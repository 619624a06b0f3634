#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repo root, on a CUDA host

Phases; any failure exits non-zero:

  1. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, all at once) and print the card (nvidia-smi
     name and power limit);
  2. hold each kernel's wrapper against its plain PyTorch version on the
     card: the serve kernels (fused_bag_interactions and
     fused_grouped_bag_interactions, the latter in both call forms: ids
     permuted with a slot map, and ids in table order) at the main path's
     shapes, and all four kernels at edge shapes (d = 128 and 256, empty
     groups, repeated, poisoned-row and out-of-range ids); the serve
     kernels also at the cluster split's edges (T = 3, 37, 100, B = 1)
     and at row widths that are not a power of two of 16-byte vectors or
     not whole vectors, or tables off 16-byte alignment;
  3. drive the plan="none" main path:
     ``Engine(get_dlrm("dlrm-rm2-small-unsharded"))`` at full width (40
     tables x 4,194,304 rows x 32, fp32, random weights from a seed), at
     the planner's default pipeline depth, serves queries through
     ``run_serial``, ``run_open_loop`` and ``submit``; the fused kernel's
     launch count must equal the sum over flushes of the resolved depth,
     and the probs must be finite, in (0, 1), and agree with the composed
     (plain) path and with the CPU path;
  4. drive the plan="auto" main path: the planner places the same weights
     in a fast and a bulk table group and the session serves them through
     the grouped kernel (launches = sum of resolved depths, and the
     single-group kernel is not launched); its probs must agree with the
     plan="none" session, with its own composed path and with a session
     under an interleaved concrete ShardingPlan. Closed-loop p50/p99 at
     the default depth and at depth 1, and a profile of both flushes;
     4c. row-wise sharding at n=1 on phase 3's tables:
     ``Engine(get_dlrm("dlrm-rm2-small-sharded"), exchange=mode)`` serves
     4 submitted queries in each wire mode ("partial_pool", "unpooled"),
     composed (``serve_kernel == "composed"``, no kernel launched), probs
     equal to the table-wise session's; closed-loop p50 beside the
     table-wise composed path, in turns;
  5. time the serve kernels with CUDA events beside their bound, their
     plain versions and one library yardstick;
  6. the tiered runtime at full width: a two-tier store built from the
     same weights by ``measure_row_freq`` (alpha 1.05) with 65,536 hot
     rows a table serves 4 batches of the stream through the cached-bag
     kernel (6a) and, once the stacked tables are freed, 4 through the
     packed embedding-bag kernel (6b; 4 launches each), all against
     ``embedding_bag_ref``; both kernels are also held against their
     plain versions (on the store: streams mostly at the pad slots, ids
     at S and R and counted from the end, ids out of range; on small
     tables: bf16, d = 30 and tables off alignment, which take the
     scalar loads, d = 20, non-zero pad rows) and timed;
  7. the kernels API's other four ops, each through ``kernels.ops`` with
     the launch counts zeroed just before and read just after:
     a. (run between phases 6a and 6b, while the stacked tables and the
        store are both resident) fused_cached_bag_interactions on the store at
        B = 25, 100, 200 and 800 of the alpha = 1.05 stream, held against
        its plain version and against fused_bag_interactions on the
        stacked tables, and interactions on pooled rows of the same
        batches (and at the edges of its design: B = 1, 397, 801, T = 1
        and 100, d = 33, 8, 256, every fp32/bf16 mix, pooled and bot_out
        off 16-byte alignment; timed beside an empty kernel's device
        time, its floor, and at d = 128); a bf16 store, d = 128, non-zero
        pad rows and other edge
        shapes, hand-made slot pairs for each branch of its two-tier pool
        (both pads, both rows real, counted from the end, out of range in
        either tier) at the cluster split's edges T = 3, 37 and 100; both
        timed;
     b. (last) flash_attention at mixtral-8x7b's widths (Hq = 32, Hkv = 8,
        hd = 128, window 4,096, causal, bf16) at the prefill_32k length
        (T = S = 32,768, batch cut from 32 to 1), held against its plain
        version at T = S = 8,192 and on sampled rows at 32,768, with edge
        cases (hd = 120, h2o-danube-3-4b's 32/8 heads of 120 at T = S =
        4,200 past its 4,096 window and its decode over a 4,096-slot ring,
        internlm2-1.8b's 16/8 heads, non-causal, T != S,
        fully masked rows, fp32; the tensor-core path's tile edges: T and S
        of 127-129, hd = 32, 64, 120, 128, windows of 1 and 127, B = 2
        with Hq / Hkv = 1 and 4), each row also held to its own norm, and
        timed at prefill_32k beside the library (K and V repeated to the
        query heads, F.scaled_dot_product_attention on its memory-efficient
        backend, held to the sampled rows too), the card's SM clock, power
        draw and temperature printed just before and after that timing;
        flash_decode at decode_32k (B = 128,
        S = 32,768, lengths in [1, S]), held against its plain version at
        B = 8 with lengths 0 and S, a poisoned tail and edge shapes; both
        timed;
     c. (after 7a, on the same stacked tables) the blocked bag,
        embedding_bag_blocked, through ``kernels.ops`` on aligned streams
        at B = 200 and 800 (lblk = 8) and on the alpha = 1.05 stream,
        held against its plain version and against embedding_bag; its
        on-device predicate against ``blocked_stream_aligned``; edge
        cases at lblk 4, 8, 16 and d 32, 128, 256 in fp32 and bf16,
        streams that are not aligned (unsorted, a block reversed, a block
        off by a row, a negative block, blocks past the table, ids out of
        range, nine ids in ten at one row; the per-row branch also at
        d = 30 and 20) and narrower loads; timed beside embedding_bag on
        the same streams, its plain version and the library;
  8. training at full width (after 7b, on tables of its own):
     ``Engine(get_dlrm("dlrm-rm2-small-unsharded"), plan=..., optimizer=
     ...).train_session().run`` at B = 200, plan="none" with SGD at depth
     1, then plan="auto" with row-wise AdaGrad at the planner's training
     depth: the first step held against the same step on a compact model
     of its touched rows (``reference_train_step`` for SGD, the
     reference's formula for AdaGrad) on the card and on the CPU, values
     and the step's changes, with sampled untouched rows unchanged; then
     TRAIN_STEPS steps with finite losses, step time p50/p99, samples/s,
     peak memory (while the session is built, and over the steps) under
     the tables' bytes + 2 GB, no kernel launched, and one step under the
     profiler; 8b. plan="auto" AdaGrad at the launchers' lr of 0.01, which
     diverges as the reference does: its first step held as in 8, then
     the step where its loss first is not finite recorded; 8c.
     ``dlrm-rm2-small-sharded`` trains through the row-wise exchange in
     both wire modes (SGD 3 steps, AdaGrad 2, depth 1), its losses, MLPs
     and touched rows (and accumulators) equal to a table-wise session's
     from the same seed and stream, no kernel launched;
  9. checkpoint at step 4 -> resume -> 4 more steps equals an
     uninterrupted 8-step run, on the card at ``cfg.reduced()`` size;
     9b. the replicated fleet at full width (``repro_torch.cluster``):
     ``Cluster(get_dlrm("dlrm-rm2-small-unsharded"))`` with B = 200,
     capacity 4 queries, max_wait_ms 2 and the planner's depth, the
     replicas sharing the card, in turn and each freed before the next:
     (i) a flash crowd at the launcher's default load (0.8 x replicas /
     the measured per-query service) on 2 replicas under p2c with an
     autoscaler that grows to 3 (every query answered once, probs finite
     in (0, 1), a scale-up whose remesh copied every param leaf, the
     spawned replica served and, while live, agrees with replica 0 (a
     replica retired by a scale-down has released its params), row 1's launches
     = the sum of resolved depths, 4 queries against the composed path,
     peak under 3 x the tables + 2 GB); (ii) zipf_drift over two
     rotations of the hot rows on 2 replicas under round robin with the
     hit-ratio monitor on the card (a baseline below 1, no lfu_refresh
     before the first rotation, one after each rotation, and the hit
     ratio back over the refresh threshold after each refresh); (iii)
     plan="auto" on 2 replicas under jsq (row 3's launches = the sum of
     resolved depths, row 1 not launched). Each run prints its report,
     wall time, achieved / offered QPS and utilizations;
     9c. the sharded fabric fleet at full width (``repro_torch.fabric``):
     ``ShardedFleet(get_dlrm("dlrm-rm2-small-unsharded"))`` on tables
     drawn once into host memory (21.47 GB, shared by every fleet), B =
     200, capacity 4 queries, max_wait_ms 2, alpha 1.05, the boards sharing
     the card, each fleet freed before the next: (a) one board of 20,480
     MiB under a zipf_drift trace at 0.3 x its measured capacity; (b)
     three boards of 7,000 MiB under jsq (the table set does not fit one
     board, a table is split into row ranges, the remote-row cache
     re-elects at least once), (c) the same with the cache off (more wire
     bytes a query), both bitwise equal to (a) query for query; (d) two
     boards at the default 12,800 MiB under a flash crowd with an
     autoscaler to 3 whose threshold the base load stays under (a
     scale-up at or after the first burst that migrates rows, bytes
     moved = rows x 128, the autoscaler's migration log equal to the
     report), bitwise equal to a static 2-board fleet. Every run holds
     the first flush of each partition's row-4 outputs against
     ``embedding_bag_ref`` and three queries' probs against a plain path
     (host rows, the ref, the dense forward). Row 4 (``embedding_bag``)
     launches once a whole-table owner and once a split pool a flush,
     plus one untimed warm-up a new shape; peak device memory under the
     tables + the largest board's slice + 2 GB; the phase under 120 s;
     9d. online updates at full width (``repro_torch.online``), on 9c's host
     tables before they are freed; each delta channel recorded before its
     run by an ``OnlineTrainer`` on a copy of those tables (lr 0.05, one
     step an update, the scenario's drift salt) whose ``OnlineSource`` puts
     5 batches inside the trace, the trainer freed before serving: (i) a
     ``Cluster`` of 2 replicas (plan none, B = 200, capacity 4, max_wait_ms
     2, the planner's depth, round robin) under a 400-query zipf_drift trace
     at the launcher's default load, each batch broadcast at its update
     barrier (every query answered once, one update a batch, rows pushed =
     the batches' rows, every updated row of both replicas bitwise its
     latest value, row 1's launches = the sum of resolved depths over every
     flush, update flushes included, peak under 2 x the tables + 2 GB); (ii)
     the sharded fleet over 9c's trace on one channel: (a) one board of
     20,480 MiB, (b) three of 7,000 MiB (table 39 split, cache on) under
     coherence "propagate", (c) as (b) under "invalidate"; (b) and (c)
     bitwise equal to (a) query for query, the fleet's host rows and every
     owner's resident rows at the updated ids bitwise their latest values,
     9c's shared host tables unchanged (the fleet's first write copies
     them), (c) invalidating and (b) propagating, row 4 held and counted as
     in 9c, peak under the tables + the largest slice + 2 GB, host RSS
     growth over the phase's start under the tables + the fleet's cache
     arrays + 4 GB; in (i) and (ii) three queries' probs (one before the
     first emit, two after later versions) against a plain path that applies
     each batch emitted at or before the query's arrival (the batches change
     the last query's pooled rows by ~1% at lr 0.05, which may not move its
     fp32 probs); (iii) the launchers at --smoke on the card: ``train
     --emit-deltas`` into ``build/``, replayed by the serve launcher in both
     fleet modes (one update a recorded batch), then ``--online-every-s``
     with ``--record-deltas`` in both modes, each recording reloaded equal
     to the channel its run consumed; then ``refresh_tiered`` on a two-tier
     store of 262,144 rows a table (``measure_row_freq`` +
     ``build_tiered_tables`` on the card), row 6 over the updated rows
     against ``embedding_bag_ref`` on the updated bulk. Each apply, the
     trainer's step and copy, staleness and RSS are printed; the phase under
     120 s;
     9e. the LM substrate (ROADMAP A8a), after 9c's host tables are
     released: (a) internlm2-1.8b at full width and depth (24 layers, d
     2,048, 16/8 heads of 128, ff 8,192, padded vocab 94,208: 1.896 B
     params) trains 30 AdamW steps through ``Engine(get_arch(
     "internlm2-1.8b"), lr=3e-4).train_session(batch=8, seq=128,
     schedule_steps=30)`` (row 8 in every forward, the backward plain
     torch), its first step's loss and grad norm held against the same
     step with plain attention, every loss finite, and the windowed
     decrease (mean of the first 5 against the last 5) at ``reduced()`` on
     the card; then ``make_prefill_step`` at B = 2 x T = 32,768
     (prefill_32k, batch cut from 32) and 32 tokens of
     ``make_decode_step`` over S = 32,800 (decode_32k, batch cut from 128)
     on the trained weights, timed; a 2 x 2,048 prompt and 8 greedy tokens
     against the plain path (rows 8 and 9's plain versions on the same
     CUDA tensors), and the last 4 tokens decoded after a prefill of the
     rest against the prefill of all (row 9 against row 8); (b)
     mixtral-8x7b at full width, depth cut to 2: prefill 1 x 8,192 past
     the 4,096 window (the MoE at capacity 2,560), 16 decode steps on the
     wrapped ring, against the plain path; (c) whisper-base whole: the
     encoder over 1,500 frames, cross-attention T != S, decode with the
     projected memory, against the plain path. Rows 8 and 9's launches
     equal the layers x forwards and decode steps; the phase under 120 s,
     its peak printed, everything freed before phase 10;
     9f. the SSM mixers (ROADMAP A8b), after 9e: (a) rwkv6-3b at full
     width and depth (32 RWKV6 time-mix + channel-mix layers, d 2,560, 40
     heads of 64, ff 8,960, vocab 65,536: 3.089 B params): one layer's
     mixer on the first batch with the 64-step chunks rematerialized
     against no chunking (loss and grads), then 8 AdamW steps through
     ``Engine(get_arch("rwkv6-3b"), lr=3e-4).train_session(batch=8,
     seq=129, schedule_steps=30)`` (T = 128 tokens a row, so the chunks
     rematerialize; the last 2 under the profiler): every loss finite,
     the peak under 76 GB (the reference's own full-width loss rises at
     this lr, as the port's does: ``tests/test_torch_lm_train.py`` holds
     the port's AdamW steps at full width to the reference's); at
     ``reduced()`` 30 steps at lr 3e-3, the mean of the last 3 losses
     below the first; ``make_prefill_step`` at 2 x 2,048 and 32 tokens
     of ``make_decode_step`` on the trained weights, timed, the decode
     state's bytes; a 2 x 256 prompt and 8 greedy tokens through prefill
     and decode against one forward over the 264 tokens; (b) jamba's
     Mamba mixer at jamba's full widths (d 8,192, d_inner 16,384, d_state
     16: 420.3 M params): ``mamba_scan`` over 2 x 1,024 against the fold
     of 1,024 ``mamba_step`` calls, both timed, on bf16 and fp32 inputs
     (the final SSM state held in fp32); (c) jamba-1.5-large-398b
     whole at ``reduced()`` (16 layers, 14 Mamba + 2 attention, 4 experts
     top-2; at full width one unit's four MoE layers alone are ~155 GB):
     loss and grads under ``forward(remat=True)`` against remat off (row 8
     recomputed), a 2 x 512 prompt and 8 decode steps against the plain
     path, then the long_500k depth: row 9 itself on one query against
     524,288 slots in which 8 keys from the first slot to the last carry
     the softmax, against its plain version, and the plain output moving
     past the row tolerance without the first slot's key; then 4 decode
     tokens ending at position 524,287 over a 524,288-slot cache seeded
     on the card (K drawn 8 wide, so a few keys carry each softmax), with
     drawn SSM states, against the plain path, and the plain path's
     logits moving past that tolerance with V zeroed over the first 1/8
     of the slots. Rows 8 and 9's launches
     counted; a train step, a prefill and a decode step of rwkv6-3b
     profiled; the phase under 120 s;
 10. the host chunk tier (last, once every earlier tensor is freed):
     ``Engine(get_dlrm("dlrm-rm2-large-unsharded"), host_capacity_mb=
     40960, alpha=1.05).serve_session()`` at full width (40 x 4,194,304
     x 128 fp32, 85.9 GB of tables in host memory; rows cut only if host
     memory cannot hold them + 10 GB), a 20 GiB hot slab and a 20 GiB
     chunk cache on the card: 16 queries at depth 1, then queries at a
     pinned depth of 4 until the cache has evicted and faulted chunks in
     again, each printed (service, modeled stall, measured transfer and
     rate, faults, evictions, writebacks, bytes, chunk hit ratio); three
     queries' probs held against the per-table plain path; the cached-bag
     pool mode on the same store, row 6 reading the flat chunk cache in
     place (probs against the paired mode, row 6's launches = the sum of
     resolved depths; row 6 held against its plain version at this shape,
     its cache rows read past element 2**31, with the edge cases of 6a
     on the shared tier; the pooling step's device time and transient
     memory, row 6 timed); an online batch written through the host
     tier (``write_through_host``: cold rows resident in the chunk cache,
     rewritten in place, and cold rows that are not, faulted in after the
     write), then a query that looks them up pooled in the cached-bag
     mode, row 6 against ``embedding_bag_ref`` on the updated host rows;
     SGD training at depth 1 on the same store, its first faulting step
     held against a compact model; at the reduced config, host-tier
     serving and SGD training bitwise equal to plan="none" (under
     deterministic algorithms); the host link measured and served
     through ``calibration=``. Peak device memory and host RSS printed.

Each phase prints its peak device memory. Every profile of a flush or a
training step keeps only whole traces (each device event a whole multiple
of the flushes or steps; up to 5 tries, else "not measured"), as the
kernel timings do; phase 4c's row-wise sessions are profiled too. The
line before the last holds the per-kernel JSON (every TPU kernel of the
JAX package, all nine ported); the last line is ``{"ok": true,
"device": {...}}``. Imports nothing of JAX or of the JAX package
``repro``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

CONFIG = "dlrm-rm2-small-unsharded"
# Kernel vs plain version: fp32 allclose at the contract of the tests.
# Inputs are drawn at the model's init scale (tables U(+-1/sqrt(R)),
# bot_out U(+-1)), where fp32 summation order moves results by ~1e-7.
RTOL = ATOL = 1e-5
# A training step's change against the compact model's, relative to its
# norm (on top of one fp32 step an updated value: ``agree_change``).
CHANGE_RTOL = 1e-3
# At R = 4,194,304 a pooled.pooled feature is ~4e-5 and a pooled one
# ~4e-3, so ATOL alone would let a 30% error there pass: those features
# are also held to their own scale, max|err| <= SCALED_TOL * max|want|
# over the pooled.pooled block of an interaction output, or over a pool.
SCALED_TOL = 1e-5
# Attention kernel vs plain version: the contract of tests/test_kernels.py.
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# An attention row that weighs n keys of N(0, 1) values has |out| ~
# sqrt(e / n), ~0.026 over a 4,096-key window, so ATTN_TOL alone would
# pass an error the size of the answer there: each (b, t, h) row is also
# held to its own scale, ||got - want|| <= ATTN_ROW_TOL * ||want||. bf16
# rounding of the output (and of P on the tensor cores) reads ~2e-3.
ATTN_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, fp32
# outside the tensor cores, and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# mixtral-8x7b (src/repro/configs/mixtral_8x7b.py) and the LM shape cells
# prefill_32k and decode_32k (src/repro/configs/base.py:184-185).
MIXTRAL = dict(Hq=32, Hkv=8, hd=128, window=4096)
PREFILL_T = DECODE_S = 32_768
DECODE_B = 128
# The plain version of flash attention holds (Hkv, G, T, S) fp32 scores:
# 8.6 GB at T = S = 8,192 (137 GB at 32,768), and the library's GQA path
# expands K and V per query head: flash decode is timed beside both at 16
# caches of S rows.
CHECK_T = 8192
TIME_DECODE_B = 16
# Row-wise sharding at n=1 (phases 4c and 8c): the paper's "full sharding"
# configuration, at phase 3's widths, against the table-wise session.
ROW_WISE_CONFIG = "dlrm-rm2-small-sharded"
ROW_WISE_MODES = ("partial_pool", "unpooled")
ROW_WISE_TRAIN = (("sgd", 0.01, 3), ("adagrad", 1e-3, 2))   # opt, lr, steps
# phase 9b, the replicated fleet: the autoscaler's p99 threshold in units
# of a 4-query flush's service time, the flash crowd's span of virtual
# time (seed 0's first burst is 2.33-3.03 s), plan="auto"'s query count
FLEET_SLA_FACTOR = 3.0
FLASH_SPAN_S = 3.2
AUTO_FLEET_QUERIES = 400
# the hit-ratio monitor's profile in (ii): 256 batches touch ~618,000
# distinct rows a table, more than its 419,430 hot slots, so the
# baseline falls below 1 (0.95) and stays within reach of the live
# stream (0.88) until a rotation (0.05). The default 4 batches touch
# ~25,000: the baseline is 1.0 and the first queries refresh before any
# drift.
MONITOR_PROFILE_BATCHES = 256
# phase 9c, the sharded fabric fleet: one table set of 40 x 512 MiB (fp32)
# = 20,480 MiB, held by one board of 20,480 MiB (a), or by three of 7,000
# MiB (b, c: 13 whole tables a board, 6,656 MiB, and the 40th split over
# the 344 MiB each board has left), or by two at the default 12,800 MiB
# that grow to three (d). The query counts keep the phase under
# FABRIC_PHASE_S: the host's LFU and wire bookkeeping takes tens of ms a
# query at full width. (a)-(c) serve a zipf_drift trace whose first
# rotation falls FABRIC_ROTATE_AT of the way through it; (d) a flash crowd
# whose first burst is stretched or squeezed to begin after
# FABRIC_BURST_AT queries. The card's host returns freed pages to
# MemAvailable over seconds, which phase 10 reads: the phase waits up to
# FABRIC_RELEASE_S for its 21.47 GB to come back.
FABRIC_ALPHA = 1.05
FABRIC_REF_MB = 20480
FABRIC_BOARD_MB = 7000
FABRIC_QUERIES = 240
FABRIC_ROTATE_AT = 0.25
FABRIC_ELASTIC_QUERIES = 240
FABRIC_BURST_AT = 48
FABRIC_PHASE_S = 120.0
FABRIC_RELEASE_S = 40.0
ONLINE_QUERIES = 400     # 9d(i)'s zipf_drift trace
ONLINE_UPDATES = 5       # delta batches a 9d trace takes
ONLINE_LR = 0.05         # the online trainer's (and the launcher's) lr
ONLINE_PHASE_S = 120.0
ONLINE_TIER_ROWS = 262_144
ONLINE_SLACK_BYTES = 4 * 10**9
# Phase 9e, the LM substrate (A8a). (a) internlm2-1.8b at full width and
# depth: 30 AdamW steps at batch 8 x 128 (lr 3e-4, the LM session's
# default), prefill at prefill_32k's seq with its batch cut from 32 to 2
# (a 32-row cache would be 103 GB), 32 decode tokens over S = 32,800
# (decode_32k's depth, its batch cut from 128), and a 2 x 2,048 prompt
# held against the plain path (at 32,768 the plain attention would hold
# 137 GB of scores), with the last LM_SPLIT_K tokens decoded after a
# prefill of the rest; the windowed decrease at reduced(), AdamW at the
# reference's test_loss_decreases lr of 3e-3. (b) mixtral-8x7b at full
# width, depth cut 32 -> 2: a prompt past its 4,096 window, then decode
# on the wrapped ring. (c) whisper-base whole.
# Tolerances of the kernel path against the plain one (the same CUDA
# tensors, rows 8 and 9's plain versions), set beforehand: the CPU tests
# hold two reduced layers against the reference at 8 bf16 ulps of the
# scale and 2% of the norm; 24 layers at full width get 16 ulps and 2%;
# the first step's loss within 1e-2 absolute and its grad norm within 2%.
LM_ARCH = "internlm2-1.8b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 128, 30
LM_TRAIN_LR = 3e-4
LM_SMALL_LR = 3e-3
LM_PREFILL = (2, 32_768)
LM_DECODE_STEPS = 32
LM_CHECK = (2, 2_048)
LM_CHECK_TOKENS = 8
LM_SPLIT_K = 4
MIXTRAL_LAYERS = 2
MIXTRAL_PREFILL = (1, 8_192)
MIXTRAL_DECODE = 16
WHISPER_PROMPT = (2, 64)
WHISPER_DECODE = 8
LM_ULPS = 16
LM_REL = 2e-2
LM_LOSS_TOL = 1e-2
LM_PHASE_S = 120.0
# Phase 9f, the SSM mixers (A8b). rwkv6-3b at full width and depth: batch
# 8, seq 129 (a batch row is seq - 1 = 128 tokens, a multiple of the
# 64-step chunk, so the chunks rematerialize; at 127 they would not, and
# autograd would save a (8, 40, 64, 64) fp32 state a step and more), 8
# AdamW steps at the session's lr, its cosine over 30 steps as phase 9e's,
# under a peak limit of the card's 80 GB less 4; the losses are finite.
# At full width the reference's own loss rises at lr 3e-4, as the port's
# does (tests/test_torch_lm_train.py holds the port's AdamW steps there to
# the reference's), and on the card the port's rises once the warmup
# brings the lr near 3e-4, so the decrease (the mean of the last 3 losses
# below the first) is held at reduced(), 30 steps at phase 9e's lr of
# 3e-3; prefill 2 x 2,048 and 32 decode tokens; a 2 x 256 prompt and 8
# greedy tokens against one forward. Mamba at jamba's full widths over 2
# x 1,024. jamba at reduced(): a 2 x 512 prompt, 8 decode steps, and the
# long_500k depth at B = 1. Tolerances, set beforehand: the chunked
# mixer's loss within 1e-5 relative and grads within 1e-4 of their norm of
# the unchunked one (the same ops); model paths at phase 9e's LM_ULPS /
# LM_REL; the scan against the fold of its steps within 2% of the output's
# norm (bf16 and fp32 inputs) and, in fp32, 1e-4 of the final SSM state's
# (in bf16 the projections round differently over B x T rows and over B:
# 7.5e-4 on the card).
SSM_ARCH = "rwkv6-3b"
SSM_LAYERS = None          # full depth; 24 if the peak passes the limit
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 8, 129, 8
SSM_PEAK_LIMIT_GB = 76.0
SSM_PREFILL = (2, 2_048)
SSM_DECODE_STEPS = 32
SSM_CHECK = (2, 256)
SSM_CHECK_TOKENS = 8
SSM_LOSS_REL = 1e-5
SSM_GRAD_REL = 1e-4
JAMBA_ARCH = "jamba-1.5-large-398b"
MAMBA_SCAN = (2, 1_024)
MAMBA_OUT_REL = 2e-2
MAMBA_STATE_REL = 1e-4
JAMBA_TRAIN = (2, 64)
JAMBA_PROMPT = (2, 512)
JAMBA_DECODE = 8
LONG_SLOTS = 524_288       # long_500k's seq
LONG_DECODE = 4
LONG_K_STD = 8.0           # the seeded keys' spread (module doc)
LONG_NEEDLES = 8
NEEDLE_SCORE = 24.0
SSM_PHASE_S = 120.0
HOT_PER_TABLE = 65_536
TIERED_ALPHA = 1.05
GB = 1e9

KERNELS = {
    "fused_bag_interactions": (
        "src/repro_torch/kernels/csrc/fused_serve.cu",
        "src/repro/kernels/fused_serve.py:134"),
    "fused_cached_bag_interactions": (
        "src/repro_torch/kernels/csrc/fused_serve.cu",
        "src/repro/kernels/fused_serve.py:181"),
    "fused_grouped_bag_interactions": (
        "src/repro_torch/kernels/csrc/fused_serve.cu",
        "src/repro/kernels/fused_serve.py:244"),
    "embedding_bag": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag.py:45"),
    "cached_embedding_bag": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/cached_embedding_bag.py:47"),
    "interactions": (
        "src/repro_torch/kernels/csrc/interactions.cu",
        "src/repro/kernels/interactions.py:31"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:90"),
    "flash_decode": (
        "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:75"),
    "embedding_bag_blocked": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag.py:107"),
}
NOT_PORTED = []          # every TPU kernel of the JAX package is ported
# The blocked bag's L-block and the batches it is timed at.
LBLK = 8
BLOCKED_BATCHES = (200, 800)
# Training at full width: (plan, optimizer, alpha of the stream, lr) a
# session, and the steps each runs after its checked first step.
# Row-wise AdaGrad's first step moves every touched element by ~lr, 20x
# the init scale 1/sqrt(R) = 4.9e-4 at the launcher's lr of 0.01, and a
# 20-step run at that lr reached a non-finite loss on the card; 1e-3 is
# 2x the init scale.
TRAIN_RUNS = (("none", "sgd", 0.0, 0.01),
              ("auto", "adagrad", TIERED_ALPHA, 1e-3))
TRAIN_STEPS = 20
PROFILE_STEPS = 2        # steps a whole-trace training profile counts
# The plan=auto AdaGrad run again at the launchers' lr of 0.01, recorded
# and not held to a finite loss: the reference diverges there too
# (tests/test_torch_train.py::
# test_adagrad_at_the_launchers_lr_diverges_as_the_reference, at the full
# widths with the rows cut). Its first step is held like phase 8's.
DIVERGING_RUN = ("auto", "adagrad", TIERED_ALPHA, 0.01)
# Phase 10, the host chunk tier: RM2-large (40 x 4,194,304 x 128 fp32,
# 85.9 GB of tables, more than the card) served and trained from host
# memory under a 40 GiB device budget (a 20 GiB hot slab + a 20 GiB chunk
# cache). MemAvailable must hold the tables + HOST_SPARE_BYTES, or the
# rows are cut. HOST_SPARE_BYTES is what the phase adds to the process
# beyond the tables and its own RSS at the start: the manager's host
# mirrors (pos, hot map, chunk arrays: ~2.4 GB at full width), the pinned
# staging rings and the link probe (~0.8 GB), the CPU side of 10c's
# compact-model check and the query streams; the phase checks its own
# peak against it. The perf model's 4-row chunks give the cache
# 10,485,760 slots, which the stream fills in ~47 queries of 600 samples:
# the depth-4 run serves until chunks come back after their eviction, at
# most HOST_MAX_QUERIES. Training (10c) draws its batches from another
# seed than serving, so its steps fault (and evict) on the full cache.
HOST_CONFIG = "dlrm-rm2-large-unsharded"
HOST_BUDGET_MB = 40960
HOST_SPARE_BYTES = 12 * 10**9
HOST_MAX_QUERIES = 64
HOST_TRAIN_LR = 0.01
HOST_TRAIN_SEED = 1
HOST_TRAIN_STEPS = 4
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"[chip_smoke] FAIL: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def clocks_line() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().replace("\n", "; ")


def peak_line(phase: str) -> None:
    torch.cuda.synchronize()
    print(f"[memory] {phase}: peak allocated "
          f"{torch.cuda.max_memory_allocated() / GB:.2f} GB, now "
          f"{torch.cuda.memory_allocated() / GB:.2f} GB")
    torch.cuda.reset_peak_memory_stats()


def close(kernel, name, got, want, errs, nan_ok=False, pairs=None):
    """Hold a kernel's output against its plain version: same NaN pattern,
    fp32 allclose, and (``pairs`` = (T, d) of an interaction output) the
    pooled.pooled block against its own scale."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{kernel} {name}: shape "
                                   f"{tuple(got.shape)}")
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan) and (nan_ok or not nan.any()),
          f"{kernel} {name}: NaN pattern differs from the plain version")
    g, w = got[~nan], want[~nan]
    abs_err = (g - w).abs().max().item() if g.numel() else 0.0
    rel_err = ((g - w).abs() / w.abs().clamp_min(1e-30)).max().item() \
        if g.numel() else 0.0
    ok = bool(torch.allclose(g, w, rtol=RTOL, atol=ATOL))
    scaled, text = 0.0, ""
    if pairs is None:                  # a pool: the whole output's scale
        gp, wp, text = got, want, " pooled err/scale"
    elif pairs[0] > 1:
        T, d = pairs
        lj = torch.tril_indices(T + 1, T + 1, offset=-1,
                                device=got.device)[1]
        pp = d + torch.nonzero(lj >= 1)[:, 0]
        gp, wp, text = got[:, pp], want[:, pp], " pooled.pooled err/scale"
    if text:
        keep = ~torch.isnan(wp)
        scale = wp[keep].abs().max().item() if keep.any() else 0.0
        if scale > 0:
            scaled = (gp - wp)[keep].abs().max().item() / scale
        text = f"{text}={scaled:.3e}"
    ok_scaled = scaled <= SCALED_TOL
    print(f"[kernel] {kernel} {name}: max_abs_err={abs_err:.3e} "
          f"max_rel_err={rel_err:.3e}{text} "
          f"{'ok' if ok and ok_scaled else 'OVER TOLERANCE'}")
    check(ok, f"{kernel} {name}: kernel disagrees with its plain version "
              f"(rtol={RTOL}, atol={ATOL})")
    check(ok_scaled, f"{kernel} {name}: pooled features off by "
                     f"{scaled:.3e} of their scale (limit {SCALED_TOL})")
    record(errs, kernel, abs_err, scaled)


def record(errs, kernel, abs_err, scaled):
    """Keep a case's errors: the largest absolute error and the largest
    error against its own scale go into the kernels line."""
    errs.setdefault(kernel, []).append(abs_err)
    errs.setdefault((kernel, "scaled"), []).append(scaled)


# ---------------------------------------------------------------- phase 2
def draw_case(B, T, L, d, R, dtype, gen, dev, tables=None):
    bound = R ** -0.5
    if tables is None:
        tables = torch.empty((T, R, d), device=dev).uniform_(
            -bound, bound, generator=gen).to(dtype)
    ids = torch.randint(0, R, (B, T, L), generator=gen, device=dev,
                        dtype=torch.int32)
    bot = torch.empty((B, d), device=dev).uniform_(-1, 1, generator=gen)
    return tables, ids, bot


def compare(name, tables, ids, bot, errs, nan_ok=False):
    from repro_torch.kernels import fused_serve, ref
    got = fused_serve.fused_bag_interactions(tables, ids, bot)
    want = ref.fused_bag_interactions_ref(tables, ids, bot)
    close("fused_bag_interactions", name, got, want, errs, nan_ok,
          pairs=(ids.shape[1], bot.shape[1]))


def compare_grouped(name, tf, tb, ids, bot, inv, errs, nan_ok=False):
    """The grouped kernel on (tf, tb) against its plain version, in both
    call forms: ``ids`` in concat(fast, bulk) order with the slot map
    ``pos`` (the kernels API's op), and the same ids in original table
    order with the per-table map ``src`` (the serve path's)."""
    from repro_torch.kernels import fused_serve, ref
    want = ref.fused_grouped_bag_interactions_ref(tf, tb, ids, bot, inv)
    pos = fused_serve.grouped_pos(inv, ids.device)
    got = fused_serve.fused_grouped_bag_interactions(tf, tb, ids, bot, pos)
    close("fused_grouped_bag_interactions", name, got, want, errs, nan_ok,
          pairs=(ids.shape[1], bot.shape[1]))
    orig = ids.index_select(1, torch.as_tensor(inv, device=ids.device))
    got = fused_serve.fused_grouped_bag_interactions_unpermuted(
        tf, tb, orig, bot, fused_serve.grouped_src(inv, ids.device))
    close("fused_grouped_bag_interactions", f"{name}, ids in table order",
          got, want, errs, nan_ok, pairs=(ids.shape[1], bot.shape[1]))


def compare_bags(name, tables, ids, gen, errs, nan_ok=False):
    """The embedding-bag kernel on (tables, ids), and the cached bag with
    ``tables`` as its bulk tier beside a small random fast tier."""
    from repro_torch.kernels import embedding_bags, ref
    close("embedding_bag", name, embedding_bags.embedding_bag(tables, ids),
          ref.embedding_bag_ref(tables, ids), errs, nan_ok)
    fast = torch.empty((tables.shape[0], 9, tables.shape[2]),
                       device=ids.device).uniform_(-1, 1, generator=gen).to(
        tables.dtype)
    fi = torch.randint(0, 9, ids.shape, generator=gen, device=ids.device,
                       dtype=torch.int32)
    close("cached_embedding_bag", name,
          embedding_bags.cached_embedding_bag(fast, tables, fi, ids),
          ref.cached_embedding_bag_ref(fast, tables, fi, ids), errs, nan_ok)


def shuffled(T, gen):
    return tuple(torch.randperm(T, generator=gen,
                                device=gen.device).tolist())


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = {}
    R = 4_194_304
    full = None
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        full = (None if full is None else full.to(dtype))
        # the plan="none" main path's micro-batch shapes at depth 8 (25 for
        # a one-query flush, 100 for a capacity flush), and whole batches
        for B in (25, 100, 200, 800) + ((1,) if dtype == torch.float32
                                        else ()):
            case = draw_case(B, 40, 80, 32, R, dtype, gen, dev, full)
            full = case[0]
            compare(f"B={B} T=40 L=80 d=32 R={R} {tag}", *case, errs)
        # the plan="auto" main path: Tf = Tb = 20, identity order, at the
        # micro-batch (25, 100), query (200) and capacity (800) shapes
        fast, bulk = full[:20], full[20:]
        for B in (25, 100, 200, 800):
            _, ids, bot = draw_case(B, 40, 80, 32, R, dtype, gen, dev, full)
            compare_grouped(f"B={B} Tf=20 Tb=20 L=80 d=32 R={R} {tag}",
                            fast, bulk, ids, bot, tuple(range(40)), errs)
        _, ids, bot = draw_case(200, 40, 80, 32, R, dtype, gen, dev, full)
        compare_grouped(f"B=200 Tf=20 Tb=20 interleaved inv_perm {tag}",
                        fast, bulk, ids, bot, shuffled(40, gen), errs)
        del fast, bulk
    del full, case
    torch.cuda.empty_cache()
    for B, T, L, d, R in ((37, 3, 5, 32, 1000), (16, 8, 4, 128, 128),
                          (16, 1, 4, 32, 64), (8, 4, 8, 256, 64),
                          (4, 100, 2, 128, 64)):   # 52 KB of shared memory
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            tables, ids, bot = draw_case(B, T, L, d, R, dtype, gen, dev)
            compare(f"B={B} T={T} L={L} d={d} R={R} {tag}", tables, ids,
                    bot, errs)
            compare_bags(f"B={B} T={T} L={L} d={d} R={R} {tag}", tables,
                         ids, gen, errs)
            # grouped: split in two, the bulk group with other row counts
            tf = tables[:T // 2]
            tb = draw_case(1, T - T // 2, 1, d, R // 2 + 1, dtype, gen,
                           dev)[0]
            ids[:, T // 2:] %= R // 2 + 1
            compare_grouped(f"B={B} Tf={T // 2} Tb={T - T // 2} L={L} "
                            f"d={d} Rf={R} Rb={R // 2 + 1} {tag}", tf, tb,
                            ids, bot, shuffled(T, gen), errs)
            empty = tables[:0]
            compare_grouped(f"B={B} Tf=0 Tb={T} L={L} d={d} {tag}", empty,
                            tables, ids, bot, shuffled(T, gen), errs)
            compare_grouped(f"B={B} Tf={T} Tb=0 L={L} d={d} {tag}", tables,
                            empty, ids, bot, shuffled(T, gen), errs)
    # the cluster split (C = min(8, T) blocks a sample, T/C tables each):
    # T < 8 (a bag split over warps; empty segments at L < 8 above), T not a
    # multiple of C, B = 1; rows of 16-byte vectors not a power of two of
    # them (d = 36 fp32: 9, d = 24 bf16: 3, d = 24 and 20 fp32: 6 and 5),
    # and rows not whole 16-byte vectors (d = 30 fp32; d = 36, 30 and 20
    # bf16), which take the scalar path
    for B, T, L, d, R in ((1, 37, 80, 32, 4096), (3, 3, 80, 32, 4096),
                          (2, 100, 80, 32, 512),
                          (8, 40, 80, 36, 4096), (8, 40, 80, 24, 4096),
                          (6, 37, 7, 30, 512), (4, 5, 9, 20, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            tables, ids, bot = draw_case(B, T, L, d, R, dtype, gen, dev)
            name = f"B={B} T={T} L={L} d={d} R={R} {tag}"
            compare(name, tables, ids, bot, errs)
            compare_grouped(f"{name} Tf={T // 3}", tables[:T // 3],
                            tables[T // 3:], ids, bot, shuffled(T, gen),
                            errs)
    # tables 4 (fp32) and 2 (bf16) bytes off 16-byte alignment: the scalar
    # path at d = 32
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.empty((1 + 8 * 512 * 32,), device=dev).uniform_(
            -0.05, 0.05, generator=gen).to(dtype)
        tables = buf[1:].view(8, 512, 32)
        _, ids, bot = draw_case(4, 8, 16, 32, 512, dtype, gen, dev, tables)
        name = f"tables {buf.element_size()} bytes off 16-byte alignment"
        compare(name, tables, ids, bot, errs)
        compare_grouped(name, tables[:3], tables[3:], ids, bot,
                        shuffled(8, gen), errs)
    tables, ids, bot = draw_case(16, 8, 4, 32, 128, torch.float32, gen, dev)
    ids[:] = ids[:, :, :1]                       # one row, L times a bag
    compare("repeated ids", tables, ids, bot, errs)
    compare_bags("repeated ids", tables, ids, gen, errs)
    compare_grouped("repeated ids", tables[:3], tables[3:], ids, bot,
                    shuffled(8, gen), errs)
    for dtype in (torch.float32, torch.bfloat16):
        tables, ids, bot = draw_case(64, 8, 16, 32, 1024, dtype, gen, dev)
        tables[:, 0, :] = float("nan")
        ids.clamp_(min=1)
        compare(f"poisoned row 0 never read ({dtype})", tables, ids, bot,
                errs)
        compare_grouped(f"poisoned row 0 never read ({dtype})", tables[:5],
                        tables[5:], ids, bot, shuffled(8, gen), errs)
        compare_bags(f"poisoned row 0 never read ({dtype})", tables, ids,
                     gen, errs)
    tables, ids, bot = draw_case(8, 4, 6, 32, 64, torch.float32, gen, dev)
    ids[0, 0, 0], ids[1, 1, 1], ids[2, 2, 2] = -1, 64, -65
    compare("out-of-range ids read as jnp.take does", tables, ids, bot, errs,
            nan_ok=True)
    compare_grouped("out-of-range ids read as jnp.take does", tables[:1],
                    tables[1:], ids, bot, (3, 0, 2, 1), errs, nan_ok=True)
    compare_bags("out-of-range ids read as jnp.take does", tables, ids, gen,
                 errs, nan_ok=True)
    peak_line("phase 2 (kernels vs plain versions)")
    return {k: max(v) for k, v in errs.items()}


# ---------------------------------------------------------------- phase 3
def record_flush_depths(sess):
    """Note the resolved pipeline depth of every flush the session runs
    (each flush launches the serve kernel once per micro-batch)."""
    depths = []
    execute = sess._execute

    def recorded(queries):
        samples = sess._padded_count(len(queries)) * sess.query_size
        depths.append(sess.depth_for_samples(samples))
        return execute(queries)

    sess._execute = recorded
    return depths


def submit_queries(cfg):
    from repro_torch.data.recsys import make_recsys_batch
    return [{k: v for k, v in make_recsys_batch(cfg, 1000 + i).items()
             if k != "labels"} for i in range(4)]


def drive(sess, qps):
    """The main path: 8 serial queries, 16 open-loop, 4 submitted (the 4th
    fills the batch). Launch counts are zeroed just before and read just
    after. Returns (serial, open_loop, futures, launches, flush depths)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    depths = record_flush_depths(sess)
    ops.reset_launch_counts()
    serial = sess.run_serial(8, metrics=reg)
    open_loop = sess.run_open_loop(16, qps=qps, metrics=reg)
    futs = [sess.submit(q, now=i * 1e-4)
            for i, q in enumerate(submit_queries(sess.cfg))]
    launches = dict(ops.launch_counts)
    del sess._execute                  # the session's own method again
    flushes = reg.snapshot()["flush_service_ms"]["count"] + 1
    check(len(depths) == flushes, f"{len(depths)} recorded flushes, "
                                  f"{flushes} counted")
    check(all(f.done for f in futs), "submit path left queries pending")
    print(f"[main] launches {launches} over {flushes} flushes (8 serial + "
          f"{flushes - 9} open-loop + 1 submit) at resolved depths "
          f"{depths} (sum {sum(depths)})")
    print(serial.summary())
    print(open_loop.summary())
    probs = np.stack([f.probs for f in futs])
    check(probs.shape == (4, sess.cfg.batch_size), f"probs shape "
                                                   f"{probs.shape}")
    check(bool(np.isfinite(probs).all() and (probs > 0).all()
               and (probs < 1).all()), "probs not finite in (0, 1)")
    return serial, open_loop, futs, launches, depths


def phase_main_none(dev):
    from repro_torch.configs import get_dlrm
    from repro_torch.data.recsys import make_recsys_batch
    from repro_torch.engine import Engine

    cfg = get_dlrm(CONFIG)
    table_bytes = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    t0 = time.perf_counter()
    eng = Engine(cfg)                                  # device None: the card
    sess = eng.serve_session(max_batch_queries=4, warmup=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] {cfg.name}: T={cfg.num_tables} R={cfg.rows_per_table} "
          f"d={cfg.embed_dim} L={cfg.lookups_per_table} B={cfg.batch_size} "
          f"tables {table_bytes / GB:.2f} GB fp32 on {sess.device}; "
          f"session built in {build_s:.2f} s, peak allocated "
          f"{peak / GB:.2f} GB")
    check(sess.serve_kernel == "fused", f"serve_kernel={sess.serve_kernel}")
    check(sess.params["tables"].is_cuda, "tables are not on the card")
    check(peak < 1.05 * table_bytes, "session holds more than one table copy")
    check(eng.pipeline_depth is None, "the default depth is not the "
                                      "planner's")
    print(f"[main] plan=none resolved pipeline depth: "
          f"{sess.depth_for_samples(cfg.batch_size)} at 1 query, "
          f"{sess.depth_for_samples(4 * cfg.batch_size)} at 4 queries")
    s1 = sess.measure_service_time(1)
    s4 = sess.measure_service_time(4)
    print(f"[main] service time a flush: 1 query {s1 * 1e3:.3f} ms, "
          f"4 queries {s4 * 1e3:.3f} ms (median of 5)")
    serial, open_loop, futs, launches, depths = drive(sess, 2.0 / s1)
    check(launches["fused_bag_interactions"] == sum(depths),
          "the kernel's launch count differs from the sum over flushes of "
          "the resolved depth")
    check(launches["fused_grouped_bag_interactions"] == 0,
          "plan=none launched the grouped kernel")

    # the same weights through the composed path (plain PyTorch)
    off = Engine(cfg, fused_serve="off").serve_session(
        max_batch_queries=4, params=sess.params)
    check(off.serve_kernel == "composed", "fused_serve=off is not composed")
    q = make_recsys_batch(cfg, 7)
    fused_p = sess.serve_direct(q["dense"], q["indices"])
    plain_p = off.serve_direct(q["dense"], q["indices"])
    err = float(np.abs(fused_p - plain_p).max())
    print(f"[main] fused vs composed probs, one query: max_abs_err={err:.3e}")
    check(np.allclose(fused_p, plain_p, rtol=RTOL, atol=ATOL),
          "fused and composed probs disagree")

    # reduced config: the card against the CPU path on the same weights
    rcfg = cfg.reduced()
    rs = Engine(rcfg).serve_session(max_batch_queries=2)
    cpu_params = {k: ([{n: t.cpu() for n, t in layer.items()} for layer in v]
                      if isinstance(v, list) else v.cpu())
                  for k, v in rs.params.items()}
    cs = Engine(rcfg, device="cpu").serve_session(max_batch_queries=2,
                                                  params=cpu_params)
    rq = make_recsys_batch(rcfg, 3, device="cpu")
    a = rs.serve_direct(rq["dense"], rq["indices"])
    b = cs.serve_direct(rq["dense"], rq["indices"])
    err_cpu = float(np.abs(a - b).max())
    print(f"[main] reduced config, card vs CPU probs: "
          f"max_abs_err={err_cpu:.3e}")
    check(np.allclose(a, b, rtol=RTOL, atol=ATOL), "card and CPU disagree")
    peak_line("phase 3 (plan=none main path)")
    return sess, launches, serial, open_loop


# ---------------------------------------------------------------- phase 4
def agree(name, got, want):
    err = float(np.abs(got - want).max())
    print(f"[auto] {name}: max_abs_err={err:.3e}")
    check(np.allclose(got, want, rtol=RTOL, atol=ATOL), f"{name} disagree")


def own_table_bytes(sess):
    return sum(sess.params[k].numel() * sess.params[k].element_size()
               for k in ("tables_fast", "tables_bulk"))


def phase_main_auto(dev, none):
    """plan="auto" on the plan="none" session's weights. Returns the
    session (alive for the timing phase) and what the phase measured."""
    from repro_torch.engine import Engine

    cfg = none.cfg
    table_bytes = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    eng = Engine(cfg, plan="auto")
    sess = eng.serve_session(max_batch_queries=4, params=none.params,
                             warmup=True)
    torch.cuda.synchronize()
    print(f"[memory] phase 4: building the plan=auto session peaked at "
          f"{torch.cuda.max_memory_allocated() / GB:.2f} GB, "
          f"{before / GB:.2f} GB before it (the plan=none session's "
          f"tables, {table_bytes / GB:.2f} GB), "
          f"{torch.cuda.memory_allocated() / GB:.2f} GB after")
    print(eng.plan_report("inference").summary())
    print(f"[auto] session built in {time.perf_counter() - t0:.2f} s "
          f"(profile, plan, split of the tables); its own tables "
          f"{own_table_bytes(sess) / GB:.2f} GB")
    check(sess.serve_kernel == "fused", f"serve_kernel={sess.serve_kernel}")
    check(eng.plan_report("inference").serve_kernel == "fused",
          "the plan report does not record the fused kernel")
    check(own_table_bytes(sess) == table_bytes,
          "the planned session's tables are not exactly one copy")
    depth1, depth4 = (sess.depth_for_samples(q * cfg.batch_size)
                      for q in (1, 4))
    print(f"[auto] resolved pipeline depth: {depth1} at 1 query, {depth4} "
          f"at 4 queries")
    s1 = sess.measure_service_time(1)
    s4 = sess.measure_service_time(4)
    print(f"[auto] service time a flush: 1 query {s1 * 1e3:.3f} ms, "
          f"4 queries {s4 * 1e3:.3f} ms (median of 5)")
    serial, open_loop, futs, launches, depths = drive(sess, 2.0 / s1)
    check(launches["fused_grouped_bag_interactions"] == sum(depths),
          "the grouped kernel's launch count differs from the sum over "
          "flushes of the resolved depth")
    check(launches["fused_bag_interactions"] == 0,
          "plan=auto launched the single-group kernel")
    queries = submit_queries(cfg)
    want = np.stack([none.serve_direct(q["dense"], q["indices"])
                     for q in queries])
    agree("plan=auto (submit) vs plan=none, same weights",
          np.stack([f.probs for f in futs]), want)
    off = Engine(cfg, plan=sess.plan, fused_serve="off").serve_session(
        max_batch_queries=4, params=sess.params)
    check(off.serve_kernel == "composed", "fused_serve=off is not composed")
    agree("plan=auto composed vs fused",
          off.serve_direct(queries[0]["dense"], queries[0]["indices"]),
          sess.serve_direct(queries[0]["dense"], queries[0]["indices"]))
    del off
    pinned = {k: Engine(cfg, plan=sess.plan, pipeline_depth=k).serve_session(
        max_batch_queries=4, params=sess.params, warmup=True)
        for k in (1, 2, 4)}
    big = {k: torch.cat([q[k] for q in queries]) for k in queries[0]}
    want = sess.serve_direct(big["dense"], big["indices"])
    for k, other in pinned.items():
        agree(f"plan=auto depth {k} vs planner depth, 4 queries",
              other.serve_direct(big["dense"], big["indices"]), want)
    # the cost of the planner's depth choice, closed loop: each depth twice,
    # in turns (1, 2, 4, planner, planner, 4, 2, 1)
    order = [(f"depth {k}", s) for k, s in pinned.items()] + [
        (f"planner depth {depth1}", sess)]
    for label, s in order + order[::-1]:
        rep = s.run_serial(16)
        print(f"[auto] closed loop, {label}: 16 queries p50 "
              f"{rep.p50_ms:.4f} ms p99 {rep.p99_ms:.4f} ms")
    peak_line("phase 4 (plan=auto main path; two table copies resident)")
    return sess, pinned[1], dict(launches=launches, serial=serial,
                                 open_loop=open_loop, depths=depths)


def phase_interleaved(none, auto_plan):
    """A concrete ShardingPlan with interleaved tiers (even tables fast)
    on the same weights: it must agree with plan=none."""
    from repro_torch.core.planner import TablePlacement
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops

    cfg = none.cfg
    plan = dataclasses.replace(auto_plan, placements=tuple(
        TablePlacement(t, "fast", "table_wise", 0) if t % 2 == 0
        else TablePlacement(t, "bulk", "row_wise", None)
        for t in range(cfg.num_tables)))
    sess = Engine(cfg, plan=plan).serve_session(max_batch_queries=4,
                                                params=none.params)
    check(sess.serve_kernel == "fused", f"serve_kernel={sess.serve_kernel}")
    queries = submit_queries(cfg)
    big = {k: torch.cat([q[k] for q in queries]) for k in queries[0]}
    ops.reset_launch_counts()
    got = sess.serve_direct(big["dense"], big["indices"])
    n = ops.launch_counts["fused_grouped_bag_interactions"]
    check(n == sess.depth_for_samples(4 * cfg.batch_size),
          f"interleaved plan: {n} grouped launches")
    agree("interleaved ShardingPlan vs plan=none, 4 queries", got,
          none.serve_direct(big["dense"], big["indices"]))
    del sess
    peak_line("phase 4b (interleaved ShardingPlan)")


def phase_row_wise_serve(none, card):
    """Phase 4c: ``dlrm-rm2-small-sharded`` (row-wise sharding at n=1) on
    phase 3's tables, under plan="none" in both wire modes: 4 submitted
    queries each, composed, no kernel launched, probs equal to the
    table-wise session's; then closed-loop p50 beside the table-wise
    composed path (fused_serve="off"), in turns."""
    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.parallel import RowWiseExchange

    t0 = time.perf_counter()
    cfg = get_dlrm(ROW_WISE_CONFIG)
    def widths(c):
        return (c.num_tables, c.rows_per_table, c.embed_dim,
                c.lookups_per_table, c.batch_size, c.num_dense)

    check(cfg.sharding == "row_wise" and widths(cfg) == widths(none.cfg),
          f"{cfg.name} is not phase 3's widths, row-wise")
    torch.cuda.reset_peak_memory_stats()
    queries = submit_queries(cfg)
    want = np.stack([none.serve_direct(q["dense"], q["indices"])
                     for q in queries])
    sessions = {}
    for mode in ROW_WISE_MODES:
        sess = Engine(cfg, exchange=mode).serve_session(
            max_batch_queries=4, params=none.params)
        check(isinstance(sess.exchange, RowWiseExchange)
              and sess.exchange.mode == mode,
              f"{mode}: the session's exchange is {sess.exchange}")
        check(sess.serve_kernel == "composed",
              f"{mode}: serve_kernel={sess.serve_kernel}")
        check(sess.params["tables"] is none.params["tables"],
              f"{mode}: the session copied the tables")
        ops.reset_launch_counts()
        futs = [sess.submit(q, now=i * 1e-4) for i, q in enumerate(queries)]
        torch.cuda.synchronize()
        launches = dict(ops.launch_counts)
        check(all(f.done for f in futs), f"{mode}: queries left pending")
        check(not any(launches.values()),
              f"{mode}: row-wise serving launched {launches}")
        got = np.stack([f.probs for f in futs])
        err = float(np.abs(got - want).max())
        print(f"[row-wise] {cfg.name} exchange={mode}: 4 queries in one "
              f"flush at depth {sess.depth_for_samples(4 * cfg.batch_size)}"
              f", serve_kernel={sess.serve_kernel}, launches {launches}; "
              f"probs vs the table-wise session max_abs_err={err:.3e}")
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"{mode}: probs not finite of shape {want.shape}")
        check(np.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"{mode}: row-wise and table-wise probs disagree")
        sessions[f"row-wise {mode}"] = sess
    sessions["table-wise composed"] = Engine(
        none.cfg, fused_serve="off").serve_session(max_batch_queries=4,
                                                   params=none.params)
    order = list(sessions.items())
    p50 = {label: [] for label in sessions}
    for label, sess in order + order[::-1]:
        rep = sess.run_serial(8)
        p50[label].append(rep.p50_ms)
    for label, sess in sessions.items():
        profile_flushes(sess, label)
    for label, sess in sessions.items():
        print(f"[row-wise] closed loop, {label} (depth "
              f"{sess.depth_for_samples(cfg.batch_size)} at 1 query): 8 "
              f"queries twice, p50 {p50[label][0]:.4f} and "
              f"{p50[label][1]:.4f} ms ({card})")
    del sessions, order
    peak_line(f"phase 4c (row-wise serving on phase 3's tables; "
              f"{time.perf_counter() - t0:.1f} s)")
    return p50


# ---------------------------------------------------------------- phase 5
def library_pairs(bot, pooled, li, lj):
    """torch.bmm + the tril gather: the interaction's library yardstick,
    timed here and never called by the port."""
    a = torch.cat([bot[:, None, :], pooled], dim=1).float()
    f = torch.bmm(a, a.transpose(1, 2))
    return torch.cat([bot.float(), f[:, li, lj]], dim=1)


def library_version(tables, ids, bot, li, lj):
    """F.embedding_bag(mode="sum") + the interaction's yardstick."""
    return library_pairs(bot, library_bag(tables, ids), li, lj)


def library_bag(tables, ids):
    """One F.embedding_bag(mode="sum") call over the flattened tables."""
    T, R, d = tables.shape
    B, _, L = ids.shape
    t = torch.arange(T, device=ids.device)[None, :, None] * R
    flat = (ids.long() + t).view(B * T, L)
    return torch.nn.functional.embedding_bag(
        flat, tables.view(T * R, d), mode="sum").view(B, T, d)


def library_grouped(tf, tb, ids, bot, inv, li, lj):
    """Per-group F.embedding_bag, cat, index_select(inv_perm), bmm and the
    tril gather: the grouped kernel's library yardstick."""
    n = tf.shape[0]
    pooled = torch.cat([library_bag(tf, ids[:, :n]),
                        library_bag(tb, ids[:, n:])], dim=1)
    return library_pairs(bot, pooled.index_select(1, inv), li, lj)


def distinct_rows(ids, rows_per_table):
    T = ids.shape[1]
    return torch.unique(
        ids.long() + torch.arange(T, device=ids.device)[None, :, None]
        * rows_per_table).numel()


def least_time(nbytes, flops, peak=FP32_FLOP_PER_S):
    """(ms, "bytes" | "operations", bytes, operations): the larger of bytes
    over HBM bandwidth and operations over their type's peak (fp32 by
    default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def bound(tables, ids, bot):
    """Least time for the fused serve work: bytes the function must move
    (the distinct rows these ids touch, the ids, bot_out, the output) over
    HBM bandwidth, against its fp32 operations over the fp32 peak. For the
    grouped kernel ``tables`` is either group (same d and dtype) and the
    row stride is the larger group's."""
    R, d = tables.shape[1], tables.shape[2]
    B, T, L = ids.shape
    pairs = (T + 1) * T // 2
    nbytes = (distinct_rows(ids, R) * d * tables.element_size()
              + ids.numel() * 4 + bot.numel() * 4 + B * (d + pairs) * 4)
    flops = B * T * L * d + B * pairs * 2 * d
    return least_time(nbytes, flops)


def time_ms(fn, n_sets, iters=40):
    for k in range(n_sets):
        fn(k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, n_sets, iters=40, tries=5):
    """(CUDA-event ms a call as ``time_ms`` takes it, device ms a call):
    the second is the sum of the device events' own times (kernels,
    memsets) under torch.profiler over ``iters`` calls, so it leaves out
    the host time between launches, which the first includes where a call
    is shorter than its launch. The profiler loses the first device
    events after a trace starts (on the H100, five 0.2 ms kernels in a
    row), which would read low: each trace runs the ``iters`` calls once
    as a warm-up it throws away, then again, and counts only when each of
    its device events was recorded a whole multiple of ``iters`` times
    (once, or as often, every call). It is asked up to ``tries`` times,
    and the device time is None if no trace is whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    event = time_ms(fn, n_sets, iters)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _warm_then_counted in range(2):
                for i in range(iters):
                    fn(i % n_sets)
                torch.cuda.synchronize()
                prof.step()
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        if device and all(e.count % iters == 0 for e in device):
            busy = sum(e.self_device_time_total for e in device)
            return event, busy / iters / 1e3
        print(f"[time] the profiler recorded "
              f"{ {e.key[:40]: e.count for e in device} } device events "
              f"of {iters} calls: not whole, asked again")
    return event, None


def report_time(name, shape, k_times, p_ms, l_ms, bounds):
    """Print and return one kernel's times (``kernel_ms``) beside the mean
    of its bounds over the input sets (``least_time`` tuples). ``p_ms`` and
    ``l_ms`` may be None where a shape is too large for the plain or
    library version."""
    k_ms, d_ms = k_times
    b_ms = float(np.mean([b[0] for b in bounds]))
    dev, per = ("not measured", k_ms) if d_ms is None else (
        f"{d_ms:.4f} ms", d_ms)
    nbytes = float(np.mean([b[2] for b in bounds]))
    flops = float(np.mean([b[3] for b in bounds]))
    plain = "not run" if p_ms is None else f"{p_ms:.4f} ms"
    library = "not run" if l_ms is None else f"{l_ms:.4f} ms"
    print(f"[time] {name} {shape}: kernel {k_ms:.4f} ms (device {dev}), "
          f"bound {b_ms:.4f} ms ({bounds[0][1]}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP; {b_ms / per:.1%} of the "
          f"{'kernel' if d_ms is None else 'device'} time), plain {plain}, "
          f"library {library}; rate {nbytes / per / 1e9:.3f} TB/s, "
          f"{flops / per / 1e9:.3f} TFLOP/s")
    return dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=b_ms, bound_by=bounds[0][1], shape=shape)


BATCHES = (25, 100, 200, 800)


def phase_timing(none, auto, dev):
    """Both serve kernels at the main path's shapes: B=25 and 100 are the
    micro-batches of a 1- and a 4-query flush at the planner's depth 8,
    B=200 and 800 the whole query and capacity batch. 8 input sets in
    turn: 8 x 82 MB of rows at B=200 overflow the 50 MB L2, so each
    launch finds its rows cold, as a new query does."""
    from repro_torch.kernels import fused_serve, ref
    from repro_torch.parallel import plan_table_groups
    tables = none.params["tables"]
    tf, tb = auto.params["tables_fast"], auto.params["tables_bulk"]
    groups = plan_table_groups(auto.plan, 1)
    inv = torch.as_tensor(groups.inv_perm, device=dev)
    perm = torch.as_tensor(groups.fast_ids + groups.bulk_ids, device=dev)
    pos = fused_serve.grouped_pos(groups.inv_perm, dev)
    T, R, d = tables.shape
    L = none.cfg.lookups_per_table
    li, lj = torch.tril_indices(T + 1, T + 1, offset=-1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    rows = {"fused_bag_interactions": {},
            "fused_grouped_bag_interactions": {}}
    for B in BATCHES:
        sets = [draw_case(B, T, L, d, R, tables.dtype, gen, dev, tables)[1:]
                for _ in range(8)]
        gsets = [(ids.index_select(1, perm), bot) for ids, bot in sets]
        shape = f"B={B} T={T} L={L} d={d} R={R} fp32"
        want = ref.fused_bag_interactions_ref(tables, *sets[0])
        check(torch.allclose(library_version(tables, *sets[0], li, lj), want,
                             rtol=RTOL, atol=ATOL),
              "library yardstick disagrees with the plain version")
        check(torch.allclose(library_grouped(tf, tb, *gsets[0], inv, li, lj),
                             want, rtol=RTOL, atol=ATOL),
              "grouped library yardstick disagrees with the plain version")
        rows["fused_bag_interactions"][B] = report_time(
            "fused_bag_interactions", shape,
            kernel_ms(lambda k: fused_serve.fused_bag_interactions(
                tables, *sets[k]), len(sets)),
            time_ms(lambda k: ref.fused_bag_interactions_ref(
                tables, *sets[k]), len(sets), iters=16),
            time_ms(lambda k: library_version(tables, *sets[k], li, lj),
                    len(sets), iters=16),
            [bound(tables, *s) for s in sets])
        rows["fused_grouped_bag_interactions"][B] = report_time(
            "fused_grouped_bag_interactions",
            f"B={B} Tf={tf.shape[0]} Tb={tb.shape[0]} L={L} d={d} R={R} "
            f"fp32",
            kernel_ms(lambda k: fused_serve.fused_grouped_bag_interactions(
                tf, tb, *gsets[k], pos), len(gsets)),
            time_ms(lambda k: ref.fused_grouped_bag_interactions_ref(
                tf, tb, *gsets[k], groups.inv_perm), len(gsets), iters=16),
            time_ms(lambda k: library_grouped(tf, tb, *gsets[k], inv, li,
                                              lj), len(gsets), iters=16),
            [bound(tf, *s) for s in gsets])
    peak_line("phase 5 (serve kernel timing)")
    return rows


def whole_profile(run, n, tries=5, cpu=True):
    """torch.profiler over ``run(n)`` (n flushes or steps), the way
    ``kernel_ms`` counts: each trace runs ``run(n)`` once as a warm-up it
    throws away, then again, and counts only when each of its device
    events was recorded a whole multiple of ``n`` times (the profiler
    drops events now and then, and a trace that lost some reads low).
    Asked up to ``tries`` times. Returns (run's own result, wall ms of
    the counted run, device busy ms, the profiler's events, device events
    by time) or None if no trace is whole. ``cpu=False`` records device
    events alone (a run of ~10^5 host ops traces in a fraction of the
    time) and sums them by name from the trace's own event list
    (``device_totals``; the profiler's events are then None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    for _ in range(tries):
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _warm_then_counted in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = run(n)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                prof.step()
        events = prof.key_averages() if cpu else None
        device = sorted((e for e in (events if cpu else device_totals(prof))
                         if e.device_type == DeviceType.CUDA
                         and not e.key.startswith("ProfilerStep")),
                        key=lambda e: -e.self_device_time_total)
        if device and all(e.count % n == 0 for e in device):
            busy = sum(e.self_device_time_total for e in device) / 1e3
            return result, wall, busy, events, device
        print(f"[profile] the profiler recorded "
              f"{ {e.key[:40]: e.count for e in device} } device events "
              f"over {n} runs: not whole, asked again")
    return None


DeviceEvents = collections.namedtuple(
    "DeviceEvents", "key device_type count self_device_time_total")


def device_totals(prof):
    """A trace's events summed by name and device, as ``key_averages``
    sums kernels (count, total µs), read from the trace's own event list:
    ``key_averages`` builds an event tree first, ~15 s of host time for
    ~10^5 events."""
    sums = {}
    for e in prof.profiler.kineto_results.events():
        got = sums.setdefault((e.name(), e.device_type()), [0, 0])
        got[0] += 1
        got[1] += e.duration_ns()
    return [DeviceEvents(name, kind, count, ns / 1e3)
            for (name, kind), (count, ns) in sums.items()]


def profile_flushes(sess, label, table=False, n=5):
    """torch.profiler over ``n`` capacity flushes (whole traces only,
    ``whole_profile``): device time by kernel, and the share of the
    flush's service time the device was busy."""
    qs = submit_queries(sess.cfg)
    sess._execute(qs)
    samples = len(qs) * sess.query_size
    got = whole_profile(
        lambda k: sum(sess._execute(qs)[1] for _ in range(k)), n)
    if got is None:
        print(f"[profile] {label}: capacity flush ({samples} samples, "
              f"depth {sess.depth_for_samples(samples)}): device busy not "
              f"measured (no whole trace in 5)")
        return
    service, _, busy, events, kernels = got
    if table:
        print(events.table(sort_by="cuda_time_total", row_limit=15))
    busy /= n
    flush = service / n * 1e3
    print(f"[profile] {label}: capacity flush ({samples} samples, depth "
          f"{sess.depth_for_samples(samples)}) service {flush:.4f} ms, "
          f"device busy {busy:.4f} ms ({busy / flush:.0%}), idle "
          f"{max(flush - busy, 0.0):.4f} ms")
    for e in kernels[:5]:
        print(f"[profile]   {e.self_device_time_total / n / 1e3:.4f} ms a "
              f"flush, {e.count // n} launches: {e.key[:80]}")


# ---------------------------------------------------------------- phase 6
def tiered_stream(cfg, dev):
    """The 4 batches of the alpha = 1.05 stream that phase 6 looks up, and
    uniform ids of the same shape."""
    from repro_torch.data.recsys import make_recsys_batch
    stream = [make_recsys_batch(cfg, 10 + s, 0, TIERED_ALPHA)["indices"]
              for s in range(4)]
    uniform = torch.randint(0, cfg.rows_per_table, stream[0].shape,
                            device=dev, dtype=torch.int32,
                            generator=torch.Generator(device=dev)
                            .manual_seed(7))
    return stream, uniform


def cached_bag_cases(name, fast, bulk, fast_idx, bulk_idx, gen, errs):
    """Row 6 on the tiers it serves, from the slots ``fast_idx`` and
    ``bulk_idx``: nine lookups in ten at both pad slots, slots at S and R
    and counted from the end (-1 is the pad), and ids out of range on
    either side (NaN). ``bulk`` is (T, R+1, d), or (R+1, d) shared by every
    table."""
    from repro_torch.kernels import embedding_bags, ref
    T, S1, _ = fast.shape
    R1 = bulk.shape[-2]
    every = bulk if bulk.dim() == 3 else bulk[None].expand(T, -1, -1)

    def held(tag, fi, bi, nan_ok=False):
        close("cached_embedding_bag", f"{name}, {tag}",
              embedding_bags.cached_embedding_bag(fast, bulk, fi, bi),
              ref.cached_embedding_bag_ref(fast, every, fi, bi), errs, nan_ok)

    pad = torch.rand(fast_idx.shape, generator=gen,
                     device=fast_idx.device) < 0.9
    held("nine lookups in ten at both pads",
         torch.where(pad, S1 - 1, fast_idx).int(),
         torch.where(pad, R1 - 1, bulk_idx).int())
    fi, bi = fast_idx.clone(), bulk_idx.clone()
    fi[:, :, 0], bi[:, :, 1] = S1 - 1, R1 - 1
    fi[:, :, 2], bi[:, :, 3] = -1, -1
    fi[:, :, 4], bi[:, :, 5] = 1 - S1, 2 - R1
    held("ids at S and R and counted from the end", fi, bi)
    fi[0, 0, 6], bi[1, -1, 7], bi[-1, 0, 0] = S1, -R1 - 1, R1
    held("ids out of range", fi, bi, nan_ok=True)


def bag_edge_cases(kernel, gen, dev, errs):
    """``kernel`` ("embedding_bag", "cached_embedding_bag" or its shared
    form "cached_embedding_bag shared") on small tables of the dtypes and
    widths the main path does not take: bf16 (8-byte loads), d = 30 and
    tables 4 bytes off alignment (scalar loads), d = 20 (five 16-byte
    vectors a row), every pad row non-zero; half the lookups at the pad
    slots, then the cases of ``cached_bag_cases`` (row 6) or ids counted
    from the end and out of range (row 4)."""
    from repro_torch.kernels import embedding_bags, ref
    B, T, L, S, R = 16, 5, 80, 9, 300
    for d, dtype, off in ((32, torch.bfloat16, 0), (30, torch.float32, 0),
                          (30, torch.bfloat16, 0), (20, torch.float32, 0),
                          (32, torch.float32, 1)):
        name = (f"B={B} T={T} L={L} d={d} {str(dtype)[6:]}"
                + " tables 4 bytes off alignment" * off)

        def draw(*shape):                # at the model's init scale
            buf = torch.empty((off + math.prod(shape),), device=dev).uniform_(
                -R ** -0.5, R ** -0.5, generator=gen).to(dtype)
            return buf[off:].view(shape)

        bulk, fast = draw(T, R + 1, d), draw(T, S + 1, d)
        hot = torch.rand((B, T, L), generator=gen, device=dev) < 0.5
        fi = torch.where(hot, torch.randint(0, S, (B, T, L), generator=gen,
                                            device=dev), S).int()
        bi = torch.where(hot, R, torch.randint(0, R, (B, T, L), generator=gen,
                                               device=dev)).int()
        if kernel == "embedding_bag":
            close(kernel, f"{name}, half the ids at row R",
                  embedding_bags.embedding_bag(bulk, bi),
                  ref.embedding_bag_ref(bulk, bi), errs)
            bi[0, 0, 0], bi[1, 1, 1] = -1, 1 - R
            bi[2, 2, 2], bi[3, 3, 3] = R + 1, -R - 2
            close(kernel, f"{name}, ids counted from the end and out of "
                          f"range", embedding_bags.embedding_bag(bulk, bi),
                  ref.embedding_bag_ref(bulk, bi), errs, nan_ok=True)
            continue
        if kernel.endswith("shared"):
            bulk = bulk[1]                       # keeps the offset
        close("cached_embedding_bag", f"{name}, half the lookups hot",
              embedding_bags.cached_embedding_bag(fast, bulk, fi, bi),
              ref.cached_embedding_bag_ref(
                  fast, bulk if bulk.dim() == 3
                  else bulk[None].expand(T, -1, -1), fi, bi), errs)
        cached_bag_cases(name, fast, bulk, fi, bi, gen, errs)


def phase_tiered(tables, cfg, dev):
    """Phase 6a: the tiered runtime at full width on the plan=none
    session's weights, through the cached-bag kernel. The other serve
    sessions are gone; the store is returned for phases 7a and 6b."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.data.recsys import make_recsys_batch
    from repro_torch.kernels import embedding_bags, ops, ref

    R = tables.shape[1]
    t0 = time.perf_counter()
    counts = te.measure_row_freq(cfg, TIERED_ALPHA, seed=0, n_batches=4,
                                 device=dev)
    store = te.build_tiered_tables(tables, counts, HOT_PER_TABLE)
    torch.cuda.synchronize()
    print(f"[tiered] store built in {time.perf_counter() - t0:.2f} s: fast "
          f"{tuple(store.fast.shape)}, bulk {tuple(store.bulk.shape)}, "
          f"row_map {tuple(store.row_map.shape)}; expected hit ratio "
          f"{te.expected_hit_ratio(counts, store):.4f}")
    check(torch.equal(store.bulk[:, :R], tables),
          "the bulk tier does not hold the tables")
    stream, uniform = tiered_stream(cfg, dev)
    hits = float(torch.stack([te.hit_mask(store, i) for i in stream])
                 .float().mean())
    print(f"[tiered] measured hit ratio on 4 batches of the alpha="
          f"{TIERED_ALPHA} stream: {hits:.4f}")
    wants = [ref.embedding_bag_ref(tables, i) for i in stream]
    errs = {}
    ops.reset_launch_counts()
    pools = [te.tiered_embedding_bag(store, i) for i in stream]
    launches = {"cached_embedding_bag":
                ops.launch_counts["cached_embedding_bag"]}
    for k, (got, want) in enumerate(zip(pools, wants)):
        close("tiered_embedding_bag", f"batch {k} vs embedding_bag_ref",
              got, want, errs)
    check(launches["cached_embedding_bag"] == 4,
          f"{launches} cached-bag launches for 4 batches")
    for tag, ids in ((f"alpha={TIERED_ALPHA}", stream[0]),
                     ("uniform", uniform)):
        fi, bi = te.translate_indices(store, ids)
        close("cached_embedding_bag", f"B=200 {tag} ids, S={HOT_PER_TABLE}",
              embedding_bags.cached_embedding_bag(store.fast, store.bulk, fi,
                                                  bi),
              ref.cached_embedding_bag_ref(store.fast, store.bulk, fi, bi),
              errs)
    gen = torch.Generator(device=dev).manual_seed(66)
    cached_bag_cases(f"B=200 alpha={TIERED_ALPHA} ids on the store",
                     store.fast, store.bulk,
                     *te.translate_indices(store, stream[1]), gen, errs)
    bag_edge_cases("cached_embedding_bag", gen, dev, errs)
    sets = [te.translate_indices(store, make_recsys_batch(
        cfg, 100 + s, 0, TIERED_ALPHA)["indices"]) for s in range(8)]
    times = {"cached_embedding_bag": time_b6(store, sets)}
    peak_line("phase 6a (tiered store, cached bag)")
    return store, (launches, times, {k: max(v) for k, v in errs.items()})


def phase_packed(store, cfg, dev):
    """Phase 6b: the store packed into one array a table, looked up
    through the embedding-bag kernel; the stacked tables are gone."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.data.recsys import make_recsys_batch
    from repro_torch.kernels import embedding_bags, ops, ref

    R = cfg.rows_per_table
    stream, uniform = tiered_stream(cfg, dev)
    errs = {}
    packed = te.packed_tables(store)
    bulk_view = store.bulk[:, :R]
    ops.reset_launch_counts()
    pools = [te.tiered_embedding_bag_packed(packed, store, i) for i in stream]
    launches = {"embedding_bag": ops.launch_counts["embedding_bag"]}
    for k, (got, ids) in enumerate(zip(pools, stream)):
        close("tiered_embedding_bag_packed",
              f"batch {k} vs embedding_bag_ref", got,
              ref.embedding_bag_ref(bulk_view, ids), errs)
    check(launches["embedding_bag"] == 4,
          f"{launches} embedding-bag launches for 4 batches")
    for tag, ids in ((f"alpha={TIERED_ALPHA}", stream[0]),
                     ("uniform", uniform)):
        phys = te.translate_indices_packed(store, ids)
        close("embedding_bag", f"B=200 {tag} ids on the packed store",
              embedding_bags.embedding_bag(packed, phys),
              ref.embedding_bag_ref(packed, phys), errs)
    # the packed store's pad rows: S (the fast tier's) and S+1+R (the
    # bulk tier's), nine lookups in ten; ids at them and counted from the
    # end; ids out of range
    S, rows = store.hot_slots, packed.shape[1]
    gen = torch.Generator(device=dev).manual_seed(67)
    phys = te.translate_indices_packed(store, stream[1])
    pad = torch.rand(phys.shape, generator=gen, device=dev)
    mostly = torch.where(pad < 0.45, S, torch.where(pad < 0.9, rows - 1,
                                                    phys)).int()
    at = phys.clone()
    at[:, :, 0], at[:, :, 1], at[:, :, 2] = S, rows - 1, -1
    out = at.clone()
    out[0, 0, 3], out[1, -1, 4] = rows, -rows - 1
    for tag, ids, nan_ok in (("nine ids in ten at the pad rows", mostly,
                              False),
                             ("ids at the pad rows S and S+1+R and -1", at,
                              False),
                             ("ids out of range", out, True)):
        close("embedding_bag", f"B=200 packed store, {tag}",
              embedding_bags.embedding_bag(packed, ids),
              ref.embedding_bag_ref(packed, ids), errs, nan_ok)
    bag_edge_cases("embedding_bag", gen, dev, errs)
    psets = [te.translate_indices_packed(store, make_recsys_batch(
        cfg, 100 + s, 0, TIERED_ALPHA)["indices"]) for s in range(8)]
    times = {"embedding_bag": time_b4(packed, psets)}
    print(f"[tiered] launches {launches} (4 batches)")
    peak_line("phase 6b (packed store, embedding bag)")
    return launches, times, {k: max(v) for k, v in errs.items()}


def library_cached(fast, bulk, fast_idx, bulk_idx):
    """Two F.embedding_bag(mode="sum") calls, one a tier (the shared tier
    read at its positions directly), added: the cached bag's yardstick."""
    if bulk.dim() == 3:
        cold = library_bag(bulk, bulk_idx)
    else:
        B, T, L = bulk_idx.shape
        cold = torch.nn.functional.embedding_bag(
            bulk_idx.view(B * T, L), bulk, mode="sum").view(B, T, -1)
    return library_bag(fast, fast_idx) + cold


def time_b6(store, sets):
    """Row 6 on ``store.fast`` and ``store.bulk`` (a (T, R+1, d) tier, or
    the (R+1, d) tier every table shares) beside its bound: the distinct
    rows the slots touch (per table, or over the shared tier), the ids
    and the output."""
    from repro_torch.kernels import embedding_bags, ref
    fast, bulk = store.fast, store.bulk
    B, T, L = sets[0][0].shape
    d = fast.shape[2]
    every = bulk if bulk.dim() == 3 else bulk[None].expand(T, -1, -1)
    want = ref.cached_embedding_bag_ref(fast, every, *sets[0])
    check(torch.allclose(library_cached(fast, bulk, *sets[0]), want,
                         rtol=RTOL, atol=ATOL),
          "cached-bag library yardstick disagrees with the plain version")
    del want
    bounds = []
    for fi, bi in sets:
        cold = (distinct_rows(bi, bulk.shape[1]) if bulk.dim() == 3
                else torch.unique(bi).numel())
        rows = distinct_rows(fi, fast.shape[1]) + cold
        nbytes = (rows * d * fast.element_size() + 2 * fi.numel() * 4
                  + B * T * d * 4)
        bounds.append(least_time(nbytes, 2 * B * T * L * d))
    bulk_shape = (f"R+1={bulk.shape[1]}" if bulk.dim() == 3 else
                  f"one shared tier of {bulk.shape[0]} rows")
    return report_time(
        "cached_embedding_bag",
        f"B={B} T={T} L={L} d={d} S+1={fast.shape[1]} {bulk_shape} fp32",
        kernel_ms(lambda k: embedding_bags.cached_embedding_bag(
            fast, bulk, *sets[k]), len(sets)),
        time_ms(lambda k: ref.cached_embedding_bag_ref(fast, every,
                                                       *sets[k]),
                len(sets), iters=16),
        time_ms(lambda k: library_cached(fast, bulk, *sets[k]), len(sets),
                iters=16),
        bounds)


def time_b4(packed, sets):
    from repro_torch.kernels import embedding_bags, ref
    B, T, L = sets[0].shape
    d = packed.shape[2]
    check(torch.allclose(library_bag(packed, sets[0]),
                         ref.embedding_bag_ref(packed, sets[0]), rtol=RTOL,
                         atol=ATOL),
          "embedding-bag library yardstick disagrees with the plain version")
    bounds = []
    for ids in sets:
        nbytes = (distinct_rows(ids, packed.shape[1]) * d
                  * packed.element_size() + ids.numel() * 4 + B * T * d * 4)
        bounds.append(least_time(nbytes, B * T * L * d))
    return report_time(
        "embedding_bag",
        f"B={B} T={T} L={L} d={d} rows={packed.shape[1]} (packed store) "
        f"fp32, alpha={TIERED_ALPHA} stream",
        kernel_ms(lambda k: embedding_bags.embedding_bag(packed, sets[k]),
                len(sets)),
        time_ms(lambda k: ref.embedding_bag_ref(packed, sets[k]), len(sets),
                iters=16),
        time_ms(lambda k: library_bag(packed, sets[k]), len(sets), iters=16),
        bounds)


# ---------------------------------------------------------------- phase 7
def serve_batches(cfg, first, n):
    """n batches of the alpha = 1.05 stream, 200 samples each, then the
    main path's shapes cut from them: B = 25, 100, 200 from one batch, 800
    from four."""
    from repro_torch.data.recsys import make_recsys_batch
    return [make_recsys_batch(cfg, first + s, 0, TIERED_ALPHA)["indices"]
            for s in range(n)]


def cut(batches, B, k):
    """Input set k of batch size B: a slice of batch k, or four batches."""
    if B <= batches[0].shape[0]:
        return batches[k % len(batches)][:B]
    n = B // batches[0].shape[0]
    return torch.cat([batches[(n * k + j) % len(batches)] for j in range(n)])


def pairs_bound(bot, pooled):
    """Least time of the interaction: bot_out and pooled read once, the
    output written once, against its fp32 operations."""
    B, T, d = pooled.shape
    pairs = (T + 1) * T // 2
    nbytes = (bot.numel() * bot.element_size()
              + pooled.numel() * pooled.element_size() + B * (d + pairs) * 4)
    return least_time(nbytes, B * pairs * 2 * d)


def cached_pairs_bound(fast, bulk, fi, bi, bot):
    """Least time of the two-tier fused op: the distinct rows of each tier
    that the ids touch, both id tensors, bot_out and the output."""
    B, T, L = fi.shape
    d = fast.shape[2]
    pairs = (T + 1) * T // 2
    rows = distinct_rows(fi, fast.shape[1]) + distinct_rows(bi, bulk.shape[1])
    nbytes = (rows * d * fast.element_size() + 2 * fi.numel() * 4
              + bot.numel() * 4 + B * (d + pairs) * 4)
    return least_time(nbytes, 2 * B * T * L * d + B * pairs * 2 * d)


def draw_store(T, S, R, d, dtype, gen, dev):
    """A small two-tier store whose pad slots (S, R) are not zero, so a
    kernel that skipped them would differ from the plain version."""
    fast = torch.empty((T, S + 1, d), device=dev).uniform_(-1, 1,
                                                           generator=gen)
    bulk = torch.empty((T, R + 1, d), device=dev).uniform_(-1, 1,
                                                           generator=gen)
    fast[:, S], bulk[:, R] = 0.5, 0.5
    return fast.to(dtype), bulk.to(dtype)


def phase_api_serve(tables, store, cfg, dev):
    """Phase 7a: the two-tier fused op (row 2) and the interaction op (row
    7) on phase 6's store and the stacked tables it was built from."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.kernels import (embedding_bags, feature_interactions,
                                     fused_serve, ops, ref)
    interactions_kernel = feature_interactions.interactions

    t0 = time.perf_counter()
    T, R, d = tables.shape
    gen = torch.Generator(device=dev).manual_seed(77)
    batches = serve_batches(cfg, 20, 4)
    ids = {B: cut(batches, B, 0) for B in BATCHES}
    tiers = {B: te.translate_indices(store, i) for B, i in ids.items()}
    bots = {B: torch.empty((B, d), device=dev).uniform_(-1, 1, generator=gen)
            for B in BATCHES}
    errs = {}
    ops.reset_launch_counts()
    got2 = {B: ops.fused_cached_bag_interactions(store.fast, store.bulk,
                                                 *tiers[B], bots[B])
            for B in BATCHES}
    pooled = {B: ops.embedding_bag(tables, ids[B]) for B in BATCHES}
    got7 = {B: ops.interactions(bots[B], pooled[B]) for B in BATCHES}
    launches = {k: ops.launch_counts[k]
                for k in ("fused_cached_bag_interactions", "interactions")}
    print(f"[api] launches {launches} (4 batch sizes each)")
    check(launches == {k: len(BATCHES) for k in launches},
          f"{launches}: not one launch a batch size")
    for B in BATCHES:
        shape = f"B={B} T={T} L={ids[B].shape[2]} d={d} S+1=" \
                f"{store.fast.shape[1]} R+1={store.bulk.shape[1]} fp32"
        close("fused_cached_bag_interactions", f"{shape} vs plain", got2[B],
              ref.fused_cached_bag_interactions_ref(
                  store.fast, store.bulk, *tiers[B], bots[B]), errs,
              pairs=(T, d))
        close("fused_cached_bag_interactions",
              f"B={B} vs fused_bag_interactions on the stacked tables",
              got2[B], fused_serve.fused_bag_interactions(tables, ids[B],
                                                          bots[B]),
              errs, pairs=(T, d))
        close("interactions", f"B={B} T={T} d={d} fp32 pooled of the batch",
              got7[B], ref.interactions_ref(bots[B], pooled[B]), errs,
              pairs=(T, d))
        half = pooled[B].bfloat16()
        close("interactions", f"B={B} T={T} d={d} bf16 pooled",
              interactions_kernel(bots[B], half),
              ref.interactions_ref(bots[B], half), errs, pairs=(T, d))
    del got2, got7

    # RM2-large's width, d = 128: rows cut to 262,144 a table for memory,
    # at the model's init scale, looked up with the same batches' ids
    R128 = 262_144
    wide = torch.empty((T, R128, 128), device=dev).uniform_(
        -R ** -0.5, R ** -0.5, generator=gen)
    for B in BATCHES:
        pooled128 = embedding_bags.embedding_bag(wide, ids[B] % R128)
        bot128 = torch.empty((B, 128), device=dev).uniform_(-1, 1,
                                                            generator=gen)
        for p in (pooled128, pooled128.bfloat16()):
            close("interactions", f"B={B} T={T} d=128 {p.dtype}",
                  interactions_kernel(bot128, p),
                  ref.interactions_ref(bot128, p), errs, pairs=(T, 128))
    del wide, pooled128
    interaction_edges(gen, dev, errs)

    # the store in bf16, at the query's B = 200
    B = BATCHES[2]
    fast16, bulk16 = store.fast.bfloat16(), store.bulk.bfloat16()
    close("fused_cached_bag_interactions", f"B={B} bf16 store",
          fused_serve.fused_cached_bag_interactions(fast16, bulk16,
                                                    *tiers[B], bots[B]),
          ref.fused_cached_bag_interactions_ref(fast16, bulk16, *tiers[B],
                                                bots[B]),
          errs, pairs=(T, d))
    del fast16, bulk16
    torch.cuda.empty_cache()
    # edge shapes: d = 128 and 256, non-zero pad rows read and summed, 52 KB
    # of shared memory at T = 100, ids outside a tier read as NaN
    for B, Tn, L, dn, S, Rn in ((16, 8, 4, 128, 9, 50), (8, 4, 8, 256, 5, 64),
                                (4, 100, 2, 128, 3, 20), (37, 3, 5, 32, 4,
                                                          1000)):
        for dtype in (torch.float32, torch.bfloat16):
            fast, bulk = draw_store(Tn, S, Rn, dn, dtype, gen, dev)
            fi = torch.randint(0, S + 1, (B, Tn, L), generator=gen,
                               device=dev, dtype=torch.int32)
            bi = torch.randint(0, Rn + 1, (B, Tn, L), generator=gen,
                               device=dev, dtype=torch.int32)
            bot = torch.empty((B, dn), device=dev).uniform_(-1, 1,
                                                            generator=gen)
            close("fused_cached_bag_interactions",
                  f"B={B} T={Tn} L={L} d={dn} S={S} R={Rn} pad rows 0.5 "
                  f"{dtype}",
                  fused_serve.fused_cached_bag_interactions(fast, bulk, fi,
                                                            bi, bot),
                  ref.fused_cached_bag_interactions_ref(fast, bulk, fi, bi,
                                                        bot),
                  errs, pairs=(Tn, dn))
    fi[0, 0, 0], bi[1, 1, 1], bi[2, 2, 2] = -1, Rn + 1, -(Rn + 2)
    close("fused_cached_bag_interactions",
          "out-of-range ids read as jnp.take does",
          fused_serve.fused_cached_bag_interactions(fast, bulk, fi, bi, bot),
          ref.fused_cached_bag_interactions_ref(fast, bulk, fi, bi, bot),
          errs, nan_ok=True, pairs=(Tn, dn))
    cached_slot_pairs(gen, dev, errs)
    times = time_api_serve(tables, store, cfg, dev)
    peak_line(f"phase 7a (kernels API: two-tier fused op, interaction; "
              f"{time.perf_counter() - t0:.1f} s)")
    return launches, times, {k: max(v) for k, v in errs.items()}


def interaction_edges(gen, dev, errs):
    """Row 7 at the edges of its design, every fp32/bf16 mix of bot_out
    and pooled: B = 1, batches that do not split evenly over the blocks
    (397, 801), T = 1 (one pair) and T = 100 (5,050), d = 33 (a row of
    partial chunks), 4 (one chunk: a tile's second lane adds zeros), 8
    and 256, and at T = 100 d = 320 (bf16 raw cells beside A) and 544 (the
    largest d there: raw cells and the staged row do not fit, so scalar
    loads and stores from registers), and d = 1,312 at T = 40 (the
    largest there); then pooled (and bot_out) at an odd
    element offset of a larger buffer, off 16-byte alignment. bot_out is
    drawn U(+-1) and pooled U(+-0.05), the scale of the main path's
    inputs (RTOL's note): at N(0, 1) inputs and d = 256 the fp32
    summation order alone moves a pair by ~4e-5."""
    from repro_torch.kernels import feature_interactions, ref
    dts = (torch.float32, torch.bfloat16)

    def draw(*shape, scale):
        return torch.empty(shape, device=dev).uniform_(-scale, scale,
                                                       generator=gen)

    for B, Tn, dn in ((1, 40, 32), (397, 40, 32), (801, 40, 128), (5, 1, 32),
                      (1, 1, 8), (3, 2, 8), (16, 100, 128), (2, 100, 256),
                      (7, 40, 33), (9, 40, 256), (3, 40, 4), (2, 100, 320),
                      (2, 100, 544), (1, 40, 1312)):
        x = draw(B, Tn, dn, scale=0.05)
        bot = draw(B, dn, scale=1.0)
        for bdt in dts:
            for pdt in dts:
                close("interactions", f"B={B} T={Tn} d={dn} bot_out "
                      f"{str(bdt)[6:]} pooled {str(pdt)[6:]}",
                      feature_interactions.interactions(bot.to(bdt),
                                                        x.to(pdt)),
                      ref.interactions_ref(bot.to(bdt), x.to(pdt)), errs,
                      pairs=(Tn, dn))
    for B, Tn, dn in ((25, 40, 32), (800, 40, 32), (3, 100, 128)):
        for pdt in dts:
            buf = draw(B * Tn * dn + 3, scale=0.05).to(pdt)
            x = buf[1:1 + B * Tn * dn].view(B, Tn, dn)
            bbuf = draw(B * dn + 1, scale=1.0)
            for bot in (bbuf[:B * dn].view(B, dn), bbuf[1:].view(B, dn)):
                check(x.data_ptr() % 4 == 2 if pdt == torch.bfloat16
                      else x.data_ptr() % 16 == 4, "pooled is aligned")
                close("interactions", f"B={B} T={Tn} d={dn} pooled "
                      f"{str(pdt)[6:]} at an odd element offset, bot_out "
                      f"at {bot.data_ptr() % 16} bytes off 16",
                      feature_interactions.interactions(bot, x),
                      ref.interactions_ref(bot, x), errs, pairs=(Tn, dn))


def cached_slot_pairs(gen, dev, errs):
    """Row 2 on hand-made (fast, bulk) slot pairs, one for each branch of
    its two-tier pool, on non-zero pad rows: one real row beside the other
    tier's pad (both ways), both pads, both rows real, slots counted from
    the end (pads and real rows); then a slot out of range in either tier
    (NaN). At the cluster split's edges T = 3, 37 and 100, and T = 40 at
    d = 128 and in bf16."""
    from repro_torch.kernels import fused_serve, ref
    S, R = 6, 50
    pairs = [(1, R), (S, 5), (S, R), (2, 7), (-1, -1), (-2, -(R + 1)),
             (-(S + 1), R), (0, R - 1)]
    for B, T, d, dtype in ((5, 3, 32, torch.float32),
                           (3, 37, 32, torch.float32),
                           (2, 100, 32, torch.bfloat16),
                           (4, 40, 128, torch.float32)):
        fast, bulk = draw_store(T, S, R, d, dtype, gen, dev)
        fi, bi = (torch.tensor([x[k] for x in pairs], dtype=torch.int32,
                               device=dev).repeat(B, T, 1) for k in (0, 1))
        bot = torch.empty((B, d), device=dev).uniform_(-1, 1, generator=gen)
        name = f"B={B} T={T} d={d} {str(dtype)[6:]} hand-made slot pairs"
        close("fused_cached_bag_interactions", name,
              fused_serve.fused_cached_bag_interactions(fast, bulk, fi, bi,
                                                        bot),
              ref.fused_cached_bag_interactions_ref(fast, bulk, fi, bi, bot),
              errs, pairs=(T, d))
        fi[0, T - 1, 3], bi[B - 1, 0, 1] = S + 1, -(R + 2)
        close("fused_cached_bag_interactions", f"{name}, out of range",
              fused_serve.fused_cached_bag_interactions(fast, bulk, fi, bi,
                                                        bot),
              ref.fused_cached_bag_interactions_ref(fast, bulk, fi, bi, bot),
              errs, nan_ok=True, pairs=(T, d))


def time_api_serve(tables, store, cfg, dev):
    """Rows 2 and 7 at the main path's batch sizes, 8 input sets in turn
    (at B >= 200 their rows overflow the 50 MB L2)."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.kernels import (embedding_bags, feature_interactions,
                                     fused_serve, ref)
    interactions_kernel = feature_interactions.interactions
    T, _, d = tables.shape
    fast, bulk = store.fast, store.bulk
    li, lj = torch.tril_indices(T + 1, T + 1, offset=-1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(78)
    batches = serve_batches(cfg, 200, 16)
    rows = {"fused_cached_bag_interactions": {}, "interactions": {}}
    for B in BATCHES:
        sets = []
        for k in range(8):
            fi, bi = te.translate_indices(store, cut(batches, B, k))
            bot = torch.empty((B, d), device=dev).uniform_(-1, 1,
                                                           generator=gen)
            sets.append((fi, bi, bot))
        want = ref.fused_cached_bag_interactions_ref(fast, bulk, *sets[0])
        check(torch.allclose(library_pairs(
            sets[0][2], library_bag(fast, sets[0][0])
            + library_bag(bulk, sets[0][1]), li, lj), want, rtol=RTOL,
            atol=ATOL),
            "two-tier library yardstick disagrees with the plain version")
        shape = f"B={B} T={T} L={sets[0][0].shape[2]} d={d} " \
                f"S+1={fast.shape[1]} R+1={bulk.shape[1]} fp32, " \
                f"alpha={TIERED_ALPHA} stream"
        rows["fused_cached_bag_interactions"][B] = report_time(
            "fused_cached_bag_interactions", shape,
            kernel_ms(lambda k: fused_serve.fused_cached_bag_interactions(
                fast, bulk, *sets[k]), len(sets)),
            time_ms(lambda k: ref.fused_cached_bag_interactions_ref(
                fast, bulk, *sets[k]), len(sets), iters=16),
            time_ms(lambda k: library_pairs(
                sets[k][2], library_bag(fast, sets[k][0])
                + library_bag(bulk, sets[k][1]), li, lj), len(sets),
                iters=16),
            [cached_pairs_bound(fast, bulk, *s) for s in sets])
        psets = [(s[2], embedding_bags.embedding_bag(tables, cut(batches, B,
                                                                 k)))
                 for k, s in enumerate(sets)]
        check(torch.allclose(library_pairs(*psets[0], li, lj),
                             ref.interactions_ref(*psets[0]), rtol=RTOL,
                             atol=ATOL),
              "interaction library yardstick disagrees with the plain "
              "version")
        rows["interactions"][B] = report_time(
            "interactions", f"B={B} T={T} d={d} fp32 pooled",
            kernel_ms(lambda k: interactions_kernel(*psets[k]), len(psets)),
            time_ms(lambda k: ref.interactions_ref(*psets[k]), len(psets),
                    iters=16),
            time_ms(lambda k: library_pairs(*psets[k], li, lj), len(psets),
                    iters=16),
            [pairs_bound(*p) for p in psets])
        # the least device time of a launch, beside row 7's at this batch
        floor = kernel_ms(lambda k: feature_interactions.empty_launch(dev), 1)
        rows["interactions"][B]["floor_ms"] = floor[1]
        print(f"[time] interactions B={B}: an empty kernel's device time "
              f"{floor[1]} ms (event {floor[0]:.4f} ms), the floor beside "
              f"row 7's {rows['interactions'][B]['device_ms']} ms")
    # row 7 at RM2-large's width, d = 128, on pooled rows at the model's
    # init scale (RM2-small's tables are d = 32)
    for B in (BATCHES[0], BATCHES[-1]):
        wsets = [(torch.empty((B, 128), device=dev).uniform_(
            -1, 1, generator=gen), torch.empty((B, T, 128), device=dev)
            .uniform_(-0.02, 0.02, generator=gen)) for _ in range(8)]
        rows["interactions"][f"{B}@d128"] = report_time(
            "interactions", f"B={B} T={T} d=128 fp32 pooled",
            kernel_ms(lambda k: interactions_kernel(*wsets[k]), len(wsets)),
            time_ms(lambda k: ref.interactions_ref(*wsets[k]), len(wsets),
                    iters=16),
            time_ms(lambda k: library_pairs(*wsets[k], li, lj), len(wsets),
                    iters=16),
            [pairs_bound(*w) for w in wsets])
    return rows


def attention_pairs(T, S, causal, window):
    """The (query, key) pairs the attention function weighs: those its
    masks keep, and all S keys for a row whose every key is masked."""
    t = np.arange(T)
    lo = np.maximum(0, t - window + 1) if window is not None else 0 * t
    hi = np.minimum(t, S - 1) if causal else np.full(T, S - 1)
    return int(np.where(lo > hi, S, hi - lo + 1).sum())


def attention_bound(q, k, causal, window):
    """Least time of flash attention: q, k, v read and the output written
    once, against 4 hd operations a weighed pair and head (q.k and p.v) at
    the peak of the inputs' type (bf16 on the tensor cores)."""
    B, T, Hq, hd = q.shape
    S = k.shape[1]
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    flops = 4 * B * Hq * hd * attention_pairs(T, S, causal, window)
    return least_time(nbytes, flops, BF16_FLOP_PER_S
                      if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S)


def decode_bound(q, k_cache, lengths):
    """Least time of flash decode: the valid prefix of both caches (all S
    rows where the length is 0), q, lengths and the output, against 4 hd
    operations a row and query head."""
    _, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    n = lengths.clamp(max=S)
    rows = int(torch.where(n <= 0, S, n).sum())
    nbytes = (2 * rows * Hkv * hd * k_cache.element_size()
              + 2 * q.numel() * q.element_size()
              + lengths.numel() * lengths.element_size())
    return least_time(nbytes, 4 * Hq * hd * rows, BF16_FLOP_PER_S
                      if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S)


def close_attention(kernel, name, got, want, errs):
    """Hold an attention output against its plain version: same shape and
    dtype, finite, allclose at the tests' tolerance for the dtype, and each
    row (the last dim) within ATTN_ROW_TOL of its own norm."""
    torch.cuda.synchronize()
    tol, row_tol = ATTN_TOL[want.dtype], ATTN_ROW_TOL[want.dtype]
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{kernel} {name}: {tuple(got.shape)} {got.dtype}, want "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{kernel} {name}: not finite")
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    ok = bool(torch.allclose(g, w, rtol=tol, atol=tol))
    hd = w.shape[-1]
    scaled = ((g - w).reshape(-1, hd).norm(dim=1)
              / w.reshape(-1, hd).norm(dim=1).clamp_min(1e-30)).max().item()
    ok_rows = scaled <= row_tol
    print(f"[kernel] {kernel} {name}: max_abs_err={err:.3e} (tol {tol}) "
          f"row err/scale={scaled:.3e} (limit {row_tol}) "
          f"{'ok' if ok and ok_rows else 'OVER TOLERANCE'}")
    check(ok, f"{kernel} {name}: kernel disagrees with its plain version")
    check(ok_rows, f"{kernel} {name}: a row is off by {scaled:.3e} of its "
                   f"norm (limit {row_tol})")
    record(errs, kernel, err, scaled)


def attention_inputs(B, T, S, Hq, Hkv, hd, dtype, gen, dev):
    return (torch.randn((B, T, Hq, hd), device=dev, generator=gen).to(dtype),
            torch.randn((B, S, Hkv, hd), device=dev, generator=gen).to(dtype),
            torch.randn((B, S, Hkv, hd), device=dev, generator=gen).to(dtype))


def sdpa_attention(q, k, v, causal, window):
    """F.scaled_dot_product_attention with enable_gqa and a boolean mask:
    the library yardstick, timed here and never called by the port."""
    T, S = q.shape[1], k.shape[1]
    t = torch.arange(T, device=q.device)[:, None]
    s = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= s <= t
    if window is not None:
        ok &= t - s < window
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=ok, enable_gqa=True).transpose(1, 2)


def sdpa_attention_expanded(q, k, v, causal, window):
    """The library yardstick where ``sdpa_attention`` does not fit (T = S
    = 32,768: enable_gqa with a mask takes the math path, whose Hq x T x S
    fp32 scores are 137 GB): K and V repeated to the query heads, then one
    F.scaled_dot_product_attention with the boolean mask on the
    memory-efficient backend. Timed here, never called by the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    T, S = q.shape[1], k.shape[1]
    G = q.shape[2] // k.shape[2]
    t = torch.arange(T, device=q.device)[:, None]
    s = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= s <= t
    if window is not None:
        ok &= t - s < window
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.repeat_interleave(G, 2).transpose(1, 2),
            v.repeat_interleave(G, 2).transpose(1, 2),
            attn_mask=ok).transpose(1, 2)


def sdpa_decode(q, k_cache, v_cache, lengths):
    """The decode yardstick: one query token, the lengths as a mask."""
    S = k_cache.shape[1]
    ok = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        attn_mask=ok[:, None, None], enable_gqa=True)[:, :, 0]


def rows_by_hand(q, k, v, rows, window):
    """Causal windowed attention of a few (b, t, h) rows, computed alone in
    fp32: the check of the prefill_32k output, too large for the plain
    version."""
    hd = q.shape[3]
    G = q.shape[2] // k.shape[2]
    out = []
    for b, t, h in rows:
        lo = max(0, t - window + 1)
        kk = k[b, lo:t + 1, h // G].float()
        s = kk @ q[b, t, h].float() / math.sqrt(hd)
        out.append(torch.softmax(s, 0) @ v[b, lo:t + 1, h // G].float())
    return torch.stack(out)


def phase_api_attention(dev):
    """Phase 7b: flash attention (row 8) and flash decode (row 9) at
    mixtral-8x7b's widths, alone on the card."""
    from repro_torch.kernels import attention, ops, ref
    attention_kernel, decode_kernel = (attention.flash_attention,
                                       attention.flash_decode)
    Hq, Hkv, hd, win = (MIXTRAL[k] for k in ("Hq", "Hkv", "hd", "window"))
    gen = torch.Generator(device=dev).manual_seed(2024)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    errs = {}
    q, k, v = attention_inputs(1, PREFILL_T, PREFILL_T, Hq, Hkv, hd,
                               torch.bfloat16, gen, dev)
    kc, vc = (torch.randn((DECODE_B, DECODE_S, Hkv, hd), device=dev,
                          generator=gen).bfloat16() for _ in range(2))
    dq = torch.randn((DECODE_B, Hq, hd), device=dev, generator=gen).bfloat16()
    lens = torch.randint(1, DECODE_S + 1, (DECODE_B,), generator=gen,
                         device=dev)
    ops.reset_launch_counts()
    prefill = ops.flash_attention(q, k, v, causal=True, window=win)
    decode = ops.flash_decode(dq, kc, vc, lens)
    launches = {n: ops.launch_counts[n]
                for n in ("flash_attention", "flash_decode")}
    print(f"[api] launches {launches} (prefill_32k, decode_32k)")
    check(launches == {"flash_attention": 1, "flash_decode": 1},
          f"{launches}: not one launch each")
    T = PREFILL_T
    # the window's edges, then 52 rows drawn from its interior (t >= win,
    # where each row weighs a full window of keys)
    rows = [(0, t, h) for t in (0, 1, win - 1, win, T // 2 + 3, T - 1)
            for h in (0, Hq - 1)]
    rows += [(0, int(t), int(h)) for t, h in zip(
        torch.randint(win, T, (52,), generator=gen, device=dev).tolist(),
        torch.randint(0, Hq, (52,), generator=gen, device=dev).tolist())]
    close_attention("flash_attention", f"T=S={T} {len(rows)} sampled rows "
                    f"by hand",
                    torch.stack([prefill[b, t, h] for b, t, h in rows]),
                    rows_by_hand(q, k, v, rows, win).bfloat16(), errs)
    picks = (0, DECODE_B // 2, DECODE_B - 1)
    close_attention("flash_decode", f"B={DECODE_B} S={DECODE_S} samples "
                    f"{picks} vs plain", decode[list(picks)],
                    torch.cat([ref.flash_decode_ref(
                        dq[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                        lens[b:b + 1]) for b in picks]), errs)
    lib = sdpa_attention_expanded(q, k, v, True, win)
    close_attention("flash_attention", f"T=S={T} library yardstick, "
                    f"{len(rows)} sampled rows by hand",
                    torch.stack([lib[b, t, h] for b, t, h in rows]),
                    rows_by_hand(q, k, v, rows, win).bfloat16(), {})
    del lib
    times = {"flash_attention": {}, "flash_decode": {}}
    print(f"[clocks] before flash_attention at T=S={T}: {clocks_line()}")
    k_times = kernel_ms(lambda _: attention_kernel(q, k, v, causal=True,
                                                   window=win), 1, iters=3)
    print(f"[clocks] after flash_attention at T=S={T}: {clocks_line()}")
    times["flash_attention"][PREFILL_T] = report_time(
        "flash_attention", f"B=1 T=S={T} Hq={Hq} Hkv={Hkv} hd={hd} causal "
        f"window={win} bf16 (prefill_32k, batch cut from 32)", k_times, None,
        time_ms(lambda _: sdpa_attention_expanded(q, k, v, True, win), 1,
                iters=3),
        [attention_bound(q, k, True, win)])
    times["flash_decode"][DECODE_B] = report_time(
        "flash_decode", f"B={DECODE_B} S={DECODE_S} Hq={Hq} Hkv={Hkv} "
        f"hd={hd} bf16, lengths in [1, S] (decode_32k)",
        kernel_ms(lambda _: decode_kernel(dq, kc, vc, lens), 1, iters=10),
        None, None, [decode_bound(dq, kc, lens)])
    del q, k, v, prefill, kc, vc, dq, decode
    torch.cuda.empty_cache()
    peak_line("phase 7b (kernels API: attention at prefill_32k, "
              "decode_32k)")

    # T = S = CHECK_T: kernel, plain version and library, mixtral's widths
    T = CHECK_T
    q, k, v = attention_inputs(1, T, T, Hq, Hkv, hd, torch.bfloat16, gen,
                               dev)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=win)
    close_attention("flash_attention", f"B=1 T=S={T} mixtral bf16",
                    attention_kernel(q, k, v, causal=True, window=win), want,
                    errs)
    lib = sdpa_attention(q, k, v, True, win)
    check(torch.allclose(lib.float(), want.float(), rtol=3e-2, atol=3e-2),
          "attention library yardstick disagrees with the plain version")
    del want, lib
    torch.cuda.empty_cache()
    shape = f"B=1 T=S={T} Hq={Hq} Hkv={Hkv} hd={hd} causal window={win} bf16"
    times["flash_attention"][T] = report_time(
        "flash_attention", shape,
        kernel_ms(lambda _: attention_kernel(q, k, v, causal=True, window=win),
                1, iters=10),
        time_ms(lambda _: ref.flash_attention_ref(q, k, v, causal=True,
                                                  window=win), 1, iters=3),
        time_ms(lambda _: sdpa_attention(q, k, v, True, win), 1, iters=3),
        [attention_bound(q, k, True, win)])
    del q, k, v
    torch.cuda.empty_cache()
    # edge cases: hd = 120 (h2o-danube-3-4b), internlm2-1.8b's 16/8 heads
    # without a window, non-causal with and without a window, T not a
    # multiple of the 64-row tile, T != S (fully masked rows when T > S
    # with a window), fp32 inputs (the CUDA-core path), a window of 1,
    # B = 2, bf16 at hd = 36 (not a multiple of 8: the CUDA-core path);
    # then the edges of the tensor-core path's 128-row query and key tiles:
    # T and S of 127, 128 and 129, T not a multiple of 128 with S larger,
    # bf16 at hd = 32, 64, 120 and 128 (TMA zero-fills hd up to 64 or 128),
    # windows of 1 and 127, T > S with fully masked rows with and without
    # causal, B = 2 with Hq / Hkv = 1 and 4
    for B, T, S, hq, hkv, d, causal, w, dtype in (
            # h2o-danube-3-4b's attention: 32/8 heads of 120 (bf16, hd %
            # 16 == 8, TMA's fill pads it), a prompt past its 4,096 window
            (1, 4200, 4200, 32, 8, 120, True, 4096, torch.bfloat16),
            (1, 1000, 1000, 32, 8, 120, True, 256, torch.bfloat16),
            (1, 1000, 1000, 32, 8, 120, True, 256, torch.float32),
            (1, 2048, 2048, 16, 8, 128, True, None, torch.bfloat16),
            (2, 512, 512, 32, 8, 128, False, None, torch.bfloat16),
            (1, 700, 700, 32, 8, 128, False, 100, torch.bfloat16),
            (1, 300, 1000, 32, 8, 128, True, 128, torch.bfloat16),
            (1, 1000, 300, 32, 8, 128, True, 64, torch.bfloat16),
            (1, 1000, 300, 8, 2, 64, False, 64, torch.float32),
            (1, 1024, 1024, 32, 8, 128, True, 256, torch.float32),
            (1, 130, 130, 4, 1, 32, True, 1, torch.float32),
            (2, 77, 200, 6, 3, 16, False, None, torch.float32),
            (1, 100, 100, 4, 2, 36, True, 16, torch.bfloat16),
            (1, 127, 127, 8, 2, 128, True, None, torch.bfloat16),
            (1, 128, 128, 8, 2, 128, True, None, torch.bfloat16),
            (1, 129, 129, 8, 2, 128, True, None, torch.bfloat16),
            (1, 129, 127, 8, 2, 128, False, None, torch.bfloat16),
            (1, 300, 1000, 8, 2, 128, False, 127, torch.bfloat16),
            (1, 200, 257, 8, 2, 32, True, None, torch.bfloat16),
            (1, 257, 257, 8, 2, 64, True, 127, torch.bfloat16),
            (1, 257, 257, 8, 2, 120, False, None, torch.bfloat16),
            (1, 257, 257, 8, 2, 128, True, 1, torch.bfloat16),
            (1, 520, 129, 8, 2, 128, True, 127, torch.bfloat16),
            (1, 520, 129, 8, 2, 64, False, 127, torch.bfloat16),
            (2, 300, 300, 8, 8, 128, True, 127, torch.bfloat16),
            (2, 300, 300, 8, 2, 128, False, None, torch.bfloat16)):
        q, k, v = attention_inputs(B, T, S, hq, hkv, d, dtype, gen, dev)
        close_attention(
            "flash_attention", f"B={B} T={T} S={S} Hq={hq} Hkv={hkv} hd={d} "
            f"causal={causal} window={w} {str(dtype)[6:]}",
            attention_kernel(q, k, v, causal=causal, window=w),
            ref.flash_attention_ref(q, k, v, causal=causal, window=w), errs)
    # bf16 q not 16-byte aligned (a view 2 bytes into its storage): the
    # fp32 path takes it, as it takes hd = 36 above
    buf = torch.randn((1 + 300 * 8 * 64,), device=dev, generator=gen)
    q = buf.bfloat16()[1:].view(1, 300, 8, 64)
    _, k, v = attention_inputs(1, 300, 300, 8, 2, 64, torch.bfloat16, gen, dev)
    close_attention("flash_attention", "bf16 q 2 bytes off 16-byte alignment",
                    attention_kernel(q, k, v, causal=True, window=64),
                    ref.flash_attention_ref(q, k, v, causal=True, window=64),
                    errs)

    # decode: B = 8 against the plain version (lengths 0, S and above S
    # among them), a poisoned tail, and TIME_DECODE_B caches for the timing
    # beside the plain version and the library
    S = DECODE_S
    kc, vc = (torch.randn((8, S, Hkv, hd), device=dev, generator=gen)
              .bfloat16() for _ in range(2))
    dq = torch.randn((8, Hq, hd), device=dev, generator=gen).bfloat16()
    lens = torch.randint(1, S + 1, (8,), generator=gen, device=dev)
    lens[0], lens[1], lens[2] = 0, S, S + 100
    got = decode_kernel(dq, kc, vc, lens)
    close_attention("flash_decode", f"B=8 S={S} mixtral bf16 lengths "
                    f"{lens.tolist()}", got,
                    ref.flash_decode_ref(dq, kc, vc, lens), errs)
    n = int(lens[3])
    kc[3, n:], vc[3, n:] = 1e9, -1e9
    poisoned = decode_kernel(dq, kc, vc, lens)
    torch.cuda.synchronize()
    check(torch.equal(poisoned, got), "flash_decode read past a length")
    close_attention("flash_decode", f"B=8 poisoned tail past length {n}",
                    poisoned, ref.flash_decode_ref(dq, kc, vc, lens), errs)
    del kc, vc
    # h2o-danube-3-4b's decode: its 4,096-slot ring (lengths in [0, S])
    for B, S, hq, hkv, d, dtype in ((2, 4096, 32, 8, 120, torch.bfloat16),
                                    (4, 3000, 32, 8, 120, torch.bfloat16),
                                    (4, 3000, 16, 8, 128, torch.bfloat16),
                                    (3, 2000, 32, 4, 128, torch.float32),
                                    (5, 77, 8, 8, 64, torch.float32),
                                    (2, 100, 4, 1, 16, torch.float32)):
        kc, vc = (torch.randn((B, S, hkv, d), device=dev, generator=gen)
                  .to(dtype) for _ in range(2))
        dq = torch.randn((B, hq, d), device=dev, generator=gen).to(dtype)
        lens = torch.randint(0, S + 1, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        close_attention("flash_decode", f"B={B} S={S} Hq={hq} Hkv={hkv} "
                        f"hd={d} {str(dtype)[6:]} int32 lengths "
                        f"{lens.tolist()}", decode_kernel(dq, kc, vc, lens),
                        ref.flash_decode_ref(dq, kc, vc, lens), errs)
    B, S = TIME_DECODE_B, DECODE_S
    kc, vc = (torch.randn((B, S, Hkv, hd), device=dev, generator=gen)
              .bfloat16() for _ in range(2))
    dq = torch.randn((B, Hq, hd), device=dev, generator=gen).bfloat16()
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    want = ref.flash_decode_ref(dq, kc, vc, lens)
    close_attention("flash_decode", f"B={B} S={S} mixtral bf16", decode_kernel(
        dq, kc, vc, lens), want, errs)
    check(torch.allclose(sdpa_decode(dq, kc, vc, lens).float(), want.float(),
                         rtol=3e-2, atol=3e-2),
          "decode library yardstick disagrees with the plain version")
    times["flash_decode"][B] = report_time(
        "flash_decode", f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} bf16, "
        f"lengths in [1, S]",
        kernel_ms(lambda _: decode_kernel(dq, kc, vc, lens), 1, iters=20),
        time_ms(lambda _: ref.flash_decode_ref(dq, kc, vc, lens), 1,
                iters=3),
        time_ms(lambda _: sdpa_decode(dq, kc, vc, lens), 1, iters=3),
        [decode_bound(dq, kc, lens)])
    peak_line(f"phase 7b (kernels API: attention checks and timing; "
              f"{time.perf_counter() - t0:.1f} s in all)")
    return launches, times, {k: max(v) for k, v in errs.items()}


# ------------------------------------------------------------- phase 7c
def aligned_ids(B, T, L, R, lblk, gen, dev):
    """A stream the blocked bag reads block by block: every L-block of
    lblk lookups is the rows [k*lblk, (k+1)*lblk) of a random block k."""
    blk = torch.randint(0, R // lblk, (B, T, L // lblk), generator=gen,
                        device=dev)
    return (blk[..., None] * lblk + torch.arange(lblk, device=dev)).reshape(
        B, T, L).to(torch.int32)


def blocked_bf16_bound(tables, ids, lblk):
    """What a bf16 blocked bag may differ from its plain version by,
    element by element, and what a bag that skipped the bf16 rounding of
    its block sums would give. Both sides round each block's fp32 sum to
    bf16 once, as the reference does, from sums taken in other orders.
    Where sum|x| is below 2^24 times the finest bf16 spacing among the
    block's values, every partial sum is exact in fp32 and both sides
    round the same sum. Otherwise the two land one bf16 step apart only
    where the block's exact sum lies within the fp32 sums' error
    ((lblk - 1) * 2^-24 * sum|x|) of a bf16 rounding boundary, and only
    such a block is allowed that step. Both then add the bf16 block sums
    in fp32 in other orders, each within (blocks - 1) * 2^-24 *
    sum|block sum| of the exact sum."""
    B, T, L = ids.shape
    base = ids.reshape(B, T, L // lblk, lblk)[..., 0].long()
    t = torch.arange(T, device=ids.device)[None, :, None, None]
    rows = base[..., None] + torch.arange(lblk, device=ids.device)
    x = tables[t, rows].double()                      # (B, T, L/lblk, lblk, d)
    exact, ax = x.sum(dim=3), x.abs()

    def spacing(v):                    # bf16 spacing at |v| (normal range)
        return torch.exp2(torch.floor(torch.log2(v.clamp_min(2.0 ** -126)))
                          - 7)

    finest = torch.where(ax > 0, spacing(ax), math.inf).amin(dim=3)
    inexact = ax.sum(dim=3) >= 2.0 ** 24 * finest
    err32 = (lblk - 1) * 2.0 ** -24 * ax.sum(dim=3)
    mag = exact.abs()
    step = spacing(mag)
    frac = mag / step - torch.floor(mag / step)
    near = inexact & ((frac - 0.5).abs() * step <= err32)
    n_blocks = L // lblk
    slack = (2 * (n_blocks - 1) * 2.0 ** -24 * (1 + 2.0 ** -7)
             * exact.abs().sum(dim=2))
    bound = (near * step).sum(dim=2) + slack
    return bound, exact.sum(dim=2), near.double().mean().item()


def compare_blocked(name, tables, ids, lblk, aligned, errs, nan_ok=False):
    """The blocked bag's wrapper against its plain version, and the card's
    predicate (its flag) against ``blocked_stream_aligned``."""
    from repro_torch.kernels import embedding_bags, ref
    got, flag = embedding_bags.embedding_bag_blocked_flag(tables, ids,
                                                          lblk=lblk)
    want = ref.embedding_bag_blocked_ref(tables, ids, lblk)
    plain = bool(ref.blocked_stream_aligned(ids, lblk, tables.shape[1]))
    check(plain == aligned, f"embedding_bag_blocked {name}: the case's "
                            f"stream is {'not ' * aligned}aligned")
    check(int(flag.item()) == int(not aligned),
          f"embedding_bag_blocked {name}: the card's predicate "
          f"(flag {int(flag.item())}) differs from blocked_stream_aligned")
    name = f"{name} ({'blocked' if aligned else 'per-row'} branch)"
    if not (aligned and tables.dtype == torch.bfloat16):
        close("embedding_bag_blocked", name, got, want, errs, nan_ok)
        return
    bound, unrounded, near = blocked_bf16_bound(tables, ids, lblk)
    err = (got.double() - want.double()).abs()
    over = (err / bound).max().item()
    miss = (unrounded - want.double()).abs() > bound
    print(f"[kernel] embedding_bag_blocked {name}: max_abs_err="
          f"{err.max().item():.3e} err/bound={over:.3e} (bound: one bf16 "
          f"step on the {near:.2%} of block sums near a rounding boundary "
          f"+ fp32 order); block sums left unrounded would be over it at "
          f"{int(miss.sum())} of {miss.numel()} elements "
          f"{'ok' if over <= 1 and miss.any() else 'FAIL'}")
    check(over <= 1, f"embedding_bag_blocked {name}: off by more than the "
                     f"bf16 block sums' rounding allows")
    check(bool(miss.any()), f"embedding_bag_blocked {name}: the case cannot "
                            f"tell rounded block sums from unrounded ones")
    errs.setdefault(("embedding_bag_blocked", "bf16_blocks"), []).append(
        over)


def blocked_edge_cases(dev, errs):
    """Aligned streams at lblk 4, 8, 16 and d 32, 128, 256 (fp32, bf16);
    streams that are not aligned: unsorted, a block reversed, one block
    off by a row, a block past the table, a negative block; d = 36, 6 and
    16 and tables 4 bytes off 16-byte alignment (the narrower loads)."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    B, T, L, R = 16, 3, 32, 1024

    def tables_of(d, dtype, rows=R, scale=1.0):
        return torch.empty((T, rows, d), device=dev).uniform_(
            -scale, scale, generator=gen).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for lblk in (4, 8, 16):
            for d in (32, 128, 256):
                compare_blocked(f"B={B} T={T} L={L} d={d} lblk={lblk} {tag} "
                                f"aligned", tables_of(d, dtype),
                                aligned_ids(B, T, L, R, lblk, gen, dev), lblk,
                                True, errs)
        tables = tables_of(32, dtype)
        ids = aligned_ids(B, T, 80, R, 8, gen, dev)
        compare_blocked(f"L=80 d=32 lblk=8 {tag} aligned", tables, ids, 8,
                        True, errs)
        cases = {
            "unsorted": torch.randint(0, R, ids.shape, generator=gen,
                                      device=dev, dtype=torch.int32),
            "one block reversed": ids.clone(),
            "one block off by a row": ids.clone(),
            "a negative block (-8 .. -1)": ids.clone(),
            "a block past the table": ids.clone(),
        }
        cases["one block reversed"][5, 1, 8:16] = ids[5, 1, 8:16].flip(0)
        cases["one block off by a row"][2, 2, 72:80] += 1
        cases["a negative block (-8 .. -1)"][3, 0, :8] = torch.arange(
            -8, 0, device=dev)
        cases["a block past the table"][7, 1, 16:24] = torch.arange(
            R, R + 8, device=dev)
        for name, bad in cases.items():
            compare_blocked(f"L=80 d=32 lblk=8 {tag} {name}", tables, bad, 8,
                            False, errs, nan_ok=name.endswith("table"))
        # R = 1020: the block at 1016 passes the reference's predicate and
        # its last four rows lie past the table
        short = tables_of(32, dtype, rows=1020)
        ids = aligned_ids(B, T, 80, 1016, 8, gen, dev)
        ids[0, 0, :8] = torch.arange(1016, 1024, device=dev)
        compare_blocked(f"R=1020 d=32 lblk=8 {tag} a block half past the "
                        f"table", short, ids, 8, False, errs, nan_ok=True)
    # the per-row branch (row 4's body) at the widths and ids row 4 takes:
    # scalar loads (d = 30), five 16-byte vectors a row (d = 20), ids
    # counted from the end and out of range, nine ids in ten at one row;
    # at the model's init scale, where fp32 order moves a sum of 80 rows
    # by ~1e-7
    init = R ** -0.5
    for d, dtype in ((30, torch.float32), (20, torch.float32),
                     (30, torch.bfloat16)):
        compare_blocked(f"L=80 d={d} lblk=8 {str(dtype)[6:]} unsorted",
                        tables_of(d, dtype, scale=init),
                        torch.randint(0, R, (B, T, 80), generator=gen,
                                      device=dev, dtype=torch.int32), 8,
                        False, errs)
    ids = torch.randint(0, R, (B, T, 80), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[0, 0, 0], ids[1, 1, 1], ids[2, 2, 2], ids[3, 0, 3] = -1, 1 - R, R, \
        -R - 1
    compare_blocked("L=80 d=32 lblk=8 fp32 ids counted from the end and out "
                    "of range", tables_of(32, torch.float32, scale=init), ids,
                    8, False, errs, nan_ok=True)
    ids = torch.where(torch.rand(ids.shape, generator=gen, device=dev) < 0.9,
                      R - 1, ids.clamp(0, R - 1)).int()
    compare_blocked("L=80 d=32 lblk=8 fp32 nine ids in ten at the last row",
                    tables_of(32, torch.float32, scale=init), ids, 8, False,
                    errs)
    for d, lblk, dtype in ((36, 4, torch.float32), (6, 4, torch.float32),
                           (16, 4, torch.bfloat16), (36, 8, torch.bfloat16)):
        compare_blocked(f"d={d} lblk={lblk} {str(dtype)[6:]} aligned",
                        tables_of(d, dtype), aligned_ids(B, T, L, R, lblk,
                                                         gen, dev), lblk,
                        True, errs)
    buf = torch.empty((T * R * 32 + 1,), device=dev).uniform_(-1, 1,
                                                              generator=gen)
    odd = buf[1:].view(T, R, 32)                 # 4 bytes past alignment
    compare_blocked("d=32 lblk=8 fp32 tables 4 bytes off alignment", odd,
                    aligned_ids(B, T, L, R, 8, gen, dev), 8, True, errs)


def bag_bound(tables, ids):
    """Least time of a sum-pool: the distinct rows the ids touch, the ids
    and the (B, T, d) fp32 output, against one add a looked-up element."""
    B, T, L = ids.shape
    d = tables.shape[2]
    nbytes = (distinct_rows(ids, tables.shape[1]) * d * tables.element_size()
              + ids.numel() * 4 + B * T * d * 4)
    return least_time(nbytes, B * T * L * d)


def phase_blocked(tables, cfg, dev):
    """Phase 7c: the blocked bag (row 5) through ``kernels.ops`` on the
    stacked tables at full width: aligned streams at B = 200 and 800 and a
    stream that is not aligned (the alpha = 1.05 one), launch counts
    zeroed just before and read just after; edge shapes against the
    plain version; row 5, row 4, the plain version and the library timed
    on the same aligned streams."""
    from repro_torch.data.recsys import make_recsys_batch
    from repro_torch.kernels import embedding_bags, ops, ref

    t0 = time.perf_counter()
    errs = {}
    blocked_edge_cases(dev, errs)
    T, R, d = tables.shape
    L = cfg.lookups_per_table
    gen = torch.Generator(device=dev).manual_seed(55)
    sets = {B: [aligned_ids(B, T, L, R, LBLK, gen, dev) for _ in range(8)]
            for B in BLOCKED_BATCHES}
    skewed = make_recsys_batch(cfg, 30, 0, TIERED_ALPHA)["indices"]
    streams = [(f"B={B} aligned", sets[B][0]) for B in BLOCKED_BATCHES] + [
        (f"B={skewed.shape[0]} alpha={TIERED_ALPHA} stream", skewed)]
    ops.reset_launch_counts()
    pools = [ops.embedding_bag_blocked(tables, ids, lblk=LBLK)
             for _, ids in streams]
    launches = {"embedding_bag_blocked":
                ops.launch_counts["embedding_bag_blocked"]}
    print(f"[blocked] launches {launches} ({len(streams)} streams)")
    check(launches["embedding_bag_blocked"] == len(streams),
          f"{launches}: not one launch a stream")
    for (name, ids), got in zip(streams, pools):
        shape = f"{name} T={T} L={L} d={d} R={R} lblk={LBLK} fp32"
        close("embedding_bag_blocked", f"{shape} vs plain", got,
              ref.embedding_bag_blocked_ref(tables, ids, LBLK), errs)
        close("embedding_bag_blocked", f"{shape} vs embedding_bag (row 4)",
              got, embedding_bags.embedding_bag(tables, ids), errs)
        flag = embedding_bags.embedding_bag_blocked_flag(
            tables, ids, lblk=LBLK)[1]
        check(int(flag.item()) == int("aligned" not in name),
              f"embedding_bag_blocked {shape}: the card took the wrong "
              f"branch (flag {int(flag.item())})")
    del pools
    rows = {"embedding_bag_blocked": {}, "embedding_bag, aligned stream": {}}
    for B in BLOCKED_BATCHES:
        ss = sets[B]
        check(torch.allclose(library_bag(tables, ss[0]),
                             ref.embedding_bag_blocked_ref(tables, ss[0],
                                                           LBLK),
                             rtol=RTOL, atol=ATOL),
              "blocked-bag library yardstick disagrees with the plain "
              "version")
        bounds = [bag_bound(tables, ids) for ids in ss]
        shape = f"B={B} T={T} L={L} d={d} R={R} lblk={LBLK} fp32, aligned"
        rows["embedding_bag_blocked"][B] = report_time(
            "embedding_bag_blocked", shape,
            kernel_ms(lambda k: embedding_bags.embedding_bag_blocked(
                tables, ss[k], lblk=LBLK), len(ss)),
            time_ms(lambda k: ref.embedding_bag_blocked_ref(
                tables, ss[k], LBLK), len(ss), iters=16),
            time_ms(lambda k: library_bag(tables, ss[k]), len(ss),
                    iters=16),
            bounds)
        rows["embedding_bag, aligned stream"][B] = report_time(
            "embedding_bag (row 4)", shape,
            kernel_ms(lambda k: embedding_bags.embedding_bag(tables, ss[k]),
                      len(ss)), None, None, bounds)
    peak_line(f"phase 7c (kernels API: blocked bag; "
              f"{time.perf_counter() - t0:.1f} s)")
    return launches, rows, {k: max(v) for k, v in errs.items()}


# ---------------------------------------------------------------- phase 8
def table_views(sess):
    """Per original table t: its (R, d) rows and, with AdaGrad, its (R,)
    accumulator, as views of the session's live tensors."""
    from repro_torch.parallel import plan_table_groups
    p, o = sess.params, sess.opt_state
    T = sess.cfg.num_tables
    if "hs_hot" in p:                      # the host tier: SGD only
        return [HostTableView(sess.exchange_inst, t) for t in range(T)], None
    if "tables" in p:
        tabs = [p["tables"][t] for t in range(T)]
        accs = None if o is None else [o["table_acc"][t] for t in range(T)]
        return tabs, accs
    groups = plan_table_groups(sess.plan, 1)
    tabs, accs = [None] * T, [None] * T
    for key, ids in (("fast", groups.fast_ids), ("bulk", groups.bulk_ids)):
        for i, t in enumerate(ids):
            tabs[t] = p[f"tables_{key}"][i]
            if o is not None:
                accs[t] = o[f"table_acc_{key}"][i]
    return tabs, (None if o is None else accs)


def clone_mlps(params, device):
    return {k: [{n: x.detach().to(device, copy=True)
                 for n, x in layer.items()} for layer in params[k]]
            for k in ("bot_mlp", "top_mlp")}


def compact_model(sess, batch):
    """The step's touched rows of every table gathered into a compact
    model (rows in sorted id order, zero rows past a table's count), its
    ids remapped to them, and copies of the dense layers and of the
    touched accumulator entries."""
    ids = batch["indices"]
    tabs, accs = table_views(sess)
    T, d = len(tabs), tabs[0].shape[1]
    uniq = [torch.unique(ids[:, t]) for t in range(T)]
    rc = max(u.numel() for u in uniq)
    tables = torch.zeros((T, rc, d), device=ids.device)
    acc = None if accs is None else torch.zeros((T, rc), device=ids.device)
    remap = torch.empty_like(ids)
    for t, u in enumerate(uniq):
        tables[t, :u.numel()] = tabs[t][u.long()]
        if acc is not None:
            acc[t, :u.numel()] = accs[t][u.long()]
        remap[:, t] = torch.searchsorted(u, ids[:, t].contiguous()).to(
            torch.int32)
    params = {**clone_mlps(sess.params, ids.device), "tables": tables}
    return params, acc, remap, uniq


def adagrad_reference(params, acc, dense, ids, labels, lr, depth):
    """One row-wise AdaGrad step written out (the reference's formula,
    ``repro.parallel.updates.adagrad_row_update`` after ``build_step``):
    the loss is the sum over ``depth`` micro-batches of their BCE / depth;
    each lookup's row grad is its bag's pooled grad; every lookup adds
    mean_d(g^2) to its row's accumulator, then every lookup moves its row
    by -lr * g / sqrt(acc + 1e-8); a dense layer moves by -lr * grad. In
    place on ``params["tables"]`` and ``acc``."""
    from repro_torch.core import dlrm
    tables = params["tables"]
    T, rc, d = tables.shape
    B, _, L = ids.shape
    with torch.no_grad():
        pooled = dlrm.embedding_bag(tables, ids)
    mlps = {k: [{n: x.detach().requires_grad_() for n, x in layer.items()}
                for layer in params[k]] for k in ("bot_mlp", "top_mlp")}
    leaves = [x for k in ("bot_mlp", "top_mlp") for layer in mlps[k]
              for x in layer.values()]
    leaf = pooled.detach().requires_grad_()
    logits = dlrm.dlrm_forward_from_pooled(mlps, dense, leaf)
    m = B // depth
    loss = sum(dlrm.bce_loss(logits[i:i + m], labels[i:i + m])
               for i in range(0, B, m)) / depth
    *grads, g_pooled = torch.autograd.grad(loss, leaves + [leaf])
    with torch.no_grad():
        g = g_pooled.transpose(0, 1)[:, :, None, :].expand(
            T, B, L, d).reshape(T * B * L, d)
        rows = (ids.transpose(0, 1).reshape(T, B * L).long()
                + torch.arange(T, device=ids.device)[:, None] * rc
                ).reshape(-1)
        acc.view(-1).index_add_(0, rows, g.square().mean(dim=-1))
        scale = torch.rsqrt(acc.view(-1)[rows] + 1e-8)
        tables.view(-1, d).index_add_(0, rows, -lr * scale[:, None] * g)
        for x, gx in zip(leaves, grads):
            x.sub_(lr * gx)
    return {**{k: [{n: x.detach() for n, x in layer.items()}
                   for layer in mlps[k]] for k in mlps}, "tables": tables}, \
        loss.detach()


def to_cpu(tree):
    """A copy of a tree of tensors in host memory."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.detach().to("cpu", copy=True)


def agree_tensors(name, got, want, rtol=RTOL, atol=ATOL):
    err = (got.float() - want.float().to(got.device)).abs().max().item()
    ok = torch.allclose(got.float(), want.float().to(got.device), rtol=rtol,
                        atol=atol)
    print(f"[train] {name}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagree (rtol={rtol}, atol={atol})")


def agree_change(name, before, got, want):
    """A step's change against the compact model's: ||got - before -
    (want - before)|| <= CHANGE_RTOL * ||want - before|| + ||ulp(want)||,
    the last term one fp32 step of every updated value (the two sides
    round their sums in other orders). The change itself must be over
    twice that bound, so a step that applied half of it, or none, fails.
    Returns the change's norm."""
    dev = got.device
    before, got, want = (x.detach().to(dev).double()
                         for x in (before, got, want))
    size = (want - before).norm().item()
    err = (got - want).norm().item()
    w32 = want.float().abs()
    floor = (torch.nextafter(w32, torch.full_like(w32, math.inf)) - w32
             ).double().norm().item()
    bound = CHANGE_RTOL * size + floor
    ok = err <= bound and size > 2 * bound
    print(f"[train] {name}: ||change||={size:.3e} ||error||={err:.3e} "
          f"bound={bound:.3e} (fp32 steps {floor:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    check(err <= bound, f"{name}: the change is off by {err:.3e} > "
                        f"{bound:.3e}")
    check(size > 2 * bound, f"{name}: the change ({size:.3e}) is not over "
                            f"twice its bound ({bound:.3e})")
    return size


def check_one_step(sess, optimizer, lr, seed, alpha, dev):
    """One step of the session at full width against the same step on a
    compact model of its touched rows (the port's reference_train_step
    for SGD, the reference formula for AdaGrad), on the card and on the
    CPU; sampled untouched rows must not move."""
    from repro_torch.core import dlrm
    from repro_torch.data.recsys import make_recsys_batch

    batch = make_recsys_batch(sess.cfg, sess.next_step, seed, alpha,
                              device=dev)
    params, acc, remap, uniq = compact_model(sess, batch)
    cpu = (to_cpu(params), None if acc is None else to_cpu(acc))
    # the steps update in place: what they start from
    rows0 = torch.cat([params["tables"][t, :u.numel()]
                       for t, u in enumerate(uniq)])
    dense0 = clone_mlps(params, dev)
    acc0 = None if acc is None else torch.cat(
        [acc[t, :u.numel()] for t, u in enumerate(uniq)])
    tabs, accs = table_views(sess)
    T, R = len(tabs), tabs[0].shape[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    sample_t = torch.randint(0, T, (4096,), generator=gen, device=dev)
    sample_r = torch.randint(0, R, (4096,), generator=gen, device=dev)
    untouched = torch.ones(4096, dtype=torch.bool, device=dev)
    for t, u in enumerate(uniq):
        mine = sample_t == t
        untouched &= ~(mine & torch.isin(sample_r, u.long()))
    before = torch.stack([tabs[t][r] for t, r in zip(sample_t.tolist(),
                                                     sample_r.tolist())])
    rep = sess.run(1)
    depth = sess.pipeline_depth
    args = (batch["dense"], remap, batch["labels"])
    if optimizer == "sgd":
        want, loss = dlrm.reference_train_step(params, *args, sess.cfg, lr)
        want_cpu, loss_cpu = dlrm.reference_train_step(
            cpu[0], *(a.cpu() for a in args), sess.cfg, lr)
    else:
        want, loss = adagrad_reference(params, acc, *args, lr, depth)
        want_cpu, loss_cpu = adagrad_reference(
            cpu[0], cpu[1], *(a.cpu() for a in args), lr, depth)
    check(math.isfinite(rep.last_loss), "the step's loss is not finite")
    agree_tensors("step loss, full model vs compact model",
                  torch.tensor(rep.last_loss), loss.cpu())
    got_rows = torch.cat([tabs[t][u.long()] for t, u in enumerate(uniq)])
    want_rows = torch.cat([want["tables"][t, :u.numel()]
                           for t, u in enumerate(uniq)])
    cpu_rows = torch.cat([want_cpu["tables"][t, :u.numel()]
                          for t, u in enumerate(uniq)])
    agree_tensors(f"touched rows ({got_rows.shape[0]}), full model on the "
                  f"card vs compact model", got_rows, want_rows)
    agree_tensors("touched rows, compact model on the card vs on the CPU",
                  want_rows, cpu_rows)
    sizes = {"rows": agree_change("touched rows' change, full model vs "
                                  "compact model", rows0, got_rows,
                                  want_rows)}
    agree_change("touched rows' change, compact model on the card vs on "
                 "the CPU", rows0, want_rows, cpu_rows)
    for k in ("bot_mlp", "top_mlp"):
        for i, (g_l, w_l, c_l) in enumerate(zip(sess.params[k], want[k],
                                                want_cpu[k])):
            for n in g_l:
                agree_tensors(f"{k}[{i}].{n}, full vs compact", g_l[n],
                              w_l[n])
                agree_tensors(f"{k}[{i}].{n}, compact card vs CPU", w_l[n],
                              c_l[n])
                x0 = dense0[k][i][n]
                sizes[f"{k}[{i}].{n}"] = agree_change(
                    f"{k}[{i}].{n} change, full vs compact", x0, g_l[n],
                    w_l[n])
                agree_change(f"{k}[{i}].{n} change, compact card vs CPU",
                             x0, w_l[n], c_l[n])
    if accs is not None:
        got_acc = torch.cat([accs[t][u.long()] for t, u in enumerate(uniq)])
        want_acc = torch.cat([acc[t, :u.numel()]
                              for t, u in enumerate(uniq)])
        cpu_acc = torch.cat([cpu[1][t, :u.numel()]
                             for t, u in enumerate(uniq)])
        agree_tensors("touched accumulators, full vs compact", got_acc,
                      want_acc)
        agree_tensors("touched accumulators, compact card vs CPU",
                      want_acc, cpu_acc)
        sizes["accumulators"] = agree_change(
            "touched accumulators' change, full vs compact", acc0, got_acc,
            want_acc)
        agree_change("touched accumulators' change, compact card vs CPU",
                     acc0, want_acc, cpu_acc)
    after = torch.stack([tabs[t][r] for t, r in zip(sample_t.tolist(),
                                                    sample_r.tolist())])
    n_un = int(untouched.sum())
    check(n_un > 0 and torch.equal(after[untouched], before[untouched]),
          "an untouched row moved")
    print(f"[train] {n_un} sampled untouched rows unchanged; "
          f"{4096 - n_un} sampled rows were touched")
    return rep.last_loss, sizes


def profile_step(sess, n=PROFILE_STEPS):
    """torch.profiler over ``n`` more steps (their batch draws included;
    whole traces only, ``whole_profile``): a step's wall time, its device
    busy time and the device events, or None if no trace was whole."""
    got = whole_profile(sess.run, n)
    if got is None:
        return None
    _, wall, busy, _, kernels = got
    return wall / n, busy / n, kernels


def phase_train(dev, card):
    """Phase 8: DLRM training at full width through
    ``Engine(...).train_session().run``: plan=none with SGD at depth 1,
    then plan=auto with row-wise AdaGrad at the planner's training depth.
    Each session's own tables (21.47 GB) are updated in place."""
    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops

    cfg = get_dlrm(CONFIG)
    table_bytes = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    out = {}
    base = torch.cuda.memory_allocated()
    for plan, optimizer, alpha, lr in TRAIN_RUNS:
        label = f"plan={plan} {optimizer}"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = Engine(cfg, plan=plan, optimizer=optimizer, alpha=alpha,
                     lr=lr)
        sess = eng.train_session()
        torch.cuda.synchronize()
        build_peak = torch.cuda.max_memory_allocated()
        if plan == "auto":
            print(eng.plan_report("training").summary())
        print(f"[train] {label}: session built in "
              f"{time.perf_counter() - t0:.2f} s on {sess.device}, depth "
              f"{sess.pipeline_depth}, lr {eng.lr}, alpha {alpha}; peak "
              f"allocated while building {build_peak / GB:.3f} GB")
        check(build_peak < table_bytes + 2 * GB,
              f"{label}: building the session peaked at "
              f"{build_peak / GB:.2f} GB, over the tables' bytes + 2 GB")
        want_depth = (1 if plan == "none"
                      else eng.plan_report("training").pipeline_depth)
        check(sess.pipeline_depth == want_depth,
              f"{label}: depth {sess.pipeline_depth}, planner {want_depth}")
        check(all(x.is_cuda for x in table_views(sess)[0]),
              f"{label}: the tables are not on the card")
        check_one_step(sess, optimizer, eng.lr, eng.seed, alpha, dev)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rep = sess.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = dict(ops.launch_counts)
        losses = [h["loss"] for h in rep.history]
        dts = np.array([h["dt"] for h in rep.history]) * 1e3
        check(all(math.isfinite(x) for x in losses),
              f"{label}: a loss is not finite: {losses}")
        check(not any(launches.values()),
              f"{label}: the training path launched {launches}; the "
              f"reference's training reaches no kernel")
        p50, p99 = np.percentile(dts, 50), np.percentile(dts, 99)
        rate = cfg.batch_size * len(dts) / (dts.sum() / 1e3)
        print(f"[train] {label}: {len(dts)} steps from step "
              f"{rep.start_step}, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"step time p50 {p50:.4f} ms p99 {p99:.4f} ms; "
              f"{rate:.1f} samples/s; peak allocated {peak / GB:.3f} GB "
              f"(tables {table_bytes / GB:.3f} GB); kernel launches "
              f"{sum(launches.values())} ({card})")
        check(peak < table_bytes + 2 * GB,
              f"{label}: peak {peak / GB:.2f} GB is over the tables' bytes "
              f"+ 2 GB")
        prof = profile_step(sess)
        if prof is None:
            print(f"[profile] train {label}: device busy not measured (no "
                  f"whole trace in 5)")
        else:
            wall, busy, kernels = prof
            print(f"[profile] train {label}: a step (batch draw included) "
                  f"{wall:.4f} ms, device busy {busy:.4f} ms "
                  f"({busy / wall:.0%}), idle {max(wall - busy, 0.0):.4f} "
                  f"ms (mean of {PROFILE_STEPS} profiled steps)")
            for e in kernels[:5]:
                per_step = e.self_device_time_total / 1e3 / PROFILE_STEPS
                print(f"[profile]   {per_step:.4f} ms a step, "
                      f"{e.count // PROFILE_STEPS} launches: {e.key[:80]}")
        out[label] = dict(p50_ms=p50, p99_ms=p99, samples_per_s=rate,
                          peak_gb=peak / GB, depth=sess.pipeline_depth)
        del sess, eng
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() < base + 0.1 * GB,
              f"{label}: the session's tensors outlive it")
    peak_line("phase 8 (training at full width)")
    return out


def largest_abs(x):
    lo, hi = torch.aminmax(x)             # no |x| temporary of x's size
    return max(-lo.item(), hi.item())


def phase_train_diverging(dev, card):
    """Phase 8b: ``DIVERGING_RUN``. Its first step is held against the
    compact model as in phase 8; it then steps on one step at a time, up
    to TRAIN_STEPS in all, printing each step's loss beside the largest
    |table value| and |dense weight|, and records the first step whose
    loss is not finite."""
    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine

    plan, optimizer, alpha, lr = DIVERGING_RUN
    label = f"plan={plan} {optimizer} lr {lr}"
    eng = Engine(get_dlrm(CONFIG), plan=plan, optimizer=optimizer,
                 alpha=alpha, lr=lr)
    sess = eng.train_session()
    loss, sizes = check_one_step(sess, optimizer, lr, eng.seed, alpha, dev)
    first_bad = None
    for n in range(1, TRAIN_STEPS + 1):
        if n > 1:
            loss = sess.run(1).last_loss
        tab = max(largest_abs(x) for k, x in sess.params.items()
                  if k.startswith("tables") and x.numel())
        dense = max(largest_abs(x) for k in ("bot_mlp", "top_mlp")
                    for layer in sess.params[k] for x in layer.values())
        print(f"[train] {label}: step {n} loss {loss:.6g}, largest |table "
              f"value| {tab:.6g}, largest |dense weight| {dense:.6g}")
        if not math.isfinite(loss):
            first_bad = n
            break
    print(f"[train] {label}: "
          + (f"the loss first was not finite at step {first_bad}"
             if first_bad else f"the loss stayed finite for {TRAIN_STEPS} "
                               f"steps")
          + f"; first step held against the compact model, its rows' "
            f"change {sizes['rows']:.3e} ({card})")
    del sess, eng
    torch.cuda.empty_cache()
    peak_line("phase 8b (training at the launchers' lr)")
    return first_bad


def phase_row_wise_train(card):
    """Phase 8c: ``dlrm-rm2-small-sharded`` trains through the row-wise
    exchange in both wire modes from the same init and stream as a
    table-wise session (Engine seed 0, depth 1): SGD 3 steps, AdaGrad 2.
    The losses, the MLPs, and the tables (and AdaGrad's accumulators) at
    every row the steps touched must be equal (rtol = atol = 1e-5). One
    session at a time holds its tables on the card; the touched rows go
    to the CPU between them."""
    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.parallel import RowWiseExchange

    t0 = time.perf_counter()
    cfg, table_cfg = get_dlrm(ROW_WISE_CONFIG), get_dlrm(CONFIG)
    torch.cuda.reset_peak_memory_stats()
    for optimizer, lr, steps in ROW_WISE_TRAIN:
        runs = [("table-wise", table_cfg, "partial_pool")] + [
            (f"row-wise {m}", cfg, m) for m in ROW_WISE_MODES]
        seen = {}
        rows = None
        for label, c, mode in runs:
            sess = Engine(c, exchange=mode, optimizer=optimizer,
                          lr=lr).train_session()
            check(sess.pipeline_depth == 1, f"{label}: depth "
                                            f"{sess.pipeline_depth}")
            check(isinstance(sess.exchange_inst, RowWiseExchange)
                  == (c is cfg), f"{label}: {sess.exchange_inst}")
            ops.reset_launch_counts()
            rep = sess.run(steps)
            torch.cuda.synchronize()
            check(not any(ops.launch_counts.values()),
                  f"{label}: training launched {dict(ops.launch_counts)}")
            if rows is None:            # every row the steps looked up
                from repro_torch.data.recsys import make_recsys_batch
                ids = torch.cat([make_recsys_batch(c, s)["indices"]
                                 for s in range(steps)])
                rows = [torch.unique(ids[:, t].reshape(-1))
                        for t in range(c.num_tables)]
            tables = sess.params["tables"]
            got = {"loss": torch.tensor([h["loss"] for h in rep.history]),
                   "tables": torch.cat([tables[t].index_select(0, r).cpu()
                                        for t, r in enumerate(rows)]),
                   **{f"{k}/{i}/{n}": v.detach().cpu()
                      for k in ("bot_mlp", "top_mlp")
                      for i, layer in enumerate(sess.params[k])
                      for n, v in layer.items()}}
            if optimizer == "adagrad":
                acc = sess.opt_state["table_acc"]
                got["table_acc"] = torch.cat(
                    [acc[t].index_select(0, r).cpu()
                     for t, r in enumerate(rows)])
                del acc
            seen[label] = got
            del sess, tables
            torch.cuda.empty_cache()
        want = seen.pop("table-wise")
        for label, got in seen.items():
            err = max(float((got[k] - want[k]).abs().max()) for k in want)
            print(f"[row-wise] {optimizer} lr {lr}, {steps} steps at depth "
                  f"1: {label} vs table-wise, losses "
                  f"{[round(x, 6) for x in got['loss'].tolist()]}, "
                  f"{sum(r.numel() for r in rows)} touched rows, max_abs_err "
                  f"{err:.3e} over losses, MLPs, touched rows"
                  f"{' and accumulators' if 'table_acc' in got else ''} "
                  f"({card})")
            for k in want:
                check(torch.allclose(got[k], want[k], rtol=RTOL, atol=ATOL),
                      f"{optimizer}: {label}'s {k} differs from the "
                      f"table-wise session's")
    peak_line(f"phase 8c (row-wise training; "
              f"{time.perf_counter() - t0:.1f} s)")


def phase_resume(dev):
    """Phase 9: checkpoint at step 4 -> resume -> 4 more steps equals an
    uninterrupted 8-step run, on the card at cfg.reduced() size, under
    plan=none/SGD and plan=auto/AdaGrad."""
    import shutil
    import tempfile

    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine

    cfg = get_dlrm(CONFIG).reduced()
    os.makedirs(BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        for plan, optimizer in (("none", "sgd"), ("auto", "adagrad")):
            kw = dict(plan=plan, optimizer=optimizer, lr=0.05, alpha=1.05)
            ckpt = os.path.join(root, f"{plan}-{optimizer}")
            Engine(cfg, **kw).train_session(ckpt_dir=ckpt,
                                            ckpt_every=4).run(4)
            s2 = Engine(cfg, **kw).train_session(ckpt_dir=ckpt,
                                                 ckpt_every=4)
            check(s2.resume_step == 4, f"resumed at {s2.resume_step}")
            s2.run(4)
            straight = Engine(cfg, **kw).train_session()
            straight.run(8)
            got, want = leaves(s2.state), leaves(straight.state)
            check([p for p, _ in got] == [p for p, _ in want],
                  "resumed and uninterrupted states differ in structure")
            err = max((a.float() - b.float()).abs().max().item()
                      for (_, a), (_, b) in zip(got, want))
            check(all(x.is_cuda for _, x in got),
                  "the resumed state is not on the card")
            ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                     for (_, a), (_, b) in zip(got, want))
            print(f"[resume] plan={plan} {optimizer}: {len(got)} leaves, "
                  f"resumed vs uninterrupted max_abs_err={err:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"plan={plan} {optimizer}: resume differs from the "
                      f"uninterrupted run")
    finally:
        shutil.rmtree(root)
    peak_line("phase 9 (checkpoint -> resume on the card)")


# -------------------------------------------------------------- phase 9b
def record_fleet_depths():
    """Note the resolved pipeline depth of every flush any ServeSession
    runs (every replica of a fleet, the spawned ones too), and of the
    untimed capacity batch each session runs once before its first flush
    (``_ensure_warm``), by wrapping the class's methods. Returns (flush
    depths, warm-up depths, a function that unwraps them)."""
    from repro_torch.engine.serving import ServeSession
    depths, warm = [], []
    execute, ensure_warm = ServeSession._execute, ServeSession._ensure_warm

    def recorded(self, queries):
        samples = self._padded_count(len(queries)) * self.query_size
        depths.append(self.depth_for_samples(samples))
        return execute(self, queries)

    def recorded_warm(self):
        if not self._warm:
            warm.append(self.depth_for_samples(
                self.query_size * self.max_batch_queries))
        ensure_warm(self)

    ServeSession._execute = recorded
    ServeSession._ensure_warm = recorded_warm

    def unwrap():
        ServeSession._execute = execute
        ServeSession._ensure_warm = ensure_warm

    return depths, warm, unwrap


def events_until(scenario, qps, t_end):
    """The scenario's seed-0 events up to virtual time ``t_end`` (a prefix
    of one draw: thinning is sequential, so it equals ``events(n)``)."""
    n = int(1.5 * scenario.peak_rate(qps) * t_end) + 64
    events = scenario.events(n, qps=qps, seed=0)
    check(events[-1].arrival_s > t_end, "the event draw ends too soon")
    return [e for e in events if e.arrival_s <= t_end]


def drive_fleet(cluster, events, label, scenario, card, online=None):
    """Serve ``events`` through ``cluster.run`` with the launch counts set
    to 0 just before and read just after; check that every query is
    answered once with finite probs in (0, 1), and print the report,
    its wall time, achieved / offered QPS and each replica's
    utilization. Returns (report, launches, resolved depths of the
    flushes and of the sessions' warm-up batches)."""
    from repro_torch.kernels import ops
    depths, warm, unwrap = record_fleet_depths()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = cluster.run(events, sla_ms=50.0, scenario=scenario, online=online)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launch_counts)
    unwrap()
    boards = cluster.replicas + cluster._retired
    flushes = sum(len(r.batch_sizes) for r in boards)
    check(len(depths) == flushes, f"{label}: {len(depths)} recorded "
                                  f"flushes, {flushes} counted")
    check(sorted(cluster.completed) == [e.qid for e in events]
          and sum(r.served for r in boards) == len(events),
          f"{label}: not every query was answered exactly once")
    probs = np.stack([cluster.completed[e.qid].probs for e in events])
    check(probs.shape == (len(events), cluster.query_size)
          and bool(np.isfinite(probs).all() and (probs > 0).all()
                   and (probs < 1).all()),
          f"{label}: probs not finite in (0, 1) of shape "
          f"({len(events)}, {cluster.query_size})")
    print(rep.summary())
    util = " ".join(f"r{int(x['rid'])}={x['util']:.4f}"
                    for x in rep.replicas)
    print(f"[fleet] {label}: {len(events)} queries, {flushes} flushes, "
          f"wall {wall:.2f} s; achieved/offered QPS "
          f"{rep.achieved_qps:.2f}/{rep.offered_qps:.2f} = "
          f"{rep.achieved_qps / rep.offered_qps:.4f}; utilization {util}; "
          f"p50 {rep.p50_ms:.4f} ms p99 {rep.p99_ms:.4f} ms; launches "
          f"{ {k: v for k, v in launches.items() if v} } at resolved depths "
          f"summing to {sum(depths)} over the flushes + {sum(warm)} over "
          f"{len(warm)} replicas' untimed warm-up batch ({card})")
    return rep, launches, depths + warm


def default_load(cluster):
    """The serve launcher's default load: 0.8 x replicas / the measured
    per-query service of replica 0 (a 1-query flush)."""
    s1 = cluster.replicas[0].session.measure_service_time()
    qps = 0.8 * cluster.n_replicas / s1
    print(f"[fleet] default load: 0.8 x {cluster.n_replicas} replicas / "
          f"{s1 * 1e3:.4f} ms per-query service = {qps:.2f} qps")
    return qps


def agree_composed(cluster, events, label):
    """Sampled queries' probs against a composed session
    (fused_serve="off") sharing replica 0's params, at the contract."""
    from repro_torch.engine import Engine
    from repro_torch.traffic import materialize_query
    r0 = cluster.replicas[0].session
    off = Engine(cluster.cfg, plan=r0.plan if r0.plan is not None
                 else "none", fused_serve="off").serve_session(
        max_batch_queries=4, params=r0.params)
    check(off.serve_kernel == "composed", "fused_serve=off is not composed")
    picks = [events[0], events[len(events) // 3], events[2 * len(events) // 3],
             events[-1]]
    err = 0.0
    for ev in picks:
        q = materialize_query(cluster.cfg, ev, device=cluster.device)
        want = off.serve_direct(q["dense"], q["indices"])
        got = cluster.completed[ev.qid].probs
        err = max(err, float(np.abs(got - want).max()))
        check(np.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"{label}: qid {ev.qid} disagrees with the composed path")
    print(f"[fleet] {label}: qids {[e.qid for e in picks]} vs the composed "
          f"path on replica 0's params: max_abs_err={err:.3e}")


def check_drift_refreshes(monitor, refreshes, rotate_s, t_end):
    """Each refresh answers a rotation: none before the first, one in
    each span between rotations after it, and the mean hit ratio of the
    span's queries after its refresh is over the refresh threshold and
    over that of its queries before it."""
    rot = int(t_end // rotate_s)
    floor = monitor.refresh_threshold * monitor.baseline
    check(all(t > rotate_s for t in refreshes),
          f"(ii): lfu_refresh at {refreshes} s before the first rotation "
          f"at {rotate_s} s")
    hist = np.asarray(monitor.history)
    for k in range(1, rot + 1):
        lo, hi = k * rotate_s, min((k + 1) * rotate_s, t_end)
        ref = [t for t in refreshes if lo < t <= hi]
        check(len(ref) == 1, f"(ii): {len(ref)} lfu_refresh in ({lo}, {hi}] "
                             f"s, after rotation {k}")
        t, h = hist[:, 0], hist[:, 1]
        before = h[(t > lo) & (t <= ref[0])]
        after = h[(t > ref[0]) & (t <= hi)]
        check(after.size > 0 and after.mean() > floor
              and after.mean() > before.mean(),
              f"(ii): after rotation {k} the hit ratio did not recover")
        print(f"[fleet] (ii) rotation {k} at {lo:.1f} s: lfu_refresh at "
              f"{ref[0]:.4f} s; hit ratio {before.mean():.4f} over "
              f"{before.size} queries before it, {after.mean():.4f} over "
              f"{after.size} after (threshold {floor:.4f})")


def check_spawned(cluster, spawned, q):
    """Hold each live spawned replica's probs for query ``q`` against
    replica 0's; a spawned replica that retired again (a scale-down) must
    have released its params."""
    b = cluster.replicas[0].session.serve_direct(q["dense"], q["indices"])
    for r in spawned:
        if r.retired_at is not None:
            check(r.session is None, f"(i): retired r{r.rid} holds its params")
            print(f"[fleet] (i) spawned replica r{r.rid} retired at "
                  f"{r.retired_at:.4f} s and released its params")
            continue
        a = r.session.serve_direct(q["dense"], q["indices"])
        err = float(np.abs(a - b).max())
        print(f"[fleet] (i) spawned replica r{r.rid} vs r0: "
              f"max_abs_err={err:.3e}")
        check(np.allclose(a, b, rtol=RTOL, atol=ATOL),
              f"(i): spawned r{r.rid}'s probs differ from replica 0's")


def free_fleet(base, label):
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < base + 0.1 * GB,
          f"{label}: the fleet's tensors outlive it")


def phase_fleet(dev, card):
    """Phase 9b: the replicated fleet at full width (ROADMAP A7a):
    ``Cluster(get_dlrm("dlrm-rm2-small-unsharded"))``, B = 200, capacity
    4 queries, max_wait_ms 2, the planner's depth; replicas share the
    card, each on its own virtual busy horizon. (i) a flash crowd on 2
    replicas under p2c and an autoscaler that grows to 3; (ii) zipf_drift
    on 2 under round robin with the hit-ratio monitor on the card; (iii)
    plan="auto" on 2 under jsq. Each run is freed before the next."""
    from repro_torch.cluster import Cluster, HitRatioMonitor, SLAAutoscaler
    from repro_torch.configs import get_dlrm
    from repro_torch.traffic import make_scenario, materialize_query

    t_phase = time.perf_counter()
    cfg = get_dlrm(CONFIG)
    table_bytes = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    base = torch.cuda.memory_allocated()
    out = {}

    # (i) flash crowd, p2c, autoscaling 2 -> 3 replicas
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cluster = Cluster(cfg, n_replicas=2, max_batch_queries=4,
                      max_wait_ms=2.0, router="p2c")
    check(cluster.replicas[0].session.serve_kernel == "fused",
          f"(i): serve_kernel={cluster.replicas[0].session.serve_kernel}")
    qps = default_load(cluster)
    s4 = cluster.replicas[0].session.measure_service_time(4)
    # the threshold needs a measured flush, so the autoscaler joins the
    # built fleet before its run
    threshold = FLEET_SLA_FACTOR * s4 * 1e3
    cluster.autoscaler = SLAAutoscaler(threshold, max_replicas=3)
    print(f"[fleet] (i) flash_crowd: 2 replicas built in "
          f"{time.perf_counter() - t0:.2f} s; autoscaler threshold "
          f"{threshold:.4f} ms ({FLEET_SLA_FACTOR} x the 4-query flush's "
          f"{s4 * 1e3:.4f} ms), max 3 replicas")
    scen = make_scenario("flash_crowd")
    events = events_until(scen, qps, FLASH_SPAN_S)
    rep, launches, depths = drive_fleet(cluster, events, "(i) flash_crowd",
                                        "flash_crowd", card)
    peak = torch.cuda.max_memory_allocated()
    check(launches["fused_bag_interactions"] == sum(depths),
          "(i): row 1's launches differ from the sum of resolved depths")
    check(launches["fused_grouped_bag_interactions"] == 0,
          "(i): plan=none launched row 3")
    ups = [e for e in rep.scale_events if e.action == "up"]
    n_leaves = len(leaves(cluster.replicas[0].session.params))
    for e in ups:
        print(f"[fleet] (i) scale up at t={e.t_s:.4f} s -> {e.n_replicas} "
              f"replicas, window p99 {e.window_p99_ms:.4f} ms, remesh "
              f"report {e.remesh} ({n_leaves} param leaves)")
    check(bool(ups), "(i): the autoscaler never scaled up")
    check(all(e.remesh == {"resharded": n_leaves, "replicated_fallback": 0}
              for e in ups), "(i): a remesh report is not every leaf "
                             "placed, none replicated")
    spawned = [r for r in cluster.replicas + cluster._retired if r.rid >= 2]
    check(spawned and all(r.batch_sizes for r in spawned),
          "(i): a spawned replica served no flush")
    check(peak < 3 * table_bytes + 2 * GB,
          f"(i): peak {peak / GB:.2f} GB over 3 x the tables + 2 GB")
    agree_composed(cluster, events, "(i)")
    check_spawned(cluster, spawned, materialize_query(cfg, events[-1],
                                                      device=dev))
    print(f"[memory] (i) peak allocated {peak / GB:.2f} GB (3 x the tables "
          f"= {3 * table_bytes / GB:.2f} GB)")
    out["flash_crowd"] = dict(report=rep, peak_gb=peak / GB,
                              threshold_ms=threshold)
    del cluster, spawned
    free_fleet(base, "(i)")

    # (ii) zipf_drift, round robin, the hit-ratio monitor on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    monitor = HitRatioMonitor(cfg, alpha=TIERED_ALPHA, model_cfg=cfg,
                              profile_batches=MONITOR_PROFILE_BATCHES,
                              device=dev)
    check(monitor.baseline < 1.0,
          f"(ii): baseline hit ratio {monitor.baseline} is not below 1")
    cluster = Cluster(cfg, n_replicas=2, max_batch_queries=4,
                      max_wait_ms=2.0, router="round_robin",
                      alpha=TIERED_ALPHA, monitor=monitor)
    print(f"[fleet] (ii) zipf_drift: monitor (baseline hit ratio "
          f"{monitor.baseline:.4f}, {monitor.hot_per_table} hot rows a "
          f"table) and 2 replicas built in {time.perf_counter() - t0:.2f} s")
    qps = default_load(cluster)
    scen = make_scenario("zipf_drift", alpha=TIERED_ALPHA)
    events = events_until(scen, qps, 2 * scen.rotate_every_s + 0.5)
    rotations = max(e.perm_salt for e in events) // scen.salt_stride
    rep, launches, depths = drive_fleet(cluster, events, "(ii) zipf_drift",
                                        "zipf_drift", card)
    peak = torch.cuda.max_memory_allocated()
    check(launches["fused_bag_interactions"] == sum(depths),
          "(ii): row 1's launches differ from the sum of resolved depths")
    check(rotations >= 2, f"(ii): the events span {rotations} rotations")
    check(len(rep.refreshes) >= 1, "(ii): the monitor fired no lfu_refresh")
    check_drift_refreshes(monitor, rep.refreshes, scen.rotate_every_s,
                          events[-1].arrival_s)
    print(f"[fleet] (ii) {rotations} rotations of the hot rows; "
          f"lfu_refresh at {[round(t, 4) for t in rep.refreshes]} s; hit "
          f"ratio {rep.hit_ratio_first:.4f} -> {rep.hit_ratio_last:.4f} "
          f"(baseline {monitor.baseline:.4f}); peak allocated "
          f"{peak / GB:.2f} GB")
    out["zipf_drift"] = dict(report=rep, peak_gb=peak / GB)
    del cluster, monitor
    free_fleet(base, "(ii)")

    # (iii) plan="auto", jsq: every replica serves through row 3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cluster = Cluster(cfg, n_replicas=2, plan="auto", alpha=TIERED_ALPHA,
                      max_batch_queries=4, max_wait_ms=2.0, router="jsq")
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated()
    print(cluster.plan_report.summary())
    check(cluster.replicas[0].session.serve_kernel == "fused",
          f"(iii): serve_kernel={cluster.replicas[0].session.serve_kernel}")
    print(f"[fleet] (iii) plan=auto: 2 replicas built in "
          f"{time.perf_counter() - t0:.2f} s, peak allocated while building "
          f"{build_peak / GB:.2f} GB (a replica's build splits fresh tables "
          f"into new tensors: 21.47 + 2 x 21.47 GB expected)")
    qps = default_load(cluster)
    events = make_scenario("stationary", alpha=TIERED_ALPHA).events(
        AUTO_FLEET_QUERIES, qps=qps, seed=0)
    rep, launches, depths = drive_fleet(cluster, events, "(iii) plan=auto",
                                        "stationary", card)
    check(launches["fused_grouped_bag_interactions"] == sum(depths),
          "(iii): row 3's launches differ from the sum of resolved depths")
    check(launches["fused_bag_interactions"] == 0,
          "(iii): plan=auto launched row 1")
    check(build_peak < 3 * table_bytes + 2 * GB,
          f"(iii): building peaked at {build_peak / GB:.2f} GB")
    agree_composed(cluster, events, "(iii)")
    out["plan_auto"] = dict(report=rep, peak_gb=build_peak / GB)
    del cluster
    free_fleet(base, "(iii)")
    peak_line(f"phase 9b (the replicated fleet; "
              f"{time.perf_counter() - t_phase:.1f} s)")
    return out


# -------------------------------------------------------------- phase 9c
def first_burst_s(scenario, qps) -> float:
    """Virtual seconds until a flash crowd's seed-0 rate first rises above
    its base rate."""
    rate = scenario.make_rate_fn(qps, 0)
    t = 0.0
    while rate(t) <= qps:
        t += 1e-3
    return t


def plain_pooled(cfg, tables_host, ev, dev, batches=()):
    """(query, pooled (B, T, d)) of one event in plain torch: the query
    regenerated from its event, its rows gathered from the host tables
    (then, in order, every online batch of ``batches`` emitted at or
    before its arrival applied to the rows it names) and copied to the
    card as a (T, B*L, d) slab that ``ref.embedding_bag_ref`` pools."""
    from repro_torch.kernels import ref
    from repro_torch.traffic import materialize_query
    q = materialize_query(cfg, ev, device=dev)
    ids = q["indices"].long().cpu()
    B, T, L = ids.shape
    rows = tables_host[torch.arange(T)[None, :, None], ids]
    for batch in batches:
        if batch.t_emit_s > ev.arrival_s:
            continue
        for d in batch.deltas:
            named = torch.from_numpy(d.rows)
            mine = ids[:, d.table].contiguous()
            at = torch.searchsorted(named, mine).clamp_(
                max=named.numel() - 1)
            hit = named[at] == mine
            rows[:, d.table][hit] = torch.from_numpy(d.values)[at[hit]]
    slab = rows.permute(1, 0, 2, 3).reshape(T, B * L, -1).to(dev)
    fake = (torch.arange(B, device=dev)[:, None, None] * L
            + torch.arange(L, device=dev)[None, None, :]).expand(B, T, L)
    return q, ref.embedding_bag_ref(slab, fake)


def plain_fabric_probs(cfg, params, tables_host, events, dev, batches=()):
    """The probs of ``events`` recomputed in plain torch, apart from any
    fleet (``plain_pooled``), then the dense forward and sigmoid at the
    query's own batch."""
    from repro_torch.core.dlrm import dlrm_forward_from_pooled
    mlps = {k: params[k] for k in ("bot_mlp", "top_mlp")}
    out = {}
    for ev in events:
        q, pooled = plain_pooled(cfg, tables_host, ev, dev, batches)
        out[ev.qid] = torch.sigmoid(dlrm_forward_from_pooled(
            mlps, q["dense"], pooled)).cpu().numpy()
    return out


def drive_fabric(fleet, events, label, scenario, card, bound_bytes, params,
                 errs, batches=(), coherence="propagate"):
    """Serve ``events`` through ``fleet.run`` with the launch counts set to
    0 just before and read just after. Row 4's launches must equal one a
    whole-table owner and one a split pool in each flush, plus the untimed
    warm-ups of new (role, shape) keys; every query answered once with
    finite probs in (0, 1); peak device memory under ``bound_bytes``.
    The first flush of each partition holds every row-4 output it made
    (each owner's lookup, the split pool) against ``ref.embedding_bag_ref``
    on the same inputs (``close``, its errors into ``errs``), and the
    first, middle and last queries' probs against ``plain_fabric_probs``
    at RTOL/ATOL. With ``batches`` the run consumes them as a recorded
    channel under ``coherence``, and the plain path applies each to the
    queries that arrive at or after its emit. Prints the report and a
    ``[fabric]`` line. Returns (report, probs by qid, launches, wall
    seconds)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.online import DeltaChannel
    expected, owner_parts = [], fleet._owner_parts
    checked = set()

    def held(board, idx):
        """owner_parts, with every row-4 output held against its plain
        version."""
        made = []

        def spy(b, name):
            fn = getattr(b, name)

            def wrapped(*args):
                out = fn(*args)
                made.append((name, b, args, out[0]))
                return out
            return wrapped

        boards = list(fleet.boards)
        for b in boards:
            b.lookup, b.pool_rows = spy(b, "lookup"), spy(b, "pool_rows")
        try:
            out = owner_parts(board, idx)
        finally:
            for b in boards:
                del b.lookup, b.pool_rows
        for name, b, args, got in made:
            if name == "lookup":
                tables, ids = b.tables, args[0].to(b.device)
            else:
                tables, ids = (a.to(b.device) for a in args)
            close("embedding_bag", f"{label}, board {b.rid}'s {name}: "
                  f"tables {tuple(tables.shape)}, ids {tuple(ids.shape)}",
                  got, ref.embedding_bag_ref(tables, ids), errs)
        return out

    def counted(board, idx):
        ex = fleet.exchange
        expected.append(sum(t.size > 0 for t in ex.tables_by_board)
                        + int(ex.split_tables.size > 0))
        layout = (tuple(tuple(t) for t in ex.tables_by_board),
                  tuple(ex.split_tables))
        if layout in checked:
            return owner_parts(board, idx)
        checked.add(layout)
        return held(board, idx)

    def warm_keys():
        return {(id(b), k) for b in fleet.boards + fleet._retired
                for k in b.warmed if k[0] in ("lookup", "pool")}

    fleet._owner_parts = counted
    warm0 = warm_keys()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    online = DeltaChannel(batches) if batches else None
    rep = fleet.run(events, sla_ms=50.0, scenario=scenario, online=online,
                    coherence=coherence)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts["embedding_bag"]
    others = {k: v for k, v in ops.launch_counts.items()
              if v and k != "embedding_bag"}
    fleet._owner_parts = owner_parts
    warm = len(warm_keys() - warm0)
    peak = torch.cuda.max_memory_allocated()
    boards = fleet.boards + fleet._retired
    check(sorted(fleet.completed) == [e.qid for e in events]
          and sum(b.served for b in boards) == len(events),
          f"{label}: not every query was answered exactly once")
    probs = {e.qid: fleet.completed[e.qid].probs for e in events}
    stacked = np.stack(list(probs.values()))
    check(stacked.shape == (len(events), fleet.query_size)
          and bool(np.isfinite(stacked).all() and (stacked > 0).all()
                   and (stacked < 1).all()),
          f"{label}: probs not finite in (0, 1)")
    check(launches == sum(expected) + warm,
          f"{label}: row 4 launched {launches} times, expected "
          f"{sum(expected)} over {len(expected)} flushes + {warm} warm-ups")
    check(not others, f"{label}: other kernels launched: {others}")
    check(peak <= bound_bytes, f"{label}: peak {peak / GB:.2f} GB over "
                               f"{bound_bytes / GB:.2f} GB")
    some = [events[0], events[len(events) // 2], events[-1]]
    plain = plain_fabric_probs(fleet.cfg, params, params["tables"], some,
                               fleet.device, batches)
    err = max(float(np.abs(probs[q] - p).max()) for q, p in plain.items())
    check(all(np.allclose(probs[q], p, rtol=RTOL, atol=ATOL)
              for q, p in plain.items()),
          f"{label}: probs disagree with the plain path: max_abs_err="
          f"{err:.3e}")
    print(f"[fabric] {label}: queries {list(plain)}' probs vs the plain "
          f"path (host rows, embedding_bag_ref, dense forward): "
          f"max_abs_err={err:.3e} ok")
    print(rep.summary())
    hit = ("none" if rep.remote_hit_first is None else
           f"{rep.remote_hit_first:.4f} -> {rep.remote_hit_last:.4f}")
    print(f"[fabric] {label}: {len(events)} queries, "
          f"{len(rep.replicas)} boards ({rep.n_replicas_start}->"
          f"{rep.n_replicas_end}), p50 {rep.p50_ms:.4f} ms p99 "
          f"{rep.p99_ms:.4f} ms, achieved/offered QPS "
          f"{rep.achieved_qps:.2f}/{rep.offered_qps:.2f}, "
          f"{rep.bytes_per_query:.1f} B/query, remote lookups "
          f"{rep.remote_lookup_fraction:.4f}, remote hit {hit} "
          f"({rep.cache_refreshes} refreshes), link stall "
          f"{rep.link_stall_share:.4f}, {rep.migrations} scale events, "
          f"{rep.migrated_bytes / 2**20:.2f} MiB migrated; row 4 launches "
          f"{launches} = {sum(expected)} over {len(expected)} flushes + "
          f"{warm} warm-ups; peak {peak / GB:.2f} GB (bound "
          f"{bound_bytes / GB:.2f}), host RSS {rss_bytes()[0] / GB:.2f} GB, "
          f"wall {wall:.2f} s ({card})")
    return rep, probs, launches, wall


def same_probs(fleet_probs, want, label):
    """Every query's probs bitwise equal to the reference run's."""
    bad = [q for q, p in fleet_probs.items() if not np.array_equal(p, want[q])]
    check(not bad, f"{label}: {len(bad)} queries' probs differ bitwise from "
                   f"the reference run (first qid {bad[:1]})")
    print(f"[fabric] {label}: all {len(fleet_probs)} queries' probs bitwise "
          f"equal to the reference run's")


def phase_fabric(dev, card):
    """Phase 9c: the sharded fabric fleet at full width (ROADMAP A7b):
    ``ShardedFleet(get_dlrm("dlrm-rm2-small-unsharded"))``, B = 200,
    capacity 4 queries, max_wait_ms 2, alpha 1.05, the tables drawn once
    from seed 0 into host memory and shared; the boards share the card.
    (a) one board of 20,480 MiB (the reference), (b) three of 7,000 MiB
    under jsq, cache on, (c) as (b) with the cache off, all three over one
    zipf_drift trace at 0.3 x (a)'s measured capacity; (d) two boards at
    the default 12,800 MiB under a flash crowd with an autoscaler to 3,
    against a static 2-board fleet. (b)-(d) must serve bitwise what their
    reference serves, and every run agrees with the plain path
    (``drive_fabric``). Each fleet is freed before the next. Returns (the
    runs, row 4's errors against its plain version, and what phase 9d
    serves next: the host tables (still held), the zipf_drift trace and
    its scenario, and the phase's memory marks, which
    ``release_fabric_tables`` takes)."""
    import gc
    from repro_torch.cluster import SLAAutoscaler
    from repro_torch.configs import get_dlrm
    from repro_torch.core.dlrm import init_mlps
    from repro_torch.fabric import ShardedFleet, fits_one_board
    from repro_torch.hoststore.exchange import draw_host_tables
    from repro_torch.traffic import make_scenario

    t_phase = time.perf_counter()
    cfg = get_dlrm(CONFIG)
    row_bytes = cfg.embed_dim * 4
    table_bytes = cfg.num_tables * cfg.rows_per_table * row_bytes
    base = torch.cuda.memory_allocated()
    rss0, avail0 = rss_bytes()[0], mem_available()
    print(rss_line("phase 9c start"))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dict(init_mlps(cfg, gen), tables=draw_host_tables(cfg, 0, dev))
    print(f"[fabric] tables drawn into host memory in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{params['tables'].numel() * 4 / GB:.2f} GB, shared by every "
          f"fleet below")
    kw = dict(alpha=FABRIC_ALPHA, seed=0, max_batch_queries=4,
              max_wait_ms=2.0, params=params, device=dev)
    out, errs = {}, {}

    def build(label, **fkw):
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() < base + 0.1 * GB,
              f"{label}: an earlier fleet's tensors outlive it")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fleet = ShardedFleet(cfg, **kw, **fkw)
        torch.cuda.synchronize()
        pm = fleet.partition
        print(pm.summary())
        resident = [round(b.resident_bytes(row_bytes) / GB, 3)
                    for b in fleet.boards]
        print(f"[fabric] {label}: {pm.n_boards} boards of "
              f"{pm.board_capacity_bytes / 2**20:.0f} MiB built in "
              f"{time.perf_counter() - t0:.2f} s; resident {resident} GB; "
              f"split tables {pm.split_tables}; {rss_line('built')}")
        return fleet, table_bytes + max(pm.board_bytes) + 2 * GB

    # (a) the reference: one board holds every table
    ref, bound = build("(a)", n_boards=1, router="jsq",
                       board_capacity_bytes=int(FABRIC_REF_MB * 2**20))
    check(ref.boards[0].resident_bytes(row_bytes) == table_bytes,
          "(a): the one board does not hold every table")
    s_cap = ref.measure_service_time()
    qps = 0.3 * 4 / s_cap
    rotate_s = FABRIC_ROTATE_AT * FABRIC_QUERIES / qps
    scen = make_scenario("zipf_drift", alpha=FABRIC_ALPHA,
                         rotate_every_s=rotate_s)
    events = scen.events(FABRIC_QUERIES, qps=qps, seed=0)
    rotations = max(e.perm_salt for e in events) // scen.salt_stride
    check(rotations >= 1, f"the trace spans {rotations} rotations")
    print(f"[fabric] load: 0.3 x 4 queries / {s_cap * 1e3:.4f} ms capacity "
          f"batch = {qps:.2f} qps; zipf_drift, a rotation every "
          f"{rotate_s:.4f} s ({rotations} in {FABRIC_QUERIES} queries)")
    drift_events, drift_scen = events, scen
    rep, want, launches, _ = drive_fabric(ref, events, "(a) 1 board",
                                          "zipf_drift", card, bound, params,
                                          errs)
    check(rep.remote_lookup_fraction == 0 and rep.bytes_per_query == 0,
          "(a): one board sent lookups over the fabric")
    out["(a) 1 board"] = dict(report=rep, launches=launches)
    del ref

    # (b) three boards of 7,000 MiB, cache on; (c) the cache off
    wire = {}
    for label, cache_on in (("(b) 3 boards, cache on", True),
                            ("(c) 3 boards, cache off", False)):
        fleet, bound = build(label[:3], n_boards=3, router="jsq",
                             board_capacity_bytes=int(FABRIC_BOARD_MB * 2**20),
                             cache_enabled=cache_on)
        pm = fleet.partition
        check(not fits_one_board(cfg, pm.board_capacity_bytes,
                                 pm.table_bytes) and pm.split_tables,
              f"{label}: the table set fits one board or no table is split")
        check(all(b.resident_bytes(row_bytes) <= pm.board_capacity_bytes
                  for b in fleet.boards),
              f"{label}: a board holds more than its capacity")
        rep, probs, launches, _ = drive_fabric(
            fleet, events, label, "zipf_drift", card, bound, params, errs)
        same_probs(probs, want, label)
        check(not rep.fits_one_board, f"{label}: reports that it fits")
        if cache_on:
            check(rep.cache_refreshes > 0,
                  f"{label}: the cache never re-elected")
        wire[cache_on] = rep.bytes_per_query
        out[label] = dict(report=rep, launches=launches)
        del fleet
    check(wire[False] > wire[True],
          f"the cache saved no wire bytes: {wire[True]} vs {wire[False]}")

    # (d) elastic: 2 boards at the default capacity, a flash crowd, an
    # autoscaler to 3; against a static 2-board fleet over the same events
    elastic, bound = build("(d)", n_boards=2, router="p2c")
    # the threshold is FLEET_SLA_FACTOR x what a query of the unloaded
    # fleet can take (the batching deadline, then a capacity batch), so
    # the base load stays under it and only the crowd crosses it
    s4 = elastic.measure_service_time(4)
    threshold = FLEET_SLA_FACTOR * (kw["max_wait_ms"] + s4 * 1e3)
    qps = 0.3 * 4 / elastic.measure_service_time()
    k = FABRIC_BURST_AT / (qps * first_burst_s(make_scenario("flash_crowd"),
                                               qps))
    scen = make_scenario("flash_crowd", alpha=FABRIC_ALPHA, on_s=0.5 * k,
                         off_s=1.5 * k)
    events = scen.events(FABRIC_ELASTIC_QUERIES, qps=qps, seed=0)
    burst = first_burst_s(scen, qps)
    auto = SLAAutoscaler(threshold, max_replicas=3)
    elastic.autoscaler = auto
    print(f"[fabric] (d): {qps:.2f} qps (0.3 x capacity), first burst at "
          f"{burst:.4f} s; autoscaler threshold {threshold:.4f} ms "
          f"({FLEET_SLA_FACTOR} x ({kw['max_wait_ms']} ms deadline + the "
          f"4-query capacity batch's {s4 * 1e3:.4f} ms)), max 3 boards")
    rep, probs, launches, _ = drive_fabric(
        elastic, events, "(d) elastic", "flash_crowd", card, bound, params,
        errs)
    ups = [e for e in rep.scale_events if e.action == "up"]
    for e in rep.scale_events:
        print(f"[fabric] (d) scale {e.action} at t={e.t_s:.4f} s -> "
              f"{e.n_replicas} boards, window p99 {e.window_p99_ms:.4f} ms, "
              f"moved {e.remesh}")
    check(ups and all(e.remesh["bytes_moved"] > 0 for e in ups),
          "(d): no scale-up migrated bytes")
    check(ups[0].t_s >= burst,
          f"(d): the fleet scaled up at t={ups[0].t_s:.4f} s, before the "
          f"first burst at {burst:.4f} s: the base load crossed the "
          f"threshold")
    check(all(e.remesh["bytes_moved"] == e.remesh["rows_moved"] * row_bytes
              for e in rep.scale_events),
          "(d): bytes moved are not rows moved x row bytes")
    check(len(auto.migration_log) == rep.migrations > 0
          and rep.migrated_bytes == sum(b for _, b, _ in auto.migration_log),
          "(d): the autoscaler's migration log disagrees with the report")
    out["(d) elastic"] = dict(report=rep, launches=launches)
    del elastic
    static, bound = build("(d) static", n_boards=2, router="p2c")
    rep, want, launches, _ = drive_fabric(
        static, events, "(d) static", "flash_crowd", card, bound, params,
        errs)
    same_probs(probs, want, "(d) elastic vs static")
    out["(d) static"] = dict(report=rep, launches=launches)
    kw.clear()
    del static
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < base + 0.1 * GB,
          "phase 9c: a fleet's tensors outlive it")
    wall = time.perf_counter() - t_phase
    peak_line(f"phase 9c (the sharded fabric fleet; {wall:.1f} s)")
    check(wall <= FABRIC_PHASE_S,
          f"phase 9c took {wall:.1f} s, over {FABRIC_PHASE_S} s")
    held = dict(params=params, events=drift_events, scenario=drift_scen,
                base=base, rss0=rss0, avail0=avail0)
    return out, {k: max(v) for k, v in errs.items()}, held


def release_fabric_tables(held):
    """Let go of the host tables phases 9c and 9d served, check that the
    host RSS is back to 9c's start, and wait for the host to take the
    pages back: phase 10 sizes its tables by MemAvailable."""
    import gc
    base, rss0, avail0 = held["base"], held["rss0"], held["avail0"]
    held.clear()                        # the last hold on the host tables
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < base + 0.1 * GB,
          "phases 9c-9d: a fleet's tensors outlive them")
    rss1 = rss_bytes()[0]
    print(rss_line("phases 9c-9d end"))
    check(rss1 < rss0 + 2 * GB, f"phases 9c-9d: host RSS {rss1 / GB:.2f} "
                                f"GB, {rss0 / GB:.2f} GB at 9c's start: the "
                                f"host tables outlive them")
    # the host takes freed pages back over seconds (~4 GB/s on the card's
    # host), and phase 10 sizes its tables by MemAvailable: wait for them
    t0 = time.perf_counter()
    while (mem_available() < avail0 - 2 * GB
           and time.perf_counter() - t0 < FABRIC_RELEASE_S):
        time.sleep(0.25)
    print(f"[host] phases 9c-9d: MemAvailable back to "
          f"{mem_available() / GB:.2f} GB ({avail0 / GB:.2f} GB at 9c's "
          f"start) after {time.perf_counter() - t0:.1f} s")
    check(mem_available() >= avail0 - 2 * GB,
          f"phases 9c-9d: the host did not take its memory back in "
          f"{FABRIC_RELEASE_S} s")


# -------------------------------------------------------------- phase 9d
def record_channel(cfg, params, events, scen, dev, label):
    """The online stream of a trace, recorded before serving as the
    launchers record it: an ``OnlineTrainer`` on a copy of ``params``'
    tables (lr ONLINE_LR, one step an update, the scenario's drift salt at
    each emit) driven by an ``OnlineSource`` whose interval puts
    ONLINE_UPDATES batches inside the trace; then the trainer, and its
    host copy of the tables, is freed. Returns (the batches, the trainer's
    timings)."""
    import gc
    from repro_torch.online import OnlineSource, OnlineTrainer
    horizon = events[-1].arrival_s
    interval = horizon / (ONLINE_UPDATES + 0.5)
    t0 = time.perf_counter()
    trainer = OnlineTrainer(cfg, params, lr=ONLINE_LR, seed=0,
                            alpha=FABRIC_ALPHA, device=dev)
    copy_s = time.perf_counter() - t0
    step_s, train = [], trainer.train_steps

    def timed(n, salt=0):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = train(n, salt=salt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return loss

    trainer.train_steps = timed
    src = OnlineSource(trainer, interval_s=interval, steps_per_update=1,
                       salt_fn=lambda t: scen.stream_params(t)[1])
    t0 = time.perf_counter()
    batches = list(src.run_to(horizon).emitted)
    run_s = time.perf_counter() - t0
    del src, trainer, train
    gc.collect()
    rows = [b.n_rows for b in batches]
    salts = [scen.stream_params(b.t_emit_s)[1] for b in batches]
    check(len(batches) == ONLINE_UPDATES and min(rows) > 0,
          f"{label}: {len(batches)} batches of {rows} rows")
    check(all(math.isfinite(b.train_loss) for b in batches),
          f"{label}: a training loss is not finite")
    emit_ms = (run_s - sum(step_s)) / len(batches) * 1e3
    print(f"[online] {label}: trainer copied the tables in {copy_s:.2f} s; "
          f"{len(batches)} batches, one every {interval * 1e3:.4f} ms of "
          f"virtual time (salts {salts}), lr {ONLINE_LR}, B="
          f"{cfg.batch_size}; a step (unique rows to the card, forward and "
          f"backward there, rows back) p50 "
          f"{np.percentile(step_s, 50) * 1e3:.3f} ms max "
          f"{max(step_s) * 1e3:.3f} ms, a batch's diff of the touched rows "
          f"{emit_ms:.3f} ms; rows a batch {rows}; losses "
          f"{[round(b.train_loss, 4) for b in batches]}")
    return batches, dict(copy_s=copy_s, step_ms=[x * 1e3 for x in step_s],
                         emit_ms=emit_ms, rows=rows)


def timed_method(obj, name, sink):
    """Wrap ``obj.name`` so each call's wall seconds (device work
    included) go to ``sink``."""
    fn = getattr(obj, name)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t)
        return out

    setattr(obj, name, timed)


def updated_rows(batches):
    """{table: sorted unique rows any batch updated}."""
    out = {}
    for b in batches:
        for d in b.deltas:
            out.setdefault(d.table, []).append(d.rows)
    return {t: np.unique(np.concatenate(r)) for t, r in out.items()}


def online_plain(label, cfg, params, batches, events, probs, dev):
    """Three queries' probs -- one arriving before the first emit, two
    after later versions -- against the plain path that applies each
    batch emitted at or before the query's arrival."""
    emits = [b.t_emit_s for b in batches]
    picks = [events[0],
             next(e for e in events if e.arrival_s > emits[1]),
             events[-1]]
    check(picks[0].arrival_s < emits[0] and picks[2].arrival_s > emits[-2],
          f"{label}: the picked queries do not straddle the emits")
    plain = plain_fabric_probs(cfg, params, params["tables"], picks, dev,
                               batches)
    err = max(float(np.abs(probs[q] - p).max()) for q, p in plain.items())
    check(all(np.allclose(probs[q], p, rtol=RTOL, atol=ATOL)
              for q, p in plain.items()),
          f"{label}: probs disagree with the plain path: max_abs_err="
          f"{err:.3e}")
    seen = [sum(t <= e.arrival_s for t in emits) for e in picks]
    # the batches changed what the last query pools; at lr ONLINE_LR a
    # row moves ~1% of itself, so its probs may not move in fp32
    _, frozen = plain_pooled(cfg, params["tables"], picks[2], dev)
    _, updated = plain_pooled(cfg, params["tables"], picks[2], dev, batches)
    moved = float((updated - frozen).abs().max() / frozen.abs().max())
    shift = float(np.abs(plain_fabric_probs(
        cfg, params, params["tables"], picks[2:], dev)[picks[2].qid]
        - probs[picks[2].qid]).max())
    check(moved > 0, f"{label}: the batches did not change the last "
                     f"query's pooled rows")
    print(f"[online] {label}: queries {list(plain)} (seeing {seen} of "
          f"{len(batches)} batches) vs the plain path (host rows, the "
          f"batches applied by arrival, embedding_bag_ref, dense forward): "
          f"max_abs_err={err:.3e} ok; the batches moved the last query's "
          f"pooled rows by up to {moved:.3e} of their scale and its probs "
          f"by {shift:.3e}")


def latest_rows(tables_host, batches):
    """{table: (rows any batch updated, their values after every batch in
    order, on top of ``tables_host``)}."""
    out = {}
    for t, rows in updated_rows(batches).items():
        out[t] = (rows, tables_host[t, torch.from_numpy(rows)].clone())
    for b in batches:
        for d in b.deltas:
            rows, vals = out[d.table]
            vals[torch.from_numpy(np.searchsorted(rows, d.rows))] = \
                torch.from_numpy(d.values)
    return out


def check_replica_rows(cluster, latest, dev):
    """Every updated row on every replica bitwise its latest value."""
    for r in cluster.replicas:
        for t, (rows, vals) in latest.items():
            got = r.session.params["tables"][t, torch.from_numpy(rows).to(
                dev)].cpu()
            check(torch.equal(got, vals),
                  f"(i): r{r.rid}'s table {t} rows differ from the "
                  f"batches' latest values")


def check_owner_rows(fleet, ids, label, dev):
    """Every owner's resident rows at the updated ids (``ids``: {table:
    rows}) bitwise the fleet's host rows."""
    host = fleet._tables_host
    for t, r in ids.items():
        rows_t = torch.from_numpy(r)
        for b in fleet.boards:
            if t in b.split_rows:
                row_ids, resident = b.split_rows[t]
                mine = rows_t[torch.isin(rows_t, row_ids.cpu())]
                got = resident[torch.searchsorted(row_ids,
                                                  mine.to(dev))].cpu()
            elif t in b.table_ids:
                j = int(np.searchsorted(b.table_ids, t))
                mine = rows_t
                got = b.tables[j, rows_t.to(dev)].cpu()
            else:
                continue
            check(torch.equal(got, host[t, mine]),
                  f"{label}: board {b.rid}'s resident rows of table {t} "
                  f"differ from the host tables")


def online_replicated(dev, card, params):
    """9d(i): ``Cluster(get_dlrm("dlrm-rm2-small-unsharded"))`` of 2
    replicas, plan none, B = 200, capacity 4, max_wait_ms 2, the
    planner's depth, round robin, serving a zipf_drift trace of
    ONLINE_QUERIES queries at the launcher's default load while a
    recorded channel of ONLINE_UPDATES batches is broadcast at its update
    barriers. Returns the run's numbers."""
    from repro_torch.cluster import Cluster
    from repro_torch.configs import get_dlrm
    from repro_torch.online import DeltaChannel
    from repro_torch.traffic import make_scenario
    cfg = get_dlrm(CONFIG)
    table_bytes = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cluster = Cluster(cfg, n_replicas=2, max_batch_queries=4,
                      max_wait_ms=2.0, router="round_robin",
                      alpha=FABRIC_ALPHA, device=dev)
    # the replicas drew their tables from seed 0, as 9c's host copy
    sample = torch.arange(0, cfg.rows_per_table, 65_537)
    check(all(torch.equal(r.session.params["tables"][:, sample].cpu(),
                          params["tables"][:, sample])
              for r in cluster.replicas),
          "(i): a replica's tables are not 9c's host tables")
    qps = default_load(cluster)
    scen = make_scenario("zipf_drift", alpha=FABRIC_ALPHA,
                         rotate_every_s=0.5 * ONLINE_QUERIES / qps)
    events = scen.events(ONLINE_QUERIES, qps=qps, seed=0)
    batches, train = record_channel(cfg, params, events, scen, dev, "(i)")
    apply_s = []
    timed_method(cluster, "_apply_update", apply_s)
    rep, launches, depths = drive_fleet(
        cluster, events, "(i) online zipf_drift", "zipf_drift", card,
        online=DeltaChannel(batches))
    peak = torch.cuda.max_memory_allocated()
    o = rep.online
    check(o is not None and o.n_updates == len(batches) == len(apply_s),
          f"(i): {o and o.n_updates} updates applied of {len(batches)}")
    check(o.rows_pushed == sum(b.n_rows for b in batches),
          "(i): rows pushed differ from the batches' rows")
    check(launches["fused_bag_interactions"] == sum(depths),
          "(i): row 1's launches differ from the sum of resolved depths "
          "over the flushes, update flushes included")
    check_replica_rows(cluster, latest_rows(params["tables"], batches), dev)
    probs = {e.qid: cluster.completed[e.qid].probs for e in events}
    online_plain("(i)", cfg, params, batches, events, probs, dev)
    check(peak < 2 * table_bytes + 2 * GB,
          f"(i): peak {peak / GB:.2f} GB over 2 x the tables + 2 GB")
    flushes = sum(len(r.batch_sizes) for r in cluster.replicas)
    print(o.summary())
    print(f"[online] (i) replicated: {o.n_updates} batches broadcast to 2 "
          f"replicas, {o.rows_pushed} rows a replica; apply (host -> card "
          f"scatter into both replicas' tables) "
          f"{[round(x * 1e3, 3) for x in apply_s]} ms; staleness p50 "
          f"{o.staleness_p50_s * 1e3:.4f} ms max "
          f"{o.staleness_max_s * 1e3:.4f} ms; {flushes} flushes; p50 "
          f"{rep.p50_ms:.4f} ms p99 {rep.p99_ms:.4f} ms; row 1 launches "
          f"{launches['fused_bag_interactions']}; peak {peak / GB:.2f} GB "
          f"(bound {(2 * table_bytes + 2 * GB) / GB:.2f}) ({card})")
    out = dict(report=rep, launches=launches["fused_bag_interactions"],
               apply_ms=[x * 1e3 for x in apply_s], peak_gb=peak / GB,
               train=train)
    del cluster
    free_fleet(base, "(i)")
    return out


def online_sharded(dev, card, held, errs):
    """9d(ii): the sharded fleet over 9c's host tables and its zipf_drift
    trace, on one recorded channel: (a) one board of FABRIC_REF_MB, (b)
    three of FABRIC_BOARD_MB (table 39 split, cache on) under
    coherence="propagate", (c) as (b) with "invalidate". Returns the
    runs."""
    import gc
    from repro_torch.configs import get_dlrm
    from repro_torch.fabric import ShardedFleet
    cfg = get_dlrm(CONFIG)
    params, events, scen = held["params"], held["events"], held["scenario"]
    row_bytes = cfg.embed_dim * 4
    table_bytes = cfg.num_tables * cfg.rows_per_table * row_bytes
    base = torch.cuda.memory_allocated()
    rss0 = rss_bytes()[0]
    batches, train = record_channel(cfg, params, events, scen, dev, "(ii)")
    ids = updated_rows(batches)
    orig = {t: params["tables"][t, torch.from_numpy(r)].clone()
            for t, r in ids.items()}
    latest = latest_rows(params["tables"], batches)
    runs, want = {}, None
    for label, n_boards, mb, mode in (
            ("(a) 1 board", 1, FABRIC_REF_MB, "propagate"),
            ("(b) 3 boards, propagate", 3, FABRIC_BOARD_MB, "propagate"),
            ("(c) 3 boards, invalidate", 3, FABRIC_BOARD_MB, "invalidate")):
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() < base + 0.1 * GB,
              f"{label}: an earlier fleet's tensors outlive it")
        torch.cuda.reset_peak_memory_stats()
        fleet = ShardedFleet(cfg, n_boards=n_boards, router="jsq",
                             board_capacity_bytes=int(mb * 2**20),
                             alpha=FABRIC_ALPHA, seed=0, max_batch_queries=4,
                             max_wait_ms=2.0, params=params, device=dev)
        pm = fleet.partition
        check(n_boards == 1 or pm.split_tables == (cfg.num_tables - 1,),
              f"{label}: split tables {pm.split_tables}")
        bound = table_bytes + max(pm.board_bytes) + 2 * GB
        apply_s = []
        timed_method(fleet, "_apply_delta", apply_s)
        rep, probs, launches, wall = drive_fabric(
            fleet, events, f"9d(ii) {label}", "zipf_drift", card, bound,
            params, errs, batches=batches, coherence=mode)
        o = rep.online
        check(o.n_updates == len(batches) == len(apply_s)
              and o.rows_pushed == sum(b.n_rows for b in batches),
              f"{label}: {o.n_updates} updates, {o.rows_pushed} rows pushed")
        if want is None:
            want = probs
        else:
            same_probs(probs, want, f"9d(ii) {label} vs (a)")
        # every owner's resident rows at the updated ids are the fleet's
        # host rows; the host tables 9c shares are untouched
        check(fleet._tables_host.data_ptr() != params["tables"].data_ptr(),
              f"{label}: the fleet wrote the shared host tables")
        check(all(torch.equal(params["tables"][t, torch.from_numpy(r)],
                              orig[t]) for t, r in ids.items()),
              f"{label}: 9c's host tables changed")
        check(all(torch.equal(fleet._tables_host[t, torch.from_numpy(r)],
                              v) for t, (r, v) in latest.items()),
              f"{label}: the fleet's host rows are not the batches' latest")
        check_owner_rows(fleet, ids, label, dev)
        caches = sum(c._last_used.nbytes + c._counts.nbytes
                     + c._cached.nbytes + c._remote.nbytes
                     for c in fleet.caches)
        last_used = sum(c._last_used.nbytes for c in fleet.caches)
        rss = rss_bytes()[0]
        grown = rss - rss0
        check(grown < table_bytes + caches + ONLINE_SLACK_BYTES,
              f"{label}: host RSS grew {grown / GB:.2f} GB over the "
              f"phase's start, past the tables + the caches' arrays + "
              f"{ONLINE_SLACK_BYTES / GB:.0f} GB")
        print(o.summary())
        print(f"[online] 9d(ii) {label} ({mode}): p50 {rep.p50_ms:.4f} ms "
              f"p99 {rep.p99_ms:.4f} ms; {o.n_updates} updates, "
              f"{o.rows_pushed} rows pushed, {o.rows_propagated} "
              f"propagated, {o.cache_invalidated_rows} invalidated, push "
              f"stall {o.push_stall_s * 1e3:.4f} ms, staleness p50 "
              f"{o.staleness_p50_s * 1e3:.4f} ms max "
              f"{o.staleness_max_s * 1e3:.4f} ms; apply (host rows, "
              f"owners' resident rows, caches) "
              f"{[round(x * 1e3, 3) for x in apply_s]} ms, the first with "
              f"the copy of the shared host tables ({fleet.host_copy_s:.3f} "
              f"s); row 4 launches {launches}; host RSS {rss / GB:.2f} GB, "
              f"{grown / GB:.2f} GB over the phase's start (the fleet's "
              f"cache arrays {caches / GB:.2f} GB, of which _last_used "
              f"{last_used / GB:.2f} GB); wall {wall:.2f} s ({card})")
        runs[label] = dict(report=rep, launches=launches,
                           apply_ms=[x * 1e3 for x in apply_s],
                           copy_s=fleet.host_copy_s, rss_grown_gb=grown / GB)
        del fleet
    b, c = (runs[k]["report"].online for k in sorted(runs)[1:])
    check(b.rows_propagated > 0 and b.cache_invalidated_rows == 0,
          "(b): propagate mode did not propagate")
    check(c.rows_propagated == 0
          and c.cache_invalidated_rows > b.cache_invalidated_rows,
          "(c): invalidate mode propagated or invalidated no more than (b)")
    gc.collect()
    torch.cuda.empty_cache()
    return runs, batches, train


def online_launchers(card):
    """9d(iii): the launchers at --smoke on the card: train --emit-deltas
    into build/, then serve --replay-deltas in both fleet modes (one
    update a recorded batch); then serve --online-every-s
    --record-deltas in both modes, each recording reloaded equal, batch
    for batch, to the channel the run consumed."""
    import contextlib
    import io
    import re
    from repro_torch.launch import serve, train
    from repro_torch.online import DeltaChannel, OnlineSource
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "online_train_deltas.jsonl")

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        out = buf.getvalue()
        check(rc == 0, f"{argv} exited {rc}:\n{out}")
        return out

    out = run(train.main, ["--smoke", "--steps", "12", "--emit-deltas",
                           path, "--delta-every-steps", "4",
                           "--delta-dt-s", "0.005"])
    n = len(DeltaChannel.load(path))
    check(n == 3, f"train --emit-deltas recorded {n} batches, not 3")
    fleets = {"replicated": ["--replicas", "2"],
              "sharded": ["--replicas", "3", "--fleet-mode", "sharded",
                          "--board-capacity-mb", "0.045"]}
    common = ["--smoke", "--queries", "24", "--qps", "600"]
    counts = {}
    for mode, extra in fleets.items():
        out = run(serve.main, [*common, *extra, "--replay-deltas", path])
        got = re.search(r"\[online\] (\d+) updates", out)
        check(got is not None and int(got.group(1)) == n,
              f"serve --replay-deltas ({mode}) applied {got and got.group(1)}"
              f" of {n} batches")
        counts[f"replay {mode}"] = int(got.group(1))
    consumed, run_to = [], OnlineSource.run_to

    def kept(self, t_end):
        ch = run_to(self, t_end)
        consumed.append(list(ch.emitted))
        return ch

    OnlineSource.run_to = kept
    try:
        for mode, extra in fleets.items():
            rec = os.path.join(BUILD_DIR, f"online_serve_{mode}.jsonl")
            out = run(serve.main, [*common, *extra, "--scenario",
                                   "zipf_drift", "--online-every-s", "0.006",
                                   "--record-deltas", rec])
            got = re.search(r"\[online\] (\d+) updates", out)
            loaded = DeltaChannel.load(rec).emitted
            check(got is not None and int(got.group(1)) == len(loaded) > 0,
                  f"serve --online-every-s ({mode}): {got and got.group(1)} "
                  f"updates, {len(loaded)} recorded")
            for a, b in zip(loaded, consumed[-1], strict=True):
                check((a.version, a.t_emit_s, a.step, a.tables)
                      == (b.version, b.t_emit_s, b.step, b.tables)
                      and all(np.array_equal(x.rows, y.rows)
                              and np.array_equal(x.values, y.values)
                              for x, y in zip(a.deltas, b.deltas)),
                      f"{rec}: batch {a.version} reloads unequal")
            counts[f"online {mode}"] = len(loaded)
    finally:
        OnlineSource.run_to = run_to
    print(f"[online] (iii) launchers at --smoke on the card: train "
          f"--emit-deltas recorded {n} batches; updates applied {counts}; "
          f"each --record-deltas file reloads equal to the channel its run "
          f"consumed ({card})")
    return counts


def online_tiered(dev, held, batches, errs):
    """Coherence under row 6: ``refresh_tiered`` on a two-tier store of
    ONLINE_TIER_ROWS rows a table (9c's tables cut to them,
    ``measure_row_freq`` + ``build_tiered_tables`` on the card), one
    online batch's rows below the cut; row 6 pools lookups of the updated
    rows and is held against ``embedding_bag_ref`` on the updated bulk.
    Returns row 6's launches."""
    from repro_torch.configs import get_dlrm
    from repro_torch.core import tiered_embedding as te
    from repro_torch.kernels import ops, ref
    from repro_torch.online import DeltaBatch, RowDelta, refresh_tiered
    cfg = get_dlrm(CONFIG)
    R = ONLINE_TIER_ROWS
    cut = dataclasses.replace(cfg, rows_per_table=R)
    tables = held["params"]["tables"][:, :R].to(dev)
    counts = te.measure_row_freq(cut, FABRIC_ALPHA, seed=0, n_batches=4,
                                 device=dev)
    store = te.build_tiered_tables(tables, counts, HOT_PER_TABLE)
    del tables, counts
    batch = DeltaBatch(version=1, t_emit_s=0.0, step=1, deltas=tuple(
        RowDelta(d.table, d.rows[d.rows < R], d.values[d.rows < R])
        for d in batches[0].deltas if (d.rows < R).any()))
    bulk0 = store.bulk.clone()
    fresh, n_fast = refresh_tiered(store, batch)
    check(torch.equal(store.bulk, bulk0),
          "refresh_tiered changed its input store")
    del bulk0
    check(0 < n_fast < batch.n_rows,
          f"refresh_tiered: {n_fast} of {batch.n_rows} rows hot")
    gen = torch.Generator(device=dev).manual_seed(91)
    B, T, L = cfg.batch_size, cfg.num_tables, cfg.lookups_per_table
    ids = torch.randint(0, R, (B, T, L), generator=gen, device=dev,
                        dtype=torch.int32)
    for d in batch.deltas:
        rows = torch.from_numpy(d.rows).to(dev, torch.int32)
        pick = torch.randint(0, rows.numel(), (B, L), generator=gen,
                             device=dev)
        ids[:, d.table] = rows[pick]
        check(torch.equal(fresh.bulk[d.table, rows.long()].cpu(),
                          torch.from_numpy(d.values)),
              f"refresh_tiered: table {d.table}'s bulk rows")
    hot = te.hit_mask(fresh, ids)
    ops.reset_launch_counts()
    got = te.tiered_embedding_bag(fresh, ids)
    launches = ops.launch_counts["cached_embedding_bag"]
    check(launches == 1, f"row 6 launched {launches} times for one pool")
    close("cached_embedding_bag",
          f"refresh_tiered store ({R} rows a table, S={HOT_PER_TABLE}), "
          f"B={B} lookups of {batch.n_rows} updated rows ({n_fast} hot; "
          f"{float(hot.float().mean()):.4f} of lookups hot) vs "
          f"embedding_bag_ref on the updated bulk",
          got, ref.embedding_bag_ref(fresh.bulk[:, :R], ids), errs)
    return launches


def phase_online(dev, card, held):
    """Phase 9d: online updates at full width (ROADMAP A7c), on 9c's host
    tables: (i) the replicated fleet, (ii) the sharded fleet in both
    coherence modes on one recorded channel, (iii) the launchers at
    --smoke, then row 6 under ``refresh_tiered``. Returns (the runs,
    each kernel's launches on the online path, the errors)."""
    t_phase = time.perf_counter()
    print(rss_line("phase 9d start"))
    errs = {}
    replicated = online_replicated(dev, card, held["params"])
    runs, batches, train = online_sharded(dev, card, held, errs)
    launchers = online_launchers(card)
    row6 = online_tiered(dev, held, batches, errs)
    torch.cuda.synchronize()
    launches = {"fused_bag_interactions": replicated["launches"],
                "embedding_bag": sum(r["launches"] for r in runs.values()),
                "cached_embedding_bag": row6}
    wall = time.perf_counter() - t_phase
    print(rss_line("phase 9d end"))
    peak_line(f"phase 9d (online updates; {wall:.1f} s)")
    print(f"[online] phase 9d: {wall:.1f} s; launches on the online path "
          f"{launches} ({card})")
    check(wall <= ONLINE_PHASE_S,
          f"phase 9d took {wall:.1f} s, over {ONLINE_PHASE_S} s")
    return (dict(replicated=replicated, sharded=runs, launchers=launchers,
                 train=train, wall_s=wall), launches,
            {k: max(v) for k, v in errs.items()})


# --------------------------------------------------------------- phase 10
def mem_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def rss_bytes():
    """The process's host resident set now (/proc/self/statm) and at its
    peak (getrusage's ru_maxrss), in bytes."""
    import resource
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def rss_line(label: str) -> str:
    rss, peak = rss_bytes()
    return (f"[host] {label}: RSS {rss / GB:.2f} GB, peak RSS "
            f"{peak / GB:.2f} GB, MemAvailable {mem_available() / GB:.2f} GB")


def host_tier_config():
    """RM2-large at full width, unless host memory cannot hold its tables
    plus HOST_SPARE_BYTES: then its rows are cut to the largest power of
    two that fits (T, L, d and B never), and the cut tables must still
    exceed the device budget, so the tier still spills."""
    from repro_torch.configs import get_dlrm
    cfg = get_dlrm(HOST_CONFIG)
    avail = mem_available()
    row_bytes = cfg.num_tables * cfg.embed_dim * 4
    rows = cfg.rows_per_table
    while rows * row_bytes + HOST_SPARE_BYTES > avail:
        rows //= 2
    budget = HOST_BUDGET_MB * 2**20
    print(f"[host] MemAvailable {avail / GB:.2f} GB; {cfg.name} tables "
          f"{cfg.rows_per_table * row_bytes / GB:.2f} GB + "
          f"{HOST_SPARE_BYTES / GB:.0f} GB spare "
          f"{'fit' if rows == cfg.rows_per_table else 'do not fit'}")
    if rows != cfg.rows_per_table:
        print(f"[host] rows cut to {rows} a table "
              f"({rows * row_bytes / GB:.2f} GB of tables)")
        cfg = dataclasses.replace(cfg, rows_per_table=rows)
    check(rows * row_bytes > budget, f"the tables ({rows * row_bytes / GB:.2f}"
          f" GB) fit the device budget: the tier would not spill")
    return cfg


class HostTableView:
    """Table t of a host-tier session as its step sees it: each row from
    the hot slab, the chunk cache or the host store, whichever holds its
    live value. Indexed like a (R, d) tensor on the card."""

    def __init__(self, ex, t):
        self.ex, self.t = ex, t
        self.shape = (ex.mgr.R, ex.mgr.d)
        self.is_cuda = True

    def __getitem__(self, rows):
        ex, t, dev = self.ex, self.t, self.ex.device
        one = isinstance(rows, int)
        r = torch.as_tensor(rows).reshape(-1).long().cpu()
        slot = torch.from_numpy(ex._hot_map_np[t])[r]
        pos = torch.from_numpy(ex.mgr.host_pos[t])[r]
        out = ex.mgr.host[t][r].to(dev)
        hot = slot >= 0
        cached = ~hot & (pos < ex.mgr.pad_pos)
        out[hot.to(dev)] = ex.hot_slab[t][slot[hot].to(dev)]
        out[cached.to(dev)] = ex.mgr.device_cache[pos[cached].long().to(dev)]
        return out[0] if one else out


def serve_host_queries(sess, steps, label, stop=None):
    """Serve one query a flush for each stream step of ``steps`` (until
    ``stop()`` says so) and print, for each, the service time, the
    modeled stall, the measured transfer and its rate, and the chunk
    accounting. Returns {step: (query, probs, modeled stall)}."""
    ex = sess.exchange
    out, services = {}, []
    for step in steps:
        q = sess._make_query(step)
        probs, service, stall = sess._execute([q])
        plan = ex._last_plan
        st = plan.stats
        need = sum(s.needed_chunks for s in st)
        hits = sum(s.hit_chunks for s in st)
        bytes_in = sum(s.bytes_in for s in st)
        copy_s = plan.copy_s
        rate = f"{bytes_in / copy_s / GB:.2f} GB/s" if copy_s else "-"
        print(f"[host] {label} step {step}: service "
              f"{service * 1e3:.3f} ms (modeled stall {stall * 1e3:.3f} "
              f"ms), transfer {copy_s * 1e3:.3f} ms at {rate}, faults "
              f"{plan.faulted_chunks}, evictions "
              f"{sum(s.evicted_chunks for s in st)}, writebacks "
              f"{sum(s.writebacks for s in st)}, bytes moved "
              f"{plan.bytes_moved}, chunk hit ratio "
              f"{hits / need if need else 1.0:.4f}")
        check(np.isfinite(probs).all() and (probs > 0).all()
              and (probs < 1).all(), f"{label} step {step}: probs not "
                                     f"finite in (0, 1)")
        out[step] = (q, probs, stall)
        services.append(service)
        if stop is not None and stop():
            break
    ms = np.array(services) * 1e3
    print(f"[host] {label}: {len(ms)} queries, service p50 "
          f"{np.percentile(ms, 50):.3f} ms p99 {np.percentile(ms, 99):.3f} ms")
    return out


def per_table_reference(mgr, mlps, served, dev):
    """The probs of ``served`` ({step: (query, probs)}) by the plain path,
    a table at a time: each table copied from the host store to the card,
    its plain embedding_bag, then the plain MLPs. Prints and checks
    allclose at RTOL/ATOL."""
    from repro_torch.core import dlrm
    T, R, d = mgr.T, mgr.R, mgr.d
    table = torch.empty((R, d), device=dev)
    pooled = {s: torch.empty((q["indices"].shape[0], T, d), device=dev)
              for s, (q, *_) in served.items()}
    t0 = time.perf_counter()
    for t in range(T):
        mgr.rows_to_device(np.arange(t * R, (t + 1) * R), table)
        for s, (q, *_) in served.items():
            pooled[s][:, t] = dlrm.embedding_bag(
                table[None], q["indices"][:, t:t + 1])[:, 0]
    for s, (q, probs, _) in served.items():
        want = torch.sigmoid(dlrm.dlrm_forward_from_pooled(
            mlps, q["dense"], pooled[s])).cpu().numpy()
        err = float(np.abs(probs[0] - want).max())
        ok = np.allclose(probs[0], want, rtol=RTOL, atol=ATOL)
        print(f"[host] step {s}: served probs vs the per-table plain path "
              f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
        check(ok, f"host-tier probs of step {s} disagree with the "
                  f"per-table plain path")
    print(f"[host] per-table reference over {T} tables in "
          f"{time.perf_counter() - t0:.2f} s")


def measure_host_link(dev):
    """This card's host link as a calibration artifact: the event time of
    a one-row (512 B) pinned copy to the card, and the rate of 256 MiB
    pinned copies."""
    def per_copy_ms(n_floats, iters):
        src = torch.empty(n_floats, pin_memory=True)
        dst = torch.empty(n_floats, device=dev)
        return time_ms(lambda _: dst.copy_(src, non_blocking=True), 1,
                       iters)

    lat_ms = per_copy_ms(128, 200)
    big = 64 * 2**20
    bw = big * 4 / (per_copy_ms(big, 10) / 1e3)
    link = {"latency_us": lat_ms * 1e3, "bandwidth_gbs": bw / 1e9}
    print(f"[host] measured host link: {link['latency_us']:.3f} us a "
          f"512 B pinned copy, {link['bandwidth_gbs']:.2f} GB/s pinned "
          f"256 MiB copies")
    return {"host_link": link}


def host_bitwise(dev, calib):
    """At RM2-large's reduced config, over its budget: host-tier serving
    equals Engine(plan="none") at the same depth, bitwise, cold and warm;
    host-tier SGD training (6 steps), flushed back, equals plan-none
    training: tables, MLPs, losses. Run under deterministic algorithms,
    so both sides scatter in the order of their ids (CUDA's index_add_
    otherwise adds repeated rows in no fixed order). The plan-none
    session serves the composed path, as the host tier does. Also serves
    one session with the measured ``calib``. Batch 8, as the reference's
    own tests of these contracts (``tests/test_hoststore.py``)."""
    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine
    cfg = dataclasses.replace(get_dlrm(HOST_CONFIG).reduced(), batch_size=8)
    cap = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4 / 1.6
    cap_mb = cap / 2**20
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = Engine(cfg, pipeline_depth=4, fused_serve="off") \
            .serve_session(max_batch_queries=1)
        host = Engine(cfg, pipeline_depth=4, alpha=TIERED_ALPHA,
                      host_capacity_mb=cap_mb, host_hot_fraction=0.25,
                      host_chunk_rows=1).serve_session(max_batch_queries=1)
        queries = [ref._make_query(s, alpha=TIERED_ALPHA) for s in range(24)]
        faults = []
        for _ in ("cold", "warm"):
            before = host.exchange.mgr.stats.faulted_chunks
            for q in queries:
                check(np.array_equal(ref._execute([q])[0],
                                     host._execute([q])[0]),
                      "host-tier serving differs from plan=none")
            faults.append(host.exchange.mgr.stats.faulted_chunks - before)
        st = host.exchange.mgr.stats
        check(st.evicted_chunks > 0 and faults[1] < faults[0],
              f"the reduced host tier did not turn over: {st}")
        print(f"[host] reduced {cfg.name}: host-tier serving == plan=none "
              f"at depth 4, bitwise, 24 queries cold ({faults[0]} faults) "
              f"and warm ({faults[1]}), {st.evicted_chunks} evictions")
        kw = dict(lr=0.05, pipeline_depth=4)
        plain = Engine(cfg, **kw).train_session()
        rep_p = plain.run(6)
        tier = Engine(cfg, host_capacity_mb=cap_mb, host_hot_fraction=0.25,
                      host_chunk_rows=2, **kw).train_session()
        rep_t = tier.run(6)
        flushed = tier.exchange_inst.flush_host_weights()
        check(torch.equal(flushed, plain.params["tables"].cpu()),
              "host-tier training's flushed tables differ from plan=none")
        check(all(torch.equal(a[n], b[n]) for k in ("bot_mlp", "top_mlp")
                  for a, b in zip(plain.params[k], tier.params[k])
                  for n in a), "host-tier training's MLPs differ")
        lp = [float(h["loss"]) for h in rep_p.history]
        check(lp == [float(h["loss"]) for h in rep_t.history],
              "host-tier training's losses differ")
        wb = tier.exchange_inst.mgr.stats.writebacks
        check(wb > 0, "the reduced training wrote nothing back")
        print(f"[host] reduced {cfg.name}: host-tier SGD (6 steps, depth "
              f"4, {wb} writebacks) + flush == plan=none training, "
              f"bitwise: tables, MLPs, losses {lp[0]:.6f} .. {lp[-1]:.6f}")
    finally:
        torch.use_deterministic_algorithms(False)
    cal = Engine(cfg, alpha=TIERED_ALPHA, host_capacity_mb=cap_mb,
                 host_hot_fraction=0.25, host_chunk_rows=1,
                 calibration=calib).serve_session(max_batch_queries=1)
    link = cal.exchange.link
    check(abs(link.bandwidth / 1e9 - calib["host_link"]["bandwidth_gbs"])
          < 1e-6, "the calibrated session does not use the measured link")
    cal._execute([cal._make_query(5)])
    print(f"[host] Engine(calibration=measured): {cal.exchange.summary()}")


def host_serve_paired(cfg, dev, card):
    """Phase 10a: ``Engine(cfg, host_capacity_mb=HOST_BUDGET_MB,
    alpha=1.05).serve_session()`` draws the store and serves 16 queries
    at depth 1, then a depth-4 session on the same exchange serves until
    chunks fault in again after their eviction; three queries are held
    against the per-table plain path. Returns both sessions and the
    checked queries ({step: (query, probs, modeled stall)})."""
    from repro_torch.engine import Engine, ServeSession
    from repro_torch.kernels import ops

    table_bytes = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    budget = HOST_BUDGET_MB * 2**20
    t0 = time.perf_counter()
    eng = Engine(cfg, host_capacity_mb=HOST_BUDGET_MB, alpha=TIERED_ALPHA)
    sess = eng.serve_session(max_batch_queries=1)
    torch.cuda.synchronize()
    ex = sess.exchange
    store = ex.mgr.host
    print(f"[host] {cfg.name}: T={cfg.num_tables} R={cfg.rows_per_table} "
          f"d={cfg.embed_dim} L={cfg.lookups_per_table} B={cfg.batch_size}, "
          f"tables {table_bytes / GB:.2f} GB fp32 in host memory, device "
          f"budget {budget / GB:.2f} GB; session built in "
          f"{time.perf_counter() - t0:.2f} s; {ex.summary()}; device "
          f"allocated {torch.cuda.memory_allocated() / GB:.2f} GB")
    print(rss_line("store drawn"))
    check(sess.serve_kernel == "composed" and sess.pipeline_depth == 1,
          f"the host tier serves {sess.serve_kernel} at depth "
          f"{sess.pipeline_depth}")
    check(store.device.type == "cpu" and tuple(store.shape) == (
        cfg.num_tables, cfg.rows_per_table, cfg.embed_dim),
          "the tables are not one store in host memory")
    check(torch.cuda.memory_allocated() < budget + 2 * GB,
          "the device holds more than the budget + 2 GB")
    # note evictions, and chunks faulted in again after theirs
    evicted = np.zeros(ex.mgr.n_chunks, bool)
    refaulted = [0]
    evict, load = ex.mgr._evict, ex.mgr._load

    def note_evict(slots, st):
        evicted[ex.mgr._slot_chunk[slots]] = True
        return evict(slots, st)

    def note_load(chunks, slots):
        refaulted[0] += int(evicted[chunks].sum())
        return load(chunks, slots)

    ex.mgr._evict, ex.mgr._load = note_evict, note_load
    ops.reset_launch_counts()
    served = serve_host_queries(sess, range(16), "depth 1")
    sess4 = ServeSession(cfg, device=dev, exchange=ex, pipeline_depth=4,
                         max_batch_queries=1, params=sess.params,
                         alpha=TIERED_ALPHA)
    check(sess4.depth_for_samples(cfg.batch_size) == 4, "depth 4 not pinned")
    served4 = serve_host_queries(
        sess4, range(16, 16 + HOST_MAX_QUERIES), "depth 4 (150 samples a "
        "micro-batch)", stop=lambda: refaulted[0] > 0)
    del ex.mgr._evict, ex.mgr._load          # the manager's own again
    launches = dict(ops.launch_counts)
    st = ex.mgr.stats
    print(f"[host] paired serving: {st.ensures} ensures, "
          f"{st.faulted_chunks} faults, {st.evicted_chunks} evictions, "
          f"{refaulted[0]} chunks faulted again after their eviction, "
          f"{st.writebacks} writebacks, {st.bytes_in / GB:.2f} GB in, "
          f"transfers {st.copy_s:.2f} s ({st.bytes_in / st.copy_s / GB:.2f}"
          f" GB/s); chunk hit ratio {st.chunk_hit_ratio:.4f}; kernel "
          f"launches {sum(launches.values())} ({card})")
    check(st.evicted_chunks > 0 and refaulted[0] > 0,
          "the chunk cache did not evict and fault again")
    check(not any(launches.values()), f"paired serving launched {launches}")
    last = max(served4)
    checked = {4: served[4], 15: served[15], last: served4[last]}
    per_table_reference(ex.mgr, sess.params, checked, dev)
    return (sess, sess4), checked


def host_serve_cached_bag(sessions, checked, calib, errs, dev):
    """Phase 10b: 10a's sessions and exchange switched to the cached-bag
    pool mode, the link the measured one: the checked queries' probs
    against the paired mode's and row 6's launches against the resolved
    depths; then row 6 at this shape on the flat chunk cache (its hot
    slab and its cache read past 2**31 elements) held against its plain
    version, with edge cases, and timed, and the pooling step's device
    time and transient memory. Prints the device peaks of 10a and of 10b's
    serving."""
    import types

    from repro_torch.core import perf_model
    from repro_torch.kernels import embedding_bags, ops, ref

    ex = sessions[0].exchange
    ex.pool_mode = "cached_bag"
    ex.link = perf_model.host_link(calibration=calib)
    torch.cuda.synchronize()
    peaks = {"10a paired serving": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    first, *rest, last = sorted(checked)
    depths = []
    for sess, steps in zip(sessions, ((first, *rest), (last,))):
        for s in steps:
            q, want, _ = checked[s]
            probs, service, stall = sess._execute([q])
            depths.append(sess.depth_for_samples(q["indices"].shape[0]))
            err = float(np.abs(probs - want).max())
            ok = np.allclose(probs, want, rtol=RTOL, atol=ATOL)
            print(f"[host] cached_bag step {s} (depth {depths[-1]}): probs "
                  f"vs paired max_abs_err={err:.3e} "
                  f"{'ok' if ok else 'FAIL'}; service {service * 1e3:.3f} "
                  f"ms; modeled stall {stall * 1e3:.3f} ms on the measured "
                  f"link ({ex._last_plan.faulted_chunks} faults)")
            check(ok, f"cached_bag probs of step {s} differ from paired")
    launches = ops.launch_counts["cached_embedding_bag"]
    torch.cuda.synchronize()
    peaks["10b cached-bag serving"] = torch.cuda.max_memory_allocated()
    print(f"[host] cached_bag: {launches} cached_embedding_bag launches "
          f"over flushes at depths {depths} (sum {sum(depths)}); "
          f"{ex.summary()}")
    check(launches == sum(depths),
          "cached-bag launches differ from the sum of resolved depths")
    # row 6 at this shape, reading the flat chunk cache in place
    params = sessions[0].params
    idx = checked[first][0]["indices"]
    ex.begin_batch(params, idx, 1)
    _, (fast_idx, pos) = ex.forward(params, idx)
    fast, cache = params["hs_hot"], params["hs_cache"]
    B, T, L = fast_idx.shape
    d = fast.shape[2]
    hit = fast_idx < fast.shape[1] - 1
    t_of = torch.arange(T, device=dev)[None, :, None].expand(B, T, L)
    far = int(((t_of[hit] * fast.shape[1] + fast_idx[hit].long()) * d).max())
    check(far >= 2**31, f"the query's hot rows stop at element {far}, "
                        f"short of 2**31")
    # 10a filled the cache from its first slots, so the query's cold rows
    # lie low in it; the same lookups moved to the cache's top rows read
    # it past element 2**31 too
    pad = cache.shape[0] - 1
    high = torch.where(hit, pos, pad - 1 - pos).int()
    every = cache[None].expand(T, -1, -1)
    for cold, tag in ((pos, "the query's cache positions"),
                      (high, "its cold lookups moved to the cache's top "
                             "rows")):
        reach = int(cold[~hit].max()) * d
        check(cold is pos or reach >= 2**31,
              f"the moved cache rows stop at element {reach}")
        close("cached_embedding_bag",
              f"host tier B={B} T={T} L={L} d={d}, hot slab S+1="
              f"{fast.shape[1]} ({fast.numel():.3e} elements, rows read to "
              f"element {far:.3e}), the flat cache of {cache.shape[0]} rows "
              f"shared by every table, {tag} (rows read to element "
              f"{reach:.3e}), {int(hit.sum())} of {hit.numel()} lookups hot",
              embedding_bags.cached_embedding_bag(fast, cache, fast_idx,
                                                  cold),
              ref.cached_embedding_bag_ref(fast, every, fast_idx, cold), errs)
    gen = torch.Generator(device=dev).manual_seed(68)
    cached_bag_cases(f"host tier B={B} d={d}, cold rows at the cache's top",
                     fast, cache, fast_idx, high, gen, errs)
    bag_edge_cases("cached_embedding_bag shared", gen, dev, errs)
    row6 = time_b6(types.SimpleNamespace(fast=fast, bulk=cache),
                   [(fast_idx, pos)])

    # the pooling step of one query (B = 600): the kernel on the flat cache
    def step(_):
        return ex._cached_bag_pool(fast, cache, fast_idx, pos)

    step_ms = kernel_ms(step, 1, iters=20)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(0)
    torch.cuda.synchronize()
    step_gb = (torch.cuda.max_memory_allocated() - base) / GB
    print(f"[host] cached-bag pooling step, one query (B={B}): "
          f"{step_ms[0]:.4f} ms (device {step_ms[1]} ms), transient device "
          f"memory {step_gb:.3f} GB")
    ex.pool_mode = "paired"
    return {"launches": launches, "time": row6, "peaks": peaks,
            "pooling_step": {"ms": step_ms[0], "device_ms": step_ms[1],
                             "transient_gb": step_gb}}


def host_write_through(sessions, checked, errs, dev, card):
    """Phase 10 (after 10b): one online batch written through the host
    tier at full width with ``write_through_host``: cold rows (not in the
    hot slab) of the last checked query that are resident in the chunk
    cache, and cold rows that are not, put into the query; then the query
    pooled in the cached-bag mode, row 6 reading the flat cache the
    session's params hold, held against ``embedding_bag_ref`` on the
    updated host rows. Returns row 6's launches."""
    from repro_torch.kernels import ops, ref
    from repro_torch.online import DeltaBatch, RowDelta, write_through_host
    sess = sessions[0]
    ex, params = sess.exchange, sess.params
    mgr = ex.mgr
    q = checked[max(checked)][0]
    idx = q["indices"].clone()
    B, T, L = idx.shape
    ids = idx.cpu().numpy()
    t_of = np.broadcast_to(np.arange(T)[None, :, None], ids.shape)
    cold = ex._hot_map_np[t_of, ids] < 0
    resident = cold & (mgr.host_pos[t_of, ids] < mgr.pad_pos)
    rng = np.random.default_rng(17)
    deltas, n_res, n_out = [], 0, 0
    for t in range(0, T, 5):
        res_rows = np.unique(ids[2:, t][resident[2:, t]])[:32]
        cand = rng.integers(0, mgr.R, 4096)
        out = np.unique(cand[(ex._hot_map_np[t, cand] < 0)
                             & (mgr.host_pos[t, cand] == mgr.pad_pos)])
        out = out[:min(16, L)]
        idx[1, t, :out.size] = torch.from_numpy(out).to(idx)
        rows = np.union1d(res_rows, out)
        deltas.append(RowDelta(t, rows, rng.standard_normal(
            (rows.size, mgr.d)).astype(np.float32)))
        n_res += res_rows.size
        n_out += out.size
    batch = DeltaBatch(version=1, t_emit_s=0.0, step=1, deltas=tuple(deltas))
    check(n_res > 0 and n_out > 0,
          f"write-through: {n_res} resident and {n_out} other cold rows")
    cache = params["hs_cache"]
    t0 = time.perf_counter()
    refreshed = write_through_host(mgr, batch)
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    check(refreshed == n_res and params["hs_cache"] is cache
          and mgr.device_cache is cache,
          f"write-through refreshed {refreshed} resident rows of {n_res}, "
          f"or the cache tensor changed")
    for d in batch.deltas:
        check(torch.equal(mgr.host[d.table, torch.from_numpy(d.rows)],
                          torch.from_numpy(d.values)),
              f"write-through: host table {d.table}")
    ex.pool_mode = "cached_bag"
    ops.reset_launch_counts()
    idx = idx.to(dev)
    ex.begin_batch(params, idx, 1)
    got, _ = ex.forward(params, idx)
    torch.cuda.synchronize()
    launches = ops.launch_counts["cached_embedding_bag"]
    ex.pool_mode = "paired"
    check(launches == 1, f"write-through pool launched row 6 {launches} "
                         f"times")
    host_ids = idx.long().cpu()
    rows = mgr.host[torch.arange(T)[None, :, None], host_ids]
    slab = rows.permute(1, 0, 2, 3).reshape(T, B * L, -1).to(dev)
    fake = (torch.arange(B, device=dev)[:, None, None] * L
            + torch.arange(L, device=dev)[None, None, :]).expand(B, T, L)
    close("cached_embedding_bag",
          f"host tier after write_through_host: B={B} T={T} L={L} "
          f"d={mgr.d}, {n_res} updated rows resident in the chunk cache and "
          f"{n_out} faulted in after the write, vs embedding_bag_ref on the "
          f"updated host rows",
          got, ref.embedding_bag_ref(slab, fake.int()), errs)
    print(f"[host] write_through_host: {batch.n_rows} rows of {len(deltas)} "
          f"tables into the host store and {refreshed} resident cache rows "
          f"in place in {apply_ms:.3f} ms; row 6 launches {launches} "
          f"({card})")
    return launches


def host_train(cfg, ex, dev, card):
    """Phase 10c: SGD at depth 1 on the same exchange, its cache full of
    10a's chunks, over another seed's stream: the first step held
    against a compact model of its touched rows, then more steps."""
    from repro_torch.engine import TrainSession
    from repro_torch.kernels import ops

    sess = TrainSession(cfg, device=dev, exchange=ex, lr=HOST_TRAIN_LR,
                        alpha=TIERED_ALPHA, seed=HOST_TRAIN_SEED)
    st = ex.mgr.stats
    before = (st.faulted_chunks, st.evicted_chunks, st.writebacks)
    ops.reset_launch_counts()
    loss0, _ = check_one_step(sess, "sgd", HOST_TRAIN_LR, HOST_TRAIN_SEED,
                              TIERED_ALPHA, dev)
    check(st.faulted_chunks > before[0] and st.evicted_chunks > before[1],
          "the checked step did not fault and evict")
    rep = sess.run(HOST_TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    losses = [loss0] + [h["loss"] for h in rep.history]
    dts = np.array([h["dt"] for h in rep.history]) * 1e3
    check(all(math.isfinite(x) for x in losses),
          f"a host-tier training loss is not finite: {losses}")
    check(not any(launches.values()),
          f"host-tier training launched {launches}")
    print(f"[host] training, SGD at depth 1, lr {HOST_TRAIN_LR}, seed "
          f"{HOST_TRAIN_SEED}: step 0 checked, then {len(dts)} steps p50 "
          f"{np.percentile(dts, 50):.3f} ms p99 {np.percentile(dts, 99):.3f} "
          f"ms; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{st.faulted_chunks - before[0]} faults, "
          f"{st.evicted_chunks - before[1]} evictions, "
          f"{st.writebacks - before[2]} writebacks, "
          f"{len(ex.mgr.dirty_chunks)} dirty chunks; kernel launches "
          f"{sum(launches.values())} ({card})")


def phase_host_tier(dev, card):
    """Phase 10: the host chunk tier at full width on RM2-large (see the
    module doc) on one exchange and its one store in host memory: 10a
    paired serving, 10b the cached-bag pool mode, 10c SGD training; then
    the reduced config's bitwise contracts. Returns row 6's host-tier
    launches and time, and its errors."""
    import gc

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = host_tier_config()
    rss0, _ = rss_bytes()
    print(rss_line("phase 10 begins"))
    errs = {}
    sessions, checked = host_serve_paired(cfg, dev, card)
    calib = measure_host_link(dev)
    row6 = host_serve_cached_bag(sessions, checked, calib, errs, dev)
    row6["write_through_launches"] = host_write_through(sessions, checked,
                                                        errs, dev, card)
    ex = sessions[0].exchange
    del sessions, checked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host_train(cfg, ex, dev, card)
    torch.cuda.synchronize()
    peaks = row6.pop("peaks")
    peaks["10c training"] = torch.cuda.max_memory_allocated()
    for label, peak in peaks.items():
        print(f"[memory] phase {label}: peak allocated {peak / GB:.2f} GB")
    print(f"[memory] phase 10, served and trained paths (10a, 10b's "
          f"serving, 10c): peak allocated {max(peaks.values()) / GB:.2f} GB "
          f"({card})")
    row6["peak_gb"] = {k: v / GB for k, v in peaks.items()}
    tables = ex.mgr.host.numel() * ex.mgr.host.element_size()
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    _, peak = rss_bytes()
    print(rss_line("after the host tier at full width"))
    print(f"[host] peak RSS {peak / GB:.2f} GB: {rss0 / GB:.2f} GB held "
          f"before the phase, {tables / GB:.2f} GB of tables and "
          f"{(peak - rss0 - tables) / GB:.2f} GB more (HOST_SPARE_BYTES "
          f"{HOST_SPARE_BYTES / GB:.0f} GB)")
    check(peak - rss0 - tables <= HOST_SPARE_BYTES,
          "phase 10 grew past the tables + HOST_SPARE_BYTES that "
          "host_tier_config allows for")
    check(torch.cuda.memory_allocated() < 1 * GB,
          f"{torch.cuda.memory_allocated() / GB:.2f} GB still allocated on "
          f"the card after the host tier")
    host_bitwise(dev, calib)
    print(f"[host] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    peak_line("phase 10 (host chunk tier)")
    return row6, {k: max(v) for k, v in errs.items()}


# -------------------------------------------------------------- phase 9e
@contextlib.contextmanager
def plain_attention():
    """Rows 8 and 9's plain versions in place of the kernels, on the same
    CUDA tensors: the model code calls ``ops.flash_attention`` and
    ``ops.flash_decode`` through the module, and the plain versions count
    no launch."""
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention, ops.flash_decode
    ops.flash_attention = ref.flash_attention_ref
    ops.flash_decode = ref.flash_decode_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode = saved


def lm_config(name, n_layers=None):
    """An architecture's full config (depth cut to ``n_layers`` if given)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def lm_close(label, got, want):
    """bf16 logits against their plain path: within LM_ULPS bf16 ulps of
    the reference's scale elementwise and LM_REL of its norm."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: not finite")
    err = (g - w).abs().max().item()
    tol = LM_ULPS * 2.0 ** -8 * w.abs().max().item()
    rel = ((g - w).norm() / w.norm()).item()
    print(f"[lm] {label}: max_abs_err={err:.4e} (tol {tol:.4e}), "
          f"err/norm {rel:.3e} (limit {LM_REL}) "
          f"{'ok' if err <= tol and rel <= LM_REL else 'OVER TOLERANCE'}")
    check(err <= tol and rel <= LM_REL, f"{label}: disagrees with the "
                                        f"plain path")
    return tol


def lm_greedy(label, tokens, ref_logits, vocab, tol):
    """Greedy tokens equal the reference's argmax wherever its top-2
    margin over the real vocab exceeds ``tol``."""
    lg = ref_logits[..., :vocab].float()
    top2 = lg.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol
    same = (tokens == lg.argmax(-1))
    print(f"[lm] {label}: greedy tokens equal at {int(same.sum())} of "
          f"{same.numel()}, {int(sure.sum())} with a clear margin")
    check(bool(same[sure].all()), f"{label}: a greedy token differs where "
                                  f"the margin is clear")


def lm_run(params, cfg, prompt, max_len, n_new, feed=None,
           encoder_embeds=None):
    """Prefill ``prompt`` and decode ``n_new`` tokens (greedy, or ``feed``'s
    tokens) through the port's model functions: (logits (B, 1 + n_new, V)
    fp32 of the last prompt position and each decoded one, the tokens
    fed (B, n_new), the prefill's ms (the encoder and its memory
    included), the decode's ms a token), on the host clock, synchronised
    at both ends."""
    from repro_torch.models import transformer as T
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        hidden, extras = T.forward(params, cfg, prompt, collect=True,
                                   encoder_embeds=encoder_embeds)
        caches = T.caches_from_prefill(cfg, extras, hidden.shape[1], max_len)
        del extras
        memory = None
        if cfg.is_encoder_decoder:
            memory = T._project_kv_memory(
                cfg, params["cross_attn"],
                T.encode(params, cfg, encoder_embeds))
        logits = [T.logits_from_hidden(params, cfg,
                                       hidden[:, -1:])[:, 0].float()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fed = []
        for i in range(n_new):
            tok = (feed[:, i] if feed is not None
                   else logits[-1][:, :cfg.vocab_size].argmax(-1))
            fed.append(tok)
            hid, caches = T.forward_with_state(
                params, cfg, tok[:, None], caches, hidden.shape[1] + i,
                memory_kv=memory)
            logits.append(T.logits_from_hidden(params, cfg, hid)[:, 0]
                          .float())
        torch.cuda.synchronize()
    del caches
    t2 = time.perf_counter()
    return (torch.stack(logits, 1), torch.stack(fed, 1) if fed else None,
            (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(1, n_new))


def lm_against_plain(label, params, cfg, prompt, max_len, n_new, card,
                     encoder_embeds=None):
    """Prefill + ``n_new`` greedy steps through the kernels (their times
    printed), then the same prompt and tokens through the plain versions:
    logits and greedy tokens held. Returns the kernel path's (logits,
    tokens)."""
    got, toks, prefill_ms, decode_ms = lm_run(
        params, cfg, prompt, max_len, n_new, encoder_embeds=encoder_embeds)
    print(f"[lm] {label}: prefill {prefill_ms:.2f} ms, decode "
          f"{decode_ms:.3f} ms a token (first calls at these shapes) "
          f"({card})")
    with plain_attention():
        want, *_ = lm_run(params, cfg, prompt, max_len, n_new, feed=toks,
                          encoder_embeds=encoder_embeds)
    tol = lm_close(f"{label} logits (prefill + {n_new} decode steps)", got,
                   want)
    lm_greedy(f"{label} greedy", toks, want[:, :n_new], cfg.vocab_size, tol)
    del want
    return got, toks


def lm_profile(label, run, n, card, top=10, cpu=True):
    """``whole_profile`` over ``run(n)``: per call, wall and device busy ms
    and the ``top`` device events by time; None if no trace was whole."""
    got = whole_profile(run, n, cpu=cpu)
    if got is None:
        print(f"[profile] {label}: not measured (no whole trace)")
        return None
    _, wall, busy, _, device = got
    print(f"[profile] {label}: wall {wall / n:.3f} ms, device busy "
          f"{busy / n:.3f} ms ({busy / wall:.1%}) a call ({card})")
    for e in device[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / n:9.3f} ms "
              f"{e.count // n:5d}x {e.key[:90]}")
    return dict(wall_ms=wall / n, busy_ms=busy / n,
                top=[(e.key[:90], e.self_device_time_total / 1e3 / n)
                     for e in device[:top]])


def lm_train(dev, card):
    """(a)1-3: internlm2-1.8b at full width and depth, 30 AdamW steps
    through the Engine; the first step's loss and grad norm held against
    the same step with plain attention; the windowed decrease at
    ``reduced()``. Returns the session's params (its optimizer state
    freed), the loss curve and the train row-8 launches expected."""
    from repro_torch.data.lm import make_lm_batch
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.models import lm as LM
    cfg = lm_config(LM_ARCH)
    B, S, steps = LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS
    sess = Engine(cfg, lr=LM_TRAIN_LR, device=dev).train_session(
        batch=B, seq=S, schedule_steps=steps)
    n_params = sum(x.numel() for _, x in leaves(sess.params))
    print(f"[lm] {cfg.name}: {n_params / 1e9:.3f} B params "
          f"({n_params * 4 / GB:.2f} GB fp32), {cfg.n_layers} layers, "
          f"d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.resolved_head_dim}, ff {cfg.d_ff}, padded vocab "
          f"{cfg.padded_vocab}")
    batch0 = make_lm_batch(cfg, 0, 0, B, S, device=dev)
    with plain_attention():
        loss0, grads = LM.value_and_grad(LM.make_loss_fn(cfg), sess.params,
                                         batch0)
        gnorm0 = float(LM.global_norm(grads))
    del grads, batch0
    loss0 = float(loss0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = sess.run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    losses = [h["loss"] for h in rep.history]
    first = rep.history[0]
    print(f"[lm] train loss curve {[round(x, 4) for x in losses]}")
    print(f"[lm] first step: loss {first['loss']:.5f} vs plain attention "
          f"{loss0:.5f}; grad norm {first['grad_norm']:.5f} vs "
          f"{gnorm0:.5f}")
    check(all(math.isfinite(x) for x in losses), "an LM loss is not finite")
    check(abs(first["loss"] - loss0) <= LM_LOSS_TOL,
          "the first step's loss disagrees with the plain attention's")
    check(abs(first["grad_norm"] - gnorm0) <= LM_REL * gnorm0,
          "the first step's grad norm disagrees with the plain attention's")
    want = {"flash_attention": cfg.n_layers * steps, "flash_decode": 0}
    check({k: counts[k] for k in want} == want,
          f"train launches {counts}, want {want}")
    dts = sorted(h["dt"] for h in rep.history)
    p50 = dts[len(dts) // 2]
    tokens = B * (S - 1)
    print(f"[lm] train {cfg.name} B={B} seq={S}: {steps} steps in "
          f"{wall:.2f} s, step p50 {p50 * 1e3:.2f} ms, "
          f"{tokens / p50:.0f} tokens/s, peak "
          f"{torch.cuda.max_memory_allocated() / GB:.2f} GB ({card})")
    ops.reset_launch_counts()
    prof = lm_profile(f"train step {cfg.name} B={B} seq={S}", sess.run,
                      PROFILE_STEPS, card)
    extra = ops.launch_counts["flash_attention"]
    params = sess.params
    del sess, rep
    torch.cuda.empty_cache()

    small = lm_config(LM_ARCH).reduced()
    ops.reset_launch_counts()
    rep = Engine(small, lr=LM_SMALL_LR, device=dev).train_session(
        batch=4, seq=33, schedule_steps=LM_TRAIN_STEPS).run(LM_TRAIN_STEPS)
    small_losses = [h["loss"] for h in rep.history]
    head, tail = np.mean(small_losses[:5]), np.mean(small_losses[-5:])
    print(f"[lm] {small.name} on the card: loss curve "
          f"{[round(x, 4) for x in small_losses]}; mean of the first 5 "
          f"{head:.4f}, of the last 5 {tail:.4f}")
    check(all(math.isfinite(x) for x in small_losses) and tail < head,
          "the reduced LM's windowed loss did not decrease")
    check(ops.launch_counts["flash_attention"]
          == small.n_layers * LM_TRAIN_STEPS, "reduced train launches")
    # the profiled steps launch row 8 too (their count depends on the
    # profiler's tries)
    launches = (cfg.n_layers * steps + small.n_layers * LM_TRAIN_STEPS
                + extra)
    return params, dict(losses=losses, p50_ms=p50 * 1e3,
                        tokens_per_s=tokens / p50, wall_s=wall,
                        profile=prof, launches=launches,
                        first_loss=(first["loss"], loss0),
                        first_grad_norm=(first["grad_norm"], gnorm0))


def lm_serve_internlm(params, dev, card):
    """(a)4-7 on the trained params: prefill 2 x 32,768 and decode 32
    tokens through the entry points (rows 8 and 9), timed; then a 2 x 2,048
    prompt against the plain path, and decode-after-prefill of T - k
    against the prefill of T."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm as LM
    cfg = lm_config(LM_ARCH)
    L_ = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(24)
    B, Tn = LM_PREFILL
    max_len = Tn + LM_DECODE_STEPS
    prompt = torch.randint(0, cfg.vocab_size, (B, Tn), generator=gen,
                           device=dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches, tok = LM.make_prefill_step(cfg, max_len)(params,
                                                     {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    kv_gb = sum(c[n].numel() * c[n].element_size() for c in caches
                for n in ("k", "v")) / GB
    decode = LM.make_decode_step(cfg)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(LM_DECODE_STEPS):
        caches, tok = decode(params, caches, tok, Tn + i)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / LM_DECODE_STEPS
    counts = dict(ops.launch_counts)
    want = {"flash_attention": L_, "flash_decode": L_ * LM_DECODE_STEPS}
    check({k: counts[k] for k in want} == want,
          f"prefill/decode launches {counts}, want {want}")
    toks = torch.stack(out, 1)
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a decoded token is outside the vocab")
    check(int((caches[0]["pos"] >= 0).sum(-1).min()) == max_len,
          "the decode cache is not full after prefill + decode")
    peak = torch.cuda.max_memory_allocated() / GB
    # decode steps at the last position again, over the full cache
    ops.reset_launch_counts()
    prof = lm_profile(
        f"decode step {cfg.name} B={B} S={max_len}",
        lambda n: [decode(params, caches, tok, max_len - 1)
                   for _ in range(n)], 4, card)
    extra = ops.launch_counts["flash_decode"]
    print(f"[lm] prefill {cfg.name} B={B} T={Tn} (prefill_32k, batch cut "
          f"from 32): {prefill_s * 1e3:.1f} ms, {B * Tn / prefill_s:.0f} "
          f"tokens/s; KV cache {kv_gb:.2f} GB; decode {LM_DECODE_STEPS} "
          f"tokens over S={max_len} (decode_32k, batch cut from 128): "
          f"{decode_s * 1e3:.2f} ms a token, {B / decode_s:.1f} tokens/s; "
          f"peak {peak:.2f} GB ({card})")
    del caches
    torch.cuda.empty_cache()

    # (a)6: a shorter prompt against the plain path, (a)7: decode the
    # last k tokens after a prefill of T - k
    B, Tn = LM_CHECK
    k = LM_SPLIT_K
    prompt = torch.randint(0, cfg.vocab_size, (B, Tn), generator=gen,
                           device=dev)
    ops.reset_launch_counts()
    full, _ = lm_against_plain(f"{cfg.name} B={B} T={Tn}", params, cfg,
                               prompt, Tn + LM_CHECK_TOKENS,
                               LM_CHECK_TOKENS, card)
    split, *_ = lm_run(params, cfg, prompt[:, :Tn - k], Tn, k,
                       feed=prompt[:, Tn - k:])
    tol = lm_close(f"{cfg.name} decode of the last {k} after a prefill of "
                   f"{Tn - k} vs the prefill of {Tn}", split[:, -1],
                   full[:, 0])
    lm_greedy("decode-after-prefill greedy", split[:, -1, :cfg.vocab_size]
              .argmax(-1), full[:, 0], cfg.vocab_size, tol)
    counts = dict(ops.launch_counts)
    want = {"flash_attention": 2 * L_,
            "flash_decode": L_ * (LM_CHECK_TOKENS + k)}
    check({n: counts[n] for n in want} == want,
          f"check launches {counts}, want {want}")
    return dict(prefill_ms=prefill_s * 1e3, decode_ms=decode_s * 1e3,
                kv_gb=kv_gb, peak_gb=peak, profile=prof,
                launches={"flash_attention": 3 * L_, "flash_decode":
                          L_ * (LM_DECODE_STEPS + LM_CHECK_TOKENS + k)
                          + extra})


def lm_mixtral(dev, card):
    """(b) mixtral-8x7b at full width, depth cut to 2: prefill 1 x 8,192
    (past the 4,096 window) and 16 decode steps on the wrapped ring,
    against the plain path; the MoE at capacity 2,560."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = lm_config("mixtral-8x7b", MIXTRAL_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(8)
    params = T.init_model(cfg, gen)
    n = sum(x.numel() for _, x in leaves(params))
    B, Tn = MIXTRAL_PREFILL
    C = L.moe_capacity(cfg, B * Tn)
    print(f"[lm] {cfg.name} depth {cfg.n_layers} (cut from 32): "
          f"{n / 1e9:.3f} B params ({n * 4 / GB:.2f} GB fp32); prefill "
          f"B={B} T={Tn}, window {cfg.sliding_window}, MoE capacity {C}")
    prompt = torch.randint(0, cfg.vocab_size, (B, Tn), generator=gen,
                           device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lm_against_plain(f"{cfg.name} depth {cfg.n_layers} B={B} T={Tn}",
                     params, cfg, prompt, Tn + MIXTRAL_DECODE,
                     MIXTRAL_DECODE, card)
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    L_ = cfg.n_layers
    want = {"flash_attention": L_, "flash_decode": L_ * MIXTRAL_DECODE}
    check({k: counts[k] for k in want} == want,
          f"mixtral launches {counts}, want {want}")
    print(f"[lm] {cfg.name}: kernel and plain paths in {wall:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / GB:.2f} GB ({card})")
    del params
    torch.cuda.empty_cache()
    return want, C


def lm_whisper(dev, card):
    """(c) whisper-base at full width and depth: the encoder over 1,500
    frames (row 8, non-causal), cross-attention T != S (row 8), decode with
    the projected memory (rows 9 and 8), against the plain path."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = lm_config("whisper-base")
    gen = torch.Generator(device=dev).manual_seed(9)
    params = T.init_model(cfg, gen)
    B, Tn = WHISPER_PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (B, Tn), generator=gen,
                           device=dev)
    frames = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen, device=dev) * 0.02
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lm_against_plain(f"{cfg.name} B={B} T={Tn} over "
                     f"{cfg.encoder_seq_len} frames", params, cfg, prompt,
                     Tn + WHISPER_DECODE, WHISPER_DECODE, card,
                     encoder_embeds=frames)
    print(f"[lm] {cfg.name}: kernel and plain paths in "
          f"{time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / GB:.2f} GB ({card})")
    counts = dict(ops.launch_counts)
    L_, E_ = cfg.n_layers, cfg.n_encoder_layers
    # the prefill's forward (encoder, self- and cross-attention), the
    # encoder again for the decode memory, then a step's cross-attention
    want = {"flash_attention": 2 * E_ + 2 * L_ + L_ * WHISPER_DECODE,
            "flash_decode": L_ * WHISPER_DECODE}
    check({k: counts[k] for k in want} == want,
          f"whisper launches {counts}, want {want}")
    del params
    torch.cuda.empty_cache()
    return want


def phase_lm(dev, card):
    """Phase 9e: the LM substrate at full width (see the module doc)."""
    t_phase = time.perf_counter()
    peaks = []

    def peak():
        peaks.append(torch.cuda.max_memory_allocated() / GB)
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    params, train = lm_train(dev, card)
    serve = lm_serve_internlm(params, dev, card)
    del params
    torch.cuda.empty_cache()
    peak()
    mixtral, C = lm_mixtral(dev, card)
    peak()
    whisper = lm_whisper(dev, card)
    peak()
    launches = {
        "flash_attention": train["launches"]
        + serve["launches"]["flash_attention"] + mixtral["flash_attention"]
        + whisper["flash_attention"],
        "flash_decode": serve["launches"]["flash_decode"]
        + mixtral["flash_decode"] + whisper["flash_decode"]}
    wall = time.perf_counter() - t_phase
    check(torch.cuda.memory_allocated() < 1 * GB,
          f"{torch.cuda.memory_allocated() / GB:.2f} GB still allocated "
          f"after phase 9e")
    print(f"[lm] phase 9e: {wall:.1f} s, peak {max(peaks):.2f} GB "
          f"(internlm2 {peaks[0]:.2f}, mixtral {peaks[1]:.2f}, whisper "
          f"{peaks[2]:.2f}); launches on the LM path {launches} ({card})")
    torch.cuda.reset_peak_memory_stats()
    check(wall < LM_PHASE_S, f"phase 9e took {wall:.1f} s, over "
                             f"{LM_PHASE_S} s")
    return dict(train=train, serve=serve, launches=launches, wall_s=wall,
                moe_capacity=C, peak_gb=max(peaks))


# -------------------------------------------------------------- phase 9f
def rel_err(got, want):
    """||got - want|| / ||want||, in fp32."""
    g, w = got.float(), want.float()
    return ((g - w).norm() / w.norm()).item()


def ssm_mixer_chunks(params, cfg, batch, dev, card):
    """(a)1: layer 0's RWKV6 mixer on the first batch's normed embeddings,
    its 64-step chunks rematerialized against no chunking: the loss (a
    drawn cotangent's inner product with the output) and its grads w.r.t.
    the mixer's params and input. Returns the autograd peaks (GB)."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models.common import COMPUTE_DTYPE
    with torch.no_grad():
        emb = torch.nn.functional.embedding(
            batch["tokens"], params["embed"].to(COMPUTE_DTYPE))
        h = L.rms_norm(emb, params["units"][0]["norm1"][0], cfg.norm_eps)
    del emb
    p0 = {k: v[0].detach() for k, v in params["units"][0]["rwkv"].items()}
    gen = torch.Generator(device=dev).manual_seed(25)
    cot = torch.randn(h.shape, generator=gen, device=dev)
    runs = {}
    for chunk in (S.SSM_CHUNK, 0):
        live = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        hl = h.clone().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.enable_grad():
            y, _ = S.rwkv6_scan(live, hl, cfg, chunk=chunk)
            loss = (y.float() * cot).sum()
            del y
            grads = torch.autograd.grad(loss, [hl, *live.values()])
        torch.cuda.synchronize()
        runs[chunk] = (loss.item(), grads, time.perf_counter() - t0,
                       (torch.cuda.max_memory_allocated() - base) / GB)
        del live, hl, loss
    (l64, g64, s64, m64), (l0, g0, s0, m0) = runs[S.SSM_CHUNK], runs[0]
    loss_rel = abs(l64 - l0) / abs(l0)
    grad_rel = max(rel_err(a, b) for a, b in zip(g64, g0))
    print(f"[ssm] {cfg.name} layer 0's mixer, B={h.shape[0]} T={h.shape[1]}:"
          f" chunk {S.SSM_CHUNK} loss {l64:.6f} vs no chunking {l0:.6f} "
          f"(rel {loss_rel:.2e}, limit {SSM_LOSS_REL}); grads at most "
          f"{grad_rel:.2e} of their norm off (limit {SSM_GRAD_REL}); "
          f"forward + backward {s64 * 1e3:.1f} / {s0 * 1e3:.1f} ms, "
          f"autograd peak {m64:.3f} / {m0:.3f} GB ({card})")
    check(loss_rel <= SSM_LOSS_REL, "the chunked mixer's loss disagrees")
    check(grad_rel <= SSM_GRAD_REL, "the chunked mixer's grads disagree")
    return m64, m0


def ssm_train(dev, card):
    """(a)1-2: rwkv6-3b at full width (depth ``SSM_LAYERS``): the chunk
    check, then ``SSM_TRAIN_STEPS`` AdamW steps through the Engine, the
    last profiled. Returns the params (the optimizer state freed) and the
    numbers."""
    from repro_torch.data.lm import make_lm_batch
    from repro_torch.engine import Engine
    from repro_torch.models import ssm as S
    cfg = lm_config(SSM_ARCH, SSM_LAYERS)
    B, S_, steps = SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS
    sess = Engine(cfg, lr=LM_TRAIN_LR, device=dev).train_session(
        batch=B, seq=S_, schedule_steps=LM_TRAIN_STEPS)
    n_params = sum(x.numel() for _, x in leaves(sess.params))
    print(f"[ssm] {cfg.name}: {n_params / 1e9:.3f} B params "
          f"({n_params * 4 / GB:.2f} GB fp32), {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.d_model // cfg.ssm.head_dim} heads of "
          f"{cfg.ssm.head_dim}, ff {cfg.d_ff}, padded vocab "
          f"{cfg.padded_vocab}")
    batch0 = make_lm_batch(cfg, 0, 0, B, S_, device=dev)
    T_ = batch0["tokens"].shape[1]
    check(T_ > S.SSM_CHUNK and T_ % S.SSM_CHUNK == 0,
          f"T = {T_} does not chunk")
    chunk_peaks = ssm_mixer_chunks(sess.params, cfg, batch0, dev, card)
    del batch0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the last 2 of the steps are the profile's (its warm-up and the
    # counted step; more if a trace comes back partial): the step p50 is
    # the others'
    t0 = time.perf_counter()
    rep = sess.run(steps - 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    history = list(rep.history)
    dts = sorted(h["dt"] for h in history)
    p50 = dts[len(dts) // 2]

    def profiled(n):
        got = sess.run(n)
        history.extend(got.history)
        return got
    prof = lm_profile(f"train step {cfg.name} B={B} T={T_}", profiled, 1,
                      card, cpu=False)
    peak = torch.cuda.max_memory_allocated() / GB
    losses = [h["loss"] for h in history]
    tokens = B * T_
    print(f"[ssm] train loss curve {[round(x, 4) for x in losses]}, grad "
          f"norms {[round(h['grad_norm'], 2) for h in history]}; mean "
          f"of the last 3 {np.mean(losses[-3:]):.4f} against the first "
          f"{losses[0]:.4f}")
    print(f"[ssm] train {cfg.name} B={B} T={T_}: {len(losses)} steps, the "
          f"first {steps - 2} in {wall:.2f} s, step p50 {p50 * 1e3:.1f} ms, "
          f"{tokens / p50:.0f} tokens/s, peak {peak:.2f} GB (limit "
          f"{SSM_PEAK_LIMIT_GB}) ({card})")
    check(len(losses) >= steps, f"{len(losses)} rwkv6 steps")
    check(all(math.isfinite(x) for x in losses),
          "an rwkv6 loss is not finite")
    check(peak < SSM_PEAK_LIMIT_GB, f"rwkv6 training peaked at {peak:.2f} "
                                    f"GB")
    params = sess.params
    del sess, rep
    torch.cuda.empty_cache()

    # the decrease, where the schedule lets the loss move in a few steps:
    # reduced(), lr 3e-3 (phase 9e's), 30 steps of 4 x 32 tokens
    small = lm_config(SSM_ARCH).reduced()
    t0 = time.perf_counter()
    rep = Engine(small, lr=LM_SMALL_LR, device=dev).train_session(
        batch=4, seq=33, schedule_steps=LM_TRAIN_STEPS).run(LM_TRAIN_STEPS)
    small_losses = [h["loss"] for h in rep.history]
    print(f"[ssm] {small.name} on the card: loss curve "
          f"{[round(x, 4) for x in small_losses]}; mean of the last 3 "
          f"{np.mean(small_losses[-3:]):.4f} against the first "
          f"{small_losses[0]:.4f} ({time.perf_counter() - t0:.1f} s)")
    check(all(math.isfinite(x) for x in small_losses)
          and np.mean(small_losses[-3:]) < small_losses[0],
          "the mean of the last 3 reduced rwkv6 losses is not below the "
          "first")
    return params, dict(losses=losses, p50_ms=p50 * 1e3, wall_s=wall,
                        tokens_per_s=tokens / p50, peak_gb=peak,
                        chunk_peaks_gb=chunk_peaks, profile=prof,
                        small_losses=small_losses)


def ssm_serve(params, dev, card):
    """(a)3-4 on the trained params: prefill 2 x 2,048 and decode 32
    tokens through the entry points, timed and profiled; then a 2 x 256
    prompt and 8 greedy tokens through prefill and decode against one
    forward over the 264 tokens."""
    from repro_torch.models import lm as LM
    from repro_torch.models import transformer as T
    cfg = lm_config(SSM_ARCH, SSM_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(25)
    B, Tn = SSM_PREFILL
    max_len = Tn + SSM_DECODE_STEPS
    prompt = torch.randint(0, cfg.vocab_size, (B, Tn), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches, tok = LM.make_prefill_step(cfg, max_len)(params,
                                                     {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    state_mb = sum(x.numel() * x.element_size() for c in caches
                   for x in c.values()) / 1e6
    decode = LM.make_decode_step(cfg)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(SSM_DECODE_STEPS):
        caches, tok = decode(params, caches, tok, Tn + i)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / SSM_DECODE_STEPS
    toks = torch.stack(out, 1)
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a decoded rwkv6 token is outside the vocab")
    print(f"[ssm] prefill {cfg.name} B={B} T={Tn}: {prefill_s * 1e3:.1f} "
          f"ms, {B * Tn / prefill_s:.0f} tokens/s; decode "
          f"{SSM_DECODE_STEPS} tokens: {decode_s * 1e3:.2f} ms a token, "
          f"{B / decode_s:.1f} tokens/s; decode state {state_mb:.2f} MB at "
          f"B={B}, whatever the length ({card})")
    prof_decode = lm_profile(
        f"decode step {cfg.name} B={B}",
        lambda n: [decode(params, caches, tok, max_len - 1)
                   for _ in range(n)], 4, card, cpu=False)
    del caches

    B, Tn = SSM_CHECK
    prompt = torch.randint(0, cfg.vocab_size, (B, Tn), generator=gen,
                           device=dev)
    prof_prefill = lm_profile(
        f"prefill {cfg.name} B={B} T={Tn}",
        lambda n: [LM.make_prefill_step(cfg, Tn)(params, {"tokens": prompt})
                   for _ in range(n)], 1, card, cpu=False)
    got, fed, _, _ = lm_run(params, cfg, prompt, Tn + SSM_CHECK_TOKENS,
                            SSM_CHECK_TOKENS)
    with torch.no_grad():
        hidden = T.forward(params, cfg, torch.cat([prompt, fed], 1))
        want = T.logits_from_hidden(params, cfg,
                                    hidden[:, Tn - 1:]).float()
    del hidden
    tol = lm_close(f"{cfg.name} B={B} T={Tn}: prefill + "
                   f"{SSM_CHECK_TOKENS} decode steps vs one forward over "
                   f"{Tn + SSM_CHECK_TOKENS}", got, want)
    lm_greedy(f"{cfg.name} decode vs forward greedy", fed,
              want[:, :SSM_CHECK_TOKENS], cfg.vocab_size, tol)
    return dict(prefill_ms=prefill_s * 1e3, decode_ms=decode_s * 1e3,
                state_mb=state_mb, prefill_tokens_per_s=SSM_PREFILL[0]
                * SSM_PREFILL[1] / prefill_s,
                profile={"decode": prof_decode, "prefill": prof_prefill})


def mamba_scan_fold(p, cfg, x):
    """``mamba_scan`` over x in one call and the fold of its single-token
    ``mamba_step`` calls, each timed: ((y, state), (y, state), scan s,
    fold s)."""
    from repro_torch.models import ssm as S
    B, Tn, _ = x.shape
    with torch.no_grad():
        S.mamba_scan(p, x[:, :S.SSM_CHUNK], cfg)     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan = S.mamba_scan(p, x, cfg)
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        state = S.init_mamba_state(cfg, B, x.dtype, x.device)
        ys = []
        t0 = time.perf_counter()
        for t in range(Tn):
            y_t, state = S.mamba_step(p, x[:, t:t + 1], cfg, state)
            ys.append(y_t)
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t0
    return scan, (torch.cat(ys, 1), state), scan_s, fold_s


def mamba_full(dev, card):
    """(b) jamba's Mamba mixer at jamba's full widths: ``mamba_scan`` over
    2 x 1,024 in one call against the fold of 1,024 ``mamba_step`` calls,
    on bf16 inputs as the model gives them (timed; the output held) and on
    fp32 inputs (the output and the final SSM state held: in bf16 the
    projections round differently over 2,048 rows and over 2)."""
    cfg = lm_config(JAMBA_ARCH)
    gen = torch.Generator(device=dev).manual_seed(26)
    from repro_torch.models import ssm as S
    p = S.init_mamba(gen, cfg)
    n = sum(x.numel() for x in p.values())
    B, Tn = MAMBA_SCAN
    x = torch.randn((B, Tn, cfg.d_model), generator=gen, device=dev)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        (y, st), (y_f, st_f), scan_s, fold_s = mamba_scan_fold(
            p, cfg, x.to(dtype))
        out[dtype] = dict(scan_ms=scan_s * 1e3, fold_ms=fold_s * 1e3,
                          out_rel=rel_err(y_f, y),
                          ssm_rel=rel_err(st_f["ssm"], st["ssm"]),
                          conv_rel=rel_err(st_f["conv"], st["conv"]))
        r = out[dtype]
        print(f"[ssm] mamba at {JAMBA_ARCH}'s widths (d {cfg.d_model}, "
              f"d_inner {cfg.ssm.expand * cfg.d_model}, d_state "
              f"{cfg.ssm.d_state}, d_conv {cfg.ssm.d_conv}: {n / 1e6:.1f} M "
              f"params), {dtype}, B={B} T={Tn}: scan {r['scan_ms']:.1f} ms, "
              f"fold of {Tn} steps {r['fold_ms']:.1f} ms "
              f"({r['fold_ms'] / Tn:.3f} ms a step); output "
              f"{r['out_rel']:.2e} of its norm off (limit {MAMBA_OUT_REL}), "
              f"final ssm state {r['ssm_rel']:.2e}, conv state "
              f"{r['conv_rel']:.2e} ({card})")
        check(all(bool(torch.isfinite(t).all()) for t in (y, st["ssm"])),
              "mamba_scan is not finite")
        check(r["out_rel"] <= MAMBA_OUT_REL,
              f"the mamba fold's {dtype} output disagrees")
    f32 = out[torch.float32]
    check(max(f32["ssm_rel"], f32["conv_rel"]) <= MAMBA_STATE_REL,
          f"the mamba fold's fp32 states are over {MAMBA_STATE_REL}")
    return dict(params=n, **out[torch.bfloat16],
                fp32_ssm_rel=f32["ssm_rel"], fp32_conv_rel=f32["conv_rel"])


def jamba_reduced(dev, card):
    """(c) jamba-1.5-large-398b whole at reduced(): remat against none
    (row 8 recomputed), a 2 x 512 prompt and 8 decode steps against the
    plain path, then 4 decode steps ending at position 524,287 of a
    524,288-slot cache (long_500k) against the plain path, row 9 itself
    held at that depth first. Returns rows 8 and 9's launches and row 9's
    comparison errors."""
    from repro_torch.data.lm import make_lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import lm as LM
    from repro_torch.models import transformer as T
    cfg = lm_config(JAMBA_ARCH).reduced()
    plan = T.plan_for(cfg)
    n_attn = plan.mixers.count("attn") * (cfg.n_layers // plan.period)
    gen = torch.Generator(device=dev).manual_seed(27)
    params = T.init_model(cfg, gen)
    print(f"[ssm] {cfg.name} (jamba at reduced(): the full width does not "
          f"fit one card): {cfg.n_layers} layers, "
          f"{cfg.n_layers - n_attn} Mamba + {n_attn} attention, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, d "
          f"{cfg.d_model}")

    B, Tn = JAMBA_TRAIN
    batch = make_lm_batch(cfg, 0, 0, B, Tn + 1, device=dev)

    def loss_fn(remat):
        def fn(p, b):
            hidden = T.forward(p, cfg, b["tokens"], remat=remat)
            return LM.chunked_cross_entropy(p, cfg, hidden, b["labels"])
        return fn
    runs = {}
    for remat in (True, False):
        ops.reset_launch_counts()
        loss, grads = LM.value_and_grad(loss_fn(remat), params, batch)
        runs[remat] = (float(loss), grads,
                       ops.launch_counts["flash_attention"])
    (l1, g1, c1), (l0, g0, c0) = runs[True], runs[False]
    grad_rel = max(((a - b).float().norm()
                    / b.float().norm().clamp_min(1e-30)).item()
                   for (_, a), (_, b) in zip(leaves(g1), leaves(g0)))
    print(f"[ssm] {cfg.name} B={B} T={Tn}: loss under remat {l1:.6f} vs "
          f"{l0:.6f}; grads at most {grad_rel:.2e} of their norm off; row "
          f"8 launches {c1} (remat) vs {c0}")
    check(abs(l1 - l0) <= SSM_LOSS_REL * abs(l0), "jamba's remat loss "
                                                  "disagrees")
    check(grad_rel <= SSM_GRAD_REL, "jamba's remat grads disagree")
    check((c1, c0) == (2 * n_attn, n_attn), f"remat launches {c1}, {c0}")
    del runs, g1, g0

    B, Tn = JAMBA_PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (B, Tn), generator=gen,
                           device=dev)
    ops.reset_launch_counts()
    lm_against_plain(f"{cfg.name} B={B} T={Tn}", params, cfg, prompt,
                     Tn + JAMBA_DECODE, JAMBA_DECODE, card)
    counts = dict(ops.launch_counts)
    want = {"flash_attention": n_attn, "flash_decode": n_attn * JAMBA_DECODE}
    check({k: counts[k] for k in want} == want,
          f"jamba launches {counts}, want {want}")

    errs = long_decode_needles(cfg, gen, dev)

    # long_500k: B = 1, the cache seeded on the card (K drawn LONG_K_STD
    # wide, so a few keys anywhere in it carry each softmax and the
    # attention layers move the logits), the SSM states drawn
    start = LONG_SLOTS - LONG_DECODE
    caches = T.init_cache(cfg, 1, LONG_SLOTS, device=dev)
    for c, mixer in zip(caches, plan.mixers):
        if mixer == "attn":
            c["k"].normal_(0.0, LONG_K_STD, generator=gen)
            c["v"].normal_(generator=gen)
            c["pos"][..., :start] = torch.arange(start, device=dev,
                                                 dtype=torch.int32)
        else:
            c["conv"].normal_(0.0, 0.5, generator=gen)
            c["ssm"].normal_(0.0, 0.1, generator=gen)
    plain_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    # the same cache with V zeroed over its first 1/8 (c["v"] is (units, B,
    # S, Hkv, hd)): what a decode that skipped the far chunks would read
    far_cut = start // 8
    cut_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    for c, mixer in zip(cut_caches, plan.mixers):
        if mixer == "attn":
            c["v"][:, :, :far_cut] = 0
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_DECODE), generator=gen,
                         device=dev)

    def run(cs):
        logits = []
        with torch.no_grad():
            for i in range(LONG_DECODE):
                hid, cs = T.forward_with_state(params, cfg, toks[:, i:i + 1],
                                               cs, start + i)
                logits.append(T.logits_from_hidden(params, cfg, hid)[:, 0]
                              .float())
        return torch.stack(logits, 1)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(caches)
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t0) * 1e3 / LONG_DECODE
    long_launches = ops.launch_counts["flash_decode"]
    with plain_attention():
        want_l = run(plain_caches)
        cut_l = run(cut_caches)
    cache_mb = sum(c[n].numel() * c[n].element_size() for c, m in
                   zip(caches, plan.mixers) if m == "attn"
                   for n in ("k", "v")) / 1e6
    print(f"[ssm] {cfg.name} long_500k: {LONG_DECODE} decode steps at "
          f"positions {start}..{LONG_SLOTS - 1} over {LONG_SLOTS} slots "
          f"(K/V {cache_mb:.1f} MB): {long_ms:.2f} ms a token ({card})")
    tol = lm_close(f"{cfg.name} long_500k decode", got, want_l)
    # the comparison can fail: V cut over the first 1/8 of the slots moves
    # the plain path's logits past lm_close's limits
    cut_err = (cut_l - want_l).abs().max().item()
    cut_rel = ((cut_l - want_l).norm() / want_l.norm()).item()
    print(f"[ssm] {cfg.name} long_500k with V zeroed over slots "
          f"[0, {far_cut}): the plain path's logits move {cut_err:.4e} "
          f"(tol {tol:.4e}), {cut_rel:.3e} of their norm (limit {LM_REL})")
    check(cut_err > tol or cut_rel > LM_REL,
          "long_500k's logits do not depend on the cache's far chunks")
    check(long_launches == n_attn * LONG_DECODE,
          f"long_500k row 9 launches {long_launches}")
    check(all(int((c["pos"] >= 0).sum(-1).min()) == LONG_SLOTS
              for c, m in zip(caches, plan.mixers) if m == "attn"),
          "the long_500k cache is not full after the decode")
    del caches, plain_caches, cut_caches, params
    torch.cuda.empty_cache()
    # row 8: remat's forward and recompute, remat off, the prefill
    return {"flash_attention": 4 * n_attn,
            "flash_decode": n_attn * (JAMBA_DECODE + LONG_DECODE)}, errs


def long_decode_needles(cfg, gen, dev):
    """Row 9 itself at long_500k's depth, at ``cfg``'s attention heads:
    one bf16 query against a 524,288-slot cache in which LONG_NEEDLES keys,
    spread from the first slot to the last, score NEEDLE_SCORE each for
    one query head of their group (the rest score ~N(0, 1)), so each
    head's output is drawn from these keys' values. Held against the
    plain version; dropping the first slot's needle moves the plain
    output past the row tolerance, so a kernel that skipped a chunk would
    fail. Comparison launches: not counted. Returns the errors."""
    from repro_torch.kernels import attention, ref
    Hq, Hkv, hd, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, LONG_SLOTS
    g = Hq // Hkv
    k = torch.randn((1, S, Hkv, hd), generator=gen, device=dev)
    v = torch.randn((1, S, Hkv, hd), generator=gen, device=dev)
    q = torch.randn((1, Hq, hd), generator=gen, device=dev)
    slots = torch.linspace(0, S - 1, LONG_NEEDLES).round().long().tolist()
    for i, s in enumerate(slots):
        for h in range(Hkv):
            qh = q[0, h * g + i % g]
            k[0, s, h] = qh * (NEEDLE_SCORE * math.sqrt(hd) / qh.dot(qh))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    lens = torch.full((1,), S, dtype=torch.int32, device=dev)
    errs = {}
    want = ref.flash_decode_ref(q, k, v, lens)
    close_attention("flash_decode", f"long_500k S={S} Hq={Hq} Hkv={Hkv} "
                    f"hd={hd} bf16, {LONG_NEEDLES} keys at slots {slots} "
                    f"scoring {NEEDLE_SCORE}",
                    attention.flash_decode(q, k, v, lens), want, errs)
    k[0, slots[0]] = 0
    dropped = ref.flash_decode_ref(q, k, v, lens).float()
    moved = ((dropped - want.float()).norm(dim=-1)
             / want.float().norm(dim=-1)).max().item()
    print(f"[ssm] long_500k row 9 without the slot-0 key: the plain output "
          f"moves {moved:.3e} of a row's norm (row limit "
          f"{ATTN_ROW_TOL[torch.bfloat16]})")
    check(moved > ATTN_ROW_TOL[torch.bfloat16],
          "long_500k's row 9 output does not depend on its first slot")
    return {name: max(e) for name, e in errs.items()}


def phase_ssm(dev, card):
    """Phase 9f: the SSM mixers (see the module doc)."""
    t_phase = time.perf_counter()
    params, train = ssm_train(dev, card)
    t_train = time.perf_counter()
    serve = ssm_serve(params, dev, card)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_serve = time.perf_counter()
    mamba = mamba_full(dev, card)
    t_mamba = time.perf_counter()
    launches, errs = jamba_reduced(dev, card)
    wall = time.perf_counter() - t_phase
    print(f"[ssm] phase 9f's parts: (a) train {t_train - t_phase:.1f} s, "
          f"serve {t_serve - t_train:.1f} s; (b) {t_mamba - t_serve:.1f} s; "
          f"(c) {t_phase + wall - t_mamba:.1f} s")
    check(torch.cuda.memory_allocated() < 1 * GB,
          f"{torch.cuda.memory_allocated() / GB:.2f} GB still allocated "
          f"after phase 9f")
    print(f"[ssm] phase 9f: {wall:.1f} s; launches on its path {launches} "
          f"({card})")
    torch.cuda.reset_peak_memory_stats()
    check(wall < SSM_PHASE_S, f"phase 9f took {wall:.1f} s, over "
                              f"{SSM_PHASE_S} s")
    return dict(train=train, serve=serve, mamba=mamba, launches=launches,
                errs=errs, wall_s=wall)


def leaves(tree, path=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k],
                                                       f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v,
                                                             f"{path}/{i}")]
    return [(path, tree)]


def build_all():
    """One nvcc per kernel source, all started together."""
    from repro_torch.kernels import (_build, attention, embedding_bags,
                                     feature_interactions, fused_serve)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(_build.build, (
            "fused_serve", "embedding_bag", "interactions", "flash_attention",
            "flash_decode")))
    for load in (fused_serve._lib, embedding_bags._lib,
                 feature_interactions._lib, attention._attention_lib,
                 attention._decode_lib):
        load()
    print(f"[build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this script runs the port on "
              "the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; allow_tf32 matmul=False cudnn=False")
    build_all()

    errs = phase_kernels(dev)
    none, none_launches, serial, open_loop = phase_main_none(dev)
    auto, auto_d1, auto_run = phase_main_auto(dev, none)
    times = phase_timing(none, auto, dev)
    print(f"[serve] plan=none per query, closed loop: p50 "
          f"{serial.p50_ms:.4f} ms, p99 {serial.p99_ms:.4f} ms; open loop "
          f"at {open_loop.offered_qps:.1f} qps: p50 {open_loop.p50_ms:.4f} "
          f"ms, p99 {open_loop.p99_ms:.4f} ms ({card})")
    s, o = auto_run["serial"], auto_run["open_loop"]
    print(f"[serve] plan=auto per query, closed loop: p50 {s.p50_ms:.4f} "
          f"ms, p99 {s.p99_ms:.4f} ms; open loop at {o.offered_qps:.1f} "
          f"qps: p50 {o.p50_ms:.4f} ms, p99 {o.p99_ms:.4f} ms ({card})")
    profile_flushes(none, "plan=none, planner depth", table=True)
    profile_flushes(auto, "plan=auto, planner depth")
    profile_flushes(auto_d1, "plan=auto, depth 1")
    auto_plan = auto.plan
    del auto, auto_d1
    torch.cuda.empty_cache()
    phase_interleaved(none, auto_plan)
    row_wise_p50 = phase_row_wise_serve(none, card)
    # 6a and 7a share the stacked tables and the store; the plan=none
    # session then hands its tables over, so 6b holds no more than ~45 GB
    cfg, tables = none.cfg, none.params["tables"]
    store, tiered = phase_tiered(tables, cfg, dev)
    api_serve = phase_api_serve(tables, store, cfg, dev)
    blocked = phase_blocked(tables, cfg, dev)
    none.params.clear()
    del tables, none
    torch.cuda.empty_cache()
    packed = phase_packed(store, cfg, dev)
    del store
    torch.cuda.empty_cache()
    api_attention = phase_api_attention(dev)
    train = phase_train(dev, card)
    first_bad = phase_train_diverging(dev, card)
    phase_row_wise_train(card)
    phase_resume(dev)
    fleet = phase_fleet(dev, card)
    fabric, fabric_errs, held = phase_fabric(dev, card)
    online, online_launches, online_errs = phase_online(dev, card, held)
    release_fabric_tables(held)
    lm = phase_lm(dev, card)
    ssm = phase_ssm(dev, card)
    for name, n in ssm["launches"].items():
        lm["launches"][name] += n
    host, host_errs = phase_host_tier(dev, card)
    for more in (tiered[2], api_serve[2], packed[2], api_attention[2],
                 blocked[2], host_errs, fabric_errs, online_errs,
                 ssm["errs"]):
        for name, err in more.items():       # the run's largest per kernel
            errs[name] = max(err, errs.get(name, 0.0))

    launches = {"fused_bag_interactions":
                none_launches["fused_bag_interactions"],
                "fused_grouped_bag_interactions":
                auto_run["launches"]["fused_grouped_bag_interactions"],
                **tiered[0], **packed[0], **api_serve[0], **api_attention[0],
                **blocked[0]}
    fabric_launches = sum(run["launches"] for run in fabric.values())
    launches["embedding_bag"] += fabric_launches
    for name, n in online_launches.items():
        launches[name] += n
    for name, n in lm["launches"].items():
        launches[name] += n
    # each kernel's row: the serve kernels at the depth-8 micro-batch
    # B = 25, the bags at B = 200, attention at the largest shape where
    # the plain version and the library also run
    by_shape = {**times, **api_serve[1], **api_attention[1], **blocked[1]}
    measured = {name: rows[25] for name, rows in by_shape.items()
                if 25 in rows}
    measured.update({**tiered[1], **packed[1]})
    measured["flash_attention"] = api_attention[1]["flash_attention"][CHECK_T]
    measured["flash_decode"] = api_attention[1]["flash_decode"][
        TIME_DECODE_B]
    measured["embedding_bag_blocked"] = blocked[1]["embedding_bag_blocked"][
        BLOCKED_BATCHES[0]]
    for label, row in train.items():
        print(f"[train] {label}: depth {row['depth']}, step p50 "
              f"{row['p50_ms']:.4f} ms p99 {row['p99_ms']:.4f} ms, "
              f"{row['samples_per_s']:.1f} samples/s, peak "
              f"{row['peak_gb']:.3f} GB ({card})")
    print(f"[train] plan={DIVERGING_RUN[0]} {DIVERGING_RUN[1]} lr "
          f"{DIVERGING_RUN[3]}: first non-finite loss at step {first_bad}")
    for label, p50 in row_wise_p50.items():
        print(f"[row-wise] {label}: closed-loop p50 {p50[0]:.4f} / "
              f"{p50[1]:.4f} ms ({card})")
    for label, run in fleet.items():
        rep = run["report"]
        print(f"[fleet] {label}: {rep.n_replicas_start}->"
              f"{rep.n_replicas_end} replicas, p50 {rep.p50_ms:.4f} ms p99 "
              f"{rep.p99_ms:.4f} ms, achieved/offered "
              f"{rep.achieved_qps:.2f}/{rep.offered_qps:.2f} qps, "
              f"{len(rep.scale_events)} scale events, "
              f"{len(rep.refreshes)} lfu_refresh, peak {run['peak_gb']:.2f} "
              f"GB ({card})")
    for label, run in [("(i) replicated", online["replicated"]),
                       *online["sharded"].items()]:
        o = run["report"].online
        print(f"[online] 9d{label}: {o.n_updates} updates, "
              f"{o.rows_pushed} rows pushed, apply "
              f"{[round(x, 3) for x in run['apply_ms']]} ms, staleness p50 "
              f"{o.staleness_p50_s * 1e3:.4f} ms max "
              f"{o.staleness_max_s * 1e3:.4f} ms, p50 "
              f"{run['report'].p50_ms:.4f} ms p99 {run['report'].p99_ms:.4f}"
              f" ms ({card})")
    tr, sv = lm["train"], lm["serve"]
    print(f"[lm] {LM_ARCH}: train step p50 {tr['p50_ms']:.2f} ms, "
          f"{tr['tokens_per_s']:.0f} tokens/s; prefill "
          f"{LM_PREFILL[0]}x{LM_PREFILL[1]} {sv['prefill_ms']:.1f} ms; "
          f"decode {sv['decode_ms']:.2f} ms a token; phase 9e "
          f"{lm['wall_s']:.1f} s, peak {lm['peak_gb']:.2f} GB ({card})")
    tr, sv, mb = ssm["train"], ssm["serve"], ssm["mamba"]
    print(f"[ssm] {SSM_ARCH}: train step p50 {tr['p50_ms']:.1f} ms, "
          f"{tr['tokens_per_s']:.0f} tokens/s, peak {tr['peak_gb']:.2f} GB; "
          f"prefill {SSM_PREFILL[0]}x{SSM_PREFILL[1]} {sv['prefill_ms']:.1f}"
          f" ms; decode {sv['decode_ms']:.2f} ms a token, state "
          f"{sv['state_mb']:.2f} MB; mamba at {JAMBA_ARCH}'s widths scan "
          f"{mb['scan_ms']:.1f} ms, fold {mb['fold_ms']:.1f} ms; phase 9f "
          f"{ssm['wall_s']:.1f} s ({card})")
    for label, run in fabric.items():
        rep = run["report"]
        print(f"[fabric] {label}: {rep.n_replicas_start}->"
              f"{rep.n_replicas_end} boards, p50 {rep.p50_ms:.4f} ms p99 "
              f"{rep.p99_ms:.4f} ms, achieved/offered "
              f"{rep.achieved_qps:.2f}/{rep.offered_qps:.2f} qps, "
              f"{rep.bytes_per_query:.1f} B/query, remote lookups "
              f"{rep.remote_lookup_fraction:.4f}, row 4 launches "
              f"{run['launches']} ({card})")
    print(json.dumps({"by_batch": by_shape}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "max_scaled_err": errs[(name, "scaled")],
         **({"max_bf16_block_err_over_bound":
             errs[(name, "bf16_blocks")]}
            if (name, "bf16_blocks") in errs else {}),
         **measured[name],
         **({"host_tier_launches": host["launches"],
             "host_tier_write_through_launches":
             host["write_through_launches"],
             "host_tier": host["time"],
             "host_tier_pooling_step": host["pooling_step"],
             "host_tier_peak_gb": host["peak_gb"]}
            if name == "cached_embedding_bag" else {}),
         **({"fabric_launches": fabric_launches}
            if name == "embedding_bag" else {}),
         **({"online_launches": online_launches[name]}
            if name in online_launches else {}),
         "lm_launches": lm["launches"].get(name, 0)}
        for name in KERNELS], "not_ported": NOT_PORTED}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

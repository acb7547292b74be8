#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. device: require CUDA; print the card's name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/**/csrc`` with
   nvcc (sm_90a), one nvcc per source, all started together;
3. hold every kernel against its plain PyTorch version on the card, with
   ``torch.equal`` (the sketch state is int32: tolerance 0), over cold,
   warm and near-rail (+ and -) states, K values that are not multiples
   of 32 or 128, R and E in {1, 7, 128}, k = 400,000 for the
   single-sketch residual kernel, and all-padding blocks: the fused
   update (kernel 1; also K at and past its staged layout's limit,
   24,576 / 24,577, and rows at one count whose water level's probe sums
   pass 2^31, K = 24,576 and 65,536), the banked residual (kernel 2;
   also K at and past its staged layout's limit, 24,576 / 24,577), the
   stacked single-sketch residual (kernel 3; also k = 16,384 / 16,385 /
   1,048,577, at and past its layouts' limits), each case of kernels 1-3
   on the layout its size names (``kernel.fused_layout``,
   ``banked_layout``, ``residual_layout``; the limit cases on the layout
   written beside them), kernels 1-3 on dyadic banks of 24 layers
   (the quantile kind's per-row capacities: K = 96,000 and 9,600
   counters a layer, the top rows almost all BLOCKED, a (1, B) weight
   row; kernel 3 at E = 24, k = 96,000), kernel 1 on the partition
   prep's flat layout (each row's run from ``uoff[r]``, the ``"bank"``
   backend) at S = 1, 7 and 128, with idle rows, rows whose inserts the
   empty fill consumes entirely, runs that fill the layout to its last
   entry and K = 40,000 and 400,000, kernels 1-3
   on the SS± drain's edge cases (``drain_domains``: ties at the
   threshold, rem at a prefix sum or past the total, error sums past
   2^31, errors of every sign, EMPTY and BLOCKED slots), and the serial
   baseline (kernel 4, on the first 4,096 items of each case, with k =
   40,000, a state that holds ids twice, the item -1 and SS± drains
   across several slots);
4. runs at a real size, each on a Zipf(1.0) stream over 2^24 ids at
   delete ratio 0.5, interleaved, in blocks of 65,536:
   - main: a flow-monitoring deployment of SpaceSaving± in the paper's
     alpha = 2 bounded-deletion regime, ``SketchSpec(eps=1e-5, alpha=2,
     shards=128, bits=24)`` = 400,000 counters, through
     ``StreamSession.ingest``, 64 blocks, kernel 1;
   - lazy: unsharded Lazy SpaceSaving±, eps=1e-3 (k = 2,000), 16 blocks,
     kernel 1;
   - block sspm k=400000: the main spec unsharded on
     ``backend="block"`` (path A), 32 blocks, kernel 3;
   - block lazy k=2000: the lazy run on ``backend="block"``, kernel 3;
     its bank must equal the lazy run's;
   - block sspm shards=128: the main run on ``backend="block"`` (path B,
     the masked-row vmap path), kernel 3; its bank must equal the main
     run's;
   - banked sspm shards=128: ``ops.sketch_block_update_banked`` over the
     main run's blocks, kernel 2; its bank must equal the main run's;
   - serial sspm k=4000: ``ops.sketch_block_update_serial`` on one
     sketch of ``capacity_for(1e-3, 2)`` counters, 8 blocks, kernel 4.
   - the bank phase (``bank_phase``): the ``"bank"`` backend (the
     partition core, one kernel-1 launch a block on the flat layout) on
     the main spec (64 blocks, staged), the lazy spec (16, through
     ``bank.update_single``) and path A's spec (32, R = 1, K = 400,000,
     unstaged), each bank equal to its ``kernel``/``block`` twin's and
     to the plain version (lazy over its first 4 blocks, k=400000 over
     its first 8); ``backend="serial"`` on the serial spec (kernel 4 over
     each block's aggregated uniques, its insert adds saturating), held
     to the plain version over 2 blocks; the sharded serial oracle at
     ``shards=8`` (one kernel-3 launch per shard) equal to the bank path
     over 2 blocks; the quantile ``"serial"`` path at bits = 12 (one
     kernel-4 launch per layer) equal to the quantile ``"bank"`` path.
   The session runs go through ``StreamSession``'s cached compiled
   ingest: each spec's first block runs eagerly and its CUDA graph is
   captured after it (timed apart, with the device memory the capture
   keeps), every later block replays the graph; each run fails unless
   its session ran the graph.
   Every counter is set to 0 before a run and read after it: each run
   must launch its kernel once per block and no other kernel (kernels 1-3
   on the layout named for the run: path A on summary+chain, the others
   staged; a replay adds the launches its graph holds). Each run
   but the serial one must equal the same blocks run through the plain
   versions on the card; each must hold the error bound of Thm 4 (SS±)
   or Thm 2 (Lazy) against the exact frequencies, with every item above
   the bound monitored. Then, each fatal:
   - the main stream through ``BlockFeeder`` at depth 1 and 2 (pinned
     host slots, a copy stream) and through
     ``ops.sketch_block_update_stream`` (its 64 x 65,536 int32 blocks on
     the card): each bank equal to the main run's, bit for bit, with 64
     staged launches of kernel 1 and no other kernel;
   - merge: the main run's bank merged with a bank of the lazy stream
     run on the main spec, on the card and on CPU copies, equal bit for
     bit, the merged bank within the summed Thm 4 bound over both
     streams with every item above it monitored; ``consolidated()`` of
     the main session equal to the CPU's consolidate;
   - the quantile kind (Dyadic SpaceSaving±, ``quantile_phase``) on the
     main stream (32 blocks) unless named: quantile sspm,
     ``SketchSpec(kind="quantile", bits=24, eps=1e-3, alpha=2)`` (24
     layers of up to 96,000 counters, 899,070 live, a 27.6 MB bank),
     through the captured ingest, kernel 1 unstaged; quantile lazy
     (eps=1e-2, 24 x 9,600, 16 blocks of another stream), kernel 1
     staged; quantile block and bank (the sspm spec on ``"block"``,
     kernel 3 summary+chain at E = 24, and on ``"bank"``, kernel 2
     unstaged), each bank equal to the sspm run's; quantile sharded
     (``shards=8`` on ``"bank"``: 192 rows, 221 MB, 8 blocks), kernel
     2 unstaged. Each launches its kernel once a block and no other;
     the sspm, lazy and sharded runs equal the plain versions over all
     their blocks, the block and bank runs over their first 8 (kernel
     and plain on the path's framework side); every layer row holds its
     Thm 4 / Thm 2 bound with the layer's own live capacity against the
     exact frequencies of ``x >> l``, every node above it monitored.
     ``rank_many`` on 4,097 points (the live values' quantiles, 0 and
     2^24 - 1) and ``quantile_many`` at 101 q (0, the percentiles, 1)
     of the sspm, lazy and sharded states are within eps·|F|₁ of the
     exact ranks and equal the CPU copies', and the rank check rejects
     a planted fault; ``sketch_block_update_stream`` with a
     ``DyadicLevelRouter`` equals the sspm bank; the sspm state merged
     with a state of the lazy stream on the sspm spec equals the CPU's
     merge and holds the summed bound; ``consolidated()`` of the sharded
     state equals the CPU's;
   - the multi-tenant serving path (``tenant_phase``), on the traffic of
     ``repro_torch.core.streams.mixed_traffic`` (Zipf(1.2) tenant sizes,
     each tenant a Zipf(1.0) bounded-deletion stream, bursts of 64, a
     query of 8 ids after 10 % of the bursts), replayed through
     ``SketchService`` as the reference's service bench replays it (a
     tick per block of pending updates), each service's kernel-1
     launches one a block: the bench shape (the reference's own,
     ``SketchSpec(k=1024*8, bits=16, tenants=1024)``, blocks of 8,192,
     200,000 updates at delete ratio 0.0 and 0.5), its bank equal to
     the plain version over every block, 32 sampled rows to the per-row
     oracle (``tenant.reference_row_update``), 64 sampled tenants to
     independent ``SketchSpec(k=8, bits=16)`` sketches fed the same
     fragments (``query_many``, ``tenant_topk``), every row within its
     Thm 4 bound; the fleet (32,768 tenants x 128 counters, a 50 MB
     bank, blocks of 16,384, 4,194,304 updates at delete ratio 0.5,
     ``window=8``) through a service that spills idle tenants
     (``spill_after=16``), refreshes 1,024 top-k subscriptions (m = 16)
     a tick and is saved and loaded into a new service halfway, and
     through a twin that does none of these: kernel 1 against its plain
     version over the first 4 blocks and, outside the service, against
     the twin over all; 64 sampled rows to the per-row oracle; the rows
     the window keeps strict turnstile within their Thm 4 bound; every
     subscription equal to a direct top-k; tenants never spilled bit for
     bit the twin's, tenants spilled and untouched since content-exact
     once re-admitted; 4,096-key batched point queries; quantile mode
     (``SketchSpec(kind="quantile", bits=24, eps=1e-3)`` with
     ``tenant_bits=8``, kernel 2 unstaged), 16 tenants subscribed to 9
     quantiles every 4 ticks, each within 2 eps·|F|₁ + 1 in rank of the
     exact per-tenant quantile; tenant specs of 1,024 and 2,048 tenants
     and of per-tenant caps sharing one compiled-ingest cell, one graph
     per state shape, each session equal to the plain version; and
     ``TokenStats`` (Gemma3-27B's 262,144-token vocabulary, 128 steps of
     8 x 4,096 Zipf(1.0) tokens, window 64) and ``ExpertLoadStats``
     (OLMoE-1B-7B's 64 experts, top-8 routing) within their Thm 4
     bounds of the exact windowed counts;
   - the family (``family_phase``): the unbiased kernel against its plain
     version on small banks, rows at and past its staged limit (16,384 /
     16,385 slots), a heavy hitter and warm banks; Double SpaceSaving± on
     the main spec (``variant="double"``, 64 blocks, two kernel-1
     launches a block and no other kernel; both banks equal to kernel
     1's replay of the blocks, and kernel 1 to its plain version over 8;
     every id within ``I_r/k_I + D_r/k_D`` of its count, never below it
     where monitored, every id above its row's slack among the top
     k_I); the service bench shape with ``variant="double"`` (the banks
     equal to the plain version over every block, 16 tenants equal to
     independent Double sketches); unbiased SpaceSaving± on the main
     spec (16 blocks, one unbiased launch a block; the kernel equal to
     its plain version on 8 sampled rows over 2 blocks, each bank's
     total its substream's mass, two sessions equal); CR-precis at the
     main budget (4 rows of primes up to 100,000, 64 blocks, no sketch
     kernel: equal to a CPU run, never below the true count, the merge
     of two halves the whole, ``topk`` at bits = 20 equal to the CPU's);
   - the fault layer (``fault_phase``), on the main spec on ``"bank"``:
     ``FaultPlan.random`` of 8 events over 64 blocks and 128 shards with
     a replay log and a schedule checkpoint at block 0; after every
     block ``dead_shards`` flags the rows corrupted that block, and any
     other row only for a count or error below 0 (SS± reaches one on a
     healthy row too: the never-failed twin's flags are recorded, each
     such row equal to the row rebuilt alone on the CPU from its own
     entries); recovery of the dead rows keeps every other row's
     live values, recovery of all 128 equals a never-failed twin; two
     delays on one row flag it on the port's straggler monitor;
     ``reshard_session`` 128 -> 96 -> 1 within each id's Thm 4 bound
     plus the accumulated ``error_slack``, the one row holding every
     counter and equal to ``consolidated()``; ``reshard_dyadic`` of an
     8-shard quantile bank to 4 within eps·|F|₁ plus 24 times the slack
     in rank;
   - the mesh phase (``mesh_phase``): (a) a process group of one rank
     over a ``FileStore`` (NCCL for the card's tensors, gloo for CPU
     copies) and ``launch.mesh.make_smoke_mesh(1)``: the main spec's
     sharded bank takes 16 blocks of the main stream through
     ``sharded.update_block(path="shard_map")`` (kernel 3 on the rank's
     rows, one launch a block), equal bit for bit to ``"vmap"`` and
     ``"block"`` and, over its first 2 blocks, to ``"block"`` on the CPU;
     the 8-shard quantile bank takes 8 blocks through
     ``dyadic_sharded.update_block(path="shard_map")`` (kernel 2), equal
     to ``"bank"``; ``train.dp_exchange.build_compressed_allreduce`` on
     that mesh over f32 gradients of Qwen3-0.6B's parameter shapes
     (``k_frac`` 0.01, 3 steps carrying the residual), equal leaf for
     leaf to the same exchange on CPU copies; the model on that mesh
     (``mesh_model``, MESH_MODEL): Qwen3-0.6B at full size through
     ``Trainer(mesh=, rules=default_rules())`` for 2 steps on DTensor
     state, kernel 5 on the rank's shards (2 a layer a step) and kernel
     1 for the token tracker, beside the same Trainer without a mesh
     (losses and gradient norms within the twin tolerances), its state
     saved on the mesh restored without one and the plain one's restored
     onto the mesh, bit for bit; Gemma3-27B's serving run (one period,
     B = 2 x 8,192, 8 tokens) through ``ServeEngine`` under ``use_mesh``
     on DTensor params, kernel 5 on the prefill and kernel 6 on each
     decode step (the cache's slots gathered over "model"), every
     step's logits and the SS± counts equal to the run without a mesh;
     kernels 5 and 6 held to their plain versions on the operands the
     mesh runs gave them; each path's ms and the mesh's overhead over
     the run without one. (b) two child processes
     on the same card in a gloo group (``mesh_child``): a
     ``StreamSession`` of the main spec on ``"bank"`` under ``use_mesh``
     of a ("data",) mesh of 2 takes the shard_map path, kernel 3 on each
     rank's 64 rows; each rank's gathered bank (staged through host
     memory: DTensor's own all-gather crashes on gloo with CUDA tensors,
     ``parallel.sharding.full``) equals (a)'s. A child that exits other
     than 0 fails the run. The ms a block of each path,
     the exchange's ms and the gathers' ms are logged with the card;
5. times: per-block ms and updates/s of each run; each kernel's device
   ms at its run's shapes (the kernels the profiler sees, per call; and
   the time per call from the host, which holds the wrapper's host time,
   the median of five rounds; the unbiased kernel on unbiased main's
   last block; the family's per-block ms, the recovery and resize
   seconds in their records)
   beside its bound and the plain version's ms; kernel 1 also on the
   lazy run's block 1 and on the partition layout (the bank main run's
   last block, bank lazy's block 1, bank k=400000's block 8), kernel 3 also on path B's last block and on the
   block-lazy run's block 1, kernels 1-3 on each quantile run's next
   block from its final bank, and for kernels 1-3 each timed block's
   evictions and SS± drain steps (in all and the most in one sketch or
   row) and the us per eviction; kernel 1 on the tenant layouts (the
   bench shape's last block, R = 1,024, and the fleet's, R = 32,768),
   with ``_pad_bank``'s ms against the device-busy ms per block of a
   profiled captured tenant ingest of each; ``rank_many`` and
   ``quantile_many`` ms;
   ``torch.profiler`` windows over blocks of the main, lazy, path A,
   path B, quantile sspm and bank main specs, each twice in one call:
   eager (``api.adapter_for(spec).update`` per block on a pageable copy)
   and captured (``StreamSession.ingest_block``: the graph, the pinned
   slot): wall and device-busy ms per block, the idle share, the host's
   ms per block in the CUDA runtime's calls (launches among them) and
   the ops that take the device and host time;
6. the attention kernels (flash attention, kernel 5; decode attention
   with per-slot mass, kernel 6), with TF32 off so the plain versions run
   in true f32:
   - each against its plain version on the card, f32 and bf16, on the
     reference's test grids plus a ragged S, T > S, no mask and a row with
     no valid slot, and flash on its wgmma path (bf16, hd 64/128/256, S =
     130, T = 300, G = 1, 2, 4), every flash case on the path
     ``flash_path`` names: flash within atol = rtol = 2e-5 (f32) / 2e-2 (bf16),
     decode ctx within 3e-5 / 3e-2 and mass within atol 2e-5, rtol 2e-4,
     the mass summing to KV·G on every row with a valid slot, flash and
     ctx also row by row as below;
   - the path at Gemma3-27B's widths (H = 32, KV = 16, hd = 128, bf16)
     through the entry points, every counter reset before and read after
     (flash twice on its wgmma path, decode once, no other kernel): flash
     global (B = 1, S = T = 4,096, causal), flash local (the same, window
     1,024), decode hh (B = 8 over the 8,192-slot heavy-hitter cache, 90 %
     valid); each
     held to its plain version row by row, |got - want| <= 2^-7·|want| +
     2^-6·RMS(row) (a row: one query's hd values of one q-head; the limit
     scales with the output), the decode launch repeated bit for bit; the
     same check must reject the plain version with a fault planted (one
     64-key tile or chunk dropped from P·V; two kv-heads swapped);
   - times with CUDA events: kernel, plain version, flash's mma.sync
     kernel at the same shapes, and one
     ``F.scaled_dot_product_attention`` call as the library yardstick
     (the backend it took is printed; for decode it gives the context
     only, not the mass), beside each run's bound.

7. the model phase (``model_phase``): the model stack and model serving
   on kernels 5 and 6, random bf16 weights from a seed, each config cut
   to one period of its layer pattern at full width:
   - Gemma3-27B (6 layers: 5 local, 1 global) serves B = 2 requests of
     8,192-token prompts and 32 greedy tokens through ``ServeEngine`` at
     a 131,072-token context: the global layer's SS± heavy-hitter cache
     of 8,192 slots is full after the prefill, so every step evicts, and
     its counts halve every 16 steps. Every counter reset before and read
     after: kernel 5 six times a prefill (5 windowed, 1 causal, by
     ``AttentionSpy``), kernel 6 six times a step, no other kernel and no
     plain version. Its plain twin (``attention="plain"`` on the card,
     teacher-forced on the kernel run's tokens, one request at a time)
     holds every step's logits row by row (|got - want| <=
     LOGIT_ROUNDING·|want| + LOGIT_SHARE·RMS(row), the check shown to
     reject the two requests' rows swapped) and the SS± cache (ids
     unique, EMPTY or a position before ``pos``, 0 <= errors <= counts,
     HH_OVERLAP of the ids in common with the twin's, counts on common
     ids within a quantum a step, one of the twin's 16 heaviest prompt
     positions resident); kernels 5 and 6 held to their plain versions
     on the operands this run gave them, as in the attention phase, with
     one fault planted per shape (``hold_kept``: the run's own logits see
     a prefill's last token only); times: prefill ms, decode ms a step,
     tokens/s over the whole timed window, the unembed's ms, one decode step profiled (device ms of kernel 6,
     the matmuls and the rest), beside the analytic bounds of the port's
     ``roofline_terms``; kernels 5 and 6 timed at the shapes this run
     gave them, beside their plain versions, one SDPA call and their
     bounds;
   - the serving invariant of ``tests/test_serve.py:24`` at the same
     width (a 1,024-token prompt, B = 2, context 4,096): prefill (kernel
     5) then one step gives the next token of 1,024 decode steps
     (kernel 6), the logits held row by row as the twin's (the
     reference's rtol = atol = 0.05, set at smoke width, is exceeded
     at this width by the plain versions too: the same run through
     them is the witness, the counts beyond it recorded for both), and
     the kernels held on its operands (``hold_kept``);
   - ``hh_planted``: the main run's SS± cache size with one heavy key a
     row, 64 evicting steps through the serving path's own SS± step
     (``decode.hh_attend_step``) on kernel 6 and on its plain version: the heavy position on top after every step, the two
     caches' ids and counts as above (at random init the main run's
     counts all round to 0);
   - the nine other configs (``MODEL_OTHERS``: Zamba2 with its shared
     block's SS± cache, Whisper with 1,500 frames, LLaVA with 2,880
     vision tokens, Mixtral and OLMoE with their experts, Mamba2 with no
     attention), each serving 4 tokens, held to its plain twin with its
     launch counts checked, and its kernels on their operands
     (``hold_kept``).

8. the train phase (``train_phase``): training through ``Trainer`` on
   kernel 5 (the forward of every attention layer; ``FlashAttentionFn``
   gives its backward, the plain attention's gradient) and kernel 1 (the
   SS± token and expert trackers), random bf16 weights from a seed:
   - main: Qwen3-0.6B at full width and depth (28 layers), B = 4 x 2,048
     tokens of ``TokenPipeline``'s Zipf stream a step, remat on, 16
     steps. One step against its plain twin (``attention="plain"``, the
     same state and batch: loss within 2^-8, gradient norm within 2^-5,
     each master leaf within 2 lr and at most 2^-3 of its weights a sign
     flip apart, ``TWIN_*``); every counter reset before the run and read
     after: kernel 5 twice a layer a step (remat's recompute the second),
     kernel 1 once a step, no other kernel and no plain version; every
     loss and gradient norm finite, the mean loss of the last 4 steps
     below step 1's, every master leaf moved and each param its cast;
     the token tracker bit for bit a CPU twin fed the same tokens;
     kernel 5 held to its plain version on the run's own operands
     (``hold_kept``) and ``FlashAttentionFn``'s input gradients equal to
     autograd's of the plain attention (``hold_grads``); times: ms a step
     after 2 warm-up steps, tokens/s, peak memory, kernel 5 and the
     attention backward at the training shape beside their bounds (and
     one SDPA call), one profiled step (device busy and idle, the device
     ms of the matmuls, kernel 5, the attention backward, the optimizer
     and the rest), beside ``roofline_terms``;
   - moe: OLMoE-1B-7B at full width (64 experts, top-8, d 2,048) on 2
     layers (depth cut), B = 4 x 1,024, 8 steps: the same checks but the
     loss's fall and the times, the expert tracker fed every step's
     counts (B·S·8·2 routed tokens) and bit for bit its CPU twin;
   - the reference's trainer cases at its shape (smoke Qwen3, seq_len
     32, B = 4): 8 straight steps against 4, save, resume, 4 more (the
     last loss within rtol 1e-5, bit-equality recorded); a stop after 3
     steps saves at step 3; the token sketch survives a resume.

9. the dry-run phase (``dryrun_phase``): in a child process of its own
   (``--dryrun-child``), a one-rank fake process group and a (1, 1) mesh
   on the card, train main's step (Qwen3-0.6B, 4 x 2,048, remat) and the
   model phase's decode step (Gemma3-27B, one period, B = 2, context
   131,072) traced under ``FakeTensorMode`` by ``launch.dryrun.
   trace_cell``; fatal: (a) kernel 5's op traced as often as the real
   train step launches kernel 5 (56) and kernel 6's as the real decode
   step launches kernel 6 (6), (b) the traced FLOPs of the train step
   within 1e-3 of ``FlopCounterMode``'s over one real step of train main
   (both printed op by op on a failure), (c) no device memory allocated
   by the traces (FakeTensorMode's one 4-byte context probe made and
   freed before the count), and the child done within 90 s; printed: the
   predicted
   per-device peak beside train main's measured one, the roofline terms.

10. the analysis phase (``analysis_phase``), fatal on any finding: the
    port's analyzer (``repro_torch.analysis``) where CUDA graphs and
    in-place donation exist: the recompile (SK203) and donation (SK204)
    layers over the reference's k = 64 grid of nine specs on the card
    (one cell per normalized layout, the tenant populations T = 3, 5, 1
    in one; each cell's ``CompiledIngest`` holding one CUDA graph per
    state shape and none more after the grid is driven again; the
    ``bank`` cells launch kernel 1; every launching wrapper's state
    operands first in its launch; a state kept from a donating ingest
    overwritten by the next, a kept state of ``donate=False`` never);
    the recompile check on the main spec's cell at its real size on
    ``"bank"`` (400,000 counters in 128 shards, block 65,536, two
    sessions on the main stream's first block: one cell, one graph);
    the ``ast`` layer with ``--ci``. Its seconds and finding counts are
    logged with the card.

The line before the last two is ``{"kernels": [...]}`` (the six ported
kernels and the port's own unbiased kernel, which replaces the
reference's plain-JAX scan; the entries of flash and of kernels 1-3
give their launches by path, kernels 1-4 and the unbiased kernel also
``stream_ms``; kernels 2 and 3 give their launches by run in
``launches_by_run``, the mesh phase's runs among them; flash's and
decode's launches include the model phase's and the mesh phase's
(``mesh_launches`` of them), decode's by run in
``launches_by_run``, their ``max_abs_err`` the model phase's shapes too, and both give their times and row shares at
the serving shapes under ``serving``; flash's launches include the
train phase's, ``training_launches`` of them, its ``max_abs_err`` the
training shapes' rows and gradients, its times at the training shape
under ``training``; kernel 1's include the trainers' trackers);
the last line is ``{"ok": true, "device": {...}}``. A summary also goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.roofline.model import hw_for  # noqa: E402

IMAX = 2**31 - 1
# the card's rates, from the port's H100 preset (its derivations are in
# src/repro_torch/roofline/model.py)
H100 = hw_for("gpu_h100")
HBM_BYTES_PER_S = H100.hbm_bw          # device memory
INT32_OPS_PER_S = H100.peak_int_ops    # int32 ALU
BF16_FLOPS_PER_S = H100.peak_flops     # dense bf16 on the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)



KERNELS = ("sketch_update_kernel_fused", "sketch_residual_kernel_banked",
           "sketch_residual_kernel", "sketch_update_kernel_serial")
FLASH, DECODE = "flash_attention_kernel", "decode_attention_kernel"


def counted_kernels() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches
    (flash attention per path, in a dict)."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.sketch_update import kernel

    wrappers = {name: getattr(kernel, name) for name in KERNELS}
    wrappers[UNBIASED] = kernel.sketch_unbiased_kernel
    wrappers[FLASH] = fa.flash_attention_kernel
    wrappers[DECODE] = da.decode_attention_kernel
    return wrappers


def reset_counts() -> None:
    for fn in counted_kernels().values():
        fn.launches = (dict.fromkeys(fn.launches, 0)
                       if isinstance(fn.launches, dict) else 0)


def read_counts() -> dict:
    """Launches by kernel; flash attention's as ``name[path]``."""
    counts = {}
    for name, fn in counted_kernels().items():
        if isinstance(fn.launches, dict):
            counts.update({f"{name}[{path}]": n
                           for path, n in fn.launches.items()})
        else:
            counts[name] = fn.launches
    return counts


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases():
    """(name, R, K, variant, bank state, block kind[, layout]) grid of
    kernel 1: besides the states above, K = 24,576 (the largest row it
    stages in shared memory) and 24,577 (past it: the row stays in device
    memory, its chunk minima in a scratch), the drain cases
    (``drain_domains``, on rows of 3,001 and 30,000 slots, after
    DRAIN_INSERTS evictions), rows at one count whose water level's
    probe sums pass 2^31 (``wrap_fused``), and dyadic banks of 24 layers
    (``case_block``'s ``"dyadic"`` block) at K = 96,000 (unstaged) and
    9,600 (staged), and the partition prep's flat layout (the ``"bank"``
    backend, each row's run from ``uoff[r]``: ``"partition*"`` blocks,
    ``fused_case``) at S = 1, 7 and 128, with rows given no work, rows
    whose inserts the empty fill consumes entirely, runs that fill the
    layout to its last entry, and K = 40,000 and 400,000 (unstaged). A
    case that names a layout must run on it."""
    cases = []
    for v in (2, 1):
        cases += [
            ("cold R=1 K=77", 1, 77, v, "cold", "stream"),
            ("warm R=7 K=200", 7, 200, v, "warm", "stream"),
            ("warm R=128 K=3125", 128, 3125, v, "warm", "stream"),
            ("warm R=1 K=2000", 1, 2000, v, "warm", "stream"),
            ("partition cold S=1 K=77", 1, 77, v, "cold", "partition"),
            ("partition warm S=1 K=2000", 1, 2000, v, "warm", "partition"),
            ("partition warm S=128 K=3125", 128, 3125, v, "warm",
             "partition"),
            ("partition rail+ S=7 K=1000", 7, 1000, v, "rail+",
             "partition"),
            ("partition idle rows S=128 K=3125", 128, 3125, v, "warm",
             "partition sparse"),
            ("partition consumed S=7 K=20000", 7, 20000, v, "cold",
             "partition consumed"),
            ("partition G full S=1 K=2000", 1, 2000, v, "warm",
             "partition full"),
            ("partition G full S=128 K=3125", 128, 3125, v, "warm",
             "partition full"),
            ("partition consumed S=1 K=40000", 1, 40000, v, "cold",
             "partition consumed", "unstaged"),
            ("partition warm S=1 K=400000", 1, 400000, v, "warm",
             "partition", "unstaged"),
            ("rail+ R=7 K=1000", 7, 1000, v, "rail+", "stream"),
            # the water level's probe is false even at INT_MAX: the
            # bisection ends with lo past hi
            ("rail+ R=1 K=77", 1, 77, v, "rail+", "stream"),
            ("rail- R=7 K=301", 7, 301, v, "rail-", "stream"),
            ("warm R=128 K=3125 padding", 128, 3125, v, "warm", "padding"),
            ("cold R=1 K=40000", 1, 40000, v, "cold", "stream"),
            ("warm R=1 K=24576", 1, 24576, v, "warm", "stream", "staged"),
            ("warm R=1 K=24577", 1, 24577, v, "warm", "stream", "unstaged"),
            ("wrap R=1 K=24576", 1, 24576, v, "equal", "wrap", "staged"),
            ("wrap R=1 K=65536", 1, 65536, v, "equal", "wrap", "unstaged"),
            ("dyadic cold R=24 K=96000", 24, 96000, v, "cold", "dyadic",
             "unstaged"),
            ("dyadic warm R=24 K=96000", 24, 96000, v, "warm", "dyadic",
             "unstaged"),
            ("dyadic warm R=24 K=9600", 24, 9600, v, "warm", "dyadic",
             "staged"),
        ]
        cases += [(f"drain {kind} R=3 K=3001", 3, 3001, v, kind, "drain")
                  for kind in DRAIN_KINDS]
        cases += [("drain ties R=2 K=30000", 2, 30000, v, "ties", "drain"),
                  ("drain signs R=2 K=30000", 2, 30000, v, "signs", "drain")]
    return cases


def banked_cases():
    """(name, R, K, variant, bank state, block kind[, layout]) grid of
    kernel 2: besides the states above, K = 24,576 (the largest row it
    stages in shared memory), 24,577 and 400,000 (past it: the row stays
    in device memory, its chunk minima in a scratch), the drain cases
    (``drain_domains``, on unpadded rows of 3,001 slots: rows off 16-byte
    alignment), and dyadic banks of 24 layers at K = 96,000 and 9,600. A
    case that names a layout must run on it."""
    cases = []
    for v in (2, 1):
        cases += [
            ("cold R=1 K=77", 1, 77, v, "cold", "stream"),
            ("warm R=7 K=200", 7, 200, v, "warm", "stream"),
            ("warm R=128 K=3125", 128, 3125, v, "warm", "stream"),
            ("rail+ R=7 K=1000", 7, 1000, v, "rail+", "stream"),
            ("rail- R=7 K=301", 7, 301, v, "rail-", "stream"),
            ("warm R=128 K=3125 padding", 128, 3125, v, "warm", "padding"),
            ("warm R=1 K=24576", 1, 24576, v, "warm", "stream", "staged"),
            ("warm R=1 K=24577", 1, 24577, v, "warm", "stream", "unstaged"),
            ("warm R=1 K=400000", 1, 400000, v, "warm", "stream",
             "unstaged"),
            ("dyadic warm R=24 K=96000", 24, 96000, v, "warm", "dyadic",
             "unstaged"),
            ("dyadic warm R=24 K=9600", 24, 9600, v, "warm", "dyadic",
             "staged"),
        ]
        cases += [(f"drain {kind} R=3 K=3001", 3, 3001, v, kind, "drain")
                  for kind in DRAIN_KINDS]
        cases += [("drain ties R=2 K=30000", 2, 30000, v, "ties", "drain"),
                  ("drain signs R=2 K=30000", 2, 30000, v, "signs", "drain")]
    return cases


def split_cases():
    """(name, E, k, variant, state, block kind[, layout]) grid of kernel
    3: E > 1
    sketches take the rows' routed (sorted) views, E = 1 the raw block.
    Besides the states above: k = 16,384 (R = 128, the largest sketch it
    stages in shared memory), 16,385 (R = 129: the rows stay in device
    memory, summarised over the card), 1,048,577 (R = 8,193: the
    summaries no longer fit shared memory and stay in the scratch), the
    drain cases (``drain_domains``) on both sides of the staged layout's
    limit, and the 24 layers of a dyadic bank of 96,000 counters a layer
    as E = 24 sketches of R = 750 rows. A case that names a layout must
    run on it."""
    cases = []
    for v in (2, 1):
        cases += [
            ("cold E=1 k=77", 1, 77, v, "cold", "stream"),
            ("warm E=7 k=200", 7, 200, v, "warm", "stream"),
            ("warm E=128 k=3125", 128, 3125, v, "warm", "stream"),
            ("rail+ E=7 k=1000", 7, 1000, v, "rail+", "stream"),
            ("rail- E=7 k=301", 7, 301, v, "rail-", "stream"),
            ("warm E=128 k=3125 padding", 128, 3125, v, "warm", "padding"),
            ("warm E=1 k=3125", 1, 3125, v, "warm", "stream"),
            ("warm E=1 k=400000", 1, 400000, v, "warm", "stream",
             "summary+chain"),
            ("warm E=1 k=16384", 1, 16384, v, "warm", "stream", "staged"),
            ("warm E=1 k=16385", 1, 16385, v, "warm", "stream",
             "summary+chain"),
            ("warm E=1 k=1048577", 1, 1048577, v, "warm", "stream",
             "summary+chain/scratch"),
            ("dyadic warm E=24 k=96000", 24, 96000, v, "warm", "dyadic",
             "summary+chain"),
        ]
        cases += [(f"drain {kind} E=3 k=3000", 3, 3000, v, kind, "drain")
                  for kind in DRAIN_KINDS]
        cases += [("drain ties E=2 k=20000", 2, 20000, v, "ties", "drain"),
                  ("drain big E=2 k=20000", 2, 20000, v, "big", "drain"),
                  ("drain signs E=1 k=400000", 1, 400000, v, "signs",
                   "drain")]
    return cases


# The SS± drain's edge cases (``drain_domains``): ties at the threshold
# (inside one 128-slot row and across rows) with a remainder, rem equal to
# a prefix sum that ends inside the ties, rem equal to the sum above them,
# rem past the total error, errors whose sum passes 2^31, errors of every
# sign (0, -1, INT_MIN, INT_MAX), and EMPTY and BLOCKED slots.
DRAIN_KINDS = ("ties", "prefix", "boundary", "over", "big", "signs", "empty")
DRAIN_INSERTS = 40   # evictions before each drain


def drain_domains(kind, n, width, seed):
    """``n`` drain domains of ``width`` slots each (a bank row, or one
    sketch's flat slots) and each one's deletion weight, from ``seed``:
    ``(ids, counts, errors, rem)``, numpy int32, the first three (n,
    width). Counts are random, some near the negative rail where a slot
    drains (kernel 3 wraps there, kernel 2 saturates)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = ((1 << 22) + np.arange(n * width)).reshape(n, width)
    counts = rng.integers(0, 10**6, (n, width))
    errors = rng.integers(0, 50, (n, width))
    rem = np.zeros(n, np.int64)
    imax = 2**31 - 1
    for d in range(n):
        e, c = errors[d], counts[d]
        if kind in ("ties", "prefix", "boundary"):
            # 24 slots at 1,000: 12 inside one 128-slot row, 12 anywhere;
            # 5 above them, two of those tied too
            row = 128 * int(rng.integers(0, max(width // 128, 1)))
            tie = np.concatenate([
                row + rng.choice(min(128, width - row), 12, replace=False),
                rng.choice(width, 12, replace=False)])
            e[tie] = 1000
            c[tie[::3]] = -imax + 600
            top = rng.choice(width, 5, replace=False)
            e[top] = [3000, 3000, 3001, 2500, 1001]
            above = int(e[e > 1000].sum())
            rem[d] = above + {"ties": 7123, "prefix": 7000, "boundary": 0}[kind]
        elif kind == "over":
            e -= 5
            rem[d] = int(e[e > 0].sum()) + 1000
        elif kind == "big":
            big = rng.choice(width, 20, replace=False)
            e[big] = rng.integers(2**29, 2**30, 20)
            c[big[:5]] = -imax + rng.integers(0, 4, 5)
            rem[d] = imax
        elif kind == "signs":
            e[:] = rng.integers(-2**31, 2**31, width)
            e[rng.choice(width, 6, replace=False)] = [-2**31, -1, 0, 0, imax,
                                                       imax]
            c[np.argsort(-e)[:8]] = -imax + 2
            rem[d] = int(rng.integers(2**30, 2**31))
        elif kind == "empty":
            # EMPTY slots (count 0, error 0) and a BLOCKED tail (INT_MAX,
            # 0), as the kernels' callers lay them out
            empty = rng.random(width) < 0.1
            ids[d, empty], c[empty], e[empty] = -1, 0, 0
            tail = slice(width - width // 16, width)
            ids[d, tail], c[tail], e[tail] = -2, imax, 0
            rem[d] = int(e[e > 0].sum()) // 2
        else:
            raise ValueError(kind)
    as32 = lambda a: a.astype(np.int32)
    return as32(ids), as32(counts), as32(errors), as32(rem)


def drain_inserts(n, B, seed):
    """(n, B) uids (fresh, distinct) and net weights (2-60, one at INT_MAX)
    of the evictions before each drain."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    uids = (1 << 23) + np.arange(n * B).reshape(n, B)
    net = rng.integers(2, 61, (n, B))
    net[:, 3] = 2**31 - 1
    return uids.astype(np.int32), net.astype(np.int32)


def drain_split(E, k, variant, kind, device, seed):
    """Kernel 3's operands for a drain case: E sketches of k slots (their
    row view, BLOCKED past k), DRAIN_INSERTS evictions each, then the
    drain of rem (SS±)."""
    import torch
    from repro_torch.sketch.phases import pad_rows

    ids, counts, errors, rem = drain_domains(kind, E, k, seed)
    uids, net = drain_inserts(E, 64, seed)
    t = lambda a: torch.as_tensor(a, device=device)
    zero = torch.zeros(E, dtype=torch.int32, device=device)
    return (list(pad_rows(t(ids), t(counts), t(errors))),
            [t(uids), t(net), zero, zero + DRAIN_INSERTS, t(rem)])


def drain_banked(R, K, variant, kind, device, seed):
    """Kernel 2's operands for a drain case: R unpadded rows of K slots,
    DRAIN_INSERTS evictions each from the flat layout, then the drain."""
    import torch

    ids, counts, errors, rem = drain_domains(kind, R, K, seed)
    uids, net = drain_inserts(1, 64 * R, seed)
    t = lambda a: torch.as_tensor(a, device=device)
    zero = torch.zeros(R, dtype=torch.int32, device=device)
    uoff = torch.arange(R, dtype=torch.int32, device=device) * 64
    return ([t(ids), t(counts), t(errors)],
            [t(uids[0]), t(net[0]), uoff, zero, zero + DRAIN_INSERTS, t(rem)])


def drain_fused(R, K, variant, kind, device, seed):
    """Kernel 1's operands for a drain case: R rows of K slots, a delta of
    -2..2 on every slot, DRAIN_INSERTS non-unit evictions each from the
    row's run of the grouped layout, then the drain."""
    import numpy as np
    import torch

    ids, counts, errors, rem = drain_domains(kind, R, K, seed)
    uids, net = drain_inserts(R, 64, seed)
    delta = np.random.default_rng(seed + 2).integers(-2, 3, (R, K))
    t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    zero = torch.zeros(R, dtype=torch.int32, device=device)
    return ([t(ids), t(counts), t(errors)],
            [t(delta), t(uids), t(net), zero, zero, zero + DRAIN_INSERTS,
             t(rem)])


def wrap_fused(R, K, device):
    """Kernel 1's operands where the water level's probe sums pass 2^31, as
    the reference's int32 sums wrap there: R rows of K monitored slots at
    count 5 and m = B = 2 * ceil(2^31 / K) unit inserts a row, so the first
    probe, at 5 + B // 2, counts B // 2 + 1 values a slot, K (B // 2 + 1)
    >= 2^31 in all."""
    import torch

    B = 2 * -(-2**31 // K)
    i32 = dict(dtype=torch.int32, device=device)
    ids = (1 << 22) + torch.arange(R * K, **i32).view(R, K)
    uids = (1 << 23) + torch.arange(R * B, **i32).view(R, B)
    zero = torch.zeros(R, **i32)
    return ([ids, torch.full((R, K), 5, **i32), torch.zeros((R, K), **i32)],
            [torch.zeros((R, K), **i32), uids, torch.ones((R, B), **i32),
             zero, zero + B, zero, zero])


SERIAL_ITEMS = 4096   # the plain serial version is a Python loop per item


def serial_cases():
    """(name, 1, k, variant, state, block kind) grid of kernel 4, each on
    the first SERIAL_ITEMS items of its block: besides the states above,
    k = 8,000 (n = 8,064, the largest n whose slots and structures all fit
    in shared memory), k = 8,100 and k = 40,000 (they do not: the slots
    stay in global memory, the structures in a scratch), a state that
    holds one id in three slots (evicted first) and another in two, a
    block with the item -1 (inserted into EMPTY slots and evicting into
    them) and one with unmonitored deletions of weight 40 (the SS± drain
    crosses several maximum-error slots)."""
    cases = []
    for v in (2, 1):
        cases += [
            ("cold k=77", 1, 77, v, "cold", "stream"),
            ("warm k=200", 1, 200, v, "warm", "stream"),
            ("rail+ k=1000", 1, 1000, v, "rail+", "stream"),
            ("rail- k=301", 1, 301, v, "rail-", "stream"),
            ("warm k=3125", 1, 3125, v, "warm", "stream"),
            ("warm k=4000", 1, 4000, v, "warm", "stream"),
            ("warm k=200 padding", 1, 200, v, "warm", "padding"),
            ("warm k=8000", 1, 8000, v, "warm", "stream"),
            ("warm k=8100", 1, 8100, v, "warm", "stream"),
            ("warm k=40000", 1, 40000, v, "warm", "stream"),
            ("dup k=1000", 1, 1000, v, "dup", "stream"),
            ("cold k=77 item -1", 1, 77, v, "cold", "minus1"),
            ("warm k=200 item -1", 1, 200, v, "warm", "minus1"),
            ("warm k=301 drain", 1, 301, v, "warm", "drain"),
        ]
    return cases


def _block(stream, lo, n, torch, device):
    part = stream[lo:lo + n]
    return (torch.as_tensor(part[:, 0], dtype=torch.int32, device=device),
            torch.as_tensor(part[:, 1], dtype=torch.int32, device=device))


def case_block(R, K, variant, state, block, device, seed, B=65536):
    """An (R, K) bank and a raw block for one case, built with the plain
    version. Returns ``(bank, items, weights, router)``. Block kind
    ``"dyadic"``: the bank of an R-bit dyadic sketch of K counters a
    layer (layer l holds min(K, 2^(R-l)) live slots, the rest BLOCKED),
    the block over 2^R ids routed by ``DyadicLevelRouter`` (one (1, B)
    weight row)."""
    import torch
    from repro_torch.core.quantiles import dyadic_layer_capacities
    from repro_torch.core.streams import bounded_stream
    from repro_torch.kernels.sketch_update.ops import block_update_with
    from repro_torch.kernels.sketch_update.ref import fused_update_ref
    from repro_torch.sketch import bank as bk
    from repro_torch.sketch.state import BLOCKED, SketchState, sat_add

    n_warm = 0 if state == "cold" else 2
    bits = R if block == "dyadic" else 20
    stream = bounded_stream(math.ceil((n_warm + 1) * B / 1.5) + 1, 0.5,
                            universe=1 << bits, seed=seed)
    if block == "dyadic":
        router = bk.DyadicLevelRouter(R)
        bank = bk.init(dyadic_layer_capacities(R, total_counters=R * K),
                       device=device)
    else:
        router = bk.HashShardRouter(R, 20)
        bank = bk.init(K, R, device=device)
    for i in range(n_warm):
        it, w = _block(stream, i * B, B, torch, device)
        bank = block_update_with(fused_update_ref, bank,
                                 *router.route_dense(it, w), variant)
    if n_warm:
        # warm rows are full and have forgotten items, so the block meets
        # the water-fill, the evictions and the spread: EMPTY slots and a
        # third of the rest take distinct ids outside the stream's universe
        # with small counts and errors
        g = torch.Generator(device=device).manual_seed(seed)
        empty = (bank.ids == -1) | ((torch.rand(
            bank.ids.shape, generator=g, device=device) < 0.3)
            & (bank.ids != BLOCKED))
        fresh = (1 << 21) + torch.arange(bank.ids.numel(), device=device,
                                         dtype=torch.int32).view_as(bank.ids)
        c = torch.randint(1, 6, bank.ids.shape, generator=g, device=device,
                          dtype=torch.int32)
        e = torch.remainder(torch.randint(0, 6, bank.ids.shape, generator=g,
                                          device=device, dtype=torch.int32), c)
        bank = SketchState(torch.where(empty, fresh, bank.ids),
                           torch.where(empty, c, bank.counts),
                           torch.where(empty, e, bank.errors))
    live = bank.ids >= 0
    if state == "rail+":
        bank = bank._replace(counts=torch.where(
            live, sat_add(bank.counts, IMAX - 40), bank.counts))
    elif state == "rail-":
        bank = bank._replace(counts=torch.where(
            live, sat_add(bank.counts, -(IMAX - 40)), bank.counts))
    it, w = _block(stream, n_warm * B, B, torch, device)
    if block == "padding":
        w = torch.zeros_like(w)
    elif block == "partition sparse":
        w[64:] = 0               # most rows get no entry
    elif block == "partition full":
        # B distinct new ids, all inserts: every entry is a residual insert
        it = (1 << 22) + torch.arange(B, dtype=torch.int32, device=device)
        w = 1 + torch.randint(0, 3, (B,), dtype=torch.int32, device=device,
                              generator=torch.Generator(device=device)
                              .manual_seed(seed))
    return SketchState(*(t.contiguous() for t in bank)), it, w, router


def fused_case(R, K, variant, state, block, device, seed):
    """Kernel 1's operands: the bank and its prep (``drain_fused``'s or
    ``wrap_fused``'s for those cases). A ``"partition*"`` block takes the
    partition prep (a flat layout and ``uoff``), and the case must be what
    its kind names: idle rows (``sparse``), every row's inserts consumed
    by the fill (``consumed``), the runs ending at the layout's last
    entry (``full``)."""
    from repro_torch.sketch import bank as bk

    if block == "drain":
        return drain_fused(R, K, variant, state, device, seed)
    if block == "wrap":
        return wrap_fused(R, K, device)
    bank, it, w, router = case_block(R, K, variant, state, block, device,
                                     seed)
    if block.startswith("partition"):
        prep = bk.phase1_partition_prep(bank, it, w, router, variant)
        delta, h_uids, h_net, i0, mu, nnu, w_del, uoff = prep
        work = i0 + mu + nnu + w_del
        if not {"partition sparse": bool((work == 0).any()),
                "partition consumed": bool(((mu + nnu) == 0).all()
                                           and (i0 > 0).all()),
                "partition full": int(uoff[-1] + mu[-1] + nnu[-1] + i0[-1])
                == len(it)}.get(block, True):
            raise SystemExit(f"the {block} case S={R} K={K} is not one")
        return list(bank), list(prep)
    ri, rw = router.route_dense(it, w)
    return list(bank), list(bk.phase1_dense_prep(bank, ri, rw, variant))


def banked_case(R, K, variant, state, block, device, seed):
    """Kernel 2's operands: the padded bank after ``bank.phase1_dense``
    (``drain_banked``'s for a drain case)."""
    if block == "drain":
        return drain_banked(R, K, variant, state, device, seed)
    bank, it, w, router = case_block(R, K, variant, state, block, device,
                                     seed)
    return banked_operands(bank, *router.route_dense(it, w), variant)


def split_case(E, k, variant, state, block, device, seed):
    """Kernel 3's operands: E sketches' row view after ``_phase1``
    (``drain_split``'s for a drain case)."""
    if block == "drain":
        return drain_split(E, k, variant, state, device, seed)
    bank, it, w, router = case_block(E, k, variant, state, block, device,
                                     seed)
    if E == 1 and block != "dyadic":
        return split_operands(bank, it[None], w[None], variant, False)
    ri, rw = router.route_dense(it, w)    # rw: (1, B) for the dyadic router
    return split_operands(bank, ri, rw.expand(ri.shape), variant, True)


def serial_case(_, k, variant, state, block, device, seed):
    """Kernel 4's operands: one sketch's row view and the block's first
    SERIAL_ITEMS items, with the serial grid's own states and blocks
    (``serial_cases``) planted on a warm state and a stream block."""
    import torch

    bank, it, w, _ = case_block(
        1, k, variant, "warm" if state == "dup" else state,
        "stream" if block in ("minus1", "drain") else block, device, seed)
    it, w = it[:SERIAL_ITEMS].clone(), w[:SERIAL_ITEMS].clone()
    if state == "dup":
        # the block's first two ids: x in three slots at count 1 (the
        # evictions take them first, the lowest first), y in two
        ids, counts, errors = (t.clone() for t in bank)
        x, y = int(it[0]), int(it[0]) + 1
        it[1] = y
        for j, item, c, e in ((k // 3, x, 1, 0), (1, x, 1, 0), (k - 1, x, 1, 0),
                              (k // 2, y, 1000, 3), (2, y, 1000, 3)):
            ids[0, j], counts[0, j], errors[0, j] = item, c, e
        bank = type(bank)(ids, counts, errors)
    if block == "minus1":
        it[::7] = -1
    if block == "drain":
        # every fifth deletion: an id never inserted, weight -40
        at = (w < 0).nonzero().flatten()[::5]
        it[at] = (1 << 23) + torch.arange(len(at), dtype=it.dtype,
                                          device=it.device)
        w[at] = -40
    return serial_operands(bank, it, w)


def banked_operands(bank, row_items, row_weights, variant):
    from repro_torch.kernels.sketch_update.ops import _pad_bank
    from repro_torch.sketch.bank import phase1_dense
    from repro_torch.sketch.state import SketchState

    ids1, cnt1, err1, h_uids, h_net, uoff, mu, nnu, w_del = phase1_dense(
        bank, row_items, row_weights, variant)
    return (list(_pad_bank(SketchState(ids1, cnt1, err1))),
            [h_uids, h_net, uoff, mu, mu + nnu, w_del])


def split_operands(bank, items, weights, variant, assume_sorted):
    from repro_torch.sketch.blocks import _phase1
    from repro_torch.sketch.phases import pad_rows

    ph = _phase1(bank, items, weights, variant, assume_sorted)
    return list(pad_rows(*ph[:3])), list(ph[3:])


def serial_operands(bank, items, weights):
    from repro_torch.sketch.phases import pad_rows

    return list(pad_rows(*(t[0] for t in bank))), [items, weights]


def max_abs_err(want, got) -> int:
    return max(int((a.long() - b.long()).abs().max()) for a, b in zip(want, got))


def check_cases(label, kernel, plain, cases, operands, device, seed0,
                layout=None) -> int:
    """Each case's operands through the kernel (on copies, as it updates
    in place) and through its plain version; equal or fatal. Where
    ``layout(R, K)`` names the kernel's layout for a case's size, the
    call must run on it, and on the layout the case names where it
    names one."""
    import torch

    worst = 0
    for i, (name, R, K, v, state, block, *named) in enumerate(cases):
        st, args = operands(R, K, v, state, block, device, seed0 + i)
        want = plain(*st, *args, variant=v)
        before = dict(kernel.launches) if layout else None
        got = kernel(*(t.clone() for t in st), *args, variant=v)
        torch.cuda.synchronize()
        ran = ""
        if layout:
            ran = [p for p, n in kernel.launches.items() if n != before[p]]
            want_layout = named[0] if named else layout(R, K)
            if ran != [want_layout] or layout(R, K) != want_layout:
                raise SystemExit(f"{label} [{name}]: ran on {ran}, expected "
                                 f"{want_layout} (the size names "
                                 f"{layout(R, K)})")
            ran = f", layout {ran[0]}"
        err = max_abs_err(want, got)
        same = all(torch.equal(a, b) for a, b in zip(want, got))
        log(f"{label} vs plain [{name} variant={v}]: "
            f"{'equal' if same else 'DIFFERENT'} (max_abs_err {err}{ran})")
        if not same:
            raise SystemExit(f"{label} disagrees with its plain version: "
                             f"{name}")
        worst = max(worst, err)
    return worst


def check_all_cases(device) -> dict:
    from repro_torch.kernels.sketch_update import kernel, ref

    grid = (
        ("sketch_update_kernel_fused", ref.fused_update_ref, kernel_cases(),
         fused_case, 100, lambda R, K: kernel.fused_layout(K)),
        ("sketch_residual_kernel_banked", ref.residual_phase_banked,
         banked_cases(), banked_case, 200,
         lambda R, K: kernel.banked_layout(K)),
        ("sketch_residual_kernel", ref.residual_phase, split_cases(),
         split_case, 300, lambda E, k: kernel.residual_layout(-(-k // 128))),
        ("sketch_update_kernel_serial", ref.serial_update_ref,
         serial_cases(), serial_case, 400, None),
    )
    worst = {}
    for name, plain, cases, operands, seed0, layout in grid:
        t0 = time.perf_counter()
        worst[name] = check_cases(name, getattr(kernel, name), plain, cases,
                                  operands, device, seed0, layout)
        log(f"{name} vs plain: {len(cases)} cases equal "
            f"({time.perf_counter() - t0:.1f} s)")
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the runs
# ---------------------------------------------------------------------------

def make_stream(n_blocks, block, seed, bits=24):
    """A Zipf(1.0) bounded-deletion stream over 2^bits ids, delete ratio
    0.5, sized to fill ``n_blocks`` blocks (the last one partly)."""
    from repro_torch.core.streams import bounded_stream

    n_insert = (n_blocks * block) * 2 // 3
    return bounded_stream(n_insert, 0.5, universe=1 << bits, skew=1.0,
                          seed=seed)


def padded_blocks(stream, block):
    """The stream as (NB, block) int32 items and weights, the last block
    padded with weight 0, as ``StreamSession.ingest`` pads it."""
    import numpy as np

    n = len(stream)
    nb = -(-n // block)
    items = np.zeros(nb * block, np.int32)
    weights = np.zeros(nb * block, np.int32)
    items[:n], weights[:n] = stream[:, 0], stream[:, 1]
    return items.reshape(nb, block), weights.reshape(nb, block)


def initial_bank(spec, device):
    """The spec's empty state as an (R, k) bank (``_bank_of``)."""
    from repro_torch.sketch import api

    return _bank_of(api.make(spec, device))


def _router(spec, bank):
    """The router the spec's adapter routes a block with."""
    from repro_torch.sketch import bank as bk

    if spec.kind == "quantile":
        if spec.shards:
            return bk.ShardLevelRouter(spec.bits, spec.shards)
        return bk.DyadicLevelRouter(spec.bits)
    return bk.HashShardRouter(bank.ids.shape[0], spec.bits)


# Each path's kernel operands for one raw block (it, w) on the (R, k) bank.

def fused_path(spec, bank, it, w):
    from repro_torch.kernels.sketch_update.ops import prep_block

    padded, prep = prep_block(bank, *_router(spec, bank).route_dense(it, w),
                              spec.variant_id)
    return list(padded), list(prep)


def partition_path(spec, bank, it, w):
    """The ``"bank"`` backend's kernel-1 operands: the padded bank and the
    partition prep of the raw block."""
    from repro_torch.kernels.sketch_update.ops import prep_partition

    padded, prep = prep_partition(bank, it, w, _router(spec, bank),
                                  spec.variant_id)
    return list(padded), list(prep)


def banked_path(spec, bank, it, w):
    return banked_operands(bank, *_router(spec, bank).route_dense(it, w),
                           spec.variant_id)


def split_path(spec, bank, it, w):
    if spec.kind == "quantile":
        # the layers as stacked sketches, each with the shared weight row
        ri, rw = _router(spec, bank).route_dense(it, w)
        return split_operands(bank, ri, rw.expand(ri.shape), spec.variant_id,
                              True)
    if spec.shards:
        return split_operands(bank, *_router(spec, bank).route_dense(it, w),
                              spec.variant_id, True)
    return split_operands(bank, it[None], w[None], spec.variant_id, False)


def serial_path(spec, bank, it, w):
    return serial_operands(bank, it, w)


def serial_scan_path(spec, bank, it, w):
    """The ``"serial"`` backend's kernel-4 operands: the block's
    aggregated uniques in id order, EMPTY entries at weight 0."""
    import torch
    from repro_torch.sketch.blocks import _aggregate_block

    uids, net = _aggregate_block(it[None], w[None])
    return serial_operands(bank, uids[0],
                           torch.where(uids[0] == -1, 0, net[0]))


def _unpad(out, bank):
    from repro_torch.sketch.state import SketchState

    R, k = bank.ids.shape
    return SketchState(*(t.reshape(R, -1)[:, :k] for t in out))


def run_plain(spec, stream, block, device, path, plain, at=-1):
    """The same padded blocks through the path's framework side and the
    kernel's plain version in place of the kernel (or a kernel, which
    updates its operands in place). Returns the final bank, block
    ``at``'s kernel operands as they were before its update (the last
    block's by default) and the time."""
    import torch

    bank = initial_bank(spec, device)
    items, weights = padded_blocks(stream, block)
    at %= len(items)
    t0 = time.perf_counter()
    for b in range(len(items)):
        it = torch.as_tensor(items[b], device=device)
        w = torch.as_tensor(weights[b], device=device)
        st, args = path(spec, bank, it, w)
        if b == at:
            last = ([t.clone() for t in st], args)
        bank = _unpad(plain(*st, *args, variant=spec.variant_id), bank)
    torch.cuda.synchronize()
    return bank, last, time.perf_counter() - t0


def run_session(spec, stream, block, device):
    """Drive a session over the stream through the cached compiled
    ingest: the first block by ``ingest_block``, timed apart (where the
    spec's CUDA graph is not captured yet, it runs eagerly and the capture
    follows), the rest by ``StreamSession.ingest`` (the user's entry
    point: validation, chunking, padding). Returns the session, the
    seconds of the other blocks, and the first block's ms with the device
    memory it kept reserved (the graph's memory pool and its static
    buffers, where it captured), beside the host ms per block that
    ``ingest``'s validation of the other blocks takes alone (that call
    finds the session's positive mass at 0: the first block went in
    without validation) and takes against the first block's positive
    mass, as a later call on a session does (the per-item net check)."""
    import numpy as np
    import torch
    from repro_torch.sketch import api
    from repro_torch.sketch.session import StreamSession

    sess = StreamSession(spec, block=block, device=device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    sess.ingest_block(*(np.ascontiguousarray(stream[:block, j], np.int32)
                        for j in (0, 1)))
    torch.cuda.synchronize()
    first = dict(first_block_ms=(time.perf_counter() - t0) * 1e3,
                 first_block_reserved_mb=(torch.cuda.memory_reserved(device)
                                          - mem0) / 1e6)
    t0 = time.perf_counter()
    sess.ingest(stream[block:, 0], stream[block:, 1])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    # the host's share: ingest validates the whole call before its blocks
    rest = stream[block:]
    prior = api.validate_block(spec, stream[:block, 0], stream[:block, 1])
    for key, prior_mass in (("validate_ms_per_block", 0),
                            ("validate_prior_ms_per_block", prior)):
        t0 = time.perf_counter()
        api.validate_block(spec, rest[:, 0], rest[:, 1],
                           prior_mass=prior_mass)
        first[key] = ((time.perf_counter() - t0) * 1e3
                      / (sess.blocks_ingested - 1))
    return sess, secs, first


def check_launches(label, counts, name, blocks, layout=None) -> int:
    """``blocks`` launches of kernel ``name`` (on ``layout``, for kernels
    2 and 3) and none of another kernel or layout."""
    key = f"{name}[{layout}]" if layout else name
    others = {k: v for k, v in counts.items() if k != key and v}
    if counts[key] != blocks or blocks == 0 or others:
        raise SystemExit(f"{label}: {counts[key]} launches of {key} for "
                         f"{blocks} blocks; other kernels launched: {others}")
    return counts[key]


def check_truth(spec, bank, stream, device, factor):
    """Per-row error bound ``factor * I_row / k`` against the exact
    frequencies (factor 2: Thm 4, SS±; factor 1: Thm 2, Lazy); every item
    above its row's bound must be monitored. Returns (worst error over
    bound, number of items above their bound)."""
    import numpy as np
    import torch
    from repro_torch.sketch.bank import shard_of

    R, k = bank.ids.shape
    U = 1 << spec.bits
    items, signs = stream[:, 0], stream[:, 1]
    freq = np.bincount(items, weights=signs, minlength=U).astype(np.int64)
    ids = bank.ids.reshape(-1).cpu().numpy()
    counts = bank.counts.reshape(-1).cpu().numpy().astype(np.int64)
    live = ids >= 0
    if len(np.unique(ids[live])) != live.sum():
        raise SystemExit("an id is monitored by two slots")
    est = np.zeros(U, np.int64)
    est[ids[live]] = counts[live]
    owner = shard_of(torch.arange(U, device=device), R).long()
    ins_per_row = torch.zeros(R, dtype=torch.float64, device=device)
    ins_items = torch.as_tensor(items[signs > 0], device=device)
    ins_per_row.index_add_(0, owner[ins_items],
                           torch.ones(len(ins_items), dtype=torch.float64,
                                      device=device))
    # Thm 4 (SS±, k = 2 alpha / eps) and Thm 2 (Lazy, k = alpha / eps) with
    # each row's own alpha = I_row / |F_row|_1: eps * |F_row|_1 = factor *
    # I_row / k
    bound = factor * ins_per_row / k
    err = torch.as_tensor(np.abs(est - freq), device=device, dtype=torch.float64)
    worst = torch.zeros(R, dtype=torch.float64, device=device).scatter_reduce(
        0, owner, err, "amax")
    if bool((worst > bound).any()):
        r = int(torch.argmax(worst - bound))
        raise SystemExit(f"row {r}: error {float(worst[r])} > bound "
                         f"{float(bound[r])}")
    hot = torch.as_tensor(freq, device=device) > bound[owner]
    est_t = torch.as_tensor(est, device=device)
    if bool((hot & (est_t <= 0)).any()):
        raise SystemExit("an item above the error bound is not monitored")
    return float((worst / bound).max()), int(hot.sum())


def _same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def run_path(label, spec, stream, block, device, factor, kernel, path, plain,
             at=-1, layout=None, hold=None, kernel_fn=None):
    """One session run: ``StreamSession.ingest`` of the stream (through
    the captured ingest), its launches of ``kernel`` (one per block on
    ``layout``, no other kernel or layout), equality with the plain
    version's run, the error bound, and the read path. Where ``hold`` is
    below the run's blocks, the kernel (``kernel_fn``, by default the
    wrapper named ``kernel``) and the plain version run on the path's
    framework side over the first ``hold`` blocks instead, and must
    agree. Returns the run's record, block ``at``'s kernel operands (of
    the blocks the plain version ran) and the session. ``ms_per_block``
    leaves the first block out (``first_block_ms``: it may hold the
    capture)."""
    import torch
    from repro_torch.kernels.sketch_update import kernel as kernels

    reset_counts()
    sess, secs, first = run_session(spec, stream, block, device)
    launches = check_launches(label, read_counts(), kernel,
                              sess.blocks_ingested, layout)
    if device.type == "cuda" and sess._compiled.graph is None:
        raise SystemExit(f"{label}: the session did not run its CUDA graph")
    n = min(hold or sess.blocks_ingested, sess.blocks_ingested)
    bank, last, plain_secs = run_plain(spec, stream[:n * block], block,
                                       device, path, plain, at)
    live = _bank_of(sess.state)
    if n < sess.blocks_ingested:
        live_n, _, _ = run_plain(spec, stream[:n * block], block, device,
                                 path, kernel_fn or getattr(kernels, kernel))
    else:
        live_n = live
    if not _same(live_n, bank):
        raise SystemExit(f"{label}: the bank after {n} blocks differs from "
                         f"the plain version's")
    ratio, n_hot = check_truth(spec, live, stream, device, factor)
    # the user's read path agrees with the bank
    hot_ids, hot_counts = sess.topk(16)
    if not torch.equal(sess.query_many(hot_ids.cpu().numpy()), hot_counts):
        raise SystemExit(f"{label}: query_many disagrees with topk")
    rest = sess.blocks_ingested - 1
    out = dict(label=label, kernel=kernel, layout=layout,
               blocks=sess.blocks_ingested,
               launches=launches, events=len(stream), rows=live.ids.shape[0],
               k_per_row=live.ids.shape[1],
               ms_per_block=secs * 1e3 / rest,
               updates_per_s=(len(stream) - block) / secs, **first,
               plain_blocks=n, plain_ms_per_block=plain_secs * 1e3 / n,
               worst_err_over_bound=ratio, items_above_bound=n_hot)
    log(f"{label}: {json.dumps(out)}")
    return out, last, sess


def run_ops_path(label, spec, stream, block, device, factor, kernel, path,
                 update, plain=None, layout=None):
    """One run of an ``ops`` entry point, ``update(bank, it, w)``, over
    the padded blocks, staged on the card before the timed loop; checked
    as ``run_path`` checks a session run (the plain run only where
    ``plain`` is given)."""
    import torch

    bank = initial_bank(spec, device)
    items, weights = padded_blocks(stream, block)
    blocks = [(torch.as_tensor(i, device=device),
               torch.as_tensor(w, device=device))
              for i, w in zip(items, weights)]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it, w in blocks:
        before_last = bank
        bank = update(bank, it, w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    last = path(spec, before_last, *blocks[-1])
    launches = check_launches(label, read_counts(), kernel, len(blocks),
                              layout)
    out = dict(label=label, kernel=kernel, layout=layout, blocks=len(blocks),
               launches=launches, events=len(stream), rows=bank.ids.shape[0],
               k_per_row=bank.ids.shape[1],
               ms_per_block=secs * 1e3 / len(blocks),
               updates_per_s=len(stream) / secs)
    if plain is not None:
        want, _, plain_secs = run_plain(spec, stream, block, device, path,
                                        plain)
        if not _same(bank, want):
            raise SystemExit(f"{label}: the bank differs from the plain "
                             f"version's")
        out["plain_ms_per_block"] = plain_secs * 1e3 / len(blocks)
    out["worst_err_over_bound"], out["items_above_bound"] = check_truth(
        spec, bank, stream, device, factor)
    log(f"{label}: {json.dumps(out)}")
    return out, last, bank


def _bank_of(state):
    """The (R, k) bank of a state: R = 1 for a plain sketch, the shards
    or the layers, or the S * bits rows of a sharded quantile bank."""
    from repro_torch.sketch.state import SketchState

    if hasattr(state, "flat_bank"):
        return state.flat_bank
    if hasattr(state, "bank"):
        return state.bank
    return SketchState(*(t[None] for t in state))


def run_fed(label, stream, block, device, want, feed, layout="staged"):
    """``feed(items, weights)`` ingests the padded blocks (each a host
    array) and returns the (R, k) bank, which must equal ``want`` bit for
    bit, with one launch of kernel 1 per block on ``layout`` and no other
    kernel. Returns the run's record."""
    import torch

    items, weights = padded_blocks(stream, block)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = feed(items, weights)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = check_launches(label, read_counts(),
                              "sketch_update_kernel_fused", len(items),
                              layout)
    if not _same(bank, want):
        raise SystemExit(f"{label}: the bank differs from the main run's")
    out = dict(label=label, blocks=len(items), launches=launches,
               ms_per_block=secs * 1e3 / len(items))
    log(f"{label}: {json.dumps(out)}")
    return out


def feeder_phase(spec, stream, block, device, want) -> dict:
    """The main stream through ``BlockFeeder`` at depth 1 and 2 (pinned
    host slots, a copy stream) and through ``ops.sketch_block_update_stream``
    (the 64 blocks on the card, no host round trip between blocks): each
    bank equal to the main run's, one kernel-1 launch per block."""
    import torch
    from repro_torch.kernels.sketch_update.ops import \
        sketch_block_update_stream
    from repro_torch.sketch.session import BlockFeeder, StreamSession

    def fed(depth):
        def feed(items, weights):
            feeder = BlockFeeder(StreamSession(spec, block=block,
                                               device=device), depth=depth)
            for it, w in zip(items, weights):
                feeder.feed(it, w)
            return _bank_of(feeder.flush())
        return feed

    runs = {f"feeder depth={d}": run_fed(f"feeder depth={d}", stream, block,
                                         device, want, fed(d))
            for d in (1, 2)}

    def streamed(items, weights):
        bank = initial_bank(spec, device)
        its = torch.as_tensor(items, device=device)
        ws = torch.as_tensor(weights, device=device)
        log(f"stream operands on the card: {its.numel() + ws.numel():,} "
            f"int32 ({(its.numel() + ws.numel()) * 4 / 1e6:.1f} MB)")
        torch.cuda.synchronize()
        return sketch_block_update_stream(bank, its, ws, _router(spec, bank),
                                          spec.variant_id)

    runs["sketch_block_update_stream"] = run_fed(
        "sketch_block_update_stream", stream, block, device, want, streamed)
    return runs


# The bank phase: the reference's default backend (the partition core) on
# kernel 1, and the serial backend on kernel 4. Blocks held to the plain
# version where the plain chains are slow (a Python loop per eviction or
# per update on the card).
BANK_LAZY_PLAIN_BLOCKS = 4
BANK_A_PLAIN_BLOCKS = 8
SERIAL_API_PLAIN_BLOCKS = 2
SERIAL_SHARDED_BLOCKS = 2
SERIAL_QUANTILE_BLOCKS = 2


def api_run(label, spec, stream, block, device, kernel, per_block,
            layout=None):
    """``api.update`` over the padded blocks (each a host array, validated
    on the host as a user's call is), ``per_block`` launches of ``kernel``
    a block and no other kernel. Returns the record and the state."""
    import torch
    from repro_torch.sketch import api

    items, weights = padded_blocks(stream, block)
    state = api.make(spec, device)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it, w in zip(items, weights):
        state = api.update(spec, state, it, w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = check_launches(label, read_counts(), kernel,
                              per_block * len(items), layout)
    out = dict(label=label, kernel=kernel, layout=layout, blocks=len(items),
               launches=launches, ms_per_block=secs * 1e3 / len(items))
    log(f"{label}: {json.dumps(out)}")
    return out, state


def bank_phase(specs, streams, twins, block, device):
    """The ``"bank"`` backend (the partition core: one kernel-1 launch a
    block on the flat layout) through the captured ingest, on the specs
    and streams of its twins: main (``shards=128``, staged), lazy (k =
    2,000, through ``bank.update_single``) and path A's spec (the main
    spec unsharded: R = 1, K = 400,000, unstaged); each bank equal to its
    twin's (the ``kernel`` or ``block`` run's) and to the plain version
    over all blocks (lazy: the first BANK_LAZY_PLAIN_BLOCKS; path A's:
    the first BANK_A_PLAIN_BLOCKS). Then the ``"serial"`` backend:
    ``specs["serial"]`` through the captured ingest (kernel 4 over each
    block's aggregated uniques, its insert adds saturating), held to the
    plain version over SERIAL_API_PLAIN_BLOCKS blocks; the sharded
    serial oracle (``update_block_serial_reference``, one kernel-3
    launch per shard) at ``shards=8`` over SERIAL_SHARDED_BLOCKS blocks,
    equal to the ``"bank"`` path's; the quantile ``"serial"`` path at
    bits = 12 (one kernel-4 launch per layer; every layer holds its node
    universe, so no eviction reorders) equal to the quantile ``"bank"``
    path's. Returns (runs, each bank run's timed kernel operands)."""
    import dataclasses
    import functools

    import numpy as np
    from repro_torch.core.streams import bounded_stream
    from repro_torch.kernels.sketch_update import kernel, ref
    from repro_torch.sketch.api import SketchSpec

    fused, serial = "sketch_update_kernel_fused", "sketch_update_kernel_serial"
    runs, last = {}, {}
    plan = (("bank main", "bank sspm shards=128", "main", 2.0, None, -1),
            ("bank lazy", "bank lazy k=2000", "lazy", 1.0,
             BANK_LAZY_PLAIN_BLOCKS, 1),
            ("bank a", "bank sspm k=400000", "a", 2.0, BANK_A_PLAIN_BLOCKS,
             -1))
    for key, label, src, factor, hold, at in plan:
        spec = dataclasses.replace(specs[src], backend="bank")
        # kernel 1's layout for the bank padded to a LANES multiple
        layout = kernel.fused_layout(
            -(-initial_bank(spec, device).ids.shape[1] // 128) * 128)
        runs[key], last[key], sess = run_path(
            label, spec, streams[src], block, device, factor, fused,
            partition_path, ref.fused_update_ref, at=at, layout=layout,
            hold=hold)
        if not _same(_bank_of(sess.state), twins[src]):
            raise SystemExit(f"{label}: the bank differs from its "
                             f"{specs[src].backend} twin's")
    runs["serial api"], _, _ = run_path(
        "serial api sspm k=4000", specs["serial"], streams["serial"], block,
        device, 2.0, serial, serial_scan_path,
        functools.partial(ref.serial_update_ref, saturate=True),
        hold=SERIAL_API_PLAIN_BLOCKS,
        kernel_fn=functools.partial(kernel.sketch_update_kernel_serial,
                                    saturate=True))
    # the sharded oracle against the partition core
    sh = dataclasses.replace(specs["main"], shards=8, backend="serial")
    stream = streams["main"][:SERIAL_SHARDED_BLOCKS * block]
    R = -(-sh.capacity // sh.shards // 128)
    runs["serial sharded"], want = api_run(
        "serial sharded=8", sh, stream, block, device,
        "sketch_residual_kernel", sh.shards,
        kernel.residual_layout(R))
    K = -(-sh.capacity // sh.shards)
    runs["bank sharded"], got = api_run(
        "bank sharded=8", dataclasses.replace(sh, backend="bank"), stream,
        block, device, fused, 1, kernel.fused_layout(K))
    if not _same(want.bank, got.bank):
        raise SystemExit("the sharded serial oracle's bank differs from the "
                         "bank path's")
    runs["serial sharded"]["worst_err_over_bound"], _ = check_truth(
        sh, got.bank, stream, device, 2.0)
    # the quantile serial path against the quantile bank path
    q = SketchSpec(kind="quantile", bits=12, eps=1e-3, alpha=2.0,
                   backend="serial")
    stream = bounded_stream(SERIAL_QUANTILE_BLOCKS * block * 2 // 3, 0.5,
                            universe=1 << 12, skew=1.0, seed=9)
    runs["serial quantile"], want = api_run(
        "serial quantile bits=12", q, stream, block, device, serial,
        q.bits)
    K = max(q.layer_capacities())
    runs["bank quantile"], got = api_run(
        "bank quantile bits=12", dataclasses.replace(q, backend="bank"),
        stream, block, device, "sketch_residual_kernel_banked", 1,
        kernel.banked_layout(K))
    if not (_same(want.bank, got.bank) and int(want.mass) == int(got.mass)
            == int(np.asarray(stream[:, 1]).sum())):
        raise SystemExit("the quantile serial path's state differs from the "
                         "bank path's")
    return runs, last


def merge_phase(spec, main, stream, block, device, main_stream) -> dict:
    """The main session's bank merged with a bank of ``stream`` (the lazy
    run's) on the main spec, on the card and on CPU copies: equal bit for
    bit, and the merged bank holds the summed Thm 4 bound over both
    streams with every item above it monitored; ``consolidated()`` of the
    main session equals the CPU's consolidate."""
    import numpy as np
    import torch
    from repro_torch.sketch import api

    other, _, _ = run_session(spec, stream, block, device)
    cpu = lambda state: type(state)(bank=type(state.bank)(
        *(t.cpu() for t in state.bank)))
    t0 = time.perf_counter()
    merged = api.merge(spec, main.state, other.state)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) * 1e3
    want = api.merge(spec, cpu(main.state), cpu(other.state))
    if not _same([t.cpu() for t in merged.bank], want.bank):
        raise SystemExit("merge on the card differs from the CPU's")
    ratio, n_hot = check_truth(spec, merged.bank,
                               np.concatenate([main_stream, stream]),
                               device, 2.0)
    t0 = time.perf_counter()
    cons = main.consolidated()
    torch.cuda.synchronize()
    consolidate_ms = (time.perf_counter() - t0) * 1e3
    want = api.consolidate(spec, cpu(main.state))
    if not _same([t.cpu() for t in cons], want):
        raise SystemExit("consolidated() on the card differs from the CPU's")
    out = dict(merge_ms=merge_ms, consolidate_ms=consolidate_ms,
               merged_worst_err_over_bound=ratio,
               merged_items_above_bound=n_hot,
               consolidated_live=int((cons.ids >= 0).sum()))
    log(f"merge and consolidate: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 4, the quantile kind: Dyadic SpaceSaving± on kernels 1-3
# ---------------------------------------------------------------------------

Q_BITS = 24
QUANTILE_BLOCKS = 32          # the quantile sspm, block and bank runs
QUANTILE_LAZY_BLOCKS = 16
QUANTILE_SHARDED_BLOCKS = 8
# the sspm, lazy and sharded runs are held to the plain versions over all
# their blocks; the block and bank runs, whose banks must equal the sspm
# run's, over their first 8 (their plain chains cost 0.1-1 s a block at
# K = 96,000)
QUANTILE_PLAIN_BLOCKS = 8
RANK_POINTS = 4097
QUANTILE_QS = (0.0, *(i / 100 for i in range(1, 100)), 1.0)


def quantile_specs(bits=Q_BITS):
    """The quantile runs' specs: sspm, a value or latency monitor over a
    2^bits bucket universe at 0.1 % rank error in the paper's alpha = 2
    regime (§4.2 sizing: 96,000 counters a layer at bits = 24), on the
    ``kernel``, ``block`` and ``bank`` backends; lazy at eps = 1e-2; and
    the shard × level bank, 8 shards of the sspm sizing, on ``bank``."""
    import dataclasses

    from repro_torch.sketch.api import SketchSpec

    sspm = SketchSpec(kind="quantile", bits=bits, eps=1e-3, alpha=2.0,
                      variant="sspm", backend="kernel")
    return dict(sspm=sspm,
                lazy=dataclasses.replace(sspm, eps=1e-2, variant="lazy"),
                block=dataclasses.replace(sspm, backend="block"),
                bank=dataclasses.replace(sspm, backend="bank"),
                sharded=dataclasses.replace(sspm, shards=8, backend="bank"))


def check_layers(spec, bank, stream, device, factor):
    """Every (shard,) layer row of a quantile bank (``_bank_of``'s rows,
    row = s * bits + l) against the exact frequencies of ``x >> l``: each
    node's error within ``factor * I_row / k_l`` (Thm 4, SS±: factor 2;
    Thm 2, Lazy: 1; I_row the inserts whose level-l node the row owns,
    k_l the layer's live capacity, ``spec.layer_capacities()``), every
    node above it monitored, no node in two slots or in a row that does
    not own it. Returns (worst error over bound, nodes above bound)."""
    import torch
    from repro_torch.sketch.bank import shard_of

    bits, S = spec.bits, spec.shards or 1
    caps = spec.layer_capacities()
    items = torch.as_tensor(stream[:, 0], device=device).long()
    signs = torch.as_tensor(stream[:, 1], device=device).long()
    ins = signs > 0
    ids = bank.ids.reshape(S, bits, -1)
    counts = bank.counts.reshape(S, bits, -1).long()
    s_ids = torch.sort(ids, dim=-1).values
    if bool(((s_ids[..., 1:] == s_ids[..., :-1]) & (s_ids[..., 1:] >= 0))
            .any()):
        raise SystemExit("a node is monitored by two slots of a row")
    worst_ratio, n_hot = 0.0, 0
    for l in range(bits):
        U = 1 << (bits - l)
        nodes = items >> l
        freq = torch.zeros(U, dtype=torch.long, device=device).index_add_(
            0, nodes, signs)
        owner = shard_of(torch.arange(U, device=device), S).long()
        row_ids, row_counts = ids[:, l], counts[:, l]
        live = row_ids >= 0
        shard = torch.arange(S, device=device)[:, None].expand_as(row_ids)
        if bool((owner[row_ids[live].long()] != shard[live]).any()):
            raise SystemExit(f"layer {l}: a row monitors a node it does not "
                             f"own")
        est = torch.zeros(U, dtype=torch.long, device=device)
        est[row_ids[live].long()] = row_counts[live]
        ins_row = torch.zeros(S, dtype=torch.float64, device=device)
        ins_row.index_add_(0, owner[nodes[ins]], torch.ones(
            int(ins.sum()), dtype=torch.float64, device=device))
        bound = factor * ins_row / caps[l]
        err = (est - freq).abs().double()
        worst = torch.zeros(S, dtype=torch.float64, device=device)
        worst = worst.scatter_reduce(0, owner, err, "amax")
        if bool((worst > bound).any()):
            r = int(torch.argmax(worst - bound))
            raise SystemExit(f"layer {l}, shard {r}: error {float(worst[r])} "
                             f"> bound {float(bound[r])}")
        hot = freq.double() > bound[owner]
        if bool((hot & (est <= 0)).any()):
            raise SystemExit(f"layer {l}: a node above the error bound is "
                             f"not monitored")
        ratio = torch.where(bound > 0, worst / bound, 0.0)
        worst_ratio = max(worst_ratio, float(ratio.max()))
        n_hot += int(hot.sum())
    return worst_ratio, n_hot


def exact_ranks(stream, bits):
    """rank(x) = |{v <= x}| of the stream's final multiset, for every x in
    [0, 2^bits)."""
    import numpy as np

    freq = np.bincount(stream[:, 0], weights=stream[:, 1],
                       minlength=1 << bits)
    return np.cumsum(freq.astype(np.int64))


def rank_grid(cum, n=RANK_POINTS):
    """n query points: the live values' quantiles at n - 2 evenly spaced
    q (the smallest x with rank(x) >= q·|F|₁, at least the smallest live
    value), then 0 and the universe's last value."""
    import numpy as np

    mass = int(cum[-1])
    targets = np.maximum(np.linspace(0.0, 1.0, n - 2) * mass, 1)
    xs = np.minimum(np.searchsorted(cum, targets), len(cum) - 1)
    return np.concatenate([[0], xs, [len(cum) - 1]]).astype(np.int32)


def check_ranks(label, est, xs, cum, eps) -> float:
    """Every estimated rank within eps·|F|₁ of the exact one; returns the
    worst error over that bound."""
    import numpy as np

    limit = eps * int(cum[-1])
    err = np.abs(np.asarray(est, np.int64) - cum[xs])
    if (err > limit).any():
        i = int(np.argmax(err))
        raise SystemExit(f"{label}: rank({xs[i]}) = {est[i]}, exact "
                         f"{cum[xs[i]]}: off by {err[i]} > eps·|F|1 = "
                         f"{limit}")
    return float(err.max() / limit) if limit else 0.0


def check_quantiles(label, got, qs, cum, eps) -> None:
    """Each returned x_q within eps·|F|₁ in rank of its target q·|F|₁
    (formed in float32, as the sketch forms it): rank(x_q) >= target -
    eps·|F|₁ and rank(x_q - 1) < target + eps·|F|₁."""
    import numpy as np

    mass = int(cum[-1])
    limit = eps * mass
    targets = np.asarray(qs, np.float32) * np.float32(mass)
    for q, x, t in zip(qs, np.asarray(got, np.int64), targets.astype(float)):
        below = cum[x - 1] if x > 0 else 0
        if not (0 <= x < len(cum) and cum[x] >= t - limit
                and below < t + limit):
            raise SystemExit(f"{label}: quantile({q}) = {x} is not within "
                             f"eps·|F|1 = {limit} in rank of {t}")


def _state_to(state, device):
    """A quantile state's copy on ``device``."""
    from repro_torch.sketch.state import SketchState

    return type(state)(bank=SketchState(*(t.to(device) for t in state.bank)),
                       mass=state.mass.to(device))


def quantile_queries(label, spec, state, stream, device, reps=3) -> dict:
    """``rank_many`` on ``rank_grid``'s points and ``quantile_many`` at
    QUANTILE_QS, each within eps·|F|₁ of the exact ranks, each equal to
    the same query of a CPU copy of the state, and the rank check shown
    to reject a planted fault (one rank off by more than the bound).
    Times: ms per call, the median of ``reps``."""
    import numpy as np
    import torch
    from repro_torch.sketch import api

    cum = exact_ranks(stream, spec.bits)
    if int(state.mass) != int(cum[-1]):
        raise SystemExit(f"{label}: mass {int(state.mass)}, exact "
                         f"{int(cum[-1])}")
    xs = rank_grid(cum)
    out = {}
    for name, call, arg in (("rank_many", api.rank_many, xs),
                            ("quantile_many", api.quantile_many,
                             QUANTILE_QS)):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = call(spec, state, arg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        want = call(spec, _state_to(state, "cpu"), arg)
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"{label}: {name} on the card differs from the "
                             f"CPU's")
        out[f"{name}_ms"] = sorted(ms)[reps // 2]
        out[name] = got.cpu().numpy()
    eps = spec.eps
    out["rank_err_over_bound"] = check_ranks(label, out["rank_many"], xs, cum,
                                             eps)
    check_quantiles(label, out["quantile_many"], QUANTILE_QS, cum, eps)
    planted = out["rank_many"].astype(np.int64)
    mid = len(xs) // 2
    planted[mid] = cum[xs[mid]] + math.floor(eps * int(cum[-1])) + 1
    try:
        check_ranks(f"{label} (planted)", planted, xs, cum, eps)
    except SystemExit:
        pass
    else:
        raise SystemExit(f"{label}: the rank check let a planted fault pass")
    del out["rank_many"], out["quantile_many"]
    return dict(out, points=len(xs), qs=len(QUANTILE_QS),
                mass=int(cum[-1]))


def run_quantile(label, spec, stream, block, device, factor, kernel, path,
                 plain, layout, n_plain):
    """One quantile session run: ``StreamSession.ingest`` of the stream
    (through the captured ingest), one launch of ``kernel`` a block on
    ``layout`` and no other kernel or layout, the session's bank equal to
    the same blocks through the plain versions (or, where ``n_plain`` is
    below the run's blocks, the kernel and the plain versions on the
    path's framework side over the first ``n_plain`` blocks), and every
    layer's bound. Returns the record and the session."""
    from repro_torch.kernels.sketch_update import kernel as kernels

    reset_counts()
    sess, secs, first = run_session(spec, stream, block, device)
    launches = check_launches(label, read_counts(), kernel,
                              sess.blocks_ingested, layout)
    if device.type == "cuda" and sess._compiled.graph is None:
        raise SystemExit(f"{label}: the session did not run its CUDA graph")
    n = min(n_plain, sess.blocks_ingested)
    want, _, plain_secs = run_plain(spec, stream[:n * block], block, device,
                                    path, plain)
    if n == sess.blocks_ingested:
        got = _bank_of(sess.state)
    else:
        got, _, _ = run_plain(spec, stream[:n * block], block, device, path,
                              getattr(kernels, kernel))
    if not _same(got, want):
        raise SystemExit(f"{label}: the bank after {n} blocks differs from "
                         f"the plain versions'")
    bank = _bank_of(sess.state)
    ratio, n_hot = check_layers(spec, bank, stream, device, factor)
    rest = sess.blocks_ingested - 1
    out = dict(label=label, kernel=kernel, layout=layout,
               blocks=sess.blocks_ingested, launches=launches,
               events=len(stream), rows=bank.ids.shape[0],
               k_per_row=bank.ids.shape[1],
               live_counters=int((bank.ids != -2).sum()),
               bank_mb=3 * bank.ids.numel() * 4 / 1e6,
               ms_per_block=secs * 1e3 / rest,
               updates_per_s=(len(stream) - block) / secs, **first,
               plain_blocks=n, plain_ms_per_block=plain_secs * 1e3 / n,
               worst_err_over_bound=ratio, nodes_above_bound=n_hot)
    log(f"{label}: {json.dumps(out)}")
    return out, sess


def quantile_phase(specs, streams, block, device, hold=QUANTILE_PLAIN_BLOCKS):
    """The quantile runs (``quantile_specs``) on the streams ``main`` (the
    sspm, block, bank and stream runs), ``lazy`` and ``sharded``, each
    checked by ``run_quantile``, over all its blocks or (block and bank)
    its first ``hold``; the block and bank banks and the stream
    entry's (``ops.sketch_block_update_stream`` with a
    ``DyadicLevelRouter``) equal to the sspm run's, bit for bit; ranks
    and quantiles of the sspm, lazy and sharded states
    (``quantile_queries``); the sspm state merged with a state of the
    lazy stream on the sspm spec, on the card and on CPU copies (equal,
    and within the summed bound); ``consolidate`` of the sharded state
    equal to the CPU's. Returns (runs, extra records, each run's final
    (R, k) bank and its next block's raw items and weights for the
    kernel times)."""
    import torch
    from repro_torch.kernels.sketch_update import ref
    from repro_torch.kernels.sketch_update.ops import \
        sketch_block_update_stream
    from repro_torch.sketch import api

    fused, banked = "sketch_update_kernel_fused", \
        "sketch_residual_kernel_banked"
    split = "sketch_residual_kernel"
    every = 1 << 30
    plan = (
        ("sspm", "main", QUANTILE_BLOCKS, every, 2.0, fused, fused_path,
         ref.fused_update_ref),
        ("lazy", "lazy", QUANTILE_LAZY_BLOCKS, every, 1.0, fused, fused_path,
         ref.fused_update_ref),
        ("block", "main", QUANTILE_BLOCKS, hold, 2.0, split, split_path,
         ref.residual_phase),
        ("bank", "main", QUANTILE_BLOCKS, hold, 2.0, banked, banked_path,
         ref.residual_phase_banked),
        ("sharded", "sharded", QUANTILE_SHARDED_BLOCKS, every, 2.0, banked,
         banked_path, ref.residual_phase_banked),
    )
    from repro_torch.kernels.sketch_update import kernel as k_

    layouts = {fused: lambda R, K: k_.fused_layout(K),
               banked: lambda R, K: k_.banked_layout(K),
               split: lambda R, K: k_.residual_layout(-(-K // 128))}
    runs, sessions, finals, extra = {}, {}, {}, {}
    for name, src, n_blocks, n_plain, factor, kernel, path, plain in plan:
        spec = specs[name]
        stream = streams[src][:n_blocks * block]
        bank0 = initial_bank(spec, device)
        layout = layouts[kernel](*bank0.ids.shape)
        label = f"quantile {name}"
        runs[name], sessions[name] = run_quantile(
            label, spec, stream, block, device, factor, kernel, path, plain,
            layout, min(n_plain, n_blocks))
        bank = _bank_of(sessions[name].state)
        finals[name] = (type(bank)(*(t.clone() for t in bank)),
                        padded_blocks(streams[src][n_blocks * block:
                                                   (n_blocks + 1) * block],
                                      block))
        if name in ("block", "bank") and not _same(
                bank, _bank_of(sessions["sspm"].state)):
            raise SystemExit(f"{label}: the bank differs from the quantile "
                             f"sspm run's")
        if name in ("sspm", "lazy", "sharded"):
            extra[f"queries {name}"] = quantile_queries(
                label, spec, sessions[name].state, stream, device)
            log(f"{label} queries: {json.dumps(extra[f'queries {name}'])}")
    sspm = specs["sspm"]
    main = streams["main"][:QUANTILE_BLOCKS * block]

    def streamed(items, weights):
        bank = initial_bank(sspm, device)
        return sketch_block_update_stream(
            bank, torch.as_tensor(items, device=device),
            torch.as_tensor(weights, device=device), _router(sspm, bank),
            sspm.variant_id)

    extra["quantile stream"] = run_fed(
        "quantile sketch_block_update_stream", main, block, device,
        _bank_of(sessions["sspm"].state), streamed, runs["sspm"]["layout"])
    # merge: the sspm state and a state of the lazy stream on the sspm spec
    lazy_stream = streams["lazy"][:QUANTILE_LAZY_BLOCKS * block]
    other, _, _ = run_session(sspm, lazy_stream, block, device)
    a, b = sessions["sspm"].state, other.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged = api.merge(sspm, a, b)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) * 1e3
    want = api.merge(sspm, _state_to(a, "cpu"), _state_to(b, "cpu"))
    if not (_same(_state_to(merged, "cpu").bank, want.bank)
            and int(merged.mass) == int(want.mass)):
        raise SystemExit("quantile merge on the card differs from the CPU's")
    import numpy as np

    ratio, n_hot = check_layers(sspm, merged.bank,
                                np.concatenate([main, lazy_stream]), device,
                                2.0)
    sharded = sessions["sharded"]
    t0 = time.perf_counter()
    cons = sharded.consolidated()
    torch.cuda.synchronize()
    consolidate_ms = (time.perf_counter() - t0) * 1e3
    want = api.consolidate(specs["sharded"], _state_to(sharded.state, "cpu"))
    if not (_same(_state_to(cons, "cpu").bank, want.bank)
            and int(cons.mass) == int(want.mass)):
        raise SystemExit("quantile consolidate on the card differs from the "
                         "CPU's")
    extra["quantile merge"] = dict(
        merge_ms=merge_ms, merged_worst_err_over_bound=ratio,
        merged_nodes_above_bound=n_hot, consolidate_ms=consolidate_ms,
        consolidated_live=int((cons.bank.ids >= 0).sum()))
    log(f"quantile merge and consolidate: "
        f"{json.dumps(extra['quantile merge'])}")
    return runs, extra, finals


def quantile_times(specs, finals, device) -> dict:
    """Kernels 1-3 at the quantile runs' shapes, on each run's next block
    from its final bank (``time_kernel``: device ms, the plain version's
    ms, the bound, evictions and drain steps, us per eviction)."""
    import torch
    from repro_torch.kernels.sketch_update import kernel, ref

    grid = (
        ("sketch_update_kernel_fused sspm", "sspm", fused_path,
         kernel.sketch_update_kernel_fused, ref.fused_update_ref, fused_bound,
         10),
        ("sketch_update_kernel_fused lazy", "lazy", fused_path,
         kernel.sketch_update_kernel_fused, ref.fused_update_ref, fused_bound,
         10),
        ("sketch_residual_kernel block", "block", split_path,
         kernel.sketch_residual_kernel, ref.residual_phase, split_bound, 10),
        ("sketch_residual_kernel_banked bank", "bank", banked_path,
         kernel.sketch_residual_kernel_banked, ref.residual_phase_banked,
         banked_bound, 10),
        ("sketch_residual_kernel_banked sharded", "sharded", banked_path,
         kernel.sketch_residual_kernel_banked, ref.residual_phase_banked,
         banked_bound, 4),
    )
    out = {}
    for label, name, path, run, plain, bound, reps in grid:
        spec = specs[name]
        bank, (items, weights) = finals[name]
        it = torch.as_tensor(items[0], device=device)
        w = torch.as_tensor(weights[0], device=device)
        last = path(spec, bank, it, w)
        out[label] = time_kernel(run, plain, last, spec.variant_id, bound,
                                 reps, 1)
        out[label]["shape"] = list(last[0][0].shape)
        log(f"{label} at the quantile shapes: {json.dumps(out[label])}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: kernel times and their bounds
# ---------------------------------------------------------------------------

def _dev_us(event) -> float:
    """A profiler event's own device time in us (the attribute's name
    differs between torch versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def device_ms(call, st, reps) -> float:
    """Device ms per ``call(state)``, each on its own copy of ``st``: over
    ``reps`` calls, each kernel's mean time per launch on the card as the
    profiler sees it, summed over the kernels a call launches once each
    (a wrapper's launches, without the host's time between them). Means
    per launch, as the profiler may miss a window's first launch. A window
    in which it records no kernel is taken again, at most twice; after a
    third such window (the card's tracing has dropped whole windows on
    this machine), the median of ``device_span_ms`` over ``reps`` calls
    instead: CUDA events around each call, which also hold the device's
    gaps between a wrapper's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        copies = [[t.clone() for t in st] for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for c in copies:
                call(c)
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        if seen:
            return sum(_dev_us(e) / e.count for e in seen) / 1e3
    copies = iter([[t.clone() for t in st] for _ in range(reps + 1)])
    spans = device_span_ms(lambda: call(next(copies)), reps)
    log(f"device_ms: the profiler saw no kernel in 3 windows; CUDA events "
        f"instead: {spans}")
    return statistics.median(spans)


STREAM_ROUNDS = 5


def stream_ms(call, st, reps, rounds=STREAM_ROUNDS) -> list:
    """ms per ``call(state)`` from the host, ``rounds`` times: CUDA events
    around ``reps`` calls in a row, each on its own copy of ``st``, the
    host's time between calls included."""
    import torch

    out = []
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    for _ in range(rounds):
        copies = [[t.clone() for t in st] for _ in range(reps)]
        torch.cuda.synchronize()
        start.record()
        for c in copies:
            call(c)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def time_kernel(kernel, plain, last, variant, bound, reps, plain_reps):
    """Kernel and plain-version ms on a run's block, each launch on its
    own copy of the state (the kernel updates in place), beside the bound
    ``bound(state, args, out, variant) -> (bytes, ops)`` gives. ``ms`` is
    the kernel's device time (``device_ms``); ``stream_ms`` the median
    of ``stream_ms_rounds`` (``stream_ms``), which hold the wrapper's host
    time wherever that is the longer. For kernels 1-3, also the block's
    trips (``fused_trips``, ``trips``) and the us per eviction."""
    import torch

    st, args = last
    first = kernel(*(t.clone() for t in st), *args, variant=variant)  # warm-up
    rounds = stream_ms(lambda c: kernel(*c, *args, variant=variant), st, reps)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    ms = device_ms(lambda c: kernel(*c, *args, variant=variant), st, reps)
    if plain_reps > 1:
        plain(*st, *args, variant=variant)  # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(plain_reps):
        want = plain(*st, *args, variant=variant)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end) / plain_reps
    if not _same(want, first):
        raise SystemExit("a timed kernel launch differs from its plain version")
    nbytes, nops = bound(st, args, want, variant)
    by_bytes = nbytes / HBM_BYTES_PER_S >= nops / INT32_OPS_PER_S
    bound_s = max(nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S)
    out = dict(ms=ms, stream_ms=sorted(rounds)[len(rounds) // 2],
               stream_ms_rounds=rounds, plain_ms=plain_ms,
               bound_ms=bound_s * 1e3,
               bound_by="bytes" if by_bytes else "operations",
               bytes=nbytes, ops=nops)
    count = {fused_bound: fused_trips, banked_bound: trips,
             split_bound: trips}.get(bound)
    if count:
        out.update(count(st, args, want, variant))
        out["us_per_eviction"] = (ms * 1e3 / out["evictions"]
                                  if out["evictions"] else None)
    return out


def trips(st, args, out, variant) -> dict:
    """A residual block's work (kernels 2 and 3): its evictions and SS±
    drain steps (slots drained), in all and the most in one sketch or
    row."""
    start, n_ins = args[-3], args[-2]
    ev = (n_ins - start).clamp(min=0).long()
    drained = _spread_slots(st, out, variant)
    return dict(evictions=int(ev.sum()), max_evictions=int(ev.max()),
                drain_steps=int(drained.sum()),
                max_drain_steps=int(drained.max()))


def fused_trips(st, args, out, variant) -> dict:
    """Kernel 1's work on a block: its empty fills, unit inserts (the
    water-fill), non-unit evictions and SS± drain steps (slots drained),
    the evictions and drain steps also the most in one row."""
    i0, mu, nnu = args[3:6]
    ev = nnu.long()
    drained = _spread_slots(st, out, variant)
    return dict(fills=int(i0.sum()), unit_inserts=int(mu.sum()),
                evictions=int(ev.sum()), max_evictions=int(ev.max()),
                drain_steps=int(drained.sum()),
                max_drain_steps=int(drained.max()))


def fused_bound(bank, prep, out, variant):
    """Kernel 1 at the least, whatever an implementation keeps: every
    delta; a row's counts in full where the water-fill or an eviction
    must see them all (mu + nnu > 0), else the counts it changes or adds
    delta to; a row's ids in full where the empty fill must find its
    EMPTY slots (i0 > 0); a row's errors in full where the SS± drain
    must find the largest (w_del > 0); each changed element written
    once; the grouped (uid, net) entries used and the per-row scalars
    read once (four; five with the partition layout's offsets). One
    operation per slot read, one pass over a row
    for its water level and one for the placement (rows with unit
    inserts), and ``STEP_OPS`` per eviction and per drained slot. The
    evictions form one dependent chain per row: its latency, not this
    bound's rates, limits the kernel."""
    delta, h_uids, h_net, i0, mu, nnu, w_del = prep[:7]
    R, K = bank[0].shape
    changed = [a != b for a, b in zip(bank, out)]
    scans = (mu + nnu) > 0
    counts_read = (K * int(scans.sum())
                   + int(((changed[1] | (delta != 0)) & ~scans[:, None]).sum()))
    ids_read = K * int((i0 > 0).sum())
    errors_read = K * int((w_del > 0).sum()) if variant == 2 else 0
    reads = R * K + counts_read + ids_read + errors_read
    writes = sum(int(c.sum()) for c in changed)
    used = int((i0.long() + mu.long() + nnu.long()).sum())
    nbytes = 4 * (reads + writes + 2 * used + (len(prep) - 3) * R)
    steps = int(nnu.long().sum()) + int(_spread_slots(bank, out, variant).sum())
    return nbytes, reads + 2 * K * int((mu > 0).sum()) + STEP_OPS * steps


def _spread_slots(st, out, variant):
    """Per row: the slots the SS± spread drained (same id, smaller error)."""
    if variant != 2:
        return st[0].new_zeros(st[0].shape[0]).long()
    hit = (out[0] == st[0]) & (out[2] < st[2])
    return hit.reshape(hit.shape[0], -1).sum(dim=1)


# Operations per eviction and per drained slot at the least, whatever
# structures an implementation keeps (as ``serial_bound`` counts an
# update): a compare and an add.
STEP_OPS = 2


def banked_bound(st, args, out, variant):
    """Kernel 2 at the least: a row's counts in full where it evicts, its
    errors in full where it spreads; each changed element written once;
    the (uid, net) entries used and four scalars per row read once. One
    operation per slot read, and ``STEP_OPS`` per eviction and per
    drained slot. The evictions form one dependent chain per row: its
    latency, not this bound's rates, limits the kernel."""
    h_uids, h_net, uoff, start, n_ins, w_del = args
    R, K = st[0].shape
    ev = (n_ins - start).clamp(min=0).long()
    spread = _spread_slots(st, out, variant)
    writes = sum(int((a != b).sum()) for a, b in zip(st, out))
    reads = K * int((ev > 0).sum()) + K * int((spread > 0).sum())
    nbytes = 4 * (reads + writes + 2 * int(ev.sum()) + 4 * R)
    return nbytes, reads + STEP_OPS * int((ev + spread).sum())


def split_bound(st, args, out, variant):
    """Kernel 3 at the least: a sketch's ids and counts in full where it
    evicts (it needs its EMPTY slots and minima), its errors in full
    where it spreads; each changed element written once; the (uid, net)
    entries used and three scalars per sketch read once. One operation
    per slot read, and ``STEP_OPS`` per eviction and per drained slot.
    The evictions form one dependent chain per sketch: its latency, not
    this bound's rates, limits the kernel."""
    r_uids, r_net, start, n_ins, w_del = args
    E, R, lanes = st[0].shape
    n = R * lanes
    ev = (n_ins - start).clamp(min=0).long()
    spread = _spread_slots(st, out, variant)
    writes = sum(int((a != b).sum()) for a, b in zip(st, out))
    reads = 2 * n * int((ev > 0).sum()) + n * int((spread > 0).sum())
    nbytes = 4 * (reads + writes + 2 * int(ev.sum()) + 3 * E)
    return nbytes, reads + STEP_OPS * int((ev + spread).sum())


def serial_bound(st, args, out, variant):
    """Kernel 4 at the least, whatever structures an implementation keeps:
    the sketch read once, each changed element written once, the items
    and weights read once; two operations (a compare and an add) per
    update of nonzero weight. The updates form one dependent chain: its
    latency, not this bound's rates, limits the kernel."""
    items, weights = args
    n = st[0].numel()
    writes = sum(int((a != b).sum()) for a, b in zip(st, out))
    nbytes = 4 * (3 * n + writes + 2 * items.numel())
    return nbytes, 2 * int((weights != 0).sum())


def serial_paths(last, B):
    """Kernel 4 on three blocks of B updates from the serial run's last
    state (full), each block taking one path of the update: every item
    monitored (+1: a probe and a count's summaries), every item new (+1:
    an eviction of the minimum, the table and both summaries rewritten),
    every item an unmonitored deletion (-1: one SS± drain step while the
    errors last). Timed as ``time_kernel`` times, beside the bound; each
    held to the plain version on its first SERIAL_ITEMS updates (the
    plain version takes seconds per block)."""
    import torch
    from repro_torch.kernels.sketch_update import kernel, ref

    run = kernel.sketch_update_kernel_serial
    st, _ = last
    ids = st[0].flatten()
    g = torch.Generator(device=ids.device).manual_seed(7)
    held = ids[ids >= 0]
    fresh = (1 << 24) + torch.arange(2 * B, dtype=torch.int32,
                                     device=ids.device)  # outside the stream
    ones = torch.ones(B, dtype=torch.int32, device=ids.device)
    blocks = {
        "monitored": (held[torch.randint(len(held), (B,), generator=g,
                                         device=ids.device)], ones),
        "evicting": (fresh[:B].clone(), ones),
        "draining": (fresh[B:].clone(), -ones),
    }
    out = {}
    for name, args in blocks.items():
        head = tuple(a[:SERIAL_ITEMS] for a in args)
        if not _same(run(*(c.clone() for c in st), *head, variant=2),
                     ref.serial_update_ref(*st, *head, variant=2)):
            raise SystemExit(f"kernel 4 on the {name} block differs from "
                             "its plain version")
        copies = [[c.clone() for c in st] for _ in range(3)]
        got = run(*copies[0], *args, variant=2)  # warm-up
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        torch.cuda.synchronize()
        start.record()
        for c in copies[1:]:
            run(*c, *args, variant=2)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 2
        nbytes, nops = serial_bound(st, args, got, 2)
        out[name] = dict(ms=ms, us_per_update=ms * 1e3 / B, bound_ms=1e3 * max(
            nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S))
    # each deletion of weight 1 drains one unit: a step while errors last
    out["draining"]["drain_steps"] = int(st[2].sum() - got[2].sum())
    return out


def host_cuda_ms(events, n_blocks) -> dict:
    """Host ms per block in the CUDA runtime's calls, by call, from a
    profile's ``key_averages()`` (``cudaLaunchKernel``, ``cudaGraphLaunch``,
    ``cudaMemcpyAsync``, ``cudaStreamSynchronize``, ...), and their sum
    over the launches (``launch``)."""
    calls = {e.key: e.self_cpu_time_total / 1e3 / n_blocks for e in events
             if e.key.startswith("cuda") and e.self_cpu_time_total}
    calls = dict(sorted(calls.items(), key=lambda kv: -kv[1]))
    return dict(launch=sum(ms for key, ms in calls.items()
                           if "Launch" in key), calls=calls)


def profile_blocks(spec, block, n_blocks, seed, device, stream=None):
    """Profile ``n_blocks`` blocks (after one warm-up block) two ways, in
    one call: ``captured``, ``StreamSession.ingest_block`` (the cached CUDA
    graph, the pinned slot); ``eager``, ``api.adapter_for(spec).update``
    per block on a pageable copy of it, as the session ingested before
    the graph. Each: wall and device-busy ms per block, the idle share,
    the kernels and copies per block, the host's ms per block in the CUDA
    runtime's calls and the ops by device and host time; then the wall
    ms per block of the next ``n_blocks`` blocks with the profiler off.
    The blocks are ``make_stream``'s, or ``stream``'s (at least
    ``2 * n_blocks + 1`` blocks of it) where given."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sketch import api
    from repro_torch.sketch.session import StreamSession

    if stream is None:
        stream = make_stream(2 * n_blocks + 1, block, seed)
    items, weights = padded_blocks(stream, block)
    sess = StreamSession(spec, block=block, device=device)
    state = [api.make(spec, device)]

    def captured(b):
        sess.ingest_block(items[b], weights[b])

    def eager(b):
        state[0] = api.adapter_for(spec).update(
            spec, state[0], torch.as_tensor(items[b], device=device),
            torch.as_tensor(weights[b], device=device))

    out = {}
    for name, step in (("eager", eager), ("captured", captured)):
        step(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in range(1, n_blocks + 1):
                step(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the next blocks again without the profiler, whose tracing costs
        # the host time per kernel
        t0 = time.perf_counter()
        for b in range(n_blocks + 1, 2 * n_blocks + 1):
            step(b)
        torch.cuda.synchronize()
        unprofiled = time.perf_counter() - t0
        events = prof.key_averages()
        # device work = the kernels and copies themselves (an aten op's
        # own device time repeats its kernels')
        on_device = [e for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(_dev_us(e) for e in on_device)

        def top(evts, key):
            return [(e.key[:80], key(e) / 1e3 / n_blocks)
                    for e in sorted(evts, key=key, reverse=True)[:8]]

        out[name] = dict(
            blocks=n_blocks, wall_ms_per_block=wall * 1e3 / n_blocks,
            unprofiled_wall_ms_per_block=unprofiled * 1e3 / n_blocks,
            device_ops_per_block=sum(e.count for e in on_device) / n_blocks,
            # None where the profiler saw no device work (not measured)
            device_busy_ms_per_block=(busy_us / 1e3 / n_blocks
                                      if busy_us else None),
            device_idle_share=1.0 - busy_us / 1e6 / wall if busy_us else None,
            host_cuda_ms_per_block=host_cuda_ms(events, n_blocks),
            top_device_ms_per_block=top(on_device, _dev_us),
            top_host_ms_per_block=top(events, lambda e: e.self_cpu_time_total))
    for a, b in zip(_bank_of(sess.state), _bank_of(state[0])):
        if not torch.equal(a, b):
            raise SystemExit("the profiled eager and captured sessions "
                             "differ")
    return out


# ---------------------------------------------------------------------------
# The attention kernels (5 and 6): cases, the full-width runs, times
# ---------------------------------------------------------------------------

# Gemma3-27B (src/repro/configs/gemma3_27b.py:8): 32 q-heads on 16 kv-heads,
# hd 128, local layers of window 1,024, a heavy-hitter cache of 8,192 slots
# per global layer; bf16
GEMMA = dict(H=32, KV=16, hd=128, window=1024, budget=8192)
PREFILL = 4096          # one 4k prefill chunk
DECODE_BATCH = 8
VALID_SHARE = 0.9       # share of the decode cache's slots that are valid
# Attention outputs are also held row by row (a row: the hd values of one
# query and q-head): |got - want| <= ROUNDING·|want| + ROW_SHARE·RMS(row),
# so the limit scales with the output, which at Gemma3-27B's widths is
# ~0.02-0.05 per element. ROUNDING is one bf16 ulp (both sides round to
# bf16); ROW_SHARE allows the kernel's bf16 P in P·V (relative error
# 2^-9 per p: ~2^-10 of the row's RMS per element, ~2^-7.3 at the worst
# of 16 M elements) and stays below what one dropped 64-key tile or chunk
# changes (~0.1-0.2 of the row's RMS at 4,096 or 7,373 keys).
ROUNDING = 2.0**-7
ROW_SHARE = 2.0**-6

# B, S, T, H, KV, hd, causal, window: the reference's grid
# (tests/test_kernel_flash_attention.py:10), a ragged S = 96 (the
# kernel's tiles are 64 and 128 rows), T > S (sequence ends aligned), no
# mask, and hd = 30 (rows not 16-byte multiples: the scalar loads); then,
# for the wgmma path (bf16, hd 64, 128, 256), S = 130 and T = 300 (not
# multiples of its 128-row tiles) with G = 1, 2 and 4, causal, windowed
# and without a mask. f32 takes the f32 path, bf16 at another hd the mma
# path (flash_path).
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 256, 256, 8, 2, 128, True, 0),
    (1, 128, 128, 2, 1, 80, True, 32),
    (1, 64, 64, 1, 1, 16, True, 0),
    (2, 128, 128, 6, 3, 48, True, 0),
    (1, 96, 96, 4, 2, 64, True, 0),
    (2, 64, 128, 4, 2, 64, True, 0),
    (1, 192, 192, 4, 2, 128, False, 0),
    (1, 80, 80, 2, 1, 30, True, 16),
    (1, 130, 300, 4, 4, 64, True, 0),
    (1, 130, 300, 4, 2, 64, True, 40),
    (2, 130, 300, 8, 4, 128, True, 100),
    (1, 130, 300, 8, 2, 128, False, 0),
    (1, 130, 300, 4, 1, 256, True, 0),
    (1, 130, 300, 4, 2, 256, False, 0),
]
# B, KV, G, hd, C, row 0 empty: the reference's grid
# (tests/test_kernel_decode_attention.py:10) at 70 % valid slots, hd = 30
# (rows staged element by element), a row with no valid slot, then the
# layouts the other configs give kernel 6: C = 1,500 at G = 1 (Whisper),
# hd 112 at KV = 32 (Zamba2) and G = 7 (Qwen2)
DECODE_CASES = [
    (2, 2, 4, 64, 256, False),
    (1, 4, 2, 128, 512, False),
    (2, 1, 8, 80, 128, False),
    (3, 2, 1, 64, 64, False),
    (2, 2, 2, 30, 100, False),
    (2, 2, 2, 64, 128, True),
    (2, 16, 1, 64, 1500, False),
    (2, 32, 1, 112, 512, False),
    (2, 4, 7, 128, 700, True),
]


def _tol(dtype, f32, bf16):
    import torch

    return f32 if dtype == torch.float32 else bf16


def randn(shape, dtype, gen, device):
    """Standard normal values drawn in f32 from ``gen``, cast to dtype."""
    import torch

    return torch.randn(shape, generator=gen, device=device).to(dtype)


def close(label, got, want, atol, rtol) -> float:
    """Max abs error of ``got`` against ``want``; fatal beyond
    ``atol + rtol * |want|`` anywhere, or on a value that is not finite."""
    import torch

    err = (got.float() - want.float()).abs()
    worst = float(err.max())
    if bool((err > atol + rtol * want.float().abs()).any()) \
            or not bool(torch.isfinite(got.float()).all()):
        raise SystemExit(f"{label}: max_abs_err {worst} beyond atol {atol}, "
                         f"rtol {rtol}")
    return worst


def row_share(got, want) -> tuple:
    """(max abs error, the largest share of its row's RMS that an
    element's error takes beyond ROUNDING·|want|), over the last axis; an
    element of a zero row must be exact (share inf otherwise)."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    excess = (err - ROUNDING * want.abs()).clamp_min(0)
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt().expand_as(excess)
    share = torch.where(rms > 0, excess / rms,
                        torch.where(excess > 0, math.inf, 0.0))
    if not bool(torch.isfinite(got).all()):
        return math.inf, math.inf
    return float(err.max()), float(share.max())


def check_rows(label, got, want) -> tuple:
    """``row_share``, fatal above ROW_SHARE or on a value that is not
    finite."""
    err, share = row_share(got, want)
    if not share <= ROW_SHARE:
        raise SystemExit(f"{label}: an error takes {share} of its row's RMS "
                         f"beyond {ROUNDING}·|want| (limit {ROW_SHARE}); "
                         f"max_abs_err {err}")
    return err, share


def must_reject(label, wrong, want) -> float:
    """A planted wrong result must fail ``check_rows``: shows the row
    limit is tight enough to see that fault. Returns its share."""
    share = row_share(wrong, want)[1]
    if share <= ROW_SHARE:
        raise SystemExit(f"{label}: the row check passes a planted fault "
                         f"(share {share} <= {ROW_SHARE})")
    return share


def check_mass(label, mass, valid, heads) -> None:
    """The mass sums to KV·G on every row with a valid slot and is 0 on
    every other row."""
    import torch

    has = valid.any(dim=1)
    sums = mass.double().sum(dim=1)
    if not torch.allclose(sums[has], torch.full_like(sums[has], heads),
                          rtol=1e-4, atol=0.0) or bool((mass[~has] != 0).any()):
        raise SystemExit(f"{label}: the mass does not sum to {heads} per "
                         f"row: {sums.tolist()[:8]}")


def check_attention_cases(device) -> tuple:
    """Kernels 5 and 6 against their plain versions on the cases above,
    f32 and bf16: flash at atol = rtol = 2e-5 (f32) / 2e-2 (bf16), each
    case on the path ``flash_path`` names for its shape (the launch
    counters show it); decode ctx at 3e-5 / 3e-2, mass at atol 2e-5, rtol
    2e-4, and its sums; flash and ctx also row by row (``check_rows``).
    Returns the worst max abs error and the worst row share of each
    kernel, and the flash cases per path. Each kernel is launched
    through its torch op (``ops.op``), as the model calls it."""
    import torch
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel, flash_path)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=device).manual_seed(500)
    paths = dict.fromkeys(flash_attention_kernel.launches, 0)
    worst = {FLASH: 0.0, DECODE: 0.0}
    shares = {FLASH: 0.0, DECODE: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        tol = _tol(dtype, 2e-5, 2e-2)
        for B, S, T, H, KV, hd, causal, window in FLASH_CASES:
            q = randn((B, S, H, hd), dtype, gen, device)
            k = randn((B, T, KV, hd), dtype, gen, device)
            v = randn((B, T, KV, hd), dtype, gen, device)
            label = (f"{FLASH} vs plain [{name} B={B} S={S} T={T} H={H} "
                     f"KV={KV} hd={hd} causal={causal} window={window}]")
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            before = dict(flash_attention_kernel.launches)
            got = flash_ops.op(q, k, v, causal, window)
            torch.cuda.synchronize()
            path = flash_path(dtype, hd, True)
            ran = {p: n - before[p]
                   for p, n in flash_attention_kernel.launches.items()}
            if ran != {p: int(p == path) for p in ran}:
                raise SystemExit(f"{label}: launches {ran}, expected one "
                                 f"on the {path} path")
            paths[path] += 1
            err = close(label, got, want, tol, tol)
            share = check_rows(label, got, want)[1]
            log(f"{label}: {path} path, within {tol} (max_abs_err "
                f"{err:.3g}, row share {share:.3g})")
            worst[FLASH] = max(worst[FLASH], err)
            shares[FLASH] = max(shares[FLASH], share)
        tol = _tol(dtype, 3e-5, 3e-2)
        for B, KV, G, hd, C, empty_row in DECODE_CASES:
            q = randn((B, KV, G, hd), dtype, gen, device)
            k = randn((B, C, KV, hd), dtype, gen, device)
            v = randn((B, C, KV, hd), dtype, gen, device)
            valid = torch.rand((B, C), generator=gen, device=device) < 0.7
            if empty_row:
                valid[0] = False
            label = (f"{DECODE} vs plain [{name} B={B} KV={KV} G={G} hd={hd} "
                     f"C={C}{' row 0 empty' if empty_row else ''}]")
            want_ctx, want_mass = decode_attention_ref(q, k, v, valid)
            ctx, mass = decode_ops.op(q, k, v, valid)
            torch.cuda.synchronize()
            err = close(label + " ctx", ctx, want_ctx, tol, tol)
            share = check_rows(label + " ctx", ctx, want_ctx)[1]
            err_m = close(label + " mass", mass, want_mass, 2e-5, 2e-4)
            check_mass(label, mass, valid, KV * G)
            log(f"{label}: ctx within {tol} (max_abs_err {err:.3g}, row "
                f"share {share:.3g}), mass within 2e-5 + 2e-4 (max_abs_err "
                f"{err_m:.3g})")
            worst[DECODE] = max(worst[DECODE], err, err_m)
            shares[DECODE] = max(shares[DECODE], share)
    return worst, shares, paths


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn`` over ``reps`` calls after ``warmup``,
    with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, calls: int = 4) -> list:
    """The device kernels ``calls`` calls of ``fn`` run, longest first:
    (name cut to 100 characters, ms per launch, launches seen; the
    profiler may miss a window's first launch). Which backend a library
    call took, and where a kernel's passes spend their time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return [(e.key[:100], _dev_us(e) / 1e3 / max(e.count, 1), e.count)
            for e in sorted(events, key=_dev_us, reverse=True)[:4]]


def host_ms(fn, reps: int = 20) -> float:
    """The host's ms per call of ``fn``: ``reps`` calls back to back, the
    device not awaited (a wrapper's checks, allocations and launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return out


L2_FLUSH_BYTES = 64 << 20   # more than the H100's 50 MB L2
SLEEP_CYCLES = 2_000_000     # ~1 ms of device time, more than a call's host time


def l2_evict():
    """A function that reads 64 MB, evicting the L2 with clean lines."""
    import torch

    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    return lambda: flush.sum()


def device_span_ms(fn, calls: int = 10, cold: bool = False) -> list:
    """Device ms of each of ``calls`` calls of ``fn``, from its first
    launch's start to its last one's end: CUDA events recorded around
    the call behind a sleep kernel, so the host has enqueued the whole
    call before the device reaches it and its host time is not in the
    span. With ``cold``, ``l2_evict`` before each call."""
    import torch

    evict = l2_evict() if cold else (lambda: None)
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(calls):
        evict()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev = (torch.cuda.Event(True), torch.cuda.Event(True))
        ev[0].record()
        fn()
        ev[1].record()
        spans.append(ev)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in spans]


def decode_device_ms(fn, calls: int = 10, cold: bool = False) -> dict:
    """Kernel 6's device time over ``calls`` calls of ``fn``: per call the
    median of ``device_span_ms``; per launch, ms of each of its kernels
    (names with ``decode_``) from the profiler. With ``cold``, the L2 is evicted before each call (a read,
    so no dirty line is written back during the call), as a decode step
    does between layers: each reads its own cache."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spans = device_span_ms(fn, calls, cold)
    evict = l2_evict() if cold else (lambda: None)
    for _ in range(3):   # a window the profiler saw no kernel in, again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                evict()
                fn()
            torch.cuda.synchronize()
        seen = {e.key[:100]: (_dev_us(e) / 1e3 / e.count, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.count and "decode_" in e.key}
        if seen:
            return dict(per_call_ms=statistics.median(spans),
                        per_call_spans=spans, per_launch=seen, cold_l2=cold)
    # the card's tracing dropped three windows (see ``device_ms``): the
    # per-call times, from CUDA events, stand; per launch not measured
    log("decode_device_ms: the profiler saw no decode kernel in 3 windows; "
        "per launch not measured")
    return dict(per_call_ms=statistics.median(spans), per_call_spans=spans,
                per_launch=None, cold_l2=cold)


def sdpa(q, k, v, **kw):
    """``F.scaled_dot_product_attention`` with kv-heads shared by G
    q-heads: ``enable_gqa`` where the installed torch has it, else K and
    V expanded first (outside any timed region: returns the call)."""
    import torch.nn.functional as F

    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                      **kw)
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def bound(nbytes: int, flops: int) -> dict:
    by_bytes = nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
    return dict(bytes=nbytes, flops=flops,
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             flops / BF16_FLOPS_PER_S) * 1e3,
                bound_by="bytes" if by_bytes else "operations")


def flash_bound(q, k, causal, window) -> dict:
    """Least work: q, k, v read once and out written once; 4·hd FLOPs per
    allowed (q, k) pair per q-head (``ref.flash_flops``, which kernel 5's
    op counts too)."""
    from repro_torch.kernels.flash_attention.ref import (allowed_count,
                                                         flash_flops)

    B, S, H, hd = q.shape
    T = k.shape[1]
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return dict(pairs=allowed_count(S, T, causal, window),
                **bound(nbytes, flash_flops(B, S, T, H, hd, causal, window)))


def decode_bound(q, k, valid) -> dict:
    """Least work, from this run's mask: q, valid and the K and V rows of
    the valid slots read once, ctx and the f32 mass written once; 4·hd
    FLOPs per valid slot per q-head (``ref.decode_flops``, which kernel
    6's op counts too)."""
    from repro_torch.kernels.decode_attention.ref import decode_flops

    B, KV, G, hd = q.shape
    n_valid = int(valid.sum())
    esize = q.element_size()
    nbytes = (esize * (2 * q.numel() + 2 * n_valid * KV * hd)
              + valid.numel() + 4 * valid.numel())
    return dict(valid_slots=n_valid,
                **bound(nbytes, decode_flops(n_valid, KV, G, hd)))


def attention_inputs(device, seed):
    """The full-width operands at Gemma3-27B's widths, bf16, from ``seed``:
    one 4k prefill chunk (B = 1, S = T = 4,096) and a decode step of B = 8
    over the 8,192-slot heavy-hitter cache, 90 % of its slots valid."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    H, KV, hd = GEMMA["H"], GEMMA["KV"], GEMMA["hd"]
    bf16 = torch.bfloat16
    flash = (randn((1, PREFILL, H, hd), bf16, gen, device),
             randn((1, PREFILL, KV, hd), bf16, gen, device),
             randn((1, PREFILL, KV, hd), bf16, gen, device))
    C, B = GEMMA["budget"], DECODE_BATCH
    decode = (randn((B, KV, H // KV, hd), bf16, gen, device),
              randn((B, C, KV, hd), bf16, gen, device),
              randn((B, C, KV, hd), bf16, gen, device),
              torch.rand((B, C), generator=gen, device=device) < VALID_SHARE)
    return flash, decode


def _swap_heads(t, dim):
    """``t`` with kv-heads 0 and 1 swapped along ``dim``."""
    import torch

    perm = list(range(t.shape[dim]))
    perm[0], perm[1] = 1, 0
    return t.index_select(dim, torch.tensor(perm, device=t.device))


def _planted(k, v, drop):
    """The wrong operands ``planted_flash`` and ``planted_decode`` run:
    keys or slots 64-127 (half of one of the wgmma kernel's 128-key
    tiles, one of the decode kernel's chunks; the upper half of the
    first min(128, T) where T is shorter) dropped from P·V, and, with two
    kv-heads or more, q-heads of kv-heads 0 and 1 reading each other's."""
    hi = min(128, k.shape[1])
    v_tile = v.clone()
    v_tile[:, hi // 2:hi] = 0
    wrong = {drop: (k, v_tile)}
    if k.shape[2] > 1:
        wrong["wrong kv-head"] = (_swap_heads(k, 2), _swap_heads(v, 2))
    return wrong


def planted_flash(label, q, k, v, window, want, causal=True) -> dict:
    """The plain version with one fault planted (``_planted``), each of
    which the row check must reject."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    return {name: must_reject(f"{label} planted {name}", flash_attention_ref(
                q, kk, vv, causal=causal, window=window), want)
            for name, (kk, vv) in _planted(k, v, "kv tile dropped").items()}


def planted_decode(label, q, k, v, valid, want_ctx) -> dict:
    """As ``planted_flash`` for the decode context."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    return {name: must_reject(f"{label} planted {name}", decode_attention_ref(
                q, kk, vv, valid)[0], want_ctx)
            for name, (kk, vv) in _planted(k, v, "chunk dropped").items()}


def attention_phase(device, seed=6) -> tuple:
    """The attention path at Gemma3-27B's widths through the entry points
    ``flash_attention`` (global: causal; local: window 1,024) and
    ``decode_attention`` (the heavy-hitter cache), with every launch
    counter reset before and read after: each kernel launched once per
    call, no other kernel. Then each result against its plain version,
    two decode launches bit-equal, and the times: kernel, plain, bound,
    and one SDPA call. Returns (the kernels line's entries, a summary)."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import (allowed_pairs,
                                                         flash_attention_ref)

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    torch.backends.cudnn.allow_tf32 = False         # run in true f32
    t0 = time.perf_counter()
    worst, case_shares, case_paths = check_attention_cases(device)
    log(f"attention kernels vs plain: {2 * len(FLASH_CASES)} flash (by "
        f"path {case_paths}) and {2 * len(DECODE_CASES)} decode cases "
        f"within tolerance ({time.perf_counter() - t0:.1f} s)")

    (q, k, v), (dq, dk, dv, valid) = attention_inputs(device, seed)
    window = GEMMA["window"]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_global = flash_attention(q, k, v, causal=True, window=0)
    out_local = flash_attention(q, k, v, causal=True, window=window)
    ctx, mass = decode_attention(dq, dk, dv, valid)
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    wgmma = f"{FLASH}[wgmma]"
    want = {wgmma: 2, DECODE: 1}
    if any(n != want.get(name, 0) for name, n in counts.items()):
        raise SystemExit(f"attention path: launches {counts}, expected {want}")
    log(f"attention path (flash global, flash local, decode hh): {path_ms:.3f}"
        f" ms wall, launches {want}")

    runs = {}
    specs = (("flash global", 0, out_global), ("flash local", window,
                                               out_local))
    for label, win, out in specs:
        plain = lambda: flash_attention_ref(q, k, v, causal=True, window=win)
        want = plain()
        err, share = check_rows(label, out, want)
        planted = planted_flash(label, q, k, v, win, want)
        kern = lambda: flash_attention_kernel(q, k, v, causal=True, window=win)
        # the mma.sync kernel the wgmma one replaced at these widths, timed
        # beside it (outside the counted run)
        out_mma = torch.empty_like(q)
        mma = lambda: fa._launch("mma", q, k, v, out_mma, True, win)
        mma()
        mma_share = check_rows(label + " (mma path)", out_mma, want)[1]
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if win:
            mask = allowed_pairs(PREFILL, PREFILL, True, win, device)
            lib = sdpa(qh, kh, vh, attn_mask=mask)
        else:
            lib = sdpa(qh, kh, vh, is_causal=True)
        lib_err = float((lib().transpose(1, 2).float() - out.float())
                        .abs().max())
        runs[label] = dict(
            shape=dict(B=1, S=PREFILL, T=PREFILL, H=GEMMA["H"],
                       KV=GEMMA["KV"], hd=GEMMA["hd"], window=win,
                       dtype="bfloat16"),
            path="wgmma", max_abs_err=err, row_share=share,
            row_share_limit=ROW_SHARE, planted_row_shares=planted,
            ms=time_ms(kern, 20), kernel_device_ms=device_kernels(kern),
            mma_path_ms=time_ms(mma, 20), mma_path_row_share=mma_share,
            plain_ms=time_ms(plain, 3),
            library_ms=time_ms(lib, 20), library_kernels=device_kernels(lib),
            library_max_abs_diff=lib_err,
            **flash_bound(q, k, True, win))
        del qh, kh, vh, lib, want, out_mma
        log(f"{label}: {json.dumps(runs[label])}")
        torch.cuda.empty_cache()

    label = "decode hh"
    want_ctx, want_mass = decode_attention_ref(dq, dk, dv, valid)
    err, share = check_rows(label + " ctx", ctx, want_ctx)
    err = max(err, close(label + " mass", mass, want_mass, 2e-5, 2e-4))
    check_mass(label, mass, valid, GEMMA["H"])
    planted = planted_decode(label, dq, dk, dv, valid, want_ctx)
    again = decode_attention_kernel(dq, dk, dv, valid)
    if not (torch.equal(again[0], ctx) and torch.equal(again[1], mass)):
        raise SystemExit("decode hh: two launches on the same inputs differ")
    B, KV, G, hd = dq.shape
    qh = dq.reshape(B, KV * G, 1, hd)
    kh, vh = (t.transpose(1, 2).contiguous() for t in (dk, dv))
    lib = sdpa(qh, kh, vh, attn_mask=valid[:, None, None, :])
    lib_err = float((lib().reshape(ctx.shape).float() - ctx.float())
                    .abs().max())
    runs[label] = dict(
        shape=dict(B=B, C=GEMMA["budget"], KV=KV, G=G, hd=hd,
                   valid_share=VALID_SHARE, dtype="bfloat16"),
        max_abs_err=err, row_share=share, row_share_limit=ROW_SHARE,
        planted_row_shares=planted, mass_bit_equal_across_launches=True,
        ms=time_ms(lambda: decode_attention_kernel(dq, dk, dv, valid), 20),
        kernel_device_ms=device_kernels(
            lambda: decode_attention_kernel(dq, dk, dv, valid)),
        device_ms=decode_device_ms(
            lambda: decode_attention_kernel(dq, dk, dv, valid)),
        device_ms_cold=decode_device_ms(
            lambda: decode_attention_kernel(dq, dk, dv, valid), cold=True),
        host_ms_per_call=host_ms(
            lambda: decode_attention_kernel(dq, dk, dv, valid)),
        plain_ms=time_ms(lambda: decode_attention_ref(dq, dk, dv, valid), 3),
        library_ms=time_ms(lib, 20), library_kernels=device_kernels(lib),
        library_max_abs_diff=lib_err, library_computes="ctx only, no mass",
        **decode_bound(dq, dk, valid))
    log(f"{label}: {json.dumps(runs[label])}")

    root = "src/repro_torch/kernels"
    entries = []
    for name, counter, run, src, ref in (
            (FLASH, wgmma, runs["flash global"], "flash_attention/csrc/"
             "flash_wgmma.cu", "flash_attention/kernel.py:82"),
            (DECODE, DECODE, runs["decode hh"], "decode_attention/csrc/"
             "decode_attention.cu", "decode_attention/kernel.py:61")):
        entries.append({
            "name": name, "route": "cuda", "source": f"{root}/{src}",
            "replaces": f"src/repro/kernels/{ref}",
            "launches": counts[counter],
            "max_abs_err": max(worst[name], run["max_abs_err"]),
            "ms": run["ms"], "plain_ms": run["plain_ms"],
            "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
            "library_ms": run["library_ms"]})
    # flash's paths by name: the path's launches in the counted run (the
    # mma and f32 paths take the shapes the wgmma kernel does not)
    entries[0].update(path="wgmma", launches_by_path={
        path: counts[f"{FLASH}[{path}]"] for path in fa.PATHS})
    return entries, dict(case_max_abs_err=worst, case_row_share=case_shares,
                         case_paths=case_paths, path_wall_ms=path_ms,
                         runs=runs)


# ---------------------------------------------------------------------------
# The model phase: the model stack and model serving on kernels 5 and 6
# ---------------------------------------------------------------------------

# The main serving run: Gemma3-27B (src/repro_torch/configs/gemma3_27b.py
# FULL) at full width, depth cut to one period (5 local + 1 global layers),
# random bf16 weights from a seed; B = 2 requests of 8,192-token prompts,
# 32 greedy tokens each, at a 131,072-token context, where the global
# layer's cache is the SS± heavy-hitter cache of 8,192 slots (the prompt
# fills it, so every step evicts) and the counts halve every 16 steps
MODEL_MAIN = dict(arch="gemma3_27b", batch=2, prompt=8192, new_tokens=32,
                  context=131_072, decay_period=16, seed=23, heavy=16)
# the reference's serving invariant (tests/test_serve.py:24) at the same
# width: a 1,024-token prompt, context 4,096 (dense caches)
MODEL_STEPWISE = dict(batch=2, prompt=1024, context=4096, seed=24)
# the other nine configs, one period each at full width: prompt tokens
# (a multiple of the SSD chunk of 256 for the SSM families; LLaVA's 320
# text tokens follow its 2,880 vision tokens, 3,200 <= its window) and
# the context (Zamba2 past HH_ENGAGE_CTX: its shared block's SS± cache)
MODEL_OTHERS = {
    "mixtral_8x7b": (512, 1024), "olmoe_1b_7b": (512, 1024),
    "zamba2_7b": (512, 131_072), "whisper_medium": (256, 1024),
    "mamba2_780m": (512, 1024), "llava_next_mistral_7b": (320, 4096),
    "nemotron_4_15b": (512, 1024), "qwen2_7b": (512, 1024),
    "qwen3_0_6b": (512, 1024)}
MODEL_OTHER_TOKENS = 4
# Logits of the kernel run are held row by row (a row: one request's
# vocabulary at one step) to its plain twin: |got - want| <=
# LOGIT_ROUNDING·|want| + LOGIT_SHARE·RMS(row). Both runs keep a bf16
# residual stream; the kernels' bf16 P in P·V moves an attention output by
# ~2^-9 of its RMS, which the bf16 residual rounds into whole ulps of some
# elements, layer after layer; the share allows that and stays below what
# the other request's row gives (``must_reject``, swapped rows).
LOGIT_ROUNDING = 2.0**-7
LOGIT_SHARE = 2.0**-4
# the SS± caches of the kernel run and its twin: ids in common per row
# (a tie broken the other way by a rounding of the mass evicts another
# slot), and counts on common ids within one quantum a step
HH_OVERLAP = 0.99


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def one_period(cfg):
    """``cfg`` cut to one period of its layer pattern (Whisper: one
    encoder and one decoder layer): the depth cut of the model phase."""
    import dataclasses

    pattern, _, _ = cfg.layer_pattern()
    return dataclasses.replace(cfg, num_layers=len(pattern),
                               encoder_layers=min(cfg.encoder_layers, 1))


def expected_masks(cfg) -> dict:
    """Kernel-5 calls of one prefill of ``cfg`` by mask: windowed for the
    swa/local layers, causal for the others' self-attention, unmasked for
    the encoder and Whisper's cross-attention."""
    from repro_torch.models.transformer import _kinds

    _, n, _ = cfg.layer_pattern()
    kinds, rem_kinds = _kinds(cfg)
    out = dict(windowed=0, causal=0, unmasked=cfg.encoder_layers)
    for k in kinds * n + rem_kinds:
        if k in ("swa", "local"):
            out["windowed"] += 1
        elif k != "mamba":
            out["causal"] += 1
            out["unmasked"] += k == "decoder_x"
    return out


def attention_calls(cfg) -> tuple:
    """(kernel-5 launches a prefill, kernel-6 launches a decode step) of
    ``cfg``: a prefill's calls by mask (``expected_masks``), of which all
    but the encoder's recur in every decode step."""
    n = sum(expected_masks(cfg).values())
    return n, n - cfg.encoder_layers


class AttentionSpy:
    """While open: counts the model's prefill attention calls by mask
    (``layers._attend_local``: windowed, causal, unmasked) and the plain
    versions' calls, and keeps the first operands of each kind (flash by
    mask and shape, decode by cache length) for ``hold_kept`` and the
    timings at serving shapes. It reads the layers' local functions, the
    ones a mesh run calls on each rank's shards, so kept operands are a
    rank's plain tensors in a mesh run too."""

    def __init__(self, keep=False):
        self.keep = keep

    def __enter__(self):
        from repro_torch.models import layers as L

        self.L = L
        self.saved = (L._attend_local, L._decode_attend_local,
                      L.flash_attention_ref, L.decode_attention_ref)
        attend, decode_attend, fref, dref = self.saved
        self.masks = dict(windowed=0, causal=0, unmasked=0)
        self.plain = dict(flash=0, decode=0)
        self.operands = {}

        def spy_attend(q, k, v, causal, window, attention):
            mask = "windowed" if window else "causal" if causal else "unmasked"
            self.masks[mask] += 1
            key = f"{mask} S={q.shape[1]} T={k.shape[1]}"
            if self.keep and key not in self.operands:
                self.operands[key] = (q, k, v, causal, window)
            return attend(q, k, v, causal, window, attention)

        def spy_decode(q, k, v, valid, attention="kernel"):
            key = f"decode C={k.shape[1]}"
            if self.keep and key not in self.operands:
                self.operands[key] = (q, k, v, valid)
            return decode_attend(q, k, v, valid, attention)

        def count(name, fn):
            def run(*a, **kw):
                self.plain[name] += 1
                return fn(*a, **kw)
            return run

        L._attend_local, L._decode_attend_local = spy_attend, spy_decode
        L.flash_attention_ref = count("flash", fref)
        L.decode_attention_ref = count("decode", dref)
        return self

    def __exit__(self, *exc):
        L = self.L
        (L._attend_local, L._decode_attend_local, L.flash_attention_ref,
         L.decode_attention_ref) = self.saved


def check_model_launches(label, counts, flash, decode, spy, plain=False):
    """``flash`` launches of kernel 5 and ``decode`` of kernel 6 (by the
    counters) and no other kernel, no plain version; or, for a plain
    twin, no kernel at all and the plain versions instead. Returns
    kernel 5's launches by path."""
    fl = {k.split("[")[1][:-1]: n for k, n in counts.items()
          if k.startswith(FLASH) and n}
    others = {k: n for k, n in counts.items()
              if n and not k.startswith(FLASH) and k != DECODE}
    if plain:
        if any(counts.values()) or spy.plain != dict(flash=flash,
                                                     decode=decode):
            raise SystemExit(f"{label}: the plain twin launched {counts}; "
                             f"plain calls {spy.plain}, expected {flash} "
                             f"flash and {decode} decode")
        return fl
    if sum(fl.values()) != flash or counts[DECODE] != decode or others \
            or any(spy.plain.values()):
        raise SystemExit(f"{label}: launches {counts}, plain calls "
                         f"{spy.plain}; expected {flash} of {FLASH}, "
                         f"{decode} of {DECODE}, no other kernel, no plain "
                         f"version")
    return fl


def hold_kept(label, operands) -> dict:
    """Kernels 5 and 6 against their plain versions on the operands a run
    gave them (``AttentionSpy(keep=True)``), through the layers' dispatch
    (``_attend``, ``decode_attend``) under "kernel" and "plain": flash
    output and decode ctx row by row (``check_rows``; flash one request
    at a time, the plain version's (S, T) f32 scores), the decode mass
    within atol 2e-5, rtol 2e-4 and its sums (``check_mass``), and one
    fault per shape planted in the plain version that the row check must
    reject (``planted_flash``, ``planted_decode``, on request 0). The
    serving run's own logits see few of these rows: a prefill's last
    token only, and a decode cache's K/V are projections, not attention
    output. Returns the record of each kept key."""
    import torch
    from repro_torch.models import layers as L

    out = {}
    for key, ops in operands.items():
        name = f"{label} {key} kernel vs plain"
        if key.startswith("decode"):
            q, k, v, valid = ops
            dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                     v.dtype)
            q, k, v = (t.to(dt) for t in (q, k, v))
            ctx, mass = L.decode_attend(q, k, v, valid, "kernel")
            want_ctx, want_mass = L.decode_attend(q, k, v, valid, "plain")
            err, share = check_rows(name + " ctx", ctx, want_ctx)
            rec = dict(max_abs_err=err, row_share=share,
                       mass_max_abs_err=close(name + " mass", mass, want_mass,
                                              2e-5, 2e-4))
            check_mass(name, mass, valid, q.shape[1] * q.shape[2])
            rec["planted_row_shares"] = planted_decode(name, q, k, v, valid,
                                                       want_ctx)
            del ctx, mass, want_ctx, want_mass
        else:
            q, k, v, causal, window = ops
            got = L._attend(q, k, v, causal, window, "kernel")
            errs, shares = [], []
            for b in range(q.shape[0]):
                one = (t[b:b + 1] for t in (q, k, v))
                want = L._attend(*one, causal, window, "plain")
                err, share = check_rows(f"{name} request {b}", got[b:b + 1],
                                        want)
                errs.append(err)
                shares.append(share)
                if b == 0:
                    planted = planted_flash(name, q[:1], k[:1], v[:1], window,
                                            want, causal)
                del want
            rec = dict(max_abs_err=max(errs), row_share=max(shares),
                       planted_row_shares=planted)
            del got
        rec["row_share_limit"] = ROW_SHARE
        out[key] = rec
        log(f"{name}: {json.dumps(rec)}")
    return out


def logit_share(got, want) -> tuple:
    """(max abs error, the largest share of its row's RMS an element's
    error takes beyond LOGIT_ROUNDING·|want|), rows on the last axis."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    excess = (err - LOGIT_ROUNDING * want.abs()).clamp_min(0)
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    if not bool(torch.isfinite(got).all()):
        return math.inf, math.inf
    return float(err.max()), float((excess / rms).max())


def model_inputs(cfg, batch, prompt, device, seed):
    """Prompt tokens (and Whisper's frames, LLaVA's patch embeddings,
    standard normal bf16) from ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=device, dtype=torch.int32)
    kw = {}
    if cfg.vision_tokens:
        kw["vision"] = randn((batch, cfg.vision_tokens, cfg.d_model),
                             torch.bfloat16, gen, device)
    if cfg.family == "encdec":
        kw["frames"] = randn((batch, cfg.encoder_frames, cfg.d_model),
                             torch.bfloat16, gen, device)
    return toks, kw


def twin_logits(cfg, params, context, decay_period, toks, kw, generated,
                rows, device):
    """The plain twin on the card, teacher-forced: the prompt rows
    ``rows`` through ``attention="plain"`` prefill, then the kernel run's
    ``generated`` tokens (B, T) one step at a time, the tokens the
    engine fed its steps. Returns (logits (T+1) x (len(rows), V), the
    final cache)."""
    from repro_torch.serve import build_prefill_step, build_serve_step

    prefill = build_prefill_step(cfg, context, attention="plain",
                                 device=device)
    step = build_serve_step(cfg, context, decay_period, attention="plain",
                            device=device)
    batch = {"tokens": toks[rows]}
    batch.update({k: v[rows] for k, v in kw.items()})
    logits, cache = prefill(params, batch)
    out = [logits[:, -1]]
    for t in range(generated.shape[1]):
        logits, cache, _ = step(params, cache, generated[rows, t:t + 1])
        out.append(logits[:, -1])
    return out, cache


def hh_entry_of(cache, cfg):
    """The SS± entry of the model's first hh layer (period 0)."""
    for pos, entry in cache["periods"].items():
        entry = entry.get("attn", entry)
        if "ids" in entry:
            return {k: v[0] for k, v in entry.items()}
    raise SystemExit(f"{cfg.name}: no SS± cache in the decode cache")


def check_hh(label, entry, pos, prompt, twin, steps, heavy) -> dict:
    """The SS± invariants of the kernel run's heavy-hitter cache: ids
    unique per row and EMPTY or a position < pos; counts >= 0; 0 <= errors
    <= counts; and against the plain twin's cache (``twin``, rows in
    order): at least HH_OVERLAP of the ids in common per row, counts on
    common ids within ``steps`` (a quantum a step), and at least one of
    the twin's ``heavy`` heaviest prompt positions resident."""
    import torch
    from repro_torch.serve import h2o

    ids, counts, errors = entry["ids"], entry["counts"], entry["errors"]
    B, C = ids.shape
    live = ids != h2o.EMPTY
    srt = torch.sort(torch.where(live, ids, -1 - torch.arange(
        C, device=ids.device)), dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise SystemExit(f"{label}: an id is resident twice in a row")
    if bool(((ids < -1) | (ids >= pos[:, None])).any()):
        raise SystemExit(f"{label}: an id is neither EMPTY nor a position "
                         f"before {pos.tolist()}")
    if bool((counts < 0).any()) or bool((errors < 0).any()) \
            or bool((errors > counts).any()):
        raise SystemExit(f"{label}: a count below 0 or an error outside "
                         f"[0, count]")
    overlap, worst, heavy_hit = [], 0, []
    for b in range(B):
        mine = dict(zip(ids[b].tolist(), counts[b].tolist()))
        theirs = dict(zip(twin["ids"][b].tolist(), twin["counts"][b].tolist()))
        common = (set(mine) & set(theirs)) - {h2o.EMPTY}
        overlap.append(len(common) / max(int(live[b].sum()), 1))
        worst = max([worst] + [abs(mine[i] - theirs[i]) for i in common])
        top, _ = h2o.hh_heavy_positions(
            {k: v[b:b + 1] for k, v in twin.items()}, C)
        top = [i for i in top[0].tolist() if 0 <= i < prompt][:heavy]
        heavy_hit.append(sum(i in mine for i in top))
    if min(overlap) < HH_OVERLAP or worst > steps or min(heavy_hit) < 1:
        raise SystemExit(f"{label}: overlap {overlap} (limit {HH_OVERLAP}), "
                         f"worst count difference {worst} (limit {steps}), "
                         f"heavy prompt positions resident {heavy_hit}")
    return dict(slots=C, live=int(live.sum()), overlap=overlap,
                worst_count_diff=worst, count_diff_limit=steps,
                heavy_resident=heavy_hit, heavy_of=heavy,
                decode_positions_resident=int((ids >= prompt).sum()),
                max_count=int(counts.max()), max_error=int(errors.max()))


# The SS± cache at the main run's size with a planted heavy hitter: at
# random init every slot of the 8,192 receives about 1/8,192 of a step's
# mass, which rounds to 0 counts (MASS_SCALE 1,024), so the main run's
# counts stay flat; here one prompt position per row has a key aligned
# with every query and takes most of each step's mass
HH_PLANTED = dict(batch=2, slots=8192, kv=16, g=2, hd=128, steps=64,
                  decay_period=16, heavy=(100, 5000), seed=31)


def hh_planted(device, c=HH_PLANTED) -> dict:
    """Full SS± caches (the prefill's cold start: positions 0..C-1,
    count 1) with random keys but one aligned key per row at position
    ``heavy[b]``; ``steps`` decode steps through the serving path's own
    SS± step after the projection (``decode.hh_attend_step``: insert a
    new token, attend, add the mass over the H q-heads, halve every
    ``decay_period`` steps on row 0's position), once through kernel 6
    and once through its plain version. Each: the heavy position
    resident with its row's largest count after every step, the SS±
    invariants (``check_hh``) against the other run's cache. Returns the
    record and kernel 6's launches."""
    import torch
    from repro_torch.serve import h2o
    from repro_torch.serve.decode import hh_attend_step

    B, C, KV, G, hd = c["batch"], c["slots"], c["kv"], c["g"], c["hd"]
    gen = torch.Generator(device=device).manual_seed(c["seed"])
    bf16 = torch.bfloat16
    u = torch.randn((B, KV, hd), generator=gen, device=device)
    u = u / u.norm(dim=-1, keepdim=True) * math.sqrt(hd)
    k = randn((B, C, KV, hd), bf16, gen, device)
    heavy = torch.tensor(c["heavy"], device=device)
    k[torch.arange(B, device=device), heavy] = u.to(bf16)
    ids = torch.arange(C, device=device, dtype=torch.int32).expand(B, C)
    start = dict(k=k, v=randn((B, C, KV, hd), bf16, gen, device),
                 ids=ids.contiguous(), counts=torch.ones_like(ids),
                 errors=torch.zeros_like(ids))
    steps = [((u[:, :, None] + 0.3 * torch.randn(
                  (B, KV, G, hd), generator=gen, device=device)).to(bf16),
              randn((B, KV, hd), bf16, gen, device),
              randn((B, KV, hd), bf16, gen, device))
             for _ in range(c["steps"])]
    out = {}
    for attention in ("kernel", "plain"):
        reset_counts()
        entry = dict(start)
        for t, (q, kn, vn) in enumerate(steps):
            pos = torch.full((B,), C + t, dtype=torch.int32, device=device)
            _, entry = hh_attend_step(entry, q, kn, vn, pos,
                                      c["decay_period"], attention)
            top, _ = h2o.hh_heavy_positions(entry, 1)
            if not torch.equal(top[:, 0], heavy.to(torch.int32)):
                raise SystemExit(f"hh planted ({attention}) step {t}: the "
                                 f"heaviest resident is {top[:, 0].tolist()}"
                                 f", not {heavy.tolist()}")
        sync(device)
        out[attention] = (entry, read_counts()[DECODE])
    (entry, launches), (twin, _) = out["kernel"], out["plain"]
    if launches != c["steps"]:
        raise SystemExit(f"hh planted: {launches} launches of {DECODE} for "
                         f"{c['steps']} steps")
    rec = check_hh("hh planted", entry, torch.full(
        (B,), C + c["steps"], device=device), C, twin, c["steps"], 1)
    rec.update(steps=c["steps"], heavy=list(c["heavy"]),
               heavy_count=entry["counts"][torch.arange(B), heavy].tolist(),
               plain_heavy_count=twin["counts"][torch.arange(B),
                                                heavy].tolist(),
               launches=launches)
    log(f"hh planted: {json.dumps(rec)}")
    return rec


def serve_run(label, cfg, params, prompt, context, new_tokens, decay_period,
              device, seed, rows_at_a_time=None) -> tuple:
    """One config served through ``ServeEngine`` on the kernels (B = 2),
    then its plain twin teacher-forced on the kernel run's tokens (both
    rows at once, or ``rows_at_a_time``), launch counts checked on both,
    every step's logits held row by row (``logit_share``), and the check
    shown to reject the two requests' rows swapped. Returns the record,
    the engine's result and the twin's final caches."""
    import torch
    from repro_torch.serve import ServeEngine

    toks, kw = model_inputs(cfg, 2, prompt, device, seed)
    B = toks.shape[0]
    flash_n, decode_n = attention_calls(cfg)
    engine = ServeEngine(cfg, params, context, decay_period, device=device)
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    with AttentionSpy(keep=True) as spy:
        res = engine.generate(toks, new_tokens, keep_logits=True, **kw)
        sync(device)
    wall = time.perf_counter() - t0
    by_path = check_model_launches(label, read_counts(), flash_n,
                                   decode_n * new_tokens, spy)
    masks = dict(spy.masks)
    generated = torch.as_tensor(res["tokens"][:, -new_tokens:],
                                device=device)
    if not all(bool(torch.isfinite(x.float()).all()) for x in res["logits"]) \
            or res["logits"][-1].shape != (B, cfg.vocab_size):
        raise SystemExit(f"{label}: logits not finite or not (B, V)")
    per = rows_at_a_time or B
    errs, shares, firsts, twin_caches = [], [], [], []
    for lo in range(0, B, per):
        rows = slice(lo, lo + per)
        reset_counts()
        with AttentionSpy() as twin_spy:
            want, cache = twin_logits(cfg, params, context, decay_period,
                                      toks, kw, generated, rows, device)
            sync(device)
        check_model_launches(label + " twin", read_counts(), flash_n,
                             decode_n * new_tokens, twin_spy, plain=True)
        twin_caches.append(cache)
        firsts.append(want[0])
        for t, w in enumerate(want):
            err, share = logit_share(res["logits"][t][rows], w)
            errs.append(err)
            shares.append(share)
            if not share <= LOGIT_SHARE:
                raise SystemExit(f"{label} step {t} rows {rows}: a logit's "
                                 f"error takes {share} of its row's RMS "
                                 f"beyond {LOGIT_ROUNDING}·|want| (limit "
                                 f"{LOGIT_SHARE}); max_abs_err {err}")
        del want
    # the limit must tell one request's logits from the other's
    swapped = logit_share(res["logits"][0].flip(0), torch.cat(firsts))[1]
    if swapped <= LOGIT_SHARE:
        raise SystemExit(f"{label}: the logit check passes the requests' "
                         f"rows swapped (share {swapped})")
    held = hold_kept(label, spy.operands)
    record = dict(
        config=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, vocab=cfg.vocab_size, batch=B,
        prompt=prompt, context=context, new_tokens=new_tokens,
        wall_s=wall, flash_launches=flash_n, flash_by_path=by_path,
        flash_by_mask=masks, decode_launches=decode_n * new_tokens,
        logit_max_abs_err=max(errs), logit_row_share=max(shares),
        logit_row_share_limit=LOGIT_SHARE, swapped_row_share=swapped,
        kernels_vs_plain=held,
        reduced=f"depth {cfg.num_layers} layers (one period)")
    log(f"{label}: {json.dumps(record)}")
    return record, res, twin_caches, spy.operands


def stepwise_invariant(cfg, params, device, c=MODEL_STEPWISE) -> dict:
    """The reference's core serving invariant (tests/test_serve.py:24) at
    full width: prefill then one step gives the next token of stepwise
    decode of the same prompt (exact, as there), and the prefill's last
    logits and those of the step after agree, through the kernels
    (kernel 5 against kernel 6, token by token) and, as the witness of
    what bf16 rounding alone gives at this width, through their plain
    versions. The logits are held row by row by ``logit_share`` within
    LOGIT_SHARE: the reference's rtol = atol = 0.05 was set at smoke width
    (logits of RMS ~0.2), and at this width (RMS 1.47, a token's own logit
    near 47, where a bf16 ulp is 0.25) the plain path exceeds it too; the
    count of elements beyond it is recorded for both paths."""
    import torch
    from repro_torch.serve import (build_cache, build_prefill_step,
                                   build_serve_step)

    toks, _ = model_inputs(cfg, c["batch"], c["prompt"], device, c["seed"])
    flash_n, decode_n = attention_calls(cfg)
    out = dict(batch=c["batch"], prompt=c["prompt"], context=c["context"],
               limit=dict(rounding=LOGIT_ROUNDING, share=LOGIT_SHARE))
    for attention in ("kernel", "plain"):
        prefill = build_prefill_step(cfg, c["context"], attention=attention,
                                     device=device)
        step = build_serve_step(cfg, c["context"], attention=attention,
                                device=device)
        reset_counts()
        t0 = time.perf_counter()
        with AttentionSpy(keep=attention == "kernel") as spy:
            la0, cache_a = prefill(params, {"tokens": toks})
            nxt = torch.argmax(la0[:, -1], -1).to(torch.int32)[:, None]
            la, _, _ = step(params, cache_a, nxt)
            del cache_a
            cache_b = build_cache(cfg, c["batch"], c["context"],
                                  device=device)
            for t in range(c["prompt"]):
                lb0, cache_b, _ = step(params, cache_b, toks[:, t:t + 1])
            nxt_b = torch.argmax(lb0[:, -1], -1).to(torch.int32)[:, None]
            lb, _, _ = step(params, cache_b, nxt_b)
            del cache_b
            sync(device)
        secs = time.perf_counter() - t0
        by_path = check_model_launches(
            f"stepwise invariant ({attention})", read_counts(), flash_n,
            decode_n * (c["prompt"] + 2), spy, plain=attention == "plain")
        if not torch.equal(nxt, nxt_b):
            raise SystemExit(f"stepwise invariant ({attention}): prefill's "
                             f"next tokens {nxt.tolist()} differ from "
                             f"stepwise decode's {nxt_b.tolist()}")
        rec = dict(next_tokens=nxt[:, 0].tolist(), seconds=secs)
        for name, (got, want) in (("prefill", (la0, lb0)),
                                  ("step after", (la, lb))):
            got, want = got[:, -1].float(), want[:, -1].float()
            err, share = logit_share(got, want)
            if not share <= LOGIT_SHARE:
                raise SystemExit(
                    f"stepwise invariant ({attention}), {name}: a logit's "
                    f"error takes {share} of its row's RMS beyond "
                    f"{LOGIT_ROUNDING}·|want| (limit {LOGIT_SHARE}); "
                    f"max_abs_err {err}")
            rec[name] = dict(
                max_abs_err=err, row_share=share,
                swapped_row_share=logit_share(got.flip(0), want)[1],
                beyond_reference_tolerance=int(
                    ((got - want).abs() > 0.05 + 0.05 * want.abs()).sum()),
                max_abs_logit=float(want.abs().max()),
                rms=want.pow(2).mean(-1).sqrt().tolist())
            if rec[name]["swapped_row_share"] <= LOGIT_SHARE:
                raise SystemExit(f"stepwise invariant ({attention}): the "
                                 f"logit check passes the rows swapped")
        if attention == "kernel":
            rec.update(flash_by_path=by_path,
                       decode_launches=decode_n * (c["prompt"] + 2),
                       kernels_vs_plain=hold_kept("stepwise invariant",
                                                  spy.operands))
            out.update(flash_by_path=by_path,
                       decode_launches=rec["decode_launches"])
        out[attention] = rec
    log(f"stepwise invariant: {json.dumps(out)}")
    return out


def serve_times(cfg, params, engine, toks, new_tokens, device) -> dict:
    """Prefill ms (median of 3) and decode ms per step (each of
    ``new_tokens`` steps timed with a sync, median and mean) on the main
    run's inputs; decode tokens/s, every token generated over the whole
    timed window of steps; the unembed's ms; one decode step profiled:
    device busy ms and the shares of kernel 6, the matmuls and the rest,
    and the host's wall ms of that step. Beside them the analytic bounds
    of ``roofline_terms`` (flops: ``model_flops``, bytes:
    ``analytic_hbm_bytes``) at these shapes."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import InputShape
    from repro_torch.models.transformer import _unembed
    from repro_torch.roofline.model import (analytic_hbm_bytes, model_flops,
                                            param_count, roofline_terms)

    B, S = toks.shape
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine._prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    steps = []
    for _ in range(new_tokens):
        t0 = time.perf_counter()
        logits, cache, _ = engine._step(params, cache, cur)
        cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    x = torch.randn((B, 1, cfg.d_model), device=device).to(torch.bfloat16)
    unembed_ms = time_ms(lambda: _unembed(params, cfg, x), 20)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache, _ = engine._step(params, cache, cur)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kinds = dict(decode_attention=0.0, matmul=0.0, other=0.0)
    device, host = [], []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.key[:60], e.self_cpu_time_total / 1e3, e.count))
            continue
        name = e.key.lower()
        kind = ("decode_attention" if any(
                    f"decode_{k}_kernel" in name for k in ("split", "combine"))
                else "matmul" if any(s in name for s in
                                     ("gemm", "gemv", "xmma", "cutlass",
                                      "nvjet", "splitk"))
                else "other")
        kinds[kind] += _dev_us(e) / 1e3
        device.append((e.key[:80], _dev_us(e) / 1e3, e.count, kind))
    busy = sum(kinds.values())
    device.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])

    pc = param_count(cfg)
    shapes = dict(prefill=InputShape("serve prefill", S, B, "prefill"),
                  decode=InputShape("serve decode", S + new_tokens, B,
                                    "decode"))
    bounds = {}
    for name, shape in shapes.items():
        terms = roofline_terms(
            hlo_flops_global=model_flops(cfg, shape),
            hlo_bytes_global=analytic_hbm_bytes(cfg, shape),
            collective_bytes_global=0.0, chips=1, cfg=cfg, shape=shape)
        bounds[name] = dict(terms.to_dict(), bound_ms=terms.bound_time_s * 1e3,
                            analytic_memory_ms=terms.memory_s_analytic * 1e3)
    # the prefill unembeds only each request's last token: the matrix work
    # without the unembed of every position
    emb = cfg.vocab_size * cfg.d_model
    pre_flops = model_flops(cfg, shapes["prefill"]) - 2.0 * emb * B * (S - 1)
    bounds["prefill"]["last_token_logits_flops"] = pre_flops
    bounds["prefill"]["last_token_logits_bound_ms"] = (
        pre_flops / BF16_FLOPS_PER_S * 1e3)
    out = dict(
        prefill_ms=statistics.median(pre), prefill_ms_runs=pre,
        prefill_tokens_per_s=B * S / (statistics.median(pre) / 1e3),
        decode_ms_per_step=statistics.median(steps),
        decode_ms_mean=statistics.mean(steps), decode_ms_steps=steps,
        decode_tokens_per_s=B * len(steps) / (sum(steps) / 1e3),
        unembed_ms=unembed_ms, params=pc["total"],
        profiled_step=dict(wall_ms=prof_wall, device_busy_ms=busy,
                           device_ms_by_kind=kinds,
                           device_launches=sum(r[2] for r in device),
                           top_device=device[:12], top_host=host[:12],
                           kernel6_share=kinds["decode_attention"] / busy
                           if busy else None),
        bounds=bounds)
    log(f"serving times: {json.dumps(out)}")
    return out


def serving_kernel_times(operands, held) -> dict:
    """Kernels 5 and 6 at the serving shapes the main run gave them (the
    first operands of each kind, kept by ``AttentionSpy``): kernel ms
    (CUDA events), plain ms, one SDPA call, and the bound, beside
    ``held``, what ``hold_kept`` found on the same operands. Kernel 6
    also by the profiler: device ms per launch and per call, with the L2
    warm from the call before and cold (``decode_device_ms``), and the
    wrapper's host ms per call (``host_ms``): back-to-back calls timed
    with events run at the slower of the two."""
    import torch
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import (allowed_pairs,
                                                         flash_attention_ref)

    out = {}
    for key, ops in operands.items():
        if key.startswith("decode"):
            q, k, v, valid = (t.contiguous() for t in ops)
            B, KV, G, hd = q.shape
            lib = sdpa(q.reshape(B, KV * G, 1, hd),
                       *(t.transpose(1, 2).contiguous() for t in (k, v)),
                       attn_mask=valid[:, None, None, :])
            kern = lambda: decode_attention_kernel(q, k, v, valid)
            warm, cold = decode_device_ms(kern), decode_device_ms(kern,
                                                                  cold=True)
            out[key] = dict(
                shape=dict(B=B, C=k.shape[1], KV=KV, G=G, hd=hd),
                ms=time_ms(kern, 20), kernel_device_ms=device_kernels(kern),
                device_ms_per_call=warm["per_call_ms"],
                device_ms_per_launch=warm["per_launch"],
                device_ms_per_call_cold=cold["per_call_ms"],
                device_ms_per_launch_cold=cold["per_launch"],
                host_ms_per_call=host_ms(kern),
                plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, valid),
                                 3),
                library_ms=time_ms(lib, 20), **decode_bound(q, k, valid))
            del lib
        else:
            q, k, v, causal, window = ops
            q, k, v = (t.contiguous() for t in (q, k, v))
            B, S, H, hd = q.shape
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if window:
                lib = sdpa(qh, kh, vh, attn_mask=allowed_pairs(
                    S, k.shape[1], causal, window, q.device))
            else:
                lib = sdpa(qh, kh, vh, is_causal=causal)
            entry = dict(
                shape=dict(B=B, S=S, T=k.shape[1], H=H, KV=k.shape[2], hd=hd,
                           causal=causal, window=window),
                ms=time_ms(lambda: flash_attention_kernel(
                    q, k, v, causal=causal, window=window), 10),
                library_ms=time_ms(lib, 10), **flash_bound(q, k, causal,
                                                           window))
            del qh, kh, vh, lib
            torch.cuda.empty_cache()
            # the plain version's (S, T) f32 scores: one request at a time
            entry["plain_ms"] = B * time_ms(lambda: flash_attention_ref(
                q[:1], k[:1], v[:1], causal=causal, window=window), 2, 1)
            entry["plain_ms_note"] = "per request, times B"
            out[key] = entry
        out[key].update(held[key])
        torch.cuda.empty_cache()
        log(f"{key} at the serving shapes: {json.dumps(out[key])}")
    return out


def model_phase(device, get=None, main=MODEL_MAIN, stepwise=MODEL_STEPWISE,
                others=MODEL_OTHERS, other_tokens=MODEL_OTHER_TOKENS,
                planted=HH_PLANTED, timed=True) -> tuple:
    """The model stack and model serving (see MODEL_MAIN): Gemma3-27B's
    main serving run with its launch counts, plain twin and SS±
    invariants; its times (``timed``); the stepwise invariant; the other
    nine configs each with its twin. ``get`` picks the configs (the full
    ones, cut to one period, by default; the CPU rehearsal passes the
    smoke ones with its own sizes). Returns (launches of kernel 5 by path
    and of kernel 6 by run, the phase's summary)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine, kv_cache

    get = get or (lambda arch: one_period(configs.get(arch)))
    t_phase = time.perf_counter()
    c = main
    cfg = get(c["arch"])
    t0 = time.perf_counter()
    params, _ = build_model(cfg).init(c["seed"], device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    launches = {"flash": {}, "decode": {}}

    def add(run, rec):
        for path, n in rec["flash_by_path"].items():
            launches["flash"][path] = launches["flash"].get(path, 0) + n
        launches["decode"][run] = rec["decode_launches"]

    rec, res, twins, operands = serve_run(
        f"model {c['arch']} main", cfg, params, c["prompt"], c["context"],
        c["new_tokens"], c["decay_period"], device, c["seed"],
        rows_at_a_time=1)
    if rec["flash_by_mask"] != expected_masks(cfg):
        raise SystemExit(f"{c['arch']} main: prefill masks "
                         f"{rec['flash_by_mask']}, expected "
                         f"{expected_masks(cfg)}")
    add(f"{c['arch']} main", rec)
    entry = hh_entry_of(res["cache"], cfg)
    twin = {k: torch.cat([hh_entry_of(t, cfg)[k] for t in twins])
            for k in ("ids", "counts", "errors")}
    rec["hh"] = check_hh(f"{c['arch']} main hh", entry, res["cache"]["pos"],
                         c["prompt"], twin, c["new_tokens"], c["heavy"])
    if rec["hh"]["live"] != c["batch"] * cfg.hh_kv_budget:
        raise SystemExit(f"the SS± cache is not full: {rec['hh']}")
    log(f"{c['arch']} main hh: {json.dumps(rec['hh'])}")
    del res, twins, entry, twin
    if timed:
        engine = ServeEngine(cfg, params, c["context"], c["decay_period"],
                             device=device)
        toks, _ = model_inputs(cfg, c["batch"], c["prompt"], device,
                               c["seed"])
        rec["times"] = serve_times(cfg, params, engine, toks,
                                   c["new_tokens"], device)
        del engine, toks
    gc_free(device)
    reset_counts()
    step_rec = stepwise_invariant(cfg, params, device, stepwise)
    add("stepwise invariant", step_rec)
    del params
    gc_free(device)
    kernel_times = (serving_kernel_times(operands, rec["kernels_vs_plain"])
                    if timed else {})
    del operands
    gc_free(device)
    rec["hh_planted"] = hh_planted(device, planted)
    launches["decode"]["hh planted"] = rec["hh_planted"]["launches"]
    gc_free(device)

    other_recs = {}
    for i, (arch, (prompt, context)) in enumerate(others.items()):
        ocfg = get(arch)
        t0 = time.perf_counter()
        oparams, _ = build_model(ocfg).init(100 + i, device=device)
        orec, res, twins, _ = serve_run(
            f"model {arch}", ocfg, oparams, prompt, context, other_tokens,
            8192, device, 100 + i)
        if orec["flash_by_mask"] != expected_masks(ocfg):
            raise SystemExit(f"{arch}: prefill masks {orec['flash_by_mask']}"
                             f", expected {expected_masks(ocfg)}")
        if ocfg.hh_kv_budget and context > kv_cache.HH_ENGAGE_CTX:
            orec["hh"] = check_hh(
                f"{arch} hh", hh_entry_of(res["cache"], ocfg),
                res["cache"]["pos"], prompt + ocfg.vision_tokens,
                hh_entry_of(twins[0], ocfg), other_tokens, 16)
        orec["seconds"] = time.perf_counter() - t0
        other_recs[arch] = orec
        add(arch, orec)
        del oparams, res, twins
        gc_free(device)
    # every shape the phase's kernel runs gave kernels 5 and 6, held
    held = dict(shapes=dict(flash=0, decode=0),
                max_abs_err=dict(flash=0.0, decode=0.0),
                row_share=dict(flash=0.0, decode=0.0))
    for run in (rec, step_rec["kernel"], *other_recs.values()):
        for key, r in run["kernels_vs_plain"].items():
            kind = "decode" if key.startswith("decode") else "flash"
            held["shapes"][kind] += 1
            held["max_abs_err"][kind] = max(held["max_abs_err"][kind],
                                            r["max_abs_err"],
                                            r.get("mass_max_abs_err", 0.0))
            held["row_share"][kind] = max(held["row_share"][kind],
                                          r["row_share"])
    summary = dict(main=rec, init_s=init_s, stepwise=step_rec,
                   serving_kernel_times=kernel_times, others=other_recs,
                   launches=launches, kernels_vs_plain=held,
                   seconds=time.perf_counter() - t_phase)
    log(f"model phase: {summary['seconds']:.1f} s, launches "
        f"{json.dumps(launches)}, kernels vs plain at the runs' shapes "
        f"{json.dumps(held)}")
    return launches, summary


# ---------------------------------------------------------------------------
# Training: the Trainer on kernel 5 (the forward of every attention layer,
# FlashAttentionFn's backward) and kernel 1 (its SS± trackers)
# ---------------------------------------------------------------------------

# Qwen3-0.6B at full width and depth (28 layers, d 1,024, 16 q-heads over
# 8 kv-heads, hd 128, vocab 151,936, tied embeddings), random bf16 init
# from the seed, remat on: 4 x 2,048 tokens a step, 16 steps, the first 2
# warm-up for the times
TRAIN_MAIN = dict(arch="qwen3_0_6b", seq_len=2048, batch=4, steps=16,
                  warmup=2, seed=25, loss_falls=True)
# OLMoE-1B-7B at full width (64 experts, top-8, d 2,048), depth cut to 2
TRAIN_MOE = dict(arch="olmoe_1b_7b", layers=2, seq_len=1024, batch=4,
                 steps=8, seed=26)
# the reference's trainer cases (tests/test_fault_tolerance.py:74-81):
# smoke Qwen3, seq_len 32, global_batch 4, token stats of 64 counters
# over a window of 4
TRAIN_RESUME = dict(arch="qwen3_0_6b", seq_len=32, batch=4, straight=8,
                    stop_after=3, sketch_steps=6)
# the reference test's own tolerance on the resumed loss; the card's
# float scatters (the embedding's gradient) need not add in one order
RESUME_RTOL = 1e-5
# One step with kernel 5 against its plain twin (attention="plain", the
# same state and batch). Both keep a bf16 model, whose roundings the
# kernel's bf16 P in P·V moves (the model phase's logit rows); limits set
# before the first run from bf16's precision: the loss within one bf16
# ulp (2^-8), the gradient's norm within 2^-5. A weight moves by about
# lr at step 1 whatever its gradient's size (mh / sqrt(vh) = sign(g)):
# where a gradient lies within the two runs' difference of 0 its sign,
# and so the weight's move, may differ by 2 lr. So each master leaf is
# held within 2 lr (+1 %) everywhere, and at most TWIN_FLIP_SHARE of its
# weights may be more than lr / 2 apart. A dropped attention gradient
# would move every weight of wq, wk and wv by lr against the twin.
TWIN_LOSS_RTOL = 2.0**-8
TWIN_GRAD_NORM_RTOL = 2.0**-5
TWIN_FLIP_SHARE = 2.0**-3
# the profiled step's spans (``profile_train_step``)
TRAIN_SPANS = ("attention backward", "optimizer")


def flat_tree(tree, prefix=""):
    """{path: leaf} of nested dicts, paths joined by "/"."""
    if isinstance(tree, dict):
        return {p: v for k, v in tree.items()
                for p, v in flat_tree(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def check_train_launches(label, counts, flash, fused, spy) -> tuple:
    """``flash`` launches of kernel 5 and ``fused`` of kernel 1 (by the
    counters), no other kernel, no plain version through the layers.
    Returns (kernel 5's by path, kernel 1's by layout)."""
    def part(name):
        return {k.split("[")[1][:-1]: n for k, n in counts.items()
                if k.startswith(name + "[") and n}

    fl, fu = part(FLASH), part(FUSED)
    others = {k: n for k, n in counts.items()
              if n and not k.startswith((FLASH + "[", FUSED + "["))}
    if sum(fl.values()) != flash or sum(fu.values()) != fused or others \
            or any(spy.plain.values()):
        raise SystemExit(f"{label}: launches {counts}, plain calls "
                         f"{spy.plain}; expected {flash} of {FLASH}, {fused} "
                         f"of {FUSED}, no other kernel, no plain version")
    return fl, fu


def train_twin(label, tr, cfg, batch) -> dict:
    """One step of the trainer's step function (kernel 5) and of its plain
    twin from the trainer's state on ``batch``: loss, gradient norm and
    master weights held as TWIN_* say; the twin launches no kernel."""
    import torch
    from repro_torch.train import build_train_step

    got, gm = tr._step(tr.state, batch)
    reset_counts()
    with AttentionSpy() as spy:
        want, wm = build_train_step(cfg, attention="plain")(tr.state, batch)
        sync(batch["tokens"].device)
    if any(read_counts().values()) or not spy.plain["flash"]:
        raise SystemExit(f"{label} twin: launches {read_counts()}, plain "
                         f"calls {spy.plain}")
    lr = float(wm["lr"])
    rec = dict(loss=float(gm["loss"]), twin_loss=float(wm["loss"]),
               grad_norm=float(gm["grad_norm"]),
               twin_grad_norm=float(wm["grad_norm"]), lr=lr,
               loss_rtol=TWIN_LOSS_RTOL, grad_norm_rtol=TWIN_GRAD_NORM_RTOL,
               flip_share_limit=TWIN_FLIP_SHARE)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    if not rel(rec["loss"], rec["twin_loss"]) <= TWIN_LOSS_RTOL or \
            not rel(rec["grad_norm"], rec["twin_grad_norm"]) \
            <= TWIN_GRAD_NORM_RTOL:
        raise SystemExit(f"{label}: the kernel step's loss or gradient norm "
                         f"is not its plain twin's: {rec}")
    worst, flips = 0.0, {}
    got_m, want_m = flat_tree(got.opt.master), flat_tree(want.opt.master)
    for path, w in want_m.items():
        err = (got_m[path] - w).abs()
        worst = max(worst, float(err.max()))
        flips[path] = float((err > lr / 2).float().mean())
        if float(err.max()) > 2.02 * lr or flips[path] > TWIN_FLIP_SHARE:
            raise SystemExit(f"{label}: master {path} moved otherwise than "
                             f"its plain twin's: max {float(err.max())}, "
                             f"share past lr / 2 {flips[path]}")
    rec.update(master_max_abs_err=worst, master_flip_share=max(
        flips.values()), master_flip_share_by_leaf=flips)
    log(f"{label} against its plain twin: {json.dumps(rec)}")
    del got, want
    return rec


def hold_grads(label, operands, seed=27) -> dict:
    """``FlashAttentionFn``'s input gradients against autograd of the
    plain attention on each kept flash shape, one seeded bf16 cotangent:
    equal, bit for bit (its backward is that plain VJP)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    out = {}
    for key, (q, k, v, causal, window) in operands.items():
        if key.startswith("decode"):
            continue
        gen = torch.Generator(device=q.device).manual_seed(seed)
        dout = randn(tuple(q.shape), q.dtype, gen, q.device)
        grads = []
        for fn in (lambda *t: FlashAttentionFn.apply(*t, causal, window),
                   lambda *t: flash_attention_ref(*t, causal=causal,
                                                  window=window)):
            leaves = [t.detach().contiguous().requires_grad_(True)
                      for t in (q, k, v)]
            grads.append(torch.autograd.grad(fn(*leaves), leaves, dout))
        diff = [float((a.float() - b.float()).abs().max())
                for a, b in zip(*grads)]
        if not all(torch.equal(a, b) for a, b in zip(*grads)):
            raise SystemExit(f"{label} {key}: FlashAttentionFn's gradients "
                             f"differ from the plain attention's: {diff}")
        out[key] = dict(max_abs_err=max(diff))
        del grads, dout
    log(f"{label} FlashAttentionFn against autograd of the plain "
        f"attention: {json.dumps(out)}")
    return out


def attribute_step(prof) -> dict:
    """Device ms of a profiled train step by kind: each kernel under one
    of TRAIN_SPANS (the nearest enclosing span of the op that launched
    it), else kernel 5 by name, else the matmuls by name, else the rest.
    ``attributed_ms`` against ``busy_ms`` says how much of the device
    time the op tree linked to a launching op."""
    import torch

    CUDA = torch.autograd.DeviceType.CUDA
    kinds = dict.fromkeys(("matmul", "kernel 5", *TRAIN_SPANS, "other"), 0.0)
    events = list(prof.events())
    busy = sum(e.time_range.end - e.time_range.start for e in events
               if e.device_type == CUDA and e.name not in TRAIN_SPANS)

    def span_of(e):
        while e is not None:
            if e.name in TRAIN_SPANS:
                return e.name
            e = e.cpu_parent
        return None

    def by_name(name):
        low = name.lower()
        if "flash_" in low and "_kernel" in low:
            return "kernel 5"
        if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                                  "splitk")):
            return "matmul"
        return "other"

    seen = 0.0
    for e in events:
        if e.device_type == CUDA:
            continue
        span = span_of(e)
        for k in getattr(e, "kernels", ()):
            kinds[span or by_name(k.name)] += k.duration
            seen += k.duration
    return dict(busy_ms=busy / 1e3, attributed_ms=seen / 1e3,
                device_ms_by_kind={k: v / 1e3 for k, v in kinds.items()})


def profile_train_step(tr) -> dict:
    """One more step of ``tr`` under the profiler, the attention backward
    (``FlashAttentionFn.backward``) and the optimizer (``adamw_update``)
    each in a span: wall ms, device busy ms and its kinds
    (``attribute_step``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
    from repro_torch.train import step as tstep

    backward, update = FlashAttentionFn.backward, tstep.adamw_update

    def spanned(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    FlashAttentionFn.backward = staticmethod(spanned(TRAIN_SPANS[0],
                                                     backward))
    tstep.adamw_update = spanned(TRAIN_SPANS[1], update)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run(1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        FlashAttentionFn.backward = staticmethod(backward)
        tstep.adamw_update = update
    out = dict(wall_ms=wall, **attribute_step(prof))
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=_dev_us, reverse=True)[:12]
    out["top_device"] = [(e.key[:80], _dev_us(e) / 1e3, e.count) for e in top]
    out["idle_share"] = 1 - out["busy_ms"] / wall if wall else None
    return out


def count_step_flops(tr) -> dict:
    """One more step of ``tr`` under ``FlopCounterMode``: its FLOPs, in
    total and by op (kernel 5's op by its own formula), the count the
    dry-run phase holds its trace to."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        tr.run(1)
    return dict(total=fc.get_total_flops(), by_op={
        str(k): v for k, v in fc.get_flop_counts()["Global"].items()})


def train_step_bounds(cfg, seq_len, batch) -> dict:
    """``roofline_terms`` of one train step at this shape, remat on (flops:
    ``model_flops``, bytes: ``analytic_hbm_bytes``)."""
    from repro_torch.configs import InputShape
    from repro_torch.roofline.model import (analytic_hbm_bytes, model_flops,
                                            roofline_terms)

    shape = InputShape("train", seq_len, batch, "train")
    terms = roofline_terms(
        hlo_flops_global=model_flops(cfg, shape),
        hlo_bytes_global=analytic_hbm_bytes(cfg, shape, remat=True),
        collective_bytes_global=0.0, chips=1, cfg=cfg, shape=shape,
        remat=True)
    return dict(terms.to_dict(), bound_ms=terms.bound_time_s * 1e3,
                analytic_memory_ms=terms.memory_s_analytic * 1e3)


def backward_times(operands) -> dict:
    """The attention backward at each kept training shape: ms of one
    ``FlashAttentionFn`` backward (the plain VJP with its recompute of
    the (S, T) f32 scores), beside its bound (q, k, v, dout read and dq,
    dk, dv written once; 8·hd FLOPs per allowed pair and q-head: dP,
    dV, dQ, dK)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import (allowed_count,
                                                         flash_attention_ref)

    out = {}
    for key, (q, k, v, causal, window) in operands.items():
        if key.startswith("decode"):
            continue
        B, S, H, hd = q.shape
        leaves = [t.detach().contiguous().requires_grad_(True)
                  for t in (q, k, v)]
        dout = torch.ones_like(q)
        ms = time_ms(lambda: torch.autograd.grad(flash_attention_ref(
            *leaves, causal=causal, window=window), leaves, dout), 3, 1)
        pairs = allowed_count(S, k.shape[1], causal, window)
        nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel())
        out[key] = dict(ms=ms, **bound(nbytes, 8 * B * H * hd * pairs))
        del leaves, dout
    log(f"attention backward at the training shapes: {json.dumps(out)}")
    return out


def train_main(label, cfg, c, device, tmp, timed=True) -> dict:
    """The Trainer on ``cfg`` for ``c["steps"]`` steps (see TRAIN_MAIN):
    its plain twin on the first batch, then the counted run (kernel 5
    twice a layer a step, remat's recompute the second; kernel 1 once a
    step for the token tracker and once for the expert tracker of a MoE
    model), every loss and gradient norm finite, the master weights
    moved with the params their bf16 casts, the loss falling where
    ``c["loss_falls"]`` (the mean of the last 4 below step 1's), the
    trackers equal to CPU twins fed
    the same tokens and expert counts, kernel 5 held to its plain
    version and ``FlashAttentionFn`` to the plain gradient on the run's
    own operands; then times, memory, a profiled step and the bounds."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig
    from repro_torch.sketch.stats import ExpertLoadStats, TokenStats
    from repro_torch.train import Trainer, TrainerConfig

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq_len"],
                    global_batch=c["batch"], seed=c["seed"])
    tc = TrainerConfig(total_steps=c["steps"], ckpt_every=0, ckpt_dir=tmp,
                       log_every=1, seed=c["seed"])
    t0 = time.perf_counter()
    tr = Trainer(cfg, dc, tc, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    twin = train_twin(label, tr, cfg, {
        k: torch.from_numpy(v).to(device)
        for k, v in tr.pipeline.batch_at(0).items()})
    start = {p: t.clone() for p, t in flat_tree(tr.state.opt.master).items()}
    fed = []
    if tr.expert_stats is not None:
        update = tr.expert_stats.update

        def record(counts):
            fed.append(np.array(counts))
            update(counts)
        tr.expert_stats.update = record
    gc_free(device)
    layers = sum(expected_masks(cfg).values())
    reset_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with AttentionSpy(keep=True) as spy:
        out = tr.run()
        sync(device)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    steps = c["steps"]
    trackers = 1 + (tr.expert_stats is not None)
    flash_by_path, fused_by_layout = check_train_launches(
        label, read_counts(), 2 * layers * steps, trackers * steps, spy)
    if spy.masks != dict(windowed=0, causal=2 * layers * steps, unmasked=0):
        raise SystemExit(f"{label}: attention calls {spy.masks}")
    log_ = tr.metrics_log
    losses = [r["loss"] for r in log_]
    norms = [r["grad_norm"] for r in log_]
    if out["final_step"] != steps or len(losses) != steps or not all(
            math.isfinite(x) for x in losses + norms):
        raise SystemExit(f"{label}: {out}, losses {losses}, norms {norms}")
    if c.get("loss_falls") and not statistics.mean(losses[-4:]) < losses[0]:
        raise SystemExit(f"{label}: the loss did not fall: {losses}")
    params, master = flat_tree(tr.state.params), flat_tree(
        tr.state.opt.master)
    for path, w in master.items():
        if torch.equal(w, start[path]) or not torch.equal(
                params[path], w.to(params[path].dtype)):
            raise SystemExit(f"{label}: {path} did not move, or its param "
                             f"is not its master weight's cast")
    del start
    # the trackers against CPU twins fed the same tokens and counts
    tok = TokenStats(capacity=tc.token_stats_capacity,
                     window=tc.token_stats_window, device="cpu")
    for i in range(steps):
        tok.update(tr.pipeline.batch_at(i)["tokens"])
    twins = [("token", tr.token_stats, tok)]
    if tr.expert_stats is not None:
        exp = ExpertLoadStats(cfg.num_experts, device="cpu")
        routed = c["batch"] * c["seq_len"] * cfg.experts_per_token * \
            cfg.num_layers
        if len(fed) != steps or any(int(f.sum()) != routed for f in fed):
            raise SystemExit(f"{label}: the expert tracker was fed "
                             f"{[int(f.sum()) for f in fed]}, expected "
                             f"{steps} steps of {routed}")
        for f in fed:
            exp.update(f)
        twins.append(("expert", tr.expert_stats, exp))
    for name, got, want in twins:
        g, w = got.state_dict(), want.state_dict()
        if (got.insertions, got.deletions) != (want.insertions,
                                               want.deletions) or not all(
                np.array_equal(np.asarray(g[k]), np.asarray(w[k]))
                for k in ("ids", "counts", "errors")):
            raise SystemExit(f"{label}: the {name} tracker differs from its "
                             f"CPU twin")
    operands = {key: tuple(t.detach() if torch.is_tensor(t) else t
                           for t in ops) for key, ops in spy.operands.items()}
    held = hold_kept(label, operands)
    grads = hold_grads(label, operands)
    times = [r["step_time_s"] * 1e3 for r in log_]
    timed_ms = times[c.get("warmup", 0):]
    tokens = c["batch"] * c["seq_len"]
    rec = dict(
        config=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, vocab=cfg.vocab_size,
        experts=cfg.num_experts, batch=c["batch"], seq_len=c["seq_len"],
        steps=steps, init_s=init_s, twin=twin, losses=losses,
        grad_norms=norms, step_ms=times,
        step_ms_median=statistics.median(timed_ms),
        tokens_per_s=tokens / (statistics.median(timed_ms) / 1e3),
        peak_memory_gb=peak / 1e9 if peak is not None else None,
        flash_launches=2 * layers * steps, flash_by_path=flash_by_path,
        fused_launches=trackers * steps, fused_by_layout=fused_by_layout,
        kernels_vs_plain=held, flash_grads_vs_plain=grads,
        trackers_vs_cpu=[name for name, _, _ in twins])
    if timed:
        rec["kernel_times"] = serving_kernel_times(operands, held)
        rec["backward_times"] = backward_times(operands)
        rec["profiled_step"] = profile_train_step(tr)
        rec["bounds"] = train_step_bounds(cfg, c["seq_len"], c["batch"])
        rec["flop_counter"] = count_step_flops(tr)
    log(f"{label}: {json.dumps({k: v for k, v in rec.items() if k not in ('twin', 'kernels_vs_plain')})}")
    del tr, operands, spy
    gc_free(device)
    return rec


def gc_free(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def train_resume(device, c, tmp) -> dict:
    """The reference's three trainer cases at its shape (TRAIN_RESUME) on
    ``device``: 8 straight steps against 4, save, a new Trainer, resume
    and 4 more (the last loss within RESUME_RTOL; whether every resumed
    loss is bit for bit the straight run's is recorded); a stop after 3
    steps saves at the final step; the token sketch survives a resume."""
    import pathlib

    import numpy as np
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt

    cfg = configs.get_smoke(c["arch"])
    tmp = pathlib.Path(tmp)

    def make(d, steps, ckpt_every=100):
        return Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=c["seq_len"],
                                       global_batch=c["batch"]),
                       TrainerConfig(total_steps=steps,
                                     ckpt_every=ckpt_every,
                                     ckpt_dir=str(tmp / d), log_every=1,
                                     token_stats_capacity=64,
                                     token_stats_window=4), device=device)

    n = c["straight"]
    a = make("a", n)
    a.run()
    first = make("b", n // 2)
    first.run()
    first.save()
    b = make("b", n)
    if not b.try_resume() or (b.step_num, b.pipeline.cursor) != (n // 2,
                                                                n // 2):
        raise SystemExit(f"train resume: resumed at {b.step_num}")
    b.run(n // 2)
    straight = [r["loss"] for r in a.metrics_log[n // 2:]]
    resumed = [r["loss"] for r in b.metrics_log]
    if not abs(resumed[-1] - straight[-1]) <= RESUME_RTOL * abs(straight[-1]):
        raise SystemExit(f"train resume: {resumed} against the straight "
                         f"run's {straight}")
    p = make("p", 100, ckpt_every=1000)
    observe, seen = p.monitor.observe, [0]

    def stop_after(host, t):
        seen[0] += 1
        if seen[0] == c["stop_after"]:
            p._stop = True   # what the signal handler does
        return observe(host, t)

    p.monitor.observe = stop_after
    out = p.run()
    if not out["preempted"] or out["final_step"] != c["stop_after"] or \
            ckpt.latest_step(tmp / "p") != c["stop_after"]:
        raise SystemExit(f"train preemption: {out}, saved at "
                         f"{ckpt.latest_step(tmp / 'p')}")
    s = make("s", c["sketch_steps"], ckpt_every=c["sketch_steps"] // 2)
    s.run()
    before = s.token_stats.topk(8)
    s2 = make("s", c["sketch_steps"])
    if not s2.try_resume():
        raise SystemExit("train sketch: no checkpoint to resume")
    after = s2.token_stats.topk(8)
    if not (np.array_equal(before.items, after.items)
            and np.array_equal(before.counts, after.counts)
            and s2.token_stats.insertions == s.token_stats.insertions):
        raise SystemExit("train sketch: the token sketch did not survive "
                         "the resume")
    rec = dict(straight=straight, resumed=resumed,
               bit_for_bit=resumed == straight, rtol=RESUME_RTOL,
               preempted_at=out["final_step"],
               sketch_top=before.items.tolist())
    log(f"train resume and preemption: {json.dumps(rec)}")
    return rec


def train_phase(device, get=None, main=TRAIN_MAIN, moe=TRAIN_MOE,
                resume=TRAIN_RESUME, timed=True) -> tuple:
    """Training on the card (see TRAIN_MAIN, TRAIN_MOE, TRAIN_RESUME):
    Qwen3-0.6B at full width and depth through ``Trainer`` (``train_main``
    with its times), OLMoE at full width on 2 layers with its expert
    tracker, then the resume and preemption cases. ``get`` picks the
    configs (the full ones by default; the CPU rehearsal passes the smoke
    ones). Returns (launches of kernel 5 by path and of kernel 1 by
    layout, the phase's summary)."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch import configs

    get = get or configs.get
    device = torch.device(device)
    t_phase = time.perf_counter()
    launches = {"flash": {}, "fused": {}}
    with tempfile.TemporaryDirectory() as tmp:
        recs = {}
        for name, c, cfg in (
                ("main", main, get(main["arch"])),
                ("moe", moe, dataclasses.replace(get(moe["arch"]),
                                                 num_layers=moe["layers"]))):
            recs[name] = train_main(f"train {name} {cfg.name}", cfg, c,
                                    device, tmp,
                                    timed=timed and name == "main")
            for kind, key in (("flash", "flash_by_path"),
                              ("fused", "fused_by_layout")):
                for part, n in recs[name][key].items():
                    launches[kind][part] = launches[kind].get(part, 0) + n
        recs["moe"]["reduced"] = f"depth {moe['layers']} layers"
        recs["resume"] = train_resume(device, resume, tmp)
    recs["launches"] = launches
    recs["seconds"] = time.perf_counter() - t_phase
    log(f"train phase: {recs['seconds']:.1f} s, launches "
        f"{json.dumps(launches)}")
    return launches, recs


# ---------------------------------------------------------------------------
# The multi-tenant serving path: SketchService on kernel 1's partition layout
# ---------------------------------------------------------------------------

# the reference's service-bench parameters (benchmarks/bench_service.py:
# 289-305): 1,024 tenants of 8 counters, 16-bit items, blocks of 8,192,
# 200,000 updates at each delete ratio
TENANT_BENCH = dict(tenants=1024, k=8, bits=16, block=8192,
                    updates=200_000, ratios=(0.0, 0.5), oracle_rows=32,
                    twins=64, profile=dict(warm=4, ticks=8))
# a fleet: 32,768 tenants of 128 counters (4,194,304 counters, a 50 MB
# bank); tenant bits 15 + item bits 16 = 31, the composite-key limit, and
# (3 * 32,768 + 1) * 16,384 < 2^31, the partition prep's limit
TENANT_FLEET = dict(tenants=32768, k=128, bits=16, block=16384,
                    updates=4_194_304, ratio=0.5, window=8, spill_after=16,
                    subscribers=1024, m=16, point_queries=4096,
                    plain_blocks=4, oracle_rows=64, not_strict_rows=16,
                    profile=dict(warm=24, ticks=8))
# the quantile phase's sspm sizing (bits 24, eps 1e-3, alpha 2) over 256
# tenants x 2^16 items, on the default "bank" backend
TENANT_QUANTILE = dict(bits=24, tenant_bits=8, eps=1e-3, block=8192,
                       updates=1_000_000, subscribers=16, every=4,
                       qs=(0.01, 0.1, 0.25, 0.4, 0.5, 0.6, 0.75, 0.9, 0.99))
# Gemma3-27B's vocabulary (src/repro/configs/gemma3_27b.py:10) and
# OLMoE-1B-7B's 64 experts, top-8 routing (src/repro/configs/
# olmoe_1b_7b.py:9): 128 steps of 8 x 4,096 tokens
TENANT_STATS = dict(vocab=262_144, capacity=4096, window=64, steps=128,
                    tokens=8 * 4096, experts=64, top=8, phi=0.125)
# the shared traffic generator's shape: Zipf(1.2) tenant sizes, Zipf(1.0)
# items, bursts of 64, a query after 10 % of the bursts, 8 ids a query
TRAFFIC = dict(skew=1.2, item_skew=1.0, burst=64, query_frac=0.1,
               query_size=8)


def tenant_spec(tenants, k, bits):
    from repro_torch.sketch.api import SketchSpec

    return SketchSpec(kind="frequency", k=tenants * k, bits=bits,
                      tenants=tenants)


def traffic(tenants, updates, ratio, bits, seed):
    from repro_torch.core.streams import mixed_traffic

    return mixed_traffic(tenants, updates, delete_ratio=ratio,
                         universe=1 << bits, seed=seed, **TRAFFIC)


def traffic_stream(ops, item_bits):
    """The update ops as one (N, 2) stream of composite keys, in order."""
    import numpy as np

    ups = [op for op in ops if op[0] == "update"]
    keys = np.concatenate([(np.int64(op[1]) << item_bits) | op[2]
                           for op in ups])
    return np.stack([keys, np.concatenate([op[3] for op in ups])], axis=1)


def replay(svc, ops, block):
    """The reference bench's ``_replay`` (bench_service.py:63): submit each
    update, open a ticket for each query, tick whenever a block's worth of
    updates is pending, and tick once at the end. Returns (seconds,
    tickets, the service's block count when each ticket was answered)."""
    tickets, at, pending = [], [], 0
    t0 = time.perf_counter()
    for op in ops:
        if op[0] == "update":
            svc.submit(op[1], op[2], op[3])
            pending += len(op[2])
            if pending >= block:
                svc.tick()
                pending = 0
                at += [svc.stats["blocks"]] * (len(tickets) - len(at))
        else:
            tickets.append(svc.query(op[1], op[2]))
    svc.tick()
    secs = time.perf_counter() - t0
    at += [svc.stats["blocks"]] * (len(tickets) - len(at))
    return secs, tickets, at


def profile_service(svc, ops, block, warm, ticks) -> dict:
    """``replay`` of ``ops`` through ``svc`` profiled from tick ``warm`` to
    tick ``warm + ticks`` (every submit, query and tick in between), then
    ``ticks`` more ticks with the profiler off, and no further. Wall and
    device-busy ms per block (the kernels' and copies' own device time,
    as ``profile_blocks`` sums it) and the idle share 1 - busy / wall
    against the profiled and the unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ops, pending = iter(ops), 0

    def run(n):
        """Replay until ``n`` more ticks ran: (time, blocks) after them."""
        nonlocal pending
        while n:
            op = next(ops, None)
            if op is None:
                raise SystemExit(f"profile_service: {svc.stats['ticks']} "
                                 f"ticks, fewer than {warm + 2 * ticks}")
            if op[0] == "query":
                svc.query(op[1], op[2])
                continue
            svc.submit(op[1], op[2], op[3])
            pending += len(op[2])
            if pending >= block:
                pending = 0
                svc.tick()
                n -= 1
        torch.cuda.synchronize()
        return time.perf_counter(), svc.stats["blocks"]

    run(warm)
    cuda = svc.device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t0, b0 = time.perf_counter(), svc.stats["blocks"]
        t1, b1 = run(ticks)
    t1_off = time.perf_counter()
    t2, b2 = run(ticks)
    busy_us = sum(_dev_us(e) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = busy_us / 1e3 / (b1 - b0) if busy_us else None
    wall = (t1 - t0) * 1e3 / (b1 - b0)
    unprofiled = (t2 - t1_off) * 1e3 / (b2 - b1)
    return dict(ticks=ticks, blocks=b1 - b0, wall_ms_per_block=wall,
                unprofiled_wall_ms_per_block=unprofiled,
                device_busy_ms_per_block=busy,
                device_idle_share=1.0 - busy / wall if busy else None,
                device_idle_share_unprofiled=(1.0 - busy / unprofiled
                                              if busy else None))


def _tenant_router(spec, bank):
    from repro_torch.sketch.bank import TenantRouter

    shards = spec.shards or 1
    return TenantRouter(bank.ids.shape[0] // shards, spec.bits, shards)


def replay_blocks(spec, blocks, device, update, at=None):
    """The traced blocks, from the spec's empty bank, through the partition
    prep and ``update`` (kernel 1, or its plain version): the service's
    ingest outside the service. Returns the bank, and block ``at``'s kernel
    operands as they were before its update."""
    import torch
    from repro_torch.kernels.sketch_update import ops
    from repro_torch.sketch import api
    from repro_torch.sketch.state import SketchState

    bank = api.make(spec, device).bank
    router = _tenant_router(spec, bank)
    last = None
    for b, (ci, cw) in enumerate(blocks):
        it = torch.as_tensor(ci, device=device)
        w = torch.as_tensor(cw, device=device)
        if b == at:
            padded, prep = ops.prep_partition(bank, it, w, router,
                                              spec.variant_id)
            last = ([t.clone() for t in padded], list(prep))
        bank = ops.partition_update_with(update, bank, it, w, router,
                                         spec.variant_id)
    torch.cuda.synchronize()
    return SketchState(*bank), last


def touched_rows(spec, blocks, bank, device) -> list:
    """Per block: the rows its real (nonzero-weight) entries route to."""
    import torch

    router = _tenant_router(spec, bank)
    out = []
    for ci, cw in blocks:
        it = torch.as_tensor(ci[cw != 0], device=device)
        out.append(set(torch.unique(router.owner_of(it)).tolist()))
    return out


def check_oracle_rows(label, spec, blocks, bank, rows, device) -> int:
    """Each sampled row of the final bank equals the per-row oracle
    (``tenant.reference_row_update``: ``blocks.block_update`` on the row's
    routed view) run over the blocks that touch it: a block with no
    weight for the row leaves the row as it is. Returns the oracle's
    block updates."""
    from repro_torch.sketch import api
    from repro_torch.sketch import tenant as tn
    from repro_torch.sketch.state import SketchState

    router = _tenant_router(spec, bank)
    fresh = api.make(spec, device).bank
    hits = touched_rows(spec, blocks, bank, device)
    n = 0
    for r in rows:
        row = SketchState(*(t[r] for t in fresh))
        for (ci, cw), hit in zip(blocks, hits):
            if r in hit:
                row = tn.reference_row_update(row, ci, cw, router, r,
                                              spec.variant_id)
                n += 1
        if not _same(row, SketchState(*(t[r] for t in bank))):
            raise SystemExit(f"{label}: row {r} differs from the per-row "
                             f"oracle")
    return n


def check_twins(label, spec, blocks, state, tenants, device, k_solo=None,
                m=None) -> dict:
    """Sampled tenants against independent ``SketchSpec(k=k_t, bits)``
    sketches of the spec's variant (``k_solo`` counters where given) fed
    each block's fragment of the tenant: ``query_many`` on every item the
    tenant saw and ``tenant_topk`` against ``topk`` at m = k_t (or
    ``m``), bit for bit (the reference bench's ``_fused_vs_sessions``)."""
    import numpy as np
    import torch
    from repro_torch.sketch import api
    from repro_torch.sketch import tenant as tn
    from repro_torch.sketch.api import SketchSpec

    k_t = -(-spec.capacity // spec.tenants)
    m = m or k_t
    solo = SketchSpec(kind="frequency", k=k_solo or k_t, bits=spec.bits,
                      variant=spec.variant)
    twins = {int(t): api.make(solo, device) for t in tenants}
    seen = {t: [] for t in twins}
    for ci, cw in blocks:
        tt, items = tn.unpack_keys(ci, spec.bits)
        for t in twins:
            sel = (tt == t) & (cw != 0)
            if sel.any():
                twins[t] = api.update(solo, twins[t], items[sel], cw[sel])
                seen[t].append(items[sel])
    checked = 0
    for t, twin in twins.items():
        probe = (np.unique(np.concatenate(seen[t])) if seen[t]
                 else np.zeros(1, np.int32)).astype(np.int32)
        keys = tn.pack_keys(np.full(len(probe), t), probe,
                            spec.bits).astype(np.int32)
        got = api.query_many(spec, state, keys)
        if not torch.equal(got, api.query_many(solo, twin, probe)):
            raise SystemExit(f"{label}: tenant {t}'s queries differ from its "
                             f"independent sketch's")
        if not _same(api.tenant_topk(spec, state, t, m),
                     api.topk(solo, twin, m)):
            raise SystemExit(f"{label}: tenant {t}'s top-k differs from its "
                             f"independent sketch's")
        checked += len(probe)
    return dict(tenants=len(twins), keys=checked)


def strict_keys(blocks):
    """The keys carried by the blocks (ascending), their exact net counts,
    their positive weight, and whether each key's running count, block
    by block (a block's entries are aggregated before they act), never
    went below 0: the strict turnstile the bounded-deletion theorems
    assume. A window's expiry of a batch that inserted a key, while a
    later batch that deleted it is still live, breaks it."""
    import numpy as np

    nz = [cw != 0 for _, cw in blocks]
    keys = np.concatenate([ci[m] for (ci, _), m in zip(blocks, nz)])
    w = np.concatenate([cw[m] for (_, cw), m in zip(blocks, nz)]
                       ).astype(np.int64)
    bidx = np.repeat(np.arange(len(blocks)), [int(m.sum()) for m in nz])
    order = np.lexsort((bidx, keys))
    k_s, b_s, w_s = keys[order], bidx[order], w[order]
    new = np.ones(len(k_s), bool)
    new[1:] = (k_s[1:] != k_s[:-1]) | (b_s[1:] != b_s[:-1])
    starts = np.flatnonzero(new)
    kb_net = np.add.reduceat(w_s, starts)
    kb_key = k_s[starts]
    head = np.flatnonzero(np.r_[True, kb_key[1:] != kb_key[:-1]])
    run = np.cumsum(kb_net)
    before = np.r_[0, run][head]
    prefix = run - np.repeat(before, np.diff(np.r_[head, len(run)]))
    uniq = kb_key[head]
    net = np.add.reduceat(kb_net, head)
    pos = np.add.reduceat(np.maximum(w_s, 0), np.flatnonzero(
        np.r_[True, k_s[1:] != k_s[:-1]]))
    return uniq, net, pos, np.minimum.reduceat(prefix, head) >= 0


def check_tenant_truth(label, spec, blocks, bank, device, factor=2.0):
    """Every tenant row within its Thm 4 bound ``2 * I_row / k_row``
    (I_row: the positive weight its keys took, expiries of deletions
    included; k_row: its live counters) against the exact net count of
    every key the blocks carried, and every key above its row's bound
    monitored; rows holding a key whose running count went below 0 (not
    strict turnstile, outside the theorem's hypothesis) are left out.
    Returns (worst error over bound, keys above their bound, rows left
    out), which rows are held, and the left-out rows with a key over its
    bound (for the per-row oracle)."""
    import numpy as np
    import torch
    from repro_torch.sketch import api
    from repro_torch.sketch import tenant as tn

    uniq, net, pos, strict = strict_keys(blocks)
    router = _tenant_router(spec, bank)
    owner = router.owner_of(torch.as_tensor(uniq, device=device)).cpu().numpy()
    R = bank.ids.shape[0]
    ins = np.bincount(owner, weights=pos, minlength=R)
    bound = factor * ins / live_counters(bank)
    held = np.ones(R, bool)
    held[owner[~strict]] = False
    state = tn.TenantBank(bank=bank)
    est = np.concatenate([
        api.query_many(spec, state, torch.as_tensor(
            uniq[s:s + (1 << 20)], device=device)).cpu().numpy()
        for s in range(0, len(uniq), 1 << 20)]).astype(np.int64)
    err = np.abs(est - net)
    over = (err > bound[owner]) & held[owner]
    if over.any():
        i = int(np.argmax(np.where(held[owner], err - bound[owner], -np.inf)))
        raise SystemExit(f"{label}: key {uniq[i]}: error {err[i]} > bound "
                         f"{bound[owner][i]}")
    hot = (net > bound[owner]) & held[owner]
    if (hot & (est <= 0)).any():
        raise SystemExit(f"{label}: a key above its row's bound is not "
                         f"monitored")
    live = (bound[owner] > 0) & held[owner]
    broken = np.unique(owner[(err > bound[owner]) & ~held[owner]])
    return ((float((err[live] / bound[owner][live]).max()) if live.any()
             else 0.0), int(hot.sum()), int((~held).sum())), held, broken


def live_counters(bank):
    """Each row's live (not BLOCKED) counters, on the host."""
    from repro_torch.sketch.state import BLOCKED

    return (bank.ids != BLOCKED).sum(dim=1).cpu().numpy()


def _before(groups, bidx, vals, n_blocks, q_groups, q_at):
    """Each query's group total of ``vals`` over the blocks before
    ``q_at`` (entries of block ``bidx``)."""
    import numpy as np

    code = groups * (n_blocks + 1) + bidx
    order = np.argsort(code, kind="stable")
    code, v = code[order], vals[order]
    g = code // (n_blocks + 1)
    cum = np.cumsum(v)
    first = np.maximum.accumulate(np.where(
        np.r_[True, g[1:] != g[:-1]], np.arange(len(g)), 0))
    total = cum - (cum[first] - v[first])
    i = np.searchsorted(code, q_groups * (n_blocks + 1) + q_at) - 1
    j = np.maximum(i, 0)
    return np.where((i >= 0) & (g[j] == q_groups), total[j], 0)


def check_ticket_bounds(label, spec, blocks, bank, tickets, at, held,
                        device, factor=2.0) -> dict:
    """Every ticket's answers within the Thm 4 bound of its row at the
    moment it was answered, after ``at`` of the blocks: exact net counts
    and the row's positive weight over those blocks; ``bank`` gives the
    rows' live counters, ``held`` the rows held (strict turnstile over
    all blocks, so over every prefix)."""
    import numpy as np
    import torch
    from repro_torch.sketch import tenant as tn

    if not tickets:
        return dict(ticket_ids_held=0, ticket_ids_left_out=0)
    nz = [cw != 0 for _, cw in blocks]
    keys = np.concatenate([ci[m] for (ci, _), m in zip(blocks, nz)]
                          ).astype(np.int64)
    w = np.concatenate([cw[m] for (_, cw), m in zip(blocks, nz)]
                       ).astype(np.int64)
    bidx = np.repeat(np.arange(len(blocks)), [int(m.sum()) for m in nz])
    router = _tenant_router(spec, bank)

    def row_of(k):
        return router.owner_of(torch.as_tensor(
            k.astype(np.int32), device=device)).cpu().numpy().astype(np.int64)

    sizes = [len(t.items) for t in tickets]
    q_keys = tn.pack_keys(np.repeat([t.tenant for t in tickets], sizes),
                          np.concatenate([t.items for t in tickets]),
                          spec.bits).astype(np.int64)
    q_at = np.repeat(np.asarray(at, np.int64), sizes)
    q_row = row_of(q_keys)
    est = np.concatenate([t.result() for t in tickets]).astype(np.int64)
    exact = _before(keys, bidx, w, len(blocks), q_keys, q_at)
    ins = _before(row_of(keys), bidx, np.maximum(w, 0), len(blocks), q_row,
                  q_at)
    bound = factor * ins / live_counters(bank)[q_row]
    err = np.abs(est - exact)
    keep = held[q_row]
    over = keep & (err > bound)
    if over.any():
        i = int(np.flatnonzero(over)[0])
        raise SystemExit(f"{label}: a ticket's key {q_keys[i]} after block "
                         f"{q_at[i]}: error {err[i]} > bound {bound[i]}")
    live = keep & (bound > 0)
    return dict(ticket_ids_held=int(keep.sum()),
                ticket_ids_left_out=int((~keep).sum()),
                worst_ticket_err_over_bound=(
                    float((err[live] / bound[live]).max()) if live.any()
                    else 0.0))


def batched_query_ms(spec, state, keys, reps=20) -> float:
    """ms of one ``api.query_many`` on ``keys`` (a device tensor), CUDA
    events over ``reps`` calls after a warm-up."""
    import torch
    from repro_torch.sketch import api

    api.query_many(spec, state, keys)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        api.query_many(spec, state, keys)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _fused_layout_of(k) -> str:
    from repro_torch.kernels.sketch_update import kernel
    from repro_torch.sketch.state import LANES

    return kernel.fused_layout(-(-k // LANES) * LANES)


def service_record(label, svc, secs, tickets, launches) -> dict:
    import numpy as np

    lat = [t.latency_s for t in tickets]
    return dict(label=label, kernel="sketch_update_kernel_fused",
                layout=_fused_layout_of(svc.session.state.bank.ids.shape[1]),
                blocks=svc.stats["blocks"], launches=launches,
                rows=svc.session.state.bank.ids.shape[0],
                k_per_row=svc.session.state.bank.ids.shape[1],
                updates=svc.stats["updates"], ticks=svc.stats["ticks"],
                ms_per_block=secs * 1e3 / svc.stats["blocks"],
                updates_per_s=svc.stats["updates"] / secs,
                tickets=len(tickets), query_ids=svc.stats["queries"],
                p99_ticket_ms=(float(np.percentile(lat, 99)) * 1e3
                               if lat else None))


def service_bench(device) -> tuple:
    """The reference's service bench shape at delete ratios 0.0 and 0.5:
    the replay through ``SketchService`` (one kernel-1 launch a block), its
    bank held to the plain version over every traced block, sampled rows
    to the per-row oracle and sampled tenants to independent sketches.
    Returns (records, block operands for the kernel's times, the service
    profiles to run later as (label, thunk))."""
    import numpy as np
    import torch
    from repro_torch.kernels.sketch_update import ref
    from repro_torch.serve import SketchService
    from repro_torch.sketch import session as ses

    c = TENANT_BENCH
    spec = tenant_spec(c["tenants"], c["k"], c["bits"])
    rng = np.random.default_rng(31)
    entries0 = ses.ingest_cache_stats()["entries"]
    out, last, later = {}, None, []
    for ratio in c["ratios"]:
        label = f"service bench delete={ratio}"
        ops = traffic(c["tenants"], c["updates"], ratio, c["bits"],
                      seed=int(ratio * 10) + 1)
        svc = SketchService(spec, block=c["block"], device=device)
        svc.trace_blocks = []
        reset_counts()
        secs, tickets, at = replay(svc, ops, c["block"])
        torch.cuda.synchronize()
        rec = service_record(label, svc, secs, tickets, check_launches(
            label, read_counts(), "sketch_update_kernel_fused",
            svc.stats["blocks"], _fused_layout_of(c["k"])))
        blocks, bank = svc.trace_blocks, svc.session.state.bank
        t0 = time.perf_counter()
        plain, last = replay_blocks(spec, blocks, device, ref.fused_update_ref,
                                    at=len(blocks) - 1)
        if not _same(plain, bank):
            raise SystemExit(f"{label}: the bank differs from the plain "
                             f"version's over the traced blocks")
        rec["plain_ms_per_block"] = (time.perf_counter() - t0) * 1e3 \
            / len(blocks)
        rows = rng.choice(bank.ids.shape[0], c["oracle_rows"], replace=False)
        rec["oracle_rows"] = len(rows)
        rec["oracle_updates"] = check_oracle_rows(label, spec, blocks, bank,
                                                  rows, device)
        rec["twins"] = check_twins(label, spec, blocks, svc.session.state,
                                   rng.choice(c["tenants"], c["twins"],
                                              replace=False), device)
        (rec["worst_err_over_bound"], rec["keys_above_bound"],
         left_out), held, _ = check_tenant_truth(label, spec, blocks, bank,
                                                 device)
        if left_out:
            raise SystemExit(f"{label}: {left_out} rows of a stream with no "
                             f"window are not strict turnstile")
        rec.update(check_ticket_bounds(label, spec, blocks, bank, tickets,
                                       at, held, device))
        keys = torch.as_tensor(traffic_stream(ops, c["bits"])[:4096, 0]
                               .astype(np.int32), device=device)
        rec["batched_4096_query_ms"] = batched_query_ms(spec,
                                                        svc.session.state,
                                                        keys)
        rec["batched_queries_per_s"] = 4096 / rec["batched_4096_query_ms"] \
            * 1e3
        later.append((label, lambda spec=spec, ops=ops: profile_service(
            SketchService(spec, block=c["block"], device=device), ops,
            c["block"], **c["profile"])))
        out[label] = rec
        log(f"{label}: {json.dumps(rec)}")
    added = ses.ingest_cache_stats()["entries"] - entries0
    if added > 1:
        raise SystemExit(f"the service bench added {added} compiled-ingest "
                         f"cells; one layout takes one")
    return out, last, later


def _timed(fn, times):
    """``fn`` wrapped to append its synchronised ms to ``times``."""
    import torch

    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def service_fleet(device) -> tuple:
    """The fleet through two services on the same traffic: ``main`` spills
    idle tenants (``spill_after``), refreshes 1,024 top-k subscriptions a
    tick and is saved and loaded into a new service halfway; ``twin`` does
    none of these. Held: both feed the same blocks, kernel 1 once a block
    in each; kernel and plain version equal over the first blocks; sampled
    rows, and the rows not strict turnstile that break the bound with a
    sample of the others, equal the per-row oracle; every strict row of
    both within its Thm 4 bound at the end, and every ticket of ``main``
    within its row's bound when it was answered; every subscription equal
    to a direct ``tenant_topk``; every tenant never spilled bit for bit
    equal to the twin's rows (the save and load included); every tenant
    spilled and not touched since re-admitted content-exact (queries and
    top-k counts equal the twin's), and every ticket of a tenant never
    re-admitted equal to the twin's. Tenants re-admitted and then updated
    again keep their content but not their slot order, so a later
    eviction among equal counts may differ from the twin's: they are
    counted, and held to the bound (their tickets and their rows)."""
    import numpy as np
    import torch
    from repro_torch.kernels.sketch_update import kernel, ref
    from repro_torch.serve import SketchService
    from repro_torch.sketch import api
    from repro_torch.sketch import tenant as tn

    c = TENANT_FLEET
    spec = tenant_spec(c["tenants"], c["k"], c["bits"])
    ops = traffic(c["tenants"], c["updates"], c["ratio"], c["bits"], seed=5)
    half = len(ops) // 2
    kw = dict(block=c["block"], window=c["window"], device=device)
    rng = np.random.default_rng(32)
    subs = rng.choice(c["tenants"], c["subscribers"], replace=False)
    spills, admits, spilled, admitted = [], [], set(), set()

    def subscribed(svc):
        for t in subs:
            svc.subscribe_topk(int(t), c["m"])
        return svc

    def service():
        svc = subscribed(SketchService(spec, spill_after=c["spill_after"],
                                       **kw))
        svc.trace_blocks = []
        spill, admit = _timed(svc._spill, spills), _timed(svc._admit, admits)
        svc._spill = lambda t: (spilled.add(t), spill(t))
        svc._admit = lambda t: (admitted.add(t), admit(t))
        return svc

    layout = _fused_layout_of(c["k"])
    main = service()
    reset_counts()
    secs, tickets, at = replay(main, ops[:half], c["block"])
    t0 = time.perf_counter()
    saved = main.save()
    main2 = service()
    main2.load(saved)
    save_load_s = time.perf_counter() - t0
    secs2, tickets2, at2 = replay(main2, ops[half:], c["block"])
    torch.cuda.synchronize()
    blocks_main = main.stats["blocks"] + main2.stats["blocks"]
    launches = check_launches("service fleet", read_counts(),
                              "sketch_update_kernel_fused", blocks_main,
                              layout)
    rec_main = service_record("service fleet", main2, secs + secs2,
                              tickets + tickets2, launches)
    rec_main.update(blocks=blocks_main, save_load_s=save_load_s,
                    updates=main.stats["updates"] + main2.stats["updates"],
                    ticks=main.stats["ticks"] + main2.stats["ticks"],
                    query_ids=main.stats["queries"] + main2.stats["queries"],
                    spills=len(spills), admits=len(admits),
                    spill_ms_mean=float(np.mean(spills)) if spills else None,
                    admit_ms_mean=float(np.mean(admits)) if admits else None,
                    ms_per_block=(secs + secs2) * 1e3 / blocks_main,
                    updates_per_s=(main.stats["updates"]
                                   + main2.stats["updates"]) / (secs + secs2))
    tickets += tickets2
    at += [a + main.stats["blocks"] for a in at2]
    main_blocks = main.trace_blocks + main2.trace_blocks
    twin = SketchService(spec, **kw)
    twin.trace_blocks = []
    reset_counts()
    t_secs, t_tickets, _ = replay(twin, ops[:half], c["block"])
    t_secs2, t_tickets2, _ = replay(twin, ops[half:], c["block"])
    torch.cuda.synchronize()
    rec_twin = service_record(
        "service fleet twin", twin, t_secs + t_secs2, t_tickets + t_tickets2,
        check_launches("service fleet twin", read_counts(),
                       "sketch_update_kernel_fused", twin.stats["blocks"],
                       layout))
    blocks, bank = twin.trace_blocks, twin.session.state.bank
    if len(main_blocks) != len(blocks) or not all(
            np.array_equal(x, y) for a, b in zip(main_blocks, blocks)
            for x, y in zip(a, b)):
        raise SystemExit("service fleet: the spilled and reloaded service "
                         "fed other blocks than the twin")
    del main_blocks
    for a, b in zip(tickets, t_tickets + t_tickets2):
        if a.tenant not in admitted and not np.array_equal(a.result(),
                                                           b.result()):
            raise SystemExit(f"service fleet: a ticket of tenant "
                             f"{a.tenant} differs from the twin's")
    # the kernel against its plain version over the first blocks, and
    # over all blocks outside the service against the twin's bank (the
    # last block's operands are kept for the kernel's times)
    n = min(c["plain_blocks"], len(blocks))
    got, _ = replay_blocks(spec, blocks[:n], device,
                           kernel.sketch_update_kernel_fused)
    want, _ = replay_blocks(spec, blocks[:n], device, ref.fused_update_ref)
    if not _same(got, want):
        raise SystemExit(f"service fleet: kernel 1 differs from its plain "
                         f"version over the first {n} blocks")
    got, last = replay_blocks(spec, blocks, device,
                              kernel.sketch_update_kernel_fused,
                              at=len(blocks) - 1)
    if not _same(got, bank):
        raise SystemExit("service fleet: kernel 1 outside the service "
                         "differs from the twin's bank")
    (rec_twin["worst_err_over_bound"], rec_twin["keys_above_bound"],
     rec_twin["rows_not_strict"]), held, broken = check_tenant_truth(
        "service fleet twin", spec, blocks, bank, device)
    # the per-row oracle: sampled rows, then every row not strict
    # turnstile with a key over its bound and a sample of the other rows
    # not strict (the bound does not hold there; the oracle does)
    rows = np.concatenate([np.arange(4), rng.choice(
        np.arange(4, bank.ids.shape[0]), c["oracle_rows"] - 4,
        replace=False)])
    rec_twin["oracle_rows"] = len(rows)
    rec_twin["oracle_updates"] = check_oracle_rows(
        "service fleet twin", spec, blocks, bank, rows, device)
    others = np.setdiff1d(np.flatnonzero(~held), broken)
    extra = np.concatenate([broken, rng.choice(
        others, min(c["not_strict_rows"], len(others)), replace=False)])
    t0 = time.perf_counter()
    rec_twin.update(
        rows_not_strict_over_bound=len(broken),
        oracle_rows_not_strict=len(extra),
        oracle_updates_not_strict=check_oracle_rows(
            "service fleet twin (rows not strict)", spec, blocks, bank,
            extra, device),
        oracle_not_strict_s=time.perf_counter() - t0)
    rec_twin["plain_blocks"] = n
    # subscriptions: refreshed at the last tick, as a direct tenant_topk
    items, vals = tn.topk_tenants(
        main2.session.state, torch.as_tensor(subs, dtype=torch.int32,
                                             device=device),
        c["m"], num_shards=1, item_bits=c["bits"])
    for i, t in enumerate(subs.tolist()):
        got_i, got_v = main2.topk_result(t)
        if not (np.array_equal(got_i, items[i].cpu().numpy())
                and np.array_equal(got_v, vals[i].cpu().numpy())):
            raise SystemExit(f"service fleet: tenant {t}'s subscription "
                             f"differs from a direct top-k")
    # main against the twin: never spilled rows bit for bit; spilled and
    # untouched since, content-exact once re-admitted
    never = torch.as_tensor(
        np.setdiff1d(np.arange(c["tenants"]), list(spilled)), device=device)
    if not _same(rows_of(main2.session.state.bank, never),
                 rows_of(bank, never)):
        raise SystemExit("service fleet: a tenant that never spilled differs "
                         "from the twin")
    again = sorted(admitted)
    cold = sorted(set(main2._spilled) - admitted)
    for t in list(main2._spilled):
        main2._admit(t)
    state = main2.session.state
    probe_keys = np.unique(traffic_stream(ops, c["bits"])[:, 0])
    owner = probe_keys >> c["bits"]
    cold_keys = probe_keys[np.isin(owner, cold)].astype(np.int32)
    if len(cold_keys):
        kt = torch.as_tensor(cold_keys, device=device)
        if not torch.equal(api.query_many(spec, state, kt),
                           api.query_many(spec, twin.session.state, kt)):
            raise SystemExit("service fleet: a re-admitted tenant's queries "
                             "differ from the twin's")
        tk = torch.as_tensor(cold, dtype=torch.int32, device=device)
        v_m = tn.topk_tenants(state, tk, c["m"], num_shards=1,
                              item_bits=c["bits"])[1]
        v_t = tn.topk_tenants(twin.session.state, tk, c["m"], num_shards=1,
                              item_bits=c["bits"])[1]
        if not torch.equal(v_m, v_t):
            raise SystemExit("service fleet: a re-admitted tenant's top-k "
                             "counts differ from the twin's")
    # re-admitted earlier, then updated again: content kept, slot order
    # not; held to the bound with every other row, and every ticket
    same_again = 0
    if again:
        keys = probe_keys[np.isin(owner, again)].astype(np.int32)
        kt = torch.as_tensor(keys, device=device)
        eq = (api.query_many(spec, state, kt)
              == api.query_many(spec, twin.session.state, kt)).cpu().numpy()
        same_again = len(again) - len(np.unique(keys[~eq] >> c["bits"]))
    (rec_main["worst_err_over_bound"], rec_main["keys_above_bound"],
     rec_main["rows_not_strict"]), held_main, _ = check_tenant_truth(
        "service fleet", spec, blocks, state.bank, device)
    rec_main.update(check_ticket_bounds("service fleet", spec, blocks,
                                        state.bank, tickets, at, held_main,
                                        device))
    rec_main.update(never_spilled=len(never), spilled_untouched=len(cold),
                    readmitted=len(again),
                    readmitted_equal_to_twin=same_again)
    keys = torch.as_tensor(probe_keys[rng.choice(len(probe_keys),
                                                 c["point_queries"])]
                           .astype(np.int32), device=device)
    rec_twin["batched_query_ms"] = batched_query_ms(spec, twin.session.state,
                                                    keys)
    rec_twin["batched_queries_per_s"] = (c["point_queries"]
                                         / rec_twin["batched_query_ms"] * 1e3)
    for rec in (rec_main, rec_twin):
        log(f"{rec['label']}: {json.dumps(rec)}")
    # the service's device busy and idle share over a window of ticks:
    # the twin's configuration and main's (spill and subscriptions)
    later = [("service fleet twin", lambda: profile_service(
                 SketchService(spec, **kw), ops, c["block"], **c["profile"])),
             ("service fleet", lambda: profile_service(
                 subscribed(SketchService(
                     spec, spill_after=c["spill_after"], **kw)),
                 ops, c["block"], **c["profile"]))]
    return ({"service fleet": rec_main, "service fleet twin": rec_twin},
            last, later)


def rows_of(bank, rows):
    from repro_torch.sketch.state import SketchState

    return SketchState(*(t[rows] for t in bank))


def quantile_service(device) -> dict:
    """Quantile mode: ``SketchService`` over the dyadic sspm spec with
    tenant_bits = 8 (the dense core, kernel 2, once a block), 16 tenants
    subscribed to 9 quantiles every 4 ticks; every answer within twice the
    single-rank bound (2 eps |F|_1 + 1 in rank) of numpy's exact
    per-tenant quantile, as ``tests/test_tenant.py:343`` holds it, and
    equal to a direct ``quantile`` call."""
    import numpy as np
    import torch
    from repro_torch.kernels.sketch_update import kernel
    from repro_torch.serve import SketchService
    from repro_torch.sketch.api import SketchSpec

    c = TENANT_QUANTILE
    label = "service quantile"
    spec = SketchSpec(kind="quantile", bits=c["bits"], eps=c["eps"],
                      alpha=2.0)
    item_bits = c["bits"] - c["tenant_bits"]
    T = 1 << c["tenant_bits"]
    ops = traffic(T, c["updates"], 0.5, item_bits, seed=6)
    svc = SketchService(spec, block=c["block"], tenant_bits=c["tenant_bits"],
                        device=device)
    svc.trace_blocks = []
    subs = list(range(c["subscribers"]))
    for t in subs:
        svc.subscribe_quantile(t, c["qs"], every=c["every"])
    layout = kernel.banked_layout(max(spec.layer_capacities()))
    reset_counts()
    secs, tickets, _ = replay(svc, ops, c["block"])
    torch.cuda.synchronize()
    rec = service_record(label, svc, secs, tickets, check_launches(
        label, read_counts(), "sketch_residual_kernel_banked",
        svc.stats["blocks"], layout))
    rec.update(kernel="sketch_residual_kernel_banked", layout=layout)
    # empty ticks until the subscriptions' last refresh is the last tick
    while svc.tick_count % c["every"] != 1:
        svc.tick()
    keys = np.concatenate([ci[cw != 0] for ci, cw in svc.trace_blocks])
    w = np.concatenate([cw[cw != 0] for ci, cw in svc.trace_blocks])
    freq = np.bincount(keys, weights=w, minlength=1 << c["bits"])
    mass = int(freq.sum())
    if int(svc.session.state.mass) != mass:
        raise SystemExit(f"{label}: the bank's mass is not the stream's")
    slack = 2 * c["eps"] * mass + 1
    for t in subs:
        cum = np.cumsum(freq[t << item_bits:(t + 1) << item_bits]
                        .astype(np.int64))
        got = svc.quantile_result(t)
        check_quantiles(f"{label} tenant {t}", got, c["qs"], cum,
                        slack / max(int(cum[-1]), 1))
        if not np.array_equal(got, svc.quantile(t, c["qs"])):
            raise SystemExit(f"{label}: tenant {t}'s subscription differs "
                             f"from a direct quantile call")
    rec.update(subscribers=len(subs), mass=mass, rank_slack=slack)
    log(f"{label}: {json.dumps(rec)}")
    return {label: rec}


def shared_cell(device) -> dict:
    """Tenant specs that differ only in the tenant count or the caps share
    one compiled-ingest cell on the card, with one CUDA graph per state
    shape ((1,024, 8) and (2,048, 4)); sessions of the three take blocks
    in turns, and each bank equals the plain version on its own blocks and
    answers its own queries."""
    import numpy as np
    import torch
    from repro_torch.kernels.sketch_update import ref
    from repro_torch.sketch import api
    from repro_torch.sketch import session as ses
    from repro_torch.sketch.api import SketchSpec
    from repro_torch.sketch.session import StreamSession

    c = TENANT_BENCH
    T, bits, B = c["tenants"], c["bits"], c["block"]
    specs = [tenant_spec(T, c["k"], bits),
             SketchSpec(kind="frequency", k=T * c["k"], bits=bits,
                        tenants=2 * T),
             SketchSpec(kind="frequency", bits=bits, tenants=T,
                        tenant_caps=(c["k"],) * T)]
    entries0 = ses.ingest_cache_stats()["entries"]
    sessions = [StreamSession(sp, block=B, device=device) for sp in specs]
    added = ses.ingest_cache_stats()["entries"] - entries0
    cell = sessions[0]._compiled
    if added > 1 or any(s._compiled is not cell for s in sessions):
        raise SystemExit(f"shared cell: the tenant specs took {added} cells")
    streams = [padded_blocks(traffic_stream(traffic(
        sp.tenants, 3 * B, 0.5, bits, seed=40 + i), bits), B)
        for i, sp in enumerate(specs)]
    n = min(len(it) for it, _ in streams)
    reset_counts()
    for b in range(n):
        for sess, (it, w) in zip(sessions, streams):
            sess.ingest_block(it[b], w[b])
    launches = check_launches("shared cell", read_counts(),
                              "sketch_update_kernel_fused", n * len(specs),
                              _fused_layout_of(c["k"]))
    shapes = sorted(tuple(k[0]) for k in cell.graphs)
    # the card's cell holds a graph per shape (the CPU's ingest is eager)
    if device.type == "cuda" and not {(T, c["k"]),
                                      (2 * T, c["k"] // 2)} <= set(shapes):
        raise SystemExit(f"shared cell: graphs of shapes {shapes}")
    for sp, sess, (it, w) in zip(specs, sessions, streams):
        want, _ = replay_blocks(sp, list(zip(it[:n], w[:n])), device,
                                ref.fused_update_ref)
        if not _same(sess.state.bank, want):
            raise SystemExit(f"shared cell: the session of {sp.tenants} "
                             f"tenants differs from the plain version")
        keys = np.unique(it[:n][w[:n] != 0]).astype(np.int32)
        if not torch.equal(sess.query_many(keys), api.query_many(
                sp, type(sess.state)(bank=want), keys)):
            raise SystemExit("shared cell: a session's queries differ")
    rec = dict(label="shared cell", kernel="sketch_update_kernel_fused",
               layout=_fused_layout_of(c["k"]), blocks=n * len(specs),
               launches=launches, cells_added=added, graph_shapes=shapes)
    log(f"shared cell: {json.dumps(rec)}")
    return {"shared cell": rec}


def stats_phase(device) -> dict:
    """``TokenStats`` over Gemma3-27B's vocabulary and ``ExpertLoadStats``
    over OLMoE-1B-7B's experts on the same steps: Zipf(1.0) tokens, each
    routed to its 8 experts by a fixed table (a skewed router: Gumbel
    noise over a preference falling as 1/rank). Each tracker's kernel-1
    launches are its session's blocks. Held against the exact windowed
    counts: ``topk(16)`` within the Thm 4 bound 2 I / k, with every token
    whose count clears the 17th largest by twice the bound reported; the
    expert tracker within the same bound on every expert it reports, and
    ``hot_experts(0.125)`` holding every expert at or above an eighth of
    the windowed load (with top-8 routing no expert holds more than an
    eighth, so that set is small or empty, and the check can show
    nothing). At phi = half the top expert's share, which the traffic
    crosses, the default tracker (32 counters for 64 experts) is only
    measured against the exact set: its bound, 2 I / k, is above every
    expert's load. A tracker with a counter per expert
    (``capacity=64``) on the same steps holds every expert exactly, so
    its ``hot_experts`` there must be the exact set."""
    import numpy as np
    import torch
    from repro_torch.core.streams import zipf_insertions
    from repro_torch.sketch.stats import ExpertLoadStats, TokenStats

    c = TENANT_STATS
    V, E = c["vocab"], c["experts"]
    rng = np.random.default_rng(33)
    pref = -np.log(np.arange(1, E + 1, dtype=np.float32))
    route = np.argpartition(-(pref + rng.gumbel(size=(V, E))
                              .astype(np.float32)), c["top"], axis=1)[:, :c["top"]]
    ts = TokenStats(capacity=c["capacity"], window=c["window"], device=device)
    es = ExpertLoadStats(num_experts=E, window=c["window"], device=device)
    every_expert = ExpertLoadStats(num_experts=E, capacity=E,
                                   window=c["window"], device=device)
    steps = [zipf_insertions(c["tokens"], V, 1.0, seed=100 + s)
             for s in range(c["steps"])]
    loads = [np.bincount(route[tok].ravel(), minlength=E) for tok in steps]
    out = {}
    for label, tracker, feed in (("stats tokens", ts, steps),
                                 ("stats experts", es, loads),
                                 ("stats experts capacity=64", every_expert,
                                  loads)):
        reset_counts()
        t0 = time.perf_counter()
        for x in feed:
            tracker.update(x)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[label] = dict(
            label=label, kernel="sketch_update_kernel_fused",
            layout=_fused_layout_of(tracker.capacity),
            blocks=tracker.bank.blocks_ingested,
            launches=check_launches(label, read_counts(),
                                    "sketch_update_kernel_fused",
                                    tracker.bank.blocks_ingested,
                                    _fused_layout_of(tracker.capacity)),
            steps=len(feed), ms_per_step=secs * 1e3 / len(feed),
            insertions=tracker.insertions, deletions=tracker.deletions)
    window = steps[-c["window"]:]
    exact = np.bincount(np.concatenate(window), minlength=V)
    bound = 2 * ts.insertions / c["capacity"]
    rep = ts.topk(16)
    err = np.abs(rep.counts.astype(np.int64) - exact[rep.items])
    if (err > bound).any() or len(rep.items) != 16:
        raise SystemExit(f"stats tokens: top-16 counts off by {err.max()} > "
                         f"the Thm 4 bound {bound}")
    top = np.sort(exact)[::-1]
    must = np.flatnonzero(exact > top[16] + 2 * bound)
    if not set(must.tolist()) <= set(rep.items.tolist()):
        raise SystemExit("stats tokens: a token clear of the 17th count by "
                         "twice the bound is missing from the top-16")
    out["stats tokens"].update(bound=bound, worst_err=int(err.max()),
                               clear_tokens=len(must))
    load = np.sum(loads[-c["window"]:], axis=0)
    live = es.insertions - es.deletions
    if live != int(load.sum()):
        raise SystemExit("stats experts: the live mass is not the window's")
    ebound = 2 * es.insertions / es.capacity
    every = es.hot_experts(0.0)
    err = np.abs(every.counts.astype(np.int64) - load[every.items])
    if (err > ebound).any():
        raise SystemExit(f"stats experts: an expert's load is off by "
                         f"{err.max()} > the Thm 4 bound {ebound}")
    hot = es.hot_experts(c["phi"])
    want = np.flatnonzero(load >= c["phi"] * live)
    if not set(want.tolist()) <= set(hot.items.tolist()):
        raise SystemExit("stats experts: an expert above phi of the windowed "
                         "load is not reported hot")
    top_share = float(load.max() / live)
    phi = top_share / 2
    want_half = set(np.flatnonzero(load >= phi * live).tolist())
    got_half = set(es.hot_experts(phi).items.tolist())
    out["stats experts"].update(
        bound=ebound, worst_err=int(err.max()), hot=len(hot.items),
        hot_exact=len(want), top_share=top_share, half_phi=phi,
        half_hot=len(got_half), half_hot_exact=len(want_half),
        half_hot_found=len(got_half & want_half))
    exact = every_expert.hot_experts(phi)
    if (not want_half or set(exact.items.tolist()) != want_half
            or not np.array_equal(exact.counts, load[exact.items])):
        raise SystemExit(f"stats experts capacity=64: hot_experts({phi}) is "
                         f"not the exact set of {len(want_half)} experts")
    out["stats experts capacity=64"].update(half_phi=phi,
                                            hot_exact=len(want_half))
    for rec in out.values():
        log(f"{rec['label']}: {json.dumps(rec)}")
    return out


def tenant_phase(device) -> tuple:
    """The multi-tenant serving path: the service bench shape, the fleet,
    quantile mode, tenant layouts sharing a cell, and the windowed
    trackers. Returns (records by label, kernel-1 operands of the bench
    shape's last block and of the fleet's, for the times, and the service
    profiles as (label, thunk): ``main`` runs them after every other
    timing, so no profiler session of theirs precedes another)."""
    out, last_bench, later = service_bench(device)
    fleet, last_fleet, later_fleet = service_fleet(device)
    out.update(fleet)
    out.update(quantile_service(device))
    out.update(shared_cell(device))
    out.update(stats_phase(device))
    return out, {"bench": last_bench, "fleet": last_fleet}, \
        later + later_fleet


def service_profiles(later, runs) -> None:
    """Run the tenant phase's service profiles into their records."""
    for label, profiled in later:
        runs[label]["profile"] = profiled()
        log(f"profile {label} (service ticks): "
            f"{json.dumps(runs[label]['profile'])}")


def tenant_times(operands, device) -> dict:
    """Kernel 1 on the tenant layouts (R = 1,024 and 32,768 rows) with its
    bound and plain version's ms (``time_kernel``); ``_pad_bank``'s ms on
    each bank against the device-busy ms per block of a profiled captured
    tenant ingest (``profile_blocks`` on the layout's own traffic)."""
    import torch
    from repro_torch.kernels.sketch_update import kernel, ref
    from repro_torch.kernels.sketch_update.ops import _pad_bank
    from repro_torch.sketch.state import SketchState

    out = {}
    for name, c, seed in (("bench", TENANT_BENCH, 1), ("fleet", TENANT_FLEET,
                                                       5)):
        st, args = operands[name]
        t = time_kernel(kernel.sketch_update_kernel_fused,
                        ref.fused_update_ref, (st, args), 2, fused_bound,
                        10, 1)
        t["rows"] = st[0].shape[0]
        spec = tenant_spec(c["tenants"], c["k"], c["bits"])
        bank = SketchState(*(x[:, :c["k"]].contiguous() for x in st))
        _pad_bank(bank)
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            _pad_bank(bank)
        end.record()
        torch.cuda.synchronize()
        t["pad_bank_ms"] = start.elapsed_time(end) / 20
        ratio = c["ratios"][-1] if "ratios" in c else c["ratio"]
        n = 4
        stream = traffic_stream(traffic(
            c["tenants"], (2 * n + 2) * c["block"], ratio, c["bits"],
            seed=seed), c["bits"])
        prof = profile_blocks(spec, c["block"], n, seed, device,
                              stream=stream)
        busy = prof["captured"]["device_busy_ms_per_block"]
        t["pad_bank_share_of_busy"] = (t["pad_bank_ms"] / busy if busy
                                       else None)
        t["profile"] = prof
        out[name] = t
        log(f"sketch_update_kernel_fused on the tenant layout ({name}, R = "
            f"{t['rows']}): {json.dumps({k: v for k, v in t.items() if k != 'profile'})}")
        for way in ("eager", "captured"):
            p = prof[way]
            log(f"profile tenant {name} {way}: wall "
                f"{p['wall_ms_per_block']:.3f} ms/block "
                f"({p['unprofiled_wall_ms_per_block']:.3f} unprofiled), busy "
                f"{p['device_busy_ms_per_block']} ms/block, idle share "
                f"{p['device_idle_share']}")
    return out


# ---------------------------------------------------------------------------
# The SpaceSaving± family and the fault layer
# ---------------------------------------------------------------------------

UNBIASED = "sketch_unbiased_kernel"
FUSED = "sketch_update_kernel_fused"
# the family on the main spec (k = 400,000 split 266,667 / 133,333: 2,084 /
# 1,042 counters a row at 128 shards); CR-precis at the same budget (4 rows
# of primes up to 100,000) and its top-k over a 2^20 universe
FAMILY = dict(double_blocks=64, plain_blocks=8, unbiased_blocks=16,
              sampled_rows=8, sampled_blocks=2, crprecis_blocks=64,
              topk_bits=20, topk_blocks=16, topk_m=64, service_twins=16)
# a fault plan of 8 events over the main spec's 64 blocks and 128 shards;
# a straggler (two delays of 5 s on one row); resizes 128 -> 96 -> 1 and
# the quantile sharded bank 8 -> 4
FAULTS = dict(blocks=64, seed=7, n_faults=8, straggler_blocks=16,
              straggler_row=5, reshard=(96, 1), dyadic_shards=4,
              dyadic_blocks=8, row_pad=1024)


def family_specs():
    """The family's specs: Double and unbiased SpaceSaving± on the main
    spec (``"bank"``), CR-precis at its budget."""
    from repro_torch.sketch.api import SketchSpec

    main = dict(eps=1e-5, alpha=2.0, shards=128, bits=24)
    return dict(double=SketchSpec(variant="double", **main),
                unbiased=SketchSpec(variant="unbiased", **main),
                crprecis=SketchSpec(eps=1e-5, alpha=2.0, backend="crprecis",
                                    bits=24))


def _blocks(stream, block):
    items, weights = padded_blocks(stream, block)
    return list(zip(items, weights))


def double_replay(spec, blocks, device, update):
    """The blocks through the partition prep and ``update`` (kernel 1 or its
    plain version) on both banks of a Double state, from the spec's empty
    state: ``bank.update_pair``'s updates outside the session."""
    import torch
    from repro_torch.kernels.sketch_update import ops
    from repro_torch.sketch import api
    from repro_torch.sketch import bank as bk
    from repro_torch.sketch.family import DoubleState

    state = api.make(spec, device)
    router = api.adapter_for(spec)._router(spec, state.ins.ids.shape[0])
    ins, dels = state.ins, state.dels
    for items, weights in blocks:
        it = torch.as_tensor(items, device=device)
        w_i, w_d = bk.split_signed(torch.as_tensor(weights, device=device))
        ins = ops.partition_update_with(update, ins, it, w_i, router, 2)
        dels = ops.partition_update_with(update, dels, it, w_d, router, 2)
    torch.cuda.synchronize()
    return DoubleState(ins, dels, state.key)


def unbiased_replay(spec, blocks, device, update, keep=()):
    """The blocks through ``ops.unbiased_update_with`` and ``update`` (the
    unbiased kernel or its plain version) from the spec's empty state,
    the uniforms and the next key from ``family.draw``, as the session
    draws them. Returns the state and, for each block in ``keep``, its
    kernel operands (both banks, then the layout) as they were before
    it."""
    import torch
    from repro_torch.kernels.sketch_update import ops
    from repro_torch.sketch import api
    from repro_torch.sketch import family as fam

    state = api.make(spec, device)
    router = api.adapter_for(spec)._router(spec, state.ins.ids.shape[0])
    kept = {}
    for b, (items, weights) in enumerate(blocks):
        def run(*operands, b=b):
            if b in keep:
                kept[b] = ([t.clone() for t in operands[:6]],
                           list(operands[6:]))
            return update(*operands)

        u, key = fam.draw(state.key, len(items))
        ins, dels = ops.unbiased_update_with(
            run, state.ins, state.dels, torch.as_tensor(items, device=device),
            torch.as_tensor(weights, device=device), u, router)
        state = fam.DoubleState(ins, dels, key)
    torch.cuda.synchronize()
    return state, kept


def sampled_rows(st, args, rows):
    """The unbiased kernel's operands cut to bank rows ``rows`` of both
    banks: their slices and their runs of the flat layout (positions keep
    indexing the whole block)."""
    import torch

    R = st[0].shape[0]
    items, weights, u, perm, roff = args
    bounds = roff.tolist()
    segs, starts = [], [0]
    for side in (0, 1):
        for r in rows:
            c = side * R + r
            segs.append(perm[bounds[c]:bounds[c + 1]])
            starts.append(starts[-1] + len(segs[-1]))
    idx = torch.as_tensor(rows, device=st[0].device)
    return ([t[idx] for t in st],
            [items, weights, u, torch.cat(segs),
             torch.tensor(starts, dtype=torch.int32, device=st[0].device)])


def unbiased_bound(st, args):
    """Least bytes: each bank row that has an entry read and written once
    (ids, counts, errors), the block's ids, weights and positions and the
    two banks' uniforms read once, the row starts; one operation an
    entry."""
    R, Ki = st[0].shape
    Kd = st[3].shape[1]
    items, _, u, perm, roff = args
    n = (roff[1:] - roff[:-1]).cpu()
    touched_i, touched_d = int((n[:R] > 0).sum()), int((n[R:] > 0).sum())
    nbytes = (2 * 12 * (touched_i * Ki + touched_d * Kd)
              + 4 * (2 * items.numel() + perm.numel() + roff.numel())
              + 4 * u.numel())
    return nbytes, int(n.sum()), touched_i + touched_d


def time_unbiased(last, reps=10) -> dict:
    """The unbiased kernel's device ms on a block (each launch on its own
    copy of the banks), its host ms per call, its plain version's ms on
    the same operands (one call), and the bound."""
    import torch
    from repro_torch.kernels.sketch_update import kernel, ref

    st, args = last
    fn = getattr(kernel, UNBIASED)
    first = fn(*(t.clone() for t in st), *args)
    rounds = stream_ms(lambda c: fn(*c, *args), st, reps)
    ms = device_ms(lambda c: fn(*c, *args), st, reps)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    want = ref.unbiased_update_ref(*st, *args)
    end.record()
    torch.cuda.synchronize()
    if not _same(want, first):
        raise SystemExit("the timed unbiased launch differs from its plain "
                         "version")
    nbytes, entries, rows = unbiased_bound(st, args)
    bound_s = max(nbytes / HBM_BYTES_PER_S, entries / INT32_OPS_PER_S)
    return dict(ms=ms, stream_ms=sorted(rounds)[len(rounds) // 2],
                stream_ms_rounds=rounds, plain_ms=start.elapsed_time(end),
                bound_ms=bound_s * 1e3,
                bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                          >= entries / INT32_OPS_PER_S else "operations"),
                bytes=nbytes, entries=entries, rows_touched=rows)


def unbiased_cases(device) -> int:
    """The unbiased kernel against its plain version beside the main run:
    small banks, rows at and past the staged layout's limit (16,384 /
    16,385 slots), a heavy hitter repeated through a block, warm banks
    (after two blocks). Returns the worst error (0 or fatal)."""
    import numpy as np
    import torch
    from repro_torch.core.streams import bounded_stream
    from repro_torch.kernels.sketch_update import kernel, ref
    from repro_torch.sketch import bank as bk
    from repro_torch.sketch import family as fam
    from repro_torch.sketch.state import SketchState

    fn = getattr(kernel, UNBIASED)
    worst = 0
    cases = ((1, 6, 3, 0), (7, 200, 100, 0), (128, 2084, 1042, 2),
             (1, 16384, 16, 0), (1, 16385, 8, 0), (3, 40, 7, 1))
    for i, (R, Ki, Kd, warm) in enumerate(cases):
        B = 4096
        router = bk.HashShardRouter(R, 24)
        s = bounded_stream((warm + 1) * B, 0.5, universe=1 << 24, skew=1.0,
                           seed=500 + i)
        if i == len(cases) - 1:   # a heavy hitter through most of a block
            s[::3, 0] = 4242
        ins, dels = bk.init(Ki, R, device=device), bk.init(Kd, R, device=device)
        key = torch.tensor([0, i], dtype=torch.int64).to(torch.uint32)
        for b in range(warm + 1):
            part = s[b * B:(b + 1) * B]
            it = torch.as_tensor(part[:, 0], dtype=torch.int32, device=device)
            w = torch.as_tensor(part[:, 1], dtype=torch.int32, device=device)
            s_items, s_w, perm, roff = fam.unbiased_prep(it, w, router)
            u, nxt = fam.draw(key.to(device), B)
            args = [s_items, s_w, u, perm, roff]
            st = [*ins, *dels]
            want = ref.unbiased_update_ref(*st, *args)
            if b == warm:
                before = dict(fn.launches)
                got = fn(*(t.clone() for t in st), *args)
                torch.cuda.synchronize()
                ran = [p for p, n in fn.launches.items() if n != before[p]]
                if ran != [kernel.unbiased_layout(max(Ki, Kd))]:
                    raise SystemExit(f"{UNBIASED} ran on {ran}")
                err = max_abs_err(want, got)
                if not _same(want, got):
                    raise SystemExit(f"{UNBIASED} disagrees with its plain "
                                     f"version: R={R}, K={Ki}/{Kd}")
                log(f"{UNBIASED} vs plain [R={R} K={Ki}/{Kd} warm={warm}]: "
                    f"equal (max_abs_err {err}, layout {ran[0]})")
                worst = max(worst, err)
            ins, dels = SketchState(*want[:3]), SketchState(*want[3:])
            key = nxt
    return worst


def check_double_truth(label, spec, state, stream, device) -> dict:
    """Every id of the universe within ``I_r / k_I + D_r / k_D`` of its
    exact count, r its owner row (I_r, D_r the row's inserted and deleted
    mass, k_I, k_D a row's counters: the family bound of
    tests/test_family.py:82-107); never below it where the insert bank
    monitors the id (an unmonitored id answers 0, as in the reference);
    every id above its row's slack monitored and among the top k_I
    (``topk``); ``query_many`` equal to the banks read directly."""
    import numpy as np
    import torch
    from repro_torch.sketch import api
    from repro_torch.sketch.bank import shard_of
    from repro_torch.sketch.family import double_capacities

    U = 1 << spec.bits
    R, k_i = state.ins.ids.shape
    k_d = state.dels.ids.shape[1]
    items = torch.as_tensor(stream[:, 0], device=device).long()
    w = torch.as_tensor(stream[:, 1], device=device).long()
    f = torch.zeros(U, dtype=torch.int64, device=device).index_add_(0, items,
                                                                     w)

    def dense(bank, val):
        live = bank.ids >= 0
        out = torch.zeros(U, dtype=torch.int64, device=device)
        out[bank.ids[live].long()] = val[live].long()
        return out, live

    est_i, live_i = dense(state.ins, state.ins.counts)
    est_d, _ = dense(state.dels, torch.clamp(state.dels.counts
                                             - state.dels.errors, min=0))
    est = torch.clamp(est_i - est_d, min=0)
    monitored = torch.zeros(U, dtype=torch.bool, device=device)
    monitored[state.ins.ids[live_i].long()] = True
    owner = shard_of(torch.arange(U, dtype=torch.int32, device=device),
                     R).long()
    row = owner[items]
    ins_r = torch.zeros(R, dtype=torch.float64, device=device).index_add_(
        0, row, torch.clamp(w, min=0).double())
    del_r = torch.zeros(R, dtype=torch.float64, device=device).index_add_(
        0, row, torch.clamp(-w, min=0).double())
    slack = (ins_r / k_i + del_r / k_d)[owner]
    err = (est - f).abs().double()
    if bool((err > slack + 1e-9).any()):
        x = int(torch.argmax(err - slack))
        raise SystemExit(f"{label}: id {x} off by {float(err[x])} > slack "
                         f"{float(slack[x])}")
    if bool((monitored & (est < f)).any()):
        raise SystemExit(f"{label}: a monitored id is estimated below its "
                         f"true count")
    above = f.double() > slack
    if bool((above & ~monitored).any()):
        raise SystemExit(f"{label}: an id above its row's slack is not "
                         f"monitored")
    m = double_capacities(spec.capacity, spec.alpha)[0]
    t0 = time.perf_counter()
    ids, _ = api.topk(spec, state, m)
    torch.cuda.synchronize()
    topk_ms = (time.perf_counter() - t0) * 1e3
    reported = torch.zeros(U, dtype=torch.bool, device=device)
    reported[ids[ids >= 0].long()] = True
    if bool((above & ~reported).any()):
        raise SystemExit(f"{label}: an id above its row's slack is not in "
                         f"the top {m}")
    rng = np.random.default_rng(9)
    sample = np.concatenate([
        torch.topk(f, 2048).indices.cpu().numpy(),
        rng.integers(0, U, 2048)]).astype(np.int32)
    got = api.query_many(spec, state, sample)
    if not torch.equal(got.long(), est[torch.as_tensor(sample,
                                                       device=device).long()]):
        raise SystemExit(f"{label}: query_many differs from the banks")
    has = slack > 0
    return dict(worst_err_over_slack=float((err[has] / slack[has]).max()),
                ids_above_slack=int(above.sum()),
                monitored_ids=int(monitored.sum()), topk_m=m,
                topk_ms=topk_ms)


def family_run(label, spec, stream, block, device, launches):
    """A session over the stream (``run_session``: the captured ingest),
    its counted launches (``launches``: kernel key -> launches a block,
    every other counter 0) and the per-block ms."""
    reset_counts()
    sess, secs, first = run_session(spec, stream, block, device)
    counts = read_counts()
    n = sess.blocks_ingested
    for key, per in launches.items():
        if counts[key] != per * n:
            raise SystemExit(f"{label}: {counts[key]} launches of {key} for "
                             f"{n} blocks, expected {per * n}")
    others = {k: v for k, v in counts.items() if v and k not in launches}
    if others:
        raise SystemExit(f"{label}: other kernels launched: {others}")
    if sess._compiled.graph is None:
        raise SystemExit(f"{label}: the session did not run its CUDA graph")
    rec = dict(label=label, blocks=n, events=len(stream),
               launches={k: counts[k] for k in launches},
               ms_per_block=secs * 1e3 / (n - 1),
               updates_per_s=(len(stream) - block) / secs, **first)
    return sess, rec


def family_service(device) -> dict:
    """The service bench shape with ``variant="double"``: the replay
    through ``SketchService`` (two kernel-1 launches a block), both banks
    equal to the plain version over every traced block, and sampled
    tenants equal to independent Double sketches of the same per-row
    capacities, queries and top-k."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels.sketch_update import ref
    from repro_torch.serve import SketchService
    from repro_torch.sketch.family import double_capacities


    c = TENANT_BENCH
    spec = dataclasses.replace(tenant_spec(c["tenants"], c["k"], c["bits"]),
                               variant="double")
    label = "family service double delete=0.5"
    ops = traffic(c["tenants"], c["updates"], 0.5, c["bits"], seed=6)
    svc = SketchService(spec, block=c["block"], device=device)
    svc.trace_blocks = []
    reset_counts()
    secs, tickets, _ = replay(svc, ops, c["block"])
    torch.cuda.synchronize()
    counts = read_counts()
    n = svc.stats["blocks"]
    key = f"sketch_update_kernel_fused[{_fused_layout_of(c['k'])}]"
    others = {k: v for k, v in counts.items() if v and k != key}
    if counts[key] != 2 * n or others:
        raise SystemExit(f"{label}: {counts[key]} launches of {key} for {n} "
                         f"blocks; others {others}")
    state = svc.session.state
    t0 = time.perf_counter()
    plain = double_replay(spec, svc.trace_blocks, device, ref.fused_update_ref)
    plain_ms = (time.perf_counter() - t0) * 1e3 / n
    if not (_same(plain.ins, state.ins) and _same(plain.dels, state.dels)):
        raise SystemExit(f"{label}: the banks differ from the plain version's")
    per_i, per_d = state.ins.ids.shape[1], state.dels.ids.shape[1]
    k_solo = next(k for k in range(2, 64)
                  if double_capacities(k, spec.alpha) == (per_i, per_d))
    rng = np.random.default_rng(41)
    twins = check_twins(label, spec, svc.trace_blocks, state,
                        rng.choice(c["tenants"], FAMILY["service_twins"],
                                   replace=False), device, k_solo=k_solo,
                        m=per_i)
    lat = [t.latency_s for t in tickets]
    rec = dict(label=label, blocks=n, launches=counts[key],
               rows=state.ins.ids.shape[0], k_per_row=[per_i, per_d],
               updates=svc.stats["updates"], ms_per_block=secs * 1e3 / n,
               updates_per_s=svc.stats["updates"] / secs,
               plain_ms_per_block=plain_ms, twins=twins,
               p99_ticket_ms=float(np.percentile(lat, 99)) * 1e3)
    log(f"{label}: {json.dumps(rec)}")
    return rec


def family_phase(device, stream, block) -> tuple:
    """The family on the main stream: double main (64 blocks, two kernel-1
    launches a block, both banks equal to kernel 1's and the plain
    version's replays, the family bound, the top-k), the double service,
    unbiased main (16 blocks, one unbiased launch a block, equal to its
    plain version on sampled rows, exact mass per bank, two sessions
    equal), CR-precis (64 blocks, equal to the CPU, never below the true
    count, merge of halves, top-k over 2^20 ids). Returns (records, the
    unbiased kernel's operands for its times, its worst error)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels.sketch_update import kernel, ref
    from repro_torch.sketch import api
    from repro_torch.sketch.session import StreamSession

    specs = family_specs()
    out = {}
    worst = unbiased_cases(device)

    # double main
    label = "family double main"
    spec = specs["double"]
    s = stream[:FAMILY["double_blocks"] * block]
    sess, rec = family_run(label, spec, s, block, device,
                           {f"{FUSED}[staged]": 2})
    blocks = _blocks(s, block)
    fused = getattr(kernel, FUSED)
    if not _same(tuple(_state_leaves(double_replay(spec, blocks, device,
                                                   fused))),
                 tuple(_state_leaves(sess.state))):
        raise SystemExit(f"{label}: the session differs from kernel 1's "
                         f"replay of its blocks")
    n = FAMILY["plain_blocks"]
    t0 = time.perf_counter()
    plain = double_replay(spec, blocks[:n], device, ref.fused_update_ref)
    rec["plain_ms_per_block"] = (time.perf_counter() - t0) * 1e3 / n
    if not _same(tuple(_state_leaves(plain)), tuple(_state_leaves(
            double_replay(spec, blocks[:n], device, fused)))):
        raise SystemExit(f"{label}: kernel 1 differs from its plain version "
                         f"over {n} blocks")
    rec["plain_blocks"] = n
    rec.update(check_double_truth(label, spec, sess.state, s, device))
    out[label] = rec
    log(f"{label}: {json.dumps(rec)}")
    out["family service double"] = family_service(device)

    # unbiased main
    label = "family unbiased main"
    spec = specs["unbiased"]
    s = stream[:FAMILY["unbiased_blocks"] * block]
    blocks = _blocks(s, block)
    sess, rec = family_run(label, spec, s, block, device,
                           {f"{UNBIASED}[staged]": 1})
    live = sess.state
    replayed, kept = unbiased_replay(
        spec, blocks, device, getattr(kernel, UNBIASED),
        keep=set(range(FAMILY["sampled_blocks"])) | {len(blocks) - 1})
    if not _same(tuple(_state_leaves(replayed)), tuple(_state_leaves(live))):
        raise SystemExit(f"{label}: the session differs from the kernel's "
                         f"replay of its blocks")
    rows = sorted(np.random.default_rng(3).choice(
        live.ins.ids.shape[0], FAMILY["sampled_rows"], replace=False).tolist())
    fn = getattr(kernel, UNBIASED)
    for b in range(FAMILY["sampled_blocks"]):
        st, args = kept[b]
        got = fn(*(t.clone() for t in st), *args)
        sub_st, sub_args = sampled_rows(st, args, rows)
        want = ref.unbiased_update_ref(*sub_st, *sub_args)
        idx = torch.as_tensor(rows, device=device)
        if not _same(want, [t[idx] for t in got]):
            raise SystemExit(f"{label}: block {b}, the kernel's sampled rows "
                             f"differ from the plain version's")
        worst = max(worst, max_abs_err(want, [t[idx] for t in got]))
    w = s[:, 1].astype(np.int64)
    mass = (int(live.ins.counts.sum(dtype=torch.int64)),
            int(live.dels.counts.sum(dtype=torch.int64)))
    if mass != (int(w[w > 0].sum()), int(-w[w < 0].sum())):
        raise SystemExit(f"{label}: bank mass {mass} is not the substreams' "
                         f"{(int(w[w > 0].sum()), int(-w[w < 0].sum()))}")
    twin = StreamSession(spec, block=block, device=device)
    twin.ingest(s[:, 0], s[:, 1])
    if not _same(tuple(_state_leaves(twin.state)),
                 tuple(_state_leaves(live))):
        raise SystemExit(f"{label}: two sessions of one seed differ")
    rec.update(sampled_rows=rows, sampled_blocks=FAMILY["sampled_blocks"],
               insert_mass=mass[0], delete_mass=mass[1])
    out[label] = rec
    log(f"{label}: {json.dumps(rec)}")
    last = kept[len(blocks) - 1]

    # CR-precis
    label = "family crprecis main"
    spec = specs["crprecis"]
    s = stream[:FAMILY["crprecis_blocks"] * block]
    sess, rec = family_run(label, spec, s, block, device, {})
    cpu = StreamSession(spec, block=block, device="cpu")
    cpu.ingest(s[:, 0], s[:, 1])
    if not all(torch.equal(a.cpu(), b) for a, b in zip(sess.state,
                                                         cpu.state)):
        raise SystemExit(f"{label}: the state differs from the CPU's")
    ids = np.unique(s[:, 0]).astype(np.int32)
    f = np.bincount(s[:, 0], weights=s[:, 1],
                    minlength=1 << spec.bits).astype(np.int64)[ids]
    est = sess.query_many(ids).cpu().numpy()
    if (est < f).any():
        raise SystemExit(f"{label}: an id is estimated below its count")
    half = len(blocks) // 2 * block
    a = StreamSession(spec, block=block, device=device)
    b = StreamSession(spec, block=block, device=device)
    a.ingest(s[:half, 0], s[:half, 1])
    b.ingest(s[half:, 0], s[half:, 1])
    merged = api.merge(spec, a.state, b.state)
    if not torch.equal(merged.counts, sess.state.counts):
        raise SystemExit(f"{label}: the merge of the halves differs from the "
                         f"whole")
    small = dataclasses.replace(spec, bits=FAMILY["topk_bits"])
    ts = make_stream(FAMILY["topk_blocks"], block, seed=12,
                     bits=FAMILY["topk_bits"])
    gpu_t = StreamSession(small, block=block, device=device)
    cpu_t = StreamSession(small, block=block, device="cpu")
    for x in (gpu_t, cpu_t):
        x.ingest(ts[:, 0], ts[:, 1])
    t0 = time.perf_counter()
    top = gpu_t.topk(FAMILY["topk_m"])
    torch.cuda.synchronize()
    topk_ms = (time.perf_counter() - t0) * 1e3
    want = cpu_t.topk(FAMILY["topk_m"])
    if not all(torch.equal(x.cpu(), y) for x, y in zip(top, want)):
        raise SystemExit(f"{label}: top-k at bits=20 differs from the CPU's")
    ft = np.bincount(ts[:, 0], weights=ts[:, 1],
                     minlength=1 << FAMILY["topk_bits"])
    tid, tval = (x.cpu().numpy() for x in top)
    if (tval < ft[np.maximum(tid, 0)]).any():
        raise SystemExit(f"{label}: a top-k value is below its id's count")
    rec.update(streamed_ids=len(ids), worst_overestimate=int((est - f).max()),
               topk_bits=FAMILY["topk_bits"], topk_ms=topk_ms,
               rows=int(sess.state.counts.shape[0]),
               primes=sess.state.primes.tolist())
    out[label] = rec
    log(f"{label}: {json.dumps(rec)}")
    return out, last, worst


def _state_leaves(state):
    from repro_torch.sketch.session import _leaves

    return _leaves(state)


def reshard_bound(label, state, bound_old, stream, bits, slack) -> float:
    """Every id of the universe within its old row's Thm 4 bound plus the
    session's accumulated resize slack. Returns the worst error over that
    bound."""
    import numpy as np

    U = 1 << bits
    f = np.bincount(stream[:, 0], weights=stream[:, 1],
                    minlength=U).astype(np.int64)
    ids, cnt = (t.reshape(-1).cpu().numpy() for t in state.bank[:2])
    live = ids >= 0
    est = np.zeros(U, np.int64)
    est[ids[live]] = cnt[live]
    err = np.abs(est - f)
    limit = bound_old + slack
    if (err > limit + 1e-9).any():
        x = int(np.argmax(err - limit))
        raise SystemExit(f"{label}: id {x} off by {err[x]} > {limit[x]}")
    return float((err / np.maximum(limit, 1e-9)).max())


def fault_spec():
    """The fault phase's spec: the main spec on the default ``"bank"``."""
    from repro_torch.sketch.api import SketchSpec

    return SketchSpec(eps=1e-5, alpha=2.0, shards=128, bits=24)


def row_fragments(spec, blocks, row, pad):
    """Each block's entries that row ``row`` of the spec's bank owns, in
    block order, as host int32 (items, weights) of length ``pad``, filled
    with no-op entries (id -1, weight 0)."""
    import numpy as np
    import torch
    from repro_torch.sketch.bank import shard_of

    out = []
    for items, weights in blocks:
        mine = shard_of(torch.as_tensor(items), spec.shards).numpy() == row
        n = int(mine.sum())
        if n > pad:
            raise ValueError(f"row {row} owns {n} entries of a block, more "
                             f"than the pad {pad}")
        it = np.full(pad, -1, np.int32)
        w = np.zeros(pad, np.int32)
        it[:n], w[:n] = items[mine], weights[mine]
        out.append((it, w))
    return out


def row_alone(spec, fragments, row):
    """Row ``row`` of the spec's bank rebuilt on the CPU from its own
    entries alone (``row_fragments``): a one-row sketch of the row's
    capacity, fed them through the plain version. The partition core's
    rows are independent, so this is the row of the whole bank."""
    import torch
    from repro_torch.sketch import api
    from repro_torch.sketch.state import BLOCKED

    k = int((api.make(spec, "cpu").bank.ids[row] != BLOCKED).sum())
    one = api.SketchSpec(k=k, alpha=spec.alpha, variant=spec.variant,
                         bits=spec.bits)
    state = api.make(one, "cpu")
    for items, weights in fragments:
        state = api.update(one, state, torch.as_tensor(items),
                           torch.as_tensor(weights))
    return state


def fault_phase(device, stream, block, q_spec) -> dict:
    """The fault layer on the main spec (``"bank"``): a seeded random plan
    over the 64 blocks and 128 shards (all four kinds) with a schedule
    checkpoint at block 0 and a replay log of 64 blocks; ``dead_shards``
    after every block (a corrupted row flagged the block it is poisoned,
    any other row only for a count or error below 0, which SS± also
    reaches on a healthy row: the twin's flags are recorded, and each row
    it flags equals the row rebuilt alone, ``row_alone``); recovery of the
    dead rows
    (the other rows keep their live values) and of all 128 rows (equal
    to a never-failed twin); a delay plan flagging its row on the port's
    straggler monitor; ``reshard_session`` 128 -> 96 -> 1 within Thm 4
    plus the slack, the one row lossless and its ``consolidated()``;
    ``reshard_dyadic`` of the quantile sharded state 8 -> 4 within
    eps·|F|₁ plus the slack per level."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.sketch import api, elastic, faults
    from repro_torch.sketch.bank import shard_of
    from repro_torch.sketch.session import StreamSession
    from repro_torch.train.straggler import StragglerConfig, StragglerMonitor

    c = FAULTS
    out = {}
    spec = fault_spec()
    S = spec.shards
    s = stream[:c["blocks"] * block]
    blocks = _blocks(s, block)
    plan = faults.FaultPlan.random(c["seed"], len(blocks), S,
                                   n_faults=c["n_faults"])
    sess = StreamSession(spec, block=block, replay=len(blocks),
                         fault_plan=plan, device=device)
    twin = StreamSession(spec, block=block, device=device)
    ckpt = sess.save(include_schedule=True)
    corrupted, touched, negative, healthy = set(), set(), set(), set()
    t0 = time.perf_counter()
    for b, (items, weights) in enumerate(blocks, start=1):
        sess.ingest_block(items, weights)
        twin.ingest_block(items, weights)
        now = {e.row for e in plan.events_at(b) if e.kind == "corrupt"}
        corrupted |= now
        touched |= {e.row for e in plan.events_at(b)}
        dead = set(np.flatnonzero(elastic.dead_shards(spec, sess.state)))
        # a corrupted row is flagged the block it is poisoned. Another row
        # may be flagged for a count below 0 (or an error, where such a
        # count was evicted): SS± reaches one on a healthy stream too, an
        # underestimate, so a row no event touched must then equal the
        # twin's; a dropped, duplicated or delayed slice makes it likelier
        if not now <= dead:
            raise SystemExit(f"fault plan: after block {b} the scan flags "
                             f"{sorted(dead)}, not the rows corrupted this "
                             f"block {sorted(now)}")
        for r in sorted(dead - corrupted):
            row = [t[int(r)] for t in sess.state.bank]
            if int(r) not in touched:
                if not _same(row, [t[int(r)] for t in twin.state.bank]):
                    raise SystemExit(f"fault plan: row {r}, which no event "
                                     f"touched, differs from the twin's")
                healthy.add(int(r))
                continue
            ids, cnt, err = (t.long() for t in row)
            live = ids >= 0
            empty, blocked = ids == -1, ids == -2
            if (bool((ids < -2).any())
                    or bool((empty & ((cnt != 0) | (err != 0))).any())
                    or bool((blocked & ((cnt != IMAX) | (err != 0))).any())
                    or len(torch.unique(ids[live])) != int(live.sum())
                    or not bool((live & ((cnt < 0) | (err < 0))).any())):
                raise SystemExit(f"fault plan: row {r} (no corrupt event) "
                                 f"flagged for another reason than a count "
                                 f"or error below 0")
            negative.add(int(r))
    sess.flush()
    twin.flush()
    fault_secs = time.perf_counter() - t0
    # the twin's flagged rows are SS±'s, not the partition core's: each
    # equals the row rebuilt alone on the CPU from its own entries, which
    # tests/test_torch_elastic.py holds against the reference's engine
    twin_dead = [int(r) for r in np.flatnonzero(
        elastic.dead_shards(spec, twin.state))]
    for r in twin_dead:
        alone = row_alone(spec, row_fragments(spec, blocks, r,
                                              c["row_pad"]), r)
        if not _same([t[r].cpu() for t in twin.state.bank], list(alone)):
            raise SystemExit(f"fault plan: the twin's flagged row {r} "
                             f"differs from the row rebuilt alone")
    dead = np.flatnonzero(elastic.dead_shards(spec, sess.state))
    live = [t.clone() for t in sess.state.bank]
    rep = elastic.recover_session(sess, ckpt, rows=dead)
    keep = [r for r in range(S) if r not in set(dead.tolist())]
    for t, lv, tw in zip(sess.state.bank, live, twin.state.bank):
        if not (torch.equal(t[keep], lv[keep])
                and torch.equal(t[dead], tw[dead])):
            raise SystemExit("recovery of the dead rows: a spliced row "
                             "differs from the twin's or a kept row moved")
    full = elastic.recover_session(sess, ckpt, rows=range(S))
    if not _same(sess.state.bank, twin.state.bank):
        raise SystemExit("recovery of all rows differs from the never-failed "
                         "twin")
    out["faults"] = dict(
        events=[dict(step=e.step, row=e.row, kind=e.kind) for e in plan.events],
        corrupted=sorted(int(r) for r in corrupted),
        dead_at_end=[int(r) for r in dead],
        healed=sorted(int(r) for r in corrupted - set(dead.tolist())),
        flagged_touched_not_corrupted=sorted(negative),
        flagged_untouched=sorted(healthy),
        twin_flagged=twin_dead, twin_flagged_equal_alone=True,
        ms_per_block_faulted=fault_secs * 1e3 / len(blocks),
        recover_dead_rows_s=rep.seconds, recover_all_s=full.seconds,
        replayed_blocks=full.replayed_blocks)
    log(f"fault plan: {json.dumps(out['faults'])}")

    # a straggler: two delays on one row walk the monitor to a flag
    row = c["straggler_row"]
    flagged = []
    mon = StragglerMonitor(StragglerConfig(min_steps=4, sustained=2,
                                           z_threshold=3.0),
                           on_straggler=lambda h, t, z: flagged.append(h))
    n = c["straggler_blocks"]
    dplan = faults.FaultPlan(events=(
        faults.FaultEvent(step=n - 3, row=row, kind="delay", delay_s=5.0),
        faults.FaultEvent(step=n - 2, row=row, kind="delay", delay_s=5.0)))
    strag = StreamSession(spec, block=block, fault_plan=dplan, device=device)
    for items, weights in blocks[:2]:     # warm, unobserved
        strag.ingest_block(items, weights)
    strag.monitor = mon
    t0 = time.perf_counter()
    for items, weights in blocks[2:n]:
        strag.ingest_block(items, weights)
    mon_ms = (time.perf_counter() - t0) * 1e3 / (n - 2)
    if row not in mon.flagged:
        raise SystemExit(f"straggler: row {row} not flagged ({mon.flagged})")
    # every host reports the same block time, so a slow block may flag
    # others too: recorded, not fatal
    out["straggler"] = dict(row=row, flagged=sorted(set(flagged)),
                            still_flagged=sorted(mon.flagged),
                            ms_per_block_with_monitor=mon_ms)
    log(f"straggler: {json.dumps(out['straggler'])}")

    # resize the twin: 128 -> 96 -> 1
    R0, k0 = twin.state.bank.ids.shape
    owner = shard_of(torch.arange(1 << spec.bits, dtype=torch.int32,
                                  device=device), R0).long()
    ins = torch.zeros(R0, dtype=torch.float64, device=device).index_add_(
        0, owner[torch.as_tensor(s[s[:, 1] > 0, 0], device=device).long()],
        torch.as_tensor(s[s[:, 1] > 0, 1], device=device).double())
    bound_old = (2.0 * ins / k0)[owner].cpu().numpy()
    resized = []
    for new in c["reshard"]:
        live_before = [t.clone() for t in twin.state.bank]
        t0 = time.perf_counter()
        report = elastic.reshard_session(twin, new)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ratio = reshard_bound(f"reshard -> {new}", twin.state, bound_old, s,
                              spec.bits, twin.error_slack)
        resized.append(dict(new_shards=new, seconds=secs, moved=report.moved,
                            dropped=report.dropped,
                            dropped_mass=report.dropped_mass,
                            error_slack=report.error_slack,
                            session_slack=twin.error_slack,
                            worst_err_over_bound=ratio))
    def live_map(bank):
        ids, cnt, err = (t.reshape(-1).cpu().numpy() for t in bank)
        keep = ids >= 0
        return set(zip(ids[keep].tolist(), cnt[keep].tolist(),
                       err[keep].tolist()))

    if resized[-1]["dropped"] or live_map(twin.state.bank) \
            != live_map(live_before):
        raise SystemExit("reshard to one row lost a counter")
    cons = twin.consolidated()
    if not _same(cons, [t[0] for t in twin.state.bank]):
        raise SystemExit("consolidated() of the one-row session differs from "
                         "its row")
    out["reshard"] = resized
    log(f"reshard: {json.dumps(resized)}")

    # the quantile sharded bank 8 -> 4
    qsess = StreamSession(q_spec, block=block, device=device)
    qs = stream[:c["dyadic_blocks"] * block]
    qsess.ingest(qs[:, 0], qs[:, 1])
    t0 = time.perf_counter()
    new_state, report = elastic.reshard_dyadic(qsess.state,
                                               c["dyadic_shards"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    new_spec = dataclasses.replace(q_spec, shards=c["dyadic_shards"])
    cum = exact_ranks(qs, q_spec.bits)
    xs = rank_grid(cum)
    est = api.rank_many(new_spec, new_state, xs).cpu().numpy()
    eps = q_spec.eps
    limit = eps * int(cum[-1]) + q_spec.bits * report.error_slack
    err = np.abs(est.astype(np.int64) - cum[xs])
    if (err > limit).any() or int(new_state.mass) != int(qsess.state.mass):
        raise SystemExit(f"reshard_dyadic: rank off by {err.max()} > "
                         f"{limit}")
    out["reshard_dyadic"] = dict(
        old_shards=q_spec.shards, new_shards=c["dyadic_shards"], seconds=secs,
        moved=report.moved, dropped=report.dropped,
        error_slack=report.error_slack, worst_rank_err=int(err.max()),
        limit=limit)
    log(f"reshard_dyadic: {json.dumps(out['reshard_dyadic'])}")
    return out


# ---------------------------------------------------------------------------
# The mesh phase: the shard_map paths on a 1-rank NCCL mesh and on two
# ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# (a): 16 blocks of the main stream through the sharded bank's shard_map
# path (kernel 3), the first 2 also on the CPU; 8 through the dyadic
# sharded bank's (kernel 2); the compressed exchange over Qwen3-0.6B's
# parameter shapes, 3 steps. (b): 2 ranks, the session on the same blocks
MESH = dict(blocks=16, cpu_blocks=2, q_blocks=8, arch="qwen3_0_6b",
            smoke_arch=False, k_frac=0.01, steps=3, seed=31, ranks=2,
            child_timeout=900)


def _ms_per(fn, n, device) -> tuple:
    """(host ms per item of ``fn()``'s ``n`` items, the card drained;
    its result)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / n, out


def _full_bank(bank):
    """A (mesh-sharded or whole) bank's leaves, gathered whole."""
    from repro_torch.parallel import sharding as psh

    return [psh.full(t) for t in bank]


def _first_and_rest(step, items, device) -> tuple:
    """``step(x)`` over ``items``: (host ms of the first, which carries
    the first call's costs, ms an item of the rest, the card drained
    after each part, the last result)."""
    sync(device)
    t0 = time.perf_counter()
    out = step(items[0])
    sync(device)
    t1 = time.perf_counter()
    for x in items[1:]:
        out = step(x)
    sync(device)
    t2 = time.perf_counter()
    return ((t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(len(items) - 1, 1),
            out)


def mesh_runs(label, spec, blocks, device, update, name, layout) -> tuple:
    """``update(state, items, weights)`` over ``blocks`` from the spec's
    empty state, every counter 0 before and read after: one launch of
    kernel ``name`` on ``layout`` a block and no other kernel. Returns
    (state, run record, ms a block after the first)."""
    import torch

    from repro_torch.sketch import api

    dev_blocks = [(torch.as_tensor(i, device=device),
                   torch.as_tensor(w, device=device)) for i, w in blocks]
    box = [api.make(spec, device)]

    def step(block):
        box[0] = update(box[0], *block)
        return box[0]

    reset_counts()
    first, ms, out = _first_and_rest(step, dev_blocks, device)
    counts = read_counts()
    n = check_launches(label, counts, name, len(blocks), layout)
    return out, dict(kernel=name, layout=layout, launches=n,
                     first_block_ms=first, ms_per_block=ms), ms


def exchange_phase(mesh, c, device) -> dict:
    """``build_compressed_allreduce(mesh)`` over f32 gradient trees of
    the model's parameter shapes (random, from ``c["seed"]``), ``steps``
    steps carrying the residual, on ``device`` and on CPU copies of the
    same gradients, held leaf for leaf. With one rank the sum is the
    top-k scatter of unique indices, so both are exact: ``torch.equal``.
    Returns the times and sizes."""
    import torch

    from repro_torch.configs import get, get_smoke
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train.dp_exchange import build_compressed_allreduce

    cpu = torch.device("cpu")
    cfg = (get_smoke if c["smoke_arch"] else get)(c["arch"])
    params, _ = build_model(cfg).init(None, device="meta")
    allreduce = build_compressed_allreduce(mesh, k_frac=c["k_frac"])
    gen = torch.Generator(device).manual_seed(c["seed"])
    res = tree_map(lambda p: torch.zeros(p.shape, device=device), params)
    res_h = tree_map(lambda p: torch.zeros(p.shape), params)
    ms, ms_h = [], []
    for step in range(c["steps"]):
        g = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device=device), params)
        t, (s, res) = _ms_per(lambda: allreduce(g, res), 1, device)
        ms.append(t)
        g = tree_map(lambda x: x.to(cpu), g)
        t, (s_h, res_h) = _ms_per(lambda: allreduce(g, res_h), 1, cpu)
        ms_h.append(t)
        for a, b in zip(tree_leaves(s) + tree_leaves(res),
                        tree_leaves(s_h) + tree_leaves(res_h)):
            if not torch.equal(a.to(cpu), b):
                raise SystemExit(f"mesh (a): the exchange's step {step} "
                                 f"differs from the CPU's")
        del g, s, s_h
    leaves = tree_leaves(params)
    return dict(arch=cfg.name, leaves=len(leaves),
                elements=sum(p.numel() for p in leaves), steps=c["steps"],
                k_frac=c["k_frac"], ms_per_exchange=ms,
                cpu_ms_per_exchange=ms_h)


# (a)'s model on the mesh: Qwen3-0.6B at full width and depth through
# Trainer(mesh=, rules=) on DTensor state (TRAIN_MAIN's shape, remat on,
# 2 steps) beside the same Trainer without a mesh, held by the twin
# tolerances (TWIN_LOSS_RTOL, TWIN_GRAD_NORM_RTOL: the mesh moves which
# way DTensor decomposes a product, a bf16 model's rounding), its state
# saved on the mesh and restored without one, and the other way round,
# bit for bit; Gemma3-27B's serving run (MODEL_MAIN's shape, fewer new
# tokens) under use_mesh on DTensor params beside the run without one:
# every step's logits and the SS± cache's counts equal
MESH_MODEL = dict(
    train=dict(arch="qwen3_0_6b", seq_len=2048, batch=4, steps=2, seed=27),
    serve=dict(arch="gemma3_27b", batch=2, prompt=8192, new_tokens=8,
               context=131_072, decay_period=16, seed=23))


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _same_tree(a, b) -> bool:
    """Leaf for leaf equal, DTensor leaves gathered whole."""
    from repro_torch.parallel import sharding as psh
    from repro_torch.train.checkpoint import _flatten

    fa, fb = _flatten(a), _flatten(b)
    return sorted(fa) == sorted(fb) and all(
        torch_equal(psh.full(fa[k]), psh.full(fb[k])) for k in fa)


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.to(b.device), b))


def mesh_train(mesh, device, c, get) -> dict:
    """The Trainer on ``mesh`` and without one (see MESH_MODEL): launches
    (kernel 5 twice a layer a step on the rank's shard, kernel 1 once a
    step for the token tracker), losses and gradient norms held, ms a
    step, the state's layout, the two checkpoint crossings."""
    import tempfile

    from repro_torch.data import DataConfig
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.parallel import sharding as psh
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt

    cfg = get(c["arch"])
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq_len"],
                    global_batch=c["batch"], seed=c["seed"])
    rules = psh.default_rules()
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(on_mesh, sub):
            tc = TrainerConfig(total_steps=c["steps"], ckpt_every=0,
                               ckpt_dir=f"{tmp}/{sub}", log_every=1,
                               seed=c["seed"])
            return Trainer(cfg, dc, tc, mesh=mesh if on_mesh else None,
                           rules=rules if on_mesh else None, device=device)

        runs = {}
        for name in ("mesh", "plain"):
            tr = trainer(name == "mesh", name)
            if (name == "mesh") != all(psh.is_dtensor(t) for t in
                                       tree_leaves(tr.state)):
                raise SystemExit(f"mesh train: the {name} trainer's state is "
                                 f"{'not ' if name == 'mesh' else ''}"
                                 f"DTensors")
            reset_counts()
            with AttentionSpy(keep=name == "mesh") as spy:
                tr.run()
                sync(device)
            fl, fu = check_train_launches(
                f"mesh train {name}", read_counts(),
                2 * cfg.num_layers * c["steps"], c["steps"], spy)
            runs[name] = dict(
                losses=[r["loss"] for r in tr.metrics_log],
                grad_norms=[r["grad_norm"] for r in tr.metrics_log],
                ms_per_step=[r["step_time_s"] * 1e3 for r in tr.metrics_log],
                flash_by_path=fl, fused_by_layout=fu)
            if name == "mesh":
                mesh_tr = tr
                rec["embed_placements"] = str(
                    tuple(tr.state.params["embed"].placements))
                # kernel 5 against its plain version on the operands the
                # mesh run gave it (a rank's shards)
                kept = {k: tuple(t.detach() if hasattr(t, "detach") else t
                                 for t in ops)
                        for k, ops in spy.operands.items()}
                del spy
                rec["kernels_vs_plain"] = hold_kept("mesh train", kept)
                rec["local_shapes"] = {k: [list(t.shape) for t in ops[:3]]
                                       for k, ops in kept.items()}
                del kept
            else:
                plain_tr = tr
        m, p = runs["mesh"], runs["plain"]
        bad = [i for i, (a, b) in enumerate(zip(m["losses"], p["losses"]))
               if not _rel(a, b) <= TWIN_LOSS_RTOL]
        bad += [i for i, (a, b) in enumerate(zip(m["grad_norms"],
                                                 p["grad_norms"]))
                if not _rel(a, b) <= TWIN_GRAD_NORM_RTOL]
        if bad or not all(math.isfinite(x) for x in m["losses"] +
                          m["grad_norms"]):
            raise SystemExit(f"mesh train: the mesh run is not the plain "
                             f"run's: {m} against {p}")
        rec.update(runs=runs, loss_rtol=TWIN_LOSS_RTOL,
                   grad_norm_rtol=TWIN_GRAD_NORM_RTOL,
                   ms_per_step_mesh=m["ms_per_step"][-1],
                   ms_per_step_plain=p["ms_per_step"][-1],
                   mesh_overhead_ms_per_step=(m["ms_per_step"][-1]
                                              - p["ms_per_step"][-1]))
        # the state saved on the mesh restores without one, bit for bit,
        # and the plain trainer's restores onto the mesh
        t0 = time.perf_counter()
        mesh_tr.save()
        plain_tr.save()
        sync(device)
        rec["save_s"] = time.perf_counter() - t0
        got, _ = ckpt.restore(f"{tmp}/mesh", {"train": mesh_tr.state},
                              device=device)
        if any(psh.is_dtensor(t) for t in tree_leaves(got)) or \
                not _same_tree(got["train"], mesh_tr.state):
            raise SystemExit("mesh train: the state saved on the mesh did "
                             "not restore without one bit for bit")
        del got
        gc_free(device)
        with psh.use_mesh(mesh, rules):
            got, _ = ckpt.restore(f"{tmp}/plain", {"train": mesh_tr.state},
                                  axes={"train": mesh_tr.axes},
                                  device=device)
        if not all(psh.is_dtensor(t) for t in tree_leaves(got)) or \
                not _same_tree(got["train"], plain_tr.state):
            raise SystemExit("mesh train: the plain state did not restore "
                             "onto the mesh bit for bit")
        rec["restores"] = "bit for bit, both ways"
        del got, mesh_tr, plain_tr
        gc_free(device)
    log(f"mesh (a) train {cfg.name}: {json.dumps(rec)}")
    return rec


def _serve_ms(engine, params, toks, new_tokens, device) -> dict:
    """Prefill ms and decode ms a step (median), each timed with a sync,
    through the engine's own steps (its logits gathered as ``generate``
    gathers them)."""
    import torch
    from repro_torch.parallel import sharding as psh

    sync(device)
    t0 = time.perf_counter()
    logits, cache = engine._prefill(params, {"tokens": toks})
    cur = torch.argmax(psh.full(logits)[:, -1], -1).to(torch.int32)[:, None]
    sync(device)
    prefill = (time.perf_counter() - t0) * 1e3
    steps = []
    for _ in range(new_tokens):
        t0 = time.perf_counter()
        logits, cache, _ = engine._step(params, cache, cur)
        cur = torch.argmax(psh.full(logits)[:, -1], -1).to(
            torch.int32)[:, None]
        sync(device)
        steps.append((time.perf_counter() - t0) * 1e3)
    return dict(prefill_ms=prefill, decode_ms_per_step=statistics.median(
        steps))


def mesh_serve(mesh, device, c, get) -> dict:
    """Gemma3-27B's serving run (see MESH_MODEL) through ``ServeEngine``
    without a mesh and under ``use_mesh`` with DTensor params: kernel 5
    on the prefill and kernel 6 on every decode step in both, every
    step's logits and the SS± cache's counts equal, kernels 5 and 6 held
    to their plain versions on the operands the mesh run gave them, and
    each run's prefill and decode ms."""
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as psh
    from repro_torch.serve import ServeEngine

    cfg = get(c["arch"])
    params, axes = build_model(cfg).init(c["seed"], device=device)
    toks, kw = model_inputs(cfg, c["batch"], c["prompt"], device, c["seed"])
    flash_n, decode_n = attention_calls(cfg)
    rules = psh.default_rules()
    rec, res = {}, {}
    for name in ("plain", "mesh"):
        on = mesh if name == "mesh" else None
        with psh.use_mesh(on, rules if on is not None else None):
            p = psh.distribute(params, axes)
            engine = ServeEngine(cfg, p, c["context"], c["decay_period"],
                                 device=device)
            reset_counts()
            with AttentionSpy(keep=name == "mesh") as spy:
                res[name] = engine.generate(toks, c["new_tokens"],
                                            keep_logits=True, **kw)
                sync(device)
            fl = check_model_launches(f"mesh serve {name}", read_counts(),
                                      flash_n, decode_n * c["new_tokens"],
                                      spy)
            rec[name] = dict(flash_by_path=fl,
                             decode_launches=decode_n * c["new_tokens"],
                             **_serve_ms(engine, p, toks, c["new_tokens"],
                                         device))
            if name == "mesh":
                if not all(psh.is_dtensor(t) for t in
                           hh_entry_of(res[name]["cache"], cfg).values()):
                    raise SystemExit("mesh serve: the SS± cache is not on "
                                     "the mesh")
                rec["cache_placements"] = str(tuple(hh_entry_of(
                    res[name]["cache"], cfg)["counts"].placements))
                rec["kernels_vs_plain"] = hold_kept("mesh serve",
                                                    spy.operands)
                rec["local_shapes"] = {
                    k: [list(t.shape) for t in ops[:3]]
                    for k, ops in spy.operands.items()}
            del engine, p, spy
    got, want = res["mesh"], res["plain"]
    if not all(torch_equal(a, b) for a, b in zip(got["logits"],
                                                 want["logits"])) or \
            len(got["logits"]) != c["new_tokens"] + 1:
        raise SystemExit("mesh serve: the mesh run's logits are not the "
                         "plain run's")
    g, w = (hh_entry_of(r["cache"], cfg) for r in (got, want))
    if not all(torch_equal(psh.full(g[k]), w[k]) for k in ("ids", "counts",
                                                          "errors")):
        raise SystemExit("mesh serve: the mesh run's SS± cache is not the "
                         "plain run's")
    rec.update(logits="equal", hh_counts="equal",
               mesh_overhead_prefill_ms=(rec["mesh"]["prefill_ms"]
                                         - rec["plain"]["prefill_ms"]),
               mesh_overhead_decode_ms_per_step=(
                   rec["mesh"]["decode_ms_per_step"]
                   - rec["plain"]["decode_ms_per_step"]))
    del res, got, want, g, w, params
    gc_free(device)
    log(f"mesh (a) serve {cfg.name}: {json.dumps(rec)}")
    return rec


def mesh_model(mesh, device, c=MESH_MODEL, get=None) -> dict:
    """(a)'s model on the mesh (see MESH_MODEL): training and serving,
    with the launches of kernels 5, 6 and 1 under the mesh. ``get`` picks
    the configs (the full ones, Gemma3 cut to one period, by default; the
    CPU rehearsal passes the smoke ones)."""
    from repro_torch import configs

    t0 = time.perf_counter()
    train = mesh_train(mesh, device, c["train"], get or configs.get)
    serve = mesh_serve(mesh, device, c["serve"],
                       get or (lambda a: one_period(configs.get(a))))
    launches = {"flash": {}, "decode": {
        "mesh (a) serve": serve["mesh"]["decode_launches"]},
        "fused": train["runs"]["mesh"]["fused_by_layout"]}
    for part in (train["runs"]["mesh"], serve["mesh"]):
        for path, n in part["flash_by_path"].items():
            launches["flash"][path] = launches["flash"].get(path, 0) + n
    errs = {"flash": 0.0, "decode": 0.0}
    for rec in (train, serve):
        for key, r in rec["kernels_vs_plain"].items():
            kind = "decode" if key.startswith("decode") else "flash"
            errs[kind] = max(errs[kind], r["max_abs_err"])
    return dict(train=train, serve=serve, launches=launches,
                max_abs_err=errs, seconds=time.perf_counter() - t0)


def mesh_phase(device, stream, block, spec, q_spec, c=MESH,
               model=MESH_MODEL, get=None) -> dict:
    """The mesh paths (fatal). (a) one rank: a process group of one rank
    over a ``FileStore`` (NCCL for the card's tensors, gloo for the CPU
    twin's) and ``make_smoke_mesh(1)``: the sharded bank (``spec``)
    through ``update_block(path="shard_map")`` (kernel 3 on the rank's
    S rows), equal bit for bit to ``"vmap"`` and ``"block"`` and, over
    the first blocks, to ``"block"`` on the CPU; the dyadic sharded bank
    (``q_spec``) through its shard_map path (kernel 2), equal to
    ``"bank"``; the compressed exchange over the model's parameter
    shapes, equal to the same exchange on the CPU leaf for leaf (one
    rank: the top-k scatter of unique indices, exact); the model on the
    mesh (``mesh_model``: ``model``'s training and serving, ``get`` its
    configs). (b) ``c["ranks"]``
    child processes sharing the card in a gloo group: a ``StreamSession``
    of ``spec`` on ``"bank"`` under ``use_mesh`` of a ("data",) mesh
    takes the shard_map path (kernel 3 on S / ranks rows a rank); the
    gathered bank (through host memory on gloo) equals (a)'s. Returns
    runs, times and launches."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.sketch_update import kernel
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel import sharding as psh
    from repro_torch.sketch import api
    from repro_torch.sketch import dyadic_sharded as ds
    from repro_torch.sketch import sharded as shd

    split, banked = "sketch_residual_kernel", "sketch_residual_kernel_banked"
    fused = "sketch_update_kernel_fused"
    out = {"runs": {}, "times": {}}
    blocks = _blocks(stream, block)[:c["blocks"]]
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if cuda:
            # the device NCCL and the mesh take for this rank
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if cuda else "gloo",
            store=dist.FileStore(str(tmp / "store_a"), 1), rank=0,
            world_size=1)
        try:
            mesh = make_smoke_mesh(1, device=torch.device(device).type)
            v, ub, qv = spec.variant_id, spec.bits, q_spec.variant_id
            # kernel 3's layout by a shard's rows of 128 slots, kernel 2's
            # by the widest layer's slots
            k = -(-spec.capacity // spec.shards)
            k3 = kernel.residual_layout(-(-k // 128))
            k2 = kernel.banked_layout(max(q_spec.layer_capacities()))
            with psh.use_mesh(mesh):
                got, run, ms = mesh_runs(
                    "mesh (a) sharded shard_map", spec, blocks, device,
                    lambda s, i, w: shd.update_block(
                        s, i, w, v, universe_bits=ub, path="shard_map"),
                    split, k3)
            if not psh.is_dtensor(got.bank.ids):
                raise SystemExit("mesh (a): the shard_map path returned no "
                                 "mesh-sharded bank")
            out["runs"]["mesh (a) sharded shard_map"] = run
            out["times"]["a_shard_map_ms_per_block"] = ms
            t0 = time.perf_counter()
            bank = _full_bank(got.bank)
            sync(device)
            out["times"]["a_gather_ms"] = (time.perf_counter() - t0) * 1e3
            for path, name, layout in (
                    ("vmap", split, k3),
                    ("block", fused, kernel.fused_layout(k))):
                twin, _, ms = mesh_runs(
                    f"mesh (a) sharded {path}", spec, blocks, device,
                    lambda s, i, w, p=path: shd.update_block(
                        s, i, w, v, universe_bits=ub, path=p),
                    name, layout)
                out["times"][f"a_{path}_ms_per_block"] = ms
                if not _same(bank, twin.bank):
                    raise SystemExit(f"mesh (a): the shard_map bank differs "
                                     f"from the {path} path's")
            # the first blocks on the CPU (the plain partition core)
            first = blocks[:c["cpu_blocks"]]
            with psh.use_mesh(mesh):
                head, _, _ = mesh_runs(
                    "mesh (a) sharded shard_map head", spec, first, device,
                    lambda s, i, w: shd.update_block(
                        s, i, w, v, universe_bits=ub, path="shard_map"),
                    split, k3)
            plain = api.make(spec, torch.device("cpu"))
            for i, w in first:
                plain = shd.update_block(plain, torch.as_tensor(i),
                                         torch.as_tensor(w), v,
                                         universe_bits=ub, path="block")
            if not _same([t.cpu() for t in _full_bank(head.bank)],
                         plain.bank):
                raise SystemExit("mesh (a): the shard_map bank differs from "
                                 "the CPU's over the first blocks")
            # the dyadic sharded bank (kernel 2)
            q_blocks = blocks[:c["q_blocks"]]
            with psh.use_mesh(mesh):
                qgot, run, ms = mesh_runs(
                    "mesh (a) dyadic shard_map", q_spec, q_blocks, device,
                    lambda s, i, w: ds.update_block(s, i, w, qv,
                                                    path="shard_map"),
                    banked, k2)
            out["runs"]["mesh (a) dyadic shard_map"] = run
            out["times"]["a_dyadic_shard_map_ms_per_block"] = ms
            qtwin, _, ms = mesh_runs(
                "mesh (a) dyadic bank", q_spec, q_blocks, device,
                lambda s, i, w: ds.update_block(s, i, w, qv, path="bank"),
                banked, k2)
            out["times"]["a_dyadic_bank_ms_per_block"] = ms
            if not (_same(_full_bank(qgot.bank), qtwin.bank)
                    and int(qgot.mass) == int(qtwin.mass)):
                raise SystemExit("mesh (a): the dyadic shard_map bank "
                                 "differs from the bank path's")
            del qgot, qtwin
            # the compressed exchange over the model's parameter shapes
            out["exchange"] = exchange_phase(mesh, c, device)
            out["model"] = mesh_model(mesh, device, model, get)
        finally:
            dist.destroy_process_group()
        # (b): ranks sharing the card over gloo
        blocks_b = np.stack([np.stack(b) for b in blocks])
        np.save(tmp / "blocks.npy", blocks_b)
        (tmp / "spec.json").write_text(json.dumps(dict(
            fields={f: getattr(spec, f) for f in (
                "kind", "eps", "alpha", "variant", "shards", "bits")},
            block=block, device=str(device))))
        procs = [subprocess.Popen(
            [sys.executable, "-X", "faulthandler",
             str(pathlib.Path(__file__).resolve()),
             "--mesh-rank", str(r), str(c["ranks"]), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(c["ranks"])]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=c["child_timeout"])[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise SystemExit(f"mesh (b): rank {r} exited "
                                 f"{p.returncode}:\n{text[-4000:]}")
        for r in range(c["ranks"]):
            res = json.loads((tmp / f"rank{r}.json").read_text())
            got_b = np.load(tmp / f"rank{r}.npz")
            if not all(np.array_equal(got_b[name], t.cpu().numpy())
                       for name, t in zip(("ids", "counts", "errors"),
                                          bank)):
                raise SystemExit(f"mesh (b): rank {r}'s gathered bank "
                                 f"differs from (a)'s")
            label = f"mesh (b) rank {r} session"
            n = check_launches(label, res.pop("counts"), split, len(blocks),
                               k3)
            out["runs"][label] = dict(
                kernel=split, layout=k3, launches=n,
                ms_per_block=res["session_ms_per_block"])
            out["times"][f"b_rank{r}"] = res
    return out


def mesh_child(rank: int, world: int, tmp: str) -> int:
    """One rank of the mesh phase's (b): a gloo group of ``world`` ranks
    over the FileStore in ``tmp``, every rank on the same device; the
    session under ``use_mesh`` of a ("data",) mesh, its launches, its
    gathered bank and its times beside ``"block"`` and ``"vmap"`` on the
    whole bank, written to ``tmp`` for the parent, which checks the
    launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.kernels.sketch_update import kernel
    from repro_torch.parallel import sharding as psh
    from repro_torch.sketch import api, sharded as shd
    from repro_torch.sketch.session import StreamSession

    tmp = pathlib.Path(tmp)
    conf = json.loads((tmp / "spec.json").read_text())
    spec = api.SketchSpec(**conf["fields"])
    device = torch.device(conf["device"])
    blocks = np.load(tmp / "blocks.npy")
    if device.type == "cuda":
        _build.build(kernel.SOURCES)
        torch.cuda.set_device(0)     # every rank on the one card
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store_b"), world), rank=rank, world_size=world)
    try:
        mesh = psh.host_device_mesh(world, axis="data", device=device.type)
        res = {}
        with psh.use_mesh(mesh):
            sess = StreamSession(spec, block=conf["block"], device=device)
            reset_counts()
            first, ms, _ = _first_and_rest(
                lambda b: sess.ingest_block(*b), list(blocks), device)
            res["counts"] = read_counts()
            res["session_first_block_ms"] = first
            res["session_ms_per_block"] = ms
            if not psh.is_dtensor(sess.state.bank.ids):
                raise SystemExit(f"mesh (b) rank {rank}: the session did "
                                 f"not take the shard_map path")
            res["local_rows"] = sess.state.bank.ids.to_local().shape[0]
            dist.barrier()
            sync(device)
            t0 = time.perf_counter()
            saved = api.save(spec, sess.state)
            res["gather_ms"] = (time.perf_counter() - t0) * 1e3
        # the single-device paths on the whole bank, timed beside it
        dev = [(torch.as_tensor(i, device=device),
                torch.as_tensor(w, device=device)) for i, w in blocks]
        for path in ("block", "vmap"):
            box = [api.make(spec, device)]

            def step(b, path=path):
                box[0] = shd.update_block(box[0], *b, spec.variant_id,
                                          universe_bits=spec.bits, path=path)
                return box[0]

            _, ms, st = _first_and_rest(step, dev, device)
            res[f"{path}_ms_per_block"] = ms
            if not all(np.array_equal(saved[n], t.cpu().numpy()) for n, t in
                       zip(("ids", "counts", "errors"), st.bank)):
                raise SystemExit(f"mesh (b) rank {rank}: the session's bank "
                                 f"differs from the {path} path's")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(tmp / f"rank{rank}.npz", **{n: saved[n] for n in (
        "ids", "counts", "errors")})
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


# ---------------------------------------------------------------------------
# The dry-run phase: the train and decode steps traced on a fake group
# ---------------------------------------------------------------------------

# train main's shape (TRAIN_MAIN: Qwen3-0.6B, B = 4 x 2,048, remat) and the
# model phase's decode step (MODEL_MAIN: Gemma3-27B cut to one period, B =
# 2 at context 131,072), each traced on a one-rank fake group; the child
# must finish within budget_s
DRYRUN = dict(train=dict(arch="qwen3_0_6b", seq_len=2048, batch=4),
              decode=dict(arch="gemma3_27b", batch=2, context=131_072),
              budget_s=90, flops_rtol=1e-3)


def dryrun_child(tmp: str) -> int:
    """The dry-run phase's child: a one-rank fake process group and a
    (1, 1) mesh on the conf's device, train main's step and the decode
    step traced under ``FakeTensorMode`` (``launch.dryrun.trace_cell``),
    their records and the device memory this process allocated, written
    to ``tmp``. It runs in a process of its own so that its fake group
    never meets the mesh phase's groups."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import default_rules

    tmp = pathlib.Path(tmp)
    conf = json.loads((tmp / "conf.json").read_text())
    c, device = conf["c"], conf["device"]
    get = configs.get_smoke if conf["smoke"] else configs.get

    def allocated():
        return (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)

    dryrun.fake_group(1)
    mesh = make_smoke_mesh(1, device)
    out = {"max_allocated_after": {"mesh": allocated()}}
    if device == "cuda":
        # FakeTensorMode starts the card's context once a device name with
        # one 4-byte tensor, made and freed (``fake_tensor.
        # init_gpu_context``): made to happen here, before the count
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            for name in ("cuda", f"cuda:{torch.cuda.current_device()}"):
                torch.empty(1, device=name)
        out["context_probe_bytes"] = allocated()
        torch.cuda.reset_peak_memory_stats()
    for name, kind in (("train", "train"), ("decode", "decode")):
        cc = c[name]
        cfg = get(cc["arch"])
        if kind == "decode":
            cfg = one_period(cfg)
            shape = InputShape("decode main", cc["context"], cc["batch"],
                               "decode")
            rules = dryrun.cell_rules(shape, multi=False)
        else:
            shape = InputShape("train main", cc["seq_len"], cc["batch"],
                               "train")
            rules = default_rules()
        t0 = time.perf_counter()
        trace, memory = dryrun.trace_cell(cfg, shape, mesh, rules,
                                          {"remat": True}, device,
                                          keep=False)
        rec = dryrun.record(cfg, shape, trace, memory, chips=1)
        rec.update(seconds=time.perf_counter() - t0,
                   peak_bytes=trace.peak,
                   flops_by_op=dict(trace.flops_by_op))
        out[name] = rec
        out["max_allocated_after"][name] = allocated()
    if device == "cuda":
        out["device_bytes"] = dict(
            allocated=torch.cuda.memory_allocated(),
            max_allocated=torch.cuda.max_memory_allocated(),
            reserved=torch.cuda.memory_reserved())
    else:
        out["device_bytes"] = dict(allocated=0, max_allocated=0, reserved=0)
    (tmp / "dryrun.json").write_text(json.dumps(out))
    return 0


def dryrun_phase(device, flops_want, flash_per_step, decode_per_step,
                 peak_measured_gb=None, c=DRYRUN, smoke=False) -> dict:
    """Train main's step and the decode step traced in a child process
    (``dryrun_child``), held to the real runs, each gate fatal:

    (a) the traced calls of kernel 5's op equal the launches a real train
        step makes (``flash_per_step``: 56 for Qwen3-0.6B, a forward and
        remat's recompute a layer), and kernel 6's a real decode step's
        (``decode_per_step``: 6, one a layer of the period);
    (b) the traced FLOPs of the train step equal ``flops_want``, what
        ``FlopCounterMode`` counted over one real step of train main
        (``count_step_flops``), within ``flops_rtol``; on a failure both
        totals are printed op by op;
    (c) the traces allocated no device memory (``max_memory_allocated``
        stays 0 once FakeTensorMode's one context probe, a 4-byte tensor
        made and freed, is done);

    and the child ends within ``budget_s``. Printed, not gated: the
    predicted per-device peak (arguments + temp) beside train main's
    measured ``max_memory_allocated``, and the roofline terms."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "conf.json").write_text(json.dumps(dict(
            c=c, device=torch_device_type(device), smoke=smoke)))
        try:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--dryrun-child", str(tmp)], capture_output=True,
                text=True, timeout=c["budget_s"])
        except subprocess.TimeoutExpired:
            raise SystemExit(f"dry-run phase: the child ran past its "
                             f"{c['budget_s']} s budget") from None
        if proc.returncode != 0:
            raise SystemExit(f"dry-run phase: the child failed "
                             f"({proc.returncode}):\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
        res = json.loads((tmp / "dryrun.json").read_text())
    seconds = time.perf_counter() - t0
    train, decode = res["train"], res["decode"]
    got = dict(flash=train["kernel_ops"]["flash"],
               decode=decode["kernel_ops"]["decode"])
    if got != dict(flash=flash_per_step, decode=decode_per_step):
        raise SystemExit(f"dry-run phase (a): traced kernel op calls {got}, "
                         f"the real steps launch flash {flash_per_step} and "
                         f"decode {decode_per_step}")
    traced = train["cost_raw"]["flops"]
    rel = abs(traced - flops_want["total"]) / max(flops_want["total"], 1)
    if not rel <= c["flops_rtol"]:
        ops = sorted(set(train["flops_by_op"]) | set(flops_want["by_op"]))
        for op in ops:
            log(f"  {op}: traced {train['flops_by_op'].get(op, 0)}, "
                f"counted {flops_want['by_op'].get(op, 0)}")
        raise SystemExit(f"dry-run phase (b): the trace counts {traced} "
                         f"FLOPs, FlopCounterMode {flops_want['total']} "
                         f"(relative {rel})")
    dev = res["device_bytes"]
    if dev["max_allocated"] != 0:
        raise SystemExit(f"dry-run phase (c): the traces allocated device "
                         f"memory: {dev}, the peak after each stage "
                         f"{res['max_allocated_after']}")
    mem = train["memory"]
    out = dict(
        seconds=seconds, child_seconds=dict(train=train["seconds"],
                                            decode=decode["seconds"]),
        kernel_ops=got, flops_traced=traced, flops_counted=flops_want[
            "total"], flops_rel=rel, device_bytes=dev,
        context_probe_bytes=res.get("context_probe_bytes", 0),
        predicted_peak_gb=(mem["argument_size_in_bytes"]
                           + mem["temp_size_in_bytes"]) / 1e9,
        measured_peak_gb=peak_measured_gb, memory=dict(
            train=mem, decode=decode["memory"]),
        collectives=dict(train=train["collectives"],
                         decode=decode["collectives"]),
        roofline=dict(train=train["roofline"], decode=decode["roofline"]))
    log(f"dry-run phase: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the analyzer on the card
# ---------------------------------------------------------------------------

def analysis_phase(device, stream, block, spec) -> dict:
    """The recompile (SK203) and donation (SK204) layers of
    ``repro_torch.analysis`` on ``device`` over the reference's k = 64
    grid, the recompile check on ``spec``'s cell at ``block`` (two
    sessions on ``stream``'s first block: one cell, one graph on the
    card), and the ``ast`` layer with ``--ci``. Fatal on any finding.
    Returns the reports, the finding counts by layer, the launches and
    the seconds."""
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.analysis.donation_audit import audit_donation
    from repro_torch.analysis.recompile_audit import audit_recompiles

    t0 = time.perf_counter()
    on_card = torch_device_type(device) == "cuda"
    found, out = {}, {}
    reset_counts()
    found["recompile"], out["recompile"] = audit_recompiles(
        block=64, k=64, device=device)
    found["donation"], out["donation"] = audit_donation(
        k=64, block=64, device=device)
    found["main cell"], out["main cell"] = audit_recompiles(
        grid=[spec, spec], block=block, device=device, stream=stream)
    out["launches"] = {key: n for key, n in read_counts().items() if n}
    bad = [f.render() for fs in found.values() for f in fs]
    if bad:
        raise SystemExit("analysis phase: findings:\n" + "\n".join(bad))
    main_cell = out["main cell"]
    if (main_cell["cells"], main_cell["graphs"]) != (1, int(on_card)):
        raise SystemExit(f"analysis phase: the main spec's cell holds "
                         f"{main_cell['cells']} cells and "
                         f"{main_cell['graphs']} graphs")
    donation = out["donation"]
    if (donation["donate=True"], donation["donate=False"]) != (on_card,
                                                               False):
        raise SystemExit(f"analysis phase: donation {donation}")
    launched = sum(n for key, n in out["launches"].items()
                   if key.startswith(FUSED))
    if on_card and not launched:
        raise SystemExit("analysis phase: the bank cells launched no "
                         "kernel 1")
    rc = analysis_main(["--layers", "ast", "--ci"])
    if rc != 0:
        raise SystemExit(f"analysis phase: the ast layer exited {rc}")
    found["ast"] = []
    out["findings"] = {layer: len(fs) for layer, fs in found.items()}
    out["seconds"] = time.perf_counter() - t0
    return out


def torch_device_type(device) -> str:
    import torch

    return torch.device(device).type


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main() -> int:
    import dataclasses

    import torch

    start = time.perf_counter()
    elapsed = {}

    def phase_done(name):
        """Seconds since the start at the end of each phase (logged)."""
        elapsed[name] = time.perf_counter() - start
        log(f"-- {name} done: {elapsed[name]:.1f} s since the start")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.kernel import \
        SOURCE as DECODE_SOURCE
    from repro_torch.kernels.flash_attention.kernel import \
        SOURCES as FLASH_SOURCES
    from repro_torch.kernels.sketch_update import kernel, ops, ref
    from repro_torch.sketch.api import SketchSpec
    from repro_torch.sketch.state import SketchState

    device = torch.device("cuda")
    card = gpu_line()
    log(f"device: {card}")
    # the card's rates must be the preset's: hw_config raises for a card
    # without one
    from repro_torch.platform import hw_config
    if hw_config() is not H100:
        raise SystemExit(f"the rates of {card} are not the H100 preset's")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    sources = (*kernel.SOURCES, *FLASH_SOURCES, DECODE_SOURCE)
    t0 = time.perf_counter()
    _build.build(sources)
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({len(sources)} sources in parallel)")

    phase_done("build")
    worst = check_all_cases(device)
    phase_done("kernel cases")

    B = 65536
    main_spec = SketchSpec(kind="frequency", eps=1e-5, alpha=2.0,
                           variant="sspm", shards=128, bits=24,
                           backend="kernel")
    lazy_spec = SketchSpec(kind="frequency", eps=1e-3, alpha=2.0,
                           variant="lazy", bits=24, backend="kernel")
    a_spec = dataclasses.replace(main_spec, shards=None, backend="block")
    b_spec = dataclasses.replace(main_spec, backend="block")
    lazy_block_spec = dataclasses.replace(lazy_spec, backend="block")
    serial_spec = SketchSpec(kind="frequency", eps=1e-3, alpha=2.0,
                             variant="sspm", bits=24)
    main_stream = make_stream(64, B, seed=1)
    lazy_stream = make_stream(16, B, seed=2)

    runs, last = {}, {}
    fused, split = "sketch_update_kernel_fused", "sketch_residual_kernel"
    runs["main"], last["main"], main_sess = run_path(
        "main sspm shards=128", main_spec, main_stream, B, device, 2.0,
        fused, fused_path, ref.fused_update_ref, layout="staged")
    main_bank = main_sess.state.bank
    # block 1 of the lazy stream brings the most evictions (2,968)
    runs["lazy"], last["lazy"], sess = run_path(
        "lazy k=2000", lazy_spec, lazy_stream, B, device, 1.0, fused,
        fused_path, ref.fused_update_ref, at=1, layout="staged")
    lazy_bank = _bank_of(sess.state)
    a_stream = make_stream(32, B, seed=4)
    runs["path_a"], last["path_a"], sess = run_path(
        "block sspm k=400000", a_spec, a_stream, B, device, 2.0, split,
        split_path, ref.residual_phase, layout="summary+chain")
    a_bank = _bank_of(sess.state)
    runs["lazy_block"], last["lazy_block"], sess = run_path(
        "block lazy k=2000", lazy_block_spec, lazy_stream, B, device, 1.0,
        split, split_path, ref.residual_phase, at=1, layout="staged")
    if not _same(_bank_of(sess.state), lazy_bank):
        raise SystemExit("the block backend's lazy bank differs from the "
                         "kernel backend's")
    runs["path_b"], last["path_b"], sess = run_path(
        "block sspm shards=128", b_spec, main_stream, B, device, 2.0, split,
        split_path, ref.residual_phase, layout="staged")
    if not _same(sess.state.bank, main_bank):
        raise SystemExit("path B's bank differs from the kernel backend's")
    fed_runs = feeder_phase(main_spec, main_stream, B, device, main_bank)
    merged = merge_phase(main_spec, main_sess, lazy_stream, B, device,
                         main_stream)

    def banked(bank, it, w):
        return ops.sketch_block_update_banked(
            bank, *_router(main_spec, bank).route_dense(it, w), 2)

    runs["banked"], last["banked"], bank = run_ops_path(
        "banked sspm shards=128", main_spec, main_stream, B, device, 2.0,
        "sketch_residual_kernel_banked", banked_path, banked,
        ref.residual_phase_banked, layout="staged")
    if not _same(bank, main_bank):
        raise SystemExit("the banked split path's bank differs from the "
                         "fused path's")

    def serial(bank, it, w):
        out = ops.sketch_block_update_serial(
            SketchState(*(t[0] for t in bank)), it, w, 2)
        return SketchState(*(t[None] for t in out))

    serial_stream = make_stream(8, B, seed=5)
    runs["serial"], last["serial"], _ = run_ops_path(
        "serial sspm k=4000", serial_spec, serial_stream, B, device, 2.0,
        "sketch_update_kernel_serial", serial_path, serial)

    phase_done("frequency runs")
    bank_runs, bank_last = bank_phase(
        dict(main=main_spec, lazy=lazy_spec, a=a_spec,
             serial=dataclasses.replace(serial_spec, backend="serial")),
        dict(main=main_stream, lazy=lazy_stream, a=a_stream,
             serial=serial_stream),
        dict(main=main_bank, lazy=lazy_bank, a=a_bank), B, device)
    runs.update(bank_runs)
    phase_done("bank runs")
    q_specs = quantile_specs()
    q_streams = dict(main=main_stream, sharded=main_stream,
                     lazy=make_stream(QUANTILE_LAZY_BLOCKS + 1, B, seed=8))
    q_runs, q_extra, q_finals = quantile_phase(q_specs, q_streams, B, device)
    phase_done("quantile runs")
    runs.update({f"quantile {name}": r for name, r in q_runs.items()})
    tenant_runs, tenant_operands, tenant_later = tenant_phase(device)
    runs.update({f"tenant {name}": r for name, r in tenant_runs.items()})
    phase_done("tenant runs")
    family_runs, unbiased_last, worst[UNBIASED] = family_phase(
        device, main_stream, B)
    phase_done("family")
    fault_runs = fault_phase(device, main_stream, B, q_specs["sharded"])
    phase_done("faults")
    mesh = mesh_phase(device, main_stream, B, fault_spec(),
                      q_specs["sharded"])
    runs.update(mesh["runs"])
    for layout, n in mesh["model"]["launches"]["fused"].items():
        runs[f"mesh (a) train trackers {layout}"] = dict(
            kernel=FUSED, launches=n, layout=layout)
    log(f"mesh phase ({card}): {json.dumps(mesh['times'])}")
    log(f"mesh phase exchange ({card}): {json.dumps(mesh['exchange'])}")
    tr, sv = mesh["model"]["train"], mesh["model"]["serve"]
    log(f"mesh phase model ({card}), ms on the mesh and without: "
        + json.dumps(dict(
            train_step=[tr["ms_per_step_mesh"], tr["ms_per_step_plain"]],
            prefill=[sv["mesh"]["prefill_ms"], sv["plain"]["prefill_ms"]],
            decode_step=[sv["mesh"]["decode_ms_per_step"],
                         sv["plain"]["decode_ms_per_step"]],
            launches=mesh["model"]["launches"])))
    phase_done("mesh")

    times = {
        fused: time_kernel(kernel.sketch_update_kernel_fused,
                           ref.fused_update_ref, last["main"], 2,
                           fused_bound, 20, 3),
        "sketch_residual_kernel_banked": time_kernel(
            kernel.sketch_residual_kernel_banked, ref.residual_phase_banked,
            last["banked"], 2, banked_bound, 20, 3),
        split: time_kernel(kernel.sketch_residual_kernel,
                           ref.residual_phase, last["path_a"], 2,
                           split_bound, 10, 1),
        "sketch_update_kernel_serial": time_kernel(
            kernel.sketch_update_kernel_serial, ref.serial_update_ref,
            last["serial"], 2, serial_bound, 3, 1),
    }
    # kernel 1 beside the main run: on the lazy run's heaviest block
    times_fused_lazy = time_kernel(kernel.sketch_update_kernel_fused,
                                   ref.fused_update_ref, last["lazy"], 1,
                                   fused_bound, 10, 1)
    # kernel 3 beside path A: on path B's last block and on the block-lazy
    # run's heaviest block
    times_b = time_kernel(kernel.sketch_residual_kernel, ref.residual_phase,
                          last["path_b"], 2, split_bound, 10, 1)
    times_lazy = time_kernel(kernel.sketch_residual_kernel,
                             ref.residual_phase, last["lazy_block"], 1,
                             split_bound, 10, 1)
    for name, t in times.items():
        log(f"{name} at its run's shapes: {json.dumps(t)}")
    log(f"sketch_update_kernel_fused on lazy's block 1: "
        f"{json.dumps(times_fused_lazy)}")
    log(f"sketch_residual_kernel at path B's shapes: {json.dumps(times_b)}")
    log(f"sketch_residual_kernel on block lazy's block 1: "
        f"{json.dumps(times_lazy)}")
    serial_by_path = serial_paths(last["serial"], B)
    log(f"sketch_update_kernel_serial by path: {json.dumps(serial_by_path)}")
    q_times = quantile_times(q_specs, q_finals, device)
    # kernel 1 on the partition layout: the bank main run's last block,
    # the bank lazy run's block 1, the bank k=400000 run's last held block
    bank_times = {
        f"{fused} {key}": time_kernel(
            kernel.sketch_update_kernel_fused, ref.fused_update_ref,
            bank_last[key], variant, fused_bound, reps, plain_reps)
        for key, variant, reps, plain_reps in (("bank main", 2, 20, 3),
                                               ("bank lazy", 1, 10, 1),
                                               ("bank a", 2, 10, 1))}
    for label, t in bank_times.items():
        log(f"{label} on the partition layout: {json.dumps(t)}")
    tenant_kernel_times = tenant_times(tenant_operands, device)
    times[UNBIASED] = time_unbiased(unbiased_last)
    log(f"{UNBIASED} on unbiased main's last block: "
        f"{json.dumps(times[UNBIASED])}")
    phase_done("kernel times")
    prof = {label: profile_blocks(spec, B, 8, seed=3, device=device)
            for label, spec in (("main", main_spec), ("lazy", lazy_spec),
                                ("path_a", a_spec), ("path_b", b_spec),
                                ("quantile", q_specs["sspm"]),
                                ("bank", dataclasses.replace(
                                    main_spec, backend="bank")))}
    log(f"profile of the sessions: {json.dumps(prof)}")
    for label, p in prof.items():
        log(f"profile {label}: " + "; ".join(
            f"{way} wall {p[way]['wall_ms_per_block']:.3f} ms/block "
            f"({p[way]['unprofiled_wall_ms_per_block']:.3f} unprofiled), busy "
            f"{p[way]['device_busy_ms_per_block']} ms/block, idle share "
            f"{p[way]['device_idle_share']}, host launch "
            f"{p[way]['host_cuda_ms_per_block']['launch']:.3f} ms/block"
            for way in ("eager", "captured")))
    phase_done("profiles")
    attention_entries, attention = attention_phase(device)
    phase_done("attention")
    model_launches, model = model_phase(device)
    phase_done("model")
    train_launches, train = train_phase(device)
    phase_done("train")
    tm, mm = train["main"], model["main"]
    dryrun = dryrun_phase(device, tm["flop_counter"],
                          tm["flash_launches"] // tm["steps"],
                          mm["decode_launches"] // mm["new_tokens"],
                          tm["peak_memory_gb"])
    phase_done("dry-run")
    # kernels 5 and 6 on the model phase's paths too: flash by path, decode
    # by run; their times at the serving shapes beside the attention
    # phase's
    flash_entry, decode_entry = attention_entries
    for path, n in model_launches["flash"].items():
        flash_entry["launches"] += n
        flash_entry["launches_by_path"][path] += n
    decode_entry["launches_by_run"] = {"attention phase": decode_entry[
        "launches"], **{f"model {run}": n for run, n in
                        model_launches["decode"].items()}}
    decode_entry["launches"] = sum(decode_entry["launches_by_run"].values())
    for entry, kind in ((flash_entry, "flash"), (decode_entry, "decode")):
        entry["max_abs_err"] = max(entry["max_abs_err"], model[
            "kernels_vs_plain"]["max_abs_err"][kind])
        entry["model_shapes_held"] = model["kernels_vs_plain"]["shapes"][kind]
    for entry, prefix in ((flash_entry, ("windowed", "causal")),
                          (decode_entry, ("decode",))):
        entry["serving"] = {
            key: {k: t[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "max_abs_err",
                                    "row_share", "row_share_limit",
                                    "device_ms_per_call",
                                    "device_ms_per_call_cold",
                                    "host_ms_per_call") if k in t}
            for key, t in model["serving_kernel_times"].items()
            if key.startswith(prefix)}
    # kernel 5 on the training path: its launches (the forward and remat's
    # recompute of every attention layer), the rows and gradients held at
    # the training shapes, its times at the main run's shape; kernel 1's
    # launches by the trainers' trackers
    for path, n in train_launches["flash"].items():
        flash_entry["launches"] += n
        flash_entry["launches_by_path"][path] += n
    flash_entry["training_launches"] = sum(train_launches["flash"].values())
    # kernels 5 and 6 on the mesh: their launches on each rank's shard in
    # the mesh phase's training and serving runs, held to their plain
    # versions on those shards
    mesh_launches = mesh["model"]["launches"]
    for path, n in mesh_launches["flash"].items():
        flash_entry["launches"] += n
        flash_entry["launches_by_path"][path] += n
    flash_entry["mesh_launches"] = sum(mesh_launches["flash"].values())
    decode_entry["launches_by_run"].update(mesh_launches["decode"])
    decode_entry["launches"] = sum(decode_entry["launches_by_run"].values())
    decode_entry["mesh_launches"] = sum(mesh_launches["decode"].values())
    for entry, kind in ((flash_entry, "flash"), (decode_entry, "decode")):
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   mesh["model"]["max_abs_err"][kind])
    for run in ("main", "moe"):
        for r in (*train[run]["kernels_vs_plain"].values(),
                  *train[run]["flash_grads_vs_plain"].values()):
            flash_entry["max_abs_err"] = max(flash_entry["max_abs_err"],
                                             r["max_abs_err"])
        for layout, n in train[run]["fused_by_layout"].items():
            runs[f"train {run} trackers {layout}"] = dict(
                kernel=fused, launches=n, layout=layout)
    flash_entry["training"] = {
        key: {k: t[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "max_abs_err",
                                "row_share", "row_share_limit") if k in t}
        for key, t in train["main"]["kernel_times"].items()}
    service_profiles(tenant_later, tenant_runs)
    phase_done("service profiles")
    analysis = analysis_phase(device, main_stream, B,
                              dataclasses.replace(main_spec, backend="bank"))
    log(f"analysis phase ({card}): {analysis['seconds']:.1f} s, findings "
        f"{json.dumps(analysis['findings'])}, {json.dumps(analysis)}")
    phase_done("analysis")

    replaces = {fused: 144, "sketch_residual_kernel_banked": 278,
                split: 220, "sketch_update_kernel_serial": 396}
    source = {fused: "fused_update.cu",
              "sketch_residual_kernel_banked": "fused_update.cu",
              split: "residual.cu",
              "sketch_update_kernel_serial": "serial_update.cu"}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/sketch_update/csrc/{source[name]}",
        "replaces": f"src/repro/kernels/sketch_update/kernel.py:{replaces[name]}",
        "launches": sum(r["launches"] for r in runs.values()
                        if r["kernel"] == name),
        "max_abs_err": worst[name],
        "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"],
        "library_ms": None,   # no PyTorch call computes these chains
        "stream_ms": times[name]["stream_ms"],
    } for name in KERNELS]
    # the port's own kernel: no Pallas counterpart (the reference's scan)
    kernels.append({
        "name": UNBIASED,
        "route": "cuda",
        "source": "src/repro_torch/kernels/sketch_update/csrc/"
                  "unbiased_update.cu",
        "replaces": "src/repro/sketch/family.py:123",
        "launches": sum(n for r in family_runs.values()
                        if isinstance(r.get("launches"), dict)
                        for key, n in r["launches"].items()
                        if key.startswith(UNBIASED)),
        "max_abs_err": worst[UNBIASED],
        **{key: times[UNBIASED][key] for key in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by",
                                                 "stream_ms")},
        "library_ms": None,   # no PyTorch call computes this scan
    })
    kernels += attention_entries
    # kernels 1-3 by layout: calls in the counted runs (a call on kernel
    # 3's unstaged layouts is two device launches)
    # kernel 1 on the tenant layouts (R = 1,024 and 32,768 rows)
    kernels[0]["tenant_layouts"] = {
        name: {key: t[key] for key in ("rows", "ms", "bound_ms", "bound_by",
                                       "plain_ms", "pad_bank_ms")}
        for name, t in tenant_kernel_times.items()}
    for entry in kernels[1:3]:
        # kernels 2 and 3 by run, the mesh phase's runs among them
        entry["launches_by_run"] = {
            label: r["launches"] for label, r in runs.items()
            if r["kernel"] == entry["name"]}
    for entry in kernels[:3]:
        entry["launches_by_path"] = {
            r["layout"]: sum(q["launches"] for q in runs.values()
                             if q["kernel"] == entry["name"]
                             and q["layout"] == r["layout"])
            for r in runs.values() if r["kernel"] == entry["name"]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, runs=runs, fed_runs=fed_runs, merge=merged,
        kernel_times=times,
        fused_times_lazy_block=times_fused_lazy,
        residual_times_path_b=times_b, residual_times_lazy_block=times_lazy,
        fused_times_partition=bank_times,
        serial_paths=serial_by_path, quantile=q_extra, elapsed_s=elapsed,
        quantile_kernel_times=q_times,
        tenant=tenant_runs, tenant_kernel_times=tenant_kernel_times,
        family=family_runs, faults=fault_runs, mesh=mesh,
        profile=prof, attention=attention, model=model, train=train,
        dryrun=dryrun, analysis=analysis, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--dryrun-child"]:
        sys.exit(dryrun_child(sys.argv[2]))
    sys.exit(main())

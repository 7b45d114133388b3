"""Drive the PyTorch/CUDA port on one GPU, end to end, and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout (one nvcc
     per source, in parallel), and print what cudaFuncGetAttributes says of
     each launcher of the weight-switch tile routine at the decode shape
     (registers, static and dynamic shared memory, local bytes, cluster)
     and of the sLSTM kernel at xlstm-1.3b width in both weight dtypes
     (the same, with the CTAs of its cooperative grid, CTAs per head and
     units per CTA, and the dynamic shared memory held to the planner's);
  3. each kernel against its PyTorch version on the card, with CUDA-event
     timings (plain, kernel, kernel, plain; L2 flushed before each call):
     the weight-switch kernels over the sweeps of tests/test_kernels.py
     (and 16-row tiles) and the decode path's full-width shape, in
     float32 (tolerance 3e-5) and bfloat16 (2e-2), the fused kernel
     bitwise equal to the switched one, timed at the decode tick's shape
     (8 rows) and the prefill chunk's (512 rows); the one-approximator MLP
     over the
     reference's four shapes and the full-width ApproxFFN shape (same
     tolerances), with ``ops.mlp_apply`` held to ``ref.mlp_forward_ref``;
     the sLSTM recurrence over the reference's three shapes and three
     that meet the edges of its split (1e-5), and xlstm-1.3b's prefill
     and decode shapes (1e-4 with float32 weights, 2e-2 with bfloat16);
  4. full-width internlm2-1.8b (24 layers, bf16, random weights from a
     seed, MCMA dispatch) served through DecodeServer with backends
     "pallas" then "pallas_fused": equal greedy tokens, and each kernel
     launched 24 times per decode tick; then one decode step through all
     three backends from one cache, held to the "xla" oracle: in float32
     (the same weights upcast) within 1e-4 with equal greedy tokens, and
     in bf16 through an oracle given the kernels' rounding;
  5. the serving configuration of the reference's scheduler at full width
     (internlm2-1.8b, batch 8, max_len 256, route_scope "tick",
     prefill_chunk 64, kv_page_size 16, 128 pages; 8 requests of 15 to 200
     prompt tokens, 16 new tokens), each tick timed by phase: "pallas" and
     "pallas_fused" give equal tokens, every request done and every page
     back; each kernel launched 24 times per tick (decode and prefill) on
     its backend alone and one dispatch plan per tick; a dense cache gives
     the same tokens and tick log; a 40-page pool defers admission but
     serves all; then, at 12 of the 24 layers, the slice-1 configuration
     (layer scope, token-by-token prefill, dense cache) on the same
     stream for comparison, and at no-clip capacities in float32 chunked
     and token-by-token prefill giving equal tokens (in bf16 the equal
     share is printed);
  6. the same stream with the serve-time features of the reference's
     DecodeServer ([serve qos library autotune full width]), each on both
     kernel backends with equal tokens, 24 launches and one dispatch plan
     per tick: QoS tiers (0.05, 0.10, 0.20) round-robin, half the requests
     by error_bound, half by tier (equal per-tier ledgers, per-tier counts
     summing to the totals, every request at the base tier == the untiered
     server, tokens and tick log); a library of 6 approximators with 3
     resident (equal swaps, lib_routed_per_class reconciled with
     off_set_exact_rows, no new step object across swaps, identity
     residency == the library-less server); autotune over the default
     ladder (equal rung trajectories, one decode step object per rung
     visited); host syncs per tick counted in separate runs; then both
     switch kernels against their PyTorch versions, timed in bf16, on
     plans of the top rung and of a ladder_from_counts rung and on stacks
     gathered from the library;
  6a. [analysis full width]: the contract gate (repro_torch.analysis) on
     phase 6's uncut library model: TA001, the autotune servers of phase
     6 hold one decode step object per rung visited, and no nvcc runs
     after the build; for each backend the decode and prefill-chunk steps
     at tick scope (the serving configuration's), dense and paged
     (16-token pages), driven
     through the audit's grid (2 margin vectors x 2 residency sets x 2 row
     masks; 2 block tables x 2 masks paged) under the audit's sync
     recorder and torch.cuda.set_sync_debug_mode("warn"): the waits the
     card reports equal the syncs the op list records, and both equal
     what the port's baseline grandfathers (0 for an empty one), 24
     switch launches a step call on the kernel backends and 0 on "xla",
     int32 plan, stats and metric leaves on the device (TA002);
     activation moves of a 3-layer execute at the CPU test's shapes
     (equal to the CPU's count of the same call) and at d 2048 (fused at
     most (1, 1) a layer and below unfused); the lint stage over the
     checkout (0 new findings);
  6b. [serve mesh full width]: the same model at its widths cut to 12
     of its 24 layers (``MESH_LAYERS``) and the same stream served by a
     DecodeServer on a (2, 2) ("data", "model") mesh: 4 ranks, one
     process each, sharing the card over gloo (every collective of a
     CUDA tensor staged through pinned host memory), on both kernel
     backends: every rank launches its backend's kernel 12 times a tick;
     tokens, drain stats and tick logs bitwise equal on every rank;
     invocation in [0, 1]; ms per tick, collectives and host stagings
     per tick printed; then a float32 witness at full
     widths cut to 2 layers, no-clip capacities: the mesh server's tokens
     equal to the single-device server's and a chunk + decode step's
     logits within 1e-4; then launch/serve.py --data 2 --model 2 (the
     smoke config, its own 4 ranks);
  7. the internlm2 smoke config in float32 on the card against the same
     parameters served on the CPU by the eager oracle;
  8. full-width xlstm-1.3b (48 layers, bf16, random weights from a seed):
     a (8, 256) prefill launching the sLSTM kernel once per group (6) over
     all 256 steps; DecodeServer serving 8 requests, 6 launches per tick;
     then, in float32 (the same weights upcast), forward over 256 tokens
     read at position 128 against prefill(128) + decode(1) within 2e-3 with
     equal greedy tokens;
  9. the xlstm smoke config in float32 on the card against the same
     parameters on the CPU: prefill 32 tokens, 8 decode ticks, logits
     within 1e-4 and equal greedy tokens;
  10. [serve hybrid full width]: zamba2-2.7b (54 Mamba2 layers in 9
     groups of 6, each followed by the one shared attention+FFN block,
     d 2560, bf16, MCMA n 3, d_hidden 256, block_t 128, tick scope)
     served through DecodeServer (8 requests of 16 + 16 tokens; the
     requested prefill chunk falls back to token by token) on both kernel
     backends: equal greedy tokens, each kernel launched 9 times a tick
     (one per application of the shared block), ms per tick, tokens/s,
     invocation and peak memory; the first tick's switch inputs held to
     the plain twins at d 2560 (2e-2); the zamba2 smoke config on the
     card against the CPU (1e-4); in float32 (the weights upcast, no
     depth cut) every Mamba2 block and shared-block application, fed the
     full forward's own inputs, gives prefill(128) + 16 one-token steps
     within 2e-3 of its forward over 256 tokens; the whole stack's
     forward vs prefill + decode gap is printed beside the forward's own
     noise under a batch change (at a random init the 54 float32 layers
     amplify rounding to O(1): not gated);
  11. [serve stablelm full width]: stablelm-1.6b (LayerNorm with bias,
     qkv biases, 25 % rotary, 32 heads of 64, bf16, MCMA) on phase 5's
     stream and serving configuration on both backends: equal tokens, 24
     launches and one plan a tick, the dense cache's tokens and tick log
     equal to the paged cache's, then phase 4's oracle witness at tick
     scope (float32 within 1e-4 of the "xla" oracle; the bf16 gaps are
     printed, not gated);
  12. [archs full width]: olmo-1b, stablelm-3b and musicgen-large (which
     takes embeddings) at full width and internvl2-76b at full width cut
     to 4 of its 80 layers (the 80 do not fit one card), bf16, MCMA: a
     (2, 128) forward with one switch launch a layer and 4 decode steps at
     tick scope with one a layer a step, logits finite; at d 2560
     (stablelm-3b) and d 8192 (internvl2-76b) one decode step's switch
     inputs held to the plain twins and timed against the bound;
  13. training at full width ([train dense full width]): internlm2-1.8b
     (24 layers, bf16, remat, the ApproxFFN of 3 approximators of 256
     with the tick router, error bound 1.4 so that exact and approximator
     labels both occur at a random init) through the Trainer, batch 8 x 512 with
     grad_accum 2, 4 steps: ms per step (host clock ended by the step's
     loss read, median of steps 2 to 4), tokens/s, peak memory, each
     step's lm_loss, grad_norm, invocation, router_acc and
     tick_router_acc (all finite), and one more step under the profiler
     (kernel launches, device busy, idle share);
  14. [train dense float32 parity]: the same config in float32 cut to 2
     layers, batch 2 x 64, warmup 0, one train step on the card and one on
     the CPU from the same state: invocation strictly between 0 and 1,
     tick labels of at least two classes and equal on both, loss and
     metrics within 1e-4 relative, each gradient (before the optimizer)
     within 1e-4, the new parameters within 2 lr;
  15. [train xlstm full width]: xlstm-1.3b (48 layers, bf16, remat) through
     the Trainer, batch 4 x 256, 2 steps: slstm_scan launched
     steps x grad_accum x groups x (1 + remat) = 2 x 1 x 6 x 2 times (the
     forward, and the remat recompute of each sLSTM block in the
     backward); ms per step and the backward's share; then
     slstm_scan_trainable at the prefill shape (256, 8, 4, 512) and the
     train shape (256, 4, 4, 512) on the card (the kernel phase also
     holds slstm_scan at the train shape): its outputs within 1e-4 (f32)
     or 2e-2 (bf16) of slstm_scan_plain's; its gradients with f32
     weights within 3e-5 of autograd through slstm_scan_plain; with bf16
     weights within 2e-2 of the plain version's in norm (its autograd
     rounds the gradient of h to bf16 at every step), and elementwise of
     autograd through the backward's own recurrence in float64;
  16. [train resume]: the internlm2 smoke config on the card under
     torch.use_deterministic_algorithms: saved at step 3, a new Trainer
     resumes to step 6 and equals an uninterrupted run bitwise;
  16b. [train mesh full width]: internlm2-1.8b at its widths cut to 12
     of its 24 layers (``MESH_LAYERS``), bf16, remat, the
     ApproxFFN and tick router at error bound 1.4, 8 x 512, grad_accum 2,
     2 Trainer steps on a (2, 2) ("data", "model") mesh of 4 ranks
     sharing the card over gloo (128 MiB exchange-arena slots): every
     rank's history, metrics and leaves replicated over data bitwise
     equal, 0 switch launches; ms per step, tokens/s, collectives and
     staged bytes per step per rank, peak memory per rank; a float32
     witness at 2 layers (8 x 128, grad_accum 2): the mesh's
     loss_and_grads against one card's from the same draw, the loss
     within 1e-5 relative, the gradients within 1e-4 elementwise and in
     norm, equal tick labels; ef_int8_allreduce_tree on a ("pod",) mesh
     of the same ranks: the reference's quadratic with CUDA tensors
     (err_compressed < 1e-2, err_exact < 1e-3), one call over a rank's
     full-width gradient shards beside the float32 all-reduce of the same
     leaves (time, staged bytes); then launch/train.py --smoke --approx
     --steps 2 --mesh 2,2 as a subprocess;
  16c. [train moe]: moonshot-v1-16b-a3b at its widths cut to 2 layers,
     remat: a float32 loss_and_grads on the card against the CPU at 2 x
     32 (gradients within 1e-4, every MoE application's gate_idx and keep
     equal), then 2 bf16 Trainer steps at 8 x 512, grad_accum 2 (ms per
     step, tokens/s, peak memory); [train example twin]:
     examples/train_lm_mcma_torch.py at its smoke preset;
  17. [paper pipeline full width]: the paper's co-training at the
     reference's paper settings (the Fig. 6 sizes, 70,000 / 30,000 rows;
     the paper topologies; 3 approximators, 5 iterations, lr 3e-3; 600 of
     the paper's 1500 epochs, for the script's time), float32 on the
     card: blackscholes through the methods of
     benchmarks/bench_paper.run_app that fit the phase's 150 s (one-pass,
     MCMA complementary and competitive; iterative and MCCA only in the
     CPU tests) with the Fig. 8 cost normalisation,
     each method's seconds, train_mlp calls and epochs/s, every metric in
     range and MCMA-competitive's invocation at least one-pass's - 0.02;
     the dispatched test rows through the switched_mlp kernel
     (ops.switched_apply) under the three 6->8->1 approximators, within
     3e-5 of apply_mlp under each row's approximator and of
     switched_mlp_plain; bessel's competitive MCMA and the example twin's
     kernel step (layers 0 and 1 of each 2->4->4->1) within 3e-5 of
     ref.switched_mlp_ref and of the plain version, timed with its bound;
     train_mlp on the card within 1e-4 of the CPU from one init (1 and 10
     epochs, both losses, weighted, 4,096 rows) and one train_mcma
     iteration's labels and classes differing on at most 0.5 % of rows;
  18. [serve moe full width], after every earlier phase's tensors are
     released: moonshot-v1-16b-a3b uncut (48 layers, 64 experts top-6,
     bf16, 56 GB), MCMA dispatch on (the MoE takes the ApproxFFN's
     place), on phase 5's stream and serving configuration with a paged
     and a dense cache: every request served, 0 switch launches and 0
     dispatch plans, ms per decode and chunk tick, tokens/s, mean TTFT,
     peak memory; at capacity factor 1.25 the share of equal tokens
     between the layouts is printed (idle slots' and padded rows compete
     for expert slots and attend to layout-dependent garbage, in the
     reference as here); at capacity factor E / top_k paged == dense,
     tokens and tick log bitwise; one profiled decode tick of 8 slots
     (launches, device busy, idle share) and the share of its expert
     choices the capacity drops (``moe.route`` on each layer's input);
  19. [moe float32 witness]: moonshot's widths cut to 2 layers, float32,
     capacity factor E / top_k: forward(512) at 256..259 against
     prefill(256) + 4 decode steps within 2e-3; chunked prefill into a
     16-token-page cache == the dense cache bitwise, within 2e-3 of the
     forward;
  20. [sliding window full width]: mixtral-8x7b's widths cut to 8 of its
     32 layers (the 32 are 93 GB in bf16), bf16: a (1, 8192) prefill
     into the 4096-row ring, 16 decode steps past the window (finite,
     pos 8208); the slice-1 stream through DecodeServer, prompts token
     by token; then at 2 layers in float32, capacity factor E / top_k,
     forward(8192) at 4096..4103 against prefill(4096) + 8 decode steps
     (the ring wraps at the first) within 2e-3; no switch launch;
  20b. the MoE family on a mesh, ONE world of 4 ranks sharing the card
     over gloo and the exchange arena (the parent's tensors released
     first): [serve moe mesh full width], moonshot uncut drawn as each
     rank's shards (``model.init_model(mesh=)``) on a (1, 4) mesh, 16
     whole experts a rank, through a mesh DecodeServer on phase 5's
     stream: every rank's tokens, stats and tick log bitwise equal, 0
     switch launches and dispatch plans; ms per tick by phase, tokens/s,
     collectives and staged bytes a tick a rank, peak memory a rank, the
     global drop share of one decode tick of 8 slots beside phase 18's,
     the bf16 tokens equal to phase 18's paged run (printed, not gated);
     float32 witnesses: moonshot at full widths cut to 2 layers on a
     (2, 2) mesh (FSDP, EP and per-shard capacity engaged), a chunk and a
     decode step within 1e-4 of one card's grouped oracle
     (``moe.scan_chunk`` = a data shard's tokens) with gate_idx and keep
     equal, and at capacity factor E / top_k of one card's plain path;
     mixtral at 2 layers on (1, 4), 8 decode steps past the window from
     one card's prefill(4096) within 1e-4 of one card's; then [train moe
     mesh]: moonshot cut to 2 layers, bf16, remat, 8 x 512, grad_accum 2,
     2 Trainer steps on (2, 2) (every rank's history, metrics and
     replicated leaves bitwise equal, finite, 0 switch launches; ms per
     step, tokens/s, collectives and staged GiB a step a rank, peak
     memory a rank) and a float32 witness (4 x 64, 2 rows a data shard:
     the loss within 1e-5 relative and every gradient within 1e-4
     elementwise of one card's grouped oracle, routing equal);
  20c. the hybrid and xLSTM families on a mesh, ONE more world of 4
     ranks ([ssm mesh world], ``ssm_mesh_full_width``): [serve hybrid
     mesh full width], zamba2-2.7b uncut drawn as shards on a (2, 2)
     mesh, MCMA at tick scope on its shared block, 8 requests of 3 + 3
     tokens (token by token: 5 ticks) through a mesh DecodeServer on both
     backends: each backend's kernel 9 times a tick on every rank, tokens
     equal across the backends, every rank's runs bitwise equal; [serve
     xlstm mesh full width], xlstm-1.3b uncut on a (1, 4) mesh (one sLSTM
     head a rank), the same stream: ``slstm_scan`` 6 times a tick on
     every rank; for each, ms a tick, collectives and staged bytes a tick
     a rank, peak memory a rank and the bf16 tokens equal to one card's
     (printed); float32 witnesses at one group (zamba2 6 layers, xlstm
     8), 8 rows decoding 9 tokens from an empty cache: every block
     teacher-forced within 1e-4 of one card, the group end to end within
     1e-4 of the logits' scale with equal greedy tokens (the bf16 gaps
     printed); [train ssm mesh]: both cut to one group at their widths,
     bf16, remat, 8 x 256 on (2, 2), 2 Trainer steps (bitwise equal on
     every rank, finite; the sLSTM kernel 2 a step a rank under remat)
     and a float32 witness (the loss within 1e-5 relative, the gradients
     within 1e-3 of one card's in norm, beside one card's own noise under
     a 1e-7 relative move of its parameters). The kernel phase times
     ``slstm_scan`` at a mesh rank's shapes too;
  20d. [dryrun full width] (``dryrun_full_width``, in a subprocess
     started with the paper phase 17, which is host-bound on one core; it
     starts a fake process group of 256 ranks): olmo-1b decode_32k on
     the (16, 16) production mesh with the ApproxFFN, recorded by
     ``launch/dryrun.run_cell`` on fake CUDA tensors and on fake CPU
     tensors, the two records equal (cost, collectives, kernel ops,
     attention, memory); rank 0's step of that cell run for real on the
     card in the same fake world (its collectives send nothing), a warm
     call and 5 timed: ``switched_mlp`` launched as many times a step as
     the record holds kernel ops, the step's arguments as many bytes as
     the record's, its host-clock ms and ``max_memory_allocated``
     printed beside the record's bytes and its three roofline terms;
     the attention count (``hlo_cost``) equal to ``flash_attention``
     traced op by op on CUDA tensors at 2048 tokens, forward and
     backward, in blocks of 512 and of 256;
  20e. [narrow mesh full width] (``narrow_mesh_full_width``): tensor
     parallelism below one kv head or one expert a rank, ONE world of 16
     ranks sharing the card on a (1, 16) mesh: internlm2-1.8b at its
     widths cut to 2 layers, drawn as shards, over the head_dim-split KV
     cache, on the scheduler's prompts and configuration with 4 new
     tokens through both backends (2 launches a tick on every rank,
     equal tokens); float32 witnesses at 2 layers against one card
     (internlm2 a chunk then a decode step within 1e-4, every rank's
     logits bitwise equal; mixtral's ring past the window within 1e-4);
     mixtral-8x7b cut to 2 layers, TP-in-expert, on the SSM mesh world's
     short stream (0 switch launches) and one bf16 Trainer step at 4 x
     128 (finite, every rank's history and shared leaves bitwise equal);
     ms a tick and a step, collectives and staged bytes a tick a rank,
     peak memory a rank;
  20f. [long context mesh full width] (``long_mesh_full_width``): xLSTM
     heads below |model| and a batch below the data axes, ONE world of 16
     ranks sharing the card on a (2, 8) mesh, then one card on the same
     inputs: xlstm-1.3b uncut, float32, one slot through the mesh
     DecodeServer (tokens equal to one card's, ``slstm_scan`` on all 4
     heads of every rank once a group a tick); its float32 witness and a
     train step's gradients at one group (1e-4); zamba2-2.7b's one tick
     at long_500k's 524,288 positions over a context-parallel cache of
     seeded random k/v (bf16 at 3 of 9 groups on both switch kernels,
     printed; float32 at one group within 1e-4 of one card over the
     whole cache) and its float32 witness at one group; mixtral-8x7b at
     2 layers, float32, its ring split over the data ranks, 4 tokens from
     position 524,293 equal to one card's; every rank's tokens, logits
     and replicated states bitwise equal; then, in the same world,
     [sequence-split training] (``seq_train_rank``, item 16d: a training
     microbatch of 1 row below the 2 data ranks, every row on each and
     half its positions): internvl2-76b at its widths cut to 1 of 80
     layers, bf16, remat, MCMA on, one train step of 1 x 1024 without
     the AdamW update (finite; every rank's loss, metrics, norm and
     shared gradients bitwise equal; ms, collectives and staged bytes,
     peak memory a rank), its float32 witness at the vocab cut to 32064
     and 1 x 512 against one card's (loss 1e-5, gradients 1e-4 in
     norm), and xlstm-1.3b at one group, float32, 1 x 512 (the same
     tolerances; data rank 1's sLSTM launch from data rank 0's state);
  21. a check that every process the phases started has ended (no
     child of this process is left: ``spawn_world`` stops its fork
     server and resource tracker before it returns), then a JSON line
     describing every kernel (the switch kernels'
     launches_by_run with the runs of phases 6a, 6b, 10 to 12, 20e and
     20f (the mesh runs' launches summed over their ranks, ``per_rank``
     beside them) and, for switched_mlp, the two paper runs, phase 20c's
     runs and phase 20d's rank step; their
     ``at_widths`` the d 2560 and d 8192 timings of phase 12, their
     ``at_rank_shapes`` one row at d 2560 (a batch below the data axes);
     slstm_scan's ``at_rank_shapes`` a mesh rank's shapes (a sequence
     slice of a training row among them); the MoE
     phases, on one card and on a mesh, launch none of the four), then
     the result line.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # outside the tensor cores
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
SERVE = dict(batch=8, max_len=256, n_requests=8, prompt_len=16, max_new=16)
# the serving configuration of the reference's scheduler: tick-scope
# routing, chunked prefill, a paged KV cache sized for the whole worst case
SCHED = dict(batch=8, max_len=256, route_scope="tick", prefill_chunk=64,
             kv_page_size=16, kv_pages=128)
SCHED_PROMPTS = (15, 16, 17, 33, 64, 100, 130, 200)
SCHED_MAX_NEW = 16
SCHED_TIGHT_PAGES = 40      # below the stream's worst-case reservation, 48
SLICE1 = dict(route_scope="layer", prefill_chunk=0, kv_page_size=0)
# the token-by-token runs of [serve scheduler full width] (the slice-1
# configuration, gate 5's chunked == token by token) at 12 of internlm2's
# 24 layers: with [long context mesh full width] the script took 1210.4 s
# on an H100 host whose paper phase took 163.7 s
SCHED_TBT_LAYERS = 12
NO_CLIP = dict(exact_frac=1.0, invoke_frac=1.0)
MLP_FULL = (2048, 2048, 256, 2048)   # ApproxFFN rows, d_in, d_hidden, d_out
MLP_BLOCK = 256
# the sLSTM at xlstm-1.3b width: prefill (S = prompt) and decode (S = 1)
SLSTM_FULL = {"prefill": (256, 8, 4, 512), "decode": (1, 8, 4, 512)}
# a mesh rank's sLSTM: its H / |model| heads of its rows (timed, with the
# full-width shapes): decode on (1, 4) (one head a rank), decode on a
# model axis of 2, the [train ssm mesh] microbatch on (2, 2), and with
# the heads below |model| every head of the whole batch
SLSTM_RANK = {"rank decode h1": (1, 8, 1, 512),
              "rank decode h2": (1, 8, 2, 512),
              "rank train": (256, 4, 2, 512),
              # heads below |model| (every rank runs all 4) at batch 1
              # below the data axes, and the one-group train witness's
              # microbatch on (2, 8) ([long context mesh full width])
              "rank decode heads shared": (1, 1, 4, 512),
              "rank train heads shared": (64, 2, 4, 512),
              # a training microbatch of 1 row below the 2 data ranks of
              # [long context mesh full width]: half of its 512 positions
              "rank train sequence slice": (256, 1, 4, 512)}
SLSTM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # full width; sweeps 1e-5
# and at batches a larger slot table gives it (checked, not timed)
SLSTM_WIDE_BATCH = [(16, 64, 4, 512), (4, 256, 4, 512)]
XLSTM_PROMPT = (8, 256)              # prefill batch, prompt length
WITNESS = dict(batch=2, seq=256, at=128)
# the train phases: batch, sequence, microbatches, steps, warmup
TRAIN_DENSE = dict(batch=8, seq=512, grad_accum=2, steps=4, warmup=2)
TRAIN_PARITY = dict(n_layers=2, batch=2, seq=64, grad_accum=2, lr=3e-4)
TRAIN_XLSTM = dict(batch=4, seq=256, grad_accum=1, steps=2, warmup=2)
# the sLSTM's shape on the xLSTM train path: (seq, microbatch, H, hd)
SLSTM_TRAIN = (TRAIN_XLSTM["seq"],
               TRAIN_XLSTM["batch"] // TRAIN_XLSTM["grad_accum"], 4, 512)
# the dense train phases' relative-error bound: at a random init every
# error is above the config's 0.1, so every label would be exact; at 1.4
# exact and approximator labels both occur (as in the CPU train tests)
TRAIN_ERROR_BOUND = 1.4
TRAIN_RESUME = dict(batch=4, seq=32, save_at=3, steps=6)
SLSTM_GRAD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
# the paper pipeline at the reference's paper settings
# (benchmarks/bench_paper.py:24, Fig. 6 sizes, float32) but 600 of their
# 1500 epochs: with [narrow mesh full width] the script took 1017.5 s on
# an H100 host where this phase took 272.3 s (1000 epochs then), 1210.4
# s with [long context mesh full width] (800 then), and 976.0 s with
# [sequence-split training] (600 since: this phase took 124.6 s at 800);
# block_t as in examples/approx_bessel.py
PAPER = dict(epochs=600, n_approx=3, iters=5, lr=3e-3, switch_rate=0.5,
             block_t=128, seed=0)
# card against CPU: 10 epochs keep two implementations' RMSprop
# trajectories at ulp distance (past about 100 epochs elements with a
# near-zero gradient take different signs and the runs drift apart)
# [serve hybrid full width]: zamba2-2.7b; the float32 witness forwards
# (batch, seq) and decodes ``decode`` tokens one by one from a prefill of
# ``at``
HYBRID = "zamba2-2.7b"
HYBRID_WITNESS = dict(batch=2, seq=256, at=128, decode=16)
STABLELM = "stablelm-1.6b"
# [archs full width]: (arch, layers kept or None for all); a (batch, seq)
# forward, then ``decode`` steps at tick scope
ARCHS_FULL = (("olmo-1b", None), ("stablelm-3b", None),
              ("musicgen-large", None), ("internvl2-76b", 4))
ARCHS_RUN = dict(batch=2, seq=128, decode=4)
ARCHS_TIMED = ("stablelm-3b", "internvl2-76b")   # d 2560 and d 8192
PAPER_PARITY = dict(rows=4096, epochs=(1, 10), mcma_epochs=10, tol=1e-4,
                    max_label_diff=0.005)
# the MoE family: moonshot-v1-16b-a3b uncut on the scheduler's stream, its
# float32 witness at its widths cut to 2 layers ((batch, S) prefill, then
# ``decode`` steps); mixtral-8x7b at full width cut in depth (the 32 layers
# are 93 GB in bf16): a (1, prefill) forward into the 4096-row ring, then
# ``decode`` steps past the window; its float32 witness at 2 layers
MOE = "moonshot-v1-16b-a3b"
MOE_WITNESS = dict(n_layers=2, batch=2, seq=256, decode=4, page_size=16)
SWA = "mixtral-8x7b"
SWA_LAYERS = 8
SWA_RUN = dict(prefill=8192, decode=16)
SWA_WITNESS = dict(n_layers=2, seq=8192, at=4096, decode=8)
# [serve mesh full width]: a (data, model) mesh of ranks sharing the one
# card over gloo; the float32 witness at full widths cut to 2 layers, its
# logits from a (batch, seq) chunk then one decode step
MESH_SHAPE = (2, 2)
# internlm2 in the two mesh phases ([serve mesh full width], [train mesh
# full width]) at its widths cut to 12 of its 24 layers: with the SSM mesh
# world added the script took 1223.0 s on a slow host (PR 24), past the
# 1200 s it must end within; then to 6 beside [narrow mesh full width],
# 100 to 110 s more; then to 4 beside [long context mesh full width]
MESH_LAYERS = 4
MESH_WITNESS = dict(n_layers=2, batch=8, seq=64, tol=1e-4)
MESH_LAUNCHER = ("--smoke", "--approx", "--mcma-dispatch", "--data", "2",
                 "--model", "2", "--batch", "4", "--requests", "6",
                 "--max-new", "6", "--route-scope", "tick",
                 "--prefill-chunk", "16", "--kv-page-size", "16")

# [train mesh full width]: TRAIN_DENSE's shape on a (data, model) mesh of
# ranks sharing the card over gloo (an exchange arena of 128 MiB a rank);
# the float32 witness at full widths cut to 2 layers; the int8
# error-feedback all-reduce on a ("pod",) mesh of the same ranks
TRAIN_MESH = dict(shape=(2, 2), batch=8, seq=512, grad_accum=2, steps=2,
                  warmup=2, exchange_mib=128)
TRAIN_MESH_WITNESS = dict(n_layers=2, batch=8, seq=128, grad_accum=2,
                          loss_tol=1e-5, grad_tol=1e-4)
EF_QUADRATIC = dict(steps=300, lr=0.05, dim=8)
TRAIN_MESH_LAUNCHER = ("--smoke", "--approx", "--steps", "2", "--mesh",
                       "2,2")
# [train moe]: moonshot at its widths cut to 2 layers; a float32 step on
# the card against the CPU at a small batch, then a timed bf16 step
TRAIN_MOE = dict(n_layers=2, parity=dict(batch=2, seq=32),
                 timed=dict(batch=8, seq=512, grad_accum=2, steps=2,
                            warmup=2))
# the MoE family on a mesh: ONE world of 4 ranks sharing the card.
# moonshot uncut served on a (1, 4) mesh (16 whole experts a rank, no
# expert weights staged); the float32 witnesses on (2, 2), where FSDP, EP
# and per-shard capacity all engage (moonshot: a (batch, seq - 1) chunk
# and one decode step), and mixtral's ring on (1, 4) (its 2 layers of
# experts gathered over (2, 2)'s data axis would stage 1.4 GB a layer a
# step a rank); [train moe mesh] at [train moe]'s cut and shape on (2, 2)
# with a float32 witness of 2 rows a data shard
MOE_MESH = dict(serve=(1, 4), witness=(2, 2), ring=(1, 4), exchange_mib=128)
MOE_MESH_WITNESS = dict(n_layers=2, batch=8, seq=64, tol=1e-4)
SWA_MESH_WITNESS = dict(n_layers=2, seq=8192, at=4096, decode=8, tol=1e-4)
TRAIN_MOE_MESH = dict(shape=(2, 2), n_layers=2, batch=8, seq=512,
                      grad_accum=2, steps=2, warmup=2,
                      witness=dict(batch=4, seq=64, loss_tol=1e-5,
                                   grad_tol=1e-4))
# the hybrid and xLSTM families on a mesh: ONE world of 4 ranks sharing
# the card.  zamba2 uncut on (2, 2) through both weight-switch kernels,
# xlstm uncut on (1, 4) (one sLSTM head a rank), on a short stream (these
# families prefill token by token: a tick a prompt token; 8 + 8 tokens,
# 15 ticks, then 6 + 6, took the script past 750 s and 1200 s on slow
# hosts; 4 + 4 until [long context mesh full width] came); float32
# witnesses at one group of each (the uncut float32 zamba2 amplifies
# rounding to O(1), ROADMAP queue 3 k), ``steps`` tokens decoded one by
# one from an empty cache against one card; [train ssm mesh] both
# families at their widths cut to one group on (2, 2) (the sLSTM's
# per-rank microbatch (256, 4, 2, 512)), with a float32 witness whose
# gradients are held in norm at 1e-3 (a reduction missing or counted
# twice moves them by O(1); the mesh's other summation order through the
# uncut one-group zamba2 moved them by 1.86e-4, so the gate of 1e-4 first
# written fell below the rounding noise, which the witness measures)
SSM_MESH = dict(hybrid=(2, 2), xlstm=(1, 4), exchange_mib=128)
SSM_STREAM = dict(batch=8, max_len=64, n_requests=8, prompt_len=3,
                  max_new=3)
SSM_WITNESS = dict(batch=8, steps=9, tol=1e-4)
TRAIN_SSM_MESH = dict(shape=(2, 2), batch=8, seq=256, grad_accum=1, steps=2,
                      warmup=2,
                      witness=dict(batch=4, seq=64, loss_tol=1e-5,
                                   norm_tol=1e-3, grad_tol=1e-4))

# [narrow mesh full width]: ONE world of 16 ranks sharing the card on a
# (1, 16) mesh, the smallest model axis where internlm2's and mixtral's 8
# kv heads and mixtral's 8 experts fall below |model| (each rank holds
# head_dim / 16 of every kv head, half a kv head of wk / wv, and d_ff /
# 16 of every expert: the head_dim-split cache and TP-in-expert).
# internlm2 at its widths cut to 2 of 24 layers (4 before [long context
# mesh full width]) on the
# scheduler's prompts and configuration with 4 new tokens a request (a
# tick costs about 1.5 s there at 4: 16 processes meet at every
# collective); mixtral cut
# to 2 of 32 on the SSM mesh world's short stream (token by token: its
# ring buffer) and one
# Trainer step of 4 x 128 (at 8 x 256 the step took 28 s); float32
# witnesses at 2 layers against one card (internlm2 a chunk then a
# decode step, mixtral's ring past the window)
NARROW = dict(shape=(1, 16), exchange_mib=32, dense_layers=2, swa_layers=2,
              max_new=4)
NARROW_WITNESS = dict(n_layers=2, batch=8, seq=64, tol=1e-4)
TRAIN_NARROW = dict(batch=4, seq=128, grad_accum=1, steps=1, warmup=1)

# [long context mesh full width]: ONE world of 16 ranks sharing the card
# on a (2, 8) mesh, whose model axis of 8 is wider than xlstm-1.3b's 4
# heads (2 ranks a head) and whose data axis of 2 is wider than a batch of
# 1 (every data rank holds the row; a KV cache is split over them by
# sequence).  xlstm-1.3b uncut through the mesh DecodeServer, a prompt of
# `xlstm_prompt` then `xlstm_new` tokens, in float32 (bf16's reassociated
# sums over 8 model ranks may flip a near-tied greedy token; the gate is
# tokens equal to one card's); its float32 witness at one group (`steps`
# tokens decoded at batch 1) and one train step's float32 gradients at
# one group (TRAIN_SSM_MESH's witness batch).  zamba2-2.7b decoding one
# tick at long_500k's `ctx` positions against a cache of seeded random
# k/v (`fill` positions a draw): bf16 on both switch kernels at
# `zamba2_groups` of its 9 groups (the 16 GB whole cache a card holds
# after the world; the whole 54 layers' 48 GB would leave 16 ranks about
# 16 GB of the card), float32 at one group held to one card over the
# whole cache, and a float32 witness at one group from an empty cache.
# mixtral-8x7b at `swa_layers` of 32 layers, float32, its ring of 4096
# rows split over the 2 data ranks, `swa_steps` tokens decoded greedily
# from position `swa_pos`, past 524,288.
LONG = dict(shape=(2, 8), exchange_mib=32, xlstm_prompt=3, xlstm_new=2,
            max_len=64, ctx=524288, fill=8192, zamba2_groups=3,
            swa_layers=2, swa_pos=524293, swa_steps=4, steps=5, tol=1e-4)

# [sequence-split training], inside the world of [long context mesh full
# width]: a training microbatch below its 2 data ranks, every row on
# each and half the positions (``activations.sequence_split``).
# internvl2-76b at its widths (d 8192, 64 heads, 8 kv heads, d_ff 28672,
# vocab 128256; seeded stub embeddings in, as its input_mode takes) cut
# to `layers` of its 80, bf16, remat, MCMA on: one train step's forward,
# backward, gradient reduction over the data axes and global-norm clip
# on 1 row of `seq` positions.  Cut for the 16 ranks that share the card
# (10.7 GB of contexts; my chip runs, PR 29): no AdamW update (the two
# vocab tables split over "model" only leave each rank 333 M parameters,
# whose float32 moments, 2.66 GB a rank, ran the card out of memory
# beside the step), and 1024 positions, not train_4k's 4096.  Then
# float32 at one layer with the vocab cut to `witness_vocab` (the float32
# tables and their gradients, 2.1 GB a rank, and the layer's FSDP gathers
# would not fit 16 ranks), 1 row of `witness_seq` positions: the mesh's
# loss_and_grads against one card's (computed before the world, its
# gradients handed to the ranks in host shared memory).  xlstm-1.3b at
# one group, float32, 1 row of 512 positions: the sLSTM kernel of data
# rank 1 runs from the state data rank 0 hands over.
SEQ_TRAIN = dict(arch="internvl2-76b", layers=1, seq=1024, witness_seq=512,
                 witness_vocab=32064, loss_tol=1e-5, norm_tol=1e-4,
                 xlstm=dict(batch=1, seq=512, loss_tol=1e-5, norm_tol=1e-4,
                            grad_tol=1e-4))

# [analysis full width]: the residency sets of the library's 3 resident
# slots, the route scope whose steps are audited (the serving
# configuration's; the CPU audit holds layer scope too), the page size,
# and the 3-layer execute of the activation-move count at the CPU test's
# shapes (tests/test_torch_analysis.py) and at full width
ANALYSIS_RESIDENCY = ([4, 1, 0], [2, 5, 3])
ANALYSIS_SCOPES = ("tick",)
ANALYSIS_PAGE = 16
MOVES_CASES = {"test shapes": dict(t=128, n=3, d=32, d_h=16, block_t=32,
                                   exact_cap=64, invoke_cap=48,
                                   dtype="float32"),
               "d 2048": dict(t=512, n=3, d=2048, d_h=256, block_t=128,
                              exact_cap=256, invoke_cap=192,
                              dtype="bfloat16")}
MOVES_LAYERS = 3
# [dryrun full width]: the cell recorded on the fake production mesh (in
# a subprocess: it starts a fake world of 256 ranks), rank 0's step of it
# run for real on the card (the median of TIMED calls after a warm one),
# and the attention count held to the traced loop at ATTN_TOKENS tokens
# (a rank's heads of olmo-1b: the config's blocks of 512, recorded as
# they are, and blocks of 256, the count's polynomial)
DRYRUN = dict(arch="olmo-1b", shape="decode_32k", mesh="single", timed=5)
DRYRUN_ATTN = dict(tokens=2048, batch=2, heads=16, blocks=(512, 256))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def log(msg):
    print(msg, flush=True)


def kernel_resources(torch):
    """Registers, shared memory, local bytes and cluster width of the three
    launchers of csrc/switch_tile.cuh, in both dtypes, at the decode
    path's shape (d_h_p 256, d_out_p 2048, block_t 128); then the sLSTM
    kernel's at xlstm-1.3b width (batch 8) with its cooperative grid."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.models.xlstm import slstm_dims
    cfg = get_config("internlm2-1.8b")
    for name, src in (("switched_mlp", "switched_mlp"),
                      ("switched_mlp_fused", "fused_dispatch"),
                      ("mlp_forward", "mcma_mlp")):
        for dtype in ("float32", "bfloat16"):
            r = build.resources(src, f"{name}_resources", (
                int(dtype == "bfloat16"), cfg.approx.d_hidden, cfg.d_model,
                cfg.approx.block_t))
            log(f"  {name} {dtype}: {r['registers']} registers/thread, "
                f"{r['static_smem']} B static + {r['dynamic_smem']} B "
                f"dynamic shared memory, {r['local_bytes']} B local, "
                f"cluster of {r['cluster']}")
    _, h, hd = slstm_dims(get_config("xlstm-1.3b"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in ("float32", "bfloat16"):
        r = K.resources(SLSTM_FULL["prefill"][1], h, hd,
                        getattr(torch, dtype))
        log(f"  slstm_scan wh {dtype}: {r['registers']} registers/thread, "
            f"{r['static_smem']} B static + {r['dynamic_smem']} B dynamic "
            f"shared memory, {r['local_bytes']} B local; cooperative grid "
            f"of {r['grid']} CTAs ({r['ctas_per_head']} per head, "
            f"{r['units']} units each, {r['chunks']} chunk(s) of batch rows "
            f"a step), {r['ctas_per_sm']} CTA/SM x {n_sm} SMs")
        if r["dynamic_smem"] != r["plan_smem"] or \
                r["ctas_per_sm"] * n_sm < r["grid"]:
            raise AssertionError(f"slstm_scan {dtype}: the planner's "
                                 f"layout or grid disagrees with the kernel "
                                 f"({r})")


def check_kernels(torch, x, cls, w, block, dtype, name):
    """Each kernel vs its PyTorch version; returns ({kernel: max |kernel -
    plain|}, the kernels' operands)."""
    from repro_torch.kernels import fused_dispatch, ops, ref, switched_mlp
    xp, rows, tile_cls, weights, order, pos = ops.kernel_operands(
        x, cls, *w, block_t=block)
    y = switched_mlp.switched_mlp(xp, tile_cls, *weights, block_t=block)
    yf = fused_dispatch.switched_mlp_fused(x, rows, tile_cls, *weights,
                                           block_t=block)
    plain = switched_mlp.switched_mlp_plain(xp, tile_cls, *weights,
                                            block_t=block)
    plain_f = fused_dispatch.switched_mlp_fused_plain(
        x, rows, tile_cls, *weights, block_t=block)
    torch.cuda.synchronize()
    t = x.shape[0]
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), plain.float(), rtol=tol, atol=tol,
                               msg=f"switched_mlp {name} {dtype}")
    torch.testing.assert_close(yf[:t].float(), plain_f[:t].float(), rtol=tol,
                               atol=tol, msg=f"fused {name} {dtype}")
    unsorted = y[pos.long()][torch.argsort(order.long())]
    if not torch.equal(yf[:t], unsorted):
        raise AssertionError(f"fused != switched bitwise ({name} {dtype})")
    d_out = w[2].shape[2]
    whole = ops.switched_apply(x, cls, *w, block_t=block)
    want = ref.switched_mlp_ref(x, cls, *w)
    torch.testing.assert_close(whole.float(), want.float(), rtol=tol,
                               atol=tol, msg=f"switched_apply {name} {dtype}")
    assert whole.shape == (t, d_out)
    err = {"switched_mlp": (y.float() - plain.float()).abs().max().item(),
           "switched_mlp_fused":
               (yf[:t].float() - plain_f[:t].float()).abs().max().item()}
    return err, (xp, rows, tile_cls, weights)


def sweep_inputs(torch, case, dtype):
    from repro_torch.kernels.sweeps import case_inputs
    x, cls, w, block = case_inputs(case)
    to = dict(device="cuda", dtype=getattr(torch, dtype))
    return (torch.from_numpy(x).to(**to), torch.from_numpy(cls).cuda(),
            [torch.from_numpy(a).to(**to) for a in w], block)


def time_ms(torch, fn, flush, iters=30):
    """Median ms of one call, each run after flushing the L2 cache (the
    decode path meets every layer's weights cold), timed with CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(dtype, n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main_path_kernel_phase(np, torch, flush):
    """Both kernels at the serving path's full-width shapes, d=2048,
    d_hidden=256, block_t=128, 3 approximators + the zero pseudo-class,
    bf16 and float32: one layer's dispatch of a decode tick (8 rows,
    t_pad 640) and of a prefill-chunk tick (8 slots x 64 tokens = 512
    rows, t_pad 1024).  Returns {(kernel, dtype[, "prefill"]): numbers}."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("internlm2-1.8b")
    a = cfg.approx
    n, d, dh = a.n_approx + 1, cfg.d_model, a.d_hidden
    out = {}
    for shape, t, seed in (("decode", SERVE["batch"], 7),
                           ("prefill", SCHED["batch"] * SCHED["prefill_chunk"],
                            8)):
        rng = np.random.default_rng(seed)
        for dtype in ("float32", "bfloat16"):
            x, w = switch_inputs(np, torch, rng, t, n, d, dh, dtype)
            cls = torch.from_numpy(rng.integers(0, n, t).astype(np.int32)
                                   ).cuda()
            for name, nums in time_switch_case(
                    np, torch, flush, x, cls, w, a.block_t, dtype,
                    f"main path {shape}").items():
                key = (name, dtype) if shape == "decode" \
                    else (name, dtype, shape)
                out[key] = nums
    # a batch below the data axes: zamba2's shared block dispatches its
    # one row as one device ([long context mesh full width])
    z = get_config(HYBRID)
    rng = np.random.default_rng(9)
    for dtype in ("float32", "bfloat16"):
        x, w = switch_inputs(np, torch, rng, 1, z.approx.n_approx + 1,
                             z.d_model, z.approx.d_hidden, dtype)
        cls = torch.zeros(1, dtype=torch.int32, device="cuda") + 1
        for name, nums in time_switch_case(
                np, torch, flush, x, cls, w, z.approx.block_t, dtype,
                f"one row d {z.d_model}").items():
            out[name, dtype, "one row"] = dict(rows=1, d_model=z.d_model,
                                               **nums)
    return out


def switch_inputs(np, torch, rng, t, n, d, dh, dtype):
    """Random rows and weight stacks of ``n`` classes in ``dtype`` on the
    card, the last class the zero pseudo-class."""
    to = dict(device="cuda", dtype=getattr(torch, dtype))
    x = torch.from_numpy(rng.normal(size=(t, d))).to(**to)
    w = [torch.from_numpy(rng.normal(size=s) * sc).to(**to)
         for s, sc in (((n, d, dh), d ** -0.5), ((n, dh), 0.1),
                       ((n, dh, d), dh ** -0.5), ((n, d), 0.1))]
    for arr in w:
        arr[-1] = 0                     # the zero pseudo-class
    return x, w


def switch_bound(torch, dtype, x, cls, w):
    """The least time for the weight switch's function on one dispatch:
    rows ``x`` under classes ``cls`` through stacks ``w`` (w1, b1, w2,
    b2), at the widths these tensors have.  Bytes: each row read and its
    output written once, the class vector, and the weights of the classes
    ``cls`` uses; FLOP: 2 * rows * (d_in * d_h + d_h * d_out).  Given the
    logical dispatch this is the bound; given a kernel's padded operands
    (per-row classes) it is what that layout moves.  The count is the
    package's (``kernels/work.switch_work``), the one the dry run's
    kernel ops read.  Returns (ms, "bytes" or "operations", bytes,
    FLOP)."""
    from repro_torch.kernels.work import switch_work
    t, d_in = x.shape
    d_h, d_out = w[2].shape[1:]
    n_bytes, flops = switch_work(
        t, d_in, d_h, d_out, n_classes=len(torch.unique(cls)),
        itemsize=x.element_size(), w_itemsize=w[0].element_size(),
        index_bytes=cls.numel() * cls.element_size())
    return (*bound(dtype, n_bytes, flops), n_bytes, flops)


def time_switch_case(np, torch, flush, x, cls, w, blk, dtype, label,
                     timed=True):
    """Both switch kernels on one dispatch (rows ``x`` under classes
    ``cls``, stacks ``w`` with the pseudo-class last) against their plain
    twins, then timed (plain, kernel, kernel, plain) with the bound of
    the dispatch (``switch_bound``: both kernels compute one function).
    Returns {kernel: numbers}; with ``timed`` False only the check and
    its error."""
    from repro_torch.kernels import fused_dispatch, switched_mlp
    t = x.shape[0]
    err, (xp, rows, tile_cls, weights) = check_kernels(
        torch, x, cls, w, blk, dtype, label)
    classes = torch.unique(tile_cls).tolist()
    live = int((tile_cls != len(w[0]) - 1).sum())
    if not timed:
        log(f"  {label} {dtype} ({t} rows, t_pad={xp.shape[0]}, {live} of "
            f"{tile_cls.numel()} tiles under a real class): max "
            f"|kernel-plain| switched {err['switched_mlp']:.3g}, fused "
            f"{err['switched_mlp_fused']:.3g}")
        return {k: dict(max_abs_err=v) for k, v in err.items()}
    b_ms, b_by, n_bytes, flops = switch_bound(torch, dtype, x, cls, w)
    run = {
        "switched_mlp": (
            lambda: switched_mlp.switched_mlp(xp, tile_cls, *weights,
                                              block_t=blk),
            lambda: switched_mlp.switched_mlp_plain(xp, tile_cls, *weights,
                                                    block_t=blk)),
        "switched_mlp_fused": (
            lambda: fused_dispatch.switched_mlp_fused(
                x, rows, tile_cls, *weights, block_t=blk),
            lambda: fused_dispatch.switched_mlp_fused_plain(
                x, rows, tile_cls, *weights, block_t=blk)),
    }
    out = {}
    for name, (kern, plain) in run.items():
        ms, plain_ms, (p1, k1, k2, p2) = timed_pair(torch, kern, plain,
                                                    flush)
        out[name] = dict(max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"  {name} {dtype} {label} ({t} rows, t_pad={xp.shape[0]}, "
            f"{len(classes)} classes, {live} of {tile_cls.numel()} tiles "
            f"under a real class): kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {n_bytes} "
            f"B, {flops} FLOP), max |kernel-plain| {err[name]:.3g}")
    return out


def timed_pair(torch, kern, plain, flush, iters=30):
    """plain, kernel, kernel, plain (two versions are compared only within
    one call); returns (kernel ms, plain ms, the four medians)."""
    p1 = time_ms(torch, plain, flush, iters)
    k1 = time_ms(torch, kern, flush, iters)
    k2 = time_ms(torch, kern, flush, iters)
    p2 = time_ms(torch, plain, flush, iters)
    return min(k1, k2), min(p1, p2), (p1, k1, k2, p2)


def max_err(torch, got, want):
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def mlp_kernel_phase(np, torch, flush):
    """mlp_forward against its PyTorch version over the reference's
    shapes and the full-width ApproxFFN shape (timed there); then the
    user entry point ops.mlp_apply against ref.mlp_forward_ref, the run
    whose launches the kernels line reports."""
    from repro_torch.kernels import mcma_mlp, ops, ref
    from repro_torch.kernels.sweeps import MLP_SHAPES, mlp_inputs
    from repro_torch.kernels.work import wrapper_work
    rng = np.random.default_rng(11)
    t, d_in, d_h, d_out = MLP_FULL
    full = [rng.normal(size=(t, d_in)), rng.normal(size=(d_in, d_h))
            * d_in ** -0.5, rng.normal(size=d_h) * 0.1,
            rng.normal(size=(d_h, d_out)) * d_h ** -0.5,
            rng.normal(size=d_out) * 0.1]
    cases = [(shape, mlp_inputs(*shape), 128) for shape in MLP_SHAPES]
    cases.append((MLP_FULL, full, MLP_BLOCK))
    out, entry = {}, []
    for dtype in ("float32", "bfloat16"):
        to = dict(device="cuda", dtype=getattr(torch, dtype))
        for shape, arrays, blk in cases:
            a = [torch.from_numpy(np.asarray(v)).to(**to) for v in arrays]
            operands = ops.mlp_operands(*a, block_t=blk)
            kern = lambda: mcma_mlp.mlp_forward(*operands, block_t=blk)
            plain = lambda: mcma_mlp.mlp_forward_plain(*operands,
                                                       block_t=blk)
            y, want = kern(), plain()
            torch.cuda.synchronize()
            tol = TOL[dtype]
            torch.testing.assert_close(y.float(), want.float(), rtol=tol,
                                       atol=tol,
                                       msg=f"mlp_forward {shape} {dtype}")
            err = max_err(torch, [y], [want])
            entry.append((shape, a, blk, dtype))
            if shape != MLP_FULL:
                log(f"  mlp_forward {shape} {dtype}: max |kernel-plain| "
                    f"{err:.3g}")
                continue
            ms, plain_ms, four = timed_pair(torch, kern, plain, flush)
            n_bytes, flops = wrapper_work("mlp_forward", operands, {})
            b_ms, b_by = bound(dtype, n_bytes, flops)
            out[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by)
            log(f"  mlp_forward {shape} {dtype} block_t {blk}: kernel "
                f"{four[1]:.4f}/{four[2]:.4f} ms, plain {four[0]:.4f}/"
                f"{four[3]:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {n_bytes} "
                f"B, {flops} FLOP), max |kernel-plain| {err:.3g}")
    # the entry point on the reference's shapes, as tests/test_kernels.py
    # holds it (the reference's ref does not round h: bf16 tolerance)
    torch.cuda.synchronize()
    entry = [e for e in entry if e[0] != MLP_FULL]
    mcma_mlp.mlp_forward.launches = 0
    for shape, a, blk, dtype in entry:
        y = ops.mlp_apply(*a, block_t=blk)
        want = ref.mlp_forward_ref(*a)
        tol = TOL[dtype]
        torch.testing.assert_close(y.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"mlp_apply {shape} {dtype}")
        if y.shape != (shape[0], shape[3]):
            raise AssertionError(f"mlp_apply {shape}: shape {y.shape}")
    torch.cuda.synchronize()
    out["launches"] = mcma_mlp.mlp_forward.launches
    if out["launches"] != len(entry):
        raise AssertionError(f"mlp_apply launched mlp_forward "
                             f"{out['launches']} times, want {len(entry)}")
    log(f"  ops.mlp_apply vs ref.mlp_forward_ref on {out['launches']} "
        f"shape x dtype cases: within tolerance, {out['launches']} launches")
    return out


def slstm_kernel_phase(np, torch, flush):
    """slstm_scan against its PyTorch version over the sweeps (1e-5),
    xlstm-1.3b's prefill and decode shapes and a mesh rank's shapes
    (timed), its width at larger batches and its train shape, with
    float32 and bfloat16 recurrent weights."""
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.kernels.sweeps import SLSTM_SHAPES, slstm_inputs
    from repro_torch.kernels.work import slstm_work
    out = {}
    cases = [(s, slstm_inputs(*s), None) for s in SLSTM_SHAPES]
    cases += [(s, slstm_inputs(*s, wh_scale=s[3] ** -0.5), name)
              for name, s in {**SLSTM_FULL, **SLSTM_RANK}.items()]
    cases += [(s, slstm_inputs(*s, wh_scale=s[3] ** -0.5), "wide")
              for s in SLSTM_WIDE_BATCH]
    cases += [(SLSTM_TRAIN, slstm_inputs(*SLSTM_TRAIN,
                                         wh_scale=SLSTM_TRAIN[3] ** -0.5),
               "train")]
    for wdtype in ("float32", "bfloat16"):
        for shape, arrays, name in cases:
            xg, wh, *st = [torch.from_numpy(v).cuda() for v in arrays]
            wh = wh.to(getattr(torch, wdtype))
            kern = lambda: K.slstm_scan(xg, wh, *st)
            plain = lambda: K.slstm_scan_plain(xg, wh, *st)
            (ys, fin), (pys, pfin) = kern(), plain()
            torch.cuda.synchronize()
            tol = SLSTM_TOL[wdtype] if name else 1e-5
            for g, w, what in zip((ys, *fin), (pys, *pfin),
                                  ("ys", "h", "c", "n", "m")):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"slstm_scan {shape}: {what} not "
                                         "finite")
                torch.testing.assert_close(
                    g, w, rtol=tol, atol=tol,
                    msg=f"slstm_scan {shape} {wdtype} {what}")
            err = max_err(torch, (ys, *fin), (pys, *pfin))
            if name in (None, "wide", "train"):
                log(f"  slstm_scan {name + ' ' if name else ''}{shape} wh "
                    f"{wdtype}: max |kernel-plain| {err:.3g}")
                continue
            ms, plain_ms, four = timed_pair(torch, kern, plain, flush,
                                            iters=10)
            n_bytes, flops = slstm_work(*shape,
                                        wh_itemsize=wh.element_size())
            b_ms, b_by = bound(wdtype, n_bytes, flops)
            out[name, wdtype] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by)
            log(f"  slstm_scan {name} {shape} wh {wdtype}: kernel "
                f"{four[1]:.4f}/{four[2]:.4f} ms, plain {four[0]:.4f}/"
                f"{four[3]:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {n_bytes} "
                f"B, {flops} FLOP), max |kernel-plain| {err:.3g}")
    return out


class StepRecorder:
    """Wraps the model's sLSTM entry to record each call's step count S
    (the wrapper's own launch counter still counts every launch)."""

    def __init__(self):
        from repro_torch.models import xlstm
        self.mod, self.real, self.steps = xlstm, xlstm.slstm_scan, []

    def __enter__(self):
        def rec(xg, *a):
            self.steps.append(xg.shape[0])
            return self.real(xg, *a)
        self.mod.slstm_scan = rec
        return self

    def __exit__(self, *exc):
        self.mod.slstm_scan = self.real


def serve_xlstm(np, torch):
    """Full-width xlstm-1.3b: prefill, DecodeServer, and the float32
    forward vs prefill + decode witness.  Returns the launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))  # MCMA dispatch on: no ApproxFFN, rate 0
    groups = M.topology(cfg).n_groups
    t0 = time.time()
    params = M.init_model(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  init {cfg.name}: {cfg.n_layers} layers ({groups} groups of "
        f"{cfg.ssm.slstm_every - 1} mLSTM + 1 sLSTM), d={cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab={cfg.vocab}, {cfg.param_dtype}, "
        f"{n_params} parameters in {time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    b, s = XLSTM_PROMPT
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                              .astype(np.int32)).cuda()
    prefill = steps.make_prefill_step(cfg)
    prefill(params, {"inputs": prompt})                      # warm-up
    torch.cuda.synchronize()
    K.slstm_scan.launches = 0
    with StepRecorder() as rec:
        t0 = time.time()
        last, cache = prefill(params, {"inputs": prompt})
        torch.cuda.synchronize()
        wall = time.time() - t0
    counts = {"prefill": K.slstm_scan.launches}
    if counts["prefill"] != groups or rec.steps != [s] * groups:
        raise AssertionError(f"prefill: {counts['prefill']} launches over "
                             f"{rec.steps} steps, want {groups} x {s}")
    if last.shape != (b, cfg.vocab) or not torch.isfinite(last.float()).all() \
            or cache["pos"].tolist() != [s] * b:
        raise AssertionError("prefill: logits or cache malformed")
    times = []
    for _ in range(3):
        t0 = time.time()
        prefill(params, {"inputs": prompt})
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    log(f"  prefill {b} x {s}: {wall * 1e3:.2f} ms (then "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms), slstm_scan "
        f"launches {counts['prefill']} = {groups} groups x 1, each S = {s}")
    del cache, last

    srv = DecodeServer(cfg, params, options=ServeOptions(
        batch=SERVE["batch"], max_len=SERVE["max_len"],
        use_mcma_dispatch=True))
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               SERVE["prompt_len"])
                    .astype(np.int32), max_new=SERVE["max_new"])
            for i in range(SERVE["n_requests"])]
    for r in reqs:
        srv.submit(r)
    torch.cuda.synchronize()
    K.slstm_scan.launches = 0
    t0 = time.time()
    stats = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts["serve"] = K.slstm_scan.launches
    if not all(r.done and not r.aborted for r in reqs):
        raise AssertionError("xlstm: server did not drain")
    if counts["serve"] != groups * stats["ticks"]:
        raise AssertionError(f"xlstm serve: {counts['serve']} launches, "
                             f"want {groups} x {stats['ticks']}")
    if stats["kv_bytes_resident"] != 0 or stats["invocation_rate"] != 0.0:
        raise AssertionError(f"xlstm serve stats: {stats.asdict()}")
    n_tok = sum(len(r.out) for r in reqs)
    log(f"  serve xlstm: {stats['ticks']} decode ticks, {n_tok} tokens, "
        f"{wall * 1e3 / stats['ticks']:.2f} ms/tick, {n_tok / wall:.1f} "
        f"tokens/s, slstm_scan launches {counts['serve']} = {groups} x "
        f"{stats['ticks']}, kv_bytes_resident 0, invocation rate 0")
    del srv

    # the consistency witness in float32: chunkwise mLSTM over 256 and the
    # kernel at S = 256, against chunkwise over 128 + the recurrent mLSTM
    # update and the kernel at S = 128 then S = 1
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    params.float()
    wb, ws, at = WITNESS["batch"], WITNESS["seq"], WITNESS["at"]
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (wb, ws))
                         .astype(np.int32)).cuda()
    with torch.no_grad():
        full, _, _, _ = M.forward(cfg32, params, x)
    want = full[:, at].float()
    _, cache = steps.make_prefill_step(cfg32)(params, {"inputs": x[:, :at]})
    got, cache = steps.make_decode_step(cfg32)(params, cache,
                                               x[:, at:at + 1])
    torch.cuda.synchronize()
    gap = (got - want).abs().max().item()
    log(f"  float32 witness: forward({ws}) at {at} vs prefill({at}) + "
        f"decode(1): max |diff| {gap:.4g} (logits span "
        f"{want.min().item():.3g}..{want.max().item():.3g})")
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3,
                               msg="xlstm float32 witness")
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError("xlstm float32 witness: greedy tokens differ")
    if cache["pos"].tolist() != [at + 1] * wb:
        raise AssertionError(f"xlstm witness pos {cache['pos'].tolist()}")
    return counts


def smoke_reference_xlstm(np, torch):
    """The float32 xlstm smoke config on the card against the same
    parameters on the CPU (the kernels' PyTorch versions): prefill 32
    tokens, then 8 greedy decode ticks; logits within 1e-4, tokens equal."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    cfg = smoke_config(get_config("xlstm-1.3b"))
    params = M.init_model(0, cfg, device="cuda")
    cpu_params = copy.deepcopy(params).cpu()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 32)).astype(np.int32))
    runs = {}
    for dev, p in (("cpu", cpu_params), ("cuda", params)):
        lg, cache = steps.make_prefill_step(cfg)(p, {"inputs": toks.to(dev)})
        step = steps.make_decode_step(cfg)
        out = [lg.float().cpu()]
        for _ in range(8):
            nxt = lg.argmax(-1).to(torch.int32)[:, None]
            lg, cache = step(p, cache, nxt)
            out.append(lg.float().cpu())
        runs[dev] = torch.stack(out)
    torch.testing.assert_close(runs["cuda"], runs["cpu"], rtol=1e-4,
                               atol=1e-4, msg="xlstm smoke cuda vs cpu")
    if not torch.equal(runs["cuda"].argmax(-1), runs["cpu"].argmax(-1)):
        raise AssertionError("xlstm smoke: greedy tokens differ")
    log(f"  xlstm smoke config f32, prefill 32 + 8 ticks: card within "
        f"{(runs['cuda'] - runs['cpu']).abs().max().item():.3g} of the "
        "CPU, greedy tokens equal")


def serve_full_width(np, torch):
    """Serve full-width internlm2-1.8b through DecodeServer on both kernel
    backends; returns per-backend results and the server of the first."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import fused_dispatch, switched_mlp
    from repro_torch.models import model as M
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))
    t0 = time.time()
    params = M.init_model(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  init {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"GQA {cfg.n_heads}/{cfg.n_kv_heads}, d_ff={cfg.d_ff}, "
        f"vocab={cfg.vocab}, {cfg.param_dtype}, {n_params} parameters in "
        f"{time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, SERVE["prompt_len"]).astype(np.int32)
               for _ in range(SERVE["n_requests"])]
    kernels = {"pallas": switched_mlp.switched_mlp,
               "pallas_fused": fused_dispatch.switched_mlp_fused}
    results, first = {}, None
    for backend in ("pallas", "pallas_fused"):
        srv = DecodeServer(cfg, params, options=ServeOptions(
            batch=SERVE["batch"], max_len=SERVE["max_len"],
            use_mcma_dispatch=True, backend=backend))
        reqs = [Request(rid=i, prompt=p, max_new=SERVE["max_new"])
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.time()
        stats = srv.run_until_drained()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {b: k.launches for b, k in kernels.items()}
        if not all(r.done and not r.aborted for r in reqs):
            raise AssertionError(f"{backend}: server did not drain")
        want = cfg.n_layers * stats["ticks"]
        if launches[backend] != want or sum(launches.values()) != want:
            raise AssertionError(f"{backend}: launches {launches}, want "
                                 f"{want} of {backend} alone")
        n_tok = sum(len(r.out) for r in reqs)
        results[backend] = dict(tokens=[r.out for r in reqs],
                                launches=launches[backend],
                                ticks=stats["ticks"], wall_s=wall,
                                tok_s=n_tok / wall,
                                invocation=stats["invocation_rate"])
        log(f"  serve {backend}: {stats['ticks']} decode ticks, {n_tok} "
            f"tokens, {wall * 1e3 / stats['ticks']:.2f} ms/tick, "
            f"{n_tok / wall:.1f} tokens/s, invocation rate "
            f"{stats['invocation_rate']:.4f}, served "
            f"{stats['served_invocation_rate']:.4f}, launches "
            f"{launches[backend]} = {cfg.n_layers} x {stats['ticks']}")
        first = first or (srv, reqs)
    if results["pallas"]["tokens"] != results["pallas_fused"]["tokens"]:
        raise AssertionError("greedy tokens differ between pallas and "
                             "pallas_fused")
    log("  greedy tokens equal across pallas and pallas_fused")
    return cfg, params, results, first


def one_step(torch, cfg, params, base, toks, backends):
    """One decode step from copies of the cache ``base``; returns the
    float32 logits of each backend, checked finite and of shape (B, V)."""
    from repro_torch.runtime import steps
    logits = {}
    for backend in backends:
        step = steps.make_decode_step(cfg, use_mcma_dispatch=True,
                                      backend=backend)
        cache = {k: v.clone() for k, v in base.items()}
        lg, _ = step(params, cache, toks)
        if lg.shape != (toks.shape[0], cfg.vocab) or \
                not torch.isfinite(lg.float()).all():
            raise AssertionError(f"{backend}: logits {tuple(lg.shape)} "
                                 "not finite or misshapen")
        logits[backend] = lg.float()
    return logits


def kernel_rounding_approximator(xb, w1, b1, w2, b2):
    """The oracle's approximator MLP with the kernels' rounding: products
    and biases summed in float32, ``h`` rounded once to the activation
    type, the result rounded once."""
    import torch
    h = torch.tanh(xb.float() @ w1.float() + b1.float()).to(xb.dtype)
    return (h.float() @ w2.float() + b2.float()).to(xb.dtype)


def oracle_witness(torch, cfg, params, srv, reqs, gate_bf16=True):
    """Hold the full-width decode step to the independent "xla" oracle
    (per-class capacity buffers, no class sort, no kernel).

    bf16: the kernel backends agree bitwise; their gap to the oracle is
    printed, then the oracle is given the kernels' rounding and (with
    ``gate_bf16``) the gap must shrink at least tenfold.  float32 (the
    same weights upcast, in place): logits within 1e-4 of the oracle,
    greedy tokens equal."""
    from repro_torch.runtime import dispatch
    base = {k: v.clone() for k, v in srv.cache.items()}
    toks = torch.tensor([[r.out[-1]] for r in reqs], dtype=torch.int32,
                        device=base["pos"].device)
    lg = one_step(torch, cfg, params, base, toks,
                  ("xla", "pallas", "pallas_fused"))
    if not torch.equal(lg["pallas"], lg["pallas_fused"]):
        raise AssertionError("pallas and pallas_fused logits differ")
    plain = dispatch.apply_approximator
    dispatch.apply_approximator = kernel_rounding_approximator
    try:
        lg_kr = one_step(torch, cfg, params, base, toks, ("xla",))["xla"]
    finally:
        dispatch.apply_approximator = plain
    gap = (lg["pallas"] - lg["xla"]).abs().max().item()
    gap_kr = (lg["pallas"] - lg_kr).abs().max().item()
    log(f"  one bf16 step from one cache: max |logits - xla| pallas "
        f"{gap:.4g}, pallas_fused "
        f"{(lg['pallas_fused'] - lg['xla']).abs().max().item():.4g}; "
        f"against the oracle with the kernels' rounding {gap_kr:.4g} "
        f"(logits span {lg['xla'].min().item():.3g}.."
        f"{lg['xla'].max().item():.3g})")

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    params.float()
    base32 = {k: v.float() if v.is_floating_point() else v
              for k, v in base.items()}
    lg32 = one_step(torch, cfg32, params, base32, toks,
                    ("xla", "pallas", "pallas_fused"))
    gap32 = (lg32["pallas"] - lg32["xla"]).abs().max().item()
    log(f"  one float32 step, same weights upcast: max |logits - xla| "
        f"pallas {gap32:.4g}, pallas_fused "
        f"{(lg32['pallas_fused'] - lg32['xla']).abs().max().item():.4g} "
        f"(logits span {lg32['xla'].min().item():.3g}.."
        f"{lg32['xla'].max().item():.3g})")
    if not torch.equal(lg32["pallas"], lg32["pallas_fused"]):
        raise AssertionError("float32: pallas and pallas_fused differ")
    for b in ("pallas", "pallas_fused"):
        torch.testing.assert_close(lg32[b], lg32["xla"], rtol=1e-4,
                                   atol=1e-4, msg=f"float32 {b} vs xla")
        if not torch.equal(lg32[b].argmax(-1), lg32["xla"].argmax(-1)):
            raise AssertionError(f"float32 {b}: greedy tokens differ")
    if gate_bf16 and not gap_kr * 10 <= gap:
        raise AssertionError(f"bf16: the oracle with the kernels' rounding "
                             f"is {gap_kr} from pallas, the plain oracle "
                             f"{gap}")


def drive(torch, srv, prompts, max_new, qos=None, count_syncs=False):
    """Submit the stream and tick the server dry, each tick timed on the
    host clock (a tick ends by reading the device) and filed by phase.
    ``qos`` gives each request's ``error_bound``/``tier`` keywords.  With
    ``count_syncs`` the host-device synchronizations of each tick are
    counted (torch.cuda.set_sync_debug_mode) and the times are not
    clean.  Returns (requests, DrainStats, {phase: [ms]}, wall s,
    {phase: [syncs]})."""
    import warnings

    from repro_torch.runtime.server import Request
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new,
                    **(qos[i] if qos else {}))
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    torch.cuda.synchronize()
    times = {"prefill": [], "decode": []}
    syncs = {"prefill": [], "decode": []}
    t0 = time.perf_counter()
    while (srv.queue or any(x is not None for x in srv.slots)) \
            and srv.ticks < 10_000:
        before, a = srv.prefill_ticks, time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            if count_syncs:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            ran = srv.tick()
            torch.cuda.set_sync_debug_mode("default")
        if ran:
            torch.cuda.synchronize()
            phase = "prefill" if srv.prefill_ticks > before else "decode"
            times[phase].append((time.perf_counter() - a) * 1e3)
            syncs[phase].append(sum("synchroniz" in str(w.message)
                                    for w in caught))
    wall = time.perf_counter() - t0
    return reqs, srv.run_until_drained(), times, wall, syncs


def run_stream(torch, cfg, params, prompts, label, qos=None,
               count_syncs=False, **over):
    """Serve the stream through a DecodeServer in the scheduler's serving
    configuration (``over`` changes options), with the launch counts set
    to 0 just before and read just after.  Fails unless every request is
    served, every page comes back, each tick launched the run's own
    switch kernel once per layer and no other, and the dispatch plans are
    one a tick (tick scope) or one a layer a tick (layer scope)."""
    from repro_torch.analysis.audit import PlanCapture
    from repro_torch.kernels import fused_dispatch, switched_mlp
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer
    kernels = {"pallas": switched_mlp.switched_mlp,
               "pallas_fused": fused_dispatch.switched_mlp_fused}
    opts = {**SCHED, "use_mcma_dispatch": True, "backend": "pallas", **over}
    srv = DecodeServer(cfg, params, options=ServeOptions(**opts))
    steps0 = (srv.decode, srv.chunk)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    with PlanCapture() as plans:
        reqs, st, times, wall, syncs = drive(torch, srv, prompts,
                                             SCHED_MAX_NEW, qos, count_syncs)
    launches = {b: k.launches for b, k in kernels.items()}
    if not all(r.done and not r.aborted for r in reqs) or \
            st["undrained_queued"] or st["undrained_inflight"]:
        raise AssertionError(f"{label}: the stream did not drain")
    if opts["kv_page_size"] and st["pages_in_use"] != 0:
        raise AssertionError(f"{label}: {st['pages_in_use']} pages held "
                             "at drain")
    ticks = st["ticks"]
    want = cfg.n_layers * ticks
    per_tick = 1 if opts["route_scope"] == "tick" else cfg.n_layers
    if launches[opts["backend"]] != want or sum(launches.values()) != want \
            or len(plans.plans) != per_tick * ticks:
        raise AssertionError(f"{label}: launches {launches}, "
                             f"{len(plans.plans)} dispatch plans in {ticks} "
                             f"ticks; want {want} "
                             f"of {opts['backend']} alone and {per_tick} "
                             "plan(s) a tick")
    n_tok = sum(len(r.out) for r in reqs)
    ttft = statistics.mean(r.first_token_tick - r.arrival_tick for r in reqs)
    med = {ph: statistics.median(v) if v else 0.0 for ph, v in times.items()}
    mean = {ph: statistics.mean(v) if v else 0.0 for ph, v in times.items()}
    pages = (f", pages hwm {st['page_hwm']}/{opts['kv_pages']}, "
             f"alloc_failures {st['alloc_failures']}, page_util "
             f"{st['page_util']:.3f}") if opts["kv_page_size"] else ""
    sync = "" if not count_syncs else (
        f"; host syncs per decode tick mean "
        f"{statistics.mean(syncs['decode']):.2f} max {max(syncs['decode'])}"
        f", per prefill tick mean {statistics.mean(syncs['prefill']):.2f} "
        f"max {max(syncs['prefill'])} (times under the sync counter)")
    log(f"  {label}: {ticks} ticks ({len(times['decode'])} decode, "
        f"{st['prefill_ticks']} prefill); ms per decode tick median "
        f"{med['decode']:.2f} mean {mean['decode']:.2f}, per prefill "
        f"tick median {med['prefill']:.2f} mean {mean['prefill']:.2f}; "
        f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; "
        f"mean TTFT {ttft:.2f} ticks; invocation rate "
        f"{st['invocation_rate']:.4f}, served "
        f"{st['served_invocation_rate']:.4f}; launches {launches}, "
        f"dispatch plans {len(plans.plans)}; kv_bytes_resident "
        f"{st['kv_bytes_resident']}{pages}{sync}")
    return dict(srv=srv, tokens=[r.out for r in reqs], stats=st,
                launches=launches, tick_log=list(srv.tick_log),
                steps0=steps0)


def stream_prompts(np, cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32)
            for n in SCHED_PROMPTS]


def serve_scheduler(np, torch):
    """Full-width internlm2-1.8b through the reference's serving
    configuration (tick scope, chunked prefill, paged KV), gates 1 to 5 of
    the phase, and the slice-1 configuration on the same stream."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    cfg = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))
    params = M.init_model(0, cfg, device="cuda")
    prompts = stream_prompts(np, cfg)

    def run(label, cfg_=cfg, **over):
        return run_stream(torch, cfg_, params, prompts, label, **over)

    # gates 1 and 2: both kernel backends give equal tokens; every run
    # launches its own kernel once per layer a tick, one plan a tick
    runs = {b: run(f"{b} tick/chunk 64/paged 16", backend=b)
            for b in ("pallas", "pallas_fused")}
    if runs["pallas"]["tokens"] != runs["pallas_fused"]["tokens"]:
        raise AssertionError("scheduler: greedy tokens differ between "
                             "pallas and pallas_fused")
    log(f"  gates 1-2: tokens equal across backends; {cfg.n_layers} launches "
        f"and 1 dispatch plan per tick on each")
    # gate 3: the dense cache, same schedule, same tokens and tick log
    dense = run("pallas dense cache", kv_page_size=0)
    if dense["tokens"] != runs["pallas"]["tokens"] or \
            dense["tick_log"] != runs["pallas"]["tick_log"]:
        raise AssertionError("scheduler: the dense cache's tokens or tick "
                             "log differ from the paged cache's")
    log("  gate 3: dense cache == paged cache (tokens and tick log)")
    # gate 4: a pool below the worst-case reservation defers admission
    tight = run(f"pallas {SCHED_TIGHT_PAGES}-page pool",
                kv_pages=SCHED_TIGHT_PAGES)
    st = tight["stats"]
    if not st["alloc_failures"] > 0 or st["page_hwm"] > SCHED_TIGHT_PAGES:
        raise AssertionError(f"scheduler tight pool: alloc_failures "
                             f"{st['alloc_failures']}, page_hwm "
                             f"{st['page_hwm']}")
    log(f"  gate 4: {SCHED_TIGHT_PAGES}-page pool deferred admission "
        f"{st['alloc_failures']} times and served every request")
    # the token-by-token runs at SCHED_TBT_LAYERS layers
    del params
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg, n_layers=SCHED_TBT_LAYERS)
    params = M.init_model(0, cfg, device="cuda")
    # the slice-1 configuration for comparison
    run(f"pallas slice-1 configuration (layer scope, token by token, "
        f"dense), {SCHED_TBT_LAYERS} layers", cfg, **SLICE1)
    # gate 5: chunked == token by token at no-clip capacities; bf16 shown
    no_clip = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, **NO_CLIP))
    bf = [run(f"bf16 no-clip prefill_chunk {c}", no_clip, prefill_chunk=c)
          for c in (64, 0)]
    pairs = [(x, y) for a, b in zip(bf[0]["tokens"], bf[1]["tokens"])
             for x, y in zip(a, b)]
    log(f"  bf16 no-clip: chunked == token by token on "
        f"{sum(x == y for x, y in pairs)} of {len(pairs)} tokens (not gated)")
    params.float()
    f32 = dataclasses.replace(no_clip, param_dtype="float32",
                              act_dtype="float32")
    fl = [run(f"float32 no-clip prefill_chunk {c}", f32, prefill_chunk=c)
          for c in (64, 0)]
    if fl[0]["tokens"] != fl[1]["tokens"]:
        raise AssertionError("float32 no-clip: chunked and token-by-token "
                             "prefill sample different tokens")
    log("  gate 5: float32 no-clip, chunked == token by token (tokens)")
    return runs


def serve_features(np, torch):
    """Full-width internlm2-1.8b in the scheduler's serving configuration
    with per-request QoS tiers, an approximator library and capacity
    autotune, each on both kernel backends, with the phase's gates; then
    both switch kernels on the new inputs (plans of the top rung and of a
    ladder_from_counts rung, residency-gathered stacks).  Returns this
    phase's launches per kernel, run by run: {backend: [{"run", "ticks",
    "launches"}, ...]} for each run that launched that backend's kernel,
    and {cfg, params, autotune} for [analysis full width]: the library
    model and each backend's autotune server."""
    from repro_torch.analysis.audit import rungs_visited
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.runtime import autotune as at
    from repro_torch.runtime.options import LibrarySpec
    cfg = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))
    params = M.init_model(0, cfg, device="cuda")
    prompts = stream_prompts(np, cfg)
    backends = ("pallas", "pallas_fused")
    by_run = {b: [] for b in backends}

    def run(label, cfg_=cfg, params_=params, **over):
        r = run_stream(torch, cfg_, params_, prompts, label, **over)
        for b in backends:
            if r["launches"][b]:
                by_run[b].append(dict(run=label, ticks=r["stats"]["ticks"],
                                      launches=r["launches"][b]))
        return r

    def same_tokens(runs, what):
        if runs["pallas"]["tokens"] != runs["pallas_fused"]["tokens"]:
            raise AssertionError(f"{what}: greedy tokens differ between "
                                 "pallas and pallas_fused")

    # 1. QoS: tiers round-robin, half the requests by error_bound, half by
    # tier, on the default table (0.05, 0.10, 0.20)
    bounds = at.default_tier_bounds(cfg.approx.error_bound)
    qos = [dict(error_bound=bounds[i % 3]) if i % 2 == 0
           else dict(tier=i % 3) for i in range(len(prompts))]
    q = {b: run(f"{b} QoS tiers {bounds}", qos=qos, qos_tiers=True,
                backend=b) for b in backends}
    same_tokens(q, "QoS")
    if q["pallas"]["stats"]["per_tier"] != \
            q["pallas_fused"]["stats"]["per_tier"]:
        raise AssertionError("QoS: per-tier ledgers differ between backends")
    for b, r in q.items():
        srv = r["srv"]
        if not (np.array_equal(srv.tier_routed_sum.sum(0), srv.routed_sum)
                and np.array_equal(srv.tier_dispatched_sum.sum(0),
                                   srv.dispatched_sum)
                and srv.tier_routed_sum.sum() == srv.active_sum):
            raise AssertionError(f"QoS {b}: the per-tier counts do not sum "
                                 "to the totals")
    srv = q["pallas"]["srv"]
    log(f"  QoS margins {[round(float(m), 4) for m in srv.tier_margins]}, "
        f"default tier {srv.default_tier}")
    for p in q["pallas"]["stats"]["per_tier"]:
        log(f"  tier {p['tier']} (bound {p['error_bound']}, margin "
            f"{p['margin']:+.4f}): {p['rows']:.0f} rows, routed invocation "
            f"{p['routed_invocation_rate']:.4f}, served invocation "
            f"{p['served_invocation_rate']:.4f}, dropped_frac "
            f"{p['dropped_frac']:.4f}")
    base = run("pallas every request at the base tier",
               qos=[dict(tier=srv.default_tier)] * len(prompts),
               qos_tiers=True)
    plain = run("pallas untiered")
    if base["tokens"] != plain["tokens"] or \
            base["tick_log"] != plain["tick_log"]:
        raise AssertionError("QoS: the base-tier server's tokens or tick "
                             "log differ from the untiered server's")
    log("  QoS gates: tokens and per-tier ledgers equal across backends; "
        "per-tier counts sum to the totals; base tier == untiered (tokens "
        "and tick log)")

    # 2. the library: 6 approximators, 3 resident
    cfg_lib = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, library_size=6))
    params_lib = M.init_model(0, cfg_lib, device="cuda")
    spec = LibrarySpec(library_size=6, n_resident=3, observe_window=2,
                       cooldown=2)
    lib = {b: run(f"{b} library 6 (3 resident)", cfg_lib, params_lib,
                  library=spec, backend=b) for b in backends}
    same_tokens(lib, "library")
    st = lib["pallas"]["stats"]
    if st["residency"] != lib["pallas_fused"]["stats"]["residency"]:
        raise AssertionError("library: the swaps differ between backends")
    for b, r in lib.items():
        s_ = r["stats"]
        lrc = s_["lib_routed_per_class"]
        if len(lrc) != 7 or s_["off_set_exact_rows"] != \
                s_["routed_per_class"][0] - lrc[0] or \
                s_["off_set_exact_rows"] > sum(lrc[1:]):
            raise AssertionError(f"library {b}: lib_routed_per_class {lrc} "
                                 "does not reconcile with off_set_exact_rows "
                                 f"{s_['off_set_exact_rows']}")
        srv_ = r["srv"]
        if (srv_.decode, srv_.chunk) != r["steps0"] or srv_._steps \
                or srv_._chunk_steps:
            raise AssertionError(f"library {b}: a swap built a new step")
    swaps = st["residency"]["swaps"]
    log(f"  library: lib_routed_per_class {st['lib_routed_per_class']}, "
        f"off_set_exact_rows {st['off_set_exact_rows']}, final resident "
        f"set {st['residency']['final_residency']}, "
        + (f"{len(swaps)} swaps: " + "; ".join(
            f"tick {x['tick']} slot {x['slot']}: {x['demoted']} -> "
            f"{x['promoted']} (EMA {x['cold_ema']:.3f} -> "
            f"{x['hot_ema']:.3f})" for x in swaps) if swaps else "no swap"))
    n = cfg.approx.n_approx
    cfg_id = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, library_size=n))
    ident = run(f"pallas identity residency (library of {n}, {n} "
                "resident)", cfg_id, params, library=LibrarySpec(n, n))
    if ident["tokens"] != plain["tokens"] or \
            ident["tick_log"] != plain["tick_log"]:
        raise AssertionError("library: identity residency differs from the "
                             "library-less server")
    log("  library gates: tokens and swaps equal across backends; "
        "lib_routed_per_class (7) reconciles with off_set_exact_rows; the "
        "two step objects unchanged across swaps; identity residency == "
        "library-less (tokens and tick log)")

    # 3. autotune over the default ladder
    ladder = at.default_ladder(cfg)
    atr = {b: run(f"{b} autotune (drop budget 0.05)", autotune=True,
                  drop_budget=0.05, backend=b) for b in backends}
    same_tokens(atr, "autotune")
    summ = atr["pallas"]["stats"]["autotune"]
    if summ != atr["pallas_fused"]["stats"]["autotune"]:
        raise AssertionError("autotune: the rung trajectories differ")
    for b, r in atr.items():
        srv_ = r["srv"]
        seen = rungs_visited(r["stats"]["autotune"])
        if set(srv_._steps) != seen or not set(srv_._chunk_steps) <= seen:
            raise AssertionError(f"autotune {b}: decode steps built for "
                                 f"rungs {sorted(srv_._steps)}, chunk steps "
                                 f"{sorted(srv_._chunk_steps)}, rungs "
                                 f"visited {sorted(seen)}")
    log(f"  autotune ladder {[(p.exact_frac, p.invoke_frac) for p in ladder]}"
        f"; trajectory: "
        + ("; ".join(f"tick {x['tick']} rung {x['from_index']} -> "
                     f"{x['to_index']} (drop EMA {x['drop_ema']:.4f})"
                     for x in summ["switches"]) or "no switch")
        + f"; final rung {summ['final_index']}; "
        f"{len(atr['pallas']['srv']._steps)} decode step objects for "
        f"{len(rungs_visited(summ))} rungs visited")
    log("  autotune gates: tokens and trajectory equal across backends; one "
        "decode step object per rung visited")

    # host syncs per tick (separate runs: the counter slows the host)
    run("pallas untiered, syncs counted", count_syncs=True)
    run("pallas QoS, syncs counted", qos=qos, qos_tiers=True,
        count_syncs=True)
    run("pallas library, syncs counted", cfg_lib, params_lib, library=spec,
        count_syncs=True)
    run("pallas autotune, syncs counted", autotune=True, drop_budget=0.05,
        count_syncs=True)

    # 4. both switch kernels at the new inputs
    rung = next((p for p in plain["srv"].derived_ladder()
                 if len(set(p.invoke_fracs)) > 1),
                plain["srv"].derived_ladder()[0])
    blk = params_lib.blocks[0].approx
    res = torch.tensor(lib["pallas"]["stats"]["residency"]["final_residency"],
                       dtype=torch.int32, device="cuda")
    feature_kernels(np, torch, cfg, at, rung, blk, res)
    del params
    for b in backends:
        log(f"  {b} launches by run: " + "; ".join(
            f"{x['run']}: {x['launches']} = {cfg.n_layers} x {x['ticks']} "
            "ticks" for x in by_run[b]))
    # what [analysis full width] audits: the library model and the
    # autotune servers
    return by_run, dict(cfg=cfg_lib, params=params_lib,
                        autotune={b: atr[b]["srv"] for b in backends})


def feature_kernels(np, torch, cfg, at, rung, blk, residency):
    """Both switch kernels against their plain twins, timed in bf16, at a
    decode tick's 8 rows and a 512-row chunk, on plans of the default
    ladder's top rung (no row dropped), of an asymmetric
    ``ladder_from_counts`` rung, and on stacks gathered from a library
    with a residency vector (n_resident + 1 rows of library_size + 1)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import dispatch
    a = cfg.approx
    d, dh = cfg.d_model, a.d_hidden
    top = at.default_ladder(cfg)[-1]
    log(f"  kernel inputs: top rung {top}; ladder_from_counts rung "
        f"exact_frac {rung.exact_frac:.3f} invoke_fracs "
        f"{tuple(round(f, 3) for f in rung.invoke_fracs)}; library stacks "
        f"{tuple(blk.a_w1.shape)} gathered at residency "
        f"{residency.tolist()}")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(21)
    for kind, pt in (("top rung", top), ("ladder_from_counts rung", rung),
                     ("gathered stacks", top)):
        n = residency.numel() if kind == "gathered stacks" else a.n_approx
        for t in (SERVE["batch"], SCHED["batch"] * SCHED["prefill_chunk"]):
            logits = torch.from_numpy(rng.normal(size=(t, n + 1))
                                      .astype(np.float32)).cuda()
            plan = dispatch.make_dispatch_plan(
                logits, operating_point=pt, backend="pallas",
                block_t=a.block_t)
            for dtype in ("float32", "bfloat16"):
                x, w = switch_inputs(np, torch, rng, t, n + 1, d, dh, dtype)
                if kind == "gathered stacks":
                    g1, g2, g3, g4 = ops.gather_resident_stacks(
                        blk.a_w1, blk.a_b1, blk.a_w2, blk.a_b2, residency)
                    w = [v.to(getattr(torch, dtype)) for v in (
                        g1[:, :d, :dh], g2[:, :dh], g3[:, :dh, :d],
                        g4[:, :d])]
                time_switch_case(np, torch, flush, x, plan.eff, w,
                                 a.block_t, dtype, f"{kind} {t} rows",
                                 timed=dtype == "bfloat16")
    del flush


def moves_per_layer(np, torch, case, backend, device):
    """(gathers, scatters) a layer of a MOVES_LAYERS-layer execute against
    one plan, as tests/test_torch_analysis.py counts them."""
    import torch.nn.functional as F

    from repro_torch.analysis.opcount import activation_moves
    from repro_torch.runtime import dispatch as D
    t, n, d, dh = case["t"], case["n"], case["d"], case["d_h"]
    rng = np.random.default_rng(9)
    to = dict(device=device, dtype=getattr(torch, case["dtype"]))
    f = lambda *s_, sc=1.0: torch.from_numpy(
        (rng.normal(size=s_) * sc).astype(np.float32)).to(**to)
    x = f(t, d, sc=0.5)
    logits = (x.float() @ f(d, n + 1, sc=0.5).float())
    w = [f(n, d, dh, sc=0.2), f(n, dh, sc=0.1), f(n, dh, d, sc=0.2),
         f(n, d, sc=0.1)]
    wi, wo = f(d, 2 * d, sc=0.1), f(2 * d, d, sc=0.1)
    stacked = [[a * (0.8 + 0.1 * i) for a in w] for i in range(MOVES_LAYERS)]
    plan = D.make_dispatch_plan(logits, exact_cap=case["exact_cap"],
                                invoke_cap=case["invoke_cap"],
                                backend=backend, block_t=case["block_t"])

    def tick(h):
        for ws in stacked:
            h = D.execute_dispatch(plan, h, lambda xb: F.silu(xb @ wi) @ wo,
                                   *ws)
        return h
    g, s_ = activation_moves(tick, (x,))
    if g % MOVES_LAYERS or s_ % MOVES_LAYERS:
        raise AssertionError(f"activation moves {backend}: {g}, {s_} over "
                             f"{MOVES_LAYERS} layers")
    return g // MOVES_LAYERS, s_ // MOVES_LAYERS


def analysis_moves(np, torch):
    """Activation moves a layer (``MOVES_CASES``): the card's count at the
    CPU test's shapes equals the CPU's count of the same call; fused at
    most (1, 1) and below unfused at both shapes."""
    for name, case in MOVES_CASES.items():
        card_moves = {b: moves_per_layer(np, torch, case, b, "cuda")
                      for b in ("xla", "pallas", "pallas_fused")}
        line = f"  activation moves a layer {name}: card {card_moves}"
        if name == "test shapes":
            cpu = {b: moves_per_layer(np, torch, case, b, "cpu")
                   for b in card_moves}
            if cpu != card_moves:
                raise AssertionError(f"activation moves: card {card_moves}, "
                                     f"CPU {cpu}")
            line += f", CPU {cpu}"
        (gf, sf), (gu, su) = card_moves["pallas_fused"], card_moves["pallas"]
        if not (gf <= 1 and sf <= 1 and gf < gu and sf < su):
            raise AssertionError(f"activation moves {name}: {card_moves}")
        log(line)


def analysis_lint(root, baseline):
    """The lint stage over the checkout: no finding the baseline lacks."""
    from repro_torch.analysis import run_lint
    t0 = time.time()
    lint = run_lint(root=root)
    new_lint = [f.render() for f in lint if f.key not in baseline]
    if new_lint:
        raise AssertionError("lint: new findings\n" + "\n".join(new_lint))
    log(f"  lint: {len(lint)} findings, 0 new, in {time.time() - t0:.2f} s")


def analysis_full_width(np, torch, audited, compiles_at_build):
    """The contract gate on the uncut library model of the QoS/library/
    autotune phase (``audited``: its cfg, params and autotune servers),
    with the gates of the module docstring's phase 6a.  Returns the step
    calls' switch launches run by run, as serve_features does."""
    from repro_torch.analysis import audit, findings, jit_cache
    from repro_torch.kernels import build
    root = Path(__file__).resolve().parent
    baseline = findings.load_baseline(root / "analysis_baseline_torch.txt")
    card = card_line()
    cfg, params = audited["cfg"], audited["params"]

    # TA001: one decode step object per rung visited, no rebuild
    for b, srv in audited["autotune"].items():
        visited = audit.rungs_visited(srv.controller.summary())
        objs = jit_cache.step_objects(srv)
        bad = [f.key for f in audit.audit_server(
            srv, scope=f"DecodeServer[{b},autotune]")]
        if bad or jit_cache.cache_size(srv) != len(visited):
            raise AssertionError(f"TA001 {b}: step objects {objs} for rungs "
                                 f"visited {sorted(visited)}: {bad}")
        log(f"  TA001 {b} autotune server: {objs['decode']} decode and "
            f"{objs['chunk']} chunk step objects for {len(visited)} rungs "
            f"visited {sorted(visited)}")

    by_run = {"pallas": [], "pallas_fused": []}
    for b in ("xla", "pallas", "pallas_fused"):
        t0 = time.time()
        fs, calls = audit.audit_steps(
            cfg, params, b, batch=SCHED["batch"], max_len=SCHED["max_len"],
            page_sizes=(ANALYSIS_PAGE,), scopes=ANALYSIS_SCOPES,
            residency_sets=ANALYSIS_RESIDENCY, device="cuda")
        torch.cuda.synchronize()
        new = [f.render() for f in fs if f.key not in baseline]
        if new:
            raise AssertionError(f"audit {b}: new findings\n"
                                 + "\n".join(new))
        want = cfg.n_layers if b != "xla" else 0
        groups = {}
        for c in calls:
            key = (c["step"], c["scope"], c["layout"])
            grandfathered = {k.split(":")[-1][len("sync_"):]
                             for k in baseline
                             if k.startswith("TA003:audit_steps:")
                             and f":{c['step']}[{b},{c['scope']}" in k}
            recorded = sum(c["syncs"].values())
            if c["waits"] != recorded or not set(c["syncs"]) \
                    <= grandfathered or c["launches"] != want:
                raise AssertionError(
                    f"analysis {b} {key}: the card waited {c['waits']} "
                    f"times, the op list recorded {c['syncs']} (baseline "
                    f"{sorted(grandfathered)}), {c['launches']} switch "
                    f"launches where {want}")
            groups.setdefault(key, []).append(c)
        for (step, scope, layout), cs in groups.items():
            log(f"  {b} {step} {scope} {layout}: {len(cs)} calls, syncs a "
                f"call (op list / card waits) max "
                f"{max(sum(c['syncs'].values()) for c in cs)} / "
                f"{max(c['waits'] for c in cs)}, switch launches a call "
                f"{cs[0]['launches']}, plans checked "
                f"{sum(c['plans'] for c in cs)}")
        log(f"  {b}: {len(calls)} step calls in {time.time() - t0:.1f} s, "
            f"{len(fs)} findings ({card})")
        if b != "xla":
            by_run[b].append(dict(run=f"analysis steps {b}",
                                  calls=len(calls), launches=sum(
                                      c["launches"] for c in calls)))

    builds = jit_cache.kernel_builds()
    if builds["compiles"] != compiles_at_build or \
            not set(builds["loaded"]) <= set(build.SOURCES):
        raise AssertionError(f"TA001: {builds} after the build phase's "
                             f"{compiles_at_build} nvcc runs")
    log(f"  TA001 kernels: libraries loaded {sorted(builds['loaded'])}, one "
        f"per source; {builds['compiles']} nvcc runs, none after the build")

    analysis_moves(np, torch)
    analysis_lint(root, baseline)
    return by_run


def smoke_reference_check(np, torch):
    """The float32 smoke config on the card, each backend, against the
    same parameters served on the CPU by the eager oracle: logits within
    1e-4 and greedy tokens equal over 8 ticks."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    cfg = smoke_config(get_config("internlm2-1.8b"))
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True))
    params = M.init_model(0, cfg, device="cuda")
    cpu_params = copy.deepcopy(params).cpu()
    b, max_len, ticks = 8, 16, 8
    mask = torch.tensor([True] * 6 + [False] * 2)
    runs = {}
    for dev, backend in (("cpu", "xla"), ("cuda", "xla"), ("cuda", "pallas"),
                         ("cuda", "pallas_fused")):
        p = cpu_params if dev == "cpu" else params
        step = steps.make_decode_step(cfg, use_mcma_dispatch=True,
                                      backend=backend)
        cache = M.init_cache(cfg, b, max_len, device=dev)
        toks = torch.arange(1, b + 1, dtype=torch.int32)[:, None]
        out = []
        for _ in range(ticks):
            lg, cache = step(p, cache, toks.to(dev), mask.to(dev))
            out.append(lg.float().cpu())
            toks = lg.argmax(-1).to(torch.int32).cpu()[:, None]
        runs[dev, backend] = torch.stack(out)
    ref = runs["cpu", "xla"]
    worst = 0.0
    for key, lg in runs.items():
        torch.testing.assert_close(lg, ref, rtol=1e-4, atol=1e-4,
                                   msg=f"smoke {key} vs cpu xla")
        if not torch.equal(lg.argmax(-1), ref.argmax(-1)):
            raise AssertionError(f"smoke {key}: greedy tokens differ")
        worst = max(worst, (lg - ref).abs().max().item())
    if not torch.equal(runs["cuda", "pallas"], runs["cuda", "pallas_fused"]):
        raise AssertionError("smoke: pallas and pallas_fused differ")
    log(f"  smoke config f32, {ticks} ticks: every card backend within "
        f"{worst:.3g} of the CPU oracle, greedy tokens equal")


def train_cfg(arch, **kw):
    """A config as the train phases run it: remat on; the dense family
    with the ApproxFFN (the config's 3 approximators of 256), the tick
    router and TRAIN_ERROR_BOUND."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if cfg.family == "dense":
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True, route_scope="tick",
            error_bound=TRAIN_ERROR_BOUND))
    return dataclasses.replace(cfg, remat=True, **kw)


class MetricsRecorder:
    """Keeps the metrics of each step a Trainer takes."""

    def __init__(self, trainer):
        self.steps, inner = [], trainer.step_fn

        def step(state, batch):
            state, m = inner(state, batch)
            self.steps.append(m)
            return state, m
        trainer.step_fn = step


def tick_labels(torch, cfg, params, inputs):
    """The train forward's tick labels: each token's competitive-label
    votes summed over the layers, the first maximum (as ``forward``
    computes them for the tick-router head)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    with torch.no_grad():
        x = L.embed_fwd(cfg, params.embed, inputs)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        votes = 0
        for blk in params.blocks:
            x, _, _, m = M._dense_block(cfg, blk, x, pos, None, serve=False)
            votes = votes + m["_label_votes"]
    return votes.argmax(-1)


def train_run(torch, cfg, shape, dev, tc_kw=None, mesh=None):
    """A Trainer on the synthetic stream (on ``mesh`` when given); returns
    it with its recorder."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=shape["seq"],
                     global_batch=shape["batch"], seed=0)
    tc = TrainerConfig(total_steps=shape["steps"], log_every=1,
                       grad_accum=shape["grad_accum"],
                       warmup=shape["warmup"], **(tc_kw or {}))
    tr = Trainer(cfg, tc, ds, mesh=mesh, seed=0, device=dev)
    return tr, MetricsRecorder(tr)


def in_turns(torch, mesh, fn):
    """``fn()`` on every rank of ``mesh``'s world one rank at a time (at
    once without a mesh): ranks that share the card draw each parameter
    whole before cutting their shard (``model.init_model(mesh=)``), and
    16 ranks drawing internvl2-76b's 4.2 GB float32 token table at once
    would not fit beside what they hold."""
    from repro_torch.sharding import collectives as C
    if mesh is None:
        return fn()
    out = None
    for r in range(mesh.devices.size):
        if r == mesh.rank:
            out = fn()
            release(torch)
        C.barrier()
    return out


def train_dense_full_width(np, torch, dev="cuda", cfg=None,
                           shape=TRAIN_DENSE):
    """internlm2-1.8b at full width through the Trainer; returns the
    numbers it prints."""
    from repro_torch.launch.profile_decode import profiled
    from repro_torch.runtime import steps
    cfg = cfg or train_cfg("internlm2-1.8b")
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tr, rec = train_run(torch, cfg, shape, dev)
    n_params = sum(p.numel() for p in tr.state["params"].parameters())
    log(f"  init {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"vocab={cfg.vocab}, {cfg.param_dtype}, remat {cfg.remat}, "
        f"ApproxFFN {cfg.approx.n_approx} x {cfg.approx.d_hidden} "
        f"({cfg.approx.route_scope} router), {n_params} parameters in "
        f"{time.time() - t0:.1f} s")
    tr.run()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    for h, m in zip(tr.history, rec.steps):
        vals = {k: float(m[k]) for k in ("lm_loss", "grad_norm",
                                          "invocation", "router_acc",
                                          "tick_router_acc", "lr")}
        log(f"  step {h['step']}: {h['dt'] * 1e3:.1f} ms, loss "
            f"{h['loss']:.4f}, " + ", ".join(f"{k} {v:.4g}"
                                              for k, v in vals.items()))
        if not all(np.isfinite([h["loss"], h["grad_norm"]])):
            raise AssertionError(f"train dense: step {h['step']} loss or "
                                 "grad norm not finite")
    ms = statistics.median(h["dt"] for h in tr.history[1:]) * 1e3
    tokens = shape["batch"] * shape["seq"]
    batch = {k: v.to(dev) for k, v in
             tr.ds.batch_at(shape["steps"]).items()}

    def one():
        tr.state, m = tr.step_fn(tr.state, batch)
        float(m["loss"])
    host_ms, wall_ms, kernels, _ = profiled(torch, one, 1)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    gemm = sum(e.self_device_time_total for e in kernels
               if any(w in e.key for w in ("gemm", "nvjet", "cutlass",
                                           "xmma"))) / 1e3
    # the step's forward and backward alone; the rest is clip + AdamW
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    steps.loss_and_grads(cfg, tr.state["params"], batch,
                         shape["grad_accum"])
    sync()
    fb_ms = (time.perf_counter() - t0) * 1e3
    out = dict(ms=ms, tokens_per_s=tokens / ms * 1e3, peak_bytes=peak,
               launches=launches, busy_ms=busy, gemm_ms=gemm, fb_ms=fb_ms,
               idle=max(0.0, 1 - busy / host_ms))
    log(f"  {ms:.1f} ms a step (median of steps 2 to {shape['steps']}), "
        f"{out['tokens_per_s']:.0f} tokens/s, peak memory {peak} B "
        f"({peak / 2**30:.2f} GiB)")
    log(f"  one step profiled: {host_ms:.1f} ms (host clock), "
        f"{wall_ms:.1f} ms under the profiler, device busy {busy:.1f} ms in "
        f"{launches} kernel launches, idle share {out['idle']:.3f}; GEMM "
        f"kernels {gemm:.1f} ms of the busy time; forward + backward alone "
        f"{fb_ms:.1f} ms (host clock), the rest of a step clip + AdamW")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} "
            f"launches  {e.key[:80]}")
    return out


def train_dense_parity(np, torch, dev="cuda", cfg=None, shape=TRAIN_PARITY):
    """One float32 train step on the card and one on the CPU from the same
    state: loss and metrics within 1e-4 relative, gradients within 1e-4,
    new parameters within 2 lr.  Returns the largest differences."""
    from repro_torch import convert
    from repro_torch.runtime import steps
    cfg = cfg or train_cfg("internlm2-1.8b", n_layers=shape["n_layers"],
                           param_dtype="float32", act_dtype="float32")
    cpu = steps.init_train_state(0, cfg, device="cpu")
    card = convert.train_state_from_jax(
        cfg, convert.train_state_to_tree(cfg, cpu), device=dev)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (shape["batch"], shape["seq"] + 1)).astype(np.int32)
    step = steps.make_train_step(cfg, grad_accum=shape["grad_accum"],
                                 base_lr=shape["lr"], warmup=0,
                                 total_steps=10)
    out = {}
    for name, state, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        t = torch.from_numpy(toks).to(d)
        batch = {"inputs": t[:, :-1], "labels": t[:, 1:]}
        # the gradients the step computes, before its clip and update
        # (which work in place)
        _, _, g = steps.loss_and_grads(cfg, state["params"], batch,
                                       shape["grad_accum"])
        g = {k: v.cpu() for k, v in g.items()}
        tick = tick_labels(torch, cfg, state["params"], batch["inputs"])
        new, m = step(state, batch)
        out[name] = ({k: v.cpu() for k, v in m.items()}, g,
                     {k: p.detach().cpu() for k, p in
                      new["params"].named_parameters()}, tick.cpu())
    (cm, cg, cp, ct), (gm, gg, gp, gt) = out["cpu"], out["card"]
    # the competitive labels are mixed: exact and approximator tokens,
    # and at least two classes among the tick labels, equal on both
    inv = float(cm["invocation"])
    if not 0 < inv < 1:
        raise AssertionError(f"train parity: invocation {inv}, the labels "
                             "are not mixed")
    if not torch.equal(gt, ct):
        raise AssertionError("train parity: the card's tick labels differ "
                             "from the CPU's")
    classes = torch.bincount(ct.flatten(), minlength=cfg.approx.n_live + 1)
    if (classes > 0).sum() < 2:
        raise AssertionError(f"train parity: tick labels all one class "
                             f"{classes.tolist()}")
    worst = {"metric_rel": 0.0, "grad": 0.0, "param": 0.0}
    for k in cm:
        torch.testing.assert_close(gm[k], cm[k], rtol=1e-4, atol=1e-6,
                                   msg=f"train parity metric {k}")
        worst["metric_rel"] = max(worst["metric_rel"], (
            (gm[k] - cm[k]).abs() / cm[k].abs().clamp(min=1e-30)).max()
            .item())
    lr = float(cm["lr"])
    for k in cg:
        torch.testing.assert_close(gg[k], cg[k], rtol=0, atol=1e-4,
                                   msg=f"train parity grad {k}")
        torch.testing.assert_close(gp[k], cp[k], rtol=0, atol=2 * lr,
                                   msg=f"train parity param {k}")
        worst["grad"] = max(worst["grad"], (gg[k] - cg[k]).abs().max()
                            .item())
        worst["param"] = max(worst["param"], (gp[k] - cp[k]).abs().max()
                             .item())
    log(f"  {cfg.n_layers} layers at full width, float32, "
        f"{shape['batch']} x {shape['seq']}, grad_accum "
        f"{shape['grad_accum']}, error bound {cfg.approx.error_bound}: "
        f"invocation {inv:.4g}, tick labels by class {classes.tolist()} "
        f"(equal on both); loss {float(cm['loss']):.6f} (CPU) "
        f"{float(gm['loss']):.6f} (card); max relative metric difference "
        f"{worst['metric_rel']:.3g} (gate 1e-4), max |gradient difference| "
        f"{worst['grad']:.3g} (gate 1e-4), max |parameter difference| "
        f"{worst['param']:.3g} (gate 2 lr = {2 * lr:.3g})")
    return worst


def slstm_grad_gate(np, torch, dev="cuda"):
    """slstm_scan_trainable at xlstm-1.3b's prefill and train shapes,
    random cotangents on all five outputs.  Its outputs (the kernel's)
    against slstm_scan_plain's within SLSTM_TOL; its gradients against
    autograd through slstm_scan_plain and through the recurrence in
    float64.  float32 weights: gradients within 3e-5 of the plain
    version's.  bfloat16 weights: within 2e-2 of the plain version's in
    norm (||g - plain|| / ||plain||), the independent check, and within
    2e-2 of the float64 ones elementwise.  The float64 witness is the
    backward's own recurrence (``ref.slstm_scan_ref``, ``h`` unrounded)
    at a higher precision, so it checks rounding only.  Autograd through
    the plain version rounds the gradient of ``h`` to bfloat16 at each
    step (the backward of its cast), so single elements of its gradients
    stray from the float64 ones by far more than the trainable's do (the
    phase prints both gaps for each gradient).  Returns {(shape, dtype):
    max |trainable - plain| of the gradients}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.kernels.sweeps import slstm_inputs
    names = ("xg", "wh", "h0", "c0", "n0", "m0")
    out = {}
    for shape in (SLSTM_FULL["prefill"], SLSTM_TRAIN):
        arrays = slstm_inputs(*shape, wh_scale=shape[3] ** -0.5)
        rng = np.random.default_rng(3)
        s, b, h, hd = shape
        cot = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(dev) for sh in ((s, b, h, hd),) + ((b, h, hd),) * 4]
        for wdtype in ("float32", "bfloat16"):
            grads, fwd = {}, {}
            for name, fn, dt in (("trainable", K.slstm_scan_trainable, None),
                                 ("plain", K.slstm_scan_plain, None),
                                 ("float64", ref.slstm_scan_ref,
                                  torch.float64)):
                xg, wh, *st = [torch.from_numpy(v).to(dev) for v in arrays]
                ins = [xg, wh.to(getattr(torch, wdtype)), *st]
                ins = [(t if dt is None else t.to(dt)).requires_grad_()
                       for t in ins]
                ys, fin = fn(*ins)
                fwd[name] = [t.detach() for t in (ys, *fin)]
                grads[name] = [g.double() for g in torch.autograd.grad(
                    (ys, *fin), ins, [c.to(ys.dtype) for c in cot])]
            tol = SLSTM_TOL[wdtype]
            for g, w, what in zip(fwd["trainable"], fwd["plain"],
                                  ("ys", "h", "c", "n", "m")):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"slstm_scan_trainable {shape} "
                                         f"{wdtype}: {what} not finite")
                torch.testing.assert_close(
                    g, w, rtol=tol, atol=tol,
                    msg=f"slstm_scan_trainable {shape} {wdtype} {what}")
            fwd_err = max_err(torch, fwd["trainable"], fwd["plain"])
            tol = SLSTM_GRAD_TOL[wdtype]
            errs = {}
            for what, g, w, t64 in zip(names, grads["trainable"],
                                       grads["plain"], grads["float64"]):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"slstm grad {shape} {wdtype} "
                                         f"{what} not finite")
                if wdtype == "float32":
                    torch.testing.assert_close(
                        g, w, rtol=tol, atol=tol,
                        msg=f"slstm grad {shape} f32 {what}")
                    continue
                torch.testing.assert_close(
                    g, t64, rtol=tol, atol=tol,
                    msg=f"slstm grad {shape} bf16 {what} vs float64")
                rel = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
                if rel > tol:
                    raise AssertionError(f"slstm grad {shape} bf16 {what}: "
                                         f"norm error {rel:.3g} vs plain")
                errs[what] = rel
            gap = {(a, c): [(x - y).abs().max().item() for x, y in
                            zip(grads[a], grads[c])]
                   for a, c in (("trainable", "plain"),
                                ("trainable", "float64"),
                                ("plain", "float64"))}
            out[shape, wdtype] = max(gap["trainable", "plain"])
            extra = (f", norm error vs plain "
                     f"{max(errs.values(), default=0):.3g} (gate {tol:g})")
            log(f"  slstm_scan_trainable {shape} wh {wdtype}: outputs max "
                f"|trainable - plain| {fwd_err:.3g} (gate "
                f"{SLSTM_TOL[wdtype]:g}); grads max |trainable - plain| "
                f"{out[shape, wdtype]:.3g}"
                f"{f' (gate {tol:g})' if wdtype == 'float32' else extra}; "
                f"per gradient {names}: |trainable - float64| "
                f"{', '.join(f'{v:.3g}' for v in gap['trainable', 'float64'])}"
                f"{'' if wdtype == 'float32' else f' (gate {tol:g})'}, "
                f"|plain - float64| "
                f"{', '.join(f'{v:.3g}' for v in gap['plain', 'float64'])}")
    return out


def train_xlstm_full_width(np, torch, dev="cuda", cfg=None,
                           shape=TRAIN_XLSTM):
    """xlstm-1.3b at full width through the Trainer, with the slstm_scan
    launch count derived from the code; returns (numbers, launches)."""
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.models import model as M
    cfg = cfg or train_cfg("xlstm-1.3b")
    groups = M.topology(cfg).n_groups
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tr, _ = train_run(torch, cfg, shape, dev)
    K.slstm_scan.launches = 0
    tr.run()
    launches = K.slstm_scan.launches
    # each microbatch runs every sLSTM block forward once through the
    # kernel, and remat runs it again in the backward; the backward of
    # the recurrence itself is a plain recompute (no launch)
    want = shape["steps"] * shape["grad_accum"] * groups \
        * (2 if cfg.remat else 1)
    if launches != want:
        raise AssertionError(f"train xlstm: {launches} slstm_scan launches, "
                             f"want {want}")
    for h in tr.history:
        if not np.isfinite([h["loss"], h["grad_norm"]]).all():
            raise AssertionError(f"train xlstm: step {h['step']} not finite")
        log(f"  step {h['step']}: {h['dt'] * 1e3:.1f} ms, loss "
            f"{h['loss']:.4f}, grad_norm {h['grad_norm']:.4g}")
    ms = statistics.median(h["dt"] for h in tr.history[1:]) * 1e3
    # one microbatch's forward and backward apart, and the sLSTM
    # backward alone at the train shape
    params = tr.state["params"]
    named = list(params.parameters())
    bt = {k: v.to(dev) for k, v in tr.ds.batch_at(0).items()}
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    loss, _ = M.lm_loss(cfg, params, bt["inputs"], bt["labels"])
    sync()
    t1 = time.perf_counter()
    torch.autograd.grad(loss, named)
    sync()
    t2 = time.perf_counter()
    fwd, bwd = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    d, h = cfg.d_model, cfg.n_heads
    s, b = shape["seq"], shape["batch"] // shape["grad_accum"]
    gen = torch.Generator(device=dev).manual_seed(0)
    xg = torch.randn((s, b, h, 4 * d // h), generator=gen, device=dev)
    wh = (torch.randn((h, d // h, 4 * d // h), generator=gen, device=dev)
          * (d // h) ** -0.5).to(cfg.pdtype)
    st = [torch.zeros((b, h, d // h), device=dev) for _ in range(3)]
    st.append(torch.full((b, h, d // h), -1e30, device=dev))
    ins = [xg.requires_grad_(), wh.requires_grad_(), *st]
    for _ in range(2):          # the second, warm
        ys, _ = K.slstm_scan_trainable(*ins)
        sync()
        t0 = time.perf_counter()
        torch.autograd.grad(ys.sum(), ins[:2])
        sync()
        slstm_bwd = (time.perf_counter() - t0) * 1e3
    out = dict(ms=ms, tokens_per_s=shape["batch"] * s / ms * 1e3,
               fwd_ms=fwd, bwd_ms=bwd, slstm_bwd_ms=slstm_bwd,
               peak_bytes=torch.cuda.max_memory_allocated()
               if dev == "cuda" else 0)
    log(f"  {ms:.1f} ms a step, {out['tokens_per_s']:.0f} tokens/s; "
        f"slstm_scan launches {launches} = {shape['steps']} steps x "
        f"{shape['grad_accum']} x {groups} groups x "
        f"{2 if cfg.remat else 1}; one microbatch: forward {fwd:.1f} ms, "
        f"backward {bwd:.1f} ms (share {bwd / (fwd + bwd):.3f}); the sLSTM "
        f"recompute backward at ({s}, {b}, {h}, {d // h}) {slstm_bwd:.1f} ms "
        f"a group, {groups * slstm_bwd:.1f} ms of {groups} groups "
        f"({groups * slstm_bwd / (fwd + bwd):.3f} of the microbatch); peak "
        f"memory {out['peak_bytes']} B")
    return out, launches


def train_resume(np, torch, dev="cuda"):
    """Saved at step 3, resumed by a new Trainer to step 6: bitwise equal
    to an uninterrupted run, under deterministic algorithms (an op that
    refuses them raises, and the phase fails)."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.convert import train_state_to_tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = smoke_config(get_config("internlm2-1.8b"))
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True, route_scope="tick"))
    sh = TRAIN_RESUME
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=sh["seq"],
                     global_batch=sh["batch"])
    # the default warmup (20 steps) spans the run, so the learning rate
    # does not depend on total_steps
    tc = lambda total, d="": TrainerConfig(
        total_steps=total, ckpt_every=sh["save_at"], log_every=100,
        ckpt_dir=d)
    torch.use_deterministic_algorithms(True)
    try:
        whole = Trainer(cfg, tc(sh["steps"]), ds, seed=3, device=dev)
        whole.run()
        with tempfile.TemporaryDirectory() as d:
            Trainer(cfg, tc(sh["save_at"], d), ds, seed=3, device=dev).run()
            resumed = Trainer(cfg, tc(sh["steps"], d), ds, seed=3,
                              device=dev)
            if resumed.start_step != sh["save_at"]:
                raise AssertionError(f"resume started at "
                                     f"{resumed.start_step}")
            resumed.run()
    finally:
        torch.use_deterministic_algorithms(False)
    a = _leaves(train_state_to_tree(cfg, whole.state))
    b = _leaves(train_state_to_tree(cfg, resumed.state))
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("train resume: the resumed state differs from "
                             "the uninterrupted run's")
    if int(resumed.state["step"]) != sh["steps"]:
        raise AssertionError(f"train resume: step {resumed.state['step']}")
    losses = ", ".join(f"{h['loss']:.4f}" for h in whole.history)
    log(f"  smoke config, saved at step {sh['save_at']}, resumed to "
        f"{sh['steps']}: {len(a)} tensors bitwise equal to the "
        f"uninterrupted run (losses {losses}), deterministic algorithms on")


def train_mesh_bf16(torch, mesh, cfg=None, shape=TRAIN_MESH):
    """internlm2-1.8b uncut (or ``cfg``), bf16, TRAIN_DENSE's shape (or
    ``shape``), 2 Trainer steps on ``mesh``: the history, the metrics,
    the collectives and the switch launches of the steps, the peak
    memory, a digest of every leaf replicated over the data axes, and the
    shards' shapes."""
    import hashlib

    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import dp_axes
    cfg = cfg or train_cfg("internlm2-1.8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tr, rec = train_run(torch, cfg, shape, "cuda", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    zero_switch()
    C.reset_counts()
    t0 = time.time()
    tr.run()
    run_s = time.time() - t0
    counts, launches = dict(C.COUNTS), switch_launches()
    named = dict(tr.state["params"].named_parameters())
    dp = dp_axes(mesh)
    digests = {k: (C.spec_axes(mesh, p._pspec), hashlib.sha1(
        p.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy())
        .hexdigest()) for k, p in named.items()
        if not C._dp_dims(p._pspec, dp)}
    out = dict(history=tr.history, counts=counts, launches=launches,
               peak=torch.cuda.max_memory_allocated(), init_s=init_s,
               run_s=run_s, digests=digests,
               n_local=sum(p.numel() for p in named.values()),
               metrics=[{k: float(m[k]) for k in (
                   "lm_loss", "grad_norm", "invocation", "router_acc",
                   "tick_router_acc", "aux_loss", "lr") if k in m}
                   for m in rec.steps])
    shapes = {k: (tuple(p.shape), p.dtype) for k, p in named.items()}
    return out, shapes


def train_mesh_witness(np, torch, mesh):
    """The float32 witness at full widths cut to 2 layers: one
    ``loss_and_grads`` on the mesh and one on this rank's single card
    from the same draw, on the same batch.  Returns the loss of each,
    each rank's worst elementwise gradient gap (against its shards of
    the single device's gradient), the squared sums of the gaps and of
    the gradient over the blocks this rank holds first, both gradient
    norms and whether the tick labels agree."""
    from repro_torch.data.pipeline import SyntheticLM, local_batch
    from repro_torch.models import model as M
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    w = TRAIN_MESH_WITNESS
    cfg = train_cfg("internlm2-1.8b", n_layers=w["n_layers"],
                    param_dtype="float32", act_dtype="float32")
    ga = w["grad_accum"]
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=w["seq"],
                        global_batch=w["batch"], seed=1).batch_at(0)
    local = {k: v.cuda() for k, v in local_batch(batch, mesh, ga).items()}
    state = S.init_train_state(0, cfg, device="cuda", mesh=mesh)
    specs = {k: p._pspec for k, p in state["params"].named_parameters()}
    with S.train_mesh_context(mesh):
        loss_m, _, grads_m = S.loss_and_grads(cfg, state["params"], local,
                                              ga)
        labels_m = tick_labels(torch, cfg, state["params"], local["inputs"])
    _, norm_m = clip_by_global_norm(dict(grads_m), float("inf"), mesh=mesh,
                                    specs=specs)
    del state
    params = M.init_model(0, cfg, device="cuda").requires_grad_(True)
    full = {k: v.cuda() for k, v in batch.items()}
    loss_s, _, grads_s = S.loss_and_grads(cfg, params, full, ga)
    labels_s = tick_labels(torch, cfg, params, full["inputs"])
    norm_s = torch.sqrt(sum((g.double() ** 2).sum()
                            for g in grads_s.values()))
    worst, gap_sq, ref_sq = 0.0, 0.0, 0.0
    tol = w["grad_tol"]
    for k, g in grads_m.items():
        want = C.shard_tensor(mesh, grads_s[k], specs[k])
        gap = (g - want).abs()
        worst = max(worst, (gap / (tol + tol * want.abs())).max().item())
        # each block counted once: on the ranks at coordinate 0 of the
        # axes the spec does not shard
        axes = C.spec_axes(mesh, specs[k])
        if all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in axes):
            gap_sq += float((gap.double() ** 2).sum())
            ref_sq += float((want.double() ** 2).sum())
    mine = local_batch({"l": labels_s.reshape(w["batch"], -1).cpu()}, mesh,
                       ga)["l"]
    return dict(loss_mesh=float(loss_m), loss_single=float(loss_s),
                worst=worst, gap_sq=gap_sq, ref_sq=ref_sq,
                norm_mesh=float(norm_m), norm_single=float(norm_s),
                labels_equal=bool(torch.equal(labels_m.cpu().reshape(
                    mine.shape), mine)),
                classes=torch.bincount(labels_s.flatten().cpu(),
                                       minlength=cfg.approx.n_live + 1)
                .tolist())


def train_mesh_ef(np, torch, shapes):
    """``ef_int8_allreduce_tree`` on the card over a ("pod",) mesh of the
    world's ranks: the reference's quadratic with CUDA tensors, then one
    call over gradients shaped as this rank's full-width shards (bf16),
    timed, with its collectives and staged bytes beside those of the
    float32 all-reduce of the same leaves (in groups of 256 MiB)."""
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.optim.compression import (ef_int8_allreduce_tree,
                                               init_error_feedback)
    from repro_torch.sharding import collectives as C
    pod = HostMesh((torch.distributed.get_world_size(),), ("pod",))
    q = EF_QUADRATIC
    targets = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (pod.size("pod"), q["dim"])).astype(np.float32)).cuda()
    tgt = targets[pod.index("pod")]
    w_c = torch.zeros_like(tgt)
    w_e = torch.zeros_like(tgt)
    err = init_error_feedback({"g": w_c})
    t0 = time.time()
    for _ in range(q["steps"]):
        mean, err = ef_int8_allreduce_tree({"g": 2 * (w_c - tgt)}, err,
                                           "pod", pod)
        w_c = w_c - q["lr"] * mean["g"]
        w_e = w_e - q["lr"] * C.all_reduce_sum(2 * (w_e - tgt), "pod",
                                               pod) / pod.size("pod")
    opt = targets.mean(0)
    out = dict(err_compressed=float(torch.linalg.norm(w_c - opt)),
               err_exact=float(torch.linalg.norm(w_e - opt)),
               quad_s=time.time() - t0)
    gen = torch.Generator(device="cuda").manual_seed(pod.rank)
    grads = {k: (torch.randn(s, generator=gen, device="cuda") * 1e-3).to(dt)
             for k, (s, dt) in shapes.items()}
    err = init_error_feedback(grads)
    for name in ("int8", "float32"):
        torch.cuda.synchronize()
        C.reset_counts()
        t0 = time.perf_counter()
        if name == "int8":
            mean, err = ef_int8_allreduce_tree(grads, err, "pod", pod)
            finite = all(bool(torch.isfinite(m).all())
                         for m in mean.values())
            del mean
        else:
            group, size = [], 0
            for g in list(grads.values()) + [None]:
                if g is None or size + g.numel() * 4 > 256 * 2**20:
                    C.all_reduce_sum_many([x.float() for x in group], "pod",
                                          pod)
                    group, size = [], 0
                if g is not None:
                    group.append(g)
                    size += g.numel() * 4
        torch.cuda.synchronize()
        out[name] = dict(s=time.perf_counter() - t0, counts=dict(C.COUNTS))
    out["int8"]["finite"] = finite
    out["n_elems"] = sum(g.numel() for g in grads.values())
    out["n_leaves"] = len(grads)
    return out


def train_mesh_rank(rank, out_dir):
    """One rank of [train mesh full width]: the bf16 Trainer steps, the
    float32 witness, the int8 all-reduce; its payload to ``out_dir``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import HostMesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = HostMesh(TRAIN_MESH["shape"], ("data", "model"))
    out = {"coords": mesh.coords}
    t0 = time.time()
    out["bf16"], shapes = train_mesh_bf16(
        torch, mesh, train_cfg("internlm2-1.8b", n_layers=MESH_LAYERS))
    release(torch)
    out["witness"] = train_mesh_witness(np, torch, mesh)
    release(torch)
    out["ef"] = train_mesh_ef(np, torch, shapes)
    out["rank_s"] = time.time() - t0
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def train_mesh_full_width(np, torch):
    """[train mesh full width]: internlm2-1.8b cut to ``MESH_LAYERS``
    layers at its widths, bf16, TRAIN_DENSE's
    shape, 2 Trainer steps on a (2, 2) mesh of 4 ranks sharing the card
    over gloo and the exchange arena; the float32 witness; the int8
    error-feedback all-reduce on a ("pod",) mesh of the same ranks; then
    launch/train.py --mesh 2,2 as a subprocess.  Gates: every rank's
    history, metrics and replicated leaves bitwise equal, 0 switch
    launches, finite losses; the witness's loss within 1e-5 relative, its
    gradients within 1e-4 elementwise and in norm, equal tick labels of
    at least two classes; the quadratic's errors below the reference's
    bounds."""
    from repro_torch.launch.mesh import spawn_world
    sh = TRAIN_MESH
    ranks = sh["shape"][0] * sh["shape"][1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        spawn_world(train_mesh_rank, ranks, (tmp,), backend="gloo",
                    exchange_mib=sh["exchange_mib"])
        log(f"  {ranks} ranks on a {sh['shape']} mesh (gloo, one card, "
            f"{sh['exchange_mib']} MiB arena slots) in "
            f"{time.time() - t0:.1f} s")
        pay = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
               for r in range(ranks)]
    b0 = pay[0]["bf16"]
    for r, p in enumerate(pay[1:], 1):
        b = p["bf16"]
        if b["history"] != b0["history"] or b["metrics"] != b0["metrics"]:
            raise AssertionError(f"train mesh: rank {r}'s history or "
                                 "metrics differ from rank 0's")
        for k, (axes, digest) in b["digests"].items():
            same = all(p["coords"][a] == pay[0]["coords"][a] for a in axes)
            if same and digest != b0["digests"][k][1]:
                raise AssertionError(f"train mesh: rank {r}'s {k} differs "
                                     "from rank 0's")
    n_rep = sum(not axes for axes, _ in b0["digests"].values())
    for p in pay:
        if p["bf16"]["launches"]:
            raise AssertionError(f"train mesh: {p['bf16']['launches']} "
                                 "switch launches; the train path runs "
                                 "none")
    for h, m in zip(b0["history"], b0["metrics"]):
        if not all(np.isfinite([h["loss"], h["grad_norm"]])):
            raise AssertionError(f"train mesh: step {h['step']} not finite")
        log(f"  step {h['step']}: {h['dt'] * 1e3:.1f} ms (slowest rank), "
            f"loss {h['loss']:.4f}, " + ", ".join(
                f"{k} {v:.4g}" for k, v in m.items()))
    steps = len(b0["history"])
    ms = b0["history"][-1]["dt"] * 1e3
    tokens = sh["batch"] * sh["seq"]
    c = b0["counts"]
    log(f"  internlm2-1.8b, {MESH_LAYERS} of its 24 layers, bf16, remat, "
        f"{sh['batch']} x "
        f"{sh['seq']}, grad_accum {sh['grad_accum']}: {ms:.1f} ms a step "
        f"(step {steps}), {tokens / ms * 1e3:.0f} tokens/s; per step per "
        f"rank {c['all_gather'] / steps:.0f} all-gathers, "
        f"{c['all_reduce'] / steps:.0f} all-reduces, "
        f"{c['reduce_scatter'] / steps:.0f} reduce-scatters, "
        f"{c['staged'] / steps:.0f} host stagings of "
        f"{c['staged_bytes'] / steps / 2**30:.2f} GiB; 0 switch launches; "
        f"init {b0['init_s']:.1f} s, {steps} steps {b0['run_s']:.1f} s")
    log("  peak memory per rank: " + ", ".join(
        f"{p['bf16']['peak']} B ({p['bf16']['peak'] / 2**30:.2f} GiB)"
        for p in pay) + f"; {b0['n_local']} parameters a rank; "
        f"{len(b0['digests'])} leaves replicated over data ({n_rep} over "
        "every axis) bitwise equal where the ranks share their block")
    # the witness
    w, wt = pay[0]["witness"], TRAIN_MESH_WITNESS
    worst = max(p["witness"]["worst"] for p in pay)
    rel = math.sqrt(sum(p["witness"]["gap_sq"] for p in pay)
                    / max(sum(p["witness"]["ref_sq"] for p in pay), 1e-300))
    loss_gap = abs(w["loss_mesh"] - w["loss_single"])
    norm_gap = abs(w["norm_mesh"] - w["norm_single"]) / w["norm_single"]
    if not (loss_gap <= wt["loss_tol"] * (1 + abs(w["loss_single"]))
            and worst <= 1.0 and rel <= wt["grad_tol"]
            and all(p["witness"]["labels_equal"] for p in pay)
            and sum(n > 0 for n in w["classes"]) >= 2):
        raise AssertionError(f"train mesh float32 witness: loss gap "
                             f"{loss_gap:.3g}, worst gradient gap "
                             f"{worst:.3g} of the gate, relative gradient "
                             f"gap {rel:.3g}, labels equal "
                             f"{[p['witness']['labels_equal'] for p in pay]}"
                             f", classes {w['classes']}")
    log(f"  float32 witness ({wt['n_layers']} layers at full width, "
        f"{wt['batch']} x {wt['seq']}, grad_accum {wt['grad_accum']}): loss "
        f"{w['loss_mesh']:.7f} (mesh) {w['loss_single']:.7f} (one card), "
        f"gap {loss_gap:.3g}; gradients within {worst:.3g} of the 1e-4 "
        f"elementwise gate, ||mesh - single|| / ||single|| {rel:.3g}; "
        f"grad norm {w['norm_mesh']:.6g} vs {w['norm_single']:.6g} "
        f"(relative {norm_gap:.3g}); tick labels equal, by class "
        f"{w['classes']}")
    # the int8 error-feedback all-reduce
    ef = pay[0]["ef"]
    if any(p["ef"]["err_compressed"] != ef["err_compressed"] for p in pay) \
            or not (ef["err_compressed"] < 1e-2 and ef["err_exact"] < 1e-3
                    and ef["int8"]["finite"]):
        raise AssertionError(f"train mesh ef int8: {ef}")
    i8, f32 = ef["int8"], ef["float32"]
    log(f"  ef_int8_allreduce_tree on a ('pod',) mesh of {ranks}: the "
        f"quadratic over {EF_QUADRATIC['steps']} steps err_compressed "
        f"{ef['err_compressed']:.3g} (< 1e-2), err_exact "
        f"{ef['err_exact']:.3g} (< 1e-3) in {ef['quad_s']:.1f} s; one call "
        f"over a rank's {ef['n_leaves']} full-width gradient shards "
        f"({ef['n_elems']} elements, bf16): {i8['s'] * 1e3:.1f} ms, "
        f"{i8['counts']['all_gather']} all-gathers, "
        f"{i8['counts']['staged_bytes']} staged bytes; the float32 "
        f"all-reduce of the same leaves: {f32['s'] * 1e3:.1f} ms, "
        f"{f32['counts']['all_reduce']} all-reduces, "
        f"{f32['counts']['staged_bytes']} staged bytes")
    log(f"  rank 0's work {pay[0]['rank_s']:.1f} s")
    t0 = time.time()
    src = str(Path(__file__).resolve().parent / "src")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *TRAIN_MESH_LAUNCHER], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=src))
    if r.returncode:
        raise AssertionError(f"launch/train.py on a mesh failed:\n"
                             f"{r.stderr[-3000:]}")
    for line in r.stdout.strip().splitlines():
        log(f"  launcher: {line}")
    log(f"  launch/train.py {' '.join(TRAIN_MESH_LAUNCHER)}: "
        f"{time.time() - t0:.1f} s")


def train_moe(np, torch):
    """[train moe]: moonshot-v1-16b-a3b at its widths cut to 2 layers,
    remat: one float32 ``loss_and_grads`` on the card against the CPU from
    the same parameters at a small batch (gradients within 1e-4, every MoE
    application's ``gate_idx`` and ``keep`` equal on both), then 2 bf16
    Trainer steps timed: ms/step, tokens/s, peak memory."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.runtime import steps
    full = get_config(MOE)
    cut = dict(n_layers=TRAIN_MOE["n_layers"], remat=True)
    cfg = dataclasses.replace(full, param_dtype="float32",
                              act_dtype="float32", **cut)
    t0 = time.time()
    card = M.init_model(0, cfg, device="cuda").requires_grad_(True)
    cpu = M.Model(cfg, torch.device("cpu"))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    cpu.requires_grad_(True)
    n_params = sum(p.numel() for p in card.parameters())
    sh = TRAIN_MOE["parity"]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (sh["batch"], sh["seq"] + 1)).astype(np.int32))
    out = {}
    for name, params, d in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        t = toks.to(d)
        batch = {"inputs": t[:, :-1], "labels": t[:, 1:]}
        with MoECapture() as cap:
            loss, _, g = steps.loss_and_grads(cfg, params, batch, 1)
        with torch.no_grad():
            routes = [moe.route(cfg, p.router, x.reshape(-1, x.shape[-1]))
                      for p, x in cap.calls]
        out[name] = (float(loss), {k: v.cpu() for k, v in g.items()},
                     [(r.gate_idx.cpu(), r.keep.cpu()) for r in routes])
        del g, cap
    (cl, cg, cr), (gl, gg, gr) = out["cpu"], out["card"]
    if len(cr) != len(gr) or not all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(cr, gr)):
        raise AssertionError("train moe: the card's routing (gate_idx, "
                             "keep) differs from the CPU's")
    worst = 0.0
    for k in cg:
        torch.testing.assert_close(gg[k], cg[k], rtol=0, atol=1e-4,
                                   msg=f"train moe grad {k}")
        worst = max(worst, (gg[k] - cg[k]).abs().max().item())
    drops = sum(int((~r[1]).sum()) for r in cr)
    log(f"  {MOE} cut to {cut['n_layers']} of its {full.n_layers} layers "
        f"at its widths ({n_params} parameters), remat: float32 "
        f"{sh['batch']} x {sh['seq']}: loss {cl:.6f} (CPU) {gl:.6f} (card), "
        f"max |gradient difference| {worst:.3g} (gate 1e-4), gate_idx and "
        f"keep equal on both over {len(cr)} MoE applications ({drops} "
        f"choices dropped by capacity); {time.time() - t0:.1f} s")
    del card, cpu, out, cg, gg
    release(torch)
    cfg16 = dataclasses.replace(full, **cut)
    ts = TRAIN_MOE["timed"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    tr, rec = train_run(torch, cfg16, ts, "cuda")
    init_s = time.time() - t0
    zero_switch()
    tr.run()
    if switch_launches():
        raise AssertionError(f"train moe: {switch_launches()} switch "
                             "launches")
    for h, m in zip(tr.history, rec.steps):
        if not all(np.isfinite([h["loss"], h["grad_norm"]])):
            raise AssertionError(f"train moe: step {h['step']} not finite")
        log(f"  step {h['step']}: {h['dt'] * 1e3:.1f} ms, loss "
            f"{h['loss']:.4f}, grad_norm {h['grad_norm']:.4g}, aux_loss "
            f"{float(m['aux_loss']):.4g}")
    ms = tr.history[-1]["dt"] * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"  bf16, cut to {cut['n_layers']} of {full.n_layers} layers, "
        f"remat, {ts['batch']} x {ts['seq']}, grad_accum {ts['grad_accum']}"
        f": {ms:.1f} ms a step (step {len(tr.history)}), "
        f"{ts['batch'] * ts['seq'] / ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak} B ({peak / 2**30:.2f} GiB), init {init_s:.1f} s; 0 switch "
        "launches")


def train_example_twin(torch):
    """examples/train_lm_mcma_torch.py at its smoke preset on the card."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / \
        "train_lm_mcma_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_mcma_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.time()
    out = mod.main(["--preset", "smoke"])
    if not (math.isfinite(out["final_loss"])
            and 0.0 <= out["invocation"] <= 1.0):
        raise AssertionError(f"train example twin: {out}")
    log(f"  examples/train_lm_mcma_torch.py --preset smoke: {out['steps']} "
        f"steps, loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}, "
        f"invocation {out['invocation']:.3f}, {time.time() - t0:.1f} s")


def paper_stacks(m):
    """The Bessel example twin's ``switch_stacks``: layers 0 and 1 of each
    of ``m``'s approximators, stacked as the weight switch's (w1, b1, w2,
    b2)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" \
        / "approx_bessel_torch.py"
    spec = importlib.util.spec_from_file_location("approx_bessel_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example.switch_stacks(m)


def paper_switch(torch, m, xte, label):
    """The paper runtime's weight switch: the test rows MCMA's classifier
    dispatches, each through ``ops.switched_apply`` (the switched_mlp
    kernel) under its approximator's layers 0 and 1.  Returns (the
    dispatched rows, their classes, the stacks, the kernel's output)."""
    from repro_torch.kernels import ops
    cls = m.classify(xte)
    disp = cls < m.n_approx
    xd, cd = xte[disp].contiguous(), cls[disp].contiguous()
    if xd.shape[0] == 0:
        raise AssertionError(f"{label}: the classifier dispatched no row")
    w = paper_stacks(m)
    return xd, cd, w, ops.switched_apply(xd, cd, *w,
                                         block_t=PAPER["block_t"])


def paper_switch_vs_plain(torch, xd, cd, w, flush, label):
    """The switched_mlp kernel against switched_mlp_plain on the paper
    runtime's operands (these launches are comparisons, not the path's);
    with ``flush`` also timed (plain, kernel, kernel, plain) with the
    bound of the dispatch at the approximators' own widths
    (``switch_bound``), the same count over the 128-padded operands
    beside it.  Returns the numbers."""
    from repro_torch.kernels import ops, switched_mlp
    blk = PAPER["block_t"]
    xp, _, tile_cls, weights, _, _ = ops.kernel_operands(xd, cd, *w,
                                                         block_t=blk)
    kern = lambda: switched_mlp.switched_mlp(xp, tile_cls, *weights,  # noqa
                                             block_t=blk)
    plain = lambda: switched_mlp.switched_mlp_plain(  # noqa: E731
        xp, tile_cls, *weights, block_t=blk)
    y, y_plain = kern(), plain()
    torch.testing.assert_close(y, y_plain, rtol=TOL["float32"],
                               atol=TOL["float32"],
                               msg=f"{label}: switched_mlp vs plain")
    out = dict(rows=xd.shape[0], t_pad=xp.shape[0],
               max_abs_err=(y - y_plain).abs().max().item())
    if flush is None:
        return out
    b_ms, b_by, n_bytes, flops = switch_bound(torch, "float32", xd, cd, w)
    pad_ms, pad_by, pad_bytes, pad_flops = switch_bound(
        torch, "float32", xp, tile_cls.repeat_interleave(blk), weights)
    ms, plain_ms, (p1, k1, k2, p2) = timed_pair(torch, kern, plain, flush)
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               padded_bound_ms=pad_ms)
    dims = " -> ".join(str(d) for d in (*w[0].shape[1:], w[2].shape[2]))
    pad = " -> ".join(str(d) for d in (*weights[0].shape[1:],
                                       weights[2].shape[2]))
    log(f"  switched_mlp float32 {label} ({xd.shape[0]} rows, {dims}; "
        f"t_pad={xp.shape[0]}, {pad} padded): kernel {k1:.4f}/{k2:.4f} ms, "
        f"plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.6f} ms ({b_by}: "
        f"{n_bytes} B, {flops} FLOP; {ms / b_ms:.0f}x), over the padded "
        f"operands {pad_ms:.5f} ms ({pad_by}: {pad_bytes} B, {pad_flops} "
        f"FLOP), max |kernel-plain| {out['max_abs_err']:.3g}")
    return out


def paper_launch_gate(run):
    """A paper run sends its dispatched rows through one switched_mlp
    launch (the methods themselves train with plain torch)."""
    if run["launches"] != 1:
        raise AssertionError(f"{run['run']}: switched_mlp launched "
                             f"{run['launches']} times, not once")


def paper_methods(torch, app, data):
    """The methods of benchmarks/bench_paper.run_app that the card runs
    (one-pass and both MCMA schemes; iterative and MCCA would take the
    phase past its 150 s, PERF.md §4, and the CPU tests hold them) at the
    paper's settings, each timed (host clock, ended by its metrics'
    reads) with its train_mlp calls, and the Fig. 8 cost normalisation
    against one-pass.  Returns ({method: model}, {method: Metrics},
    {method: CostReport})."""
    from repro_torch.core import npu_model, train_mcma, train_one_pass
    from repro_torch.core.mlp import train_mlp
    xtr, ytr, xte, yte = data
    p, n = PAPER, PAPER["n_approx"]
    kw = dict(epochs=p["epochs"], lr=p["lr"])
    gen = lambda i: torch.Generator(device="cuda").manual_seed(  # noqa
        p["seed"] + i)
    runs = {
        # bench_paper.run_app's keys: ks[0] for one-pass, ks[3] for both
        # MCMA schemes
        "one-pass": lambda: train_one_pass(app, gen(0), xtr, ytr, **kw),
        "mcma-complementary": lambda: train_mcma(
            app, gen(3), xtr, ytr, n_approx=n, scheme="complementary",
            iters=p["iters"], **kw),
        "mcma-competitive": lambda: train_mcma(
            app, gen(3), xtr, ytr, n_approx=n, scheme="competitive",
            iters=p["iters"], **kw),
    }
    models, rows, costs, timing = {}, {}, {}, {}
    for name, run in runs.items():
        calls = train_mlp.calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[name] = run()
        rows[name] = models[name].evaluate(xte, yte)
        timing[name] = (time.perf_counter() - t0, train_mlp.calls - calls)
    for name, met in rows.items():
        multi = name.startswith("mcma")
        costs[name] = npu_model.cost(
            app, met.invocation, n_approx=n if multi else 1, multiclass=multi,
            switch_rate=p["switch_rate"] if multi else 0.0)
    base = costs["one-pass"]
    for name, met in rows.items():
        s, calls = timing[name]
        log(f"  {app.name} {name:18s} inv={met.invocation:.4f} "
            f"err/bound={met.err_norm:.4f} recall={met.recall:.4f} "
            f"false_pos={met.false_pos:.4f} "
            f"speedup={costs[name].speedup_vs(base):.4f} "
            f"energy={costs[name].energy_reduction_vs(base):.4f} | "
            f"{s:.2f} s, {calls} train_mlp calls, "
            f"{calls * p['epochs'] / s:.0f} epochs/s")
    return models, rows, costs


def paper_gates(torch, app, models, rows, costs, xte):
    """Every metric finite and in its range, the headline (MCMA-competitive
    invocation >= one-pass's - 0.02), ``history`` of ``iters`` entries and
    ``classify`` in [0, n]."""
    base = costs["one-pass"]
    for name, met in rows.items():
        shares = [met.invocation, met.true_invocation, met.recall,
                  met.false_neg, met.false_pos, *met.dispatch_frac]
        ratios = [met.err_norm, costs[name].speedup_vs(base),
                  costs[name].energy_reduction_vs(base)]
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in shares) \
                or not all(math.isfinite(v) and v >= 0.0 for v in ratios):
            raise AssertionError(f"{app.name} {name}: a metric is out of "
                                 f"range: {met}, cost {costs[name]}")
    inv_mcma = rows["mcma-competitive"].invocation
    inv_op = rows["one-pass"].invocation
    if inv_mcma < inv_op - 0.02:
        raise AssertionError(f"{app.name}: MCMA-competitive invocation "
                             f"{inv_mcma} < one-pass {inv_op} - 0.02")
    for name, m in models.items():
        if not name.startswith("mcma"):
            continue
        cls = m.classify(xte)
        if len(m.history) != PAPER["iters"] or not all(
                0.0 <= h <= 1.0 for h in m.history) \
                or int(cls.min()) < 0 or int(cls.max()) > m.n_approx:
            raise AssertionError(f"{app.name} {name}: history {m.history}, "
                                 f"classes {int(cls.min())}..{int(cls.max())}")
        log(f"  {app.name} {name} invocation by iteration: "
            + " ".join(f"{h:.4f}" for h in m.history))


def paper_card_vs_cpu(np, torch):
    """train_mlp on the card and on the CPU from one init (made on the
    CPU), on 4,096 blackscholes rows with per-sample weights, for 1 and 10
    epochs, both losses: parameters within 1e-4.  Then one train_mcma
    iteration (competitive, 10 epochs) on each from the same CPU
    generator: its labels and the classifier's classes counted where they
    differ, at most 0.5 % of the rows."""
    from repro_torch.apps import get_app, make_dataset
    from repro_torch.core import init_mlp, train_mcma, train_mlp
    from repro_torch.core.mcma import _labels_competitive
    c = PAPER_PARITY
    app = get_app("blackscholes")
    x, y, _, _ = make_dataset(app, torch.Generator().manual_seed(11),
                              c["rows"], 16)
    w = torch.from_numpy(np.random.default_rng(11).random(c["rows"])
                         .astype(np.float32))
    labels = (y[:, 0] > y[:, 0].median()).to(torch.int32)
    for loss, spec, target in (("mse", app.approx_spec, y),
                               ("xent", app.cls_spec(2), labels)):
        p0 = init_mlp(torch.Generator().manual_seed(12), spec)
        for epochs in c["epochs"]:
            got = {dev: train_mlp(p0, x.to(dev), target.to(dev), spec,
                                  weights=w.to(dev), loss=loss,
                                  epochs=epochs, lr=PAPER["lr"])
                   for dev in ("cpu", "cuda")}
            err = max((a[k].cpu() - b[k]).abs().max().item()
                      for a, b in zip(got["cuda"], got["cpu"])
                      for k in ("w", "b"))
            log(f"  train_mlp {loss} {epochs} epoch(s), {c['rows']} rows: "
                f"card within {err:.3g} of the CPU")
            if err > c["tol"]:
                raise AssertionError(f"train_mlp {loss} {epochs}: card "
                                     f"{err} from the CPU > {c['tol']}")
    out = {}
    for dev in ("cpu", "cuda"):
        xd, yd = x.to(dev), y.to(dev)
        m = train_mcma(app, torch.Generator().manual_seed(13), xd, yd,
                       n_approx=3, scheme="competitive", iters=1,
                       epochs=c["mcma_epochs"], lr=PAPER["lr"])
        lab = _labels_competitive(m.approximator_errors(xd, yd),
                                  app.error_bound)
        out[dev] = (lab.cpu(), m.classify(xd).cpu(), m.history)
    n_lab = int((out["cpu"][0] != out["cuda"][0]).sum())
    n_cls = int((out["cpu"][1] != out["cuda"][1]).sum())
    by_class = torch.bincount(out["cpu"][0], minlength=4).tolist()
    log(f"  train_mcma 1 iteration ({c['mcma_epochs']} epochs): labels "
        f"differ on {n_lab}, classes on {n_cls} of {c['rows']} rows "
        f"(CPU labels by class {by_class}); invocation card "
        f"{out['cuda'][2]} CPU {out['cpu'][2]}")
    limit = c["max_label_diff"] * c["rows"]
    if n_lab > limit or n_cls > limit:
        raise AssertionError(f"train_mcma: {n_lab} labels / {n_cls} "
                             f"classes differ between card and CPU > "
                             f"{limit}")


def paper_pipeline_full_width(np, torch):
    """[paper pipeline full width]: the reference's paper settings on the
    card (the Fig. 6 sizes, the paper topologies, n 3, 5 iterations, lr
    3e-3; ``PAPER["epochs"]`` of the paper's 1500), float32.  (1)
    blackscholes: one-pass and both MCMA schemes of bench_paper.run_app
    with the Fig. 8 costs, gated, then the dispatched test rows through the switched_mlp kernel under the
    three 6->8->1 approximators (two layers: the kernel computes each
    whole), within
    3e-5 of apply_mlp under each row's approximator and of
    switched_mlp_plain; (2) bessel: competitive MCMA, then the example
    twin's kernel step (layers 0 and 1 of each 2->4->4->1) within 3e-5 of
    ref.switched_mlp_ref and of the plain version, timed; (3) the card
    against the CPU.  Returns the kernels line's runs for switched_mlp."""
    from repro_torch.apps import get_app, make_dataset
    from repro_torch.core import apply_mlp, train_mcma
    from repro_torch.kernels import ref
    from repro_torch.kernels.switched_mlp import switched_mlp
    tol = dict(rtol=TOL["float32"], atol=TOL["float32"])
    by_run = []

    app = get_app("blackscholes")
    data = make_dataset(app, torch.Generator(device="cuda").manual_seed(
        PAPER["seed"]), app.n_train, app.n_test)
    log(f"  blackscholes: {app.n_train} train / {app.n_test} test rows, "
        f"{app.approx_topo} approximators, {app.cls_topo} classifier")
    switched_mlp.launches = 0
    t0 = time.perf_counter()
    models, rows, costs = paper_methods(torch, app, data)
    xd, cd, w, got = paper_switch(torch, models["mcma-competitive"],
                                  data[2], "blackscholes")
    torch.cuda.synchronize()
    by_run.append(dict(run="paper blackscholes", rows=xd.shape[0],
                       launches=switched_mlp.launches))
    paper_launch_gate(by_run[-1])
    log(f"  blackscholes run {time.perf_counter() - t0:.1f} s")
    paper_gates(torch, app, models, rows, costs, data[2])
    m = models["mcma-competitive"]
    want = torch.zeros_like(got)
    for i, a in enumerate(m.a_params):
        want[cd == i] = apply_mlp(a, xd[cd == i], app.approx_spec)
    torch.testing.assert_close(got, want, **tol,
                               msg="blackscholes switch vs apply_mlp")
    sw = paper_switch_vs_plain(torch, xd, cd, w, None, "blackscholes")
    log(f"  blackscholes switch: {xd.shape[0]} dispatched rows, "
        f"{by_run[-1]['launches']} launch; kernel within "
        f"{(got - want).abs().max().item():.3g} of apply_mlp, "
        f"{sw['max_abs_err']:.3g} of switched_mlp_plain")
    del models, data

    app = get_app("bessel")
    xtr, ytr, xte, yte = make_dataset(
        app, torch.Generator(device="cuda").manual_seed(PAPER["seed"] + 1),
        app.n_train, app.n_test)
    switched_mlp.launches = 0
    t0 = time.perf_counter()
    m = train_mcma(app, torch.Generator(device="cuda").manual_seed(
        PAPER["seed"] + 11), xtr, ytr, n_approx=PAPER["n_approx"],
        scheme="competitive", iters=PAPER["iters"], epochs=PAPER["epochs"],
        lr=PAPER["lr"])
    met = m.evaluate(xte, yte)
    xd, cd, w, got = paper_switch(torch, m, xte, "bessel")
    torch.cuda.synchronize()
    by_run.append(dict(run="paper bessel", rows=xd.shape[0],
                       launches=switched_mlp.launches))
    paper_launch_gate(by_run[-1])
    log(f"  bessel competitive ({time.perf_counter() - t0:.1f} s): "
        f"{met.row()}; invocation by iteration "
        + " ".join(f"{h:.4f}" for h in m.history)
        + "; territory shares " + " ".join(f"{f:.4f}"
                                           for f in met.dispatch_frac))
    shares = [met.invocation, met.recall, met.false_pos, *met.dispatch_frac]
    if not all(math.isfinite(v) and 0 <= v <= 1 for v in shares) \
            or len(m.history) != PAPER["iters"]:
        raise AssertionError(f"bessel: {met}, history {m.history}")
    want = ref.switched_mlp_ref(xd, cd, *w)
    torch.testing.assert_close(got, want, **tol,
                               msg="bessel switch vs switched_mlp_ref")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    sw = paper_switch_vs_plain(torch, xd, cd, w, flush, "bessel")
    del flush
    by_run[-1].update(ms=sw["ms"], plain_ms=sw["plain_ms"],
                      bound_ms=sw["bound_ms"], bound_by=sw["bound_by"],
                      padded_bound_ms=sw["padded_bound_ms"],
                      max_abs_err=max(sw["max_abs_err"],
                                      (got - want).abs().max().item()))
    log(f"  bessel switch: {xd.shape[0]} dispatched rows, "
        f"{by_run[-1]['launches']} launch; kernel "
        f"within {(got - want).abs().max().item():.3g} of "
        f"switched_mlp_ref, {sw['max_abs_err']:.3g} of switched_mlp_plain")
    del xtr, ytr, xte, yte, m
    torch.cuda.empty_cache()

    paper_card_vs_cpu(np, torch)
    return by_run


class SwitchCapture:
    """Records the operands of the first ``execute_dispatch`` call against
    prepadded stacks (a tick plan's) that the serving path makes: its
    rows, their classes with the pseudo-class last, and the logical
    slices of the stacks; through every module binding of it."""

    def __enter__(self):
        from repro_torch.models import approx_ffn
        from repro_torch.runtime import dispatch
        self.mods, self.real, self.args = (approx_ffn, dispatch), \
            dispatch.execute_dispatch, None

        def capture(plan, x, exact_fn, w1, b1, w2, b2, **kw):
            if self.args is None and kw.get("weights_prepadded"):
                d, dh = x.shape[1], w2.shape[1]
                self.args = (x.detach().clone(), plan.eff.clone(),
                             [w1[:, :d, :dh].clone(), b1[:, :dh].clone(),
                              w2[:, :dh, :d].clone(), b2[:, :d].clone()])
            return self.real(plan, x, exact_fn, w1, b1, w2, b2, **kw)
        for m in self.mods:
            m.execute_dispatch = capture
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.execute_dispatch = self.real


def approx_cfg(arch, **over):
    """``arch`` at full width with the ApproxFFN on (the config's 3
    approximators of 256, block_t 128), ``over`` replacing fields of its
    ApproxConfig."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True, **over))


def init_logged(torch, cfg, what=""):
    from repro_torch.models import model as M
    t0 = time.time()
    params = M.init_model(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    log(f"  init {cfg.name}{what}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd} (kv {cfg.n_kv_heads}), d_ff="
        f"{cfg.d_ff}, vocab={cfg.vocab}, {cfg.param_dtype}, {n} "
        f"parameters in {time.time() - t0:.1f} s")
    return params


def serve_hybrid(np, torch):
    """Full-width zamba2-2.7b with MCMA at tick scope through DecodeServer
    on both kernel backends (the requested prefill chunk falls back to
    token by token); the first tick's switch inputs against the plain
    twins at d 2560; the float32 forward against prefill + token-by-token
    decode.  Returns the runs' launch records."""
    from repro_torch.kernels import fused_dispatch, switched_mlp
    from repro_torch.models import model as M
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = approx_cfg(HYBRID, route_scope="tick")
    topo = M.topology(cfg)
    params = init_logged(torch, cfg, f" ({topo.n_groups} groups of "
                                     f"{topo.per_group} Mamba2 + the shared "
                                     "block)")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, SERVE["prompt_len"])
               .astype(np.int32) for _ in range(SERVE["n_requests"])]
    kernels = {"pallas": switched_mlp.switched_mlp,
               "pallas_fused": fused_dispatch.switched_mlp_fused}
    results = {}
    for backend in kernels:
        srv = DecodeServer(cfg, params, options=ServeOptions(
            batch=SERVE["batch"], max_len=SERVE["max_len"],
            use_mcma_dispatch=True, backend=backend, route_scope="tick",
            prefill_chunk=SCHED["prefill_chunk"]))
        if srv.prefill_chunk != 0:
            raise AssertionError("hybrid: the server chunks prompts")
        reqs = [Request(rid=i, prompt=p, max_new=SERVE["max_new"])
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        with SwitchCapture() as cap:
            t0 = time.time()
            stats = srv.run_until_drained()
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = {b: k.launches for b, k in kernels.items()}
        if not all(r.done and not r.aborted for r in reqs):
            raise AssertionError(f"hybrid {backend}: server did not drain")
        want = topo.n_groups * stats["ticks"]
        if launches[backend] != want or sum(launches.values()) != want:
            raise AssertionError(f"hybrid {backend}: launches {launches}, "
                                 f"want {want} of {backend} alone")
        n_tok = sum(len(r.out) for r in reqs)
        results[backend] = dict(tokens=[r.out for r in reqs],
                                launches=launches[backend],
                                ticks=stats["ticks"], first=cap.args)
        log(f"  serve {backend}: {stats['ticks']} decode ticks "
            f"({stats['prefill_ticks']} prefill), {n_tok} tokens, "
            f"{wall * 1e3 / stats['ticks']:.2f} ms/tick, "
            f"{n_tok / wall:.1f} tokens/s, invocation rate "
            f"{stats['invocation_rate']:.4f}, launches {launches[backend]} = "
            f"{topo.n_groups} x {stats['ticks']}, kv_bytes_resident "
            f"{stats['kv_bytes_resident']}, peak memory "
            f"{torch.cuda.max_memory_allocated()} B")
        del srv
    if results["pallas"]["tokens"] != results["pallas_fused"]["tokens"]:
        raise AssertionError("hybrid: greedy tokens differ between pallas "
                             "and pallas_fused")
    log("  greedy tokens equal across pallas and pallas_fused")
    x, cls, w = results["pallas"]["first"]
    time_switch_case(np, torch, None, x, cls, w, cfg.approx.block_t,
                     "bfloat16", f"{cfg.name} first tick d {cfg.d_model}",
                     timed=False)
    smoke_reference_hybrid(np, torch)

    hybrid_witness(np, torch, cfg, params, rng)
    return {b: dict(run=f"{HYBRID} serve {b}", ticks=r["ticks"],
                    launches=r["launches"]) for b, r in results.items()}


def hybrid_witness(np, torch, cfg, params, rng):
    """The float32 witness of the hybrid's decode path at full width and
    depth (the weights upcast in place; they fit the card, no depth
    cut).  End to end, forward over 256 tokens against prefill(128) + 16
    decode steps is printed beside the forward's own noise under a batch
    change (row 0 alone against the batch of 2): at a random init the
    54-layer float32 stack amplifies rounding to O(1) on the logits, so
    that gap is not gated.  Gated within 2e-3, each block teacher-forced:
    every Mamba2 block and every application of the shared block is fed
    the full forward's own inputs to it, and its chunked output at
    positions 128..143 is held to prefill(128) + one-token steps (the
    Mamba2 state update; the shared block's KV cache at the group's
    positions)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    params.float()
    wb, ws, at, nd = (HYBRID_WITNESS[k] for k in
                      ("batch", "seq", "at", "decode"))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (wb, ws))
                            .astype(np.int32)).cuda()
    with torch.no_grad():
        full, _, _, _ = M.forward(cfg32, params, toks)
        row0, _, _, _ = M.forward(cfg32, params, toks[:1])
        _, cache, _, _ = M.forward(cfg32, params, toks[:, :at],
                                   collect_cache=True)
        cache = M.pad_cache(cfg32, cache, ws)
        e2e = []
        for i in range(nd):
            got, cache = M.decode(cfg32, params, cache,
                                  toks[:, at + i:at + i + 1], serve=False)
            e2e.append((got - full[:, at + i]).abs().max().item())
        if cache["pos"].tolist() != [at + nd] * wb:
            raise AssertionError(f"hybrid witness pos "
                                 f"{cache['pos'].tolist()}")
        noise = (row0[0] - full[0]).abs().max().item()
        log(f"  float32 end to end, all {cfg.n_layers} layers: forward({ws}) "
            f"at {at}..{at + nd - 1} vs prefill({at}) + {nd} decode steps, "
            f"max |diff| {max(e2e):.4g} (per step "
            f"{', '.join(f'{g:.3g}' for g in e2e)}); the forward's own "
            f"batch-change noise {noise:.4g}; logits span "
            f"{full.min().item():.3g}..{full.max().item():.3g} (not gated)")
        gaps = {"mamba": 0.0, "shared": 0.0}
        x = L.embed_fwd(cfg32, params.embed, toks)
        positions = torch.arange(ws, device=x.device)[None, :]
        for g, mblks in enumerate(params.mamba):
            for blk in mblks:
                want, _ = M._mamba_block(cfg32, blk, x, None)
                _, st = M._mamba_block(cfg32, blk, x[:, :at], None)
                for i in range(nd):
                    got, st = M._mamba_block(cfg32, blk,
                                             x[:, at + i:at + i + 1], st)
                    gaps["mamba"] = max(gaps["mamba"], witness_close(
                        torch, got[:, 0], want[:, at + i],
                        f"mamba {g} step {i}"))
                x = want
            want, _, _, _ = M._dense_block(cfg32, params.shared, x,
                                           positions, None)
            _, kv, _, _ = M._dense_block(cfg32, params.shared, x[:, :at],
                                         positions[:, :at], None)
            lc = M.pad_cache(cfg32, {"k": kv["k"][None], "v": kv["v"][None],
                                     "pos": cache["pos"] * 0 + at}, ws)
            lc = M._layer_cache(lc, 0)
            for i in range(nd):
                got, lc, _, _ = M._dense_block(
                    cfg32, params.shared, x[:, at + i:at + i + 1],
                    lc["pos"][:, None], lc)
                gaps["shared"] = max(gaps["shared"], witness_close(
                    torch, got[:, 0], want[:, at + i],
                    f"shared block, group {g}, step {i}"))
            x = want
    log(f"  float32 witness, each of the {cfg.n_layers} Mamba2 blocks and "
        f"{len(params.mamba)} shared-block applications fed the forward's "
        f"inputs: prefill({at}) + {nd} steps vs forward({ws}) within 2e-3, "
        f"max |diff| Mamba2 {gaps['mamba']:.4g}, shared {gaps['shared']:.4g}")


def witness_close(torch, got, want, what):
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3,
                               msg=f"hybrid witness: {what}")
    return (got - want).abs().max().item()


def smoke_reference_hybrid(np, torch):
    """The float32 zamba2 smoke config with MCMA at tick scope on the card
    (both kernel backends) against the same parameters on the CPU (the
    plain versions, the "xla" oracle): a prefill of 32 tokens, then 8
    decode ticks with two idle slots; logits within 1e-4, greedy tokens
    equal, the backends bitwise equal."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    cfg = smoke_config(get_config(HYBRID))
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=True, route_scope="tick"))
    params = M.init_model(0, cfg, device="cuda")
    cpu_params = copy.deepcopy(params).cpu()
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (8, 32)).astype(np.int32))
    mask = torch.tensor([True] * 6 + [False] * 2)
    runs = {}
    for dev, backend in (("cpu", "xla"), ("cuda", "pallas"),
                         ("cuda", "pallas_fused")):
        p = cpu_params if dev == "cpu" else params
        with torch.no_grad():
            lg, cache, _, _ = M.forward(cfg, p, toks.to(dev),
                                        collect_cache=True)
        cache = M.pad_cache(cfg, cache, 48)
        lg = lg[:, -1]
        step = steps.make_decode_step(cfg, use_mcma_dispatch=True,
                                      backend=backend)
        out = [lg.float().cpu()]
        for _ in range(8):
            nxt = lg.argmax(-1).to(torch.int32)[:, None]
            lg, cache = step(p, cache, nxt, mask.to(dev))
            out.append(lg.float().cpu())
        runs[dev, backend] = torch.stack(out)
    ref = runs["cpu", "xla"]
    for key, lg in runs.items():
        torch.testing.assert_close(lg, ref, rtol=1e-4, atol=1e-4,
                                   msg=f"hybrid smoke {key} vs cpu")
        if not torch.equal(lg.argmax(-1), ref.argmax(-1)):
            raise AssertionError(f"hybrid smoke {key}: greedy tokens "
                                 "differ")
    if not torch.equal(runs["cuda", "pallas"],
                       runs["cuda", "pallas_fused"]):
        raise AssertionError("hybrid smoke: pallas and pallas_fused differ")
    log(f"  zamba2 smoke config f32, prefill 32 + 8 ticks at tick scope: "
        f"card within {(runs['cuda', 'pallas'] - ref).abs().max().item():.3g}"
        f" of the CPU oracle, greedy tokens equal, backends bitwise equal")


def serve_stablelm(np, torch):
    """Full-width stablelm-1.6b on the scheduler's stream (tick scope,
    chunk 64, paged) on both backends, the dense cache's tokens and tick
    log equal to the paged cache's, and the float32 oracle witness.
    Returns the runs' launch records by backend."""
    import types
    cfg = approx_cfg(STABLELM)
    params = init_logged(torch, cfg)
    prompts = stream_prompts(np, cfg)
    runs = {b: run_stream(torch, cfg, params, prompts,
                          f"{cfg.name} {b} tick/chunk 64/paged 16",
                          backend=b)
            for b in ("pallas", "pallas_fused")}
    if runs["pallas"]["tokens"] != runs["pallas_fused"]["tokens"]:
        raise AssertionError(f"{cfg.name}: greedy tokens differ between "
                             "pallas and pallas_fused")
    dense = run_stream(torch, cfg, params, prompts,
                       f"{cfg.name} pallas dense cache", kv_page_size=0)
    if dense["tokens"] != runs["pallas"]["tokens"] or \
            dense["tick_log"] != runs["pallas"]["tick_log"]:
        raise AssertionError(f"{cfg.name}: the dense cache's tokens or "
                             "tick log differ from the paged cache's")
    log(f"  tokens equal across backends; dense cache == paged cache "
        f"(tokens and tick log); {cfg.n_layers} launches a tick")
    # the float32 witness gates; the bf16 gaps are printed (one or two
    # bf16 ulps of the logits either way at this model: not gated)
    reqs = [types.SimpleNamespace(out=t) for t in dense["tokens"]]
    oracle_witness(torch, dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, route_scope="tick")), params, dense["srv"], reqs,
        gate_bf16=False)
    out = {"pallas": [], "pallas_fused": []}
    for label, r in (("paged", runs["pallas"]), ("dense", dense),
                     ("paged", runs["pallas_fused"])):
        for b, n in r["launches"].items():
            if n:
                out[b].append(dict(run=f"{cfg.name} stream {b} {label}",
                                   ticks=r["stats"]["ticks"], launches=n))
    return out


def archs_full_width(np, torch):
    """olmo-1b, stablelm-3b and musicgen-large at full width and
    internvl2-76b at full width cut to 4 of its 80 layers, bf16, MCMA
    on: a (2, 128) forward (layer scope, one switch launch a layer) and 4
    decode steps at tick scope (one a layer a step), logits finite; at d
    2560 and d 8192 one decode step's switch inputs held to the plain
    twins and timed.  Returns (launch records, {d: timings})."""
    from repro_torch.kernels import fused_dispatch, switched_mlp
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    b, s, nd = ARCHS_RUN["batch"], ARCHS_RUN["seq"], ARCHS_RUN["decode"]
    records, timed = [], {}
    for arch, keep in ARCHS_FULL:
        cfg = approx_cfg(arch)
        what = ""
        if keep:
            what = f" (cut to {keep} of its {cfg.n_layers} layers)"
            cfg = dataclasses.replace(cfg, n_layers=keep)
        params = init_logged(torch, cfg, what)
        gen = torch.Generator(device="cuda").manual_seed(1)
        if cfg.input_mode == "embeddings":
            x = torch.randn((b, s + nd, cfg.d_model), generator=gen,
                            device="cuda").to(cfg.adtype)
        else:
            x = torch.randint(0, cfg.vocab, (b, s + nd), generator=gen,
                              device="cuda", dtype=torch.int32)
        prefill = steps.make_prefill_step(steps.mcma_serve_config(cfg))
        step = steps.make_decode_step(cfg, use_mcma_dispatch=True,
                                      backend="pallas", route_scope="tick")
        torch.cuda.synchronize()
        switched_mlp.switched_mlp.launches = 0
        fused_dispatch.switched_mlp_fused.launches = 0
        t0 = time.time()
        last, cache = prefill(params, {"inputs": x[:, :s]})
        torch.cuda.synchronize()
        t_fwd = time.time() - t0
        n_fwd = switched_mlp.switched_mlp.launches
        cache = M.pad_cache(cfg, cache, s + nd)
        switched_mlp.switched_mlp.launches = 0
        times = []
        with SwitchCapture() as cap:
            for i in range(nd):
                t0 = time.time()
                lg, cache = step(params, cache, x[:, s + i:s + i + 1])
                torch.cuda.synchronize()
                times.append((time.time() - t0) * 1e3)
                if not torch.isfinite(lg.float()).all():
                    raise AssertionError(f"{arch}: decode logits not finite")
        n_dec = switched_mlp.switched_mlp.launches
        if fused_dispatch.switched_mlp_fused.launches:
            raise AssertionError(f"{arch}: the fused kernel launched")
        if last.shape != (b, cfg.vocab) or \
                not torch.isfinite(last.float()).all():
            raise AssertionError(f"{arch}: forward logits malformed")
        if n_fwd != cfg.n_layers or n_dec != cfg.n_layers * nd:
            raise AssertionError(f"{arch}: {n_fwd} launches in the forward, "
                                 f"{n_dec} in {nd} decode steps; want "
                                 f"{cfg.n_layers} and {cfg.n_layers * nd}")
        if cache["pos"].tolist() != [s + nd] * b:
            raise AssertionError(f"{arch}: pos {cache['pos'].tolist()}")
        log(f"  {arch}: forward ({b}, {s}) {t_fwd * 1e3:.2f} ms with "
            f"{n_fwd} switch launches; {nd} decode steps at tick scope "
            f"{', '.join(f'{t:.2f}' for t in times)} ms, {n_dec} launches "
            f"= {cfg.n_layers} x {nd}; logits finite")
        records += [dict(run=f"{arch} forward", launches=n_fwd),
                    dict(run=f"{arch} decode", ticks=nd, launches=n_dec)]
        if arch in ARCHS_TIMED:
            xk, cls, w = cap.args
            flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                                device="cuda")
            timed[cfg.d_model] = time_switch_case(
                np, torch, flush, xk, cls, w, cfg.approx.block_t,
                "bfloat16", f"{arch} decode step d {cfg.d_model}")
            del flush
        del params, cache, last, lg, x
        torch.cuda.empty_cache()
    return records, timed


def no_drop(cfg):
    """``cfg`` with capacity factor E / top_k: every token gets a slot in
    each of its experts (the reference's decode check,
    tests/test_archs.py), so no row competes with another."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def dryrun_child(path: str):
    """[dryrun full width]'s subprocess: (a) the cell recorded on fake
    CUDA tensors, (b) on fake CPU tensors, (c) rank 0's step of it run
    for real on the card in the same fake world (its collectives send
    nothing: the values mean nothing, the time and the memory hold), (d)
    the attention count against the traced loop.  Writes JSON to
    ``path``."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import switched_mlp
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HostMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    out, t0 = {}, time.time()
    cell = (DRYRUN["arch"], DRYRUN["shape"], DRYRUN["mesh"])
    for dev in ("cuda", "cpu"):
        out[dev] = dryrun.run_cell(*cell, approx=True, device=dev)
        out[dev]["roofline"] = dryrun.roofline_terms(out[dev])
    out["t_record_s"] = time.time() - t0
    cfg = dryrun.cell_config(DRYRUN["arch"], approx=True)
    mesh = HostMesh(*dryrun._mesh_layout(DRYRUN["mesh"]))
    torch.cuda.reset_peak_memory_stats()
    step, args, arg_bytes = dryrun.cell_step(
        cfg, SHAPES[DRYRUN["shape"]], mesh, "cuda", fake=False)
    torch.cuda.synchronize()
    switched_mlp.switched_mlp.launches = 0
    step(*args)                                         # warm
    torch.cuda.synchronize()
    warm = switched_mlp.switched_mlp.launches
    times = []
    for _ in range(DRYRUN["timed"]):
        t = time.perf_counter()
        logits, _ = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out["step"] = dict(
        times_ms=times, ms=statistics.median(times), argument_bytes=arg_bytes,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches_per_step=warm,
        launches=switched_mlp.switched_mlp.launches,
        logits=list(logits.shape))
    out["attention"] = dryrun_attention(torch, cfg)
    out["t_child_s"] = time.time() - t0
    with open(path, "w") as f:
        json.dump(out, f)


def dryrun_attention(torch, cfg):
    """The attention count (``hlo_cost._FlashCount``) against
    ``flash_attention`` traced op by op on CUDA tensors, forward and
    backward, at DRYRUN_ATTN's tokens and block sizes."""
    from repro_torch.launch import hlo_cost
    from repro_torch.models import layers
    real, a = layers.flash_attention, DRYRUN_ATTN
    res = []
    for blk in a["blocks"]:
        c = dataclasses.replace(cfg, q_block=blk, kv_block=blk)
        got = {}
        for how in ("counted", "traced"):
            qkv = [torch.zeros((a["batch"], a["tokens"], a["heads"], c.hd),
                               dtype=c.adtype, device="cuda",
                               requires_grad=True) for _ in range(3)]
            t = time.time()
            with hlo_cost.record(args=qkv) as rec:
                if how == "traced":
                    layers.flash_attention = real
                o = layers.flash_attention(c, *qkv)
                fwd = [rec.cost.flops, rec.cost.bytes]
                torch.autograd.grad(o, qkv, torch.ones_like(o))
            got[how] = dict(forward=fwd, backward=[
                rec.cost.flops - fwd[0], rec.cost.bytes - fwd[1]],
                s=time.time() - t)
        res.append(dict(block=blk, blocks=a["tokens"] // blk, **got))
    return res


def dryrun_start():
    """Start [dryrun full width]'s subprocess (``dryrun_child``), which
    runs beside the paper phase (host-bound on one core); returns what
    ``dryrun_full_width`` waits on."""
    root = Path(__file__).resolve().parent
    tmp = tempfile.TemporaryDirectory()
    path = f"{tmp.name}/dryrun.json"
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.dryrun_child({path!r})"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root / "src"), str(root)])))
    return proc, tmp, path


def dryrun_full_width(np, torch, started):
    """[dryrun full width]: ``launch/dryrun`` on a production cell, in the
    subprocess ``dryrun_start`` started, with four gates: (a) the record
    on fake CUDA tensors equals (b) the record on fake CPU tensors (cost,
    collectives, kernel ops, attention, memory); (c) rank 0's step run
    for real launches ``switched_mlp`` as many times a step as the record
    holds kernel ops, its ms and peak memory printed beside the record's
    bytes and terms; (d) the attention count equals the traced loop,
    forward and backward.  Returns the step's launches for the kernels
    line."""
    proc, tmp, path = started
    with tmp:
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise AssertionError(f"dryrun child failed:\n{err[-3000:]}")
        with open(path) as f:
            out = json.load(f)
    a, b, st = out["cuda"], out["cpu"], out["step"]
    if not (a["ok"] and b["ok"]):
        raise AssertionError(f"dryrun: {a.get('error')} {b.get('error')}")
    for key in ("cost", "collectives", "kernels", "attention", "memory"):
        if a[key] != b[key]:
            raise AssertionError(f"dryrun: {key} on fake cuda {a[key]} != "
                                 f"on fake cpu {b[key]}")
    cell = f"{DRYRUN['arch']} {DRYRUN['shape']} {DRYRUN['mesh']} approx"
    r_ = a["roofline"]
    log(f"  (a) = (b): {cell} recorded on fake cuda and fake cpu tensors "
        f"in {out['t_record_s']:.1f} s: {a['cost']['flops_per_chip']:.6g} "
        f"FLOP, {a['cost']['bytes_per_chip']:.6g} B, "
        f"{a['cost']['n_ops']} ops a rank; collectives "
        f"{a['collectives']['counts']} sending "
        f"{a['collectives']['by_kind']} B (ring model "
        f"{a['collectives']['ring_by_kind']}); kernel ops {a['kernels']}")
    want = a["kernels"]["switched_mlp"]["calls"]
    if st["launches_per_step"] != want \
            or st["launches"] != want * (1 + DRYRUN["timed"]):
        raise AssertionError(f"dryrun: the step launched switched_mlp "
                             f"{st['launches_per_step']} times a step "
                             f"({st['launches']} in all); the record "
                             f"holds {want} kernel ops")
    m = a["memory"]
    log(f"  (c) rank 0's step on the card: {st['ms']:.2f} ms (host clock, "
        f"median of {DRYRUN['timed']} after a warm call: "
        f"{', '.join(f'{t:.2f}' for t in st['times_ms'])}), "
        f"max_memory_allocated {st['max_memory_allocated']} B, argument "
        f"bytes {st['argument_bytes']}; switched_mlp {want} launches a "
        f"step = the record's kernel ops.  The record: argument_bytes "
        f"{m['argument_bytes']}, peak_bytes {m['peak_bytes']}; terms "
        f"compute {r_['t_compute_s'] * 1e3:.4f} ms, memory "
        f"{r_['t_memory_s'] * 1e3:.4f} ms, collective "
        f"{r_['t_collective_s'] * 1e3:.4f} ms ({r_['bottleneck']}-bound; "
        f"{card_line()})")
    if st["argument_bytes"] != m["argument_bytes"]:
        raise AssertionError(f"dryrun: the step's arguments hold "
                             f"{st['argument_bytes']} B, the record "
                             f"{m['argument_bytes']}")
    for att in out["attention"]:
        c, t = att["counted"], att["traced"]
        if (c["forward"], c["backward"]) != (t["forward"], t["backward"]):
            raise AssertionError(f"dryrun: attention at "
                                 f"{DRYRUN_ATTN['tokens']} tokens, blocks "
                                 f"of {att['block']}: counted {c} != "
                                 f"traced {t}")
        log(f"  (d) attention at {DRYRUN_ATTN['tokens']} tokens, "
            f"{att['blocks']} blocks of {att['block']}: counted == traced, "
            f"forward {c['forward'][0]:.6g} FLOP {c['forward'][1]:.6g} B, "
            f"backward {c['backward'][0]:.6g} FLOP {c['backward'][1]:.6g} "
            f"B (counted in {c['s']:.2f} s, traced in {t['s']:.2f} s)")
    log(f"  child {out['t_child_s']:.1f} s")
    return dict(run=f"dryrun {DRYRUN['arch']} {DRYRUN['shape']} rank step",
                steps=1 + DRYRUN["timed"], launches=st["launches"])


def release(torch):
    """Free what the last phase left: its tensors, then the cache."""
    gc.collect()
    torch.cuda.empty_cache()


def child_processes() -> list[str]:
    """This process's children that are still there, as "pid name"."""
    me, left = str(os.getpid()), []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:                       # it ended meanwhile
            continue
        # "pid (name) state ppid ...": the name may hold spaces
        if text[text.rindex(")") + 2:].split()[1] == me:
            left.append(f"{stat.parent.name} "
                        f"{text[text.index('(') + 1:text.rindex(')')]}")
    return left


def zero_switch():
    from repro_torch.kernels import fused_dispatch, switched_mlp
    switched_mlp.switched_mlp.launches = 0
    fused_dispatch.switched_mlp_fused.launches = 0


def switch_launches() -> int:
    from repro_torch.kernels import fused_dispatch, switched_mlp
    return switched_mlp.switched_mlp.launches \
        + fused_dispatch.switched_mlp_fused.launches


class MoECapture:
    """Records each MoE application's parameters and input (one a layer
    a step) through the model's binding of ``moe.moe_fwd``."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.real, self.calls = moe, moe.moe_fwd, []

        def capture(cfg, p, x):
            self.calls.append((p, x.detach().clone()))
            return self.real(cfg, p, x)
        moe.moe_fwd = capture
        return self

    def __exit__(self, *exc):
        self.mod.moe_fwd = self.real


def drop_share(torch, cfg, calls):
    """The share of (token, expert) choices that the capacity drops over
    the recorded MoE applications, from the router's top-k and
    ``capacity_slots`` on each one's input (``moe.dropped_choices``: on a
    mesh, called inside its serve context, each data shard's rows at its
    own capacity and the counts summed over the data axes, so the share
    is global).  Returns (mean share, per-layer shares, slots per expert
    of a data shard)."""
    from repro_torch.models import moe
    shares = []
    for p, x in calls:
        dropped, total = moe.dropped_choices(cfg, p, x)
        shares.append(int(dropped) / int(total))
    t, m = x.shape[0] * x.shape[1], cfg.moe
    cap = min(int(m.capacity_factor * t * m.top_k / m.n_experts) + 1, t)
    return statistics.mean(shares), shares, cap


def moe_stream(torch, cfg, params, prompts, label, **over):
    """The scheduler's stream through DecodeServer on an MoE model (MCMA
    dispatch on, which serves the MoE), the switch counts set to 0 just
    before and read just after.  Fails unless every request is served,
    every page comes back, and no switch kernel and no dispatch plan ran
    (the MoE takes the ApproxFFN's place and routes itself)."""
    from repro_torch.analysis.audit import PlanCapture
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer
    opts = {**SCHED, "use_mcma_dispatch": True, "backend": "pallas", **over}
    srv = DecodeServer(cfg, params, options=ServeOptions(**opts))
    torch.cuda.synchronize()
    zero_switch()
    with PlanCapture() as plans:
        reqs, st, times, wall, _ = drive(torch, srv, prompts, SCHED_MAX_NEW)
    if not all(r.done and not r.aborted for r in reqs) or \
            st["undrained_queued"] or st["undrained_inflight"]:
        raise AssertionError(f"{label}: the stream did not drain")
    if opts["kv_page_size"] and st["pages_in_use"] != 0:
        raise AssertionError(f"{label}: {st['pages_in_use']} pages held")
    if switch_launches() or len(plans.plans):
        raise AssertionError(f"{label}: {switch_launches()} switch launches "
                             f"and {len(plans.plans)} dispatch plans on an "
                             "MoE model; want 0")
    n_tok = sum(len(r.out) for r in reqs)
    ttft = statistics.mean(r.first_token_tick - r.arrival_tick for r in reqs)
    med = {ph: statistics.median(v) if v else 0.0 for ph, v in times.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"  {label}: {st['ticks']} ticks ({len(times['decode'])} decode, "
        f"{st['prefill_ticks']} prefill); ms per decode tick median "
        f"{med['decode']:.2f}, per prefill tick median "
        f"{med['prefill']:.2f}; {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; mean TTFT {ttft:.2f} ticks; 0 "
        f"switch launches, 0 dispatch plans; kv_bytes_resident "
        f"{st['kv_bytes_resident']}; peak memory so far in the phase "
        f"{peak} B")
    return dict(tokens=[r.out for r in reqs], tick_log=list(srv.tick_log),
                stats=st)


def serve_moe(np, torch):
    """[serve moe full width]: moonshot-v1-16b-a3b uncut, bf16, on the
    scheduler's stream and serving configuration, on the paged and the
    dense cache; paged == dense bitwise at capacity factor E / top_k;
    one profiled decode tick of 8 decoding slots and the share of expert
    choices its capacity drops."""
    from repro_torch.launch.profile_decode import profiled
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = approx_cfg(MOE)
    params = init_logged(torch, cfg, " (uncut)")
    prompts = stream_prompts(np, cfg)
    layouts = (("paged 16", {}), ("dense", dict(kv_page_size=0)))
    runs = {lbl: moe_stream(torch, cfg, params, prompts,
                            f"{cfg.name} tick/chunk 64/{lbl}", **over)
            for lbl, over in layouts}
    pairs = [(x, y) for a, b in zip(runs["paged 16"]["tokens"],
                                    runs["dense"]["tokens"])
             for x, y in zip(a, b)]
    log(f"  capacity factor {cfg.moe.capacity_factor}: paged == dense on "
        f"{sum(x == y for x, y in pairs)} of {len(pairs)} tokens (not "
        "gated: idle slots' and padded chunk rows compete for expert "
        "capacity, and what they attend to differs between the layouts, "
        "in the reference as here)")
    nd = no_drop(cfg)
    free = {lbl: moe_stream(torch, nd, params, prompts,
                            f"{cfg.name} capacity factor E/top_k {lbl}",
                            **over)
            for lbl, over in layouts}
    if free["paged 16"]["tokens"] != free["dense"]["tokens"] or \
            free["paged 16"]["tick_log"] != free["dense"]["tick_log"]:
        raise AssertionError(f"{cfg.name}: at capacity factor E/top_k the "
                             "paged cache's tokens or tick log differ from "
                             "the dense cache's")
    log("  gate: at capacity factor E/top_k (no row competes) paged == "
        "dense, tokens and tick log bitwise")

    # one decode tick of 8 decoding slots, as the server runs it
    srv = DecodeServer(cfg, params, options=ServeOptions(
        **SCHED, use_mcma_dispatch=True, backend="pallas"))
    rng = np.random.default_rng(1)
    for i in range(SCHED["batch"]):
        srv.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 1)
                           .astype(np.int32), max_new=64))
    for _ in range(3):
        srv.tick()
    zero_switch()
    with MoECapture() as cap:
        srv.tick()
    share, shares, slots = drop_share(torch, cfg, cap.calls)
    host_ms, wall_ms, kernels, _ = profiled(torch, srv.tick, 1)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    if switch_launches() or len(cap.calls) != cfg.n_layers:
        raise AssertionError(f"{cfg.name} tick: {switch_launches()} switch "
                             f"launches, {len(cap.calls)} MoE calls")
    log(f"  one decode tick of {SCHED['batch']} slots: {host_ms:.2f} ms (host "
        f"clock), {wall_ms:.2f} ms under the profiler, device busy "
        f"{busy:.2f} ms in {launches} kernel launches, idle share "
        f"{max(0.0, 1 - busy / host_ms):.3f}; {slots} slot(s) per expert: "
        f"{share:.4f} of the {SCHED['batch'] * cfg.moe.top_k} expert "
        f"choices a layer dropped (layers {min(shares):.4f} to "
        f"{max(shares):.4f})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} "
            f"launches  {e.key[:80]}")
    return dict(tokens=runs["paged 16"]["tokens"], share=share)


def moe_witness(np, torch):
    """[moe float32 witness]: moonshot at its widths cut to 2 layers,
    float32, capacity factor E / top_k: forward(2S) at S + j against
    prefill(S) + decode steps j = 0..3 within 2e-3; the chunk path into a
    dense and a paged cache, then the same steps: bitwise equal, and
    within 2e-3 of the forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    w = MOE_WITNESS
    full_cfg = get_config(MOE)
    cfg = dataclasses.replace(no_drop(full_cfg), n_layers=w["n_layers"],
                              param_dtype="float32", act_dtype="float32")
    params = init_logged(torch, cfg, f" (cut to {w['n_layers']} of its "
                                     f"{full_cfg.n_layers} layers, float32, "
                                     "capacity factor E/top_k)")
    b, s, nd, ps = w["batch"], w["seq"], w["decode"], w["page_size"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (b, 2 * s), generator=gen,
                         device="cuda", dtype=torch.int32)
    gaps, outs = [], {}
    with torch.no_grad():
        want = M.forward(cfg, params, toks)[0][:, s:s + nd].clone()
        _, cache, _, _ = M.forward(cfg, params, toks[:, :s],
                                   collect_cache=True)
        cache = M.pad_cache(cfg, cache, 2 * s)
        for j in range(nd):
            got, cache = M.decode(cfg, params, cache,
                                  toks[:, s + j:s + j + 1])
            torch.testing.assert_close(got, want[:, j], rtol=2e-3, atol=2e-3,
                                       msg=f"moe witness step {j}")
            gaps.append((got - want[:, j]).abs().max().item())
        if cache["pos"].tolist() != [s + nd] * b:
            raise AssertionError(f"moe witness pos {cache['pos'].tolist()}")
        for page in (0, ps):
            c = M.init_cache(cfg, b, 2 * s, page_size=page,
                             kv_pages=b * 2 * s // ps if page else 0,
                             device="cuda")
            if page:
                bt = c["block_table"]
                bt.copy_(torch.arange(bt.numel(), dtype=torch.int32,
                                      device="cuda").reshape(bt.shape))
            c, _ = M.decode_chunk(cfg, params, c, toks[:, :s],
                                  torch.full((b,), s, dtype=torch.int32,
                                             device="cuda"))
            steps_out = []
            for j in range(nd):
                got, c = M.decode(cfg, params, c, toks[:, s + j:s + j + 1])
                steps_out.append(got)
            outs[page] = torch.stack(steps_out, 1)
    if not torch.equal(outs[0], outs[ps]):
        raise AssertionError("moe witness: the paged cache's logits differ "
                             "from the dense cache's")
    torch.testing.assert_close(outs[0], want, rtol=2e-3, atol=2e-3,
                               msg="moe witness: chunked prefill + decode")
    log(f"  forward({2 * s}) at {s}..{s + nd - 1} vs prefill({s}) + {nd} "
        f"decode steps: max |diff| {max(gaps):.4g} (per step "
        f"{', '.join(f'{g:.3g}' for g in gaps)}) within 2e-3; the chunk "
        f"path into {ps}-token pages == the dense cache bitwise, "
        f"{(outs[0] - want).abs().max().item():.4g} from the forward")


def swa_full_width(np, torch):
    """[sliding window full width]: mixtral-8x7b at full width cut to
    SWA_LAYERS layers, bf16: a (1, 8192) prefill into the 4096-row ring
    and 16 decode steps past the window (finite logits, pos); the slice-1
    stream through DecodeServer (prompts token by token); then the
    float32 witness at 2 layers, capacity factor E / top_k: forward over
    8192 at 4096 + j against a 4096-token prefill + 8 decode steps (the
    ring wraps at the first), within 2e-3.  No switch kernel runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.runtime import steps
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    full_cfg = get_config(SWA)
    win = full_cfg.sliding_window
    cfg = dataclasses.replace(full_cfg, n_layers=SWA_LAYERS)
    params = init_logged(torch, cfg, f" (cut to {SWA_LAYERS} of its "
                                     f"{full_cfg.n_layers} layers; window "
                                     f"{win})")
    n, nd = SWA_RUN["prefill"], SWA_RUN["decode"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (1, n + nd), generator=gen,
                         device="cuda", dtype=torch.int32)
    prefill, step = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    zero_switch()
    t0 = time.time()
    last, cache = prefill(params, {"inputs": toks[:, :n]})
    torch.cuda.synchronize()
    t_fwd = time.time() - t0
    if cache["k"].shape[2] != win or not torch.isfinite(last.float()).all():
        raise AssertionError(f"{SWA}: ring of {cache['k'].shape[2]} rows "
                             f"(want {win}) or prefill logits not finite")
    times = []
    for i in range(nd):
        t0 = time.time()
        lg, cache = step(params, cache, toks[:, n + i:n + i + 1])
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        if not torch.isfinite(lg.float()).all():
            raise AssertionError(f"{SWA}: decode step {i} not finite")
    if cache["pos"].tolist() != [n + nd] or switch_launches():
        raise AssertionError(f"{SWA}: pos {cache['pos'].tolist()}, "
                             f"{switch_launches()} switch launches")
    log(f"  prefill (1, {n}) {t_fwd * 1e3:.1f} ms into a ring of {win} "
        f"rows; {nd} decode steps past the window, ms median "
        f"{statistics.median(times):.2f}, pos {n + nd}, logits finite; peak "
        f"memory so far in the phase {torch.cuda.max_memory_allocated()} B")
    del cache, last, lg

    rng = np.random.default_rng(0)
    srv = DecodeServer(cfg, params, options=ServeOptions(
        batch=SERVE["batch"], max_len=SERVE["max_len"],
        prefill_chunk=SCHED["prefill_chunk"]))
    if srv.prefill_chunk != 0:
        raise AssertionError(f"{SWA}: the server chunks a ring's prompts")
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               SERVE["prompt_len"])
                    .astype(np.int32), max_new=SERVE["max_new"])
            for i in range(SERVE["n_requests"])]
    for r in reqs:
        srv.submit(r)
    torch.cuda.synchronize()
    zero_switch()
    t0 = time.time()
    st = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_tok = sum(len(r.out) for r in reqs)
    if not all(r.done and not r.aborted for r in reqs) or switch_launches():
        raise AssertionError(f"{SWA} serve: drained "
                             f"{all(r.done for r in reqs)}, "
                             f"{switch_launches()} switch launches")
    log(f"  serve the slice-1 stream (token by token, ring of "
        f"{srv.cache['k'].shape[2]} rows at max_len {SERVE['max_len']}): "
        f"{st['ticks']} ticks, {n_tok} tokens, "
        f"{wall * 1e3 / st['ticks']:.2f} ms/tick, {n_tok / wall:.1f} "
        f"tokens/s, 0 switch launches, peak memory so far in the phase "
        f"{torch.cuda.max_memory_allocated()} B")
    del srv, params
    release(torch)

    w = SWA_WITNESS
    cfg32 = dataclasses.replace(no_drop(full_cfg), n_layers=w["n_layers"],
                                param_dtype="float32", act_dtype="float32")
    p32 = init_logged(torch, cfg32, f" (cut to {w['n_layers']} layers, "
                                    "float32, capacity factor E/top_k)")
    s, at, nd = w["seq"], w["at"], w["decode"]
    toks = torch.randint(0, cfg32.vocab, (1, s), generator=gen,
                         device="cuda", dtype=torch.int32)
    gaps = []
    with torch.no_grad():
        want = M.forward(cfg32, p32, toks)[0][:, at:at + nd].clone()
        _, cache, _, _ = M.forward(cfg32, p32, toks[:, :at],
                                   collect_cache=True)
        if cache["k"].shape[2] != min(at, win):
            raise AssertionError(f"{SWA} witness: ring {cache['k'].shape}")
        for j in range(nd):
            got, cache = M.decode(cfg32, p32, cache,
                                  toks[:, at + j:at + j + 1])
            torch.testing.assert_close(got, want[:, j], rtol=2e-3, atol=2e-3,
                                       msg=f"{SWA} witness step {j}")
            gaps.append((got - want[:, j]).abs().max().item())
    if cache["pos"].tolist() != [at + nd]:
        raise AssertionError(f"{SWA} witness pos {cache['pos'].tolist()}")
    log(f"  float32 witness: forward({s}) at {at}..{at + nd - 1} vs "
        f"prefill({at}) + {nd} decode steps (the ring wraps at the first): "
        f"max |diff| {max(gaps):.4g} (per step "
        f"{', '.join(f'{g:.3g}' for g in gaps)}) within 2e-3")


def mesh_witness_logits(torch, cfg, params, mesh, toks):
    """A (batch, seq) prompt through one chunk step and one decode step at
    tick scope on a dense cache (on ``mesh`` under its serve context):
    the decode step's logits, float32."""
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    kw = dict(use_mcma_dispatch=True, route_scope="tick", backend="pallas")
    b, s = toks.shape
    with S.serve_mesh_context(mesh):
        cache = M.init_cache(cfg, b, 2 * s, device="cuda")
        cache, _ = S.make_prefill_chunk_step(cfg, **kw)(
            params, cache, toks[:, :-1],
            torch.full((b,), s - 1, dtype=torch.int32, device="cuda"))
        logits, _ = S.make_decode_step(cfg, **kw)(
            params, cache, toks[:, -1:],
            torch.ones(b, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    return logits.float()


def mesh_run(torch, np, cfg, params, prompts, backend, mesh,
             max_new=SCHED_MAX_NEW):
    """The scheduler's stream through a DecodeServer (on ``mesh`` when
    given), the switch launches and the collectives counted from 0 after
    the server is built: tokens, stats, tick log, launches, tick times."""
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.sharding import collectives as C
    srv = DecodeServer(cfg, params, options=ServeOptions(
        **SCHED, use_mcma_dispatch=True, backend=backend, mesh=mesh))
    torch.cuda.synchronize()
    zero_switch()
    C.reset_counts()
    reqs, st, times, wall, _ = drive(torch, srv, prompts, max_new)
    stats = st.asdict()
    stats.pop("wall_s")
    return dict(tokens=[list(r.out) for r in reqs],
                done=all(r.done and not r.aborted for r in reqs),
                stats=stats, tick_log=list(srv.tick_log),
                launches=switch_launches(), collectives=dict(C.COUNTS),
                times=times, wall=wall)


def mesh_cfg():
    """internlm2-1.8b as [serve mesh full width] serves it: MCMA on, cut
    to ``MESH_LAYERS`` layers."""
    return dataclasses.replace(approx_cfg("internlm2-1.8b"),
                               n_layers=MESH_LAYERS)


def mesh_rank(rank, out_dir):
    """One rank of [serve mesh full width]: the bf16 stream on both
    backends, then the float32 witness; its payload to ``out_dir``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(data=MESH_SHAPE[0], model=MESH_SHAPE[1])
    cfg = mesh_cfg()
    prompts = stream_prompts(np, cfg)
    out = {"coords": mesh.coords, "runs": {}}
    for b in ("pallas", "pallas_fused"):
        params = M.init_model(0, cfg, device="cuda")
        out["runs"][b] = mesh_run(torch, np, cfg, params, prompts, b, mesh)
        del params
        release(torch)
    w = MESH_WITNESS
    cfg32 = dataclasses.replace(
        approx_cfg("internlm2-1.8b", **NO_CLIP), n_layers=w["n_layers"],
        param_dtype="float32", act_dtype="float32")
    params = M.init_model(0, cfg32, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg32.vocab, (w["batch"], w["seq"])).astype(np.int32)).cuda()
    single = mesh_run(torch, np, cfg32, params, prompts, "pallas", None)
    single_logits = mesh_witness_logits(torch, cfg32, params, None, toks)
    sharded = mesh_run(torch, np, cfg32, params, prompts, "pallas", mesh)
    mesh_logits = mesh_witness_logits(torch, cfg32, params, mesh, toks)
    out["witness"] = dict(
        single=single["tokens"], mesh=sharded["tokens"],
        done=single["done"] and sharded["done"],
        max_abs=float((mesh_logits - single_logits).abs().max()),
        finite=bool(torch.isfinite(mesh_logits).all()))
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def serve_mesh(np, torch):
    """[serve mesh full width]: internlm2-1.8b at its widths cut to
    ``MESH_LAYERS`` layers, bf16, served by a
    DecodeServer on a (2, 2) ("data", "model") mesh of 4 ranks sharing the
    card over gloo, on the scheduler's stream on both backends, then a
    float32 witness at full widths cut to 2 layers, then the launcher
    with ``--data 2 --model 2``.  Gates: each rank launches its backend's
    kernel once a layer a tick; tokens, stats and tick logs bitwise equal
    on every rank; invocation in [0, 1]; the witness's tokens equal to the
    single-device server's and its logits within 1e-4.  (No bf16 token
    comparison with the scheduler phase's single-device run: that one
    has all 24 layers.)  Returns the kernels line's runs."""
    from repro_torch.launch.mesh import spawn_world
    cfg = mesh_cfg()
    ranks = MESH_SHAPE[0] * MESH_SHAPE[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        spawn_world(mesh_rank, ranks, (tmp,), backend="gloo")
        log(f"  {ranks} ranks on a {MESH_SHAPE} mesh (gloo, one card) in "
            f"{time.time() - t0:.1f} s")
        pay = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
               for r in range(ranks)]
    strip = lambda run: {k: v for k, v in run.items()
                         if k not in ("times", "wall")}
    for r, p in enumerate(pay[1:], 1):
        for b in p["runs"]:
            if strip(p["runs"][b]) != strip(pay[0]["runs"][b]):
                raise AssertionError(f"mesh: rank {r} disagrees with rank 0 "
                                     f"on the {b} run")
        if p["witness"] != pay[0]["witness"]:
            raise AssertionError(f"mesh: rank {r}'s witness differs")
    by_run = {}
    for b, run in pay[0]["runs"].items():
        ticks = run["stats"]["ticks"]
        want = cfg.n_layers * ticks
        launches = [p["runs"][b]["launches"] for p in pay]
        inv = run["stats"]["invocation_rate"]
        if not run["done"] or any(n != want for n in launches) \
                or not 0.0 <= inv <= 1.0:
            raise AssertionError(f"mesh {b}: done {run['done']}, launches "
                                 f"per rank {launches} (want {want}), "
                                 f"invocation {inv}")
        n_tok = sum(len(t) for t in run["tokens"])
        med = {ph: statistics.median(v) if v else 0.0
               for ph, v in run["times"].items()}
        col = run["collectives"]
        log(f"  {b}: {ticks} ticks ({run['stats']['prefill_ticks']} "
            f"prefill); rank 0 ms per decode tick median {med['decode']:.2f},"
            f" per prefill tick median {med['prefill']:.2f}; {n_tok} tokens "
            f"in {run['wall']:.3f} s = {n_tok / run['wall']:.1f} tokens/s; "
            f"invocation {inv:.4f}, served "
            f"{run['stats']['served_invocation_rate']:.4f}; launches per "
            f"rank {launches[0]} ({cfg.n_layers} a tick, every rank); per "
            f"tick per rank {col['all_gather'] / ticks:.1f} all-gathers, "
            f"{col['all_reduce'] / ticks:.1f} all-reduces, "
            f"{col['staged'] / ticks:.1f} host stagings of "
            f"{col['staged_bytes'] / ticks / 2**20:.1f} MiB; "
            "kv_bytes_resident "
            f"{run['stats']['kv_bytes_resident']}")
        by_run[b] = dict(run=f"mesh {MESH_SHAPE} {b}, all ranks",
                         ticks=ticks, launches=sum(launches),
                         per_rank=launches[0])
    wit = pay[0]["witness"]
    if not (wit["done"] and wit["finite"] and wit["mesh"] == wit["single"]
            and wit["max_abs"] <= MESH_WITNESS["tol"]):
        raise AssertionError(f"mesh float32 witness: tokens equal "
                             f"{wit['mesh'] == wit['single']}, max |mesh - "
                             f"single| logits {wit['max_abs']:.3g}")
    log(f"  float32 witness ({MESH_WITNESS['n_layers']} layers at full "
        f"width, no-clip): tokens equal to the single-device server's; "
        f"decode logits within {wit['max_abs']:.3g} "
        f"(<= {MESH_WITNESS['tol']})")
    t0 = time.time()
    src = str(Path(__file__).resolve().parent / "src")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *MESH_LAUNCHER], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=src))
    if r.returncode:
        raise AssertionError(f"launch/serve.py on a mesh failed:\n"
                             f"{r.stderr[-3000:]}")
    for line in r.stdout.strip().splitlines():
        log(f"  launcher: {line}")
    log(f"  launch/serve.py {' '.join(MESH_LAUNCHER)}: "
        f"{time.time() - t0:.1f} s")
    return by_run


def moe_mesh_serve(np, torch, mesh, single_tokens):
    """[serve moe mesh full width], one rank: moonshot uncut, bf16, drawn
    as this rank's shards (16 whole experts on a (1, 4) mesh), through a
    mesh DecodeServer on the scheduler's stream; then one decode tick of
    8 slots, each layer's global drop share.  Returns the run's record."""
    from repro_torch.analysis.audit import PlanCapture
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer, Request
    from repro_torch.sharding import collectives as C
    cfg = approx_cfg(MOE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_local = sum(p.numel() for p in params.parameters())
    prompts = stream_prompts(np, cfg)
    srv = DecodeServer(cfg, params, options=ServeOptions(
        **SCHED, use_mcma_dispatch=True, backend="pallas", mesh=mesh))
    torch.cuda.synchronize()
    zero_switch()
    C.reset_counts()
    with PlanCapture() as plans:
        reqs, st, times, wall, _ = drive(torch, srv, prompts, SCHED_MAX_NEW)
    counts, launches = dict(C.COUNTS), switch_launches()
    stats = st.asdict()
    stats.pop("wall_s")
    tokens = [list(r.out) for r in reqs]
    out = dict(tokens=tokens, stats=stats, tick_log=list(srv.tick_log),
               done=all(r.done and not r.aborted for r in reqs),
               launches=launches, plans=len(plans.plans), counts=counts,
               times=times, wall=wall, init_s=init_s, n_local=n_local,
               agree=None if single_tokens is None else sum(
                   x == y for a, b in zip(tokens, single_tokens)
                   for x, y in zip(a, b)))
    del srv
    # one decode tick of 8 decoding slots, as serve_moe's on one card
    srv = DecodeServer(cfg, params, options=ServeOptions(
        **SCHED, use_mcma_dispatch=True, backend="pallas", mesh=mesh))
    rng = np.random.default_rng(1)
    for i in range(SCHED["batch"]):
        srv.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 1)
                           .astype(np.int32), max_new=64))
    for _ in range(3):
        srv.tick()
    with MoECapture() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.tick()
        torch.cuda.synchronize()
        out["tick_ms"] = (time.perf_counter() - t0) * 1e3
    with S.serve_mesh_context(mesh):
        out["share"], out["shares"], out["slots"] = drop_share(
            torch, cfg, cap.calls)
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def moe_routing(torch, cfg, calls, mesh=None):
    """Each recorded MoE application's routing over the whole batch:
    (gate_idx, keep) of every token group as ``moe.route`` gives them
    over all E experts.  On a mesh (inside its context) each data
    shard's rows route at the shard's capacity with the router gathered
    whole, and the shards are gathered in data order; on one card the
    groups are ``moe.scan_chunk``'s (the grouped oracle's data shards)."""
    from repro_torch.models import moe
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import P, dp_axes
    out = []
    with torch.no_grad():
        for p, x in calls:
            t, d = x.shape[0] * x.shape[1], x.shape[-1]
            if mesh is None:
                ck = cfg.moe.scan_chunk
                groups = x.reshape(-1, ck if t > ck and t % ck == 0 else t,
                                   d)
                rs = [moe.route(cfg, p.router, g) for g in groups]
                out.append((torch.cat([r.gate_idx for r in rs]).cpu(),
                            torch.cat([r.keep for r in rs]).cpu()))
                continue
            router = C.gather_whole(p.router, p.router._pspec, mesh)
            r = moe.route(cfg, router, x.reshape(t, d))
            spec = P(dp_axes(mesh))
            out.append(tuple(C.gather_whole(a, spec, mesh).cpu()
                             for a in (r.gate_idx, r.keep)))
    return out


def moe_witness_logits(torch, cfg, params, toks, mesh=None, step_cfg=None):
    """A (batch, seq) prompt through one chunk step (seq - 1 tokens,
    under ``cfg``) and one decode step (under ``step_cfg``, default
    ``cfg``) on a dense cache, on ``mesh`` under its serve context when
    given: the decode step's logits (float32) and the routing of every
    MoE application (``moe_routing``), the chunk's then the step's."""
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    b, s = toks.shape
    step_cfg = step_cfg or cfg
    with S.serve_mesh_context(mesh), torch.no_grad():
        cache = M.init_cache(cfg, b, 2 * s, device="cuda")
        with MoECapture() as chunk:
            cache, _ = M.decode_chunk(
                cfg, params, cache, toks[:, :-1],
                torch.full((b,), s - 1, dtype=torch.int32, device="cuda"))
        with MoECapture() as step:
            logits, _ = M.decode(step_cfg, params, cache, toks[:, -1:])
        torch.cuda.synchronize()
        routing = moe_routing(torch, cfg, chunk.calls, mesh) \
            + moe_routing(torch, step_cfg, step.calls, mesh)
    return logits.float(), routing


def grouped(cfg, tokens: int):
    """``cfg`` with ``moe.scan_chunk`` = ``tokens``: on one card, the
    grouped oracle of a mesh whose data shards hold ``tokens`` tokens
    each (``local_rows`` is contiguous, so the groups are the shards)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, scan_chunk=tokens))


def moe_mesh_witness(np, torch, mesh):
    """The float32 witness of the MoE mesh, one rank: moonshot at full
    widths cut to 2 layers on ``mesh`` ((2, 2): FSDP, EP and per-shard
    capacity engaged); one chunk and one decode step at the reference's
    capacity, then at capacity factor E / top_k.  Rank 0 also runs one
    card's grouped oracle (and at E / top_k its plain path) and returns
    the gaps and whether the routing agrees."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import dp_axes
    w = MOE_MESH_WITNESS
    cfg = dataclasses.replace(get_config(MOE), n_layers=w["n_layers"],
                              param_dtype="float32", act_dtype="float32")
    b, s = w["batch"], w["seq"]
    g = mesh.size(dp_axes(mesh))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)).cuda()
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    runs = {}
    for name, c in (("capacity", cfg), ("E/top_k", no_drop(cfg))):
        logits, routing = moe_witness_logits(torch, c, params, toks, mesh)
        runs[name] = dict(logits=logits, routing=routing)
    del params
    release(torch)
    out = {"finite": all(bool(torch.isfinite(r["logits"]).all())
                         for r in runs.values())}
    C.barrier()
    if mesh.rank == 0:
        one = M.init_model(0, cfg, device="cuda")
        # the grouped oracle: the chunk's groups are the shards' b / g
        # rows of s - 1 tokens, the decode step's their b / g tokens; at
        # E / top_k one card's plain path (one group, nothing dropped)
        want = {"capacity": moe_witness_logits(
                    torch, grouped(cfg, b // g * (s - 1)), one, toks,
                    step_cfg=grouped(cfg, b // g)),
                "E/top_k": moe_witness_logits(torch, no_drop(cfg), one,
                                              toks)}
        for name, run in runs.items():
            lg, routing = want[name]
            out[name] = dict(
                max_abs=float((run["logits"] - lg).abs().max()),
                routing_equal=len(routing) == len(run["routing"]) and all(
                    torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1])
                    for a, b_ in zip(routing, run["routing"])),
                dropped=sum(int((~r[1]).sum()) for r in routing),
                choices=sum(r[1].numel() for r in routing))
        del one, want
        release(torch)
    C.barrier()
    return out


def swa_mesh_witness(np, torch, mesh, out_dir):
    """Mixtral's ring on a mesh, one rank: at full widths cut to 2 layers,
    float32, capacity factor E / top_k.  Rank 0 runs one card:
    forward(seq) read at at..at + decode - 1, and prefill(at) into the
    window's ring plus ``decode`` steps; every rank then takes that
    prefill's ring, sharded (``model.shard_cache``), and decodes the same
    steps on ``mesh`` past the window (the ring wraps at the first).
    Rank 0 returns the gaps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    w = SWA_MESH_WITNESS
    cfg = dataclasses.replace(no_drop(get_config(SWA)),
                              n_layers=w["n_layers"], param_dtype="float32",
                              act_dtype="float32")
    s, at, nd = w["seq"], w["at"], w["decode"]
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, s)).astype(np.int32)).cuda()
    ring = f"{out_dir}/ring.pt"
    if mesh.rank == 0:
        one = M.init_model(0, cfg, device="cuda")
        with torch.no_grad():
            want = M.forward(cfg, one, toks)[0][:, at:at + nd].float()
            _, cache, _, _ = M.forward(cfg, one, toks[:, :at],
                                       collect_cache=True)
            torch.save({k: v.cpu() for k, v in cache.items()}, ring)
            single = []
            for j in range(nd):
                lg, cache = M.decode(cfg, one, cache,
                                     toks[:, at + j:at + j + 1])
                single.append(lg.float())
        single = torch.stack(single, 1)
        del one, cache
        release(torch)
    C.barrier()
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    got = []
    with S.serve_mesh_context(mesh), torch.no_grad():
        cache = M.shard_cache(mesh, {
            k: v.cuda() for k, v in torch.load(ring).items()})
        for j in range(nd):
            lg, cache = M.decode(cfg, params, cache,
                                 toks[:, at + j:at + j + 1])
            got.append(lg.float())
    got = torch.stack(got, 1)
    out = dict(ring_rows=int(cache["k"].shape[2]), pos=cache["pos"].tolist(),
               kv_local=int(cache["k"].shape[3]),
               finite=bool(torch.isfinite(got).all()))
    if mesh.rank == 0:
        out.update(vs_single=float((got - single).abs().max()),
                   vs_forward=float((got - want).abs().max()),
                   single_vs_forward=float((single - want).abs().max()))
    del params, cache
    release(torch)
    C.barrier()
    return out


def train_moe_mesh_witness(np, torch, mesh):
    """The float32 witness of [train moe mesh], one rank: moonshot at its
    widths cut to 2 layers, remat; ``loss_and_grads`` on ``mesh`` on the
    rank's rows of a small batch, with its routing.  Rank 0 also runs one
    card's grouped oracle (``moe.scan_chunk`` = a data shard's tokens)
    and holds each gradient leaf, gathered whole one at a time, to it;
    it returns the loss of each, the worst elementwise gap against the
    gate, the squared sums of the gaps and of the gradient, and whether
    the routing agrees."""
    from repro_torch.data.pipeline import SyntheticLM, local_batch
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import dp_axes
    w = TRAIN_MOE_MESH["witness"]
    cfg = train_cfg(MOE, n_layers=TRAIN_MOE_MESH["n_layers"],
                    param_dtype="float32", act_dtype="float32")
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=w["seq"],
                        global_batch=w["batch"], seed=1).batch_at(0)
    local = {k: v.cuda() for k, v in local_batch(batch, mesh, 1).items()}
    state = S.init_train_state(0, cfg, device="cuda", mesh=mesh)
    named = dict(state["params"].named_parameters())
    with S.train_mesh_context(mesh), MoECapture() as cap:
        loss_m, _, grads_m = S.loss_and_grads(cfg, state["params"], local)
    routing_m = moe_routing(torch, cfg, cap.calls, mesh)
    del cap
    out = dict(loss_mesh=float(loss_m))
    want = None
    if mesh.rank == 0:
        one = M.init_model(0, cfg, device="cuda").requires_grad_(True)
        oracle = grouped(cfg, w["batch"] // mesh.size(dp_axes(mesh))
                         * w["seq"])
        full = {k: v.cuda() for k, v in batch.items()}
        with MoECapture() as cap:
            loss_s, _, want = S.loss_and_grads(oracle, one, full)
        routing_s = moe_routing(torch, oracle, cap.calls)
        del one, cap
        out.update(loss_single=float(loss_s), routing_equal=len(
            routing_s) == len(routing_m) and all(
                torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                for a, b in zip(routing_s, routing_m)),
            dropped=sum(int((~r[1]).sum()) for r in routing_s),
            choices=sum(r[1].numel() for r in routing_s))
    worst, gap_sq, ref_sq, tol = 0.0, 0.0, 0.0, w["grad_tol"]
    for k in list(grads_m):
        g = C.gather_whole(grads_m.pop(k), named[k]._pspec, mesh)
        if want is not None:
            ref = want.pop(k)
            gap = (g - ref).abs()
            worst = max(worst, (gap / (tol + tol * ref.abs())).max().item())
            gap_sq += float((gap.double() ** 2).sum())
            ref_sq += float((ref.double() ** 2).sum())
        del g
    out.update(worst=worst, gap_sq=gap_sq, ref_sq=ref_sq)
    del state, named, want
    release(torch)
    C.barrier()
    return out


def moe_mesh_rank(rank, out_dir, single_tokens):
    """One rank of the MoE mesh world: [serve moe mesh full width] on a
    (1, 4) mesh, the float32 witnesses (moonshot on (2, 2), mixtral's
    ring on (1, 4)), then [train moe mesh] on (2, 2) (2 bf16 Trainer
    steps, then its float32 witness); its payload to ``out_dir``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import HostMesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {shape: HostMesh(shape, ("data", "model"))
              for shape in (MOE_MESH["serve"], MOE_MESH["witness"])}
    out = {"coords": {k: m.coords for k, m in meshes.items()}}
    t0 = time.time()
    out["serve"] = moe_mesh_serve(np, torch, meshes[MOE_MESH["serve"]],
                                  single_tokens)
    release(torch)
    out["serve_s"] = time.time() - t0
    t0 = time.time()
    out["witness"] = moe_mesh_witness(np, torch, meshes[MOE_MESH["witness"]])
    out["ring"] = swa_mesh_witness(np, torch, meshes[MOE_MESH["ring"]],
                                   out_dir)
    out["witness_s"] = time.time() - t0
    t0 = time.time()
    cfg = train_cfg(MOE, n_layers=TRAIN_MOE_MESH["n_layers"])
    out["train"], _ = train_mesh_bf16(torch, meshes[TRAIN_MOE_MESH["shape"]],
                                      cfg, TRAIN_MOE_MESH)
    release(torch)
    out["train_witness"] = train_moe_mesh_witness(
        np, torch, meshes[TRAIN_MOE_MESH["shape"]])
    out["train_s"] = time.time() - t0
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def moe_mesh_full_width(np, torch, single):
    """[serve moe mesh full width], the MoE float32 witnesses and [train
    moe mesh] in ONE world of 4 ranks sharing the card over gloo and the
    exchange arena (``moe_mesh_rank``).  ``single``: [serve moe full
    width]'s record (its paged tokens and drop share on one card).
    Gates: the serve run drained with every rank's tokens, stats and
    tick log bitwise equal and 0 switch launches and dispatch plans;
    moonshot's float32 logits within 1e-4 of one card's grouped oracle
    with equal routing, and at E / top_k of its plain path; mixtral's
    ring on the mesh within 1e-4 of one card past the window; the train
    steps bitwise equal on every rank and finite, 0 switch launches; the
    train witness's loss within 1e-5 relative, its gradients within 1e-4
    elementwise, equal routing."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import spawn_world
    ranks, top_k = 4, get_config(MOE).moe.top_k
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        spawn_world(moe_mesh_rank, ranks, (tmp, single["tokens"]),
                    backend="gloo", exchange_mib=MOE_MESH["exchange_mib"])
        log(f"  {ranks} ranks (gloo, one card, {MOE_MESH['exchange_mib']} "
            f"MiB arena slots) in {time.time() - t0:.1f} s")
        pay = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
               for r in range(ranks)]
    p0 = pay[0]
    # [serve moe mesh full width]
    sv = p0["serve"]
    same = ("tokens", "stats", "tick_log", "done", "launches", "plans",
            "share", "shares")
    for r, p in enumerate(pay[1:], 1):
        if any(p["serve"][k] != sv[k] for k in same):
            raise AssertionError(f"moe mesh serve: rank {r} disagrees with "
                                 "rank 0")
    if not sv["done"] or any(p["serve"]["launches"] or p["serve"]["plans"]
                             for p in pay):
        raise AssertionError(f"moe mesh serve: done {sv['done']}, switch "
                             f"launches {[p['serve']['launches'] for p in pay]}"
                             f", plans {[p['serve']['plans'] for p in pay]}")
    st, c = sv["stats"], sv["counts"]
    ticks = st["ticks"]
    n_tok = sum(len(t) for t in sv["tokens"])
    med = {ph: statistics.median(v) if v else 0.0
           for ph, v in sv["times"].items()}
    log(f"  [serve moe mesh full width] {MOE} uncut on a "
        f"{MOE_MESH['serve']} mesh ({sv['n_local']} parameters a rank, "
        f"drawn as shards in {sv['init_s']:.1f} s): {ticks} ticks "
        f"({len(sv['times']['decode'])} decode, {st['prefill_ticks']} "
        f"prefill); rank 0 ms per decode tick median {med['decode']:.2f}, "
        f"per prefill tick median {med['prefill']:.2f}; {n_tok} tokens in "
        f"{sv['wall']:.3f} s = {n_tok / sv['wall']:.1f} tokens/s; per tick "
        f"per rank {c['all_gather'] / ticks:.1f} all-gathers, "
        f"{c['all_reduce'] / ticks:.1f} all-reduces, "
        f"{c['reduce_scatter'] / ticks:.1f} reduce-scatters, "
        f"{c['staged'] / ticks:.1f} host stagings of "
        f"{c['staged_bytes'] / ticks / 2**20:.2f} MiB; every rank's tokens, "
        f"stats and tick log bitwise equal; 0 switch launches, 0 dispatch "
        f"plans; kv_bytes_resident {st['kv_bytes_resident']}")
    log("  peak memory per rank: " + ", ".join(
        f"{p['serve']['peak']} B ({p['serve']['peak'] / 2**30:.2f} GiB)"
        for p in pay))
    log(f"  one decode tick of {SCHED['batch']} slots: {sv['tick_ms']:.2f} "
        f"ms (host clock); {sv['slots']} slot(s) per expert: global drop "
        f"share {sv['share']:.4f} of the {SCHED['batch'] * top_k} expert "
        "choices "
        f"a layer (layers {min(sv['shares']):.4f} to "
        f"{max(sv['shares']):.4f}); one card {single['share']:.4f}")
    log(f"  bf16 tokens equal to one card's [serve moe full width] paged "
        f"run: {sv['agree']} of {n_tok} (not gated: the partial outputs' sum "
        "over model reassociates the combine; ROADMAP queue 3 f); rank 0's "
        f"part {p0['serve_s']:.1f} s")
    # the float32 witnesses
    wt, mw = p0["witness"], MOE_MESH_WITNESS
    for name in ("capacity", "E/top_k"):
        x = wt[name]
        if not (wt["finite"] and x["max_abs"] <= mw["tol"]
                and x["routing_equal"]):
            raise AssertionError(f"moe mesh float32 witness ({name}): max "
                                 f"|mesh - one card| {x['max_abs']:.3g}, "
                                 f"routing equal {x['routing_equal']}")
    log(f"  float32 witness, {MOE} at full widths cut to "
        f"{mw['n_layers']} layers on a {MOE_MESH['witness']} mesh, a "
        f"({mw['batch']}, {mw['seq'] - 1}) chunk and one decode step: at "
        f"capacity factor 1.25 within {wt['capacity']['max_abs']:.3g} of "
        f"one card's grouped oracle (<= {mw['tol']}), gate_idx and keep "
        f"equal ({wt['capacity']['dropped']} of "
        f"{wt['capacity']['choices']} choices dropped); at E/top_k within "
        f"{wt['E/top_k']['max_abs']:.3g} of one card's plain path, routing "
        "equal")
    rg, sw = p0["ring"], SWA_MESH_WITNESS
    want_pos = [sw["at"] + sw["decode"]]
    if not (all(p["ring"]["finite"] and p["ring"]["pos"] == want_pos
                for p in pay) and rg["vs_single"] <= sw["tol"]
            and rg["vs_forward"] <= 2e-3):
        raise AssertionError(f"mixtral ring on a mesh: {rg}")
    log(f"  float32 witness, {SWA} at full widths cut to "
        f"{sw['n_layers']} layers on a {MOE_MESH['ring']} mesh (a ring of "
        f"{rg['ring_rows']} rows and {rg['kv_local']} kv heads a rank): "
        f"{sw['decode']} decode steps past the window from one card's "
        f"prefill({sw['at']}) within {rg['vs_single']:.3g} of one card's "
        f"steps (<= {sw['tol']}) and {rg['vs_forward']:.3g} of "
        f"forward({sw['seq']}) (one card's own {rg['single_vs_forward']:.3g}"
        f"); rank 0's witnesses {p0['witness_s']:.1f} s")
    # [train moe mesh]
    b0, sh = p0["train"], TRAIN_MOE_MESH
    for r, p in enumerate(pay[1:], 1):
        b = p["train"]
        if b["history"] != b0["history"] or b["metrics"] != b0["metrics"]:
            raise AssertionError(f"train moe mesh: rank {r}'s history or "
                                 "metrics differ from rank 0's")
        for k, (axes, digest) in b["digests"].items():
            same_blk = all(p["coords"][sh["shape"]][a]
                           == p0["coords"][sh["shape"]][a] for a in axes)
            if same_blk and digest != b0["digests"][k][1]:
                raise AssertionError(f"train moe mesh: rank {r}'s {k} "
                                     "differs from rank 0's")
    if any(p["train"]["launches"] for p in pay):
        raise AssertionError("train moe mesh: switch launches")
    for h, m in zip(b0["history"], b0["metrics"]):
        if not all(np.isfinite([h["loss"], h["grad_norm"]])):
            raise AssertionError(f"train moe mesh: step {h['step']} not "
                                 "finite")
        log(f"  step {h['step']}: {h['dt'] * 1e3:.1f} ms (slowest rank), "
            f"loss {h['loss']:.4f}, " + ", ".join(
                f"{k} {v:.4g}" for k, v in m.items()))
    steps = len(b0["history"])
    ms = b0["history"][-1]["dt"] * 1e3
    c = b0["counts"]
    log(f"  [train moe mesh] {MOE} cut to {sh['n_layers']} layers at its "
        f"widths, bf16, remat, {sh['batch']} x {sh['seq']}, grad_accum "
        f"{sh['grad_accum']}, a {sh['shape']} mesh: {ms:.1f} ms a step "
        f"(step {steps}), {sh['batch'] * sh['seq'] / ms * 1e3:.0f} tokens/s"
        f"; per step per rank {c['all_gather'] / steps:.0f} all-gathers, "
        f"{c['all_reduce'] / steps:.0f} all-reduces, "
        f"{c['reduce_scatter'] / steps:.0f} reduce-scatters, "
        f"{c['staged'] / steps:.0f} host stagings of "
        f"{c['staged_bytes'] / steps / 2**30:.2f} GiB; 0 switch launches; "
        f"every rank's history, metrics and replicated leaves bitwise equal"
        f"; init {b0['init_s']:.1f} s, {steps} steps {b0['run_s']:.1f} s")
    log("  peak memory per rank: " + ", ".join(
        f"{p['train']['peak']} B ({p['train']['peak'] / 2**30:.2f} GiB)"
        for p in pay) + f"; {b0['n_local']} parameters a rank")
    tw, tt = p0["train_witness"], sh["witness"]
    rel = math.sqrt(tw["gap_sq"] / max(tw["ref_sq"], 1e-300))
    loss_gap = abs(tw["loss_mesh"] - tw["loss_single"])
    if not (loss_gap <= tt["loss_tol"] * abs(tw["loss_single"])
            and tw["worst"] <= 1.0 and tw["routing_equal"]
            and all(p["train_witness"]["loss_mesh"] == tw["loss_mesh"]
                    for p in pay)):
        raise AssertionError(f"train moe mesh float32 witness: loss gap "
                             f"{loss_gap:.3g}, worst gradient gap "
                             f"{tw['worst']:.3g} of the gate, routing equal "
                             f"{tw['routing_equal']}")
    log(f"  float32 witness ({sh['n_layers']} layers, {tt['batch']} x "
        f"{tt['seq']}, {tt['batch'] // sh['shape'][0]} rows a data shard): "
        f"loss {tw['loss_mesh']:.7f} (mesh) {tw['loss_single']:.7f} (one "
        f"card's grouped oracle), gap {loss_gap:.3g}; gradients within "
        f"{tw['worst']:.3g} of the 1e-4 elementwise gate, ||mesh - one "
        f"card|| / ||one card|| {rel:.3g}; routing equal "
        f"({tw['dropped']} of {tw['choices']} choices dropped); rank 0's "
        f"train part {p0['train_s']:.1f} s")


def one_group(arch) -> int:
    """The layers of one group of a hybrid (Mamba2 blocks + the shared
    block) or xLSTM (mLSTM blocks + the sLSTM block) config."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return cfg.attn_every if cfg.family == "hybrid" else cfg.ssm.slstm_every


def ssm_run(torch, cfg, params, prompts, backend, mesh):
    """The SSM mesh world's short stream through a DecodeServer (on
    ``mesh`` when given), tick scope: tokens, stats, tick log, the switch
    and sLSTM launches and the collectives counted from 0 after the
    server is built, the tick times."""
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.sharding import collectives as C
    srv = DecodeServer(cfg, params, options=ServeOptions(
        batch=SSM_STREAM["batch"], max_len=SSM_STREAM["max_len"],
        use_mcma_dispatch=True, backend=backend, route_scope="tick",
        mesh=mesh))
    torch.cuda.synchronize()
    zero_switch()
    K.slstm_scan.launches = 0
    C.reset_counts()
    reqs, st, times, wall, _ = drive(torch, srv, prompts,
                                     SSM_STREAM["max_new"])
    stats = st.asdict()
    stats.pop("wall_s")
    return dict(tokens=[list(r.out) for r in reqs],
                done=all(r.done and not r.aborted for r in reqs),
                stats=stats, tick_log=list(srv.tick_log),
                switch=switch_launches(), slstm=K.slstm_scan.launches,
                collectives=dict(C.COUNTS), times=times, wall=wall)


def ssm_mesh_serve(np, torch, arch, mesh):
    """[serve hybrid mesh full width] or [serve xlstm mesh full width],
    one rank: ``arch`` uncut, bf16, drawn as this rank's shards, MCMA at
    tick scope (the hybrid's shared block; the xLSTM has no ApproxFFN),
    the short stream through a mesh DecodeServer on each backend (the
    hybrid: both weight-switch kernels); then rank 0 serves the same
    stream on one card, for the tokens to compare (not gated)."""
    from repro_torch.models import model as M
    from repro_torch.sharding import collectives as C
    cfg = approx_cfg(arch, route_scope="tick")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    out = dict(init_s=time.time() - t0,
               n_local=sum(p.numel() for p in params.parameters()))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, SSM_STREAM["prompt_len"])
               .astype(np.int32) for _ in range(SSM_STREAM["n_requests"])]
    backends = ("pallas", "pallas_fused") if cfg.family == "hybrid" \
        else ("pallas",)
    out["runs"] = {b: ssm_run(torch, cfg, params, prompts, b, mesh)
                   for b in backends}
    out["peak"] = torch.cuda.max_memory_allocated()
    del params
    release(torch)
    C.barrier()
    if mesh.rank == 0:
        one = M.init_model(0, cfg, device="cuda")
        single = ssm_run(torch, cfg, one, prompts, "pallas", None)
        out["single"] = dict(tokens=single["tokens"],
                             decode_ms=statistics.median(
                                 single["times"]["decode"]))
        del one
        release(torch)
    C.barrier()
    return out


def ssm_decode_logits(torch, cfg, params, toks, mesh):
    """``toks`` (B, n) decoded one by one from an empty cache through the
    decode step at tick scope (on ``mesh`` under its serve context): each
    step's logits, float32, (B, n, V)."""
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    step = S.make_decode_step(cfg, use_mcma_dispatch=True,
                              route_scope="tick", backend="pallas")
    b, n = toks.shape
    out = []
    with S.serve_mesh_context(mesh):
        cache = M.init_cache(cfg, b, n, device="cuda")
        for j in range(n):
            lg, cache = step(params, cache, toks[:, j:j + 1])
            out.append(lg.float())
    torch.cuda.synchronize()
    return torch.stack(out, 1)


def ssm_block_outputs(torch, cfg, params, toks, mesh, feed=None):
    """One group's blocks of ``cfg`` (the hybrid's Mamba2 blocks then its
    shared block, exact FFN; the xLSTM's mLSTM blocks then its sLSTM
    block) decoding ``toks`` (B, n) one token a step from an empty cache
    (on ``mesh`` under its serve context, this rank's rows and heads).
    Each block takes the previous block's output, or with ``feed`` (the
    inputs one card recorded, {block: (B, n, d)}) that block's recorded
    input (teacher forcing).  Returns ({block: input}, {block: output}),
    each (B, n, d) float32 over the whole batch."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import P, dp_axes
    b, n = toks.shape
    ins, outs = {}, {}
    with S.serve_mesh_context(mesh), torch.no_grad():
        rows = slice(None) if mesh is None else C.local_rows(
            mesh, dp_axes(mesh), b)
        cache = M.init_cache(cfg, b, n, device="cuda")
        hybrid = cfg.family == "hybrid"
        core = params.mamba[0] if hybrid else params.mlstm[0]
        names = [f"{'mamba' if hybrid else 'mlstm'} {j}"
                 for j in range(len(core))] + \
            ["shared" if hybrid else "slstm"]
        x_tok = L.embed_fwd(cfg, params.embed, toks[rows])
        for t in range(n):
            x = x_tok[:, t:t + 1]
            for i, name in enumerate(names):
                if feed is not None:
                    x = feed[name][rows, t:t + 1].cuda()
                ins.setdefault(name, []).append(x)
                if name == "shared":
                    pos = torch.full((x.shape[0],), t, dtype=torch.int32,
                                     device=x.device)
                    x, _, _, _ = M._dense_block(
                        cfg, params.shared, x, pos[:, None],
                        M._layer_cache(cache, 0, pos))
                elif name == "slstm":
                    st = {k: v[0] for k, v in cache["slstm"].items()}
                    x, st = M._slstm_block(cfg, params.slstm[0], x, st)
                    for k, v in st.items():
                        cache["slstm"][k][0] = v
                else:
                    head = "mamba" if hybrid else "mlstm"
                    st = {k: v[0, i] for k, v in cache[head].items()}
                    fn = M._mamba_block if hybrid else M._mlstm_block
                    x, st = fn(cfg, core[i], x, st)
                    for k, v in st.items():
                        cache[head][k][0, i] = v
                outs.setdefault(name, []).append(x)
        whole = (lambda t: t) if mesh is None else \
            (lambda t: C.gather_whole(t.contiguous(), P(dp_axes(mesh)),
                                      mesh))
        pack = lambda d: {k: whole(torch.cat(v, 1)).float()
                          for k, v in d.items()}
        ins, outs = pack(ins), pack(outs)
    torch.cuda.synchronize()
    return ins, outs


def ssm_mesh_witness(np, torch, arch, mesh, out_dir):
    """The float32 witness of an SSM family on a mesh, one rank: ``arch``
    at its widths cut to one group, ``SSM_WITNESS``'s tokens decoded one
    by one from an empty cache on ``mesh``, end to end (through the
    decode step, no capacity clips) and block by block teacher-forced
    (each block fed the input it had on one card; the hybrid's shared
    block with its exact FFN).  Rank 0 also runs one card and returns the
    gaps: end to end, and each kind of block's largest."""
    from repro_torch.models import model as M
    from repro_torch.sharding import collectives as C
    w = SSM_WITNESS
    cfg = dataclasses.replace(
        approx_cfg(arch, route_scope="tick", **NO_CLIP),
        n_layers=one_group(arch), param_dtype="float32",
        act_dtype="float32")
    exact = dataclasses.replace(cfg, approx=dataclasses.replace(
        cfg.approx, enable=False))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (w["batch"], w["steps"])).astype(np.int32)).cuda()
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                               act_dtype="bfloat16")
    feed = f"{out_dir}/{arch}_feed.pt"
    out = {"layers": cfg.n_layers}
    if mesh.rank == 0:
        one = M.init_model(0, cfg, device="cuda")
        want = ssm_decode_logits(torch, cfg, one, toks, None)
        del one
        one = M.init_model(0, bf16, device="cuda")
        want_bf16 = ssm_decode_logits(torch, bf16, one, toks, None)
        del one
        one = M.init_model(0, exact, device="cuda")
        ins, want_blocks = ssm_block_outputs(torch, exact, one, toks, None)
        torch.save({k: v.cpu() for k, v in ins.items()}, feed)
        del one, ins
        release(torch)
    C.barrier()
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    got = ssm_decode_logits(torch, cfg, params, toks, mesh)
    del params
    params = M.init_model(0, exact, device="cuda", mesh=mesh)
    _, got_blocks = ssm_block_outputs(torch, exact, params, toks, mesh,
                                      feed=torch.load(feed))
    del params
    params = M.init_model(0, bf16, device="cuda", mesh=mesh)
    got_bf16 = ssm_decode_logits(torch, bf16, params, toks, mesh)
    del params
    release(torch)
    out["finite"] = bool(torch.isfinite(got).all()) and all(
        bool(torch.isfinite(v).all()) for v in got_blocks.values())
    if mesh.rank == 0:
        gaps = {}
        for name, v in got_blocks.items():
            kind = name.split()[0]
            gaps[kind] = max(gaps.get(kind, 0.0),
                             float((v - want_blocks[name]).abs().max()))
        out.update(max_abs=float((got - want).abs().max()),
                   scale=float(want.abs().max()),
                   tokens_equal=bool(torch.equal(got.argmax(-1),
                                                 want.argmax(-1))),
                   blocks=gaps,
                   bf16=dict(mesh=float((got_bf16 - want_bf16).abs().max()),
                             vs_f32=float((want_bf16 - want).abs().max()),
                             tokens=float((got_bf16.argmax(-1)
                                           == want_bf16.argmax(-1))
                                          .float().mean())))
    C.barrier()
    return out


def ssm_train_cfg(arch, **kw):
    """``arch`` cut to one group as [train ssm mesh] trains it: remat on;
    the hybrid with MCMA on its shared block (the ApproxFFN's
    co-training and the tick router, at TRAIN_ERROR_BOUND)."""
    cfg = train_cfg(arch, n_layers=one_group(arch), **kw)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, enable=True, route_scope="tick",
            error_bound=TRAIN_ERROR_BOUND))
    return cfg


def train_ssm_mesh_witness(np, torch, arch, mesh, w=None):
    """The float32 witness of [train ssm mesh], one rank: ``arch`` at its
    widths cut to one group, remat; ``loss_and_grads`` on ``mesh`` on the
    rank's rows of a small batch (``w``, default TRAIN_SSM_MESH's; a
    batch below the data axes: every row and the rank's slice of the
    positions, ``activations.sequence_split``).  Rank 0 also runs one
    card and holds
    each gradient leaf, gathered whole one at a time, to it: the loss of
    each, the squared sums of the gaps and of the gradient, the worst
    leaf's relative gap in norm and the worst elementwise gap against the
    gate."""
    from repro_torch.data.pipeline import SyntheticLM, local_batch
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    w = w or TRAIN_SSM_MESH["witness"]
    cfg = ssm_train_cfg(arch, param_dtype="float32", act_dtype="float32")
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=w["seq"],
                        global_batch=w["batch"], seed=1).batch_at(0)
    local = {k: v.cuda() for k, v in local_batch(batch, mesh, 1).items()}
    state = S.init_train_state(0, cfg, device="cuda", mesh=mesh)
    named = dict(state["params"].named_parameters())
    torch.cuda.synchronize()
    C.barrier()
    t0 = time.time()
    with S.train_mesh_context(mesh, w["batch"]):
        loss_m, _, grads_m = S.loss_and_grads(cfg, state["params"], local)
    torch.cuda.synchronize()
    out = dict(loss_mesh=float(loss_m),
               ms_mesh=C.world_max(time.time() - t0) * 1e3)
    want = None
    if mesh.rank == 0:
        one = M.init_model(0, cfg, device="cuda").requires_grad_(True)
        full = {k: v.cuda() for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.time()
        loss_s, _, want = S.loss_and_grads(cfg, one, full)
        torch.cuda.synchronize()
        out["ms_single"] = (time.time() - t0) * 1e3
        # the gradients' own rounding-level noise: one card again with
        # every parameter moved by a relative 1e-7 (seeded)
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in one.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen)
                       .to(p.device))
        _, _, moved = S.loss_and_grads(cfg, one, full)
        floor = [0.0, 0.0]
        for k, g in moved.items():
            floor[0] += float(((g - want[k]).double() ** 2).sum())
            floor[1] += float((want[k].double() ** 2).sum())
        del one, moved
        out.update(loss_single=float(loss_s),
                   floor=math.sqrt(floor[0] / max(floor[1], 1e-300)))
    worst, leaf, gap_sq, ref_sq, tol = 0.0, (0.0, ""), 0.0, 0.0, \
        w["grad_tol"]
    for k in list(grads_m):
        g = C.gather_whole(grads_m.pop(k), named[k]._pspec, mesh)
        if want is not None:
            ref = want.pop(k)
            gap = (g - ref).abs()
            worst = max(worst, (gap / (tol + tol * ref.abs())).max().item())
            g2, r2 = float((gap.double() ** 2).sum()), \
                float((ref.double() ** 2).sum())
            leaf = max(leaf, (math.sqrt(g2 / max(r2, 1e-300)), k))
            gap_sq += g2
            ref_sq += r2
        del g
    out.update(worst=worst, worst_leaf=leaf, gap_sq=gap_sq, ref_sq=ref_sq)
    del state, named, want
    release(torch)
    C.barrier()
    return out


def ssm_mesh_rank(rank, out_dir):
    """One rank of the SSM mesh world: [serve hybrid mesh full width] on
    (2, 2) and [serve xlstm mesh full width] on (1, 4), each with its
    float32 witness, then [train ssm mesh] on (2, 2) (2 bf16 Trainer
    steps of each family cut to one group, then its float32 witness); its
    payload to ``out_dir``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.launch.mesh import HostMesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = {SSM_MESH["hybrid"], SSM_MESH["xlstm"], TRAIN_SSM_MESH["shape"]}
    meshes = {s: HostMesh(s, ("data", "model")) for s in shapes}
    out = {"coords": {k: m.coords for k, m in meshes.items()}}
    for key, arch in (("hybrid", HYBRID), ("xlstm", "xlstm-1.3b")):
        mesh = meshes[SSM_MESH[key]]
        t0 = time.time()
        out[key] = ssm_mesh_serve(np, torch, arch, mesh)
        out[key]["witness"] = ssm_mesh_witness(np, torch, arch, mesh,
                                               out_dir)
        out[key]["s"] = time.time() - t0
    mesh = meshes[TRAIN_SSM_MESH["shape"]]
    for key, arch in (("hybrid", HYBRID), ("xlstm", "xlstm-1.3b")):
        t0 = time.time()
        K.slstm_scan.launches = 0
        run, _ = train_mesh_bf16(torch, mesh, ssm_train_cfg(arch),
                                 TRAIN_SSM_MESH)
        run["slstm"] = K.slstm_scan.launches
        release(torch)
        run["witness"] = train_ssm_mesh_witness(np, torch, arch, mesh)
        run["s"] = time.time() - t0
        out[f"train_{key}"] = run
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def ssm_mesh_full_width(np, torch):
    """[serve hybrid mesh full width], [serve xlstm mesh full width] and
    [train ssm mesh] in ONE world of 4 ranks sharing the card over gloo
    and the exchange arena (``ssm_mesh_rank``).  Gates: every rank's
    runs (tokens, stats, tick log, launches) bitwise equal; every request
    served; the hybrid's tokens equal across its two backends and each
    backend's kernel launched once a group a tick on every rank (9 a
    tick), the other not at all; the xLSTM's ``slstm_scan`` launched once
    a group a tick on every rank, no switch launch; the float32 witnesses
    block by block within 1e-4 of one card, and at one group end to end
    within 1e-4 of the logits' scale with equal greedy tokens (the
    bf16 gaps printed); the train steps
    bitwise equal on every rank and finite, the sLSTM's launches
    steps x 2 (remat) on every rank; the train witnesses' loss within
    1e-5 relative and their gradients within 1e-3 of one card's in norm
    (printed beside one card's own noise under a 1e-7 relative move of
    its parameters).
    Returns the kernels line's runs: {kernel: [run records]}."""
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models import model as M
    ranks, smi = 4, card_line()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        spawn_world(ssm_mesh_rank, ranks, (tmp,), backend="gloo",
                    exchange_mib=SSM_MESH["exchange_mib"])
        log(f"  {ranks} ranks (gloo, one card, {SSM_MESH['exchange_mib']} "
            f"MiB arena slots) in {time.time() - t0:.1f} s")
        pay = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
               for r in range(ranks)]
    p0 = pay[0]
    strip = lambda run: {k: v for k, v in run.items()
                         if k not in ("times", "wall")}
    by_run = {"switched_mlp": [], "switched_mlp_fused": [], "slstm_scan": []}
    kernel_of = {"pallas": "switched_mlp",
                 "pallas_fused": "switched_mlp_fused"}
    for key, arch in (("hybrid", HYBRID), ("xlstm", "xlstm-1.3b")):
        shape, sv = SSM_MESH[key], p0[key]
        groups = M.topology(approx_cfg(arch)).n_groups
        for r, p in enumerate(pay[1:], 1):
            for b in sv["runs"]:
                if strip(p[key]["runs"][b]) != strip(sv["runs"][b]):
                    raise AssertionError(f"{key} mesh {b}: rank {r} "
                                         "disagrees with rank 0")
        for b, run in sv["runs"].items():
            ticks = run["stats"]["ticks"]
            want = groups * ticks
            mine = run["switch"] if key == "hybrid" else run["slstm"]
            other = run["slstm"] if key == "hybrid" else run["switch"]
            if not run["done"] or mine != want or other:
                raise AssertionError(
                    f"{key} mesh {b}: done {run['done']}, launches {mine} "
                    f"(want {groups} x {ticks}), other kernels {other}")
            kern = kernel_of[b] if key == "hybrid" else "slstm_scan"
            by_run[kern].append(dict(
                run=f"{arch} mesh {shape} {b}, all ranks", ticks=ticks,
                launches=ranks * mine, per_rank=mine))
            col = run["collectives"]
            med = statistics.median(run["times"]["decode"])
            n_tok = sum(len(t) for t in run["tokens"])
            single = sv["single"]
            agree = sum(x == y for a, c in zip(run["tokens"],
                                               single["tokens"])
                        for x, y in zip(a, c))
            log(f"  [serve {key} mesh full width] {arch} uncut on a {shape} "
                f"mesh ({sv['n_local']} parameters a rank, drawn as shards "
                f"in {sv['init_s']:.1f} s), {b}: {ticks} ticks (prompts "
                f"token by token, {run['stats']['prefill_ticks']} prefill); "
                f"rank 0 ms per tick median {med:.2f} (one card "
                f"{single['decode_ms']:.2f}); {n_tok} tokens in "
                f"{run['wall']:.3f} s = {n_tok / run['wall']:.1f} tokens/s; "
                f"{kern} launches per rank {mine} = {groups} x {ticks}; per "
                f"tick per rank {col['all_gather'] / ticks:.1f} all-gathers, "
                f"{col['gather_for_split'] / ticks:.1f} gathers for heads, "
                f"{col['all_reduce'] / ticks:.1f} all-reduces, "
                f"{col['staged'] / ticks:.1f} host stagings of "
                f"{col['staged_bytes'] / ticks / 2**20:.2f} MiB; every "
                f"rank's tokens, stats and tick log bitwise equal; bf16 "
                f"tokens equal to one card's: {agree} of {n_tok} (not "
                f"gated); {smi}")
        if key == "hybrid" and sv["runs"]["pallas"]["tokens"] != \
                sv["runs"]["pallas_fused"]["tokens"]:
            raise AssertionError("hybrid mesh: tokens differ between "
                                 "pallas and pallas_fused")
        log("  peak memory per rank: " + ", ".join(
            f"{p[key]['peak']} B ({p[key]['peak'] / 2**30:.2f} GiB)"
            for p in pay) + f"; {smi}")
        wt, tol = sv["witness"], SSM_WITNESS["tol"]
        # block by block within tol; end to end within tol of the logits'
        # scale (at this random init they reach about 5, and a one-group
        # stack amplifies the mesh's other summation order: ROADMAP queue
        # 3 k)
        if not (all(p[key]["witness"]["finite"] for p in pay)
                and max(wt["blocks"].values()) <= tol
                and wt["max_abs"] <= tol * wt["scale"]
                and wt["tokens_equal"]):
            raise AssertionError(f"{key} mesh float32 witness: {wt}")
        log(f"  float32 witness, {arch} at its widths cut to one group "
            f"({wt['layers']} layers) on a {shape} mesh, "
            f"{SSM_WITNESS['batch']} rows decoded {SSM_WITNESS['steps']} "
            f"tokens one by one from an empty cache: block by block "
            f"(teacher-forced, each fed its input on one card) within "
            + ", ".join(f"{k} {v:.3g}" for k, v in wt["blocks"].items())
            + f" of one card's (<= {tol}); end to end through the decode "
            f"step within {wt['max_abs']:.3g} = "
            f"{wt['max_abs'] / wt['scale']:.3g} of the logits' scale "
            f"{wt['scale']:.3g} (<= {tol}), greedy tokens equal; in bf16 "
            f"the mesh {wt['bf16']['mesh']:.3g} from one card's logits "
            f"(one card's bf16 {wt['bf16']['vs_f32']:.3g} from its float32"
            f"), greedy tokens {wt['bf16']['tokens']:.3f} equal (printed); "
            f"rank 0's part {sv['s']:.1f} s")
    sh = TRAIN_SSM_MESH
    for key, arch in (("hybrid", HYBRID), ("xlstm", "xlstm-1.3b")):
        name = f"train_{key}"
        b0 = p0[name]
        for r, p in enumerate(pay[1:], 1):
            b = p[name]
            if b["history"] != b0["history"] or b["metrics"] != b0["metrics"]:
                raise AssertionError(f"train ssm mesh {key}: rank {r}'s "
                                     "history or metrics differ")
            for k, (axes, digest) in b["digests"].items():
                same_blk = all(p["coords"][sh["shape"]][a]
                               == p0["coords"][sh["shape"]][a] for a in axes)
                if same_blk and digest != b0["digests"][k][1]:
                    raise AssertionError(f"train ssm mesh {key}: rank {r}'s "
                                         f"{k} differs from rank 0's")
        steps = len(b0["history"])
        want_slstm = steps * sh["grad_accum"] * 2 if key == "xlstm" else 0
        if any(p[name]["slstm"] != want_slstm for p in pay) or \
                (key == "xlstm" and any(p[name]["launches"] for p in pay)):
            raise AssertionError(
                f"train ssm mesh {key}: slstm launches "
                f"{[p[name]['slstm'] for p in pay]} (want {want_slstm}), "
                f"switch {[p[name]['launches'] for p in pay]}")
        if want_slstm:
            by_run["slstm_scan"].append(dict(
                run=f"{arch} train mesh {sh['shape']}, all ranks",
                steps=steps, launches=ranks * want_slstm,
                per_rank=want_slstm))
        for h, m in zip(b0["history"], b0["metrics"]):
            if not all(np.isfinite([h["loss"], h["grad_norm"]])):
                raise AssertionError(f"train ssm mesh {key}: step "
                                     f"{h['step']} not finite")
            log(f"  step {h['step']}: {h['dt'] * 1e3:.1f} ms (slowest "
                f"rank), loss {h['loss']:.4f}, " + ", ".join(
                    f"{k} {v:.4g}" for k, v in m.items()))
        ms = b0["history"][-1]["dt"] * 1e3
        c = b0["counts"]
        log(f"  [train ssm mesh] {arch} cut to one group "
            f"({one_group(arch)} layers) at its widths, bf16, remat, "
            f"{sh['batch']} x {sh['seq']}, grad_accum {sh['grad_accum']}, "
            f"a {sh['shape']} mesh: {ms:.1f} ms a step (step {steps}), "
            f"{sh['batch'] * sh['seq'] / ms * 1e3:.0f} tokens/s; per step "
            f"per rank {c['all_gather'] / steps:.0f} all-gathers, "
            f"{c['gather_for_split'] / steps:.0f} gathers for heads, "
            f"{c['all_reduce'] / steps:.0f} all-reduces, "
            f"{c['reduce_scatter'] / steps:.0f} reduce-scatters, "
            f"{c['staged'] / steps:.0f} host stagings of "
            f"{c['staged_bytes'] / steps / 2**30:.3f} GiB; slstm_scan "
            f"launches per rank {b0['slstm']}, switch {b0['launches']}; "
            f"every rank's history, metrics and replicated leaves bitwise "
            f"equal; init {b0['init_s']:.1f} s; {smi}")
        log("  peak memory per rank: " + ", ".join(
            f"{p[name]['peak']} B ({p[name]['peak'] / 2**30:.2f} GiB)"
            for p in pay) + f"; {b0['n_local']} parameters a rank")
        tw, tt = b0["witness"], sh["witness"]
        rel = math.sqrt(tw["gap_sq"] / max(tw["ref_sq"], 1e-300))
        loss_gap = abs(tw["loss_mesh"] - tw["loss_single"])
        if not (loss_gap <= tt["loss_tol"] * abs(tw["loss_single"])
                and rel <= tt["norm_tol"]
                and all(p[name]["witness"]["loss_mesh"] == tw["loss_mesh"]
                        for p in pay)):
            raise AssertionError(f"train ssm mesh {key} float32 witness: "
                                 f"loss gap {loss_gap:.3g}, gradients "
                                 f"{rel:.3g} off in norm (worst leaf "
                                 f"{tw['worst_leaf']}, the noise floor "
                                 f"{tw['floor']:.3g})")
        log(f"  float32 witness ({tt['batch']} x {tt['seq']}, "
            f"{tt['batch'] // sh['shape'][0]} rows a data shard): loss "
            f"{tw['loss_mesh']:.7f} (mesh) {tw['loss_single']:.7f} (one "
            f"card), gap {loss_gap:.3g}; ||mesh - one card|| / ||one card|| "
            f"{rel:.3g} (<= {tt['norm_tol']}; one card's own under a 1e-7 "
            f"relative move of its parameters {tw['floor']:.3g}), worst leaf "
            f"{tw['worst_leaf'][1]} {tw['worst_leaf'][0]:.3g}, worst element "
            f"{tw['worst']:.3g} of the {tt['grad_tol']} elementwise band "
            f"(printed); rank 0's part {b0['s']:.1f} s")
    return by_run


def narrow_dense_witness(np, torch, mesh):
    """internlm2 at full widths cut to 2 layers, float32, no-clip: a
    (batch, seq - 1) chunk then one decode step (``mesh_witness_logits``:
    the chunk gathers each rank's kv head, the decode exchanges partial
    scores) on the mesh; rank 0 also on one card.  Returns the mesh
    logits' digest (every rank) and the gap (rank 0)."""
    import hashlib

    from repro_torch.models import model as M
    from repro_torch.sharding import collectives as C
    w = NARROW_WITNESS
    cfg = dataclasses.replace(
        approx_cfg("internlm2-1.8b", **NO_CLIP), n_layers=w["n_layers"],
        param_dtype="float32", act_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (w["batch"], w["seq"])).astype(np.int32)).cuda()
    out = {}
    if mesh.rank == 0:
        one = M.init_model(0, cfg, device="cuda")
        single = mesh_witness_logits(torch, cfg, one, None, toks)
        del one
        release(torch)
    C.barrier()
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    got = mesh_witness_logits(torch, cfg, params, mesh, toks)
    out["digest"] = hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()
    out["finite"] = bool(torch.isfinite(got).all())
    if mesh.rank == 0:
        out["max_abs"] = float((got - single).abs().max())
        out["scale"] = float(single.abs().max())
    del params
    release(torch)
    C.barrier()
    return out


def narrow_mesh_rank(rank, out_dir):
    """One rank of [narrow mesh full width] on a (1, 16) mesh: internlm2
    (4 layers, bf16, drawn as this rank's shards) on the scheduler's
    stream through both switch kernels, its float32 witness; mixtral (2
    layers) on the short stream, its ring's float32 witness, one bf16
    Trainer step; the payload to ``out_dir``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import model as M
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = HostMesh(NARROW["shape"], ("data", "model"))
    out = {"coords": mesh.coords, "runs": {}, "s": {}}
    t0 = time.time()
    cfg = dataclasses.replace(approx_cfg("internlm2-1.8b"),
                              n_layers=NARROW["dense_layers"])
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    out["n_local"] = sum(p.numel() for p in params.parameters())
    prompts = stream_prompts(np, cfg)
    for b in ("pallas", "pallas_fused"):
        out["runs"][b] = mesh_run(torch, np, cfg, params, prompts, b, mesh,
                                  max_new=NARROW["max_new"])
    del params
    release(torch)
    out["s"]["dense"] = time.time() - t0
    t0 = time.time()
    out["dense_witness"] = narrow_dense_witness(np, torch, mesh)
    out["ring"] = swa_mesh_witness(np, torch, mesh, out_dir)
    out["s"]["witness"] = time.time() - t0
    t0 = time.time()
    from repro_torch.configs.registry import get_config
    swa = dataclasses.replace(
        get_config(SWA), n_layers=NARROW["swa_layers"],
        approx=dataclasses.replace(get_config(SWA).approx, enable=True))
    params = M.init_model(0, swa, device="cuda", mesh=mesh)
    out["swa_n_local"] = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, swa.vocab, SSM_STREAM["prompt_len"])
               .astype(np.int32) for _ in range(SSM_STREAM["n_requests"])]
    out["swa"] = ssm_run(torch, swa, params, prompts, "pallas", mesh)
    del params
    release(torch)
    out["s"]["swa"] = time.time() - t0
    t0 = time.time()
    out["train"], _ = train_mesh_bf16(
        torch, mesh, train_cfg(SWA, n_layers=NARROW["swa_layers"]),
        TRAIN_NARROW)
    release(torch)
    out["s"]["train"] = time.time() - t0
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def narrow_mesh_full_width(np, torch):
    """[narrow mesh full width]: tensor parallelism below one kv head and
    one expert a rank, ONE world of 16 ranks sharing the card over gloo
    and the exchange arena (``narrow_mesh_rank``).  Gates: every rank's
    tokens, stats, tick logs, launches and train history bitwise equal;
    internlm2's runs drained, each rank launching its backend's kernel
    once a layer a tick, both backends' tokens equal; mixtral's stream
    drained and its train step finite, 0 switch launches; the float32
    witnesses within 1e-4 of one card (internlm2's logits bitwise equal
    on every rank).  Returns the kernels line's runs."""
    from repro_torch.launch.mesh import spawn_world
    shape = NARROW["shape"]
    ranks = shape[0] * shape[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        spawn_world(narrow_mesh_rank, ranks, (tmp,), backend="gloo",
                    exchange_mib=NARROW["exchange_mib"])
        log(f"  {ranks} ranks on a {shape} mesh (gloo, one card, "
            f"{NARROW['exchange_mib']} MiB arena slots) in "
            f"{time.time() - t0:.1f} s")
        pay = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
               for r in range(ranks)]
    p0 = pay[0]
    log("  rank 0's parts: " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in p0["s"].items()))
    strip = lambda run: {k: v for k, v in run.items()
                         if k not in ("times", "wall")}
    for r, p in enumerate(pay[1:], 1):
        pairs = [(f"{b} {k}", v, p0["runs"][b][k])
                 for b in p0["runs"] for k, v in strip(p["runs"][b]).items()]
        pairs += [(f"mixtral {k}", v, p0["swa"][k])
                  for k, v in strip(p["swa"]).items()]
        pairs += [(f"train {k}", p["train"][k], p0["train"][k])
                  for k in ("history", "metrics")]
        pairs.append(("witness", p["dense_witness"]["digest"],
                      p0["dense_witness"]["digest"]))
        differ = [name for name, a, b in pairs if a != b]
        if differ:
            raise AssertionError(f"narrow mesh: rank {r} disagrees with "
                                 f"rank 0 on {differ}")
        for k, (axes, digest) in p["train"]["digests"].items():
            if all(p["coords"][a] == p0["coords"][a] for a in axes) \
                    and digest != p0["train"]["digests"][k][1]:
                raise AssertionError(f"narrow mesh train: rank {r}'s {k} "
                                     "differs from rank 0's")
    layers = NARROW["dense_layers"]
    by_run = {}
    for b, run in p0["runs"].items():
        ticks = run["stats"]["ticks"]
        launches = [p["runs"][b]["launches"] for p in pay]
        if not run["done"] or any(n != layers * ticks for n in launches):
            raise AssertionError(f"narrow mesh {b}: done {run['done']}, "
                                 f"launches per rank {launches} (want "
                                 f"{layers * ticks})")
        med = {ph: statistics.median(v) if v else 0.0
               for ph, v in run["times"].items()}
        n_tok = sum(len(t) for t in run["tokens"])
        col = run["collectives"]
        log(f"  internlm2-1.8b, {layers} of 24 layers, bf16, {b}: {ticks} "
            f"ticks ({run['stats']['prefill_ticks']} prefill); rank 0 ms "
            f"per decode tick median {med['decode']:.2f}, per prefill tick "
            f"median {med['prefill']:.2f}; {n_tok} tokens in "
            f"{run['wall']:.3f} s = {n_tok / run['wall']:.1f} tokens/s; "
            f"per tick per rank {col['all_gather'] / ticks:.1f} all-gathers,"
            f" {col['all_reduce'] / ticks:.1f} all-reduces, "
            f"{col['reduce_scatter'] / ticks:.1f} reduce-scatters, "
            f"{col['all_to_all'] / ticks:.1f} all-to-alls, "
            f"{col['gather_for_split'] / ticks:.1f} k/v gathers, "
            f"{col['staged'] / ticks:.1f} host stagings of "
            f"{col['staged_bytes'] / ticks / 2**20:.2f} MiB; switch "
            f"launches per rank {launches[0]} ({layers} a tick, every "
            f"rank); invocation {run['stats']['invocation_rate']:.4f}; "
            f"kv_bytes_resident {run['stats']['kv_bytes_resident']}")
        by_run[b] = dict(run=f"narrow mesh {shape} internlm2 {b}, all "
                         "ranks", ticks=ticks, launches=sum(launches),
                         per_rank=launches[0])
    if p0["runs"]["pallas"]["tokens"] != p0["runs"]["pallas_fused"]["tokens"]:
        raise AssertionError("narrow mesh: the two backends' tokens differ")
    log(f"  both backends' tokens equal; {p0['n_local']} parameters a rank; "
        f"rank 0's internlm2 part {p0['s']['dense']:.1f} s")
    dw = p0["dense_witness"]
    if not (all(p["dense_witness"]["finite"] for p in pay)
            and dw["max_abs"] <= NARROW_WITNESS["tol"]):
        raise AssertionError(f"narrow mesh internlm2 float32 witness: max "
                             f"|mesh - one card| {dw['max_abs']:.3g}")
    log(f"  float32 witness, internlm2 at full widths cut to "
        f"{NARROW_WITNESS['n_layers']} layers, a ({NARROW_WITNESS['batch']},"
        f" {NARROW_WITNESS['seq'] - 1}) chunk then one decode step: logits "
        f"within {dw['max_abs']:.3g} of one card's (<= "
        f"{NARROW_WITNESS['tol']}; logits up to {dw['scale']:.3g}), every "
        f"rank's bitwise equal")
    rg, sw = p0["ring"], SWA_MESH_WITNESS
    if not (all(p["ring"]["finite"] for p in pay)
            and rg["vs_single"] <= sw["tol"] and rg["vs_forward"] <= 2e-3):
        raise AssertionError(f"narrow mesh mixtral ring witness: {rg}")
    log(f"  float32 witness, {SWA} at full widths cut to {sw['n_layers']} "
        f"layers (a ring of {rg['ring_rows']} rows, {rg['kv_local']} kv "
        f"heads of head_dim / {shape[1]} a rank): {sw['decode']} decode "
        f"steps past "
        f"the window within {rg['vs_single']:.3g} of one card's (<= "
        f"{sw['tol']}) and {rg['vs_forward']:.3g} of forward({sw['seq']}) "
        f"(one card's own {rg['single_vs_forward']:.3g}); rank 0's "
        f"witnesses {p0['s']['witness']:.1f} s")
    sv = p0["swa"]
    if not sv["done"] or any(p["swa"]["switch"] for p in pay):
        raise AssertionError(f"narrow mesh mixtral stream: done "
                             f"{sv['done']}, launches "
                             f"{[p['swa']['switch'] for p in pay]}")
    ticks, c = sv["stats"]["ticks"], sv["collectives"]
    med = statistics.median(sv["times"]["decode"] or [0.0])
    log(f"  {SWA}, {NARROW['swa_layers']} of 32 layers, bf16, "
        f"TP-in-expert ({p0['swa_n_local']} parameters a rank): {ticks} "
        f"ticks, rank 0 ms per tick median {med:.2f}; per tick per rank "
        f"{c['all_gather'] / ticks:.1f} all-gathers, "
        f"{c['all_reduce'] / ticks:.1f} all-reduces, "
        f"{c['reduce_scatter'] / ticks:.1f} reduce-scatters, "
        f"{c['all_to_all'] / ticks:.1f} all-to-alls, "
        f"{c['staged'] / ticks:.1f} host stagings of "
        f"{c['staged_bytes'] / ticks / 2**20:.2f} MiB; 0 switch launches; "
        f"rank 0's part {p0['s']['swa']:.1f} s")
    tr, sh = p0["train"], TRAIN_NARROW
    if any(p["train"]["launches"] for p in pay) or not all(
            np.isfinite([h["loss"], h["grad_norm"]]).all()
            for h in tr["history"]):
        raise AssertionError(
            f"narrow mesh train: {tr['history']}, launches "
            f"{[p['train']['launches'] for p in pay]}")
    ms = tr["history"][-1]["dt"] * 1e3
    c = tr["counts"]
    log(f"  [train] {SWA} cut to {NARROW['swa_layers']} layers, bf16, remat,"
        f" {sh['batch']} x {sh['seq']}: {ms:.1f} ms a step (slowest rank), "
        f"loss {tr['history'][-1]['loss']:.4f}; per step per rank "
        f"{c['all_gather']} all-gathers, {c['all_reduce']} all-reduces, "
        f"{c['reduce_scatter']} reduce-scatters, {c['staged']} host "
        f"stagings of {c['staged_bytes'] / 2**30:.2f} GiB; 0 switch "
        f"launches; every rank's history and shared leaves bitwise equal; "
        f"init {tr['init_s']:.1f} s, rank 0's part {p0['s']['train']:.1f} s")
    log("  peak memory per rank (train): " + ", ".join(
        f"{p['train']['peak'] / 2**30:.2f}" for p in pay) + " GiB")
    return by_run


def long_cfg(arch, dtype, **over):
    """``arch`` at full width in ``dtype`` (the hybrid with MCMA at tick
    scope on its shared block), ``over`` replacing config fields."""
    from repro_torch.configs.registry import get_config
    cfg = approx_cfg(arch, route_scope="tick") if arch == HYBRID \
        else get_config(arch)
    return dataclasses.replace(cfg, param_dtype=dtype, act_dtype=dtype,
                               **over)


def long_cache(torch, cfg, rows: int, pos: int, mesh=None, seed=11):
    """A batch-1 decode cache of ``rows`` k/v rows at position ``pos``
    holding seeded random values: on ``mesh`` this rank's shard (as
    ``rules.cache_pspecs`` places a batch below the data axes: the
    sequence over them), else whole.  The k/v are drawn LONG["fill"]
    positions at a time, each draw from its own generator, so a rank
    draws only its slice's positions and one card draws them all; a
    hybrid's Mamba2 state is drawn whole and cut."""
    from repro_torch.models import model as M
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import cache_pspecs
    meta = M.init_cache(cfg, 1, rows, device="meta")
    specs = None if mesh is None else cache_pspecs(mesh, meta)
    fill, out = LONG["fill"], {}
    for name in ("k", "v"):
        g_n, _, s, kv, hd = meta[name].shape
        spec = (None,) * 5 if specs is None else specs[name]
        seq, heads, dims = slice(0, s), slice(None), slice(None)
        if spec[2] is not None:
            n = s // mesh.size(spec[2])
            seq = slice(mesh.index(spec[2]) * n, (mesh.index(spec[2]) + 1)
                        * n)
        if spec[3] is not None:
            n = kv // mesh.size("model")
            heads = slice(mesh.index("model") * n,
                          (mesh.index("model") + 1) * n)
        if spec[4] is not None:
            n = hd // mesh.size("model")
            dims = slice(mesh.index("model") * n,
                         (mesh.index("model") + 1) * n)
        shard = torch.empty((g_n, 1, seq.stop - seq.start,
                             len(range(kv)[heads]), len(range(hd)[dims])),
                            dtype=cfg.adtype, device="cuda")
        for g in range(g_n):
            for a in range(seq.start - seq.start % fill, seq.stop, fill):
                gen = torch.Generator(device="cuda").manual_seed(
                    seed * 1_000_003 + g * 7919 + a // fill * 2
                    + (name == "v"))
                blk = torch.randn((fill, kv, hd), generator=gen,
                                  device="cuda")[:, heads, dims]
                lo, hi = max(a, seq.start), min(a + fill, seq.stop)
                shard[g, 0, lo - seq.start:hi - seq.start] = \
                    blk[lo - a:hi - a].to(cfg.adtype)
        out[name] = shard
    if "mamba" in meta:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        h = 0.1 * torch.randn(meta["mamba"]["h"].shape, generator=gen,
                              device="cuda")
        out["mamba"] = {"h": h if mesh is None else C.shard_tensor(
            mesh, h, specs["mamba"]["h"])}
    out["pos"] = torch.full((1,), pos, dtype=torch.int32, device="cuda")
    return out


def long_decode(torch, cfg, params, cache, tok, steps, backend, mesh):
    """``steps`` greedy decode steps at batch 1 from ``tok`` (1, 1)
    through the decode step (on ``mesh`` under its serve context): each
    step's float32 logits (steps, V), the tokens, the host ms of each
    step, and the kernels launched."""
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    mcma = cfg.approx.enable
    step = S.make_decode_step(cfg, use_mcma_dispatch=mcma,
                              route_scope="tick" if mcma else None,
                              backend=backend if mcma else None)
    zero_switch()
    K.slstm_scan.launches = 0
    C.reset_counts()
    logits, toks, ms = [], [], []
    with S.serve_mesh_context(mesh), torch.no_grad():
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = step(params, cache, tok)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            tok = lg.argmax(-1).to(torch.int32)[:, None]
            logits.append(lg[0].float())
            toks.append(int(tok[0, 0]))
    return dict(logits=torch.stack(logits), tokens=toks, ms=ms,
                switch=switch_launches(), slstm=K.slstm_scan.launches,
                collectives=dict(C.COUNTS))


def long_xlstm_serve(np, torch, mesh=None):
    """xlstm-1.3b uncut, float32, one request through a DecodeServer of
    one slot (on ``mesh``: every rank's params drawn as its shards, the
    row whole on both data ranks, the heads 2 ranks each): tokens, tick
    times, sLSTM launches, collectives."""
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.models import model as M
    from repro_torch.runtime.options import ServeOptions
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.sharding import collectives as C
    cfg = long_cfg("xlstm-1.3b", "float32")
    t0 = time.time()
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    out = dict(init_s=time.time() - t0,
               n_local=sum(p.numel() for p in params.parameters()))
    srv = DecodeServer(cfg, params, options=ServeOptions(
        batch=1, max_len=LONG["max_len"], mesh=mesh))
    prompt = np.random.default_rng(12).integers(
        0, cfg.vocab, LONG["xlstm_prompt"]).astype(np.int32)
    torch.cuda.synchronize()
    K.slstm_scan.launches = 0
    C.reset_counts()
    reqs, st, times, wall, _ = drive(torch, srv, [prompt],
                                     LONG["xlstm_new"])
    out.update(tokens=list(reqs[0].out), done=reqs[0].done,
               ticks=st["ticks"], times=times["decode"], wall=wall,
               slstm=K.slstm_scan.launches, collectives=dict(C.COUNTS),
               state={k: v.cpu() for k, v in srv.cache["slstm"].items()})
    del srv, params
    release(torch)
    return out


def long_witness(np, torch, arch, mesh):
    """The float32 witness of ``arch`` at one group and batch 1 (below the
    data axes): LONG["steps"] tokens decoded one by one from an empty
    cache on ``mesh``; rank 0 also on one card.  Returns the logits'
    digest, finiteness, the steps' launches and, on rank 0, the gap."""
    import hashlib

    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    cfg = long_cfg(arch, "float32", n_layers=one_group(arch))
    if cfg.approx.enable:
        cfg = dataclasses.replace(cfg, approx=dataclasses.replace(
            cfg.approx, **NO_CLIP))
    n = LONG["steps"]
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (1, n)).astype(np.int32)).cuda()

    def run(params, mesh):
        step = S.make_decode_step(cfg, use_mcma_dispatch=cfg.approx.enable,
                                  route_scope="tick")
        lgs = []
        with S.serve_mesh_context(mesh), torch.no_grad():
            cache = M.init_cache(cfg, 1, n + n % 2, device="cuda")
            for j in range(n):
                lg, cache = step(params, cache, toks[:, j:j + 1])
                lgs.append(lg.float())
        return torch.cat(lgs)
    out = {}
    if mesh.rank == 0:
        one = M.init_model(0, cfg, device="cuda")
        single = run(one, None)
        del one
        release(torch)
    C.barrier()
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    zero_switch()
    from repro_torch.kernels import slstm_scan as K
    K.slstm_scan.launches = 0
    got = run(params, mesh)
    out.update(digest=hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest(),
               finite=bool(torch.isfinite(got).all()),
               switch=switch_launches(), slstm=K.slstm_scan.launches)
    if mesh.rank == 0:
        out.update(max_abs=float((got - single).abs().max()),
                   scale=float(single.abs().max()))
    del params
    release(torch)
    C.barrier()
    return out


def long_zamba2(np, torch, mesh=None):
    """zamba2-2.7b's tick at long_500k (on ``mesh`` the rank's shards):
    bf16 at LONG["zamba2_groups"] groups on both switch kernels (the
    Mamba2 states and the write restored between them), then float32 at
    one group; each against a cache of LONG["ctx"] rows at position
    ctx - 1, filled with seeded random k/v.  Returns each run's logits,
    token, ms and launches, and the fill's seconds."""
    from repro_torch.models import model as M
    from repro_torch.sharding import collectives as C
    out = {}
    runs = [("bf16", "bfloat16", LONG["zamba2_groups"],
             ("pallas", "pallas_fused")), ("f32", "float32", 1, ("pallas",))]
    for key, dtype, groups, backends in runs:
        cfg = long_cfg(HYBRID, dtype, n_layers=groups * one_group(HYBRID))
        params = M.init_model(0, cfg, device="cuda", mesh=mesh)
        t0 = time.time()
        cache = long_cache(torch, cfg, LONG["ctx"], LONG["ctx"] - 1, mesh)
        torch.cuda.synchronize()
        out[f"{key}_fill_s"] = time.time() - t0
        out[f"{key}_cache_bytes"] = sum(
            v.numel() * v.element_size() for k, v in cache.items()
            if k in ("k", "v"))
        keep = cache["mamba"]["h"].clone()
        tok = torch.full((1, 1), 7, dtype=torch.int32, device="cuda")
        for b in backends:
            cache["mamba"]["h"].copy_(keep)
            cache["pos"].fill_(LONG["ctx"] - 1)
            r = long_decode(torch, cfg, params, cache, tok, 1, b, mesh)
            r["logits"] = r["logits"].cpu()
            out[key, b] = r
        del params, cache, keep
        release(torch)
        if mesh is not None:
            C.barrier()
    return out


def long_swa(np, torch, mesh=None):
    """mixtral-8x7b at LONG["swa_layers"] layers, float32: its ring of
    4096 rows (on ``mesh`` split over the data axes) holding seeded
    random k/v at position LONG["swa_pos"], past long_500k's 524,288;
    LONG["swa_steps"] greedy decode steps."""
    from repro_torch.models import model as M
    cfg = long_cfg(SWA, "float32", n_layers=LONG["swa_layers"])
    params = M.init_model(0, cfg, device="cuda", mesh=mesh)
    cache = long_cache(torch, cfg, cfg.sliding_window, LONG["swa_pos"],
                       mesh, seed=17)
    tok = torch.full((1, 1), 11, dtype=torch.int32, device="cuda")
    out = long_decode(torch, cfg, params, cache, tok, LONG["swa_steps"],
                      None, mesh)
    out["logits"] = out["logits"].cpu()
    out["ring_local"] = tuple(cache["k"].shape)
    del params, cache
    release(torch)
    return out


def seq_cfg(dtype, **over):
    """internvl2-76b as [sequence-split training] trains it: cut to
    SEQ_TRAIN's layers, remat, the ApproxFFN with the tick router at
    TRAIN_ERROR_BOUND, in ``dtype``, ``over`` replacing fields."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(SEQ_TRAIN["arch"])
    return dataclasses.replace(
        cfg, n_layers=SEQ_TRAIN["layers"], remat=True, param_dtype=dtype,
        act_dtype=dtype, approx=dataclasses.replace(
            cfg.approx, enable=True, route_scope="tick",
            error_bound=TRAIN_ERROR_BOUND), **over)


def seq_batch(torch, cfg, seq: int) -> dict:
    """One row of ``seq`` positions on the CPU: seeded stub embeddings (1,
    S, d) in float32, as internvl2's ``input_mode="embeddings"`` takes
    them, and the synthetic stream's labels."""
    from repro_torch.data.pipeline import SyntheticLM
    labels = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=1,
                         seed=1).batch_at(0)["labels"]
    gen = torch.Generator().manual_seed(1000)
    return {"inputs": torch.randn((1, seq, cfg.d_model), generator=gen),
            "labels": labels}


def witness_cfg():
    return seq_cfg("float32", vocab=SEQ_TRAIN["witness_vocab"])


def seq_train_reference(np, torch):
    """One card's float32 ``loss_and_grads`` of [sequence-split training]'s
    witness: the loss, and every gradient but the unused token table's
    (exactly 0: the model takes embeddings) in host shared memory, for
    the world's ranks."""
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    cfg = witness_cfg()
    params = M.init_model(0, cfg, device="cuda").requires_grad_(True)
    batch = seq_batch(torch, cfg, SEQ_TRAIN["witness_seq"])
    loss, _, grads = S.loss_and_grads(
        cfg, params, {k: v.cuda() for k, v in batch.items()})
    tok = grads.pop("embed.tok")
    assert not tok.any(), "the token table of an embeddings model trains"
    ref = {"loss": float(loss),
           "grads": {k: g.cpu().share_memory_() for k, g in grads.items()}}
    del params, grads, tok
    release(torch)
    return ref


def _sq_sum(t) -> float:
    """The sum of squares of ``t`` in float64, 16 M elements at a time."""
    return sum(float((c.double() ** 2).sum())
               for c in t.reshape(-1).split(1 << 24))


def seq_train_bf16(np, torch, mesh):
    """[sequence-split training]'s bf16 step on one rank: internvl2-76b at
    SEQ_TRAIN's layers, its shards drawn in turns, ``loss_and_grads`` on 1
    row of SEQ_TRAIN["seq"] (the rank's half of the positions) and the
    global-norm clip over the shards: the loss, the metrics and the norm,
    the slowest rank's ms, the collectives and switch launches, the peak
    memory from the step's start, a digest of each gradient replicated
    over the data axes."""
    import hashlib

    from repro_torch.data.pipeline import local_batch
    from repro_torch.models import model as M
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import dp_axes
    cfg = seq_cfg("bfloat16")
    t0 = time.time()
    params = in_turns(torch, mesh, lambda: M.init_model(
        0, cfg, device="cuda", mesh=mesh).requires_grad_(True))
    init_s = time.time() - t0
    named = dict(params.named_parameters())
    local = {k: v.cuda() for k, v in local_batch(
        seq_batch(torch, cfg, SEQ_TRAIN["seq"]), mesh, 1).items()}
    torch.cuda.synchronize()
    C.barrier()
    torch.cuda.reset_peak_memory_stats()
    zero_switch()
    C.reset_counts()
    t0 = time.time()
    with S.train_mesh_context(mesh, 1):
        loss, metrics, grads = S.loss_and_grads(cfg, params, local)
    grads, norm = clip_by_global_norm(
        grads, 1.0, mesh=mesh, specs={k: p._pspec for k, p in named.items()})
    torch.cuda.synchronize()
    ms = C.world_max(time.time() - t0) * 1e3
    dp = dp_axes(mesh)
    out = dict(loss=float(loss), norm=float(norm), ms=ms, init_s=init_s,
               metrics={k: float(v) for k, v in metrics.items()},
               counts=dict(C.COUNTS), launches=switch_launches(),
               peak=torch.cuda.max_memory_allocated(),
               n_local=sum(p.numel() for p in named.values()),
               digests={k: (C.spec_axes(mesh, named[k]._pspec),
                            hashlib.sha1(g.contiguous().view(-1).view(
                                torch.uint8).cpu().numpy()).hexdigest())
                        for k, g in grads.items()
                        if not C._dp_dims(named[k]._pspec, dp)},
               finite=all(bool(torch.isfinite(g).all())
                          for g in grads.values()))
    del params, named, grads, local
    release(torch)
    C.barrier()
    return out


def seq_train_witness(np, torch, mesh, ref):
    """The float32 witness of [sequence-split training] on one rank: the
    mesh's ``loss_and_grads`` on 1 row (the rank's half of the positions)
    from the one card's draw (ranks drawing in turns), each gradient
    block held to the same block of one card's (``ref``): the sums of
    the squared gaps and of the squared gradient over every block (each
    counted by the first rank that holds it, summed over the world), the
    worst elementwise gap."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import local_batch
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S
    from repro_torch.sharding import collectives as C
    cfg = witness_cfg()
    local = {k: v.cuda() for k, v in local_batch(
        seq_batch(torch, cfg, SEQ_TRAIN["witness_seq"]), mesh, 1).items()}
    params = in_turns(torch, mesh, lambda: M.init_model(
        0, cfg, device="cuda", mesh=mesh).requires_grad_(True))
    named = dict(params.named_parameters())
    with S.train_mesh_context(mesh, 1):
        loss, _, grads = S.loss_and_grads(cfg, params, local)
    sums = torch.zeros(2, dtype=torch.float64)
    worst, tok = 0.0, 0.0
    for k in list(grads):
        g = grads.pop(k)
        if k == "embed.tok":
            tok = float(g.abs().max())
            continue
        spec = named[k]._pspec
        want = C.shard_tensor(mesh, ref["grads"][k], spec).cuda()
        gap = g - want
        worst = max(worst, float(gap.abs().max()))
        held = C.spec_axes(mesh, spec)
        if all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in held):
            sums += torch.tensor([_sq_sum(gap), _sq_sum(want)],
                                 dtype=torch.float64)
        del g, want, gap
    dist.all_reduce(sums)
    out = dict(loss=float(loss), gap_sq=float(sums[0]),
               ref_sq=float(sums[1]), worst=worst, tok=tok)
    del params, named, local
    release(torch)
    C.barrier()
    return out


def seq_train_rank(np, torch, mesh, ref):
    """[sequence-split training] on one rank of the (2, 8) world: the
    bf16 step of internvl2-76b, its float32 witness against one card
    (``ref``), and the xlstm-1.3b witness at one group, each sLSTM
    launch's initial state h0 recorded (data rank 1's first call starts
    from data rank 0's last state)."""
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.models import xlstm
    from repro_torch.sharding import sequence
    out, t0 = {}, time.time()
    out["bf16"] = seq_train_bf16(np, torch, mesh)
    out["s_bf16"] = time.time() - t0
    t0 = time.time()
    out["witness"] = seq_train_witness(np, torch, mesh, ref)
    out["s_witness"] = time.time() - t0
    t0 = time.time()
    real, h0 = xlstm.slstm_scan, []
    rounds, handoff = sequence._rounds, [0, 0]

    def recording(xg, wh, h, *st):
        h0.append((tuple(xg.shape), float(h.abs().max())))
        return real(xg, wh, h, *st)

    def counted(send, *a):              # the handoff's state gathers
        handoff[0] += 1
        handoff[1] += send.numel() * send.element_size()
        return rounds(send, *a)
    xlstm.slstm_scan, sequence._rounds = recording, counted
    K.slstm_scan.launches = 0
    try:
        out["xlstm"] = train_ssm_mesh_witness(np, torch, "xlstm-1.3b", mesh,
                                              SEQ_TRAIN["xlstm"])
    finally:
        xlstm.slstm_scan, sequence._rounds = real, rounds
    out["xlstm"].update(slstm=K.slstm_scan.launches, h0=h0,
                        handoff=handoff)
    out["s_xlstm"] = time.time() - t0
    return out


def long_mesh_rank(rank, out_dir, seq_ref):
    """One rank of [long context mesh full width] on a (2, 8) mesh: the
    uncut xlstm-1.3b served at one slot, its float32 witness and train
    step's gradients at one group; zamba2-2.7b's long_500k tick and its
    float32 witness; mixtral's ring decoding past 524,288; then
    [sequence-split training] (``seq_train_rank``, against one card's
    ``seq_ref``).  The payload to ``out_dir``."""
    # a shard cut from a whole draw (``model.init_model(mesh=)``) would
    # otherwise keep the draw's freed segment reserved around it:
    # internvl2-76b's 3.9 GiB float32 token table a rank
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import slstm_scan as K
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.sharding import collectives as C
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = HostMesh(LONG["shape"], ("data", "model"))
    out = {"coords": mesh.coords, "s": {}}
    t0 = time.time()
    out["xlstm"] = long_xlstm_serve(np, torch, mesh)
    C.barrier()
    out["s"]["xlstm serve"] = time.time() - t0
    t0 = time.time()
    out["xlstm_witness"] = long_witness(np, torch, "xlstm-1.3b", mesh)
    K.slstm_scan.launches = 0
    out["xlstm_train"] = train_ssm_mesh_witness(np, torch, "xlstm-1.3b",
                                                mesh)
    out["xlstm_train"]["slstm"] = K.slstm_scan.launches
    out["s"]["xlstm witnesses"] = time.time() - t0
    t0 = time.time()
    out["zamba2"] = long_zamba2(np, torch, mesh)
    out["zamba2_witness"] = long_witness(np, torch, HYBRID, mesh)
    out["s"]["zamba2"] = time.time() - t0
    t0 = time.time()
    out["swa"] = long_swa(np, torch, mesh)
    out["s"]["mixtral"] = time.time() - t0
    out["peak"] = torch.cuda.max_memory_allocated()
    C.barrier()
    t0 = time.time()
    out["seq_train"] = seq_train_rank(np, torch, mesh, seq_ref)
    out["s"]["sequence-split training"] = time.time() - t0
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def long_mesh_full_width(np, torch):
    """[long context mesh full width]: xLSTM heads below |model| and a
    batch below the data axes, ONE world of 16 ranks on a (2, 8) mesh
    sharing the card (``long_mesh_rank``), then one card on the same
    inputs.  Gates: every rank's tokens, logits and replicated states
    bitwise equal; the xLSTM's tokens equal to one card's, ``slstm_scan``
    launched once a group a tick on every rank on all 4 heads; its
    witness and zamba2's float32 tick over the whole 524,288-row cache
    within 1e-4 of one card's logits' scale, the train step's gradients
    within 1e-4 in norm; zamba2's switch kernels launched once a group a
    tick, both backends' tokens equal; mixtral's tokens equal to one
    card's and its logits within 1e-4.  Returns the kernels line's runs."""
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models import xlstm
    shape = LONG["shape"]
    ranks = shape[0] * shape[1]
    t0 = time.time()
    seq_ref = seq_train_reference(np, torch)
    log(f"  [sequence-split training] one card's float32 witness of "
        f"{SEQ_TRAIN['arch']} ({SEQ_TRAIN['layers']} layer, vocab "
        f"{SEQ_TRAIN['witness_vocab']}, 1 x {SEQ_TRAIN['witness_seq']}) in "
        f"{time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        spawn_world(long_mesh_rank, ranks, (tmp, seq_ref), backend="gloo",
                    exchange_mib=LONG["exchange_mib"])
        log(f"  {ranks} ranks on a {shape} mesh (gloo, one card, "
            f"{LONG['exchange_mib']} MiB arena slots) in "
            f"{time.time() - t0:.1f} s")
        pay = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
               for r in range(ranks)]
    p0 = pay[0]
    log("  rank 0's parts: " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in p0["s"].items()))
    log("  peak memory per rank: " + ", ".join(
        f"{p['peak'] / 2**30:.2f}" for p in pay) + " GiB")
    for r, p in enumerate(pay[1:], 1):
        pairs = [("xlstm tokens", p["xlstm"]["tokens"],
                  p0["xlstm"]["tokens"]),
                 ("xlstm witness", p["xlstm_witness"]["digest"],
                  p0["xlstm_witness"]["digest"]),
                 ("zamba2 witness", p["zamba2_witness"]["digest"],
                  p0["zamba2_witness"]["digest"]),
                 ("mixtral tokens", p["swa"]["tokens"], p0["swa"]["tokens"]),
                 ("mixtral logits", p["swa"]["logits"].numpy().tobytes(),
                  p0["swa"]["logits"].numpy().tobytes()),
                 ("xlstm train loss", p["xlstm_train"]["loss_mesh"],
                  p0["xlstm_train"]["loss_mesh"])]
        pairs += [(f"zamba2 {k}", p["zamba2"][k]["logits"].numpy().tobytes(),
                   p0["zamba2"][k]["logits"].numpy().tobytes())
                  for k in p0["zamba2"] if isinstance(k, tuple)]
        pairs += [(f"xlstm {k} state", p["xlstm"]["state"][k].numpy()
                   .tobytes(), p0["xlstm"]["state"][k].numpy().tobytes())
                  for k in p0["xlstm"]["state"]]
        differ = [name for name, a, b in pairs if a != b]
        if differ:
            raise AssertionError(f"long context mesh: rank {r} disagrees "
                                 f"with rank 0 on {differ}")
    runs = {"switched_mlp": [], "switched_mlp_fused": [], "slstm_scan": []}
    # the uncut xLSTM through the server: one card serves the same
    xs = p0["xlstm"]
    cfg = long_cfg("xlstm-1.3b", "float32")
    groups = cfg.n_layers // cfg.ssm.slstm_every
    launches = [p["xlstm"]["slstm"] for p in pay]
    if not xs["done"] or any(n != groups * xs["ticks"] for n in launches):
        raise AssertionError(f"long context xlstm: done {xs['done']}, "
                             f"sLSTM launches per rank {launches} (want "
                             f"{groups * xs['ticks']})")
    release(torch)
    one = long_xlstm_serve(np, torch)
    if one["tokens"] != xs["tokens"]:
        raise AssertionError(f"long context xlstm: mesh tokens "
                             f"{xs['tokens']} != one card's {one['tokens']}")
    # the uncut stack's float32 state, printed (at a random init 48
    # layers amplify the reassociated sums' rounding, caveat k); the
    # witnesses below hold one group at 1e-4
    gaps = {k: float((v - one["state"][k]).abs().max())
            for k, v in xs["state"].items()}
    c = xs["collectives"]
    log(f"  xlstm-1.3b uncut ({cfg.n_layers} layers, {cfg.n_heads} heads "
        f"over model {shape[1]}: {shape[1] // cfg.n_heads} ranks a head), "
        f"float32, one slot (below data {shape[0]}), a prompt of "
        f"{LONG['xlstm_prompt']} + {LONG['xlstm_new']} new: {xs['ticks']} "
        f"ticks, rank 0 ms per tick median "
        f"{statistics.median(xs['times']):.2f} (one card "
        f"{statistics.median(one['times']):.2f}); tokens {xs['tokens']} "
        f"equal to one card's; the last sLSTM states' max |mesh - one "
        f"card| " + ", ".join(f"{k} {g:.3g}" for k, g in gaps.items())
        + f" (every rank's bitwise equal); per tick per rank "
        f"{c['all_gather'] / xs['ticks']:.1f} all-gathers, "
        f"{c['gather_for_split'] / xs['ticks']:.1f} gathers for split, "
        f"{c['all_reduce'] / xs['ticks']:.1f} all-reduces, "
        f"{c['staged'] / xs['ticks']:.1f} host stagings of "
        f"{c['staged_bytes'] / xs['ticks'] / 2**20:.2f} MiB; slstm_scan "
        f"{launches[0]} a rank on all {cfg.n_heads} heads (every group "
        f"a tick); {xs['n_local']} parameters a rank, init "
        f"{xs['init_s']:.1f} s")
    runs["slstm_scan"].append(dict(
        run=f"long context mesh {shape} xlstm-1.3b serve, all ranks",
        ticks=xs["ticks"], launches=sum(launches), per_rank=launches[0]))
    del one
    release(torch)
    # the float32 witnesses at one group, batch 1
    for arch, key in (("xlstm-1.3b", "xlstm_witness"),
                      (HYBRID, "zamba2_witness")):
        w = p0[key]
        if not (all(p[key]["finite"] for p in pay)
                and w["max_abs"] <= LONG["tol"] * max(1.0, w["scale"])):
            raise AssertionError(f"long context {arch} float32 witness: "
                                 f"{w}")
        log(f"  float32 witness, {arch} at one group ({one_group(arch)} "
            f"layers), batch 1, {LONG['steps']} tokens from an empty "
            f"cache: logits within {w['max_abs']:.3g} of one card's "
            f"(<= {LONG['tol']} x max(1, {w['scale']:.3g})), every rank's "
            f"bitwise equal")
        kern = "slstm_scan" if arch != HYBRID else "switched_mlp"
        n = [p[key]["slstm" if arch != HYBRID else "switch"] for p in pay]
        runs[kern].append(dict(run=f"long context mesh {shape} {arch} "
                               "float32 witness, all ranks",
                               ticks=LONG["steps"], launches=sum(n),
                               per_rank=n[0]))
    tr, wt = p0["xlstm_train"], TRAIN_SSM_MESH["witness"]
    rel = math.sqrt(tr["gap_sq"] / max(tr["ref_sq"], 1e-300))
    if not (abs(tr["loss_mesh"] - tr["loss_single"]) <= wt["loss_tol"]
            and rel <= LONG["tol"]):
        raise AssertionError(f"long context xlstm train witness: loss "
                             f"{tr['loss_mesh']} vs {tr['loss_single']}, "
                             f"gradients {rel:.3g} in norm")
    # rank 0's count holds its one-card runs too
    n = [p["xlstm_train"]["slstm"] for p in pay]
    log(f"  [train] xlstm-1.3b at one group, float32, {wt['batch']} x "
        f"{wt['seq']} on {shape}: loss {tr['loss_mesh']:.6f} vs one card "
        f"{tr['loss_single']:.6f}; gradients within {rel:.3g} in norm "
        f"(<= {LONG['tol']}; one card's own noise {tr['floor']:.3g}), the "
        f"worst leaf {tr['worst_leaf'][1]} at {tr['worst_leaf'][0]:.3g}; "
        f"slstm_scan {n[1]} a rank (rank 0 {n[0]} with its one card)")
    runs["slstm_scan"].append(dict(
        run=f"long context mesh {shape} xlstm-1.3b train witness, all "
        "ranks and rank 0's one card", launches=sum(n), per_rank=n[1]))
    # zamba2 at long_500k: one card over the whole cache
    zm = p0["zamba2"]
    for key, dtype, groups in (("bf16", "bfloat16", LONG["zamba2_groups"]),
                               ("f32", "float32", 1)):
        cfg = long_cfg(HYBRID, dtype, n_layers=groups * one_group(HYBRID))
        release(torch)
        from repro_torch.models import model as M
        params = M.init_model(0, cfg, device="cuda")
        cache = long_cache(torch, cfg, LONG["ctx"], LONG["ctx"] - 1)
        whole = sum(cache[k].numel() * cache[k].element_size()
                    for k in ("k", "v"))
        one = long_decode(torch, cfg, params, cache, torch.full(
            (1, 1), 7, dtype=torch.int32, device="cuda"), 1, "pallas",
            None)
        del params, cache
        release(torch)
        want = one["logits"].cpu()
        backends = [k[1] for k in zm if isinstance(k, tuple)
                    and k[0] == key]
        for b in backends:
            got = zm[key, b]
            gap = float((got["logits"] - want).abs().max())
            scale = float(want.abs().max())
            n = [p["zamba2"][key, b]["switch"] for p in pay]
            if not (torch.isfinite(got["logits"]).all()
                    and all(x == groups for x in n)):
                raise AssertionError(f"long context zamba2 {key} {b}: "
                                     f"finite, launches {n}")
            if key == "f32" and not gap <= LONG["tol"] * max(1.0, scale):
                raise AssertionError(f"long context zamba2 float32 tick: "
                                     f"max |mesh - one card| {gap:.3g}")
            c = got["collectives"]
            log(f"  zamba2-2.7b, {groups * one_group(HYBRID)} of 54 layers,"
                f" {dtype}, {b}: one tick at position {LONG['ctx'] - 1} "
                f"over {LONG['ctx']} rows (whole cache {whole} B on one "
                f"card, {zm[key + '_cache_bytes']} B a rank, filled in "
                f"{zm[key + '_fill_s']:.1f} s): rank 0 {got['ms'][0]:.2f} "
                f"ms, one card {one['ms'][0]:.2f} ms; logits within "
                f"{gap:.3g} of one card's (scale {scale:.3g}"
                + (f", gated at {LONG['tol']}" if key == "f32" else
                   ", bf16: printed") + f"), token {got['tokens']} vs "
                f"{one['tokens']}; {c['all_gather']} all-gathers, "
                f"{c['all_reduce']} all-reduces, {c['gather_for_split']} "
                f"gathers for split a rank; switch launches {n[0]} a rank")
            kern = "switched_mlp" if b == "pallas" else "switched_mlp_fused"
            runs[kern].append(dict(
                run=f"long context mesh {shape} zamba2-2.7b {key} long_500k "
                f"{b}, all ranks", ticks=1, launches=sum(n), per_rank=n[0]))
        if key == "bf16":
            toks = [zm[key, b]["tokens"] for b in backends]
            if any(t != toks[0] for t in toks):
                raise AssertionError(f"long context zamba2: the backends' "
                                     f"tokens differ {toks}")
    # mixtral's ring past 524,288
    sw = p0["swa"]
    release(torch)
    one = long_swa(np, torch)
    gap = float((sw["logits"] - one["logits"]).abs().max())
    scale = float(one["logits"].abs().max())
    if sw["tokens"] != one["tokens"] or not gap <= LONG["tol"] * max(
            1.0, scale) or any(p["swa"]["switch"] for p in pay):
        raise AssertionError(f"long context mixtral: tokens {sw['tokens']}"
                             f" vs one card {one['tokens']}, logits gap "
                             f"{gap:.3g}")
    c = sw["collectives"]
    log(f"  {SWA}, {LONG['swa_layers']} of 32 layers, float32, ring of "
        f"{sw['ring_local'][2] * shape[0]} rows ({sw['ring_local']} a rank),"
        f" {LONG['swa_steps']} steps from "
        f"position {LONG['swa_pos']}: tokens {sw['tokens']} equal to one "
        f"card's, logits within {gap:.3g} (scale {scale:.3g}); rank 0 ms "
        f"per step median {statistics.median(sw['ms']):.2f}, one card "
        f"{statistics.median(one['ms']):.2f}; "
        f"{c['all_gather'] / LONG['swa_steps']:.1f} all-gathers, "
        f"{c['all_reduce'] / LONG['swa_steps']:.1f} all-reduces a step a "
        "rank; 0 switch launches")
    del one
    release(torch)
    assert xlstm.heads_below_model(long_cfg("xlstm-1.3b", "float32"),
                                   shape[1])
    seq_train_gates(pay, seq_ref, runs)
    return runs


def seq_train_gates(pay, ref, runs):
    """[sequence-split training]'s gates and lines from the (2, 8) world's
    payloads: the bf16 step finite, every rank's loss, metrics, norm and
    shared gradients bitwise equal, no switch launch; the float32
    witness's loss within SEQ_TRAIN's 1e-5 and its gradients within 1e-4
    in norm of one card's; the xLSTM's likewise, with data rank 1's first
    sLSTM launch starting from a handed-over (nonzero) state and data
    rank 0's from zeros.  Adds the sLSTM runs to ``runs``."""
    shape = LONG["shape"]
    s0 = pay[0]["seq_train"]
    b0 = s0["bf16"]
    for r, p in enumerate(pay):
        b = p["seq_train"]["bf16"]
        same = [b[k] == b0[k] for k in ("loss", "norm", "metrics")]
        if not (b["finite"] and math.isfinite(b["loss"]) and all(same)) \
                or b["launches"]:
            raise AssertionError(f"sequence-split training: rank {r}'s bf16 "
                                 f"step: loss {b['loss']}, norm {b['norm']},"
                                 f" finite {b['finite']}, switch launches "
                                 f"{b['launches']}")
        for k, (axes, digest) in b["digests"].items():
            if all(p["coords"][a] == pay[0]["coords"][a] for a in axes) \
                    and digest != b0["digests"][k][1]:
                raise AssertionError(f"sequence-split training: rank {r}'s "
                                     f"gradient of {k} differs from rank "
                                     "0's")
    c = b0["counts"]
    cfg = seq_cfg("bfloat16")
    log(f"  [sequence-split training] {cfg.name} cut to {cfg.n_layers} of "
        f"80 layers (d {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"stub embeddings in), bf16, remat, MCMA on, one train step "
        f"(forward, backward, the gradients reduced over the data axes, "
        f"the global-norm clip; no AdamW update) of 1 x {SEQ_TRAIN['seq']} "
        f"on {shape} ({SEQ_TRAIN['seq'] // shape[0]} positions a rank): "
        f"{b0['ms']:.1f} ms (slowest rank), loss {b0['loss']:.4f}, grad "
        f"norm {b0['norm']:.4f}, invocation "
        f"{b0['metrics'].get('invocation', 0):.3f}; per step per rank "
        f"{c['all_gather']} all-gathers, {c['gather_for_split']} gathers "
        f"for split, {c['all_reduce']} all-reduces, {c['reduce_scatter']} "
        f"reduce-scatters, {c['staged']} host stagings of "
        f"{c['staged_bytes'] / 2**30:.3f} GiB; 0 switch launches; every "
        f"rank's loss, metrics, norm and shared gradients bitwise equal; "
        f"{b0['n_local']} parameters a rank, drawn in turns in "
        f"{b0['init_s']:.1f} s")
    log("  [sequence-split training] peak memory per rank (bf16 step): "
        + ", ".join(f"{p['seq_train']['bf16']['peak'] / 2**30:.2f}"
                    for p in pay) + " GiB")
    w = s0["witness"]
    rel = math.sqrt(w["gap_sq"] / max(w["ref_sq"], 1e-300))
    if any(p["seq_train"]["witness"]["loss"] != w["loss"] for p in pay) \
            or abs(w["loss"] - ref["loss"]) > SEQ_TRAIN["loss_tol"] \
            or rel > SEQ_TRAIN["norm_tol"] \
            or any(p["seq_train"]["witness"]["tok"] for p in pay):
        raise AssertionError(f"sequence-split training float32 witness: "
                             f"loss {w['loss']} vs one card {ref['loss']}, "
                             f"gradients {rel:.3g} in norm")
    log(f"  [sequence-split training] float32 witness at "
        f"{SEQ_TRAIN['layers']} layer, vocab {SEQ_TRAIN['witness_vocab']}, "
        f"1 x {SEQ_TRAIN['witness_seq']}: loss "
        f"{w['loss']:.6f} vs one card {ref['loss']:.6f}; gradients within "
        f"{rel:.3g} in norm (<= {SEQ_TRAIN['norm_tol']}), worst "
        f"elementwise gap {w['worst']:.3g}; every rank's loss bitwise "
        f"equal")
    x0 = s0["xlstm"]
    xw = SEQ_TRAIN["xlstm"]
    xrel = math.sqrt(x0["gap_sq"] / max(x0["ref_sq"], 1e-300))
    first = {p["coords"]["data"]: p["seq_train"]["xlstm"]["h0"][0]
             for p in pay}
    n = [p["seq_train"]["xlstm"]["slstm"] for p in pay]
    if abs(x0["loss_mesh"] - x0["loss_single"]) > xw["loss_tol"] \
            or xrel > xw["norm_tol"] or first[0][1] != 0.0 \
            or not first[1][1] > 0.0 or min(n) < 1 \
            or any(p["seq_train"]["xlstm"]["loss_mesh"] != x0["loss_mesh"]
                   for p in pay):
        raise AssertionError(f"sequence-split training xlstm witness: loss "
                             f"{x0['loss_mesh']} vs {x0['loss_single']}, "
                             f"gradients {xrel:.3g} in norm, first sLSTM "
                             f"h0 by data rank {first}, launches {n}")
    log(f"  [sequence-split training] xlstm-1.3b at one group, float32, 1 "
        f"x {xw['seq']} on {shape}: loss {x0['loss_mesh']:.6f} vs one card "
        f"{x0['loss_single']:.6f}; gradients within {xrel:.3g} in norm (<= "
        f"{xw['norm_tol']}; one card's own noise {x0['floor']:.3g}); "
        f"slstm_scan at {first[1][0]} on each rank, data rank 1's first "
        f"launch from data rank 0's state (max |h0| {first[1][1]:.3g}), "
        f"{n[1]} launches a rank (forward, remat's recompute, the "
        f"handoff's backward; rank 0 {n[0]} with its one card); "
        f"loss_and_grads {x0['ms_mesh']:.1f} ms on the mesh (slowest rank)"
        f", {x0['ms_single']:.1f} ms on one card; the handoff's state "
        f"gathers {x0['handoff'][0]} a rank of "
        f"{x0['handoff'][1] / 2**20:.2f} MiB")
    runs["slstm_scan"].append(dict(
        run=f"long context mesh {shape} xlstm-1.3b sequence-split train "
        "witness (1 row below the data axes), all ranks and rank 0's one "
        "card", launches=sum(n), per_rank=n[1]))
    log("  [sequence-split training] rank 0's parts: bf16 step "
        f"{s0['s_bf16']:.1f} s, float32 witness {s0['s_witness']:.1f} s, "
        f"xlstm witness {s0['s_xlstm']:.1f} s")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def main() -> int:
    # cuBLAS reads this when CUDA initializes; [train resume] runs under
    # torch.use_deterministic_algorithms, which needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.sweeps import CASES

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    log("[build]")
    t0 = time.time()
    logs = build.build_all()
    compiles_at_build = build.build_all.compiles
    log(f"  built {len(logs)} of {len(build.SOURCES)} kernels in "
        f"{time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[kernel resources]")
    kernel_resources(torch)

    log("[kernels vs plain]")
    for case in sorted(CASES):
        for dtype in ("float32", "bfloat16"):
            x, cls, w, block = sweep_inputs(torch, case, dtype)
            err, _ = check_kernels(torch, x, cls, w, block, dtype, case)
            log(f"  {case} {dtype}: max |kernel-plain| switched "
                f"{err['switched_mlp']:.3g}, fused "
                f"{err['switched_mlp_fused']:.3g}")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    timing = main_path_kernel_phase(np, torch, flush)
    mlp = mlp_kernel_phase(np, torch, flush)
    slstm = slstm_kernel_phase(np, torch, flush)
    del flush

    log("[serve full width]")
    cfg, params, results, (srv, reqs) = serve_full_width(np, torch)
    oracle_witness(torch, cfg, params, srv, reqs)
    del srv, params
    torch.cuda.empty_cache()

    log("[serve scheduler full width]")
    serve_scheduler(np, torch)
    torch.cuda.empty_cache()

    log("[serve qos library autotune full width]")
    t0 = time.time()
    feature_launches, audited = serve_features(np, torch)
    torch.cuda.empty_cache()
    log(f"  phase {time.time() - t0:.1f} s")

    log("[analysis full width]")
    t0 = time.time()
    analysis_launches = analysis_full_width(np, torch, audited,
                                            compiles_at_build)
    del audited
    torch.cuda.empty_cache()
    log(f"  phase {time.time() - t0:.1f} s ({card_line()})")

    log("[serve mesh full width]")
    t0 = time.time()
    release(torch)
    mesh_runs = serve_mesh(np, torch)
    release(torch)
    log(f"  phase {time.time() - t0:.1f} s")

    log("[smoke reference]")
    smoke_reference_check(np, torch)
    torch.cuda.empty_cache()

    log("[serve xlstm full width]")
    slstm_launches = serve_xlstm(np, torch)
    torch.cuda.empty_cache()

    log("[smoke reference xlstm]")
    smoke_reference_xlstm(np, torch)
    torch.cuda.empty_cache()

    log("[serve hybrid full width]")
    t0 = time.time()
    hybrid_runs = serve_hybrid(np, torch)
    torch.cuda.empty_cache()
    log(f"  phase {time.time() - t0:.1f} s")

    log("[serve stablelm full width]")
    t0 = time.time()
    stablelm_runs = serve_stablelm(np, torch)
    torch.cuda.empty_cache()
    log(f"  phase {time.time() - t0:.1f} s")

    log("[archs full width]")
    t0 = time.time()
    arch_runs, widths = archs_full_width(np, torch)
    torch.cuda.empty_cache()
    log(f"  phase {time.time() - t0:.1f} s")

    log("[train dense full width]")
    t0 = time.time()
    train_dense_full_width(np, torch)
    torch.cuda.empty_cache()
    log(f"  phase {time.time() - t0:.1f} s")

    log("[train dense float32 parity]")
    t0 = time.time()
    train_dense_parity(np, torch)
    torch.cuda.empty_cache()
    log(f"  phase {time.time() - t0:.1f} s")

    log("[train xlstm full width]")
    t0 = time.time()
    _, train_slstm = train_xlstm_full_width(np, torch)
    torch.cuda.empty_cache()
    slstm_grad_gate(np, torch)
    torch.cuda.empty_cache()
    log(f"  phase {time.time() - t0:.1f} s")

    log("[train resume]")
    t0 = time.time()
    train_resume(np, torch)
    log(f"  phase {time.time() - t0:.1f} s")

    # the train phases of the mesh, the MoE family and the example twin
    # launch none of the four kernels
    for name, phase in (("train mesh full width", train_mesh_full_width),
                        ("train moe", train_moe),
                        ("train example twin",
                         lambda np, torch: train_example_twin(torch))):
        release(torch)
        log(f"[{name}]")
        t0 = time.time()
        phase(np, torch)
        release(torch)
        log(f"  phase {time.time() - t0:.1f} s")

    log("[paper pipeline full width]")
    t0 = time.time()
    dryrun_started = dryrun_start()
    paper_runs = paper_pipeline_full_width(np, torch)
    torch.cuda.empty_cache()
    log(f"  phase {time.time() - t0:.1f} s")

    # the MoE family: moonshot alone holds 56 GB, so every earlier
    # phase's tensors go first; each phase's peak is printed
    release(torch)
    moe_runs = {}
    for name, phase in (("serve moe full width", serve_moe),
                        ("moe float32 witness", moe_witness),
                        ("sliding window full width", swa_full_width),
                        ("moe mesh world", lambda np, torch: moe_mesh_full_width(
                            np, torch, moe_runs["serve moe full width"]))):
        log(f"[{name}]")
        log(f"  {torch.cuda.memory_allocated()} B allocated before")
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        moe_runs[name] = phase(np, torch)
        log(f"  phase {time.time() - t0:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated()} B")
        release(torch)

    # the hybrid and xLSTM families on a mesh: the shared block's switch
    # kernels and the sLSTM kernel per rank on its heads
    log("[ssm mesh world]")
    log(f"  {torch.cuda.memory_allocated()} B allocated before")
    t0 = time.time()
    ssm_runs = ssm_mesh_full_width(np, torch)
    log(f"  phase {time.time() - t0:.1f} s")
    release(torch)

    # tensor parallelism below one kv head and one expert a rank: the
    # switch kernels on each of 16 ranks
    log("[narrow mesh full width]")
    log(f"  {torch.cuda.memory_allocated()} B allocated before")
    t0 = time.time()
    narrow_runs = narrow_mesh_full_width(np, torch)
    log(f"  phase {time.time() - t0:.1f} s ({card_line()})")
    release(torch)

    # xLSTM heads below |model| and a batch below the data axes (context-
    # parallel decode): the sLSTM kernel on every head of each of 16 ranks,
    # the switch kernels on one row a rank
    log("[long context mesh full width]")
    log(f"  {torch.cuda.memory_allocated()} B allocated before")
    t0 = time.time()
    long_runs = long_mesh_full_width(np, torch)
    log(f"  phase {time.time() - t0:.1f} s ({card_line()})")
    release(torch)

    log("[dryrun full width]")
    t0 = time.time()
    dryrun_run = dryrun_full_width(np, torch, dryrun_started)
    log(f"  phase {time.time() - t0:.1f} s after the paper phase")

    # every process a phase started (ranks, fork servers, launchers,
    # compilers) has ended before the result is printed
    left = child_processes()
    if left:
        raise AssertionError(f"processes left running: {left}")
    log("[processes] no child process left")

    # library_ms is null for all four: no single PyTorch call computes a
    # per-tile weight-switched MLP, the one-approximator MLP (addmm + tanh
    # + addmm) or the recurrence (a loop of steps)
    # launches: the sum over the main-path runs that launched the kernel;
    # launches_by_run: each of those runs with its own count
    rows = []
    switch_runs = {b: [dict(run=f"slice 1 {b}", ticks=results[b]["ticks"],
                            launches=results[b]["launches"])]
                   + feature_launches[b] + analysis_launches[b]
                   for b in ("pallas", "pallas_fused")}
    for b in ("pallas", "pallas_fused"):
        switch_runs[b] += [hybrid_runs[b]] + stablelm_runs[b] \
            + [mesh_runs[b]]
    switch_runs["pallas"] += arch_runs + paper_runs
    switch_runs["pallas"] += ssm_runs["switched_mlp"] + [dryrun_run]
    switch_runs["pallas_fused"] += ssm_runs["switched_mlp_fused"]
    for b in ("pallas", "pallas_fused"):
        switch_runs[b].append(narrow_runs[b])
    switch_runs["pallas"] += long_runs["switched_mlp"]
    switch_runs["pallas_fused"] += long_runs["switched_mlp_fused"]
    for name, src, replaces, tm, by_run in (
            ("switched_mlp", "switched_mlp.cu",
             "src/repro/kernels/switched_mlp.py:37",
             timing["switched_mlp", "bfloat16"], switch_runs["pallas"]),
            ("switched_mlp_fused", "fused_dispatch.cu",
             "src/repro/kernels/fused_dispatch.py:120",
             timing["switched_mlp_fused", "bfloat16"],
             switch_runs["pallas_fused"]),
            ("mlp_forward", "mcma_mlp.cu",
             "src/repro/kernels/mcma_mlp.py:37", mlp["bfloat16"],
             [dict(run="ops.mlp_apply", launches=mlp["launches"])]),
            ("slstm_scan", "slstm_scan.cu",
             "src/repro/kernels/slstm_scan.py:94",
             slstm["prefill", "bfloat16"],
             [dict(run=f"xlstm {k}", launches=v)
              for k, v in slstm_launches.items()]
             + [dict(run="xlstm train", steps=TRAIN_XLSTM["steps"],
                     launches=train_slstm)] + ssm_runs["slstm_scan"]
             + long_runs["slstm_scan"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": sum(x["launches"] for x in by_run),
            "launches_by_run": by_run,
            "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None})
        if name == "slstm_scan":
            # a mesh rank's shapes: its heads of its rows
            rows[-1]["at_rank_shapes"] = [
                dict(shape=list(shape), **slstm[k, "bfloat16"])
                for k, shape in SLSTM_RANK.items()]
        if name in ("switched_mlp", "switched_mlp_fused"):
            # one decode step's inputs at d 2560 and d 8192
            rows[-1]["at_widths"] = [dict(d_model=d, **nums[name])
                                     for d, nums in sorted(widths.items())]
            # a mesh rank's one row (a batch below the data axes)
            rows[-1]["at_rank_shapes"] = [timing[name, "bfloat16",
                                                 "one row"]]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

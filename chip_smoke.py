#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: the card's name and power limit, torch and CUDA versions; f32
   matmuls and convolutions without TF32, cuDNN deterministic and not
   autotuned (``cudnn.deterministic``, no ``cudnn.benchmark``).
2. Codec kernels: build ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a
   (one ``nvcc`` per source, all started together); hold
   ``wan_encode`` and ``wan_decode`` bit-equal to their plain versions on
   every tier (int8, fp8, int4) at 64M values per pod x 2 pods and on edge
   cases: ragged n, ties, all-zero blocks, column slices (one not 16-byte
   aligned), blocks 128 to 65536, every key in one high-byte bin, ties at
   the threshold over many threads, ``k_block`` 1, 300 and ``k_block ==
   block``, and NaN and inf inputs (a row of NaN beside a finite one,
   scattered NaN and inf, NaN in a ragged last block); then time both at the main path's size (the whole granite-8b
   2-layer gradient, 838,881,280 values per pod x 2 pods) beside their
   bound, their plain version and the one PyTorch call that computes the
   same function, where there is one.
2b. Flash attention: hold the kernel to its plain version
   (``ref.sdpa``) within 2e-2 (bf16) or 2e-5 (f32) at the serving path's
   shape (B 1, S 2048, H 32, K 8, Dh 128, bf16, causal), a ragged S 1000,
   MQA, f32 inputs, non-causal, window 256 with softcap 50, Dh 256 and the
   reference's kernel-test cases, and on the bf16 tensor-core path at Dh
   32-256 causal and not, S 1-65, Sq != Sk both ways, windows, strided
   views, qwen2-vl's 12 heads over 2; a misaligned bf16 view must be
   refused; then time it at the main path's shape and at qwen2-vl's (B 1,
   S 2048, H 12, K 2) (ms, TFLOP/s) beside its bound, its plain version
   and ``F.scaled_dot_product_attention`` (timed only, never used by the
   port).
3. Training path: granite-8b at full width (depth cut to 2 layers, bf16,
   random weights from a seed), 2 pods, global batch 8, seq 512, sgd, an
   ASGD-GA sync every 2 steps through the int8 codec with error feedback,
   4 steps through ``Trainer.fit`` (granite's ``remat="full"``: each
   layer group recomputed in the backward).  Each round's EF residual
   must equal ``flat - local`` and the kernel's decode of the shipped
   payload must equal the plain decode, bit for bit.  The launch counts
   of this run show that the rounds went through the kernels.
3d. The control loop: phase 3's model and batch through
   ``repro_torch.launch.train.main`` with ``--bucket-policy layer-class
   --adaptive-sync --wan-trace ... --events ...`` (``CONTROL_*``): the
   ``BucketedSyncController`` retunes each bucket group's tier and top-k
   as a bandwidth collapse and recovery reach it over the ``EventBus``,
   the ``ElasticityController`` re-plans on a straggler and on pod1
   leaving and rejoining (2 -> 1 -> 2 pods, applied at sync barriers).
   Every round, at whatever tiers it runs, is held as phase 3's are, per
   bucket group; at least two retunes, a round at an fp8 or int4 rung and
   the 2 -> 1 -> 2 reconfig must happen.  Prints the decision stream, the
   applied reconfigs, launches by tier, round times by knobs (first round
   at new knobs apart), the reconfig barriers' times and peak memory.
3e. The transport seam at full width: phase 3's model and batch under
   ``--bucket-policy layer-class`` (embed, norm and dense buckets), 4 steps
   through ``Trainer.fit`` three times: over the inline ring, a
   ``SimTransport`` (fluctuation 0.25, seed 0, a measured probe) and a
   ``MeshTransport`` (one card: unsharded, a roll between device waits).
   Every sim and mesh round ships the inline ring's bytes, every round is
   held as 3d's are, the three runs end in the same params, EF residual
   and tier and pass through the same per-round norms (bit for bit, or at
   ``TRANSPORT_ATOL`` / ``TRANSPORT_RTOL`` if two inline runs differ,
   which the phase then prints), with equal launch counts; the mesh run
   writes one record per bucket per round and one probe observation per
   round.  Then the launcher in measured mode (3d's argv with
   ``--transport sim:...`` and no ``--events``, 20 steps): it retunes after
   the 250 Mbps collapse from billed transfers alone, and a fresh
   ``SimTransport`` replays its records float for float.  Then the mesh
   run with an emulated 10 Gbps hop (every record at least its hop time)
   and ``MeshTransport.measure_overlap`` at ``N_MAIN`` values per pod in 8
   chunks (both schedules decode to equal bytes).
3f. Faults and crash recovery at full width: phase 3e's setup (its
   ``SimTransport`` knobs, the CUDA codec kernels under phase 1's
   deterministic settings), ``FAULT_STEPS`` steps a case through a
   ``ChaosTransport``: (a) an empty plan, bit-equal to the bare sim run in
   params, EF residual, norms, tier, billed seconds and probe belief; (b)
   ``fail:x2@1,timeout:x6@3``, 3 retries, bit-equal to the bare run, every
   outcome's retry bill equal to ``resolve_round``'s; (c) ``corrupt@3``
   caught by the checksums and re-shipped (bit-equal, the first bucket's
   wire MB retried), then unverified (``tolerate=False``): the receiving
   pod's params go non-finite, its corrupted payload decoded by the kernel
   equal to the plain decode, NaN in place; (d) ``crash:pod1@3``: two
   degraded rounds, each held to the degraded rule (no pod receives, EF ==
   the whole message, norms 0, params untouched), and no EF-guard trip.
   Every round is held as 3e's are.  (e) The whole granite ``TrainState``
   saved by ``checkpoint.save`` and restored onto the card bit-equal, then
   the launcher with 3e's argv plus ``--faults`` ``FAULT_LAUNCH`` and
   ``--ckpt-dir``: one retry, one rollback to the barrier checkpoint, pod 1
   removed.  Prints each save's and restore's GB and seconds, the free disk
   (the phase fails below twice the state and the params) and the round
   times; the checkpoints live in a temporary directory it removes.
3h. The async snapshot engine at full width: 3f's setup (the 20.13 GB
   state). (a) A blocking ``checkpoint.save`` of the trainer's state, then
   two ``AsyncCheckpointEngine`` snapshots, each followed at once by
   in-place steps: the first snapshot's manifest (size and CRC32) equals
   the blocking save's, the second reuses the first's page-locked buffer
   set; prints ``snapshot()``'s host s, the next step's s and the steps'
   s while the commit runs against steps with no snapshot, each commit's
   s and the pinned GB.  (b) The launcher with ``--async-checkpoint
   --events cloud_left:pod1@0 --serve`` against the same argv without the
   engine: losses bit-equal step for step, one migration, no migrator
   error, the 1-pod params' MB staged, 3 snapshots, step 2 durable; prints
   every ``snapshot()`` (a backpressure stall included), commit and the
   stage's join, the reconfig barrier's s and both arms' peak memory.
   (c) ``--faults crash:pod1@1:rollback`` with snapshots in flight against
   the blocking barrier path: equal losses and fault counters, the
   ``restore_last`` s (its drain included).  (d) ``--serve``: 6 requests,
   48 tokens.  The phase needs twice the state on disk and three times
   in ``MemAvailable``; everything lives in a temporary directory it
   removes.
4. Entry point: ``repro_torch.launch.train.main`` on the tiny preset.
2c. SSD scan: hold the kernel to its plain version (``ref.ssd``) within
   the reference's tolerance (``y / max|y|`` within 1e-5, the final state
   within 1e-3) at the reference's kernel-test shapes, S == chunk, S <
   chunk, a non-zero ``init_state``, bf16 B/C, B/C as a stride-0 view over
   heads, chunks 64-256, 16 chunks, the scoring forward's B 2 and the
   serving prefill's shape (B 1, S 2048, H 64, P 64, N 128, chunk 256, x
   and a f32, B and C bf16); then time it there (ms, TFLOP/s) beside its
   bound (the f32-operand products priced as 3xTF32) and its plain
   version (no single PyTorch call computes SSD).
5. Serving path: granite-8b at its published size (36 layers, bf16,
   random weights from a seed, ``attention_impl="pallas"``), two replicas
   (us-east, eu-west) sharing the parameters behind a balanced
   ``GeoRouter``, each a ``ContinuousScheduler`` over a
   ``ContinuousEngine(n_slots=4, cache_len=2080)``; 8 requests drawn as the
   serving launcher draws them with ``--prompt-len 2048``, 32 new tokens
   each.  Every request must finish with 32 tokens, the flash kernel must
   launch 36 times per prefill, every attention layer of the first prefill
   is held to ``ref.sdpa`` on the same q, k, v, and request 0 decoded alone
   in a fresh pool must give the tokens it got beside its neighbours.
6. Entry point: ``repro_torch.launch.serve.main`` on the smoke config.
5c. gemma3-12b at its published size (48 layers, d_model 3840, 16 heads,
   8 KV heads, head_dim 256, window 1024 on 5 of every 6 layers, vocab
   262,144 tied, bf16, random weights from a seed, ``attention_impl=
   "pallas"``): one ``ContinuousEngine`` prefill of a 2048-token prompt
   (48 flash launches; layers 0 and 5 held to ``ref.sdpa``) and 8 decode
   steps; prints the prefill time and the flash kernel's share of it.
7. Mamba2 serving: mamba2-1.3b at its published size (48 layers, bf16,
   random weights from a seed), two replicas as in phase 5; 8 requests
   whose prompt lengths are phase 5's rounded down to a multiple of 256
   (the SSD's chunk; the reference refuses other lengths above it), 32 new
   tokens each.  Every request must finish with 32 tokens, the SSD kernel
   must launch 48 times per prefill, every SSM layer of the first prefill
   is held to ``ref.ssd`` on the same inputs (within 5e-4) and to an f64
   evaluation of the same SSD (within the reference's 1e-5: at the
   model's real decays the f32 plain version is itself ~1e-4 from
   exact), request 0 alone in a fresh
   pool must give the same tokens, and the engine must refuse a 1895-token
   prompt as the reference does.
7b. Mamba2 scoring: ``forward(..., use_ssm_kernel=True)`` at B 2, S 2048
   (48 launches), held to the same forward through the plain SSD.
8. Entry point: ``repro_torch.launch.serve.main --arch mamba2-1.3b``.
2d. Block top-k: hold ``ops.topk_compress_chunked`` (the legacy sparse
   shipping's kernel) bit-equal to its plain version (vals, idx and the
   decompressed dense) on each of granite-8b's 12 leaf shapes at 2 layers
   as ``_ship_ring`` cuts them into chunks of 2**26 values, in f32 and
   bf16, and on ties, zeros, -0.0, pad winners (n 1027), ``k // nb == 0``,
   ``nb * k_block < k``, ``k_block`` 512, ``n < block`` and the inputs
   that split the kernel's branches (large values every 16, 32 or 128
   positions, all equal, a tie at the threshold split across lanes); then
   time it at the largest leaf (embed, 2 pods x 3 chunks) and over a whole
   round's 12 launches beside its bound, its plain version and the nearest
   PyTorch call (``torch.topk`` per block: no tie order, magnitudes), and
   the embed leaf once more with large values every 16 positions, which
   sends every tile down the kernel's general branch.
3b. Sync strategies at full width: phase 3's setup (granite-8b x2 layers,
   2 pods, batch 8, seq 512, sgd, interval 2, 4 steps) under sparse
   ``asgd_ga``, ``ama`` and ``asp`` (top-k 0.01, no codec), ``sma`` and
   ``asgd``; every top-k launch held bit-equal to the plain version
   (``TOPK_CHECK_HOOK``), 24 launches per sparse strategy, none for the
   others, no codec, flash or SSD launch; then sparse ``asgd_ga`` once
   more without the check, whose round times are unfenced (the check
   synchronizes the device after each launch).
3i. The mesh path: a one-rank NCCL group (``HashStore``; a failure to
   start it fails the run), ``make_debug_mesh(1, 1, 1)``, and phase 3's
   run built by ``launch.context.make_train_setup`` with its state and
   batches placed through ``TrainSetup`` (every parameter a DTensor):
   (a) the codec, (b) sparse ``ama`` (phase 3b's), (c) dense ``ama``
   (``compress_topk=0``: the round runs on the placed leaves, each rank
   shipping its own shard, and must post no all-gather); each bit-equal
   to the unsharded trainer on the same seed and batches (losses, digests
   of every parameter leaf and of the EF residual), each codec round and
   top-k launch held to its plain version; prints each arm's step and
   round times beside the unsharded run's and phase 3's and 3b's, its peak
   memory and launches, and (c)'s round times beside (b)'s with the
   card's name and power limit.  (d) Serving under ``serve_rules``:
   granite-8b at full width, ``MESH_SERVE_LAYERS`` layers, ``"xla"``
   attention, its parameters placed by ``make_serve_setup`` and its cache
   by ``cache_logical_axes``: ``dryrun.lower_prefill``'s and
   ``lower_decode``'s step functions (``transformer.prefill``,
   ``decode_step``) run for real on a 2-row prompt of 1024 tokens and 8
   greedy decode steps, placed and unplaced on the same parameters: equal
   tokens, bit-equal logits (one rank combines no softmax across ranks),
   no kernel launched; prints prefill s and the median decode
   step s of both.  Then granite-8b x2's forward at B 8, S 512 with
   ``embed_impl="onehot"`` against ``"gather"``, and every arch's input
   specs at the four assigned shapes on the meta device, allocating
   nothing; the NCCL version and the card's name and power limit.
3k. The WAN transports on a pod axis split over processes: phase 3's run
   (granite-8b x2 layers at full width, 2 pods, batch 8, seq 512, sgd,
   ASGD-GA every 2 steps, the int8 codec at top-k ``POD_PROC_TOPK`` with
   EF, three bucket groups of ``STREAM_CHUNKS`` chunks), each arm first
   run whole in this process (its digests kept, its state freed), then in
   two spawned processes on the card, one pod each, through
   ``make_train_setup`` on a ``(2, 1, 1)`` mesh with the transport bound
   to the split pod axis.  One card: the pod group is gloo (NCCL refuses
   two ranks on one device, gloo sends no CUDA tensor), and ``PodAxis``
   stages the rows through pinned host buffers; two or more cards: NCCL,
   one card a pod.
   Arms, 4 steps each: (a) ``SimTransport``, (b) ``MeshTransport`` with
   the emulated ``HOP_MBPS`` hop, (c) a ``ChaosTransport`` with a failed
   and a corrupted attempt (round 1) and pod 1 crashed (round 2,
   degraded), (d) a streaming round over 3g (b)'s collapsing trace that
   retunes mid-round, (e) ``HierarchicalTransport`` over two regions, (f)
   ``Trainer.retune`` from int8 to int4 between the rounds.  Each held
   bit for bit against its whole run: losses, every parameter row's and
   EF row's digest, the records and billed seconds (b: their bytes), the
   probe belief, fault outcomes, streaming decisions and tiers, equal on
   both ranks (b's measured seconds agreed over the pod group); every
   codec launch of the processes held to its plain version by the round
   hook.  Prints the backend, each rank's launches, each arm's round and
   step times split against whole and each process's peak memory; a
   failed or hung process (``POD_PROC_TIMEOUT``) fails the phase.
3l. Elasticity on a pod axis split over processes: granite-8b at full
   width and 1 layer, 3 pods, batch 8, seq 512, sgd, ASGD-GA every 2
   steps through the int8 codec with EF at top-k ``POD_PROC_TOPK``, a
   ``SimTransport`` without fluctuation in a chaos plan; first whole in
   this process, then three spawned processes, one pod each, on a
   ``(3, 1, 1)`` mesh (gloo on one card, NCCL with a card a pod).  Two
   steps and a round; a placed save (``Trainer.save_state``) whose
   size and CRC32 equal the whole run's save, restored placed bit-equal;
   an async snapshot of the bound engine (the same file); pod 1 leaves at
   the barrier (``keep=(0, 2)``), staged by ``LiveMigrator`` (the stage
   joined before the barrier, so that the barrier holds the resize alone,
   as the whole run's does); two steps
   and a round on 2 pods; pod 1 rejoins; two steps and a round on 3
   pods, then a round with pod 1 crashed (degraded).  The rows of the
   parameters, the gradient accumulator and the EF residual after the
   leave, the rejoin and the last round are bit-equal to the whole run,
   losses, billed records and fault outcomes equal (pod 1's process
   missing the rounds it idled through), every round held by the round
   hook.  Prints the save, restore, ``snapshot()``, commit and stage s,
   the reconfiguration barriers split against whole and each process's
   peak;
   a failed or hung process (``ELASTIC_TIMEOUT``) fails the phase.
3j. The dry run (``repro_torch.launch.dryrun``'s command line, each run
   in a process of its own: its fake process group is global to the
   process), on the host, no card, at all layers, on the multi-pod mesh of
   512 fake ranks: granite-8b ``train_4k`` (the record must say ``"ok"``
   and its sync step must cross pods), granite-8b ``prefill_32k`` and
   ``decode_32k`` and mamba2-1.3b ``long_500k`` (each ``"ok"`` and
   crossing no pod).  The four start at once after the last phase on the
   card (6f), so that no timed phase shares the host with them; a
   non-zero exit fails the phase.
   Prints each record's per-rank argument and temp bytes beside the card's
   memory, its in-pod collective bytes and cross-pod bytes, and the
   phase's seconds.
3c. The paper's models (LeNet, ResNet, DeepFM) at their own sizes, 2 pods,
   Fig 11's ``asgd@1``, ``asgd_ga@8``, ``ama@8``, ``sma@8`` and ``ama@8``
   at top-k 0.01, 16 steps each; at 2 pods ``ama@8`` and ``sma@8`` must
   agree within 1e-6, step for step.
4b. Entry point: ``repro_torch.launch.train.main --sync ama
   --compress-topk 0.02``.
6a. qwen3-moe-30b-a3b at its published size (48 layers, 128 experts
   top-8, GQA 32/4, 30.5 B parameters, bf16, random weights from a seed,
   ``attention_impl="pallas"``) through a 4-slot ``ContinuousEngine``:
   prompts of 2048, 1536, 1024 and 512 tokens, 16 new each, 48 flash
   launches a prefill, every one held to ``ref.sdpa``; the MoE layers'
   share of a prefill's device time (router, expert products, dispatch
   and combine, by CUDA events).  Then a 16-slot pool at 1 layer with a
   zero router (every slot ties and picks experts 0-7): its tokens must
   equal each request's alone in the pool (each slot routed on its own),
   while the 16 tokens routed together overflow their experts.
6b. kimi-k2 at full width, 1 of 61 layers (384 experts top-8, capacity
   factor 1.0): a 2048-token prefill and 8 decode steps; prints the
   (token, expert) assignments the capacity dropped.
6c. jamba-1.5-large at one period (7 Mamba layers with 256 SSM heads in 8
   B/C groups, 1 attention layer, MoE 16 experts top-2 on 4), d_ff cut
   from 24576 to 8192 to fit one card: requests of 2048 and 1024 tokens,
   16 new each; 7 SSD and 1 flash launch a prefill, each held to its
   plain version (the SSD at G 8, B and C expanded by a copy, whose bytes
   and time it prints).
6d. whisper-tiny whole: the encoder over (4, 1500, 384) stub frames (4
   non-causal flash launches at head_dim 64, each held to ``ref.sdpa``),
   then ``ServingEngine.generate`` with its output as ``audio_emb``,
   32-token prompts and 32 new tokens; in f32, decode == forward at the
   reference's tolerance.
6e. qwen3-moe-30b-a3b x1 layer trained through ``launch/train.py`` (2
   pods, global batch 8, seq 512, sgd, ``asgd_ga`` interval 2, int8 top-k
   0.05 with error feedback, ``--bucket-policy layer-class
   --bucket-patterns moe-router``), 8 steps: finite losses, non-empty
   ``moe`` and ``router`` buckets, every codec round held as in 3d.
6f. qwen2-vl-2b at its published size (28 layers, d_model 1536, 12 heads
   over 2 KV heads of 128, M-RoPE sections (16, 24, 24), 1.78 B
   parameters, bf16, random weights from a seed, ``attention_impl=
   "pallas"``): (a) ``ServingEngine.generate`` at B 2 over a 2048-token
   prompt with seeded patch embeddings over the first 256 positions, 16
   new tokens: 28 flash launches, each held to ``ref.sdpa`` on the same
   M-RoPE-rotated q, k, v; layer 0's M-RoPE on the card within 1e-2 of
   the CPU's on the same q (default and vision-grid positions); the first
   256 embeddings equal to the cast patches; the patches move the
   last-token logits.  (b) A 4-slot pool of cache_len 2080 behind one
   replica: 8 requests drawn as the serving launcher draws them, 16 new
   each at ``(3, B, 1)`` positions, request 0 alone giving the same
   tokens; then the serve launcher with ``--arch qwen2-vl-2b``.  (c) 19
   layers (the most whose ``remat="none"`` run peaks under 75 GB) trained
   as phase 3 at seq 1024 with the patch embeddings, under ``remat``
   "none", "full" and "dots": losses and final parameters equal across the
   arms, every codec round held as phase 3's; prints each arm's peak (of
   the run, and to the end of the first step), step and round times and
   launches.

Every time is a CUDA-event median of calls made back to back, taken the
same way for a kernel, its plain version and the library call.  The line
before the last is a JSON object with one entry per kernel; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth, non-tensor-core f32 rate
# and dense bf16 and TF32 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
# calls timed back to back in each run of time_ms
TIMED_CALLS = 10

SEED = 0
N_MAIN = 838_881_280           # granite-8b, 2 layers: values per pod
PODS = 2
BLOCK = 4096
TOPK = 0.01
# the serving path: granite-8b at 36 layers, 2 replicas of 4 slots
SERVE_REGIONS = ("us-east", "eu-west")
SERVE_SLOTS = 4
SERVE_REQUESTS = 8
SERVE_PROMPT_LEN = 2048
SERVE_NEW_TOKENS = 32
FLASH_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
# the reference's SSD tolerance (tests/test_kernels.py): y / max|y|, and
# the final state absolute
SSD_Y_TOL, SSD_STATE_TOL = 1e-5, 1e-3
# the SSD of a real prefill (see ssd_serving_close): y / max|y| and
# state / max|state| against the plain f32 version, which is itself up to
# 1.4e-4 from the f64 evaluation there (on an H100: kernel vs plain at most
# 1.25e-4 (y) and 1.36e-4 (state) over the 48 layers); the kernel is held
# to the f64 evaluation within the reference's SSD_Y_TOL (measured 3.1e-7)
SERVE_SSD_TOL = 5e-4
# mamba2-1.3b serving: phase 5's prompt lengths rounded down to the chunk
MAMBA_CHUNK = 256
MAMBA_SCORE_BATCH = 2
# the scoring forward through the kernel against the same forward through
# the plain SSD, both bf16 over 48 layers: max |diff| / max|logit| (the two
# SSDs differ in f32 rounding, which flips bf16 roundings that 48 layers
# carry on; on an H100: 7.7e-3, every argmax equal)
MAMBA_LOGIT_TOL = 2e-2
# the paper's models at 2 pods: ama@8 and sma@8 take the same mean, so
# their losses must agree step for step (up to the last bits of the loss's
# own reduction)
PAPER_AMA_SMA_TOL = 1e-6
# the legacy sparse shipping: top-k block (the reference's default)
TOPK_BLOCK = 1024
# phase 3d, the control loop: 2 pods at interval 2, the codec at int8
# with top-k 0.05.  The elasticity controller's 100 Mbps reference puts its
# interval at 1 for every bandwidth of the run, so its first bandwidth
# event (step 1) re-plans once and later ones do not; a 250 Mbps collapse
# at step 3 pushes the per-bucket controller down the ladder (at
# granite-8b's 1.68 GB, to int4 rungs), the straggler's re-plan at 14
# resets the knobs and the controller walks again, pod1 leaves at 24 and
# rejoins at 28 (2 -> 1 -> 2 pods); a round every 4 steps, so each set of
# knobs runs warm rounds after its first
CONTROL_STEPS = 44
CONTROL_TRACE = "2000@0,1900@1,250@3,2000@20"
CONTROL_EVENTS = ("straggler:pod0x2.0@14,bandwidth:1800@19,"
                  "cloud_left:pod1@24,cloud_joined:pod1@28")
CONTROL_EF_GUARD = 0.98
# phase 3e, the transport seam: the sim transport's knobs (the launcher's
# defaults but for the seed), the measured-mode launcher run's length, the
# emulated WAN hop and the overlap measurement's chunks.  If two inline
# runs of the training step differ, the three runs are held at
# tests/test_torch_trainer.py's tolerances instead of bit for bit
TRANSPORT_STEPS = 4
TRANSPORT_SIM = "sim:fluct=0.25,latency=0.05,seed=0"
TRANSPORT_LAUNCH_STEPS = 20
HOP_MBPS = 10_000.0
OVERLAP_CHUNKS = 8
TRANSPORT_ATOL, TRANSPORT_RTOL = 1e-3, 1e-3
# phase 3f, faults: steps a case (3 rounds at interval 2) and the
# launcher's plan: one failed attempt at step 1, then a rollback-mode crash
# of pod 1 at step 3 (restored from the barrier checkpoint of step 2)
FAULT_STEPS = 6
FAULT_LAUNCH = "fail:x1@1,crash:pod1@3:rollback"
# phase 3g, streaming rounds and the hierarchical transport: steps a case
# (3 rounds at interval 2), the codec's top-k (3e's launcher's) and chunks
# a bucket (so a retune cuts a bucket mid-way and its tail is a strided
# view), (b)'s trace: 2000 Mbps, then 250 from the second round's clock on
# (steps tick 0.5 s; round 2 bills at 1.5 s), an 8x collapse past the
# streaming cliff of 4x; (c)'s four regions at one layer (a relay route
# needs a root that keeps the collapsed link's end: four regions, since
# with three the tree re-roots instead; four pods of two layers do not
# fit one card): the root's links fast, the others slow, eu<->us
# collapsing before round 2, billed without latency or fluctuation (each
# link's belief is its traced bandwidth); the launcher runs' steps
STREAM_STEPS = 6
STREAM_TOPK = 0.05
STREAM_CHUNKS = 4
STREAM_TRACE = ((0.0, 1.5), (2000.0, 250.0))
STREAM_CLIFF = 4.0
STREAM_EF_GUARD = 0.999
STREAM_TOPO_REGIONS = ("us", "eu", "ap", "sa")
STREAM_TOPO_LINK = ("eu", "us")
STREAM_TOPO_FAST, STREAM_TOPO_SLOW = 2000.0, 500.0
STREAM_TOPO_COLLAPSE = ((0.0, 1.0), (2000.0, 20.0))
STREAM_LAUNCH_STEPS = 8
# phase 3h, the async snapshot engine: (a) warm steps (one round) and
# steps timed without and then with a commit in flight; (b) pod1 leaves
# at step 0: staged from the step-0 snapshot (the stage drains the queue,
# the step-2 barrier snapshot with it), reconciled at the step-2 barrier,
# then two steps at 1 pod; (c) pod1 crashes in the step-2 round, rolled
# back to the step-0 snapshot, removed at that barrier, one step after
SNAP_TIMED_STEPS = 2
SNAP_MIGRATE_STEPS = 4
SNAP_EVENT = "cloud_left:pod1@0"
SNAP_CRASH_STEPS = 3
SNAP_CRASH = "crash:pod1@1:rollback"
# phase 5c: gemma3-12b's prefill, 2048 prompt tokens and 8 new ones
GEMMA_NEW_TOKENS = 8
GEMMA_CHECKED_LAYERS = (0, 5)       # a windowed layer and a global one
STRATEGIES_3B = (("asgd_ga", TOPK), ("ama", TOPK), ("asp", TOPK),
                 ("sma", 0.0), ("asgd", 0.0))
# phase 3i: the one-hot forward against the gather's (bit-equal expected:
# a one-hot row selects the row exactly), else within two bf16 steps of
# max|logit|; phases 3's and 3b's step and round times, for 3i to print
ONEHOT_TOL = 2.0 ** -7
PHASE_TIMES: dict = {}
# phase 3i arm (d): serving on the (1, 1, 1) mesh.  The placed step runs
# the same local ops as the unplaced one (every placement ``Replicate``,
# no softmax combined across ranks), so its logits must be bit-equal
MESH_SERVE_LAYERS, MESH_SERVE_PROMPT, MESH_SERVE_NEW = 8, 1024, 8


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def clocked(torch, hook, spent: list, at=lambda: 0):
    """``hook`` fenced by device syncs, its seconds added to
    ``spent[at()]``.  A check hook runs inside a timed serving run; the
    run's prefill seconds and tok/s leave its time out (``at``: the index
    of the prefill it runs in, where each prefill holds checks)."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hook(*args, **kw)
        torch.cuda.synchronize()
        spent[at()] += time.perf_counter() - t0
    return run


def time_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Median device time of one ``fn`` call over ``reps`` runs (CUDA
    events), each of ``TIMED_CALLS`` calls back to back, so that the host's
    work for one call overlaps the device's for the one before, as on a
    model's path.  Kernels, plain versions and library calls alike."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TIMED_CALLS):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / TIMED_CALLS)
    return statistics.median(times)


def same(a, b) -> bool:
    """Equal dtypes, shapes and values, element for element."""
    import torch
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x, y) for x, y in zip(a, b))


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, "nvidia-smi runs")
    print(smi.stdout.strip().splitlines()[0])
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    deterministic(torch)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def deterministic(torch) -> None:
    """f32 matmuls and convolutions in full f32, as the reference's parity
    assumes; cuDNN's deterministic algorithms and no autotuning, so that
    two runs that must agree (phase 3c's ama@8 and sma@8 at 2 pods, phase
    3k's pod processes and the whole run) do not differ by the order of an
    atomic sum or by the algorithm chosen."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.wan_codec import k_per_block

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k = k_per_block(BLOCK, TOPK)

    def check(x, k_block, block, tier):
        kern = ops.wan_encode(x, k_block, block=block, value_dtype=tier)
        plain = ops.wan_encode(x, k_block, block=block, value_dtype=tier,
                               use_kernel=False)
        require(same(kern, plain), f"encode {tier} {tuple(x.shape)} "
                f"k={k_block} block={block} bit-equal to plain")
        n = x.shape[-1]
        dk = ops.wan_decode(*kern, n, block=block, value_dtype=tier)
        dp = ops.wan_decode(*plain, n, block=block, value_dtype=tier,
                            use_kernel=False)
        torch.cuda.synchronize()
        # a NaN equal to a NaN in place: q = 0 times an inf scale
        require(nan_equal(torch, dk, dp), f"decode {tier} {tuple(x.shape)} "
                f"bit-equal to plain")

    big = torch.randn(PODS, 64 << 20, generator=gen, device="cuda")
    edge = torch.randn(PODS, 777_777, generator=gen, device="cuda")
    edge[:, :5000] = 0.25                    # ties
    edge[:, 9000:20000] = 0.0                # all-zero blocks
    # every key in one high-byte bin; ties at the threshold over many
    # threads
    one_bin = torch.sign(edge) * (1 + torch.rand(
        PODS, edge.shape[1], generator=gen, device="cuda"))
    halves = torch.round(edge * 2) / 2
    for tier in ("int8", "fp8", "int4"):
        check(big, k, BLOCK, tier)
        check(edge, k, BLOCK, tier)          # ragged n, odd k (41)
        check(edge[:, 1000:500_000], 7, 128, tier)   # column slice
        check(edge[:, 3:500_003], k, BLOCK, tier)    # not 16-byte aligned
        check(edge, 655, 65536, tier)        # largest block: 128 KB smem
        check(torch.zeros(3000, device="cuda"), 5, 1024, tier)
        check(one_bin, k, BLOCK, tier)
        check(halves, k, BLOCK, tier)
        check(halves, 655, 65536, tier)
        check(edge, 1, BLOCK, tier)          # k_block 1
        check(edge, 300, BLOCK, tier)        # above 256: the general path
        check(edge[:, :5000], 128, 128, tier)        # k_block == block
        print(f"[kernels] {tier}: encode and decode bit-equal to plain on "
              f"{PODS} x {64 << 20} values and the edge cases")
    del big, edge, one_bin, halves

    nf = torch.randn(PODS, 777_777, generator=gen, device="cuda")
    all_nan = nf.clone()
    all_nan[1] = float("nan")
    some = nf.clone()
    some[1, ::7] = float("nan")
    some[0, ::13] = float("inf")
    tail = nf.clone()
    tail[1, -100:] = float("nan")          # the ragged last block
    for tier in ("int8", "fp8", "int4"):
        for x in (all_nan, some, tail):
            check(x, k, BLOCK, tier)
            check(x, 300, BLOCK, tier)     # the general path
            check(x, 655, 65536, tier)     # keys in shared memory
    print("[kernels] NaN and inf inputs (a NaN row beside a finite one, "
          "scattered NaN and inf, NaN in a ragged last block): encode and "
          "decode bit-equal to plain")
    del nf, all_nan, some, tail

    # time both at the main path's size (int8, the main path's tier)
    x = torch.randn(PODS, N_MAIN, generator=gen, device="cuda")
    kern = ops.wan_encode(x, k)
    plain = ops.wan_encode(x, k, use_kernel=False)
    require(same(kern, plain), "encode at main-path size bit-equal")
    dk = ops.wan_decode(*kern, N_MAIN)
    dp = ops.wan_decode(*plain, N_MAIN, use_kernel=False)
    torch.cuda.synchronize()
    dec_err = float((dk - dp).abs().max())
    enc_err = float((ops.wan_decode(*kern, N_MAIN, use_kernel=False)
                     - dp).abs().max())
    del dk, dp, plain
    q, idx, scales = kern
    enc_ms = time_ms(torch, lambda: ops.wan_encode(x, k), reps=20)
    enc_plain_ms = time_ms(torch, lambda: ops.wan_encode(
        x, k, use_kernel=False), reps=5, warm=1)
    dec_ms = time_ms(torch, lambda: ops.wan_decode(q, idx, scales, N_MAIN),
                     reps=20)
    dec_plain_ms = time_ms(torch, lambda: ops.wan_decode(
        q, idx, scales, N_MAIN, use_kernel=False), reps=5, warm=1)
    nb = scales.shape[1]
    vals = (q.float().reshape(PODS, nb, k) * scales[..., None])
    il = idx.reshape(PODS, nb, k).long()
    dec_lib_ms = time_ms(torch, lambda: torch.zeros(
        PODS, nb, BLOCK, device="cuda").scatter_(2, il, vals), reps=20)
    payload = q.numel() + idx.numel() * 4 + scales.numel() * 4
    dense = PODS * N_MAIN * 4
    winners = PODS * nb * k

    def bound(nbytes, flops):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / F32_FLOP_PER_S * 1e3
        return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")

    # encode: |x| and the max per value, a divide and a round per winner
    enc_bound, enc_by = bound(dense + payload, 2 * PODS * N_MAIN + 2 * winners)
    # decode: one multiply per winner
    dec_bound, dec_by = bound(dense + payload, winners)
    del x, q, idx, scales, kern, vals, il
    torch.cuda.empty_cache()
    print(f"[kernels] wan_encode {PODS} x {N_MAIN}: {enc_ms:.3f} ms "
          f"(bound {enc_bound:.3f} ms by {enc_by}, plain {enc_plain_ms:.1f} "
          f"ms, no single PyTorch call)")
    print(f"[kernels] wan_decode {PODS} x {N_MAIN}: {dec_ms:.3f} ms "
          f"(bound {dec_bound:.3f} ms by {dec_by}, plain {dec_plain_ms:.1f} "
          f"ms, zeros().scatter_() {dec_lib_ms:.3f} ms)")
    src = "src/repro_torch/kernels/csrc/wan_codec.cu"
    return {
        "wan_encode": {"name": "wan_encode", "route": "cuda", "source": src,
                       "replaces": "src/repro/kernels/wan_codec.py:196",
                       "max_abs_err": enc_err, "ms": enc_ms,
                       "plain_ms": enc_plain_ms, "bound_ms": enc_bound,
                       "bound_by": enc_by, "library_ms": None},
        "wan_decode": {"name": "wan_decode", "route": "cuda", "source": src,
                       "replaces": "src/repro/kernels/wan_codec.py:219",
                       "max_abs_err": dec_err, "ms": dec_ms,
                       "plain_ms": dec_plain_ms, "bound_ms": dec_bound,
                       "bound_by": dec_by, "library_ms": dec_lib_ms},
    }


def flash_close(torch, out, expect, what: str) -> float:
    """Hold a flash output to its plain version at the dtype's tolerance;
    returns the largest absolute difference."""
    tol = FLASH_TOL[str(out.dtype)]
    diff = (out.float() - expect.float()).abs()
    bad = diff > tol + tol * expect.float().abs()
    require(not bool(bad.any()) and bool(torch.isfinite(out).all()),
            f"flash {what} within {tol} of ref.sdpa "
            f"(max |diff| {float(diff.max()):.3g})")
    return float(diff.max())


def phase_flash(torch) -> dict:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(B, S, H, K, Dh, dtype, Sk=None):
        return [torch.randn(B, n_s, n, Dh, generator=gen, device="cuda"
                            ).to(dtype)
                for n_s, n in ((S, H), (Sk or S, K), (Sk or S, K))]

    def check(B, S, H, K, Dh, dtype, causal=True, window=None,
              softcap=0.0, Sk=None):
        q, k, v = inputs(B, S, H, K, Dh, dtype, Sk)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
        expect = ref.sdpa(q, k, v, causal=causal, window=window,
                          softcap=softcap)
        torch.cuda.synchronize()
        return flash_close(torch, out, expect, f"{(B, S, H, K, Dh)} {dtype} "
                           f"Sk={Sk or S} causal={causal} window={window} "
                           f"softcap={softcap}")

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ((1, 2048, 32, 8, 128, bf16), {}),            # the serving prefill
        ((1, 1000, 32, 8, 128, bf16), {}),            # ragged S
        ((1, 2048, 32, 1, 128, bf16), {}),            # MQA
        ((1, 1024, 32, 8, 128, f32), {}),             # f32 inputs
        ((1, 1024, 32, 8, 128, bf16), {"causal": False}),
        ((1, 1024, 32, 16, 128, bf16), {"window": 256, "softcap": 50.0}),
        ((1, 1024, 16, 8, 256, bf16), {}),            # Dh 256
        ((2, 2048, 12, 2, 128, bf16), {}),            # qwen2-vl: 6 a group
        ((1, 1000, 12, 2, 128, f32), {}),
    ]
    # the reference's kernel tests (tests/test_kernels.py)
    for shape in ((2, 128, 4, 2, 64), (1, 256, 4, 4, 64), (2, 96, 6, 2, 32),
                  (1, 64, 8, 1, 128)):
        cases += [(shape + (f32,), {}), (shape + (bf16,), {})]
    cases += [((1, 128, 4, 2, 64, f32), {"window": w, "softcap": c})
              for w in (16, 64) for c in (0.0, 30.0)]
    cases.append(((2, 64, 2, 2, 32, f32), {"causal": False}))
    # the tensor-core (bf16) path: every head dim, less than one tile,
    # Sq != Sk both ways, MQA, non-causal, window and soft-cap
    cases += [((1, 1024, 16, 4, dh, bf16), {"causal": c})
              for dh in (32, 64, 128, 256) for c in (True, False)]
    cases += [((2, s, 8, 2, 128, bf16), {}) for s in (1, 5, 17, 65)]
    cases += [((2, sq, 8, 2, 128, bf16), {"Sk": sk, "causal": c})
              for sq, sk in ((100, 300), (300, 100), (17, 1000))
              for c in (True, False)]
    cases += [((1, 1000, 16, 1, 64, bf16), {}),
              ((1, 333, 4, 2, 64, bf16), {"window": 16, "softcap": 30.0}),
              ((1, 333, 4, 2, 64, bf16), {"window": 64}),
              ((1, 2048, 32, 8, 128, bf16), {"window": 700})]
    for shape, kw in cases:
        check(*shape, **kw)
    # strided views read in place, and a misaligned one refused
    qkv = torch.randn(2, 100, 8, 64, generator=gen, device="cuda").to(bf16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    flash_close(torch, ops.flash_attention(q, k, v), ref.sdpa(q, k, v),
                "bf16 strided views")
    before = ops.LAUNCHES["flash_attention"]
    wide = torch.randn(1, 64, 4, 72, generator=gen, device="cuda").to(bf16)
    try:
        ops.flash_attention(*([wide[..., 1:65]] * 3))
        refused = False
    except ValueError as e:
        refused = "aligned" in str(e)
    require(refused and ops.LAUNCHES["flash_attention"] == before,
            "a misaligned bf16 view is refused with ValueError, unlaunched")
    print(f"[flash] kernel within tolerance of ref.sdpa on {len(cases) + 1} "
          f"cases (the serving shape, ragged S, MQA, qwen2-vl's GQA group "
          f"of 6, f32, non-causal, "
          f"window+softcap, Dh 32-256, S 1-65, Sq != Sk, strided views, "
          f"the reference's kernel tests); a misaligned view refused")

    entry = time_flash(torch, inputs(1, SERVE_PROMPT_LEN, 32, 8, 128, bf16))
    # qwen2-vl-2b's prefill shape (phase 6f): a GQA group of 6
    time_flash(torch, inputs(1, VL_PROMPT, 12, 2, 128, bf16))
    return {"flash_attention": {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33", **entry}}


def time_flash(torch, qkv) -> dict:
    """Hold the causal flash kernel to ``ref.sdpa`` on ``qkv`` and time it
    (ms, TFLOP/s) beside its bound, its plain version and
    ``F.scaled_dot_product_attention``; prints one ``[flash]`` line."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    q, k, v = qkv
    B, S, H, Dh = q.shape
    K = k.shape[2]
    out = ops.flash_attention(q, k, v)
    err = flash_close(torch, out, ref.sdpa(q, k, v),
                      f"timed shape {(B, S, H, K, Dh)}")
    ms = time_ms(torch, lambda: ops.flash_attention(q, k, v), reps=50)
    plain_ms = time_ms(torch, lambda: ref.sdpa(q, k, v), reps=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=50)
    flops = 2 * B * S * S * H * Dh              # causal QK^T and PV
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    f_ms = flops / BF16_FLOP_PER_S * 1e3
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes")
    print(f"[flash] {(B, S, H, K, Dh)} bf16 causal: {ms:.4f} ms = "
          f"{flops / ms / 1e9:.1f} TFLOP/s (bound {bound:.4f} ms by {by}: "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; plain "
          f"{plain_ms:.3f} ms, F.scaled_dot_product_attention {lib_ms:.4f} "
          f"ms = {ms / lib_ms:.2f}x), max |err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def codec_round_check(torch, rounds: list):
    """A ``round_hook`` holding each single-bucket codec round to its
    definition: the EF residual == ``flat - local``, the kernel's decode of
    the shipped payload == the plain decode, bit for bit; appends the EF
    residual's norm to ``rounds``.  Its compare launches are not the main
    path's and leave the counts as they were."""
    from repro_torch.core import sync as S
    from repro_torch.kernels import ops

    def check_round(state, payloads, shipped, sync):
        counts = dict(ops.LAUNCHES)
        ef = state.sync_state.ef_residual
        require(torch.equal(ef, payloads.flat - payloads.local),
                "EF residual == flat - local")
        n = payloads.flat.shape[1]
        bcfg = sync.for_bucket("all")
        kern = S._decode_bucket(bcfg, shipped["all"], n)
        widths = S._chunk_widths(bcfg, n)
        plain = S._cat([ops.wan_decode(
            c.q, c.idx.to(torch.int32), c.scales, m, block=BLOCK,
            use_kernel=False) for c, m in zip(shipped["all"], widths)])
        require(torch.equal(kern, plain), "peer decode kernel == plain")
        rounds.append(float(ef.norm()))
        ops.LAUNCHES.update(counts)
    return check_round


def phase_main_path(torch) -> dict:
    from repro_torch import tree as T
    from repro_torch.configs import granite_8b
    from repro_torch.core import sync as S
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_batches
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = granite_8b.CONFIG.replace(n_layers=2)
    sync = S.SyncConfig("asgd_ga", 2, compress_topk=TOPK, quantize_int8=True,
                        error_feedback=True)
    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0) for i in range(PODS))
    plan = build_training_plan(TrainingRequest(
        model=cfg.name, clouds=clouds, sync=sync, n_iters=4,
        global_batch=8))
    batches = make_batches(plan, cfg.vocab_size, 512, "cuda")
    rounds = []
    trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                      lambda g: transformer.init_params(g, cfg, "cuda"),
                      TrainerConfig(n_pods=PODS, optimizer="sgd", lr=0.02,
                                    sync=sync),
                      device="cuda", round_hook=codec_round_check(torch,
                                                                  rounds))
    state = trainer.init_state(SEED)
    leaves = T.leaves(state.params)
    n_params = sum(x.numel() for x in leaves) // PODS
    require(n_params == N_MAIN, f"{n_params} params per pod")
    model_mb = sum(x.numel() * x.element_size() for x in leaves) / PODS / 1e6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, hist = trainer.fit(state, batches, 4, model_mb=model_mb)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = hist["loss_per_pod"]
    require(all(math.isfinite(v) for row in losses for v in row),
            f"finite losses {losses}")
    require(len(rounds) == 2, f"2 sync rounds checked, got {len(rounds)}")
    require(launches == {"wan_encode": 2, "wan_decode": 4,
                         "flash_attention": 0, "ssd_scan": 0,
                         "topk_compress": 0},
            f"main path launches {launches}")
    for leaf in T.leaves(state.params):
        require(bool(torch.isfinite(leaf).all()), "finite params")
    print(f"[main] {cfg.name} x2 layers, {n_params:,} params/pod, {PODS} "
          f"pods, batch 8, seq 512: losses {losses}")
    PHASE_TIMES["3"] = (trainer.step_seconds, trainer.sync_seconds)
    print(f"[main] step s {[round(t, 4) for t in trainer.step_seconds]}, "
          f"sync-round s {[round(t, 4) for t in trainer.sync_seconds]}, "
          f"EF residual norms {rounds}, peak memory {peak_gb:.2f} GB, "
          f"launches {launches}")
    return launches


def bucketed_round_check(torch):
    """A ``round_hook`` for the launcher's codec rounds under any bucket
    policy, streamed or not, and what it fills: launches by tier, each
    round's worst-pod EF ratios by bucket, and the launch counts at the
    last round.  Call ``mark.update(ops.LAUNCHES)`` just after resetting
    the counts."""
    from repro_torch.core import sync as S
    from repro_torch.kernels import ops

    per_tier: dict = {}
    checked = []
    mark = {}

    def tally(tier, enc, dec):
        t = per_tier.setdefault(tier, {"wan_encode": 0, "wan_decode": 0})
        t["wan_encode"] += enc
        t["wan_decode"] += dec

    def decode_held(bcfg, chunks, widths, n_total, what):
        block = min(bcfg.codec_block, max(1, n_total))
        kern, plain = (S._cat([ops.wan_decode(
            c.q, c.idx.to(torch.int32), c.scales, m, block=block,
            value_dtype=bcfg.value_dtype, use_kernel=use)
            for c, m in zip(chunks, widths)]) for use in (True, False))
        require(torch.equal(kern, plain),
                f"round {len(checked)} {what} ({bcfg.value_dtype}@"
                f"{bcfg.compress_topk}): peer decode kernel == plain")

    def check_round(state, payloads, shipped, sync, retune=None):
        """EF residual == flat - local (after a streaming retune,
        ``payloads.local`` holds the spliced reconstruction); each shipped
        chunk's kernel decode == its plain decode, bit for bit: the prefix
        at the bucket's tier, a re-encoded tail at the retune's tier and
        the tail's width; the round's launches are one encode and one local
        decode per chunk, one peer decode per shipped prefix chunk, and one
        encode and two decodes per tail chunk.  The compare launches leave
        the counts as they were."""
        counts = dict(ops.LAUNCHES)
        enc = counts["wan_encode"] - mark["wan_encode"]
        dec = counts["wan_decode"] - mark["wan_decode"]
        require(torch.equal(state.sync_state.ef_residual,
                            payloads.flat - payloads.local),
                f"round {len(checked)}: EF residual == flat - local")
        layout = S.bucket_layout(sync, state.sync_state.ga_buffer)
        want = [0, 0]
        for g, name in enumerate(layout.names):
            size = layout.sizes[g]
            if not size:
                continue
            bcfg = sync.for_bucket(name)
            widths = S._chunk_widths(bcfg, size)
            n_sent = (len(widths) if retune is None
                      else retune.sent.get(name, len(widths)))
            if n_sent:
                decode_held(bcfg, shipped[name][:n_sent], widths[:n_sent],
                            size, name)
            tally(bcfg.value_dtype, len(widths), len(widths) + n_sent)
            want[0] += len(widths)
            want[1] += len(widths) + n_sent
            if n_sent < len(widths):
                tcfg = retune.cfg_to.for_bucket(name)
                tw = size - sum(widths[:n_sent])
                twidths = S._chunk_widths(tcfg, tw)
                decode_held(tcfg, retune.tail_shipped[name], twidths, tw,
                            f"{name} tail")
                tally(tcfg.value_dtype, len(twidths), 2 * len(twidths))
                want[0] += len(twidths)
                want[1] += 2 * len(twidths)
        require([enc, dec] == want,
                f"round {len(checked)}: {enc} encodes, {dec} decodes, want "
                f"{want}")
        ratios = (state.sync_state.resid_norm
                  / state.sync_state.msg_norm.clamp_min(1e-30)).amax(0)
        checked.append([round(float(r), 4) for r in ratios.cpu()])
        ops.LAUNCHES.update(counts)
        mark.update(counts)

    return check_round, per_tier, checked, mark


def phase_control_loop(torch, device: str = "cuda", cfg=None,
                       seq: int = 512) -> dict:
    """Phase 3d: the launcher's control loop (``--events``, ``--wan-trace``,
    ``--adaptive-sync`` under ``--bucket-policy layer-class``) training
    granite-8b x2 layers at full width; every codec round held to its
    definition at the tiers it runs.  Returns the codec launches."""
    from repro_torch.configs import granite_8b
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    cfg = cfg or granite_8b.CONFIG.replace(n_layers=2)
    check_round, per_tier, checked, mark = bucketed_round_check(torch)

    argv = ["--pods", str(PODS), "--steps", str(CONTROL_STEPS), "--batch",
            "8", "--seq", str(seq), "--interval", "2", "--compress-topk",
            "0.05", "--int8", "--error-feedback", "--bucket-policy",
            "layer-class", "--adaptive-sync", "--wan-trace", CONTROL_TRACE,
            "--ef-guard", str(CONTROL_EF_GUARD), "--events", CONTROL_EVENTS,
            "--log-every", "0", "--device", device]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    mark.update(ops.LAUNCHES)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = train.main(argv, model_cfg=cfg, round_hook=check_round)
    launches = dict(ops.LAUNCHES)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device == "cuda" else float("nan"))
    text = buf.getvalue()
    print("\n".join(line for line in text.splitlines()
                    if line.startswith(("[control-plane]", "[train]",
                                        "[autotune]", "[elasticity]"))))
    applied = [n for _, n, _ in summary["reconfigs_at"]]
    rounds = summary["rounds"]
    require(len(checked) == len(rounds) > 0,
            f"{len(checked)} of {len(rounds)} codec rounds checked")
    require(summary["retunes"] >= 2, f"{summary['retunes']} retunes")
    low = [r for r in rounds if "fp8" in r[1] or "int4" in r[1]]
    require(len(low) > 0, "a round ran at an fp8 or int4 rung")
    require(1 in applied and applied.index(1) < len(applied) - 1
            and applied[applied.index(1) + 1:].count(2) > 0
            and summary["final_pods"] == 2,
            f"pods 2 -> 1 -> 2 through applied reconfigs {applied}")
    require(math.isfinite(summary["loss_last"]), "finite loss")
    total = {k: sum(t[k] for t in per_tier.values())
             for k in ("wan_encode", "wan_decode")}
    require(launches == {"wan_encode": total["wan_encode"],
                         "wan_decode": total["wan_decode"],
                         "flash_attention": 0, "ssd_scan": 0,
                         "topk_compress": 0},
            f"control-loop launches {launches} == per-tier sums {total}")
    # a round's time by the knobs it ran at: the first round at new knobs
    # (after a retune or a reconfig) apart from the warm ones after it
    dec_steps = [d["step"] for d in summary["decisions"]]
    rc_steps = [s for s, _, _ in summary["reconfigs_at"]]
    first, warm, prev = [], {}, 0
    for i, (step, label, sec) in enumerate(rounds):
        if (i == 0 or label != rounds[i - 1][1]
                or any(prev < s <= step for s in dec_steps)
                or any(prev <= s < step for s in rc_steps)):
            first.append([step, label, round(sec, 4)])
        else:
            warm.setdefault(label, []).append(round(sec, 4))
        prev = step
    print(f"[control] {cfg.name} x{cfg.n_layers} layers, {PODS} pods, "
          f"batch 8, seq {seq}: {summary['retunes']} retunes, "
          f"{summary['reconfigs']} reconfigs applied (pods {applied}), "
          f"final pods {summary['final_pods']}, final tier "
          f"{summary['final_tier']}, max EF ratio {summary['max_ef_ratio']} "
          f"(per bucket {summary['max_ef_ratio_by_bucket']}, guard "
          f"{CONTROL_EF_GUARD})")
    for d in summary["decisions"]:
        print(f"[control] decision at step {d['step']}: {d['tiers']}, "
              f"interval {d['interval']}: {d['summary']}")
    print(f"[control] rounds (step, knobs, s): "
          f"{[[r[0], r[1], round(r[2], 4)] for r in rounds]}")
    print(f"[control] per-round worst-pod EF ratios by bucket: {checked}")
    print(f"[control] warm round s by knobs: "
          f"{warm}; first round at new knobs (retune or reconfig) {first}; "
          f"reconfig barriers (step, pods, s) "
          f"{[[a, b, round(t, 4)] for a, b, t in summary['reconfigs_at']]}"
          f"; launches by tier {per_tier}; peak memory {peak_gb:.2f} GB")
    return {k: launches[k] for k in ("wan_encode", "wan_decode")}


def same_as_ring(torch, check_round, shipped_checked: list):
    """A ``round_hook`` that holds each bucket's shipped chunks bit-equal to
    the inline ring's ship of the same payloads, then runs
    ``check_round`` (3d's checks) on the round."""
    from repro_torch.core import sync as S

    def hook(state, payloads, shipped, sync):
        for name, chunks in payloads.chunks.items():
            ring = S._INLINE_RING.ship_bucket(name, chunks, sync.peer_shift)
            require(len(ring) == len(shipped[name])
                    and all(same(a, b) for a, b in zip(ring, shipped[name])),
                    f"round {len(shipped_checked)} {name}: shipped == the "
                    f"inline ring's bytes")
        shipped_checked.append(sorted(payloads.chunks))
        check_round(state, payloads, shipped, sync)

    return hook


def transport_run(torch, cfg, sync, batches, transport, device: str,
                  steps: int) -> dict:
    """Train ``steps`` steps through ``Trainer.fit`` over ``transport``
    (``None``: the inline ring), every round held as 3d's are and, over a
    transport, to the inline ring's bytes.  Returns the final state's
    params, EF residual and tier, the per-round norms, the launches and the
    trainer's times."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    check_round, _, checked, mark = bucketed_round_check(torch)
    norms, shipped_checked = [], []

    def hook(state, payloads, shipped, sync):
        norms.append((state.sync_state.msg_norm.clone(),
                      state.sync_state.resid_norm.clone()))
        check_round(state, payloads, shipped, sync)

    trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                      lambda g: transformer.init_params(g, cfg, device),
                      TrainerConfig(n_pods=PODS, optimizer="sgd", lr=0.02,
                                    sync=sync),
                      device=device,
                      round_hook=(hook if transport is None else
                                  same_as_ring(torch, hook, shipped_checked)),
                      transport=transport)
    state = trainer.init_state(SEED)
    if device == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    mark.update(ops.LAUNCHES)
    state, hist = trainer.fit(state, batches, steps)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in ("wan_encode", "wan_decode")}
    require(all(math.isfinite(v) for row in hist["loss_per_pod"]
                for v in row), "finite losses")
    require(len(checked) == steps // sync.interval,
            f"{len(checked)} codec rounds checked")
    require(transport is None or len(shipped_checked) == len(checked),
            "every round's shipped bytes checked")
    out = {"params": state.params, "ef": state.sync_state.ef_residual,
           "tier": state.sync_state.tier, "norms": norms,
           "launches": launches, "sync_s": list(trainer.sync_seconds),
           "step_s": list(trainer.step_seconds),
           "buckets": shipped_checked[0] if shipped_checked else None}
    del state, trainer
    return out


def stream_diff(torch, a: dict, b: dict, exact: bool) -> list:
    """What differs between two runs' final params, EF residual, tier and
    per-round norms: bit for bit, or at ``TRANSPORT_ATOL`` /
    ``TRANSPORT_RTOL``."""
    from repro_torch import tree as T

    def close(x, y):
        if exact:
            return x.dtype == y.dtype and torch.equal(x, y)
        return torch.allclose(x.float(), y.float(), atol=TRANSPORT_ATOL,
                              rtol=TRANSPORT_RTOL)

    bad = []
    for i, (x, y) in enumerate(zip(T.leaves(a["params"]),
                                   T.leaves(b["params"]))):
        if not close(x, y):
            bad.append(f"param leaf {i}")
    if not close(a["ef"], b["ef"]):
        bad.append("ef_residual")
    if not torch.equal(a["tier"], b["tier"]):
        bad.append("tier")
    if len(a["norms"]) != len(b["norms"]):
        bad.append("number of rounds")
    for r, ((ma, ra), (mb, rb)) in enumerate(zip(a["norms"], b["norms"])):
        if not (close(ma, mb) and close(ra, rb)):
            bad.append(f"round {r} norms")
    return bad


def phase_transport(torch, device: str = "cuda", cfg=None, seq: int = 512,
                    n_elems: int = N_MAIN) -> dict:
    """Phase 3e: the transport seam (``SimTransport``, ``MeshTransport``,
    the launcher's ``--transport``) at granite-8b width.  Returns the codec
    launches of its runs."""
    from repro_torch.configs import granite_8b
    from repro_torch.core import sync as S
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.core.transport import (MeasuredWanProbe, MeshTransport,
                                            SimTransport)
    from repro_torch.core.wan import WANConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    cfg = cfg or granite_8b.CONFIG.replace(n_layers=2)
    sync = S.SyncConfig("asgd_ga", 2, compress_topk=TOPK, quantize_int8=True,
                        error_feedback=True, bucket_policy="layer-class")

    def peak_gb() -> float:
        return (torch.cuda.max_memory_allocated() / 1e9
                if device == "cuda" else float("nan"))

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0) for i in range(PODS))
    plan = build_training_plan(TrainingRequest(
        model=cfg.name, clouds=clouds, sync=sync, n_iters=TRANSPORT_STEPS,
        global_batch=8))
    batches = train.make_batches(plan, cfg.vocab_size, seq, device)
    trace = train.parse_wan_trace(CONTROL_TRACE, TRANSPORT_STEPS, 0.5)
    total = {"wan_encode": 0, "wan_decode": 0}

    def tally(launches):
        for k in total:
            total[k] += launches[k]

    # 1. three-way parity: inline, sim, mesh
    inline = transport_run(torch, cfg, sync, batches, None, device,
                           TRANSPORT_STEPS)
    tally(inline["launches"])
    sim = SimTransport(trace, WANConfig(fluctuation=0.25, seed=0),
                       probe=MeasuredWanProbe())
    mesh = MeshTransport(probe=MeasuredWanProbe())
    runs, diffs, loose = {}, {}, {}
    for name, tr in (("sim", sim), ("mesh", mesh)):
        run = transport_run(torch, cfg, sync, batches, tr, device,
                            TRANSPORT_STEPS)
        tally(run["launches"])
        # compare now and keep only the verdicts: each run's final state
        # is ~10 GB of the card's memory
        diffs[name] = stream_diff(torch, inline, run, True)
        loose[name] = stream_diff(torch, inline, run, False)
        runs[name] = {k: run[k] for k in ("launches", "sync_s", "step_s",
                                          "buckets")}
        del run
    buckets = runs["mesh"]["buckets"]
    n_rounds = TRANSPORT_STEPS // sync.interval
    require(buckets == ["dense", "embed", "norm"],
            f"three non-empty buckets, got {buckets}")
    exact = True
    if any(diffs.values()):
        # is the training step itself deterministic here?
        again = transport_run(torch, cfg, sync, batches, None, device,
                              TRANSPORT_STEPS)
        tally(again["launches"])
        twice = stream_diff(torch, inline, again, True)
        require(bool(twice), f"inline runs agree bit for bit but the "
                f"transports' differ: {diffs}")
        print(f"[transport] two inline runs differ ({twice[:4]}...): the "
              f"streams are held at atol {TRANSPORT_ATOL}, rtol "
              f"{TRANSPORT_RTOL}")
        del again
        exact = False
        diffs = loose
    require(not any(diffs.values()), f"sim and mesh streams == inline: "
            f"{diffs}")
    for k, r in runs.items():
        require(r["launches"] == inline["launches"],
                f"{k} launches {r['launches']} == inline "
                f"{inline['launches']}")
    require(len(mesh.records) == len(buckets) * n_rounds
            and all(r.seconds > 0 for r in mesh.records),
            f"one positive record per bucket per round, got "
            f"{[(r.bucket, r.seconds) for r in mesh.records]}")
    require(mesh.probe.n_observations == n_rounds,
            f"{mesh.probe.n_observations} mesh probe observations")
    sharded = mesh.sharding(PODS, device) is not None
    print(f"[transport] {cfg.name} x{cfg.n_layers} layers, {PODS} pods, "
          f"batch 8, seq {seq}, buckets {buckets}: sim and mesh ship the "
          f"inline ring's bytes every round; streams equal "
          f"{'bit for bit' if exact else 'within tolerance'}; launches "
          f"{inline['launches']} each; mesh "
          f"{'sharded' if sharded else 'unsharded'} over "
          f"{len(mesh.devices(device))} device(s); peak memory "
          f"{peak_gb():.2f} GB")
    for k, r in (("inline", inline), *runs.items()):
        print(f"[transport] {k}: sync-round s "
              f"{[round(t, 4) for t in r['sync_s']]}, step s "
              f"{[round(t, 4) for t in r['step_s']]}")
    print(f"[transport] mesh records (bucket, MB, s): "
          f"{[(r.bucket, round(r.payload_mb, 4), r.seconds) for r in mesh.records]}"
          f"; sim records (bucket, MB, s): "
          f"{[(r.bucket, round(r.payload_mb, 4), r.seconds) for r in sim.records]}")
    del inline, runs
    if device == "cuda":
        torch.cuda.empty_cache()

    # 2. the launcher in measured mode: the controllers read only the
    #    sim transport's billed transfers
    check_round, per_tier, checked, mark = bucketed_round_check(torch)
    made = []
    parse = train.parse_transport

    def keep(*args):
        made.append(parse(*args))
        return made[-1]

    argv = ["--pods", str(PODS), "--steps", str(TRANSPORT_LAUNCH_STEPS),
            "--batch", "8", "--seq", str(seq), "--interval", "2",
            "--compress-topk", "0.05", "--int8", "--error-feedback",
            "--bucket-policy", "layer-class", "--adaptive-sync",
            "--wan-trace", CONTROL_TRACE, "--ef-guard",
            str(CONTROL_EF_GUARD), "--transport", TRANSPORT_SIM,
            "--log-every", "0", "--device", device]
    ops.reset_launches()
    mark.update(ops.LAUNCHES)
    buf = io.StringIO()
    train.parse_transport = keep
    try:
        with contextlib.redirect_stdout(buf):
            summary = train.main(argv, model_cfg=cfg, round_hook=check_round)
    finally:
        train.parse_transport = parse
    tally(ops.LAUNCHES)
    print("\n".join(line for line in buf.getvalue().splitlines()
                    if line.startswith(("[transport]", "[autotune]"))))
    tr = made[0]
    rounds = summary["rounds"]
    require(len(checked) == len(rounds) > 0,
            f"{len(checked)} of {len(rounds)} codec rounds checked")
    require(summary["transfers"] == len(tr.records) > 0,
            f"transfers {summary['transfers']} == {len(tr.records)} records")
    require(tr.probe.n_observations >= len(rounds),
            f"{tr.probe.n_observations} probe observations for "
            f"{len(rounds)} rounds")
    require(summary["measured_bandwidth_mbps"] is not None,
            "a measured bandwidth")
    # the collapse is billed in the round of step 3 (index); the
    # controller can act on it from the next step's update (step 5, 1-based)
    after = [d for d in summary["decisions"] if d["step"] >= 5]
    require(len(after) > 0, f"a retune after the collapse: "
            f"{summary['decisions']}")
    by_step: dict = {}
    for r in tr.records:
        by_step.setdefault(r.step, {})[r.bucket] = r.payload_mb
    replay = SimTransport(tr.trace, tr.wan)
    for step in range(TRANSPORT_LAUNCH_STEPS):
        if step in by_step:
            replay.on_sync(by_step[step], step=step)
        replay.tick(0.5)
    require([(r.bucket, r.payload_mb, r.seconds, r.step)
              for r in replay.records]
             == [(r.bucket, r.payload_mb, r.seconds, r.step)
                 for r in tr.records],
             "the billing replays float for float")
    print(f"[transport] measured mode: {summary['retunes']} retunes, "
          f"{len(rounds)} rounds, {summary['transfers']} transfers, "
          f"{tr.probe.n_observations} probe observations, belief "
          f"{summary['measured_bandwidth_mbps']} Mbps; billing replayed "
          f"float for float")
    for d in summary["decisions"]:
        print(f"[transport] decision at step {d['step']}: {d['tiers']}, "
              f"interval {d['interval']}: {d['summary']}")
    achieved = {}
    for r in tr.records:
        achieved.setdefault(r.step, []).append(round(r.mbps, 3))
    print(f"[transport] achieved Mbps by round (step: per bucket): "
          f"{achieved}; rounds (step, knobs, s): "
          f"{[[r[0], r[1], round(r[2], 4)] for r in rounds]}; launches by "
          f"tier {per_tier}")
    del made, tr
    if device == "cuda":
        torch.cuda.empty_cache()

    # 3. the emulated hop
    hop = MeshTransport(probe=MeasuredWanProbe(), emulate_mbps=HOP_MBPS)
    run = transport_run(torch, cfg, sync, batches, hop, device,
                        TRANSPORT_STEPS)
    tally(run["launches"])
    short = [(r.bucket, r.seconds, r.payload_mb * 8.0 / HOP_MBPS)
             for r in hop.records
             if r.seconds < r.payload_mb * 8.0 / HOP_MBPS]
    require(len(hop.records) == len(buckets) * n_rounds and not short,
            f"every hop record at least its hop time: {short}")
    hop_mb = {}
    for r in hop.records:
        hop_mb[r.step] = hop_mb.get(r.step, 0.0) + r.payload_mb
    print(f"[transport] emulated {HOP_MBPS:.0f} Mbps hop: records (bucket, "
          f"MB, s, hop s) "
          f"{[(r.bucket, round(r.payload_mb, 4), r.seconds, r.payload_mb * 8.0 / HOP_MBPS) for r in hop.records]}"
          f"; MB a pod a round {hop_mb}; sync-round s "
          f"{[round(t, 4) for t in run['sync_s']]}")
    del run
    if device == "cuda":
        torch.cuda.empty_cache()

    # 4. what overlap_chunks pipelining buys against the emulated hop
    ocfg = S.SyncConfig("asgd_ga", 2, compress_topk=TOPK, quantize_int8=True,
                        error_feedback=True, overlap_chunks=OVERLAP_CHUNKS)
    ops.reset_launches()
    rep = MeshTransport(emulate_mbps=HOP_MBPS).measure_overlap(
        ocfg, n_pods=PODS, n_elems=n_elems, reps=3, device=device)
    tally(ops.LAUNCHES)
    require(rep["chunks"] == OVERLAP_CHUNKS and rep["overlap_speedup"] > 0,
            f"overlap report {rep}")
    print(f"[transport] overlap at {HOP_MBPS:.0f} Mbps, {PODS} x "
          f"{n_elems:,} values: {json.dumps(rep)}")
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"[transport] phase 3e: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {total}, peak memory {peak_gb():.2f} GB")
    return total


def nan_equal(torch, a, b) -> bool:
    """Equal dtypes, shapes and values, NaN equal to NaN in place (a
    corrupted scale decodes q = 0 to NaN on both sides)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if torch.equal(a, b):
        return True
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, torch.zeros_like(a), a),
        torch.where(nb, torch.zeros_like(b), b)))


def fault_round_check(torch, transport, first=0, n_pods=PODS):
    """A ``round_hook`` for rounds over any transport, a chaos-wrapped one
    included, run by a process that holds the pods' rows from global pod
    ``first`` on, of ``n_pods`` (either may be a function that reads it at
    the round, for a run that reconfigures): each shipped chunk's kernel
    decode (a corrupted one
    included) == its plain decode, NaN equal in place, the prefix at the
    bucket's tier and a streaming retune's tails at the retune's; the
    round's launches are one encode and one local decode per chunk and one
    peer decode per shipped chunk; a sender whose message was delivered
    keeps ``flat - local`` as its EF residual (the spliced local after a
    retune), one whose message was not keeps the whole ``flat`` and its
    norms read 0 (the reference's degraded-round rule,
    ``repro/core/sync.py:969-980``).  The compare launches leave the
    counts as they were."""
    from repro_torch.core import sync as S
    from repro_torch.kernels import ops

    checked, mark = [], {}

    def decode_held(bcfg, chunks, widths, n_total, what):
        # chunk by chunk: at full width a bucket's decode, twice, beside
        # the round's buffers would not fit the card
        block = min(bcfg.codec_block, max(1, n_total))
        for i, (c, m) in enumerate(zip(chunks, widths)):
            kern, plain = (ops.wan_decode(
                c.q, c.idx.to(torch.int32), c.scales, m, block=block,
                value_dtype=bcfg.value_dtype, use_kernel=use)
                for use in (True, False))
            require(nan_equal(torch, kern, plain),
                    f"round {len(checked)} {what} chunk {i}: peer decode "
                    f"kernel == plain")
            del kern, plain

    def hook(state, payloads, shipped, sync, retune=None):
        counts = dict(ops.LAUNCHES)
        enc = counts["wan_encode"] - mark["wan_encode"]
        dec = counts["wan_decode"] - mark["wan_decode"]
        ss = state.sync_state
        n = n_pods() if callable(n_pods) else n_pods
        at = first() if callable(first) else first
        failed = tuple(getattr(transport, "round_failed_pods", ()) or ())
        alive = [0 if p in failed else 1 for p in range(n)]
        delivered = [alive[p] * alive[(p + sync.peer_shift) % n]
                     for p in range(n)]
        for i in range(ss.ef_residual.shape[0]):
            p = at + i
            want = (payloads.flat[i] - payloads.local[i] if delivered[p]
                    else payloads.flat[i])
            require(nan_equal(torch, ss.ef_residual[i], want),
                    f"round {len(checked)} pod {p}: EF residual == "
                    f"{'flat - local' if delivered[p] else 'flat'}")
            if not delivered[p]:
                require(float(ss.msg_norm[i].abs().sum()) == 0.0
                        and float(ss.resid_norm[i].abs().sum()) == 0.0,
                        f"round {len(checked)} pod {p}: undelivered norms "
                        f"read 0")
        layout = S.bucket_layout(sync, ss.ga_buffer)
        want_launches = [0, 0]
        for g, name in enumerate(layout.names):
            size = layout.sizes[g]
            if not size:
                continue
            bcfg = sync.for_bucket(name)
            widths = S._chunk_widths(bcfg, size)
            n_sent = (len(widths) if retune is None
                      else retune.sent.get(name, len(widths)))
            if n_sent:
                decode_held(bcfg, shipped[name][:n_sent], widths[:n_sent],
                            size, name)
            want_launches[0] += len(widths)
            want_launches[1] += len(widths) + n_sent
            if n_sent < len(widths):
                tcfg = retune.cfg_to.for_bucket(name)
                tw = size - sum(widths[:n_sent])
                twidths = S._chunk_widths(tcfg, tw)
                decode_held(tcfg, retune.tail_shipped[name], twidths, tw,
                            f"{name} tail")
                want_launches[0] += len(twidths)
                want_launches[1] += 2 * len(twidths)
        require([enc, dec] == want_launches,
                f"round {len(checked)}: {enc} encodes, {dec} decodes, want "
                f"{want_launches}")
        checked.append({"failed": failed, "delivered": delivered,
                        "retuned": retune is not None})
        ops.LAUNCHES.update(counts)
        mark.update(counts)

    return hook, checked, mark


def fault_run(torch, cfg, sync, batches, transport, device: str,
              steps: int = FAULT_STEPS, keep_state: bool = False) -> dict:
    """Train ``steps`` steps over ``transport`` as the launcher's loop does
    (the sim clock ticks 0.5 s a step), every round held by
    ``fault_round_check``.  A round that completes without some pods
    (``round_failed_pods``) is held to its definition on the parameters
    too: a pod whose ring sender is dead keeps its pre-round parameters
    bit for bit.  Returns the final params, EF residual, tier, per-round
    norms, the launches, the times and the losses (the whole state too
    with ``keep_state``)."""
    from repro_torch import tree as T
    from repro_torch.core.sync import is_sync_step
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    hook, checked, mark = fault_round_check(torch, transport)
    norms = []

    def round_hook(state, payloads, shipped, sync):
        norms.append((state.sync_state.msg_norm.clone(),
                      state.sync_state.resid_norm.clone()))
        hook(state, payloads, shipped, sync)

    trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                      lambda g: transformer.init_params(g, cfg, device),
                      TrainerConfig(n_pods=PODS, optimizer="sgd", lr=0.02,
                                    sync=sync),
                      device=device, round_hook=round_hook,
                      transport=transport)
    state = trainer.init_state(SEED)
    if device == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    mark.update(ops.LAUNCHES)
    losses, held = [], 0
    for step in range(steps):
        state, metrics = trainer.train_step(state, batches(step))
        losses.append(metrics["loss_per_pod"].float().cpu().tolist())
        pre = None
        plan = getattr(transport, "plan", None)
        if (is_sync_step(sync, step) and plan is not None
                and any(ev.kind == "crash" for ev in plan.at(step))):
            pre = T.tree_map(lambda x: x.clone(), state.params)
        state = trainer.maybe_sync(state, step)
        transport.tick(0.5)
        if pre is not None:
            failed = tuple(transport.round_failed_pods)
            for p in range(PODS):
                if (p + PODS - sync.peer_shift) % PODS in failed \
                        or p in failed:
                    require(all(torch.equal(a[p], b[p]) for a, b in zip(
                        T.leaves(state.params), T.leaves(pre))),
                        f"step {step} pod {p}: no update applied from a "
                        f"dead sender")
                    held += 1
            del pre
    if device == "cuda":
        torch.cuda.synchronize()
    require(len(checked) == steps // sync.interval,
            f"{len(checked)} codec rounds checked")
    out = {"params": state.params, "ef": state.sync_state.ef_residual,
           "tier": state.sync_state.tier, "norms": norms,
           "launches": {k: ops.LAUNCHES[k]
                        for k in ("wan_encode", "wan_decode")},
           "sync_s": list(trainer.sync_seconds),
           "step_s": list(trainer.step_seconds), "losses": losses,
           "checked": checked, "held_pods": held,
           "wire_mb": trainer.wire_mb(state)}
    if keep_state:
        out["state"] = state
    del state, trainer
    return out


def state_gb(torch, state) -> float:
    """GB the checkpoint file holds for ``state``: every tensor leaf as
    stored (bf16 upcast to f32)."""
    from repro_torch import tree as T

    return sum(x.numel() * (4 if x.dtype == torch.bfloat16
                            else x.element_size())
               for x in T.leaves(state) if isinstance(x, torch.Tensor)) / 1e9


@contextlib.contextmanager
def timed_checkpoints(torch, log: list):
    """Time every ``checkpoint.save`` and ``restore`` call in the block
    (the launcher's included): ``(kind, directory name, GB of arrays.npz,
    s)``, the device synchronized before the clock stops."""
    from repro_torch.checkpoint import checkpoint as ckpt

    save, restore = ckpt.save, ckpt.restore

    def size_gb(directory):
        return os.path.getsize(os.path.join(directory, "arrays.npz")) / 1e9

    def timed_save(directory, *args, **kw):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(directory, *args, **kw)
        log.append(("save", os.path.basename(directory), size_gb(directory),
                    time.perf_counter() - t0))

    def timed_restore(directory, *args, **kw):
        t0 = time.perf_counter()
        out = restore(directory, *args, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        log.append(("restore", os.path.basename(directory),
                    size_gb(directory), time.perf_counter() - t0))
        return out

    ckpt.save, ckpt.restore = timed_save, timed_restore
    try:
        yield
    finally:
        ckpt.save, ckpt.restore = save, restore


def phase_faults(torch, device: str = "cuda", cfg=None,
                 seq: int = 512) -> dict:
    """Phase 3f: faults and crash recovery (``ChaosTransport``, the barrier
    checkpoint, the launcher's ``--faults`` / ``--ckpt-dir``) at granite-8b
    width, on phase 3e's setup.  Returns the codec launches of its runs."""
    import shutil
    import tempfile

    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import granite_8b
    from repro_torch.core import sync as S
    from repro_torch.core.autotune import AdaptiveSyncController, BucketStats
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.faults import ChaosTransport, FaultPlan, \
        resolve_round
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.core.transport import MeasuredWanProbe, SimTransport
    from repro_torch.core.wan import WANConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    cfg = cfg or granite_8b.CONFIG.replace(n_layers=2)
    sync = S.SyncConfig("asgd_ga", 2, compress_topk=TOPK, quantize_int8=True,
                        error_feedback=True, bucket_policy="layer-class")

    def peak_gb() -> float:
        return (torch.cuda.max_memory_allocated() / 1e9
                if device == "cuda" else float("nan"))

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0) for i in range(PODS))
    plan = build_training_plan(TrainingRequest(
        model=cfg.name, clouds=clouds, sync=sync, n_iters=FAULT_STEPS,
        global_batch=8))
    batches = train.make_batches(plan, cfg.vocab_size, seq, device)
    trace = train.parse_wan_trace(CONTROL_TRACE, FAULT_STEPS, 0.5)
    total = {"wan_encode": 0, "wan_decode": 0}

    def tally(launches):
        for k in total:
            total[k] += launches[k]

    def sim():
        return SimTransport(trace, WANConfig(fluctuation=0.25, seed=0),
                            probe=MeasuredWanProbe())

    def chaos(spec, tolerate=True):
        return ChaosTransport(sim(), train.parse_faults(spec) or FaultPlan(),
                              tolerate=tolerate)

    times, peaks = {}, {}

    def keep_times(case, run):
        times[case] = [round(t, 4) for t in run["sync_s"]]

    def keep_peak(case):
        """The device's peak since the last case, then a fresh count."""
        peaks[case] = round(peak_gb(), 2)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()

    ckpt_log, tmp = [], tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # the bare sim run every tolerant run must end equal to; its state
        # is (e)'s direct checkpoint
        bare_t = sim()
        bare = fault_run(torch, cfg, sync, batches, bare_t, device,
                         keep_state=True)
        tally(bare["launches"])
        keep_peak("bare sim")
        keep_times("bare sim", bare)
        state = bare.pop("state")
        gb = state_gb(torch, state)
        free = shutil.disk_usage(tmp).free / 1e9
        params_gb = state_gb(torch, state.params)
        # the launcher's barrier is rewritten beside its last copy, and a
        # pre-reconfig save of the params may stand beside both
        need = 2 * gb + params_gb
        print(f"[faults] checkpoint directory {tmp}: {free:.1f} GB free, "
              f"state {gb:.2f} GB (params {params_gb:.2f} GB as f32)")
        require(free >= need,
                f"the disk holds {free:.1f} GB; the barrier checkpoints need "
                f"{need:.1f} GB (twice the {gb:.2f} GB state and the "
                f"pre-reconfig params)")

        # (e) direct save and restore of the whole TrainState
        with timed_checkpoints(torch, ckpt_log):
            ckpt.save(os.path.join(tmp, "direct"), state, step=state.step,
                      metadata={"model": cfg.name, "pods": PODS})
            back, step = ckpt.restore(os.path.join(tmp, "direct"), state,
                                      device=device)
        require(step == state.step == back.step == FAULT_STEPS,
                f"restored step {step}")
        for a, b in zip(T.leaves(state), T.leaves(back), strict=True):
            require(type(a) is type(b) and (
                a == b if isinstance(a, int) else
                (a.dtype == b.dtype and a.device == b.device
                 and torch.equal(a, b))),
                "restored state == saved, bit for bit")
        del back, state
        keep_peak("(e) save and restore")
        shutil.rmtree(os.path.join(tmp, "direct"))
        if device == "cuda":
            torch.cuda.empty_cache()

        def same(run):
            bad = stream_diff(torch, bare, run, True)
            require(not bad, f"stream == the bare sim run's: {bad}")

        # (a) empty plan: the bare transport, bit for bit
        t_a = chaos("")
        run_a = fault_run(torch, cfg, sync, batches, t_a, device)
        tally(run_a["launches"])
        keep_peak("(a)")
        keep_times("(a)", run_a)
        same(run_a)
        require([r.seconds for r in t_a.records]
                == [r.seconds for r in bare_t.records]
                and t_a.probe.estimator.bandwidth_mbps
                == bare_t.probe.estimator.bandwidth_mbps
                and t_a.retries == 0 and t_a.outcomes == [] and t_a.in_graph,
                "empty plan: the same records, belief, no retries or outcomes")
        del run_a

        # (b) retries: two failed attempts at step 1, a hard timeout at 3
        t_b = chaos("fail:x2@1,timeout:x6@3")
        run_b = fault_run(torch, cfg, sync, batches, t_b, device)
        tally(run_b["launches"])
        keep_peak("(b)")
        keep_times("(b)", run_b)
        same(run_b)
        require(t_b.retries == 3, f"(b) {t_b.retries} retries")
        for o in t_b.outcomes:
            out = resolve_round(t_b.plan, t_b.retry_policy, o["step"],
                                o["expected_s"])
            require(out.extra_s == o["extra_s"]
                    and out.attempts == o["attempts"],
                    f"(b) outcome {o} == resolve_round {out}")
        wire = run_b["wire_mb"]
        del run_b

        # (c) corruption: caught and re-shipped, then decoded unverified
        t_c = chaos("corrupt@3")
        run_c = fault_run(torch, cfg, sync, batches, t_c, device)
        tally(run_c["launches"])
        keep_peak("(c)")
        keep_times("(c)", run_c)
        same(run_c)
        first = sorted(wire)[0]     # the host seam ships in name order
        require(t_c.retries == 1 and t_c.retried_mb == wire[first],
                f"(c) {t_c.retries} retries, {t_c.retried_mb} MB retried "
                f"== {first}'s {wire[first]} MB")
        del run_c
        t_n = chaos("corrupt@3", tolerate=False)
        run_n = fault_run(torch, cfg, sync, batches, t_n, device)
        tally(run_n["launches"])
        keep_peak("(c) no tolerance")
        keep_times("(c) no tolerance", run_n)
        lost = [i for i, r in enumerate(run_n["losses"])
                if not all(math.isfinite(v) for v in r)]
        receiver = (0 + sync.peer_shift) % PODS
        require(t_n.retries == 0 and lost and lost[0] == 4,
                f"(c) no tolerance: losses non-finite from step 4, got "
                f"{lost}")
        require(not all(bool(torch.isfinite(x[receiver]).all())
                        for x in T.leaves(run_n["params"])),
                f"(c) no tolerance: pod {receiver}'s params non-finite")
        del run_n

        # (d) a degraded crash: pod 1 dead from step 3, never removed
        t_d = chaos("crash:pod1@3")
        run_d = fault_run(torch, cfg, sync, batches, t_d, device)
        tally(run_d["launches"])
        keep_peak("(d)")
        keep_times("(d)", run_d)
        degraded = [c for c in run_d["checked"] if c["failed"]]
        require(t_d.degraded_rounds == 2 == len(degraded)
                and all(c["delivered"] == [0] * PODS for c in degraded)
                and run_d["held_pods"] == 2 * PODS,
                f"(d) {t_d.degraded_rounds} degraded rounds {degraded}, "
                f"{run_d['held_pods']} pod rounds held")
        msg, res = run_d["norms"][-1]
        stats = BucketStats.from_norms(msg.double().cpu().numpy(),
                                       res.double().cpu().numpy())
        # tests/test_faults.py's controller: it may refit the interval, but
        # the EF guard must not trip on a round that delivered nothing
        tuner = AdaptiveSyncController(sync, 44.6, 0.3, ef_guard=0.9)
        tuner.observe_wan(100.0)
        rung = tuner.rung
        upd = tuner.update(FAULT_STEPS, stats)
        require(stats.msg_norm == 0.0 and stats.resid_norm == 0.0
                and tuner.rung == rung
                and (upd is None or "ef-guard" not in upd.summary()),
                f"(d) the degraded round reads as no reading, no EF trip: "
                f"{stats}, {upd and upd.summary()}")
        del run_d
        if device == "cuda":
            torch.cuda.empty_cache()

        # (e) the launcher: a retry, then a rollback-mode crash restored
        #     from the barrier checkpoint, then pod 1 removed
        del bare
        if device == "cuda":
            torch.cuda.empty_cache()
        check_round, per_tier, checked, mark = bucketed_round_check(torch)
        argv = ["--pods", str(PODS), "--steps", str(FAULT_STEPS),
                "--batch", "8", "--seq", str(seq), "--interval", "2",
                "--compress-topk", str(TOPK), "--int8", "--error-feedback",
                "--bucket-policy", "layer-class", "--adaptive-sync",
                "--wan-trace", CONTROL_TRACE, "--ef-guard",
                str(CONTROL_EF_GUARD), "--transport", TRANSPORT_SIM,
                "--faults", FAULT_LAUNCH, "--ckpt-dir",
                os.path.join(tmp, "run"), "--log-every", "0", "--device",
                device]
        ops.reset_launches()
        mark.update(ops.LAUNCHES)
        buf = io.StringIO()
        with timed_checkpoints(torch, ckpt_log), \
                contextlib.redirect_stdout(buf):
            summary = train.main(argv, model_cfg=cfg, round_hook=check_round)
        tally(ops.LAUNCHES)
        keep_peak("(e) launcher")
        print("\n".join(line for line in buf.getvalue().splitlines()
                        if line.startswith(("[faults]", "[elasticity]",
                                            "[autotune] step"))))
        fields = {k: summary[k] for k in (
            "retries", "retried_mb", "degraded_rounds", "crash_recoveries",
            "rollbacks", "final_pods", "reconfigs")}
        require(fields["rollbacks"] == 1 and fields["crash_recoveries"] == 1
                and fields["retries"] == 1 and fields["final_pods"] == 1,
                f"(e) launcher {fields}")
        require(len(checked) == len(summary["rounds"]) - 1,
                f"{len(checked)} completed rounds checked of "
                f"{len(summary['rounds'])} (one rolled back)")
        # the crash plan makes the elasticity controller live, so the
        # trace's bandwidth events may re-plan too: one pre-reconfig save
        # per applied reconfig, the last one removing pod 1
        dirs = sorted(os.listdir(os.path.join(tmp, "run")))
        require(dirs == sorted(["fault_barrier"] + [
            f"pre_reconfig_{s}" for s, _, _ in summary["reconfigs_at"]])
                and summary["reconfigs_at"][-1][1] == 1,
                f"checkpoint directories {dirs}, reconfigs "
                f"{summary['reconfigs_at']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if device == "cuda":
        torch.cuda.empty_cache()

    print(f"[faults] {cfg.name} x{cfg.n_layers} layers, {PODS} pods, batch "
          f"8, seq {seq}, {FAULT_STEPS} steps a case: (a) empty plan, (b) "
          f"{t_b.retries} retries, (c) 1 re-ship of {first} "
          f"({t_c.retried_mb} MB) and the unverified decode, (d) "
          f"{t_d.degraded_rounds} degraded rounds, all held; streams of "
          f"(a)-(c) == the bare sim run's bit for bit")
    print(f"[faults] sync-round s by case (steps 1, 3, 5): {times}")
    print(f"[faults] peak memory GB by case: {peaks}")
    outcomes = [(o["step"], o["expected_s"], o["attempts"], o["extra_s"],
                 o["t_s"]) for o in t_b.outcomes]
    print(f"[faults] (b) outcomes (step, expected s, attempts, extra s, "
          f"billed s): {outcomes}")
    print(f"[faults] (e) launcher: {fields}; rounds (step, knobs, s) "
          f"{[[r[0], r[1], round(r[2], 4)] for r in summary['rounds']]}; "
          f"launches by tier {per_tier}")
    for kind, name, size, secs in ckpt_log:
        print(f"[faults] {kind} {name}: {size:.3f} GB in {secs:.2f} s "
              f"({size / secs:.2f} GB/s)")
    print(f"[faults] phase 3f: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {total}, peak memory {max(peaks.values()):.2f} GB")
    return total


def stream_run(torch, cfg, sync, batches, transport, device: str,
               steps: int, stream=None, n_pods: int = PODS, hook=None,
               every_step=None) -> dict:
    """Train ``steps`` steps over ``transport`` as the launcher's loop does
    (the clock ticks 0.5 s a step), every round held by
    ``bucketed_round_check`` (and ``hook``, called with the round's
    arguments first).  ``every_step(step)`` runs before each step.  Returns the
    final params, EF residual and tier, the per-round norms, the launches,
    the checked rounds, the trainer's times and retunes."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    check, per_tier, checked, mark = bucketed_round_check(torch)
    norms = []

    def round_hook(state, payloads, shipped, sync_, retune=None):
        norms.append((state.sync_state.msg_norm.clone(),
                      state.sync_state.resid_norm.clone()))
        if hook is not None:
            hook(state, payloads, shipped, sync_, retune=retune)
        check(state, payloads, shipped, sync_, retune=retune)

    trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                      lambda g: transformer.init_params(g, cfg, device),
                      TrainerConfig(n_pods=n_pods, optimizer="sgd", lr=0.02,
                                    sync=sync),
                      device=device, round_hook=round_hook,
                      transport=transport, stream=stream)
    state = trainer.init_state(SEED)
    if device == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    mark.update(ops.LAUNCHES)
    losses = []
    for step in range(steps):
        if every_step is not None:
            every_step(step)
        state, metrics = trainer.train_step(state, batches(step))
        losses.append(metrics["loss_per_pod"].float().cpu().tolist())
        state = trainer.maybe_sync(state, step)
        if hasattr(transport, "tick"):
            transport.tick(0.5)
    if device == "cuda":
        torch.cuda.synchronize()
    require(all(math.isfinite(v) for row in losses for v in row),
            f"finite losses {losses}")
    require(len(checked) == steps // sync.interval,
            f"{len(checked)} codec rounds checked")
    out = {"params": state.params, "ef": state.sync_state.ef_residual,
           "tier": state.sync_state.tier, "norms": norms,
           "launches": {k: ops.LAUNCHES[k]
                        for k in ("wan_encode", "wan_decode")},
           "checked": checked, "per_tier": per_tier,
           "sync_s": list(trainer.sync_seconds),
           "step_s": list(trainer.step_seconds),
           "stream_retunes": trainer.stream_retunes}
    del state, trainer
    return out


def phase_streaming(torch, device: str = "cuda", cfg=None,
                    seq: int = 512) -> dict:
    """Phase 3g: streaming rounds (``_StreamRound``, the transports' stream
    protocol, ``Trainer._stream_sync``), the mid-round tail re-encode
    (``reencode_unsent``, ``finish_codec_sync_split``), the
    ``HierarchicalTransport`` and the launcher's ``--stream-retune`` and
    ``--topology`` at granite-8b width, on phase 3e's setup.  Returns the
    codec launches of its runs."""
    from repro_torch import tree as T
    from repro_torch.configs import granite_8b
    from repro_torch.core import sync as S
    from repro_torch.core.autotune import StreamingShipController
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.core.topology import (HierarchicalTransport,
                                           TopologySpec, link_key)
    from repro_torch.core.transport import (MeasuredWanProbe, MeshTransport,
                                            SimTransport)
    from repro_torch.core.wan import BandwidthTrace, WANConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.wan_codec import k_per_block
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    cfg = cfg or granite_8b.CONFIG.replace(n_layers=2)
    sync = S.SyncConfig("asgd_ga", 2, compress_topk=STREAM_TOPK,
                        quantize_int8=True, error_feedback=True,
                        overlap_chunks=STREAM_CHUNKS,
                        bucket_policy="layer-class")
    total = {"wan_encode": 0, "wan_decode": 0}
    peaks: dict = {}
    launches: dict = {}

    def peak_gb() -> float:
        return (torch.cuda.max_memory_allocated() / 1e9
                if device == "cuda" else float("nan"))

    def keep(case, run_launches):
        """The case's launches and the device's peak since the last case."""
        launches[case] = {k: run_launches[k] for k in total}
        for k in total:
            total[k] += run_launches[k]
        peaks[case] = round(peak_gb(), 2)
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def plan_batches(n_pods, batch, steps):
        clouds = tuple(CloudResources(region=f"pod{i}",
                                      devices=(("v5e", 4),), data_size=1.0)
                       for i in range(n_pods))
        plan = build_training_plan(TrainingRequest(
            model=cfg.name, clouds=clouds, sync=sync, n_iters=steps,
            global_batch=batch))
        return train.make_batches(plan, cfg.vocab_size, seq, device)

    def records(t):
        return [(r.bucket, r.payload_mb, r.seconds, r.step)
                for r in t.records]

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    batches = plan_batches(PODS, 8, STREAM_STEPS)
    trace = train.parse_wan_trace(CONTROL_TRACE, STREAM_STEPS, 0.5)
    model_mb = cfg.param_count() * 2 / 1e6   # bf16 weights a pod
    n_rounds = STREAM_STEPS // sync.interval
    exact = True

    # (a) zero retunes: every run of every transport, classic and
    #     streaming, against the classic sim run (all ship the inline
    #     ring's bytes)
    def never():
        return StreamingShipController(sync, model_mb)

    made = {
        "sim": lambda: SimTransport(trace, WANConfig(fluctuation=0.25,
                                                     seed=0),
                                    probe=MeasuredWanProbe()),
        "mesh": lambda: MeshTransport(probe=MeasuredWanProbe()),
        "hier": lambda: HierarchicalTransport(
            TopologySpec.from_regions(["us", "eu"], kind="tree"), trace,
            wan=WANConfig(fluctuation=0.25, seed=0),
            probe=MeasuredWanProbe()),
    }
    base = None
    round_s, ts = {}, {}
    for kind in ("sim", "mesh", "hier"):
        for mode in ("classic", "stream"):
            tr = made[kind]()
            ctl = never() if mode == "stream" else None
            run = stream_run(torch, cfg, sync, batches, tr, device,
                             STREAM_STEPS, stream=ctl)
            keep(f"(a) {kind} {mode}", run["launches"])
            round_s[f"{kind} {mode}"] = [round(t, 4) for t in run["sync_s"]]
            if base is None:
                base = run
            else:
                bad = stream_diff(torch, base, run, True)
                if bad and exact:
                    # is the training step itself deterministic here?
                    again = stream_run(torch, cfg, sync, batches,
                                       made["sim"](), device, STREAM_STEPS)
                    twice = stream_diff(torch, base, again, True)
                    del again
                    require(bool(twice), f"(a) {kind} {mode} differs from "
                            f"the classic sim run ({bad}) though two "
                            f"classic runs agree")
                    print(f"[stream] two classic runs differ ({twice[:4]}"
                          f"...): (a) is held at atol {TRANSPORT_ATOL}, "
                          f"rtol {TRANSPORT_RTOL}")
                    exact = False
                if not exact:
                    bad = stream_diff(torch, base, run, False)
                require(not bad, f"(a) {kind} {mode} == the classic sim "
                        f"run: {bad}")
                require(run["launches"] == base["launches"],
                        f"(a) {kind} {mode} launches {run['launches']} == "
                        f"{base['launches']}")
            if mode == "stream":
                require(len(tr.stream_rounds) == n_rounds
                        and not any(r["retuned"] for r in tr.stream_rounds)
                        and tr.probe.n_chunk_observations
                        == len(ctl.decisions) > 0,
                        f"(a) {kind}: {len(tr.stream_rounds)} streamed "
                        f"rounds, {tr.probe.n_chunk_observations} chunk "
                        f"observations")
            ts[(kind, mode)] = tr
            del run
        c, st = ts[(kind, "classic")], ts[(kind, "stream")]
        if kind == "mesh":
            # a streamed bucket's MB is its chunks' sum: equal up to float
            # association
            rc, rs = ([(b, round(mb, 9), s) for b, mb, _, s in records(t)]
                      for t in (c, st))
            require(rc == rs and c.probe.n_observations
                    == st.probe.n_observations == n_rounds,
                    f"(a) mesh: records by bucket, MB and step {rc} == {rs}, "
                    f"probe observations {c.probe.n_observations} == "
                    f"{st.probe.n_observations} == {n_rounds}")
        else:
            require(records(c) == records(st)
                    and c.probe.estimator.bandwidth_mbps
                    == st.probe.estimator.bandwidth_mbps
                    and c.on_sync({"all": 1.0}) == st.on_sync({"all": 1.0}),
                    f"(a) {kind}: billed records, probe belief and the next "
                    f"draw equal")
        if kind == "hier":
            require(c.beliefs.snapshot() == st.beliefs.snapshot()
                    and c.schedule == st.schedule,
                    "(a) hier: link beliefs and schedule equal")
    ref_launches = dict(base["launches"])
    del base, ts
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"[stream] (a) {cfg.name} x{cfg.n_layers} layers, {PODS} pods, "
          f"batch 8, seq {seq}, {sync.value_dtype} top-k {STREAM_TOPK}, "
          f"{STREAM_CHUNKS} chunks a bucket: zero-retune streaming == "
          f"classic on sim, mesh (one card) and hierarchical (2 regions), "
          f"{'bit for bit' if exact else 'within tolerance'}; records, "
          f"probe belief and rng stream equal; launches {ref_launches} a "
          f"run")
    print(f"[stream] (a) sync-round s (steps 1, 3, 5) classic vs "
          f"streaming: {round_s}")

    # (b) one retune: a clean sim link collapsing 8x at round 2
    tb = SimTransport(BandwidthTrace(*STREAM_TRACE),
                      WANConfig(latency_s=0.0, fluctuation=0.0),
                      probe=MeasuredWanProbe())
    ctl_b = StreamingShipController(sync, model_mb, cliff_ratio=STREAM_CLIFF,
                                    ef_guard=STREAM_EF_GUARD,
                                    probe_est=tb.probe.estimator)
    held: dict = {}

    def hold_retune(state, payloads, shipped, sync_, retune=None):
        """The retuned round, held outside its timing: EF residual == flat
        - spliced local, recomputed through reencode_unsent; the tails
        recomputed == the shipped ones; each tail's encode and decode ==
        the plain versions on the same strided views; a shrunk block at an
        unaligned base likewise; the tail re-encode timed."""
        if retune is None:
            return
        counts = dict(ops.LAUNCHES)
        layout = S.bucket_layout(sync_, state.sync_state.ga_buffer)
        flat, ef = payloads.flat, state.sync_state.ef_residual
        tails, tail_local = S.reencode_unsent(sync_, retune.cfg_to, flat,
                                              layout, retune.sent)
        require(sorted(tails) == sorted(retune.tails),
                f"(b) tails {sorted(tails)}")
        cuts = {}
        for g, name in enumerate(layout.names):
            off, size = layout.offsets[g], layout.sizes[g]
            if not size:
                continue
            widths = S._chunk_widths(sync_.for_bucket(name), size)
            sw = int(sum(widths[:retune.sent.get(name, len(widths))]))
            lo = off + sw
            require(torch.equal(ef[:, off:lo],
                                flat[:, off:lo] - payloads.local[:, off:lo]),
                    f"(b) {name}: prefix EF == flat - local")
            if name not in tails:
                continue
            cuts[name] = (lo, off + size)
            require(torch.equal(ef[:, lo:off + size],
                                flat[:, lo:off + size] - tail_local[name]),
                    f"(b) {name}: tail EF == flat - the re-encoded tail's "
                    f"local")
            require(all(same(a, b) for a, b in
                        zip(tails[name], retune.tails[name], strict=True)),
                    f"(b) {name}: re-encoded tail == the shipped one")
        del tail_local
        tcfg = retune.cfg_to
        views = [(name, flat[:, lo:hi]) for name, (lo, hi) in cuts.items()]
        # a tail narrower than the codec block at an odd (unaligned) base
        lo = cuts[max(cuts, key=lambda n: cuts[n][1] - cuts[n][0])][0] + 1
        views.append(("shrunk, unaligned", flat[:, lo:lo + 3001]))
        held["views"] = []
        for what, view in views:
            n = view.shape[1]
            block = min(tcfg.codec_block, n)
            kb = k_per_block(block, tcfg.compress_topk)
            kern = ops.wan_encode(view, kb, block=block,
                                  value_dtype=tcfg.value_dtype)
            plain = ops.wan_encode(view, kb, block=block,
                                   value_dtype=tcfg.value_dtype,
                                   use_kernel=False)
            require(same(kern, plain), f"(b) {what}: encode kernel == plain "
                    f"on the view")
            dk = ops.wan_decode(*kern, n, block=block,
                                value_dtype=tcfg.value_dtype)
            dp = ops.wan_decode(*plain, n, block=block,
                                value_dtype=tcfg.value_dtype,
                                use_kernel=False)
            require(torch.equal(dk, dp), f"(b) {what}: decode kernel == "
                    f"plain")
            held["views"].append((what, n, block,
                                  (view.data_ptr() % 16) == 0))
            del kern, plain, dk, dp
        if device == "cuda":
            held["reencode_ms"] = time_ms(
                torch, lambda: S.reencode_unsent(sync_, tcfg, flat, layout,
                                                 retune.sent), reps=3, warm=1)
        held["sent"] = dict(retune.sent)
        held["tail_chunks"] = sum(len(c) for c in retune.tails.values())
        held["cfg_to"] = (tcfg.compress_topk, tcfg.value_dtype)
        ops.LAUNCHES.update(counts)

    run_b = stream_run(torch, cfg, sync, batches, tb, device, STREAM_STEPS,
                       stream=ctl_b, hook=hold_retune)
    keep("(b) one retune", run_b["launches"])
    retunes = [d for d in ctl_b.decisions if d["action"] == "retune"]
    rd = [r for r in tb.stream_rounds if r["retuned"]]
    cheap = ctl_b.ladder[retunes[0]["rung"]] if retunes else None
    require(run_b["stream_retunes"] == 1 == ctl_b.n_retunes == len(rd)
            and rd[0]["step"] == 3 and "views" in held,
            f"(b) one retune, at round 2 (step 3): {run_b['stream_retunes']} "
            f"retunes, rounds {[r['step'] for r in rd]}")
    require(retunes[0]["rung"] > 0 and held["cfg_to"]
            == (cheap.compress_topk, cheap.value_dtype)
            and tb.probe.estimator.bandwidth_mbps == STREAM_TRACE[1][1],
            f"(b) the tail at the cliff law's rung {retunes[0]['rung']} "
            f"({held['cfg_to']}), belief snapped to "
            f"{tb.probe.estimator.bandwidth_mbps}")
    print(f"[stream] (b) clean sim link {STREAM_TRACE[1][0]:.0f} -> "
          f"{STREAM_TRACE[1][1]:.0f} Mbps at round 2: one retune after "
          f"chunk {retunes[0]['chunk']} ({retunes[0]['bucket']}, achieved "
          f"{retunes[0]['achieved']:.1f} vs believed "
          f"{retunes[0]['believed']:.1f} Mbps) to rung {retunes[0]['rung']}"
          f" {held['cfg_to'][1]}@{held['cfg_to'][0]}; chunks sent before "
          f"it {held['sent']}, {held['tail_chunks']} tail chunks "
          f"re-encoded; EF == "
          f"flat - spliced local bit for bit; tail views (what, width, "
          f"block, 16-byte aligned) {held['views']} held to the plain "
          f"encode and decode")
    print(f"[stream] (b) sync-round s {[round(t, 4) for t in run_b['sync_s']]}"
          f" (the retuning round: step 3); tail re-encode "
          f"{held.get('reencode_ms', float('nan')):.3f} ms; round (tail MB, "
          f"t_tail s, shipped MB, t s) "
          f"{[(r['tail_mb'], r['t_tail'], r['shipped_mb'], r['t_s']) for r in rd]}"
          f"; launches {run_b['launches']} (by tier {run_b['per_tier']})")
    del run_b, tb, ctl_b
    if device == "cuda":
        torch.cuda.empty_cache()

    # (c) topology: four regions at one layer, the hierarchical run
    #     against the inline ring; a collapse on eu<->us reroutes from the
    #     next round; set_kind tree -> ring -> tree
    cfg1 = cfg.replace(n_layers=1)
    n4 = len(STREAM_TOPO_REGIONS)
    batches4 = plan_batches(n4, 8, STREAM_STEPS)
    root, bad_link = STREAM_TOPO_REGIONS[0], link_key(*STREAM_TOPO_LINK)
    fast = {link_key(root, r): BandwidthTrace((0.0,), (STREAM_TOPO_FAST,))
            for r in STREAM_TOPO_REGIONS[1:]}
    fast[bad_link] = BandwidthTrace(*STREAM_TOPO_COLLAPSE)
    hier = HierarchicalTransport(
        TopologySpec.from_regions(list(STREAM_TOPO_REGIONS), kind="tree"),
        BandwidthTrace((0.0,), (STREAM_TOPO_SLOW,)),
        wan=WANConfig(latency_s=0.0, fluctuation=0.0), link_traces=fast,
        probe=MeasuredWanProbe())
    crossed = []

    def switch(step):
        if step == 4:
            hier.set_kind("ring", step=step)
        elif step == 5:
            hier.set_kind("tree", step=step)
        if step % sync.interval == sync.interval - 1:
            crossed.append((step, bad_link in {
                h for leg in hier.schedule.wan_legs for h in leg.hops}))

    run_c = stream_run(torch, cfg1, sync, batches4, hier, device,
                       STREAM_STEPS, n_pods=n4, every_step=switch)
    keep("(c) hierarchical", run_c["launches"])
    # four pods' state does not fit twice: the hierarchical run's final
    # state waits on the host while the inline run trains
    held_c = {"params": T.tree_map(lambda x: x.cpu(), run_c["params"]),
              "ef": run_c["ef"].cpu(), "tier": run_c["tier"].cpu(),
              "norms": [(m.cpu(), r.cpu()) for m, r in run_c["norms"]],
              "launches": run_c["launches"], "sync_s": run_c["sync_s"]}
    del run_c
    if device == "cuda":
        torch.cuda.empty_cache()
    inline = stream_run(torch, cfg1, sync, batches4, None, device,
                        STREAM_STEPS, n_pods=n4)
    keep("(c) inline", inline["launches"])
    bad = stream_diff(torch, held_c, {
        "params": T.tree_map(lambda x: x.cpu(), inline["params"]),
        "ef": inline["ef"].cpu(), "tier": inline["tier"].cpu(),
        "norms": [(m.cpu(), r.cpu()) for m, r in inline["norms"]]}, exact)
    require(not bad and held_c["launches"] == inline["launches"],
            f"(c) hierarchical == the inline ring: {bad}")
    require([s for s, _ in hier.reroutes] == [3, 5]
            and [c for _, c in crossed] == [True, True, False],
            f"(c) the collapse billed at round 2 (step 3) reroutes round 3:"
            f" reroutes {hier.reroutes}, {bad_link} crossed by the rounds "
            f"at steps 1, 3, 5: {crossed}")
    require(hier.switches == [(4, "tree", "ring"), (5, "ring", "tree")],
            f"(c) switches {hier.switches}")
    print(f"[stream] (c) {cfg1.name} x1 layer, {n4} pods in regions "
          f"{list(STREAM_TOPO_REGIONS)} (tree rooted at {root}): the "
          f"hierarchical run == the inline ring "
          f"{'bit for bit' if exact else 'within tolerance'}; {bad_link} "
          f"{STREAM_TOPO_COLLAPSE[1][0]:.0f} -> "
          f"{STREAM_TOPO_COLLAPSE[1][1]:.0f} Mbps at "
          f"{STREAM_TOPO_COLLAPSE[0][1]} s, crossed by the rounds at steps "
          f"1, 3, 5: {[c for _, c in crossed]}; reroutes {hier.reroutes}; "
          f"switches {hier.switches}; {hier.wan_transfers_per_round} WAN "
          f"transfers a round")
    print(f"[stream] (c) sync-round s hierarchical "
          f"{[round(t, 4) for t in held_c['sync_s']]}, "
          f"inline {[round(t, 4) for t in inline['sync_s']]}; billed "
          f"(bucket, MB, s, step) "
          f"{[(b, round(mb, 3), sec, st) for b, mb, sec, st in records(hier)]}")
    del inline, held_c, hier
    if device == "cuda":
        torch.cuda.empty_cache()

    # (d) the launcher: 3e's argv with --stream-retune, then with
    #     --topology auto (the hierarchical transport) in place of sim
    argv = ["--pods", str(PODS), "--steps", str(STREAM_LAUNCH_STEPS),
            "--batch", "8", "--seq", str(seq), "--interval", "2",
            "--compress-topk", str(STREAM_TOPK), "--int8",
            "--error-feedback", "--overlap-chunks", str(STREAM_CHUNKS),
            "--bucket-policy", "layer-class", "--adaptive-sync",
            "--wan-trace", CONTROL_TRACE, "--ef-guard",
            str(CONTROL_EF_GUARD), "--stream-retune", "--log-every", "0",
            "--device", device]
    launcher = {}
    for case, extra in (("sim", ["--transport", TRANSPORT_SIM]),
                        ("topology", ["--topology", "auto"])):
        check, per_tier, checked, mark = bucketed_round_check(torch)
        ops.reset_launches()
        mark.update(ops.LAUNCHES)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = train.main(argv + extra, model_cfg=cfg,
                                 round_hook=check)
        keep(f"(d) {case}", ops.LAUNCHES)
        total_tier = {k: sum(t[k] for t in per_tier.values())
                      for k in ("wan_encode", "wan_decode")}
        require(launches[f"(d) {case}"] == total_tier,
                f"(d) {case}: launches {launches[f'(d) {case}']} == "
                f"per-tier sums {total_tier}")
        lines = [line for line in buf.getvalue().splitlines()
                 if line.startswith(("[stream]", "[topology]",
                                     "[transport]"))]
        print("\n".join(lines))
        rounds = summary["rounds"]
        require(len(checked) == len(rounds) > 0,
                f"(d) {case}: {len(checked)} of {len(rounds)} rounds checked")
        require(summary["stream_retunes"] >= 1
                and summary["stream_rounds"] == len(rounds)
                and any(line.startswith("[stream]") for line in lines),
                f"(d) {case}: a [stream] line and a streaming retune: "
                f"{summary['stream_retunes']} retunes, "
                f"{summary['stream_rounds']} streamed rounds")
        if case == "topology":
            require(any(line.startswith("[topology]") for line in lines)
                    and summary["final_topology"] in ("ring", "tree")
                    and summary["wan_transfers_per_round"] == PODS,
                    f"(d) topology: {summary['final_topology']}, "
                    f"{summary['wan_transfers_per_round']} transfers")
        launcher[case] = {k: summary[k] for k in (
            "stream_retunes", "stream_rounds", "stream_decisions", "retunes",
            "final_topology", "topology_switches", "topology_reroutes",
            "wan_transfers_per_round", "transfers",
            "measured_bandwidth_mbps")}
        print(f"[stream] (d) launcher {case}: {launcher[case]}; rounds "
              f"(step, knobs, s) "
              f"{[[r[0], r[1], round(r[2], 4)] for r in rounds]}; launches "
              f"by tier {per_tier}")
    print(f"[stream] launches by case {launches}")
    print(f"[stream] peak memory GB by case {peaks}")
    print(f"[stream] phase 3g: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {total}, peak memory {max(peaks.values()):.2f} GB")
    return total


def mem_available_gb() -> float:
    """The host's ``MemAvailable`` (``/proc/meminfo``), in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("/proc/meminfo has no MemAvailable")


@contextlib.contextmanager
def timed_engine(torch, log: list):
    """Time the snapshot engine and the migrator in the block (the
    launcher's included): each ``snapshot()``'s host seconds (a
    backpressure stall included) with the pool's pinned GB after it, each
    commit's seconds on the worker, each ``restore_last`` (its drain
    included) and each join of a staged migration at the barrier, as
    ``(kind, step or None, seconds, pinned GB or None)``; after each join,
    the migrator's errors and supersedes as ``("migrator", errors,
    restaged)`` (not the migrator, which holds the staged state)."""
    from repro_torch.checkpoint.async_engine import AsyncCheckpointEngine
    from repro_torch.training.trainer import LiveMigrator

    snap, commit = (AsyncCheckpointEngine.snapshot,
                    AsyncCheckpointEngine._commit_snapshot)
    restore_last, join = (AsyncCheckpointEngine.restore_last,
                          LiveMigrator._join_pending)

    def pinned(eng):
        return sum(b.nbytes for b in eng._host_bufs
                   if b.registered) / 1e9

    def timed_snapshot(self, tree, step, *args, **kw):
        t0 = time.perf_counter()
        snap(self, tree, step, *args, **kw)
        log.append(("snapshot", step, time.perf_counter() - t0,
                    pinned(self)))

    def timed_commit(self, keys, host, step, *args, **kw):
        t0 = time.perf_counter()
        commit(self, keys, host, step, *args, **kw)
        log.append(("commit", step, time.perf_counter() - t0, None))

    def timed_restore_last(self, *args, **kw):
        t0 = time.perf_counter()
        out = restore_last(self, *args, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        log.append(("restore_last", out[1], time.perf_counter() - t0, None))
        return out

    def timed_join(self, *args, **kw):
        t0 = time.perf_counter()
        out = join(self, *args, **kw)
        log.append(("stage join", None, time.perf_counter() - t0, None))
        log.append(("migrator", [repr(e) for e in self.errors],
                    self.restaged))
        return out

    AsyncCheckpointEngine.snapshot = timed_snapshot
    AsyncCheckpointEngine._commit_snapshot = timed_commit
    AsyncCheckpointEngine.restore_last = timed_restore_last
    LiveMigrator._join_pending = timed_join
    try:
        yield
    finally:
        AsyncCheckpointEngine.snapshot = snap
        AsyncCheckpointEngine._commit_snapshot = commit
        AsyncCheckpointEngine.restore_last = restore_last
        LiveMigrator._join_pending = join


@contextlib.contextmanager
def recorded_losses(out: list):
    """Every ``Trainer.train_step``'s mean loss in the block, in order."""
    from repro_torch.training.trainer import Trainer

    step = Trainer.train_step

    def recorded(self, *args, **kw):
        state, metrics = step(self, *args, **kw)
        out.append(float(metrics["loss"]))
        return state, metrics

    Trainer.train_step = recorded
    try:
        yield
    finally:
        Trainer.train_step = step


def phase_snapshots(torch, device: str = "cuda", cfg=None,
                    seq: int = 512) -> dict:
    """Phase 3h: the async snapshot engine, live pod migration and the
    launcher's ``--serve`` at granite-8b width, on phase 3f's setup.
    Returns the codec launches of its runs."""
    import shutil
    import tempfile

    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint.async_engine import (AsyncCheckpointEngine,
                                                     blocking_equivalent)
    from repro_torch.configs import granite_8b
    from repro_torch.core import sync as S
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig, _wait

    t_phase = time.perf_counter()
    cfg = cfg or granite_8b.CONFIG.replace(n_layers=2)
    sync = S.SyncConfig("asgd_ga", 2, compress_topk=TOPK, quantize_int8=True,
                        error_feedback=True, bucket_policy="layer-class")
    total = {"wan_encode": 0, "wan_decode": 0}

    def peak_gb() -> float:
        return (torch.cuda.max_memory_allocated() / 1e9
                if device == "cuda" else float("nan"))

    def reset_peak():
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0) for i in range(PODS))
    plan = build_training_plan(TrainingRequest(
        model=cfg.name, clouds=clouds, sync=sync, n_iters=4,
        global_batch=8))
    batches = train.make_batches(plan, cfg.vocab_size, seq, device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    # the launcher runs get no --ckpt-dir (its pre-reconfig saves would
    # add ~27 GB of writes): their snapshot and barrier directories are
    # temporary directories, made here and removed with the rest
    tempdir, tempfile.tempdir = tempfile.tempdir, tmp
    log, out = [], {}
    try:
        # ------------------------------------------------------------ (a)
        reset_peak()
        trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                          lambda g: transformer.init_params(g, cfg, device),
                          TrainerConfig(n_pods=PODS, optimizer="sgd",
                                        lr=0.02, sync=sync), device=device)
        state = trainer.init_state(SEED)
        ops.reset_launches()
        for step in range(2):                   # one codec round
            state, _ = trainer.train_step(state, batches(step))
            state = trainer.maybe_sync(state, step)
        for k in total:
            total[k] += ops.LAUNCHES[k]
        gb = state_gb(torch, state)
        params_mb = sum(x.numel() * x.element_size()
                        for x in T.leaves(state.params)) / PODS / 1e6
        free = shutil.disk_usage(tmp).free / 1e9
        avail = mem_available_gb()
        # disk: (a) a blocking save beside a snapshot, (b) two 2-pod
        # snapshots, then a 1-pod one; host memory: (b)'s two pinned sets
        # beside the staged restore (the f32 file, then the 1-pod state)
        need_disk, need_mem = 2 * gb + 1, 3 * gb
        print(f"[snap] {tmp}: {free:.1f} GB free disk, {avail:.1f} GB "
              f"MemAvailable, state {gb:.2f} GB, params {params_mb:.1f} MB "
              f"a pod")
        require(free >= need_disk and avail >= need_mem,
                f"the snapshot cases need {need_disk:.1f} GB of disk and "
                f"{need_mem:.1f} GB of host memory")

        def steps_s(n, sync_first=True):
            """Seconds of each of ``n`` steps, the device synchronized at
            each end (and before the first with ``sync_first``)."""
            nonlocal state
            if sync_first:
                _wait(torch.device(device))
            out, t0 = [], time.perf_counter()
            for _ in range(n):
                state, _ = trainer.train_step(state, batches(3))
                _wait(torch.device(device))
                out.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
            return out

        quiet = steps_s(SNAP_TIMED_STEPS)
        _wait(torch.device(device))
        t0 = time.perf_counter()
        bdir = blocking_equivalent(state, 1, os.path.join(tmp, "a_block"),
                                   metadata={"model": cfg.name})
        block_s = time.perf_counter() - t0
        eng = AsyncCheckpointEngine(os.path.join(tmp, "a_snap"), keep=1)
        snaps = []
        with timed_engine(torch, log):
            for s in (1, 2):
                # the first snapshot pins its buffer set, the second reuses
                # it; the step after each writes the params in place,
                # behind the copies
                _wait(torch.device(device))
                t0 = time.perf_counter()
                eng.snapshot(state, s, metadata={"model": cfg.name})
                t1 = time.perf_counter()
                after = steps_s(1, sync_first=False)[0]
                busy = steps_s(SNAP_TIMED_STEPS)
                eng.wait()
                snaps.append({"snapshot() s": round(t1 - t0, 4),
                              "next step s": round(after, 4),
                              "steps while committing s":
                                  [round(t, 4) for t in busy],
                              "snapshot to durable s":
                                  round(time.perf_counter() - t0, 2)})
                if s == 1:
                    ma = ckpt.load_manifest(eng.last_durable()[1])
                    mb = ckpt.load_manifest(bdir)
                    require(all(ma[k] == mb[k] for k in (
                        "keys", "dtypes", "shapes", "step", "metadata",
                        "arrays_bytes", "arrays_crc32")),
                        f"(a) snapshot manifest == the blocking save's: "
                        f"{ma['arrays_bytes']} / {ma['arrays_crc32']} vs "
                        f"{mb['arrays_bytes']} / {mb['arrays_crc32']}")
                    shutil.rmtree(os.path.join(tmp, "a_block"))
        pinned = sum(b.nbytes for b in eng._host_bufs) / 1e9
        require(len(eng._host_bufs) == 1,
                f"(a) {len(eng._host_bufs)} buffer sets for two snapshots")
        eng.close()
        for snap, c in zip(snaps, [e for e in log if e[0] == "commit"]):
            snap["commit s"] = round(c[2], 2)
        out["a"] = {"blocking save s": round(block_s, 2),
                    "steps with no snapshot s": [round(t, 4) for t in quiet],
                    "first snapshot": snaps[0], "second snapshot": snaps[1],
                    "pinned GB": round(pinned, 3),
                    "arrays_bytes": ma["arrays_bytes"],
                    "arrays_crc32": ma["arrays_crc32"],
                    "peak GB": round(peak_gb(), 2)}
        del state, trainer
        shutil.rmtree(os.path.join(tmp, "a_snap"))
        log.clear()

        # ----------------------------------------------------- (b) and (d)
        check_round, per_tier, checked, mark = bucketed_round_check(torch)
        base = ["--pods", str(PODS), "--batch", "8", "--seq", str(seq),
                "--interval", "2", "--compress-topk", str(TOPK), "--int8",
                "--error-feedback", "--bucket-policy", "layer-class",
                "--log-every", "0", "--device", device]

        def launch(argv):
            reset_peak()
            ops.reset_launches()
            mark.update(ops.LAUNCHES)
            losses, buf = [], io.StringIO()
            t0 = time.perf_counter()
            with recorded_losses(losses), timed_engine(torch, log), \
                    contextlib.redirect_stdout(buf):
                summary = train.main(argv, model_cfg=cfg,
                                     round_hook=check_round)
            for k in total:
                total[k] += ops.LAUNCHES[k]
            lines = [line for line in buf.getvalue().splitlines()
                     if line.startswith(("[elasticity]", "[faults]",
                                         "[ckpt] async engine", "[serve]"))]
            return {"summary": summary, "losses": losses, "lines": lines,
                    "peak GB": round(peak_gb(), 2),
                    "wall s": round(time.perf_counter() - t0, 1),
                    "launches": {k: ops.LAUNCHES[k] for k in total}}

        argv_b = base + ["--steps", str(SNAP_MIGRATE_STEPS), "--events",
                         SNAP_EVENT]
        live = launch(argv_b + ["--async-checkpoint", "--serve"])
        live_log, log[:] = list(log), []
        pause = launch(argv_b)
        ls, ps = live["summary"], pause["summary"]
        migrators = [e[1:] for e in live_log if e[0] == "migrator"]
        require(live["losses"] == pause["losses"]
                and len(live["losses"]) == SNAP_MIGRATE_STEPS,
                f"(b) losses bit-equal step for step: {live['losses']} vs "
                f"{pause['losses']}")
        require(ls["migrations"] == 1 == ls["reconfigs"] == ps["reconfigs"]
                and ls["final_pods"] == 1 == ps["final_pods"]
                and migrators == [([], 0)]
                and ls["staged_mb"] == round(params_mb, 3)
                and ls["snapshots"] == 3 and ls["last_durable_step"] == 2,
                f"(b) migrations {ls['migrations']}, staged "
                f"{ls['staged_mb']} MB (want {params_mb:.3f}), snapshots "
                f"{ls['snapshots']}, last durable {ls['last_durable_step']},"
                f" migrator (errors, restaged) {migrators}")
        # (d) --serve on pod 0's final params after the live run
        require(ls["serve"] is not None and ls["serve"]["requests"] == 6
                and ls["serve"]["new_tokens"] == 48,
                f"(d) serve {ls['serve']}")
        out["b"] = {
            "live": {"reconfig barrier s": ls["reconfigs_at"][0][2],
                     "peak GB": live["peak GB"], "wall s": live["wall s"]},
            "pause": {"reconfig barrier s": ps["reconfigs_at"][0][2],
                      "peak GB": pause["peak GB"],
                      "wall s": pause["wall s"]},
            "launches": live["launches"]}
        out["d"] = ls["serve"]

        # ------------------------------------------------------------ (c)
        argv_c = base + ["--steps", str(SNAP_CRASH_STEPS), "--wan-trace",
                         CONTROL_TRACE, "--transport", TRANSPORT_SIM,
                         "--faults", SNAP_CRASH]
        c_live = launch(argv_c + ["--async-checkpoint"])
        c_log, log[:] = list(log), []
        c_block = launch(argv_c)
        cs, cb = c_live["summary"], c_block["summary"]
        keys = ("rollbacks", "crash_recoveries", "degraded_rounds",
                "reconfigs", "final_pods", "retries")
        require(c_live["losses"] == c_block["losses"]
                and all(cs[k] == cb[k] for k in keys)
                and cs["rollbacks"] == 1 and cs["final_pods"] == 1,
                f"(c) async == blocking: {c_live['losses']} vs "
                f"{c_block['losses']}, "
                f"{[(k, cs[k], cb[k]) for k in keys]}")
        restore_s = [e[2] for e in c_log if e[0] == "restore_last"]
        require(len(restore_s) == 1, f"(c) {len(restore_s)} restore_last")
        out["c"] = {"restore_last s (drain included)": round(restore_s[0], 2),
                    "live peak GB": c_live["peak GB"],
                    "blocking peak GB": c_block["peak GB"],
                    "live wall s": c_live["wall s"],
                    "blocking wall s": c_block["wall s"]}
        require(os.listdir(tmp) == [],
                f"the launchers left {os.listdir(tmp)} behind")
    finally:
        tempfile.tempdir = tempdir
        shutil.rmtree(tmp, ignore_errors=True)
    if device == "cuda":
        torch.cuda.empty_cache()

    print(f"[snap] (a) {cfg.name} x{cfg.n_layers} layers, {PODS} pods: "
          f"{out['a']}")
    for name, lg in (("(b) live", live_log), ("(c) live", c_log)):
        print(f"[snap] {name} engine (kind, step, s, pinned GB): "
              f"{[(e[0], e[1], round(e[2], 4), e[3] and round(e[3], 2)) for e in lg if e[0] != 'migrator']}")
    print(f"[snap] (b) live migration == pause and restore, losses bit-equal "
          f"{live['losses']}; {out['b']}; (d) serve {out['d']}")
    print(f"[snap] (b) lines: {live['lines']}")
    print(f"[snap] (c) rollback with snapshots in flight == blocking "
          f"barrier path, losses {c_live['losses']}; {out['c']}")
    print(f"[snap] phase 3h: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {total}")
    return total


def phase_entry_point(torch) -> None:
    from repro_torch.launch import train

    summary = train.main(["--preset", "tiny", "--steps", "8", "--interval",
                          "4", "--compress-topk", "0.02", "--int8",
                          "--error-feedback", "--log-every", "4"])
    require(summary["device"] == "cuda", "launcher ran on the card")
    require(math.isfinite(summary["loss_last"]), "finite loss")


def topk_equal(torch, got, want, chunk: int, what: str) -> None:
    """Hold a top-k launch bit-equal to its plain version: vals (as bits,
    so -0.0 != +0.0), idx and the decompressed dense rows."""
    from repro_torch.kernels import ops

    (vk, ik), (vp, ip) = got, want
    bits = torch.int16 if vk.dtype == torch.bfloat16 else torch.int32
    require(vk.dtype == vp.dtype and vk.shape == vp.shape
            and torch.equal(ik, ip) and torch.equal(vk.view(bits),
                                                    vp.view(bits)),
            f"top-k {what}: vals and idx bit-equal to plain")
    dk = ops.topk_decompress(vk, ik, chunk)
    dp = ops.topk_decompress(vp, ip, chunk)
    require(torch.equal(dk.view(bits), dp.view(bits)),
            f"top-k {what}: decompressed dense bit-equal to plain")


def topk_bound(x_bytes: int, n_values: int, out_values: int,
               itemsize: int) -> tuple:
    """The least time of the top-k over inputs of ``x_bytes`` (read once)
    holding ``n_values`` values, writing ``out_values`` vals and int32 idx:
    the bytes over the memory rate, or one |x| compare per value at the f32
    rate, whichever is larger."""
    b_ms = (x_bytes + out_values * (itemsize + 4)) / HBM_BYTES_PER_S * 1e3
    f_ms = n_values / F32_FLOP_PER_S * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


def granite_leaf_sizes(torch) -> list:
    """Per-pod values of each leaf of granite-8b at 2 layers."""
    from repro_torch import tree as T
    from repro_torch.configs import granite_8b
    from repro_torch.models import transformer

    cfg = granite_8b.CONFIG.replace(n_layers=2)
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    sizes = [x.numel() for x in T.leaves(params)]
    require(sum(sizes) == N_MAIN and len(sizes) == 12,
            f"granite leaves {sizes}")
    return sizes


def topk_adversarial(case: str, x):
    """``x`` ``(rows, n)`` (n a multiple of 1024 for ``tie_at_threshold``)
    made into an input that splits the top-k kernel's branches, in place:
    with large values every 16 positions two lanes of each 1024-value tile
    hold 64 of them, more than 32 keys above the lane-maxima bound, so
    every tile takes the general branch; every 32, one lane holds 32 (the
    general branch too); every 128, one lane holds 8 (the fast path)."""
    if case.startswith("stride"):
        x[:, ::int(case[6:])] *= 50
    elif case == "all_equal":
        x.fill_(0.75)
    elif case == "tie_at_threshold":
        # per tile five 3.0s and ten -2.0s in different lanes and register
        # slots: at k_block 10 the 10th key ties at 2.0, split across lanes
        x.clamp_(-0.9, 0.9)
        tiles = x.view(x.shape[0], -1, 1024)
        tiles[..., [33, 250, 511, 700, 1000]] = 3.0
        tiles[..., [7, 40, 100, 300, 301, 555, 703, 901, 1017, 1023]] = -2.0
    else:
        raise ValueError(case)
    return x


TOPK_ADVERSARIAL = ("stride16", "stride32", "stride128", "all_equal",
                    "tie_at_threshold")


def ship_args(n: int) -> tuple:
    """``(chunk, k)`` of a leaf of ``n`` values per pod, as ``_ship_ring``
    cuts it at top-k ``TOPK``."""
    from repro_torch.core.sync import CHUNK

    chunk = min(CHUNK, n)
    return chunk, max(1, int(chunk * TOPK))


def phase_topk(torch) -> dict:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sizes = granite_leaf_sizes(torch)
    torch.cuda.empty_cache()

    def check(x, chunk, k, what):
        got = ops.topk_compress_chunked(x, chunk, k, block=TOPK_BLOCK)
        want = ops.topk_compress_chunked(x, chunk, k, block=TOPK_BLOCK,
                                         use_kernel=False)
        torch.cuda.synchronize()
        topk_equal(torch, got, want, chunk, what)

    for dtype in (torch.float32, torch.bfloat16):
        for n in sizes:
            x = torch.randn(PODS, n, generator=gen, device="cuda").to(dtype)
            check(x, *ship_args(n), f"leaf {n} {dtype}")
        base = torch.randn(3, 300_000, generator=gen, device="cuda")
        negz = torch.where(base > 0, -0.0, 0.0)
        negz[:, 5] = -0.25
        edge = [(torch.round(base * 2), 300_000, 3000, "ties"),
                (torch.zeros_like(base), 300_000, 3000, "zeros"),
                (negz, 300_000, 3000, "-0.0"),
                (base[:, :1027].clone(), 1027, 16, "pad wins (n 1027)"),
                (base, 5000, 3, "k // nb == 0"),
                (base[:, :8192].clone(), 8192, 81, "nb * k_block < k"),
                (base, 4096, 2048, "k_block 512"),
                (base[:, :300].clone(), 300, 20, "n < block")]
        edge += [(topk_adversarial(case, base[:, :299_008].clone()),
                  299_008, 2990, case) for case in TOPK_ADVERSARIAL]
        for x, chunk, k, what in edge:
            check(x.to(dtype), chunk, k, f"{what} {dtype}")
        print(f"[topk] {dtype}: kernel bit-equal to plain (vals, idx, "
              f"dense) on the 12 granite leaves as _ship_ring chunks them "
              f"and on {len(edge)} edge cases")
    del x, base, negz, edge
    torch.cuda.empty_cache()

    # the largest leaf (embed: 2 pods x 3 chunks of 2**26), f32 and bf16
    n = max(sizes)
    chunk, k = ship_args(n)
    k_block = max(1, k // (chunk // TOPK_BLOCK))
    x32 = torch.randn(PODS, n, generator=gen, device="cuda")
    rows = []
    for x in (x32, x32.bfloat16()):
        got = ops.topk_compress_chunked(x, chunk, k)
        err = float((got[0].float() - ref.topk_block_chunks(
            x, chunk, k, TOPK_BLOCK)[0].float()).abs().max())
        ms = time_ms(torch, lambda: ops.topk_compress_chunked(x, chunk, k),
                     reps=20)
        plain_ms = time_ms(torch, lambda: ops.topk_compress_chunked(
            x, chunk, k, use_kernel=False), reps=3, warm=1)
        lib_ms = time_ms(torch, lambda: torch.topk(
            x.abs().view(-1, TOPK_BLOCK), k_block, dim=1), reps=20)
        bound, by = topk_bound(x.numel() * x.element_size(), x.numel(),
                               got[0].numel(), x.element_size())
        rows.append((x.dtype, ms, plain_ms, lib_ms, bound, by, err))
        print(f"[topk] embed leaf {PODS} x {n} {x.dtype}, chunk {chunk}, "
              f"k {k}: {ms:.4f} ms (bound {bound:.4f} ms by {by}, plain "
              f"{plain_ms:.2f} ms, nearest torch.topk per block "
              f"{lib_ms:.4f} ms: no tie order, magnitudes)")
    # the embed leaf with every tile on the general branch
    xg = topk_adversarial("stride16", x32)
    got = ops.topk_compress_chunked(xg, chunk, k)
    topk_equal(torch, got, ops.topk_compress_chunked(
        xg, chunk, k, use_kernel=False), chunk, "general branch, embed")
    general_ms = time_ms(torch, lambda: ops.topk_compress_chunked(
        xg, chunk, k), reps=10)
    print(f"[topk] embed leaf, large values every 16 positions (every tile "
          f"on the general branch), f32: {general_ms:.4f} ms")
    del x32, x, xg, got
    torch.cuda.empty_cache()

    # a whole round: the 12 leaves, one launch each
    round_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs = [torch.randn(PODS, m, generator=gen, device="cuda").to(dtype)
              for m in sizes]
        args = [ship_args(m) for m in sizes]
        blocks = [min(TOPK_BLOCK, c) for c, _ in args]
        kbs = [max(1, k // -(-c // b)) for (c, k), b in zip(args, blocks)]

        def kernel_round():
            return [ops.topk_compress_chunked(x, c, k)
                    for x, (c, k) in zip(xs, args)]

        outs = kernel_round()
        ms = time_ms(torch, kernel_round, reps=10)
        plain_ms = time_ms(torch, lambda: [ops.topk_compress_chunked(
            x, c, k, use_kernel=False) for x, (c, k) in zip(xs, args)],
            reps=2, warm=1)
        lib_ms = time_ms(torch, lambda: [torch.topk(
            x.abs().view(-1, b), kb, dim=1)
            for x, b, kb in zip(xs, blocks, kbs)], reps=10)
        itemsize = xs[0].element_size()
        bound, by = topk_bound(sum(x.numel() for x in xs) * itemsize,
                               sum(x.numel() for x in xs),
                               sum(v.numel() for v, _ in outs), itemsize)
        round_rows[dtype] = (ms, plain_ms, lib_ms, bound, by)
        print(f"[topk] a round's 12 launches, {PODS} pods, {dtype}: "
              f"{ms:.4f} ms (bound {bound:.4f} ms by {by}, plain "
              f"{plain_ms:.2f} ms, nearest torch.topk per block "
              f"{lib_ms:.4f} ms)")
        del xs, outs
        torch.cuda.empty_cache()
    ms, plain_ms, lib_ms, bound, by = round_rows[torch.float32]
    return {"topk_compress": {
        "name": "topk_compress", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_compress.cu",
        "replaces": "src/repro/kernels/topk_compress.py:35",
        "max_abs_err": max(r[-1] for r in rows), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": lib_ms,
        "library_call": "torch.topk(x.abs().view(-1, 1024), k_block) per "
                        "leaf: the nearest call, not the same function",
        "general_branch_ms": general_ms}}


def phase_strategies(torch) -> int:
    """Phase 3's setup under each sync strategy, every top-k launch held to
    the plain version, then sparse ``asgd_ga`` again unchecked (its rounds
    unfenced); returns the top-k launches of the checked sparse runs."""
    from repro_torch import tree as T
    from repro_torch.configs import granite_8b
    from repro_torch.core import sync as S
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_batches
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = granite_8b.CONFIG.replace(n_layers=2)
    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0) for i in range(PODS))
    total, fenced_net = 0, {}
    runs = [(name, topk, True) for name, topk in STRATEGIES_3B]
    for strategy, topk, fenced in runs + [("asgd_ga", TOPK, False)]:
        sync = S.SyncConfig(strategy, 2, compress_topk=topk)
        plan = build_training_plan(TrainingRequest(
            model=cfg.name, clouds=clouds, sync=sync, n_iters=4,
            global_batch=8))
        batches = make_batches(plan, cfg.vocab_size, 512, "cuda")
        trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                          lambda g: transformer.init_params(g, cfg, "cuda"),
                          TrainerConfig(n_pods=PODS, optimizer="sgd",
                                        lr=0.02, sync=sync),
                          device="cuda")
        # each launch held to the plain version outside the round's time
        checked, check_s = [], [0.0] * 3
        check_hook = clocked(torch, topk_check_hook(torch, checked, strategy),
                             check_s, lambda: len(trainer.sync_seconds))

        state = trainer.init_state(SEED)
        leaves = T.leaves(state.params)
        model_mb = sum(x.numel() * x.element_size()
                       for x in leaves) / PODS / 1e6
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.TOPK_CHECK_HOOK = check_hook if fenced else None
        ops.reset_launches()
        state, hist = trainer.fit(state, batches, 4, model_mb=model_mb)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        ops.TOPK_CHECK_HOOK = None
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expect = 12 * 2 if topk else 0
        require(launches == {"wan_encode": 0, "wan_decode": 0,
                             "flash_attention": 0, "ssd_scan": 0,
                             "topk_compress": expect},
                f"{strategy} launches {launches}")
        require(len(checked) == (expect if fenced else 0),
                f"{len(checked)} launches checked")
        losses = hist["loss_per_pod"]
        require(all(math.isfinite(v) for row in losses for v in row),
                f"{strategy}: finite losses {losses}")
        for leaf in T.leaves(state.params):
            require(bool(torch.isfinite(leaf).all()),
                    f"{strategy}: finite params")
        rounds = trainer.sync_seconds
        net = [t - check_s[i] for i, t in enumerate(rounds)]
        require(len(rounds) == (0 if strategy == "asgd" else 2),
                f"{strategy}: {len(rounds)} sync rounds")
        frac = float(state.sync_state.significant_frac)
        steps = [round(t, 4) for t in trainer.step_seconds]
        if fenced:
            PHASE_TIMES[f"3b {strategy}"] = (trainer.step_seconds, net)
            fenced_net[strategy] = [round(t, 4) for t in net]
            print(f"[strategies] {strategy}@2 top-k {topk}: losses {losses}; "
                  f"step s {steps}, sync-round s {fenced_net[strategy]} (net "
                  f"of the check's {[round(v, 4) for v in check_s[:len(net)]]}"
                  f"), peak memory {peak_gb:.2f} GB, launches {launches}"
                  + (f", significant_frac {frac:.4g}" if strategy == "asp"
                     else ""))
            total += launches["topk_compress"]
        else:
            print(f"[strategies] {strategy}@2 top-k {topk} unchecked: losses "
                  f"{losses}; step s {steps}, sync-round s "
                  f"{[round(t, 4) for t in rounds]} unfenced (checked and "
                  f"fenced: {fenced_net[strategy]}), launches {launches}")
        del trainer, state, leaves, batches
        torch.cuda.empty_cache()
    return total


def bits_digest(torch, x) -> tuple:
    """Two int64 sums of a tensor's bit patterns, plain and weighted by
    position (mod 65521), taken 2**26 elements at a time on its device:
    equal bits give equal digests, and a changed or moved value changes
    them."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    flat = x.detach().contiguous().view(view).reshape(-1)
    plain = weighted = 0
    for lo in range(0, flat.numel(), 1 << 26):
        b = flat[lo:lo + (1 << 26)].to(torch.int64)
        w = torch.arange(lo, lo + b.numel(), device=b.device) % 65521 + 1
        plain += int(b.sum())
        weighted += int((b * w).sum())
    return plain, weighted


def state_digest(torch, state) -> dict:
    """Digests of every parameter leaf and of the EF residual."""
    from repro_torch import tree as T
    from repro_torch.sharding.rules import whole_local

    out = {path: bits_digest(torch, whole_local(x))
           for path, x in T.leaves_with_path(state.params)}
    out["ef_residual"] = bits_digest(
        torch, whole_local(state.sync_state.ef_residual))
    return out


def median_after_first(times) -> float:
    return statistics.median(times[1:]) if len(times) > 1 else float("nan")


def topk_check_hook(torch, checked: list, what: str):
    """``ops.TOPK_CHECK_HOOK``: each top-k launch held bit-equal to the
    plain version on the same input, outside the launch counts
    (:func:`clocked` keeps it out of the round's time)."""
    from repro_torch.kernels import ops, ref

    def hook(x, vals, idx, *, chunk, k, block):
        counts = dict(ops.LAUNCHES)
        want = ref.topk_block_chunks(x, chunk, k, block)
        topk_equal(torch, (vals, idx), want, chunk,
                   f"{what} launch {len(checked)}")
        checked.append(tuple(x.shape))
        ops.LAUNCHES.update(counts)
    return hook


def greedy_serve(torch, cfg, params, prompt, new: int, setup=None):
    """``transformer.prefill`` of ``prompt`` into a cache of ``prompt +
    new`` positions, then ``new`` greedy ``decode_step``s: placed by
    ``setup`` (a ``ServeSetup``; the step functions of
    ``dryrun.lower_prefill`` and ``lower_decode``) or unplaced.  Returns
    (every step's logits whole, the tokens, prefill s, decode-step s)."""
    import contextlib

    from repro_torch.models import transformer
    from repro_torch.sharding.rules import whole_local

    B, S = prompt.shape
    logits_seq, tokens, decode_s = [], [], []
    scope = setup.scope() if setup is not None else contextlib.nullcontext()
    with torch.no_grad(), scope:
        toks = (setup.place_batch({"tokens": prompt})["tokens"]
                if setup is not None else prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(params, cfg, toks, S + new)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        for i in range(new):
            whole = whole_local(logits).reshape(B, -1)
            logits_seq.append(whole)
            tok = torch.argmax(whole, dim=-1).to(torch.int32)
            tokens.append(tok.tolist())
            step = {"token": tok[:, None],
                    "cache_pos": torch.tensor(S + i, dtype=torch.int32,
                                              device=prompt.device)}
            if setup is not None:
                step = setup.place_batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(
                params, cfg, step["token"], cache, step["cache_pos"])
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
        logits_seq.append(whole_local(logits).reshape(B, -1))
    return logits_seq, tokens, prefill_s, decode_s


def mesh_serving_arm(torch, mesh) -> None:
    """Phase 3i arm (d): granite-8b at full width served under
    ``serve_rules`` on the one-rank mesh against the same parameters
    unplaced."""
    from repro_torch import tree as T
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import context as C
    from repro_torch.models import transformer
    from repro_torch.sharding.rules import is_dtensor

    setup = C.make_serve_setup(get_arch("granite-8b"), mesh,
                               config_overrides={"n_layers":
                                                 MESH_SERVE_LAYERS})
    cfg = setup.cfg
    require(cfg.attention_impl == "xla", "arm d serves under 'xla'")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = transformer.init_params(gen, cfg, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (2, MESH_SERVE_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    ops.reset_launches()
    want, want_tokens, want_prefill, want_decode = greedy_serve(
        torch, cfg, params, prompt, MESH_SERVE_NEW)
    placed = setup.place_params(params)
    require(all(is_dtensor(x) for x in T.leaves(placed)),
            "arm d: every parameter leaf is a DTensor")
    got, tokens, prefill_s, decode_s = greedy_serve(
        torch, cfg, placed, prompt, MESH_SERVE_NEW, setup)
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    require(not launched, f"arm d launches no kernel: {launched}")
    require(tokens == want_tokens, f"arm d: placed tokens {tokens} == "
            f"unplaced {want_tokens}")
    gap = max(float((a - b).abs().max()) for a, b in zip(got, want))
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"arm d: placed logits bit-equal to the unplaced run's on one "
            f"rank: max|gap| {gap}")
    print(f"[mesh] arm d (serving under serve_rules), {cfg.name} "
          f"x{cfg.n_layers} layers, \"xla\" attention, B 2 x "
          f"{MESH_SERVE_PROMPT} prompt, {MESH_SERVE_NEW} greedy steps on a "
          f"(1, 1, 1) mesh: tokens {tokens} equal to the unplaced run's, "
          f"logits bit-equal; prefill s {prefill_s:.4f} placed, {want_prefill:.4f} "
          f"unplaced; decode step s (median) "
          f"{statistics.median(decode_s):.4f} placed, "
          f"{statistics.median(want_decode):.4f} unplaced; {card_line()}")
    del params, placed, got, want
    torch.cuda.empty_cache()


def phase_mesh(torch) -> dict:
    """Phase 3i: the mesh path.  A one-rank NCCL group (a ``HashStore``:
    no network, no fallback), ``make_debug_mesh(1, 1, 1)``; phase 3's run
    built through ``make_train_setup`` and placed through ``TrainSetup``
    (arm a: the codec; arm b: sparse ``ama``, the top-k kernel), each held
    bit for bit against the unsharded trainer on the same seed and batches
    (losses, every parameter leaf's digest and the EF residual's), every
    codec round and top-k launch held to its plain version; the one-hot
    embedding's forward against the gather's; every arch's input specs on
    the meta device.  Returns the sharded arms' launches."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import tree as T
    from repro_torch.configs import all_archs, get_arch
    from repro_torch.core import sync as S
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.kernels import ops
    from repro_torch.launch import context as C
    from repro_torch.launch import mesh as M
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.train import make_batches
    from repro_torch.models import transformer
    from repro_torch.sharding.rules import is_dtensor
    from repro_torch.training.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    arch = get_arch("granite-8b")
    overrides, seq = {"n_layers": 2}, 512
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    launches = {name: 0 for name in ops.LAUNCHES}
    try:
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
        mesh = M.make_debug_mesh(1, 1, 1, device_type="cuda")
        clouds = tuple(CloudResources(region=f"pod{i}",
                                      devices=(("v5e", 4),), data_size=1.0)
                       for i in range(PODS))
        arms = {"a": (S.SyncConfig("asgd_ga", 2, compress_topk=TOPK,
                                   quantize_int8=True, error_feedback=True),
                      {"wan_encode": 2, "wan_decode": 4}),
                "b": (S.SyncConfig("ama", 2, compress_topk=TOPK),
                      {"topk_compress": 24}),
                "c": (S.SyncConfig("ama", 2), {})}
        round_s = {}
        for name, (sync, want) in arms.items():
            setup = C.make_train_setup(arch, mesh, sync=sync, lr=0.02,
                                       n_pods=PODS,
                                       config_overrides=overrides)
            cfg = setup.cfg
            plan = build_training_plan(TrainingRequest(
                model=cfg.name, clouds=clouds, sync=sync, n_iters=4,
                global_batch=8))
            batches = make_batches(plan, cfg.vocab_size, seq, "cuda")
            # the unsharded trainer first, then freed: two states at once
            # would not fit the card
            plain = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                            lambda g: transformer.init_params(g, cfg,
                                                              "cuda"),
                            TrainerConfig(n_pods=PODS, optimizer="sgd",
                                          lr=0.02, sync=sync),
                            device="cuda")
            state = plain.init_state(SEED)
            state, hist = plain.fit(state, batches, 4)
            want_losses, want_digest = hist["loss_per_pod"], \
                state_digest(torch, state)
            plain_times = (plain.step_seconds, plain.sync_seconds)
            del plain, state
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the sharded arm
            rounds, checked = [], []
            tr = setup.trainer
            tr.round_hook = codec_round_check(torch, rounds) \
                if sync.uses_codec else None
            state = setup.place_state(tr.init_state(SEED))
            require(all(is_dtensor(x) for x in T.leaves(state.params)),
                    f"arm {name}: every parameter leaf is a DTensor")
            # a top-k check runs inside its round, fenced and timed apart
            spent = [0.0] * 3
            ops.TOPK_CHECK_HOOK = None if sync.uses_codec else clocked(
                torch, topk_check_hook(torch, checked, "mesh"), spent,
                lambda: len(tr.sync_seconds))
            # the collectives of each round: a dense round on the placed
            # leaves gathers nothing
            round_comm = []
            whole_round = tr._sync_round

            def counted_round(st):
                with CommDebugMode() as comm:
                    out = whole_round(st)
                round_comm.append(sum(
                    v for k, v in comm.get_comm_counts().items()
                    if "all_gather" in str(k) or "allgather" in str(k)))
                return out
            tr._sync_round = counted_round
            ops.reset_launches()
            state, hist = tr.fit(state, lambda s: setup.place_batch(
                batches(s)), 4)
            torch.cuda.synchronize()
            got = dict(ops.LAUNCHES)
            require(len(round_comm) == 2, f"arm {name}: 2 rounds")
            if name == "c":
                require(round_comm == [0, 0], f"arm c's rounds post no "
                        f"all-gather: {round_comm}")
            ops.TOPK_CHECK_HOOK = None
            peak = torch.cuda.max_memory_allocated() / 1e9
            expect = {k: want.get(k, 0) for k in got}
            require(got == expect, f"arm {name} launches {got} == {expect}")
            require(len(rounds) == (2 if sync.uses_codec else 0)
                    and len(checked) == want.get("topk_compress", 0),
                    f"arm {name}: {len(rounds)} codec rounds and "
                    f"{len(checked)} top-k launches held to plain")
            require(hist["loss_per_pod"] == want_losses,
                    f"arm {name}: losses {hist['loss_per_pod']} == "
                    f"unsharded {want_losses}")
            digest = state_digest(torch, state)
            require(digest == want_digest,
                    f"arm {name}: parameters and EF residual bit-equal to "
                    f"the unsharded run, differing "
                    f"{[k for k in digest if digest[k] != want_digest.get(k)]}")
            for k, v in got.items():
                launches[k] += v
            # the unsharded run of the same config in an earlier phase
            ref_phase = {"a": "3", "b": "3b ama"}.get(name)
            ref3 = PHASE_TIMES.get(ref_phase)
            ship = ("int8 top-k " + str(TOPK) + " + EF" if sync.uses_codec
                    else "sparse top-k " + str(TOPK)
                    if sync.compress_topk else "dense")
            print(f"[mesh] arm {name} ({sync.strategy}, {ship}"
                  f"), {cfg.name} x{cfg.n_layers} layers, {PODS} pods on a "
                  f"(1, 1, 1) mesh: losses {hist['loss_per_pod']} bit-equal "
                  f"to the unsharded trainer, {len(digest)} digests equal; "
                  f"launches {got}; peak memory {peak:.2f} GB")
            net = [t - spent[i] for i, t in enumerate(tr.sync_seconds)]
            round_s[name] = net
            print(f"[mesh] arm {name} step s {[round(t, 4) for t in tr.step_seconds]}"
                  f", round s {[round(t, 4) for t in net]} (net of the "
                  f"top-k check's {[round(t, 4) for t in spent[:len(net)]]})"
                  f"; median after the first: step "
                  f"{median_after_first(tr.step_seconds):.4f} s, round "
                  f"{median_after_first(net):.4f} s; unsharded "
                  f"here: step {median_after_first(plain_times[0]):.4f} s, "
                  f"round {median_after_first(plain_times[1]):.4f} s"
                  + ("" if ref_phase is None else f"; phase {ref_phase}: "
                     + (f"step {median_after_first(ref3[0]):.4f} s, round "
                        f"{median_after_first(ref3[1]):.4f} s" if ref3
                        else "not run")))
            del setup, tr, state, batches
            torch.cuda.empty_cache()

        mesh_serving_arm(torch, mesh)

        # the one-hot embedding: a full-width forward against the gather
        cfg = arch.config.replace(**overrides)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = transformer.init_params(gen, cfg, "cuda")
        toks = torch.randint(0, cfg.vocab_size, (8, seq), generator=gen,
                             device="cuda")
        with torch.no_grad():
            a, _ = transformer.forward(params, cfg.replace(
                embed_impl="onehot"), toks)
            b, _ = transformer.forward(params, cfg, toks)
        gap = float((a - b).abs().max())
        scale = float(b.abs().max())
        require(gap <= ONEHOT_TOL * scale,
                f"one-hot logits within {ONEHOT_TOL} of max|logit| of the "
                f"gather's: gap {gap}")
        print(f"[mesh] one-hot embed forward, {cfg.name} x{cfg.n_layers} "
              f"layers, B 8, S {seq}: "
              + ("bit-equal to the gather's" if torch.equal(a, b) else
                 f"max|gap| {gap} (max|logit| {scale}), within "
                 f"{ONEHOT_TOL} of max|logit|"))
        del params, a, b

        # every arch x the four assigned shapes, on the meta device
        before = torch.cuda.memory_allocated()
        n_specs, skipped = 0, []
        for ar in all_archs():
            for shape_name, shape in SH.INPUT_SHAPES.items():
                ok, why = SH.shape_supported(ar, shape_name)
                if not ok:
                    skipped.append(f"{ar.name}/{shape_name}")
                    continue
                specs = (SH.train_batch_specs(ar, shape, 2)
                         if shape.kind == "train" else
                         SH.prefill_specs(ar, shape) if shape.kind ==
                         "prefill" else SH.decode_specs(ar, shape))
                require(all(v.device.type == "meta"
                            for v in specs.values()), "meta specs")
                n_specs += len(specs)
        after = torch.cuda.memory_allocated()
        require(after == before, f"input specs allocate nothing: "
                f"{before} -> {after} bytes")
        print(f"[mesh] input specs: {n_specs} meta tensors for "
              f"{len(all_archs())} archs x {len(SH.INPUT_SHAPES)} shapes, "
              f"{len(skipped)} skipped ({', '.join(skipped)}); device "
              f"memory {before} -> {after} bytes")
        smi = card_line()
        print(f"[mesh] round s on the placed leaves, arm c (dense ama) "
              f"{[round(t, 4) for t in round_s['c']]} (median after the "
              f"first {median_after_first(round_s['c']):.4f} s), beside "
              f"arm b (sparse ama, gathered whole) "
              f"{[round(t, 4) for t in round_s['b']]} "
              f"({median_after_first(round_s['b']):.4f} s); {smi}")
        print(f"[mesh] NCCL {nccl}; {smi}; "
              f"phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        ops.TOPK_CHECK_HOOK = None
        dist.destroy_process_group()
    return launches


# phase 3k: phase 3's run as two processes on the card, one pod each (one
# card a pod where the machine has two), 4 steps (2 rounds) an arm, each
# held bit for bit against the same arm run whole in this process: (a)
# SimTransport, (b) MeshTransport with the emulated hop, (c) a chaos plan
# with a failed and a corrupted attempt in round 1 and pod 1 crashed
# (degraded) in round 2, (d) a streaming round over 3g (b)'s collapsing
# trace that retunes mid-round, (e) HierarchicalTransport over two regions,
# (f) a retune from int8 to int4 between the rounds
POD_PROC_ARMS = ("a", "b", "c", "d", "e", "f")
POD_PROC_STEPS = 4
POD_PROC_TOPK = 0.05
POD_PROC_FAULTS = (("fail", 1, 0), ("corrupt", 1, 0), ("crash", 3, 1))
POD_PROC_TIMEOUT = 480        # seconds for the two pod processes together


def pod_arm(name: str, model_mb: float):
    """Phase 3k's arm ``name`` -> (sync config, transport, streaming
    controller or None, the config a retune after round 1 goes to or
    None).  Every process builds the same arm from the same seeds."""
    import dataclasses

    from repro_torch.core import sync as S
    from repro_torch.core.autotune import StreamingShipController
    from repro_torch.core.faults import ChaosTransport, FaultEvent, FaultPlan
    from repro_torch.core.topology import HierarchicalTransport, TopologySpec
    from repro_torch.core.transport import (MeasuredWanProbe, MeshTransport,
                                            SimTransport)
    from repro_torch.core.wan import BandwidthTrace, WANConfig

    sync = S.SyncConfig("asgd_ga", 2, compress_topk=POD_PROC_TOPK,
                        quantize_int8=True, error_feedback=True,
                        overlap_chunks=STREAM_CHUNKS,
                        bucket_policy="layer-class")
    trace = BandwidthTrace(*STREAM_TRACE)

    def sim(wan=WANConfig(fluctuation=0.25, seed=0)):
        return SimTransport(trace, wan, probe=MeasuredWanProbe())

    if name == "a":
        return sync, sim(), None, None
    if name == "b":
        return sync, MeshTransport(probe=MeasuredWanProbe(),
                                   emulate_mbps=HOP_MBPS), None, None
    if name == "c":
        plan = FaultPlan(tuple(FaultEvent(k, step, pod=pod)
                               for k, step, pod in POD_PROC_FAULTS))
        return sync, ChaosTransport(sim(), plan), None, None
    if name == "d":
        t = sim(WANConfig(latency_s=0.0, fluctuation=0.0))
        return sync, t, StreamingShipController(
            sync, model_mb, cliff_ratio=STREAM_CLIFF,
            ef_guard=STREAM_EF_GUARD, probe_est=t.probe.estimator), None
    if name == "e":
        spec = TopologySpec.from_regions(["us", "eu"], kind="tree")
        return sync, HierarchicalTransport(
            spec, trace, wan=WANConfig(fluctuation=0.25, seed=0),
            probe=MeasuredWanProbe()), None, None
    if name == "f":
        return sync, sim(), None, dataclasses.replace(sync,
                                                      value_dtype="int4")
    raise ValueError(name)


def row_digests(torch, state, first: int) -> dict:
    """Digests of every parameter leaf's, the gradient accumulator's and
    the EF residual's rows, keyed by the global pod: ``first`` is the
    global pod of row 0."""
    from repro_torch import tree as T
    from repro_torch.sharding.rules import whole_local

    out = {}
    leaves = T.leaves_with_path(state.params) + [
        ("ef_residual", state.sync_state.ef_residual)] + [
        ("ga" + path, x) for path, x in
        T.leaves_with_path(state.sync_state.ga_buffer)]
    for path, x in leaves:
        x = whole_local(x)
        for i in range(x.shape[0]):
            out[f"{path}@{first + i}"] = list(bits_digest(torch, x[i]))
    return out


def pod_drive(torch, trainer, state, batches, place=lambda b: b):
    """Phase 3k's loop: ``POD_PROC_STEPS`` steps, the round where due, the
    sim clock ticking 0.5 s a step, and ``trainer.retune_to`` (if set)
    applied after the first round.  Returns (trainer, state, the losses
    and what the host decided, as plain JSON values)."""
    import dataclasses

    from repro_torch.sharding.rules import whole_local

    t = trainer.transport
    retune_to = getattr(trainer, "retune_to", None)
    losses, keeps_mesh = [], None
    for step in range(POD_PROC_STEPS):
        batch = place(batches(step))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        trainer.step_seconds.append(time.perf_counter() - t0)
        losses.append(metrics["loss_per_pod"].float().cpu().tolist())
        state = trainer.maybe_sync(state, step)
        if hasattr(t, "tick"):
            t.tick(0.5)
        if retune_to is not None and len(trainer.sync_seconds) == 1:
            mesh = trainer.mesh
            trainer, state = trainer.retune(state, retune_to)
            keeps_mesh, retune_to = trainer.mesh is mesh, None
    torch.cuda.synchronize()
    stream = trainer.stream
    host = {
        "losses": losses,
        "records": [list(dataclasses.astuple(r)) for r in t.records],
        "probe": t.probe.estimator.bandwidth_mbps,
        "outcomes": list(getattr(t, "outcomes", [])),
        "retries": getattr(t, "retries", 0),
        "degraded": getattr(t, "degraded_rounds", 0),
        "stream_rounds": list(t.stream_rounds),
        "decisions": [] if stream is None else list(stream.decisions),
        "stream_retunes": trainer.stream_retunes,
        "tier": whole_local(state.sync_state.tier).tolist(),
        "keeps_mesh": keeps_mesh,
    }
    return trainer, state, json.loads(json.dumps(host))


def pod_batches(torch, cfg, sync, device: str, n_pods: int = PODS,
                steps: int = POD_PROC_STEPS):
    """The launcher's batches of global batch 8 split over ``n_pods``
    clouds (a batch function of the step)."""
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.launch.train import make_batches

    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0) for i in range(n_pods))
    plan = build_training_plan(TrainingRequest(
        model=cfg.name, clouds=clouds, sync=sync, n_iters=steps,
        global_batch=8))
    return make_batches(plan, cfg.vocab_size, 512, device)


def pod_proc_worker(rank: int, world: int, backend: str, store: str,
                    out_file: str) -> None:
    """One pod process of phase 3k: a ``world``-rank group of ``backend``
    (a ``FileStore``: no network), ``make_debug_mesh(2, 1, 1)`` on the
    card, every arm through ``make_train_setup`` with its transport bound
    to the split pod axis; each round held by :func:`fault_round_check`.
    Writes its rows' digests, the host decisions, launches, times and peak
    memory as JSON."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    deterministic(torch)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        from repro_torch.configs import get_arch
        from repro_torch.kernels import ops
        from repro_torch.launch import context as C
        from repro_torch.launch import mesh as M

        arch = get_arch("granite-8b")
        mesh = M.make_debug_mesh(PODS, 1, 1, device_type="cuda")
        out = {"arms": {}}
        for name in POD_PROC_ARMS:
            cfg = arch.config.replace(n_layers=2)
            sync, transport, stream, retune_to = pod_arm(
                name, cfg.param_count() * 2 / 1e6)
            setup = C.make_train_setup(arch, mesh, sync=sync, lr=0.02,
                                       n_pods=PODS,
                                       config_overrides={"n_layers": 2},
                                       transport=transport, stream=stream)
            tr = setup.trainer
            hook, checked, mark = fault_round_check(torch, transport,
                                                    tr.pods.first)
            tr.round_hook, tr.retune_to = hook, retune_to
            batches = pod_batches(torch, setup.cfg, sync, "cuda")
            state = setup.place_state(tr.init_state(SEED))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            mark.update(ops.LAUNCHES)
            pods = tr.pods
            tr, state, host = pod_drive(torch, tr, state, batches,
                                        setup.place_batch)
            out["arms"][name] = {
                "host": host, "digests": row_digests(torch, state,
                                                     pods.first),
                "launches": {k: ops.LAUNCHES[k]
                             for k in ("wan_encode", "wan_decode")},
                "checked": len(checked),
                "sync_s": list(tr.sync_seconds),
                "step_s": list(tr.step_seconds),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "sends": pods.sends, "agreements": pods.agreements}
            out["backend"], out["staged"] = pods.backend, pods.staged
            out["first"] = pods.first
            del setup, tr, state, batches, transport, stream
            torch.cuda.empty_cache()
        with open(out_file + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(out_file + ".tmp", out_file)
    finally:
        dist.destroy_process_group()


def phase_pod_procs(torch) -> dict:
    """Phase 3k: the WAN transports on a pod axis split over processes.
    Each arm runs whole in this process first (its digests kept, its
    state freed), then two spawned processes run every arm, one pod each;
    a failed or hung process fails the phase.  Returns the codec launches
    of the whole runs and both processes."""
    import tempfile

    import torch.multiprocessing as tmp

    from repro_torch.configs import granite_8b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = granite_8b.CONFIG.replace(n_layers=2)
    model_mb = cfg.param_count() * 2 / 1e6
    world = PODS
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    why = ("one card a pod" if backend == "nccl" else
           "both pods on one card: NCCL refuses two ranks on one device, "
           "so the pod group is gloo and the rows are staged through "
           "pinned host buffers")
    total = {"wan_encode": 0, "wan_decode": 0}
    want = {}
    for name in POD_PROC_ARMS:
        sync, transport, stream, retune_to = pod_arm(name, model_mb)
        hook, checked, mark = fault_round_check(torch, transport)
        tr = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                     lambda g: transformer.init_params(g, cfg, "cuda"),
                     TrainerConfig(n_pods=PODS, optimizer="sgd", lr=0.02,
                                   sync=sync),
                     device="cuda", round_hook=hook, transport=transport,
                     stream=stream)
        tr.retune_to = retune_to
        batches = pod_batches(torch, cfg, sync, "cuda")
        state = tr.init_state(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        mark.update(ops.LAUNCHES)
        tr, state, host = pod_drive(torch, tr, state, batches)
        require(len(checked) == POD_PROC_STEPS // 2,
                f"[pods] arm {name}: {len(checked)} rounds held")
        want[name] = {"host": host, "digests": row_digests(torch, state, 0),
                      "sync_s": list(tr.sync_seconds),
                      "step_s": list(tr.step_seconds),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        for k in total:
            total[k] += ops.LAUNCHES[k]
        del tr, state, batches, transport, stream
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t_phase

    # the pod processes: every arm, one pod each
    t_spawn = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
        ctx = tmp.get_context("spawn")
        procs = [ctx.Process(target=pod_proc_worker,
                             args=(r, world, backend,
                                   os.path.join(d, "store"), outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + POD_PROC_TIMEOUT
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join(10)
        require(not hung, f"[pods] {len(hung)} of {world} pod processes "
                f"still running after {POD_PROC_TIMEOUT} s")
        require([p.exitcode for p in procs] == [0] * world,
                f"[pods] pod processes exited {[p.exitcode for p in procs]}")
        got = []
        for o in outs:
            with open(o) as f:
                got.append(json.load(f))
    procs_s = time.perf_counter() - t_spawn
    smi = card_line()
    print(f"[pods] {cfg.name} x{cfg.n_layers} layers, {PODS} pods, batch 8, "
          f"seq 512, {POD_PROC_STEPS} steps an arm: {world} processes, "
          f"pod group {got[0]['backend']} (staged through pinned host "
          f"buffers: {got[0]['staged']}; {why})")
    for name in POD_PROC_ARMS:
        w = want[name]
        ranks = [g["arms"][name] for g in got]
        for r, a in enumerate(ranks):
            h, wh = a["host"], w["host"]
            require(h["losses"] == wh["losses"],
                    f"[pods] arm {name} rank {r}: losses {h['losses']} == "
                    f"whole {wh['losses']}")
            bad = [k for k, v in a["digests"].items()
                   if w["digests"].get(k) != v]
            require(not bad and len(a["digests"]) * world
                    == len(w["digests"]),
                    f"[pods] arm {name} rank {r}: rows bit-equal to the "
                    f"whole run, differing {bad[:4]}")
            same_keys = (("records", "probe", "outcomes", "retries",
                          "degraded", "stream_rounds", "decisions",
                          "stream_retunes", "tier") if name != "b"
                         else ("outcomes", "retries", "tier"))
            for k in same_keys:
                require(h[k] == wh[k], f"[pods] arm {name} rank {r}: {k} "
                        f"equal to the whole run's")
            if name == "b":
                require([x[:2] + x[3:] for x in h["records"]]
                        == [x[:2] + x[3:] for x in wh["records"]],
                        f"[pods] arm b rank {r}: record bytes equal")
            require(a["checked"] == POD_PROC_STEPS // 2,
                    f"[pods] arm {name} rank {r}: {a['checked']} rounds "
                    f"held to the plain decode")
            for k in total:
                total[k] += a["launches"][k]
        # every rank decided alike: measured seconds are agreed
        for k in ranks[0]["host"]:
            require(all(a["host"][k] == ranks[0]["host"][k]
                        for a in ranks),
                    f"[pods] arm {name}: ranks' {k} equal")
        h0 = ranks[0]["host"]
        if name == "c":
            require(h0["retries"] == 2 and h0["degraded"] == 1,
                    f"[pods] arm c: 2 retries, 1 degraded round: {h0}")
        if name == "d":
            require(h0["stream_retunes"] == 1,
                    f"[pods] arm d: one mid-round retune")
        if name == "f":
            require(h0["keeps_mesh"] is True
                    and h0["tier"] == [3] * len(h0["tier"]),
                    f"[pods] arm f: retuned on the mesh to int4")
        extra = ""
        if name == "b":
            extra = (f"; records {len(h0['records'])}, probe "
                     f"{h0['probe']:.1f} Mbps on both ranks (agreed: "
                     f"{ranks[0]['agreements']} all-reduces)")
        if name == "c":
            extra = (f"; outcomes {[o['kinds'] for o in h0['outcomes']]}, "
                     f"retries {h0['retries']}, degraded {h0['degraded']}")
        if name == "d":
            cut = [(x["step"], x["chunk"], x["bucket"])
                   for x in h0["decisions"] if x["action"] == "retune"]
            extra = f"; retune at (step, chunk, bucket) {cut}"
        print(f"[pods] arm {name}: losses and {len(w['digests'])} row "
              f"digests bit-equal to the whole run, host decisions equal"
              f"{extra}; launches by rank "
              f"{[a['launches'] for a in ranks]}, every round held to the "
              f"plain decode")
        print(f"[pods] arm {name} round s: split "
              f"{[[round(t, 4) for t in a['sync_s']] for a in ranks]} "
              f"against whole {[round(t, 4) for t in w['sync_s']]}; step s "
              f"split {[[round(t, 4) for t in a['step_s']] for a in ranks]}"
              f" against whole {[round(t, 4) for t in w['step_s']]}; peak "
              f"memory a process {[round(a['peak_gb'], 2) for a in ranks]}"
              f" GB against whole {w['peak_gb']:.2f} GB")
    print(f"[pods] whole runs {whole_s:.1f} s, pod processes {procs_s:.1f} "
          f"s; {smi}; phase {time.perf_counter() - t_phase:.1f} s")
    return total


# phase 3l: elastic reconfiguration on a split pod axis, one pod a process:
# granite-8b at full width and 1 layer, 3 pods (three processes share one
# card: at 2 layers one of phase 3k's processes peaks at 24.01-30.52 GB on
# an NVIDIA H100 80GB HBM3 at 700 W), the schedule of
# tests/test_torch_mesh_elastic.py
ELASTIC_PODS = 3
ELASTIC_LAYERS = 1
ELASTIC_STEPS = 8
ELASTIC_CRASH = 7             # the chaos round: pod 1 crashed
ELASTIC_TIMEOUT = 600         # seconds for the three pod processes together


def elastic_arm():
    """Phase 3l's sync config and transport: phase 3k's codec (int8 + EF
    at top-k ``POD_PROC_TOPK``, layer-class buckets of ``STREAM_CHUNKS``
    chunks), a round every 2 steps, over a ``SimTransport`` billed without
    fluctuation (a pod that idles misses rounds, so every bill depends on
    the clock alone) in a chaos plan that crashes pod 1 in the last
    round."""
    from repro_torch.core import sync as S
    from repro_torch.core.faults import ChaosTransport, FaultEvent, FaultPlan
    from repro_torch.core.transport import SimTransport
    from repro_torch.core.wan import BandwidthTrace, WANConfig

    sync = S.SyncConfig("asgd_ga", 2, compress_topk=POD_PROC_TOPK,
                        quantize_int8=True, error_feedback=True,
                        overlap_chunks=STREAM_CHUNKS,
                        bucket_policy="layer-class")
    sim = SimTransport(BandwidthTrace(*STREAM_TRACE),
                       WANConfig(fluctuation=0.0, seed=0))
    return sync, ChaosTransport(sim, FaultPlan((
        FaultEvent("crash", ELASTIC_CRASH, pod=1),)))


class ElasticPlan:
    """A reconfiguration plan as ``apply_reconfig`` reads one."""

    def __init__(self, n_new, keep, sync):
        from types import SimpleNamespace

        self.is_noop, self._t = False, (keep, n_new)
        self.new = SimpleNamespace(request=SimpleNamespace(sync=sync))

    def pod_transition(self):
        return self._t


def elastic_drive(torch, box, state, batches, d, setup=None, engine=None):
    """Phase 3l's schedule for the whole run (``setup=None``) or one pod
    process: two steps and a round on 3 pods; a save (placed: every rank)
    and, split, its restore held bit-equal, an async snapshot, and pod 1
    leaving at the barrier (``keep=(0, 2)``) staged by ``LiveMigrator``,
    the stage joined before the barrier (whole: ``apply_reconfig``); two
    steps and a round on 2 pods; pod 1
    rejoins; two steps and a round on 3 pods, two more with the chaos
    round.  ``box[0]`` is the live trainer (the round hook reads it);
    ``batches[n]`` the batch function for ``n`` pods.  Returns the host
    record: losses, times, digests of the rows after the leave, the rejoin
    and the last round, the save's and snapshot's commit records."""
    import dataclasses
    import shutil

    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.sharding.rules import local_part
    from repro_torch.training.trainer import LiveMigrator, apply_reconfig

    rec = {"losses": {}, "times": {}, "digests": {}}
    writer = setup is None or dist.get_rank() == 0

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec["times"][name] = time.perf_counter() - t0
        return out

    def steps(lo, hi):
        nonlocal state
        for step in range(lo, hi):
            tr = box[0]
            if state is not None:
                b = batches[tr.cfg.n_pods](step)
                if setup is not None:
                    b = setup.place_batch(b, tr)
                state, metrics = tr.train_step(state, b)
                rec["losses"][str(step)] = \
                    metrics["loss_per_pod"].float().cpu().tolist()
                state = tr.maybe_sync(state, step)
            tr.transport.tick(0.5)

    def digest(name):
        if state is not None:
            torch.cuda.synchronize()
            rec["digests"][name] = row_digests(torch, state,
                                               box[0].pods.first)

    def manifest(path):
        m = ckpt.load_manifest(path)
        return [m["arrays_bytes"], m["arrays_crc32"]]

    steps(0, 2)
    path = os.path.join(d, "save")
    run("save", lambda: box[0].save_state(path, state))
    rec["save"] = manifest(path)
    plan = ElasticPlan(2, (0, 2), box[0].cfg.sync)
    if setup is None:
        shutil.rmtree(path)
        box[0], state, _ = run("leave", lambda: apply_reconfig(
            box[0], state, plan))
    else:
        got, step = run("restore", lambda: setup.restore_state(path))
        rec["restore_equal"] = step == state.step and all(
            torch.equal(local_part(a), local_part(b))
            for a, b in zip(T.leaves(got), T.leaves(state))
            if isinstance(a, torch.Tensor))
        state = got
        del got
        dist.barrier()
        if writer:
            shutil.rmtree(path)
        t0 = time.perf_counter()
        engine.snapshot(state, state.step, parts=box[0].leaf_parts(state))
        rec["times"]["snapshot"] = time.perf_counter() - t0
        run("commit", engine.wait)
        rec["snapshot"] = manifest(engine.last_durable()[1])
        migrator = LiveMigrator(engine)
        migrator.stage(state, 2, (0, 2), trainer=box[0],
                       like=setup.abstract_state)
        run("stage", migrator.wait)
        box[0], state, _ = run("leave", lambda: migrator.reconcile(
            box[0], state, plan))
        rec["staged_mb"] = migrator.staged_mb
        rec["migrator_errors"] = [repr(e) for e in migrator.errors]
        migrator.last_staged = None
    digest("left")
    steps(2, 4)
    box[0], state = run("join", lambda: box[0].reconfigure(state, 3))
    digest("joined")
    steps(4, ELASTIC_STEPS)
    digest("final")
    t = box[0].transport
    rec.update(records=[list(dataclasses.astuple(r)) for r in t.records],
               outcomes=list(t.outcomes), degraded=t.degraded_rounds,
               retries=t.retries,
               moved_gb=getattr(box[0], "reconfig_sent", 0) / 1e9)
    return json.loads(json.dumps(rec))


def elastic_worker(rank: int, world: int, backend: str, store: str,
                   out_file: str, d: str) -> None:
    """One pod process of phase 3l: a ``world``-rank group of ``backend``
    (a ``FileStore``), ``make_debug_mesh(3, 1, 1)`` on the card, granite-8b
    x1 through ``make_train_setup`` (the rank's init staggered: each
    process builds the whole initial state before it keeps its rows), the
    async engine bound to the mesh, :func:`elastic_drive`, every round held
    by :func:`fault_round_check`.  Writes its record, launches and peak
    memory as JSON."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    deterministic(torch)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        from repro_torch.checkpoint.async_engine import AsyncCheckpointEngine
        from repro_torch.configs import get_arch
        from repro_torch.kernels import ops
        from repro_torch.launch import context as C
        from repro_torch.launch import mesh as M

        mesh = M.make_debug_mesh(ELASTIC_PODS, 1, 1, device_type="cuda")
        sync, transport = elastic_arm()
        setup = C.make_train_setup(
            get_arch("granite-8b"), mesh, sync=sync, lr=0.02,
            n_pods=ELASTIC_PODS,
            config_overrides={"n_layers": ELASTIC_LAYERS},
            transport=transport)
        box = [setup.trainer]
        hook, checked, mark = fault_round_check(
            torch, transport, first=lambda: box[0].pods.first,
            n_pods=lambda: box[0].cfg.n_pods)
        box[0].round_hook = hook
        batches = {n: pod_batches(torch, setup.cfg, sync, "cuda", n,
                                  ELASTIC_STEPS) for n in (2, 3)}
        state = None
        for r in range(world):
            if r == rank:
                state = setup.place_state(box[0].init_state(SEED))
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        engine = AsyncCheckpointEngine(os.path.join(d, "snaps"), keep=1)
        engine.bind(box[0].mesh_ranks)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        mark.update(ops.LAUNCHES)
        rec = elastic_drive(torch, box, state, batches, d, setup, engine)
        engine.close()
        rec.update(
            launches={k: ops.LAUNCHES[k] for k in ("wan_encode",
                                                   "wan_decode")},
            checked=len(checked), live=box[0].live,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            backend=str(dist.get_backend()), first=box[0].pods.first)
        with open(out_file + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(out_file + ".tmp", out_file)
    finally:
        dist.destroy_process_group()


def phase_elastic(torch) -> dict:
    """Phase 3l: elastic reconfiguration on a pod axis split over
    processes.  The schedule runs whole in this process first (its
    digests kept, its state freed), then in three spawned processes, one
    pod each; a failed or hung process fails the phase.  Returns the codec
    launches of the whole run and the processes."""
    import shutil
    import tempfile

    import torch.multiprocessing as tmp

    from repro_torch.configs import granite_8b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = granite_8b.CONFIG.replace(n_layers=ELASTIC_LAYERS)
    world = ELASTIC_PODS
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    sync, transport = elastic_arm()
    box = []
    hook, checked, mark = fault_round_check(
        torch, transport, n_pods=lambda: box[0].cfg.n_pods)
    box.append(Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                       lambda g: transformer.init_params(g, cfg, "cuda"),
                       TrainerConfig(n_pods=ELASTIC_PODS, optimizer="sgd",
                                     lr=0.02, sync=sync),
                       device="cuda", round_hook=hook, transport=transport))
    batches = {n: pod_batches(torch, cfg, sync, "cuda", n, ELASTIC_STEPS)
               for n in (2, 3)}
    state = box[0].init_state(SEED)
    gb = state_gb(torch, state)
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        free = shutil.disk_usage(d).free / 1e9
        require(free > 1.5 * gb, f"[elastic] {free:.1f} GB free on disk for "
                f"a {gb:.2f} GB state, want 1.5x")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        mark.update(ops.LAUNCHES)
        want = elastic_drive(torch, box, state, batches, d)
        want["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        require(len(checked) == ELASTIC_STEPS // 2,
                f"[elastic] whole run: {len(checked)} rounds held")
        total = {k: ops.LAUNCHES[k] for k in ("wan_encode", "wan_decode")}
        del state, box[:], transport
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        whole_s = time.perf_counter() - t_phase

        t_spawn = time.perf_counter()
        outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
        ctx = tmp.get_context("spawn")
        procs = [ctx.Process(target=elastic_worker,
                             args=(r, world, backend,
                                   os.path.join(d, "store"), outs[r], d))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + ELASTIC_TIMEOUT
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join(10)
        require(not hung, f"[elastic] {len(hung)} of {world} pod processes "
                f"still running after {ELASTIC_TIMEOUT} s")
        require([p.exitcode for p in procs] == [0] * world,
                f"[elastic] pod processes exited "
                f"{[p.exitcode for p in procs]}")
        got = []
        for o in outs:
            with open(o) as f:
                got.append(json.load(f))
    procs_s = time.perf_counter() - t_spawn
    away = {"2", "3"}               # steps pod 1's process idles through
    for r, g in enumerate(got):
        present = {s: v for s, v in want["losses"].items()
                   if r != 1 or s not in away}
        require(g["losses"] == present,
                f"[elastic] rank {r}: losses equal to the whole run's")
        rounds = [x for x in want["records"]
                  if r != 1 or str(x[-1]) not in away]
        require(g["records"] == rounds,
                f"[elastic] rank {r}: billed records equal to the whole "
                f"run's rounds it took part in")
        require(g["outcomes"] == want["outcomes"] and g["degraded"] == 1
                == want["degraded"],
                f"[elastic] rank {r}: the degraded chaos round, as whole")
        require(g["save"] == want["save"],
                f"[elastic] rank {r}: placed save {g['save']} == whole "
                f"save {want['save']} (bytes, CRC32)")
        require(g["snapshot"] == want["save"],
                f"[elastic] rank {r}: the snapshot's file is the save's")
        require(g["restore_equal"] is True,
                f"[elastic] rank {r}: restore bit-equal")
        require(not g["migrator_errors"],
                f"[elastic] rank {r}: migrator errors {g['migrator_errors']}")
        require(g["checked"] == ELASTIC_STEPS // 2 - (r == 1),
                f"[elastic] rank {r}: {g['checked']} rounds held to the "
                f"plain decode")
        require(g["live"], f"[elastic] rank {r} live at the end")
        for k in total:
            total[k] += g["launches"][k]
    require(got[1]["staged_mb"] == 0 and got[0]["staged_mb"] > 0
            and got[0]["staged_mb"] == got[2]["staged_mb"],
            f"[elastic] staged MB by rank {[g['staged_mb'] for g in got]}")
    for point in ("left", "joined", "final"):
        split = {}
        for g in got:
            split.update(g["digests"].get(point, {}))
        bad = [k for k, v in want["digests"][point].items()
               if split.get(k) != v]
        require(not bad and len(split) == len(want["digests"][point]),
                f"[elastic] {point}: every pod's rows bit-equal to the "
                f"whole run's, differing {bad[:4]}")
    smi = card_line()
    t = [g["times"] for g in got]
    print(f"[elastic] {cfg.name} x{cfg.n_layers} layer, {ELASTIC_PODS} pods, "
          f"batch 8, seq 512, {ELASTIC_STEPS} steps: {world} processes, pod "
          f"group {got[0]['backend']}; 3 -> 2 (keep (0, 2), staged) -> 3 "
          f"pods, a degraded round at 3 pods with pod 1 crashed; rows after "
          f"the leave, the rejoin and the last round bit-equal to the whole "
          f"run ({len(want['digests']['final'])} row digests), losses, "
          f"records and outcomes equal, every round held to the plain "
          f"decode")
    print(f"[elastic] save: whole {want['times']['save']:.2f} s, placed "
          f"{[round(x['save'], 2) for x in t]} s, {want['save'][0] / 1e9:.3f}"
          f" GB, CRC32 {want['save'][1]} on every rank; placed restore "
          f"{[round(x['restore'], 2) for x in t]} s; snapshot() host "
          f"{[round(x['snapshot'], 4) for x in t]} s, commit "
          f"{[round(x['commit'], 2) for x in t]} s; the leave's stage "
          f"(the snapshot read and resized to each rank's rows) "
          f"{[round(x['stage'], 2) for x in t]} s")
    print(f"[elastic] reconfiguration barrier s (the resize and the new "
          f"mesh, the stage joined before): leave split "
          f"{[round(x['leave'], 3) for x in t]} against whole "
          f"{want['times']['leave']:.3f}; rejoin split "
          f"{[round(x['join'], 3) for x in t]} against whole "
          f"{want['times']['join']:.3f}; staged MB "
          f"{[round(g['staged_mb'], 1) for g in got]}; peak GB a process "
          f"{[round(g['peak_gb'], 2) for g in got]} against whole "
          f"{want['peak_gb']:.2f}; launches by rank "
          f"{[g['launches'] for g in got]}")
    print(f"[elastic] whole run {whole_s:.1f} s, pod processes "
          f"{procs_s:.1f} s; {smi}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return total


DRYRUN_TIMEOUT = 300          # seconds for the full-depth dry runs
# phase 3j's runs: (arch, shape), each on the multi-pod mesh
DRYRUN_JOBS = (("granite-8b", "train_4k"), ("granite-8b", "prefill_32k"),
               ("granite-8b", "decode_32k"), ("mamba2-1.3b", "long_500k"))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, "nvidia-smi runs")
    return smi.stdout.strip().splitlines()[0]


def phase_dryrun(torch) -> dict:
    """Phase 3j: the dry run's command lines, started at once after the
    last timed phase on the card, each in a process of its own, their
    records into a temporary directory; every process is ended on the way
    out.  Returns the records by (arch, shape)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs, recs = {}, {}
    try:
        for arch, shape in DRYRUN_JOBS:
            # output to a file: a pipe left unread could fill and stop it
            with open(os.path.join(out_dir, f"{arch}__{shape}.log"),
                      "w") as log:
                procs[(arch, shape)] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh",
                     "multi_pod", "--out-dir", out_dir], cwd=ROOT, env=env,
                    stdout=log, stderr=subprocess.STDOUT)
        for (arch, shape), proc in procs.items():
            left = DRYRUN_TIMEOUT - (time.perf_counter() - t_phase)
            try:
                proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"chip_smoke check failed: the dry run "
                                   f"of {arch} {shape} ends within "
                                   f"{DRYRUN_TIMEOUT} s")
            with open(os.path.join(out_dir, f"{arch}__{shape}.log")) as f:
                log = f.read()
            require(proc.returncode == 0, f"the dry run of {arch} {shape} "
                    f"exits 0: {log[-3000:]}")
            with open(os.path.join(out_dir,
                                   f"{arch}__{shape}__multi_pod.json")) as f:
                rec = json.load(f)
            require(rec["status"] == "ok", f"dry run {arch} {shape} status "
                    f"{rec['status']}: {rec.get('traceback')}")
            coll = rec["collectives"]
            require(coll["cross_pod_bytes"] == 0,
                    f"the {arch} {shape} step crosses no pod: "
                    f"{coll['cross_pod_bytes']} B")
            line = ""
            if shape == "train_4k":
                cross = rec["sync_step"]["collectives"]["cross_pod_bytes"]
                require(cross > 0, "the dry run's sync step crosses pods")
                line = f", sync-step cross-pod bytes {cross}"
            mem, cost = rec["memory"], rec["cost"]
            need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            print(f"[dryrun] {arch} {shape} multi_pod (512 fake ranks, "
                  f"{rec['mesh_info']}), {rec['extrapolated']['n_groups']} "
                  f"layer groups, host counts a rank: argument "
                  f"{mem['argument_size_in_bytes']} B + temp "
                  f"{mem['temp_size_in_bytes']} B = {need / 1e9:.2f} GB "
                  f"beside the card's {total / 1e9:.2f} GB "
                  f"({torch.cuda.get_device_name(0)}); flops "
                  f"{cost['flops']:.6g}, in-pod collective bytes "
                  f"{coll['total_bytes'] - coll['cross_pod_bytes']}, "
                  f"cross-pod bytes {coll['cross_pod_bytes']}{line}; "
                  f"traced in {rec['lower_s']} s, record {rec['total_s']} s")
            recs[(arch, shape)] = rec
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[dryrun] {len(recs)} records ok; phase "
          f"{time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return recs


def phase_paper_models(torch) -> None:
    from repro_torch import tree as T
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data.pipeline import GeoDataset, synthetic_classification
    from repro_torch.kernels import ops, ref
    from repro_torch.models.reference import PAPER_MODELS
    from repro_torch.training.trainer import (Trainer, TrainerConfig,
                                              accuracy_eval,
                                              stack_pod_batches)

    runs = (("asgd", 1, 0.0), ("asgd_ga", 8, 0.0), ("ama", 8, 0.0),
            ("sma", 8, 0.0), ("ama", 8, TOPK))

    def check_hook(x, vals, idx, *, chunk, k, block):
        counts = dict(ops.LAUNCHES)
        topk_equal(torch, (vals, idx), ref.topk_block_chunks(
            x, chunk, k, block), chunk, f"paper model leaf {tuple(x.shape)}")
        ops.LAUNCHES.update(counts)

    for name in ("lenet", "resnet", "deepfm"):
        m = PAPER_MODELS[name]
        fv = 5400 if name == "deepfm" else None
        data = synthetic_classification(2000, m["input_shape"],
                                        m["n_classes"], seed=0,
                                        feature_vocab=fv)
        test = synthetic_classification(500, m["input_shape"],
                                        m["n_classes"], seed=1,
                                        feature_vocab=fv)
        geo = GeoDataset.partition(data, ["bj", "sh"], [1, 1])
        out, curves = {}, {}
        for strategy, interval, topk in runs:
            loaders = [geo.loader("bj", 32, seed=0),
                       geo.loader("sh", 32, seed=1)]
            trainer = Trainer(
                lambda p, b, m=m: (m["loss"](p, b), {}),
                lambda g, m=m: m["init"](g, "cuda"),
                TrainerConfig(n_pods=2, optimizer="sgd", lr=0.05,
                              sync=SyncConfig(strategy, interval,
                                              compress_topk=topk)),
                device="cuda")
            state = trainer.init_state(SEED)
            n_leaves = len(T.leaves(state.params))
            ops.TOPK_CHECK_HOOK = check_hook
            ops.reset_launches()
            state, hist = trainer.fit(
                state, lambda s: stack_pod_batches(
                    [next(ld) for ld in loaders], "cuda"), 16,
                eval_fn=accuracy_eval(m["apply"], test), eval_every=16)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            ops.TOPK_CHECK_HOOK = None
            expect = 2 * n_leaves if topk else 0
            require(launches == {"wan_encode": 0, "wan_decode": 0,
                                 "flash_attention": 0, "ssd_scan": 0,
                                 "topk_compress": expect},
                    f"{name} {strategy}@{interval} launches {launches}")
            require(all(math.isfinite(v) for v in hist["loss"]),
                    f"{name} {strategy}: finite losses")
            key = f"{strategy}@{interval}" + (f" top-k {topk}" if topk
                                              else "")
            curves[key] = hist["loss"]
            out[key] = {"loss_first": round(hist["loss"][0], 4),
                        "loss_last4": round(statistics.mean(
                            hist["loss"][-4:]), 4),
                        "acc": round(hist["eval"][-1][1], 4),
                        "step_s": round(statistics.median(
                            trainer.step_seconds), 5),
                        "topk_launches": launches["topk_compress"]}
        print(f"[paper] {name} ({n_leaves} leaves), 2 pods, batch 32, 16 "
              f"steps: {json.dumps(out)}")
        # at 2 pods the ring neighbour's copy is the other pod's, so ama's
        # (p + peer) / 2 is sma's mean: the two runs must agree step for
        # step (with cuDNN's deterministic algorithms, phase_device)
        gap = max(abs(x - y) for x, y in zip(curves["ama@8"],
                                              curves["sma@8"]))
        print(f"[paper] {name}: max |loss(ama@8) - loss(sma@8)| over 16 "
              f"steps {gap:.3g}")
        require(gap <= PAPER_AMA_SMA_TOL, f"{name}: ama@8 and sma@8 agree "
                f"within {PAPER_AMA_SMA_TOL} at 2 pods (gap {gap:.3g})")


def phase_entry_point_ama(torch) -> None:
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launches()
    summary = train.main(["--preset", "tiny", "--sync", "ama",
                          "--compress-topk", "0.02", "--interval", "4",
                          "--steps", "8", "--log-every", "4"])
    require(summary["device"] == "cuda", "launcher ran on the card")
    require(math.isfinite(summary["loss_last"]), "finite loss")
    require(ops.LAUNCHES["topk_compress"] > 0, "the sparse ama rounds "
            "launched the top-k kernel")


def phase_serving(torch) -> dict:
    from repro_torch import tree as T
    from repro_torch.configs import granite_8b
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import route_and_submit
    from repro_torch.models import transformer
    from repro_torch.serving.engine import (ContinuousEngine,
                                            ContinuousScheduler)
    from repro_torch.serving.router import GeoRouter, ReplicaSpec

    cfg = granite_8b.CONFIG.replace(attention_impl="pallas")
    cache_len = SERVE_PROMPT_LEN + SERVE_NEW_TOKENS
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count(), f"{n_params} params")

    def engine():
        return ContinuousEngine(None, params, n_slots=SERVE_SLOTS,
                                cache_len=cache_len, cfg=cfg,
                                module="transformer")

    # warm cuBLAS and the kernel's shared-memory attribute off the record
    with torch.no_grad():
        transformer.prefill(params, cfg, torch.zeros(
            1, 64, dtype=torch.int32, device="cuda"), 96)
    torch.cuda.synchronize()

    checked = []

    def check_hook(q, k, v, out, *, causal, window, softcap):
        """Hold each attention layer of the first prefill to ref.sdpa on the
        same q, k, v; the plain version launches no kernel of the port, and
        the counts are put back as they were all the same.  The hook takes
        itself off after the first prefill's last layer."""
        counts = dict(ops.LAUNCHES)
        expect = ref.sdpa(q, k, v, causal=causal, window=window,
                          softcap=softcap)
        checked.append(flash_close(torch, out, expect,
                                   f"prefill layer {len(checked)}"))
        ops.LAUNCHES.update(counts)
        if len(checked) == cfg.n_layers:
            ops.FLASH_CHECK_HOOK = None

    router = GeoRouter([ReplicaSpec(region=r, n_slots=SERVE_SLOTS)
                        for r in SERVE_REGIONS], mode="balanced")
    scheds = {r: ContinuousScheduler(engine()) for r in SERVE_REGIONS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    check_s = [0.0]
    ops.FLASH_CHECK_HOOK = clocked(torch, check_hook, check_s)
    ops.reset_launches()
    t0 = time.perf_counter()
    placed = route_and_submit(router, scheds, SERVE_REGIONS, SERVE_REQUESTS,
                              SERVE_PROMPT_LEN, SERVE_NEW_TOKENS,
                              cfg.vocab_size, seed=0)
    by_region = {r: s.run() for r, s in scheds.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - check_s[0]
    launches = dict(ops.LAUNCHES)
    ops.FLASH_CHECK_HOOK = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    results = {}
    for rid, (region, local, _) in placed.items():
        results[rid] = by_region[region][local]
        router.complete(rid)

    engines = [s.engine for s in scheds.values()]
    prefill_s = [t for e in engines for t in e.prefill_seconds]
    prefill_s[0] -= check_s[0]    # the first prefill run held the check
    step_s = [t for e in engines for t in e.step_seconds]
    n_prefills = len(prefill_s)
    require(n_prefills == SERVE_REQUESTS, f"{n_prefills} prefills")
    require(all(len(t) == SERVE_NEW_TOKENS for t in results.values())
            and len(results) == SERVE_REQUESTS,
            f"every request finished with {SERVE_NEW_TOKENS} tokens")
    require(all(0 <= int(x) < cfg.vocab_size for t in results.values()
                for x in t), "tokens within the vocabulary")
    require(launches == {"wan_encode": 0, "wan_decode": 0,
                         "flash_attention": cfg.n_layers * n_prefills,
                         "ssd_scan": 0, "topk_compress": 0},
            f"serving launches {launches}: {cfg.n_layers} flash launches "
            f"per prefill")
    require(len(checked) == cfg.n_layers,
            f"{len(checked)} prefill layers held to ref.sdpa")
    routes = {r: sum(1 for p in placed.values() if p[0] == r)
              for r in SERVE_REGIONS}

    # slot independence: request 0 went first into slot 0 of its replica
    # and its neighbours were inserted while it decoded; alone in a fresh
    # pool it must give the same tokens
    region0, local0, prompt0 = placed[0]
    hist = scheds[region0].history
    require(hist[0] == ("prefill", local0, 0), f"request 0 in slot 0: "
            f"{hist[0]}")
    done0 = hist.index(("finish", local0, "max_new"))
    require(any(h[0] == "prefill" for h in hist[1:done0]),
            "a neighbour was inserted while request 0 decoded")
    solo = engine()
    solo.insert(prompt0, SERVE_NEW_TOKENS, rid=0)
    alone = None
    while alone is None:
        for f in solo.step():
            alone = f.tokens
    require(solo.slots == [None] * SERVE_SLOTS, "solo pool drained")
    require(list(alone) == list(results[0]),
            "request 0 alone == request 0 beside inserted neighbours")

    total_new = sum(len(t) for t in results.values())
    print(f"[serve] {cfg.name} x{cfg.n_layers} layers, {n_params:,} params, "
          f"{cfg.compute_dtype}, attention_impl=pallas; "
          f"{len(SERVE_REGIONS)} replicas x {SERVE_SLOTS} slots, cache_len "
          f"{cache_len}; routes {routes}")
    print(f"[serve] prompt lengths "
          f"{[len(p[2]) for _, p in sorted(placed.items())]}; every "
          f"request finished with {SERVE_NEW_TOKENS} tokens; launches "
          f"{launches}; first prefill's {len(checked)} layers within "
          f"{FLASH_TOL['torch.bfloat16']} of ref.sdpa (max |err| "
          f"{max(checked):.3g}); request 0 alone == beside neighbours")
    print(f"[serve] prefill s per request {[round(t, 4) for t in prefill_s]}"
          f" (median {statistics.median(prefill_s):.4f}; the first net of its check's {check_s[0]:.4f} s, left out of "
          f"tok/s too), median decode step {statistics.median(step_s):.4f} s over "
          f"{len(step_s)} pool steps, {total_new} tokens in {wall:.2f} s = "
          f"{total_new / wall:.1f} generated tok/s, peak memory "
          f"{peak_gb:.2f} GB")
    return launches


def phase_serve_entry_point(torch) -> None:
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = serve.main(["--replicas", "2", "--requests", "6"])
    text = buf.getvalue()
    print(text, end="")
    summary, _ = json.JSONDecoder().raw_decode(text[text.index("{"):])
    require(summary["device"] == "cuda", "serve launcher ran on the card")
    require(len(results) == 6 and sum(summary["routes"].values()) == 6,
            "6 requests served and routed")


def phase_gemma3_prefill(torch) -> dict:
    """Phase 5c: gemma3-12b at its published size, one prefill of a
    2048-token prompt through the flash kernel (48 launches: 40 windowed
    layers, 8 global) and 8 decode steps; layers 0 (window 1024) and 5
    (global) held to ``ref.sdpa`` on the same q, k, v."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import gemma3_12b
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ContinuousEngine

    cfg = gemma3_12b.CONFIG.replace(attention_impl="pallas")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count(), f"{n_params} params")
    weights_gb = sum(x.numel() * x.element_size()
                     for x in T.leaves(params)) / 1e9
    with torch.no_grad():
        transformer.prefill(params, cfg, torch.zeros(
            1, 64, dtype=torch.int32, device="cuda"), 96)
    torch.cuda.synchronize()

    seen, checked = [0], {}

    def check_hook(q, k, v, out, *, causal, window, softcap):
        """Hold layers 0 and 5 of the prefill to ref.sdpa; the plain
        version launches no kernel of the port, and the counts are put
        back as they were all the same."""
        layer = seen[0]
        seen[0] += 1
        if layer in GEMMA_CHECKED_LAYERS:
            counts = dict(ops.LAUNCHES)
            expect = ref.sdpa(q, k, v, causal=causal, window=window,
                              softcap=softcap)
            checked[layer] = (window, flash_close(
                torch, out, expect, f"gemma3 prefill layer {layer}"))
            ops.LAUNCHES.update(counts)

    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, SERVE_PROMPT_LEN).astype(np.int32)
    engine = ContinuousEngine(None, params, n_slots=1,
                              cache_len=SERVE_PROMPT_LEN + GEMMA_NEW_TOKENS,
                              cfg=cfg, module="transformer")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    check_s = [0.0]
    ops.FLASH_CHECK_HOOK = clocked(torch, check_hook, check_s)
    ops.reset_launches()
    engine.insert(prompt, GEMMA_NEW_TOKENS, rid=0)
    ops.FLASH_CHECK_HOOK = None
    tokens = None
    while tokens is None:
        for f in engine.step():
            tokens = f.tokens
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(launches == {"wan_encode": 0, "wan_decode": 0,
                         "flash_attention": cfg.n_layers, "ssd_scan": 0,
                         "topk_compress": 0},
            f"gemma3 launches {launches}: {cfg.n_layers} flash launches "
            f"in one prefill")
    require(sorted(checked) == list(GEMMA_CHECKED_LAYERS)
            and checked[0][0] == 1024 and checked[5][0] is None,
            f"layers 0 (window 1024) and 5 (global) checked: {checked}")
    require(len(tokens) == GEMMA_NEW_TOKENS
            and all(0 <= int(t) < cfg.vocab_size for t in tokens),
            f"{len(tokens)} tokens within the vocabulary")
    prefill_s = engine.prefill_seconds[0] - check_s[0]
    step_s = statistics.median(engine.step_seconds)

    # the flash kernel's share of the prefill: its time at the prefill's
    # two layer shapes, as many times as the prefill launches each
    q, k, v = (torch.randn(1, SERVE_PROMPT_LEN, n, cfg.resolved_head_dim,
                           device="cuda", dtype=torch.bfloat16)
               for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    windows = [s.window for s in cfg.pattern] * cfg.n_groups
    ms = {w: time_ms(torch, lambda w=w: ops.flash_attention(
        q, k, v, window=w), reps=20) for w in set(windows)}
    flash_ms = sum(ms[w] for w in windows)
    print(f"[gemma3] {cfg.name} x{cfg.n_layers} layers, {n_params:,} params "
          f"({weights_gb:.2f} GB bf16), d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, window 1024 on "
          f"{windows.count(1024)} layers; prompt {SERVE_PROMPT_LEN} tokens, "
          f"{GEMMA_NEW_TOKENS} new: launches {launches}; layers 0 and 5 "
          f"within {FLASH_TOL['torch.bfloat16']} + "
          f"{FLASH_TOL['torch.bfloat16']}|ref| of ref.sdpa (max |err| "
          f"{ {l: round(e, 5) for l, (_, e) in checked.items()} })")
    print(f"[gemma3] prefill {prefill_s:.4f} s (net of its check's "
          f"{check_s[0]:.4f} s), median decode step {step_s:.4f} s over "
          f"{len(engine.step_seconds)} steps; flash at the prefill's shapes "
          f"{ {str(w): round(t, 4) for w, t in ms.items()} } ms a launch, "
          f"{flash_ms:.3f} ms a prefill = "
          f"{flash_ms / (prefill_s * 1e3):.1%} of it; peak memory "
          f"{peak_gb:.2f} GB")
    del params, engine, q, k, v
    return launches


def ssd_close(torch, y, final, y_ref, f_ref, what: str) -> tuple:
    """Hold an SSD output to its plain version at the reference's
    tolerance; returns the largest |diff| of y, absolute and over max|y|."""
    scale = float(y_ref.float().abs().max()) or 1.0
    y_abs = float((y.float() - y_ref.float()).abs().max())
    y_err = y_abs / scale
    s_err = float((final - f_ref).abs().max())
    require(y_err <= SSD_Y_TOL and s_err <= SSD_STATE_TOL
            and bool(torch.isfinite(y).all()),
            f"ssd {what} within {SSD_Y_TOL} (y / max|y|) and "
            f"{SSD_STATE_TOL} (state) of ref.ssd (got {y_err:.3g}, "
            f"{s_err:.3g})")
    return y_abs, y_err


def ssd_f64(torch, x, a, Bm, Cm, chunk, init_state):
    """The chunked SSD of ``ref.ssd`` evaluated in float64: the yardstick
    that the kernel and the plain f32 version are both measured against on
    a real prefill's inputs."""
    f64 = torch.float64
    Bsz, S, H, P = x.shape
    N, L = Bm.shape[-1], min(chunk, S)
    nc = S // L
    xc = x.reshape(Bsz, nc, L, H, P).to(f64)
    Bc = Bm.reshape(Bsz, nc, L, H, N).to(f64)
    Cc = Cm.reshape(Bsz, nc, L, H, N).to(f64)
    a_cum = torch.cumsum(a.reshape(Bsz, nc, L, H).to(f64).movedim(-1, -2),
                         dim=-1)                          # (B, nc, H, L)
    seg = a_cum[..., :, None] - a_cum[..., None, :]
    tril = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    Lmat = torch.where(tril, seg, -torch.inf).exp()
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc) * Lmat
    y = torch.einsum("bchls,bcshp->bclhp", scores, xc)
    w = (a_cum[..., -1:] - a_cum).exp()
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Bc, w, xc)
    st = (torch.zeros(Bsz, H, P, N, dtype=f64, device=x.device)
          if init_state is None else init_state.to(f64))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * a_cum[:, c, :, -1, None, None].exp() + states[:, c]
    y = y + torch.einsum("bclhn,bchpn,bchl->bclhp", Cc,
                         torch.stack(prev, 1), a_cum.exp())
    return y.reshape(Bsz, S, H, P), st


def ssd_serving_close(torch, x, a, Bm, Cm, y, final, chunk, init_state,
                      what: str) -> dict:
    """Hold a real prefill's SSD to the plain f32 version within
    SERVE_SSD_TOL (y / max|y|, state / max|state|) and to the f64
    evaluation within the reference's SSD_Y_TOL.  At the model's real
    decays (``max_abs_a``, up to a few hundred per step in the fast heads)
    the f32 plain version is itself ~1e-4
    from exact, mostly from rounding the f32 log-decay prefix, which the
    kernel keeps in f64; so the reference's tolerance is held against the
    f64 yardstick, and the looser one against the plain version."""
    from repro_torch.kernels import ref

    y_ref, f_ref = ref.ssd(x, a, Bm, Cm, chunk=chunk, init_state=init_state)
    y64, f64 = ssd_f64(torch, x, a, Bm, Cm, chunk, init_state)
    ys, fs = float(y64.abs().max()) or 1.0, float(f64.abs().max()) or 1.0

    def err(t, ref_t, scale):
        return float((t.double() - ref_t.double()).abs().max()) / scale

    e = {"y_vs_plain": err(y, y_ref, ys), "state_vs_plain": err(final, f_ref,
                                                                 fs),
         "y_vs_f64": err(y, y64, ys), "state_vs_f64": err(final, f64, fs),
         "plain_y_vs_f64": err(y_ref, y64, ys),
         "plain_state_vs_f64": err(f_ref, f64, fs),
         "max_abs_a": float(a.abs().max())}
    require(bool(torch.isfinite(y).all())
            and e["y_vs_plain"] <= SERVE_SSD_TOL
            and e["state_vs_plain"] <= SERVE_SSD_TOL
            and e["y_vs_f64"] <= SSD_Y_TOL and e["state_vs_f64"] <= SSD_Y_TOL,
            f"ssd {what} within {SERVE_SSD_TOL} of ref.ssd and {SSD_Y_TOL} "
            f"of the f64 SSD: {e}")
    return e


def ssd_flops(B, S, H, P, N, L) -> tuple:
    """The causal products of one SSD call: (C B^T over the L(L+1)/2 pairs
    of each chunk, the masked scores times x, and the two products that
    take B or C as one operand: the local state x^T (B w) and the
    carried-state term C state^T)."""
    blocks = B * H * (S // L)
    pairs = L * (L + 1) // 2
    return (blocks * 2 * pairs * N, blocks * 2 * pairs * P,
            blocks * 4 * L * N * P)


def ssd_bound(B, S, H, P, N, L, nbytes, bc_bf16: bool):
    """The least time for one SSD call: the causal products' FLOPs, each
    over the peak rate of the tensor-core arithmetic that keeps the spec's
    f32 accuracy, or the bytes over the memory rate, whichever is larger.
    C B^T with bf16 B and C runs at the bf16 rate (a product of two bf16
    values is exact in f32).  A product with an f32 operand runs as 3xTF32,
    hi*hi + hi*lo + lo*hi: three TF32 products where both operands are f32
    (the scores times x; every product when B and C are f32), two where the
    other is bf16, which is exact in TF32 and has no lo part (the local and
    carried-state products with bf16 B and C)."""
    cb, sx, state = ssd_flops(B, S, H, P, N, L)
    if bc_bf16:
        f_ms = (cb / BF16_FLOP_PER_S
                + (3 * sx + 2 * state) / TF32_FLOP_PER_S) * 1e3
    else:
        f_ms = 3 * (cb + sx + state) / TF32_FLOP_PER_S * 1e3
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes")


def phase_ssd(torch) -> dict:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(B, S, H, P, N, bc_dtype=torch.float32, init=False,
               expand=False):
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        x = randn(B, S, H, P)
        a = -randn(B, S, H).abs() * 0.1
        if expand:
            Bm = randn(B, S, 1, N).to(bc_dtype).expand(B, S, H, N)
            Cm = randn(B, S, 1, N).to(bc_dtype).expand(B, S, H, N)
        else:
            Bm = randn(B, S, H, N).to(bc_dtype)
            Cm = randn(B, S, H, N).to(bc_dtype)
        return x, a, Bm, Cm, (randn(B, H, P, N) if init else None)

    def check(B, S, H, P, N, chunk, **kw):
        x, a, Bm, Cm, s0 = inputs(B, S, H, P, N, **kw)
        y, f = ops.ssd_scan(x, a, Bm, Cm, chunk=chunk, init_state=s0)
        y_ref, f_ref = ref.ssd(x, a, Bm, Cm, chunk=chunk, init_state=s0)
        torch.cuda.synchronize()
        return ssd_close(torch, y, f, y_ref, f_ref,
                         f"{(B, S, H, P, N, chunk)} {kw}")

    bf16 = torch.bfloat16
    main = (1, SERVE_PROMPT_LEN, 64, 64, 128, MAMBA_CHUNK)
    cases = [((2, 128, 4, 16, 32, 32), {}),       # the reference's tests
             ((1, 256, 2, 64, 128, 64), {}),
             ((2, 64, 8, 8, 16, 64), {}),
             ((1, 256, 8, 64, 128, 256), {}),     # S == chunk
             ((2, 100, 8, 64, 128, 256), {}),     # S < chunk
             ((2, 512, 4, 64, 128, 256), {"init": True}),
             ((1, 512, 8, 64, 128, 256), {"bc_dtype": bf16}),
             ((1, 512, 8, 64, 128, 256), {"bc_dtype": bf16, "expand": True}),
             (main, {"bc_dtype": bf16, "expand": True})]
    # chunks 64, 128 and 256 (f32 and bf16 B/C), 16 chunks, the scoring
    # shape (B 2), init_state with bf16 and stride-0 B/C
    cases += [((1, 1024, 8, 64, 128, c), {"bc_dtype": d, "expand": True,
                                          "init": True})
              for c in (64, 128, 256) for d in (torch.float32, bf16)]
    cases += [((1, 4096, 16, 64, 128, 256), {"bc_dtype": bf16,
                                              "expand": True}),
              ((MAMBA_SCORE_BATCH,) + main[1:], {"bc_dtype": bf16,
                                                  "expand": True}),
              ((2, 512, 8, 64, 128, 256), {"bc_dtype": bf16, "init": True}),
              ((2, 512, 8, 64, 128, 256), {"bc_dtype": bf16, "init": True,
                                           "expand": True}),
              ((2, 192, 3, 80, 100, 96), {"bc_dtype": bf16, "init": True})]
    errs = [check(*shape, **kw)[1] for shape, kw in cases]
    print(f"[ssd] kernel within {SSD_Y_TOL} (y / max|y|) and "
          f"{SSD_STATE_TOL} (state) of ref.ssd on {len(cases)} cases (the "
          f"reference's kernel tests, S == chunk, S < chunk, init_state, "
          f"f32 and bf16 B/C, stride-0 B/C, chunks 64-256, 16 chunks, "
          f"ragged P-tiles, the serving prefill's and the scoring "
          f"forward's shapes); max y "
          f"err {max(errs):.3g}")

    B, S, H, P, N, L = main
    x, a, Bm, Cm, _ = inputs(B, S, H, P, N, bc_dtype=bf16, expand=True)
    y, f = ops.ssd_scan(x, a, Bm, Cm, chunk=L)
    abs_err, err = ssd_close(torch, y, f, *ref.ssd(x, a, Bm, Cm, chunk=L),
                             "main-path shape")
    ms = time_ms(torch, lambda: ops.ssd_scan(x, a, Bm, Cm, chunk=L),
                 reps=20)
    plain_ms = time_ms(torch, lambda: ref.ssd(x, a, Bm, Cm, chunk=L),
                       reps=5)
    # inputs read once (B and C as their stride-0 storage), outputs once
    nbytes = (x.numel() * 4 + a.numel() * 4 + 2 * B * S * N * 2
              + y.numel() * 4 + f.numel() * 4)
    bound, by = ssd_bound(B, S, H, P, N, L, nbytes,
                          bc_bf16=Bm.dtype == torch.bfloat16)
    flops = sum(ssd_flops(B, S, H, P, N, L))
    print(f"[ssd] {(B, S, H, P, N)} chunk {L}, x/a f32, B/C bf16 stride-0: "
          f"{ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s (bound {bound:.4f} "
          f"ms by {by}, the f32-operand products priced as 3xTF32; plain "
          f"{plain_ms:.3f} ms, no single PyTorch call), max |y err| "
          f"{abs_err:.3g} ({err:.3g} of max|y|)")
    return {"ssd_scan": {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:32",
        "max_abs_err": abs_err, "max_rel_err": err, "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None}}


def mamba_requests(regions, vocab_size: int):
    """Phase 5's draws (the serving launcher's, numpy seed 0, prompt-len
    2048), each prompt cut to a multiple of the SSD chunk."""
    import numpy as np

    rng = np.random.default_rng(0)
    out = []
    for _ in range(SERVE_REQUESTS):
        plen = int(rng.integers(SERVE_PROMPT_LEN // 2, SERVE_PROMPT_LEN + 1))
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        src = regions[int(rng.integers(len(regions)))]
        out.append((prompt, prompt[: plen // MAMBA_CHUNK * MAMBA_CHUNK], src))
    return out


def phase_mamba_serving(torch):
    from repro_torch import tree as T
    from repro_torch.configs import mamba2_1_3b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.engine import (ContinuousEngine,
                                            ContinuousScheduler)
    from repro_torch.serving.router import GeoRouter, ReplicaSpec

    cfg = mamba2_1_3b.CONFIG
    cache_len = SERVE_PROMPT_LEN + SERVE_NEW_TOKENS
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count(), f"{n_params} params")

    def engine():
        return ContinuousEngine(None, params, n_slots=SERVE_SLOTS,
                                cache_len=cache_len, cfg=cfg,
                                module="transformer")

    # warm cuBLAS and the kernel's shared-memory attribute off the record
    with torch.no_grad():
        transformer.prefill(params, cfg, torch.zeros(
            1, MAMBA_CHUNK, dtype=torch.int32, device="cuda"), 96)
    torch.cuda.synchronize()

    checked = []

    def check_hook(x, a, Bm, Cm, y, final, *, chunk, init_state):
        """Hold each SSM layer of the first prefill to ref.ssd on the same
        inputs; the plain version launches no kernel of the port, and the
        counts are put back as they were all the same.  The hook takes
        itself off after the first prefill's last layer."""
        counts = dict(ops.LAUNCHES)
        checked.append(ssd_serving_close(
            torch, x, a, Bm, Cm, y, final, chunk, init_state,
            f"prefill layer {len(checked)}"))
        ops.LAUNCHES.update(counts)
        if len(checked) == cfg.n_layers:
            ops.SSD_CHECK_HOOK = None

    router = GeoRouter([ReplicaSpec(region=r, n_slots=SERVE_SLOTS)
                        for r in SERVE_REGIONS], mode="balanced")
    scheds = {r: ContinuousScheduler(engine()) for r in SERVE_REGIONS}
    requests = mamba_requests(SERVE_REGIONS, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    check_s = [0.0]
    ops.SSD_CHECK_HOOK = clocked(torch, check_hook, check_s)
    ops.reset_launches()
    t0 = time.perf_counter()
    placed = {}
    for rid, (_, prompt, src) in enumerate(requests):
        region = router.route(rid, src, prompt.size, SERVE_NEW_TOKENS)
        placed[rid] = (region, scheds[region].submit(prompt,
                                                     SERVE_NEW_TOKENS),
                       prompt)
    by_region = {r: s.run() for r, s in scheds.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - check_s[0]
    launches = dict(ops.LAUNCHES)
    ops.SSD_CHECK_HOOK = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    results = {}
    for rid, (region, local, _) in placed.items():
        results[rid] = by_region[region][local]
        router.complete(rid)

    engines = [s.engine for s in scheds.values()]
    prefill_s = [t for e in engines for t in e.prefill_seconds]
    prefill_s[0] -= check_s[0]    # the first prefill run held the check
    step_s = [t for e in engines for t in e.step_seconds]
    n_prefills = len(prefill_s)
    require(n_prefills == SERVE_REQUESTS, f"{n_prefills} prefills")
    require(all(len(t) == SERVE_NEW_TOKENS for t in results.values())
            and len(results) == SERVE_REQUESTS,
            f"every request finished with {SERVE_NEW_TOKENS} tokens")
    require(all(0 <= int(x) < cfg.vocab_size for t in results.values()
                for x in t), "tokens within the vocabulary")
    require(launches == {"wan_encode": 0, "wan_decode": 0,
                         "flash_attention": 0,
                         "ssd_scan": cfg.n_layers * n_prefills,
                         "topk_compress": 0},
            f"mamba serving launches {launches}: {cfg.n_layers} SSD "
            f"launches per prefill")
    require(len(checked) == cfg.n_layers,
            f"{len(checked)} prefill layers held to ref.ssd")
    routes = {r: sum(1 for p in placed.values() if p[0] == r)
              for r in SERVE_REGIONS}

    # slot independence, as in phase 5
    region0, local0, prompt0 = placed[0]
    hist = scheds[region0].history
    require(hist[0] == ("prefill", local0, 0), f"request 0 in slot 0: "
            f"{hist[0]}")
    done0 = hist.index(("finish", local0, "max_new"))
    require(any(h[0] == "prefill" for h in hist[1:done0]),
            "a neighbour was inserted while request 0 decoded")
    solo = engine()
    solo.insert(prompt0, SERVE_NEW_TOKENS, rid=0)
    alone = None
    while alone is None:
        for f in solo.step():
            alone = f.tokens
    require(list(alone) == list(results[0]),
            "request 0 alone == request 0 beside inserted neighbours")

    # the reference refuses a prompt above the chunk that is not a
    # multiple of it (ssd_chunked's assert); so does the engine
    uncut = requests[0][0]
    require(uncut.size == 1895, f"uncut prompt 0 has {uncut.size} tokens")
    try:
        solo.insert(uncut, SERVE_NEW_TOKENS, rid=1)
        refused = False
    except ValueError as e:
        refused = "multiple of the chunk" in str(e)
    require(refused and solo.free_slots == list(range(SERVE_SLOTS)),
            "the engine refuses a 1895-token prompt and keeps its slots")

    total_new = sum(len(t) for t in results.values())
    print(f"[mamba] {cfg.name} x{cfg.n_layers} layers, {n_params:,} params, "
          f"{cfg.compute_dtype}; {len(SERVE_REGIONS)} replicas x "
          f"{SERVE_SLOTS} slots, cache_len {cache_len}; routes {routes}")
    worst = {k: max(e[k] for e in checked) for k in checked[0]}
    print(f"[mamba] first prefill's largest |a| (log decay per step): "
          f"{worst.pop('max_abs_a'):.4g}")
    print(f"[mamba] prompt lengths "
          f"{[len(p[2]) for _, p in sorted(placed.items())]}; every "
          f"request finished with {SERVE_NEW_TOKENS} tokens; launches "
          f"{launches}; request 0 alone == beside neighbours; a "
          f"{uncut.size}-token prompt refused")
    print(f"[mamba] first prefill's {len(checked)} SSM layers: kernel "
          f"within {SERVE_SSD_TOL} of ref.ssd and {SSD_Y_TOL} of the f64 "
          f"SSD; worst over layers (of max|y|, max|state|): "
          f"{json.dumps(worst)}")
    print(f"[mamba] prefill s per request {[round(t, 4) for t in prefill_s]}"
          f" (median {statistics.median(prefill_s):.4f}; the first net of its check's {check_s[0]:.4f} s, left out of "
          f"tok/s too), median decode step {statistics.median(step_s):.4f} s over "
          f"{len(step_s)} pool steps, {total_new} tokens in {wall:.2f} s = "
          f"{total_new / wall:.1f} generated tok/s, peak memory "
          f"{peak_gb:.2f} GB")
    return launches, params


def phase_mamba_scoring(torch, params) -> int:
    from repro_torch.configs import mamba2_1_3b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = mamba2_1_3b.CONFIG
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (MAMBA_SCORE_BATCH,
                                               SERVE_PROMPT_LEN),
                           generator=gen, device="cuda", dtype=torch.int32)
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, _ = transformer.forward(params, cfg, tokens,
                                        use_ssm_kernel=True)
        torch.cuda.synchronize()
        kern_s = time.perf_counter() - t0
        launches = ops.LAUNCHES["ssd_scan"]
        t0 = time.perf_counter()
        plain, _ = transformer.forward(params, cfg, tokens)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    require(launches == cfg.n_layers,
            f"{launches} SSD launches in the scoring forward")
    V = cfg.vocab_size
    logits, plain = logits[..., :V], plain[..., :V]
    require(bool(torch.isfinite(logits).all()), "finite logits")
    scale = float(plain.abs().max())
    err = float((logits - plain).abs().max()) / scale
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"[score] {cfg.name} forward B {MAMBA_SCORE_BATCH} S "
          f"{SERVE_PROMPT_LEN}: {launches} SSD launches; {kern_s:.4f} s "
          f"through the kernel, {plain_s:.4f} s through the plain SSD; "
          f"max |logit diff| / max|logit| {err:.3g}, argmax agreement "
          f"{agree:.4f}")
    require(err <= MAMBA_LOGIT_TOL, f"scoring logits within "
            f"{MAMBA_LOGIT_TOL} of the plain SSD's (got {err:.3g})")
    return launches


def phase_mamba_entry_point(torch) -> None:
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = serve.main(["--arch", "mamba2-1.3b", "--replicas", "2",
                              "--requests", "6"])
    text = buf.getvalue()
    print(text, end="")
    summary, _ = json.JSONDecoder().raw_decode(text[text.index("{"):])
    require(summary["device"] == "cuda" and summary["arch"] == "mamba2-1.3b",
            "mamba serve launcher ran on the card")
    require(len(results) == 6 and sum(summary["routes"].values()) == 6,
            "6 mamba requests served and routed")


# phases 6a-6e: the MoE, hybrid and encoder-decoder families
MOE_SERVE_PROMPTS = (2048, 1536, 1024, 512)
MOE_NEW_TOKENS = 16
MOE_POOL = 16                       # the colliding pool of phase 6a
MOE_POOL_PROMPT, MOE_POOL_NEW = 64, 8
KIMI_NEW_TOKENS = 8
JAMBA_PROMPTS = (2048, 1024)        # multiples of the 256-token SSD chunk
JAMBA_D_FF = 8192                   # cut from 24576 to fit one card
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 4, 32, 32
# the reference's whisper decode-vs-forward tolerance
# (tests/test_models.py::test_whisper_decode_matches_forward), in f32
WHISPER_STEP_ATOL, WHISPER_STEP_RTOL = 2e-3, 2e-2
MOE_TRAIN_STEPS = 8
VL_BATCH, VL_PROMPT, VL_NEW_TOKENS = 2, 2048, 16
VL_PATCH_SCALE = 0.02
VL_GRID_W = 16                      # 256 patches on a 16 x 16 grid
VL_TRAIN_SEQ, VL_TRAIN_STEPS = 1024, 4
# the most layers at which the "none" arm peaks under VL_PEAK_GB
# (tools/remat_depth.py on the card)
VL_TRAIN_LAYERS = 19
VL_PEAK_GB = 75.0
# if recompute is not bit-equal on the card, the largest relative gap held
VL_REMAT_RTOL = 1e-6
# M-RoPE on the card against the CPU: each side's f32 cos and sin, one
# bf16 rounding of the rotation, so at most about one bf16 ulp apart
MROPE_TOL = 1e-2


def flash_hook_all(torch, checked: list):
    """A flash check hook holding every launch to ``ref.sdpa`` on the same
    q, k, v; the plain version launches no kernel of the port, and the
    counts are put back as they were all the same."""
    from repro_torch.kernels import ops, ref

    def hook(q, k, v, out, *, causal, window, softcap):
        counts = dict(ops.LAUNCHES)
        expect = ref.sdpa(q, k, v, causal=causal, window=window,
                          softcap=softcap)
        checked.append(flash_close(torch, out, expect,
                                   f"launch {len(checked)} "
                                   f"{tuple(q.shape)}/{k.shape[2]}"))
        ops.LAUNCHES.update(counts)
    return hook


def only(launches: dict, **want) -> dict:
    """The five kernels' counts with ``want`` and zeros elsewhere."""
    return {k: want.get(k, 0) for k in launches}


def serve_pool(engine, prompts, new_tokens) -> dict:
    """Every prompt through a ``ContinuousScheduler`` over ``engine``;
    returns rid -> tokens."""
    from repro_torch.serving.engine import ContinuousScheduler

    sched = ContinuousScheduler(engine)
    for p in prompts:
        sched.submit(p, new_tokens)
    return sched.run()


def moe_time_split(torch, run) -> dict:
    """Device time of one ``run()`` (a prefill) and of its MoE layers, by
    CUDA events around every ``moe_apply`` and, inside it, the router and
    the expert products; dispatch and combine are the rest of the layer."""
    from repro_torch.models import moe, transformer

    spans = {"moe": [], "router": [], "experts": []}

    def timed(name, fn):
        def wrapped(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans[name].append((a, b))
            return out
        return wrapped

    saved = (transformer.M.moe_apply, moe._route, moe._experts)
    transformer.M.moe_apply = timed("moe", moe.moe_apply)
    moe._route = timed("router", moe._route)
    moe._experts = timed("experts", moe._experts)
    try:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
    finally:
        transformer.M.moe_apply, moe._route, moe._experts = saved
    ms = {k: sum(x.elapsed_time(y) for x, y in v) for k, v in spans.items()}
    ms["dispatch_combine"] = ms["moe"] - ms["router"] - ms["experts"]
    ms["total"] = a.elapsed_time(b)
    return ms


def phase_qwen3_moe(torch) -> dict:
    """Phase 6a: qwen3-moe-30b-a3b at its published size (48 layers, 128
    experts top-8, 30.5 B parameters, bf16, random weights from a seed,
    ``attention_impl="pallas"``) through a 4-slot ``ContinuousEngine``:
    prompts of 2048, 1536, 1024 and 512 tokens, 16 new tokens each; every
    flash launch held to ``ref.sdpa``.  Then a 16-slot pool of the same
    model at 1 layer with a zero router (every slot ties and picks experts
    0-7): each slot is routed alone, so the pool's tokens equal each
    request's alone in the pool, while the 16 tokens routed together
    overflow their experts."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import qwen3_moe_30b_a3b
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.serving.engine import ContinuousEngine

    cfg = qwen3_moe_30b_a3b.CONFIG.replace(attention_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count(), f"{n_params} params")
    weights_gb = sum(x.numel() * x.element_size()
                     for x in T.leaves(params)) / 1e9
    with torch.no_grad():
        transformer.prefill(params, cfg, torch.zeros(
            1, 64, dtype=torch.int32, device="cuda"), 96)
    torch.cuda.synchronize()

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in MOE_SERVE_PROMPTS]
    cache_len = max(MOE_SERVE_PROMPTS) + 32
    engine = ContinuousEngine(None, params, n_slots=SERVE_SLOTS,
                              cache_len=cache_len, cfg=cfg,
                              module="transformer")
    checked, check_s = [], [0.0] * len(prompts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.FLASH_CHECK_HOOK = clocked(torch, flash_hook_all(torch, checked),
                                   check_s,
                                   lambda: len(engine.prefill_seconds))
    ops.reset_launches()
    results = serve_pool(engine, prompts, MOE_NEW_TOKENS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    ops.FLASH_CHECK_HOOK = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_prefills = len(engine.prefill_seconds)
    require(n_prefills == len(prompts), f"{n_prefills} prefills")
    require(launches == only(launches,
                             flash_attention=cfg.n_layers * n_prefills),
            f"qwen3-moe launches {launches}: {cfg.n_layers} flash launches "
            f"per prefill")
    require(len(checked) == cfg.n_layers * n_prefills,
            f"{len(checked)} flash launches held to ref.sdpa")
    require(sorted(results) == list(range(len(prompts)))
            and all(len(t) == MOE_NEW_TOKENS
                    and all(0 <= int(x) < cfg.vocab_size for x in t)
                    for t in results.values()),
            f"every request finished with {MOE_NEW_TOKENS} tokens in the "
            f"vocabulary")
    # the prefills are net of their checks: each check is fenced and timed
    prefill_s = [t - c for t, c in zip(engine.prefill_seconds, check_s)]
    step_s = statistics.median(engine.step_seconds)

    # the MoE layers' share of one 2048-token prefill's device time, and
    # the flash kernel's time at the prefill's shape (off the record)
    tok = torch.from_numpy(prompts[0])[None].cuda()
    with torch.no_grad():
        split = moe_time_split(torch, lambda: transformer.prefill(
            params, cfg, tok, cache_len))
    q = torch.randn(1, MOE_SERVE_PROMPTS[0], cfg.n_heads,
                    cfg.resolved_head_dim, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn(1, MOE_SERVE_PROMPTS[0], cfg.n_kv_heads,
                        cfg.resolved_head_dim, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    flash_ms = time_ms(torch, lambda: ops.flash_attention(q, k, v), reps=20)
    n_steps = len(engine.step_seconds)
    del q, k, v, engine
    print(f"[qwen3-moe] {cfg.name} x{cfg.n_layers} layers, {n_params:,} "
          f"params ({weights_gb:.2f} GB bf16), {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.top_k}, heads {cfg.n_heads}/{cfg.n_kv_heads}; init "
          f"{init_s:.1f} s, init peak {init_peak:.2f} GB")
    print(f"[qwen3-moe] prompts {list(MOE_SERVE_PROMPTS)}, "
          f"{MOE_NEW_TOKENS} new each through a {SERVE_SLOTS}-slot pool: "
          f"launches {launches}; all {len(checked)} flash launches within "
          f"{FLASH_TOL['torch.bfloat16']} + {FLASH_TOL['torch.bfloat16']}"
          f"|ref| of ref.sdpa (max |err| {max(checked):.3g})")
    print(f"[qwen3-moe] prefill s {[round(t, 4) for t in prefill_s]} (net "
          f"of the checks, {[round(t, 4) for t in check_s]} s), median decode "
          f"step {step_s:.4f} s over {n_steps} steps; peak memory "
          f"{peak_gb:.2f} GB")
    print(f"[qwen3-moe] a {MOE_SERVE_PROMPTS[0]}-token prefill by CUDA "
          f"events: {split['total']:.2f} ms, MoE layers {split['moe']:.2f} "
          f"ms = {split['moe'] / split['total']:.1%} (router "
          f"{split['router']:.2f}, expert products {split['experts']:.2f}, "
          f"dispatch and combine {split['dispatch_combine']:.2f} ms); flash "
          f"{flash_ms:.4f} ms a launch at (1, {MOE_SERVE_PROMPTS[0]}, "
          f"{cfg.n_heads}, {cfg.n_kv_heads}, {cfg.resolved_head_dim}), "
          f"{flash_ms * cfg.n_layers:.2f} ms a prefill")

    # the colliding pool: layer 0 of the same weights, a zero router
    cfg1 = cfg.replace(n_layers=1)
    blocks = T.tree_map(lambda x: x[:1], params["blocks"])
    blocks["pos0"]["moe"]["router"] = torch.zeros_like(
        blocks["pos0"]["moe"]["router"])
    params1 = {"embed": params["embed"], "blocks": blocks,
               "final_norm": params["final_norm"]}
    pool_prompts = [rng.integers(0, cfg.vocab_size, MOE_POOL_PROMPT + i
                                 ).astype(np.int32) for i in range(MOE_POOL)]
    pool_len = MOE_POOL_PROMPT + MOE_POOL + MOE_POOL_NEW

    def pool():
        return ContinuousEngine(None, params1, n_slots=MOE_POOL,
                                cache_len=pool_len, cfg=cfg1,
                                module="transformer")

    crowd = pool()
    for rid, p in enumerate(pool_prompts):
        crowd.insert(p, MOE_POOL_NEW, rid=rid)
    together = {}
    while crowd.live_slots:
        for f in crowd.step():
            together[f.rid] = list(f.tokens)
    alone = {}
    for rid, p in enumerate(pool_prompts):
        solo = pool()
        solo.insert(p, MOE_POOL_NEW, rid=rid)
        while solo.live_slots:
            for f in solo.step():
                alone[f.rid] = list(f.tokens)
    require(together == alone, "a 16-slot pool's tokens == each request "
            "alone in the pool (every slot routed on its own)")
    C16 = moe.expert_capacity(MOE_POOL, cfg1)
    cache = transformer.init_cache(cfg1, MOE_POOL, pool_len, device="cuda")
    tok = torch.tensor([[int(p[0])] for p in pool_prompts],
                       dtype=torch.int32, device="cuda")
    with torch.no_grad():
        rows, _ = transformer.decode_step(
            params1, cfg1, tok, T.tree_map(torch.clone, cache), 0,
            moe_per_row=True)
        shared, _ = transformer.decode_step(
            params1, cfg1, tok, T.tree_map(torch.clone, cache), 0)
    gap = (rows - shared).abs().amax(dim=(1, 2))
    require(C16 < MOE_POOL and bool((gap[C16:] > 0).all()),
            f"routed together, slots {C16}.. overflow experts 0-7 "
            f"(capacity {C16})")
    print(f"[qwen3-moe] 16-slot pool at 1 layer, zero router (every slot "
          f"ties: experts 0-7): tokens == each request alone in the pool "
          f"(16 runs); the 16 tokens routed together get a capacity of "
          f"{C16} per expert and slots {C16}-15 lose their experts (max "
          f"|logit diff| {float(gap[C16:].min()):.3g}-"
          f"{float(gap[C16:].max()):.3g})")
    del params, params1, blocks, crowd, cache
    torch.cuda.empty_cache()
    return launches


def phase_kimi_k2(torch) -> dict:
    """Phase 6b: kimi-k2 at full width, 1 of 61 layers (d_model 7168, 64/8
    heads, 384 experts top-8 at capacity factor 1.0, vocab 163,840; bf16,
    random weights from a seed, ``attention_impl="pallas"``): one 2048-token
    prefill and 8 decode steps; prints the (token, expert) assignments the
    prefill's capacity dropped."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import kimi_k2_1t_a32b
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.serving.engine import ContinuousEngine

    cfg = kimi_k2_1t_a32b.CONFIG.replace(n_layers=1, attention_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count(), f"{n_params} params")
    weights_gb = sum(x.numel() * x.element_size()
                     for x in T.leaves(params)) / 1e9
    with torch.no_grad():
        transformer.prefill(params, cfg, torch.zeros(
            1, 64, dtype=torch.int32, device="cuda"), 96)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, SERVE_PROMPT_LEN).astype(np.int32)
    engine = ContinuousEngine(None, params, n_slots=1,
                              cache_len=SERVE_PROMPT_LEN + KIMI_NEW_TOKENS,
                              cfg=cfg, module="transformer")
    drops = []
    count_slots = moe._capacity_slots

    def counted(top_e, C, E):
        slot = count_slots(top_e, C, E)
        if top_e.shape[1] > 1:                       # the prefill's layer
            drops.append((int((slot == E * C).sum()), slot.numel(),
                          int((slot == E * C).all(-1).sum()), C))
        return slot

    checked, check_s = [], [0.0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moe._capacity_slots = counted
    ops.FLASH_CHECK_HOOK = clocked(torch, flash_hook_all(torch, checked),
                                   check_s)
    ops.reset_launches()
    try:
        tokens = serve_pool(engine, [prompt], KIMI_NEW_TOKENS)[0]
        torch.cuda.synchronize()
    finally:
        moe._capacity_slots = count_slots
        ops.FLASH_CHECK_HOOK = None
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(launches == only(launches, flash_attention=1),
            f"kimi-k2 launches {launches}: one flash launch")
    require(len(checked) == 1, "the flash launch held to ref.sdpa")
    require(len(tokens) == KIMI_NEW_TOKENS
            and all(0 <= int(t) < cfg.vocab_size for t in tokens),
            "tokens within the vocabulary")
    (dropped, slots, lost, C), = drops
    prefill_s = engine.prefill_seconds[0] - check_s[0]
    step_s = statistics.median(engine.step_seconds)
    print(f"[kimi-k2] {cfg.name} x1 of 61 layers, {n_params:,} params "
          f"({weights_gb:.2f} GB bf16), d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.top_k}, capacity factor {cfg.moe.capacity_factor}; "
          f"init peak {init_peak:.2f} GB")
    print(f"[kimi-k2] prefill {SERVE_PROMPT_LEN} tokens, "
          f"{KIMI_NEW_TOKENS} new: launches {launches}, flash within "
          f"{FLASH_TOL['torch.bfloat16']} of ref.sdpa (max |err| "
          f"{checked[0]:.3g}); capacity {C} per expert: {dropped} of {slots} "
          f"(token, expert) assignments dropped ({dropped / slots:.2%}), "
          f"{lost} tokens lost all {cfg.moe.top_k}")
    print(f"[kimi-k2] prefill {prefill_s:.4f} s (net of its check), median "
          f"decode step {step_s:.4f} s over {len(engine.step_seconds)} "
          f"steps; peak memory {peak_gb:.2f} GB")
    del params, engine
    torch.cuda.empty_cache()
    return launches


def phase_jamba(torch) -> dict:
    """Phase 6c: jamba-1.5-large at one period (8 layers: 7 Mamba, 1
    attention; MoE 16 experts top-2 on 4; d_model 8192, 64/8 heads, 256 SSM
    heads of P 64, N 128 in 8 B/C groups, chunk 256, vocab 65,536) with d_ff
    cut from 24,576 to 8,192 to fit one card; bf16, random weights from a
    seed, ``attention_impl="pallas"``.  Two requests of 2048 and 1024
    tokens, 16 new each, through a 2-slot ``ContinuousEngine``: 7 SSD and 1
    flash launch a prefill, every one held to its plain version."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import jamba_1_5_large_398b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ContinuousEngine

    cfg = jamba_1_5_large_398b.CONFIG.replace(
        n_layers=8, d_ff=JAMBA_D_FF, attention_impl="pallas")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count(), f"{n_params} params")
    weights_gb = sum(x.numel() * x.element_size()
                     for x in T.leaves(params)) / 1e9
    with torch.no_grad():
        transformer.prefill(params, cfg, torch.zeros(
            1, MAMBA_CHUNK, dtype=torch.int32, device="cuda"), 300)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in JAMBA_PROMPTS]
    engine = ContinuousEngine(None, params, n_slots=len(JAMBA_PROMPTS),
                              cache_len=max(JAMBA_PROMPTS) + 32, cfg=cfg,
                              module="transformer")
    G, H, N = cfg.ssm.n_groups, cfg.ssm_heads, cfg.ssm.state_dim
    flash_checked, ssd_checked, groups = [], [], []
    check_s = [0.0] * len(prompts)

    def at():
        return len(engine.prefill_seconds)


    def ssd_hook(x, a, Bm, Cm, y, final, *, chunk, init_state):
        counts = dict(ops.LAUNCHES)
        # B and C reach the kernel expanded from G groups to H heads
        g = Bm.reshape(*Bm.shape[:2], G, H // G, N)
        groups.append(bool((g == g[:, :, :, :1]).all())
                      and Bm.shape[2] == H)
        ssd_checked.append(ssd_serving_close(
            torch, x, a, Bm, Cm, y, final, chunk, init_state,
            f"jamba SSD launch {len(ssd_checked)}"))
        ops.LAUNCHES.update(counts)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.FLASH_CHECK_HOOK = clocked(
        torch, flash_hook_all(torch, flash_checked), check_s, at)
    ops.SSD_CHECK_HOOK = clocked(torch, ssd_hook, check_s, at)
    ops.reset_launches()
    try:
        results = serve_pool(engine, prompts, MOE_NEW_TOKENS)
        torch.cuda.synchronize()
    finally:
        ops.FLASH_CHECK_HOOK = ops.SSD_CHECK_HOOK = None
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_ssm = sum(1 for s in cfg.pattern if s.kind == "ssm")
    n_attn = len(cfg.pattern) - n_ssm
    n = len(prompts)
    require(launches == only(launches, flash_attention=n_attn * n,
                             ssd_scan=n_ssm * n),
            f"jamba launches {launches}: {n_ssm} SSD and {n_attn} flash "
            f"launches a prefill")
    require(len(ssd_checked) == n_ssm * n and len(flash_checked) == n_attn * n
            and all(groups), "every SSD and flash launch held, B/C expanded "
            f"from {G} groups")
    require(sorted(results) == list(range(n))
            and all(len(t) == MOE_NEW_TOKENS
                    and all(0 <= int(x) < cfg.vocab_size for x in t)
                    for t in results.values()),
            f"both requests finished with {MOE_NEW_TOKENS} tokens")
    # the B/C copy: each SSM layer expands (1, S, G, N) to (1, S, H, N),
    # for B and for C, in bf16
    copy_mb = {S: 2 * S * H * N * 2 / 1e6 for S in JAMBA_PROMPTS}
    grouped_mb = {S: 2 * S * G * N * 2 / 1e6 for S in JAMBA_PROMPTS}
    prefill_s = [t - c for t, c in zip(engine.prefill_seconds, check_s)]
    step_s = statistics.median(engine.step_seconds)
    worst = {k: max(e[k] for e in ssd_checked) for k in ssd_checked[0]}
    n_steps = len(engine.step_seconds)
    del engine

    # the SSD kernel and the B/C copy at the 2048-token prefill's shape,
    # and the flash kernel at its attention layer's (off the record)
    S0, P, L = JAMBA_PROMPTS[0], cfg.ssm.head_dim, cfg.ssm.chunk_size
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(1, S0, H, P, generator=gen, device="cuda")
    a = -torch.rand(1, S0, H, generator=gen, device="cuda")
    Bg, Cg = (torch.randn(1, S0, G, N, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    Bm, Cm = (t.repeat_interleave(H // G, dim=2) for t in (Bg, Cg))
    ssd_ms = time_ms(torch, lambda: ops.ssd_scan(x, a, Bm, Cm, chunk=L),
                     reps=20)
    copy_ms = time_ms(torch, lambda: (Bg.repeat_interleave(H // G, dim=2),
                                      Cg.repeat_interleave(H // G, dim=2)),
                      reps=20)
    # inputs read once (B and C as the kernel reads them: expanded), the
    # outputs written once
    nbytes = (x.numel() * 4 + a.numel() * 4 + 2 * Bm.numel() * 2
              + x.numel() * 4 + H * P * N * 4)
    bound, by = ssd_bound(1, S0, H, P, N, L, nbytes, bc_bf16=True)
    q = torch.randn(1, S0, cfg.n_heads, cfg.resolved_head_dim,
                    device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn(1, S0, cfg.n_kv_heads, cfg.resolved_head_dim,
                        device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    flash_ms = time_ms(torch, lambda: ops.flash_attention(q, k, v), reps=20)
    del x, a, Bg, Cg, Bm, Cm, q, k, v
    print(f"[jamba] {cfg.name} x{cfg.n_layers} layers (one period: "
          f"{n_ssm} Mamba, {n_attn} attention, MoE {cfg.moe.num_experts} "
          f"experts top-{cfg.moe.top_k} on 4), d_ff {cfg.d_ff} (published "
          f"24576), {n_params:,} params ({weights_gb:.2f} GB bf16); SSM "
          f"heads {H} of P {cfg.ssm.head_dim}, N {N}, {G} B/C groups, chunk "
          f"{cfg.ssm.chunk_size}")
    print(f"[jamba] prompts {list(JAMBA_PROMPTS)}, {MOE_NEW_TOKENS} new: "
          f"launches {launches}; every SSD launch at G {G} within "
          f"{SERVE_SSD_TOL} of ref.ssd and {SSD_Y_TOL} of the f64 SSD "
          f"(worst {json.dumps(worst)}); the flash launches within "
          f"{FLASH_TOL['torch.bfloat16']} of ref.sdpa (max |err| "
          f"{max(flash_checked):.3g})")
    print(f"[jamba] B/C expanded by group before the kernel: "
          f"{ {S: round(mb, 1) for S, mb in copy_mb.items()} } MB a layer "
          f"(against { {S: round(mb, 1) for S, mb in grouped_mb.items()} } "
          f"MB grouped), x{n_ssm} a prefill; the copy {copy_ms:.4f} ms a "
          f"layer at {S0} tokens")
    print(f"[jamba] at {S0} tokens: the SSD {ssd_ms:.4f} ms a launch (bound "
          f"{bound:.4f} ms by {by}, B/C read expanded), flash "
          f"{flash_ms:.4f} ms at (1, {S0}, {cfg.n_heads}, {cfg.n_kv_heads}, "
          f"{cfg.resolved_head_dim})")
    print(f"[jamba] prefill s {[round(t, 4) for t in prefill_s]} (net of "
          f"the checks), median decode step {step_s:.4f} s over "
          f"{n_steps} steps; peak memory {peak_gb:.2f} GB")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_whisper(torch) -> dict:
    """Phase 6d: whisper-tiny whole (4 encoder and 4 decoder layers,
    d_model 384, 6 heads, vocab 51,865; bf16, random weights from a seed,
    ``attention_impl="pallas"``): the encoder over (4, 1500, 384) stub frame
    embeddings drawn from a seed (4 flash launches, non-causal, each held to
    ``ref.sdpa``), then ``ServingEngine.generate`` with the encoder output as
    ``audio_emb`` (the reference's engine takes it as the encoder output):
    32-token prompts teacher-forced, 32 new tokens.  The same model in f32
    then holds its decode to its forward at the reference's tolerance."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    from repro_torch.serving.engine import ServingEngine

    arch = get_arch("whisper-tiny")
    cfg = arch.config.replace(attention_impl="pallas")
    arch = type(arch)(name=arch.name, config=cfg, smoke=arch.smoke,
                      module=arch.module)
    params = encdec.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == encdec.param_count(cfg), f"{n_params} params")
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy(rng.normal(size=(
        WHISPER_BATCH, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
        * 0.1).cuda()
    prompt = rng.integers(0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT)
                          ).astype(np.int32)
    engine = ServingEngine(arch, params,
                           cache_len=WHISPER_PROMPT + WHISPER_NEW)
    with torch.no_grad():
        encdec.encode(params, cfg, audio[:1, :64])
    checked, check_s = [], [0.0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.FLASH_CHECK_HOOK = clocked(torch, flash_hook_all(torch, checked),
                                   check_s)
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = encdec.encode(params, cfg, audio)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0 - check_s[0]
    ops.FLASH_CHECK_HOOK = None
    t0 = time.perf_counter()
    res = engine.generate(prompt, WHISPER_NEW, audio_emb=enc)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(launches == only(launches, flash_attention=cfg.encoder_layers),
            f"whisper launches {launches}: {cfg.encoder_layers} flash "
            f"launches in the encoder")
    require(len(checked) == cfg.encoder_layers,
            "the encoder's flash launches held to ref.sdpa")
    require(res.tokens.shape == (WHISPER_BATCH, WHISPER_NEW)
            and bool(((res.tokens >= 0)
                      & (res.tokens < cfg.vocab_size)).all()),
            f"{WHISPER_BATCH} x {WHISPER_NEW} tokens within the vocabulary")

    # the same weights in f32: teacher-forced decode == forward at the
    # reference's tolerance, the encoder through the f32 flash kernel
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = T.tree_map(lambda x: x.float(), params)
    toks = torch.from_numpy(prompt[:1]).cuda()
    with torch.no_grad():
        full, _ = encdec.forward(p32, cfg32, toks, audio[:1])
        cache = encdec.init_cache(cfg32, 1, WHISPER_PROMPT,
                                  enc=encdec.encode(p32, cfg32, audio[:1]),
                                  params=p32)
        worst = 0.0
        for t in range(WHISPER_PROMPT):
            step, cache = encdec.decode_step(p32, cfg32, toks[:, t:t + 1],
                                             cache, t)
            diff = (step[:, 0] - full[:, t]).abs()
            bound = WHISPER_STEP_ATOL + WHISPER_STEP_RTOL * full[:, t].abs()
            require(bool((diff <= bound).all()),
                    f"whisper f32 decode step {t} == forward within "
                    f"{WHISPER_STEP_ATOL} + {WHISPER_STEP_RTOL}|ref|")
            worst = max(worst, float(diff.max()))
    n_steps = WHISPER_PROMPT + WHISPER_NEW
    qkv = torch.randn(3, WHISPER_BATCH, cfg.encoder_ctx, cfg.n_heads,
                      cfg.resolved_head_dim, device="cuda",
                      dtype=torch.bfloat16)
    flash_ms = time_ms(torch, lambda: ops.flash_attention(
        *qkv, causal=False), reps=20)
    del qkv
    print(f"[whisper] {cfg.name}: {cfg.encoder_layers} + {cfg.n_layers} "
          f"layers, {n_params:,} params, audio_emb ({WHISPER_BATCH}, "
          f"{cfg.encoder_ctx}, {cfg.d_model}); launches {launches}; the "
          f"encoder's {len(checked)} non-causal flash launches at "
          f"({WHISPER_BATCH}, {cfg.encoder_ctx}, {cfg.n_heads}, "
          f"{cfg.resolved_head_dim}) within {FLASH_TOL['torch.bfloat16']} "
          f"of ref.sdpa (max |err| {max(checked):.3g}), {flash_ms:.4f} ms "
          f"a launch")
    print(f"[whisper] encode {enc_s:.4f} s (net of its check), "
          f"{WHISPER_PROMPT}-token prompts fed and {WHISPER_NEW} tokens "
          f"generated in {gen_s:.4f} s ({n_steps} decode steps, "
          f"{gen_s / n_steps * 1e3:.2f} ms a step); f32 decode == forward "
          f"over {WHISPER_PROMPT} steps (max |diff| {worst:.3g}); peak "
          f"memory {peak_gb:.2f} GB")
    del params, p32, engine, enc, cache
    torch.cuda.empty_cache()
    return launches


def phase_moe_training(torch) -> dict:
    """Phase 6e: qwen3-moe-30b-a3b at full width, 1 layer, through
    ``repro_torch.launch.train`` (``--arch qwen3-moe-30b-a3b`` cut to 1
    layer): 2 pods, global batch 8, seq 512, sgd, ``asgd_ga`` interval 2,
    the int8 codec at top-k 0.05 with error feedback, ``--bucket-policy
    layer-class --bucket-patterns moe-router`` (the routers in their own
    bucket group), 8 steps; every codec round held as phase 3d's are."""
    from repro_torch.configs import qwen3_moe_30b_a3b
    from repro_torch.core import sync as S
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.training.trainer import Trainer

    cfg = qwen3_moe_30b_a3b.CONFIG.replace(n_layers=1)
    round_check, per_tier, checked, mark = bucketed_round_check(torch)
    sizes, steps = {}, []

    def check(state, payloads, shipped, sync):
        layout = S.bucket_layout(sync, state.sync_state.ga_buffer)
        sizes.update(zip(layout.names, layout.sizes))
        round_check(state, payloads, shipped, sync)

    train_step = Trainer.train_step

    def timed_step(self, state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(self, state, batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        return out

    argv = ["--arch", "qwen3-moe-30b-a3b", "--pods", str(PODS), "--steps",
            str(MOE_TRAIN_STEPS), "--batch", "8", "--seq", "512", "--sync",
            "asgd_ga", "--interval", "2", "--optimizer", "sgd",
            "--compress-topk", "0.05", "--int8", "--error-feedback",
            "--bucket-policy", "layer-class", "--bucket-patterns",
            "moe-router", "--log-every", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    mark.update(ops.LAUNCHES)
    buf = io.StringIO()
    Trainer.train_step = timed_step
    try:
        with contextlib.redirect_stdout(buf):
            summary = train.main(argv, model_cfg=cfg, round_hook=check)
    finally:
        Trainer.train_step = train_step
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    text = buf.getvalue()
    lines = text.splitlines()
    print("\n".join(line for line in lines if line.startswith("[train]")))
    losses = [float(line.split("loss ")[1].split()[0]) for line in lines
              if line.startswith("step ")]
    rounds = summary["rounds"]
    require(len(losses) == MOE_TRAIN_STEPS
            and all(math.isfinite(v) for v in losses),
            f"finite losses {losses}")
    # bf16 parameters: MB per pod of each bucket group
    mb = {n: round(v * 2 / 1e6, 3) for n, v in sizes.items()}
    require(sizes.get("moe", 0) > 0 and sizes.get("router", 0) > 0,
            f"moe and router buckets hold parameters: {sizes}")
    require(len(checked) == len(rounds) == MOE_TRAIN_STEPS // 2,
            f"{len(checked)} of {len(rounds)} codec rounds checked")
    total = {k: sum(t[k] for t in per_tier.values())
             for k in ("wan_encode", "wan_decode")}
    require(launches == only(launches, **total),
            f"MoE training launches {launches} == per-round sums {total}")
    print(f"[moe-train] {cfg.name} x1 layer, {PODS} pods, batch 8, seq "
          f"512, asgd_ga@2, int8 top-k 0.05 + EF, buckets {mb} MB: losses "
          f"{[round(v, 4) for v in losses]}; launches {launches}")
    print(f"[moe-train] step s {[round(t, 4) for t in steps]}, round s "
          f"{[round(r[2], 4) for r in rounds]}, per-round worst-pod EF "
          f"ratios by bucket {checked}; peak memory {peak_gb:.2f} GB")
    return {k: launches[k] for k in ("wan_encode", "wan_decode")}


def vl_positions(torch, batch: int, seq: int, n_patches: int):
    """(3, batch, seq) M-RoPE positions in qwen2-vl's scheme: the patches
    at t 0 on a ``VL_GRID_W``-wide (h, w) grid, the text after them counting
    on from the largest patch position on every component."""
    pos = torch.zeros(3, batch, seq, dtype=torch.int32)
    i = torch.arange(n_patches, dtype=torch.int32)
    pos[1, :, :n_patches] = i // VL_GRID_W
    pos[2, :, :n_patches] = i % VL_GRID_W
    start = int(pos[:, :, :n_patches].max()) + 1
    pos[:, :, n_patches:] = start + torch.arange(seq - n_patches,
                                                 dtype=torch.int32)
    return pos


def vl_train_arm(torch, layers: int, remat: str, steps: int) -> dict:
    """qwen2-vl-2b at full width, cut to ``layers``, under ``remat``:
    phase 3's setup (2 pods, global batch 8, sgd, ASGD-GA interval 2, int8
    top-k 0.01 with error feedback) at seq ``VL_TRAIN_SEQ``, each pod's
    rows carrying the same seeded patch embeddings, ``steps`` steps through
    ``Trainer.fit``; every codec round held as phase 3's are.  Returns the
    losses, the step and round times, the peak memory (of the run, and to
    the end of the first step), the launches and the final parameters
    copied to the host."""
    from repro_torch import tree as T
    from repro_torch.configs import qwen2_vl_2b
    from repro_torch.core import sync as S
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_batches
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = qwen2_vl_2b.CONFIG.replace(n_layers=layers, remat=remat)
    sync = S.SyncConfig("asgd_ga", 2, compress_topk=TOPK, quantize_int8=True,
                        error_feedback=True)
    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0) for i in range(PODS))
    plan = build_training_plan(TrainingRequest(
        model=cfg.name, clouds=clouds, sync=sync, n_iters=steps,
        global_batch=8))
    tokens = make_batches(plan, cfg.vocab_size, VL_TRAIN_SEQ, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    patches = VL_PATCH_SCALE * torch.randn(
        PODS, max(plan.batch_split), cfg.vision_patches, cfg.d_model,
        generator=gen, device="cuda")

    def batches(step):
        return {**tokens(step), "patch_emb": patches}

    rounds = []
    trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                      lambda g: transformer.init_params(g, cfg, "cuda"),
                      TrainerConfig(n_pods=PODS, optimizer="sgd", lr=0.02,
                                    sync=sync),
                      device="cuda", round_hook=codec_round_check(torch,
                                                                  rounds))
    state = trainer.init_state(SEED)
    leaves = T.leaves(state.params)
    n_params = sum(x.numel() for x in leaves) // PODS
    model_mb = sum(x.numel() * x.element_size() for x in leaves) / PODS / 1e6
    # the peak up to the end of the first step, before any sync round:
    # the state plus one step's activations and gradients
    first_peak = []
    train_step = trainer.train_step

    def step_and_peak(state, batch):
        out = train_step(state, batch)
        if not first_peak:
            torch.cuda.synchronize()
            first_peak.append(torch.cuda.max_memory_allocated() / 1e9)
        return out

    trainer.train_step = step_and_peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, hist = trainer.fit(state, batches, steps, model_mb=model_mb)
    torch.cuda.synchronize()
    out = {"layers": layers, "n_params": n_params,
           "losses": hist["loss_per_pod"],
           "launches": dict(ops.LAUNCHES),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "step_peak_gb": first_peak[0],
           "step_s": list(trainer.step_seconds),
           "sync_s": list(trainer.sync_seconds), "rounds": rounds,
           "params": [x.cpu() for x in T.leaves(state.params)]}
    del trainer, state, leaves, patches
    torch.cuda.empty_cache()
    return out


def phase_qwen2_vl(torch) -> dict:
    """Phase 6f: qwen2-vl-2b at its published size (28 layers, d_model
    1536, 12 heads over 2 KV heads of 128, M-RoPE sections (16, 24, 24),
    vocab 151,936 padded to 153,600, untied; bf16, random weights from a
    seed, ``attention_impl="pallas"``).  (a) ``ServingEngine.generate`` at
    B 2 over a 2048-token prompt with seeded patch embeddings over the
    first 256 positions, 16 new tokens: 28 flash launches in the prefill,
    each held to ``ref.sdpa`` on the same M-RoPE-rotated q, k, v; layer 0's
    M-RoPE on the card held to the CPU's on the same q; the first 256
    embeddings equal to the cast patches; the last-token logits moved by
    them.  (b) A 4-slot ``ContinuousEngine`` behind one replica: 8 requests
    drawn as the serving launcher draws them at ``--prompt-len 2048``, 16
    new each, decoded at ``(3, B, 1)`` positions; request 0 alone in a
    fresh pool gives the same tokens; then ``launch.serve.main --arch
    qwen2-vl-2b``.  (c) Training at full width, ``VL_TRAIN_LAYERS`` layers,
    under ``remat`` "none", "full" and "dots": equal losses and final
    parameters (bit for bit, else within ``VL_REMAT_RTOL``), each arm's
    peak memory, step times and launches."""
    import dataclasses

    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.serve import route_and_submit
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.serving.engine import (ContinuousEngine,
                                            ContinuousScheduler,
                                            ServingEngine)
    from repro_torch.serving.router import GeoRouter, ReplicaSpec

    t_phase = time.perf_counter()
    arch = get_arch("qwen2-vl-2b")
    cfg = arch.config.replace(attention_impl="pallas")
    arch = dataclasses.replace(arch, config=cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = transformer.init_params(gen, cfg, "cuda")
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count() == 1_782_142_464,
            f"{n_params} params")
    weights_gb = sum(x.numel() * x.element_size()
                     for x in T.leaves(params)) / 1e9
    cache_len = VL_PROMPT + 32
    with torch.no_grad():                  # warm cuBLAS and the kernel
        transformer.prefill(params, cfg, torch.zeros(
            1, 64, dtype=torch.int32, device="cuda"), 96)
    torch.cuda.synchronize()

    # ----------------------------------------- (a) the batched engine
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab_size, (VL_BATCH, VL_PROMPT)
                          ).astype(np.int32)
    patches = VL_PATCH_SCALE * torch.randn(
        VL_BATCH, cfg.vision_patches, cfg.d_model, generator=gen,
        device="cuda")
    engine = ServingEngine(arch, params, cache_len=cache_len)
    checked, check_s = [], [0.0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.FLASH_CHECK_HOOK = clocked(torch, flash_hook_all(torch, checked),
                                   check_s)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = engine.generate(prompt, VL_NEW_TOKENS, patch_emb=patches)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0 - check_s[0]
    batch_launches = dict(ops.LAUNCHES)
    ops.FLASH_CHECK_HOOK = None
    batch_peak = torch.cuda.max_memory_allocated() / 1e9
    require(batch_launches == only(batch_launches,
                                   flash_attention=cfg.n_layers),
            f"qwen2-vl generate launches {batch_launches}: {cfg.n_layers} "
            f"flash launches in the prefill")
    require(len(checked) == cfg.n_layers,
            f"{len(checked)} flash launches held to ref.sdpa")
    require(res.tokens.shape == (VL_BATCH, VL_NEW_TOKENS)
            and bool(((res.tokens >= 0)
                      & (res.tokens < cfg.vocab_size)).all()),
            f"{VL_NEW_TOKENS} tokens a row in the vocabulary")

    tok = torch.from_numpy(prompt).to("cuda")
    with torch.no_grad():
        emb = transformer._embed(params, cfg, tok, patches)
        require(torch.equal(emb[:, :cfg.vision_patches],
                            patches.to(emb.dtype)),
                "embeddings 0-255 == the patches cast to bf16")
        p0 = T.tree_map(lambda x: x[0], params["blocks"]["pos0"])
        hn = L.rmsnorm(p0["ln1"], emb, cfg.norm_eps)
        q = (hn @ p0["attn"]["wq"]).reshape(
            VL_BATCH, VL_PROMPT, cfg.n_heads, cfg.resolved_head_dim)
        gaps = {}
        for name, pos in (("default", transformer._positions_for(
                cfg, tok, None).cpu()),
                ("vision grid", vl_positions(torch, VL_BATCH, VL_PROMPT,
                                             cfg.vision_patches))):
            got = L.apply_mrope(q, pos.to("cuda"), cfg.rope_theta,
                                cfg.mrope_sections).cpu().float()
            want = L.apply_mrope(q.cpu(), pos, cfg.rope_theta,
                                 cfg.mrope_sections).float()
            diff = (got - want).abs()
            require(bool((diff <= MROPE_TOL + MROPE_TOL * want.abs()).all()),
                    f"layer 0 M-RoPE ({name} positions) on the card within "
                    f"{MROPE_TOL} of the CPU's (max |diff| "
                    f"{float(diff.max()):.3g})")
            gaps[name] = float(diff.max())
        with_pe, _ = engine.prefill(prompt, patch_emb=patches)
        without, _ = engine.prefill(prompt)
        moved = float((with_pe - without).abs().max())
    require(moved > 0, "the patches move the last-token logits")
    del emb, p0, hn, q, with_pe, without, engine   # p0: views of params
    print(f"[qwen2-vl] {cfg.name} x{cfg.n_layers} layers, {n_params:,} "
          f"params ({weights_gb:.2f} GB bf16), heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} x {cfg.resolved_head_dim}, M-RoPE "
          f"{cfg.mrope_sections}, {cfg.vision_patches} vision placeholders")
    print(f"[qwen2-vl] generate B {VL_BATCH} x {VL_PROMPT} with patch "
          f"embeddings, {VL_NEW_TOKENS} new: launches {batch_launches}; all "
          f"{len(checked)} flash launches within "
          f"{FLASH_TOL['torch.bfloat16']} of ref.sdpa (max |err| "
          f"{max(checked):.3g}); {gen_s:.3f} s net of the checks "
          f"({check_s[0]:.3f} s); peak {batch_peak:.2f} GB")
    print(f"[qwen2-vl] layer 0 M-RoPE on the card vs the CPU, max |diff| "
          f"{gaps}; embeddings 0-{cfg.vision_patches - 1} == the cast "
          f"patches; the patches move the last-token logits by up to "
          f"{moved:.3g}")

    # ------------------------------------------------ (b) the slot pool
    region = SERVE_REGIONS[0]
    pool = ContinuousEngine(None, params, n_slots=SERVE_SLOTS,
                            cache_len=cache_len, cfg=cfg,
                            module="transformer")
    sched = ContinuousScheduler(pool)
    router = GeoRouter([ReplicaSpec(region=region, n_slots=SERVE_SLOTS)],
                       mode="balanced")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    placed = route_and_submit(router, {region: sched}, (region,),
                              SERVE_REQUESTS, VL_PROMPT, VL_NEW_TOKENS,
                              cfg.vocab_size, seed=0)
    results = sched.run()
    torch.cuda.synchronize()
    pool_launches = dict(ops.LAUNCHES)
    pool_peak = torch.cuda.max_memory_allocated() / 1e9
    n_prefills = len(pool.prefill_seconds)
    require(n_prefills == SERVE_REQUESTS, f"{n_prefills} prefills")
    require(pool_launches == only(pool_launches, flash_attention=cfg.n_layers
                                  * n_prefills),
            f"qwen2-vl pool launches {pool_launches}")
    require(sorted(results) == list(range(SERVE_REQUESTS))
            and all(len(t) == VL_NEW_TOKENS
                    and all(0 <= int(x) < cfg.vocab_size for x in t)
                    for t in results.values()),
            f"every request finished with {VL_NEW_TOKENS} tokens")
    solo = ContinuousEngine(None, params, n_slots=SERVE_SLOTS,
                            cache_len=cache_len, cfg=cfg,
                            module="transformer")
    alone = serve_pool(solo, [placed[0][2]], VL_NEW_TOKENS)[0]
    require(list(alone) == list(results[placed[0][1]]),
            "request 0 alone == request 0 beside its neighbours")
    print(f"[qwen2-vl] pool of {SERVE_SLOTS} slots, cache_len {cache_len}: "
          f"prompts {[len(p[2]) for _, p in sorted(placed.items())]}, "
          f"{VL_NEW_TOKENS} new each at (3, B, 1) positions; launches "
          f"{pool_launches}; request 0 alone == beside its neighbours")
    print(f"[qwen2-vl] prefill s {[round(t, 4) for t in pool.prefill_seconds]}"
          f" (median {statistics.median(pool.prefill_seconds):.4f}), median "
          f"decode step {statistics.median(pool.step_seconds):.4f} s over "
          f"{len(pool.step_seconds)} steps; peak {pool_peak:.2f} GB")
    del params, pool, solo, sched
    torch.cuda.empty_cache()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        served = serve.main(["--arch", "qwen2-vl-2b", "--smoke", "--replicas",
                             "2", "--requests", "6"])
    summary, _ = json.JSONDecoder().raw_decode(
        buf.getvalue()[buf.getvalue().index("{"):])
    require(summary["device"] == "cuda" and summary["arch"] == "qwen2-vl-2b"
            and len(served) == 6, f"serve launcher: {summary}")
    print(f"[qwen2-vl] launch.serve --arch qwen2-vl-2b --smoke: "
          f"{summary['requests']} requests, {summary['new_tokens']} tokens, "
          f"routes {summary['routes']}")

    # ------------------------------------------- (c) training and remat
    arms = {r: vl_train_arm(torch, VL_TRAIN_LAYERS, r, VL_TRAIN_STEPS)
            for r in ("none", "full", "dots")}
    base = arms["none"]
    require(base["peak_gb"] < VL_PEAK_GB,
            f"the 'none' arm peaks under {VL_PEAK_GB} GB: "
            f"{base['peak_gb']:.2f}")
    for r, arm in arms.items():
        require(all(math.isfinite(v) for row in arm["losses"] for v in row),
                f"{r}: finite losses {arm['losses']}")
        require(len(arm["rounds"]) == VL_TRAIN_STEPS // 2,
                f"{r}: {len(arm['rounds'])} codec rounds checked")
        require(arm["launches"] == only(arm["launches"], wan_encode=2,
                                        wan_decode=4),
                f"{r}: launches {arm['launches']}")
    gaps = {}
    for r in ("full", "dots"):
        arm = arms[r]
        equal = arm["losses"] == base["losses"] and all(
            torch.equal(a, b) for a, b in zip(arm["params"],
                                               base["params"]))
        gap = 0.0 if equal else max(
            float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-30)
            for a, b in zip(arm["params"], base["params"]))
        loss_gap = max(abs(x - y) / abs(y) for ra, rb in zip(
            arm["losses"], base["losses"]) for x, y in zip(ra, rb))
        require(equal or max(gap, loss_gap) <= VL_REMAT_RTOL,
                f"remat {r}: losses and parameters == 'none' (largest "
                f"relative gap {max(gap, loss_gap):.3g})")
        gaps[r] = "bit-equal" if equal else f"{max(gap, loss_gap):.3g}"
    print(f"[qwen2-vl] training {base['layers']} of 28 layers (the most "
          f"whose 'none' arm peaks under {VL_PEAK_GB:.0f} GB: "
          f"tools/remat_depth.py), {base['n_params']:,} params/pod, {PODS} "
          f"pods, batch 8, seq {VL_TRAIN_SEQ}, patch embeddings, asgd_ga@2, "
          f"int8 top-k {TOPK} + EF, {VL_TRAIN_STEPS} steps; losses "
          f"{[[round(v, 4) for v in row] for row in base['losses']]}; "
          f"against 'none': {gaps}")
    for r, arm in arms.items():
        print(f"[qwen2-vl] remat {r}: peak {arm['peak_gb']:.2f} GB (to the "
              f"end of the first step, before any round: "
              f"{arm['step_peak_gb']:.2f} GB), step s "
              f"{[round(t, 4) for t in arm['step_s']]}, sync-round s "
              f"{[round(t, 4) for t in arm['sync_s']]}, launches "
              f"{arm['launches']}")
    print(f"[qwen2-vl] phase 6f {time.perf_counter() - t_phase:.1f} s")
    launches = {k: batch_launches[k] + pool_launches[k]
                + sum(a["launches"][k] for a in arms.values())
                for k in batch_launches}
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    t_run = time.perf_counter()
    device = phase_device(torch)
    kernels = phase_kernels(torch)
    kernels.update(phase_flash(torch))
    kernels.update(phase_ssd(torch))
    torch.cuda.empty_cache()
    kernels.update(phase_topk(torch))
    torch.cuda.empty_cache()
    train_launches = phase_main_path(torch)
    torch.cuda.empty_cache()
    control_launches = phase_control_loop(torch)
    torch.cuda.empty_cache()
    transport_launches = phase_transport(torch)
    torch.cuda.empty_cache()
    fault_launches = phase_faults(torch)
    torch.cuda.empty_cache()
    stream_launches = phase_streaming(torch)
    torch.cuda.empty_cache()
    snap_launches = phase_snapshots(torch)
    torch.cuda.empty_cache()
    topk_launches = phase_strategies(torch)
    torch.cuda.empty_cache()
    mesh_launches = phase_mesh(torch)
    torch.cuda.empty_cache()
    pod_launches = phase_pod_procs(torch)
    torch.cuda.empty_cache()
    elastic_launches = phase_elastic(torch)
    torch.cuda.empty_cache()
    phase_paper_models(torch)
    phase_entry_point(torch)
    phase_entry_point_ama(torch)
    torch.cuda.empty_cache()
    serve_launches = phase_serving(torch)
    torch.cuda.empty_cache()
    phase_serve_entry_point(torch)
    gemma_launches = phase_gemma3_prefill(torch)
    torch.cuda.empty_cache()
    mamba_launches, params = phase_mamba_serving(torch)
    phase_mamba_scoring(torch, params)
    del params
    torch.cuda.empty_cache()
    phase_mamba_entry_point(torch)
    family_launches = [phase_qwen3_moe(torch), phase_kimi_k2(torch),
                       phase_jamba(torch), phase_whisper(torch)]
    torch.cuda.empty_cache()
    moe_train_launches = phase_moe_training(torch)
    torch.cuda.empty_cache()
    vl_launches = phase_qwen2_vl(torch)
    torch.cuda.empty_cache()
    phase_dryrun(torch)
    for name in ("wan_encode", "wan_decode"):
        kernels[name]["launches"] = (train_launches[name]
                                     + control_launches[name]
                                     + transport_launches[name]
                                     + fault_launches[name]
                                     + stream_launches[name]
                                     + snap_launches[name]
                                     + moe_train_launches[name]
                                     + vl_launches[name]
                                     + mesh_launches[name]
                                     + pod_launches[name]
                                     + elastic_launches[name])
    kernels["flash_attention"]["launches"] = (
        serve_launches["flash_attention"]
        + gemma_launches["flash_attention"]
        + sum(f["flash_attention"] for f in family_launches)
        + vl_launches["flash_attention"])
    kernels["ssd_scan"]["launches"] = (
        mamba_launches["ssd_scan"]
        + sum(f["ssd_scan"] for f in family_launches))
    kernels["topk_compress"]["launches"] = (topk_launches
                                            + mesh_launches["topk_compress"])
    print(f"[chip_smoke] whole run {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

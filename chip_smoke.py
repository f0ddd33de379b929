#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together) and print the build time
   and what ptxas reports (registers, spills, wgmma serialisation); print
   each K3 kernel's registers and shared memory (``cuobjdump -res-usage``
   and the launch's dynamic shared memory) and count its HGMMA (wgmma)
   and UTMALDG (TMA load) instructions in the library's SASS (``cuobjdump
   -sass``): every kernel of ``flash_attention.cu`` (WGMMA_KERNELS: the
   bf16 forward, dq and dk/dv at D = 32, 64 and 128, the bf16 dq and
   dk/dv at D = 16) must hold both, and ptxas's spills of each are
   printed; count by pipe the
   instructions K1 and K2 issue per (row, coordinate) term at r = 5, in
   the SASS block that holds the most sign hashes, beside what a term
   needs (SIGN_HASH, K1's index step, K2's share of its median network
   MEDIAN_NETS); K2 must call no subroutine and issue fewer than
   K2_BUBBLE_SASS_PER_TERM a term; print the registers, spills, HMMA
   mnemonics, asynchronous copies and most issued opcodes of
   ``flash_tiled.cu``'s float32 kernels and bf16 D = 16 forward
   (``phase_tiled_sass``): each float32 kernel's SASS must hold HMMA on
   TF32 operands (TF32_KERNELS), the bf16 forward's LDGSTS or UTMALDG
   (ASYNC_KERNELS);
2. hold K1 (circulant encode) and K2 (circulant decode) against their
   plain PyTorch versions on the card at the ResNet-9 shapes
   (d = 6,568,640, c = 500,736, r = 5; seeded inputs; shifts from
   ``make_circulant_sketch``), at the unaligned c = 500,000, and at the
   GPT-2 shape (d = 92,138,496, c = 524,288, r = 5, m = 176), the
   FEMNIST ResNet101LN shape (d = 43,124,350, c = 500,736, m = 87) and
   the ImageNet FixupResNet50 shape (d = 25,504,026, m = 51), bitwise
   (int32 views, ``same_bits``), fresh and accumulating, K2 also on a
   table with zeroed cells, -0 and NaN (``zeroed_table``); time kernel
   and plain version with CUDA events (median of 25 after warm-up)
   beside each kernel's bound, the largest of its bytes, float
   operations and the instructions a term needs (``bound``) over the
   card's rates, and print two measured floors of the L2 read rate
   outside the bound: a PyTorch reduction's (``l2_read_rate``) and that
   of the kernels' own r gathers; K1/K2 also at the StreamMLP shape (d =
   102,830,080, m = 197); K1's range form (``phase_kernels_range``) at
   the GPT-2 and StreamMLP shapes, bitwise its plain version, fresh and
   accumulating, over ``range_cases`` (on a block boundary, straddling
   one, inside one, ending at d, one value, the whole vector, which must
   also give the whole-vector call's bits), the weight-sized (4,194,304)
   and bias-sized (2,048) ranges timed beside their bounds; K2's range
   form (``phase_decode_range``) at m = 14 and 176 over 4 and 8 equal
   shards of d_pad, the shards bitwise the whole decode and their plain
   version, +0.0 past d, a shard timed beside its bound
   (``range_decode_work``); then the split round (``phase_decode_overlap``:
   ``--decode_overlap`` against the monolithic round through the entry
   point at the headline, interleaved, bitwise over ROUNDS_SPLIT rounds
   with 9 K1 + 1 K2 a round, the driver waiting on the cohort's event
   alone; the host syncs left in each half; the GPT-2 sweep's overlap
   arms beside its base arm) and a 1-rank NCCL mesh (``phase_mesh1``:
   the replicated tail, the sharded tail and the reduce in the decode
   bitwise each other and the no-mesh round, K2's range form once a
   sharded round; the int8 wire's sharded round, monolithic and split,
   bitwise each other; every arm's first round under the collectives
   ledger, within the JAX launch bounds with no table-reduce wire bytes
   on one rank; ``--checkpoint_sharded`` written and read back, the next
   round bitwise; the group torn down in a ``finally``); then ring
   attention in one process (``phase_ring``: all shards on the card at
   GPT-2 small's width, (8, 1024) over 4 shards and (4, 4096) over 8,
   output and gradients against dense float32 attention and against
   K3, each row within RING_ROW_RTOL, timed beside K3 and SDPA),
   ``scaling_curves``' n = 1 arms on the card (``phase_scaling``), the
   flags lifted on a mesh through the entry points on a 1-rank NCCL
   mesh (``phase_mesh_entry``: ``--wire_dtype int8 --checkpoint_sharded
   --alert_action abort``, a resume bitwise the straight run; ``gpt2_train
   --mesh_axes clients,seq``) and ``multihost_dryrun`` on the machine's
   CPU (``phase_multihost``; in the whole run it runs beside K1 and K2's
   phases, whose times are device times). ``python3 chip_smoke.py
   --mesh`` runs the build and the mesh phases alone, ``--ring`` the
   build and the ring (no result line);
3. hold K3 (causal flash attention: forward, dq, dk/dv) against its plain
   versions at (N, S, H, D) = (8, 1024, 12, 64), (8, 256, 12, 64), (8,
   2048, 12, 64), (4, 4096, 12, 64), (16, 256, 12, 64) and (16, 1024,
   12, 64) (``FLASH_SHAPES``: the main path's and the bench paths'), q,
   k, v the slices of one c_attn-shaped buffer, each output row against
   its own norm (FLASH_ROW_RTOL), and show that this check rejects a
   planted fault in each kernel (one tile of its walk skipped), and that
   two calls of each kernel give bitwise-equal outputs, and that the
   autograd function's backward (on autograd's own thread, the process's
   first backward) gives the direct calls' bits; time
   the kernels, the plain versions and ``scaled_dot_product_attention``
   (forward, backward and both) beside each kernel's bound; then every
   other route (``phase_flash_routes``: float32 at D = 16, 32, 64, 128,
   ``flash_tiled.cu``'s; bf16 at 16, 32, 128, ``flash_attention.cu``'s
   but the D = 16 forward) against
   its plain version at (8, 1024 and 256, 768 / D, D), two calls
   bitwise, the check rejecting a forward that skips one key tile
   (``planted_drops``) and, for the ``flash_attention.cu`` backward, a
   dq and a dk/dv that each skip one tile, each kernel timed beside its
   bound (float32 at the 3xTF32 rate, the FFMA rate's bound printed
   beside it) and SDPA, whose kernels are named (``sdpa_kernels``), and
   the routes' GPT-2 paths (``phase_gpt2_routes``; the bf16 D = 16, 32
   and 128 forms at GPT-2 small's depth, 12 layers, ``model_route_steps``).
   ``python3 chip_smoke.py --slice19`` runs the build, these and the
   split round's decode half alone, ``--slice21`` the build,
   ``phase_sass``, ``phase_tiled_sass`` and these alone (no result
   line);
4. small-input checks: three rounds of a narrow ResNet-9 on the card
   (float32, TF32 off) against the same rounds on the CPU, whose wrappers
   take the plain versions, on the float32 and on the int8 wire; a narrow GPT-2 (2 layers, width 128, 2 heads
   of 64, S = 128, bf16, K3 on the card, full-length random tokens) on
   the card against the CPU: one client's c_attn q/k/v gradient and three
   rounds, within NARROW_LIMITS, and the same runs with a planted fault
   in each K3 kernel outside them; one sketch round of each CV model
   family at a narrow or shallow form (FixupResNet9, ResNet18 and
   FixupResNet18 at one block a stage, FixupResNet50 at (1, 1, 1, 1),
   the torchvision ResNet with BasicBlock and grouped Bottleneck under
   the batch and the layer norm) on the card against the CPU, float32
   with TF32 off, within ZOO_LOSS_RTOL, ZOO_UPDATE_RTOL and ZOO_SWAPS;
5. the card's top-k (``topk_with_idx`` and the row-wise ``topk``) on
   vectors with +-NaN, +-inf, +-0 and ties against a plain ranking of
   the card's own squares (it prints which NaN (-NaN)^2 gives), timed at
   d = 6,568,640 and 92,138,496 with k = 50,000 beside ``torch.topk`` of
   the float32 squares; the device time of the byte accounting at both
   d; the sparse re-encode of 50,000 values on the card bitwise equal to
   the CPU's, at both sketches;
6. the ResNet-9 main path: ``commefficient_torch.cv_train`` at full width
   (8 clients x 64 synthetic CIFAR10 images, prepared in a temporary
   directory and served by the device store, k = 50,000, r = 5,
   c = 500,000 -> 500,736, bf16 compute), every launch count set to 0
   just before and read just after; requires 9 encode and 1 decode launch
   per round and finite losses; prints the median round time (of the
   rounds after the first), img/s and peak memory; then the same with
   ``--no_track_bytes``; then each of ``WIRE_ARMS`` (``phase_wire``:
   ``--wire_dtype bfloat16``, ``--sketch_dtype bfloat16``, ``--wire_dtype
   int8`` twice, with ``--max_grad_norm 1`` and with the hash sketch), 3
   rounds each, exact K1/K2 launches, every round's bytes a client held
   to the arm's (5,007,360 bf16, 2,542,800 int8) and to
   ``upload_wire_bytes``, the alias's warning and bits equal to the bf16
   arm's, the two int8 runs bitwise equal;
7. ``cv_train`` in every mode of the single-device round
   (``MODE_CONFIGS``: uncompressed, true_topk, local_topk with local
   error and momentum rows, fedavg with whole-client batches, sketch
   subtract with 16-image microbatches, the unfused sketch) at full
   width, 100 clients of 64 images, 3 rounds: finite losses, exact K1/K2
   launches a round, every round's upload bytes 4 x upload_floats and
   its download counts equal to a plain recount on the card
   (``RoundRecorder``); then a planted NaN in the main path's second
   round must set ``nan_round`` to 1 and stop the driver at that epoch's
   end without validating it;
   then the hash sketch and the SRHT on the card (``phase_hash_rht``):
   the hash encode at ResNet-9's shape against the same call on the CPU
   (HASH_ENCODE_RTOL), its decode (a table with zeroed cells, -0 and
   NaN) and sparse re-encode bitwise equal to the CPU's, the SRHT's round
   trip at c = d' = 2^23 within RHT_ROUND_TRIP_ATOL with TF32 switched on
   around it, and the rht path's encode against the CPU's; DP noise
   measured in a round (``phase_noise``: uncompressed ResNet-9 with
   ``--dp``, worker and server; the update's difference from a
   noise-free run over the rate has standard deviation 0.1 within
   NOISE_STD_RTOL, and a repeated round draws the same noise); then
   ``cv_train`` in each of ``RULE_CONFIGS`` (the table clip, the dense
   clip, the dense server state, DP worker and server, ``--topk_down``,
   the hash sketch with the zero rule and with the dense state, the SRHT
   at r c = d) at the same widths, 3 rounds each, exact K1/K2 launches a
   round, as the JAX package routes them under its default telemetry (8
   + 1 for the table clip, whose per-client gradient statistics take it
   off the fused encode; 16 + 1 for the table clip under
   ``--no_client_stats``, the fused per-client route; 1 + 1 for
   ``--topk_down``, the dense clip, DP and the dense state, none for
   hash, rht and the uncompressed DP run) and the bytes held as in the
   modes; then the
   SRHT's row scan (``phase_rht_scan``): one ResNet-9 round with
   ``--sketch_scan_rows 1`` against ``0``, the update within
   RHT_SCAN_RTOL, and GPT2_RHT_ARMS at GPT-2's width (the automatic scan
   at d' = 2^27, ``--sketch_scan_rows 0``, ``--sketch_dtype bfloat16``),
   3 rounds each, no K1/K2, median and peak memory, the scan's peak below
   the batched form's;
8. real-format data, checkpoints and resume (``phase_real_data_resume``):
   a full-scale ``cifar-10-batches-py`` (50,000 train and 10,000 test
   images of ``synthetic_cifar``) is written to a temporary directory;
   ``cv_train`` runs the main path's flags from it for two epochs with
   ``--checkpoint_every 1``: every round from the device store (its MiB
   printed), exactly 9 K1 and 1 K2 launches a round, the store's host
   time a round against the host gather's; a flipped byte in the newest
   generation, then ``--resume`` in a fresh call: the restore must fall
   back to the first generation and name the damaged one, the restored
   state must be bitwise the saved one, the first resumed round's batch
   bitwise the uninterrupted run's and its loss within
   RESUME_LOSS_RTOL;
9. the GPT-2 main path: ``commefficient_torch.gpt2_train`` at GPT-2
   small's width (8 clients x 4 dialogues x 2 candidates x 1024 tokens,
   k = 50,000, r = 5, c = 524,288, bf16, K3), every launch count set to
   0 just before; each round is an epoch and ends in a validation;
   requires per round exactly 9 K1, 1 K2, 96 K3 forward, 96 dq and 96
   dk/dv launches, 12 K3 forward launches and nothing else in each
   validation batch (each counted around its own call, ``LaunchSplit``),
   no launch outside them, and finite losses; prints the median round
   time (of the rounds after the first), tokens/s, the analytic model
   TFLOP/s and its share of 989 TFLOP/s, and peak memory; then the same
   with ``--no_track_bytes``; then the GPT-2 main path's state saved and
   loaded once at full width (time, size, bitwise on the card); then two
   arms of the JAX package's GPT-2 study at the main path's k
   (``GPT2_ARMS``: the table clip ``--max_grad_norm 1``, 8 K1 a round,
   and ``densestate_clip1``, 1 K1), 3 rounds each, with the same launch
   checks; then ``--wire_dtype int8`` (3 rounds, 9 K1 + 1 K2 a round,
   2,662,400 bytes a client a round); then GPT-2's memory levers
   (``phase_gpt2_levers``): the base arm and ``GPT2_LEVER_ARMS`` (``--lm_chunk 128``, ``--remat``,
   ``--remat --remat_policy dots_with_no_batch_dims_saveable``, ``--remat
   --lm_chunk 128``), 3 rounds each, exact launches (192 K3 forward a
   round under ``--remat``), each arm's median round and peak memory
   beside the base arm's, and its first round's loss and weights against
   the base arm's (bit for bit under remat alone, LEVER_LIMITS with the
   chunked loss); then the pretrained path (``phase_gpt2_pretrained``):
   an HF ``pytorch_model.bin`` at GPT-2 small's width written from a
   seed, one round with ``--model_checkpoint DIR --checkpoint --iid
   --num_clients 16`` (initial weights bit for bit ``load_state_dict`` of
   the file, ``load_pretrained`` of the saved directory bit for bit the
   final weights), a second round that reads the PersonaChat packs the
   first wrote (no pack counted), and the K3 forward of the loaded
   DoubleHeads model and of a ``GPT2LMHead`` against dense attention
   (PRETRAINED_FLASH_RTOL);
10. the FEMNIST FetchSGD round (``phase_femnist``): a LEAF FEMNIST
   directory of 3,500 writers (16 train and 1 test image each, the real
   json schema over 4 files a split) is written and prepared, both
   times printed; ``cv_train --dataset_name EMNIST --model ResNet101LN
   --mode sketch`` at full width (d = 43,124,350, m = 87, 8 writers of
   16 a round, k = 50,000, r = 5, c = 500,736) from the device store, 3
   rounds and a validation, every launch count set to 0 just before:
   exactly 9 K1 and 1 K2 a round; then BASELINE config 3
   (``phase_fixup``): ``cv_train --dataset_name CIFAR100 --model
   FixupResNet50 --mode true_topk``, 100 synthetic clients, 8 a round, 3
   rounds, with Fixup's (d,) rate vector (its share of 0.1 entries
   printed), the first round's update held bit for bit to the rate
   vector times the server rule's update at rate 1; then the round input
   pipeline on these two store paths and the main path's
   (``phase_pipeline_ab``: the driver's loop in four runs, inline,
   threaded, threaded, inline; the round and the wall a round of each);
11. the ImageNet recipe (``phase_imagenet``): ``cv_train --dataset_name
   ImageNet --model FixupResNet50`` with ``scripts/imagenet.sh``'s flags
   (``--mesh_shape ""``, 7 iid clients of 64) on a synthetic ImageNet at
   224 x 224 (8 classes x 64, the device store), 3 rounds uncompressed
   and 3 of the sketch form (d = 25,504,026, m = 51: exactly 8 K1 and 1
   K2 a round, K1/K2 also bitwise at this shape in phase 2), each with
   its median round, img/s, the analytic model FLOPs' share of 989
   TFLOP/s, peak memory and the Fixup multiplier's share, then one
   ``profile_round`` call of the sketch round for the device's idle
   share; the host path (``phase_imagenet_host``: 8 classes x 2,000, 2.41
   GB, over the store's 2 GiB) inline and pipelined, the batches bitwise
   equal round by round and the losses within HOST_LOSS_RTOL, the fetch,
   the wait and the round of both; the native CIFAR host gather against
   its numpy twin and across thread counts (``phase_native``); the
   finetune two-step (``phase_finetune``: FixupResNet50 on CIFAR100 with
   ``--checkpoint``, then its head alone on CIFAR10, the backbone bitwise
   the saved one); the reference API (``phase_compat``: ``FedModel``'s
   ResNet-9 sketch round on the card with the driver's 9 K1 and 1 K2 a
   step);
12. the streaming encode (``phase_stream``): ``FedRuntime`` on a
   StreamMLP (L = 24, H = 2,048, d_in = 1,024, d = 102,830,080), r = 5,
   c = 524,288, 8 clients x 32, 3 rounds, with the loss's
   ``streaming_grad`` and without: exact launches (50 K1 ranges a
   microbatch with the hook), the first round's losses equal and its
   updates within STREAM_UPDATE_RTOL, the client step's peak above its
   resident memory under d 4 bytes with the hook, at least d 4 without;
13. the runtime services at the main path's widths over 100 clients of
   64 images (``run_services``): ``phase_robust`` runs the plain sketch
   round and ``ROBUST_ARMS`` (``--defense normclip``, ``trim``,
   ``--adversary signflip`` with normclip, ``--adversary nan`` with
   ``--nonfinite_action quarantine``), SERVICE_ROUNDS rounds each through
   ``cv_train``: 9 K1 + 1 K2 a plain round, exactly 1 + 1 a robust one,
   finite losses, every round's defense scalars, each arm's median and
   peak beside the plain round's, the quarantine ledger equal to the CPU
   run's of the same seeds, and each arm's first round at full width
   held to the CPU's (ROBUST_* limits); ``phase_async``: ``--async_agg
   --max_inflight 1 --buffer_goal 1`` bitwise the plain rounds (weights,
   losses, launches), then ASYNC_STRAGGLERS for ASYNC_TICKS ticks and
   the flush (9 K1 a computed cohort, 1 K2 a commit, staleness, tick and
   commit medians); ``phase_preempt``: ``--watchdog`` bitwise the plain
   rounds, and one epoch in child processes: a SIGTERM drain at round 3,
   a kill inside the next checkpoint write, a resume that falls back to
   the preempt generation and ends bitwise at the uninterrupted epoch's
   weights. The services' streams (``--telemetry_every 1``): a
   ``defense`` event every round of each robust arm, an ``async_round``
   event a commit, and the children's one stream of three segments, each
   ``resume`` naming the one before, with the drain's ``fault`` event.
   ``python3 chip_smoke.py --services`` runs the build and these three
   phases alone (no result line);
14. the run telemetry (``phase_telemetry``): the ResNet-9 main path
   through ``cv_train``, ROUNDS rounds, four runs interleaved (default
   with ``--telemetry_every 1``, ``--no_telemetry``, default,
   ``--no_telemetry``): 9 K1 + 1 K2 a round in each, the round-1 weights
   bitwise equal in both arms, both arms' medians printed with the
   card's name and power limit; the default stream validated (manifest
   first with the card and ``cuda``, summary last, one ``round``,
   ``signals``, ``layer_signals`` and ``client_stats`` event a round,
   ``device_wait`` spans, ``utilization``, memory events with live, peak
   and limit bytes, null ``grad_true_norm`` and ``grad_mass`` on the fused
   route, the layer counts summing to the support) and its measured
   round_step ledger against d x 4 bytes; round 1's signals, layer
   signals and client quantiles of phase_small_reference's narrow
   ResNet-9, card against CPU (TEL_SIGNAL_RTOL, TEL_SWAPS);
   ``--signals_exact`` (1 K1 + 1 K2 a round, topk_overlap in [0, 1]);
   ``--profile_dir`` (a chrome trace of rounds 2:4, its kernels counted);
   GPT-2 at full width with and without ``--signal_groups off`` (layer
   signals over its 39 coarse groups: each block's attn, mlp and
   norm-bias, embed, the final norm and the head; the MFU
   against the 989 TFLOP/s entry, the two peaks side by side, their
   difference under d x 4 bytes). Every entry-point call of every phase
   writes its stream under the run's data root (``entry_main``,
   ``--logdir``); the port's ``check_telemetry_schema`` and ``teleview
   summarize`` on the default arm's stream, in process (``phase_readers``:
   both exit 0, the summary names ``cv_train`` and the card).
   ``python3 chip_smoke.py --telemetry`` runs the build and this phase
   alone (no result line);
15. the benchmark entry points (``phase_bench``): ``python -m
   commefficient_torch.bench.bench --telemetry_dir D`` in a subprocess
   (rc 0, bench.py's keys at each depth, no ``error``, value > 0 and mfu
   in (0, 1] in the headline, the saturated point and GPT-2, the bytes a
   round exact, the stream's three ``bench`` and ``utilization`` events
   and its summary); then in process, every count set to 0 just before
   and each round between two syncs: ``run_cifar`` on the float32 and
   int8 wires (9 K1 + 1 K2 in every warmup and timed round),
   ``round_shape_grid`` at its 9 cells (W + 1 K1 a round),
   ``gpt2_mfu_sweep`` with SWEEP_ARMS (SWEEP_K1 + 1 K2 a round; the
   ``overlap`` arm's client halves SWEEP_K1 + 0), ``ledger_ab`` at full
   width,
   ``bench_imagenet`` in both layouts, ``bench_gpt2_model`` and
   ``bench_longctx`` (exact K3 launches a step); at each shape these two
   give K3, the first-step loss and c_attn gradient with K3 against
   dense attention, and with a planted fault in each K3 kernel, which
   must fail (BENCH_ATTN_LIMITS); one ``[bench]`` line with the card's
   name and power limit. K1/K2 at the GPT-2 bench's full vocabulary
   (d = 124,444,416, m = 238) run in phase 2 and K3 at the bench paths'
   shapes in phase 3. ``bench_imagenet_model`` at batch 64
   (``phase_bench_model``: its line and top-25 table, every value finite
   and > 0). ``python3 chip_smoke.py --bench`` runs the build, those
   kernel checks and this phase alone (no result line);
16. the crash harness and the study recipes: ``crash_matrix``'s
   ``mid_round`` and ``async_pool`` rows with children on the card
   (``phase_crash``: killed, resumed, bit for bit the straight child,
   whose launches are exactly CRASH_W K1 + 1 K2 a round), and one epoch
   of each CIFAR10 curve arm, of the GPT-2 sketch arm and of its two
   clip placements at seed 21 (``phase_curves``: the TSV header, the
   upload MiB equal to the TPU log's, each arm's K1, K2 and cell sums a
   round, ``CURVE_LAUNCHES``: 9 K1 + 1 K2 a ResNet-9 sketch round, 8 + 1
   a GPT-2 one and under its table clip, 1 + 1 under its dense clip).
   The smoke also runs the first epoch of two EF arms
   (CURVE_EF_SMOKE_ARMS: 9 rows, and the subtract rule up to its abort;
   2 cell sums a round). ``python3 chip_smoke.py --crash`` runs the build
   and all six crash rows, ``--curves [ARM,...|ef|all [SEED,...
   [OUT]]]`` a learning-curve study (default: the EF study's 15 arms at
   seeds 21-23) into OUT (default CURVES_OUT), CURVE_PROCS runs on the
   card at once after the parent has written their shared data: each
   run's record checked the same way, what differs printed rather than
   fatal, then each arm's band verdict (no result line);
17. print the ``{"kernels": [...]}`` line (K1's range launches and
   range timings in its entry; K2's range form an entry of its own,
   ``circ_decode_range``), the card's name and power limit, and last
   the ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device it fails at once.
"""

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12         # FP32 outside the tensor cores
H100_BF16_PER_S = 989e12        # dense bf16 tensor cores
H100_TF32_PER_S = 495e12        # dense TF32 tensor cores
# the operations a bound names, by the peak they are held to; a float32
# product in 3xTF32 is three TF32 products, so those bounds count 3 x FLOPs
PEAK_KINDS = {H100_FP32_PER_S: "fp32", H100_BF16_PER_S: "bf16",
              H100_TF32_PER_S: "3xTF32"}
H100_SMS = 132
# the clock that gives the data sheet's 67 TFLOP/s float32 (128 lanes an
# SM, 2 operations an FMA): 67e12 / (132 x 256) = 1.98 GHz
H100_CLOCK_HZ = H100_FP32_PER_S / (H100_SMS * 256)
# thread instructions an SM a clock (CUDA C Programming Guide, throughput
# of arithmetic instructions, compute capability 9.0; pipes as Nsight
# Compute names them): the ALU pipe (integer add, logic, shift, compare,
# select) 64, the FMA pipe's integer half (IMAD, IMUL) 64, and the four
# schedulers issue 128 of any kind
LANES = {"alu": 64, "imad": 64, "issue": 128}
# What one (row, coordinate) term of K1 and K2 needs, as the instructions
# the card issues for it: the sign hash, bit 31 of fmix32(x key +
# 0x9E3779B9) (the finalizer's last h ^= h >> 16 cannot reach bit 31),
# then the sign applied to the value by one xor. Each entry is (operation,
# operand, pipe); "either" runs as an IMAD or as an IADD3 on the ALU (x key
# + C is the previous coordinate's plus key). ``sign_hash`` evaluates this
# list, and the tests hold it to the port's sign stream.
SIGN_HASH = (("mad", 0x9E3779B9, "either"), ("shr", 16, "alu"),
             ("xor", None, "alu"), ("mul", 0x85EBCA6B, "imad"),
             ("shr", 13, "alu"), ("xor", None, "alu"),
             ("mul", 0xC2B2AE35, "imad"), ("sign", None, "alu"))
# besides the hash, a term of K1 needs one index step (an add, either
# pipe); K2 reads its r cells of a tile through row pointers and needs none
INDEX_STEP = "either"
# K2's median of the r signed estimates of a coordinate, as min/max
# operations: ("min" or "max", a, b) appends min or max of values a and b
# to the values 0 .. r - 1 (the estimates); the median is the last value
# for odd r, the mean of the last two for even r (the two middle values,
# in either order). Each min and max returns a NaN operand and orders -0
# below +0, as jnp.minimum / jnp.maximum do: one FMNMX on the card's ALU
# pipe. ``median_net`` evaluates a network; the tests hold each, bit for
# bit, to the JAX package's median_axis0, show that none of its operations
# can go, and that csrc/circulant.cu MedianNet holds the same lists.
MEDIAN_NETS = {
    1: (),
    2: (),
    3: (("min", 0, 1), ("max", 0, 1), ("min", 4, 2), ("max", 3, 5)),
    4: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("max", 4, 6), ("min", 5, 7)),
    5: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("max", 5, 7), ("min", 6, 8), ("min", 4, 9), ("max", 4, 9),
        ("min", 12, 10), ("max", 11, 13)),
    6: (("min", 1, 4), ("max", 1, 4), ("min", 0, 2), ("max", 0, 2),
        ("min", 9, 5), ("max", 9, 5), ("min", 8, 3), ("max", 8, 3),
        ("min", 10, 7), ("max", 10, 7), ("max", 12, 6), ("min", 16, 13),
        ("max", 16, 13), ("min", 18, 11), ("max", 17, 14),
        ("min", 19, 15)),
    7: (("min", 2, 6), ("max", 2, 6), ("min", 0, 7), ("max", 0, 7),
        ("min", 10, 5), ("max", 10, 5), ("min", 1, 8), ("max", 1, 8),
        ("min", 12, 14), ("min", 13, 4), ("max", 13, 4), ("min", 3, 17),
        ("max", 3, 17), ("min", 19, 15), ("max", 9, 18), ("max", 16, 11),
        ("min", 22, 21), ("max", 22, 21), ("min", 24, 20),
        ("max", 23, 25)),
    8: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("min", 4, 5), ("max", 4, 5), ("min", 6, 7), ("max", 6, 7),
        ("min", 8, 10), ("max", 8, 10), ("min", 9, 11), ("max", 9, 11),
        ("min", 12, 14), ("max", 12, 14), ("min", 13, 15), ("max", 13, 15),
        ("min", 18, 17), ("max", 18, 17), ("min", 22, 21), ("max", 22, 21),
        ("max", 16, 20), ("max", 24, 26), ("min", 25, 27), ("min", 19, 23),
        ("min", 31, 29), ("max", 30, 28)),
    # r = 9 to 16: Batcher's odd-even merge sort on r wires, less every
    # operation no median output reads and every one whose value could be
    # either operand's on all 0/1 columns (csrc/circulant.cu MedianNet)
    9: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("min", 4, 5), ("max", 4, 5), ("min", 6, 7), ("max", 6, 7),
        ("min", 9, 11), ("max", 9, 11), ("min", 10, 12), ("max", 10, 12),
        ("min", 13, 15), ("max", 13, 15), ("min", 14, 16), ("max", 14, 16),
        ("min", 19, 18), ("max", 19, 18), ("min", 23, 22), ("max", 23, 22),
        ("max", 17, 21), ("max", 25, 27), ("min", 26, 28), ("min", 20, 24),
        ("max", 31, 29), ("min", 32, 30), ("min", 34, 33), ("max", 34, 33),
        ("min", 36, 8), ("max", 35, 37)),
    10: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("min", 4, 5), ("max", 4, 5), ("min", 6, 7), ("max", 6, 7),
        ("min", 8, 9), ("max", 8, 9), ("min", 10, 12), ("max", 10, 12),
        ("min", 11, 13), ("max", 11, 13), ("min", 14, 16), ("max", 14, 16),
        ("min", 15, 17), ("max", 15, 17), ("min", 22, 21), ("max", 22, 21),
        ("min", 26, 25), ("max", 26, 25), ("max", 20, 24), ("min", 28, 30),
        ("max", 28, 30), ("min", 29, 31), ("max", 29, 31), ("min", 23, 27),
        ("min", 35, 32), ("max", 35, 32), ("min", 37, 34), ("max", 37, 34),
        ("min", 40, 39), ("max", 40, 39), ("min", 41, 36), ("max", 33, 19),
        ("min", 43, 18), ("max", 43, 18), ("min", 44, 45), ("max", 38, 46),
        ("min", 42, 48), ("max", 42, 48), ("max", 50, 49), ("min", 51, 47)),
    11: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("min", 4, 5), ("max", 4, 5), ("min", 6, 7), ("max", 6, 7),
        ("min", 8, 9), ("max", 8, 9), ("min", 11, 13), ("max", 11, 13),
        ("min", 12, 14), ("max", 12, 14), ("min", 15, 17), ("max", 15, 17),
        ("min", 16, 18), ("max", 16, 18), ("min", 19, 10), ("max", 19, 10),
        ("min", 23, 22), ("max", 23, 22), ("min", 27, 26), ("max", 27, 26),
        ("min", 20, 30), ("max", 20, 30), ("max", 21, 25), ("min", 31, 33),
        ("max", 31, 33), ("min", 32, 34), ("max", 32, 34), ("min", 24, 28),
        ("min", 40, 37), ("max", 40, 37), ("min", 42, 39), ("max", 42, 39),
        ("max", 38, 43), ("min", 45, 44), ("max", 45, 44), ("min", 46, 41),
        ("max", 47, 36), ("max", 49, 29), ("min", 50, 35), ("max", 48, 53),
        ("min", 51, 52), ("min", 54, 55)),
    12: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("min", 4, 5), ("max", 4, 5), ("min", 6, 7), ("max", 6, 7),
        ("min", 8, 9), ("max", 8, 9), ("min", 10, 11), ("max", 10, 11),
        ("min", 12, 14), ("max", 12, 14), ("min", 13, 15), ("max", 13, 15),
        ("min", 16, 18), ("max", 16, 18), ("min", 17, 19), ("max", 17, 19),
        ("min", 20, 22), ("max", 20, 22), ("min", 21, 23), ("max", 21, 23),
        ("min", 26, 25), ("max", 26, 25), ("min", 30, 29), ("max", 30, 29),
        ("min", 34, 33), ("max", 34, 33), ("max", 24, 28), ("min", 36, 38),
        ("max", 36, 38), ("min", 37, 39), ("max", 37, 39), ("min", 27, 31),
        ("min", 45, 42), ("max", 45, 42), ("min", 47, 44), ("max", 47, 44),
        ("min", 43, 48), ("max", 43, 48), ("min", 50, 49), ("max", 50, 49),
        ("min", 51, 46), ("max", 51, 46), ("max", 52, 40), ("max", 53, 41),
        ("min", 54, 35), ("max", 55, 32), ("min", 56, 58), ("min", 57, 59),
        ("max", 60, 62), ("min", 63, 61), ("min", 64, 65), ("max", 64, 65)),
    13: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("min", 4, 5), ("max", 4, 5), ("min", 6, 7), ("max", 6, 7),
        ("min", 8, 9), ("max", 8, 9), ("min", 10, 11), ("max", 10, 11),
        ("min", 13, 15), ("max", 13, 15), ("min", 14, 16), ("max", 14, 16),
        ("min", 17, 19), ("max", 17, 19), ("min", 18, 20), ("max", 18, 20),
        ("min", 21, 23), ("max", 21, 23), ("min", 22, 24), ("max", 22, 24),
        ("min", 27, 26), ("max", 27, 26), ("min", 31, 30), ("max", 31, 30),
        ("min", 35, 34), ("max", 35, 34), ("max", 25, 29), ("min", 37, 39),
        ("max", 37, 39), ("min", 38, 40), ("max", 38, 40), ("min", 28, 32),
        ("min", 33, 12), ("max", 33, 12), ("min", 46, 43), ("max", 46, 43),
        ("min", 48, 45), ("max", 48, 45), ("min", 42, 50), ("max", 42, 50),
        ("min", 44, 51), ("max", 44, 51), ("min", 53, 52), ("max", 53, 52),
        ("min", 54, 47), ("max", 54, 47), ("min", 41, 55), ("max", 41, 55),
        ("min", 36, 56), ("max", 36, 56), ("max", 57, 63), ("max", 58, 64),
        ("min", 59, 65), ("min", 60, 66), ("max", 70, 49), ("min", 61, 67),
        ("min", 62, 68), ("max", 69, 72), ("min", 73, 71), ("max", 74, 75)),
    14: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("min", 4, 5), ("max", 4, 5), ("min", 6, 7), ("max", 6, 7),
        ("min", 8, 9), ("max", 8, 9), ("min", 10, 11), ("max", 10, 11),
        ("min", 12, 13), ("max", 12, 13), ("min", 14, 16), ("max", 14, 16),
        ("min", 15, 17), ("max", 15, 17), ("min", 18, 20), ("max", 18, 20),
        ("min", 19, 21), ("max", 19, 21), ("min", 22, 24), ("max", 22, 24),
        ("min", 23, 25), ("max", 23, 25), ("min", 30, 29), ("max", 30, 29),
        ("min", 34, 33), ("max", 34, 33), ("min", 38, 37), ("max", 38, 37),
        ("min", 28, 32), ("max", 28, 32), ("min", 40, 42), ("max", 40, 42),
        ("min", 41, 43), ("max", 41, 43), ("min", 31, 35), ("max", 31, 35),
        ("min", 36, 26), ("max", 36, 26), ("min", 44, 27), ("max", 44, 27),
        ("min", 50, 47), ("max", 50, 47), ("min", 52, 49), ("max", 52, 49),
        ("min", 45, 55), ("max", 45, 55), ("min", 39, 57), ("max", 39, 57),
        ("min", 48, 58), ("max", 48, 58), ("min", 60, 59), ("max", 60, 59),
        ("min", 61, 51), ("max", 61, 51), ("min", 56, 62), ("max", 56, 62),
        ("min", 64, 63), ("max", 64, 63), ("max", 46, 54), ("max", 66, 72),
        ("max", 67, 73), ("min", 68, 74), ("max", 68, 74), ("min", 69, 75),
        ("min", 70, 65), ("max", 81, 76), ("min", 82, 77), ("max", 82, 77),
        ("min", 71, 78), ("min", 53, 80), ("max", 79, 84), ("min", 86, 83),
        ("max", 86, 83), ("min", 87, 85), ("max", 88, 89), ("min", 91, 90)),
    15: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("min", 4, 5), ("max", 4, 5), ("min", 6, 7), ("max", 6, 7),
        ("min", 8, 9), ("max", 8, 9), ("min", 10, 11), ("max", 10, 11),
        ("min", 12, 13), ("max", 12, 13), ("min", 15, 17), ("max", 15, 17),
        ("min", 16, 18), ("max", 16, 18), ("min", 19, 21), ("max", 19, 21),
        ("min", 20, 22), ("max", 20, 22), ("min", 23, 25), ("max", 23, 25),
        ("min", 24, 26), ("max", 24, 26), ("min", 27, 14), ("max", 27, 14),
        ("min", 31, 30), ("max", 31, 30), ("min", 35, 34), ("max", 35, 34),
        ("min", 39, 38), ("max", 39, 38), ("min", 28, 42), ("max", 28, 42),
        ("min", 29, 33), ("max", 29, 33), ("min", 43, 45), ("max", 43, 45),
        ("min", 44, 46), ("max", 44, 46), ("min", 32, 36), ("max", 32, 36),
        ("min", 37, 41), ("max", 37, 41), ("min", 47, 49), ("max", 47, 49),
        ("min", 48, 50), ("max", 48, 50), ("min", 55, 52), ("max", 55, 52),
        ("min", 57, 54), ("max", 57, 54), ("min", 63, 60), ("max", 63, 60),
        ("min", 40, 62), ("max", 40, 62), ("min", 53, 65), ("max", 53, 65),
        ("min", 67, 66), ("max", 67, 66), ("min", 68, 56), ("max", 68, 56),
        ("min", 61, 69), ("max", 61, 69), ("min", 71, 70), ("max", 71, 70),
        ("min", 72, 64), ("max", 72, 64), ("max", 51, 59), ("max", 73, 79),
        ("max", 74, 80), ("max", 75, 81), ("min", 76, 82), ("min", 77, 83),
        ("min", 78, 84), ("max", 89, 85), ("max", 90, 86), ("min", 91, 87),
        ("min", 58, 88), ("max", 94, 92), ("min", 95, 93), ("min", 97, 96)),
    16: (("min", 0, 1), ("max", 0, 1), ("min", 2, 3), ("max", 2, 3),
        ("min", 4, 5), ("max", 4, 5), ("min", 6, 7), ("max", 6, 7),
        ("min", 8, 9), ("max", 8, 9), ("min", 10, 11), ("max", 10, 11),
        ("min", 12, 13), ("max", 12, 13), ("min", 14, 15), ("max", 14, 15),
        ("min", 16, 18), ("max", 16, 18), ("min", 17, 19), ("max", 17, 19),
        ("min", 20, 22), ("max", 20, 22), ("min", 21, 23), ("max", 21, 23),
        ("min", 24, 26), ("max", 24, 26), ("min", 25, 27), ("max", 25, 27),
        ("min", 28, 30), ("max", 28, 30), ("min", 29, 31), ("max", 29, 31),
        ("min", 34, 33), ("max", 34, 33), ("min", 38, 37), ("max", 38, 37),
        ("min", 42, 41), ("max", 42, 41), ("min", 46, 45), ("max", 46, 45),
        ("min", 32, 36), ("max", 32, 36), ("min", 48, 50), ("max", 48, 50),
        ("min", 49, 51), ("max", 49, 51), ("min", 35, 39), ("max", 35, 39),
        ("min", 40, 44), ("max", 40, 44), ("min", 52, 54), ("max", 52, 54),
        ("min", 53, 55), ("max", 53, 55), ("min", 43, 47), ("max", 43, 47),
        ("min", 60, 57), ("max", 60, 57), ("min", 62, 59), ("max", 62, 59),
        ("min", 68, 65), ("max", 68, 65), ("min", 70, 67), ("max", 70, 67),
        ("min", 58, 72), ("max", 58, 72), ("min", 74, 73), ("max", 74, 73),
        ("min", 75, 61), ("max", 75, 61), ("min", 66, 76), ("max", 66, 76),
        ("min", 78, 77), ("max", 78, 77), ("min", 79, 69), ("max", 79, 69),
        ("max", 56, 64), ("max", 80, 86), ("max", 81, 87), ("max", 82, 88),
        ("min", 83, 89), ("min", 84, 90), ("min", 85, 91), ("min", 63, 71),
        ("max", 96, 92), ("max", 97, 93), ("min", 98, 94), ("min", 99, 95),
        ("max", 102, 100), ("min", 103, 101), ("min", 105, 104),
        ("max", 105, 104)),
}
# what K2's earlier design (one thread per coordinate, a 64-bit division
# per coordinate, the bubble network of NaN-aware min/max) issued per term
# at r = 5, read by phase_sketch_sass on an NVIDIA H100 80GB HBM3; the
# decode must issue fewer
K2_BUBBLE_SASS_PER_TERM = 34.20
# the pipe of each SASS opcode the circulant kernels issue (by its name
# before the first dot); any other counts only as an issued instruction
SASS_PIPE = {**dict.fromkeys(("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA",
                              "PRMT", "IMNMX", "FMNMX", "FSEL", "FSETP",
                              "PLOP3", "IABS"), "alu"),
             **dict.fromkeys(("IMAD", "IMUL"), "imad"),
             **dict.fromkeys(("FADD", "FMUL", "FFMA"), "fp32"),
             **dict.fromkeys(("LDG", "STG", "LDS", "STS", "LDC"), "memory")}
# the hash's first multiplier as SASS prints an immediate (signed)
SASS_HASH_MARK = f"-{hex(2**32 - 0x85EBCA6B)}"
ROUNDS = 6
FLAGSHIP = dict(d=6_568_640, c=500_736, r=5)
GPT2_SKETCH = dict(d=92_138_496, c=524_288, r=5)
# K1/K2 at the EF study's tables (scripts/gpt2_ef_study.sh) at GPT-2's d,
# with the encode's scale (a client's datum count): 9 rows (m = 176), 2
# rows of 4,603,904 columns (m = 21), 5 rows of 8,388,608, 4,194,304 and
# 1,835,008 (m = 11, 22, 51); and 16 rows, the kernels' most, at the
# ResNet-9 shape (m = 14)
ROWS_SKETCHES = {
    "gpt2_r9_shape": (dict(GPT2_SKETCH, r=9), 4.0),
    "gpt2_r2_c4603904_shape": (dict(GPT2_SKETCH, c=4_603_904, r=2), 4.0),
    "r16_resnet9_shape": (dict(FLAGSHIP, r=16), 64.0),
    **{f"gpt2_m{m}_shape": (dict(GPT2_SKETCH, c=c), 4.0) for m, c in
       ((11, 8_388_608), (22, 4_194_304), (51, 1_835_008))}}
GPT2_ROUNDS = 4
# K1: 8 clients + the weight-decay encode; the zero rule's cell sum; K3:
# 12 layers x 8 clients
GPT2_PER_ROUND = {"circ_encode": 9, "circ_decode": 1, "cell_sum": 1,
                  "flash_fwd": 96, "flash_bwd_dq": 96, "flash_bwd_dkv": 96}
GPT2_VAL_FWD = 12               # one validation batch of 8 items, 12 layers
# two arms of the JAX package's GPT-2 study (scripts/gpt2_ef_study.sh) at
# the main path's k, 3 rounds each: the table clip (under the default
# telemetry, as the JAX package routes it, each client's dense gradient is
# encoded into its own table: 8 K1, 1 cell sum) and densestate_clip1 (dense
# clip, one deferred encode of the dense sum of the (d,) error pre-image:
# 1 K1, no cell sum); (flags, K1 a round, cell sums a round)
GPT2_ARM_ROUNDS = 3
GPT2_ARMS = {
    "clip1": (["--max_grad_norm", "1"], 8, 1),
    "densestate_clip1": (["--sketch_server_state", "dense",
                          "--sketch_dense_clip", "--max_grad_norm", "1"], 1,
                         0),
}
# the hash encode on the card against the same call on the CPU: each
# cell within 1e-5 of itself plus 1e-5 of its row's RMS cell (index_add_
# sums a cell's ~13 addends in no fixed order on the card)
HASH_ENCODE_RTOL = 1e-5
# the SRHT's lossless round trip at c >= d': within 1e-5 of the largest
# |v| (three float32 products of 2^23 coordinates; TF32 would miss it)
RHT_ROUND_TRIP_ATOL = 1e-5
# the DP noise measured in a round on the card: its standard deviation
# within 1% of noise_multiplier, and a repeated round's noise within 1e-3
# of it (the gradient's own run-to-run spread on the card is far below)
NOISE_STD_RTOL = 1e-2
NOISE_REPEAT_RTOL = 1e-3
# (N, S, H, D): the main path's shape, S = 256, and the bench paths'
# shapes: the long-context bench's two longest (bench_longctx: 16,384
# tokens a step), the bare-model bench's (a microbatch of 8 dialogues x 2
# candidates) and the long-context bench's at S = 1024. N sets the work
# list of K3's persistent grid: at (16, 256) its last round on the 132
# CTAs is a partial one at an even r, which no other shape gives
FLASH_SHAPES = ((8, 1024, 12, 64), (8, 256, 12, 64), (8, 2048, 12, 64),
                (4, 4096, 12, 64), (16, 256, 12, 64), (16, 1024, 12, 64))
# a planted fault skips this many keys or queries: finer than the
# 128-wide tiles of every K3 kernel
FLASH_TILE = 64
# the bf16 D = 64 route: K3's kernels on GPT-2's paths
HOPPER_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# flash_attention.cu's kernels, built from wgmma fed by TMA, each by its C
# entry point and its instantiation's mangled mark: their SASS must hold
# both of HOPPER_SASS
WGMMA_KERNELS = {
    "flash_fwd": "flash_fwd_kernelILi64E",
    "flash_bwd_dq": "flash_bwd_dq_kernelILi64E",
    "flash_bwd_dkv": "flash_bwd_dkv_kernelILi64E",
    **{f"flash_fwd_bf16_d{D}": f"flash_fwd_kernelILi{D}E"
       for D in (32, 128)},
    **{f"flash_bwd_{kind}_bf16_d{D}": f"flash_bwd_{kind}_kernelILi{D}E"
       for D in (16, 32, 128) for kind in ("dq", "dkv")}}
HOPPER_SASS = ("HGMMA", "UTMALDG")
# flash_tiled.cu's float32 kernels (forward, dq, dk/dv), each by its C
# entry point and its instantiation's mangled mark: 3xTF32 products on the
# tensor cores, so their SASS must hold HMMA on TF32 operands
TF32_KERNELS = {
    f"flash_{kind}_f32_d{D}": f"{kernel}_f32_kernelILi{D}E"
    for kind, kernel in (("fwd", "fwd"), ("bwd_dq", "dq"),
                         ("bwd_dkv", "dkv"))
    for D in (16, 32, 64, 128)}
# flash_tiled.cu's bf16 forward kernel (D = 16): K and V copied
# asynchronously, so its SASS must hold LDGSTS (cp.async) or UTMALDG (a
# TMA load)
ASYNC_KERNELS = {"flash_fwd_bf16_d16": "fwd_bf16_kernelILi16E"}
ASYNC_SASS = ("LDGSTS", "UTMALDG")
# K3 against its plain version, each (n, s, h) row of D held against its
# own size: |got - ref| <= 1.5e-2 |ref| (+ 1e-3 of the mean row norm, for
# rows near 0) for o, dq, dk and dv. The kernels round p and ds to bf16 as
# product operands and round their outputs to bf16: about 5e-3 at worst
# (an emulation of that rounding on the CPU; read on an H100: 4.6e-3 to
# 5.5e-3, and 1.0 to 1.6 with a planted fault). lse to 1e-4 absolute.
FLASH_ROW_RTOL = 1.5e-2
FLASH_LSE_ATOL = 1e-4
# K3's float32 routes against their plain version: the largest difference
# of o, lse, dq, dk and dv within 2e-5 of that output's largest magnitude.
# Every float32 kernel runs 3xTF32 products (about 21 bits an operand) on
# the tensor cores, summed there from zero a stage at a time (the forward's
# s over D, its p v over a tile of 64 keys), then in float32; the plain
# version is float32 with TF32 off. tests/test_torch_attention.py holds
# the limit to emulated products: the backward's 3xTF32 summed in float32
# within an eighth of it (3.8e-7 to 1.4e-6 on the CPU) and summed as a
# model of the tensor cores (truncating, stage by stage) within a third
# (9.5e-7 to 4.5e-6), single TF32 products each more than ten times over
# (2.6e-4 to 1.1e-3); the forward's within a sixteenth and an eighth
# (3.6e-7 to 6.6e-7, 6.6e-7 to 1.1e-6), single TF32 more than ten times
# over (2.7e-4 to 4.8e-4); a skipped tile far over. Read on an H100 80GB
# HBM3: the backward 2.0e-7 to 4.3e-6, the same to two digits with exp2f
# as with ex2.approx: the truncating sums, not the exp, set its error; the
# forward's o 5.5e-7 to 1.0e-6
FLASH_F32_RTOL = 2e-5
# narrow GPT-2, card against CPU (phase_gpt2_reference): largest relative
# L2 error of a c_attn q/k/v gradient block, largest relative loss
# difference over 3 rounds, least cosine of the rounds' weight update.
# Read on an H100: sound 1.6e-2, 1.8e-3, 0.934; a planted dq fault 0.83,
# 2.8e-2, 0.50; a planted dk/dv fault 0.80, 4.3e-3, 0.49 (the loss alone
# does not separate that one); a planted forward fault far outside.
NARROW_LIMITS = {"grad": 0.1, "dloss": 1e-2, "cos": 0.75}
LIBRARY_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, n: int = 25, warmup: int = 3, reps: int = 3) -> float:
    """Device time of one ``fn()``: CUDA events around ``n`` calls that
    run back to back on the card, median over ``reps`` such runs. The calls
    are enqueued behind a device-side sleep longer than it takes the host
    to enqueue them, so the wrappers' host overhead (checks, ctypes) does
    not enter the time unless it exceeds the device time. The sleep is
    sized from a timed enqueue of ``n`` calls after the warm-up (first
    calls pay one-time set-up) and capped at about a second."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # 2x the enqueue at the card's ~2 GHz clock
    cycles = int(min(2 * enqueue_s, 1.0) * 2e9) + 10_000_000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def reference_file(name: str) -> str:
    """Repository path of the TPU kernels' file ``name`` in the JAX
    package, found on disk (nothing of it is imported)."""
    import glob
    root = os.path.dirname(os.path.abspath(__file__))
    hits = sorted(os.path.relpath(h, root)
                  for h in glob.glob(os.path.join(root, "*", name)))
    hits = [h for h in hits if not h.startswith("commefficient_torch")]
    return hits[0] if hits else name


# the compiler's output of each source compiled by phase_build
BUILD_LOGS = {}


def phase_build():
    from commefficient_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    BUILD_LOGS.update(logs)
    dt = time.perf_counter() - t0
    for source, log in logs.items():
        lines = [ln for ln in log.splitlines()
                 if any(w in ln for w in ("registers", "spill", "Compiling",
                                          "wgmma"))]
        print(f"[build] {source}:\n  " + "\n  ".join(lines))
    print(f"[build] {len(_build.SOURCES)} source(s) in {dt:.2f} s "
          f"({len(logs)} compiled now)", flush=True)


def cuobjdump(flag: str, source: str):
    """Lines of the toolkit's ``cuobjdump <flag>`` of the built library of
    ``source`` (it carries SASS for sm_90a only, no PTX)."""
    from commefficient_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    r = subprocess.run([tool, flag, _build.library_path(source)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump {flag} failed: {r.stderr.strip()}")
    return r.stdout.splitlines()


def phase_sketch_sass():
    """Instructions by pipe per (row, coordinate) term that K1 and K2
    issue at r = 5, read from the circulant library's SASS
    (``sass_per_term``), beside what a term needs (``term_instructions``,
    ``decode_term_instructions``). Fails if the block is not found, if a
    kernel issues fewer integer instructions a term than the count of what
    a term needs, if K2 calls a subroutine (a 64-bit division would) or if
    it issues K2_BUBBLE_SASS_PER_TERM or more a term."""
    from commefficient_torch.ops import circulant_kernels as K
    funcs, name = {}, None
    # K2's whole decode is its kRange = false instantiation
    marks = {"circ_encode": "encode_kernelILi5E",
             "circ_decode": "decode_kernelILi5ELb0E",
             "circ_decode r = 9": "decode_kernelILi9ELb0E"}
    for line in cuobjdump("-sass", K.SOURCE):
        if "Function :" in line:
            name = next((n for n, mark in marks.items() if mark in line),
                        None)
            if name is not None:
                funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    resources = sketch_resources(funcs.pop("circ_decode r = 9", []))
    needs = {"circ_encode": term_instructions(0),
             "circ_decode": decode_term_instructions(5)}
    kind_of = {"circ_encode": "K1", "circ_decode": "K2"}
    out = {}
    for name, need in needs.items():
        need_int = need["alu"] + need["imad"] + need["either"]
        per, hashes = sass_per_term(funcs.get(name, []))
        calls = sum(" CALL" in line for line in funcs.get(name, []))
        issued = sum(per.values())
        print(f"[sass] {name} (r = 5): per term, in the block of "
              f"{hashes} hashes: " + ", ".join(f"{n:.2f} {p}" for p, n in
                                               per.items())
              + f" = {issued:.2f} issued; a term needs {need_int:.2f} "
              f"integer ({need['alu']:.2f} ALU, {need['imad']} IMAD, "
              f"{need['either']} either); {calls} CALL in the function",
              flush=True)
        if hashes == 0 or per["alu"] + per["imad"] < need_int:
            fail(f"{name}: no hash block in the SASS, or fewer integer "
                 f"instructions a term than counted as needed: {per}")
        if name == "circ_decode":
            print(f"[sass] circ_decode issues {issued:.2f} a term; the "
                  f"one-thread-per-coordinate design issued "
                  f"{K2_BUBBLE_SASS_PER_TERM:.2f}", flush=True)
            if calls or issued >= K2_BUBBLE_SASS_PER_TERM:
                fail(f"circ_decode: {calls} CALL, {issued:.2f} "
                     "instructions a term")
        out[name] = {"hashes_in_block": hashes, "calls": calls, **per,
                     "resources": {k: v for k, v in resources.items()
                                   if k.startswith(kind_of[name])}}
    return out


# the instantiations of K1 and K2 whose registers, stack and local memory
# are printed: r = 5 (the main paths') and the first and last past r = 8
SKETCH_RESOURCE_ROWS = (5, 9, 16)


def sketch_resources(decode9_sass) -> dict:
    """Registers, stack frame and local memory of every K1 and K2
    instantiation (``cuobjdump -res-usage`` of the built library, whether
    or not this run compiled it), printed at SKETCH_RESOURCE_ROWS, and the
    SASS of the whole decode at r = 9. Fails if an instantiation has a
    stack frame or local memory (a spill would), or if
    ``decode_kernel<9>`` calls a subroutine or moves local memory (LDL,
    STL): its median network must stay in registers."""
    import re

    from commefficient_torch.ops import circulant_kernels as K

    def instance(line):
        hit = re.search(r"(encode|decode)_kernelILi(\d+)E(Lb([01])E)?",
                        line)
        if not hit:
            return None
        kind = "K1 encode" if hit.group(1) == "encode" else (
            "K2 decode" + (" range" if hit.group(4) == "1" else ""))
        return f"{kind}<{hit.group(2)}>"

    use, name = {}, None
    for line in cuobjdump("-res-usage", K.SOURCE):
        if "Function " in line:
            name = instance(line)
        elif name is not None and "REG:" in line:
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            use[name] = {"registers": int(fields["REG"]),
                         "stack_bytes": int(fields["STACK"]),
                         "local_bytes": int(fields["LOCAL"])}
    out = {}
    for r in SKETCH_RESOURCE_ROWS:
        for kind in ("K1 encode", "K2 decode"):
            key = f"{kind}<{r}>"
            if key not in use:
                fail(f"cuobjdump -res-usage reported nothing for {key}")
            out[key] = use[key]
            print(f"[sass] {key}: {use[key]['registers']} registers, "
                  f"{use[key]['stack_bytes']} B stack, "
                  f"{use[key]['local_bytes']} B local", flush=True)
    local = sorted(k for k, u in use.items()
                   if u["stack_bytes"] or u["local_bytes"])
    if local:
        fail(f"K1/K2 instantiations with a stack frame or local memory: "
             f"{local}")
    ops = [line.split(";")[0] for line in decode9_sass]
    calls = sum(" CALL" in op for op in ops)
    local = sum(bool(re.search(r"\b(LDL|STL)\b", op)) for op in ops)
    print(f"[sass] K2 decode<9>: {len(ops)} SASS lines, {calls} CALL, "
          f"{local} local-memory loads and stores; instantiations "
          f"without stack or local memory: {len(use)}", flush=True)
    if not ops or calls or local:
        fail(f"decode_kernel<9>: {len(ops)} SASS lines, {calls} CALL, "
             f"{local} LDL/STL")
    return out


def phase_sass():
    """Registers, shared memory, spills and the wgmma/TMA instruction
    counts of each kernel of ``flash_attention.cu`` (WGMMA_KERNELS), read
    from the built library with the toolkit's cuobjdump (spills from the
    build's ptxas output, when this run compiled it). Fails if a kernel
    lacks HGMMA or UTMALDG."""
    from commefficient_torch.ops import flash_attention as FA

    def kernel_of(line):
        return next((name for name, mark in WGMMA_KERNELS.items()
                     if mark in line), None)

    out = {name: dict.fromkeys(HOPPER_SASS, 0) for name in WGMMA_KERNELS}
    name = None
    for line in cuobjdump("-sass", FA.SOURCE):
        if "Function :" in line:
            name = kernel_of(line)
        elif name is not None:
            for op in HOPPER_SASS:
                out[name][op] += op in line
    for line in cuobjdump("-res-usage", FA.SOURCE):
        if "Function " in line:
            name = kernel_of(line)
        elif name is not None and "REG:" in line:
            use = dict(f.split(":", 1) for f in line.split() if ":" in f)
            out[name]["registers"] = int(use["REG"])
            out[name]["static_smem"] = int(use["SHARED"])
    spills = {kernel_of(m): nums for m, nums in ptxas_spills(
        BUILD_LOGS.get(FA.SOURCE, "")).items() if kernel_of(m)}
    lib_fa = FA._lib()
    for name, use in out.items():
        use["dynamic_smem"] = getattr(lib_fa, f"{name}_smem_bytes")()
        sp = spills.get(name)
        use["spill_store_bytes"] = sp[1] if sp else None
        print(f"[sass] {name}: {use.get('registers')} registers at launch, "
              f"shared memory {use.get('static_smem')} B static + "
              f"{use['dynamic_smem']} B dynamic; ptxas "
              + (f"{sp[1]} B spill stores, {sp[2]} B spill loads" if sp
                 else "spills not in this run's build log")
              + "; SASS: "
              + ", ".join(f"{use[op]} {op}" for op in HOPPER_SASS),
              flush=True)
        if "registers" not in use:
            fail(f"cuobjdump -res-usage reported nothing for {name}")
    lacking = [f"{name} ({op})" for name in WGMMA_KERNELS
               for op in HOPPER_SASS if out[name][op] == 0]
    if lacking:
        fail(f"K3 kernels without wgmma/TMA in SASS: {lacking}")
    return out


def ptxas_spills(log: str) -> dict:
    """{mangled function: (stack frame, spill store, spill load bytes)}
    from ``nvcc -Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ", 1)[1].strip()
        elif name is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[name] = tuple(nums[:3])
            name = None
    return out


def phase_tiled_sass():
    """``flash_tiled.cu``'s float32 kernels (TF32_KERNELS: forward, dq and
    dk/dv at every D) and bf16 forwards (ASYNC_KERNELS) in the built
    library: registers and stack frame (``cuobjdump -res-usage``), spill
    bytes (the build's ptxas output, when this run compiled it), the HMMA
    mnemonics, the asynchronous copies and the most issued opcodes of
    their SASS. Fails if a float32 kernel's SASS holds no HMMA on TF32
    operands, or a bf16 forward's no LDGSTS or UTMALDG."""
    from commefficient_torch.ops import flash_attention as FA
    marks = {**TF32_KERNELS, **ASYNC_KERNELS}

    def kernel_of(line):
        return next((name for name, mark in marks.items() if mark in line),
                    None)

    ops = {name: {} for name in marks}
    name = None
    for line in cuobjdump("-sass", FA.TILED_SOURCE):
        if "Function :" in line:
            name = kernel_of(line)
        elif name is not None and "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                ops[name][words[0]] = ops[name].get(words[0], 0) + 1
    res = {}
    for line in cuobjdump("-res-usage", FA.TILED_SOURCE):
        if "Function " in line:
            name = kernel_of(line)
        elif name is not None and "REG:" in line:
            res[name] = dict(f.split(":", 1) for f in line.split()
                             if ":" in f)
    spills = {}
    for mangled, nums in ptxas_spills(
            BUILD_LOGS.get(FA.TILED_SOURCE, "")).items():
        hit = kernel_of(mangled)
        if hit is not None:
            spills[hit] = nums
    out, lacking = {}, []
    for name, count in ops.items():
        hmma = {op: n for op, n in count.items() if op.startswith("HMMA")}
        copies = {op: n for op, n in count.items()
                  if op.split(".")[0] in ASYNC_SASS}
        top = sorted(count.items(), key=lambda kv: -kv[1])[:10]
        use = res.get(name, {})
        sp = spills.get(name)
        print(f"[sass] {name}: {use.get('REG')} registers, stack frame "
              f"{use.get('STACK')} B, local {use.get('LOCAL')} B; ptxas "
              + (f"{sp[1]} B spill stores, {sp[2]} B spill loads"
                 if sp else "spills not in this run's build log")
              + f"; HMMA {hmma}; asynchronous copies {copies}; most "
              f"issued (static): {top}", flush=True)
        if name in TF32_KERNELS and not any("TF32" in op for op in hmma):
            lacking.append(f"{name} (no TF32 HMMA)")
        if name in ASYNC_KERNELS and not copies:
            lacking.append(f"{name} (no {' or '.join(ASYNC_SASS)})")
        out[name] = {"registers": int(use.get("REG", -1)),
                     "stack_bytes": int(use.get("STACK", -1)),
                     "spill_store_bytes": sp[1] if sp else None,
                     "hmma": hmma, "async_copies": copies,
                     "instructions": sum(count.values())}
    if lacking:
        fail(f"flash_tiled.cu kernels without their instructions in SASS: "
             f"{lacking}")
    return out


def bound(nbytes: float, ops: float, peak: float, instr=None):
    """(least ms, what bounds it) on an H100 SXM: the largest of
    ``nbytes`` over 3.35 TB/s ("bytes"), ``ops`` over ``peak`` ("fp32",
    "bf16" or "3xTF32 operations", PEAK_KINDS) and, given ``instr``
    (instruction counts by pipe: "alu", "imad", "either" of the two,
    "other"), the ALU's and the IMAD pipe's own instructions over their
    lanes ("ALU issue", "IMAD issue") and all of them over the SM's issue
    rate ("instruction issue")."""
    times = {"bytes": nbytes / H100_BYTES_PER_S,
             PEAK_KINDS[peak] + " operations": ops / peak}
    if instr:
        per_lane = H100_SMS * H100_CLOCK_HZ
        times["ALU issue"] = instr["alu"] / (LANES["alu"] * per_lane)
        times["IMAD issue"] = instr["imad"] / (LANES["imad"] * per_lane)
        times["instruction issue"] = (sum(instr.values())
                                      / (LANES["issue"] * per_lane))
    kind = max(times, key=times.get)
    return 1e3 * times[kind], kind


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products and convolutions in full float32 on the card
    (TF32 off) while open, and the caller's two settings restored after:
    a phase that needs float32 must not leave TF32 on for the phases after
    it (PyTorch's default is off for matrix products)."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def bound_by(kind: str) -> str:
    return "bytes" if kind == "bytes" else "operations"


def sign_hash(x, key: int, value, ops=SIGN_HASH):
    """``value`` (float32) times sigma(x) for a row's ``key``, computed by
    the instructions of ``ops`` in uint32 arithmetic: x, value numpy
    arrays of one shape."""
    import numpy as np
    x = np.asarray(x, np.uint32)
    h = t = np.zeros_like(x)
    out = np.asarray(value, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        for op, arg, _ in ops:
            if op == "mad":
                h = x * np.uint32(key) + np.uint32(arg)
            elif op == "shr":
                t = h >> np.uint32(arg)
            elif op == "xor":
                h = h ^ t
            elif op == "mul":
                h = h * np.uint32(arg)
            elif op == "sign":
                out = out ^ (h & np.uint32(0x80000000))
    return out.view(np.float32)


def median_net(x, ops):
    """The median over the leading axis of ``x`` ((r, ...) float32) by
    the operations ``ops`` of a MEDIAN_NETS entry, each min and max under
    the rule of jnp.minimum / jnp.maximum (a NaN operand is returned,
    -0 < +0)."""
    import numpy as np
    v = list(np.asarray(x, np.float32))
    r = len(v)
    for op, a, b in ops:
        p, q = v[a], v[b]
        order = p < q if op == "min" else p > q
        tie = (p == q) & (np.signbit(p) == (op == "min"))
        v.append(np.where(np.isnan(p) | order | tie, p, q))
    return v[-1] if r % 2 else np.float32(0.5) * (v[-2] + v[-1])


def term_instructions(other: float, index_step: bool = True):
    """Instructions one (row, coordinate) term needs by pipe: the sign
    hash and sign of SIGN_HASH, one index step unless ``index_step`` is
    False, and ``other``, the term's share of the loads, stores and float
    operations."""
    out = {"alu": 0, "imad": 0, "either": 0, "other": other}
    for _, _, pipe in SIGN_HASH:
        out[pipe] += 1
    out[INDEX_STEP] += index_step
    return out


def decode_term_instructions(r: int):
    """What a term of K2 needs by pipe: SIGN_HASH, its share of a load and
    a store, and its share (1/r) of the coordinate's median network on the
    ALU; no index step."""
    out = term_instructions(1 + 1 / r, index_step=False)
    out["alu"] += len(MEDIAN_NETS[r]) / r
    return out


def sketch_work(d: int, c: int, r: int):
    """(bytes, float operations, instructions by pipe) that K1 (the timed
    call accumulates: the table is read and written) and K2 must move and
    do: every input read once, every output written once. K1: per
    coordinate below d a load of v and the scale multiply, per (row,
    coordinate) a term and an add. K2: per (row, coordinate) a term and a
    load of a table cell, per coordinate a store, the median network
    (``decode_term_instructions``) and, for even r, the mean's add and
    multiply."""
    terms = r * d
    return {"circ_encode": (4 * d + 2 * 4 * r * c, terms + d,
                            {p: n * terms for p, n in
                             term_instructions(1 + 2 / r).items()}),
            "circ_decode": (4 * r * c + 4 * d, (1 - r % 2) * 2 * d,
                            {p: n * terms for p, n in
                             decode_term_instructions(r).items()})}


def sass_blocks(lines):
    """The basic blocks of one function's SASS (``cuobjdump -sass``
    lines), each a list of its instructions' opcodes and texts, split at
    every branch and at every address a branch or a BSSY names."""
    import re
    inst = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);")
    code = []
    for line in lines:
        hit = inst.search(line)
        if hit:
            code.append((int(hit.group(1), 16), hit.group(2),
                         hit.group(2) + hit.group(3)))
    leaders = {addr for _, op, text in code
               if op.split(".")[0] in ("BRA", "BSSY", "CALL")
               for addr in (int(a, 16) for a in
                            re.findall(r"0x([0-9a-f]+)\s*$", text))}
    blocks, cur = [], []
    for addr, op, text in code:
        if addr in leaders and cur:
            blocks.append(cur)
            cur = []
        cur.append((op, text))
        if op.split(".")[0] in ("BRA", "EXIT", "RET", "CALL"):
            blocks.append(cur)
            cur = []
    return blocks + ([cur] if cur else [])


def sass_per_term(lines):
    """Instructions by pipe per sign hash in the basic block that holds
    the most hashes, the shortest of them on a tie (K1: one block of the
    walk; K2: a tile that holds no seam), and that block's hash count."""
    block = max(sass_blocks(lines),
                key=lambda b: (sum(SASS_HASH_MARK in t for _, t in b),
                               -len(b)))
    hashes = sum(SASS_HASH_MARK in t for _, t in block)
    out = dict.fromkeys(("alu", "imad", "fp32", "memory", "other"), 0)
    for op, _ in block:
        out[SASS_PIPE.get(op.split(".")[0], "other")] += 1
    return {p: n / max(hashes, 1) for p, n in out.items()}, hashes


def row_errors(got, ref):
    """Relative L2 error of each row (last dimension) of ``got`` against
    ``ref``: |got - ref| / (|ref| + 1e-3 of ref's mean row norm)."""
    diff = (got.float() - ref.float()).norm(dim=-1)
    norm = ref.float().norm(dim=-1)
    return diff / (norm + 1e-3 * norm.mean())


def planted_drops(S: int, device):
    """(S, S) masks of the (query, key) pairs that a faulty K3 kernel would
    skip: the forward and dq kernels skip key tile 0 for the rows of the
    second half; the dk/dv kernel skips the last query tile for the keys
    outside it."""
    import torch
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    T = FLASH_TILE
    tile0 = (i >= S // 2) & (j < T)
    return {"flash_fwd": tile0, "flash_bwd_dq": tile0,
            "flash_bwd_dkv": (i >= S - T) & (j < S - T)}


def plain_delta(o, do):
    """delta = rowsum(dO o), float32 (N, H, S)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def attention_skipping(q, k, v, drop, do=None, lse=None, delta=None):
    """Causal attention of (N, S, H, D) q, k, v in float32 that leaves out
    the (query, key) pairs of ``drop``: a planted fault. Without ``do``, the
    forward ``(o, lse)``; with ``do``, ``lse`` and ``delta``, the backward
    ``(dq, dk, dv)`` as the kernels compute it."""
    import torch
    S, D = q.shape[1], q.shape[-1]
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril() & ~drop
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) / math.sqrt(D)
    s = s.masked_fill(~keep, float("-inf"))
    if do is None:
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        o = torch.einsum("nhqk,nkhd->nqhd", p, v.float())
        return o.to(q.dtype).contiguous(), lse
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    ds = p * (torch.einsum("nqhd,nkhd->nhqk", dof, v.float())
              - delta[..., None])
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k.float()) / math.sqrt(D)
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q.float()) / math.sqrt(D)
    dv = torch.einsum("nhqk,nqhd->nkhd", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@contextlib.contextmanager
def planted_k3(fault, S: int, device):
    """While open, the K3 kernel named ``fault`` (None: none) is replaced
    by plain attention that skips one tile of its walk
    (``planted_drops``); the autograd function and every caller reach the
    replacement."""
    from commefficient_torch.ops import flash_attention as FA
    saved = FA.forward, FA.backward_dq, FA.backward_dkv
    if fault is not None:
        drop = planted_drops(S, device)[fault]
    if fault == "flash_fwd":
        FA.forward = lambda q, k, v: attention_skipping(q, k, v, drop)
    elif fault == "flash_bwd_dq":
        FA.backward_dq = lambda q, k, v, o, lse, do: (
            attention_skipping(q, k, v, drop, do, lse,
                               plain_delta(o, do))[0],
            plain_delta(o, do))
    elif fault == "flash_bwd_dkv":
        FA.backward_dkv = lambda q, k, v, do, lse, delta: \
            attention_skipping(q, k, v, drop, do, lse, delta)[1:]
    try:
        yield
    finally:
        FA.forward, FA.backward_dq, FA.backward_dkv = saved


def qkv_blocks(model, g) -> dict:
    """Each layer's q, k and v column blocks of the c_attn kernel's
    gradient in the flat gradient ``g`` (what dq, dk and dv feed), as
    float32 copies."""
    c = model.views(g)["transformer/h/block/c_attn/kernel"]
    E = c.shape[1]
    return {f"layer {i} {name}": c[i, :, j * E:(j + 1) * E].float().clone()
            for i in range(c.shape[0]) for j, name in enumerate("qkv")}


def worst_block_error(got: dict, ref: dict) -> float:
    """The largest relative L2 error of a block of ``got`` against
    ``ref``."""
    return max(float((got[key].float() - r.float()).norm() / r.float().norm())
               for key, r in ref.items())


def same_bits(a, b) -> bool:
    """Bitwise equality of two float32 tensors (int32 views: -0 differs
    from +0), NaN counted by position only: the card's float units return
    one canonical NaN, where a sign xor keeps a NaN's payload."""
    import torch
    nan = torch.tensor(float("nan"), device=a.device)
    a = torch.where(torch.isnan(a), nan, a)
    b = torch.where(torch.isnan(b), nan, b)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def sketch_launches(rounds: int, k1: int = 9, k2: int = 1,
                    cells: int = 1) -> dict:
    """The ``circulant_kernels.launches`` of ``rounds`` rounds that each
    launch ``k1`` K1, ``k2`` K2 and ``cells`` cell sums (the headline's
    sketch round: 9, 1 and 1; the subtract rule 2 cell sums, a dense
    server state or the SRHT none)."""
    return {"circ_encode": k1 * rounds, "circ_decode": k2 * rounds,
            "cell_sum": cells * rounds}


def nonzero(counts: dict) -> dict:
    """The entries of a launch count that are not 0."""
    return {name: n for name, n in counts.items() if n}


def zeroed_table(r: int, c: int, seed: int):
    """A seeded (r, c) table as the server's zero rule leaves one: about
    half its cells 0, some -0, and a few NaN (numpy, on the CPU)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    table = rng.randn(r, c).astype(np.float32)
    table[rng.rand(r, c) < 0.5] = 0.0
    table[rng.rand(r, c) < 0.05] = -0.0
    table[rng.rand(r, c) < 0.002] = np.nan
    return table


def tie_heavy_sparse(d: int, k: int, seed: int, specials: bool = True,
                     one=None):
    """A seeded sparse vector ``(idx (k,) int64, vals (k,) float32)`` whose
    re-encode's cell sums depend on their order (numpy, on the CPU):
    ``one`` addends (a quarter by default) on one coordinate (one cell in
    every row), pairs (x, -x) on one coordinate each, which cancel to
    exactly +0.0 and so decide the zero rule's mask (in another order,
    x + y - x - y need not be 0 where two pairs collide), -0.0 as the
    first addend of two coordinates (alone: +0.0, as a sum from +0.0
    gives), and with ``specials`` inf, -inf and NaN addends; the rest
    shuffled."""
    import numpy as np
    rng = np.random.RandomState(seed)
    coords = rng.permutation(d)
    n_one, n_pairs = (k // 4 if one is None else one), k // 4
    rest = k - n_one - 2 * n_pairs - 3
    one = np.full(n_one, coords[0])
    pairs = np.repeat(coords[1:1 + n_pairs], 2)
    singles = coords[1 + n_pairs:1 + n_pairs + rest]
    x = rng.randn(n_pairs).astype(np.float32)
    idx = np.concatenate([one, pairs, singles])
    vals = np.concatenate([rng.randn(n_one).astype(np.float32),
                           np.stack([x, -x], 1).reshape(-1),
                           rng.randn(rest).astype(np.float32)])
    if specials:
        vals[n_one + 2 * n_pairs:n_one + 2 * n_pairs + 3] = [np.inf, -np.inf,
                                                            np.nan]
    # shuffle whole pairs and single addends, keeping each pair in order
    units = ([[i] for i in range(n_one)]
             + [[n_one + 2 * j, n_one + 2 * j + 1] for j in range(n_pairs)]
             + [[i] for i in range(n_one + 2 * n_pairs, len(idx))])
    order = [i for u in rng.permutation(len(units)) for i in units[u]]
    # -0.0 first, on the last spare coordinate alone and on the one cell's
    # coordinate before its other addends
    lone = coords[1 + n_pairs + rest]
    idx = np.concatenate([[lone, coords[0]], idx[order], [lone]])
    vals = np.concatenate([[-0.0, -0.0], vals[order], [-0.0]]).astype(
        np.float32)
    return idx.astype(np.int64), vals


# the numpy twins of the native host gather against its library: the
# unfused x / 255 is rounded once more, by at most half an ulp of 1.0
# (2^-24), which 1 / std (at most 4.3 for the CIFAR and ImageNet
# constants) scales, plus an ulp of the result
NATIVE_PLAIN_ATOL = 2.0 ** -21


def _splitmix64(x):
    import numpy as np
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _native_normalize_plain(px, mean, std):
    import numpy as np
    stdinv = np.float32(1.0) / np.asarray(std, np.float32)
    return ((px.astype(np.float32) * (np.float32(1.0) / np.float32(255.0))
             - np.asarray(mean, np.float32)) * stdinv)


def native_gather_augment_plain(images, idx, mean, std, pad: int,
                                flip: bool, seed: int):
    """``data/native.gather_augment`` in numpy: the library's splitmix64
    draws, its index arithmetic (the flip mirrors the column before the
    reflect-padded shift) and its float32 operations, unfused: within
    NATIVE_PLAIN_ATOL of the library."""
    import numpy as np
    flat = np.asarray(idx, np.int64).reshape(-1)
    n = flat.size
    h, w = images.shape[1:3]
    items = np.arange(n, dtype=np.uint64)
    r = _splitmix64(np.uint64(seed)
                    ^ (items * np.uint64(0x2545F4914F6CDD1D)))
    dy = dx = np.zeros(n, np.int64)
    if pad > 0:
        span = np.uint64(2 * pad + 1)
        dy = (r % span).astype(np.int64) - pad
        r = _splitmix64(r)
        dx = (r % span).astype(np.int64) - pad
        r = _splitmix64(r)
    do_flip = ((r & np.uint64(1)).astype(bool) if flip
               else np.zeros(n, bool))

    def reflect(i, m):
        i = np.abs(i)
        return np.where(i >= m, 2 * m - 2 - i, i)

    xs = np.arange(w)
    cols = np.where(do_flip[:, None], w - 1 - xs, xs)
    rows = reflect(np.arange(h)[None, :] + dy[:, None], h)
    cols = reflect(cols + dx[:, None], w)
    px = images[flat[:, None, None], rows[:, :, None], cols[:, None, :]]
    return _native_normalize_plain(px, mean, std).reshape(
        np.shape(idx) + images.shape[1:])


def native_gather_normalize_plain(images, idx, mean, std):
    """``data/native.gather_normalize`` in numpy, unfused."""
    import numpy as np
    flat = np.asarray(idx, np.int64).reshape(-1)
    return _native_normalize_plain(images[flat], mean, std).reshape(
        np.shape(idx) + images.shape[1:])


def l2_read_rate(nbytes: int = 4 * 5 * 524_288, passes: int = 64):
    """(TB/s, ms) of ``torch.sum`` over ``passes`` reads of one float32
    buffer of ``nbytes`` that stays in the 50 MB L2 (a stride-0 view
    repeats it): the rate at which a PyTorch reduction reads from L2. It
    is a floor of what L2 can deliver, not its ceiling; the sketch
    kernels' own gather rates are printed beside it."""
    import torch
    buf = torch.randn(nbytes // 4, device="cuda")
    view = buf.expand(passes, buf.numel())
    ms = time_ms(lambda: view.sum())
    return passes * nbytes / (ms * 1e-3) / 1e12, ms


# phase_kernels' seeded vectors on the host by d, each with the state of
# its RandomState after the draw (several shapes share GPT-2's d)
SKETCH_VECTORS = {}


def sketch_vector(d: int):
    """The seeded (d,) float32 vector of ``phase_kernels`` (numpy) and a
    RandomState in the state its draw left, drawn once a run for each d."""
    import numpy as np
    if d not in SKETCH_VECTORS:
        rng = np.random.RandomState(0)
        SKETCH_VECTORS[d] = (rng.randn(d).astype(np.float32),
                             rng.get_state())
    v, state = SKETCH_VECTORS[d]
    rng = np.random.RandomState()
    rng.set_state(state)
    return v, rng


def phase_kernels(shape: dict, cols_list, scale: float, plain_n: int = 20):
    """K1 and K2 against their plain versions at (d, r) of ``shape`` and
    each c of ``cols_list``, bitwise (``same_bits``), K2 also on a table
    with zeroed cells, signed zeros and NaN (``zeroed_table``), and their
    timings at ``shape['c']`` beside their bounds and the L2 read rates
    of ``torch.sum`` and of their r gathers."""
    import numpy as np
    import torch
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops.circulant import make_circulant_sketch

    dev = torch.device("cuda")
    d, c, r = shape["d"], shape["c"], shape["r"]
    v, rng = sketch_vector(d)
    v = torch.from_numpy(v).to(dev)
    t0 = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(dev)
    results = {}

    for cols in cols_list:
        cs = make_circulant_sketch(d, cols, r, device=dev)
        m = cs.m
        args = (cs.shifts, cs.sign_keys, cols, r, m)
        tab = t0 if cols == c else torch.from_numpy(
            rng.randn(r, cols).astype(np.float32)).to(dev)
        enc_k = K.encode(v, *args, scale=scale, table=tab.clone())
        enc_p = K.encode_plain(v, *args, scale=scale, table=tab)
        fresh_k = K.encode(v, *args)
        fresh_p = K.encode_plain(v, *args)
        dec_k = K.decode(tab, *args, d)
        dec_p = K.decode_plain(tab, *args, d)
        zt = torch.from_numpy(zeroed_table(r, cols, seed=cols)).to(dev)
        zdec_k = K.decode(zt, *args, d)
        zdec_p = K.decode_plain(zt, *args, d)
        torch.cuda.synchronize()
        if not torch.isfinite(enc_k).all() or dec_k.shape != (d,):
            fail(f"c={cols}: kernel output not finite or misshapen")
        e1 = max(float((enc_k - enc_p).abs().max()),
                 float((fresh_k - fresh_p).abs().max()))
        e2 = float((dec_k - dec_p).abs().max())
        k1_bitwise = same_bits(enc_k, enc_p) and same_bits(fresh_k, fresh_p)
        k2_bitwise = same_bits(dec_k, dec_p)
        k2_zeroed = same_bits(zdec_k, zdec_p)
        zeros = int((zdec_p == 0).sum())
        neg = int(((zdec_p == 0) & torch.signbit(zdec_p)).sum())
        nans = int(torch.isnan(zdec_p).sum())
        print(f"[kernels] c={cols} m={m}: K1 max|diff| {e1} "
              f"(bitwise {k1_bitwise}), K2 max|diff| {e2} "
              f"(bitwise {k2_bitwise}); K2 on a zeroed table ({zeros} "
              f"zero estimates, {neg} of them -0, {nans} NaN): bitwise "
              f"{k2_zeroed}", flush=True)
        if not k1_bitwise:
            fail(f"K1 is not bitwise equal to its plain version at "
                 f"c={cols}: {e1}")
        if not (k2_bitwise and k2_zeroed):
            fail(f"K2 is not bitwise equal to its plain version at "
                 f"c={cols}: randn {k2_bitwise}, zeroed {k2_zeroed}")
        del zt, zdec_k, zdec_p
        if cols == c:
            results["err"] = (e1, e2)
            results["args"] = args

    args = results.pop("args")
    m = args[4]
    acc = t0.clone()
    enc_ms = time_ms(lambda: K.encode(v, *args, scale=scale, table=acc))
    enc_plain_ms = time_ms(
        lambda: K.encode_plain(v, *args, scale=scale, table=acc),
        n=plain_n)
    dec_ms = time_ms(lambda: K.decode(t0, *args, d))
    dec_plain_ms = time_ms(lambda: K.decode_plain(t0, *args, d), n=plain_n)
    l2_tb_s, l2_ms = l2_read_rate()
    gathers = 4 * r * d
    rates = {"circ_encode": gathers / (enc_ms * 1e-3) / 1e12,
             "circ_decode": gathers / (dec_ms * 1e-3) / 1e12}
    print(f"[kernels] L2 reads: torch.sum over 64 reads of a 10.5 MB "
          f"buffer that L2 holds {l2_tb_s:.3f} TB/s ({l2_ms:.4f} ms); the "
          f"r gathers of a call (r 4 d = {gathers / 1e9:.3f} GB, L2 hits) "
          f"ran at {rates['circ_encode']:.3f} TB/s in K1 and "
          f"{rates['circ_decode']:.3f} TB/s in K2: measured floors of the "
          f"L2 read rate, outside the bound", flush=True)

    bounds = {}
    for name, (nbytes, ops, instr) in sketch_work(d, c, r).items():
        bounds[name] = bound(nbytes, ops, H100_FP32_PER_S, instr)
        print(f"[kernels] {name} (d={d}): {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e6:.1f} M fp32 ops, instructions "
              + ", ".join(f"{n / 1e6:.1f} M {p}" for p, n in instr.items())
              + f" -> bound {bounds[name][0] * 1e3:.2f} us "
              f"({bounds[name][1]})")
    print(f"[kernels] circ_encode (accumulate, r={r}, m={m}): kernel "
          f"{enc_ms:.4f} ms, plain {enc_plain_ms:.4f} ms, bound "
          f"{bounds['circ_encode'][0]:.4f} ms "
          f"({bounds['circ_encode'][0] / enc_ms:.1%} of it)")
    print(f"[kernels] circ_decode (r={r}, m={m}): kernel {dec_ms:.4f} ms, "
          f"plain {dec_plain_ms:.4f} ms, bound "
          f"{bounds['circ_decode'][0]:.4f} ms "
          f"({bounds['circ_decode'][0] / dec_ms:.1%} of it)", flush=True)
    e1, e2 = results["err"]
    return {
        "circ_encode": {"max_abs_err": e1, "ms": enc_ms, "kernel_ms": enc_ms,
                        "plain_ms": enc_plain_ms,
                        "bound_ms": bounds["circ_encode"][0],
                        "bound_by": bound_by(bounds["circ_encode"][1]),
                        "library_ms": None, "l2_sum_tb_s": l2_tb_s,
                        "gather_tb_s": rates["circ_encode"]},
        "circ_decode": {"max_abs_err": e2, "ms": dec_ms, "kernel_ms": dec_ms,
                        "plain_ms": dec_plain_ms,
                        "bound_ms": bounds["circ_decode"][0],
                        "bound_by": bound_by(bounds["circ_decode"][1]),
                        "library_ms": None, "l2_sum_tb_s": l2_tb_s,
                        "gather_tb_s": rates["circ_decode"]},
    }


def phase_kernels_rows() -> dict:
    """K1 and K2 at each table of ROWS_SKETCHES (``phase_kernels``:
    bitwise their plain versions, K2 also on the zeroed table with -0 and
    NaN; time, bound and share printed). Returns each table's entries of
    the kernel line."""
    return {name: phase_kernels(shape, (shape["c"],), scale=scale,
                                plain_n=5)
            for name, (shape, scale) in ROWS_SKETCHES.items()}


def flash_inputs(N, S, H, D, seed=0, dtype=None):
    """q, k, v as the three (N, S, H, D) slices of one seeded (N, S, 3HD)
    buffer (the c_attn output's layout) in ``dtype`` (bf16 by default),
    and an output gradient."""
    import numpy as np
    import torch
    dtype = dtype or torch.bfloat16
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(N, S, 3 * H * D).astype(
        np.float32)).to("cuda", dtype)
    do = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32)).to(
        "cuda", dtype)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    return q, k, v, do


def flash_bounds(N, S, H, D, elem: int = 2):
    """(bytes, FLOPs) each K3 kernel must move and do: every input read
    once, every output written once (``elem`` bytes an element: 2 bf16, 4
    float32); 2 D FLOPs per causal (query, key) pair and product
    (forward: q k^T and p v; dq: q k^T, dO v^T, ds k; dk/dv: k q^T, p^T
    dO, v dO^T, ds^T q)."""
    pairs = N * H * S * (S + 1) // 2
    product = 2 * D * pairs
    t = elem * N * S * H * D                   # one (N, S, H, D) operand
    stat = 4 * N * H * S                       # one float32 (N, H, S)
    return {"flash_fwd": (4 * t + stat, 2 * product),
            "flash_bwd_dq": (6 * t + 2 * stat, 3 * product),
            "flash_bwd_dkv": (6 * t + 2 * stat, 4 * product)}


def flash_autograd_check():
    """The autograd function at S = 256: its backward runs on autograd's
    own device thread, where a kernel wrapper may make the thread's first
    CUDA call (this is the process's first backward). Its gradients must
    be bitwise those of the direct kernel calls."""
    import torch
    from commefficient_torch.ops import flash_attention as FA
    q, k, v, do = flash_inputs(*FLASH_SHAPES[1])
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    FA.flash_attention(*leaves).backward(do)
    o, lse = FA.forward(q, k, v)
    dq, delta = FA.backward_dq(q, k, v, o, lse, do)
    dk, dv = FA.backward_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    same = all(torch.equal(t.grad, g) for t, g in zip(leaves, (dq, dk, dv)))
    print(f"[flash] autograd function on its own thread, S = "
          f"{FLASH_SHAPES[1][1]}: gradients bitwise those of the direct "
          f"calls: {same}", flush=True)
    if not same:
        fail("the K3 autograd function's gradients differ from the kernels'")


def phase_flash(shapes=FLASH_SHAPES):
    """K3 against its plain versions at each of ``shapes`` (the main
    path's first), and timings of kernels, plain versions and SDPA at
    each; the kernel line's entries are the first shape's, the others
    under ``at_shapes``."""
    import torch
    import torch.nn.functional as F
    from commefficient_torch.ops import flash_attention as FA

    flash_autograd_check()
    per_shape = {}
    for N, S, H, D in shapes:
        q, k, v, do = flash_inputs(N, S, H, D)
        o, lse = FA.forward(q, k, v)
        dq, delta = FA.backward_dq(q, k, v, o, lse, do)
        dk, dv = FA.backward_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        o_ref, lse_ref = FA.forward_plain(q, k, v)
        refs = dict(zip(("dq", "dk", "dv"),
                        FA.backward_plain(q, k, v, o, lse_ref, do)))
        refs["o"] = o_ref

        def worst(outs):
            """Largest per-row relative error of each output in ``outs``,
            and max|diff| of lse when ``outs`` has it."""
            out = {name: float(row_errors(t, refs[name]).max())
                   for name, t in outs.items() if name != "lse"}
            if "lse" in outs:
                out["lse"] = float((outs["lse"] - lse_ref).abs().max())
            return out

        def passes(errs):
            return all(math.isfinite(e) and e <= (
                FLASH_LSE_ATOL if name == "lse" else FLASH_ROW_RTOL)
                for name, e in errs.items())

        errs = worst({"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv})
        abs_errs = {name: float((t.float() - refs[name].float()).abs().max())
                    for name, t in (("o", o), ("dq", dq), ("dk", dk),
                                    ("dv", dv))}
        print(f"[flash] (N, S, H, D) = {(N, S, H, D)}: worst row error "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (limits {FLASH_ROW_RTOL} of each row's norm, lse "
              f"{FLASH_LSE_ATOL}); max|diff| "
              + ", ".join(f"{n} {e:.3e}" for n, e in abs_errs.items()),
              flush=True)
        if not passes(errs):
            fail(f"K3 disagrees with its plain version at S={S}: {errs}")
        # the check must reject a kernel that skips one tile of its walk
        drops = planted_drops(S, q.device)
        fwd_f = attention_skipping(q, k, v, drops["flash_fwd"])
        faults = {"flash_fwd": {"o": fwd_f[0], "lse": fwd_f[1]},
                  **planted_backward(q, k, v, do, o, lse_ref, drops)}
        for name, outs in faults.items():
            planted = worst(outs)
            print(f"[flash] S={S}, planted fault in {name} (one tile "
                  f"skipped): worst row error {planted}", flush=True)
            if passes(planted):
                fail(f"the K3 check passed a planted fault in {name} at "
                     f"S={S}: {planted}")
        del fwd_f, faults
        # no atomics: a second call repeats every bit
        o2, lse2 = FA.forward(q, k, v)
        dq2, delta2 = FA.backward_dq(q, k, v, o, lse, do)
        dk2, dv2 = FA.backward_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in
                   ((o, o2), (lse, lse2), (dq, dq2), (delta, delta2),
                    (dk, dk2), (dv, dv2)))
        print(f"[flash] S={S}: a second call of each K3 kernel is bitwise "
              f"equal: {same}", flush=True)
        if not same:
            fail(f"a K3 kernel is not deterministic at S={S}")
        del o2, lse2, dq2, delta2, dk2, dv2
        del o_ref, refs
        ms = {"flash_fwd": time_ms(lambda: FA.forward(q, k, v)),
              "flash_bwd_dq": time_ms(
                  lambda: FA.backward_dq(q, k, v, o, lse, do)),
              "flash_bwd_dkv": time_ms(
                  lambda: FA.backward_dkv(q, k, v, do, lse, delta))}
        plain_fwd = time_ms(lambda: FA.forward_plain(q, k, v), n=10)
        plain_bwd = time_ms(lambda: FA.backward_plain(q, k, v, o, lse, do),
                            n=10)
        # the library call, timed here only: SDPA on (N, H, S, D) views
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        sdpa_fwd = time_ms(lambda: sdpa().detach())
        o_s = sdpa()
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            o_s, (qt, kt, vt), dot, retain_graph=True))
        sdpa_both = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), dot))
        err_lib = float((o_s.detach().transpose(1, 2).float()
                         - o.float()).abs().max())
        print(f"[flash] S={S}: kernels fwd {ms['flash_fwd']:.4f} ms, dq "
              f"{ms['flash_bwd_dq']:.4f} ms, dk/dv "
              f"{ms['flash_bwd_dkv']:.4f} ms (fwd+bwd "
              f"{sum(ms.values()):.4f} ms); plain fwd {plain_fwd:.4f} ms, "
              f"bwd {plain_bwd:.4f} ms; SDPA fwd {sdpa_fwd:.4f} ms, bwd "
              f"{sdpa_bwd:.4f} ms, fwd+bwd {sdpa_both:.4f} ms (SDPA vs "
              f"kernel o: max|diff| {err_lib:.3e})", flush=True)
        library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                   "flash_bwd_dkv": sdpa_bwd}
        plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd,
                 "flash_bwd_dkv": plain_bwd}
        row_err = {"flash_fwd": errs["o"], "flash_bwd_dq": errs["dq"],
                   "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
        err = {"flash_fwd": abs_errs["o"], "flash_bwd_dq": abs_errs["dq"],
               "flash_bwd_dkv": max(abs_errs["dk"], abs_errs["dv"])}
        shape = (N, S, H, D)
        per_shape[shape] = {}
        for name, (nbytes, flops) in flash_bounds(N, S, H, D).items():
            b_ms, b_kind = bound(nbytes, flops, H100_BF16_PER_S)
            print(f"[flash] {shape} {name}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP -> bound {b_ms * 1e3:.2f} us "
                  f"({b_kind}); kernel {ms[name] * 1e3:.2f} us = "
                  f"{flops / ms[name] / 1e9:.1f} TFLOP/s")
            per_shape[shape][name] = {
                "max_abs_err": err[name], "ms": ms[name],
                "kernel_ms": ms[name], "plain_ms": plain[name],
                "bound_ms": b_ms, "bound_by": bound_by(b_kind),
                "library_ms": library[name], "max_row_err": row_err[name]}
        del q, k, v, do, o, lse, dq, delta, dk, dv, qt, kt, vt, o_s
        torch.cuda.empty_cache()
    main = shapes[0]
    return {name: {**entry, "at_shapes": {
        "x".join(map(str, shape)): per_shape[shape][name]
        for shape in shapes[1:]}}
        for name, entry in per_shape[main].items()}


def planted_backward(q, k, v, do, o, lse, drops) -> dict:
    """The outputs of a dq kernel and of a dk/dv kernel that each skip one
    tile of their walk (``planted_drops``), from the forward's ``o`` and
    the plain ``lse``: {"flash_bwd_dq": {"dq": ...}, "flash_bwd_dkv":
    {"dk": ..., "dv": ...}}."""
    delta = plain_delta(o, do)
    dq = attention_skipping(q, k, v, drops["flash_bwd_dq"], do, lse,
                            delta)[0]
    _, dk, dv = attention_skipping(q, k, v, drops["flash_bwd_dkv"], do, lse,
                                   delta)
    return {"flash_bwd_dq": {"dq": dq}, "flash_bwd_dkv": {"dk": dk,
                                                          "dv": dv}}


def flash_route_errors(q, k, v, do, got):
    """``(errors, ok)`` of K3's outputs ``got`` (o, and any of lse, dq,
    dk, dv) against the plain versions on the same inputs (the backward's
    from ``got["o"]``, as the kernels' is): bf16 each output row against
    its own norm (FLASH_ROW_RTOL; lse to FLASH_LSE_ATOL), float32 the
    largest difference over the plain output's largest magnitude
    (FLASH_F32_RTOL)."""
    import torch
    from commefficient_torch.ops import flash_attention as FA
    o_ref, lse_ref = FA.forward_plain(q, k, v)
    refs = {"o": o_ref, "lse": lse_ref}
    if set(got) & {"dq", "dk", "dv"}:
        refs.update(zip(("dq", "dk", "dv"), FA.backward_plain(
            q, k, v, got["o"], lse_ref, do)))
    f32 = q.dtype == torch.float32
    errs = {}
    for name, t in got.items():
        ref = refs[name].float()
        if f32:
            errs[name] = float((t.float() - ref).abs().max()
                               / ref.abs().max())
        elif name == "lse":
            errs[name] = float((t - ref).abs().max())
        else:
            errs[name] = float(row_errors(t, ref).max())
    limit = {name: (FLASH_F32_RTOL if f32 else FLASH_LSE_ATOL
                    if name == "lse" else FLASH_ROW_RTOL) for name in errs}
    ok = all(math.isfinite(e) and e <= limit[n] for n, e in errs.items())
    return errs, ok


def sdpa_kernels(dtype, D, sdpa, o_s, leaves, dot):
    """Print the CUDA kernels that one SDPA forward and one backward ran
    (``torch.profiler``): what the tiled routes are timed against."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for part, fn in (("forward", lambda: sdpa().detach()),
                     ("backward", lambda: torch.autograd.grad(
                         o_s, leaves, dot, retain_graph=True))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names[part] = sorted({e.name for e in prof.events()
                              if e.device_type == DeviceType.CUDA})
    print(f"[flash {dtype} D={D}] SDPA's kernels: forward "
          f"{[n[:110] for n in names['forward']]}, backward "
          f"{[n[:110] for n in names['backward']]}", flush=True)
    return names


def phase_flash_routes():
    """Every route but bf16 D = 64's (float32 at D = 16, 32, 64 and 128
    in ``flash_tiled.cu``; bf16 at D = 32 and 128 in
    ``flash_attention.cu``, at D = 16 its forward in ``flash_tiled.cu``
    and its backward in ``flash_attention.cu``) at (8, 1024, 768 / D, D)
    and (8, 256, 768 / D, D), GPT-2 small's width in heads of D: o, lse,
    dq, dk and dv against the plain versions (``flash_route_errors``), a
    second call of each kernel bitwise the first, the same check failing
    a forward that skips one key tile (``planted_drops``) and, for the
    backward kernels of ``flash_attention.cu``, a dq that skips key tile
    0 for the second half's rows and a dk/dv that skips the last query
    tile, and each kernel timed beside its bound, the plain versions and
    SDPA (the library call, timed here only). Returns {kernel name: its
    entry at S = 1024, S = 256's under ``at_shapes``}."""
    import torch
    import torch.nn.functional as F
    from commefficient_torch.ops import flash_attention as FA

    out = {}
    for (dtype, D), r in FA.ROUTES.items():
        if (dtype, D) == (torch.bfloat16, 64):
            continue                    # phase_flash's, at FLASH_SHAPES
        f32 = dtype == torch.float32
        for N, S, H, D in ((8, 1024, 768 // D, D), (8, 256, 768 // D, D)):
            shape = (N, S, H, D)
            q, k, v, do = flash_inputs(N, S, H, D, dtype=dtype)
            o, lse = FA.forward(q, k, v)
            dq, delta = FA.backward_dq(q, k, v, o, lse, do)
            dk, dv = FA.backward_dkv(q, k, v, do, lse, delta)
            torch.cuda.synchronize()
            got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
            errs, ok = flash_route_errors(q, k, v, do, got)
            o2, lse2 = FA.forward(q, k, v)
            dq2, delta2 = FA.backward_dq(q, k, v, o, lse, do)
            dk2, dv2 = FA.backward_dkv(q, k, v, do, lse, delta)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       ((o, o2), (lse, lse2), (dq, dq2), (delta, delta2),
                        (dk, dk2), (dv, dv2)))
            del o2, lse2, dq2, delta2, dk2, dv2
            # the check must reject a forward that skips one key tile,
            # and a wgmma backward kernel that skips one tile of its walk
            drops = planted_drops(S, q.device)
            o_f, lse_f = attention_skipping(q, k, v, drops["flash_fwd"])
            planted, caught = flash_route_errors(q, k, v, do,
                                                 {"o": o_f, "lse": lse_f})
            caught = not caught
            del o_f, lse_f
            if r.sources[1] == FA.SOURCE:
                for fault, outs in planted_backward(
                        q, k, v, do, o, FA.forward_plain(q, k, v)[1],
                        drops).items():
                    errs_f, ok_f = flash_route_errors(
                        q, k, v, do, {"o": o, **outs})
                    planted.update({f"{fault} {n}": e
                                    for n, e in errs_f.items() if n != "o"})
                    caught = caught and not ok_f
            print(f"[flash {dtype} D={D}] {shape}: "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + (f" (largest difference over the largest value, limit "
                     f"{FLASH_F32_RTOL})" if f32 else
                     f" (worst row error, limit {FLASH_ROW_RTOL}; lse "
                     f"{FLASH_LSE_ATOL})")
                  + f"; a second call bitwise: {same}; planted faults (a "
                  f"forward or dq that skips key tile 0 for the second "
                  f"half's rows, a dk/dv that skips the last query tile): "
                  + ", ".join(f"{n} {e:.3e}" for n, e in planted.items())
                  + f" (each rejected: {caught}); libraries "
                  + ", ".join(f"{n} {src}" for n, src in
                              zip(r.names, r.sources)), flush=True)
            if not ok or not same or not caught:
                fail(f"K3 {dtype} D={D} at {shape}: {errs}, deterministic "
                     f"{same}, each planted fault rejected {caught}")
            ms = {r.fwd: time_ms(lambda: FA.forward(q, k, v), n=10),
                  r.dq: time_ms(lambda: FA.backward_dq(q, k, v, o, lse, do),
                                n=10),
                  r.dkv: time_ms(lambda: FA.backward_dkv(q, k, v, do, lse,
                                                         delta), n=10)}
            plain_fwd = time_ms(lambda: FA.forward_plain(q, k, v), n=3)
            plain_bwd = time_ms(
                lambda: FA.backward_plain(q, k, v, o, lse, do), n=3)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)

            sdpa_fwd = time_ms(lambda: sdpa().detach(), n=10)
            o_s = sdpa()
            sdpa_bwd = time_ms(lambda: torch.autograd.grad(
                o_s, (qt, kt, vt), dot, retain_graph=True), n=10)
            plain = {r.fwd: plain_fwd, r.dq: plain_bwd, r.dkv: plain_bwd}
            library = {r.fwd: sdpa_fwd, r.dq: sdpa_bwd, r.dkv: sdpa_bwd}
            err = {r.fwd: errs["o"], r.dq: errs["dq"],
                   r.dkv: max(errs["dk"], errs["dv"])}
            bounds = dict(zip(r.names, flash_bounds(
                N, S, H, D, elem=4 if f32 else 2).values()))
            print(f"[flash {dtype} D={D}] {shape}: kernels "
                  + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items())
                  + f"; plain fwd {plain_fwd:.4f} ms, bwd {plain_bwd:.4f} "
                  f"ms; SDPA fwd {sdpa_fwd:.4f} ms, bwd {sdpa_bwd:.4f} ms",
                  flush=True)
            if S == 1024:
                sdpa_kernels(dtype, D, sdpa, o_s, (qt, kt, vt), dot)
            for name in r.names:
                nbytes, flops = bounds[name]
                # float32: the products at the 3xTF32 rate, the rate the
                # tensor cores give float32-level products at (the FFMA
                # rate's bound printed beside it)
                b_ms, kind = (bound(nbytes, 3 * flops, H100_TF32_PER_S)
                              if f32 else
                              bound(nbytes, flops, H100_BF16_PER_S))
                entry = {"max_abs_err": err[name], "ms": ms[name],
                         "plain_ms": plain[name], "bound_ms": b_ms,
                         "bound_by": bound_by(kind),
                         "library_ms": library[name],
                         "tflops": flops / ms[name] / 1e9}
                ffma_ms = (bound(nbytes, flops, H100_FP32_PER_S)[0]
                           if f32 else None)
                print(f"[flash {dtype} D={D}] {shape} {name}: bound "
                      f"{b_ms:.4f} ms ({kind})"
                      + (f", at the FFMA rate {ffma_ms:.4f} ms" if f32
                         else "")
                      + f"; kernel {ms[name]:.4f} ms = "
                      f"{100 * b_ms / ms[name]:.1f}% of the bound, SDPA "
                      f"{library[name]:.4f} ms", flush=True)
                if S == 1024:
                    out[name] = {**entry, "shape": list(shape),
                                 "at_shapes": {}}
                else:
                    out[name]["at_shapes"]["x".join(map(str, shape))] = entry
            del q, k, v, do, o, lse, dq, delta, dk, dv, qt, kt, vt, o_s
            torch.cuda.empty_cache()
    return out


def phase_small_reference():
    """Narrow ResNet-9 rounds: the card (kernels) against the CPU (plain
    versions), on the float32 wire and on the int8 wire (``--wire_dtype
    int8``, block 256: the rounding draws are the same bits on both
    devices). float32 with TF32 off on the card, so only summation order
    differs: losses to rtol 1e-4, weights to atol 1e-5."""
    import numpy as np
    import torch
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.resnet9 import ResNet9

    with no_tf32():
        ch = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32}
        for wire in ("float32", "int8"):
            cfg = FedConfig(mode="sketch", error_type="virtual",
                            local_momentum=0.0, virtual_momentum=0.9,
                            weight_decay=5e-4, k=200, num_rows=5,
                            num_cols=4096, num_workers=2,
                            local_batch_size=8, compute_dtype="float32",
                            wire_dtype=wire)
            runs = {}
            for device in ("cpu", "cuda"):
                model = ResNet9(channels=ch,
                                generator=torch.Generator().manual_seed(0))
                rt = FedRuntime(cfg, model, make_cv_loss(model, "float32"),
                                device=device)
                st = rt.init_state()
                rng = np.random.RandomState(0)
                losses = []
                for rnd in range(3):
                    batch = {"image": rng.randn(2, 8, 32, 32, 3).astype(
                        np.float32), "target": rng.randint(0, 10, (2, 8))}
                    st, met = rt.round(st, np.arange(2), batch,
                                       np.ones((2, 8), bool),
                                       0.1 * (rnd + 1))
                    losses.append(met["results"][0].cpu().numpy())
                runs[device] = (np.stack(losses),
                                st.ps_weights.cpu().numpy())
            (l_cpu, w_cpu), (l_gpu, w_gpu) = runs["cpu"], runs["cuda"]
            dl = float(np.abs(l_gpu - l_cpu).max())
            dw = float(np.abs(w_gpu - w_cpu).max())
            print(f"[reference] narrow ResNet-9, {wire} wire, 3 rounds, "
                  f"card vs CPU: max|dloss| {dl:.3e}, max|dw| {dw:.3e}",
                  flush=True)
            if not np.allclose(l_gpu, l_cpu, rtol=1e-4, atol=0) \
                    or dw > 1e-5:
                fail(f"the card's rounds on the {wire} wire disagree with "
                     "the CPU's plain rounds")


def narrow_gpt2_batch(rng, W, B, C, S, vocab):
    """W clients x B items of C random token sequences that fill all S
    positions, every position with an LM label, so every attention row and
    tile enters the loss (a synthetic PersonaChat dialogue fills at most
    47 positions; the rest is padding that no loss reads)."""
    import numpy as np
    ids = rng.randint(0, vocab, (W, B, C, S))
    return {"input_ids": ids, "lm_labels": ids,
            "token_type_ids": vocab + 2 + rng.randint(0, 2, (W, B, C, S)),
            "mc_token_ids": np.full((W, B, C), S - 1),
            "mc_label": rng.randint(0, C, (W, B))}


def phase_gpt2_reference():
    """Narrow GPT-2 (2 layers, width 128, 2 heads of 64, S = 128, bf16):
    the card (K3, K1, K2) against the CPU (the plain versions), on
    full-length random token batches. Two readings, each with its limit
    (NARROW_LIMITS): (1) the gradient of one client's loss at the initial
    weights, in each layer's q, k and v column blocks of c_attn (what dq,
    dk and dv feed), as relative L2 errors; (2) three sketch rounds:
    relative loss differences and the cosine of the rounds' weight update
    (w - w0). The frameworks round bf16 at different places, so neither is
    exact. Then the card runs again with a planted fault in each K3 kernel
    (one tile of its walk skipped, ``planted_drops``), and the check must
    reject each."""
    import numpy as np
    import torch
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_gpt2_train_loss
    from commefficient_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
    from commefficient_torch.ops import flash_attention as FA

    S, W, B, C = 128, 2, 2, 2
    gcfg = GPT2Config(vocab_size=8192, n_positions=S, n_embd=128,
                      n_layer=2, n_head=2)
    cfg = FedConfig(model="GPT2", dataset_name="PERSONA", mode="sketch",
                    error_type="virtual", local_momentum=0.0,
                    virtual_momentum=0.9,
                    weight_decay=5e-4, k=2000, num_rows=5, num_cols=65536,
                    num_workers=W, local_batch_size=B, attn_impl="flash",
                    max_seq_len=S)
    rng = np.random.RandomState(0)
    batches = [narrow_gpt2_batch(rng, W, B, C, S, gcfg.vocab_size)
               for _ in range(3)]

    def run(device, fault=None):
        """(c_attn gradient blocks, (3, W) losses, update, K3 launches of
        the rounds) with ``fault`` planted in that K3 kernel."""
        with planted_k3(fault, S, device):
            model = GPT2DoubleHeads(gcfg, attn_impl="flash",
                                    generator=torch.Generator().manual_seed(0))
            loss_fn = make_gpt2_train_loss(model)
            rt = FedRuntime(cfg, model, loss_fn, device=device)
            st = rt.init_state()
            w0 = st.ps_weights.clone()
            w = w0.clone().requires_grad_(True)
            loss, _ = loss_fn(w, {key: val[0] for key, val in
                                  rt.to_device(batches[0]).items()},
                              torch.ones(B, dtype=torch.bool, device=device))
            (g,) = torch.autograd.grad(loss, w)
            blocks = {key: b.cpu() for key, b in qkv_blocks(model, g).items()}
            FA.reset_launches()
            losses = []
            for rnd, batch in enumerate(batches):
                st, met = rt.round(st, np.arange(W), batch,
                                   np.ones((W, B), bool), 0.16)
                losses.append(met["results"][0].cpu().numpy())
            return (blocks, np.stack(losses),
                    (st.ps_weights - w0).cpu().numpy(), dict(FA.launches))

    g_cpu, l_cpu, u_cpu, n_cpu = run("cpu")

    def readings(result):
        g, l, u, _ = result
        grad = worst_block_error(g, g_cpu)
        cos = float(u @ u_cpu / (np.linalg.norm(u) * np.linalg.norm(u_cpu)))
        dloss = float(np.abs(l / l_cpu - 1).max())
        return {"grad": grad, "dloss": dloss, "cos": cos}

    def passes(r):
        lim = NARROW_LIMITS
        return (r["grad"] <= lim["grad"] and r["dloss"] <= lim["dloss"]
                and r["cos"] >= lim["cos"])

    sound = run("cuda")
    read = readings(sound)
    print(f"[reference] narrow GPT-2, card (bf16, K3) vs CPU (bf16, plain): "
          f"c_attn q/k/v gradient error {read['grad']:.3e}, 3 rounds: max "
          f"relative dloss {read['dloss']:.3e}, update cosine "
          f"{read['cos']:.6f} (limits {NARROW_LIMITS}); K3 launches of the "
          f"rounds on the card {sound[3]}", flush=True)
    faults = {}
    for fault in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        faults[fault] = readings(run("cuda", fault))
        print(f"[reference] narrow GPT-2 with a planted fault in {fault}: "
              f"{faults[fault]}", flush=True)
    if nonzero(n_cpu) or nonzero(sound[3]) != dict.fromkeys(
            HOPPER_KERNELS, 3 * W * gcfg.n_layer):
        fail(f"narrow GPT-2: unexpected K3 launches {n_cpu} / {sound[3]}")
    if not np.isfinite(sound[1]).all() or not passes(read):
        fail(f"the card's GPT-2 gradient or rounds disagree with the CPU's "
             f"plain ones: {read}")
    passed = [fault for fault, r in faults.items() if passes(r)]
    if passed:
        fail(f"the narrow GPT-2 check passed planted faults in {passed}")


# the K3 routes on the port's GPT-2 paths (phase_gpt2_routes): GPT2Config.
# small under gpt2_train --test (2 layers, 4 heads of D = 16, bf16) with
# SMALL_ROUTE_WORKERS clients a round, so each round launches n_layer x
# clients of each kernel of the bf16 D = 16 route; and, for the routes
# that no gpt2_train configuration reaches, GPT2DoubleHeads at GPT-2
# small's width (768) in heads of D, (dtype, D, layers): the bf16 forms
# whose backward is flash_attention.cu's templates at GPT-2 small's full
# depth (D = 16 also, beside its GPT2Config.small round), the float32 ones
# at 2 layers, each step a training-loss forward and backward of (2, 2,
# 1024) tokens, MODEL_ROUTE_STEPS of them (the first warms up)
SMALL_ROUTE_WORKERS = 4
SMALL_ROUTE_ROUNDS = 2
MODEL_ROUTE_FORMS = (("bfloat16", 16, 12), ("bfloat16", 32, 12),
                     ("bfloat16", 128, 12), ("float32", 16, 2),
                     ("float32", 32, 2), ("float32", 128, 2))
MODEL_ROUTE_STEPS = 3
# K3's kernel functions in either library, as the profiler names them
K3_KERNEL_NAMES = re.compile(r"(flash_fwd|flash_bwd_dq|flash_bwd_dkv|"
                             r"(fwd|dq|dkv)_(bf16|f32))_kernel")


def phase_gpt2_routes():
    """K3's new routes on the port's GPT-2 paths, each with every launch
    count set to 0 just before it and read just after: (1) ``gpt2_train
    --compute_dtype float32`` at GPT-2 small's width and S = 1024 with the
    default ``--attn_impl auto`` (``phase_gpt2_main``: each of
    GPT2_ROUNDS rounds exactly 96 of each float32 D = 64 kernel and no
    other K3 kernel, each validation batch GPT2_VAL_FWD forwards, finite
    losses, the peak memory); (2) ``gpt2_train --test --attn_impl flash
    --max_seq_len 128`` (``GPT2Config.small``: bf16, D = 16), every round
    2 x SMALL_ROUTE_WORKERS of each bf16 D = 16 kernel and no other; (3)
    each of MODEL_ROUTE_FORMS through ``GPT2DoubleHeads`` and its
    training loss (``model_route_steps``), every step n_layer launches of
    each of the form's kernels, a finite loss and gradient. Returns
    ({path: launches}, {path: (median round or step ms, peak bytes)})."""
    import numpy as np
    import torch
    from commefficient_torch import gpt2_train
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops import flash_attention as FA

    paths, runs = {}, {}
    f32 = FA.route(torch.float32, 64)
    rounds, val, ms, info = phase_gpt2_main(
        ["--compute_dtype", "float32"], GPT2_ROUNDS, k3=f32.names)
    tag = "gpt2_train --compute_dtype float32"
    paths[tag] = {n: rounds[n] + val[n] for n in rounds}
    runs[tag] = (ms, info["peak"])

    small = FA.route(torch.bfloat16, 16)
    argv = ["--test", "--attn_impl", "flash", "--max_seq_len", "128",
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", str(SMALL_ROUTE_WORKERS), "--local_batch_size",
            "2", "--num_rounds", str(SMALL_ROUTE_ROUNDS),
            *dataset_flags("persona_small")]
    print("[routes] python -m commefficient_torch.gpt2_train "
          + " ".join(argv), flush=True)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    FA.reset_launches()
    with LaunchSplit(gpt2_train.kernel_launches) as split:
        out = entry_main(gpt2_train, argv)
    total = gpt2_train.kernel_launches()
    want = dict.fromkeys(small.names, 2 * SMALL_ROUTE_WORKERS)
    per_round = [nonzero({n: c[n] for n in FA.launches})
                 for c in split.calls["round"]]
    per_val = [set(nonzero({n: c[n] for n in FA.launches}))
               for c in split.calls["val"]]
    if out["rounds"] != SMALL_ROUTE_ROUNDS or \
            not np.isfinite(out["losses"]).all() or \
            any(r != want for r in per_round) or \
            any(v - {small.fwd} for v in per_val):
        fail(f"gpt2_train --test --attn_impl flash: {out['rounds']} rounds,"
             f" losses {out['losses']}, K3 launches a round {per_round} "
             f"(want {want}), a validation batch {per_val}")
    tag = "gpt2_train --test --attn_impl flash --max_seq_len 128"
    paths[tag] = total
    runs[tag] = (statistics.median(out["round_s"]) * 1e3,
                 torch.cuda.max_memory_allocated())
    print(f"[routes] {tag}: {SMALL_ROUTE_ROUNDS} rounds, losses "
          f"{[round(float(x), 5) for x in out['losses']]}, K3 a round "
          f"{per_round[0]}, the run's K3 {nonzero(total)}", flush=True)

    for dtype_name, D, n_layer in MODEL_ROUTE_FORMS:
        tag, launches, step_ms, peak, _ = model_route_steps(
            getattr(torch, dtype_name), D, n_layer)
        paths[tag] = launches
        runs[tag] = (step_ms, peak)
    return paths, runs


def model_route_steps(dtype, D: int, n_layer: int,
                      steps: int = MODEL_ROUTE_STEPS, profile: bool = False):
    """``GPT2DoubleHeads`` at GPT-2 small's width (768) in heads of D,
    ``n_layer`` layers, flash attention in ``dtype``: ``steps`` training
    loss forwards and backwards of one seeded (2, 2, 1024) batch, K3's
    counts set to 0 just before each step and read just after. Fails
    unless every step launches exactly n_layer of each of the form's
    kernels and no other, with a finite loss and gradient. With
    ``profile``, one more step under ``torch.profiler``: its device busy
    time (the union of its kernels' intervals) and its K3 kernels' sum,
    in ms. Returns (tag, the launches of all steps, the median host ms of
    the steps after the first, the peak bytes, the profiled step's
    {"busy_ms", "k3_ms"} or None)."""
    import numpy as np
    import torch
    from commefficient_torch import profile_round
    from commefficient_torch.losses import make_gpt2_train_loss
    from commefficient_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
    from commefficient_torch.ops import flash_attention as FA

    r = FA.route(dtype, D)
    dtype_name = str(dtype).split(".")[-1]
    gcfg = GPT2Config(vocab_size=8192, n_embd=768, n_layer=n_layer,
                      n_head=768 // D, compute_dtype=dtype)
    model = GPT2DoubleHeads(gcfg, attn_impl="flash",
                            generator=torch.Generator().manual_seed(0)
                            ).cuda()
    batch = {key: torch.from_numpy(val[0]).long().cuda()
             for key, val in narrow_gpt2_batch(
                 np.random.RandomState(7), 1, 2, 2, 1024,
                 gcfg.vocab_size).items()}
    w = model.flat.detach().clone().requires_grad_(True)
    loss_fn = make_gpt2_train_loss(model)
    mask = torch.ones(2, dtype=torch.bool, device="cuda")
    tag = (f"GPT2DoubleHeads {dtype_name} D={D} (768 wide, "
           f"{gcfg.n_head} heads, {n_layer} layers)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = dict.fromkeys(FA.launches, 0)
    times, losses, busy = [], [], None

    def step():
        loss, _ = loss_fn(w, batch, mask)
        return loss, torch.autograd.grad(loss, w)[0]

    for i in range(steps + int(profile)):
        FA.reset_launches()
        if i < steps:
            t0 = time.perf_counter()
            loss, g = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        else:
            out = []
            _, kernels, _ = profile_round._profiled(
                lambda: out.extend(step()))
            loss, g = out
            busy = {"busy_ms": profile_round._busy_us(
                [(e.time_range.start, e.time_range.end)
                 for e in kernels]) / 1e3,
                "k3_ms": sum(e.time_range.end - e.time_range.start
                             for e in kernels
                             if K3_KERNEL_NAMES.search(e.name)) / 1e3}
        launches = dict(FA.launches)
        loss = float(loss.detach())
        losses.append(loss)
        finite = bool(torch.isfinite(g).all())
        if nonzero(launches) != dict.fromkeys(r.names, n_layer) or \
                not math.isfinite(loss) or not finite:
            fail(f"{tag}: loss {loss}, gradient finite {finite}, launches "
                 f"{nonzero(launches)}")
        for n, c in launches.items():
            total[n] += c
        del g
    step_ms = statistics.median(times[1:]) if steps > 1 else times[0]
    print(f"[routes] {tag}: losses {[round(x, 5) for x in losses]}, "
          f"gradient finite, K3 a step {nonzero(launches)}, steps (ms) "
          + ", ".join(f"{t:.1f}" for t in times)
          + f": median after the first {step_ms:.3f} ms"
          + (f"; a profiled step: device busy {busy['busy_ms']:.3f} ms, "
             f"K3 {busy['k3_ms']:.3f} ms" if busy else ""), flush=True)
    peak = torch.cuda.max_memory_allocated()
    del model, w, batch
    torch.cuda.empty_cache()
    return tag, total, step_ms, peak, busy


# where the phases' CIFAR directories are written (a temporary directory
# that main() makes and removes)
DATA_ROOT = {"path": None}
# the script's start (perf_counter), for the [time] lines
T0 = {"t": None}


def time_done(phase: str) -> None:
    print(f"[time] {phase} done at {time.perf_counter() - T0['t']:.1f} s",
          flush=True)


def dataset_flags(name: str):
    """``--dataset_dir`` of a directory of its own under the run's data
    root (each synthetic size is prepared in its own)."""
    return ["--dataset_dir", os.path.join(DATA_ROOT["path"], name)]


# the telemetry streams of the run's entry-point calls, {logdir: tag}:
# every call writes its stream under the run's data root (``--logdir``),
# never into the checkout
LOGDIRS = {}


def logdir_flags(tag: str):
    """``--logdir`` of a directory of its own under the run's data root
    for one entry-point call's stream (registered in LOGDIRS)."""
    name = "".join(ch if ch.isalnum() else "_" for ch in tag)
    path = os.path.join(DATA_ROOT["path"], "logs",
                        f"{len(LOGDIRS):03d}_{name}")
    LOGDIRS[path] = tag
    return ["--logdir", path]


def entry_main(module, argv, tag: str = "run"):
    """``module.main(argv)`` (``cv_train`` or ``gpt2_train``) with its
    telemetry stream under the run's data root, unless argv names a
    ``--logdir``."""
    argv = list(argv)
    if "--logdir" not in argv:
        argv += logdir_flags(tag)
    return module.main(argv)


def read_stream(logdir: str, tag: str):
    """The events of ``logdir``'s telemetry.jsonl, which must exist and
    pass the port's validator (a stream that disabled itself fails)."""
    from commefficient_torch.telemetry import validate_file
    path = os.path.join(logdir, "telemetry.jsonl")
    if not os.path.exists(path):
        fail(f"{tag}: no telemetry stream at {path}")
    problems = validate_file(path)
    if problems:
        fail(f"{tag}: the stream {path} fails the validator: "
             f"{problems[:5]}")
    return [json.loads(line) for line in open(path) if line.strip()]


def kinds_of(events) -> dict:
    out = {}
    for e in events:
        out[e["event"]] = out.get(e["event"], 0) + 1
    return out


MAIN_ARGV = ["--dataset_name", "CIFAR10", "--model", "ResNet9",
             "--mode", "sketch", "--error_type", "virtual",
             "--local_momentum", "0", "--virtual_momentum", "0.9", "--num_workers", "8",
             "--local_batch_size", "64", "--k", "50000", "--num_rows", "5",
             "--num_cols", "500000"]


def phase_main_path(extra=()):
    """Full-width rounds through the user's entry point; ``extra`` flags
    (``--no_track_bytes``) after the main path's. Returns the launches and
    the median round time (ms)."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.ops import circulant_kernels as K

    argv = MAIN_ARGV + dataset_flags("synthetic64") + [
        "--num_rounds", str(ROUNDS), *extra]
    tag = " ".join(extra) or "bytes on"
    print("[main] python -m commefficient_torch.cv_train " + " ".join(argv),
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    out = entry_main(cv_train, argv)
    launches = dict(K.launches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if out["rounds"] != ROUNDS or out["summary"] is None:
        fail(f"ran {out['rounds']} rounds (summary {out['summary']}), "
             f"wanted {ROUNDS}")
    if not np.isfinite(out["losses"]).all() or \
            not math.isfinite(out["val_loss"]):
        fail(f"non-finite losses {out['losses']} / {out['val_loss']}")
    if launches != sketch_launches(ROUNDS):
        fail(f"launches {launches}: want 9 encode, 1 decode and 1 cell sum "
             "per round")
    rt = statistics.median(out["round_s"][1:])
    print(f"[main] {tag}: {ROUNDS} rounds: median of rounds 2-{ROUNDS} "
          f"(the first pays one-time set-up) {rt * 1e3:.3f} ms "
          f"(all: {[round(t * 1e3, 3) for t in out['round_s']]}), "
          f"{8 * 64 / rt:.1f} img/s, peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}", flush=True)
    return launches, rt * 1e3


# the single-device round in every mode at ResNet-9's full width: 100
# clients of 64 synthetic images, 8 a round; (flags, K1, K2 and cell-sum
# launches a round). K1: the fused step's W x (64 / 16) microbatches +
# weight decay, or the unfused path's one encode of the summed gradient;
# the cell sum: the zero rule's sparse re-encode once, the subtract
# rule's twice (the update and the velocity's estimates).
MODE_ROUNDS = 3
MODE_COMMON = ["--dataset_name", "CIFAR10", "--model", "ResNet9",
               "--error_type", "virtual", "--local_momentum", "0",
               "--num_clients", "100", "--synthetic_per_class", "640",
               "--num_workers", "8", "--local_batch_size", "64",
               "--k", "50000", "--num_rows", "5", "--num_cols", "500000",
               "--valid_batch_size", "400", "--num_rounds", str(MODE_ROUNDS)]
MODE_CONFIGS = {
    "uncompressed": (["--mode", "uncompressed", "--error_type", "none",
                      "--virtual_momentum", "0.9"], 0, 0, 0),
    "true_topk": (["--mode", "true_topk", "--virtual_momentum", "0.9"],
                  0, 0, 0),
    "local_topk": (["--mode", "local_topk", "--error_type", "local",
                    "--local_momentum", "0.9"], 0, 0, 0),
    "fedavg": (["--mode", "fedavg", "--error_type", "none",
                "--local_batch_size", "-1", "--fedavg_batch_size", "64"],
               0, 0, 0),
    "sketch_subtract": (["--mode", "sketch", "--virtual_momentum", "0.9",
                         "--sketch_ef", "subtract", "--microbatch_size",
                         "16"], 8 * 4 + 1, 1, 2),
    "sketch_unfused": (["--mode", "sketch", "--virtual_momentum", "0.9",
                        "--sketch_fused_encode", "off"], 1, 1, 1),
}
# the client and server rules of this slice at the same widths (100
# clients: --topk_down holds a row of weights for each). K1 as the JAX
# package routes them under its default telemetry, whose per-client
# gradient statistics take every per-client arm off the fused encode: the
# table clip encodes each client's dense gradient (8), --topk_down, the
# dense clip and DP encode the round's dense sum once, the dense server
# state its (d,) error once; with --no_client_stats the table clip streams
# each client's microbatch and its weight-decay term into its own table (8
# x 2, the fused per-client route, kept held); hash and rht launch none.
# The cell sum: once a round where the server keeps the table (hash too),
# none under the dense server state or the SRHT.
SKETCH_FLAGS = ["--mode", "sketch", "--virtual_momentum", "0.9"]
RULE_CONFIGS = {
    "clip": (SKETCH_FLAGS + ["--max_grad_norm", "1"], 8, 1, 1),
    "clip_no_client_stats": (SKETCH_FLAGS + ["--max_grad_norm", "1",
                                             "--no_client_stats"], 16, 1,
                             1),
    "dense_clip": (SKETCH_FLAGS + ["--sketch_dense_clip",
                                   "--max_grad_norm", "1"], 1, 1, 1),
    "dense_state": (SKETCH_FLAGS + ["--sketch_server_state", "dense"], 1, 1,
                    0),
    "dp_worker": (SKETCH_FLAGS + ["--dp", "--l2_norm_clip", "1",
                                  "--noise_multiplier", "0.1"], 1, 1, 1),
    "dp_server_uncompressed": (["--mode", "uncompressed", "--error_type",
                                "none", "--dp", "--dp_mode", "server",
                                "--noise_multiplier", "0.1"], 0, 0, 0),
    "topk_down": (SKETCH_FLAGS + ["--topk_down"], 1, 1, 1),
    "hash": (SKETCH_FLAGS + ["--sketch_impl", "hash", "--num_cols",
                             "500000", "--num_blocks", "20"], 0, 0, 1),
    "hash_dense_state": (SKETCH_FLAGS + ["--sketch_impl", "hash",
                                         "--num_cols", "500000",
                                         "--num_blocks", "20",
                                         "--sketch_server_state", "dense"],
                         0, 0, 0),
    "rht": (SKETCH_FLAGS + ["--sketch_impl", "rht", "--num_rows", "5",
                            "--num_cols", "1313728"], 0, 0, 0),
}


class RoundRecorder:
    """Wraps ``FedRuntime.round`` while installed: keeps each round's
    participants, the byte state its download count reads (cloned before
    the round) and its metrics, so the counts can be recounted plainly
    after the run."""

    def __init__(self):
        from commefficient_torch.core.runtime import FedRuntime
        self.cls, self.orig, self.rounds = FedRuntime, FedRuntime.round, []

    def __enter__(self):
        import numpy as np
        import torch
        orig, rounds = self.orig, self.rounds

        def round(rt, state, client_ids, batch, mask, lr, **kw):
            ids = torch.as_tensor(np.asarray(client_ids), device=rt.device)
            before = None
            if rt.cfg.track_bytes:
                before = (state.coord_last_update.clone(),
                          state.client_last_round[ids].clone())
            new, metrics = orig(rt, state, client_ids, batch, mask, lr,
                                **kw)
            rounds.append((rt.cfg, ids, before, metrics))
            return new, metrics

        self.cls.round = round
        return self

    def __exit__(self, *exc):
        self.cls.round = self.orig

    def check_bytes(self, label: str, want_up=None) -> int:
        """Upload bytes ``want_up`` (default 4 x upload_floats, the
        float32 wire) for each participant and 0 for the others; download
        bytes 4 x a plain recount on the card, ``(coord_last_update >=
        t).sum()``. Returns the rounds checked."""
        import torch
        for cfg, ids, (cul, thr), m in self.rounds:
            up, down = m["upload_bytes"], m["download_bytes"]
            want = 4.0 * cfg.upload_floats if want_up is None else want_up
            plain = torch.stack([(cul >= t).sum() for t in thr])
            others = torch.ones_like(up, dtype=torch.bool)
            others[ids] = False
            if not (torch.equal(up[ids], torch.full_like(up[ids], want))
                    and not up[others].any() and not down[others].any()
                    and torch.equal(down[ids], 4.0 * plain.float())):
                fail(f"{label}: byte accounting disagrees: up {up[ids]}, "
                     f"want {want}; down {down[ids]}, plain {4 * plain}")
        return len(self.rounds)


def phase_modes(configs=None, tag: str = "modes"):
    """``cv_train`` on the card in every configuration of ``configs``
    (default ``MODE_CONFIGS``) at ResNet-9's full width, MODE_ROUNDS
    rounds each: finite losses, the exact K1, K2 and cell-sum launches a
    round, and the bytes (``RoundRecorder``). Returns {name: (launches, median round
    ms)}."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.ops import circulant_kernels as K

    out_modes = {}
    for mode, (flags, n_enc, n_dec, n_cell) in (configs
                                                or MODE_CONFIGS).items():
        argv = MODE_COMMON + dataset_flags("synthetic640") + flags
        print(f"[{tag}] python -m commefficient_torch.cv_train "
              + " ".join(argv), flush=True)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        with RoundRecorder() as rec:
            out = entry_main(cv_train, argv)
        launches = dict(K.launches)
        peak = torch.cuda.max_memory_allocated()
        if out["rounds"] != MODE_ROUNDS or out["summary"] is None \
                or not np.isfinite(out["losses"]).all():
            fail(f"{mode}: {out['rounds']} rounds, losses {out['losses']}, "
                 f"summary {out['summary']}")
        want = sketch_launches(MODE_ROUNDS, n_enc, n_dec, n_cell)
        if launches != want:
            fail(f"{mode}: launches {launches}, want {want}")
        checked = rec.check_bytes(mode)
        rt = statistics.median(out["round_s"][1:])
        print(f"[{tag}] {mode}: median of rounds 2-{MODE_ROUNDS} "
              f"{rt * 1e3:.3f} ms (all: "
              f"{[round(t * 1e3, 3) for t in out['round_s']]}), "
              f"losses {[round(float(x), 5) for x in out['losses']]}, "
              f"launches {launches}, bytes of {checked} rounds held to the "
              f"plain recount, {out['total_upload_mib']:.3f} MiB up and "
              f"{out['total_download_mib']:.3f} MiB down, peak memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
        out_modes[mode] = (launches, rt * 1e3)
        del out, rec
        torch.cuda.empty_cache()
    return out_modes


def phase_nan_abort():
    """A planted NaN: the main path's second round reads a NaN pixel in
    one client's batch, planted in what the device store hands the
    driver. The round must set ``nan_round`` to 1 on the device, and the
    driver must stop at that epoch's end (each round is an epoch here)
    without validating it. Returns the K1/K2 launches."""
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.config import parse_known
    from commefficient_torch.core import driver
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.utils.schedules import lr_schedule_for

    ns = parse_known(cv_train.build_parser(),
                     MAIN_ARGV + dataset_flags("synthetic64"))
    runtime, state, train_ds, val_ds = cv_train.setup(ns)[:4]
    train_store, val_store = cv_train.make_stores(runtime, train_ds, val_ds)
    if train_store is None:
        fail("the main path's rounds are not fed by the device store")
    draw, calls = train_store.round_batch, []

    def planted(idx, round_index=None):
        batch = draw(idx, round_index)
        calls.append(round_index)
        if len(calls) == 2:
            batch["image"][3, 0, 0, 0, 0] = float("nan")
        return batch

    train_store.round_batch = planted
    K.reset_launches()
    state, summary, log = driver.train(runtime, state, train_ds, val_ds,
                                       lr_schedule_for(runtime.cfg),
                                       num_rounds=4, train_store=train_store,
                                       val_store=val_store)
    launches = dict(K.launches)
    nan_round = int(state.nan_round)
    print(f"[nan] planted NaN in round 1: nan_round {nan_round}, summary "
          f"{summary}, epochs validated {len(log.epochs)}, rounds run "
          f"{len(log.round_s)}, update finite "
          f"{bool(torch.isfinite(state.ps_weights).all())}, launches "
          f"{launches}", flush=True)
    if nan_round != 1 or summary is not None or len(log.epochs) != 1 \
            or len(log.round_s) != 2 or calls != [1, 2]:
        fail("the planted NaN did not set nan_round = 1 and abort the "
             f"driver at the second epoch's end (store rounds {calls})")
    return launches


def phase_accounting():
    """Device time of a round's byte accounting at both main paths' d,
    W = 8, 100 rounds in (CUDA events, 10 calls a timing) on the states a
    run holds: a sparse run's (50,000 coordinates updated a round, the
    rest -1), a dense mode's (every coordinate updated in the last round)
    and random rounds. The download count (``download_coord_counts``),
    the update's record (``where(update != 0, step, coord_last_update)``
    on a 50,000-sparse update), and beside them a plain recount (one
    compare-and-sum over d a participant), which must give the same
    counts, and ``torch.bincount`` of ``coord_last_update + 1`` (the
    histogram form, whose atomics pile onto one bin in the skewed
    states)."""
    import torch
    from commefficient_torch.core.runtime import download_coord_counts

    dev, step, out = torch.device("cuda"), 100, {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (FLAGSHIP["d"], GPT2_SKETCH["d"]):
        thr = torch.randint(0, step + 1, (8,), generator=gen, device=dev,
                            dtype=torch.int32)
        update = torch.zeros(d, device=dev)
        update[torch.randperm(d, generator=gen, device=dev)[:50_000]] = 1.0
        step_t = torch.tensor(step, dtype=torch.int32, device=dev)
        sparse = torch.full((d,), -1, dtype=torch.int32, device=dev)
        hit = torch.randint(0, d, (50_000 * step,), generator=gen,
                            device=dev)
        sparse[hit] = torch.randint(0, step, hit.shape, generator=gen,
                                    device=dev, dtype=torch.int32)
        states = {
            "sparse": sparse,
            "dense": torch.full((d,), step - 1, dtype=torch.int32,
                                device=dev),
            "random": torch.randint(-1, step, (d,), generator=gen,
                                    device=dev, dtype=torch.int32)}
        record_ms = time_ms(
            lambda: torch.where(update != 0, step_t, sparse), n=10)
        for kind, cul in states.items():
            def plain():
                return torch.stack([(cul >= t).sum() for t in thr])

            if not torch.equal(download_coord_counts(cul, thr), plain()):
                fail(f"download counts at d={d} ({kind}) disagree with "
                     "the recount")
            count_ms = time_ms(lambda: download_coord_counts(cul, thr),
                               n=10)
            plain_ms = time_ms(plain, n=10)
            hist_ms = time_ms(lambda: torch.bincount(
                cul.to(torch.int64) + 1, minlength=step + 2), n=10)
            out[(d, kind)] = (count_ms, record_ms)
            print(f"[bytes] d={d} {kind}: download count {count_ms:.4f} "
                  f"ms, update record {record_ms:.4f} ms a round (device); "
                  f"a plain recount of 8 participants {plain_ms:.4f} ms, "
                  f"torch.bincount {hist_ms:.4f} ms", flush=True)
    return out


def time_host_ms(fn, n: int = 5) -> float:
    """Host-clock time of one ``fn()`` over ``n`` calls ending in a
    synchronize: for a function that reads back to the host itself (the
    cell sum's plain loop), which ``time_ms``'s device-side sleep would
    otherwise enter."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def cell_sum_work(n: int, size: int):
    """Bytes the cell sum must move for ``n`` addends into a ``size``-cell
    table: its sorted cells and order (int64) and addends (float32) read
    once, the table written once (zeroed, then each run's sum)."""
    return 20 * n + 4 * size


def phase_sparse_encode():
    """The sparse re-encode (``encode_vals_at``, whose ordered cell sums
    the zero rule's mask and the subtract rule read) on the card at both
    main paths' sketches with k = 50,000: its table must have the bits of
    the same call on the CPU (the plain loop), two card calls the same
    bits, and neither make a host sync (``host_syncs``). Then
    ``tie_heavy_sparse`` at k = 50,000 (2,000 addends on one coordinate,
    cancelling pairs, -0.0 first, inf, NaN) against the CPU's bits, and
    all k addends of every row in one cell (the kernel's worst case, one
    thread a row) against numpy's sequential float32 fold. Timed at each
    sketch on the random case: the cell sum's wrapper (the table's
    zeroing and the kernel), its plain loop on the card (host clock: it
    reads its rank count back), ``index_add_`` on the same cells (no
    fixed order), and the whole ``encode_vals_at``; and the wrapper on
    the tie-heavy case. Returns {"cell_sum": the kernel line's
    entry at the ResNet-9 sketch, with the GPT-2 sketch's and the worst
    case's beside it}."""
    import numpy as np
    import torch
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops.circulant import (make_circulant_sketch,
                                                   ordered_cell_sum)

    rng, out = np.random.RandomState(5), {}
    k = 50_000
    for shape in (FLAGSHIP, GPT2_SKETCH):
        d, c, r = shape["d"], shape["c"], shape["r"]
        cpu = make_circulant_sketch(d, c, r, device="cpu")
        card = make_circulant_sketch(d, c, r, device="cuda")
        cases = {"random": (rng.permutation(d)[:k],
                            rng.randn(k).astype(np.float32)),
                 "tie-heavy": tie_heavy_sparse(d, k, seed=d % 1000,
                                               one=2000)}
        on_card = {}
        for case, (idx, vals) in cases.items():
            idx, vals = torch.from_numpy(idx), torch.from_numpy(vals)
            want = cpu.encode_vals_at(vals, idx)
            gi, gv = on_card[case] = idx.cuda(), vals.cuda()
            K.reset_launches()
            got = card.encode_vals_at(gv, gi)
            syncs = host_syncs(lambda: card.encode_vals_at(gv, gi))
            again = card.encode_vals_at(gv, gi)
            torch.cuda.synchronize()
            if not (same_bits(got.cpu(), want) and same_bits(got, again)) \
                    or syncs or K.launches != sketch_launches(3, 0, 0):
                fail(f"the sparse re-encode at d={d} ({case}): bitwise the "
                     f"CPU {same_bits(got.cpu(), want)}, across calls "
                     f"{same_bits(got, again)}, host syncs {syncs}, "
                     f"launches {K.launches}")
            print(f"[sparse] d={d} c={c} {case}: encode_vals_at of {k:,} "
                  f"values bitwise the CPU's plain loop and across calls, "
                  f"one cell-sum launch a call, no host sync", flush=True)
        # timings on the random case's cells, and the kernel's on the
        # tie-heavy case's (a run of 2,000 addends in one thread a row)
        def prepared(gi, gv):
            sg, buckets = card._signs_and_buckets(gi)
            rows = torch.arange(r, device="cuda")[:, None]
            cells = (buckets + rows * c).reshape(-1)
            return (cells, *torch.sort(cells, stable=True),
                    (sg * gv).reshape(-1).contiguous())

        size = r * c
        tie_args = prepared(*on_card["tie-heavy"])[1:]
        tie_ms = time_ms(lambda: K.cell_sum(*tie_args, size))
        gi, gv = on_card["random"]
        cells, sorted_cells, order, addends = prepared(gi, gv)

        def index_add():
            return torch.zeros(size, device="cuda").index_add_(0, cells,
                                                               addends)

        ms = time_ms(lambda: K.cell_sum(sorted_cells, order, addends, size))
        plain_ms = time_host_ms(
            lambda: K.cell_sum_plain(sorted_cells, order, addends, size))
        lib = time_ms(index_add)
        whole = time_ms(lambda: card.encode_vals_at(gv, gi))
        err = float((K.cell_sum(sorted_cells, order, addends, size)
                     - K.cell_sum_plain(sorted_cells, order, addends,
                                        size)).abs().max())
        nbytes = cell_sum_work(r * k, size)
        b_ms, kind = bound(nbytes, 0, H100_FP32_PER_S)
        print(f"[sparse] d={d} c={c}: the cell sum of {r * k:,} addends "
              f"{ms:.4f} ms (bound {b_ms:.4f} ms, {kind}: "
              f"{nbytes / 1e6:.2f} MB), its plain loop {plain_ms:.4f} ms, "
              f"index_add_ {lib:.4f} ms; the whole encode_vals_at "
              f"{whole:.4f} ms; the cell sum of the tie-heavy case "
              f"{tie_ms:.4f} ms", flush=True)
        out[d] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": bound_by(kind),
                  "library_ms": lib, "encode_vals_at_ms": whole,
                  "tie_heavy_ms": tie_ms}
    # the worst case: every addend of a row in one cell
    d, c, r = FLAGSHIP["d"], FLAGSHIP["c"], FLAGSHIP["r"]
    addends = rng.randn(r, k).astype(np.float32)
    addends[:, 0] = -0.0
    fold = np.zeros((r, c), np.float32)
    fold[:, 0] = np.add.accumulate(
        np.concatenate([np.zeros((r, 1), np.float32), addends], 1),
        axis=1, dtype=np.float32)[:, -1]
    gb = torch.zeros((r, k), dtype=torch.int64, device="cuda")
    ga = torch.from_numpy(addends).cuda()
    got = ordered_cell_sum(gb, ga, c)
    if not same_bits(got.cpu(), torch.from_numpy(fold)):
        fail("the cell sum of one cell a row differs from numpy's "
             "sequential float32 fold")
    worst = time_ms(lambda: ordered_cell_sum(gb, ga, c), n=5)
    print(f"[sparse] all {k:,} addends of each of {r} rows in one cell: "
          f"bitwise numpy's sequential fold, {worst:.4f} ms (one thread a "
          "row)", flush=True)
    main = out[FLAGSHIP["d"]]
    return {"cell_sum": {**main, "at_gpt2_shape": out[GPT2_SKETCH["d"]],
                         "one_cell_a_row_ms": worst}}


def phase_hash_rht():
    """The hash Count Sketch and the SRHT on the card at the shapes their
    paths give them. Hash (ResNet-9: d = 6,568,640, c = 500,000, r = 5,
    20 blocks): the encode of a seeded vector against the same call on
    the CPU (HASH_ENCODE_RTOL), the decode of a table with zeroed cells,
    -0 and NaN bitwise equal to the CPU's, the sparse re-encode of 50,000
    values bitwise equal to the CPU's. SRHT: the round trip at c >= d'
    (d = 6,568,640, c = d' = 2^23, r = 1) within RHT_ROUND_TRIP_ATOL,
    with TF32 switched on around the call (the transform must turn it
    off), and the rht path's encode (r = 5, c = 1,313,728) against the
    CPU's. Returns the device times (ms) of each call, and of the hash
    encode's two parts apart (the derived buckets and signs of all d
    coordinates; one ``index_add_`` of the r d signed values)."""
    import numpy as np
    import torch
    from commefficient_torch.ops.rht import make_rht_sketch
    from commefficient_torch.ops.sketch import make_sketch

    d, c, r = FLAGSHIP["d"], 500_000, 5
    rng = np.random.RandomState(8)
    v = torch.from_numpy(rng.randn(d).astype(np.float32))
    cpu = make_sketch(d, c, r, 20, device="cpu")
    card = make_sketch(d, c, r, 20, device="cuda")
    want = cpu.encode(v)
    vc = v.cuda()
    got = card.encode(vc).cpu()
    rms = torch.linalg.vector_norm(want, dim=1, keepdim=True) / math.sqrt(c)
    enc_err = float(((got - want).abs() / (want.abs() + rms)).max())
    if not enc_err <= HASH_ENCODE_RTOL:
        fail(f"the hash encode on the card is {enc_err:.3e} from the CPU's "
             f"(limit {HASH_ENCODE_RTOL})")
    table = torch.from_numpy(zeroed_table(r, c, seed=9))
    tc = table.cuda()
    if not same_bits(card.decode(tc).cpu(), cpu.decode(table)):
        fail("the hash decode on the card differs from the CPU's bits")
    idx = torch.from_numpy(rng.permutation(d)[:50_000])
    vals = torch.from_numpy(rng.randn(50_000).astype(np.float32))
    gi, gv = idx.cuda(), vals.cuda()
    if not same_bits(card.encode_vals_at(gv, gi).cpu(),
                     cpu.encode_vals_at(vals, idx)):
        fail("the hash sparse re-encode on the card differs from the CPU's "
             "bits")
    # the encode's two parts apart: the derived buckets and signs of all
    # d coordinates (block by block, as encode and decode derive them),
    # and one index_add_ of the r d signed values into their cells
    blocks = [torch.arange(lo, min(lo + card.block_len, d), device="cuda")
              for lo in range(0, d, card.block_len)]
    buckets, sg = card.buckets_signs(torch.arange(d, device="cuda"))
    cells = (buckets + torch.arange(r, device="cuda")[:, None] * c).view(-1)
    addends = (sg * vc).view(-1)
    del buckets, sg
    out = {"hash_encode": time_ms(lambda: card.encode(vc), n=5),
           "hash_decode": time_ms(lambda: card.decode(tc), n=5),
           "hash_encode_vals_at": time_ms(
               lambda: card.encode_vals_at(gv, gi), n=5),
           "hash_buckets_signs": time_ms(
               lambda: [card.buckets_signs(i) for i in blocks], n=5),
           "hash_index_add": time_ms(
               lambda: card.empty_table().view(-1).index_add_(0, cells,
                                                              addends), n=5)}
    del cells, addends

    lossless = make_rht_sketch(d, 1 << 23, 1, device="cuda")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        back = lossless.decode(lossless.encode(vc))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    trip_err = float((back - vc).abs().max() / vc.abs().max())
    if not trip_err <= RHT_ROUND_TRIP_ATOL:
        fail(f"the SRHT round trip at c = d' is {trip_err:.3e} of max|v| "
             f"from v (limit {RHT_ROUND_TRIP_ATOL})")
    c_rht = 1_313_728
    rht_cpu = make_rht_sketch(d, c_rht, r, device="cpu")
    rht = make_rht_sketch(d, c_rht, r, device="cuda")
    want = rht_cpu.encode(v)
    rht_err = float((rht.encode(vc).cpu() - want).abs().max()
                    / want.abs().max())
    if not rht_err <= RHT_ROUND_TRIP_ATOL:
        fail(f"the SRHT encode on the card is {rht_err:.3e} of the largest "
             f"cell from the CPU's (limit {RHT_ROUND_TRIP_ATOL})")
    t_rht = rht.encode(vc)
    out.update(rht_encode=time_ms(lambda: rht.encode(vc), n=5),
               rht_decode=time_ms(lambda: rht.decode(t_rht), n=5))
    print(f"[hash/rht] hash encode within {enc_err:.3e} (cell-relative) of "
          f"the CPU's, decode and sparse re-encode bitwise; SRHT round trip "
          f"at c = d' = 2^23 within {trip_err:.3e} of max|v| (TF32 on "
          f"around it), the rht path's encode within {rht_err:.3e} of the "
          "CPU's; device ms: "
          + ", ".join(f"{k} {t:.4f}" for k, t in out.items()), flush=True)
    return out


def phase_noise():
    """DP noise on the card, measured in a round: ResNet-9 uncompressed
    at the main path's widths with ``--dp`` (worker and server), one
    round from the initial state with noise_multiplier 0.1, again, and
    once from a run with 0 (the same seeded weights). The update's difference over the rate is the noise:
    its standard deviation within NOISE_STD_RTOL of 0.1 (worker: 8 draws
    of 0.1 sqrt(8) averaged), its mean near 0, and the repeated round's
    noise within NOISE_REPEAT_RTOL of the first (one seed, one round, one
    slot: one draw). Returns {mode: measured std}."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.config import parse_known

    sigma, W, B, lr = 0.1, 8, 64, 0.1
    out = {}
    def runtime(mode: str, multiplier: float):
        argv = (MAIN_ARGV + dataset_flags("synthetic64")
                + ["--mode", "uncompressed", "--error_type", "none", "--dp",
                   "--dp_mode", mode, "--noise_multiplier", str(multiplier)])
        return cv_train.setup(parse_known(cv_train.build_parser(), argv))[:2]

    for mode in ("worker", "server"):
        rng = np.random.RandomState(3)
        batch = {"image": rng.randn(W, B, 32, 32, 3).astype(np.float32),
                 "target": rng.randint(0, 10, (W, B))}
        ids, mask = np.arange(W), np.ones((W, B), bool)
        rt, s0 = runtime(mode, sigma)
        a, _ = rt.round(s0, ids, batch, mask, lr)
        b, _ = rt.round(s0, ids, batch, mask, lr)
        rt, s0 = runtime(mode, 0.0)
        c, _ = rt.round(s0, ids, batch, mask, lr)
        noise = ((c.ps_weights - a.ps_weights) / lr).double()
        repeat = float((b.ps_weights - a.ps_weights).abs().max()) / lr
        std, mean = float(noise.std()), float(noise.mean())
        n = noise.numel()
        if not (abs(std / sigma - 1) <= NOISE_STD_RTOL
                and abs(mean) <= 5 * sigma / math.sqrt(n)
                and repeat <= NOISE_REPEAT_RTOL * sigma):
            fail(f"DP {mode} noise on the card: std {std:.6f} (want "
                 f"{sigma}), mean {mean:.3e}, a repeated round's noise "
                 f"{repeat:.3e} from the first")
        out[mode] = std
        print(f"[noise] --dp_mode {mode}: std {std:.6f} over {n} "
              f"coordinates (want {sigma}), mean {mean:.3e}, a repeated "
              f"round's noise {repeat:.3e} from the first", flush=True)
        del rt, s0, a, b, c
        torch.cuda.empty_cache()
    return out


def phase_topk(device="cuda"):
    """The card's top-k (``topk_with_idx``, and row-wise ``topk``) on
    vectors with +-NaN, +-inf, +-0 and ties, held to a plain ranking of
    the card's own ``vec * vec`` (numpy's lexsort of its float32 bits in
    their total order, then the index); prints which NaN the card's
    multiply gives for (-NaN)^2, and times the top-k at both main paths'
    d with k = 50,000 (CUDA events) and PyTorch's ``torch.topk`` of the
    same k over the float32 squares beside it."""
    import numpy as np
    import torch
    from commefficient_torch.ops.topk import topk, topk_with_idx

    def plain_order(sq, k=None):
        """The first k indices of ``sq`` by descending total order of its
        bits, then ascending index (all of them without k)."""
        bits = sq.view(np.int32).astype(np.int64)
        keys = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
        cand = np.arange(len(sq))
        if k is not None and k < len(sq):
            kth = np.partition(keys, len(sq) - k)[len(sq) - k]
            cand = np.flatnonzero(keys >= kth)
        return cand[np.lexsort((cand, -keys[cand]))][:k]

    special = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0xFFC00005,
                        0x7F800000, 0xFF800000, 0, 0x80000000],
                       np.uint32).view(np.float32)
    small = np.concatenate([special, np.float32([1, -2, 3, -3, 2, 0.5, -1,
                                                 3, 2e-30, -2e-30])])
    dev = torch.device(device)
    v = torch.from_numpy(small).to(dev)
    sq = (v * v).cpu().numpy()
    order = plain_order(sq)
    for k in range(1, len(small) + 1):
        vals, idx = topk_with_idx(v, k)
        if not np.array_equal(idx.cpu().numpy(), order[:k]) or \
                not np.array_equal(vals.cpu().numpy().view(np.uint32)
                                   [order[:k]],
                                   small.view(np.uint32)[order[:k]]):
            fail(f"top-k on the card, k={k}: {idx.cpu().numpy()} against "
                 f"the plain ranking {order[:k]}")
    neg = sq.view(np.uint32)[[2, 3]]
    print(f"[topk] the card's (-NaN)^2 for inputs 0xffc00000, 0xffc00005: "
          f"{[hex(int(b)) for b in neg]} (the CPU keeps the sign bit: "
          f"0xffc00000, 0xffc00005); +NaN^2: "
          f"{[hex(int(b)) for b in sq.view(np.uint32)[[0, 1]]]}; k = 1..18 "
          f"agree with the plain ranking", flush=True)
    rng = np.random.RandomState(0)
    times = {}
    for d in (FLAGSHIP["d"], GPT2_SKETCH["d"]):
        big = rng.randn(d).astype(np.float32)
        big[rng.randint(0, d, 64)] = np.nan
        big[rng.randint(0, d, 64)] = -np.inf
        big[rng.randint(0, d, 5000)] = 2.5       # ties around the cut
        big[rng.randint(0, d, 64)] = -0.0
        vb = torch.from_numpy(big).to(dev)
        k = 50_000
        _, idx = topk_with_idx(vb, k)
        want = plain_order((vb * vb).cpu().numpy(), k)
        if not np.array_equal(idx.cpu().numpy(), want):
            fail(f"top-k on the card at d={d} disagrees with the plain "
                 "ranking")
        rows = vb[: 8 * (d // 8)].view(8, -1)
        dense = topk(rows, 1000).cpu().numpy()
        for j in (0, 7):
            o = plain_order((rows[j] * rows[j]).cpu().numpy(), 1000)
            if not np.array_equal(np.flatnonzero(dense[j] != 0),
                                  np.sort(o[rows[j].cpu().numpy()[o] != 0])):
                fail(f"row-wise top-k on the card, row {j}, disagrees")
        ms = time_ms(lambda: topk_with_idx(vb, k), n=10)
        lib = time_ms(lambda: torch.topk(vb * vb, k), n=10)
        times[d] = (ms, lib)
        print(f"[topk] d={d} k={k} (NaN, -inf, ties, -0 planted): agrees "
              f"with the plain ranking (and the row-wise top-k of 8 rows); "
              f"topk_with_idx {ms:.4f} ms, torch.topk of the float32 "
              f"squares {lib:.4f} ms", flush=True)
    return times


class LaunchSplit:
    """Wraps ``FedRuntime.round`` and ``FedRuntime.val`` while installed:
    keeps the kernel launches each call made (the counts read before and
    after it), so the run's launches split into rounds and validation
    batches by measurement. With ``keep_weights``, ``first_weights``
    holds the first round's weights before and after it, copied to the
    host."""

    def __init__(self, counts, keep_weights: bool = False):
        from commefficient_torch.core.runtime import FedRuntime
        self.cls, self.counts = FedRuntime, counts
        self.orig = {"round": FedRuntime.round, "val": FedRuntime.val}
        self.calls = {"round": [], "val": []}
        self.keep_weights, self.first_weights = keep_weights, None

    def __enter__(self):
        for kind, orig in self.orig.items():
            setattr(self.cls, kind, self._wrap(orig, self.calls[kind]))
        return self

    def _wrap(self, orig, calls):
        counts = self.counts

        def wrapped(*args, **kw):
            before = counts()
            out = orig(*args, **kw)
            after = counts()
            calls.append({n: after[n] - before[n] for n in after})
            if self.keep_weights and calls is self.calls["round"] \
                    and self.first_weights is None:
                self.first_weights = (args[1].ps_weights.cpu(),
                                      out[0].ps_weights.cpu())
            return out

        return wrapped

    def __exit__(self, *exc):
        for kind, orig in self.orig.items():
            setattr(self.cls, kind, orig)

    def total(self, kind: str) -> dict:
        return {n: sum(c[n] for c in self.calls[kind])
                for n in self.counts()}


GPT2_ARGV = ["--mode", "sketch", "--error_type", "virtual",
             "--local_momentum", "0", "--virtual_momentum", "0.9",
             "--num_workers", "8", "--local_batch_size", "4",
             "--num_candidates", "2", "--max_seq_len", "1024", "--k",
             "50000", "--num_rows", "5", "--num_cols", "524288"]


def phase_gpt2_main(extra=(), n_rounds: int = GPT2_ROUNDS,
                    encodes: int = 9, fwd: int = GPT2_PER_ROUND["flash_fwd"],
                    keep: bool = False, decodes: int = 1,
                    want_up=None, k3=HOPPER_KERNELS, cells: int = 1):
    """``n_rounds`` GPT-2 rounds at GPT-2 small's width through the user's
    entry point, each round an epoch with its validation; ``extra`` flags
    after the main path's. Every round must launch exactly GPT2_PER_ROUND
    (with ``encodes`` K1, ``decodes`` K2, ``cells`` cell sums and ``fwd``
    K3 forward kernels: 192 when every block's forward runs again in the
    backward) and every validation batch GPT2_VAL_FWD K3 forward kernels
    and nothing else (``LaunchSplit``), and the two must add up to the run's counts. Returns the measured
    launches of the rounds and of the validations, the median round time
    (ms) and ``info``: the peak memory (bytes), the round losses and,
    with ``keep``, the first round's weights before and after it and the
    final weights (on the host). With ``want_up``, each round's upload
    bytes a participant are held to it (``RoundRecorder``). ``k3`` names
    the K3 route's forward, dq and dk/dv kernels (the bf16 D = 64 route's
    by default; every other route 0)."""
    import contextlib

    import numpy as np
    import torch
    from commefficient_torch import gpt2_train
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops import flash_attention as FA

    argv = [*GPT2_ARGV, "--num_rounds", str(n_rounds), *extra]
    per_round = {**dict.fromkeys(gpt2_train.kernel_launches(), 0),
                 **sketch_launches(1, encodes, decodes, cells),
                 **dict(zip(k3, (fwd, GPT2_PER_ROUND["flash_bwd_dq"],
                                 GPT2_PER_ROUND["flash_bwd_dkv"])))}
    tag = " ".join(extra) or "bytes on"
    print("[gpt2] python -m commefficient_torch.gpt2_train " + " ".join(argv),
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    FA.reset_launches()
    with LaunchSplit(gpt2_train.kernel_launches, keep) as split, \
            (RoundRecorder() if want_up is not None
             else contextlib.nullcontext()) as rec:
        out = entry_main(gpt2_train, argv)
    if rec is not None:
        rec.check_bytes(" ".join(extra), want_up)
    total = gpt2_train.kernel_launches()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rounds, val = split.total("round"), split.total("val")
    val_batch = dict.fromkeys(total, 0)
    val_batch[k3[0]] = GPT2_VAL_FWD
    if out["rounds"] != n_rounds or len(split.calls["round"]) \
            != n_rounds or len(split.calls["val"]) != out["val_batches"] \
            or out["val_batches"] < 1:
        fail(f"ran {out['rounds']} GPT-2 rounds ({len(split.calls['round'])}"
             f" measured) and {out['val_batches']} validation batches "
             f"({len(split.calls['val'])} measured), wanted {n_rounds} "
             "and some")
    if not np.isfinite(out["losses"]).all() or \
            not math.isfinite(out["val_loss"]):
        fail(f"non-finite GPT-2 losses {out['losses']} / {out['val_loss']}")
    bad = [("round", i, c) for i, c in enumerate(split.calls["round"])
           if c != per_round] + \
          [("validation batch", i, c) for i, c in enumerate(split.calls["val"])
           if c != val_batch]
    if bad:
        fail(f"GPT-2 launches: {bad[:4]}; want {per_round} a round and "
             f"{val_batch} a validation batch")
    if {n: rounds[n] + val[n] for n in total} != total:
        fail(f"GPT-2 launches {total} outside the rounds ({rounds}) and the "
             f"validation batches ({val})")
    rt = statistics.median(out["round_s"][1:] or out["round_s"])
    tflops = out["model_flops_per_round"] / rt / 1e12
    print(f"[gpt2] {tag}: {n_rounds} rounds: median of rounds "
          f"2-{n_rounds} (the first pays one-time set-up; one round: "
          "itself) "
          f"{rt * 1e3:.3f} ms "
          f"(all: {[round(t * 1e3, 3) for t in out['round_s']]}), "
          f"{out['tokens_per_round'] / rt:.1f} tokens/s, "
          f"{out['model_flops_per_round'] / 1e12:.3f} model TFLOP/round -> "
          f"{tflops:.2f} TFLOP/s = {100 * tflops * 1e12 / H100_BF16_PER_S:.2f}"
          f"% of 989 TFLOP/s, peak memory {peak / 2**30:.3f} GiB, "
          f"round losses {[round(float(x), 5) for x in out['losses']]}, "
          f"val nll {out['val_loss']:.4f}, {out['total_download_mib']:.1f} "
          f"MiB down, {out['total_upload_mib']:.1f} MiB up; launches "
          f"measured around each call: rounds {rounds}, validation "
          f"({out['val_batches']} batches) {val}", flush=True)
    info = {"peak": peak, "losses": [float(x) for x in out["losses"]],
            "upload_mib": out["total_upload_mib"]}
    if keep:
        info["first_weights"] = split.first_weights
        info["final"] = out["state"].ps_weights.cpu()
    return rounds, val, rt * 1e3, info


# the main path's table at more rows than r = 8 (K1/K2 took at most 8
# before): GPT2_ARM_ROUNDS rounds at each
GPT2_ROWS = (9, 16)


def phase_gpt2_rows() -> dict:
    """``gpt2_train --num_rows R`` for R of GPT2_ROWS at the main path's
    width (``phase_gpt2_main``: exact launches a round, finite losses,
    each round's upload 4 R c bytes a participant); returns each run's
    result."""
    out = {}
    for r in GPT2_ROWS:
        out[r] = phase_gpt2_main(["--num_rows", str(r)], GPT2_ARM_ROUNDS,
                                 want_up=4 * r * GPT2_SKETCH["c"])
        print(f"[gpt2] --num_rows {r}: median {out[r][2]:.3f} ms, peak "
              f"{out[r][3]['peak'] / 2**30:.3f} GiB", flush=True)
    return out


# the real-data phase: a full-scale CIFAR10 pickle directory (50,000 train
# and 10,000 test images of synthetic_cifar, 5,000 and 1,000 a class)
REAL_TRAIN_PER_CLASS = 5000
REAL_TEST_PER_CLASS = 1000
REAL_EPOCHS = 2
REAL_VALID_BATCH = 1000
# the first resumed round's loss: a forward of identical weights on an
# identical batch (bf16 compute); the card's convolutions may pick other
# algorithms in another process
RESUME_LOSS_RTOL = 1e-3
HOST_GATHER_ROUNDS = 20


def write_cifar10_pickles(root: str) -> float:
    """``cifar-10-batches-py`` under ``root`` in the CIFAR python-pickle
    schema: 5 train batches of 10,000 images and a test batch, classes
    interleaved by a seeded permutation. Returns the seconds it took."""
    import pickle
    import numpy as np
    from commefficient_torch.data.fed_cifar import synthetic_cifar

    t0 = time.perf_counter()
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)

    def rows(images):
        return np.ascontiguousarray(images.transpose(0, 3, 1, 2)
                                    .reshape(len(images), 3072))

    images, labels = synthetic_cifar(10, REAL_TRAIN_PER_CLASS)
    perm = np.random.RandomState(0).permutation(len(labels))
    for i, part in enumerate(np.array_split(perm, 5)):
        with open(os.path.join(d, f"data_batch_{i + 1}"), "wb") as f:
            pickle.dump({b"data": rows(images[part]),
                         b"labels": labels[part].tolist()}, f)
    images, labels = synthetic_cifar(10, REAL_TEST_PER_CLASS, seed=4321)
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump({b"data": rows(images), b"labels": labels.tolist()}, f)
    return time.perf_counter() - t0


class StoreRecorder:
    """Wraps ``DeviceStore.round_batch`` while installed: keeps each train
    batch (round index, indices, output) of the run."""

    def __init__(self):
        from commefficient_torch.data.device_store import DeviceStore
        self.cls, self.orig, self.calls = DeviceStore, \
            DeviceStore.round_batch, []

    def __enter__(self):
        import numpy as np
        orig, calls = self.orig, self.calls

        def round_batch(store, flat_idx, round_index=None):
            out = orig(store, flat_idx, round_index)
            if round_index is not None:
                calls.append((round_index, np.array(flat_idx), out))
            return out

        self.cls.round_batch = round_batch
        return self

    def __exit__(self, *exc):
        self.cls.round_batch = self.orig

    def batch(self, round_index: int):
        hits = [c for c in self.calls if c[0] == round_index]
        if len(hits) != 1:
            fail(f"round {round_index} drew {len(hits)} store batches")
        return hits[0]


def same_state_bits(a, b) -> list:
    """The fields of two ``FedState``s whose bits differ."""
    import torch
    bad = [] if a.step == b.step else ["step"]
    for name in ("ps_weights", "Vvelocity", "Verror", "client_velocities",
                 "client_errors", "coord_last_update", "client_last_round",
                 "nan_round"):
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None) or (x is not None and not (
                x.dtype == y.dtype and x.device == y.device
                and torch.equal(x.view(torch.int32), y.view(torch.int32)))):
            bad.append(name)
    return bad


def phase_real_data_resume():
    """The main path from a CIFAR10 pickle directory at full scale:
    ``cv_train`` with the main path's flags, ``--checkpoint_every 1``, two
    epochs, from the device store (its MiB printed), exactly 9 K1, 1 K2
    and 1 cell sum a round; the data path's time a round against the host
    gather's; then a flipped byte in the newest generation and a
    ``--resume`` in a fresh call of the entry point: the restore must
    fall back to the first generation and name the damaged one, the
    restored state must be bitwise the one saved, the first resumed
    round's batch (indices, augmented images, targets) bitwise the
    uninterrupted run's and its loss within RESUME_LOSS_RTOL. Returns the
    launches of both runs."""
    import numpy as np
    import torch
    from commefficient_torch import checkpoint as ckpt
    from commefficient_torch import cv_train
    from commefficient_torch.config import parse_known
    from commefficient_torch.core import driver
    from commefficient_torch.data.transforms import transforms_for
    from commefficient_torch.ops import circulant_kernels as K

    root = os.path.join(DATA_ROOT["path"], "cifar10_pickles")
    gen_s = write_cifar10_pickles(root)
    ck_dir = os.path.join(DATA_ROOT["path"], "checkpoints")
    argv = MAIN_ARGV + [
        "--dataset_dir", root, "--num_epochs", str(REAL_EPOCHS),
        "--valid_batch_size", str(REAL_VALID_BATCH), "--checkpoint_every",
        "1", "--checkpoint_path", ck_dir]
    print(f"[real] wrote {root} ({REAL_TRAIN_PER_CLASS * 10} train and "
          f"{REAL_TEST_PER_CLASS * 10} test images) in {gen_s:.2f} s; "
          "python -m commefficient_torch.cv_train " + " ".join(argv),
          flush=True)
    saved = {}
    save = ckpt.CheckpointManager.save

    def keep_saved(mgr, state, epoch, meta=None):
        saved[epoch] = ckpt.FedState(**{
            f: (v.clone() if isinstance(v, torch.Tensor) else v)
            for f, v in vars(state).items()})
        return save(mgr, state, epoch, meta)

    ckpt.CheckpointManager.save = keep_saved
    K.reset_launches()
    try:
        with StoreRecorder() as rec_a:
            whole = entry_main(cv_train, argv)
    finally:
        ckpt.CheckpointManager.save = save
    launches_a = dict(K.launches)
    n_a = whole["rounds"]
    if whole["summary"] is None or whole["summary"]["epoch"] != REAL_EPOCHS \
            or not np.isfinite(whole["losses"]).all():
        fail(f"the real-data run ended at {whole['summary']}")
    if launches_a != sketch_launches(n_a):
        fail(f"real-data launches {launches_a} over {n_a} rounds: want 9 "
             "encode, 1 decode and 1 cell sum a round")
    if len(rec_a.calls) != n_a:
        fail(f"{len(rec_a.calls)} store batches for {n_a} rounds: the "
             "rounds were not fed by the device store")
    store_mib = whole["train_store"].nbytes / 2**20
    mgr = ckpt.CheckpointManager(os.path.join(ck_dir, "ResNet9"))
    first = ckpt.load_meta(mgr.path(1))["global_round"]
    rt = statistics.median(whole["round_s"][1:])
    data_ms = 1e3 * statistics.median(whole["fetch_s"][1:])

    # the host path's data path for the same rounds, as the driver takes
    # it where no store is built: the gather with its crop, flip and
    # normalisation, and the batch's upload, synced
    ns = parse_known(cv_train.build_parser(), argv)
    train_ds = cv_train.setup(ns)[2]
    train_ds.transform = transforms_for("CIFAR10", True)
    runtime = whole["runtime"]
    device = runtime.device
    host_ms = []
    for i, rnd in enumerate(driver.epoch_sampler(runtime.cfg, train_ds, 0)):
        if i == HOST_GATHER_ROUNDS:
            break
        driver._sync(device)
        t0 = time.perf_counter()
        runtime.to_device(train_ds.gather(rnd.idx))
        driver._sync(device)
        host_ms.append(1e3 * (time.perf_counter() - t0))
    host_ms = statistics.median(host_ms[1:])
    print(f"[real] {n_a} rounds in {REAL_EPOCHS} epochs ({first} in the "
          f"first) from the device store ({store_mib:.1f} MiB train): "
          f"median round {rt * 1e3:.3f} ms, data path {data_ms:.3f} ms a "
          "round (index upload, gather and augmentation on the device, "
          f"synced) against {host_ms:.3f} ms for the host gather and its "
          f"upload; val acc "
          f"{whole['summary']['test_acc']:.4f} after {REAL_EPOCHS} epochs; "
          f"launches {launches_a}", flush=True)

    # damage the newest generation, resume in a fresh call
    import zipfile
    newest = mgr.path(REAL_EPOCHS) + ".npz"
    with zipfile.ZipFile(newest) as zf:
        info = zf.getinfo("ps_weights.npy")
    end = (info.header_offset + 30 + len(info.filename) + len(info.extra)
           + info.compress_size)
    with open(newest, "r+b") as f:
        f.seek(end - 4)
        byte = f.read(1)
        f.seek(end - 4)
        f.write(bytes([byte[0] ^ 0x01]))
    restored = {}
    setup = cv_train.setup_checkpointing

    def keep_restored(*a, **kw):
        out = setup(*a, **kw)
        restored["mgr"], restored["epoch"], restored["state"], \
            restored["round"] = out
        return out

    cv_train.setup_checkpointing = keep_restored
    K.reset_launches()
    try:
        with StoreRecorder() as rec_b:
            rest = entry_main(cv_train, argv + ["--resume"])
    finally:
        cv_train.setup_checkpointing = setup
    launches_b = dict(K.launches)
    n_b = rest["rounds"]
    fallbacks = [fb["path"] for fb in restored["mgr"].restore_fallbacks]
    if fallbacks != [mgr.path(REAL_EPOCHS)] or restored["epoch"] != 1 \
            or restored["round"] != first:
        fail(f"the resume restored epoch {restored['epoch']} at round "
             f"{restored['round']} with fallbacks {fallbacks}; want epoch "
             f"1, round {first}, past {mgr.path(REAL_EPOCHS)}")
    bad = same_state_bits(restored["state"], saved[1])
    if bad or restored["state"].ps_weights.device.type != device.type:
        fail(f"the restored state differs from the saved one in {bad}")
    if launches_b != sketch_launches(n_b) or n_b != n_a - first:
        fail(f"resumed run: {n_b} rounds, launches {launches_b}; want "
             f"{n_a - first} rounds, 9 + 1 + 1 a round")
    r_a, idx_a, out_a = rec_a.batch(first + 1)
    r_b, idx_b, out_b = rec_b.calls[0]
    if r_b != first + 1 or not np.array_equal(idx_a, idx_b) or not all(
            torch.equal(out_a[k].view(torch.int32) if k == "image"
                        else out_a[k],
                        out_b[k].view(torch.int32) if k == "image"
                        else out_b[k]) for k in out_a):
        fail(f"the first resumed round (store round {r_b}) drew another "
             f"batch than round {first + 1} of the uninterrupted run")
    loss_a, loss_b = whole["losses"][first], rest["losses"][0]
    rel = abs(loss_b - loss_a) / abs(loss_a)
    if rel > RESUME_LOSS_RTOL:
        fail(f"first resumed round's loss {loss_b} against {loss_a}: "
             f"relative {rel:.3g} > {RESUME_LOSS_RTOL}")
    diffs = [abs(b - a) / abs(a)
             for a, b in zip(whole["losses"][first:], rest["losses"])]
    print(f"[real] resumed from epoch 1 (global round {first}) past the "
          f"damaged {fallbacks[0]}: restored state bitwise the saved one "
          f"on {restored['state'].ps_weights.device}; round {first + 1}'s "
          f"batch bitwise the uninterrupted run's; its loss "
          f"{float(loss_b)!r} against {float(loss_a)!r} (relative "
          f"{rel:.3g}, limit "
          f"{RESUME_LOSS_RTOL}); epoch {REAL_EPOCHS}'s {n_b} rounds' "
          f"losses within {max(diffs):.3g} relative (printed, not held: "
          f"the card's kernels need not repeat their bits); val acc "
          f"{rest['summary']['test_acc']:.4f} against "
          f"{whole['summary']['test_acc']:.4f}; launches {launches_b}",
          flush=True)
    return launches_a, launches_b


def phase_gpt2_checkpoint():
    """Save and load the GPT-2 main path's state at full width once
    (d = 92,138,496, sketch tables, byte accounting): the time and size of
    each, and the loaded state bitwise the saved one on the card."""
    import torch
    from commefficient_torch import gpt2_train
    from commefficient_torch.checkpoint import load_meta, load_state, \
        save_state
    from commefficient_torch.config import parse_known
    from commefficient_torch.core import driver

    ns = parse_known(gpt2_train.build_parser(), [
        "--mode", "sketch", "--error_type", "virtual", "--local_momentum",
        "0", "--virtual_momentum", "0.9", "--num_workers", "8",
        "--local_batch_size", "4", "--max_seq_len", "1024", "--k", "50000", "--num_rows", "5",
        "--num_cols", "524288"])
    runtime = gpt2_train.setup(ns)[0]
    state = runtime.init_state()
    gen = torch.Generator(device=runtime.device).manual_seed(0)
    state.Vvelocity.normal_(generator=gen)
    state.Verror.normal_(generator=gen)
    state.coord_last_update.random_(0, 100, generator=gen)
    path = os.path.join(DATA_ROOT["path"], "gpt2_state")
    driver._sync(runtime.device)
    t0 = time.perf_counter()
    save_state(path, state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_state(path, runtime.device, load_meta(path)["digests"],
                        runtime.state_shapes())
    driver._sync(runtime.device)
    load_s = time.perf_counter() - t0
    bad = same_state_bits(loaded, state)
    if bad:
        fail(f"the GPT-2 state read back differs in {bad}")
    size = os.path.getsize(path + ".npz")
    print(f"[ckpt] GPT-2 main path state (d = {runtime.cfg.grad_size}): "
          f"{size / 2**20:.1f} MiB, saved in {save_s:.3f} s (host copies, "
          f"sha256 of each entry, write, fsync), loaded and verified in "
          f"{load_s:.3f} s, bitwise equal on {runtime.device}", flush=True)
    os.unlink(path + ".npz")
    return save_s, load_s, size


# GPT-2's memory levers (the JAX package's bench_gpt2.py runs its round
# with remat and lm_chunk 128; scripts/gpt2_mfu_sweep.py sweeps both),
# each GPT2_ARM_ROUNDS rounds beside the base arm of the same call: its
# flags and its K3 forward launches a round (under --remat each block's
# forward runs again in the backward: K3 is reached through ctypes, so no
# policy saves its outputs)
GPT2_LEVER_ARMS = {
    "lm_chunk128": (["--lm_chunk", "128"], 96),
    "remat": (["--remat"], 192),
    "remat_dots_no_batch": (["--remat", "--remat_policy",
                             "dots_with_no_batch_dims_saveable"], 192),
    "remat_lm_chunk128": (["--remat", "--lm_chunk", "128"], 192),
}
# the lever arms against the base arm, after the first round: remat
# repeats the block's arithmetic, so its arms must give the base arm's
# loss and weights bit for bit (they do on an H100); the chunked LM loss
# sums the same logits in another order (and float32 products of other
# heights), so its arms are held to LEVER_LIMITS: the first round's loss
# (relative) and the first round's update (relative L2: the gradient's
# last bits move a few of the k = 50,000 coordinates at the top-k's edge
# in or out). Read on an H100: 6.4e-8 and 4.8e-2.
LEVER_BITWISE = ("remat", "remat_dots_no_batch")
LEVER_LIMITS = {"dloss": 1e-6, "dupdate": 0.1}
# the pretrained round trip: an HF GPT-2 checkpoint at GPT-2 small's width
# over the HashTokenizer's 8,192 rows, drawn from a seed; iid clients
PRETRAINED_CLIENTS = 16
# K3 against dense attention at full width from those weights (bf16):
# the logits' relative L2 error (read on an H100: 9.4e-3 DoubleHeads,
# 1.1e-2 LMHead; the two round bf16 at different places)
PRETRAINED_FLASH_RTOL = 2e-2


def phase_gpt2_levers():
    """The base arm and each of GPT2_LEVER_ARMS through ``gpt2_train``,
    GPT2_ARM_ROUNDS rounds each, at the main path's width: exact launches
    a round (``phase_gpt2_main``), the median round and the peak memory
    of each arm beside the base arm's, and the first round's loss and
    weights against the base arm's (LEVER_BITWISE, LEVER_LIMITS). Returns
    ``{arm: (round launches, validation launches, median ms, peak bytes,
    readings)}``, the base arm first."""
    base = phase_gpt2_main([], GPT2_ARM_ROUNDS, keep=True)
    b_info = base[3]
    b_w0, b_w1 = b_info["first_weights"]
    b_up = b_w1 - b_w0
    out = {"base": base[:3] + (b_info["peak"], {})}
    for arm, (flags, fwd) in GPT2_LEVER_ARMS.items():
        rounds, val, ms, info = phase_gpt2_main(flags, GPT2_ARM_ROUNDS,
                                                fwd=fwd, keep=True)
        w0, w1 = info["first_weights"]
        if not same_bits(w0, b_w0):
            fail(f"GPT-2 lever arm {arm} started from other weights")
        read = {"dloss": abs(info["losses"][0] / b_info["losses"][0] - 1),
                "dupdate": float((w1 - w0 - b_up).norm() / b_up.norm()),
                "bitwise": bool(same_bits(w1, b_w1) and info["losses"][0]
                                == b_info["losses"][0])}
        print(f"[levers] {arm} ({' '.join(flags)}): median round {ms:.3f} "
              f"ms (base {base[2]:.3f}), peak memory "
              f"{info['peak'] / 2**30:.3f} GiB (base "
              f"{b_info['peak'] / 2**30:.3f}); first round against the "
              f"base arm: loss {info['losses'][0]!r} vs "
              f"{b_info['losses'][0]!r} (relative {read['dloss']:.3e}), "
              f"update relative L2 {read['dupdate']:.3e}, bitwise "
              f"{read['bitwise']}", flush=True)
        if arm in LEVER_BITWISE and not read["bitwise"]:
            fail(f"GPT-2 lever arm {arm}: the first round differs from the "
                 f"base arm's: {read}")
        if read["dloss"] > LEVER_LIMITS["dloss"] or \
                read["dupdate"] > LEVER_LIMITS["dupdate"]:
            fail(f"GPT-2 lever arm {arm}: {read} outside {LEVER_LIMITS}")
        out[arm] = (rounds, val, ms, info["peak"], read)
    return out


def write_hf_gpt2(root: str, gcfg, seed: int = 0) -> dict:
    """An HF ``GPT2Model`` checkpoint (``pytorch_model.bin``, the
    ``transformer.`` keys of an LM-head checkpoint) at ``gcfg``'s width
    with ``gcfg.vocab_size`` token rows and ``n_positions`` positions,
    drawn from ``seed`` at GPT-2's initial scales; returns the arrays."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    E, L = gcfg.n_embd, gcfg.n_layer

    def draw(shape, scale, mean=0.0):
        return (mean + scale * rng.standard_normal(shape, np.float32)
                ).astype(np.float32)

    sd = {"wte.weight": draw((gcfg.vocab_size, E), 0.02),
          "wpe.weight": draw((gcfg.n_positions, E), 0.01),
          "ln_f.weight": draw((E,), 0.01, 1.0), "ln_f.bias": draw((E,), 0.01)}
    for i in range(L):
        for name, n_in, n_out in (("attn.c_attn", E, 3 * E),
                                  ("attn.c_proj", E, E),
                                  ("mlp.c_fc", E, 4 * E),
                                  ("mlp.c_proj", 4 * E, E)):
            sd[f"h.{i}.{name}.weight"] = draw((n_in, n_out), 0.02)
            sd[f"h.{i}.{name}.bias"] = draw((n_out,), 0.01)
        for ln in ("ln_1", "ln_2"):
            sd[f"h.{i}.{ln}.weight"] = draw((E,), 0.01, 1.0)
            sd[f"h.{i}.{ln}.bias"] = draw((E,), 0.01)
    os.makedirs(root, exist_ok=True)
    torch.save({"transformer." + k: torch.from_numpy(v)
                for k, v in sd.items()},
               os.path.join(root, "pytorch_model.bin"))
    return sd


def phase_gpt2_pretrained():
    """The pretrained path at full width: an HF checkpoint written by
    ``write_hf_gpt2``, then one round of the main path's flags plus
    ``--model_checkpoint DIR --checkpoint --iid --num_clients 16`` into a
    fresh dataset directory, then one more round from the same directory
    (exact launches a round in both). The run's initial weights must be
    ``load_state_dict`` of the file's arrays bit for bit,
    ``load_pretrained`` of the saved directory its final weights bit for
    bit, the second run must pack nothing (the first packs the train and
    validation splits once each), and the K3 forward of the loaded
    DoubleHeads model and of a ``GPT2LMHead`` from the same file must
    agree with their dense forward (PRETRAINED_FLASH_RTOL). Returns the
    two runs' launches, their round times (ms) and the K3 readings."""
    import numpy as np
    import torch
    from commefficient_torch import gpt2_train
    from commefficient_torch.data.fed_persona import FedPERSONA
    from commefficient_torch.models.gpt2 import (GPT2Config,
                                                 GPT2DoubleHeads, GPT2LMHead,
                                                 load_state_dict)
    from commefficient_torch.ops import flash_attention as FA

    root = tempfile.mkdtemp(prefix="gpt2_pretrained_", dir=DATA_ROOT["path"])
    gcfg = GPT2Config(vocab_size=8192)
    t0 = time.perf_counter()
    sd = write_hf_gpt2(os.path.join(root, "hf"), gcfg)
    write_s = time.perf_counter() - t0
    flags = ["--model_checkpoint", os.path.join(root, "hf"), "--iid",
             "--num_clients", str(PRETRAINED_CLIENTS), "--dataset_dir",
             os.path.join(root, "data")]
    saved = os.path.join(root, "ck", "gpt2_doubleheads")
    packs, orig = [], FedPERSONA._pack_split

    def counted(self, *a, **kw):
        packs.append(self.train)
        return orig(self, *a, **kw)

    FedPERSONA._pack_split = counted
    try:
        first = phase_gpt2_main([*flags, "--checkpoint", "--checkpoint_path",
                                 os.path.join(root, "ck")], 1, keep=True)
        first_packs = len(packs)
        second = phase_gpt2_main(flags, 1)
    finally:
        FedPERSONA._pack_split = orig
    if first_packs != 2 or len(packs) != 2:
        fail(f"PersonaChat packs: {first_packs} in the first run (want 2: "
             f"train and validation), {len(packs) - first_packs} in the "
             "second (want 0: the cache)")
    seed = gpt2_train.build_parser().get_default("seed")
    seeded = GPT2DoubleHeads(gcfg, generator=torch.Generator().manual_seed(
        seed))
    w0 = first[3]["first_weights"][0]
    if not same_bits(load_state_dict(seeded, gcfg, sd), w0):
        fail("the pretrained run's initial weights are not load_state_dict "
             "of the checkpoint's arrays")
    model, flat, gcfg_saved, tok = gpt2_train.load_pretrained(saved, "cuda")
    if gcfg_saved != gcfg or tok.base_vocab != 8192 or \
            not same_bits(flat.cpu(), first[3]["final"]):
        fail(f"load_pretrained of {saved} is not the run's final model")
    rng = np.random.default_rng(1)
    N, C, S = 2, 2, gcfg.n_positions
    ids = torch.from_numpy(rng.integers(0, gcfg.total_vocab, (N, C, S))).cuda()
    tt = torch.from_numpy(rng.integers(gcfg.vocab_size, gcfg.total_vocab,
                                       (N, C, S))).cuda()
    mc = torch.full((N, C), S - 1).cuda()
    flash_model = GPT2DoubleHeads(gcfg, attn_impl="flash").cuda()
    lm_flash = GPT2LMHead(gcfg, attn_impl="flash")
    lm_flat = load_state_dict(lm_flash, gcfg, sd).cuda()
    lm_flash, lm_dense = lm_flash.cuda(), GPT2LMHead(gcfg).cuda()
    readings, launches = {}, {}
    with torch.no_grad():
        for name, run_flash, run_dense in (
                ("DoubleHeads", lambda: flash_model(ids, mc, tt, flat),
                 lambda: model(ids, mc, tt, flat)),
                ("LMHead", lambda: (lm_flash(ids, tt, lm_flat),),
                 lambda: (lm_dense(ids, tt, lm_flat),))):
            FA.reset_launches()
            got = run_flash()
            launches[name] = FA.launches["flash_fwd"]
            ref = run_dense()
            readings[name] = max(float((g - r).norm() / r.norm())
                                 for g, r in zip(got, ref))
    FA.reset_launches()
    print(f"[pretrained] HF checkpoint at GPT-2 small's width (8,192 token "
          f"rows) written in {write_s:.2f} s; the run's initial weights are "
          f"load_state_dict of it bit for bit; load_pretrained of {saved} "
          f"gives its final weights bit for bit; PersonaChat packed "
          f"{first_packs} times by the first run and 0 by the second; "
          f"rounds {first[2]:.3f} / {second[2]:.3f} ms; K3 forward against "
          f"dense attention from these weights (logits' relative L2, "
          f"limit {PRETRAINED_FLASH_RTOL}): "
          + ", ".join(f"{n} {e:.3e} ({launches[n]} K3 launches)"
                      for n, e in readings.items()), flush=True)
    if any(e > PRETRAINED_FLASH_RTOL for e in readings.values()) or \
            any(n != GPT2_VAL_FWD for n in launches.values()):
        fail(f"K3 forward from the pretrained weights: {readings}, "
             f"launches {launches}")
    return {"pretrained": first[:3], "cached": second[:3],
            "flash": readings}


# the CV model zoo, card against CPU (phase_zoo_reference): one sketch
# round of each family at a narrow or shallow form, from its seeded
# initialisation plus seeded noise of ZOO_NOISE on every weight (so
# Fixup's zero convs and classifiers pass a gradient), float32 with TF32
# off on the card (cuDNN would run float32 convolutions in TF32; the
# drivers' default bf16 compute does not use TF32), so only summation
# order differs. The clients' losses within ZOO_LOSS_RTOL; the weight
# update's L2 difference within ZOO_UPDATE_RTOL of its norm, apart from
# at most ZOO_SWAPS coordinates of the k-sparse support on each side (a
# near-tie at the k-th estimate tipped by that noise). Single coordinates
# move more: a relu or a max tipped by summation order carries a
# gradient coordinate with it (ResNet18's largest single difference, read
# on an H100 from the seeded initialisation: 8.1e-4 of the largest
# update), so the limit is on the norm.
ZOO_NOISE = 0.01
ZOO_LOSS_RTOL = 1e-4
ZOO_UPDATE_RTOL = 1e-3
ZOO_SWAPS = 2
ZOO_CH = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32}
SHALLOW = (1, 1, 1, 1)
# the FEMNIST FetchSGD round: ResNet101LN at 28 x 28 x 1 and 62 classes
# (d = 43,124,350), c = 500,000 -> 500,736, so m = ceil(d / c) = 87; 8
# writers of 16 images a round: 8 fused client encodes + the weight-decay
# encode = 9 K1, 1 K2 a round
FEMNIST_SKETCH = dict(d=43_124_350, c=500_736, r=5)
FEMNIST_WRITERS = 3500
FEMNIST_PER_WRITER = 16
FEMNIST_TEST_PER_WRITER = 1
FEMNIST_FILES = 4
FEMNIST_ROUNDS = 3
FEMNIST_PER_ROUND = sketch_launches(1)
FEMNIST_ARGV = ["--dataset_name", "EMNIST", "--model", "ResNet101LN",
                "--mode", "sketch", "--error_type", "virtual",
                "--virtual_momentum", "0.9", "--local_momentum", "0",
                "--num_workers", "8", "--local_batch_size", "16",
                "--k", "50000", "--num_rows", "5", "--num_cols", "500000",
                "--valid_batch_size", "500",
                "--num_rounds", str(FEMNIST_ROUNDS)]
# BASELINE config 3: FixupResNet50 / CIFAR100 / true_topk / 100 clients
# (synthetic, 64 images each), 8 a round, with Fixup's rate vector
FIXUP_D = 23_659_926
FIXUP_ROUNDS = 3
FIXUP_ARGV = ["--dataset_name", "CIFAR100", "--model", "FixupResNet50",
              "--mode", "true_topk", "--error_type", "virtual",
              "--virtual_momentum", "0.9", "--local_momentum", "0",
              "--num_workers", "8", "--local_batch_size", "64",
              "--k", "50000", "--valid_batch_size", "400",
              "--num_rounds", str(FIXUP_ROUNDS)]


def zoo_families():
    """(name, constructor, NHWC input shape, classes) of each family at
    its narrow or shallow form."""
    from commefficient_torch.models.fixup_resnet import FixupResNetImageNet
    from commefficient_torch.models.resnet9 import FixupResNet9
    from commefficient_torch.models.resnet18 import FixupResNet18, ResNet18
    from commefficient_torch.models.resnets import (ResNet, basic_block,
                                                    bottleneck)
    cifar, emnist = (32, 32, 3), (28, 28, 1)
    out = [("FixupResNet9", lambda **kw: FixupResNet9(channels=ZOO_CH, **kw),
            cifar, 10),
           ("ResNet18", lambda **kw: ResNet18(num_blocks=SHALLOW, **kw),
            cifar, 10),
           ("FixupResNet18",
            lambda **kw: FixupResNet18(num_blocks=SHALLOW, **kw), cifar, 10),
           ("FixupResNet50",
            lambda **kw: FixupResNetImageNet(SHALLOW, 100, cifar, **kw),
            cifar, 100)]
    for norm in ("batch", "layer"):
        out.append((f"resnet BasicBlock {norm}",
                    lambda norm=norm, **kw: ResNet(
                        basic_block, SHALLOW, 62, norm, input_shape=emnist,
                        **kw), emnist, 62))
        out.append((f"resnet grouped Bottleneck {norm}",
                    lambda norm=norm, **kw: ResNet(
                        bottleneck, SHALLOW, 62, norm, groups=4,
                        width_per_group=4, input_shape=emnist, **kw),
                    emnist, 62))
    return out


def phase_zoo_reference():
    """One sketch round of each CV family on the card (K1, K2, cuDNN)
    against the same round on the CPU (plain versions), float32 with TF32
    off, within ZOO_LOSS_RTOL, ZOO_UPDATE_RTOL and ZOO_SWAPS. Returns
    {family: (max relative loss difference, the update's relative L2
    difference, support swaps)}."""
    import numpy as np
    import torch
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_cv_loss

    cfg = FedConfig(mode="sketch", error_type="virtual", local_momentum=0.0,
                    virtual_momentum=0.9, weight_decay=5e-4, k=200,
                    num_rows=5, num_cols=4096, num_workers=2,
                    local_batch_size=4, compute_dtype="float32")
    out = {}
    with no_tf32():
        for name, make, shape, classes in zoo_families():
            rng = np.random.RandomState(0)
            batch = {"image": rng.randn(2, 4, *shape).astype(np.float32),
                     "target": rng.randint(0, classes, (2, 4))}
            mask = np.ones((2, 4), bool)
            mask[1, 3:] = False
            runs = {}
            for device in ("cpu", "cuda"):
                model = make(generator=torch.Generator().manual_seed(0))
                with torch.no_grad():
                    model.flat.add_(ZOO_NOISE * torch.randn(
                        model.num_params,
                        generator=torch.Generator().manual_seed(1)))
                rt = FedRuntime(cfg, model, make_cv_loss(model, "float32"),
                                device=device)
                st, met = rt.round(rt.init_state(), np.arange(2), batch,
                                   mask, 0.1)
                runs[device] = (met["results"][0].cpu().numpy(),
                                (st.ps_weights - rt.initial_weights)
                                .cpu().numpy())
            (l_cpu, u_cpu), (l_gpu, u_gpu) = runs["cpu"], runs["cuda"]
            dl = float(np.abs(l_gpu - l_cpu).max() / np.abs(l_cpu).max())
            s_cpu, s_gpu = u_cpu != 0, u_gpu != 0
            swaps = int(max((s_cpu & ~s_gpu).sum(), (s_gpu & ~s_cpu).sum()))
            same = s_cpu == s_gpu
            diff = (u_gpu - u_cpu)[same]
            du = float(np.linalg.norm(diff) / np.linalg.norm(u_cpu))
            dmax = float(np.abs(diff).max() / np.abs(u_cpu).max())
            print(f"[zoo] {name} (d={model.num_params}), one sketch round, "
                  f"card vs CPU: max rel dloss {dl:.3e}, update L2 "
                  f"difference {du:.3e} of its norm (largest single "
                  f"{dmax:.3e} of the largest), support {int(s_cpu.sum())} "
                  f"coordinates, {swaps} swapped", flush=True)
            if not (dl <= ZOO_LOSS_RTOL and du <= ZOO_UPDATE_RTOL
                    and swaps <= ZOO_SWAPS and s_cpu.sum() > 0):
                fail(f"{name}: the card's round disagrees with the CPU's "
                     f"(dloss {dl}, dupdate {du}, swaps {swaps})")
            out[name] = (dl, du, swaps)
    return out


def write_leaf_femnist(root: str, writers: int, per_writer: int,
                       test_per_writer: int, files: int,
                       seed: int = 0) -> int:
    """A LEAF FEMNIST directory in the real schema (``train/`` and
    ``test/`` of ``all_data_<i>.json``, each ``{"users", "num_samples",
    "user_data": {user: {"x": [784-float lists], "y": [ints]}}}``):
    ``writers`` writers split over ``files`` files, white pixels (1.00)
    with the darker strokes of a seeded prototype of each of the 62
    classes, numbers of 2 decimals laid out by numpy rather than by
    ``json.dump``. Returns the bytes written."""
    import numpy as np
    rng = np.random.RandomState(seed)
    protos = rng.rand(62, 28, 28) < 0.15
    levels = np.frombuffer(b"".join(f"{v / 100:.2f}".encode()
                                    for v in range(101)),
                           np.uint8).reshape(101, 4)
    total = 0
    for split, per in (("train", per_writer), ("test", test_per_writer)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i, users in enumerate(np.array_split(np.arange(writers), files)):
            names = [f"f{u:04d}_{u % 89:02d}" for u in users]
            parts = []
            for name in names:
                y = rng.randint(0, 62, per)
                dark = protos[y] ^ (rng.rand(per, 28, 28) < 0.02)
                level = np.where(dark, rng.randint(0, 60, dark.shape),
                                 100).reshape(per, 784)
                # each image "[p,p,...,p]" and a "," after it, the last "]"
                img = np.empty((per, 784 * 5 + 2), np.uint8)
                img[:, 0] = ord("[")
                body = img[:, 1:-1].reshape(per, 784, 5)
                body[:, :, :4] = levels[level]
                body[:, :, 4] = ord(",")
                body[:, -1, 4] = ord("]")
                img[:, -1] = ord(",")
                img[-1, -1] = ord("]")
                parts.append(b'"' + name.encode() + b'": {"x": ['
                             + img.tobytes() + b', "y": '
                             + json.dumps(y.tolist()).encode() + b"}")
            blob = (b'{"users": ' + json.dumps(names).encode()
                    + b', "num_samples": '
                    + json.dumps([per] * len(names)).encode()
                    + b', "user_data": {' + b", ".join(parts) + b"}}")
            with open(os.path.join(root, split, f"all_data_{i}.json"),
                      "wb") as f:
                f.write(blob)
            total += len(blob)
    return total


def phase_femnist():
    """The FEMNIST FetchSGD round through the user's entry point at full
    width: a LEAF directory of FEMNIST_WRITERS writers is written and
    prepared (its times printed), then FEMNIST_ROUNDS rounds of
    ResNet101LN and one validation, every launch count set to 0 just
    before; exactly FEMNIST_PER_ROUND launches a round, d and m as
    predicted, finite losses. Returns (launches, median round ms)."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.data.fed_emnist import FedEMNIST
    from commefficient_torch.ops import circulant_kernels as K

    root = os.path.join(DATA_ROOT["path"], "femnist")
    t0 = time.perf_counter()
    nbytes = write_leaf_femnist(root, FEMNIST_WRITERS, FEMNIST_PER_WRITER,
                                FEMNIST_TEST_PER_WRITER, FEMNIST_FILES)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = FedEMNIST(root)
    prepare_s = time.perf_counter() - t0
    n_writers, n_images = train.num_clients, len(train)
    del train
    print(f"[femnist] LEAF directory: {FEMNIST_WRITERS} writers x "
          f"{FEMNIST_PER_WRITER} train + {FEMNIST_TEST_PER_WRITER} test "
          f"images in {FEMNIST_FILES} files a split, {nbytes / 1e6:.1f} MB "
          f"of json written in {write_s:.2f} s; prepared (json ingest to "
          f"FedEMNIST_train/val.npz) in {prepare_s:.2f} s: {n_writers} "
          f"clients, {n_images} images", flush=True)
    if n_writers != FEMNIST_WRITERS:
        fail(f"FEMNIST prepared {n_writers} writers, wrote "
             f"{FEMNIST_WRITERS}")
    argv = FEMNIST_ARGV + ["--dataset_dir", root]
    print("[femnist] python -m commefficient_torch.cv_train "
          + " ".join(argv), flush=True)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    out = entry_main(cv_train, argv)
    launches = dict(K.launches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rt = out["runtime"]
    want = {n: c * FEMNIST_ROUNDS for n, c in FEMNIST_PER_ROUND.items()}
    if out["rounds"] != FEMNIST_ROUNDS or out["summary"] is None:
        fail(f"FEMNIST ran {out['rounds']} rounds (summary "
             f"{out['summary']}), wanted {FEMNIST_ROUNDS}")
    if not np.isfinite(out["losses"]).all() or \
            not math.isfinite(out["val_loss"]):
        fail(f"FEMNIST non-finite losses {out['losses']} / "
             f"{out['val_loss']}")
    if (rt.cfg.grad_size, rt.cfg.num_cols, rt.cs.m) != (
            FEMNIST_SKETCH["d"], FEMNIST_SKETCH["c"], 87):
        fail(f"FEMNIST d={rt.cfg.grad_size} c={rt.cfg.num_cols} "
             f"m={rt.cs.m}, want {FEMNIST_SKETCH} and m = 87")
    if out["train_store"] is None or rt.num_clients != FEMNIST_WRITERS:
        fail("FEMNIST: the writers are not served by the device store")
    if launches != want:
        fail(f"FEMNIST launches {launches}, want {want}")
    med = statistics.median(out["round_s"][1:])
    print(f"[femnist] ResNet101LN d={rt.cfg.grad_size} m={rt.cs.m}: "
          f"{FEMNIST_ROUNDS} rounds, median of rounds 2-{FEMNIST_ROUNDS} "
          f"{med * 1e3:.3f} ms (all: "
          f"{[round(t * 1e3, 3) for t in out['round_s']]}), "
          f"{8 * FEMNIST_PER_WRITER / med:.1f} img/s, losses "
          f"{[round(float(x), 5) for x in out['losses']]}, val loss "
          f"{out['val_loss']:.5f}, launches {launches} (want {want}), "
          f"peak memory {peak / 2**30:.3f} GiB", flush=True)
    del out, rt
    torch.cuda.empty_cache()
    return launches, med * 1e3


def phase_fixup():
    """BASELINE config 3 through the entry point: FixupResNet50 on CIFAR100,
    true_topk, 100 clients, 8 a round, FIXUP_ROUNDS rounds with Fixup's
    (d,) rate vector; in the first round the server rule runs once more at
    rate 1, and its update times the rate vector must be the round's
    update bit for bit (the rounds after it, which the median reads, run
    it once). Returns (launches, median round ms, share of 0.1 rates)."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.core import runtime as runtime_mod
    from commefficient_torch.ops import circulant_kernels as K

    orig, checked = runtime_mod.server_update, []

    def server_update(cfg, agg, vel, err, lr, *args, **kw):
        out = orig(cfg, agg, vel, err, lr, *args, **kw)
        if lr.ndim and not checked:
            unit = orig(cfg, agg, vel, err, torch.ones_like(lr[0]), *args,
                        **kw)
            checked.append(torch.equal(out[0], unit[0] * lr)
                           and int((out[0] != 0).sum()) > 0)
        return out

    argv = FIXUP_ARGV + dataset_flags("cifar100_64")
    print("[fixup] python -m commefficient_torch.cv_train " + " ".join(argv),
          flush=True)
    K.reset_launches()
    runtime_mod.server_update = server_update
    try:
        out = entry_main(cv_train, argv)
    finally:
        runtime_mod.server_update = orig
    launches = dict(K.launches)
    mult, rt = out["lr_mult"], out["runtime"]
    if out["rounds"] != FIXUP_ROUNDS or out["summary"] is None \
            or not np.isfinite(out["losses"]).all():
        fail(f"FixupResNet50: {out['rounds']} rounds, losses "
             f"{out['losses']}, summary {out['summary']}")
    if rt.cfg.grad_size != FIXUP_D or mult is None \
            or tuple(mult.shape) != (FIXUP_D,) or mult.device.type != "cuda":
        fail(f"FixupResNet50: d={rt.cfg.grad_size}, multiplier "
             f"{None if mult is None else tuple(mult.shape)}")
    if checked != [True]:
        fail(f"FixupResNet50: the round's update is not lr * lr_mult * the "
             f"unscaled update ({checked})")
    if any(launches.values()):
        fail(f"FixupResNet50 true_topk launched sketch kernels {launches}")
    tenth = int((mult != 1.0).sum())
    med = statistics.median(out["round_s"][1:])
    print(f"[fixup] FixupResNet50 d={FIXUP_D}: the (d,) multiplier in use, "
          f"0.1 on {tenth} parameters ({tenth / FIXUP_D:.6f} of d); round "
          f"1's update equals lr * lr_mult * the unscaled update bit for "
          f"bit; median of rounds 2-{FIXUP_ROUNDS} {med * 1e3:.3f} ms "
          f"(all: {[round(t * 1e3, 3) for t in out['round_s']]}), losses "
          f"{[round(float(x), 5) for x in out['losses']]}", flush=True)
    del out, rt, mult
    torch.cuda.empty_cache()
    return launches, med * 1e3, tenth / FIXUP_D


# the round input pipeline on the store paths: each path's rounds inline
# and on the worker thread, in the order inline, threaded, threaded, inline
PIPELINE_AB_ROUNDS = {"ResNet-9": 12, "FEMNIST ResNet101LN": 6,
                      "FixupResNet50 CIFAR100": 6}


def phase_pipeline_ab():
    """What the round input pipeline costs or saves where the device store
    feeds the rounds (the fetch is a few kernels of gather and
    augmentation): the main path's ResNet-9, the FEMNIST ResNet101LN
    round and the FixupResNet50 true_topk round, PIPELINE_AB_ROUNDS
    rounds a run, four runs a path (inline, threaded, threaded, inline).
    Each run is the driver's loop (``RoundPipeline`` over ``make_fetch``
    at depth 2, the round, a sync), timed on the host clock: the round
    alone, as the driver's ``round_s``, and the loop's wall a round, the
    first round left out of both. Returns {path: {way: [(median round
    ms, wall ms a round) of each run]}}."""
    import itertools
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.config import parse_known
    from commefficient_torch.core.driver import epoch_sampler, make_fetch
    from commefficient_torch.core.pipeline import RoundPipeline

    paths = {
        "ResNet-9": MAIN_ARGV + dataset_flags("synthetic64"),
        "FEMNIST ResNet101LN": FEMNIST_ARGV + [
            "--dataset_dir", os.path.join(DATA_ROOT["path"], "femnist")],
        "FixupResNet50 CIFAR100": FIXUP_ARGV + dataset_flags("cifar100_64"),
    }
    out = {}
    for path, argv in paths.items():
        n = PIPELINE_AB_ROUNDS[path]
        rt, state, train_ds, val_ds = cv_train.setup(
            parse_known(cv_train.build_parser(), argv))[:4]
        store, _ = cv_train.make_stores(rt, train_ds, val_ds)
        if store is None:
            fail(f"[pipeline] {path}: no device store")
        fetch = make_fetch(rt, train_ds, store)
        mult = cv_train.lr_multiplier(rt)
        lr = 0.01 if mult is None else 0.01 * mult
        runs = {"inline": [], "threaded": []}
        for way in ("inline", "threaded", "threaded", "inline"):
            rounds = itertools.chain.from_iterable(
                epoch_sampler(rt.cfg, train_ds, e)
                for e in itertools.count())
            round_s, ends = [], []
            torch.cuda.synchronize()
            with RoundPipeline(rounds, fetch, start_round=0, max_rounds=n,
                               depth=2, enabled=way == "threaded",
                               device=rt.device) as pipe:
                for item in pipe:
                    t0 = time.perf_counter()
                    state, _ = rt.round(state, item.rnd.client_ids,
                                        item.batch, item.rnd.mask, lr)
                    torch.cuda.synchronize()
                    ends.append(time.perf_counter())
                    round_s.append(ends[-1] - t0)
            runs[way].append((1e3 * statistics.median(round_s[1:]),
                              1e3 * (ends[-1] - ends[0]) / (n - 1)))
        out[path] = runs
        print(f"[pipeline] {path} on the store path, {n} rounds a run "
              "(median round ms, wall ms a round): "
              + "; ".join(f"{way} " + ", ".join(f"{a:.3f}/{b:.3f}"
                                                for a, b in r)
                          for way, r in runs.items()), flush=True)
        del rt, state, store, fetch, train_ds, val_ds, mult, lr
        torch.cuda.empty_cache()
    return out


# the ImageNet recipe (scripts/imagenet.sh) on one device: FixupResNet50 at
# 224 x 224 x 3 and 1,000 classes (d = 25,504,026), 7 iid clients of 64
# images a round (448 images), weight decay 1e-4, on a synthetic ImageNet
# of 8 classes x 64 (77 MB of uint8: the device store); its sketch form at
# c = 500,000 -> 500,736, so m = ceil(d / c) = 51: 7 fused client encodes
# and the weight-decay encode = 8 K1, and 1 K2, a round
IMAGENET_SKETCH = dict(d=25_504_026, c=500_736, r=5)
IMAGENET_M = 51
IMAGENET_ROUNDS = 3
IMAGENET_IMAGES = 7 * 64
IMAGENET_ARGV = ["--dataset_name", "ImageNet", "--model", "FixupResNet50",
                 "--mode", "uncompressed", "--error_type", "virtual",
                 "--virtual_momentum", "0.9", "--local_momentum", "0",
                 "--weight_decay", "1e-4", "--lr_scale", "0.4",
                 "--pivot_epoch", "2", "--num_workers", "7",
                 "--num_clients", "7", "--iid", "--local_batch_size", "64",
                 "--valid_batch_size", "64", "--mesh_shape", "",
                 "--checkpoint", "--num_rounds", str(IMAGENET_ROUNDS)]
IMAGENET_MODES = {
    "uncompressed": ([], sketch_launches(1, 0, 0, 0)),
    "sketch": (["--mode", "sketch", "--k", "50000", "--num_rows", "5"],
               sketch_launches(1, 8, 1, 1)),
}
IMAGENET_STORE_PER_CLASS = 64
# the host path: 8 classes x 2,000 images (2.41 GB of uint8, over the
# store's 2 GiB), inline and pipelined
IMAGENET_HOST_PER_CLASS = 2000
# the same rounds twice on the card, from the same batches: the losses
# agree within the card's run-to-run spread (cuDNN's weight-gradient
# kernels may sum in another order from run to run, so the second round
# on may start from weights a few ulps apart)
HOST_LOSS_RTOL = 1e-3
# the finetune two-step: FixupResNet50 on CIFAR100 with --checkpoint, then
# its head (fc: 2,048 x 10 + 10 = 20,490 weights) on CIFAR10. Uncompressed:
# the head is smaller than the sketch's k = 50,000 and than one row of its
# table, so a sketch or a top-k would pass it whole
FINETUNE_ROUNDS = 2
FINETUNE_D = 2048 * 10 + 10
FINETUNE_COMMON = ["--model", "FixupResNet50", "--mode", "uncompressed",
                   "--error_type", "virtual", "--virtual_momentum", "0.9",
                   "--local_momentum", "0", "--num_workers", "8",
                   "--local_batch_size", "64", "--valid_batch_size", "400",
                   "--num_rounds", str(FINETUNE_ROUNDS)]
COMPAT_STEPS = 2


def imagenet_argv(root: str, per_class: int, extra=()):
    return IMAGENET_ARGV + [
        "--dataset_dir", root, "--synthetic_per_class", str(per_class),
        "--checkpoint_path", os.path.join(DATA_ROOT["path"], "imagenet_ck"),
        *extra]


def phase_imagenet():
    """The ImageNet recipe through the user's entry point on a synthetic
    ImageNet at 224 x 224 served by the device store: IMAGENET_ROUNDS
    rounds of the recipe (uncompressed) and of its sketch form, every
    launch count set to 0 just before each run: exactly IMAGENET_MODES'
    launches a round, finite losses, d = 25,504,026 (m = 51 in the
    sketch), the final weights written by ``--checkpoint``; then one
    ``profile_round`` call of the sketch round for the device's idle
    share. Returns ({mode: launches}, {mode: median ms}, idle share)."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train, profile_round
    from commefficient_torch.bench.bench_imagenet import imagenet_flops
    from commefficient_torch.data.fed_imagenet import FedImageNet
    from commefficient_torch.ops import circulant_kernels as K

    # no ImageNet tree here: the synthetic set is prepared first, and the
    # recipe reads it as a prepared directory
    root = os.path.join(DATA_ROOT["path"], "imagenet_store")
    FedImageNet(root, synthetic=True,
                synthetic_per_class=IMAGENET_STORE_PER_CLASS)
    flops = imagenet_flops(IMAGENET_IMAGES)
    launches, medians = {}, {}
    for mode, (flags, per_round) in IMAGENET_MODES.items():
        argv = imagenet_argv(root, IMAGENET_STORE_PER_CLASS, flags)
        print(f"[imagenet] python -m commefficient_torch.cv_train "
              + " ".join(repr(a) if a == "" else a for a in argv),
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        out = entry_main(cv_train, argv)
        launches[mode] = dict(K.launches)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        rt, mult = out["runtime"], out["lr_mult"]
        want = {n: c * IMAGENET_ROUNDS for n, c in per_round.items()}
        if out["rounds"] != IMAGENET_ROUNDS or out["summary"] is None \
                or not np.isfinite(out["losses"]).all() \
                or not math.isfinite(out["val_loss"]):
            fail(f"ImageNet {mode}: {out['rounds']} rounds, losses "
                 f"{out['losses']}, val {out['val_loss']}")
        if rt.cfg.grad_size != IMAGENET_SKETCH["d"] or \
                out["train_store"] is None or mult is None:
            fail(f"ImageNet {mode}: d={rt.cfg.grad_size}, store "
                 f"{out['train_store']}, multiplier {mult}")
        if mode == "sketch" and (rt.cfg.num_cols, rt.cs.m) != (
                IMAGENET_SKETCH["c"], IMAGENET_M):
            fail(f"ImageNet sketch c={rt.cfg.num_cols} m={rt.cs.m}, want "
                 f"{IMAGENET_SKETCH['c']} and {IMAGENET_M}")
        if launches[mode] != want:
            fail(f"ImageNet {mode} launches {launches[mode]}, want {want}")
        saved = os.path.join(DATA_ROOT["path"], "imagenet_ck",
                             "FixupResNet50.npz")
        with np.load(saved) as f:
            if f["ps_weights"].shape != (IMAGENET_SKETCH["d"],):
                fail(f"--checkpoint wrote {f['ps_weights'].shape}")
        med = statistics.median(out["round_s"][1:])
        medians[mode] = med * 1e3
        tenth = float((mult != 1.0).float().mean())
        print(f"[imagenet] {mode}: FixupResNet50 at 224 x 224, d="
              f"{rt.cfg.grad_size}"
              + (f", c={rt.cfg.num_cols}, m={rt.cs.m}" if mode == "sketch"
                 else "")
              + f"; {IMAGENET_ROUNDS} rounds, median of rounds 2-"
              f"{IMAGENET_ROUNDS} {med * 1e3:.3f} ms (all: "
              f"{[round(t * 1e3, 3) for t in out['round_s']]}), "
              f"{IMAGENET_IMAGES / med:.1f} img/s; model FLOPs "
              f"{flops / 1e12:.3f} TFLOP a round, {flops / med / 1e12:.1f} "
              f"TFLOP/s, {flops / med / H100_BF16_PER_S:.4f} of 989 "
              f"TFLOP/s; losses {[round(float(x), 5) for x in out['losses']]}"
              f", val loss {out['val_loss']:.5f}; the Fixup multiplier's "
              f"0.1 on {tenth:.6f} of d; peak memory {peak / 2**30:.3f} GiB"
              f"; store {out['train_store'].nbytes / 2**20:.1f} MiB; "
              f"launches {launches[mode]} (want {want})", flush=True)
        del out, rt, mult
        torch.cuda.empty_cache()
    argv = imagenet_argv(root, IMAGENET_STORE_PER_CLASS,
                         IMAGENET_MODES["sketch"][0]
                         + ["--warmup", "1", "--rounds", "2"])
    print("[imagenet] python -m commefficient_torch.profile_round "
          + " ".join(repr(a) if a == "" else a for a in argv), flush=True)
    prof = profile_round.main(argv)
    idle = prof["device_idle_share_of_wall"]
    print(f"[imagenet] sketch round profiled: device busy "
          f"{prof['device_busy_ms_per_round']:.3f} ms of a "
          f"{prof['wall_ms_per_round']:.3f} ms profiled wall a round, idle "
          f"share {idle:.3f}, {prof['device_ops_per_round']:.0f} device "
          "operations a round; by group (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      prof["kernel_ms_per_round_by_group"].items()),
          flush=True)
    torch.cuda.empty_cache()
    return launches, medians, idle


def phase_imagenet_host():
    """The recipe on a synthetic ImageNet over the store's cut-off (the
    host path: the host gather with ``ImagenetTrain``'s flip and the
    upload from pinned memory), IMAGENET_ROUNDS rounds inline
    (``--no_pipeline``) and pipelined (``--prefetch_depth 2``): the
    batches trained on bitwise equal round by round (kept on the card,
    a sha256 digest a round printed), the losses within HOST_LOSS_RTOL;
    prints the fetch, the wait and the round for both. Returns {way:
    (median fetch ms, median wait ms, median round ms)}."""
    import hashlib
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.core import driver
    from commefficient_torch.data.fed_imagenet import FedImageNet
    from commefficient_torch.ops import circulant_kernels as K

    root = os.path.join(DATA_ROOT["path"], "imagenet_host")
    t0 = time.perf_counter()
    ds = FedImageNet(root, synthetic=True,
                     synthetic_per_class=IMAGENET_HOST_PER_CLASS)
    prep_s = time.perf_counter() - t0
    nbytes, n_images = ds.arrays["image"].nbytes, len(ds)
    del ds
    print(f"[imagenet-host] synthetic ImageNet of 8 classes x "
          f"{IMAGENET_HOST_PER_CLASS} at 224 x 224 ({nbytes / 1e9:.3f} GB "
          f"of uint8 train images, {n_images} images) generated and "
          f"prepared in {prep_s:.2f} s", flush=True)
    make_fetch = driver.make_fetch
    runs = {}
    for way, flags in (("inline", ["--no_pipeline"]),
                       ("pipelined", ["--prefetch_depth", "2"])):
        kept = []

        def keeping(*args, **kw):
            fetch = make_fetch(*args, **kw)

            def wrapped(rnd, g):
                batch = fetch(rnd, g)
                kept.append({k: v.clone() for k, v in batch.items()})
                return batch
            return wrapped

        argv = imagenet_argv(root, IMAGENET_HOST_PER_CLASS, flags)
        print("[imagenet-host] python -m commefficient_torch.cv_train "
              + " ".join(repr(a) if a == "" else a for a in argv),
              flush=True)
        K.reset_launches()
        driver.make_fetch = keeping
        try:
            out = entry_main(cv_train, argv)
        finally:
            driver.make_fetch = make_fetch
        if out["train_store"] is not None:
            fail("the 2.41 GB ImageNet went to the device store")
        if out["rounds"] != IMAGENET_ROUNDS or len(kept) != IMAGENET_ROUNDS \
                or not np.isfinite(out["losses"]).all() \
                or any(K.launches.values()):
            fail(f"ImageNet host path {way}: {out['rounds']} rounds, "
                 f"{len(kept)} batches, losses {out['losses']}, launches "
                 f"{dict(K.launches)}")
        runs[way] = (out["losses"], out["fetch_s"], out["data_s"],
                     out["round_s"], kept)
        del out
    (l_a, _, _, _, b_a), (l_b, _, _, _, b_b) = runs.values()
    digests = []
    for i, (a, b) in enumerate(zip(b_a, b_b)):
        if a.keys() != b.keys() or not all(
                torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8))
                for k in a):
            fail(f"round {i + 1}: the pipelined batch differs from the "
                 "inline one")
        h = hashlib.sha256()
        for k in sorted(a):
            h.update(a[k].cpu().numpy().tobytes())
        digests.append(h.hexdigest()[:16])
    dloss = max(abs(x - y) / abs(y) for x, y in zip(l_b, l_a))
    print(f"[imagenet-host] the batches of rounds 1-{IMAGENET_ROUNDS} are "
          f"bitwise equal inline and pipelined (sha256 {digests}); losses "
          f"inline {[round(float(x), 6) for x in l_a]}, pipelined "
          f"{[round(float(x), 6) for x in l_b]}: largest relative "
          f"difference {dloss:.3e} (limit {HOST_LOSS_RTOL})", flush=True)
    if dloss > HOST_LOSS_RTOL:
        fail(f"the pipelined losses differ from the inline ones by {dloss}")
    out = {}
    for way, (_, fetch_s, wait_s, round_s, _) in runs.items():
        med = [1e3 * statistics.median(x[1:]) for x in (fetch_s, wait_s,
                                                       round_s)]
        out[way] = tuple(med)
        print(f"[imagenet-host] {way}: medians of rounds 2-"
              f"{IMAGENET_ROUNDS}: fetch {med[0]:.3f} ms (the host gather, "
              f"flip, normalisation and upload, synced), the round's wait "
              f"for its batch {med[1]:.3f} ms, round {med[2]:.3f} ms; all "
              f"fetches {[round(t * 1e3, 3) for t in fetch_s]}, waits "
              f"{[round(t * 1e3, 3) for t in wait_s]}", flush=True)
    del runs, b_a, b_b
    torch.cuda.empty_cache()
    return out


def phase_native():
    """The native host gather on this machine: the port's host-path CIFAR
    batch (``FedDataset.gather`` through ``CifarTrain``, one main-path
    round of 8 x 64 images) against its numpy twin within
    NATIVE_PLAIN_ATOL, each element from the twin's source pixel, the
    same bits for 1 to 16 threads, and its time beside the numpy stream's
    on the same round. Returns (native ms, numpy ms)."""
    import numpy as np
    from commefficient_torch.core.driver import epoch_sampler
    from commefficient_torch.config import FedConfig
    from commefficient_torch.data import native
    from commefficient_torch.data import transforms as T
    from commefficient_torch.data.fed_cifar import FedCIFAR10

    if not native.enabled():
        fail("COMMEFFICIENT_NATIVE=0: the native host gather is off")
    ds = FedCIFAR10(dataset_flags("synthetic64")[1],
                    transform=T.CifarTrain(seed=21))
    cfg = FedConfig(num_workers=8, local_batch_size=64)
    rnd = next(iter(epoch_sampler(cfg, ds, 0)))
    got = ds.gather(rnd.idx)["image"]
    # the same draws again (a fresh transform at the seed), timed
    ds.transform = T.CifarTrain(seed=21)
    t0 = time.perf_counter()
    again = ds.gather(rnd.idx)["image"]
    native_ms = 1e3 * (time.perf_counter() - t0)
    images = ds.arrays["image"]
    twin = native_gather_augment_plain(images, rnd.idx, T.CIFAR10_MEAN,
                                       T.CIFAR10_STD, 4, True, (21 << 20) + 1)
    err = float(np.abs(got - twin).max())
    px = np.rint((got * T.CIFAR10_STD + T.CIFAR10_MEAN) * 255)
    px_twin = np.rint((twin * T.CIFAR10_STD + T.CIFAR10_MEAN) * 255)
    threads = {0: np.array_equal(again.view(np.int32), got.view(np.int32))}
    for n in (1, 2, 4, 8, 16):
        again = native.gather_augment(images, rnd.idx, T.CIFAR10_MEAN,
                                      T.CIFAR10_STD, 4, True,
                                      (21 << 20) + 1, num_threads=n)
        threads[n] = np.array_equal(again.view(np.int32), got.view(np.int32))
    t0 = time.perf_counter()
    T.CifarTrain(seed=21)({"image": images[rnd.idx]})
    numpy_ms = 1e3 * (time.perf_counter() - t0)
    print(f"[native] host CIFAR batch of {rnd.idx.size} images through the "
          f"native gather ({native.library_path()}): max |diff| to the "
          f"numpy twin {err:.3e} (limit {NATIVE_PLAIN_ATOL:.3e}), "
          f"{float((got != twin).mean()):.4f} of the values differ (the "
          f"fused multiply-add), source pixels equal "
          f"{bool(np.array_equal(px, px_twin))}; bitwise equal for threads "
          f"{threads} (0: the default); {native_ms:.3f} ms against "
          f"{numpy_ms:.3f} ms for the numpy stream", flush=True)
    if err > NATIVE_PLAIN_ATOL or not np.array_equal(px, px_twin) \
            or not all(threads.values()):
        fail(f"the native gather disagrees with its numpy twin ({err}, "
             f"threads {threads})")
    return native_ms, numpy_ms


def phase_finetune():
    """The finetune two-step through the entry point: FINETUNE_ROUNDS
    rounds of FixupResNet50 on CIFAR100 with ``--checkpoint``, then
    ``--finetune --finetuned_from CIFAR100`` on CIFAR10 for
    FINETUNE_ROUNDS rounds: the federated vector is the head (d =
    FINETUNE_D), which moves; the frozen backbone on the card is the saved
    one bit for bit. Returns the median round ms of the finetune."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.ops import circulant_kernels as K

    ck = os.path.join(DATA_ROOT["path"], "finetune_ck")
    argv = FINETUNE_COMMON + ["--dataset_name", "CIFAR100", "--checkpoint",
                              "--checkpoint_path", ck] \
        + dataset_flags("cifar100_64")
    print("[finetune] python -m commefficient_torch.cv_train "
          + " ".join(argv), flush=True)
    first = entry_main(cv_train, argv)
    full_layout = first["runtime"].layout
    del first
    with np.load(os.path.join(ck, "FixupResNet50.npz")) as f:
        saved = torch.from_numpy(f["ps_weights"])
    pieces, at = [], 0
    for path, shape in full_layout:
        n = math.prod(shape)
        if not path.startswith("params/fc/"):
            pieces.append(saved[at:at + n])
        at += n
    backbone = torch.cat(pieces)
    argv = FINETUNE_COMMON + ["--dataset_name", "CIFAR10", "--finetune",
                              "--finetuned_from", "CIFAR100",
                              "--finetune_path", ck] \
        + dataset_flags("synthetic64")
    print("[finetune] python -m commefficient_torch.cv_train "
          + " ".join(argv), flush=True)
    K.reset_launches()
    out = entry_main(cv_train, argv)
    rt, state = out["runtime"], out["state"]
    frozen = out["frozen"].frozen_vector
    same = frozen.device.type == "cuda" and torch.equal(
        frozen.cpu().view(torch.int32), backbone.view(torch.int32))
    moved = int((state.ps_weights != 0).sum())
    med = statistics.median(out["round_s"][1:]) if out["rounds"] > 1 \
        else out["round_s"][0]
    print(f"[finetune] head of d={rt.cfg.grad_size} trained "
          f"{out['rounds']} rounds on CIFAR10 (losses "
          f"{[round(float(x), 5) for x in out['losses']]}, val loss "
          f"{out['val_loss']:.5f}, median round {med * 1e3:.3f} ms): "
          f"{moved} of its weights moved from 0; the frozen backbone "
          f"({frozen.numel()} weights on {frozen.device}) is the saved one "
          f"bit for bit: {same}; launches {dict(K.launches)}", flush=True)
    if rt.cfg.grad_size != FINETUNE_D or moved == 0 or not same \
            or not np.isfinite(out["losses"]).all() \
            or any(K.launches.values()):
        fail("the finetune did not train the head alone on the saved "
             "backbone")
    del out, rt, state, frozen
    torch.cuda.empty_cache()
    return med * 1e3


def phase_compat():
    """The reference API: ``FedModel`` over the main path's ResNet-9
    sketch round on the card (its default device), COMPAT_STEPS train
    steps on 8 clients x 64 synthetic CIFAR10 images in the reference's
    flat wire format, then a validation call; exactly the driver's 9 K1
    and 1 K2 a step, none in the validation. Returns the launches."""
    import numpy as np
    import torch
    from commefficient_torch.compat import FedModel, FedOptimizer
    from commefficient_torch.config import FedConfig
    from commefficient_torch.data import transforms as T
    from commefficient_torch.data.fed_cifar import FedCIFAR10
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.resnet9 import ResNet9
    from commefficient_torch.ops import circulant_kernels as K

    ds = FedCIFAR10(dataset_flags("synthetic64")[1],
                    transform=T.CifarEval())
    model = ResNet9(num_classes=10,
                    generator=torch.Generator().manual_seed(21))
    cfg = FedConfig(mode="sketch", error_type="virtual", local_momentum=0.0,
                    virtual_momentum=0.9, num_workers=8, local_batch_size=64,
                    k=50_000, num_rows=5, num_cols=500_000,
                    valid_batch_size=500)
    fm = FedModel(model, make_cv_loss(model), cfg, num_clients=10)
    opt = fm.attach_optimizer(FedOptimizer(fm.cfg, lr=0.1))
    rng = np.random.RandomState(0)
    K.reset_launches()
    losses = []
    for step in range(COMPAT_STEPS):
        clients = rng.choice(10, 8, replace=False)
        idx = np.concatenate([c * 64 + rng.permutation(64)
                              for c in clients])
        batch = ds.gather(idx)
        loss, acc, down, up = fm({"client_id": batch["target"], **batch})
        opt.step()
        losses.append(loss)
        if (up > 0).sum() != 8 or not np.isfinite(loss).all():
            fail(f"FedModel step {step}: losses {loss}, uploads {up}")
    train_launches = dict(K.launches)
    fm.train(False)
    val = FedCIFAR10(dataset_flags("synthetic64")[1], train=False,
                     transform=T.CifarEval()).gather(np.arange(160))
    vloss, vacc = fm({"client_id": np.full(160, -1), **val})
    want = sketch_launches(COMPAT_STEPS)
    print(f"[compat] FedModel on {fm.runtime.device}, ResNet-9 sketch "
          f"(d={fm.cfg.grad_size}, m={fm.runtime.cs.m}): {COMPAT_STEPS} "
          f"steps, losses {[[round(float(v), 5) for v in x] for x in losses]}"
          ", "
          f"launches {train_launches} (want {want}); validation loss "
          f"{float(vloss[0]):.5f}, acc {float(vacc[0]):.4f}, launches after "
          f"it {dict(K.launches)}", flush=True)
    if fm.runtime.device.type != "cuda" or train_launches != want \
            or dict(K.launches) != want or not np.isfinite(vloss).all():
        fail("FedModel's round did not launch the driver's kernels")
    del fm, model
    torch.cuda.empty_cache()
    return train_launches


# ---- the sketch wire, the SRHT's row scan, the streaming encode

# StreamMLP at the streaming encode's card shape: d = 102,830,080
# (d 4 = 411 MB), r = 5, c = 524,288 (m = 197), k = 50,000, 8 clients x
# 32 samples, 3 rounds; a microbatch streams 2 L + 2 = 50 K1 ranges
STREAM = dict(L=24, H=2048, d_in=1024, classes=10)
STREAM_SKETCH = dict(d=102_830_080, c=524_288, r=5)
STREAM_ROUNDS = 3
STREAM_W, STREAM_B = 8, 32
# the first round's update with the hook against the flat path: the same
# gradient values summed into the table in another order, then the top-k
# of 50,000 of 102.8 M estimates (a coordinate at the edge may swap)
STREAM_UPDATE_RTOL = 1e-2
# K1's range form: the weight- and bias-sized ranges timed, and the
# ranges held bitwise to the plain version (start, n), d the shape's
RANGE_WEIGHT = 4 * 1024 * 1024
RANGE_BIAS = 2048


def range_cases(d: int, c: int):
    """(label, start, n) of the K1 ranges checked bitwise: on a block
    boundary, straddling one, inside one block, ending at d, one value,
    and the whole vector."""
    return [("block boundary, weight-sized", 5 * c, RANGE_WEIGHT),
            ("straddling a boundary", 7 * c - 1000, 5000),
            ("inside one block, bias-sized", 10 * c + 100, RANGE_BIAS),
            ("ending at d", d - 3_000_000, 3_000_000),
            ("one value", d // 2, 1),
            ("whole vector", 0, d)]


def phase_kernels_range(shape: dict, scale: float, plain_n: int = 5):
    """K1's range form at (d, c, r) of ``shape``: each of ``range_cases``
    bitwise (``same_bits``) its plain version, fresh and accumulating, and
    the whole range bitwise the whole-vector call (which phase_kernels
    holds bitwise to the plain version, unchanged for the whole vector);
    the weight- and bias-sized ranges timed beside their bounds
    (``sketch_work`` of n values). Returns {label: timings}."""
    import numpy as np
    import torch
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops.circulant import make_circulant_sketch

    dev = torch.device("cuda")
    d, c, r = shape["d"], shape["c"], shape["r"]
    cs = make_circulant_sketch(d, c, r, device=dev)
    args = (cs.shifts, cs.sign_keys, c, r, cs.m)
    rng = np.random.RandomState(1)
    v = torch.from_numpy(rng.randn(d).astype(np.float32)).to(dev)
    t0 = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(dev)
    for label, start, n in range_cases(d, c):
        vals = v[start:start + n]
        got = K.encode(vals, *args, start=start)
        got_acc = K.encode(vals, *args, scale=scale, table=t0.clone(),
                           start=start)
        want = K.encode_plain(vals, *args, start=start)
        want_acc = K.encode_plain(vals, *args, scale=scale, table=t0,
                                  start=start)
        torch.cuda.synchronize()
        ok = same_bits(got, want) and same_bits(got_acc, want_acc)
        print(f"[range] m={cs.m} [{start}, {start + n}) ({label}): bitwise "
              f"{ok}", flush=True)
        if not ok:
            fail(f"K1's range form differs from its plain version at m="
                 f"{cs.m}, [{start}, {start + n}): max|diff| "
                 f"{float((got_acc - want_acc).abs().max())}")
    whole = K.encode(v, *args)
    if not same_bits(K.encode(v, *args, start=0), whole):
        fail(f"K1 at start 0, n = d differs from the whole-vector call at "
             f"m={cs.m}")
    out = {}
    for label, start, n in (("weight", 5 * c, RANGE_WEIGHT),
                            ("bias", 10 * c + 100, RANGE_BIAS)):
        vals = v[start:start + n].contiguous()
        acc = t0.clone()
        ms = time_ms(lambda: K.encode(vals, *args, scale=scale, table=acc,
                                      start=start))
        plain_ms = time_ms(lambda: K.encode_plain(
            vals, *args, scale=scale, table=acc, start=start), n=plain_n)
        nbytes, ops, instr = sketch_work(n, c, r)["circ_encode"]
        b_ms, kind = bound(nbytes, ops, H100_FP32_PER_S, instr)
        print(f"[range] m={cs.m}, {label} range of {n} values "
              f"(accumulate): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({kind}: {nbytes / 1e6:.1f} MB, the "
              f"table's {8 * r * c / 1e6:.1f} MB read and written)",
              flush=True)
        out[label] = {"n": n, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": bound_by(kind)}
    return out


WIRE_ROUNDS = 3
# the ResNet-9 main path on each wire: (flags, K1 a round, K2 a round,
# bytes a client a round), and in every arm the zero rule's one cell sum a
# round; int8 at --wire_block 256 is 5 c cells plus a float32 scale every
# 256 columns of a row
WIRE_ARMS = {
    "bf16": (["--wire_dtype", "bfloat16"], 9, 1, 5_007_360),
    "sketch_dtype_alias": (["--sketch_dtype", "bfloat16"], 9, 1, 5_007_360),
    "int8": (["--wire_dtype", "int8"], 9, 1, 2_542_800),
    "int8_again": (["--wire_dtype", "int8"], 9, 1, 2_542_800),
    # the table clip under the default telemetry: each client's dense
    # gradient encoded (8 K1), as the JAX package routes it
    "int8_clip": (["--wire_dtype", "int8", "--max_grad_norm", "1"], 8, 1,
                  2_542_800),
    "int8_hash": (["--wire_dtype", "int8", "--sketch_impl", "hash",
                   "--num_cols", "500736"], 0, 0, 2_542_800),
}


def phase_wire():
    """The ResNet-9 main path (8 x 64, k = 50,000, r = 5, c = 500,736)
    on each of ``WIRE_ARMS`` through ``python -m
    commefficient_torch.cv_train``, WIRE_ROUNDS rounds each: finite
    losses, the exact K1, K2 and cell-sum launches a round, every
    round's upload bytes
    a client held to the arm's bytes and to ``upload_wire_bytes``
    (``RoundRecorder``); the ``--sketch_dtype`` arm warns and its state
    is bitwise the bf16 arm's; the two int8 runs are bitwise equal.
    Returns {arm: (launches, median round ms, bytes)}."""
    import contextlib
    import io

    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.ops import circulant_kernels as K

    out_arms, finals = {}, {}
    for arm, (flags, n_enc, n_dec, want_up) in WIRE_ARMS.items():
        argv = MAIN_ARGV + dataset_flags("synthetic64") + [
            "--num_rounds", str(WIRE_ROUNDS), *flags]
        print(f"[wire] python -m commefficient_torch.cv_train "
              + " ".join(argv), flush=True)
        K.reset_launches()
        err = io.StringIO()
        with RoundRecorder() as rec, contextlib.redirect_stderr(err):
            res = entry_main(cv_train, argv)
        sys.stderr.write(err.getvalue())
        launches = dict(K.launches)
        want = sketch_launches(WIRE_ROUNDS, n_enc, n_dec)
        if res["rounds"] != WIRE_ROUNDS or \
                not np.isfinite(res["losses"]).all() or launches != want:
            fail(f"wire {arm}: {res['rounds']} rounds, losses "
                 f"{res['losses']}, launches {launches} (want {want})")
        cfg = rec.rounds[0][0]
        if cfg.upload_wire_bytes() != want_up:
            fail(f"wire {arm}: upload_wire_bytes {cfg.upload_wire_bytes()}"
                 f", want {want_up}")
        rec.check_bytes(f"wire {arm}", want_up)
        warned = "--sketch_dtype is a deprecated alias" in err.getvalue()
        if warned != ("--sketch_dtype" in flags):
            fail(f"wire {arm}: the deprecation warning printed {warned}")
        finals[arm] = (res["state"].ps_weights.cpu(), res["losses"])
        rt = statistics.median(res["round_s"][1:])
        print(f"[wire] {arm}: median of rounds 2-{WIRE_ROUNDS} "
              f"{rt * 1e3:.3f} ms (all: "
              f"{[round(t * 1e3, 3) for t in res['round_s']]}), "
              f"{want_up} bytes a client a round (float32: "
              f"{4 * cfg.num_rows * cfg.num_cols}), losses "
              f"{[round(float(x), 5) for x in res['losses']]}, launches "
              f"{launches}", flush=True)
        out_arms[arm] = (launches, rt * 1e3, want_up)
        del res, rec
        torch.cuda.empty_cache()
    for a, b in (("bf16", "sketch_dtype_alias"), ("int8", "int8_again")):
        if not (same_bits(finals[a][0], finals[b][0])
                and finals[a][1] == finals[b][1]):
            fail(f"wire: the {b} run is not bitwise the {a} run")
    print("[wire] --sketch_dtype bfloat16 bitwise --wire_dtype bfloat16; "
          "the two int8 runs bitwise equal", flush=True)
    return out_arms


# the SRHT at ResNet-9's width (r c >= d, the rht rule's arm): the first
# round's update with the row scan forced against the batched form,
# within this relative L2 (the same products in other cuBLAS shapes,
# then the top-k of 50,000 estimates, where an edge coordinate may swap)
RHT_SCAN_RTOL = 5e-2
RHT_RESNET_FLAGS = ["--sketch_impl", "rht", "--num_rows", "5",
                    "--num_cols", "1313728"]
GPT2_RHT_ROUNDS = 3
# bytes a client a round on GPT-2's int8 wire: 5 x 524,288 cells plus a
# float32 scale every 256 columns of a row
GPT2_INT8_BYTES = 2_662_400
GPT2_RHT_ARMS = {
    "rht auto (row scan at d' = 2^27)": [],
    "rht --sketch_scan_rows 0": ["--sketch_scan_rows", "0"],
    "rht --sketch_dtype bfloat16": ["--sketch_dtype", "bfloat16"],
}


def phase_rht_scan():
    """The SRHT's row scan. ResNet-9 (main path's round, r = 5, c =
    1,313,728): one round with ``--sketch_scan_rows 1`` and one with
    ``0``, the first update's relative L2 within RHT_SCAN_RTOL. GPT-2
    (main path's flags, ``--sketch_impl rht --allow_divergent_rht``):
    each of GPT2_RHT_ARMS for GPT2_RHT_ROUNDS rounds, no K1/K2 and 96 of
    each K3 a round, its median round and peak memory; the scan arm's
    peak must sit below the batched arm's. Returns ({arm: (median ms,
    peak bytes)}, the ResNet-9 relative L2, {arm: (launches of the
    rounds, of the validations)})."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.ops import circulant_kernels as K

    updates = {}
    for flag in ("1", "0"):
        argv = MAIN_ARGV + dataset_flags("synthetic64") + RHT_RESNET_FLAGS \
            + ["--sketch_scan_rows", flag, "--num_rounds", "1"]
        print("[rht] python -m commefficient_torch.cv_train "
              + " ".join(argv), flush=True)
        K.reset_launches()
        with LaunchSplit(lambda: dict(K.launches), True) as split:
            res = entry_main(cv_train, argv)
        before, after = split.first_weights
        if not np.isfinite(res["losses"]).all() or any(K.launches.values()):
            fail(f"rht scan {flag}: losses {res['losses']}, launches "
                 f"{K.launches}")
        updates[flag] = (before - after).double()
    rel = float((updates["1"] - updates["0"]).norm() / updates["0"].norm())
    print(f"[rht] ResNet-9 width, first round's update, --sketch_scan_rows "
          f"1 against 0: relative L2 {rel:.3e} (limit {RHT_SCAN_RTOL})",
          flush=True)
    if not rel <= RHT_SCAN_RTOL:
        fail(f"the SRHT's row scan moves the first update by {rel:.3e}")
    arms, runs = {}, {}
    for arm, flags in GPT2_RHT_ARMS.items():
        rounds, val, ms, info = phase_gpt2_main(
            ["--sketch_impl", "rht", "--allow_divergent_rht", *flags],
            GPT2_RHT_ROUNDS, encodes=0, decodes=0, cells=0)
        arms[arm], runs[arm] = (ms, info["peak"]), (rounds, val)
        torch.cuda.empty_cache()
    print("[rht] GPT-2 SRHT arms, median round (ms) / peak memory (GiB): "
          + ", ".join(f"{a} {ms:.3f} / {p / 2**30:.3f}"
                      for a, (ms, p) in arms.items()), flush=True)
    scan, batched = (arms[a][1] for a in list(GPT2_RHT_ARMS)[:2])
    if not scan < batched:
        fail(f"the SRHT row scan's peak {scan} is not below the batched "
             f"form's {batched}")
    return arms, rel, runs


def phase_stream():
    """The streaming encode: ``FedRuntime`` built directly on a StreamMLP
    (STREAM: L = 24, H = 2,048, d_in = 1,024, 10 classes, d =
    102,830,080), circulant r = 5, c = 524,288 (m = 197), k = 50,000, 8
    clients x 32 seeded samples, STREAM_ROUNDS rounds; once with the
    loss's ``streaming_grad`` and once without it (the flat gradient, one
    whole-vector K1 a microbatch). Exact launches: with the hook 2 L + 2
    K1 ranges a microbatch and one whole-vector K1 (weight decay) a
    round, without it 8 + 1 whole-vector K1, 1 K2 either way; the first
    round's losses equal and its updates within STREAM_UPDATE_RTOL; the
    client step's peak allocation above what is resident before it below
    d 4 bytes with the hook and at least d 4 without. Returns {arm:
    (launches, range launches, median round ms, client-step peak
    bytes)}."""
    import numpy as np
    import torch
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.models.stream_mlp import (init_stream_mlp,
                                                       make_stream_mlp_loss)
    from commefficient_torch.ops import circulant_kernels as K

    L, H, d_in, C = (STREAM[k] for k in ("L", "H", "d_in", "classes"))
    cfg = FedConfig(mode="sketch", error_type="virtual", local_momentum=0.0,
                    virtual_momentum=0.9, k=50_000, num_rows=5,
                    num_cols=STREAM_SKETCH["c"], num_workers=STREAM_W,
                    local_batch_size=STREAM_B, num_clients=100)
    rng = np.random.RandomState(0)
    rounds = []
    for _ in range(STREAM_ROUNDS):
        rounds.append((rng.choice(100, STREAM_W, replace=False),
                       {"x": rng.randn(STREAM_W, STREAM_B, d_in).astype(
                           np.float32),
                        "target": rng.randint(0, C, (STREAM_W, STREAM_B))},
                       np.ones((STREAM_W, STREAM_B), bool)))
    model = init_stream_mlp(d_in, H, L, C,
                            generator=torch.Generator().manual_seed(0),
                            device="cuda")
    d = model.num_params
    if d != STREAM_SKETCH["d"]:
        fail(f"StreamMLP d = {d}, want {STREAM_SKETCH['d']}")
    out, first = {}, {}
    for arm in ("streaming_grad", "flat gradient"):
        loss_fn = make_stream_mlp_loss(model)
        if arm == "flat gradient":
            plain = loss_fn
            loss_fn = lambda f, b, m: plain(f, b, m)  # noqa: E731
        rt = FedRuntime(cfg, model, loss_fn, device="cuda")
        if rt.cs.m != 197 or rt._fused_fn is None:
            fail(f"stream {arm}: m = {rt.cs.m}, fused {rt._fused_fn}")
        fused, peaks = rt._fused_fn, []

        def measured(*args, _fused=fused, _peaks=peaks):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = _fused(*args)
            torch.cuda.synchronize()
            _peaks.append(torch.cuda.max_memory_allocated() - base)
            return res

        rt._fused_fn = measured
        st = rt.init_state()
        K.reset_launches()
        times = []
        for i, (ids, batch, mask) in enumerate(rounds):
            torch.cuda.synchronize()
            t = time.perf_counter()
            w0 = st.ps_weights.clone() if i == 0 else None
            st, met = rt.round(st, ids, batch, mask, 0.1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if i == 0:
                first[arm] = (met["results"][0].cpu(),
                              (w0 - st.ps_weights).double().cpu())
            if not torch.isfinite(met["results"][0]).all():
                fail(f"stream {arm}: non-finite losses")
        launches = dict(K.launches)
        ranges = K.range_launches["circ_encode"]
        per_mb = 2 * L + 2
        want_ranges = (per_mb * STREAM_W * STREAM_ROUNDS
                       if arm == "streaming_grad" else 0)
        want = {"circ_encode": (want_ranges + STREAM_ROUNDS
                                if arm == "streaming_grad"
                                else (STREAM_W + 1) * STREAM_ROUNDS),
                "circ_decode": STREAM_ROUNDS, "cell_sum": STREAM_ROUNDS}
        if launches != want or ranges != want_ranges:
            fail(f"stream {arm}: launches {launches}, ranges {ranges}; want "
                 f"{want}, {want_ranges} ranges")
        peak = max(peaks)
        med = statistics.median(times[1:])
        print(f"[stream] {arm}: d = {d} (d 4 = {4 * d} bytes), m = 197: "
              f"median of rounds 2-{STREAM_ROUNDS} {med * 1e3:.3f} ms (all:"
              f" {[round(t * 1e3, 3) for t in times]}), launches {launches}"
              f" ({ranges} K1 ranges, {per_mb} a microbatch), client step's"
              f" peak above its resident memory {peak} bytes "
              f"({peak / (4 * d):.4f} d 4)", flush=True)
        out[arm] = (launches, ranges, med * 1e3, peak)
        del rt, st, fused
        torch.cuda.empty_cache()
    (l_s, u_s), (l_f, u_f) = first["streaming_grad"], first["flat gradient"]
    rel = float((u_s - u_f).norm() / u_f.norm())
    print(f"[stream] first round: losses equal {torch.equal(l_s, l_f)}, "
          f"update relative L2 {rel:.3e} (limit {STREAM_UPDATE_RTOL})",
          flush=True)
    if not torch.equal(l_s, l_f) or not rel <= STREAM_UPDATE_RTOL:
        fail(f"stream: the hook's first round differs from the flat path's"
             f" (losses {l_s} / {l_f}, update {rel:.3e})")
    if not (out["streaming_grad"][3] < 4 * d <= out["flat gradient"][3]):
        fail(f"stream: client-step peaks {out['streaming_grad'][3]} (hook) "
             f"and {out['flat gradient'][3]} (flat) against d 4 = {4 * d}")
    return out


# ------------------------------------------------------ the runtime services
# The A10 arms on the ResNet-9 FetchSGD round at full width (8 clients x
# 64, k = 50,000, r = 5, c = 500,736, d = 6,568,640) over the 100-client
# universe of MODE_COMMON (12 rounds an epoch), SERVICE_ROUNDS rounds each.
SERVICE_ROUNDS = 5
SERVICE_ARGV = MODE_COMMON + ["--mode", "sketch", "--virtual_momentum",
                              "0.9", "--num_rounds", str(SERVICE_ROUNDS),
                              "--telemetry_every", "1"]
# a robust arm runs the per-client path with deferred encode: one K1 (the
# aggregate's encode), one K2 and one cell sum a round
ROBUST_ARMS = {
    "normclip": ["--defense", "normclip"],
    "trim": ["--defense", "trim"],
    "signflip_normclip": ["--adversary", "signflip", "--adversary_frac",
                          "0.25", "--defense", "normclip"],
    "nan_quarantine": ["--adversary", "nan", "--adversary_frac", "0.25",
                       "--nonfinite_action", "quarantine"],
}
# the first robust round on the card against the same round on the CPU
# (plain kernel versions), float32 with TF32 off, 8 clients x 8 images:
# the loss to 1e-4 relative, the update on the support both pick to 1e-3
# of its L2 norm, at most 50 of the k = 50,000 coordinates swapped (0.1%:
# the gradients differ in float32 order, and estimates tie near the k-th)
ROBUST_LOSS_RTOL = 1e-4
ROBUST_UPDATE_RTOL = 1e-3
ROBUST_SWAPS = 50
ROBUST_DEFENSE_RTOL = 1e-3
ASYNC_TICKS = 12
# the straggler fraction 0.25: at the default 0.1 the fates of seed 21's
# 12 ticks draw no straggler (cohort 1 is dropped); at 0.25 cohorts 2 and
# 10 take 10 ticks, so the pool fills and staleness shows
ASYNC_STRAGGLERS = ["--async_agg", "--max_inflight", "4", "--buffer_goal",
                    "2", "--staleness_discount", "poly", "--scenario",
                    "stragglers", "--scenario_dropout", "0.1",
                    "--scenario_straggler_frac", "0.25"]
PREEMPT_TIMEOUT_S = 300


def run_cv(argv, tag: str):
    """``cv_train.main(argv)`` (through ``entry_main``) on the card with
    every launch count set to 0 just before and read just after; returns
    (result, launches, peak memory)."""
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.ops import circulant_kernels as K

    print(f"[{tag}] python -m commefficient_torch.cv_train "
          + " ".join(argv), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    out = entry_main(cv_train, argv)
    launches = dict(K.launches)
    torch.cuda.synchronize()
    return out, launches, torch.cuda.max_memory_allocated()


def _rounds_ok(tag, out, launches, want, rounds=SERVICE_ROUNDS):
    import numpy as np
    if out["rounds"] != rounds or out["summary"] is None \
            or not np.isfinite(out["losses"]).all():
        fail(f"{tag}: {out['rounds']} rounds, losses {out['losses']}, "
             f"summary {out['summary']}")
    if launches != want:
        fail(f"{tag}: launches {launches}, want {want}")


def robust_reference_round(flags_kw: dict):
    """The first round of a robust arm on the card and on the CPU (plain
    versions) at ResNet-9's full width, float32, TF32 off, 8 clients x 8
    seeded images; returns (rel dloss, rel dupdate, swaps, defense
    scalars of both)."""
    import numpy as np
    import torch
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.data.scenarios import make_adversary
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.resnet9 import ResNet9

    cfg = FedConfig(mode="sketch", error_type="virtual", local_momentum=0.0,
                    virtual_momentum=0.9, weight_decay=5e-4, k=50_000,
                    num_rows=5, num_cols=500_000, num_workers=8,
                    local_batch_size=8, compute_dtype="float32",
                    num_clients=100, **flags_kw)
    plan = make_adversary(cfg)
    ids = np.arange(8)
    if plan is not None:
        hostile = plan.universe_mask(100)
        ids = np.concatenate([np.flatnonzero(hostile)[:2],
                              np.flatnonzero(~hostile)[:6]])
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(8, 8, 32, 32, 3).astype(np.float32),
             "target": rng.randint(0, 10, (8, 8))}
    mask = np.ones((8, 8), bool)
    mask[1, 5:] = False
    runs = {}
    with no_tf32():
        for device in ("cpu", "cuda"):
            model = ResNet9(num_classes=10,
                            generator=torch.Generator().manual_seed(0))
            rt = FedRuntime(cfg, model, make_cv_loss(model, "float32"),
                            device=device)
            st, met = rt.round(rt.init_state(), ids, batch, mask, 0.1)
            runs[device] = (met["results"][0].cpu().numpy(),
                            (st.ps_weights - rt.initial_weights)
                            .cpu().numpy(),
                            {k: float(v) for k, v in met["defense"].items()},
                            None if met["client_finite"] is None
                            else met["client_finite"].cpu().numpy())
            del rt, st, met
    (l_cpu, u_cpu, d_cpu, f_cpu), (l_gpu, u_gpu, d_gpu, f_gpu) = \
        runs["cpu"], runs["cuda"]
    fin = np.isfinite(l_cpu)
    if not np.array_equal(fin, np.isfinite(l_gpu)):
        fail(f"robust reference {flags_kw}: finite losses differ")
    dl = float(np.abs(l_gpu - l_cpu)[fin].max() / np.abs(l_cpu[fin]).max())
    s_cpu, s_gpu = u_cpu != 0, u_gpu != 0
    swaps = int(max((s_cpu & ~s_gpu).sum(), (s_gpu & ~s_cpu).sum()))
    same = s_cpu == s_gpu
    du = float(np.linalg.norm((u_gpu - u_cpu)[same])
               / np.linalg.norm(u_cpu))
    for key, v in d_cpu.items():
        w = d_gpu[key]
        if not (math.isnan(v) and math.isnan(w)
                or abs(w - v) <= ROBUST_DEFENSE_RTOL * max(abs(v), 1e-12)):
            fail(f"robust reference {flags_kw}: defense {key} {w} on the "
                 f"card, {v} on the CPU")
    if (f_cpu is None) != (f_gpu is None) or (
            f_cpu is not None and not np.array_equal(f_cpu, f_gpu)):
        fail(f"robust reference {flags_kw}: finite flags {f_gpu} / {f_cpu}")
    if not (dl <= ROBUST_LOSS_RTOL and du <= ROBUST_UPDATE_RTOL
            and swaps <= ROBUST_SWAPS and s_cpu.sum() > 0
            and np.isfinite(u_gpu).all()):
        fail(f"robust reference {flags_kw}: the card's round disagrees "
             f"with the CPU's (dloss {dl}, dupdate {du}, swaps {swaps})")
    return dl, du, swaps, d_gpu


def phase_robust():
    """The plain sketch round and the four robust arms (ROBUST_ARMS)
    through ``cv_train`` at full width, SERVICE_ROUNDS rounds each, in
    one call: 9 K1 + 1 K2 + 1 cell sum a round plain, exactly 1 K1 + 1 K2
    + 1 cell sum a robust round, finite losses, the defense scalars of every round printed,
    each arm's median round and peak memory beside the plain round's;
    the quarantine arm's ledger (strikes, benches, ejections) equal to
    the CPU run's of the same seeds (``--test`` size: the ledger depends
    on the sampler and the adversary plan alone); each arm's first round
    card-vs-CPU (``robust_reference_round``). Returns (plain, {arm:
    (launches, median ms, peak bytes)})."""
    import numpy as np
    from commefficient_torch import cv_train

    R = SERVICE_ROUNDS
    argv = SERVICE_ARGV + dataset_flags("synthetic640")
    out, launches, peak = run_cv(argv, "robust")
    _rounds_ok("plain sketch", out, launches, sketch_launches(R))
    plain_ms = statistics.median(out["round_s"][1:]) * 1e3
    plain = {"launches": launches, "ms": plain_ms, "peak": peak,
             "weights": out["state"].ps_weights.cpu(),
             "losses": list(out["losses"])}
    print(f"[robust] plain sketch: median of rounds 2-{R} {plain_ms:.3f} "
          f"ms, peak {peak / 2**30:.3f} GiB, launches {launches}",
          flush=True)
    del out
    arms = {}
    for arm, flags in ROBUST_ARMS.items():
        out, launches, peak = run_cv(argv + flags, "robust")
        _rounds_ok(arm, out, launches, sketch_launches(R, 1))
        ms = statistics.median(out["round_s"][1:]) * 1e3
        scalars = out["defense"]
        if len(scalars) != R:
            fail(f"{arm}: {len(scalars)} rounds of defense scalars")
        # the defense event of every round (A10's telemetry), its device
        # scalars the console row's
        events = read_stream(out["logdir"], arm)
        defense = [e for e in events if e["event"] == "defense"]
        if [e["round"] for e in defense] != list(range(1, R + 1)) or any(
                e["defense"] != (flags[flags.index("--defense") + 1]
                                 if "--defense" in flags else "none")
                for e in defense):
            fail(f"{arm}: defense events {[e['round'] for e in defense]}")
        print(f"[robust] {arm}: {len(defense)} defense events, e.g. "
              + json.dumps({k: defense[-1][k] for k in (
                  "clip_frac", "trim_frac", "nonfinite_clients",
                  "quarantined", "injected")}), flush=True)
        print(f"[robust] {arm}: median of rounds 2-{R} {ms:.3f} ms "
              f"(plain {plain_ms:.3f}), peak {peak / 2**30:.3f} GiB (plain "
              f"{plain['peak'] / 2**30:.3f}), launches {launches}, losses "
              f"{[round(float(x), 5) for x in out['losses']]}, defense "
              + "; ".join(", ".join(f"{k} {v:.5g}" for k, v in s.items())
                          for s in scalars), flush=True)
        if "quarantine" in arm:
            ledger = out["services"].qledger
            cpu = entry_main(cv_train, ["--device", "cpu", "--test"]
                             + argv[:-2] + dataset_flags("synthetic640_cpu")
                             + flags)
            want = cpu["services"].qledger
            if ledger.state_dict() != want.state_dict() \
                    or not ledger.total_strikes:
                fail(f"{arm}: the card's quarantine ledger "
                     f"{ledger.state_dict()} is not the CPU run's "
                     f"{want.state_dict()}")
            print(f"[robust] {arm}: {ledger.total_strikes} strikes, "
                  f"{ledger.quarantined(R)} benched and "
                  f"{len(ledger.ejected)} ejected after round {R}, equal "
                  "to the CPU run of the same seeds", flush=True)
            del cpu
        arms[arm] = (launches, ms, peak)
        del out
    for arm, flags in ROBUST_ARMS.items():
        kw = {f[2:]: (float(v) if f in ("--adversary_frac",) else v)
              for f, v in zip(flags[::2], flags[1::2])}
        dl, du, swaps, d = robust_reference_round(kw)
        print(f"[robust] {arm}: first round card vs CPU (float32, TF32 "
              f"off, 8 x 8): rel dloss {dl:.3e}, update L2 difference "
              f"{du:.3e} of its norm, {swaps} of 50,000 swapped; defense "
              + ", ".join(f"{k} {v:.5g}" for k, v in d.items()), flush=True)
    return plain, arms


def phase_async(plain):
    """``--async_agg --max_inflight 1 --buffer_goal 1`` over the plain
    arm's rounds: weights, losses and launches bitwise the synchronous
    run's; then ASYNC_STRAGGLERS for ASYNC_TICKS ticks (one epoch of the
    100-client universe) and its flush: commits, staleness, K1 = 9 a
    computed cohort (a dropped cohort computes nothing, as in the JAX
    package), K2 = 1 a commit, tick and commit medians. Returns
    {part: launches} and the printed numbers."""
    import numpy as np
    import torch
    from commefficient_torch.core.runtime import FedRuntime

    argv = SERVICE_ARGV + dataset_flags("synthetic640")
    out, launches, peak = run_cv(argv + ["--async_agg", "--max_inflight",
                                         "1", "--buffer_goal", "1"],
                                 "async")
    agg = out["services"].async_agg
    if not (same_bits(out["state"].ps_weights.cpu(), plain["weights"])
            and list(out["losses"]) == plain["losses"]
            and launches == plain["launches"]
            and agg.commits == SERVICE_ROUNDS):
        fail(f"async K=1/M=1: not bitwise the synchronous rounds (launches "
             f"{launches} vs {plain['launches']}, commits {agg.commits})")
    k1m1_ms = statistics.median(out["round_s"][1:]) * 1e3
    print(f"[async] K=1 M=1: {SERVICE_ROUNDS} ticks bitwise the synchronous"
          f" rounds (weights, losses, launches {launches}); median tick "
          f"{k1m1_ms:.3f} ms against the round's {plain['ms']:.3f}, peak "
          f"{peak / 2**30:.3f} GiB", flush=True)
    del out
    commit_s, orig = [], FedRuntime.commit

    def timed_commit(rt, state, lr):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = orig(rt, state, lr)
        torch.cuda.synchronize()
        commit_s.append(time.perf_counter() - t)
        return res

    FedRuntime.commit = timed_commit
    try:
        argv = MODE_COMMON + ["--mode", "sketch", "--virtual_momentum",
                              "0.9", "--num_rounds", str(ASYNC_TICKS),
                              "--telemetry_every", "1"]
        out, launches, peak = run_cv(argv + dataset_flags("synthetic640")
                                     + ASYNC_STRAGGLERS, "async")
    finally:
        FedRuntime.commit = orig
    agg = out["services"].async_agg
    want = {"circ_encode": 9 * agg.dispatched, "circ_decode": agg.commits,
            "cell_sum": agg.commits}
    if launches != want or agg.dispatched + agg.dropped != ASYNC_TICKS \
            or agg.inflight or agg.pending or not agg.commits \
            or out["state"].step != agg.commits \
            or not np.isfinite(out["losses"]).all() \
            or len(commit_s) != agg.commits:
        fail(f"async stragglers: launches {launches} (want {want}), "
             f"dispatched {agg.dispatched}, dropped {agg.dropped}, commits "
             f"{agg.commits}, in flight {agg.inflight}, pending "
             f"{agg.pending}")
    tick_ms = statistics.median(out["round_s"][1:]) * 1e3
    commit_ms = statistics.median(commit_s) * 1e3
    # one async_round event a commit (A10's telemetry), the device fields
    # on record ticks and the flush's
    events = read_stream(out["logdir"], "async stragglers")
    commits_ev = [e for e in events if e["event"] == "async_round"]
    if len(commits_ev) != agg.commits or [e["round"] for e in commits_ev] \
            != list(range(1, agg.commits + 1)) or \
            commits_ev[-1]["update_norm"] is None:
        fail(f"async stragglers: {len(commits_ev)} async_round events for "
             f"{agg.commits} commits")
    print(f"[async] {len(commits_ev)} async_round events, staleness max "
          f"{max(e['staleness_max'] for e in commits_ev)}, last update "
          f"norm {commits_ev[-1]['update_norm']:.6g}", flush=True)
    print(f"[async] stragglers K=4 M=2 poly, dropout 0.1, straggler "
          f"share 0.25: {ASYNC_TICKS} "
          f"ticks, {agg.dispatched} cohorts computed, {agg.dropped} dropped,"
          f" {agg.merged} merged, {agg.commits} commits, staleness mean "
          f"{agg.staleness_mean_seen:.3f} max {agg.staleness_max_seen}; "
          f"K1 {launches['circ_encode']} (9 a computed cohort), K2 "
          f"{launches['circ_decode']} (1 a commit); median tick "
          f"{tick_ms:.3f} ms (a tick's dispatch, landings and commits), "
          f"median commit {commit_ms:.3f} ms, peak {peak / 2**30:.3f} GiB",
          flush=True)
    return {"k1m1": dict(plain["launches"]), "stragglers": launches}, \
        {"k1m1_ms": k1m1_ms, "tick_ms": tick_ms, "commit_ms": commit_ms}


def phase_preempt(plain):
    """``--watchdog`` on the plain arm's rounds: bitwise its weights. Then
    one epoch (12 rounds) with ``--checkpoint_every 1 --checkpoint``
    uninterrupted in this process, and in child processes on the card:
    ``COMMEFFICIENT_FAULT=sigterm:pre_round:3`` drains to
    ``ckpt_000000_r000003_preempt`` and exits 0; ``--resume`` under
    ``kill:mid_checkpoint_write`` is killed (137) writing the epoch's
    generation, which leaves the preempt generation and .tmp litter; a
    last ``--resume`` falls back to the preempt generation, removes the
    litter and ends at the uninterrupted run's weights bit for bit.
    Returns the watchdog run's launches and the children's seconds."""
    import numpy as np

    argv = SERVICE_ARGV + dataset_flags("synthetic640")
    out, launches, _ = run_cv(argv + ["--watchdog"], "preempt")
    if not (same_bits(out["state"].ps_weights.cpu(), plain["weights"])
            and launches == plain["launches"]):
        fail("--watchdog changed the rounds")
    print(f"[preempt] --watchdog: {SERVICE_ROUNDS} rounds bitwise the plain "
          f"arm's, deadline history {len(out['services'].watchdog.history)}"
          f" rounds, {out['services'].watchdog.stalls} stalls", flush=True)
    wd_launches = launches
    del out
    root = os.path.dirname(os.path.abspath(__file__))

    def epoch_argv(ck):
        # one stream for the run and its resumes: the lineage
        return (MODE_COMMON + ["--mode", "sketch", "--virtual_momentum",
                               "0.9", "--num_rounds", "0", "--num_epochs",
                               "1", "--checkpoint_every", "1",
                               "--checkpoint", "--checkpoint_path", ck,
                               "--logdir", os.path.join(ck, "logs")]
                + dataset_flags("synthetic640"))

    ck_a = os.path.join(DATA_ROOT["path"], "preempt_straight")
    ck_b = os.path.join(DATA_ROOT["path"], "preempt_chain")
    out, _, _ = run_cv(epoch_argv(ck_a), "preempt")
    straight = np.load(os.path.join(ck_a, "ResNet9.npz"))["ps_weights"]
    if out["rounds"] != 12:
        fail(f"preempt: the straight epoch ran {out['rounds']} rounds")
    del out
    times = {}

    def child(tag, extra, fault):
        env = dict(os.environ)
        env.pop("COMMEFFICIENT_FAULT", None)
        if fault:
            env["COMMEFFICIENT_FAULT"] = fault
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "commefficient_torch.cv_train"]
            + epoch_argv(ck_b) + extra, cwd=root, env=env,
            capture_output=True, text=True, timeout=PREEMPT_TIMEOUT_S)
        times[tag] = time.perf_counter() - t
        return res

    gens = lambda: sorted(f for f in os.listdir(  # noqa: E731
        os.path.join(ck_b, "ResNet9")) if f.endswith(".npz"))
    a = child("sigterm", [], "sigterm:pre_round:3")
    if a.returncode != 0 or "PREEMPT: drained at epoch 0 + 3" not in \
            a.stdout or gens() != ["ckpt_000000_r000003_preempt.npz"]:
        fail(f"preempt: the SIGTERM drain (rc {a.returncode}): "
             f"{a.stdout[-1500:]} {a.stderr[-1500:]}")
    b = child("kill", ["--resume"], "kill:mid_checkpoint_write")
    litter = [f for f in os.listdir(os.path.join(ck_b, "ResNet9"))
              if f.endswith(".tmp")]
    if b.returncode != 137 or gens() != \
            ["ckpt_000000_r000003_preempt.npz"] or not litter:
        fail(f"preempt: the kill inside the checkpoint write (rc "
             f"{b.returncode}, generations {gens()}, litter {litter}): "
             f"{b.stderr[-1500:]}")
    c = child("resume", ["--resume"], None)
    got = np.load(os.path.join(ck_b, "ResNet9.npz"))["ps_weights"]
    if c.returncode != 0 or "epoch 0 + 3 rounds (preempt checkpoint)" \
            not in c.stdout or "stale .tmp" not in c.stderr \
            or got.tobytes() != straight.tobytes():
        fail(f"preempt: the resume (rc {c.returncode}) did not end at the "
             f"uninterrupted weights: {c.stdout[-1500:]} "
             f"{c.stderr[-1500:]}")
    # the stream the three children shared: one segment each, every
    # resume naming the segment before it, the drain's fault event
    events = read_stream(os.path.join(ck_b, "logs"), "preempt children")
    manifests = [e for e in events if e["event"] == "manifest"]
    resumes = [e for e in events if e["event"] == "resume"]
    faults = [e for e in events if e["event"] == "fault"]
    if len(manifests) != 3 or [r["prior_stream"] for r in resumes] != \
            [m["stream_id"] for m in manifests[:2]] or not any(
                f["kind"] == "preempt" and f["round"] == 3 for f in faults):
        fail(f"preempt: the stream's lineage: {len(manifests)} manifests, "
             f"resumes {[r['prior_stream'] for r in resumes]}, faults "
             f"{[(f['kind'], f['round']) for f in faults]}")
    print(f"[preempt] the children's stream: {len(manifests)} segments, "
          f"each resume names its predecessor "
          f"({[r['prior_events'] for r in resumes]} events before it), "
          f"faults {[(f['kind'], f['round']) for f in faults]}",
          flush=True)
    rows = [ln for ln in c.stdout.splitlines() if "train_time" in ln]
    epoch_row = c.stdout.splitlines()
    epoch_row = epoch_row[epoch_row.index(rows[0]) + 1] if rows else ""
    print(f"[preempt] the last resume's epoch row: {epoch_row.strip()}",
          flush=True)
    print(f"[preempt] sigterm:pre_round:3 drained to the preempt "
          f"generation and exited 0 ({times['sigterm']:.1f} s); the resume "
          f"under kill:mid_checkpoint_write exited 137 leaving it and "
          f"{len(litter)} .tmp file(s) ({times['kill']:.1f} s); the last "
          f"resume fell back to it, removed the litter and ended bitwise "
          f"at the uninterrupted epoch's weights ({times['resume']:.1f} s)",
          flush=True)
    return wd_launches, times


# the telemetry phase (phase_telemetry): the main path's A/B, then the
# card's round-1 signals against the CPU's at phase_small_reference's
# narrow width, float32, TF32 off: every norm, mass and quantile within
# TEL_SIGNAL_RTOL of the CPU's, the support counts within TEL_SWAPS of k
TEL_SIGNAL_RTOL = 1e-4
TEL_SWAPS = 2
TEL_GPT2_ROUNDS = 2
H100_NAME = "NVIDIA H100 80GB HBM3"


class FirstRound:
    """While installed, keeps the weights after the first
    ``FedRuntime.round`` call (on the host)."""

    def __enter__(self):
        from commefficient_torch.core.runtime import FedRuntime
        self.cls, self.orig, self.weights = FedRuntime, FedRuntime.round, None
        orig, box = self.orig, self

        def round(rt, state, *args, **kw):
            new, metrics = orig(rt, state, *args, **kw)
            if box.weights is None:
                box.weights = new.ps_weights.detach().cpu().clone()
            return new, metrics

        self.cls.round = round
        return self

    def __exit__(self, *exc):
        self.cls.round = self.orig


def smi_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return (smi.stdout.strip().splitlines() or ["(nvidia-smi: none)"])[0]


def check_main_stream(events, rounds: int, d: int) -> dict:
    """The default arm's stream: manifest first (the card, cuda), summary
    last, one round/signals/layer_signals/client_stats event a round,
    device_wait spans, a utilization event, memory events with live,
    peak and limit bytes, the fused route's null grad_true_norm and
    grad_mass, the measured round_step ledger. Returns its counts."""
    import torch
    counts = kinds_of(events)
    man = events[0]
    if man["event"] != "manifest" or man["backend"] != "cuda" or \
            man["device_kind"] != torch.cuda.get_device_name(0):
        fail(f"telemetry: manifest {man.get('backend')} "
             f"{man.get('device_kind')}")
    if events[-1]["event"] != "summary" or events[-1]["aborted"]:
        fail(f"telemetry: the stream ends with {events[-1]['event']}")
    for kind in ("round", "signals", "layer_signals", "client_stats"):
        got = [e["round"] for e in events if e["event"] == kind]
        if got != list(range(1, rounds + 1)):
            fail(f"telemetry: {kind} events for rounds {got}")
    spans = {s["name"] for e in events if e["event"] == "span"
             for s in e["spans"]}
    if "device_wait" not in spans or not counts.get("utilization"):
        fail(f"telemetry: spans {sorted(spans)}, utilization "
             f"{counts.get('utilization')}")
    for e in events:
        if e["event"] == "memory" and None in (
                e["live_bytes"], e["peak_bytes"], e["limit_bytes"]):
            fail(f"telemetry: memory event {e['phase']} has null bytes")
    sig = [e for e in events if e["event"] == "signals"]
    lay = [e for e in events if e["event"] == "layer_signals"]
    if any(e["grad_true_norm"] is not None for e in sig) or any(
            e["grad_mass"] is not None for e in lay):
        fail("telemetry: the fused route reported a dense gradient")
    if any(abs(sum(e["topk_count"]) - s["support_density"] * d) > 0.5
           for e, s in zip(lay, sig)):
        fail("telemetry: the layer counts do not sum to the support")
    return counts


def phase_telemetry():
    """The run telemetry on the card (the stream, the in-round signals,
    memory, the profiler window):

    - the ResNet-9 main path through ``cv_train``, ROUNDS rounds, four
      runs interleaved: default (``--telemetry_every 1``),
      ``--no_telemetry``, default, ``--no_telemetry``, then one at the
      default cadence (no record in ROUNDS rounds). Every run launches
      exactly 9 K1 + 1 K2 a round, the weights after round 1 are bit for
      bit equal in every arm (telemetry only observes), the medians are
      printed side by side with the card's name and power limit;
    - the default arm's stream (``check_main_stream``) and its measured
      round_step ledger against d x 4 bytes (printed);
    - round 1's signals, layer signals and client quantiles of a narrow
      ResNet-9 on the card against the CPU's (TEL_SIGNAL_RTOL,
      TEL_SWAPS);
    - ``--signals_exact``: the unfused route (1 K1 + 1 K2 a round), a
      grad_true_norm, topk_overlap in [0, 1] every round;
    - ``--profile_dir``: a chrome trace of rounds 2:4 with its kernels;
    - GPT-2 at full width, TEL_GPT2_ROUNDS rounds, with the default
      groups and with ``--signal_groups off``: layer signals over GPT-2's
      coarse groups, the MFU against the card's 989 TFLOP/s entry, and
      the two peaks side by side (the per-range reductions add no
      d-sized map: the difference stays under d x 4 bytes).
    Returns the medians (ms) of both arms and the GPT-2 peaks."""
    import numpy as np
    import torch
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.resnet9 import ResNet9
    from commefficient_torch.telemetry import (check_dense_grad_floor,
                                               tree_to_host)

    base = MAIN_ARGV + dataset_flags("synthetic64") + [
        "--num_rounds", str(ROUNDS)]
    # the A/B at one record a round, then one run at the default cadence
    # (a record every 64 rounds: none in these rounds), the telemetry's
    # cost between records
    arms = (("telemetry", ["--telemetry_every", "1"]),
            ("no_telemetry", ["--no_telemetry"])) * 2 + (
                ("default_cadence", []),)
    medians, firsts, streams = {}, {}, []
    d = None
    for arm, flags in arms:
        with FirstRound() as first:
            out, launches, peak = run_cv(base + flags, f"telemetry {arm}")
        if launches != sketch_launches(ROUNDS) \
                or out["rounds"] != ROUNDS or out["summary"] is None:
            fail(f"telemetry {arm}: launches {launches}, {out['rounds']} "
                 "rounds: want 9 K1 + 1 K2 + 1 cell sum a round")
        d = out["runtime"].cfg.grad_size
        medians.setdefault(arm, []).append(
            statistics.median(out["round_s"][1:]) * 1e3)
        firsts.setdefault(arm, []).append(first.weights)
        if arm == "telemetry":
            streams.append(out["logdir"])
        elif arm == "no_telemetry" and os.path.exists(
                os.path.join(list(LOGDIRS)[-1], "telemetry.jsonl")):
            fail("--no_telemetry wrote a stream")
        del out
    for a, b in zip(firsts["telemetry"] + firsts["default_cadence"],
                    firsts["no_telemetry"] * 2):
        if not same_bits(a, b):
            fail("telemetry changed the round-1 weights")
    smi = smi_line()
    print(f"[telemetry] main path A/B on {smi}: median of rounds 2-{ROUNDS}"
          f" (ms), interleaved: telemetry "
          f"{[round(x, 3) for x in medians['telemetry']]}, --no_telemetry "
          f"{[round(x, 3) for x in medians['no_telemetry']]}, then the "
          "default cadence "
          f"{[round(x, 3) for x in medians['default_cadence']]}; 9 K1 + 1 "
          "K2 a round in every run, round-1 weights bitwise equal",
          flush=True)
    events = read_stream(streams[0], "telemetry main path")
    counts = check_main_stream(events, ROUNDS, d)
    ledger = [e for e in events if e["event"] == "memory_ledger"][0]
    over = check_dense_grad_floor(ledger, d)
    rnd = [e for e in events if e["event"] == "round"]
    print(f"[telemetry] stream: {len(events)} events {counts}; round "
          f"split (host/dispatch/device ms, median): "
          + "/".join(f"{statistics.median(e[k] for e in rnd) * 1e3:.3f}"
                     for k in ("host_s", "dispatch_s", "device_s"))
          + f"; measured round_step temp {ledger['temp_bytes']} B against "
          f"d x 4 = {4 * d} B ({'above' if over else 'below'}: the "
          "autograd route forms each microbatch's (d,) gradient)",
          flush=True)
    util = [e for e in events if e["event"] == "utilization"]
    print(f"[telemetry] utilization: device_wait_frac "
          f"{util[-1]['device_wait_frac']}, dispatch_frac "
          f"{util[-1]['dispatch_frac']}, input_wait_frac "
          f"{util[-1]['input_wait_frac']}, mfu {util[-1]['mfu']} (no "
          "analytic FLOP count for the CV models)", flush=True)
    phase_readers(streams[0])
    time_done("the stream's readers (check_telemetry_schema, teleview)")

    # round 1's signals, card against CPU
    ch = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32}
    cfg = FedConfig(mode="sketch", error_type="virtual", local_momentum=0.0,
                    virtual_momentum=0.9, weight_decay=5e-4, k=200,
                    num_rows=5, num_cols=4096, num_workers=2,
                    local_batch_size=8, compute_dtype="float32")
    got = {}
    with no_tf32():
        for device in ("cpu", "cuda"):
            model = ResNet9(channels=ch,
                            generator=torch.Generator().manual_seed(0))
            rt = FedRuntime(cfg, model, make_cv_loss(model, "float32"),
                            device=device)
            rng = np.random.RandomState(0)
            batch = {"image": rng.randn(2, 8, 32, 32, 3).astype(np.float32),
                     "target": rng.randint(0, 10, (2, 8))}
            mask = np.ones((2, 8), bool)
            mask[1, 5:] = False
            _, met = rt.round(rt.init_state(), np.arange(2), batch, mask,
                              0.1)
            got[device] = tree_to_host({k: met[k] for k in (
                "signals", "layer_signals", "client_stats")})
    worst = 0.0

    def near(a, b, what):
        nonlocal worst
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        both = np.isnan(a) & np.isnan(b)
        err = np.abs(a - b)[~both] / np.maximum(np.abs(b)[~both], 1e-30)
        worst = max(worst, float(err.max(initial=0.0)))
        if not np.array_equal(np.isnan(a), np.isnan(b)) or \
                (err > TEL_SIGNAL_RTOL).any():
            fail(f"telemetry: round-1 {what} on the card {a} against the "
                 f"CPU's {b}")

    gpu, cpu = got["cuda"], got["cpu"]
    for key, v in cpu["signals"].items():
        if key == "support_density":
            if abs(float(gpu["signals"][key]) - float(v)) * d > 2 * TEL_SWAPS:
                fail(f"telemetry: support on the card {gpu['signals'][key]}"
                     f" against {v}")
        else:
            near(gpu["signals"][key], v, f"signals.{key}")
    for key, v in cpu["layer_signals"].items():
        if v is None:
            if gpu["layer_signals"][key] is not None:
                fail(f"telemetry: layer {key} on the card only")
        elif key == "topk_count":
            if np.abs(gpu["layer_signals"][key] - v).sum() > 2 * TEL_SWAPS:
                fail(f"telemetry: layer counts {gpu['layer_signals'][key]}"
                     f" against {v}")
        else:
            near(gpu["layer_signals"][key], v, f"layer_signals.{key}")
    for key, s in cpu["client_stats"].items():
        for field in ("q", "max", "mean"):
            near(gpu["client_stats"][key][field], s[field],
                 f"client_stats.{key}.{field}")
    print(f"[telemetry] round-1 signals, layer signals and client "
          f"quantiles, card vs CPU (narrow ResNet-9, float32, TF32 off): "
          f"largest relative difference {worst:.3e}", flush=True)

    # --signals_exact: the unfused route, an overlap every round
    out, launches, _ = run_cv(base[:-1] + ["3", "--signals_exact",
                                           "--telemetry_every", "1"],
                              "telemetry --signals_exact")
    if launches != sketch_launches(3, 1):
        fail(f"--signals_exact: launches {launches}, want 1 K1 + 1 K2 + 1 "
             "cell sum a round (the unfused route)")
    sig = [e for e in read_stream(out["logdir"], "signals_exact")
           if e["event"] == "signals"]
    if len(sig) != 3 or any(
            e["topk_overlap"] is None or not 0 <= e["topk_overlap"] <= 1
            or e["grad_true_norm"] is None for e in sig):
        fail(f"--signals_exact: signals {sig}")
    print("[telemetry] --signals_exact: 1 K1 + 1 K2 a round, topk_overlap "
          f"{[round(e['topk_overlap'], 5) for e in sig]}, grad_true_norm "
          f"{[round(e['grad_true_norm'], 5) for e in sig]}", flush=True)
    del out

    # --profile_dir: the trace of rounds 2:4
    prof_dir = os.path.join(DATA_ROOT["path"], "profile")
    out, _, _ = run_cv(base[:-1] + ["4", "--profile_dir", prof_dir],
                       "telemetry --profile_dir")
    trace = os.path.join(prof_dir, "trace_rounds_2-4.json")
    if not os.path.exists(trace):
        fail(f"--profile_dir: no {trace}")
    with open(trace) as f:
        tev = json.load(f).get("traceEvents", [])
    n_kernels = sum(1 for e in tev if e.get("cat") == "kernel")
    print(f"[telemetry] --profile_dir: {os.path.basename(trace)}, "
          f"{os.path.getsize(trace)} bytes, {len(tev)} events, "
          f"{n_kernels} device kernels", flush=True)
    del out

    # GPT-2 with the default groups and without them
    peaks = {}
    for arm, flags in (("coarse", []), ("off", ["--signal_groups", "off"])):
        logdir = logdir_flags(f"gpt2 telemetry {arm}")
        _, _, ms, info = phase_gpt2_main(
            flags + logdir + ["--telemetry_every", "1"], TEL_GPT2_ROUNDS)
        peaks[arm] = (info["peak"], ms)
        events = read_stream(logdir[1], f"gpt2 {arm}")
        lay = [e for e in events if e["event"] == "layer_signals"]
        util = [e for e in events if e["event"] == "utilization"]
        if arm == "coarse":
            groups = set(lay[0]["groups"]) if lay else set()
            want = {"embed", "head"} | {f"h{b}/{s}" for b in range(12)
                                        for s in ("attn", "mlp",
                                                  "norm-bias")}
            if len(lay) != TEL_GPT2_ROUNDS or not want <= groups:
                fail(f"gpt2 telemetry: layer_signals {len(lay)}, groups "
                     f"{sorted(groups)}")
            if not util or util[0]["mfu"] is None or \
                    util[0]["peak_flops"] != 989e12:
                fail(f"gpt2 telemetry: utilization {util[:1]}")
            print(f"[telemetry] gpt2: layer_signals over "
                  f"{len(lay[0]['groups'])} groups, mfu "
                  f"{[e['mfu'] for e in util]} against "
                  f"{util[0]['peak_flops']:.3g} FLOP/s "
                  f"({util[0]['device_kind']})", flush=True)
        elif lay:
            fail("gpt2 --signal_groups off wrote layer_signals")
    d_gpt2 = GPT2_SKETCH["d"]
    extra = peaks["coarse"][0] - peaks["off"][0]
    if extra >= 4 * d_gpt2:
        fail(f"gpt2: the layer signals add {extra} bytes of peak (d x 4 = "
             f"{4 * d_gpt2})")
    print(f"[telemetry] gpt2 on {smi}: median round / peak, coarse groups "
          f"{peaks['coarse'][1]:.3f} ms / {peaks['coarse'][0] / 2**30:.3f} "
          f"GiB, --signal_groups off {peaks['off'][1]:.3f} ms / "
          f"{peaks['off'][0] / 2**30:.3f} GiB", flush=True)
    return medians, peaks


# the benchmark entry points (commefficient_torch/bench/): phase_bench
GPT2_BENCH_SKETCH = dict(d=124_444_416, c=524_288, r=5)
# the keys of bench.py's line (bench.py:120-176 and 225-293) and of its
# nested GPT-2 stage (bench_gpt2.py:269-298), key for key
BENCH_CIFAR_KEYS = {"metric", "value", "unit", "vs_baseline", "mfu",
                    "timed_rounds", "wire_dtype", "wire_bytes_per_round",
                    "warmup_s", "phase_split", "input_wait_frac",
                    "roofline"}
BENCH_KEYS = {"headline": BENCH_CIFAR_KEYS | {"cifar_saturated", "gpt2"},
              "cifar_saturated": BENCH_CIFAR_KEYS | {"round_images"},
              "gpt2": {"metric", "value", "unit", "vs_baseline", "mfu",
                       "tokens_per_round", "timed_rounds", "wire_dtype",
                       "wire_bytes_per_round", "warmup_s", "phase_split",
                       "input_wait_frac", "roofline", "memory_ledger",
                       "memory_ledger_decode", "dryrun", "config"}}
# each stage's upload a round on the float32 wire, W x 4 r c (the CIFAR
# table sized 500,000 -> 500,736), and the headline's on the int8 wire
# (a byte a cell and a float32 scale every 256 columns of a row)
BENCH_WIRE_BYTES = {"headline": 8 * 4 * 5 * 500_736,
                    "cifar_saturated": 32 * 4 * 5 * 500_736,
                    "gpt2": 8 * 4 * 5 * 524_288}
BENCH_INT8_BYTES = 8 * (5 * 500_736 + 4 * 5 * 1956)
BENCH_TIMEOUT_S = 600
# timed rounds of each in-process bench run (the launch counts), chained
# steps of the bare-model and long-context arms
BENCH_ROUNDS = 2
BENCH_STEPS = 2
# the GPT-2 bench's K1 a round: 8 clients x their microbatches (weight
# decay 0: no decay encode, core/client.py make_fused_grad); unfused: the
# clients' dense sum encoded once
SWEEP_ARMS = ("base", "unfused_encode", "mb4", "chunk256", "overlap")
SWEEP_K1 = {"base": 8, "unfused_encode": 1, "mb4": 16, "chunk256": 8,
            "overlap": 8}
# the bench paths that launch K3, flash against dense attention from the
# same weights and tokens (the bare model step: one client's microbatch,
# (16, 256); the long-context step at S = 1024, 2048, 4096): the relative
# difference of the first-step loss, and the largest relative L2 error
# of a layer's q, k or v block of the c_attn gradient. The two round the
# probabilities to bf16 in different places. Read on an H100 (NVIDIA
# H100 80GB HBM3, 700 W): the loss 1.4e-6 to 8.2e-6 (the bare-model
# bench's mean over 8 clients 1.6e-5), the gradient 2.8e-2 to 4.4e-2; with
# a planted fault in a K3 kernel the gradient 0.13 (dk/dv at S = 4096)
# to 3.7. A planted forward fault moves the loss 3.5e-3 at S = 256 but
# only 1.4e-5 to 2.6e-5 at S >= 1024, inside the loss limit, and a
# backward fault not at all: there the gradient rejects it
BENCH_ATTN_LIMITS = {"loss": 1e-4, "grad": 0.08}
K3_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


class SyncedRounds:
    """While installed, every ``FedRuntime.round`` and ``.cohort`` call
    runs between two ``torch.cuda.synchronize()`` calls; ``calls`` keeps
    each call's kind, kernel launches (the counts read before and after
    it) and seconds."""

    def __init__(self, counts):
        from commefficient_torch.core.runtime import FedRuntime
        self.cls, self.counts = FedRuntime, counts
        self.orig = {"round": FedRuntime.round, "cohort": FedRuntime.cohort}
        self.calls = []

    def __enter__(self):
        import torch

        def wrap(kind, orig):
            def wrapped(*args, **kw):
                torch.cuda.synchronize()
                before, t0 = self.counts(), time.perf_counter()
                out = orig(*args, **kw)
                torch.cuda.synchronize()
                dt, after = time.perf_counter() - t0, self.counts()
                self.calls.append((kind, {n: after[n] - before[n]
                                          for n in after}, dt))
                return out
            return wrapped

        for kind, orig in self.orig.items():
            setattr(self.cls, kind, wrap(kind, orig))
        return self

    def __exit__(self, *exc):
        for kind, orig in self.orig.items():
            setattr(self.cls, kind, orig)

    def median_ms(self, skip: int = 0) -> float:
        return 1e3 * statistics.median(dt for _, _, dt in self.calls[skip:])


def launches_of(k1: int = 0, k2: int = 0, k3=(0, 0, 0),
                cells: int = 0) -> dict:
    """The K1, K2, cell-sum and bf16 D = 64 K3 counts of
    ``gpt2_train.kernel_launches`` (every other K3 route 0)."""
    from commefficient_torch.ops import flash_attention as FA
    return {**sketch_launches(1, k1, k2, cells),
            **dict.fromkeys(FA.launches, 0), **dict(zip(K3_NAMES, k3))}


def check_calls(tag: str, calls, want) -> None:
    """``calls`` (kind, launches, s) against ``want`` (kind, launches),
    call by call."""
    got = [(kind, launches) for kind, launches, _ in calls]
    if got != list(want):
        bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
               if g != w]
        fail(f"{tag}: {len(got)} calls, want {len(want)}; first "
             f"differences (call, got, want): {bad[:3]}")


def errors_in(obj, path="") -> list:
    """The paths of every ``error`` key in a JSON value."""
    if isinstance(obj, dict):
        return ([path + "/error"] if "error" in obj else []) + [
            p for k, v in obj.items() for p in errors_in(v, f"{path}/{k}")]
    if isinstance(obj, list):
        return [p for i, v in enumerate(obj)
                for p in errors_in(v, f"{path}/{i}")]
    return []


def bench_as_a_user() -> dict:
    """``python -m commefficient_torch.bench.bench --telemetry_dir D`` in
    a subprocess: rc 0, the last line parses with bench.py's keys at each
    depth, no ``error`` anywhere, each stage's value > 0, mfu in (0, 1]
    and upload bytes exact, the GPT-2 stage's measured ledger; the stream
    validates and holds three bench and utilization events and a
    summary. Returns the line."""
    tdir = os.path.join(DATA_ROOT["path"], "bench_telemetry")
    root = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "commefficient_torch.bench.bench",
            "--telemetry_dir", tdir]
    print("[bench] " + " ".join(argv[1:]), flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"bench: rc {proc.returncode}; stderr tail:\n"
             f"{proc.stderr[-4000:]}")
    line = json.loads(lines[-1])
    stages = {"headline": line, "cifar_saturated": line["cifar_saturated"],
              "gpt2": line["gpt2"]}
    errs = errors_in(line)
    if errs:
        fail(f"bench: errors at {errs}: {line}")
    for name, stage in stages.items():
        if set(stage) != BENCH_KEYS[name]:
            fail(f"bench {name}: keys {sorted(stage)}, want "
                 f"{sorted(BENCH_KEYS[name])}")
        mfu = stage["mfu"]
        if not stage["value"] > 0 or mfu is None or not 0 < mfu <= 1:
            fail(f"bench {name}: value {stage['value']}, mfu {mfu}")
        if stage["wire_bytes_per_round"] != BENCH_WIRE_BYTES[name]:
            fail(f"bench {name}: {stage['wire_bytes_per_round']} bytes a "
                 f"round on the wire, want {BENCH_WIRE_BYTES[name]}")
    if stages["cifar_saturated"]["round_images"] != 32 * 512:
        fail(f"bench: saturated round of {line['cifar_saturated']}")
    ledger = stages["gpt2"]["memory_ledger"] or {}
    if not (ledger.get("temp_bytes") or 0) > 0:
        fail(f"bench gpt2: memory ledger {ledger}")
    events = read_stream(tdir, "bench")
    kinds = kinds_of(events)
    if kinds.get("bench") != 3 or kinds.get("utilization") != 3 or \
            events[-1]["event"] != "summary":
        fail(f"bench stream: {kinds}, last {events[-1]['event']}")
    print(f"[bench] the entry point took {wall:.1f} s; its stream holds "
          f"{kinds}; its line: {json.dumps(line)}", flush=True)
    return line


def bench_attention_check(model_arms, long_arms):
    """The bench paths' attention against dense attention
    (BENCH_ATTN_LIMITS): each flash arm's first loss in the benches'
    records against the dense arm's; then, at each shape that a bench
    path gives K3, the first-step loss and c_attn gradient blocks
    recomputed with dense attention, with K3, and with a planted fault in
    each K3 kernel (``planted_k3``), which the check must reject."""
    import torch
    from commefficient_torch.bench import (bench_gpt2, bench_gpt2_model,
                                           bench_longctx)
    from commefficient_torch.core.client import make_forward_grad
    from commefficient_torch.losses import make_gpt2_train_loss
    from commefficient_torch.models.gpt2 import (GPT2Config,
                                                 GPT2DoubleHeads, GPT2LMHead)

    lim = BENCH_ATTN_LIMITS

    def rel(a, b):
        return abs(a - b) / abs(b)

    dense = {a["remat"]: a for a in model_arms if a["attn"] == "dense"
             and "error" not in a}
    pairs = [(f"bench_gpt2_model {a['arm']}", a["first_loss"],
              dense.get(a["remat"], dense[True])["first_loss"])
             for a in model_arms if a["attn"] == "flash"]
    pairs += [(f"bench_longctx S={d['S']}", f["first_loss"], d["first_loss"])
              for d, f in zip(long_arms[::2], long_arms[1::2])]
    for tag, flash, ref in pairs:
        print(f"[bench] {tag}: first-step loss flash {flash:.6f}, dense "
              f"{ref:.6f} (relative {rel(flash, ref):.2e}, limit "
              f"{lim['loss']})", flush=True)
        if not rel(flash, ref) <= lim["loss"]:
            fail(f"{tag}: flash first loss {flash} against dense {ref}")

    def bare_model():
        W, B, NC, S = bench_gpt2_model.SHAPE
        gcfg = GPT2Config(remat=True)
        cfg = bench_gpt2_model.model_step_config(W, B)
        batch = {k: v[0] for k, v in bench_gpt2.random_batch(
            gcfg, bench_gpt2_model.SHAPE, "cuda").items()}
        mask = torch.ones(B, dtype=torch.bool, device="cuda")

        def loss_and_grad(attn):
            model = bench_gpt2.seeded_gpt2(GPT2DoubleHeads, gcfg, attn,
                                           "cuda")
            fwd = make_forward_grad(cfg, make_gpt2_train_loss(
                model, lm_chunk=cfg.lm_chunk), B)
            g, res, _ = fwd(model.flat.detach(), batch, mask)
            return float(res[0]), qkv_blocks(model, g)

        return f"bench_gpt2_model (N, S) = ({B * NC}, {S})", S, loss_and_grad

    def long_context(S):
        B = bench_longctx.TOKENS // S
        gcfg = GPT2Config(n_positions=S, remat=True)
        ids, labels = bench_longctx.lm_batch(gcfg, B, S, "cuda")

        def loss_and_grad(attn):
            model = bench_gpt2.seeded_gpt2(GPT2LMHead, gcfg, attn, "cuda")
            w = model.flat.detach().requires_grad_(True)
            loss = bench_longctx.lm_loss(model, ids, labels)(w)
            (g,) = torch.autograd.grad(loss, w)
            return float(loss), qkv_blocks(model, g)

        return f"bench_longctx (N, S) = ({B}, {S})", S, loss_and_grad

    def passes(r):
        return r["loss"] <= lim["loss"] and r["grad"] <= lim["grad"]

    for tag, S, loss_and_grad in [bare_model()] + [
            long_context(S) for S in bench_longctx.SEQS]:
        loss_d, g_d = loss_and_grad("dense")

        def reading(fault=None):
            with planted_k3(fault, S, "cuda"):
                loss, g = loss_and_grad("flash")
            return {"loss": rel(loss, loss_d),
                    "grad": worst_block_error(g, g_d)}

        sound = reading()
        planted = {fault: reading(fault) for fault in K3_NAMES}
        torch.cuda.empty_cache()
        print(f"[bench] {tag}, flash against dense: loss {sound['loss']:.2e}"
              f", c_attn q/k/v gradient {sound['grad']:.3e} (limits {lim})"
              "; with a planted fault: "
              + ", ".join(f"{f} loss {r['loss']:.2e} gradient "
                          f"{r['grad']:.3e}" for f, r in planted.items()),
              flush=True)
        if not passes(sound):
            fail(f"{tag}: flash disagrees with dense attention: {sound}")
        caught = [f for f, r in planted.items() if passes(r)]
        if caught:
            fail(f"{tag}: the check passed planted faults in {caught}")


def phase_bench():
    """The benchmark entry points on the card (``commefficient_torch/
    bench/``):

    - ``bench`` as a user runs it (``bench_as_a_user``);
    - in process, every count set to 0 just before and read just after,
      each round between two syncs (``SyncedRounds``): ``run_cifar`` on
      the float32 and on the int8 wire (W + 1 K1, 1 K2 and 1 cell sum in
      every warmup and timed round, the bytes exact); ``round_shape_grid``
      at its 9 cells (W + 1 K1, 1 K2 and 1 cell sum a round at W = 8, 16,
      32); ``gpt2_mfu_sweep`` with SWEEP_ARMS (``bench_gpt2.run`` in each
      arm: SWEEP_K1, 1 K2 and 1 cell sum a round; the ``overlap`` arm's
      synced calls are its client halves, SWEEP_K1 and no K2 or cell sum,
      and both its ledgers are measured); ``ledger_ab``
      at full width (the cohort: 8 K1 fused, 1 unfused, no K2; both
      ledgers measured); ``bench_imagenet`` in both layouts (no K1/K2);
      ``bench_gpt2_model`` (K3 at (16, 256, 12, 64): 12 layers x 8
      clients a step, the forward twice under remat; its no-remat dense
      arm runs or records its error); ``bench_longctx`` (K3 at S = 1024,
      2048, 4096: 24 forwards, 12 dq, 12 dk/dv a flash step); then
      ``bench_attention_check`` (flash against dense at each of these
      shapes, with planted faults).
    Prints the [bench] line; returns the launches by path."""
    from commefficient_torch import gpt2_train
    from commefficient_torch.bench import (bench, bench_gpt2,
                                           bench_gpt2_model, bench_imagenet,
                                           bench_longctx, gpt2_mfu_sweep,
                                           round_shape_grid)
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops import flash_attention as FA

    counts = gpt2_train.kernel_launches
    launches = {}

    def zero():
        K.reset_launches()
        FA.reset_launches()

    line = bench_as_a_user()
    R = BENCH_ROUNDS

    # run_cifar on both wires: 2 warmup + R timed rounds
    cifar_ms = {}
    for wire in ("float32", "int8"):
        res = {"metric": "cifar10_sketch_round_throughput"}
        zero()
        with SyncedRounds(counts) as rec:
            bench.run_cifar(res, n_rounds=R, wire_dtype=wire)
        check_calls(f"run_cifar {wire}", rec.calls,
                    [("round", launches_of(9, 1, cells=1))] * (2 + R))
        want = BENCH_INT8_BYTES if wire == "int8" else \
            BENCH_WIRE_BYTES["headline"]
        if res["wire_bytes_per_round"] != want:
            fail(f"run_cifar {wire}: {res['wire_bytes_per_round']} bytes, "
                 f"want {want}")
        launches[f"bench run_cifar W=8 {wire}"] = counts()
        cifar_ms[wire] = rec.median_ms(skip=2)

    # the round-shape grid: 9 cells of 2 warmup + R rounds
    zero()
    with SyncedRounds(counts) as rec:
        grid = round_shape_grid.main(["--rounds", str(R)])
    cells = [(W, B) for W in round_shape_grid.GRID_W
             for B in round_shape_grid.GRID_B]
    check_calls("round_shape_grid", rec.calls,
                [("round", launches_of(W + 1, 1, cells=1))
                 for W, _ in cells for _ in range(2 + R)])
    if [(r["W"], r["B"]) for r in grid["rows"]] != cells or any(
            "error" in r or r["mfu"] is None or not 0 < r["mfu"] <= 1
            for r in grid["rows"]):
        fail(f"round_shape_grid: {grid}")
    launches["bench round_shape_grid"] = counts()
    per_cell = 2 + R
    sat_ms = 1e3 * statistics.median(
        dt for _, _, dt in rec.calls[-per_cell:][2:])

    # the sweep: each arm 1 warmup + R timed rounds + the ledger's round
    out = os.path.join(DATA_ROOT["path"], "gpt2_mfu_sweep.jsonl")
    zero()
    with SyncedRounds(counts) as rec:
        rc = gpt2_mfu_sweep.main(["--arms", ",".join(SWEEP_ARMS),
                                  "--rounds", str(R), "--out", out])
    with open(out) as f:
        arms = {r["arm"]: r for r in map(json.loads, f)}
    if rc != 0 or list(arms) != list(SWEEP_ARMS):
        fail(f"gpt2_mfu_sweep: rc {rc}, lines {arms}")
    # the overlap arm's rounds are split: its synced calls are the client
    # halves (its K2 and cell-sum launches in the decode halves between
    # them)
    check_calls("gpt2_mfu_sweep", rec.calls,
                [("cohort", launches_of(SWEEP_K1[a], 0)) if a == "overlap"
                 else ("round", launches_of(SWEEP_K1[a], 1, cells=1))
                 for a in SWEEP_ARMS for _ in range(R + 2)])
    for a in SWEEP_K1:
        res = arms[a].get("result") or {}
        ledgers = ["memory_ledger"] + (["memory_ledger_decode"]
                                       if a == "overlap" else [])
        if "error" in arms[a] or not res.get("value", 0) > 0 or \
                not 0 < (res.get("mfu") or 0) <= 1 or \
                not all(((res.get(k) or {}).get("temp_bytes") or 0) > 0
                        for k in ledgers):
            fail(f"gpt2_mfu_sweep {a}: {arms[a]}")
    launches["bench gpt2_mfu_sweep (bench_gpt2.run arms)"] = counts()
    gpt2_ms = 1e3 * statistics.median(dt for _, _, dt in
                                      rec.calls[1:R + 1])

    # ledger_ab at full width: two cohort calls an arm
    zero()
    with SyncedRounds(counts) as rec:
        ab = bench_gpt2.ledger_ab()
    check_calls("ledger_ab", rec.calls,
                [("cohort", launches_of(8))] * 2
                + [("cohort", launches_of(1))] * 2)
    temps = {fe: (led or {}).get("temp_bytes")
             for fe, led in ab["arms"].items()}
    if ab["d"] != GPT2_BENCH_SKETCH["d"] or not all(
            t and t > 0 for t in temps.values()):
        fail(f"ledger_ab: {ab}")
    launches["bench ledger_ab (cohorts)"] = counts()

    # ImageNet in both layouts: uncompressed, no K1/K2
    imagenet = {}
    for layout in ("uint8_device", "float_host"):
        zero()
        res = bench_imagenet.main(["--layout", layout, "--rounds", str(R)])
        if counts() != launches_of() or not res["value"] > 0 or \
                not 0 < (res["mfu"] or 0) <= 1 or res["round_images"] != 448:
            fail(f"bench_imagenet {layout}: {res}, launches {counts()}")
        imagenet[layout] = res

    def per_step(module, name):
        """Wraps ``module.<name>`` (one step) and ``module.seeded_gpt2``
        (one arm's model): a None-separated list of each step's
        launches."""
        steps, orig, seeded = [], getattr(module, name), module.seeded_gpt2

        def step(*a, **kw):
            before = counts()
            out = orig(*a, **kw)
            after = counts()
            steps.append({n: after[n] - before[n] for n in after})
            return out

        def model(cls, gcfg, attn, dev):
            steps.append((gcfg.remat, attn))
            return seeded(cls, gcfg, attn, dev)

        return steps, {name: (step, orig), "seeded_gpt2": (model, seeded)}

    def run_counted(module, name, fn):
        steps, patches = per_step(module, name)
        for attr, (new, _) in patches.items():
            setattr(module, attr, new)
        try:
            zero()
            return fn(), steps
        finally:
            for attr, (_, old) in patches.items():
                setattr(module, attr, old)

    def check_steps(tag, arms, steps, n):
        """Each arm's steps: 1 + BENCH_STEPS of them (an arm with an
        error: at most that many), each with n K3 calls of each kernel in
        a flash arm (the forward twice under remat), none in a dense
        one."""
        got = []
        for s in steps:
            if isinstance(s, tuple):
                got.append((s, []))
            else:
                got[-1][1].append(s)
        if len(got) != len(arms):
            fail(f"{tag}: {len(got)} arms built, {len(arms)} recorded")
        for arm, ((remat, attn), arm_steps) in zip(arms, got):
            want = (launches_of(k3=((1 + remat) * n, n, n))
                    if attn == "flash" else launches_of())
            if ("error" not in arm and len(arm_steps) != 1 + BENCH_STEPS) \
                    or len(arm_steps) > 1 + BENCH_STEPS \
                    or any(s != want for s in arm_steps):
                fail(f"{tag} {arm}: steps {arm_steps}, want "
                     f"{1 + BENCH_STEPS} of {want}")

    model_arms, steps = run_counted(
        bench_gpt2_model, "chained_step",
        lambda: bench_gpt2_model.run(BENCH_STEPS))
    # 12 layers x 8 clients (one microbatch of 16 sequences each)
    check_steps("bench_gpt2_model", model_arms, steps, 96)
    for a in model_arms:
        if "error" in a and (a["remat"] or a["attn"] != "dense"):
            fail(f"bench_gpt2_model {a['arm']}: {a['error']}")
    launches["bench_gpt2_model"] = counts()

    long_arms, steps = run_counted(
        bench_longctx, "grad_step",
        lambda: bench_longctx.run(BENCH_STEPS))
    check_steps("bench_longctx", long_arms, steps, 12)
    if any("error" in a for a in long_arms):
        fail(f"bench_longctx: {long_arms}")
    launches["bench_longctx"] = counts()
    bench_attention_check(model_arms, long_arms)
    bare = phase_bench_model()
    time_done("bench_imagenet_model (the bare FixupResNet50 step at 224)")
    smi = smi_line()
    sat, g = line["cifar_saturated"], line["gpt2"]
    summary = (
        f"[bench] on {smi}: python -m commefficient_torch.bench.bench: "
        f"headline {line['value']} img/s, mfu {line['mfu']}; saturated "
        f"{sat['value']} img/s, mfu {sat['mfu']}; gpt2 {g['value']} tok/s, "
        f"mfu {g['mfu']}, warm-round temp "
        f"{g['memory_ledger']['temp_bytes']} B; synced round medians "
        f"(in process, ms): headline {cifar_ms['float32']:.3f} (int8 wire "
        f"{cifar_ms['int8']:.3f}), saturated {sat_ms:.3f}, gpt2 "
        f"{gpt2_ms:.3f}; sweep (tok/s, mfu): "
        + ", ".join(f"{a} {arms[a]['result']['value']} "
                    f"{arms[a]['result']['mfu']}" for a in SWEEP_K1)
        + f"; ledger_ab cohort temp auto {temps['auto']} B, off "
        f"{temps['off']} B (d x 4 = {4 * ab['d']}), covers "
        f"{ab.get('drop_covers_dense_grad')}; imagenet "
        + ", ".join(f"{k} {r['value']} img/s mfu {r['mfu']}"
                    for k, r in imagenet.items())
        + "; grid (W, B: img/s, mfu) "
        + ", ".join(f"{r['W']}x{r['B']}: {r['img_per_s']} {r['mfu']}"
                    for r in grid["rows"])
        + "; bare model (ms/step, mfu) "
        + ", ".join(f"{a['arm']} "
                    + (f"{a['ms']:.2f} {a['mfu']:.4f}" if "ms" in a
                       else a.get("error", "")[:60])
                    for a in model_arms)
        + "; longctx (S attn ms/step mfu) "
        + ", ".join(f"{a['S']} {a['attn']} {a['ms']:.2f} {a['mfu']:.4f}"
                    for a in long_arms)
        + f"; bench_imagenet_model batch 64: {bare['ms_per_step']:.3f} "
        f"ms/step, {bare['img_per_s']:.1f} img/s, mfu "
        f"{bare['mfu_flopcounter']:.4f} (FlopCounterMode) / "
        f"{bare['mfu_script_count']:.4f} (3 x 4.1e9, C13), busy "
        f"{bare['busy_ms_per_step']:.3f} ms/step")
    print(summary, flush=True)
    return launches


# the stream's readers, the crash harness and the study recipes (A11c,
# A13): the crash rows of the full run (the two that no child test of
# the port covered before the crash matrix), the curve arms of its
# one-epoch smoke, and the K1, K2 and cell sums a ResNet-9 sketch round
# launches (PERF.md kernel table)
CRASH_FULL_POINTS = ("mid_round", "async_pool")
# the crash child: 2 epochs of 7 rounds (the sampler stops when fewer
# than W = 4 clients have data left), W K1 (no weight decay: no decay
# encode), 1 K2 and 1 cell sum a synchronous round
CRASH_ROUNDS, CRASH_W = 14, 4
# the EF study's arms in the smoke: 9 rows (K1/K2 past r = 8 on a real
# path) and the subtract rule, which aborted in its first epoch on the TPU
CURVE_EF_SMOKE_ARMS = ("gpt2_sketch24_clip1_r9", "gpt2_sketch24_sub")
CURVE_SMOKE_ARMS = ("cv_uncompressed24", "cv_true_topk24", "cv_sketch96",
                    "gpt2_sketch24", "gpt2_sketch24_clip",
                    "gpt2_sketch24_denseclip") + CURVE_EF_SMOKE_ARMS
# each curve arm's K1, K2 and cell sums a round (PERF.md kernel table;
# core/server.py): the ResNet-9 sketch 9 K1 (8 clients and the weight
# decay's encode); the GPT-2 sketch 8 (no weight decay), also under the
# table clip (each client's table is clipped) and at any width, r or k;
# 1 under the dense clip (one encode of the clipped sum); the subtract
# rule 2 cell sums (encode_at of the update and encode_vals_at of the
# momentum's kept values); the dense server state 1 K1 (one encode of the
# round's dense sum) and no cell sum (its state is dense); the dense arms
# none
CURVE_LAUNCHES = {
    "cv_uncompressed24": (0, 0, 0), "cv_true_topk24": (0, 0, 0),
    "cv_sketch96": (9, 1, 1),
    "gpt2_uncompressed24": (0, 0, 0), "gpt2_true_topk24_clip": (0, 0, 0),
    "gpt2_true_topk24": (0, 0, 0),
    "gpt2_sketch24": (8, 1, 1), "gpt2_sketch24_clip": (8, 1, 1),
    "gpt2_sketch24_denseclip": (1, 1, 1), "gpt2_sketch24_clip8": (8, 1, 1),
    "gpt2_sketch24_c1048576": (8, 1, 1), "gpt2_sketch24_c2097152": (8, 1, 1),
    "gpt2_sketch48": (8, 1, 1),
    "gpt2_sketch24_clip1_decay95": (8, 1, 1),
    "gpt2_sketch24_clip1_k200k": (8, 1, 1),
    "gpt2_sketch24_clip1_r9": (8, 1, 1),
    "gpt2_sketch24_clip1_c1p8m": (8, 1, 1),
    "gpt2_sketch24_clip1_c4m": (8, 1, 1),
    "gpt2_sketch24_clip1_c8m": (8, 1, 1),
    "gpt2_sketch24_clip1_r2_c4p6m": (8, 1, 1),
    "gpt2_sketch24_densestate_clip1": (1, 1, 0),
    "gpt2_sketch24_densestate_clip1_decay95": (1, 1, 0),
    "gpt2_sketch24_sub": (8, 1, 2),
    "gpt2_sketch24_sub_clip1": (8, 1, 2),
    "gpt2_sketch24_sub_clip1_decay90": (8, 1, 2),
    "gpt2_sketch24_sub_clip1_r9": (8, 1, 2),
    "gpt2_sketch24_sub_clip1_c1p8m": (8, 1, 2),
    "gpt2_sketch24_densestate": (1, 1, 0)}
CURVES_OUT = "curves_out"


def phase_readers(logdir: str) -> None:
    """The port's ``check_telemetry_schema`` and ``teleview summarize``,
    in process, on the stream at ``logdir``: both exit 0, and the summary
    names ``cv_train`` and the card."""
    import io

    import torch
    from commefficient_torch.scripts import check_telemetry_schema, teleview
    path = os.path.join(logdir, "telemetry.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_check = check_telemetry_schema.main([path])
        mark = len(buf.getvalue())
        rc_view = teleview.main(["summarize", path])
    text = buf.getvalue()
    summary = text[mark:]
    kind = torch.cuda.get_device_name(0)
    if rc_check != 0 or rc_view != 0 or "cv_train" not in summary \
            or kind not in summary:
        fail(f"the stream's readers on {path}: check_telemetry_schema rc "
             f"{rc_check}, teleview summarize rc {rc_view}: "
             f"{text[-1500:]}")
    print(f"[readers] check_telemetry_schema: "
          f"{text[:mark].strip().splitlines()[-1]}; teleview summarize: "
          f"{summary.strip().splitlines()[0]} ({len(summary.splitlines())}"
          " lines)", flush=True)


def phase_bench_model() -> dict:
    """``bench_imagenet_model`` at batch 64 in process: its line and the
    top-25 table printed, every reported value finite and > 0."""
    from commefficient_torch.scripts import bench_imagenet_model
    out = bench_imagenet_model.main(["--batch", "64"])
    vals = [out["ms_per_step"], out["img_per_s"], out["mfu_flopcounter"],
            out["mfu_script_count"], out["busy_ms_per_step"]] + [
        ms for _, ms in out["ops_ms_per_step"][:bench_imagenet_model.TOP]]
    if not all(v is not None and math.isfinite(v) and v > 0
               for v in vals) or not out["grad_finite"] \
            or len(out["ops_ms_per_step"]) < bench_imagenet_model.TOP:
        fail(f"bench_imagenet_model: a reported value is not finite and "
             f"positive: {vals[:5]}, {len(out['ops_ms_per_step'])} ops")
    return out


def phase_crash(points=CRASH_FULL_POINTS) -> dict:
    """``crash_matrix`` with children on the card, at the rows
    ``points``: each row killed, resumed and held bit for bit to the
    straight child; the straight synchronous child launches exactly
    CRASH_W K1, 1 K2 and 1 cell sum a round at d = 18 (the asynchronous one's counts
    printed). Returns the straight children's launches."""
    from commefficient_torch.scripts import crash_matrix
    rows = [m for m in crash_matrix.MATRIX if m[0] in points]
    res = {}
    t = time.perf_counter()
    rc = crash_matrix.run_matrix(rows, keep=False, device="cuda",
                                 results=res)
    if rc != 0 or any(res.get(m[0]) != "PASS" for m in rows):
        fail(f"crash matrix on the card: rc {rc}, "
             + ", ".join(f"{m[0]} {res.get(m[0])}" for m in rows))
    launches = {("async" if a else "sync"): res[("straight", a)]
                for a in (False, True) if ("straight", a) in res}
    sync = launches.get("sync")
    if sync is not None and sync != sketch_launches(CRASH_ROUNDS, CRASH_W):
        fail(f"crash matrix: the straight child launched {sync}; want "
             f"{CRASH_W} K1 + 1 K2 + 1 cell sum a round over {CRASH_ROUNDS} "
             "rounds")
    asy = launches.get("async")
    if asy is not None and not (asy["circ_encode"] > 0
                                and asy["circ_decode"] > 0):
        fail(f"crash matrix: the async straight child launched {asy}")
    print(f"[crash] rows {[m[0] for m in rows]} passed on the card in "
          f"{time.perf_counter() - t:.1f} s; straight children's launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return {f"crash_matrix straight {k} child": v
            for k, v in launches.items()}


def check_curve_record(rec: dict, arm, strict: bool = True) -> bool:
    """A curve run's record: a TSV with its header, finite epoch rows,
    the upload MiB at the TPU's seed equal to the TPU log's, and the
    arm's K1, K2 and cell sums a round (``CURVE_LAUNCHES``) over the
    rounds it ran. An arm whose TPU run aborted (``arm.tpu_abort``) may
    have no epoch row (the port's run aborted too) and has no upload
    column to compare; whether it aborted where the TPU's did is
    ``curves band``'s verdict. Fails on a wrong header or a non-finite
    row, and on a full arm's record without an epoch row when
    ``strict``; on the rest too when ``strict``, else prints what differs
    (the whole study reports, it does not stop). Returns whether
    everything matched."""
    from commefficient_torch.scripts import curves
    name = rec["arm"]
    with open(rec["tsv"]) as f:
        head = f.readline().strip()
    want_head = ("epoch,hours,top1Accuracy" if arm.kind == "cv"
                 else "epoch\thours\ttest_nll\tppl\tmc_acc")
    rows = rec["epochs"]
    aborting = arm.tpu_abort is not None
    if head != want_head or not all(
            math.isfinite(r["test_loss"]) for r in rows):
        fail(f"curves {name}: header {head!r}, epoch rows {rows}")
    problems = []
    if not rows and not aborting:
        problems.append("no epoch row: the run aborted")
    if rec["seed"] == curves.TPU_SEED and not aborting:
        wrong = curves.up_matches(rec, arm.tpu_log)
        if wrong:
            problems.append(f"up (MiB) differs from the TPU log's: "
                            f"{wrong[:5]}")
    n = rec["rounds"]
    k1, k2, cells = CURVE_LAUNCHES[name]
    want = sketch_launches(n, k1, k2, cells)
    got = {k: rec["launches"][k] for k in want}
    if got != want:
        problems.append(f"launches {got} over {n} rounds; want {k1} K1 + "
                        f"{k2} K2 + {cells} cell sum a round")
    if problems and strict:
        fail(f"curves {name}: " + "; ".join(problems))
    for p in problems:
        print(f"[curves] {name} seed {rec['seed']}: {p}", flush=True)
    return not problems


def phase_curves(arms=CURVE_SMOKE_ARMS, seeds=(21,), epochs=1,
                 out=None, strict=True) -> dict:
    """The study recipes (``curves.run_arm``) on the card: each arm at each
    seed, its first ``epochs`` epochs (None: the whole run), each run's
    record checked (``check_curve_record``). Returns the records."""
    from commefficient_torch.scripts import curves
    out = out or os.path.join(DATA_ROOT["path"], "curves")
    recs = {}
    for name in arms:
        for seed in seeds:
            t = time.perf_counter()
            rec = curves.run_arm(name, seed, out, "cuda", epochs)
            check_curve_record(rec, curves.ARMS[name], strict)
            recs[(name, seed)] = rec
            print(f"[curves] {name} seed {seed}: {curve_outcome(rec)}; "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
    return recs


def curve_outcome(rec: dict) -> str:
    """A run record's rounds, round median, last epoch row (or the
    driver's abort and its first non-finite round) and launches."""
    from commefficient_torch.scripts import curves
    if rec["epochs"]:
        row = rec["epochs"][-1]
        end = (f"epoch {row['epoch']}: test_loss {row['test_loss']:.4f} "
               f"test_acc {row['test_acc']:.4f} up (MiB) "
               f"{row['up (MiB)']}")
    else:
        with open(os.path.splitext(rec["tsv"])[0] + ".log") as f:
            end = (f"aborted, first non-finite round "
                   f"{curves.abort_round(f.read())}, no epoch row")
    median = rec["round_s_median"]
    return (f"{rec['rounds']} rounds, round median "
            f"{median * 1e3 if median else float('nan'):.3f} ms, {end}; "
            f"launches {nonzero(rec['launches'])}")


# the study's runs on the card at once: six GPT-2 runs share one H100
# without slowing a round
CURVE_PROCS = 6


def run_curve_study(arms, seeds, out: str) -> None:
    """The A13 study (``--curves``): every arm at every seed, CURVE_PROCS
    child processes on the card at once (``curves run`` each, largest
    tables first), each run's record checked, then ``curves band``: each
    arm's per-epoch verdict against its TPU curve in
    ``out/<arm>_band.txt``, its first line printed. A curve outside its
    band is a finding, not a failure of the run. The data the runs share
    under ``out`` is written here first, once for each kind of arm, so
    that no two children prepare it at once."""
    from commefficient_torch.scripts import curves
    first = {}
    for a in arms:
        first.setdefault(curves.ARMS[a].kind, a)
    for a in first.values():
        curves.prepare_data(a, out)
    jobs = sorted(((a, s) for a in arms for s in seeds),
                  key=lambda job: curve_cost(curves.ARMS[job[0]]),
                  reverse=True)
    rcs = run_children(
        [(f"{a}_s{s}", [sys.executable, "-m",
                        "commefficient_torch.scripts.curves", "run",
                        "--arms", a, "--seeds", str(s), "--out", out])
         for a, s in jobs], CURVE_PROCS, out)
    for a, s in jobs:
        path = os.path.join(out, f"{a}_s{s}.json")
        if rcs[f"{a}_s{s}"] != 0 or not os.path.exists(path):
            print(f"[curves] {a} seed {s}: the run failed (rc "
                  f"{rcs[f'{a}_s{s}']}, {out}/{a}_s{s}.out)", flush=True)
            continue
        with open(path) as f:
            rec = json.load(f)
        check_curve_record(rec, curves.ARMS[a], strict=False)
        print(f"[curves] {a} seed {s}: {curve_outcome(rec)}; "
              f"{rec['wall_s']:.1f} s", flush=True)
    print(f"[curves] on {smi_line()}", flush=True)
    curves.main(["band", "--arms", ",".join(arms), "--seeds",
                 ",".join(map(str, seeds)), "--out", out])


def curve_cost(arm) -> tuple:
    """A run's expected length, for the order of the study's runs: whole
    runs before those whose TPU run aborted, more epochs first, then
    the larger table."""
    flags = list(arm.flags)

    def value(flag, default):
        return int(flags[flags.index(flag) + 1]) if flag in flags \
            else default
    return (arm.tpu_abort is None, arm.epochs,
            value("--num_rows", 0) * value("--num_cols", 0))


def run_children(jobs, procs: int, out: str) -> dict:
    """Runs the commands of ``jobs`` (``(name, argv)``), ``procs`` at a
    time, each one's output in ``out/<name>.out``; returns each one's
    exit code. Stops every child it started if interrupted."""
    running, rcs, queue = {}, {}, list(jobs)
    try:
        while queue or running:
            while queue and len(running) < procs:
                name, argv = queue.pop(0)
                log = open(os.path.join(out, f"{name}.out"), "w")
                running[name] = (subprocess.Popen(
                    argv, stdout=log, stderr=subprocess.STDOUT), log,
                    time.perf_counter())
            time.sleep(2)
            for name, (proc, log, t) in list(running.items()):
                if proc.poll() is not None:
                    log.close()
                    rcs[name] = proc.returncode
                    del running[name]
                    print(f"[curves] {name}: rc {proc.returncode} after "
                          f"{time.perf_counter() - t:.1f} s", flush=True)
    finally:
        for proc, log, _ in running.values():
            proc.kill()
            proc.wait()
            log.close()
    return rcs


def run_services() -> dict:
    """phase_robust, phase_async and phase_preempt; returns {path: K1/K2
    launches} for the kernel line."""
    plain, arms = phase_robust()
    async_launches, async_ms = phase_async(plain)
    wd_launches, preempt_s = phase_preempt(plain)
    print("[slice 13] round medians (ms) and peaks (GiB), beside the plain "
          f"sketch round's {plain['ms']:.3f} / {plain['peak'] / 2**30:.3f}: "
          + ", ".join(f"{a} {ms:.3f} / {pk / 2**30:.3f}"
                      for a, (_, ms, pk) in arms.items())
          + f"; async K=1 M=1 tick {async_ms['k1m1_ms']:.3f}, stragglers "
          f"tick {async_ms['tick_ms']:.3f} and commit "
          f"{async_ms['commit_ms']:.3f}; preempt children (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in preempt_s.items()),
          flush=True)
    return {"plain": plain["launches"],
            **{f"--defense/--adversary {a}": v[0] for a, v in arms.items()},
            **{f"--async_agg {a}": v for a, v in async_launches.items()},
            "--watchdog": wd_launches}


# ------------------------------------------------ the split round, the mesh

# the split round (--decode_overlap) against the monolithic one through the
# entry point at the ResNet-9 headline round: ROUNDS_SPLIT rounds a run,
# the four runs interleaved (monolithic, split, split, monolithic); the
# GPT-2 sweep's overlap arms beside its base arm, GPT2_OVERLAP_ROUNDS
# timed rounds a run, interleaved the same way
ROUNDS_SPLIT = 5
GPT2_OVERLAP_ARMS = ("base", "overlap", "overlap_unfused")
GPT2_OVERLAP_ROUNDS = 3
# the 1-rank NCCL mesh at the headline round: MESH1_ROUNDS rounds of
# 8 x 64 seeded images a run; the no-mesh round held to the JAX mesh
# test's tolerance (tests/test_parallel.py: rtol 1e-4, atol 1e-6)
MESH1_ROUNDS = 3
MESH1_RTOL, MESH1_ATOL = 1e-4, 1e-6
# K2's range form: shards of d_pad over 4 and 8 ranks
DECODE_SHARDS = (4, 8)
# ring attention at GPT-2 small's width (H = 12, D = 64): (N, S, shards)
RING_SHAPES = ((8, 1024, 4), (4, 4096, 8))
# the ring's outputs against plain float32 dense attention, each output
# row against its own norm (the ring's bf16 output and gradients round
# once, as K3's do); against K3, the largest difference over the dense
# output's largest value (a per-row measure would divide K3's own error
# in a near-zero row, dq's first, by that row's norm)
RING_ROW_RTOL = FLASH_ROW_RTOL
RING_K3_RTOL = 2e-2
# the scaling curves' n = 1 arms on the card (3 rounds after 2 of
# warm-up) and the multi-host dryrun's time limit on the CPU
SCALING_ROUNDS = 3
MULTIHOST_TIMEOUT_S = 300


def range_decode_work(d: int, start: int, n: int, c: int, r: int):
    """(bytes, float operations, instructions by pipe) that K2's range
    form must move and do for the coordinates [start, start + n): the
    table cells its live coordinates (those below d) gather, read once
    (all r c once the range spans c), n values written, and K2's work
    (``sketch_work``) for the live coordinates."""
    live = max(0, min(n, d - start))
    terms = r * live
    return (4 * r * min(live, c) + 4 * n, (1 - r % 2) * 2 * live,
            {p: k * terms for p, k in decode_term_instructions(r).items()})


def phase_decode_range(shape: dict, plain_n: int = 5):
    """K2's range form at (d, c, r) of ``shape``: the shards of d_pad over
    each count of DECODE_SHARDS bitwise (``same_bits``) the whole decode,
    an interior shard bitwise its plain version, a range across d +0.0
    past it; the interior shard timed beside its bound and its plain
    version. Returns {n: timings}."""
    import numpy as np
    import torch
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops.circulant import make_circulant_sketch

    dev = torch.device("cuda")
    d, c, r = shape["d"], shape["c"], shape["r"]
    cs = make_circulant_sketch(d, c, r, device=dev)
    args = (cs.shifts, cs.sign_keys, c, r, cs.m)
    t0 = torch.from_numpy(np.random.RandomState(2).randn(
        r, c).astype(np.float32)).to(dev)
    whole = K.decode(t0, *args, d)
    across = K.decode(t0, *args, d, start=d - 1000, n=5000)
    K.reset_launches()
    one = K.decode(t0, *args, d, start=0, n=d)
    torch.cuda.synchronize()
    if not (same_bits(across[:1000], whole[-1000:])
            and same_bits(across[1000:], torch.zeros(4000, device=dev))):
        fail(f"K2's range form across d (m={cs.m}) is not the whole "
             "decode's tail and +0.0 past d")
    # the range form over [0, d), a sharded tail on one rank, runs the
    # range instantiation and is bitwise the whole decode
    if not same_bits(one, whole) or K.range_launches["circ_decode"] != 1:
        fail(f"K2's range form over [0, d) (m={cs.m}): bitwise "
             f"{same_bits(one, whole)}, range launches "
             f"{K.range_launches['circ_decode']}")
    out = {}
    for n in DECODE_SHARDS:
        blk = -(-d // n)
        shards = [K.decode(t0, *args, d, start=i * blk, n=blk)
                  for i in range(n)]
        cat = torch.cat(shards)
        plain = K.decode_range_plain(t0, *args, d, blk, blk)
        torch.cuda.synchronize()
        err = float((shards[1] - plain).abs().max())
        ok = (same_bits(cat[:d], whole) and same_bits(shards[1], plain)
              and same_bits(cat[d:], torch.zeros(n * blk - d, device=dev)))
        print(f"[range] K2 m={cs.m}, {n} shards of {blk}: bitwise the whole "
              f"decode and the plain version {ok} (max|diff| {err})",
              flush=True)
        if not ok:
            fail(f"K2's range form differs at m={cs.m}, {n} shards")
        ms = time_ms(lambda: K.decode(t0, *args, d, start=blk, n=blk))
        plain_ms = time_ms(
            lambda: K.decode_range_plain(t0, *args, d, blk, blk), n=plain_n)
        nbytes, ops, instr = range_decode_work(d, blk, blk, c, r)
        b_ms, kind = bound(nbytes, ops, H100_FP32_PER_S, instr)
        print(f"[range] K2 m={cs.m}, shard 1 of {n} ([{blk}, {2 * blk})): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({kind}: {nbytes / 1e6:.1f} MB)", flush=True)
        out[n] = {"n": blk, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": b_ms,
                  "bound_by": bound_by(kind), "library_ms": None}
    return out


def host_syncs(fn) -> list:
    """The host syncs ``fn()`` makes (``torch.cuda.set_sync_debug_mode``'s
    warnings), each as ``path:line`` of the innermost frame in the
    repository at the sync, followed by ``(in path:line)`` of the frame
    the warning names where that lies outside it (inside torch). Only
    warnings raised inside ``fn()`` count: the process's first switch to
    the warning mode warns of itself (torch/cuda/__init__.py, read on an
    H100 with torch 2.11)."""
    import traceback
    import warnings
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    found, inside = set(), [False]

    def where(filename: str, lineno: int) -> str:
        return f"{os.path.relpath(filename, root)}:{lineno}"

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if os.path.abspath(f.filename).startswith(root + os.sep)]
        at = where(filename, lineno)
        if ours and where(ours[-1].filename, ours[-1].lineno) != at:
            at = f"{where(ours[-1].filename, ours[-1].lineno)} (in {at})"
        found.add(at)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        inside[0] = True
        try:
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted(found)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, for runs held bitwise to each
    other (a nondeterministic weight gradient would differ between them
    whatever the code under test does)."""
    import torch
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before


def phase_decode_overlap():
    """``--decode_overlap`` at the ResNet-9 headline round through the
    entry point, interleaved with the monolithic round (monolithic, split,
    split, monolithic; cuDNN deterministic in all four): every run 9 K1 +
    1 K2 + 1 cell sum a round; the first split run's losses and state
    bitwise the first monolithic run's; the driver waiting on the cohort's
    event once a round (``DecodeOverlapRound.wait_cohort``) and never on
    the whole card, and the share of rounds whose decode had not ended
    when that wait returned (``decode_done``). The split round again
    under ``--sketch_ef subtract`` (9 K1 + 1 K2 + 2 cell sums a round) and
    ``--sketch_impl hash`` (1 cell sum a round). Then the host syncs of
    the decode half (``FedRuntime.decode``) in those three forms: the
    phase fails on any (phase_mesh1 checks the sharded tail's); the client
    half's are printed. Then the GPT-2 sweep's overlap arms beside its
    base arm, interleaved. Returns (launches by path, the A/B numbers)."""
    import numpy as np
    import torch
    from commefficient_torch.bench import bench_gpt2, gpt2_mfu_sweep
    from commefficient_torch.core import driver, pipeline
    from commefficient_torch.ops import circulant_kernels as K

    base = MAIN_ARGV + dataset_flags("synthetic64") + [
        "--num_rounds", str(ROUNDS_SPLIT)]
    counts = {"wait_cohort": 0, "sync": 0, "decode_running": 0}
    wait, sync = pipeline.DecodeOverlapRound.wait_cohort, driver._sync

    def counted_wait(self):
        counts["wait_cohort"] += 1
        wait(self)
        # the decode had not ended when the host went on
        counts["decode_running"] += not self.decode_done.query()

    def counted_sync(device):
        counts["sync"] += 1
        return sync(device)

    runs, launches_by, medians = {}, {}, {"monolithic": [], "split": []}
    running, runtimes = [], {}
    arms = [(arm, ["--decode_overlap"] if arm == "split" else [],
             sketch_launches(ROUNDS_SPLIT))
            for arm in ("monolithic", "split", "split", "monolithic")]
    arms += [("subtract", ["--decode_overlap", "--sketch_ef", "subtract"],
              sketch_launches(ROUNDS_SPLIT, cells=2)),
             ("hash", ["--decode_overlap", "--sketch_impl", "hash"],
              sketch_launches(ROUNDS_SPLIT, 0, 0))]
    with deterministic_cudnn():
        for arm, flags, want in arms:
            counts.update(wait_cohort=0, sync=0, decode_running=0)
            pipeline.DecodeOverlapRound.wait_cohort = counted_wait
            driver._sync = counted_sync
            try:
                out, launches, _ = run_cv(base + flags, f"overlap {arm}")
            finally:
                pipeline.DecodeOverlapRound.wait_cohort = wait
                driver._sync = sync
            _rounds_ok(f"overlap {arm}", out, launches, want, ROUNDS_SPLIT)
            if flags and (counts["wait_cohort"] != ROUNDS_SPLIT
                          or counts["sync"]):
                fail(f"the split round's driver waited {counts}: want the "
                     f"cohort's event {ROUNDS_SPLIT} times, no whole sync")
            if arm in medians:
                medians[arm].append(
                    statistics.median(out["round_s"][1:]) * 1e3)
            if arm == "split":
                running.append(counts["decode_running"] / ROUNDS_SPLIT)
            launches_by[f"cv_train --decode_overlap ({arm})"] = launches
            runs.setdefault(arm, out)
            if flags:
                runtimes.setdefault("zero rule" if arm == "split" else arm,
                                    out["runtime"])
    mono, split = runs["monolithic"], runs["split"]
    if not np.array_equal(np.asarray(mono["losses"]),
                          np.asarray(split["losses"])):
        fail(f"split losses {split['losses']} != monolithic "
             f"{mono['losses']}")
    bad = same_state_bits(mono["state"], split["state"])
    if bad:
        fail(f"the split round's state differs from the monolithic one's "
             f"in {bad} after {ROUNDS_SPLIT} rounds")
    print(f"[overlap] {ROUNDS_SPLIT} rounds: losses and state bitwise the "
          "monolithic round's; 9 K1 + 1 K2 + 1 cell sum a round (subtract: "
          "2 cell sums; hash: 1); the driver waited on the cohort's event "
          "once a round; share of rounds whose decode still ran when that "
          f"wait returned: {running}", flush=True)

    # the host syncs of each half, on each split run's runtime
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(8, 64, 32, 32, 3).astype(np.float32),
             "target": rng.randint(0, 10, (8, 64))}
    ids, mask = np.arange(8), np.ones((8, 64), bool)
    decode_syncs, cohort_syncs = {}, {}
    for form, rt in runtimes.items():
        state = rt.init_state()
        got = {}
        cohort_syncs[form] = host_syncs(lambda: got.update(
            zip(("state", "pay"), rt.cohort(state, ids, batch, mask, 0.1))))
        decode_syncs[form] = host_syncs(lambda: rt.decode(
            got["state"], got["pay"]["sum"], got["pay"]["n_total"], 0.1))
        del state, got
    print(f"[overlap] host syncs in the decode half: {decode_syncs}; in "
          f"the client half: {cohort_syncs}", flush=True)
    if any(decode_syncs.values()):
        fail(f"the decode half reads back to the host: {decode_syncs}")
    del rt, runtimes, runs, mono, split

    gpt2 = {arm: [] for arm in GPT2_OVERLAP_ARMS}
    for arm in GPT2_OVERLAP_ARMS + GPT2_OVERLAP_ARMS[::-1]:
        K.reset_launches()
        res = bench_gpt2.run(n_rounds=GPT2_OVERLAP_ROUNDS,
                             **gpt2_mfu_sweep.ARMS[arm])
        launches_by[f"bench_gpt2 sweep arm {arm}"] = dict(K.launches)
        ms = 1e3 * res["tokens_per_round"] / res["value"]
        gpt2[arm].append((ms, res["memory_ledger_decode"]))
        torch.cuda.empty_cache()
    smi = smi_line()
    print(f"[overlap] A/B on {smi}, interleaved: ResNet-9 median round "
          f"(rounds 2-{ROUNDS_SPLIT}, ms) monolithic "
          f"{[round(x, 3) for x in medians['monolithic']]}, split "
          f"{[round(x, 3) for x in medians['split']]}; GPT-2 bench round "
          f"({GPT2_OVERLAP_ROUNDS} timed, ms) "
          + ", ".join(f"{a} {[round(ms, 3) for ms, _ in v]}"
                      for a, v in gpt2.items())
          + "; the decode half's peak above resident (GiB): "
          + ", ".join(f"{a} {v[0][1]['temp_bytes'] / 2**30:.3f}"
                      for a, v in gpt2.items() if v[0][1]), flush=True)
    return launches_by, {"resnet9": medians, "gpt2": gpt2,
                         "decode_running": running,
                         "decode_syncs": decode_syncs,
                         "cohort_syncs": cohort_syncs}


def phase_mesh1():
    """A clients mesh of one rank over NCCL (``--mesh_shape 1``: the group
    set up as a lone process sets it, torn down in a ``finally``) at the
    ResNet-9 headline round, 8 x 64 seeded images, MESH1_ROUNDS rounds
    (cuDNN deterministic): the replicated tail, the sharded tail and the
    sharded tail with the reduce in the decode (``--decode_overlap``),
    the sharded forms bitwise the replicated one, each against the
    no-mesh round at the JAX mesh test's tolerance; 9 K1 and 1 cell sum a
    round, K2's whole decode once a replicated round and its range form
    once a sharded one. Returns {path: launches}."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.pipeline import DecodeOverlapRound
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.resnet9 import ResNet9
    from commefficient_torch.checkpoint import (load_meta,
                                                restore_own_shards,
                                                save_sharded)
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.parallel.mesh import init_distributed, make_mesh
    from commefficient_torch.telemetry.collectives import (
        past_bounds, recording, summarize_ledger, table_reduce_wire_bytes)

    rng = np.random.RandomState(3)
    rounds = [{"image": rng.randn(8, 64, 32, 32, 3).astype(np.float32),
               "target": rng.randint(0, 10, (8, 64))}
              for _ in range(MESH1_ROUNDS)]
    ids, mask = np.arange(8), np.ones((8, 64), bool)
    base_kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
                   virtual_momentum=0.9, k=50_000, num_rows=5,
                   num_cols=500_000, num_workers=8, local_batch_size=64,
                   num_clients=100, telemetry=False)
    arms, ledgers = {}, {}
    device = init_distributed("cuda")
    try:
        mesh = make_mesh((1,), ("clients",))
        if dist.get_backend() != "nccl" or mesh.size != 1:
            fail(f"mesh of {mesh.size} over {dist.get_backend()}")
        with deterministic_cudnn():
            for arm, kw, m in (
                    ("no mesh", {}, None),
                    ("replicated tail", {"sketch_sharded_server": "off"},
                     mesh),
                    ("sharded tail", {"sketch_sharded_server": "on"}, mesh),
                    ("sharded tail, reduce in the decode",
                     {"sketch_sharded_server": "on",
                      "decode_overlap": True}, mesh),
                    ("int8 sharded tail", {"sketch_sharded_server": "on",
                                           "wire_dtype": "int8"}, mesh),
                    ("int8 sharded tail, reduce in the decode",
                     {"sketch_sharded_server": "on", "wire_dtype": "int8",
                      "decode_overlap": True}, mesh)):
                model = ResNet9(num_classes=10,
                                generator=torch.Generator().manual_seed(0))
                rt = FedRuntime(FedConfig(**base_kw, **kw), model,
                                make_cv_loss(model), device=device, mesh=m)
                obj = DecodeOverlapRound(rt) if rt.cfg.decode_overlap else rt
                st = obj.init_state()
                torch.cuda.synchronize()
                K.reset_launches()
                losses, times = [], []
                for i, b in enumerate(rounds):
                    t0 = time.perf_counter()
                    with recording() as entries:
                        st, met = obj.round(st, ids, b, mask, 0.1)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    losses.append(met["results"][0])
                    if i == 0 and m is not None:
                        ledgers[arm] = entries
                launches = dict(K.launches)
                ranged = K.range_launches["circ_decode"]
                if rt.cfg.decode_overlap:
                    # the sharded tail's decode half: no host sync
                    got = dict(zip(("state", "pay"), rt.cohort(
                        st, ids, rounds[0], mask, 0.1)))
                    syncs = host_syncs(lambda: rt.decode(
                        got["state"], got["pay"]["sum"],
                        got["pay"]["n_total"], 0.1))
                    print(f"[mesh1] {arm}: host syncs in the decode half: "
                          f"{syncs or 'none'}", flush=True)
                    if syncs:
                        fail(f"mesh1 {arm}: the decode half reads back to "
                             f"the host: {syncs}")
                    del got
                if arm == "int8 sharded tail":
                    # --checkpoint_sharded: this rank's shards written and
                    # read back, and a round more from each, bitwise
                    path = os.path.join(DATA_ROOT["path"], "mesh1_int8")
                    save_sharded(path, st, rt, {"epoch": 0})
                    back = restore_own_shards(path, rt,
                                              load_meta(path)["digests"])
                    resumed = [f for f in ("ps_weights", "Vvelocity",
                                           "Verror", "nan_round")
                               if not same_bits(getattr(back, f),
                                                getattr(st, f))]
                    if resumed or back.step != st.step:
                        fail(f"mesh1: the sharded checkpoint's {resumed} "
                             "did not read back bitwise")
                    st_a, _ = rt.round(st, ids, rounds[0], mask, 0.1)
                    st_b, _ = rt.round(back, ids, rounds[0], mask, 0.1)
                    if not same_bits(st_a.ps_weights, st_b.ps_weights):
                        fail("mesh1: the round after the sharded "
                             "checkpoint's restore is not bitwise")
                    print(f"[mesh1] --checkpoint_sharded at the headline: "
                          f"{os.path.getsize(path + '.npz') / 2**20:.1f} "
                          "MiB, read back bitwise, the next round bitwise",
                          flush=True)
                    del st_a, st_b, back
                    K.reset_launches()
                arms[arm] = (rt.flat_weights(st).clone(),
                             torch.stack(losses), launches, ranged,
                             statistics.median(times[1:]) * 1e3)
                if m is not None and (rt.sharded_server
                                      != ("sharded" in arm)):
                    fail(f"mesh1 {arm}: sharded server "
                         f"{rt.sharded_server}")
                del rt, obj, st, model
    finally:
        dist.destroy_process_group()
    ref_w, ref_l = arms["replicated tail"][:2]
    for arm in ("sharded tail", "sharded tail, reduce in the decode"):
        w, lo = arms[arm][:2]
        if not (same_bits(w, ref_w) and same_bits(lo, ref_l)):
            fail(f"mesh1: the {arm} is not bitwise the replicated tail")
    w8, l8 = arms["int8 sharded tail"][:2]
    w8s, l8s = arms["int8 sharded tail, reduce in the decode"][:2]
    if not (same_bits(w8, w8s) and same_bits(l8, l8s)):
        fail("mesh1: the int8 split round is not bitwise the monolithic")
    if not torch.isfinite(l8).all():
        fail(f"mesh1: the int8 round's losses {l8}")
    # the first round's collectives: within the JAX launch bounds, and no
    # table-reduce wire bytes on one rank (the wire model)
    for arm, entries in ledgers.items():
        over = past_bounds(entries)
        wire = table_reduce_wire_bytes(entries, 1)
        counts = summarize_ledger(entries)["counts"]
        print(f"[mesh1] {arm}: the round's collectives {counts}, "
              f"table_reduce_bytes {wire}", flush=True)
        if over or wire != 0.0 or not entries:
            fail(f"mesh1 {arm}: collectives {counts} (past bounds {over}),"
                 f" table_reduce_bytes {wire}")
        if "int8" in arm and counts.get("all-to-all", 0) < 2:
            fail(f"mesh1 {arm}: no int8 all_to_all reduce: {counts}")
    w0, l0 = arms["no mesh"][:2]
    dw = float((ref_w - w0).abs().max())
    exact = same_bits(ref_w, w0) and same_bits(ref_l, l0)
    if not torch.allclose(ref_w, w0, rtol=MESH1_RTOL, atol=MESH1_ATOL) or \
            not torch.allclose(ref_l, l0, rtol=1e-5):
        fail(f"mesh1: the mesh round departs from the no-mesh round "
             f"(max|dw| {dw})")
    out = {}
    for arm, (_, _, launches, ranged, ms) in arms.items():
        sharded = "sharded" in arm
        want = sketch_launches(MESH1_ROUNDS)
        if launches != want or ranged != (MESH1_ROUNDS if sharded else 0):
            fail(f"mesh1 {arm}: launches {launches}, range form {ranged}")
        out[f"mesh1 {arm}"] = {"circ_encode": launches["circ_encode"],
                               "circ_decode": launches["circ_decode"]
                               - ranged, "circ_decode_range": ranged,
                               "cell_sum": launches["cell_sum"]}
    print(f"[mesh1] 1-rank NCCL mesh, {MESH1_ROUNDS} headline rounds: the "
          f"sharded tail and the reduce in the decode bitwise the "
          f"replicated tail; the int8 wire's split round bitwise its "
          f"monolithic one; against the no-mesh round bitwise {exact} "
          f"(max|dw| {dw:.3e}); K2's range form once a sharded round; "
          "round medians (ms): "
          + ", ".join(f"{a} {v[4]:.3f}" for a, v in arms.items()),
          flush=True)
    return out


def phase_ring():
    """Ring attention in its single-process form (all shards on the card,
    the ring a rotating list: ``parallel/ring.py ring_attention_shards``)
    at GPT-2 small's width, RING_SHAPES: its output and dq, dk, dv from
    the seeded bf16 q, k, v of ``flash_inputs`` held against plain float32
    dense causal attention (autograd) and against K3, each row within
    RING_ROW_RTOL of its own norm; the ring's forward and forward+backward
    timed beside K3's and SDPA's at the same shape. Returns
    {shape: times}."""
    import torch
    import torch.nn.functional as F
    from commefficient_torch.models.gpt2 import dense_causal_attention
    from commefficient_torch.ops import flash_attention as FA
    from commefficient_torch.parallel.ring import ring_attention_shards

    out = {}
    H, D = 12, 64
    for N, S, n in RING_SHAPES:
        q, k, v, do = flash_inputs(N, S, H, D)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

        def ring(qq, kk, vv):
            return torch.cat(ring_attention_shards(
                list(qq.chunk(n, 1)), list(kk.chunk(n, 1)),
                list(vv.chunk(n, 1))), 1)

        o = ring(*leaves)
        dq, dk, dv = torch.autograd.grad(o, leaves, do)
        ref_in = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        o_ref = dense_causal_attention(*ref_in)
        refs = dict(zip(("dq", "dk", "dv"),
                        torch.autograd.grad(o_ref, ref_in, do.float())))
        refs["o"] = o_ref.detach()
        del o_ref, ref_in
        o3, lse = FA.forward(q, k, v)
        dq3, delta = FA.backward_dq(q, k, v, o3, lse, do)
        dk3, dv3 = FA.backward_dkv(q, k, v, do, lse, delta)
        k3 = {"o": o3, "dq": dq3, "dk": dk3, "dv": dv3}
        got = {"o": o.detach(), "dq": dq, "dk": dk, "dv": dv}
        errs = {name: (float(row_errors(t, refs[name]).max()),
                       float((t.float() - k3[name].float()).abs().max()
                             / refs[name].abs().max()))
                for name, t in got.items()}
        print(f"[ring] (N, S, H, D) = {(N, S, H, D)} over {n} shards: worst "
              "row error against dense float32 / largest difference from "
              "K3 over the largest dense value: "
              + ", ".join(f"{name} {a:.3e} / {b:.3e}"
                          for name, (a, b) in errs.items())
              + f" (limits {RING_ROW_RTOL} / {RING_K3_RTOL})", flush=True)
        bad = {name: e for name, e in errs.items()
               if not (math.isfinite(e[0]) and e[0] <= RING_ROW_RTOL
                       and math.isfinite(e[1]) and e[1] <= RING_K3_RTOL)}
        if bad:
            fail(f"ring attention disagrees at {(N, S, n)}: {bad}")
        del refs, k3, o, dq, dk, dv, o3, dq3, dk3, dv3, delta
        torch.cuda.empty_cache()
        # fwd and fwd+bwd: the ring, K3 and SDPA at the same shape
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        qk = [t.detach().requires_grad_(True) for t in (q, k, v)]
        times = {
            "ring_fwd": time_ms(lambda: ring(q, k, v), n=3, warmup=1),
            "ring_fwd_bwd": time_ms(lambda: torch.autograd.grad(
                ring(*leaves), leaves, do), n=3, warmup=1),
            "k3_fwd": time_ms(lambda: FA.forward(q, k, v)),
            "k3_fwd_bwd": time_ms(lambda: torch.autograd.grad(
                FA.flash_attention(*qk), qk, do)),
            "sdpa_fwd": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True).detach()),
            "sdpa_fwd_bwd": time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                (qt, kt, vt), do.transpose(1, 2)))}
        print(f"[ring] {(N, S, H, D)} over {n} shards (ms): "
              + ", ".join(f"{a} {t:.4f}" for a, t in times.items()),
              flush=True)
        out[f"{N}x{S}x{H}x{D}/{n}"] = times
        del q, k, v, do, leaves, qt, kt, vt, qk
        torch.cuda.empty_cache()
    return out


def phase_scaling():
    """``scaling_curves``'s n = 1 arms on the card (a 1-rank NCCL mesh,
    weak and strong, float32 and int8): one JSONL line an arm, read
    back; every arm's collectives within the JAX bounds and its
    table-reduce bytes 0 on one rank. Returns ``(launches, lines)``."""
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.scripts import scaling_curves

    out = os.path.join(DATA_ROOT["path"], "scaling.jsonl")
    K.reset_launches()
    rc = scaling_curves.main(["--device", "cuda", "--devices", "1",
                              "--rounds", str(SCALING_ROUNDS),
                              "--wire_dtype", "float32,int8",
                              "--out", out])
    launches = {**K.launches,
                "circ_decode_range": K.range_launches["circ_decode"]}
    launches["circ_decode"] -= launches["circ_decode_range"]
    lines = [json.loads(ln) for ln in open(out)]
    arms = [ln for ln in lines if ln["kind"] == "arm"]
    if rc != 0 or len(arms) != 3 or any(
            a["backend"] != "nccl-cuda" or a["table_reduce_bytes"] != 0.0
            for a in arms):
        fail(f"scaling_curves on the card: rc {rc}, {arms}")
    print("[scaling] n = 1 arms on the card: " + "; ".join(
        f"{a['scaling']} {a['wire_dtype']} {a['items_per_s']:.1f} img/s, "
        f"round {a['round_ms']:.3f} ms, collectives {a['collectives']}"
        for a in arms), flush=True)
    return launches, arms


def _mesh_entry(module, argv, tag):
    """An entry point on a 1-rank NCCL mesh (the group its setup joins
    as a lone process), its final weights gathered (``flat``) before the
    group is torn down."""
    import torch.distributed as dist
    try:
        out = entry_main(module, argv, tag)
        out["flat"] = out["runtime"].flat_weights(out["state"])
        return out
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_mesh_entry():
    """The flags this slice lifted on a mesh, through the entry points on
    a 1-rank NCCL mesh: ``cv_train`` at the headline with ``--mesh_shape 1
    --wire_dtype int8 --checkpoint_sharded --checkpoint_every 1
    --alert_action abort`` (one epoch, then ``--resume`` to the second,
    bitwise the straight two-epoch run; 9 K1, K2's range form and 1 cell
    sum a round), and ``gpt2_train --test --mesh_axes clients,seq --mesh_shape
    1,1`` (a seq axis of one rank is none). Returns the launches."""
    import numpy as np
    from commefficient_torch import cv_train, gpt2_train
    from commefficient_torch.ops import circulant_kernels as K

    ck = os.path.join(DATA_ROOT["path"], "mesh_entry_ck")
    base = MAIN_ARGV + dataset_flags("mesh_entry") + [
        "--mesh_shape", "1", "--wire_dtype", "int8", "--checkpoint_sharded",
        "--checkpoint_every", "1", "--alert_action", "abort",
        "--synthetic_per_class", "64"]
    runs = {}
    with deterministic_cudnn():
        K.reset_launches()
        runs["first"] = _mesh_entry(cv_train, base + [
            "--num_epochs", "1", "--checkpoint_path", ck], "mesh int8 e1")
        launches = {**K.launches,
                    "circ_decode_range": K.range_launches["circ_decode"]}
        rounds = runs["first"]["rounds"]
        runs["resumed"] = _mesh_entry(cv_train, base + [
            "--num_epochs", "2", "--resume", "--checkpoint_path", ck],
            "mesh int8 resumed")
        runs["straight"] = _mesh_entry(cv_train, base + [
            "--num_epochs", "2", "--checkpoint_path", ck + "_straight"],
            "mesh int8 straight")
    w = {k: v["flat"] for k, v in runs.items()}
    gens = sorted(f for f in os.listdir(os.path.join(ck, "ResNet9"))
                  if f.endswith(".npz"))
    with np.load(os.path.join(ck, "ResNet9", gens[0])) as z:
        sharded = "__sharded__" in z.files
    ok = (rounds > 0 and sharded and runs["first"]["runtime"].sharded_server
          and same_bits(w["resumed"], w["straight"])
          and launches["circ_encode"] == 9 * rounds
          and launches["circ_decode_range"] == rounds
          and launches["circ_decode"] == rounds
          and launches["cell_sum"] == rounds)
    print(f"[mesh entry] cv_train --mesh_shape 1 --wire_dtype int8 "
          f"--checkpoint_sharded --alert_action abort: {rounds} rounds an "
          f"epoch, launches {launches}, the sharded generation {gens[0]}, "
          f"the resumed second epoch bitwise the straight run: "
          f"{same_bits(w['resumed'], w['straight'])}", flush=True)
    if not ok:
        fail(f"mesh entry: rounds {rounds}, sharded {sharded}, launches "
             f"{launches}")
    g = _mesh_entry(gpt2_train, ["--test", "--error_type", "virtual",
                                 "--local_momentum", "0", "--num_rounds",
                                 "1", "--mesh_shape", "1,1", "--mesh_axes",
                                 "clients,seq"] + dataset_flags(
                                     "mesh_entry_persona"), "gpt2 seq 1,1")
    if g["rounds"] != 1 or not np.isfinite(g["losses"]).all():
        fail(f"gpt2_train on a (1, 1) clients,seq mesh: {g['losses']}")
    print(f"[mesh entry] gpt2_train --test --mesh_axes clients,seq "
          f"--mesh_shape 1,1: loss {g['losses']}", flush=True)
    return {"cv_train --mesh_shape 1 --wire_dtype int8 "
            "--checkpoint_sharded": {
                "circ_encode": launches["circ_encode"],
                "circ_decode": launches["circ_decode"]
                - launches["circ_decode_range"],
                "circ_decode_range": launches["circ_decode_range"],
                "cell_sum": launches["cell_sum"]}}


def start_multihost():
    """``multihost_dryrun`` on this machine's CPU, started in the
    background (two torchrun launchers of 4 gloo ranks against one of 8;
    no card): it runs beside the card's phases. ``finish_multihost``
    reads it."""
    return subprocess.Popen(
        [sys.executable, "-m", "commefficient_torch.scripts.multihost_dryrun"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True), time.perf_counter()


def stop_multihost(started) -> None:
    """End the dryrun and every launcher and rank it started."""
    import signal
    proc = started[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()


def finish_multihost(started) -> None:
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=MULTIHOST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        stop_multihost(started)
        fail(f"multihost_dryrun took over {MULTIHOST_TIMEOUT_S} s")
    line = [ln for ln in out.splitlines()
            if ln.startswith("multihost dryrun:")]
    if proc.returncode != 0 or not line or "PASS" not in line[0]:
        fail(f"multihost_dryrun failed (rc {proc.returncode}):\n"
             f"{out[-2000:]}\n{err[-2000:]}")
    print(f"[multihost] {line[0]} ({time.perf_counter() - t0:.1f} s on "
          "the CPU, beside the card's phases)", flush=True)


def phase_multihost():
    finish_multihost(start_multihost())


def run_slice18() -> tuple:
    """The ring at GPT-2 small's width, the scaling curves' n = 1 arms and
    the lifted flags through the entry points (phase_mesh1 holds the int8
    wire, the sharded checkpoint and the ledger on the 1-rank mesh; the
    multi-host dryrun runs beside the K1/K2 phases)."""
    ring = phase_ring()
    time_done("ring attention")
    scaling_launches, scaling = phase_scaling()
    time_done("the scaling curves' n = 1 arms")
    entry_launches = phase_mesh_entry()
    time_done("the lifted flags through the entry points on the mesh")
    return ring, {"scaling_curves n = 1 arms": scaling_launches,
                  **entry_launches}, scaling


def run_slice19() -> tuple:
    """K3's float32 and D = 16, 32, 128 routes against their plain
    versions and through the port's GPT-2 paths (the cell sum is in
    phase_sparse_encode, the decode half's host syncs in
    phase_decode_overlap and phase_mesh1)."""
    routes = phase_flash_routes()
    time_done("K3's float32 and D = 16, 32, 128 routes")
    route_paths, route_runs = phase_gpt2_routes()
    time_done("K3's new routes on the port's GPT-2 paths")
    return routes, route_paths, route_runs


def run_slice17() -> tuple:
    """K2's range form at m = 14 and m = 176, the split round and the
    1-rank mesh."""
    decode_range = {"m=14": phase_decode_range(FLAGSHIP),
                    "m=176": phase_decode_range(GPT2_SKETCH)}
    time_done("K2's range form")
    overlap_launches, overlap = phase_decode_overlap()
    time_done("the split round (--decode_overlap)")
    mesh_launches = phase_mesh1()
    time_done("the 1-rank NCCL mesh")
    return decode_range, overlap_launches, overlap, mesh_launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs only on the card")
    try:
        import commefficient_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable here ({e}): run from the root "
             "of the repository")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = T0["t"] = time.perf_counter()
    DATA_ROOT["path"] = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        if sys.argv[1:2] == ["--telemetry"]:
            # the telemetry phase alone, after the build (no result line)
            phase_build()
            phase_telemetry()
            print(f"[time] telemetry done at {time.perf_counter() - t0:.1f}"
                  " s (partial run: no result line)", flush=True)
            return 0
        if sys.argv[1:2] == ["--bench"]:
            # the benchmark entry points alone, after the build and the
            # kernel checks at their new shapes (no result line)
            phase_build()
            phase_kernels(GPT2_BENCH_SKETCH, (GPT2_BENCH_SKETCH["c"],),
                          scale=8.0, plain_n=5)
            phase_flash(FLASH_SHAPES[2:])
            phase_bench()
            print(f"[time] bench done at {time.perf_counter() - t0:.1f} s "
                  "(partial run: no result line)", flush=True)
            return 0
        if sys.argv[1:2] == ["--crash"]:
            # the whole crash matrix, children on the card (no result line)
            from commefficient_torch.scripts import crash_matrix
            phase_build()
            phase_crash([m[0] for m in crash_matrix.MATRIX])
            time_done("crash matrix (partial run: no result line)")
            return 0
        if sys.argv[1:2] == ["--curves"]:
            # the learning-curve study (no result line): the EF study's
            # arms (or the comma-separated arms of the next argument;
            # "all" for every arm) at every seed (or those of the one
            # after), records under the directory after them (default
            # CURVES_OUT)
            from commefficient_torch.scripts import curves
            arg = sys.argv[2] if len(sys.argv) > 2 else "ef"
            arms = {"ef": list(curves.EF_ARMS),
                    "all": list(curves.ARMS)}.get(arg, arg.split(","))
            seeds = ([int(x) for x in sys.argv[3].split(",")]
                     if len(sys.argv) > 3 else list(curves.SEEDS))
            phase_build()
            run_curve_study(arms, seeds,
                            sys.argv[4] if len(sys.argv) > 4 else CURVES_OUT)
            time_done("curves (partial run: no result line)")
            return 0
        if sys.argv[1:2] == ["--mesh"]:
            # K2's range form, the split round, the 1-rank mesh (the int8
            # wire, the sharded checkpoint, the ledger), the scaling
            # curves' n = 1 arms and the multi-host dryrun alone, after
            # the build (no result line)
            phase_build()
            run_slice17()
            phase_scaling()
            phase_mesh_entry()
            phase_multihost()
            time_done("mesh (partial run: no result line)")
            return 0
        if sys.argv[1:2] == ["--slice19"]:
            # the cell sum, K3's new routes and the split round's decode
            # half alone, after the build (no result line)
            phase_build()
            phase_sparse_encode()
            run_slice19()
            phase_decode_overlap()
            phase_mesh1()
            time_done("slice 19 (partial run: no result line)")
            return 0
        if sys.argv[1:2] == ["--slice21"]:
            # K3's kernels but the D = 64 main path's: the build, the SASS
            # of every kernel of both libraries, every route with a tiled
            # kernel against its plain version and SDPA with the planted
            # faults, and the routes' GPT-2 paths (no result line)
            phase_build()
            phase_sass()
            phase_tiled_sass()
            run_slice19()
            time_done("slice 21 (partial run: no result line)")
            return 0
        if sys.argv[1:2] == ["--ring"]:
            # ring attention alone, after the build (no result line)
            phase_build()
            phase_ring()
            time_done("ring (partial run: no result line)")
            return 0
        if sys.argv[1:2] == ["--services"]:
            # the runtime services' phases alone, after the build: a quick
            # check of this slice, with no kernel line and no result line
            phase_build()
            run_services()
            print(f"[time] services done at {time.perf_counter() - t0:.1f}"
                  " s (partial run: no result line)", flush=True)
            return 0
        return run_phases(t0)
    finally:
        shutil.rmtree(DATA_ROOT["path"], ignore_errors=True)


def run_phases(t0: float) -> int:
    import torch
    from commefficient_torch.ops import flash_attention as FA

    def done(phase: str) -> None:
        print(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    phase_build()
    resources = phase_sass()
    resources.update(phase_tiled_sass())
    sketch_sass = phase_sketch_sass()
    done("build")
    # the multi-host dryrun, CPU only, beside the card's K1/K2 phases: they
    # time their kernels and plain versions in device time (time_ms), so
    # the host the dryrun loads does not enter their numbers
    multihost = start_multihost()
    try:
        # scale: a client's datum count, as the fused step passes it
        circ = phase_kernels(FLAGSHIP, (FLAGSHIP["c"], 500_000), scale=64.0)
        circ_gpt2 = phase_kernels(GPT2_SKETCH, (GPT2_SKETCH["c"],),
                                  scale=4.0, plain_n=5)
        circ_femnist = phase_kernels(FEMNIST_SKETCH, (FEMNIST_SKETCH["c"],),
                                     scale=16.0, plain_n=5)
        circ_imagenet = phase_kernels(IMAGENET_SKETCH,
                                      (IMAGENET_SKETCH["c"],), scale=64.0,
                                      plain_n=5)
        circ_stream = phase_kernels(STREAM_SKETCH, (STREAM_SKETCH["c"],),
                                    scale=32.0, plain_n=5)
        # the GPT-2 bench's full vocabulary: m = 238, 8 dialogues a client
        circ_gpt2_bench = phase_kernels(GPT2_BENCH_SKETCH,
                                        (GPT2_BENCH_SKETCH["c"],), scale=8.0,
                                        plain_n=5)
        circ_rows = phase_kernels_rows()
        k1_range = {"gpt2": phase_kernels_range(GPT2_SKETCH, scale=4.0),
                    "stream": phase_kernels_range(STREAM_SKETCH,
                                                  scale=32.0)}
    except BaseException:
        stop_multihost(multihost)
        raise
    SKETCH_VECTORS.clear()
    done("K1/K2, K1's range form")
    finish_multihost(multihost)
    done("the multi-host dryrun")
    decode_range, overlap_launches, overlap, mesh_launches = run_slice17()
    ring, scaling_launches, scaling = run_slice18()
    flash = phase_flash()
    done("K3")
    routes, route_paths, route_runs = run_slice19()
    phase_small_reference()
    phase_gpt2_reference()
    zoo = phase_zoo_reference()
    done("card-vs-CPU rounds")
    topk_ms = phase_topk()
    accounting = phase_accounting()
    sparse = phase_sparse_encode()
    done("top-k, byte accounting, sparse re-encode")
    cv_launches, cv_ms = phase_main_path()
    cv_off, cv_off_ms = phase_main_path(["--no_track_bytes"])
    done("ResNet-9 main path")
    wire = phase_wire()
    done("the ResNet-9 main path on the bf16 and int8 wires")
    modes = phase_modes()
    nan_launches = phase_nan_abort()
    done("modes and the NaN abort")
    hash_rht = phase_hash_rht()
    noise = phase_noise()
    rules = phase_modes(RULE_CONFIGS, tag="rules")
    done("hash, SRHT, DP noise and the clip/DP/topk-down/server-state paths")
    rht_arms, rht_scan_rel, rht_runs = phase_rht_scan()
    done("the SRHT's row scan and bf16 transform (ResNet-9, GPT-2)")
    real_launches, resumed_launches = phase_real_data_resume()
    done("real-format CIFAR10, checkpoint and resume")
    gpt2_rounds, gpt2_val, gpt2_ms, _ = phase_gpt2_main()
    gpt2_off, gpt2_off_val, gpt2_off_ms, _ = phase_gpt2_main(
        ["--no_track_bytes"])
    gpt2_ckpt = phase_gpt2_checkpoint()
    done("GPT-2 main path, its state saved and loaded")
    gpt2_arms = {arm: phase_gpt2_main(flags, GPT2_ARM_ROUNDS, encodes,
                                      cells=cells)
                 for arm, (flags, encodes, cells) in GPT2_ARMS.items()}
    gpt2_int8 = phase_gpt2_main(["--wire_dtype", "int8"], GPT2_ARM_ROUNDS,
                                want_up=GPT2_INT8_BYTES)
    print(f"[gpt2] --wire_dtype int8: {GPT2_INT8_BYTES} bytes a client a "
          f"round (float32: {4 * 5 * GPT2_SKETCH['c']}), median "
          f"{gpt2_int8[2]:.3f} ms", flush=True)
    gpt2_rows = phase_gpt2_rows()
    done("GPT-2 study arms, the int8 wire")
    levers = phase_gpt2_levers()
    pretrained = phase_gpt2_pretrained()
    done("GPT-2 memory levers and the pretrained round trip")
    gpt2_runs = {**{f"{a} (GPT2_ARMS)": v[:2] for a, v in gpt2_arms.items()},
                 **{f"--num_rows {r}": v[:2] for r, v in gpt2_rows.items()},
                 **{f"levers {a}": v[:2] for a, v in levers.items()},
                 **{k: pretrained[k][:2] for k in ("pretrained", "cached")}}
    femnist_launches, femnist_ms = phase_femnist()
    fixup_launches, fixup_ms, fixup_share = phase_fixup()
    done("FEMNIST ResNet101LN and FixupResNet50 paths")
    phase_pipeline_ab()
    done("the round pipeline on the store paths")
    imagenet_launches, imagenet_ms, imagenet_idle = phase_imagenet()
    imagenet_host = phase_imagenet_host()
    native_ms = phase_native()
    finetune_ms = phase_finetune()
    compat_launches = phase_compat()
    done("ImageNet recipe and its host path, native gather, finetune, "
         "compat")
    stream = phase_stream()
    done("the streaming encode (StreamMLP)")
    services = run_services()
    done("the runtime services (robust, async, preempt)")
    phase_telemetry()
    done("the run telemetry")
    bench_launches = phase_bench()
    done("the benchmark entry points")
    crash_launches = phase_crash()
    done("the crash matrix's mid_round and async_pool rows")
    curve_recs = phase_curves()
    print("[curves] the EF arms of the smoke added "
          + ", ".join(f"{a} {curve_recs[(a, 21)]['wall_s']:.1f} s"
                      for a in CURVE_EF_SMOKE_ARMS), flush=True)
    done("one epoch of each CIFAR10 curve arm, of the GPT-2 sketch arm "
         "and its two clip placements, and of the EF study's r = 9 and "
         "subtract arms")
    print("[slice 12] round medians (ms): ResNet-9 wires "
          + ", ".join(f"{a} {ms:.3f} ({b} B a client)"
                      for a, (_, ms, b) in wire.items())
          + f"; GPT-2 int8 {gpt2_int8[2]:.3f}; SRHT (ms / GiB peak) "
          + ", ".join(f"{a} {ms:.3f} / {p / 2**30:.3f}"
                      for a, (ms, p) in rht_arms.items())
          + f", ResNet-9 scan vs batched update {rht_scan_rel:.3e}; "
          "StreamMLP "
          + ", ".join(f"{a} {ms:.3f} (client-step peak {pk / 2**20:.1f} MiB)"
                      for a, (_, _, ms, pk) in stream.items())
          + "; K1 ranges (ms, bound): "
          + ", ".join(f"{shape} {k} {t['ms']:.4f} ({t['bound_ms']:.4f})"
                      for shape, kinds in k1_range.items()
                      for k, t in kinds.items()), flush=True)
    print("[slice 18] ring attention (ms): "
          + "; ".join(f"{shape} " + ", ".join(f"{a} {t:.4f}"
                                              for a, t in times.items())
                      for shape, times in ring.items())
          + "; scaling n = 1 on the card (img/s): "
          + ", ".join(f"{a['scaling']} {a['wire_dtype']} "
                      f"{a['items_per_s']:.1f}" for a in scaling),
          flush=True)
    print("[slice 17] K2's range form (ms, bound): "
          + ", ".join(f"{m} {n} shards {t['ms']:.4f} ({t['bound_ms']:.4f})"
                      for m, shards in decode_range.items()
                      for n, t in shards.items())
          + "; split round A/B (ms) ResNet-9 "
          + ", ".join(f"{a} {[round(x, 3) for x in v]}"
                      for a, v in overlap["resnet9"].items())
          + ", GPT-2 "
          + ", ".join(f"{a} {[round(ms, 3) for ms, _ in v]}"
                      for a, v in overlap["gpt2"].items())
          + f"; decode-half host syncs {overlap['decode_syncs']}; share of "
          f"split rounds whose decode still ran when wait_cohort returned "
          f"{overlap['decode_running']}",
          flush=True)
    print(f"[imagenet] this slice's paths, round medians (ms): ImageNet "
          f"FixupResNet50 "
          + ", ".join(f"{m} {ms:.3f}" for m, ms in imagenet_ms.items())
          + f" (sketch round's device idle share {imagenet_idle:.3f}); the "
          "host path's fetch / wait / round: "
          + ", ".join(f"{w} {a:.3f} / {b:.3f} / {c:.3f}"
                      for w, (a, b, c) in imagenet_host.items())
          + f"; the native CIFAR gather {native_ms[0]:.3f} ms against "
          f"numpy's {native_ms[1]:.3f} ms; finetune round {finetune_ms:.3f}",
          flush=True)
    print(f"[zoo] this slice's paths, round medians (ms): FEMNIST "
          f"ResNet101LN sketch {femnist_ms:.3f}, FixupResNet50 CIFAR100 "
          f"true_topk {fixup_ms:.3f} (0.1 rate on {fixup_share:.6f} of d); "
          "card vs CPU (rel dloss, dupdate, swaps): "
          + ", ".join(f"{n} {a:.2e}/{b:.2e}/{c}"
                      for n, (a, b, c) in zoo.items()), flush=True)
    print("[levers] GPT-2 round medians (ms) and peak memory (GiB), each "
          "arm beside the base arm of this call: "
          + ", ".join(f"{a} {ms:.3f} / {peak / 2**30:.3f}"
                      for a, (_, _, ms, peak, _) in levers.items())
          + "; pretrained round trip: rounds "
          f"{pretrained['pretrained'][2]:.3f} / "
          f"{pretrained['cached'][2]:.3f} ms, K3 vs dense "
          + ", ".join(f"{n} {e:.3e}" for n, e in pretrained["flash"].items()),
          flush=True)
    print(f"[bytes] what byte accounting costs a round (medians; bytes on "
          f"vs --no_track_bytes): ResNet-9 {cv_ms:.3f} vs "
          f"{cv_off_ms:.3f} ms, GPT-2 {gpt2_ms:.3f} vs {gpt2_off_ms:.3f} "
          f"ms; round medians by mode (ms): "
          + ", ".join(f"{m} {ms:.3f}" for m, (_, ms) in modes.items())
          + "; accounting's device time a round (count + record, ms): "
          + ", ".join(f"d={d} {kind}: {c:.4f} + {r:.4f}"
                      for (d, kind), (c, r) in accounting.items())
          + "; the cell sum (ms; plain loop, index_add_): "
          + ", ".join(f"{at} {t['ms']:.4f} ({t['plain_ms']:.4f}, "
                      f"{t['library_ms']:.4f})"
                      for at, t in (("d=6568640", sparse["cell_sum"]),
                                    ("d=92138496", sparse["cell_sum"][
                                        "at_gpt2_shape"])))
          + f"; GPT-2 state checkpoint: saved {gpt2_ckpt[0]:.3f} s, loaded "
          f"{gpt2_ckpt[1]:.3f} s, {gpt2_ckpt[2] / 2**20:.1f} MiB"
          + "; the slice's paths, round medians (ms): "
          + ", ".join(f"{m} {ms:.3f}" for m, (_, ms) in rules.items())
          + ", GPT-2 "
          + ", ".join(f"{a} {ms:.3f}"
                      for a, (_, _, ms, _) in gpt2_arms.items())
          + "; hash and SRHT (ms, plain PyTorch): "
          + ", ".join(f"{k} {t:.4f}" for k, t in hash_rht.items())
          + "; DP noise std: "
          + ", ".join(f"{m} {v:.6f}" for m, v in noise.items())
          + "; top-k (ms, kernel-free PyTorch): "
          + ", ".join(f"d={d}: {a:.4f} (torch.topk of the squares "
                      f"{b:.4f})" for d, (a, b) in topk_ms.items()),
          flush=True)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("JAX was imported: the port must run without it")

    pallas_file = reference_file("ops/circulant_pallas.py")
    gpt2_file = reference_file("models/gpt2.py")

    def sketch_paths(name: str) -> dict:
        """{path: launches of the sketch kernel ``name``} over every run
        of the main paths and the other paths that count it, each read
        from that run's own counts."""
        return {"cv_train": cv_launches[name],
                "cv_train --no_track_bytes": cv_off[name],
                **{f"cv_train --mode {m}": launches[name]
                   for m, (launches, _) in modes.items()},
                "cv_train planted NaN": nan_launches[name],
                "cv_train CIFAR10 pickles, device store":
                    real_launches[name],
                "cv_train --resume": resumed_launches[name],
                "gpt2_train": gpt2_rounds[name] + gpt2_val[name],
                "gpt2_train --no_track_bytes": (gpt2_off[name]
                                                + gpt2_off_val[name]),
                **{f"cv_train {m}": launches[name]
                   for m, (launches, _) in rules.items()},
                **{f"gpt2_train {a}": r[name] + v[name]
                   for a, (r, v) in gpt2_runs.items()},
                "cv_train EMNIST ResNet101LN": femnist_launches[name],
                "cv_train CIFAR100 FixupResNet50 true_topk":
                    fixup_launches[name],
                **{f"cv_train ImageNet FixupResNet50 {m}": launches[name]
                   for m, launches in imagenet_launches.items()},
                "compat FedModel ResNet9 sketch": compat_launches[name],
                **{f"cv_train wire {a}": launches[name]
                   for a, (launches, _, _) in wire.items()},
                "gpt2_train --wire_dtype int8": (gpt2_int8[0][name]
                                                 + gpt2_int8[1][name]),
                **{f"FedRuntime StreamMLP {a}": launches[name]
                   for a, (launches, _, _, _) in stream.items()},
                **{f"cv_train services {a}": launches[name]
                   for a, launches in services.items()},
                **{path: launches[name]
                   for path, launches in bench_launches.items()},
                **{path: launches[name]
                   for path, launches in crash_launches.items()},
                **{f"curves {arm} seed {seed} (1 epoch)":
                   rec["launches"][name]
                   for (arm, seed), rec in curve_recs.items()},
                **{path: launches[name]
                   for path, launches in overlap_launches.items()},
                **{path: launches[name]
                   for path, launches in mesh_launches.items()},
                **{path: launches[name]
                   for path, launches in scaling_launches.items()},
                **{path: launches[name]
                   for path, launches in route_paths.items()
                   if name in launches}}

    kernels = []
    for name, line in (("circ_encode", 144), ("circ_decode", 175)):
        by_path = sketch_paths(name)
        extra = {}
        if name == "circ_encode":
            extra = {"range_launches": stream["streaming_grad"][1],
                     "range_form": k1_range}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "commefficient_torch/csrc/circulant.cu",
            "replaces": f"{pallas_file}:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **circ[name], "at_gpt2_shape": circ_gpt2[name],
            "at_femnist_shape": circ_femnist[name],
            "at_imagenet_shape": circ_imagenet[name],
            "at_stream_shape": circ_stream[name],
            "at_gpt2_bench_shape": circ_gpt2_bench[name],
            **{f"at_{shape}": t[name] for shape, t in circ_rows.items()},
            "sass_per_term": sketch_sass[name], **extra})
    # K2's range form: the sharded server tail's decode of a rank's
    # coordinates (the headline's m = 14 shard of 4; m = 176 beside it)
    by_path = {path: launches["circ_decode_range"]
               for path, launches in mesh_launches.items()}
    by_path.update({path: launches["circ_decode_range"]
                    for path, launches in scaling_launches.items()})
    kernels.append({
        "name": "circ_decode_range", "route": "cuda",
        "source": "commefficient_torch/csrc/circulant.cu",
        "replaces": f"{pallas_file}:175",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **decode_range["m=14"][4],
        "shards": decode_range})
    for name, line in (("flash_fwd", 589), ("flash_bwd_dq", 1287),
                       ("flash_bwd_dkv", 941)):
        by_path = {"gpt2_train rounds": gpt2_rounds[name],
                   "gpt2_train validation": gpt2_val[name],
                   "gpt2_train --no_track_bytes rounds": gpt2_off[name],
                   "gpt2_train --no_track_bytes validation":
                       gpt2_off_val[name],
                   **{f"gpt2_train {a}": r[name] + v[name]
                      for a, (r, v) in gpt2_runs.items()},
                   "gpt2_train --wire_dtype int8": (gpt2_int8[0][name]
                                                    + gpt2_int8[1][name]),
                   **{f"gpt2_train {a}": r[name] + v[name]
                      for a, (r, v) in rht_runs.items()},
                   **{path: launches[name]
                      for path, launches in bench_launches.items()}}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "commefficient_torch/csrc/flash_attention.cu",
            "replaces": f"{gpt2_file}:106 -> {LIBRARY_FLASH}:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **flash[name], "resources": resources[name]})
    source_of = {n: r.source_of(n) for r in FA.ROUTES.values()
                 for n in r.names}
    for name, entry in routes.items():
        by_path = {path: launches[name]
                   for path, launches in route_paths.items()
                   if launches.get(name)}
        line = {"fwd": 589, "bwd_dq": 1287, "bwd_dkv": 941}[
            name.split("_", 1)[1].rsplit("_", 2)[0]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"commefficient_torch/csrc/{source_of[name]}",
            "replaces": f"{gpt2_file}:106 -> {LIBRARY_FLASH}:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **entry, **({"resources": resources[name]}
                        if name in resources else {})})
    # the sparse re-encode's ordered cell sum: no Pallas kernel computes
    # it in the JAX package (XLA's segment_sum there)
    by_path = sketch_paths("cell_sum")
    kernels.append({
        "name": "cell_sum", "route": "cuda",
        "source": "commefficient_torch/csrc/cellsum.cu",
        "replaces": "none (XLA's jax.ops.segment_sum, "
                    f"{reference_file('ops/circulant.py')}:296)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **sparse["cell_sum"]})
    if any(not k["launches"] for k in kernels):
        fail("kernels no path launched: "
             + ", ".join(k["name"] for k in kernels if not k["launches"]))
    print("[slice 19] K3's new routes (ms at S = 1024; bound, SDPA): "
          + ", ".join(f"{n} {e['ms']:.4f} ({e['bound_ms']:.4f}, "
                      f"{e['library_ms']:.4f})" for n, e in routes.items())
          + "; the routes' GPT-2 paths (ms, peak GiB): "
          + ", ".join(f"{p} {ms:.3f} / {peak / 2**30:.3f}"
                      for p, (ms, peak) in route_runs.items()), flush=True)
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   -sass``): all three K3 kernels must hold both; count by pipe the
   instructions K1 and K2 issue per (row, coordinate) term at r = 5, in
   the SASS block that holds the most sign hashes, beside what a term
   needs (SIGN_HASH, K1's index step, K2's share of its median network
   MEDIAN_NETS); K2 must call no subroutine and issue fewer than
   K2_BUBBLE_SASS_PER_TERM a term;
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
   and bias-sized (2,048) ranges timed beside their bounds;
3. hold K3 (causal flash attention: forward, dq, dk/dv) against its plain
   versions at (N, H, S, D) = (8, 12, 1024, 64) and (8, 12, 256, 64), q,
   k, v the slices of one c_attn-shaped buffer, each output row against
   its own norm (FLASH_ROW_RTOL), and show that this check rejects a
   planted fault in each kernel (one tile of its walk skipped), and that
   two calls of each kernel give bitwise-equal outputs, and that the
   autograd function's backward (on autograd's own thread, the process's
   first backward) gives the direct calls' bits; time
   the kernels, the plain versions and ``scaled_dot_product_attention``
   (forward, backward and both) beside each kernel's bound;
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
   round (16 + 1 for the table clip and ``--topk_down``, 1 + 1 for the
   dense clip, DP and the dense state, none for hash, rht and the
   uncompressed DP run) and the bytes held as in the modes; then the
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
   (``GPT2_ARMS``: the table clip ``--max_grad_norm 1``, 16 K1 a round,
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
   weights. ``python3 chip_smoke.py --services`` runs the build and these
   three phases alone (no result line);
14. print the ``{"kernels": [...]}`` line (K1's range launches and
   range timings in its entry), the card's name and power limit, and last
   the ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device it fails at once.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12         # FP32 outside the tensor cores
H100_BF16_PER_S = 989e12        # dense bf16 tensor cores
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
GPT2_ROUNDS = 4
# K1: 8 clients + the weight-decay encode; K3: 12 layers x 8 clients
GPT2_PER_ROUND = {"circ_encode": 9, "circ_decode": 1, "flash_fwd": 96,
                  "flash_bwd_dq": 96, "flash_bwd_dkv": 96}
GPT2_VAL_FWD = 12               # one validation batch of 8 items, 12 layers
# two arms of the JAX package's GPT-2 study (scripts/gpt2_ef_study.sh) at
# the main path's k, 3 rounds each: the table clip (each client streams
# its microbatch and its weight-decay term into its own table: 8 x 2 K1)
# and densestate_clip1 (dense clip, one deferred encode of the dense sum
# of the (d,) error pre-image: 1 K1)
GPT2_ARM_ROUNDS = 3
GPT2_ARMS = {
    "clip1": (["--max_grad_norm", "1"], 16),
    "densestate_clip1": (["--sketch_server_state", "dense",
                          "--sketch_dense_clip", "--max_grad_norm", "1"], 1),
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
FLASH_SHAPES = ((8, 1024, 12, 64), (8, 256, 12, 64))   # (N, S, H, D)
# a planted fault skips this many keys or queries: finer than the
# 128-wide tiles of every K3 kernel
FLASH_TILE = 64
# kernels built from wgmma fed by TMA: their SASS must hold both
HOPPER_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
HOPPER_SASS = ("HGMMA", "UTMALDG")
# K3 against its plain version, each (n, s, h) row of D held against its
# own size: |got - ref| <= 1.5e-2 |ref| (+ 1e-3 of the mean row norm, for
# rows near 0) for o, dq, dk and dv. The kernels round p and ds to bf16 as
# product operands and round their outputs to bf16: about 5e-3 at worst
# (an emulation of that rounding on the CPU; read on an H100: 4.6e-3 to
# 5.5e-3, and 1.0 to 1.6 with a planted fault). lse to 1e-4 absolute.
FLASH_ROW_RTOL = 1.5e-2
FLASH_LSE_ATOL = 1e-4
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


def phase_build():
    from commefficient_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
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
    for line in cuobjdump("-sass", K.SOURCE):
        if "Function :" in line:
            name = next((f"circ_{n}" for n in ("encode", "decode")
                         if f"{n}_kernelILi5E" in line), None)
            if name is not None:
                funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    needs = {"circ_encode": term_instructions(0),
             "circ_decode": decode_term_instructions(5)}
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
        out[name] = {"hashes_in_block": hashes, "calls": calls, **per}
    return out


def phase_sass():
    """Registers, shared memory and the wgmma/TMA instruction counts of each
    K3 kernel, read from the built library with the toolkit's cuobjdump.
    Fails if a kernel of HOPPER_KERNELS lacks HGMMA or UTMALDG."""
    from commefficient_torch.ops import flash_attention as FA

    def kernel_of(line):
        return next((name for name in FA.launches
                     if f"{name}_kernel" in line), None)

    out = {name: dict.fromkeys(HOPPER_SASS, 0) for name in FA.launches}
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
    lib_fa = FA._lib()
    dynamic = {"flash_fwd": lib_fa.flash_fwd_smem_bytes(),
               "flash_bwd_dq": lib_fa.flash_bwd_dq_smem_bytes(),
               "flash_bwd_dkv": lib_fa.flash_bwd_dkv_smem_bytes()}
    for name, use in out.items():
        use["dynamic_smem"] = dynamic[name]
        print(f"[sass] {name}: {use.get('registers')} registers at launch, "
              f"shared memory {use.get('static_smem')} B static + "
              f"{use['dynamic_smem']} B dynamic; SASS: "
              + ", ".join(f"{use[op]} {op}" for op in HOPPER_SASS),
              flush=True)
        if "registers" not in use:
            fail(f"cuobjdump -res-usage reported nothing for {name}")
    lacking = [f"{name} ({op})" for name in HOPPER_KERNELS
               for op in HOPPER_SASS if out[name][op] == 0]
    if lacking:
        fail(f"K3 kernels without wgmma/TMA in SASS: {lacking}")
    return out


def bound(nbytes: float, ops: float, peak: float, instr=None):
    """(least ms, what bounds it) on an H100 SXM: the largest of
    ``nbytes`` over 3.35 TB/s ("bytes"), ``ops`` over ``peak`` ("fp32
    operations" or "bf16 operations") and, given ``instr`` (instruction
    counts by pipe: "alu", "imad", "either" of the two, "other"), the
    ALU's and the IMAD pipe's own instructions over their lanes ("ALU
    issue", "IMAD issue") and all of them over the SM's issue rate
    ("instruction issue")."""
    times = {"bytes": nbytes / H100_BYTES_PER_S,
             ("fp32" if peak == H100_FP32_PER_S else "bf16")
             + " operations": ops / peak}
    if instr:
        per_lane = H100_SMS * H100_CLOCK_HZ
        times["ALU issue"] = instr["alu"] / (LANES["alu"] * per_lane)
        times["IMAD issue"] = instr["imad"] / (LANES["imad"] * per_lane)
        times["instruction issue"] = (sum(instr.values())
                                      / (LANES["issue"] * per_lane))
    kind = max(times, key=times.get)
    return 1e3 * times[kind], kind


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


def same_bits(a, b) -> bool:
    """Bitwise equality of two float32 tensors (int32 views: -0 differs
    from +0), NaN counted by position only: the card's float units return
    one canonical NaN, where a sign xor keeps a NaN's payload."""
    import torch
    nan = torch.tensor(float("nan"), device=a.device)
    a = torch.where(torch.isnan(a), nan, a)
    b = torch.where(torch.isnan(b), nan, b)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


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
    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.randn(d).astype(np.float32)).to(dev)
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
    print(f"[kernels] circ_encode (accumulate, m={m}): kernel {enc_ms:.4f} "
          f"ms, plain {enc_plain_ms:.4f} ms, bound "
          f"{bounds['circ_encode'][0]:.4f} ms")
    print(f"[kernels] circ_decode (m={m}): kernel {dec_ms:.4f} ms, plain "
          f"{dec_plain_ms:.4f} ms, bound {bounds['circ_decode'][0]:.4f} ms",
          flush=True)
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


def flash_inputs(N, S, H, D, seed=0):
    """q, k, v as the three (N, S, H, D) slices of one seeded (N, S, 3HD)
    bf16 buffer (the c_attn output's layout), and an output gradient."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(N, S, 3 * H * D).astype(
        np.float32)).to("cuda", torch.bfloat16)
    do = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    return q, k, v, do


def flash_bounds(N, S, H, D):
    """(bytes, FLOPs) each K3 kernel must move and do: every input read
    once, every output written once; 2 D FLOPs per causal (query, key)
    pair and product (forward: q k^T and p v; dq: q k^T, dO v^T, ds k;
    dk/dv: k q^T, p^T dO, v dO^T, ds^T q)."""
    pairs = N * H * S * (S + 1) // 2
    product = 2 * D * pairs
    t = 2 * N * S * H * D                      # one bf16 (N, S, H, D)
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


def phase_flash():
    """K3 against its plain versions at the main path's shape and at
    S = 256, and timings of kernels, plain versions and SDPA."""
    import torch
    import torch.nn.functional as F
    from commefficient_torch.ops import flash_attention as FA

    flash_autograd_check()
    out = {}
    for N, S, H, D in FLASH_SHAPES:
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
        delta_ref = plain_delta(o, do)
        dq_f = attention_skipping(q, k, v, drops["flash_bwd_dq"], do,
                                  lse_ref, delta_ref)[0]
        dk_f, dv_f = attention_skipping(q, k, v, drops["flash_bwd_dkv"], do,
                                        lse_ref, delta_ref)[1:]
        for name, outs in (("flash_fwd", {"o": fwd_f[0], "lse": fwd_f[1]}),
                           ("flash_bwd_dq", {"dq": dq_f}),
                           ("flash_bwd_dkv", {"dk": dk_f, "dv": dv_f})):
            planted = worst(outs)
            print(f"[flash] S={S}, planted fault in {name} (one tile "
                  f"skipped): worst row error {planted}", flush=True)
            if passes(planted):
                fail(f"the K3 check passed a planted fault in {name} at "
                     f"S={S}: {planted}")
        del fwd_f, dq_f, dk_f, dv_f, delta_ref
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
        if S != FLASH_SHAPES[0][1]:
            continue
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
        for name, (nbytes, flops) in flash_bounds(N, S, H, D).items():
            b_ms, b_kind = bound(nbytes, flops, H100_BF16_PER_S)
            print(f"[flash] {name}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP -> bound {b_ms * 1e3:.2f} us "
                  f"({b_kind}); kernel {ms[name] * 1e3:.2f} us = "
                  f"{flops / ms[name] / 1e9:.1f} TFLOP/s")
            out[name] = {"max_abs_err": err[name], "ms": ms[name],
                         "kernel_ms": ms[name], "plain_ms": plain[name],
                         "bound_ms": b_ms, "bound_by": bound_by(b_kind),
                         "library_ms": library[name],
                         "max_row_err": row_err[name]}
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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ch = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32}
    for wire in ("float32", "int8"):
        cfg = FedConfig(mode="sketch", error_type="virtual",
                        local_momentum=0.0, virtual_momentum=0.9,
                        weight_decay=5e-4, k=200, num_rows=5,
                        num_cols=4096, num_workers=2, local_batch_size=8,
                        compute_dtype="float32", wire_dtype=wire)
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
                                   np.ones((2, 8), bool), 0.1 * (rnd + 1))
                losses.append(met["results"][0].cpu().numpy())
            runs[device] = (np.stack(losses), st.ps_weights.cpu().numpy())
        (l_cpu, w_cpu), (l_gpu, w_gpu) = runs["cpu"], runs["cuda"]
        dl = float(np.abs(l_gpu - l_cpu).max())
        dw = float(np.abs(w_gpu - w_cpu).max())
        print(f"[reference] narrow ResNet-9, {wire} wire, 3 rounds, card vs "
              f"CPU: max|dloss| {dl:.3e}, max|dw| {dw:.3e}", flush=True)
        if not np.allclose(l_gpu, l_cpu, rtol=1e-4, atol=0) or dw > 1e-5:
            fail(f"the card's rounds on the {wire} wire disagree with the "
                 "CPU's plain rounds")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


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
    E = gcfg.n_embd

    def run(device, fault=None):
        """(c_attn gradient blocks, (3, W) losses, update, K3 launches of
        the rounds) with ``fault`` planted in that K3 kernel."""
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
            g = model.views(g)["transformer/h/block/c_attn/kernel"]
            blocks = {f"layer {i} {name}": g[i, :, j * E:(j + 1) * E].cpu()
                      for i in range(gcfg.n_layer)
                      for j, name in enumerate("qkv")}
            FA.reset_launches()
            losses = []
            for rnd, batch in enumerate(batches):
                st, met = rt.round(st, np.arange(W), batch,
                                   np.ones((W, B), bool), 0.16)
                losses.append(met["results"][0].cpu().numpy())
            return (blocks, np.stack(losses),
                    (st.ps_weights - w0).cpu().numpy(), dict(FA.launches))
        finally:
            FA.forward, FA.backward_dq, FA.backward_dkv = saved

    g_cpu, l_cpu, u_cpu, n_cpu = run("cpu")

    def readings(result):
        g, l, u, _ = result
        grad = max(float((g[key].float() - ref.float()).norm()
                         / ref.float().norm()) for key, ref in g_cpu.items())
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
    if n_cpu != {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0} \
            or sound[3] != dict.fromkeys(n_cpu, 3 * W * gcfg.n_layer):
        fail(f"narrow GPT-2: unexpected K3 launches {n_cpu} / {sound[3]}")
    if not np.isfinite(sound[1]).all() or not passes(read):
        fail(f"the card's GPT-2 gradient or rounds disagree with the CPU's "
             f"plain ones: {read}")
    passed = [fault for fault, r in faults.items() if passes(r)]
    if passed:
        fail(f"the narrow GPT-2 check passed planted faults in {passed}")


# where the phases' CIFAR directories are written (a temporary directory
# that main() makes and removes)
DATA_ROOT = {"path": None}


def dataset_flags(name: str):
    """``--dataset_dir`` of a directory of its own under the run's data
    root (each synthetic size is prepared in its own)."""
    return ["--dataset_dir", os.path.join(DATA_ROOT["path"], name)]


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
    out = cv_train.main(argv)
    launches = dict(K.launches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if out["rounds"] != ROUNDS or out["summary"] is None:
        fail(f"ran {out['rounds']} rounds (summary {out['summary']}), "
             f"wanted {ROUNDS}")
    if not np.isfinite(out["losses"]).all() or \
            not math.isfinite(out["val_loss"]):
        fail(f"non-finite losses {out['losses']} / {out['val_loss']}")
    if launches["circ_encode"] != 9 * ROUNDS or \
            launches["circ_decode"] != ROUNDS:
        fail(f"launches {launches}: want 9 encode and 1 decode per round")
    rt = statistics.median(out["round_s"][1:])
    print(f"[main] {tag}: {ROUNDS} rounds: median of rounds 2-{ROUNDS} "
          f"(the first pays one-time set-up) {rt * 1e3:.3f} ms "
          f"(all: {[round(t * 1e3, 3) for t in out['round_s']]}), "
          f"{8 * 64 / rt:.1f} img/s, peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}", flush=True)
    return launches, rt * 1e3


# the single-device round in every mode at ResNet-9's full width: 100
# clients of 64 synthetic images, 8 a round; (flags, K1 and K2 launches a
# round). K1: the fused step's W x (64 / 16) microbatches + weight decay,
# or the unfused path's one encode of the summed gradient.
MODE_ROUNDS = 3
MODE_COMMON = ["--dataset_name", "CIFAR10", "--model", "ResNet9",
               "--error_type", "virtual", "--local_momentum", "0",
               "--num_clients", "100", "--synthetic_per_class", "640",
               "--num_workers", "8", "--local_batch_size", "64",
               "--k", "50000", "--num_rows", "5", "--num_cols", "500000",
               "--valid_batch_size", "400", "--num_rounds", str(MODE_ROUNDS)]
MODE_CONFIGS = {
    "uncompressed": (["--mode", "uncompressed", "--error_type", "none",
                      "--virtual_momentum", "0.9"], 0, 0),
    "true_topk": (["--mode", "true_topk", "--virtual_momentum", "0.9"],
                  0, 0),
    "local_topk": (["--mode", "local_topk", "--error_type", "local",
                    "--local_momentum", "0.9"], 0, 0),
    "fedavg": (["--mode", "fedavg", "--error_type", "none",
                "--local_batch_size", "-1", "--fedavg_batch_size", "64"],
               0, 0),
    "sketch_subtract": (["--mode", "sketch", "--virtual_momentum", "0.9",
                         "--sketch_ef", "subtract", "--microbatch_size",
                         "16"], 8 * 4 + 1, 1),
    "sketch_unfused": (["--mode", "sketch", "--virtual_momentum", "0.9",
                        "--sketch_fused_encode", "off"], 1, 1),
}
# the client and server rules of this slice at the same widths (100
# clients: --topk_down holds a row of weights for each). K1 as the JAX
# package routes them: the table clip and --topk_down stream each
# client's microbatch and its own weight-decay term into its own table (8
# x 2); the dense clip and DP encode the round's dense sum once; the dense
# server state encodes its (d,) error once; hash and rht launch none.
SKETCH_FLAGS = ["--mode", "sketch", "--virtual_momentum", "0.9"]
RULE_CONFIGS = {
    "clip": (SKETCH_FLAGS + ["--max_grad_norm", "1"], 16, 1),
    "dense_clip": (SKETCH_FLAGS + ["--sketch_dense_clip",
                                   "--max_grad_norm", "1"], 1, 1),
    "dense_state": (SKETCH_FLAGS + ["--sketch_server_state", "dense"], 1, 1),
    "dp_worker": (SKETCH_FLAGS + ["--dp", "--l2_norm_clip", "1",
                                  "--noise_multiplier", "0.1"], 1, 1),
    "dp_server_uncompressed": (["--mode", "uncompressed", "--error_type",
                                "none", "--dp", "--dp_mode", "server",
                                "--noise_multiplier", "0.1"], 0, 0),
    "topk_down": (SKETCH_FLAGS + ["--topk_down"], 16, 1),
    "hash": (SKETCH_FLAGS + ["--sketch_impl", "hash", "--num_cols",
                             "500000", "--num_blocks", "20"], 0, 0),
    "hash_dense_state": (SKETCH_FLAGS + ["--sketch_impl", "hash",
                                         "--num_cols", "500000",
                                         "--num_blocks", "20",
                                         "--sketch_server_state", "dense"],
                         0, 0),
    "rht": (SKETCH_FLAGS + ["--sketch_impl", "rht", "--num_rows", "5",
                            "--num_cols", "1313728"], 0, 0),
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

        def round(rt, state, client_ids, batch, mask, lr):
            ids = torch.as_tensor(np.asarray(client_ids), device=rt.device)
            before = None
            if rt.cfg.track_bytes:
                before = (state.coord_last_update.clone(),
                          state.client_last_round[ids].clone())
            new, metrics = orig(rt, state, client_ids, batch, mask, lr)
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
    rounds each: finite losses, the exact K1/K2 launches a round, and the
    bytes (``RoundRecorder``). Returns {name: (launches, median round
    ms)}."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.ops import circulant_kernels as K

    out_modes = {}
    for mode, (flags, n_enc, n_dec) in (configs or MODE_CONFIGS).items():
        argv = MODE_COMMON + dataset_flags("synthetic640") + flags
        print(f"[{tag}] python -m commefficient_torch.cv_train "
              + " ".join(argv), flush=True)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        with RoundRecorder() as rec:
            out = cv_train.main(argv)
        launches = dict(K.launches)
        peak = torch.cuda.max_memory_allocated()
        if out["rounds"] != MODE_ROUNDS or out["summary"] is None \
                or not np.isfinite(out["losses"]).all():
            fail(f"{mode}: {out['rounds']} rounds, losses {out['losses']}, "
                 f"summary {out['summary']}")
        want = {"circ_encode": n_enc * MODE_ROUNDS,
                "circ_decode": n_dec * MODE_ROUNDS}
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


def phase_sparse_encode():
    """The sparse re-encode (``encode_vals_at``, which the subtract rule
    reads) on the card at both main paths' sketches with k = 50,000: its
    table must have the bits of the same call on the CPU (a cell's
    addends are summed in the order of ``idx`` on every device), and two
    card calls the same bits; timed beside ``index_add_`` (whose order on
    the card is not fixed)."""
    import numpy as np
    import torch
    from commefficient_torch.ops.circulant import make_circulant_sketch

    rng, out = np.random.RandomState(5), {}
    for shape in (FLAGSHIP, GPT2_SKETCH):
        d, c, r = shape["d"], shape["c"], shape["r"]
        idx = torch.from_numpy(rng.permutation(d)[:50_000])
        vals = torch.from_numpy(rng.randn(50_000).astype(np.float32))
        cpu = make_circulant_sketch(d, c, r, device="cpu")
        card = make_circulant_sketch(d, c, r, device="cuda")
        want = cpu.encode_vals_at(vals, idx)
        gi, gv = idx.cuda(), vals.cuda()
        got = card.encode_vals_at(gv, gi)
        again = card.encode_vals_at(gv, gi)
        if not (same_bits(got.cpu(), want) and same_bits(got, again)):
            fail(f"the sparse re-encode at d={d} differs from the CPU's "
                 "bits or between two calls")

        def index_add():
            table = card.empty_table()
            for j in range(r):
                table[j].index_add_(0, card._buckets_of(j, gi),
                                    card._sign_of(j, gi) * gv)
            return table

        ms = time_ms(lambda: card.encode_vals_at(gv, gi), n=10)
        lib = time_ms(index_add, n=10)
        out[d] = (ms, lib)
        print(f"[sparse] d={d} c={c}: encode_vals_at of 50,000 values "
              f"bitwise equal to the CPU's and across calls; "
              f"{ms:.4f} ms (index_add_ {lib:.4f} ms)", flush=True)
    return out


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
                    want_up=None):
    """``n_rounds`` GPT-2 rounds at GPT-2 small's width through the user's
    entry point, each round an epoch with its validation; ``extra`` flags
    after the main path's. Every round must launch exactly GPT2_PER_ROUND
    (with ``encodes`` K1 and ``fwd`` K3 forward kernels: 192 when every
    block's forward runs again in the backward) and every validation batch
    GPT2_VAL_FWD K3 forward kernels and nothing else (``LaunchSplit``),
    and the two must add up to the run's counts. Returns the measured
    launches of the rounds and of the validations, the median round time
    (ms) and ``info``: the peak memory (bytes), the round losses and,
    with ``keep``, the first round's weights before and after it and the
    final weights (on the host). With ``want_up``, each round's upload
    bytes a participant are held to it (``RoundRecorder``)."""
    import contextlib

    import numpy as np
    import torch
    from commefficient_torch import gpt2_train
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops import flash_attention as FA

    argv = [*GPT2_ARGV, "--num_rounds", str(n_rounds), *extra]
    per_round = dict(GPT2_PER_ROUND, circ_encode=encodes, flash_fwd=fwd,
                     circ_decode=decodes)
    tag = " ".join(extra) or "bytes on"
    print("[gpt2] python -m commefficient_torch.gpt2_train " + " ".join(argv),
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    FA.reset_launches()
    with LaunchSplit(gpt2_train.kernel_launches, keep) as split, \
            (RoundRecorder() if want_up is not None
             else contextlib.nullcontext()) as rec:
        out = gpt2_train.main(argv)
    if rec is not None:
        rec.check_bytes(" ".join(extra), want_up)
    total = gpt2_train.kernel_launches()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rounds, val = split.total("round"), split.total("val")
    val_batch = dict.fromkeys(total, 0)
    val_batch["flash_fwd"] = GPT2_VAL_FWD
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
    epochs, from the device store (its MiB printed), exactly 9 K1 and 1 K2
    launches a round; the data path's time a round against the host
    gather's; then a flipped byte in the newest generation and a
    ``--resume`` in a fresh call of the entry point: the restore must
    fall back to the first generation and name the damaged one, the
    restored state must be bitwise the one saved, the first resumed
    round's batch (indices, augmented images, targets) bitwise the
    uninterrupted run's and its loss within RESUME_LOSS_RTOL. Returns the
    K1/K2 launches of both runs."""
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
            whole = cv_train.main(argv)
    finally:
        ckpt.CheckpointManager.save = save
    launches_a = dict(K.launches)
    n_a = whole["rounds"]
    if whole["summary"] is None or whole["summary"]["epoch"] != REAL_EPOCHS \
            or not np.isfinite(whole["losses"]).all():
        fail(f"the real-data run ended at {whole['summary']}")
    if launches_a != {"circ_encode": 9 * n_a, "circ_decode": n_a}:
        fail(f"real-data launches {launches_a} over {n_a} rounds: want 9 "
             "encode and 1 decode a round")
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
            rest = cv_train.main(argv + ["--resume"])
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
    if launches_b != {"circ_encode": 9 * n_b, "circ_decode": n_b} \
            or n_b != n_a - first:
        fail(f"resumed run: {n_b} rounds, launches {launches_b}; want "
             f"{n_a - first} rounds, 9 + 1 a round")
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
FEMNIST_PER_ROUND = {"circ_encode": 9, "circ_decode": 1}
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
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
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
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
    out = cv_train.main(argv)
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
        out = cv_train.main(argv)
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
    "uncompressed": ([], {"circ_encode": 0, "circ_decode": 0}),
    "sketch": (["--mode", "sketch", "--k", "50000", "--num_rows", "5"],
               {"circ_encode": 8, "circ_decode": 1}),
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


def imagenet_round_flops() -> float:
    """Model FLOPs of one ImageNet round: the forward and backward of
    FixupResNet50 at 224 x 224 (convolutions and matrix products, counted
    by ``FlopCounterMode`` from the shapes on the ``meta`` device) times
    IMAGENET_IMAGES."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from commefficient_torch.models.fixup_resnet import FixupResNet50

    m = FixupResNet50(num_classes=1000, input_shape=(224, 224, 3),
                      device="meta")
    flat = torch.zeros(m.num_params, device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        m(torch.zeros(1, 224, 224, 3, device="meta"), flat,
          dtype=torch.bfloat16).float().sum().backward()
    return counter.get_total_flops() * IMAGENET_IMAGES


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
    from commefficient_torch.data.fed_imagenet import FedImageNet
    from commefficient_torch.ops import circulant_kernels as K

    # no ImageNet tree here: the synthetic set is prepared first, and the
    # recipe reads it as a prepared directory
    root = os.path.join(DATA_ROOT["path"], "imagenet_store")
    FedImageNet(root, synthetic=True,
                synthetic_per_class=IMAGENET_STORE_PER_CLASS)
    flops = imagenet_round_flops()
    launches, medians = {}, {}
    for mode, (flags, per_round) in IMAGENET_MODES.items():
        argv = imagenet_argv(root, IMAGENET_STORE_PER_CLASS, flags)
        print(f"[imagenet] python -m commefficient_torch.cv_train "
              + " ".join(repr(a) if a == "" else a for a in argv),
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        out = cv_train.main(argv)
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
                         + ["--warmup", "1", "--profile_rounds", "2"])
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
            out = cv_train.main(argv)
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
    first = cv_train.main(argv)
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
    out = cv_train.main(argv)
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
    want = {"circ_encode": 9 * COMPAT_STEPS, "circ_decode": COMPAT_STEPS}
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
# bytes a client a round); int8 at --wire_block 256 is 5 c cells plus a
# float32 scale every 256 columns of a row
WIRE_ARMS = {
    "bf16": (["--wire_dtype", "bfloat16"], 9, 1, 5_007_360),
    "sketch_dtype_alias": (["--sketch_dtype", "bfloat16"], 9, 1, 5_007_360),
    "int8": (["--wire_dtype", "int8"], 9, 1, 2_542_800),
    "int8_again": (["--wire_dtype", "int8"], 9, 1, 2_542_800),
    "int8_clip": (["--wire_dtype", "int8", "--max_grad_norm", "1"], 16, 1,
                  2_542_800),
    "int8_hash": (["--wire_dtype", "int8", "--sketch_impl", "hash",
                   "--num_cols", "500736"], 0, 0, 2_542_800),
}


def phase_wire():
    """The ResNet-9 main path (8 x 64, k = 50,000, r = 5, c = 500,736)
    on each of ``WIRE_ARMS`` through ``python -m
    commefficient_torch.cv_train``, WIRE_ROUNDS rounds each: finite
    losses, the exact K1/K2 launches a round, every round's upload bytes
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
            res = cv_train.main(argv)
        sys.stderr.write(err.getvalue())
        launches = dict(K.launches)
        want = {"circ_encode": n_enc * WIRE_ROUNDS,
                "circ_decode": n_dec * WIRE_ROUNDS}
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
            res = cv_train.main(argv)
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
            GPT2_RHT_ROUNDS, encodes=0, decodes=0)
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
                "circ_decode": STREAM_ROUNDS}
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
                              "0.9", "--num_rounds", str(SERVICE_ROUNDS)]
# a robust arm runs the per-client path with deferred encode: one K1 (the
# aggregate's encode) and one K2 a round
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
    """``cv_train.main(argv)`` on the card with every launch count set to
    0 just before and read just after; returns (result, launches, peak
    memory)."""
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.ops import circulant_kernels as K

    print(f"[{tag}] python -m commefficient_torch.cv_train "
          + " ".join(argv), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    out = cv_train.main(argv)
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
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
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
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
    one call: 9 K1 + 1 K2 a round plain, exactly 1 K1 + 1 K2 a robust
    round, finite losses, the defense scalars of every round printed,
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
    _rounds_ok("plain sketch", out, launches,
               {"circ_encode": 9 * R, "circ_decode": R})
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
        _rounds_ok(arm, out, launches, {"circ_encode": R, "circ_decode": R})
        ms = statistics.median(out["round_s"][1:]) * 1e3
        scalars = out["defense"]
        if len(scalars) != R:
            fail(f"{arm}: {len(scalars)} rounds of defense scalars")
        print(f"[robust] {arm}: median of rounds 2-{R} {ms:.3f} ms "
              f"(plain {plain_ms:.3f}), peak {peak / 2**30:.3f} GiB (plain "
              f"{plain['peak'] / 2**30:.3f}), launches {launches}, losses "
              f"{[round(float(x), 5) for x in out['losses']]}, defense "
              + "; ".join(", ".join(f"{k} {v:.5g}" for k, v in s.items())
                          for s in scalars), flush=True)
        if "quarantine" in arm:
            ledger = out["services"].qledger
            cpu = cv_train.main(["--device", "cpu", "--test"] + argv[:-2]
                                + dataset_flags("synthetic640_cpu") + flags)
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
                              "0.9", "--num_rounds", str(ASYNC_TICKS)]
        out, launches, peak = run_cv(argv + dataset_flags("synthetic640")
                                     + ASYNC_STRAGGLERS, "async")
    finally:
        FedRuntime.commit = orig
    agg = out["services"].async_agg
    want = {"circ_encode": 9 * agg.dispatched, "circ_decode": agg.commits}
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
        return (MODE_COMMON + ["--mode", "sketch", "--virtual_momentum",
                               "0.9", "--num_rounds", "0", "--num_epochs",
                               "1", "--checkpoint_every", "1",
                               "--checkpoint", "--checkpoint_path", ck]
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
    t0 = time.perf_counter()
    DATA_ROOT["path"] = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
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

    def done(phase: str) -> None:
        print(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    phase_build()
    resources = phase_sass()
    sketch_sass = phase_sketch_sass()
    done("build")
    # scale: a client's datum count, as the fused step passes it
    circ = phase_kernels(FLAGSHIP, (FLAGSHIP["c"], 500_000), scale=64.0)
    circ_gpt2 = phase_kernels(GPT2_SKETCH, (GPT2_SKETCH["c"],), scale=4.0,
                              plain_n=5)
    circ_femnist = phase_kernels(FEMNIST_SKETCH, (FEMNIST_SKETCH["c"],),
                                 scale=16.0, plain_n=5)
    circ_imagenet = phase_kernels(IMAGENET_SKETCH, (IMAGENET_SKETCH["c"],),
                                  scale=64.0, plain_n=5)
    circ_stream = phase_kernels(STREAM_SKETCH, (STREAM_SKETCH["c"],),
                                scale=32.0, plain_n=5)
    k1_range = {"gpt2": phase_kernels_range(GPT2_SKETCH, scale=4.0),
                "stream": phase_kernels_range(STREAM_SKETCH, scale=32.0)}
    done("K1/K2, K1's range form")
    flash = phase_flash()
    done("K3")
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
    gpt2_arms = {arm: phase_gpt2_main(flags, GPT2_ARM_ROUNDS, encodes)
                 for arm, (flags, encodes) in GPT2_ARMS.items()}
    gpt2_int8 = phase_gpt2_main(["--wire_dtype", "int8"], GPT2_ARM_ROUNDS,
                                want_up=GPT2_INT8_BYTES)
    print(f"[gpt2] --wire_dtype int8: {GPT2_INT8_BYTES} bytes a client a "
          f"round (float32: {4 * 5 * GPT2_SKETCH['c']}), median "
          f"{gpt2_int8[2]:.3f} ms", flush=True)
    done("GPT-2 study arms, the int8 wire")
    levers = phase_gpt2_levers()
    pretrained = phase_gpt2_pretrained()
    done("GPT-2 memory levers and the pretrained round trip")
    gpt2_runs = {**{f"{a} (GPT2_ARMS)": v[:2] for a, v in gpt2_arms.items()},
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
          + "; sparse re-encode (ms; index_add_): "
          + ", ".join(f"d={d}: {a:.4f} ({b:.4f})"
                      for d, (a, b) in sparse.items())
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
    kernels = []
    for name, line in (("circ_encode", 144), ("circ_decode", 175)):
        by_path = {"cv_train": cv_launches[name],
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
                      for a, launches in services.items()}}
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
            "sass_per_term": sketch_sass[name], **extra})
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
                      for a, (r, v) in rht_runs.items()}}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "commefficient_torch/csrc/flash_attention.cu",
            "replaces": f"{gpt2_file}:106 -> {LIBRARY_FLASH}:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **flash[name], "resources": resources[name]})
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

#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from anywhere in a checkout: ``python3 chip_smoke.py``.  Needs one CUDA
card and the CUDA toolkit (nvcc); it builds the port's kernels from
``src/repro_torch/kernels/csrc`` first.  Phases, each printing JSON lines on
stdout; a failing phase raises and the script exits non-zero:

1. device  — the card's name, and its name and power limit as nvidia-smi
             reports them.
2. build   — seconds taken by the parallel nvcc build, and ptxas's
             register/shared-memory report per kernel.
3. kernels — each kernel against its plain PyTorch version on the card:
             the §7 classifier and autoencoder stacks in REAL/SINT/INT/DINT at
             M = 1024, 1000 and 37, and untimed SINT and REAL at the 8-row
             block's edges (M = 1, 7, 8, 9, 15, 16, 17, 127, 128, 129), a
             37-13-5-3 stack (off both MMA granules) in the four schemes and
             a SINT stack with a REAL last layer (the f32-tile path)
             (fused_mlp; each row names its path, fused_mlp.path); the four
             classifier SINT
             layer shapes, and the LLM paths' SINT projections at their
             prefill and decode batches: mamba2-370m's two (M = 8 x 1024
             and 8), qwen3-8b's four (K x N = 4096 x 4096, 4096 x 1024,
             4096 x 12288, 12288 x 4096 at M = 8 x 1024 and 8) and
             granite-moe's two (1024 x 1024, 1024 x 512 at M = 512 and
             8), phase 13's: Jamba's six (8192 x 34944, 16384 x 8192,
             8192 x 8192, 8192 x 1024, 8192 x 24576, 24576 x 8192 at
             M = 4 x 1024 and 8), LLaVA-NeXT-34b's four (7168 x 7168,
             7168 x 1024, 7168 x 20480, 20480 x 7168 at M = 2 x 3392 and
             8) and whisper-base's three (512 x 512, 512 x 2048,
             2048 x 512 at M = 8 x 1500 and 8), and untimed checks
             on both sides of its path switch (M = 8, 63, 64, 65, 1000 at
             K x N = 400 x 64, 256 x 4384, 256 x 1024, 16 x 2, and an
             operand off 16-byte alignment) (qmatmul); the
             four-head §7 fleet (classifier, autoencoder, margin trunk,
             forecaster) in the four schemes at M = 1024, 1000 and 37 per
             group, a fleet whose classifier ends
             in a softmax, and a one-group fleet of the SINT autoencoder
             (the fused autoencoder's work through the grouped kernel, a
             like-for-like time), and untimed the four-head fleet at the
             block's edges and a fleet whose groups differ in true widths
             at every position (inputs 400/397/250, depths 4/3/4), SINT and
             REAL (grouped_fused_mlp); the §6.2 pruned layer
             (784 inputs padded to 7 x 128, 512 units) at M = 8 and 1024,
             sparsities 0/0.25/0.5/0.75 in (128, 128) blocks and 0.5 in
             (64, 64), plus an all-zero weight and a block-column pruned
             whole, and untimed checks at M = 1, 32, 33, each also
             bit-equal over two calls (sparse_matmul); mamba2-370m's SSD
             widths (H 32, P 64,
             N 128, G 1) at B 8 x T 1024 (the serve runs' prefill), a ragged
             T 1000 and one B 1 x T 32768 row against the chunked plain
             version (T zero-padded to its chunk), and B 2 x T 256
             against the sequential recurrence; Jamba's (H 128, P 128,
             N 128, G 8: two 64-column slices of each head) at B 4 x
             T 1024 (run (A)'s prefill), a ragged T 1000 and B 1 x T 4096;
             the final state at every
             shape against ref.ssd_final_state_ref, and at the two prefill
             shapes bf16 views of a conv output bit-equal to the same call
             on f32 copies and held to the plain versions on the same
             views (ssd_scan).  SINT must be
             torch.equal (grouped: the logit lanes; score lanes,
             reductions summed in another order, within 1e-5 relative);
             REAL within 1e-5 (and the softmax fleet); DINT within 1e-4;
             INT within 1e-3 (a last-bit difference ahead of a requantize
             can move an INT code by one step); sparse_matmul within 1e-4
             with pruned columns exactly 0; ssd_scan within rtol 2e-4 /
             atol 2e-5 (the reference's own tolerance), y and state.
             ``bound_ms`` of ssd_scan is the redesigned kernel's on f32
             inputs, ``bf16_views_bound_ms`` on the bf16 views (ssd_bound);
             ``cuda_core_bound_ms`` the bound of the earlier CUDA-core
             kernel (ssd_cuda_core_bound).
             ``ms`` is the kernel's device time from torch.profiler;
             ``call_ms`` the time per call through the Python wrapper, back
             to back (CUDA events), which the host's launch cost can bound;
             ``library_ms`` (sparse_matmul) one torch.matmul on the dense
             weight, TF32 off, per call back to back (CUDA events), and
             ``library_device_ms`` its device time (every kernel it
             launches; calls replayed from a CUDA graph); ``int_mm_ms`` (qmatmul, prefill
             shapes) one torch._int_mm on the same codes: the int32
             product alone, no epilogue, a yardstick.
4. serve   — a 1024-plant fleet (the 128-plant scenario fleet tiled 8x)
             through StreamEngine, warmup + 400 scan cycles (21 verdict
             steps) per run: (a) SINT classifier, fused; (b) REAL classifier;
             (c) SINT autoencoder + calibrated ReconstructionHead; (d) (a)
             with fused=False; (e) (a) with async_depth=1.  Then 4 x 1024
             plants (the scenario fleet tiled 32x) through
             GroupedStreamEngine, one group per §7 head, 400 cycles each:
             (f) SINT, megakernel, the reconstruction group adaptive;
             (g) REAL, megakernel; (h) (f) with megakernel=False.  Score
             heads are calibrated through the plain path on the fleet's
             first off-cadence windows (cycles 5-204, which the engine never
             serves, so no served score sits exactly on a threshold); the
             margin center is their mean embedding.  Each run against the
             same engine with backend="ref" (and (f) against (h)): preds
             identical, SINT logits bit-equal, scores within 1e-5, REAL
             within 1e-5; kernel launch counts checked.
5. profile — 10 more verdict steps of runs (a) and (f) under
             torch.profiler: device busy share and device time by kernel,
             the kernel's records counted at three stages (prof.events(),
             kineto's raw results, the chrome trace kineto writes) beside
             the launch counters; one kernel record per step, checked.
             Every session follows an empty one and opens with a lead-in
             of device ops that takes the records such a session loses
             (see device_events).
6. prune   — the §6.2 pruned layer's path: block_magnitude_prune ->
             compress_blocks -> ops.sparse_dense at M = 8 (the pruning
             bench's shape), sparsities 0/0.25/0.5/0.75: one sparse_matmul
             launch each, held to the plain version.
7. serve   — mamba2-370m at full width (48 layers, random weights from a
             seed) through the wave Engine, 8 slots, 8 requests of 1024
             prompt tokens and 32 greedy new tokens each: (i) bf16 REAL,
             (j) bf16 SINT (qmatmul on the projections), (k) f32 REAL,
             (l) f32 SINT.  Each against the same engine with
             backend="ref" (the sequential SSD recurrence, plain qmatmul):
             (k) greedy tokens identical and prefill logits within 1e-3 of
             the largest; (i)/(j) prefill logits no farther from those of
             the same weights in f32 through the plain path than
             BF16_NOISE_FACTOR times the bf16 plain path's (relative L2);
             token agreement printed.  (j)/(l) also against the same engine
             with only qmatmul plain (backend={"qmatmul": "ref"}): tokens
             and prefill logits equal.  (k)/(l) print how far the two plain
             SSD versions (chunked, sequential) put the logits apart.
             Launches checked: 48 ssd_scan per prefill, 96 qmatmul per
             forward for SINT, nothing else.
8. profile — one prefill of (i) under torch.profiler: device busy share,
             device time by kernel, 48 ssd_scan kernels, and no state
             kernel (scan, cumsum, flip) outside ssd_scan.
9. late_profile — phase 5's sessions again, now after the Mamba-2 runs
             (where sessions without the lead-in lost records every
             time), checked the same way.
10. framework — the ICSML framework itself on the card.  (m) the SINT
             classifier of run (a) through apply, apply_planned (the §4.2.1
             arena) and MultipartInference at 1, 2, 4 and 8 segments, all
             torch.equal to apply; (n) the §6.3 demo model (mobilenet_ish
             of benchmarks/multipart_bench.py: Conv2D-s2 / BatchNorm-relu /
             DepthwiseConv2D / BatchNorm-relu at 8, 16, 32 channels, pool,
             Dense-10 softmax), REAL, with cuDNN's TF32 flag at PyTorch's
             default (on) for the run: apply_planned and every segment count
             within 1e-6 relative of apply, apply within 1e-5 of the CPU
             plain path (the layers keep IEEE f32); both print per-segment
             wall µs and totals (CUDA events, MULTIPART_REPS inferences),
             segment FLOPs and the planned and naive arena bytes, and one
             4-segment inference under torch.profiler (device events, busy
             share, device time by kernel); (o) one
             plant of the port's MSF simulator through ScanCycleRuntime for
             N_CYCLES cycles with a trivial control task and (m)'s model as
             a 4-segment SlidingWindowDetector on the card: every inference
             4 cycles late, predictions equal to single-shot apply of the
             same windows, cycle times against the 100 ms budget; (p) the
             IEC 61131-3 export of examples/export_st.py::verify_export:
             the SINT classifier, the SINT autoencoder and the REAL
             autoencoder (score heads calibrated on the off-cadence windows)
             exported with the ingest normalization baked in, the 1024-plant
             fleet served through StreamEngine on the card (one fused_mlp
             launch per verdict step, checked) and every window of a seeded
             sample of REPLAY_PLANTS plants replayed through the emulated
             block in one batched call: 0 failures; SINT also 0 borderline
             windows and a body difference of 0.0 (the block's outputs
             bit-equal to numpy_mlp_ref, PRED and THRESHOLD equal to the
             card engine's, CONF/SCORE within 1e-4 relative), and for the
             classifier the engine's own logits, fused_mlp's outputs,
             bit-equal to numpy_mlp_ref too (max_engine_diff 0.0; the
             autoencoders' engine step returns only the score).  No
             verdict diversity is asserted: the weights are random.
11. train — the §7 detectors trained on the card, at the data scale of
             examples/export_st.py::trained_detector's real workflow
             (build_dataset(21000 normal, 2850 attack cycles, stride 8,
             jitter 0.015 over 4 plants): 7,452 windows), 60 epochs,
             patience 8, lr 1e-3, batch 256.  (q) train_detector,
             train_autoencoder, train_one_class and train_forecaster with
             device="cuda": epochs run, first and last train loss, best
             validation metric, test_acc, each score head's threshold,
             calib_fpr and detection rate, wall seconds, steps/s and
             fused_mlp launches; checked: the last epoch's loss below the
             first, test_acc > 0.70, the autoencoder's detection rate >
             0.5, every calib_fpr <= target_fpr, one fused_mlp launch per
             validation epoch (plus the test split, the calibration and
             attack scores, the margin center), and fused_mlp held to its
             plain version on each trained stack's validation split (within
             1e-5 of 1 + the largest output, as verify_export holds REAL:
             the trained classifier's logits reach the hundreds).  One
             classifier epoch under torch.profiler (busy share, device time
             by kernel).  (r) each trainer for CHECK_EPOCHS epochs on the
             card and on the CPU from the same seed, cuBLAS's TF32 flag on
             (training turns it off for itself and restores it): losses,
             validation metrics (the classifier's accuracy within one
             validation window) and params (of the largest weight) within
             1e-4.  (s) the trained classifier and autoencoder through
             port_mlp, SINT quantization (calibration_samples of the
             dataset), the autoencoder's threshold recalibrated on its
             held-out calib_windows, export_st with the ingest
             normalization, and verify_export against the 1024-plant fleet
             on the card as in (p): 0 failures, 0 borderline, body
             difference 0.0 (the classifier's engine difference 0.0), and
             0 < anomalous < windows served; alarms per scenario printed
             (first alarm after onset, alarms before it).  (t) the four
             trained heads in SINT, score heads recalibrated on their
             calib_windows, 4 x 1024 plants through
             GroupedStreamEngine(megakernel=True) for 400 cycles: one
             grouped_fused_mlp launch per step, equal to backend="ref" (as
             (f)), and 0 < anomalous < windows for the classifier and the
             autoencoder groups.

12. llm — the dense GQA decoder and its MoE twin at full width, random
             weights from a seed (qwen3-8b: 36 layers, d 4096, 32/8 heads of
             128, d_ff 12288, vocab 151936; granite-moe-1b-a400m: 24
             layers, d 1024, 16/8 heads, 32 experts top-8, d_ff 512).
             (u) qwen3-8b bf16 SINT through the wave Engine, 8 slots, 8
             requests of 1024 prompt tokens, 32 greedy new tokens (the
             slice's main path): 252 qmatmul launches per forward (8,064),
             nothing else; tokens and prefill logits torch.equal to the
             same engine with backend={"qmatmul": "ref"}; one prefill and
             one decode step under torch.profiler (busy share, device time
             by kernel, qmatmul's share against its bound).  (v) the §6.3 CyclicDecoder, 4
             segments, batch 1, from (u)'s first prompt, 31 tokens after
             the prefill's, a PI control task once per cycle: tokens equal
             to a batch-1 wave engine's; cycle p50/p99 against the 100 ms
             scan cycle.  (w) qwen3-8b's widths cut to 2 layers, f32 REAL,
             2 x 128 prompt tokens, prefill and 8 greedy decode steps, card
             against the CPU's plain path (TF32 off): every step's logits
             within 1e-4 of the largest, tokens equal.  (x) granite-moe
             bf16 SINT through ContinuousEngine, 8 slots, 24 requests
             (seeded prompt lengths 64-512, new tokens 16-48): tokens equal
             to the same engine with qmatmul plain, 96 qmatmul launches per
             forward (admission prefills and steps), ServeStats.  (y) (x)
             with cyclic_segments=4: tokens equal to (x).  (z) mamba2-370m
             f32 REAL through ContinuousEngine, 8 slots, 16 requests
             (prompts 64-256): greedy tokens equal to backend="ref", 48
             ssd_scan launches per admission.
13. families — the last three families at full width, random weights from
             a seed, each model freed before the next, peak memory printed
             per run.  (A) jamba-1.5-large-398b bf16 SINT through the wave
             Engine, 4 slots, 4 requests of 1024 prompt tokens, 16 greedy
             new tokens: widths uncut (d 8192, 64/8 heads of 128, d_ff
             24576, vocab 65536, 128 SSD heads of P 128, N 128, G 8, top-2);
             depth cut to one super-block of 8 layers (attention at
             position 3, 7 Mamba, 4 dense MLP, 4 MoE) and the experts from
             16 to 8 (all 16 would be 77.3 GB of one super-block's experts
             alone); 30 qmatmul launches per forward and 7 ssd_scan per
             prefill; tokens and prefill logits torch.equal to the same
             engine with qmatmul plain (the ssd_scan kernel in both); one
             prefill and one decode step under torch.profiler.  (B) one of
             its Mamba mixers, f32 REAL, B 1 x T 256: output and both states
             within 1e-4 (of the largest) of the CPU's plain path.  (C)
             (A)'s model through ContinuousEngine, 4 slots, 12 requests
             (seeded prompts of 64-512 tokens, 8-24 new): tokens and step
             count equal to the qmatmul-plain engine's, 7 ssd_scan launches
             per admission.  (D) llava-next-34b bf16 SINT, all 60 layers
             (d 7168, 56/8 heads of 128, d_ff 20480, vocab 64000), the wave
             Engine with extras={"image_emb": (2, 2880, 1152)} from a seed,
             512 text tokens, 16 new: 420 qmatmul launches per forward,
             tokens and prefill logits torch.equal to the qmatmul-plain
             twin, the prefix shown to move the text's logits, one prefill
             under torch.profiler.  (E) (D) through the CyclicDecoder, 4
             segments of 15 layers, batch 1, a PI control task per cycle:
             tokens equal to the batch-1 wave engine's, every cycle under
             the 100 ms scan cycle.  (F) whisper-base uncut (6 + 6 layers,
             d 512, 8 heads, d_ff 2048, vocab 51865, 1500 frames),
             extras={"frames": (8, 1500, 512)} from a seed, 64 prompt
             tokens: bf16 SINT through the wave Engine, 32 new, tokens and
             prefill logits equal to the qmatmul-plain twin, 96 qmatmul
             launches per prefill (36 encoder, 60 decoder) and 48 per
             decode step; f32 REAL, prefill and 8 greedy steps within 1e-4
             (of the largest logit) of the CPU, tokens equal; and
             ``python -m repro_torch.launch.serve --arch whisper_base`` and
             ``--arch llava_next_34b --reduced`` on the card.
14. llm_train — the LLM training stack (launch.steps: eager autograd,
             AdamW with f32 moments, every layer rematerialised), random
             weights from a seed, data from data.SyntheticLM; no kernel may
             launch inside a train step (the gradient takes the plain
             versions, launch.steps.GRAD_BACKEND).  (G) qwen3-8b's widths
             (d 4096, 32/8 heads of 128, d_ff 12288, vocab 151936, tied
             embedding) cut to 8 layers (2.17B params; all 36 would be
             ~91 GB with their gradients and moments), bf16, 20 steps of
             8 x 1024 tokens at lr 3e-4, warmup 5: losses and gradient
             norms finite, the last 5 losses' mean below the first 5's,
             every float leaf moved; step ms, tokens/s, peak GB, and one
             more step under torch.profiler.  (H) one step of each
             family's reduced f32 config (qwen3, granite-moe, mamba2,
             Jamba, LLaVA-NeXT, Whisper), 2 x 64 tokens, card against the
             CPU from the same params and batch (TF32 off): loss and
             gradient norm within 1e-4 relative, every gradient leaf
             within 1e-4 of its largest value, the updated params within
             1e-4 of the largest param.
             (I) mamba2-370m uncut (48 layers, d 1024, 32 SSD heads of
             P 64, N 128, vocab 50280), bf16, 10 steps of 8 x 1024 tokens
             through the chunked SSD's gradient; the loss without a
             gradient on the params upcast to f32 through ssd_scan (48
             launches) within 1e-4 relative of the chunked plain SSD's; a
             checkpoint saved and restored (every leaf torch.equal), then 2
             more steps from the live state and from the restored one under
             torch.use_deterministic_algorithms: equal losses; the restored
             model in f32 through the wave Engine at (k)'s shape (8 x 1024
             prompt tokens, 32 new): 48 ssd_scan launches, greedy tokens
             equal to backend={"ssd_scan": "ref"}'s, prefill logits within
             1e-3.  (J) examples/train_llm.py's default model whole (12
             layers, d 512, 8/4 heads, d_ff 1408, vocab 32768, ~55M
             params), bf16, 300 steps of 8 x 256 tokens at lr 6e-4, warmup
             50: the last 5 losses' mean at least 0.3 below the first 5's.
             (K) ``python -m repro_torch.launch.train --arch mamba2_370m
             --reduced --steps 5 --ckpt-dir <tmp> --ckpt-every 5`` exits 0
             and leaves LATEST = 5.
15. mesh   — the fleet served on torch.distributed meshes, one process
             per rank (repro_torch.launch.mesh.spawn; the kernels built
             before any rank starts), at full width, window 200, stride
             10, 21 steps after the ring fills: (L) the SINT classifier,
             fused, on a (4,) data mesh, 4 x 1024 plants; (M) (L) in REAL;
             (N) the SINT classifier per layer on a (2, 2) mesh, 2 x 1024
             plants, its 64-wide layer column-sharded (32 columns a rank
             through qmatmul), and the same mesh run with qmatmul plain
             (backend="ref"); (O) the SINT autoencoder on (2, 2)
             (three wide layers); (P) the four-head SINT fleet on a (2,)
             data mesh, 2 x 1024 plants a group, per group and with
             megakernel=True; (Q) one rank over NCCL on the (1,) and the
             host (1, 1) mesh, 1024 plants.  (L)-(P) run on four ranks:
             over NCCL, one rank per card, on a machine with four cards;
             else over gloo, the ranks sharing the card.  Every rank's
             verdicts equal those of the unsharded engine over the same
             plants on the same card (run in this process), SINT outputs
             torch.equal, REAL within 1e-6 relative, the grouped fleet's
             as run (h)'s; each rank's launches and gathers a step are
             counted.  One line per run: backend, ranks and their
             devices, windows/s, p50/p99 verdict latency, deadline misses,
             launches and gathers a step by rank, gather ms a step.

Then the wall seconds of each phase and in all, and each trainer's wall
seconds (``{"phase": "seconds"}``),
the kernels summary line (``{"kernels": [...]}``, launch counts from
the main-path runs), the nvidia-smi line and, last, ``{"ok": true,
"device": ...}``.
"""

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# cuBLAS's deterministic workspace, read when the first handle is made: run
# (I)'s resumed steps run under torch.use_deterministic_algorithms.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# Published H100 SXM peaks (NVIDIA data sheet, dense) for the bounds.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # TF32 on the tensor cores
BF16_FLOPS_PER_S = 989e12        # bf16 on the tensor cores
TOL = {"REAL": 1e-5, "INT": 1e-3, "DINT": 1e-4}
SCHEMES = ("REAL", "SINT", "INT", "DINT")
N_PLANTS, TILE, N_CYCLES = 128, 8, 400
GROUPS, GROUP_TILE = ("clf", "ae", "mg", "fc"), 32    # 4 x 1024 plants
DEVICE = "cuda"
# Batches checked but not timed for fused_mlp / grouped_fused_mlp: the edges
# of the 8-row block and of the m16 tile whose upper half it fills.
EDGE_MS = (1, 7, 8, 9, 15, 16, 17, 127, 128, 129)
# The §6.2 pruned layer's batches: the pruning bench's 8, and 1024.
PRUNE_MS = (8, 1024)
# Batches checked but not timed: the small-M path's ends and the first
# large-M batch (sparse_matmul.plan switches above 32).
PRUNE_CHECK_MS = (1, 32, 33)
# ssd_scan shapes (B, T) at the Mamba-2 config's widths (H 32, P 64, N 128,
# G 1) and, "jamba_*", at Jamba's (H 128, P 128, N 128, G 8).  The bf16
# views of a conv output run at the two "prefill" shapes.
SSD_SHAPES = {"prefill": (8, 1024), "ragged": (8, 1000), "long": (1, 32768),
              "vs_sequential": (2, 256), "jamba_prefill": (4, 1024),
              "jamba_ragged": (4, 1000), "jamba_long": (1, 4096)}
MAMBA_ARCH = "mamba2_370m"
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_NEW = 8, 1024, 32
# A bf16 run's prefill logits carry bf16 rounding noise that the 48 random
# residual layers amplify: a last-bit difference in the SSD's f32 sums can
# flip the bf16 rounding of an activation (or a SINT code), and the flips
# grow through the depth, so the kernel and plain paths of one bf16 model
# differ by a few percent (3.8% relative L2 in the first card run) with
# both right.  The yardstick is therefore the same weights in f32 through
# the plain path (backend="ref", no kernel of this script): the kernel
# path's distance from that twin's logits may be at most BF16_NOISE_FACTOR
# times the plain path's (two correct paths carry the same noise; a fault
# of the algorithm — a lost state, a wrong chunk — adds O(1)).  Under SINT
# the activation codes turn a last-bit difference into a whole quantization
# step, so even f32 paths part by tenths (both bf16 distances read about
# 0.5): there this check catches only gross faults, and the SINT runs are
# held exactly to the same path with qmatmul's plain version.
BF16_NOISE_FACTOR = 2.0
# The two Dense-stack kernels' designs, for the kernels line.
FUSED_DESIGN = ("int8_mma: 8-row blocks (128 at M=1024), input quantized as "
                "staged (16-byte loads) into int8 codes, mma.sync m16n8k32 "
                "from K-major int8 weight copies, epilogues requantized in "
                "registers, step table in shared memory; f32_tile "
                "(REAL/INT/DINT layers): f32 tiles, CUDA-core dots, two "
                "rows a thread")
GROUPED_DESIGN = ("int8_mma: 16-row blocks, grid (M / 16, G), each group at "
                  "its true widths from the meta row, as fused_mlp's "
                  "int8_mma otherwise; f32_tile: 8-row blocks; masked "
                  "softmax and the head epilogue from the group's f32 tile")
F32_LOGIT_TOL = 1e-3
# Phase 10: inferences timed per segment count, and the plants whose every
# window the emulated ST block replays.
MULTIPART_REPS = 20
REPLAY_PLANTS = 256
# Phase 11: the data and settings of examples/export_st.py::trained_detector's
# real (not --fast) workflow, and run (r)'s short card-against-CPU runs.
TRAIN_DATA = dict(normal_cycles=21_000, attack_cycles=2_850, stride=8, seed=0,
                  jitter=0.015, jitter_plants=4)
TRAIN_EPOCHS, TRAIN_PATIENCE, TRAIN_LR, TRAIN_BATCH = 60, 8, 1e-3, 256
CHECK_EPOCHS, CARD_CPU_TOL = 2, 1e-4
# Phase 12: the dense GQA decoder and its MoE twin at full width.  (u) and
# (v): qwen3-8b, 8 x 1024 prompt tokens, 32 new, a 1088-position arena;
# (v) decodes in CYCLIC_SEGMENTS scan cycles per token against the PLC's
# SCAN_CYCLE_S.  (w): qwen3-8b's widths cut to WIDTH_LAYERS layers, card
# against the CPU.  (x), (y): granite-moe through CONT_SLOTS continuous
# slots, CONT_REQUESTS requests with seeded prompt lengths and new tokens
# (prompt bodies of at most moe_group = 512 tokens: the MoE dispatch's
# groups).  (z): mamba2-370m through the same slots.
QWEN_ARCH, GRANITE_ARCH = "qwen3_8b", "granite_moe_1b_a400m"
LLM_BATCH, LLM_PROMPT, LLM_NEW, LLM_CACHE = 8, 1024, 32, 1088
CYCLIC_SEGMENTS, SCAN_CYCLE_S = 4, 0.1
WIDTH_LAYERS, WIDTH_BATCH, WIDTH_PROMPT, WIDTH_STEPS = 2, 2, 128, 8
WIDTH_TOL = 1e-4
CONT_SLOTS, CONT_REQUESTS, CONT_PROMPTS, CONT_NEW = 8, 24, (64, 512), \
    (16, 48)
SSM_REQUESTS, SSM_PROMPTS, SSM_NEW, SSM_CACHE = 16, (64, 256), (16, 32), 512
# Phase 13: the last three families at full width (module docstring).  (A)
# Jamba cut to JAMBA_LAYERS (one super-block) and JAMBA_EXPERTS experts;
# (B) one of its Mamba mixers over MIXER_T steps; (C) (A)'s model through
# JCONT_SLOTS continuous slots; (D), (E) llava-next-34b uncut, its image
# prefix and LLAVA_TEXT text tokens; (F) whisper-base uncut.
JAMBA_ARCH, LLAVA_ARCH, WHISPER_ARCH = ("jamba_1_5_large_398b",
                                        "llava_next_34b", "whisper_base")
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 8
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_NEW, JAMBA_CACHE = 4, 1024, 16, 1088
MIXER_T = 256
JCONT_SLOTS, JCONT_REQUESTS, JCONT_PROMPTS, JCONT_NEW = 4, 12, (64, 512), \
    (8, 24)
LLAVA_BATCH, LLAVA_TEXT, LLAVA_NEW = 2, 512, 16
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW, WHISPER_CACHE = 8, 64, 32, 96
WHISPER_CPU_STEPS = 8
# Phase 14: the LLM training stack (module docstring).  (G) qwen3-8b's
# widths cut to LT_QWEN_LAYERS, LT_QWEN_STEPS steps of LT_BATCH x LT_SEQ
# tokens; (H) one step per family in LT_FAMILIES, reduced, f32, card
# against the CPU; (I) mamba2-370m uncut, LT_MAMBA_STEPS steps, then
# LT_RESUME_STEPS from a checkpoint; (J) examples/train_llm.py's default
# model (LT_SMALL) and schedule; (K) the launcher.
LT_BATCH, LT_SEQ = 8, 1024
LT_QWEN_LAYERS, LT_QWEN_STEPS, LT_QWEN_LR, LT_QWEN_WARMUP = 8, 20, 3e-4, 5
LT_FAMILIES = ("qwen3_8b", "granite_moe_1b_a400m", "mamba2_370m",
               "jamba_1_5_large_398b", "llava_next_34b", "whisper_base")
LT_CPU_BATCH, LT_CPU_SEQ = 2, 64
LT_MAMBA_STEPS, LT_RESUME_STEPS, LT_MAMBA_LR, LT_MAMBA_WARMUP = 10, 2, \
    3e-4, 2
LT_SMALL = dict(n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
                d_ff=1408, vocab=32768)
LT_SMALL_STEPS, LT_SMALL_SEQ, LT_SMALL_LR, LT_SMALL_WARMUP = 300, 256, \
    6e-4, 50
# The drop of tests/test_system.py::test_loss_decreases: the mean of the
# last 5 losses at least this far below the first 5's.
LT_SMALL_MARGIN = 0.3
# Phase 15: fleet meshes (module docstring).  (L)-(P) on MESH_WORLD ranks,
# MESH_PLANTS plants a data shard (a group a shard in (P)); (Q) one NCCL
# rank.  REAL (M) is held to the unsharded engine within MESH_REAL_RTOL.
MESH_WORLD, MESH_PLANTS, MESH_REAL_RTOL = 4, 1024, 1e-6
Q_BACKEND = "nccl"
# Phase 16: the sharded LLM train step (module docstring).  (R)-(T) on
# TM_WORLD ranks, TM_STEPS steps of launch.steps' default AdamW schedule
# (warmup 100: learning rates 3e-6, 6e-6, 9e-6, so an update's noise stays
# far below TM_PARAM_TOL), each held to the unsharded step on this card.
TM_WORLD, TM_STEPS, TM_QWEN_LAYERS = 4, 3, 2
TM_RUNS = (("R_qwen3_8b_widths_f32", QWEN_ARCH, "float32", (2, 2), 4, 1024),
           ("R_qwen3_8b_widths_bf16", QWEN_ARCH, "bfloat16", (2, 2), 4, 1024),
           ("S_granite_moe_bf16", GRANITE_ARCH, "bfloat16", (1, 4), 4, 512),
           ("T_mamba2_bf16", MAMBA_ARCH, "bfloat16", (4, 1), 8, 512))
TM_RTOL, TM_PARAM_TOL = 1e-5, 1e-4
TM_LAUNCH_STEPS = 5
# chip_mesh.py's phase 16 on four cards: qwen3-8b uncut on (1, 4), one
# rank per card over NCCL, at lr 3e-4 (warmup 1), so the loss falls.
TM_UNCUT = ("qwen3_8b_uncut_bf16", QWEN_ARCH, "bfloat16", (1, 4), 8, 1024)
TM_UNCUT_LR = 3e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps):
    """Mean time per call of ``fn`` over ``reps`` back-to-back calls, from
    CUDA events: the device's time, or the host's time to issue a call when
    that is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# The lead-in each profiler session opens with (see device_events): LEAD_IN
# launches of PyTorch's spin kernel, a name no measured call launches.
LEAD_IN, LEAD_IN_KERNEL = 64, "spin_kernel"
PROFILE_TRIES = 3


def _profile_session(fn):
    """One torch.profiler session (CPU and CUDA activities) around ``fn``,
    synchronised before it closes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def device_events(fn, raw=None, expect=None):
    """(name, µs) of every device-side event (kernels, copies) while ``fn``
    runs, from torch.profiler (CUPTI).  ``raw``, when given, receives the
    device records at the two stages below ``prof.events()``: the names of
    the raw kineto results' device events (``"kineto"``) and of the entries
    of the chrome trace kineto writes (``"trace"``).  ``expect``, when
    given, maps a kernel's name to the records ``fn`` must leave: a session
    that lost some is taken again (``fn`` run again), up to PROFILE_TRIES
    sessions; the caller checks the last.

    Two losses of device records, both already in kineto's raw results, on
    an H100 (PERF.md, Findings).  Once a process has opened one profiler
    session and then run device work or idled for some tens of seconds,
    every later session loses the records of its first few device ops,
    PyTorch's own copies and kernels as much as the port's; it is the same
    with the kernels linked against a static or the shared CUDA runtime,
    with CUPTI torn down or kept between sessions, and after idle host time
    at the session's start.  So the session opens with a lead-in of LEAD_IN
    spin kernels, synchronised, which takes that loss, and their records
    are left out of what is returned (by name: the host's and the device's
    clocks in the trace disagree by more than a short call lasts).  Apart
    from that, a session now and then loses a run of records in its
    middle; an empty session just before it (as phase 5 of earlier
    versions opened with) made that rare, so one runs first; where it
    still strikes (249 of a decode step's 252 `qmatmul` records, seen
    once), ``expect`` takes the session again."""
    for _ in range(PROFILE_TRIES):
        events = _device_events_once(fn, raw)
        if not expect or not events or all(
                sum(name in n for n, _ in events) == count
                for name, count in expect.items()):
            break
    return events


def _device_events_once(fn, raw):
    _profile_session(lambda: None)

    def lead_then_fn():
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()

    prof = _profile_session(lead_then_fn)
    if raw is not None:
        import tempfile
        raw["kineto"] = [
            e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and LEAD_IN_KERNEL not in e.name()]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        raw["trace"] = [e.get("name", "") for e in trace.get("traceEvents", [])
                        if e.get("cat") in ("kernel", "gpu_memcpy",
                                            "gpu_memset")
                        and LEAD_IN_KERNEL not in e.get("name", "")]
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and LEAD_IN_KERNEL not in e.name]


def kernel_ms(fn, reps, name):
    """Mean device time of the kernel called ``name`` over ``reps`` calls of
    ``fn`` (None when the profiler records no such kernel)."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()

    times = [us for n, us in device_events(calls) if name in n]
    return sum(times) / len(times) / 1e3 if times else None


def graph_ms(fn, reps):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's cost to issue a call drops out and
    every kernel a call launches counts (a library call may launch more
    than one)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, op_seconds):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (max(t_bytes, op_seconds) * 1e3,
            "bytes" if t_bytes >= op_seconds else "operations")


def fused_bound(x, prepared):
    layers = prepared.layers
    ops_s = sum(2 * x.shape[0] * l.w.shape[0] * l.w.shape[1]
                / (INT8_OPS_PER_S if l.w.dtype == torch.int8
                   else F32_FLOPS_PER_S) for l in layers)
    moved = nbytes(x) + x.shape[0] * prepared.n_out * 4 + sum(
        nbytes(l.w, l.bias, l.scale) for l in layers)
    return bound(moved, ops_s)


def _weight(p):
    return p["qw"] if "qw" in p else p["w"]


def grouped_bound(x, out, plan, arrays):
    """Bytes: each group's true input lanes of x, the target lanes its
    epilogue reads (a score group's first n_out lanes; none for a logits
    group, kind 0) and every arena read once, the payload written once.
    Operations: each group's true-width products at its type's peak (int8 on
    the tensor cores' int8 rate, f32 otherwise)."""
    m = x.shape[1]
    ops_s = sum(2 * m * _weight(p).shape[0] * _weight(p).shape[1]
                / (INT8_OPS_PER_S if _weight(p).dtype == torch.int8
                   else F32_FLOPS_PER_S)
                for stack in arrays["stacks"] for p in stack)
    lanes = sum(k0 + (n_out if kind else 0) for k0, n_out, kind
                in zip(plan.true_k0s, plan.n_outs, plan.kinds))
    arenas = [t for key in ("w", "scale", "bias", "x_scale")
              for t in arrays[key]] + [arrays["meta"]]
    return bound(m * lanes * x.element_size() + nbytes(out, *arenas), ops_s)


def qmatmul_bound(xq, wq, scale, bias):
    m, k = xq.shape
    n = wq.shape[1]
    return bound(nbytes(xq, wq, scale, bias) + m * n * 4,
                 2 * m * k * n / INT8_OPS_PER_S)


def qmatmul_shape_bound(m, k, n):
    """qmatmul_bound of an (m, k) x (k, n) call without a bias."""
    return bound(m * k + k * n + 4 * n + 4 * m * n,
                 2 * m * k * n / INT8_OPS_PER_S)


def sparse_bound(x, w):
    """Bytes: the K blocks of x some tile reads, the nonzero tiles with their
    indices, out.  Operations: the nonzero tiles' products, f32."""
    m = x.shape[0]
    bk, bn = w.block
    x_rows = len(np.unique(w.indices[:, 0])) * bk
    moved = (m * x_rows * x.element_size() + nbytes(
        w.col_values, w.col_rows, w.col_offsets) + m * w.shape[1] * 4)
    return bound(moved, 2 * m * bk * bn * w.nnz_blocks / F32_FLOPS_PER_S)


def _ssd_flops(t, chunk, p, n, last_update):
    """The chunked algorithm's products for one (batch row, head) as a T of
    ``t`` needs them, as (C Bᵀ, the rest): per chunk of l steps the causal
    halves of C Bᵀ (N l (l + 1)) and of (decay ∘ C Bᵀ) x (P l (l + 1)), the
    readout of the carried state (2 l N P, not in the first chunk: the
    state is 0) and the state update (2 l N P; after the last chunk only if
    ``last_update``)."""
    starts = range(0, t, chunk)
    cb = rest = 0
    for i, t0 in enumerate(starts):
        l = min(chunk, t - t0)
        cb += n * l * (l + 1)
        rest += p * l * (l + 1)
        rest += 2 * l * n * p * ((i > 0) + (last_update
                                             or i < len(starts) - 1))
    return cb, rest


def ssd_bound(x, dt, a, b, c, y, state, chunk):
    """The redesigned kernel's work: its chunk (ssd_scan.KERNEL_CHUNK), the
    state update after the last chunk too (the final state is an output).
    On f32 inputs every product is three tensor-core passes (3xTF32) at the
    TF32 rate.  On bf16 x, B and C their lo parts are 0: C Bᵀ is one
    bf16 x bf16 product, counted at the bf16 rate, and the other three
    products (one f32 operand each) two TF32 passes.  Bytes: every input
    read once in its own type, y and the state written once."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    cb, rest = (f * bsz * h for f in _ssd_flops(t, chunk, p, n, True))
    if x.dtype == torch.bfloat16:
        op_seconds = cb / BF16_FLOPS_PER_S + 2 * rest / TF32_FLOPS_PER_S
    else:
        op_seconds = 3 * (cb + rest) / TF32_FLOPS_PER_S
    return bound(nbytes(x, dt, a, b, c, y, state), op_seconds)


def ssd_cuda_core_bound(x, dt, a, b, c):
    """The earlier CUDA-core kernel's bound, kept so that its rows compare
    with the tensor-core kernel's: chunk 128, no state update after the
    last chunk, f32 products at the CUDA-core rate; f32 inputs read and y
    written once."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    flops = sum(_ssd_flops(t, 128, p, n, False)) * bsz * h
    return bound(4 * (x.numel() + dt.numel() + a.numel() + b.numel()
                      + c.numel() + x.numel()), flops / F32_FLOPS_PER_S)


def upcast(tree):
    """A param tree with its floating leaves in f32 (bf16 is exact in f32)."""
    return {k: upcast(v) if isinstance(v, dict)
            else v.float() if v.is_floating_point() else v
            for k, v in tree.items()}


def tree_to(tree, device):
    """A param tree with every leaf copied to ``device``."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def rel_l2(got, want):
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# The kernels whose launches the main-path runs count (module integers of
# repro_torch.kernels: reset before a run, read after it).
COUNTED = ("fused_mlp", "qmatmul", "grouped_mlp", "sparse_matmul", "ssd_scan")


def reset_counts():
    from repro_torch.kernels import fused_mlp, qmatmul, sparse_matmul, ssd_scan
    fused_mlp.launches = qmatmul.launches = 0
    fused_mlp.grouped_launches = 0
    sparse_matmul.launches = ssd_scan.launches = 0


def read_counts():
    from repro_torch.kernels import fused_mlp, qmatmul, sparse_matmul, ssd_scan
    return {"fused_mlp": fused_mlp.launches, "qmatmul": qmatmul.launches,
            "grouped_mlp": fused_mlp.grouped_launches,
            "sparse_matmul": sparse_matmul.launches,
            "ssd_scan": ssd_scan.launches}


def expect(**counts):
    return {k: counts.get(k, 0) for k in COUNTED}


def drive_grouped(engine, readings):
    """Every cycle of ``readings`` through a GroupedStreamEngine: (verdicts,
    each verdict step's outputs by group)."""
    outs, verdicts = [], []
    for c in range(len(readings)):
        got = engine.ingest(readings[c])
        if got:
            verdicts.extend(got)
            outs.append({k: v.copy() for k, v in
                         engine.last_outputs.items()})
    return verdicts, outs


def same_outputs(run, scheme, got_steps, want_steps):
    """Two runs' grouped outputs, step by step: the SINT classifier's logits
    bit-equal, every other group within the REAL tolerance."""
    if len(got_steps) != len(want_steps):
        raise AssertionError(f"{run}: {len(got_steps)} vs "
                             f"{len(want_steps)} steps of outputs")
    for got, want in zip(got_steps, want_steps):
        for name in GROUPS:
            a, b = got[name], want[name]
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"{run}: bad {name} output "
                                     f"{a.shape}")
            if scheme == "SINT" and name == "clf":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=TOL["REAL"],
                                           atol=TOL["REAL"])


def train_phase(dev, smi, readings, grouped_readings, replay):
    """Phase 11 (module docstring): (q) the four trainers at the full data
    scale, (r) each against the CPU over CHECK_EPOCHS epochs, (s) the trained
    classifier and autoencoder exported and verified against the card's
    engine, (t) the trained four-head fleet.  Returns the main-path launch
    counts, fused_mlp's largest difference from its plain version at this
    path's shapes, and each trainer's wall seconds."""
    import tempfile
    from repro_torch.codegen import export_st, verify_export, window_starts
    from repro_torch.codegen.verify import run_engine
    from repro_torch.configs import msf_detector as spec
    from repro_torch.core import porting, quantize
    from repro_torch.kernels import fused_mlp, ops, ref
    from repro_torch.serving import GroupedStreamEngine, ModelGroup
    from repro_torch.sim import (SCENARIOS, ClassifierHead, build_dataset,
                                 recalibrate_threshold, train_autoencoder,
                                 train_detector, train_forecaster,
                                 train_one_class)

    launches = dict.fromkeys(COUNTED, 0)
    fused_err = 0.0
    walls = {}
    x, y = build_dataset(**TRAIN_DATA)
    n_normal = int(np.sum(y == 0))
    trainers = {"clf": train_detector, "ae": train_autoencoder,
                "mg": train_one_class, "fc": train_forecaster}
    # fused_mlp launches besides one per validation epoch: the test split
    # (classifier); the calibration and attack scores (score heads); the
    # margin center's initial embedding.
    extra = {"clf": 1, "ae": 2, "mg": 3, "fc": 2}
    kw = dict(batch_size=TRAIN_BATCH, lr=TRAIN_LR, patience=TRAIN_PATIENCE)

    def split(name):
        """(training, validation) rows of a trainer: all windows for the
        classifier, the benign ones for a score head."""
        n = len(x) if name == "clf" else n_normal
        return int(0.7225 * n), int(0.1275 * n)

    def add(counts):
        for k in COUNTED:
            launches[k] += counts[k]

    def check_fused(what, model, params, rows, exact):
        """fused_mlp against its plain version on ``rows`` (host windows,
        cut to the model's input as its head's prepare cuts them).  REAL
        within 1e-5 of (1 + the largest output), verify_export's REAL
        contract: trained logits reach the hundreds, and f32 sums taken in
        another order part by ulps of their largest partial sums."""
        nonlocal fused_err
        stack = ops.dense_stack(model, params)
        xs = torch.from_numpy(np.ascontiguousarray(
            rows[:, :model.input_shape[0]], np.float32)).to(dev)
        got = fused_mlp.fused_mlp(xs, ops.prepare_fused(stack))
        want = ref.fused_mlp_ref(xs, stack)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = (torch.equal(got, want) if exact else
              err <= TOL["REAL"] * (1.0 + float(want.abs().max())))
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"fused_mlp {what} M={len(rows)}: kernel "
                                 f"disagrees with the plain version (max abs "
                                 f"err {err})")
        fused_err = max(fused_err, err)
        return err

    # -- (q) full training on the card -------------------------------------
    trained = {}
    for name, train in trainers.items():
        reset_counts()
        t0 = time.perf_counter()
        model, res = train(x, y, epochs=TRAIN_EPOCHS, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        add(counts)
        walls[name] = wall
        epochs = len(res.history)
        n_train, n_val = split(name)
        steps = epochs * len(range(0, n_train - TRAIN_BATCH + 1, TRAIN_BATCH))
        first, last = res.history[0][1], res.history[-1][1]
        if not (np.isfinite([l for _, l, _ in res.history]).all()
                and last < first):
            raise AssertionError(f"(q) {name}: train loss {first} -> {last}")
        if counts != expect(fused_mlp=epochs + extra[name]):
            raise AssertionError(f"(q) {name}: launches {counts}, expected "
                                 f"{epochs} validation epochs + "
                                 f"{extra[name]} fused_mlp")
        row = {"phase": "train", "run": f"q_{name}", "nvidia_smi": smi,
               "windows": len(x), "train_rows": n_train, "val_rows": n_val,
               "epochs_run": epochs, "steps": steps,
               "first_train_loss": first, "last_train_loss": last,
               "wall_s": wall, "steps_per_s": steps / wall,
               "launches": counts}
        # The path's fused_mlp shapes: the validation split (REAL f32_tile).
        normal = x if name == "clf" else x[y == 0]
        row["fused_vs_plain_val_err"] = check_fused(
            f"trained {name} validation split", model, res.params,
            normal[n_train:n_train + n_val], exact=False)
        if name == "clf":
            row.update(best_val_acc=res.best_val_acc, test_acc=res.test_acc)
            if not res.test_acc > 0.70:
                raise AssertionError(f"(q) clf: test_acc {res.test_acc}")
        else:
            row.update(best_val=(res.best_val_mse if name == "ae"
                                 else res.best_val),
                       threshold=res.threshold, calib_fpr=res.calib_fpr,
                       target_fpr=res.head.target_fpr,
                       test_detection_rate=res.test_detection_rate)
            if not res.calib_fpr <= res.head.target_fpr:
                raise AssertionError(f"(q) {name}: calib_fpr {res.calib_fpr}"
                                     f" > {res.head.target_fpr}")
            if name == "ae" and not res.test_detection_rate > 0.5:
                raise AssertionError(f"(q) ae: detection rate "
                                     f"{res.test_detection_rate}")
        trained[name] = (model, res)
        emit(row)

    # One epoch of the classifier under torch.profiler.
    timing = {}

    def one_epoch():
        t0 = time.perf_counter()
        train_detector(x, y, epochs=1, device=dev, **kw)
        torch.cuda.synchronize()
        timing["wall"] = time.perf_counter() - t0

    events = device_events(one_epoch)
    by_name = {}
    for ev, us in events:
        by_name[ev] = by_name.get(ev, 0.0) + us
    busy_us = sum(by_name.values())
    n_train, _ = split("clf")
    emit({"phase": "train", "run": "q_profile_clf_epoch", "nvidia_smi": smi,
          "steps": n_train // TRAIN_BATCH, "device_events": len(events),
          "fused_mlp_kernels": sum("fused_mlp_kernel" in n for n, _ in
                                   events),
          "wall_ms": timing["wall"] * 1e3, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e6 / timing["wall"],
          "top_device_us": sorted(by_name.items(),
                                  key=lambda kv: -kv[1])[:10]})

    # -- (r) card against CPU, CHECK_EPOCHS epochs, TF32 flag on -----------
    torch.backends.cuda.matmul.allow_tf32 = True
    for name, train in trainers.items():
        _, card = train(x, y, epochs=CHECK_EPOCHS, device=dev, **kw)
        _, cpu = train(x, y, epochs=CHECK_EPOCHS, device="cpu", **kw)
        if not torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("(r): training did not restore the TF32 "
                                 "flag")
        _, n_val = split(name)
        loss_err = max(abs(a[1] - b[1]) / abs(b[1])
                       for a, b in zip(card.history, cpu.history))
        val_err = max(abs(a[2] - b[2]) / abs(b[2])
                      for a, b in zip(card.history, cpu.history))
        largest = max(float(v.abs().max()) for p in cpu.params.values()
                      for v in p.values())
        param_err = max(float((card.params[u][k].cpu() - v).abs().max())
                        for u, p in cpu.params.items()
                        for k, v in p.items()) / largest
        val_ok = (all(abs(a[2] - b[2]) <= 1.0 / n_val + 1e-6
                      for a, b in zip(card.history, cpu.history))
                  if name == "clf" else val_err <= CARD_CPU_TOL)
        if (len(card.history) != len(cpu.history) or not val_ok
                or not loss_err <= CARD_CPU_TOL
                or not param_err <= CARD_CPU_TOL):
            raise AssertionError(
                f"(r) {name}: card against CPU: losses {loss_err}, "
                f"validation {val_err}, params {param_err} (histories "
                f"{card.history} / {cpu.history})")
        row = {"phase": "train", "run": f"r_{name}_card_vs_cpu",
               "nvidia_smi": smi, "epochs": CHECK_EPOCHS,
               "train_loss_rel_err": loss_err, "val_metric_rel_err": val_err,
               "params_err_of_largest": param_err,
               "card_history": card.history, "cpu_history": cpu.history}
        if name != "clf":
            row.update(threshold=[card.threshold, cpu.threshold],
                       calib_fpr=[card.calib_fpr, cpu.calib_fpr],
                       test_detection_rate=[card.test_detection_rate,
                                            cpu.test_detection_rate])
        emit(row)
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- (s) the trained deployment: port, SINT, calibrate, export, serve --
    calib = quantize.calibration_samples(x, y, device=dev)
    steps = len(window_starts(N_CYCLES, spec.WINDOW, spec.STRIDE))
    names = list(SCENARIOS)
    scenario_of = [names[(s % N_PLANTS) % len(names)]
                   for s in range(readings.shape[1])]
    for name, run in (("clf", "s_trained_sint_classifier_export"),
                      ("ae", "s_trained_sint_autoencoder_export")):
        model, res = trained[name]
        with tempfile.TemporaryDirectory() as tmp:
            model, params = porting.port_mlp(model, res.params, tmp)
        params = quantize.quantize_params(model, params, "SINT",
                                          calibration=calib)
        if name == "clf":
            head = ClassifierHead()
        else:
            head, _ = recalibrate_threshold(model, params, res.calib_windows,
                                            device=dev)
        export = export_st(model, params, head=head, name=run.upper(),
                           normalize=(spec.NORM_MEAN, spec.NORM_STD))
        reset_counts()
        out = verify_export(export, model, params, head, readings,
                            spec.STRIDE, streams=replay, device=dev)
        counts = read_counts()
        add(counts)
        if counts != expect(fused_mlp=steps):
            raise AssertionError(f"{run}: launches {counts}, expected "
                                 f"{steps} fused_mlp")
        if (out["windows"] != len(replay) * steps or out["failures"]
                or out["borderline"] or out["max_body_diff"] != 0.0
                or (name == "clf" and out["max_engine_diff"] != 0.0)
                or not 0 < out["anomalous"] < out["engine_windows"]):
            raise AssertionError(f"{run}: {out}")
        # Alarms per scenario, from the same engine's verdicts.
        reset_counts()
        verdicts = run_engine(model, params, readings, stride=spec.STRIDE,
                              head=head, device=dev)
        add(read_counts())
        if sum(v.pred != 0 for v in verdicts) != out["anomalous"]:
            raise AssertionError(f"{run}: a second serve of the fleet "
                                 "decided otherwise")
        alarms = {}
        for v in verdicts:
            sc = SCENARIOS[scenario_of[v.stream]]
            a = alarms.setdefault(sc.name, {
                "onset": sc.onset, "windows": 0, "alarms": 0,
                "alarms_before_onset": 0, "first_alarm_after_onset": None})
            a["windows"] += 1
            if v.pred == 0:
                continue
            a["alarms"] += 1
            if sc.onset is None or v.cycle < sc.onset:
                a["alarms_before_onset"] += 1
            elif (a["first_alarm_after_onset"] is None
                  or v.cycle < a["first_alarm_after_onset"]):
                a["first_alarm_after_onset"] = v.cycle
        # The SINT stack's fused_mlp on the windows it was calibrated on.
        exact_err = check_fused(f"trained SINT {name}", model, params,
                                res.calib_windows if name == "ae"
                                else x[y == 0], exact=True)
        emit({"phase": "train", "run": run, "nvidia_smi": smi,
              "scheme": export.scheme, "head": export.head_name,
              "threshold": getattr(head, "threshold", None),
              "st_lines": len(export.text.splitlines()),
              "plants_served": readings.shape[1],
              "plants_replayed": len(replay), "steps": steps,
              "launches": counts, "fused_vs_plain_err": exact_err, **out,
              "alarms_by_scenario": alarms})

    # -- (t) the trained four-head fleet -----------------------------------
    groups = []
    for name in GROUPS:
        model, res = trained[name]
        params = quantize.quantize_params(
            model, res.params, "SINT", calibration=quantize.calibration_samples(
                x[:, :model.input_shape[0]], y, device=dev))
        head = ClassifierHead()
        if name != "clf":
            head, _ = recalibrate_threshold(model, params, res.calib_windows,
                                            head=res.head, device=dev)
        groups.append(ModelGroup(name, model, params, readings.shape[1],
                                 head))
    engine = GroupedStreamEngine(groups, megakernel=True, device=dev)
    engine.warmup()
    reset_counts()
    verdicts, outs = drive_grouped(engine, grouped_readings)
    counts = read_counts()
    add(counts)
    fleet_steps = engine.stats.steps
    if (fleet_steps != steps or counts != expect(grouped_mlp=fleet_steps)
            or engine.mega_reason is not None):
        raise AssertionError(f"(t): {fleet_steps} steps, launches {counts}, "
                             f"{engine.mega_reason}")
    plain = GroupedStreamEngine(groups, backend="ref", device=dev)
    plain.warmup()
    plain_verdicts, plain_outs = drive_grouped(plain, grouped_readings)
    if [v.pred for v in verdicts] != [v.pred for v in plain_verdicts]:
        raise AssertionError("(t): preds differ from the plain path")
    same_outputs("(t)", "SINT", outs, plain_outs)
    anomalous = {name: int(sum(v.pred for v in verdicts if v.group == name))
                 for name in GROUPS}
    per_group = readings.shape[1] * steps
    for name in ("clf", "ae"):
        if not 0 < anomalous[name] < per_group:
            raise AssertionError(f"(t) {name}: {anomalous[name]} anomalous "
                                 f"of {per_group}")
    stats = engine.stats
    emit({"phase": "train", "run": "t_trained_sint_fleet_mega",
          "nvidia_smi": smi, "streams": engine.n_streams,
          "groups": len(groups), "cycles": stats.cycles, "steps": fleet_steps,
          "windows": stats.windows, "windows_per_s": stats.windows_per_s(),
          "p99_ms": stats.latency_p(99) * 1e3, "launches": counts,
          "thresholds": {g.name: getattr(g.head, "threshold", None)
                         for g in groups},
          "anomalous_verdicts": anomalous, "windows_per_group": per_group})
    return launches, fused_err, walls


def tree_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    return [tree]


def percentiles(xs):
    xs = np.asarray(xs)
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "max": float(xs.max())}


def counted_into(launches, fn):
    """``fn()`` with every count set to 0 just before it and read just
    after: (its result, the counts), the counts added to ``launches``."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    for k in COUNTED:
        launches[k] += counts[k]
    return out, counts


def check_counts(run, counts, want):
    if counts != want:
        raise AssertionError(f"{run}: launches {counts}, expected {want}")


def by_uid(done):
    return {c.uid: np.asarray(c.tokens) for c in done}


def same_tokens(run, got, want):
    if sorted(got) != sorted(want) or any(
            not np.array_equal(got[u], want[u]) for u in want):
        bad = [u for u in want if not np.array_equal(got.get(u), want[u])]
        raise AssertionError(f"{run}: tokens differ from the run it is held "
                             f"to for requests {bad}")


class PlcTask:
    """A PLC's primary task, one step per scan cycle: a PI loop holding a
    tank level at its set point (the control task of runs (v) and (E))."""

    def __init__(self):
        self.level, self.integral, self.cycles = 0.5, 0.0, 0

    def __call__(self):
        err = 0.6 - self.level
        self.integral += err * SCAN_CYCLE_S
        u = 0.8 * err + 0.2 * self.integral
        self.level += SCAN_CYCLE_S * (u - 0.1 * self.level)
        self.cycles += 1


def llm_phase(dev, smi):
    """Phase 12 (module docstring): runs (u)-(z), the dense decoder and its
    MoE twin at full width through the wave Engine, the CyclicDecoder and
    the ContinuousEngine, and mamba2's continuous slots.  Returns the
    launch counts of the runs."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import get_model
    from repro_torch.serving import (ContinuousEngine, CyclicDecoder, Engine,
                                     Request)

    launches = dict.fromkeys(COUNTED, 0)
    gen = torch.Generator(device=dev)

    def counted(fn):
        return counted_into(launches, fn)

    def emit_row(run, row):
        emit({"phase": "llm", "run": run, "nvidia_smi": smi, **row})

    # -- (u) qwen3-8b, bf16 SINT, wave Engine: the slice's main path -------
    qcfg = get_config(QWEN_ARCH).with_(quant="SINT")
    per_forward = 7 * qcfg.n_layers          # q, k, v, o, gate, up, down
    gen.manual_seed(19)
    t0 = time.perf_counter()
    params = get_model(qcfg).init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = nbytes(*tree_tensors(params)) / 1e9
    prompts = np.random.default_rng(19).integers(
        0, qcfg.vocab, (LLM_BATCH, LLM_PROMPT))
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=LLM_NEW)
            for i in range(LLM_BATCH)]
    api = get_model(qcfg)
    engine = Engine(api, params, batch_slots=LLM_BATCH, cache_len=LLM_CACHE)
    engine.serve([Request(uid=0, prompt=prompts[0, :64], max_new_tokens=2)])
    torch.cuda.reset_peak_memory_stats()
    done, counts = counted(lambda: engine.serve(reqs))
    check_counts("u", counts, expect(qmatmul=per_forward * LLM_NEW))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    logits = engine.last_prefill_logits.clone()
    tokens = np.stack([c.tokens for c in done])
    if tokens.shape != (LLM_BATCH, LLM_NEW) \
            or logits.shape != (LLM_BATCH, qcfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"u: tokens {tokens.shape}, logits "
                             f"{tuple(logits.shape)}")
    del engine
    plain = Engine(get_model(qcfg, backend={"qmatmul": "ref"}), params,
                   batch_slots=LLM_BATCH, cache_len=LLM_CACHE)
    plain_done = plain.serve(reqs)
    plain_logits = plain.last_prefill_logits
    if not torch.equal(logits, plain_logits) or not np.array_equal(
            tokens, np.stack([c.tokens for c in plain_done])):
        raise AssertionError(
            f"u: the kernel path differs from the same path with plain "
            f"qmatmul (logits off by "
            f"{float((logits - plain_logits).abs().max())})")
    del plain, plain_logits
    emit_row("u_qwen3_8b_bf16_sint_wave", {
        "model": qcfg.name, "dtype": "bfloat16", "quant": "SINT",
        "layers": qcfg.n_layers, "d_model": qcfg.d_model,
        "heads": [qcfg.n_heads, qcfg.n_kv_heads, qcfg.d_head],
        "d_ff": qcfg.d_ff, "vocab": qcfg.vocab, "batch": LLM_BATCH,
        "prompt": LLM_PROMPT, "new_tokens": LLM_NEW, "cache_len": LLM_CACHE,
        "init_s": init_s, "param_gb": param_gb, "peak_mem_gb": peak_gb,
        "prefill_s": done[0].prefill_s,
        "prefill_tok_per_s": LLM_BATCH * LLM_PROMPT / done[0].prefill_s,
        "decode_s": done[0].decode_s,
        "decode_tok_per_s": LLM_BATCH * (LLM_NEW - 1) / done[0].decode_s,
        "launches": counts, "qmatmul_per_forward": per_forward,
        "equal_to_plain_qmatmul_path": True,
        "plain_prefill_s": plain_done[0].prefill_s,
        "plain_decode_s": plain_done[0].decode_s,
        "first_tokens": tokens[:, :8].tolist()})

    # One prefill and one decode step of (u) under torch.profiler: where
    # their time goes.
    batch = {"tokens": torch.from_numpy(prompts).to(dev)}
    cache, lg = api.prefill(params, batch, LLM_CACHE)
    torch.cuda.synchronize()
    timing = {}

    def one_prefill():
        t0 = time.perf_counter()
        api.prefill(params, batch, LLM_CACHE)
        torch.cuda.synchronize()
        timing["wall"] = time.perf_counter() - t0

    events = device_events(one_prefill,
                           expect={"qmatmul_kernel": per_forward})
    d, kv, ff = qcfg.d_model, qcfg.n_kv_heads * qcfg.d_head, qcfg.d_ff
    shapes = ((d, d), (d, kv), (d, kv), (d, d), (d, ff), (d, ff), (ff, d))

    def profile_row(run, events, wall, m):
        """Busy share, device time by kernel and qmatmul's share against
        its bound (the layer's seven projections at M = m, every layer)."""
        by_name = {}
        for name, us in events:
            by_name[name] = by_name.get(name, 0.0) + us
        busy_us = sum(by_name.values())
        q_us = [us for name, us in events if "qmatmul_kernel" in name]
        if events and len(q_us) != per_forward:
            raise AssertionError(f"profile {run}: {len(q_us)} qmatmul "
                                 f"kernels, expected {per_forward}")
        emit({"phase": "profile", "run": run, "nvidia_smi": smi,
              "kernel": "qmatmul_kernel", "kernel_launches": len(q_us),
              "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
              "device_busy_share": busy_us / 1e6 / wall,
              "qmatmul_ms": sum(q_us) / 1e3,
              "qmatmul_share_of_busy": (sum(q_us) / busy_us if busy_us
                                        else None),
              "qmatmul_bound_ms": qcfg.n_layers * sum(
                  qmatmul_shape_bound(m, k, n)[0] for k, n in shapes),
              "device_events": len(events),
              "top_device_us": sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:15]})

    profile_row("u_qwen3_8b_prefill", events, timing["wall"],
                LLM_BATCH * LLM_PROMPT)
    cur = torch.argmax(lg[:, -1], dim=-1)[:, None]
    api.decode(params, cache, {"tokens": cur}, LLM_PROMPT)
    torch.cuda.synchronize()

    def one_step():
        t0 = time.perf_counter()
        api.decode(params, cache, {"tokens": cur}, LLM_PROMPT + 1)
        torch.cuda.synchronize()
        timing["step"] = time.perf_counter() - t0

    profile_row("u_qwen3_8b_decode_step",
                device_events(one_step,
                              expect={"qmatmul_kernel": per_forward}),
                timing["step"], LLM_BATCH)
    del batch, events, cache, lg

    # -- (v) §6.3: the same model decoding in CYCLIC_SEGMENTS cycles ----------
    control_task = PlcTask()
    one = {"tokens": torch.from_numpy(prompts[:1]).to(dev)}

    def cyclic():
        cache, lg = api.prefill(params, one, LLM_CACHE)
        first = torch.argmax(lg[:, -1], dim=-1)
        cd = CyclicDecoder(qcfg, params, n_segments=CYCLIC_SEGMENTS,
                           batch=1, cache_len=LLM_CACHE)
        t0 = time.perf_counter()
        toks, _, stats = cd.decode_tokens(cache, first, LLM_PROMPT,
                                          LLM_NEW - 1,
                                          control_task=control_task)
        return ([int(first[0])] + toks, stats, cd.bounds,
                time.perf_counter() - t0)

    (ctoks, stats, bounds, cyc_s), counts = counted(cyclic)
    check_counts("v", counts, expect(qmatmul=per_forward * LLM_NEW))
    wave1 = Engine(api, params, batch_slots=1, cache_len=LLM_CACHE).serve(
        [reqs[0]])[0].tokens
    if not np.array_equal(np.asarray(ctoks), wave1):
        raise AssertionError(f"v: cyclic tokens {ctoks} differ from the "
                             f"batch-1 wave engine's {wave1.tolist()}")
    if control_task.cycles != len(bounds) * (LLM_NEW - 1) \
            or len(stats.cycle_times_s) != control_task.cycles:
        raise AssertionError(f"v: {control_task.cycles} control steps, "
                             f"{len(stats.cycle_times_s)} cycle times")
    ct = stats.cycle_times_s
    emit_row("v_qwen3_8b_sint_cyclic", {
        "model": qcfg.name, "segments": bounds, "tokens": len(ctoks),
        "cycles": len(ct), "cycle_s": percentiles(ct),
        "scan_cycle_s": SCAN_CYCLE_S,
        "cycles_over_scan_cycle": int(sum(c > SCAN_CYCLE_S for c in ct)),
        "decode_s": cyc_s, "tok_per_s": (LLM_NEW - 1) / cyc_s,
        "launches": counts, "equal_to_batch1_wave": True,
        "control_level": control_task.level})
    del params, api

    # -- (w) qwen3-8b widths, two layers, f32 REAL: card against the CPU ----
    wcfg = get_config(QWEN_ARCH).with_(n_layers=WIDTH_LAYERS,
                                       dtype=torch.float32)
    cpu_params = get_model(wcfg).init(torch.Generator().manual_seed(23),
                                      device="cpu")
    card_params = tree_to(cpu_params, dev)
    wprompts = np.random.default_rng(23).integers(
        0, wcfg.vocab, (WIDTH_BATCH, WIDTH_PROMPT))

    def greedy(p, device):
        """Prefill and WIDTH_STEPS greedy decode steps: each step's logits
        (on the host) and tokens."""
        wapi = get_model(wcfg)
        cache, lg = wapi.prefill(p, {"tokens": torch.from_numpy(
            wprompts).to(device)}, WIDTH_PROMPT + WIDTH_STEPS)
        outs, toks = [lg[:, -1].cpu()], []
        for step in range(WIDTH_STEPS):
            cur = torch.argmax(lg[:, -1], dim=-1)
            toks.append(cur.cpu().numpy())
            cache, lg = wapi.decode(p, cache, {"tokens": cur[:, None]},
                                    WIDTH_PROMPT + step)
            outs.append(lg[:, -1].cpu())
        return torch.stack(outs), np.stack(toks)

    t0 = time.perf_counter()
    card_logits, card_toks = greedy(card_params, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_logits, cpu_toks = greedy(cpu_params, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    w_err = float((card_logits - cpu_logits).abs().max()
                  / cpu_logits.abs().max())
    if w_err > WIDTH_TOL or not np.array_equal(card_toks, cpu_toks):
        raise AssertionError(f"w: logits {w_err} of the largest from the "
                             f"CPU (tolerance {WIDTH_TOL}), tokens equal "
                             f"{np.array_equal(card_toks, cpu_toks)}")
    emit_row("w_qwen3_8b_widths_f32_card_vs_cpu", {
        "model": wcfg.name, "layers": WIDTH_LAYERS, "batch": WIDTH_BATCH,
        "prompt": WIDTH_PROMPT, "decode_steps": WIDTH_STEPS,
        "logits_max_rel_err": w_err, "tolerance": WIDTH_TOL,
        "tokens_equal": True, "card_s": card_s, "cpu_s": cpu_s,
        "tf32": torch.backends.cuda.matmul.allow_tf32})
    del cpu_params, card_params

    # -- (x), (y) granite-moe, bf16 SINT, continuous slots -----------------
    gcfg = get_config(GRANITE_ARCH).with_(quant="SINT")
    g_forward = 4 * gcfg.n_layers            # q, k, v, o; experts plain
    gen.manual_seed(29)
    gparams = get_model(gcfg).init(gen)
    rng = np.random.default_rng(29)
    lens = rng.integers(CONT_PROMPTS[0], CONT_PROMPTS[1] + 1, CONT_REQUESTS)
    news = rng.integers(CONT_NEW[0], CONT_NEW[1] + 1, CONT_REQUESTS)
    creqs = [Request(uid=i, prompt=rng.integers(0, gcfg.vocab, lens[i]),
                     max_new_tokens=int(news[i]))
             for i in range(CONT_REQUESTS)]

    def continuous(cfg, p, reqs_, backend="auto", cyclic=0, slots=CONT_SLOTS,
                   cache_len=LLM_CACHE):
        eng = ContinuousEngine(get_model(cfg, backend=backend), p,
                               batch_slots=slots, cache_len=cache_len,
                               cyclic_segments=cyclic)
        eng.serve(reqs_[:1])                  # warm-up
        return eng

    def serve_row(eng, done, counts, extra):
        st = eng.last_stats
        n_tok = sum(len(c.tokens) for c in done)
        prefill = sum(c.prefill_s for c in done)
        lat = [c.finished_s for c in done]
        return {"slots": eng.batch_slots, "requests": len(done),
                "steps": st.steps, "admitted": st.admitted,
                "wall_s": st.wall_s, "tokens": n_tok,
                "tok_per_s": n_tok / st.wall_s,
                "admission_prefill_s": prefill,
                "step_ms": (st.wall_s - prefill) / st.steps * 1e3,
                "finished_s": percentiles(lat), "launches": counts, **extra}

    results = {}
    for run, cyclic in (("x_granite_moe_bf16_sint_continuous", 0),
                        ("y_granite_moe_bf16_sint_continuous_cyclic",
                         CYCLIC_SEGMENTS)):
        eng = continuous(gcfg, gparams, creqs, cyclic=cyclic)
        done, counts = counted(lambda: eng.serve(creqs))
        st = eng.last_stats
        check_counts(run, counts,
                     expect(qmatmul=g_forward * (st.admitted + st.steps)))
        got = by_uid(done)
        if cyclic == 0:
            plain = continuous(gcfg, gparams, creqs,
                               backend={"qmatmul": "ref"})
            same_tokens(run, got, by_uid(plain.serve(creqs)))
            held_to = "same engine, qmatmul plain"
        else:
            same_tokens(run, got, results["x_granite_moe_bf16_sint_"
                                          "continuous"])
            held_to = "x"
        if any(len(got[r.uid]) != r.max_new_tokens for r in creqs):
            raise AssertionError(f"{run}: a request stopped short")
        results[run] = got
        emit_row(run, serve_row(eng, done, counts, {
            "model": gcfg.name, "dtype": "bfloat16", "quant": "SINT",
            "layers": gcfg.n_layers, "experts": [gcfg.n_experts,
                                                 gcfg.top_k],
            "prompt_lens": [int(lens.min()), int(lens.max())],
            "new_tokens": [int(news.min()), int(news.max())],
            "cyclic_segments": cyclic, "held_to": held_to,
            "tokens_equal": True}))
        del eng
    del gparams

    # -- (z) mamba2-370m, f32 REAL, continuous slots -----------------------
    mcfg = get_config(MAMBA_ARCH).with_(dtype=torch.float32)
    gen.manual_seed(31)
    mparams = get_model(mcfg).init(gen)
    rng = np.random.default_rng(31)
    slens = rng.integers(SSM_PROMPTS[0], SSM_PROMPTS[1] + 1, SSM_REQUESTS)
    snews = rng.integers(SSM_NEW[0], SSM_NEW[1] + 1, SSM_REQUESTS)
    sreqs = [Request(uid=i, prompt=rng.integers(0, mcfg.vocab, slens[i]),
                     max_new_tokens=int(snews[i]))
             for i in range(SSM_REQUESTS)]
    eng = continuous(mcfg, mparams, sreqs, cache_len=SSM_CACHE)
    done, counts = counted(lambda: eng.serve(sreqs))
    check_counts("z", counts, expect(ssd_scan=mcfg.n_layers * SSM_REQUESTS))
    plain = continuous(mcfg, mparams, sreqs, backend="ref",
                       cache_len=SSM_CACHE)
    same_tokens("z", by_uid(done), by_uid(plain.serve(sreqs)))
    emit_row("z_mamba2_f32_continuous", serve_row(eng, done, counts, {
        "model": mcfg.name, "dtype": "float32", "quant": "REAL",
        "prompt_lens": [int(slens.min()), int(slens.max())],
        "new_tokens": [int(snews.min()), int(snews.max())],
        "held_to": "backend='ref' (sequential SSD)", "tokens_equal": True}))
    return launches


def families_phase(dev, smi):
    """Phase 13 (module docstring): runs (A)-(F), the Jamba hybrid, the
    LLaVA-NeXT VLM and the Whisper encoder-decoder at full width (Jamba's
    depth and experts cut) through the wave Engine with its extras, the
    ContinuousEngine and the CyclicDecoder, each SINT run held to its twin
    with qmatmul plain and each f32 run to the CPU.  Returns the launch
    counts of the runs."""
    import contextlib
    import gc
    import io
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import mamba2
    from repro_torch.models.api import get_model
    from repro_torch.models.vlm import VISION_D
    from repro_torch.serving import (ContinuousEngine, CyclicDecoder, Engine,
                                     Request)

    launches = dict.fromkeys(COUNTED, 0)
    gen = torch.Generator(device=dev)
    plain_q = {"qmatmul": "ref"}

    def counted(fn):
        return counted_into(launches, fn)

    def emit_row(run, row):
        emit({"phase": "families", "run": run, "nvidia_smi": smi, **row})

    def fresh():
        """Free what the last run left and restart the peak count."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9

    def init(cfg, seed):
        """(params on the card, seconds, GB of params)."""
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        params = get_model(cfg).init(gen)
        torch.cuda.synchronize()
        return (params, time.perf_counter() - t0,
                nbytes(*tree_tensors(params)) / 1e9)

    def held_to_plain(run, engine, done, plain, plain_done):
        """Tokens and prefill logits torch.equal to the qmatmul-plain
        twin's."""
        got, want = engine.last_prefill_logits, plain.last_prefill_logits
        if not torch.equal(got, want) or not torch.isfinite(got).all():
            raise AssertionError(
                f"{run}: prefill logits differ from the same path with plain "
                f"qmatmul (by {float((got - want).abs().max())})")
        same_tokens(run, by_uid(done), by_uid(plain_done))

    def profile(run, fn, want):
        """One call of ``fn`` under torch.profiler: wall and device busy
        time, device time by kernel, and each counted kernel's records
        (``want``: name -> records expected) with their time and share."""
        timing = {}

        def timed():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            timing["wall"] = time.perf_counter() - t0

        events = device_events(timed, expect=want)
        by_name = {}
        for name, us in events:
            by_name[name] = by_name.get(name, 0.0) + us
        busy = sum(by_name.values())
        kernels = {}
        for kname, n in want.items():
            us = [u for name, u in events if kname in name]
            if events and len(us) != n:
                raise AssertionError(f"profile {run}: {len(us)} {kname} "
                                     f"records, expected {n}")
            kernels[kname] = {"records": len(us), "ms": sum(us) / 1e3,
                              "share_of_busy": sum(us) / busy if busy
                              else None}
        emit({"phase": "profile", "run": run, "nvidia_smi": smi,
              "wall_ms": timing["wall"] * 1e3, "device_busy_ms": busy / 1e3,
              "device_busy_share": busy / 1e6 / timing["wall"],
              "kernels": kernels, "device_events": len(events),
              "top_device_us": sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:15]})

    def wave_row(cfg, done, batch, prompt, new, extra):
        d = done[0]
        return {"model": cfg.name, "dtype": str(cfg.dtype).split(".")[-1],
                "quant": cfg.quant or "REAL", "layers": cfg.n_layers,
                "d_model": cfg.d_model,
                "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head],
                "d_ff": cfg.d_ff, "vocab": cfg.vocab, "batch": batch,
                "prompt": prompt, "new_tokens": new,
                "prefill_s": d.prefill_s,
                "prefill_tok_per_s": batch * prompt / d.prefill_s,
                "decode_s": d.decode_s,
                "decode_tok_per_s": batch * (new - 1) / d.decode_s,
                "first_tokens": [c.tokens[:8].tolist() for c in done],
                **extra}

    # -- (A) Jamba, bf16 SINT, wave Engine ----------------------------------
    fresh()
    jcfg = get_config(JAMBA_ARCH).with_(
        n_layers=JAMBA_LAYERS, n_experts=JAMBA_EXPERTS, quant="SINT")
    full = get_config(JAMBA_ARCH)
    period = jcfg.attn_period
    n_super = jcfg.n_layers // period
    n_mamba = n_super * (period - 1)
    # in/out_proj per Mamba layer, q/k/v/o, gate/up/down per dense MLP; the
    # experts are plain, as in the reference.
    j_forward = n_super * (2 * (period - 1) + 4 + 3 * (period - period // 2))
    cuts = {"n_layers": [full.n_layers, jcfg.n_layers,
                         "one super-block: attention at position 3, 7 "
                         "Mamba, 4 dense MLP and 4 MoE layers"],
            "n_experts": [full.n_experts, jcfg.n_experts,
                          "all 16 of one super-block's 4 MoE layers are "
                          "4 x 16 x 3 x 8192 x 24576 bf16 = 77.3 GB, "
                          "beyond one card"]}
    jparams, init_s, param_gb = init(jcfg, 41)
    init_peak = peak_gb()
    prompts = np.random.default_rng(41).integers(
        0, jcfg.vocab, (JAMBA_BATCH, JAMBA_PROMPT))
    jreqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=JAMBA_NEW)
             for i in range(JAMBA_BATCH)]
    japi = get_model(jcfg)
    engine = Engine(japi, jparams, batch_slots=JAMBA_BATCH,
                    cache_len=JAMBA_CACHE)
    engine.serve([Request(uid=0, prompt=prompts[0, :64], max_new_tokens=2)])
    torch.cuda.reset_peak_memory_stats()
    done, counts = counted(lambda: engine.serve(jreqs))
    check_counts("A", counts, expect(qmatmul=j_forward * JAMBA_NEW,
                                     ssd_scan=n_mamba))
    peak = peak_gb()
    if np.stack([c.tokens for c in done]).shape != (JAMBA_BATCH, JAMBA_NEW):
        raise AssertionError("A: a request stopped short")
    plain = Engine(get_model(jcfg, backend=plain_q), jparams,
                   batch_slots=JAMBA_BATCH, cache_len=JAMBA_CACHE)
    plain_done = plain.serve(jreqs)
    held_to_plain("A", engine, done, plain, plain_done)
    del engine, plain
    emit_row("A_jamba_bf16_sint_wave", wave_row(
        jcfg, done, JAMBA_BATCH, JAMBA_PROMPT, JAMBA_NEW, {
            "cuts": cuts, "experts": [jcfg.n_experts, jcfg.top_k],
            "ssd": [jcfg.ssm_heads, jcfg.ssm_headdim, jcfg.ssm_state,
                    jcfg.ssm_groups],
            "cache_len": JAMBA_CACHE, "init_s": init_s,
            "param_gb": param_gb, "init_peak_mem_gb": init_peak,
            "peak_mem_gb": peak, "launches": counts,
            "qmatmul_per_forward": j_forward, "ssd_scan_per_prefill": n_mamba,
            "equal_to_plain_qmatmul_path": True,
            "plain_prefill_s": plain_done[0].prefill_s,
            "plain_decode_s": plain_done[0].decode_s}))

    # One prefill and one decode step of (A) under torch.profiler.
    batch = {"tokens": torch.from_numpy(prompts).to(dev)}
    cache, lg = japi.prefill(jparams, batch, JAMBA_CACHE)
    profile("A_jamba_prefill",
            lambda: japi.prefill(jparams, batch, JAMBA_CACHE),
            {"qmatmul_kernel": j_forward, "ssd_scan_kernel": n_mamba})
    cur = torch.argmax(lg[:, -1], dim=-1)[:, None]
    japi.decode(jparams, cache, {"tokens": cur}, JAMBA_PROMPT)
    profile("A_jamba_decode_step",
            lambda: japi.decode(jparams, cache, {"tokens": cur},
                                JAMBA_PROMPT + 1),
            {"qmatmul_kernel": j_forward, "ssd_scan_kernel": 0})
    del batch, cache, lg, cur

    # -- (C) (A)'s model through the ContinuousEngine ------------------------
    rng = np.random.default_rng(43)
    lens = rng.integers(JCONT_PROMPTS[0], JCONT_PROMPTS[1] + 1,
                        JCONT_REQUESTS)
    news = rng.integers(JCONT_NEW[0], JCONT_NEW[1] + 1, JCONT_REQUESTS)
    creqs = [Request(uid=i, prompt=rng.integers(0, jcfg.vocab, lens[i]),
                     max_new_tokens=int(news[i]))
             for i in range(JCONT_REQUESTS)]

    def continuous(backend):
        eng = ContinuousEngine(get_model(jcfg, backend=backend), jparams,
                               batch_slots=JCONT_SLOTS, cache_len=JAMBA_CACHE)
        eng.serve(creqs[:1])                  # warm-up
        return eng

    eng = continuous("auto")
    torch.cuda.reset_peak_memory_stats()
    done, counts = counted(lambda: eng.serve(creqs))
    st = eng.last_stats
    check_counts("C", counts, expect(
        qmatmul=j_forward * (st.admitted + st.steps),
        ssd_scan=n_mamba * st.admitted))
    peak = peak_gb()
    plain = continuous(plain_q)
    same_tokens("C", by_uid(done), by_uid(plain.serve(creqs)))
    if plain.last_stats.steps != st.steps or any(
            len(c.tokens) != int(news[c.uid]) for c in done):
        raise AssertionError(f"C: {st.steps} steps against "
                             f"{plain.last_stats.steps}, or a request "
                             "stopped short")
    n_tok = sum(len(c.tokens) for c in done)
    prefill = sum(c.prefill_s for c in done)
    emit_row("C_jamba_bf16_sint_continuous", {
        "model": jcfg.name, "cuts": cuts, "slots": JCONT_SLOTS,
        "requests": len(done), "steps": st.steps, "admitted": st.admitted,
        "prompt_lens": [int(lens.min()), int(lens.max())],
        "new_tokens": [int(news.min()), int(news.max())],
        "wall_s": st.wall_s, "tokens": n_tok, "tok_per_s": n_tok / st.wall_s,
        "admission_prefill_s": prefill,
        "step_ms": (st.wall_s - prefill) / st.steps * 1e3,
        "finished_s": percentiles([c.finished_s for c in done]),
        "peak_mem_gb": peak, "launches": counts,
        "held_to": "same engine, qmatmul plain", "tokens_equal": True,
        "steps_equal": True})
    del eng, plain, jparams, japi

    # -- (B) one Jamba Mamba mixer, f32 REAL: card against the CPU -----------
    fresh()
    mcfg = get_config(JAMBA_ARCH).with_(dtype=torch.float32)
    cpu_gen = torch.Generator().manual_seed(47)
    p_cpu = mamba2.mamba_init(cpu_gen, mcfg)
    x_cpu = torch.randn((1, MIXER_T, mcfg.d_model), generator=cpu_gen)
    p_card = tree_to(p_cpu, dev)
    t0 = time.perf_counter()
    (out, state), counts = counted(lambda: mamba2._mamba_forward_state(
        p_card, mcfg, x_cpu.to(dev)))
    card_s = time.perf_counter() - t0
    check_counts("B", counts, expect(ssd_scan=1))
    t0 = time.perf_counter()
    want, want_state = mamba2._mamba_forward_state(p_cpu, mcfg, x_cpu)
    cpu_s = time.perf_counter() - t0
    errs = {name: float((got.cpu() - ref_).abs().max() / ref_.abs().max())
            for name, got, ref_ in (("out", out, want),
                                    ("conv_state", state["conv"],
                                     want_state["conv"]),
                                    ("ssm_state", state["ssm"],
                                     want_state["ssm"]))}
    if max(errs.values()) > WIDTH_TOL or not torch.isfinite(out).all():
        raise AssertionError(f"B: the card's mixer is {errs} of the largest "
                             f"from the CPU's (tolerance {WIDTH_TOL})")
    emit_row("B_jamba_mamba_mixer_f32_card_vs_cpu", {
        "model": mcfg.name, "t": MIXER_T, "d_model": mcfg.d_model,
        "ssd": [mcfg.ssm_heads, mcfg.ssm_headdim, mcfg.ssm_state,
                mcfg.ssm_groups],
        "max_rel_err": errs, "tolerance": WIDTH_TOL, "card_s": card_s,
        "cpu_s": cpu_s, "launches": counts, "peak_mem_gb": peak_gb(),
        "tf32": torch.backends.cuda.matmul.allow_tf32})
    del p_cpu, p_card, out, state, want, want_state

    # -- (D) llava-next-34b, bf16 SINT, wave Engine with the image prefix ----
    fresh()
    lcfg = get_config(LLAVA_ARCH).with_(quant="SINT")
    l_forward = 7 * lcfg.n_layers        # q, k, v, o, gate, up, down
    n_img = lcfg.num_image_tokens
    l_cache = n_img + LLAVA_TEXT + LLAVA_NEW
    lparams, init_s, param_gb = init(lcfg, 53)
    init_peak = peak_gb()
    image = torch.randn((LLAVA_BATCH, n_img, VISION_D), generator=gen,
                        device=dev).to(lcfg.dtype)
    texts = np.random.default_rng(53).integers(
        0, lcfg.vocab, (LLAVA_BATCH, LLAVA_TEXT))
    lreqs = [Request(uid=i, prompt=texts[i], max_new_tokens=LLAVA_NEW)
             for i in range(LLAVA_BATCH)]
    lapi = get_model(lcfg)
    engine = Engine(lapi, lparams, batch_slots=LLAVA_BATCH,
                    cache_len=l_cache, extras={"image_emb": image})
    torch.cuda.reset_peak_memory_stats()
    done, counts = counted(lambda: engine.serve(lreqs))
    check_counts("D", counts, expect(qmatmul=l_forward * LLAVA_NEW))
    peak = peak_gb()
    plain = Engine(get_model(lcfg, backend=plain_q), lparams,
                   batch_slots=LLAVA_BATCH, cache_len=l_cache,
                   extras={"image_emb": image})
    plain_done = plain.serve(lreqs)
    held_to_plain("D", engine, done, plain, plain_done)
    logits = engine.last_prefill_logits.clone()
    del engine, plain
    # The projected prefix moves the text's logits.
    batch = {"tokens": torch.from_numpy(texts).to(dev), "image_emb": image}
    _, moved = lapi.prefill(lparams, dict(batch, image_emb=image + 1),
                            l_cache)
    prefix_moves = float((moved[:, -1] - logits).abs().max())
    if not prefix_moves > 0:
        raise AssertionError("D: the image prefix does not reach the text's "
                             "logits")
    del moved
    emit_row("D_llava_bf16_sint_wave", wave_row(
        lcfg, done, LLAVA_BATCH, LLAVA_TEXT, LLAVA_NEW, {
            "image_tokens": n_img, "vision_d": VISION_D,
            "prefill_positions": n_img + LLAVA_TEXT, "cache_len": l_cache,
            "cuts": {}, "init_s": init_s, "param_gb": param_gb,
            "init_peak_mem_gb": init_peak, "peak_mem_gb": peak,
            "launches": counts, "qmatmul_per_forward": l_forward,
            "equal_to_plain_qmatmul_path": True,
            "prefix_moves_logits_by": prefix_moves,
            "plain_prefill_s": plain_done[0].prefill_s,
            "plain_decode_s": plain_done[0].decode_s}))
    profile("D_llava_prefill",
            lambda: lapi.prefill(lparams, batch, l_cache),
            {"qmatmul_kernel": l_forward})
    del batch

    # -- (E) (D)'s model in CYCLIC_SEGMENTS scan cycles per token ------------
    control_task = PlcTask()
    one = {"tokens": torch.from_numpy(texts[:1]).to(dev),
           "image_emb": image[:1]}

    def cyclic():
        cache, lg = lapi.prefill(lparams, one, l_cache)
        first = torch.argmax(lg[:, -1], dim=-1)
        cd = CyclicDecoder(lcfg, lparams, n_segments=CYCLIC_SEGMENTS,
                           batch=1, cache_len=l_cache)
        t0 = time.perf_counter()
        toks, _, stats = cd.decode_tokens(cache, first, LLAVA_TEXT,
                                          LLAVA_NEW - 1,
                                          control_task=control_task)
        return ([int(first[0])] + toks, stats, cd.bounds,
                time.perf_counter() - t0)

    (ctoks, stats, bounds, cyc_s), counts = counted(cyclic)
    check_counts("E", counts, expect(qmatmul=l_forward * LLAVA_NEW))
    wave1 = Engine(lapi, lparams, batch_slots=1, cache_len=l_cache,
                   extras={"image_emb": image[:1]}).serve([lreqs[0]])[0]
    if not np.array_equal(np.asarray(ctoks), wave1.tokens):
        raise AssertionError(f"E: cyclic tokens {ctoks} differ from the "
                             f"batch-1 wave engine's {wave1.tokens.tolist()}")
    ct = stats.cycle_times_s
    if control_task.cycles != len(bounds) * (LLAVA_NEW - 1) \
            or len(ct) != control_task.cycles or max(ct) >= SCAN_CYCLE_S:
        raise AssertionError(f"E: {control_task.cycles} control steps, "
                             f"{len(ct)} cycle times, the longest {max(ct)} s "
                             f"against the {SCAN_CYCLE_S} s scan cycle")
    emit_row("E_llava_sint_cyclic", {
        "model": lcfg.name, "segments": bounds, "tokens": len(ctoks),
        "cycles": len(ct), "cycle_s": percentiles(ct),
        "scan_cycle_s": SCAN_CYCLE_S, "cycles_over_scan_cycle": 0,
        "decode_s": cyc_s, "tok_per_s": (LLAVA_NEW - 1) / cyc_s,
        "launches": counts, "equal_to_batch1_wave": True,
        "control_level": control_task.level})
    del lparams, lapi, image, one

    # -- (F) whisper-base, uncut: bf16 SINT against its plain-qmatmul twin ---
    fresh()
    wcfg = get_config(WHISPER_ARCH).with_(quant="SINT")
    # Encoder: q, k, v, o, up, down; decoder: self q/k/v/o, cross q/k/v/o,
    # up, down.  A decode step: self q/k/v/o, cross q and o, up, down.
    w_prefill = 6 * wcfg.n_layers + 10 * wcfg.n_layers
    w_step = 8 * wcfg.n_layers
    wparams, init_s, param_gb = init(wcfg, 59)
    frames = torch.randn((WHISPER_BATCH, wcfg.encoder_frames, wcfg.d_model),
                         generator=gen, device=dev).to(wcfg.dtype)
    wprompts = np.random.default_rng(59).integers(
        0, wcfg.vocab, (WHISPER_BATCH, WHISPER_PROMPT))
    wreqs = [Request(uid=i, prompt=wprompts[i], max_new_tokens=WHISPER_NEW)
             for i in range(WHISPER_BATCH)]

    def whisper_engine(backend):
        return Engine(get_model(wcfg, backend=backend), wparams,
                      batch_slots=WHISPER_BATCH, cache_len=WHISPER_CACHE,
                      extras={"frames": frames})

    engine = whisper_engine("auto")
    engine.serve(wreqs[:1])                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    done, counts = counted(lambda: engine.serve(wreqs))
    check_counts("F", counts, expect(
        qmatmul=w_prefill + w_step * (WHISPER_NEW - 1)))
    peak = peak_gb()
    plain = whisper_engine(plain_q)
    plain_done = plain.serve(wreqs)
    held_to_plain("F", engine, done, plain, plain_done)
    del engine, plain
    emit_row("F_whisper_bf16_sint_wave", wave_row(
        wcfg, done, WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW, {
            "encoder_frames": wcfg.encoder_frames, "cache_len": WHISPER_CACHE,
            "cuts": {}, "init_s": init_s, "param_gb": param_gb,
            "peak_mem_gb": peak, "launches": counts,
            "qmatmul_per_prefill": w_prefill, "qmatmul_per_step": w_step,
            "equal_to_plain_qmatmul_path": True,
            "plain_prefill_s": plain_done[0].prefill_s,
            "plain_decode_s": plain_done[0].decode_s}))
    del wparams, frames

    # ... f32 REAL, card against the CPU over the prefill and
    # WHISPER_CPU_STEPS greedy steps.
    fresh()
    fcfg = get_config(WHISPER_ARCH).with_(dtype=torch.float32)
    cpu_gen = torch.Generator().manual_seed(61)
    cpu_params = get_model(fcfg).init(cpu_gen, device="cpu")
    cpu_frames = torch.randn((WHISPER_BATCH, fcfg.encoder_frames,
                              fcfg.d_model), generator=cpu_gen)
    card_params = tree_to(cpu_params, dev)
    fapi = get_model(fcfg)

    def greedy(p, device):
        cache, lg = fapi.prefill(p, {"tokens": torch.from_numpy(
            wprompts).to(device), "frames": cpu_frames.to(device)},
            WHISPER_CACHE)
        outs, toks = [lg[:, -1].cpu()], []
        for step in range(WHISPER_CPU_STEPS):
            cur = torch.argmax(lg[:, -1], dim=-1)
            toks.append(cur.cpu().numpy())
            cache, lg = fapi.decode(p, cache, {"tokens": cur[:, None]},
                                    WHISPER_PROMPT + step)
            outs.append(lg[:, -1].cpu())
        return torch.stack(outs), np.stack(toks)

    t0 = time.perf_counter()
    card_logits, card_toks = greedy(card_params, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_logits, cpu_toks = greedy(cpu_params, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    f_err = float((card_logits - cpu_logits).abs().max()
                  / cpu_logits.abs().max())
    if f_err > WIDTH_TOL or not np.array_equal(card_toks, cpu_toks):
        raise AssertionError(f"F: logits {f_err} of the largest from the "
                             f"CPU (tolerance {WIDTH_TOL}), tokens equal "
                             f"{np.array_equal(card_toks, cpu_toks)}")
    emit_row("F_whisper_f32_card_vs_cpu", {
        "model": fcfg.name, "batch": WHISPER_BATCH,
        "encoder_frames": fcfg.encoder_frames, "prompt": WHISPER_PROMPT,
        "decode_steps": WHISPER_CPU_STEPS, "logits_max_rel_err": f_err,
        "tolerance": WIDTH_TOL, "tokens_equal": True, "card_s": card_s,
        "cpu_s": cpu_s, "tf32": torch.backends.cuda.matmul.allow_tf32})
    del cpu_params, card_params

    # The launcher on the card: whisper-base uncut, llava-next reduced.
    fresh()
    for argv in (["--arch", WHISPER_ARCH],
                 ["--arch", LLAVA_ARCH, "--reduced"]):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            launch_serve.main(argv)
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("req ")]
        if len(lines) != 4:
            raise AssertionError(f"launch.serve {argv}: {out.getvalue()}")
        emit_row("F_launch_serve", {"argv": argv, "requests": len(lines),
                                    "wall_s": time.perf_counter() - t0,
                                    "first": lines[0]})
    return launches


def llm_train_phase(dev, smi):
    """Phase 14 (module docstring): runs (G)-(K), the LLM training stack on
    the card.  Returns the launch counts of the runs."""
    import gc
    import shutil
    import tempfile
    from repro_torch.checkpoint import latest_step, restore, save
    from repro_torch.configs.base import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import (loss_and_grads, make_optimizer,
                                          make_train_step)
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import leaves, tree_map
    from repro_torch.serving import Engine, Request

    launches = dict.fromkeys(COUNTED, 0)
    gen = torch.Generator(device=dev)
    none = expect()

    def counted(fn):
        return counted_into(launches, fn)

    def emit_row(run, row):
        emit({"phase": "llm_train", "run": run, "nvidia_smi": smi, **row})

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def stream(cfg, seq, batch, seed):
        return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch,
                                      seed=seed)).batches()

    def on_card(host):
        return {k: torch.from_numpy(v).to(dev, dtype=torch.int64)
                for k, v in host.items()}

    def leaf_sums(params):
        return [float(p.double().sum()) for p in leaves(params)
                if p.is_floating_point()]

    def run_steps(step, params, opt, batches):
        """Train steps over ``batches`` (on the card): (params, opt,
        losses, gradient norms, wall seconds a step, each ending in the
        host's read of the loss)."""
        losses, norms, secs = [], [], []
        for b in batches:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
            norms.append(float(m["grad_norm"]))
        if not np.isfinite(losses + norms).all():
            raise AssertionError(f"non-finite loss or gradient norm: "
                                 f"{losses} {norms}")
        return params, opt, losses, norms, secs

    def learned(run, losses, margin):
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if not last < first - margin:
            raise AssertionError(f"{run}: mean loss {first} -> {last}, "
                                 f"not {margin} lower: {losses}")
        return first, last

    def step_row(secs, tokens):
        steady = secs[1:] or secs
        ms = float(np.median(steady)) * 1e3
        return {"first_step_ms": secs[0] * 1e3, "step_ms_median": ms,
                "step_ms": [s * 1e3 for s in secs],
                "tokens_per_s": tokens / ms * 1e3}

    # -- (G) qwen3-8b's widths, depth cut, bf16, remat per layer -----------
    fresh()
    full = get_config(QWEN_ARCH)
    gcfg = full.with_(n_layers=LT_QWEN_LAYERS)
    gen.manual_seed(71)
    t0 = time.perf_counter()
    api = get_model(gcfg)
    params = api.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(params))
    opt_init, opt_update = make_optimizer(LT_QWEN_LR, warmup=LT_QWEN_WARMUP,
                                          steps=LT_QWEN_STEPS)
    opt = opt_init(params)
    step = make_train_step(api, opt_update)
    data = stream(gcfg, LT_SEQ, LT_BATCH, 0)
    batches = [on_card(next(data)) for _ in range(LT_QWEN_STEPS + 1)]
    before = leaf_sums(params)
    torch.cuda.reset_peak_memory_stats()
    (params, opt, losses, norms, secs), counts = counted(
        lambda: run_steps(step, params, opt, batches[:LT_QWEN_STEPS]))
    check_counts("G", counts, none)
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = sum(a != b for a, b in zip(before, leaf_sums(params)))
    if moved != len(before):
        raise AssertionError(f"G: {len(before) - moved} of {len(before)} "
                             f"float leaves did not move")
    first, last = learned("G", losses, 0.0)
    # One more step under torch.profiler: where a step's time goes.
    timing = {}

    def one_step():
        t1 = time.perf_counter()
        step(params, opt, batches[-1])
        torch.cuda.synchronize()
        timing["wall"] = time.perf_counter() - t1

    events = device_events(one_step)
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy = sum(by_name.values())
    emit_row("G_qwen3_8b_widths_train", {
        "model": gcfg.name, "dtype": "bfloat16", "remat": gcfg.remat,
        "layers": gcfg.n_layers, "d_model": gcfg.d_model,
        "heads": [gcfg.n_heads, gcfg.n_kv_heads, gcfg.d_head],
        "d_ff": gcfg.d_ff, "vocab": gcfg.vocab,
        "cuts": {"n_layers": [full.n_layers, gcfg.n_layers,
                              "36 layers are ~7.6B params, ~91 GB at 12 "
                              "bytes each (bf16 param and gradient, two "
                              "f32 moments) before activations"]},
        "params": n_params, "param_gb": nbytes(*leaves(params)) / 1e9,
        "batch": LT_BATCH, "seq": LT_SEQ, "steps": LT_QWEN_STEPS,
        "lr": LT_QWEN_LR, "warmup": LT_QWEN_WARMUP, "init_s": init_s,
        "peak_mem_gb": peak, "losses": losses, "grad_norms": norms,
        "mean_loss_first5": first, "mean_loss_last5": last,
        "leaves_moved": moved, "launches": counts,
        **step_row(secs, LT_BATCH * LT_SEQ)})
    emit({"phase": "profile", "run": "G_one_train_step", "nvidia_smi": smi,
          "wall_ms": timing["wall"] * 1e3, "device_busy_ms": busy / 1e3,
          "device_busy_share": busy / 1e6 / timing["wall"],
          "device_events": len(events),
          "top_device_us": sorted(by_name.items(),
                                  key=lambda kv: -kv[1])[:15]})
    del params, opt, step, batches, api

    # -- (H) one train step per family, card against the CPU --------------
    fresh()
    for arch in LT_FAMILIES:
        cfg = get_config(arch).reduced().with_(dtype=torch.float32)
        api = get_model(cfg)
        cpu_gen = torch.Generator().manual_seed(73)
        cpu_params = api.init(cpu_gen, device="cpu")
        cpu_batch = api.init_batch("train", LT_CPU_BATCH, LT_CPU_SEQ,
                                   cpu_gen, device="cpu")
        card_params = tree_to(cpu_params, dev)
        card_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
        opt_init, opt_update = make_optimizer()
        step = make_train_step(api, opt_update)

        def card_step():
            grads = loss_and_grads(api, card_params, card_batch)[1]
            return grads, step(card_params, opt_init(card_params),
                               card_batch)

        (card_grads, (card_params, _, card_m)), counts = counted(card_step)
        check_counts(f"H {arch}", counts, none)
        cpu_grads = loss_and_grads(api, cpu_params, cpu_batch)[1]
        cpu_params, _, cpu_m = step(cpu_params, opt_init(cpu_params),
                                    cpu_batch)
        errs = {k: abs(float(card_m[k]) - float(cpu_m[k]))
                / abs(float(cpu_m[k])) for k in ("loss", "grad_norm")}
        # Each gradient leaf against its own largest value; the updated
        # params against the largest param (phase 11's measure): AdamW's
        # first step moves every element of a leaf by about the learning
        # rate whatever the size of its gradient, so a leaf that starts at
        # zero (a bias) holds only +-lr, whose signs follow the last bits
        # of the gradients near zero.
        errs["grads"] = max(
            float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(leaves(card_grads), leaves(cpu_grads)))
        largest = max(float(b.abs().max()) for b in leaves(cpu_params))
        errs["params"] = max(float((a.cpu() - b).abs().max()) / largest
                             for a, b in zip(leaves(card_params),
                                             leaves(cpu_params)))
        if max(errs.values()) > CARD_CPU_TOL:
            raise AssertionError(f"H {arch}: {errs} from the CPU "
                                 f"(tolerance {CARD_CPU_TOL})")
        emit_row("H_train_step_card_vs_cpu", {
            "model": cfg.name, "family": cfg.family, "reduced": True,
            "dtype": "float32", "batch": LT_CPU_BATCH, "seq": LT_CPU_SEQ,
            "loss": float(card_m["loss"]), "max_rel_err": errs,
            "tolerance": CARD_CPU_TOL, "launches": counts,
            "tf32": torch.backends.cuda.matmul.allow_tf32})
        del cpu_params, card_params

    # -- (I) mamba2-370m uncut: train, loss through ssd_scan, resume, serve --
    fresh()
    mcfg = get_config(MAMBA_ARCH)
    gen.manual_seed(79)
    api = get_model(mcfg)
    params = api.init(gen)
    opt_init, opt_update = make_optimizer(
        LT_MAMBA_LR, warmup=LT_MAMBA_WARMUP,
        steps=LT_MAMBA_STEPS + LT_RESUME_STEPS)
    opt = opt_init(params)
    step = make_train_step(api, opt_update)
    data = stream(mcfg, LT_SEQ, LT_BATCH, 1)
    batches = [on_card(next(data))
               for _ in range(LT_MAMBA_STEPS + LT_RESUME_STEPS + 1)]
    before = leaf_sums(params)
    torch.cuda.reset_peak_memory_stats()
    (params, opt, losses, norms, secs), counts = counted(
        lambda: run_steps(step, params, opt, batches[:LT_MAMBA_STEPS]))
    check_counts("I train", counts, none)
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = sum(a != b for a, b in zip(before, leaf_sums(params)))
    emit_row("I_mamba2_train", {
        "model": mcfg.name, "dtype": "bfloat16", "remat": mcfg.remat,
        "layers": mcfg.n_layers, "d_model": mcfg.d_model,
        "ssd": [mcfg.ssm_heads, mcfg.ssm_headdim, mcfg.ssm_state],
        "vocab": mcfg.vocab, "params": sum(p.numel() for p in leaves(params)),
        "batch": LT_BATCH, "seq": LT_SEQ, "steps": LT_MAMBA_STEPS,
        "ssd_gradient": "chunked plain version (launch.steps.GRAD_BACKEND)",
        "peak_mem_gb": peak, "losses": losses, "grad_norms": norms,
        "leaves_moved": [moved, len(before)], "launches": counts,
        **step_row(secs, LT_BATCH * LT_SEQ)})

    # The loss without a gradient, through ssd_scan and through the chunked
    # plain SSD, on the params upcast to f32.
    fcfg = mcfg.with_(dtype=torch.float32)
    f32_params = upcast(params)
    held_out = batches[-1]
    with torch.no_grad():
        t0 = time.perf_counter()
        kernel_loss, counts = counted(
            lambda: float(get_model(fcfg).loss(f32_params, held_out)))
        kernel_s = time.perf_counter() - t0
        check_counts("I loss", counts, expect(ssd_scan=mcfg.n_layers))
        t0 = time.perf_counter()
        plain_loss = float(get_model(fcfg, backend={
            "ssd_scan": "chunked"}).loss(f32_params, held_out))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    loss_err = abs(kernel_loss - plain_loss) / abs(plain_loss)
    if not np.isfinite(kernel_loss) or loss_err > CARD_CPU_TOL:
        raise AssertionError(f"I: the loss through ssd_scan {kernel_loss} "
                             f"against the chunked plain SSD's {plain_loss}")
    del f32_params
    emit_row("I_mamba2_no_grad_loss", {
        "dtype": "float32 (the trained params upcast)",
        "loss_ssd_scan": kernel_loss, "loss_chunked": plain_loss,
        "rel_err": loss_err, "tolerance": CARD_CPU_TOL, "launches": counts,
        "ssd_scan_s": kernel_s, "chunked_s": plain_s})

    # Checkpoint round trip, then LT_RESUME_STEPS more steps from the live
    # state and from the restored one, deterministic algorithms on.
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        save(ckpt_dir, LT_MAMBA_STEPS, {"params": params})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = restore(ckpt_dir, {"params": params})["params"]
        restore_s = time.perf_counter() - t0
        if latest_step(ckpt_dir) != LT_MAMBA_STEPS or not all(
                torch.equal(a, b) for a, b in zip(leaves(params),
                                                  leaves(restored))):
            raise AssertionError("I: the restored params differ from the "
                                 "saved ones")
        opt_copy = opt._replace(mu=tree_map(torch.clone, opt.mu),
                                nu=tree_map(torch.clone, opt.nu))
        resume = batches[LT_MAMBA_STEPS:LT_MAMBA_STEPS + LT_RESUME_STEPS]
        torch.use_deterministic_algorithms(True)
        try:
            (_, _, live, _, _), counts = counted(
                lambda: run_steps(step, params, opt, resume))
            restored, _, again, _, _ = run_steps(step, restored, opt_copy,
                                                 resume)
        finally:
            torch.use_deterministic_algorithms(False)
        check_counts("I resume", counts, none)
        if live != again:
            raise AssertionError(f"I: resumed losses {again} differ from "
                                 f"the live run's {live}")
    finally:
        shutil.rmtree(ckpt_dir)
    emit_row("I_mamba2_checkpoint_resume", {
        "leaves": len(leaves(params)), "bit_equal_leaves": True,
        "save_s": save_s, "restore_s": restore_s,
        "resume_steps": LT_RESUME_STEPS, "live_losses": live,
        "restored_losses": again, "deterministic_algorithms": True,
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG")})
    del params, opt, opt_copy, step, batches

    # Serve the restored, trained model in f32 through the wave Engine at
    # (k)'s shape: ssd_scan in the prefill, tokens equal to the plain
    # sequential SSD's.
    served = upcast(restored)
    del restored
    prompts = np.random.default_rng(79).integers(
        0, mcfg.vocab, (MAMBA_BATCH, MAMBA_PROMPT))
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=MAMBA_NEW)
            for i in range(MAMBA_BATCH)]
    cache_len = MAMBA_PROMPT + MAMBA_NEW
    engine = Engine(get_model(fcfg), served, batch_slots=MAMBA_BATCH,
                    cache_len=cache_len)
    engine.serve([Request(uid=0, prompt=prompts[0, :128], max_new_tokens=2)])
    done, counts = counted(lambda: engine.serve(reqs))
    check_counts("I serve", counts, expect(ssd_scan=mcfg.n_layers))
    logits = engine.last_prefill_logits.clone()
    plain = Engine(get_model(fcfg, backend={"ssd_scan": "ref"}), served,
                   batch_slots=MAMBA_BATCH, cache_len=cache_len)
    plain_done = plain.serve(reqs)
    want = plain.last_prefill_logits
    max_rel = float((logits - want).abs().max() / want.abs().max())
    if max_rel > F32_LOGIT_TOL or not torch.isfinite(logits).all():
        raise AssertionError(f"I serve: prefill logits {max_rel} of the "
                             f"largest from the plain SSD's")
    same_tokens("I serve", by_uid(done), by_uid(plain_done))
    emit_row("I_mamba2_trained_serve_f32", {
        "batch": MAMBA_BATCH, "prompt": MAMBA_PROMPT, "new_tokens": MAMBA_NEW,
        "prefill_s": done[0].prefill_s,
        "prefill_tok_per_s": MAMBA_BATCH * MAMBA_PROMPT / done[0].prefill_s,
        "decode_s": done[0].decode_s,
        "decode_tok_per_s": MAMBA_BATCH * (MAMBA_NEW - 1) / done[0].decode_s,
        "launches": counts, "logits_max_rel_err": max_rel,
        "tokens_equal_to_plain_ssd": True,
        "plain_prefill_s": plain_done[0].prefill_s,
        "first_tokens": [c.tokens[:8].tolist() for c in done]})
    del engine, plain, served, logits, want

    # -- (J) the reference example's ~55M qwen3-family model, whole --------
    fresh()
    jcfg = get_config(QWEN_ARCH).with_(**LT_SMALL)
    gen.manual_seed(0)
    api = get_model(jcfg)
    params = api.init(gen)
    opt_init, opt_update = make_optimizer(LT_SMALL_LR,
                                          warmup=LT_SMALL_WARMUP,
                                          steps=LT_SMALL_STEPS)
    step = make_train_step(api, opt_update)
    data = stream(jcfg, LT_SMALL_SEQ, LT_BATCH, 0)
    batches = [on_card(next(data)) for _ in range(LT_SMALL_STEPS)]
    t0 = time.perf_counter()
    (params, _, losses, norms, secs), counts = counted(
        lambda: run_steps(step, params, opt_init(params), batches))
    wall = time.perf_counter() - t0
    check_counts("J", counts, none)
    first, last = learned("J", losses, LT_SMALL_MARGIN)
    emit_row("J_example_55m_train", {
        "model": "qwen3 family, examples/train_llm.py's default",
        **LT_SMALL, "params": sum(p.numel() for p in leaves(params)),
        "batch": LT_BATCH, "seq": LT_SMALL_SEQ, "steps": LT_SMALL_STEPS,
        "lr": LT_SMALL_LR, "warmup": LT_SMALL_WARMUP, "wall_s": wall,
        "mean_loss_first5": first, "mean_loss_last5": last,
        "required_drop": LT_SMALL_MARGIN, "losses_every_50": losses[::50],
        "final_loss": losses[-1], "launches": counts,
        **{k: v for k, v in step_row(secs, LT_BATCH * LT_SMALL_SEQ).items()
           if k != "step_ms"}})
    del params, step, batches, api

    # -- (K) the launcher on the card --------------------------------------
    fresh()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = ["--arch", MAMBA_ARCH, "--reduced", "--steps", "5",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "5"]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": src})
        wall = time.perf_counter() - t0
        latest = latest_step(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir)
    if proc.returncode != 0 or latest != 5:
        raise AssertionError(f"K: launch.train exited {proc.returncode}, "
                             f"LATEST {latest}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    emit_row("K_launch_train", {"argv": argv[:-4] + ["--ckpt-dir", "<tmp>",
                                                     "--ckpt-every", "5"],
                                "exit_code": proc.returncode,
                                "latest": latest, "wall_s": wall,
                                "stdout": proc.stdout.splitlines()[-3:]})
    return launches


def mesh_backend(world):
    """NCCL with one rank per card where the machine has the cards; gloo
    with the ranks sharing the cards otherwise (NCCL refuses two ranks on
    one card)."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def serve_outputs(engine, readings):
    """Every cycle of ``readings`` through a fleet engine: (each verdict's
    (stream, cycle, pred, group), each verdict step's outputs by unit)."""
    outs, verdicts = [], []
    for c in range(len(readings)):
        got = engine.ingest(readings[c])
        if got:
            verdicts.extend((v.stream, v.cycle, v.pred, v.group) for v in got)
            outs.append({k: v.copy() for k, v in
                         engine.last_outputs.items()})
    return verdicts, outs


def mesh_engine(run, models, dev, mesh):
    """The engine of a phase-15 run on ``mesh`` (None: unsharded), its
    params made on ``dev`` from the host copies in ``models``."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.serving import (GroupedStreamEngine, ModelGroup,
                                     StreamEngine)
    kw = dict(run["kw"])
    kw.update({"mesh": mesh} if mesh is not None else {"shard": False})
    if run["kind"] == "grouped":
        return GroupedStreamEngine(
            [ModelGroup(name, model, params_from_numpy(p, device=dev),
                        run["plants"], head, None, adapt)
             for name, model, p, head, adapt in models["groups"]],
            device=dev, **kw)
    model, p = models[run["model"]]
    if "head" in run:
        kw["head"] = models[run["head"]]
    return StreamEngine(model, params_from_numpy(p, device=dev),
                        n_streams=run["plants"], device=dev, **kw)


def mesh_readings(base, run):
    """The run's readings: the scenario fleet ``base`` tiled to the run's
    streams (all groups' for a grouped run)."""
    n = run["plants"] * (len(GROUPS) if run["kind"] == "grouped" else 1)
    return np.tile(base, (1, n // base.shape[1], 1))


def mesh_rank(rank, world, runs, models, base, device_type):
    """One rank of phase 15: build every mesh of ``runs`` (collectively, in
    one order), then serve each run this rank is a member of.  Per run: the
    verdicts and outputs, this rank's kernel launches (counted from 0 just
    before the run), its stats, and the milliseconds its gathers took by
    axis (each gather timed between two synchronizations)."""
    from repro_torch.launch.mesh import make_fleet_mesh, make_host_mesh
    from repro_torch.serving import core
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device_type == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device(device_type))
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    meshes = {}
    for run in runs:
        if run["mesh"] not in meshes:
            meshes[run["mesh"]] = (
                make_host_mesh(device_type=device_type)
                if run["mesh"] == "host" else
                make_fleet_mesh(run["mesh"][0], model_shards=run["mesh"][1],
                                device_type=device_type))
    gather, current, spent = core._gather, [None], {}

    def timed(t, group, size):
        sync()
        t0 = time.perf_counter()
        out = gather(t, group, size)
        sync()
        axis = "model" if group is current[0]._model_group else "data"
        spent[axis] = spent.get(axis, 0.0) + time.perf_counter() - t0
        return out

    core._gather = timed
    results = {}
    try:
        for run in runs:
            mesh = meshes[run["mesh"]]
            if mesh.get_coordinate() is None:
                continue
            engine = current[0] = mesh_engine(run, models, dev, mesh)
            engine.warmup()
            readings = mesh_readings(base, run)
            spent.clear()
            reset_counts()
            verdicts, outs = serve_outputs(engine, readings)
            sync()
            counts = read_counts()
            stats = engine.stats
            results[run["name"]] = {
                "verdicts": verdicts, "outs": outs, "launches": counts,
                "steps": stats.steps, "dispatches": stats.dispatches,
                "collectives": dict(stats.collectives),
                "windows_per_s": stats.windows_per_s(),
                "p50_ms": stats.latency_p(50) * 1e3,
                "p99_ms": stats.latency_p(99) * 1e3,
                "deadline_misses": stats.deadline_misses,
                "gather_ms": {k: v * 1e3 for k, v in spent.items()},
                "device": str(dev), "in_mesh": engine._in_mesh}
            del engine
            current[0] = None
    finally:
        core._gather = gather
    return results


def mesh_phase(dev, smi, models, base):
    """Phase 15: runs (L)-(Q), each on its mesh against the unsharded engine
    over the same plants on the same card.  Returns the launches of every
    rank's runs, summed, by kernel."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn
    # Built here, before any rank starts: the ranks load these builds.
    build.build()
    host = {k: (models[k][0], params_to_numpy(models[k][1]))
            for k in ("cls_sint", "cls_real", "ae_sint")}
    # Fresh head copies: a margin head caches its center on the card.
    host["ae_head"] = dataclasses.replace(models["ae_head"])
    host["groups"] = [(g.name, g.model, params_to_numpy(g.params),
                       dataclasses.replace(g.head), g.adapt)
                      for g in models["groups"]]
    p = MESH_PLANTS
    runs = [
        dict(name="L_sint_classifier_fused", mesh=(4, 1), kind="stream",
             model="cls_sint", plants=4 * p, kw={}, scheme="SINT",
             per_step=(expect(fused_mlp=1), {"model": 0, "data": 1})),
        dict(name="M_real_classifier_fused", mesh=(4, 1), kind="stream",
             model="cls_real", plants=4 * p, kw={}, scheme="REAL",
             per_step=(expect(fused_mlp=1), {"model": 0, "data": 1})),
        dict(name="N_sint_classifier_per_layer", mesh=(2, 2), kind="stream",
             model="cls_sint", plants=2 * p, kw={}, scheme="SINT",
             twin_kw={"fused": False},
             per_step=(expect(qmatmul=4), {"model": 1, "data": 1})),
        # qmatmul is the per-layer step's only kernel: backend="ref" runs
        # it plain.
        dict(name="N_sint_classifier_per_layer_qmatmul_plain", mesh=(2, 2),
             kind="stream", model="cls_sint", plants=2 * p,
             kw={"backend": "ref"}, scheme="SINT",
             twin_kw={"fused": False},
             per_step=(expect(), {"model": 1, "data": 1})),
        dict(name="O_sint_autoencoder_per_layer", mesh=(2, 2), kind="stream",
             model="ae_sint", head="ae_head", plants=2 * p, kw={},
             scheme="SINT", twin_kw={"fused": False},
             per_step=(expect(qmatmul=4), {"model": 3, "data": 1})),
        dict(name="P_sint_fleet_per_group", mesh=(2, 1), kind="grouped",
             plants=2 * p, kw={}, scheme="SINT",
             per_step=(expect(fused_mlp=4), {"model": 0, "data": 1})),
        dict(name="P_sint_fleet_mega", mesh=(2, 1), kind="grouped",
             plants=2 * p, kw={"megakernel": True}, scheme="SINT",
             per_step=(expect(grouped_mlp=1), {"model": 0, "data": 1})),
    ]
    q_runs = [
        dict(name="Q_sint_classifier_nccl_data1", mesh=(1, 1),
             kind="stream", model="cls_sint", plants=p, kw={},
             scheme="SINT",
             per_step=(expect(fused_mlp=1), {"model": 0, "data": 1})),
        dict(name="Q_sint_classifier_nccl_host_mesh", mesh="host",
             kind="stream", model="cls_sint", plants=p, kw={},
             scheme="SINT",
             per_step=(expect(fused_mlp=1), {"model": 0, "data": 1})),
    ]
    # The unsharded twins, on this process's card.
    twins = {}
    for run in runs + q_runs:
        twin_run = dict(run, kw=dict(run["kw"], **run.get("twin_kw", {})))
        # The twin of a run on the plain qmatmul, or through the
        # megakernel, is the default unsharded engine.
        twin_run["kw"].pop("backend", None)
        twin_run["kw"].pop("megakernel", None)
        key = repr((twin_run["model"] if "model" in twin_run else "groups",
                    twin_run["plants"], sorted(twin_run["kw"].items())))
        if key not in twins:
            engine = mesh_engine(twin_run, host, dev, None)
            engine.warmup()
            verdicts, outs = serve_outputs(engine, mesh_readings(base, run))
            twins[key] = (verdicts, outs, engine.stats.windows_per_s())
            del engine
        run["twin"] = key
    torch.cuda.empty_cache()
    launches = dict.fromkeys(COUNTED, 0)
    for world, bk, todo in ((MESH_WORLD, mesh_backend(MESH_WORLD), runs),
                            (1, Q_BACKEND, q_runs)):
        ranks = spawn(mesh_rank, world, bk,
                      [{k: v for k, v in r.items() if k != "twin"}
                       for r in todo], host, base, dev.type, timeout=600.0)
        for run in todo:
            got = [r[run["name"]] for r in ranks if run["name"] in r]
            shape = run["mesh"]
            want_ranks = 1 if shape == "host" else shape[0] * shape[1]
            if len(got) != want_ranks:
                raise AssertionError(f"{run['name']}: {len(got)} ranks "
                                     f"served, expected {want_ranks}")
            t_verdicts, t_outs, t_wps = twins[run["twin"]]
            bit_equal, max_rel = True, 0.0
            kernels, gathers = run["per_step"]
            for g in got:
                steps = g["steps"]
                if steps != 21 or g["verdicts"] != t_verdicts:
                    raise AssertionError(
                        f"{run['name']}: {steps} steps; verdicts differ "
                        "from the unsharded engine's")
                if g["launches"] != {k: n * steps for k, n in
                                     kernels.items()}:
                    raise AssertionError(f"{run['name']}: launches "
                                         f"{g['launches']} in {steps} steps")
                if g["collectives"] != {k: n * steps for k, n in
                                        gathers.items()}:
                    raise AssertionError(
                        f"{run['name']}: gathers {g['collectives']}")
                if len(g["outs"]) != len(t_outs):
                    raise AssertionError(f"{run['name']}: outputs")
                for a_step, b_step in zip(g["outs"], t_outs):
                    for k, b in b_step.items():
                        a = a_step[k]
                        if a.shape != b.shape or not np.isfinite(a).all():
                            raise AssertionError(f"{run['name']}: bad {k}")
                        if not np.array_equal(a, b):
                            bit_equal = False
                            max_rel = max(max_rel, float(np.max(
                                np.abs(a - b) / np.maximum(np.abs(b),
                                                           1e-30))))
                for k in COUNTED:
                    launches[k] += g["launches"][k]
            if run["scheme"] == "SINT" and run["kind"] == "stream" \
                    and not bit_equal:
                raise AssertionError(f"{run['name']}: SINT outputs differ "
                                     "from the unsharded engine's")
            if run["kind"] == "grouped":
                for g in got:
                    same_outputs(run["name"], "SINT", g["outs"], t_outs)
            elif max_rel > MESH_REAL_RTOL:
                raise AssertionError(f"{run['name']}: outputs {max_rel} "
                                     "relative from the unsharded engine's")
            placement = ("one rank per card" if bk == "nccl" else
                         f"{world} ranks sharing {torch.cuda.device_count()} "
                         "card(s)")
            emit({"phase": "mesh", "run": run["name"], "backend": bk,
                  "world": world, "placement": placement,
                  "mesh": ("host (1, 1)" if shape == "host" else
                           list(shape) if shape[1] > 1 else [shape[0]]),
                  "plants": run["plants"] * (len(GROUPS) if run["kind"]
                                             == "grouped" else 1),
                  "devices": [g["device"] for g in got],
                  "steps": got[0]["steps"],
                  "windows_per_s": [g["windows_per_s"] for g in got],
                  "p50_ms": [g["p50_ms"] for g in got],
                  "p99_ms": [g["p99_ms"] for g in got],
                  "deadline_misses": [g["deadline_misses"] for g in got],
                  "launches_per_step": [
                      {k: n / g["steps"] for k, n in g["launches"].items()
                       if n} for g in got],
                  "collectives_per_step": [
                      {k: n / g["steps"] for k, n in g["collectives"].items()}
                      for g in got],
                  "gather_ms_per_step": [
                      {k: v / g["steps"] for k, v in g["gather_ms"].items()}
                      for g in got],
                  "equal_to_unsharded": True, "bit_equal": bit_equal,
                  "max_rel_err": max_rel,
                  "unsharded_windows_per_s": t_wps, "nvidia_smi": smi})
    return launches


def tm_config(run):
    """The config of a phase-16 run: (R) qwen3-8b's widths cut to
    TM_QWEN_LAYERS layers, (S) and (T) uncut, in the run's dtype."""
    from repro_torch.configs.base import get_config
    name, arch, dtype = run[:3]
    cfg = get_config(arch).with_(dtype=getattr(torch, dtype))
    return cfg.with_(n_layers=TM_QWEN_LAYERS) if arch == QWEN_ARCH else cfg


def tm_batches(cfg, batch, seq, dev):
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=3)).batches()
    return [{k: torch.from_numpy(v).to(dev, dtype=torch.int64)
             for k, v in next(data).items()} for _ in range(TM_STEPS)]


def tm_params(api, dev, upcast=False):
    """The run's params from its seed on ``dev`` (every rank draws the same
    ones); ``upcast``: the same values in f32 (a bf16 run's f32 twin)."""
    from repro_torch.optim.adamw import tree_map
    params = api.init(torch.Generator(device=dev).manual_seed(83), device=dev)
    return tree_map(lambda t: t.to(torch.float32) if t.is_floating_point()
                    else t, params) if upcast else params


def tm_unsharded(run, dev, upcast=False):
    """TM_STEPS unsharded steps of a phase-16 run on this card: (losses,
    gradient norms, params after them)."""
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.api import get_model
    cfg = tm_config(run)
    if upcast:
        cfg = cfg.with_(dtype=torch.float32)
    api = get_model(cfg)
    params = tm_params(get_model(tm_config(run)), dev, upcast)
    opt_init, opt_update = make_optimizer()
    opt = opt_init(params)
    step = make_train_step(api, opt_update)
    losses, norms = [], []
    for b in tm_batches(cfg, run[4], run[5], dev):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, params


def train_mesh_rank(rank, world, runs, twin_dir, device_type):
    """One rank of phase 16: each run's sharded steps on its mesh (built
    collectively, in one order).  Per run: losses, gradient norms, wall ms
    a step (each ending in the host's read of the loss), the peak memory
    this rank allocated, the collectives of one step (its first, under
    CommDebugMode) and, on rank 0 of an f32 run, the largest param
    difference from the unsharded twin's params (saved in ``twin_dir``)
    over the largest param."""
    import gc
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.steps import (make_optimizer,
                                          make_sharded_train_step)
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device_type == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device(device_type))
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    results = {}
    for run in runs:
        name, _, dtype, shape, batch, seq = run
        mesh = DeviceMesh(device_type, torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        cfg = tm_config(run)
        api = get_model(cfg)
        params = sh.shard_params(tm_params(api, dev), cfg, mesh)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        opt_init, opt_update = make_optimizer()
        opt = opt_init(params)
        step = make_sharded_train_step(api, opt_update, mesh)
        losses, norms, secs, comm_counts = [], [], [], None
        for i, b in enumerate(tm_batches(cfg, batch, seq, dev)):
            sync()
            t0 = time.perf_counter()
            if i == 0:
                with CommDebugMode() as comm:
                    params, opt, m = step(params, opt, b)
                comm_counts = {str(k): v for k, v in
                               comm.get_comm_counts().items()}
            else:
                params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
            norms.append(float(m["grad_norm"]))
        out = {"losses": losses, "grad_norms": norms,
               "step_ms": [x * 1e3 for x in secs],
               "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if cuda else None),
               "collectives_step1": comm_counts, "device": str(dev),
               "local_param_gb": sum(t.to_local().numel() * t.element_size()
                                     for t in leaves(params)) / 1e9}
        if dtype == "float32":
            full = [t.full_tensor() for t in leaves(params)]
            if mesh.get_rank() == 0:
                twin = torch.load(os.path.join(twin_dir, name + ".pt"),
                                  mmap=True)
                largest = max(float(w.abs().max()) for w in twin)
                out["param_err"] = max(
                    float((a.cpu() - w).abs().max()) for a, w in
                    zip(full, twin)) / largest
            del full
        results[name] = out
        del params, opt, step, mesh
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return results


def train_mesh_phase(dev, smi):
    """Phase 16 (module docstring): runs (R)-(V), the sharded LLM train step
    on the card.  Returns the launch counts of the runs (none: no kernel
    runs in a train step)."""
    import gc
    import re
    import shutil
    import tempfile
    from repro_torch.launch.mesh import spawn
    from repro_torch.optim.adamw import leaves

    launches = dict.fromkeys(COUNTED, 0)

    def emit_row(run, row):
        emit({"phase": "train_mesh", "run": run, "nvidia_smi": smi, **row})

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()

    twin_dir = tempfile.mkdtemp(prefix="chip_smoke_twins_")
    try:
        # The unsharded twins on this card, first: the ranks then have the
        # card's memory to themselves.
        twins = {}
        for run in TM_RUNS:
            fresh()
            (losses, norms, params), counts = counted_into(
                launches, lambda: tm_unsharded(run, dev))
            check_counts(run[0], counts, expect())
            twins[run[0]] = {"losses": losses, "grad_norms": norms}
            if run[2] == "float32":
                torch.save([t.cpu() for t in leaves(params)],
                           os.path.join(twin_dir, run[0] + ".pt"))
            del params
            if run[2] != "float32":
                fresh()
                f32_losses, f32_norms, _ = tm_unsharded(run, dev,
                                                        upcast=True)
                twins[run[0]].update(f32_losses=f32_losses,
                                     f32_grad_norms=f32_norms)
        fresh()
        t0 = time.perf_counter()
        backend = mesh_backend(TM_WORLD)
        (ranks), counts = counted_into(launches, lambda: spawn(
            train_mesh_rank, TM_WORLD, backend, list(TM_RUNS), twin_dir,
            dev.type, timeout=900.0))
        check_counts("R-T", counts, expect())
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(twin_dir)

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    for run in TM_RUNS:
        name, arch, dtype, shape, batch, seq = run
        got = [r[name] for r in ranks]
        twin = twins[name]
        errs = {k: max(rel(g[k], twin[k]) for g in got)
                for k in ("losses", "grad_norms")}
        if dtype == "float32":
            tol = {"losses": TM_RTOL, "grad_norms": TM_RTOL}
            errs["params"] = got[0]["param_err"]
            tol["params"] = TM_PARAM_TOL
        else:
            # Two correct bf16 paths part by bf16 rounding noise: each is
            # held to BF16_NOISE_FACTOR times the unsharded bf16 step's
            # distance from its f32 twin (the same params in f32).
            tol = {k: BF16_NOISE_FACTOR * rel(twin[k], twin["f32_" + k])
                   for k in ("losses", "grad_norms")}
        bad = {k: (errs[k], tol[k]) for k in errs if not errs[k] <= tol[k]}
        if bad or not np.isfinite([x for g in got for x in
                                   g["losses"] + g["grad_norms"]]).all():
            raise AssertionError(f"{name}: {bad} (error, tolerance) from the "
                                 f"unsharded step; {got[0]['losses']} "
                                 f"against {twin['losses']}")
        cfg = tm_config(run)
        emit_row(name, {
            "model": cfg.name, "dtype": dtype, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "mesh": list(shape), "backend": backend,
            "placement": f"{TM_WORLD} ranks sharing "
                         f"{torch.cuda.device_count()} card(s)",
            "batch": batch, "seq": seq, "steps": TM_STEPS,
            "losses": got[0]["losses"], "grad_norms": got[0]["grad_norms"],
            "unsharded": twin, "max_rel_err": errs, "tolerance": tol,
            "step_ms_by_rank": [g["step_ms"] for g in got],
            "peak_gb_by_rank": [g["peak_gb"] for g in got],
            "local_param_gb_by_rank": [g["local_param_gb"] for g in got],
            "collectives_step1_rank0": got[0]["collectives_step1"],
            "launches": expect()})
    emit_row("R_T_ranks", {"wall_s": ranks_s, "world": TM_WORLD})

    # -- (U) the launcher under torch.distributed.run ----------------------
    fresh()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = {**os.environ, "PYTHONPATH": src}
    argv = ["--arch", QWEN_ARCH, "--reduced", "--steps",
            str(TM_LAUNCH_STEPS), "--log-every", "1"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone"]

    def launched(cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, env=env)
        return proc, time.perf_counter() - t0

    def losses_of(text):
        return re.findall(r"^step +\d+ loss (\S+) gnorm (\S+)", text,
                          re.MULTILINE)

    alone, alone_s = launched(
        [sys.executable, "-m", "repro_torch.launch.train", *argv])
    grouped, grouped_s = launched(
        torchrun + ["--nproc-per-node=1", "-m", "repro_torch.launch.train",
                    *argv])
    refused, _ = launched(
        torchrun + [f"--nproc-per-node={TM_WORLD}", "-m",
                    "repro_torch.launch.train", *argv, "--production-mesh"])
    want, got = losses_of(alone.stdout), losses_of(grouped.stdout)
    if (alone.returncode or grouped.returncode or len(want)
            != TM_LAUNCH_STEPS or got != want):
        raise AssertionError(
            f"U: launch.train exited {alone.returncode} alone, "
            f"{grouped.returncode} under torch.distributed.run; losses "
            f"{want} against {got}: {grouped.stdout[-2000:]}"
            f"{grouped.stderr[-2000:]}")
    if refused.returncode == 0 or "needs 256 ranks but only 4 present" \
            not in refused.stdout + refused.stderr:
        raise AssertionError(f"U: --production-mesh on {TM_WORLD} ranks "
                             f"exited {refused.returncode}: "
                             f"{refused.stderr[-2000:]}")
    emit_row("U_launch_train_torchrun", {
        "argv": argv, "nproc": 1, "backend": "nccl", "mesh": "host (1, 1)",
        "losses_gnorms": got, "equal_to_no_group": True,
        "wall_s": {"no_group": alone_s, "torchrun": grouped_s},
        "production_mesh_on_4_ranks": "RuntimeError: needs 256 ranks"})

    # -- (V) the dry run on a fake (16, 16) group --------------------------
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         QWEN_ARCH, "--shape", "train_4k"], capture_output=True, text=True,
        timeout=600, env=env)
    wall = time.perf_counter() - t0
    blob_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "experiments", "dryrun_torch",
                             f"{QWEN_ARCH}__train_4k__16x16.json")
    if proc.returncode or not os.path.exists(blob_path):
        raise AssertionError(f"V: dryrun exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    with open(blob_path) as f:
        blob = json.load(f)
    emit_row("V_dryrun_qwen3_8b_train_4k", {
        "torch": torch.__version__, "wall_s": wall,
        **{k: blob[k] for k in ("mesh", "n_chips", "n_layers", "param_bytes",
                                "opt_bytes", "per_rank", "hlo_flops",
                                "collectives", "trace_s")}})
    return launches


def uncut_rank(rank, world, run, device_type):
    """One rank of the uncut run: TM_STEPS sharded steps; (losses,
    gradient norms, wall ms a step, peak GB, the first step's
    collectives)."""
    import gc
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.base import get_config
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.steps import (make_optimizer,
                                          make_sharded_train_step)
    from repro_torch.models.api import get_model
    cuda = device_type == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device(device_type))
    mesh = DeviceMesh(device_type, torch.arange(world).reshape(run[3]),
                      mesh_dim_names=("data", "model"))
    cfg = get_config(run[1])
    api = get_model(cfg)
    params = sh.shard_params(tm_params(api, dev), cfg, mesh)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    opt_init, opt_update = make_optimizer(TM_UNCUT_LR, warmup=1,
                                          steps=TM_STEPS)
    opt = opt_init(params)
    step = make_sharded_train_step(api, opt_update, mesh)
    losses, norms, secs = [], [], []
    for i, b in enumerate(tm_batches(cfg, run[4], run[5], dev)):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with CommDebugMode() if i == 0 else contextlib.nullcontext() as comm:
            params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
        if i == 0:
            counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    return {"losses": losses, "grad_norms": norms,
            "step_ms": [x * 1e3 for x in secs], "device": str(dev),
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else None),
            "collectives_step1": counts}


def train_mesh_uncut(dev, smi):
    """chip_mesh.py's phase-16 run that one card cannot hold: qwen3-8b
    uncut (7.57B params: ~91 GB of params, gradients and moments) on a
    (1, 4) mesh, one rank per card over NCCL.  Its first loss is held to
    the unsharded forward-only loss of the same params and batch on card 0
    (the params alone fit): within BF16_NOISE_FACTOR times that loss's
    distance from its f32 twin's; the losses stay finite and fall."""
    import gc
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.api import get_model
    run = TM_UNCUT
    world = run[3][0] * run[3][1]
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"the uncut run needs {world} cards, one rank "
                           f"each; {torch.cuda.device_count()} present")
    launches = dict.fromkeys(COUNTED, 0)
    cfg = get_config(run[1])
    batch = tm_batches(cfg, run[4], run[5], dev)[0]
    fwd = {}
    for upcast in (False, True):
        params = tm_params(get_model(cfg), dev, upcast)
        api = get_model(cfg.with_(dtype=torch.float32) if upcast else cfg)
        with torch.no_grad():
            loss, counts = counted_into(launches,
                                        lambda: float(api.loss(params, batch)))
        check_counts("uncut forward", counts, expect())
        fwd["f32" if upcast else "bf16"] = loss
        del params
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(uncut_rank, world, mesh_backend(world), run, dev.type,
                  timeout=900.0)
    wall = time.perf_counter() - t0
    losses = ranks[0]["losses"]
    err = abs(losses[0] - fwd["bf16"]) / abs(fwd["bf16"])
    tol = BF16_NOISE_FACTOR * abs(fwd["bf16"] - fwd["f32"]) / abs(fwd["f32"])
    if any(r["losses"] != losses for r in ranks) or not np.isfinite(
            losses + ranks[0]["grad_norms"]).all() or err > tol \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"uncut: losses {[r['losses'] for r in ranks]}"
                             f", forward-only {fwd}, error {err} against "
                             f"{tol}")
    emit({"phase": "train_mesh", "run": run[0], "nvidia_smi": smi,
          "model": cfg.name, "layers": cfg.n_layers, "dtype": run[2],
          "mesh": list(run[3]), "backend": mesh_backend(world),
          "placement": "one rank per card", "batch": run[4],
          "seq": run[5], "steps": TM_STEPS, "lr": TM_UNCUT_LR,
          "losses": losses, "grad_norms": ranks[0]["grad_norms"],
          "forward_only_loss": fwd, "step1_rel_err": err, "tolerance": tol,
          "step_ms_by_rank": [r["step_ms"] for r in ranks],
          "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
          "devices": [r["device"] for r in ranks],
          "collectives_step1_rank0": ranks[0]["collectives_step1"],
          "wall_s": wall, "launches": launches})
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs on an NVIDIA GPU")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.configs import icsml_mlp
    from repro_torch.configs import msf_detector as spec
    from repro_torch.configs.base import get_config
    from repro_torch.core import prune, quantize
    from repro_torch.core import layers as L
    from repro_torch.core.model import sequential
    from repro_torch.kernels import (build, fused_mlp, ops, qmatmul, ref,
                                     sparse_matmul, ssd_scan)
    from repro_torch.models.api import get_model
    from repro_torch.serving import (AdaptConfig, Engine, GroupedStreamEngine,
                                     ModelGroup, Request, StreamEngine)
    from repro_torch.sim import (ClassifierHead, ForecastHead, MarginHead,
                                 ReconstructionHead, build_autoencoder,
                                 build_detector, build_fleet, build_forecaster,
                                 build_margin_model, fleet_readings)
    from repro_torch.codegen import export_st, verify_export, window_starts
    from repro_torch.core import memory as memlib
    from repro_torch.core import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    started = last = time.perf_counter()
    seconds = {}

    def phase_done(name):
        """Wall seconds since the previous phase ended."""
        nonlocal last
        now = time.perf_counter()
        seconds[name] = now - last
        last = now
    card_gen = torch.Generator(device=dev)

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    phase_done("device")
    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "smem" in ln
                           or "spill" in ln]
                    for name, log in reports.items()}})

    # The fleet's readings and its first (benign) windows, normalized as
    # the engine normalizes them: realistic inputs for phase 3 and the
    # calibration data for phase 4.
    grouped_readings = np.tile(fleet_readings(N_PLANTS, N_CYCLES, seed=0),
                               (1, GROUP_TILE, 1))
    readings = grouped_readings[:, :N_PLANTS * TILE]
    n_streams = readings.shape[1]

    def normalized_windows(start):
        """The fleet's windows of cycles [start, start + WINDOW), as the
        engine normalizes and unrolls them: (4096, 400) f32 on the card."""
        w = (grouped_readings[start:start + spec.WINDOW]
             - np.asarray(spec.NORM_MEAN, np.float32)) \
            / np.asarray(spec.NORM_STD, np.float32)
        w = w.transpose(1, 0, 2).reshape(grouped_readings.shape[1], -1)
        return torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(dev)

    group_windows = normalized_windows(0)               # first windows
    windows = group_windows[:n_streams]
    first = windows.cpu().numpy()

    def card_model(builder, scheme, seed):
        model = builder()
        params = model.init_params(torch.Generator().manual_seed(seed),
                                   device=dev)
        if scheme != "REAL":
            params = quantize.quantize_params(
                model, params, scheme,
                calibration=quantize.calibration_samples(
                    first[:, :model.input_shape[0]], k=32, device=dev))
        return model, params

    fleet_builders = (build_detector, build_autoencoder, build_margin_model,
                      build_forecaster)

    def fleet_models(scheme, seed, softmax=False):
        """(model, params) per §7 head; ``softmax`` ends the classifier in
        a softmax (the one activation the grouped kernel masks)."""
        models = [card_model(b, scheme, seed + i)
                  for i, b in enumerate(fleet_builders)]
        if softmax:
            clf = sequential(
                [L.Input()] + [L.Dense(units=h, activation="relu")
                               for h in spec.HIDDEN]
                + [L.Dense(units=spec.CLASSES, activation="softmax")],
                (spec.INPUT_SIZE,))
            models[0] = (clf, models[0][1])
        return models

    def fleet_targets(x, center):
        """The engine's epilogue targets for the four-head fleet: zeros
        (classifier), the window (autoencoder), the center (margin), the
        window's newest reading (forecaster)."""
        tgt = torch.zeros_like(x)
        tgt[1] = x[1]
        tgt[2, :, :center.shape[0]] = center
        tgt[3, :, :spec.N_FEATURES] = x[3, :, -spec.N_FEATURES:]
        return tgt

    phase_done("build")
    # -- 3. kernels vs their plain versions ---------------------------------
    fused_rows, fused_err = [], 0.0
    for name, builder in (("detector", build_detector),
                          ("autoencoder", build_autoencoder)):
        for scheme in SCHEMES:
            model, params = card_model(builder, scheme, seed=1)
            stack = ops.dense_stack(model, params)
            prepared = ops.prepare_fused(stack)
            for m in (1024, 1000, 37):
                x = windows[:m].contiguous()
                got = fused_mlp.fused_mlp(x, prepared)
                want = ref.fused_mlp_ref(x, stack)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if scheme == "SINT":
                    ok = torch.equal(got, want)
                else:
                    ok = torch.allclose(got, want, rtol=TOL[scheme],
                                        atol=TOL[scheme])
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError(
                        f"fused_mlp {name} {scheme} M={m}: kernel disagrees "
                        f"with the plain version (max abs err {err})")
                fused_err = max(fused_err, err)
                row = {"stack": name, "scheme": scheme, "m": m,
                       "path": prepared.path, "max_abs_err": err}
                if m == 1024:
                    row["ms"] = kernel_ms(lambda: fused_mlp.fused_mlp(
                        x, prepared), 50, "fused_mlp_kernel")
                    row["call_ms"] = time_ms(lambda: fused_mlp.fused_mlp(
                        x, prepared), 200)
                    row["plain_ms"] = time_ms(lambda: ref.fused_mlp_ref(
                        x, stack), 20)
                    row["bound_ms"], row["bound_by"] = fused_bound(x,
                                                                   prepared)
                    row["bound_us"] = row["bound_ms"] * 1e3
                fused_rows.append(row)
                emit({"phase": "kernels", "kernel": "fused_mlp", **row})

    def sequential_model(widths, acts, k0):
        return lambda: sequential([L.Input()] + [
            L.Dense(units=w, activation=a) for w, a in zip(widths, acts)],
            (k0,))

    def check_fused(what, stack, scheme, ms, k0=spec.INPUT_SIZE):
        """Untimed: the kernel against its plain version at each M."""
        nonlocal fused_err
        prepared = ops.prepare_fused(stack)
        worst = 0.0
        for m in ms:
            x = windows[:m, :k0].contiguous()
            got = fused_mlp.fused_mlp(x, prepared)
            want = ref.fused_mlp_ref(x, stack)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = (torch.equal(got, want) if scheme == "SINT" else
                  torch.allclose(got, want, rtol=TOL[scheme],
                                 atol=TOL[scheme]))
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(f"fused_mlp {what} {scheme} M={m}: "
                                     f"kernel disagrees with the plain "
                                     f"version (max abs err {err})")
            worst = max(worst, err)
        fused_err = max(fused_err, worst)
        emit({"phase": "kernels", "kernel": "fused_mlp", "case": what,
              "scheme": scheme, "path": prepared.path, "m": list(ms),
              "max_abs_err": worst})

    # The new tile's edges, widths off both MMA granules (K 37, N 13/5/3)
    # and a stack that is not all int8 (the f32-tile path).
    for name, builder in (("detector", build_detector),
                          ("autoencoder", build_autoencoder)):
        for scheme in ("SINT", "REAL"):
            check_fused(f"{name} tile edges", ops.dense_stack(
                *card_model(builder, scheme, seed=1)), scheme, EDGE_MS)

    build_ragged = sequential_model((13, 5, 3), ("relu", "relu", "linear"),
                                    37)
    for scheme in SCHEMES:
        check_fused("37-13-5-3", ops.dense_stack(
            *card_model(build_ragged, scheme, seed=1)), scheme,
            (1, 9, 1000), k0=37)
    # The REAL layer goes last: ahead of a SINT layer a last-bit difference
    # in its f32 sum can move a code by a whole step (in the plain version
    # as much as in the kernel), which no f32 tolerance holds.
    sint = ops.dense_stack(*card_model(build_detector, "SINT", seed=1))
    real = ops.dense_stack(*card_model(build_detector, "REAL", seed=1))
    mixed = sint[:3] + real[3:]
    if fused_mlp.path(ops.prepare_fused(mixed)) != fused_mlp.F32_TILE:
        raise AssertionError("fused_mlp: a mixed stack is not on the f32 "
                             "tile path")
    check_fused("detector SINT with a REAL last layer", mixed, "REAL",
                (1000, 37))

    q_rows, q_err = [], 0.0
    model, params = card_model(build_detector, "SINT", seed=1)
    h = windows
    for p, act in ops.dense_stack(model, params):
        # The per-layer step's own quantization of each layer's input.
        qmax = torch.iinfo(p["qw"].dtype).max
        for m in (1024, 1000, 37):
            xq = torch.clamp(torch.round(h[:m] / p["x_scale"]), -qmax,
                             qmax).to(torch.int8).contiguous()
            scale = (p["x_scale"] * p["w_scale"]).contiguous()
            got = qmatmul.qmatmul(xq, p["qw"], scale, p["b"])
            want = ref.qmatmul_ref(xq, p["qw"], scale, p["b"])
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"qmatmul {tuple(xq.shape)}x{tuple(p['qw'].shape)}: "
                    f"kernel disagrees with the plain version ({err})")
            q_err = max(q_err, err)
            row = {"m": m, "k": xq.shape[1], "n": p["qw"].shape[1],
                   "max_abs_err": err}
            if m == 1024:
                row["ms"] = kernel_ms(lambda: qmatmul.qmatmul(
                    xq, p["qw"], scale, p["b"]), 50, "qmatmul_kernel")
                row["call_ms"] = time_ms(lambda: qmatmul.qmatmul(
                    xq, p["qw"], scale, p["b"]), 200)
                row["plain_ms"] = time_ms(lambda: ref.qmatmul_ref(
                    xq, p["qw"], scale, p["b"]), 20)
                row["bound_ms"], row["bound_by"] = qmatmul_bound(
                    xq, p["qw"], scale, p["b"])
                row["bound_us"] = row["bound_ms"] * 1e3
            q_rows.append(row)
            emit({"phase": "kernels", "kernel": "qmatmul", **row})
        h = ref.dense_layer_ref(h, p, act)

    g_rows, g_err = [], 0.0
    gx_all = group_windows.view(len(GROUPS), n_streams, -1)
    kinds = (ops.GROUPED_KIND_LOGITS,) + (ops.GROUPED_KIND_SCORE,) * 3
    # "SINT-ae-alone": a one-group fleet of the SINT autoencoder, the same
    # work as the fused_mlp autoencoder row above, so the two kernels'
    # per-block code compares like for like.
    for scheme in SCHEMES + ("SINT-softmax", "SINT-ae-alone"):
        base = scheme.split("-")[0]
        models = fleet_models(base, seed=1, softmax=scheme == "SINT-softmax")
        stacks = [ops.dense_stack(m, p) for m, p in models]
        center = ref.fused_mlp_ref(gx_all[2], stacks[2]).mean(dim=0)
        if scheme == "SINT-ae-alone":
            stacks, fleet_kinds = stacks[1:2], kinds[1:2]
        else:
            fleet_kinds = kinds
        plan, arrays = ops.build_grouped_plan(stacks, fleet_kinds,
                                              k0=spec.INPUT_SIZE)
        prepared = ops.prepare_grouped(plan, arrays)
        plain_stacks = [list(zip(arrays["stacks"][g], plan.acts[g]))
                        for g in range(plan.n_groups)]
        ms_sizes = {"SINT-softmax": (1000,), "SINT-ae-alone": (1024,)}
        for m in ms_sizes.get(scheme, (1024, 1000, 37)):
            if scheme == "SINT-ae-alone":
                x = gx_all[1:2, :m].contiguous()
                tgt = x.clone()
            else:
                x = gx_all[:, :m].contiguous()
                tgt = fleet_targets(x, center)

            def plain():
                return ref.grouped_mlp_ref(
                    x, plain_stacks, kinds=plan.kinds,
                    true_k0s=plan.true_k0s, n_outs=plan.n_outs, tgt=tgt,
                    n_pay=plan.payload_width)

            got = fused_mlp.grouped_fused_mlp(x, prepared, tgt)
            want = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if scheme in ("SINT", "SINT-ae-alone"):
                ok = all(torch.equal(got[g], want[g]) if k == 0 else
                         torch.allclose(got[g], want[g], rtol=1e-5, atol=0)
                         for g, k in enumerate(plan.kinds))
            else:
                tol = TOL["REAL" if scheme != base else base]
                ok = torch.allclose(got, want, rtol=tol, atol=tol)
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(
                    f"grouped_fused_mlp {scheme} M={m}: kernel disagrees "
                    f"with the plain version (max abs err {err})")
            g_err = max(g_err, err)
            row = {"fleet": ("ae" if scheme == "SINT-ae-alone"
                             else "clf+ae+margin+forecast"),
                   "scheme": scheme, "m_per_group": m,
                   "path": prepared.path, "max_abs_err": err}
            if m == 1024:
                row["ms"] = kernel_ms(lambda: fused_mlp.grouped_fused_mlp(
                    x, prepared, tgt), 50, "grouped_mlp_kernel")
                row["call_ms"] = time_ms(lambda: fused_mlp.grouped_fused_mlp(
                    x, prepared, tgt), 200)
                row["plain_ms"] = time_ms(plain, 20)
                row["bound_ms"], row["bound_by"] = grouped_bound(
                    x, got, plan, arrays)
                row["bound_us"] = row["bound_ms"] * 1e3
            g_rows.append(row)
            emit({"phase": "kernels", "kernel": "grouped_fused_mlp", **row})

    def check_grouped(what, stacks, fleet_kinds, scheme, ms, targets):
        """Untimed: the grouped kernel against its plain version at each M
        per group; ``targets(x, plan)`` gives the epilogue targets."""
        nonlocal g_err
        plan, arrays = ops.build_grouped_plan(stacks, fleet_kinds,
                                              k0=spec.INPUT_SIZE)
        prepared = ops.prepare_grouped(plan, arrays)
        plain_stacks = [list(zip(arrays["stacks"][g], plan.acts[g]))
                        for g in range(plan.n_groups)]
        worst = 0.0
        for m in ms:
            x = gx_all[:plan.n_groups, :m].contiguous()
            tgt = targets(x, plan)
            got = fused_mlp.grouped_fused_mlp(x, prepared, tgt)
            want = ref.grouped_mlp_ref(
                x, plain_stacks, kinds=plan.kinds, true_k0s=plan.true_k0s,
                n_outs=plan.n_outs, tgt=tgt, n_pay=plan.payload_width)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if scheme == "SINT":
                ok = all(torch.equal(got[g], want[g]) if k == 0 else
                         torch.allclose(got[g], want[g], rtol=1e-5, atol=0)
                         for g, k in enumerate(plan.kinds))
            else:
                ok = torch.allclose(got, want, rtol=TOL[scheme],
                                    atol=TOL[scheme])
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(
                    f"grouped_fused_mlp {what} {scheme} M={m}: kernel "
                    f"disagrees with the plain version (max abs err {err})")
            worst = max(worst, err)
        g_err = max(g_err, worst)
        emit({"phase": "kernels", "kernel": "grouped_fused_mlp",
              "case": what, "scheme": scheme, "path": prepared.path,
              "m_per_group": list(ms), "max_abs_err": worst})

    # The four-head fleet at the new tile's edges, and a fleet whose groups
    # differ in true widths at every position (inputs 400, 397, 250 of the
    # 400-wide union; depths 4, 3, 4).
    for scheme in ("SINT", "REAL"):
        models = fleet_models(scheme, seed=1)
        stacks = [ops.dense_stack(m, p) for m, p in models]
        center = ref.fused_mlp_ref(gx_all[2], stacks[2]).mean(dim=0)
        check_grouped("four-head tile edges", stacks, kinds, scheme,
                      EDGE_MS, lambda x, plan: fleet_targets(x, center))
        widths = (((64, 32, 16, 2), ("relu",) * 3 + ("linear",), 400),
                  ((45, 21, 7), ("relu", "relu", "linear"), 397),
                  ((96, 40, 33, 11), ("relu",) * 3 + ("linear",), 250))
        stacks = [ops.dense_stack(*card_model(sequential_model(*w), scheme,
                                              seed=20 + i))
                  for i, w in enumerate(widths)]
        check_grouped("true widths 400/397/250", stacks, (0, 1, 0), scheme,
                      (1, 9, 1000),
                      lambda x, plan: x[:, :, :plan.n_out].contiguous())

    # qmatmul at the LLM paths' SINT projections, over a prefill and over a
    # decode step of their batches: mamba2-370m's in_proj and out_proj
    # (MAMBA_BATCH x MAMBA_PROMPT tokens, run (j)); qwen3-8b's four shapes
    # (LLM_BATCH x LLM_PROMPT tokens, run (u): K = 12288 walks 96 K steps,
    # the 4096 x 12288 weight is 50 MB at decode); granite-moe's two
    # attention shapes at the largest admission prefill of run (x) and its
    # 8-slot decode.
    mcfg = get_config(MAMBA_ARCH)
    qcfg, gcfg = get_config(QWEN_ARCH), get_config(GRANITE_ARCH)
    proj_out = 2 * mcfg.d_inner + 2 * mcfg.ssm_groups * mcfg.ssm_state \
        + mcfg.ssm_heads
    q_d, q_kv = qcfg.d_model, qcfg.n_kv_heads * qcfg.d_head
    g_d, g_kv = gcfg.d_model, gcfg.n_kv_heads * gcfg.d_head
    llm_shapes = [
        ("mamba2 in_proj", mcfg.d_model, proj_out,
         (MAMBA_BATCH * MAMBA_PROMPT, MAMBA_BATCH)),
        ("mamba2 out_proj", mcfg.d_inner, mcfg.d_model,
         (MAMBA_BATCH * MAMBA_PROMPT, MAMBA_BATCH)),
        ("qwen3-8b wq/wo", q_d, q_d, (LLM_BATCH * LLM_PROMPT, LLM_BATCH)),
        ("qwen3-8b wk/wv", q_d, q_kv, (LLM_BATCH * LLM_PROMPT, LLM_BATCH)),
        ("qwen3-8b gate/up", q_d, qcfg.d_ff,
         (LLM_BATCH * LLM_PROMPT, LLM_BATCH)),
        ("qwen3-8b down", qcfg.d_ff, q_d,
         (LLM_BATCH * LLM_PROMPT, LLM_BATCH)),
        ("granite-moe wq/wo", g_d, g_d, (CONT_PROMPTS[1], CONT_SLOTS)),
        ("granite-moe wk/wv", g_d, g_kv, (CONT_PROMPTS[1], CONT_SLOTS)),
    ]
    # Phase 13's families: Jamba (run (A): 4 x 1024 prompt tokens), LLaVA
    # (run (D): 2 x (2880 image + 512 text) tokens) and Whisper (run (F):
    # the encoder's 8 x 1500 frames), each also at M = 8.
    jcfg, lcfg, wcfg = (get_config(a) for a in (JAMBA_ARCH, LLAVA_ARCH,
                                                WHISPER_ARCH))
    j_m = (JAMBA_BATCH * JAMBA_PROMPT, 8)
    l_m = (LLAVA_BATCH * (lcfg.num_image_tokens + LLAVA_TEXT), 8)
    w_m = (WHISPER_BATCH * wcfg.encoder_frames, 8)
    j_d, l_d, w_d = jcfg.d_model, lcfg.d_model, wcfg.d_model
    llm_shapes += [
        ("jamba in_proj", j_d, 2 * jcfg.d_inner + 2 * jcfg.ssm_groups
         * jcfg.ssm_state + jcfg.ssm_heads, j_m),
        ("jamba out_proj", jcfg.d_inner, j_d, j_m),
        ("jamba wq/wo", j_d, j_d, j_m),
        ("jamba wk/wv", j_d, jcfg.n_kv_heads * jcfg.d_head, j_m),
        ("jamba gate/up", j_d, jcfg.d_ff, j_m),
        ("jamba down", jcfg.d_ff, j_d, j_m),
        ("llava wq/wo", l_d, l_d, l_m),
        ("llava wk/wv", l_d, lcfg.n_kv_heads * lcfg.d_head, l_m),
        ("llava gate/up", l_d, lcfg.d_ff, l_m),
        ("llava down", lcfg.d_ff, l_d, l_m),
        ("whisper attention", w_d, w_d, w_m),
        ("whisper up", w_d, wcfg.d_ff, w_m),
        ("whisper down", wcfg.d_ff, w_d, w_m),
    ]
    for name, k, n, ms, m in [(*shape, m) for shape in llm_shapes
                              for m in shape[3]]:
        card_gen.manual_seed(k + n + m)
        xq = torch.randint(-127, 128, (m, k), generator=card_gen,
                           device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=card_gen,
                           device=dev, dtype=torch.int8)
        scale = torch.rand(n, generator=card_gen, device=dev) * 1e-4
        got = qmatmul.qmatmul(xq, wq, scale)
        want = ref.qmatmul_ref(xq, wq, scale)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"qmatmul {name} ({m}, {k}, {n}): "
                                 "kernel disagrees with the plain version")
        row = {"m": m, "k": k, "n": n, "layer": name,
               "step": "prefill" if m > ms[1] else "decode",
               "max_abs_err": 0.0,
               "ms": kernel_ms(lambda: qmatmul.qmatmul(xq, wq, scale), 5,
                               "qmatmul_kernel"),
               "call_ms": time_ms(lambda: qmatmul.qmatmul(xq, wq, scale),
                                  10),
               "plain_ms": time_ms(lambda: ref.qmatmul_ref(xq, wq, scale),
                                   3),
               "path": qmatmul.path(m)}
        row["bound_ms"], row["bound_by"] = qmatmul_bound(xq, wq, scale, None)
        if row["step"] == "prefill":
            # A yardstick, not a library_ms: torch._int_mm gives the int32
            # product alone, with no dequantization epilogue.
            row["int_mm_ms"] = time_ms(lambda: torch._int_mm(xq, wq), 10)
            row["int_mm_is"] = "int32 product only, no epilogue"
        q_rows.append(row)
        emit({"phase": "kernels", "kernel": "qmatmul", **row})

    # qmatmul on both sides of its path switch (M >= 64: tensor cores), at a
    # fleet width, at mamba2-370m's two widths with K cut to 256 (N 4384
    # keeps its ragged last tile), at N = 2, and from an operand one byte
    # off 16-byte alignment (the byte-wise instances): all torch.equal.
    for (k, n), m in itertools.product(
            ((400, 64), (256, 4384), (256, 1024), (16, 2)),
            (8, 63, 64, 65, 1000)):
        card_gen.manual_seed(k * n + m)
        xq = torch.randint(-127, 128, (m, k), generator=card_gen,
                           device=dev, dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=card_gen,
                           device=dev, dtype=torch.int8)
        scale = torch.rand(n, generator=card_gen, device=dev) * 1e-3
        bias = torch.randn(n, generator=card_gen, device=dev)
        cases = [("aligned", xq)]
        if (k, n) == (256, 4384):
            shifted = torch.empty(m * k + 1, dtype=torch.int8, device=dev)
            shifted[1:] = xq.reshape(-1)
            cases.append(("unaligned", shifted[1:].view(m, k)))
        for what, operand in cases:
            if not torch.equal(qmatmul.qmatmul(operand, wq, scale, bias),
                               ref.qmatmul_ref(xq, wq, scale, bias)):
                raise AssertionError(f"qmatmul ({m}, {k}, {n}) {what}: "
                                     "kernel disagrees with the plain "
                                     "version")
            emit({"phase": "kernels", "kernel": "qmatmul", "case": what,
                  "m": m, "k": k, "n": n, "path": qmatmul.path(m),
                  "max_abs_err": 0.0})

    # sparse_matmul: the §6.2 pruned layer, its 784 inputs padded to whole
    # 128-blocks as benchmarks/pruning_bench.py pads them.
    n_in, n_out = icsml_mlp.PRUNE_LAYER
    k_pad = -(-n_in // 128) * 128

    def prune_weight(sparsity, block, seed):
        card_gen.manual_seed(seed)
        w = torch.randn((k_pad, n_out), generator=card_gen, device=dev)
        return prune.compress_blocks(
            prune.block_magnitude_prune(w, sparsity, block), block)

    def prune_input(m):
        card_gen.manual_seed(m)
        return torch.randn((m, k_pad), generator=card_gen, device=dev)

    def stale_output(m):
        """NaNs in the allocator's next (m, n_out) block: an output element
        the kernel does not write shows."""
        torch.full((m, n_out), float("nan"), device=dev)

    def check_sparse(what, x, w, want):
        stale_output(x.shape[0])
        got = sparse_matmul.sparse_matmul(x, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        dead = (w.to_dense() == 0).all(dim=0)
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4) \
                or not bool((got[:, dead] == 0).all()):
            raise AssertionError(f"sparse_matmul {what}: kernel disagrees "
                                 f"with the plain version ({err})")
        return err, int(dead.sum()) // w.block[1]

    s_rows, s_err = [], 0.0
    for sparsity, block in ([(s_, (128, 128)) for s_ in (0.0, 0.25, 0.5,
                                                         0.75)]
                            + [(0.5, (64, 64))]):
        w = prune_weight(sparsity, block, seed=5)
        dense = w.to_dense()
        for m in PRUNE_CHECK_MS:
            # Both sides of the small-M switch, untimed; and the same bits
            # from a second call (no atomics).
            x = prune_input(m)
            err, _ = check_sparse(f"{block} s={sparsity} M={m}", x, w,
                                  ref.sparse_matmul_ref(x, w))
            s_err = max(s_err, err)
            if not torch.equal(sparse_matmul.sparse_matmul(x, w),
                               sparse_matmul.sparse_matmul(x, w)):
                raise AssertionError(f"sparse_matmul {block} s={sparsity} "
                                     f"M={m}: two calls differ")
            emit({"phase": "kernels", "kernel": "sparse_matmul",
                  "case": "check", "block": list(block),
                  "sparsity": sparsity, "m": m,
                  "path": sparse_matmul.plan(m, w).path,
                  "max_abs_err": err, "deterministic": True})
        for m in PRUNE_MS:
            x = prune_input(m)
            err, dead_cols = check_sparse(f"{block} s={sparsity} M={m}", x,
                                          w, ref.sparse_matmul_ref(x, w))
            s_err = max(s_err, err)
            row = {"block": list(block), "sparsity": sparsity, "m": m,
                   "path": sparse_matmul.plan(m, w).path,
                   "k": k_pad, "n": n_out, "nnz_blocks": w.nnz_blocks,
                   "pruned_block_columns": dead_cols, "max_abs_err": err,
                   "ms": kernel_ms(lambda: sparse_matmul.sparse_matmul(x, w),
                                   50, "sparse_matmul_kernel"),
                   "call_ms": time_ms(
                       lambda: sparse_matmul.sparse_matmul(x, w), 200),
                   "plain_ms": time_ms(lambda: ref.sparse_matmul_ref(x, w),
                                       20),
                   "library_ms": time_ms(lambda: torch.matmul(x, dense),
                                         200),
                   "library_device_ms": graph_ms(
                       lambda: torch.matmul(x, dense), 20)}
            row["bound_ms"], row["bound_by"] = sparse_bound(x, w)
            row["bound_us"] = row["bound_ms"] * 1e3
            s_rows.append(row)
            emit({"phase": "kernels", "kernel": "sparse_matmul", **row})
    card_gen.manual_seed(6)
    w_col = torch.randn((k_pad, n_out), generator=card_gen, device=dev)
    w_col[:, 128:256] = 0.0
    for what, w_dense in (("all-zero weight",
                           torch.zeros((k_pad, n_out), device=dev)),
                          ("a block-column pruned whole", w_col)):
        w = prune.compress_blocks(w_dense, (128, 128))
        x = prune_input(1024)
        err, dead_cols = check_sparse(what, x, w, x @ w_dense)
        s_err = max(s_err, err)
        emit({"phase": "kernels", "kernel": "sparse_matmul", "case": what,
              "nnz_blocks": w.nnz_blocks, "pruned_block_columns": dead_cols,
              "max_abs_err": err})

    # ssd_scan at the Mamba-2 config's and Jamba's SSD widths.
    def ssd_inputs(cfg, bsz, t, seed):
        card_gen.manual_seed(seed)

        def randn(*shape):
            return torch.randn(shape, generator=card_gen, device=dev)
        h, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
        return (randn(bsz, t, h, cfg.ssm_headdim),
                torch.nn.functional.softplus(randn(bsz, t, h)) * 0.2,
                -torch.exp(randn(h) * 0.5),
                randn(bsz, t, g, n) * 0.3, randn(bsz, t, g, n) * 0.3)

    def conv_output_views(cfg, bsz, t, seed):
        """x, B and C as the model hands them to the kernel: bf16 views of
        one (B, T, H P + 2 G N) conv output."""
        card_gen.manual_seed(seed)
        h, g, n, p = (cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_headdim)
        xbc = (torch.randn((bsz, t, h * p + 2 * g * n), generator=card_gen,
                           device=dev) * 0.5).to(torch.bfloat16)
        return (xbc[..., :h * p].reshape(bsz, t, h, p),
                xbc[..., h * p:h * p + g * n].reshape(bsz, t, g, n),
                xbc[..., h * p + g * n:].reshape(bsz, t, g, n))

    def ssd_close(what, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=2e-4, atol=2e-5) \
                or not torch.isfinite(got).all():
            raise AssertionError(f"ssd_scan {what} {tuple(got.shape)}: the "
                                 f"kernel disagrees with the plain version "
                                 f"({err})")
        return err

    ssd_rows, ssd_err = [], 0.0
    for shape, (bsz, t) in SSD_SHAPES.items():
        scfg = jcfg if shape.startswith("jamba") else mcfg
        args = ssd_inputs(scfg, bsz, t, seed=t)
        got, state = ssd_scan.ssd_scan(*args, return_state=True)
        against_recurrence = shape == "vs_sequential"
        plain = functools.partial(ops.ssd, *args, backend=(
            "ref" if against_recurrence else "chunked"))
        err = ssd_close(shape, got, plain())
        state_err = ssd_close(f"{shape} final state", state,
                              ref.ssd_final_state_ref(*args[:4]))
        ssd_err = max(ssd_err, err, state_err)
        row = {"shape": shape, "b": bsz, "t": t, "h": scfg.ssm_heads,
               "p": scfg.ssm_headdim, "n": scfg.ssm_state,
               "g": scfg.ssm_groups,
               "plain": "ssd_scan_ref" if against_recurrence else "ssd_chunked_ref",
               "max_abs_err": err, "state_max_abs_err": state_err}
        if not against_recurrence:
            reps = 20 if t * bsz <= 8192 else 5

            def call():
                return ssd_scan.ssd_scan(*args, return_state=True)
            row["ms"] = kernel_ms(call, reps, "ssd_scan_kernel")
            row["call_ms"] = time_ms(call, reps)
            row["plain_ms"] = time_ms(
                lambda: (plain(), ref.ssd_final_state_ref(*args[:4])), 3)
            row["bound_ms"], row["bound_by"] = ssd_bound(
                *args, got, state, ssd_scan.KERNEL_CHUNK)
            row["bound_us"] = row["bound_ms"] * 1e3
            row["cuda_core_bound_ms"], _ = ssd_cuda_core_bound(*args)
        if shape in ("prefill", "jamba_prefill"):
            # The main path's call: bf16 views of a conv output, read in
            # place; bit-equal to the same call on f32 contiguous copies.
            x16, b16, c16 = conv_output_views(scfg, bsz, t, seed=t + 1)
            dt_, a_ = args[1:3]
            views = (x16, dt_, a_, b16, c16)
            copies = (x16.float().contiguous(), dt_, a_,
                      b16.float().contiguous(), c16.float().contiguous())
            got16 = ssd_scan.ssd_scan(*views, return_state=True)
            want16 = ssd_scan.ssd_scan(*copies, return_state=True)
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(got16, want16)):
                raise AssertionError("ssd_scan: bf16 views differ from the "
                                     "same call on f32 copies")
            # ... and held to the plain versions on the same views.
            y_plain, state_plain = ops.ssd(*views, backend="chunked",
                                           return_state=True)
            row["bf16_views_max_abs_err"] = ssd_close(
                "bf16 views", got16[0], y_plain)
            row["bf16_views_state_max_abs_err"] = ssd_close(
                "bf16 views final state", got16[1], state_plain)
            ssd_err = max(ssd_err, row["bf16_views_max_abs_err"],
                          row["bf16_views_state_max_abs_err"])

            def call16():
                return ssd_scan.ssd_scan(*views, return_state=True)
            row["bf16_views_equal_f32_copies"] = True
            row["bf16_views_ms"] = kernel_ms(call16, reps, "ssd_scan_kernel")
            row["bf16_views_bound_ms"], _ = ssd_bound(
                *views, *got16, ssd_scan.KERNEL_CHUNK)
            del (views, copies, got16, want16, x16, b16, c16, y_plain,
                 state_plain)
        ssd_rows.append(row)
        emit({"phase": "kernels", "kernel": "ssd_scan", **row})
        del args, got, state

    phase_done("kernels")
    # -- 4. serve: the 1024-plant fleet -------------------------------------
    def drive(engine):
        outs, verdicts = [], []
        for c in range(N_CYCLES):
            got = engine.ingest(readings[c])
            if got:
                verdicts.extend(got)
                outs.append(engine.last_logits.copy())
        verdicts.extend(engine.flush())
        if engine.async_depth:
            outs.append(engine.last_logits.copy())
        return verdicts, outs

    cls_sint = card_model(build_detector, "SINT", seed=2)
    cls_real = card_model(build_detector, "REAL", seed=2)
    ae_sint = card_model(build_autoencoder, "SINT", seed=3)
    ae_stack = ops.dense_stack(*ae_sint)
    recon = ref.fused_mlp_ref(windows, ae_stack)
    scores = torch.mean(torch.square(recon - windows), dim=-1)
    ae_head = ReconstructionHead().calibrate(scores.cpu().numpy(),
                                             spec.AE_TARGET_FPR)
    runs = {
        "a_sint_classifier_fused": (cls_sint, "SINT", {}),
        "b_real_classifier_fused": (cls_real, "REAL", {}),
        "c_sint_autoencoder_fused": (ae_sint, "SINT", {"head": ae_head}),
        "d_sint_classifier_per_layer": (cls_sint, "SINT", {"fused": False}),
        "e_sint_classifier_fused_async": (cls_sint, "SINT",
                                          {"async_depth": 1}),
    }
    launches = dict.fromkeys(COUNTED, 0)

    for run, ((model, params), scheme, kw) in runs.items():
        engine = StreamEngine(model, params, n_streams=n_streams, **kw)
        engine.warmup()
        reset_counts()
        verdicts, outs = drive(engine)
        counts = read_counts()
        for k in launches:
            launches[k] += counts[k]
        steps = engine.stats.steps
        want_counts = (expect(qmatmul=4 * steps)
                       if kw.get("fused") is False
                       else expect(fused_mlp=steps))
        if steps != 21 or counts != want_counts:
            raise AssertionError(f"{run}: {steps} steps, launches {counts}, "
                                 f"expected {want_counts}")
        plain = StreamEngine(model, params, n_streams=n_streams,
                             backend="ref", **kw)
        plain.warmup()
        plain_verdicts, plain_outs = drive(plain)
        if [v.pred for v in verdicts] != [v.pred for v in plain_verdicts]:
            raise AssertionError(f"{run}: preds differ from the plain path")
        if len(outs) != len(plain_outs) or len(outs) != steps:
            raise AssertionError(f"{run}: {len(outs)} outputs, {steps} steps")
        for got, want in zip(outs, plain_outs):
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"{run}: bad output {got.shape}")
            if scheme == "SINT":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=TOL["REAL"],
                                           atol=TOL["REAL"])
        stats = engine.stats
        emit({"phase": "serve", "run": run, "streams": n_streams,
              "cycles": stats.cycles, "steps": steps,
              "windows": stats.windows,
              "windows_per_s": stats.windows_per_s(),
              "p50_ms": stats.latency_p(50) * 1e3,
              "p99_ms": stats.latency_p(99) * 1e3,
              "deadline_misses": stats.deadline_misses,
              "dispatches": stats.dispatches, "launches": counts,
              "anomalous_verdicts": int(sum(v.pred for v in verdicts)),
              "plain_windows_per_s": plain.stats.windows_per_s(),
              "plain_p99_ms": plain.stats.latency_p(99) * 1e3})
        if run == "a_sint_classifier_fused":
            profiled = engine

    # The heterogeneous fleet: 4 groups x 1024 plants, one per §7 head.
    calib_windows = normalized_windows(spec.STRIDE // 2).view(
        len(GROUPS), n_streams, -1)

    def fleet_groups(scheme, seed):
        """ModelGroups with heads calibrated through the plain path on the
        off-cadence windows (module docstring)."""
        models = fleet_models(scheme, seed)
        stacks = [ops.dense_stack(m, p) for m, p in models]
        cx = calib_windows
        recon = ref.fused_mlp_ref(cx[1], stacks[1])
        emb = ref.fused_mlp_ref(cx[2], stacks[2])
        center = emb.mean(dim=0)
        fc_in = spec.INPUT_SIZE - spec.N_FEATURES
        pred = ref.fused_mlp_ref(cx[3][:, :fc_in].contiguous(), stacks[3])

        def calibrated(head, out, target):
            scores = torch.mean(torch.square(out - target), dim=-1)
            return head.calibrate(scores.cpu().numpy(), spec.AE_TARGET_FPR)

        heads = (ClassifierHead(),
                 calibrated(ReconstructionHead(), recon, cx[1]),
                 calibrated(MarginHead(center=tuple(
                     float(c) for c in center.cpu().numpy())), emb, center),
                 calibrated(ForecastHead(), pred, cx[3][:, fc_in:]))
        return [ModelGroup(name, model, params, n_streams, head)
                for name, (model, params), head in zip(GROUPS, models, heads)]

    sint_groups = fleet_groups("SINT", seed=4)
    sint_groups[1] = dataclasses.replace(sint_groups[1], adapt=AdaptConfig())
    grouped_runs = {
        "f_sint_fleet_mega_adaptive": (sint_groups, "SINT", {}),
        "g_real_fleet_mega": (fleet_groups("REAL", seed=4), "REAL", {}),
        "h_sint_fleet_per_group": (sint_groups, "SINT",
                                   {"megakernel": False}),
    }
    grouped_results = {}
    for run, (groups, scheme, kw) in grouped_runs.items():
        engine = GroupedStreamEngine(groups, **kw)
        engine.warmup()
        reset_counts()
        verdicts, outs = drive_grouped(engine, grouped_readings)
        counts = read_counts()
        for k in launches:
            launches[k] += counts[k]
        steps = engine.stats.steps
        want_counts = (expect(fused_mlp=4 * steps)
                       if kw.get("megakernel") is False
                       else expect(grouped_mlp=steps))
        if steps != 21 or counts != want_counts:
            raise AssertionError(f"{run}: {steps} steps, launches {counts}, "
                                 f"expected {want_counts}")
        if engine.mega_reason is not None:
            raise AssertionError(f"{run}: fleet does not pack: "
                                 f"{engine.mega_reason}")
        plain = GroupedStreamEngine(groups, backend="ref", **kw)
        plain.warmup()
        plain_verdicts, plain_outs = drive_grouped(plain,
                                                   grouped_readings)
        if [v.pred for v in verdicts] != [v.pred for v in plain_verdicts]:
            raise AssertionError(f"{run}: preds differ from the plain path")
        same_outputs(run, scheme, outs, plain_outs)
        thresholds = engine.live_thresholds()
        np.testing.assert_allclose(
            [t for t in thresholds.values() if t is not None],
            [t for t in plain.live_thresholds().values() if t is not None],
            rtol=TOL["REAL"])
        grouped_results[run] = (verdicts, outs)
        stats = engine.stats
        emit({"phase": "serve", "run": run, "streams": engine.n_streams,
              "groups": len(groups), "cycles": stats.cycles, "steps": steps,
              "windows": stats.windows,
              "windows_per_s": stats.windows_per_s(),
              "p50_ms": stats.latency_p(50) * 1e3,
              "p99_ms": stats.latency_p(99) * 1e3,
              "deadline_misses": stats.deadline_misses,
              "dispatches": stats.dispatches, "launches": counts,
              "anomalous_verdicts": {
                  name: int(sum(v.pred for v in verdicts if v.group == name))
                  for name in GROUPS},
              "live_thresholds": thresholds,
              "plain_windows_per_s": plain.stats.windows_per_s(),
              "plain_p99_ms": plain.stats.latency_p(99) * 1e3})
        if run.startswith("f_"):
            profiled_fleet = engine
    mega, per_group = (grouped_results["f_sint_fleet_mega_adaptive"],
                       grouped_results["h_sint_fleet_per_group"])
    if [v.pred for v in mega[0]] != [v.pred for v in per_group[0]]:
        raise AssertionError("(f) and (h): preds differ between the "
                             "megakernel and the per-group path")
    same_outputs("(f) vs (h)", "SINT", mega[1], per_group[1])

    phase_done("serve_fleet")
    # -- 5. profile: where a serving step's device time goes ----------------
    def profile(run, engine, fleet_readings_, kernel, late=False):
        raw, timing = {}, {}

        def ten_steps():
            reset_counts()
            t0 = time.perf_counter()
            for c in range(spec.WINDOW, spec.WINDOW + 10 * spec.STRIDE):
                engine.ingest(fleet_readings_[c])
            engine.flush()
            torch.cuda.synchronize()
            timing["wall"] = time.perf_counter() - t0

        events = device_events(ten_steps, raw)
        wall = timing["wall"]
        counted = read_counts()
        by_name = {}
        for name, us in events:
            by_name[name] = by_name.get(name, 0.0) + us
        busy_us = sum(by_name.values())
        kernel_events = sum(1 for name, _ in events if kernel in name)
        emit({"phase": "late_profile" if late else "profile", "run": run,
              "steps": 10, "kernel": kernel, "kernel_launches": kernel_events,
              "launches_counted": counted,
              "kineto_kernel_records": sum(kernel in n for n in raw["kineto"]),
              "trace_kernel_records": sum(kernel in n for n in raw["trace"]),
              "kineto_device_records": len(raw["kineto"]),
              "device_events": len(events),
              "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
              "device_busy_share": busy_us / 1e6 / wall,
              "device_events_per_step": len(events) / 10,
              "top_device_us": sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:10]})
        if events and kernel_events != 10:
            raise AssertionError(
                f"profile {run}: {kernel_events} {kernel}s in 10 verdict "
                f"steps, expected one per step (launches {counted}, device "
                f"events {sorted(by_name.items())})")

    profile("a_sint_classifier_fused", profiled, readings, "fused_mlp_kernel")
    profile("f_sint_fleet_mega_adaptive", profiled_fleet, grouped_readings,
            "grouped_mlp_kernel")


    phase_done("profile")
    # -- 6. prune: the §6.2 pruned layer's path ------------------------------
    card_gen.manual_seed(0)
    w_layer = torch.randn((k_pad, n_out), generator=card_gen, device=dev)
    x_layer = prune_input(PRUNE_MS[0])
    reset_counts()
    pruned = []
    for sparsity in (0.0, 0.25, 0.5, 0.75):
        w = prune.compress_blocks(
            prune.block_magnitude_prune(w_layer, sparsity, (128, 128)),
            (128, 128))
        pruned.append((sparsity, w, ops.sparse_dense(x_layer, w)))
    counts = read_counts()
    if counts != expect(sparse_matmul=len(pruned)):
        raise AssertionError(f"prune: launches {counts}")
    launches["sparse_matmul"] += counts["sparse_matmul"]
    for sparsity, w, got in pruned:
        want = ref.sparse_matmul_ref(x_layer, w)
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"prune s={sparsity}: the pruned layer "
                                 "disagrees with the plain version")
        total = (k_pad // 128) * (n_out // 128)
        if w.nnz_blocks != total - round(sparsity * total):
            raise AssertionError(f"prune s={sparsity}: {w.nnz_blocks} of "
                                 f"{total} blocks kept")
        emit({"phase": "prune", "sparsity": sparsity, "m": PRUNE_MS[0],
              "k": k_pad, "n": n_out, "nnz_blocks": w.nnz_blocks,
              "of_blocks": total, "launches": 1,
              "max_abs_err": float((got - want).abs().max())})

    phase_done("prune")
    # -- 7. serve: mamba2-370m at full width through the wave Engine --------
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, mcfg.vocab, (MAMBA_BATCH, MAMBA_PROMPT))
    mamba_requests = [Request(uid=i, prompt=prompts[i],
                              max_new_tokens=MAMBA_NEW)
                      for i in range(MAMBA_BATCH)]
    warm = [Request(uid=0, prompt=prompts[0, :128], max_new_tokens=2)]
    cache_len = MAMBA_PROMPT + MAMBA_NEW
    prompt_batch = {"tokens": torch.from_numpy(prompts).to(dev)}
    mamba_runs = {"i_bf16_real": mcfg,
                  "j_bf16_sint": mcfg.with_(quant="SINT"),
                  "k_f32_real": mcfg.with_(dtype=torch.float32),
                  "l_f32_sint": mcfg.with_(dtype=torch.float32,
                                           quant="SINT")}

    def serve_plain(cfg, params, backend):
        """Tokens and prefill logits of the same wave through ``backend``."""
        engine = Engine(get_model(cfg, backend=backend), params,
                        batch_slots=MAMBA_BATCH, cache_len=cache_len)
        done = engine.serve(mamba_requests)
        return (np.stack([c.tokens for c in done]),
                engine.last_prefill_logits, done[0])

    for run, cfg in mamba_runs.items():
        card_gen.manual_seed(11)
        t0 = time.perf_counter()
        params = get_model(cfg).init(card_gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        engine = Engine(get_model(cfg), params, batch_slots=MAMBA_BATCH,
                        cache_len=cache_len)
        engine.serve(warm)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        done = engine.serve(mamba_requests)
        counts = read_counts()
        want_counts = expect(ssd_scan=cfg.n_layers, qmatmul=(
            2 * cfg.n_layers * MAMBA_NEW if cfg.quant == "SINT" else 0))
        if counts != want_counts:
            raise AssertionError(f"{run}: launches {counts}, expected "
                                 f"{want_counts}")
        for k in launches:
            launches[k] += counts[k]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        logits = engine.last_prefill_logits.clone()
        tokens = np.stack([c.tokens for c in done])
        if tokens.shape != (MAMBA_BATCH, MAMBA_NEW) \
                or logits.shape != (MAMBA_BATCH, cfg.vocab) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"{run}: tokens {tokens.shape}, logits "
                                 f"{tuple(logits.shape)}")
        plain_tokens, want, plain_done = serve_plain(cfg, params, "ref")
        max_rel = float((logits - want).abs().max() / want.abs().max())
        extra = {}
        if cfg.quant == "SINT":
            # The same path with qmatmul's plain version and every other
            # kernel launched: qmatmul is bit-exact, so this is equality.
            mixed_tokens, mixed, _ = serve_plain(cfg, params,
                                                 {"qmatmul": "ref"})
            if not torch.equal(logits, mixed) \
                    or not np.array_equal(tokens, mixed_tokens):
                raise AssertionError(
                    f"{run}: the kernel path differs from the same path with "
                    f"plain qmatmul (logits off by "
                    f"{float((logits - mixed).abs().max())}, tokens equal "
                    f"{np.array_equal(tokens, mixed_tokens)})")
            extra["equal_to_plain_qmatmul_path"] = True
        if cfg.dtype == torch.float32:
            # Two plain versions (SSD summed chunk by chunk vs step by
            # step): the spread that the plain path itself has.
            _, chunked = get_model(cfg, backend={
                "ssd_scan": "chunked", "qmatmul": "ref"}).prefill(
                    params, prompt_batch, cache_len)
            extra["plain_chunked_vs_plain_rel_l2"] = rel_l2(
                chunked[:, -1], want)
            if cfg.quant is None and (max_rel > F32_LOGIT_TOL or
                                      not np.array_equal(tokens,
                                                         plain_tokens)):
                raise AssertionError(
                    f"{run}: prefill logits off by {max_rel} of the largest "
                    f"or greedy tokens differ from the plain path")
        else:
            _, twin = get_model(cfg.with_(dtype=torch.float32),
                                backend="ref").prefill(
                upcast(params), prompt_batch, cache_len)
            twin = twin[:, -1]
            extra.update(kernel_vs_f32_twin_rel_l2=rel_l2(logits, twin),
                         plain_vs_f32_twin_rel_l2=rel_l2(want, twin))
            if extra["kernel_vs_f32_twin_rel_l2"] > BF16_NOISE_FACTOR \
                    * extra["plain_vs_f32_twin_rel_l2"]:
                raise AssertionError(f"{run}: prefill logits farther from "
                                     f"the f32 twin than the plain path's: "
                                     f"{extra}")
        decode_s = done[0].decode_s
        emit({"phase": "serve", "run": run, "model": cfg.name,
              "dtype": str(cfg.dtype).replace("torch.", ""),
              "quant": cfg.quant or "REAL", "layers": cfg.n_layers,
              "batch": MAMBA_BATCH, "prompt": MAMBA_PROMPT,
              "new_tokens": MAMBA_NEW, "init_s": init_s,
              "prefill_s": done[0].prefill_s,
              "prefill_tok_per_s": MAMBA_BATCH * MAMBA_PROMPT
              / done[0].prefill_s,
              "decode_s": decode_s,
              "decode_tok_per_s": MAMBA_BATCH * (MAMBA_NEW - 1) / decode_s,
              "peak_mem_gb": peak_gb, "launches": counts,
              "logits_max_rel_err": max_rel,
              "logits_rel_l2": rel_l2(logits, want), **extra,
              "token_agreement": float((tokens == plain_tokens).mean()),
              "first_token_agreement": float(
                  (tokens[:, 0] == plain_tokens[:, 0]).mean()),
              "plain_prefill_s": plain_done.prefill_s,
              "plain_decode_s": plain_done.decode_s})
        if run == "i_bf16_real":
            profiled_mamba = (get_model(cfg), params)
        del engine, params
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} was never launched on the main path")

    phase_done("serve_mamba2")
    # -- 8. profile: one prefill of (i), 8 x 1024 tokens, 48 layers ---------
    api, params = profiled_mamba
    api.prefill(params, prompt_batch, cache_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = device_events(lambda: api.prefill(params, prompt_batch,
                                               cache_len))
    wall = time.perf_counter() - t0
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_us = sum(by_name.values())
    ssd_us = [us for name, us in events if "ssd_scan_kernel" in name]
    if events and len(ssd_us) != mcfg.n_layers:
        raise AssertionError(f"profile i: {len(ssd_us)} ssd_scan kernels in "
                             f"one prefill, expected {mcfg.n_layers}")
    # The final SSM state comes out of ssd_scan: no scan (cumsum) or flip
    # of a plain distillation may run beside it.
    state_ops = sorted({name for name in by_name
                        if "ssd_scan_kernel" not in name
                        and any(k in name.lower()
                                for k in ("scan", "cumsum", "flip"))})
    if state_ops:
        raise AssertionError(f"profile i: state kernels outside ssd_scan in "
                             f"the prefill: {state_ops}")
    emit({"phase": "profile", "run": "i_bf16_real", "prefills": 1,
          "kernel": "ssd_scan_kernel", "kernel_launches": len(ssd_us),
          "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e6 / wall,
          "ssd_scan_ms": sum(ssd_us) / 1e3,
          "ssd_scan_share_of_busy": sum(ssd_us) / busy_us if busy_us else None,
          "state_kernels_outside_ssd_scan": state_ops,
          "device_events": len(events),
          "top_device_us": sorted(by_name.items(),
                                  key=lambda kv: -kv[1])[:12]})

    phase_done("profile_mamba2")
    # -- 9. late profile: (a) and (f) as in phase 5, after the Mamba-2 runs,
    # checked the same way (see device_events).
    profile("a_sint_classifier_fused", profiled, readings, "fused_mlp_kernel",
            late=True)
    profile("f_sint_fleet_mega_adaptive", profiled_fleet, grouped_readings,
            "grouped_mlp_kernel", late=True)

    phase_done("late_profile")
    # -- 10. framework: the ICSML core and the IEC 61131-3 export -----------
    def event_ms(fn):
        """``fn()`` between two CUDA events, waited for: (result, ms)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def multipart(run, model, params, x, single, same):
        """MultipartInference at 1, 2, 4, 8 segments against ``single``
        (``same(got, run_name)`` raises on a mismatch), timed per segment."""
        _, apply_ms = event_ms(lambda: model.apply(params, x))
        planned = model.apply_planned(params, x)
        same(planned, f"{run} apply_planned")
        mem = memlib.activation_bytes(model.graph, model.input_shape)
        rows = []
        for n in (1, 2, 4, 8):
            mi = runtime.MultipartInference(model, params, n)
            same(mi.run_all(x), f"{run} {n} segments")
            seg_ms = [[] for _ in range(mi.n_segments)]
            for _ in range(MULTIPART_REPS):
                state = mi.start(x)
                for k in range(mi.n_segments):
                    state, ms = event_ms(lambda: mi.step(state))
                    seg_ms[k].append(ms)
                same(mi.output(state), f"{run} {n} segments, timed")
            rows.append({"requested": n, "segments": mi.n_segments,
                         "bounds": mi.bounds,
                         "segment_flops": mi.segment_flops(),
                         "segment_us": [1e3 * float(np.mean(m))
                                        for m in seg_ms],
                         "total_us": 1e3 * float(np.sum([np.mean(m)
                                                        for m in seg_ms]))})
        emit({"phase": "framework", "run": run, "nvidia_smi": smi,
              "apply_us": 1e3 * apply_ms, "reps": MULTIPART_REPS,
              "planned_arena_bytes": mem["planned"],
              "naive_arena_bytes": mem["naive"],
              "param_bytes": model.param_bytes(), "flops": model.flops(),
              "multipart": rows})

    def profile_inference(run, model, params, x, n_segments):
        """Device events of one multipart inference under torch.profiler
        (see device_events): where a segment's time goes."""
        mi = runtime.MultipartInference(model, params, n_segments)
        mi.run_all(x)
        torch.cuda.synchronize()
        timing = {}

        def one():
            t0 = time.perf_counter()
            mi.run_all(x)
            torch.cuda.synchronize()
            timing["wall"] = time.perf_counter() - t0

        events = device_events(one)
        by_name = {}
        for name, us in events:
            by_name[name] = by_name.get(name, 0.0) + us
        busy_us = sum(by_name.values())
        emit({"phase": "framework", "run": run, "nvidia_smi": smi,
              "segments": mi.n_segments,
              "device_events": len(events), "device_busy_us": busy_us,
              "profiled_wall_us": timing["wall"] * 1e6,
              "device_busy_share": busy_us / 1e6 / timing["wall"],
              "top_device_us": sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:8]})

    # (m) the §7 detector of run (a), multipart.
    det_model, det_params = cls_sint
    x_det = windows[0]
    det_single = det_model.apply(det_params, x_det)

    def det_same(got, what):
        if not torch.equal(got, det_single):
            raise AssertionError(f"{what}: not torch.equal to apply")

    multipart("m_sint_detector_multipart", det_model, det_params, x_det,
              det_single, det_same)
    profile_inference("m_profile", det_model, det_params, x_det, 4)

    # (n) the §6.3 demo model, REAL, with cuDNN's TF32 flag on.
    conv_layers = [L.Input(features=(16, 16, 3))]
    for ch in (8, 16, 32):
        conv_layers += [L.Conv2D(filters=ch, kernel_size=(3, 3),
                                 strides=(2, 2)),
                        L.BatchNorm(activation="relu"),
                        L.DepthwiseConv2D(kernel_size=(3, 3)),
                        L.BatchNorm(activation="relu")]
    conv_model = sequential(conv_layers + [
        L.GlobalAvgPool(), L.Dense(units=10, activation="softmax")],
        (16, 16, 3))
    conv_params = conv_model.init_params(torch.Generator().manual_seed(5),
                                         device=dev)
    conv_rng = np.random.default_rng(5)
    for p in conv_params.values():    # nonzero biases and statistics
        for k, v in p.items():
            noise = 0.1 * conv_rng.standard_normal(tuple(v.shape))
            v += torch.from_numpy(np.abs(noise) if k == "var" else noise
                                  ).to(v)
    x_conv = torch.from_numpy(conv_rng.standard_normal((16, 16, 3)).astype(
        np.float32)).to(dev)
    cpu_params = {u: {k: v.cpu() for k, v in p.items()}
                  for u, p in conv_params.items()}
    conv_cpu = conv_model.apply(cpu_params, x_conv.cpu())
    conv_bit_equal = {}
    torch.backends.cudnn.allow_tf32 = True
    conv_single = conv_model.apply(conv_params, x_conv)

    def conv_same(got, what):
        err = float((got - conv_single).abs().max()
                    / conv_single.abs().max())
        if err > 1e-6:
            raise AssertionError(f"{what}: {err} relative from apply")
        conv_bit_equal[what] = bool(torch.equal(got, conv_single))

    multipart("n_real_mobilenet_ish_multipart_tf32_flag_on", conv_model,
              conv_params, x_conv, conv_single, conv_same)
    profile_inference("n_profile", conv_model, conv_params, x_conv, 4)
    torch.backends.cudnn.allow_tf32 = False
    conv_err = float((conv_single.cpu() - conv_cpu).abs().max()
                     / conv_cpu.abs().max())
    if conv_err > 1e-5:
        raise AssertionError(f"(n): apply on the card is {conv_err} "
                             "relative from the CPU: not IEEE f32")
    emit({"phase": "framework", "run": "n_checks", "nvidia_smi": smi,
          "card_vs_cpu_rel_err": conv_err, "bit_equal_to_apply":
          conv_bit_equal})

    # (o) the scan-cycle runtime: one plant, a trivial control task, (m)'s
    # detector in 4 segments.
    plant = build_fleet(["tb0-spoof"], seed=11)[0]
    plant_raw = np.array([(r.tb0_meas, r.wd_meas) for r in
                          (plant.step() for _ in range(N_CYCLES))],
                         np.float32)
    plant_readings = ((plant_raw - np.asarray(spec.NORM_MEAN, np.float32))
                      / np.asarray(spec.NORM_STD, np.float32))

    def control(reading, state):
        return np.array([0.5 * (1.0 - float(reading[1]))], np.float32), state

    detector = runtime.SlidingWindowDetector(
        det_model, det_params, window=spec.WINDOW,
        n_features=spec.N_FEATURES, n_segments=4)
    results = []
    tick = detector.tick

    def recorded_tick(cycle):
        result = tick(cycle)
        if result is not None:
            results.append(result)
        return result

    detector.tick = recorded_tick
    scan = runtime.ScanCycleRuntime(control, detector, cycle_budget_s=0.1)
    log = scan.run(list(plant_readings))
    n_inferences = (N_CYCLES - spec.WINDOW + 1) // 4
    if len(results) != n_inferences or any(lat != 4
                                           for _, _, lat in results):
        raise AssertionError(f"(o): {len(results)} inferences (expected "
                             f"{n_inferences}), latencies "
                             f"{sorted({lat for _, _, lat in results})}")
    starts = [c - 3 for c, _, _ in results]
    scan_windows = torch.from_numpy(np.stack([
        plant_readings[s + 1 - spec.WINDOW:s + 1].reshape(-1)
        for s in starts])).to(dev)
    single_preds = det_model.apply(det_params, scan_windows).argmax(
        dim=-1).cpu().tolist()
    if [p for _, p, _ in results] != single_preds or log.detections != [
            (c, p) for c, p, _ in results if p != 0]:
        raise AssertionError("(o): predictions differ from single-shot "
                             "apply of the same windows")
    summary = log.summary()
    emit({"phase": "framework", "run": "o_scan_cycle_runtime",
          "nvidia_smi": smi, "cycles": summary["cycles"],
          "segments": 4, "n_inferences": summary["n_inferences"],
          "latency_cycles": sorted(set(log.inference_latency_cycles)),
          "detections": len(log.detections),
          "cycle_time_mean_ms": 1e3 * summary["cycle_time_mean_s"],
          "cycle_time_p99_ms": 1e3 * summary["cycle_time_p99_s"],
          "cycle_time_max_ms": 1e3 * max(log.cycle_times_s),
          "cycle_budget_ms": 1e3 * scan.cycle_budget_s,
          "cycles_over_budget": sum(t > scan.cycle_budget_s
                                    for t in log.cycle_times_s)})

    # (p) the IEC 61131-3 export, held against the card's engine.
    off_cadence = normalized_windows(spec.STRIDE // 2)[:n_streams]

    def calibrated_head(model, params):
        recon = ref.fused_mlp_ref(off_cadence, ops.dense_stack(model, params))
        scores = torch.mean(torch.square(recon - off_cadence), dim=-1)
        return ReconstructionHead().calibrate(scores.cpu().numpy(),
                                              spec.AE_TARGET_FPR)

    ae_real = card_model(build_autoencoder, "REAL", seed=3)
    replay = sorted(int(s) for s in np.random.default_rng(17).choice(
        n_streams, REPLAY_PLANTS, replace=False))
    steps = len(window_starts(N_CYCLES, spec.WINDOW, spec.STRIDE))
    for run, (model, params), head in (
            ("p_sint_classifier_export", cls_sint, ClassifierHead()),
            ("p_sint_autoencoder_export", ae_sint,
             calibrated_head(*ae_sint)),
            ("p_real_autoencoder_export", ae_real,
             calibrated_head(*ae_real))):
        export = export_st(model, params, head=head, name=run.upper(),
                           normalize=(spec.NORM_MEAN, spec.NORM_STD))
        reset_counts()
        res = verify_export(export, model, params, head, readings,
                            spec.STRIDE, streams=replay, device=dev)
        counts = read_counts()
        launches["fused_mlp"] += counts["fused_mlp"]
        sint = export.scheme == "SINT"
        if counts != expect(fused_mlp=steps):
            raise AssertionError(f"{run}: launches {counts}, expected "
                                 f"{steps} fused_mlp")
        if (res["windows"] != REPLAY_PLANTS * steps or res["failures"]
                or (sint and (res["borderline"]
                              or res["max_body_diff"] != 0.0))
                or (sint and head.name == "classifier"
                    and res["max_engine_diff"] != 0.0)):
            raise AssertionError(f"{run}: {res}")
        emit({"phase": "framework", "run": run, "nvidia_smi": smi,
              "scheme": export.scheme, "head": export.head_name,
              "st_lines": len(export.text.splitlines()),
              "plants_served": n_streams, "plants_replayed": REPLAY_PLANTS,
              "steps": steps, "launches": counts, **res})

    phase_done("framework")
    # -- 11. train: the §7 trainers on the card, and what they trained ------
    train_launches, train_err, train_walls = train_phase(
        dev, smi, readings, grouped_readings, replay)
    for k in COUNTED:
        launches[k] += train_launches[k]
    fused_err = max(fused_err, train_err)
    phase_done("train")
    # -- 12. llm: the dense decoder and its MoE twin at full width ----------
    llm_launches = llm_phase(dev, smi)
    for k in COUNTED:
        launches[k] += llm_launches[k]
    phase_done("llm")
    # -- 13. families: Jamba, LLaVA-NeXT and Whisper at full width ----------
    fam_launches = families_phase(dev, smi)
    for k in COUNTED:
        launches[k] += fam_launches[k]
    phase_done("families")
    # -- 14. llm_train: the LLM training stack on the card -----------------
    train_llm_launches = llm_train_phase(dev, smi)
    for k in COUNTED:
        launches[k] += train_llm_launches[k]
    phase_done("llm_train")
    # -- 15. mesh: the fleet served on torch.distributed meshes -------------
    mesh_launches = mesh_phase(
        dev, smi, {"cls_sint": cls_sint, "cls_real": cls_real,
                   "ae_sint": ae_sint, "ae_head": ae_head,
                   "groups": sint_groups}, grouped_readings[:, :N_PLANTS])
    phase_done("mesh")
    # -- 16. train_mesh: the sharded LLM train step ------------------------
    train_mesh_launches = train_mesh_phase(dev, smi)
    for k in COUNTED:
        launches[k] += train_mesh_launches[k]
    phase_done("train_mesh")
    emit({"phase": "seconds", "total": time.perf_counter() - started,
          **seconds, "trainer_wall_s": train_walls})

    # -- summary ------------------------------------------------------------
    def ms(row):
        # The profiler's kernel time; the per-call time where the profiler
        # saw no kernel (the summary says which).
        return row["call_ms"] if row["ms"] is None else row["ms"]

    fused_head = next(r for r in fused_rows if r["stack"] == "detector"
                      and r["scheme"] == "SINT" and r["m"] == 1024)
    q_main = [r for r in q_rows if r["m"] == 1024 and "layer" not in r]
    q_llm = [r for r in q_rows if "layer" in r]
    g_head = next(r for r in g_rows if r["scheme"] == "SINT"
                  and r["m_per_group"] == 1024)
    s_head = next(r for r in s_rows if r["m"] == PRUNE_MS[0]
                  and r["sparsity"] == 0.5 and r["block"] == [128, 128])
    ssd_head = next(r for r in ssd_rows if r["shape"] == "prefill")
    ssd_jamba = next(r for r in ssd_rows if r["shape"] == "jamba_prefill")
    source = ("torch.profiler" if fused_head["ms"] is not None
              and all(r["ms"] is not None for r in q_main) else "call_ms")
    kernels = [
        {"name": "fused_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_mlp.cu",
         "replaces": "src/repro/kernels/fused_mlp.py:234",
         "launches": launches["fused_mlp"],
         "mesh_launches": mesh_launches["fused_mlp"],
         "train_launches": train_launches["fused_mlp"],
         "max_abs_err": fused_err, "ms": ms(fused_head), "ms_source": source,
         "call_ms": fused_head["call_ms"], "plain_ms": fused_head["plain_ms"],
         "bound_ms": fused_head["bound_ms"],
         "bound_us": fused_head["bound_us"],
         "bound_by": fused_head["bound_by"], "library_ms": None,
         "path": fused_head["path"], "design": FUSED_DESIGN,
         "shape": "detector SINT, M=1024 (400-64-32-16-2)",
         "timed": [r for r in fused_rows if r["m"] == 1024]},
        {"name": "qmatmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qmatmul.cu",
         "replaces": "src/repro/kernels/qmatmul.py:69",
         "launches": launches["qmatmul"],
         "mesh_launches": mesh_launches["qmatmul"], "max_abs_err": q_err,
         "ms": sum(ms(r) for r in q_main), "ms_source": source,
         "call_ms": sum(r["call_ms"] for r in q_main),
         "plain_ms": sum(r["plain_ms"] for r in q_main),
         "bound_ms": sum(r["bound_ms"] for r in q_main),
         "bound_us": sum(r["bound_us"] for r in q_main),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                    for r in q_main) else "operations",
         "library_ms": None,
         "shape": "the four detector SINT layers at M=1024, summed "
                  "(one per-layer step)",
         "llm_launches": llm_launches["qmatmul"],
         "families_launches": fam_launches["qmatmul"],
         "timed": q_main, "timed_llm_sint": q_llm},
        {"name": "grouped_fused_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_mlp.cu",
         "replaces": "src/repro/kernels/fused_mlp.py:473",
         "launches": launches["grouped_mlp"],
         "mesh_launches": mesh_launches["grouped_mlp"],
         "train_launches": train_launches["grouped_mlp"],
         "max_abs_err": g_err,
         "ms": ms(g_head),
         "ms_source": ("torch.profiler" if g_head["ms"] is not None
                       else "call_ms"),
         "call_ms": g_head["call_ms"], "plain_ms": g_head["plain_ms"],
         "bound_ms": g_head["bound_ms"], "bound_us": g_head["bound_us"],
         "bound_by": g_head["bound_by"], "library_ms": None,
         "path": g_head["path"], "design": GROUPED_DESIGN,
         "shape": "four-head §7 fleet SINT (400-64-32-16-2, 400-64-16-64-400, "
                  "400-64-32-16, 398-64-32-2), M=1024 per group",
         "timed": [r for r in g_rows if r["m_per_group"] == 1024]},
        {"name": "sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_matmul.cu",
         "replaces": "src/repro/kernels/sparse_matmul.py:85",
         "launches": launches["sparse_matmul"],
         "mesh_launches": mesh_launches["sparse_matmul"],
         "max_abs_err": s_err,
         "ms": ms(s_head),
         "ms_source": ("torch.profiler" if s_head["ms"] is not None
                       else "call_ms"),
         "call_ms": s_head["call_ms"], "plain_ms": s_head["plain_ms"],
         "bound_ms": s_head["bound_ms"], "bound_us": s_head["bound_us"],
         "bound_by": s_head["bound_by"], "library_ms": s_head["library_ms"],
         "library_device_ms": s_head["library_device_ms"],
         "shape": f"§6.2 layer {k_pad}x{n_out} ({n_in} inputs padded), "
                  "M=8, half of its (128, 128) blocks pruned",
         "timed": s_rows},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:85",
         "launches": launches["ssd_scan"],
         "mesh_launches": mesh_launches["ssd_scan"],
         "llm_launches": llm_launches["ssd_scan"],
         "families_launches": fam_launches["ssd_scan"],
         "llm_train_launches": train_llm_launches["ssd_scan"],
         "max_abs_err": ssd_err,
         "ms": ms(ssd_head),
         "ms_source": ("torch.profiler" if ssd_head["ms"] is not None
                       else "call_ms"),
         "call_ms": ssd_head["call_ms"], "plain_ms": ssd_head["plain_ms"],
         "bound_ms": ssd_head["bound_ms"], "bound_us": ssd_head["bound_us"],
         "bound_by": ssd_head["bound_by"],
         "cuda_core_bound_ms": ssd_head["cuda_core_bound_ms"],
         "bf16_views_ms": ssd_head["bf16_views_ms"],
         "bf16_views_bound_ms": ssd_head["bf16_views_bound_ms"],
         "library_ms": None,
         "shape": f"{MAMBA_ARCH} prefill, B={ssd_head['b']} "
                  f"T={ssd_head['t']} H={ssd_head['h']} P={ssd_head['p']} "
                  f"N={ssd_head['n']} G={ssd_head['g']}",
         "jamba": {k: ssd_jamba[k] for k in (
             "b", "t", "h", "p", "n", "g", "ms", "call_ms", "plain_ms",
             "bound_ms", "bound_by", "bf16_views_ms", "bf16_views_bound_ms",
             "max_abs_err", "state_max_abs_err")},
         "timed": [r for r in ssd_rows if "ms" in r]},
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Main paths: continuous paged serving of stablelm-1.6b (GQA; kernels
K1-K6) and of deepseek-v3's dense prefix (its first 3 layers, MLA with a
dense MLP, at the published width, the MoE layers dropped; registered at
run time as ``deepseek-v3-dense3``; kernels K8-K10, and K3/K4 in dynamic
w8a8), the static ``serve()`` of stablelm-1.6b over a contiguous cache,
lock-step or ragged, greedy or sampled (kernel K7; K2/K3 with
--prequantize, K3/K4 in dynamic w8a8), the dense family: continuous
serving of stablelm-12b, starcoder2-15b and gemma3-27b at their published
widths (K1-K6 at G = 4, 12 and 2, dh = 160 and 128, gemma3's 1,024-key
window), and the Mixture-of-Experts configs: continuous serving of
qwen2-moe-a2.7b at its published width and depth (K1-K6 at Hkv = 16,
dh = 128) and of deepseek-v3 cut to 5 layers, 3 dense and 2 MoE
(``deepseek-v3-moe5``; K8-K10, K3/K4), and qwen2-moe's static
``serve()`` (K7). Their experts run as float products in every mode, on
every token. The recurrent configs: continuous serving of mamba2-780m (a
pure SSM: K2-K4 only) and zamba2-1.2b (Mamba2 layers and six sites of one
shared attention block: K1 and K6 at its sites, K3/K4) at their published
widths and depths, and their static ``serve()`` (zamba2's sites on K7);
their SSD scans, convs and gated norms are plain torch ops, as the
reference's are plain jnp. The non-token frontends: the static
``serve()`` of qwen2-vl-72b (patch embeddings in, M-RoPE; 12 of its 80
layers, ``qwen2-vl-72b-L12``, in every mode, and 40, ``qwen2-vl-72b-L40``,
with --prequantize) and of musicgen-large (four codebooks) at their published
widths (K7 at G = 8, dh = 128; K2-K4 up to K = 29568 and N = 152064).
The paper-fidelity modes: continuous serving of stablelm-1.6b at its
published width in ``qat`` (K3 for every activation and weight, a float
matmul) and ``analog_sim`` (w8a8's K2-K4 products, then the analog noise
and TDC epilogue in plain torch), the analog VMM at the paper's size and
the straight-through backward passes. Training: stablelm-1.6b trained at
its published width and depth through ``make_train_step`` in bf16, qat
(K3 on every activation and weight transpose) and w8a8 (K3 and K4 on
every linear), at M = 8 x 256 rows, and the trainer's checkpoint and
resume on the card. Tensor-parallel serving: stablelm-1.6b and the dense
prefix served on 2 and 4 rank processes, each holding its heads of the
attention projections and its part of the GQA pools (K1, K2, K3, K6 and
K8 on a rank's heads). Sharded training: stablelm-1.6b at its published
width on a 2 x 2 rank mesh under the 'tp' and 'fsdp2d' layouts (K3, K4
and K2 on a rank's blocks in w8a8).

Phases, in order; any failure exits non-zero and prints no result:

1. build   — print the card's name and power limit, compile every CUDA
             kernel from ``src/repro_torch/csrc`` (one nvcc per source, all
             at once) and print the redesigned kernels' registers, shared
             memory and spills (a ``{"ptxas": [...]}`` line).
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the serving paths' full-width shapes (K3/K4 at the linear
             shapes of both models, K2 at stablelm's, each at M = 8 and
             128 and, for stablelm's layer linears, at the static
             prefill's M = 8 * 128 = 1024; int outputs and int8
             codes bit-exact; GQA attention 1e-5 on f32 and on bf16 pools,
             since kernel and plain version both compute in f32 on the same
             pools, with a sliding window on half the slots; K5 and K9 on
             the rows below their limit, every row finite, K5 (the key
             split with a chunk's rows) also at a 4,096-token context
             (W=512); K3 bit-exact also at an unaligned K and base
             pointer, and timed beside a kernel that does nothing (the
             launch floor); K6 also
             bit-equal to K1, and K10 to K8, when the hot window covers the
             table, over poisoned int8 pools; K1 and K6 (the key split over
             block tables, two device kernels a launch) also at Hkv=8, G=4,
             dh=128, at the dense family's layouts (Hkv=8, G=4, dh=160;
             Hkv=4, G=12, dh=128; Hkv=16, G=2, dh=128) and at a
             4,096-token context (W=512), each with an L2-cold reading;
             K1 and K5 at gemma3's local layers (a 1,024-key window at a
             1,160-token context; K5's 128-token chunk at offset 1,024);
             K2/K3/K4 also at the dense family's linear shapes and the
             MoE configs' (qwen2-moe's lm_head, deepseek-v3's shared
             FFN) and the recurrent configs' (mamba2's in_proj N = 6448,
             out_proj and tied head N = 50280; zamba2's in_proj N = 8384,
             out_proj, shared MLP out K = 8192) and the frontends'
             (qwen2-vl-72b's q/o, k/v, MLP in, MLP down K = 29568 and
             lm_head N = 152064; musicgen's MLP in and out); K1/K6 (hot
             window 2), K5 (C = 8 and 32) and K7 (S = 160) at
             qwen2-moe's Hkv = 16, G = 1, dh = 128; K7 (S = 160) at
             qwen2-vl's Hkv = 8, G = 8, dh = 128 (musicgen's heads are
             stablelm's, whose row is above); MLA
             attention 2e-5, the
             reference's tolerance, at H=128, DK=576, r=512, with the
             kernels' resident blocks per SM; K8, K9 and K10 (the latent
             key split, K9 with a chunk's rows, two device kernels a
             launch) also at a 4,096-token context (W=512), bf16 and f32
             pools, K8 and K10 each with an L2-cold reading, K9 beside
             K8's time a query row and visible key) and time kernel, plain
             version and, where one exists, the one PyTorch call computing
             the same function (device time of each call's kernels, from
             torch.profiler; CUDA events where the profiler records no
             device kernel, named in each row's ``timer``). K2 runs on
             prequantize_weight's K-major weights, refuses a row-major
             one, and is timed beside torch._int_mm on the same operands;
             K4 runs on views of K3's codes of the K-major float weight's
             transpose, as dynamic w8a8 serves it, and refuses row-major
             codes, ops.yoco_vmm a row-major float weight; the whole
             dynamic linear (ops.yoco_vmm) is bit-equal to yoco_vmm_ref.
             K7 at stablelm's static shape (B=8, Hkv=32, dh=64, S=160;
             lock-step and ragged, a window on half the slots), at G=4,
             dh=128 and dh=160, S=200, f32 and bf16 caches (dh=160 in f32:
             two 16-byte pieces a lane), and lock-step at S=4096,
             1e-5, every row finite, its streamed path bit-equal to the
             prefetch path, beside scaled_dot_product_attention on the
             same cache, each warm and with L2 flushed between calls
             (three cold readings each, in turns, at lock-step).
             Last, NaN inputs (nan_kernel_phase): a NaN page alone in its
             key split and among finite keys through K1, K5, K6, K8, K9
             and K10 on bf16 and f32 pools, and K3 on a crafted NaN row;
             the kernels leave non-finite exactly the plain versions'
             non-finite rows (a ``{"nan": [...]}`` line).
3. smoke   — the port's GPU path against its own CPU plain path on each
             smoke config in f32 (the dense family's three, qwen2-moe,
             deepseek-v3 with its MoE layers, mamba2 and zamba2 too, and
             zamba2 over the int8 tier): prefill
             plus decode in every served mode (stablelm and the dense
             prefix also in qat and analog_sim, stablelm's analog_sim
             with --prequantize too),
             decode over the int8 tier (hot window 1), and a prefix hit
             served by chunked prefill, and the static serve() with
             --attn-impl flash, lock-step and --ragged, in bf16 and w8a8
             --prequantize mode; every forward's logits within 1e-4 and
             equal greedy tokens. The card runs first; the CPU
             run takes the card's int8 codes (K3, the tier's page
             quantize) where its own differ by rounding-boundary flips
             only, and fails on any other difference (see SMOKE_TOL);
             in analog_sim it also takes the card's noise draws (a CPU
             generator draws another stream) and, likewise, its TDC
             codes.
4. profile — the device busy share and device kernels of a short
             full-width serve under torch.profiler: stablelm in bf16, w8a8
             --prequantize and dynamic w8a8, the dense prefix in bf16 and
             dynamic w8a8 (None where the profiler records no device
             kernel), with the attention kernels' device time and calls.
5. serve   — continuous paged serving at the published width (random
             weights from a seed). stablelm-1.6b in bf16, w8a8
             --prequantize and dynamic w8a8, plus one bf16 run whose pool
             forces preemption; then bf16 and w8a8 --prequantize with the
             int8 KV tier (--kv-quant --hot-window 2), and a stream of
             128-token prompts sharing a 96-token prefix served privately,
             with --prefix-cache --chunk-prefill 32, and with
             --prefix-cache --kv-quant --hot-window 2. The dense prefix in
             bf16, dynamic w8a8, bf16 with the int8 latent tier, and the
             same three shared-prefix runs. Every request must finish, no
             lane may produce a non-finite logits row, and each kernel's
             launch counter must equal the path's (K1 24 times per decode
             step, K6 in its place with the tier; K5 24 times per prefill
             chunk; with --prequantize K2 169 times per forward and K3 97,
             one quantization per distinct activation (q/k/v and gate/up
             share theirs); in dynamic w8a8 K4 169 and K3 97 + 169 = 266;
             K8 3 times per decode step, K10 in its place with the tier,
             K9 3 times per prefill chunk, and in dynamic w8a8 K4 22 per
             decode step or chunk, 25 per monolithic prefill, K3 16 + 22
             and 19 + 25 (w_dq and w_dkv, gate and up share)); the tier
             must quantize pages, and the prefix cache must hit on at least
             15 of 16 admissions with fewer peak pages than the private
             run. Then the static serve() at the published width (batch 8,
             prompt 128, generation 32): stablelm bf16 flash lock-step,
             bf16 flash --ragged, bf16 einsum --ragged, w8a8 --prequantize
             flash --ragged, one sampled run (temperature 0.8, top-k 40),
             one temperature-0 run whose tokens must equal the greedy flash
             run's, the dense prefix in bf16 einsum lock-step (the
             contiguous latent cache), and stablelm in dynamic w8a8 flash
             --ragged; every logits row finite, shape [8, 32], K7 launched
             24 * 31 = 744 times per flash run and never by einsum, no
             paged kernel, K2 169 and K3 97 times per forward with
             --prequantize, K4 169 and K3 266 in dynamic w8a8; and the
             device busy share of the bf16 flash lock-step run and of the
             dynamic w8a8 flash --ragged run.
5b. dense — stablelm-12b, starcoder2-15b and gemma3-27b at their
             published widths (dense_phase): 8 requests of 128-token
             prompts, 16 generated, in bf16, w8a8 --prequantize and
             dynamic w8a8 (gemma3-27b's refused: its f32 masters exceed
             the card), gemma3-27b also 2 prompts of 1,152 tokens with
             --chunk-prefill 128 --kv-quant; every request finishes, no
             non-finite logits row, exact launches (K1 once a layer a
             decode step, K6 with the tier, K5 once a layer a chunk,
             K2/K3/K4 per forward); one decode step a config under
             torch.cuda.set_sync_debug_mode('error'), its flash and
             einsum logits equal within 1e-4 in f32 (bf16 reported).
5c. moe   — qwen2-moe-a2.7b at its published width and deepseek-v3-moe5
             (moe_phase): 8 requests of 128-token prompts, 16 generated,
             qwen2-moe in bf16, w8a8 --prequantize and dynamic w8a8 and a
             shared-prefix stream with --prefix-cache --kv-quant,
             deepseek-v3-moe5 in bf16, the same shared stream, and
             dynamic w8a8 (refused and checked where its weights would
             not fit); every request finishes, no non-finite logits row,
             exact launches (the router and the experts launch no int8
             kernel), each serve's device busy share under
             torch.profiler and its peak memory; one decode step a
             config under set_sync_debug_mode('error'), flash vs einsum
             in f32 within 1e-4; each model freed before the next loads.
             The static phase then serves qwen2-moe in bf16 flash
             lock-step (K7 24 * 31 times, no other kernel).
5d. ssm   — mamba2-780m and zamba2-1.2b at their published widths and
             depths (ssm_phase): 8 requests of 128-token prompts, 16
             generated, mamba2 in bf16, bf16 over a pool that forces
             preemption (its tokens equal to the bf16 run's), w8a8
             --prequantize and dynamic w8a8, then 2 prompts of 1,024
             tokens (four SSD chunks) and layer 0's SSD at full width
             against the sequential recurrence (2e-4, the reference's);
             zamba2 in bf16, the preempting pool, --kv-quant --hot-window
             2 and dynamic w8a8 (--prequantize refused); the static
             serve() (batch 8, prompt 128, generation 32): zamba2 flash
             lock-step (K7 6 * 31) and einsum --ragged, mamba2 einsum
             --ragged (flash refused); exact launches (K1 6 a zamba2
             decode step, K6 with the tier; mamba2 --prequantize K2 96,
             K3 98, K4 1 a forward, dynamic K4 97, K3 194; zamba2 dynamic
             K4 101, K3 190), each run's device busy share, peak memory
             and recurrent state bytes; one decode step a config under
             set_sync_debug_mode('error'), and its SSM ops' device time
             beside the state-traffic bound.
5e. frontends — qwen2-vl-72b and musicgen-large through the static
             serve() (frontends_phase): their smoke configs card against
             CPU in f32 (lock-step and --ragged, flash, bf16, w8a8
             --prequantize, dynamic w8a8; every forward's logits within
             1e-4, equal tokens); qwen2-vl-72b-L12 (12 of 80 layers) and
             musicgen-large (48 layers) at their published widths, batch
             8, prompt 128, generation 32, in bf16 (flash lock-step,
             einsum --ragged, sampled flash --ragged), w8a8 --prequantize
             (flash --ragged) and dynamic w8a8 (flash lock-step): every
             logits row finite, shape [8, 32] ([8, 32, 4] for musicgen),
             exact launches (K7 once a layer a decode step; per forward
             K2 85 and K3 49 with --prequantize, K4 85 and K3 134 dynamic
             on qwen2-vl-72b-L12; 288 and 192 / 288 and 480 on musicgen,
             whose four heads are a float einsum), peak memory beside the
             weights' read bound; 4 greedy decode steps in f32 through
             flash and einsum with equal tokens; then qwen2-vl-72b's 80
             layers refused in bf16 and dynamic w8a8 before any draw, and
             40 of them (qwen2-vl-72b-L40) served with --prequantize
             (flash): finite logits, exact launches, peak memory beside
             the card's total, decode_step_ms beside the weights' read
             bound.
5f. fidelity — the paper-fidelity modes on stablelm-1.6b at its
             published width (fidelity_phase): 8 requests of 128-token
             prompts, 16 generated, in dynamic w8a8, qat, analog_sim
             (twice at noise seed 0, once at seed 1), w8a8 --prequantize
             and analog_sim --prequantize; every request finishes, no
             non-finite logits, exact K1-K4 launches (analog_sim as w8a8;
             qat K3 97 + 169 a forward and no K2 or K4), equal tokens at
             one seed and different logits at another, the share of
             tokens equal to w8a8's, the device busy share of the qat and
             analog_sim serves; layer 0's seven linears in analog_sim
             within (0, 3%) of full scale from w8a8; the analog VMM at the
             paper's 1024 x 256 (64 rows) over 256 Monte-Carlo chips, its
             worst code error within 0.79% + 0.4% of full scale, ideal
             circuits within one code, card vs CPU on the same draws equal
             up to boundary flips; a qat and a w8a8 linear's STE backward
             at K = N = 2048, card vs CPU within 1e-5.
5g. train  — training (train_phase): one make_train_step step at smoke
             size on the card against the CPU from the same seed-0 params
             and batch (stablelm in bf16, qat, w8a8 and analog_sim, the
             last on the card's replayed draws, with grad_accum 1 and 2;
             qwen2-moe and mamba2 in bf16), to the CPU tests' bounds (loss
             1e-3 and grad norm 5e-3 relative, at most 3% of params off by
             more than 1e-6, each by at most 2.2 lr); the trainer at smoke
             size, 10 steps, against the CLI killed at step 6
             (``--simulate-failure-at 6``, exit 17, after its step-6
             checkpoint) and resumed by train() to step 10: the losses at
             steps 6-9 equal bit for bit (else again under
             torch.use_deterministic_algorithms, reported); stablelm-1.6b
             at its published width and depth, 8 AdamW steps of global
             batch 8 x 256 tokens in bf16, qat and w8a8: finite losses,
             the last below the first, K3 266 and K4 169 (w8a8) or 0
             (qat) launches a step exactly, none in bf16, every linear
             master and its moments K-major after the last step; the step
             time, tokens/s, peak memory, busy share of a profiled step
             and 6 N tokens a step over the card's dense bf16 peak; K3 on
             the bf16 activations (K = 2048, 5632) and weight transposes,
             K4 at M = 2048 through the four linear shapes, bit-exact and
             timed beside torch._int_mm.
6. chaos   — continuous serving under the fault injector at the published
             width, each serve beside a clean run of the same stream and
             weights (chaos_phase): stablelm bf16 with the int8 tier and
             the prefix cache, stablelm w8a8 --prequantize (kernels K1,
             K2, K3, K5, K6 under poisoned pages and logits rows, dropped
             quantize chunks, pool squeezes, preemption storms,
             cancellations, mangled prompts), the dense prefix in dynamic
             w8a8 (K3, K4, K8 under poisoned pages and logits rows),
             zamba2 in bf16 (K1 at its six sites; a quarantined lane's
             recurrent rows zeroed before reuse). Every
             lane that read a poisoned row quarantined, every request the
             injector did not touch with the clean run's tokens, the
             metrics equal to the event log, the trace a Chrome trace, no
             telemetry hook synchronising the device; then the host ms a
             step with metrics on and off (not gated).
7. tp      — tensor-parallel continuous serving on rank processes
             (tp_phase): stablelm-1.6b at its published width and depth at
             tp = 2 in bf16 and in w8a8 --prequantize over the int8 tier
             (K2, K3, K6 on each rank's heads) and at tp = 4 in bf16 (K1),
             deepseek-v3's dense prefix at tp = 2 in bf16 (K8 on 64 of its
             128 heads), 8 requests of 64-128-token prompts, 16 generated;
             the ranks share cuda:0 over gloo (nccl with a card a rank).
             Before the serves, a rank's products against tp = 1's, bit
             for bit: the bf16 q/k/v columns, K1, K8 and K7 (at the
             mesh-sharded serve's decode step) on a rank's heads planned
             for all heads (``ways``), MLA's W_uv product at the whole
             head count; and the device ms of K1, K8, K7 and W_uv at tp =
             1 and on a rank at tp = 2 (K1, K8 and K7 also planned for the
             rank's heads alone). Each distinct run is served once at tp =
             1. Tokens equal tp = 1's, every rank's launches equal tp =
             1's kernel by kernel, one head all-gather a layer a forward
             and no other collective, finite logits; wall time, tokens/s
             and the KV pool bytes a rank printed (no TP speed: the ranks
             share one card).
8. sharded — sharded training on a 2 x 2 rank mesh (sharded_phase):
             four rank processes on cuda:0 over gloo (a card a rank over
             nccl on four cards). At smoke size, the card against a CPU
             group on the same seed-0 inputs: the reference's 8
             distributed parity rows (stablelm, deepseek-v3 and qwen2-moe
             expert-parallel, mamba2; 'tp' and 'fsdp2d'), losses within
             1e-3, and moe_ep with capacity drops, 1e-4 and the same drop
             fraction. At stablelm-1.6b's published width (SHARDED_LAYERS
             deep), global batch 8 x 256, 2 AdamW steps in bf16 under
             'tp' (remat none and full) and 'fsdp2d', and in w8a8 under
             'tp' (K3 and K4 on the column blocks, K3 and K2 on the row
             blocks with the whole rows' scales and an int32 sum): held to
             the one-device make_train_step (loss 1e-3, grad norm 5e-3, 3%
             of params off by > 1e-6, each at most 2.2 lr), each rank's
             master and moment bytes its blocks', the collectives and
             kernel launches a step as sharded_counts derives them, remat
             full peaking at most at none; step ms, tokens/s, peak memory
             and bytes moved a step printed (no sharded speed: the ranks
             share one card). Before the ranks start, the dry run of those
             steps and of the serves below on the meta device
             (launch/dryrun.py): its collectives and blocks equal each
             rank's, its train-step peak within SHARDED_PEAK_TOL of the
             card's. Then a static serve on the same ranks through
             sharded_prefill_step / sharded_decode_step (8 x 128 prompt, 8
             greedy steps, flash), w8a8 --prequantize (K2, K3, K7 on a
             rank's blocks) and bf16 (K7): tokens equal one device's (a
             differing token only below its top-2 gap), logits within
             SHARDED_SERVE_TOL, collectives and launches a step as
             serve_counts derives them; each step's roofline bound beside
             its time. K2 and K7 rows at a rank's decode-step shapes
             against their plain versions.

Prints a ``{"kernels": [...]}`` line (one row per kernel and main path it
runs on, with that path's launches; K9 on both pool dtypes), a
``{"redesigned": [...]}`` line (every row of the redesigned kernels, all
ten), a ``{"nan": [...]}``, a ``{"serve": [...]}``, a ``{"dense":
[...]}``, a ``{"moe": [...]}``, a ``{"static_serve": [...]}``, a
``{"chaos": [...]}``, a ``{"ssm": [...]}``, a ``{"frontends": [...]}``,
a ``{"fidelity": [...]}``, a ``{"train": [...]}``, a ``{"tp":
[...]}`` and a ``{"sharded": [...]}`` line, the whole script's seconds
beside the card (``{"script_s": ..., "smi": ...}``), the
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. Details (the full shape sweep, compiler
reports) go to ``build/chip_smoke.json``.

Usage: python3 chip_smoke.py (every phase runs, always).
       python3 chip_smoke.py --phase
       kernels|profile|static|nan|chaos|dense|moe|ssm|frontends|fidelity|
       train|tp|sharded:
       the build and that phase alone (its report in
       ``build/chip_smoke_<phase>.json``, no result line), to rehearse a
       kernel or to measure another tree with this script copied into its
       root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

T_START = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, 'src')
OUT_DIR = os.path.join(HERE, 'build')



# repro_torch.core.roofline: the card's datasheet peaks (one set for the
# whole repo) and a kernel's bound; main() imports it once src/ is on
# sys.path
roofline = None


ARCH = 'stablelm-1.6b'
LAYERS_FULL = 24
LINEARS_PER_FORWARD = 7 * LAYERS_FULL + 1      # q k v o gate up down + lm_head
# distinct activations those linears read (K3 launches in w8a8): q/k/v
# share x, gate/up share the normed x, then o's and down's inputs, and the
# lm_head's
ACTIVATIONS_PER_FORWARD = 4 * LAYERS_FULL + 1
# deepseek-v3's dense prefix: its first 3 layers (MLA + a dense SwiGLU MLP
# of d_ff 18432) at the published width, the 58 MoE layers dropped;
# registered at run time by register_dense_prefix()
MLA_ARCH = 'deepseek-v3-dense3'
MLA_LAYERS = 3
# linears a forward runs per MLA layer (mla_counts): w_dq w_uq w_dkv wo +
# gate up down; a monolithic prefill also expands k/v through w_ukv
# (decode and chunks absorb it into f32 einsums instead); plus one lm_head
# per forward. Their distinct activations: w_dq and w_dkv share x, gate
# and up share the normed x; w_uq's, wo's and down's inputs (and w_ukv's
# in a monolithic prefill); the lm_head's
# the Mixture-of-Experts configs (phase "moe"): qwen2-moe-a2.7b at its
# published width and depth, and deepseek-v3 cut to its first 5 layers (3
# dense MLA layers, then 2 MoE layers), registered at run time by
# register_moe5(); their MoE layers run the same linears over the same
# activations as a dense layer (the shared FFN in the MLP's place), so
# gqa_counts and the MLA counts hold
MOE_ARCH = 'qwen2-moe-a2.7b'
MOE5_ARCH = 'deepseek-v3-moe5'
MOE5_LAYERS = 5
# the static serve() runs at full width: batch 8, prompt 128, generation 32
STATIC_BATCH, STATIC_PROMPT, STATIC_GEN = 8, 128, 32
# (K, N) of every linear each main path runs through K3/K4 (and K2):
# stablelm q/k/v/o, MLP in and out, lm_head; the dense prefix's w_dq,
# w_uq, w_dkv, wo, MLP in and out, lm_head, and the prefill's w_ukv
LINEAR_SHAPES = (
    (ARCH, ((2048, 2048), (2048, 5632), (5632, 2048), (2048, 100352)), True),
    (MLA_ARCH, ((7168, 1536), (1536, 24576), (7168, 576), (16384, 7168),
                (7168, 18432), (18432, 7168), (7168, 129280), (512, 32768)),
     False),
    # the dense family (phase "dense"): q/o (gemma3: q, then o), k/v, MLP
    # in (gate and up each), MLP out, lm_head
    ('stablelm-12b', ((5120, 5120), (5120, 1280), (5120, 13824),
                      (13824, 5120), (5120, 100352)), True),
    ('starcoder2-15b', ((6144, 6144), (6144, 512), (6144, 24576),
                        (24576, 6144), (6144, 49152)), True),
    ('gemma3-27b', ((5376, 4096), (5376, 2048), (4096, 5376),
                    (5376, 21504), (21504, 5376), (5376, 262144)), True),
    # the MoE configs (phase "moe"): qwen2-moe's lm_head (its q/k/v/o and
    # shared FFN have stablelm-1.6b's shapes); deepseek-v3's shared FFN
    # (gate and up each, then down), dynamic w8a8 only
    (MOE_ARCH, ((2048, 151936),), True),
    (MOE5_ARCH, ((7168, 2048), (2048, 7168)), False),
    # the recurrent configs (phase "ssm"): mamba2's in_proj (N = 6448),
    # out_proj and tied head (N = 50280, no multiple of 16: the K2/K4 edge
    # masks), --prequantize and dynamic; zamba2's Mamba2 in_proj
    # (N = 8384) and out_proj, and its shared block's MLP out (K = 8192),
    # dynamic only (the port refuses --prequantize there); its q/k/v/o
    # have stablelm-1.6b's (2048, 2048)
    ('mamba2-780m', ((1536, 6448), (3072, 1536), (1536, 50280)), True),
    ('zamba2-1.2b', ((2048, 8384), (4096, 2048), (8192, 2048)), False),
    # the non-token frontends (phase "frontends"): qwen2-vl-72b's q/o, k/v,
    # MLP in (gate and up each), MLP down (K = 29568, the longest
    # contraction) and lm_head (N = 152064); musicgen-large's GELU MLP in
    # and out (its q/k/v/o have stablelm-1.6b's (2048, 2048); its four
    # heads are a float einsum, no linear)
    ('qwen2-vl-72b', ((8192, 8192), (8192, 1024), (8192, 29568),
                      (29568, 8192), (8192, 152064)), True),
    ('musicgen-large', ((2048, 8192), (8192, 2048)), True),
)
# stablelm's layer linears (q/k/v/o, MLP in and out) also run at the static
# prefill's M = batch * prompt rows; its lm_head reads only the last
# positions there (M = batch)
STATIC_PREFILL_LINEARS = ((2048, 2048), (2048, 5632), (5632, 2048))
STATIC_PREFILL_ROWS = STATIC_BATCH * STATIC_PROMPT


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def register_dense_prefix():
    """Register deepseek-v3's dense prefix, ``replace(FULL, n_layers=3,
    moe=None)`` (and the smoke config cut the same way), as MLA_ARCH;
    returns the full config."""
    import dataclasses

    from repro_torch import configs
    full = configs.get('deepseek-v3-671b')
    smoke = configs.get('deepseek-v3-671b', smoke=True)
    configs.base.register(
        dataclasses.replace(full, name=MLA_ARCH, n_layers=MLA_LAYERS,
                            moe=None),
        dataclasses.replace(smoke, name=MLA_ARCH, moe=None))
    return configs.get(MLA_ARCH)


def register_moe5():
    """Register deepseek-v3 cut to its first 5 layers, ``replace(FULL,
    n_layers=5)`` (3 dense layers and 2 MoE layers; the smoke config is the
    reference's SMOKE, 1 dense layer and 2 MoE layers), as MOE5_ARCH;
    returns the full config."""
    import dataclasses

    from repro_torch import configs
    full = configs.get('deepseek-v3-671b')
    configs.base.register(
        dataclasses.replace(full, name=MOE5_ARCH, n_layers=MOE5_LAYERS),
        dataclasses.replace(configs.get('deepseek-v3-671b', smoke=True),
                            name=MOE5_ARCH))
    return configs.get(MOE5_ARCH)


def smi_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# spin kernels (``torch.cuda._sleep``) launched on each side of a profiled
# window: a session of torch.profiler was seen to drop kernels at its edge,
# more of them the more sessions the process had opened (up to half of 20
# single-kernel calls), so the window's edges hold kernels nothing else
# launches and that are left out of every sum
PAD_KERNELS = 128


def profiled_kernels(torch, fn, attempts=2):
    """``{kernel name: [device ms, calls]}`` of every device kernel ``fn()``
    launches, from ``torch.profiler``; empty when the profiler recorded no
    device kernel in any of ``attempts`` sessions (its device tracing does
    not always start). The session's raw kineto events are read, not
    ``prof.events()``: the same device durations, without building the
    event tree, which took seconds a session for a plain version of a
    few hundred kernels a call."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(1)

    by_name = defaultdict(lambda: [0.0, 0])
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad()
            fn()
            pad()
            torch.cuda.synchronize()
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA \
                    and 'spin_kernel' not in name:
                by_name[name][0] += ev.duration_ns() / 1e6
                by_name[name][1] += 1
        if by_name:
            break
    return dict(by_name)


# profiler sessions one reading may open before it falls back to CUDA
# events: on the H100 a session now and then records no device kernel, or
# drops a few, at any row; the misses are counted here and reported
PROFILE_SESSIONS = 6
PROFILER_MISSES = dict(empty=0, short=0, fallbacks=0)


def device_ms(torch, fn, iters=20, warmup=3, expect=None):
    """``(ms, timer, kernels)`` of one call. With ``timer == 'profiler'``,
    the summed duration of every kernel the call launches over ``iters``
    calls (CUDA events around one call would also count the host's launch
    latency, which dominates a kernel of a few microseconds), and
    ``kernels`` the device kernels recorded a call. A session that records
    no device kernel, or fewer than ``expect`` a call, is retried, up to
    PROFILE_SESSIONS; after that ``timer == 'cuda_events'``: the time of
    ``iters`` back-to-back calls between two CUDA events, which includes
    host launch time where that exceeds the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    n = None
    for _ in range(PROFILE_SESSIONS):
        kernels = profiled_kernels(torch, calls, attempts=1)
        if not kernels:
            PROFILER_MISSES['empty'] += 1
            continue
        n = sum(v[1] for v in kernels.values()) / iters
        if expect is None or n == expect:
            return (sum(v[0] for v in kernels.values()) / iters, 'profiler',
                    n)
        PROFILER_MISSES['short'] += 1
    PROFILER_MISSES['fallbacks'] += 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    calls()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 'cuda_events', n


# bytes written between two calls of a cold-L2 reading: more than the 50 MB
# L2, as a serving step reads each layer's cache after the other layers'
FLUSH_BYTES = 128 << 20


# the device kernels of the L2 flush (named once a process: each profiler
# session costs about a second of the run's time limit)
FLUSH_NAMES = set()


def cold_device_ms(torch, fn, iters=10):
    """Device time of one ``fn()`` with the L2 cache flushed before each
    call (a uint8 fill of FLUSH_BYTES): the summed duration of the kernels
    ``fn`` launches, from torch.profiler, leaving out the fill's kernels.
    None where the profiler records none of ``fn``'s kernels."""
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device='cuda')

    def flush():
        buf.fill_(1)

    flush()
    fn()
    torch.cuda.synchronize()
    if not FLUSH_NAMES:
        FLUSH_NAMES.update(profiled_kernels(torch, flush))
    flush_names = FLUSH_NAMES

    def calls():
        for _ in range(iters):
            flush()
            fn()

    kernels = profiled_kernels(torch, calls)
    del buf
    ms = [v[0] for name, v in kernels.items() if name not in flush_names]
    return sum(ms) / iters if ms else None


# the redesigned kernels' entry functions whose compiler report chip_smoke
# prints (every template instance: K2's and K4's epilogue of each K2/K4
# mainloop, the key split's row loader, rows a block and chunk flag of K7,
# K1, K6 and K5, the latent split's pool dtype and chunk flag of K8, K10
# and K9, K3's element type and pieces a thread), and the wrappers whose
# every row it prints (with the launch floor beside K3's)
PTXAS_KERNELS = ('int8_gemm_wgmma', 'int8_gemv_splitk', 'key_split_kernel',
                 'latent_split_kernel', 'split_combine_kernel',
                 'quantize_rows_kernel')
SPLIT_LOADERS = ('TieredPagedKV', 'PagedKV', 'ContigKV')
REDESIGNED = ('int8_matmul', 'yoco_vmm_int8', 'flash_decode_contig',
              'flash_decode_paged', 'flash_decode_paged_q8',
              'flash_decode_paged_mla', 'flash_decode_paged_mla_q8',
              'quantize_rows', 'flash_chunk_paged', 'flash_chunk_paged_mla',
              'launch_floor')


def ptxas_summary(logs) -> list:
    """Registers, shared memory and spills of each PTXAS_KERNELS entry
    function, from ``nvcc -Xptxas -v`` reports ({source: text}); a key
    split instance also names its row loader, query rows a block, aligned
    and chunk flags, a latent split instance its pool dtype and chunk
    flag, a K3 instance its element type, pieces a thread, aligned and
    cluster flags (from the mangled template arguments)."""
    import re
    out, cur = [], None
    for src, log in logs.items():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
                cur = None
                short = [k for k in PTXAS_KERNELS if k in name]
                if short:
                    cur = dict(name=short[0], source=f'{src}.cu',
                               kernel=name)
                    loader = [k for k in SPLIT_LOADERS if k in name]
                    if loader:
                        cur['loader'] = loader[0]
                    if short[0] == 'latent_split_kernel':
                        cur['pool'] = ('bfloat16' if '__nv_bfloat16' in name
                                       else 'float32')
                        cur['chunk'] = 'Lb1E' in name
                    if short[0] in ('key_split_kernel',
                                    'quantize_rows_kernel'):
                        t = re.search(r'Li(\d+)ELb([01])E(?:Lb([01])E)?',
                                      name)
                        if t:
                            cur['rows' if loader else 'vecs'] = int(t[1])
                            cur['aligned'] = t[2] == '1'
                            cur['chunk' if loader else 'cluster'] = \
                                t[3] == '1'
                        if not loader:
                            cur['dtype'] = ('bfloat16' if '__nv_bfloat16'
                                            in name else 'float32')
                    out.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r'(\d+) bytes stack frame', line)
            if m:
                cur['stack_frame'] = int(m.group(1))
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                          line)
            if m:
                cur['spill_stores'] = int(m.group(1))
                cur['spill_loads'] = int(m.group(2))
            m = re.search(r'Used (\d+) registers', line)
            if m:
                cur['registers'] = int(m.group(1))
                sm = re.search(r'(\d+) bytes smem', line)
                cur['static_smem'] = int(sm.group(1)) if sm else 0
    return out


def bound(nbytes: float, ops: float = 0.0, ops_rate: float = None):
    """(ms, 'bytes' or 'operations'): ``roofline.bound_s`` and which of its
    two times it is; ``ops_rate`` defaults to the int8 peak."""
    rate = roofline.PEAK_FLOPS_INT8 if ops_rate is None else ops_rate
    ms = roofline.bound_s(nbytes, ops, rate) * 1e3
    return (ms, 'bytes') if nbytes / roofline.HBM_BW >= ops / rate else \
        (ms, 'operations')


# ----------------------------------------------------------------------------
# phase 2: every kernel against its plain version at full-width shapes
# ----------------------------------------------------------------------------
def record_row(torch, rows, name, shape, err, tol, fn, plain, lib, nbytes,
               ops=0.0, ops_rate=None, route='cuda', source='',
               replaces='', kernels_per_launch=1, plain_iters=20):
    """Hold one kernel case to its tolerance, then time the kernel, its
    plain version (over ``plain_iters`` calls) and the library call, and
    append the row. The kernel's time counts only a profiler session that
    recorded every device kernel of the launches its wrapper counted
    (``kernels_per_call``; K1, K6 and K7 run two kernels a launch, their
    key splits and the combine)."""
    from repro_torch.kernels import build
    check(err <= tol, f'{name} {shape}: max |kernel - plain| = {err} '
                      f'> {tol}')
    b_ms, b_by = bound(nbytes, ops, ops_rate)
    lib_ms = lib_timer = None
    if lib is not None:
        try:
            lib()
        except RuntimeError:
            lib = None          # the library call does not take this shape
    if lib is not None:
        lib_ms, lib_timer, _ = device_ms(torch, lib)
    before = sum(build.LAUNCHES.values())
    fn()
    launches = sum(build.LAUNCHES.values()) - before
    ms, timer, kernels = device_ms(torch, fn,
                                   expect=launches * kernels_per_launch)
    plain_ms, plain_timer, _ = device_ms(torch, plain, iters=plain_iters)
    rows.append(dict(name=name, shape=shape, route=route, source=source,
                     replaces=replaces, max_abs_err=err, tol=tol,
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib_ms,
                     kernels_per_call=kernels,
                     timer=dict(ms=timer, plain_ms=plain_timer,
                                library_ms=lib_timer)))


def _paged_shape(q, kp, pos, win, bt, **extra):
    """The shape dict of a K1 or K6 row."""
    b, hkv, g, dh = q.shape
    w, ps = bt.shape[1], kp.shape[1]
    pos_h, win_h = pos.cpu().tolist(), win.cpu().tolist()
    return dict(B=b, Hkv=hkv, G=g, dh=dh, page_size=ps, W=w,
                pool=str(kp.dtype).replace('torch.', ''),
                live_keys=sum(min(p + 1, w_) for p, w_ in zip(pos_h, win_h)),
                windowed_slots=sum(w_ <= w * ps for w_ in win_h), **extra)


def k1_row(torch, fd, rows, q, kp, vp, pos, win, bt, plain_iters=20):
    """Hold K1 (paged decode on the key split) to its plain version, 1e-5
    on either pool dtype (both compute in f32 on the same pools), every
    row finite; record its row with an L2-cold reading."""
    scale = 1.0 / q.shape[-1] ** 0.5

    def k1():
        return fd.flash_decode_gqa_paged(q, kp, vp, pos, win, bt,
                                         scale=scale)

    def plain():
        return fd.flash_decode_gqa_paged_plain(q, kp, vp, pos, win, bt,
                                               scale=scale)
    got, want = k1(), plain()
    torch.cuda.synchronize()
    shape = _paged_shape(q, kp, pos, win, bt)
    tag = f'K1 {shape}'
    check(bool(torch.isfinite(got).all()), f'{tag}: output not finite')
    _, hkv, _, dh = q.shape
    nbytes = (2 * shape['live_keys'] * hkv * dh * kp.element_size()
              + 2 * q.numel() * 4)
    record_row(torch, rows, 'flash_decode_paged', shape,
               float((got - want).abs().max()), 1e-5, k1, plain, None,
               nbytes, source='src/repro_torch/csrc/flash_decode.cu',
               replaces='src/repro/kernels/flash_decode.py:304',
               kernels_per_launch=2, plain_iters=plain_iters)
    rows[-1]['cold_ms'] = cold_device_ms(torch, k1)


def k6_row(torch, fd, rows, q, c, pos, win, bt, hw, plain_iters=20):
    """Hold K6 (K1 over the int8 tier, hot window ``hw``) to its plain
    version (1e-5, every row finite) on pools ``c`` whose pages outside
    the hot window are quantized, and record its row, with an L2-cold
    reading and K1's time on the same fp pools. Then poison the int8 tier
    (127 / -127 codes, NaN / 1e6 scales): with a hot window covering the
    table K6 must equal K1 bit for bit."""
    from repro_torch.runtime import kv_quant as kvq

    scale = 1.0 / q.shape[-1] ** 0.5
    ps, w = c['k'].shape[1], bt.shape[1]
    hwt = torch.tensor([hw], dtype=torch.int32, device=q.device)
    args = (q, c['k'], c['v'], c['kq'], c['vq'], c['ks'], c['vs'], pos, win,
            bt)

    def k6():
        return fd.flash_decode_gqa_paged_q8(*args, hwt, scale=scale)

    def plain():
        return fd.flash_decode_gqa_paged_q8_plain(*args, hwt, scale=scale)

    def k1():
        return fd.flash_decode_gqa_paged(q, c['k'], c['v'], pos, win, bt,
                                         scale=scale)
    got, want = k6(), plain()
    torch.cuda.synchronize()
    pos_h, win_h = pos.cpu().tolist(), win.cpu().tolist()
    shape = _paged_shape(
        q, c['k'], pos, win, bt, hot_window=hw,
        cold_pages=len(kvq.cold_page_list(bt.cpu(), pos_h, ps, hw)))
    check(bool(torch.isfinite(got).all()), f'K6 {shape}: output not finite')
    # bytes: each live key from its one tier, a scale pair per cold live
    # page, q in and out
    _, hkv, _, dh = q.shape
    elt = c['k'].element_size()
    nbytes = 2 * q.numel() * 4
    for p_, w_ in zip(pos_h, win_h):
        first_hot = max(p_, 0) // ps - hw + 1
        cold_pages = set()
        for kpos in range(max(p_ - w_ + 1, 0), p_ + 1):
            if kpos // ps >= first_hot:
                nbytes += 2 * hkv * dh * elt
            else:
                nbytes += 2 * hkv * dh
                cold_pages.add(kpos // ps)
        nbytes += len(cold_pages) * 2 * hkv * 4
    record_row(torch, rows, 'flash_decode_paged_q8', shape,
               float((got - want).abs().max()), 1e-5, k6, plain, None,
               nbytes, source='src/repro_torch/csrc/flash_decode.cu',
               replaces='src/repro/kernels/flash_decode.py:475',
               kernels_per_launch=2, plain_iters=plain_iters)
    rows[-1]['cold_ms'] = cold_device_ms(torch, k6)
    # what the tier costs on the device: K1 over the same fp pools
    rows[-1]['k1_ms_same_inputs'], *_ = device_ms(torch, k1, expect=2)
    rows[-1]['k1_cold_ms_same_inputs'] = cold_device_ms(torch, k1)
    # a hot window covering the table never reads the int8 tier: K6 is
    # then bit-equal to K1, even over poisoned int8 pools
    c['kq'].fill_(127)
    c['vq'].fill_(-127)
    c['ks'].fill_(float('nan'))
    c['vs'].fill_(1e6)
    full = torch.tensor([w], dtype=torch.int32, device=q.device)
    q8 = fd.flash_decode_gqa_paged_q8(*args, full, scale=scale)
    fp = k1()
    torch.cuda.synchronize()
    check(bool(torch.equal(q8, fp)),
          f'K6 with hw >= W differs from K1 ({shape}): max '
          f'{float((q8 - fp).abs().max())}')
    rows[-1]['bit_equal_k1_at_full_hot_window'] = True


def tiered_pools(torch, gen, q, bt, pos, n_pages, ps, hw, dt):
    """Random fp pools of dtype ``dt`` and an int8 tier in which every page
    outside its hot window is quantized (``quantize_pages_layer``)."""
    from repro_torch.runtime import kv_quant as kvq
    _, hkv, _, dh = q.shape
    dev = q.device
    shape = (n_pages, ps, hkv, dh)
    c = dict(k=torch.randn(shape, generator=gen, device=dev).to(dt),
             v=torch.randn(shape, generator=gen, device=dev).to(dt),
             kq=torch.zeros(shape, dtype=torch.int8, device=dev),
             vq=torch.zeros(shape, dtype=torch.int8, device=dev),
             ks=torch.zeros((n_pages, hkv), device=dev),
             vs=torch.zeros((n_pages, hkv), device=dev))
    cold = kvq.cold_page_list(bt.cpu(), pos.cpu().tolist(), ps, hw)
    kvq.quantize_pages_layer(c, torch.tensor(cold, device=dev))
    return c


def kernel_phase(torch, kmods, nan=None):
    """Every kernel at its main paths' shapes; the rows. K3's crafted rows
    (their ninth kind holds a NaN) add one NaN report a cut to ``nan``."""
    fd, kq, ky, build = kmods
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def record(*args, **kw):
        record_row(torch, rows, *args, **kw)

    # K1: B=8 slots, Hkv=32, G=1, dh=64, page size 8, W=20 (128 + 32 tokens)
    b, hkv, g, dh, ps, w = 8, 32, 1, 64, 8, 20
    n_pages = 1 + b * w
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(b, w).to(torch.int32).contiguous()
    pos = torch.randint(1, w * ps, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = 0                       # an idle slot: pos 0 ...
    bt[0] = 0                        # ... against the garbage page
    win = torch.full((b,), w * ps + 1, dtype=torch.int32, device=dev)
    win[1::2] = 9                    # a sliding window on every odd slot
    check(bool(((pos - win + 1) // ps > 0).any()),
          'K1 case: no window starts past the first page')
    q = torch.randn((b, hkv, g, dh), generator=gen, device=dev)
    # kernel and plain version both compute in f32 on the same pools, so
    # bf16 pools are held to the f32 tolerance
    for dt in (torch.bfloat16, torch.float32):
        kp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        vp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        k1_row(torch, fd, rows, q, kp, vp, pos, win, bt)

    # the launch floor: a kernel that does nothing, launched through the
    # same C interface as K3, timed as every row is (K3's decode rows are
    # held against it: their byte bound is far below any launch)
    floor_fn = build.function('quantize', 'launch_floor', [build.P])

    def floor():
        build.check(floor_fn(torch.cuda.current_stream().cuda_stream),
                    'quantize', 'launch_floor')
    floor_ms, floor_timer, floor_n = device_ms(torch, floor, expect=1)
    rows.append(dict(name='launch_floor', shape=dict(grid=1, threads=32),
                     ms=floor_ms, kernels_per_call=floor_n,
                     timer=dict(ms=floor_timer)))
    # K3 bit-exact beyond the serving rows: a K that is no multiple of a
    # 16-byte piece, a row base off 16-byte alignment (both the kernel's
    # element-load branch), one short row, and a row whose absmax sits in
    # the last cluster slice
    for m, k, dt, shift in ((8, 7, torch.float32, 0),
                            (1024, 2049, torch.bfloat16, 0),
                            (8, 2048, torch.bfloat16, 1),
                            (8, 7168, torch.bfloat16, 0),
                            (1, 5632, torch.float32, 3)):
        x = torch.randn((m * k + shift,), generator=gen, device=dev).to(dt)
        x = x[shift:].view(m, k)
        x[-1, -1] = 100.0             # the absmax in the row's last piece
        xq, sx = kq.quantize_rows(x)
        xq_p, sx_p = kq.quantize_rows_plain(x)
        torch.cuda.synchronize()
        check(bool(torch.equal(xq, xq_p) and torch.equal(sx, sx_p)),
              f'K3 ({m},{k}) {dt} offset {shift} not bit-exact')
    # K3 bit-exact on crafted rows that random rows never reach, on one CTA
    # a row (K=2048), clusters (K=7168, 18432), several rows a block
    # (M=1024) and the element-load branch (K=2049; a base off 16 bytes);
    # 9 decode rows take the 8 rows' cut and hold every kind, the NaN
    # row's scale NaN in both
    for m, k, shift in ((9, 2048, 0), (9, 7168, 0), (9, 18432, 0),
                        (1024, 2048, 0), (9, 2049, 0), (9, 7168, 1)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.empty((m * k + shift,), device=dev, dtype=dt)
            x = x[shift:].view(m, k)
            x.copy_(k3_crafted_rows(torch, m, k, gen))
            xq, sx = kq.quantize_rows(x)
            xq_p, sx_p = kq.quantize_rows_plain(x)
            torch.cuda.synchronize()
            check(bool(torch.equal(xq, xq_p))
                  and _same_floats(torch, sx, sx_p),
                  f'K3 crafted rows ({m},{k}) {dt} offset {shift} not '
                  f'bit-exact')
            check(xq[0, :8].tolist() == [127, 2, -4, 0, 0, 126, 2, -2],
                  f'K3 crafted rows ({m},{k}) {dt}: ties not half to even')
            nan_rows = torch.isnan(sx_p[:, 0]).cpu()
            check(torch.equal(nan_rows, torch.arange(m) % K3_ROW_KINDS == 8),
                  f'K3 crafted rows ({m},{k}) {dt}: NaN scales off the NaN '
                  f'kind\'s rows')
            if nan is not None:
                nan.append(dict(
                    kernel='K3', case=f'crafted rows ({m},{k}) offset '
                    f'{shift}', pool=str(dt).replace('torch.', ''), rows=m,
                    plain_nonfinite_rows=int(nan_rows.sum()),
                    kernel_nonfinite_rows=int(torch.isnan(sx[:, 0]).sum()),
                    same_rows=True, codes_bit_equal=True,
                    max_abs_err_finite_rows=0.0, tol=0.0))

    # K3 / K2 / K4 at each main path's linear shapes, M in {8 slots,
    # 128-token prompt} and, for stablelm's layer linears, the static
    # prefill's 1024 rows: K3 on the bf16 activation and on the f32
    # weight's transpose (dynamic w8a8 quantizes it every call, in place:
    # the weight is stored K-major at load), K4 on both; K2 on stablelm
    # only (the dense prefix is served without --prequantize)
    from repro_torch.core.yoco_linear import prequantize_weight
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.models.model import k_major_linear_weights
    for arch, kn, with_k2 in LINEAR_SHAPES:
        seen = set()                    # one K3 activation row per (M, K)
        for k, n in kn:
            wf = torch.randn((k, n), generator=gen, device=dev)
            # dynamic w8a8's weight as served: k_major_linear_weights'
            # K-major f32, whose transpose wt K3 reads in place
            wt = k_major_linear_weights(dict(wq=wf))['wq'].t()
            check(wt.is_contiguous(), f'k_major_linear_weights ({k},{n}) '
                                      f'is not K-major')
            # K2's weight as served: prequantize_weight's K-major int8
            wk = prequantize_weight(wf).wq if with_k2 else None
            check(wk is None or wk.t().is_contiguous(),
                  f'prequantize_weight ({k},{n}) is not K-major')
            # no hidden per-call transpose: a row-major float weight is
            # refused before any launch
            try:
                ops.yoco_vmm(torch.zeros((8, k), device=dev), wf)
            except ValueError:
                pass
            else:
                check(False, 'ops.yoco_vmm took a row-major (K, N) weight')
            del wf
            wq_t, sw_t = kq.quantize_rows(wt)
            wq_tp, sw_tp = kq.quantize_rows_plain(wt)
            torch.cuda.synchronize()
            check(bool(torch.equal(wq_t, wq_tp) and torch.equal(sw_t, sw_tp)),
                  f'K3 ({n},{k}) f32 not bit-exact')
            del wq_tp, sw_tp
            record('quantize_rows', dict(arch=arch, M=n, K=k,
                                         dtype='float32'), 0.0, 0.0,
                   lambda: kq.quantize_rows(wt),
                   lambda: kq.quantize_rows_plain(wt), None,
                   n * k * 4 + n * k + n * 4,
                   source='src/repro_torch/csrc/quantize.cu',
                   replaces='src/repro/kernels/quantize.py:35')
            # K4's operands as ops.yoco_vmm hands them over: views of K3's
            # (N, K) codes and (N, 1) scales, uncopied
            wq, sw = wq_t.t(), sw_t.reshape(1, n)
            wr = wq.contiguous()      # row-major codes: K2 and K4 refuse them
            static = arch == ARCH and (k, n) in STATIC_PREFILL_LINEARS
            for m in (8, 128) + ((STATIC_PREFILL_ROWS,) if static else ()):
                x = torch.randn((m, k), generator=gen, device=dev).to(
                    torch.bfloat16)
                x[0, :] = 0          # an all-zero row: scale 1e-8 / 127
                xq, sx = kq.quantize_rows(x)
                xq_p, sx_p = kq.quantize_rows_plain(x)
                torch.cuda.synchronize()
                check(bool(torch.equal(xq, xq_p) and torch.equal(sx, sx_p)),
                      f'K3 ({m},{k}) bf16 not bit-exact')
                if (m, k) not in seen:
                    seen.add((m, k))
                    record('quantize_rows', dict(arch=arch, M=m, K=k,
                                                 dtype='bfloat16'), 0.0,
                           0.0, lambda: kq.quantize_rows(x),
                           lambda: kq.quantize_rows_plain(x), None,
                           m * k * 2 + m * k + m * 4,
                           source='src/repro_torch/csrc/quantize.cu',
                           replaces='src/repro/kernels/quantize.py:35')
                mm_bytes = m * k + k * n
                if with_k2:
                    # no hidden per-call transpose: a row-major weight is
                    # refused
                    try:
                        ky.int8_matmul(xq, wr)
                    except ValueError:
                        pass
                    else:
                        check(False, 'K2 took a row-major (K, N) weight')
                    acc = ky.int8_matmul(xq, wk)
                    acc_p = ky.int8_matmul_plain(xq, wk)
                    torch.cuda.synchronize()
                    check(bool(torch.equal(acc, acc_p)),
                          f'K2 ({m},{k},{n}) not bit-exact')
                    del acc, acc_p
                    # the library call on the same K-major operands
                    record('int8_matmul', dict(arch=arch, M=m, K=k, N=n),
                           0.0, 0.0, lambda: ky.int8_matmul(xq, wk),
                           lambda: ky.int8_matmul_plain(xq, wk),
                           lambda: torch._int_mm(xq, wk),
                           mm_bytes + 4 * m * n, 2.0 * m * k * n,
                           source='src/repro_torch/csrc/yoco_vmm.cu',
                           replaces='src/repro/kernels/yoco_vmm.py:116')
                # a row-major weight is refused, as K2's is
                try:
                    ky.yoco_vmm_int8(xq, wr, sx, sw)
                except ValueError:
                    pass
                else:
                    check(False, 'K4 took a row-major (K, N) weight')
                if m == 8:
                    # the whole dynamic linear on the served weight: K3,
                    # K3 on wᵀ in place, K4, against the plain composition
                    y = ops.yoco_vmm(x, wt.t())
                    y_p = kref.yoco_vmm_ref(x, wt.t())
                    torch.cuda.synchronize()
                    check(bool(torch.equal(y, y_p)),
                          f'ops.yoco_vmm ({m},{k},{n}) differs from '
                          f'yoco_vmm_ref')
                    del y, y_p
                y = ky.yoco_vmm_int8(xq, wq, sx, sw)
                y_p = ky.yoco_vmm_int8_plain(xq, wq, sx, sw)
                torch.cuda.synchronize()
                check(bool(torch.equal(y, y_p)),
                      f'K4 ({m},{k},{n}) differs from its plain version')
                del y, y_p
                record('yoco_vmm_int8', dict(arch=arch, M=m, K=k, N=n), 0.0,
                       0.0, lambda: ky.yoco_vmm_int8(xq, wq, sx, sw),
                       lambda: ky.yoco_vmm_int8_plain(xq, wq, sx, sw), None,
                       mm_bytes + 4 * (m + n) + 4 * m * n, 2.0 * m * k * n,
                       source='src/repro_torch/csrc/yoco_vmm.cu',
                       replaces='src/repro/kernels/yoco_vmm.py:65')
            del wt, wq_t, sw_t, wq, sw, wr, wk
    return rows


#: the kinds of crafted K3 rows
K3_ROW_KINDS = 9


def k3_crafted_rows(torch, m, k, gen):
    """(m, k) f32 rows of nine kinds, row i of kind i % 9: exact .5
    quotients (absmax 127 gives scale 1.0; absmax 508 scale 4.0), denormals
    beside a normal absmax and alone, an absmax near the largest finite
    value, one below 1e-8, tiny normals, a row holding +inf and -inf (its
    scale inf, inf / inf a NaN code), and a row holding a NaN (the
    poisoned lane's activation: its scale NaN, every code a NaN's)."""
    ties = torch.tensor([2.5, -3.5, 0.5, -0.5, 126.5, 1.5, -1.5, 125.5],
                        device=gen.device)
    noise = torch.randn((m, k), generator=gen, device=gen.device)
    x = torch.empty((m, k), device=gen.device)
    tiled = ties.repeat(-(-k // 8))[:k - 1]
    for kind in range(K3_ROW_KINDS):
        r = x[kind::K3_ROW_KINDS]
        if kind in (0, 7):
            r[:, 0] = 127.0 if kind == 0 else 508.0
            r[:, 1:] = tiled * (1 if kind == 0 else 4)
        elif kind in (1, 2):
            r.copy_(noise[kind::K3_ROW_KINDS] * 1e-39)
            if kind == 1:
                r[:, -1] = 1.0
        elif kind == 3:
            r.copy_(noise[kind::K3_ROW_KINDS] * 1e37)
            r[:, k // 2] = 3.0e38
        elif kind == 4:
            r.copy_(noise[kind::K3_ROW_KINDS] * 1e-9)
        elif kind == 5:
            r.copy_(noise[kind::K3_ROW_KINDS])
            r[:, k // 3] = float('inf')
            r[:, -1] = float('-inf')
        elif kind == 6:
            r.copy_(noise[kind::K3_ROW_KINDS] * 1e-30)
        else:
            r.copy_(noise[kind::K3_ROW_KINDS])
            r[:, k // 5] = float('nan')
    return x


def tier_chunk_kernel_phase(torch, kmods):
    """K6 (paged decode over the int8 tier) and K5 (chunked-prefill
    attention) against their plain versions at full-width shapes, K5 also
    at a 4,096-token context."""
    from repro_torch.runtime import kv_quant as kvq

    fd = kmods[0]
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []

    # K6: B=8, Hkv=32, G=1, dh=64, page size 8, W=20, hot window 2; one
    # idle slot, a 9-key window on every odd slot, three slots deep enough
    # for many cold pages; every page outside its hot window quantized
    b, hkv, g, dh, ps, w, hw = 8, 32, 1, 64, 8, 20, 2
    n_pages = 1 + b * w
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    pos = torch.randint(1, w * ps, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = 0
    bt[0] = 0
    pos[2], pos[4], pos[6] = w * ps - 1, 130, 97
    win = torch.full((b,), w * ps + 1, dtype=torch.int32, device=dev)
    win[1::2] = 9
    q = torch.randn((b, hkv, g, dh), generator=gen, device=dev)
    cold = kvq.cold_page_list(bt.cpu(), pos.cpu().tolist(), ps, hw)
    check(len(cold) >= 30, f'K6 case has only {len(cold)} cold pages')
    for dt in (torch.bfloat16, torch.float32):
        c = tiered_pools(torch, gen, q, bt, pos, n_pages, ps, hw, dt)
        k6_row(torch, fd, rows, q, c, pos, win, bt, hw)
        del c

    # K5 (on the key split: two device kernels a launch): one request,
    # Hkv=32, G=1, dh=64, page size 8. W=20, limit 128: C=32 at offsets 0
    # and 96 (a miss's first chunk, a prefix hit's suffix at
    # --chunk-prefill 32), C=8 at offsets 96 and 120 (the first and last
    # page-size chunk of a prefix hit's suffix, the chunk size the prefix
    # cache uses without --chunk-prefill) and an unaligned C=7 whose last 3
    # rows are padding. W=512, limit 4096 (a 4,096-token context): C=32 at
    # offset 4064 and C=8 at 4088, the plain version timed over 2 calls
    for w, limit, cases in (
            (20, 128, ((32, 0), (32, 96), (8, 96), (8, 120), (7, 124))),
            (512, 4096, ((32, 4064), (8, 4088)))):
        k5_rows(torch, fd, rows, gen, w, limit, cases)
    return rows


def k5_rows(torch, fd, rows, gen, w, limit, cases, hkv=32, g=1, dh=64,
            window=None):
    """Hold K5 to its plain version (1e-5 on the rows below ``limit``, every
    row finite) for one request of Hkv=32, G=1, dh=64 (or the given head
    layout and sliding ``window``) over a W-page table, bf16 and f32 pools,
    at each (C, offset) of ``cases``; record the rows (the plain version
    over 2 calls at W > 20)."""
    dev = torch.device('cuda')
    src = 'src/repro_torch/csrc/flash_decode.cu'
    b, ps = 1, 8
    reach = window if window is not None else w * ps + 1
    scale = 1.0 / dh ** 0.5
    n_pages = 1 + w
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        kp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        vp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        for c, off in cases:
            qc = torch.randn((b, c, hkv * g, dh), generator=gen, device=dev)
            qg = qc.reshape(b, c, hkv, g, dh).permute(0, 2, 1, 3, 4) \
                .reshape(b, hkv, c * g, dh).contiguous()
            offv, posv, winv = fd._chunk_scalars(off, limit, window, b, c,
                                                 w * ps, dev)
            args = (qg, kp, vp, posv, winv, bt, offv)
            got = fd.flash_decode_gqa_paged(*args, scale=scale, chunk=c)
            want = fd.flash_decode_gqa_paged_plain(*args, scale=scale,
                                                   chunk=c)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f'K5 C={c} offset={off}: output not finite')
            n_valid = min(c, limit - off)
            rowpos = off + torch.arange(c * g, device=dev) // g
            valid = rowpos < limit
            err = float((got - want)[:, :, valid].abs().max())
            pos_u = int(posv[0])
            # keys [max(offset - window + 1, 0), pos]: the rows' union
            live_keys = pos_u + 1 - max(off - reach + 1, 0)
            nbytes = (2 * live_keys * hkv * dh * kp.element_size()
                      + 2 * int(valid.sum()) * hkv * dh * 4)
            row_keys = sum(min(off + i + 1, reach)
                           for i in range(n_valid)) * g
            ops = 4.0 * hkv * dh * row_keys
            record_row(torch, rows, 'flash_chunk_paged',
                       dict(B=b, Hkv=hkv, G=g, dh=dh, page_size=ps, W=w,
                            C=c, offset=off, limit=limit, window=window,
                            pool=str(dt).replace('torch.', ''),
                            padding_rows=c - n_valid,
                            all_rows_max_abs_err=float(
                                (got - want).abs().max())),
                       err, 1e-5,
                       lambda: fd.flash_decode_gqa_paged(*args, scale=scale,
                                                         chunk=c),
                       lambda: fd.flash_decode_gqa_paged_plain(
                           *args, scale=scale, chunk=c),
                       None, nbytes, ops, roofline.PEAK_FLOPS_BF16,
                       source=src,
                       replaces='src/repro/kernels/flash_decode.py:304',
                       kernels_per_launch=2,
                       plain_iters=20 if w <= 20 else 2)
            rows[-1]['plan'] = fd.chunk_split_plan(b, w, ps, hkv, c, g, dh,
                                                   kp.element_size())


def paged_split_kernel_phase(torch, kmods):
    """K1 and K6 on the key split beyond the serving rows, bf16 and f32
    pools, K6 at hot window 2: a grouped head layout (Hkv=8, G=4, dh=128,
    W=20: K7's G > 1 case, query rows in pairs; ragged positions, an idle
    slot, a 33-key window on every odd slot), the dense family's layouts
    and qwen2-moe's at the same B=8, W=20 (stablelm-12b Hkv=8, G=4,
    dh=160: two 16-byte pieces a lane in f32; starcoder2-15b Hkv=4, G=12,
    dh=128; gemma3-27b Hkv=16, G=2, dh=128; qwen2-moe Hkv=16, G=1,
    dh=128) and a 4,096-token context (Hkv=32, G=1, dh=64,
    W=512: 8 slots within 16 keys of full, where K1 should reach half its
    bound; the plain versions walk 512 pages, so they are timed over 2
    calls)."""
    fd = kmods[0]
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    ps, hw = 8, 2
    for case, b, hkv, g, dh, w in (('g4', 8, 8, 4, 128, 20),
                                   ('stablelm-12b', 8, 8, 4, 160, 20),
                                   ('starcoder2-15b', 8, 4, 12, 128, 20),
                                   ('gemma3-27b', 8, 16, 2, 128, 20),
                                   ('long', 8, 32, 1, 64, 512),
                                   (MOE_ARCH, 8, 16, 1, 128, 20)):
        n_pages = 1 + b * w
        bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
            .reshape(b, w).to(torch.int32).contiguous()
        win = torch.full((b,), w * ps + 1, dtype=torch.int32, device=dev)
        if case != 'long':
            pos = torch.randint(w * ps // 2, w * ps, (b,), generator=gen,
                                device=dev, dtype=torch.int32)
            pos[0] = 0                     # an idle slot ...
            bt[0] = 0                      # ... against the garbage page
            win[1::2] = 33
        else:
            pos = w * ps - 1 - torch.randint(0, 16, (b,), generator=gen,
                                             device=dev, dtype=torch.int32)
        q = torch.randn((b, hkv, g, dh), generator=gen, device=dev)
        iters = 2 if case == 'long' else 20
        for dt in (torch.bfloat16, torch.float32):
            c = tiered_pools(torch, gen, q, bt, pos, n_pages, ps, hw, dt)
            k1_row(torch, fd, rows, q, c['k'], c['v'], pos, win, bt,
                   plain_iters=iters)
            rows[-1]['shape']['case'] = case
            k6_row(torch, fd, rows, q, c, pos, win, bt, hw,
                   plain_iters=iters)
            rows[-1]['shape']['case'] = case
            del c
    return rows


#: gemma3-27b's local layers: Hkv=16, G=2, dh=128 and a 1,024-key window,
#: at a 1,160-token context (W=145 pages of 8) where the window binds
GEMMA_LOCAL = dict(hkv=16, g=2, dh=128, window=1024, w=145)


def window_kernel_phase(torch, kmods):
    """K1 and K5 at gemma3-27b's local-layer shape with its 1,024-key
    window binding: K1 over 8 slots within 16 keys of a 1,160-token
    context, K5 for one request's last 128-token chunk of a 1,152-token
    prompt (offset 1,024, the --chunk-prefill 128 serve's), bf16 and f32
    pools, each against its plain version (1e-5; the plain versions walk
    145 pages, so they are timed over 2 calls)."""
    fd = kmods[0]
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    hkv, g, dh, window, w = (GEMMA_LOCAL[k] for k in ('hkv', 'g', 'dh',
                                                       'window', 'w'))
    b, ps = 8, 8
    n_pages = 1 + b * w
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    pos = w * ps - 1 - torch.randint(0, 16, (b,), generator=gen, device=dev,
                                     dtype=torch.int32)
    win = torch.full((b,), window, dtype=torch.int32, device=dev)
    check(bool((pos - win + 1 > 0).all()), 'gemma3 K1 case: the window '
                                           'does not bind')
    q = torch.randn((b, hkv, g, dh), generator=gen, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        kp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        vp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        k1_row(torch, fd, rows, q, kp, vp, pos, win, bt, plain_iters=2)
        rows[-1]['shape']['case'] = 'gemma3-27b local'
        del kp, vp
    k5_rows(torch, fd, rows, gen, w, 1152, ((128, 1024),), hkv=hkv, g=g,
            dh=dh, window=window)
    return rows


def contig_kernel_phase(torch, kmods, cases=None, seed=4):
    """K7 (flash decode over a contiguous cache) against its plain version
    at stablelm-1.6b's static-serve shape, B=8, Hkv=32, G=1, dh=64, S=160
    (prompt 128 + 32 generated): lock-step at pos S - 16 = 144 and ragged
    positions, a 33-key sliding window on every odd slot, bf16 and f32
    caches; one G > 1 case at an S that is not a multiple of 32 or 128
    (Hkv=8, G=4, dh=128, S=200); and lock-step at stablelm's max_seq_len,
    S=4096, bf16. Tolerance 1e-5, as K1 (kernel and plain version both
    compute in f32 on the same cache); every row finite;
    ``impl='streamed'`` bit-equal to the prefetch path. Timed beside the
    one PyTorch call computing the same function,
    ``scaled_dot_product_attention`` on the same cache (a permuted view)
    with a (B, 1, 1, S) boolean mask and ``enable_gqa`` when G > 1, each
    with a warm and a cold-L2 reading (cold_device_ms). ``cases`` and
    ``seed`` replace those cases and their generator's seed."""
    import torch.nn.functional as F

    fd = kmods[0]
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    src = 'src/repro_torch/csrc/flash_decode.cu'
    cases = cases or (
             ('lockstep', 8, 32, 1, 64, 160, torch.bfloat16),
             ('lockstep', 8, 32, 1, 64, 160, torch.float32),
             ('ragged', 8, 32, 1, 64, 160, torch.bfloat16),
             ('ragged', 8, 32, 1, 64, 160, torch.float32),
             ('g4_unaligned', 8, 8, 4, 128, 200, torch.bfloat16),
             ('g4_unaligned', 8, 8, 4, 128, 200, torch.float32),
             ('g4_dh160', 8, 8, 4, 160, 200, torch.bfloat16),
             ('g4_dh160', 8, 8, 4, 160, 200, torch.float32),
             ('lockstep', 8, 32, 1, 64, 4096, torch.bfloat16))
    for case, b, hkv, g, dh, s_max, dt in cases:
        scale = 1.0 / dh ** 0.5
        if case == 'lockstep':
            pos = torch.full((b,), s_max - 16, dtype=torch.int32, device=dev)
        else:
            pos = torch.randint(s_max // 2, s_max, (b,), generator=gen,
                                device=dev, dtype=torch.int32)
            pos[0] = 0                          # a one-key request
            pos[1] = s_max - 1
        win = torch.full((b,), s_max + 1, dtype=torch.int32, device=dev)
        win[1::2] = 33
        q = torch.randn((b, hkv, g, dh), generator=gen, device=dev)
        k = torch.randn((b, s_max, hkv, dh), generator=gen,
                        device=dev).to(dt)
        v = torch.randn((b, s_max, hkv, dh), generator=gen,
                        device=dev).to(dt)
        args = (q, k, v, pos, win)
        got = fd.flash_decode_gqa(*args, scale=scale)
        streamed = fd.flash_decode_gqa(*args, scale=scale, prefetch=False)
        want = fd.flash_decode_gqa_plain(*args, scale=scale)
        torch.cuda.synchronize()
        tag = f'K7 {case} G={g} {dt}'
        check(bool(torch.isfinite(got).all()), f'{tag}: output not finite')
        check(bool(torch.equal(streamed, got)),
              f'{tag}: streamed differs from prefetch by '
              f'{float((streamed - got).abs().max())}')
        err = float((got - want).abs().max())
        pos_h, win_h = pos.cpu().tolist(), win.cpu().tolist()
        live_keys = sum(min(p + 1, w_) for p, w_ in zip(pos_h, win_h))
        nbytes = (2 * live_keys * hkv * dh * k.element_size()
                  + 2 * q.numel() * 4)
        # the library call: the same function on the same cache, q in the
        # cache dtype (it takes one dtype), keys masked as K7 masks them
        kpos = torch.arange(s_max, device=dev)
        mask = ((kpos[None] <= pos[:, None].long())
                & (kpos[None] > (pos - win)[:, None].long()))[:, None, None]
        q_lib = q.reshape(b, hkv * g, 1, dh).to(dt)
        k_lib, v_lib = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        gqa = dict(enable_gqa=True) if g > 1 else {}
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q_lib, k_lib, v_lib, attn_mask=mask, scale=scale, **gqa)
        record_row(torch, rows, 'flash_decode_contig',
                   dict(case=case, B=b, Hkv=hkv, G=g, dh=dh, S=s_max,
                        pool=str(dt).replace('torch.', ''),
                        live_keys=live_keys, pos=pos_h,
                        windowed_slots=int((win <= s_max).sum()),
                        streamed_bit_equal=True),
                   err, 1e-5,
                   lambda: fd.flash_decode_gqa(*args, scale=scale),
                   lambda: fd.flash_decode_gqa_plain(*args, scale=scale),
                   sdpa, nbytes, 4.0 * dh * hkv * g * live_keys,
                   roofline.PEAK_FLOPS_BF16, source=src,
                   replaces='src/repro/kernels/flash_decode.py:252',
                   kernels_per_launch=2)
        rows[-1]['streamed_ms'], *_ = device_ms(
            torch, lambda: fd.flash_decode_gqa(*args, scale=scale,
                                               prefetch=False), expect=2)
        # L2-cold readings, taken in turns: three each at lock-step (for
        # their spread), one elsewhere; the row keeps the median
        cold, lib_cold = [], []
        for _ in range(3 if case == 'lockstep' else 1):
            cold.append(cold_device_ms(
                torch, lambda: fd.flash_decode_gqa(*args, scale=scale)))
            lib_cold.append(cold_device_ms(torch, sdpa))
        rows[-1]['cold_ms'] = _median(cold)
        rows[-1]['library_cold_ms'] = _median(lib_cold)
        if len(cold) > 1:
            rows[-1]['cold_ms_runs'] = cold
            rows[-1]['library_cold_ms_runs'] = lib_cold
    return rows


def moe_kernel_phase(torch, kmods):
    """The attention kernels at qwen2-moe's heads (Hkv=16, G=1, dh=128)
    beyond phase 2's K1/K6 rows (paged_split_kernel_phase): K5 for one
    request's chunks of a prefix hit's suffix (C=8 and C=32 at offset 96,
    limit 128, W=20) and K7 at the static path's lock-step shape (B=8,
    S=160, pos 144), bf16 and f32 pools, each against its plain version
    (1e-5) with its own generator, so the rows before it keep their
    inputs."""
    gen = torch.Generator(device='cuda').manual_seed(7)
    rows = []
    k5_rows(torch, kmods[0], rows, gen, 20, 128, ((32, 96), (8, 96)),
            hkv=16, g=1, dh=128)
    rows += contig_kernel_phase(
        torch, kmods, seed=8,
        cases=tuple(('lockstep', 8, 16, 1, 128, 160, dt)
                    for dt in (torch.bfloat16, torch.float32)))
    return rows


def frontend_kernel_phase(torch, kmods):
    """K7 at qwen2-vl-72b's static shapes (B=8, S=160, lock-step at pos
    144, a 33-key window on every odd slot; Hkv=8, G=8, dh=128) on bf16
    and f32 caches, each against its plain version (1e-5) beside SDPA,
    with its own generator. musicgen-large's heads (Hkv=32, G=1, dh=64)
    are stablelm-1.6b's: the static phase's row holds them."""
    return contig_kernel_phase(
        torch, kmods, seed=9,
        cases=(('lockstep', 8, 8, 8, 128, 160, torch.bfloat16),
               ('lockstep', 8, 8, 8, 128, 160, torch.float32)))


def _median(xs):
    """The median of the readings that are not None (None if none is)."""
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else None


def mla_decode_rows(torch, fd, rows, gen, q, pos, win, bt, hw, case,
                    plain_iters=20):
    """Hold K8 (the latent split over a latent pool) and K10 (K8 over the
    int8 latent tier at hot window ``hw``) to their plain versions, 2e-5,
    every row finite, on a bf16 and an f32 pool drawn from ``gen``; record
    both rows (two device kernels a launch: splits, combine) with L2-cold
    readings and K8's time on K10's fp pool; then poison the int8 tier
    (127 / -127 codes, NaN / 1e6 scales): with a hot window covering the
    table K10 must equal K8 bit for bit."""
    from repro_torch.runtime import kv_quant as kvq

    src = 'src/repro_torch/csrc/flash_decode.cu'
    b, _, h, dk = q.shape
    r, tol = MLA_R, 2e-5
    n_pages, w, ps = 1 + b * bt.shape[1], bt.shape[1], MLA_PAGE
    scale = MLA_SCALE
    pos_h = pos.cpu().tolist()
    live_keys = sum(p + 1 for p in pos_h)
    q_out_bytes = b * h * (dk + r) * 4
    flops_per_key = 2.0 * h * (dk + r)
    hwt = torch.tensor([hw], dtype=torch.int32, device=q.device)
    cold = kvq.cold_page_list(bt.cpu(), pos_h, ps, hw)
    for dt in (torch.bfloat16, torch.float32):
        cl = torch.randn((n_pages, ps, dk), generator=gen,
                         device=q.device).to(dt)
        elt = cl.element_size()
        args = (q, cl, pos, win, bt)

        def k8(args=args):
            return fd.flash_decode_mla_paged(*args, scale=scale, r=r)
        got = k8()
        want = fd.flash_decode_mla_paged_plain(*args, scale=scale, r=r)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f'K8 {case} output not finite')
        err = float((got - want).abs().max())
        shape = dict(case=case, B=b, H=h, DK=dk, r=r, page_size=ps, W=w,
                     pool=str(dt).replace('torch.', ''),
                     live_keys=live_keys, idle_slots=pos_h.count(0))
        record_row(torch, rows, 'flash_decode_paged_mla', shape, err, tol,
                   k8, lambda args=args: fd.flash_decode_mla_paged_plain(
                       *args, scale=scale, r=r),
                   None, live_keys * dk * elt + q_out_bytes,
                   flops_per_key * live_keys, roofline.PEAK_FLOPS_BF16,
                   source=src,
                   replaces='src/repro/kernels/flash_decode.py:365',
                   kernels_per_launch=2, plain_iters=plain_iters)
        rows[-1]['cold_ms'] = cold_device_ms(torch, k8)

        c = dict(cl=cl, clq=torch.zeros((n_pages, ps, dk), dtype=torch.int8,
                                        device=q.device),
                 cs=torch.zeros((n_pages, 1), device=q.device))
        kvq.quantize_latent_pages_layer(c, torch.tensor(cold,
                                                        device=q.device))
        qargs = (q, cl, c['clq'], c['cs'], pos, win, bt, hwt)

        def k10(qargs=qargs):
            return fd.flash_decode_mla_paged_q8(*qargs, scale=scale, r=r)
        got = k10()
        want = fd.flash_decode_mla_paged_q8_plain(*qargs, scale=scale, r=r)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f'K10 {case} output not finite')
        err = float((got - want).abs().max())
        nbytes = q_out_bytes
        for p_ in pos_h:
            first_hot = p_ // ps - hw + 1
            for blk in range(p_ // ps + 1):
                n = min(ps, p_ + 1 - blk * ps)     # live rows of the page
                nbytes += n * dk * (elt if blk >= first_hot else 1)
                nbytes += 0 if blk >= first_hot else 4
        record_row(torch, rows, 'flash_decode_paged_mla_q8',
                   dict(shape, hot_window=hw, cold_pages=len(cold)), err, tol,
                   k10, lambda qargs=qargs: fd.flash_decode_mla_paged_q8_plain(
                       *qargs, scale=scale, r=r),
                   None, nbytes, flops_per_key * live_keys,
                   roofline.PEAK_FLOPS_BF16, source=src,
                   replaces='src/repro/kernels/flash_decode.py:556',
                   kernels_per_launch=2, plain_iters=plain_iters)
        rows[-1]['cold_ms'] = cold_device_ms(torch, k10)
        # what the tier costs on the device: K8 over the same fp pool
        rows[-1]['k8_ms_same_inputs'], *_ = device_ms(torch, k8, expect=2)
        rows[-1]['k8_cold_ms_same_inputs'] = cold_device_ms(torch, k8)
        # a hot window covering the table never reads the int8 tier: K10
        # is then bit-equal to K8, even over poisoned int8 pools
        c['clq'][::2] = 127
        c['clq'][1::2] = -127
        c['cs'][::2] = float('nan')
        c['cs'][1::2] = 1e6
        full = torch.tensor([w], dtype=torch.int32, device=q.device)
        q8 = fd.flash_decode_mla_paged_q8(q, cl, c['clq'], c['cs'], pos, win,
                                          bt, full, scale=scale, r=r)
        fp = k8()
        torch.cuda.synchronize()
        check(bool(torch.equal(q8, fp)),
              f'K10 {case} with hw >= W differs from K8 ({dt}): max '
              f'{float((q8 - fp).abs().max())}')
        rows[-1]['bit_equal_k8_at_full_hot_window'] = True
        del c, q8, fp, cl


def k9_rows(torch, fd, rows, gen, w, limit, cases):
    """Hold K9 (the latent split with a chunk's rows) to its plain version
    (2e-5 on the rows below ``limit``, every row finite) for one admission
    of deepseek-v3's H=128, DK=576, r=512 over a W-page table, bf16 and f32
    pools, at each (C, offset) of ``cases``; record the rows (two device
    kernels a launch; the plain version over 2 calls at W > 20). At W > 20
    each row also gets K8's time a (query row x visible key) from its
    W=512 row on the same pool dtype, and its own."""
    dev = torch.device('cuda')
    src = 'src/repro_torch/csrc/flash_decode.cu'
    b, h, r, ps = 1, MLA_H, MLA_R, MLA_PAGE
    dk = r + MLA_DR
    flops_per_key = 2.0 * h * (dk + r)
    n_pages = 1 + w
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        cl = torch.randn((n_pages, ps, dk), generator=gen, device=dev).to(dt)
        pool = str(dt).replace('torch.', '')
        for cc, off in cases:
            qc = torch.randn((b, 1, cc * h, dk), generator=gen, device=dev)
            offv, posv, winv = fd._chunk_scalars(off, limit, None, b, cc,
                                                 w * ps, dev)
            args = (qc, cl, posv, winv, bt, offv)
            got = fd.flash_decode_mla_paged(*args, scale=MLA_SCALE, r=r,
                                            chunk=cc)
            want = fd.flash_decode_mla_paged_plain(*args, scale=MLA_SCALE,
                                                   r=r, chunk=cc)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f'K9 C={cc} offset={off} W={w} {pool}: output not finite')
            n_valid = min(cc, limit - off)
            valid = off + torch.arange(cc * h, device=dev) // h < limit
            err = float((got - want)[:, :, valid].abs().max())
            keys = int(posv[0]) + 1             # keys [0, pos]
            nbytes = (keys * dk * cl.element_size()
                      + n_valid * h * (dk + r) * 4)
            row_keys = sum(off + i + 1 for i in range(n_valid))
            record_row(torch, rows, 'flash_chunk_paged_mla',
                       dict(B=b, H=h, DK=dk, r=r, page_size=ps, W=w, C=cc,
                            offset=off, limit=limit, pool=pool,
                            rows=cc * h, padding_rows=(cc - n_valid) * h,
                            all_rows_max_abs_err=float(
                                (got - want).abs().max())),
                       err, 2e-5,
                       lambda: fd.flash_decode_mla_paged(
                           *args, scale=MLA_SCALE, r=r, chunk=cc),
                       lambda: fd.flash_decode_mla_paged_plain(
                           *args, scale=MLA_SCALE, r=r, chunk=cc),
                       None, nbytes, flops_per_key * row_keys,
                       roofline.PEAK_FLOPS_BF16, source=src,
                       replaces='src/repro/kernels/flash_decode.py:889',
                       kernels_per_launch=2,
                       plain_iters=20 if w <= 20 else 2)
            rows[-1]['plan'] = fd.latent_split_plan(
                b, w, ps, cc * h, dk, r, cl.element_size())
            if w > 20:
                k8 = [x for x in rows if x['name'] == 'flash_decode_paged_mla'
                      and x['shape']['case'] == 'long'
                      and x['shape']['pool'] == pool][0]
                rows[-1]['ms_per_row_key'] = rows[-1]['ms'] / (h * row_keys)
                rows[-1]['k8_ms_per_row_key'] = k8['ms'] / (
                    h * k8['shape']['live_keys'])
        del cl


# deepseek-v3's absorbed attention at full width: 128 heads, latent rank
# 512 plus a 64-wide rope part, scale 1/sqrt(nope + rope), page size 8
MLA_H, MLA_R, MLA_DR, MLA_PAGE = 128, 512, 64, 8
MLA_SCALE = 1.0 / (128 + 64) ** 0.5


def mla_kernel_phase(torch, kmods):
    """K8 (absorbed MLA paged decode on the latent key split), K9 (its
    chunked prefill, the latent split with a chunk's rows) and K10 (K8 over
    the int8 latent tier) against their plain versions at deepseek-v3's
    full width: H=128, DK = r + d_rope = 576, r=512, page size 8, W=20
    (128 + 32 tokens), and each also at W=512 (a 4,096-token context: K8
    and K10 8 slots within 16 keys of full, K9 one admission's last chunk;
    the plain versions walk 512 pages, so they are timed over 2 calls).
    Tolerance 2e-5, the reference's own for its MLA kernel against the
    absorbed oracle on f32 latents (kernel and plain version both compute
    to f32 accuracy, bf16 pools included: the latent split splits every
    f32 operand into three bf16 parts on the tensor cores);
    K9 on the rows below its limit, every row finite; K10 with a hot
    window covering the table bit-equal to K8 over poisoned int8 pools.
    Bounds: the larger of the latent rows each slot's live pages hold
    (from their tier, plus a scale per cold page), q in and the f32 latent
    out over 3.35 TB/s, and 2*H*(DK + r) flops a visible key and row over
    the bf16 tensor rate."""
    import ctypes

    from repro_torch.runtime import kv_quant as kvq

    fd, build = kmods[0], kmods[3]
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    h, r, dr, ps, w = MLA_H, MLA_R, MLA_DR, MLA_PAGE, 20
    dk = r + dr
    # resident blocks per SM: the latent split (one kernel serves K8 and
    # K10) at the serving plan's staged pages, its chunk instance (K9) at
    # C=8's
    occupancy = {}
    fn = build.function('flash_decode', 'flash_mla_occupancy',
                        [build.I] * 6 + [build.P, build.P])
    for kernel, b, rows_arg in ((8, 8, h), (9, 1, 8 * h)):
        for bf16 in (1, 0):
            plan = fd.latent_split_plan(b, w, ps, rows_arg, dk, r,
                                        2 if bf16 else 4)
            n_stage = plan['tiles_per_split'] * plan['tile'] // ps
            blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
            build.check(fn(kernel, fd.LATENT_ROWS, dk, r, bf16, n_stage,
                           ctypes.byref(blocks), ctypes.byref(smem)),
                        'flash_decode', 'flash_mla_occupancy')
            occupancy[f'{"K8/K10" if kernel == 8 else "K9"} '
                      f'{"bf16" if bf16 else "f32"}'] = dict(
                blocks_per_sm=blocks.value, smem_bytes=smem.value)
    print(f'MLA kernels, resident blocks per SM: {json.dumps(occupancy)}',
          flush=True)

    # K8 and K10: B=8 slots at positions 96..159 (prompts of 128 and their
    # generation) and one idle slot at pos 0 against the garbage page; no
    # window (MLA never windows)
    b = 8
    n_pages = 1 + b * w
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    pos = torch.randint(96, w * ps, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = 0
    bt[0] = 0
    pos[2] = w * ps - 1
    win = torch.full((b,), w * ps + 1, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, dk), generator=gen, device=dev)
    check(len(kvq.cold_page_list(bt.cpu(), pos.cpu().tolist(), ps, 2)) >= 60,
          'K10 serving case has too few cold pages')
    mla_decode_rows(torch, fd, rows, gen, q, pos, win, bt, 2, 'serving')

    # K9 (on the latent split: two device kernels a launch): one
    # admission, limit 128: C=8 at offsets 96 and 120 (the first and last
    # page-size chunk of a prefix hit's suffix), C=32 at offset 96 (the
    # suffix at --chunk-prefill 32; C*H = 1024 and 4096 rows) and an
    # unaligned C=7 whose last 3 positions (384 rows) are padding
    k9_rows(torch, fd, rows, gen, w, 128,
            ((8, 96), (8, 120), (32, 96), (7, 124)))
    # K8 and K10 at a 4,096-token context: W=512, 8 slots within 16 keys of
    # full (its own generator: the serving rows above keep their inputs)
    gen = torch.Generator(device=dev).manual_seed(6)
    b, w = 8, 512
    bt = (torch.randperm(b * w, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    pos = w * ps - 1 - torch.randint(0, 16, (b,), generator=gen, device=dev,
                                     dtype=torch.int32)
    win = torch.full((b,), w * ps + 1, dtype=torch.int32, device=dev)
    q = torch.randn((b, 1, h, dk), generator=gen, device=dev)
    mla_decode_rows(torch, fd, rows, gen, q, pos, win, bt, 2, 'long',
                    plain_iters=2)
    # K9 at a 4,096-token context: W=512, limit 4096, C=32 at offset 4064
    # and C=8 at 4088 (the plain version over 2 calls), beside K8's time a
    # (query row x visible key) at W=512 on the same pool dtype
    k9_rows(torch, fd, rows, torch.Generator(device=dev).manual_seed(7),
            512, 4096, ((32, 4064), (8, 4088)))
    for row in rows:
        row['occupancy'] = occupancy
    return rows




# ----------------------------------------------------------------------------
# phase 2, last: a poisoned page and a NaN row against the plain versions
# ----------------------------------------------------------------------------
def _nan_case(torch, out, name, case, pool, got, want, tol):
    """One NaN case: the query rows (every axis but the last) that the
    kernel and its plain version leave non-finite, and the kernel's largest
    error on the rows the plain version keeps finite."""
    bad = (~torch.isfinite(got)).any(dim=-1)
    bad_p = (~torch.isfinite(want)).any(dim=-1)
    fin = ~bad_p
    err = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    out.append(dict(kernel=name, case=case, pool=pool, rows=bad.numel(),
                    plain_nonfinite_rows=int(bad_p.sum()),
                    kernel_nonfinite_rows=int(bad.sum()),
                    same_rows=bool(torch.equal(bad, bad_p)),
                    max_abs_err_finite_rows=err, tol=tol))


def _same_floats(torch, a, b) -> bool:
    """Bit-equal floats, where a NaN equals a NaN (of any payload)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(a[~na], b[~nb]))


def _nan_case_ok(c) -> bool:
    """The gate of one NaN case. A NaN in visible keys: non-finite on
    exactly the plain version's rows (some, not all), the usual tolerance
    on the others. A NaN in masked rows only: the kernel never reads them
    and stays finite where the plain version (and the reference, whose
    p @ v multiplies them by 0) goes NaN, and it equals the plain version
    run with those rows zeroed."""
    if c.get('masked_only'):
        return (c['kernel_nonfinite_rows'] == 0
                and c['plain_nonfinite_rows'] > 0
                and c['max_abs_err_masked_zeroed'] <= c['tol'])
    return (c['same_rows'] and 0 < c['plain_nonfinite_rows'] < c['rows']
            and c['max_abs_err_finite_rows'] <= c['tol'])


def _masked_nan_case(torch, out, name, pool, kernel, plain, pools, tol):
    """A NaN in masked rows only: ``pools`` hold it, ``kernel()`` and
    ``plain()`` read them; then the plain version again on the pools with
    the NaN rows zeroed, the row the kernel should give."""
    got, want = kernel(), plain()
    for t in pools:
        t.nan_to_num_(nan=0.0)
    ref = plain()
    out.append(dict(kernel=name, case='NaN in masked rows only', pool=pool,
                    rows=got[..., 0].numel(), masked_only=True,
                    plain_nonfinite_rows=int(
                        (~torch.isfinite(want)).any(dim=-1).sum()),
                    kernel_nonfinite_rows=int(
                        (~torch.isfinite(got)).any(dim=-1).sum()),
                    max_abs_err_masked_zeroed=float(
                        (got - ref).abs().max()), tol=tol))


def nan_kernel_phase(torch, kmods, dev='cuda', k3=()):
    """Every paged attention kernel on NaN inputs, against its plain
    version: a NaN page (the chaos layer's poisoned page, NaN in every row
    of both fp pools) placed twice, alone in its key split (the split's
    only live keys) and among finite keys of a split, on bf16 and f32
    pools: K1 and K6 at the serving shape (hot window 2, both NaN pages
    hot), K5 with C=8 at the split's start and after a NaN page of the
    prefix, K8 and K10 at deepseek-v3's serving shape, K9 as K5. The gate:
    the kernel leaves non-finite exactly the rows the plain version does
    (the NaN pages' requests), and holds the others to the kernel's usual
    tolerance (1e-5 GQA, 2e-5 MLA). Then K1 and K8 with a NaN only in the
    rows past one request's position, which no query sees: there the
    kernels stay finite and the plain versions go NaN, as the reference
    does (:func:`_nan_case_ok`); the chaos serves' quarantines follow the
    kernels (:func:`_poison_reads`). Positions come from each kernel's own
    split plan; no window, so a row sees every live key of its pages.
    ``k3``: K3's NaN-row reports from :func:`kernel_phase` (its crafted
    rows, gated there), reported here beside the rest. Every case is run
    and reported before the gate fails."""
    from repro_torch.runtime import kv_quant as kvq

    fd = kmods[0]
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    out = list(k3)
    nan = float('nan')
    masked_pos = 100               # slot 3: rows 5..7 of its page past it

    def split_keys(plan):
        return plan['tile'] * plan['tiles_per_split']

    # K1 and K6: B=8, Hkv=32, G=1, dh=64, page size 8, W=20; slot 1 sits 2
    # keys into the last split, its page there NaN (alone in the split);
    # slot 2 is 3 keys short of the table's end, the page before its last
    # NaN (among finite keys of its split); slot 0 idle
    b, hkv, g, dh, ps, w, hw = 8, 32, 1, 64, 8, 20, 2
    n_pages = 1 + b * w
    scale = 1.0 / dh ** 0.5
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1) \
        .reshape(b, w).to(torch.int32).contiguous()
    pos = torch.randint(96, w * ps, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = 0
    bt[0] = 0
    win = torch.full((b,), w * ps + 1, dtype=torch.int32, device=dev)
    q = torch.randn((b, hkv, g, dh), generator=gen, device=dev)
    hwt = torch.tensor([hw], dtype=torch.int32, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        sk = split_keys(fd.paged_split_plan(b, w, ps, hkv, g, dh,
                                            torch.finfo(dt).bits // 8))
        last = (w * ps - 1) // sk * sk
        pos[1], pos[2] = last + 2, w * ps - 3
        nan_pages = [int(bt[1, last // ps]), int(bt[2, (w * ps - 3) // ps
                                                      - 1])]
        c = tiered_pools(torch, gen, q, bt, pos, n_pages, ps, hw, dt)
        for page in nan_pages:
            c['k'][page] = nan
            c['v'][page] = nan
        pool = str(dt).replace('torch.', '')
        args = (q, c['k'], c['v'], pos, win, bt)
        _nan_case(torch, out, 'K1', 'pages alone and among finite keys',
                  pool, fd.flash_decode_gqa_paged(*args, scale=scale),
                  fd.flash_decode_gqa_paged_plain(*args, scale=scale), 1e-5)
        qargs = (q, c['k'], c['v'], c['kq'], c['vq'], c['ks'], c['vs'], pos,
                 win, bt, hwt)
        _nan_case(torch, out, 'K6', 'pages alone and among finite keys, '
                  'hot', pool, fd.flash_decode_gqa_paged_q8(*qargs,
                                                            scale=scale),
                  fd.flash_decode_gqa_paged_q8_plain(*qargs, scale=scale),
                  1e-5)
        del c
        kp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        vp = torch.randn((n_pages, ps, hkv, dh), generator=gen,
                         device=dev).to(dt)
        pos[3] = masked_pos
        page = int(bt[3, masked_pos // ps])
        kp[page, masked_pos % ps + 1:] = nan
        vp[page, masked_pos % ps + 1:] = nan
        args = (q, kp, vp, pos, win, bt)
        _masked_nan_case(
            torch, out, 'K1', pool,
            lambda: fd.flash_decode_gqa_paged(*args, scale=scale),
            lambda: fd.flash_decode_gqa_paged_plain(*args, scale=scale),
            (kp, vp), 1e-5)
        del kp, vp

    # K5: two requests, C=8 at the start of the split holding position 96
    # (the first request's page there NaN: the split's only live keys),
    # and C=8 at offset 96 after a NaN page of its prefix (block 3); the
    # second request's pages finite
    for dt in (torch.bfloat16, torch.float32):
        bt1 = (torch.randperm(2 * w, generator=gen, device=dev) + 1) \
            .reshape(2, w).to(torch.int32).contiguous()
        sk = split_keys(fd.chunk_split_plan(2, w, ps, hkv, 8, g, dh,
                                            torch.finfo(dt).bits // 8))
        pool = str(dt).replace('torch.', '')
        for case, off, blk in (('page alone in its split', 96 // sk * sk,
                                96 // sk * sk // ps),
                               ('prefix page among finite keys', 96, 3)):
            kp = torch.randn((1 + 2 * w, ps, hkv, dh), generator=gen,
                             device=dev).to(dt)
            vp = torch.randn((1 + 2 * w, ps, hkv, dh), generator=gen,
                             device=dev).to(dt)
            kp[int(bt1[0, blk])] = nan
            vp[int(bt1[0, blk])] = nan
            qc = torch.randn((2, hkv, 8 * g, dh), generator=gen, device=dev)
            offv, posv, winv = fd._chunk_scalars(off, 128, None, 2, 8,
                                                 w * ps, dev)
            args = (qc, kp, vp, posv, winv, bt1, offv)
            _nan_case(torch, out, 'K5', case, pool,
                      fd.flash_decode_gqa_paged(*args, scale=scale, chunk=8),
                      fd.flash_decode_gqa_paged_plain(*args, scale=scale,
                                                      chunk=8), 1e-5)

    # K8 and K10 at deepseek-v3's serving shape (H=128, DK=576, r=512),
    # the NaN pages placed as K1's by the latent split's plan; K9 as K5
    h, r = MLA_H, MLA_R
    dk = r + MLA_DR
    ql = torch.randn((b, 1, h, dk), generator=gen, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        elt = torch.finfo(dt).bits // 8
        sk = split_keys(fd.latent_split_plan(b, w, ps, h, dk, r, elt))
        last = (w * ps - 1) // sk * sk
        pos[1], pos[2] = last + 2, w * ps - 3
        cl = torch.randn((n_pages, ps, dk), generator=gen,
                         device=dev).to(dt)
        c = dict(cl=cl, clq=torch.zeros((n_pages, ps, dk), dtype=torch.int8,
                                        device=dev),
                 cs=torch.zeros((n_pages, 1), device=dev))
        cold = kvq.cold_page_list(bt.cpu(), pos.cpu().tolist(), ps, hw)
        kvq.quantize_latent_pages_layer(c, torch.tensor(cold, device=dev))
        cl[int(bt[1, last // ps])] = nan
        cl[int(bt[2, (w * ps - 3) // ps - 1])] = nan
        pool = str(dt).replace('torch.', '')
        args = (ql, cl, pos, win, bt)
        _nan_case(torch, out, 'K8', 'pages alone and among finite keys',
                  pool, fd.flash_decode_mla_paged(*args, scale=MLA_SCALE,
                                                  r=r),
                  fd.flash_decode_mla_paged_plain(*args, scale=MLA_SCALE,
                                                  r=r), 2e-5)
        qargs = (ql, cl, c['clq'], c['cs'], pos, win, bt, hwt)
        _nan_case(torch, out, 'K10', 'pages alone and among finite keys, '
                  'hot', pool,
                  fd.flash_decode_mla_paged_q8(*qargs, scale=MLA_SCALE, r=r),
                  fd.flash_decode_mla_paged_q8_plain(*qargs,
                                                     scale=MLA_SCALE, r=r),
                  2e-5)
        del c, cl
        cl = torch.randn((n_pages, ps, dk), generator=gen,
                         device=dev).to(dt)
        pos[3] = masked_pos
        cl[int(bt[3, masked_pos // ps]), masked_pos % ps + 1:] = nan
        args = (ql, cl, pos, win, bt)
        _masked_nan_case(
            torch, out, 'K8', pool,
            lambda: fd.flash_decode_mla_paged(*args, scale=MLA_SCALE, r=r),
            lambda: fd.flash_decode_mla_paged_plain(*args, scale=MLA_SCALE,
                                                    r=r),
            (cl,), 2e-5)
        del cl
        bt1 = (torch.randperm(2 * w, generator=gen, device=dev) + 1) \
            .reshape(2, w).to(torch.int32).contiguous()
        sk = split_keys(fd.latent_split_plan(2, w, ps, 8 * h, dk, r, elt))
        for case, off, blk in (('page alone in its split', 96 // sk * sk,
                                96 // sk * sk // ps),
                               ('prefix page among finite keys', 96, 3)):
            cl1 = torch.randn((1 + 2 * w, ps, dk), generator=gen,
                              device=dev).to(dt)
            cl1[int(bt1[0, blk])] = nan
            qc = torch.randn((2, 1, 8 * h, dk), generator=gen, device=dev)
            offv, posv, winv = fd._chunk_scalars(off, 128, None, 2, 8,
                                                 w * ps, dev)
            args = (qc, cl1, posv, winv, bt1, offv)
            _nan_case(torch, out, 'K9', case, pool,
                      fd.flash_decode_mla_paged(*args, scale=MLA_SCALE, r=r,
                                                chunk=8),
                      fd.flash_decode_mla_paged_plain(*args, scale=MLA_SCALE,
                                                      r=r, chunk=8), 2e-5)

    if dev.type == 'cuda':
        torch.cuda.synchronize()
    print(json.dumps(dict(nan=out)), flush=True)
    bad = [c for c in out if not _nan_case_ok(c)]
    check(not bad, f'NaN inputs: {len(bad)} of {len(out)} cases differ from '
                   f'the plain versions: {json.dumps(bad)}')
    return out

# ----------------------------------------------------------------------------
# phase 3: GPU path vs the CPU plain path, smoke config, f32
# ----------------------------------------------------------------------------
# GPU-vs-CPU logits tolerance of the smoke parity runs, every forward: f32
# end to end the two paths differ by reduction order only. Some f32
# results (rmsnorm, the absorb and W_uv einsums) end a few ulps apart on
# the two devices, and a value that close to an int8 rounding boundary
# takes the neighbouring code on one side (K3 in w8a8, the tier's page
# quantize); left alone, one such code moved the dense prefix's logits by
# 0.0444 (dynamic w8a8) or 7.9e-4 (latent tier at hot window 1) on an
# H100. So the card runs first and records every int8 code it
# quantizes; the CPU run then takes the card's codes wherever its own are
# at most rounding-boundary flips of them (one code step, in at most
# max(4, 1%) of a call's codes; anything else fails), and every forward is
# held to 1e-4 on equal codes. K3, K4 and the page quantize are exact on
# equal inputs (phase 2).
SMOKE_TOL = 1e-4


def _match_codes(mine, card, forward, flips):
    """The card's int8 codes ``card`` for a quantization whose codes here
    are ``mine``, once they differ by rounding-boundary flips only: one
    code step, in at most max(4, 1%) of the codes. Each flip is recorded
    in ``flips``."""
    check(mine.shape == card.shape, f'int8 codes {tuple(mine.shape)} on the '
                                    f'CPU, {tuple(card.shape)} on the card')
    step = (mine.short() - card.short()).abs()
    n = int((step > 0).sum())
    if n:
        flip = dict(forward=forward, codes=n, of=step.numel(),
                    max_step=int(step.max()))
        check(flip['max_step'] == 1 and n <= max(4, step.numel() // 100),
              f'int8 codes differ beyond rounding-boundary flips: {flip}')
        flips.append(flip)
    return card


class _K3Codes:
    """While active, records the int8 codes of every K3 call, each tagged
    with the forward that made it (``forward``, set by the caller). Given
    the card run's record as ``follow``, each call returns the card's codes
    instead, through :func:`_match_codes`."""

    def __init__(self, follow=None):
        self.forward, self.codes, self.flips = 0, [], []
        self._follow = follow

    def __enter__(self):
        from repro_torch.kernels import quantize as kq
        self._kq, self._orig = kq, kq.quantize_rows

        def recorded(x):
            q, s = self._orig(x)
            if self._follow is not None:
                check(len(self.codes) < len(self._follow),
                      'more K3 calls on the CPU than on the card')
                fwd, card = self._follow[len(self.codes)]
                check(fwd == self.forward, f'K3 call {len(self.codes)} in '
                      f'forward {self.forward} here, {fwd} on the card')
                q = _match_codes(q, card.to(q.device), fwd, self.flips)
            self.codes.append((self.forward, q.cpu()))
            return q, s
        kq.quantize_rows = recorded
        return self

    def __exit__(self, *exc):
        self._kq.quantize_rows = self._orig


class _AnalogDraws:
    """While active, records every ``analog_sim`` linear's draws
    (``yoco_linear.analog_normals``) and TDC codes
    (``yoco_linear.tdc_quantize``), each tagged with the forward that made
    it (``forward``, set by the caller). Given the card run's record as
    ``follow``, each call takes the card's draws instead (a CPU generator
    draws another stream than the card's), and returns the card's TDC codes
    through :func:`_match_codes`, as :class:`_K3Codes` does K3's (unless
    ``follow_codes`` is False: a train step is held to bounds instead)."""

    def __init__(self, follow=None, follow_codes=True):
        self.forward, self.draws, self.codes, self.flips = 0, [], [], []
        self._follow = follow
        self._follow_codes = follow_codes

    def __enter__(self):
        from repro_torch.core import yoco_linear as yl
        self._yl = yl
        self._orig = yl.analog_normals, yl.tdc_quantize

        def normals(seed, word, shape, need_gain, device):
            if self._follow is None:
                n1, n2 = self._orig[0](seed, word, shape, need_gain, device)
                self.draws.append((self.forward, word, n1.cpu(),
                                   None if n2 is None else n2.cpu()))
                return n1, n2
            check(len(self.draws) < len(self._follow.draws),
                  'more analog draws on the CPU than on the card')
            fwd, card_word, n1, n2 = self._follow.draws[len(self.draws)]
            check(fwd == self.forward and card_word == word
                  and tuple(n1.shape) == tuple(shape),
                  f'analog draw {len(self.draws)}: forward {self.forward}, '
                  f'word {word} here, {fwd}, {card_word} on the card')
            self.draws.append((fwd, word, n1, n2))
            return n1.to(device), None if n2 is None else n2.to(device)

        def tdc(y, bits):
            q, scale = self._orig[1](y, bits)
            if self._follow is not None and self._follow_codes:
                fwd, card = self._follow.codes[len(self.codes)]
                q = _match_codes(q, card.to(q.device), fwd, self.flips)
            self.codes.append((self.forward, q.cpu()))
            return q, scale
        yl.analog_normals, yl.tdc_quantize = normals, tdc
        return self

    def __exit__(self, *exc):
        self._yl.analog_normals, self._yl.tdc_quantize = self._orig


def _hold_smoke(tag, cpu, gpu):
    """Hold every forward of a smoke run to SMOKE_TOL and the greedy tokens
    to equality; returns the report row's numbers. ``cpu``, ``gpu``:
    (logits by forward, tokens, codes, code flips)."""
    import torch
    per = _per_step(cpu[0], gpu[0])
    check(len(cpu[2]) == len(gpu[2]),
          f'{tag}: {len(cpu[2])} int8 quantizations on the CPU, '
          f'{len(gpu[2])} on the card')
    check(max(per) <= SMOKE_TOL, f'{tag}: GPU vs CPU logits differ by '
                                 f'{max(per)} > {SMOKE_TOL}')
    check(bool(torch.equal(cpu[1], gpu[1])), f'{tag}: greedy tokens differ')
    return dict(max_abs_logit_err=max(per), tol=SMOKE_TOL,
                code_flips=cpu[3], per_step=per)


# the paper-fidelity modes the smoke phase adds on stablelm and the MLA
# prefix (which serves no --prequantize)
FIDELITY_SMOKE_MODES = (('qat', False), ('analog_sim', False),
                        ('analog_sim', True))
MLA_SMOKE_MODES = (('bf16', False), ('w8a8', False), ('qat', False),
                   ('analog_sim', False))


def smoke_phase(torch, arch=ARCH, modes=(('bf16', False), ('w8a8', True),
                                          ('w8a8', False))):
    from repro_torch import configs
    from repro_torch.core import yoco_linear
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.models import model as M
    from repro_torch.runtime import kv_cache as kvc
    from repro_torch.runtime import layouts

    cfg = configs.get(arch, smoke=True)
    f32 = torch.float32
    base = M.init_params(torch.Generator().manual_seed(0), cfg, device='cpu')
    b, plen, steps, ps = 4, 12, 8, 4
    max_blocks = -(-(plen + steps) // ps)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen)
    results = []
    for mode, prequant in modes:
        yoco = YocoConfig(mode=mode, compute_dtype=f32)
        rt = M.ModelRuntime(attn_impl='flash', compute_dtype=f32)
        # the trees serve() loads: int8 in situ, or the dynamic modes'
        # K-major float weights (K4 refuses any other layout on the card)
        host = (yoco_linear.quantize_tree(base) if prequant
                else M.k_major_linear_weights(base) if mode != 'bf16'
                else base)
        runs = {}
        for dev in ('cuda', 'cpu'):     # the CPU run follows the card's codes
            params = _to(host, dev)
            kv = kvc.PagedKVCache(1 + b * max_blocks, ps, max_blocks, b)
            cache = M.init_paged_cache_tree(
                cfg, b, num_pages=1 + b * max_blocks, page_size=ps,
                max_blocks=max_blocks, dtype=f32, device=dev)
            for s in range(b):
                kv.alloc_blocks(s, max_blocks)
            cache = layouts.with_block_tables(cache, kv.tables)
            follow = runs['cuda'][2] if dev == 'cpu' else None
            analog = runs['cuda'][4] if dev == 'cpu' else None
            with _K3Codes(follow) as k3, _AnalogDraws(analog) as an:
                logits, cache = M.prefill(params,
                                          dict(inputs=prompts.to(dev)),
                                          cache, cfg, yoco, rt)
                rows, toks = [logits.cpu()], []
                tok = torch.argmax(logits, -1)
                for i in range(steps):
                    k3.forward = an.forward = i + 1
                    toks.append(tok.cpu())
                    pos = torch.full((b,), plen + i, dtype=torch.int32,
                                     device=dev)
                    logits, cache = M.decode_step(params, tok, pos, cache,
                                                  cfg, yoco, rt)
                    rows.append(logits.cpu())
                    tok = torch.argmax(logits, -1)
            runs[dev] = (torch.stack(rows), torch.stack(toks), k3.codes,
                         k3.flips + an.flips, an)
        check(mode != 'analog_sim' or len(runs['cpu'][4].draws)
              == len(runs['cuda'][4].draws) > 0,
              f'smoke {arch} {mode}: the CPU run took '
              f'{len(runs["cpu"][4].draws)} of the card\'s '
              f'{len(runs["cuda"][4].draws)} analog draws')
        results.append(dict(arch=arch, mode=mode, prequantize=prequant,
                            **_hold_smoke(f'smoke {arch} {mode} prequant='
                                          f'{prequant}', runs['cpu'],
                                          runs['cuda'])))
    return results


def smoke_tier_prefix_phase(torch, arch=ARCH, paths=('tier', 'prefix')):
    """The slice-2 paths on ``arch``'s smoke config in f32, GPU against CPU:
    decode over the int8 tier with hot window 1 (K6; aged-out pages
    quantized before each step), and a prefix hit whose unshared suffix is
    prefilled in chunks (K5) and then decoded beside its donor (K1); K10,
    K9 and K8 on an MLA config. ``paths`` picks them (a hybrid serves no
    prefix cache: its tier only)."""
    from repro_torch import configs
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.models import model as M
    from repro_torch.runtime import kv_cache as kvc
    from repro_torch.runtime import kv_quant as kvq
    from repro_torch.runtime import layouts

    cfg = configs.get(arch, smoke=True)
    f32 = torch.float32
    base = M.init_params(torch.Generator().manual_seed(0), cfg, device='cpu')
    yoco = YocoConfig(mode='bf16', compute_dtype=f32)
    rt = M.ModelRuntime(attn_impl='flash', compute_dtype=f32)
    gen = torch.Generator().manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (4, 12), generator=gen)
    suffix = torch.randint(0, cfg.vocab_size, (5,), generator=gen)

    def tier_run(dev, follow=None):
        b, plen, steps, ps = 4, 12, 8, 4
        w = -(-(plen + steps) // ps)
        params = _to(base, dev)
        kv = kvc.PagedKVCache(1 + b * w, ps, w, b)
        for s in range(b):
            kv.alloc_blocks(s, w)
        cache = M.init_paged_cache_tree(cfg, b, num_pages=1 + b * w,
                                        page_size=ps, max_blocks=w,
                                        dtype=f32, kv_dtype='int8',
                                        hot_window=1, device=dev)
        cache = layouts.with_block_tables(cache, kv.tables)
        tier = kvq.KVTierTracker(1, ps)
        logits, cache = M.prefill(params, dict(inputs=prompts.to(dev)),
                                  cache, cfg, yoco, rt)
        rows, toks, quantized, codes, flips = [logits.cpu()], [], 0, [], []
        tok = torch.argmax(logits, -1)
        for i in range(steps):
            toks.append(tok.cpu())
            pages = [p for s in range(b)
                     for p in tier.aged_out(s, plen + i, kv.tables[s])]
            if pages:
                quantized += len(pages)
                idx = torch.tensor(pages, device=dev)
                cache = kvq.quantize_tree_pages(cache, idx)
                # the codes just written, first read by forward i + 1;
                # int8 leaves are stacked (L, P, ...); a hybrid's are its
                # attention sites'
                pools = cache['attn'] if cfg.hybrid_group \
                    else cache['layers']
                for _, leaf in sorted(pools.items()):
                    if leaf.dtype != torch.int8:
                        continue
                    if follow is not None:
                        check(len(codes) < len(follow)
                              and follow[len(codes)][0] == i + 1,
                              'the tier quantizes otherwise on the CPU')
                        leaf[:, idx] = _match_codes(
                            leaf[:, idx], follow[len(codes)][1].to(dev),
                            i + 1, flips)
                    codes.append((i + 1, leaf[:, idx].cpu()))
            pos = torch.full((b,), plen + i, dtype=torch.int32, device=dev)
            logits, cache = M.decode_step(params, tok, pos, cache, cfg,
                                          yoco, rt)
            rows.append(logits.cpu())
            tok = torch.argmax(logits, -1)
        check(quantized > 0, 'smoke tier run quantized no page')
        return torch.stack(rows), torch.stack(toks), codes, flips

    def prefix_run(dev, follow=None):
        del follow                      # no int8 tier: nothing quantized
        ps, w, steps, c = 4, 5, 6, 4
        params = _to(base, dev)
        donor = prompts[0].numpy()
        hit = np.concatenate([donor[:8], suffix.numpy()])
        kv = kvc.PagedKVCache(1 + 2 * w, ps, w, 2, prefix_cache=True)
        cache = M.init_paged_cache_tree(cfg, 2, num_pages=1 + 2 * w,
                                        page_size=ps, max_blocks=w,
                                        dtype=f32, device=dev)
        check(not kv.admit_prompt(0, donor)['hit'], 'smoke donor hit')
        part = layouts.with_block_tables(cache, kv.tables[0:1])
        logits, _ = M.prefill(params, dict(inputs=prompts[:1].to(dev)), part,
                              cfg, yoco, rt)
        kv.seal_slot(0, donor)
        rows = [logits.cpu()]
        plan = kv.admit_prompt(1, hit)
        check(plan['hit'] and plan['shared'] == 2
              and plan['prefill_start'] == 8, f'smoke prefix plan {plan}')
        part = layouts.with_block_tables(cache, kv.tables[1:2])
        lim = torch.tensor([len(hit)], dtype=torch.int32, device=dev)
        for off in range(plan['prefill_start'], len(hit), c):
            ck = np.zeros((1, c), np.int64)
            ck[0, :len(hit[off:off + c])] = hit[off:off + c]
            logits, _ = M.prefill_chunk(
                params, dict(inputs=torch.from_numpy(ck).to(dev)),
                torch.tensor([off], dtype=torch.int32, device=dev), lim,
                part, cfg, yoco, rt)
        rows.append(logits.cpu())
        tok = torch.cat([torch.argmax(r, -1) for r in rows]).to(dev)
        pos = np.array([len(donor), len(hit)])
        toks = []
        for i in range(steps):
            toks.append(tok.cpu())
            for s in range(2):
                check(kv.ensure(s, int(pos[s]) + i), 'smoke pool dry')
            cache = layouts.with_block_tables(cache, kv.tables)
            logits, cache = M.decode_step(
                params, tok, torch.from_numpy(pos + i).to(torch.int32)
                .to(dev), cache, cfg, yoco, rt)
            rows.append(logits.cpu())
            tok = torch.argmax(logits, -1)
        return torch.cat(rows), torch.stack(toks), [], []

    results = []
    for name, fn in (('kv_quant hot_window=1', tier_run),
                     ('prefix hit, chunked prefill C=4', prefix_run)):
        if (fn is tier_run and 'tier' not in paths) or \
                (fn is prefix_run and 'prefix' not in paths):
            continue
        gpu = fn('cuda')
        cpu = fn('cpu', gpu[2])         # the CPU run follows the card's codes
        results.append(dict(arch=arch, mode='bf16', path=name,
                            **_hold_smoke(f'smoke {arch} {name}', cpu, gpu)))
    return results


def smoke_static_phase(torch, arch=ARCH, modes=(('bf16', False),
                                                 ('w8a8', True))):
    """The static ``serve()`` on ``arch``'s smoke config in f32, GPU
    against CPU: lock-step and ``--ragged``, ``attn_impl='flash'`` (K7 on
    the card), in each of ``modes``; every forward's logits (from
    ``step_hook``) and the tokens held by :func:`_hold_smoke`. Prompts of
    the config's input kind: token ids, codebook grids (musicgen) or f32
    embeddings (qwen2-vl)."""
    from repro_torch import configs
    from repro_torch.core import yoco_linear
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M

    cfg = configs.get(arch, smoke=True)
    base = M.init_params(torch.Generator().manual_seed(0), cfg, device='cpu')
    b, plen, gen_len = 4, 12, 8
    rng = np.random.RandomState(3)
    shape = SV._prompt_shape(cfg, b, plen)
    prompts = (rng.randn(*shape).astype(np.float32)
               if cfg.input_kind == 'embeddings'
               else rng.randint(0, cfg.vocab_size, shape).astype(np.int32))
    results = []
    for ragged in (False, True):
        for mode, prequant in modes:
            host = yoco_linear.quantize_tree(base) if prequant else base
            runs = {}
            for dev in ('cuda', 'cpu'):   # the CPU run follows the card's
                follow = runs['cuda'][2] if dev == 'cpu' else None
                rows = []
                with _K3Codes(follow) as k3:
                    def hook(logits, tok, rows=rows, k3=k3):
                        rows.append(logits.cpu())
                        k3.forward += 1
                    out = SV.serve(arch, batch=b, prompt_len=plen,
                                   gen_len=gen_len, mode=mode,
                                   prequantize=prequant, attn_impl='flash',
                                   ragged=ragged, quiet=True, device=dev,
                                   compute_dtype=torch.float32,
                                   params=_to(host, dev), prompts=prompts,
                                   step_hook=hook)
                runs[dev] = (torch.stack(rows),
                             torch.from_numpy(out['tokens']), k3.codes,
                             k3.flips)
            tag = (f'smoke static serve {arch} {mode} prequant={prequant} '
                   f'ragged={ragged}')
            results.append(dict(arch=arch, mode=mode, prequantize=prequant,
                                path=f'static serve flash ragged={ragged}',
                                **_hold_smoke(tag, runs['cpu'],
                                              runs['cuda'])))
    return results


def _per_step(a, b):
    """Largest |a - b| of each forward's logits (leading axis)."""
    return [float(x) for x in (a - b).abs().flatten(1).amax(dim=1)]


def _to(tree, dev):
    from repro_torch.core.yoco_linear import QuantizedWeight
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(tree.wq.to(dev), tree.scale.to(dev))
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ----------------------------------------------------------------------------
# phase 5: the main path at full width
# ----------------------------------------------------------------------------
TIER = dict(kv_quant=True, hot_window=2)
SERVE_RUNS = (
    # mode, prequantize, slots, requests, num_pages (None: full lanes),
    # stream, serve_continuous options. Streams: 'ragged' = the serve
    # path's synthetic 64-128-token prompts; 'full' = 128-token prompts;
    # 'shared' = 128-token prompts that open with one 96-token system
    # prompt (what chat users send on every request)
    ('bf16', False, 8, 16, None, 'ragged', {}),
    ('w8a8', True, 8, 16, None, 'ragged', {}),
    ('w8a8', False, 8, 8, None, 'ragged', {}),
    # full-length prompts: 3 lanes of 16 pages fill the 48-page pool and
    # all must grow past position 128, so the youngest is preempted (and
    # waits for a lane to finish instead of cycling through readmission)
    ('bf16', False, 4, 8, 1 + 48, 'full', {}),
    ('bf16', False, 8, 16, None, 'ragged', TIER),
    ('w8a8', True, 8, 16, None, 'ragged', TIER),
    # the private baseline of the two prefix-cache runs after it
    ('bf16', False, 8, 16, None, 'shared', {}),
    ('bf16', False, 8, 16, None, 'shared',
     dict(prefix_cache=True, chunk_prefill=32)),
    ('bf16', False, 8, 16, None, 'shared', dict(prefix_cache=True, **TIER)),
)
# deepseek-v3's dense prefix (MLA_ARCH): bf16 and dynamic w8a8 only (the
# port refuses --prequantize on MLA, where the reference fails)
MLA_SERVE_RUNS = (
    ('bf16', False, 8, 16, None, 'ragged', {}),
    ('w8a8', False, 8, 8, None, 'ragged', {}),
    ('bf16', False, 8, 16, None, 'ragged', TIER),
    ('bf16', False, 8, 16, None, 'shared', {}),
    ('bf16', False, 8, 16, None, 'shared',
     dict(prefix_cache=True, chunk_prefill=32)),
    ('bf16', False, 8, 16, None, 'shared', dict(prefix_cache=True, **TIER)),
)
SHARED_PREFIX = 96
# the static serve() paths' names in the kernels line
STATIC_PATH = f'{ARCH} static serve()'
MOE_STATIC_PATH = f'{MOE_ARCH} static serve()'


def _stream(SV, cfg, kind, n_req):
    """The request stream of a serve run (None: the serve path's own)."""
    if kind == 'ragged':
        return None
    from repro_torch.data import synthetic
    prompts = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=n_req, seq_len=128), 0)['inputs'].numpy()
    if kind == 'full':
        return [SV.Request(rid=i, prompt=prompts[i], target_gen=32)
                for i in range(n_req)]
    prompts[:, :SHARED_PREFIX] = prompts[0, :SHARED_PREFIX]
    return [SV.Request(rid=i, prompt=prompts[i],
                       target_gen=16 + (i * 3) % 17) for i in range(n_req)]


def _prefill_chunks(out, stream, opts):
    """(chunked-prefill calls, admissions prefilled in chunks) of a run,
    from its admit events: prefix hits (prefill_start > 0) always take
    chunks, misses only with chunk_prefill."""
    if out['chunk_prefill'] is None:
        return 0, 0
    plen = {req.rid: len(req.prompt) for req in stream}
    c = out['chunk_prefill']
    admits = [e for e in out['event_log'] if e['kind'] == 'admit'
              and (opts.get('chunk_prefill') or e['prefill_start'] > 0)]
    return (sum(-(-(plen[e['rid']] - e['prefill_start']) // c)
                for e in admits), len(admits))


def gqa_counts(cfg):
    """(linears, distinct activations) of one forward of a dense GQA
    config: q k v o and the MLP's linears (gate up down, or in and out for
    starcoder2's GELU MLP) a layer, plus the lm_head; q/k/v read one
    activation, a gated MLP's gate and up another, then o's, the MLP
    output's and the lm_head's (4 a layer either way)."""
    mlp = 3 if cfg.mlp_type in ('swiglu', 'geglu') else 2
    return (4 + mlp) * cfg.n_layers + 1, 4 * cfg.n_layers + 1


def _gqa_launches(out, mode, prequant, chunks, chunked_admits, cfg=None):
    """Launches a dense GQA path must make (``cfg``; None: stablelm-1.6b):
    K1 once a layer a decode step (K6 in its place with the tier), K5 once
    a layer a prefill chunk (each launch two device kernels, its splits and
    their combine), and per forward (a decode step, a monolithic prefill
    or a chunk) :func:`gqa_counts`' linears over its distinct activations:
    at stablelm-1.6b's 24 layers 169 over 97, so K3 97 + K2 169 with
    --prequantize, K3 97 + 169 (the weights) + K4 169 dynamic. analog_sim
    launches what w8a8 does (its noise epilogue is plain torch); qat K3 97
    + 169 (activations, then each weight's fake quantization, with or
    without --prequantize) and neither K2 nor K4 (its product is a float
    matmul)."""
    layers, (per_fwd, acts_fwd) = (
        (LAYERS_FULL, (LINEARS_PER_FORWARD, ACTIVATIONS_PER_FORWARD))
        if cfg is None else (cfg.n_layers, gqa_counts(cfg)))
    decode = layers * out['steps']
    want = dict(flash_decode_paged=0 if out['kv_quant'] else decode,
                flash_decode_paged_q8=decode if out['kv_quant'] else 0,
                flash_chunk_paged=layers * chunks)
    forwards = (out['steps'] + out['events']['admit'] - chunked_admits
                + chunks)
    linears = per_fwd * forwards
    activations = acts_fwd * forwards
    if mode in ('w8a8', 'analog_sim') and prequant:
        want.update(quantize_rows=activations, int8_matmul=linears)
    elif mode in ('w8a8', 'analog_sim'):
        want.update(quantize_rows=activations + linears,
                    yoco_vmm_int8=linears)
    elif mode == 'qat':
        want.update(quantize_rows=activations + linears)
    return want


def mla_counts(layers):
    """(linears a decode step or chunk, a monolithic prefill; their
    distinct activations) of an MLA config of ``layers`` layers: w_dq w_uq
    w_dkv wo and the MLP's (or an MoE layer's shared FFN's) gate up down a
    layer, a monolithic prefill's w_ukv too, plus the lm_head."""
    return (7 * layers + 1, 8 * layers + 1, 5 * layers + 1, 6 * layers + 1)


def _mla_launches(out, mode, prequant, chunks, chunked_admits,
                  layers=MLA_LAYERS):
    """Launches an MLA path of ``layers`` layers must make (deepseek-v3's
    dense prefix by default): K8 once a layer a decode step (K10 in its
    place with the tier), K9 once a layer a prefill chunk; in dynamic
    w8a8, :func:`mla_counts`' linears (at 3 layers 22 over 16 distinct
    activations a decode step or chunk, 25 over 19 a monolithic prefill,
    where w_ukv expands the prompt's k/v): K4 a linear, K3 an activation
    and a linear. An MoE layer's router and experts launch none of
    K2-K4."""
    check(not prequant, 'the port serves no --prequantize on MLA')
    dec_lin, pre_lin, dec_act, pre_act = mla_counts(layers)
    decode = layers * out['steps']
    want = dict(flash_decode_paged_mla=0 if out['kv_quant'] else decode,
                flash_decode_paged_mla_q8=decode if out['kv_quant'] else 0,
                flash_chunk_paged_mla=layers * chunks)
    if mode == 'w8a8':
        monolithic = out['events']['admit'] - chunked_admits
        linears = (dec_lin * (out['steps'] + chunks) + pre_lin * monolithic)
        activations = (dec_act * (out['steps'] + chunks)
                       + pre_act * monolithic)
        want.update(quantize_rows=activations + linears,
                    yoco_vmm_int8=linears)
    return want


def serve_phase(torch, build, arch=ARCH, runs=SERVE_RUNS,
                launches_of=_gqa_launches):
    """Serve each of ``runs`` on ``arch`` at full width and hold every
    request, logits row and launch count to the path; returns (rows,
    launch totals)."""
    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M

    cfg = configs.get(arch, smoke=False)
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = M.init_params(gen, cfg, device='cuda')
    totals = {k: 0 for k in build.LAUNCHES}
    results = []
    private_peak = None
    for mode, prequant, slots, n_req, num_pages, kind, opts in runs:
        # warm-up (library handles, allocator) outside the measured run
        SV.serve_continuous(arch, smoke=False, slots=slots, n_requests=1,
                            prompt_len=128, gen_len=2, mode=mode,
                            prequantize=prequant, params=params, quiet=True,
                            **opts)
        torch.cuda.synchronize()
        stream = _stream(SV, cfg, kind, n_req)
        build.reset_counts()
        out = SV.serve_continuous(arch, smoke=False, slots=slots,
                                  n_requests=n_req, prompt_len=128,
                                  gen_len=32, page_size=8,
                                  num_pages=num_pages, mode=mode,
                                  prequantize=prequant, attn_impl='flash',
                                  params=params, request_stream=stream,
                                  quiet=True, **opts)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        tag = (f'serve {arch} {mode} prequant={prequant} pages={num_pages} '
               f'stream={kind} {opts}')
        check(out['completed'] == n_req and out['failed'] == 0
              and out['rejected'] == 0 and out['cancelled'] == 0,
              f'{tag}: not every request finished: {out["events"]}')
        check(out['quarantined'] == 0,
              f'{tag}: {out["quarantined"]} lanes had non-finite logits')
        chunks, chunked_admits = _prefill_chunks(out, stream, opts)
        want = {k: 0 for k in build.LAUNCHES}
        want.update(launches_of(out, mode, prequant, chunks, chunked_admits))
        for name, n in want.items():
            check(launches[name] == n,
                  f'{tag}: {name} launched {launches[name]} times, '
                  f'expected {n} ({out["steps"]} decode steps, {chunks} '
                  f'prefill chunks)')
        if num_pages is not None:
            check(out['preempted'] > 0, f'{tag}: the small pool forced no '
                                        f'preemption')
        if out['kv_quant']:
            check(out['pages_quantized'] > 0, f'{tag}: no page quantized')
        if kind == 'shared' and out['prefix'] is None:
            private_peak = out['peak_pages']
        if out['prefix'] is not None:
            check(chunks > 0, f'{tag}: no prefill chunk')
            check(out['prefix']['hits'] >= n_req - 1,
                  f'{tag}: {out["prefix"]["hits"]} prefix hits of {n_req}')
            check(out['peak_pages'] < private_peak,
                  f'{tag}: peak pages {out["peak_pages"]} not below the '
                  f'private run\'s {private_peak}')
        for k in totals:
            totals[k] += launches[k]
        decode_s = out['wall_s'] - out['prefill_s']
        results.append(dict(
            arch=arch,
            decode_step_ms=decode_s / max(out['steps'], 1) * 1e3,
            mode=mode, prequantize=prequant, slots=slots, requests=n_req,
            num_pages=out['total_pages'] + 1, prompt_len=128, gen_len=32,
            stream=kind, options=opts,
            tokens_per_s=out['tokens_per_s'], wall_s=out['wall_s'],
            prefill_s=out['prefill_s'], steps=out['steps'],
            decode_tokens=out['decode_tokens'], preempted=out['preempted'],
            peak_pages=out['peak_pages'],
            pages_quantized=out['pages_quantized'], prefix=out['prefix'],
            prefill_chunks=chunks,
            launches={k: v for k, v in launches.items() if v}))
        print(f'serve run: {json.dumps(results[-1])}', flush=True)
    return results, totals


# ----------------------------------------------------------------------------
# phase 5b: the reference's other dense configs at full width
# ----------------------------------------------------------------------------
DENSE_PATH = 'dense family'
# arch -> (layers, d_model, q heads, KV heads, dh, d_ff, vocab): the
# published widths the phase must serve
DENSE_ARCHS = {
    'stablelm-12b': (40, 5120, 32, 8, 160, 13824, 100352),
    'starcoder2-15b': (40, 6144, 48, 4, 128, 24576, 49152),
    'gemma3-27b': (62, 5376, 32, 16, 128, 21504, 262144),
}
# every config in bf16, w8a8 --prequantize and dynamic w8a8; dynamic w8a8
# keeps f32 masters (4 bytes a parameter), refused before any draw where
# they exceed the card's free memory (gemma3-27b: 113.6 GB)
DENSE_MODES = (('bf16', False), ('w8a8', True), ('w8a8', False))
DENSE_PROMPT, DENSE_GEN = 128, 16
# gemma3-27b also serves 2 prompts of 1,152 tokens (past its 1,024-token
# window) chunked by 128 over the int8 tier: the window on K1's tiered
# twin K6 and on K5 in a serve
DENSE_LONG = dict(requests=2, prompt_len=1152,
                  opts=dict(chunk_prefill=128, kv_quant=True, hot_window=2))
# first-decode-step logits of the flash route against the einsum route, at
# full width: in f32 compute (f32 pools, each bf16 weight cast per call)
# within SMOKE_TOL, the bound the f32 smoke parity holds; in bf16 the two
# routes round differently (the einsum oracle casts the probabilities to
# bf16 before PV, the kernels keep them f32), so there both are reported
# beside the f32 logits, not gated: the reference's own full-stack bf16
# bound for the two routes (5e-2, tests/test_flash_decode.py::
# test_model_decode_step_vector_pos_full_stack, at smoke width) was
# exceeded at stablelm-12b's full width (0.094)
DENSE_ROUTE_TOL = SMOKE_TOL


def _dense_stream(SV, cfg, n_req, plen):
    from repro_torch.data import synthetic
    prompts = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=n_req, seq_len=plen), 0)['inputs'].numpy()
    return [SV.Request(rid=i, prompt=prompts[i], target_gen=DENSE_GEN)
            for i in range(n_req)]


def _dense_decode_checks(torch, build, cfg, params):
    """One decode step of ``cfg`` after a prefill of B prompts (gemma3:
    2 of 1,152 tokens, so its local layers' window binds; else 4 of 128)
    over a paged cache, in bf16 and in f32 compute, each through the flash
    route under ``torch.cuda.set_sync_debug_mode('error')`` (no layer
    copies its window, or anything else, host to device; an MoE layer
    routes on the device; K1, or K8 on an MLA config, launched once a
    layer) and then the einsum route on the same cache (each layer
    rewrites the step's row before it reads it). Gate: the two routes'
    f32 logits within DENSE_ROUTE_TOL; the bf16 ones are reported beside
    the f32 flash logits. The step's token is each prompt's last."""
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.data import synthetic
    from repro_torch.models import model as M
    from repro_torch.runtime import layouts

    b, plen = ((2, DENSE_LONG['prompt_len']) if cfg.sliding_window
               else (4, DENSE_PROMPT))
    kernel = ('flash_decode_paged_mla' if cfg.mla is not None
              else 'flash_decode_paged')
    ps = 8
    blocks = -(-(plen + 1) // ps)
    prompts = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=b, seq_len=plen), 0)['inputs'].to('cuda')
    tok = prompts[:, -1].to(torch.int32).contiguous()
    pos = torch.full((b,), plen, dtype=torch.int32, device='cuda')
    tables = 1 + torch.arange(b * blocks, dtype=torch.int32,
                              device='cuda').reshape(b, blocks)

    def routes(dtype):
        yoco = YocoConfig(mode='bf16', compute_dtype=dtype)
        flash = M.ModelRuntime(attn_impl='flash', compute_dtype=dtype)
        cache = M.init_paged_cache_tree(cfg, b, num_pages=1 + b * blocks,
                                        page_size=ps, max_blocks=blocks,
                                        dtype=dtype, device='cuda')
        cache = layouts.with_block_tables(cache, tables)
        _, cache = M.prefill(params, dict(inputs=prompts), cache, cfg, yoco,
                             flash)
        torch.cuda.synchronize()
        build.reset_counts()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode('error')
        try:
            lf, cache = M.decode_step(params, tok, pos, cache, cfg, yoco,
                                      flash)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        check(launches == {kernel: cfg.n_layers},
              f'{cfg.name} {dtype} decode step: launches {launches}, '
              f'expected {kernel} {cfg.n_layers} times (once a layer)')
        le, _ = M.decode_step(params, tok, pos, cache, cfg, yoco,
                              M.ModelRuntime(attn_impl='einsum',
                                             compute_dtype=dtype))
        check(bool(torch.isfinite(lf).all() and torch.isfinite(le).all()),
              f'{cfg.name} {dtype} decode step: non-finite logits')
        return lf.float(), le.float()

    f16, e16 = routes(torch.bfloat16)
    f32, e32 = routes(torch.float32)

    def dist(a, c):
        return float((a - c).abs().max())
    row = dict(arch=cfg.name, check='decode step', batch=b, context=plen,
               window_binds=bool(cfg.sliding_window
                                 and plen >= cfg.sliding_window),
               sync_debug='error', decode_launches={kernel: cfg.n_layers},
               f32_flash_vs_einsum=dist(f32, e32), tol=DENSE_ROUTE_TOL,
               bf16_flash_vs_einsum=dist(f16, e16),
               bf16_flash_vs_f32=dist(f16, f32),
               bf16_einsum_vs_f32=dist(e16, f32),
               max_abs_logit=float(f32.abs().max()))
    print(f'dense check: {json.dumps(row)}', flush=True)
    check(row['f32_flash_vs_einsum'] <= DENSE_ROUTE_TOL,
          f'{cfg.name} decode step: f32 flash vs einsum logits differ by '
          f'{row["f32_flash_vs_einsum"]} > {DENSE_ROUTE_TOL}')
    return row


def dense_phase(torch, build):
    """stablelm-12b, starcoder2-15b and gemma3-27b at their published
    widths through ``serve_continuous`` (random weights from seed 0, drawn
    by the serve in their serving form; page 8, 8 slots): 8 requests of
    128-token prompts and 16 generated tokens in bf16, w8a8 --prequantize
    and dynamic w8a8 (gemma3-27b's refused for its f32 masters, the refusal
    checked), and gemma3-27b's 2 prompts of 1,152 tokens chunked by 128
    over the int8 tier. Gates: every request finishes, no lane has a
    non-finite logits row, each kernel launched exactly as the path must
    (K1 once a layer a decode step, K6 in its place with the tier, K5 once
    a layer a chunk; K2/K3/K4 per :func:`gqa_counts`); then one decode
    step a config through :func:`_dense_decode_checks`. Each model is
    freed before the next loads. Returns (rows, launch totals)."""
    import functools
    import gc

    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M

    totals = {k: 0 for k in build.LAUNCHES}
    rows = []
    t0 = time.perf_counter()
    dev = torch.device('cuda')
    for arch, widths in DENSE_ARCHS.items():
        cfg = configs.get(arch, smoke=False)
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == widths,
              f'{arch} is not at its published width')
        launches_of = functools.partial(_gqa_launches, cfg=cfg)
        runs = [(m, p, DENSE_PROMPT, 8, {}) for m, p in DENSE_MODES]
        if cfg.sliding_window:
            runs.append(('bf16', False, DENSE_LONG['prompt_len'],
                         DENSE_LONG['requests'], DENSE_LONG['opts']))
        for mode, prequant, plen, n_req, opts in runs:
            tag = (f'dense {arch} {mode} prequant={prequant} prompt={plen} '
                   f'{opts}')
            gc.collect()            # the last serve's weights, before the
            torch.cuda.empty_cache()    # next draw
            free = torch.cuda.mem_get_info(dev)[0]
            need = M.serving_bytes(cfg, mode, prequant, torch.bfloat16)
            if mode == 'w8a8' and not prequant and need > free:
                try:
                    SV.serve_continuous(arch, smoke=False, mode=mode,
                                        n_requests=1, quiet=True)
                except ValueError as e:
                    check(f'{need} bytes' in str(e),
                          f'{tag}: refusal without the bytes: {e}')
                    rows.append(dict(arch=arch, mode=mode,
                                     prequantize=prequant, refused=str(e),
                                     free_bytes=free))
                    print(f'dense run: {json.dumps(rows[-1])}', flush=True)
                    continue
                check(False, f'{tag}: f32 masters of {need} bytes were '
                             f'not refused')
            stream = _dense_stream(SV, cfg, n_req, plen)
            torch.cuda.reset_peak_memory_stats()
            build.reset_counts()
            out = SV.serve_continuous(
                arch, smoke=False, slots=8, n_requests=n_req,
                prompt_len=plen, gen_len=DENSE_GEN, page_size=8, mode=mode,
                prequantize=prequant, attn_impl='flash', seed=0,
                request_stream=stream, quiet=True, **opts)
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            check(out['completed'] == n_req and out['failed'] == 0
                  and out['rejected'] == 0 and out['cancelled'] == 0,
                  f'{tag}: not every request finished: {out["events"]}')
            check(out['quarantined'] == 0,
                  f'{tag}: {out["quarantined"]} lanes had non-finite '
                  f'logits')
            chunks, chunked_admits = _prefill_chunks(out, stream, opts)
            want = {k: 0 for k in build.LAUNCHES}
            want.update(launches_of(out, mode, prequant, chunks,
                                    chunked_admits))
            for name, n in want.items():
                check(launches[name] == n,
                      f'{tag}: {name} launched {launches[name]} times, '
                      f'expected {n} ({out["steps"]} decode steps, '
                      f'{chunks} prefill chunks)')
            if out['kv_quant']:
                check(out['pages_quantized'] > 0, f'{tag}: no page '
                                                  f'quantized')
            for k in totals:
                totals[k] += launches[k]
            rows.append(dict(
                arch=arch, mode=mode, prequantize=prequant, slots=8,
                requests=n_req, prompt_len=plen, gen_len=DENSE_GEN,
                options=opts, tokens_per_s=out['tokens_per_s'],
                wall_s=out['wall_s'], prefill_s=out['prefill_s'],
                steps=out['steps'], peak_pages=out['peak_pages'],
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                pages_quantized=out['pages_quantized'],
                prefill_chunks=chunks,
                launches={k: v for k, v in launches.items() if v}))
            print(f'dense run: {json.dumps(rows[-1])}', flush=True)
            del out
        gc.collect()
        torch.cuda.empty_cache()
        params = SV._serving_params(cfg, None, dev, seed=0, mode='bf16',
                                    prequantize=False,
                                    compute_dtype=torch.bfloat16)
        rows.append(_dense_decode_checks(torch, build, cfg, params))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    rows.append(dict(phase_s=time.perf_counter() - t0))
    print(f'dense family phase: {rows[-1]["phase_s"]:.1f} s', flush=True)
    return rows, totals


# ----------------------------------------------------------------------------
# phase 5c: the Mixture-of-Experts configs at full width
# ----------------------------------------------------------------------------
MOE_PATH = 'moe family'
# arch -> (layers, d_model, q heads, KV heads, experts, stack, top-k,
# d_ff expert, d_ff shared, dense layers first, vocab): the published
# widths the phase must serve (deepseek-v3's depth cut 61 -> 5)
MOE_ARCHS = {
    MOE_ARCH: (24, 2048, 16, 16, 60, 64, 4, 1408, 5632, 0, 151936),
    MOE5_ARCH: (MOE5_LAYERS, 7168, 128, 128, 256, 256, 8, 2048, 2048, 3,
                129280),
}
# (arch, mode, prequantize, stream, serve_continuous options), grouped by
# the weights they serve: qwen2-moe in bf16 (the full stream, then the
# shared one with the prefix cache over the int8 tier: K5 and K6), w8a8
# --prequantize and dynamic w8a8; deepseek-v3-moe5 in bf16 (the same two
# streams: K9 and K10) and dynamic w8a8 (the port refuses --prequantize
# on MLA)
MOE_RUNS = (
    (MOE_ARCH, 'bf16', False, 'full', {}),
    (MOE_ARCH, 'bf16', False, 'shared', dict(prefix_cache=True, **TIER)),
    (MOE_ARCH, 'w8a8', True, 'full', {}),
    (MOE_ARCH, 'w8a8', False, 'full', {}),
    (MOE5_ARCH, 'bf16', False, 'full', {}),
    (MOE5_ARCH, 'bf16', False, 'shared', dict(prefix_cache=True, **TIER)),
    (MOE5_ARCH, 'w8a8', False, 'full', {}),
)
MOE_REQUESTS, MOE_PROMPT, MOE_GEN = 8, 128, 16
# what is left allocated between two models (the next one must not load
# beside the last)
MOE_FREED_BYTES = 1 << 30


def _moe_stream(SV, cfg, kind):
    """8 requests of 128-token prompts generating 16 tokens; 'shared'
    prompts open with one 96-token system prompt."""
    from repro_torch.data import synthetic
    prompts = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=MOE_REQUESTS, seq_len=MOE_PROMPT),
        0)['inputs'].numpy()
    if kind == 'shared':
        prompts[:, :SHARED_PREFIX] = prompts[0, :SHARED_PREFIX]
    return [SV.Request(rid=i, prompt=prompts[i], target_gen=MOE_GEN)
            for i in range(MOE_REQUESTS)]


def moe_phase(torch, build):
    """qwen2-moe-a2.7b at its published width and depth and deepseek-v3
    cut to 5 layers (3 dense, 2 MoE) at its published width, through
    ``serve_continuous`` (random weights from seed 0, drawn once a (config,
    mode) in their serving form, expert stacks in bf16; page 8, 8 slots):
    each of MOE_RUNS after a warm-up, then once more under torch.profiler
    for the device busy share. Gates: every request finishes, no lane has
    a non-finite logits row, each kernel launched exactly as the path must
    (K1 once a layer a decode step, K6 in its place with the tier, K5 once
    a layer a chunk, qwen2-moe's K2/K3/K4 per :func:`gqa_counts`; K8/K10
    and K9 once a layer, deepseek's K3/K4 per :func:`mla_counts`; the
    router and the experts launch none), the tier quantizes pages and the
    prefix cache hits; then one decode step a config through
    :func:`_dense_decode_checks` (no host sync, flash vs einsum in f32).
    Dynamic w8a8 is refused before any draw where its weights exceed the
    card's free memory (checked as in the dense phase). Each model is
    freed before the next loads. Returns (rows, launch totals)."""
    import functools
    import gc

    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M

    totals = {k: 0 for k in build.LAUNCHES}
    rows = []
    t0 = time.perf_counter()
    dev = torch.device('cuda')
    bf16 = torch.bfloat16
    for arch, widths in MOE_ARCHS.items():
        cfg = configs.get(arch, smoke=False)
        mo = cfg.moe
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               mo.n_experts, mo.stack_size, mo.top_k, mo.d_ff_expert,
               mo.d_ff_shared, mo.first_k_dense, cfg.vocab_size) == widths,
              f'{arch} is not at its published width')
        launches_of = (functools.partial(_mla_launches, layers=cfg.n_layers)
                       if cfg.mla is not None
                       else functools.partial(_gqa_launches, cfg=cfg))
        params, loaded = None, None
        for run_arch, mode, prequant, kind, opts in MOE_RUNS:
            if run_arch != arch:
                continue
            tag = (f'moe {arch} {mode} prequant={prequant} stream={kind} '
                   f'{opts}')
            load_s = None
            if loaded != (mode, prequant):
                params = kw = None          # the last serve's weights
                gc.collect()
                torch.cuda.empty_cache()
                check(torch.cuda.memory_allocated() < MOE_FREED_BYTES,
                      f'{tag}: {torch.cuda.memory_allocated()} bytes still '
                      f'allocated before the model loads')
                free = torch.cuda.mem_get_info(dev)[0]
                need = M.serving_bytes(cfg, 'w8a8', False, bf16)
                if mode == 'w8a8' and not prequant and need > free:
                    try:
                        SV.serve_continuous(arch, smoke=False, mode=mode,
                                            n_requests=1, quiet=True)
                    except ValueError as e:
                        check(f'{need} bytes' in str(e),
                              f'{tag}: refusal without the bytes: {e}')
                        rows.append(dict(arch=arch, mode=mode,
                                         prequantize=prequant,
                                         refused=str(e), free_bytes=free))
                        print(f'moe run: {json.dumps(rows[-1])}',
                              flush=True)
                        continue
                    check(False, f'{tag}: {need} bytes of weights were not '
                                 f'refused with {free} free')
                torch.cuda.reset_peak_memory_stats()
                t_load = time.perf_counter()
                params = SV._serving_params(cfg, None, dev, seed=0,
                                            mode=mode, prequantize=prequant,
                                            compute_dtype=bf16)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t_load
                loaded = (mode, prequant)
            kw = dict(smoke=False, slots=8, page_size=8, mode=mode,
                      prequantize=prequant, attn_impl='flash',
                      params=params, quiet=True, **opts)
            # warm-up (library handles, allocator) outside the measured run
            SV.serve_continuous(arch, n_requests=1, prompt_len=MOE_PROMPT,
                                gen_len=2, **kw)
            torch.cuda.synchronize()
            stream = _moe_stream(SV, cfg, kind)
            build.reset_counts()
            t_run = time.perf_counter()
            out = SV.serve_continuous(arch, prompt_len=MOE_PROMPT,
                                      gen_len=MOE_GEN, request_stream=stream,
                                      **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_run) * 1e3
            launches = dict(build.LAUNCHES)
            check(out['completed'] == MOE_REQUESTS and out['failed'] == 0
                  and out['rejected'] == 0 and out['cancelled'] == 0,
                  f'{tag}: not every request finished: {out["events"]}')
            check(out['quarantined'] == 0,
                  f'{tag}: {out["quarantined"]} lanes had non-finite '
                  f'logits')
            chunks, chunked_admits = _prefill_chunks(out, stream, opts)
            want = {k: 0 for k in build.LAUNCHES}
            want.update(launches_of(out, mode, prequant, chunks,
                                    chunked_admits))
            for name, n in want.items():
                check(launches[name] == n,
                      f'{tag}: {name} launched {launches[name]} times, '
                      f'expected {n} ({out["steps"]} decode steps, '
                      f'{chunks} prefill chunks)')
            if out['kv_quant']:
                check(out['pages_quantized'] > 0, f'{tag}: no page '
                                                  f'quantized')
            if out['prefix'] is not None:
                check(chunks > 0, f'{tag}: no prefill chunk')
                check(out['prefix']['hits'] >= MOE_REQUESTS - 1,
                      f'{tag}: {out["prefix"]["hits"]} prefix hits of '
                      f'{MOE_REQUESTS}')
            for k in totals:
                totals[k] += launches[k]
            # the device busy share: the kernels' summed device time under
            # torch.profiler over the wall time of the run above
            stream = _moe_stream(SV, cfg, kind)
            by_name = profiled_kernels(torch, lambda: SV.serve_continuous(
                arch, prompt_len=MOE_PROMPT, gen_len=MOE_GEN,
                request_stream=stream, **kw))
            busy_ms = sum(v[0] for v in by_name.values()) if by_name \
                else None
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            decode_s = out['wall_s'] - out['prefill_s']
            rows.append(dict(
                arch=arch, mode=mode, prequantize=prequant, stream=kind,
                slots=8, requests=MOE_REQUESTS, prompt_len=MOE_PROMPT,
                gen_len=MOE_GEN, options=opts, load_s=load_s,
                tokens_per_s=out['tokens_per_s'], wall_s=out['wall_s'],
                prefill_s=out['prefill_s'], steps=out['steps'],
                decode_step_ms=decode_s / max(out['steps'], 1) * 1e3,
                peak_pages=out['peak_pages'],
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                pages_quantized=out['pages_quantized'],
                prefix=out['prefix'], prefill_chunks=chunks,
                launches={k: v for k, v in launches.items() if v},
                wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=(None if busy_ms is None
                                   else busy_ms / wall_ms),
                kernel_launches=sum(v[1] for v in by_name.values()),
                top=[dict(kernel=k[:80], device_ms=v[0], calls=v[1])
                     for k, v in top]))
            print(f'moe run: {json.dumps(rows[-1])}', flush=True)
            del out
        params = kw = None
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() < MOE_FREED_BYTES,
              f'{arch}: {torch.cuda.memory_allocated()} bytes still '
              f'allocated before the decode check loads')
        params = SV._serving_params(cfg, None, dev, seed=0, mode='bf16',
                                    prequantize=False, compute_dtype=bf16)
        rows.append(_dense_decode_checks(torch, build, cfg, params))
        params = None
        gc.collect()
        torch.cuda.empty_cache()
    rows.append(dict(phase_s=time.perf_counter() - t0))
    print(f'moe phase: {rows[-1]["phase_s"]:.1f} s', flush=True)
    return rows, totals


# ----------------------------------------------------------------------------
# phase 5d: the recurrent configs at full width and depth
# ----------------------------------------------------------------------------
SSM_ARCH, HYB_ARCH = 'mamba2-780m', 'zamba2-1.2b'
SSM_PATH = 'ssm family'
# arch -> (layers, d_model, d_state, expand, head_dim, groups, conv width,
# chunk, hybrid_group, heads, d_ff, vocab): the published widths and depths
SSM_ARCHS = {
    SSM_ARCH: (48, 1536, 128, 2, 64, 1, 4, 256, 0, 0, 0, 50280),
    HYB_ARCH: (38, 2048, 64, 2, 64, 1, 4, 256, 6, 32, 8192, 32000),
}
SSM_REQUESTS, SSM_PROMPT, SSM_GEN = 8, 128, 16
# 3 lanes of 16 pages fill the 48-page pool and all must grow past position
# 128, so the youngest is preempted and later recomputes from its prompt
SSM_PREEMPT_PAGES = 1 + 48
# (arch, mode, prequantize, num_pages, serve_continuous options), grouped
# by the weights they serve; zamba2's --prequantize is refused (the
# reference fails there), checked before its runs
SSM_RUNS = (
    (SSM_ARCH, 'bf16', False, None, {}),
    (SSM_ARCH, 'bf16', False, SSM_PREEMPT_PAGES, {}),
    (SSM_ARCH, 'w8a8', True, None, {}),
    (SSM_ARCH, 'w8a8', False, None, {}),
    (HYB_ARCH, 'bf16', False, None, {}),
    (HYB_ARCH, 'bf16', False, SSM_PREEMPT_PAGES, {}),
    (HYB_ARCH, 'bf16', False, None, TIER),
    (HYB_ARCH, 'w8a8', False, None, {}),
)
# mamba2's long prompts: 1,024 tokens, four SSD chunks of 256
SSM_LONG = dict(requests=2, prompt_len=1024)
# ssd_chunked against the sequential recurrence: the reference's own
# tolerance (tests/test_ssm.py, rtol and atol)
SSD_TOL = 2e-4
# (arch, attn_impl, ragged) of the static serve() at full width
SSM_STATIC_RUNS = ((HYB_ARCH, 'flash', False), (HYB_ARCH, 'einsum', True),
                   (SSM_ARCH, 'einsum', True))


def ssm_counts(cfg):
    """(linears, distinct activations) of one forward of a recurrent config:
    in_proj and out_proj a Mamba2 layer (each its own activation); a
    hybrid's shared block at each site runs q k v o and the GELU MLP's in
    and out (q/k/v share one activation: 4 a site); the lm_head (mamba2's
    tied embedding's transpose) one more. The shared block's per-site
    in_proj is a float einsum, no linear. mamba2-780m: 97 over 97;
    zamba2-1.2b: 101 over 89."""
    from repro_torch.models import model as M
    sites = M._n_sites(cfg)
    return (2 * M._n_mamba(cfg) + 6 * sites + 1,
            2 * M._n_mamba(cfg) + 4 * sites + 1)


def _ssm_launches(cfg, forwards, decode_steps, mode, prequant, *,
                  kv_quant=False, static_flash=False):
    """Launches a recurrent path must make: a hybrid's K1 once a site a
    decode step (K6 in its place with the tier; K7 in the static flash
    serve()), a pure SSM no attention kernel; per forward
    :func:`ssm_counts`' linears: with --prequantize K2 on every linear but
    the tied head, which is quantized dynamically in every w8a8 mode (K3
    on its weight, then K4): K2 96, K3 98, K4 1 for mamba2; dynamic K4 on
    every linear, K3 on each activation and each weight (mamba2 97 and
    194, zamba2 101 and 190)."""
    sites = cfg.n_layers // cfg.hybrid_group if cfg.hybrid_group else 0
    linears, acts = ssm_counts(cfg)
    attn = sites * decode_steps
    want = dict(flash_decode_paged=0 if kv_quant or static_flash else attn,
                flash_decode_paged_q8=attn if kv_quant else 0,
                flash_decode_contig=attn if static_flash else 0)
    if mode == 'w8a8' and prequant:
        check(cfg.tie_embeddings, 'prequantize counted for a tied head')
        want.update(int8_matmul=(linears - 1) * forwards,
                    quantize_rows=(acts + 1) * forwards,
                    yoco_vmm_int8=forwards)
    elif mode == 'w8a8':
        want.update(yoco_vmm_int8=linears * forwards,
                    quantize_rows=(acts + linears) * forwards)
    return want


def _check_launches(build, tag, want):
    full = {k: 0 for k in build.LAUNCHES}
    full.update(want)
    for name, n in full.items():
        check(build.LAUNCHES[name] == n,
              f'{tag}: {name} launched {build.LAUNCHES[name]} times, '
              f'expected {n}')


def _state_bytes(cache):
    return sum(t.numel() * t.element_size() for t in cache['ssm'].values())


def _ssd_check(torch, cfg, params, prompt):
    """Layer 0's SSD inputs for ``prompt`` (1, S) at full width, made as
    the served forward makes them (bf16 embedding, norm and in_proj; the
    f32 conv and softplus), then ``ssd_chunked`` against the sequential
    ``ssd_reference`` in f32 on the card, the reference's SSD_TOL."""
    from repro_torch.core import yoco_linear
    from repro_torch.models import ssm as S
    from repro_torch.models.layers import apply_norm

    lp = params['layers'][0]
    mix = lp['mixer']
    dm = S.dims(cfg)
    s = cfg.ssm
    x = params['embed'][prompt.long()].to(torch.bfloat16)
    h = apply_norm(lp['norm'], x, cfg)
    zx = yoco_linear.linear(h, mix['in_proj'])
    _, xbc, dt, di, gn = S._split_in_proj(zx, cfg)
    xbc = S._causal_conv(xbc, mix['conv_w'], mix['conv_b'])
    n = prompt.shape[1]
    xh = xbc[..., :di].reshape(1, n, dm['n_heads'], s.head_dim)
    b = xbc[..., di:di + gn].reshape(1, n, s.n_groups, s.d_state)
    c = xbc[..., di + gn:].reshape(1, n, s.n_groups, s.d_state)
    dt = S.softplus(dt.float() + mix['dt_bias'])
    a = -torch.exp(mix['a_log'])
    y, fin = S.ssd_chunked(xh, dt, a, b, c, s.chunk_size)
    y_s, fin_s = S.ssd_reference(xh, dt, a, b, c)
    torch.cuda.synchronize()
    row = dict(arch=cfg.name, check='ssd_chunked vs ssd_reference, layer 0',
               tokens=n, chunks=n // s.chunk_size, heads=dm['n_heads'],
               head_dim=s.head_dim, d_state=s.d_state)
    for name, got, want in (('y', y, y_s), ('state', fin, fin_s)):
        err = (got - want).abs()
        excess = float((err - SSD_TOL * want.abs()).max())
        row[f'{name}_max_abs_err'] = float(err.max())
        row[f'{name}_max_abs'] = float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and excess <= SSD_TOL,
              f'{cfg.name} ssd_chunked {name} differs from the sequential '
              f'recurrence beyond rtol = atol = {SSD_TOL}: {row}')
    row['tol'] = dict(rtol=SSD_TOL, atol=SSD_TOL)
    print(f'ssm check: {json.dumps(row)}', flush=True)
    return row


def _ssm_decode_check(torch, build, cfg, params):
    """One decode step of ``cfg`` (8 slots after a prefill of 8 prompts of
    128 tokens, bf16, paged) under ``set_sync_debug_mode('error')``: no
    host sync, a hybrid's K1 once a site and nothing else, every logit
    finite. Then the step's SSM ops alone (``ssm.decode_core`` on every
    Mamba2 layer's state: the conv window, softplus, the SSD step, the D
    skip and the gated norm) timed on the device beside their bound: the
    f32 state read and written once, the in_proj output read and out_proj's
    input written once, over the card's memory rate."""
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.data import synthetic
    from repro_torch.models import model as M
    from repro_torch.models import ssm as S
    from repro_torch.runtime import layouts

    b, plen, ps = 8, SSM_PROMPT, 8
    blocks = -(-(plen + 1) // ps)
    prompts = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=b, seq_len=plen), 0)['inputs'].to('cuda')
    tok = prompts[:, -1].to(torch.int32).contiguous()
    pos = torch.full((b,), plen, dtype=torch.int32, device='cuda')
    tables = 1 + torch.arange(b * blocks, dtype=torch.int32,
                              device='cuda').reshape(b, blocks)
    yoco = YocoConfig(mode='bf16')
    rt = M.ModelRuntime(attn_impl='flash')
    cache = M.init_paged_cache_tree(cfg, b, num_pages=1 + b * blocks,
                                    page_size=ps, max_blocks=blocks,
                                    device='cuda')
    cache = layouts.with_block_tables(cache, tables)
    _, cache = M.prefill(params, dict(inputs=prompts), cache, cfg, yoco, rt)
    torch.cuda.synchronize()
    build.reset_counts()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        logits, cache = M.decode_step(params, tok, pos, cache, cfg, yoco, rt)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    sites = M._n_sites(cfg)
    want = {'flash_decode_paged': sites} if sites else {}
    check(launches == want, f'{cfg.name} decode step: launches {launches}, '
                            f'expected {want}')
    check(bool(torch.isfinite(logits).all()),
          f'{cfg.name} decode step: non-finite logits')
    # the SSM ops of one decode step, every Mamba2 layer, on the served
    # state (decode_core writes it in place, as the step does)
    dm = S.dims(cfg)
    st = cache['ssm']
    n_layers = M._n_mamba(cfg)
    zx = torch.randn((b, 1, dm['d_in_proj']), device='cuda').to(
        torch.bfloat16)
    views = [{k: v[l] for k, v in st.items()} for l in range(n_layers)]
    mixers = [lp['mixer'] for lp in params['layers']]

    def ssm_ops():
        for mix, view in zip(mixers, views):
            S.decode_core(mix, zx, cfg, view)
    state = _state_bytes(cache)
    io = n_layers * (zx.numel() + b * dm['d_inner']) * 2
    s_cfg = cfg.ssm
    ops = 6.0 * n_layers * b * dm['n_heads'] * s_cfg.head_dim * s_cfg.d_state
    b_ms, b_by = bound(2 * state + io, ops, roofline.PEAK_FLOPS_F32)
    ms, timer, kernels = device_ms(torch, ssm_ops, iters=10)
    check(bool(torch.isfinite(st['ssm']).all()),
          f'{cfg.name}: the decode state went non-finite')
    row = dict(arch=cfg.name, check='decode step', batch=b, context=plen,
               sync_debug='error', decode_launches=want,
               max_abs_logit=float(logits.float().abs().max()),
               state_bytes=state, state_bytes_per_slot=state // b,
               ssm_ops_ms=ms, ssm_ops_timer=timer,
               ssm_ops_kernels=kernels, ssm_ops_bound_ms=b_ms,
               ssm_ops_bound_by=b_by, ssm_ops_bytes=2 * state + io,
               mamba_layers=n_layers)
    print(f'ssm check: {json.dumps(row)}', flush=True)
    return row


def ssm_phase(torch, build):
    """mamba2-780m and zamba2-1.2b at their published widths and depths
    through ``serve_continuous`` (random weights from seed 0, drawn once a
    (config, mode) in their serving form; page 8, 8 slots): each of
    SSM_RUNS on 8 requests of 128-token prompts generating 16 tokens,
    after a warm-up, then once more under torch.profiler for the device
    busy share; mamba2 also on 2 prompts of 1,024 tokens (four SSD chunks)
    and, on one of them, layer 0's SSD at full width against the
    sequential recurrence (:func:`_ssd_check`); zamba2's --prequantize
    refused; the static serve() (batch 8, prompt 128, generation 32) of
    SSM_STATIC_RUNS and mamba2's --attn-impl flash refused; one decode
    step a config through :func:`_ssm_decode_check`. The preempting runs
    are not profiled. Gates: every request
    finishes, no non-finite logits row, exact launches
    (:func:`_ssm_launches`), the tier quantizes pages, the preempting
    pool preempts and leaves the tokens of the run beside it, the
    recurrent state's bytes are the config's. Each model is freed before
    the next loads. Returns (rows, launch totals)."""
    import gc

    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.models import ssm as S
    from repro_torch.runtime import serve_step as SS

    totals = {k: 0 for k in build.LAUNCHES}
    rows = []
    t0 = time.perf_counter()
    dev = torch.device('cuda')
    bf16 = torch.bfloat16

    def add(tag, want):
        _check_launches(build, tag, want)
        for k in totals:
            totals[k] += build.LAUNCHES[k]

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() < MOE_FREED_BYTES,
              f'{torch.cuda.memory_allocated()} bytes still allocated '
              f'before a model loads')

    for arch, widths in SSM_ARCHS.items():
        cfg = configs.get(arch, smoke=False)
        s = cfg.ssm
        check((cfg.n_layers, cfg.d_model, s.d_state, s.expand, s.head_dim,
               s.n_groups, s.conv_width, s.chunk_size, cfg.hybrid_group,
               cfg.n_heads, cfg.d_ff, cfg.vocab_size) == widths,
              f'{arch} is not at its published width and depth')
        dm = S.dims(cfg)
        # f32 conv window and SSD state a Mamba2 layer, a slot
        slot_bytes = 4 * (M._n_mamba(cfg) * (
            (s.conv_width - 1) * dm['conv_dim']
            + dm['n_heads'] * s.head_dim * s.d_state))
        if cfg.hybrid_group:
            try:
                SV.serve_continuous(arch, smoke=False, mode='w8a8',
                                    prequantize=True, n_requests=1,
                                    quiet=True)
            except ValueError as e:
                check('blocks.py:136' in str(e),
                      f'{arch} --prequantize refused without the reason: '
                      f'{e}')
                rows.append(dict(arch=arch, mode='w8a8', prequantize=True,
                                 refused=str(e)))
            else:
                check(False, f'{arch} --prequantize was not refused')
        params, kw, loaded, base_tokens = None, None, None, None
        for run_arch, mode, prequant, num_pages, opts in SSM_RUNS:
            if run_arch != arch:
                continue
            tag = (f'ssm {arch} {mode} prequant={prequant} pages='
                   f'{num_pages} {opts}')
            if loaded != (mode, prequant):
                params = kw = None      # the serve kwargs hold the weights
                free()
                params = SV._serving_params(cfg, None, dev, seed=0,
                                            mode=mode, prequantize=prequant,
                                            compute_dtype=bf16)
                loaded = (mode, prequant)
            kw = dict(smoke=False, slots=8, page_size=8, mode=mode,
                      prequantize=prequant, attn_impl='flash',
                      params=params, quiet=True, num_pages=num_pages,
                      **opts)
            SV.serve_continuous(arch, n_requests=1, prompt_len=SSM_PROMPT,
                                gen_len=2, **kw)            # warm-up
            torch.cuda.synchronize()
            stream = _dense_stream(SV, cfg, SSM_REQUESTS, SSM_PROMPT)
            seen = []
            torch.cuda.reset_peak_memory_stats()
            build.reset_counts()
            t_run = time.perf_counter()
            out = SV.serve_continuous(
                arch, prompt_len=SSM_PROMPT, gen_len=SSM_GEN,
                request_stream=stream,
                step_hook=lambda sched, kv, cache: seen.append(
                    _state_bytes(cache)) if not seen else None, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_run) * 1e3
            peak = torch.cuda.max_memory_allocated()
            check(out['completed'] == SSM_REQUESTS and out['failed'] == 0
                  and out['rejected'] == 0 and out['cancelled'] == 0,
                  f'{tag}: not every request finished: {out["events"]}')
            check(out['quarantined'] == 0,
                  f'{tag}: {out["quarantined"]} lanes had non-finite '
                  f'logits')
            add(tag, _ssm_launches(
                cfg, out['steps'] + out['events']['admit'], out['steps'],
                mode, prequant, kv_quant=bool(opts.get('kv_quant'))))
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            check(seen and seen[0] == 8 * slot_bytes,
                  f'{tag}: recurrent state of {seen} bytes, expected '
                  f'{8 * slot_bytes}')
            if opts.get('kv_quant'):
                check(out['pages_quantized'] > 0, f'{tag}: no page '
                                                  f'quantized')
            if mode == 'bf16' and num_pages is None and not opts:
                base_tokens = out['outputs']
            if num_pages is not None:
                check(out['preempted'] > 0, f'{tag}: the small pool forced '
                                            f'no preemption')
                check(out['outputs'] == base_tokens,
                      f'{tag}: the preempted requests\' tokens differ from '
                      f'the unpressured run\'s')
            # the device busy share: the unpressured runs' kernels under
            # torch.profiler over their wall time (the preempting runs
            # repeat the bf16 run's work four times over)
            stream = _dense_stream(SV, cfg, SSM_REQUESTS, SSM_PROMPT)
            by_name = {} if num_pages is not None else profiled_kernels(
                torch, lambda: SV.serve_continuous(
                    arch, prompt_len=SSM_PROMPT, gen_len=SSM_GEN,
                    request_stream=stream, **kw))
            busy_ms = sum(v[0] for v in by_name.values()) if by_name \
                else None
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            decode_s = out['wall_s'] - out['prefill_s']
            rows.append(dict(
                arch=arch, mode=mode, prequantize=prequant, slots=8,
                requests=SSM_REQUESTS, prompt_len=SSM_PROMPT,
                gen_len=SSM_GEN, num_pages=num_pages, options=opts,
                tokens_per_s=out['tokens_per_s'], wall_s=out['wall_s'],
                prefill_s=out['prefill_s'], steps=out['steps'],
                decode_step_ms=decode_s / max(out['steps'], 1) * 1e3,
                preempted=out['preempted'],
                pages_quantized=out['pages_quantized'],
                state_bytes=seen[0], state_bytes_per_slot=slot_bytes,
                max_memory_allocated=peak, launches=launched,
                wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=(None if busy_ms is None
                                   else busy_ms / wall_ms),
                kernel_launches=sum(v[1] for v in by_name.values()),
                top=[dict(kernel=k[:80], device_ms=v[0], calls=v[1])
                     for k, v in top]))
            print(f'ssm run: {json.dumps(rows[-1])}', flush=True)
            if arch == SSM_ARCH and mode == 'bf16' and num_pages is None:
                # the long prompts: four SSD chunks a prefill
                n_req, plen = SSM_LONG['requests'], SSM_LONG['prompt_len']
                stream = _dense_stream(SV, cfg, n_req, plen)
                build.reset_counts()
                out = SV.serve_continuous(
                    arch, smoke=False, slots=n_req, page_size=8,
                    prompt_len=plen, gen_len=SSM_GEN, params=params,
                    request_stream=stream, quiet=True)
                torch.cuda.synchronize()
                ltag = f'ssm {arch} bf16 prompt={plen}'
                check(out['completed'] == n_req and out['quarantined'] == 0,
                      f'{ltag}: {out["events"]}')
                add(ltag, {})
                rows.append(dict(
                    arch=arch, mode='bf16', requests=n_req,
                    prompt_len=plen, gen_len=SSM_GEN,
                    ssd_chunks=plen // s.chunk_size,
                    tokens_per_s=out['tokens_per_s'], wall_s=out['wall_s'],
                    prefill_s=out['prefill_s'], steps=out['steps']))
                print(f'ssm run: {json.dumps(rows[-1])}', flush=True)
                prompt = torch.from_numpy(stream[0].prompt[None]).to(dev)
                rows.append(_ssd_check(torch, cfg, params, prompt))
        # the static serve() and one decode step, on bf16 weights
        params = kw = None
        free()
        params = SV._serving_params(cfg, None, dev, seed=0, mode='bf16',
                                    prequantize=False, compute_dtype=bf16)
        kw = dict(smoke=False, batch=STATIC_BATCH, prompt_len=STATIC_PROMPT,
                  quiet=True, params=params)
        if not cfg.hybrid_group:
            try:
                SV.serve(arch, attn_impl='flash', gen_len=2, **kw)
            except ValueError as e:
                rows.append(dict(arch=arch, attn_impl='flash',
                                 refused=str(e)))
            else:
                check(False, f'{arch} static --attn-impl flash was not '
                             f'refused')
        SV.serve(arch, gen_len=2, **kw)                     # warm-up
        for run_arch, impl, ragged in SSM_STATIC_RUNS:
            if run_arch != arch:
                continue
            tag = f'ssm static serve {arch} {impl} ragged={ragged}'
            finite = []
            torch.cuda.reset_peak_memory_stats()
            build.reset_counts()
            out = SV.serve(arch, gen_len=STATIC_GEN, attn_impl=impl,
                           ragged=ragged,
                           step_hook=lambda logits, tok: finite.append(
                               SS.logits_health(logits)[0].all()), **kw)
            torch.cuda.synchronize()
            check(len(finite) == STATIC_GEN
                  and bool(torch.stack(finite).all()),
                  f'{tag}: a logits row is not finite')
            check(out['generated_shape'] == [STATIC_BATCH, STATIC_GEN],
                  f'{tag}: generated_shape {out["generated_shape"]}')
            add(tag, _ssm_launches(cfg, STATIC_GEN, STATIC_GEN - 1, 'bf16',
                                   False, static_flash=impl == 'flash')
                if impl == 'flash' else {})
            rows.append(dict(
                arch=arch, static=True, attn_impl=impl, ragged=ragged,
                batch=STATIC_BATCH, prompt_len=STATIC_PROMPT,
                gen_len=STATIC_GEN, tokens_per_s=out['tokens_per_s'],
                prefill_s=out['prefill_s'], decode_s=out['decode_s'],
                decode_step_ms=out['decode_s'] / (STATIC_GEN - 1) * 1e3,
                prompt_lens=out.get('prompt_lens'),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches={k: v for k, v in build.LAUNCHES.items() if v}))
            print(f'ssm run: {json.dumps(rows[-1])}', flush=True)
        rows.append(_ssm_decode_check(torch, build, cfg, params))
        params = kw = None
        free()
    rows.append(dict(phase_s=time.perf_counter() - t0))
    print(f'ssm phase: {rows[-1]["phase_s"]:.1f} s', flush=True)
    return rows, totals


# ----------------------------------------------------------------------------
# phase 5e: the non-token frontends (qwen2-vl-72b, musicgen-large)
# ----------------------------------------------------------------------------
FRONTEND_PATH = 'frontends static serve()'
VL_ARCH, MG_ARCH = 'qwen2-vl-72b', 'musicgen-large'
# qwen2-vl-72b cut to 12 of its 80 layers (bf16: 23.56 GB of weights;
# dynamic w8a8's f32 masters 47.11 GB), and to 40 for the --prequantize
# serve (its 80 layers' 71.5 GB of int8 weights served whole until the
# train phase needed the time), registered at run time by
# register_vl_cuts()
VL12_ARCH, VL12_LAYERS = 'qwen2-vl-72b-L12', 12
VL40_ARCH, VL40_LAYERS = 'qwen2-vl-72b-L40', 40
# arch -> (layers, d_model, q heads, KV heads, dh, d_ff, vocab, codebooks):
# the published widths the phase must serve
FRONTEND_ARCHS = {
    VL12_ARCH: (VL12_LAYERS, 8192, 64, 8, 128, 29568, 152064, 1),
    MG_ARCH: (48, 2048, 32, 32, 64, 8192, 2048, 4),
}
# the static serve() runs of each config, by mode: (attn_impl, ragged,
# sampling); batch 8, prompt 128, generation 32
FRONTEND_RUNS = {
    ('bf16', False): (('flash', False, None), ('einsum', True, None),
                      ('flash', True, dict(temperature=0.8, top_k=40))),
    ('w8a8', True): (('flash', True, None),),
    ('w8a8', False): (('flash', False, None),),
}
# greedy decode steps the f32 flash and einsum routes must agree on
FRONTEND_ROUTE_STEPS = 4


def register_vl_cuts():
    """Register qwen2-vl-72b cut to its first 12 and its first 40 layers,
    ``replace(FULL, n_layers=n)`` (the smoke config is the reference's
    SMOKE), as VL12_ARCH and VL40_ARCH; returns the 12-layer config."""
    import dataclasses

    from repro_torch import configs
    for name, layers in ((VL12_ARCH, VL12_LAYERS), (VL40_ARCH, VL40_LAYERS)):
        configs.base.register(
            dataclasses.replace(configs.get(VL_ARCH), name=name,
                                n_layers=layers),
            dataclasses.replace(configs.get(VL_ARCH, smoke=True), name=name))
    return configs.get(VL12_ARCH)


def frontend_counts(cfg):
    """(linears, distinct activations) of one forward of a frontend config:
    :func:`gqa_counts`' (q k v o and the MLP a layer: qwen2-vl's SwiGLU
    7, musicgen's GELU 6; 4 activations a layer), with the lm_head's
    linear and activation only where the head is one: musicgen's four
    codebook heads are a float einsum. qwen2-vl-72b-L12: 85 over 49;
    musicgen-large: 288 over 192."""
    linears, acts = gqa_counts(cfg)
    head = 0 if cfg.n_codebooks > 1 else 1
    return linears - 1 + head, acts - 1 + head


def _frontend_launches(cfg, mode, prequant, impl, forwards=STATIC_GEN):
    """Launches a static serve() of a frontend config must make: K7 once a
    layer a decode step with flash (none with einsum), and per forward
    :func:`frontend_counts`' linears over their activations: K2 a linear
    and K3 an activation with --prequantize, K4 a linear and K3 an
    activation and a linear in dynamic w8a8."""
    linears, acts = frontend_counts(cfg)
    want = dict(flash_decode_contig=cfg.n_layers * (forwards - 1)
                if impl == 'flash' else 0)
    if mode == 'w8a8' and prequant:
        want.update(int8_matmul=linears * forwards,
                    quantize_rows=acts * forwards)
    elif mode == 'w8a8':
        want.update(yoco_vmm_int8=linears * forwards,
                    quantize_rows=(acts + linears) * forwards)
    return want


def _frontend_route_check(torch, build, cfg, params):
    """Greedy decode of 8 prompts of 128 (the config's synthetic input
    kind) over a contiguous f32 cache, in f32 compute on the served bf16
    weights (each cast per call), FRONTEND_ROUTE_STEPS steps through the
    flash route (K7 once a layer a step, nothing else) and through the
    einsum route from the same prefill: equal tokens at every step, every
    logit finite. The embeddings input's next-step row
    (``serve._step_input``) is made under ``set_sync_debug_mode('error')``:
    no host round trip."""
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.data import synthetic
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M

    b, plen, steps = STATIC_BATCH, STATIC_PROMPT, FRONTEND_ROUTE_STEPS
    f32 = torch.float32
    prompts = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=b, seq_len=plen), 0)['inputs'].to('cuda')
    yoco = YocoConfig(mode='bf16', compute_dtype=f32)
    cache = M.init_cache_tree(cfg, b, plen + steps, dtype=f32, device='cuda')
    logits0, cache = M.prefill(params, dict(inputs=prompts), cache, cfg,
                               yoco, M.ModelRuntime(compute_dtype=f32))
    ids = torch.arange(cfg.d_model, device='cuda')
    pos = torch.arange(plen, plen + steps, dtype=torch.int32, device='cuda')
    runs = {}
    copy = {ck: {k: v.clone() for k, v in leaves.items()}
            for ck, leaves in cache.items()}
    for impl, c in (('flash', copy), ('einsum', cache)):
        rt = M.ModelRuntime(attn_impl=impl, compute_dtype=f32)
        logits, toks, rows = logits0, [], []
        torch.cuda.synchronize()
        build.reset_counts()
        for i in range(steps):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode('error')
            try:
                step_in = SV._step_input(cfg, tok, ids)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            logits, c = M.decode_step(params, step_in, pos[i], c, cfg, yoco,
                                      rt)
            rows.append(logits)
        torch.cuda.synchronize()
        want = {'flash_decode_contig': cfg.n_layers * steps} \
            if impl == 'flash' else {}
        launched = {k: v for k, v in build.LAUNCHES.items() if v}
        check(launched == want, f'{cfg.name} f32 {impl} decode: launches '
                                f'{launched}, expected {want}')
        runs[impl] = (torch.stack(toks), torch.stack(rows))
    (tf, lf), (te, le) = runs['flash'], runs['einsum']
    check(bool(torch.isfinite(lf).all() and torch.isfinite(le).all()),
          f'{cfg.name} f32 decode: non-finite logits')
    row = dict(arch=cfg.name, check='f32 flash vs einsum decode', batch=b,
               context=plen, steps=steps,
               tokens_equal=bool(torch.equal(tf, te)),
               max_abs_logit_diff=float((lf - le).abs().max()),
               max_abs_logit=float(le.abs().max()),
               flash_launches=cfg.n_layers * steps)
    print(f'frontends check: {json.dumps(row)}', flush=True)
    check(row['tokens_equal'], f'{cfg.name}: f32 flash and einsum greedy '
                               f'tokens differ: {row}')
    return row


def frontends_phase(torch, build):
    """The two non-token frontends through the static ``serve()``.
    (1) Smoke configs, card against CPU (:func:`smoke_static_phase`, f32,
    lock-step and --ragged, flash) in bf16, w8a8 --prequantize and dynamic
    w8a8. (2) qwen2-vl-72b-L12 and musicgen-large at their published
    widths (random weights from seed 0, drawn in their serving form; batch
    8, prompt 128, generation 32), FRONTEND_RUNS in each mode, after a
    warm-up: every logits row finite, ``generated_shape`` [8, 32] (and 4
    codebooks for musicgen), exact launches (:func:`_frontend_launches`),
    each run's peak memory beside its weights' read bound; then the f32
    flash and einsum routes' tokens (:func:`_frontend_route_check`); the
    device busy share of each config's bf16 flash lock-step run.
    (3) qwen2-vl-72b's 80 layers: bf16 and dynamic w8a8 refused before any
    draw with their bytes; then 40 of them (VL40_ARCH) served with
    --prequantize, bf16 compute,
    flash: finite logits, exact launches, peak memory beside the card's
    total, ``decode_step_ms`` beside the int8 weights' read bound, its
    device busy share. Each
    model is freed before the next loads. Returns (rows, launch totals)."""
    import gc

    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_step as SS

    t0 = time.perf_counter()
    rows = []
    for arch in (VL_ARCH, MG_ARCH):
        rows += smoke_static_phase(torch, arch, modes=DENSE_MODES)
    print(f'frontends smoke: {json.dumps(rows)}', flush=True)
    totals = {k: 0 for k in build.LAUNCHES}
    dev = torch.device('cuda')
    bf16 = torch.bfloat16
    total_mem = torch.cuda.get_device_properties(0).total_memory

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() < MOE_FREED_BYTES,
              f'{torch.cuda.memory_allocated()} bytes still allocated '
              f'before a model loads')

    def measured(arch, tag, cfg, params, want, mode, prequant, impl, ragged,
                 sampling, profile=False, **extra):
        """One static serve at full width, held to its gates; its row, with
        ``extra`` and, with ``profile``, the device busy share of the same
        serve run again under torch.profiler."""
        finite = []
        kw = dict(smoke=False, batch=STATIC_BATCH, prompt_len=STATIC_PROMPT,
                  gen_len=STATIC_GEN, mode=mode, prequantize=prequant,
                  attn_impl=impl, ragged=ragged, greedy=sampling is None,
                  **(sampling or {}), params=params, quiet=True)
        torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        t_run = time.perf_counter()
        out = SV.serve(arch, step_hook=lambda logits, tok: finite.append(
            SS.logits_health(logits.flatten(0, -2))[0].all()), **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_run) * 1e3
        check(len(finite) == STATIC_GEN and bool(torch.stack(finite).all()),
              f'{tag}: a logits row is not finite')
        shape = [STATIC_BATCH, STATIC_GEN] + (
            [cfg.n_codebooks] if cfg.n_codebooks > 1 else [])
        check(out['generated_shape'] == shape,
              f'{tag}: generated_shape {out["generated_shape"]}')
        _check_launches(build, tag, want)
        for k in totals:
            totals[k] += build.LAUNCHES[k]
        weights = M.serving_bytes(cfg, mode, prequant, torch.bfloat16)
        rows.append(dict(
            arch=arch, mode=mode, prequantize=prequant, attn_impl=impl,
            ragged=ragged, sampling=sampling, batch=STATIC_BATCH,
            prompt_len=STATIC_PROMPT, gen_len=STATIC_GEN,
            tokens_per_s=out['tokens_per_s'], prefill_s=out['prefill_s'],
            decode_s=out['decode_s'],
            decode_step_ms=out['decode_s'] / (STATIC_GEN - 1) * 1e3,
            weight_bytes=weights,
            weight_read_bound_ms=weights / roofline.HBM_BW * 1e3,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            total_memory=total_mem, sample=out['sample'], wall_ms=wall_ms,
            launches={k: v for k, v in build.LAUNCHES.items() if v},
            **extra))
        if profile:
            def run():
                SV.serve(arch, **kw)
                torch.cuda.synchronize()
            by_name = profiled_kernels(torch, run)
            busy_ms = sum(v[0] for v in by_name.values()) if by_name \
                else None
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            rows[-1].update(
                device_busy_ms=busy_ms,
                device_busy_share=(None if busy_ms is None
                                   else busy_ms / wall_ms),
                kernel_launches=sum(v[1] for v in by_name.values()),
                top=[dict(kernel=k[:80], device_ms=v[0], calls=v[1])
                     for k, v in top])
        print(f'frontends run: {json.dumps(rows[-1])}', flush=True)

    for arch, widths in FRONTEND_ARCHS.items():
        cfg = configs.get(arch, smoke=False)
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
               cfg.n_codebooks) == widths,
              f'{arch} is not at its published width')
        for (mode, prequant), runs in FRONTEND_RUNS.items():
            params = None
            free()
            t_load = time.perf_counter()
            params = SV._serving_params(cfg, None, dev, seed=0, mode=mode,
                                        prequantize=prequant,
                                        compute_dtype=bf16)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t_load
            SV.serve(arch, smoke=False, batch=STATIC_BATCH,
                     prompt_len=STATIC_PROMPT, gen_len=2, mode=mode,
                     prequantize=prequant, params=params, quiet=True)
            for i, (impl, ragged, sampling) in enumerate(runs):
                tag = (f'frontends {arch} {mode} prequant={prequant} {impl} '
                       f'ragged={ragged} sampling={sampling}')
                # the first run of a mode: its load time; of bf16: its
                # device busy share
                measured(arch, tag, cfg, params,
                         _frontend_launches(cfg, mode, prequant, impl),
                         mode, prequant, impl, ragged, sampling,
                         profile=i == 0 and mode == 'bf16',
                         **(dict(load_s=load_s) if i == 0 else {}))
            if mode == 'bf16':
                rows.append(_frontend_route_check(torch, build, cfg, params))
        params = None
        free()
    # qwen2-vl-72b whole: refused in bf16 and dynamic w8a8 before any draw,
    # served with its int8 weights resident
    cfg = configs.get(VL_ARCH, smoke=False)
    check(cfg.n_layers == 80 and cfg.d_ff == 29568, f'{VL_ARCH} is not at '
                                                    f'its published depth')
    for mode, prequant in (('bf16', False), ('w8a8', False)):
        need = M.serving_bytes(cfg, mode, prequant, torch.bfloat16)
        free_bytes = torch.cuda.mem_get_info(dev)[0]
        try:
            SV.serve(VL_ARCH, smoke=False, mode=mode, batch=1,
                     prompt_len=8, gen_len=2, quiet=True)
        except ValueError as e:
            check(f'{need} bytes' in str(e),
                  f'{VL_ARCH} {mode}: refusal without the bytes: {e}')
            check(torch.cuda.memory_allocated() < MOE_FREED_BYTES,
                  f'{VL_ARCH} {mode}: weights were drawn before the '
                  f'refusal')
            rows.append(dict(arch=VL_ARCH, mode=mode, prequantize=prequant,
                             refused=str(e), weight_bytes=need,
                             free_bytes=free_bytes))
            print(f'frontends run: {json.dumps(rows[-1])}', flush=True)
        else:
            check(False, f'{VL_ARCH} {mode}: {need} bytes of weights were '
                         f'not refused')
    # the --prequantize serve at 40 of the 80 layers
    cfg = configs.get(VL40_ARCH, smoke=False)
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size)
          == (VL40_LAYERS, 8192, 29568, 152064),
          f'{VL40_ARCH} is not at its published width')
    torch.cuda.reset_peak_memory_stats()
    t_load = time.perf_counter()
    params = SV._serving_params(cfg, None, dev, seed=0, mode='w8a8',
                                prequantize=True, compute_dtype=bf16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t_load
    load_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    SV.serve(VL40_ARCH, smoke=False, batch=STATIC_BATCH,
             prompt_len=STATIC_PROMPT, gen_len=2, mode='w8a8',
             prequantize=True, attn_impl='flash', params=params, quiet=True)
    measured(VL40_ARCH, f'frontends {VL40_ARCH} w8a8 prequant flash',
             cfg, params, _frontend_launches(cfg, 'w8a8', True, 'flash'),
             'w8a8', True, 'flash', False, None, profile=True,
             load_s=load_s, load_peak_memory=load_peak,
             resident_weight_memory=resident, layers=cfg.n_layers)
    params = None
    free()
    rows.append(dict(phase_s=time.perf_counter() - t0))
    print(f'frontends phase: {rows[-1]["phase_s"]:.1f} s', flush=True)
    return rows, totals


# ----------------------------------------------------------------------------
# phase 5f: the paper-fidelity modes (qat, analog_sim) at full width
# ----------------------------------------------------------------------------
FIDELITY_PATH = f'{ARCH} fidelity modes'
FIDELITY_REQUESTS, FIDELITY_GEN = 8, 16
# (mode, prequantize, noise_seed, role, generated tokens): the two w8a8
# serves the others' tokens are compared with; analog_sim served twice at
# one seed and once, to its first decode step, at another; the 'measured'
# ones are served once more under torch.profiler for the busy share
FIDELITY_RUNS = (
    ('w8a8', False, 0, 'baseline', FIDELITY_GEN),
    ('qat', False, 0, 'measured', FIDELITY_GEN),
    ('analog_sim', False, 0, 'measured', FIDELITY_GEN),
    ('analog_sim', False, 0, 'same seed', FIDELITY_GEN),
    ('analog_sim', False, 1, 'other seed', 2),
    ('w8a8', True, 0, 'baseline', FIDELITY_GEN),
    ('analog_sim', True, 0, 'measured', FIDELITY_GEN),
)
# the reference's bounds: an analog_sim linear within 3% of full scale of
# its digital product (tests/test_yoco_linear.py), the analog VMM's total
# error 0.79% + 0.4% of the TDC's full scale (tests/test_analog.py)
ANALOG_LINEAR_BOUND = 0.03
ANALOG_VMM_BOUND = 0.0079 + 0.004
VMM_CHIPS = 256
VMM_TOL = 1e-5          # volts: a card-vs-CPU code flip must lie this close
                        # to a TDC boundary


class _DecodeLogits:
    """While active, keeps a copy of the logits of the first ``steps``
    decode steps of every ``serve_continuous`` (it wraps the decode step
    the serve builds)."""

    def __init__(self, SV, steps=2):
        self.rows, self._ss, self._steps = [], SV.SS, steps

    def __enter__(self):
        self._orig = self._ss.make_decode_step

        def make(*a, **k):
            step = self._orig(*a, **k)

            def tapped(*args):
                tok, logits, cache = step(*args)
                if len(self.rows) < self._steps:
                    self.rows.append(logits.float().clone())
                return tok, logits, cache
            return tapped
        self._ss.make_decode_step = make
        return self

    def __exit__(self, *exc):
        self._ss.make_decode_step = self._orig


def _token_share(a, b):
    """The share of generated token positions where two serves of one
    stream agree."""
    same = total = 0
    for rid, toks in a['outputs'].items():
        other = b['outputs'][rid]
        n = min(len(toks), len(other))
        same += sum(int(x == y) for x, y in zip(toks[:n], other[:n]))
        total += max(len(toks), len(other))
    return same / max(total, 1)


def _analog_linear_check(torch, trees):
    """Layer 0's seven linears at a decode activation (8 rows, bf16), each
    in analog_sim against w8a8 on the same weight (dynamic and with
    --prequantize): the largest difference over the w8a8 output's full
    scale must lie in (0, ANALOG_LINEAR_BOUND)."""
    from repro_torch.core import yoco_linear as yl
    bf16 = torch.bfloat16
    gen = torch.Generator(device='cuda').manual_seed(3)
    out = []
    for prequant, tree in trees:
        layer = tree['layers'][0]
        for grp, name in (('attn', 'wq'), ('attn', 'wk'), ('attn', 'wv'),
                          ('attn', 'wo'), ('mlp', 'w_gate'), ('mlp', 'w_up'),
                          ('mlp', 'w_down')):
            w = layer[grp][name]
            k = (w.wq if isinstance(w, yl.QuantizedWeight) else w).shape[0]
            x = torch.randn((8, 1, k), generator=gen, device='cuda',
                            dtype=torch.float32).to(bf16)
            yw, ya = (yl.linear(x, w, cfg=yl.YocoConfig(
                mode=mode, compute_dtype=bf16)).float()
                for mode in ('w8a8', 'analog_sim'))
            rel = float((ya - yw).abs().max() / yw.abs().max())
            check(0.0 < rel < ANALOG_LINEAR_BOUND,
                  f'analog_sim {name} (prequant={prequant}): {rel} of full '
                  f'scale from its w8a8 output, outside (0, '
                  f'{ANALOG_LINEAR_BOUND})')
            out.append(dict(linear=name, prequantize=prequant, K=k,
                            rel_to_w8a8=rel))
    return out


def _analog_vmm_check(torch):
    """The paper's 1024 x 256 VMM, x of 64 rows, on the card: ideal
    circuits within one code of the exact product's codes; over
    VMM_CHIPS Monte-Carlo chips (each with its thermal and share-line
    draws) the worst code error within ANALOG_VMM_BOUND of the TDC's
    full scale; and two chips' draws replayed on the CPU give the card's
    codes, up to one-step flips whose volts lie within VMM_TOL of a TDC
    boundary."""
    from repro_torch.core import analog
    gen = torch.Generator(device='cuda').manual_seed(7)
    x = torch.randint(0, 256, (64, 1024), generator=gen, device='cuda')
    w = torch.randint(0, 256, (1024, 256), generator=gen, device='cuda')
    ideal = analog.analog_vmm_ideal_codes(x, w)
    ideal_err = int((analog.analog_vmm(x, w) - ideal).abs().max())
    check(ideal_err <= 1, f'analog_vmm with ideal circuits is {ideal_err} '
                          f'codes from the exact product')
    errs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(VMM_CHIPS):
        chip_gen = torch.Generator(device='cuda').manual_seed(1000 + c)
        errs.append((analog.analog_vmm(x, w, chip_gen) - ideal).abs().amax())
    errs = torch.stack(errs).double() / 255.0
    torch.cuda.synchronize()
    vmm_ms = (time.perf_counter() - t0) * 1e3 / VMM_CHIPS
    worst = float(errs.max())
    check(worst <= ANALOG_VMM_BOUND, f'analog_vmm: worst code error '
                                     f'{worst} of full scale over '
                                     f'{VMM_CHIPS} chips > '
                                     f'{ANALOG_VMM_BOUND}')
    flips = []
    full_scale = 1024 // analog.MACRO_ROWS * analog.VDD
    for c in range(2):
        chip, normals = analog.vmm_draws(
            torch.Generator(device='cuda').manual_seed(1000 + c), (64,),
            1024, 256)
        card, volts = analog.analog_vmm(x, w, chip=chip, normals=normals,
                                        return_volts=True)
        chip_cpu = analog.ChipSample(**{
            k: v.cpu() for k, v in vars(chip).items()})
        mine = analog.analog_vmm(x.cpu(), w.cpu(), chip=chip_cpu,
                                 normals=[n.cpu() for n in normals])
        step = (mine - card.cpu()).abs()
        lvl = volts.cpu().double() / full_scale * 255
        near = (lvl - lvl.floor() - 0.5).abs() <= VMM_TOL / full_scale * 255
        check(int(step.max()) <= 1 and bool(near[step > 0].all()),
              f'analog_vmm chip {c}: card and CPU codes differ beyond '
              f'boundary flips ({int((step > 0).sum())} codes, max step '
              f'{int(step.max())})')
        flips.append(int((step > 0).sum()))
    check(sum(flips) <= max(4, 2 * x.shape[0] * w.shape[1] // 100),
          f'analog_vmm: {flips} boundary flips card vs CPU')
    return dict(shape=dict(M=64, K=1024, N=256), chips=VMM_CHIPS,
                worst_rel_code_err=worst,
                mean_rel_code_err=float(errs.mean()),
                bound=ANALOG_VMM_BOUND, ideal_max_code_err=ideal_err,
                ms_per_vmm=vmm_ms, card_vs_cpu_flips=flips)


def _ste_backward_check(torch):
    """One qat and one w8a8 linear's straight-through backward at
    stablelm's width (8 rows, K = N = 2048, f32, a K-major weight), card
    against CPU: equal forward, gradients within 1e-5 of their full
    scale (float matmuls in another order)."""
    from repro_torch.core import yoco_linear as yl
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((8, 2048), generator=gen)
    w = yl.k_major(torch.randn((2048, 2048), generator=gen) / 2048 ** 0.5)
    g = torch.randn((8, 2048), generator=gen)
    out = []
    for mode in ('qat', 'w8a8'):
        res = {}
        for dev in ('cuda', 'cpu'):
            # new leaves (on the CPU ``to`` returns the tensor itself)
            xt = x.to(dev).detach().requires_grad_()
            wt = w.to(dev).detach().requires_grad_()
            y = yl.linear(xt, wt, cfg=yl.YocoConfig(
                mode=mode, compute_dtype=torch.float32))
            (y * g.to(dev)).sum().backward()
            res[dev] = [t.detach().cpu() for t in (y, xt.grad, wt.grad)]
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(res['cuda'], res['cpu'])]
        check(max(errs) <= 1e-5, f'{mode} STE backward: card vs CPU '
                                 f'(y, dx, dw) differ by {errs} of full '
                                 f'scale')
        out.append(dict(mode=mode, rel_err_y_dx_dw=errs))
    return out


def fidelity_phase(torch, build):
    """The paper-fidelity modes at stablelm-1.6b's published width
    (random weights from seed 0, f32 masters stored K-major for the dynamic
    modes, int8 with --prequantize): ``serve_continuous`` of 8 requests of
    128-token prompts, 16 generated, page 8, in each of FIDELITY_RUNS after
    a warm-up a mode. Gates: every request finishes, no lane has a
    non-finite logits row, K1-K4 launched exactly as the mode must
    (:func:`_gqa_launches`), analog_sim served twice at one noise seed
    gives equal tokens and at another seed different logits, layer 0's
    linears in analog_sim within (0, 3%) of their w8a8 outputs
    (:func:`_analog_linear_check`), the analog VMM at the paper's size
    (:func:`_analog_vmm_check`) and the STE backward passes
    (:func:`_ste_backward_check`). Reports each serve's tokens_per_s,
    decode_step_ms, the share of its tokens equal to w8a8's, and the
    device busy share of the measured ones under torch.profiler. Returns
    (rows, launch totals)."""
    import gc

    from repro_torch import configs
    from repro_torch.core import yoco_linear as yl
    from repro_torch.data import synthetic
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    cfg = configs.get(ARCH, smoke=False)
    base = M.init_params(torch.Generator(device='cuda').manual_seed(0), cfg,
                         device='cuda')
    trees = {False: M.k_major_linear_weights(base),
             True: yl.quantize_tree(base)}
    del base
    gc.collect()
    prompts = synthetic.make_batch(synthetic.for_arch(
        cfg, global_batch=FIDELITY_REQUESTS, seq_len=128), 0)['inputs']
    prompts = prompts.numpy()

    def stream(gen=FIDELITY_GEN):
        return [SV.Request(rid=i, prompt=prompts[i], target_gen=gen)
                for i in range(FIDELITY_REQUESTS)]

    totals = {k: 0 for k in build.LAUNCHES}
    rows, outs, warmed = [], {}, set()
    for mode, prequant, seed, role, gen in FIDELITY_RUNS:
        kw = dict(smoke=False, slots=8, prompt_len=128, gen_len=gen,
                  page_size=8, mode=mode, prequantize=prequant,
                  noise_seed=seed, attn_impl='flash',
                  params=trees[prequant], quiet=True)
        if (mode, prequant) not in warmed:
            SV.serve_continuous(ARCH, n_requests=1, **dict(kw, gen_len=2))
            warmed.add((mode, prequant))
        torch.cuda.synchronize()
        tag = (f'fidelity {ARCH} {mode} prequant={prequant} '
               f'noise_seed={seed}')
        build.reset_counts()
        t_run = time.perf_counter()
        with _DecodeLogits(SV) as tap:
            out = SV.serve_continuous(ARCH, request_stream=stream(gen), **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_run) * 1e3
        launches = dict(build.LAUNCHES)
        check(out['completed'] == FIDELITY_REQUESTS and out['failed'] == 0
              and out['rejected'] == 0 and out['cancelled'] == 0,
              f'{tag}: not every request finished: {out["events"]}')
        check(out['quarantined'] == 0,
              f'{tag}: {out["quarantined"]} lanes had non-finite logits')
        check(all(bool(torch.isfinite(r).all()) for r in tap.rows),
              f'{tag}: non-finite decode logits')
        want = {k: 0 for k in build.LAUNCHES}
        want.update(_gqa_launches(out, mode, prequant, 0, 0))
        for name, n in want.items():
            check(launches[name] == n,
                  f'{tag}: {name} launched {launches[name]} times, '
                  f'expected {n} ({out["steps"]} decode steps)')
        for k in totals:
            totals[k] += launches[k]
        outs[(mode, prequant, seed, role)] = out, tap.rows
        baseline = outs[('w8a8', prequant, 0, 'baseline')][0]
        decode_s = out['wall_s'] - out['prefill_s']
        row = dict(
            arch=ARCH, mode=mode, prequantize=prequant, noise_seed=seed,
            role=role, slots=8, requests=FIDELITY_REQUESTS, prompt_len=128,
            gen_len=gen, tokens_per_s=out['tokens_per_s'],
            wall_s=out['wall_s'], prefill_s=out['prefill_s'],
            steps=out['steps'],
            decode_step_ms=decode_s / max(out['steps'], 1) * 1e3,
            tokens_equal_to_w8a8=(_token_share(out, baseline)
                                  if gen == FIDELITY_GEN else None),
            launches={k: v for k, v in launches.items() if v})
        if role == 'measured':
            # the device busy share: the kernels' summed device time under
            # torch.profiler over the wall time of the run above
            by_name = profiled_kernels(torch, lambda: SV.serve_continuous(
                ARCH, request_stream=stream(), **kw))
            busy_ms = sum(v[0] for v in by_name.values()) if by_name \
                else None
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            row.update(wall_ms=wall_ms, device_busy_ms=busy_ms,
                       device_busy_share=(None if busy_ms is None
                                          else busy_ms / wall_ms),
                       kernel_launches=sum(v[1] for v in by_name.values()),
                       top=[dict(kernel=k[:80], device_ms=v[0], calls=v[1])
                            for k, v in top])
        rows.append(row)
        print(f'fidelity run: {json.dumps(row)}', flush=True)
    (a, la), (b, lb), (c, lc) = (
        outs[('analog_sim', False, s, r)] for s, r in
        ((0, 'measured'), (0, 'same seed'), (1, 'other seed')))
    check(a['outputs'] == b['outputs'], 'analog_sim served twice at noise '
                                        'seed 0 gave different tokens')
    # the first decode step: the other-seed serve stops after it
    check(not torch.equal(la[0], lc[0]),
          'analog_sim at noise seeds 0 and 1 gave equal decode logits')
    seeds = dict(same_seed_tokens_equal=True,
                 same_seed_logits_equal=all(bool(torch.equal(x, y))
                                            for x, y in zip(la, lb)),
                 other_seed_max_logit_diff=float((la[0] - lc[0]).abs().max()))
    rows.append(dict(noise_seeds=seeds))
    print(f'fidelity seeds: {json.dumps(seeds)}', flush=True)
    rows.append(dict(analog_linears=_analog_linear_check(
        torch, sorted(trees.items()))))
    print(f'fidelity linears: {json.dumps(rows[-1])}', flush=True)
    del trees, outs
    gc.collect()
    torch.cuda.empty_cache()
    rows.append(dict(analog_vmm=_analog_vmm_check(torch)))
    print(f'fidelity vmm: {json.dumps(rows[-1])}', flush=True)
    rows.append(dict(ste_backward=_ste_backward_check(torch)))
    print(f'fidelity ste: {json.dumps(rows[-1])}', flush=True)
    rows.append(dict(phase_s=time.perf_counter() - t0))
    print(f'fidelity phase: {rows[-1]["phase_s"]:.1f} s', flush=True)
    return rows, totals


# ----------------------------------------------------------------------------
# phase 5g: training (the train step, the trainer) on stablelm-1.6b
# ----------------------------------------------------------------------------
TRAIN_PATH = f'{ARCH} train'
# full width: global batch 8 of 256 tokens, 8 AdamW steps a mode
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 8
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ       # M of every training linear
TRAIN_MODES = ('bf16', 'qat', 'w8a8')
TRAIN_LR = 1e-3
# one train step on the card against the CPU's at smoke size: (arch, mode,
# grad_accum)
TRAIN_SMOKE = (tuple((ARCH, m, a) for m in ('bf16', 'qat', 'w8a8',
                                           'analog_sim') for a in (1, 2))
               + ((MOE_ARCH, 'bf16', 1), (SSM_ARCH, 'bf16', 1)))
# the CPU tests' bounds (tests/test_torch_train_step.py): loss and grad
# norm relative, the share of params off by more than 1e-6, each at most
# 2.2 lr off (a sign flip of the first AdamW step plus the decay)
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_PARAM_SHARE = 1e-3, 5e-3, 0.03
# the activation widths and weights (K, N) of stablelm's training linears:
# q/k/v/o, MLP in (gate, up), MLP down, lm_head
TRAIN_ACT_KS = (2048, 5632)
TRAIN_WEIGHTS = ((2048, 2048), (2048, 5632), (5632, 2048), (2048, 100352))


def _linear_masters(tree):
    """(name, tensor) of every linear weight of a param-shaped tree."""
    from repro_torch.core.yoco_linear import is_linear_weight
    out = []

    def walk(node, name=''):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, name)
        elif is_linear_weight(name, node):
            out.append((name, node))
    walk(tree)
    return out


def _train_step_pair(torch, arch, mode, accum):
    """One ``make_train_step`` step from the trainer's seed-0 params and
    the port's batch 0 (4 x 16 tokens) on the card and on the CPU (which
    replays the card's analog draws); held to the CPU tests' bounds."""
    from repro_torch import configs
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.data import synthetic
    from repro_torch.launch.train import init_state
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_step as TS

    cfg = configs.get(arch, smoke=True)
    opt = adamw.OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10,
                          grad_accum=accum)
    batch = synthetic.make_batch(synthetic.for_arch(cfg, global_batch=4,
                                                    seq_len=16), 0)
    host, _ = init_state(cfg, opt, 0, 'cpu')
    out, draws = {}, None
    for dev in ('cuda', 'cpu'):
        params = adamw.tree_map(lambda t: t.to(dev, copy=True), host)
        state = adamw.init(params, opt)
        with _AnalogDraws(draws, follow_codes=False) as an:
            params, state, m = TS.make_train_step(
                cfg, YocoConfig(mode=mode), opt_cfg=opt)(
                params, state, {k: v.to(dev) for k, v in batch.items()})
        draws = an
        out[dev] = (M.params_to_numpy(params, cfg),
                    {k: float(v) for k, v in m.items()})
    tag = f'train smoke {arch} {mode} grad_accum={accum}'
    (pg, mg), (pc, mc) = out['cuda'], out['cpu']
    loss_err = abs(mg['loss'] - mc['loss']) / abs(mc['loss'])
    gn_err = abs(mg['grad_norm'] - mc['grad_norm']) / mc['grad_norm']
    check(loss_err <= TRAIN_LOSS_TOL, f'{tag}: loss {mg["loss"]} on the '
                                      f'card, {mc["loss"]} on the CPU')
    check(gn_err <= TRAIN_GNORM_TOL, f'{tag}: grad norm {mg["grad_norm"]} '
                                     f'on the card, {mc["grad_norm"]} on '
                                     f'the CPU')
    check(abs(mg['lr'] - mc['lr']) <= 1e-9, f'{tag}: learning rates differ')
    off = total = 0
    worst = 0.0

    def walk(a, b):
        nonlocal off, total, worst
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
            return
        d = np.abs(a - b)
        off += int((d > 1e-6).sum())
        total += d.size
        worst = max(worst, float(d.max()))
    walk(pg, pc)
    check(worst <= 2.2 * TRAIN_LR and off <= TRAIN_PARAM_SHARE * total,
          f'{tag}: {off} of {total} params off by > 1e-6, the worst by '
          f'{worst}')
    check(mode != 'analog_sim' or len(draws.draws) > 0,
          f'{tag}: no analog draw replayed')
    return dict(arch=arch, mode=mode, grad_accum=accum, loss=mg['loss'],
                loss_rel_err=loss_err, grad_norm_rel_err=gn_err,
                params_off=off, params=total, worst_param_err=worst,
                tol=dict(loss=TRAIN_LOSS_TOL, grad_norm=TRAIN_GNORM_TOL,
                         share=TRAIN_PARAM_SHARE, param=2.2 * TRAIN_LR))


def _resume_runs(torch, root, deterministic):
    """The trainer on the card at smoke size: 10 steps uninterrupted, and
    the same 10-step run through the CLI killed at step 6 (after its
    step-6 checkpoint; ``ckpt_every=3``), then resumed by ``train()`` to
    step 10. Returns (uninterrupted losses, resumed losses at 6-9)."""
    import shutil

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch import train as T

    shutil.rmtree(root, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=SRC)
    pre = ''
    if deterministic:
        env['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
        os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
        pre = 'import torch; torch.use_deterministic_algorithms(True); '
    torch.use_deterministic_algorithms(deterministic)
    try:
        kw = dict(smoke=True, steps=10, global_batch=8, seq_len=64,
                  quiet=True, device='cuda')
        whole = T.train(ARCH, ckpt_every=0, ckpt_dir=os.path.join(
            root, 'whole'), **kw)
        run = os.path.join(root, 'run')
        code = (pre + 'from repro_torch.launch.train import main; main('
                + repr(['--steps', '10', '--ckpt-every', '3',
                        '--simulate-failure-at', '6', '--ckpt-dir', run,
                        '--global-batch', '8', '--seq-len', '64']) + ')')
        r = subprocess.run([sys.executable, '-c', code], env=env, cwd=HERE,
                           capture_output=True, text=True, timeout=600)
        check(r.returncode == 17 and '[failure-sim] dying at step 6'
              in r.stdout, f'train CLI: exit {r.returncode}, expected 17: '
                           f'{r.stdout[-2000:]} {r.stderr[-2000:]}')
        check(CheckpointManager(run).latest_step() == 6,
              'train CLI: the step-6 checkpoint is not the latest')
        rest = T.train(ARCH, ckpt_every=3, ckpt_dir=run, **kw)
        check(rest['steps_run'] == 4, f'train resume ran '
                                      f'{rest["steps_run"]} steps, not 4')
        return whole['history'], rest['history']
    finally:
        torch.use_deterministic_algorithms(False)


def _train_resume_check(torch):
    """The resumed losses at steps 6-9 against the uninterrupted run's:
    bit for bit by default, else under torch.use_deterministic_algorithms,
    which must then give them bit for bit."""
    root = os.path.join(OUT_DIR, 'train_ckpt')
    whole, rest = _resume_runs(torch, root, deterministic=False)
    row = dict(uninterrupted=whole, resumed=rest,
               bit_equal=rest == whole[6:], deterministic_needed=False)
    if not row['bit_equal']:
        row['max_rel_diff'] = max(abs(a - b) / abs(b)
                                  for a, b in zip(rest, whole[6:]))
        whole, rest = _resume_runs(torch, root, deterministic=True)
        row.update(deterministic_needed=True, deterministic_uninterrupted=whole,
                   deterministic_resumed=rest,
                   deterministic_bit_equal=rest == whole[6:])
        check(row['deterministic_bit_equal'],
              f'train resume: losses at steps 6-9 {rest} differ from the '
              f'uninterrupted run\'s {whole[6:]} even under '
              f'torch.use_deterministic_algorithms')
    return row


def train_kernel_rows(torch, kmods):
    """K3 and K4 at the training shapes (M = 8 x 256 rows), bit-exact
    against their plain versions and timed: K3 on the bf16 activations
    (K = 2048, 5632) and on the bf16 casts of the K-major linear masters
    (their transposes read in place: N x K rows), K4 on those codes, beside
    torch._int_mm on the same int8 operands (no scale epilogue)."""
    fd, kq, ky, build = kmods
    del fd, build
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16, m = torch.bfloat16, TRAIN_ROWS
    rows = []
    src_q, rep_q = ('src/repro_torch/csrc/quantize.cu',
                    'src/repro/kernels/quantize.py:35')
    src_v, rep_v = ('src/repro_torch/csrc/yoco_vmm.cu',
                    'src/repro/kernels/yoco_vmm.py:65')

    def k3(x, shape):
        xq, sx = kq.quantize_rows(x)
        xq_p, sx_p = kq.quantize_rows_plain(x)
        torch.cuda.synchronize()
        check(bool(torch.equal(xq, xq_p) and torch.equal(sx, sx_p)),
              f'K3 {shape} not bit-exact')
        r, k = x.shape
        record_row(torch, rows, 'quantize_rows', shape, 0.0, 0.0,
                   lambda: kq.quantize_rows(x),
                   lambda: kq.quantize_rows_plain(x), None,
                   r * k * 2 + r * k + r * 4, source=src_q, replaces=rep_q)
        return xq, sx

    acts = {}
    for k in TRAIN_ACT_KS:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        acts[k] = k3(x, dict(arch=ARCH, path='train', operand='activation',
                             M=m, K=k, dtype='bfloat16'))
    for k, n in TRAIN_WEIGHTS:
        # the bf16 cast of a K-major master: its transpose, (N, K)
        # contiguous, is what K3 reads
        wt = (torch.randn((n, k), generator=gen, device=dev)
              * k ** -0.5).to(bf16)
        wq_t, sw_t = k3(wt, dict(arch=ARCH, path='train', operand='weight',
                                 M=n, K=k, dtype='bfloat16'))
        xq, sx = acts[k]
        wq, sw = wq_t.t(), sw_t.reshape(1, n)
        y = ky.yoco_vmm_int8(xq, wq, sx, sw)
        y_p = ky.yoco_vmm_int8_plain(xq, wq, sx, sw)
        torch.cuda.synchronize()
        check(bool(torch.equal(y, y_p)),
              f'K4 ({m},{k},{n}) differs from its plain version')
        del y, y_p
        record_row(torch, rows, 'yoco_vmm_int8',
                   dict(arch=ARCH, path='train', M=m, K=k, N=n), 0.0, 0.0,
                   lambda: ky.yoco_vmm_int8(xq, wq, sx, sw),
                   lambda: ky.yoco_vmm_int8_plain(xq, wq, sx, sw),
                   lambda: torch._int_mm(xq, wq),
                   m * k + k * n + 4 * (m + n) + 4 * m * n, 2.0 * m * k * n,
                   source=src_v, replaces=rep_v, plain_iters=3)
        del wt, wq_t, sw_t, wq, sw
    return rows


def train_counts(mode):
    """K3 and K4 launches one stablelm forward makes in ``mode`` (the
    backward makes none): qat and w8a8 quantize every distinct activation
    and every weight transpose, w8a8 runs every linear on K4; bf16 runs
    neither."""
    if mode == 'bf16':
        return dict(quantize_rows=0, yoco_vmm_int8=0)
    return dict(quantize_rows=ACTIVATIONS_PER_FORWARD + LINEARS_PER_FORWARD,
                yoco_vmm_int8=LINEARS_PER_FORWARD if mode == 'w8a8' else 0)


def train_phase(torch, kmods):
    """Training on the card (the port's ``make_train_step`` and trainer).
    (1) One step at smoke size on the card against the CPU
    (TRAIN_SMOKE: stablelm in every mode with grad_accum 1 and 2,
    qwen2-moe and mamba2 in bf16), to the CPU tests' bounds. (2) The
    trainer at smoke size: 10 steps uninterrupted, and the CLI killed at
    step 6 and resumed to 10, the resumed losses equal to the
    uninterrupted run's. (3) stablelm-1.6b at its published width and
    depth: TRAIN_STEPS steps of global batch TRAIN_BATCH x TRAIN_SEQ from
    the port's data stream in each of TRAIN_MODES (``OptConfig(lr=1e-3,
    warmup_steps=1, total_steps=8)``): every loss finite, the last below
    the first, K3/K4 launched exactly ``train_counts`` a step (nothing
    else), every linear master and its moments K-major after the last
    step; step ms (median of steps 2-8), tokens/s, peak memory, the busy
    share of one more step under torch.profiler, and 6 N tokens a step
    over the card's dense bf16 peak. (4) K3/K4 rows at the training
    shapes (:func:`train_kernel_rows`). Returns (rows, launch totals,
    kernel rows)."""
    import gc

    from repro_torch import configs
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.data import synthetic
    from repro_torch.launch.train import init_state
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_step as TS

    build = kmods[3]
    t0 = time.perf_counter()
    rows = [dict(smoke=[_train_step_pair(torch, *case)
                        for case in TRAIN_SMOKE])]
    print(f'train smoke: {json.dumps(rows[-1])}', flush=True)
    rows.append(dict(resume=_train_resume_check(torch)))
    print(f'train resume: {json.dumps(rows[-1])}', flush=True)

    cfg = configs.get(ARCH, smoke=False)
    check(cfg.n_layers == LAYERS_FULL and cfg.d_model == 2048
          and cfg.vocab_size == 100352, f'{ARCH} is not at its published '
                                        f'width and depth')
    dc = synthetic.for_arch(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    batches = [{k: v.to('cuda') for k, v in
                synthetic.make_batch(dc, s).items()}
               for s in range(TRAIN_STEPS + 1)]
    totals = {k: 0 for k in build.LAUNCHES}
    for mode in TRAIN_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() < MOE_FREED_BYTES,
              f'{torch.cuda.memory_allocated()} bytes still allocated '
              f'before a model loads')
        tag = f'train {ARCH} {mode}'
        opt = adamw.OptConfig(lr=TRAIN_LR, warmup_steps=1,
                              total_steps=TRAIN_STEPS)
        params, state = init_state(cfg, opt, 0, 'cuda')
        n_params = M.param_count(params)
        step = TS.make_train_step(cfg, YocoConfig(mode=mode), opt_cfg=opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        losses, ms = [], []
        for s in range(TRAIN_STEPS):
            t_step = time.perf_counter()
            params, state, metrics = step(params, state, batches[s])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t_step) * 1e3)
            losses.append(float(metrics['loss']))
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f'{tag}: a loss is not finite: '
                                        f'{losses}')
        check(losses[-1] < losses[0], f'{tag}: the loss did not fall: '
                                      f'{losses}')
        want = {k: 0 for k in build.LAUNCHES}
        want.update({k: v * TRAIN_STEPS for k, v in train_counts(mode)
                     .items()})
        for name, n in want.items():
            check(launches[name] == n, f'{tag}: {name} launched '
                                       f'{launches[name]} times, expected {n}')
        for k in totals:
            totals[k] += launches[k]
        bad = [name for tree in (params, state.mu, state.nu)
               for name, w in _linear_masters(tree)
               if not w.t().is_contiguous()]
        check(not bad, f'{tag}: linear masters or moments no longer '
                       f'K-major: {bad}')
        step_ms = _median(ms[1:])

        def one_step():
            step(params, state, batches[TRAIN_STEPS])
            torch.cuda.synchronize()
        by_name = profiled_kernels(torch, one_step)
        busy_ms = sum(v[0] for v in by_name.values()) if by_name else None
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        flops = 6.0 * n_params * TRAIN_ROWS
        rows.append(dict(
            arch=ARCH, mode=mode, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            steps=TRAIN_STEPS, params=n_params, losses=losses, step_ms=ms,
            median_step_ms=step_ms,
            tokens_per_s=TRAIN_ROWS / (step_ms / 1e3),
            max_memory_allocated=peak,
            device_busy_ms=busy_ms,
            device_busy_share=(None if busy_ms is None
                               else busy_ms / step_ms),
            kernel_launches=sum(v[1] for v in by_name.values()),
            model_flops=flops,
            bf16_peak_share=(flops / (step_ms / 1e3)
                             / roofline.PEAK_FLOPS_BF16),
            launches={k: v for k, v in launches.items() if v},
            top=[dict(kernel=k[:80], device_ms=v[0], calls=v[1])
                 for k, v in top]))
        print(f'train run: {json.dumps(rows[-1])}', flush=True)
        params = state = step = metrics = None
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    kernel_rows = train_kernel_rows(torch, kmods)
    print(f'train kernel rows: {len(kernel_rows)}', flush=True)
    rows.append(dict(phase_s=time.perf_counter() - t0))
    print(f'train phase: {rows[-1]["phase_s"]:.1f} s', flush=True)
    return rows, totals, kernel_rows


# the static serve() runs at full width: (arch, mode, prequantize,
# attn_impl, ragged, sampling)
STATIC_RUNS = (
    (ARCH, 'bf16', False, 'flash', False, None),
    (ARCH, 'bf16', False, 'flash', True, None),
    (ARCH, 'bf16', False, 'einsum', True, None),
    (ARCH, 'w8a8', True, 'flash', True, None),
    (ARCH, 'bf16', False, 'flash', True, dict(temperature=0.8, top_k=40)),
    # temperature 0 is the argmax: its tokens must equal run 0's
    (ARCH, 'bf16', False, 'flash', False, dict(temperature=0.0)),
    (MLA_ARCH, 'bf16', False, 'einsum', False, None),
    (ARCH, 'w8a8', False, 'flash', True, None),
)


def static_serve_phase(torch, build):
    """The static ``serve()`` path at the published width (random weights
    from a seed), each of STATIC_RUNS once after a warm-up per model, then
    qwen2-moe-a2.7b in bf16 flash lock-step (its K7 launches returned on
    their own: the MoE static path's). Gates:
    every logits row finite, ``generated_shape == [8, 32]``, K7 launched
    exactly 24 * 31 = 744 times per flash run and never by einsum, no paged
    kernel launched, K2 169 and K3 97 times per forward with
    --prequantize, K4 169 and K3 266 times per forward in dynamic w8a8,
    and the
    temperature-0 run's tokens equal to the greedy flash run's.
    Then the device busy share of the bf16 flash lock-step run and of the
    dynamic w8a8 flash --ragged run. Returns (rows, launch totals, the
    qwen2-moe run's launches)."""
    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_step as SS

    kw = dict(smoke=False, batch=STATIC_BATCH, prompt_len=STATIC_PROMPT,
              quiet=True)
    params = {}
    for arch in (ARCH, MLA_ARCH):
        cfg = configs.get(arch, smoke=False)
        params[arch] = M.init_params(
            torch.Generator(device='cuda').manual_seed(0), cfg,
            device='cuda')
        # warm-up (library handles, allocator) outside the measured runs
        SV.serve(arch, gen_len=2, params=params[arch], **kw)
        torch.cuda.synchronize()
    totals = {k: 0 for k in build.LAUNCHES}
    results, tokens = [], []
    for arch, mode, prequant, impl, ragged, sampling in STATIC_RUNS:
        finite = []
        build.reset_counts()
        out = SV.serve(arch, gen_len=STATIC_GEN, mode=mode,
                       prequantize=prequant, attn_impl=impl, ragged=ragged,
                       greedy=sampling is None, **(sampling or {}),
                       params=params[arch],
                       step_hook=lambda logits, tok: finite.append(
                           SS.logits_health(logits)[0].all()), **kw)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        tokens.append(out['tokens'])
        tag = (f'static serve {arch} {mode} prequant={prequant} {impl} '
               f'ragged={ragged} sampling={sampling}')
        check(len(finite) == STATIC_GEN and bool(torch.stack(finite).all()),
              f'{tag}: a logits row is not finite')
        check(out['generated_shape'] == [STATIC_BATCH, STATIC_GEN],
              f'{tag}: generated_shape {out["generated_shape"]}')
        layers = configs.get(arch, smoke=False).n_layers
        want = {k: 0 for k in build.LAUNCHES}
        if impl == 'flash':
            want['flash_decode_contig'] = layers * (STATIC_GEN - 1)
        linears = LINEARS_PER_FORWARD * STATIC_GEN
        activations = ACTIVATIONS_PER_FORWARD * STATIC_GEN
        if mode == 'w8a8' and prequant:
            want.update(quantize_rows=activations, int8_matmul=linears)
        elif mode == 'w8a8':
            want.update(quantize_rows=activations + linears,
                        yoco_vmm_int8=linears)
        for name, n in want.items():
            check(launches[name] == n, f'{tag}: {name} launched '
                                       f'{launches[name]} times, expected {n}')
        for k in totals:
            totals[k] += launches[k]
        results.append(dict(
            arch=arch, mode=mode, prequantize=prequant, attn_impl=impl,
            ragged=ragged, sampling=sampling, batch=STATIC_BATCH,
            prompt_len=STATIC_PROMPT, gen_len=STATIC_GEN,
            tokens_per_s=out['tokens_per_s'], prefill_s=out['prefill_s'],
            decode_s=out['decode_s'],
            decode_step_ms=out['decode_s'] / (STATIC_GEN - 1) * 1e3,
            prompt_lens=out.get('prompt_lens'), sample=out['sample'],
            launches={k: v for k, v in launches.items() if v}))
        print(f'static serve run: {json.dumps(results[-1])}', flush=True)
    check(np.array_equal(tokens[5], tokens[0]),
          'static serve: temperature-0 tokens differ from the greedy run\'s')
    # the device busy share of the bf16 flash lock-step run and of the
    # dynamic w8a8 flash --ragged run (its load stores the weights K-major
    # once, inside the call): their kernels' summed device time under
    # torch.profiler over the wall time of the same run bare (None where
    # the profiler records no device kernel)
    for label, opts in (('bf16 flash lock-step', {}),
                        ('dynamic w8a8 flash --ragged',
                         dict(mode='w8a8', ragged=True))):
        def run(opts=opts):
            SV.serve(ARCH, gen_len=STATIC_GEN, attn_impl='flash',
                     params=params[ARCH], **opts, **kw)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = profiled_kernels(torch, run)
        busy_ms = sum(v[0] for v in by_name.values()) if by_name else None
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        results.append(dict(
            profile=label, wall_ms=wall_ms, device_busy_ms=busy_ms,
            device_busy_share=None if busy_ms is None else busy_ms / wall_ms,
            kernel_launches=sum(v[1] for v in by_name.values()),
            top=[dict(kernel=k[:80], device_ms=v[0], calls=v[1])
                 for k, v in top]))
        print(f'static serve profile: {json.dumps(results[-1])}',
              flush=True)
    # information, not a gate: bf16 rounds differently on the two routes
    agree = float((tokens[1] == tokens[2]).mean())
    print(f'static serve: flash vs einsum token agreement (ragged, bf16): '
          f'{agree}', flush=True)
    results.append(dict(flash_vs_einsum_token_agreement=agree))
    # qwen2-moe at its published width, bf16 flash lock-step (K7 at its
    # heads), once the two f32 trees above are freed: its weights drawn in
    # their serving form, every expert on every one of the prefill's 1,024
    # tokens
    import gc
    params = None
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get(MOE_ARCH, smoke=False)
    moe_params = SV._serving_params(cfg, None, torch.device('cuda'), seed=0,
                                    mode='bf16', prequantize=False,
                                    compute_dtype=torch.bfloat16)
    SV.serve(MOE_ARCH, gen_len=2, params=moe_params, **kw)     # warm-up
    torch.cuda.synchronize()
    finite = []
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    out = SV.serve(MOE_ARCH, gen_len=STATIC_GEN, attn_impl='flash',
                   params=moe_params,
                   step_hook=lambda logits, tok: finite.append(
                       SS.logits_health(logits)[0].all()), **kw)
    torch.cuda.synchronize()
    moe_totals = dict(build.LAUNCHES)
    tag = f'static serve {MOE_ARCH} bf16 flash'
    check(len(finite) == STATIC_GEN and bool(torch.stack(finite).all()),
          f'{tag}: a logits row is not finite')
    check(out['generated_shape'] == [STATIC_BATCH, STATIC_GEN],
          f'{tag}: generated_shape {out["generated_shape"]}')
    want = {k: 0 for k in build.LAUNCHES}
    want['flash_decode_contig'] = cfg.n_layers * (STATIC_GEN - 1)
    for name, n in want.items():
        check(moe_totals[name] == n, f'{tag}: {name} launched '
                                     f'{moe_totals[name]} times, expected '
                                     f'{n}')
    results.append(dict(
        arch=MOE_ARCH, mode='bf16', prequantize=False, attn_impl='flash',
        ragged=False, sampling=None, batch=STATIC_BATCH,
        prompt_len=STATIC_PROMPT, gen_len=STATIC_GEN,
        tokens_per_s=out['tokens_per_s'], prefill_s=out['prefill_s'],
        decode_s=out['decode_s'],
        decode_step_ms=out['decode_s'] / (STATIC_GEN - 1) * 1e3,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches={k: v for k, v in moe_totals.items() if v}))
    print(f'static serve run: {json.dumps(results[-1])}', flush=True)
    del moe_params, out
    gc.collect()
    torch.cuda.empty_cache()
    return results, totals, moe_totals


# ----------------------------------------------------------------------------
# phase 4: device busy share of full-width serving
# ----------------------------------------------------------------------------
PROFILE_MODES = (('bf16', False), ('w8a8', True), ('w8a8', False))
# the device kernels of the attention entry points (K1, K5-K10)
ATTENTION_KERNELS = ('key_split_kernel', 'latent_split_kernel',
                     'split_combine_kernel')
MLA_PROFILE_MODES = (('bf16', False), ('w8a8', False))


def profile_phase(torch, arch=ARCH, modes=PROFILE_MODES):
    """Device busy share of full-width decode.
    A short serve in each of ``modes``, timed once bare and once
    under ``torch.profiler``: the summed duration of every device kernel
    over the bare run's wall time, the device kernels launched (with the
    forwards the serve ran: decode steps plus admissions), and the kernels
    that took most of it. Where the profiler records no device kernel, the
    share is reported as not measured (None)."""
    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M

    cfg = configs.get(arch, smoke=False)
    params = M.init_params(torch.Generator(device='cuda').manual_seed(0),
                           cfg, device='cuda')
    out = []
    for mode, prequant in modes:
        kw = dict(smoke=False, slots=8, n_requests=8, prompt_len=128,
                  gen_len=8, mode=mode, prequantize=prequant, params=params,
                  quiet=True)
        SV.serve_continuous(arch, **kw)                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = SV.serve_continuous(arch, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = profiled_kernels(
            torch, lambda: SV.serve_continuous(arch, **kw))
        busy_ms = sum(v[0] for v in by_name.values()) if by_name else None
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        out.append(dict(arch=arch, mode=mode, prequantize=prequant,
                        forwards=run['steps'] + run['events']['admit'],
                        decode_steps=run['steps'],
                        wall_ms=wall_ms,
                        device_busy_ms=busy_ms,
                        device_busy_share=(None if busy_ms is None
                                           else busy_ms / wall_ms),
                        kernel_launches=sum(v[1] for v in by_name.values()),
                        top=[dict(kernel=k[:80], device_ms=v[0], calls=v[1])
                             for k, v in top],
                        attention=[dict(kernel=k[:80], device_ms=v[0],
                                        calls=v[1])
                                   for k, v in by_name.items()
                                   if any(a in k for a in ATTENTION_KERNELS)]))
        print(f'profile: {json.dumps(out[-1])}', flush=True)
    return out


# ----------------------------------------------------------------------------
# phase 6: chaos and telemetry at full width
# ----------------------------------------------------------------------------
# one fault of each kind at steps where it can land (scheduled on top of
# chaos_profile()'s rates): mangled prompts at submission, poisoned pages
# and logits rows while lanes decode, dropped quantize chunks (with the
# int8 tier only), a pool squeeze with a preemption storm, a cancellation
CHAOS_SEED = 0
CHAOS_SCHEDULE = (
    (0, 'mangle_prompt', (3, 'oversize')), (0, 'mangle_prompt',
                                            (5, 'garbage')),
    (2, 'poison_page', None), (3, 'drop_quant', None),
    (4, 'poison_logits', None), (6, 'pool_squeeze', 24),
    (6, 'preempt_storm', 2), (9, 'cancel', None), (11, 'poison_page', None),
    (15, 'poison_logits', None),
    (17, 'poison_page', None), (23, 'poison_page', None),
    (29, 'poison_page', None))
# the dense prefix: poisoned pages and logits rows only, no rates
MLA_CHAOS_SCHEDULE = ((2, 'poison_page', None), (4, 'poison_logits', None),
                      (7, 'poison_page', None), (10, 'poison_page', None),
                      (13, 'poison_logits', None), (16, 'poison_page', None))
# (arch, mode, prequantize, requests, stream, options, schedule, the
# kernels the serve must launch)
CHAOS_RUNS = (
    (ARCH, 'bf16', False, 16, 'shared',
     dict(kv_quant=True, hot_window=8, prefix_cache=True), CHAOS_SCHEDULE,
     ('flash_decode_paged_q8', 'flash_chunk_paged')),
    (ARCH, 'w8a8', True, 16, 'ragged', {}, CHAOS_SCHEDULE,
     ('flash_decode_paged', 'quantize_rows', 'int8_matmul')),
    (MLA_ARCH, 'w8a8', False, 8, 'ragged', {}, MLA_CHAOS_SCHEDULE,
     ('flash_decode_paged_mla', 'quantize_rows', 'yoco_vmm_int8')),
    # zamba2: a poisoned page reaches every site's pool, and a quarantined
    # lane's recurrent rows are zeroed before the slot is reused
    ('zamba2-1.2b', 'bf16', False, 8, 'ragged', {}, MLA_CHAOS_SCHEDULE,
     ('flash_decode_paged',)),
)
# the telemetry hooks the serve loop calls each step (checked to make no
# device synchronisation)
TELEMETRY_HOOKS = ('begin_step', 'prefill', 'phase', 'sample', 'decode',
                   'logits_gauge', 'step_done', '_on_event')


def _poison_reads(out, picks, page_size, hot_window):
    """For each poisoned page, the rids that read a NaN row of it as a
    visible key in that step's decode (each must be quarantined), and the
    owners that did not: the page was in the int8 tier for the lane, or
    at or past its write position (the decode writes row pos before it
    reads keys <= pos; the kernels never read masked rows, where the plain
    versions' p @ v multiplies them by 0). A lane's position at step s is
    its prompt length plus the steps since its last admission."""
    ev = out['event_log']
    plen = {e['rid']: e['plen'] for e in ev if e['kind'] == 'submit'}
    reads, spared = [], []
    for e in (e for e in ev if e['kind'] == 'fault'
              and e['fault'] == 'poison_page'):
        step, blk = e['step'], picks[(e['step'], e['slot'], e['page'])]
        for owner in e['owners']:
            admit = [a for a in ev if a['kind'] == 'admit'
                     and a['slot'] == owner and a['step'] <= step][-1]
            pos = plen[admit['rid']] + step - admit['step']
            cold = hot_window is not None and \
                blk < max(pos // page_size - hot_window + 1, 0)
            hit = not cold and blk * page_size < pos
            (reads if hit else spared).append((step, admit['rid']))
    return reads, spared


def chaos_phase(torch, build):
    """Continuous serving under injected faults at the published width,
    each serve after a warm-up and beside a clean run of the same stream
    and weights (page size 8, prompts 128, generation 32): stablelm-1.6b in
    bf16 with the int8 tier and the prefix cache (a shared-prefix stream),
    and in w8a8 --prequantize, each under chaos_profile() seeded
    CHAOS_SEED plus CHAOS_SCHEDULE; the dense prefix in dynamic w8a8 under
    MLA_CHAOS_SCHEDULE. Every run writes its metrics (Prometheus text) and
    a Chrome trace, and every telemetry hook runs under
    torch.cuda.set_sync_debug_mode('error'). Gates: terminal accounting
    (the serve audits it); every lane that read a poisoned page's NaN row,
    and every poisoned logits row, quarantined at that step, and no lane
    that only held one in masked rows or the int8 tier (it finishes on the
    clean run's tokens); every finished request outside ``touched`` with
    the clean run's tokens;
    ``serve_events_total{kind}`` and ``serve_requests_total{terminal}``
    equal to the event log; every scheduled fault landed (a dropped
    quantize chunk only with the tier), the fault events counting them;
    the trace a Chrome trace; each serve's kernels launched. Then, not
    gated: the host ms a decode step with metrics on and off, three
    interleaved pairs of stablelm bf16 serves, medians. Returns the rows."""
    from repro_torch import configs
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.runtime import faults as F
    from repro_torch.runtime import telemetry as T

    class PickRecorder(F.FaultInjector):
        """An injector that remembers the block index of each poisoned
        page it picks (its draws are the injector's own)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.picks = {}

        def pick(self, seq):
            seq = list(seq)
            got = super().pick(seq)
            if seq and isinstance(seq[0], tuple):
                slot, page = got
                blocks = [p for s, p in seq if s == slot]
                self.picks[(self._step, slot, page)] = blocks.index(page)
            return got

    hook_calls = dict.fromkeys(TELEMETRY_HOOKS, 0)
    originals = {h: getattr(T.ServeTelemetry, h) for h in TELEMETRY_HOOKS}

    def guarded(name, fn):
        def hook(*a, **kw):
            hook_calls[name] += 1
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode('error')
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return hook

    t_phase = time.perf_counter()
    rows, weights = [], {}
    for i, (arch, mode, prequant, n_req, kind, opts, schedule,
            kernels) in enumerate(CHAOS_RUNS):
        cfg = configs.get(arch, smoke=False)
        if arch not in weights:
            weights[arch] = M.init_params(torch.Generator(device='cuda')
                                          .manual_seed(0), cfg, device='cuda')
        params = weights[arch]
        kw = dict(smoke=False, slots=8, prompt_len=128, gen_len=32,
                  page_size=8, mode=mode, prequantize=prequant,
                  attn_impl='flash', params=params, quiet=True, **opts)
        SV.serve_continuous(arch, **dict(kw, n_requests=1, gen_len=2))
        torch.cuda.synchronize()
        clean = SV.serve_continuous(
            arch, n_requests=n_req,
            request_stream=_stream(SV, cfg, kind, n_req), **kw)
        profile = F.chaos_profile() if arch == ARCH else F.FaultProfile()
        inj = PickRecorder(CHAOS_SEED, profile, schedule=schedule)
        trace = os.path.join(OUT_DIR, f'chaos_trace_{i}.json')
        prom = os.path.join(OUT_DIR, f'chaos_metrics_{i}.prom')
        os.makedirs(OUT_DIR, exist_ok=True)
        for h in TELEMETRY_HOOKS:
            setattr(T.ServeTelemetry, h, guarded(h, originals[h]))
        build.reset_counts()
        try:
            out = SV.serve_continuous(
                arch, n_requests=n_req, faults=inj, trace=trace,
                metrics_out=prom,
                request_stream=_stream(SV, cfg, kind, n_req), **kw)
            torch.cuda.synchronize()
        finally:
            for h in TELEMETRY_HOOKS:
                setattr(T.ServeTelemetry, h, originals[h])
        launches = dict(build.LAUNCHES)
        tag = f'chaos {arch} {mode} prequant={prequant} {opts}'
        ev = out['event_log']
        check(set(out['terminal']) == {e['rid'] for e in ev
                                       if e['kind'] == 'submit'},
              f'{tag}: a submitted request has no terminal state')
        # poisoned lanes
        quarantined = {(e['step'], e['rid']) for e in ev
                       if e['kind'] == 'quarantine'}
        reads, spared = _poison_reads(
            out, inj.picks, 8, opts.get('hot_window') if opts.get('kv_quant')
            else None)
        logit_rows = [(e['step'], e['rid']) for e in ev if e['kind'] == 'fault'
                      and e['fault'] == 'poison_logits']
        missed = [x for x in reads + logit_rows if x not in quarantined]
        check(not missed, f'{tag}: poisoned lanes not quarantined: {missed}')
        check(reads and logit_rows, f'{tag}: no lane read a poisoned page '
                                    f'({spared} spared) or logits row')
        # a lane whose poisoned rows were all masked or in the tier stays
        # finite on the card (the plain versions would quarantine it)
        hit = set(reads) | set(logit_rows)
        wrongly = [x for x in spared if x in quarantined and x not in hit]
        check(not wrongly, f'{tag}: spared lanes quarantined: {wrongly}')
        # clean tokens outside touched
        finished = [r for r, t in out['terminal'].items() if t == 'finish']
        differ = [r for r in finished if r not in inj.touched
                  and out['outputs'][r] != clean['outputs'][r]]
        check(not differ, f'{tag}: requests {differ} differ from the clean '
                          f'run')
        read_rids = {rid for _, rid in hit}
        spared_clean = sorted({rid for _, rid in spared
                               if rid in finished and rid not in read_rids
                               and rid not in inj.touched})
        differ = [r for r in spared_clean
                  if out['outputs'][r] != clean['outputs'][r]]
        check(not differ, f'{tag}: spared requests {differ} differ from the '
                          f'clean run')
        # metrics against the log
        m = out['telemetry']['metrics']
        check(m['serve_events_total']['values']
              == {k: float(v) for k, v in out['events'].items()},
              f'{tag}: serve_events_total differs from the event log')
        terms = Counter(out['terminal'].values())
        check(m['serve_requests_total']['values']
              == {k: float(v) for k, v in terms.items()},
              f'{tag}: serve_requests_total differs from the terminal map')
        # the schedule landed
        want = Counter(k for _, k, _ in schedule
                       if k != 'drop_quant' or opts.get('kv_quant'))
        counts = out['faults']
        check(all(counts.get(k, 0) >= n for k, n in want.items()),
              f'{tag}: fault counts {counts} below the schedule\'s {want}')
        fault_events = Counter(e['fault'] for e in ev if e['kind'] == 'fault')
        for k in ('poison_page', 'poison_logits', 'drop_quant',
                  'mangle_prompt'):
            check(fault_events.get(k, 0) == counts.get(k, 0),
                  f'{tag}: {k} applied {counts.get(k, 0)} times, '
                  f'{fault_events.get(k, 0)} fault events')
        check(out['events'].get('cancel', 0) >= want.get('cancel', 0),
              f'{tag}: no cancellation')
        check(out['events'].get('reject', 0) >= want.get('mangle_prompt', 0),
              f'{tag}: a mangled prompt was not rejected')
        if opts.get('kv_quant'):
            check(out['pages_quant_dropped'] > 0 and inj.touched,
                  f'{tag}: no quantize chunk dropped')
        # the trace and the Prometheus text
        with open(trace) as f:
            tr = json.load(f)['traceEvents']
        check(tr and all(e['ph'] in ('M', 'X', 'i') and 'name' in e
                         and (e['ph'] == 'M' or isinstance(e['ts'], float))
                         and (e['ph'] != 'X' or e['dur'] >= 0) for e in tr),
              f'{tag}: the trace is not a Chrome trace of complete spans and '
              f'instants')
        with open(prom) as f:
            check('serve_energy_pj_total{path="achieved"}' in f.read(),
                  f'{tag}: no modelled energy in the metrics')
        for k in kernels:
            check(launches[k] > 0, f'{tag}: {k} never launched')
        check(all(hook_calls[h] > 0 for h in ('begin_step', 'sample',
                                              'decode', 'logits_gauge',
                                              '_on_event')),
              f'{tag}: a telemetry hook never ran: {hook_calls}')
        rows.append(dict(
            arch=arch, mode=mode, prequantize=prequant, requests=n_req,
            stream=kind, options=opts, steps=out['steps'],
            wall_s=out['wall_s'], clean_wall_s=clean['wall_s'],
            events=out['events'], faults=counts,
            fault_steps=[(e['step'], e['fault']) for e in ev
                         if e['kind'] == 'fault'],
            terminal=dict(terms),
            poisoned_reads=len(reads), poisoned_pages_spared=spared,
            spared_clean_token_requests=spared_clean,
            poisoned_logits_rows=len(logit_rows),
            quarantined=out['quarantined'], touched=sorted(inj.touched),
            clean_token_requests=len([r for r in finished
                                      if r not in inj.touched]),
            pages_quant_dropped=out['pages_quant_dropped'],
            telemetry_summary=out['telemetry_summary'],
            hook_calls_no_sync=dict(hook_calls),
            launches={k: v for k, v in launches.items() if v}))
        print(f'chaos run: {json.dumps(rows[-1])}', flush=True)
    # host ms a decode step, metrics on and off, interleaved
    kw = dict(smoke=False, slots=8, n_requests=8, prompt_len=128,
              gen_len=32, page_size=8, params=weights[ARCH], quiet=True)
    SV.serve_continuous(ARCH, **kw)
    step_ms = dict(on=[], off=[])
    for _ in range(3):
        for key in ('on', 'off'):
            torch.cuda.synchronize()
            o = SV.serve_continuous(ARCH, metrics=key == 'on', **kw)
            step_ms[key].append((o['wall_s'] - o['prefill_s'])
                                / max(o['steps'], 1) * 1e3)
    rows.append(dict(metrics_host_ms_per_step=step_ms,
                     median_on=_median(step_ms['on']),
                     median_off=_median(step_ms['off']),
                     ratio=_median(step_ms['on']) / _median(step_ms['off'])))
    rows.append(dict(phase_s=time.perf_counter() - t_phase))
    print(f'chaos metrics on/off: {json.dumps(rows[-2])}; phase '
          f'{rows[-1]["phase_s"]:.1f} s', flush=True)
    return rows

# ----------------------------------------------------------------------------
# phase 7: tensor-parallel continuous serving (rank processes, one card)
# ----------------------------------------------------------------------------
# tp -> the runs served on one group of that many ranks: (arch, mode,
# prequantize, serve_continuous options); each is served at tp = 1 too
TP_RUNS = {
    2: ((ARCH, 'bf16', False, {}), (ARCH, 'w8a8', True, TIER),
        (MLA_ARCH, 'bf16', False, {})),
    4: ((ARCH, 'bf16', False, {}),),
}
# 8 requests of the serve path's ragged 64-128-token prompts, 16 generated
TP_SERVE = dict(smoke=False, slots=8, n_requests=8, prompt_len=128,
                gen_len=16, page_size=8, attn_impl='flash', quiet=True,
                metrics=False)


def _tp_product_check(torch):
    """A rank's products against tp = 1's, bit for bit, and their device
    times. (1) stablelm's q/k/v columns (K = 2048, N = 2048 each) on a
    bf16 activation of the decode step's 8 rows and of a padded 128-token
    prefill, through ``yoco_linear.linears`` with the whole bf16 weights
    and with each rank's column slices (``sharding.shard_serve_params``)
    at tp = 2 and 4: cuBLAS may pick another algorithm for N / tp columns
    than for N. (2) K1 at stablelm's decode step (B = 8, 32 KV heads, dh =
    64, 137 keys on 8-key pages) and K8 at the dense prefix's (B = 8, 128
    heads, r = 512, 137 keys), each rank's heads with ``ways`` = tp (the
    key split planned for all heads) against the whole call's slice. (3)
    MLA's W_uv product at 8 rows (H = 128, r = 512, dv = 128) as the port
    computes it under TP (``attention._uv_product``, at the whole head
    count) and, not gated, as a batched product over the rank's heads
    alone. (4) K7 at the mesh-sharded serve's decode step (B = 4, 32 KV
    heads, dh = 64, a 136-key bf16 cache), each rank's heads with ``ways``
    = tp against the whole call's slice. Then the device ms (profiler) of
    K1, K8, K7 and the W_uv product at tp = 1 and on a rank at tp = 2, and
    of K1, K8 and K7 on a rank planned for its own heads only (``ways`` =
    1): the occupancy ``ways`` costs.
    Returns one row a (check, M, tp) and one row of times."""
    import functools
    import types

    from repro_torch.core import yoco_linear
    from repro_torch.distributed import sharding
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import attention

    dev = torch.device('cuda')
    gen = torch.Generator(device='cuda').manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda')
    ws = {k: (randn(2048, 2048) / 2048 ** 0.5).to(torch.bfloat16)
          for k in ('wq', 'wk', 'wv')}
    rows = []
    for m in (8, 128):
        x = randn(1, m, 2048).to(torch.bfloat16)
        whole = yoco_linear.linears(x, [ws['wq'], ws['wk'], ws['wv']])
        for tp in (2, 4):
            equal = True
            for rank in range(tp):
                part = sharding.shard_serve_params(ws, rank, tp)
                got = yoco_linear.linears(x, [part['wq'], part['wk'],
                                              part['wv']])
                per = 2048 // tp
                equal &= all(torch.equal(g, w[..., rank * per:
                                              (rank + 1) * per])
                             for g, w in zip(got, whole))
            rows.append(dict(check='qkv_columns_bf16', M=m, tp=tp,
                             bit_equal=bool(equal)))

    # the decode kernels on a rank's heads: a step at 137 keys, 8 requests
    b, page, pos_n = 8, 8, 137
    w = -(-(pos_n + 7) // page)
    bt = (1 + torch.arange(b * w, device=dev, dtype=torch.int32)
          ).reshape(b, w)
    pos = torch.full((b,), pos_n - 1, dtype=torch.int32, device=dev)
    kp, vp = (randn(1 + b * w, page, 32, 64).to(torch.bfloat16)
              for _ in range(2))
    q1 = randn(b, 1, 32, 64).to(torch.bfloat16)
    lat = randn(1 + b * w, page, 576).to(torch.bfloat16)
    q8 = randn(b, 1, 128, 576)

    def k1(q, k, v, ways):
        return lambda: fd.flash_decode_paged(q, k, v, pos, bt,
                                             scale=0.125, ways=ways)

    def k8(q, ways):
        return lambda: fd.flash_decode_paged_mla(q, lat, pos, bt, r=512,
                                                 scale=0.07, ways=ways)
    calls = dict(k1_tp1=k1(q1, kp, vp, 1), k8_tp1=k8(q8, 1))
    whole = dict(k1=calls['k1_tp1'](), k8=calls['k8_tp1']())
    for tp in (2, 4):
        eq1 = eq8 = True
        for rank in range(tp):
            h1, h8 = (slice(rank * n // tp, (rank + 1) * n // tp)
                      for n in (32, 128))
            rank_k1 = k1(q1[:, :, h1].contiguous(),
                         kp[:, :, h1].contiguous(),
                         vp[:, :, h1].contiguous(), tp)
            rank_k8 = k8(q8[:, :, h8].contiguous(), tp)
            eq1 &= torch.equal(rank_k1(), whole['k1'][:, :, h1])
            eq8 &= torch.equal(rank_k8(), whole['k8'][:, :, h8])
            if tp == 2 and rank == 0:
                calls.update(k1_tp2=rank_k1, k8_tp2=rank_k8)
                calls['k1_tp2_own_plan'] = k1(q1[:, :, h1].contiguous(),
                                              kp[:, :, h1].contiguous(),
                                              vp[:, :, h1].contiguous(), 1)
                calls['k8_tp2_own_plan'] = k8(q8[:, :, h8].contiguous(), 1)
        rows.append(dict(check='k1_ways', M=b, tp=tp, bit_equal=bool(eq1)))
        rows.append(dict(check='k8_ways', M=b, tp=tp, bit_equal=bool(eq8)))

    # K7 at the mesh-sharded serve's decode step (a rank's 4 rows of the
    # 8, lock-step at its last position, 136-key bf16 cache)
    b7, s7 = SHARDED_SERVE_BATCH // SHARDED_MESH[0], (SHARDED_SERVE_PROMPT
                                                      + SHARDED_SERVE_STEPS)
    pos7 = torch.full((b7,), s7 - 1, dtype=torch.int32, device=dev)
    win7 = torch.full((b7,), s7 + 1, dtype=torch.int32, device=dev)
    q7 = randn(b7, 32, 1, 64)
    k7c, v7c = (randn(b7, s7, 32, 64).to(torch.bfloat16) for _ in range(2))

    def k7(h, ways):
        args = (q7[:, h].contiguous(), k7c[:, :, h].contiguous(),
                v7c[:, :, h].contiguous(), pos7, win7)
        return lambda: fd.flash_decode_gqa(*args, scale=0.125, ways=ways)
    calls['k7_tp1'] = k7(slice(None), 1)
    whole = calls['k7_tp1']()
    for tp in (2, 4):
        eq7 = True
        for rank in range(tp):
            h7 = slice(rank * 32 // tp, (rank + 1) * 32 // tp)
            eq7 &= torch.equal(k7(h7, tp)(), whole[:, h7])
            if tp == 2 and rank == 0:
                calls['k7_tp2'] = k7(h7, tp)
                calls['k7_tp2_own_plan'] = k7(h7, 1)
        rows.append(dict(check='k7_ways', M=b7, tp=tp, bit_equal=bool(eq7)))

    mla = types.SimpleNamespace(nope_head_dim=128, v_head_dim=128,
                                kv_lora_rank=512)
    w_ukv = randn(512, 128 * 256)
    o_lat = randn(8, 1, 128, 512)

    def uv(o, p, rt):
        return attention._uv_product(
            o, attention._absorb_weights(p, mla)[1], p, mla, rt)

    def rt_of(rank, tp):
        group = types.SimpleNamespace(size=lambda: tp, rank=lambda: rank)
        return types.SimpleNamespace(tp_group=group)
    whole = uv(o_lat, dict(w_ukv=w_ukv), None)
    calls['w_uv_tp1'] = lambda: uv(o_lat, dict(w_ukv=w_ukv), None)
    for tp in (2, 4):
        alone = padded = True
        for rank in range(tp):
            heads = slice(rank * 128 // tp, (rank + 1) * 128 // tp)
            part = sharding.shard_serve_params(dict(w_ukv=w_ukv), rank, tp)
            own = o_lat[:, :, heads].contiguous()
            want = whole[:, :, heads]
            padded &= torch.equal(uv(own, part, rt_of(rank, tp)), want)
            alone &= torch.equal(uv(own, part, None), want)
            if tp == 2 and rank == 0:
                calls['w_uv_tp2'] = functools.partial(uv, own, part,
                                                      rt_of(rank, tp))
                calls['w_uv_tp2_own_heads'] = functools.partial(
                    uv, own, part, None)
        rows.append(dict(check='mla_w_uv_product', M=8, tp=tp,
                         bit_equal=bool(padded),
                         bit_equal_over_own_heads=bool(alone)))
    times = {}
    for name, fn in calls.items():
        ms, timer, kernels = device_ms(torch, fn, iters=10, warmup=2)
        times[name] = dict(ms=ms, timer=timer, kernels=kernels)
    rows.append(dict(check='device_ms', shapes=dict(
        k1=dict(B=b, hkv_tp1=32, dh=64, keys=pos_n, page=page),
        k8=dict(B=b, h_tp1=128, r=512, d_rope=64, keys=pos_n, page=page),
        k7=dict(B=b7, hkv_tp1=32, dh=64, S=s7, keys=s7),
        w_uv=dict(M=8, h_tp1=128, r=512, dv=128)), **times))
    return rows


def tp_phase(torch, build):
    """stablelm-1.6b at its published width and depth served at tp = 2 in
    bf16 and in w8a8 --prequantize over the int8 tier, and at tp = 4 in
    bf16, and deepseek-v3's dense prefix at tp = 2 in bf16, the runs of
    one tp on one group of rank processes
    (``launch/serve.py::serve_continuous_group``). On one card the ranks
    share ``cuda:0`` over gloo, whose collectives cross the host; with a
    card a rank (two or more cards at tp = 2) the group is nccl. First
    :func:`_tp_product_check` (gated, bit for bit). Gates, against the
    same run at tp = 1, served once (seeded weights, the same draws on
    every rank): equal tokens, every rank's kernel launches equal tp =
    1's kernel by kernel, one ``heads_all_gather`` a layer a forward
    (decode steps and admission prefills) and no other collective, no
    quarantined lane (finite logits). Prints each run's wall time,
    tokens/s and the KV pool bytes a rank; it measures no TP speed: ranks
    that share one card only show the sharded path right on the card."""
    from repro_torch import configs
    from repro_torch.distributed import ranks, sharding
    from repro_torch.launch import serve as SV

    t_phase = time.perf_counter()
    rows = _tp_product_check(torch)
    print(f'tp products: {json.dumps(rows)}', flush=True)
    for row in rows:
        check(row.get('bit_equal', True), f'tp products: {row}')
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f'tp phase: the NCCL path (a card a rank) is not run: this '
              f'machine has {n_cards} card', flush=True)
    served = {}         # each distinct run's tp = 1 serve, served once
    for tp, runs in TP_RUNS.items():
        base = []
        for arch, mode, prequant, opts in runs:
            key = json.dumps([arch, mode, prequant, opts], sort_keys=True)
            if key not in served:
                build.reset_counts()
                t0 = time.perf_counter()
                one = SV.serve_continuous(arch, mode=mode,
                                          prequantize=prequant,
                                          **TP_SERVE, **opts)
                torch.cuda.synchronize()
                served[key] = (one, dict(build.LAUNCHES),
                               time.perf_counter() - t0)
            base.append(served[key])
        devs, backend = ranks.placement(tp)
        t0 = time.perf_counter()
        outs = SV.serve_continuous_group(
            [dict(TP_SERVE, arch=arch, mode=mode, prequantize=prequant,
                  **opts) for arch, mode, prequant, opts in runs], tp=tp)
        group_s = time.perf_counter() - t0
        for (arch, mode, prequant, opts), (one, launches, one_s), out in \
                zip(runs, base, outs):
            cfg = configs.get(arch, smoke=TP_SERVE['smoke'])
            tag = f'tp={tp} {arch} {mode} prequant={prequant} {opts}'
            check(out['tp'] == tp and out['backend'] == backend
                  and [r['device'] for r in out['ranks']]
                  == [str(d) for d in devs],
                  f'{tag}: ranks {out["ranks"]} on {backend}')
            check(out['completed'] == one['completed'] == 8
                  and out['quarantined'] == one['quarantined'] == 0,
                  f'{tag}: not every request finished with finite logits: '
                  f'{out["events"]} vs {one["events"]}')
            check(out['outputs'] == one['outputs'],
                  f'{tag}: tokens differ from tp=1\'s')
            forwards = out['steps'] + out['events']['admit']
            want_calls = dict(heads_all_gather=cfg.n_layers * forwards,
                              all_reduce=0, gather_objects=0)
            for rank in out['ranks']:
                check(rank['launches'] == launches,
                      f'{tag}: rank {rank["rank"]} launched '
                      f'{rank["launches"]}, tp=1 {launches}')
                check(rank['collectives'] == want_calls,
                      f'{tag}: rank {rank["rank"]} made '
                      f'{rank["collectives"]} collectives, expected '
                      f'{want_calls}')
            max_blocks = -(-(TP_SERVE['prompt_len'] + TP_SERVE['gen_len'])
                           // TP_SERVE['page_size'])
            pool = dict(batch=TP_SERVE['slots'],
                        num_pages=1 + TP_SERVE['slots'] * max_blocks,
                        page_size=TP_SERVE['page_size'],
                        max_blocks=max_blocks,
                        kv_dtype='int8' if opts.get('kv_quant') else None,
                        hot_window=opts.get('hot_window', 2),
                        dtype=torch.bfloat16)
            rows.append(dict(
                tp=tp, arch=arch, mode=mode, prequantize=prequant,
                options=opts, backend=backend,
                devices=[r['device'] for r in out['ranks']],
                wall_s=out['wall_s'], prefill_s=out['prefill_s'],
                tokens_per_s=out['tokens_per_s'], steps=out['steps'],
                decode_tokens=out['decode_tokens'],
                pool_bytes_a_rank=sharding.pool_bytes(cfg, tp, **pool),
                pool_bytes_tp1=sharding.pool_bytes(cfg, 1, **pool),
                heads_all_gather=out['collectives']['heads_all_gather'],
                launches={k: v for k, v in launches.items() if v},
                tp1_wall_s=one['wall_s'],
                tp1_tokens_per_s=one['tokens_per_s'],
                tp1_call_s=one_s, group_s=group_s))
            print(f'tp run: {json.dumps(rows[-1])}', flush=True)
    rows.append(dict(phase_s=time.perf_counter() - t_phase))
    print(f'tp phase: {rows[-1]["phase_s"]:.1f} s', flush=True)
    return rows


SHARDED_PATH = f'{ARCH} sharded train'
# stablelm-1.6b at its published width on a 2 x 2 rank mesh (four ranks
# on one card over gloo, a card a rank over nccl where there are four):
# global batch 8 of 256 tokens, 2 AdamW steps a run, at the published
# depth unless the phase outgrows its time (then SHARDED_LAYERS, the
# depth the report states)
SHARDED_MESH = (2, 2)
SHARDED_LAYERS = 4
SHARDED_STEPS = 2
# (mode, layout, remats): bf16 under both layouts, w8a8 under 'tp', each
# stepped with the first remat; bf16 'tp' also measured without remat, for
# the memory remat saves
SHARDED_RUNS = (('bf16', 'tp', ('full', 'none')), ('bf16', 'fsdp2d', ('full',)),
                ('w8a8', 'tp', ('full',)))
# the 8 rows of the reference's distributed parity (tests/
# dist_parity_main.py): (name, arch, expert-parallel)
SHARDED_SMOKE_ROWS = (('dense', ARCH, False),
                      ('mla_moe', 'deepseek-v3-671b', True),
                      ('gqa_moe', MOE_ARCH, True), ('ssm', SSM_ARCH, False))
SHARDED_SMOKE_TOL = 1e-3          # a card's sharded loss against the CPU's
# the sharded params off by > 1e-6 after a step, at most this many times
# the one-device trainer's against itself (grad_accum 2 against 1, the
# control); set after a card run read 2.5x for bf16 'tp', 1.0x for 'fsdp2d'
SHARDED_CONTROL_FACTOR = 4
MOE_EP_TOL = 1e-4                 # moe_ep's f32 outputs, card against CPU


def _sharded_cfg(layers=None):
    """stablelm-1.6b at its published width, cut to ``layers`` (registered
    at run time under its own name) where that is not its depth."""
    import dataclasses

    from repro_torch import configs
    cfg = configs.get(ARCH, smoke=False)
    layers = layers or SHARDED_LAYERS
    if layers == cfg.n_layers:
        return cfg
    name = f'{ARCH}-L{layers}'
    configs.base.register(dataclasses.replace(cfg, name=name,
                                              n_layers=layers),
                          configs.get(ARCH, smoke=True))
    return configs.get(name, smoke=False)


def sharded_counts(cfg, mode, layout, remat, accum=1):
    """The collectives one sharded stablelm step makes on a rank, derived
    from the specs (PERF §3): every master dim the step gathers is one
    all-gather a microbatch and one reduce-scatter in its backward ('tp':
    the dims cut over 'data', every 'model' block being kept; 'fsdp2d':
    every cut dim, its axes in one gather; and the sequence-parallel
    attention's K and V, gathered over 'model' each layer a forward, run
    again by 'full' remat). All-reduces a microbatch:
    'tp': the vocab-parallel embedding 1, each row-parallel linear (wo,
    w_down: 2 a layer) 1 in bf16 or 2 in w8a8 (the absmax MAX, the int32
    sum) a forward, run again by 'full' remat, each layer's 2 copy_in in
    the backward and the lm_head's 1, the vocab-parallel loss 3 (max, sum,
    gold), the loss's sum and token count 2; 'fsdp2d': the loss's 2. Then
    a step: one all-reduce a set of token axes that replicated leaves lie
    whole on, and the global norm's 1. K3, K4 and K2 launches a step in
    w8a8 'tp': a forward quantizes 2 activations, 5 column weights and 2
    row blocks (activation and weight each) a layer, and the lm_head's
    activation and weight; K4 runs the 5 column products a layer and the
    lm_head's, K2 the 2 row products (their int32 sums); 'full' remat
    runs each layer's again."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime import train_step as TS
    mesh = mesh_mod.shape_mesh(dict(data=SHARDED_MESH[0],
                                    model=SHARDED_MESH[1]))
    pabs, oabs = TS.abstract_state(cfg)
    pspecs, _, _ = TS.state_shardings(mesh, cfg, pabs, oabs, layout)
    gathers, replicated = 0, set()
    for leaf, spec in sharding.leaves_with_specs(pabs, pspecs):
        for _, axes in sharding.spec_axes(spec, leaf.ndim):
            gathers += (axes.count('data') if layout == 'tp' else 1)
        rep = sharding.replicated_axes(spec, mesh)
        if layout == 'tp':
            rep = tuple(a for a in rep if a == 'data')
        if rep:
            replicated.add(rep)
    layers = cfg.n_layers
    again = 2 if remat == 'full' else 1
    kv = 0
    if layout == 'tp':
        rows = 2 * layers * (2 if mode == 'w8a8' else 1)
        per_mb = 1 + again * rows + 2 * layers + 1 + 3 + 2
    else:
        per_mb = 2
        kv = 2 * layers             # K and V over 'model', each layer
    calls = dict(all_gather=accum * (gathers + again * kv),
                 reduce_scatter=accum * (gathers + kv), all_to_all=0,
                 all_reduce=accum * per_mb + len(replicated) + 1)
    launches = dict(quantize_rows=0, yoco_vmm_int8=0, int8_matmul=0)
    if mode == 'w8a8':
        launches = dict(quantize_rows=accum * (11 * layers * again + 2),
                        yoco_vmm_int8=accum * (5 * layers * again + 1),
                        int8_matmul=accum * 2 * layers * again)
    return calls, launches


# the mesh-sharded static serve on the phase's ranks
# (runtime/serve_step.py::sharded_prefill_step / sharded_decode_step): a
# prefill of SHARDED_SERVE_BATCH x SHARDED_SERVE_PROMPT tokens, then
# SHARDED_SERVE_STEPS greedy decode steps, flash attention (K7 on a rank's
# heads), in w8a8 with int8 weights resident (K2, K3, K7) and in bf16
# (K7); (mode, prequantize)
SHARDED_SERVES = (('w8a8', True), ('bf16', False))
SHARDED_SERVE_BATCH, SHARDED_SERVE_PROMPT = 8, 128
SHARDED_SERVE_STEPS = 8
# the sharded serve's logits against one device's, max abs, until a
# token differs: four times the CPU rehearsal's 0.0654 (bf16, the same
# weights, prompts and 2 x 2 mesh; PERF §6, set before the card run)
SHARDED_SERVE_TOL = 0.25
# the dry run's peak live bytes of a train step (gloo's reduce-scatter
# input copies counted: dryrun.GLOO_CUDA_STAGING) against the step's own
# peak on the card (max_memory_allocated less what was allocated before
# the step, plus the rank's masters and moments), relative: PERF §6's
# prediction (the card's readings so far are within 0.2% of the model)
SHARDED_PEAK_TOL = 0.02
# PERF §6's bytes of the bf16 'tp' step with remat 'full' (the ranks' reading):
# gathered, reduce-scattered, all-reduced; a rank's master and moment bytes
SHARDED_TP_BYTES = dict(all_gather=411_041_792, reduce_scatter=822_083_584,
                        all_reduce=591_556_620)
SHARDED_TP_ARGS = (822_231_040, 1_644_462_080)


def _serve_shape(kind):
    return dict(kind=kind, global_batch=SHARDED_SERVE_BATCH,
                seq_len=SHARDED_SERVE_PROMPT,
                max_seq=SHARDED_SERVE_PROMPT + SHARDED_SERVE_STEPS)


def serve_counts(cfg, mode, prequant):
    """The collectives and launches of one sharded serving step on a rank
    of the 2 x 2 mesh, derived from the specs: {kind: (calls, bytes,
    launches)} for 'prefill' and 'decode'. All-gathers: every weight dim
    cut over 'data' (each rank computes on its 'model' block: heads,
    hidden units, vocab), the gathered block's bytes; the logits' vocab
    blocks over 'model' and the rows over 'data' (bf16). All-reduces: the
    vocab-parallel embedding's f32 rows, and each row-parallel linear (wo,
    w_down) a layer, its f32 sum in bf16, in w8a8 its rows' absmax (f32)
    and its int32 accumulators. Launches: in w8a8 with int8 weights K3 on
    4 activations a layer (q/k/v, wo's block, gate/up, w_down's block)
    and the lm_head's, K2 on 7 weights a layer and the lm_head; K7 once a
    layer a decode step."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime import serve_step as SS
    mesh = mesh_mod.shape_mesh(dict(data=SHARDED_MESH[0],
                                    model=SHARDED_MESH[1]))
    b, p = SHARDED_SERVE_BATCH, SHARDED_SERVE_PROMPT
    pabs, cabs = SS.abstract_serve_state(cfg, b, p + SHARDED_SERVE_STEPS,
                                         torch.bfloat16, prequant,
                                         mode=mode)
    pspecs, _ = SS.serve_shardings(mesh, cfg, pabs, cabs, b)
    keep = sharding.compute_specs(pabs, pspecs, cfg, mesh, 'batch', False,
                                  serve=True)
    gathers = gathered = 0
    for (leaf, spec), (_, kept) in zip(
            sharding.leaves_with_specs(pabs, pspecs),
            sharding.leaves_with_specs(pabs, keep)):
        n = sum(axes.count('data')
                for _, axes in sharding.spec_axes(spec, leaf.ndim))
        if n:
            gathers += n
            gathered += int(np.prod(sharding.block_shape(
                leaf.shape, kept, mesh))) * leaf.element_size()
    rows = b // SHARDED_MESH[0]
    d, layers, v = cfg.d_model, cfg.n_layers, cfg.vocab_size
    int8 = mode == 'w8a8'
    out = {}
    for kind, m in (('prefill', rows * p), ('decode', rows)):
        calls = dict(all_gather=gathers + 2,
                     all_reduce=1 + 2 * layers * (2 if int8 else 1))
        nbytes = dict(all_gather=gathered + 2 * rows * v + 2 * b * v,
                      all_reduce=m * d * 4 + 2 * layers * (
                          m * d * 4 + (m * 4 if int8 else 0)))
        launches = dict(quantize_rows=(4 * layers + 1) if int8 else 0,
                        int8_matmul=(7 * layers + 1) if int8 else 0,
                        flash_decode_contig=layers if kind == 'decode'
                        else 0)
        out[kind] = (calls, nbytes, launches)
    return out


def sharded_dryrun(cfg, staging=None):
    """The dry run (``launch/dryrun.py::dryrun_step``) of the phase's steps
    on the meta device, one rank of a fake 2 x 2 group, with the code the
    ranks run: the first step of each of SHARDED_RUNS, and each serve's
    prefill and decode step; ``staging`` the backend's device copies
    (``dryrun.GLOO_CUDA_STAGING`` for ranks that share a card). Returns
    ({key: record}, seconds)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    mesh = mesh_mod.shape_mesh(dict(data=SHARDED_MESH[0],
                                    model=SHARDED_MESH[1]))
    out = {}
    for mode, layout, remats in SHARDED_RUNS:
        out['train', mode, layout] = dryrun.dryrun_step(
            cfg, dict(kind='train', global_batch=TRAIN_BATCH,
                      seq_len=TRAIN_SEQ), mesh, layout=layout, grad_accum=1,
            remat=remats[0], yoco_mode=mode, staging=staging)
    for mode, prequant in SHARDED_SERVES:
        for kind in ('prefill', 'decode'):
            out[kind, mode] = dryrun.dryrun_step(
                cfg, _serve_shape(kind), mesh, yoco_mode=mode,
                prequant=prequant, attn_impl='flash', staging=staging)
    return out, time.perf_counter() - t0


def _token_gate(r0, gate, tag):
    """Rank 0's tokens against one device's: equal, or at the first step a
    row differs, one device's top-2 gap there below the logit error of
    that step (bf16 sums reassociated); later steps of such a row are
    not compared. Returns (the max logit error over the compared steps,
    the differing rows' report)."""
    got, want = r0['tokens'], r0['ref_tokens']
    logits, ref = r0['logits'], r0['ref_logits']
    live = np.ones(got.shape[1], dtype=bool)
    err, report = 0.0, []
    for i in range(got.shape[0]):
        if live.any():
            err = max(err, float(np.abs(logits[i][live]
                                        - ref[i][live]).max()))
        for row in np.nonzero(live & (got[i] != want[i]))[0]:
            step_err = float(np.abs(logits[i, row] - ref[i, row]).max())
            top2 = np.sort(ref[i, row])[-2:]
            gap = float(top2[1] - top2[0])
            report.append(dict(step=i, row=int(row), top2_gap=gap,
                               logit_err=step_err))
            gate(gap < step_err, f'{tag}: row {row} token differs at step '
                                 f'{i} with a top-2 gap {gap} above the '
                                 f'logit error {step_err}')
            live[row] = False
    return err, report


def _serve_gates(cfg, mode, prequant, outs, dry, gate):
    """One sharded serve's gates: the ranks' tokens agree, rank 0's equal
    one device's (:func:`_token_gate`), its logits within
    SHARDED_SERVE_TOL of one device's until a token differs; each step's
    collectives and launches on every rank exactly :func:`serve_counts`,
    and the dry run's collectives and argument bytes what each rank
    counted and holds. Returns the report row, with each step's roofline
    bound beside its time (information: four ranks share one card)."""
    tag = (f'sharded serve {cfg.name} {mode}'
           f'{" prequantized" if prequant else ""}')
    want = serve_counts(cfg, mode, prequant)
    kinds = ['prefill'] + ['decode'] * SHARDED_SERVE_STEPS
    r0 = outs[0]
    for o in outs:
        gate(np.array_equal(o['tokens'], r0['tokens']),
             f'{tag}: rank {o["rank"]} tokens differ from rank 0\'s')
        for i, kind in enumerate(kinds):
            calls, nbytes, launches = want[kind]
            got = ({k: o['calls'][i][k] for k in calls},
                   {k: o['bytes'][i][k] for k in nbytes},
                   {k: o['launches'][i].get(k, 0) for k in launches})
            gate(got == (calls, nbytes, launches),
                 f'{tag}: rank {o["rank"]} step {i} made {got}, derived '
                 f'{(calls, nbytes, launches)}')
        for i, kind in ((0, 'prefill'), (1, 'decode')):
            dc = dry[kind, mode]['collectives']
            got = {k: o['calls'][i][k] for k in dc['calls']}
            gate(got == dc['calls'] and o['bytes'][i] == dc['bytes'],
                 f'{tag}: rank {o["rank"]} {kind} made {got}, '
                 f'{o["bytes"][i]}; the dry run counts {dc["calls"]}, '
                 f'{dc["bytes"]}')
        darg = dry['decode', mode]['argument_bytes']
        gate(o['param_bytes'] == darg['params']
             and o['cache_bytes'] == darg['cache'],
             f'{tag}: rank {o["rank"]} holds {o["param_bytes"]} + '
             f'{o["cache_bytes"]}, the dry run {darg}')
    err, differ = _token_gate(r0, gate, tag)
    gate(bool(np.isfinite(r0['logits']).all()) and err <= SHARDED_SERVE_TOL,
         f'{tag}: logits {err} from one device\'s (bound '
         f'{SHARDED_SERVE_TOL})')
    rate = (roofline.PEAK_FLOPS_INT8 if mode == 'w8a8'
            else roofline.PEAK_FLOPS_BF16)
    steps = {}
    for i, kind in ((0, 'prefill'), (1, 'decode')):
        rec = dry[kind, mode]
        measured = (r0['seconds'][0] if kind == 'prefill'
                    else _median(r0['seconds'][1:]))
        steps[kind] = dict(
            ms=measured * 1e3, bound_ms=roofline.bound_s(
                rec['argument_bytes']['total'], rec['flops'], rate) * 1e3,
            flops=rec['flops'], argument_bytes=rec['argument_bytes'],
            dryrun_peak_bytes=rec['memory']['peak_bytes'],
            collectives=want[kind][0], bytes=want[kind][1],
            launches=want[kind][2])
        print(f'{tag} {kind}: {steps[kind]["ms"]:.2f} ms a step, roofline '
              f'bound {steps[kind]["bound_ms"]:.4f} ms (information)',
              flush=True)
    return dict(
        arch=cfg.name, layers=cfg.n_layers, mode=mode, prequantize=prequant,
        attn_impl='flash', mesh=dict(data=SHARDED_MESH[0],
                                     model=SHARDED_MESH[1]),
        batch=SHARDED_SERVE_BATCH, prompt=SHARDED_SERVE_PROMPT,
        decode_steps=SHARDED_SERVE_STEPS, tokens_equal=bool(np.array_equal(
            r0['tokens'], r0['ref_tokens'])), differing=differ,
        logit_err=err, tol=SHARDED_SERVE_TOL, steps=steps,
        seconds_a_rank=[o['job_s'] for o in outs])


def _leaf_diffs(torch, got, want, names=None):
    """(params off by > 1e-6, the worst difference, off counts by leaf
    name, default its shape) of two lists of leaves."""
    off, worst, by_name = 0, 0.0, Counter()
    for j, (a, b) in enumerate(zip(got, want)):
        d = (a - b).abs()
        n = int((d > 1e-6).sum())
        off += n
        by_name[names[j] if names else str(tuple(d.shape))] += n
        worst = max(worst, float(d.max()))
    return off, worst, dict(by_name.most_common(6))


# a rank's one-device references, (config name, mode, steps) -> [(metrics,
# params after the first step or None)] a step: the same draw and batch
# serve every layout
_REFERENCES = {}


def _references(torch, cfg, mode, steps, batch, control):
    """A rank: the one-device ``make_train_step`` from the trainer's
    seed-0 draw, ``steps`` steps (the first step's params kept on the
    card for the next run of the mode), and with ``control`` one step at
    grad_accum 2 from the same draw, held to the first step: the same
    trainer summing its gradient in another order, what reassociation
    alone moves."""
    import dataclasses
    import gc

    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.launch.train import init_state
    from repro_torch.models.model import ModelRuntime
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_step as TS
    dev = batch['inputs'].device
    opt = adamw.OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    key = (cfg.name, mode, steps)
    if key not in _REFERENCES:
        _REFERENCES.clear()         # one mode's at a time: the card is shared
    runs = [(1, steps)] if key not in _REFERENCES else []
    if control:
        runs.append((2, 1))
    got = {}
    for accum, n in runs:
        whole, st = init_state(cfg, opt, 0, dev)
        one = TS.make_train_step(cfg, YocoConfig(mode=mode), ModelRuntime(),
                                 opt_cfg=dataclasses.replace(
                                     opt, grad_accum=accum))
        got[accum] = []
        for i in range(n):
            whole, st, m = one(whole, st, batch)
            # the params after the first step, which the gates compare
            got[accum].append(
                ({k: float(m[k]) for k in ('loss', 'grad_norm', 'lr')},
                 [t.clone() for t in adamw.tree_leaves(whole)]
                 if i == 0 else None))
        del whole, st, one, m
        gc.collect()
        torch.cuda.empty_cache()
    if 1 in got:
        _REFERENCES[key] = got[1]
    ref = _REFERENCES[key]
    out = None
    if control:
        off, worst, by_shape = _leaf_diffs(torch, got[2][0][1], ref[0][1])
        out = dict(grad_accum=2, metrics=got[2][0][0], params_off=off,
                   worst_param_err=worst, params_off_by_shape=by_shape)
    return ref, out


def sharded_rank_job(mesh, *, cfg, mode, layout, remats, steps, batch,
                     check_ref, control=False):
    """A mesh job: the trainer's seed-0 draw of ``cfg`` on the rank's
    card, cut into its blocks; with ``check_ref`` every rank holds the
    one-device reference (:func:`_references`). Given several ``remats``,
    every rank measures the bytes autograd holds after one forward under
    each and the peak of a forward and backward under the others; it
    takes ``steps`` sharded steps under the first remat. After the first
    step each rank counts its blocks' params off the reference's, summed
    over the mesh. Returns the rank's losses, step ms, its first step's
    peak memory, the held bytes and peaks a remat, collective calls and
    bytes and kernel launches a step (of the first remat), master and
    moment bytes, and its seconds."""
    import gc

    import torch
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import build
    from repro_torch.launch.train import init_state
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_step as TS

    dev = mesh.device
    cuda = dev.type == 'cuda'       # a CPU rehearsal has no allocator

    def release():
        # four ranks share the card: each returns what its allocator
        # caches before another rank needs it
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def allocated():
        return torch.cuda.memory_allocated(dev) if cuda else 0

    def peak():
        return torch.cuda.max_memory_allocated(dev) if cuda else 0
    release()
    laps = {}
    started = time.time()
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        sync()
        now = time.perf_counter()
        laps[name] = now - t0
        t0 = now
    opt = adamw.OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    yoco = YocoConfig(mode=mode)
    whole, _ = init_state(cfg, opt, 0, dev)
    fns = {r: TS.sharded_train_step(mesh, cfg, yoco, opt_cfg=opt,
                                    layout=layout, remat=r)[0]
           for r in remats}
    pabs, oabs = TS.abstract_state(cfg, opt)
    pspecs, _, _ = TS.state_shardings(mesh, cfg, pabs, oabs, layout)
    blocks = sharding.shard_tree(whole, pspecs, mesh)
    state = adamw.init(blocks, opt)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    del whole
    release()
    lap('draw_and_cut')
    # every rank has let go of its whole draw before the one-device
    # references allocate their moments and activations
    torch.distributed.barrier()
    out = dict(rank=mesh.rank, coords=mesh.coords, device=str(dev),
               backend=torch.distributed.get_backend(),
               master_bytes=sharding.nbytes(blocks),
               moment_bytes=sharding.nbytes([state.mu, state.nu]),
               losses=[], grad_norms=[], step_ms=[], params_off=[],
               worst_param_err=[], params_off_by_shape=[], reference=None,
               held_bytes={}, peak_bytes={})
    ref_params = []
    if check_ref:
        # every rank runs the one-device step itself and holds its own
        # block of it against its block of the sharded step
        ref, out['control'] = _references(torch, cfg, mode, steps, batch,
                                          control and mesh.rank == 0)
        out['reference'] = [m for m, _ in ref]
        ref_params = [p for _, p in ref]
        release()
    lap('reference')
    # the bytes autograd holds for the backward after one forward, and the
    # peak of that forward and its backward (the step's own peak is its
    # optimizer's where the layers' activations are small)
    mb = TS.rank_rows(batch, mesh, sharding.dp_axes_of(mesh), 1, 0)
    out['forward_backward_peak_bytes'] = {}
    for r, fn in (fns.items() if len(remats) > 1 else ()):
        for p in adamw.tree_leaves(blocks):
            p.requires_grad_(True)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        before = allocated()
        loss = fn.loss_of(blocks, mb)[0]
        out['held_bytes'][r] = allocated() - before
        if r != remats[0]:      # the first remat's peak: its step's
            loss.backward()
            out['forward_backward_peak_bytes'][r] = peak()
        del loss
        for p in adamw.tree_leaves(blocks):
            p.grad = None
            p.requires_grad_(False)
        release()
    lap('held')
    calls, nbytes, launches = Counter(), Counter(), Counter()
    for i in range(steps):
        collectives.reset_counts()
        build.reset_counts()
        if i == 0:
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            out['before_step_bytes'] = allocated()
        t_step = time.perf_counter()
        blocks, state, m = fns[remats[0]](blocks, state, batch)
        sync()
        out['step_ms'].append((time.perf_counter() - t_step) * 1e3)
        out['losses'].append(float(m['loss']))
        out['grad_norms'].append(float(m['grad_norm']))
        calls.update(collectives.CALLS)
        nbytes.update(collectives.BYTES)
        launches.update(build.LAUNCHES)
        if i == 0:
            out['peak_bytes'][remats[0]] = peak()
        if i == 0 and ref_params:
            # the params against the reference's after the first step (the
            # gated one): each rank its own blocks, a replicated block
            # counted on one rank, the counts summed over the mesh
            coords = mesh.coords
            mine, theirs, shapes = [], [], []
            for (leaf, spec), want in zip(
                    sharding.leaves_with_specs(blocks, pspecs),
                    ref_params[0]):
                if any(coords[a] for a in
                       sharding.replicated_axes(spec, mesh)):
                    continue
                mine.append(leaf)
                theirs.append(want[sharding.block_index(want.shape, spec,
                                                        mesh)])
                shapes.append(str(tuple(want.shape)))
            off, worst, by_shape = _leaf_diffs(torch, mine, theirs, shapes)
            every = collectives.gather_objects(
                (off, worst, by_shape, sum(t.numel() for t in mine)),
                mesh.group(mesh.axis_names))
            shape_off = Counter()
            for e in every:
                shape_off.update(e[2])
            out['params_off'].append(sum(e[0] for e in every))
            out['worst_param_err'].append(max(e[1] for e in every))
            out['params_off_by_shape'].append(
                dict(shape_off.most_common(6)))
            out['params'] = sum(e[3] for e in every)
            del mine, theirs
            release()
        lap(f'step{i + 1}')
    out['calls'] = {k: calls[k] // steps for k in collectives.CALLS}
    out['bytes'] = {k: nbytes[k] // steps for k in collectives.BYTES}
    out['launches'] = {k: v // steps for k, v in launches.items() if v}
    del blocks, state, fns, m
    release()
    out['seconds'] = laps
    out['started'] = started
    if mesh.rank == 0:
        print(f'sharded rank 0: {cfg.name} {mode} {layout} {remats}: '
              f'{json.dumps(laps)}, step ms {out["step_ms"]}', flush=True)
    return out


def timed_job(mesh, *, timed, kwargs):
    """A mesh job: job ``timed``'s result on the mesh and its seconds."""
    from repro_torch.distributed import ranks
    t0 = time.perf_counter()
    out = ranks._job_fn(timed)(mesh, **kwargs)
    return out, time.perf_counter() - t0


def _timed(job):
    """``job`` (a mesh job, or every rank's result of one) timed on each
    rank by :func:`timed_job`."""
    from repro_torch.distributed import ranks
    target, kw = job
    if target.endswith(':_all_ranks'):
        return ranks.all_ranks_job(_timed(kw['job']))
    return ranks.mesh_job('chip_smoke:timed_job', kw['n_model'],
                          timed=kw['target'], kwargs=kw['kwargs'])


def _sharded_smoke_jobs(device=None):
    """The smoke-size jobs, the same on the card and on the CPU (``device``
    'cpu': the ranks' CPU tensors, over a gloo group): the 8 parity rows'
    sharded loss from the trainer's seed-0 draw, and moe_ep with capacity
    drops on qwen2-moe's f32 stacks, both token entries."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.distributed import ranks
    from repro_torch.launch.train import init_state
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    jobs = []
    for name, arch, ep in SHARDED_SMOKE_ROWS:
        cfg = configs.get(arch, smoke=True)
        if ep:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl='ep', capacity_factor=100.0))
        params, _ = init_state(cfg, adamw.OptConfig(), 0, 'cpu')
        batch = synthetic.make_batch(synthetic.for_arch(
            cfg, global_batch=4, seq_len=32), 0)
        for layout in ('tp', 'fsdp2d'):
            jobs.append(((name, layout), _timed(ranks.mesh_job(
                'repro_torch.runtime.train_step:sharded_job', 2, cfg=cfg,
                params=M.params_to_numpy(params, cfg),
                batch={k: v.numpy() for k, v in batch.items()},
                layout=layout, device=device))))
    cfg = configs.get(MOE_ARCH, smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl='ep', capacity_factor=1.25))
    p = moe.init_moe(torch.Generator().manual_seed(8), cfg, device='cpu')
    p = {k: M._to_numpy(v) for k, v in p.items()}
    x = (np.random.RandomState(8).randn(4, 8, cfg.d_model)
         * 0.5).astype(np.float32)
    for split in (True, False):
        jobs.append((('moe_ep', split), _timed(ranks.all_ranks_job(
            ranks.mesh_job('repro_torch.models.moe:moe_ep_job', 2, cfg=cfg,
                           params=p, x=x, r=x, seq_split=split,
                           device=device)))))
    return jobs


# the sharded w8a8 'tp' step's kernel shapes on a rank of the 2 x 2 mesh:
# its 4 x 256 rows (one dp block of 8 x 256), the column blocks (K, N / 2)
# and the row blocks (K / 2, N) of stablelm's linears, and the lm_head's
# vocab block
SHARDED_ROWS = TRAIN_ROWS // SHARDED_MESH[0]
SHARDED_COLUMNS = ((2048, 1024), (2048, 2816), (2048, 50176))
SHARDED_ROW_BLOCKS = ((1024, 2048), (2816, 2048))


def sharded_kernel_rows(torch, kmods):
    """K3, K4 and K2 at the shapes a rank's w8a8 'tp' step gives them,
    each bit-exact against its plain version and timed: K3 on the bf16
    activations (K = 2048, 5632 / 2 + 1: a row block's codes take the
    whole row's scale through one extra column), K4 on the column blocks,
    K3 on a row block's weight transpose (+1 column) and K2 on the row
    blocks (their int32 sums are all-reduced before the epilogue), beside
    torch._int_mm on the same int8 operands; then the serve's decode-step
    K2 and K7 rows (:func:`sharded_serve_kernel_rows`)."""
    fd, kq, ky, build = kmods
    del fd, build
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(9)
    bf16, m = torch.bfloat16, SHARDED_ROWS
    rows = []
    src_q, rep_q = ('src/repro_torch/csrc/quantize.cu',
                    'src/repro/kernels/quantize.py:35')
    src_v = 'src/repro_torch/csrc/yoco_vmm.cu'

    def k3(x, shape):
        xq, sx = kq.quantize_rows(x)
        xq_p, sx_p = kq.quantize_rows_plain(x)
        torch.cuda.synchronize()
        check(bool(torch.equal(xq, xq_p) and torch.equal(sx, sx_p)),
              f'K3 {shape} not bit-exact')
        r, k = x.shape
        record_row(torch, rows, 'quantize_rows', shape, 0.0, 0.0,
                   lambda: kq.quantize_rows(x),
                   lambda: kq.quantize_rows_plain(x), None,
                   r * k * 2 + r * k + r * 4, source=src_q, replaces=rep_q)
        return xq, sx

    def codes(r, k, shape):
        x = torch.randn((r, k), generator=gen, device=dev).to(bf16)
        return k3(x, shape)

    x_whole = codes(m, 2048, dict(arch=ARCH, path='sharded', operand=
                                  'activation', M=m, K=2048))
    for k, n in SHARDED_COLUMNS:
        wq_t, sw_t = codes(n, k, dict(arch=ARCH, path='sharded', operand=
                                      'column block weight', M=n, K=k))
        xq, sx = x_whole
        wq, sw = wq_t.t(), sw_t.reshape(1, n)
        y = ky.yoco_vmm_int8(xq, wq, sx, sw)
        check(bool(torch.equal(y, ky.yoco_vmm_int8_plain(xq, wq, sx, sw))),
              f'K4 ({m},{k},{n}) differs from its plain version')
        record_row(torch, rows, 'yoco_vmm_int8',
                   dict(arch=ARCH, path='sharded', block='column', M=m, K=k,
                        N=n), 0.0, 0.0,
                   lambda: ky.yoco_vmm_int8(xq, wq, sx, sw),
                   lambda: ky.yoco_vmm_int8_plain(xq, wq, sx, sw),
                   lambda: torch._int_mm(xq, wq),
                   m * k + k * n + 4 * (m + n) + 4 * m * n, 2.0 * m * k * n,
                   source=src_v, replaces='src/repro/kernels/yoco_vmm.py:65',
                   plain_iters=3)
    for k, n in SHARDED_ROW_BLOCKS:
        xq, _ = codes(m, k + 1, dict(arch=ARCH, path='sharded', operand=
                                     'row block activation + 1', M=m,
                                     K=k + 1))
        wq_t, _ = codes(n, k + 1, dict(arch=ARCH, path='sharded', operand=
                                       'row block weight + 1', M=n,
                                       K=k + 1))
        xq = xq[:, :k].contiguous()
        wq = wq_t[:, :k].contiguous().t()
        acc = ky.int8_matmul(xq, wq)
        check(bool(torch.equal(acc, ky.int8_matmul_plain(xq, wq))),
              f'K2 ({m},{k},{n}) differs from its plain version')
        record_row(torch, rows, 'int8_matmul',
                   dict(arch=ARCH, path='sharded', block='row', M=m, K=k,
                        N=n), 0.0, 0.0,
                   lambda: ky.int8_matmul(xq, wq),
                   lambda: ky.int8_matmul_plain(xq, wq),
                   lambda: torch._int_mm(xq, wq),
                   m * k + k * n + 4 * m * n, 2.0 * m * k * n,
                   source=src_v, replaces='src/repro/kernels/yoco_vmm.py:116',
                   plain_iters=3)
    rows += sharded_serve_kernel_rows(torch, kmods, gen)
    return rows


def sharded_serve_kernel_rows(torch, kmods, gen):
    """K2 and K7 at the shapes a rank's decode step of the mesh-sharded
    serve gives them (w8a8 --prequantize, flash): K2 on the rank's 4 rows
    against each column block (q/k/v, gate/up, the lm_head's vocab) and
    row block (wo, w_down) of stablelm's int8 weights, bit-exact against
    its plain version, beside torch._int_mm; K7 on the rank's 16 of 32 KV
    heads planned for all of them (``ways`` = 2), 136-key bf16 cache,
    lock-step at its last position, within 1e-5 of its plain version,
    beside SDPA."""
    import torch.nn.functional as F
    fd, _, ky, _ = kmods
    dev = torch.device('cuda')
    rows = []
    m = SHARDED_SERVE_BATCH // SHARDED_MESH[0]
    src_v = 'src/repro_torch/csrc/yoco_vmm.cu'
    for block, shapes in (('column', SHARDED_COLUMNS),
                          ('row', SHARDED_ROW_BLOCKS)):
        for k, n in shapes:
            xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                               dtype=torch.int8).t()
            acc = ky.int8_matmul(xq, wq)
            check(bool(torch.equal(acc, ky.int8_matmul_plain(xq, wq))),
                  f'K2 serve ({m},{k},{n}) differs from its plain version')
            record_row(torch, rows, 'int8_matmul',
                       dict(arch=ARCH, path='sharded serve decode',
                            block=block, M=m, K=k, N=n), 0.0, 0.0,
                       lambda: ky.int8_matmul(xq, wq),
                       lambda: ky.int8_matmul_plain(xq, wq),
                       lambda: torch._int_mm(xq, wq),
                       m * k + k * n + 4 * m * n, 2.0 * m * k * n,
                       source=src_v,
                       replaces='src/repro/kernels/yoco_vmm.py:116',
                       plain_iters=3)
    hkv, dh = 32 // SHARDED_MESH[1], 64
    s_max = SHARDED_SERVE_PROMPT + SHARDED_SERVE_STEPS
    scale = 1.0 / dh ** 0.5
    pos = torch.full((m,), s_max - 1, dtype=torch.int32, device=dev)
    win = torch.full((m,), s_max + 1, dtype=torch.int32, device=dev)
    q = torch.randn((m, hkv, 1, dh), generator=gen, device=dev)
    kc, vc = (torch.randn((m, s_max, hkv, dh), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    args = (q, kc, vc, pos, win)
    ways = SHARDED_MESH[1]
    got = fd.flash_decode_gqa(*args, scale=scale, ways=ways)
    want = fd.flash_decode_gqa_plain(*args, scale=scale)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), 'K7 sharded serve: not finite')
    q_lib = q.reshape(m, hkv, 1, dh).to(torch.bfloat16)
    k_lib, v_lib = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    record_row(torch, rows, 'flash_decode_contig',
               dict(case='sharded serve decode', B=m, Hkv=hkv, G=1, dh=dh,
                    S=s_max, pool='bfloat16', live_keys=m * s_max,
                    ways=ways),
               float((got - want).abs().max()), 1e-5,
               lambda: fd.flash_decode_gqa(*args, scale=scale, ways=ways),
               lambda: fd.flash_decode_gqa_plain(*args, scale=scale),
               lambda: F.scaled_dot_product_attention(q_lib, k_lib, v_lib,
                                                      scale=scale),
               2 * m * s_max * hkv * dh * 2 + 2 * q.numel() * 4,
               4.0 * dh * hkv * m * s_max, roofline.PEAK_FLOPS_BF16,
               source='src/repro_torch/csrc/flash_decode.cu',
               replaces='src/repro/kernels/flash_decode.py:252',
               kernels_per_launch=2)
    return rows


def _moe_ep_output(outs, seq_split):
    """moe_ep's global (B, S, d) output from the 2 x 2 ranks' blocks."""
    rows = []
    for d in range(SHARDED_MESH[0]):
        mine = outs[d * SHARDED_MESH[1]:(d + 1) * SHARDED_MESH[1]]
        rows.append(np.concatenate([o['y'] for o in mine], 1) if seq_split
                    else mine[0]['y'])
    return np.concatenate(rows)


def sharded_phase(torch, kmods):
    """Sharded training on a 2 x 2 rank mesh (``runtime/train_step.py::
    sharded_train_step``), four rank processes on ``cuda:0`` over gloo
    (a card a rank over nccl on a four-card machine). (1) Smoke size, the
    card against the CPU from the same seed-0 inputs: the 8 rows of the
    reference's distributed parity (stablelm, deepseek-v3 and qwen2-moe
    expert-parallel at capacity 100, mamba2; 'tp' and 'fsdp2d'), each
    sharded loss within SHARDED_SMOKE_TOL of the CPU group's; moe_ep with
    capacity drops, outputs within MOE_EP_TOL and the same drop fraction.
    (2) stablelm-1.6b at its published width (SHARDED_LAYERS deep), global
    batch 8 x 256, SHARDED_STEPS AdamW steps in each of SHARDED_RUNS, held
    to the one-device ``make_train_step`` on the same draw and batch: loss
    1e-3 and grad norm 5e-3 relative each step; after the first step
    each param within 2.2 lr and at most 3% of them (the train phase's
    one-step bounds) or SHARDED_CONTROL_FACTOR times the control's share
    off by more than 1e-6 (the control: the one-device trainer at
    grad_accum 2 against itself at 1; the second step's shares are
    reported); finite losses; each rank's master and moment bytes its
    blocks' under the specs; the collectives and the K3/K4/K2 launches a
    step exactly :func:`sharded_counts`; with remat 'full' each rank holds
    fewer bytes after a forward than without (the peaks of a forward and
    backward with and without remat, and of a step, are reported: at
    this depth they come after the activations are freed). Reports step ms, tokens/s,
    peak and held memory a rank and the bytes gathered, reduced and
    exchanged a step. The ranks
    share one card: correctness, not sharded speed. (3) K3/K4/K2 rows at a
    rank's w8a8 'tp' shapes (:func:`sharded_kernel_rows`). Returns (rows,
    launch totals over every rank's steps, kernel rows)."""
    from repro_torch.data import synthetic
    from repro_torch.distributed import ranks, sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime import train_step as TS

    t_phase = time.perf_counter()
    n = SHARDED_MESH[0] * SHARDED_MESH[1]
    smoke = _sharded_smoke_jobs()
    cfg = _sharded_cfg()
    check(cfg.d_model == 2048 and cfg.n_heads == 32 and cfg.d_ff == 5632
          and cfg.vocab_size == 100352, f'{ARCH} is not at its published '
                                        f'width')
    # the dry run of the phase's steps on the meta device, before the
    # ranks start; ranks that share a card over gloo stage each
    # reduce-scatter's input on it
    from repro_torch.launch import dryrun
    devs, backend = ranks.placement(n)
    dry, dry_s = sharded_dryrun(
        cfg, dryrun.GLOO_CUDA_STAGING if backend == 'gloo' else None)
    print(f'sharded dry run: {dry_s:.1f} s', flush=True)
    batch = {k: v.numpy() for k, v in synthetic.make_batch(
        synthetic.for_arch(cfg, global_batch=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ), 0).items()}
    full = [ranks.all_ranks_job(ranks.mesh_job(
        'chip_smoke:sharded_rank_job', SHARDED_MESH[1], cfg=cfg, mode=mode,
        layout=layout, remats=remats, steps=SHARDED_STEPS, batch=batch,
        check_ref=True, control=i == 0))
        for i, (mode, layout, remats) in enumerate(SHARDED_RUNS)]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(SHARDED_SERVE_BATCH, SHARDED_SERVE_PROMPT))
    serves = [ranks.all_ranks_job(ranks.mesh_job(
        'repro_torch.runtime.serve_step:sharded_serve_job', SHARDED_MESH[1],
        cfg=cfg, prompts=prompts, steps=SHARDED_SERVE_STEPS, seed=0,
        mode=mode, prequant=prequant, attn_impl='flash',
        compute_dtype=torch.bfloat16, reference=True))
        for mode, prequant in SHARDED_SERVES]
    # ranks sharing a card over gloo run the CPU's smoke jobs too (gloo
    # takes CPU tensors); over nccl a CPU group of its own runs them
    cpu_jobs = [j for _, j in _sharded_smoke_jobs('cpu')]
    in_group = backend == 'gloo'
    t0, t0_wall = time.perf_counter(), time.time()
    card = ranks.run([j for _, j in smoke] + full + serves
                     + (cpu_jobs if in_group else []), (devs, backend))
    card_s = time.perf_counter() - t0
    if in_group:
        cpu, cpu_s = card[-len(cpu_jobs):], None
    else:
        t0 = time.perf_counter()
        cpu = ranks.run(cpu_jobs, ranks.placement(n, 'cpu'))
        cpu_s = time.perf_counter() - t0
    rows = []
    smoke_rows = []
    failures = []

    def gate(cond, msg):
        # every row is printed first; the phase fails on any gate after
        if not cond:
            failures.append(msg)
            print(f'sharded gate failed: {msg}', flush=True)
    def untimed(out):
        # (result, seconds), or every rank's (result, seconds)
        if isinstance(out, list):
            return [o[0] for o in out], max(o[1] for o in out)
        return out
    smoke_s = []
    for (key, _), c, g in zip(smoke, cpu, card):
        (c, c_s), (g, g_s) = untimed(c), untimed(g)
        smoke_s.append(dict(job=list(map(str, key)), card_s=g_s, cpu_s=c_s))
        if key[0] == 'moe_ep':
            err = float(np.abs(_moe_ep_output(c, key[1])
                               - _moe_ep_output(g, key[1])).max())
            drops = [o['metrics']['drop_fraction'] for o in c + g]
            gate(err <= MOE_EP_TOL and len(set(drops)) == 1
                  and 0 < drops[0] < 1,
                  f'sharded smoke moe_ep seq_split={key[1]}: card vs CPU '
                  f'{err}, drop fractions {drops}')
            smoke_rows.append(dict(row='moe_ep', seq_split=key[1],
                                   max_abs_err=err, tol=MOE_EP_TOL,
                                   drop_fraction=drops[0]))
            continue
        rel = abs(g['loss'] - c['loss']) / abs(c['loss'])
        gate(np.isfinite(g['loss']) and rel <= SHARDED_SMOKE_TOL,
              f'sharded smoke {key}: loss {g["loss"]} on the card, '
              f'{c["loss"]} on the CPU')
        smoke_rows.append(dict(row=key[0], layout=key[1], card=g['loss'],
                               cpu=c['loss'], rel_err=rel,
                               tol=SHARDED_SMOKE_TOL))
    rows.append(dict(smoke=smoke_rows, cpu_group_s=cpu_s,
                     smoke_job_s=smoke_s))
    print(f'sharded smoke: {json.dumps(rows[-1])}', flush=True)
    mesh = mesh_mod.shape_mesh(dict(data=SHARDED_MESH[0],
                                    model=SHARDED_MESH[1]))
    runs = card[len(smoke):len(smoke) + len(full)]
    served = card[len(smoke) + len(full):len(smoke) + len(full)
                  + len(serves)]
    control = runs[0][0]['control']
    for (mode, layout, remats), outs in zip(SHARDED_RUNS, runs):
        remat = remats[0]
        tag = f'sharded {cfg.name} {mode} {layout} remat={remat}'
        r0 = outs[0]
        ref = r0['reference']
        for o in outs:
            gate(all(np.isfinite(o['losses'])), f'{tag}: a loss is not '
                                                 f'finite: {o["losses"]}')
            gate(o['losses'] == r0['losses'], f'{tag}: ranks disagree on '
                                               f'the loss')
        loss_err = max(abs(a - b['loss']) / abs(b['loss'])
                       for a, b in zip(r0['losses'], ref))
        gn_err = max(abs(a - b['grad_norm']) / b['grad_norm']
                     for a, b in zip(r0['grad_norms'], ref))
        gate(loss_err <= TRAIN_LOSS_TOL, f'{tag}: loss {r0["losses"]} '
                                          f'against {ref}')
        gate(gn_err <= TRAIN_GNORM_TOL, f'{tag}: grad norm '
                                         f'{r0["grad_norms"]} against {ref}')
        # the train phase's bounds are one step's: the first step's
        # params, each within 2.2 lr; the share off by > 1e-6 at most the
        # train phase's or SHARDED_CONTROL_FACTOR times the control's (at
        # the published vocab the lm_head's ~1e-7 gradients sit in
        # AdamW's eps region, where any reassociation moves an update)
        share = max(TRAIN_PARAM_SHARE * r0['params'],
                    SHARDED_CONTROL_FACTOR * control['params_off'])
        gate(r0['worst_param_err'][0] <= 2.2 * TRAIN_LR
             and r0['params_off'][0] <= share,
             f'{tag}: {r0["params_off"][0]} of {r0["params"]} params off '
             f'by > 1e-6 after the first step (bound {share}), the worst '
             f'by {r0["worst_param_err"][0]}')
        pabs, oabs = TS.abstract_state(cfg)
        pspecs, _, _ = TS.state_shardings(mesh, cfg, pabs, oabs, layout)
        calls, launches = sharded_counts(cfg, mode, layout, remat)
        for o in outs:
            cut = mesh_mod.shape_mesh(mesh.shape, rank=o['rank'])
            want = sum(int(np.prod(sharding.block(
                torch.empty(leaf.shape, device='meta'), spec, cut).shape))
                * 4 for leaf, spec in sharding.leaves_with_specs(pabs,
                                                                 pspecs))
            gate(o['master_bytes'] == want
                  and o['moment_bytes'] == 2 * want,
                  f'{tag}: rank {o["rank"]} holds {o["master_bytes"]} '
                  f'master and {o["moment_bytes"]} moment bytes, its '
                  f'blocks {want}')
            got = {k: o['calls'][k] for k in calls}
            gate(got == calls, f'{tag}: rank {o["rank"]} made {got} '
                                f'collectives a step, derived {calls}')
            got = {k: o['launches'].get(k, 0) for k in launches}
            gate(got == launches, f'{tag}: rank {o["rank"]} launched '
                                   f'{got} a step, derived {launches}')
        # the dry run of the step on the meta device: what each rank
        # counted, its blocks' bytes, its peak
        d = dry['train', mode, layout]
        dc, darg = d['collectives'], d['argument_bytes']
        step_peaks = []
        for o in outs:
            got = {k: o['calls'][k] for k in dc['calls']}
            gate(got == dc['calls'] and o['bytes'] == dc['bytes'],
                 f'{tag}: rank {o["rank"]} made {got}, {o["bytes"]}; the '
                 f'dry run counts {dc["calls"]}, {dc["bytes"]}')
            gate(o['master_bytes'] == darg['params']
                 and o['moment_bytes'] == darg['opt'],
                 f'{tag}: rank {o["rank"]} holds {o["master_bytes"]} + '
                 f'{o["moment_bytes"]}, the dry run {darg}')
            step_peaks.append(o['peak_bytes'][remat]
                              - o['before_step_bytes']
                              + o['master_bytes'] + o['moment_bytes'])
        peak_err = max(abs(d['memory']['peak_bytes'] - p) / p
                       for p in step_peaks)
        gate(peak_err <= SHARDED_PEAK_TOL,
             f'{tag}: the dry run\'s peak {d["memory"]["peak_bytes"]} '
             f'against the ranks\' step peaks {step_peaks}')
        if (mode, layout) == ('bf16', 'tp'):
            got = {k: dc['bytes'][k] for k in SHARDED_TP_BYTES}
            gate(got == SHARDED_TP_BYTES
                 and (darg['params'], darg['opt']) == SHARDED_TP_ARGS,
                 f'{tag}: the dry run counts {got} and {darg}, PERF '
                 f'{SHARDED_TP_BYTES} and {SHARDED_TP_ARGS}')
        step_ms = _median([o['step_ms'][-1] for o in outs])
        if len(remats) > 1:
            for o in outs:
                # the held bytes: at this depth the peak comes after the
                # layers' activations are freed (the optimizer's or the
                # gradients' buffers), the same with and without remat
                gate(o['held_bytes']['full'] < o['held_bytes']['none'],
                     f'{tag}: rank {o["rank"]} holds '
                     f'{o["held_bytes"]["full"]} bytes after a forward '
                     f'with remat full, {o["held_bytes"]["none"]} without')
        rows.append(dict(
            arch=cfg.name, layers=cfg.n_layers, mode=mode, layout=layout,
            remat=remat, mesh=dict(data=SHARDED_MESH[0],
                                   model=SHARDED_MESH[1]),
            backend=backend, devices=[o['device'] for o in outs],
            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=SHARDED_STEPS,
            losses=r0['losses'], reference=ref, loss_rel_err=loss_err,
            grad_norm_rel_err=gn_err, params_off=r0['params_off'],
            params_off_by_shape=r0['params_off_by_shape'],
            params=r0['params'], worst_param_err=r0['worst_param_err'],
            control=control, remats=list(remats),
            seconds_a_rank=[o['seconds'] for o in outs],
            step_ms=[o['step_ms'] for o in outs], median_step_ms=step_ms,
            tokens_per_s=TRAIN_ROWS / (step_ms / 1e3),
            peak_bytes_a_rank=[o['peak_bytes'] for o in outs],
            held_bytes_a_rank=[o['held_bytes'] for o in outs],
            forward_backward_peak_bytes_a_rank=[
                o['forward_backward_peak_bytes'] for o in outs],
            master_bytes_a_rank=[o['master_bytes'] for o in outs],
            moment_bytes_a_rank=[o['moment_bytes'] for o in outs],
            collectives_a_step=calls, bytes_a_step=r0['bytes'],
            launches_a_step=r0['launches'],
            dryrun=dict(peak_bytes=d['memory']['peak_bytes'],
                        step_peak_bytes_a_rank=step_peaks,
                        peak_rel_err=peak_err, flops=d['flops'],
                        seconds=d['dryrun_s'])))
        print(f'sharded run: {json.dumps(rows[-1])}', flush=True)
    totals = {k: 0 for k in kmods[3].LAUNCHES}
    for outs in runs:
        for o in outs:
            for k, v in o['launches'].items():
                totals[k] += v * SHARDED_STEPS
    for (mode, prequant), outs in zip(SHARDED_SERVES, served):
        rows.append(_serve_gates(cfg, mode, prequant, outs, dry, gate))
        print(f'sharded serve: {json.dumps(rows[-1])}', flush=True)
        for o in outs:
            for step in o['launches']:
                for k, v in step.items():
                    totals[k] += v
    check(not failures, '; '.join(failures))
    kernel_rows = sharded_kernel_rows(torch, kmods)
    print(f'sharded kernel rows: {len(kernel_rows)}', flush=True)
    rows.append(dict(card_group_s=card_s,
                     # the group's start and its smoke jobs, to the first
                     # full-width run
                     spawn_and_smoke_s=runs[0][0]['started'] - t0_wall,
                     dryrun_s=dry_s,
                     serve_s=[max(o['job_s'] for o in outs)
                              for outs in served],
                     phase_s=time.perf_counter() - t_phase))
    print(f'sharded phase: {rows[-1]["phase_s"]:.1f} s', flush=True)
    return rows, totals, kernel_rows


def all_kernel_phases(torch, kmods, nan=None):
    """Phase 2: every kernel against its plain version; the rows (K3's
    NaN-row reports go to ``nan``). Each part prints its seconds."""
    t0 = [time.perf_counter()]

    def passed(what):
        now = time.perf_counter()
        print(f'{what} checks passed ({now - t0[0]:.1f} s)', flush=True)
        t0[0] = now

    rows = kernel_phase(torch, kmods, nan)
    passed(f'kernel: {len(rows)} shapes')
    rows += tier_chunk_kernel_phase(torch, kmods)
    passed('K5/K6')
    rows += paged_split_kernel_phase(torch, kmods)
    passed('K1/K6 G>1 (the dense family\'s layouts) and W=512')
    rows += window_kernel_phase(torch, kmods)
    passed('K1/K5 at gemma3\'s 1,024-key window')
    rows += mla_kernel_phase(torch, kmods)
    passed('K8/K9/K10')
    rows += contig_kernel_phase(torch, kmods)
    passed('K7')
    rows += moe_kernel_phase(torch, kmods)
    passed('K5/K7 at qwen2-moe\'s heads')
    rows += frontend_kernel_phase(torch, kmods)
    passed('K7 at qwen2-vl\'s G=8')
    return rows


def all_profiles(torch, kmods):
    """Phase 4 on both models."""
    del kmods
    return (profile_phase(torch)
            + profile_phase(torch, MLA_ARCH, MLA_PROFILE_MODES))


def static_rows(torch, kmods):
    """Phase 5's static serve() runs and their profiles."""
    return static_serve_phase(torch, kmods[3])[0]


def dense_rows(torch, kmods):
    """Phase 5b, the dense family at full width, alone."""
    return dense_phase(torch, kmods[3])[0]


def moe_rows(torch, kmods):
    """Phase 5c, the MoE configs at full width, alone."""
    return moe_phase(torch, kmods[3])[0]


def ssm_rows(torch, kmods):
    """Phase 5d, the recurrent configs at full width and depth, alone."""
    return ssm_phase(torch, kmods[3])[0]


def frontends_rows(torch, kmods):
    """Phase 5e, the non-token frontends, alone."""
    return frontends_phase(torch, kmods[3])[0]


def fidelity_rows(torch, kmods):
    """Phase 5f, the paper-fidelity modes at full width, alone."""
    return fidelity_phase(torch, kmods[3])[0]


def train_rows(torch, kmods):
    """Phase 5g, training, alone (its K3/K4 rows after its runs)."""
    rows, _, kernel_rows = train_phase(torch, kmods)
    return rows + kernel_rows


# ``--phase NAME``: the build and that phase alone, to compare two trees
# (copy this script into the other tree's root) or to rehearse a kernel
def chaos_rows(torch, kmods):
    """Phase 6 alone."""
    return chaos_phase(torch, kmods[3])


def tp_rows(torch, kmods):
    """Phase 7 alone."""
    return tp_phase(torch, kmods[3])


def sharded_rows(torch, kmods):
    """Phase 8 alone (its K2/K3/K4 rows after its runs)."""
    rows, _, kernel_rows = sharded_phase(torch, kmods)
    return rows + kernel_rows


PHASES = dict(kernels=all_kernel_phases, profile=all_profiles,
              static=static_rows, nan=nan_kernel_phase, chaos=chaos_rows,
              dense=dense_rows, moe=moe_rows, ssm=ssm_rows,
              frontends=frontends_rows, fidelity=fidelity_rows,
              train=train_rows, tp=tp_rows, sharded=sharded_rows)


def print_redesigned(rows):
    """Every row of the redesigned kernels, on one line."""
    keys = ('shape', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
            'kernels_per_call', 'timer', 'max_abs_err', 'plan', 'streamed_ms',
            'cold_ms', 'library_cold_ms', 'cold_ms_runs',
            'library_cold_ms_runs', 'k1_ms_same_inputs',
            'k1_cold_ms_same_inputs', 'bit_equal_k1_at_full_hot_window',
            'k8_ms_same_inputs', 'k8_cold_ms_same_inputs',
            'bit_equal_k8_at_full_hot_window', 'ms_per_row_key',
            'k8_ms_per_row_key')
    print(json.dumps(dict(redesigned=[
        dict(name=r['name'], **{k: r[k] for k in keys if k in r})
        for r in rows if r['name'] in REDESIGNED])), flush=True)


def run_phases(torch, report, kmods):
    """The check phases after the build; fills ``report`` as they pass and
    returns each main path's launch totals, by arch."""
    from repro_torch import configs
    gqa = configs.get(ARCH, smoke=False)
    check(gqa.n_layers == LAYERS_FULL and gqa.d_model == 2048
          and gqa_counts(gqa) == (LINEARS_PER_FORWARD,
                                  ACTIVATIONS_PER_FORWARD),
          'stablelm-1.6b FULL config changed')
    mla = register_dense_prefix()
    register_moe5()
    register_vl_cuts()
    check(mla.n_layers == MLA_LAYERS and mla.d_model == 7168
          and mla.n_heads == 128 and mla.d_ff == 18432
          and mla.vocab_size == 129280 and mla.moe is None
          and mla.mla.kv_lora_rank == 512 and mla.mla.rope_head_dim == 64,
          'deepseek-v3 dense prefix is not at the published width')
    # each phase's wall time (the run must end within its time limit)
    phase_s = report['phase_s'] = {}
    t0 = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - t0[0]
        t0[0] = now
        print(f'phase {name}: {phase_s[name]:.1f} s', flush=True)

    k3_nan = []
    report['kernel_sweep'] = all_kernel_phases(torch, kmods, k3_nan)
    lap('kernels')
    report['nan'] = nan_kernel_phase(torch, kmods, k3=k3_nan)
    lap('nan')
    report['smoke'] = (smoke_phase(torch)
                       + smoke_phase(torch, ARCH, FIDELITY_SMOKE_MODES)
                       + smoke_tier_prefix_phase(torch)
                       + smoke_phase(torch, MLA_ARCH, MLA_SMOKE_MODES)
                       + smoke_tier_prefix_phase(torch, MLA_ARCH)
                       + smoke_static_phase(torch)
                       + [row for arch in DENSE_ARCHS
                          for row in smoke_phase(torch, arch)]
                       + smoke_phase(torch, MOE_ARCH)
                       + smoke_phase(torch, MOE5_ARCH, (('bf16', False),
                                                        ('w8a8', False)))
                       + smoke_phase(torch, SSM_ARCH)
                       + smoke_phase(torch, HYB_ARCH, (('bf16', False),
                                                       ('w8a8', False)))
                       + smoke_tier_prefix_phase(torch, HYB_ARCH,
                                                 paths=('tier',)))
    print(f'smoke parity: {json.dumps(report["smoke"])}', flush=True)
    lap('smoke')
    report['profile'] = all_profiles(torch, kmods)
    lap('profile')
    report['serve'], gqa_totals = serve_phase(torch, kmods[3])
    mla_serve, mla_totals = serve_phase(torch, kmods[3], MLA_ARCH,
                                        MLA_SERVE_RUNS, _mla_launches)
    report['serve'] += mla_serve
    lap('serve')
    report['dense'], dense_totals = dense_phase(torch, kmods[3])
    lap('dense')
    report['moe'], moe_totals = moe_phase(torch, kmods[3])
    lap('moe')
    report['ssm'], ssm_totals = ssm_phase(torch, kmods[3])
    lap('ssm')
    report['frontends'], frontend_totals = frontends_phase(torch, kmods[3])
    lap('frontends')
    report['fidelity'], fidelity_totals = fidelity_phase(torch, kmods[3])
    lap('fidelity')
    report['train'], train_totals, train_kernel = train_phase(torch, kmods)
    report['kernel_sweep'] += train_kernel
    lap('train')
    report['static_serve'], static_totals, moe_static_totals = \
        static_serve_phase(torch, kmods[3])
    lap('static')
    report['chaos'] = chaos_phase(torch, kmods[3])
    lap('chaos')
    report['tp'] = tp_phase(torch, kmods[3])
    lap('tp')
    report['sharded'], sharded_totals, sharded_kernel = sharded_phase(
        torch, kmods)
    report['kernel_sweep'] += sharded_kernel
    lap('sharded')
    for k in gqa_totals:
        check(gqa_totals[k] + mla_totals[k] + static_totals[k] > 0,
              f'kernel {k} was never launched on the main paths')
    return {ARCH: gqa_totals, MLA_ARCH: mla_totals,
            STATIC_PATH: static_totals, DENSE_PATH: dense_totals,
            MOE_PATH: moe_totals, MOE_STATIC_PATH: moe_static_totals,
            SSM_PATH: ssm_totals, FRONTEND_PATH: frontend_totals,
            FIDELITY_PATH: fidelity_totals, TRAIN_PATH: train_totals,
            SHARDED_PATH: sharded_totals}


def main(argv) -> int:
    import torch
    phase = None
    if argv:
        if len(argv) != 2 or argv[0] != '--phase' or argv[1] not in PHASES:
            print(f'usage: python3 chip_smoke.py [--phase '
                  f'{"|".join(PHASES)}]', file=sys.stderr)
            return 2
        phase = argv[1]
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, 'repro_torch')):
        print(f'chip_smoke: {SRC}/repro_torch not found: run from a '
              f'checkout of the repository', file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    global roofline
    from repro_torch.core import roofline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quantize as kq
    from repro_torch.kernels import yoco_vmm as ky

    smi = smi_line()
    print(smi, flush=True)
    report = dict(smi=smi, device=torch.cuda.get_device_name(0))
    t0 = time.time()
    build.build()
    report['build_s'] = time.time() - t0
    report['build_logs'] = dict(build.BUILD_LOGS)
    print(f'built kernels in {report["build_s"]:.1f} s', flush=True)
    for name, log in build.BUILD_LOGS.items():
        print(f'--- nvcc {name}.cu\n{log.strip()}', flush=True)
    report['ptxas'] = ptxas_summary(build.BUILD_LOGS)
    print(json.dumps(dict(ptxas=report['ptxas'])), flush=True)
    kmods = (fd, kq, ky, build)
    if phase is not None:
        register_dense_prefix()
        register_moe5()
        register_vl_cuts()
        try:
            report[phase] = PHASES[phase](torch, kmods)
        finally:
            report['profiler_misses'] = PROFILER_MISSES
            os.makedirs(OUT_DIR, exist_ok=True)
            with open(os.path.join(OUT_DIR, f'chip_smoke_{phase}.json'),
                      'w') as f:
                json.dump(report, f, indent=1)
        if phase == 'kernels':
            print_redesigned(report[phase])
            print(json.dumps(dict(kernels=[
                dict(name=r['name'], shape=r['shape'], ms=r['ms'],
                     timer=r['timer']['ms'],
                     kernels_per_call=r['kernels_per_call'])
                for r in report[phase]])), flush=True)
        print(json.dumps(dict(profiler_misses=PROFILER_MISSES)), flush=True)
        print(smi, flush=True)
        return 0
    try:
        totals = run_phases(torch, report, kmods)
    finally:
        report['profiler_misses'] = PROFILER_MISSES
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, 'chip_smoke.json'), 'w') as f:
            json.dump(report, f, indent=1)
    rows = report['kernel_sweep']
    # one line per kernel and main path it runs on, at that path's decode
    # shape, with that path's launches; K5 and K9 at the page-size chunk
    # of a prefix hit, which carries most of their launches (K9 on both
    # pool dtypes); K2/K3/K4 on the static path at its prefill's 1024 rows
    # through q/k/v/o, the shape no other path gives them (its decode
    # shape is the continuous path's M=8)
    pick = (('flash_decode_paged', ARCH, dict(pool='bfloat16', W=20, G=1)),
            ('flash_decode_contig', STATIC_PATH, dict(pool='bfloat16',
                                                      case='lockstep')),
            ('flash_chunk_paged', ARCH, dict(pool='bfloat16', C=8,
                                             offset=96)),
            ('flash_decode_paged_q8', ARCH, dict(pool='bfloat16', W=20,
                                                 G=1)),
            ('flash_decode_paged_mla', MLA_ARCH, dict(pool='bfloat16',
                                                      case='serving')),
            ('flash_chunk_paged_mla', MLA_ARCH, dict(pool='bfloat16', C=8,
                                                     offset=96)),
            ('flash_chunk_paged_mla', MLA_ARCH, dict(pool='float32', C=8,
                                                     offset=96)),
            ('flash_decode_paged_mla_q8', MLA_ARCH, dict(pool='bfloat16',
                                                         case='serving')),
            ('quantize_rows', ARCH, dict(arch=ARCH, M=8, K=2048,
                                         dtype='bfloat16')),
            ('quantize_rows', MLA_ARCH, dict(arch=MLA_ARCH, M=8, K=7168,
                                             dtype='bfloat16')),
            ('quantize_rows', STATIC_PATH,
             dict(arch=ARCH, M=STATIC_PREFILL_ROWS, K=2048,
                  dtype='bfloat16')),
            ('int8_matmul', ARCH, dict(arch=ARCH, M=8, K=2048, N=100352)),
            ('int8_matmul', STATIC_PATH,
             dict(arch=ARCH, M=STATIC_PREFILL_ROWS, K=2048, N=2048)),
            ('yoco_vmm_int8', ARCH, dict(arch=ARCH, M=8, K=2048, N=100352)),
            ('yoco_vmm_int8', STATIC_PATH,
             dict(arch=ARCH, M=STATIC_PREFILL_ROWS, K=2048, N=2048)),
            ('yoco_vmm_int8', MLA_ARCH, dict(arch=MLA_ARCH, M=8, K=7168,
                                             N=129280)),
            # the dense family: K1 at stablelm-12b's G=4, dh=160, K6 at
            # gemma3's G=2, K5 at gemma3's windowed 128-token chunk, the
            # int8 linears at each config's widest decode product
            ('flash_decode_paged', DENSE_PATH, dict(pool='bfloat16',
                                                    case='stablelm-12b')),
            ('flash_decode_paged_q8', DENSE_PATH, dict(pool='bfloat16',
                                                       case='gemma3-27b')),
            ('flash_chunk_paged', DENSE_PATH, dict(pool='bfloat16', C=128,
                                                   offset=1024)),
            ('quantize_rows', DENSE_PATH, dict(arch='stablelm-12b', M=8,
                                               K=5120, dtype='bfloat16')),
            ('int8_matmul', DENSE_PATH, dict(arch='gemma3-27b', M=8,
                                             K=5376, N=262144)),
            ('yoco_vmm_int8', DENSE_PATH, dict(arch='starcoder2-15b', M=8,
                                               K=6144, N=49152)),
            # the MoE configs: K1/K6 and K5 at qwen2-moe's heads (Hkv=16,
            # G=1, dh=128), K2 at its lm_head, K3/K4 at deepseek-v3's
            # shared FFN gate/up, K8-K10 at the dense prefix's shapes (the
            # same attention); K7 on qwen2-moe's static path
            ('flash_decode_paged', MOE_PATH, dict(pool='bfloat16',
                                                  case=MOE_ARCH)),
            ('flash_decode_paged_q8', MOE_PATH, dict(pool='bfloat16',
                                                     case=MOE_ARCH)),
            ('flash_chunk_paged', MOE_PATH, dict(pool='bfloat16', Hkv=16,
                                                 C=8, offset=96)),
            ('int8_matmul', MOE_PATH, dict(arch=MOE_ARCH, M=8, K=2048,
                                           N=151936)),
            ('quantize_rows', MOE_PATH, dict(arch=MOE5_ARCH, M=8, K=7168,
                                             dtype='bfloat16')),
            ('yoco_vmm_int8', MOE_PATH, dict(arch=MOE5_ARCH, M=8, K=7168,
                                             N=2048)),
            ('flash_decode_paged_mla', MOE_PATH, dict(pool='bfloat16',
                                                      case='serving')),
            ('flash_chunk_paged_mla', MOE_PATH, dict(pool='bfloat16', C=8,
                                                     offset=96)),
            ('flash_decode_paged_mla_q8', MOE_PATH, dict(pool='bfloat16',
                                                         case='serving')),
            ('flash_decode_contig', MOE_STATIC_PATH,
             dict(pool='bfloat16', case='lockstep', Hkv=16)),
            # the recurrent configs: zamba2's sites decode at stablelm's
            # heads (Hkv=32, G=1, dh=64), paged, over the tier and, in its
            # static serve(), contiguous at S=160; the int8 linears at
            # mamba2's in_proj (K2, K3) and tied head (K4)
            ('flash_decode_paged', SSM_PATH, dict(pool='bfloat16', W=20,
                                                  G=1)),
            ('flash_decode_paged_q8', SSM_PATH, dict(pool='bfloat16', W=20,
                                                     G=1)),
            ('flash_decode_contig', SSM_PATH, dict(pool='bfloat16',
                                                   case='lockstep')),
            ('quantize_rows', SSM_PATH, dict(arch=SSM_ARCH, M=8, K=1536,
                                             dtype='bfloat16')),
            ('int8_matmul', SSM_PATH, dict(arch=SSM_ARCH, M=8, K=1536,
                                           N=6448)),
            ('yoco_vmm_int8', SSM_PATH, dict(arch=SSM_ARCH, M=8, K=1536,
                                             N=50280)),
            # the non-token frontends' static serve(): K7 at qwen2-vl's
            # G=8, dh=128; the int8 linears at its lm_head (K2, K4; N =
            # 152064) and its decode activation (K3, K = 8192)
            ('flash_decode_contig', FRONTEND_PATH,
             dict(pool='bfloat16', case='lockstep', Hkv=8, G=8)),
            ('quantize_rows', FRONTEND_PATH, dict(arch=VL_ARCH, M=8, K=8192,
                                                  dtype='bfloat16')),
            ('int8_matmul', FRONTEND_PATH, dict(arch=VL_ARCH, M=8, K=8192,
                                                N=152064)),
            ('yoco_vmm_int8', FRONTEND_PATH, dict(arch=VL_ARCH, M=8, K=8192,
                                                  N=152064)),
            # the paper-fidelity modes on stablelm: its decode shapes (K3
            # the decode activation, K2/K4 the lm_head, K1 the serving row)
            ('flash_decode_paged', FIDELITY_PATH, dict(pool='bfloat16', W=20,
                                                       G=1)),
            ('quantize_rows', FIDELITY_PATH, dict(arch=ARCH, M=8, K=2048,
                                                  dtype='bfloat16')),
            ('int8_matmul', FIDELITY_PATH, dict(arch=ARCH, M=8, K=2048,
                                                N=100352)),
            ('yoco_vmm_int8', FIDELITY_PATH, dict(arch=ARCH, M=8, K=2048,
                                                  N=100352)),
            # training at full width: K3 on the widest activation, K4 on
            # the lm_head, both at M = 8 x 256 rows
            ('quantize_rows', TRAIN_PATH, dict(path='train',
                                               operand='activation',
                                               M=TRAIN_ROWS, K=5632)),
            ('yoco_vmm_int8', TRAIN_PATH, dict(path='train', M=TRAIN_ROWS,
                                               K=2048, N=100352)),
            # sharded training, a rank of the 2 x 2 mesh in w8a8 'tp': K3
            # on its rows' activation, K4 on the lm_head's vocab block, K2
            # on w_down's row block
            ('quantize_rows', SHARDED_PATH, dict(path='sharded',
                                                 operand='activation',
                                                 M=SHARDED_ROWS, K=2048)),
            ('yoco_vmm_int8', SHARDED_PATH, dict(path='sharded',
                                                 block='column', N=50176)),
            ('int8_matmul', SHARDED_PATH, dict(path='sharded', block='row',
                                               K=2816)))
    check({name for name, _, _ in pick} == set(totals[ARCH]),
          'the kernels line does not cover every kernel')
    kernels = []
    for name, path, want in pick:
        for r in rows:
            if r['name'] == name and all(r['shape'].get(k) == v
                                         for k, v in want.items()):
                kernels.append(dict(
                    name=name, path=path, route=r['route'],
                    source=r['source'], replaces=r['replaces'],
                    launches=totals[path][name],
                    max_abs_err=r['max_abs_err'], ms=r['ms'],
                    plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                    bound_by=r['bound_by'], library_ms=r['library_ms'],
                    kernels_per_call=r['kernels_per_call'],
                    timer=r['timer'], shape=r['shape']))
                break
        else:
            check(False, f'no kernel row for {name} at {want}')
        check(kernels[-1]['launches'] > 0,
              f'{name} was never launched on the {path} path')
    print(json.dumps(dict(kernels=kernels)), flush=True)
    # every shape of the redesigned kernels, K2 and K4 (M = 8, 128 and the
    # static prefill's 1024) and K7 (warm and cold)
    print_redesigned(rows)
    print(json.dumps(dict(profiler_misses=PROFILER_MISSES)), flush=True)
    print(json.dumps(dict(serve=report['serve'])), flush=True)
    print(json.dumps(dict(dense=report['dense'])), flush=True)
    print(json.dumps(dict(moe=report['moe'])), flush=True)
    print(json.dumps(dict(static_serve=report['static_serve'])), flush=True)
    print(json.dumps(dict(chaos=report['chaos'])), flush=True)
    print(json.dumps(dict(ssm=report['ssm'])), flush=True)
    print(json.dumps(dict(frontends=report['frontends'])), flush=True)
    print(json.dumps(dict(fidelity=report['fidelity'])), flush=True)
    print(json.dumps(dict(train=report['train'])), flush=True)
    print(json.dumps(dict(tp=report['tp'])), flush=True)
    print(json.dumps(dict(sharded=report['sharded'])), flush=True)
    print(json.dumps(dict(script_s=time.time() - T_START, smi=smi)),
          flush=True)
    print(smi, flush=True)
    print(json.dumps(dict(ok=True, device=dict(
        platform='gpu', kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f'chip_smoke: FAIL: {e}', file=sys.stderr)
        sys.exit(1)

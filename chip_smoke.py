"""GPU smoke run of the PyTorch/CUDA port's main path (needs one CUDA card).

    python3 chip_smoke.py

Phases, each failing the run on any error:

1. build — compile every CUDA kernel of the path from ``src/repro_torch/
   kernels/csrc`` (one nvcc per source, in parallel) into build/repro_torch/,
   and count the tensor-core instructions (IMMA, IGMMA, HMMA) in each
   library's SASS (``cuobjdump -sass``), in all and per kernel function: the
   three plane libraries must hold IMMA, the attention library HMMA, and
   HMMA must show in each of its tensor-core functions (the dense prefill
   body and both decode split functions, paged and dense);
2. kernel checks — each kernel against its plain PyTorch version on the
   card at the main path's shapes (granite-3-8b gate / down / lm_head at
   decode M=4 and prefill M=256): raw int32 bit-equal, the bf16 epilogue
   bit-equal, one truncated (4-bit) tier bit-equal; plane_matmul at the
   digit level, the 4-bit bit-plane tier and with pair weights near +-2^31
   that are no outer product; the packed kernel also
   on the blocked 8x8 Booth cache, SBMwC in the global planar layout, and
   gated against dense on a weight whose top planes are zero; plus timings
   (CUDA events: the median of single eager calls, and the device time of
   a CUDA-graph replay of the call; for the fused and packed kernels also
   the wrapper's host time per call) beside the bound and a library
   yardstick (``torch._int_mm``, never used by the port). Then the fused and
   packed kernels beyond those shapes: corrupted words (flipped bits, sign
   bits without their magnitude bits), unsigned activations, a_bits 1/3/5,
   ragged M (1, 5, 17, 100) and N (4099), packed K = 1000 — bit-equal;
   then both given pair weights with one entry perturbed and operands
   packed without plane weights: the all-pairs path, bit-equal to the plain
   version in this process (no child process), launching plane_matmul;
3. engine at --level bitplane — continuous batching over full-width
   granite-3-8b (depth cut to 4 layers), 8-bit Booth plane cache, 4 slots,
   prompts 32/64/128/256 arriving 2 steps apart, 16 new tokens, int8 KV,
   an 8 -> 4 bit switch at decode step 8; every projection must launch the
   fused kernel (with no pair weights read back), and the greedy tokens
   must equal a run with every projection on the plain version (which must
   launch no kernel); two more
   timed runs give the spread of the host times, and one run under
   ``torch.profiler`` the device time in all and inside the engine's
   prefill and decode-step ranges;
3b. autotune — the tile autotuner on the card: for each of the three plane
   kernels at the decode gate shape (M=4, K=4096, N=12800) and at M=256,
   every candidate the tuner ranks (row tile, K split; the default first)
   must give the default's output bit for bit (the fused kernel's raw
   accumulator and its bf16 epilogue), and the default's and the winner's
   device ms are printed (the tuner's CUDA-event timing, the weight read
   cold, and graph replays), with the default's row tile in one K range;
   ``ops.bitserial_matmul`` on the card at the gate shape (fused with its
   epilogue, packed, digit) bit-equal to the ``torch`` backend,
   each launching its row's kernel; then the bitplane cell again with
   ``autotune=True`` on a plan store under a temp dir: ``bitplane-autotune``
   (cold: ``tunes == store_misses >= 1``, every stored record legal) and
   ``bitplane-autotune-warm`` (a new tuner on the same file, the registry
   cleared: no tune, no miss, ``store_hits`` = the cold tunes), both with
   ``bitplane``'s tokens, a fingerprint naming the card, and no plan
   resolved inside a CUDA-graph capture; each prints its graph replay's
   device ms beside ``bitplane``'s and the tiles chosen. The tuner is
   detached after the phase;
4. engine at --level digit — the same through the plane-pair kernel
   (digit caches are not truncatable, so no precision switch);
5. engine bitplane-nofused — the bitplane workload with the fused kernel
   off (``--no-fused``): every projection must launch the packed kernel
   and the fused kernel never, and the tokens must equal the plain path's
   and the fused engine's; one warm-up, one timed and one profiled run;
6. engine bitplane-detect — the same with ``integrity="detect"`` and an
   audit every iteration, layers unrolled so that every projection's ABFT
   check counts on its own: a clean run has no alarm and one check per
   projection call, and its tokens equal bitplane-nofused's; then one bit
   of one packed weight word is flipped on the card and a second run must
   raise at least one ABFT alarm and one audit alarm. It prints what
   detection adds to the wall time and the decode step time. Then the
   same again on the default scanned layer stack (bitplane-detect-scan),
   which folds the stack's checks into one per forward: a clean run counts
   two checks per forward (the stack and lm_head) and no alarm, and the
   flipped bit again raises both alarms;
7. attention kernel checks at granite-3-8b's heads (32 / 8, head_dim 128):
   the paged decode kernel (the split-KV body on the tensor cores) at B=4,
   pages of 16, lengths 1/16/37/272 (pool pages in a permuted order, the
   null page holding garbage) against its plain version and, bit for bit,
   against the dense kernel's decode call on the gathered pools (its twin:
   the same body); at load (B=64, lengths 512-4096 from a seed); each line
   names the body, the split length, the blocks launched and live, and the
   workspace's bytes, and the device time of its split and combine
   launches apart; the dense kernel at
   Sq=Sk=256 and 4096, causal, bf16, against its plain version (and at 256
   against attention_ref), and at B=4, Sq=Sk=512 on an int8 K/V with
   scales and lengths 512/301/64/0, causal and not (A5; A3-A5 run the
   tensor-core body); each timed beside its bound, its plain version
   and scaled_dot_product_attention on dequantized, expanded K/V (a
   yardstick the port never calls); then one counted call of the
   ops.flash_attention entry point;
8. engine bitplane-paged — int8 KV in pages of 16, prefill in chunks of 64,
   shared prefixes: 10 requests one step apart, the first 8 opening with
   one 64-token prefix, bodies of 16-192 tokens, 16 new tokens, 4 slots.
   The kernel run must launch the paged kernel layers x decode steps times
   and never take the gather path, every projection through the fused
   kernel, with at least one shared-prefix hit and a peak of resident pages
   below the dense reservation; the plain paged run's tokens must equal the
   plain dense engine's with the same prefill chunks; an attention replay (16 decode steps of four
   prefilled requests, each forward run with the kernel and with the plain
   path from clones of one cache) must keep max|dlogit| within the bound
   and the greedy token wherever the plain top-2 margin exceeds twice it;
9. engines bitplane-scrub and bitplane-scrub-retry — the packed route with
   scrub-mode integrity, layers unrolled, 8 bits throughout (no switch: a
   flip in a plane the 4-bit tier drops reaches no ABFT check). A clean run
   has no alarm, one ABFT check per projection call and the tokens of
   bitplane-nofused at 8 bits; then the reference's seven-site spec
   (planes, sign, occupancy, checksum, scale, kv, kv_scale on iterations
   2-8, seed 11) with an audit every iteration: 7/7 detected, at least one
   scrub, tokens bit-identical, every leaf of the quantized tree at its
   address. Then, audits off, ``planes@2,sign@9;seed=11`` (a prefill, then
   a decode step): at least 2 step retries and 2 scrubs, tokens
   bit-identical, no precision captured twice, and the eager step
   (``compile_steps=False``) gives the same tokens, integrity counts and
   events. Each line prints the scrubs' seconds, the retained source and
   the per-step backup bytes, and the clean runs' host ms per decode step
   and decode busy share beside bitplane-detect's;
10. engines bitplane-paged-detect and bitplane-paged-scrub — the
   bitplane-paged workload with per-page KV checksums (the packed route).
   Detect: no alarm and bitplane-paged's tokens on a clean run; one bit
   flipped on the card in a page a live slot maps must raise a KV alarm and
   move that page's fold alone. Scrub: a seeded kv / kv_scale spec plus one
   flip in a page of the shared 64-token prefix while two or more slots
   map it: every flip outside the null page detected (flips on the null
   page are listed apart), the holders requeued, a registry entry dropped,
   tokens bit-identical to the clean run.
11. engines bitplane-autopilot and bitplane-paged-autopilot — the SLA
   autopilot (queue SLA 6 steps, patience 2 down / 4 up, cooldown 2, shadow
   probes on half the decode steps) over 16 requests with prompts of
   32/64/96/128 tokens in turn, 4 arriving per decode step from step 0, 16
   new tokens, int8 KV, prefill in chunks of 64; the paged cell adds pages
   of 16 and a declared 32-token shared prefix. A step whose slots hold
   several tiers replays each tier's graph and merges in place. Gates: two
   or more tiers admitted and counted; every finished request equal to a
   static run of its admission tier; requests shed, all at the lowest tier;
   the autopilot's p99 queue wait within the SLA where the static 8-bit
   run's exceeds it; shadow probes with a finite KL; the eager control
   equal in tokens, switches and shed set. Printed: host and device ms per
   decode step for single-tier and mixed-tier steps apart, the decode busy
   share, capture seconds per graph;
12. digit-w16 — --bits 16 --level digit through the float32-accumulated
   oracle route: at each main-path shape, M = 4 and 256, the oracle within
   1e-5 of max|exact| of the float64 product; the engine's graph run equal
   to its eager control; the 16-bit prefill logits closer to the
   unquantized model's than the 8-bit digit model's. The line prints the
   TF32 setting (no matmul precision switch is set);
13. lockstep — Engine.generate on 4 prompts of 64 tokens, 16 new tokens,
   from graphs: equal to its eager control and to continuous batching with
   bf16 KV at the same batch; under detect one flipped weight bit raises
   its alarm count;
14. the SSM and hybrid families at full width, seeded random weights, the
   continuous-batching workload of phase 3 (``FAMILY_LAYERS`` sets each
   family's depth): mamba2-bitplane (8 -> 4 at step 8), mamba2-digit and
   mamba2-detect (the packed route, layers unrolled, an audit every
   iteration: no alarm clean and one check per projection; the fold
   kernel bit-equal to the plain folds on the cache with its float32 SSM
   state; one flipped state bit in a live slot moves that slot's fold
   alone and raises a KV alarm; one flipped weight bit an ABFT and an
   audit alarm);
15. rgemma-bitplane — recurrentgemma-2b (periods of rec, rec, attn and a
   tail) on the same workload;
16. rgemma-window — prompts 2040/64/128/256, 24 new tokens: the long
   request's 2048-row ring wraps at its 9th decode token; its decode
   logits (bf16 ring) are held against a cache-free forward over the same
   tokens on the plain route within ``WINDOW_DLOGIT_TOL``, and again with
   the decode's softmax weights kept in float32 (reported: the part of the
   gap the bf16 rounding of those weights makes).
   Each family cell replays its decode steps from graphs and is held
   against its eager twin (tokens, launches) and against the plain route
   on the card (``backend="torch"``: tokens equal, and max|dlogit| of
   every prefill and of the first 4 decode steps within
   ``FAMILY_DLOGIT_TOL``); it prints host and device ms per decode step,
   busy shares, tok/s, prefill s, launches per route, and the device ms per
   decode step of the families' own operators (the ``family.*`` profiler
   ranges of a short eager run).
17. the MoE, VLM and encoder architectures at full width, seeded random
   weights, the reference's serving policy (8-bit bit-plane, the front
   end and the MoE router kept dense; depths in ``ARCH_LAYERS``):
   qwen3moe-bitplane (qwen3-moe-235b-a22b, 128 experts top-8) and
   scout-bitplane (llama4-scout-17b-a16e, 16 experts top-1) on phase 3's
   workload, held as the family cells are and printing the device ms per
   decode step of the ``moe.*`` ranges (route, dispatch, the experts' fake
   quantizers, their products, the combine) and the eager twin's dropped
   expert copies at prefill and decode (at least one at decode: with 4
   slots an expert holds one decode copy); internvl2-bitplane (internvl2-2b
   on text, the same workload and gates); internvl2-patches
   (``make_prefill_step`` on 4 x (256 patches + 64 text tokens), 16 decode
   steps through ``make_serve_step``: tokens equal to the plain route's,
   max|dlogit| of the prefill and the first 4 decode steps within
   ``FAMILY_DLOGIT_TOL``); hubert-encode (``forward`` on 4 x 500 frames of
   512 features: every frame's argmax equal to the plain route's, max|dlogit|
   within ``FAMILY_DLOGIT_TOL``). Every projection launches
   fused_plane_linear (the encoder's float32 projections take its raw
   accumulator);
18. training at granite-3-8b's full width (``run_training``);
19. tensor-parallel serving at phase 3's width and depth: tp1-nccl (in
   this process, a ``TPContext`` over an NCCL group of world size 1: the
   tensor-parallel prefill and decode steps serve the workload's four
   prompts and 16 decode steps; the decode step captured in a CUDA graph
   with its collectives must replay the eager TP step's tokens, which must
   equal the single-device steps'), then bitplane-tp2 and
   bitplane-paged-tp2 (two ranks spawned over gloo, both on this card,
   eager steps: gloo's collectives cannot be captured) on phase 3's and
   phase 8's workloads: on each rank the tokens of the single-device cell,
   fused_plane_linear for every column- and vocab-parallel projection,
   plane_matmul_packed for every row-parallel one, the paged kernel layers
   x decode steps times, no plain route; each rank's plane bytes at most
   0.55 of one device's. Every model of the spawn is loaded layer by
   layer (``SeededParams(0)``: a rank draws one part at a time on the card
   and keeps its shard of it): a "tp load" line gives each rank's card
   peak part by part and resident after, beside one device's load. In the
   same spawn: bitplane-scrub-tp2 (bitplane-scrub's engine, one seeded
   plane flip on rank 1 alone: found on both ranks, one scrub each, the
   fingerprint restored, tokens of bitplane-scrub), bitplane-autopilot-tp2
   (the autopilot cell's ramp: each request's tokens, the switches, the
   tiers and the shed set of the single-device cell, whose requests equal
   static runs of their tiers), bitplane-autotune-tp2 and -warm-tp2 (a
   fresh plan store then warm from it: rank 0 alone tunes and keeps the one
   store, every rank the same tiles, warm no tune; bitplane's tokens), and
   mamba2-tp2 (2 layers), qwen3moe-tp2 (1 layer, router dense) and
   internvl2-patches-tp2 (2 layers, the image prefix through the TP
   prefill and decode steps), each against a single-device eager twin at
   its depth run in this call; rows 1 and 2 on every rank of every cell,
   no plain route. Before the cells, the plain attention paths over one
   rank's heads at P = 2 and 4 must give the whole heads' bits;
20. training on a (data x model) mesh (``run_mesh_training``): two gloo
   ranks sharing the card (``spawn_ranks``, eager) train through
   ``TrainRun`` on their mesh, each holding its blocks of the parameters
   and optimizer state: train-fsdp2 (granite-3-8b at full width, 1 layer,
   AdamW, mesh (2,1)), train-tp2 (the same at (1,2)) and train-ep2
   (qwen3-moe-235b-a22b at full width, 1 layer, Adafactor, capacity factor
   2.0, (1,2)), batch 8 x 256, 3 steps (the third traced); the same
   TrainRun on one device is the control: the first step's loss and grad
   norm within MESH_FIRST_RTOL / MESH_GNORM_RTOL, every loss within the
   reference's 2e-2; train-ep2's first MoE call keeps one device's copies.
   Each cell prints the step ms, each rank's card peak and resident memory
   beside one device's, the collectives' ms of the traced step and the
   losses.
21. the analysis layer (``run_analysis``): the paper's §IV-A protocol for
   the cycle-accurate systolic simulator (``core/systolic.py``) on the
   card — every pair of 8-bit values, both variants; 1000 random 16-bit
   dot products of 1000 values; ``serial_sa_matmul`` on a 64 x 16 array —
   each result equal to the exact product (modulo 2^32, the int32
   accumulator) and to the same call on the CPU, the cycles Eq. 8's; then
   ``launch/cost.py``'s report of two steps run on meta tensors (a
   prediction for the H100 row): phase 3's ``bitplane`` decode step, whose
   bound over the device ms a decode step phase 3 measured must be <= 1,
   and phase 18's ``train-dense`` step, whose predicted peak must lie
   within ``ANALYSIS_PEAK_RTOL`` of the measured ``max_memory_allocated``,
   its resident within ``ANALYSIS_RESIDENT_RTOL`` of TrainRun's, and its
   bound no greater than the measured median step.
22. the paper's four example scenarios (``run_examples``): each function
   of ``repro_torch.examples`` as its script calls it, on phase 3's
   granite-3-8b (full width, ``LAYERS`` deep), and again on the plain route
   (``backend="torch"``, which must launch no kernel): quickstart (§4's
   logits bit-equal, row 3 alone launched), serve_quantized at its defaults
   (batch 4, prompt 32, 24 new tokens; five lockstep engines: every
   engine's tokens equal to its plain twin's, ``sbmwc == booth`` and
   ``digit == bitplane``, the dial's plans truncating the stored planes,
   row 1 on the bit-plane engines and row 3 on the digit one),
   precision_sweep unrolled (16 to 1 bits, the mixed policy and the dial:
   every policy's logits bit-equal to the plain route's, each on its route
   and kernel), and the trainer runs, each the script's command line in a
   process of its own started before phase 19 and run beside phases 19-21
   (``start_example_trainers``): train_tiny_lm --model-100m (300 steps,
   checkpoints) and tiny_7m --qat-bits 8 (100 steps), which must exit 0
   (the script asserts the loss falls) having launched no kernel; steps/s
   and the card's peak memory are printed.

Every engine cell's main run replays each decode step from the engine's
CUDA graph of that precision (captured by the warm-up run; the counted
run must capture nothing), and each cell also serves its workload with the
eager step (``compile_steps=False``): tokens, launches and, in detect mode,
every integrity count (clean and after the flipped bit) must equal the
graph run's. Each cell prints each precision's capture seconds on a line
of its own, its host and device ms per decode step and its busy shares,
and a replay of its storage-width graph profiled with CPU and CUDA
activities: the main kernels counted by name must equal the launches the
engine tallies per replay (the session's second replay is counted; its
first, which can lose its first device records, is reported beside it). In the detect cell the fold kernel
(``csrc/fold.cu``) is held bit-equal to the plain folds on the whole 3.40
GB quantized tree and on the KV cache, must move with one flipped bit, and
is timed beside its byte bound.

Prints one JSON line per kernel check and per engine cell (the scrub and
paged-integrity cells' lines carry the card's name and power limit), one
``{"kernels": [...]}`` summary line (the fold kernel's entry included; the
fused kernel's entry also counts its launches on the QAT-trained weights,
``train_launches``, and in each phase-17 cell, ``arch_launches``; every
kernel its launches in each section of phase 22, ``examples_launches``; rows 1-3
also their default and tuned device ms, ``autotune``; rows 1, 2 and 5 their
launches on each rank of the phase-19 cells, ``tp_launches``), the card's
name and power limit, and last
``{"ok": true, ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 and bf16 tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1.979e15
PEAK_BF16_OPS_PER_S = 0.989e15

GRANITE_SHAPES = (  # (name, K, N, activation) of the main path's projections
    ("gate", 4096, 12800, "silu"),
    ("down", 12800, 4096, "none"),
    ("lm_head", 4096, 49408, "none"),
)
ROWS = (4, 256)  # decode M = n_slots, prefill M = longest prompt

# kernel cases beyond the main path's shapes, each bit-equal to its plain
# version: fused (variant, a_bits, M, corrupt words) at K = 4096 and a
# ragged N; packed (variant, bits, M, pack block, corrupt words) at K = 1000
CASE_N = 4099  # a multiple of no tile (4-column vectors, 32-column warps, 128-column blocks)
FUSED_CASES = (
    ("booth", 8, 4, True),
    ("unsigned", 8, 5, False),
    ("booth", 1, 1, False),
    ("booth", 3, 17, True),
    ("sbmwc", 5, 100, True),
)
FUSED_CASE_K = 4096
PACKED_CASES = (
    ("booth", 8, 5, 512, True),
    ("unsigned", 8, 17, None, False),
    ("sbmwc", 8, 100, None, True),
    ("booth", 8, 1, None, False),
)
PACKED_CASE_K = 1000
# each library's main loop runs on the tensor cores: the SASS instruction
# that must show it (IMMA: int8 mma.sync, HMMA: bf16 mma.sync)
TENSOR_CORE_LIBS = {"plane_mm_fused": "IMMA", "plane_mm_packed": "IMMA", "plane_mm": "IMMA",
                    "flash_attn": "HMMA"}
# the kernel functions of a library that must each show that instruction
# (every template instance of the name counted together)
TENSOR_CORE_FUNCTIONS = {"flash_attn": ("attn_mma::dense_mma_kernel",
                                        "attn_decode::decode_split_paged_kernel",
                                        "attn_decode::decode_split_dense_kernel")}
# device events of the attention kernels in a profile (substrings of their names)
ATTENTION_KERNEL_TAGS = ("paged_kernel", "dense_kernel", "decode_split", "decode_combine")

# the engine workload: full-width granite-3-8b, depth cut to LAYERS
LAYERS = 4
N_SLOTS = 4
PROMPT_LENS = (32, 64, 128, 256)
STAGGER = 2  # decode steps between arrivals
GEN_TOKENS = 16


def _die(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of per-launch CUDA-event times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around replays of a CUDA graph
    of it (its launches back to back, none of the wrapper's host time,
    which ``_time_ms`` includes when the card waits for the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_device_ms(fn, reps: int = 5) -> dict:
    """Device time per call of each kernel that ``fn`` launches (summed by
    kernel name over ``reps`` calls under ``torch.profiler``, divided by
    ``reps``)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^void |[(<].*$", "", evt.name)
            per[name] = per.get(name, 0.0) + (evt.time_range.end - evt.time_range.start) / 1e3
    return {name: ms / reps for name, ms in sorted(per.items())}


def _host_ms(fn, reps: int = 50) -> float:
    """Host time of one call: the host clock over back-to-back calls,
    before the synchronise (what the wrapper costs the host per call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def _bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_INT8_OPS_PER_S) -> tuple[float, str]:
    """A call's bound on the H100 row (``launch/roofline.bound_ms``)."""
    from repro_torch.launch import roofline

    return roofline.bound_ms(n_bytes, n_ops, peak_ops)


def _library_ms(x_q: torch.Tensor, w_q: torch.Tensor):
    """``torch._int_mm`` of the same int8 product (rows padded to 32, the
    smallest M it takes) — a yardstick: (call ms, device ms, None), or
    (None, None, reason) if refused."""
    m = x_q.shape[0]
    xp = torch.zeros((max(m, 32), x_q.shape[1]), dtype=torch.int8, device=x_q.device)
    xp[:m] = x_q
    for w in (w_q, w_q.t().contiguous().t()):
        try:
            torch._int_mm(xp, w)
        except RuntimeError as e:  # layout the library does not take
            reason = str(e).splitlines()[0]
            continue
        return (_time_ms(lambda w=w: torch._int_mm(xp, w)),
                _graph_ms(lambda w=w: torch._int_mm(xp, w)), None)
    return None, None, reason


def check_packed(summary: dict, name, m, k, n, x_q, w_q, wp, wp4, x4, lib_ms) -> list:
    """The packed kernel against its plain version: the blocked 8x8 Booth
    cache (cached_packed), the 4-bit truncated tier, SBMwC in the global
    planar layout (staged_packed), and gate=True against gate=False on a
    weight whose top Booth planes are zero — all bit-equal (int32)."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import plane_mm_packed as pmp
    from repro_torch.kernels.bytesplit import CHUNK_WORDS
    from repro_torch.launch import roofline

    dev = x_q.device

    def pack_a(x, bits, variant, block):
        dec = bp.to_bitplanes(x, bits, variant)
        return bp.pack_decomposition(dec, axis=-1, variant=variant, block=block), dec

    def pair_w(dec_a, pw_side):  # as the plan executors build them: no read-back
        return ops._pair_weights(dec_a.weights, pw_side.weights, dev)

    sb = bp.make_weight_planes(w_q, w_bits=8, variant="sbmwc", level="bitplane", block=None)
    small = bp.make_weight_planes(w_q >> 3, w_bits=8, variant="booth", level="bitplane")
    w4 = bp.shift_requantize(w_q, 8, 4, "booth")  # the values the 4-bit tier's planes hold
    cases = []  # (name, A, W, pair weights, gate, A bits, W bits)
    pa8, da8 = pack_a(x_q, 8, "booth", wp.packed.block)
    cases.append(("booth8_blocked", pa8, wp.packed, pair_w(da8, wp.packed), False, 8, 8))
    pa4, da4 = pack_a(x4, 4, "booth", wp4.packed.block)
    cases.append(("booth4_truncated", pa4, wp4.packed, pair_w(da4, wp4.packed), False, 4, 4))
    pas, das = pack_a(x_q, 8, "sbmwc", None)
    cases.append(("sbmwc8_planar", pas, sb.packed, pair_w(das, sb.packed), False, 8, 8))
    cases.append(("booth8_gated", pa8, small.packed, pair_w(da8, small.packed), True, 8, 8))
    lines = []
    for variant, pa, pw, pairs, gate, a_bits, w_bits in cases:
        got = pmp.plane_matmul_packed(pa, pw, pairs, gate=gate)
        plain = pmp.plane_matmul_packed_plain(pa, pw, pairs)
        dense = pmp.plane_matmul_packed(pa, pw, pairs) if gate else got
        torch.cuda.synchronize()
        eq = bool(torch.equal(got, plain)) and bool(torch.equal(dense, got))
        err = float((got.double() - plain.double()).abs().max())
        k_ms = _time_ms(lambda: pmp.plane_matmul_packed(pa, pw, pairs, gate=gate))
        d_ms = _graph_ms(lambda: pmp.plane_matmul_packed(pa, pw, pairs, gate=gate))
        h_ms = _host_ms(lambda: pmp.plane_matmul_packed(pa, pw, pairs, gate=gate))
        p_ms = _time_ms(lambda: pmp.plane_matmul_packed_plain(pa, pw, pairs), reps=3, warmup=1)
        tiles = bp.occupancy_per_tile(pw.occupancy, CHUNK_WORDS) if gate else None
        products = roofline.split_products(a_bits, w_bits)
        b_ms, b_by = roofline.packed_call_bound(m, n, pa, pw, products, tiles)
        line = {
            "kernel": "plane_matmul_packed", "shape": name, "M": m, "K": k, "N": n,
            "variant": variant, "gate": gate, "planes": [pa.n_planes, pw.n_planes],
            "raw_int32_equal": eq, "max_abs_err": err,
            "kernel_ms": k_ms, "device_ms": d_ms, "host_ms": h_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_products": products,
        }
        if gate:
            line["dense_ms"] = _time_ms(lambda: pmp.plane_matmul_packed(pa, pw, pairs))
            line["occupied_tiles"] = [int(tiles.sum()), int(tiles.numel())]
        print(json.dumps(line), flush=True)
        lines.append(line)
        if not eq:
            _die(f"plane_matmul_packed {variant} differs from its plain version at {name} M={m}")
        summary.setdefault("plane_matmul_packed", []).append(line)
        del got, plain, dense
    return lines


def _corrupt(packed, gen: torch.Generator, n_words: int = 8):
    """The words as faults leave them: ``n_words`` magnitude bits flipped
    and, on ternary words, ``n_words`` sign bits set whose magnitude bits
    are clear (plane value -2, which no valid pack holds)."""
    def pick(hi):
        return int(torch.randint(hi, (1,), generator=gen, device=gen.device))

    mag = packed.mag.clone().reshape(-1)
    sign = None if packed.sign is None else packed.sign.clone().reshape(-1)
    for _ in range(n_words):
        mag[pick(mag.numel())] ^= 1 << pick(31)
        if sign is not None:
            j, bit = pick(mag.numel()), 1 << pick(31)
            mag[j] &= ~bit
            sign[j] |= bit
    return dataclasses.replace(
        packed, mag=mag.reshape(packed.mag.shape),
        sign=None if sign is None else sign.reshape(packed.sign.shape))


def check_kernel_cases(summary: dict) -> list:
    """The redesigned kernels against their plain versions beyond the main
    path's shapes: corrupted words, unsigned activations, a_bits 1/3/5,
    ragged M and N, packed K = 1000 — all bit-equal (raw int32; the fused
    kernel's bf16 epilogue too)."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import plane_mm_fused as pmf
    from repro_torch.kernels import plane_mm_packed as pmp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)

    def ints(bits, variant, shape):
        lo, hi = (0, (1 << bits) - 1) if variant == "unsigned" else bp.signed_range(bits)
        return torch.randint(lo, hi + 1, shape, generator=gen, device=dev, dtype=torch.int32)

    def report(kernel, case, eq, err, d_ms, **extra):
        line = {"kernel": kernel, "case": case, **extra, "raw_int32_equal": eq,
                "max_abs_err": err, "device_ms": d_ms}
        print(json.dumps(line), flush=True)
        if not eq:
            _die(f"{kernel} case {case} differs from its plain version")
        summary.setdefault(kernel, []).append(line)
        return line

    lines = []
    for variant, a_bits, m, corrupt in FUSED_CASES:
        k, n = FUSED_CASE_K, CASE_N
        x = ints(a_bits, variant, (m, k)).to(torch.int8)  # an unsigned byte as its int8 bits
        wp = bp.make_weight_planes(ints(8, variant, (k, n)), w_bits=8, variant=variant,
                                   level="bitplane")
        pk = _corrupt(wp.packed, gen) if corrupt else wp.packed
        pw = ops._pair_weights(bp.plane_weights(a_bits, variant), pk.weights, dev)
        kw = dict(a_bits=a_bits, variant=variant)
        ep = dict(a_scale=torch.rand((m, 1), generator=gen, device=dev) * 1e-2,
                  w_scale=torch.rand((1, n), generator=gen, device=dev) * 1e-3,
                  activation="silu")
        raw_k, raw_p = pmf.fused_plane_linear(x, pk, pw, **kw), pmf.fused_plane_linear_plain(x, pk, pw, **kw)
        out_k = pmf.fused_plane_linear(x, pk, pw, **kw, **ep)
        out_p = pmf.fused_plane_linear_plain(x, pk, pw, **kw, **ep)
        torch.cuda.synchronize()
        eq = bool(torch.equal(raw_k, raw_p)) and bool(torch.equal(out_k, out_p))
        err = float((raw_k.double() - raw_p.double()).abs().max())
        d_ms = _graph_ms(lambda: pmf.fused_plane_linear(x, pk, pw, **kw, **ep))
        lines.append(report("fused_plane_linear", f"{variant}{a_bits}" + ("_corrupt" if corrupt else ""),
                            eq, err, d_ms, variant=variant, a_bits=a_bits, M=m, K=k, N=n,
                            corrupt=corrupt))
    for variant, bits, m, block, corrupt in PACKED_CASES:
        k, n = PACKED_CASE_K, CASE_N
        pa = bp.pack_decomposition(bp.to_bitplanes(ints(bits, variant, (m, k)), bits, variant),
                                   axis=-1, variant=variant, block=block)
        pk = bp.pack_decomposition(bp.to_bitplanes(ints(bits, variant, (k, n)), bits, variant),
                                   axis=-2, variant=variant, block=block)
        if corrupt:
            pa, pk = _corrupt(pa, gen), _corrupt(pk, gen)
        pw = ops._pair_weights(pa.weights, pk.weights, dev)
        got, plain = pmp.plane_matmul_packed(pa, pk, pw), pmp.plane_matmul_packed_plain(pa, pk, pw)
        torch.cuda.synchronize()
        eq = bool(torch.equal(got, plain))
        err = float((got.double() - plain.double()).abs().max())
        d_ms = _graph_ms(lambda: pmp.plane_matmul_packed(pa, pk, pw))
        layout = "blocked" if block else "planar"
        lines.append(report("plane_matmul_packed",
                            f"{variant}{bits}_{layout}" + ("_corrupt" if corrupt else ""),
                            eq, err, d_ms, variant=variant, bits=bits, M=m, K=k, N=n,
                            corrupt=corrupt))
    return lines


def _kernel_name(mangled: str) -> str:
    """A kernel function's nested names and first integer template
    argument from its mangled name, e.g.
    ``attn_decode::decode_split_paged_kernel<128>``."""
    i = 3 if mangled.startswith("_ZN") else 2
    parts = []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        parts.append(mangled[j:j + n])
        i = j + n
    if not parts:
        return mangled
    arg = re.match(r"ILi(\d+)E", mangled[i:])
    return "::".join(parts) + (f"<{arg.group(1)}>" if arg else "")


def check_sass() -> dict:
    """Tensor-core instructions in each kernel library's SASS (``cuobjdump
    -sass``): IMMA (int8 mma.sync), IGMMA (int8 wgmma) and HMMA (bf16
    mma.sync), in all and per kernel function. Each library must hold its
    TENSOR_CORE_LIBS instruction, and each TENSOR_CORE_FUNCTIONS function
    that instruction."""
    from repro_torch.kernels import _build

    tool = _build.cuda_tool("cuobjdump")
    ops = ("IMMA", "IGMMA", "HMMA")
    counts, by_function = {}, {}
    for name in _build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))], capture_output=True,
                              text=True, check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
        funcs: dict = {}
        for body in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
            fn = _kernel_name(body.split(None, 1)[0])
            got = funcs.setdefault(fn, dict.fromkeys(ops, 0))
            for op in ops:
                got[op] += len(re.findall(rf"\b{op}\b", body))
        by_function[name] = {fn: c for fn, c in sorted(funcs.items()) if any(c.values())}
        for fn in TENSOR_CORE_FUNCTIONS.get(name, ()):
            if fn not in {f.split("<")[0] for f in funcs}:
                _die(f"lib{name}: no kernel function {fn} in its SASS: {sorted(funcs)}")
    print(json.dumps({"sass_tensor_core_instructions": counts,
                      "sass_by_function": by_function}), flush=True)
    for name, op in TENSOR_CORE_LIBS.items():
        if not counts[name][op]:
            _die(f"lib{name}: no {op} instruction in its SASS")
        for fn in TENSOR_CORE_FUNCTIONS.get(name, ()):
            if not sum(c[op] for f, c in by_function[name].items() if f.split("<")[0] == fn):
                _die(f"lib{name}: no {op} instruction in {fn}")
    return counts


def check_plane_matmul(summary: dict, gen, name, m, k, n, x_q, w_q, w_dig, x4, wp4, pw4,
                       lib) -> list:
    """plane_matmul against its plain version at one main-path shape, three
    ways, each bit-equal (raw int32) and timed: the Booth radix-256 digits
    (the digit cell's call; also equal to the plain int8 product), the
    4-bit bit-plane tier (4 x 4 pairs), and the digits with pair weights
    that are no outer product, near +-2^31 (every product wraps)."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.kernels import ops, plane_mm

    dev = x_q.device
    a_dig = bp.to_digits(x_q, 8, "booth")
    a_pl, w_pl = a_dig.planes.to(torch.int8).contiguous(), w_dig.planes.to(torch.int8).contiguous()
    pwd = ops._pair_weights(a_dig.weights, w_dig.weights, dev)
    off = torch.randint(0, 64, pwd.shape, generator=gen, device=dev, dtype=torch.int64)
    sign = torch.randint(0, 2, pwd.shape, generator=gen, device=dev, dtype=torch.int64)
    pw_wrap = torch.where(sign == 1, 2**31 - 1 - off, -(2**31) + off).to(torch.int32)
    a_b4 = bp.to_bitplanes(x4, 4, "booth").planes.to(torch.int8).contiguous()
    w_b4 = bp.unpack_planes(wp4.packed).contiguous()
    cases = (("digit", a_pl, w_pl, pwd), ("bitplane4", a_b4, w_b4, pw4),
             ("digit_pw_near_2_31", a_pl, w_pl, pw_wrap))
    lines = []
    for variant, ap, wpl, pw in cases:
        got = plane_mm.plane_matmul(ap, wpl, pw)
        plain = plane_mm.plane_matmul_plain(ap, wpl, pw)
        torch.cuda.synchronize()
        eq = bool(torch.equal(got, plain))
        if variant == "digit":  # the digit contraction is the plain int8 product
            eq = eq and bool(torch.equal(plain.double(), x_q.double() @ w_q.double()))
        err = float((got.double() - plain.double()).abs().max())
        p_a, p_w = ap.shape[0], wpl.shape[0]
        n_bytes = p_a * m * k + p_w * k * n + 4 * p_a * p_w + 4 * m * n
        # folding the side with fewer planes leaves min(P_a, P_w) products
        b_ms, b_by = _bound(n_bytes, 2.0 * m * n * k * min(p_a, p_w))
        line = {
            "kernel": "plane_matmul", "shape": name, "variant": variant, "M": m, "K": k, "N": n,
            "planes": [p_a, p_w], "raw_int32_equal": eq, "max_abs_err": err,
            "kernel_ms": _time_ms(lambda: plane_mm.plane_matmul(ap, wpl, pw)),
            "device_ms": _graph_ms(lambda: plane_mm.plane_matmul(ap, wpl, pw)),
            "host_ms": _host_ms(lambda: plane_mm.plane_matmul(ap, wpl, pw)),
            "plain_ms": _time_ms(lambda: plane_mm.plane_matmul_plain(ap, wpl, pw), reps=3,
                                 warmup=1),
            "library_ms": lib[0], "library_device_ms": lib[1],
            "bound_ms": b_ms, "bound_by": b_by, "bound_products": min(p_a, p_w),
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
        if not eq:
            _die(f"plane_matmul {variant} differs from its plain version at {name} M={m}")
        summary.setdefault("plane_matmul", []).append(line)
        del got, plain
    return lines


def check_any_pair_weights(summary: dict) -> list:
    """Fault A: the fused and the packed kernel given pair weights that are
    no outer product of the operands' plane weights (one entry perturbed),
    and operands packed without plane weights. Each call takes the
    all-pairs path (decided on the host, before any launch), must equal its
    plain version (raw int32 and bf16), must launch plane_matmul and not
    the byte-split kernel, and the process carries on."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import plane_mm_fused as pmf
    from repro_torch.kernels import plane_mm_packed as pmp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    m, k, n = 5, FUSED_CASE_K, CASE_N
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int32)
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev, dtype=torch.int32)
    pa = bp.pack_decomposition(bp.to_bitplanes(x, 8, "booth"), axis=-1, variant="booth", block=512)
    pk = bp.pack_decomposition(bp.to_bitplanes(w, 8, "booth"), axis=-2, variant="booth", block=512)
    bare_a, bare_w = dataclasses.replace(pa, weights=()), dataclasses.replace(pk, weights=())
    pw_packed = ops._pair_weights(pa.weights, pk.weights, dev)
    pw_fused = ops._pair_weights(bp.plane_weights(8, "booth"), pk.weights, dev)
    ep = dict(a_scale=torch.rand((m, 1), generator=gen, device=dev) * 1e-2,
              w_scale=torch.rand((1, n), generator=gen, device=dev) * 1e-3, activation="silu")
    xq = x.to(torch.int8)

    def perturbed(pw):
        bad = pw.clone()
        bad[int(torch.randint(pw.numel(), (1,), generator=gen, device=dev))] += 12345
        return bad

    lines = []
    for kernel in ("fused_plane_linear", "plane_matmul_packed"):
        for case in ("perturbed_pw", "no_weights"):
            ak, wk = (bare_a, bare_w) if case == "no_weights" else (pa, pk)
            if kernel == "fused_plane_linear":
                pw = perturbed(pw_fused) if case == "perturbed_pw" else pw_fused
                kw = dict(a_bits=8, variant="booth")
                calls = [(functools.partial(pmf.fused_plane_linear, xq, wk, pw, **kw, **e),
                          functools.partial(pmf.fused_plane_linear_plain, xq, wk, pw, **kw, **e))
                         for e in ({}, ep)]
            else:
                pw = perturbed(pw_packed) if case == "perturbed_pw" else pw_packed
                calls = [(functools.partial(pmp.plane_matmul_packed, ak, wk, pw),
                          functools.partial(pmp.plane_matmul_packed_plain, ak, wk, pw))]
            lines.append(_all_pairs_line(summary, kernel, case, calls, (m, k, n)))
    return lines


def _all_pairs_line(summary: dict, kernel: str, case: str, calls, mkn) -> dict:
    """Run ``calls`` (kernel, plain) pairs of one all-pairs case: bit-equal,
    launching plane_matmul once per call and not the byte-split kernel."""
    m, k, n = mkn
    _reset_counts()
    got = [kern() for kern, _ in calls]
    torch.cuda.synchronize()
    counts = _read_counts()
    want = [plain() for _, plain in calls]
    eq = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    line = {"kernel": kernel, "case": f"all_pairs_{case}", "M": m, "K": k, "N": n,
            "raw_int32_equal": eq, "outputs": [str(t.dtype) for t in got],
            "max_abs_err": err, "launches": counts,
            # events around one eager call: a foreign pw is read back on every
            # call, which a CUDA graph cannot capture
            "ms": _time_ms(calls[-1][0])}
    print(json.dumps(line), flush=True)
    if not eq:
        _die(f"{kernel} {case} differs from its plain version")
    if counts["plane_matmul"] != len(calls) or counts["plane_matmul_packed"]:
        _die(f"{kernel} {case} did not take the all-pairs path: {counts}")
    summary.setdefault(kernel, []).append(line)
    return line


def check_kernels(summary: dict) -> list:
    from repro_torch.core import bitplanes as bp
    from repro_torch.kernels import ops
    from repro_torch.kernels import plane_mm_fused
    from repro_torch.launch import roofline

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    lines = []
    for name, k, n, act in GRANITE_SHAPES:
        w_q = torch.randint(-128, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        wp = bp.make_weight_planes(w_q, w_bits=8, variant="booth", level="bitplane")
        wp4 = bp.truncate_weight_planes(wp, 4)
        w_dig = bp.to_digits(w_q, 8, "booth")
        w_scale = torch.rand((1, n), generator=gen, device=dev) * 1e-3 + 1e-4
        bias = (
            torch.randn((n,), generator=gen, device=dev) * 0.1 if name == "down" else None
        )
        for m in ROWS:
            x_q = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            a_scale = torch.rand((m, 1), generator=gen, device=dev) * 1e-2 + 1e-3
            # ---- fused_plane_linear ------------------------------------------------
            # the pair weights as the plan executors build them (no read-back)
            pw8 = ops._pair_weights(bp.plane_weights(8, "booth"), wp.weights, dev)
            pw4 = ops._pair_weights(bp.plane_weights(4, "booth"), wp4.weights, dev)
            x4 = torch.clamp_max(bp.shift_requantize(x_q, 8, 4, "booth"), 7).to(torch.int8)
            kw = dict(a_bits=8, variant="booth")
            raw_k = plane_mm_fused.fused_plane_linear(x_q, wp.packed, pw8, **kw)
            raw_p = plane_mm_fused.fused_plane_linear_plain(x_q, wp.packed, pw8, **kw)
            ep = dict(a_scale=a_scale, w_scale=w_scale, bias=bias, activation=act)
            out_k = plane_mm_fused.fused_plane_linear(x_q, wp.packed, pw8, **kw, **ep)
            out_p = plane_mm_fused.fused_plane_linear_plain(x_q, wp.packed, pw8, **kw, **ep)
            tr_k = plane_mm_fused.fused_plane_linear(x4, wp4.packed, pw4, a_bits=4, variant="booth", **ep)
            tr_p = plane_mm_fused.fused_plane_linear_plain(x4, wp4.packed, pw4, a_bits=4, variant="booth", **ep)
            torch.cuda.synchronize()
            raw_eq = bool(torch.equal(raw_k, raw_p))
            ep_err = float((out_k.float() - out_p.float()).abs().max())
            tr_err = float((tr_k.float() - tr_p.float()).abs().max())
            ep_eq = bool(torch.equal(out_k, out_p)) and bool(torch.equal(tr_k, tr_p))
            k_ms = _time_ms(lambda: plane_mm_fused.fused_plane_linear(x_q, wp.packed, pw8, **kw, **ep))
            d_ms = _graph_ms(lambda: plane_mm_fused.fused_plane_linear(x_q, wp.packed, pw8, **kw, **ep))
            h_ms = _host_ms(lambda: plane_mm_fused.fused_plane_linear(x_q, wp.packed, pw8, **kw, **ep))
            p_ms = _time_ms(lambda: plane_mm_fused.fused_plane_linear_plain(x_q, wp.packed, pw8, **kw, **ep), reps=3, warmup=1)
            lib_ms, lib_dev_ms, lib_why = _library_ms(x_q, w_q)
            n_w, kwords, _ = wp.packed.mag.shape
            n_bytes = (m * k + 2 * n_w * kwords * n * 4 + 4 * pw8.numel()
                       + 4 * m + 4 * n + m * n * 2)
            if bias is not None:
                n_bytes += 4 * n
            products = roofline.split_products(8, 8)
            b_ms, b_by = _bound(n_bytes, 2.0 * m * n * k * products)
            line = {
                "kernel": "fused_plane_linear", "shape": name, "M": m, "K": k, "N": n,
                "activation": act, "bias": bias is not None,
                "raw_int32_equal": raw_eq, "bf16_epilogue_equal": ep_eq,
                "epilogue_max_abs_err": ep_err, "trunc4_max_abs_err": tr_err,
                "kernel_ms": k_ms, "device_ms": d_ms, "host_ms": h_ms, "plain_ms": p_ms,
                "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_products": products,
            }
            if lib_why:
                line["library_note"] = lib_why
            print(json.dumps(line), flush=True)
            lines.append(line)
            if not raw_eq:
                _die(f"fused_plane_linear raw int32 differs from its plain version at {name} M={m}")
            if not ep_eq:
                _die(
                    f"fused_plane_linear bf16 epilogue differs from its plain version at "
                    f"{name} M={m} (max abs err {max(ep_err, tr_err)})"
                )
            summary.setdefault("fused_plane_linear", []).append(line)
            del raw_k, raw_p, out_k, out_p, tr_k, tr_p
            lines += check_plane_matmul(summary, gen, name, m, k, n, x_q, w_q, w_dig, x4, wp4,
                                        pw4, (lib_ms, lib_dev_ms))
            lines += check_packed(summary, name, m, k, n, x_q, w_q, wp, wp4, x4, lib_ms)
        del wp, wp4, w_dig, w_q
        torch.cuda.empty_cache()
    return lines


# granite-3-8b's attention at full width
HQ, HKV, HEAD_DIM = 32, 8, 128
PAGE = 16
# tolerances of the attention kernels against their plain versions (PERF.md,
# written before the first chip run): float32 outputs within ATTN_RTOL of
# max|plain| (the two sum q.k over d and p.v over positions in other
# orders); bf16 outputs within one bf16 step of the element on top of it
ATTN_RTOL = 1e-4
# A5: the dense kernel's int8 path at prefill, per-lane lengths (one free lane)
DENSE_INT8_S = 512
DENSE_INT8_LENS = [512, 301, 64, 0]


def _attn_err(got: torch.Tensor, plain: torch.Tensor) -> tuple[float, bool]:
    """(max |got - plain|, within the tolerance for got's dtype)."""
    diff = (got.float() - plain.float()).abs()
    atol = ATTN_RTOL * float(plain.float().abs().max())
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(got.float().abs(), plain.float().abs()).clamp_min(1e-30)
        ok = bool((diff <= atol + torch.exp2(torch.floor(torch.log2(mag)) - 7)).all())
    else:
        ok = bool((diff <= atol).all())
    return float(diff.max()), ok


def _paged_inputs(gen, lens, extra_pages: int = 8):
    """Pools holding every lane's pages in a random permuted order, tables
    padded with the null page 0, which holds non-zero garbage."""
    dev = torch.device("cuda")
    b = len(lens)
    per = [-(-n // PAGE) for n in lens]
    p = max(per)
    n_pages = sum(per) + 1 + extra_pages
    kq = torch.randint(-127, 128, (n_pages, PAGE, HKV, HEAD_DIM), generator=gen, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, kq.shape, generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand(kq.shape[:-1], generator=gen, device=dev) * 0.02 + 1e-3
    vs = torch.rand(kq.shape[:-1], generator=gen, device=dev) * 0.02 + 1e-3
    perm = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).tolist()
    tables = torch.zeros((b, p), dtype=torch.int32)
    at = 0
    for i, n in enumerate(per):
        tables[i, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    q = torch.randn((b, HQ, 1, HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kq, vq, ks, vs, tables.to(dev), kv_lens


def _gather_dense(pool, tables):
    """(n_pages, PAGE, H[, D]) pools through (B, P) tables -> (B, H, P*PAGE[, D])."""
    b, p = tables.shape
    x = pool[tables.long().reshape(-1)].reshape(b, p * PAGE, *pool.shape[2:])
    return (x.permute(0, 2, 1) if x.ndim == 3 else x.permute(0, 2, 1, 3)).contiguous()


def _sdpa_ms(q, k, v, **kw):
    """The library yardstick: one scaled_dot_product_attention call on K/V
    already dequantized to bf16 and expanded to the query heads."""
    import torch.nn.functional as F

    return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw))


def check_paged(name: str, gen, lens) -> dict:
    """The paged kernel against its plain version (float32 and bf16
    outputs), timed beside its byte bound and the library call; on the
    first check also against the dense kernel on the gathered pools, bit
    for bit."""
    from repro_torch.kernels import flash_attention as fa

    args = _paged_inputs(gen, lens)
    q, kq, vq, ks, vs, tables, kv_lens = args
    errs, oks = [], []
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fa.paged_flash_attention(*args, out_dtype=out_dtype)
        plain = fa.paged_flash_attention_plain(*args, out_dtype=out_dtype)
        torch.cuda.synchronize()
        err, ok = _attn_err(got, plain)
        errs.append(err)
        oks.append(ok)
    rows = HQ // HKV
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, kq, vq))
    shape = fa.decode_launch(len(lens), HKV, rows, HEAD_DIM, tables.shape[1] * PAGE)
    live = sum(-(-min(n, tables.shape[1] * PAGE) // shape["split_keys"]) for n in lens) * HKV
    line = {"kernel": "paged_flash_attention", "check": name, "B": len(lens),
            "lens": lens if len(lens) <= 8 else [min(lens), max(lens)],
            "page_size": PAGE, "heads": [HQ, HKV], "head_dim": HEAD_DIM,
            "body": fa.paged_body(q.dtype, HEAD_DIM, rows, aligned),
            "split_keys": shape["split_keys"], "grid_blocks": shape["grid_blocks"],
            "live_blocks": live, "combine_blocks": shape["combine_blocks"],
            "workspace_bytes": shape["workspace_bytes"],
            "f32_max_abs_err": errs[0], "bf16_max_abs_err": errs[1],
            "within_tolerance": all(oks), "max_abs_err": errs[0]}
    kd, vd = _gather_dense(kq, tables), _gather_dense(vq, tables)
    ksd, vsd = _gather_dense(ks, tables), _gather_dense(vs, tables)
    if len(lens) <= 8:
        line["dense_twin_body"] = fa.dense_body(q.dtype, kd.dtype, 1, HEAD_DIM, aligned,
                                                causal=False, lens=True, rows=rows)
        equal = []
        for out_dtype in (torch.float32, torch.bfloat16):
            paged = fa.paged_flash_attention(*args, out_dtype=out_dtype)
            dense = fa.flash_attention(q, kd, vd, causal=False, kv_lens=kv_lens, k_scale=ksd,
                                       v_scale=vsd, block_q=1, block_k=PAGE, out_dtype=out_dtype)
            torch.cuda.synchronize()
            equal.append(bool(torch.equal(paged, dense)))
        line["equals_dense_kernel_on_gathered_pools"] = all(equal)
    line["kernel_ms"] = _time_ms(lambda: fa.paged_flash_attention(*args))
    line["device_ms"] = _graph_ms(lambda: fa.paged_flash_attention(*args))
    line["device_ms_by_kernel"] = _kernel_device_ms(lambda: fa.paged_flash_attention(*args))
    line["plain_ms"] = _time_ms(lambda: fa.paged_flash_attention_plain(*args), reps=3, warmup=1)
    # yardstick inputs: dequantized to bf16, expanded to the query heads
    kx = (kd.float() * ksd[..., None]).to(torch.bfloat16).repeat_interleave(HQ // HKV, dim=1)
    vx = (vd.float() * vsd[..., None]).to(torch.bfloat16).repeat_interleave(HQ // HKV, dim=1)
    mask = (torch.arange(kd.shape[2], device=q.device)[None, :] < kv_lens[:, None].long())
    line["library_ms"] = _sdpa_ms(q, kx, vx, attn_mask=mask[:, None, None, :])
    del kx, vx
    # the function reads each live position's K/V (one byte a value) and
    # scales once, the queries, tables and lengths, and writes the output
    live = int(sum(lens))
    n_bytes = (q.numel() * 2 + live * HKV * (2 * HEAD_DIM + 2 * 4) + tables.numel() * 4
               + kv_lens.numel() * 4 + q.numel() * 2)
    line["bound_ms"], line["bound_by"] = _bound(n_bytes, 4.0 * HQ * live * HEAD_DIM,
                                                PEAK_BF16_OPS_PER_S)
    print(json.dumps(line), flush=True)
    if line["body"] != "tensor_core_decode" or line.get("dense_twin_body", line["body"]) != \
            line["body"]:
        _die(f"paged_flash_attention {name} does not run the tensor-core decode body: {line}")
    if not all(oks):
        _die(f"paged_flash_attention {name} is outside the tolerance of its plain version: {errs}")
    if line.get("equals_dense_kernel_on_gathered_pools") is False:
        _die(f"paged_flash_attention {name} differs from the dense kernel on gathered pools")
    return line


def check_dense(name: str, gen, s: int, versus_oracle: bool) -> tuple[dict, tuple]:
    """The dense kernel (through its entry point's block sizes, 128 x 128)
    against its plain version at B=1, Sq=Sk=s, causal, bf16; with
    ``versus_oracle`` also against attention_ref (Sq == Sk: the kernels'
    top-left causal mask and the oracle's bottom-right one agree).
    Returns the line and the inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref

    dev = torch.device("cuda")
    q = torch.randn((1, HQ, s, HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((1, HKV, s, HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, HKV, s, HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(causal=True, block_q=128, block_k=128)
    errs, oks = [], []
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fa.flash_attention(q, k, v, out_dtype=out_dtype, **kw)
        plain = fa.flash_attention_plain(q, k, v, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        err, ok = _attn_err(got, plain)
        errs.append(err)
        oks.append(ok)
        del plain
    line = {"kernel": "flash_attention", "check": name, "B": 1, "Sq": s, "Sk": s,
            "causal": True, "heads": [HQ, HKV], "head_dim": HEAD_DIM, "blocks": [128, 128],
            "body": fa.dense_body(q.dtype, k.dtype, 128, HEAD_DIM, True),
            "f32_max_abs_err": errs[0], "bf16_max_abs_err": errs[1],
            "within_tolerance": all(oks), "max_abs_err": errs[0]}
    if versus_oracle:
        oracle = attention_ref(q, k, v, causal=True)
        err, ok = _attn_err(got, oracle)  # got: the bf16 output
        line.update(oracle_max_abs_err=err, oracle_within_tolerance=ok)
        oks.append(ok)
    line["kernel_ms"] = _time_ms(lambda: fa.flash_attention(q, k, v, **kw))
    line["device_ms"] = _graph_ms(lambda: fa.flash_attention(q, k, v, **kw))
    line["plain_ms"] = _time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), reps=3, warmup=1)
    kx = k.repeat_interleave(HQ // HKV, dim=1)
    vx = v.repeat_interleave(HQ // HKV, dim=1)
    line["library_ms"] = _sdpa_ms(q, kx, vx, is_causal=True)
    # causal (top-left): query i attends keys 0..i, s(s+1)/2 pairs a head
    pairs = s * (s + 1) / 2
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    line["bound_ms"], line["bound_by"] = _bound(n_bytes, 4.0 * HQ * pairs * HEAD_DIM,
                                                PEAK_BF16_OPS_PER_S)
    del kx, vx, got
    print(json.dumps(line), flush=True)
    if not all(oks):
        _die(f"flash_attention {name} is outside its tolerance: {line}")
    return line, (q, k, v)


def check_dense_int8(name: str, gen, lens) -> dict:
    """A5: the dense kernel's tensor-core body on an int8 K/V with scales,
    B = len(lens), Sq = Sk = DENSE_INT8_S, per-lane kv_lens (one of 0),
    causal and not, float32 and bf16 outputs, each within the tolerance of
    its plain version; timed (causal) beside its bound, its plain version
    and scaled_dot_product_attention on dequantized, expanded K/V."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    b, s = len(lens), DENSE_INT8_S
    q = torch.randn((b, HQ, s, HEAD_DIM), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randint(-127, 128, (b, HKV, s, HEAD_DIM), generator=gen, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, k.shape, generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand((b, HKV, s), generator=gen, device=dev) * 0.02 + 1e-3
    vs = torch.rand((b, HKV, s), generator=gen, device=dev) * 0.02 + 1e-3
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(block_q=128, block_k=128, kv_lens=kv_lens, k_scale=ks, v_scale=vs)
    errs, oks = {}, []
    for causal in (True, False):
        for out_dtype in (torch.float32, torch.bfloat16):
            got = fa.flash_attention(q, k, v, causal=causal, out_dtype=out_dtype, **kw)
            plain = fa.flash_attention_plain(q, k, v, causal=causal, out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            err, ok = _attn_err(got, plain)
            errs[f"{'causal' if causal else 'full'}_{str(out_dtype)[6:]}_max_abs_err"] = err
            oks.append(ok and bool(torch.isfinite(got).all()))
    line = {"kernel": "flash_attention", "check": name, "B": b, "Sq": s, "Sk": s, "lens": lens,
            "kv": "int8 with scales", "heads": [HQ, HKV], "head_dim": HEAD_DIM,
            "blocks": [128, 128], "body": fa.dense_body(q.dtype, k.dtype, 128, HEAD_DIM, True),
            **errs, "within_tolerance": all(oks), "max_abs_err": max(errs.values())}
    line["kernel_ms"] = _time_ms(lambda: fa.flash_attention(q, k, v, causal=True, **kw))
    line["device_ms"] = _graph_ms(lambda: fa.flash_attention(q, k, v, causal=True, **kw))
    line["full_kernel_ms"] = _time_ms(lambda: fa.flash_attention(q, k, v, causal=False, **kw))
    line["plain_ms"] = _time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, **kw),
                                reps=3, warmup=1)
    kx = (k.float() * ks[..., None]).to(torch.bfloat16).repeat_interleave(HQ // HKV, dim=1)
    vx = (v.float() * vs[..., None]).to(torch.bfloat16).repeat_interleave(HQ // HKV, dim=1)
    pos = torch.arange(s, device=dev)
    mask = ((pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < kv_lens[:, None, None]))
    line["library_ms"] = _time_ms(lambda: F.scaled_dot_product_attention(
        q, kx, vx, attn_mask=mask[:, None]))
    del kx, vx
    # causal with lengths: query i reads keys 0..min(i, len - 1); each live
    # position's K/V (one byte a value) and scales once, q and the output
    # once (the timed call writes q's dtype)
    out_size = fa.flash_attention(q, k, v, causal=True, **kw).element_size()
    pairs = sum(min(i + 1, n) for n in lens for i in range(s))
    n_bytes = (2 * q.numel() + sum(lens) * HKV * (2 * HEAD_DIM + 2 * 4) + 4 * b
               + out_size * q.numel())
    line["bound_ms"], line["bound_by"] = _bound(n_bytes, 4.0 * HQ * pairs * HEAD_DIM,
                                                PEAK_BF16_OPS_PER_S)
    print(json.dumps(line), flush=True)
    if not all(oks):
        _die(f"flash_attention {name} is outside its tolerance: {line}")
    return line


def check_attention(summary: dict) -> tuple:
    """A1-A5: the attention kernels at granite-3-8b's heads. Returns A4's
    inputs."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    summary["paged_flash_attention"] = [check_paged("A1 paged decode", gen, [1, 16, 37, 272])]
    rng = np.random.default_rng(7)
    lens = [int(x) for x in rng.integers(512, 4097, 64)]
    summary["paged_flash_attention"].append(check_paged("A2 paged decode at load", gen, lens))
    torch.cuda.empty_cache()
    a3, _ = check_dense("A3 dense prefill", gen, 256, True)
    a4, inputs = check_dense("A4 dense long", gen, 4096, False)
    a5 = check_dense_int8("A5 dense int8 prefill", gen, DENSE_INT8_LENS)
    summary["flash_attention"] = [a3, a4, a5]
    torch.cuda.empty_cache()
    return inputs


def count_dense_entry_point(q, k, v) -> int:
    """The dense kernel's own path: one call of the port's
    ``ops.flash_attention`` entry point on A4's inputs, counted: it must
    launch the dense kernel once and nothing else."""
    from repro_torch.kernels import ops

    _reset_counts()
    out = ops.flash_attention(q, k, v, causal=True, backend="auto")
    torch.cuda.synchronize()
    counts = _read_counts()
    if counts["flash_attention"] != 1 or sum(counts.values()) != 1:
        _die(f"ops.flash_attention launched {counts}")
    if out.shape != q.shape or not bool(torch.isfinite(out).all()):
        _die("ops.flash_attention gave a malformed result")
    return counts["flash_attention"]


def _profile(engine, reqs, schedule) -> dict:
    """Device side of one served run under ``torch.profiler``: the time
    and number of device events (kernels, copies, sets) in all, and the
    time of those that start inside the host spans of the engine's
    ``serve.prefill`` / ``serve.decode_step`` ranges. The profiler slows
    the host, so host times come from unprofiled runs."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        engine.run(reqs, precision_schedule=schedule)
        torch.cuda.synchronize()
    spans: dict[str, list] = {"serve.prefill": [], "serve.decode_step": []}
    device = []  # (name, start, us) of each device event
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            if evt.name in spans:
                spans[evt.name].append((evt.time_range.start, evt.time_range.end))
        elif evt.name not in spans:  # not a range's own span on the device timeline
            device.append((evt.name, evt.time_range.start,
                           evt.time_range.end - evt.time_range.start))
    # each range ends by reading its result back to the host, so the device
    # work it launched starts inside its host span (one profiler clock)
    in_range = {name: sum(us for _, start, us in device
                          if any(lo <= start < hi for lo, hi in ranges))
                for name, ranges in spans.items()}
    busy_us = sum(us for _, _, us in device)
    plane_us = sum(us for name, _, us in device
                   if any(tag in name for tag in ("plane_linear", "plane_mm", "packed_mm",
                                                  "epilogue_kernel")))
    attn_us = sum(us for name, _, us in device
                  if any(tag in name for tag in ATTENTION_KERNEL_TAGS))
    if not spans["serve.decode_step"]:
        print("[chip_smoke] the profile holds no serve.decode_step range: per-step device "
              "times are not measured", file=sys.stderr)
    return {
        "device_events": len(device), "device_busy_s": busy_us / 1e6,
        "plane_kernels_s": plane_us / 1e6, "attention_kernels_s": attn_us / 1e6,
        "prefill_ranges": len(spans["serve.prefill"]),
        "prefill_device_s": in_range["serve.prefill"] / 1e6,
        "decode_ranges": len(spans["serve.decode_step"]),
        "decode_device_s": in_range["serve.decode_step"] / 1e6,
        "outside_ranges_s": (busy_us - sum(in_range.values())) / 1e6,
    }


def _counters() -> dict:
    from repro_torch.launch import graphs

    return graphs.launch_counters()


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _requests(cfg) -> list:
    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (s,)) for s in PROMPT_LENS]
    return [
        Request(rid=i, tokens=p, max_new_tokens=GEN_TOKENS, arrival_step=STAGGER * i)
        for i, p in enumerate(prompts)
    ]


def _check_finished(name: str, cfg, results: dict, stats: dict, reqs=None) -> None:
    """Every request finished with its ``max_new_tokens`` in-vocab tokens
    (``reqs``: the run's requests, default ``_requests(cfg)``)."""
    want = {r.rid: r.max_new_tokens for r in (reqs or _requests(cfg))}
    if stats["failed"] or sorted(results) != sorted(want):
        _die(f"{name}: not every request finished: {stats['failed']}")
    for rid, toks in results.items():
        if toks.shape != (want[rid],) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            _die(f"{name}: request {rid} produced malformed tokens {toks}")


def _same_tokens(name: str, results: dict, other: dict, what: str) -> None:
    mismatch = [rid for rid in results if not np.array_equal(results[rid], other[rid])]
    if mismatch:
        _die(f"{name}: greedy tokens differ from {what} for requests {mismatch}")


def _engine(cfg, params, policy, **kw):
    from repro_torch.launch.serve import ContinuousBatchingEngine

    kw.setdefault("max_len", max(PROMPT_LENS) + GEN_TOKENS)
    return ContinuousBatchingEngine(cfg, params, policy, n_slots=N_SLOTS, device="cuda", **kw)


class _ReadBacks:
    """Counts the pair-weight read-backs of the kernel wrappers' route
    decision (``bytesplit.is_outer_product``): the plan executors' pair
    weights carry their factors, so a served run makes none."""

    def __enter__(self):
        from repro_torch.kernels import bytesplit

        self.mod, self.orig, self.calls = bytesplit, bytesplit.is_outer_product, 0

        def counted(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)

        bytesplit.is_outer_product = counted
        return self

    def __exit__(self, *exc):
        self.mod.is_outer_product = self.orig


def _counted_run(name, cfg, engine, schedule, kernel, route, also=(), reqs=_requests,
                 around=contextlib.nullcontext) -> tuple:
    """One warm-up (on a graph engine it captures each precision's decode
    step), then the counted run: launch counts are set to 0 just before it
    and read just after; ``kernel`` must have launched once per ``route``
    projection call and no other kernel but those in ``also``, and no pair
    weights may have been read back. On a graph engine every decode step
    must have replayed a captured graph (no capture inside the run).
    ``reqs(cfg)`` makes the workload's requests; ``around()`` is entered
    around the counted run alone."""
    # allocator, library handles, and each precision's decode-step graph
    engine.run(reqs(cfg)[:1], precision_schedule=schedule)
    engine.set_precision(None)
    with _ReadBacks() as reads, around():
        _reset_counts()
        results, stats = engine.run(reqs(cfg), precision_schedule=schedule)
        counts = _read_counts()
    stats["pair_weight_read_backs"] = reads.calls
    if reads.calls:
        _die(f"{name}: {reads.calls} pair-weight read-backs in a served run")
    _check_finished(name, cfg, results, stats, reqs(cfg))
    calls = stats["route_calls"].get(route, 0)
    others = {k: v for k, v in counts.items() if k != kernel and k not in also and v}
    if counts[kernel] == 0 or counts[kernel] != calls or others:
        _die(f"{name}: launches {counts} against {route} projection calls {calls}")
    if engine.compile_steps and (stats["capture_s"] or not engine._compiled_graphs):
        _die(f"{name}: the counted run captured {stats['capture_s']}, graphs "
             f"{list(engine._compiled_graphs)}")
    return results, stats, counts


# the main kernel of each counted wrapper, by the name it has in a device trace
MAIN_KERNELS = {"fused_plane_linear": "plane_mm_fused_main", "plane_matmul": "plane_mm_kernel",
                "plane_matmul_packed": "plane_mm_packed_main",
                "paged_flash_attention": "decode_split_paged_kernel"}


# idle seconds between the two replays of a profiled session. A
# torch.profiler session can lose the first device records of its first
# graph replay (late in this script's process, a main kernel among them),
# so the session replays twice and counts the second replay
PROFILE_GAP_S = 0.05


def _profiled_replays(captured, tallied: dict) -> list:
    """Two replays of a captured step in one ``torch.profiler`` session,
    ``PROFILE_GAP_S`` of idle card apart; the device records are split at
    the longest idle gap between consecutive ones. Per replay: its device
    events and its main kernels counted by name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            captured(0)
            torch.cuda.synchronize()
            time.sleep(PROFILE_GAP_S)
    cuda = sorted((evt for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda evt: evt.time_range.start)
    cut = max(range(1, len(cuda)),
              key=lambda i: cuda[i].time_range.start - cuda[i - 1].time_range.end)
    return [{"device_events": len(replay),
             "main_kernels": {k: sum(MAIN_KERNELS[k] in evt.name for evt in replay)
                              for k in tallied}}
            for replay in (cuda[:cut], cuda[cut:])]


def _graph_line(name: str, engine, reps: int = 20) -> dict:
    """The engine's captured decode steps: each precision's warm-up and
    capture seconds on a line of its own; one replay of the storage-width
    graph under ``torch.profiler`` (CPU and CUDA activities), whose main
    kernels counted by name must equal the launches the engine tallies per
    replay; and the device time of a replay (CUDA events around ``reps``
    replays, on the finished run's state, which the next run resets).
    The profile holds two replays and counts the second
    (``_profiled_replays``); the first's counts are reported beside it."""
    for prec, secs in engine.capture_s.items():
        print(json.dumps({"engine": name, "graph_precision": str(prec), "capture_s": secs}),
              flush=True)
    captured = engine._compiled_graphs[None]
    captured(0)
    torch.cuda.synchronize()
    tallied = {k: v for k, v in captured.increment["launches"].items() if v}
    first, counted = _profiled_replays(captured, tallied)
    found = counted["main_kernels"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        captured(i)
    end.record()
    end.synchronize()
    line = {"captured_precisions": [str(p) for p in engine._compiled_graphs],
            "capture_s": {str(p): t for p, t in engine.capture_s.items()},
            "replay_device_events": counted["device_events"], "replay_kernel_counts": found,
            "tallied_launches_per_replay": tallied, "first_profiled_replay": first,
            "replay_device_ms": start.elapsed_time(end) / reps}
    if found != tallied:
        _die(f"{name}: a profiled replay ran {found} main kernels, the engine tallies {tallied} "
             f"(the session's first replay: {first})")
    return line


def _eager_twin(name, cfg, params, policy, schedule, kernel, route, results, counts,
                also=(), reqs=_requests, family_ops=False, **kw) -> dict:
    """The same cell with ``compile_steps=False``: the eager step must give
    the graph run's tokens and launch counts. Returns its host times and,
    with ``family_ops``, the device time per decode step of the families'
    own operators (``_family_ops``, one more profiled run); on an MoE model
    the counted run's dropped expert copies (``_drops``)."""
    from repro_torch.layers import moe

    logs = []

    @contextlib.contextmanager
    def drops():
        with moe.record_drops() as log:
            yield
        logs.append(log)

    engine = _engine(cfg, params, policy, compile_steps=False, **kw)
    res, stats, cnt = _counted_run(f"{name} eager", cfg, engine, schedule, kernel, route, also,
                                   reqs, around=drops)
    ops = _family_ops(engine, reqs(cfg), schedule) if family_ops else None
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _same_tokens(f"{name} graph", results, res, "the eager step")
    if cnt != counts:
        _die(f"{name}: graph launches {counts} against the eager step's {cnt}")
    return {"tokens_equal": True, "launches_equal": True, "launches": cnt,
            "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
            "decode_s": stats["decode_s"],
            "host_ms_per_decode_step": 1e3 * stats["decode_s"] / stats["decode_steps"],
            "integrity": stats.get("integrity"), "family_ops_device_ms_per_decode_step": ops,
            "moe_dropped_copies": _drops(logs[0]) if cfg.family == "moe" else None}


def _drops(log) -> dict:
    """The MoE layers' dispatches of one eager run, prefill (a sequence of
    several tokens) and decode (one token per slot) apart: calls, token
    copies and copies dropped past an expert's capacity."""
    out = {phase: {"calls": 0, "copies": 0, "dropped": 0} for phase in ("prefill", "decode")}
    for s, n, dropped in log:
        c = out["decode" if s == 1 else "prefill"]
        c["calls"] += 1
        c["copies"] += n
        c["dropped"] += int(dropped)
    return out


def _summary(name, cfg, results, stats, counts, kernel, runs, profile) -> dict:
    return {
        "engine": name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "requests": len(results), "tokens": stats["decoded_tokens"] + stats["admitted"],
        "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
        "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
        "decode_steps": stats["decode_steps"], "launches": counts[kernel], "all_launches": counts,
        "pair_weight_read_backs": stats.get("pair_weight_read_backs"),
        "route_calls": stats["route_calls"], "precision_switches": stats["precision_switches"],
        "runs": [{k: s[k] for k in ("wall_s", "prefill_s", "decode_s", "tok_per_s")} for s in runs],
        "profile": profile,
        # device time (in all, and inside the ranges) over each run's host
        # time (wall, and of the same phase)
        "busy_share": [profile["device_busy_s"] / s["wall_s"] for s in runs],
        "decode_busy_share": [profile["decode_device_s"] / s["decode_s"] for s in runs],
        "prefill_busy_share": [profile["prefill_device_s"] / s["prefill_s"] for s in runs],
        "host_ms_per_decode_step": [1e3 * s["decode_s"] / s["decode_steps"] for s in runs],
        "device_ms_per_decode_step": (1e3 * profile["decode_device_s"] / profile["decode_ranges"]
                                      if profile["decode_ranges"] else None),
    }


def run_engine(level: str, cfg, params, kernel: str, route: str) -> tuple[dict, dict, dict]:
    """Serve the workload at ``level`` (the fused kernel at bitplane, the
    plane-pair kernel at digit) and on the plain path; returns the summary,
    the kernel path's tokens and the plain path's."""
    from repro_torch.core.precision import PrecisionPolicy

    schedule = {8: 4} if level == "bitplane" else None
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level=level)
    engine = _engine(cfg, params, policy)
    results, stats, counts = _counted_run(level, cfg, engine, schedule, kernel, route)
    # two more timed runs give the spread of the host-side times
    reruns = []
    for _ in range(2):
        engine.set_precision(None)
        reruns.append(engine.run(_requests(cfg), precision_schedule=schedule)[1])
    engine.set_precision(None)
    profile = _profile(engine, _requests(cfg), schedule)
    graph = _graph_line(level, engine)
    del engine
    gc.collect()
    eager = _eager_twin(level, cfg, params, policy, schedule, kernel, route, results, counts)
    plain = _engine(cfg, params, policy, backend="torch", compile_steps=False)
    _reset_counts()
    res_plain, stats_plain = plain.run(_requests(cfg), precision_schedule=schedule)
    plain_counts = _read_counts()
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    if any(plain_counts.values()) or set(stats_plain["route_calls"]) != {"cached_scan"}:
        _die(f"{level}: the plain run launched kernels {plain_counts} or took routes "
             f"{stats_plain['route_calls']}")
    _same_tokens(level, results, res_plain, "the plain path")
    out = _summary(level, cfg, results, stats, counts, kernel, [stats] + reruns, profile)
    out.update(plain_tok_per_s=stats_plain["tok_per_s"],
               plain_route_calls=stats_plain["route_calls"], tokens_equal_plain=True,
               graph=graph, eager=eager)
    print(json.dumps(out), flush=True)
    return out, results, res_plain


# -- the tile autotuner and its plan store (phase 3b) --------------------------

# rows 1-3 of the kernel table and the plan route each is timed on; the
# plane-pair kernel at the digit level, as the digit cell runs it
TUNED_ROWS = (("fused_plane_linear", "fused_cached", "bitplane"),
              ("plane_matmul_packed", "cached_packed", "bitplane"),
              ("plane_matmul", "cached_planes", "digit"))
TUNED_SHAPES = ((4, 4096, 12800), (256, 4096, 12800))  # the decode gate shape; prefill M=256


def _tuning_key(m, k, n, route, level):
    """The plan key a granite projection resolves to on ``route``."""
    from repro_torch.core import bitplanes as bp
    from repro_torch.core.plan import PlanKey

    cache = (("bitplane", "booth", 8, True, bp.DEFAULT_BLOCK, False, 8, False)
             if level == "bitplane" else ("digit", "booth", 8, False, None, True, 2, False))
    return PlanKey(m=m, k=k, n=n, a_bits=8, w_bits=8, a_in_bits=8, w_in_bits=8,
                   variant="booth", level=level, mode="fully_serial", backend="cuda",
                   accum="int32", has_epilogue=True, cache=cache,
                   fused=None if route == "fused_cached" else False, packed=None,
                   bm=None, bn=None, bk=None)


def check_tuned_kernels() -> list:
    """Rows 1-3 at the decode gate shape and at M=256: each of the tuner's
    candidates (``tile_candidates``, the default first) must give the
    default's output bit for bit (the fused kernel's raw int32 accumulator
    and its bf16 epilogue); the tuner then times them on the route's kernel
    (``KernelTimer``: CUDA events, the card idled ahead of back-to-back
    calls, the weight read cold) and the default and the winner are timed
    again as graph replays (``_graph_ms``, the kernel table's device time),
    with the default's row tile in one K range beside them: the default
    before it filled a part-empty last wave. Printed, not gated."""
    from repro_torch.core import autotune

    hw = autotune.hardware_model("cuda")
    lines = []
    for m, k, n in TUNED_SHAPES:
        for name, route, level in TUNED_ROWS:
            key = _tuning_key(m, k, n, route, level)
            timer = autotune.KernelTimer()
            tuner = autotune.PlanAutotuner(None, hw=hw, measure=timer)
            cands = autotune.tile_candidates(key, route, hw)
            call = timer.route_call(key, route)
            outs = {}
            for raw in ({False, True} if route == "fused_cached" else {False}):
                want = call(cands[0][0], cands[0][3], raw=raw)
                for tiles in cands[1:]:
                    if not torch.equal(call(tiles[0], tiles[3], raw=raw), want):
                        _die(f"autotune {name} M={m}: candidate {tiles} differs from the "
                             f"default {cands[0]} (raw={raw})")
                outs[raw] = want
            winner, detail = tuner.tune(key, route)
            tag = "x".join(map(str, winner))
            line = {
                "autotune_kernel": name, "route": route, "level": level, "M": m, "K": k, "N": n,
                "candidates": [list(t) for t in cands], "candidates_bit_equal": True,
                "default": list(cands[0]), "tuned": list(winner),
                "timer_us": detail["wall_us"],
                "default_timer_us": detail["wall_us"]["x".join(map(str, cands[0]))],
                "tuned_timer_us": detail["wall_us"][tag],
                "model_us": {"x".join(map(str, t)): autotune._predict_us(hw, route, key, t[0],
                                                                         t[2], t[3])
                             for t in cands},
                "default_device_ms": _graph_ms(lambda: call(cands[0][0], cands[0][3])),
                "tuned_device_ms": _graph_ms(lambda: call(winner[0], winner[3])),
                "one_range_device_ms": _graph_ms(lambda: call(cands[0][0], 1)),
                "card": CARD,
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
            del call, timer, tuner, outs
            gc.collect()
            torch.cuda.empty_cache()
    return lines


def check_front_door() -> dict:
    """``ops.bitserial_matmul`` on the card at the decode gate shape — fused
    with its epilogue, packed, and at the digit level — bit-equal to the
    ``torch`` backend (the plain versions) on the same operands, each
    raising its row's launch counter."""
    from repro_torch.kernels import ops

    m, k, n = TUNED_SHAPES[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    ep = ops.Epilogue(a_scale=torch.rand((m, 1), generator=gen, device="cuda"),
                      w_scale=torch.rand((n,), generator=gen, device="cuda") * 1e-3)
    cases = {"fused": ("fused_plane_linear", dict(level="bitplane", epilogue=ep)),
             "packed": ("plane_matmul_packed", dict(level="bitplane", packed=True)),
             "digit": ("plane_matmul", dict(level="digit"))}
    out = {}
    for case, (kernel, kw) in cases.items():
        _reset_counts()
        with warnings.catch_warnings():  # the legacy keywords warn once, by design
            warnings.simplefilter("ignore", DeprecationWarning)
            got = ops.bitserial_matmul(a, w, a_bits=8, w_bits=8, backend="cuda", **kw)
            torch.cuda.synchronize()
            counts = _read_counts()
            plain = ops.bitserial_matmul(a, w, a_bits=8, w_bits=8, backend="torch", **kw)
        if not counts[kernel] or not torch.equal(got, plain):
            _die(f"front door {case}: launches {counts}, equal to the plain version "
                 f"{torch.equal(got, plain)}")
        out[case] = {"kernel": kernel, "launches": counts[kernel], "dtype": str(got.dtype),
                     "bit_equal": True}
    line = {"front_door": out, "M": m, "K": k, "N": n}
    print(json.dumps(line), flush=True)
    return line


def _stored_records(path: str, fingerprint: str) -> dict:
    return json.loads(Path(path).read_text())["hosts"].get(fingerprint, {})


def _stored_key(key_id: str):
    """The PlanKey a store's key id was made from (requested tiles None)."""
    from repro_torch.core.plan import PlanKey

    d = json.loads(key_id)
    d["cache"] = None if d["cache"] is None else tuple(d["cache"])
    d["shard"] = None if d["shard"] is None else tuple(d["shard"])
    return PlanKey(bm=None, bn=None, bk=None, **d)


def _replay_ms(engine, reps: int = 20) -> float:
    """Device ms of one replay of the engine's storage-width decode graph:
    CUDA events around ``reps`` replays on the finished run's state."""
    captured = engine._compiled_graphs[None]
    captured(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        captured(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_autotune(cfg, params, bit_results: dict) -> dict:
    """The bitplane cell served with the tile autotuner on a plan store
    under a temp dir: ``bitplane-autotune`` (cold: a fresh store, every plan
    of the workload tuned on the card in the eager warm-ups and prefills)
    and ``bitplane-autotune-warm`` (a new tuner on the same file, the plan
    registry cleared: every plan from the store). Gates: tokens equal to
    ``bitplane``'s in both; cold ``tunes == store_misses >= 1`` and every
    stored record legal; warm no tune, no miss and ``store_hits`` = the cold
    cell's tunes; the fingerprint names the card; no plan resolved inside a
    capture. Printed: the tiles chosen, and tuned (the cold engine) against
    an untuned control engine of the same cell, in turns (control, tuned,
    tuned, control): the device ms of a replay of the storage-width decode
    graph, and a profiled run's device time inside the prefill and
    decode-step ranges. The tuner is detached and the registry cleared
    after."""
    import shutil
    import tempfile

    from repro_torch.core import autotune, plan as plan_mod
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import ops

    registry = plan_mod.DEFAULT_REGISTRY
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane")
    schedule = {8: 4}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    path = str(Path(tmp) / "plans.json")
    capturing = []  # per plan the tuner resolved: was a stream capturing?
    out = {}
    engines = {}
    try:
        registry.attach_tuner(None)
        registry.clear()
        control = _engine(cfg, params, policy)  # untuned: the wrappers' default geometry
        results, _ = control.run(_requests(cfg), precision_schedule=schedule)
        _same_tokens("bitplane-autotune control", results, bit_results, "bitplane's")
        engines["control"] = control
        for name in ("bitplane-autotune", "bitplane-autotune-warm"):
            registry.attach_tuner(None)  # the next engine attaches a new tuner
            registry.clear()
            t0 = time.perf_counter()
            engine = _engine(cfg, params, policy, autotune=True, plan_store_path=path)
            tuner = engine.autotuner
            tiles_for = tuner.tiles_for

            def watched(key, kernel, _tiles_for=tiles_for):
                capturing.append(torch.cuda.is_current_stream_capturing())
                return _tiles_for(key, kernel)

            tuner.tiles_for = watched
            results, stats, counts = _counted_run(name, cfg, engine, schedule,
                                                  "fused_plane_linear", "fused_cached")
            _same_tokens(name, results, bit_results, "bitplane's")
            ps = tuner.stats()
            tuned = [p for p in registry.plans() if p.tuned]
            line = {
                "engine": name, "store": ps, "cell_s": time.perf_counter() - t0,
                "plans_resolved": len(registry), "plans_tuned": len(tuned),
                "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
                "prefill_s": stats["prefill_s"], "launches": counts["fused_plane_linear"],
                "tokens_equal_bitplane": True,
                # (route, M, K, N, a_bits, bm, k_split) of every tuned plan
                "tiles": sorted({(p.kernel, p.key.m, p.key.k, p.key.n, p.key.a_bits, p.bm,
                                  p.k_split) for p in tuned}),
                "card": CARD,
            }
            fp = ps["fingerprint"]
            if autotune._slug(torch.cuda.get_device_name(0)) not in fp:
                _die(f"{name}: the fingerprint {fp} does not name the card")
            if name == "bitplane-autotune":
                engines["tuned"] = engine
                if not ps["tunes"] >= 1 or ps["tunes"] != ps["store_misses"] or ps["store_hits"]:
                    _die(f"{name}: store counters {ps}")
                records = _stored_records(path, fp)
                for kid, rec in records.items():
                    key = json.loads(kid)
                    block = key["cache"][4] if rec["kernel"] == "fused_cached" else None
                    if not ops.tiles_legal(rec["bm"], rec["bn"], rec["bk"], kernel=rec["kernel"],
                                           k_split=rec["k_split"], k=key["k"],
                                           pack_block=block):
                        _die(f"{name}: illegal stored record {rec} for {kid}")
                measured = sum(r["source"] == "measured" for r in records.values())
                defaults = sum(
                    (r["bm"], r["bn"], r["bk"], r["k_split"])
                    == autotune._heuristic_tiles(_stored_key(kid), r["kernel"])
                    for kid, r in records.items())
                if len(records) != ps["tunes"] or not measured:
                    _die(f"{name}: {len(records)} records ({measured} measured) for "
                         f"{ps['tunes']} tunes")
                line.update(records=len(records), records_measured=measured,
                            records_default_won=defaults, records_legal=True)
            else:
                tuners = {"control": None, "tuned": tuner}  # the warm tuner: all memo hits
                del engine
                if ps["tunes"] or ps["store_misses"] or \
                        ps["store_hits"] != out["bitplane-autotune"]["store"]["tunes"]:
                    _die(f"{name}: store counters {ps} after a cold run of "
                         f"{out['bitplane-autotune']['store']}")
            out[name] = line
            print(json.dumps(line), flush=True)
        if any(capturing) or not capturing:
            _die(f"plans resolved inside a CUDA-graph capture: {sum(capturing)} of "
                 f"{len(capturing)}")
        order = ("control", "tuned", "tuned", "control")
        turns = [(who, _replay_ms(engines[who])) for who in order]
        profiles = []
        for who in order:  # eager prefill resolves its plans: the registry as each engine's
            registry.attach_tuner(tuners[who])
            registry.clear()
            engines[who].set_precision(None)
            engines[who].run(_requests(cfg), precision_schedule=schedule)  # resolve, untimed
            engines[who].set_precision(None)
            profiles.append((who, _profile(engines[who], _requests(cfg), schedule)))

        def mean(values, who):
            return float(np.mean([v for w, v in values if w == who]))

        per_step = [(w, 1e3 * p["decode_device_s"] / max(1, p["decode_ranges"]))
                    for w, p in profiles]
        out["replay"] = {
            "turns": turns,
            "untuned_device_ms": mean(turns, "control"),
            "tuned_device_ms": mean(turns, "tuned"),
            "prefill_device_s": [(w, p["prefill_device_s"]) for w, p in profiles],
            "untuned_prefill_device_s": mean([(w, p["prefill_device_s"]) for w, p in profiles],
                                             "control"),
            "tuned_prefill_device_s": mean([(w, p["prefill_device_s"]) for w, p in profiles],
                                           "tuned"),
            "untuned_decode_device_ms_per_step": mean(per_step, "control"),
            "tuned_decode_device_ms_per_step": mean(per_step, "tuned"),
            "card": CARD,
        }
        print(json.dumps({"engine": "bitplane-autotune", "replay": out["replay"]}), flush=True)
    finally:
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
        registry.attach_tuner(None)
        registry.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    out["tuner_lookups"] = len(capturing)
    out["tuner_lookups_inside_capture"] = 0
    return out


def run_nofused(cfg, params, fused_results: dict, plain_results: dict) -> tuple:
    """The bitplane workload with the fused kernel off: every projection
    through the packed kernel (route cached_packed), tokens equal to the
    plain path's and to the fused engine's. Returns the summary, the
    tokens, and the tokens of one more run at 8 bits throughout (no switch:
    the scrub cells' yardstick)."""
    from repro_torch.core.precision import PrecisionPolicy

    name, schedule = "bitplane-nofused", {8: 4}
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane",
                                     fuse_epilogue=False)
    engine = _engine(cfg, params, policy)
    results, stats, counts = _counted_run(
        name, cfg, engine, schedule, "plane_matmul_packed", "cached_packed")
    engine.set_precision(None)
    profile = _profile(engine, _requests(cfg), schedule)
    graph = _graph_line(name, engine)
    engine.set_precision(None)
    results8, stats8 = engine.run(_requests(cfg))
    _check_finished(f"{name} at 8 bits", cfg, results8, stats8)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    eager = _eager_twin(name, cfg, params, policy, schedule, "plane_matmul_packed",
                        "cached_packed", results, counts)
    _same_tokens(name, results, plain_results, "the plain path")
    _same_tokens(name, results, fused_results, "the fused bitplane engine")
    out = _summary(name, cfg, results, stats, counts, "plane_matmul_packed", [stats], profile)
    out.update(tokens_equal_plain=True, tokens_equal_fused=True, graph=graph, eager=eager)
    print(json.dumps(out), flush=True)
    return out, results, results8


def _flip_weight_bit(engine) -> None:
    """Flip one bit of one packed weight word, on the card."""
    mag = engine.q_params["layers"][0]["mlp"]["gate_proj"]["w_planes"].packed.mag
    mag[0, 0, 0] ^= 1 << 5


def _detect_pass(name, cfg, params, schedule, nofused_results, checks_of,
                 compile_steps=True) -> tuple:
    """Serve the workload with detect-mode integrity and an audit every
    iteration: the clean run must raise no alarm, count ``checks_of(stats)``
    ABFT checks and give bitplane-nofused's tokens; then one weight bit is
    flipped on the card and a second run must raise at least one ABFT alarm
    and one audit alarm. Returns the engine and the clean run's results,
    stats and launch counts."""
    from repro_torch.core.precision import PrecisionPolicy

    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane",
                                     integrity="detect")
    engine = _engine(cfg, params, policy, audit_interval=1, compile_steps=compile_steps)
    results, stats, counts = _counted_run(
        name, cfg, engine, schedule, "plane_matmul_packed", "cached_packed", also=("fold",))
    clean = stats["integrity"]
    if (clean["abft_alarms"], clean["audit_alarms"], clean["kv_alarms"]) != (0, 0, 0):
        _die(f"{name}: alarms on a clean run: {clean}")
    if clean["abft_checks"] != checks_of(stats) or not clean["audits"] or not clean["kv_checks"]:
        _die(f"{name}: {clean['abft_checks']} ABFT checks against {checks_of(stats)} expected, "
             f"{clean['audits']} audits, {clean['kv_checks']} KV checks")
    _same_tokens(name, results, nofused_results, "bitplane-nofused")
    return engine, results, stats, counts


def _flipped_pass(name, cfg, engine, schedule) -> dict:
    """Flip one weight bit of ``engine`` and serve again: at least one ABFT
    alarm and one audit alarm must follow. Returns the integrity counts."""
    _flip_weight_bit(engine)
    engine.set_precision(None)
    _, fstats = engine.run(_requests(cfg), precision_schedule=schedule)
    flipped = fstats["integrity"]
    if flipped["abft_alarms"] < 1 or flipped["audit_alarms"] < 1:
        _die(f"{name}: a flipped weight bit went undetected: {flipped}")
    return flipped


def _detect_eager(name, cfg, params, schedule, nofused_results, checks_of, results, counts,
                  clean, flipped) -> dict:
    """The detect pass with ``compile_steps=False``: tokens, launches and
    the integrity counts, clean and after the flipped bit, must equal the
    graph engine's."""
    engine, res, stats, cnt = _detect_pass(f"{name} eager", cfg, params, schedule,
                                           nofused_results, checks_of, compile_steps=False)
    eflipped = _flipped_pass(f"{name} eager", cfg, engine, schedule)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    _same_tokens(f"{name} graph", results, res, "the eager step")
    if cnt != counts or stats["integrity"] != clean or eflipped != flipped:
        _die(f"{name}: graph {counts} {clean} {flipped} against eager {cnt} "
             f"{stats['integrity']} {eflipped}")
    return {"tokens_equal": True, "launches_equal": True, "integrity_equal": True,
            "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
            "decode_s": stats["decode_s"],
            "host_ms_per_decode_step": 1e3 * stats["decode_s"] / stats["decode_steps"]}


def check_fold(summary: dict, engine) -> dict:
    """The fold kernel on the detect engine's whole quantized tree (full
    width, 4 layers) and on its KV cache after a run: bit-equal to the
    plain folds (``integrity.tree_checksum``, ``cache_slot_checksums``);
    one flipped weight bit moves the tree's fold and one flipped KV bit
    only its slot's (both flipped back); timed beside its byte bound."""
    from repro_torch.core import integrity
    from repro_torch.kernels import fold
    from repro_torch.models.cache import cache_slot_checksums

    tree, cache = engine.q_params, engine._cache
    got, plain = fold.tree_fold(tree), integrity.tree_checksum(tree)
    slots, slots_plain = fold.slot_folds(cache), cache_slot_checksums(cache)
    torch.cuda.synchronize()
    mag = tree["layers"][1]["attn"]["o_proj"]["w_planes"].packed.mag
    mag[3, 5, 7] ^= 1 << 30
    moved = int(fold.tree_fold(tree)) != int(got)
    mag[3, 5, 7] ^= 1 << 30
    kq = cache["layers"][2]["k_q"]
    kq[1, 3, 0, 9] ^= 4
    slot_moved = (fold.slot_folds(cache) != slots).tolist()
    kq[1, 3, 0, 9] ^= 4
    tree_bytes = sum(t.numel() * t.element_size() for t in integrity._leaves(tree))
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in [cache["step"]] + [v for b in cache["layers"] for v in b.values()])
    line = {"kernel": "fold", "shape": "quantized tree", "tree_bytes": tree_bytes,
            "kv_bytes": kv_bytes, "n_slots": int(cache["step"].shape[0]),
            "tree_equal": int(got) == int(plain), "kv_equal": bool(torch.equal(slots, slots_plain)),
            "flip_moves_tree": moved, "flip_moves_slot": slot_moved,
            "max_abs_err": float(abs(int(got) - int(plain))),
            "kernel_ms": _time_ms(lambda: fold.tree_fold(tree)),
            "device_ms": _graph_ms(lambda: fold.tree_fold(tree)),
            "plain_ms": _time_ms(lambda: integrity.tree_checksum(tree), reps=3, warmup=1),
            "kv_device_ms": _graph_ms(lambda: fold.slot_folds(cache)),
            "kv_plain_ms": _time_ms(lambda: cache_slot_checksums(cache), reps=3, warmup=1),
            # no one PyTorch call folds a tree of tensors
            "library_ms": None}
    # one read of every byte; a byte sum is no tensor-core work
    line["bound_ms"], line["bound_by"] = tree_bytes / PEAK_BYTES_PER_S * 1e3, "bytes"
    line["kv_bound_ms"] = kv_bytes / PEAK_BYTES_PER_S * 1e3
    print(json.dumps(line), flush=True)
    if not (line["tree_equal"] and line["kv_equal"] and moved
            and slot_moved == [s == 1 for s in range(line["n_slots"])]):
        _die(f"fold: the kernel differs from the plain folds or misses a flipped bit: {line}")
    summary["fold"] = [line]
    return line


def run_detect(cfg, params, nofused: dict, nofused_results: dict, summary: dict) -> dict:
    """The nofused workload with ABFT checks, at-rest audits every
    iteration and per-slot KV checksums, twice: with the layers unrolled
    (``scan_layers=False``: names only, the arithmetic is the same), so
    that every projection's check counts on its own, and on the default
    scanned stack, which reports one folded check for the stack and one
    for lm_head per forward, as the reference's lax.scan does."""
    name, schedule = "bitplane-detect", {8: 4}
    unrolled = dataclasses.replace(cfg, scan_layers=False)
    unrolled_checks = lambda st: st["route_calls"].get("cached_packed", 0)  # noqa: E731
    engine, results, stats, counts = _detect_pass(
        name, unrolled, params, schedule, nofused_results, unrolled_checks)
    engine.set_precision(None)
    profile = _profile(engine, _requests(cfg), schedule)
    graph = _graph_line(name, engine)
    check_fold(summary, engine)
    flipped = _flipped_pass(name, unrolled, engine, schedule)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    eager = _detect_eager(name, unrolled, params, schedule, nofused_results, unrolled_checks,
                          results, counts, stats["integrity"], flipped)

    scan_name = "bitplane-detect-scan"
    scan_checks = lambda st: 2 * (st["admitted"] + st["decode_steps"])  # noqa: E731
    engine, scan_results, scan_stats, scan_counts = _detect_pass(
        scan_name, cfg, params, schedule, nofused_results, scan_checks)
    scan_flipped = _flipped_pass(scan_name, cfg, engine, schedule)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    scan_eager = _detect_eager(scan_name, cfg, params, schedule, nofused_results, scan_checks,
                               scan_results, scan_counts, scan_stats["integrity"], scan_flipped)

    steps = stats["decode_steps"]
    out = _summary(name, unrolled, results, stats, counts, "plane_matmul_packed", [stats],
                   profile)
    out.update(
        integrity_clean=stats["integrity"], integrity_flipped=flipped,
        tokens_equal_nofused=True,
        scan_integrity_clean=scan_stats["integrity"], scan_integrity_flipped=scan_flipped,
        scan_tokens_equal_nofused=True, scan_wall_s=scan_stats["wall_s"],
        graph=graph, eager=eager, scan_eager=scan_eager, fold_launches=counts["fold"],
        # what detection adds over the same workload without it
        overhead_wall_s=stats["wall_s"] - nofused["wall_s"],
        overhead_wall_ratio=stats["wall_s"] / nofused["wall_s"],
        overhead_decode_step_ms=1e3 * (stats["decode_s"] / steps
                                       - nofused["decode_s"] / nofused["decode_steps"]),
        overhead_decode_step_ratio=(stats["decode_s"] / steps)
        / (nofused["decode_s"] / nofused["decode_steps"]),
    )
    print(json.dumps(out), flush=True)
    return out


# the bitplane-paged cell: int8 KV in pages, chunked prefill, shared prefixes
PAGED_MAX_LEN = 272  # longest prompt (64 + 192) + GEN_TOKENS
PAGED_CHUNK = 64
PAGED_PREFIX = 64
PAGED_REQUESTS = 10
PAGED_SHARED = 8  # the first 80% open with the shared prefix, as the serving bench's
# bound on max|logit(kernel) - logit(plain)| in the attention replay (PERF.md,
# written before the first chip run)
DLOGIT_BOUND = 0.5
# planted wiring faults for the replay's negative control: what the attention
# layer hands the paged kernel, (tables, kv_lens) -> (tables, kv_lens)
WIRING_FAULTS = {
    "kv_lens - 1": lambda tables, kv_lens: (tables, kv_lens - 1),
    "table shifted one page": lambda tables, kv_lens: (torch.roll(tables, 1, dims=1), kv_lens),
}


def _paged_requests(cfg) -> list:
    """Ten requests arriving one step apart; the first eight open with the
    same 64-token prefix and declare it shared; bodies of 16-192 tokens."""
    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (PAGED_PREFIX,))
    body = np.random.default_rng(1)
    reqs = []
    for i in range(PAGED_REQUESTS):
        shared = i < PAGED_SHARED
        blen = int(body.integers(16, 193))
        toks = (np.concatenate([prefix, body.integers(0, cfg.vocab_size, (blen,))]) if shared
                else body.integers(0, cfg.vocab_size, (PAGED_PREFIX + blen,)))
        reqs.append(Request(rid=i, tokens=toks, max_new_tokens=GEN_TOKENS, arrival_step=i,
                            shared_prefix_len=PAGED_PREFIX if shared else 0))
    return reqs


def _paged_engine(cfg, params, policy, paged=True, **kw):
    from repro_torch.launch.serve import ContinuousBatchingEngine

    if paged:
        kw.update(page_size=PAGE, prefill_chunk=PAGED_CHUNK, share_prefixes=True)
    return ContinuousBatchingEngine(cfg, params, policy, n_slots=N_SLOTS,
                                    max_len=PAGED_MAX_LEN, device="cuda", **kw)


class _GatherCount:
    """Counts calls of the attention layer's ``_decode_gqa`` (the plain
    paged path gathers the pages and calls it; the kernel path never)."""

    def __enter__(self):
        from repro_torch.layers import attention

        self.mod, self.orig, self.calls = attention, attention._decode_gqa, 0

        def counted(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)

        attention._decode_gqa = counted
        return self

    def __exit__(self, *exc):
        self.mod._decode_gqa = self.orig


class _AttentionTap:
    """Records every paged-kernel call of the attention layer as (query,
    output); with ``fault``, the layer's tables and lengths pass through
    it on their way to the kernel (a planted wiring fault)."""

    def __init__(self, fault=None):
        self.fault = fault

    def __enter__(self):
        from repro_torch.layers import attention

        self.mod, self.orig, self.calls = attention, attention.paged_flash_attention, []

        def tapped(q, k_pool, v_pool, k_scale_pool, v_scale_pool, tables, kv_lens, **kw):
            if self.fault is not None:
                tables, kv_lens = self.fault(tables, kv_lens)
            out = self.orig(q, k_pool, v_pool, k_scale_pool, v_scale_pool, tables, kv_lens, **kw)
            self.calls.append((q, out))
            return out

        attention.paged_flash_attention = tapped
        return self

    def __exit__(self, *exc):
        self.mod.paged_flash_attention = self.orig


def _layer_errs(calls, before, after) -> list:
    """Each layer's paged-kernel output against the kernel's plain
    function on that layer's pools after the append, its block table and
    its length + 1, all read from the caches before and after the step,
    not from the call: a fault in what the layer hands the kernel shows
    here at the kernel's own tolerance. Returns [(max|err|, within), ...]."""
    from repro_torch.kernels import flash_attention as fa

    if len(calls) != len(before["layers"]):
        _die(f"attention replay: {len(calls)} paged-kernel calls in one step of "
             f"{len(before['layers'])} layers")
    errs = []
    for (q, out), blk0, blk1 in zip(calls, before["layers"], after["layers"]):
        plain = fa.paged_flash_attention_plain(
            q, blk1["k_q"], blk1["v_q"], blk1["k_scale"], blk1["v_scale"],
            blk0["block_table"], blk0["len"] + 1)
        errs.append(_attn_err(out, plain))
    return errs


def _finished(name, cfg, results, stats, n) -> None:
    if stats["failed"] or sorted(results) != list(range(n)):
        _die(f"{name}: not every request finished: {stats['failed']}")
    for rid, toks in results.items():
        if toks.shape != (GEN_TOKENS,) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            _die(f"{name}: request {rid} produced malformed tokens {toks}")


def _replay(cfg, engine) -> dict:
    """B4: four requests prefilled through the paged path (prefill chunks
    and paged_commit), then 16 decode steps, each run twice from clones of
    the same paged cache and tokens: backend "cuda" (the paged kernel) and
    "torch" (gather + _decode_gqa). The projections are bit-equal between
    the two, so only the attention differs; the trajectory follows the
    kernel's tokens. Every layer's kernel output is also held against the
    kernel's plain function on the inputs read from the cache
    (:func:`_layer_errs`), and before the first step each planted wiring
    fault must fail that check."""
    from repro_torch.launch import sampling
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import paging
    from repro_torch.models.transformer import forward

    ps = PAGE
    n_pages = N_SLOTS * (PAGED_MAX_LEN // ps) + 1
    cache = paging.paged_init_cache(cfg, N_SLOTS, PAGED_MAX_LEN, ps, n_pages, device="cuda")
    pager = paging.SlotPager(paging.PageAllocator(n_pages, ps), N_SLOTS, PAGED_MAX_LEN // ps)
    prefill = make_prefill_step(cfg, engine.policy, max_len=PAGED_MAX_LEN, backend="auto")
    first = []
    for slot, req in enumerate(_paged_requests(cfg)[:N_SLOTS]):
        scratch = None
        for a in range(0, req.tokens.size, PAGED_CHUNK):
            toks = torch.as_tensor(req.tokens[a:a + PAGED_CHUNK], device="cuda")[None, :]
            logits, scratch = prefill(engine.q_params, toks, scratch)
        table, mask = pager.assign(slot, [], pager.pages_needed(req.tokens.size + GEN_TOKENS))
        paging.paged_commit(cache, scratch, slot, table, mask, int(req.tokens.size))
        first.append(int(sampling.greedy(sampling.mask_vocab(logits, cfg.vocab_size))[0]))
    tokens = torch.tensor(first, dtype=torch.int32, device="cuda")[:, None]

    def clone(c):
        return {"step": c["step"].clone(),
                "layers": [{k: v.clone() for k, v in blk.items()} for blk in c["layers"]]}

    def kernel_step(fault=None):
        with _AttentionTap(fault) as tap:
            logits, _, after = forward(cfg, engine.q_params, {"tokens": tokens},
                                       policy=engine.policy, cache=clone(cache), backend="cuda")
        return logits[:, -1, :cfg.vocab_size].float(), after, _layer_errs(tap.calls, cache, after)

    deltas, margins, near_ties, mismatches = [], [], 0, []
    layer_err, layer_bad, faults = 0.0, [], {}
    with torch.no_grad():
        for step in range(GEN_TOKENS):
            lk, new_cache, errs = kernel_step()
            lt, _, _ = forward(cfg, engine.q_params, {"tokens": tokens}, policy=engine.policy,
                               cache=clone(cache), backend="torch")
            lt = lt[:, -1, :cfg.vocab_size].float()
            if step == 0:
                # negative control: the same step with each planted fault
                for fname, fault in WIRING_FAULTS.items():
                    lf, _, ferrs = kernel_step(fault)
                    faults[fname] = {
                        "layers_outside_tolerance": sum(not ok for _, ok in ferrs),
                        "layer_max_abs_err": max(e for e, _ in ferrs),
                        "max_abs_dlogit": float((lf - lt).abs().max()),
                    }
            layer_err = max([layer_err] + [e for e, _ in errs])
            layer_bad += [(step, layer) for layer, (_, ok) in enumerate(errs) if not ok]
            delta = float((lk - lt).abs().max())
            top = lt.topk(2, dim=-1).values
            margin = (top[:, 0] - top[:, 1]).cpu()
            tk, tt = lk.argmax(-1).cpu(), lt.argmax(-1).cpu()
            for s_ in range(N_SLOTS):
                if float(margin[s_]) > 2 * delta:
                    if int(tk[s_]) != int(tt[s_]):
                        mismatches.append((step, s_))
                else:
                    near_ties += 1
            deltas.append(delta)
            margins.append(float(margin.min()))
            cache = new_cache
            tokens = tk.to(device="cuda", dtype=torch.int32)[:, None]
    out = {"steps": GEN_TOKENS, "slots": N_SLOTS, "max_abs_dlogit": max(deltas),
           "dlogit_per_step": deltas, "dlogit_bound": DLOGIT_BOUND,
           "least_plain_top2_margin": min(margins), "near_ties": near_ties,
           "greedy_mismatches_beyond_ties": mismatches,
           "layer_checks": GEN_TOKENS * cfg.n_layers, "layer_max_abs_err": layer_err,
           "layers_outside_tolerance": layer_bad, "planted_faults": faults}
    print(json.dumps({"attention_replay": out}), flush=True)
    if layer_bad:
        _die(f"attention replay: the paged kernel's output is outside its plain function's "
             f"tolerance at (step, layer) {layer_bad}")
    missed = [f for f, r in faults.items() if not r["layers_outside_tolerance"]]
    if missed:
        _die(f"attention replay: the per-layer check did not see the planted faults {missed}")
    if max(deltas) > DLOGIT_BOUND:
        _die(f"attention replay: max|dlogit| {max(deltas)} above the bound {DLOGIT_BOUND}")
    if mismatches:
        _die(f"attention replay: greedy tokens differ at (step, slot) {mismatches} "
             f"where the plain top-2 margin exceeds 2 max|dlogit|")
    return out


def _chunked_vs_monolithic(cfg, engine) -> dict:
    """Reported, not gated: each prompt's last-token logits from a one-chunk
    plain prefill against chunks of PAGED_CHUNK tokens."""
    from repro_torch.launch.steps import make_prefill_step

    prefill = make_prefill_step(cfg, engine.policy, max_len=PAGED_MAX_LEN, backend="torch")
    unequal, worst = [], 0.0
    for req in _paged_requests(cfg):
        toks = torch.as_tensor(req.tokens, device="cuda")[None, :]
        lm, _ = prefill(engine.q_params, toks)
        scratch = None
        for a in range(0, toks.shape[1], PAGED_CHUNK):
            lc, scratch = prefill(engine.q_params, toks[:, a:a + PAGED_CHUNK], scratch)
        if not torch.equal(lm, lc):
            unequal.append([req.rid, int(toks.shape[1])])
        worst = max(worst, float((lm.float() - lc.float()).abs().max()))
    return {"prompts": PAGED_REQUESTS, "unequal_rid_len": unequal, "max_abs_dlogit": worst}


def run_paged(cfg, params) -> dict:
    """The bitplane-paged cell: B1 the kernel run (paged attention kernel,
    fused projections), B2 the plain paged run, B3 the plain dense engine
    with the same prefill chunks (B2's tokens must equal B3's), B4 the
    attention replay."""
    from repro_torch.core.precision import PrecisionPolicy

    name = "bitplane-paged"
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane")
    engine = _paged_engine(cfg, params, policy)
    engine.run(_paged_requests(cfg)[:2])  # warm-up: a registry miss and a hit
    with _GatherCount() as gathers:
        _reset_counts()
        results, stats = engine.run(_paged_requests(cfg))
        counts = _read_counts()
    _finished(name, cfg, results, stats, PAGED_REQUESTS)
    steps = stats["decode_steps"]
    pg = stats["paging"]
    others = {k: v for k, v in counts.items()
              if k not in ("fused_plane_linear", "paged_flash_attention") and v}
    if (counts["paged_flash_attention"] != LAYERS * steps or gathers.calls
            or counts["fused_plane_linear"] != stats["route_calls"].get("fused_cached", 0)
            or set(stats["route_calls"]) != {"fused_cached"} or others):
        _die(f"{name}: launches {counts}, {gathers.calls} gather-path calls, routes "
             f"{stats['route_calls']}, {steps} decode steps x {LAYERS} layers")
    if pg["shared_prefix_hits"] < 1:
        _die(f"{name}: no shared-prefix hit: {pg}")
    if pg["peak_used_pages"] >= N_SLOTS * pg["pages_per_slot"]:
        _die(f"{name}: peak pages {pg['peak_used_pages']} not below the dense reservation "
             f"{N_SLOTS * pg['pages_per_slot']}")
    profile = _profile(engine, _paged_requests(cfg), None)
    graph = _graph_line(name, engine)
    eager_engine = _paged_engine(cfg, params, policy, compile_steps=False)
    eager_engine.run(_paged_requests(cfg)[:2])
    _reset_counts()
    res_eager, st_eager = eager_engine.run(_paged_requests(cfg))
    eager_counts = _read_counts()
    del eager_engine
    gc.collect()
    _same_tokens(f"{name} graph", results, res_eager, "the eager step")
    if eager_counts != counts:
        _die(f"{name}: graph launches {counts} against the eager step's {eager_counts}")
    eager = {"tokens_equal": True, "launches_equal": True, "tok_per_s": st_eager["tok_per_s"],
             "wall_s": st_eager["wall_s"], "decode_s": st_eager["decode_s"],
             "host_ms_per_decode_step": 1e3 * st_eager["decode_s"] / st_eager["decode_steps"]}

    plain = _paged_engine(cfg, params, policy, backend="torch", compile_steps=False)
    with _GatherCount() as plain_gathers:
        _reset_counts()
        res_plain, st_plain = plain.run(_paged_requests(cfg))
        plain_counts = _read_counts()
    del plain
    _finished(f"{name} plain", cfg, res_plain, st_plain, PAGED_REQUESTS)
    if (any(plain_counts.values()) or set(st_plain["route_calls"]) != {"cached_scan"}
            or plain_gathers.calls != LAYERS * st_plain["decode_steps"]):
        _die(f"{name}: the plain paged run launched {plain_counts}, took routes "
             f"{st_plain['route_calls']}, {plain_gathers.calls} gather-path calls")
    # the dense engine with the same prefill chunks: on the card the plain
    # prefill's float32 reductions depend on a chunk's row count, so a
    # monolithic prefill is not bit-equal to a chunked one (measured below)
    dense = _paged_engine(cfg, params, policy, paged=False, backend="torch",
                          prefill_chunk=PAGED_CHUNK, compile_steps=False)
    res_dense, st_dense = dense.run(_paged_requests(cfg))
    chunking = _chunked_vs_monolithic(cfg, dense)
    del dense
    _finished(f"{name} plain dense", cfg, res_dense, st_dense, PAGED_REQUESTS)
    _same_tokens(f"{name} plain paged", res_plain, res_dense, "the plain dense engine")
    torch.cuda.empty_cache()

    replay = _replay(cfg, engine)
    del engine
    torch.cuda.empty_cache()
    # reported, not gated: the kernel's float32 probabilities against the
    # plain path's bf16 ones move near-tied greedy choices
    equal = sum(int(np.sum(results[r] == res_plain[r])) for r in results)
    diverged = [(r, int(np.argmax(results[r] != res_plain[r]))) for r in sorted(results)
                if not np.array_equal(results[r], res_plain[r])]
    out = _summary(name, cfg, results, stats, counts, "paged_flash_attention", [stats], profile)
    out.update(
        paging=pg, prefill_chunks=stats["prefill_chunks"],
        shared_prefix_hits=pg["shared_prefix_hits"],
        dense_reservation_pages=N_SLOTS * pg["pages_per_slot"],
        decode_iter_p99_ms=stats["decode_iter_p99_ms"],
        paged_kernel_launches=counts["paged_flash_attention"],
        fused_kernel_launches=counts["fused_plane_linear"], gather_path_calls=0,
        attention_device_ms_per_decode_step=(1e3 * profile["attention_kernels_s"]
                                             / profile["decode_ranges"]
                                             if profile["decode_ranges"] else None),
        plain_tok_per_s=st_plain["tok_per_s"], plain_dense_tok_per_s=st_dense["tok_per_s"],
        plain_paged_tokens_equal_plain_dense=True, chunked_vs_monolithic_prefill=chunking,
        kernel_vs_plain_equal_tokens=[equal, PAGED_REQUESTS * GEN_TOKENS],
        kernel_vs_plain_first_divergence=diverged[:1], replay=replay, graph=graph,
        eager=eager,
    )
    print(json.dumps(out), flush=True)
    return out, results


# the scrub cells: recovery under the seeded injector, 8 bits throughout (a
# flip in a plane the 4-bit tier drops would reach no ABFT check)
SEVEN_SITES = "planes@2,sign@3,occupancy@4,checksum@5,scale@6,kv@7,kv_scale@8;seed=11"
# iteration 2 admits a request (the planes flip hits its prefill), 9 comes
# after the last arrival (the sign flip hits a decode step)
RETRY_SPEC = "planes@2,sign@9;seed=11"
PAGED_KV_SPEC = "kv@10,kv_scale@20,kv@30;seed=7"
CARD = ""  # the card's name and power limit as nvidia-smi gives them (set by main)


def _tree_bytes(tree) -> int:
    from repro_torch.core import integrity

    return sum(t.numel() * t.element_size() for t in integrity._leaves(tree))


def _leaf_ptrs(tree) -> list:
    from repro_torch.core import integrity

    return [t.data_ptr() for t in integrity._leaves(tree)]


def _events(injector) -> list:
    return [dataclasses.asdict(e) for e in injector.events]


def _faulted(name, cfg, engine, injector, clean: dict, requests) -> dict:
    """Serve with ``injector``: no request may fail, the tokens must equal
    the clean run's, every leaf of the quantized tree must keep its address
    and nothing may be captured. Returns the stats."""
    ptrs = _leaf_ptrs(engine.q_params)
    results, stats = engine.run(requests(cfg), injector=injector)
    if stats["failed"] or sorted(results) != sorted(clean):
        _die(f"{name}: requests failed under faults: {stats['failed']}")
    _same_tokens(name, results, clean, "the clean run")
    if _leaf_ptrs(engine.q_params) != ptrs:
        _die(f"{name}: a scrub moved a leaf of the quantized tree")
    if stats["capture_s"] or list(engine._compiled_graphs) != [None]:
        _die(f"{name}: the faulted run captured {stats['capture_s']}, graphs "
             f"{list(engine._compiled_graphs)}")
    return stats


def _clean_gate(name, stats, checks=None) -> None:
    ig = stats["integrity"]
    alarms = {k: ig[k] for k in ("abft_alarms", "audit_alarms", "kv_alarms", "scrubs",
                                 "step_retries", "requeued")}
    if any(alarms.values()) or (checks is not None and ig["abft_checks"] != checks):
        _die(f"{name}: a clean run raised {alarms}, {ig['abft_checks']} ABFT checks "
             f"against {checks} expected")


def _host_and_busy(summary: dict) -> dict:
    return {k: summary[k] for k in ("host_ms_per_decode_step", "decode_busy_share",
                                    "device_ms_per_decode_step", "tok_per_s", "wall_s")}


def run_scrub(cfg, params, nofused8: dict, detect: dict) -> tuple[dict, dict]:
    """bitplane-scrub and bitplane-scrub-retry: the packed route with
    scrub-mode integrity, layers unrolled, 8 bits throughout. Clean, then
    the seven-site spec with an audit every iteration (every flip found at
    the top of its iteration, scrubbed before the step); then, audits off,
    the retry spec, whose flips only the ABFT checks see (a prefill chunk
    and a decode step, each put back, scrubbed and re-run), against the
    same with the eager step."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.runtime.faults import FaultInjector

    name = "bitplane-scrub"
    unrolled = dataclasses.replace(cfg, scan_layers=False)
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane", integrity="scrub")
    t0 = time.perf_counter()
    engine = _engine(unrolled, params, policy, audit_interval=1)
    load_s = time.perf_counter() - t0
    results, stats, counts = _counted_run(name, unrolled, engine, None, "plane_matmul_packed",
                                          "cached_packed", also=("fold",))
    _clean_gate(name, stats, stats["route_calls"].get("cached_packed", 0))
    _same_tokens(name, results, nofused8, "bitplane-nofused at 8 bits")
    profile = _profile(engine, _requests(unrolled), None)
    inj = FaultInjector(SEVEN_SITES)
    fstats = _faulted(name, unrolled, engine, inj, results, _requests)
    fi = fstats["integrity"]
    if len(inj.events) != 7 or inj.undetected or fi["scrubs"] < 1:
        _die(f"{name}: {len(inj.events) - len(inj.undetected)}/{len(inj.events)} detected, "
             f"{fi}")
    sizes = {"retained_source_bytes": _tree_bytes(engine._src_params),
             "quantized_tree_bytes": _tree_bytes(engine.q_params),
             "backup_bytes_per_decode_step": _tree_bytes(engine._backup)}
    out = _summary(name, unrolled, results, stats, counts, "plane_matmul_packed", [stats],
                   profile)
    out.update(card=CARD, spec=SEVEN_SITES, load_s=load_s, integrity_clean=stats["integrity"],
               integrity_faulted=fi, events=_events(inj),
               detected=[len(inj.events) - len(inj.undetected), len(inj.events)],
               scrub_s=list(engine.scrub_s), tokens_equal_nofused_8bit=True,
               tokens_equal_clean=True, leaf_addresses_kept=True, **sizes,
               detect_cell=_host_and_busy(detect))
    print(json.dumps(out), flush=True)

    name = "bitplane-scrub-retry"
    engine.audit_interval = 0
    n_scrubs = len(engine.scrub_s)
    _reset_counts()
    r_clean, s_clean = engine.run(_requests(unrolled))
    r_counts = _read_counts()
    _check_finished(name, unrolled, r_clean, s_clean)
    _clean_gate(name, s_clean, s_clean["route_calls"].get("cached_packed", 0))
    _same_tokens(name, r_clean, results, "bitplane-scrub")
    r_profile = _profile(engine, _requests(unrolled), None)
    inj = FaultInjector(RETRY_SPEC)
    rstats = _faulted(name, unrolled, engine, inj, results, _requests)
    ri = rstats["integrity"]
    if ri["step_retries"] < 2 or ri["scrubs"] < 2:
        _die(f"{name}: {ri['step_retries']} step retries, {ri['scrubs']} scrubs: {ri}")
    scrub_s = engine.scrub_s[n_scrubs:]
    captured = [str(p) for p in engine._compiled_graphs]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    eager = _engine(unrolled, params, policy, audit_interval=0, compile_steps=False)
    inj_e = FaultInjector(RETRY_SPEC)
    re_, se = eager.run(_requests(unrolled), injector=inj_e)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    _same_tokens(f"{name} eager", re_, results, "bitplane-scrub")
    if se["integrity"] != ri or _events(inj_e) != _events(inj):
        _die(f"{name}: graph {ri} {_events(inj)} against eager {se['integrity']} "
             f"{_events(inj_e)}")
    rout = _summary(name, unrolled, r_clean, s_clean, r_counts, "plane_matmul_packed",
                    [s_clean], r_profile)
    rout.update(card=CARD, spec=RETRY_SPEC, integrity_clean=s_clean["integrity"],
                integrity_faulted=ri, events=_events(inj), scrub_s=scrub_s,
                tokens_equal_clean=True, leaf_addresses_kept=True,
                captured_precisions=captured,
                eager={"tokens_equal": True, "integrity_equal": True, "events_equal": True,
                       "integrity": se["integrity"],
                       "host_ms_per_decode_step": 1e3 * se["decode_s"] / se["decode_steps"]},
                **sizes, detect_cell=_host_and_busy(detect))
    print(json.dumps(rout), flush=True)
    return out, rout


class _PageFlip:
    """The paged cells' injector: a seeded :class:`FaultInjector` (``spec``)
    plus one bit flipped on the card in a page that at least ``holders``
    committed slots map among their first ``span`` table entries (layer 0's
    block tables and lengths, read back at the top of each iteration from
    ``at`` on until the flip lands). The flip is recorded as a ``kv`` event,
    so the detection bookkeeping covers it; ``moved`` lists the pages whose
    fold it moved (it must be its page alone)."""

    def __init__(self, spec, at: int, holders: int, span: int):
        from repro_torch.runtime.faults import FaultInjector, FaultSpec

        self.base = FaultInjector(spec if spec else FaultSpec((), 0))
        self.events = self.base.events
        self.at, self.holders, self.span = at, holders, span
        self.page, self.holding, self.moved = None, [], []

    def apply(self, step, params, cache=None):
        from repro_torch.kernels import fold
        from repro_torch.runtime.faults import FaultEvent, flip_bit

        self.base.apply(step, params, cache)
        if self.page is not None or step < self.at:
            return params, cache
        blk = cache["layers"][0]
        tables, lens = blk["block_table"].cpu(), blk["len"].cpu()
        held: dict = {}
        for slot in range(tables.shape[0]):
            n = min(-(-int(lens[slot]) // PAGE), self.span)
            for pid in tables[slot, :n].tolist():
                if pid:
                    held.setdefault(pid, []).append(slot)
        cands = sorted(p for p, s in held.items() if len(s) >= self.holders)
        if cands:
            self.page, self.holding = cands[0], held[cands[0]]
            layer = len(cache["layers"]) - 1
            leaf = cache["layers"][layer]["v_q"]
            page_bytes = leaf[0].numel() * leaf.element_size()
            before = fold.page_folds(cache)[0]
            byte = self.page * page_bytes + 4321 % page_bytes
            flip_bit(leaf, byte, 3)
            self.moved = (fold.page_folds(cache)[0] != before).nonzero().flatten().tolist()
            self.events.append(FaultEvent("kv", step, f"/layers/{layer}/v_q", byte, 3, "kv"))
        return params, cache

    def mark_detected(self, category, step):
        return self.base.mark_detected(category, step)

    @property
    def undetected(self):
        return self.base.undetected


def _null_page(cache, event) -> bool:
    """Whether an event's byte lies in page 0 of its pool (the null page)."""
    blk = cache["layers"][int(event.leaf.split("/")[2])]
    leaf = blk[event.leaf.split("/")[3]]
    return event.byte < leaf[0].numel() * leaf.element_size()


class _RegistryDrops:
    """Counts the prefix-registry entries that ``drop_page`` removes."""

    def __enter__(self):
        from repro_torch.models import paging

        self.cls, self.orig, self.dropped = paging.PrefixRegistry, paging.PrefixRegistry.drop_page, 0

        def counted(registry, pid):
            n = self.orig(registry, pid)
            self.dropped += n
            return n

        self.cls.drop_page = counted
        return self

    def __exit__(self, *exc):
        self.cls.drop_page = self.orig


def run_paged_integrity(cfg, params, paged_results: dict) -> tuple[dict, dict]:
    """bitplane-paged-detect and bitplane-paged-scrub: the bitplane-paged
    workload with per-page KV checksums. Detect: a clean run with no alarm
    and bitplane-paged's tokens, then one bit flipped in a live page, which
    must raise a KV alarm and move that page's fold alone. Scrub: a clean
    run, then the seeded KV spec plus one flip in a page of the shared
    prefix while two or more slots map it: every flip outside the null page
    detected, the holders requeued, the registry entry dropped, the tokens
    of the clean run."""
    from repro_torch.core.precision import PrecisionPolicy

    out = {}
    for mode in ("detect", "scrub"):
        name = f"bitplane-paged-{mode}"
        policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane", integrity=mode)
        engine = _paged_engine(cfg, params, policy, audit_interval=1)
        engine.run(_paged_requests(cfg)[:2])  # warm-up: a registry miss and a hit
        _reset_counts()
        results, stats = engine.run(_paged_requests(cfg))
        counts = _read_counts()
        _finished(name, cfg, results, stats, PAGED_REQUESTS)
        steps = stats["decode_steps"]
        if (counts["paged_flash_attention"] != LAYERS * steps
                or counts["plane_matmul_packed"] != stats["route_calls"].get("cached_packed")
                or not counts["fold"]):
            _die(f"{name}: launches {counts}, routes {stats['route_calls']}, {steps} steps")
        _clean_gate(name, stats)
        _same_tokens(name, results, paged_results, "bitplane-paged")
        if mode == "detect":
            flip = _PageFlip(None, 12, 1, PAGED_MAX_LEN // PAGE)
        else:
            flip = _PageFlip(PAGED_KV_SPEC, 0, 2, PAGED_PREFIX // PAGE)
        with _RegistryDrops() as drops:
            fres, fstats = engine.run(_paged_requests(cfg), injector=flip)
        fi = fstats["integrity"]
        if flip.page is None or flip.moved != [flip.page]:
            _die(f"{name}: the placed flip landed in page {flip.page}, moving {flip.moved}")
        null = [e.byte for e in flip.events if _null_page(engine._cache, e)]
        missed = [dataclasses.asdict(e) for e in flip.undetected
                  if not _null_page(engine._cache, e)]
        if missed or fi["kv_alarms"] < 1:
            _die(f"{name}: undetected flips outside the null page {missed}, {fi}")
        line = {"engine": name, "card": CARD, "requests": len(results),
                "decode_steps": steps, "launches": counts, "integrity_clean": stats["integrity"],
                "integrity_faulted": fi, "events": _events(flip), "null_page_flips": null,
                "placed_flip": {"page": flip.page, "holders": flip.holding,
                                "pages_moved": flip.moved},
                "registry_entries_dropped": drops.dropped,
                "tokens_equal_bitplane_paged": True,
                "host_ms_per_decode_step": 1e3 * stats["decode_s"] / steps,
                "tok_per_s": stats["tok_per_s"]}
        if mode == "scrub":
            if fstats["failed"]:
                _die(f"{name}: requests failed under faults: {fstats['failed']}")
            _same_tokens(name, fres, results, "the clean run")
            if (fi["page_faults"] < 1 or fi["requeued"] < len(flip.holding)
                    or drops.dropped < 1):
                _die(f"{name}: {fi}, {drops.dropped} registry entries dropped, holders "
                     f"{flip.holding}")
            line["tokens_equal_clean"] = True
        print(json.dumps(line), flush=True)
        out[mode] = line
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out["detect"], out["scrub"]


# the autopilot cells: the reference test's ratio (requests arrive as fast
# as slots exist), at full width
AP_PROMPTS = (32, 64, 96, 128)
AP_REQUESTS = 16
AP_SLA = 6
AP_PREFIX = 32  # the paged cell's declared shared prefix
AP_MAX_LEN = max(AP_PROMPTS) + GEN_TOKENS  # 144: nine pages of 16
AP_POLICY = dict(sla_queue_steps=AP_SLA, degrade_patience=2, upgrade_patience=4,
                 cooldown_steps=2, shadow_frac=0.5)
W16_GEN = 8
W16_REL_BOUND = 1e-5  # of max|exact|: the float32 oracle against the float64 product
LOCK_PROMPT, LOCK_BATCH = 64, 4


def _ap_requests(cfg, shared: bool) -> list:
    """16 requests, prompts of 32/64/96/128 tokens in turn, 4 arriving per
    decode step from step 0, 16 new tokens; ``shared``: every prompt opens
    with one 32-token prefix, declared."""
    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, (AP_PREFIX,))
    out = []
    for i in range(AP_REQUESTS):
        s = AP_PROMPTS[i % len(AP_PROMPTS)]
        body = rng.integers(0, cfg.vocab_size, (s,))
        toks = np.concatenate([prefix, body[AP_PREFIX:]]) if shared else body
        out.append(Request(rid=i, tokens=toks, max_new_tokens=GEN_TOKENS,
                           arrival_step=i // N_SLOTS,
                           shared_prefix_len=AP_PREFIX if shared else 0))
    return out


def _decode_range_device_ms(engine, run) -> tuple[dict, list, dict]:
    """``run()`` under ``torch.profiler``: its stats, the device ms of each
    ``serve.decode_step`` range in order, and the device seconds in all and
    inside the decode ranges."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        stats = run()
        torch.cuda.synchronize()
    ranges, device = [], []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            if evt.name == "serve.decode_step":
                ranges.append((evt.time_range.start, evt.time_range.end))
        elif evt.name not in ("serve.decode_step", "serve.prefill"):
            device.append((evt.time_range.start, evt.time_range.end - evt.time_range.start))
    ranges.sort()
    per = [sum(us for start, us in device if lo <= start < hi) / 1e3 for lo, hi in ranges]
    return stats, per, {"device_busy_s": sum(us for _, us in device) / 1e6,
                        "decode_device_s": sum(per) / 1e3}


def _split_steps(values, passes) -> dict:
    """Mean of ``values`` over single-tier and over mixed-tier decode steps."""
    out = {}
    for kind, keep in (("single_tier", lambda n: n == 1), ("mixed_tier", lambda n: n > 1)):
        vals = [v for v, n in zip(values, passes) if keep(n)]
        out[kind] = {"steps": len(vals), "mean": (sum(vals) / len(vals)) if vals else None}
    return out


def run_autopilot(cfg, params, paged: bool) -> dict:
    """bitplane-autopilot / bitplane-paged-autopilot: the SLA autopilot
    (queue SLA 6 steps, patience 2 down / 4 up, cooldown 2, shadow probes on
    half the decode steps) over an overload ramp, its decode steps replayed
    from one graph per tier (a mixed-tier step: one replay per tier present,
    merged in place). Gates: at least two tiers admitted and two in the
    per-tier token counts; every finished request equal to a static run of
    its admission tier; requests shed, all at the lowest tier; the
    autopilot's p99 queue wait within the SLA where the static 8-bit run's
    exceeds it; shadow probes with a finite KL; the eager control
    (``compile_steps=False``) equal in tokens, switches and shed set."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.runtime.autopilot import AutopilotPolicy

    name = "bitplane-paged-autopilot" if paged else "bitplane-autopilot"
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane")
    # prefill in chunks of 64, one chunk per iteration, in both cells: with
    # whole-prompt admission the four slots fill at step 0 and free at step
    # 16, while the shedding ladder (a 16-step service estimate against the
    # 6-step SLA) empties the queue at step 5, so one tier alone would ever
    # be admitted
    kw = dict(prefill_chunk=PAGED_CHUNK)
    if paged:
        kw.update(page_size=PAGE, share_prefixes=True)

    def requests():
        return _ap_requests(cfg, shared=paged)

    def build(**extra):
        from repro_torch.launch.serve import ContinuousBatchingEngine

        return ContinuousBatchingEngine(cfg, params, policy, n_slots=N_SLOTS,
                                        max_len=AP_MAX_LEN, device="cuda", **kw, **extra)

    engine = build(autopilot=AutopilotPolicy(**AP_POLICY))
    engine.run(requests())  # captures each tier's decode graph and the probe's
    _reset_counts()
    results, stats = engine.run(requests())
    counts = _read_counts()
    apst = stats["autopilot"]
    if stats["capture_s"]:
        _die(f"{name}: the counted run captured {stats['capture_s']}")
    calls = stats["route_calls"].get("fused_cached", 0)
    if not calls or counts["fused_plane_linear"] != calls or (
            paged and not counts["paged_flash_attention"]):
        _die(f"{name}: launches {counts} against {calls} fused_cached calls")
    prof_stats, per_step_ms, prof = _decode_range_device_ms(
        engine, lambda: engine.run(requests())[1])
    capture_s = {str(k): v for k, v in engine.capture_s.items()}
    for prec, secs in capture_s.items():
        print(json.dumps({"engine": name, "graph": prec, "capture_s": secs}), flush=True)
    state_bytes = {k: _tree_bytes(getattr(engine, k)) for k in ("_backup", "_merge")}
    del engine
    gc.collect()
    eager = build(autopilot=AutopilotPolicy(**AP_POLICY), compile_steps=False)
    res_e, st_e = eager.run(requests())
    del eager
    gc.collect()
    if sorted(results) != sorted(res_e) or apst["switches"] != st_e["autopilot"]["switches"] \
            or stats["failed"] != st_e["failed"]:
        _die(f"{name}: graph and eager runs differ in requests, switches or shed set")
    _same_tokens(f"{name} graph", results, res_e, "the eager control")

    tiers = apst["request_tiers"]
    if len(set(tiers.values())) < 2 or len(apst["tier_tokens"]) < 2:
        _die(f"{name}: fewer than two tiers admitted: {tiers}, {apst['tier_tokens']}")
    static = build()
    static_p99 = {}
    for tier in sorted(set(tiers.values())):
        w = int(tier.split("a")[0][1:])
        static.set_precision(None if w == 8 else w)
        ref, st = static.run(requests())
        static_p99[tier] = st["p99_queue_steps"]
        mine = {rid: results[rid] for rid, t in tiers.items() if t == tier and rid in results}
        _same_tokens(f"{name} tier {tier}", mine, ref, f"the static run at {tier}")
    if "w8a8" not in static_p99:
        static.set_precision(None)
        static_p99["w8a8"] = static.run(requests())[1]["p99_queue_steps"]
    del static
    gc.collect()
    torch.cuda.empty_cache()
    lowest = min(w for _, w in apst["tiers"])
    shed = [r for r in stats["failed"].values() if r.startswith("overload:")]
    if not apst["shed"] or len(shed) != apst["shed"] or not all(
            f"tier w{lowest}" in r for r in shed):
        _die(f"{name}: shedding {apst['shed']} with reasons {shed}")
    if not (apst["p99_queue_steps"] <= AP_SLA < static_p99["w8a8"]):
        _die(f"{name}: p99 queue steps {apst['p99_queue_steps']} against the static 8-bit "
             f"run's {static_p99['w8a8']} (SLA {AP_SLA})")
    kl = apst["shadow_kl_ewma"]
    if not apst["shadow_probes"] or kl is None or not np.isfinite(kl):
        _die(f"{name}: shadow probes {apst['shadow_probes']}, KL {kl}")
    passes = prof_stats["autopilot"]["step_passes"]
    if len(per_step_ms) != len(passes):
        _die(f"{name}: {len(per_step_ms)} decode ranges against {len(passes)} decode steps")
    out = {
        "engine": name, "card": CARD, "layers": cfg.n_layers, "requests": AP_REQUESTS,
        "finished": len(results), "shed": apst["shed"], "tiers": apst["tiers"],
        "switches": apst["switches"], "request_tiers": tiers, "tier_tokens": apst["tier_tokens"],
        "mixed_steps": apst["mixed_steps"], "decode_steps": stats["decode_steps"],
        "p99_queue_steps": apst["p99_queue_steps"], "static_p99_queue_steps": static_p99,
        "shadow_probes": apst["shadow_probes"], "shadow_kl_ewma": kl,
        "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
        "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
        "launches": counts, "route_calls": stats["route_calls"],
        "host_ms_per_decode_step": _split_steps(apst["step_host_ms"], apst["step_passes"]),
        "device_ms_per_decode_step": _split_steps(per_step_ms, passes),
        "decode_busy_share": prof["decode_device_s"] / prof_stats["decode_s"],
        "capture_s": capture_s, "state_bytes": state_bytes,
        "tokens_equal_static_tier": True, "eager_equal": True,
    }
    if paged:
        out["paging"] = stats["paging"]
    print(json.dumps(out), flush=True)
    # phase 19's control (not printed): the tokens and the shed set
    out.update(tokens=results, failed=stats["failed"],
               host_ms_per_decode_step=out["host_ms_per_decode_step"])
    return out


def check_oracle16(summary: dict) -> list:
    """The 16-bit digit-level oracle (float32 accumulation, the reference's
    route beyond 8 bits) at each main-path shape, M = 4 and 256, against
    the float64 product of the same int32 operands: within
    ``W16_REL_BOUND`` of max|exact|. Times one call (CUDA events) beside the
    float64 product's."""
    from repro_torch.core import bitserial

    lines = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    for name, k, n, _ in GRANITE_SHAPES:
        w = torch.randint(-(1 << 15), 1 << 15, (k, n), generator=gen, device="cuda",
                          dtype=torch.int32)
        for m in ROWS:
            a = torch.randint(-(1 << 15), 1 << 15, (m, k), generator=gen, device="cuda",
                              dtype=torch.int32)

            def oracle():
                return bitserial.bitserial_matmul(a, w, a_bits=16, w_bits=16, level="digit",
                                                  accum_dtype=torch.float32)

            got = oracle()
            exact = a.double() @ w.double()
            rel = float((got.double() - exact).abs().max() / exact.abs().max())
            line = {"check": "oracle16", "shape": name, "M": m, "K": k, "N": n,
                    "rel_err_of_max": rel, "bound": W16_REL_BOUND,
                    "ms": _time_ms(oracle, reps=3, warmup=1),
                    "float64_ms": _time_ms(lambda: a.double() @ w.double(), reps=3, warmup=1)}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if not rel <= W16_REL_BOUND:
                _die(f"oracle16 {name} M={m}: {rel:.3g} of max|exact| against {W16_REL_BOUND}")
            del got, exact
        del w
        torch.cuda.empty_cache()
    summary["oracle16"] = lines
    return lines


def _prefill_logits(cfg, tree, policy, prompts) -> list:
    from repro_torch.launch.steps import make_prefill_step

    step = make_prefill_step(cfg, policy)
    return [step(tree, torch.as_tensor(p, device="cuda")[None])[0].float() for p in prompts]


def run_digit16(cfg, params, summary: dict) -> dict:
    """digit-w16: --bits 16 --level digit, the paper's widest setting,
    through the float32-accumulated oracle route (the weight decomposed on
    every call). Gates: the oracle within its bound at every main-path
    shape; the graph run's tokens equal the eager control's; the 16-bit
    prefill logits closer to the unquantized model's (max|dlogit| over the
    four prompts) than the 8-bit digit model's."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.models.quant import quantize_params
    from repro_torch.runtime.scheduler import Request

    name = "digit-w16"
    check_oracle16(summary)
    policy = PrecisionPolicy.uniform(16, 16, variant="booth", level="digit")

    def requests():
        rng = np.random.default_rng(0)
        return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, (s,)),
                        max_new_tokens=W16_GEN, arrival_step=STAGGER * i)
                for i, s in enumerate(PROMPT_LENS)]

    engine = _engine(cfg, params, policy)
    engine.run(requests())
    _reset_counts()
    results, stats = engine.run(requests())
    counts = _read_counts()
    if stats["capture_s"] or set(stats["route_calls"]) != {"oracle"}:
        _die(f"{name}: captured {stats['capture_s']} or took routes {stats['route_calls']}")
    if any(stats["failed"]) or sorted(results) != list(range(len(PROMPT_LENS))):
        _die(f"{name}: not every request finished: {stats['failed']}")
    profile = _profile(engine, requests(), None)
    prompts = [r.tokens for r in requests()]
    logits16 = _prefill_logits(cfg, engine.q_params, policy, prompts)
    capture_s = {str(k): v for k, v in engine.capture_s.items()}
    q_bytes = _tree_bytes(engine.q_params)
    del engine
    gc.collect()
    eager = _engine(cfg, params, policy, compile_steps=False)
    res_e, _ = eager.run(requests())
    del eager
    gc.collect()
    _same_tokens(name, results, res_e, "the eager control")
    dense = _prefill_logits(cfg, params, PrecisionPolicy.off(), prompts)
    pol8 = PrecisionPolicy.uniform(8, 8, variant="booth", level="digit")
    q8 = quantize_params(params, pol8, cfg=cfg, plane_cache=True)
    logits8 = _prefill_logits(cfg, q8, pol8, prompts)
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    d16 = max(float((a - b).abs().max()) for a, b in zip(logits16, dense))
    d8 = max(float((a - b).abs().max()) for a, b in zip(logits8, dense))
    if not d16 < d8:
        _die(f"{name}: 16-bit max|dlogit| {d16} not below the 8-bit run's {d8}")
    out = {
        "engine": name, "card": CARD, "layers": cfg.n_layers, "requests": len(results),
        "tokens": stats["decoded_tokens"] + stats["admitted"], "tok_per_s": stats["tok_per_s"],
        "wall_s": stats["wall_s"], "prefill_s": stats["prefill_s"],
        "decode_s": stats["decode_s"], "decode_steps": stats["decode_steps"],
        "route_calls": stats["route_calls"], "launches": counts,
        "host_ms_per_decode_step": 1e3 * stats["decode_s"] / stats["decode_steps"],
        "device_ms_per_decode_step": (1e3 * profile["decode_device_s"] / profile["decode_ranges"]
                                      if profile["decode_ranges"] else None),
        "decode_busy_share": profile["decode_device_s"] / stats["decode_s"],
        "prefill_busy_share": profile["prefill_device_s"] / stats["prefill_s"],
        "max_abs_dlogit_vs_unquantized": {"w16": d16, "w8": d8},
        "capture_s": capture_s, "quantized_tree_bytes": q_bytes, "eager_equal": True,
        "tf32": {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "float32_matmul_precision": torch.get_float32_matmul_precision()},
    }
    print(json.dumps(out), flush=True)
    return out


def run_lockstep(cfg, params) -> dict:
    """lockstep: ``Engine.generate`` on 4 prompts of 64 tokens, 16 new
    tokens, 8 bits at bitplane level, its decode steps replayed from graphs.
    Gates: the eager control's tokens; with bf16 KV the continuous-batching
    engine's tokens for the same 4 requests arriving at step 0 (the same
    batch); under detect, one flipped weight bit raises ``last_alarms``."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import ContinuousBatchingEngine, Engine
    from repro_torch.runtime.scheduler import Request

    name = "lockstep"
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (LOCK_BATCH, LOCK_PROMPT))
    max_len = LOCK_PROMPT + GEN_TOKENS
    graph = Engine(cfg, params, policy, max_len=max_len, device="cuda")
    graph.generate(prompts, GEN_TOKENS)  # captures the decode graph
    _reset_counts()
    toks, tps = graph.generate(prompts, GEN_TOKENS)
    counts = _read_counts()
    runs = [tps] + [graph.generate(prompts, GEN_TOKENS)[1] for _ in range(2)]
    capture_s = {str(k): v for k, v in graph.capture_s.items()}
    del graph
    gc.collect()
    eager = Engine(cfg, params, policy, max_len=max_len, device="cuda", compile_steps=False)
    toks_e, tps_e = eager.generate(prompts, GEN_TOKENS)
    del eager
    gc.collect()
    if not torch.equal(toks, toks_e):
        _die(f"{name}: graph tokens differ from the eager control's")
    cb = ContinuousBatchingEngine(cfg, params, policy, n_slots=LOCK_BATCH, max_len=max_len,
                                  kv_quant=False, device="cuda")
    res, _ = cb.run([Request(rid=i, tokens=p, max_new_tokens=GEN_TOKENS)
                     for i, p in enumerate(prompts)])
    del cb
    gc.collect()
    _same_tokens(name, {i: toks[i].cpu().numpy() for i in range(LOCK_BATCH)}, res,
                 "continuous batching with bf16 KV")
    det = Engine(cfg, params, PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane",
                                                      integrity="detect"),
                 max_len=max_len, device="cuda")
    det.generate(prompts, GEN_TOKENS)
    clean_alarms = det.last_alarms
    _flip_weight_bit(det)
    det.generate(prompts, GEN_TOKENS)
    flipped_alarms = det.last_alarms
    del det
    gc.collect()
    torch.cuda.empty_cache()
    if clean_alarms or flipped_alarms < 1:
        _die(f"{name}: detect alarms {clean_alarms} clean, {flipped_alarms} flipped")
    out = {
        "engine": name, "card": CARD, "layers": cfg.n_layers, "batch": LOCK_BATCH,
        "prompt_len": LOCK_PROMPT, "new_tokens": GEN_TOKENS,
        "decode_tok_per_s": runs, "eager_decode_tok_per_s": tps_e,
        "host_ms_per_decode_step": [1e3 * LOCK_BATCH / t for t in runs],
        "eager_host_ms_per_decode_step": 1e3 * LOCK_BATCH / tps_e,
        "launches": counts, "capture_s": capture_s, "eager_equal": True,
        "cb_bf16_equal": True, "detect_alarms": {"clean": clean_alarms, "flipped": flipped_alarms},
    }
    print(json.dumps(out), flush=True)
    return out


# the SSM and hybrid families (phases 14-16): full width, depth per FAMILY_LAYERS
FAMILY_SCHEDULE = {8: 4}
# max|dlogit| of the kernel route against the plain route (backend="torch")
# on the same quantized tree, every prefill and the first 4 decode steps:
# the projections are bit-equal and the rest is the same code, so 0 is
# expected; 0.05 is about one bf16 step at |logit| in [4, 8)
FAMILY_DLOGIT_TOL = 0.05
FAMILY_PARITY_STEPS = 4
WINDOW_PROMPTS = (2040, 64, 128, 256)
WINDOW_GEN = 24
# the long request's decode logits against a cache-free forward over the
# same tokens: _decode_gqa rounds its softmax weights to bf16 (the
# reference's order), _local_gqa keeps them in float32, and each projection
# requantizes its input to int8, so a rounding difference grows with depth
# (the check is repeated with float32 weights and reported beside it). At
# the cell's 8 layers an NVIDIA H100 80GB HBM3 at 700 W read 0.1875-0.2412
# on both sides of the wrap (seeded: the same in every run). One evicted
# key of 2048 moves a logit less, so the exact check of the ring's rows
# carries the alignment, and this bounds the noise
WINDOW_DLOGIT_TOL = 0.3
WINDOW_WRAP_RATIO = 1.25  # after the wrap, at most this times the largest error before it
# the MoE layer's parts (phase 17)
MOE_OPS = ("moe.route", "moe.dispatch", "moe.expert_quant", "moe.expert_mm", "moe.combine")
FAMILY_OPS = ("family.ssd", "family.rglru", "family.conv", "family.ring_attention",
              "family.tied_head") + MOE_OPS
LEVEL_KERNELS = {"bitplane": ("fused_plane_linear", "fused_cached"),
                 "digit": ("plane_matmul", "cached_planes"),
                 "detect": ("plane_matmul_packed", "cached_packed")}


def _window_requests(cfg) -> list:
    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(0)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, (s,)),
                    max_new_tokens=WINDOW_GEN, arrival_step=STAGGER * i)
            for i, s in enumerate(WINDOW_PROMPTS)]


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0))


FAMILY_OPS_STEPS = 4  # decode steps of the profiled eager run
# depth of each family's cells (full: 48 and 26 = 8 periods + a 2-layer tail).
# Cut for the smoke's 1200 s, never the width (PERF.md, section 4): the
# mamba2 cells 8, the rgemma cells one (rec, rec, attn) period and the
# 2-layer tail (the examples phase took the time of 8 more mamba2 layers and
# of three rgemma layers in each cell)
FAMILY_LAYERS = {"mamba2-bitplane": 8, "mamba2-digit": 8, "mamba2-detect": 8,
                 "rgemma-bitplane": 5, "rgemma-window": 5}


def _family_ops(engine, reqs, schedule) -> dict:
    """The workload's first request alone, ``FAMILY_OPS_STEPS`` decode steps
    of the eager step (every slot decodes at every step) under
    ``torch.profiler``: the device time per decode step of the families'
    own operators (the ``family.*`` ranges: the SSD or RG-LRU step, the
    causal conv, the ring attention, the tied head; the kernels their ops
    launch) inside the ``serve.decode_step`` ranges, apart from the
    projections. A short run: the profiler's host-side cost grows with
    every op of every layer it records."""
    cpu = torch.autograd.DeviceType.CPU
    engine.set_precision(None)
    req = dataclasses.replace(reqs[0], max_new_tokens=FAMILY_OPS_STEPS + 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, stats = engine.run([req], precision_schedule=schedule)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == cpu]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "serve.decode_step"]
    total = {name: 0.0 for name in FAMILY_OPS}
    for e in events:
        if e.name in total and any(lo <= e.time_range.start < hi for lo, hi in spans):
            total[e.name] += _device_us(e)
    steps = max(stats["decode_steps"], 1)
    return {name: us / 1e3 / steps for name, us in total.items() if us}


def _logit_parity(cfg, q_params, policy, prompts, max_len) -> dict:
    """The kernel route against the plain route on the card, on one
    quantized tree: each prompt's prefill (batch 1, int8 KV committed as
    the engine commits it) and its first ``FAMILY_PARITY_STEPS`` greedy
    decode steps (the plain route's token fed to both). Returns the
    largest max|dlogit| of the prefills and of the decode steps."""
    from repro_torch.launch import sampling
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    steps = {be: (make_prefill_step(cfg, policy, max_len=max_len, kv_quant=True, backend=be),
                  make_decode_step(cfg, policy, backend=be)) for be in ("auto", "torch")}
    worst = {"prefill": 0.0, "decode": 0.0}
    for p in prompts:
        toks = torch.as_tensor(p, device="cuda", dtype=torch.int32)[None]
        out = {be: fns[0](q_params, toks) for be, fns in steps.items()}
        worst["prefill"] = max(worst["prefill"],
                               float((out["auto"][0] - out["torch"][0]).abs().max()))
        for _ in range(FAMILY_PARITY_STEPS):
            tok = sampling.greedy(sampling.mask_vocab(out["torch"][0], cfg.vocab_size))
            tok = tok.to(torch.int32)[:, None]
            out = {be: fns[1](q_params, out[be][1], tok) for be, fns in steps.items()}
            worst["decode"] = max(worst["decode"],
                                  float((out["auto"][0] - out["torch"][0]).abs().max()))
        del out
    torch.cuda.empty_cache()
    return worst


class _StateFlip:
    """The mamba2-detect cell's upset: at engine iteration ``at``, one bit of
    the float32 SSM state of the first live slot (a nonzero length) in
    layer ``layer``, flipped on the card; ``moved`` lists the slots whose
    fold (the fold kernel) it moved, which must be that slot alone. The
    flip is recorded as a ``kv`` event of an empty-spec injector, whose
    bookkeeping the engine's KV check marks."""

    def __init__(self, at: int, layer: int):
        from repro_torch.runtime.faults import FaultInjector, FaultSpec

        self.base = FaultInjector(FaultSpec((), 0))
        self.events = self.base.events
        self.at, self.layer, self.slot, self.moved = at, layer, None, []

    def apply(self, step, params, cache=None):
        from repro_torch.kernels import fold
        from repro_torch.runtime.faults import FaultEvent, flip_bit

        if step != self.at:
            return params, cache
        blk = cache["layers"][self.layer]
        self.slot = next(i for i, n in enumerate(blk["len"].tolist()) if n > 0)
        leaf = blk["state"]
        per_slot = leaf[0].numel() * leaf.element_size()
        byte = self.slot * per_slot + 4321 % per_slot
        before = fold.slot_folds(cache)
        flip_bit(leaf, byte, 6)
        self.moved = (fold.slot_folds(cache) != before).nonzero().flatten().tolist()
        self.events.append(FaultEvent("kv", step, f"/layers/{self.layer}/state", byte, 6, "kv"))
        return params, cache

    def mark_detected(self, category, step):
        return self.base.mark_detected(category, step)

    @property
    def undetected(self):
        return self.base.undetected


def _flip_first_weight_bit(engine) -> None:
    """Flip one bit of the first packed weight word of layer 0, on the card."""
    from repro_torch.core import bitplanes as bp

    def first(node):
        if isinstance(node, bp.WeightPlanes):
            return node
        for v in (node.values() if isinstance(node, dict) else []):
            got = first(v)
            if got is not None:
                return got
        return None

    first(engine.q_params["layers"][0]).packed.mag.view(-1)[7] ^= 1 << 5


def _family_detect(name, cfg, params, engine, reqs, results) -> dict:
    """mamba2-detect's gates on top of the counted clean run: no alarm and
    one ABFT check per projection call; the fold kernel bit-equal to the
    plain per-slot folds on the cache with its float32 state; one flipped
    bit in a live slot's SSM state raises a KV alarm on that slot alone;
    one flipped weight bit raises at least one ABFT and one audit alarm."""
    from repro_torch.kernels import fold
    from repro_torch.models.cache import cache_slot_checksums

    cache = engine._cache
    kernel_folds, plain_folds = fold.slot_folds(cache), cache_slot_checksums(cache)
    fold_equal = bool(torch.equal(kernel_folds, plain_folds))
    state_bytes = sum(b["state"].numel() * 4 for b in cache["layers"])
    engine.set_precision(None)
    flip = _StateFlip(at=3, layer=cfg.n_layers // 2)
    _, sstats = engine.run(reqs(cfg), precision_schedule=FAMILY_SCHEDULE, injector=flip)
    state_integ = sstats["integrity"]
    _flip_first_weight_bit(engine)
    engine.set_precision(None)
    _, wstats = engine.run(reqs(cfg), precision_schedule=FAMILY_SCHEDULE)
    weight_integ = wstats["integrity"]
    out = {"fold_kernel_equal_plain": fold_equal, "state_bytes": state_bytes,
           "state_flip_slot": flip.slot, "state_flip_moved_slots": flip.moved,
           "integrity_state_flip": state_integ, "integrity_weight_flip": weight_integ,
           "state_flip_detected": not flip.undetected}
    if not fold_equal:
        _die(f"{name}: the fold kernel differs from the plain folds on the SSM state")
    if flip.moved != [flip.slot] or state_integ["kv_alarms"] < 1 or flip.undetected:
        _die(f"{name}: a flipped state bit in slot {flip.slot} moved slots {flip.moved}, "
             f"integrity {state_integ}")
    if weight_integ["abft_alarms"] < 1 or weight_integ["audit_alarms"] < 1:
        _die(f"{name}: a flipped weight bit went undetected: {weight_integ}")
    return out


def _decode_gqa_f32_weights(q, k_cache, v_cache, valid, k_scale=None, v_scale=None):
    """``layers.attention._decode_gqa`` with its softmax weights kept in
    float32 for the value product, as ``_local_gqa`` keeps them: the one
    rounding the two differ by (bf16 ring, no scales)."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    qf = q.reshape(b, hkv, hq // hkv, d).to(torch.float32)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.to(torch.float32)) * (d**-0.5)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(torch.float32)) / torch.clamp_min(l, 1e-30)
    return out.reshape(b, 1, hq, d)


def _window_check(cfg, q_params, policy) -> dict:
    """The long request of rgemma-window (prompt 2040, 24 decode tokens, a
    2048-row ring that wraps at its 9th decode token) on the kernel route
    with a bf16 ring. Exact: after the decodes, every windowed layer's ring
    holds the prefill's rows 16..2039 unchanged and new rows 2040..2047 and
    0..15 (the decodes wrote ``pos % 2048``, evicting positions 0..15).
    Logits: each decode step's against a cache-free forward over the same
    tokens on the plain route (its logits at every decode position, from
    one causal forward), every step within ``WINDOW_DLOGIT_TOL`` and the
    steps after the wrap within ``WINDOW_WRAP_RATIO`` of the largest before
    it. The same tokens decoded again with the softmax weights kept in
    float32 (``_decode_gqa_f32_weights``) give the witness line
    ``max_abs_dlogit_f32_weights``: what is left of the gap without their
    bf16 rounding (reported, not gated)."""
    from repro_torch.launch import sampling
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.layers import attention
    from repro_torch.models.transformer import forward

    prompt, n = WINDOW_PROMPTS[0], WINDOW_GEN
    rows = min(cfg.local_window, prompt + n)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, prompt)),
                           device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg, policy, max_len=prompt + n)
    decode = make_decode_step(cfg, policy)
    logits, cache = prefill(q_params, toks)
    rings = [i for i, k in enumerate(cfg.layer_kinds()) if k == "attn"]
    before = {i: cache["layers"][i]["k"][0].clone() for i in rings}
    seq, steps = [toks], []
    for i in range(n):
        tok = sampling.greedy(sampling.mask_vocab(logits, cfg.vocab_size)).to(torch.int32)[:, None]
        seq.append(tok)
        logits, cache = decode(q_params, cache, tok)
        steps.append(logits[0].float())
    wrote = (list(range(prompt, rows)) + list(range(prompt + n - rows)))
    kept = [r for r in range(rows) if r not in set(wrote)]
    ring_ok = all(
        torch.equal(cache["layers"][i]["k"][0][kept], before[i][kept])
        and all(not torch.equal(cache["layers"][i]["k"][0][r], before[i][r]) for r in wrote)
        and int(cache["layers"][i]["len"][0]) == prompt + n
        for i in rings)
    del cache, before
    full = torch.cat(seq, dim=1)  # prompt + n tokens; the last n logits are the decodes'
    with torch.no_grad():
        free, _, _ = forward(cfg, q_params, {"tokens": full}, policy=policy, backend="torch",
                             last_only=n)
    errs = [float((s - f.float()).abs().max()) for s, f in zip(steps, free[0])]
    plain_decode, attention._decode_gqa = attention._decode_gqa, _decode_gqa_f32_weights
    try:
        errs32 = []
        logits, cache = prefill(q_params, toks)
        for tok, f in zip(seq[1:], free[0]):
            logits, cache = decode(q_params, cache, tok)
            errs32.append(float((logits[0].float() - f.float()).abs().max()))
    finally:
        attention._decode_gqa = plain_decode
    del free, cache
    torch.cuda.empty_cache()
    wrap = rows - prompt  # the decode step whose write evicts the first row
    out = {"prompt": prompt, "ring_rows": rows, "windowed_layers": len(rings),
           "wraps_at_decode_token": wrap + 1, "rows_written": [wrote[0], wrote[-1]],
           "ring_rows_exact": ring_ok, "max_abs_dlogit_per_step": errs,
           "max_abs_dlogit_before_wrap": max(errs[:wrap]),
           "max_abs_dlogit_after_wrap": max(errs[wrap:]), "tolerance": WINDOW_DLOGIT_TOL,
           "max_abs_dlogit_f32_weights": max(errs32), "dlogit_f32_weights_per_step": errs32,
           "wrap_ratio_bound": WINDOW_WRAP_RATIO}
    if not ring_ok or max(errs) > WINDOW_DLOGIT_TOL or \
            max(errs[wrap:]) > WINDOW_WRAP_RATIO * max(errs[:wrap]):
        _die(f"rgemma-window: the ring after the wrap: {out}")
    return out


def run_family(name, cfg, params, mode, reqs=_requests, schedule=FAMILY_SCHEDULE,
               max_len=None, keep_dense=()) -> dict:
    """One cell of the SSM / hybrid families at full width: the graph
    engine's counted run (every projection through the route's kernel)
    and a profiled replay; the eager twin (tokens and launches
    equal) and its device time per decode step of the families' own
    operators; the plain route on the card (``backend="torch"``): tokens
    equal, and ``_logit_parity`` within ``FAMILY_DLOGIT_TOL``. ``mode``:
    bitplane, digit or detect (the packed route, layers unrolled, an audit
    every iteration; plus ``_family_detect``). ``keep_dense``: the policy's
    dense layers (an MoE model's router). An MoE cell also counts the eager
    twin's dropped expert copies, of which decode must drop at least one
    (free slots compete for capacity)."""
    from repro_torch.core.precision import PrecisionPolicy

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    phases: dict = {}

    def lap(phase):
        phases[phase] = time.perf_counter() - t0 - sum(phases.values())

    kernel, route = LEVEL_KERNELS[mode]
    detect = mode == "detect"
    level = "digit" if mode == "digit" else "bitplane"
    if detect:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    schedule = None if level == "digit" else schedule
    kw = {"max_len": max_len} if max_len else {}
    pol = dict(variant="booth", level=level, keep_dense=keep_dense)
    if detect:
        pol.update(fuse_epilogue=False, integrity="detect")
        kw["audit_interval"] = 1
    policy = PrecisionPolicy.uniform(8, 8, **pol)
    also = ("fold",) if detect else ()
    engine = _engine(cfg, params, policy, **kw)
    lap("load")
    results, stats, counts = _counted_run(name, cfg, engine, schedule, kernel, route, also, reqs)
    lap("counted")
    extra = {}
    if detect:
        clean = stats["integrity"]
        if (clean["abft_alarms"], clean["audit_alarms"], clean["kv_alarms"]) != (0, 0, 0) or \
                clean["abft_checks"] != stats["route_calls"].get(route, 0):
            _die(f"{name}: clean-run integrity {clean} against {stats['route_calls']}")
        extra["integrity_clean"] = clean
    graph = _graph_line(name, engine)
    lap("graph_replay")
    prompts = [r.tokens for r in reqs(cfg)]
    parity = _logit_parity(cfg, engine.q_params, policy, prompts, engine.max_len)
    lap("logit_parity")
    if max(parity.values()) > FAMILY_DLOGIT_TOL:
        _die(f"{name}: kernel route against the plain route: max|dlogit| {parity}")
    if name == "rgemma-window":
        extra["ring"] = _window_check(cfg, engine.q_params, policy)
        lap("ring_check")
    if detect:  # last: it flips bits in the engine's state and weights
        extra.update(_family_detect(name, cfg, params, engine, reqs, results))
        lap("flips")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    eager = _eager_twin(name, cfg, params, policy, schedule, kernel, route, results, counts,
                        also, reqs, family_ops=True, **kw)
    lap("eager_twin")
    if cfg.family == "moe" and eager["moe_dropped_copies"]["decode"]["dropped"] < 1:
        _die(f"{name}: no expert copy was dropped at decode: {eager['moe_dropped_copies']}")
    plain = _engine(cfg, params, policy, backend="torch", compile_steps=False, **kw)
    _reset_counts()
    res_plain, stats_plain = plain.run(reqs(cfg), precision_schedule=schedule)
    plain_counts = _read_counts()
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    # the plain route launches no kernel but the fold (detect's audits on the card)
    if any(v for k, v in plain_counts.items() if k != "fold") or \
            set(stats_plain["route_calls"]) != {"cached_scan"}:
        _die(f"{name}: the plain run launched kernels {plain_counts} or took routes "
             f"{stats_plain['route_calls']}")
    _same_tokens(name, results, res_plain, "the plain route")
    lap("plain_run")
    host_ms = 1e3 * stats["decode_s"] / stats["decode_steps"]
    out = {
        "engine": name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "requests": len(results), "tokens": stats["decoded_tokens"] + stats["admitted"],
        "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
        "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
        "decode_steps": stats["decode_steps"], "launches": counts[kernel],
        "all_launches": counts, "route_calls": stats["route_calls"],
        "precision_switches": stats["precision_switches"],
        "host_ms_per_decode_step": host_ms,
        # the device time of one replay of the storage-width graph (CUDA
        # events), over the counted run's host time per decode step
        "device_ms_per_decode_step": graph["replay_device_ms"],
        "decode_busy_share": graph["replay_device_ms"] / host_ms,
    }
    ops = eager.get("family_ops_device_ms_per_decode_step") or {}
    out.update(card=CARD, family=cfg.family, prompts=[len(p) for p in prompts],
               new_tokens=reqs(cfg)[0].max_new_tokens, phases_s=phases,
               peak_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
               tokens_equal_plain=True, plain_tok_per_s=stats_plain["tok_per_s"],
               plain_route_calls=stats_plain["route_calls"],
               max_abs_dlogit_vs_plain=parity, dlogit_tolerance=FAMILY_DLOGIT_TOL,
               family_ops_device_ms_per_decode_step=ops,
               moe_dropped_copies=eager["moe_dropped_copies"], keep_dense=list(keep_dense),
               graph=graph, eager=eager, cell_s=time.perf_counter() - t0, **extra)
    print(json.dumps(out), flush=True)
    return out


def run_families() -> dict:
    """Phases 14-16: mamba2-1.3b and recurrentgemma-2b (periods of rec, rec,
    attn and a 2-layer tail) at full width from seeded random weights, each
    cell at its ``FAMILY_LAYERS`` depth (the first layers of one model per
    family)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cells = {}
    for arch, names in (("mamba2-1.3b", ("mamba2-bitplane", "mamba2-digit", "mamba2-detect")),
                        ("recurrentgemma-2b", ("rgemma-bitplane", "rgemma-window"))):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=max(FAMILY_LAYERS[n] for n in names))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        # a cell at a cut depth serves the first layers of the same weights
        params = init_params(cfg, gen, device="cuda")
        for name in names:
            depth = FAMILY_LAYERS[name]
            cfg = dataclasses.replace(full, n_layers=depth)
            cut = dict(params, layers=params["layers"][:depth])
            print(f"[chip_smoke] {name}: {cfg.name} at full width ({depth} of "
                  f"{full.n_layers} layers, {cfg.layer_kinds()[:3]}..., d_model "
                  f"{cfg.d_model}, vocab {cfg.vocab_size})", flush=True)
            mode = {"digit": "digit", "detect": "detect"}.get(name.split("-")[1], "bitplane")
            if name == "rgemma-window":
                cells[name] = run_family(name, cfg, cut, "bitplane", reqs=_window_requests,
                                         schedule=None,
                                         max_len=max(WINDOW_PROMPTS) + WINDOW_GEN)
            else:
                cells[name] = run_family(name, cfg, cut, mode)
            c = cells[name]
            print(f"[chip_smoke] engine {name} done in {c['cell_s']:.1f} s "
                  f"({c['tok_per_s']:.1f} tok/s, device ms per decode step "
                  f"{c['device_ms_per_decode_step']}, family ops "
                  f"{c['family_ops_device_ms_per_decode_step']})", flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return cells


# -- the MoE, VLM and encoder architectures (phase 17) -----------------------

# the reference's serving policy keeps these dense (src/repro/launch/dryrun.py:55)
ARCH_KEEP_DENSE = ("frontend", "router")
# depth of each cell (full: 94, 48, 24 and 48 layers); width is never cut.
# The MoE cells are cut for the smoke's 1200 s and the card's 80 GB (the
# expert stacks are fake-quantized on every call; qwen3moe-bitplane 4 -> 2
# for the tensor-parallel phase's new cells), internvl2-bitplane for
# the smoke's time (its plain-route control runs ~1 s a decode step at 24
# layers, and its decode attention attends one KV head at a time;
# internvl2-patches 24 -> 12 to make room for the mesh-training phase, and
# for the examples phase the MoE cells 2 -> 1, internvl2-bitplane 6 -> 4 and
# internvl2-patches 12 -> 6); PERF.md, section 4
ARCH_LAYERS = {"qwen3moe-bitplane": 1, "scout-bitplane": 1, "internvl2-bitplane": 4,
               "internvl2-patches": 6, "hubert-encode": 48}
VLM_TEXT = 64  # text tokens after internvl2's 256 patches
VLM_BATCH = 4
VLM_GEN = 16
ENC_BATCH = 4
ENC_FRAMES = 500  # 10 s of 16 kHz audio at 20 ms frames


def _card_ms(fn, reps: int = 3) -> float:
    """CUDA events around ``reps`` calls of ``fn`` after one warm-up: ms per
    call on the card's clock (for an eager call, the host's gaps between
    launches included)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_vlm_patches(name, cfg, params, policy) -> dict:
    """internvl2-patches: ``make_prefill_step`` on ``VLM_BATCH`` x (256
    patches of 1024 features + ``VLM_TEXT`` text tokens), then ``VLM_GEN``
    greedy decode steps through ``make_serve_step``, on the kernel route
    and on the plain route (``backend="torch"``) from one quantized tree.
    Gates: every token equal; max|dlogit| of the prefill and of the first
    ``FAMILY_PARITY_STEPS`` decode steps within ``FAMILY_DLOGIT_TOL``; the
    kernel route launches the fused kernel on every projection and nothing
    else, the plain route nothing. Times: prefill and decode host ms (each
    ended by a synchronize), the prefill's ms between CUDA events."""
    from repro_torch.launch import sampling
    from repro_torch.launch.inputs import make_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.quant import quantize_params

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    q_params = quantize_params(params, policy, plane_cache=True, cfg=cfg)
    seq = cfg.num_patches + VLM_TEXT
    batch = make_batch(cfg, VLM_BATCH, seq, "prefill", np.random.default_rng(0), device="cuda")
    runs = {}
    for be in ("auto", "torch"):
        prefill = make_prefill_step(cfg, policy, max_len=seq + VLM_GEN, kv_quant=True, backend=be)
        seen = []

        def greedy(logits, gen, seen=seen):
            seen.append(logits[:, :cfg.vocab_size].float())
            return sampling.greedy(logits, gen)

        step = make_serve_step(cfg, policy, sample_fn=greedy, backend=be)
        prefill(q_params, batch)  # warm-up: allocator and library handles
        torch.cuda.synchronize()
        _reset_counts()
        t1 = time.perf_counter()
        logits, cache = prefill(q_params, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        positions = cache["step"].tolist()
        toks = [sampling.greedy(sampling.mask_vocab(logits, cfg.vocab_size)).to(torch.int32)]
        for _ in range(VLM_GEN - 1):
            tok, cache = step(q_params, cache, toks[-1][:, None])
            toks.append(tok[:, 0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        runs[be] = {"counts": _read_counts(), "prefill_s": t2 - t1,
                    "host_ms_per_decode_step": 1e3 * (t3 - t2) / (VLM_GEN - 1),
                    "tokens": torch.stack(toks, 1).cpu().numpy(),
                    "logits": [logits[:, :cfg.vocab_size].float()] + seen,
                    "step": positions}
        del cache
        if be == "auto":
            runs[be]["prefill_event_ms"] = _card_ms(lambda: prefill(q_params, batch), reps=2)
    k, p = runs["auto"], runs["torch"]
    errs = [float((a - b).abs().max()) for a, b in zip(k["logits"], p["logits"])]
    parity = {"prefill": errs[0], "decode": max(errs[1:1 + FAMILY_PARITY_STEPS])}
    launches = k["counts"]["fused_plane_linear"]
    out = {"engine": name, "card": CARD, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": VLM_BATCH, "patches": cfg.num_patches, "text_tokens": VLM_TEXT,
           "new_tokens": VLM_GEN, "positions_after_prefill": k["step"],
           "prefill_s": k["prefill_s"], "prefill_event_ms": k["prefill_event_ms"],
           "host_ms_per_decode_step": k["host_ms_per_decode_step"],
           "tok_per_s": VLM_BATCH / (k["host_ms_per_decode_step"] / 1e3),
           "plain_prefill_s": p["prefill_s"],
           "plain_host_ms_per_decode_step": p["host_ms_per_decode_step"],
           "launches": launches, "all_launches": k["counts"], "plain_launches": p["counts"],
           "tokens_equal_plain": bool((k["tokens"] == p["tokens"]).all()),
           "max_abs_dlogit_vs_plain": parity, "dlogit_tolerance": FAMILY_DLOGIT_TOL,
           "finite": all(bool(torch.isfinite(x).all()) for x in k["logits"]),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
           "cell_s": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    others = {n: v for n, v in k["counts"].items() if v and n != "fused_plane_linear"}
    if not launches or others or any(p["counts"].values()):
        _die(f"{name}: kernel route launches {k['counts']}, plain route {p['counts']}")
    if k["step"] != [seq] * VLM_BATCH:
        _die(f"{name}: the cache holds {k['step']} positions after the prefill, not {seq}")
    if not out["tokens_equal_plain"] or max(parity.values()) > FAMILY_DLOGIT_TOL \
            or not out["finite"]:
        _die(f"{name}: kernel route against the plain route: tokens equal "
             f"{out['tokens_equal_plain']}, max|dlogit| {parity}")
    del q_params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_encoder(name, cfg, params, policy) -> dict:
    """hubert-encode: ``forward`` on ``ENC_BATCH`` x ``ENC_FRAMES`` frames of
    512 features (float32 hidden state; the encoder has no cache), on the
    kernel route and the plain route from one quantized tree. Gates: every
    frame's argmax over the labels equal, max|dlogit| within
    ``FAMILY_DLOGIT_TOL``, finite logits of the expected shape; the kernel
    route launches the fused kernel (its raw accumulator: the float32
    epilogue runs beside it) and nothing else, the plain route nothing.
    Times: ms per forward on each route between CUDA events (the eager
    forward's host gaps included)."""
    from repro_torch.launch.inputs import make_batch
    from repro_torch.models.quant import quantize_params
    from repro_torch.models.transformer import forward

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    q_params = quantize_params(params, policy, plane_cache=True, cfg=cfg)
    batch = make_batch(cfg, ENC_BATCH, ENC_FRAMES, "prefill", np.random.default_rng(0),
                       device="cuda")
    logits, counts, ms = {}, {}, {}
    with torch.no_grad():
        for be in ("auto", "torch"):
            def fwd(be=be):
                return forward(cfg, q_params, batch, policy=policy, backend=be)[0]
            if be == "auto":  # the plain route (~6 s a call) is timed on its one call
                ms[be] = _card_ms(fwd, reps=2)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            _reset_counts()
            start.record()
            logits[be] = fwd()[..., :cfg.vocab_size].float()
            end.record()
            end.synchronize()
            counts[be] = _read_counts()
            ms.setdefault(be, start.elapsed_time(end))
    k, p = logits["auto"], logits["torch"]
    frames_equal = float((k.argmax(-1) == p.argmax(-1)).float().mean())
    out = {"engine": name, "card": CARD, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": ENC_BATCH, "frames": ENC_FRAMES, "logits_shape": list(k.shape),
           "forward_event_ms": ms["auto"], "plain_forward_event_ms": ms["torch"],
           "frames_per_s": ENC_BATCH * ENC_FRAMES / (ms["auto"] / 1e3),
           "launches": counts["auto"]["fused_plane_linear"], "all_launches": counts["auto"],
           "plain_launches": counts["torch"], "frame_argmax_equal_share": frames_equal,
           "max_abs_dlogit_vs_plain": float((k - p).abs().max()),
           "dlogit_tolerance": FAMILY_DLOGIT_TOL, "finite": bool(torch.isfinite(k).all()),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
           "cell_s": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    others = {n: v for n, v in counts["auto"].items() if v and n != "fused_plane_linear"}
    if not out["launches"] or others or any(counts["torch"].values()):
        _die(f"{name}: kernel route launches {counts['auto']}, plain route {counts['torch']}")
    if frames_equal != 1.0 or out["max_abs_dlogit_vs_plain"] > FAMILY_DLOGIT_TOL or \
            not out["finite"] or out["logits_shape"] != [ENC_BATCH, ENC_FRAMES, cfg.vocab_size]:
        _die(f"{name}: kernel route against the plain route: {out}")
    del q_params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_architectures() -> dict:
    """Phase 17: qwen3-moe-235b-a22b and llama4-scout-17b-a16e served
    bit-serially with the router dense, internvl2-2b served on text and
    prefilled with its 256 image patches, hubert-xlarge's encoder forward;
    full width, seeded random weights made on the card, the reference's
    serving policy (``ARCH_KEEP_DENSE``), depths per ``ARCH_LAYERS``."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.models.transformer import init_params

    t0 = time.perf_counter()
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane",
                                     keep_dense=ARCH_KEEP_DENSE)
    cells = {}
    for arch, names in (("qwen3-moe-235b-a22b", ("qwen3moe-bitplane",)),
                        ("llama4-scout-17b-a16e", ("scout-bitplane",)),
                        ("internvl2-2b", ("internvl2-bitplane", "internvl2-patches")),
                        ("hubert-xlarge", ("hubert-encode",))):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=max(ARCH_LAYERS[n] for n in names))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        # a cell at a cut depth serves the first layers of the same weights
        all_params = init_params(cfg, gen, device="cuda")
        for name in names:
            cfg = dataclasses.replace(full, n_layers=ARCH_LAYERS[name])
            params = dict(all_params, layers=all_params["layers"][:cfg.n_layers])
            n_params = sum(t.numel() for t in tree.leaves(params))
            print(f"[chip_smoke] {name}: {cfg.name} at full width ({cfg.n_layers} of "
                  f"{full.n_layers} layers, {n_params / 1e9:.2f} G parameters, d_model "
                  f"{cfg.d_model}, vocab {cfg.vocab_size})", flush=True)
            if name == "internvl2-patches":
                cells[name] = run_vlm_patches(name, cfg, params, policy)
            elif name == "hubert-encode":
                cells[name] = run_encoder(name, cfg, params, policy)
            else:
                cells[name] = run_family(name, cfg, params, "bitplane",
                                         keep_dense=ARCH_KEEP_DENSE)
            cells[name]["parameters"] = n_params
            print(f"[chip_smoke] {name} done in {cells[name]['cell_s']:.1f} s", flush=True)
        del params, all_params
        gc.collect()
        torch.cuda.empty_cache()
    cells["phase_s"] = time.perf_counter() - t0
    return cells


# -- training (phase 18) -----------------------------------------------------

# TrainRun at granite-3-8b's full width, depth cut to LAYERS; train-resume
# at RESUME_LAYERS (a cut for checkpoint bytes: ~6.0 GB a save)
TRAIN_BATCH = 8
TRAIN_SEQ = 256
TRAIN_STEPS = 12
TRAIN_LR = 1e-3
TRAIN_MICRO = 4
RESUME_LAYERS = 1
RESUME_EVERY = 6
# the QAT forward against the bit-serial inference it trains for: the
# bounds of tests/test_torch_train.py (QAT_GAP, QAT_AGREE)
QAT_GAP = 0.1  # max|dlogit| / max|logit|
QAT_AGREE = 0.75  # greedy-token agreement
QAT_PROMPTS = (4, 64)  # prompts x tokens of the comparison


def _train_cell(name: str, cfg, **kw) -> tuple[dict, dict, object]:
    """One TrainRun on the card (launch counts set to 0 just before it and
    read just after: training launches none of the port's kernels, its
    QAT product being a plain bf16 matmul as the reference's is). Returns
    its line, TrainRun's dict and the run."""
    from repro_torch.launch.train import TrainRun

    args = dict(cfg=cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                peak_lr=TRAIN_LR, log_every=1000, device="cuda")
    args.update(kw)
    run = TrainRun(**args)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _reset_counts()
    out = run.run()
    torch.cuda.synchronize()
    counts = _read_counts()
    if any(counts.values()):
        _die(f"{name}: training launched the port's kernels {counts}")
    step_ms = run.timings["step_ms"]
    med = float(np.median(step_ms)) if step_ms else float("nan")
    line = {
        "train_cell": name, "card": CARD, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "batch": run.global_batch, "seq": run.seq_len, "microbatches": run.microbatches,
        "steps": len(out["losses"]), "policy": run.policy.describe(),
        "losses": out["losses"], "step_ms": step_ms, "step_ms_median": med,
        "steps_per_s": 1e3 / med, "trainrun_steps_per_s": out["steps_per_s"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "resident_bytes": run.timings.get("resident_bytes"),
        "kernel_launches": counts, "cell_s": time.perf_counter() - t0,
    }
    return line, out, run


GEMM_TAGS = ("gemm", "nvjet", "xmma", "cutlass", "cublas")  # matmul kernels, by name
TRAIN_RANGES = ("train.grads", "train.clip", "train.update")


def _train_profile(cfg, params, policy) -> dict:
    """Where a step's device time goes: one warm step of
    ``make_train_step`` from ``params`` (the run's trained weights, a
    fresh AdamW state, the pipeline's batch 0), then one under
    ``torch.profiler``: the kernels' device time in all and in matmul
    kernels (by name); the device spans of the clip's and the optimizer's
    ranges (their annotations on the device timeline: ``train.clip``,
    ``train.update``); the rest (forward and backward, whose backward
    runs on autograd's thread, outside any annotation) and the 10 kernels
    that take the most."""
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.optim import OptimConfig

    opt = OptimConfig(peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, opt, policy=policy)
    pipe = DataPipeline(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                   vocab_size=cfg.vocab_size))
    dev = params["embed"]["embedding"].device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
    p, s, _ = step(params, init_opt_state(cfg, opt, params), batch, 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        p, s, _ = step(p, s, batch, 1)
        torch.cuda.synchronize()
    del p, s
    by_name: dict = {}
    spans = {name: 0.0 for name in TRAIN_RANGES}
    busy = gemm = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        us = e.time_range.end - e.time_range.start
        if e.name in spans:  # a range's annotation, not a kernel
            spans[e.name] += us
            continue
        busy += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        if any(t in e.name.lower() for t in GEMM_TAGS):
            gemm += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels_ms": busy / 1e3, "matmul_ms": gemm / 1e3,
            "clip_span_ms": spans["train.clip"] / 1e3,
            "update_span_ms": spans["train.update"] / 1e3,
            "rest_ms": (busy - spans["train.clip"] - spans["train.update"]) / 1e3,
            "top_kernels_ms": {name[:100]: us / 1e3 for name, us in top}}


def _loss_falls(name: str, losses: list) -> None:
    """The reference's criterion (examples/train_tiny_lm.py): every loss
    finite, the mean of the last 3 below the mean of the first 3."""
    if not np.isfinite(losses).all():
        _die(f"{name}: a loss is not finite: {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        _die(f"{name}: the loss did not fall: {losses}")


def _train_resume(full) -> dict:
    """``train-resume``: 12 steps at full width and RESUME_LAYERS, saving
    every RESUME_EVERY steps; the final checkpoint (step 11) is deleted, a
    crash after the step-5 save, and a fresh TrainRun resumes from step 5.
    Both runs use deterministic algorithms (with ``warn_only``: an op with
    no deterministic CUDA version is named, and then the losses are held
    within 1e-3 instead of bit for bit)."""
    import os
    import shutil
    import tempfile
    import warnings

    cfg = dataclasses.replace(full, n_layers=RESUME_LAYERS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            line, out, run = _train_cell("train-resume", cfg, ckpt_dir=tmp,
                                         ckpt_every=RESUME_EVERY)
            shutil.rmtree(Path(tmp) / f"step_{TRAIN_STEPS - 1}")
            kept = sorted(p.name for p in Path(tmp).iterdir())
            res_line, res_out, res_run = _train_cell("train-resume (resumed)", cfg,
                                                     ckpt_dir=tmp, ckpt_every=RESUME_EVERY)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught if "deterministic" in str(w.message)})
    want = out["losses"][RESUME_EVERY:]
    got = res_out["losses"]
    if len(got) != TRAIN_STEPS - RESUME_EVERY:
        _die(f"train-resume: resumed {len(got)} steps, kept {kept}")
    exact = got == want
    if nondet:
        if not np.allclose(got, want, rtol=1e-3):
            _die(f"train-resume: nondeterministic ops {nondet}; resumed losses {got} "
                 f"against {want} beyond rtol 1e-3")
    elif not exact:
        _die(f"train-resume: resumed losses {got} differ from the uninterrupted {want}")
    saves = run.timings["saves"] + res_run.timings["saves"]
    line.update(
        cut=f"depth {full.n_layers} -> {RESUME_LAYERS} (checkpoint bytes)",
        ckpt_every=RESUME_EVERY, kept_after_crash=kept, resumed_losses=got,
        resumed_equal=exact, nondeterministic_ops=nondet,
        gate="bit-equal" if not nondet else "rtol 1e-3",
        saves=saves, save_s=[s["snapshot_s"] + s["write_s"] for s in saves],
        save_bytes=[s["bytes"] for s in saves], restore_s=res_run.timings["restore_s"],
        resumed_step_ms_median=res_line["step_ms_median"],
        resumed_peak_memory_gb=res_line["peak_memory_gb"],
    )
    return line


def _qat_gap(cfg, params, policy) -> dict:
    """``train-serve`` (a): the training forward's logits (fake quant)
    against the on-the-fly bit-serial inference (``training=False``, the
    same policy and dense weights: route ``fused_repack``, kernel row 1)
    on QAT_PROMPTS, launches counted over the inference forward alone."""
    from repro_torch.models.transformer import forward

    b, s = QAT_PROMPTS
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)))
    tokens = tokens.to(params["embed"]["embedding"].device)
    with torch.no_grad():
        qat = forward(cfg, params, {"tokens": tokens}, policy=policy, training=True)[0]
        _reset_counts()
        inf = forward(cfg, params, {"tokens": tokens}, policy=policy)[0]
        torch.cuda.synchronize()
        counts = _read_counts()
    qat = qat.float()[..., :cfg.vocab_size]
    inf = inf.float()[..., :cfg.vocab_size]
    gap = float((qat - inf).abs().max())
    scale = float(qat.abs().max())
    agree = float((qat.argmax(-1) == inf.argmax(-1)).float().mean())
    if not counts["fused_plane_linear"] or any(v for k, v in counts.items()
                                                  if k != "fused_plane_linear"):
        _die(f"train-serve: the bit-serial forward launched {counts}")
    if not (np.isfinite(gap) and gap <= QAT_GAP * scale and agree >= QAT_AGREE):
        _die(f"train-serve: QAT forward against bit-serial max|dlogit| {gap} (max|logit| "
             f"{scale}), argmax agreement {agree}; bounds {QAT_GAP} of max|logit|, "
             f"{QAT_AGREE}")
    return {"max_abs_dlogit": gap, "max_abs_logit": scale, "gap_over_max_logit": gap / scale,
            "argmax_agreement": agree, "bound": f"{QAT_GAP} of max|logit|, agreement >= "
            f"{QAT_AGREE}", "prompts": list(QAT_PROMPTS), "launches": counts}


def _train_serve(cfg, params, policy) -> dict:
    """``train-serve``: the QAT-trained weights through (a) the QAT gap
    and (b) quantize_params(plane_cache=True) and the continuous-batching
    bitplane engine on 4 requests, whose greedy tokens must equal the
    plain route's on the card; the fused kernel's launches counted."""
    from repro_torch.runtime.scheduler import Request

    t0 = time.perf_counter()
    gap = _qat_gap(cfg, params, policy)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (s,)) for s in PROMPT_LENS]

    def reqs(_cfg):
        return [Request(rid=i, tokens=p, max_new_tokens=GEN_TOKENS, arrival_step=STAGGER * i)
                for i, p in enumerate(prompts)]

    # the precision QAT trained for, served from the plane cache
    engine = _engine(cfg, params, policy)
    results, stats, counts = _counted_run("train-serve", cfg, engine, None,
                                          "fused_plane_linear", "fused_cached", reqs=reqs)
    del engine
    plain = _engine(cfg, params, policy, backend="torch", compile_steps=False)
    res_plain, _ = plain.run(reqs(cfg))
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    _same_tokens("train-serve", results, res_plain, "the plain route")
    return {"train_cell": "train-serve", "card": CARD, "layers": cfg.n_layers,
            "qat_vs_bit_serial": gap, "requests": len(results), "tokens_equal_plain": True,
            "launches": counts, "route_calls": stats["route_calls"],
            "tok_per_s": stats["tok_per_s"], "cell_s": time.perf_counter() - t0}


def run_training() -> dict:
    """Phase 18: quantization-aware training and checkpoints at
    granite-3-8b's full width through ``TrainRun`` (train-dense,
    train-qat8, train-micro4, train-resume, train-serve)."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.models.transformer import unstack_layers

    t0 = time.perf_counter()
    full = get_config("granite-3-8b")
    cfg = dataclasses.replace(full, n_layers=LAYERS)
    cells = {}

    def done(name, line):
        cells[name] = line
        print(json.dumps(line), flush=True)

    line, dense, _ = _train_cell("train-dense", cfg)
    _loss_falls("train-dense", dense["losses"])
    line["profile"] = _train_profile(cfg, dense["params"], PrecisionPolicy.off())
    done("train-dense", line)
    del dense
    # QAT ignores the level; the bit-serial inference of train-serve takes
    # the fused bit-plane kernel at it
    qat_policy = PrecisionPolicy.uniform(8, 8, level="bitplane", keep_dense=("lm_head", "embed"))
    line, qat, _ = _train_cell("train-qat8", cfg, policy=qat_policy)
    _loss_falls("train-qat8", qat["losses"])
    line["profile"] = _train_profile(cfg, qat["params"], qat_policy)
    done("train-qat8", line)
    trained = unstack_layers(cfg, qat["params"])
    del qat
    line, micro, _ = _train_cell("train-micro4", cfg, steps=1, microbatches=TRAIN_MICRO)
    single = cells["train-dense"]["losses"][0]
    if not np.isclose(micro["losses"][0], single, rtol=1e-3):
        _die(f"train-micro4: first-step loss {micro['losses'][0]} against the single-shot "
             f"{single} beyond rtol 1e-3")
    line.update(single_shot_first_loss=single, rtol=1e-3)
    done("train-micro4", line)
    done("train-resume", _train_resume(full))
    done("train-serve", _train_serve(cfg, trained, qat_policy))
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    cells["phase_s"] = time.perf_counter() - t0
    return cells


# -- tensor-parallel serving (phase 19) ---------------------------------------

TP_SIZE = 2  # ranks of the gloo cells, sharing the one card
TP_DECODE_STEPS = 16  # decode steps of tp1-nccl's loops
TP_BYTES_RATIO = 0.55  # per-rank plane bytes at P=2 against P=1's, at most


def _seed_params(cfg):
    """Phase 3's weights: ``init_params`` from a CUDA generator seeded 0,
    on the card."""
    from repro_torch.models.transformer import init_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return init_params(cfg, gen, device="cuda")


def _tp_loop(cfg, kv_cfg, q_params, prefill, step, prompts, max_len,
             runner=None) -> np.ndarray:
    """Prefill ``prompts`` one by one into the slots of an int8 slot cache
    (``kv_cfg``'s heads), then ``TP_DECODE_STEPS`` greedy decode steps over
    the slot array: eagerly, or with ``runner`` as replays of one CUDA graph
    of the step (``graphs.CapturedStep``, captured on the loop's state).
    Returns the (steps, slots) tokens."""
    from repro_torch.launch import graphs, sampling
    from repro_torch.launch.serve import _decode_body
    from repro_torch.models.cache import init_cache, insert_slot, quantize_scratch

    n = len(prompts)
    state = {"cache": init_cache(kv_cfg, n, max_len, cfg.dtype, kv_quant=True, device="cuda"),
             "tokens": torch.zeros((n, 1), dtype=torch.int32, device="cuda"),
             "temps": torch.zeros((n,), dtype=torch.float32, device="cuda")}
    for slot, p in enumerate(prompts):
        toks = torch.as_tensor(p, device="cuda")[None, :]
        logits, scratch = prefill(q_params, toks)
        insert_slot(state["cache"], quantize_scratch(scratch), slot)
        state["tokens"][slot, 0] = sampling.greedy(
            sampling.mask_vocab(logits, cfg.vocab_size), None)[0]
    body = _decode_body(step, q_params, False)
    captured = None
    if runner is not None:
        from repro_torch.core import plan as plan_mod

        captured = graphs.CapturedStep(body, state, plan_mod.DEFAULT_REGISTRY, runner)
    out = []
    for i in range(TP_DECODE_STEPS):
        toks = body(state, None) if captured is None else captured(i)
        out.append(toks.cpu().numpy())
    return np.stack(out)


def run_tp_nccl(cfg, params, base: int) -> dict:
    """tp1-nccl: a ``TPContext`` over an NCCL group of world size 1 in this
    process. The single-device steps and the tensor-parallel ones (eager,
    then the decode step captured in a CUDA graph with its collectives)
    serve the workload's first prompts; the tokens must agree. ``params``
    lie on the card, drawn there after the peak memory count was reset at
    ``base`` bytes: the single-device load's peak (the dense tree and its
    quantization) is reported beside the ranks'."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch import graphs, mesh
    from repro_torch.launch.steps import (make_cb_decode_step, make_prefill_step,
                                          make_tp_cb_decode_step, make_tp_prefill_step)
    from repro_torch.models.quant import quantize_params
    from repro_torch.sharding.tp import plane_cache_device_bytes, shard_quantized

    t0 = time.perf_counter()
    name = "tp1-nccl"
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane")
    prompts = [r.tokens for r in _requests(cfg)]
    max_len = max(p.size for p in prompts) + TP_DECODE_STEPS
    single = quantize_params(params, policy, cfg=cfg, plane_cache=True)
    one_bytes = plane_cache_device_bytes(single)
    one_peak = torch.cuda.max_memory_allocated() - base
    one_resident = torch.cuda.memory_allocated() - base  # the dense tree and its quantization
    ref = _tp_loop(cfg, cfg, single, make_prefill_step(cfg, policy, max_len=max_len),
                   make_cb_decode_step(cfg, policy), prompts, max_len)
    del single
    with tempfile.TemporaryDirectory(prefix="tp1_") as where:
        tp = mesh.init_tp_group(1, 0, where, backend="nccl")
        try:
            q = shard_quantized(params, policy, tp, cfg=cfg)
            kv_cfg = tp.local_config(cfg)
            prefill = make_tp_prefill_step(cfg, tp, policy, max_len=max_len)
            step = make_tp_cb_decode_step(cfg, tp, policy)
            eager = _tp_loop(cfg, kv_cfg, q, prefill, step, prompts, max_len)
            _reset_counts()
            replayed = _tp_loop(cfg, kv_cfg, q, prefill, step, prompts, max_len,
                                runner=graphs.CudaGraphRunner(torch.device("cuda")))
            counts = _read_counts()
            del q
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    if not np.array_equal(eager, ref):
        _die(f"{name}: the eager TP step's tokens differ from the single-device steps'")
    if not np.array_equal(replayed, eager):
        _die(f"{name}: the captured TP decode step's tokens differ from the eager TP step's")
    line = {"engine": name, "layers": cfg.n_layers, "backend": "nccl", "world_size": 1,
            "prompts": [int(p.size) for p in prompts], "decode_steps": TP_DECODE_STEPS,
            "tokens_equal_single_device": True, "graph_equals_eager": True,
            "launches_graph_loop": counts, "plane_cache_bytes_p1": one_bytes,
            "load_peak_gb_p1": one_peak / 2**30, "resident_gb_p1": one_resident / 2**30,
            "phase_s": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    return line


def _tp_cell(name, cfg, engine, reqs, schedule, rank) -> dict:
    """One tensor-parallel cell on this rank: a warm-up run and the counted
    run (launch counts set to 0 just before it, read just after). No run
    is profiled: a profiled gloo run took ~30 s a cell on the host (PR 28,
    a cut for the smoke's limit; PERF.md §4)."""
    t0 = time.perf_counter()
    engine.run(reqs[:1], precision_schedule=schedule)
    engine.set_precision(None)
    _reset_counts()
    results, stats = engine.run(reqs, precision_schedule=schedule)
    counts = _read_counts()
    engine.set_precision(None)
    return {"engine": name, "rank": rank, "cell_s": time.perf_counter() - t0,
            "tokens": {rid: t.tolist() for rid, t in results.items()},
            "failed": stats["failed"], "launches": counts, "route_calls": stats["route_calls"],
            "decode_steps": stats["decode_steps"], "prefill_s": stats["prefill_s"],
            "host_ms_per_decode_step": 1e3 * stats["decode_s"] / stats["decode_steps"],
            "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
            "plane_cache_bytes": engine.plane_cache_bytes_per_device()}


#: one plane-word flip before iteration 2, injected on rank 1 alone
TP_SCRUB_SPEC = "planes@2;seed=11"
#: the families served tensor-parallel in phase 19: name -> (arch, depth,
#: dense layers). Depth is cut for the phase's time, never width; each is
#: held against a single-device eager twin at the same depth
TP_FAMILIES = {"mamba2-tp2": ("mamba2-1.3b", 2, ()),
               "qwen3moe-tp2": ("qwen3-moe-235b-a22b", 1, ARCH_KEEP_DENSE),
               "internvl2-patches-tp2": ("internvl2-2b", 2, ARCH_KEEP_DENSE)}
#: the routes of the plane kernels on the TP main path (rows 1 and 2)
TP_ROUTES = {"fused_cached": "fused_plane_linear", "cached_packed": "plane_matmul_packed"}


def _tp_load_line(tp, cfg, policy) -> dict:
    """This rank's shard drawn by the layer-by-layer loader
    (``sharding.tp.load_shard``, phase 3's seed): its card memory peak
    while each part (the embedding, the final norm, the head, each layer)
    is drawn, sliced, quantized and decomposed — everything held then
    included — and resident after, in GiB above the count's start."""
    from repro_torch.models.transformer import SeededParams
    from repro_torch.sharding.tp import load_shard

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    parts = {}

    def on_part(path):
        parts[path] = (torch.cuda.max_memory_allocated() - base) / 2**30
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    shard = load_shard(cfg, SeededParams(0).generator("cuda"), policy, tp, on_part=on_part)
    torch.cuda.synchronize()
    out = {"load_s": time.perf_counter() - t0, "peak_gb": max(parts.values()),
           "resident_gb": (torch.cuda.memory_allocated() - base) / 2**30,
           "part_peak_gb": parts, "largest_part": max(parts, key=parts.get)}
    del shard
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_counted(name, engine, reqs, schedule, rank, injector=None) -> tuple:
    """One counted run on this rank (launch counts set to 0 just before it,
    read just after): (results, stats, the line's common fields)."""
    t0 = time.perf_counter()
    _reset_counts()
    results, stats = engine.run(reqs, precision_schedule=schedule, injector=injector)
    counts = _read_counts()
    return results, stats, {
        "engine": name, "rank": rank, "run_s": time.perf_counter() - t0,
        "tokens": {rid: t.tolist() for rid, t in results.items()}, "failed": stats["failed"],
        "launches": counts, "route_calls": stats["route_calls"],
        "decode_steps": stats["decode_steps"], "prefill_s": stats["prefill_s"],
        "host_ms_per_decode_step": 1e3 * stats["decode_s"] / max(stats["decode_steps"], 1)}


def _tp_scrub_cell(tp, cfg, seeded) -> dict:
    """bitplane-scrub-tp2: bitplane-scrub's engine (the packed route, layers
    unrolled, an audit every iteration) on each rank, with one seeded plane
    flip on rank 1 alone: found by rank 1's audit, maximized over the
    ranks, so both scrub at the same iteration."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.kernels import fold
    from repro_torch.runtime.faults import FaultInjector

    name = "bitplane-scrub-tp2"
    unrolled = dataclasses.replace(cfg, scan_layers=False)
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane", integrity="scrub")
    t0 = time.perf_counter()
    engine = _engine(unrolled, seeded, policy, audit_interval=1, compile_steps=False,
                     model_parallel=tp.size)
    inj = FaultInjector(TP_SCRUB_SPEC) if tp.rank == 1 else None
    _, stats, line = _tp_counted(name, engine, _requests(unrolled), None, tp.rank, inj)
    line.update(integrity=stats["integrity"], scrub_s=list(engine.scrub_s),
                injected=len(inj.events) if inj else 0,
                undetected=len(inj.undetected) if inj else 0,
                fingerprint_restored=int(fold.tree_fold(engine.q_params)) == engine._params_ref,
                source_bytes=_tree_bytes(engine._src_params),
                quantized_tree_bytes=_tree_bytes(engine.q_params),
                cell_s=time.perf_counter() - t0)
    del engine
    gc.collect()
    return line


def _tp_autopilot_cell(tp, cfg, seeded, policy) -> dict:
    """bitplane-autopilot-tp2: bitplane-autopilot's engine and overload
    ramp (16 requests, prefill chunks of 64) on each rank, eager."""
    from repro_torch.launch.serve import ContinuousBatchingEngine
    from repro_torch.runtime.autopilot import AutopilotPolicy

    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(cfg, seeded, policy, n_slots=N_SLOTS, max_len=AP_MAX_LEN,
                                      device="cuda", prefill_chunk=PAGED_CHUNK,
                                      compile_steps=False, model_parallel=tp.size,
                                      autopilot=AutopilotPolicy(**AP_POLICY))
    _, stats, line = _tp_counted("bitplane-autopilot-tp2", engine, _ap_requests(cfg, False),
                                 None, tp.rank)
    ap = stats["autopilot"]
    line.update({k: ap[k] for k in ("switches", "request_tiers", "tier_tokens", "shed",
                                    "mixed_steps", "shadow_probes", "shadow_kl_ewma")},
                host_ms_split=_split_steps(ap["step_host_ms"], ap["step_passes"]),
                cell_s=time.perf_counter() - t0)
    del engine
    gc.collect()
    return line


def _tp_autotune_cells(tp, cfg, seeded, policy, plans_dir) -> list:
    """bitplane-autotune-tp2 (the tile autotuner on a fresh plan store in
    ``plans_dir``: rank 0 tunes and writes it, every rank takes rank 0's
    picks) and -warm-tp2 (a new tuner on the same store, the registry
    cleared): bitplane's workload, eager. The tuner is detached after."""
    from repro_torch.core import plan as plan_mod

    registry = plan_mod.DEFAULT_REGISTRY
    path = os.path.join(plans_dir, "plans.json")
    out = []
    for name in ("bitplane-autotune-tp2", "bitplane-autotune-warm-tp2"):
        registry.attach_tuner(None)
        registry.clear()
        t0 = time.perf_counter()
        engine = _engine(cfg, seeded, policy, autotune=True, plan_store_path=path,
                         compile_steps=False, model_parallel=tp.size)
        _, stats, line = _tp_counted(name, engine, _requests(cfg), {8: 4}, tp.rank)
        inner = engine.autotuner.tuner
        tuned = [p for p in registry.plans() if p.tuned]
        line.update(store=stats["plans"], keeps_store=getattr(inner, "store", None) is not None,
                    tiles=sorted({(p.kernel, p.key.m, p.key.k, p.key.n, p.key.a_bits, p.bm,
                                   p.k_split) for p in tuned}),
                    store_files=sorted(os.listdir(plans_dir)), cell_s=time.perf_counter() - t0)
        out.append(line)
        del engine
        gc.collect()
    registry.attach_tuner(None)
    registry.clear()
    return out


def _vlm_loop(cfg, q_params, prefill, step) -> np.ndarray:
    """internvl2's image prefix: ``prefill`` of ``VLM_BATCH`` x (256
    patches + ``VLM_TEXT`` tokens), then ``VLM_GEN - 1`` greedy decode
    steps of ``step`` (a continuous-batching step at temperature 0).
    Returns the (batch, VLM_GEN) tokens."""
    from repro_torch.launch import sampling
    from repro_torch.launch.inputs import make_batch

    seq = cfg.num_patches + VLM_TEXT
    batch = make_batch(cfg, VLM_BATCH, seq, "prefill", np.random.default_rng(0), device="cuda")
    logits, cache = prefill(q_params, batch)
    tok = sampling.greedy(sampling.mask_vocab(logits, cfg.vocab_size)).to(torch.int32)[:, None]
    temps = torch.zeros((VLM_BATCH,), dtype=torch.float32, device="cuda")
    toks = [tok]
    for _ in range(VLM_GEN - 1):
        tok, cache = step(q_params, cache, tok, temps, None)[:2]
        toks.append(tok)
    return torch.cat(toks, dim=1).cpu().numpy()


def _tp_family_setup(name):
    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy

    arch, layers, keep = TP_FAMILIES[name]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    return cfg, PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane",
                                        keep_dense=keep)


def _tp_family_cell(tp, name) -> dict:
    """One family served tensor-parallel on this rank, eager, its weights
    drawn by the layer-by-layer loader (phase 3's seed): the engine on
    ``_requests`` with the families' 8 -> 4 switch, or internvl2's image
    prefix through the tensor-parallel prefill and decode steps."""
    from repro_torch.launch.steps import make_tp_cb_decode_step, make_tp_prefill_step
    from repro_torch.models.transformer import SeededParams
    from repro_torch.sharding.tp import load_shard

    cfg, policy = _tp_family_setup(name)
    t0 = time.perf_counter()
    if name == "internvl2-patches-tp2":
        q = load_shard(cfg, SeededParams(0).generator("cuda"), policy, tp)
        prefill = make_tp_prefill_step(cfg, tp, policy,
                                       max_len=cfg.num_patches + VLM_TEXT + VLM_GEN,
                                       kv_quant=True)
        step = make_tp_cb_decode_step(cfg, tp, policy)
        _reset_counts()
        t1 = time.perf_counter()
        toks = _vlm_loop(cfg, q, prefill, step)
        counts = _read_counts()
        line = {"engine": name, "rank": tp.rank, "run_s": time.perf_counter() - t1,
                "tokens": toks.tolist(), "failed": {}, "launches": counts,
                "route_calls": None}
        del q
    else:
        engine = _engine(cfg, SeededParams(0), policy, compile_steps=False,
                         model_parallel=tp.size)
        _, _, line = _tp_counted(name, engine, _requests(cfg), FAMILY_SCHEDULE, tp.rank)
        del engine
    line.update(layers=cfg.n_layers, cell_s=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    return line


def _tp_family_twins() -> dict:
    """The single-device eager twin of each ``TP_FAMILIES`` cell at its
    depth, on phase 3's seed: the tokens (and the host ms a decode step)."""
    from repro_torch.launch.steps import make_cb_decode_step, make_prefill_step
    from repro_torch.models.quant import quantize_params

    out = {}
    for name in TP_FAMILIES:
        cfg, policy = _tp_family_setup(name)
        params = _seed_params(cfg)
        t0 = time.perf_counter()
        if name == "internvl2-patches-tp2":
            q = quantize_params(params, policy, cfg=cfg, plane_cache=True)
            prefill = make_prefill_step(cfg, policy, max_len=cfg.num_patches + VLM_TEXT + VLM_GEN,
                                        kv_quant=True)
            out[name] = {"tokens": _vlm_loop(cfg, q, prefill, make_cb_decode_step(cfg, policy))}
            del q
        else:
            engine = _engine(cfg, params, policy, compile_steps=False)
            results, stats = engine.run(_requests(cfg), precision_schedule=FAMILY_SCHEDULE)
            _check_finished(f"{name} twin", cfg, results, stats)
            out[name] = {"tokens": results, "host_ms_per_decode_step":
                         1e3 * stats["decode_s"] / stats["decode_steps"]}
            del engine
        out[name]["s"] = time.perf_counter() - t0
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tp_rank_cells(backend, device, n_layers: int, plans_dir: str) -> list:
    """One rank of the gloo cells (every rank on ``cuda:0``), each eager
    (gloo's collectives cannot be captured), every model drawn by the
    layer-by-layer loader from phase 3's seed (``SeededParams(0)``): the
    load line; bitplane-tp2 on phase 3's workload with its 8 -> 4 switch at
    step 8, and bitplane-paged-tp2 on phase 8's; the scrub, autopilot and
    autotune cells; the families (``TP_FAMILIES``). Returns every rank's
    lines (rank 0's is the one ``spawn_ranks`` hands back)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.mesh import tp_context
    from repro_torch.models.transformer import SeededParams

    tp = tp_context()
    started = time.time()
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=n_layers)
    seeded = SeededParams(0)
    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane")
    lines = []
    loader = _tp_load_line(tp, cfg, policy)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = _engine(cfg, seeded, policy, compile_steps=False, model_parallel=tp.size)
    load_s = time.perf_counter() - t0
    memory = {"load_peak_gb": (torch.cuda.max_memory_allocated() - base) / 2**30,
              "resident_gb": (torch.cuda.memory_allocated() - base) / 2**30}
    lines.append(dict(_tp_cell("bitplane-tp2", cfg, engine, _requests(cfg), {8: 4}, tp.rank),
                      load_s=load_s, started=started, memory=memory, loader=loader))
    del engine
    gc.collect()
    engine = _paged_engine(cfg, seeded, policy, compile_steps=False, model_parallel=tp.size)
    lines.append(_tp_cell("bitplane-paged-tp2", cfg, engine, _paged_requests(cfg), None,
                          tp.rank))
    del engine
    gc.collect()
    lines.append(_tp_scrub_cell(tp, cfg, seeded))
    lines.append(_tp_autopilot_cell(tp, cfg, seeded, policy))
    lines += _tp_autotune_cells(tp, cfg, seeded, policy, plans_dir)
    torch.cuda.empty_cache()
    for name in TP_FAMILIES:
        lines.append(_tp_family_cell(tp, name))
    every = [None] * tp.size
    dist.all_gather_object(every, lines)
    return every


def _tp_launch_gate(tag, r, attn_per_step=0, packed=None) -> None:
    """Every projection of the rank's counted run through rows 1 and 2 (no
    plain route): each route's calls equal its kernel's launches, row 1
    launched (``packed``: row 2 alone, the scrub cell's packed route; None:
    whatever the routes say), and row 5 ``attn_per_step`` times a decode
    step; nothing else but the fold kernel."""
    c, routes = r["launches"], r["route_calls"]
    kernels = set(TP_ROUTES.values()) | {"paged_flash_attention", "fold"}
    others = {k: v for k, v in c.items() if v and k not in kernels}
    if routes is None:  # internvl2-patches-tp2: the steps alone, no engine's route report
        bad = others or not c["fused_plane_linear"] or c["paged_flash_attention"]
    else:
        bad = (set(routes) - set(TP_ROUTES) or others
               or any(c[k] != routes.get(route, 0) for route, k in TP_ROUTES.items())
               or c["paged_flash_attention"] != attn_per_step * r["decode_steps"]
               or not c["plane_matmul_packed" if packed else "fused_plane_linear"]
               or (packed and c["fused_plane_linear"]))
    if bad:
        _die(f"{tag}: launches {c} against routes {routes}")


def _tp_tokens_gate(tag, r, control: dict, what: str, failed=None) -> None:
    """The rank's tokens equal ``control``'s, request for request; its
    failed requests (rid -> reason) are ``failed`` (default none)."""
    if r["failed"] != (failed or {}):
        _die(f"{tag}: requests failed: {r['failed']} against {failed or {}} in {what}")
    got = {int(k): np.asarray(v) for k, v in r["tokens"].items()}
    if sorted(got) != sorted(int(k) for k in control):
        _die(f"{tag}: requests {sorted(got)} against {sorted(control)} in {what}")
    _same_tokens(tag, got, control, what)


def run_tp(cfg, controls: dict, p1_bytes: int, p1_memory: tuple, twins: dict) -> dict:
    """Phase 19, tensor-parallel serving: ``TP_SIZE`` ranks spawned over
    gloo, all on this card, serve bitplane-tp2, bitplane-paged-tp2,
    bitplane-scrub-tp2, bitplane-autopilot-tp2, bitplane-autotune(-warm)-tp2
    and the ``TP_FAMILIES`` cells, every model loaded layer by layer. On
    each rank: the tokens equal the single-device cell's or eager twin's
    (``controls``; the autopilot cell's its request by request, its
    switches, tiers and shed set on every rank); every column- and
    vocab-parallel projection launches fused_plane_linear and every
    row-parallel one plane_matmul_packed (the scrub cell: every projection
    packed; the paged cell also paged_flash_attention, layers x decode
    steps times), no plain route runs; the scrub cell's flip on rank 1 is
    found on every rank, one scrub each, the fingerprint restored; the
    autotune cells: every rank the same tiles, rank 0 alone keeps the one
    store, warm from it with no tune; each rank's plane bytes at most
    ``TP_BYTES_RATIO`` of the single-device tree's ``p1_bytes``. Prints a
    line per cell with each rank's launches, host ms per decode step beside
    the single-device eager twin's (``twins``) and prefill s; the first
    cell's also each rank's card memory at load (peak, and resident after,
    and the loader's peak part by part) beside the single-device load's,
    ``p1_memory`` (GiB)."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh

    t0, t0_wall = time.perf_counter(), time.time()
    plans_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_plans_")
    try:
        every = mesh.spawn_ranks(_tp_rank_cells, TP_SIZE, device="cuda", share_device=True,
                                 args=(cfg.n_layers, plans_dir))
    finally:
        shutil.rmtree(plans_dir, ignore_errors=True)
    spawn_s = time.perf_counter() - t0
    by_name: dict = {}
    for lines in every:
        for line in lines:
            by_name.setdefault(line["engine"], []).append(line)
    out = {}

    def common(name, ranks) -> dict:
        return {"engine": name, "ranks": TP_SIZE, "backend": "gloo",
                "device": "cuda:0 (every rank)", "compile_steps": False,
                "launches_per_rank": [r["launches"] for r in ranks],
                "route_calls_per_rank": [r["route_calls"] for r in ranks],
                "host_ms_per_decode_step_per_rank": [r.get("host_ms_per_decode_step")
                                                     for r in ranks],
                "cell_s_per_rank": [r["cell_s"] for r in ranks], "card": CARD}

    for name in ("bitplane-tp2", "bitplane-paged-tp2"):
        ranks = by_name[name]
        for r in ranks:
            tag = f"{name} rank {r['rank']}"
            _tp_tokens_gate(tag, r, controls[name], "the single-device cell")
            paged = name.endswith("paged-tp2")
            _tp_launch_gate(tag, r, cfg.n_layers if paged else 0)
            if not r["launches"]["plane_matmul_packed"]:
                _die(f"{tag}: no row-parallel projection launched plane_matmul_packed")
            if r["plane_cache_bytes"] > TP_BYTES_RATIO * p1_bytes:
                _die(f"{tag}: {r['plane_cache_bytes']} plane bytes on the rank against "
                     f"{p1_bytes} on one device (more than {TP_BYTES_RATIO} of them)")
        r0 = ranks[0]
        line = dict(common(name, ranks), layers=cfg.n_layers, tokens_equal_single_device=True,
                    single_device_eager_host_ms_per_decode_step=twins[name],
                    prefill_s_per_rank=[r["prefill_s"] for r in ranks],
                    tok_per_s_rank0=r0["tok_per_s"], wall_s_rank0=r0["wall_s"],
                    decode_steps=r0["decode_steps"],
                    plane_cache_bytes_per_rank=[r["plane_cache_bytes"] for r in ranks],
                    plane_cache_bytes_p1=p1_bytes,
                    bytes_ratio=max(r["plane_cache_bytes"] for r in ranks) / p1_bytes)
        if "load_s" in r0:  # the first cell: the rank's start-up and load
            line["load_s_rank0"] = r0["load_s"]
            line["rank0_started_s_after_spawn"] = r0["started"] - t0_wall
            line["memory_per_rank"] = [r["memory"] for r in ranks]
            line["load_peak_gb_p1"], line["resident_gb_p1"] = p1_memory
            load = {"check": "tp load, layer by layer", "ranks": TP_SIZE,
                    "layers": cfg.n_layers, "loader_per_rank": [r["loader"] for r in ranks],
                    "engine_load_per_rank": [r["memory"] for r in ranks],
                    "load_peak_gb_p1": p1_memory[0], "resident_gb_p1": p1_memory[1],
                    "card": CARD}
            print(json.dumps(load), flush=True)
            out["load"] = load
        print(json.dumps(line), flush=True)
        out[name] = line

    name = "bitplane-scrub-tp2"
    ranks = by_name[name]
    for r in ranks:
        tag = f"{name} rank {r['rank']}"
        _tp_tokens_gate(tag, r, controls[name], "bitplane-scrub (bitplane-nofused at 8 bits)")
        _tp_launch_gate(tag, r, packed=True)
        ig = r["integrity"]
        if (ig["audit_alarms"] < 1 or ig["scrubs"] != 1 or not r["fingerprint_restored"]
                or r["undetected"] or r["injected"] != (1 if r["rank"] == 1 else 0)):
            _die(f"{tag}: {r['injected']} injected, {r['undetected']} undetected, integrity "
                 f"{ig}, fingerprint restored {r['fingerprint_restored']}")
    out[name] = dict(common(name, ranks), spec=TP_SCRUB_SPEC + " on rank 1",
                     tokens_equal_single_device=True,
                     integrity_per_rank=[r["integrity"] for r in ranks],
                     scrub_s_per_rank=[r["scrub_s"] for r in ranks],
                     source_bytes_per_rank=[r["source_bytes"] for r in ranks],
                     quantized_tree_bytes_per_rank=[r["quantized_tree_bytes"] for r in ranks])
    print(json.dumps(out[name]), flush=True)

    name = "bitplane-autopilot-tp2"
    ranks, single = by_name[name], controls[name]
    for r in ranks:
        tag = f"{name} rank {r['rank']}"
        # the shed set too: the same requests fail with the same reasons
        _tp_tokens_gate(tag, r, single["tokens"], "bitplane-autopilot (each a static run of "
                        "its tier there)", failed=single["failed"])
        _tp_launch_gate(tag, r)
        mine = {k: r[k] for k in ("switches", "request_tiers", "shed")}
        if mine != {k: single[k] for k in mine}:
            _die(f"{tag}: switches, tiers or shed {mine} against the single device's "
                 f"{[single[k] for k in mine]}")
    out[name] = dict(common(name, ranks), tokens_equal_single_device=True,
                     schedule_equal_single_device=True,
                     switches=ranks[0]["switches"], shed=ranks[0]["shed"],
                     mixed_steps=ranks[0]["mixed_steps"],
                     shadow_probes=ranks[0]["shadow_probes"],
                     host_ms_split_per_rank=[r["host_ms_split"] for r in ranks],
                     single_device_host_ms=single["host_ms_per_decode_step"])
    print(json.dumps(out[name]), flush=True)

    cold_tunes = None
    for name in ("bitplane-autotune-tp2", "bitplane-autotune-warm-tp2"):
        ranks = by_name[name]
        for r in ranks:
            tag = f"{name} rank {r['rank']}"
            _tp_tokens_gate(tag, r, controls["bitplane-tp2"], "bitplane's")
            _tp_launch_gate(tag, r)
            st = r["store"]
            bad = (r["tiles"] != ranks[0]["tiles"] or not r["tiles"]
                   or r["keeps_store"] != (r["rank"] == 0) or r["store_files"] != ["plans.json"])
            if name.endswith("warm-tp2"):
                bad = bad or st["tunes"] or st["store_misses"] or st["store_hits"] != cold_tunes
            else:
                bad = bad or not st["tunes"] or st["store_hits"]
            if bad:
                _die(f"{tag}: store {st}, tiles {r['tiles']} against rank 0's "
                     f"{ranks[0]['tiles']}, keeps the store {r['keeps_store']}, files "
                     f"{r['store_files']}")
        cold_tunes = ranks[0]["store"]["tunes"]
        out[name] = dict(common(name, ranks), tokens_equal_bitplane=True,
                         tiles_equal_every_rank=True, store=ranks[0]["store"],
                         tiles=ranks[0]["tiles"])
        print(json.dumps(out[name]), flush=True)

    for name in TP_FAMILIES:
        ranks, twin = by_name[name], controls[name]
        for r in ranks:
            tag = f"{name} rank {r['rank']}"
            if name == "internvl2-patches-tp2":
                if not np.array_equal(np.asarray(r["tokens"]), twin["tokens"]):
                    _die(f"{tag}: tokens differ from the single-device eager twin's")
            else:
                _tp_tokens_gate(tag, r, twin["tokens"], "the single-device eager twin")
            _tp_launch_gate(tag, r)
        out[name] = dict(common(name, ranks), layers=ranks[0]["layers"],
                         tokens_equal_single_device_eager_twin=True,
                         twin_host_ms_per_decode_step=twin.get("host_ms_per_decode_step"),
                         twin_s=twin["s"], run_s_per_rank=[r["run_s"] for r in ranks])
        print(json.dumps(out[name]), flush=True)
    out["phase_s"] = time.perf_counter() - t0
    out["spawn_s"] = spawn_s
    return out


def _head_slices(cfg) -> dict:
    """The plain attention paths (which are not kernels) over one rank's
    heads at P = 2 and 4 against the whole heads, at granite's shapes:
    the decode path ``_decode_gqa`` on an int8 cache (4 slots, 272
    positions) and the prefill path ``_chunked_gqa`` (one 256-token bf16
    prompt). Each slice must give the whole's bits: a float32 reduction
    whose order followed the head count would let tensor-parallel tokens
    drift from one device's at near-ties."""
    from repro_torch.layers.attention import _chunked_gqa, _decode_gqa

    gen = torch.Generator(device="cuda").manual_seed(5)
    hq, hkv, d, b, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, N_SLOTS, PAGED_MAX_LEN

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = rnd(b, 1, hq, d).to(torch.bfloat16)
    kq = torch.randint(-127, 128, (b, s, hkv, d), generator=gen, device="cuda",
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (b, s, hkv, d), generator=gen, device="cuda",
                       dtype=torch.int8)
    ks, vs = rnd(b, s, hkv).abs() * 0.01, rnd(b, s, hkv).abs() * 0.01
    valid = torch.arange(s, device="cuda")[None, :] < torch.tensor(
        [[1], [37], [200], [272]], device="cuda")
    qp, kp, vp = (rnd(1, 256, h, d).to(torch.bfloat16) for h in (hq, hkv, hkv))
    whole = {"decode": _decode_gqa(q, kq, vq, valid, ks, vs),
             "prefill": _chunked_gqa(qp, kp, vp, causal=True, chunk=cfg.attn_chunk, q_offset=0)}
    out, unequal = {}, []
    for p in (2, 4):
        hs, ks_ = hq // p, hkv // p
        parts = {"decode": [], "prefill": []}
        for r in range(p):
            qh, kh = slice(r * hs, (r + 1) * hs), slice(r * ks_, (r + 1) * ks_)
            parts["decode"].append(_decode_gqa(q[:, :, qh], kq[:, :, kh], vq[:, :, kh], valid,
                                               ks[:, :, kh], vs[:, :, kh]))
            parts["prefill"].append(_chunked_gqa(qp[:, :, qh], kp[:, :, kh], vp[:, :, kh],
                                                 causal=True, chunk=cfg.attn_chunk, q_offset=0))
        for path, chunks in parts.items():
            got = torch.cat(chunks, dim=2)
            out[f"{path} P={p}"] = {"bit_equal": bool(torch.equal(got, whole[path])),
                                    "max_abs_diff": float((got - whole[path]).abs().max())}
            if not out[f"{path} P={p}"]["bit_equal"]:
                unequal.append(f"{path} P={p}")
    print(json.dumps({"check": "tp head slices of the plain attention paths", "results": out,
                      "card": CARD}), flush=True)
    if unequal:
        _die(f"tp head slices: {unequal} differ from the whole heads' attention")
    return out


def run_tp_phase(cfg, controls: dict, twins: dict) -> dict:
    """Phase 19: tp1-nccl in this process, the head slices, the families'
    single-device eager twins, then the gloo cells."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = _seed_params(cfg)
    nccl = run_tp_nccl(cfg, params, base)
    del params
    _head_slices(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    controls = dict(controls, **_tp_family_twins())
    twins_s = time.perf_counter() - t1
    out = run_tp(cfg, controls, nccl["plane_cache_bytes_p1"],
                 (nccl["load_peak_gb_p1"], nccl["resident_gb_p1"]), twins)
    out["tp1-nccl"] = nccl
    out["twins_s"] = twins_s
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- training on a (data x model) mesh (phase 20) ------------------------------

MESH_RANKS = 2  # gloo ranks sharing the one card, eager
MESH_STEPS = 3  # the last one traced (left out of the step times)
MESH_FIRST_RTOL = 1e-3  # first step: only the order of the sums differs
# the first step's grad norm: on the card one device scatter-adds the
# embedding's gradient rows in bf16 over all 2048 tokens, a data rank over
# its 1024 before the float32 reduce-scatter, which moves the whole norm
# by 3.8e-3 at (2,1)
MESH_GNORM_RTOL = 1e-2
MESH_RTOL = MESH_ATOL = 2e-2  # every step: the reference's bound between meshes
#: name -> (arch, depth, optimizer, model axis): the data axis is the rest
#: of the ranks; qwen3-moe at the reference's profile for it (Adafactor,
#: capacity factor 2.0: src/repro/launch/dryrun.py:72-74). granite runs 1
#: layer: train-fsdp2's gloo steps (whole float32 gradients through the
#: host) took 9-16 s each at 2 layers, and the smoke's margin under its
#: time limit
MESH_CELLS = {
    "train-fsdp2": ("granite-3-8b", 1, "adamw", 1),
    "train-tp2": ("granite-3-8b", 1, "adamw", 2),
    "train-ep2": ("qwen3-moe-235b-a22b", 1, "adafactor", 2),
}
MESH_COLLECTIVES = ("train.allgather", "train.reduce_scatter", "train.allreduce",
                    "moe.ep_gather", "moe.ep_combine")


def _mesh_run(arch, layers, opt, model_axis, device):
    """A TrainRun of a phase-20 cell (the same on every mesh and on one
    device): full width, ``layers`` deep, batch TRAIN_BATCH x TRAIN_SEQ."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainRun

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    return TrainRun(cfg=cfg, steps=MESH_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                    optimizer=opt, peak_lr=TRAIN_LR, log_every=1000, device=device,
                    model_axis=model_axis, gather_params=False, profile_step=MESH_STEPS - 1)


def _mesh_kept(log, group=None) -> int:
    """The copies the first MoE call of a run kept (summed over ``group``,
    the ranks holding its experts)."""
    import torch.distributed as dist

    s, n, dropped = log[0]
    d = dropped.to(torch.int64).reshape(1).clone()
    if group is not None:
        dist.all_reduce(d, group=group)
    return int(n) - int(d)


def _mesh_rank_cells(backend, device) -> list:
    """One rank of phase 20: every cell's TrainRun on its mesh of the
    world, as a rank of it; each rank's line per cell, gathered."""
    import torch.distributed as dist

    from repro_torch.layers import moe as tmoe

    mine = []
    for name, (arch, layers, opt, model_axis) in MESH_CELLS.items():
        run = _mesh_run(arch, layers, opt, model_axis, str(device))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        with tmoe.record_drops() as log:
            out = run.run()
        torch.cuda.synchronize()
        prof = run.timings["profile"]
        mine.append({
            "cell": name, "mesh": out["mesh"], "losses": out["losses"],
            "grad_norms": out["grad_norms"], "step_ms": run.timings["step_ms"],
            "traced_step_ms": prof["step_ms"],
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "resident_gb": run.timings["resident_bytes"] / 2**30,
            "collectives_device_ms": {k: prof["device_ms"][k] for k in MESH_COLLECTIVES},
            "collectives_host_ms": {k: prof["host_ms"][k] for k in MESH_COLLECTIVES},
            "step_parts_device_ms": {k: prof["device_ms"][k] for k in
                                     ("train.grads", "train.clip", "train.update")},
            "kernels_ms": prof["kernels_ms"],
            "kept_first_call": _mesh_kept(log, dist.group.WORLD) if log else None,
            "kernel_launches": _read_counts(), "cell_s": time.perf_counter() - t0,
        })
        del out, log
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def run_mesh_training() -> dict:
    """Phase 20, training on a (data x model) mesh: ``MESH_RANKS`` gloo
    ranks sharing this card (eager) train each of ``MESH_CELLS`` through
    ``TrainRun`` on its mesh; the same TrainRun on one device in this
    process is the control. Gates: every loss finite; the first step's loss
    within MESH_FIRST_RTOL and grad norm within MESH_GNORM_RTOL of one
    device's, every step's within the reference's bound; train-ep2 (data 1:
    one device's capacity) keeps as many copies in its first MoE call as
    one device; no rank launches the port's kernels. Prints a line per
    cell: the step ms (median), each rank's card peak and resident memory
    beside one device's, the collectives' device and host ms of the traced
    step, and the losses."""
    from repro_torch.launch import mesh
    from repro_torch.layers import moe as tmoe

    t0 = time.perf_counter()
    controls = {}
    for name, (arch, layers, opt, _) in MESH_CELLS.items():
        key = (arch, layers, opt)
        if key in controls:
            continue
        run = _mesh_run(arch, layers, opt, 1, "cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tmoe.record_drops() as log:
            out = run.run()
        torch.cuda.synchronize()
        controls[key] = {
            "losses": out["losses"], "grad_norms": out["grad_norms"],
            "step_ms_median": float(np.median(run.timings["step_ms"])),
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "resident_gb": run.timings["resident_bytes"] / 2**30,
            "kept_first_call": _mesh_kept(log) if log else None,
        }
        del out, log, run
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    every = mesh.spawn_ranks(_mesh_rank_cells, MESH_RANKS, device="cuda", share_device=True)
    spawn_s = time.perf_counter() - t1
    cells = {}
    for i, name in enumerate(MESH_CELLS):
        arch, layers, opt, model_axis = MESH_CELLS[name]
        ctl = controls[(arch, layers, opt)]
        ranks_ = [lines[i] for lines in every]
        r0 = ranks_[0]
        losses, gn = r0["losses"], r0["grad_norms"]
        if any(r["losses"] != losses for r in ranks_):
            _die(f"{name}: the ranks report different losses {[r['losses'] for r in ranks_]}")
        if not np.isfinite(losses).all():
            _die(f"{name}: a loss is not finite: {losses}")
        rel0 = abs(losses[0] - ctl["losses"][0]) / abs(ctl["losses"][0])
        grel0 = abs(gn[0] - ctl["grad_norms"][0]) / abs(ctl["grad_norms"][0])
        if rel0 > MESH_FIRST_RTOL or grel0 > MESH_GNORM_RTOL:
            _die(f"{name}: first step loss {losses[0]} / grad norm {gn[0]} against one "
                 f"device's {ctl['losses'][0]} / {ctl['grad_norms'][0]}")
        if not np.allclose(losses, ctl["losses"], rtol=MESH_RTOL, atol=MESH_ATOL):
            _die(f"{name}: losses {losses} against one device's {ctl['losses']}")
        if any(any(r["kernel_launches"].values()) for r in ranks_):
            _die(f"{name}: training launched the port's kernels "
                 f"{[r['kernel_launches'] for r in ranks_]}")
        line = {
            "mesh_cell": name, "card": CARD, "arch": arch, "layers": layers,
            "optimizer": opt, "mesh": r0["mesh"], "ranks": MESH_RANKS, "backend": "gloo",
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": MESH_STEPS,
            "losses": losses, "one_device_losses": ctl["losses"],
            "grad_norms": gn, "one_device_grad_norms": ctl["grad_norms"],
            "first_loss_rel": rel0, "first_gnorm_rel": grel0,
            "step_ms_median": float(np.median(r0["step_ms"])),
            "one_device_step_ms_median": ctl["step_ms_median"],
            "peak_gb_per_rank": [r["peak_gb"] for r in ranks_],
            "resident_gb_per_rank": [r["resident_gb"] for r in ranks_],
            "one_device_peak_gb": ctl["peak_gb"], "one_device_resident_gb": ctl["resident_gb"],
            "traced_step_ms_per_rank": [r["traced_step_ms"] for r in ranks_],
            "collectives_device_ms_per_rank": [r["collectives_device_ms"] for r in ranks_],
            "collectives_host_ms_per_rank": [r["collectives_host_ms"] for r in ranks_],
            "step_parts_device_ms_per_rank": [r["step_parts_device_ms"] for r in ranks_],
            "kernels_ms_per_rank": [r["kernels_ms"] for r in ranks_],
            "kernel_launches": [r["kernel_launches"] for r in ranks_],
            "cell_s_per_rank": [r["cell_s"] for r in ranks_],
        }
        if arch.startswith("qwen3"):
            line["kept_first_call"] = r0["kept_first_call"]
            line["one_device_kept_first_call"] = ctl["kept_first_call"]
            if r0["kept_first_call"] != ctl["kept_first_call"]:
                _die(f"{name}: the first MoE call kept {r0['kept_first_call']} copies, one "
                     f"device {ctl['kept_first_call']}")
        cells[name] = line
        print(json.dumps(line), flush=True)
    cells["spawn_s"] = spawn_s
    cells["phase_s"] = time.perf_counter() - t0
    return cells


# -- the analysis layer (phase 21) ---------------------------------------------

# the cost report's predictions against the card's measurements (PERF.md,
# written before the first chip run): the train step's predicted peak and
# resident bytes within these shares of max_memory_allocated and of
# TrainRun's resident; a step's bound never above its measured time
ANALYSIS_PEAK_RTOL = 0.15
ANALYSIS_RESIDENT_RTOL = 0.05
SA_DOT_VALUES = 1000  # the paper's §IV-A protocol: random dot products of 1000 values
SA_DOTS = 1000


def _wrapped(t: torch.Tensor) -> torch.Tensor:
    """int64 values modulo 2^32 as int32 (the simulated accumulator's range)."""
    return (((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def check_systolic() -> dict:
    """Phase 21 (a): the paper's §IV-A protocol for the cycle-accurate
    simulator on the card: every pair of 8-bit values, both variants;
    ``SA_DOTS`` random 16-bit dot products of ``SA_DOT_VALUES`` values;
    ``serial_sa_matmul`` on a 64 x 16 array. Each result must equal the
    exact integer product (modulo 2^32: the int32 accumulator) and the
    same call on the CPU; the cycles must follow Eq. 8."""
    from repro_torch.core import systolic as sa

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(21)
    vals = torch.arange(-128, 128, dtype=torch.int32)
    mc, ml = (t[..., None] for t in torch.meshgrid(vals, vals, indexing="ij"))
    a16 = torch.randint(-(1 << 15), 1 << 15, (SA_DOTS, SA_DOT_VALUES), generator=gen,
                        dtype=torch.int32)
    b16 = torch.randint(-(1 << 15), 1 << 15, (SA_DOTS, SA_DOT_VALUES), generator=gen,
                        dtype=torch.int32)
    cfg = sa.SAConfig(64, 16)
    am = torch.randint(-(1 << 15), 1 << 15, (cfg.height, 100), generator=gen, dtype=torch.int32)
    bm = torch.randint(-(1 << 15), 1 << 15, (100, cfg.width), generator=gen, dtype=torch.int32)
    cases = []  # (name, card call, cpu call, exact, cycles expected)
    for variant in ("booth", "sbmwc"):
        cases.append((f"pairs8_{variant}",
                      lambda v=variant: sa.serial_mac_dot(mc.to(dev), ml.to(dev), 8, v),
                      lambda v=variant: sa.serial_mac_dot(mc, ml, 8, v),
                      (mc * ml)[..., 0], sa.bitsmm_dot_cycles(8, 1)))
        cases.append((f"dots16_{variant}",
                      lambda v=variant: sa.serial_mac_dot(a16.to(dev), b16.to(dev), 16, v),
                      lambda v=variant: sa.serial_mac_dot(a16, b16, 16, v),
                      _wrapped((a16.long() * b16.long()).sum(dim=-1)),
                      sa.bitsmm_dot_cycles(16, SA_DOT_VALUES)))
        cases.append((f"sa_matmul_64x16_{variant}",
                      lambda v=variant: sa.serial_sa_matmul(am.to(dev), bm.to(dev), 16, cfg, v),
                      lambda v=variant: sa.serial_sa_matmul(am, bm, 16, cfg, v),
                      _wrapped(am.long() @ bm.long()),
                      sa.bitsmm_dot_cycles(16, 100) + cfg.n_macs))
    out = {"analysis": "systolic", "card": CARD, "cases": {}}
    for name, card, cpu, exact, cycles in cases:
        got, cyc = card()
        torch.cuda.synchronize()
        host, cyc_host = cpu()
        got = got.cpu()
        ok = torch.equal(got, exact) and torch.equal(got, host) and cyc == cyc_host == cycles
        out["cases"][name] = {"results": int(got.numel()), "equal_exact": torch.equal(got, exact),
                              "equal_cpu": torch.equal(got, host), "cycles": cyc,
                              "eq8_cycles": cycles}
        if not ok:
            _die(f"phase 21: the systolic simulator's {name} on the card: "
                 f"{out['cases'][name]}")
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return out


def _dry_decode_report(cfg):
    """The cost report of phase 3's ``bitplane`` decode step (its engine's
    config: 8-bit Booth bit planes, int8 KV of ``N_SLOTS`` slots of the
    workload's max length), run on meta tensors: a prediction, no card."""
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch import cost
    from repro_torch.launch.steps import make_cb_decode_step
    from repro_torch.models.cache import init_cache
    from repro_torch.models.quant import quantize_params
    from repro_torch.models.transformer import init_params

    policy = PrecisionPolicy.uniform(8, 8, variant="booth", level="bitplane")
    meta = torch.device("meta")
    params = quantize_params(init_params(cfg, torch.Generator(), device=meta), policy, cfg=cfg,
                             plane_cache=True)
    cache = init_cache(cfg, N_SLOTS, max(PROMPT_LENS) + GEN_TOKENS, cfg.dtype, kv_quant=True,
                       device=meta)
    tokens = torch.empty((N_SLOTS, 1), dtype=torch.int32, device=meta)
    temps = torch.empty((N_SLOTS,), dtype=torch.float32, device=meta)
    with cost.report(resident={"params": params, "cache": cache},
                     inputs=(tokens, temps)) as rep:
        make_cb_decode_step(cfg, policy)(params, cache, tokens, temps)
    return rep


def _dry_train_report(cfg):
    """The cost report of phase 18's ``train-dense`` step (TrainRun's:
    AdamW, the reference's tree, batch ``TRAIN_BATCH`` x ``TRAIN_SEQ``),
    run on meta tensors: a prediction, no card."""
    from repro_torch.launch import cost
    from repro_torch.launch.inputs import batch_struct
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.models.transformer import init_params, stack_layers
    from repro_torch.optim import OptimConfig

    meta = torch.device("meta")
    opt = OptimConfig(kind="adamw", peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
    params = stack_layers(cfg, init_params(cfg, torch.Generator(), device=meta))
    state = init_opt_state(cfg, opt, params)
    batch = {k: torch.empty(s, dtype=d, device=meta)
             for k, (s, d) in batch_struct(cfg, TRAIN_BATCH, TRAIN_SEQ, "train").items()}
    with cost.report(resident={"params": params, "opt": state}, inputs=batch) as rep:
        make_train_step(cfg, opt)(params, state, batch, 0)
    return rep


def run_analysis(cfg, eng_bit: dict, train_dense: dict) -> dict:
    """Phase 21: the analysis layer. (a) the systolic simulator on the
    card; (b) the cost report of phase 3's ``bitplane`` decode step against
    the device ms a decode step phase 3 measured: its bound / the
    measurement <= 1; (c) the cost report of phase 18's ``train-dense``
    step: the predicted peak within ``ANALYSIS_PEAK_RTOL`` of the measured
    ``max_memory_allocated``, the predicted resident within
    ``ANALYSIS_RESIDENT_RTOL`` of TrainRun's, the bound no greater than the
    measured median step."""
    t0 = time.perf_counter()
    out = {"systolic": check_systolic()}
    rep = _dry_decode_report(cfg)
    bound_ms, by = rep.bound()
    device_ms = eng_bit["device_ms_per_decode_step"]
    line = {"analysis": "bitplane_decode_cost", "card": CARD, "layers": cfg.n_layers,
            "predicted": {"flops": rep.flops, "int8_ops": rep.int8_ops,
                          "hbm_bytes": rep.hbm_bytes, "calls": rep.calls,
                          "resident_bytes": rep.resident_bytes, "peak_bytes": rep.peak_bytes},
            "bound_ms": bound_ms, "bottleneck": by,
            "device_ms_per_decode_step": device_ms, "share": bound_ms / device_ms}
    print(json.dumps(line), flush=True)
    if not line["share"] <= 1.0:
        _die(f"phase 21: the bitplane decode step's bound {bound_ms:.4f} ms exceeds its "
             f"measured {device_ms:.4f} device ms: the count is wrong")
    out["bitplane_decode_cost"] = line
    rep = _dry_train_report(cfg)
    bound_ms, by = rep.bound()
    peak = train_dense["peak_memory_gb"] * 1e9
    resident = train_dense["resident_bytes"]
    step_ms = train_dense["step_ms_median"]
    line = {"analysis": "train_dense_cost", "card": CARD, "layers": cfg.n_layers,
            "predicted": {"flops": rep.flops, "hbm_bytes": rep.hbm_bytes,
                          "resident_bytes": rep.resident_bytes, "peak_bytes": rep.peak_bytes,
                          "top": rep.top[:5]},
            "bound_ms": bound_ms, "bottleneck": by,
            "measured": {"peak_bytes": peak, "resident_bytes": resident,
                         "step_ms_median": step_ms},
            "peak_ratio": rep.peak_bytes / peak, "resident_ratio": rep.resident_bytes / resident,
            "share": bound_ms / step_ms}
    print(json.dumps(line), flush=True)
    if abs(line["peak_ratio"] - 1.0) > ANALYSIS_PEAK_RTOL:
        _die(f"phase 21: train-dense predicted peak {rep.peak_bytes / 1e9:.3f} GB against "
             f"{peak / 1e9:.3f} measured, beyond {ANALYSIS_PEAK_RTOL:.0%}")
    if abs(line["resident_ratio"] - 1.0) > ANALYSIS_RESIDENT_RTOL:
        _die(f"phase 21: train-dense predicted resident {rep.resident_bytes / 1e9:.3f} GB "
             f"against {resident / 1e9:.3f} measured, beyond {ANALYSIS_RESIDENT_RTOL:.0%}")
    if not line["share"] <= 1.0:
        _die(f"phase 21: train-dense bound {bound_ms:.2f} ms exceeds its measured median "
             f"step {step_ms:.2f} ms: the count is wrong")
    out["train_dense_cost"] = line
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- the paper's four example scenarios (phase 22) -----------------------------

#: the two trainer runs of phase 22, each the script's command line in a
#: process of its own, started before phase 19 and run beside phases 19-21
#: (their steps host-bound, the card idle through most of the gloo phases):
#: --model-100m at its default 300 steps, and tiny_7m at 8-bit QAT
EXAMPLE_TRAINERS = {"train_tiny_lm --model-100m": ["--model-100m"],
                    "train_tiny_lm --qat-bits 8": ["--qat-bits", "8", "--steps", "100"]}
EXAMPLE_TRAINER_TIMEOUT_S = 600
#: the plan route each sweep row takes on the kernel route and on the plain
#: one (``backend="torch"``), and the kernel it launches: 16 bits, the
#: runtime dial, and 1-8 bits with the mixed policy
SWEEP_ROUTES = {"w16": ("oracle", "oracle", None),
                "dial": ("fused_cached", "cached_scan", "fused_plane_linear"),
                "digit": ("staged", "oracle", "plane_matmul")}
#: each serve_quantized engine's kernel on the card (none on the dense one)
SERVE_KERNELS = {"booth-bitplane-w8": "fused_plane_linear",
                 "booth-bitplane-w6": "fused_plane_linear",
                 "booth-bitplane-w4": "fused_plane_linear",
                 "booth-digit": "plane_matmul", "sbmwc-bitplane": "fused_plane_linear"}


def _example_section(name, fn) -> tuple:
    """``fn()`` with the plan registry cleared (the script's registry report
    is the section's own) and every launch count set to 0 just before it
    and read just after: (its result, launches, route calls, seconds). A
    failed assert of the script fails the run."""
    from repro_torch.core import plan as plan_mod

    gc.collect()
    torch.cuda.empty_cache()
    plan_mod.DEFAULT_REGISTRY.clear()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        out = fn()
    except AssertionError as e:
        _die(f"phase 22 {name}: the script's assert failed: {e}")
    torch.cuda.synchronize()
    return out, _read_counts(), dict(plan_mod.DEFAULT_REGISTRY.calls), time.perf_counter() - t0


def _plain_twin(name, fn) -> dict:
    """The section again on the plain route (``backend="torch"``), which
    must launch no kernel."""
    out, counts, routes, _ = _example_section(f"{name} (plain route)", fn)
    if any(counts.values()):
        _die(f"phase 22 {name}: the plain route launched kernels {counts}")
    return out


def _only(name, launches: dict, kernel) -> None:
    """``kernel`` (None: no kernel) and no other launched in ``launches``."""
    others = {k: v for k, v in launches.items() if k != kernel and v}
    if others or (kernel and not launches.get(kernel)):
        _die(f"phase 22 {name}: launches {launches}, expected {kernel} alone")


def _example_quickstart(cfg, params) -> dict:
    from repro_torch.examples import quickstart

    qs, counts, routes, secs = _example_section(
        "quickstart", lambda: quickstart.quickstart(cfg, params, "cuda"))
    plain = _plain_twin("quickstart", lambda: quickstart.quickstart(cfg, params, "cuda",
                                                                      backend="torch"))
    _only("quickstart", counts, "plane_matmul")
    if set(routes) != {"staged"} or counts["plane_matmul"] != routes["staged"]:
        _die(f"phase 22 quickstart: routes {routes} against launches {counts}")
    for k in ("dense", "quant"):
        if not torch.equal(qs[k], plain[k]):
            _die(f"phase 22 quickstart §4: the {k} logits differ from the plain route's "
                 f"(max |d| {float((qs[k].float() - plain[k].float()).abs().max())})")
    line = {"example": "quickstart", "card": CARD, "layers": cfg.n_layers,
            "exact": all(qs["exact"].values()), "mac": qs["mac"],
            "gops": {f"{c}x{r}": g for (c, r), g in qs["gops"].items()},
            "rel_l1": qs["rel_l1"], "rel_l1_plain": plain["rel_l1"],
            "logits_equal_plain": True, "launches": counts, "routes": routes,
            "section_s": secs}
    print(json.dumps(line), flush=True)
    return line


def _example_serve(cfg, params) -> dict:
    from repro_torch.examples import serve_quantized

    sq, counts, routes, secs = _example_section(
        "serve_quantized", lambda: serve_quantized.serve_quantized(cfg, params, "cuda"))
    audit = sq["truncation_audit"]
    t_plain = time.perf_counter()
    plain = _plain_twin("serve_quantized", lambda: serve_quantized.serve_quantized(
        cfg, params, "cuda", backend="torch"))
    plain_s = time.perf_counter() - t_plain
    for name, toks in sq["tokens"].items():
        if not torch.equal(toks, plain["tokens"][name]):
            _die(f"phase 22 serve_quantized {name}: tokens differ from the plain route's")
        _only(f"serve_quantized {name}", sq["launches"][name], SERVE_KERNELS.get(name))
    if not (sq["sbmwc_eq_booth"] and sq["digit_eq_bitplane"]):
        _die("phase 22 serve_quantized: sbmwc == booth or digit == bitplane failed")
    if not audit["truncated_ok"] or audit["routes"] != ["fused_cached"]:
        _die(f"phase 22 serve_quantized: truncation audit {audit}")
    line = {"example": "serve_quantized", "card": CARD, "layers": cfg.n_layers,
            "batch": 4, "prompt_len": 32, "gen": 24,
            "tok_per_s": sq["tok_per_s"], "plain_tok_per_s": plain["tok_per_s"],
            "agreement": sq["agreement"], "sbmwc_eq_booth": True, "digit_eq_bitplane": True,
            "tokens_equal_plain": True, "registry": sq["registry"],
            "plain_registry": plain["registry"], "truncation_audit": audit,
            "routes": sq["routes"], "launches": sq["launches"],
            "plain_routes": plain["routes"], "section_s": secs, "plain_s": plain_s}
    print(json.dumps(line), flush=True)
    line["all_launches"] = counts
    return line


def _example_sweep(cfg, params) -> dict:
    from repro_torch.examples import precision_sweep

    scfg = precision_sweep.sweep_config(cfg)
    sw, counts, routes, secs = _example_section(
        "precision_sweep", lambda: precision_sweep.precision_sweep(scfg, params, "cuda"))
    plain = _plain_twin("precision_sweep", lambda: precision_sweep.precision_sweep(
        scfg, params, "cuda", backend="torch"))
    audit = sw["truncation_audit"]
    for name, logits in sw["logits"].items():
        other = plain["logits"][name]
        if not torch.equal(logits, other):
            _die(f"phase 22 precision_sweep {name}: logits differ from the plain route's "
                 f"(max |d| {float((logits.float() - other.float()).abs().max())})")
        if name == "dense":
            continue
        row = "w16" if name == "w16" else "dial" if name.startswith("dial") else "digit"
        route, plain_route, kernel = SWEEP_ROUTES[row]
        if set(sw["routes"][name]) != {route} or set(plain["routes"][name]) != {plain_route}:
            _die(f"phase 22 precision_sweep {name}: routes {sw['routes'][name]}, plain "
                 f"{plain['routes'][name]}; expected {route}, {plain_route}")
        _only(f"precision_sweep {name}", sw["launches"][name], kernel)
    if not audit["truncated_ok"] or audit["routes"] != ["fused_cached"]:
        _die(f"phase 22 precision_sweep: truncation audit {audit}")
    line = {"example": "precision_sweep", "card": CARD, "layers": scfg.n_layers,
            "scan_layers": scfg.scan_layers, "kl": sw["kl"], "kl_plain": plain["kl"],
            "cycles": sw["cycles"], "logits_equal_plain": True, "registry": sw["registry"],
            "truncation_audit": audit, "routes": sw["routes"], "launches": sw["launches"],
            "tf32": torch.backends.cuda.matmul.allow_tf32, "section_s": secs}
    print(json.dumps(line), flush=True)
    line["all_launches"] = counts
    return line


def _trainer_child(argv_json: str) -> None:
    """A trainer run of phase 22 in its own process: the script's ``main``
    on its command line (a checkpoint directory appended), with every
    launch count set to 0 just before and read just after; prints one JSON
    line with the run's numbers."""
    from repro_torch.examples import train_tiny_lm

    argv = json.loads(argv_json)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    tr = train_tiny_lm.main(argv)
    torch.cuda.synchronize()
    print(json.dumps({
        "child_s": time.perf_counter() - t0, "launches": _read_counts(),
        "steps": len(tr["losses"]), "loss_first10": tr["first"], "loss_last10": tr["last"],
        "steps_per_s": tr["steps_per_s"],
        "step_ms_median": float(np.median(tr["timings"]["step_ms"])),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "saves": tr["timings"]["saves"]}), flush=True)


def start_example_trainers() -> dict:
    """Start phase 22's trainer runs (``EXAMPLE_TRAINERS``), each in a child
    process with its checkpoints and output under a temp dir; they are
    collected by ``run_examples`` and killed if this process ends first."""
    import atexit
    import tempfile

    where = tempfile.mkdtemp(prefix="chip_smoke_trainers_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for i, (name, argv) in enumerate(EXAMPLE_TRAINERS.items()):
        log = open(os.path.join(where, f"trainer{i}.log"), "w+")
        args = json.dumps(argv + ["--ckpt", os.path.join(where, f"ckpt{i}")])
        proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke._trainer_child({args!r})"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        out[name] = (proc, log, time.perf_counter())
    out["dir"] = where
    return out


def _example_trainers(trainers: dict) -> dict:
    """Wait for the trainer runs: each must exit 0 (its script asserts the
    loss falls) having launched no kernel (fake quant: a plain bf16 matmul,
    as the reference's)."""
    import shutil

    lines = {}
    for name in EXAMPLE_TRAINERS:
        proc, log, started = trainers[name]
        t0 = time.perf_counter()
        try:
            rc = proc.wait(timeout=EXAMPLE_TRAINER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            _die(f"phase 22 {name}: no end within {EXAMPLE_TRAINER_TIMEOUT_S} s")
        log.seek(0)
        text = log.read()
        log.close()
        print("\n".join(l for l in text.splitlines() if l.startswith("[tiny-lm]")), flush=True)
        if rc != 0:
            _die(f"phase 22 {name}: exit {rc}: {text[-2000:]}")
        res = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
        _only(name, res["launches"], None)
        line = {"example": name, "card": CARD, **res,
                "beside": "phases 19-21 (their gloo ranks and the analysis) in this call",
                "wall_s": time.perf_counter() - started, "waited_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines[name] = line
    shutil.rmtree(trainers["dir"], ignore_errors=True)
    return lines


def run_examples(trainers: dict) -> dict:
    """Phase 22: the paper's four example scenarios (``repro_torch.examples``)
    on the card, each function called as its script calls it, on phase 3's
    granite-3-8b (full width, ``LAYERS`` deep, seed 0), and again on the
    plain route: quickstart (§1-3 on the card's tensors; §4's logits equal
    the plain route's, row 3 alone launched); serve_quantized at its
    defaults (every engine's tokens equal its plain twin's, ``sbmwc ==
    booth`` and ``digit == bitplane``, the dial's plans truncating the
    stored planes; row 1 on the bit-plane engines, row 3 on the digit one);
    precision_sweep unrolled (every policy's logits equal the plain
    route's: 1-8 bits and the mixed policy through row 3, the dial through
    row 1, 16 bits on the float32 oracle); then the trainer runs started by
    ``start_example_trainers`` (train_tiny_lm --model-100m, 300 steps with
    checkpoints, and tiny_7m --qat-bits 8, 100 steps), whose loss must
    fall. Launch counts are set to 0 just before each section."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    out = {"quickstart": _example_quickstart(cfg, params),
           "serve_quantized": _example_serve(cfg, params),
           "precision_sweep": _example_sweep(cfg, params)}
    del params
    out.update(_example_trainers(trainers))
    out["launches"] = {name: sec.get("all_launches", sec["launches"])
                       for name, sec in out.items()}
    out["phase_s"] = time.perf_counter() - t0
    return out


def main() -> None:
    if not torch.cuda.is_available():
        _die("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    global CARD
    CARD = smi
    print(smi, flush=True)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build_s = _build.build_all()
    print(f"[chip_smoke] build: {build_s:.1f} s (sources {', '.join(_build.SOURCES)})", flush=True)

    check_sass()
    summary: dict = {}
    check_kernels(summary)
    check_kernel_cases(summary)
    check_any_pair_weights(summary)
    print(f"[chip_smoke] kernel checks done at {time.perf_counter() - t0:.1f} s", flush=True)
    dense_launches = count_dense_entry_point(*check_attention(summary))
    print(f"[chip_smoke] attention kernel checks done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    full = get_config("granite-3-8b")
    cfg = dataclasses.replace(full, n_layers=LAYERS)
    print(f"[chip_smoke] model: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}); depth cut {full.n_layers} -> {cfg.n_layers} layers", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    eng_bit, res_bit, res_plain = run_engine(
        "bitplane", cfg, params, "fused_plane_linear", "fused_cached")
    print(f"[chip_smoke] engine bitplane done at {time.perf_counter() - t0:.1f} s", flush=True)
    t_tune = time.perf_counter()
    tuned_rows = check_tuned_kernels()
    front_door = check_front_door()
    eng_tune = run_autotune(cfg, params, res_bit)
    cold, warm = eng_tune["bitplane-autotune"], eng_tune["bitplane-autotune-warm"]
    print(f"[chip_smoke] autotune done at {time.perf_counter() - t0:.1f} s (phase "
          f"{time.perf_counter() - t_tune:.1f} s; cold {cold['store']['tunes']} tunes, warm "
          f"{warm['store']['store_hits']} store hits; decode graph replay device ms "
          f"{eng_tune['replay']['tuned_device_ms']:.3f} tuned against "
          f"{eng_tune['replay']['untuned_device_ms']:.3f} untuned)", flush=True)
    eng_dig, _, _ = run_engine("digit", cfg, params, "plane_matmul", "cached_planes")
    print(f"[chip_smoke] engine digit done at {time.perf_counter() - t0:.1f} s", flush=True)
    eng_nof, res_nof, res_nof8 = run_nofused(cfg, params, res_bit, res_plain)
    print(f"[chip_smoke] engine bitplane-nofused done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    eng_det = run_detect(cfg, params, eng_nof, res_nof, summary)
    print(f"[chip_smoke] engine bitplane-detect done at {time.perf_counter() - t0:.1f} s "
          f"(detect adds {eng_det['overhead_wall_s']:.3f} s wall, "
          f"{eng_det['overhead_decode_step_ms']:.2f} ms per decode step)", flush=True)
    eng_pag, res_pag = run_paged(cfg, params)
    rp = eng_pag["replay"]
    print(f"[chip_smoke] engine bitplane-paged done at {time.perf_counter() - t0:.1f} s "
          f"({eng_pag['tok_per_s']:.2f} tok/s; replay max|dlogit| {rp['max_abs_dlogit']:.4g}, "
          f"least margin {rp['least_plain_top2_margin']:.4g}, {rp['near_ties']} near ties)",
          flush=True)
    eng_scr, eng_ret = run_scrub(cfg, params, res_nof8, eng_det)
    print(f"[chip_smoke] engines bitplane-scrub and bitplane-scrub-retry done at "
          f"{time.perf_counter() - t0:.1f} s ({eng_scr['detected'][0]}/{eng_scr['detected'][1]} "
          f"detected, {eng_scr['integrity_faulted']['scrubs']} scrubs; "
          f"{eng_ret['integrity_faulted']['step_retries']} step retries)", flush=True)
    eng_pdet, eng_pscr = run_paged_integrity(cfg, params, res_pag)
    print(f"[chip_smoke] engines bitplane-paged-detect and bitplane-paged-scrub done at "
          f"{time.perf_counter() - t0:.1f} s ({eng_pscr['integrity_faulted']['page_faults']} "
          f"page faults, {eng_pscr['integrity_faulted']['requeued']} requeued)", flush=True)
    for paged in (False, True):
        eng_ap = run_autopilot(cfg, params, paged)
        if not paged:
            ap_single = eng_ap
        print(f"[chip_smoke] engine {eng_ap['engine']} done at {time.perf_counter() - t0:.1f} s "
              f"({eng_ap['finished']} finished, {eng_ap['shed']} shed, tiers "
              f"{sorted(set(eng_ap['request_tiers'].values()))}, {eng_ap['mixed_steps']} "
              f"mixed-tier steps)", flush=True)
    eng_w16 = run_digit16(cfg, params, summary)
    print(f"[chip_smoke] engine digit-w16 done at {time.perf_counter() - t0:.1f} s "
          f"({eng_w16['host_ms_per_decode_step']:.2f} host ms per decode step)", flush=True)
    eng_lock = run_lockstep(cfg, params)
    print(f"[chip_smoke] engine lockstep done at {time.perf_counter() - t0:.1f} s "
          f"({eng_lock['decode_tok_per_s'][0]:.1f} decode tok/s)", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    fam = run_families()
    print(f"[chip_smoke] SSM and hybrid families done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    archs = run_architectures()
    print(f"[chip_smoke] MoE, VLM and encoder architectures done at "
          f"{time.perf_counter() - t0:.1f} s (phase {archs['phase_s']:.1f} s)", flush=True)
    train = run_training()
    print(f"[chip_smoke] training done at {time.perf_counter() - t0:.1f} s (phase "
          f"{train['phase_s']:.1f} s; step ms dense {train['train-dense']['step_ms_median']:.1f}, "
          f"qat8 {train['train-qat8']['step_ms_median']:.1f})", flush=True)
    trainers = start_example_trainers()  # phase 22's trainer runs, beside phases 19-21
    tp = run_tp_phase(
        cfg, {"bitplane-tp2": res_bit, "bitplane-paged-tp2": res_pag,
              "bitplane-scrub-tp2": res_nof8, "bitplane-autopilot-tp2": ap_single},
        {"bitplane-tp2": eng_bit["eager"]["host_ms_per_decode_step"],
         "bitplane-paged-tp2": eng_pag["eager"]["host_ms_per_decode_step"]})
    print(f"[chip_smoke] tensor-parallel serving done at {time.perf_counter() - t0:.1f} s "
          f"(phase {tp['phase_s']:.1f} s, spawn {tp['spawn_s']:.1f} s)", flush=True)
    meshed = run_mesh_training()
    print(f"[chip_smoke] mesh training done at {time.perf_counter() - t0:.1f} s (phase "
          f"{meshed['phase_s']:.1f} s, spawn {meshed['spawn_s']:.1f} s; step ms "
          + ", ".join(f"{n} {c['step_ms_median']:.1f}" for n, c in meshed.items()
                      if isinstance(c, dict)) + ")", flush=True)
    analysis = run_analysis(cfg, eng_bit, train["train-dense"])
    print(f"[chip_smoke] analysis done at {time.perf_counter() - t0:.1f} s (phase "
          f"{analysis['phase_s']:.1f} s; bound / measured: bitplane decode "
          f"{analysis['bitplane_decode_cost']['share']:.3f}, train-dense "
          f"{analysis['train_dense_cost']['share']:.3f}; train-dense peak predicted / measured "
          f"{analysis['train_dense_cost']['peak_ratio']:.3f})", flush=True)
    examples = run_examples(trainers)
    big = examples["train_tiny_lm --model-100m"]
    print(f"[chip_smoke] examples done at {time.perf_counter() - t0:.1f} s (phase "
          f"{examples['phase_s']:.1f} s; 100M: {big['steps_per_s']:.2f} steps/s, peak "
          f"{big['peak_memory_gb']:.2f} GB, waited {big['waited_s']:.1f} s)", flush=True)

    def fam_launches(kernel):
        """The kernel's launches in each family cell's counted run."""
        return {name: c["all_launches"][kernel] for name, c in fam.items()
                if c["all_launches"].get(kernel)}

    def entry(name, source, replaces, lines, launches):
        rep = lines[0]  # decode gate projection, M=4: the most frequent main-path call
        errs = [max(l.get("epilogue_max_abs_err", 0.0), l.get("trunc4_max_abs_err", 0.0),
                    l.get("max_abs_err", 0.0)) for l in lines]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(errs),
            "ms": rep["kernel_ms"], "device_ms": rep["device_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "shape": f"{rep['shape']} M={rep['M']} K={rep['K']} N={rep['N']}",
        }

    kernels = [
        entry("fused_plane_linear", "src/repro_torch/kernels/csrc/plane_mm_fused.cu",
              "src/repro/kernels/plane_mm_fused.py:168", summary["fused_plane_linear"],
              eng_bit["launches"]),
        entry("plane_matmul", "src/repro_torch/kernels/csrc/plane_mm.cu",
              "src/repro/kernels/plane_mm.py:62", summary["plane_matmul"],
              eng_dig["launches"]),
        entry("plane_matmul_packed", "src/repro_torch/kernels/csrc/plane_mm_packed.cu",
              "src/repro/kernels/plane_mm_packed.py:160", summary["plane_matmul_packed"],
              eng_nof["launches"]),
    ]

    def attn_entry(name, replaces, rep, lines, launches, path, source):
        return {
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(l["max_abs_err"] for l in lines),
            "ms": rep["kernel_ms"], "device_ms": rep["device_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "shape": rep["check"], "path": path,
        }

    paged_lines, dense_lines = summary["paged_flash_attention"], summary["flash_attention"]
    kernels += [
        attn_entry("flash_attention", "src/repro/kernels/flash_attention.py:126", dense_lines[1],
                   dense_lines, dense_launches, "ops.flash_attention (not on the serving path)",
                   "attn_mma.cuh"),
        attn_entry("paged_flash_attention", "src/repro/kernels/flash_attention.py:328",
                   paged_lines[0], paged_lines, eng_pag["launches"], "bitplane-paged decode",
                   "attn_decode.cuh"),
    ]
    for k in kernels:
        k["family_launches"] = fam_launches(k["name"])
        rows = [r for r in tuned_rows if r["autotune_kernel"] == k["name"]]
        if rows:  # rows 1-3: the default's and the tuner's winner's device ms
            k["autotune"] = {f"M={r['M']}": {"default": r["default"], "tuned": r["tuned"],
                                             "default_device_ms": r["default_device_ms"],
                                             "tuned_device_ms": r["tuned_device_ms"],
                                             "one_range_device_ms": r["one_range_device_ms"]}
                             for r in rows}
            k["front_door_launches"] = sum(c["launches"] for c in front_door["front_door"].values()
                                           if c["kernel"] == k["name"])
    # row 1 in the MoE, VLM and encoder cells (phase 17): every projection
    arch_launches = {name: c["all_launches"].get("fused_plane_linear", 0)
                     for name, c in archs.items() if name != "phase_s"}
    if not all(arch_launches.values()):
        _die(f"a phase-17 cell launched no fused_plane_linear: {arch_launches}")
    kernels[0]["arch_launches"] = arch_launches
    # the QAT-trained weights through row 1: the on-the-fly check (a) and the
    # served run (b) of train-serve
    kernels[0]["train_launches"] = {
        "train-serve qat check": train["train-serve"]["qat_vs_bit_serial"]["launches"][
            "fused_plane_linear"],
        "train-serve": train["train-serve"]["launches"]["fused_plane_linear"]}
    fl = summary["fold"][0]
    kernels.append({
        # no Pallas kernel: it replaces the reference's compiled fold
        # (jax.jit(integrity.tree_checksum); jax.jit(cache_slot_checksums) at :667)
        "name": "fold", "route": "cuda", "source": "src/repro_torch/kernels/csrc/fold.cu",
        "replaces": "src/repro/launch/serve.py:181", "launches": eng_det["fold_launches"],
        "max_abs_err": fl["max_abs_err"], "ms": fl["kernel_ms"], "device_ms": fl["device_ms"],
        "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"], "shape": f"quantized tree, {fl['tree_bytes']} bytes",
        "path": "bitplane-detect audits and KV checks",
        "family_launches": fam_launches("fold"),
    })
    # rows 1, 2 and 5 on every rank of the tensor-parallel cells (phase 19)
    for k in kernels:
        tp_launches = {f"{name} rank {r}": c[k["name"]]
                       for name, cell in tp.items() if isinstance(cell, dict)
                       and "launches_per_rank" in cell
                       for r, c in enumerate(cell["launches_per_rank"]) if c[k["name"]]}
        if tp_launches:
            k["tp_launches"] = tp_launches
    # every kernel's launches in each section of phase 22 (the examples)
    for k in kernels:
        ex = {name: c[k["name"]] for name, c in examples["launches"].items()
              if c.get(k["name"])}
        if ex:
            k["examples_launches"] = ex
    if not (kernels[0].get("examples_launches") and kernels[1].get("examples_launches")):
        _die("phase 22 launched no fused_plane_linear or no plane_matmul")
    missing = [k for k in ("fused_plane_linear", "plane_matmul", "plane_matmul_packed", "fold")
               if not fam_launches(k)]
    if missing:
        _die(f"the family cells launched no {missing}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

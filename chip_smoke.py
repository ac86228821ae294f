#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``doc2tex_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one.  Phases, one line each:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — nvcc builds the three kernel sources at once, one process
   per source (seconds taken): B1 (with its int8 K/V form), B2 (with its
   int8 memory form), and B2's backward;
3. slice   — MathRecognition with the released ``synthetic_tfm_big``
   weights, beam 10, on 16 seeded synthetic crops: float32 (the strings
   must equal the JAX package's golden strings on >= 15 of 16) and
   bfloat16, the release compute type (agreement printed, not gated).  B1's
   launch count must rise in each run; the float32 run's decode steps give
   the slice's B1 launch shapes (``tfm_launch_shapes``);
4. kernel  — beam decode attention (B1) against its plain PyTorch version
   on the card, in float32 and bfloat16: at the decode shapes of the TFM
   release model (self-attention with a random beam-ancestry mask,
   cross-attention over 623 memory tokens), at the slice's own launch
   shapes, and where the kernel splits M over a cluster (batch 1 and 8, M
   5010); bit for bit in bf16 and f16 on inputs that show where the
   probabilities are rounded.  Then times (each a call's share of a CUDA
   graph of 20 calls) at the release shape (batch 64, beam 10, step 151;
   the JSON record), at the slice's shapes and at the split shapes, beside
   the plain version, F.scaled_dot_product_attention (a yardstick only; the
   port never calls it) and the bound;
5. kernel  — the coverage-attention step (B2) against its plain versions.
   The feature form (the TPU kernel's contract) at rows {1, 10, 37, 640} x
   S {83, 623, 2525} x (D, H, Kl) {(128, 128, 64), (256, 256, 128)} and at
   the rows and S of every batch the ``synthetic`` slice phase decodes; the
   coverage form (the main path's: location conv folded in, memory at
   sample rows) at samples {1, 8, 64} x K {1, 5, 10} x S {83, 445, 623,
   2525} x the same widths and the slice's shapes, on coverage of decode
   steps 1 and 150; each x valid_len {None, S - 17}, float32 and bfloat16
   memory.  Then both forms timed (bf16, CUDA graphs) at each of the
   slice's shapes and at the release shape (64 crops x beam 10, S 623)
   beside the plain version and the bound.  The JSON record holds the
   coverage form at the slice's largest launch;
6. slice   — the same with the released coverage-LSTM ``synthetic``
   against its own golden file; B2's coverage-form launch count must rise
   in each run;
7. int8    — every int8 layer of both releases' encoders (``quantize:
   int8``: the gated ResNet convolutions, the patch conv, the ViT Denses)
   on the card against the same layer on the CPU, in float32 and
   bfloat16, on the inputs the layer gets when the release encodes a golden
   crop at the slice's largest bucket: equal bits (integer sums are exact
   and the rescale is the same ops in the same order), and at M <= 16 rows
   (the product's zero-row padding);
8. slice   — both releases as they ship, ``quantize: int8``: float32
   against the JAX package's int8 golden (equal strings printed; gated on
   a mean character match >= 0.85 and >= 2 strings that differ from the
   float32 golden, ``check_int8_strings``: int8 strings follow every float
   op's last bit), and bfloat16 (printed), each kernel's launch count
   rising;
8b. int8_memory — the modes that keep decode memory in int8: the golden
   crops of ``synthetic_tfm_big`` and ``synthetic`` with ``quantize:
   int8_full`` and of ``synthetic_tfm_big`` with the parts encoder,
   decoder_mem, decoder_kv, float32 gated by ``check_int8_strings``
   against the JAX package's golden of the same parts
   (``tests/torch_port_golden[_synthetic]_int8_{full,kv}.json``) and bf16
   printed; every launch that reads int8 memory goes through an int8 form
   (B2 only int8; B1's cross-attention int8, and with decoder_kv its
   self-attention too).  Then B1's int8 K/V form against its plain version
   at every shape those runs launched it with, self M 310..1510 and cross
   623 at B 64, self M 5010, in float32 and bf16 q (``TOL``), and bit for
   bit on rounding-point inputs; B2's int8 form at its launched shapes, the
   release shape and D = H = 256 (S 623, 2525), float32 and bf16 compute
   (``B2_TOL``); both timed (CUDA graphs) beside the float forms and
   their bounds.  The JSON line's ``decode_attention_int8`` and
   ``attention_step_int8`` hold the release-shape times and the launches of
   the 16-crop float32 int8_full call;
9. serve   — ``python -m doc2tex_tpu_torch.api.serve --selftest 32
   --model_version synthetic`` (int8, as shipped) in a child process, its
   stats printed (batches, p50/p99 latency, crops/s); then the HTTP front
   in this process on a localhost port: POST /recognize with a PNG must
   return a string, B2 launching in that request;
10. eval   — the release-eval twin (``tools/release_eval.py``) on
   ``synthetic`` at 256 generated samples, bf16 and int8, printed (at
   that size the interval is too wide to gate);
11. detect — ``MathDetector`` (the released detector, float32; it turns
   cuDNN's TF32 off for its forward) on the 3 golden pages of
   ``tests/torch_port_golden_pages.json`` (1024x1280, 35 windows each),
   with the process's TF32 as torch leaves it, as the app and the server
   run: every box matched one to one with the JAX package's, within 0.5 px
   and scores within 1e-3, at most one box over all pages unmatched and
   only one scored within 0.01 of the threshold; the same bits with TF32
   off process-wide.  Then SSD512's forward, the per-window NMS, the page NMS and the whole
   ``detect_page`` timed on a page beside the SSD's float32 bound
   (``tools/profile_page.detect_timings``);
11b. detect_quant — ``MathDetector(quantize="bf16")`` and ``"int8"`` on
   the golden pages through the host-window path, 5 windows a batch (the
   int8 activation scale is a batch's), against the JAX package's boxes in
   the same mode (``tests/torch_port_golden_pages_{bf16,int8}.json``)
   within ``DETECT_QUANT_TOL``; then ``App(detect_quantize=...)`` on a page
   (the device-window path, 35 windows in one batch), and ``detect_page``
   timed beside the float32 detector's;
12. page   — ``App`` with the shared ``synthetic_tfm_big`` recognizer:
   (a) float32, beam 10, on the golden pages: strings equal to the JAX
   package's on every crop whose integer box equals JAX's, but at most
   one, B1 launching; (b) the page-eval twin (``tools/page_eval.py``) on 40
   pages of seed 35 as the reference's record ran (``quantize: int8`` as
   shipped, beam 10, coalescing off): detection precision, recall and
   end-to-end accuracy each inside the record's Wilson interval
   (``tools/page_eval_r05.json``); (c) the HTTP front with ``--detect`` in
   this process: ``POST /recognize_page`` with a PNG page returns regions,
   B1 launching in that request.  (b) and (c) run with the process's TF32
   as torch leaves it;
12b. detect_train — the detector trains (``tools/detection_soak.py``'s
   twin, the shipped detector, float32, TF32 off): (a) one Adam step on the
   first 8 windows of the ``windows`` pool (seed 0; their sha256 and the
   JAX package's first loss in ``tests/torch_port_golden_detect_soak.json``)
   on the card against the same step on the CPU: the loss within 1e-5 of
   the CPU's and JAX's, every gradient leaf within ``TRAIN_TOL`` or
   ``SPREAD_FACTOR`` times the CPU's own spread under ``WEIGHT_NOISE``, at
   most 5 % of the weights further than 1e-6 apart after the step; (a') 3
   Adam steps on the pool's first 24 windows in order, each loss within
   ``DETECT_STEPS_RTOL`` of JAX's; (b) the soak twin ``--style windows
   --init_from <shipped> --steps 50``: every loss finite, the mean of the
   last 10 at most 1.5 times the first 10's;
   steps/s at batch 8, the pool's upload and the peak memory printed;
   (c) ``--steps 0``: the shipped weights' held-out windows (seed 99)
   against the golden's boxes (``match_boxes``) and equal CROHME counts;
   (d) (b)'s ``--save`` reloaded by ``MathDetector`` gives the in-memory
   model's boxes on a golden page; (e) the voting stitch on the 3 golden
   pages (``detect_page(raw=True)``, ``stitch_page(thresh_votes=8)``)
   against ``tests/torch_port_golden_stitch.json`` within 1 px a
   coordinate, and ``App(stitch=True)``'s strings (float32, beam 10) as
   the page phase's (a) gates them; the stitch's ms a page printed;
13. train  — the release recipe ``config/train_hard_tfm_big.yaml`` at full
   width through the port's trainer (``engine.training``), with
   ``synthetic_data``, ``num_iter`` and ``valInterval`` cut (printed):
   (a) one float32 train step on the card against the same step on the CPU
   (same batch, the shipped weights, dropout 0, warmup 0 so the first
   update moves the weights at the peak rate): loss, grad_norm, every
   gradient leaf and the share of weights apart after the step within
   ``TRAIN_TOL``'s tolerances; (b) bf16 steps on one fixed batch of 32 at 224x704 from a
   seeded random init: every loss finite and the last below the first,
   steps/s and peak memory printed; (c) a run from the shipped weights
   (``pretrained_weight``): its validation (greedy) launches B1, at K = 1
   (shapes printed), B1 matches its plain version at every shape the
   validation launched it with (``TOL``), its EM printed; (d) its ``best_*.msgpack`` load into
   ``MathRecognition`` and give the in-memory model's greedy strings on the
   golden crops; (e) resuming from ``last_checkpoint.msgpack`` restores
   every tensor of the state bit for bit and gives the next step's loss bit
   for bit, with ``torch.backends.cudnn.deterministic`` on for that step.
   Checkpoints go to a temporary directory that is removed;
13b. train_lstm — the coverage-LSTM head trains (the ``synthetic``
   release's recipe: ``tools/structured_soak.py --hard``, ViT 128x3 on a
   128-channel ResNet, ``Attnv2`` hidden 128, kernel_dim 64, batch 32,
   224x704, ``batch_max_length`` 150, the hard vocabulary): (a) one float32
   step on the card against the CPU from the shipped ``synthetic`` weights,
   32 hard crops at 224x704, within ``TRAIN_TOL`` (the ResNet's leaves
   within the larger of it and 4 times the CPU's own spread, ``WEIGHT_NOISE``);
   (b) bf16 steps on one fixed batch of 32 from a seeded random init: the
   loss falls, steps/s and peak memory printed; (c) the soak twin
   (``doc2tex_tpu_torch.tools.structured_soak --hard``, device pools, one
   step per pool, then 4 steps) from the shipped weights: beam-5 EM before
   and after printed (the shipped weights' gated at >= 0.5), B2 launching
   at K 1 (training) and 5 (validation) and its backward launching;
   (d) ``config/train_synth.yaml`` cut (``LSTM_TRAIN_CUTS``) through the
   port's trainer, greedy validation through B2, its best checkpoints
   decoding as the in-memory model, the resume bit for bit; (e) B2's
   backward kernel against its plain version, and against itself (equal
   bits), at every (B, S, D, H, Kl, type) that (a)-(d) launched it with, on
   the inputs of a launch there, and at the reference widths (D = H = 256,
   Kl 128, S 623 and 2525), coverage and loc_aware, float32 and bf16
   (``B2_BWD_TOL``); then timed (CUDA graphs) beside its plain version,
   autograd of the plain forward (a yardstick) and its bound;
14. synthetic_tfm — the small TFM release (ViT 128x3, 3-layer head, hd
   32) as phases 3 and 8 run the big one: float32 against its JAX golden
   (>= 15 of 16), bfloat16 printed, int8 as shipped gated by
   ``check_int8_strings``; every (B, K, M, kind) of B1 these runs launched
   held against the plain version in bf16 and float32 (``release_phase``);
15. synthetic_long — the same for the long-formula release: 16
   ``synth_long_sample`` crops in its 448x960 bucket, decodes of up to 500
   steps (KV cache grown over 5 chunks to 501 x 10 slots), B1 at self M
   up to 5010 and cross M 1695; then B1 timed at those M, batch 16 and 64;
16, 17. version1, version2 — the blocks that ship no weights (512-channel
   backbone, ViT 256x6, the coverage head at width 256, kernel_dim 128) at
   random init from seed 0 with CLAHE on (``version_phase``): crops
   (hard, long, and two long stacked, which version1 decodes at 800x800,
   S 2525) decoded on the card, B2 launching; every B2 launch shape held
   against the plain version and timed; one crop at 40 steps in float32,
   the card's tokens equal to the CPU's.  Then B2 timed at the reference
   widths at S 1694 and 2525;
18. infer — ``python -m doc2tex_tpu_torch.api.infer`` in this process over
   the long golden crops as PNGs with a TSV manifest
   (``tests/torch_port_infer_synthetic_long.yaml``: float32, beam 10): its
   predictions.csv equal to the JAX CLI's (``tests/torch_port_golden_infer.json``)
   on >= 15 of 16 rows, B1 launching;
19. realdata — the reference's data chain (``tools/realdata.py``'s twin):
   (a) its package fallback writes 512 hard PNGs (seed 77) and its lmdb
   stage packs them into a store (``tools.lmdb_builder``), and the first 64
   into a validation store: every stored image decodes equal to its source
   array, and the share of each PNG row filter in the store (``encode_png``
   picks one per row, mostly Paeth, as PIL's writer does) beside
   ``decode_png``'s host time a sample through the native row unfilter and
   the plain Python one; (b) ``config/train.yaml`` (ViT 256x6 on the 512-channel ResNet,
   ``Attnv2`` coverage hidden 256, kernel_dim 128, batch 16, 800x800,
   augment on) with the stores as ``train_data``/``valid_data`` and the
   hard vocabulary: one float32 step on the store's first batch on the card
   against the CPU (``TRAIN_TOL``, the ResNet's leaves within 4 times the
   CPU's own spread), bf16 steps on that batch (steps/s, peak memory), then
   ``REALDATA_STEPS`` bf16 steps and one validation through ``python -m
   doc2tex_tpu_torch.api.train``, B2's forward and backward launching, each
   shape they launched held against the plain versions; (c) ``api.infer``
   with ``eval_data`` an LMDB store of the 16 long golden crops: >= 15 of
   16 rows equal to the JAX CLI's, B1 launching, and the scoring time
   (``score_s``) with the native edit distance beside the plain one;
20. zoo — the rest of the model zoo at full width (``zoo_phase``), the
   blocks of ``tests/torch_port_zoo.yaml`` (version2's 224x960 contract,
   no weights: every leaf drawn from numpy's seed 0, ``zoo_variables``;
   CLAHE on): ``zoo_cnn_tfm`` (ResNet 512
   -> 2D table -> TFM d 512 nh 8: B1 at hd 64, cross M = 13 x 241),
   ``zoo_cnn_bilstm_attn`` (ResNet 512 -> BiLSTM with the GatedSum blend ->
   coverage head: B2 at D = H = 256 on 241 columns), ``zoo_vgg_bahdanau``
   (VGG 512 -> bahdanau: B2's content form, D 512, H 256, no location
   term) and ``zoo_vit_gcb_learned`` (ViT 256x6 on the GCB ResNet with the
   interpolated learned table -> luong concat: plain PyTorch, no kernel).
   For each: (a) float32, 40 steps, beam 10, on the first 8 crops of
   ``tests/torch_port_golden_synthetic.json``: >= 7 of 8 strings equal to
   the JAX package's (``tests/torch_port_golden_zoo.json``, written by
   ``tests/torch_port_zoo_golden.py``), the first crop's teacher-forced
   logits (4 tokens) within 1e-4 of the largest |logit| of JAX's (random
   weights decode flat: few distinct strings), and the card's tokens equal
   the CPU's on one crop; (b) the block's bfloat16 at the full 200 steps on
   the same crops, counts set to 0 just before: the head's kernel
   launching (none for luong), seconds, launches and peak memory printed;
   every launched shape held against the plain version and timed beside
   its bound (and SDPA for B1).  Then the importer
   (``tools/torch_import.py``): a random reference state_dict of
   ``synthetic_tfm_big``'s architecture imported on the card and on the
   CPU, 8 crops decoded in float32 (40 steps, beam 10): strings equal on
   >= 7 of 8, the first crop's logits within 1e-4 of the CPU's largest,
   B1 launching; then the same in the int8 mode the block ships, printed
   and not gated (int8 codes round from sums the two add in other orders).
   Each content-form timing also times the coverage form with a zero
   location conv at the same shape (the same function).

Then a JSON line with the kernels' numbers (B2's backward: its launches
in (c), timed at the recipe's largest launch; the int8 forms: 8b's; B1 at
hd 64 and B2's content form: phase 20's), and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the traceback
is printed and the exit code is 1.  A hang is cut by faulthandler.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback

TIME_LIMIT_S = 1100
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = {"synthetic_tfm_big": os.path.join(ROOT, "tests", "torch_port_golden.json"),
          "synthetic": os.path.join(ROOT, "tests", "torch_port_golden_synthetic.json"),
          "synthetic_tfm": os.path.join(ROOT, "tests", "torch_port_golden_synthetic_tfm.json"),
          "synthetic_long": os.path.join(ROOT, "tests", "torch_port_golden_synthetic_long.json")}
GOLDEN_INT8 = {
    "synthetic_tfm_big": os.path.join(ROOT, "tests", "torch_port_golden_int8.json"),
    "synthetic": os.path.join(ROOT, "tests", "torch_port_golden_synthetic_int8.json"),
    "synthetic_tfm": os.path.join(ROOT, "tests", "torch_port_golden_synthetic_tfm_int8.json"),
    "synthetic_long": os.path.join(ROOT, "tests", "torch_port_golden_synthetic_long_int8.json")}
# the eval CLI's golden: the JAX package's api/infer.py over the long
# golden crops (PNGs, a TSV manifest) with the flat config below
GOLDEN_INFER = os.path.join(ROOT, "tests", "torch_port_golden_infer.json")
INFER_CONFIG = os.path.join(ROOT, "tests", "torch_port_infer_synthetic_long.yaml")
MIN_INFER_MATCH = 15
# the realdata phase: the reference's training config, from LMDB stores the
# port's chain builds (512 hard PNGs of the JAX tool's seed; the first 64 as
# the validation store), a few bf16 steps through api.train, validating once
REALDATA_CONFIG = os.path.join(ROOT, "config", "train.yaml")
REALDATA_N, REALDATA_VALID_N, REALDATA_STEPS = 512, 64, 6
# the version blocks without weights (the reference architecture: 512-channel
# backbone, ViT 256x6, the coverage head at width 256, kernel_dim 128), run
# at random init from seed 0 with CLAHE on; the card-against-CPU check
# decodes one crop for this many steps
VERSION_BLOCKS = ("version1", "version2")
VERSION_CUT_STEPS = 40
# the zoo phase (20): its blocks, their JAX golden, the crops decoded; the
# teacher-forced logits of the first crop over ZOO_LOGIT_STEPS tokens, held
# to JAX's within ZOO_LOGIT_TOL of the largest |logit| (random weights decode
# flat, so the strings alone would not tell a wrong model path); the
# importer's architecture
ZOO_CONFIG = os.path.join(ROOT, "tests", "torch_port_zoo.yaml")
GOLDEN_ZOO = os.path.join(ROOT, "tests", "torch_port_golden_zoo.json")
ZOO_BLOCKS = ("zoo_cnn_tfm", "zoo_cnn_bilstm_attn", "zoo_vgg_bahdanau", "zoo_vit_gcb_learned")
ZOO_N_CROPS = 8
MIN_ZOO_MATCH = 7       # of 8: one beam tie may flip where the card sums in another order
ZOO_LOGIT_STEPS = 4
ZOO_LOGIT_TOL = 1e-4
# the block's bfloat16 logits against JAX's float32 ones: bf16 rounding
# moves them by under 1 % of the largest, another crop's logits lie 5 % or
# more away (tests/test_torch_port_smoke.py::test_zoo_golden_logits_match_port_cpu)
ZOO_BF16_LOGIT_TOL = 2.5e-2
ZOO_IMPORT_VERSION = "synthetic_tfm_big"
# B2 timed at the reference architecture's widths (D, H, Kl) and the S of a
# 448x960 and an 800x800 bucket, 8 samples x beam 10
B2_WIDE = (256, 256, 128)
B2_WIDE_S = (1694, 2525)
GOLDEN_PAGES = os.path.join(ROOT, "tests", "torch_port_golden_pages.json")
# the reference's page-eval record this port is held to: 40 pages, seed 35,
# synthetic_tfm_big int8 beam 10, float32 detector, page NMS, coalescing off
PAGE_EVAL_REF = (os.path.join(ROOT, "tools", "page_eval_r05.json"),
                 "synthetic_tfm_big_ftrecog_p40")
PAGE_EVAL_PAGES = 40
# cuDNN's TF32 setting as torch leaves it in a process that does not set it
# (the app, the server); main reads it before it turns TF32 off
USERS_CUDNN_TF32 = None
# the detect phase's gates against the golden pages
BOX_TOL_PX = 0.5
SCORE_TOL = 1e-3
NEAR_THRESHOLD = 0.01   # an unmatched box must score this close to conf_thresh
MAX_UNMATCHED = 1
MAX_PAGE_STRING_MISSES = 1
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor rate
F32_FLOPS = 67e12                  # H100 SXM float32 rate outside the tensor cores
KERNEL_SOURCE = "doc2tex_tpu_torch/csrc/decode_attention.cu"
KERNEL_REPLACES = "doc2tex_tpu/ops/decode_attention.py:104"
B2_SOURCE = "doc2tex_tpu_torch/csrc/attention_step.cu"
B2_REPLACES = "doc2tex_tpu/ops/attention_step.py:99"
# stated tolerances of kernel vs plain version (abs + rel * |plain|)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 0.0)}
# B1's int8 K/V form: float32 as TOL; with bf16 q its output is a bf16
# rounding of float32 sums, so kernel and plain version part by at most a
# unit or two in the last place of bf16 (2^-8 relative) where their sums
# round apart; this phase measured at most 1.953e-3 on an H100 (PERF.md §6)
INT8_TOL = {"float32": TOL["float32"], "bfloat16": (4e-3, 1e-2)}
# B2 computes in float32 whatever the memory's type, so one tolerance for
# both: float32 sums of the same terms in another order
B2_TOL = (1e-5, 1e-5)
MIN_GOLDEN_MATCH = 15
TRAIN_CONFIG = os.path.join(ROOT, "config", "train_hard_tfm_big.yaml")
TFM_BIG_WEIGHTS = os.path.join(ROOT, "saved_models", "math_recog", "synthetic_tfm_big",
                               "best_weights.msgpack")
# the train phase's cuts of the recipe (widths, ladder and sequence length stay)
TRAIN_CUTS = {"synthetic_data": 3200, "num_iter": 8, "valInterval": 8, "logInterval": 1}
TRAIN_FIXED_BUCKET = (224, 704)
TRAIN_BF16_STEPS = 12
# (a) card against CPU, float32, at the shipped weights: the loss, every
# gradient leaf (relative to its norm plus grad_floor times the whole
# gradient's norm: the attention key biases' gradient is 0 up to float
# noise, since a bias added to every key does not move a softmax) and
# grad_norm; after the step, the share of weights further apart than
# 1e-6.  Adam's first update is about -lr * sign(g), so only a weight whose
# gradient is near 0 on both sides can differ; a wrong update (lr, decay,
# bias correction, clip) moves nearly every weight.  The H100 read 6.7e-6
# for the loss, 2.67e-4 for the head's worst leaf (a key bias), 1.35e-4
# for the ResNet's, 2.9e-6 for grad_norm and 0.43 % of the weights.
TRAIN_TOL = {"loss_rtol": 1e-5, "grad_rtol": 1e-3, "grad_floor": 1e-5,
             "grad_norm_rtol": 1e-3, "param_far_share": 0.05}
# (a) of train_lstm: the ResNet's own float32 spread, from the weights scaled
# by (1 + WEIGHT_NOISE N(0, 1)) on the CPU; its leaves are held within the
# larger of grad_rtol and SPREAD_FACTOR times that spread (the factor of
# tests/test_torch_port_train.py).  At the shipped synthetic weights and 32
# hard crops at 224x704 the card read 1.20e-3 for a ResNet leaf, 1.27e-5
# for the head's and the ViT's worst (an NVIDIA H100 80GB HBM3 at 700 W)
WEIGHT_NOISE = 1e-7
SPREAD_FACTOR = 4.0
# (c) the validation's greedy EM of the shipped weights on the run's
# validation set, before training (the release's own EM is 0.8757)
TRAIN_MIN_SHIPPED_EM = 0.5
# the train_lstm phase: the shipped coverage-LSTM weights, config/train_synth.yaml
# with its cuts (widths, ladder, sequence length and batch stay), and the
# soak twin's --hard arm (the synthetic recipe) cut to a few steps and a
# small eval set (the precompile pass takes one step per pool on top)
SYNTHETIC_WEIGHTS = os.path.join(ROOT, "saved_models", "math_recog", "synthetic",
                                 "best_weights.msgpack")
LSTM_TRAIN_CONFIG = os.path.join(ROOT, "config", "train_synth.yaml")
LSTM_TRAIN_CUTS = {"synthetic_data": 400, "num_iter": 6, "valInterval": 6, "logInterval": 1}
LSTM_SOAK_ARGV = ("--hard", "--steps", "4", "--n_train", "1024", "--n_eval", "256",
                  "--eval_every", "4", "--eval_first", "--lr", "1e-4")
# B2's backward against its plain version: float32 sums of the same terms in
# another order (the location conv folded into w_loc, partial sums per block
# of positions), so every output within B2_BWD_TOL of its largest magnitude;
# d enc and d enc_proj come out in the memory's type, so in bf16 they may
# also sit one unit in the last place (at most 2^-7 of the element) apart
# (plus B2_BWD_FLOOR of the largest magnitude among the call's nine outputs:
# an output whose terms cancel, such as d loc_conv_b at random weights, is
# held to the scale of its terms rather than of its sum)
B2_BWD_TOL = 1e-4
B2_BWD_FLOOR = 1e-3
B2_BWD_SOURCE = "doc2tex_tpu_torch/csrc/attention_step_backward.cu"
# the JAX package has no backward kernel: jax.grad differentiates the step
# in its teacher-forced scan
B2_BWD_REPLACES = "doc2tex_tpu/models/decoder_lstm.py:279"
B2_BWD_NAMES = ("d_enc", "d_enc_proj", "d_q", "d_mem", "d_loc_conv_w", "d_loc_conv_b",
                "d_w_loc", "d_b_loc", "d_w_score")
# the detect_train phase: the goldens the JAX package wrote on the CPU, the
# soak twin's fine-tune (its pool and eval as the JAX tool's), the stitch's
# gate (a coordinate may move by 1 px where a vote boundary sits on a window
# edge) and the soak's loss gates.  Fine-tuning from a trained point, Adam's
# fresh moments move every weight by about lr at the first steps and the
# loss rises (JAX's own step does the same: 2e-5 -> 0.276 at batch 1 on the
# CPU, tests/test_torch_port_detect_train.py), so the first loss is no
# baseline: the last 10 losses' mean is held to DETECT_SOAK_LOSS_FACTOR
# times the first 10's (no blow-up over the run), and the rise itself to
# JAX's: the golden's 3 Adam steps on the pool's first 24 windows within
# DETECT_STEPS_RTOL (a wrong moment, bias correction or count moves a loss
# by far more; an H100 80GB HBM3's first step sits 2.2e-6 from the CPU's)
GOLDEN_DETECT_SOAK = os.path.join(ROOT, "tests", "torch_port_golden_detect_soak.json")
GOLDEN_STITCH = os.path.join(ROOT, "tests", "torch_port_golden_stitch.json")
DETECT_SOAK_STEPS = 50
DETECT_SOAK_LOSS_FACTOR = 1.5
DETECT_STEPS_RTOL = 1e-3
STITCH_TOL_PX = 1
# the int8 strings' gates (see check_int8_strings)
INT8_MIN_CHAR_MATCH = 0.85
INT8_MIN_CHANGED = 2
# the modes that keep decode memory in int8 (phase 8b): their goldens (the
# JAX package's strings on the CPU in float32 with the same parts) and the
# parts; int8_kv is no quantize: mode, its parts are set on the model
GOLDEN_QUANT = {
    "int8_full": {v: GOLDEN[v].replace(".json", "_int8_full.json")
                  for v in ("synthetic_tfm_big", "synthetic")},
    "int8_kv": {"synthetic_tfm_big": GOLDEN["synthetic_tfm_big"].replace(".json", "_int8_kv.json")}}
QUANT_PARTS = {"int8_kv": ("encoder", "decoder_mem", "decoder_kv")}
# the int8 forms replace XLA code of the reference, not a Pallas kernel:
# decode_attention's _reference int8 branch, and the LSTM step on int8 memory
B1_INT8_REPLACES = "doc2tex_tpu/ops/decode_attention.py:36"
B2_INT8_REPLACES = "doc2tex_tpu/models/decoder_lstm.py:237"
# the quantized detector against the JAX package's boxes in the same mode
# (tests/torch_port_golden_pages_{bf16,int8}.json: host windows, 5 a batch,
# as the port runs here).  Loc/conf part by a few bf16 steps (bf16) or by a
# quantization step that a float32 layer's last bit moves (int8): on a
# seeded window the port on the CPU sits within 3.3e-3 / 1.7e-2 of loc's
# largest magnitude (4.7) of JAX's, 7.3e-3 / 6.5e-3 of conf's (17)
# (tests/test_torch_port_detect.py).  A loc offset of 0.08 moves a corner
# by 0.1 x 0.08 of a prior's size (up to ~300 px): 2.4 px; a conf logit
# offset of 0.12 moves a score by at most 0.03.  Boxes whose score lies
# near the threshold may come and go.
DETECT_QUANT_GOLDEN = {q: os.path.join(ROOT, "tests", f"torch_port_golden_pages_{q}.json")
                       for q in ("bf16", "int8")}
DETECT_QUANT_TOL = {"bf16": {"box_px": 2.0, "score": 0.03, "unmatched": 3, "near": 0.05},
                    "int8": {"box_px": 3.0, "score": 0.03, "unmatched": 3, "near": 0.05}}
INT8_BYTES_PER_SCALE = 4


def log(phase: str, t0: float, msg: str) -> None:
    print(f"[{phase} {time.perf_counter() - t0:7.2f}s] {msg}", flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return out.stdout.strip() or f"unavailable (rc {out.returncode}: {out.stderr.strip()})"


def attention_inputs(B, K, M, nh, hd, dtype, device, masked, seed, step=None):
    """Random q/k/v and, if ``masked``, a random beam-ancestry mask over
    M = T*K flat positions: each hypothesis's prefix picks one slot per
    position up to the current step, and its own slot at that step.  The
    current step is ``step`` for every sample (the positions after it are
    the cache's dead tail), or random per sample when ``step`` is None."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn(B, K, nh, hd, generator=g) / hd ** 0.5).to(device, dtype)
    k = torch.randn(B, M, nh, hd, generator=g).to(device, dtype)
    v = torch.randn(B, M, nh, hd, generator=g).to(device, dtype)
    mask = None
    if masked:
        T = M // K
        slot = torch.randint(0, K, (B, K, T), generator=g)
        t_cur = (torch.full((B,), step) if step is not None
                 else torch.randint(0, T, (B,), generator=g))
        slot[torch.arange(B)[:, None], torch.arange(K)[None, :], t_cur[:, None]] = torch.arange(K)
        live = torch.arange(T)[None, None, :, None] <= t_cur[:, None, None, None]
        sel = torch.nn.functional.one_hot(slot, K).bool() & live   # (B, K, T, K)
        mask = sel.reshape(B, K, T * K).to(device)
    return q, k, v, mask


ROUNDING_POINT_CASES = ((3, 1.25), (7, 1.25), (7, 5.0))  # (attended positions, v)


def rounding_point_inputs(n, v0, dtype, device, B=1, K=1, nh=1, hd=32, spread=1, seed=0):
    """Inputs on which rounding the normalised probabilities to v's type
    before P.V (the reference's order) and keeping them in float32 give
    different results: q = 0, so the ``n`` attended positions (every
    ``spread``-th of M = n * spread) score alike and p = 1/n; V is ``v0`` at
    position 0 and 0 elsewhere.  Every output element is then
    round(round(1/n) * v0), one product summed with zeros."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    M = n * spread
    q = torch.zeros(B, K, nh, hd)
    k = torch.randn(B, M, nh, hd, generator=g)
    v = torch.zeros(B, M, nh, hd)
    v[:, 0] = v0
    mask = None
    if spread > 1:
        mask = torch.zeros(B, K, M, dtype=torch.bool)
        mask[:, :, ::spread] = True
        mask = mask.to(device)
    return q.to(device, dtype), k.to(device, dtype), v.to(device, dtype), mask


def check_attention(B, K, M, nh, hd, dtype, masked, seed, step=None):
    """B1 against its plain version at one shape; returns the max abs error."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    name = str(dtype).split(".")[-1]
    atol, rtol = TOL[name]
    q, k, v, mask = attention_inputs(B, K, M, nh, hd, dtype, "cuda", masked, seed, step)
    out = decode_attention(q, k, v, mask)
    ref = decode_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"non-finite kernel output at B{B} K{K} M{M} {name}")
    err = (out.float() - ref.float()).abs()
    if (err > atol + rtol * ref.float().abs()).any():
        raise AssertionError(f"kernel disagrees with plain version at B{B} K{K} M{M} "
                             f"mask={masked} step={step} {name}: max abs err "
                             f"{err.max().item():.3e}")
    return err.max().item()


def attention_timing(B, K, M, masked, step, nh=8, hd=32):
    """B1, its plain version and SDPA (a yardstick; the port never calls
    it) timed at one bf16 shape, and the bound of the same work.  Each time
    is one call's share of a CUDA graph of 20 calls, so host time between
    launches is not counted."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference, launch_plan)
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    q, k, v, mask = attention_inputs(B, K, M, nh, hd, torch.bfloat16, "cuda", masked,
                                     seed=7, step=step)
    sdpa_mask = None if mask is None else mask[:, None]
    qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    before = decode_attention.launches
    ms = graph_ms(lambda: decode_attention(q, k, v, mask))
    plain_ms = graph_ms(lambda: decode_attention_reference(q, k, v, mask))
    library_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask, scale=1.0))
    err = (decode_attention(q, k, v, mask).float()
           - decode_attention_reference(q, k, v, mask).float()).abs().max().item()
    decode_attention.launches = before  # timing launches are not main-path launches
    elem = 2  # bf16
    # bytes this data needs: q read, out written, the mask, and the K/V
    # rows that at least one beam of the sample attends
    kv_rows = B * M if mask is None else int(mask.any(dim=1).sum().item())
    nbytes = (2 * q.numel() + 2 * kv_rows * nh * hd) * elem
    nbytes += 0 if mask is None else mask.numel()
    attended = B * K * M if mask is None else int(mask.sum().item())
    flops = 4 * attended * nh * hd  # q.k and p.v over the attended positions
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    plan = launch_plan(B, K, M, nh, hd, torch.bfloat16)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=err,
                text=f"B{B} K{K} M{M} {'step ' + str(step) if masked else 'no mask'} nh{nh} "
                     f"hd{hd} bf16 (cluster {plan.cluster}, chunk {plan.chunk}, "
                     f"{plan.smem_bytes} B smem): max abs err {err:.3e}, "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"sdpa (yardstick) {library_ms:.4f} ms, bound {bound:.4f} ms "
                     f"({nbytes / 1e6:.2f} MB), {bound / ms:.0%} of bound, achieved "
                     f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")


def kernel_phase(t0, slice_shapes):
    """B1 against its plain version over the listed grid, the launch shapes
    of the ``synthetic_tfm_big`` slice, shapes where M is split over a
    cluster, and bit for bit on the rounding-point inputs; then times at
    the release shape (the JSON record), the slice's shapes and the split
    shapes.  Returns the kernel's JSON record (launches filled later)."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    nh, hd, S = 8, 32, 623
    grid = [(B, K, M, masked, None) for B in (1, 16, 64) for K in (1, 5, 10)
            for M, masked in ((31 * K, True), (151 * K, True), (S, False))]
    grid += [(B, K, M, t is not None, t) for B, K, M, t in slice_shapes]
    grid += [(B, 10, M, masked, None) for B in (1, 8) for M, masked in ((1510, True), (623, False))]
    grid += [(1, 10, 5010, True, 500), (64, 10, 5010, True, None)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        worst[name] = max(check_attention(B, K, M, nh, hd, dtype, masked,
                                          seed=B * 1000 + K * 10 + masked, step=step)
                          for B, K, M, masked, step in grid)
    log("kernel", t0, f"matches plain version at {len(grid)} shapes per dtype (B{{1,16,64}} x "
        "K{1,5,10} x {self M=31K, 151K masked; cross M=623}; the slice's shapes "
        f"{slice_shapes}; B{{1,8}} x M{{1510 masked, 623}}; M 5010 at B{{1,64}}): max abs err "
        + ", ".join(f"{n} {e:.3e} (tol {TOL[n][0]:g} abs + {TOL[n][1]:g} rel)"
                    for n, e in worst.items()))

    n = 0
    for dtype in (torch.bfloat16, torch.float16):
        for m, v0 in ROUNDING_POINT_CASES:
            for spread, B, K, nh_ in ((1, 1, 1, 1), (500, 1, 10, 8)):
                q, k, v, mask = rounding_point_inputs(m, v0, dtype, "cuda", B=B, K=K, nh=nh_,
                                                      spread=spread)
                out = decode_attention(q, k, v, mask)
                ref = decode_attention_reference(q, k, v, mask)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"rounding point: kernel {out.flatten()[0].item()!r} != plain "
                        f"{ref.flatten()[0].item()!r} at n {m}, v {v0}, spread {spread}, {dtype}")
                n += 1
    log("kernel", t0, f"equals plain version bit for bit on {n} rounding-point inputs "
        "(p = 1/n rounded to v's type before P.V; bf16 and f16; unsplit and over 8 blocks)")

    timings = {}
    for label, shape in (("self", (64, 10, 1510, True, 150)), ("cross", (64, 10, S, False, None))):
        timings[label] = attention_timing(*shape)
        log("kernel", t0, f"{label} (release shape) {timings[label]['text']}")
    slice_ms = 0.0
    for B, K, M, step in slice_shapes:
        timing = attention_timing(B, K, M, step is not None, step)
        log("kernel", t0, f"synthetic_tfm_big slice {timing['text']}")
        slice_ms += timing["ms"]
    log("kernel", t0, f"sum over the slice's {len(slice_shapes)} shapes: {slice_ms:.4f} ms")
    for B, K, M, masked, step in ((1, 10, 1510, True, 150), (8, 10, 1510, True, 150),
                                  (1, 10, S, False, None), (8, 10, S, False, None),
                                  (1, 10, 5010, True, 500), (64, 10, 5010, True, 500)):
        log("kernel", t0, f"split {attention_timing(B, K, M, masked, step)['text']}")
    rel = timings["self"]
    return {
        "name": "decode_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": 0, "max_abs_err": rel["max_abs_err"],
        "ms": rel["ms"], "plain_ms": rel["plain_ms"], "bound_ms": rel["bound_ms"],
        "bound_by": rel["bound_by"], "library_ms": rel["library_ms"],
    }


def attention_step_inputs(rows, S, D, H, Kl, dtype, seed):
    """Random inputs of the feature form of the attention step on the card,
    at the scales of a decode: unit-variance memory and keys, location
    features of a coverage conv, weights scaled by fan-in."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return dict(
        enc=randn(rows, S, D).to(dtype), enc_proj=randn(rows, S, H).to(dtype),
        q=randn(rows, H), loc_feat=randn(rows, S, Kl, scale=0.5),
        w_loc=randn(Kl, H, scale=Kl ** -0.5), b_loc=randn(H, scale=0.1),
        w_score=randn(H, 1, scale=H ** -0.5),
    )


COVERAGE_STEPS = (1, 150)  # decode steps whose coverage the B2 checks hold


def coverage_step_inputs(Bs, K, S, D, H, Kl, dtype, t, seed, taps=5):
    """Random inputs of the coverage form on the card, as a decode at step
    ``t`` gives them: the memory at Bs sample rows, q at Bs*K rows, and the
    coverage the sum of t softmax rows over S (non-negative; about 1 in
    all at t = 1, about t at t = 150).  Weights at the released
    ``synthetic`` head's scales (std 0.5 conv, 0.35 w_loc, 0.4 w_score)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    mem = torch.zeros(Bs * K, S, device="cuda")
    for _ in range(t):
        mem += torch.softmax(randn(Bs * K, S, scale=3.0), dim=-1)
    return dict(
        enc=randn(Bs, S, D).to(dtype), enc_proj=randn(Bs, S, H, scale=1.5).to(dtype),
        q=randn(Bs * K, H, scale=1.5), mem=mem,
        loc_conv_w=randn(taps, 1, Kl, scale=0.5), loc_conv_b=randn(Kl, scale=0.1),
        w_loc=randn(Kl, H, scale=0.35), b_loc=randn(H, scale=0.17),
        w_score=randn(H, 1, scale=0.4),
    )


def lstm_launch_shapes(version: str = "synthetic", beam_size: int = 10):
    """(samples, K, S, D, H, Kl) of the B2 launches the ``version`` slice
    phase makes: one shape per batch that MathRecognition builds from the
    golden crops (samples = the padded batch, K = the beam; S = the bucket's
    patch grid, the v2 cls token split off).  Host arithmetic only."""
    from doc2tex_tpu_torch.models.vit import grid_size_for
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config

    _, crops = golden_crops(version)
    cfg, weights = load_recog_config(version=version)
    cfg["quantize"] = None
    rec = MathRecognition(cfg, weights, beam_size=beam_size, device="cpu")
    vit, head = cfg["SequenceModeling"]["params"], cfg["Prediction"]["params"]
    prepped = [rec._preprocess(c) for c in crops]
    shapes = set()
    for bucket, idxs in rec.group(prepped).items():
        gh, gw = grid_size_for(bucket, tuple(vit["patch_size"]))
        samples = rec.make_batch([prepped[i] for i in idxs], bucket).shape[0]
        shapes.add((samples, beam_size, gh * gw, vit["hidden_size"], head["hidden_size"],
                    head["kernel_dim"]))
    return sorted(shapes)


def tfm_launch_shapes(steps: int, config=None, beam_size: int = 10):
    """(B, K, M, t) of the B1 launches that the ``synthetic_tfm_big`` slice
    phase makes on the golden crops when each batch decodes ``steps``
    steps: for self-attention one entry per KV-cache chunk the decode
    reaches (M = the chunk's end step x K, the decode's chunk schedule) with
    t the last step decoded in it, whose ancestry mask is the densest of
    the chunk; for cross-attention (B, K, S, None), S the patch grid and
    the cls token.  ``config`` defaults to the release's.  Host arithmetic
    only: no weights are read and nothing is decoded."""
    from doc2tex_tpu_torch.decode.runner import DECODE_CHUNKS, _chunk_ends
    from doc2tex_tpu_torch.models.vit import grid_size_for
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config

    if config is None:
        config, _ = load_recog_config(version="synthetic_tfm_big")
        config["quantize"] = None
    _, crops = golden_crops("synthetic_tfm_big")
    rec = MathRecognition(config, None, beam_size=beam_size, device="cpu")
    patch = tuple(config["SequenceModeling"]["params"]["patch_size"])
    ends = _chunk_ends(config["batch_max_length"] + 1, DECODE_CHUNKS)
    prepped = [rec._preprocess(c) for c in crops]
    shapes = set()
    for bucket, idxs in rec.group(prepped).items():
        B = rec.make_batch([prepped[i] for i in idxs], bucket).shape[0]
        gh, gw = grid_size_for(bucket, patch)
        shapes.add((B, beam_size, gh * gw + 1, None))
        for start, end in zip([0] + ends, ends):
            if start < steps:
                shapes.add((B, beam_size, end * beam_size, min(end, steps) - 1))
    return sorted(shapes, key=lambda s: (s[3] is None, s))


def _b2_result(ms, plain_ms, got, ref, nbytes, flops, text):
    """B2's timing record: the bound of the work, and the text line."""
    err = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=err,
                text=f"{text}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
                     f"(bytes {bytes_ms:.4f} ms for {nbytes / 1e6:.2f} MB, operations "
                     f"{ops_ms:.4f} ms for {flops / 1e9:.4f} GFLOP f32), {bound / ms:.0%} of "
                     f"bound, achieved {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, "
                     f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")


def attention_step_timing(rows, S, D, H, Kl):
    """The feature form (the TPU kernel's contract, memory at the rows of
    q) and its plain version timed at one shape with bf16 memory, each a
    call's share of a CUDA graph of 20 calls, and the bound of the same
    work."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        attention_step_reference, fused_attention_step)
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    kw = attention_step_inputs(rows, S, D, H, Kl, torch.bfloat16, seed=7)
    before = fused_attention_step.launches
    ms = graph_ms(lambda: fused_attention_step(**kw))
    plain_ms = graph_ms(lambda: attention_step_reference(**kw))
    got, ref = fused_attention_step(**kw), attention_step_reference(**kw)
    fused_attention_step.launches = before  # timing launches are not main-path launches
    nbytes = sum(t.numel() * t.element_size() for t in kw.values())
    nbytes += (got[0].numel() + got[1].numel()) * 4
    # float32 work per position: loc.w_loc, the adds, tanh and w_score over
    # H, the softmax, and alpha.enc over D
    flops = rows * S * (2 * Kl * H + 5 * H + 3 + 2 * D)
    return _b2_result(ms, plain_ms, got, ref, nbytes, flops,
                      f"feature form, rows {rows} S {S} D{D} H{H} Kl{Kl} bf16")


def coverage_step_timing(Bs, K, S, D, H, Kl):
    """The coverage form (the main path's) and its plain version timed at
    one shape with bf16 memory, as ``attention_step_timing``, and the bound
    of the fused function: the memory read once per sample, the coverage,
    q and the weights read and the outputs written once; per position 5
    window taps times H, the adds, tanh and w_score, the softmax, and
    alpha.enc over D."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        COVERAGE, coverage_attention_step, coverage_attention_step_reference, launch_plan)
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    kw = coverage_step_inputs(Bs, K, S, D, H, Kl, torch.bfloat16, COVERAGE_STEPS[-1], seed=7)
    before = coverage_attention_step.launches
    ms = graph_ms(lambda: coverage_attention_step(**kw))
    plain_ms = graph_ms(lambda: coverage_attention_step_reference(**kw))
    got, ref = coverage_attention_step(**kw), coverage_attention_step_reference(**kw)
    coverage_attention_step.launches = before  # timing launches are not main-path launches
    taps = kw["loc_conv_w"].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in kw.values())
    nbytes += (got[0].numel() + got[1].numel()) * 4
    flops = Bs * K * S * (2 * taps * H + 5 * H + 3 + 2 * D)
    plan = launch_plan(Bs, K, S, D, H, Kl, torch.bfloat16, COVERAGE, taps)
    return _b2_result(ms, plain_ms, got, ref, nbytes, flops,
                      f"coverage form, {Bs} samples x K {K} S {S} D{D} H{H} Kl{Kl} bf16 "
                      f"(cluster {plan.cluster}, chunk {plan.chunk}, zsplit {plan.zsplit}, "
                      f"{plan.smem_bytes} B smem)")


def _check_b2(name, got, ref, where):
    """Both outputs of a B2 call finite and within B2_TOL of the plain
    version's; returns (the largest error, the largest error over its
    tolerance)."""
    import torch

    atol, rtol = B2_TOL
    worst = (0.0, 0.0)
    for what, a, b in (("context", got[0], ref[0]), ("alpha", got[1], ref[1])):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {what} at {where}")
        err = (a - b).abs()
        if (err > atol + rtol * b.abs()).any():
            raise AssertionError(f"{name} disagrees with plain version ({what}) at {where}: "
                                 f"max abs err {err.max().item():.3e}")
        ratio = (err / (atol + rtol * b.abs())).max().item()
        worst = (max(worst[0], err.max().item()), max(worst[1], ratio))
    return worst


def check_coverage_shapes(shapes):
    """B2's coverage form against its plain version at each (samples, K, S,
    D, H, Kl) of ``shapes``, float32 and bfloat16 memory, on coverage of
    the steps COVERAGE_STEPS, valid_len None and S - 17.  Returns (checks
    made, the worst errors as text)."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        coverage_attention_step, coverage_attention_step_reference)

    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for Bs, K, S, D, H, Kl in shapes:
            for t in COVERAGE_STEPS:
                kw = coverage_step_inputs(Bs, K, S, D, H, Kl, dtype, t, seed=n)
                for valid in (None, S - 17):
                    n += 1
                    got = coverage_attention_step(**kw, valid_len=valid)
                    ref = coverage_attention_step_reference(**kw, valid_len=valid)
                    torch.cuda.synchronize()
                    worst[name] = tuple(map(max, worst[name], _check_b2(
                        "attention step (coverage form)", got, ref,
                        f"{Bs} samples K {K} S {S} D{D} H{H} Kl{Kl} step {t} valid {valid} "
                        f"{name}")))
                    del got, ref
                del kw
    return n, ("max abs err " + ", ".join(
        f"{k} {e:.3e} (at most {r:.2f} of its tolerance)" for k, (e, r) in worst.items())
        + f"; tol {B2_TOL[0]:g} abs + {B2_TOL[1]:g} rel")


def check_b1_shapes(t0, phase, shapes, nh, hd):
    """B1 against its plain version at every (B, K, M, kind) a phase
    launched it with, in bfloat16 and float32; self-attention with the mask
    of the chunk's last step live, the densest it had."""
    import torch

    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        worst[name] = max(check_attention(B, K, M, nh, hd, dt, kind == "self",
                                          seed=B * 1000 + M,
                                          step=M // K - 1 if kind == "self" else None)
                          for B, K, M, kind in shapes)
    log(phase, t0, f"B1 matches its plain version at the {len(shapes)} (B, K, M, kind) shapes "
        f"launched (nh {nh}, hd {hd}): {sorted(shapes)}; max abs err "
        + ", ".join(f"{n} {e:.3e} (tol {TOL[n][0]:g} abs + {TOL[n][1]:g} rel)"
                    for n, e in worst.items()))


@contextlib.contextmanager
def recorded_launches():
    """Record the shapes the models give the kernels' wrappers while the
    block runs: B1's (B, K, M, kind) under ``"b1"`` (its int8 K/V form's
    under ``"b1_int8"``) and its (heads, head dim, type) under
    ``"b1_types"``, B2's (samples, K, S, D, H, Kl) under ``"b2"`` (its int8
    form's under ``"b2_int8"``), its content form's (samples, K, S, D, H)
    under ``"b2_content"`` (``"b2_content_int8"``), and B2's backward's (B, S, D, H, Kl, type) under ``"b2_bwd"``
    with the inputs of a call at each under ``"b2_bwd_inputs"``.  The
    wrappers run as they are, counting their launches."""
    from doc2tex_tpu_torch.models import decoder_lstm, decoder_tfm
    from doc2tex_tpu_torch.ops import attention_step

    seen = {"b1": set(), "b1_int8": set(), "b1_types": set(), "b2": set(), "b2_int8": set(),
            "b2_bwd": set(), "b2_bwd_inputs": {}}
    attend, step = decoder_tfm.decode_attention, decoder_lstm.coverage_attention_step
    backward = attention_step.coverage_attention_step_backward
    live = set()

    def b1(q, k, v, mask=None, k_scale=None, v_scale=None):
        seen["b1" if k_scale is None else "b1_int8"].add(
            (q.shape[0], q.shape[1], k.shape[1], "self" if mask is not None else "cross"))
        seen["b1_types"].add((q.shape[2], q.shape[3], v.dtype))
        return attend(q, k, v, mask, k_scale, v_scale)

    def b2(enc, enc_proj, q, mem, loc_conv_w, *args, **kwargs):
        seen["b2" if kwargs.get("enc_scale") is None else "b2_int8"].add(
            (enc.shape[0], q.shape[0] // enc.shape[0], enc.shape[1], enc.shape[2],
             enc_proj.shape[2], loc_conv_w.shape[2]))
        return step(enc, enc_proj, q, mem, loc_conv_w, *args, **kwargs)

    class B2Backward:
        """The backward wrapper, recording; its launch count is the
        wrapper's own (the wrapper counts through its module's name)."""

        def __call__(self, *args):
            enc, enc_proj, loc_conv_w = args[0], args[1], args[4]
            shape = (*enc.shape, enc_proj.shape[2], loc_conv_w.shape[2], str(enc.dtype)[6:])
            # the first call at a shape with a cotangent that is not zero (the
            # last decode steps' targets are mostly padding), which in the
            # reverse order of a backward is the one with the most coverage
            if shape not in live and (args[10].any() or args[11].any()):
                live.add(shape)
                seen["b2_bwd_inputs"][shape] = [a.detach().clone() for a in args]
            elif shape not in seen["b2_bwd"]:
                seen["b2_bwd_inputs"][shape] = [a.detach().clone() for a in args]
            seen["b2_bwd"].add(shape)
            return backward(*args)

        @property
        def launches(self):
            return backward.launches

        @launches.setter
        def launches(self, n):
            backward.launches = n

    content = decoder_lstm.content_attention_step

    def b2_content(enc, enc_proj, q, w_score, **kwargs):
        seen["b2_content" if kwargs.get("enc_scale") is None else "b2_content_int8"].add(
            (enc.shape[0], q.shape[0] // enc.shape[0], enc.shape[1], enc.shape[2],
             enc_proj.shape[2]))
        return content(enc, enc_proj, q, w_score, **kwargs)

    seen.update(b2_content=set(), b2_content_int8=set())
    decoder_tfm.decode_attention, decoder_lstm.coverage_attention_step = b1, b2
    decoder_lstm.content_attention_step = b2_content
    attention_step.coverage_attention_step_backward = B2Backward()
    try:
        yield seen
    finally:
        decoder_tfm.decode_attention, decoder_lstm.coverage_attention_step = attend, step
        decoder_lstm.content_attention_step = content
        attention_step.coverage_attention_step_backward = backward


def attention_step_phase(t0):
    """B2 against its plain versions: the feature form over the listed
    grid and the shapes of the ``synthetic`` slice (memory at the rows of
    q), the coverage form over the listed grid and the slice's shapes
    (memory at sample rows, coverage of steps 1 and 150); then both forms
    timed at each of the slice's shapes and at the release shape.  Returns
    the kernel's JSON record (launches filled later): the coverage form at
    the slice's largest launch."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import attention_step_reference, fused_attention_step

    main_path = lstm_launch_shapes()
    log("kernel", t0, "attention_step launch shapes of the synthetic slice (samples, K, S, D, H, "
        "Kl): " + ", ".join(map(str, main_path)))
    widths = ((128, 128, 64), (256, 256, 128))
    grid = [(rows, S, D, H, Kl) for D, H, Kl in widths
            for S in (83, 623, 2525) for rows in (1, 10, 37, 640)]
    grid += [(Bs * K, S, D, H, Kl) for Bs, K, S, D, H, Kl in main_path]
    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for rows, S, D, H, Kl in grid:
            for valid in (None, S - 17):
                kw = attention_step_inputs(rows, S, D, H, Kl, dtype, seed=n)
                n += 1
                got = fused_attention_step(**kw, valid_len=valid)
                ref = attention_step_reference(**kw, valid_len=valid)
                torch.cuda.synchronize()
                worst[name] = tuple(map(max, worst[name], _check_b2(
                    "attention step (feature form)", got, ref,
                    f"rows {rows} S {S} D{D} H{H} Kl{Kl} valid {valid} {name}")))
                del kw, got, ref
    log("kernel", t0, f"attention_step feature form matches plain version at {n} shapes (rows "
        "{1,10,37,640} x S {83,623,2525} x (D,H,Kl) {(128,128,64),(256,256,128)}, and the "
        "synthetic slice's shapes; x valid {None, S-17}): max abs err "
        + ", ".join(f"{k} {e:.3e} (at most {r:.2f} of its tolerance)"
                    for k, (e, r) in worst.items())
        + f"; tol {B2_TOL[0]:g} abs + {B2_TOL[1]:g} rel")

    cgrid = [(Bs, K, S, D, H, Kl) for D, H, Kl in widths for S in (83, 445, 623, 2525)
             for Bs in (1, 8, 64) for K in (1, 5, 10)]
    cgrid += [shape for shape in main_path if shape not in cgrid]
    n, text = check_coverage_shapes(cgrid)
    log("kernel", t0, f"attention_step coverage form matches plain version at {n} shapes "
        "(samples {1,8,64} x K {1,5,10} x S {83,445,623,2525} x (D,H,Kl) {(128,128,64),"
        "(256,256,128)}, and the synthetic slice's shapes; x coverage of step {1,150} x valid "
        "{None, S-17}): " + text)

    timings = {shape: coverage_step_timing(*shape) for shape in main_path}
    for Bs, K, S, D, H, Kl in main_path:
        log("kernel", t0, f"attention_step (synthetic slice) {timings[Bs, K, S, D, H, Kl]['text']}")
        log("kernel", t0, "attention_step (synthetic slice) "
            + attention_step_timing(Bs * K, S, D, H, Kl)["text"])
    log("kernel", t0, "attention_step (release shape, 64 crops x beam 10) "
        + coverage_step_timing(64, 10, 623, 128, 128, 64)["text"])
    log("kernel", t0, "attention_step (release shape, 64 crops x beam 10) "
        + attention_step_timing(640, 623, 128, 128, 64)["text"])
    # the record: the slice's largest launch (most samples, then longest S)
    rel = timings[max(main_path)]
    return {
        "name": "attention_step", "route": "cuda", "source": B2_SOURCE,
        "replaces": B2_REPLACES, "launches": 0, "max_abs_err": rel["max_abs_err"],
        "ms": rel["ms"], "plain_ms": rel["plain_ms"], "bound_ms": rel["bound_ms"],
        "bound_by": rel["bound_by"], "library_ms": None,
    }


def golden_file(version: str, quantize=None) -> str:
    """``version``'s golden file: float32, or the one of mode ``quantize``."""
    if quantize is None:
        return GOLDEN[version]
    return GOLDEN_INT8[version] if quantize == "int8" else GOLDEN_QUANT[quantize][version]


def golden_crops(version: str = "synthetic_tfm_big", quantize=None):
    """The 16 crops of ``version``'s golden file (the mode's with
    ``quantize``), regenerated from their seeds with the file's generator
    (``synth_hard_sample`` unless it names another); their sha256 must
    match, so a numpy difference fails here and not as a parity miss."""
    import hashlib

    import numpy as np

    from doc2tex_tpu_torch.data import synthetic

    with open(golden_file(version, quantize)) as f:
        golden = json.load(f)
    h, w = golden["crop_max"]
    generate = getattr(synthetic, golden.get("generator", "synth_hard_sample"))
    crops = []
    for c in golden["crops"]:
        img, _ = generate(np.random.default_rng(c["seed"]), max_h=h, max_w=w)
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        if digest != c["sha256"]:
            raise AssertionError(f"crop of seed {c['seed']} differs from the golden crop")
        crops.append(img)
    return golden, crops


def reset_launches() -> None:
    """Every kernel wrapper's launch counts (each form's) to 0."""
    from doc2tex_tpu_torch.ops.attention_step import (
        content_attention_step, coverage_attention_step, fused_attention_step)
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention

    decode_attention.launches = decode_attention.int8_launches = 0
    fused_attention_step.launches = 0
    coverage_attention_step.launches = coverage_attention_step.int8_launches = 0
    content_attention_step.launches = content_attention_step.int8_launches = 0


def launch_counts() -> dict:
    """The forward kernels' launch counts, by form, as they stand."""
    from doc2tex_tpu_torch.ops.attention_step import (
        content_attention_step, coverage_attention_step)
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention

    return {"decode_attention": decode_attention.launches,
            "decode_attention_int8": decode_attention.int8_launches,
            "attention_step": coverage_attention_step.launches,
            "attention_step_int8": coverage_attention_step.int8_launches,
            "attention_step_content": content_attention_step.launches,
            "attention_step_content_int8": content_attention_step.int8_launches}


def run_slice(config, weights_path, crops, beam_size: int, device: str, parts=None):
    """Drive the port's main path: MathRecognition on ``crops`` (with the
    quantized ``parts`` set on its model when given).  Returns (strings,
    launches of the head's kernel (all its forms), decode steps, seconds
    of the timed run); ``launch_counts()`` has them by form after it.  The
    first call warms up; the counted and timed call is the second, with
    every kernel's count set to 0 just before it."""
    import torch

    from doc2tex_tpu_torch.recognition import MathRecognition

    rec = MathRecognition(config, weights_path, beam_size=beam_size, device=device)
    if parts is not None:
        rec.model.set_quantize(parts)
    rec(crops)
    if device != "cpu":
        torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    out = rec(crops)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launch_counts()
    if rec.model.head == "TFM":
        launches = counts["decode_attention"] + counts["decode_attention_int8"]
        steps = launches // (2 * rec.model.predicter.num_layers)
    else:  # the LSTM head: one attention step (coverage form) per decode step
        launches = steps = counts["attention_step"] + counts["attention_step_int8"]
    return out, launches, steps, seconds


def slice_phase(t0, version, kernel, quantize=None):
    """Decode the golden crops of ``version`` in float32 and bfloat16, with
    ``quantize`` (None, ``int8``, ``int8_full`` or ``int8_kv``) against the
    matching golden; returns (launches of ``kernel``, decode steps) of the
    float32 run; ``launch_counts()`` of that run is in ``SLICE_COUNTS``.
    With decode memory in int8 (int8_full, int8_kv) every launch of the
    head's kernel that reads it must be its int8 form's."""
    from doc2tex_tpu_torch.recognition import load_recog_config

    from doc2tex_tpu_torch.eval.metrics import get_single_ED

    golden, crops = golden_crops(version, quantize)
    want = [c["beam10"] for c in golden["crops"]]
    for dtype in ("float32", "bfloat16"):
        cfg, weights = load_recog_config(version=golden["version"])
        cfg["dtype"] = dtype
        cfg["quantize"] = "int8_full" if quantize in QUANT_PARTS else quantize
        out, launches, steps, seconds = run_slice(cfg, weights, crops, 10, "cuda",
                                                  parts=QUANT_PARTS.get(quantize))
        if launches <= 0:
            raise AssertionError(f"{version} {dtype} run launched its kernel {kernel} 0 times")
        counts = launch_counts()
        if quantize in ("int8_full", "int8_kv"):
            check_int8_forms(version, quantize, dtype, counts)
        misses = [i for i, (a, b) in enumerate(zip(out, want)) if a != b]
        match = len(want) - len(misses)
        chars = sum(get_single_ED(b, a) for a, b in zip(out, want)) / len(want)
        log("slice", t0, f"{version} beam 10 {dtype} quantize {quantize}: {match}/{len(want)} "
            f"equal to the JAX {quantize + ' ' if quantize else ''}golden (misses at crops "
            f"{misses}; character match {chars:.4f}), {len(crops) / seconds:.2f} crops/s "
            f"({seconds:.3f} s), {steps} decode steps, {launches} {kernel} launches "
            f"(by form: {counts})")
        if dtype == "float32":
            SLICE_COUNTS[version, quantize] = counts
        if dtype == "float32" and quantize:
            counted = launches, steps
            check_int8_strings(version, out, chars, quantize)
        elif dtype == "float32":
            counted = launches, steps
            if match < MIN_GOLDEN_MATCH:
                raise AssertionError(
                    f"float32 strings equal the golden on {match}/16 < {MIN_GOLDEN_MATCH}: "
                    + "; ".join(f"crop {i}: {out[i]!r} != {want[i]!r}" for i in misses))
    return counted


SLICE_COUNTS: dict = {}   # (version, quantize) -> launch_counts() of slice_phase's float32 run


def check_int8_forms(version, quantize, dtype, counts) -> None:
    """int8 decode memory in effect: B2 only through its int8 form; B1's
    cross-attention (and with int8_kv its self-attention) through its int8
    K/V form, as many launches as the float form's self-attention under
    int8_full."""
    if version == "synthetic":
        ok = counts["attention_step_int8"] > 0 and counts["attention_step"] == 0
    elif quantize == "int8_kv":
        ok = counts["decode_attention_int8"] > 0 and counts["decode_attention"] == 0
    else:
        ok = counts["decode_attention_int8"] == counts["decode_attention"] > 0
    if not ok:
        raise AssertionError(f"{version} {dtype} {quantize}: launches by form {counts}")


def release_phase(t0, version):
    """A TFM release that ships ``quantize: int8`` (phases 14 and 15): its
    golden crops in float32 against the JAX golden and in bfloat16, then as
    shipped (int8) against the JAX int8 golden (``slice_phase``), every
    (B, K, M, kind) of B1 that these runs launched held against the plain
    version.  Returns those (B, K, M, kind)."""
    with recorded_launches() as seen:
        slice_phase(t0, version, "decode_attention")
        slice_phase(t0, version, "decode_attention", quantize="int8")
    (nh, hd), = {t[:2] for t in seen["b1_types"]}
    check_b1_shapes(t0, version, seen["b1"], nh, hd)
    return seen["b1"]


def long_timings(t0, shapes):
    """B1 timed at the ``synthetic_long`` phase's largest self-attention M,
    at the full cache of a 500-token decode (M 5010, which the release
    eval's longest labels reach) and at the phase's cross-attention M, at
    batch 16 (the release eval's) and 64 (the 16-crop call's snapped
    batch), beam 10."""
    M_self = max(M for _, _, M, kind in shapes if kind == "self")
    M_cross = max(M for _, _, M, kind in shapes if kind == "cross")
    for B in (16, 64):
        for M, masked in dict.fromkeys(((M_self, True), (5010, True), (M_cross, False))):
            timing = attention_timing(B, 10, M, masked, M // 10 - 1 if masked else None)
            log("synthetic_long", t0, f"B1 {timing['text']}")
            print(json.dumps({"b1_long": {k: v for k, v in timing.items() if k != "text"}
                              | {"B": B, "K": 10, "M": M, "masked": masked}}),
                  file=sys.stderr, flush=True)


def version_crops():
    """Crops for the version phases: two golden hard crops, a long golden
    crop and two long crops stacked (about 800x940, which ``version1``
    decodes in its 800x800 bucket)."""
    import numpy as np

    _, hard = golden_crops("synthetic")
    _, long = golden_crops("synthetic_long")
    a, b = long[0], long[1]
    w = max(a.shape[1], b.shape[1])
    tall = np.full((a.shape[0] + b.shape[0], w), 255, np.uint8)
    tall[:a.shape[0], :a.shape[1]] = a
    tall[a.shape[0]:, :b.shape[1]] = b
    return [hard[0], hard[1], long[2], tall]


def version_phase(t0, version, crops, device="cuda"):
    """``version`` (phases 16 and 17): a block that ships no weights, at
    full width from a seeded random init (as the JAX package runs it),
    CLAHE on, bfloat16 as the block leaves it, beam 10: ``crops`` decoded
    on the card, B2 launching; every B2 launch shape held against the plain
    version; then one crop decoded for VERSION_CUT_STEPS steps in float32 on
    the card and on the CPU from the same init: equal tokens.  A test
    passes ``device="cpu"`` (and a tiny block) to rehearse the phase: the
    kernel checks and timings need the card and are left out."""
    import copy

    import torch

    from doc2tex_tpu_torch.ops.attention_step import coverage_attention_step
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config

    cfg, weights = load_recog_config(version=version)
    if weights is not None:
        raise AssertionError(f"{version} ships weights {weights}; the phase expects none")
    cuda = device != "cpu"
    rec = MathRecognition(copy.deepcopy(cfg), None, beam_size=10, device=device)
    if not rec.use_clahe or rec.model.head == "TFM":
        raise AssertionError(f"{version}: CLAHE {rec.use_clahe}, head {rec.model.head}")
    buckets = sorted({rec.bucket_key(c) for c in crops})
    with recorded_launches() as seen:
        coverage_attention_step.launches = 0
        t = time.perf_counter()
        out = rec(crops)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = coverage_attention_step.launches
    if (cuda and launches <= 0) or not all(isinstance(x, str) for x in out):
        raise AssertionError(f"{version}: {launches} attention_step launches, {out!r:.200}")
    log(version, t0, f"random init (seed 0), CLAHE on, {cfg['dtype']}, beam 10, "
        f"batch_max_length {cfg['batch_max_length']}: {len(crops)} crops "
        f"{[c.shape for c in crops]} in buckets {buckets} decoded in {seconds:.2f} s, "
        f"{launches} attention_step launches; B2 shapes (samples, K, S, D, H, Kl) "
        f"{sorted(seen['b2'])}; strings {[len(x.split()) for x in out]} tokens long")
    if cuda:
        n, text = check_coverage_shapes(sorted(seen["b2"]))
        log(version, t0, f"attention_step coverage form matches plain version at {n} checks of "
            f"the phase's shapes (x coverage of step {{1,150}} x valid {{None, S-17}}): {text}")
        for shape in sorted(seen["b2"]):
            log(version, t0, f"attention_step (path) {coverage_step_timing(*shape)['text']}")

    cut = cut_config(cfg)
    card_equals_cpu(version, t0, lambda dev: MathRecognition(
        copy.deepcopy(cut), None, beam_size=10, device=dev), crops[0], device)
    return launches, seen["b2"]


def write_manifest(directory, crops, labels, names) -> str:
    """The crops as PNGs in ``directory`` and a TSV manifest (name, label;
    a header row) beside them, as the eval CLI reads them; returns the
    manifest's path."""
    from doc2tex_tpu_torch.utils.png import encode_png

    for img, name in zip(crops, names):
        with open(os.path.join(directory, name), "wb") as f:
            f.write(encode_png(img))
    path = os.path.join(directory, "labels.tsv")
    with open(path, "w", newline="") as f:
        f.write("name\tlabel\n")
        f.writelines(f"{n}\t{lb}\n" for n, lb in zip(names, labels))
    return path


def infer_manifest(directory):
    """The long golden crops written by ``write_manifest``, named by
    seed; returns (manifest path, the golden file)."""
    golden, crops = golden_crops("synthetic_long")
    names = [f"long_{c['seed']:05d}.png" for c in golden["crops"]]
    return write_manifest(directory, crops, [c["label"] for c in golden["crops"]], names), golden


def infer_phase(t0):
    """The eval CLI's twin (phase 18): ``python -m
    doc2tex_tpu_torch.api.infer`` in this process, from the repository
    root, over the long golden crops as PNGs with a TSV manifest and the
    flat config INFER_CONFIG (``synthetic_long``'s block, float32, beam 10):
    its predictions.csv equal to the JAX CLI's (GOLDEN_INFER) on at least
    MIN_INFER_MATCH of 16 rows, B1 launching."""
    import csv
    import tempfile

    from doc2tex_tpu_torch.api import infer
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention

    with open(GOLDEN_INFER) as f:
        want = {r["name"]: r["pred"] for r in json.load(f)["rows"]}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(ROOT):
        manifest, _ = infer_manifest(tmp)
        out_dir = os.path.join(tmp, "out")
        decode_attention.launches = 0
        t = time.perf_counter()
        infer.main(["--config", os.path.relpath(INFER_CONFIG, ROOT), "--csv_dir", manifest,
                    "--data_dir", tmp, "--log_path", out_dir])
        seconds = time.perf_counter() - t
        launches = decode_attention.launches
        with open(os.path.join(out_dir, "predictions.csv"), newline="") as f:
            got = {r["name"]: r["pred"] for r in csv.DictReader(f)}
        with open(os.path.join(out_dir, "metrics.json")) as f:
            metrics = json.load(f)
    match = sum(got.get(name) == pred for name, pred in want.items())
    log("infer", t0, f"api.infer over {len(got)} PNGs ({os.path.relpath(INFER_CONFIG, ROOT)}): "
        f"{match}/{len(want)} predictions equal to the JAX CLI's; EM {metrics['accuracy']:.4f}, "
        f"BLEU {metrics['bleu']:.4f}, {metrics['images_per_sec']:.2f} images/s, {seconds:.1f} s "
        f"with set-up; {launches} decode_attention launches")
    if launches <= 0:
        raise AssertionError("the infer CLI launched decode_attention 0 times")
    if match < MIN_INFER_MATCH:
        raise AssertionError(f"infer: {match}/{len(want)} predictions equal the JAX CLI's "
                             f"(need {MIN_INFER_MATCH})")


def int8_clone(layer, dtype, device):
    """A copy of an int8 layer (Conv or Dense) in compute type ``dtype`` on
    ``device``, with the int8 flag set."""
    from doc2tex_tpu_torch.models.layers import Dense
    from doc2tex_tpu_torch.models.resnet import Conv

    bias = layer.bias is not None
    if isinstance(layer, Dense):
        clone = Dense(*layer.kernel.shape, bias=bias, dtype=dtype)
    else:
        cout, cin, kh, kw = layer.kernel.shape
        clone = Conv(cin, cout, (kh, kw), layer.stride, layer.padding, bias=bias, dtype=dtype)
    clone.load_state_dict(layer.state_dict())
    clone.int8 = True
    return clone.to(device)


def int8_op_phase(t0):
    """Every int8 layer of both releases on the card against the same layer
    on the CPU (equal bits), float32 and bfloat16, on the inputs a golden
    crop gives it at the slice's largest bucket; and M <= 16 calls."""
    import torch

    from doc2tex_tpu_torch.models.layers import Dense
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
    from doc2tex_tpu_torch.tools.bench_int8 import call_batches, record_inputs

    def check(layer, x, dtype, where):
        card, cpu = int8_clone(layer, dtype, "cuda"), int8_clone(layer, dtype, "cpu")
        with torch.inference_mode():
            got, want = card(x.to("cuda", dtype)), cpu(x.to("cpu", dtype))
        if not (torch.isfinite(got).all() and torch.equal(got.cpu(), want)):
            err = (got.float().cpu() - want.float()).abs().max().item()
            raise AssertionError(f"int8 {where} {dtype}: card differs from CPU (max {err:.3e})")
        return got.shape

    for version in ("synthetic_tfm_big", "synthetic"):
        cfg, weights = load_recog_config(version=version)   # quantize: int8, bf16, as shipped
        rec = MathRecognition(cfg, weights, beam_size=1)
        _, crops = golden_crops(version)
        batches = call_batches(rec, crops)
        largest = max(batches, key=lambda x: x.shape[1] * x.shape[2])[:1]
        calls = record_inputs(rec.model, [largest])
        small = 0
        for dtype in (torch.float32, torch.bfloat16):
            for name, layer, x in calls:
                check(layer, x, dtype, f"{version} {name} {tuple(x.shape)}")
            for name, layer, x in calls:    # M <= 16: 5 token rows; a 16-patch window
                if isinstance(layer, Dense):
                    check(layer, x.reshape(-1, x.shape[-1])[:5], dtype, f"{name} M 5")
                elif name == "HybridEmbed_0.Conv_0":
                    check(layer, x[:, :, :8, :8], dtype, f"{name} M 16")
                else:
                    continue
                small += 1
        log("int8", t0, f"{version}: {len(calls)} int8 layers x float32, bfloat16 equal the CPU "
            f"bit for bit at the bucket {tuple(largest.shape[1:3])} (batch 1; inputs "
            f"{tuple(calls[0][2].shape)} to {tuple(calls[-1][2].shape)}), and {small} calls at "
            "M <= 16")
        del rec, batches, calls


def serve_phase(t0):
    """The serving entry point on the card: ``--selftest 32`` of the
    shipped ``synthetic`` (int8) in a child process, then the HTTP front in
    this process with one PNG request; returns B2's launches in that
    request."""
    import threading
    from http.client import HTTPConnection
    from http.server import ThreadingHTTPServer

    from doc2tex_tpu_torch.api import serve
    from doc2tex_tpu_torch.ops.attention_step import coverage_attention_step
    from doc2tex_tpu_torch.utils.png import encode_png

    cmd = [sys.executable, "-m", "doc2tex_tpu_torch.api.serve", "--selftest", "32",
           "--model_version", "synthetic"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serve --selftest failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    if stats["completed"] != 32 or stats["errors"] or stats["quantize"] != "int8" \
            or stats["device"] != "cuda":
        raise AssertionError(f"serve --selftest: {stats}")
    log("serve", t0, f"selftest 32 synthetic int8 on cuda: {stats['batches']} batches (avg "
        f"{stats['avg_batch']}), p50 {stats['latency_p50_ms']} ms, p99 "
        f"{stats['latency_p99_ms']} ms, {stats['crops_per_s']} crops/s over {stats['wall_s']} s "
        "(burst; includes the first calls of each bucket)")
    print(json.dumps({"serve_selftest": stats}), file=sys.stderr, flush=True)

    args = serve.parse_args(["--model_version", "synthetic"])
    recog, server = serve.build_server(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(
        server, config_info={"model_version": "synthetic", "beam_size": recog.beam_size}))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        _, crops = golden_crops("synthetic")
        body = encode_png(crops[0])
        replies = []
        for _ in range(2):      # the first request warms the bucket; the second is counted
            coverage_attention_step.launches = 0
            conn = HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
            conn.request("POST", "/recognize", body=body)
            resp = conn.getresponse()
            replies.append((resp.status, json.loads(resp.read())))
            conn.close()
        launches = coverage_attention_step.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=30)
    status, payload = replies[-1]
    if status != 200 or not isinstance(payload.get("latex"), str) or launches <= 0:
        raise AssertionError(f"POST /recognize: {status} {payload}, {launches} B2 launches")
    log("serve", t0, f"HTTP POST /recognize ({len(body)} B PNG) -> 200 in {payload['ms']} ms, "
        f"{launches} attention_step launches: {payload['latex'][:80]!r}")
    return launches


def eval_phase(t0, n_gen=256):
    """The release-eval twin on ``synthetic`` at ``n_gen`` generated samples."""
    from doc2tex_tpu_torch.tools.release_eval import evaluate

    version, rows = evaluate("attn", False, n_gen=n_gen, modes=("bf16", "int8"))
    for mode, row in rows.items():
        log("eval", t0, f"{version} {mode}: EM {row['em']} {row['em_ci95']} at n {row['n']}, "
            f"BLEU {row['bleu']}, char {row['char']}, {row['eval_s']} s (not gated)")


def check_int8_strings(version: str, out, chars: float, quantize: str = "int8") -> None:
    """The gate of the float32 int8 run (any int8 mode): its strings share
    at least ``INT8_MIN_CHAR_MATCH`` of their characters with the JAX
    package's strings of the same mode (mean match score), and differ from
    the float32 golden on at least ``INT8_MIN_CHANGED`` crops (int8 is in
    effect).

    Exact agreement cannot be the gate.  The int8 encoder takes one
    activation scale per tensor, its abs-max, so a last-bit difference in
    any float op before an int8 layer (another convolution algorithm,
    another summation order) that moves the largest element moves every
    quantized value of the next layer, and two implementations' int8
    strings part wherever the model is unsure, however exact the int8 ops
    are (one float32 ulp on one weight changes 4 of 16 int8 strings in the
    JAX package itself).  JAX's own float32 and int8 strings share 0.90 of
    their characters on these crops, the port's int8 strings on the CPU
    0.93-0.95 of JAX's int8 ones, a model that reads nothing ~0.5 of the
    labels'."""
    with open(GOLDEN[version]) as f:
        plain = [c["beam10"] for c in json.load(f)["crops"]]
    changed = sum(a != b for a, b in zip(out, plain))
    if chars < INT8_MIN_CHAR_MATCH or changed < INT8_MIN_CHANGED:
        raise AssertionError(
            f"{version} float32 {quantize}: character match {chars:.4f} with the JAX golden "
            f"(need {INT8_MIN_CHAR_MATCH}), {changed} strings differ from the float32 golden "
            f"(need {INT8_MIN_CHANGED})")


@contextlib.contextmanager
def users_tf32():
    """The block runs with cuDNN's TF32 as torch leaves it (USERS_CUDNN_TF32),
    as the app and the server run; TF32 is off again after it."""
    import torch

    torch.backends.cudnn.allow_tf32 = USERS_CUDNN_TF32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def golden_pages():
    """The golden file of the page phases and its pages, regenerated with
    the page-eval twin's generator; their sha256 must match."""
    import hashlib

    import numpy as np

    from doc2tex_tpu_torch.tools.page_eval import synth_labelled_page

    with open(GOLDEN_PAGES) as f:
        golden = json.load(f)
    rng = np.random.default_rng(golden["seed"])
    pages = []
    for g in golden["pages"]:
        page, _, _ = synth_labelled_page(rng)
        if hashlib.sha256(page.tobytes()).hexdigest() != g["sha256"]:
            raise AssertionError(f"page {len(pages)} of seed {golden['seed']} differs from the "
                                 "golden page")
        pages.append(page)
    return golden, pages


def match_boxes(want_boxes, want_scores, got_boxes, got_scores, box_px=None):
    """Pair each golden box with an unpaired box of ours whose corners are
    all within ``box_px`` (BOX_TOL_PX; the closest); returns (pairs,
    unmatched), each unmatched entry ("jax" or "port", score)."""
    box_px = BOX_TOL_PX if box_px is None else box_px
    import numpy as np

    want, got = np.asarray(want_boxes, np.float64), np.asarray(got_boxes, np.float64)
    taken = np.zeros(len(got), bool)
    pairs, unmatched = [], []
    for i, box in enumerate(want):
        dist = np.abs(got - box).max(axis=1) if len(got) else np.zeros(0)
        dist[taken] = np.inf
        j = int(np.argmin(dist)) if len(dist) else -1
        if j >= 0 and dist[j] <= box_px:
            taken[j] = True
            pairs.append((i, j, float(dist[j]), abs(float(got_scores[j]) - want_scores[i])))
        else:
            unmatched.append(("jax", float(want_scores[i])))
    unmatched += [("port", float(got_scores[j])) for j in np.flatnonzero(~taken)]
    return pairs, unmatched


def check_detections(golden, results, conf_thresh, tol=None):
    """The detect phase's gates over all golden pages: paired boxes within
    BOX_TOL_PX and SCORE_TOL, at most MAX_UNMATCHED unpaired boxes, each
    scored within NEAR_THRESHOLD of ``conf_thresh`` (or the ``tol`` dict's
    box_px, score, unmatched and near).  Returns (pairs, worst corner
    distance, worst score difference, unmatched)."""
    tol = tol or {"box_px": BOX_TOL_PX, "score": SCORE_TOL, "unmatched": MAX_UNMATCHED,
                  "near": NEAR_THRESHOLD}
    n_pairs, worst_px, worst_score, unmatched = 0, 0.0, 0.0, []
    for g, (boxes, scores) in zip(golden["pages"], results):
        pairs, miss = match_boxes(g["boxes"], g["scores"], boxes, scores, tol["box_px"])
        n_pairs += len(pairs)
        unmatched += miss
        for _, _, px, ds in pairs:
            worst_px, worst_score = max(worst_px, px), max(worst_score, ds)
    if worst_score > tol["score"]:
        raise AssertionError(f"a detection's score differs from the golden by {worst_score:.2e}"
                             f" > {tol['score']}")
    far = [u for u in unmatched if abs(u[1] - conf_thresh) > tol["near"]]
    if len(unmatched) > tol["unmatched"] or far:
        raise AssertionError(f"unmatched boxes {unmatched} (at most {tol['unmatched']}, each "
                             f"scored within {tol['near']} of {conf_thresh})")
    return n_pairs, worst_px, worst_score, unmatched


def check_page_strings(golden, regions_per_page):
    """Page phase (a)'s gate: on every region whose integer box equals the
    golden's, the same string, but at most MAX_PAGE_STRING_MISSES.
    Returns (regions compared, misses)."""
    compared, misses = 0, []
    for p, (g, regions) in enumerate(zip(golden["pages"], regions_per_page)):
        ours = {tuple(box): latex for box, latex in regions}
        for r in g["regions"]:
            if tuple(r["box"]) in ours:
                compared += 1
                if ours[tuple(r["box"])] != r["latex"]:
                    misses.append((p, r["box"], ours[tuple(r["box"])], r["latex"]))
    if len(misses) > MAX_PAGE_STRING_MISSES or compared == 0:
        raise AssertionError(f"page strings: {len(misses)} of {compared} differ from the golden "
                             f"(at most {MAX_PAGE_STRING_MISSES}): {misses}")
    return compared, misses


def detect_phase(t0):
    """The released detector on the golden pages against JAX's boxes, run
    as the app and the server run it (the process's cuDNN TF32 setting as
    torch leaves it) and again with TF32 off in the whole process: the
    boxes must not move.  Then its parts timed on a page."""
    import numpy as np
    import torch

    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
    from doc2tex_tpu_torch.tools.profile_page import detect_timings

    golden, pages = golden_pages()
    det = MathDetector(SHIPPED_WEIGHTS, conf_thresh=golden["conf_thresh"],
                       iou_thresh=golden["nms_iou"], expand_frac=golden["expand_frac"])
    with users_tf32():
        results = [det.detect_page(page) for page in pages]
    n_pairs, worst_px, worst_score, unmatched = check_detections(
        golden, results, golden["conf_thresh"])
    off = [det.detect_page(page) for page in pages]       # TF32 off process-wide (main)
    if not all(np.array_equal(a, b) for r, o in zip(results, off) for a, b in zip(r, o)):
        raise AssertionError("the detector's boxes depend on the process's cuDNN TF32 setting")
    # what the detector's own setting keeps out: its bare forward under the
    # process's TF32 against the path's (printed, not gated)
    x = det.model_input(det.page_windows(pages[0])[0])
    with torch.inference_mode():
        want = det.ssd(x)
        with users_tf32():
            got = det.model(x)
    tf32_diff = max((g - w).abs().max().item() for g, w in zip(got, want))
    log("detect", t0, f"{len(pages)} golden pages ({'x'.join(map(str, golden['page_hw']))}), "
        f"cuDNN TF32 as torch leaves it ({USERS_CUDNN_TF32}): {n_pairs} boxes matched to the JAX "
        f"package's within {worst_px:.4f} px (tol {BOX_TOL_PX}) and scores within "
        f"{worst_score:.2e} (tol {SCORE_TOL}); unmatched {unmatched}; the same bits with TF32 "
        f"off process-wide; SSD512's bare forward under TF32 {USERS_CUDNN_TF32} would differ "
        f"from the path's by up to {tf32_diff:.3e} in loc/conf")
    tm = detect_timings(det, pages[0])
    log("detect", t0, f"page 0 ({tm['windows']} windows, float32, TF32 off): SSD512 forward "
        f"{tm['ssd_ms']:.2f} ms (bound {tm['ssd_bound_ms']:.2f} ms: {tm['ssd_gflop']:.0f} GFLOP "
        f"at {F32_FLOPS / 1e12:.0f} TFLOP/s; achieved {tm['ssd_tflop_per_s']:.1f} TFLOP/s), "
        f"per-window decode + NMS {tm['window_nms_ms']:.2f} ms, page NMS "
        f"{tm['page_nms_ms']:.2f} ms ({tm['page_nms_boxes']} candidates), detect_page whole "
        f"{tm['detect_page_ms']:.2f} ms (host clock)")
    print(json.dumps({"detect_timings": tm}), file=sys.stderr, flush=True)


def page_phase(t0):
    """App with the shared synthetic_tfm_big recognizer: (a) float32 on the
    golden pages (TF32 off process-wide), (b) the page-eval twin against
    the reference's record and (c) POST /recognize_page, both with the
    process's TF32 settings as torch leaves them, as users run them."""
    from doc2tex_tpu_torch.app import App
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
    from doc2tex_tpu_torch.tools.page_eval import evaluate

    golden, pages = golden_pages()
    cfg, weights = load_recog_config(version=golden["recognizer"]["version"])
    cfg["dtype"], cfg["quantize"] = "float32", None
    app = App(recognizer=MathRecognition(cfg, weights, beam_size=golden["recognizer"]["beam"]))
    decode_attention.launches = 0
    t = time.perf_counter()
    regions = [app(page) for page in pages]
    seconds = time.perf_counter() - t
    launches = decode_attention.launches
    compared, misses = check_page_strings(golden, regions)
    if launches <= 0:
        raise AssertionError("the page path launched decode_attention 0 times")
    log("page", t0, f"(a) {len(pages)} golden pages, synthetic_tfm_big float32 beam 10: "
        f"{sum(map(len, regions))} regions, {compared - len(misses)}/{compared} strings equal to "
        f"the JAX package's where the boxes are equal (misses {misses}); {seconds:.2f} s, "
        f"{launches} decode_attention launches ({launches / len(pages):.0f} a page)")

    with open(PAGE_EVAL_REF[0]) as f:
        ref = json.load(f)[PAGE_EVAL_REF[1]]
    with users_tf32():
        row = evaluate(pages=PAGE_EVAL_PAGES, version=ref["version"], coalesce_ratio=0)
    # each of the port's rates inside the reference's Wilson interval
    inside = {k: ref[f"{ci}_ci"][0] <= row[k] <= ref[f"{ci}_ci"][1] for k, ci in (
        ("det_precision", "det_precision"), ("det_recall", "det_recall"),
        ("end_to_end_acc", "end_to_end"))}
    log("page", t0, f"(b) page-eval twin, {row['pages']} pages / {row['gt_regions']} regions, "
        f"quantize {row['quantize']}, beam {row['beam']}, coalesce {row['coalesce_ratio']}: "
        f"precision {row['det_precision']} {row['det_precision_ci']} (reference "
        f"{ref['det_precision']} {ref['det_precision_ci']}), recall {row['det_recall']} "
        f"{row['det_recall_ci']} (reference {ref['det_recall']} {ref['det_recall_ci']}), "
        f"det-F1 {row['det_f1']} (reference {ref['det_f1']}), em_matched {row['em_matched']} "
        f"(reference {ref['em_matched']}), end to end {row['end_to_end_acc']} "
        f"{row['end_to_end_ci']} (reference {ref['end_to_end_acc']} {ref['end_to_end_ci']}); "
        f"detect {row['detect_s_per_page']} s a page, recognize {row['recog_s_per_page']} s a "
        "page (host clock)")
    print(json.dumps({"page_eval": row}), file=sys.stderr, flush=True)
    if not all(inside.values()):
        raise AssertionError(f"page eval outside the reference's interval: {inside}")

    with users_tf32():
        page_request(t0, ref["version"], pages[0])


def page_request(t0, version, page):
    """Page phase (c): the HTTP front with ``--detect`` in this process,
    one PNG page twice; B1 must launch during the second request."""
    import threading
    from http.client import HTTPConnection
    from http.server import ThreadingHTTPServer

    from doc2tex_tpu_torch.api import serve
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.utils.png import encode_png

    args = serve.parse_args(["--model_version", version, "--detect"])
    recog, server = serve.build_server(args)
    page_server = serve.build_page_server(args, recog, server)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_handler(
        server, page_server, config_info={"model_version": version,
                                          "beam_size": recog.beam_size}))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        body = encode_png(page)
        replies = []
        for _ in range(2):      # the first request warms the page's buckets; the second is counted
            decode_attention.launches = 0
            conn = HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=600)
            conn.request("POST", "/recognize_page", body=body)
            resp = conn.getresponse()
            replies.append((resp.status, json.loads(resp.read())))
            conn.close()
        launches = decode_attention.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        page_server.close()
        server.close()
        thread.join(timeout=30)
    status, payload = replies[-1]
    regions = payload.get("regions") or []
    if status != 200 or not regions or launches <= 0 or not all(
            len(r["box"]) == 4 and isinstance(r["latex"], str) for r in regions):
        raise AssertionError(f"POST /recognize_page: {status} {payload}, {launches} B1 launches")
    log("page", t0, f"(c) HTTP POST /recognize_page ({len(body)} B PNG, --detect, int8 as "
        f"shipped) -> 200 in {payload['ms']} ms, {len(regions)} regions, {launches} "
        f"decode_attention launches: {regions[0]}")


def _adam_grads(opt_state) -> dict:
    """The gradient of an Adam step read back from its first moment, which
    is (1 - b1) g = 0.1 g after one step; on the CPU, as float32."""
    return {k: (v / 0.1).float().cpu() for k, v in opt_state[0].mu.items()}


def _detect_step(model, batch):
    """One Adam step (lr 1e-4) of the detector's train step on ``batch``
    (the pool's float32 windows, gt, valid); returns (metrics as floats,
    gradients, the weights after the step on the CPU)."""
    from doc2tex_tpu_torch.detection.data import make_detection_train_step
    from doc2tex_tpu_torch.detection.priors import make_priors
    from doc2tex_tpu_torch.tools.detection_soak import LR
    from doc2tex_tpu_torch.train.optim import adam
    from doc2tex_tpu_torch.train.trainer import named_params

    tx = adam(LR)
    params = named_params(model)
    _, opt_state, m = make_detection_train_step(model, make_priors(), tx)(
        params, tx.init(params), *batch)
    return ({k: float(v) for k, v in m.items()}, _adam_grads(opt_state),
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def detect_step_parity(t0, golden, device="cuda", n=None):
    """detect_train (a): the shipped detector, one float32 step on the
    pool's first ``n`` (default the golden's batch) windows, ``device``
    against the CPU, and the CPU against itself under WEIGHT_NOISE."""
    import copy
    import hashlib

    import torch

    from doc2tex_tpu_torch.detection.data import detection_input
    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
    from doc2tex_tpu_torch.detection.loss import multibox_loss
    from doc2tex_tpu_torch.detection.priors import make_priors
    from doc2tex_tpu_torch.tools import detection_soak

    n = n or golden["batch"]
    n_first = golden["batch"] * len(golden["step_losses"])
    pool = detection_soak.build_pool("windows", golden["neg_frac"], detection_soak.N_POOL,
                                     first=n_first)
    first = pool["images"][:golden["batch"]]
    if (hashlib.sha256(first.tobytes()).hexdigest() != golden["pool_sha256"]
            or hashlib.sha256(pool["images"].tobytes()).hexdigest()
            != golden["pool_sha256_steps"]):
        raise AssertionError("(a) the pool's first windows differ from the JAX tool's")
    batch = (pool["images"][:n], pool["gt"][:n], pool["valid"][:n])
    cpu_model = MathDetector(SHIPPED_WEIGHTS, device="cpu").model.train()
    noisy = copy.deepcopy(cpu_model)
    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for p in noisy.parameters():
            p.mul_(1 + WEIGHT_NOISE * torch.randn(p.shape, generator=gen))
    noisy_grads = _detect_step(noisy, batch)[1]
    del noisy
    m0, g0, p0 = _detect_step(cpu_model, batch)
    m1, g1, p1 = _detect_step(MathDetector(SHIPPED_WEIGHTS, device=device).model.train(), batch)
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g0.values())))
    own, worst = (_worst_leaves(noisy_grads, g0, norm)[False],
                  _worst_leaves(g1, g0, norm)[False])    # no leaf of SSD512 is a ResNet's
    tol = max(TRAIN_TOL["grad_rtol"], SPREAD_FACTOR * own[0])
    diffs = torch.cat([(p1[k] - p0[k]).abs().flatten() for k in p0])
    far = (diffs > 1e-6).float().mean().item()
    loss_err = abs(m1["loss"] - m0["loss"]) / abs(m0["loss"])
    jax_loss = golden["first_step"]["loss"] if n == golden["batch"] else None
    jax_err = abs(m1["loss"] - jax_loss) / abs(jax_loss) if jax_loss else 0.0
    # the same windows with the mean taken off once, as the app and the
    # held-out evaluation feed the detector (the soak's pool holds windows
    # with the mean off and its step takes it off again); printed only
    model = MathDetector(SHIPPED_WEIGHTS, device=device).model.eval()
    with torch.no_grad():
        x = detection_input(torch.from_numpy(batch[0]).to(device),
                            torch.zeros(3, device=device))
        once = sum(multibox_loss(*model(x), torch.from_numpy(batch[1]).to(device),
                                 torch.from_numpy(batch[2]).to(device),
                                 torch.from_numpy(make_priors()).to(device))).item()
    log("detect_train", t0, f"(a) float32 Adam step (lr 1e-4) on the windows pool's first {n} "
        f"windows (sha256 as the JAX tool's), {device} against cpu: loss {m1['loss']:.7f} / "
        f"{m0['loss']:.7f} (rel {loss_err:.2e}; JAX {jax_loss} rel {jax_err:.2e}), loss_loc "
        f"{m1['loss_loc']:.7f} / {m0['loss_loc']:.7f}, loss_conf {m1['loss_conf']:.7f} / "
        f"{m0['loss_conf']:.7f}; worst gradient leaf {worst[0]:.2e} of its norm ({worst[1]}; "
        f"tolerance {tol:.2e}: the CPU against itself with its weights scaled by "
        f"(1 + {WEIGHT_NOISE:g} N(0, 1)) moves its worst leaf by {own[0]:.2e}, {own[1]}); "
        f"weights after the step: max |diff| {diffs.max().item():.3e}, {far:.4%} further than "
        f"1e-6; the same windows with the mean taken off once: loss {once:.5f}")
    if not (loss_err <= TRAIN_TOL["loss_rtol"] and jax_err <= TRAIN_TOL["loss_rtol"]
            and worst[0] <= tol and far <= TRAIN_TOL["param_far_share"]):
        raise AssertionError("(a) the card's float32 detector step disagrees with the CPU's")
    if n == golden["batch"]:
        detect_steps_against_jax(t0, golden, pool, device)


def detect_steps_against_jax(t0, golden, pool, device):
    """detect_train (a'): Adam steps from the shipped detector on the pool's
    windows in order (``golden["batch"]`` a step) on ``device``, each
    loss within DETECT_STEPS_RTOL of the JAX package's."""
    from doc2tex_tpu_torch.detection.data import make_detection_train_step
    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
    from doc2tex_tpu_torch.detection.priors import make_priors
    from doc2tex_tpu_torch.tools.detection_soak import LR
    from doc2tex_tpu_torch.train.optim import adam
    from doc2tex_tpu_torch.train.trainer import named_params

    model = MathDetector(SHIPPED_WEIGHTS, device=device).model.train()
    tx = adam(LR)
    params = named_params(model)
    opt_state = tx.init(params)
    step = make_detection_train_step(model, make_priors(), tx)
    losses, B = [], golden["batch"]
    for i in range(len(golden["step_losses"])):
        b = slice(i * B, (i + 1) * B)
        params, opt_state, m = step(params, opt_state, pool["images"][b], pool["gt"][b],
                                    pool["valid"][b])
        losses.append(float(m["loss"]))
    errs = [abs(a - w) / abs(w) for a, w in zip(losses, golden["step_losses"])]
    log("detect_train", t0, f"(a') {len(losses)} Adam steps from the shipped weights on the "
        f"pool's windows in order, batch {B}: losses {[f'{v:.6f}' for v in losses]} against "
        f"the JAX package's {[f'{v:.6f}' for v in golden['step_losses']]} (rel "
        f"{', '.join(f'{e:.1e}' for e in errs)}; tol {DETECT_STEPS_RTOL})")
    if max(errs) > DETECT_STEPS_RTOL:
        raise AssertionError("(a') the card's Adam steps leave the JAX package's losses")


def check_soak_eval(golden, ev):
    """detect_train (c): each held-out window's boxes paired with the
    golden's (``check_detections`` at conf 0.3) and the CROHME counts equal."""
    results = list(zip(ev["preds"], ev["pred_scores"]))
    pairs, worst_px, worst_score, unmatched = check_detections(
        {"pages": golden["eval"]}, results, golden["conf_thresh"])
    counts = ("allGTbox", "allDet", "correctDet_c", "correctDet_f")
    if any(ev["scores"][k] != golden["scores"][k] for k in counts):
        raise AssertionError(f"(c) CROHME counts {ev['scores']} differ from the golden's "
                             f"{golden['scores']}")
    return pairs, worst_px, worst_score, unmatched


def detect_train_phase(t0, device="cuda", n=None, soak_steps=DETECT_SOAK_STEPS, n_pages=None):
    """Phase 12b: the detector's training and the voting stitch.  ``n``,
    ``soak_steps`` and ``n_pages`` cut (a)'s batch, (b)'s steps and (e)'s
    pages for a rehearsal on the CPU."""
    import tempfile

    import numpy as np
    import torch

    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
    from doc2tex_tpu_torch.tools import detection_soak

    with open(GOLDEN_DETECT_SOAK) as f:
        golden = json.load(f)
    detect_step_parity(t0, golden, device, n)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        path = os.path.join(ckpt_dir, "last.msgpack")
        argv = ["--style", "windows", "--steps", str(soak_steps), "--init_from",
                SHIPPED_WEIGHTS, "--save", path, "--device", device]
        t = time.perf_counter()
        out = detection_soak.run(detection_soak.parse_args(argv))
        seconds = time.perf_counter() - t
        losses = out["losses"]
        early, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        log("detect_train", t0, f"(b) python -m doc2tex_tpu_torch.tools.detection_soak "
            f"--style windows --init_from {os.path.relpath(SHIPPED_WEIGHTS, ROOT)} --steps "
            f"{soak_steps}: pool {out['n_pos']} positive / {out['n_neg']} negative "
            f"windows built in {out['pool_build_s']:.1f} s, upload {out['pool_mb']:.0f} MB in "
            f"{out['upload_s']:.3f} s; {out['steps_per_s']:.2f} steps/s at batch 8 "
            f"({out['train_s']:.1f} s, float32, TF32 off), peak memory "
            f"{(out['peak_bytes'] or 0) / 2**30:.2f} GiB; loss {losses[0]:.4f} first, first 10 "
            f"mean {early:.4f}, last 10 mean {last:.4f} (at most {DETECT_SOAK_LOSS_FACTOR} x the "
            f"first 10's); held-out {out['scores']}; {seconds:.1f} s in all")
        print(json.dumps({"detect_soak_losses": losses}), file=sys.stderr, flush=True)
        if not (len(losses) == soak_steps and np.all(np.isfinite(losses))
                and last <= DETECT_SOAK_LOSS_FACTOR * early):
            raise AssertionError(f"(b) the soak's losses {losses}")

        # (d) the saved checkpoint against the in-memory model, on a golden page
        _, pages = golden_pages()
        saved = MathDetector(path, device=device)
        live = MathDetector(path, device=device)
        live.model = out["model"].eval()
        a, b = saved.detect_page(pages[0]), live.detect_page(pages[0])
        if not (all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a[0])):
            raise AssertionError("(d) the saved checkpoint's boxes differ from the model's")
        log("detect_train", t0, f"(d) {os.path.basename(path)} reloaded by MathDetector: "
            f"{len(a[0])} boxes on golden page 0, equal to the in-memory model's")
        del out, saved, live

    argv = ["--style", "windows", "--steps", "0", "--init_from", SHIPPED_WEIGHTS, "--save", "",
            "--device", device]
    ev = detection_soak.run(detection_soak.parse_args(argv))
    pairs, worst_px, worst_score, unmatched = check_soak_eval(golden, ev)
    log("detect_train", t0, f"(c) --steps 0, the shipped weights on {len(ev['preds'])} held-out "
        f"windows (seed 99, conf 0.3, NMS 0.3): {pairs} boxes paired with the JAX package's "
        f"within {worst_px:.4f} px and scores within {worst_score:.2e}; unmatched {unmatched}; "
        f"CROHME {ev['scores']} (golden {golden['scores']})")
    del ev
    if device != "cpu":
        torch.cuda.empty_cache()
    stitch_check(t0, device, n_pages)


def stitch_check(t0, device="cuda", n_pages=None):
    """detect_train (e): ``detect_page(raw=True)`` + ``stitch_page`` on the
    golden pages against the JAX package's stitched boxes, then
    ``App(stitch=True)``'s strings, B1 launching."""
    import numpy as np

    from doc2tex_tpu_torch.app import App
    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector
    from doc2tex_tpu_torch.detection.stitch import _to_ink_mask, label_components, stitch_page
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config

    with open(GOLDEN_STITCH) as f:
        golden = json.load(f)
    _, pages = golden_pages()
    pages = pages[:n_pages]
    golden["pages"] = golden["pages"][:len(pages)]
    det = MathDetector(SHIPPED_WEIGHTS, conf_thresh=golden["conf_thresh"], device=device)
    n_boxes = exact = 0
    worst, stitch_ms, label_ms, n_raw = 0.0, [], [], []
    for g, page in zip(golden["pages"], pages):
        raw_boxes, raw_scores = det.detect_page(page, raw=True)
        bs = np.concatenate([raw_boxes, raw_scores[:, None]], axis=1)
        t = time.perf_counter()
        boxes = stitch_page(bs, page.shape[:2], page_image=page, thresh_votes=golden["thresh_votes"])
        stitch_ms.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        label_components(_to_ink_mask(page))
        label_ms.append(1e3 * (time.perf_counter() - t))
        n_raw.append(len(raw_boxes))
        want = np.asarray(g["boxes"], np.float64).reshape(-1, 4)
        got = np.asarray(boxes, np.float64).reshape(-1, 4)
        taken = np.zeros(len(got), bool)
        for box in want:
            dist = np.abs(got - box).max(axis=1) if len(got) else np.zeros(0)
            dist[taken] = np.inf
            j = int(np.argmin(dist)) if len(dist) else -1
            if j < 0 or dist[j] > STITCH_TOL_PX:
                raise AssertionError(f"(e) stitched box {box.tolist()} has no box of ours within "
                                     f"{STITCH_TOL_PX} px: {got.tolist()}")
            taken[j] = True
            worst = max(worst, float(dist[j]))
            exact += int(dist[j] == 0)
        if not taken.all():
            raise AssertionError(f"(e) extra stitched boxes {got[~taken].tolist()}")
        n_boxes += len(want)
    log("detect_train", t0, f"(e) voting stitch (equal votes >= {golden['thresh_votes']}, fit to "
        f"the ink) on {len(pages)} golden pages, {n_raw} raw boxes: {n_boxes} stitched boxes "
        f"paired with the JAX package's, {exact} exactly equal, worst {worst:.0f} px (tol "
        f"{STITCH_TOL_PX}); stitch_page {', '.join(f'{v:.1f}' for v in stitch_ms)} ms a page, "
        f"of which the page's ink labelling {', '.join(f'{v:.1f}' for v in label_ms)} ms "
        f"(host clock, numpy)")

    cfg, weights = load_recog_config(version=golden["recognizer"]["version"])
    cfg["dtype"], cfg["quantize"] = "float32", None
    app = App(recognizer=MathRecognition(cfg, weights, beam_size=golden["recognizer"]["beam"],
                                         device=device),
              stitch=True, stitch_votes=golden["thresh_votes"], device=device)
    decode_attention.launches = 0
    t = time.perf_counter()
    regions = [app(page) for page in pages]
    seconds = time.perf_counter() - t
    launches = decode_attention.launches
    compared, misses = check_page_strings(golden, regions)
    log("detect_train", t0, f"(e) App(stitch=True), synthetic_tfm_big float32 beam 10: "
        f"{sum(map(len, regions))} regions, {compared - len(misses)}/{compared} strings equal to "
        f"the JAX package's where the boxes are equal (misses {misses}); {seconds:.2f} s, "
        f"{launches} decode_attention launches")
    if device != "cpu" and launches <= 0:
        raise AssertionError("App(stitch=True) launched decode_attention 0 times")


def _resnet_leaf(name: str) -> bool:
    return "ResNetFeatureExtractor_0" in name


def train_config(**overrides):
    """The release recipe with the phase's cuts."""
    from doc2tex_tpu_torch.config import load_config

    cfg = load_config(TRAIN_CONFIG)
    cfg.update(TRAIN_CUTS)
    cfg.update(overrides)
    return cfg


def fixed_batch(cfg, n, bucket, seed=90):
    """``n`` hard crops of the config's generator padded into ``bucket``
    (uint8 (n, H, W, 1)) and their encoded labels."""
    import numpy as np

    from doc2tex_tpu_torch.data.buckets import pad_to_bucket
    from doc2tex_tpu_torch.data.synthetic import synth_hard_dataset
    from doc2tex_tpu_torch.tokenizer.converters import create_converter

    kw = dict(cfg.get("synthetic_kwargs") or {})
    kw.update(max_h=min(kw.get("max_h", bucket[0]), bucket[0]),
              max_w=min(kw.get("max_w", bucket[1]), bucket[1]))
    images, labels = synth_hard_dataset(n, seed=seed, **kw)
    batch = np.stack([pad_to_bucket(im, bucket) for im in images])[..., None]
    text, _ = create_converter(cfg).encode([lb.split() for lb in labels],
                                           cfg["batch_max_length"])
    return batch, text


def _worst_leaves(got, want, norm):
    """The worst gradient leaf against its norm (+ grad_floor of the whole
    gradient's), over the ResNet (key True) and the rest (False)."""
    worst = {True: (0.0, ""), False: (0.0, "")}
    for k, g in want.items():
        rel = (got[k] - g).abs().max().item() / (g.norm().item() + TRAIN_TOL["grad_floor"] * norm)
        worst[_resnet_leaf(k)] = max(worst[_resnet_leaf(k)], (rel, k))
    return worst


def _train_step_parity(t0, cfg, weights, batch, text, device, phase="train", spread=False):
    """(a): one float32 step of the same state on ``device`` and on the CPU,
    dropout and the augmentation off.  With ``spread``, the CPU's gradient again with the weights scaled by
    (1 + WEIGHT_NOISE N(0, 1)): the ResNet's leaves are then held within
    the larger of ``grad_rtol`` and SPREAD_FACTOR times the CPU's own
    spread (its float32 gradient is not smooth: ReLU choices flip)."""
    import copy

    import torch

    from doc2tex_tpu_torch.engine.training import init_training
    from doc2tex_tpu_torch.train.trainer import loss_and_grads
    from doc2tex_tpu_torch.transforms.augment import normalize

    cfg = copy.deepcopy(cfg)
    # dropout and the augmentation draw from a generator on the device, so the
    # card and the CPU would draw differently: both off, the same inputs
    cfg.update(dtype="float32", warmup_epochs=0, pretrained_weight=weights, augment=False)
    head = cfg["Prediction"]["params"]
    head["droprate" if cfg["Prediction"]["name"].startswith("Attn") else "dropout"] = 0.0
    runs, own = {}, (0.0, "")
    for dev in ("cpu", device):
        b = init_training(copy.deepcopy(cfg), device=dev)
        x = normalize(torch.from_numpy(batch).to(dev))
        tokens = torch.from_numpy(text).to(dev).long()
        _, _, grads = loss_and_grads(copy.deepcopy(b.model), b.criterion, x, tokens)
        if spread and dev == "cpu":
            noisy = copy.deepcopy(b.model)
            gen = torch.Generator().manual_seed(17)
            with torch.no_grad():
                for p in noisy.parameters():
                    p.mul_(1 + WEIGHT_NOISE * torch.randn(p.shape, generator=gen))
            _, _, noisy_grads = loss_and_grads(noisy, b.criterion, x, tokens)
            norm = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
            own = _worst_leaves(noisy_grads, grads, norm)[True]
            del noisy, noisy_grads
        m = b.train_step(b.state, batch, text, torch.Generator().manual_seed(5))
        runs[dev] = (float(m["loss"]), float(m["grad_norm"]),
                     {k: g.cpu() for k, g in grads.items()},
                     {k: v.cpu() for k, v in b.model.state_dict().items()})
        del b
    (l0, n0, g0, p0), (l1, n1, g1, p1) = runs["cpu"], runs[device]
    loss_err, norm_err = abs(l1 - l0) / abs(l0), abs(n1 - n0) / abs(n0)
    worst = _worst_leaves(g1, g0, n0)
    resnet_tol = max(TRAIN_TOL["grad_rtol"], SPREAD_FACTOR * own[0])
    diffs = torch.cat([(p1[k] - p0[k]).abs().flatten() for k in p0])
    far = (diffs > 1e-6).float().mean().item()
    log(phase, t0, f"(a) float32 step, {device} against cpu, batch {batch.shape[0]} at "
        f"{batch.shape[1:3]}, lr {float(cfg['optimizer']['lr']):g}: loss {l1:.7f} / {l0:.7f} (rel {loss_err:.2e}), "
        f"grad_norm {n1:.6f} / {n0:.6f} (rel {norm_err:.2e}), worst gradient leaf "
        f"{worst[False][0]:.2e} of its norm ({worst[False][1]}; ResNet {worst[True][0]:.2e}, "
        f"{worst[True][1]}), weights after the step: "
        f"max |diff| {diffs.max().item():.3e}, {far:.4%} further than 1e-6 (tolerances "
        f"{TRAIN_TOL}" + (f"; the ResNet's {resnet_tol:.2e}: the CPU against itself with "
                          f"its weights scaled by (1 + {WEIGHT_NOISE:g} N(0, 1)) moves its "
                          f"worst leaf by {own[0]:.2e} ({own[1]})" if spread else "") + ")")
    tol = TRAIN_TOL
    if not (loss_err <= tol["loss_rtol"] and norm_err <= tol["grad_norm_rtol"]
            and worst[False][0] <= tol["grad_rtol"] and worst[True][0] <= resnet_tol
            and far <= tol["param_far_share"]):
        raise AssertionError("(a) the card's float32 train step disagrees with the CPU's")


def _bf16_steps(t0, phase, cfg, n, bucket, device, batch=None):
    """(b): TRAIN_BF16_STEPS steps of the config's type on one fixed batch
    (``fixed_batch``'s, or ``batch``: (images, text)) from a seeded random
    init: every loss finite and the last below the first; steps/s and the
    peak memory printed.  Returns the batch."""
    import copy

    import numpy as np
    import torch

    from doc2tex_tpu_torch.engine.training import init_training

    cuda = device != "cpu"
    batch, text = batch if batch is not None else fixed_batch(cfg, n, bucket)
    b = init_training(copy.deepcopy(cfg), device=device)
    gen = torch.Generator().manual_seed(7)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, t_start = [], None
    for i in range(TRAIN_BF16_STEPS):
        if i == 2:
            if cuda:
                torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(b.train_step(b.state, batch, text, gen)["loss"])
    losses = [float(x) for x in losses]   # the host copy syncs
    seconds = time.perf_counter() - t_start
    timed = TRAIN_BF16_STEPS - 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
    log(phase, t0, f"(b) {cfg['dtype']} steps on one batch of {n} at {bucket}, text "
        f"{text.shape[1]} wide (decoder length {text.shape[1] - 1}), random init: losses "
        f"{[round(x, 4) for x in losses]}; {timed / seconds:.3f} steps/s "
        f"({1e3 * seconds / timed:.1f} ms/step over {timed} steps after 2), peak memory "
        f"allocated {peak:.2f} GiB; {nvidia_smi() if cuda else 'cpu'}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"(b) losses not finite or not falling: {losses}")
    return batch, text


def _checkpoint_checks(t0, phase, run_cfg, bundle, log_dir, rcfg, crops, batch, text, device,
                       steps=("d", "e")):
    """The run's best checkpoints in ``MathRecognition`` against the
    in-memory model (greedy strings on ``crops``), then the resume from
    ``last_checkpoint`` bit for bit: every tensor of the state, and the next
    step's loss with ``torch.backends.cudnn.deterministic`` on."""
    import copy

    import numpy as np
    import torch

    from doc2tex_tpu_torch.engine.training import init_training
    from doc2tex_tpu_torch.recognition import MathRecognition
    from doc2tex_tpu_torch.train.optim import state_to_flax

    mem = MathRecognition(copy.deepcopy(rcfg), None, beam_size=1, device=device)
    mem.model.load_state_dict(bundle.model.state_dict())
    want = mem(crops)
    for name in ("best_accuracy.msgpack", "best_bleu.msgpack"):
        rec = MathRecognition(copy.deepcopy(rcfg), os.path.join(log_dir, name),
                              beam_size=1, device=device)
        got = rec(crops)
        if got != want:
            raise AssertionError(f"({steps[0]}) {name} decodes otherwise than the in-memory "
                                 "model")
    log(phase, t0, f"({steps[0]}) best_accuracy and best_bleu .msgpack ({os.path.getsize(os.path.join(log_dir, 'best_accuracy.msgpack')) / 2 ** 20:.1f} MiB each) "
        f"in MathRecognition: the in-memory model's greedy strings on {len(crops)} crops")

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        resumed = init_training(dict(copy.deepcopy(run_cfg), pretrained_weight=None,
                                     resume_path=os.path.join(log_dir,
                                                              "last_checkpoint.msgpack")),
                                device=device)
        if resumed.state.step != bundle.state.step or resumed.start_iter != run_cfg["num_iter"]:
            raise AssertionError(f"({steps[1]}) resumed at step {resumed.state.step}")
        same = all(torch.equal(a, b) for a, b in zip(
            resumed.model.state_dict().values(), bundle.model.state_dict().values()))
        leaves = lambda s: [np.asarray(x) for x in _flat(state_to_flax(s))]   # noqa: E731
        same = same and all(np.array_equal(a, b) for a, b in zip(
            leaves(resumed.state.opt_state), leaves(bundle.state.opt_state)))
        gen = torch.Generator().manual_seed(run_cfg.get("manualSeed", 1111) + 1)
        go = bundle.train_step(bundle.state, batch, text, gen)
        back = resumed.train_step(resumed.state, batch, text, gen)
        after = max((a - b).abs().max().item() for a, b in zip(
            resumed.model.state_dict().values(), bundle.model.state_dict().values()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    lu, lr_ = float(go["loss"]), float(back["loss"])
    log(phase, t0, f"({steps[1]}) resumed from last_checkpoint at step {resumed.start_iter}: "
        f"state {'equal' if same else 'NOT equal'} bit for bit; step {bundle.state.step} loss "
        f"{lr_!r} resumed, {lu!r} uninterrupted (cudnn deterministic); weights after it "
        f"within {after:.3e}")
    if not same or lu != lr_:
        raise AssertionError(f"({steps[1]}) the resumed run differs from the uninterrupted one")


def train_phase(t0, cfg=None, weights=TFM_BIG_WEIGHTS, recog=None, crops=None,
                device="cuda", fixed=(32, TRAIN_FIXED_BUCKET), parity_batch=(4, (96, 352))):
    """The training path (phase 13).  ``cfg``, ``recog`` (a recognizer
    config) and ``crops`` default to the release recipe, the released
    ``synthetic_tfm_big`` block and the golden crops; a test passes tiny
    ones to rehearse the phase on the CPU."""
    import copy
    import tempfile

    from doc2tex_tpu_torch.engine.inferencing import validation
    from doc2tex_tpu_torch.engine.training import init_training, train
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.recognition import load_recog_config
    from doc2tex_tpu_torch.data.loader import ArrayDataset, BucketLoader
    from doc2tex_tpu_torch.data.synthetic import synth_hard_dataset
    from doc2tex_tpu_torch.decode.runner import make_decode_fn
    from doc2tex_tpu_torch.weights import load_weights

    cuda = device != "cpu"
    cfg = cfg or train_config()
    log("train", t0, f"{os.path.relpath(TRAIN_CONFIG, ROOT)} cut to "
        f"{ {k: cfg[k] for k in TRAIN_CUTS} }; "
        f"batch {cfg['batch_size']}, ladder {cfg['min_dimension']}..{cfg['max_dimension']} "
        f"growth {cfg['bucket_growth']}, batch_max_length {cfg['batch_max_length']}, "
        f"dtype {cfg['dtype']}")

    # (a) float32 card step against the CPU
    n, bucket = parity_batch
    _train_step_parity(t0, cfg, weights, *fixed_batch(cfg, n, bucket, seed=91), device)

    # (b) bf16 steps on one fixed batch from a seeded random init; steps/s
    batch, text = _bf16_steps(t0, "train", cfg, *fixed, device)

    # (c) the run from the shipped weights; its validation launches B1
    run_cfg = dict(copy.deepcopy(cfg), pretrained_weight=weights)
    shipped = init_training(copy.deepcopy(run_cfg), device=device)
    if weights:
        load_weights(shipped.model, weights)      # the statistics too, for this check
    # the run's validation split, as build_loader makes it
    seed = run_cfg.get("manualSeed", 1111)
    images, labels = synth_hard_dataset(max(int(run_cfg["synthetic_data"]) // 10, 4),
                                        seed=seed + 1, **run_cfg.get("synthetic_kwargs", {}))
    valid = BucketLoader(ArrayDataset(images, labels), run_cfg, converter=shipped.converter,
                         seed=seed)
    val = validation(make_decode_fn(shipped.model, run_cfg, beam_size=1, device=device),
                     shipped.converter, valid, run_cfg)
    log("train", t0, f"(c) validation set: {val['n_samples']} samples in full batches; the "
        f"shipped weights (with their BatchNorm statistics), greedy: EM {val['accuracy']:.4f} "
        f"(gate >= {TRAIN_MIN_SHIPPED_EM}), BLEU {val['bleu']:.4f}")
    if val["n_samples"] == 0 or (weights and val["accuracy"] < TRAIN_MIN_SHIPPED_EM):
        raise AssertionError("(c) the shipped weights do not decode the validation set")
    del shipped
    with tempfile.TemporaryDirectory() as log_dir:
        bundle = init_training(copy.deepcopy(run_cfg), device=device)
        decode_attention.launches = 0
        with recorded_launches() as seen:
            t_run = time.perf_counter()
            metrics = train(run_cfg, log_dir, device=device, bundle=bundle)
            t_run = time.perf_counter() - t_run
        shapes, types = seen["b1"], seen["b1_types"]
        launches = decode_attention.launches
        ks = sorted({s[1] for s in shapes})
        log("train", t0, f"(c) {run_cfg['num_iter']} steps from the shipped weights (their "
            f"BatchNorm statistics fresh, as the JAX engine's pretrained_weight leaves them) "
            f"and a validation in {t_run:.1f} s: greedy EM {metrics['accuracy']:.4f}, loss "
            f"{metrics['loss']:.4f}, {metrics['n_samples']} samples; decode_attention "
            f"launches {launches}, K {ks}, (B, K, M, kind) shapes {sorted(shapes)[:6]} ... "
            f"{len(shapes)} in all")
        if cuda and (launches <= 0 or ks != [1] or len(types) != 1):
            raise AssertionError(f"(c) validation launched B1 {launches} times at K {ks}, "
                                 f"(heads, head dim, type) {types}")
        if cuda:
            _check_validation_shapes(t0, shapes, *types.pop()[:2])

        # (d) the best checkpoints in MathRecognition; (e) resume bit for bit
        rcfg = copy.deepcopy(recog or load_recog_config(version="synthetic_tfm_big")[0])
        rcfg.update(quantize=None, dtype=run_cfg["dtype"])
        crops = crops if crops is not None else golden_crops("synthetic_tfm_big")[1]
        _checkpoint_checks(t0, "train", run_cfg, bundle, log_dir, rcfg, crops, batch, text,
                           device)


def lstm_train_config(**overrides):
    """``config/train_synth.yaml`` with the train_lstm phase's cuts."""
    from doc2tex_tpu_torch.config import load_config

    cfg = load_config(LSTM_TRAIN_CONFIG)
    cfg.update(LSTM_TRAIN_CUTS)
    cfg.update(overrides)
    return cfg


def lstm_recipe_config():
    """The shipped ``synthetic`` recipe: the soak twin's ``--hard`` arm,
    with the hard vocabulary and the soak's generator arguments."""
    from doc2tex_tpu_torch.data.synthetic import hard_vocab
    from doc2tex_tpu_torch.tools import structured_soak

    cfg = structured_soak.arm_config(structured_soak.parse_args(["--hard"]))
    cfg.update(character=hard_vocab(), synthetic_kwargs=dict(structured_soak.HARD_KW))
    return cfg


def train_lstm_phase(t0, recipe=None, run_cfg=None, weights=SYNTHETIC_WEIGHTS, device="cuda",
                     fixed=(32, TRAIN_FIXED_BUCKET), soak_argv=LSTM_SOAK_ARGV):
    """The coverage-LSTM training path (phase 13b).  ``recipe`` (the
    ``synthetic`` recipe), ``run_cfg`` (``config/train_synth.yaml`` cut)
    and ``weights`` default to the full-width ones; a test passes tiny ones
    (and a soak whose ``build`` it swaps) to rehearse the phase on the CPU.
    Returns B2's backward's JSON record (launches from (c)) on the card,
    else None."""
    import copy
    import tempfile

    from doc2tex_tpu_torch.data.loader import build_loader
    from doc2tex_tpu_torch.engine.training import init_training, train
    from doc2tex_tpu_torch.ops.attention_step import (coverage_attention_step,
                                                      coverage_attention_step_backward)
    from doc2tex_tpu_torch.tools import structured_soak

    cuda = device != "cpu"
    recipe = recipe or lstm_recipe_config()
    run_cfg = run_cfg or lstm_train_config()
    head = recipe["Prediction"]["params"]
    log("train_lstm", t0, f"the synthetic recipe (soak --hard): batch {recipe['batch_size']}, "
        f"ladder {recipe['min_dimension']}..{recipe['max_dimension']} growth "
        f"{recipe['bucket_growth']}, batch_max_length {recipe['batch_max_length']}, "
        f"{recipe['dtype']}, {recipe['Prediction']['name']} {head['attn_type']} hidden "
        f"{head['hidden_size']} kernel_dim {head['kernel_dim']}, vocab "
        f"{len(recipe['character'])} + 3")
    shapes, inputs = set(), {}
    with recorded_launches() as seen:
        # (a) float32 card step against the CPU, from the shipped weights
        n, bucket = fixed
        _train_step_parity(t0, recipe, weights, *fixed_batch(recipe, n, bucket, seed=91),
                           device, phase="train_lstm", spread=True)
        # (b) bf16 steps on one fixed batch from a seeded random init
        _bf16_steps(t0, "train_lstm", recipe, n, bucket, device)

        # (c) the soak twin from the shipped weights, with device pools
        argv = list(soak_argv) + (["--init_from", os.path.relpath(weights, ROOT)]
                                  if weights else [])
        seen["b2"].clear()
        with tempfile.TemporaryDirectory() as ckpt_dir:
            args = structured_soak.parse_args(argv + ["--ckpt_dir", ckpt_dir, "--device", device])
            args.init_from = weights
            coverage_attention_step.launches = coverage_attention_step_backward.launches = 0
            t_run = time.perf_counter()
            soak = structured_soak.run(args)
            t_run = time.perf_counter() - t_run
            fwd = coverage_attention_step.launches
            bwd = coverage_attention_step_backward.launches
        before, after = soak["curve"][0], soak["curve"][-1]
        ks = sorted({s[1] for s in seen["b2"]})
        log("train_lstm", t0, f"(c) python -m doc2tex_tpu_torch.tools.structured_soak "
            f"{' '.join(argv)}: {len(soak['pools'])} device pools "
            f"{[(p.bucket, p.n) for p in soak['pools']]}, {t_run:.1f} s; beam-5 EM "
            f"{before['em']:.4f} before (the shipped weights, n {before['n']}), "
            f"{after['em']:.4f} after step {after['step']} (BLEU {after['bleu']}); "
            f"attention_step launches {fwd} (K {ks}), backward launches {bwd}")
        if (len(soak["curve"]) != 2 or not soak["pools"] or before["n"] == 0
                or (weights and before["em"] < TRAIN_MIN_SHIPPED_EM)):
            raise AssertionError(f"(c) the soak's curve {soak['curve']}")
        if cuda and (fwd <= 0 or bwd <= 0 or ks != [1, 5]):
            raise AssertionError(f"(c) B2 launched {fwd} times at K {ks}, its backward {bwd}")
        soak_bwd = bwd

        # (d) config/train_synth.yaml, cut, through the port's trainer
        with tempfile.TemporaryDirectory() as log_dir:
            bundle = init_training(copy.deepcopy(run_cfg), device=device)
            coverage_attention_step.launches = coverage_attention_step_backward.launches = 0
            t_run = time.perf_counter()
            metrics = train(run_cfg, log_dir, device=device, bundle=bundle)
            t_run = time.perf_counter() - t_run
            fwd, bwd = coverage_attention_step.launches, coverage_attention_step_backward.launches
            log("train_lstm", t0, f"(d) {os.path.relpath(LSTM_TRAIN_CONFIG, ROOT)} cut to "
                f"{ {k: run_cfg[k] for k in LSTM_TRAIN_CUTS} } ({run_cfg['dtype']}, batch "
                f"{run_cfg['batch_size']}, augment {run_cfg['augment']}, "
                f"{bundle.converter.num_classes} classes) in {t_run:.1f} s: greedy EM "
                f"{metrics['accuracy']:.4f}, loss {metrics['loss']:.4f}, "
                f"{metrics['n_samples']} samples; attention_step launches {fwd}, backward {bwd}")
            if cuda and (fwd <= 0 or bwd <= 0):
                raise AssertionError(f"(d) B2 launched {fwd} times, its backward {bwd}")
            # the run's first validation batch and crops, as build_loader makes them
            _, valid = build_loader(run_cfg, bundle.converter,
                                    seed=run_cfg.get("manualSeed", 1111))
            first = next(iter(valid))
            crops = [valid.dataset.image(i) for i in range(min(8, len(valid.dataset)))]
            rcfg = dict(copy.deepcopy(run_cfg), quantize=None, clahe=False)
            _checkpoint_checks(t0, "train_lstm", run_cfg, bundle, log_dir, rcfg, crops,
                               first.images, first.text, device, steps=("d", "d"))
        shapes, inputs = seen["b2_bwd"], seen["b2_bwd_inputs"]
    if not cuda:
        return None
    # (e) the backward kernel at every shape (a)-(d) launched, the reference widths, timed
    record = backward_phase(t0, shapes, inputs)
    record["launches"] = soak_bwd
    return record


def _check_validation_shapes(t0, shapes, nh, hd):
    """(c): B1 against its plain version at every (B, K, M, kind) the
    validation launched it with (``check_b1_shapes``); then timed at the
    largest self and cross shapes (CUDA graphs)."""
    check_b1_shapes(t0, "train", shapes, nh, hd)
    B, K, M, _ = max((s for s in shapes if s[3] == "self"), key=lambda s: (s[2], s[0]))
    S = max(s[2] for s in shapes if s[3] == "cross")
    for shape in ((B, K, M, True, M - 1), (B, K, S, False, None)):
        log("train", t0, f"(c) B1 at K = 1: {attention_timing(*shape, nh=nh, hd=hd)['text']}")


def backward_inputs(B, S, D, H, Kl, dtype, attn, seed, taps=5):
    """Inputs of B2's backward on the card in its argument order: the
    forward's (``coverage_step_inputs`` at K = 1: the coverage of 150 steps,
    or for ``loc_aware`` one alignment), alpha from the plain forward, and
    cotangents at a step's scales."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import coverage_attention_step_reference

    kw = coverage_step_inputs(B, 1, S, D, H, Kl, dtype,
                              COVERAGE_STEPS[-1] if attn == "coverage" else 1, seed, taps)
    _, alpha = coverage_attention_step_reference(**kw)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return [kw["enc"], kw["enc_proj"], kw["q"], kw["mem"], kw["loc_conv_w"],
            kw["loc_conv_b"], kw["w_loc"], kw["w_score"], kw["b_loc"], alpha,
            torch.randn(B, D, generator=g, device="cuda") * 0.1,
            torch.randn(B, S, generator=g, device="cuda") * 0.1]


def check_backward(args, where):
    """B2's backward on ``args`` against its plain version (``B2_BWD_TOL``)
    and against itself (two runs, equal bits); returns (the largest error,
    the largest error over its tolerance).  Not counted as launches."""
    import torch

    from doc2tex_tpu_torch.ops import attention_step as b2

    before = b2.coverage_attention_step_backward.launches
    got = b2.coverage_attention_step_backward(*args)
    again = b2.coverage_attention_step_backward(*args)
    ref = b2.coverage_attention_step_backward_reference(*args)
    torch.cuda.synchronize()
    b2.coverage_attention_step_backward.launches = before
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"B2's backward differs between two runs at {where}")
    worst = (0.0, 0.0)
    top = max(b.abs().max().item() for b in ref)
    for name, a, b in zip(B2_BWD_NAMES, got, ref):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"B2's backward: {name} {tuple(a.shape)} at {where}")
        err = (a - b).abs()
        tol = B2_BWD_TOL * (b.abs().max() + B2_BWD_FLOOR * top) + 1e-30
        if got[B2_BWD_NAMES.index(name)].dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * b.abs()
        if (err > tol).any():
            raise AssertionError(
                f"B2's backward disagrees with its plain version ({name}) at {where}: max abs "
                f"err {err.max().item():.3e}, largest {b.abs().max().item():.3e}; the outputs' "
                "largest: " + ", ".join(f"{n} {r.abs().max().item():.3e}"
                                        for n, r in zip(B2_BWD_NAMES, ref)))
        worst = (max(worst[0], err.max().item()), max(worst[1], (err / tol).max().item()))
    return worst


def _event_ms(fn, reps=20):
    """One call's time over ``reps`` calls between CUDA events (host gaps
    included), after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def backward_timing(B, S, D, H, Kl, dtype_name="bfloat16", attn="coverage"):
    """B2's backward timed (a call's share of a CUDA graph of 20) beside its
    plain version (the same), autograd of the plain forward (a yardstick:
    event time, host gaps included) and the bound: each input read once and
    each output written once at 3.35 TB/s, or the work after the fold at
    the float32 rate, per position: enc . g_context and alpha g_context
    over D (3 D), the pre-activation's 5 taps and adds, tanh, the tanh
    gradient, d q, d w_score, the 5 taps' M and R sums over H (40 H)."""
    import torch

    from doc2tex_tpu_torch.ops import attention_step as b2
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    dtype = getattr(torch, dtype_name)
    args = backward_inputs(B, S, D, H, Kl, dtype, attn, seed=11)
    before = b2.coverage_attention_step_backward.launches
    ms = graph_ms(lambda: b2.coverage_attention_step_backward(*args))
    got = b2.coverage_attention_step_backward(*args)
    b2.coverage_attention_step_backward.launches = before
    plain_ms = graph_ms(lambda: b2.coverage_attention_step_backward_reference(*args))
    ref = b2.coverage_attention_step_backward_reference(*args)
    enc, enc_proj, q, mem, cw, cb, w_loc, w_score, b_loc, _, g_ctx, g_alpha = args
    leaves = [t.detach().clone().requires_grad_()
              for t in (enc, enc_proj, q, mem, cw, cb, w_loc, b_loc, w_score)]
    out = b2.coverage_attention_step_reference(*leaves)
    autograd_ms = _event_ms(lambda: torch.autograd.grad(out, leaves, (g_ctx, g_alpha),
                                                        retain_graph=True))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
    nbytes = sum(t.numel() * t.element_size() for t in list(args) + list(got))
    flops = B * S * (3 * D + 40 * H)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    return dict(ms=ms, plain_ms=plain_ms, autograd_ms=autograd_ms, bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=err,
                text=f"backward, {B} samples S {S} D{D} H{H} Kl{Kl} {dtype_name} {attn}: kernel "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms, autograd of the plain forward "
                     f"{autograd_ms:.4f} ms (events), bound {bound:.4f} ms (bytes "
                     f"{bytes_ms:.4f} ms for {nbytes / 1e6:.2f} MB, operations {ops_ms:.4f} ms "
                     f"for {flops / 1e9:.4f} GFLOP f32), {bound / ms:.0%} of bound")


def backward_phase(t0, shapes, inputs):
    """(e): B2's backward against its plain version and itself at every
    (B, S, D, H, Kl, type) the phase launched it with, on the inputs of its
    first launch there (real coverages and cotangents), and at the reference
    widths (D = H = 256, Kl 128; S 623 and 2525) for coverage and
    loc_aware, float32 and bf16, and at S that tiles do not divide; then
    timed at the recipe's largest launch (the JSON record) and the
    reference widths.  Returns the kernel's record (launches filled later)."""
    import torch

    worst = {}
    for shape in sorted(shapes):
        err = check_backward(inputs[shape], f"launched shape {shape}")
        worst[shape[-1]] = tuple(map(max, worst.get(shape[-1], (0.0, 0.0)), err))
    log("train_lstm", t0, f"(e) B2's backward matches its plain version, and two runs are "
        f"equal bit for bit, at the {len(shapes)} (B, S, D, H, Kl, type) it was launched with, "
        f"on the inputs of a launch there with a cotangent that is not zero: {sorted(shapes)}; "
        "max abs err "
        + ", ".join(f"{k} {e:.3e} (at most {r:.2f} of its tolerance)" for k, (e, r) in worst.items())
        + f"; tol {B2_BWD_TOL:g} of each output's largest magnitude (+ {B2_BWD_FLOOR:g} of "
        "the call's largest output, + one bf16 ulp)")
    grid = [(B, S, D, H, Kl) for B, S, D, H, Kl in
            ((32, 623, 256, 256, 128), (8, 2525, 256, 256, 128), (3, 3, 128, 128, 64),
             (5, 61, 128, 128, 64), (2, 129, 256, 256, 8), (7, 1000, 128, 128, 64))]
    worst, n = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for attn in ("coverage", "loc_aware"):
            for B, S, D, H, Kl in grid:
                err = check_backward(backward_inputs(B, S, D, H, Kl, dtype, attn, seed=n),
                                     f"B {B} S {S} D{D} H{H} Kl{Kl} {name} {attn}")
                worst[name] = tuple(map(max, worst.get(name, (0.0, 0.0)), err))
                n += 1
    log("train_lstm", t0, f"(e) B2's backward matches its plain version, two runs equal bit "
        f"for bit, at {n} checks ((B, S, D, H, Kl) {grid} x coverage, loc_aware x float32, "
        "bfloat16): max abs err "
        + ", ".join(f"{k} {e:.3e} (at most {r:.2f} of its tolerance)" for k, (e, r) in worst.items()))
    bf16 = sorted(s for s in shapes if s[-1] == "bfloat16")
    main = max(bf16, key=lambda s: (s[0] * s[1], s)) if bf16 else (32, 623, 128, 128, 64, "bfloat16")
    rec = backward_timing(*main)
    log("train_lstm", t0, f"(e) B2's backward (the recipe's largest launch) {rec['text']}")
    for shape in (s for s in bf16 if s != main):
        log("train_lstm", t0, f"(e) B2's backward (launched) {backward_timing(*shape)['text']}")
    for B, S in ((32, 623), (8, 2525)):
        for attn in ("coverage", "loc_aware"):
            log("train_lstm", t0, "(e) B2's backward (reference widths) "
                + backward_timing(B, S, 256, 256, 128, attn=attn)["text"])
    return {
        "name": "attention_step_backward", "route": "cuda", "source": B2_BWD_SOURCE,
        "replaces": B2_BWD_REPLACES, "launches": 0, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
    }


def _flat(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    else:
        yield tree


def build_kernels(t0):
    """nvcc on every source at once (one process each)."""
    from concurrent.futures import ThreadPoolExecutor

    from doc2tex_tpu_torch.ops import attention_step, decode_attention

    builds = ((decode_attention.SOURCE, decode_attention.build),
              (attention_step.SOURCE, attention_step.build),
              (f"{attention_step.SOURCE} -D{attention_step.WIDE_DEFINE}",
               attention_step.build_wide),
              (attention_step.BACKWARD_SOURCE, attention_step.build_backward))
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        infos = list(pool.map(lambda b: (b[0], b[1]()), builds))
    for source, info in infos:
        log("build", t0, f"{source} built in {info['seconds']:.2f} s "
            f"({'compiled' if info['built'] else 'cached'}): {info['path']}")
        if info["ptxas"]:
            print(info["ptxas"], file=sys.stderr, flush=True)

# ---- the int8 decode memory (phase 8b) ---------------------------------------

def int8_attention_inputs(B, K, M, nh, hd, dtype, masked, seed, step=None):
    """``attention_inputs`` with K and V quantized per vector (quantize_kv,
    as the decoder stores them): (q in ``dtype``, k8, v8, k_scale,
    v_scale, mask)."""
    import torch

    from doc2tex_tpu_torch.ops.quant import quantize_kv

    q, k, v, mask = attention_inputs(B, K, M, nh, hd, torch.float32, "cuda", masked, seed, step)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    return q.to(dtype), k8, v8, ks, vs, mask


def check_attention_int8(B, K, M, nh, hd, dtype, masked, seed, step=None):
    """B1's int8 K/V form against its plain version at one shape; returns
    the max abs error."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_int8_reference)

    name = str(dtype).split(".")[-1]
    atol, rtol = INT8_TOL[name]
    q, k8, v8, ks, vs, mask = int8_attention_inputs(B, K, M, nh, hd, dtype, masked, seed, step)
    before = decode_attention.int8_launches
    out = decode_attention(q, k8, v8, mask, ks, vs)
    decode_attention.int8_launches = before
    ref = decode_attention_int8_reference(q, k8, v8, mask, ks, vs)
    torch.cuda.synchronize()
    if out.dtype != dtype or not torch.isfinite(out).all():
        raise AssertionError(f"int8 K/V form: {out.dtype} or non-finite output at B{B} K{K} "
                             f"M{M} {name}")
    err = (out.float() - ref.float()).abs()
    if (err > atol + rtol * ref.float().abs()).any():
        raise AssertionError(f"B1's int8 K/V form disagrees with its plain version at B{B} K{K} "
                             f"M{M} mask={masked} step={step} {name}: max abs err "
                             f"{err.max().item():.3e}")
    return err.max().item()


def int8_rounding_point_check() -> int:
    """B1's int8 K/V form equals its plain version bit for bit (bf16) where
    both rounding points of the scaled probabilities show: q = 0, so the n
    attended positions score alike and p = 1/n; V is v8 at position 0 with
    scale s, 0 elsewhere; every output is round(round(round(1/n) *
    round(s)) * v8).  Unsplit and over a cluster (every 500th position
    attended).  Returns the checks made."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_int8_reference)

    n_checks = 0
    before = decode_attention.int8_launches
    for n, v8, scale in ((3, 100, 0.0123), (7, 127, 0.0917), (3, 55, 0.0457)):
        for spread, B, K, nh in ((1, 1, 1, 1), (500, 1, 10, 8)):
            M = n * spread
            q = torch.zeros(B, K, nh, 32, dtype=torch.bfloat16, device="cuda")
            g = torch.Generator(device="cpu").manual_seed(n)
            k8 = torch.randint(-127, 128, (B, M, nh, 32), generator=g).to("cuda", torch.int8)
            v = torch.zeros(B, M, nh, 32, dtype=torch.int8, device="cuda")
            v[:, 0] = v8
            ks = torch.full((B, M, nh), 0.01, device="cuda")
            vs = torch.full((B, M, nh), scale, device="cuda")
            mask = None
            if spread > 1:
                mask = torch.zeros(B, K, M, dtype=torch.bool, device="cuda")
                mask[:, :, ::spread] = True
            out = decode_attention(q, k8, v, mask, ks, vs)
            ref = decode_attention_int8_reference(q, k8, v, mask, ks, vs)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"int8 rounding point: kernel {out.flatten()[0].item()!r} "
                                     f"!= plain {ref.flatten()[0].item()!r} at n {n}, v8 {v8}, "
                                     f"scale {scale}, spread {spread}")
            n_checks += 1
    decode_attention.int8_launches = before
    return n_checks


def attention_int8_timing(B, K, M, masked, step, nh=8, hd=32):
    """B1's int8 K/V form and its plain version timed at one shape with
    bf16 q (CUDA graphs, as ``attention_timing``), and the bound of the
    same work: q read and the output written once, the mask, and the int8
    K/V rows that a beam of the sample attends with their two f32 scales;
    Q.K and P.V over the attended positions at the bf16 tensor rate.  No
    single PyTorch call computes this function (library_ms None)."""
    import torch

    from doc2tex_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_int8_reference, launch_plan)
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    q, k8, v8, ks, vs, mask = int8_attention_inputs(B, K, M, nh, hd, torch.bfloat16, masked,
                                                    seed=7, step=step)
    before = decode_attention.int8_launches
    ms = graph_ms(lambda: decode_attention(q, k8, v8, mask, ks, vs))
    plain_ms = graph_ms(lambda: decode_attention_int8_reference(q, k8, v8, mask, ks, vs))
    err = (decode_attention(q, k8, v8, mask, ks, vs).float()
           - decode_attention_int8_reference(q, k8, v8, mask, ks, vs).float()).abs().max().item()
    decode_attention.int8_launches = before  # timing launches are not main-path launches
    kv_rows = B * M if mask is None else int(mask.any(dim=1).sum().item())
    nbytes = 2 * q.numel() * 2 + kv_rows * nh * (2 * hd + 2 * INT8_BYTES_PER_SCALE)
    nbytes += 0 if mask is None else mask.numel()
    attended = B * K * M if mask is None else int(mask.sum().item())
    flops = 4 * attended * nh * hd
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    plan = launch_plan(B, K, M, nh, hd, torch.bfloat16, torch.int8)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=err,
                text=f"int8 K/V, B{B} K{K} M{M} {'step ' + str(step) if masked else 'no mask'} "
                     f"nh{nh} hd{hd} bf16 q (cluster {plan.cluster}, chunk {plan.chunk}, "
                     f"{plan.smem_bytes} B smem): max abs err {err:.3e}, kernel {ms:.4f} ms, "
                     f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB), "
                     f"{bound / ms:.0%} of bound, achieved "
                     f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")


def coverage_int8_inputs(Bs, K, S, D, H, Kl, compute, t, seed, taps=5):
    """``coverage_step_inputs`` with enc and enc_proj rounded to the
    compute type and quantized per sample (quantize_memory, as the decoder
    stores them): (the step's inputs, the int8 keywords)."""
    import torch

    from doc2tex_tpu_torch.ops.quant import quantize_memory

    kw = coverage_step_inputs(Bs, K, S, D, H, Kl, torch.float32, t, seed, taps)
    kw["enc"], enc_scale = quantize_memory(kw["enc"].to(compute))
    kw["enc_proj"], proj_scale = quantize_memory(kw["enc_proj"].to(compute))
    return kw, dict(enc_scale=enc_scale, proj_scale=proj_scale, compute_dtype=compute)


def check_coverage_int8_shapes(shapes):
    """B2's int8 form against its plain version at each (samples, K, S, D,
    H, Kl) of ``shapes``, float32 and bfloat16 compute, coverage of the
    steps COVERAGE_STEPS, valid_len None and S - 17 (B2_TOL).  Returns
    (checks made, the worst errors as text)."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        coverage_attention_step, coverage_attention_step_int8_reference)

    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    n = 0
    before = coverage_attention_step.int8_launches
    for compute in (torch.float32, torch.bfloat16):
        name = str(compute).split(".")[-1]
        for Bs, K, S, D, H, Kl in shapes:
            for t in COVERAGE_STEPS:
                kw, q8 = coverage_int8_inputs(Bs, K, S, D, H, Kl, compute, t, seed=n)
                for valid in (None, S - 17):
                    n += 1
                    got = coverage_attention_step(**kw, valid_len=valid, **q8)
                    ref = coverage_attention_step_int8_reference(
                        *kw.values(), valid, q8["enc_scale"], q8["proj_scale"], compute)
                    torch.cuda.synchronize()
                    worst[name] = tuple(map(max, worst[name], _check_b2(
                        "attention step (int8 form)", got, ref,
                        f"{Bs} samples K {K} S {S} D{D} H{H} Kl{Kl} step {t} valid {valid} "
                        f"int8 memory, {name} compute")))
    coverage_attention_step.int8_launches = before
    return n, ("max abs err " + ", ".join(
        f"{k} {e:.3e} (at most {r:.2f} of its tolerance)" for k, (e, r) in worst.items())
        + f"; tol {B2_TOL[0]:g} abs + {B2_TOL[1]:g} rel")


def coverage_int8_timing(Bs, K, S, D, H, Kl):
    """B2's int8 form (bf16 compute) and its plain version timed at one
    shape (CUDA graphs), and the bound of the fused function: the int8
    memory and its scales read once per sample, the coverage, q and the
    weights read and the outputs written once; the float32 work of
    ``coverage_step_timing``.  No single PyTorch call computes it."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        COVERAGE, coverage_attention_step, coverage_attention_step_int8_reference, launch_plan)
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    kw, q8 = coverage_int8_inputs(Bs, K, S, D, H, Kl, torch.bfloat16, COVERAGE_STEPS[-1], seed=7)
    ref_args = (*kw.values(), None, q8["enc_scale"], q8["proj_scale"], torch.bfloat16)
    before = coverage_attention_step.int8_launches
    ms = graph_ms(lambda: coverage_attention_step(**kw, **q8))
    plain_ms = graph_ms(lambda: coverage_attention_step_int8_reference(*ref_args))
    got = coverage_attention_step(**kw, **q8)
    ref = coverage_attention_step_int8_reference(*ref_args)
    coverage_attention_step.int8_launches = before
    taps = kw["loc_conv_w"].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in kw.values())
    nbytes += 2 * Bs * INT8_BYTES_PER_SCALE + (got[0].numel() + got[1].numel()) * 4
    flops = Bs * K * S * (2 * taps * H + 5 * H + 3 + 2 * D)
    plan = launch_plan(Bs, K, S, D, H, Kl, torch.int8, COVERAGE, taps)
    result = _b2_result(ms, plain_ms, got, ref, nbytes, flops,
                        f"int8 form, {Bs} samples x K {K} S {S} D{D} H{H} Kl{Kl} int8 memory, "
                        f"bf16 compute (cluster {plan.cluster}, chunk {plan.chunk}, zsplit "
                        f"{plan.zsplit}, {plan.smem_bytes} B smem)")
    return dict(result, library_ms=None)


def int8_memory_phase(t0):
    """Phase 8b: the modes that keep decode memory in int8.  The golden
    crops of ``synthetic_tfm_big`` and ``synthetic`` with ``quantize:
    int8_full``, and of ``synthetic_tfm_big`` with the parts encoder,
    decoder_mem and decoder_kv, float32 (gated by ``check_int8_strings``
    against the JAX golden of the same parts) and bf16, every launch that
    reads int8 memory through an int8 form; then B1's int8 K/V form and
    B2's int8 form against their plain versions at every shape those runs
    launched them with, at the release shapes and longer, and timed.
    Returns the two forms' JSON records, their launches those of the
    float32 int8_full runs (16 crops)."""
    import torch

    with recorded_launches() as seen:
        slice_phase(t0, "synthetic_tfm_big", "decode_attention", quantize="int8_full")
        slice_phase(t0, "synthetic_tfm_big", "decode_attention", quantize="int8_kv")
        slice_phase(t0, "synthetic", "attention_step", quantize="int8_full")
    b1_launches = SLICE_COUNTS["synthetic_tfm_big", "int8_full"]["decode_attention_int8"]
    b2_launches = SLICE_COUNTS["synthetic", "int8_full"]["attention_step_int8"]
    log("int8_memory", t0, "launches of a 16-crop float32 call by form: int8_full "
        f"synthetic_tfm_big {SLICE_COUNTS['synthetic_tfm_big', 'int8_full']}, int8_kv "
        f"synthetic_tfm_big {SLICE_COUNTS['synthetic_tfm_big', 'int8_kv']}, int8_full synthetic "
        f"{SLICE_COUNTS['synthetic', 'int8_full']}")

    nh, hd = 8, 32
    b1_shapes = sorted(seen["b1_int8"])
    grid = [(B, K, M, kind == "self", M // K - 1 if kind == "self" else None)
            for B, K, M, kind in b1_shapes]
    grid += [(64, 10, 10 * t, True, t - 1) for t in (31, 62, 93, 124, 151)]
    grid += [(64, 10, 623, False, None), (64, 10, 5010, True, 500), (1, 10, 5010, True, 500),
             (8, 10, 623, False, None)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        worst[name] = max(check_attention_int8(B, K, M, nh, hd, dtype, masked,
                                               seed=B * 1000 + M, step=step)
                          for B, K, M, masked, step in grid)
    log("int8_memory", t0, f"B1's int8 K/V form matches its plain version at {len(grid)} shapes "
        f"per q type (the {len(b1_shapes)} (B, K, M, kind) the int8 runs launched: "
        f"{b1_shapes}; self M 310..1510 and cross 623 at B 64, self M 5010 at B 1 and 64, "
        "cross 623 at B 8): max abs err "
        + ", ".join(f"{n} {e:.3e} (tol {INT8_TOL[n][0]:g} abs + {INT8_TOL[n][1]:g} rel)"
                    for n, e in worst.items()))
    log("int8_memory", t0, f"B1's int8 K/V form equals its plain version bit for bit on "
        f"{int8_rounding_point_check()} rounding-point inputs (bf16; unsplit and over a cluster)")
    timings = {}
    for label, shape in (("self", (64, 10, 1510, True, 150)), ("cross", (64, 10, 623, False, None)),
                         ("long self", (64, 10, 5010, True, 500))):
        timings[label] = attention_int8_timing(*shape)
        log("int8_memory", t0, f"B1 {label} {timings[label]['text']} (bf16 form "
            f"{attention_timing(*shape)['ms']:.4f} ms in this run)")

    b2_shapes = sorted(seen["b2_int8"])
    cgrid = b2_shapes + [s for s in ((64, 10, 623, 128, 128, 64), (8, 10, 623, 256, 256, 128),
                                     (8, 10, 2525, 256, 256, 128)) if s not in b2_shapes]
    n, text = check_coverage_int8_shapes(cgrid)
    log("int8_memory", t0, f"B2's int8 form matches its plain version at {n} checks ((samples, "
        f"K, S, D, H, Kl) {cgrid}, the first {len(b2_shapes)} launched by the int8 run; x "
        "float32, bf16 compute x coverage of step {1,150} x valid {None, S-17}): " + text)
    b2 = {}
    for shape in cgrid:
        b2[shape] = coverage_int8_timing(*shape)
        log("int8_memory", t0, f"B2 {b2[shape]['text']} (bf16 memory form "
            f"{coverage_step_timing(*shape)['ms']:.4f} ms in this run)")
    rel1 = timings["self"]
    rel2 = b2[max(b2_shapes)] if b2_shapes else b2[64, 10, 623, 128, 128, 64]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [
        {"name": "decode_attention_int8", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": B1_INT8_REPLACES, "launches": b1_launches, **{k: rel1[k] for k in keys}},
        {"name": "attention_step_int8", "route": "cuda", "source": B2_SOURCE,
         "replaces": B2_INT8_REPLACES, "launches": b2_launches, **{k: rel2[k] for k in keys}},
    ]


def detect_quant_phase(t0):
    """Phase 11b: ``MathDetector`` with ``quantize`` bf16 and int8 on the
    golden pages (host windows, 5 a batch, as the JAX goldens ran) against
    the JAX package's boxes in the same mode (DETECT_QUANT_TOL); then
    through ``App(detect_quantize=...)`` on the default device-window path
    (one batch of a page's 35 windows), and detect_page timed beside the
    float32 detector's."""
    import torch

    from doc2tex_tpu_torch.app import App
    from doc2tex_tpu_torch.detection.flow import SHIPPED_WEIGHTS, MathDetector

    _, pages = golden_pages()
    for mode, path in DETECT_QUANT_GOLDEN.items():
        with open(path) as f:
            golden = json.load(f)
        tol = DETECT_QUANT_TOL[mode]
        det = MathDetector(SHIPPED_WEIGHTS, conf_thresh=golden["conf_thresh"],
                           iou_thresh=golden["nms_iou"], expand_frac=golden["expand_frac"],
                           quantize=mode, device_windows=False,
                           batch_size=golden["window_batch"])
        results = [det.detect_page(page) for page in pages]
        n_pairs, worst_px, worst_score, unmatched = check_detections(
            golden, results, golden["conf_thresh"], tol)
        log("detect_quant", t0, f"{mode} ({len(det.int8_layers)} int8 layers): {n_pairs} boxes "
            f"matched to the JAX package's {mode} boxes within {worst_px:.4f} px (tol "
            f"{tol['box_px']}) and scores within {worst_score:.2e} (tol {tol['score']}); "
            f"unmatched {unmatched} (at most {tol['unmatched']}, each within {tol['near']} of "
            "the threshold)")
        with torch.inference_mode():  # the mode is in effect: bf16 heads, or int8 layers
            loc = det.model(torch.zeros(1, 3, 512, 512, device="cuda"))[0]
        if (loc.dtype == torch.bfloat16) != (mode == "bf16") or (mode == "int8") != bool(
                det.int8_layers):
            raise AssertionError(f"MathDetector(quantize={mode!r}) computed loc in {loc.dtype} "
                                 f"with {len(det.int8_layers)} int8 layers")
        app = App(detect_quantize=mode, recognizer=lambda crops: ["x"] * len(crops))
        regions = app(pages[0])
        if not regions or app.detector.quantize != mode:
            raise AssertionError(f"App(detect_quantize={mode!r}) gave {regions}")
        ms = {q: _event_ms(lambda d=MathDetector(SHIPPED_WEIGHTS, quantize=q): d.detect_page(
            pages[0]), reps=5) for q in (None, mode)}
        log("detect_quant", t0, f"App(detect_quantize={mode!r}) on page 0: {len(regions)} "
            f"regions; detect_page (35 windows, one batch) {ms[mode]:.2f} ms against float32's "
            f"{ms[None]:.2f} ms (a call's mean over 5 between CUDA events, after 3 warm-ups)")


def _decode_times(reader, n_plain=16) -> str:
    """The share of each PNG row filter in a store's images, and
    ``decode_png``'s host time a sample through the native row unfilter
    and, on the first ``n_plain`` images, through the plain Python one."""
    import struct
    import zlib
    from collections import Counter

    from doc2tex_tpu_torch.data.lmdb_reader import KEY_IMAGE
    from doc2tex_tpu_torch.utils import png

    raws = [reader.txn.get((KEY_IMAGE % (i + 1)).encode()) for i in range(len(reader))]
    kinds = Counter()
    for raw in raws:
        chunks = dict(png._chunks(raw))   # one IDAT chunk: encode_png writes one
        w, h, _, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
        rows = zlib.decompress(chunks[b"IDAT"])
        stride = w * png._CHANNELS[color]
        kinds.update(rows[y * (stride + 1)] for y in range(h))
    names = ("none", "Sub", "Up", "Average", "Paeth")
    share = ", ".join(f"{names[k]} {100 * v / sum(kinds.values()):.1f} %"
                      for k, v in sorted(kinds.items()))
    times = {}
    for kind, unfilter, some in (("native", png._unfilter, raws),
                                 ("plain", png._unfilter_py, raws[:n_plain])):
        saved, png._unfilter = png._unfilter, unfilter
        try:
            t = time.perf_counter()
            for raw in some:
                png.decode_png(raw, rgb=reader.rgb)
            times[kind] = (time.perf_counter() - t) / len(some) * 1e3
        finally:
            png._unfilter = saved
    return (f"the stored rows' filters: {share}; decode_png {times['native']:.4f} ms a sample "
            f"through the native unfilter ({len(raws)} samples), {times['plain']:.4f} ms through "
            f"the plain Python one (first {min(n_plain, len(raws))})")


def realdata_phase(t0, device="cuda", n=REALDATA_N, valid_n=REALDATA_VALID_N,
                   steps=REALDATA_STEPS, config=REALDATA_CONFIG, infer_config=INFER_CONFIG):
    """The data chain (phase 19): (a) ``tools.realdata``'s package fallback
    and lmdb stages on the host, every stored image decoding to its source
    array; (b) ``config`` trained through ``api.train`` from those stores;
    (c) ``api.infer`` over an LMDB ``eval_data`` of the long golden crops.
    The defaults are the card's; tiny ones (and ``infer_config`` None,
    which leaves (c) out) rehearse (a) and (b) on the CPU
    (``tests/test_torch_port_lmdb.py``)."""
    import copy
    import csv
    import tempfile

    import numpy as np
    import torch

    from doc2tex_tpu_torch.api import infer
    from doc2tex_tpu_torch.config import load_config
    from doc2tex_tpu_torch.data.lmdb_reader import LmdbReader, write_lmdb
    from doc2tex_tpu_torch.data.loader import build_loader
    from doc2tex_tpu_torch.data.synthetic import HARD_VOCAB_PATH, synth_hard_dataset
    from doc2tex_tpu_torch.eval import metrics
    from doc2tex_tpu_torch.ops.attention_step import (coverage_attention_step,
                                                      coverage_attention_step_backward)
    from doc2tex_tpu_torch.ops.decode_attention import decode_attention
    from doc2tex_tpu_torch.tokenizer.converters import create_converter
    from doc2tex_tpu_torch.tools import realdata

    cuda = device != "cpu"
    card = nvidia_smi() if cuda else "cpu"
    with tempfile.TemporaryDirectory() as work:
        # (a) the chain on the host
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            realdata.stage_package_fallback(work, n)
            t_pack = time.perf_counter() - t
            store = realdata.stage_lmdb(work, valid_n)
        t_lmdb = time.perf_counter() - t - t_pack
        t = time.perf_counter()
        reader = LmdbReader(store)
        stored = [reader.image(i + 1) for i in range(len(reader))]
        t_read = time.perf_counter() - t
        images, labels = synth_hard_dataset(n, seed=realdata.FALLBACK_SEED)
        same = sum(a.shape == b.shape and bool((a == b).all()) for a, b in zip(stored, images))
        decode = _decode_times(reader)
        log("realdata", t0, f"(a) tools.realdata package --synthetic_fallback --n {n} (seed "
            f"{realdata.FALLBACK_SEED}) {t_pack:.2f} s, lmdb --valid_n {valid_n} {t_lmdb:.2f} s "
            f"({os.path.getsize(os.path.join(store, 'data.mdb')) / 2 ** 20:.2f} MiB); the store "
            f"read back in {t_read:.2f} s: {same}/{n} images equal to their source arrays, "
            f"labels {'equal' if [reader.label(i + 1) for i in range(n)] == labels else 'DIFFER'}; "
            f"{decode}; host of {card}")
        if same != n or len(reader) != n or [reader.label(i + 1) for i in range(n)] != labels:
            raise AssertionError("(a) the store does not hold the generator's images and labels")

        # (b) config/train.yaml through api.train from the stores
        cfg_path = realdata.train_config(work, steps, HARD_VOCAB_PATH, config, val_interval=steps)
        cfg = load_config(cfg_path)
        seq, head = cfg["SequenceModeling"]["params"], cfg["Prediction"]["params"]
        first = next(iter(build_loader(copy.deepcopy(cfg), create_converter(copy.deepcopy(cfg)),
                                       seed=cfg["manualSeed"])[0]))
        log("realdata", t0, f"(b) {os.path.relpath(config, ROOT)} with train_data/valid_data the "
            f"stores, the hard vocabulary, num_iter {steps}: {seq['backbone']['name']} "
            f"{seq['backbone']['output_channel']} + ViT {seq['hidden_size']}x{seq['depth']}, "
            f"{cfg['Prediction']['name']} {head['attn_type']} hidden {head['hidden_size']} "
            f"kernel_dim {head['kernel_dim']}, batch {cfg['batch_size']}, max_dimension "
            f"{cfg['max_dimension']}, augment {cfg['augment']}, {cfg['dtype']}; the store's first "
            f"train batch: {first.images.shape[0]} at {first.bucket}")
        with recorded_launches() as seen:
            _train_step_parity(t0, cfg, None, first.images, first.text, device, phase="realdata",
                               spread=True)
            _bf16_steps(t0, "realdata", cfg, first.images.shape[0], first.bucket, device,
                        batch=(first.images, first.text))
            seen["b2"].clear()
            seen["b2_bwd"].clear()
            seen["b2_bwd_inputs"].clear()
            coverage_attention_step.launches = coverage_attention_step_backward.launches = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                realdata.stage_train(work, steps, HARD_VOCAB_PATH, config, device,
                                     val_interval=steps, in_process=True)
            t_run = time.perf_counter() - t
            fwd, bwd = coverage_attention_step.launches, coverage_attention_step_backward.launches
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
            with open(os.path.join(work, "run", "summary.csv"), newline="") as f:
                val = list(csv.DictReader(f))
            fwd_shapes, bwd_shapes = sorted(seen["b2"]), sorted(seen["b2_bwd"])
            bwd_inputs = dict(seen["b2_bwd_inputs"])
        log("realdata", t0, f"(b) python -m doc2tex_tpu_torch.api.train: {steps} steps and "
            f"{len(val)} validation over {valid_n} samples in {t_run:.1f} s with set-up "
            f"({steps / t_run:.3f} steps/s); validation EM {float(val[-1]['accuracy']):.4f}, loss "
            f"{float(val[-1]['loss']):.4f}; peak memory allocated {peak:.2f} GiB; "
            f"attention_step launches {fwd}, backward {bwd}; {card}")
        if len(val) != 1 or not np.isfinite(float(val[-1]["loss"])):
            raise AssertionError(f"(b) the run's validations: {val}")
        if cuda:
            if fwd <= 0 or bwd <= 0:
                raise AssertionError(f"(b) B2 launched {fwd} times, its backward {bwd}")
            checks, text = check_coverage_shapes(fwd_shapes)
            log("realdata", t0, f"(b) B2 matches its plain version at the {len(fwd_shapes)} "
                f"(samples, K, S, D, H, Kl) the run launched, {checks} checks: {fwd_shapes}; {text}")
            worst = {}
            for shape in bwd_shapes:
                err = check_backward(bwd_inputs[shape], f"launched shape {shape}")
                worst[shape[-1]] = tuple(map(max, worst.get(shape[-1], (0.0, 0.0)), err))
            log("realdata", t0, f"(b) B2's backward matches its plain version, two runs equal "
                f"bit for bit, at the {len(bwd_shapes)} (B, S, D, H, Kl, type) launched: "
                f"{bwd_shapes}; max abs err " + ", ".join(
                    f"{k} {e:.3e} (at most {r:.2f} of its tolerance)" for k, (e, r) in worst.items()))

    # (c) api.infer over an LMDB eval_data of the long golden crops
    if infer_config is None:
        return
    with open(GOLDEN_INFER) as f:
        want = {r["name"]: r["pred"] for r in json.load(f)["rows"]}
    golden, crops = golden_crops("synthetic_long")
    names = [f"long_{c['seed']:05d}.png" for c in golden["crops"]]
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(ROOT):
        write_lmdb(os.path.join(tmp, "eval"), crops, [c["label"] for c in golden["crops"]], names)
        with open(infer_config) as f:
            text = realdata.override_yaml(f.read(), {"eval_data": os.path.join(tmp, "eval")})
        cfg_path = os.path.join(tmp, "infer.yaml")
        with open(cfg_path, "w") as f:
            f.write(text)
        out_dir = os.path.join(tmp, "out")
        decode_attention.launches = 0
        t = time.perf_counter()
        infer.main(["--config", cfg_path, "--log_path", out_dir, "--device", device])
        seconds = time.perf_counter() - t
        launches = decode_attention.launches
        with open(os.path.join(out_dir, "predictions.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
    got = {r["name"]: r["pred"] for r in rows}
    match = sum(got.get(name) == pred for name, pred in want.items())
    preds, gts = [r["pred"] for r in rows], [r["label"] for r in rows]
    scored = {}
    for kind, lev in (("native", metrics.levenshtein), ("plain", metrics._lev_py)):
        saved, metrics.levenshtein = metrics.levenshtein, lev
        try:
            t = time.perf_counter()
            value = (sum(metrics.get_single_ED(g, p) for g, p in zip(gts, preds)),
                     metrics.get_word_NED(preds, gts))
            scored[kind] = (time.perf_counter() - t, value)
        finally:
            metrics.levenshtein = saved
    log("realdata", t0, f"(c) api.infer with eval_data an LMDB store of the {len(crops)} long "
        f"golden crops ({os.path.relpath(infer_config, ROOT)}): {match}/{len(want)} predictions "
        f"equal to the JAX CLI's over the PNG manifest; {seconds:.1f} s with set-up, "
        f"decode_attention launches {launches}; score_s (char and word match of the "
        f"{len(rows)} predictions) native {scored['native'][0]:.4f} s, plain "
        f"{scored['plain'][0]:.4f} s, equal {scored['native'][1] == scored['plain'][1]}; {card}")
    if cuda and launches <= 0:
        raise AssertionError("(c) api.infer launched decode_attention 0 times")
    if match < MIN_INFER_MATCH or scored["native"][1] != scored["plain"][1]:
        raise AssertionError(f"(c) {match}/{len(want)} predictions equal the JAX CLI's "
                             f"(need {MIN_INFER_MATCH}), or the scorers disagree: {scored}")


# ---- the rest of the model zoo (phase 20) --------------------------------------

def content_step_timing(Bs, K, S, D, H):
    """B2's content form (no location term) and its plain version timed at
    one shape with bf16 memory, as ``coverage_step_timing``, and the bound
    of the fused function: the memory read once per sample, q and w_score
    read and the outputs written once; per position the add, tanh and
    w_score over H, the softmax, and alpha.enc over D.  Beside it, the
    coverage form with a zero location conv (1 tap, Kl 4, the least
    location work it takes), which computes the same function: what the
    content form's own instances save."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        CONTENT, content_attention_step, content_attention_step_reference,
        coverage_attention_step, launch_plan)
    from doc2tex_tpu_torch.tools.bench_decode_attention import graph_ms

    full = coverage_step_inputs(Bs, K, S, D, H, 4, torch.bfloat16, 1, seed=7, taps=1)
    kw = {k: full[k] for k in ("enc", "enc_proj", "q", "w_score")}
    zero = dict(full, **{k: torch.zeros_like(full[k])
                         for k in ("loc_conv_w", "loc_conv_b", "w_loc", "b_loc")})
    before = content_attention_step.launches, coverage_attention_step.launches
    ms = graph_ms(lambda: content_attention_step(**kw))
    zero_ms = graph_ms(lambda: coverage_attention_step(**zero))
    plain_ms = graph_ms(lambda: content_attention_step_reference(**kw))
    got, ref = content_attention_step(**kw), content_attention_step_reference(**kw)
    same = coverage_attention_step(**zero)
    zero_diff = max((a - b).abs().max().item() for a, b in zip(same, got))
    # timing launches are not main-path launches
    content_attention_step.launches, coverage_attention_step.launches = before
    nbytes = sum(t.numel() * t.element_size() for t in kw.values())
    nbytes += (got[0].numel() + got[1].numel()) * 4
    flops = Bs * K * S * (5 * H + 3 + 2 * D)
    plan = launch_plan(Bs, K, S, D, H, 0, torch.bfloat16, CONTENT)
    out = _b2_result(ms, plain_ms, got, ref, nbytes, flops,
                     f"content form, {Bs} samples x K {K} S {S} D{D} H{H} bf16 "
                     f"(cluster {plan.cluster}, chunk {plan.chunk}, zsplit {plan.zsplit}, "
                     f"{plan.smem_bytes} B smem)")
    out["text"] += (f"; the coverage form with a zero location conv {zero_ms:.4f} ms "
                    f"(outputs {zero_diff:.1e} from the content form's)")
    return out


def check_content_shapes(shapes):
    """B2's content form against its plain version at each (samples, K, S,
    D, H) of ``shapes``, float32 and bfloat16 memory, valid_len None and S
    - 17.  Returns (checks made, the worst errors as text)."""
    import torch

    from doc2tex_tpu_torch.ops.attention_step import (
        content_attention_step, content_attention_step_reference)

    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for Bs, K, S, D, H in shapes:
            full = coverage_step_inputs(Bs, K, S, D, H, 64, dtype, 1, seed=n)
            kw = {k: full[k] for k in ("enc", "enc_proj", "q", "w_score")}
            for valid in (None, S - 17):
                n += 1
                got = content_attention_step(**kw, valid_len=valid)
                ref = content_attention_step_reference(**kw, valid_len=valid)
                torch.cuda.synchronize()
                worst[name] = tuple(map(max, worst[name], _check_b2(
                    "attention step (content form)", got, ref,
                    f"{Bs} samples K {K} S {S} D{D} H{H} valid {valid} {name}")))
    return n, ("max abs err " + ", ".join(
        f"{k} {e:.3e} (at most {r:.2f} of its tolerance)" for k, (e, r) in worst.items())
        + f"; tol {B2_TOL[0]:g} abs + {B2_TOL[1]:g} rel")


def zoo_variables(model, seed: int = 0) -> dict:
    """Flax variables for ``model`` with every leaf drawn from numpy's
    generator of ``seed`` (``weights.random_variables`` over
    ``to_variables``' tree).  numpy gives the same draws with every torch;
    torch's seeded init does not (torch 2.11 and 2.13 draw other weights
    from one seed), and a golden written with one torch would not hold a
    model another torch built."""
    import numpy as np

    from doc2tex_tpu_torch.weights import random_variables, to_variables

    return random_variables(to_variables(model), np.random.default_rng(seed))


def zoo_recognizer(config, device, seed: int = 0):
    """MathRecognition of a zoo block (no weights) with ``zoo_variables``."""
    from doc2tex_tpu_torch.recognition import MathRecognition
    from doc2tex_tpu_torch.weights import load_variables

    rec = MathRecognition(config, None, beam_size=10, device=device)
    load_variables(rec.model, zoo_variables(rec.model, seed))
    rec.model.to(device)
    return rec


def zoo_logit_inputs(rec, crop, steps=ZOO_LOGIT_STEPS):
    """The image batch of ``crop`` as ``rec`` decodes it (preprocessed,
    bucketed, normalized: float32 (1, H, W, 1)) and ``steps`` tokens drawn
    from numpy's seed 0 ((1, steps) int64), as numpy arrays."""
    import numpy as np
    import torch

    from doc2tex_tpu_torch.transforms.augment import normalize

    prepped = [rec._preprocess(crop)]
    (bucket, _), = rec.group(prepped).items()
    batch = torch.from_numpy(rec.make_batch(prepped, bucket))
    x = normalize(batch, mean=rec.config.get("mean", 0.5), std=rec.config.get("std", 0.5))
    text = np.random.default_rng(0).integers(1, rec.converter.num_classes, (1, steps))
    return x.float().numpy(), text.astype(np.int64)


def zoo_logits(rec, crop, steps=ZOO_LOGIT_STEPS):
    """Teacher-forced float32 logits (steps, classes) of ``rec``'s model on
    its device for ``zoo_logit_inputs``."""
    import torch

    x, text = zoo_logit_inputs(rec, crop, steps)
    device = next(rec.model.parameters()).device
    with torch.no_grad():
        logits = rec.model(torch.from_numpy(x).to(device), torch.from_numpy(text).to(device))
    return logits[0].float().cpu().numpy()


def logit_check(got, ref, rel=ZOO_LOGIT_TOL):
    """(max abs error, the tolerance ``rel`` of the largest |ref|, the
    logits' std over the classes, the median top-1/top-2 gap) as floats."""
    import numpy as np

    top2 = np.sort(ref, axis=-1)[:, -2:]
    return (float(np.abs(got - ref).max()), rel * float(np.abs(ref).max()),
            float(ref.std(axis=-1).mean()), float(np.median(top2[:, 1] - top2[:, 0])))


def zoo_golden(path=GOLDEN_ZOO) -> dict:
    with open(path) as f:
        return json.load(f)


def cut_config(cfg) -> dict:
    """A block's config as the phases' card-against-CPU and golden checks
    decode it: float32, ``batch_max_length`` VERSION_CUT_STEPS."""
    import copy

    return dict(copy.deepcopy(cfg), batch_max_length=VERSION_CUT_STEPS, dtype="float32")


def card_equals_cpu(phase, t0, make, crop, device):
    """One crop decoded by ``make(device)``'s recognizer on the card and on
    the CPU: equal tokens."""
    import torch

    tokens = {}
    for dev in dict.fromkeys((device, "cpu")):
        r = make(dev)
        prepped = [r._preprocess(crop)]
        (bucket, _), = r.group(prepped).items()
        tokens[dev] = r._decode(r.make_batch(prepped, bucket))[0].cpu()
    if not torch.equal(tokens[device], tokens["cpu"]):
        raise AssertionError(f"{phase}: the card's tokens differ from the CPU's at "
                             f"{VERSION_CUT_STEPS} steps")
    log(phase, t0, f"float32, {VERSION_CUT_STEPS} steps, crop {crop.shape} in bucket {bucket}: "
        f"the card's beam-10 tokens equal the CPU's ({tuple(tokens['cpu'].shape)})")


def zoo_block(t0, block, crops, want, device="cuda"):
    """One zoo block (see the module docstring, phase 20): (a) float32 at
    the cut against ``want`` (the block's golden: the JAX package's strings
    under ``"jax"``, its teacher-forced logits of the first crop under
    ``"jax_logits"``) and card == CPU on one crop; (b) the block's own type
    at its full length, a warm-up call,
    then the counted and timed call; its launched shapes checked and timed.
    Returns the timings of the largest launches by record name, and the
    head kernel's launches under ``"launches"``."""
    import copy

    import numpy as np
    import torch

    from doc2tex_tpu_torch.recognition import load_recog_config

    cfg, weights = load_recog_config(ZOO_CONFIG, version=block)
    if weights is not None:
        raise AssertionError(f"{block} names weights {weights}; the phase expects none")
    cuda = device != "cpu"
    cut = cut_config(cfg)
    rec = zoo_recognizer(copy.deepcopy(cut), device)
    out = rec(crops)
    same = sum(a == b for a, b in zip(out, want["jax"]))
    log(block, t0, f"float32, {VERSION_CUT_STEPS} steps, beam 10, numpy draws (seed 0): "
        f"{same}/{len(crops)} strings equal the JAX package's ({len(set(out))} distinct)")
    if same < min(MIN_ZOO_MATCH, len(crops)):
        raise AssertionError(f"{block}: {same}/{len(crops)} float32 strings equal JAX's "
                             f"(need {MIN_ZOO_MATCH})")
    err, tol, spread, gap = logit_check(zoo_logits(rec, crops[0]), np.asarray(
        want["jax_logits"], dtype=np.float32))
    log(block, t0, f"float32 teacher-forced logits of crop 0 ({ZOO_LOGIT_STEPS} tokens x "
        f"{rec.converter.num_classes} classes): max abs err against JAX's {err:.3e}, tol "
        f"{tol:.3e} ({ZOO_LOGIT_TOL:g} of the largest |logit|); JAX's logits' std over the "
        f"classes {spread:.3e}, median top-1/top-2 gap {gap:.3e}")
    if not err <= tol:
        raise AssertionError(f"{block}: logits {err:.3e} from JAX's (tol {tol:.3e})")
    card_equals_cpu(block, t0, lambda dev: zoo_recognizer(copy.deepcopy(cut), dev),
                     crops[0], device)

    rec = zoo_recognizer(copy.deepcopy(cfg), device)
    head = rec.model.predicter
    attn = getattr(head, "attn_type", None)
    rec(crops)   # warm-up: cuDNN's algorithm choice for each bucket's shapes
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with recorded_launches() as seen:
        reset_launches()
        t = time.perf_counter()
        out = rec(crops)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    err, tol, _, _ = logit_check(zoo_logits(rec, crops[0]), np.asarray(
        want["jax_logits"], dtype=np.float32), ZOO_BF16_LOGIT_TOL)
    kernel = ("decode_attention" if rec.model.head == "TFM" else
              "attention_step_content" if attn == "bahdanau" else
              None if attn == "luong" else "attention_step")
    launched = {k: v for k, v in counts.items() if v}
    if not all(isinstance(x, str) for x in out) or (cuda and kernel and not launched.get(kernel)):
        raise AssertionError(f"{block}: launches {counts}, {out!r:.200}")
    if kernel is None and launched:
        raise AssertionError(f"{block}: the luong head launched {launched}")
    no_kernel = ("none: the luong head's scores are plain PyTorch, as the JAX package "
                 "computes them in XLA")
    log(block, t0, f"{cfg['dtype']}, {cfg['batch_max_length']} steps, beam 10: "
        f"{len(crops)} crops decoded in {seconds:.3f} s, peak memory {peak:.2f} GiB, "
        f"launches {launched or no_kernel}; "
        f"B1 {sorted(seen['b1'])} {sorted(seen['b1_types'])}, B2 coverage "
        f"{sorted(seen['b2'])}, B2 content {sorted(seen['b2_content'])}; strings "
        f"{[len(x.split()) for x in out]} tokens long; its teacher-forced logits of crop 0 "
        f"{err:.3e} from JAX's float32 ones (tol {tol:.3e}, {ZOO_BF16_LOGIT_TOL:g} of the "
        f"largest |logit|)")
    if not err <= tol:
        raise AssertionError(f"{block}: {cfg['dtype']} logits {err:.3e} from JAX's float32 "
                             f"(tol {tol:.3e})")
    records = {}
    if not cuda or kernel is None:
        return records
    if kernel == "decode_attention":
        (nh, hd, _), = {(a, b, c) for a, b, c in seen["b1_types"]}
        check_b1_shapes(t0, block, sorted(seen["b1"]), nh, hd)
        for B, K, M, kind in sorted(seen["b1"]):   # the largest of each kind last
            timing = attention_timing(B, K, M, kind == "self",
                                      M // K - 1 if kind == "self" else None, nh=nh, hd=hd)
            log(block, t0, f"decode_attention ({kind}, path) {timing['text']}")
            records[f"decode_attention_hd{hd}_{kind}"] = timing
        records["launches"] = counts[kernel]
    elif kernel == "attention_step":
        n, text = check_coverage_shapes(sorted(seen["b2"]))
        log(block, t0, f"attention_step coverage form matches plain version at {n} checks of "
            f"the phase's shapes: {text}")
        for shape in sorted(seen["b2"]):
            log(block, t0, f"attention_step (path) {coverage_step_timing(*shape)['text']}")
    else:
        n, text = check_content_shapes(sorted(seen["b2_content"]))
        log(block, t0, f"attention_step content form matches plain version at {n} checks of "
            f"the phase's shapes: {text}")
        for shape in sorted(seen["b2_content"]):
            timing = content_step_timing(*shape)
            log(block, t0, f"attention_step content form (path) {timing['text']}")
            records["content"] = max(records.get("content", timing), timing,
                                     key=lambda r: r["bound_ms"])
        records["launches"] = counts[kernel]
    return records


def zoo_import(t0, crops, device="cuda", version=ZOO_IMPORT_VERSION):
    """The importer: a random reference state_dict (seed 0) of
    ``version``'s architecture through ``tools.torch_import`` on the card
    and on the CPU; the crops decoded in float32 (cut, beam 10) on both:
    strings equal on >= MIN_ZOO_MATCH, the first crop's teacher-forced
    logits within ZOO_LOGIT_TOL of the CPU's, B1 launching on the card.
    Then, not gated, the same in the mode ``version`` ships (int8): there
    the encoder's int8 codes round from float32 sums that the card and the
    CPU add in other orders, so the logits part by more than float32's and
    beam ties under random weights may flip."""
    import copy

    import numpy as np

    from doc2tex_tpu_torch.recognition import MathRecognition, load_recog_config
    from doc2tex_tpu_torch.tools.torch_import import (import_torch_state_dict,
                                                      reference_state_dict)

    cfg, _ = load_recog_config(version=version)
    sd = None
    for mode in dict.fromkeys((None, cfg.get("quantize"))):
        cut = dict(cut_config(cfg), quantize=mode)
        outs, logits = {}, {}
        for dev in dict.fromkeys(("cpu", device)):
            rec = MathRecognition(copy.deepcopy(cut), None, beam_size=10, device=dev)
            if sd is None:
                sd = reference_state_dict(rec.model, cut, np.random.default_rng(0))
            missing = import_torch_state_dict(sd, cut, rec.model)
            if missing:
                raise AssertionError(f"import left {missing[:8]} unfilled")
            reset_launches()
            outs[dev] = rec(crops)
            launches = launch_counts()["decode_attention"]
            logits[dev] = zoo_logits(rec, crops[0])
        same = sum(a == b for a, b in zip(outs[device], outs["cpu"]))
        err, tol, spread, gap = logit_check(logits[device], logits["cpu"])
        log("zoo", t0, f"torch_import: a random reference state_dict of {version}'s "
            f"architecture ({len(sd)} tensors) imported; {mode or 'float32'}"
            f"{'' if mode else ' (gated)'}, {VERSION_CUT_STEPS} steps, beam 10: the card's "
            f"strings equal the CPU's on {same}/{len(crops)} ({len(set(outs['cpu']))} "
            f"distinct), {launches} decode_attention launches; teacher-forced logits of crop 0 "
            f"card - CPU max {err:.3e} (tol {tol:.3e}), the CPU's std over the classes "
            f"{spread:.3e}, median top-1/top-2 gap {gap:.3e}")
        if mode is None and (same < min(MIN_ZOO_MATCH, len(crops)) or not err <= tol
                             or (device != "cpu" and launches <= 0)):
            raise AssertionError(f"torch_import: {same}/{len(crops)} strings equal, logits "
                                 f"{err:.3e} apart (tol {tol:.3e}), {launches} B1 launches")


def zoo_phase(t0, device="cuda", blocks=ZOO_BLOCKS, golden=None, crops=None):
    """Phase 20 (see the module docstring).  Returns the kernels' JSON
    records of the new instances: B1 at hd 64 (``zoo_cnn_tfm``'s
    self-attention launches) and B2's content form (``zoo_vgg_bahdanau``'s).
    A test passes ``device="cpu"`` with a tiny block, its golden and crops
    to rehearse the phase: the kernel checks and timings need the card and
    are left out."""
    golden = golden or zoo_golden()
    if crops is None:
        _, crops = golden_crops("synthetic")
        crops = crops[:ZOO_N_CROPS]
    records = []
    for block in blocks:
        got = zoo_block(t0, block, crops, golden["blocks"][block], device)
        if "decode_attention_hd64_self" in got:
            rel = got["decode_attention_hd64_self"]
            records.append({
                "name": "decode_attention_hd64", "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": KERNEL_REPLACES, "launches": got["launches"],
                "max_abs_err": rel["max_abs_err"], "ms": rel["ms"], "plain_ms": rel["plain_ms"],
                "bound_ms": rel["bound_ms"], "bound_by": rel["bound_by"],
                "library_ms": rel["library_ms"]})
        if "content" in got:
            rel = got["content"]
            records.append({
                "name": "attention_step_content", "route": "cuda", "source": B2_SOURCE,
                "replaces": B2_REPLACES, "launches": got["launches"],
                "max_abs_err": rel["max_abs_err"], "ms": rel["ms"], "plain_ms": rel["plain_ms"],
                "bound_ms": rel["bound_ms"], "bound_by": rel["bound_by"], "library_ms": None})
    if device != "cpu":
        zoo_import(t0, crops, device)
    return records


def main() -> int:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    global USERS_CUDNN_TF32
    USERS_CUDNN_TF32 = torch.backends.cudnn.allow_tf32
    # float32 means float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log("device", t0, f"{name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    log("device", t0, f"nvidia-smi: {nvidia_smi()}")
    build_kernels(t0)
    tfm_launches, tfm_steps = slice_phase(t0, "synthetic_tfm_big", "decode_attention")
    slice_shapes = tfm_launch_shapes(tfm_steps)
    log("kernel", t0, "decode_attention launch shapes of the synthetic_tfm_big slice "
        f"(B, K, M, live step; None = cross-attention): {slice_shapes}")
    records = [kernel_phase(t0, slice_shapes), attention_step_phase(t0)]
    records[0]["launches"] = tfm_launches
    records[1]["launches"], _ = slice_phase(t0, "synthetic", "attention_step")
    int8_op_phase(t0)
    slice_phase(t0, "synthetic_tfm_big", "decode_attention", quantize="int8")
    slice_phase(t0, "synthetic", "attention_step", quantize="int8")
    records += int8_memory_phase(t0)
    serve_phase(t0)
    eval_phase(t0)
    detect_phase(t0)
    detect_quant_phase(t0)
    page_phase(t0)
    detect_train_phase(t0)
    train_phase(t0)
    records.append(train_lstm_phase(t0))
    release_phase(t0, "synthetic_tfm")
    long_timings(t0, release_phase(t0, "synthetic_long"))
    crops = version_crops()
    for version in VERSION_BLOCKS:
        version_phase(t0, version, crops)
    for S in B2_WIDE_S:
        log("kernel", t0, "attention_step (reference widths, 8 crops x beam 10) "
            + coverage_step_timing(8, 10, S, *B2_WIDE)["text"])
    infer_phase(t0)
    realdata_phase(t0)
    records += zoo_phase(t0)
    print(json.dumps({"kernels": records}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # report every failed phase, then exit non-zero
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)

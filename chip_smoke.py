"""Smoke run of the PyTorch/CUDA port on one GPU: int8 ResNet-50 and
MobileNetV2, each b8 224^2 fused (the run path) and b1 224^2 unfused (the
trace path), the trained MobileNetV2 fixture loaded from its .tkmod, the
float transformers BERT-base, GPT-2 small and ViT-B/16 through
fuse_attention and K6, the tuning path (tune, the four conv layouts K7-K10,
dispatch from a tuning database) on ResNet-50, the direct-conv tuning
path (int8 VGG-16, tune_conv on K11/K12, the graph tuner), and the int8
transformers (BERT-base run and traced, GPT-2 small and ViT-B/16 run) on K1,
K4 and K1's batched mode, GPT-2 small KV-cache decoding (float: the host
loop, the step replayed as one CUDA graph, the scanned form; int8 at M = 1,
one step traced), the rest of the vision zoo (eleven builders, int8,
fused, on K1, K2 and K5; the Inception-v3 stem traced on K4), and the
TFLite import and W8A16 path (the exporter's int8 MobileNetV2 at b16 on K1,
K2 and K5 at its own zero points, traced at b1; ResNet-50 W8A16 b8 and b1
on K4 over two byte planes; the 16x8 fixture), and the ONNX import path
(ResNet-50 b8 written as torch.onnx.export writes it, fused on K1-K3; the
six exporters' fixtures float, int8 and traced; the importer's 53 ops), and
the PyTorch import path and FQ2I (a torch.ao-quantized ResNet-50 b8 on
K1-K3 at its own zero points, traced at b1 on K4; the float module through
from_torch; FQ2I'd QDQ ONNX models; the evaluation modules and the CLI's
.pt and evaluate).

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; no phase catches its own):
  1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
  2. the kernels' build from tachikoma_tpu_torch/csrc (nvcc, sm_90a), and
     `nm -D` of every library: no GNU-unique symbol (the launchers' statics
     stay local to each library, so a second copy can be loaded beside it);
  3. ResNet-50 built, quantized (numpy calibration on the host, timed here,
     outside every timed window) and fused, with random weights from a seed;
  4. K1 (qgemm_rq), K2 (qconv_rq) and K3 (qconv_rq_res) at the shapes the main
     path gives them: one forward is recorded call by call, then every call is
     replayed on the same tensors, its output held == against the kernel's
     plain PyTorch version, and timed (CUDA events over CUDA-graph replays)
     beside its bound and a library call of the same shape (at M <= 16,
     where torch._int_mm refuses, an fp16 matmul of the same shape); K1's
     tiled path, K2 and K3 share the persistent wgmma body of
     csrc/igemm_hopper.cuh (K3's residual add as two tables, K2's and K1's
     K split across blocks into a workspace whose last block requantizes
     the whole sum), K1's dense calls run its skinny split-K path, and each
     call is printed with its plan (K1's path, tile and split; K2's tile and
     split; K3's tile), beside the previous design's time on that call (K1
     and K2 on csrc/qgemm.cuh), and their times per forward beside the
     previous design's;
  5. the main path: the launch counts are set to 0, a few requests run through
     TorchExecutor(fuse=True, device="cuda"), the counts are read (each kernel
     must have launched), every captured integer node and the int8 logits are
     held == against the port's plain path (TorchExecutor on the CPU) on the
     same input, the softmax output with a stated tolerance, no weight is
     packed K-major again during the requests (K1-K4 pack each weight
     tensor once), and the median latency and images/s are printed;
  6. device time per request by kernel (torch.profiler) and the device's
     busy share of the median latency;
  7. the trace path, K4: ResNet-50 b1 224^2 quantized and left unfused; one
     forward of TorchExecutor(fuse=False, device="cuda") with all 232 nodes
     captured is recorded call by call, and every K4 call (qgemm_raw,
     qconv_raw) is held == against its plain version and timed as in phase 4,
     each conv-mode call (K3's body, K split across blocks with int32
     atomics where the tiles leave the card idle) printed with its split and
     each GEMM-mode call (K1's two paths: the tiled wgmma body, the skinny
     split-K path) with its plan, both beside the previous design's time per
     call and per forward; every captured integer node is held == against
     the CPU plain path;
  8. trace emission: the launch counts are set to 0, TraceEmitter(
     backend="torch", device="cuda").emit_to writes the b1 224^2 trace (one
     warm call, five timed), the counts are read (both K4 modes must have
     launched), no weight is packed K-major during the timed calls, the
     trace is held record by record against the CPU plain path's trace
     (integer records byte-equal, float records allclose), its CRCs checked
     natively and every record re-executed by verify_trace;
  9. MobileNetV2 b8 224^2 (the JAX package's zoo model, width 1.0, random
     weights from the seed): phases 3-6 again -- K5 qdwconv_rq at its 17
     calls (each printed with its tile, per call and per forward beside the
     first design's time) and K1/K2 at their MobileNetV2 shapes held == plain
     and timed, 20 requests with every kernel of the path launched, every
     integer node == the CPU plain path, latency, images/s and the device's
     busy time a request beside the earlier tree's;
 10. MobileNetV2 b1 224^2 unfused: phases 7-8 again -- K5 qdwconv_raw (each
     call with its tile and the first design's time) and K4 held == plain and
     timed (each GEMM-mode call with its plan and the previous design's
     time), the trace emitted on the card (1 warm + 5 timed) with both K4
     modes and qdwconv_raw launched and no weight packed during the timed
     traces, compared record by record with the CPU trace, CRC-checked and
     verify_trace'd;
 11. the trained fixture tests/fixtures/synth_mbv2.tkmod, loaded with the
     port's load_artifact, quantized on the host with a calibration batch from
     the seed and fused, run on the card: K5 launched, every integer node ==
     the CPU plain path;
 12. float BERT-base b4 s128, 13. GPT-2 small b1 s128 (causal), 14. ViT-B/16
     b8 224^2 (S = 197), full width and depth, random weights from the seed,
     in four steps each: (a) build and fuse_attention (12 tk.attention, causal
     on GPT-2's only); (b) one forward recorded call by call, every K6 call
     held against its plain version (rtol 2e-5, atol 2e-6,
     tests/test_flash_attention.py's) on the head-split views the graph
     hands over (read in place) and timed beside its bound, torch's
     scaled_dot_product_attention and the first design's time, per call (with
     its launch plan) and per forward; (c) the launch counts set to 0, 20
     requests through TorchExecutor(device="cuda"), K6 read at 12 per
     request and the wrapper's copies of q, k and v at 0, the logits and
     every tk.attention output held against the port's CPU path at rtol
     1e-4, atol 1e-4, median latency; (d) the device's busy time a request
     beside the earlier tree's share.  Phase 12 also runs K6 (e) at
     tests/test_flash_attention.py's four shapes and at D = 32, 80, 160,
     256 and 320, causal and not, S 130 and 197;
 15. the tuning path, on phase 3's ResNet-50 b8 224^2: (a) the quantized
     graph written under TMPDIR and `tachikoma_tpu_torch.cli tune --db
     --budget 64` run on it (every trial's output == its plain version before
     it is timed; the only failures allowed are the library route's refusals),
     per-task trials and bests printed; (b) with a database forcing each
     layout at 64 x 64 on the three 3x3 s2 convs, one forward recorded and
     K7-K10 (qconv_rq_t/_s/_w/_r) held == plain at its three calls, timed
     beside their bound, the plain version, cuDNN's int8 conv
     (quantized::conv2d, channels-last) and K2 on the same calls, with each
     layout's per-call wrapper work (host clock); then the same at the stem
     (7x7 s2, CIN 3, the layout forced on it alone) beside K2, and at a chain
     stage (56^2 c64 3x3 s1) beside K2;
     (c) the forward under the tuned database
     (every kernel call of one forward == plain, then 10 counted requests)
     and under each forced layout (3 counted requests, the layout launched
     3 times per forward), every integer node == phase 5's CPU path, and the
     median latency of 10 requests without and with the tuned database, in
     turns;
 16. the direct-conv tuning path: (a) int8 VGG-16 b8 224^2 (five
     tk.conv2d_chain, three tk.dense_rq) through phases 3-6 again: K2 and K1
     == plain and timed at its calls, 20 counted requests, every integer
     node == the CPU plain path (its time printed), latency, images/s and
     device busy share; (b) tune_conv on the card over the distinct conv
     workloads of VGG-16 b8 (9), ResNet-50 b8's groups-1 convs and
     MobileNetV2 b8's depthwise convs, with K11 (qconv_direct) and K12
     (qdwconv_direct) counted from 0: every trial == plain before it is
     timed, no WRONG_ANSWER and no unsupported record; then each workload's
     kernel == plain, timed beside its bound, its plain version, the library
     call, the forward's own route for the same conv (qconv2d_flat: K2, K1
     for a 1x1, K5), whose output it must equal, and the previous design's
     time (K11's mma.sync kernel; K12's own kernel, which K5's body
     replaced); each K11 call is printed with its plan
     (the Hopper path's BN and taps a step: the staged window, each tap a
     wgmma at a shifted descriptor; or the narrow path's chunk), and each
     CIN-3 conv also on K11's other path (== plain, timed); (c)
     tune_graph over VGG-16's five chain runs, each variant run as handed
     over by TorchExecutor for 5 counted requests, every integer node == the CPU
     path, the median of the last 4 its time; the records go to a database
     under TMPDIR.  The phase's host seconds are printed;
 17. the int8 transformers: (a) BERT-base b4 s128 (12 layers, hidden 768,
     the JAX package's bench configuration) built from the seed, quantized
     with TRANSFORMER_INT8 on the host (timed, outside every timed window)
     and fused, its fused op counts asserted (12 qnn.dense, 38 tk.dense_rq,
     24 tk.bmm_rq, 12 qnn.softmax, 25 qnn.layer_norm, 13 qnn.lut); (b) one
     forward recorded call by call, every K1 (qgemm_rq), K4 (qgemm_raw: the
     merged Q/K/V dense) and K1 batched-mode (qbmm_rq: the attention's two
     products of each layer) call held == plain and timed beside its bound
     and library call (an fp16 torch.matmul of the same batched shapes for
     qbmm, not exact), with its
     plan; (c) 20 requests through TorchExecutor(fuse=True, device="cuda")
     with the counts set to 0 and read, no weight packed during them, every
     integer node == the CPU path, the median latency and sequences/s; (d)
     device time by kernel and the busy share; (e) the trace path at b1
     s128, unfused: every K4 and qbmm_raw call == plain and timed, the
     trace emitted on the card (1 warm, 5 timed, no weight packed during
     them) and held record by record against the CPU's trace, CRCs and
     verify_trace; (f) GPT-2 small b1 s128 (causal) and ViT-B/16 b8 224^2
     quantized with TRANSFORMER_INT8, fused and run on the card: every
     recorded kernel call == plain, 3 counted requests with their tk.bmm_rq
     through qbmm_rq, every integer node == the CPU path;
 18. decoding (models/decoding.py, the serving path), GPT-2 small b1 with a
     cache of 128, a prompt of 8 tokens from the seed and 64 new ones (the
     JAX package's scripts/bench_models.py configuration): (a) the full
     graph, its fuse_attention form and the decode step built; (b) the host
     loop, GreedyDecoder(device="cuda").attach_prefill(fused).generate: K6
     launched 12 times in the prefill, each within rtol 2e-5, atol 2e-6 of
     plain, the tokens == the CPU decoder's (a difference prints the step
     and the top-2 gap, and fails), every step's logits within rtol 1e-4,
     atol 1e-4 of the CPU's and every position's within 2e-4 of the full
     recompute on the card, ms/token, tokens/s and the busy share of a step;
     (c) generate_ondevice: one step captured in a CUDA graph and replayed
     per token, tokens == (b)'s, ms/token with the prefill amortised, one
     replay timed alone (CUDA events); (d) gpt2_generate_scanned, tokens ==
     (b)'s; (e) the int8 step (4 step feeds calibrate TRANSFORMER_INT8,
     fused: 12 qnn.dense, 36 tk.dense_rq, 24 tk.bmm_rq, 1 float nn.matmul),
     every K1, K4 and qbmm_rq call of a step == plain and timed, every
     integer node == the CPU path, 16 tokens counted (72 launches a token)
     and == the CPU int8 decoder's; (f) one unfused int8 step at pos 8
     traced on the card: K4 and qbmm_raw == plain and timed, the trace held
     record by record against the CPU's, CRCs and verify_trace;
 19. the vision zoo (models/vision.py), each builder at the JAX builder's
     published widths and default sizes, weights and inputs from the seed:
     SqueezeNet 1.1 b8 224^2, DenseNet-121 b8 224^2, the Inception-v3 stem b8
     299^2, DQN b1 84^2 x 4, LeNet-5 b1, the MLP b1, the trained digits CNN
     b32 (tests/fixtures/digits_cnn.npz), the LSTM b1 seq 16, the DCGAN
     generator b1, SSD-lite b1 320^2 (boxes, scores, NMS indices) and
     ResNet3D-18 b1 16 x 112^2: (19a-19k) built, calibrated, quantized and
     fused, the fused op counts printed; every K1/K2/K3/K5 call of a forward
     == plain and timed beside its bound and library call; 20 requests
     through TorchExecutor(device='cuda'), launches counted, the median
     latency and (3 requests, torch.profiler) the busy share; every integer
     node == the CPU path, except the nodes that a float op computed in
     another order on the card reaches (float_source_set: float
     convolutions and products, mean and the pools, exp, sigmoid, tanh,
     softmax), each of which == its own op's CPU plain impl on the card's
     captured inputs, its end-to-end difference printed (elements, LSB, a
     quantize's distance to its rounding boundary); float nodes and outputs
     within rtol 1e-4, atol 1e-4, a float output downstream of a flipped
     quantize within atol 2e-3; argmax == the CPU's; SSD-lite's NMS == the
     oracle on the card's inputs, its indices == the CPU's or a printed
     near-tie (score and IoU both within 1e-4 of their thresholds), and
     timed; the requests run with TF32 allowed for cuDNN and matmuls, which
     the port's float convolutions and products override;
     (19l) the Inception-v3 stem b1 299^2 unfused: K4 == plain and timed,
     the trace emitted on the card and held against the CPU's, CRCs and
     verify_trace.  Each phase title carries the card's name and power
     limit;
 20. the TFLite import and the W8A16 path: (a) the exporter's int8
     MobileNetV2 96^2 (tests/fixtures/mobilenet_v2_int8.tflite: 52 convs
     and a dense, every one at a nonzero input zero point, -128 on 25;
     TFLite's stride-2 SAME padding (0, 0, 1, 1)) imported at b16 with
     integer_lut False and the default, fused: every K1/K2/K5 call == plain
     and timed beside its bound and library call, 20 requests on the batch
     fixture's 16 images (launches counted), every integer node == the CPU
     path, the int8 output within one quantum of the TFLite interpreter's
     goldens and top-1 16 of 16, latency, images/s and the busy share; the
     default import's nodes == the CPU path, top-1 16 of 16; (b) the same
     model b1 unfused: K4 and K5's raw mode == plain, the trace emitted on
     the card, held against the CPU's, CRCs and verify_trace; (c) ResNet-50
     quantized W8A16 (int16 activations, int64 accumulators; seed 0, numpy
     calibration outside the timed windows) b8 224^2, unfused: every int64
     product (wide_planes: K4's raw modes on two byte planes of the int16
     activations) == its float64 plain version and timed beside its bound
     and the float64 cuBLAS / cuDNN call of the same shapes, every plane's
     K4 call == plain and timed, 20 requests, every integer node == the CPU
     path, the probabilities within phase 5's tolerance, latency and the
     busy share; (d) its b1 trace on the card, held against the CPU's
     trace, CRCs and verify_trace; (e) the 16x8 TFLite fixture on the card
     (K4 and K5's raw modes on the planes, a depthwise conv among them):
     every call == plain, integers == the CPU path, the float output within
     2^-15 of the interpreter's;
 21. the ONNX import path: (a) ResNet-50 b8 224^2 written as
     torch.onnx.export lays out torchvision's model (models/onnx_resnet.py:
     batch norms folded into the convs, NCHW input, weights from the seed)
     with the port's encoder, imported with from_onnx, calibrated,
     quantized and fused, its fused op counts asserted (14 tk.conv2d_rq, 1
     tk.conv2d_chain, 4 tk.conv2d_block_stack, 1 tk.dense_rq: native
     ResNet-50's); every K1/K2/K3 call == plain and timed, 20 requests with
     the launches counted, every integer node == the CPU path, the median
     latency, images/s and the busy share; (b) the six exporters' fixtures
     (tests/fixtures/{paddle,oneflow,caffe,coreml,darknet}_route.onnx,
     mxnet_lenet.onnx): float on the card within rtol 1e-4, atol 1e-4 of
     their expected outputs and of the CPU path; int8 and fused, every
     kernel call == plain and timed, every node held as phase 19 holds it;
     a b1 graph of each (the batch overridden at import) unfused and traced
     on the card (K4), held against the CPU's trace, CRCs and verify_trace;
     (c) each of the importer's 53 ops on the card against its CPU torch
     impl on tests/onnx_op_cases.py's cases: integers, indices, bools and
     the exact float ops ==, the others within rtol 1e-5, atol 1e-6; (d)
     `python -m tachikoma_tpu_torch.cli run` on darknet_route.onnx (on the
     card, the CLI's default), its output within rtol 1e-4, atol 1e-4 of
     the expected one.  The phase's host seconds are printed.
 22. the PyTorch import path and FQ2I: (a) ResNet-50 as a torchvision-layout
     nn.Module (models/torch_resnet.py, weights from the seed), quantized by
     torch.ao on the host (prepare_fx, fbgemm's default qconfig, one b2 224^2
     calibration batch, convert_fx; timed outside every timed window),
     imported at b8 224^2 with import_torch_quantized (the model's own scales
     and zero points: quint8's shifted by -128) and fused (14 / 1 / 4 / 1, as
     phase 21a), the stem's and a block stack's zero points printed; every
     K1/K2/K3 call == plain and timed, 20 requests with the launches counted,
     every integer node and the logits == the CPU path, latency, images/s and
     the busy share; the largest difference from torch's eager quantized model
     (on the host) in output quanta, the top-1 agreement and the distinct
     top-1 classes, printed and not held; (b) the same model imported at b1
     224^2, unfused and traced on the card (K4), as phases 7-8; (c) the float
     module through from_torch: the b8 forward on the card within rtol 1e-4
     and atol 2.5e-3 (2.6x the largest float32 distance measured: the pooled
     features' scale is 10^3) of torch eager on the card and of the CPU path,
     then quantize and fuse (14 / 1 / 4 / 1), one b8 forward with the launches
     counted, every K1/K2/K3 call == plain and every integer node == the CPU
     path; (d) FQ2I on the three QDQ ONNX models of tests/test_fq2i.py
     (tests/torch_import_cases.py): from_onnx, fq2i, fuse, integer ops only,
     on the card == the CPU path, every kernel call == plain; (e)
     quantization_report of (c)'s float and quantized graphs on one b8 batch
     (the numpy oracle; the worst five layers' SNR), eval_topk of (c)'s float
     graph against (a)'s int8 graph on 64 synthetic_images on the card with
     the float graph's distinct top-1 classes printed, and `python -m
     tachikoma_tpu_torch.cli run` on a saved (model, shape) .pt of (a)'s model
     and `cli evaluate` of the float and int8 .pt files on a dataset .npz,
     both exiting 0. The phase's host seconds are printed.

In the kernels line, the times (ms, plain_ms, bound_ms, library_ms) of K1-K4
are per ResNet-50 forward (b8 fused for K1-K3, b1 unfused for K4), those of
K5 per MobileNetV2 forward (b8 fused for qdwconv_rq, b1 unfused for
qdwconv_raw), those of K6 (flash_attn) per BERT-base b4 s128 forward (its
bound at the 3xTF32 rate, 495 / 3 TFLOP/s, or its bytes), those
of K7-K10 per ResNet-50 b8 forward with the layout forced (its three 3x3 s2
calls; every wrapper's device work included), those of K11 per VGG-16 b8
forward (its 13 conv calls, summed with their repeats) and of K12 per
MobileNetV2 b8 forward (its 17 depthwise calls), those of qbmm_rq per int8
BERT-base b4 s128 forward and of qbmm_raw per int8 BERT-base b1 s128 trace
forward (phase 17), those of wide_planes (the W8A16 products on K4 / K5
over two byte planes: its bound the int16 read, int8 weights and int64
write, or two int8 products; its library call the float64 product) per
W8A16 ResNet-50 b8 forward (phase 20c); `launches` sums each
kernel's launches over the paths' timed runs (phases 5, 8, 9, 10, 11,
12c-14c, 15c, 16a, 16c, 17c, 17e, 17f, 18b, 18e, 18f, 19a-19k, 19l, 20a-20e,
21a, 21b, 22a-22d; K11
and K12 in 16b's tune_conv run), each counted from 0 just before its run; max_abs_err is the largest over every check.  TF32 is off for matmuls and cuDNN (the float path's
products are float32).  The line before the last is one JSON object
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

BATCH, IMAGE, SEED = 8, 224, 0
REQUESTS = 20
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak, same source
SOFTMAX_RTOL, SOFTMAX_ATOL = 1e-5, 1e-8
TF32X3_OPS_PER_S = 495e12 / 3      # K6's 3xTF32 products: the dense TF32 peak over 3, same source
FA_RTOL, FA_ATOL = 2e-5, 2e-6      # K6 vs plain: tests/test_flash_attention.py:42
GRAPH_RTOL, GRAPH_ATOL = 1e-4, 1e-4  # a 12-layer float forward, card vs CPU
# tests/test_flash_attention.py:27-32 (B, H, S, D, causal), then the head
# widths of tests/test_torch_port_cuda.py's K6 cases (D above 128: the
# output columns split across blocks; 320: Q and K read from global memory)
FA_SHAPES = ((2, 2, 128, 64, False), (1, 3, 256, 64, True), (2, 2, 200, 128, False),
             (1, 2, 130, 64, True),
             *((2, 3, 130 if i % 2 else 197, d, causal) for i, d in enumerate((32, 80, 160, 256, 320))
               for causal in (False, True)))

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6  # float trace records (tests/test_trace.py's rule)
TRACE_BATCH = 1
TRACE_TIMED = 5

KERNELS = {
    "qgemm_rq": ("tachikoma_tpu_torch/csrc/qgemm_rq.cu",
                 "tachikoma_tpu/ops/pallas/matmul_int8.py:33"),
    "qconv_rq": ("tachikoma_tpu_torch/csrc/qconv_igemm_hopper.cu",
                 "tachikoma_tpu/ops/pallas/conv_flat.py:68"),
    "qconv_rq_res": ("tachikoma_tpu_torch/csrc/qconv_igemm_hopper.cu",
                     "tachikoma_tpu/ops/pallas/conv_flat.py:1285"),
    "qgemm_raw": ("tachikoma_tpu_torch/csrc/qgemm_rq.cu",
                  "tachikoma_tpu/ops/pallas/matmul_int8.py:61"),
    "qconv_raw": ("tachikoma_tpu_torch/csrc/qconv_igemm_hopper.cu",
                  "tachikoma_tpu/ops/pallas/conv_flat.py:68"),
    "qdwconv_rq": ("tachikoma_tpu_torch/csrc/qdwconv.cu",
                   "tachikoma_tpu/ops/pallas/conv_flat.py:402"),
    # no Pallas kernel: the JAX package's grouped qnn.conv2d (lax.conv)
    "qdwconv_raw": ("tachikoma_tpu_torch/csrc/qdwconv.cu",
                    "tachikoma_tpu/ops/jax_ops.py:121"),
    "flash_attn": ("tachikoma_tpu_torch/csrc/flash_attn.cu",
                   "tachikoma_tpu/ops/pallas/flash_attention.py:33"),
    "qconv_rq_t": ("tachikoma_tpu_torch/csrc/qconv_layouts_hopper.cu",
                   "tachikoma_tpu/ops/pallas/conv_flat.py:278"),
    "qconv_rq_s": ("tachikoma_tpu_torch/csrc/qconv_layouts.cu",
                   "tachikoma_tpu/ops/pallas/conv_flat.py:133"),
    "qconv_rq_w": ("tachikoma_tpu_torch/csrc/qconv_layouts_hopper.cu",
                   "tachikoma_tpu/ops/pallas/conv_flat.py:182"),
    "qconv_rq_r": ("tachikoma_tpu_torch/csrc/qconv_layouts.cu",
                   "tachikoma_tpu/ops/pallas/conv_flat.py:224"),
    "qconv_direct": ("tachikoma_tpu_torch/csrc/qconv_direct.cu",
                     "tachikoma_tpu/ops/pallas/conv_int8.py:47"),
    "qdwconv_direct": ("tachikoma_tpu_torch/csrc/qdwconv.cu",
                       "tachikoma_tpu/ops/pallas/conv_int8.py:87"),
    # no Pallas kernel: XLA runs tk.bmm_rq and qnn.batch_matmul in the JAX package
    "qbmm_rq": ("tachikoma_tpu_torch/csrc/qgemm_rq.cu", "tachikoma_tpu/runtime/fuse.py:389"),
    "qbmm_raw": ("tachikoma_tpu_torch/csrc/qgemm_rq.cu", "tachikoma_tpu/ops/jax_ops.py:249"),
    # no Pallas kernel: XLA runs qnn.conv2d / qnn.dense into int64 in the JAX
    # package; the port runs them on K4 / K5's raw modes over two byte planes
    "wide_planes": ("tachikoma_tpu_torch/ops/kernels/wide.py",
                    "tachikoma_tpu/ops/jax_ops.py:103"),
}
LAYOUT_KERNELS = ("qconv_rq_t", "qconv_rq_s", "qconv_rq_w", "qconv_rq_r")
WRAPPER_CALLS = 20                # host-clock repeats of the wrappers' own work
TUNE_BUDGET = 64
FORCED_BLOCKS = [64, 64, 64]      # the tile of the forced-layout databases (phase 15)
FORCED_REQUESTS = 3
TUNED_REQUESTS = 10               # pairs of untuned and tuned requests, in turns
CHAIN_STAGE = ((8, 56, 56, 64), (3, 3, 64, 64), (1, 1), (1, 1, 1, 1))  # 56^2 c64 3x3 s1
RUN_KERNELS = ("qgemm_rq", "qconv_rq", "qconv_rq_res")
TRACE_KERNELS = ("qgemm_raw", "qconv_raw")
MBV2_RUN_KERNELS = ("qdwconv_rq", "qgemm_rq", "qconv_rq")
MBV2_TRACE_KERNELS = ("qdwconv_raw", "qgemm_raw", "qconv_raw")
FIXTURE = os.path.join("tests", "fixtures", "synth_mbv2.tkmod")
# phase 20: the exporter-made TFLite fixtures and the W8A16 path
TFLITE_MODEL = os.path.join("tests", "fixtures", "mobilenet_v2_int8.tflite")
TFLITE_BATCH = os.path.join("tests", "fixtures", "mobilenet_v2_int8_batch.npz")
TFLITE_16X8 = os.path.join("tests", "fixtures", "small_cnn_16x8.tflite")
TFLITE_16X8_IO = os.path.join("tests", "fixtures", "small_cnn_16x8_io.npz")
TFLITE_KERNELS = ("qgemm_rq", "qconv_rq", "qdwconv_rq")
TFLITE_TRACE_KERNELS = ("qgemm_raw", "qconv_raw", "qdwconv_raw")
W8A16_KERNELS = ("wide_planes", "qgemm_raw", "qconv_raw")
W8A16_16X8_KERNELS = ("wide_planes", "qgemm_raw", "qconv_raw", "qdwconv_raw")
VGG_RUN_KERNELS = ("qconv_rq", "qgemm_rq")
DIRECT_KERNELS = ("qconv_direct", "qdwconv_direct")
VGG_CONVS, VGG_CONV_WORKLOADS, MBV2_DW_CONVS = 13, 9, 17
GRAPH_TUNE_REQUESTS = 5           # per variant; the first is dropped from the median
SEQ = 128                         # BERT-base and GPT-2 small's sequence (phases 12, 13, 17)
BERT_BATCH = 4
# the fused int8 BERT-base's op counts (phase 17a), from the JAX package's fuse_qnn
BERT_INT8_OPS = {"qnn.dense": 12, "tk.dense_rq": 38, "tk.bmm_rq": 24, "qnn.softmax": 12,
                 "qnn.layer_norm": 25, "qnn.lut": 13}
INT8_TRANSFORMER_KERNELS = ("qgemm_rq", "qgemm_raw", "qbmm_rq")
INT8_TRACE_KERNELS = ("qgemm_raw", "qbmm_raw")
INT8_CHECK_REQUESTS = 3           # phase 17f's counted requests
# decoding (phase 18): the JAX package's bench configuration
# (scripts/bench_models.py gpt2_decode): GPT-2 small b1, a cache of 128, a
# prompt of 8 tokens, then 64 new ones; the int8 step calibrated on 4 step feeds
DECODE_PROMPT, DECODE_NEW, DECODE_INT8_NEW, DECODE_CALIB = 8, 64, 16, 4
DECODE_LAYERS, DECODE_VOCAB = 12, 50257
STEP_RTOL, STEP_ATOL = 1e-4, 1e-4  # a step's logits, card vs CPU
RECOMPUTE_TOL = 2e-4               # tests/test_decoding.py:55-62
REPLAYS_TIMED = 20
# the fused int8 GPT-2 small step's op counts, from the JAX package's fuse_qnn
GPT2_INT8_STEP_OPS = {"qnn.dense": 12, "tk.dense_rq": 36, "tk.bmm_rq": 24, "nn.matmul": 1}
DECODE_KERNELS = ("qgemm_rq", "qgemm_raw", "qbmm_rq")
DECODE_TRACE_KERNELS = ("qgemm_raw", "qbmm_raw")
# The previous designs' ms on one NVIDIA H100 80GB HBM3 at 700.00 W, printed
# beside this run's (PERF.md's kernel table): per forward, K3 (ResNet-50 b8)
# and K4's conv mode (b1) on their first body, csrc/qgemm.cuh, and K2 on it
# and K11 on its mma.sync kernel (this script on the tree before them); per
# call, K2 and K11 there, by the shape label of `work`.
EARLIER_MS = {("ResNet-50", "qconv_rq_res"): 0.3525, ("ResNet-50", "qconv_raw"): 0.6127,
              ("ResNet-50", "qconv_rq"): 0.7759, ("VGG-16", "qconv_rq"): 2.1242,
              ("MobileNetV2", "qconv_rq"): 0.0311, ("VGG-16", "qconv_direct"): 1.9689,
              ("ResNet-50", "qconv_direct"): 1.8627,
              # K5 and K6 before their Hopper redesign (their first designs)
              ("MobileNetV2", "qdwconv_rq"): 0.1892, ("MobileNetV2", "qdwconv_raw"): 0.0777,
              # K1 on csrc/qgemm.cuh and K12 on its own kernel, before their redesign
              ("ResNet-50", "qgemm_rq"): 0.4246, ("MobileNetV2", "qgemm_rq"): 0.3658,
              ("VGG-16", "qgemm_rq"): 0.4019, ("MobileNetV2", "qdwconv_direct"): 0.1936,
              # K4's GEMM mode on csrc/qgemm.cuh, before it moved onto K1's paths
              # (tools/gemm_probe.py --raw --csrc on the tree before it, b1 forwards)
              ("ResNet-50", "qgemm_raw"): 0.3268, ("MobileNetV2", "qgemm_raw"): 0.2139,
              ("BERT-base b4 s128", "flash_attn"): 0.2954,
              ("GPT-2 small b1 s128", "flash_attn"): 0.2878,
              (f"ViT-B/16 b{BATCH} {IMAGE}^2", "flash_attn"): 0.8744}
# The device's busy share of a request on the tree before K5 and K6's
# redesign (this script's phases 9d and 12d-14d there)
EARLIER_BUSY = {"MobileNetV2": "1.8423 ms, 7.5%", "BERT-base b4 s128": "27.3%",
                "GPT-2 small b1 s128": "17.3%", f"ViT-B/16 b{BATCH} {IMAGE}^2": "72.4%"}
EARLIER_CALL_MS = {
    # K12's own kernel before it moved onto K5's body (tools/dw_probe.py --k12 on it)
    ("MobileNetV2", "qdwconv_direct"): {
        "8x112x112x32 k3 s1 -> 32": 0.0312, "8x112x112x96 k3 s2 -> 96": 0.0190,
        "8x56x56x144 k3 s1 -> 144": 0.0312, "8x56x56x144 k3 s2 -> 144": 0.0128,
        "8x28x28x192 k3 s1 -> 192": 0.0112, "8x28x28x192 k3 s2 -> 192": 0.0075,
        "8x14x14x384 k3 s1 -> 384": 0.0070, "8x14x14x576 k3 s1 -> 576": 0.0098,
        "8x14x14x576 k3 s2 -> 576": 0.0054, "8x7x7x960 k3 s1 -> 960": 0.0051},
    # K1's first design (csrc/qgemm.cuh), per call (tools/gemm_probe.py on it)
    ("ResNet-50", "qgemm_rq"): {
        "M=25088 K=64 N=64": 0.0086, "M=25088 K=64 N=256": 0.0332, "M=25088 K=256 N=64": 0.0117,
        "M=25088 K=256 N=128": 0.0251, "M=6272 K=256 N=512": 0.0241, "M=6272 K=512 N=128": 0.0131,
        "M=6272 K=512 N=256": 0.0181, "M=1568 K=512 N=1024": 0.0199, "M=1568 K=1024 N=256": 0.0148,
        "M=1568 K=1024 N=512": 0.0197, "M=392 K=1024 N=2048": 0.0194, "M=392 K=2048 N=512": 0.0243,
        "M=8 K=2048 N=1000": 0.0195},
    ("MobileNetV2", "qgemm_rq"): {
        "M=100352 K=32 N=16": 0.0109, "M=100352 K=16 N=96": 0.0393, "M=25088 K=96 N=24": 0.0059,
        "M=25088 K=24 N=144": 0.0217, "M=25088 K=144 N=24": 0.0067, "M=6272 K=144 N=32": 0.0061,
        "M=6272 K=32 N=192": 0.0086, "M=6272 K=192 N=32": 0.0061, "M=1568 K=192 N=64": 0.0061,
        "M=1568 K=64 N=384": 0.0075, "M=1568 K=384 N=64": 0.0079, "M=1568 K=384 N=96": 0.0079,
        "M=1568 K=96 N=576": 0.0080, "M=1568 K=576 N=96": 0.0096, "M=392 K=576 N=160": 0.0098,
        "M=392 K=160 N=960": 0.0067, "M=392 K=960 N=160": 0.0131, "M=392 K=960 N=320": 0.0138,
        "M=392 K=320 N=1280": 0.0105, "M=8 K=1280 N=1000": 0.0134},
    # K4's GEMM mode on csrc/qgemm.cuh, per b1 call (tools/gemm_probe.py --raw on it)
    ("ResNet-50", "qgemm_raw"): {
        "M=3136 K=64 N=64": 0.0041, "M=3136 K=64 N=256": 0.0066, "M=3136 K=256 N=64": 0.0059,
        "M=3136 K=256 N=128": 0.0064, "M=784 K=128 N=512": 0.0050, "M=784 K=256 N=512": 0.0062,
        "M=784 K=512 N=128": 0.0082, "M=784 K=512 N=256": 0.0083, "M=196 K=256 N=1024": 0.0058,
        "M=196 K=512 N=1024": 0.0082, "M=196 K=1024 N=256": 0.0128, "M=196 K=1024 N=512": 0.0124,
        "M=49 K=512 N=2048": 0.0081, "M=49 K=1024 N=2048": 0.0128, "M=49 K=2048 N=512": 0.0222,
        "M=1 K=2048 N=1000": 0.0182},
    ("MobileNetV2", "qgemm_raw"): {
        "M=12544 K=32 N=16": 0.0036, "M=12544 K=16 N=96": 0.0082, "M=3136 K=96 N=24": 0.0037,
        "M=3136 K=24 N=144": 0.0057, "M=3136 K=144 N=24": 0.0042, "M=784 K=144 N=32": 0.0046,
        "M=784 K=32 N=192": 0.0041, "M=784 K=192 N=32": 0.0046, "M=196 K=192 N=64": 0.0050,
        "M=196 K=64 N=384": 0.0041, "M=196 K=384 N=64": 0.0069, "M=196 K=384 N=96": 0.0068,
        "M=196 K=96 N=576": 0.0047, "M=196 K=576 N=96": 0.0085, "M=49 K=576 N=160": 0.0081,
        "M=49 K=160 N=960": 0.0050, "M=49 K=960 N=160": 0.0116, "M=49 K=960 N=320": 0.0116,
        "M=49 K=320 N=1280": 0.0063, "M=1 K=1280 N=1000": 0.0123},
    ("VGG-16", "qgemm_rq"): {
        "M=8 K=25088 N=4096": 0.3230, "M=8 K=4096 N=4096": 0.0403, "M=8 K=4096 N=1000": 0.0359},
    ("ResNet-50", "qconv_rq"): {
        "8x224x224x3 k7 s2 -> 64": 0.0710, "8x56x56x64 k3 s1 -> 64": 0.0211,
        "8x56x56x128 k3 s2 -> 128": 0.0305, "8x28x28x128 k3 s1 -> 128": 0.0316,
        "8x28x28x256 k3 s2 -> 256": 0.0443, "8x14x14x256 k3 s1 -> 256": 0.0447,
        "8x14x14x512 k3 s2 -> 512": 0.0828, "8x7x7x512 k3 s1 -> 512": 0.0833},
    ("VGG-16", "qconv_rq"): {
        "8x224x224x3 k3 s1 -> 64": 0.1252, "8x224x224x64 k3 s1 -> 64": 0.2188,
        "8x112x112x64 k3 s1 -> 128": 0.1199, "8x112x112x128 k3 s1 -> 128": 0.2079,
        "8x56x56x128 k3 s1 -> 256": 0.1099, "8x56x56x256 k3 s1 -> 256": 0.2041,
        "8x28x28x256 k3 s1 -> 512": 0.1287, "8x28x28x512 k3 s1 -> 512": 0.2447,
        "8x14x14x512 k3 s1 -> 512": 0.1044},
    ("MobileNetV2", "qconv_rq"): {"8x224x224x3 k3 s2 -> 32": 0.0311},
    # K5's first design, per call (tools/dw_probe.py --design first on it)
    ("MobileNetV2", "qdwconv_rq"): {
        "8x112x112x32 k3 s1 -> 32": 0.0234, "8x112x112x96 k3 s2 -> 96": 0.0213,
        "8x56x56x144 k3 s1 -> 144": 0.0286, "8x56x56x144 k3 s2 -> 144": 0.0093,
        "8x28x28x192 k3 s1 -> 192": 0.0127, "8x28x28x192 k3 s2 -> 192": 0.0056,
        "8x14x14x384 k3 s1 -> 384": 0.0076, "8x14x14x576 k3 s1 -> 576": 0.0103,
        "8x14x14x576 k3 s2 -> 576": 0.0051, "8x7x7x960 k3 s1 -> 960": 0.0055},
    ("MobileNetV2", "qdwconv_raw"): {
        "1x112x112x32 k3 s1 -> 32": 0.0049, "1x112x112x96 k3 s2 -> 96": 0.0051,
        "1x56x56x144 k3 s1 -> 144": 0.0058, "1x56x56x144 k3 s2 -> 144": 0.0044,
        "1x28x28x192 k3 s1 -> 192": 0.0046, "1x28x28x192 k3 s2 -> 192": 0.0043,
        "1x14x14x384 k3 s1 -> 384": 0.0042, "1x14x14x576 k3 s1 -> 576": 0.0043,
        "1x14x14x576 k3 s2 -> 576": 0.0042, "1x7x7x960 k3 s1 -> 960": 0.0041},
    ("VGG-16", "qconv_direct"): {
        "8x224x224x3 k3 s1 -> 64": 0.0874, "8x224x224x64 k3 s1 -> 64": 0.2208,
        "8x112x112x64 k3 s1 -> 128": 0.1235, "8x112x112x128 k3 s1 -> 128": 0.2027,
        "8x56x56x128 k3 s1 -> 256": 0.1050, "8x56x56x256 k3 s1 -> 256": 0.1885,
        "8x28x28x256 k3 s1 -> 512": 0.1261, "8x28x28x512 k3 s1 -> 512": 0.2387,
        "8x14x14x512 k3 s1 -> 512": 0.0830},
    ("ResNet-50", "qconv_direct"): {
        "8x224x224x3 k7 s2 -> 64": 0.0371, "8x56x56x64 k1 s1 -> 256": 0.0346,
        "8x56x56x64 k1 s1 -> 64": 0.0107, "8x56x56x64 k3 s1 -> 64": 0.0193,
        "8x56x56x256 k1 s1 -> 64": 0.0194, "8x56x56x256 k1 s1 -> 128": 0.0300,
        "8x56x56x128 k3 s2 -> 128": 0.0300, "8x28x28x128 k1 s1 -> 512": 0.0266,
        "8x56x56x256 k1 s2 -> 512": 0.0516, "8x28x28x512 k1 s1 -> 128": 0.0259,
        "8x28x28x128 k3 s1 -> 128": 0.0261, "8x28x28x512 k1 s1 -> 256": 0.0325,
        "8x28x28x256 k3 s2 -> 256": 0.0417, "8x14x14x256 k1 s1 -> 1024": 0.0214,
        "8x28x28x512 k1 s2 -> 1024": 0.0471, "8x14x14x1024 k1 s1 -> 256": 0.0409,
        "8x14x14x256 k3 s1 -> 256": 0.0369, "8x14x14x1024 k1 s1 -> 512": 0.0451,
        "8x14x14x512 k3 s2 -> 512": 0.0760, "8x7x7x512 k1 s1 -> 2048": 0.0271,
        "8x14x14x1024 k1 s2 -> 2048": 0.0724, "8x7x7x2048 k1 s1 -> 512": 0.0796,
        "8x7x7x512 k3 s1 -> 512": 0.0666},
}
# printed call by call with their plan
PLAN_KERNELS = ("qgemm_rq", "qconv_rq", "qconv_rq_res", "qgemm_raw", "qconv_raw", "qdwconv_rq",
                "qdwconv_raw", "flash_attn", "qbmm_rq", "qbmm_raw")
BMM_KERNELS = ("qbmm_rq", "qbmm_raw")


def say(*a):
    print(*a, flush=True)


def phase(title):
    say(f"\n== {title}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def graph_ms(fn) -> float:
    """Device time of one fn() call: 20 calls captured in a CUDA graph,
    replayed 3 times, timed with CUDA events (no host time between launches;
    the tuner's timer, tachikoma_tpu_torch/utils/timing.py)."""
    from tachikoma_tpu_torch.utils.timing import call_seconds

    return call_seconds(fn, "cuda") * 1e3


def eager_ms(fn, reps=3) -> float:
    """Time of one fn() call run eagerly (host dispatch included), CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel calls of the main path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording(calls: list):
    """Record every call of the kernel wrappers (kernel name, args, kwargs)."""
    from tachikoma_tpu_torch.ops import attention
    from tachikoma_tpu_torch.ops.kernels import conv, matmul_int8, wide

    saved = []
    for mod, attr, name in ((wide, "wide_conv", "wide_planes"), (wide, "wide_dense", "wide_planes"),
                            (matmul_int8, "qgemm_rq", "qgemm_rq"), (conv, "qconv_rq", "qconv_rq"),
                            (conv, "qconv_rq_res", "qconv_rq_res"),
                            (matmul_int8, "qgemm_raw", "qgemm_raw"),
                            (conv, "qconv_raw", "qconv_raw"),
                            (conv, "qdwconv_rq", "qdwconv_rq"),
                            (conv, "qdwconv_raw", "qdwconv_raw"),
                            (attention, "flash_attention", "flash_attn"),
                            (matmul_int8, "qbmm_rq", "qbmm_rq"),
                            (matmul_int8, "qbmm_raw", "qbmm_raw"),
                            *((conv, name, name) for name in LAYOUT_KERNELS)):
        fn = getattr(mod, attr)

        def rec(*a, _fn=fn, _name=name, **k):
            calls.append((_name, a, k))
            return _fn(*a, **k)

        saved.append((mod, attr, fn))
        setattr(mod, attr, rec)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def work(name, a, k) -> tuple[int, int, str]:
    """(bytes moved, operations, shape label) of one call: each input read
    once, each output written once (a depthwise weight is (KH, KW, 1, C):
    one input channel per output channel; attention reads q, k, v and writes
    out, (G, S, D) float32 each, and under causal needs the products of the
    S (S + 1) / 2 unmasked scores only; K1's batched mode reads its operands
    (views read in place) and writes (batch, M, N))."""
    if name in BMM_KERNELS:
        from tachikoma_tpu_torch.ops.kernels.matmul_int8 import _logical

        A, B = _logical(a[0], a[1], k.get("transpose_a", False), k.get("transpose_b", False))
        m, kk, n = A.shape[-2], A.shape[-1], B.shape[-1]
        nb = int(np.prod(torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])))
        out_b = 4 if name == "qbmm_raw" else 1
        return (A.numel() + B.numel() + out_b * nb * m * n, 2 * nb * m * kk * n,
                f"{nb}x ({m}, {kk}) x ({kk}, {n})")
    if name == "flash_attn":
        b, h, s, d = a[0].shape
        g = b * h
        causal = bool(k.get("causal", False))
        ops = 4 * g * d * s * (s + 1) // 2 if causal else 4 * g * s * s * d
        return (4 * g * s * d * 4, ops,
                f"G={g} S={s} D={d}{' causal' if causal else ''}")
    x, w = a[0], a[1]
    cout = w.shape[-1]
    if name == "wide_planes":  # int16 in, int8 weights, int64 out; two int8 products
        if w.ndim == 2:
            m, kk = x.shape
            return (2 * m * kk + kk * cout + 8 * m * cout, 2 * 2 * m * kk * cout,
                    f"M={m} K={kk} N={cout} int16")
        out_shape, label = conv_out(x, w, k)
        return (2 * x.numel() + w.numel() + 8 * int(np.prod(out_shape)),
                2 * 2 * int(np.prod(out_shape)) * int(np.prod(w.shape[:3])), label + " int16")
    raw = name.endswith("_raw")
    out_b, vec_b = (4, 4) if raw else (1, 12)  # output bytes, per-channel vector bytes
    if name in ("qgemm_rq", "qgemm_raw"):
        m, kk = x.shape
        return (m * kk + kk * cout + out_b * m * cout + vec_b * cout, 2 * m * kk * cout,
                f"M={m} K={kk} N={cout}")
    kh, kw, cin, _ = w.shape
    sh, sw = k.get("strides", (1, 1))
    pt, pl, pb, pr = k.get("padding", (0, 0, 0, 0))
    n, h, wd, _ = x.shape
    oh, ow = (h + pt + pb - kh) // sh + 1, (wd + pl + pr - kw) // sw + 1
    out = n * oh * ow * cout
    nbytes = (x.numel() + w.numel() + out_b * out + vec_b * cout
              + (out if name == "qconv_rq_res" else 0))
    return (nbytes, 2 * out * kh * kw * cin,
            f"{n}x{h}x{wd}x{x.shape[3]} k{kh} s{sh} -> {cout}")


def conv_out(x, w, k) -> tuple[tuple, str]:
    """The output shape (N, OH, OW, COUT) of a recorded conv call, and its label."""
    kh, kw = w.shape[:2]
    sh, sw = k.get("strides", (1, 1))
    pt, pl, pb, pr = k.get("padding", (0, 0, 0, 0))
    n, h, wd, c = x.shape
    oh, ow = (h + pt + pb - kh) // sh + 1, (wd + pl + pr - kw) // sw + 1
    return (n, oh, ow, w.shape[3]), f"{n}x{h}x{wd}x{c} k{kh} s{sh} -> {w.shape[3]}"


def library_call(name, a, k):
    """One PyTorch call of the same shape (used only as a yardstick): for the
    GEMMs torch._int_mm, which computes K4's function exactly but refuses M
    <= 16 and, through cuBLASLt, some other shapes (M=784 K=32 N=192 on
    torch 2.11, CUDA 12.8); there an fp16 matmul of the same shape."""
    x, w = a[0], a[1]
    if name == "wide_planes":  # the exact float64 product (cuBLAS, cuDNN) of the same shapes
        xd, wd = x.to(torch.float64), w.to(torch.float64)
        if w.ndim == 2:
            return lambda: xd @ wd
        pt, pl, pb, pr = k.get("padding", (0, 0, 0, 0))
        xd = torch.nn.functional.pad(xd, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2).contiguous()
        wd = wd.permute(3, 2, 0, 1).contiguous()
        groups = int(k.get("groups", 1))
        return lambda: torch.nn.functional.conv2d(xd, wd, stride=tuple(k.get("strides", (1, 1))),
                                                  groups=groups)
    if name in BMM_KERNELS:  # an fp16 product of the same shapes: not exact
        from tachikoma_tpu_torch.ops.kernels.matmul_int8 import _logical

        A, B = _logical(x.half(), w.half(), k.get("transpose_a", False),
                        k.get("transpose_b", False))
        A, B = A.contiguous(), B.contiguous()
        return lambda: torch.matmul(A, B)
    if name == "flash_attn":
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            x, w, a[2], is_causal=bool(k.get("causal", False)), scale=k.get("scale"))
    if name in ("qgemm_rq", "qgemm_raw"):
        m, kk = x.shape
        n = w.shape[1]
        if m > 16 and kk % 8 == 0 and n % 8 == 0:
            try:
                torch._int_mm(x, w)
                return lambda: torch._int_mm(x, w)
            except RuntimeError as e:
                say(f"torch._int_mm refuses M={m} K={kk} N={n}: {str(e)[:60]}")
        x16, w16 = x.half(), w.half()
        return lambda: x16 @ w16
    pt, pl, pb, pr = k.get("padding", (0, 0, 0, 0))
    stride = tuple(k.get("strides", (1, 1)))
    if name in LAYOUT_KERNELS or name == "qconv_direct":
        assert (pt, pl) == (pb, pr), "library conv takes symmetric padding"
        # cuDNN's int8 conv (quantized::conv2d on the card) on the same int8
        # tensors, channels-last, per-tensor scales, cuDNN's own requantize;
        # a CIN that is not a multiple of 4 (the CIN-3 first convs) is padded
        # with zero channels first, outside the timed call: cuDNN would pad it
        # on each call with a host copy, which a CUDA graph cannot capture
        cpad = -x.shape[3] % 4
        if cpad:
            x = torch.nn.functional.pad(x, (0, cpad))
            w = torch.nn.functional.pad(w, (0, 0, 0, cpad))
        qx = torch._make_per_tensor_quantized_tensor(x, 1.0, 0).permute(0, 3, 1, 2)
        qw = torch._make_per_tensor_quantized_tensor(w.permute(3, 2, 0, 1).contiguous(), 1.0, 0)
        packed = torch.ops.quantized.conv2d_prepack(qw, None, list(stride), [pt, pl], [1, 1], 1)
        return lambda: torch.ops.quantized.conv2d.new(qx, packed, 64.0, 0)
    x16 = x.permute(0, 3, 1, 2).half()
    if (pt, pl) != (pb, pr):  # an asymmetric pad (TFLite's SAME at stride 2) goes first
        x16, pt, pl = torch.nn.functional.pad(x16, (pl, pr, pt, pb)), 0, 0
    x16 = x16.contiguous(memory_format=torch.channels_last)
    w16 = w.permute(3, 2, 0, 1).half().contiguous(memory_format=torch.channels_last)
    groups = x.shape[3] if name.startswith("qdwconv") else 1
    return lambda: torch.nn.functional.conv2d(x16, w16, stride=stride, padding=(pt, pl),
                                              groups=groups)


def kernel_impls() -> dict:
    """Kernel name -> (wrapper, plain version)."""
    from tachikoma_tpu_torch.ops.kernels import (conv, conv_direct, conv_layouts, depthwise,
                                                 flash_attention, matmul_int8, wide)

    def wide_call(conv_fn, dense_fn):
        return lambda x, w, **k: (dense_fn if w.ndim == 2 else conv_fn)(x, w, **k)

    impl = {"wide_planes": (wide_call(wide.wide_conv, wide.wide_dense),
                            wide_call(wide.wide_conv_plain, wide.wide_dense_plain)),
            "qgemm_rq": (matmul_int8.qgemm_rq, matmul_int8.qgemm_rq_plain),
            "qconv_rq": (conv.qconv_rq, conv.qconv_rq_plain),
            "qconv_rq_res": (conv.qconv_rq_res, conv.qconv_rq_res_plain),
            "qgemm_raw": (matmul_int8.qgemm_raw, matmul_int8.qgemm_raw_plain),
            "qconv_raw": (conv.qconv_raw, conv.qconv_raw_plain),
            "qdwconv_rq": (depthwise.qdwconv_rq, depthwise.qdwconv_rq_plain),
            "qdwconv_raw": (depthwise.qdwconv_raw, depthwise.qdwconv_raw_plain),
            "flash_attn": (flash_attention.flash_attention,
                           flash_attention.flash_attention_plain),
            "qconv_direct": (conv_direct.qconv_direct, conv_direct.qconv_direct_plain),
            "qdwconv_direct": (conv_direct.qdwconv_direct, conv_direct.qdwconv_direct_plain),
            "qbmm_rq": (matmul_int8.qbmm_rq, matmul_int8.qbmm_rq_plain),
            "qbmm_raw": (matmul_int8.qbmm_raw, matmul_int8.qbmm_raw_plain)}
    for name in LAYOUT_KERNELS:
        impl[name] = (getattr(conv_layouts, name), getattr(conv_layouts, f"{name}_plain"))
    return impl


def hold_call(name, a, k, impl) -> float:
    """Run one recorded call and its plain version on the same inputs, hold
    them == (allclose for K6); returns the largest |err|."""
    fn, plain = impl[name]
    got, want = fn(*a, **k), plain(*a, **k)
    torch.cuda.synchronize()
    if name == "flash_attn":
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=FA_RTOL, atol=FA_ATOL)
        return err
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    assert torch.equal(got, want), f"{name} != plain on {work(name, a, k)[2]}: max |err| {err}"
    return err


def launch_plan(name, a, k) -> str:
    """The launch of one call as its wrapper plans it: K1's and K4's GEMM
    mode's path (tiled at a tile, or skinny) and split of K, K2's tile and split of
    K, K3's tile, K4's conv-mode split, K11's path (BN and taps a step on the
    Hopper path, the chunk on the narrow one), K5's tile, K6's plan (warps a
    block, depth of Q.K^T, output columns a block, column blocks, stages;
    kg: Q and K read from global memory)."""
    from tachikoma_tpu_torch.ops.kernels import (_lib, conv, conv_direct, depthwise,
                                                 flash_attention, matmul_int8)

    x, w = a[0], a[1]
    if name in BMM_KERNELS:
        _, _, _, p = matmul_int8._bmm_launch(
            name, x, w, k.get("lhs_zero_point", 0), k.get("rhs_zero_point", 0),
            k.get("transpose_a", False), k.get("transpose_b", False), k.get("plan"))
        modes = {v: key for key, v in matmul_int8.BMM_MODES.items()}
        return (f"tile {p['bm']}x{p['bn']}, {p['bmm_nb']} products, A {modes[p['a_mode']]}, "
                f"B {modes[p['b_mode']]}")
    if name in ("qgemm_rq", "qgemm_raw"):
        p = k.get("plan") or matmul_int8.gemm_plan(x.shape[0], x.shape[1], w.shape[1],
                                                   k.get("blocks"), conv.sm_count(x.device.index))
        tile = f" {p['bm']}x{p['bn']}" if p["path"] == "tiled" else ""
        return f"{p['path']}{tile} split {p['ks']} x {p['kper']}"
    if name == "flash_attn":
        b, h, s_, d = x.shape
        p = flash_attention.fa_plan(b * h, s_, d, conv.sm_count(x.device.index))
        return (f"w {p['w']} dq {p['dq']} dv {p['dv']} cs {p['cs']} st {p['stages']}"
                f"{' kg' if p['kg'] else ''}, {p['blocks']} blocks")
    kh, kw, cin, cout = w.shape
    sh, sw = k.get("strides", (1, 1))
    pt, pl, pb, pr = k.get("padding", (0, 0, 0, 0))
    oh, ow = (x.shape[1] + pt + pb - kh) // sh + 1, (x.shape[2] + pl + pr - kw) // sw + 1
    sms = conv.sm_count(x.device.index)
    if name.startswith("qdwconv"):
        p = depthwise.dw_plan(x.shape[0], oh, ow, cout, kh, kw, sh, sw)
        return f"ct {p['ct']} tile {p['th']}x{p['tw']}, {p['blocks']} blocks"
    if name == "qconv_direct":
        plan = k.get("plan") or conv_direct.direct_plan(tuple(x.shape), tuple(w.shape),
                                                        (sh, sw), (pt, pl, pb, pr), sms)
        if plan["cc"] != conv_direct.KC:
            return f"narrow cc {plan['cc']}"
        return f"wgmma bn {plan['bn']} taps {plan['group']}"
    if name == "qconv_raw":
        ks, kper = conv.raw_split(x.shape[0] * oh * ow, cout, kh * kw * cin, sms)
        return f"split {ks} x {kper} steps"
    if name == "qconv_rq_res":
        bm, bn = _lib.tile_params(k.get("blocks")).values()
        return f"tile {bm}x{bn}"
    (bm, bn), ks, kper = conv.rq_launch(tuple(x.shape), tuple(w.shape), (sh, sw),
                                        (pt, pl, pb, pr), k.get("blocks"), sms)
    return f"tile {bm}x{bn} split {ks} x {kper}"


def check_call(name, a, k, impl) -> dict:
    """One call held against its plain version, then timed beside its bound,
    the plain version and the library call."""
    fn, plain = impl[name]
    err = hold_call(name, a, k, impl)
    nbytes, ops, label = work(name, a, k)
    rate = TF32X3_OPS_PER_S if name == "flash_attn" else INT8_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    lib = library_call(name, a, k)
    return dict(kernel=name, shape=label, bytes=nbytes, ops=ops,
                ms=graph_ms(lambda: fn(*a, **k)),
                plain_ms=eager_ms(lambda: plain(*a, **k)),
                library_ms=graph_ms(lib) if lib is not None else None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err)


def check_kernels(calls: list, names, model: str = "") -> dict:
    """Hold every recorded call of the kernels `names` against its plain
    version (== for the integer kernels, allclose for K6), time it, and sum
    per kernel; K2-K4 are printed call by call with their launch plan and
    the previous design's time on `model`'s call."""
    impl = kernel_impls()
    per_call, totals = [], {}
    for name, a, k in calls:
        per_call.append(check_call(name, a, k, impl))
        if name in PLAN_KERNELS:
            per_call[-1]["plan"] = launch_plan(name, a, k)

    def fmt(v, width, digits):
        return f"{v:{width}.{digits}f}" if v is not None else f"{'-':>{width}s}"

    for name in names:
        recs = [r for r in per_call if r["kernel"] == name]
        assert recs, f"the main path made no call of {name}"
        by_bytes = sum(r["bound_ms"] for r in recs if r["bound_by"] == "bytes")
        t = dict(calls=len(recs), max_abs_err=max(r["max_abs_err"] for r in recs),
                 bound_by="bytes" if 2 * by_bytes >= sum(r["bound_ms"] for r in recs)
                 else "operations")
        for key in ("ms", "plain_ms", "bound_ms"):
            t[key] = sum(r[key] for r in recs)
        libs = [r["library_ms"] for r in recs if r["library_ms"] is not None]
        t["library_ms"] = sum(libs) if libs else None
        t["library_calls"] = len(libs)
        totals[name] = t
        held = "within rtol 2e-5 atol 2e-6 of" if name == "flash_attn" else "=="
        phase(f"{name} ({KERNELS[name][0]}): {len(recs)} calls per forward, all {held} plain; "
              f"max |err| {t['max_abs_err']}")
        say(f"{'shape':38s} {'calls':>5s} {'ms':>9s} {'bound_ms':>9s} {'by':>10s} "
            f"{'plain_ms':>9s} {'library_ms':>10s}")
        shapes = Counter(r["shape"] for r in recs)
        for shape, count in shapes.items():
            r = next(r for r in recs if r["shape"] == shape)
            say(f"{shape:38s} {count:5d} {r['ms']:9.4f} {r['bound_ms']:9.4f} "
                f"{r['bound_by']:>10s} {r['plain_ms']:9.3f} {fmt(r['library_ms'], 10, 4)}")
        say(f"{'per forward':38s} {len(recs):5d} {t['ms']:9.4f} {t['bound_ms']:9.4f} "
            f"{t['bound_by']:>10s} {t['plain_ms']:9.3f} {fmt(t['library_ms'], 10, 4)}"
            f"  (library over {len(libs)} of {len(recs)} calls)")
        if name in PLAN_KERNELS:
            before = dict(EARLIER_CALL_MS.get((model, name), {}))
            if name == "flash_attn" and (model, name) in EARLIER_MS:  # 12 equal calls
                before = {r["shape"]: EARLIER_MS[(model, name)] / len(recs) for r in recs}
            for r in recs:
                say(f"  call {r['shape']:36s} {r['plan']:24s} {r['ms']:9.4f} ms, bound "
                    f"{r['bound_ms']:.4f}, library {fmt(r['library_ms'], 0, 4)}, before "
                    f"{fmt(before.get(r['shape']), 0, 4)}")
        if (model, name) in EARLIER_MS:
            ms = EARLIER_MS[(model, name)]
            say(f"{name} per {model} forward {t['ms']:.4f} ms; the previous design {ms:.4f} ms "
                f"({t['ms'] / ms:.3f}x); library {fmt(t['library_ms'], 0, 4)} ms")
    return totals


def profile_requests(ex, requests, median_ms: float, earlier: str | None = None) -> None:
    """Device time per request by kernel name, and the device's busy share
    of the unprofiled median latency (beside `earlier`, the tree before K5
    and K6's redesign, where given)."""
    feeds = iter(requests)
    profile_runs(lambda: ex.run_device(next(feeds)), len(requests), median_ms, "request",
                 earlier)


def profile_runs(run, n: int, median_ms: float, what: str,
                 earlier: str | None = None) -> tuple[float, float] | None:
    """`run()` n times under torch.profiler: device time per run by kernel
    name and the device's busy share of `median_ms`, the unprofiled median
    of one run.  Returns (busy ms, device operations) per run, or None when
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
            torch.cuda.synchronize()
    # device-side entries only: an operator's entry repeats the time of the
    # kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU and e.count > 0
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    if busy_ms == 0:
        say("the profiler saw no device time: device busy share not measured")
        return None
    say(f"device busy ms per {what} {busy_ms:.4f} = {busy_ms / median_ms:.1%} of the "
        f"median latency; idle {1 - busy_ms / median_ms:.1%}"
        + (f" (before K5 and K6's redesign: {earlier})" if earlier else ""))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms  "
            f"{e.count // n:4d}x  {e.key[:90]}")
    return busy_ms, sum(e.count for e in events) / n


# ---------------------------------------------------------------------------
# the trace path (phases 7 and 8)
# ---------------------------------------------------------------------------

def filesystem_type(path: str) -> str:
    """The type of the filesystem that holds `path` (tmpfs, ext4, ...), as
    `stat -f` gives it: the trace seconds depend on it."""
    out = subprocess.run(["stat", "-f", "-c", "%T", path], capture_output=True, text=True)
    return out.stdout.strip() or "unknown"


FLOAT_PRODUCTS = ("nn.matmul", "nn.dense", "nn.batch_matmul")


def float_product_cone(graph) -> set:
    """The float nodes that a float product (FLOAT_PRODUCTS) reaches through
    float nodes, the product included: cuBLAS and the CPU sum a product in
    another order, and the difference flows on to them."""
    cone: set = set()
    for n in graph.nodes:  # topological order
        if (n.dtype or "").startswith("float") and (
                n.op in FLOAT_PRODUCTS or any(i in cone for i in n.inputs)):
            cone.add(n.name)
    return cone


def compare_traces(path: str, ref_path: str, cone: set = frozenset(),
                   counts: dict | None = None) -> tuple[int, int]:
    """Hold the trace at `path` record by record against `ref_path`: same
    header, names, op ids and attrs; integer records byte-equal, float
    records allclose at FLOAT_RTOL / FLOAT_ATOL, those of the nodes in `cone`
    (`float_product_cone`) at the float transformers' GRAPH_RTOL /
    GRAPH_ATOL.  Returns (records, integer records); `counts` gets the
    number of float records that are byte-equal all the same."""
    from tachikoma_tpu_torch.trace.format import TraceReader, op_id

    with open(path, "rb") as f, open(ref_path, "rb") as g:
        got, want = TraceReader(f), TraceReader(g)
    assert got.graph_hash == want.graph_hash and len(got) == len(want) and got.meta == want.meta
    n_int = n_float_equal = 0
    for a, b in zip(got, want):
        assert (a.node_id, a.name, a.op_name, a.attrs) == (b.node_id, b.name, b.op_name, b.attrs)
        assert op_id(a.op_name) == op_id(b.op_name)
        if a.output.to_array().dtype.kind in "iu":
            assert a.encode() == b.encode(), f"trace record {a.name} differs from the CPU's"
            n_int += 1
            continue
        n_float_equal += a.encode() == b.encode()
        rtol, atol = (GRAPH_RTOL, GRAPH_ATOL) if a.name in cone else (FLOAT_RTOL, FLOAT_ATOL)
        for ta, tb in zip(a.tensors, b.tensors):
            assert ta.role == tb.role and ta.shape == tb.shape
            np.testing.assert_allclose(ta.to_array(), tb.to_array(), rtol=rtol, atol=atol,
                                       err_msg=a.name)
    if counts is not None:
        counts["float_byte_equal"] = n_float_equal
    return len(got), n_int


def hold_against_plain(names, outs, plain, graph, rtol, atol) -> int:
    """Every captured integer node == the CPU plain path, float nodes finite
    and allclose; returns the number of integer nodes."""
    n_int = 0
    for nm, a, b in zip(names, outs, plain):
        assert a.shape == b.shape and a.dtype == b.dtype, nm
        if a.dtype.kind in "iu":
            assert (a == b).all(), f"{nm} ({graph[nm].op}) != plain path"
            n_int += 1
        else:
            assert np.isfinite(a).all(), nm
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=nm)
    return n_int


def reset(names) -> None:
    from tachikoma_tpu_torch.ops.kernels import _lib

    for name in names:
        _lib.LAUNCHES[name] = 0


def read_launches(names, what: str) -> dict:
    from tachikoma_tpu_torch.ops.kernels import _lib

    launches = {name: _lib.LAUNCHES[name] for name in names}
    for name, n in launches.items():
        assert n > 0, f"{what} launched {name} no time"
    return launches


def run_path(labels, model: str, build, kernels) -> tuple[dict, dict, dict]:
    """The run path of one model, four phases titled by `labels` (3-6 for
    ResNet-50; 9a-9d for MobileNetV2): build, quantize and fuse on the host, the
    kernels at the path's shapes (== plain, timed), REQUESTS requests on the
    card, the integer nodes == the CPU plain path, the device's busy share.
    Returns the kernels' per-forward totals, their launches, and the path's
    state for phase 15 (graphs, executor, requests, the CPU outputs of the
    first request, the median latency)."""
    from tachikoma_tpu_torch.ops.kernels import matmul_int8
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    phase(f"{labels[0]} int8 {model} b{BATCH} {IMAGE}^2: build, quantize, fuse (host)")
    t0 = time.perf_counter()
    g = build(BATCH)
    rng = np.random.default_rng(SEED)
    calib = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    t1 = time.perf_counter()
    q = quantize(g, [calib])
    t2 = time.perf_counter()
    fused = fuse_qnn(q)
    t3 = time.perf_counter()
    ops = Counter(n.op for n in fused.nodes if n.op not in ("var", "const"))
    say(f"build {t1 - t0:.2f} s, calibrate+quantize {t2 - t1:.2f} s, fuse {t3 - t2:.2f} s")
    say("fused graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    names = computational_nodes(fused)
    ex = TorchExecutor(fused, capture=names, device="cuda")
    requests = [rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
                for _ in range(REQUESTS)]

    phase(f"{labels[1]} {model}: kernels at main-path shapes: == plain, time, bound, library")
    calls: list = []
    with recording(calls):
        ex.run_device(requests[0])
    torch.cuda.synchronize()
    totals = check_kernels(calls, kernels, model)

    phase(f"{labels[2]} {model} main path: {REQUESTS} requests through "
          "TorchExecutor(device='cuda')")
    packed = len(matmul_int8._KMAJOR)
    lat, first_out, launches = timed_requests(ex, requests, kernels, f"the {model} run path")
    # K1-K4 read weights packed K-major once per weight tensor: none is
    # packed again inside a request
    assert len(matmul_int8._KMAJOR) == packed, "a request packed a weight again"
    say(f"{packed} weight tensors packed K-major before the requests, none during them")
    t0 = time.perf_counter()
    plain = TorchExecutor(fused, capture=names, device="cpu").run(requests[0])
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    n_int = hold_against_plain(names, first_out, plain, fused, SOFTMAX_RTOL, SOFTMAX_ATOL)
    prob = first_out[names.index(fused.outputs[0])]
    assert prob.shape == (BATCH, 1000) and np.allclose(prob.sum(-1), 1, atol=1e-4)
    say(f"{n_int} integer nodes == plain path; float nodes within rtol {SOFTMAX_RTOL} "
        f"atol {SOFTMAX_ATOL}")
    med = say_latency(lat, BATCH)
    kernel_ms = sum(t["ms"] for t in totals.values())
    say(f"{'+'.join(kernels)} device ms per forward {kernel_ms:.4f} of {med:.3f} ms end to end")

    phase(f"{labels[3]} {model}: device time of the main path (torch.profiler, 3 requests)")
    profile_requests(ex, requests[:3], med, EARLIER_BUSY.get(model))
    state = dict(quantized=q, fused=fused, names=names, ex=ex, requests=requests, plain=plain,
                 median_ms=med)
    return totals, launches, state


def timed_requests(ex, feeds, kernels, what: str) -> tuple[list, list, dict]:
    """Each feed through ex.run_device, the kernels' counts set to 0 just
    before and read just after: the latencies (ms, host clock around the
    run and a synchronize), the first request's outputs and the launches."""
    reset(kernels)
    lat, first_out = [], None
    for x in feeds:
        t0 = time.perf_counter()
        outs = ex.run_device(x)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if first_out is None:
            first_out = [o.cpu().numpy() for o in outs]
    launches = read_launches(kernels, what)
    for name, n in launches.items():
        say(f"{name}: {n} launches, {n // len(feeds)} per forward")
    return lat, first_out, launches


def say_latency(lat: list, batch: int) -> float:
    """Print the median latency (the first request dropped) and images/s;
    returns the median."""
    med = statistics.median(lat[1:])
    say(f"latency ms per request (b{batch}): median {med:.3f}, all "
        + " ".join(f"{v:.3f}" for v in lat))
    say(f"images/s {batch / med * 1e3:.1f}")
    return med


def packed_weights() -> set:
    """The K-major packed weights held now (`kmajor_weights`' cache), by
    identity: a weight packed after this call is not in the set."""
    from tachikoma_tpu_torch.ops.kernels import matmul_int8

    return {id(v[2]) for v in matmul_int8._KMAJOR.values()}


def trace_path(labels, model: str, build, kernels, make_input=None, config=None,
               size: str = f"{IMAGE}^2", prepared=None) -> tuple[dict, dict]:
    """The trace path of one model, two phases titled by `labels` (7-8 for
    ResNet-50; 10a-10b for MobileNetV2; 17e for int8 BERT-base; 20b and 20d
    for the TFLite MobileNetV2 and W8A16 ResNet-50): the unfused b1
    forward's raw kernels == plain and timed, every integer node == the CPU
    plain path, then the trace emitted on the card, compared with the CPU's
    and verified.  `make_input(rng)` makes the calibration batch and the
    input (an image by default), `config` is the QConfig (the default one by
    default); `prepared` = (integer graph, input) skips the build and the
    quantize (an imported model).  Returns the kernels' per-forward totals
    and their launches (the trace path's run)."""
    from tachikoma_tpu_torch.ops.kernels import _lib
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.trace.emitter import TraceEmitter, verify_trace
    from tachikoma_tpu_torch.trace.native import native_verify

    phase(f"{labels[0]} trace path: {model} b{TRACE_BATCH} {size} unfused on the card")
    if make_input is None:
        def make_input(rng):
            return rng.standard_normal((TRACE_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    t0 = time.perf_counter()
    if prepared is None:
        rng = np.random.default_rng(SEED)
        calib = make_input(rng)
        q = quantize(build(TRACE_BATCH), [calib], *([config] if config is not None else []))
        x = make_input(rng)
    else:
        q, x = prepared
    names = computational_nodes(q)
    ops = Counter(q[n].op for n in names)
    if prepared is None:
        say(f"build + calibrate + quantize {time.perf_counter() - t0:.2f} s (host)")
    say(f"unfused graph: {len(names)} computational nodes: "
        + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    ex = TorchExecutor(q, capture=names, device="cuda", fuse=False)
    reset(kernels)
    calls: list = []
    with recording(calls):
        outs = [o.cpu().numpy() for o in ex.run_device(x)]
    read_launches(kernels, f"the unfused {model} forward")
    say("raw kernel calls per forward: " + ", ".join(
        f"{name} {_lib.LAUNCHES[name]}" for name in kernels)
        + f" ({ops['qnn.conv2d']} qnn.conv2d + {ops['qnn.dense']} qnn.dense + "
        f"{ops['qnn.batch_matmul']} qnn.batch_matmul)")
    # a W8A16 product is one wide_planes call and the K4 / K5 calls of its two planes
    n_wide = sum(name == "wide_planes" for name, _, _ in calls)
    assert len(calls) == (ops["qnn.conv2d"] + ops["qnn.dense"] + ops["qnn.batch_matmul"]
                          + 2 * n_wide)
    totals = check_kernels(calls, kernels, model)
    plain = TorchExecutor(q, capture=names, device="cpu", fuse=False).run(x)
    n_int = hold_against_plain(names, outs, plain, q, FLOAT_RTOL, FLOAT_ATOL)
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path; "
        f"float nodes within rtol {FLOAT_RTOL} atol {FLOAT_ATOL}")

    phase(f"{labels[1]} {model} trace emission: TraceEmitter(backend='torch', "
          f"device='cuda').emit_to, 1 warm + {TRACE_TIMED} timed")
    tdir = tempfile.gettempdir()
    path = os.path.join(tdir, f"tk_chip_smoke_{os.getpid()}.bin")
    ref_path = os.path.join(tdir, f"tk_chip_smoke_{os.getpid()}_cpu.bin")
    meta = {"model": f"{model.lower().replace('-', '')}_b{TRACE_BATCH}_{size.split('^')[0]}"}
    try:
        em = TraceEmitter(q, backend="torch", device="cuda", meta=meta)
        reset(kernels)
        n_records = em.emit_to(x, path)
        packed = packed_weights()
        times, timings = [], []
        for _ in range(TRACE_TIMED):
            t0 = time.perf_counter()
            em.emit_to(x, path)
            times.append(time.perf_counter() - t0)
            timings.append(dict(em.last_timings))
        launches = read_launches(kernels, f"the {model} trace path")
        for name, n in launches.items():
            say(f"{name}: {n} launches in {TRACE_TIMED + 1} traces")
        # K4 reads weights packed K-major once per weight tensor: the warm
        # call packed them, the timed calls pack none
        again = packed_weights() - packed
        assert not again, f"the timed traces packed {len(again)} weights K-major"
        say(f"{len(packed)} weight tensors packed K-major by the warm trace, none during the "
            f"{TRACE_TIMED} timed traces")
        nbytes = os.path.getsize(path)
        med = statistics.median(times)

        def median_of(key):
            return statistics.median(t[key] for t in timings)

        say(f"trace dir {tdir} ({filesystem_type(tdir)}); writer {timings[-1]['writer']}")
        say(f"records {n_records}, bytes {nbytes}, fetched bytes {timings[-1]['fetched_bytes']}")
        say(f"median s: trace {med:.4f}, dispatch {median_of('dispatch_s'):.4f}, "
            f"fetch wait {median_of('fetch_s'):.4f}, serialize {median_of('serialize_s'):.4f}")
        say("trace s, all: " + " ".join(f"{v:.4f}" for v in times))
        say(f"records/s {n_records / med:.1f}, traces/s {1 / med:.3f}, "
            f"MB/s {nbytes / med / 1e6:.1f}")
        say("last trace, per group: fetch wait s "
            + " ".join(f"{v:.4f}" for v in timings[-1]["group_waits"]) + "; walk s "
            + " ".join(f"{v:.4f}" for v in timings[-1]["group_walks"]))

        t0 = time.perf_counter()
        TraceEmitter(q, backend="torch", device="cpu", meta=meta).emit_to(x, ref_path)
        t1 = time.perf_counter()
        n, n_int = compare_traces(path, ref_path)
        say(f"CPU plain trace {t1 - t0:.2f} s; card trace == CPU trace: {n} records, "
            f"{n_int} integer byte-equal, {n - n_int} float within rtol {FLOAT_RTOL} "
            f"atol {FLOAT_ATOL} ({time.perf_counter() - t1:.2f} s)")
        assert native_verify(path) == n_records
        t0 = time.perf_counter()
        res = verify_trace(path, q)
        assert res["verified"] == res["records"] == n_records, res["mismatches"][:5]
        say(f"CRCs ok (native); verify_trace: {res['verified']}/{res['records']} records "
            f"verified by the numpy oracle in {time.perf_counter() - t0:.2f} s")
    finally:
        for p in (path, ref_path):
            if os.path.exists(p):
                os.unlink(p)
    return totals, launches


def fixture_path() -> dict:
    """Phase 11: the trained MobileNetV2 fixture on the card; returns K5's
    launches in its run."""
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.artifact import load_artifact
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    phase(f"11. trained fixture {FIXTURE}: load_artifact, quantize, fuse, run on the card")
    t0 = time.perf_counter()
    g, manifest = load_artifact(FIXTURE)
    shape = tuple(g.inputs[0].shape)
    rng = np.random.default_rng(SEED)
    calib = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    fused = fuse_qnn(quantize(g, [calib]))
    names = computational_nodes(fused)
    dw = sum(fused[n].op == "tk.conv2d_rq" and fused[n].attrs.get("groups", 1) > 1
             for n in names)
    say(f"{manifest['name']}: input {shape} (NCHW), {len(names)} fused nodes, {dw} depthwise; "
        f"load + quantize + fuse {time.perf_counter() - t0:.2f} s (host)")
    ex = TorchExecutor(fused, capture=names, device="cuda")
    reset(("qdwconv_rq",))
    outs = [o.cpu().numpy() for o in ex.run_device(x)]
    launches = read_launches(("qdwconv_rq",), "the fixture's forward")
    assert launches["qdwconv_rq"] == dw
    plain = TorchExecutor(fused, capture=names, device="cpu").run(x)
    n_int = hold_against_plain(names, outs, plain, fused, FLOAT_RTOL, FLOAT_ATOL)
    out = names.index(fused.outputs[0])
    agree = int((outs[out].argmax(-1) == plain[out].argmax(-1)).sum())
    say(f"qdwconv_rq: {launches['qdwconv_rq']} launches; {n_int} of {len(names)} nodes are "
        f"integer and == the CPU plain path; logits {outs[out].shape}, argmax agrees with "
        f"the CPU's on {agree} of {shape[0]}")
    return launches


# ---------------------------------------------------------------------------
# the float transformer path (phases 12-14)
# ---------------------------------------------------------------------------

def transformer_path(label: str, model: str, build, make_input, causal: bool,
                     unit: str) -> tuple[dict, int]:
    """Phases <label>a-d of one float transformer: build and fuse_attention,
    K6 at the forward's 12 calls (allclose plain, timed), REQUESTS requests on
    the card with K6 counted, the logits and tk.attention outputs against the
    CPU path, the device's busy share.  Returns K6's per-forward totals and
    its launches in the requests."""
    from tachikoma_tpu_torch.ir.transforms import fuse_attention
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    phase(f"{label}a. float {model}: build, fuse_attention (host)")
    t0 = time.perf_counter()
    g = build()
    t1 = time.perf_counter()
    fused = fuse_attention(g)
    t2 = time.perf_counter()
    attn = [n for n in fused.nodes if n.op == "tk.attention"]
    assert len(attn) == 12, len(attn)
    assert all(bool(n.attrs["causal"]) == causal for n in attn)
    n_params = sum(v.size for v in fused.params.values())
    say(f"build {t1 - t0:.2f} s, fuse_attention {t2 - t1:.2f} s: {len(g)} -> {len(fused)} "
        f"nodes, 12 tk.attention (causal {causal}), q {fused[attn[0].inputs[0]].shape}, "
        f"{n_params} params")
    names = [n.name for n in attn] + list(fused.outputs)
    ex = TorchExecutor(fused, capture=names, device="cuda")
    rng = np.random.default_rng(SEED)
    requests = [make_input(rng) for _ in range(REQUESTS)]
    batch = requests[0].shape[0]

    phase(f"{label}b. {model}: K6 at the forward's calls: allclose plain, time, bound, SDPA")
    calls: list = []
    with recording(calls):
        ex.run_device(requests[0])
    torch.cuda.synchronize()
    assert [c[0] for c in calls] == ["flash_attn"] * 12
    assert not any(t.is_contiguous() for t in calls[0][1]), "the head split hands over views"
    totals = check_kernels(calls, ("flash_attn",), model)["flash_attn"]

    phase(f"{label}c. {model} main path: {REQUESTS} requests through "
          "TorchExecutor(device='cuda')")
    from tachikoma_tpu_torch.ops.kernels.flash_attention import COPIES

    reset(("flash_attn",))
    COPIES["flash_attn"] = 0
    lat = []
    first_out = None
    for x in requests:
        t0 = time.perf_counter()
        outs = ex.run_device(x)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if first_out is None:
            first_out = [o.cpu().numpy() for o in outs]
    launches = read_launches(("flash_attn",), f"the {model} path")["flash_attn"]
    assert launches == 12 * REQUESTS, launches
    assert COPIES["flash_attn"] == 0, f"the wrapper copied q, k or v {COPIES['flash_attn']} times"
    say(f"flash_attn: {launches} launches, {launches // REQUESTS} per request; q, k and v read "
        f"in place (the wrapper's copies: {COPIES['flash_attn']})")
    t0 = time.perf_counter()
    plain = TorchExecutor(fused, capture=names, device="cpu").run(requests[0])
    say(f"CPU path forward {time.perf_counter() - t0:.2f} s; card vs CPU, largest |err| "
        f"(rtol {GRAPH_RTOL} atol {GRAPH_ATOL}):")
    for nm, a, b in zip(names, first_out, plain):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, nm
        assert np.isfinite(a).all(), nm
        say(f"  {nm:28s} {tuple(a.shape)!s:22s} max |err| {np.abs(a - b).max():.3e}, "
            f"max |CPU| {np.abs(b).max():.3e}")
    for nm, a, b in zip(names, first_out, plain):
        np.testing.assert_allclose(a, b, rtol=GRAPH_RTOL, atol=GRAPH_ATOL, err_msg=nm)
    med = statistics.median(lat[1:])
    say(f"latency ms per request (b{batch}): median {med:.3f}, all "
        + " ".join(f"{v:.3f}" for v in lat))
    say(f"{unit}/s {batch / med * 1e3:.1f}; K6 device ms per forward {totals['ms']:.4f} of "
        f"{med:.3f} ms end to end")

    phase(f"{label}d. {model}: device time of the main path (torch.profiler, 3 requests)")
    profile_requests(ex, requests[:3], med, EARLIER_BUSY.get(model))
    return totals, launches


def k6_reference_shapes() -> float:
    """Phase 12e: K6 at tests/test_flash_attention.py's four shapes against
    its plain version; returns the largest |err|."""
    from tachikoma_tpu_torch.ops.kernels.flash_attention import (flash_attention,
                                                                 flash_attention_plain)

    phase("12e. K6 at tests/test_flash_attention.py's four shapes and at D = 32 to 320: "
          "allclose plain")
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for b, h, s, d, causal in FA_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).cuda()
                   for _ in range(3))
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=FA_RTOL, atol=FA_ATOL)
        worst = max(worst, err)
        say(f"B={b} H={h} S={s} D={d} causal={causal}: max |err| {err:.3e}, plan "
            f"{launch_plan('flash_attn', (q, k, v), {})}")
    return worst


# ---------------------------------------------------------------------------
# the tuning path (phase 15)
# ---------------------------------------------------------------------------

def s2_workloads(fused, k: int = 3) -> list[str]:
    """The tuning-database keys of the fused graph's k x k stride-2 convs (k
    3: the three 3x3 s2; k 7: the stem)."""
    from tachikoma_tpu_torch.ops.kernels.conv import flat_conv_workload
    from tachikoma_tpu_torch.ops.nn import _pair

    keys = []
    for n in fused.nodes:
        if n.op == "tk.conv2d_rq":
            x, w = fused[n.inputs[0]].shape, fused[n.inputs[1]].shape
            strides = _pair(tuple(n.attrs.get("strides", (1, 1))))
            if tuple(w[:2]) == (k, k) and strides == (2, 2):
                keys.append(flat_conv_workload(*x, w[3], k, k, strides, True))
    return keys


def forced_calls(ex, x, workloads, name: str) -> list:
    """The calls of `name` in one forward of `ex` under a database forcing
    its layout on `workloads`."""
    from tachikoma_tpu_torch.tune.database import apply_history_best

    calls: list = []
    with apply_history_best(forced_database(workloads, name)), recording(calls):
        ex.run_device(x)
    torch.cuda.synchronize()
    return [c for c in calls if c[0] == name]


def wrapper_work_ms(calls) -> float:
    """Host-clock ms per forward of a layout kernel's wrapper work besides the
    launch (conv_layouts.layout_operands: the packed-weight lookup, the bias
    fold where izp != 0, the output's allocation), summed over `calls`, each
    the mean of WRAPPER_CALLS calls ending in a synchronize."""
    from tachikoma_tpu_torch.ops.kernels.conv_layouts import flat_geometry, layout_operands

    total = 0.0
    for _, a, k in calls:
        g = flat_geometry(a[0].shape, a[1].shape, k["strides"], k["padding"])
        layout_operands(a[0], a[1], a[2], k["izp"], g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WRAPPER_CALLS):
            layout_operands(a[0], a[1], a[2], k["izp"], g)
        torch.cuda.synchronize()
        total += (time.perf_counter() - t0) * 1e3 / WRAPPER_CALLS
    return total


def forced_database(workloads, layout: str):
    """A database whose only records force `layout` at FORCED_BLOCKS."""
    from tachikoma_tpu_torch.tune.database import TuneDatabase, TuneRecord

    db = TuneDatabase()
    for wl in workloads:
        db.add(TuneRecord(wl, {"blocks": FORCED_BLOCKS, "layout": layout[-1]}, 0.0))
    return db


def counted_requests(ex, requests, kernels) -> tuple[dict, list]:
    """Run `requests` with the launch counts of `kernels` set to 0 just before
    and read just after; returns the counts and the first request's outputs."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    reset(kernels)
    first = None
    for x in requests:
        outs = ex.run_device(x)
        torch.cuda.synchronize()
        if first is None:
            first = [o.cpu().numpy() for o in outs]
    return {name: _lib.LAUNCHES[name] for name in kernels}, first


def tune_path(state) -> tuple[dict, dict]:
    """Phases 15a-15c: tune ResNet-50 b8 on the card through the CLI, K7-K10
    at the forward's shapes, the forward under the tuned database and under a
    database that forces each layout.  Returns K7-K10's per-forward totals and
    the launches of every kernel in the counted runs."""
    from tachikoma_tpu_torch import cli
    from tachikoma_tpu_torch.tune.database import (NO_ERROR, RUNTIME_ERROR, TuneDatabase,
                                                   apply_history_best)

    fused, names, ex = state["fused"], state["names"], state["ex"]
    requests, plain = state["requests"], state["plain"]
    impl = kernel_impls()
    kernels = RUN_KERNELS + LAYOUT_KERNELS
    wls = s2_workloads(fused)
    assert len(wls) == 3, wls

    phase(f"15a. tune: int8 ResNet-50 b{BATCH} {IMAGE}^2 fused, `tachikoma_tpu_torch.cli tune "
          f"--budget {TUNE_BUDGET}` on the card")
    tdir = tempfile.mkdtemp(prefix="tk_chip_smoke_tune_")
    try:
        gpath, db_path = os.path.join(tdir, "r50.json"), os.path.join(tdir, "h100.jsonl")
        with open(gpath, "w") as f:
            f.write(state["quantized"].to_json())
        t0 = time.perf_counter()
        cli.main(["tune", gpath, "--db", db_path, "--budget", str(TUNE_BUDGET)])
        say(f"tune seconds {time.perf_counter() - t0:.1f} (host clock, task set-up included)")
        db = TuneDatabase(db_path)
    finally:
        for p in os.listdir(tdir):
            os.unlink(os.path.join(tdir, p))
        os.rmdir(tdir)
    assert len(db) == TUNE_BUDGET, len(db)
    bad = [(r.workload, r.config, r.error_no, r.error_msg[-300:]) for r in db.records
           if r.error_no != NO_ERROR
           and not (r.error_no == RUNTIME_ERROR and r.config == {"impl": "xla"})]
    assert not bad, bad
    say(f"{'workload':66s} {'trials':>6s} {'failed':>6s}  best")
    for wl in dict.fromkeys(r.workload for r in db.records):
        recs = [r for r in db.records if r.workload == wl]
        best = db.best(wl)
        shown = (f"{best.config} {best.time_ms * 1e3:.2f} us, {best.meta.get('tops')} TOP/s"
                 if best else "none")
        say(f"{wl[:66]:66s} {len(recs):6d} {sum(r.error_no != NO_ERROR for r in recs):6d}  "
            f"{shown}")

    phase("15b. K7-K10 at the forward's three 3x3 s2 calls (each layout forced at "
          f"{FORCED_BLOCKS}), K2 on the same calls, the stem, and a chain stage: == plain, "
          "time, bound, library")
    totals, errs = {}, {}
    k2_ms = None
    for name in LAYOUT_KERNELS:
        calls = forced_calls(ex, requests[0], wls, name)
        assert len(calls) == 3, (name, len(calls))
        totals.update(check_kernels(calls, (name,)))
        errs[name] = totals[name]["max_abs_err"]
        if k2_ms is None:  # K2 at the same tile on the same three calls
            for _, a, k in calls:
                hold_call("qconv_rq", a, k, impl)
            k2_ms = sum(graph_ms(lambda a=a, k=k: impl["qconv_rq"][0](*a, **k))
                        for _, a, k in calls)
        work_ms = wrapper_work_ms(calls)
        say(f"{name}: the wrapper's own work per forward (host clock, {WRAPPER_CALLS} calls "
            f"each; packed-weight lookup, bias fold at izp "
            f"{sorted({k['izp'] for _, _, k in calls})}, output allocation) {work_ms:.4f} ms; "
            "no operand build")
    say(f"\nper ResNet-50 b{BATCH} forward, the three 3x3 s2 calls at {FORCED_BLOCKS} (ms; "
        f"{state['card']}):")
    say(f"{'kernel':12s} {'ms':>9s} {'bound_ms':>9s} {'plain_ms':>9s} {'cuDNN int8':>10s} "
        f"{'K2 same calls':>13s} {'/ K2':>6s}")
    for name in LAYOUT_KERNELS:
        t = totals[name]
        say(f"{name:12s} {t['ms']:9.4f} {t['bound_ms']:9.4f} {t['plain_ms']:9.3f} "
            f"{t['library_ms']:10.4f} {k2_ms:13.4f} {t['ms'] / k2_ms:6.2f}")

    stem = s2_workloads(fused, 7)
    assert len(stem) == 1, stem
    phase(f"15b. the stem (7x7 s2, CIN 3), each layout forced at {FORCED_BLOCKS}: == plain, "
          "time, bound, library, beside K2")
    say(f"{'kernel':12s} {'ms':>9s} {'bound_ms':>9s} {'by':>10s} {'plain_ms':>9s} "
        f"{'library_ms':>10s}  (library: cuDNN int8, CIN padded to 4)")
    for name in LAYOUT_KERNELS:
        (_, a, k), = forced_calls(ex, requests[0], stem, name)
        for kernel in (("qconv_rq", name) if name == LAYOUT_KERNELS[0] else (name,)):
            r = check_call(kernel, a, k, impl)
            errs[kernel] = max(errs.get(kernel, 0), r["max_abs_err"])
            say(f"{kernel:12s} {r['ms']:9.4f} {r['bound_ms']:9.4f} {r['bound_by']:>10s} "
                f"{r['plain_ms']:9.3f} {r['library_ms']:10.4f}")

    shape, wshape, strides, padding = CHAIN_STAGE
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).cuda()
    w = torch.from_numpy(rng.integers(-127, 128, wshape).astype(np.int8)).cuda()
    bias = torch.from_numpy(rng.integers(-5000, 5000, wshape[3]).astype(np.int32)).cuda()
    from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize

    mult, shift = plan_requantize(0.002 * (0.5 + rng.random(wshape[3])), 1.0)
    args = (x, w, bias, channel_vector(mult, wshape[3], "cuda"),
            channel_vector(shift, wshape[3], "cuda"))
    kw = dict(strides=strides, padding=padding, blocks=tuple(FORCED_BLOCKS))
    phase(f"15b. chain stage {shape} * {wshape} s1 at {FORCED_BLOCKS}: == plain, time, bound")
    say(f"{'kernel':12s} {'ms':>9s} {'bound_ms':>9s} {'by':>10s} {'plain_ms':>9s} "
        f"{'library_ms':>10s}  (library: fp16 cuDNN for K2, int8 cuDNN for K7-K10)")
    for name in ("qconv_rq",) + LAYOUT_KERNELS:
        r = check_call(name, args, kw, impl)
        errs[name] = max(errs.get(name, 0), r["max_abs_err"])
        say(f"{name:12s} {r['ms']:9.4f} {r['bound_ms']:9.4f} {r['bound_by']:>10s} "
            f"{r['plain_ms']:9.3f} {r['library_ms']:10.4f}")

    phase(f"15c. the forward under the tuned database, then with each layout forced on the "
          f"three 3x3 s2 convs: every integer node == the CPU path")
    launches = Counter()
    with apply_history_best(db):
        calls = []
        with recording(calls):
            ex.run_device(requests[0])
        for name, a, k in calls:
            if name in kernels:
                hold_call(name, a, k, impl)
        counts, first = counted_requests(ex, requests[:TUNED_REQUESTS], kernels)
    n_int = hold_against_plain(names, first, plain, fused, SOFTMAX_RTOL, SOFTMAX_ATOL)
    for name in RUN_KERNELS:
        assert counts[name] > 0, f"the tuned forward launched {name} no time"
    launches.update(counts)
    say(f"tuned: {len(calls)} kernel calls of one forward == plain; {n_int} integer nodes == "
        f"the CPU path; launches in {TUNED_REQUESTS} requests: "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    for name in LAYOUT_KERNELS:
        with apply_history_best(forced_database(wls, name)):
            counts, first = counted_requests(ex, requests[:FORCED_REQUESTS], kernels)
        hold_against_plain(names, first, plain, fused, SOFTMAX_RTOL, SOFTMAX_ATOL)
        assert counts[name] == 3 * FORCED_REQUESTS, (name, counts)
        launches.update(counts)
        say(f"{name} forced: launches in {FORCED_REQUESTS} requests: "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
            + f"; {n_int} integer nodes == the CPU path")
    lat = {"untuned": [], "tuned": []}
    for x in requests[:TUNED_REQUESTS]:
        for key in lat:
            with apply_history_best(db) if key == "tuned" else contextlib.nullcontext():
                t0 = time.perf_counter()
                ex.run_device(x)
                torch.cuda.synchronize()
                lat[key].append((time.perf_counter() - t0) * 1e3)
    for key, v in lat.items():
        say(f"{key:8s} latency ms (b{BATCH}, {TUNED_REQUESTS} requests in turns): median "
            f"{statistics.median(v):.3f}, all " + " ".join(f"{t:.3f}" for t in v))
    for name in LAYOUT_KERNELS:
        totals[name]["max_abs_err"] = errs[name]
    return totals, dict(launches)


# ---------------------------------------------------------------------------
# the direct-conv tuning path (phase 16)
# ---------------------------------------------------------------------------

def conv_calls(state) -> Counter:
    """(x shape, w shape, strides, padding, groups) of every conv call of one
    forward of the state's executor, with its count: the tk.conv2d_rq calls
    of qconv2d_flat and the chain and stack stages."""
    from tachikoma_tpu_torch.ops.kernels import conv
    from tachikoma_tpu_torch.runtime import fuse

    calls = Counter()
    real_stage, real_flat = conv._stage, fuse.qconv2d_flat

    def stage(cur, st, *a, **k):
        calls[(tuple(cur.shape), tuple(st["w"].shape), (1, 1), tuple(st["padding"]), 1)] += 1
        return real_stage(cur, st, *a, **k)

    def flat(x, w, *a, strides=(1, 1), padding=(0, 0, 0, 0), groups=1, **k):
        calls[(tuple(x.shape), tuple(w.shape), tuple(strides), tuple(padding), int(groups))] += 1
        return real_flat(x, w, *a, strides=strides, padding=padding, groups=groups, **k)

    conv._stage, fuse.qconv2d_flat = stage, flat
    try:
        state["ex"].run_device(state["requests"][0])
        torch.cuda.synchronize()
    finally:
        conv._stage, fuse.qconv2d_flat = real_stage, real_flat
    return calls


def direct_path(vgg_state, r50_state, mbv2_state) -> tuple[dict, dict]:
    """Phase 16b: tune_conv on the card over the conv workloads of VGG-16 b8
    (all 13 calls), ResNet-50 b8 (its groups-1 convs) and MobileNetV2 b8
    (its 17 depthwise convs), with K11 / K12's launches counted from 0; then
    each workload's kernel == plain and timed beside its bound, its plain
    version, the library call, the forward's own route (qconv2d_flat: K1
    for a 1x1, K2, K5 for a depthwise conv), whose output it must equal, and
    the previous design; a CIN-3 conv also on K11's other path.
    Returns K11's totals per VGG-16 forward and K12's per MobileNetV2
    forward, and their launches in the tune_conv run."""
    from tachikoma_tpu_torch.ops.kernels import conv, conv_direct
    from tachikoma_tpu_torch.ops.kernels.conv import qconv2d_flat
    from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize
    from tachikoma_tpu_torch.tune.database import NO_ERROR, TuneDatabase
    from tachikoma_tpu_torch.tune.tuner import conv_workload, tune_conv

    models = {"VGG-16": conv_calls(vgg_state),
              "ResNet-50": Counter({k: v for k, v in conv_calls(r50_state).items() if k[4] == 1}),
              "MobileNetV2": Counter({k: v for k, v in conv_calls(mbv2_state).items()
                                      if k[4] > 1})}
    assert sum(models["VGG-16"].values()) == VGG_CONVS
    assert len(models["VGG-16"]) == VGG_CONV_WORKLOADS, models["VGG-16"]
    assert sum(models["MobileNetV2"].values()) == MBV2_DW_CONVS
    keys = list(dict.fromkeys(k for calls in models.values() for k in calls))
    phase(f"16b. tune_conv on the card: {len(keys)} distinct conv workloads ("
          + ", ".join(f"{m} {len(c)} of {sum(c.values())} calls" for m, c in models.items())
          + "), K11 qconv_direct / K12 qdwconv_direct")
    tdir = tempfile.mkdtemp(prefix="tk_chip_smoke_direct_")
    try:
        path = os.path.join(tdir, "direct.jsonl")
        db = TuneDatabase(path)
        reset(DIRECT_KERNELS)
        t0 = time.perf_counter()
        for shape, wshape, strides, padding, groups in keys:
            tune_conv(shape, wshape, strides, padding, groups, db, verbose=False)
        launches = read_launches(DIRECT_KERNELS, "tune_conv")
        say(f"tune_conv seconds {time.perf_counter() - t0:.1f} (host clock, inputs and plain "
            f"references on the card included); launches: "
            + ", ".join(f"{k} {v}" for k, v in launches.items()))
        with open(path) as f:
            lines = len(f.read().splitlines())
    finally:
        for p in os.listdir(tdir):
            os.unlink(os.path.join(tdir, p))
        os.rmdir(tdir)
    bad = [(r.workload, r.error_no, r.error_msg[-300:]) for r in db.records
           if r.error_no != NO_ERROR]
    assert not bad, bad
    assert len(db) == lines == len(keys)
    say(f"{len(db)} records, every trial == plain before it was timed: no WRONG_ANSWER, "
        "no unsupported")

    impl = kernel_impls()
    rng = np.random.default_rng(SEED)
    rows = {}
    for key in keys:
        shape, wshape, strides, padding, groups = key
        name = "qconv_direct" if groups == 1 else "qdwconv_direct"
        cout = wshape[3]
        x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-127, 128, wshape).astype(np.int8)).cuda()
        bias = torch.from_numpy(rng.integers(-5000, 5000, cout).astype(np.int32)).cuda()
        mult, shift = plan_requantize(0.002 * (0.5 + rng.random(cout)), 1.0)
        args = (x, w, bias, channel_vector(mult, cout, "cuda"), channel_vector(shift, cout, "cuda"))
        kw = dict(strides=strides, padding=padding)
        r = check_call(name, args, kw, impl)
        r["plan"] = launch_plan(name, args, kw)

        def route(x=x, w=w, bias=bias, mult=mult, shift=shift, key=key):
            return qconv2d_flat(x, w, bias, mult, shift, strides=key[2], padding=key[3],
                                groups=key[4])

        assert torch.equal(route(), impl[name][0](*args, **kw)), f"{name} != the forward's route"
        r["route"] = "K5" if groups > 1 else ("K1" if wshape[:2] == (1, 1) else "K2")
        r["route_ms"] = graph_ms(route)
        r["tune_ms"] = db.best(conv_workload(*shape, cout, *wshape[:2], strides, groups)).time_ms
        narrow = conv_direct.narrow_chunk(shape[3], *wshape[:2], strides)
        if groups == 1 and shape[3] < conv_direct.NARROW_CIN and narrow is not None:
            # a narrow CIN: K11's other path on the same call, == plain, timed
            own = conv_direct.direct_plan(shape, wshape, strides, padding,
                                          conv.sm_count(x.device.index))
            other = ({"cc": narrow} if own["cc"] == conv_direct.KC else
                     conv_direct.hopper_plan(shape, wshape, strides, padding,
                                             conv.sm_count(x.device.index)))
            ok = dict(kw, plan=other)
            r["other_err"] = hold_call(name, args, ok, impl)
            r["other_ms"] = graph_ms(lambda a=args, k=ok: impl[name][0](*a, **k))
            r["other_plan"] = launch_plan(name, args, ok)
        rows[key] = r

    def fmt(v, width, digits):
        return f"{v:{width}.{digits}f}" if v is not None else f"{'-':>{width}s}"

    totals = {}
    for model, calls in models.items():
        name = "qdwconv_direct" if model == "MobileNetV2" else "qconv_direct"
        before = EARLIER_CALL_MS.get((model, name), {})
        say(f"\n{model}: {name} per call (ms; route = the forward's own kernel on the same "
            "call; before = the previous design)")
        say(f"{'shape':34s} {'n':>2s} {'plan':22s} {'ms':>8s} {'tune_ms':>8s} {'bound_ms':>8s} "
            f"{'by':>10s} {'plain_ms':>8s} {'library':>8s} {'route':>5s} {'route_ms':>8s} "
            f"{'before':>8s}")
        for key, count in calls.items():
            r = rows[key]
            say(f"{r['shape']:34s} {count:2d} {r['plan']:22s} {r['ms']:8.4f} {r['tune_ms']:8.4f} "
                f"{r['bound_ms']:8.4f} {r['bound_by']:>10s} {r['plain_ms']:8.3f} "
                f"{fmt(r['library_ms'], 8, 4)} {r['route']:>5s} {r['route_ms']:8.4f} "
                f"{fmt(before.get(r['shape']), 8, 4)}")
            if "other_ms" in r:
                say(f"  {'':32s}    {r['other_plan']:22s} {r['other_ms']:8.4f}  (K11's other "
                    "path on the same call, == plain)")
        t = {k: sum(rows[key][k] * n for key, n in calls.items())
             for k in ("ms", "plain_ms", "bound_ms", "route_ms")}
        libs = [(rows[key]["library_ms"], n) for key, n in calls.items()
                if rows[key]["library_ms"] is not None]
        t["library_ms"] = sum(v * n for v, n in libs) if libs else None
        by_bytes = sum(rows[key]["bound_ms"] * n for key, n in calls.items()
                       if rows[key]["bound_by"] == "bytes")
        t["bound_by"] = "bytes" if 2 * by_bytes >= t["bound_ms"] else "operations"
        t["max_abs_err"] = max(max(rows[key]["max_abs_err"], rows[key].get("other_err", 0))
                               for key in calls)
        n_calls = sum(calls.values())
        say(f"{'per forward':34s} {n_calls:2d} {t['ms']:8.4f} {'':8s} {t['bound_ms']:8.4f} "
            f"{t['bound_by']:>10s} {t['plain_ms']:8.3f} {fmt(t['library_ms'], 8, 4)} "
            f"{'':5s} {t['route_ms']:8.4f}  (library over {sum(n for _, n in libs)} of "
            f"{n_calls} calls; {name} / route {t['ms'] / t['route_ms']:.2f}x)")
        if (model, name) in EARLIER_MS:
            ms = EARLIER_MS[(model, name)]
            say(f"{name} per {model} forward {t['ms']:.4f} ms; the previous design {ms:.4f} ms "
                f"({t['ms'] / ms:.3f}x)")
        if model != "ResNet-50":
            totals[name] = t
    return totals, launches


def graph_tune_path(state) -> dict:
    """Phase 16c: tune_graph over VGG-16 b8's quantized graph, all five chain
    runs flipped in turn.  The measurer runs GRAPH_TUNE_REQUESTS counted
    requests of TorchExecutor on the variant as handed over (not fused
    again), holds every integer node of the first == the CPU plain path of
    phase 16a, and returns the median latency of the others.  Returns the
    launches in the variants' counted requests."""
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor
    from tachikoma_tpu_torch.tune.database import TuneDatabase
    from tachikoma_tpu_torch.tune.graph_tuner import chain_runs, tune_graph

    q, fused, names = state["quantized"], state["fused"], state["names"]
    requests, plain = state["requests"][:GRAPH_TUNE_REQUESTS], state["plain"]
    runs = chain_runs(fused)
    assert len(runs) == 5, runs
    phase(f"16c. tune_graph over VGG-16 b{BATCH}'s {len(runs)} chain runs ({', '.join(runs)}): "
          f"median of {GRAPH_TUNE_REQUESTS - 1} counted requests per variant")
    launches = Counter()

    def measure(g):
        ex = TorchExecutor(g, capture=names, device="cuda")
        assert ex.graph is g, "the executor fused the variant again"
        chains = [n for n in g.nodes if n.op == "tk.conv2d_chain"]
        split = [n for n in g.nodes if n.op == "tk.conv2d_rq"]
        assert sum(len(n.attrs["stages"]) for n in chains) + len(split) == VGG_CONVS
        counts, first = counted_requests(ex, requests, VGG_RUN_KERNELS)
        assert counts == {"qconv_rq": VGG_CONVS * len(requests),
                          "qgemm_rq": 3 * len(requests)}, counts
        launches.update(counts)
        n_int = hold_against_plain(names, first, plain, g, SOFTMAX_RTOL, SOFTMAX_ATOL)
        lat = []
        for x in requests[1:]:
            t0 = time.perf_counter()
            ex.run_device(x)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        say(f"  variant: {len(chains)} chains + {len(split)} split convs; {n_int} integer nodes "
            f"== the CPU path; ms " + " ".join(f"{v:.3f}" for v in lat))
        return statistics.median(lat) / 1e3

    tdir = tempfile.mkdtemp(prefix="tk_chip_smoke_graph_")
    try:
        db = TuneDatabase(os.path.join(tdir, "graph.jsonl"))
        t0 = time.perf_counter()
        res = tune_graph(q, measure, db=db)
        seconds = time.perf_counter() - t0
    finally:
        for p in os.listdir(tdir):
            os.unlink(os.path.join(tdir, p))
        os.rmdir(tdir)
    assert res.trials == len(runs) + 1 and len(db) == res.trials
    say(f"baseline {res.baseline_time_s * 1e3:.3f} ms, best {res.best_time_s * 1e3:.3f} ms with "
        f"disabled {res.best_disabled}, {res.trials} trials, {seconds:.1f} s (host clock); "
        f"records under {db.records[0].workload}")
    return dict(launches)


# ---------------------------------------------------------------------------
# the int8 transformers (phase 17)
# ---------------------------------------------------------------------------

def bert_ids(batch: int):
    def make(rng):
        return rng.integers(0, 30522, (batch, SEQ)).astype(np.int32)

    return make


def int8_bert_path() -> tuple[dict, dict]:
    """Phases 17a-d: int8 BERT-base b4 s128 (TRANSFORMER_INT8) quantized and
    fused on the host, K1, K4 and qbmm_rq at the forward's calls (== plain,
    timed), REQUESTS requests on the card with the kernels counted, every
    integer node == the CPU path, the device's busy share.  Returns the
    kernels' per-forward totals and their launches in the requests."""
    from tachikoma_tpu_torch.models.transformer import bert_base
    from tachikoma_tpu_torch.ops.kernels import matmul_int8
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    model = f"int8 BERT-base b{BERT_BATCH} s{SEQ}"
    phase(f"17a. {model}: build, quantize (TRANSFORMER_INT8), fuse (host)")
    make = bert_ids(BERT_BATCH)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    g = bert_base(batch_size=BERT_BATCH, seq_len=SEQ, seed=SEED)
    t1 = time.perf_counter()
    q = quantize(g, [make(rng)], TRANSFORMER_INT8)
    t2 = time.perf_counter()
    fused = fuse_qnn(q)
    t3 = time.perf_counter()
    ops = Counter(n.op for n in fused.nodes if n.op not in ("var", "const"))
    say(f"build {t1 - t0:.2f} s, calibrate+quantize {t2 - t1:.2f} s, fuse {t3 - t2:.2f} s")
    say("fused graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    for op, n in BERT_INT8_OPS.items():
        assert ops[op] == n, f"{op}: {ops[op]} in the fused graph, expected {n}"
    names = computational_nodes(fused)
    ex = TorchExecutor(fused, capture=names, device="cuda")
    requests = [make(rng) for _ in range(REQUESTS)]

    phase(f"17b. {model}: K1, K4 and K1's batched mode at the forward's calls: == plain, "
          "time, bound, library")
    calls: list = []
    with recording(calls):
        ex.run_device(requests[0])
    torch.cuda.synchronize()
    totals = check_kernels(calls, INT8_TRANSFORMER_KERNELS, model)

    phase(f"17c. {model} main path: {REQUESTS} requests through "
          "TorchExecutor(fuse=True, device='cuda')")
    packed = len(matmul_int8._KMAJOR)
    reset(INT8_TRANSFORMER_KERNELS)
    lat = []
    first_out = None
    for x in requests:
        t0 = time.perf_counter()
        outs = ex.run_device(x)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if first_out is None:
            first_out = [o.cpu().numpy() for o in outs]
    launches = read_launches(INT8_TRANSFORMER_KERNELS, f"the {model} run path")
    per = {"qgemm_rq": BERT_INT8_OPS["tk.dense_rq"], "qgemm_raw": BERT_INT8_OPS["qnn.dense"],
           "qbmm_rq": BERT_INT8_OPS["tk.bmm_rq"]}
    for name, n in launches.items():
        say(f"{name}: {n} launches, {n // REQUESTS} per forward")
        assert n == per[name] * REQUESTS, (name, n)
    assert len(matmul_int8._KMAJOR) == packed, "a request packed a weight again"
    say(f"{packed} weight tensors packed K-major before the requests, none during them "
        "(the batched mode packs nothing)")
    t0 = time.perf_counter()
    plain = TorchExecutor(fused, capture=names, device="cpu").run(requests[0])
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    n_int = hold_against_plain(names, first_out, plain, fused, FLOAT_RTOL, FLOAT_ATOL)
    logits = first_out[names.index(fused.outputs[0])]
    assert logits.shape == (BERT_BATCH, 2) and np.isfinite(logits).all()
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path; "
        f"logits {logits.shape} finite")
    med = statistics.median(lat[1:])
    say(f"latency ms per request (b{BERT_BATCH} s{SEQ}): median {med:.3f}, all "
        + " ".join(f"{v:.3f}" for v in lat))
    say(f"sequences/s {BERT_BATCH / med * 1e3:.1f}")
    kernel_ms = sum(t["ms"] for t in totals.values())
    say(f"{'+'.join(INT8_TRANSFORMER_KERNELS)} device ms per forward {kernel_ms:.4f} of "
        f"{med:.3f} ms end to end")

    phase(f"17d. {model}: device time of the main path (torch.profiler, 3 requests)")
    profile_requests(ex, requests[:3], med)
    return totals, launches


def int8_transformer_check(label: str, model: str, build, make_input) -> dict:
    """Phase 17f: an int8 transformer (TRANSFORMER_INT8) quantized, fused and
    run on the card: every recorded kernel call == plain, INT8_CHECK_REQUESTS
    requests with K1 and qbmm_rq counted, every integer node == the CPU path
    (float nodes within the float transformers' tolerance: GPT-2's float
    lm-head product).  Returns the launches."""
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    phase(f"{label} int8 {model}: quantize (TRANSFORMER_INT8), fuse, run on the card")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    fused = fuse_qnn(quantize(build(), [make_input(rng)], TRANSFORMER_INT8))
    ops = Counter(n.op for n in fused.nodes if n.op not in ("var", "const"))
    say(f"build + calibrate + quantize + fuse {time.perf_counter() - t0:.2f} s (host)")
    say("fused graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    assert ops["tk.bmm_rq"] == 24 and ops["qnn.softmax"] == 12, ops
    names = computational_nodes(fused)
    ex = TorchExecutor(fused, capture=names, device="cuda")
    x = make_input(rng)
    calls: list = []
    with recording(calls):
        ex.run_device(x)
    torch.cuda.synchronize()
    impl = kernel_impls()
    held = Counter()
    for name, a, k in calls:
        hold_call(name, a, k, impl)
        held[name] += 1
    say("kernel calls of one forward, each == plain: "
        + ", ".join(f"{n} {name}" for name, n in sorted(held.items())))
    assert held["qbmm_rq"] == 24, held
    kernels = ("qgemm_rq", "qbmm_rq")
    reset(kernels)
    first_out = None
    for _ in range(INT8_CHECK_REQUESTS):
        outs = ex.run_device(x)
        torch.cuda.synchronize()
        if first_out is None:
            first_out = [o.cpu().numpy() for o in outs]
    launches = read_launches(kernels, f"the int8 {model} path")
    assert launches["qbmm_rq"] == 24 * INT8_CHECK_REQUESTS, launches
    say(", ".join(f"{name}: {n} launches in {INT8_CHECK_REQUESTS} requests"
                  for name, n in launches.items()))
    plain = TorchExecutor(fused, capture=names, device="cpu").run(x)
    n_int = hold_against_plain(names, first_out, plain, fused, GRAPH_RTOL, GRAPH_ATOL)
    out = first_out[names.index(fused.outputs[0])]
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path; "
        f"output {out.shape} finite, float nodes within rtol {GRAPH_RTOL} atol {GRAPH_ATOL}")
    return launches


# ---------------------------------------------------------------------------
# decoding (phase 18)
# ---------------------------------------------------------------------------

def same_tokens(got, want, want_logits, n_prompt: int, what: str) -> None:
    """Hold two greedy token sequences ==; at the first difference print the
    new token's index and the top-2 gap of the reference's logits there."""
    if got.shape == want.shape and (got == want).all():
        return
    s = int(np.argwhere((got != want).any(axis=0))[0][0])
    top2 = np.sort(want_logits[n_prompt - 1 + s][0])[-2:]
    say(f"{what}: new token {s} differs, {got[:, s].tolist()} vs {want[:, s].tolist()}; the "
        f"reference's top-2 gap there {top2[1] - top2[0]:.3e}")
    raise AssertionError(f"{what}: greedy tokens differ at new token {s}")


def step_bound_ms(step, int8: bool) -> tuple[float, float]:
    """(bytes, ms at HBM_BYTES_PER_S) one decode step must move at b1: every
    param read once but the embedding tables (a row each), and the float
    caches read by the attention and copied by the functional cache write;
    the int8 step also quantizes them (a float read, an int8 write)."""
    params = sum(v.nbytes for k, v in step.params.items() if k not in ("wte", "wpe"))
    rows = step.params["wte"][0].nbytes + step.params["wpe"][0].nbytes
    cache = sum(4 * int(np.prod(n.shape)) for n in step.inputs
                if n.name[0] in "kv" and n.name[1:].isdigit())
    nbytes = params + rows + 3 * cache + (cache + cache // 4 if int8 else 0)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def decode_path(card: str) -> tuple[dict, dict]:
    """Phases 18a-f: GPT-2 small KV-cache decoding on the card (the JAX
    package's serving path, models/decoding.py).  Returns the int8 step's
    kernels' per-step totals and the launches of the counted runs (K6 in
    18b's prefill, K1, K4 and qbmm_rq in 18e's generation, K4 and qbmm_raw in
    18f's traces)."""
    from tachikoma_tpu_torch.ir.transforms import fuse_attention
    from tachikoma_tpu_torch.models.decoding import (GreedyDecoder, gpt2_decode_step,
                                                     gpt2_generate_scanned)
    from tachikoma_tpu_torch.models.transformer import gpt2_small
    from tachikoma_tpu_torch.ops.kernels import matmul_int8
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
    from tachikoma_tpu_torch.runtime.interpreter import run_graph
    from tachikoma_tpu_torch.trace.emitter import TraceEmitter, verify_trace
    from tachikoma_tpu_torch.trace.native import native_verify

    P, NEW, LAY = DECODE_PROMPT, DECODE_NEW, DECODE_LAYERS
    launches = {}
    phase(f"18a. decoding GPT-2 small b1, cache {SEQ}: build, fuse_attention, the decode step "
          f"(host) [{card}]")
    t0 = time.perf_counter()
    full = gpt2_small(batch_size=1, seq_len=SEQ, seed=SEED)
    t1 = time.perf_counter()
    fused = fuse_attention(full)
    t2 = time.perf_counter()
    step = gpt2_decode_step(full, batch_size=1, max_len=SEQ)
    t3 = time.perf_counter()
    prompt = np.random.default_rng(SEED).integers(0, DECODE_VOCAB, (1, P)).astype(np.int32)
    n_attn = sum(n.op == "tk.attention" for n in fused.nodes)
    say(f"build {t1 - t0:.2f} s, fuse_attention {t2 - t1:.2f} s, decode step {t3 - t2:.2f} s: "
        f"full graph {len(full)} nodes, fused {len(fused)} ({n_attn} tk.attention), step "
        f"{len(step)} nodes, {len(computational_nodes(step))} ops; prompt {prompt.tolist()}")

    phase(f"18b. float decoding, the host loop: attach_prefill(fuse_attention(full)), "
          f"generate(prompt, {NEW}) on the card [{card}]")
    dec = GreedyDecoder(step, layers=LAY, device="cuda").attach_prefill(fused)
    dec.generate(prompt, 4)  # warm: cuBLAS, the kernel library, the allocator
    calls: list = []
    reset(("flash_attn",))
    t0 = time.perf_counter()
    with recording(calls):
        toks, logits = dec.generate(prompt, NEW)
    total_s = time.perf_counter() - t0
    launches["flash_attn"] = read_launches(("flash_attn",), "the prefill")["flash_attn"]
    assert launches["flash_attn"] == 12 and [c[0] for c in calls] == ["flash_attn"] * 12, calls
    impl = kernel_impls()
    k6_err = max(hold_call(name, a, k, impl) for name, a, k in calls)
    say(f"prefill: 12 flash_attn launches ({work(*calls[0])[2]}, "
        f"{launch_plan(*calls[0])}), each within rtol {FA_RTOL} atol {FA_ATOL} of plain, max "
        f"|err| {k6_err:.3e}")
    t0 = time.perf_counter()
    ctoks, clogits = GreedyDecoder(step, layers=LAY, device="cpu").attach_prefill(
        fused).generate(prompt, NEW)
    say(f"CPU host loop {time.perf_counter() - t0:.2f} s (host)")
    same_tokens(toks, ctoks, clogits, P, "float host loop, card vs CPU")
    assert len(logits) == len(clogits) == P + NEW - 1
    worst = 0.0
    for p, (a, b) in enumerate(zip(logits, clogits)):
        assert a.shape == (1, DECODE_VOCAB) and np.isfinite(a).all(), p
        np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=f"position {p}")
        worst = max(worst, float(np.abs(a - b).max()))
    seq = np.zeros((1, SEQ), np.int32)
    seq[:, :P] = prompt
    seq[:, P:P + NEW] = toks
    recompute = TorchExecutor(fused, device="cuda").run({"input_ids": seq})[0]
    worst_full = 0.0
    for p in range(P + NEW - 1):
        np.testing.assert_allclose(logits[p], recompute[:, p], rtol=RECOMPUTE_TOL,
                                   atol=RECOMPUTE_TOL, err_msg=f"position {p}")
        worst_full = max(worst_full, float(np.abs(logits[p] - recompute[:, p]).max()))
    say(f"tokens == the CPU's host loop, all {NEW}: {toks[0].tolist()}")
    say(f"every step's logits within rtol {STEP_RTOL} atol {STEP_ATOL} of the CPU's (max |err| "
        f"{worst:.3e}); every position's within {RECOMPUTE_TOL} of the full recompute on the "
        f"card (max |err| {worst_full:.3e})")
    step_ms = [1e3 * v for v in dec.step_seconds]
    med = statistics.median(step_ms)
    nbytes, bound = step_bound_ms(step, int8=False)
    say(f"ms/token (host clock per step, median of {len(step_ms)}) {med:.4f}, tokens/s "
        f"{1e3 / med:.1f}; bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); the whole call {total_s:.3f} s")
    say("steps ms, all: " + " ".join(f"{v:.3f}" for v in step_ms))
    ex = dec._ex
    feed = {"token": torch.from_numpy(toks[:, :1]).cuda(),
            "pos": torch.tensor(P, dtype=torch.int32, device="cuda"),
            **{n.name: torch.zeros(n.shape, device="cuda") for n in step.inputs
               if n.name[0] in "kv"}}
    busy = profile_runs(lambda: ex.run_device(feed)[0].cpu(), 3, med, "step")
    say(f"launches per token: 0 of the port's kernels (the float step runs torch ops; K6 "
        f"12 in the prefill), {busy[1]:.0f} device operations a step" if busy else
        "launches per token: 0 of the port's kernels")

    phase(f"18c. float decoding on the device: generate_ondevice(prompt, {NEW}), the step "
          f"captured once in a CUDA graph and replayed [{card}]")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        otoks = dec.generate_ondevice(prompt, NEW)
        times.append(time.perf_counter() - t0)
        same_tokens(otoks, toks, logits, P, "generate_ondevice vs generate")
    assert dec.cuda_graph is not None and dec.replays == NEW - 1, dec.replays
    call_ms = 1e3 * statistics.median(times[1:])
    say(f"tokens == 18b's; {dec.replays} replays of one captured CUDA graph a call")
    say(f"ms/token with the prefill and the capture amortised over {NEW} tokens "
        f"{call_ms / NEW:.4f} (call {call_ms:.3f} ms, median of the last 2 of 3), tokens/s "
        f"{NEW / call_ms * 1e3:.1f}")
    replay = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(REPLAYS_TIMED):
        start.record()
        dec.cuda_graph.replay()
        end.record()
        torch.cuda.synchronize()
        replay.append(start.elapsed_time(end))
    rep = statistics.median(replay)
    say(f"one step replayed alone: median {rep:.4f} ms of {REPLAYS_TIMED} (CUDA events), "
        f"{1e3 / rep:.1f} tokens/s; bound {bound:.4f} ms ({bound / rep:.1%} of it)")
    profile_runs(lambda: dec.generate_ondevice(prompt, NEW), 1, call_ms, "generate_ondevice call")
    profile_runs(dec.cuda_graph.replay, 3, rep, "replayed step")

    phase(f"18d. gpt2_generate_scanned(full, prompt, {NEW}, max_len={SEQ}): plain torch over the "
          f"stacked layer weights [{card}]")
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        stoks = gpt2_generate_scanned(full, prompt, NEW, max_len=SEQ, device="cuda")
        times.append(time.perf_counter() - t0)
        same_tokens(stoks, toks, logits, P, "gpt2_generate_scanned vs generate")
    say(f"tokens == 18b's; ms/token {1e3 * times[-1] / NEW:.4f} (the second call "
        f"{times[-1]:.3f} s over {NEW} tokens, {P + NEW - 1} steps; the first, with the weights' "
        f"upload, {times[0]:.3f} s)")

    phase(f"18e. int8 decode step: calibrate on {DECODE_CALIB} step feeds (positions 0-"
          f"{DECODE_CALIB - 1}), quantize (TRANSFORMER_INT8), fuse (host) [{card}]")
    t0 = time.perf_counter()
    caches = {n.name: np.zeros(n.shape, np.float32) for n in step.inputs if n.name[0] in "kv"}
    calib = []
    for p in range(DECODE_CALIB):
        f = {"token": prompt[:, p:p + 1], "pos": np.int32(p), **caches}
        calib.append(dict(f))
        outs = run_graph(step, f)
        for i in range(LAY):
            caches[f"k{i}"], caches[f"v{i}"] = outs[1 + i], outs[1 + LAY + i]
    t1 = time.perf_counter()
    q = quantize(step, calib, TRANSFORMER_INT8)
    t2 = time.perf_counter()
    qf = fuse_qnn(q)
    t3 = time.perf_counter()
    ops = Counter(n.op for n in qf.nodes if n.op not in ("var", "const"))
    say(f"step feeds {t1 - t0:.2f} s, calibrate+quantize {t2 - t1:.2f} s, fuse {t3 - t2:.2f} s")
    say("fused step: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    for op, n in GPT2_INT8_STEP_OPS.items():
        assert ops[op] == n, f"{op}: {ops[op]} in the fused step, expected {n}"
    names = computational_nodes(qf)
    feed = {"token": prompt[:, DECODE_CALIB:DECODE_CALIB + 1], "pos": np.int32(DECODE_CALIB),
            **caches}
    ex8 = TorchExecutor(qf, capture=names, device="cuda")
    calls = []
    with recording(calls):
        outs8 = [o.cpu().numpy() for o in ex8.run_device(feed)]
    totals = check_kernels(calls, DECODE_KERNELS, "int8 GPT-2 small decode step")
    plain = TorchExecutor(qf, capture=names, device="cpu").run(feed)
    n_int = hold_against_plain(names, outs8, plain, qf, GRAPH_RTOL, GRAPH_ATOL)
    say(f"one step at pos {DECODE_CALIB}: {n_int} of {len(names)} captured nodes are integer and "
        f"== the CPU path; float nodes within rtol {GRAPH_RTOL} atol {GRAPH_ATOL}")

    phase(f"18e. int8 decoding on the card: generate(prompt, {DECODE_INT8_NEW}), the prompt "
          f"stepped through the step graph [{card}]")
    dec8 = GreedyDecoder(qf, layers=LAY, device="cuda")
    dec8.generate(prompt, 2)  # warm: K1 and K4 pack their weights
    packed = len(matmul_int8._KMAJOR)
    reset(DECODE_KERNELS)
    toks8, logits8 = dec8.generate(prompt, DECODE_INT8_NEW)
    n_steps = P + DECODE_INT8_NEW - 1
    counted = read_launches(DECODE_KERNELS, "the int8 decoder")
    per = {"qgemm_rq": GPT2_INT8_STEP_OPS["tk.dense_rq"], "qgemm_raw": GPT2_INT8_STEP_OPS["qnn.dense"],
           "qbmm_rq": GPT2_INT8_STEP_OPS["tk.bmm_rq"]}
    for name, n in counted.items():
        assert n == per[name] * n_steps, (name, n)
        launches[name] = n
    assert len(matmul_int8._KMAJOR) == packed, "a step packed a weight again"
    say(", ".join(f"{name}: {n} launches in {n_steps} steps, {n // n_steps} a token"
                  for name, n in counted.items())
        + f"; {packed} weight tensors packed K-major by the warm call, none during the steps")
    t0 = time.perf_counter()
    ctoks8, clogits8 = GreedyDecoder(qf, layers=LAY, device="cpu").generate(prompt,
                                                                           DECODE_INT8_NEW)
    say(f"CPU int8 decoder {time.perf_counter() - t0:.2f} s (host)")
    same_tokens(toks8, ctoks8, clogits8, P, "int8 decoder, card vs CPU")
    for p, (a, b) in enumerate(zip(logits8, clogits8)):
        assert np.isfinite(a).all(), p
        np.testing.assert_allclose(a, b, rtol=GRAPH_RTOL, atol=GRAPH_ATOL, err_msg=f"int8 {p}")
    say(f"tokens == the CPU int8 decoder's, all {DECODE_INT8_NEW}: {toks8[0].tolist()}; every "
        f"step's float logits within rtol {GRAPH_RTOL} atol {GRAPH_ATOL}")
    step_ms = [1e3 * v for v in dec8.step_seconds[P:]]
    med8 = statistics.median(step_ms)
    nbytes8, bound8 = step_bound_ms(qf, int8=True)
    kernel_ms = sum(t["ms"] for t in totals.values())
    say(f"ms/token (host clock per step, median of the {len(step_ms)} decode steps) {med8:.4f}, "
        f"tokens/s {1e3 / med8:.1f}; bound {bound8:.4f} ms ({nbytes8 / 1e6:.1f} MB); "
        f"{'+'.join(DECODE_KERNELS)} device ms per step {kernel_ms:.4f}")
    feed_dev = {k: torch.as_tensor(np.asarray(v)).cuda() for k, v in feed.items()}
    ex8s = dec8._ex
    busy = profile_runs(lambda: ex8s.run_device(feed_dev)[0].cpu(), 3, med8, "step")
    say(f"launches per token: {sum(per.values())} of the port's kernels "
        f"({', '.join(f'{per[n]} {n}' for n in DECODE_KERNELS)})"
        + (f", {busy[1]:.0f} device operations a step" if busy else ""))

    phase(f"18f. trace of one unfused int8 step at pos {P} (the caches of 18e's prompt): K4 and "
          f"qbmm_raw == plain, TraceEmitter(backend='torch', device='cuda').emit_to [{card}]")
    c8 = {n.name: torch.zeros(n.shape, device="cuda") for n in qf.inputs if n.name[0] in "kv"}
    for p in range(P):
        _, c8 = dec8._step(prompt[:, p:p + 1], p, c8)
    tfeed = {"token": toks8[:, :1], "pos": np.int32(P),
             **{k: v.cpu().numpy() for k, v in c8.items()}}
    qnames = computational_nodes(q)
    exq = TorchExecutor(q, capture=qnames, device="cuda")
    reset(DECODE_TRACE_KERNELS)
    calls = []
    with recording(calls):
        qouts = [o.cpu().numpy() for o in exq.run_device(tfeed)]
    read_launches(DECODE_TRACE_KERNELS, "the unfused int8 step")
    trace_totals = check_kernels(calls, DECODE_TRACE_KERNELS, "int8 GPT-2 small decode step")
    n_int = hold_against_plain(qnames, qouts,
                               TorchExecutor(q, capture=qnames, device="cpu").run(tfeed), q,
                               GRAPH_RTOL, GRAPH_ATOL)
    say(f"{n_int} of {len(qnames)} nodes of the unfused step are integer and == the CPU path")
    tdir = tempfile.gettempdir()
    path = os.path.join(tdir, f"tk_chip_smoke_{os.getpid()}_step.bin")
    ref_path = os.path.join(tdir, f"tk_chip_smoke_{os.getpid()}_step_cpu.bin")
    meta = {"model": f"gpt2_small_b1_step_pos{P}"}
    try:
        em = TraceEmitter(q, backend="torch", device="cuda", meta=meta)
        reset(DECODE_TRACE_KERNELS)
        t0 = time.perf_counter()
        n_records = em.emit_to(tfeed, path)
        t1 = time.perf_counter()
        em.emit_to(tfeed, path)
        t2 = time.perf_counter()
        for name, n in read_launches(DECODE_TRACE_KERNELS, "the step's traces").items():
            launches[name] = launches.get(name, 0) + n
        nbytes = os.path.getsize(path)
        say(f"records {n_records}, bytes {nbytes}; trace s {t2 - t1:.4f} (the first, warm, "
            f"{t1 - t0:.4f}); writer {em.last_timings['writer']}; dir {tdir} "
            f"({filesystem_type(tdir)})")
        t0 = time.perf_counter()
        TraceEmitter(q, backend="torch", device="cpu", meta=meta).emit_to(tfeed, ref_path)
        t1 = time.perf_counter()
        counts: dict = {}
        cone = float_product_cone(q)
        n, n_int = compare_traces(path, ref_path, cone, counts)
        with open(path, "rb") as f, open(ref_path, "rb") as g:
            whole = f.read() == g.read()
        say(f"CPU trace {t1 - t0:.2f} s; card trace vs CPU trace: {n} records, {n_int} integer "
            f"byte-equal, {n - n_int} float ({counts['float_byte_equal']} of them byte-equal) "
            f"within rtol {FLOAT_RTOL} atol {FLOAT_ATOL} but the {len(cone)} of the float LM "
            f"head's product and what it feeds ({', '.join(sorted(cone))}), within the float "
            f"transformers' rtol {GRAPH_RTOL} atol {GRAPH_ATOL}; the whole file byte-equal: "
            f"{whole}")
        assert native_verify(path) == n_records
        t0 = time.perf_counter()
        res = verify_trace(path, q)
        assert res["verified"] == res["records"] == n_records, res["mismatches"][:5]
        say(f"CRCs ok (native); verify_trace: {res['verified']}/{res['records']} records "
            f"verified by the numpy oracle in {time.perf_counter() - t0:.2f} s")
    finally:
        for p_ in (path, ref_path):
            if os.path.exists(p_):
                os.unlink(p_)
    totals.update(trace_totals)
    totals["flash_attn"] = {"max_abs_err": k6_err}
    return totals, launches


# ---------------------------------------------------------------------------
# the vision zoo (phase 19)
# ---------------------------------------------------------------------------

ZOO_KERNELS = ("qgemm_rq", "qconv_rq", "qconv_rq_res", "qdwconv_rq")
ZOO_PROFILED = 3                  # requests under torch.profiler
DIGITS_FIXTURE = os.path.join("tests", "fixtures", "digits_cnn.npz")
# the end-to-end limit of a float output that a quantize flipped by the
# float-source set feeds (ResNet3D-18's probabilities: 7.06e-4 measured, PERF.md 2)
ZOO_FLIPPED_ATOL = 2e-3


def _host(v):
    return [t.cpu().numpy() for t in v] if isinstance(v, (list, tuple)) else v.cpu().numpy()


def quantize_gap(node, x: np.ndarray, index) -> str:
    """For a qnn.quantize element: its float input, x / scale (float32, as
    the op divides) and that value's distance to the nearest rounding
    boundary k + 1/2 (rint rounds ties to even)."""
    scale = np.asarray(node.attrs["scale"], np.float32)
    s = scale if scale.ndim == 0 else scale.reshape(-1)[index[int(node.attrs.get("axis", -1))]]
    q = float(np.float32(x[index]) / np.float32(s))
    return (f"input {float(x[index])!r}, x/scale {q!r}, "
            f"{abs(abs(q - np.floor(q)) - 0.5):.3g} from a rounding boundary")


@contextlib.contextmanager
def tf32_allowed():
    """torch's TF32 flags set as a user may set them (cuDNN's is on by
    default): the port's float convolutions and products run in float32
    all the same (ops/nn.py float32_products)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def hold_zoo_nodes(graph, names, card: list, cpu: list, feeds: dict) -> dict:
    """Phase 19's rule (runtime/crosscheck.py hold_node_level at GRAPH_RTOL /
    GRAPH_ATOL): outside the float-source set every captured node == the CPU
    path; inside it every node == its own op's CPU impl on the card's
    captured inputs.  Prints each end-to-end difference there: elements that
    differ, the largest difference in LSB, and for a qnn.quantize its first
    differing element's float input and distance to the rounding boundary."""
    from tachikoma_tpu_torch.runtime.crosscheck import hold_node_level

    counts, differing = hold_node_level(graph, names, card, cpu, feeds, GRAPH_RTOL, GRAPH_ATOL)
    for nm, n_diff, lsb, first in differing:
        node = graph[nm]
        a = card[names.index(nm)]
        line = (f"  end to end: {nm} ({node.op}) {n_diff} of {a.size} elements "
                f"differ from the CPU path, at most {lsb} LSB; first at {first}")
        if node.op == "qnn.quantize":
            src = node.inputs[0]
            if src in names:
                line += (f"; card {quantize_gap(node, card[names.index(src)], first)}"
                         f"; CPU {quantize_gap(node, cpu[names.index(src)], first)}")
        say(line)
    return dict(counts)


def nms_versus_cpu(graph, names, card: list, cpu: list) -> str:
    """Phase 19's SSD-lite check of the selected boxes: the card's NMS on its
    own inputs is held == the oracle (by hold_zoo_nodes and here), then its
    indices against the CPU path's.  A difference prints each box that only
    one side keeps, its score's distance to the score threshold and its
    largest IoU with the boxes kept before it, and fails unless both that
    score and that IoU lie within GRAPH_ATOL of their thresholds (a
    near-tie)."""
    from tachikoma_tpu_torch.ir.registry import get_op

    node = next(n for n in graph.nodes if n.op == "vision.non_max_suppression")
    cap = dict(zip(names, card))
    boxes, scores = cap[node.inputs[0]], cap[node.inputs[1]]
    oracle = get_op(node.op).np_impl(boxes, scores, node=node)
    got, want = cap[node.name], cpu[names.index(node.name)]
    assert (got == oracle).all(), "the card's NMS != the oracle on the card's own inputs"
    kept = int((got >= 0).sum())
    if (got == want).all():
        return f"NMS: {kept} boxes kept, == the CPU path's indices and == the oracle"
    iou_thr = float(node.attrs.get("iou_threshold", 0.5))
    score_thr = float(node.attrs.get("score_threshold", -np.inf))
    ours, theirs = list(got[0][got[0] >= 0]), list(want[0][want[0] >= 0])
    only = [i for i in ours if i not in theirs] + [i for i in theirs if i not in ours]
    near = True
    for i in sorted(only, key=lambda i: -scores[0, i]):
        before = [j for j in ours if scores[0, j] > scores[0, i] or (scores[0, j] == scores[0, i]
                                                                      and j < i)]
        b = boxes[0]
        ious = [0.0]
        for j in before:
            y1, x1 = max(b[i, 0], b[j, 0]), max(b[i, 1], b[j, 1])
            y2, x2 = min(b[i, 2], b[j, 2]), min(b[i, 3], b[j, 3])
            inter = max(y2 - y1, 0) * max(x2 - x1, 0)
            union = ((b[i, 2] - b[i, 0]) * (b[i, 3] - b[i, 1])
                     + (b[j, 2] - b[j, 0]) * (b[j, 3] - b[j, 1]) - inter)
            ious.append(float(inter / max(union, 1e-9)))
        gap_s, gap_i = float(scores[0, i]) - score_thr, max(ious) - iou_thr
        say(f"  NMS: box {i} {b[i].tolist()} kept by {'the card' if i in ours else 'the CPU'} "
            f"only; score {float(scores[0, i])!r} ({gap_s:+.3g} from {score_thr}), largest IoU "
            f"with a box kept before it {max(ious):.6f} ({gap_i:+.3g} from {iou_thr})")
        near = near and max(abs(gap_s), abs(gap_i)) <= GRAPH_ATOL
    assert near, "the card's NMS indices differ from the CPU path's beyond a near-tie"
    return f"NMS: {kept} boxes kept; {len(only)} differ from the CPU path's, each a near-tie"


def zoo_path(label: str, model: str, build, make_input, card: str,
             check_output=None) -> tuple[dict, dict, dict]:
    """Phase 19 for one builder at its published widths: build, calibrate
    and quantize from SEED, fuse; every recorded K1/K2/K3/K5 call == plain,
    timed, bound and library; REQUESTS requests through
    TorchExecutor(device='cuda') with the launches counted; the integer
    nodes held to the CPU path by hold_zoo_nodes; the device's busy share.
    Returns the kernels' per-forward totals, their launches and a summary."""
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.crosscheck import float_source_set
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    phase(f"{label} {model}: build, calibrate, quantize, fuse (host) [{card}]")
    t0 = time.perf_counter()
    g = build()
    rng = np.random.default_rng(SEED)
    t1 = time.perf_counter()
    q = quantize(g, [make_input(rng)])
    t2 = time.perf_counter()
    fused = fuse_qnn(q)
    ops = Counter(n.op for n in fused.nodes if n.op not in ("var", "const"))
    say(f"build {t1 - t0:.2f} s, calibrate+quantize {t2 - t1:.2f} s, fuse "
        f"{time.perf_counter() - t2:.2f} s")
    say("fused graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    names = computational_nodes(fused)
    ex = TorchExecutor(fused, capture=names, device="cuda")
    requests = [make_input(rng) for _ in range(REQUESTS)]

    calls: list = []
    with recording(calls):
        ex.run_device(requests[0])
    torch.cuda.synchronize()
    kernels = tuple(k for k in ZOO_KERNELS if any(c[0] == k for c in calls))
    phase(f"{label} {model}: {', '.join(kernels) or 'no kernel'} at the forward's "
          f"{len(calls)} calls: == plain, time, bound, library [{card}]")
    totals = check_kernels(calls, kernels, model) if kernels else {}

    phase(f"{label} {model}: {REQUESTS} requests through TorchExecutor(device='cuda'), TF32 "
          f"allowed for cuDNN and matmuls [{card}]")
    reset(kernels)
    lat, first = [], None
    with tf32_allowed():  # the port's float products must not take it
        for x in requests:
            t0 = time.perf_counter()
            outs = ex.run_device(x)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = [_host(o) for o in outs]
    launches = read_launches(kernels, f"the {model} path")
    say(", ".join(f"{k}: {n} launches, {n // REQUESTS} per request" for k, n in launches.items()))
    med = statistics.median(lat[1:])
    say(f"latency ms per request: median {med:.3f}, all " + " ".join(f"{v:.3f}" for v in lat))
    t0 = time.perf_counter()
    plain = [_host(o) for o in
             TorchExecutor(fused, capture=names, device="cpu").run_device(requests[0])]
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    feeds = requests[0] if isinstance(requests[0], dict) else {fused.inputs[0].name: requests[0]}
    counts = hold_zoo_nodes(fused, names, first, plain, feeds)
    say(f"{counts.get('int', 0)} integer nodes outside the float-source set == the CPU path; "
        f"{counts.get('float', 0)} float nodes there within rtol {GRAPH_RTOL} atol {GRAPH_ATOL} "
        f"({counts.get('float_bit_equal', 0)} bit-equal); the set holds {counts['cone']} nodes: "
        f"{counts.get('cone_int', 0)} integer, each == its CPU impl on the card's inputs "
        f"({counts.get('cone_int_differing', 0)} differ from the CPU path end to end), "
        f"{counts.get('cone_float', 0)} float within rtol {GRAPH_RTOL} atol {GRAPH_ATOL} of it")
    # the float outputs inside the set: within GRAPH_RTOL / GRAPH_ATOL of the
    # CPU path where no quantize of the set flipped, else within
    # ZOO_FLIPPED_ATOL (those outside the set were held above)
    atol = ZOO_FLIPPED_ATOL if counts.get("cone_int_differing") else GRAPH_ATOL
    cone = float_source_set(fused)
    for o in fused.outputs:
        a, b = first[names.index(o)], plain[names.index(o)]
        if a.dtype.kind == "f" and o in cone:
            assert np.isfinite(a).all(), o
            err = np.abs(a.astype(np.float64) - b).max()
            bad = int((~np.isclose(a, b, rtol=GRAPH_RTOL, atol=GRAPH_ATOL)).sum())
            say(f"  end to end: output {o} max |card - CPU| {err:.3g}, {bad} of {a.size} "
                f"elements outside rtol {GRAPH_RTOL} atol {GRAPH_ATOL}; held at atol {atol}")
            np.testing.assert_allclose(a, b, rtol=GRAPH_RTOL, atol=atol, err_msg=o)
    extra = check_output(fused, names, first, plain) if check_output else ""
    say(f"outputs: {', '.join(f'{o} {first[names.index(o)].shape}' for o in fused.outputs)}"
        + (f"; {extra}" if extra else ""))
    kernel_ms = sum(t["ms"] for t in totals.values())
    say(f"{'+'.join(kernels) or 'no kernel'} device ms per forward {kernel_ms:.4f} of {med:.3f} "
        "ms end to end")

    phase(f"{label} {model}: device time (torch.profiler, {ZOO_PROFILED} requests) [{card}]")
    busy = profile_runs(lambda: ex.run_device(requests[1]), ZOO_PROFILED, med, "request")
    summary = dict(model=model, nodes=len(names), median_ms=med, kernel_ms=kernel_ms,
                   busy_ms=busy[0] if busy else None,
                   launches={k: n // REQUESTS for k, n in launches.items()},
                   kernels={k: {f: t[f] for f in ("calls", "ms", "bound_ms", "plain_ms",
                                                   "library_ms")} for k, t in totals.items()},
                   **counts)
    say("zoo summary " + json.dumps(summary))
    return totals, launches, summary


def classifier(classes: int):
    def check(graph, names, card, cpu):
        p = card[names.index(graph.outputs[0])]
        assert p.shape[-1] == classes and np.allclose(p.sum(-1), 1, atol=1e-4), p.shape
        agree = int((p.argmax(-1) == cpu[names.index(graph.outputs[0])].argmax(-1)).sum())
        assert agree == p.shape[0], f"argmax == the CPU's on {agree} of {p.shape[0]}"
        return f"probabilities sum to 1, argmax == the CPU's on {agree} of {p.shape[0]}"
    return check


def logits(classes: int):
    def check(graph, names, card, cpu):
        y = card[names.index(graph.outputs[0])]
        assert y.shape[-1] == classes and np.isfinite(y).all(), y.shape
        agree = int((y.argmax(-1) == cpu[names.index(graph.outputs[0])].argmax(-1)).sum())
        assert agree == y.shape[0], f"argmax == the CPU's on {agree} of {y.shape[0]}"
        return f"argmax == the CPU's on {agree} of {y.shape[0]}"
    return check


def dcgan_check(graph, names, card, cpu):
    img = card[names.index(graph.outputs[0])]
    assert img.shape == (1, 64, 64, 3) and np.abs(img).max() <= 1, img.shape
    return f"image {img.shape} in [{img.min():.3f}, {img.max():.3f}]"


def ssd_check(graph, names, card, cpu):
    boxes, scores, keep = (card[names.index(o)] for o in graph.outputs)
    assert boxes.shape[:2] == scores.shape and keep.shape == (1, 100), (boxes.shape, keep.shape)
    assert ((keep >= -1) & (keep < scores.shape[1])).all()
    node = next(n for n in graph.nodes if n.op == "vision.non_max_suppression")
    cap = dict(zip(names, card))
    from tachikoma_tpu_torch.ir.registry import get_op

    b, s = (torch.from_numpy(cap[i]).cuda() for i in node.inputs)
    nms = get_op(node.op).torch_impl
    ms = eager_ms(lambda: nms(b, s, node=node))
    return (f"{scores.shape[1]} priors; {nms_versus_cpu(graph, names, card, cpu)}; "
            f"NMS on the card {ms:.3f} ms a call (eager, host reads every "
            f"few fixed-point steps included)")


def zoo_configs():
    """Phase 19's eleven configurations: the JAX builders' published widths
    and default sizes (b8 for the ImageNet CNNs, b32 for the digits set, b1
    for the rest), inputs and weights from SEED (digits_cnn: its trained
    fixture)."""
    from tachikoma_tpu_torch.models import vision as v

    def images(shape):
        return lambda rng: rng.standard_normal(shape).astype(np.float32)

    return [
        ("19a.", "SqueezeNet 1.1 b8 224^2", lambda: v.squeezenet(batch_size=8, seed=SEED),
         images((8, 224, 224, 3)), classifier(1000)),
        ("19b.", "DenseNet-121 b8 224^2", lambda: v.densenet(batch_size=8, seed=SEED),
         images((8, 224, 224, 3)), classifier(1000)),
        ("19c.", "Inception-v3 stem b8 299^2", lambda: v.inception_v3_stem(batch_size=8, seed=SEED),
         images((8, 299, 299, 3)), classifier(1000)),
        ("19d.", "DQN b1 84^2 x 4", lambda: v.dqn(batch_size=1, seed=SEED),
         images((1, 84, 84, 4)), logits(18)),
        ("19e.", "LeNet-5 b1 28^2", lambda: v.lenet5(batch_size=1, seed=SEED),
         images((1, 28, 28, 1)), classifier(10)),
        ("19f.", "MLP b1 784", lambda: v.mlp(batch_size=1, seed=SEED), images((1, 784)),
         classifier(10)),
        ("19g.", "digits CNN b32 8^2 (trained)",
         lambda: v.digits_cnn(DIGITS_FIXTURE, batch_size=32), images((32, 8, 8, 1)), logits(10)),
        ("19h.", "LSTM b1 seq 16", lambda: v.lstm(batch_size=1, seq_len=16, seed=SEED),
         images((1, 16, 64)), classifier(10)),
        ("19i.", "DCGAN generator b1 latent 100",
         lambda: v.dcgan_generator(batch_size=1, seed=SEED), images((1, 100)), dcgan_check),
        ("19j.", "SSD-lite b1 320^2", lambda: v.ssd_lite(batch_size=1, seed=SEED),
         images((1, 320, 320, 3)), ssd_check),
        ("19k.", "ResNet3D-18 b1 16 x 112^2",
         lambda: v.resnet_3d(18, batch_size=1, seed=SEED), images((1, 16, 112, 112, 3)),
         classifier(400)),
    ]


def vision_zoo(card: str) -> tuple[dict, dict, list]:
    """Phase 19: the eleven builders (zoo_path each), then the traced run of
    the Inception-v3 stem b1 299^2 unfused (K4's conv and GEMM modes, the
    qnn.avg_pool2d and qnn.concatenate records) held against the CPU's
    trace.  Returns the kernels' totals (the first path's per kernel, for
    the kernels line), their launches and the per-model summaries."""
    from tachikoma_tpu_torch.models.vision import inception_v3_stem

    totals, launches, summaries = {}, Counter(), []
    for label, model, build, make_input, check in zoo_configs():
        t, n, summary = zoo_path(label, model, build, make_input, card, check)
        for name, tot in t.items():
            totals.setdefault(name, tot)
            totals[name]["max_abs_err"] = max(totals[name]["max_abs_err"], tot["max_abs_err"])
        launches.update(n)
        summaries.append(summary)
    trace_totals, trace_launches = trace_path(
        (f"19l. [{card}]", f"19l. [{card}]"), "Inception-v3 stem",
        lambda b: inception_v3_stem(batch_size=b, seed=SEED), TRACE_KERNELS,
        make_input=lambda rng: rng.standard_normal((TRACE_BATCH, 299, 299, 3)).astype(np.float32),
        size="299^2")
    for name, tot in trace_totals.items():
        totals.setdefault(name, tot)
    launches.update(trace_launches)
    say("zoo summary " + json.dumps({"model": "Inception-v3 stem b1 299^2 trace",
                                     "kernels": {k: {f: t[f] for f in ("calls", "ms", "bound_ms",
                                                                       "plain_ms", "library_ms")}
                                                 for k, t in trace_totals.items()}}))
    return totals, dict(launches), summaries


# ---------------------------------------------------------------------------
# the TFLite import and the W8A16 path (phase 20)
# ---------------------------------------------------------------------------

def tflite_path(card: str) -> tuple[dict, dict, dict]:
    """Phases 20a-20b: the exporter's int8 MobileNetV2 96^2 (52 convs and a
    dense, each at a nonzero input zero point; TFLite's stride-2 SAME pads
    the bottom and right only) imported and fused at b16: K1 / K2 / K5 ==
    plain and timed at every call, REQUESTS requests on the batch fixture's
    16 images, every integer node == the CPU path, the int8 output within
    one quantum of the TFLite interpreter's and top-1 16 of 16, the busy
    share; the default (integer_lut) import checked alike; then b1 unfused
    on K4 / K5's raw modes and traced.  Returns the kernels' per-forward
    totals, the launches and the largest |err| of each kernel."""
    from tachikoma_tpu_torch.frontend import from_tflite
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    model = "TFLite MobileNetV2 b16 96^2"
    phase(f"20a. the exporter's int8 MobileNetV2 ({TFLITE_MODEL}) b16 96^2: from_tflite "
          f"(integer_lut False and the default), fuse (host) [{card}]")
    batch = np.load(TFLITE_BATCH)
    xs, ys = batch["x"], batch["y"]
    t0 = time.perf_counter()
    name = from_tflite(TFLITE_MODEL).inputs[0].name
    graphs = {lut: from_tflite(TFLITE_MODEL, {name: xs.shape}, integer_lut=lut)
              for lut in (False, True)}
    fused = {lut: fuse_qnn(g) for lut, g in graphs.items()}
    say(f"import + fuse, both modes {time.perf_counter() - t0:.2f} s (host)")
    ops = Counter(n.op for n in fused[False].nodes if n.op not in ("var", "const"))
    say("fused graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    heads = [n for n in fused[False].nodes if n.op in ("tk.conv2d_rq", "tk.dense_rq")]
    izps = Counter(int(n.attrs["input_zero_point"]) for n in heads)
    assert len(heads) == 53 and 0 not in izps, izps
    s2 = [(n.name, tuple(n.attrs["padding"]), n.attrs["input_zero_point"]) for n in heads
          if tuple(n.attrs.get("strides", (1, 1))) == (2, 2)]
    assert all(p == (0, 0, 1, 1) for _, p, _ in s2), s2
    say(f"input zero points of the 53 fused convs and dense: {dict(sorted(izps.items()))}; "
        f"stride-2 convs (name, padding, izp): {s2}")
    names = computational_nodes(fused[False])
    ex = TorchExecutor(graphs[False], capture=names, fuse=True, device="cuda")
    assert ex.graph.to_json() == fused[False].to_json()

    phase(f"20a. {model}: K1, K2 and K5 at the forward's calls: == plain, time, bound, "
          f"library [{card}]")
    calls: list = []
    with recording(calls):
        ex.run_device(xs)
    torch.cuda.synchronize()
    totals = check_kernels(calls, TFLITE_KERNELS, model)
    errs = {k: t["max_abs_err"] for k, t in totals.items()}

    phase(f"20a. {model}: {REQUESTS} requests through TorchExecutor(fuse=True, "
          f"device='cuda') [{card}]")
    lat, first_out, launches = timed_requests(ex, [xs] * REQUESTS, TFLITE_KERNELS,
                                              f"the {model} path")
    plain = TorchExecutor(graphs[False], capture=names, fuse=True, device="cpu").run(xs)
    n_int = hold_against_plain(names, first_out, plain, fused[False], FLOAT_RTOL, FLOAT_ATOL)
    out = first_out[names.index(fused[False].outputs[0])]
    diff = np.abs(out.astype(np.int32) - ys.astype(np.int32))
    top1 = int((out.argmax(-1) == ys.argmax(-1)).sum())
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path; int8 "
        f"output {out.shape} vs the TFLite interpreter: max |diff| {diff.max()} quantum, "
        f"{(diff == 0).mean():.1%} equal, top-1 {top1} of {len(ys)}")
    assert diff.max() <= 1 and top1 == len(ys)
    med = say_latency(lat, len(xs))
    kernel_ms = sum(t["ms"] for t in totals.values())
    say(f"{'+'.join(TFLITE_KERNELS)} device ms per forward {kernel_ms:.4f} of {med:.3f} ms "
        "end to end")
    profile_requests(ex, [xs] * 3, med)
    names_l = computational_nodes(fused[True])
    card_l = TorchExecutor(graphs[True], capture=names_l, fuse=True, device="cuda").run(xs)
    cpu_l = TorchExecutor(graphs[True], capture=names_l, fuse=True, device="cpu").run(xs)
    n_int = hold_against_plain(names_l, card_l, cpu_l, fused[True], FLOAT_RTOL, FLOAT_ATOL)
    out = card_l[names_l.index(fused[True].outputs[0])]
    top1 = int((out.argmax(-1) == ys.argmax(-1)).sum())
    assert top1 == len(ys)
    say(f"integer_lut import (qnn.softmax): {n_int} of {len(names_l)} nodes integer and == the "
        f"CPU plain path, top-1 {top1} of {len(ys)}")

    trace_totals, trace_launches = trace_path(
        ("20b.", "20b."), "TFLite MobileNetV2", None, TFLITE_TRACE_KERNELS, size="96^2",
        prepared=(from_tflite(TFLITE_MODEL), xs[:TRACE_BATCH]))
    for k, t in trace_totals.items():
        errs[k] = max(errs.get(k, 0), t["max_abs_err"])
    for k, n in trace_launches.items():
        launches[k] = launches.get(k, 0) + n
    return totals, launches, errs


def w8a16_path(card: str) -> tuple[dict, dict, dict]:
    """Phases 20c-20e: ResNet-50 quantized W8A16 (int16 activations, int64
    accumulators, unfused) at b8 224^2: every product on K4 over two byte
    planes == its float64 plain version, timed beside the float64 cuBLAS /
    cuDNN call of the same shapes and the bound, REQUESTS requests, every
    integer node == the CPU path, the probabilities within phase 5's
    tolerance, the busy share; its b1 trace; the 16x8 TFLite fixture on the
    card.  Returns wide_planes' per-forward totals, the launches and the
    largest |err| of each kernel."""
    from tachikoma_tpu_torch.frontend import from_tflite
    from tachikoma_tpu_torch.models.vision import resnet
    from tachikoma_tpu_torch.quantize.config import W8A16
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes

    model = f"ResNet-50 W8A16 b{BATCH} {IMAGE}^2"

    def r50(batch):
        return resnet(50, batch_size=batch, image_size=IMAGE, seed=SEED)

    phase(f"20c. {model}: build (seed {SEED}), calibrate, quantize (W8A16), unfused (host) "
          f"[{card}]")
    t0 = time.perf_counter()
    g = r50(BATCH)
    rng = np.random.default_rng(SEED)
    calib = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    t1 = time.perf_counter()
    q = quantize(g, [calib], W8A16)
    say(f"build {t1 - t0:.2f} s, calibrate+quantize {time.perf_counter() - t1:.2f} s")
    ops = Counter((n.op, n.dtype) for n in q.nodes if n.op not in ("var", "const"))
    say("graph: " + ", ".join(f"{v} {k[0]} {k[1]}" for k, v in sorted(ops.items())))
    assert ops[("qnn.conv2d", "int64")] == 53 and ops[("qnn.dense", "int64")] == 1, ops
    assert ops[("qnn.requantize", "int16")] == 54, ops
    names = computational_nodes(q)
    ex = TorchExecutor(q, capture=names, device="cuda")
    requests = [rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
                for _ in range(REQUESTS)]

    phase(f"20c. {model}: the int64 products on K4 over two byte planes (wide_planes) and the "
          f"planes' K4 calls: == plain (float64), time, bound, float64 library call [{card}]")
    calls: list = []
    with recording(calls):
        ex.run_device(requests[0])
    torch.cuda.synchronize()
    assert sum(name == "wide_planes" for name, _, _ in calls) == 54
    totals = check_kernels(calls, W8A16_KERNELS, model)
    errs = {k: t["max_abs_err"] for k, t in totals.items()}

    phase(f"20c. {model}: {REQUESTS} requests through TorchExecutor(device='cuda') [{card}]")
    lat, first_out, launches = timed_requests(ex, requests, W8A16_KERNELS, f"the {model} path")
    t0 = time.perf_counter()
    plain = TorchExecutor(q, capture=names, device="cpu").run(requests[0])
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    n_int = hold_against_plain(names, first_out, plain, q, SOFTMAX_RTOL, SOFTMAX_ATOL)
    prob = first_out[names.index(q.outputs[0])]
    assert prob.shape == (BATCH, 1000) and np.allclose(prob.sum(-1), 1, atol=1e-4)
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path; float "
        f"nodes within rtol {SOFTMAX_RTOL} atol {SOFTMAX_ATOL}")
    med = say_latency(lat, BATCH)
    say(f"wide_planes device ms per forward {totals['wide_planes']['ms']:.4f} (bound "
        f"{totals['wide_planes']['bound_ms']:.4f}, float64 library "
        f"{totals['wide_planes']['library_ms']:.4f}) of {med:.3f} ms end to end")
    profile_requests(ex, requests[:3], med)

    trace_totals, trace_launches = trace_path(("20d.", "20d."), "ResNet-50 W8A16", r50,
                                              W8A16_KERNELS, config=W8A16)
    for k, t in trace_totals.items():
        errs[k] = max(errs.get(k, 0), t["max_abs_err"])
    for k, n in trace_launches.items():
        launches[k] = launches.get(k, 0) + n

    phase(f"20e. the 16x8 TFLite fixture ({TFLITE_16X8}) on the card: every product on K4 / K5 "
          f"over two byte planes == plain, integers == the CPU path [{card}]")
    io16 = np.load(TFLITE_16X8_IO)
    g16 = from_tflite(TFLITE_16X8)
    names16 = computational_nodes(g16)
    ex16 = TorchExecutor(g16, capture=names16, device="cuda")
    calls = []
    with recording(calls):
        ex16.run_device(io16["x"])
    torch.cuda.synchronize()
    impl = kernel_impls()
    held = Counter()
    for k, a, kw in calls:
        errs[k] = max(errs.get(k, 0), hold_call(k, a, kw, impl))
        held[k] += 1
    say("kernel calls of one forward, each == plain: "
        + ", ".join(f"{n} {k}" for k, n in sorted(held.items())))
    reset(W8A16_16X8_KERNELS)
    card16 = ex16.run(io16["x"])
    for k, n in read_launches(W8A16_16X8_KERNELS, "the 16x8 fixture").items():
        launches[k] = launches.get(k, 0) + n
    cpu16 = TorchExecutor(g16, capture=names16, device="cpu").run(io16["x"])
    n_int = hold_against_plain(names16, card16, cpu16, g16, FLOAT_RTOL, FLOAT_ATOL)
    out = card16[names16.index(g16.outputs[0])]
    gap = float(np.abs(out - io16["y"]).max())
    assert gap <= 1.0 / (1 << 15) + 1e-9, gap
    say(f"{n_int} of {len(names16)} nodes integer and == the CPU plain path; float output within "
        f"{gap:.3g} of the TFLite interpreter's (limit 2^-15)")
    return totals, launches, errs


# ---------------------------------------------------------------------------
# the ONNX import path (phase 21)
# ---------------------------------------------------------------------------

ONNX_DIR = os.path.join("tests", "fixtures")
ONNX_FIXTURES = ("paddle_route", "oneflow_route", "caffe_route", "coreml_route",
                 "darknet_route", "mxnet_lenet")
# the fused ONNX ResNet-50's op counts: native ResNet-50's (phase 3)
ONNX_R50_OPS = {"tk.conv2d_rq": 14, "tk.conv2d_chain": 1, "tk.conv2d_block_stack": 4,
                "tk.dense_rq": 1}
# a fixture's float output (tests/test_frontend_onnx_routes.py:40)
ROUTE_RTOL, ROUTE_ATOL = 1e-4, 1e-4
OP_RTOL, OP_ATOL = 1e-5, 1e-6        # a float op on the card against its CPU torch impl
RAW_KERNELS = ("qgemm_raw", "qconv_raw", "qdwconv_raw")


def onnx_resnet_path(card: str) -> tuple[dict, dict]:
    """Phase 21a: ResNet-50 b8 224^2 written as torch.onnx.export writes it
    (models/onnx_resnet.py, weights from SEED), imported with from_onnx,
    quantized and fused to native ResNet-50's form, then run by
    fused_resnet_run.  Returns the kernels' per-forward totals and their
    launches."""
    from tachikoma_tpu_torch.frontend import from_onnx
    from tachikoma_tpu_torch.models.onnx_resnet import resnet50_onnx
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    model = f"ONNX ResNet-50 b{BATCH} {IMAGE}^2"
    phase(f"21a. {model}: written by models/onnx_resnet.py (seed {SEED}), from_onnx, quantize, "
          f"fuse (host) [{card}]")
    t0 = time.perf_counter()
    blob = resnet50_onnx(BATCH, IMAGE, seed=SEED)
    t1 = time.perf_counter()
    g = from_onnx(blob)
    t2 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    q = quantize(g, [rng.standard_normal((BATCH, 3, IMAGE, IMAGE)).astype(np.float32)])
    t3 = time.perf_counter()
    fused = fuse_qnn(q)
    say(f"write {t1 - t0:.2f} s ({len(blob)} bytes), from_onnx {t2 - t1:.2f} s ({len(g)} "
        f"nodes), calibrate+quantize {t3 - t2:.2f} s, fuse {time.perf_counter() - t3:.2f} s")
    requests = [rng.standard_normal((BATCH, 3, IMAGE, IMAGE)).astype(np.float32)
                for _ in range(REQUESTS)]
    totals, launches, _, _, _ = fused_resnet_run("21a.", model, fused, requests, card)
    return totals, launches


def fused_resnet_run(label: str, model: str, fused, requests, card: str):
    """Phases 21a and 22a on a ResNet-50 fused to native's form (asserted):
    every K1/K2/K3 call of one forward == plain and timed, REQUESTS requests
    through TorchExecutor(device='cuda') with the launches counted, every
    integer node == the CPU path, the latency and the busy share.  Returns
    the kernels' per-forward totals, their launches, the recorded calls,
    and the first request's logits on the card and on the CPU path."""
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes

    ops = Counter(n.op for n in fused.nodes if n.op not in ("var", "const"))
    say("fused graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    assert {k: ops[k] for k in ONNX_R50_OPS} == ONNX_R50_OPS, ops
    names = computational_nodes(fused)
    ex = TorchExecutor(fused, capture=names, device="cuda")

    phase(f"{label} {model}: K1, K2 and K3 at the forward's calls: == plain, time, bound, "
          f"library [{card}]")
    calls: list = []
    with recording(calls):
        ex.run_device(requests[0])
    torch.cuda.synchronize()
    totals = check_kernels(calls, RUN_KERNELS, model)

    phase(f"{label} {model}: {REQUESTS} requests through TorchExecutor(device='cuda') [{card}]")
    lat, first_out, launches = timed_requests(ex, requests, RUN_KERNELS, f"the {model} path")
    t0 = time.perf_counter()
    plain = TorchExecutor(fused, capture=names, device="cpu").run(requests[0])
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    n_int = hold_against_plain(names, first_out, plain, fused, FLOAT_RTOL, FLOAT_ATOL)
    out = names.index(fused.outputs[0])
    logits = first_out[out]
    assert logits.shape == (BATCH, 1000) and np.isfinite(logits).all()
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path; logits "
        f"{logits.shape} (max |logit| {np.abs(logits).max():.2f}), float nodes within rtol "
        f"{FLOAT_RTOL} atol {FLOAT_ATOL}")
    med = say_latency(lat, BATCH)
    kernel_ms = sum(t["ms"] for t in totals.values())
    say(f"{'+'.join(RUN_KERNELS)} device ms per forward {kernel_ms:.4f} of {med:.3f} ms end to "
        f"end [{card}]")
    profile_requests(ex, requests[:3], med)
    return totals, launches, calls, logits, plain[out]


def kernels_called(ex, x) -> tuple:
    """The kernel wrappers one run of `ex` on `x` calls, in KERNELS' order."""
    calls: list = []
    with recording(calls):
        ex.run_device(x)
    torch.cuda.synchronize()
    return tuple(k for k in KERNELS if any(c[0] == k for c in calls))


def onnx_fixture_path(name: str, card: str) -> tuple[dict, dict, dict]:
    """Phase 21b for one exporter's fixture: the float graph on the card
    within ROUTE_RTOL / ROUTE_ATOL of the exporter's expected output and of
    the CPU path; int8 and fused, every kernel call == plain and timed, the
    launches counted, every node held as phase 19 holds it (hold_zoo_nodes);
    then a b1 graph (the batch overridden at import) unfused and traced on
    the card (trace_path).  Returns the kernels' totals, launches and
    largest |err|."""
    from tachikoma_tpu_torch.frontend import from_onnx
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    path = os.path.join(ONNX_DIR, f"{name}.onnx")
    io_ = np.load(os.path.join(ONNX_DIR, f"{name}_io.npz"))
    x, expected = io_["x"], io_["expected"]
    phase(f"21b. {path}: float, then int8 fused on the card, input {x.shape} [{card}]")
    t0 = time.perf_counter()
    g = from_onnx(path)
    on_card = TorchExecutor(g, device="cuda").run([x])[0]
    on_cpu = TorchExecutor(g, device="cpu").run([x])[0]
    np.testing.assert_allclose(on_card, expected, rtol=ROUTE_RTOL, atol=ROUTE_ATOL)
    np.testing.assert_allclose(on_card, on_cpu, rtol=ROUTE_RTOL, atol=ROUTE_ATOL)
    say(f"float {sorted({n.op for n in g.nodes} - {'var', 'const'})}: output {on_card.shape}, "
        f"max |card - expected| {np.abs(on_card - expected).max():.3g}, max |card - CPU| "
        f"{np.abs(on_card - on_cpu).max():.3g}")
    fused = fuse_qnn(quantize(g, [x]))
    ops = Counter(n.op for n in fused.nodes if n.op not in ("var", "const"))
    say(f"import, runs, calibrate+quantize+fuse {time.perf_counter() - t0:.2f} s (host); fused "
        "graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    names = computational_nodes(fused)
    ex = TorchExecutor(fused, capture=names, device="cuda")
    calls: list = []
    with recording(calls):
        ex.run_device(x)
    torch.cuda.synchronize()
    kernels = tuple(k for k in KERNELS if any(c[0] == k for c in calls))
    assert kernels, f"{name}: the fused forward ran no kernel"
    totals = check_kernels(calls, kernels, name)
    reset(kernels)
    card_out = [_host(o) for o in ex.run_device(x)]
    launches = read_launches(kernels, f"the fused {name} forward")
    cpu_out = [_host(o) for o in TorchExecutor(fused, capture=names, device="cpu").run_device(x)]
    counts = hold_zoo_nodes(fused, names, card_out, cpu_out, {fused.inputs[0].name: x})
    say(f"{', '.join(f'{k} {n}' for k, n in launches.items())} launches; {counts.get('int', 0)} "
        f"integer nodes == the CPU path, {counts.get('cone_int', 0)} in the float-source set "
        f"== their CPU impl on the card's inputs ({counts.get('cone_int_differing', 0)} differ "
        f"end to end), {counts.get('float', 0) + counts.get('cone_float', 0)} float nodes "
        f"within rtol {GRAPH_RTOL} atol {GRAPH_ATOL}")
    errs = {k: t["max_abs_err"] for k, t in totals.items()}

    inp = g.inputs[0].name
    g1 = from_onnx(path, {inp: (TRACE_BATCH,) + tuple(x.shape[1:])})
    q1 = quantize(g1, [x[:TRACE_BATCH]])
    trace_kernels = kernels_called(TorchExecutor(q1, device="cuda"), x[:TRACE_BATCH])
    trace_totals, trace_launches = trace_path(
        ("21b.", "21b."), f"ONNX {name}", None, trace_kernels, size=f"{x.shape[2]}^2",
        prepared=(q1, x[:TRACE_BATCH]))
    for k, t in trace_totals.items():
        errs[k] = max(errs.get(k, 0), t["max_abs_err"])
    for k, n in trace_launches.items():
        launches[k] = launches.get(k, 0) + n
    return totals, launches, errs


def onnx_ops_on_card(card: str) -> None:
    """Phase 21c: each of the ONNX importer's 53 ops on the card against its
    CPU torch impl, on the cases of tests/onnx_op_cases.py (the JAX
    package's op tests' shapes and the named trouble spots): integers,
    indices, bools and the exact float ops ==, the others within OP_RTOL /
    OP_ATOL."""
    from tachikoma_tpu_torch.ir.graph import Node
    from tachikoma_tpu_torch.ir.registry import get_op

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from onnx_op_cases import CASES

    phase(f"21c. the ONNX importer's ops on the card against their CPU torch impls: "
          f"{len(CASES)} cases [{card}]")
    per_op: dict = {}
    for cid, op, inputs, attrs, tol, _, _, _ in CASES:
        node = Node("y", op, tuple(f"x{i}" for i in range(len(inputs))), attrs)
        impl = get_op(op).torch_impl
        got = impl(*(torch.from_numpy(v).cuda() for v in inputs), node=node)
        want = impl(*map(torch.from_numpy, inputs), node=node)
        got, want = (v if isinstance(v, list) else [v] for v in (got, want))
        err = 0.0
        for a, b in zip(got, want):
            a = a.cpu().numpy()
            b = b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, cid
            if tol is True or b.dtype.kind in "iub":
                np.testing.assert_array_equal(a, b, err_msg=cid)
            else:
                np.testing.assert_allclose(a, b, rtol=OP_RTOL, atol=OP_ATOL, err_msg=cid)
                both = np.isfinite(a) & np.isfinite(b)
                if both.any():
                    err = max(err, float(np.abs(a[both].astype(np.float64) - b[both]).max()))
        cases, exact, worst = per_op.get(op, (0, True, 0.0))
        per_op[op] = (cases + 1, exact and (tol is True), max(worst, err))
    for op, (cases, exact, worst) in sorted(per_op.items()):
        say(f"  {op:24s} {cases:2d} cases  "
            + ("==" if exact else f"max |card - CPU| {worst:.3g} (rtol {OP_RTOL} atol {OP_ATOL})"))
    assert len(per_op) == 53, sorted(per_op)
    say(f"{len(per_op)} ops, {len(CASES)} cases held")


def onnx_cli(card: str) -> None:
    """Phase 21d: `python -m tachikoma_tpu_torch.cli run` on an .onnx
    fixture on the card (the CLI's default device), its output within
    ROUTE_RTOL / ROUTE_ATOL of the exporter's expected output."""
    name = "darknet_route"
    path = os.path.join(ONNX_DIR, f"{name}.onnx")
    io_ = np.load(os.path.join(ONNX_DIR, f"{name}_io.npz"))
    phase(f"21d. python -m tachikoma_tpu_torch.cli run {path} (device cuda) [{card}]")
    tdir = tempfile.mkdtemp(prefix="tk_chip_smoke_onnx_")
    xin, out = os.path.join(tdir, "x.npy"), os.path.join(tdir, "y.npz")
    np.save(xin, io_["x"])
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "tachikoma_tpu_torch.cli", "run", path,
                          "--input", xin, "-o", out], capture_output=True, text=True,
                         timeout=300)
    say(res.stdout.strip().splitlines()[0] if res.stdout.strip() else "(no output)")
    assert res.returncode == 0, res.stderr[-2000:]
    got = np.load(out)
    y = got[got.files[0]]
    np.testing.assert_allclose(y, io_["expected"], rtol=ROUTE_RTOL, atol=ROUTE_ATOL)
    say(f"exit 0 in {time.perf_counter() - t0:.2f} s; {got.files[0]} {y.shape} within rtol "
        f"{ROUTE_RTOL} atol {ROUTE_ATOL} of the exporter's expected output (max |diff| "
        f"{np.abs(y - io_['expected']).max():.3g})")
    for f in (xin, out):
        os.remove(f)
    os.rmdir(tdir)


def onnx_path(card: str) -> tuple[dict, dict, dict]:
    """Phase 21: the ONNX import path (21a-21d).  Returns the kernels' totals
    (ResNet-50's), their launches over 21a and 21b's counted runs, and the
    largest |err| of each."""
    totals, launches = onnx_resnet_path(card)
    errs = {k: t["max_abs_err"] for k, t in totals.items()}
    for name in ONNX_FIXTURES:
        _, fx_launches, fx_errs = onnx_fixture_path(name, card)
        for k, e in fx_errs.items():
            errs[k] = max(errs.get(k, 0), e)
        for k, n in fx_launches.items():
            launches[k] = launches.get(k, 0) + n
    onnx_ops_on_card(card)
    onnx_cli(card)
    return totals, launches, errs


# ---------------------------------------------------------------------------
# the PyTorch import path and FQ2I (phase 22)
# ---------------------------------------------------------------------------

TORCH_CALIB_BATCH = 2             # torch.ao's calibration batch (b2 224^2)
# 22c's float logits: rtol GRAPH_RTOL and this atol, 2.6x the largest float32
# distance of models/torch_resnet.py's ResNet-50 at b8 224^2 on an H100 (the
# card against the CPU path 9.7e-4, against torch eager on the card 8.2e-4):
# float32's error at its pooled features' scale of 10^3, which the fc's
# projection cancels out of the logits (near 10^2) but not out of the sums
# (tests/test_torch_port_torch_fx.py, tests/test_torch_port_cuda.py hold it too)
R50_FLOAT_ATOL = 2.5e-3
EVAL_IMAGES = 64                  # 22e's synthetic images
CLI_EVAL_IMAGES = 16              # 22e's `cli evaluate` dataset


def hold_calls(calls: list) -> dict:
    """Every recorded kernel call == its plain version; the largest |err|
    of each kernel."""
    impl, errs = kernel_impls(), {}
    for name, a, k in calls:
        errs[name] = max(errs.get(name, 0), hold_call(name, a, k, impl))
    return errs


def counted_forward(ex, x, kernels, what: str) -> tuple[list, dict, dict]:
    """One forward of `ex` with the kernels' counts set to 0 just before and
    read just after (each must have launched), every call recorded and then
    held == plain.  Returns the captured outputs (host), the launches and
    each kernel's largest |err|."""
    reset(kernels)
    calls: list = []
    with recording(calls):
        outs = [_host(o) for o in ex.run_device(x)]
    launches = read_launches(kernels, what)
    errs = hold_calls(calls)
    say(f"{what}: " + ", ".join(f"{k} {n} launches" for k, n in launches.items())
        + f"; {len(calls)} kernel calls, all == plain")
    return outs, launches, errs


def torch_ao_resnet_path(card: str) -> tuple[dict, dict, dict]:
    """Phase 22a: ResNet-50 of models/torch_resnet.py quantized by torch.ao
    (fbgemm) on the host, imported at b8 224^2 with import_torch_quantized
    and fused to native ResNet-50's form, then run by fused_resnet_run; the
    logits == the CPU path; its distance from torch's eager quantized
    model.  Returns the kernels' per-forward
    totals, their launches and the path's state."""
    from tachikoma_tpu_torch.frontend.torch_quantized import import_torch_quantized
    from tachikoma_tpu_torch.models.torch_resnet import quantize_fx, resnet50_torch
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    model = f"torch.ao ResNet-50 b{BATCH} {IMAGE}^2"
    phase(f"22a. {model}: models/torch_resnet.py (seed {SEED}), torch.ao prepare_fx / calibrate "
          f"b{TORCH_CALIB_BATCH} / convert_fx (fbgemm), import_torch_quantized, fuse (host) [{card}]")
    t0 = time.perf_counter()
    float_model = resnet50_torch(seed=SEED)
    t1 = time.perf_counter()
    mq = quantize_fx(float_model, (TORCH_CALIB_BATCH, 3, IMAGE, IMAGE), seed=SEED)
    t2 = time.perf_counter()
    g = import_torch_quantized(mq, {"x": (BATCH, 3, IMAGE, IMAGE)})
    t3 = time.perf_counter()
    fused = fuse_qnn(g)
    say(f"build {t1 - t0:.2f} s, torch.ao quantize {t2 - t1:.2f} s, import_torch_quantized "
        f"{t3 - t2:.2f} s ({len(g)} nodes), fuse {time.perf_counter() - t3:.2f} s")
    stem = next(n for n in fused.nodes if n.op == "tk.conv2d_rq")
    stack = next(n for n in fused.nodes if n.op == "tk.conv2d_block_stack")
    res = stack.attrs["blocks"][0]["res_add"]
    say(f"zero points: stem {stem.name} (7x7 s2) input {stem.attrs['input_zero_point']}, output "
        f"{stem.attrs['output_zero_point']}; block stack {stack.name}: first conv's input "
        f"{stack.attrs['blocks'][0]['stages'][0]['input_zero_point']}, residual add lhs "
        f"{res['lhs_zero_point']} rhs {res['rhs_zero_point']} output "
        f"{res['output_zero_point']} (clip from {res['a_min']})")
    rng = np.random.default_rng(SEED)
    requests = [rng.standard_normal((BATCH, 3, IMAGE, IMAGE)).astype(np.float32)
                for _ in range(REQUESTS)]
    totals, launches, calls, logits, cpu_logits = fused_resnet_run("22a.", model, fused,
                                                                   requests, card)
    assert np.array_equal(logits, cpu_logits), "the logits differ from the CPU path"
    say("the logits == the CPU path")
    # the K2 / K3 wrappers fold the input zero point into the bias on every
    # call (ops/kernels/matmul_int8.py fold_input_zero_point, four torch
    # launches), inside the times above; phase 21a's calls have izp 0
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import fold_input_zero_point

    fold: dict = {}
    for name, a, k in calls:
        if name in ("qconv_rq", "qconv_rq_res") and k.get("izp", 0):
            fold[name] = fold.get(name, 0.0) + graph_ms(
                lambda a=a, k=k: fold_input_zero_point(a[2], a[1], k["izp"]))
    say("the input zero point's fold into the bias inside the K2 / K3 wrappers, device ms a "
        "forward: " + ", ".join(f"{n} {v:.4f} of {totals[n]['ms']:.4f}"
                                for n, v in fold.items()) + f" [{card}]")
    t0 = time.perf_counter()
    with torch.no_grad():
        eager = mq(torch.from_numpy(requests[0])).numpy()
    scale = float(mq.fc.scale)
    top1, eager_top1 = logits.argmax(-1), eager.argmax(-1)
    say(f"torch eager quantized model (host, engine {torch.backends.quantized.engine}) "
        f"{time.perf_counter() - t0:.2f} s: max |logits - eager| {np.abs(logits - eager).max():.4g}"
        f" = {np.abs(logits - eager).max() / scale:.2f} output quanta (fc scale {scale:.6g}); "
        f"top-1 agreement {(top1 == eager_top1).mean():.3f} ({int((top1 == eager_top1).sum())} "
        f"of {BATCH}; {len(set(top1))} distinct top-1 classes here, {len(set(eager_top1))} in "
        f"eager); printed, not held")
    state = dict(float_model=float_model, mq=mq, fused=fused, requests=requests)
    return totals, launches, state


def torch_float_path(card: str, state: dict) -> tuple[dict, dict]:
    """Phase 22c: the float module through from_torch: its b8 forward on the
    card within GRAPH_RTOL and R50_FLOAT_ATOL of torch eager on the card and
    of the CPU path; then quantized and fused (native ResNet-50's form), one
    counted b8 forward, every kernel call == plain and every integer node
    == the CPU path.  Returns the launches and the largest |err|s; `state`
    gets the float and quantized graphs."""
    from tachikoma_tpu_torch.frontend import from_torch
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    float_model, x = state["float_model"], state["requests"][0]
    model = f"float ResNet-50 b{BATCH} {IMAGE}^2 (from_torch)"
    phase(f"22c. {model}: the card against torch eager on the card and the CPU path [{card}]")
    t0 = time.perf_counter()
    gf = from_torch(float_model, {"x": (BATCH, 3, IMAGE, IMAGE)})
    ops = Counter(n.op for n in gf.nodes)
    say(f"from_torch {time.perf_counter() - t0:.2f} s: {len(gf)} nodes, {ops['nn.conv2d']} "
        f"nn.conv2d, {ops['nn.batch_norm']} nn.batch_norm, {ops['nn.dense']} nn.dense")
    on_card = TorchExecutor(gf, device="cuda").run(x)[0]
    on_cpu = TorchExecutor(gf, device="cpu").run(x)[0]
    with torch.no_grad():
        eager = float_model.cuda()(torch.from_numpy(x).cuda()).cpu().numpy()
    float_model.cpu()
    say(f"logits {on_card.shape}: max |card - torch eager on the card| "
        f"{np.abs(on_card - eager).max():.3g}, max |card - CPU| "
        f"{np.abs(on_card - on_cpu).max():.3g}; max |logit| {np.abs(eager).max():.2f}; held at "
        f"rtol {GRAPH_RTOL}, atol {R50_FLOAT_ATOL} (TF32 off); elements beyond atol "
        f"{GRAPH_ATOL} + rtol {GRAPH_RTOL}: "
        f"{int((np.abs(on_card - eager) > GRAPH_ATOL + GRAPH_RTOL * np.abs(eager)).sum())} "
        f"of {eager.size}")
    np.testing.assert_allclose(on_card, eager, rtol=GRAPH_RTOL, atol=R50_FLOAT_ATOL)
    np.testing.assert_allclose(on_card, on_cpu, rtol=GRAPH_RTOL, atol=R50_FLOAT_ATOL)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    q = quantize(gf, [rng.standard_normal((BATCH, 3, IMAGE, IMAGE)).astype(np.float32)])
    fused = fuse_qnn(q)
    fops = Counter(n.op for n in fused.nodes)
    say(f"calibrate+quantize+fuse {time.perf_counter() - t0:.2f} s (host): "
        + ", ".join(f"{fops[k]} {k}" for k in ONNX_R50_OPS))
    assert {k: fops[k] for k in ONNX_R50_OPS} == ONNX_R50_OPS, fops
    names = computational_nodes(fused)
    outs, launches, errs = counted_forward(TorchExecutor(fused, capture=names, device="cuda"),
                                           x, RUN_KERNELS, f"the quantized {model} forward")
    plain = TorchExecutor(fused, capture=names, device="cpu").run(x)
    n_int = hold_against_plain(names, outs, plain, fused, FLOAT_RTOL, FLOAT_ATOL)
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path")
    state.update(float_graph=gf, quantized_float=q)
    return launches, errs


def fq2i_onnx_path(card: str) -> tuple[dict, dict]:
    """Phase 22d: the three QDQ ONNX models of tests/test_fq2i.py, written
    with the port's encoder (tests/torch_import_cases.py): from_onnx,
    fq2i, fuse; no float product left; on the card, every kernel call ==
    plain and every node == the CPU path.  Returns the launches and the
    largest |err|s."""
    from tachikoma_tpu_torch.frontend import from_onnx
    from tachikoma_tpu_torch.quantize.fq2i import fq2i
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_import_cases import QDQ_CASES

    phase(f"22d. FQ2I on QDQ ONNX models: from_onnx, fq2i, fuse, the card == the CPU path "
          f"[{card}]")
    launches, errs = {}, {}
    for name, build in sorted(QDQ_CASES.items()):
        model, shape = build(np.random.default_rng(0))
        g = from_onnx(model)
        ig = fq2i(g)
        fused = fuse_qnn(ig)
        ops = [n.op for n in fused.nodes if n.op not in ("var", "const")]
        assert not {"nn.conv2d", "nn.dense", "nn.matmul", "nn.batch_matmul"} & set(ops), ops
        names = computational_nodes(fused)
        x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
        ex = TorchExecutor(fused, capture=names, device="cuda")
        kernels = kernels_called(ex, x)
        assert kernels, f"{name}: the fused graph ran no kernel"
        outs, n_launch, n_errs = counted_forward(ex, x, kernels, f"{name} {shape}")
        cpu = TorchExecutor(fused, capture=names, device="cpu").run(x)
        for nm, a, b in zip(names, outs, cpu):
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{name}: {nm} != the CPU path"
        say(f"  {name}: QDQ graph {len(g)} nodes -> fused {' -> '.join(ops)}; {len(names)} "
            f"nodes == the CPU path")
        for k, n in n_launch.items():
            launches[k] = launches.get(k, 0) + n
        for k, e in n_errs.items():
            errs[k] = max(errs.get(k, 0), e)
    return launches, errs


def torch_eval_path(card: str, state: dict) -> None:
    """Phase 22e: quantization_report of 22c's float and quantized graphs on
    one b8 batch (the numpy oracle), eval_topk of 22c's float graph against
    22a's int8 graph on EVAL_IMAGES synthetic images on the card, and the
    CLI's `run` on a saved (model, shape) .pt of 22a's model and `evaluate`
    of the float and int8 .pt files on a dataset .npz (on the card, the
    CLI's default)."""
    from tachikoma_tpu_torch.quantize.accuracy import eval_topk
    from tachikoma_tpu_torch.quantize.dataset import Dataset, synthetic_images
    from tachikoma_tpu_torch.quantize.evaluate import quantization_report
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    phase(f"22e. evaluation: quantization_report (b{BATCH}, the numpy oracle), eval_topk "
          f"({EVAL_IMAGES} synthetic images on the card), the CLI's run and evaluate [{card}]")
    t0 = time.perf_counter()
    rep = quantization_report(state["float_graph"], state["quantized_float"],
                              state["requests"][0])
    say(f"quantization_report {time.perf_counter() - t0:.2f} s (host): {len(rep.layers)} layers")
    for line in rep.table(worst=5).splitlines():
        say("  " + line)
    t0 = time.perf_counter()
    ds = synthetic_images(EVAL_IMAGES, (IMAGE, IMAGE, 3), seed=SEED)
    ds = Dataset(np.ascontiguousarray(ds.data.transpose(0, 3, 1, 2)), None, ds.name)
    t1 = time.perf_counter()
    acc = eval_topk(state["float_graph"], state["fused"], ds, executor="torch", device="cuda",
                    name="torch.ao")
    say(f"synthetic_images {t1 - t0:.2f} s (host); eval_topk {time.perf_counter() - t1:.2f} s: "
        f"{acc.row()}")
    assert acc.n == EVAL_IMAGES
    ex = TorchExecutor(state["float_graph"], device="cuda")
    top1 = np.concatenate([ex.run([chunk])[0][:valid].argmax(-1)
                           for chunk, valid in ds.batches(BATCH)])
    say(f"the float graph's top-1 class over the {EVAL_IMAGES} images: {len(set(top1))} "
        f"distinct classes (the agreement above can move)")

    tdir = tempfile.mkdtemp(prefix="tk_chip_smoke_torch_")
    int8_pt, float_pt = os.path.join(tdir, "r50_int8.pt"), os.path.join(tdir, "r50_float.pt")
    data = os.path.join(tdir, "images.npz")
    torch.save((state["mq"], (BATCH, 3, IMAGE, IMAGE)), int8_pt)
    torch.save((state["float_model"], (BATCH, 3, IMAGE, IMAGE)), float_pt)
    np.savez(data, data=ds.data[:CLI_EVAL_IMAGES])
    try:
        for args in (["run", int8_pt],
                     ["evaluate", float_pt, int8_pt, "--dataset", data, "--samples",
                      str(CLI_EVAL_IMAGES)]):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "tachikoma_tpu_torch.cli", *args],
                                 capture_output=True, text=True, timeout=300)
            lines = res.stdout.strip().splitlines()
            say(f"cli {args[0]} (device cuda): exit {res.returncode} in "
                f"{time.perf_counter() - t0:.2f} s; " + (lines[0] if lines else "(no output)"))
            assert res.returncode == 0, res.stderr[-2000:]
    finally:
        for f in (int8_pt, float_pt, data):
            if os.path.exists(f):
                os.remove(f)
        os.rmdir(tdir)


def torch_path(card: str) -> tuple[dict, dict]:
    """Phase 22 (22a-22e).  Returns each kernel's launches over 22a-22d's
    counted runs and its largest |err|."""
    from tachikoma_tpu_torch.frontend.torch_quantized import import_torch_quantized

    totals, launches, state = torch_ao_resnet_path(card)
    errs = {k: t["max_abs_err"] for k, t in totals.items()}

    def merge(part_launches, part_errs):
        for k, n in part_launches.items():
            launches[k] = launches.get(k, 0) + n
        for k, e in part_errs.items():
            errs[k] = max(errs.get(k, 0), e)

    g1 = import_torch_quantized(state["mq"], {"x": (TRACE_BATCH, 3, IMAGE, IMAGE)})
    trace_totals, trace_launches = trace_path(
        ("22b.", "22b."), "torch.ao ResNet-50", None, TRACE_KERNELS,
        prepared=(g1, state["requests"][0][:TRACE_BATCH]))
    merge(trace_launches, {k: t["max_abs_err"] for k, t in trace_totals.items()})
    merge(*torch_float_path(card, state))
    merge(*fq2i_onnx_path(card))
    torch_eval_path(card, state)
    return launches, errs


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tachikoma_tpu_torch.models.transformer import bert_base, gpt2_small, vit_b16
    from tachikoma_tpu_torch.models.vision import mobilenet_v2, resnet, vgg
    from tachikoma_tpu_torch.ops.kernels import _lib
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("TK_TUNE_DB", None)  # every phase names its database, or none

    phase("1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    precision = torch.get_float32_matmul_precision()
    say(f"float32 matmul precision {precision}, TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, TF32 cuDNN {torch.backends.cudnn.allow_tf32}")
    assert precision == "highest", precision
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()

    phase("2. kernel build (nvcc, sm_90a, one process per source)")
    seconds, log = _lib.build(verbose=True)
    say(f"build seconds {seconds:.1f}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say(line.strip())
    # the launchers' once-per-kernel statics stay local to each library
    # (-fno-gnu-unique): no STB_GNU_UNIQUE ('u') symbol in any of them
    for lib in sorted(_lib.BUILD_DIR.glob("*.so")):
        syms = subprocess.run(["nm", "-D", str(lib)], capture_output=True, text=True,
                              check=True).stdout.splitlines()
        unique = [ln for ln in syms if ln.split()[-2:-1] == ["u"]]
        assert not unique, f"{lib.name}: GNU-unique symbols {unique[:3]}"
    say("nm -D: no GNU-unique symbol in " + ", ".join(p.name for p in
                                                      sorted(_lib.BUILD_DIR.glob("*.so"))))

    def r50(batch):
        return resnet(50, batch_size=batch, image_size=IMAGE, seed=SEED)

    def mbv2(batch):
        return mobilenet_v2(batch_size=batch, image_size=IMAGE, seed=SEED)

    def vgg16(batch):
        return vgg(16, batch_size=batch, image_size=IMAGE, seed=SEED)

    totals, launches, r50_state = run_path(("3.", "4.", "5.", "6."), "ResNet-50", r50,
                                           RUN_KERNELS)
    trace_totals, trace_launches = trace_path(("7.", "8."), "ResNet-50", r50, TRACE_KERNELS)
    totals.update(trace_totals)
    launches.update(trace_launches)
    errs = {k: t["max_abs_err"] for k, t in totals.items()}

    def merge(path_totals, path_launches):
        for name, t in path_totals.items():
            errs[name] = max(errs.get(name, 0), t["max_abs_err"])
            totals.setdefault(name, t)
        for name, n in path_launches.items():
            launches[name] = launches.get(name, 0) + n

    mbv2_totals, mbv2_launches, mbv2_state = run_path(("9a.", "9b.", "9c.", "9d."),
                                                      "MobileNetV2", mbv2, MBV2_RUN_KERNELS)
    merge(mbv2_totals, mbv2_launches)
    merge(*trace_path(("10a.", "10b."), "MobileNetV2", mbv2, MBV2_TRACE_KERNELS))
    merge({}, fixture_path())

    transformers = (
        ("12", "BERT-base b4 s128", lambda: bert_base(batch_size=4, seq_len=128, seed=SEED),
         lambda rng: rng.integers(0, 30522, (4, 128)).astype(np.int32), False, "sequences"),
        ("13", "GPT-2 small b1 s128", lambda: gpt2_small(batch_size=1, seq_len=128, seed=SEED),
         lambda rng: rng.integers(0, 50257, (1, 128)).astype(np.int32), True, "sequences"),
        ("14", f"ViT-B/16 b{BATCH} {IMAGE}^2",
         lambda: vit_b16(batch_size=BATCH, image_size=IMAGE, seed=SEED),
         lambda rng: rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32), False,
         "images"))
    launches["flash_attn"], errs["flash_attn"] = 0, 0.0
    for label, model, build, make_input, causal, unit in transformers:
        fa, n = transformer_path(label, model, build, make_input, causal, unit)
        totals.setdefault("flash_attn", fa)  # BERT-base's, per forward
        launches["flash_attn"] += n
        errs["flash_attn"] = max(errs["flash_attn"], fa["max_abs_err"])
        if label == "12":
            errs["flash_attn"] = max(errs["flash_attn"], k6_reference_shapes())
    r50_state["card"] = card
    tune_totals, tune_launches = tune_path(r50_state)
    for name, t in tune_totals.items():
        totals[name], errs[name] = t, t["max_abs_err"]
    for name, n in tune_launches.items():
        launches[name] = launches.get(name, 0) + n

    t16 = time.perf_counter()
    vgg_totals, vgg_launches, vgg_state = run_path(("16a.1", "16a.2", "16a.3", "16a.4"), "VGG-16",
                                                   vgg16, VGG_RUN_KERNELS)
    ops = Counter(n.op for n in vgg_state["fused"].nodes)
    assert ops["tk.conv2d_chain"] == 5 and ops["tk.dense_rq"] == 3, ops
    merge(vgg_totals, vgg_launches)
    direct_totals, direct_launches = direct_path(vgg_state, r50_state, mbv2_state)
    for name, t in direct_totals.items():
        totals[name], errs[name] = t, t["max_abs_err"]
    merge({}, direct_launches)
    merge({}, graph_tune_path(vgg_state))
    say(f"\nphase 16 seconds {time.perf_counter() - t16:.1f} (host clock)")

    t17 = time.perf_counter()
    bert_totals, bert_launches = int8_bert_path()
    for name, t in bert_totals.items():
        errs[name] = max(errs.get(name, 0), t["max_abs_err"])
    totals["qbmm_rq"] = bert_totals["qbmm_rq"]
    merge({}, bert_launches)
    bert_trace_totals, bert_trace_launches = trace_path(
        ("17e.", "17e."), "BERT-base", lambda b: bert_base(batch_size=b, seq_len=SEQ, seed=SEED),
        INT8_TRACE_KERNELS, make_input=bert_ids(TRACE_BATCH), config=TRANSFORMER_INT8,
        size=f"s{SEQ}")
    for name, t in bert_trace_totals.items():
        errs[name] = max(errs.get(name, 0), t["max_abs_err"])
    totals["qbmm_raw"] = bert_trace_totals["qbmm_raw"]
    merge({}, bert_trace_launches)
    merge({}, int8_transformer_check(
        "17f.", f"GPT-2 small b1 s{SEQ}", lambda: gpt2_small(batch_size=1, seq_len=SEQ, seed=SEED),
        lambda rng: rng.integers(0, 50257, (1, SEQ)).astype(np.int32)))
    merge({}, int8_transformer_check(
        "17f.", f"ViT-B/16 b{BATCH} {IMAGE}^2",
        lambda: vit_b16(batch_size=BATCH, image_size=IMAGE, seed=SEED),
        lambda rng: rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)))
    say(f"\nphase 17 seconds {time.perf_counter() - t17:.1f} (host clock)")
    t18 = time.perf_counter()
    decode_totals, decode_launches = decode_path(card)
    for name, t in decode_totals.items():
        errs[name] = max(errs.get(name, 0), t["max_abs_err"])
    merge({}, decode_launches)
    say(f"\nphase 18 seconds {time.perf_counter() - t18:.1f} (host clock)")
    t19 = time.perf_counter()
    zoo_totals, zoo_launches, _ = vision_zoo(card)
    for name, t in zoo_totals.items():
        errs[name] = max(errs.get(name, 0), t["max_abs_err"])
    merge({}, zoo_launches)
    say(f"\nphase 19 seconds {time.perf_counter() - t19:.1f} (host clock)")
    t20 = time.perf_counter()
    tflite_totals, tflite_launches, tflite_errs = tflite_path(card)
    wide_totals, wide_launches, wide_errs = w8a16_path(card)
    for part in (tflite_errs, wide_errs):
        for name, e in part.items():
            errs[name] = max(errs.get(name, 0), e)
    totals["wide_planes"] = wide_totals["wide_planes"]
    launches["wide_planes"] = 0
    merge({}, tflite_launches)
    merge({}, wide_launches)
    say(f"\nphase 20 seconds {time.perf_counter() - t20:.1f} (host clock)")
    t21 = time.perf_counter()
    _, onnx_launches, onnx_errs = onnx_path(card)
    for name, e in onnx_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    merge({}, onnx_launches)
    say(f"\nphase 21 seconds {time.perf_counter() - t21:.1f} (host clock) [{card}]")
    t22 = time.perf_counter()
    torch_launches, torch_errs = torch_path(card)
    for name, e in torch_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    merge({}, torch_launches)
    say(f"\nphase 22 seconds {time.perf_counter() - t22:.1f} (host clock) [{card}]")
    say(f"card: {card}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": totals[name]["ms"],
         "plain_ms": totals[name]["plain_ms"], "bound_ms": totals[name]["bound_ms"],
         "bound_by": totals[name]["bound_by"], "library_ms": totals[name]["library_ms"]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

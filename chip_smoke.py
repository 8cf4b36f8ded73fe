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
on qgemm_wide / qconv_wide, the int64 products' own kernel; the 16x8
fixture, its depthwise conv on K5's int16 mode), and the ONNX import path
(ResNet-50 b8 written as torch.onnx.export writes it, fused on K1-K3; the
six exporters' fixtures float, int8 and traced; the importer's 53 ops), and
the PyTorch import path and FQ2I (a torch.ao-quantized ResNet-50 b8 on
K1-K3 at its own zero points, traced at b1 on K4; the float module through
from_torch; FQ2I'd QDQ ONNX models; the evaluation modules and the CLI's
.pt and evaluate), and the segmented executor and the rest of item 13's
executors (int8 ViT-L/16 b1 224^2 with layer-tied scales run as a scan over
stacked layers on K1, K4, qbmm_rq and K2; the segmented trace backend on
int8 GPT-2 small; the "torch-cpu" calibration; the CLI's run --segmented and
profile; placement and shape buckets), and data-dependent shapes, control
flow and quantization-aware training (int8 ResNet-50 b8 with a per-request
top-k head through the dispatch-time specializer on K1-K3; tk.cond and
tk.while_loop over its pooled int8 features on K4; every dyn.* op; a
fake-quant ResNet-50 b8 trained on the card through torch autograd and
finalized to int8 on K1-K3), and the TensorFlow and Keras import path (a
Keras-layout ResNet-50 b8 .pb read by the in-tree GraphDef codec, fused on
K1 and K2, traced at b1 on K4, run through the CLI; the six ops the
importer brought), and parallel/* over torch.distributed (int8 ResNet-50
b8 sharded dp x tp over four rank processes on the one card over gloo on
K4, with int32 all-reduces; NCCL at world size 1; the tp-sharded b1 trace
and the trace collector's merge byte-equal to the single card's; a
two-stage pipeline; int8 ring attention on K1's batched mode; MoE on K4),
and dilated and grouped int8 convs on K2 and K4's conv mode
(DeepLabV3-ResNet-50 b1 520^2 at output stride 8 through ONNX, ResNeXt-50
32x4d b8 224^2 through torch.fx, fused, unfused and traced), and legacy
uint8 TFLite models (MobileNetV2 1.0 b8 224^2 laid out as TF1's converter
writes it, uint8 data, weights and outputs at nonzero weight zero points, on
K1, K2 and K5; its b1 trace on K4 and K5; K5 with dilation at
DeepLab-MobileNetV2's atrous depthwise calls).

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
     warm call, two timed), the counts are read (both K4 modes must have
     launched), no weight is packed K-major during the timed calls, the
     trace is held record by record against the CPU plain path's trace
     (integer records byte-equal, float records allclose), its CRCs checked
     natively and every record re-executed by verify_trace;
  9. MobileNetV2 b8 224^2 (the JAX package's zoo model, width 1.0, random
     weights from the seed): phases 3-6 again -- K5 qdwconv_rq at its 17
     calls (each printed with its tile, per call and per forward beside the
     first design's time) and K1/K2 at their MobileNetV2 shapes held == plain
     and timed, 12 requests with every kernel of the path launched, every
     integer node == the CPU plain path, latency, images/s and the device's
     busy time a request beside the earlier tree's;
 10. MobileNetV2 b1 224^2 unfused: phases 7-8 again -- K5 qdwconv_raw (each
     call with its tile and the first design's time) and K4 held == plain and
     timed (each GEMM-mode call with its plan and the previous design's
     time), the trace emitted on the card (1 warm + 2 timed) with both K4
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
     plan; (c) 12 requests through TorchExecutor(fuse=True, device="cuda")
     with the counts set to 0 and read, no weight packed during them, every
     integer node == the CPU path, the median latency and sequences/s; (d)
     device time by kernel and the busy share; (e) the trace path at b1
     s128, unfused: every K4 and qbmm_raw call == plain and timed, the
     trace emitted on the card (1 warm, 2 timed, no weight packed during
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
     == plain and timed beside its bound and library call; 12 requests
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
     and timed beside its bound and library call, 12 requests on the batch
     fixture's 16 images (launches counted), every integer node == the CPU
     path, the int8 output within one quantum of the TFLite interpreter's
     goldens and top-1 16 of 16, latency, images/s and the busy share; the
     default import's nodes == the CPU path, top-1 16 of 16; (b) the same
     model b1 unfused: K4 and K5's raw mode == plain, the trace emitted on
     the card, held against the CPU's, CRCs and verify_trace; (c) ResNet-50
     quantized W8A16 (int16 activations, int64 accumulators; seed 0, numpy
     calibration outside the timed windows) b8 224^2, unfused: every int64
     product (qgemm_wide for the 1x1 stride-1 convs and the dense,
     qconv_wide for the others: one wgmma pass over the int16 activations'
     two byte planes, csrc/qconv_wide_hopper.cu) == its float64 plain
     version and timed beside its bound and the float64 cuBLAS / cuDNN call
     of the same shapes, no K4 / K5 launch, 12 requests, every integer node
     == the CPU path, the probabilities within phase 5's tolerance, latency
     and the busy share; (d) its b1 trace on the card, held against the
     CPU's trace, CRCs and verify_trace; (e) the 16x8 TFLite fixture on the
     card (qgemm_wide, qconv_wide and its depthwise conv on qdwconv_wide,
     K5's int16 mode; each call == plain and timed, no K4 / K5 launch):
     every call == plain, integers == the CPU path, the float output within
     2^-15 of the interpreter's;
 21. the ONNX import path: (a) ResNet-50 b8 224^2 written as
     torch.onnx.export lays out torchvision's model (models/onnx_resnet.py:
     batch norms folded into the convs, NCHW input, weights from the seed)
     with the port's encoder, imported with from_onnx, calibrated,
     quantized and fused, its fused op counts asserted (14 tk.conv2d_rq, 1
     tk.conv2d_chain, 4 tk.conv2d_block_stack, 1 tk.dense_rq: native
     ResNet-50's); every K1/K2/K3 call == plain and timed, 12 requests with
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
     K1/K2/K3 call == plain and timed, 12 requests with the launches counted,
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
 23. the segmented executor and the rest of item 13's executors: (a) int8
     ViT-L/16 b1 224^2 (24 blocks, hidden 1024, 16 heads, FFN 4096, 197
     tokens; seed 0) calibrated by the oracle on one image, quantized with
     TRANSFORMER_INT8_SCAN (layer-tied scales) and fused, run by
     SegmentedExecutor at its defaults (min_ops 48, max_ops 640,
     min_scan_layers 3): its partition asserted to the JAX package's (13
     segments, 3 programs, the scan run (1, 11, 0)), the device bytes at
     construction (the scan's stacks, the other segments' params, nothing
     else); one segmented forward recorded, every K1 / K4 / qbmm_rq / K2
     call == plain and each distinct shape timed beside its bound and
     library call; 10 requests through the segmented executor (the scan:
     each layer's params views of the stacks, made once, no weight packed
     during them) and 10 through TorchExecutor, counted, both medians; the
     scan's logits == the whole graph's, every node of the segmented
     executor (every node captured: no scan) == the whole graph's and the
     integer ones == the CPU plain path; the busy share; (b) int8 GPT-2 small
     b1 s128 (TRANSFORMER_INT8_SCAN, unfused) traced on the card through
     the "torch-segmented" backend, its K4 and qbmm_raw calls == plain, the
     file byte-equal to the "torch" backend's trace, CRCs and verify_trace;
     (c) the "torch-cpu" calibration of the float ViT-L (the segmented
     executor on the host, streamed): every scale within 1e-4 relative of
     the oracle's; the CLI's `run --segmented`, `profile --mode ablate` and
     `profile --mode isolated --top 10` on the saved int8 ResNet-50 b8
     graph of phase 3, on the card; (d) phase 17's int8 BERT-base b4 s128
     with its embedding lookup on the host (HeterogeneousExecutor, devices
     ("cuda:0", "cpu")): one transfer a request, the outputs == the
     single-device executor on the card, both latencies; (e) int8 ResNet-50
     224^2 through BucketedExecutor (buckets 1, 2, 4, 8) at batches 1, 3
     and 8: rows == TorchExecutor at the true batch on the card, latencies.
     The phase's host seconds are printed.
 24. data-dependent shapes, control flow and quantization-aware training:
     (a) phase 3's int8 ResNet-50 b8 224^2 with a dyn.topk (axis -1, both)
     on its int8 logits, k an int32 input (tests/runtime_cases.py
     with_topk_head), fused (14 / 1 / 4 / 1 and the dyn.topk), run through
     a new DynShapeExecutor(device="cuda") at k = 1, 5, 10, 5: three
     specializations and a hit, each miss's fold / infer / build host
     seconds, every K1-K3 call of the first request == plain (the bytes its
     recorded tensors held), every output == the CPU path (probabilities
     within the softmax tolerance) and == the graph with k a static topk;
     the device bytes at construction (the weights, once), after the first
     request (the weights, their K-major packs, the rest), and no pack and
     no byte more from the second request on; the int8 logits' count of
     -128; 20 hits and 20 requests of TorchExecutor on the static graph in
     turns, both medians and their ratio, no weight packed;
     (b) ResNet-50 b8's pooled int8 features (8, 2048) from phase 3's CPU
     path through tk.cond between two int8 heads (qnn.dense 2048 -> 1000 +
     requantize) on both flags and tk.while_loop over a qnn.dense 2048 ->
     2048 + requantize + clip block at n = 0, 1, 4: == the CPU path, every
     K4 call (qgemm_raw) == plain, 20 requests each with the latency and the
     host reads a request; the b1 cond graph traced on the card, byte-equal
     to the CPU path's trace and verify_trace'd; (c) every dyn.* op at
     tests/test_dyn.py's shapes (tests/runtime_cases.py CASES) through
     DynShapeExecutor(device="cuda") == device="cpu", dyn.nonzero
     unspecialized; (d) float ResNet-50 b8 224^2 (seed 0) with log_softmax +
     nn.cross_entropy_with_logits against one-hot labels, qat_prepare on one
     b8 batch, value_and_grad_fn on the card: the float graph's step-0 loss
     within 1e-4 of the CPU's, every gradient within GRAD_NORMWISE
     norm-wise of the CPU's taking the card's relu and max-pool branches
     (card_branches), which the control, the same backward in TF32, must
     exceed on most leaves; the
     fake-quant graph's step-0 loss within QAT_FQ_LOSS_RTOL of the CPU's,
     its gradients' difference printed beside the CPU's own spread when
     every weight moves by 1e-7 (a rounding tipped by a float sum's order
     moves an activation by a quantum), remat's loss == and gradients
     within 1e-5 of the plain run's on the card, both peak device bytes; 3
     SGD steps (the gradient scaled to a step length of 0.01), the loss
     falling; STE_LAYER's fake-quant pairs (its activation on another
     batch at the stepped weights, its per-channel weight) forward and
     backward == the CPU's on identical inputs; qat_finalize from the
     card's stepped weights, fuse_qnn (14 / 1 / 4 / 1), every K1-K3 call of a forward ==
     plain, 12 requests counted, every integer node == the CPU path.  The
     phase's host seconds are printed;
 25. the TensorFlow and Keras import path: (a) keras.applications.ResNet50's
     frozen inference graph (Keras 3's layout: the stride on the 1x1 convs,
     batch norm unfolded into Reshape / Rsqrt / Mul / Sub / AddV2) written at
     b8 224^2 from the seed by models/keras_resnet.py to a .pb in a
     temporary directory, its bytes and node histogram printed (held to
     Keras's), read back by the port's codec (frontend/tf_proto.py: no
     TensorFlow here), from_tf_graphdef, quantized on phase 3's calibration
     batch and fused, the fused op counts printed beside native
     ResNet-50's and why they differ (53 tk.conv2d_rq, no chain: each batch
     norm stays a qnn.mul and a qnn.add, so K3 has no call), then every K1
     and K2 call == plain and timed, 12 requests counted, every integer node
     == the CPU path, the probabilities within FLOAT_RTOL / FLOAT_ATOL,
     latency and busy share; (b) the same .pb at b1 (input_specs),
     quantized and left unfused, traced on K4 as in phases 7-8, the records a
     float source reaches (the float mean's quantize and what follows)
     holding their integer tensors == and their float input within
     FLOAT_RTOL / FLOAT_ATOL; (c) `tachikoma_tpu_torch.cli quantize` of the
     .pb on 25a's calibration batch writes 25a's integer graph (equal
     JSON), and `run` of it on the card gives 25a's output; (d) the six ops
     the TensorFlow importer brought (rsqrt, floor_divide, floor_mod, all,
     any, stack) on tests/tf_op_cases.py's cases on the card == their CPU
     torch impls.  The phase's host seconds are printed;
 26. parallel/* over torch.distributed: phase 3's ResNet-50 b8 224^2 and
     phase 7's b1 graph go to PARALLEL_WORLD rank processes on cuda:0
     (gloo; the kernels built before any rank starts) as .tkmod files.
     (a) ShardedExecutor over dp 2 x tp 2 and tp 4: the plan (column- /
     row-parallel per product, the collectives a request), every K4 call
     of a forward == plain and timed at the slices on rank 0, 5 requests
     with the int8 logits == and the probabilities within rtol 1e-5, atol
     1e-7 of the single card's unfused run, the collectives a request by
     kind (calls, bytes, host-staged bytes, host ms), the median beside the
     single card's; at dp 2 x tp 2 one run capturing every integer node,
     each == the single card's (sha256); (b) a one-rank NCCL group: the
     same graph == the single card, its all-reduce and all-gather with no
     host byte; (c) ShardedTraceEmitter at tp 2 on the b1 graph: bytes ==
     phase 7's trace, verify_trace, then the two ranks upload alternate
     records in reverse to a TraceCollector on rank 0, whose merge == the
     same bytes; (d) in this process, PipelineExecutor in 2 stages on two
     streams of cuda:0, 4 microbatches, its int8 logits and probabilities
     == the single card's (exact), timed, the
     stages' spans (CUDA events) and whether they overlapped; (e) ring
     attention B 1, H 12, D 64 at S 4096 over sp 2 and 4 == qnn.attention
     on the card (sha256) and at S 512 == the numpy oracle, every
     qbmm_raw call == plain; (f) MoE at K 768, N 3072, E 8, T 512
     (top1_gate) over ep 2 and 4 through an ExpertParallelDense (the
     experts on the card once) == moe_dense_int8_reference, every
     qgemm_raw call == plain.  Beside them, two ranks on cuda:0 in one
     NCCL group: NCCL's refusal ("Duplicate GPU detected") is printed.
     The phase's host seconds are printed;
 27. dilated and grouped convs: (a) DeepLabV3-ResNet-50 b1 520^2 (21
     classes, output stride 8, ASPP 12 / 24 / 36) written by
     models/onnx_deeplab.py from the seed, from_onnx, quantized with the
     bilinear Resize in float (deeplab_qconfig), fused, every K1 / K2 / K3
     call of a forward == plain and timed, its 11 dilated K2 calls asserted (the
     dilated K2 calls summed as a row of their own: launches, ms, the bound
     of their useful operations, plain, the fp16 cuDNN conv with their
     dilation), 12 requests counted with no plain conv and no library conv
     run (`conv_acc_exact`, `exact_int_matmul` and F.conv2d spied on), the
     nodes held to the CPU path as phase 19 holds them (hold_node_level:
     this graph has no float source, its pooling is integer and its
     bilinear Resize elementwise, so every integer node == the CPU path and
     the float logits are within GRAPH_RTOL / GRAPH_ATOL), latency and
     busy share; (b) the same graph unfused at b1 520^2: every K1 / K4
     call == plain and timed, the dilated K4 calls as a row; (c) the model
     written at b1 176^2 (22^2 maps: the trace kept small; the backbone's
     and the rate-12 branch's taps land inside the map, the rate-24 and
     rate-36 branches' outer taps only in the padding, so only (b) runs
     those two at their real geometry), quantized, traced on K4 as in phases
     7-8; (d) ResNeXt-50 32x4d b8 224^2 (models/torch_resnet.py) through
     from_torch, quantized and fused, then as (a), its 16 grouped K2 calls
     asserted and summed as a row; (e) its b1 224^2
     graph traced on K4 as in phases 7-8, its 16 grouped K4 calls as a row.
     The phase's host seconds are printed;
 28. legacy uint8 TFLite models: (a) MobileNetV2 1.0 b8 224^2 as TF1's
     quantization-aware converter writes TF's hosted uint8 model (uint8
     input at 1/128 and 128, uint8 weights per tensor at their own zero
     points, uint8 activations and a uint8 softmax at 1/256), written by
     models/tflite_mobilenet.py from the seed, from_tflite, fused (53
     tk.conv2d_rq, each uint8 out at a weight zero point other than 0): every
     K1 / K2 / K5 call of a forward == plain and timed beside its bound,
     plain version and library call (torch._int_mm on the same bytes; cuDNN's
     fp16 conv and depthwise conv), 12 requests counted with no plain
     version and no library conv run (`no_plain_conv`), every integer
     node == the CPU path, latency and busy share; (b) its b1 224^2 graph
     unfused on K4 and K5's raw mode, every call == plain, traced on the
     card (1 warm + 2 timed), the integer records byte-equal to the CPU
     path's and verify_trace'd; (c) K5 with dilation, requantize and raw
     modes, int8 and uint8 data (the latter at a weight zero point, a uint8
     output), at DeepLab-MobileNetV2's ten atrous depthwise calls
     (ATROUS_CALLS: b1 65^2 maps, 384 and 576 channels at dilation 2, 960
     at 4), the calls counted, each == plain and timed beside cuDNN's fp16
     dilated depthwise conv.  The phase's host seconds are printed.  To
     make room for it, REQUESTS went from 20 to 12 and TRACE_TIMED from 5
     to 2, in every phase;
 29. W8A16 beyond the plain CNN (int16 activations, int64 accumulators,
     unfused): (a) BERT-base b4 s128 quantized with W8A16, its 24
     qnn.batch_matmul on qbmm_wide (csrc/qbmm_wide_hopper.cu: both int16
     operands split into byte planes, four wgmma products into three int32
     sums, int64 out) and its 50 denses on qgemm_wide, every call == its
     float64 plain version and timed beside the bound and the float64
     cuBLAS call, REQUESTS requests with no plain
     version and no library product run (no_plain_conv, torch.matmul and
     torch.bmm spied on too), every node held to the CPU path at node level
     (hold_zoo_nodes: the card's float softmax and tanh round in their own
     way, and a flipped int16 element grows through the reference's int16
     layer norm, whose int32 sum of squares wraps, so the logits' distance
     from the CPU's is printed, not held), latency and busy share; (b) its
     b1 s128 trace on the card, the records no float op reaches byte-equal
     to the CPU's, every record verify_trace'd; (c) ViT-B/16 b1 224^2 as
     (a), its patch embedding on qconv_wide; (d) DeepLabV3-ResNet-50 b1
     520^2 (phase 27's float graph, the Resize in float) as (a), its 11
     dilated convs on qconv_wide summed as a row, every node held at 176^2;
     (e) ResNeXt-50 32x4d b1 224^2 (phase 27's module) as (a), its 16
     grouped convs on qconv_wide's super-groups as a row; (f) qdwconv_wide
     dilated at the ten atrous calls of phase 28c at int16.  The phase's
     host seconds are printed.

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
forward (phase 17), those of qgemm_wide and qconv_wide (the W8A16 int64
products: their bound the int16 read, int8 weights and int64 write, or two
int8 products; their library call the float64 product) per W8A16
ResNet-50 b8 forward (phase 20c) and of qdwconv_wide per 16x8 fixture
forward (phase 20e), those of qbmm_wide per W8A16 BERT-base b4 s128 forward
(phase 29a); `launches` sums each
kernel's launches over the paths' timed runs (phases 5, 8, 9, 10, 11,
12c-14c, 15c, 16a, 16c, 17c, 17e, 17f, 18b, 18e, 18f, 19a-19k, 19l, 20a-20e,
21a, 21b, 22a-22d, 23a, 23b, 23d, 23e, 24a, 24b, 24d, 25a, 25b; 26a,
26d, 26e, 26f summed over the ranks; 27a-27e; 28a-28c; 29a-29f; K11
and K12 in 16b's tune_conv run), each counted from 0 just before its run; max_abs_err is the largest over every check.  TF32 is off for matmuls and cuDNN (the float path's
products are float32).  The line before the last is one JSON object
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
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
REQUESTS = 12                      # 20 until phase 28 came: its seconds came from here
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
TRACE_TIMED = 2                    # 5 until phase 28 came

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
    "qbmm_rq": ("tachikoma_tpu_torch/csrc/qbmm_hopper.cu", "tachikoma_tpu/runtime/fuse.py:389"),
    "qbmm_raw": ("tachikoma_tpu_torch/csrc/qbmm_hopper.cu", "tachikoma_tpu/ops/jax_ops.py:249"),
    # no Pallas kernel: XLA runs qnn.dense / qnn.conv2d into int64 in the JAX package
    "qgemm_wide": ("tachikoma_tpu_torch/csrc/qconv_wide_hopper.cu",
                   "tachikoma_tpu/ops/jax_ops.py:188"),
    "qconv_wide": ("tachikoma_tpu_torch/csrc/qconv_wide_hopper.cu",
                   "tachikoma_tpu/ops/jax_ops.py:103"),
    "qdwconv_wide": ("tachikoma_tpu_torch/csrc/qdwconv.cu", "tachikoma_tpu/ops/jax_ops.py:103"),
    # no Pallas kernel: XLA runs qnn.batch_matmul into int64 in the JAX package
    "qbmm_wide": ("tachikoma_tpu_torch/csrc/qbmm_wide_hopper.cu",
                  "tachikoma_tpu/ops/jax_ops.py:249"),
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
W8A16_KERNELS = ("qgemm_wide", "qconv_wide")
W8A16_16X8_KERNELS = ("qgemm_wide", "qconv_wide", "qdwconv_wide")
# every W8A16 int64 product: the three above and the batched product (phase 29)
WIDE_KERNELS = W8A16_16X8_KERNELS + ("qbmm_wide",)
# the plane route's ms per forward (wide_planes: K4 / K5 on two byte planes
# and torch passes; this script on the tree before the W8A16 kernels, NVIDIA
# H100 80GB HBM3, 700.00 W): phase 20c b8, 20d b1
PLANE_ROUTE_MS = {"20c": 6.2636, "20d": 2.9902}
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
    # K1's batched mode as a BMM instantiation of csrc/igemm_hopper.cuh's body,
    # per call (tools/bmm_probe.py --csrc on it)
    ("int8 BERT-base b4 s128", "qbmm_rq"): {
        "48x (128, 64) x (64, 128)": 0.0046, "48x (128, 128) x (128, 64)": 0.0060},
    ("BERT-base", "qbmm_raw"): {
        "12x (128, 64) x (64, 128)": 0.0037, "12x (128, 128) x (128, 64)": 0.0055},
    ("int8 GPT-2 small decode step", "qbmm_rq"): {
        "12x (1, 64) x (64, 128)": 0.0040, "12x (1, 128) x (128, 64)": 0.0057},
    ("int8 GPT-2 small decode step", "qbmm_raw"): {
        "12x (1, 64) x (64, 128)": 0.0036, "12x (1, 128) x (128, 64)": 0.0054},
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
                "qdwconv_raw", "flash_attn", "qbmm_rq", "qbmm_raw", "qgemm_wide", "qconv_wide",
                "qdwconv_wide", "qbmm_wide")
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
    for mod, attr, name in (*((wide, name, name) for name in WIDE_KERNELS),
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
    if name == "qbmm_wide":  # int16 operands (views read in place), int64 out, four
        # int8 products (the byte planes of both operands)
        from tachikoma_tpu_torch.ops.kernels.matmul_int8 import _logical

        A, B = _logical(a[0], a[1], k.get("transpose_a", False), k.get("transpose_b", False))
        m, kk, n = A.shape[-2], A.shape[-1], B.shape[-1]
        nb = int(np.prod(np.broadcast_shapes(tuple(A.shape[:-2]), tuple(B.shape[:-2]))))
        return (2 * (A.numel() + B.numel()) + 8 * nb * m * n, 4 * 2 * nb * m * kk * n,
                f"{nb}x ({m}, {kk}) x ({kk}, {n}) int16")
    if name == "flash_attn":
        b, h, s, d = a[0].shape
        g = b * h
        causal = bool(k.get("causal", False))
        ops = 4 * g * d * s * (s + 1) // 2 if causal else 4 * g * s * s * d
        return (4 * g * s * d * 4, ops,
                f"G={g} S={s} D={d}{' causal' if causal else ''}")
    x, w = a[0], a[1]
    cout = w.shape[-1]
    if name in WIDE_KERNELS:  # int16 in, int8 weights, int64 out
        if name == "qgemm_wide":  # two int8 products (the byte planes)
            m, kk = x.shape
            return (2 * m * kk + kk * cout + 8 * m * cout, 2 * 2 * m * kk * cout,
                    f"M={m} K={kk} N={cout} int16")
        out_shape, label = conv_out(x, w, k)
        products = 1 if name == "qdwconv_wide" else 2  # depthwise: no planes
        return (2 * x.numel() + w.numel() + 8 * int(np.prod(out_shape)),
                products * 2 * int(np.prod(out_shape)) * int(np.prod(w.shape[:3])),
                label + " int16")
    raw = name.endswith("_raw")
    out_b, vec_b = (4, 4) if raw else (1, 12)  # output bytes, per-channel vector bytes
    if k.get("kzp") is not None:  # the weights' zero point, int32 a column
        vec_b += 4
    if name in ("qgemm_rq", "qgemm_raw"):
        m, kk = x.shape
        return (m * kk + kk * cout + out_b * m * cout + vec_b * cout, 2 * m * kk * cout,
                f"M={m} K={kk} N={cout}")
    kh, kw, cin, _ = w.shape  # cin: a group's input channels (the useful products)
    out_shape, label = conv_out(x, w, k)
    out = int(np.prod(out_shape))
    nbytes = (x.numel() + w.numel() + out_b * out + vec_b * cout
              + (out if name == "qconv_rq_res" else 0))
    return nbytes, 2 * out * kh * kw * cin, label


def conv_out(x, w, k) -> tuple[tuple, str]:
    """The output shape (N, OH, OW, COUT) of a recorded conv call, and its
    label (with the dilation and the groups where they are not 1)."""
    kh, kw = w.shape[:2]
    sh, sw = k.get("strides", (1, 1))
    dh, dw = k.get("dilation", (1, 1))
    groups = k.get("groups", 1)
    pt, pl, pb, pr = k.get("padding", (0, 0, 0, 0))
    n, h, wd, c = x.shape
    oh = (h + pt + pb - (kh - 1) * dh - 1) // sh + 1
    ow = (wd + pl + pr - (kw - 1) * dw - 1) // sw + 1
    extra = (f" d{dh}" if (dh, dw) != (1, 1) else "") + (f" g{groups}" if groups != 1 else "")
    return (n, oh, ow, w.shape[3]), f"{n}x{h}x{wd}x{c} k{kh} s{sh}{extra} -> {w.shape[3]}"


def library_call(name, a, k):
    """One PyTorch call of the same shape (used only as a yardstick): for the
    GEMMs torch._int_mm, which computes K4's function exactly but refuses M
    <= 16 and, through cuBLASLt, some other shapes (M=784 K=32 N=192 on
    torch 2.11, CUDA 12.8); there an fp16 matmul of the same shape."""
    x, w = a[0], a[1]
    if name == "qbmm_wide":  # the exact float64 product (cuBLAS) of the same operands
        from tachikoma_tpu_torch.ops.kernels.matmul_int8 import _logical

        A, B = _logical(x.to(torch.float64), w.to(torch.float64), k.get("transpose_a", False),
                        k.get("transpose_b", False))
        return lambda: torch.matmul(A, B)
    if name in WIDE_KERNELS:  # the exact float64 product (cuBLAS, cuDNN) of the same shapes
        xd, wd = x.to(torch.float64), w.to(torch.float64)
        if name == "qgemm_wide":
            return lambda: xd @ wd
        pt, pl, pb, pr = k.get("padding", (0, 0, 0, 0))
        xd = torch.nn.functional.pad(xd, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2).contiguous()
        wd = wd.permute(3, 2, 0, 1).contiguous()
        groups = x.shape[3] if name == "qdwconv_wide" else k.get("groups", 1)
        dilation = tuple(k.get("dilation", (1, 1)))
        return lambda: torch.nn.functional.conv2d(xd, wd, stride=tuple(k.get("strides", (1, 1))),
                                                  dilation=dilation, groups=groups)
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
        if x.dtype == torch.uint8:  # the same bytes and shapes: _int_mm takes int8 alone
            x = x.view(torch.int8)
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
    groups = x.shape[3] if name.startswith("qdwconv") else k.get("groups", 1)
    dilation = tuple(k.get("dilation", (1, 1)))
    return lambda: torch.nn.functional.conv2d(x16, w16, stride=stride, padding=(pt, pl),
                                              dilation=dilation, groups=groups)


def kernel_impls() -> dict:
    """Kernel name -> (wrapper, plain version)."""
    from tachikoma_tpu_torch.ops.kernels import (conv, conv_direct, conv_layouts, depthwise,
                                                 flash_attention, matmul_int8, wide)

    impl = {"qgemm_rq": (matmul_int8.qgemm_rq, matmul_int8.qgemm_rq_plain),
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
    for name in WIDE_KERNELS:
        impl[name] = (getattr(wide, name), getattr(wide, f"{name}_plain"))
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
                                                 flash_attention, matmul_int8, wide)

    x, w = a[0], a[1]
    if name == "qgemm_wide":
        p = k.get("plan") or wide.wide_plan(x.shape[0], x.shape[1], w.shape[1],
                                            conv.sm_count(x.device.index))
        return f"tile {p['bm']}x{p['bn']} split {p['ks']} x {p['kper']}"
    if name in BMM_KERNELS:  # path, tile, chunks of K, staging modes, operands read as uint8
        return matmul_int8.launch_summary(name, x, w, **k)
    if name == "qbmm_wide":  # products, staging modes
        return wide.bmm_wide_summary(x, w, **k)
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
    dilation, groups = tuple(k.get("dilation", (1, 1))), k.get("groups", 1)
    (_, oh, ow, _), _ = conv_out(x, w, k)
    sms = conv.sm_count(x.device.index)
    if name == "qconv_wide":
        span = conv.group_span(groups, cout // groups, wide.GROUPED_BN) if groups != 1 else 1
        p = k.get("plan") or wide.wide_plan(x.shape[0] * oh * ow, kh * kw * span * cin, cout,
                                            sms, wide.GROUPED_BN if groups != 1 else None)
        return (f"tile {p['bm']}x{p['bn']} split {p['ks']} x {p['kper']}"
                + (f", {span} groups a tile" if groups != 1 else ""))
    if name.startswith("qdwconv"):
        p = depthwise.dw_plan(x.shape[0], oh, ow, cout, kh, kw, sh, sw, x.element_size(),
                              *dilation)
        return f"ct {p['ct']} tile {p['th']}x{p['tw']}, {p['blocks']} blocks"
    if name == "qconv_direct":
        plan = k.get("plan") or conv_direct.direct_plan(tuple(x.shape), tuple(w.shape),
                                                        (sh, sw), (pt, pl, pb, pr), sms)
        if plan["cc"] != conv_direct.KC:
            return f"narrow cc {plan['cc']}"
        return f"wgmma bn {plan['bn']} taps {plan['group']}"
    if name == "qconv_raw":
        kk, span = conv._geometry(tuple(x.shape), tuple(w.shape), conv.RAW_TILE[1], groups)
        ks, kper = conv.raw_split(x.shape[0] * oh * ow, cout, kk, sms)
        return f"split {ks} x {kper} steps" + (f", {span} groups a tile" if groups != 1 else "")
    if name == "qconv_rq_res":
        bm, bn = _lib.tile_params(k.get("blocks")).values()
        return f"tile {bm}x{bn}"
    (bm, bn), ks, kper = conv.rq_launch(tuple(x.shape), tuple(w.shape), (sh, sw),
                                        (pt, pl, pb, pr), k.get("blocks"), sms, dilation, groups)
    span = conv._geometry(tuple(x.shape), tuple(w.shape), bn, groups)[1]
    return f"tile {bm}x{bn} split {ks} x {kper}" + (f", {span} groups a tile"
                                                    if groups != 1 else "")


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


def call_key(name, a, k) -> tuple:
    """What sets a call's time: the kernel, each tensor argument's shape,
    dtype and strides, every other argument."""
    def arg(v):
        if isinstance(v, torch.Tensor):
            return ("tensor", tuple(v.shape), str(v.dtype), v.stride())
        if isinstance(v, (list, tuple)):
            return tuple(arg(u) for u in v)
        return repr(v)
    return name, tuple(arg(v) for v in a), tuple(sorted((kk, arg(v)) for kk, v in k.items()))


def check_kernels(calls: list, names, model: str = "", keep: list | None = None) -> dict:
    """Hold every recorded call of the kernels `names` against its plain
    version (== for the integer kernels, allclose for K6), time it, and sum
    per kernel; K2-K4 are printed call by call with their launch plan and
    the previous design's time on `model`'s call.  `keep`, where given,
    receives every call's record (its dilation and groups among them).
    Every call is held, but timed once per distinct call (`call_key`: the
    same kernel, shapes, strides and arguments): a repeat, a later layer's
    call, takes the first one's times."""
    impl = kernel_impls()
    per_call, totals, timed = [], {}, {}
    for name, a, k in calls:
        key = call_key(name, a, k)
        if key in timed:
            per_call.append(dict(timed[key], max_abs_err=hold_call(name, a, k, impl)))
        else:
            per_call.append(timed.setdefault(key, check_call(name, a, k, impl)))
        per_call[-1]["geometry"] = (tuple(k.get("dilation", (1, 1))), k.get("groups", 1))
        if name in PLAN_KERNELS:
            per_call[-1]["plan"] = launch_plan(name, a, k)
    say(f"{len(per_call)} calls held == plain, {len(timed)} distinct ones timed")
    if keep is not None:
        keep.extend(per_call)

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
                   counts: dict | None = None, sourced: set = frozenset(),
                   node_level: bool = False) -> tuple[int, int]:
    """Hold the trace at `path` record by record against `ref_path`: same
    header, names, op ids and attrs; integer records byte-equal, float
    records allclose at FLOAT_RTOL / FLOAT_ATOL, those of the nodes in `cone`
    (`float_product_cone`) at the float transformers' GRAPH_RTOL /
    GRAPH_ATOL.  An integer record of a node in `sourced` (the float source
    set, `runtime/crosscheck.py float_source_set`: a qnn.quantize of a float
    mean the card sums in another order) holds its integer tensors == and its
    float input at FLOAT_RTOL / FLOAT_ATOL; with `node_level` (a float op
    of the card's, softmax or tanh, inside the graph) every record of the
    set, float or integer, is held only by verify_trace, its op re-run on
    its own inputs, since an ulp there rounds a later qnn.quantize the
    other way.  Returns (records,
    integer records); `counts` gets the number of float records that are
    byte-equal all the same and, with `node_level`, the number of sourced
    integer records that differ from the CPU's."""
    from tachikoma_tpu_torch.trace.format import TraceReader, op_id

    with open(path, "rb") as f, open(ref_path, "rb") as g:
        got, want = TraceReader(f), TraceReader(g)
    assert got.graph_hash == want.graph_hash and len(got) == len(want) and got.meta == want.meta
    n_int = n_float_equal = n_sourced_differ = 0
    for a, b in zip(got, want):
        assert (a.node_id, a.name, a.op_name, a.attrs) == (b.node_id, b.name, b.op_name, b.attrs)
        assert op_id(a.op_name) == op_id(b.op_name)
        if a.output.to_array().dtype.kind in "iu":
            if a.name in sourced and node_level:
                for ta, tb in zip(a.tensors, b.tensors):
                    assert (ta.role, ta.shape, ta.dtype) == (tb.role, tb.shape, tb.dtype)
                n_sourced_differ += a.encode() != b.encode()
            elif a.name in sourced and a.encode() != b.encode():
                for ta, tb in zip(a.tensors, b.tensors):
                    assert ta.role == tb.role and ta.shape == tb.shape
                    x, y = ta.to_array(), tb.to_array()
                    if y.dtype.kind in "iub":
                        assert x.dtype == y.dtype and (x == y).all(), \
                            f"trace record {a.name} differs from the CPU's"
                    else:
                        np.testing.assert_allclose(x, y, rtol=FLOAT_RTOL, atol=FLOAT_ATOL,
                                                   err_msg=a.name)
            else:
                assert a.encode() == b.encode(), f"trace record {a.name} differs from the CPU's"
            n_int += 1
            continue
        n_float_equal += a.encode() == b.encode()
        if a.name in sourced and node_level:  # held by verify_trace on its own inputs
            for ta, tb in zip(a.tensors, b.tensors):
                assert (ta.role, ta.shape, ta.dtype) == (tb.role, tb.shape, tb.dtype)
            continue
        rtol, atol = (GRAPH_RTOL, GRAPH_ATOL) if a.name in cone else (FLOAT_RTOL, FLOAT_ATOL)
        for ta, tb in zip(a.tensors, b.tensors):
            assert ta.role == tb.role and ta.shape == tb.shape
            np.testing.assert_allclose(ta.to_array(), tb.to_array(), rtol=rtol, atol=atol,
                                       err_msg=a.name)
    if counts is not None:
        counts["float_byte_equal"] = n_float_equal
        counts["sourced_differ"] = n_sourced_differ
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
    """The K-major packed weights held now (`kmajor_weights`' cache and
    `grouped_weights`' caches), by identity: a weight packed after this call
    is not in the set."""
    from tachikoma_tpu_torch.ops.kernels import conv, matmul_int8

    caches = (matmul_int8._KMAJOR, *conv._GROUPED.values())
    return {id(v[2]) for cache in caches for v in cache.values()}


def trace_path(labels, model: str, build, kernels, make_input=None, config=None,
               size: str = f"{IMAGE}^2", prepared=None, keep: dict | None = None,
               per_call: list | None = None, node_level: bool = False) -> tuple[dict, dict]:
    """The trace path of one model, two phases titled by `labels` (7-8 for
    ResNet-50; 10a-10b for MobileNetV2; 17e for int8 BERT-base; 20b and 20d
    for the TFLite MobileNetV2 and W8A16 ResNet-50): the unfused b1
    forward's raw kernels == plain and timed, every integer node == the CPU
    plain path, then the trace emitted on the card, compared with the CPU's
    and verified.  `make_input(rng)` makes the calibration batch and the
    input (an image by default), `config` is the QConfig (the default one by
    default); `prepared` = (integer graph, input) skips the build and the
    quantize (an imported model).  The records a float source reaches are
    held as compare_traces's `sourced` says (Keras's float mean).  `keep`,
    where given, receives the integer graph, the input, the meta and the
    card trace's size and sha256 (phase 26c holds the sharded trace to
    them); `per_call`, where given, the unfused forward's call records
    (check_kernels).  `node_level` (a graph with float gelu / softmax /
    tanh: W8A16's transformers): the nodes and trace records those reach
    are held at node level (hold_zoo_nodes; verify_trace), the others ==
    and byte-equal.  Returns the kernels' per-forward totals and their
    launches (the trace path's run)."""
    from tachikoma_tpu_torch.ops.kernels import _lib
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.crosscheck import float_source_set
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
    assert len(calls) == ops["qnn.conv2d"] + ops["qnn.dense"] + ops["qnn.batch_matmul"]
    totals = check_kernels(calls, kernels, model, per_call)
    plain = TorchExecutor(q, capture=names, device="cpu", fuse=False).run(x)
    if node_level:
        counts = hold_zoo_nodes(q, names, outs, plain, {q.inputs[0].name: x})
        say(f"{counts.get('int', 0)} integer nodes outside the float-source set == the CPU "
            f"path; the set's {counts.get('cone_int', 0)} integer nodes each == its CPU impl "
            f"on the card's inputs ({counts.get('cone_int_differing', 0)} differ from the CPU "
            f"path end to end), its {counts.get('cone_float', 0)} float nodes within rtol "
            f"{GRAPH_RTOL} atol {GRAPH_ATOL} of theirs")
    else:
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
        if keep is not None:
            with open(path, "rb") as f:
                keep.update(graph=q, input=x, meta=meta, bytes=nbytes,
                            sha256=hashlib.file_digest(f, "sha256").hexdigest())

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
        sourced = float_source_set(q)
        tcounts: dict = {}
        n, n_int = compare_traces(path, ref_path, sourced=sourced, counts=tcounts,
                                  node_level=node_level)
        reached = sorted(nm for nm in sourced if not q[nm].dtype.startswith("float"))
        say(f"CPU plain trace {t1 - t0:.2f} s; card trace == CPU trace: {n} records, "
            f"{n_int} integer byte-equal"
            + (f" but the {len(reached)} a float source reaches, held by verify_trace below "
               f"({tcounts['sourced_differ']} differ from the CPU's)" if node_level and reached
               else f" but those a float source reaches ({', '.join(reached)}: their integer "
               f"tensors ==, float inputs within rtol {FLOAT_RTOL} atol {FLOAT_ATOL})"
               if reached else "")
            + f", {n - n_int} float within rtol {FLOAT_RTOL} atol {FLOAT_ATOL} "
            f"({time.perf_counter() - t1:.2f} s)")
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
    kernels' per-forward totals, their launches in the requests, and the
    path's state for phase 23d (the fused graph, the executor, the
    requests)."""
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
    return totals, launches, dict(fused=fused, ex=ex, requests=requests)


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
             check_output=None, config=None, keep: dict | None = None,
             only_kernels: bool = False, kernels=ZOO_KERNELS,
             products: bool = False, end_to_end: bool = True,
             hold=None) -> tuple[dict, dict, dict]:
    """Phase 19 for one builder at its published widths: build, calibrate
    and quantize from SEED, fuse; every recorded K1/K2/K3/K5 call == plain,
    timed, bound and library; REQUESTS requests through
    TorchExecutor(device='cuda') with the launches counted; the integer
    nodes held to the CPU path by hold_zoo_nodes; the device's busy share.
    Returns the kernels' per-forward totals, their launches and a summary.
    `config` is the QConfig (the default one by default); `keep` receives
    the integer graph, the requests and the forward's call records
    (check_kernels' "per_call"); `only_kernels` runs the requests under
    no_plain_conv (`products`: with the library's products spied on too);
    `kernels` names the kernels held and counted (phase 29: the W8A16
    ones); `end_to_end` False prints the float outputs' distance from the CPU path
    inside the float-source set without holding it (W8A16 transformers: a
    softmax ulp's flip grows through the reference's int16 layer norm,
    whose int32 sum of squares wraps); `hold` = (integer graph, input), where
    given, is where the nodes and outputs are held against the CPU path (a
    smaller input of the same model: DeepLab's 176^2 in phase 29d), the
    requests keeping their size; `make_input` may make NCHW batches (an
    imported model's input)."""
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.crosscheck import float_source_set
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    phase(f"{label} {model}: build, calibrate, quantize, fuse (host) [{card}]")
    t0 = time.perf_counter()
    g = build()
    rng = np.random.default_rng(SEED)
    t1 = time.perf_counter()
    q = quantize(g, [make_input(rng)], *([config] if config is not None else []))
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
    kernels = tuple(k for k in kernels if any(c[0] == k for c in calls))
    phase(f"{label} {model}: {', '.join(kernels) or 'no kernel'} at the forward's "
          f"{len(calls)} calls: == plain, time, bound, library [{card}]")
    if keep is not None:
        keep.update(quantized=q, requests=requests, per_call=[])
    per_call = keep["per_call"] if keep is not None else None
    totals = check_kernels(calls, kernels, model, per_call) if kernels else {}

    phase(f"{label} {model}: {REQUESTS} requests through TorchExecutor(device='cuda'), TF32 "
          f"allowed for cuDNN and matmuls [{card}]")
    reset(kernels)
    lat, first = [], None
    spy = (no_plain_conv(f"the {model} requests", products) if only_kernels
           else contextlib.nullcontext())
    with tf32_allowed(), spy:  # the port's float products must not take TF32
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
    x0 = requests[0]
    if hold is not None:  # the nodes held at the smaller input
        fused, x0 = fuse_qnn(hold[0]), hold[1]
        names = computational_nodes(fused)
        first = [_host(o) for o in
                 TorchExecutor(fused, capture=names, device="cuda").run_device(x0)]
        say(f"the nodes held at input {x0.shape}, the requests at {requests[0].shape}")
    t0 = time.perf_counter()
    plain = [_host(o) for o in TorchExecutor(fused, capture=names, device="cpu").run_device(x0)]
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    feeds = x0 if isinstance(x0, dict) else {fused.inputs[0].name: x0}
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
                f"elements outside rtol {GRAPH_RTOL} atol {GRAPH_ATOL}; "
                + (f"held at atol {atol}" if end_to_end else "printed, not held"))
            if end_to_end:
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


def no_raw_launch(what: str) -> None:
    """Assert that K4 / K5 (their raw modes) launched no time since their
    counts were set to 0: an int16 product runs on its own kernels."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    raw = {name: _lib.LAUNCHES[name] for name in RAW_KERNELS}
    assert not any(raw.values()), f"{what} launched K4 / K5: {raw}"
    say(f"{what}: no K4 / K5 launch ({', '.join(RAW_KERNELS)} 0)")


def wide_products_ms(label: str, totals: dict) -> None:
    """The W8A16 products' device ms per forward beside the plane route's."""
    ms = sum(totals[k]["ms"] for k in W8A16_KERNELS)
    say(f"{label} W8A16 products per forward: "
        + " + ".join(f"{k} {totals[k]['ms']:.4f}" for k in W8A16_KERNELS)
        + f" = {ms:.4f} ms; the plane route {PLANE_ROUTE_MS[label]:.4f} ms "
        f"({ms / PLANE_ROUTE_MS[label]:.3f}x); bound "
        f"{sum(totals[k]['bound_ms'] for k in W8A16_KERNELS):.4f} ms")


def w8a16_path(card: str) -> tuple[dict, dict, dict]:
    """Phases 20c-20e: ResNet-50 quantized W8A16 (int16 activations, int64
    accumulators, unfused) at b8 224^2: every product on qgemm_wide /
    qconv_wide == its float64 plain version, timed beside the float64
    cuBLAS / cuDNN call of the same shapes and the bound, no K4 / K5 launch,
    REQUESTS requests, every integer node == the CPU path, the probabilities
    within phase 5's tolerance, the busy share; its b1 trace; the 16x8
    TFLite fixture on the card (its depthwise conv on qdwconv_wide).
    Returns the three kernels' per-forward totals (qgemm_wide and
    qconv_wide per b8 forward, qdwconv_wide per 16x8 forward), the launches
    and the largest |err| of each kernel."""
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

    phase(f"20c. {model}: the int64 products on qgemm_wide / qconv_wide: == plain (float64), "
          f"time, bound, float64 library call [{card}]")
    calls: list = []
    with recording(calls):
        ex.run_device(requests[0])
    torch.cuda.synchronize()
    assert len(calls) == 54 and {name for name, _, _ in calls} == set(W8A16_KERNELS), \
        Counter(name for name, _, _ in calls)
    totals = check_kernels(calls, W8A16_KERNELS, model)
    errs = {k: t["max_abs_err"] for k, t in totals.items()}
    wide_products_ms("20c", totals)

    phase(f"20c. {model}: {REQUESTS} requests through TorchExecutor(device='cuda') [{card}]")
    reset(RAW_KERNELS)
    lat, first_out, launches = timed_requests(ex, requests, W8A16_KERNELS, f"the {model} path")
    no_raw_launch(f"the {model} requests")
    t0 = time.perf_counter()
    plain = TorchExecutor(q, capture=names, device="cpu").run(requests[0])
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    n_int = hold_against_plain(names, first_out, plain, q, SOFTMAX_RTOL, SOFTMAX_ATOL)
    prob = first_out[names.index(q.outputs[0])]
    assert prob.shape == (BATCH, 1000) and np.allclose(prob.sum(-1), 1, atol=1e-4)
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path; float "
        f"nodes within rtol {SOFTMAX_RTOL} atol {SOFTMAX_ATOL}")
    med = say_latency(lat, BATCH)
    say(f"W8A16 products device ms per forward "
        f"{sum(totals[k]['ms'] for k in W8A16_KERNELS):.4f} (bound "
        f"{sum(totals[k]['bound_ms'] for k in W8A16_KERNELS):.4f}, float64 library "
        f"{sum(totals[k]['library_ms'] for k in W8A16_KERNELS):.4f}) of {med:.3f} ms end to end")
    profile_requests(ex, requests[:3], med)

    reset(RAW_KERNELS)
    trace_totals, trace_launches = trace_path(("20d.", "20d."), "ResNet-50 W8A16", r50,
                                              W8A16_KERNELS, config=W8A16)
    no_raw_launch("the W8A16 b1 trace path")
    wide_products_ms("20d", trace_totals)
    for k, t in trace_totals.items():
        errs[k] = max(errs.get(k, 0), t["max_abs_err"])
    for k, n in trace_launches.items():
        launches[k] = launches.get(k, 0) + n

    phase(f"20e. the 16x8 TFLite fixture ({TFLITE_16X8}) on the card: every product on "
          f"qgemm_wide / qconv_wide / qdwconv_wide == plain and timed, integers == the CPU path "
          f"[{card}]")
    io16 = np.load(TFLITE_16X8_IO)
    g16 = from_tflite(TFLITE_16X8)
    names16 = computational_nodes(g16)
    ex16 = TorchExecutor(g16, capture=names16, device="cuda")
    calls = []
    with recording(calls):
        ex16.run_device(io16["x"])
    torch.cuda.synchronize()
    assert Counter(k for k, _, _ in calls) == {"qgemm_wide": 2, "qconv_wide": 2,
                                               "qdwconv_wide": 1}, calls
    totals16 = check_kernels(calls, W8A16_16X8_KERNELS, "16x8 fixture")
    for k, t in totals16.items():
        errs[k] = max(errs.get(k, 0), t["max_abs_err"])
    totals["qdwconv_wide"] = totals16["qdwconv_wide"]
    reset(W8A16_16X8_KERNELS + RAW_KERNELS)
    card16 = ex16.run(io16["x"])
    for k, n in read_launches(W8A16_16X8_KERNELS, "the 16x8 fixture").items():
        launches[k] = launches.get(k, 0) + n
    no_raw_launch("the 16x8 fixture")
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


def fused_resnet_run(label: str, model: str, fused, requests, card: str,
                     expected_ops: dict = ONNX_R50_OPS, kernels=RUN_KERNELS):
    """Phases 21a, 22a and 25a on a fused ResNet-50 whose op counts are
    `expected_ops` (native's form unless given; asserted): every call of the
    `kernels` (K1/K2/K3 unless given) in one forward == plain and timed,
    REQUESTS requests through TorchExecutor(device='cuda') with the launches
    counted, every integer node == the CPU path, the latency and the busy
    share.  Returns the kernels' per-forward totals, their launches, the
    recorded calls, and the first request's output on the card and on the
    CPU path."""
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes

    ops = Counter(n.op for n in fused.nodes if n.op not in ("var", "const"))
    say("fused graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    assert {k: ops[k] for k in expected_ops} == expected_ops, ops
    names = computational_nodes(fused)
    ex = TorchExecutor(fused, capture=names, device="cuda")

    phase(f"{label} {model}: {', '.join(kernels)} at the forward's calls: == plain, time, "
          f"bound, library [{card}]")
    calls: list = []
    with recording(calls):
        ex.run_device(requests[0])
    torch.cuda.synchronize()
    totals = check_kernels(calls, kernels, model)

    phase(f"{label} {model}: {REQUESTS} requests through TorchExecutor(device='cuda') [{card}]")
    lat, first_out, launches = timed_requests(ex, requests, kernels, f"the {model} path")
    t0 = time.perf_counter()
    plain = TorchExecutor(fused, capture=names, device="cpu").run(requests[0])
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    n_int = hold_against_plain(names, first_out, plain, fused, FLOAT_RTOL, FLOAT_ATOL)
    out = names.index(fused.outputs[0])
    logits = first_out[out]
    assert logits.shape == (BATCH, 1000) and np.isfinite(logits).all()
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path; output "
        f"{logits.shape} (max |value| {np.abs(logits).max():.4g}), float nodes within rtol "
        f"{FLOAT_RTOL} atol {FLOAT_ATOL}")
    med = say_latency(lat, BATCH)
    kernel_ms = sum(t["ms"] for t in totals.values())
    say(f"{'+'.join(kernels)} device ms per forward {kernel_ms:.4f} of {med:.3f} ms end to "
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
# the segmented executor and the rest of item 13's executors (phase 23)
# ---------------------------------------------------------------------------

# The JAX package's partition of the tied, fused int8 ViT-L/16 at the
# segmented executor's defaults (min_ops 48, max_ops 640, min_scan_layers 3):
# segments, programs and the scan runs (start, length, carry slot).  It reads
# node counts and attrs, not widths: the same graph at hidden 64 gives it in
# both packages (tests/test_torch_port_segmented.py holds the port's
# partition to the JAX package's on every test graph).
VITL_PARTITION = (13, 3, [(1, 11, 0)])
VITL_KERNELS = ("qgemm_rq", "qgemm_raw", "qbmm_rq", "qconv_rq")
SEGMENTED_REQUESTS = 10           # requests per executor in 23a, and per batch in 23d/23e
BUCKETS, BUCKET_BATCHES = (1, 2, 4, 8), (1, 3, 8)
CALIB_RTOL = 1e-4                 # "torch-cpu" scales vs the oracle's (tests/test_quantize.py:199-203)


def median_requests(run, feeds) -> tuple[float, list]:
    """Each feed through run(), host clock around the run and a synchronize;
    the median with the first dropped, and every latency (ms)."""
    lat = []
    for x in feeds:
        t0 = time.perf_counter()
        run(x)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat[1:]), lat


def vitl_segmented_path(card: str) -> tuple[dict, dict, dict]:
    """Phase 23a: int8 ViT-L/16 b1 224^2 (TRANSFORMER_INT8_SCAN, fused) run
    by SegmentedExecutor at its defaults.  Returns the kernels' per-forward
    totals, their launches in the segmented requests, and the state 23c
    reuses (the simplified float graph, its oracle calibration and input)."""
    from tachikoma_tpu_torch.ir.transforms import simplify
    from tachikoma_tpu_torch.models.transformer import vit_l16
    from tachikoma_tpu_torch.quantize.calibrate import calibrate
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8_SCAN
    from tachikoma_tpu_torch.quantize.quantizer import Quantizer
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
    from tachikoma_tpu_torch.runtime.segmented import SegmentedExecutor

    model = f"int8 ViT-L/16 b1 {IMAGE}^2"
    phase(f"23a. {model}: build (seed {SEED}), quantize (TRANSFORMER_INT8_SCAN, the oracle's "
          f"calibration on one image), fuse (host) [{card}]")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    g = simplify(vit_l16(batch_size=1, image_size=IMAGE, seed=SEED))
    calib = rng.standard_normal((1, IMAGE, IMAGE, 3)).astype(np.float32)
    t1 = time.perf_counter()
    c_oracle = calibrate(g, [calib], TRANSFORMER_INT8_SCAN)
    t2 = time.perf_counter()
    fused = fuse_qnn(Quantizer(g, c_oracle, TRANSFORMER_INT8_SCAN).run())
    t3 = time.perf_counter()
    ops = Counter(n.op for n in fused.nodes if n.op not in ("var", "const"))
    say(f"build + simplify {t1 - t0:.2f} s, oracle calibration {t2 - t1:.2f} s, quantize + "
        f"fuse {t3 - t2:.2f} s")
    say("fused graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    assert ops["tk.bmm_rq"] == 48 and ops["qnn.dense"] == 24 and ops["tk.conv2d_rq"] == 1, ops

    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    seg = SegmentedExecutor(fused, device="cuda")
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    say(f"SegmentedExecutor(fused, device='cuda') at min_ops 48, max_ops 640, min_scan_layers 3: "
        f"built in {time.perf_counter() - t0:.2f} s; {len(seg.segments)} segments, "
        f"{seg.n_programs} programs, scan runs (start, length, carry slot) {seg.scan_runs}")
    say("segment ops: " + " ".join(str(len([n for n in s.sub.nodes
                                             if not (n.is_var or n.is_const)]))
                                   for s in seg.segments))
    assert (len(seg.segments), seg.n_programs, seg.scan_runs) == VITL_PARTITION, (
        len(seg.segments), seg.n_programs, seg.scan_runs)
    start, length, _ = seg.scan_runs[0]
    n_stacks = len(seg._scans[start]["stacks"])
    other = {p.data_ptr(): p for si, ps in enumerate(seg._seg_params)
             if not start <= si < start + length for p in ps}
    n_tensors = n_stacks + len(other)
    held = seg.stacked_bytes + seg.segment_bytes
    say(f"device bytes at construction {m1 - m0}: the scan's {n_stacks} stacks "
        f"{seg.stacked_bytes} (the {length} members' weights, each member's params views of "
        f"them), the other segments' params {seg.segment_bytes} ({len(other)} tensors); no "
        f"per-segment copy of a member's weights (the JAX package's executor puts those on the "
        f"device too: {seg.stacked_bytes} bytes more)")
    # the caching allocator may hand out up to 1 MiB more than asked for a
    # large tensor (it keeps a remainder under 1 MiB in the block); a second
    # copy of the members' weights would add the stacks' size again
    assert held <= m1 - m0 <= held + (1 << 20) * n_tensors, (m1 - m0, held, n_tensors)

    names = computational_nodes(fused)
    whole = TorchExecutor(fused, device="cuda")
    seg_all = SegmentedExecutor(fused, capture=names, device="cuda")
    assert seg_all.scan_runs == [] and seg_all.n_programs == seg.n_programs
    requests = [rng.standard_normal((1, IMAGE, IMAGE, 3)).astype(np.float32)
                for _ in range(SEGMENTED_REQUESTS)]
    x = requests[0]

    phase(f"23a. {model}: K1, K4, qbmm_rq and K2 at the segmented forward's calls (the scan's "
          f"views of the stacks): == plain, time, bound, library [{card}]")
    calls: list = []
    before = packed_weights()
    with recording(calls):
        out_scan = _host(seg.run_device(x)[0])
    torch.cuda.synchronize()
    first = len(packed_weights() - before)
    say("kernel calls of one segmented forward: " + ", ".join(
        f"{n} {name}" for name, n in sorted(Counter(c[0] for c in calls).items())))
    totals = check_kernels(calls, VITL_KERNELS, model)

    phase(f"23a. {model}: {SEGMENTED_REQUESTS} requests through the segmented executor (the "
          f"scan) and through TorchExecutor (whole graph), counted; every node == [{card}]")
    packed = packed_weights()
    reset(VITL_KERNELS)
    med_seg, lat_seg = median_requests(seg.run_device, requests)
    launches = read_launches(VITL_KERNELS, f"the segmented {model} path")
    again = packed_weights() - packed
    assert not again, f"the segmented requests packed {len(again)} weights K-major again"
    for name, n in launches.items():
        say(f"{name}: {n} launches, {n // SEGMENTED_REQUESTS} per forward")
    say(f"{first} weight tensors packed K-major by the first segmented forward (one per layer "
        f"view of the stacks and per other weight of K1 / K4 / K2), none during the requests")
    med_whole, lat_whole = median_requests(whole.run_device, requests)
    say(f"latency ms per request (b1): segmented median {med_seg:.3f}, whole graph median "
        f"{med_whole:.3f} ({med_seg / med_whole:.3f}x)")
    say("segmented, all: " + " ".join(f"{v:.3f}" for v in lat_seg))
    say("whole graph, all: " + " ".join(f"{v:.3f}" for v in lat_whole))
    say(f"images/s: segmented {1e3 / med_seg:.1f}, whole graph {1e3 / med_whole:.1f}")
    kernel_ms = sum(t["ms"] for t in totals.values())
    say(f"{'+'.join(VITL_KERNELS)} device ms per forward {kernel_ms:.4f} of {med_seg:.3f} ms "
        "end to end")

    whole_all = TorchExecutor(fused, capture=names, device="cuda")
    outs_whole = [_host(o) for o in whole_all.run_device(x)]
    outs_seg = [_host(o) for o in seg_all.run_device(x)]
    t0 = time.perf_counter()
    plain = TorchExecutor(fused, capture=names, device="cpu").run(x)
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    n_int = 0
    for nm, a, b in zip(names, outs_seg, outs_whole):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all(), nm
        n_int += a.dtype.kind in "iu"
    n_plain = hold_against_plain(names, outs_seg, plain, fused, FLOAT_RTOL, FLOAT_ATOL)
    logits = outs_whole[names.index(fused.outputs[0])]
    assert out_scan.shape == logits.shape == (1, 1000) and (out_scan == logits).all()
    assert np.isfinite(logits).all()
    int_logits = fused[fused.outputs[0]].inputs[0]
    say(f"the scan's logits == the whole graph's; {len(names)} captured nodes of the segmented "
        f"executor (no scan: every node captured) == the whole graph's, {n_int} integer (the "
        f"int8 logits {int_logits} among them); {n_plain} integer == the CPU plain path, float "
        f"nodes within rtol {FLOAT_RTOL} atol {FLOAT_ATOL}")

    phase(f"23a. {model}: device time of the segmented path (torch.profiler, 3 requests) "
          f"[{card}]")
    feeds = iter(requests[:3])
    profile_runs(lambda: seg.run_device(next(feeds)), 3, med_seg, "request")
    del whole, whole_all, seg_all
    state = dict(float_graph=g, calib=calib, c_oracle=c_oracle, oracle_s=t2 - t1)
    return totals, launches, state


def gpt2_segmented_trace(card: str) -> tuple[dict, dict]:
    """Phase 23b: int8 GPT-2 small b1 s128 (TRANSFORMER_INT8_SCAN, unfused)
    traced on the card through the "torch-segmented" backend, byte-equal to
    the "torch" backend's trace and verified.  Returns the raw kernels'
    launches in the segmented traces and their largest |err|."""
    import filecmp

    from tachikoma_tpu_torch.models.transformer import gpt2_small
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8_SCAN
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.trace.emitter import TraceEmitter, verify_trace
    from tachikoma_tpu_torch.trace.native import native_verify

    model = f"int8 GPT-2 small b1 s{SEQ}"
    phase(f"23b. {model}: quantize (TRANSFORMER_INT8_SCAN), unfused; TraceEmitter(backend="
          f"'torch-segmented') against backend='torch' on the card [{card}]")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    q = quantize(gpt2_small(batch_size=1, seq_len=SEQ, seed=SEED),
                 [rng.integers(0, 50257, (1, SEQ)).astype(np.int32)], TRANSFORMER_INT8_SCAN)
    x = rng.integers(0, 50257, (1, SEQ)).astype(np.int32)
    say(f"build + calibrate + quantize {time.perf_counter() - t0:.2f} s (host)")
    tdir = tempfile.gettempdir()
    path = os.path.join(tdir, f"tk_chip_smoke_{os.getpid()}_seg.bin")
    ref_path = os.path.join(tdir, f"tk_chip_smoke_{os.getpid()}_whole.bin")
    meta = {"model": f"gpt2_small_b1_s{SEQ}_scan"}
    try:
        em = TraceEmitter(q, backend="torch-segmented", device="cuda", meta=meta)
        ex = em._executor
        say(f"the segmented backend's executor: {len(ex.segments)} segments, {ex.n_programs} "
            f"programs, scan runs {ex.scan_runs} (every node is captured)")
        calls: list = []
        with recording(calls):
            ex.run_device(x)
        errs = hold_calls(calls)
        say("raw kernel calls of one forward, each == plain: " + ", ".join(
            f"{n} {name}" for name, n in sorted(Counter(c[0] for c in calls).items())))
        reset(INT8_TRACE_KERNELS)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            n_records = em.emit_to(x, path)
            times.append(time.perf_counter() - t0)
        launches = read_launches(INT8_TRACE_KERNELS, f"the segmented {model} trace")
        say(", ".join(f"{k}: {n} launches in 2 traces" for k, n in launches.items()))
        whole = TraceEmitter(q, backend="torch", device="cuda", meta=meta)
        whole.emit_to(x, ref_path)
        t0 = time.perf_counter()
        whole.emit_to(x, ref_path)
        t_whole = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        assert filecmp.cmp(path, ref_path, shallow=False), "segmented trace != whole-graph trace"
        say(f"records {n_records}, {nbytes / 1e6:.1f} MB; trace s: segmented {times[0]:.4f} "
            f"(first) {times[1]:.4f}, whole graph {t_whole:.4f}; the two files byte-equal "
            f"(writer {em.last_timings['writer']}, {tdir} on {filesystem_type(tdir)})")
        assert native_verify(path) == n_records
        t0 = time.perf_counter()
        res = verify_trace(path, q)
        assert res["records"] == n_records
        say(f"CRCs ok (native); verify_trace: {res['verified']}/{res['records']} records in "
            f"{time.perf_counter() - t0:.2f} s")
        say(verify_cone(path, q, res))
    finally:
        for p in (path, ref_path):
            if os.path.exists(p):
                os.unlink(p)
    return launches, errs


def verify_cone(path: str, graph, res: dict) -> str:
    """verify_trace's mismatches, held to section 2's rule: only records of
    the float product cone (a float product on cuBLAS, in another sum order
    than numpy's, and the float nodes it feeds) may miss the verifier's
    rtol 1e-5, atol 1e-6, and each of those is re-run by the numpy oracle
    and held within the float transformers' GRAPH_RTOL / GRAPH_ATOL."""
    from tachikoma_tpu_torch.ir.graph import Node
    from tachikoma_tpu_torch.ir.registry import get_op
    from tachikoma_tpu_torch.trace.format import ROLE_INPUT, ROLE_PARAM, TraceReader

    cone = float_product_cone(graph)
    off = {name for name, _ in res["mismatches"]}
    assert off <= cone, [m for m in res["mismatches"] if m[0] not in cone][:5]
    worst, held = 0.0, 0
    with open(path, "rb") as f:
        for rec in TraceReader(f):
            if rec.name not in off:
                continue
            args = [t.to_array() for t in rec.tensors if t.role in (ROLE_INPUT, ROLE_PARAM)]
            shadow = Node(rec.name, rec.op_name, tuple(f"i{k}" for k in range(len(args))),
                          {k: tuple(v) if isinstance(v, list) else v
                           for k, v in rec.attrs.items()})
            want = np.asarray(get_op(rec.op_name).np_impl(*args, node=shadow), np.float64)
            got = rec.output.to_array().astype(np.float64)
            np.testing.assert_allclose(got, want, rtol=GRAPH_RTOL, atol=GRAPH_ATOL,
                                       err_msg=rec.name)
            worst = max(worst, float(np.abs(got - want).max()))
            held += 1
    assert held == len(off)
    return (f"the {len(off)} records verify_trace leaves ({', '.join(sorted(off)) or 'none'}) "
            f"are in the float product cone ({len(cone)} nodes) and within rtol {GRAPH_RTOL} "
            f"atol {GRAPH_ATOL} of the oracle (max |err| {worst:.3e})")


def calibration_and_cli(card: str, vitl: dict, r50_state: dict) -> None:
    """Phase 23c: the "torch-cpu" calibration of the ViT-L float graph against
    the oracle's; the CLI's `run --segmented` and `profile` (both modes) on
    the saved int8 ResNet-50 b8 graph, on the card."""
    from dataclasses import replace

    from tachikoma_tpu_torch.cli import main as cli_main
    from tachikoma_tpu_torch.quantize.calibrate import calibrate
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8_SCAN
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    phase(f"23c. the 'torch-cpu' calibration of the float ViT-L/16 b1 {IMAGE}^2 (segmented, "
          f"streamed, on the host) against the oracle's [{card}]")
    t0 = time.perf_counter()
    c_cpu = calibrate(vitl["float_graph"], [vitl["calib"]],
                      replace(TRANSFORMER_INT8_SCAN, calibrate_backend="torch-cpu"))
    t_cpu = time.perf_counter() - t0
    assert set(c_cpu.stats) == set(vitl["c_oracle"].stats)
    worst = 0.0
    for k in c_cpu.stats:
        s1, z1 = vitl["c_oracle"].scale_zp(k)
        s2, z2 = c_cpu.scale_zp(k)
        rel = abs(s1 - s2) / max(s1, 1e-12)
        assert rel < CALIB_RTOL and z1 == z2, (k, s1, s2)
        worst = max(worst, rel)
    say(f"{len(c_cpu.stats)} scales, largest relative difference {worst:.3e} (< {CALIB_RTOL}); "
        f"oracle {vitl['oracle_s']:.2f} s, torch-cpu {t_cpu:.2f} s (host)")

    phase(f"23c. the CLI on the saved int8 ResNet-50 b{BATCH} {IMAGE}^2 graph: run --segmented, "
          f"profile --mode ablate, profile --mode isolated --top 10 (device cuda) [{card}]")
    tdir = tempfile.mkdtemp()
    graph_path = os.path.join(tdir, "r50.json")
    x_path, out_path = os.path.join(tdir, "x.npy"), os.path.join(tdir, "out.npz")
    q = r50_state["quantized"]
    with open(graph_path, "w") as f:
        f.write(q.to_json())
    x = r50_state["requests"][0]
    np.save(x_path, x)
    try:
        for argv in (["run", graph_path, "--segmented", "--input", x_path, "-o", out_path],
                     ["profile", graph_path, "--mode", "ablate", "--input", x_path],
                     ["profile", graph_path, "--mode", "isolated", "--top", "10", "--input",
                      x_path]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli_main(argv)
            say(f"$ python -m tachikoma_tpu_torch.cli {' '.join(argv[:1] + argv[2:])} "
                f"({time.perf_counter() - t0:.2f} s)")
            text = buf.getvalue()
            if "ablate" in argv:
                say(text.rstrip())
                assert "cum ms" in text and f"device: {torch.cuda.get_device_name(0)}" in text
            elif "isolated" in argv:
                say(text.rstrip())
                lines = text.rstrip().splitlines()
                assert "GOPS" in lines[0] and len(lines) == 12 and "whole-graph" in lines[-1]
        got = np.load(out_path)[q.outputs[0]]
        want = TorchExecutor(q, fuse=True, device="cuda").run(x)[0]
        assert got.shape == (BATCH, 1000) and np.array_equal(got, want)
        say(f"run --segmented: output {got.shape} == TorchExecutor(fuse=True) on the card")
    finally:
        for p in (graph_path, x_path, out_path):
            if os.path.exists(p):
                os.unlink(p)
        os.rmdir(tdir)


def placement_path(card: str, bert: dict) -> dict:
    """Phase 23d: phase 17's int8 BERT-base b4 s128 with its embedding lookup
    on the host (devices ("cuda:0", "cpu")); outputs == the single-device
    executor on the card.  Returns the kernels' launches in its requests."""
    from tachikoma_tpu_torch.runtime.placement import (HeterogeneousExecutor,
                                                       embeddings_on_host, plan_devices)

    model = f"int8 BERT-base b{BERT_BATCH} s{SEQ}"
    phase(f"23d. {model}: the embedding lookups on the host, the rest on cuda:0 "
          f"(HeterogeneousExecutor, devices ('cuda:0', 'cpu')) [{card}]")
    fused, requests, ex = bert["fused"], bert["requests"], bert["ex"]
    placed = embeddings_on_host(fused)
    plan = plan_devices(placed)
    on_host = sorted(k for k, d in plan.items() if d == 1)
    hx = HeterogeneousExecutor(placed, devices=("cuda:0", "cpu"))
    say(f"on the host: {on_host}; segments (device id, nodes): "
        + ", ".join(f"({d}, {len(ns)})" for d, ns in hx.segments))
    reset(INT8_TRANSFORMER_KERNELS)
    med, lat = median_requests(hx.run_device, requests[:SEGMENTED_REQUESTS])
    launches = read_launches(INT8_TRANSFORMER_KERNELS, f"the placed {model} path")
    say(f"transfers per request {hx.transfers}; " + ", ".join(
        f"{k}: {n} launches" for k, n in launches.items()))
    out_index = [ex.capture.index(o) for o in fused.outputs]
    for x in requests[:2]:
        got = [_host(o) for o in hx.run_device(x)]
        want = [_host(ex.run_device(x)[i]) for i in out_index]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    med_one, _ = median_requests(ex.run_device, requests[:SEGMENTED_REQUESTS])
    say(f"outputs == TorchExecutor on the card; latency ms median: placed {med:.3f}, one device "
        f"{med_one:.3f}; placed, all: " + " ".join(f"{v:.3f}" for v in lat))
    assert hx.transfers == 1, hx.transfers
    return launches


def bucketed_path(card: str, r50_state: dict) -> dict:
    """Phase 23e: int8 ResNet-50 fused through BucketedExecutor with buckets
    (1, 2, 4, 8) at batches 1, 3 and 8: rows == TorchExecutor at the true
    batch on the card.  Returns the kernels' launches in its requests."""
    from tachikoma_tpu_torch.runtime.bucketed import BucketedExecutor
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    phase(f"23e. int8 ResNet-50 {IMAGE}^2 fused through BucketedExecutor(buckets={BUCKETS}) at "
          f"batches {BUCKET_BATCHES} [{card}]")
    q = r50_state["quantized"]
    bx = BucketedExecutor(q, buckets=BUCKETS, fuse=True, device="cuda")
    rng = np.random.default_rng(SEED + 23)
    launches: dict = {}
    for b in BUCKET_BATCHES:
        feeds = [rng.standard_normal((b, IMAGE, IMAGE, 3)).astype(np.float32)
                 for _ in range(SEGMENTED_REQUESTS)]
        t0 = time.perf_counter()
        bx.run_device(feeds[0])
        t_first = time.perf_counter() - t0
        reset(RUN_KERNELS)
        med, _ = median_requests(bx.run_device, feeds)
        for k, n in read_launches(RUN_KERNELS, f"the bucketed ResNet-50 at b{b}").items():
            launches[k] = launches.get(k, 0) + n
        got = _host(bx.run_device(feeds[0])[0])
        exact = TorchExecutor(bx._graph_for(b), fuse=True, device="cuda")
        want = exact.run(feeds[0])[0]
        assert got.shape == want.shape == (b, 1000) and np.array_equal(got, want)
        med_exact, _ = median_requests(exact.run_device, feeds)
        bucket = next(v for v in BUCKETS if v >= b)
        say(f"b{b} on bucket {bucket}: rows == TorchExecutor at b{b}; first call {t_first:.2f} s; "
            f"latency ms median {med:.3f} (exact-shape executor {med_exact:.3f})")
    say(f"buckets built: {bx.compiled_buckets}; launches: {launches}")
    assert bx.compiled_buckets == [1, 4, 8]
    return launches


def executors_path(card: str, r50_state: dict, bert: dict) -> tuple[dict, dict, dict]:
    """Phase 23 (23a-23e).  Returns 23a's kernel totals, each kernel's
    launches over 23a-23e's counted runs, and its largest |err|."""
    totals, launches, vitl = vitl_segmented_path(card)
    errs = {k: t["max_abs_err"] for k, t in totals.items()}

    def merge(part_launches, part_errs=None):
        for k, n in part_launches.items():
            launches[k] = launches.get(k, 0) + n
        for k, e in (part_errs or {}).items():
            errs[k] = max(errs.get(k, 0), e)

    merge(*gpt2_segmented_trace(card))
    calibration_and_cli(card, vitl, r50_state)
    merge(placement_path(card, bert))
    merge(bucketed_path(card, r50_state))
    return totals, launches, errs


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# dynamic shapes, control flow and quantization-aware training (phase 24)
# ---------------------------------------------------------------------------

TOPK_KS = (1, 5, 10, 5)           # 24a: three specializations, then a hit
HIT_REQUESTS = 20                 # 24a: hits and static-graph requests, in turns
CONTROL_REQUESTS = 20             # 24b: requests per graph, the flags and trip counts in turns
LOOP_TRIPS = (0, 1, 4)            # 24b
CONTROL_KERNELS = ("qgemm_raw",)  # a branch's and a loop body's qnn.dense on K4's GEMM mode
QAT_STEPS = 3
# 24d: each SGD step is the gradient scaled to this length in parameter
# space: the random ResNet-50's loss is 10^6-10^8 (its logits are that
# large), where a fixed rate either stalls or diverges; 0.01 descended at
# every step on the CPU at b2 32^2, b2 64^2 and b4 96^2 (0.05 overshot at 32^2)
QAT_STEP_LENGTH = 0.01
QAT_LOSS_RTOL = 1e-4              # step 0's loss of the float graph, card vs CPU
# each gradient of the float graph, card vs CPU, norm-wise relative.  A
# relu whose input the card's float sums put on the other side of 0 from
# the CPU's (or a max pool's near tie that they order otherwise) changes
# the gradient of every leaf before it: by up to 7.0e-3 at conv0_w, where
# the CPU's own spread under a QAT_NUDGE move is 6.6e-3.  So the CPU takes
# the card's branches (card_branches), and every leaf is held within
# GRAD_NORMWISE, which the control, the backward in TF32 (`_tf32_grads`),
# must exceed on most leaves: the card read 6.2e-8 to 1.8e-6, the control
# 9.9e-5 to 1.2e-3 on 266 of 267 (NVIDIA H100 80GB HBM3, 700.00 W)
GRAD_NORMWISE = 1e-5
BRANCH_OPS = ("nn.relu", "nn.max_pool2d")  # ResNet-50's float ops with a branch
# step 0's loss of the fake-quant graph, card vs CPU: between the card's
# reading (1.05e-4, NVIDIA H100 80GB HBM3, 700.00 W) and the CPU's own
# spread under a QAT_NUDGE move of every weight (8.9e-4)
QAT_FQ_LOSS_RTOL = 3e-4
# the fake-quant pairs held card against CPU at full size: this conv's
# activation (a real NHWC activation of the stepped model on another batch;
# one entry past the calibrated range) and weight (per-channel scales on
# HWIO's last axis)
STE_LAYER = "s0b0_conv2"
QAT_NUDGE = 1e-7                  # the CPU's own spread: every weight moved by this, relative
REMAT_NORMWISE = 1e-5             # remat=True against remat=False on the card (the same forward)


def runtime_cases():
    """tests/runtime_cases.py (no jax): the dyn.* cases, the topk head, the
    control-flow graphs and the training loss shared with the tests."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import runtime_cases as cases

    return cases


def same_outputs(got, want, what: str, float_tol=(SOFTMAX_RTOL, SOFTMAX_ATOL)) -> None:
    """== and one dtype; float arrays within `float_tol`."""
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, *float_tol, err_msg=what)
        else:
            assert (a == b).all(), f"{what}: != the CPU path"


def dyn_head_path(card: str, r50_state: dict) -> tuple[dict, dict]:
    """Phase 24a: phase 3's int8 ResNet-50 with a dyn.topk head (k an
    int32 input) on the int8 logits, fused, through DynShapeExecutor on the
    card.  Returns the launches and the kernels' largest |err|."""
    from tachikoma_tpu_torch.ir.graph import Graph, Node
    from tachikoma_tpu_torch.ops.kernels import matmul_int8
    from tachikoma_tpu_torch.runtime.dynshape import DynShapeExecutor, specialize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    cases = runtime_cases()
    model = f"int8 ResNet-50 b{BATCH} {IMAGE}^2"
    phase(f"24a. dynamic head: {model} (phase 3's graph) with a dyn.topk (axis -1, both) on "
          f"its int8 logits, k an int32 input, fused [{card}]")
    t0 = time.perf_counter()
    fused = fuse_qnn(cases.with_topk_head(r50_state["quantized"], Node, Graph))
    ops = Counter(n.op for n in fused.nodes)
    n_tk = sum(v for op, v in ops.items() if op.startswith("tk."))
    say(f"with_topk_head + fuse_qnn {time.perf_counter() - t0:.2f} s (host): {n_tk} tk.* ops, "
        f"{ops['dyn.topk']} dyn.topk")
    assert ops["dyn.topk"] == 1 and {k: ops[k] for k in ONNX_R50_OPS} == ONNX_R50_OPS, ops
    # a new executor, as a user builds it: its own copy of the weights,
    # packed K-major at the first request and shared by every specialization
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ex = DynShapeExecutor(fused, device="cuda")
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in ex._params.values())
    say(f"DynShapeExecutor(fused, device='cuda'): {torch.cuda.memory_allocated() - base} "
        f"device bytes at construction; the weights: {weights} bytes in {len(ex._params)} "
        f"tensors, one copy")
    x = r50_state["requests"][0]
    feeds = [{"data": x, "k": np.array([k], np.int32)} for k in TOPK_KS]
    cpu = DynShapeExecutor(fused, device="cpu")
    cpu_outs = {}
    t0 = time.perf_counter()
    for f in feeds:
        k = int(f["k"][0])
        if k not in cpu_outs:
            cpu_outs[k] = cpu.run(f)
    say(f"CPU path, k in {sorted(cpu_outs)}: {time.perf_counter() - t0:.2f} s (host)")

    def request(f) -> list:
        misses = ex.misses
        t0 = time.perf_counter()
        o = [v.cpu().numpy() for v in ex.run_device(f)]
        secs = time.perf_counter() - t0
        build = ex.miss_seconds[-1] if ex.misses > misses else None
        say(f"request k={int(f['k'][0]):2d}: {'miss' if build else 'hit'}, "
            f"{secs * 1e3:.1f} ms (host)"
            + (f"; fold {build['fold'] * 1e3:.2f} ms, infer {build['infer'] * 1e3:.2f} ms, "
               f"build {build['build'] * 1e3:.2f} ms" if build else ""))
        return o

    # the first request packs the weights; its K1-K3 calls are recorded and
    # held == plain, and then let go
    packed = packed_weights()
    reset(RUN_KERNELS)
    calls: list = []
    with recording(calls):
        outs = [request(feeds[0])]
    launches = read_launches(RUN_KERNELS, "the dynamic head's first request")
    errs = hold_calls(calls)
    kmajor = [v[2] for v in matmul_int8._KMAJOR.values() if id(v[2]) not in packed]
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for _, a, k in calls for t in (*a, *k.values()) if isinstance(t, torch.Tensor)}
    own = {t.untyped_storage().data_ptr() for t in ex._params.values()}
    say(f"{len(calls)} K1-K3 calls of the first request, all == plain; their recorded "
        f"tensors held {sum(v for p, v in held.items() if p not in own)} device bytes beside "
        f"the weights until let go")
    del calls, held
    torch.cuda.synchronize()
    mem = [torch.cuda.memory_allocated() - base]
    packed = packed_weights()
    say(f"after the first request: {mem[0]} device bytes over the executor's start = the "
        f"weights {weights} + {len(kmajor)} K-major packed weights "
        f"{sum(t.numel() * t.element_size() for t in kmajor)} + "
        f"{mem[0] - weights - sum(t.numel() * t.element_size() for t in kmajor)} other")
    del kmajor
    reset(RUN_KERNELS)
    for f in feeds[1:]:
        outs.append(request(f))
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated() - base)
    for name, n in read_launches(RUN_KERNELS, "the dynamic head's later requests").items():
        launches[name] += n
    assert (ex.misses, ex.hits, len(ex._cache)) == (3, 1, 3), (ex.misses, ex.hits)
    new_packs = packed_weights() - packed
    say(f"device bytes over the executor's start after 1 specialization {mem[0]}, after 3 "
        f"{mem[2]}, after the hit {mem[3]}; weights packed after the first request: "
        f"{len(new_packs)}")
    assert not new_packs and mem == [mem[0]] * len(mem), (len(new_packs), mem)
    for f, o in zip(feeds, outs):
        k = int(f["k"][0])
        same_outputs(o, cpu_outs[k], f"k={k} vs the CPU path")
        sg, key = specialize(fused, f)
        assert key == (("head_topk", ((k,),)),) and sg["head_topk"].op == "topk"
        static = TorchExecutor(sg, device="cuda", params=ex._params).run({"data": x})
        same_outputs(o, static, f"k={k} vs the static topk", float_tol=(0, 0))
        assert o[1].shape == (BATCH, k) and o[2].shape == (BATCH, k)
    say(f"every output == the CPU path (probabilities within rtol {SOFTMAX_RTOL} atol "
        f"{SOFTMAX_ATOL}) and == the graph with k a static topk, at k = "
        + ", ".join(str(k) for k in TOPK_KS))
    logits_name = next(n for n in fused.nodes if n.op == "qnn.dequantize").inputs[0]
    logits = r50_state["plain"][r50_state["names"].index(logits_name)]
    wrapped = int(((logits == -128).any(axis=-1)).sum())
    say(f"the int8 logits ({logits_name}, {logits.shape}) hold {int((logits == -128).sum())} "
        f"entries of -128, in {wrapped} of {BATCH} rows: the reference oracle's wrapped "
        f"negation would rank -128 first there (ROADMAP Queue 3)")

    phase(f"24a. {model}: {HIT_REQUESTS} hits (k=5) and {HIT_REQUESTS} requests of "
          f"TorchExecutor on the static graph, in turns [{card}]")
    static_ex = TorchExecutor(specialize(fused, feeds[1])[0], device="cuda", params=ex._params)
    reqs = r50_state["requests"]
    reset(RUN_KERNELS)
    hit_lat, static_lat = [], []
    for i in range(HIT_REQUESTS):
        xi = reqs[i % len(reqs)]
        for run, lat in ((lambda: ex.run_device({"data": xi, "k": feeds[1]["k"]}), hit_lat),
                         (lambda: static_ex.run_device({"data": xi}), static_lat)):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
    runs = read_launches(RUN_KERNELS, "the hits and the static requests")
    for name, n in runs.items():
        launches[name] += n
    assert ex.hits == 1 + HIT_REQUESTS and ex.misses == 3
    new_packs = packed_weights() - packed
    assert not new_packs, f"{len(new_packs)} weights packed during the requests"
    hit_ms, static_ms = statistics.median(hit_lat[1:]), statistics.median(static_lat[1:])
    say(f"hit median {hit_ms:.3f} ms, static TorchExecutor median {static_ms:.3f} ms, ratio "
        f"{hit_ms / static_ms:.3f} (b{BATCH}, host clock, the first of each dropped) [{card}]")
    say(f"weights packed after the first request, in the {len(feeds) - 1} later requests and "
        f"the {2 * HIT_REQUESTS} timed: 0")
    return launches, errs


def control_path(card: str, r50_state: dict) -> tuple[dict, dict]:
    """Phase 24b: tk.cond between two int8 heads and tk.while_loop over an
    int8 block, on ResNet-50 b8's pooled int8 features."""
    from tachikoma_tpu_torch import Graph, GraphBuilder, infer_types
    from tachikoma_tpu_torch.ops import control
    from tachikoma_tpu_torch.ops.kernels import _lib
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor
    from tachikoma_tpu_torch.trace.emitter import TraceEmitter, emit_trace, verify_trace

    cases = runtime_cases()
    pkg = (GraphBuilder, Graph, infer_types)
    fused, names = r50_state["fused"], r50_state["names"]
    gap = next(n.name for n in fused.nodes if n.op == "nn.global_avg_pool2d")
    feats = r50_state["plain"][names.index(gap)].reshape(BATCH, -1)
    width = feats.shape[1]
    assert feats.dtype == np.int8 and width == 2048, (feats.dtype, feats.shape)
    phase(f"24b. control flow at ResNet-50's head: its pooled int8 features {feats.shape} "
          f"({gap}, phase 3's CPU path); tk.cond between two int8 heads (qnn.dense {width} -> "
          f"1000, requantize), tk.while_loop over a qnn.dense {width} -> {width} + requantize + "
          f"clip block [{card}]")
    graphs = {"cond": cases.cond_heads(*pkg, batch=BATCH, features=width, classes=1000),
              "while": cases.while_blocks(*pkg, batch=BATCH, features=width)}
    feeds = {"cond": [{"flag": np.asarray(f), "features": feats} for f in (True, False)],
             "while": [{"i0": np.int32(0), "n": np.int32(n), "features": feats}
                       for n in LOOP_TRIPS]}
    launches, errs = {name: 0 for name in CONTROL_KERNELS}, {}
    for which, g in graphs.items():
        ex, cpu = TorchExecutor(g, device="cuda"), TorchExecutor(g, device="cpu")
        answers = []
        for f in feeds[which]:
            reset(CONTROL_KERNELS)
            calls: list = []
            with recording(calls):
                got = ex.run(f)
            for name in CONTROL_KERNELS:
                launches[name] += _lib.LAUNCHES[name]
            for name, e in hold_calls(calls).items():
                errs[name] = max(errs.get(name, 0), e)
            same_outputs(got, cpu.run(f), f"{which} {f.get('flag', f.get('n'))}")
            answers.append(got[-1])
            trips = f"n={int(f['n'])}, count {int(got[0])}" if which == "while" else \
                f"flag {bool(f['flag'])}"
            say(f"{which} {trips}: == the CPU path, {len(calls)} K4 calls == plain")
        assert not (answers[0] == answers[1]).all(), f"{which}: the two runs agree"
        reset(CONTROL_KERNELS)
        control.HOST_READS.clear()
        lat = []
        for i in range(CONTROL_REQUESTS):
            f = feeds[which][i % len(feeds[which])]
            t0 = time.perf_counter()
            ex.run_device(f)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        for name in CONTROL_KERNELS:
            launches[name] += _lib.LAUNCHES[name]
        reads = sum(control.HOST_READS.values())
        say(f"{which}: {CONTROL_REQUESTS} requests ({'flags' if which == 'cond' else 'n'} in "
            f"turns) median {statistics.median(lat[1:]):.3f} ms, all "
            + " ".join(f"{v:.2f}" for v in lat)
            + f"; host reads {reads / CONTROL_REQUESTS:.2f} per request [{card}]")
    assert launches["qgemm_raw"] > 0

    g1 = cases.cond_heads(*pkg, batch=1, features=width, classes=1000)
    f1 = {"flag": np.asarray(False), "features": feats[:1]}
    t0 = time.perf_counter()
    blob = TraceEmitter(g1, backend="torch", device="cuda").emit_bytes(f1)
    t1 = time.perf_counter()
    assert blob == emit_trace(g1, f1, backend="torch", device="cpu")
    report = verify_trace(blob, g1)
    assert report["mismatches"] == [], report["mismatches"][:3]
    say(f"b1 trace of the cond graph on the card: {len(blob)} bytes, {(t1 - t0) * 1e3:.1f} ms, "
        f"byte-equal to the CPU path's, verify_trace: {report['records']} records, no mismatch")
    return launches, errs


def dyn_ops_on_card(card: str) -> None:
    """Phase 24c: every dyn.* op at tests/test_dyn.py's shapes through
    DynShapeExecutor(device='cuda') == device='cpu'."""
    from tachikoma_tpu_torch import GraphBuilder
    from tachikoma_tpu_torch.runtime.dynshape import DynShapeExecutor

    cases = runtime_cases()
    phase(f"24c. the 17 dyn.* ops at tests/test_dyn.py's shapes: DynShapeExecutor(device='cuda') "
          f"== device='cpu' [{card}]")
    seen = set()
    for cid, build, feeds in cases.CASES:
        g = build(GraphBuilder)
        ex = DynShapeExecutor(g, device="cuda")
        got, want = ex.run(dict(feeds)), DynShapeExecutor(g, device="cpu").run(dict(feeds))
        same_outputs(got, want, cid, float_tol=(0, 0))
        ops = {n.op for n in g.nodes if n.op.startswith("dyn.")}
        seen |= ops
        if ops == {"dyn.nonzero"}:
            assert list(ex._cache) == [()], "dyn.nonzero specialized"
        say(f"  {cid:20s} {'+'.join(sorted(ops)):36s} == "
            + ("(unspecialized)" if ops == {"dyn.nonzero"} else f"key {list(ex._cache)[0]}"))
    assert seen == cases.DYN_OPS, sorted(cases.DYN_OPS - seen)
    say(f"{len(seen)} dyn.* ops, {len(cases.CASES)} cases held")


def _loss_and_grads(graph, feeds, device: str):
    """One value_and_grad_fn step of `graph` on `device` from its own weights."""
    from tachikoma_tpu_torch.runtime.autodiff import value_and_grad_fn

    fn, train, _ = value_and_grad_fn(graph, device=device)
    return fn(train, feeds)


def _cpu_spread(graph, feeds, loss, grads) -> tuple[float, str, float]:
    """The CPU against its own (loss, grads) with every weight moved by
    QAT_NUDGE relative (normal, seed SEED + 1): the largest gradient
    difference norm-wise, its parameter, and the loss's relative difference."""
    from tachikoma_tpu_torch.runtime.autodiff import value_and_grad_fn

    fn, train, _ = value_and_grad_fn(graph, device="cpu")
    rng = np.random.default_rng(SEED + 1)
    moved_loss, moved = fn({k: v * (1 + QAT_NUDGE * torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32))) for k, v in train.items()},
        feeds)
    d, k = max((_normwise(moved[k], grads[k]), k) for k in grads)
    return d, k, abs(float(moved_loss) - float(loss)) / abs(float(loss))


def _pool_windows(data: torch.Tensor, node) -> torch.Tensor:
    """nn.max_pool2d's windows of NHWC `data`, (n, oh, ow, c, kh, kw), the
    padding -inf (as ops/nn.py's impl makes them)."""
    from tachikoma_tpu_torch.ops.nn import _pool_geometry

    kh, kw, sh, sw, (pt, pl, pb, pr), _, _ = _pool_geometry(node, *data.shape[1:3])
    padded = torch.nn.functional.pad(data, (0, 0, pl, pr, pt, pb), value=float("-inf"))
    return padded.unfold(1, kh, sh).unfold(2, kw, sw)


def _branch_weights(node, x: torch.Tensor) -> torch.Tensor:
    """The share of the gradient that `node`'s backward gives each element
    at input `x`: an nn.relu's (torch.maximum: 1 above 0, 0.5 at 0, 0
    below), an nn.max_pool2d's per window element (amax: 1 / the window's
    count of maxima at each maximum, else 0)."""
    if node.op == "nn.relu":
        return (x > 0).float() + 0.5 * (x == 0).float()
    win = _pool_windows(x, node)
    top = (win == win.amax(dim=(-2, -1), keepdim=True)).float()
    return top / top.sum(dim=(-2, -1), keepdim=True)


def card_branches(graph, feeds) -> tuple[dict, list[str]]:
    """The branches of `graph`'s float forward on the card: for each
    nn.relu and nn.max_pool2d, _branch_weights at the card's input (on the
    host); and the nodes whose CPU input takes another branch on some
    element, in topological order."""
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    nodes = [n for n in graph.nodes if n.op in BRANCH_OPS]
    ins = [n.inputs[0] for n in nodes]
    card = TorchExecutor(graph, capture=ins, device="cuda").run_device(feeds)
    cpu = TorchExecutor(graph, capture=ins, device="cpu").run_device(feeds)
    weights, flips = {}, []
    for n, a, b in zip(nodes, card, cpu):
        weights[n.name] = _branch_weights(n, a).cpu()
        if not torch.equal(weights[n.name], _branch_weights(n, b)):
            flips.append(n.name)
    return weights, flips


@contextlib.contextmanager
def taking(weights: dict):
    """The CPU's nn.relu and nn.max_pool2d take the branches `weights` gives
    (card_branches): relu(x) as x * w, a max pool as each window's sum of
    x * share, so the backward routes the gradient as the card's did; the
    forward moves by no more than the inputs' own ulps."""
    from tachikoma_tpu_torch.ir.registry import get_op

    relu, pool = get_op("nn.relu"), get_op("nn.max_pool2d")
    impls = relu.torch_impl, pool.torch_impl

    def relu_as(x, *, node):
        return x * weights[node.name] if node.name in weights else impls[0](x, node=node)

    def pool_as(x, *, node):
        if node.name not in weights:
            return impls[1](x, node=node)
        share = weights[node.name]
        win = _pool_windows(x, node)
        return torch.where(share > 0, win, torch.zeros_like(win)).mul(share).sum(dim=(-2, -1))

    relu.torch_impl, pool.torch_impl = relu_as, pool_as
    try:
        yield
    finally:
        relu.torch_impl, pool.torch_impl = impls


def float_grads_check(g, feeds, card: str) -> None:
    """24d's float graph (no fake quant): value_and_grad_fn's loss and
    gradients on the card against the CPU's taking the card's branches
    (card_branches, taking): the loss within QAT_LOSS_RTOL, every
    gradient within GRAD_NORMWISE norm-wise, which the control, the
    backward in TF32, exceeds on most of them."""
    weights, flips = card_branches(g, feeds)
    cpu_s = time.perf_counter()
    with taking(weights):
        closs, cgrads = _loss_and_grads(g, feeds, "cpu")
    cpu_s = time.perf_counter() - cpu_s
    del weights
    loss0, grads0 = _loss_and_grads(g, feeds, "cuda")
    rel = abs(float(loss0) - float(closs)) / abs(float(closs))
    tf32 = _tf32_grads(g, feeds)
    diffs = {what: sorted(((_normwise(gr[k], cgrads[k]), k) for k in cgrads), reverse=True)
             for what, gr in (("sound", grads0), ("tf32", tf32))}
    own = _cpu_spread(g, feeds, closs, cgrads)
    say(f"step 0 of the float graph (same loss, no fake quant): loss on the card "
        f"{float(loss0):.6g}, on the CPU {float(closs):.6g} (relative {rel:.3g}; CPU step "
        f"{cpu_s:.2f} s); the CPU against itself with the weights moved by {QAT_NUDGE} "
        f"relative: {own[0]:.3g} ({own[1]}) [{card}]")
    say(f"relus and max pools whose CPU input takes another branch than the card's: "
        f"{len(flips)} ({', '.join(flips)}); the CPU takes the card's")
    over = {what: sum(d > GRAD_NORMWISE for d, _ in diffs[what]) for what in diffs}
    for what, label in (("sound", "the card's gradients"),
                        ("tf32", "the control, the card's backward in TF32")):
        nonzero = [d for d, _ in diffs[what] if d > 0]
        say(f"  {label} against the CPU's, norm-wise relative, of {len(cgrads)}: largest "
            + ", ".join(f"{d:.3g} ({k})" for d, k in diffs[what][:3])
            + f", median {statistics.median(d for d, _ in diffs[what]):.3g}, smallest "
            f"nonzero {min(nonzero):.3g}; {over[what]} above {GRAD_NORMWISE}")
    assert rel <= QAT_LOSS_RTOL and diffs["sound"][0][0] <= GRAD_NORMWISE, (
        rel, diffs["sound"][:3])
    assert 2 * over["tf32"] > len(cgrads), ("the control passes", over["tf32"], diffs["tf32"][-3:])
    say(f"held: the loss within {QAT_LOSS_RTOL}, every gradient within {GRAD_NORMWISE}, which "
        f"the control exceeds on {over['tf32']} of {len(cgrads)}")


def _tf32_grads(graph, feeds) -> dict:
    """The fault GRAD_NORMWISE is there to catch, as a control: the
    gradients of value_and_grad_fn's step with the backward run in TF32
    (torch's default for cuDNN) instead of under float32_products."""
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    ex = TorchExecutor(graph, device="cuda")
    train = {k: v.detach().requires_grad_(True) for k, v in ex._params.items()
             if v.dtype.is_floating_point}
    loss = ex.run_device(feeds, params=train)[0]
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        grads = torch.autograd.grad(loss, list(train.values()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return dict(zip(train, grads))


def ste_on_card(qat_g, train, feeds, layer: str, card: str) -> None:
    """The fake-quant pairs of conv `layer`, forward and straight-through
    backward, card against CPU on identical inputs: the activation the
    card's forward gives at the stepped weights `train`, the stepped
    weight, and one upstream gradient (seed SEED + 2).  Held ==."""
    from tachikoma_tpu_torch.ir.registry import get_op
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    conv = qat_g[layer]
    pairs = []
    for src in conv.inputs[:2]:
        sdq = qat_g[src]
        sq = qat_g[sdq.inputs[0]]
        pairs.append((sq.inputs[0], sq, sdq))
    act = pairs[0][0]
    x = TorchExecutor(qat_g, capture=[act], device="cuda").run_device(feeds, params=train)[0]
    values = {act: x.detach().cpu(), pairs[1][0]: train[pairs[1][0]].detach().cpu()}
    rng = np.random.default_rng(SEED + 2)
    sq_impl = get_op("qnn.simulated_quantize").torch_impl
    sdq_impl = get_op("qnn.simulated_dequantize").torch_impl
    saturated = []
    for name, sq, sdq in pairs:
        v = values[name]
        up = torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
        res = {}
        for dev in ("cpu", "cuda"):
            t = v.to(dev).requires_grad_(True)
            y = sdq_impl(sq_impl(t, node=sq), node=sdq)
            (g,) = torch.autograd.grad(y, t, up.to(dev))
            res[dev] = (y.detach().cpu(), g.cpu())
        (y, g), (cy, cg) = res["cuda"], res["cpu"]
        assert torch.equal(y, cy) and torch.equal(g, cg), (
            name, float((y - cy).abs().max()), float((g - cg).abs().max()))
        per = (f"per-channel on axis {sq.attrs.get('axis')}"
               if np.ndim(sq.attrs["scale"]) else "per-tensor")
        saturated.append(int((cg == 0).sum()) - int((up == 0).sum()))
        say(f"  {layer}'s fake-quant of {name} {tuple(v.shape)} ({per} scale): forward and "
            f"straight-through gradient == the CPU's; {saturated[-1]} entries saturated "
            f"(gradient 0) [{card}]")
    # the other batch takes the activation past its calibrated range: the
    # clip's zero gradient is among what was held
    assert saturated[0] > 0, saturated


def _normwise(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def qat_path(card: str, r50_state: dict) -> tuple[dict, dict]:
    """Phase 24d: quantization-aware training of float ResNet-50 b8 224^2
    on the card, then the finalized int8 model on K1-K3."""
    from tachikoma_tpu_torch.ir.graph import Graph, Node
    from tachikoma_tpu_torch.models.vision import resnet
    from tachikoma_tpu_torch.quantize.qat import qat_finalize, qat_prepare
    from tachikoma_tpu_torch.runtime.autodiff import value_and_grad_fn
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    cases = runtime_cases()
    model = f"float ResNet-50 b{BATCH} {IMAGE}^2"
    phase(f"24d. QAT: {model} (seed {SEED}) with log_softmax + nn.cross_entropy_with_logits "
          f"against one-hot labels; qat_prepare on one b{BATCH} batch [{card}]")
    float_g = resnet(50, batch_size=BATCH, image_size=IMAGE, seed=SEED)
    g = cases.with_cross_entropy(float_g, Node, Graph)
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    feeds = {"data": x, "labels": cases.one_hot_labels(BATCH, 1000, SEED)}
    t0 = time.perf_counter()
    qat_g = qat_prepare(g, [feeds])
    ops = Counter(n.op for n in qat_g.nodes)
    say(f"qat_prepare {time.perf_counter() - t0:.2f} s (host, numpy calibration): "
        f"{ops['qnn.simulated_quantize']} fake-quant pairs")

    float_grads_check(g, feeds, card)

    # the fake-quant graph, card against CPU: a rounding that a float sum in
    # another order tips over a half changes an activation by a quantum, so
    # the gradients differ as much as the CPU's own do when every weight
    # moves by QAT_NUDGE relative (printed beside, not held); the loss is held
    fn, train, _ = value_and_grad_fn(qat_g, device="cuda")
    t0 = time.perf_counter()
    loss0, grads0 = fn(train, feeds)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    closs, cgrads = _loss_and_grads(qat_g, feeds, "cpu")
    card_vs_cpu = max((_normwise(grads0[k], cgrads[k]), k) for k in cgrads)
    own = _cpu_spread(qat_g, feeds, closs, cgrads)
    fq_rel = abs(float(loss0) - float(closs)) / abs(float(closs))
    say(f"step 0 of the fake-quant graph: loss on the card {float(loss0):.6g}, on the CPU "
        f"{float(closs):.6g} (relative {fq_rel:.3g}, held within {QAT_FQ_LOSS_RTOL}), the "
        f"largest gradient difference {card_vs_cpu[0]:.3g} norm-wise ({card_vs_cpu[1]}); "
        f"the CPU against itself with the weights moved by {QAT_NUDGE} relative: loss "
        f"{own[2]:.3g}, gradients {own[0]:.3g} ({own[1]}) [{card}]")
    assert fq_rel <= QAT_FQ_LOSS_RTOL, fq_rel
    del cgrads

    # remat on the card: the same forward run again in the backward
    rfn, rtrain, _ = value_and_grad_fn(qat_g, remat=True, device="cuda")
    peaks = {}
    for what, f, t in (("remat=False", fn, train), ("remat=True", rfn, rtrain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        rloss, gr = f(t, feeds)
        torch.cuda.synchronize()
        peaks[what] = torch.cuda.max_memory_allocated() - before
    rworst = max((_normwise(gr[k], grads0[k]), k) for k in grads0)
    say(f"remat=True: loss {float(rloss):.6g}, gradients within {rworst[0]:.3g} norm-wise of "
        f"remat=False's ({rworst[1]}); peak device bytes over the parameters: remat=False "
        f"{peaks['remat=False']}, remat=True {peaks['remat=True']} [{card}]")
    assert float(rloss) == float(loss0) and rworst[0] <= REMAT_NORMWISE, (rloss, loss0, rworst)
    del gr, grads0

    phase(f"24d. {QAT_STEPS} SGD steps on the card (step length {QAT_STEP_LENGTH}) [{card}]")
    losses, step_ms = [], []
    for _ in range(QAT_STEPS):
        t0 = time.perf_counter()
        loss, grads = fn(train, feeds)
        norm = torch.sqrt(sum((v.double() ** 2).sum() for v in grads.values()))
        lr = float(QAT_STEP_LENGTH / norm)
        train = {k: v - lr * grads[k] for k, v in train.items()}
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    losses.append(float(fn(train, feeds)[0]))
    say("losses " + " -> ".join(f"{v:.6g}" for v in losses)
        + f"; ms per step {statistics.median(step_ms):.1f} (all "
        + " ".join(f"{v:.1f}" for v in step_ms) + f"; the first value_and_grad {first_ms:.1f}) "
        f"[{card}]")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    ste_on_card(qat_g, train, {**feeds, "data": r50_state["requests"][1]}, STE_LAYER, card)

    t0 = time.perf_counter()
    qg = qat_finalize(float_g, train, [x])
    t1 = time.perf_counter()
    fused = fuse_qnn(qg)
    say(f"qat_finalize {t1 - t0:.2f} s (host, the card's stepped weights read back, numpy "
        f"calibration), fuse {time.perf_counter() - t1:.2f} s")
    ops = Counter(n.op for n in fused.nodes)
    assert {k: ops[k] for k in ONNX_R50_OPS} == ONNX_R50_OPS, ops
    names = computational_nodes(fused)
    ex = TorchExecutor(fused, capture=names, device="cuda")
    requests = r50_state["requests"]
    _, _, errs = counted_forward(ex, requests[0], RUN_KERNELS, "the finalized model's first forward")
    lat, first_out, launches = timed_requests(ex, requests, RUN_KERNELS,
                                              "the finalized model's requests")
    plain = TorchExecutor(fused, capture=names, device="cpu").run(requests[0])
    n_int = hold_against_plain(names, first_out, plain, fused, SOFTMAX_RTOL, SOFTMAX_ATOL)
    say(f"finalized int8 ResNet-50: {n_int} integer nodes == the CPU path")
    say_latency(lat, BATCH)
    return launches, errs


def runtime_path(card: str, r50_state: dict) -> tuple[dict, dict]:
    """Phase 24: the dynamic head, control flow, the dyn.* ops and QAT."""
    launches, errs = {}, {}

    def merge(part):
        for name, n in part[0].items():
            launches[name] = launches.get(name, 0) + n
        for name, e in part[1].items():
            errs[name] = max(errs.get(name, 0), e)

    merge(dyn_head_path(card, r50_state))
    merge(control_path(card, r50_state))
    dyn_ops_on_card(card)
    merge(qat_path(card, r50_state))
    return launches, errs


# ---------------------------------------------------------------------------
# the TensorFlow and Keras import path (phase 25)
# ---------------------------------------------------------------------------

# the op histogram of keras.applications.ResNet50's frozen graph at b8 224^2
# (tests/test_torch_port_tf.py holds models/keras_resnet.py to Keras's own)
KERAS_R50_GRAPHDEF_OPS = {
    "Placeholder": 1, "Const": 641, "Identity": 321, "Conv2D": 53, "BiasAdd": 54, "Reshape": 265,
    "Squeeze": 53, "Rsqrt": 53, "Mul": 159, "Sub": 53, "AddV2": 122, "Relu": 49, "Pad": 2,
    "MaxPool": 1, "Mean": 1, "MatMul": 1, "Softmax": 1, "NoOp": 1}
# its fused int8 graph (the JAX package's fuse_qnn gives the same,
# tests/test_torch_port_tf.py): every batch norm stays a qnn.mul and a qnn.add
# between its conv and the ReLU, so no chain or block stack forms
KERAS_R50_OPS = {"tk.conv2d_rq": 53, "tk.conv2d_chain": 0, "tk.conv2d_block_stack": 0,
                 "tk.dense_rq": 1, "qnn.mul": 53, "qnn.add": 69}
KERAS_RUN_KERNELS = ("qgemm_rq", "qconv_rq")


def keras_resnet_path(card: str, tdir: str) -> tuple[dict, dict, dict]:
    """Phase 25a: Keras's ResNet-50 b8 224^2 written as a frozen GraphDef
    (models/keras_resnet.py, weights from SEED) to a .pb, read back with the
    port's codec (no TensorFlow on this machine), imported, quantized on
    phase 3's calibration batch and fused, then run by fused_resnet_run on
    K1 and K2.  Returns the kernels' totals and launches, and the state 25b
    and 25c read (the path, the calibration batch, the quantized graph, the
    first request and its output on the card)."""
    from tachikoma_tpu_torch.frontend import from_tf_graphdef
    from tachikoma_tpu_torch.frontend.tf_proto import load_graph_def
    from tachikoma_tpu_torch.models.keras_resnet import resnet50_keras
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    model = f"Keras ResNet-50 b{BATCH} {IMAGE}^2"
    phase(f"25a. {model}: written by models/keras_resnet.py (seed {SEED}) to a .pb, read by "
          f"frontend/tf_proto.py, from_tf_graphdef, quantize, fuse (host) [{card}]")
    path = os.path.join(tdir, "keras_resnet50.pb")
    t0 = time.perf_counter()
    blob = resnet50_keras(BATCH, IMAGE, seed=SEED)
    with open(path, "wb") as f:
        f.write(blob)
    t1 = time.perf_counter()
    gd = load_graph_def(path)
    t2 = time.perf_counter()
    g = from_tf_graphdef(gd)
    t3 = time.perf_counter()
    hist = Counter(n.op for n in gd.node)
    say(f"{path}: {len(blob)} bytes, {len(gd.node)} nodes: "
        + ", ".join(f"{v} {k}" for k, v in sorted(hist.items())))
    assert hist == KERAS_R50_GRAPHDEF_OPS, hist
    imported = Counter(n.op for n in g.nodes)
    say(f"write {t1 - t0:.2f} s, decode {t2 - t1:.2f} s, from_tf_graphdef {t3 - t2:.2f} s "
        f"(host): " + ", ".join(f"{v} {k}" for k, v in sorted(imported.items())))
    # phase 3's calibration batch, then the requests, from the seed
    rng = np.random.default_rng(SEED)
    calib = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    t0 = time.perf_counter()
    q = quantize(g, [calib])
    t1 = time.perf_counter()
    fused = fuse_qnn(q)
    say(f"simplify + calibrate + quantize {t1 - t0:.2f} s, fuse {time.perf_counter() - t1:.2f} s "
        "(host)")
    ops = Counter(n.op for n in fused.nodes)
    say("fused op counts, this graph against native ResNet-50's (phase 3): "
        + ", ".join(f"{k} {ops[k]} / {ONNX_R50_OPS.get(k, '-')}"
                    for k in ("tk.conv2d_rq", "tk.conv2d_chain", "tk.conv2d_block_stack",
                              "tk.dense_rq")))
    say("  they differ because Keras 3 writes each batch norm unfolded: simplify folds its "
        "constants to one multiply and one add a channel, which quantize as qnn.mul and "
        f"qnn.add ({ops['qnn.mul']} and {ops['qnn.add']}) between the conv's requantize and "
        "the ReLU, so fuse_qnn forms no chain and no block stack and K3 has no call; the "
        "stride sits on the 1x1 convs (the stem and the 3x3 convs run on K2, every 1x1 conv, "
        "the strided ones subsampled first, on K1's GEMM: ops/kernels/conv.py "
        "_conv1x1_matmul)")
    requests = [rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
                for _ in range(REQUESTS)]
    totals, launches, _, out, _ = fused_resnet_run("25a.", model, fused, requests, card,
                                                   KERAS_R50_OPS, KERAS_RUN_KERNELS)
    assert np.allclose(out.sum(-1), 1, atol=1e-4), out.sum(-1)
    state = dict(path=path, calib=calib, quantized=q, x=requests[0], out=out)
    return totals, launches, state


def keras_trace_path(card: str, state: dict) -> tuple[dict, dict]:
    """Phase 25b: the same .pb at b1 (input_specs), quantized on the first
    image of 25a's calibration batch and left unfused, traced on K4
    (trace_path: every K4 call == plain, every integer record byte-equal to
    the CPU plain path's trace, verify_trace)."""
    from tachikoma_tpu_torch.frontend import from_tf_graphdef
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    t0 = time.perf_counter()
    g1 = from_tf_graphdef(state["path"], {"x": (TRACE_BATCH, IMAGE, IMAGE, 3)})
    x1 = state["x"][:TRACE_BATCH]
    q1 = quantize(g1, [state["calib"][:TRACE_BATCH]])
    say(f"\n25b. the .pb at b{TRACE_BATCH} (input_specs): import, calibrate, quantize "
        f"{time.perf_counter() - t0:.2f} s (host) [{card}]")
    kernels = kernels_called(TorchExecutor(q1, device="cuda"), x1)
    assert kernels == TRACE_KERNELS, kernels
    return trace_path(("25b.", "25b."), "Keras ResNet-50", None, kernels, prepared=(q1, x1))


def keras_cli(card: str, state: dict, tdir: str) -> None:
    """Phase 25c: the port's CLI on the written .pb: `quantize` on 25a's
    calibration batch writes 25a's integer graph (equal JSON), then `run` of
    that graph on the card (the CLI's default device) gives 25a's output on
    its first request."""
    calib, xin = os.path.join(tdir, "calib.npy"), os.path.join(tdir, "x.npy")
    qpath, out = os.path.join(tdir, "q.json"), os.path.join(tdir, "y.npz")
    np.save(calib, state["calib"])
    np.save(xin, state["x"])
    cli = [sys.executable, "-m", "tachikoma_tpu_torch.cli"]
    phase(f"25c. python -m tachikoma_tpu_torch.cli quantize {state['path']} --calib-data, then "
          f"run (device cuda) [{card}]")
    t0 = time.perf_counter()
    res = subprocess.run(cli + ["quantize", state["path"], "-o", qpath, "--calib-data", calib],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    say(res.stdout.strip().splitlines()[-1])
    with open(qpath) as f:
        assert f.read() == state["quantized"].to_json(), "the CLI's integer graph is not 25a's"
    t1 = time.perf_counter()
    res = subprocess.run(cli + ["run", qpath, "--input", xin, "-o", out], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    say(res.stdout.strip().splitlines()[0] if res.stdout.strip() else "(no output)")
    got = np.load(out)
    y = got[got.files[0]]
    assert y.shape == state["out"].shape and np.isfinite(y).all()
    np.testing.assert_allclose(y, state["out"], rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL)
    say(f"quantize exit 0 in {t1 - t0:.2f} s: the integer graph == 25a's (equal JSON); run exit "
        f"0 in {time.perf_counter() - t1:.2f} s: {got.files[0]} {y.shape}, max |CLI - 25a| "
        f"{np.abs(y - state['out']).max():.3g} (rtol {SOFTMAX_RTOL} atol {SOFTMAX_ATOL}), "
        f"argmax equal {bool((y.argmax(-1) == state['out'].argmax(-1)).all())}")


def tf_ops_on_card(card: str) -> None:
    """Phase 25d: the six ops the TensorFlow importer brought (rsqrt,
    floor_divide, floor_mod, all, any, stack) on the card against their CPU
    torch impls, on tests/tf_op_cases.py's cases: all == (a zero's sign
    too), an integer divided by zero included."""
    from tachikoma_tpu_torch.ir.graph import Node
    from tachikoma_tpu_torch.ir.registry import get_op

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from tf_op_cases import CASES

    phase(f"25d. the TensorFlow importer's six new ops on the card against their CPU torch "
          f"impls: {len(CASES)} cases [{card}]")
    per_op = Counter()
    for cid, op, inputs, attrs, _, _, _, _ in CASES:
        node = Node("y", op, tuple(f"x{i}" for i in range(len(inputs))), attrs)
        impl = get_op(op).torch_impl
        a = impl(*(torch.from_numpy(v).cuda() for v in inputs), node=node).cpu().numpy()
        b = impl(*map(torch.from_numpy, inputs), node=node).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, cid
        np.testing.assert_array_equal(a, b, err_msg=cid)
        if b.dtype.kind == "f":
            seen = ~np.isnan(b)
            np.testing.assert_array_equal(np.signbit(a)[seen], np.signbit(b)[seen], err_msg=cid)
        per_op[op] += 1
    say(", ".join(f"{op} {n} cases ==" for op, n in sorted(per_op.items())))
    assert len(per_op) == 6, per_op


def tf_path(card: str) -> tuple[dict, dict]:
    """Phase 25: the TensorFlow and Keras import path (25a-25d).  Returns the
    kernels' launches over 25a and 25b's counted runs and the largest |err|
    of each."""
    tdir = tempfile.mkdtemp(prefix="tk_chip_smoke_tf_")
    try:
        totals, launches, state = keras_resnet_path(card, tdir)
        errs = {k: t["max_abs_err"] for k, t in totals.items()}
        trace_totals, trace_launches = keras_trace_path(card, state)
        for k, t in trace_totals.items():
            errs[k] = max(errs.get(k, 0), t["max_abs_err"])
        for k, n in trace_launches.items():
            launches[k] = launches.get(k, 0) + n
        keras_cli(card, state, tdir)
    finally:
        for name in os.listdir(tdir):
            os.remove(os.path.join(tdir, name))
        os.rmdir(tdir)
    tf_ops_on_card(card)
    return launches, errs


# ---------------------------------------------------------------------------
# phase 26: parallel/* over torch.distributed on the card
# ---------------------------------------------------------------------------

PARALLEL_WORLD = 4                 # rank processes, all on cuda:0 over gloo
SHARD_MESHES = ({"dp": 2, "tp": 2}, {"tp": 4})
CAPTURE_MESH = {"dp": 2, "tp": 2}  # the mesh of the every-integer-node run
SHARD_REQUESTS = 5
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-7  # tests/test_shard.py:43
RING_SHAPE = (1, 12, 4096, 64)     # int8 BERT-base's attention width, a long document
RING_SMALL = 512                   # the S held against the numpy oracle too
RING_SIZES = (2, 4)
RING_SCALES = dict(scores_scale=0.02, v_scale=0.1, output_scale=0.12)
RING_KERNELS = ("qbmm_raw",)
MOE_SHAPE = (512, 768, 3072, 8)    # tokens, BERT-base's FFN K and N, experts
EXPERT_SIZES = (2, 4)
MOE_KERNELS = ("qgemm_raw",)
PIPE_STAGES, PIPE_MICRO = 2, 4


def _sha(a) -> str:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _mesh_key(axes) -> str:
    return "x".join(f"{k}{v}" for k, v in axes.items())


def _check_rank_calls(rank: int, calls: list, names, model: str) -> dict:
    """Rank 0 holds each recorded call == plain and times it
    (check_kernels: the other ranks wait at a barrier meanwhile); every
    other rank holds its own calls == plain.  Returns rank 0's totals."""
    import torch.distributed as dist

    impl = kernel_impls()
    totals = {}
    if rank != 0:
        for name, a, k in calls:
            hold_call(name, a, k, impl)
    dist.barrier()
    if rank == 0:
        totals = check_kernels(calls, names, model)
    dist.barrier()
    return totals


def _counted(names) -> dict:
    from tachikoma_tpu_torch.ops.kernels import _lib

    return {n: _lib.LAUNCHES[n] for n in names}


def shard_rank(rank: int, spec: dict, res: dict) -> None:
    """26a on one rank: ResNet-50 b8 224^2 unfused over SHARD_MESHES, every
    K4 call == plain, SHARD_REQUESTS timed requests held against the single
    card, then (CAPTURE_MESH) every integer node's digest == the single
    card's."""
    import torch.distributed as dist

    from tachikoma_tpu_torch.ops.kernels import matmul_int8
    from tachikoma_tpu_torch.parallel.mesh import simple_mesh
    from tachikoma_tpu_torch.parallel.shard import ShardedExecutor
    from tachikoma_tpu_torch.runtime.artifact import load_artifact

    q, _ = load_artifact(spec["r50"])
    reqs = np.load(spec["requests"])
    outs_want = np.load(spec["single_outs"])
    capture = [spec["logits"], q.outputs[0]]
    for axes in SHARD_MESHES:
        key = _mesh_key(axes)
        mesh = simple_mesh(axes, backend="gloo", device="cuda:0")
        t0 = time.perf_counter()
        ex = ShardedExecutor(q, mesh, capture=capture)
        ex.run_device(reqs[0])
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        if rank == 0:
            counts = ex.plan_counts()
            phase(f"26a. ResNet-50 b{BATCH} {IMAGE}^2 unfused, ShardedExecutor over {axes} on "
                  f"{PARALLEL_WORLD} ranks (cuda:0 each, gloo) [{spec['card']}]")
            say(f"plan: products {counts['products']}; collectives per request "
                f"{counts['collectives']}")
            for line in ex.describe():
                say(f"  {line}")
            say(f"construct + first request (packs the slices K-major) {warm:.2f} s")
        calls: list = []
        with recording(calls):
            ex.run_device(reqs[0])
        torch.cuda.synchronize()
        totals = _check_rank_calls(rank, calls, TRACE_KERNELS, f"ResNet-50 {key}")
        res["totals"][key] = totals
        res["held"] += len(calls)
        packed = len(matmul_int8._KMAJOR)
        reset(TRACE_KERNELS)
        mesh.reset_stats()
        lat = []
        for i in range(1, 1 + SHARD_REQUESTS):
            dist.barrier()
            t0 = time.perf_counter()
            outs = ex.run_device(reqs[i])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            logits, prob = (o.cpu().numpy() for o in outs)
            assert (logits == outs_want["logits"][i]).all(), f"{key}: logits != single card"
            np.testing.assert_allclose(prob, outs_want["prob"][i], rtol=SHARD_RTOL,
                                       atol=SHARD_ATOL)
        launches = read_launches(TRACE_KERNELS, f"the sharded ResNet-50 over {key}")
        for name, n in launches.items():
            res["launches"][name] = res["launches"].get(name, 0) + n
        assert len(matmul_int8._KMAJOR) == packed, "a sharded request packed a weight again"
        stats = mesh.stats_snapshot()
        res["shard"][key] = dict(lat=lat, stats=stats, launches=launches)
        if rank == 0:
            say(f"{SHARD_REQUESTS} requests: int8 logits == the single card's, probabilities "
                f"within rtol {SHARD_RTOL} atol {SHARD_ATOL}; no weight packed during them")
            for kind, s in sorted(stats.items()):
                say(f"  {kind:10s} per request: {s['calls'] / SHARD_REQUESTS:6.1f} calls, "
                    f"{s['bytes'] / SHARD_REQUESTS / 1e6:9.3f} MB on the wire, "
                    f"{s['host_bytes'] / SHARD_REQUESTS / 1e6:9.3f} MB host-staged, "
                    f"{s['seconds'] / SHARD_REQUESTS * 1e3:8.3f} host ms (rank 0)")
            med = statistics.median(lat)
            say(f"latency ms per request: median {med:.3f} (single card, unfused: "
                f"{spec['single_ms']:.3f}; {med / spec['single_ms']:.2f}x), all "
                + " ".join(f"{v:.3f}" for v in lat))
            say("launches: " + ", ".join(f"{n} {v} ({v // SHARD_REQUESTS} per request on rank "
                                         "0)" for n, v in launches.items()))
        if axes == CAPTURE_MESH:
            names = list(spec["digests"])
            exc = ShardedExecutor(q, mesh, capture=names)
            t0 = time.perf_counter()
            outs = exc.run_device(reqs[1])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if rank == 0:
                bad = [n for n, o in zip(names, outs) if _sha(o) != spec["digests"][n]]
                assert not bad, f"{len(bad)} integer nodes != the single card: {bad[:5]}"
                say(f"every integer node captured over {key}: {len(names)} == the single "
                    f"card's (sha256 of each), run {t1 - t0:.2f} s, compared "
                    f"{time.perf_counter() - t1:.2f} s")
            del exc, outs
        del ex
        torch.cuda.empty_cache()


def nccl_rank(rank: int, spec: dict, res: dict) -> None:
    """26b: the same graph through ShardedExecutor on a one-rank NCCL group
    (rank 0), and the collective helper's all-reduce and all-gather on it."""
    from tachikoma_tpu_torch.parallel.mesh import simple_mesh
    from tachikoma_tpu_torch.parallel.shard import ShardedExecutor
    from tachikoma_tpu_torch.runtime.artifact import load_artifact

    mesh = simple_mesh({"dp": 1}, backend="nccl", device="cuda:0")
    if rank != 0:
        return
    q, _ = load_artifact(spec["r50"])
    reqs = np.load(spec["requests"])
    want = np.load(spec["single_outs"])
    ex = ShardedExecutor(q, mesh, capture=[spec["logits"], q.outputs[0]])
    logits, prob = (o.cpu().numpy() for o in ex.run_device(reqs[1]))
    assert (logits == want["logits"][1]).all()
    np.testing.assert_allclose(prob, want["prob"][1], rtol=SHARD_RTOL, atol=SHARD_ATOL)
    line = mesh.collective("dp")
    t = torch.arange(-5, 1000, dtype=torch.int32, device="cuda:0")
    assert torch.equal(line.all_reduce(t.clone()), t)
    assert torch.equal(line.all_gather(t, 0), t)
    stats = mesh.stats_snapshot()
    assert all(s["host_bytes"] == 0 for s in stats.values()), stats
    phase(f"26b. NCCL at world size 1: ShardedExecutor on a one-rank NCCL group == 26a's "
          f"single card (int8 logits ==, probabilities within rtol {SHARD_RTOL}); the helper's "
          f"all_reduce and all_gather on it ==, host-staged bytes 0 ({dict(stats)}) "
          f"[{spec['card']}]")
    del ex


def trace_rank(rank: int, spec: dict, res: dict) -> None:
    """26c: the tp-sharded b1 trace (tp 2, dp 1) on ranks 0 and 1 == phase
    7's bytes, verify_trace; then the two ranks upload alternate records,
    out of order, to a TraceCollector on rank 0, whose merged file == the
    same bytes."""
    import torch.distributed as dist

    from tachikoma_tpu_torch.exec.trace_collector import TraceCollector, TraceUploader
    from tachikoma_tpu_torch.parallel.gather import ShardedTraceEmitter
    from tachikoma_tpu_torch.parallel.mesh import simple_mesh
    from tachikoma_tpu_torch.runtime.artifact import load_artifact
    from tachikoma_tpu_torch.trace.emitter import _build_records, _graph_hash, verify_trace

    mesh = simple_mesh({"tp": 2}, backend="gloo", device="cuda:0")
    if not mesh.member:
        return
    line = mesh.collective("tp")
    q1, _ = load_artifact(spec["r50_b1"])
    x1 = np.load(spec["b1_input"])
    steps = {}

    def file_sha(path):
        with open(path, "rb") as f:
            return hashlib.file_digest(f, "sha256").hexdigest()

    t0 = time.perf_counter()
    em = ShardedTraceEmitter(q1, mesh, meta=spec["meta"])
    steps["construct"] = time.perf_counter() - t0
    path = os.path.join(spec["tdir"], "sharded.bin")
    t0 = time.perf_counter()
    if rank == 0:
        with open(path, "wb") as f:
            manifest = em.emit(x1, f)
    else:
        manifest = em.emit(x1, None)
    steps["emit (rank 0 writes)"] = time.perf_counter() - t0
    if rank == 0:
        t0 = time.perf_counter()
        assert os.path.getsize(path) == spec["trace_bytes"], "sharded trace size != phase 7's"
        assert file_sha(path) == spec["trace_sha256"], "sharded trace bytes != phase 7's"
        steps["sha256"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        v = verify_trace(path, q1)
        assert v["verified"] == v["records"] == manifest["records"], v["mismatches"][:3]
        steps["verify_trace"] = time.perf_counter() - t0
    # the collector: rank 0 listens; both ranks upload alternate records,
    # each in reverse order
    coll = TraceCollector(expected_workers=2) if rank == 0 else None
    port = [coll.port if coll else None]
    dist.broadcast_object_list(port, src=line.ranks[0], group=line.group)
    t0 = time.perf_counter()
    values = em.values(x1)
    recs = list(_build_records(em._ex.graph, values))
    steps["run + records"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    up = TraceUploader("127.0.0.1", port[0], f"rank{rank}")
    for rec in recs[rank::2][::-1]:
        up.send_record(rec.node_id, rec.encode())
    up.finish()
    steps["upload"] = time.perf_counter() - t0
    if rank == 0:
        t0 = time.perf_counter()
        try:
            assert coll.wait(300), "the collector did not hear both ranks finish"
            assert not coll.errors, coll.errors[:3]
            merged = os.path.join(spec["tdir"], "merged.bin")
            n = coll.write_trace(merged, _graph_hash(em._ex.graph), spec["meta"])
        finally:
            coll.close()
        assert n == manifest["records"]
        steps["merge + write"] = time.perf_counter() - t0
        assert file_sha(merged) == spec["trace_sha256"], "merged trace bytes != phase 7's"
        phase(f"26c. tp-sharded b1 trace (tp 2, dp 1, ranks 0-1): ShardedTraceEmitter's bytes "
              f"== phase 7's single-card trace ({spec['trace_bytes']} bytes, "
              f"{manifest['records']} records, sha256 {spec['trace_sha256'][:16]}), "
              f"verify_trace {v['verified']}/{v['records']}; the collector's merge of the "
              f"two ranks' alternate records, uploaded in reverse, == the same bytes "
              f"[{spec['card']}]")
        say("seconds: " + ", ".join(f"{k} {s:.2f}" for k, s in steps.items()))
        for p in (path, merged):
            os.unlink(p)
    res["trace_steps"] = steps


def ring_rank(rank: int, spec: dict, res: dict) -> None:
    """26e: ring attention at S 4096 over sp 2 and 4 == qnn.attention on the
    card, at S 512 returned for the numpy oracle; every qbmm_raw call of a
    run == plain; ms per ring size."""
    import torch.distributed as dist

    from tachikoma_tpu_torch.parallel.mesh import simple_mesh
    from tachikoma_tpu_torch.parallel.ring_attention import ring_attention_int8

    qkv = np.load(spec["ring"])
    q, k, v = (torch.from_numpy(qkv[n]).cuda() for n in "qkv")
    small = [t[..., :RING_SMALL, :].contiguous() for t in (q, k, v)]
    for sp in RING_SIZES:
        mesh = simple_mesh({"sp": sp}, backend="gloo", device="cuda:0")
        calls: list = []
        if mesh.member:
            ring_attention_int8(q, k, v, mesh, **RING_SCALES)
            with recording(calls):
                out = ring_attention_int8(q, k, v, mesh, **RING_SCALES)
            torch.cuda.synchronize()
            assert _sha(out) == spec["attn_sha"], f"ring sp {sp} != qnn.attention on the card"
        totals = _check_rank_calls(rank, calls, RING_KERNELS, f"ring sp{sp}")
        res["held"] += len(calls)
        if mesh.member:
            reset(RING_KERNELS)
            mesh.reset_stats()
            lat = []
            for _ in range(3):
                dist.barrier(group=mesh.collective("sp").group)
                t0 = time.perf_counter()
                ring_attention_int8(q, k, v, mesh, **RING_SCALES)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            for name, n in read_launches(RING_KERNELS, f"ring sp {sp}").items():
                res["launches"][name] = res["launches"].get(name, 0) + n
            stats = mesh.stats_snapshot()
            out512 = ring_attention_int8(*small, mesh, **RING_SCALES).cpu().numpy()
            res["ring"][sp] = dict(ms=statistics.median(lat), out512=out512 if rank == 0 else None,
                                   totals=totals)
            if rank == 0:
                phase(f"26e. ring attention B{RING_SHAPE[0]} H{RING_SHAPE[1]} S{RING_SHAPE[2]} "
                      f"D{RING_SHAPE[3]} over sp {sp}: == qnn.attention on the card "
                      f"(sha256), median {statistics.median(lat):.3f} ms (single-card op "
                      f"{spec['attn_ms']:.3f} ms), send_recv {stats['send_recv']['calls'] / 3:.0f} "
                      f"a run, {stats['send_recv']['bytes'] / 3 / 1e6:.3f} MB sent, "
                      f"{stats['send_recv']['host_bytes'] / 3 / 1e6:.3f} MB host-staged "
                      f"[{spec['card']}]")
        dist.barrier()


def moe_rank(rank: int, spec: dict, res: dict) -> None:
    """26f: MoE at BERT-base's FFN widths over ep 2 and 4 == the reference;
    every qgemm_raw call == plain; ms per expert split."""
    import torch.distributed as dist

    from tachikoma_tpu_torch.parallel.mesh import simple_mesh
    from tachikoma_tpu_torch.parallel.moe import ExpertParallelDense

    case = np.load(spec["moe"])
    x, w, gate = case["x"], case["w"], case["gate"]
    for ep in EXPERT_SIZES:
        mesh = simple_mesh({"ep": ep}, backend="gloo", device="cuda:0")
        calls: list = []
        if mesh.member:
            moe = ExpertParallelDense(w, mesh)  # the rank's experts put on the card once
            moe(x, gate)
            with recording(calls):
                out = moe(x, gate)
            assert _sha(out) == spec["moe_sha"], f"MoE ep {ep} != moe_dense_int8_reference"
        totals = _check_rank_calls(rank, calls, MOE_KERNELS, f"MoE ep{ep}")
        res["held"] += len(calls)
        if mesh.member:
            reset(MOE_KERNELS)
            lat = []
            for _ in range(3):
                dist.barrier(group=mesh.collective("ep").group)
                t0 = time.perf_counter()
                moe(x, gate)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            for name, n in read_launches(MOE_KERNELS, f"MoE ep {ep}").items():
                res["launches"][name] = res["launches"].get(name, 0) + n
            res["moe"][ep] = dict(ms=statistics.median(lat), totals=totals)
            if rank == 0:
                T, K, N, E = MOE_SHAPE
                phase(f"26f. MoE T {T} K {K} N {N} E {E} (top1_gate) over ep {ep}: == "
                      f"moe_dense_int8_reference (sha256), median "
                      f"{statistics.median(lat):.3f} ms a call (the rank's experts on the card "
                      f"since construction: routing, K4 products, int32 all-reduce) "
                      f"[{spec['card']}]")
        dist.barrier()


def nccl_probe_rank(rank: int, world: int) -> str:
    """Two ranks on one card in an NCCL group: NCCL's answer to a SUM (run
    by nccl_probe, in a process of its own)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    group = dist.new_group([0, 1], backend="nccl")
    try:
        dist.all_reduce(torch.ones(4, device="cuda:0"), group=group)
        torch.cuda.synchronize()
        return "accepted"
    except Exception as e:  # the answer probed for is a refusal; it is returned, not hidden
        return f"{type(e).__name__}: {str(e).splitlines()[-1][:200]}"


def parallel_rank(rank: int, world: int, spec: dict) -> dict:
    """Phase 26 on one rank process (cuda:0, the default group over gloo):
    26a, 26b, 26c, 26e, 26f in order.  Returns the rank's launches, its
    held calls and its measurements."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"launches": {}, "held": 0, "totals": {}, "shard": {}, "ring": {}, "moe": {}}
    t = {}
    for name, fn in (("26a", shard_rank), ("26b", nccl_rank), ("26c", trace_rank),
                     ("26e", ring_rank), ("26f", moe_rank)):
        t0 = time.perf_counter()
        fn(rank, spec, res)
        t[name] = time.perf_counter() - t0
    res["seconds"] = t
    return res


def nccl_probe() -> None:
    """Two ranks on cuda:0 in one NCCL group; prints each rank's answer.
    chip_smoke.py runs it as `python -c "import chip_smoke;
    chip_smoke.nccl_probe()"` beside phase 26 and reads its output."""
    from tachikoma_tpu_torch.parallel.gather import launch

    with tempfile.TemporaryDirectory() as tdir:
        for rank, answer in enumerate(launch(2, nccl_probe_rank, init_method=f"file://{tdir}/s",
                                             timeout=90)):
            print(f"nccl probe rank {rank}: {answer}", flush=True)


def parallel_path(card: str, r50_state: dict, trace: dict) -> tuple[dict, dict]:
    """Phase 26: parallel/* over torch.distributed on the card.  The kernels
    are built (phase 2) before any rank starts; the ranks read phase 3's
    int8 ResNet-50 b8 (unfused) and phase 7's b1 graph as .tkmod files.
    26a-26c, 26e and 26f run in PARALLEL_WORLD rank processes on cuda:0 over
    gloo (parallel_rank), 26d (the pipeline) here, after them; the NCCL
    probe runs in a process of its own meanwhile.  Returns the launches
    summed over the ranks' counted runs and the largest |err| per kernel."""
    from tachikoma_tpu_torch.ir.graph import Graph, GraphBuilder
    from tachikoma_tpu_torch.ir.infer import infer_types
    from tachikoma_tpu_torch.ir.registry import get_op
    from tachikoma_tpu_torch.parallel.gather import launch
    from tachikoma_tpu_torch.parallel.moe import moe_dense_int8_reference, top1_gate
    from tachikoma_tpu_torch.parallel.pipeline import PipelineExecutor
    from tachikoma_tpu_torch.runtime.artifact import save_artifact
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.interpreter import run_graph

    t26 = time.perf_counter()
    env = dict(os.environ, NCCL_DEBUG="WARN")
    probe = subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.nccl_probe()"],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
    q = r50_state["quantized"]
    logits = next(n for n in q.nodes if n.op == "qnn.dequantize").inputs[0]
    names = [n for n in computational_nodes(q) if q[n].dtype in ("int8", "int32")]
    tdir = tempfile.mkdtemp(prefix="tk_chip_smoke_parallel_")
    try:
        phase(f"26. parallel/*: single-card baselines and the ranks' inputs (host) [{card}]")
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 26)
        reqs = np.stack([rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
                         for _ in range(1 + SHARD_REQUESTS)])
        single = TorchExecutor(q, capture=[logits, q.outputs[0]], device="cuda")
        outs, lat = [], []
        for x in reqs:
            t1 = time.perf_counter()
            o = single.run_device(x)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
            outs.append([v.cpu().numpy() for v in o])
        single_ms = statistics.median(lat[1:])
        digests = {n: _sha(v) for n, v in zip(names, TorchExecutor(
            q, capture=names, device="cuda").run_device(reqs[1]))}
        spec = dict(card=card, tdir=tdir, logits=logits, single_ms=single_ms, digests=digests,
                    r50=os.path.join(tdir, "r50.tkmod"), r50_b1=os.path.join(tdir, "r50_b1.tkmod"),
                    requests=os.path.join(tdir, "requests.npy"),
                    single_outs=os.path.join(tdir, "single.npz"),
                    b1_input=os.path.join(tdir, "b1.npy"), meta=trace["meta"],
                    trace_sha256=trace["sha256"], trace_bytes=trace["bytes"],
                    ring=os.path.join(tdir, "ring.npz"), moe=os.path.join(tdir, "moe.npz"))
        save_artifact(spec["r50"], q)
        save_artifact(spec["r50_b1"], trace["graph"])
        np.save(spec["requests"], reqs)
        np.save(spec["b1_input"], trace["input"])
        np.savez(spec["single_outs"], logits=np.stack([o[0] for o in outs]),
                 prob=np.stack([o[1] for o in outs]))
        # ring attention's inputs, the single-card op at S 4096, the oracle at S 512
        qkv = {n: rng.integers(-128, 128, RING_SHAPE).astype(np.int8) for n in "qkv"}
        np.savez(spec["ring"], **qkv)
        b = GraphBuilder("attention")
        vs = [b.var(n, RING_SHAPE[:2] + (RING_SMALL, RING_SHAPE[3]), "int8") for n in "qkv"]
        g512 = infer_types(b.build(b.call("qnn.attention", *vs, **RING_SCALES)))
        node = g512.nodes[-1]
        attn = get_op("qnn.attention").torch_impl
        dev = [torch.from_numpy(qkv[n]).cuda() for n in "qkv"]
        spec["attn_sha"] = _sha(attn(*dev, node=node))
        spec["attn_ms"] = eager_ms(lambda: attn(*dev, node=node))
        want512 = run_graph(g512, {n: qkv[n][..., :RING_SMALL, :] for n in "qkv"})[0]
        del dev
        # MoE's tokens, experts and routing
        T, K, N, E = MOE_SHAPE
        x = rng.integers(-128, 128, (T, K)).astype(np.int8)
        w = rng.integers(-128, 128, (E, K, N)).astype(np.int8)
        gate = top1_gate(x, rng.integers(-128, 128, (K, E)).astype(np.int8))
        np.savez(spec["moe"], x=x, w=w, gate=gate)
        spec["moe_sha"] = _sha(moe_dense_int8_reference(x, w, gate))
        say(f"single card, unfused ResNet-50 b{BATCH}: median {single_ms:.3f} ms of "
            f"{SHARD_REQUESTS} requests; {len(digests)} integer nodes hashed; qnn.attention at "
            f"S {RING_SHAPE[2]} {spec['attn_ms']:.3f} ms; experts' tokens "
            f"{np.bincount(gate, minlength=E).tolist()}; {time.perf_counter() - t0:.2f} s")
        del single
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks = launch(PARALLEL_WORLD, parallel_rank, (spec,),
                       init_method=f"file://{os.path.join(tdir, 'store')}", timeout=600)
        say(f"\n{PARALLEL_WORLD} rank processes: {time.perf_counter() - t0:.2f} s from spawn to "
            "the last result; per part on rank 0: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in ranks[0]["seconds"].items()))
        for sp in RING_SIZES:
            np.testing.assert_array_equal(ranks[0]["ring"][sp]["out512"], want512)
        say(f"ring attention at S {RING_SMALL} over sp {RING_SIZES} == the numpy oracle")
        launches = Counter()
        for r in ranks:
            launches.update(r["launches"])
        say(f"kernel calls held == plain on the {PARALLEL_WORLD} ranks: "
            f"{sum(r['held'] for r in ranks)}; launches in the counted runs, summed over the "
            "ranks: " + ", ".join(f"{k} {v}" for k, v in sorted(launches.items())))

        phase(f"26d. pipeline: ResNet-50 b{BATCH} unfused in {PIPE_STAGES} stages on cuda:0, "
              f"{PIPE_MICRO} microbatches of {BATCH // PIPE_MICRO}, a stream per stage [{card}]")
        # the graph with its int8 logits as a second output, held as 26a holds them
        q2 = Graph(list(q.nodes), [logits, q.outputs[0]], dict(q.params), q.name)
        pe = PipelineExecutor(q2, PIPE_STAGES, devices=["cuda:0"] * PIPE_STAGES)
        say("stages (outputs): " + "; ".join(",".join(st.outputs) for st in pe.stages))
        pe.run(reqs[0], num_microbatches=PIPE_MICRO)
        reset(TRACE_KERNELS)
        lat = []
        for i in range(1, 1 + SHARD_REQUESTS):
            t1 = time.perf_counter()
            got = pe.run(reqs[i], num_microbatches=PIPE_MICRO)
            lat.append((time.perf_counter() - t1) * 1e3)
            assert got[0].dtype == np.int8, got[0].dtype
            np.testing.assert_array_equal(got[0], outs[i][0])
            np.testing.assert_array_equal(got[1], outs[i][1])
        pipe_launches = read_launches(TRACE_KERNELS, "the pipeline")
        launches.update(pipe_launches)
        spans = pe.intervals()
        overlap = [(a[:2], b[:2]) for a in spans for b in spans
                   if a[0] < b[0] and a[1] != b[1] and a[2] < b[3] and b[2] < a[3]]
        say(f"{SHARD_REQUESTS} requests == the single card (int8 logits and float "
            f"probabilities, exact); median {statistics.median(lat):.3f} ms beside the "
            f"single card's {single_ms:.3f} ms; launches "
            + ", ".join(f"{k} {v}" for k, v in pipe_launches.items()))
        say("last request's stage spans (stage, microbatch, start ms, end ms; CUDA events): "
            + "; ".join(f"({s}, {m}, {a:.3f}, {e:.3f})" for s, m, a, e in spans))
        say(f"streams overlapped: {bool(overlap)} ({len(overlap)} pairs of spans of different "
            "stages and microbatches overlap in time)")
        del pe

        out, _ = probe.communicate(timeout=120)
        refusals = [ln for ln in out.splitlines() if "Duplicate GPU" in ln]
        say("\nNCCL probe, two ranks on cuda:0 in one NCCL group: "
            + (refusals[0].strip()[:240] if refusals else "no refusal seen"))
        assert refusals, f"NCCL did not refuse two ranks on one card:\n{out[-2000:]}"
    finally:
        if probe.poll() is None:
            probe.kill()
            probe.wait()
        for name in os.listdir(tdir):
            os.remove(os.path.join(tdir, name))
        os.rmdir(tdir)
    errs: dict = {}
    for part in [*ranks[0]["totals"].values(), *(r["totals"] for r in ranks[0]["ring"].values()),
                 *(r["totals"] for r in ranks[0]["moe"].values())]:
        for name, t in part.items():
            errs[name] = max(errs.get(name, 0), t["max_abs_err"])
    say(f"\nphase 26 seconds {time.perf_counter() - t26:.1f} (host clock) [{card}]")
    return dict(launches), errs


# ---------------------------------------------------------------------------
# phase 27: dilated and grouped convs on K2 and K4's conv mode
# ---------------------------------------------------------------------------

DEEPLAB_SIDE = 520          # torchvision's references/segmentation evaluation size
DEEPLAB_TRACE_SIDE = 176    # the trace's reduced input: 22^2 maps at output stride 8
DEEPLAB_CLASSES = 21
DEEPLAB_DILATED = 11        # layer3 5 x d2, layer4 d2 and 2 x d4, the ASPP at 12, 24, 36
RESNEXT_GROUPED = 16        # the grouped 3x3 of each bottleneck


@contextlib.contextmanager
def no_plain_conv(what: str, products: bool = False):
    """Spy on the plain versions' sums (ops/kernels/conv.py conv_acc_exact,
    under every plain K2-K4; matmul_int8.py exact_int_matmul, under K1's
    and K4's GEMM mode's; depthwise.py dw_acc_plain, under K5's; wide.py's
    wide_conv_plain, wide_dense_plain and qbmm_wide_plain, under the W8A16
    products') and on the library's conv (F.conv2d) while the block runs,
    and fail if any of them ran; `products`: on the library's products too
    (torch.matmul and torch.bmm: a path with no float product)."""
    from tachikoma_tpu_torch.ops.kernels import conv, depthwise, matmul_int8, wide

    counts: Counter = Counter()
    spied = ((conv, "conv_acc_exact"), (matmul_int8, "exact_int_matmul"),
             (depthwise, "dw_acc_plain"), (wide, "wide_conv_plain"),
             (wide, "wide_dense_plain"), (wide, "qbmm_wide_plain"),
             (torch.nn.functional, "conv2d"),
             *(((torch, "matmul"), (torch, "bmm")) if products else ()))
    saved = [getattr(mod, attr) for mod, attr in spied]

    def spy(fn, key):
        def call(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return call

    for (mod, attr), fn in zip(spied, saved):
        setattr(mod, attr, spy(fn, attr))
    try:
        yield counts
    finally:
        for (mod, attr), fn in zip(spied, saved):
            setattr(mod, attr, fn)
    assert not counts, f"{what} ran a plain or library conv: {dict(counts)}"
    say(f"{what}: no plain version and no library conv ran (conv_acc_exact, exact_int_matmul, "
        "dw_acc_plain, wide_conv_plain, wide_dense_plain, qbmm_wide_plain, F.conv2d"
        + (", torch.matmul, torch.bmm" if products else "") + " spied on)")


def geometry_rows(per_call: list, what: str, card: str) -> dict:
    """The dilated and grouped calls among a forward's call records, summed
    by kernel: calls, ms, the bound of their useful operations (a grouped
    call's products within its groups, not the block-diagonal ones the
    kernel computes), plain ms and the library call's ms; printed, with the
    ratios, as one line each and one JSON line."""
    rows: dict = {}
    for r in per_call:
        (dilation, groups) = r["geometry"]
        if dilation == (1, 1) and groups == 1:
            continue
        t = rows.setdefault(r["kernel"], dict(calls=0, ms=0.0, bound_ms=0.0, plain_ms=0.0,
                                              library_ms=0.0, ops=0, bytes=0))
        t["calls"] += 1
        for key in ("ms", "bound_ms", "plain_ms", "ops", "bytes"):
            t[key] += r[key]
        t["library_ms"] += r["library_ms"] or 0.0
    for name, t in rows.items():
        lib = t["library_ms"]
        say(f"{what}: {name} {t['calls']} dilated / grouped calls a forward: {t['ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['ms'] / t['bound_ms']:.1f}x the bound; "
            f"{t['ops']:.4g} useful operations), plain {t['plain_ms']:.3f} ms, library "
            f"{lib:.4f} ms" + (f" ({t['ms'] / lib:.2f}x)" if lib else "") + f" [{card}]")
    say("geometry rows " + json.dumps({"what": what, "card": card, **rows}))
    return rows


def segmentation(classes: int, side: int):
    def check(graph, names, card, cpu):
        y = card[names.index(graph.outputs[0])]
        assert y.shape == (1, classes, side, side) and np.isfinite(y).all(), y.shape
        agree = float((y.argmax(1) == cpu[names.index(graph.outputs[0])].argmax(1)).mean())
        return f"logits {y.shape} finite, per-pixel argmax == the CPU's at {agree:.6f} of pixels"
    return check


def unfused_forward(label: str, model: str, q, x, card: str) -> tuple[dict, dict, dict]:
    """An unfused forward on the card: every K1 / K4 call == plain and timed,
    the launches counted from 0, no plain conv on the path.  Returns the
    launches, each kernel's largest |err| and the dilated / grouped rows."""
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor

    phase(f"{label} {model} unfused: every K4 call == plain, timed [{card}]")
    ex = TorchExecutor(q, device="cuda", fuse=False)
    ex.run_device(x)  # the weights packed
    torch.cuda.synchronize()
    calls: list = []
    kernels = ("qgemm_raw", "qconv_raw")
    reset(kernels)
    with recording(calls), no_plain_conv(f"the unfused {model} forward"):
        ex.run_device(x)
        torch.cuda.synchronize()
    launches = read_launches(kernels, f"the unfused {model} forward")
    per_call: list = []
    totals = check_kernels(calls, kernels, model, per_call)
    rows = geometry_rows(per_call, f"{label} {model} unfused", card)
    return launches, {k: t["max_abs_err"] for k, t in totals.items()}, rows


def deeplab_path(card: str, r50_state: dict, keep: dict) -> tuple[dict, dict]:
    """Phases 27a-27c on DeepLabV3-ResNet-50.  Returns the launches and the
    largest |err| per kernel; `keep` receives the imported float graph
    ("deeplab", phase 29's)."""
    from tachikoma_tpu_torch.frontend import from_onnx
    from tachikoma_tpu_torch.models.onnx_deeplab import deeplab_qconfig, deeplabv3_onnx
    from tachikoma_tpu_torch.quantize.quantizer import quantize

    side = DEEPLAB_SIDE
    model = f"DeepLabV3-ResNet-50 b1 {side}^2"

    def build():
        t0 = time.perf_counter()
        blob = deeplabv3_onnx(1, side, DEEPLAB_CLASSES, seed=SEED)
        say(f"written by models/onnx_deeplab.py (seed {SEED}): {len(blob)} bytes in "
            f"{time.perf_counter() - t0:.2f} s")
        keep["deeplab"] = from_onnx(blob)
        return keep["deeplab"]

    zoo: dict = {}
    totals, launches, summary = zoo_path(
        "27a.", model, build,
        lambda rng: rng.standard_normal((1, 3, side, side)).astype(np.float32), card,
        check_output=segmentation(DEEPLAB_CLASSES, side), config=deeplab_qconfig(), keep=zoo,
        only_kernels=True)
    rows = geometry_rows(zoo["per_call"], f"27a. {model} fused", card)
    assert rows["qconv_rq"]["calls"] == DEEPLAB_DILATED, rows
    say(f"27a. {model}: median {summary['median_ms']:.3f} ms a request, device busy "
        f"{summary['busy_ms']} ms; ResNet-50 b{BATCH} {IMAGE}^2 (phase 5) "
        f"{r50_state['median_ms']:.3f} ms [{card}]")
    errs = {k: t["max_abs_err"] for k, t in totals.items()}
    raw_launches, raw_errs, raw_rows = unfused_forward("27b.", model, zoo["quantized"],
                                                       zoo["requests"][0], card)
    assert raw_rows["qconv_raw"]["calls"] == DEEPLAB_DILATED, raw_rows
    for part in (raw_launches,):
        for k, n in part.items():
            launches[k] = launches.get(k, 0) + n
    for k, e in raw_errs.items():
        errs[k] = max(errs.get(k, 0), e)

    t0 = time.perf_counter()
    tside = DEEPLAB_TRACE_SIDE
    rng = np.random.default_rng(SEED)
    g = from_onnx(deeplabv3_onnx(1, tside, DEEPLAB_CLASSES, seed=SEED))
    calib, x = (rng.standard_normal((1, 3, tside, tside)).astype(np.float32) for _ in range(2))
    q = quantize(g, [calib], deeplab_qconfig())
    say(f"\n27c. DeepLabV3-ResNet-50 written at b1 {tside}^2 (the trace's reduced input: "
        f"{-(-tside // 8)}^2 maps), import, calibrate, quantize {time.perf_counter() - t0:.2f} s "
        f"(host) [{card}]")
    per_call: list = []
    trace_totals, trace_launches = trace_path(
        ("27c.", "27c."), "DeepLabV3-ResNet-50", None, TRACE_KERNELS, prepared=(q, x),
        size=f"{tside}^2", per_call=per_call)
    geometry_rows(per_call, f"27c. DeepLabV3-ResNet-50 b1 {tside}^2 unfused", card)
    for k, n in trace_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, t in trace_totals.items():
        errs[k] = max(errs.get(k, 0), t["max_abs_err"])
    return launches, errs


def resnext_path(card: str, r50_state: dict, keep: dict) -> tuple[dict, dict]:
    """Phases 27d-27e on ResNeXt-50 32x4d.  Returns the launches and the
    largest |err| per kernel; `keep` receives the module ("resnext", phase
    29's)."""
    from tachikoma_tpu_torch.frontend.torch_fx import from_torch
    from tachikoma_tpu_torch.models.torch_resnet import resnext50_32x4d_torch
    from tachikoma_tpu_torch.quantize.quantizer import quantize

    model = f"ResNeXt-50 32x4d b{BATCH} {IMAGE}^2"
    t0 = time.perf_counter()
    module = keep["resnext"] = resnext50_32x4d_torch(seed=SEED)
    say(f"\n27d. models/torch_resnet.py resnext50_32x4d_torch (seed {SEED}) "
        f"{time.perf_counter() - t0:.2f} s (host)")

    def make_input(rng):
        return rng.standard_normal((BATCH, 3, IMAGE, IMAGE)).astype(np.float32)

    keep: dict = {}
    totals, launches, summary = zoo_path(
        "27d.", model, lambda: from_torch(module, {"x": (BATCH, 3, IMAGE, IMAGE)}), make_input,
        card, check_output=logits(1000), keep=keep, only_kernels=True)
    rows = geometry_rows(keep["per_call"], f"27d. {model} fused", card)
    assert rows["qconv_rq"]["calls"] == RESNEXT_GROUPED, rows
    say(f"27d. {model}: median {summary['median_ms']:.3f} ms a request, device busy "
        f"{summary['busy_ms']} ms; ResNet-50 b{BATCH} {IMAGE}^2 (phase 5) "
        f"{r50_state['median_ms']:.3f} ms [{card}]")
    errs = {k: t["max_abs_err"] for k, t in totals.items()}

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    shape = (TRACE_BATCH, 3, IMAGE, IMAGE)
    calib, x = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    q = quantize(from_torch(module, {"x": shape}), [calib])
    say(f"\n27e. ResNeXt-50 32x4d at b{TRACE_BATCH}: from_torch, calibrate, quantize "
        f"{time.perf_counter() - t0:.2f} s (host) [{card}]")
    per_call: list = []
    trace_totals, trace_launches = trace_path(
        ("27e.", "27e."), "ResNeXt-50 32x4d", None, TRACE_KERNELS, prepared=(q, x),
        per_call=per_call)
    raw_rows = geometry_rows(per_call, f"27e. ResNeXt-50 32x4d b{TRACE_BATCH} unfused", card)
    assert raw_rows["qconv_raw"]["calls"] == RESNEXT_GROUPED, raw_rows
    for k, n in trace_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, t in trace_totals.items():
        errs[k] = max(errs.get(k, 0), t["max_abs_err"])
    return launches, errs


def geometry_path(card: str, r50_state: dict, keep: dict) -> tuple[dict, dict]:
    """Phase 27: DeepLabV3-ResNet-50 (dilated) and ResNeXt-50 32x4d
    (grouped).  Returns the launches and the largest |err| per kernel;
    `keep` receives the float DeepLab graph and the ResNeXt module."""
    phase(f"27. dilated and grouped convs on K2 and K4's conv mode [{card}]")
    launches, errs = deeplab_path(card, r50_state, keep)
    more_launches, more_errs = resnext_path(card, r50_state, keep)
    for k, n in more_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, e in more_errs.items():
        errs[k] = max(errs.get(k, 0), e)
    return launches, errs


LEGACY_CLASSES = 1001
# DeepLab-MobileNetV2's atrous depthwise calls (slim's mobilenet_v2 conv defs
# at output stride 8, b1 513^2: 65^2 maps from the fourth stage on, which
# keeps stride 1 and runs its later blocks at rate 2, the sixth at 4): (C,
# dilation) a call, 3x3 s1, padding the dilation, in the network's order
ATROUS_MAP = 65
ATROUS_CALLS = ((384, 2),) * 4 + ((576, 2),) * 3 + ((960, 4),) * 3


def legacy_fused_path(card: str) -> tuple[dict, dict, dict]:
    """Phase 28a: the uint8 MobileNetV2 b8 224^2 written by
    models/tflite_mobilenet.py, imported and fused: every K1 / K2 / K5 call
    == plain and timed, REQUESTS requests under no_plain_conv with the
    launches counted, every integer node == the CPU path, the busy share.
    Returns the kernels' per-forward totals, the launches and the largest
    |err| of each kernel."""
    from tachikoma_tpu_torch.frontend import from_tflite
    from tachikoma_tpu_torch.models.tflite_mobilenet import (mobilenet_v2_input,
                                                            mobilenet_v2_tflite)
    from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    model = f"uint8 MobileNetV2 b{BATCH} {IMAGE}^2"
    phase(f"28a. {model} (legacy uint8 TFLite, models/tflite_mobilenet.py, seed {SEED}): "
          f"write, from_tflite, fuse (host) [{card}]")
    t0 = time.perf_counter()
    blob = mobilenet_v2_tflite(BATCH, IMAGE, SEED)
    t1 = time.perf_counter()
    g = from_tflite(blob)
    fused = fuse_qnn(g)
    say(f"written: {len(blob)} bytes in {t1 - t0:.2f} s; import + fuse "
        f"{time.perf_counter() - t1:.2f} s (host)")
    ops = Counter(n.op for n in fused.nodes if n.op not in ("var", "const"))
    say("fused graph: " + ", ".join(f"{v} {k}" for k, v in sorted(ops.items())))
    heads = [n for n in fused.nodes if n.op == "tk.conv2d_rq"]
    kzps = Counter(int(n.attrs["kernel_zero_point"]) for n in heads)
    assert len(heads) == 53 and 0 not in kzps, kzps
    assert all(n.attrs["out_dtype"] == "uint8" for n in heads)
    say(f"53 tk.conv2d_rq, each uint8 out at a weight zero point other than 0 "
        f"({len(kzps)} distinct, {min(kzps)} to {max(kzps)}); input zero points "
        f"{sorted(Counter(int(n.attrs['input_zero_point']) for n in heads))[:6]} ...")
    names = computational_nodes(fused)
    ex = TorchExecutor(g, capture=names, fuse=True, device="cuda")
    assert ex.graph.to_json() == fused.to_json()
    requests = [mobilenet_v2_input(BATCH, IMAGE, SEED + i) for i in range(REQUESTS)]

    phase(f"28a. {model}: K1, K2 and K5 at the forward's calls: == plain, time, bound, "
          f"library [{card}]")
    calls: list = []
    with recording(calls):
        ex.run_device(requests[0])
    torch.cuda.synchronize()
    counts = Counter(name for name, _, _ in calls)
    assert counts == {"qgemm_rq": 35, "qconv_rq": 1, "qdwconv_rq": 17}, counts
    totals = check_kernels(calls, TFLITE_KERNELS, model)
    errs = {k: t["max_abs_err"] for k, t in totals.items()}

    phase(f"28a. {model}: {REQUESTS} requests through TorchExecutor(fuse=True, "
          f"device='cuda') [{card}]")
    with no_plain_conv(f"the {model} requests"):
        lat, first_out, launches = timed_requests(ex, requests, TFLITE_KERNELS,
                                                  f"the {model} path")
    t0 = time.perf_counter()
    plain = TorchExecutor(g, capture=names, fuse=True, device="cpu").run(requests[0])
    say(f"CPU plain forward {time.perf_counter() - t0:.2f} s (host)")
    n_int = hold_against_plain(names, first_out, plain, fused, FLOAT_RTOL, FLOAT_ATOL)
    out = first_out[names.index(fused.outputs[0])]
    assert out.dtype == np.uint8 and out.shape == (BATCH, LEGACY_CLASSES), (out.dtype, out.shape)
    say(f"{n_int} of {len(names)} captured nodes are integer and == the CPU plain path; uint8 "
        f"probabilities {out.shape}: per image {int((out > 0).sum(-1).min())} to "
        f"{int((out > 0).sum(-1).max())} classes above 0, top-1 "
        f"{out.argmax(-1).tolist()}")
    med = say_latency(lat, BATCH)
    kernel_ms = sum(t["ms"] for t in totals.values())
    say(f"{'+'.join(TFLITE_KERNELS)} device ms per forward {kernel_ms:.4f} of {med:.3f} ms "
        "end to end")
    profile_requests(ex, requests[:3], med)
    say("legacy rows " + json.dumps({"what": f"28a. {model}", "card": card, **{
        k: {f: t[f] for f in ("calls", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms")}
        for k, t in totals.items()}, "median_ms": med}))
    return totals, launches, errs


def atrous_depthwise(card: str) -> tuple[dict, dict]:
    """Phase 28c: K5 with dilation, requantize and raw modes, int8 data and
    uint8 data with a weight zero point (a uint8 output), at DeepLab-
    MobileNetV2's ten atrous depthwise calls (ATROUS_CALLS): the calls run
    once with the counts from 0, then each is held == plain and timed
    beside its bound, the plain version and cuDNN's fp16 dilated depthwise
    conv.  Returns the launches and the largest |err| per kernel."""
    from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize

    phase(f"28c. K5 with dilation at DeepLab-MobileNetV2's {len(ATROUS_CALLS)} atrous "
          f"depthwise calls (b1 {ATROUS_MAP}^2 maps, output stride 8) [{card}]")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    calls = {"int8": [], "uint8": []}
    for dtype, cs in calls.items():
        for c, d in ATROUS_CALLS:
            shape = (1, ATROUS_MAP, ATROUS_MAP, c)
            if dtype == "uint8":  # a legacy model's: uint8 data, the weights' zero point
                x = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)).to(dev)
                kzp = channel_vector(rng.integers(-60, 60, c), c, dev)
                izp, out = dict(izp=120), dict(out_zp=0, qmin=0, qmax=255, out_dtype="uint8")
            else:
                x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).to(dev)
                kzp, izp, out = None, dict(izp=-128), dict(out_zp=-128, qmin=-128, qmax=127)
            w = torch.from_numpy(rng.integers(-128, 128, (3, 3, 1, c)).astype(np.int8)).to(dev)
            b = torch.from_numpy(rng.integers(-20000, 20000, c).astype(np.int32)).to(dev)
            m, s = plan_requantize(0.0008 * (0.5 + rng.random(c)), 1.0)
            kw = dict(strides=(1, 1), padding=(d,) * 4, dilation=(d, d), kzp=kzp, **izp)
            cs.append(("qdwconv_rq", (x, w, b, channel_vector(m, c, dev),
                                      channel_vector(s, c, dev)),
                       dict(kw, rq_izp=0, rounding="TONEAREST", **out)))
            cs.append(("qdwconv_raw", (x, w, b), kw))
    names = ("qdwconv_rq", "qdwconv_raw")
    impl = kernel_impls()
    reset(names)
    for cs in calls.values():
        for name, a, k in cs:
            impl[name][0](*a, **k)
    torch.cuda.synchronize()
    launches = read_launches(names, "28c's calls")
    say(", ".join(f"{k}: {n} launches" for k, n in launches.items()))
    errs: dict = {}
    rows: dict = {}
    for dtype, cs in calls.items():
        totals = check_kernels(cs, names, f"DeepLab-MobileNetV2 atrous {dtype}")
        for name, t in totals.items():
            errs[name] = max(errs.get(name, 0), t["max_abs_err"])
            rows[f"{name} {dtype}"] = {f: t[f] for f in ("calls", "ms", "bound_ms", "bound_by",
                                                          "plain_ms", "library_ms")}
    for key, t in rows.items():
        say(f"28c. {key}: {t['calls']} calls {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} "
            f"({t['ms'] / t['bound_ms']:.1f}x), plain {t['plain_ms']:.3f}, fp16 cuDNN "
            f"{t['library_ms']:.4f} ({t['ms'] / t['library_ms']:.2f}x) [{card}]")
    say("atrous rows " + json.dumps({"card": card, **rows}))
    return launches, errs


def legacy_path(card: str) -> tuple[dict, dict]:
    """Phase 28: legacy uint8 TFLite models on K1, K2, K4 and K5, and K5
    with dilation.  Returns the launches and the largest |err| per
    kernel."""
    from tachikoma_tpu_torch.frontend import from_tflite
    from tachikoma_tpu_torch.models.tflite_mobilenet import (mobilenet_v2_input,
                                                            mobilenet_v2_tflite)

    phase(f"28. legacy uint8 TFLite models: uint8 data, weight zero points, uint8 outputs; "
          f"K5 with dilation [{card}]")
    _, launches, errs = legacy_fused_path(card)
    prepared = (from_tflite(mobilenet_v2_tflite(TRACE_BATCH, IMAGE, SEED)),
                mobilenet_v2_input(TRACE_BATCH, IMAGE, SEED))
    trace_totals, trace_launches = trace_path(
        ("28b.", "28b."), "uint8 MobileNetV2", None, TFLITE_TRACE_KERNELS, prepared=prepared)
    atrous_launches, atrous_errs = atrous_depthwise(card)
    for part in (trace_launches, atrous_launches):
        for k, n in part.items():
            launches[k] = launches.get(k, 0) + n
    for k, t in trace_totals.items():
        errs[k] = max(errs.get(k, 0), t["max_abs_err"])
    for k, e in atrous_errs.items():
        errs[k] = max(errs.get(k, 0), e)
    return launches, errs


# ---------------------------------------------------------------------------
# phase 29: W8A16 beyond the plain CNN: int16 attention products on
# qbmm_wide, dilated and grouped int64 convs on qconv_wide / qdwconv_wide
# ---------------------------------------------------------------------------

W8A16_FAMILY_KERNELS = ("qbmm_wide", "qgemm_wide", "qconv_wide", "qdwconv_wide")
W8A16_ATTENTION_BMM = 24    # BERT-base's and ViT-B/16's qnn.batch_matmul: 12 scores, 12 contexts


def w8a16_logits(classes: int):
    """A W8A16 transformer's or CNN's float logits: shape and finite; their
    distance from the CPU path's and the argmax agreement printed (a float
    softmax or tanh of the card's rounds a later qnn.quantize the other way
    on a few elements: hold_zoo_nodes holds those nodes one by one)."""
    def check(graph, names, card, cpu):
        y, c = card[names.index(graph.outputs[0])], cpu[names.index(graph.outputs[0])]
        assert y.shape[-1] == classes and np.isfinite(y).all(), y.shape
        agree = int((y.argmax(-1) == c.argmax(-1)).sum())
        return (f"logits {y.shape} finite, max |card - CPU| {np.abs(y - c).max():.3g}, argmax "
                f"== the CPU's on {agree} of {y.shape[0]}")
    return check


def w8a16_model(label: str, model: str, build, make_input, card: str, check_output,
                config, expect: dict, end_to_end: bool = True,
                hold=None) -> tuple[dict, dict, dict]:
    """One W8A16 configuration through zoo_path (quantize, every W8A16
    product == plain and timed, REQUESTS requests with no plain version and
    no library product run, every node held to the CPU path; `end_to_end`
    and `hold` as zoo_path's); `expect`: the calls a forward of each kernel,
    and of its dilated / grouped calls ("dilated / grouped qconv_wide": n).
    Returns the per-forward totals, the launches and the dilated / grouped
    rows."""
    keep: dict = {}
    totals, launches, summary = zoo_path(
        label, model, build, make_input, card, check_output=check_output, config=config,
        keep=keep, only_kernels=True, kernels=W8A16_FAMILY_KERNELS, products=True,
        end_to_end=end_to_end, hold=hold)
    rows = geometry_rows(keep["per_call"], f"{label} {model}", card)
    got = {k: t["calls"] for k, t in totals.items()}
    got.update((f"dilated / grouped {k}", t["calls"]) for k, t in rows.items())
    for key, n in expect.items():
        assert got.get(key) == n, f"{model}: {key} {got.get(key)} calls a forward, expected {n}"
    say(f"{label} {model}: median {summary['median_ms']:.3f} ms a request, device busy "
        f"{summary['busy_ms']} ms [{card}]")
    return totals, launches, rows


def atrous_wide(card: str) -> tuple[dict, dict]:
    """Phase 29f: qdwconv_wide (K5's int16 mode) with dilation at DeepLab-
    MobileNetV2's ten atrous depthwise calls (ATROUS_CALLS), int16 data at
    the int16 extremes: the calls counted, each == plain and timed beside
    its bound, the plain version and cuDNN's float64 dilated depthwise
    conv.  Returns the launches and the totals."""
    phase(f"29f. qdwconv_wide with dilation at DeepLab-MobileNetV2's {len(ATROUS_CALLS)} atrous "
          f"depthwise calls at int16 (b1 {ATROUS_MAP}^2 maps) [{card}]")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    calls = []
    for c, d in ATROUS_CALLS:
        x = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, (1, ATROUS_MAP, ATROUS_MAP, c))
                             .astype(np.int16)).to(dev)
        w = torch.from_numpy(rng.integers(-128, 128, (3, 3, 1, c)).astype(np.int8)).to(dev)
        calls.append(("qdwconv_wide", (x, w), dict(strides=(1, 1), padding=(d,) * 4,
                                                   dilation=(d, d), izp=int(rng.integers(-300,
                                                                                         300)))))
    impl = kernel_impls()
    reset(("qdwconv_wide",))
    for name, a, k in calls:
        impl[name][0](*a, **k)
    torch.cuda.synchronize()
    launches = read_launches(("qdwconv_wide",), "29f's calls")
    assert launches["qdwconv_wide"] == len(ATROUS_CALLS), launches
    totals = check_kernels(calls, ("qdwconv_wide",), "DeepLab-MobileNetV2 atrous int16")
    t = totals["qdwconv_wide"]
    say(f"29f. qdwconv_wide dilated: {t['calls']} calls {t['ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ({t['ms'] / t['bound_ms']:.1f}x), plain {t['plain_ms']:.3f}, "
        f"float64 cuDNN {t['library_ms']:.4f} ({t['ms'] / t['library_ms']:.2f}x) [{card}]")
    return launches, totals


def w8a16_families(card: str, keep: dict) -> tuple[dict, dict, dict]:
    """Phase 29: W8A16 (int16 activations, int64 accumulators, unfused) on
    the families the int8 path runs: BERT-base b4 s128 and ViT-B/16 b1 224^2
    (their attention products on qbmm_wide), BERT-base's b1 s128 trace,
    DeepLabV3-ResNet-50 b1 520^2 (11 dilated convs on qconv_wide; its nodes
    held at 176^2) and
    ResNeXt-50 32x4d b1 224^2 (16 grouped ones), and qdwconv_wide dilated.
    `keep` holds phase 27's float DeepLab graph and ResNeXt module.
    Returns qbmm_wide's per-forward totals (BERT-base b4), the launches and
    the largest |err| of each kernel."""
    from tachikoma_tpu_torch.frontend import from_onnx
    from tachikoma_tpu_torch.frontend.torch_fx import from_torch
    from tachikoma_tpu_torch.models.onnx_deeplab import FLOAT_OPS, deeplabv3_onnx
    from tachikoma_tpu_torch.models.transformer import bert_base, vit_b16
    from tachikoma_tpu_torch.quantize.config import W8A16
    from tachikoma_tpu_torch.quantize.quantizer import quantize

    phase(f"29. W8A16 families: int16 x int16 batched products into int64 (qbmm_wide), "
          f"dilated and grouped int64 convs (qconv_wide, qdwconv_wide) [{card}]")
    launches: dict = {}
    errs: dict = {}

    def merge(path_totals, path_launches):
        for name, t in path_totals.items():
            errs[name] = max(errs.get(name, 0), t["max_abs_err"])
        for name, n in path_launches.items():
            launches[name] = launches.get(name, 0) + n

    bert_totals, bert_launches, _ = w8a16_model(
        "29a.", f"W8A16 BERT-base b{BERT_BATCH} s{SEQ}",
        lambda: bert_base(batch_size=BERT_BATCH, seq_len=SEQ, seed=SEED), bert_ids(BERT_BATCH),
        card, w8a16_logits(2), W8A16, {"qbmm_wide": W8A16_ATTENTION_BMM}, end_to_end=False)
    merge(bert_totals, bert_launches)
    merge(*trace_path(("29b.", "29b."), "W8A16 BERT-base",
                      lambda b: bert_base(batch_size=b, seq_len=SEQ, seed=SEED),
                      ("qbmm_wide", "qgemm_wide"), make_input=bert_ids(TRACE_BATCH), config=W8A16,
                      size=f"s{SEQ}", node_level=True))
    merge(*w8a16_model(
        "29c.", f"W8A16 ViT-B/16 b1 {IMAGE}^2", lambda: vit_b16(batch_size=1, image_size=IMAGE,
                                                                  seed=SEED),
        lambda rng: rng.standard_normal((1, IMAGE, IMAGE, 3)).astype(np.float32), card,
        w8a16_logits(1000), W8A16, {"qbmm_wide": W8A16_ATTENTION_BMM, "qconv_wide": 1},
        end_to_end=False)[:2])
    # DeepLab: the requests at 520^2, every node held at phase 27c's 176^2
    # (the CPU path's forward at 520^2 would take 17 s of host time)
    config = dataclasses.replace(W8A16, float_ops=FLOAT_OPS)
    tside, rng = DEEPLAB_TRACE_SIDE, np.random.default_rng(SEED)
    calib, x = (rng.standard_normal((1, 3, tside, tside)).astype(np.float32) for _ in range(2))
    small = quantize(from_onnx(deeplabv3_onnx(1, tside, DEEPLAB_CLASSES, seed=SEED)), [calib],
                     config)
    merge(*w8a16_model(
        "29d.", f"W8A16 DeepLabV3-ResNet-50 b1 {DEEPLAB_SIDE}^2", lambda: keep["deeplab"],
        lambda rng: rng.standard_normal((1, 3, DEEPLAB_SIDE, DEEPLAB_SIDE)).astype(np.float32),
        card, segmentation(DEEPLAB_CLASSES, tside), config,
        {"dilated / grouped qconv_wide": DEEPLAB_DILATED}, hold=(small, x))[:2])
    shape = (1, 3, IMAGE, IMAGE)
    merge(*w8a16_model(
        "29e.", f"W8A16 ResNeXt-50 32x4d b1 {IMAGE}^2",
        lambda: from_torch(keep["resnext"], {"x": shape}),
        lambda rng: rng.standard_normal(shape).astype(np.float32), card, w8a16_logits(1000),
        W8A16, {"dilated / grouped qconv_wide": RESNEXT_GROUPED})[:2])
    atrous_launches, atrous_totals = atrous_wide(card)
    merge(atrous_totals, atrous_launches)
    return bert_totals["qbmm_wide"], launches, errs


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
    r50_trace: dict = {}
    trace_totals, trace_launches = trace_path(("7.", "8."), "ResNet-50", r50, TRACE_KERNELS,
                                              keep=r50_trace)
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
    bert_totals, bert_launches, bert_state = int8_bert_path()
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
    for name in W8A16_16X8_KERNELS:
        totals[name] = wide_totals[name]
        launches[name] = 0
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
    t23 = time.perf_counter()
    _, exec_launches, exec_errs = executors_path(card, r50_state, bert_state)
    for name, e in exec_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    merge({}, exec_launches)
    say(f"\nphase 23 seconds {time.perf_counter() - t23:.1f} (host clock) [{card}]")
    t24 = time.perf_counter()
    runtime_launches, runtime_errs = runtime_path(card, r50_state)
    for name, e in runtime_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    merge({}, runtime_launches)
    say(f"\nphase 24 seconds {time.perf_counter() - t24:.1f} (host clock) [{card}]")
    t25 = time.perf_counter()
    tf_launches, tf_errs = tf_path(card)
    for name, e in tf_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    merge({}, tf_launches)
    say(f"\nphase 25 seconds {time.perf_counter() - t25:.1f} (host clock) [{card}]")
    parallel_launches, parallel_errs = parallel_path(card, r50_state, r50_trace)
    for name, e in parallel_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    merge({}, parallel_launches)
    t27 = time.perf_counter()
    geometry_keep: dict = {}
    geometry_launches, geometry_errs = geometry_path(card, r50_state, geometry_keep)
    for name, e in geometry_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    merge({}, geometry_launches)
    say(f"\nphase 27 seconds {time.perf_counter() - t27:.1f} (host clock) [{card}]")
    t28 = time.perf_counter()
    legacy_launches, legacy_errs = legacy_path(card)
    for name, e in legacy_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    merge({}, legacy_launches)
    say(f"\nphase 28 seconds {time.perf_counter() - t28:.1f} (host clock) [{card}]")
    t29 = time.perf_counter()
    totals["qbmm_wide"], family_launches, family_errs = w8a16_families(card, geometry_keep)
    for name, e in family_errs.items():
        errs[name] = max(errs.get(name, 0), e)
    merge({}, family_launches)
    say(f"\nphase 29 seconds {time.perf_counter() - t29:.1f} (host clock) [{card}]")
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

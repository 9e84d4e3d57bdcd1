#!/usr/bin/env python3
"""Drive the PyTorch port's int8 ViT-Base, weight-only GPT-2 decode, int8
GPT-2 full-context scoring, int8 TinyLlama-1.1B scoring, int8 T5-small
encoder-decoder scoring, W8A16 ViT-Base, 1-16-bit MLP, TinyLlama-1.1B
decode and prefill paths, the serving paths (map_batches/serve_stream
over ViT-Base, the continuous-batching engine, prefill admission and the
full-sequence generators over TinyLlama-1.1B), ONNX interop (the
conformance vectors; QDQ/QOperator export and save/load of ViT-Base) and
the PTQ accuracy passes (GPTQ, AdaRound, bias correction, SmoothQuant,
AWQ, rotation, equalization, clipped calibration, mixed precision,
dynamic quantization), the CNN/GNN zoo (ResNet-18 and MobileNet-V1
widths, Cora-size GCNs, a CNN, a U-Net and an LSTM classifier),
encoder-decoder generation, quantization-aware training and the rest of
the model zoo (Mamba-130m, Mixtral-8x7B widths, CLIP ViT-B/32,
BERT-base) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits non-zero):
  0. the card, the software, and the kernels' build (one nvcc per source,
     all started together);
  1. intops.int_matmul against a float64 product over a sweep of small
     shapes (cuBLASLt's refused ones padded); the monolithic attention
     kernel's shared-memory carve-up against its host mirror; every
     hand-written kernel against its plain PyTorch version on the
     card, in every variant the paths use, then both timed at ViT-Base
     serving shapes beside the kernel's bound (and, for the packed
     matmuls, beside torch._int_mm plus the eager epilogue, each x
     loader form's launches, and 0 mismatches at the three ViT-Base shapes
     at batch 96 as well as on the ragged shapes); the exact
     attention forms must show no flipped (row, head) block wherever they
     sum softmax rows in torch's order, which torch's own CUDA sum must
     still take at that shape (probed once per shape);
  2. the main path in f32: random ViT-Base weights (seed 0) -> ONNX ->
     Model.from_onnx -> calibration on 2 images -> quantize(int8,
     quantize_conv) -> unfused forward -> optimize() -> pack_weights()
     -> fused forward under packed_execution="unpack", which must launch
     the attention kernel once per layer, equal its plain version on every
     layer's operands (no flipped block) and agree with the unfused
     forward (logits within LOGIT_TOL, labels wherever the top-1 margin is
     clear of it);
  3. the bf16 serving mode at batch 96 (the bench.py configuration):
     finite outputs, kernel launches per forward, labels against f32,
     images/s;
  4. the packed paths in f32 at batch 8 -- int8, W4A8 per-channel and
     W3A8, each after optimize() + pack_weights() (72 weights): the
     "kernel" forward launches its packed kernel 72 times and equals the
     "unpack" forward bit for bit;
  5. int8, W4A8 and W3A8 in bf16 serving at batch 96 under "kernel" and
     "unpack" (taken in turns: kernel, unpack, unpack, kernel; medians):
     images/s, launches per forward, the "kernel" logits equal to the
     "unpack" ones bit for bit, labels against f32; one profiled W4A8 and
     W3A8 "kernel" forward with the packed kernels' device time and share;
  6. the weight-only kernel splitk_wo_matmul against its plain version at
     1/2/4/8 bits, per-tensor, per-channel and grouped scales (groups
     within and across the split-K fields), f32 and bf16, on ragged
     shapes; then timed with a cold L2 at the five GPT-2 decode shapes
     (M = 8, W4 g=128), each with its launch plan (the cluster along K),
     beside its bound, the plain version and torch.matmul on the weight
     dequantized beforehand, in f32 and bf16;
  7. the weight-only decode path at full width: random GPT-2 small
     weights (seed 0) -> gpt_decode_step(B=8, max_len=64) ->
     Model.from_onnx -> quantize_weights(4, group_size=128) (49 weights)
     -> greedy generate (prompt 16, 48 new tokens) under "kernel" and
     "unpack", f32 and bf16: 49 kernel launches per step, f32 "kernel"
     tokens equal to "unpack" tokens (a row may part only where the top-2
     margin is within the measured logit difference), tokens/s (median of
     5 timed decodes per mode, the modes taken in turns);
  8. the blockwise attention kernel fused_attention_hs_blockq against its
     plain version in every variant (exact, fast, fast with the static
     shift x causal none, full and window 256 x out_requant off and on x
     zero points zero and nonzero) at (B, N, H) = (2, 1024, 12),
     (1, 1000, 4) and (1, 4096, 2), head dims 16, 32 and 128, narrow q at
     N=4096, tile skipping off and the static shift's full walk, the exact
     form at N = 8, 50, 100, 127, 130, 1000 and 1023 (no flipped block
     where torch sums a row in one warp); the monolithic kernel's exact form
     at those N, its head dims 16, 32 and 128 in every form, every form at
     D=128 with N=768 and 896 (K and V staged in turns), its causal and
     window forms at N=197 and 256; blockwise against monolithic at
     N=1000 (at most 1% of (row, head) blocks may differ, each by one
     probability step); then timed at the GPT-2 shape (B=8, N=1024, H=12,
     causal, int8 out) beside its bound and its plain version;
  9. the int8 GPT-2 scoring path at full width and depth: random GPT-2
     small weights (seed 0) -> gpt_causal_lm(B=8, seq 1024) ->
     Model.from_onnx -> calibration on 2 sequences -> quantize(int8) ->
     unfused forward -> optimize() (12 causal FusedAttentionHS) -> fused
     f32 forward, which must launch the blockwise kernel 12 times and the
     monolithic one never, equal its plain version on every layer's
     operands (no flipped block) and equal the unfused forward bit for bit;
     the bf16 mode; tokens scored per second (median of 5 forwards per
     mode, in turns); one profiled bf16 forward; peak device memory;
 10. the pre-split attention kernel fused_attention against its plain
     version in 525 variants (zero points all nonzero, all zero and each
     alone zero; out_requant off, on, on without res_zp; mask none, causal,
     window 6 and 512; N = 8, 50, 100, 127, 130, 197, 1000, 1023, 1024,
     2048; head dims 16-128; odd BH; a mask too small to skip tiles), with
     0 flipped blocks required wherever torch sums a row in one warp, which
     torch's own CUDA sum must still do in the kernel's order; then at the
     TinyLlama scoring shape (B=4 x 32 heads, N=2048, D=64, causal, int8
     out): against its plain version (0 flips), and timed beside its bound
     and its plain version;
 11. the int8 TinyLlama-1.1B scoring path at full width and LLAMA_LAYERS
     (3) of its 22 layers, as in phases 15, 16 and 19(c): random
     weights (seed 0) -> llama_causal_lm(B=4, seq 2048) -> Model.from_onnx
     -> calibration on 2 sequences -> quantize(int8) -> unfused B=1 forward
     in f32 and bf16 -> optimize() (one FusedAttention plain fusion per
     layer, 0 FusedAttentionHS, no failures) -> fused B=1 forward (one
     launch per layer, whether the kernel skips masked key tiles at
     these qparams, logits within LOGIT_TOL of the unfused ones, argmax
     equal where the margin clears it) -> fused B=1 bf16 forward (a
     launch per layer, the kernel equal to its plain version on its
     operands; its distance from f32 beside the unfused bf16 walk's) ->
     fused B=4 forward (a launch per layer; row
     0 against the B=1 forward) -> bf16; tokens/s
     (median of 5 forwards per mode, in turns); one profiled bf16 forward;
     peak device memory of the unfused B=1 and fused B=4 forwards;
 12. the score-bias forms of both head-split kernels against their plain
     versions (monolithic and blockwise x exact, fast, static shift x the
     per-head, head-shared and decoder bias + causal forms x out_requant x
     zero points, H=8 at N = 128, 256, 512, 1024 with D=64 and at N=256
     with D=16, 32 and 128): no flipped block on the exact forms, the
     one-step rule on the fast ones; the bias clause of the dispatch (N=256
     monolithic, 257 blockwise) and narrow q refused; then timed at
     t5-small's three attention shapes beside bound and plain version;
     phases 1, 8 and 12 must have launched every template instantiation
     of both head-split kernels (head dim x bias in or out x softmax
     form);
 13. the int8 T5-small scoring path at full width and depth: random
     weights (seed 0) -> t5_conditional_generation(B=8, source 512, target
     128) -> Model.from_onnx -> calibration on 2 sequence pairs ->
     quantize(int8) -> unfused forward -> optimize() (18 FusedAttentionHS,
     12 with the score bias as 4th input, no plain fusion, no failure) ->
     fused f32 forward (6 blockwise and 12 monolithic launches, no flipped
     block, equal to the unfused forward bit for bit) -> bf16 (launches,
     logits against f32); target tokens/s (median of 5 forwards per mode,
     in turns); one profiled bf16 forward; peak device memory.
 14. the quantize boundaries and the 9-16-bit path: (a) the elementwise
     kernels quantize, dequantize and fake_quantize (csrc/elementwise.cu)
     against their plain chains bit for bit at widths 1-64 in every form
     (f32/bf16 in; int8/int32/int64 out; zero point none, scalar or a
     tensor; scale scalar or per channel; a zero scale; ties, infinities,
     NaN and values past the clip; contiguous, misaligned, transposed,
     strided and dense-rows data read in place), then every form of the
     launch plan (scalar, inner, outer, full, general) at 3-D and 4-D
     layouts; (b) each path form timed at ViT-Base's largest boundary,
     the GPT-2 and TinyLlama scoring shapes and W8A16's fc1 beside its
     bytes bound and its chain (quantize with a scalar and a per-channel
     scale; dequantize with a scalar, [1, N] and [M, 1] zero point),
     torch's quantized-tensor calls (another function), the host time per
     call, and the decode shapes: the int8 cache writes, p_past
     [8, 32, 1, 2048] read in place, the cache fake-quant
     [8, 32, 2048, 64] in one fake_quantize launch beside the two-launch
     chain; (c) the ViT-Base int8 f32 forward equal with the
     kernels and with the chains swapped in, the kernels' launches per
     forward on the ViT, GPT-2, TinyLlama and T5 paths, aten calls and
     wall time per forward of ViT-Base and T5-small with either; (d) the
     reference's bit-width sweep, mlp.onnx at 1-16 bits on the two-circles
     data: the card's integers equal the CPU port's, accuracy > 0.9 from 6
     bits; (e) ViT-Base W8A16 (16-bit activations, 8-bit weights) in f32
     at B=8 after optimize(): no fused attention (JAX's reason), closer to
     the float logits than int8, images/s, idle share, peak memory.
 15. TinyLlama-1.1B decode and prefill at full width, LLAMA_LAYERS deep
     (the weights of phase 11, shared): (f) first the kernels at the path's new
     shapes against their plain versions and timed -- splitk_wo_matmul at
     M = 8, W4 g=128 for 2048 -> 2048, 256, 5632, 32000 and 5632 -> 2048
     (f32, bf16, cold L2, its launch plan, beside torch.matmul on the
     dequantized weight) (quantize/dequantize/fake_quantize at the decode
     shapes: phase 14(b)), fused_attention at BH = 32, N = 512 causal (no
     flipped block);
     (a) llama_decode_step(B=8, cache 2048) -> Model.from_onnx ->
     decode_calibration over a 32-id prompt -> merged stats ->
     quantize(int8) twice, one optimize()d (22 DecodeAttention, no
     failure); (e) the float prefill (P=32) against the calibration caches;
     then quantize_weights(4, group_size=128) of the float step (155
     weights); (b, c) greedy decodes of 32 + 32 tokens in f32 and bf16:
     int8 unfused (cut to 32 + 8), int8 fused with a float and with the
     int8 cache, W4 under "kernel" and "unpack", each the median of 3 taken
     in turns: tokens/s, ms/step, aten calls and device busy time per step
     (one profiled 2-step decode), idle share, quantize, dequantize,
     fake_quantize (DecodeAttention's fake quantizations, one launch each)
     and splitk_wo_matmul launches per step (155 under "kernel", 0 under
     "unpack"); KV-cache bytes (int8 one quarter of f32); int8-cache tokens
     equal to float-cache tokens; fused vs unfused and "kernel" vs
     "unpack" in f32 under phase 7's margin rule; (d) seeded sampling
     reproducible, top_k=1 equal to greedy, ids in the vocabulary; (e) the
     int8 prefill at P=512, B=1: 22 plain fusions, 22 fused_attention
     launches, fused f32 equal to unfused bit for bit, tokens/s.
 16. serving at full width: (a) run before phase 15, on phase 3's
     optimized, packed int8 ViT-Base in bf16 at B=96: map_batches and
     serve_stream(depth=2) over 4 seeded batches under "unpack" and
     "kernel", each output equal to its batch's __call__ bit for bit,
     images/s of both and of a plain __call__ loop, launches per forward;
     (b) the continuous-batching engine on phase 15's int8 fused step (B=8
     slots, cache 2048) over 24 requests from seed 16 (prompts of 12, 24
     and 40 ids, 8 each, budgets 8-40, submitted interleaved): E1 dense
     with the int8 cache, E2 paged (16-row blocks, 21 allocatable: at
     least one preemption), E3 steps_per_sync=4, each request's tokens
     equal to generate_kv's over its group on the same step model; the
     step counts equal the schedule computed without the engine;
     tokens/s, host syncs per step call, the source line of each host
     sync of three steady steps and one profiled step's idle share; E4 every 4th request sampled at temperature 0.8: the greedy
     requests equal E1's, and on group 1 (admitted together) two seeded
     runs and the steps_per_sync=4 run give equal tokens; E5 the W4 g=128
     float step under "kernel" over group 1, equal to its generate_kv,
     155 splitk_wo_matmul launches per step; (c) prefill admission with
     phase 15's int8 llama_prefill (P=512) of 8 prompts of 64-480 ids
     (seed 17): 22 fused_attention launches per admission, each first
     token the argmax of the prefill logits at row plen-1, the slot's int8
     cache rows [0, plen) equal to the plain quantize of the presents (and
     the quantize kernel at that shape held to it in 15(f)), agreement
     with a teacher-forced engine reported; (d) generate (B=2, 16 + 32
     greedy), beam_search (4 beams, 16 new) and generate_speculative (a
     2-layer draft from TinyLlama's first layers, k=4) on an int8,
     optimize()d llama_causal_lm at L=64: generate equal to the argmax of
     one forward of its final ids, beam scores sorted and equal to their
     tokens' summed log-softmax within BEAM_TOL, speculative equal to
     generate, and with the target as its own draft equal to it in
     ceil(32 / 5) = 7 target forwards.
 17. ONNX interop, run right after 16(a) on phase 3's models: (a) the 13
     conformance vectors (conformance/: QDQ, QOperator, dynamic
     quantization, LSTM/GRU and float graphs) imported and run on the card
     in f32 with TF32 off, each output within its vector's atol; (b) the
     int8 ViT-Base (quantize(8, quantize_conv=True)), and phase 3's
     optimize()d, pack_weights()ed one under "kernel", exported with
     export_qdq and export_qoperator, re-imported with Model.from_onnx and
     run at f32 B=8 against the source forward by the JAX package's rules
     (mean |dlogit| < 0.02 QDQ, < 0.05 QOperator, equal labels; every
     quantized MatMul of the int8 model but each layer's probs @ v a
     QLinearMatMul); (c) save_qmodel -> load_qmodel of the int8 model
     and of W4A8 per-channel packed under "kernel": the loaded forward equal
     to the saved one bit for bit at f32 B=8 and bf16 B=96; (d) images/s
     at bf16 B=96 of the re-imported QDQ and QOperator models and the
     native optimized model under both packed executions (two runs each,
     in turns), with device busy ms and aten calls of one profiled forward.
 18. captured forwards (Model.__call__ replays one CUDA graph per input
     signature; config.eager_forward walks the graph node by node), run
     inside the phases that hold the models: (a) ViT-Base int8 f32 B=8 and
     bf16 B=96 under "unpack" and "kernel", (b) W4A8 and W3A8 bf16 B=96
     under "kernel" (after phase 5), (c) T5-small f32 and bf16 (phase 13),
     (d) the TinyLlama int8 prefill P=512 (15e), (e) the TinyLlama decode
     step through generate_kv, int8 fused with the int8 cache and W4
     "kernel" (15), (f) the dense engine E1 (16b), (g) the GPT-2 W4 decode
     step (7). Each: the captured outputs equal the eager ones bit for bit
     (tokens and engine outputs equal), launches equal eager's (the first
     call's too: a capture's warm-up walk and the capture count nothing,
     a replay what it launches), every hand kernel in a torch.profiler
     trace of one replay as often as eager launches it, 0 host syncs
     inside a steady replay (decode: inside any step call of a steady
     run), decodes read the dense KV caches in place (bytes copied per
     step below the bytes read in place, no recapture), the capture's
     seconds and memory pool, eager and captured throughput in turns,
     busy ms, the idle share and host µs per call.
 19. the PTQ accuracy passes (run after 16(d), on the TinyLlama weights
     of phase 11): splitk_wo_matmul against its plain version and timed
     at ViT-Base's three layer shapes with M = 8 * 197 and 96 * 197 (W4
     g=128, f32 and bf16, cold L2, beside its bound and torch.matmul on
     the dequantized weight); (a) the trained ViT-Base-width fixture (2
     layers; 32 calibration images, 256 held out): float, int8 min/max,
     percentile 99.99, MSE and KL, SmoothQuant + int8, W4A8 per channel
     plain / GPTQ / AdaRound / GPTQ + bias correction, W3A8 per tensor
     plain / rotate_vo, the sensitivity plan (half the parameters at 4
     bits), W4 g=128 weight-only plain / AWQ, dynamic int8 per row: each
     row's held-out accuracy, labels equal to float, max |dlogit| and pass
     seconds; every exact rewrite within REPARAM_TOL of the float logits;
     after optimize() + pack_weights() the f32 "kernel" logits equal to
     "unpack" bit for bit (weight-only rows: the margin rule), a captured
     bf16 B=96 "kernel" forward's images/s and launches, equal to
     "unpack"; (b) the main path: 12-layer ViT-Base (seed 0) W4A8 per
     channel, GPTQ on all 73 2-D weights timed on the card, then the
     packed captured bf16 B=96 "kernel" forward, counted (72
     splitk_qmatmul, 12 fused_attention_hs, quantize and dequantize
     launched), images/s beside plain W4A8's in turns, mean |dlogit|
     against float for both (reported); (c) the TinyLlama-1.1B int8
     prefill (P=512) after smooth_outliers(0.5): the float logits within
     REPARAM_TOL, a fused_attention launch per layer, fused f32 equal to
     unfused
     bit for bit; (d) the rows of the modular-sum accuracy ladder
     (accuracy_ladder.py) at B=256 that the JAX package's capstone rules
     read (MODSUM_ROWS), held to those rules (MODSUM_RULES); (e) T5-small (B=2, 512 + 128) after equalize() on its
     12 ReLU feed-forward pairs: the float logits within REPARAM_TOL, then
     int8 optimize()d scoring with 6 blockwise and 12 monolithic head-split
     launches.
 20. the CNN and GNN zoo (after 19), B=32, random weights (seed 0):
     resnet_classifier at ResNet-18's widths (224 px, 1000 classes):
     fold_batchnorm() within FOLD_TOL of the unfolded logits; then with
     mobilenet_classifier at MobileNet-V1's widths, gcn_dense and
     gcn_scatter at Cora's sizes (pack_weights(), both packed_execution
     settings), cnn_classifier, unet_segmenter and lstm_classifier: the
     float forward within ZOO_FLOAT_TOL of the model's torch oracle on
     the card, quantize(8) -> optimize(), every quantize/dequantize and
     packed-matmul launch of one eager forward against its plain version
     (0 mismatches), each depthwise int8 Conv's accumulator against an
     int64 version, the captured f32 forward against eager (phase 18's
     checks), "kernel" == "unpack" bit for bit on the GCNs, the launches
     of one counted replay (quantize, dequantize and, under "kernel",
     splitk_qmatmul non-zero), int8 labels against float, the captured
     bf16 forward's images/s (nodes/s) with one profiled replay's busy ms
     and top kernels, peak device memory and seconds.
 21. encoder-decoder generation at full width (after 20), B=8, random
     weights (seed 0): (a) T5-small's KV-cache decode step (cache 128,
     source 512, the score-bias and memory forms of generate_kv; prompt 4 +
     28 new): float, int8 (decode_calibration stats, optimize(): 6
     DecodeAttention and 6 cross FusedAttentionHS at q = 1 against 512
     keys), int8 with the int8 cache (tokens equal to the float carry's),
     W4 g=128 under "kernel" (splitk_wo_matmul at M = 8 and 4096), each a
     phase 18 captured decode; the 12 cross K/V products per step timed
     alone (their share of the step); the engine (score_bias=,
     has_memory=True, int8 cache) over 16 requests (budgets 8-24) on 8 slots, each
     request's tokens equal to generate_kv's for it alone; (b) BART-base
     int8 at source 1024, target 128: 18 fusions, no failure, the f32
     fused forward equal to the unfused one bit for bit, 12 blockwise and
     6 monolithic launches, captured f32 and bf16 forwards, pack_weights()
     "kernel" == "unpack" bit for bit; generate_seq2seq (32 new) float and
     int8; bart_decode_step under generate_kv(memory=) against the full
     form (tokens equal, or parted only within phase 7's margin rule);
     (c) Whisper-tiny from features [8, 80, 3000]: generate_seq2seq (32
     new), the decode step against the full form, the int8 encoder (Conv1d
     into the blockwise kernel at N = 1500; packed "kernel" == "unpack"),
     decoder (cross 128 x 1500) and step (cross 1 x 1500), int8 agreement
     with float; (d) the copy-task fixture through JAX's capstone rows
     (float >= 0.97; W8 weight-only equal to float; W4 g=32 + AWQ under
     "kernel"; int8 PTQ; int8 + GPTQ; the int8 KV cache equal to the float
     carry; the paged engine 2x oversubscribed with prefill admission),
     each within 0.02 of float. Every quantize/dequantize, head-split and
     packed-matmul launch of one eager run per path against its plain
     version (0 mismatches; head-split: 0 flipped blocks where the exact
     form sums in torch's order), hs_plan's choice at every head-split
     shape;
 22. QAT and the rest of the model zoo: (a) QAT of mlp.onnx at 4 bits
     under JAX's tests/test_qat.py rules (the loss below 0.8x its first,
     closer to float than PTQ, the float model untouched, train_filter
     keeping fc1 at PTQ's integers, accuracy at least PTQ's), JAX's 3-bit
     ViT capstone on the small fixture (QAT > PTQ + 0.015 held out, the
     loss minimum below half the first) and on the ViT-Base-width fixture
     (then optimize() + pack_weights(): packed_qmatmul, kernel == unpack,
     captured bf16 B=96), BERT-base W4A8 (40 steps on int64 ids, every
     MatMul weight 4 bits); (b) Mamba-130m widths at MAMBA_LAYERS (2) of
     its 24 layers, B=8: the L=128 full form float and int8 captured, the state-carry step under
     generate_mamba (32 + 96; float tokens equal the full form's under
     the margin rule), int8 from mamba_decode_calibration under "kernel"
     (4 splitk_qmatmul launches per layer and the head's per step,
     tokens equal "unpack"'s), the
     state_carry engine over 16 requests equal to generate_mamba alone;
     (c) Mixtral-8x7B widths at 1 of 32 layers: the int8 full form at
     1 x 2048 (1 plain fusion at D=128, fused == unfused bit for bit),
     the step at B=8, cache 512 (float tokens equal the L=32 full form's,
     top-2 routing equal at every position; int8 fused with the int8
     cache; W4 g=128 under "kernel"), fused_attention timed at D=128 and
     splitk_wo_matmul at its six decode shapes; (d) CLIP ViT-B/32, 96
     images x 1,000 prompts of 77 tokens (24 head-split fusions, fused ==
     unfused, f32 and bf16 captured); (e) BERT-base at 32 x 128 (12
     fusions, fused == unfused, one capture for three batches of device
     ids). Every quantize/dequantize, head-split, plain-attention, packed
     and weight-only launch of one eager run per model against its plain
     version, with hs_plan's, qmm_plan's and wo_plan's choice per shape.
 23. data, tensor and pipeline parallelism: four ranks on the one card
     over gloo (numpy_quant_tpu_torch/parallel; the card time-slices
     them, so no time here is a scaling figure), each held against this
     process's single-process port: (a) the int8 ViT-Base at B=32 saved
     here, loaded by every rank, sharded DP x TP 2 x 2 and TP 4,
     optimize() (12 MatMulSplit merges) and pack_weights() (24 stacked
     row shards): logits equal bit for bit under both packed executions,
     fused_attention_hs at 6 and 3 heads and splitk_qmatmul at N/tp
     counted per rank, every kernel launch of one eager run against its
     plain version; W3A8 through packed_qmatmul; (b) TP 2 decodes on two
     rows of two ranks: GPT-2 small int8 and W4 g=128 ("kernel"),
     TinyLlama-1.1B widths at PAR_LLAMA_LAYERS layers int8 (built on the
     CPU, each rank moving its own shard), tokens equal; the engine over
     the TP GPT-2 step, 16 requests on 8 slots, each equal to generate_kv
     alone (decodes of GPT_PROMPT + PAR_NEW tokens); (c) split_stages + pipeline_forward (2 stages x 4
     microbatches) and PP x TP 2 x 2, logits equal bit for bit; (d) every
     kernel at the shard shapes against its plain version and timed, and
     merged against unmerged Q/K/V products; (e) a saved stacked model
     loaded back byte for byte and a QDQ export after the merge equal to
     the unmerged export's logits.
 24. deployment artifacts (utils/aot.py): (a) after phase 18(a, b), the
     main path's int8 ViT-Base under "kernel" saved with save_compiled at
     f32 B=8 and bf16 B=96, both artifacts loaded in one fresh process:
     logits equal the live captured forward's bit for bit, launches
     equal; (b) after phase 7, decode loops (save_decode_loop ->
     load_decode_loop) of GPT-2 small W4 (16 + AOT_NEW, 16), TinyLlama widths at
     AOT_LLAMA_LAYERS layers (int8, int8 cache, RoPE) and the copy fixture
     greedy and sampled: tokens equal generate_kv's; (c) every custom op
     inside a loaded artifact and through torch.library.opcheck.
 25. serve_ring and the fixture trainers: (a) after phase 16(a), the main
     path's int8 ViT-Base under serve_ring over RING_STEPS batches from a
     live generator, f32 B=8 "unpack" and bf16 B=96 "kernel": every output
     equal to __call__'s bit for bit, launches per ring step equal to one
     __call__'s; images/s of serve_ring, map_batches and
     serve_stream(depth=2) in turns, host syncs per step, the idle share
     of one profiled session and the probe's seconds; (b)
     train_base_fixture at its full configuration (ViT-Base widths, 2
     layers, 180 steps of 32) from the port's seeded init: s/step, the
     held-out accuracy beside the committed fixture's by the same forward
     (at least it less 0.05), then the fresh weights through the int8 main
     path, bf16 B=96 "kernel" (2 fused_attention_hs launches, labels
     against float); (c) the copy and modsum trainers at full width, 200
     steps each, dropout on: the last step's loss below step 0's by
     LOSS_DROP, s/step and the full runs reckoned from it.
Phases 1-17 run captured forwards from here on, except where a forward
is swapped or hooked (plain_chain, boundary_cost, phase 3's kernel and
plain-chain turns, record=True): those walk eagerly.
Phase 3 also times the bf16 forward with the plain chains swapped in and
profiles one forward. The last three lines are the kernels JSON line, the
card's name and power limit, and the result line. Imports nothing of JAX or numpy_quant_tpu.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# data-sheet peaks (NVIDIA, dense): device memory bytes/s, int8 ops/s,
# bf16 tensor-core flop/s, f32 flop/s outside the tensor cores
PEAKS = {
    "H100 PCIe": dict(bytes=2.0e12, int8=1513e12, bf16=756e12, f32=51e12),
    "H100 NVL": dict(bytes=3.9e12, int8=1671e12, bf16=835e12, f32=60e12),
    "H100": dict(bytes=3.35e12, int8=1979e12, bf16=989e12, f32=67e12)}

B_CHECK, B_TIME, B_F32, B_SERVE = 32, 96, 8, 96
N_TOK, HEADS, HEAD_DIM = 197, 12, 64
QP = dict(scaling=0.125, sq=0.0513, zq=3, sk=0.0437, zk=-5, sv=0.0317,
          zv=7, sp=float(1.0 / 255.0), zp_p=-128, bit_width=8)
OUT_REQUANT = (0.0213, 4)
SCORE_MAX = 3.17
LOGIT_TOL = 0.1  # fused vs unfused f32 logits, relative to max|logits|

# packed matmuls: the ragged check shape (no multiple of 8, 16 or 128;
# K no multiple of r)
QMM_CHECK = (133, 203, 149)  # M, K, N: ragged K, the general x loader
QMM_CHECK_ALIGNED = (133, 208, 149)  # K % 16 == 0: int8 x takes TMA
QMM_CHECK_DEEP = (300, 8192, 72)  # K past a 32-wide panel: two K slabs
QMM_FORMS = ("tma", "general")
M_TIME = B_TIME * N_TOK      # ViT-Base rows at batch 96
QMM_SHAPES = ((768, 768), (768, 3072), (3072, 768))  # (K, N) per layer
X_SCALE, X_ZP, W_SCALE = 0.0213, 3, 0.0117
PACKED_PER_FORWARD = 6 * 12  # Q, K, V, out, fc1, fc2 in 12 layers
# launches per forward at each (K x N): Q, K, V, out; fc1; fc2
QMM_PER_FORWARD = {"768x768": 4 * 12, "768x3072": 12, "3072x768": 12}

# weight-only matmul: check shapes with ragged M and N (K = 384 lets every
# width take both group forms), and one ragged K (no multiple of r)
WO_CHECK = ((133, 384, 149), (7, 384, 300))
WO_RAGGED_K = (133, 203, 149)
WO_TOL = {"f32": 2e-5, "bf16": 2.0 ** -7}  # max|kernel - plain| / max|y|
GPT_B, GPT_PROMPT, GPT_NEW, GPT_MAX_LEN, WO_GROUP = 8, 16, 48, 64, 128
# (K, N) of c_attn, attn c_proj, c_fc, mlp c_proj and the tied head
DECODE_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768),
                 (768, 50257))
WO_PER_STEP = 4 * 12 + 1
TEACHER_TOL = 1e-4  # kernel vs unpack logits on forced steps, of max|logit|
DECODE_REPS = 5  # timed decodes per (dtype, mode), in turns
LEAD_CYCLES = 2_000_000  # ~1 ms of device sleep ahead of a cold timed call

# blockwise attention (phase 8), head dim 64
BQ_SHAPES = ((2, 1024, 12), (1, 1000, 4), (1, 4096, 2))  # (B, N, H)
MASK_VAL = -3.2e8  # a dequantized -1e9-style causal mask constant
NOSKIP_MASK = -2000.0  # too small for the kernel to skip masked tiles
DEGENERATE_SCORE_MAX = 200.0  # every score clamps: the full-walk case
QP_ZERO = dict(QP, zq=0, zk=0, zv=0, zp_p=0, sp=float(1.0 / 127.0))
ATT_MODES = {"exact": (False, None), "fast": (True, None),
             "fast_shift": (True, SCORE_MAX)}
CAUSAL = {"none": (None, None), "full": (MASK_VAL, None),
          "window256": (MASK_VAL, 256)}
MONO_N, MONO_WINDOW = (197, 256), 64
# the monolithic kernel at D = 128 where K and V take turns in every form
# (the fast forms read K again in their second score pass)
MONO_TURNS_N = (768, 896)
# exact forms of the tiled kernels (phases 8, 10) at short N, N % 4 != 0
# and the strided/vectorized edge: 0 flipped blocks where torch sums a row
# in one warp
EXACT_N = (8, 50, 100, 127, 130, 1000, 1023)
# GPT-2 scoring (phase 9): batch GPT_B at the full context
GPT_SEQ = 1024
SCORE_REPS = 5  # timed forwards per mode, in turns
# TinyLlama-1.1B scoring (phases 10-11): batch LLAMA_B at the full context
LLAMA_B, LLAMA_SEQ = 4, 2048
# score-bias forms (phase 12) at t5-small's heads: the encoder's per-head
# relative bias, a head-shared bias and the decoder's combined bias + causal
# constant, at these key counts (and head dims 32 and 128 at SB_D_N)
SB_B, SB_HEADS = 2, 8
SB_N, SB_D_N = (128, 256, 512, 1024), 256
SB_FORMS = ("per_head", "shared", "decoder")
# T5-small scoring (phase 13): B sequences of T5_SRC source and T5_TGT
# target tokens (t5's fine-tuning input length)
T5_B, T5_SRC, T5_TGT = 8, 512, 128
# quantize/dequantize (phase 14): the boundary kernels every path runs
ELEMENTWISE = ("quantize", "dequantize", "fake_quantize")
# intops.int_matmul (phase 1): the sweep of small shapes cuBLASLt's int8
# kernels refused before the M padding, [70, 48] @ [48, 40] among them
INT_MM_M = (1, 8, 16, 17, 24, 31, 33, 40, 63, 65, 70, 100, 127, 131, 200)
INT_MM_K = (2, 8, 16, 24, 48, 50, 64, 96, 120, 127, 128, 136, 200)
INT_MM_N = (1, 8, 24, 31, 32, 40, 64, 100, 128, 200)
EW_WIDTHS = (1, 2, 3, 4, 7, 8, 9, 12, 16, 32, 64)
EW_SHAPE = (37, 29)  # 1,073 elements: no multiple of the 4-wide vector
EW_LAYOUTS = ("contiguous", "offset", "transposed", "strided", "rows")
EW_SCALE, EW_ZP = 0.0213, -7  # the timed calls' qparams
MLP_ACC_RULE = 6  # the reference's rule: accuracy > 0.9 from 6 bits
# TinyLlama-1.1B decode (phase 15): a server answering DEC_B requests, one
# full-context cache each, DEC_PROMPT teacher-forced ids + DEC_NEW new ones
DEC_B, DEC_LEN, DEC_PROMPT, DEC_NEW = 8, 2048, 32, 32
DEC_REPS = 3  # timed decodes per mode, in turns
DEC_UNFUSED_NEW = 8  # the unfused int8 runs: the prompt + 8 new tokens
DEC_SAMPLED_NEW = 8  # new tokens of each sampled decode
DEC_PROFILE_PROMPT, DEC_PROFILE_NEW = 1, 2  # the profiled decode: 2 steps
# (K, N) of q/o, k/v, gate/up, down and the LM head
LLAMA_WO_SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
                   (2048, 32000))
# TinyLlama-1.1B's depth in phases 11, 15, 16 and 19c: cut from 22 (to 6
# with phase 23, to 3 with phase 24, to 2 with phase 25) to keep the script
# well inside its time limit on a slow host (PERF.md §4)
LLAMA_LAYERS = 2
LLAMA_WO_PER_STEP = LLAMA_LAYERS * 7 + 1  # 7 projections per layer, head
PREFILL_N = 512  # the int8 prefill (B=1); the float one runs DEC_PROMPT
VIT_STEPS = 4  # seeded ViT-Base batches of B_SERVE under map_batches
SERVE_PLENS, SERVE_PER_GROUP = (12, 24, 40), 8  # the engine's three groups
SERVE_BUDGETS = (8, 40)  # new tokens per request, uniform, inclusive
SERVE_PAGED = (16, 22)  # block size, blocks: 21 allocatable of 16 rows
SERVE_K = 4  # steps_per_sync of the chunked runs
SERVE_TEMP = 0.8  # every 4th request's temperature in the sampled runs
ADMIT_PLENS, ADMIT_BUDGETS = (64, 480), (8, 24)  # 16c's 8 requests
GEN_LEN, GEN_B, GEN_PROMPT, GEN_NEW = 64, 2, 16, 32  # 16d's generate
BEAM_W, BEAM_NEW, SPEC_K, DRAFT_LAYERS = 4, 16, 4, 2
BEAM_TOL = 1e-4  # beam score against the summed log-softmax, relative
# phase 17: the JAX package's round-trip rules (mean |dlogit| against the
# source QModel; tests/test_utils.py, tests/test_qoperator.py)
EXPORT_RULES = {"qdq": 0.02, "qoperator": 0.05}
INTEROP_REPS = 10  # forwards per images/s run in 17(d)
# launches phase 16 requires of each kernel on the serving paths
SERVE_LAUNCHES = {
    "fused_attention_hs_per_vit_forward": 12,
    "splitk_qmatmul_per_vit_forward_kernel": PACKED_PER_FORWARD,
    "splitk_wo_matmul_per_w4_engine_step": LLAMA_WO_PER_STEP,
    "fused_attention_per_prefill_admission": LLAMA_LAYERS,
    "fused_attention_per_generate_forward": LLAMA_LAYERS}


def tinyllama() -> dict:
    """TinyLlama-1.1B's config at LLAMA_LAYERS layers (full width)."""
    from numpy_quant_tpu_torch.models.llama import TINYLLAMA_1_1B
    return dict(TINYLLAMA_1_1B, num_hidden_layers=LLAMA_LAYERS)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str) -> dict:
    for key in ("H100 PCIe", "H100 NVL", "H100"):
        if key in name:
            return PEAKS[key]
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def build_kernels() -> float:
    from numpy_quant_tpu_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = list(pool.map(build.compile_source, names))
    seconds = time.perf_counter() - t0
    for name, (path, report) in zip(names, results):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                say("build", kernel=name, ptxas=line.strip().replace(" ", "_"))
        say("build", kernel=name, library=os.path.relpath(path, REPO))
    return seconds


def cuda_ms(fn, reps: int = 20, warmup: int = 3, flush=None,
            lead: bool = False) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events).
    With ``flush`` (a device buffer larger than the L2 cache) zeroed before
    each call, outside the timed span, every call finds L2 cold. With
    ``flush`` or ``lead`` a device sleep queued before the call lets the
    host enqueue it before the device reaches it, so a call whose kernels
    take less time than its Python wrapper is timed on the device alone."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if flush is not None or lead:
            torch.cuda._sleep(LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(b: int, nq: int, seed: int, n: int = N_TOK,
                     heads: int = HEADS, d: int = HEAD_DIM):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shape = (b, n, heads * d)
    q, k, v = (torch.from_numpy(rng.integers(-128, 128, size=shape)
                                .astype(np.int8)).cuda() for _ in range(3))
    return q[:, :nq].contiguous(), k, v


def attention_diff(got, want, heads: int, rq, qp: dict, label: str,
                   int8_step: float | None = None) -> tuple[int, int, float]:
    """An attention kernel's output against another version's: (flipped
    (row, head) blocks, blocks, max |difference|). Raises unless at most
    1% of the blocks differ (or one), each by at most one probability
    step: 255 * sp * sv on f32 out; on int8 out that over the requant
    scale, rounded, floor(255 * sp * sv / res_scale) + 1 (or
    ``int8_step``)."""
    import torch
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, label
    diff = (got.double() - want.double()).abs()
    b, nq, hd = got.shape
    blocks = diff.reshape(b, nq, heads, hd // heads).amax(dim=-1)
    flips = int((blocks > 0).sum())
    max_err = float(diff.max())
    per_flip = 255.0 * qp["sp"] * qp["sv"] * 1.000001
    if rq is not None:
        per_flip = int8_step or float(int(per_flip / rq[0]) + 1)
    if max_err > per_flip or flips > max(1, 0.01 * blocks.numel()):
        raise AssertionError(f"{label}: {flips} of {blocks.numel()} blocks "
                             f"differ, max |diff| {max_err}")
    return flips, blocks.numel(), max_err


def check_attention() -> float:
    """Kernel against plain version in every variant; returns the largest
    |difference| over the f32-output variants. First the monolithic
    kernel's shared-memory carve-up against its host mirror
    (kernels/attention.py::hs_smem_bytes, which plans every launch)."""
    from numpy_quant_tpu_torch.kernels import attention as A
    lib = A._library("attention_hs", A._HSParams)
    layouts = list(itertools.product((1, 8, 50, 128, 197, 256, 512, 896, 1000),
                                     A.KERNEL_DIMS, (1, 2, 4, 8), (0, 1),
                                     (0, 1)))
    for n, d, warps, both, exact in layouts:
        assert lib.nq_attention_hs_smem_bytes(n, d, warps, both, exact) \
            == A.hs_smem_bytes(n, d, warps, both, exact), (n, d, warps)
    say("kernel-check", kernel="fused_attention_hs", scope="smem_layout",
        layouts=len(layouts), host_mirror_equal=True)
    worst = 0.0
    cases = [(False, rq, nq, None) for rq, nq in itertools.product(
        (None, OUT_REQUANT), (N_TOK, 1))]
    cases += [(True, rq, nq, sm) for rq, nq, sm in itertools.product(
        (None, OUT_REQUANT), (N_TOK, 1), (None, SCORE_MAX))]
    for i, (fast, rq, nq, sm) in enumerate(cases):
        q, k, v = attention_inputs(B_CHECK, nq, seed=i)
        kw = dict(QP, num_heads=HEADS, fast=fast, out_requant=rq,
                  score_max=sm)
        flips, blocks, max_err = attention_diff(
            A.fused_attention_hs(q, k, v, **kw),
            A.fused_attention_hs_reference(q, k, v, **kw), HEADS, rq, QP,
            "fused_attention_hs against its plain version", int8_step=1.0)
        say("kernel-check", kernel="fused_attention_hs", fast=fast,
            out_requant=rq is not None, nq=nq, score_max=sm,
            flipped_blocks=f"{flips}/{blocks}", max_abs_err=max_err)
        if not fast:
            # the exact form sums rows in torch's order (N % 4 != 0: each
            # row's own unaligned head and tail), so no block may flip
            assert exact_in_order(B_CHECK * HEADS * nq, N_TOK) \
                and flips == 0, (nq, rq, flips)
        if rq is None:
            worst = max(worst, max_err)
    return worst


def time_attention(name: str) -> dict:
    """The serving form (fast, int8 out, full q) at batch 96: kernel,
    plain version and bound; the exact f32 form is printed beside it."""
    from numpy_quant_tpu_torch.kernels import attention as A
    mem_rate, int8_rate = peaks(name)["bytes"], peaks(name)["int8"]
    q, k, v = attention_inputs(B_TIME, N_TOK, seed=99)
    res = {}
    for label, fast, rq in (("serving", True, OUT_REQUANT),
                            ("exact_f32", False, None)):
        kw = dict(QP, num_heads=HEADS, fast=fast, out_requant=rq,
                  score_max=SCORE_MAX if fast else None)
        ms = cuda_ms(lambda: A.fused_attention_hs(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: A.fused_attention_hs_reference(q, k, v, **kw))
        out_bytes = q.numel() * (1 if rq is not None else 4)
        nbytes = q.numel() + k.numel() + v.numel() + out_bytes
        ops = 4 * B_TIME * HEADS * N_TOK * N_TOK * HEAD_DIM
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / int8_rate * 1e3
        res[label] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations")
        say("kernel-time", kernel="fused_attention_hs", form=label,
            shape=f"B{B_TIME}xN{N_TOK}xH{HEADS}xD{HEAD_DIM}", ms=ms,
            plain_ms=plain_ms, bound_ms=res[label]["bound_ms"],
            bound_by=res[label]["bound_by"], bytes=nbytes, ops=ops,
            card=name.replace(" ", "_"))
    return res["serving"]


def attention_flips(qmodel, x, skips: list | None = None) -> tuple[int, int]:
    """The attention kernels against their plain versions on every
    attention layer's real inputs (one recorded forward of ``x``, an input
    or a list of inputs): flipped (row, head) blocks. ``skips`` receives,
    per FusedAttention call, whether its kernel skips masked key tiles.
    The recorded values are dropped afterwards."""
    import torch
    from numpy_quant_tpu_torch.graph import Variable
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.ops.registry import (attention_call,
                                                    plain_attention_call)
    qmodel(x if isinstance(x, list) else [x], record=True, as_numpy=False)
    recorded = {v.name: v.data for v in qmodel.values if v.data is not None}
    flips = blocks = 0
    for node in qmodel.nodes:
        if node.op not in ("FusedAttentionHS", "FusedAttention"):
            continue
        # the operands as the executor hands them to the op (quantized)
        ins = qmodel._node_inputs(node, recorded)
        if node.op == "FusedAttention":
            q, kt, v, kw = plain_attention_call(ins, node.attrs)
            if skips is not None:
                skips.append(A.skips_masked_tiles(q.shape[-1], **kw))
            got = A.fused_attention(q, kt, v, **kw)
            want = A.fused_attention_reference(q, kt, v, **kw)
            heads = 1  # one (row, head) block per row of [BH, N, D]
        else:
            q, k, v, kw, _ = attention_call(ins, node.attrs)
            got = A.fused_attention_hs(q, k, v, **kw)
            bias = kw["score_bias"]
            plain = A.fused_attention_hs_blockq_reference \
                if A.blockwise(k.shape[1], None, nq=q.shape[1],
                               bias_heads=None if bias is None
                               else kw["num_heads"]) \
                else A.fused_attention_hs_reference
            want = plain(q, k, v, **kw)
            heads = kw["num_heads"]
        diff = (got.double() - want.double()).abs()
        b, nq, hd = got.shape
        per_block = diff.reshape(b, nq, heads, -1).amax(dim=-1)
        flips += int((per_block > 0).sum())
        blocks += per_block.numel()
    torch.cuda.synchronize()
    del recorded
    for v in qmodel.values:
        if isinstance(v, Variable):
            v.data = None
    return flips, blocks


def qmm_operands(layout: str, bits: int, m: int, k: int, n: int, seed: int,
                 *, per_channel: bool, quantize_x: bool, bias: bool,
                 requant: bool, x_dtype=None):
    """Random operands and keyword arguments of one packed-matmul call, on
    the card: (x, payload, colsum, bias, w_scale_vec, kwargs, int8 W)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.kernels.pack import pack_bitplanes, pack_splitk
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int32)
    if layout == "splitk":
        payload = w.astype(np.int8) if bits == 8 else pack_splitk(w, bits)
    else:
        payload = pack_bitplanes(w, bits)
    if quantize_x:
        x = torch.from_numpy((rng.normal(size=(m, k)) * 1.3).astype(np.float32))
    else:
        x = torch.from_numpy(rng.integers(-128, 128, size=(m, k))
                             .astype(np.int8)).to(x_dtype or torch.int8)
    kw = dict(bits=bits, bit_width=8, x_scale=X_SCALE,
              x_zp=None if seed % 3 == 0 else X_ZP, quantize_x=quantize_x,
              out_requant=(0.0371, -5, 8) if requant else None)
    wvec = None
    if per_channel:
        wvec = torch.from_numpy(rng.uniform(0.004, 0.02, size=(1, n))
                                .astype(np.float32)).cuda()
    else:
        kw["w_scale"] = W_SCALE
    b = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32)).cuda() \
        if bias else None
    colsum = torch.from_numpy(w.sum(axis=0, keepdims=True).astype(np.int32))
    return (x.cuda(), torch.from_numpy(payload).cuda(), colsum.cuda(), b,
            wvec, kw, torch.from_numpy(w.astype(np.int8)).cuda())


def check_qmatmul() -> tuple[dict, dict]:
    """Both packed kernels against their plain versions in every variant
    (per-tensor or per-channel scale, quantize_x, bias, out_requant; int8
    or int32 x) at every width, on a ragged shape (the general x loader)
    and on one whose K is 16-byte aligned (int8 x takes the TMA loader),
    then once at a K deep enough for two panel slabs; returns the largest
    |difference| of the f32-output variants per kernel and the launches
    of each x form per kernel. Bit equality is required, and both forms
    must run."""
    import torch
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    worst, forms = {}, {}
    for name, layout, widths in (
            ("splitk_qmatmul", "splitk", (1, 2, 4, 8)),
            ("packed_qmatmul", "bitplanes", range(1, 9))):
        fn = getattr(Q, name)
        ref = getattr(Q, name + "_reference")
        worst[name], mismatches, outputs, calls = 0.0, 0, 0, 0
        before = dict(fn.launches_by_form)
        cases = [(shape, bits, i, v) for shape in (QMM_CHECK,
                                                   QMM_CHECK_ALIGNED)
                 for bits in widths for i, v in enumerate(
                     itertools.product((False, True), repeat=4))]
        cases.append((QMM_CHECK_DEEP, 2 if layout == "splitk" else 3, 4,
                      (False, False, True, False)))
        for (m, k, n), bits, i, (pc, qx, bias, rq) in cases:
            x, payload, colsum, b, wvec, kw, _ = qmm_operands(
                layout, bits, m, k, n, seed=16 * bits + i,
                per_channel=pc, quantize_x=qx, bias=bias, requant=rq,
                x_dtype=torch.int32 if i % 4 == 1 else torch.int8)
            got = fn(x, payload, colsum, b, wvec, **kw)
            want = ref(x, payload, colsum, b, wvec, **kw)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype
            mismatches += int((got != want).sum())
            outputs += got.numel()
            calls += 1
            if not rq:
                worst[name] = max(worst[name],
                                  float((got - want).abs().max()))
        forms[name] = {f: fn.launches_by_form[f] - before[f]
                       for f in QMM_FORMS}
        say("kernel-check", kernel=name, variants=calls,
            shapes=",".join(f"M{m}xK{k}xN{n}" for m, k, n in (
                QMM_CHECK, QMM_CHECK_ALIGNED, QMM_CHECK_DEEP)),
            mismatches=f"{mismatches}/{outputs}", max_abs_err=worst[name],
            **{f"launches_{f}": c for f, c in forms[name].items()})
        if mismatches:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {mismatches} outputs")
        assert all(forms[name].values()), (name, forms[name])
    return worst, forms


def time_qmatmul(name: str) -> dict:
    """At the ViT-Base shapes at batch 96 (M = 18,912), where the
    persistent walk takes many M tiles per block and K = 3072 the narrow
    panel: each kernel against its plain version bit for bit (W8 and W4
    split-K, W3 bit-planes), then the serving form (int8 x already
    quantized, f32 out) timed with a device sleep ahead of each call:
    kernel, plain version, bound, and torch._int_mm on the unpacked int8
    weight plus the eager epilogue (not one call: the product, then the
    elementwise correction and dequantize). Returns, per kernel at its
    path's width, the 768->3072 numbers and every shape's."""
    import torch
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    mem_rate, int8_rate = peaks(name)["bytes"], peaks(name)["int8"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for kname, layout, bits, per_channel in (
            ("splitk_qmatmul", "splitk", 8, False),
            ("splitk_qmatmul", "splitk", 4, True),
            ("packed_qmatmul", "bitplanes", 3, False)):
        fn = getattr(Q, kname)
        ref = getattr(Q, kname + "_reference")
        for k, n in QMM_SHAPES:
            x, payload, colsum, _, wvec, kw, w8 = qmm_operands(
                layout, bits, M_TIME, k, n, seed=1, per_channel=per_channel,
                quantize_x=False, bias=False, requant=False)
            before = dict(fn.launches_by_form)
            got = fn(x, payload, colsum, None, wvec, **kw)
            form = next(f for f in QMM_FORMS
                        if fn.launches_by_form[f] != before[f])
            mismatches = int((got != ref(x, payload, colsum, None, wvec,
                                         **kw)).sum())
            del got
            scale_row = torch.full((), X_SCALE, device="cuda") * wvec \
                if per_channel else torch.full(
                    (), float(X_SCALE * W_SCALE), device="cuda")
            zp = torch.full((), X_ZP, dtype=torch.int32, device="cuda")

            def library():
                acc = torch._int_mm(x, w8)
                return (acc - colsum * zp).to(torch.float32) * scale_row

            ms = cuda_ms(lambda: fn(x, payload, colsum, None, wvec, **kw),
                         lead=True)
            plain_ms = cuda_ms(lambda: ref(x, payload, colsum, None, wvec,
                                           **kw), lead=True)
            library_ms = cuda_ms(library, lead=True)
            nbytes = (x.numel() + payload.numel() + 4 * n
                      + (4 * n if per_channel else 0) + 4 * M_TIME * n)
            ops = 2 * M_TIME * n * k
            t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / int8_rate * 1e3
            plan = Q.qmm_plan(M_TIME, n, k, bits, layout, sms)
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       mismatches=mismatches, form=form,
                       plan={key: plan[key] for key in (
                           "bn", "stages", "panels", "ranges", "slabs")})
            say("kernel-time", kernel=kname, bits=bits,
                scale="per_channel" if per_channel else "per_tensor",
                shape=f"M{M_TIME}xK{k}xN{n}", form=form,
                mismatches=f"{mismatches}/{M_TIME * n}", ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library="_int_mm+eager_epilogue", bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], x_bound=ms / row["bound_ms"],
                bytes=nbytes, ops=ops,
                plan=",".join(f"{key}={v}" for key, v in row["plan"].items()),
                card=name.replace(" ", "_"))
            assert mismatches == 0, (kname, bits, k, n, mismatches)
            assert form == "tma", (kname, k, form)
            if bits != 8:
                res.setdefault(kname, {"shapes": {}})
                res[kname]["shapes"][f"{k}x{n}"] = row
                if (k, n) == (768, 3072):
                    res[kname].update(row)
    return res


def counted(fn):
    """Run ``fn()`` with every kernel's launch count set to 0 just
    before; returns its result and the counts read just after."""
    from numpy_quant_tpu_torch import kernels as K
    counters = {name: getattr(K, name) for name in (
        "fused_attention_hs", "fused_attention_hs_blockq", "splitk_qmatmul",
        "packed_qmatmul", "splitk_wo_matmul", "fused_attention",
        *ELEMENTWISE)}
    for f in counters.values():
        f.launches = 0
    out = fn()
    return out, {name: f.launches for name, f in counters.items()}


def others(counts: dict) -> int:
    """Launches of every kernel but the quantize boundaries', which every
    path runs."""
    return sum(v for k, v in counts.items() if k not in ELEMENTWISE)


@contextlib.contextmanager
def packed_execution(mode: str):
    from numpy_quant_tpu_torch import config
    prev = config.packed_execution
    config.packed_execution = mode
    try:
        yield
    finally:
        config.packed_execution = prev


def packed_forward(qmodel, x, mode: str):
    """One forward under packed_execution=mode, with its launch counts."""
    with packed_execution(mode):
        return counted(lambda: qmodel([x])[0])


def images_per_s(qmodel, x, mode: str, reps: int = 20) -> float:
    import torch
    with packed_execution(mode):
        for _ in range(3):
            qmodel([x], as_numpy=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            qmodel([x], as_numpy=False)
        torch.cuda.synchronize()
        return x.shape[0] * reps / (time.perf_counter() - t0)


def wo_operands(bits: int, m: int, k: int, n: int, groups: int, seed: int,
                dtype):
    """Random operands of one weight-only call on the card: (x, payload,
    scale) with a host scalar scale at groups=0, else a [groups, N]
    device tensor (1 = per channel)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.kernels.pack import pack_splitk
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int8)
    payload = w if bits == 8 else pack_splitk(w, bits)
    if groups == 0:
        scale = float(np.float32(rng.uniform(0.004, 0.02)))
    else:
        scale = torch.from_numpy(rng.uniform(0.004, 0.02, size=(groups, n))
                                 .astype(np.float32)).cuda()
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    return x.to(dtype).cuda(), torch.from_numpy(payload).cuda(), scale


def wo_compare(x, payload, scale, bits: int, label: str) -> tuple[float, float]:
    """The kernel against its plain version on one input: (max|diff|,
    max|y|); raises beyond the tolerance of x's type."""
    import torch
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    got = Q.splitk_wo_matmul(x, payload, scale, bits=bits)
    want = Q.splitk_wo_matmul_reference(x, payload, scale, bits=bits)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == x.dtype
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    tol = WO_TOL["bf16" if x.dtype == torch.bfloat16 else "f32"]
    if not err <= tol * top:
        raise AssertionError(f"splitk_wo_matmul disagrees with its plain "
                             f"version ({label}): {err} > {tol} * {top}")
    return err, top


def check_wo() -> float:
    """splitk_wo_matmul against its plain version at every width, scale
    form and float type; returns the largest |difference| of the f32
    variants."""
    import torch
    worst = 0.0
    for bits in (1, 2, 4, 8):
        kr = 384 * bits // 8
        # per tensor, per channel, groups of 16 rows (within a field), of a
        # whole field (K/2 at 8 bits, where a field is all of K) and, at 1
        # and 2 bits, of two whole fields (scale row v // gsz spans fields)
        forms = {"tensor": 0, "channel": 1, "group16": 384 // 16,
                 "group_field": 384 // (kr if bits < 8 else 192)}
        if bits < 4:
            forms["group_2field"] = 384 // (2 * kr)
        cases = [(shape, f) for shape in WO_CHECK for f in forms]
        cases += [(WO_RAGGED_K, f) for f in ("tensor", "channel")]
        for tname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            err = rel = 0.0
            for i, ((m, k, n), form) in enumerate(cases):
                x, payload, scale = wo_operands(bits, m, k, n, forms[form],
                                                seed=100 * bits + i,
                                                dtype=dtype)
                e, top = wo_compare(x, payload, scale, bits,
                                    f"{bits} bits {tname} M{m}xK{k}xN{n} "
                                    f"{form}")
                err, rel = max(err, e), max(rel, e / top)
            say("kernel-check", kernel="splitk_wo_matmul", bits=bits,
                dtype=tname, variants=len(cases),
                shapes="+".join(f"M{m}xK{k}xN{n}" for m, k, n in
                                WO_CHECK + (WO_RAGGED_K,)),
                max_abs_err=err, max_err_over_max_y=rel, tolerance=WO_TOL[tname])
            if tname == "f32":
                worst = max(worst, err)
    return worst


def time_wo(name: str, shapes=DECODE_SHAPES, path: str = "gpt2",
            m: int = GPT_B) -> dict:
    """The decode shapes (K, N) at M = ``m`` (8), W4 g=128, f32 and bf16, each
    first held against the plain version: kernel, plain version, bound and
    the library call (torch.matmul on the weight dequantized beforehand,
    in x's type: 8x (f32) or 4x (bf16) the payload's bytes), every call
    with a cold L2, as in a decode step whose weights outrun it (62 MB on
    GPT-2, 551 MB on TinyLlama); each shape's launch plan (the cluster
    along K) beside it. Returns the rows by dtype and "KxN"."""
    import torch
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    rates = peaks(name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for tname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for k, n in shapes:
            x, payload, scale = wo_operands(4, m, k, n, k // WO_GROUP,
                                            seed=k + n, dtype=dtype)
            err, top = wo_compare(x, payload, scale, 4,
                                  f"{path} M{m} {k}->{n}")
            w = Q.unpack_splitk(payload, 4, k).float()
            w_deq = (w * torch.repeat_interleave(scale, WO_GROUP, dim=0)) \
                .to(dtype)
            del w
            ms = cuda_ms(lambda: Q.splitk_wo_matmul(x, payload, scale, bits=4),
                         flush=flush)
            plain_ms = cuda_ms(lambda: Q.splitk_wo_matmul_reference(
                x, payload, scale, bits=4), flush=flush)
            library_ms = cuda_ms(lambda: torch.matmul(x, w_deq), flush=flush)
            del w_deq
            size = x.element_size()
            nbytes = (payload.numel() + 4 * scale.numel() + size * x.numel()
                      + size * m * n)
            ops = 2 * m * k * n
            t_bytes = nbytes / rates["bytes"] * 1e3
            t_ops = ops / rates[tname] * 1e3
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=err, max_err_over_max_y=err / top)
            plan = Q.wo_plan(m, n, payload.shape[0], 4, sms)
            say("kernel-time", kernel="splitk_wo_matmul", path=path, bits=4,
                scale=f"g{WO_GROUP}", dtype=tname,
                shape=f"M{m}xK{k}xN{n}", cluster=plan["cluster"],
                blocks=plan["blocks"], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library="matmul_on_dequantized_weight",
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                bytes=nbytes, ops=ops, max_abs_err=err,
                tolerance=f"{WO_TOL[tname]}*max|y|", l2="cold",
                card=name.replace(" ", "_"))
            res.setdefault(tname, {})[f"{k}x{n}"] = row
    del flush
    return res


def device_bytes(model) -> dict:
    """Bytes the step model keeps on the card, by kind."""
    from numpy_quant_tpu_torch.graph import Constant
    from numpy_quant_tpu_torch.tensor import FTensor, PackedQTensor
    out = dict(payload=0, scales=0, colsums=0, float=0, tables=0)
    for v in model.values:
        if not isinstance(v, Constant):
            continue
        d = v.data
        if isinstance(d, PackedQTensor):
            out["payload"] += d.planes.numel() * d.planes.element_size()
            out["colsums"] += d.colsum.numel() * d.colsum.element_size()
            sv = d.scale_vec()
            out["scales"] += 0 if sv is None else sv.numel() * 4
        elif isinstance(d, FTensor):
            out["float"] += d.data.numel() * d.data.element_size()
    for _, table in model.__dict__.get("_table_cache", {}).values():
        out["tables"] += table.numel() * table.element_size()
    return out


@contextlib.contextmanager
def decode_mode(dtype: str, mode: str):
    """packed_execution=mode, in bf16 (low_precision_floats) or f32."""
    from numpy_quant_tpu_torch import config
    floats = config.low_precision_floats() if dtype == "bf16" \
        else contextlib.nullcontext()
    with packed_execution(mode), floats:
        yield


def decode_run(model, proto, prompt, dtype: str, mode: str):
    """One greedy decode; returns (ids, per-step logits, launch counts)."""
    from numpy_quant_tpu_torch.utils import generate_kv
    rows = []
    with decode_mode(dtype, mode):
        ids, counts = counted(lambda: generate_kv(
            model, prompt, proto._wte, proto._wpe, GPT_NEW, step_logits=rows))
    return ids, rows, counts


def decode_seconds(model, proto, prompt, runs: list, reps: int) -> dict:
    """Wall seconds of ``reps`` greedy decodes of each (dtype, mode) in
    ``runs``, taken in turns (forward, then backward order) so that a
    host that slows for a while slows every mode alike."""
    import torch
    from numpy_quant_tpu_torch.utils import generate_kv
    seconds = {run: [] for run in runs}
    for rep in range(reps):
        for run in (runs if rep % 2 == 0 else runs[::-1]):
            with decode_mode(*run):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                generate_kv(model, prompt, proto._wte, proto._wpe, GPT_NEW)
                seconds[run].append(time.perf_counter() - t0)
    return seconds


def compare_decodes(ids_a, rows_a, ids_b, rows_b,
                    prompt: int = GPT_PROMPT) -> dict:
    """Greedy runs a and b of one model: the largest |logit difference|
    over the steps whose inputs agree in both (a row's ids equal up to
    the step), that over the teacher-forced steps (the first ``prompt``),
    and the rows that part, each with its top-2 margin (of run b) at the
    step where they part. A shorter run b is compared over its length."""
    import numpy as np
    ids_a = ids_a[:, :ids_b.shape[1]]
    same_upto = np.cumprod(ids_a == ids_b, axis=1).astype(bool)
    max_diff = forced_diff = max_logit = 0.0
    for t, (ra, rb) in enumerate(zip(rows_a, rows_b)):
        diff = (ra - rb).abs().amax(dim=1).cpu().numpy()
        live = same_upto[:, t]
        if live.any():
            max_diff = max(max_diff, float(diff[live].max()))
        if t < prompt:  # inputs all from the prompt
            forced_diff = max(forced_diff, float(diff.max()))
        max_logit = max(max_logit, float(rb.abs().max()))
    parted = []
    for b in range(ids_a.shape[0]):
        if same_upto[b, -1]:
            continue
        p = int(np.argmin(same_upto[b]))  # first position that differs
        top2 = rows_b[p - 1][b].topk(2).values
        parted.append((b, p, float(top2[0] - top2[1])))
    return dict(max_diff=max_diff, forced_diff=forced_diff,
                max_logit=max_logit, parted=parted)


def decode_phase(card: str) -> tuple:
    """Phase 7: returns the f32 "kernel" run's launch counts and the W4
    model with its proto (phase 24(b))."""
    import numpy as np
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.gpt import (GPT2_SMALL, gpt_decode_step,
                                                  random_gpt2_weights)
    from numpy_quant_tpu_torch.utils import generate_kv
    t0 = time.perf_counter()
    proto = gpt_decode_step(random_gpt2_weights(GPT2_SMALL, seed=0),
                            GPT2_SMALL, batch_size=GPT_B, max_len=GPT_MAX_LEN)
    model = Model.from_onnx(proto)
    converted = model.quantize_weights(bit_width=4, group_size=WO_GROUP)
    say("gpt2-setup", seconds=time.perf_counter() - t0, nodes=len(model.nodes),
        converted=converted, device=model.device)
    assert converted == WO_PER_STEP, converted
    prompt = np.random.default_rng(0).integers(
        0, GPT2_SMALL["vocab_size"], size=(GPT_B, GPT_PROMPT)).astype(np.int32)
    steps = GPT_PROMPT + GPT_NEW - 1
    modes = [(d, m) for d in ("f32", "bf16") for m in ("kernel", "unpack")]
    runs = {}
    for dtype, mode in modes:
        ids, rows, counts = decode_run(model, proto, prompt, dtype, mode)
        runs[dtype, mode] = ids, rows, counts
    seconds = decode_seconds(model, proto, prompt, modes, DECODE_REPS)
    for dtype, mode in modes:
        ids, rows, counts = runs[dtype, mode]
        wo = counts["splitk_wo_matmul"]
        finite = all(bool(r.isfinite().all()) for r in rows)
        wall = statistics.median(seconds[dtype, mode])
        say("gpt2-decode", dtype=dtype, packed_execution=mode,
            batch=GPT_B, prompt=GPT_PROMPT, new_tokens=GPT_NEW,
            steps=steps, kernel_launches_per_step=wo / steps,
            other_kernel_launches=others(counts) - wo,
            tokens_per_s=GPT_B * GPT_NEW / wall,
            ms_per_step=wall / steps * 1e3,
            ms_per_step_runs=",".join(
                f"{s / steps * 1e3:.2f}" for s in seconds[dtype, mode]),
            finite=finite, card=card.replace(" ", "_"))
        assert ids.shape == (GPT_B, GPT_PROMPT + GPT_NEW), ids.shape
        assert (ids[:, :GPT_PROMPT] == prompt).all()
        assert finite, f"{dtype} {mode}: non-finite logits"
        assert wo == (WO_PER_STEP * steps if mode == "kernel" else 0), wo
        assert others(counts) == wo, counts
    say("gpt2-memory", **{f"{k}_bytes": v
                          for k, v in device_bytes(model).items()})
    ids_k, rows_k, counts = runs["f32", "kernel"]
    ids_u, rows_u, _ = runs["f32", "unpack"]
    cmp = compare_decodes(ids_k, rows_k, ids_u, rows_u)
    # where greedy rows part, the two runs' logits at that step may differ
    # by max_diff each, so the top-2 margin there is at most 2 * max_diff
    unexplained = [c for c in cmp["parted"] if c[2] > 2 * cmp["max_diff"]]
    gen = slice(GPT_PROMPT, None)
    say("gpt2-f32-kernel-vs-unpack",
        tokens_equal=f"{int((ids_k[:, gen] == ids_u[:, gen]).sum())}/"
                     f"{ids_k[:, gen].size}",
        rows_equal=f"{GPT_B - len(cmp['parted'])}/{GPT_B}",
        rows_parted_within_margin=len(cmp["parted"]) - len(unexplained),
        parted=";".join(f"row{b}@{p}:margin{m:.3g}" for b, p, m in cmp["parted"])
        or "none",
        max_abs_logit_diff=cmp["max_diff"],
        teacher_forced_max_diff=cmp["forced_diff"],
        max_abs_logit=cmp["max_logit"])
    assert not unexplained, unexplained
    assert cmp["forced_diff"] <= TEACHER_TOL * cmp["max_logit"], cmp
    for mode in ("kernel", "unpack"):
        ids_b = runs["bf16", mode][0]
        say("gpt2-bf16-vs-f32-kernel", packed_execution=mode,
            tokens_equal=f"{int((ids_b[:, gen] == ids_k[:, gen]).sum())}/"
                         f"{ids_k[:, gen].size}")
    # phase 18 (g): the W4 decode step captured, through generate_kv
    with packed_execution("kernel"):
        captured_decode(
            "gpt2_w4_decode", card, model,
            lambda m: (generate_kv(m, prompt, proto._wte, proto._wpe,
                                   GPT_NEW), steps),
            np.array_equal, lambda ids: GPT_B * GPT_NEW, dtype="f32",
            packed_execution="kernel", batch=GPT_B)
    return counts, (model, proto)


def forms_launched() -> dict:
    """Phases 1, 8 and 12 together launch every template instantiation
    (head dim x score bias in or out x softmax form) of both head-split
    kernels: the instantiations each wrapper counted since the start."""
    from numpy_quant_tpu_torch.kernels import attention as A
    res = {}
    for kname in ("fused_attention_hs", "fused_attention_hs_blockq"):
        by_form = getattr(A, kname).launches_by_form
        missing = [f for f in A.HS_FORMS if not by_form[f]]
        res[kname] = len(A.HS_FORMS) - len(missing)
        say("kernel-forms", kernel=kname, launched=res[kname],
            instantiations=len(A.HS_FORMS), missing="|".join(missing) or None)
        assert not missing, (kname, missing)
    return res


def check_int_matmul() -> dict:
    """intops.int_matmul (torch._int_mm on zero-padded operands,
    intops.int_mm_shape) against a float64 product over a sweep of small
    shapes around [70, 48] @ [48, 40]: every product computed and exact.
    Beside it, the rule behind the padding: each shape torch._int_mm
    refuses with only K and N padded to 8 and M to 17 rows is one whose
    M int_mm_shape pads further (K < 128, N >= 32)."""
    import torch
    from numpy_quant_tpu_torch import intops
    g = torch.Generator(device="cuda").manual_seed(70)
    shapes = list(itertools.product(INT_MM_M, INT_MM_K, INT_MM_N))
    assert (70, 48, 40) in shapes
    wrong, refused = [], []
    for m, k, n in shapes:
        a = torch.randint(-128, 128, (m, k), device="cuda", dtype=torch.int8,
                          generator=g)
        b = torch.randint(-128, 128, (k, n), device="cuda", dtype=torch.int8,
                          generator=g)
        got = intops.int_matmul(a, b)
        want = (a.double() @ b.double()).to(torch.int32)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            wrong.append((m, k, n))
        _, kp, np_ = intops.int_mm_shape(m, k, n)
        try:
            torch._int_mm(intops._pad_to(intops._pad_to(a, 1, kp), 0,
                                         max(m, 17)).contiguous(),
                          intops._pad_to(intops._pad_to(b, 0, kp), 1,
                                         np_).contiguous())
        except RuntimeError:
            refused.append((m, k, n))
    torch.cuda.synchronize()
    outside = [s for s in refused
               if intops.int_mm_shape(*s)[0] == max(s[0], 17)]
    res = dict(shapes=len(shapes), wrong=len(wrong),
               refused_without_row_padding=len(refused),
               refused_outside_the_rule=len(outside),
               refused_m=",".join(map(str, sorted({s[0] for s in refused}))),
               refused_k=",".join(map(str, sorted({s[1] for s in refused}))),
               refused_n=",".join(map(str, sorted({s[2] for s in refused}))),
               padded_70x48x40="x".join(map(str, intops.int_mm_shape(70, 48,
                                                                     40))))
    say("int-matmul-check", **res)
    assert not wrong, wrong[:20]
    assert not outside, outside[:20]
    return res


def attention_kw(heads: int, mode: str, causal: str, rq, qp: dict,
                 **over) -> dict:
    fast, score_max = ATT_MODES[mode]
    mask, window = CAUSAL[causal]
    kw = dict(qp, num_heads=heads, fast=fast, score_max=score_max,
              out_requant=rq, causal_mask_val=mask, causal_window=window)
    kw.update(over)
    return kw


def check_blockq() -> float:
    """Phase 8: the blockwise kernel against its plain version, the
    monolithic kernel's causal forms against theirs, and blockwise against
    monolithic. Returns the largest |difference| of the f32-output
    blockwise variants."""
    from numpy_quant_tpu_torch.kernels import attention as A
    worst, seed = 0.0, 1000

    def against_plain(b, n, h, nq, rq, qp, kw, label, fn=None, plain=None,
                      d=HEAD_DIM):
        """(flipped blocks, blocks, max |diff| on f32 out, else 0)."""
        nonlocal seed
        seed += 1
        q, k, v = attention_inputs(b, nq, seed, n=n, heads=h, d=d)
        fn = fn or A.fused_attention_hs_blockq
        plain = plain or A.fused_attention_hs_blockq_reference
        flips, blocks, err = attention_diff(
            fn(q, k, v, **kw), plain(q, k, v, **kw), h, rq, qp, label)
        if not kw["fast"]:
            # exact forms: no flip where both sides sum rows in torch's
            # order (the blockwise plain version in BLOCK_Q-row q tiles)
            tiles = {nq}
            if plain is A.fused_attention_hs_blockq_reference:
                tiles = {min(nq, A.BLOCK_Q), nq % A.BLOCK_Q or min(nq, A.BLOCK_Q)}
            if all(exact_in_order(b * h * t, n) for t in tiles):
                assert flips == 0, (label, flips, blocks)
        return flips, blocks, err if rq is None else 0.0

    def summary(kernel, shape, label, results):
        err = max(r[2] for r in results)
        say("kernel-check", kernel=kernel, shape=shape, cases=label,
            variants=len(results),
            flipped_blocks=f"{sum(r[0] for r in results)}/"
                           f"{sum(r[1] for r in results)}",
            max_abs_err_f32_out=err)
        return err

    variants = list(itertools.product(CAUSAL, (None, OUT_REQUANT),
                                      ("nonzero", "zero")))
    for b, n, h in BQ_SHAPES:
        for mode in ATT_MODES:
            res = []
            for causal, rq, zp in variants:
                qp = QP if zp == "nonzero" else QP_ZERO
                res.append(against_plain(
                    b, n, h, n, rq, qp, attention_kw(h, mode, causal, rq, qp),
                    f"blockq B{b} N{n} H{h} {mode} {causal} rq={rq} zp={zp}"))
            worst = max(worst, summary(
                "fused_attention_hs_blockq", f"B{b}xN{n}xH{h}xD{HEAD_DIM}",
                f"{mode}:causal_none/full/window256:rq_off/on:zp_nonzero/zero",
                res))
    # the exact form at short N, N % 4 != 0 and the 128-key edge
    for n in EXACT_N:
        res = []
        for causal, rq, zp in variants:
            qp = QP if zp == "nonzero" else QP_ZERO
            res.append(against_plain(
                1, n, 3, n, rq, qp, attention_kw(3, "exact", causal, rq, qp),
                f"blockq exact N{n} {causal} rq={rq} zp={zp}"))
        worst = max(worst, summary(
            "fused_attention_hs_blockq", f"B1xN{n}xH3xD{HEAD_DIM}",
            "exact_N:causal_none/full/window256:rq_off/on:zp", res))
    # narrow q (no mask) at N = 4096
    res = []
    for nq, mode, rq, zp in itertools.product((1, 3), ATT_MODES,
                                              (None, OUT_REQUANT),
                                              ("nonzero", "zero")):
        qp = QP if zp == "nonzero" else QP_ZERO
        res.append(against_plain(1, 4096, 2, nq, rq, qp,
                                 attention_kw(2, mode, "none", rq, qp),
                                 f"blockq narrow nq={nq} {mode} rq={rq}"))
    worst = max(worst, summary("fused_attention_hs_blockq", "B1xN4096xH2",
                               "narrow_q1/3:all_modes:rq_off/on:zp",
                               res))
    # the other head dims the kernel is built for
    for d in (16, 32, 128):
        res = []
        for mode, causal, rq in itertools.product(ATT_MODES, ("none", "full"),
                                                  (None, OUT_REQUANT)):
            res.append(against_plain(
                1, 1000, 2, 1000, rq, QP, attention_kw(2, mode, causal, rq, QP),
                f"blockq D{d} {mode} {causal} rq={rq}", d=d))
        worst = max(worst, summary("fused_attention_hs_blockq",
                                   f"B1xN1000xH2xD{d}",
                                   "all_modes:causal_none/full:rq_off/on", res))
    # a mask too small to skip tiles; the static shift's full walk
    res = []
    for mode, causal, rq in itertools.product(ATT_MODES, ("full", "window256"),
                                              (None, OUT_REQUANT)):
        res.append(against_plain(
            1, 1000, 4, 1000, rq, QP,
            attention_kw(4, mode, causal, rq, QP, causal_mask_val=NOSKIP_MASK),
            f"blockq noskip {mode} {causal} rq={rq}"))
        if mode == "fast_shift":
            res.append(against_plain(
                1, 1000, 4, 1000, rq, QP,
                attention_kw(4, mode, causal, rq, QP,
                             score_max=DEGENERATE_SCORE_MAX),
                f"blockq full-walk {causal} rq={rq}"))
    worst = max(worst, summary("fused_attention_hs_blockq", "B1xN1000xH4",
                               "mask_-2000_no_skip+score_max_200_full_walk",
                               res))
    # the monolithic kernel's exact form at short N, N % 4 != 0 and the
    # 128-key edge (its K and V in turns from N = 1000 on), and its other
    # head dims in every form
    for n in EXACT_N:
        res = []
        for causal, rq, zp in variants:
            qp = QP if zp == "nonzero" else QP_ZERO
            res.append(against_plain(
                1, n, 3, n, rq, qp, attention_kw(3, "exact", causal, rq, qp),
                f"monolithic exact N{n} {causal} rq={rq} zp={zp}",
                fn=A.fused_attention_hs_monolithic,
                plain=A.fused_attention_hs_reference))
        summary("fused_attention_hs", f"B1xN{n}xH3xD{HEAD_DIM}",
                "exact_N:causal_none/full/window256:rq_off/on:zp", res)
    for d in (16, 32, 128):
        res = []
        for mode, causal, rq in itertools.product(ATT_MODES, ("none", "full"),
                                                  (None, OUT_REQUANT)):
            res.append(against_plain(
                2, N_TOK, 2, N_TOK, rq, QP,
                attention_kw(2, mode, causal, rq, QP),
                f"monolithic D{d} {mode} {causal} rq={rq}", d=d,
                fn=A.fused_attention_hs_monolithic,
                plain=A.fused_attention_hs_reference))
        summary("fused_attention_hs", f"B2xN{N_TOK}xH2xD{d}",
                "all_modes:causal_none/full:rq_off/on", res)
    for n in MONO_TURNS_N:
        for mode in ATT_MODES:
            assert not A.hs_plan(n, n, 128, 2, exact=mode == "exact")[
                "kv_both"], (n, mode)
        res = []
        for mode, causal, rq in itertools.product(ATT_MODES, ("none", "full"),
                                                  (None, OUT_REQUANT)):
            res.append(against_plain(
                1, n, 2, n, rq, QP, attention_kw(2, mode, causal, rq, QP),
                f"monolithic K/V in turns N{n} D128 {mode} {causal} rq={rq}",
                d=128, fn=A.fused_attention_hs_monolithic,
                plain=A.fused_attention_hs_reference))
        summary("fused_attention_hs", f"B1xN{n}xH2xD128",
                "kv_in_turns:all_modes:causal_none/full:rq_off/on", res)
    # the monolithic kernel's causal and window forms
    for n in MONO_N:
        res = []
        for mode, window, rq, zp in itertools.product(
                ATT_MODES, (None, MONO_WINDOW), (None, OUT_REQUANT),
                ("nonzero", "zero")):
            qp = QP if zp == "nonzero" else QP_ZERO
            res.append(against_plain(
                2, n, HEADS, n, rq, qp,
                attention_kw(HEADS, mode, "full", rq, qp, causal_window=window),
                f"monolithic causal N{n} {mode} window={window} rq={rq}",
                fn=A.fused_attention_hs_monolithic,
                plain=A.fused_attention_hs_reference))
        summary("fused_attention_hs", f"B2xN{n}xH{HEADS}",
                f"causal_full/window{MONO_WINDOW}:all_modes:rq:zp", res)
    # blockwise against monolithic at N = 1000 (K/V still fit one block)
    res = []
    for mode, causal, rq in itertools.product(ATT_MODES, CAUSAL,
                                              (None, OUT_REQUANT)):
        res.append(against_plain(
            1, 1000, 4, 1000, rq, QP, attention_kw(4, mode, causal, rq, QP),
            f"blockq vs monolithic {mode} {causal} rq={rq}",
            plain=A.fused_attention_hs_monolithic))
    summary("fused_attention_hs_blockq_vs_monolithic", "B1xN1000xH4",
            "all_modes:causal_none/full/window256:rq_off/on", res)
    return worst


def time_blockq(name: str) -> dict:
    """The blockwise kernel at the GPT-2 scoring shape (causal, int8 out):
    the serving form (fast, static shift) and the exact form, kernel and
    plain version, beside the bound of the visible half. Returns the
    serving form's numbers."""
    from numpy_quant_tpu_torch.kernels import attention as A
    rates = peaks(name)
    b, n, h = GPT_B, GPT_SEQ, HEADS
    q, k, v = attention_inputs(b, n, seed=99, n=n, heads=h)
    res = {}
    for label, mode in (("serving", "fast_shift"), ("exact", "exact")):
        kw = attention_kw(h, mode, "full", OUT_REQUANT, QP)
        ms = cuda_ms(lambda: A.fused_attention_hs_blockq(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: A.fused_attention_hs_blockq_reference(
            q, k, v, **kw))
        nbytes = 4 * q.numel()  # q, k, v read once; int8 out written once
        # both products over the visible (causal) half of the scores
        ops = 2 * 2 * b * h * (n * (n + 1) // 2) * HEAD_DIM
        t_bytes, t_ops = nbytes / rates["bytes"] * 1e3, ops / rates["int8"] * 1e3
        res[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations")
        say("kernel-time", kernel="fused_attention_hs_blockq", form=label,
            shape=f"B{b}xN{n}xH{h}xD{HEAD_DIM}", causal=True, ms=ms,
            plain_ms=plain_ms, bound_ms=res[label]["bound_ms"],
            bound_by=res[label]["bound_by"], bytes=nbytes, ops=ops,
            library="none", card=name.replace(" ", "_"))
    return res["serving"]


def plain_inputs(bh: int, n: int, d: int, seed: int):
    """Random int8 q [BH, N, D], kt [BH, D, N] and v [BH, N, D] on the
    card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.integers(-128, 128, size=(bh, n, d))
                                .astype(np.int8)).cuda() for _ in range(3))
    return q, k.transpose(1, 2).contiguous(), v


def check_plain() -> tuple[float, int, int]:
    """Phase 10: fused_attention against its plain version in every
    variant: zero points (all nonzero, all zero, and each of zq, zk, zv,
    zp_p alone zero), out_requant off / on / on without res_zp, mask none /
    causal / window 6 / window 512, at N = 50, 197 (byte loads of k^T,
    ragged key tiles), 1000, 1024 and 2048 (word loads), head dims 16, 32,
    64 and 128, odd BH, a mask too small to skip tiles, and the exact
    cases at EXACT_N. Returns (the largest |difference| on f32 out, flipped
    (row, head) blocks, blocks)."""
    from numpy_quant_tpu_torch.kernels import attention as A
    zps = {"nonzero": QP, "zero": QP_ZERO}
    for name in ("zq", "zk", "zv", "zp_p"):
        zps[f"{name}=0"] = dict(QP, **{name: 0})
    rqs = {"off": None, "on": OUT_REQUANT, "on_no_zp": (OUT_REQUANT[0], None)}
    masks = {"none": (None, None), "causal": (MASK_VAL, None),
             "window6": (MASK_VAL, 6), "window512": (MASK_VAL, 512)}
    worst, all_flips, all_blocks, seed = 0.0, 0, 0, 2000

    def run(bh, n, d, qp, rq, mask, window, label):
        nonlocal seed, worst, all_flips, all_blocks
        seed += 1
        q, kt, v = plain_inputs(bh, n, d, seed)
        kw = dict(qp, out_requant=rq, causal_mask_val=mask,
                  causal_window=window)
        flips, blocks, err = attention_diff(
            A.fused_attention(q, kt, v, **kw),
            A.fused_attention_reference(q, kt, v, **kw), 1, rq, qp, label)
        if rq is None:
            worst = max(worst, err)
        all_flips += flips
        all_blocks += blocks
        return flips, blocks, err if rq is None else 0.0

    def summary(shape, n, cases, res):
        flips = sum(r[0] for r in res)
        bh = int(shape.split("BH")[1].split("x")[0])
        say("kernel-check", kernel="fused_attention", shape=shape,
            cases=cases, variants=len(res),
            flipped_blocks=f"{flips}/{sum(r[1] for r in res)}",
            max_abs_err_f32_out=max(r[2] for r in res))
        # where the kernel sums rows in torch's order it equals the plain
        # version (its [BH, rows of a q tile, N] softmax) bit for bit
        tile = min(n, A.plain_tile(n))
        if all(exact_in_order(bh * t, n) for t in {tile, n % tile or tile}):
            assert flips == 0, f"{shape}: {flips} flipped blocks in torch order"

    for bh, n in ((5, 50), (5, 197), (3, 1024), (3, 2048)):
        res = [run(bh, n, HEAD_DIM, zps[z], rqs[r], *masks[m],
                   f"plain BH{bh} N{n} zp={z} rq={r} mask={m}")
               for z, r, m in itertools.product(zps, rqs, masks)]
        summary(f"BH{bh}xN{n}xD{HEAD_DIM}", n,
                "zp_6_forms:rq_off/on/on_no_zp:mask_none/causal/window6/512",
                res)
    for d, (bh, n) in itertools.product((16, 32, 128), ((7, 197), (3, 1000))):
        res = [run(bh, n, d, zps[z], rqs[r], *masks[m],
                   f"plain D{d} BH{bh} N{n} zp={z} rq={r} mask={m}")
               for z, r, m in itertools.product(("nonzero", "zero"), rqs,
                                                masks)]
        summary(f"BH{bh}xN{n}xD{d}", n, "zp_nonzero/zero:rq:mask", res)
    res = [run(3, 1024, HEAD_DIM, QP, rqs[r], NOSKIP_MASK, w,
               f"plain noskip rq={r} window={w}")
           for r, w in itertools.product(rqs, (None, 6, 512))]
    summary(f"BH3xN1024xD{HEAD_DIM}", 1024, "mask_-2000_no_skip:rq:causal/window",
            res)
    # short N, N % 4 != 0 and the 128-key edge (every row alignment)
    for n in EXACT_N:
        res = [run(3, n, HEAD_DIM, zps[z], rqs[r], *masks[m],
                   f"plain exact N{n} zp={z} rq={r} mask={m}")
               for z, r, m in itertools.product(("nonzero", "zero"),
                                                ("off", "on"),
                                                ("none", "causal", "window6"))]
        summary(f"BH3xN{n}xD{HEAD_DIM}", n, "exact_N:zp:rq_off/on:mask", res)
    return worst, all_flips, all_blocks


_PROBES: dict = {}


def exact_in_order(rows: int, n: int) -> bool:
    """True where an exact attention kernel must equal its plain version
    (and the unfused executor) bit for bit: the kernel replays torch's row
    sum order for the plain version's softmax tensor [rows, n]
    (kernels/attention.py::in_torch_order), and torch's own CUDA sum takes
    that order there, probed once per shape. A torch whose order changed
    fails the phase."""
    from numpy_quant_tpu_torch.kernels import attention as A
    if not A.in_torch_order(rows, n):
        return False
    if (rows, n) not in _PROBES:
        _PROBES[rows, n] = A.torch_sums_in_kernel_order("cuda", rows, n)
        say("torch-order", rows=rows, n=n,
            torch_sums_in_kernel_order=_PROBES[rows, n])
    assert _PROBES[rows, n], (f"torch's CUDA sum over [{rows}, {n}] no "
                              "longer takes the kernels' order")
    return True


def time_plain(name: str) -> dict:
    """fused_attention at the TinyLlama scoring shape (B=4 x 32 heads,
    N=2048, D=64, causal, int8 out): held against its plain version (no
    flip: N is in torch's order), then kernel and plain version timed
    (median of 20 CUDA-event calls) beside the bound of the visible
    half."""
    from numpy_quant_tpu_torch.kernels import attention as A
    rates = peaks(name)
    bh, n, d = LLAMA_B * 32, LLAMA_SEQ, 64
    q, kt, v = plain_inputs(bh, n, d, seed=99)
    kw = dict(QP, out_requant=OUT_REQUANT, causal_mask_val=MASK_VAL)
    flips, blocks, _ = attention_diff(
        A.fused_attention(q, kt, v, **kw),
        A.fused_attention_reference(q, kt, v, **kw), 1, OUT_REQUANT, QP,
        f"plain BH{bh} N{n} timing shape")
    say("kernel-check", kernel="fused_attention", shape=f"BH{bh}xN{n}xD{d}",
        cases="timing_shape:causal:rq_on", flipped_blocks=f"{flips}/{blocks}")
    assert not exact_in_order(bh * A.plain_tile(n), n) \
        or flips == 0, (flips, blocks)
    ms = cuda_ms(lambda: A.fused_attention(q, kt, v, **kw))
    plain_ms = cuda_ms(lambda: A.fused_attention_reference(q, kt, v, **kw))
    nbytes = 4 * q.numel()  # q, kt, v read once; int8 out written once
    ops = 2 * 2 * bh * (n * (n + 1) // 2) * d
    t_bytes, t_ops = nbytes / rates["bytes"] * 1e3, ops / rates["int8"] * 1e3
    res = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    say("kernel-time", kernel="fused_attention", form="exact",
        shape=f"BH{bh}xN{n}xD{d}", causal=True, out="int8", ms=ms,
        plain_ms=plain_ms, bound_ms=res["bound_ms"], bound_by=res["bound_by"],
        bytes=nbytes, ops=ops, library="none", card=name.replace(" ", "_"))
    return res


def scoring_phase(card: str) -> dict:
    """Phase 9: returns the launch counts of the f32 fused forward."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.models.gpt import (GPT2_SMALL, gpt_causal_lm,
                                                  random_gpt2_weights)
    t0 = time.perf_counter()
    vocab = GPT2_SMALL["vocab_size"]
    proto = gpt_causal_lm(random_gpt2_weights(GPT2_SMALL, seed=0), GPT2_SMALL,
                          batch_size=GPT_B, seq_len=GPT_SEQ)
    model = Model.from_onnx(proto)
    rng = np.random.default_rng(0)
    # token embeddings of seeded random ids: 2 calibration sequences, then
    # the scored batch
    calib = proto._wte[rng.integers(0, vocab, size=(2, GPT_SEQ))]
    embeds = torch.from_numpy(
        proto._wte[rng.integers(0, vocab, size=(GPT_B, GPT_SEQ))]).cuda()
    qmodel = model.quantize(bit_width=8,
                            stats=model.calibration_stats([calib]))
    del model
    say("scoring-setup", seconds=time.perf_counter() - t0,
        nodes=len(qmodel.nodes), device=qmodel.device)

    def forward():
        return qmodel([embeds], as_numpy=False)[0]

    torch.cuda.reset_peak_memory_stats()
    unfused = forward()
    peak_unfused = torch.cuda.max_memory_allocated()
    report = qmodel.optimize()
    fnodes = [nd for nd in qmodel.nodes if nd.op == "FusedAttentionHS"]
    say("scoring-optimize", fuse_attention=report["fuse_attention"],
        fuse_gelu=report["fuse_gelu"], int8_dataflow=report["int8_dataflow"],
        fusion_failures=len(report["fusion_failures"]),
        causal_mask_vals=",".join(f"{nd.attrs.get('causal_mask_val'):.6g}"
                                  for nd in fnodes),
        windows=sum("causal_window" in nd.attrs for nd in fnodes))
    assert report["fuse_attention"] == 12 and not report["fusion_failures"]
    assert len(fnodes) == 12 and all(
        nd.attrs.get("causal_mask_val") is not None
        and "causal_window" not in nd.attrs for nd in fnodes)
    torch.cuda.reset_peak_memory_stats()
    fused, counts = counted(forward)
    peak_fused = torch.cuda.max_memory_allocated()
    assert fused.shape == (GPT_B, GPT_SEQ, vocab), fused.shape
    assert bool(torch.isfinite(fused).all())
    # The exact blockwise kernel sums softmax rows in torch's order, so it
    # equals its plain version on every layer's operands, and the fused
    # forward equals the unfused one bit for bit.
    parity = logit_parity(fused, unfused)
    flips, blocks = attention_flips(qmodel, embeds)
    equal = bool(torch.equal(fused, unfused))
    say("scoring-f32", batch=GPT_B, seq=GPT_SEQ,
        blockq_launches=counts["fused_attention_hs_blockq"],
        monolithic_launches=counts["fused_attention_hs"],
        attention_flipped_blocks=f"{flips}/{blocks}",
        fused_equals_unfused_bitwise=equal, **parity)
    assert counts["fused_attention_hs_blockq"] == 12, counts
    assert others(counts) == 12, counts
    # the plain version's softmax runs in [B, H, BLOCK_Q, N] q tiles
    assert exact_in_order(GPT_B * HEADS * A.BLOCK_Q, GPT_SEQ)
    assert flips == 0 and equal, (flips, blocks, equal)
    del unfused

    with config.low_precision_floats():
        torch.cuda.reset_peak_memory_stats()
        bf, bf_counts = counted(forward)
        peak_bf16 = torch.cuda.max_memory_allocated()
    assert bf.shape == fused.shape and bf.dtype == torch.float32
    assert bool(torch.isfinite(bf).all())
    agree = float((bf.argmax(-1) == fused.argmax(-1)).float().mean())
    say("scoring-bf16", batch=GPT_B, seq=GPT_SEQ,
        blockq_launches=bf_counts["fused_attention_hs_blockq"],
        monolithic_launches=bf_counts["fused_attention_hs"],
        argmax_agreement_f32=agree,
        max_abs_diff_f32=float((bf - fused).abs().max()))
    assert bf_counts["fused_attention_hs_blockq"] == 12, bf_counts
    assert others(bf_counts) == 12, bf_counts
    del bf, fused

    for m, runs in forward_seconds(forward, SCORE_REPS).items():
        wall = statistics.median(runs)
        say("scoring-throughput", dtype=m, batch=GPT_B, seq=GPT_SEQ,
            tokens_per_s=GPT_B * GPT_SEQ / wall, ms_per_forward=wall * 1e3,
            ms_runs=",".join(f"{r * 1e3:.2f}" for r in runs),
            card=card.replace(" ", "_"))
    say("scoring-memory", peak_unfused_f32_bytes=peak_unfused,
        peak_fused_f32_bytes=peak_fused, peak_fused_bf16_bytes=peak_bf16)
    say("scoring-profile", **bf16_profile(forward))
    return counts


def forward_seconds(forward, reps: int) -> dict:
    """Wall seconds of ``reps`` forwards in f32 and in bf16, the modes taken
    in turns, each timed from a synchronize to a synchronize."""
    import torch
    from numpy_quant_tpu_torch import config
    modes = {"f32": contextlib.nullcontext, "bf16": config.low_precision_floats}
    seconds = {m: [] for m in modes}
    for rep in range(reps):
        for m in (list(modes) if rep % 2 == 0 else list(modes)[::-1]):
            with modes[m]():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                seconds[m].append(time.perf_counter() - t0)
    return seconds


def profiled(run, tries: int = 3):
    """One ``run()`` under the profiler (CPU and CUDA), 50 ms of host time
    on either side of it (device_rows's margins). Late in this script the
    tracer has come back with no device record at all (a TinyLlama decode
    in phase 15, on one host and not on another), so a trace that saw no
    device time is taken again, at most ``tries`` times in all. Returns
    (run's result, the last trace's key_averages(), its device ms or None
    where no try saw device time, the tries taken)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for tried in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            out = run()
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        if busy > 0:
            return out, events, busy, tried
    return out, events, None, tries


def aten_count(events) -> int:
    """aten calls among a trace's host events."""
    import torch
    return sum(e.count for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith("aten::"))


def bf16_profile(forward) -> dict:
    """One profiled bf16 forward beside one unprofiled: device busy time,
    its share of the unprofiled wall, device kernels, the device time of
    the quantize boundaries, the packed matmuls, torch's elementwise
    kernels and each attention kernel, the top five by device time. Every
    device figure is None where no trace saw device time (profiled)."""
    import torch
    from numpy_quant_tpu_torch import config
    with config.low_precision_floats():
        forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _, events, busy, tries = profiled(forward)
    if busy is None:
        return dict(dtype="bf16", wall_ms_unprofiled=wall_ms,
                    device_busy_ms=None, profile_tries=tries,
                    device_kernels=None, top5=None)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    # the quantize boundaries' kernel, and torch's own elementwise kernels
    qdq = sum(ms for k, ms, _ in rows if "qdq_kernel" in k)
    # the packed matmuls' kernel (csrc/qmatmul.cu)
    packed = sum(ms for k, ms, _ in rows if "qmatmul_kernel" in k)
    torch_ew = sum(ms for k, ms, _ in rows
                   if "elementwise_kernel" in k and "qdq_kernel" not in k)
    # the attention kernels (csrc/attention_hs.cu, attention_hs_blockq.cu,
    # attention_plain.cu)
    attention = {name: sum(ms for k, ms, _ in rows if name in k)
                 for name in ("attention_hs_kernel", "blockq_kernel",
                              "plain_kernel")}
    return dict(dtype="bf16", wall_ms_unprofiled=wall_ms, device_busy_ms=busy,
                profile_tries=tries, busy_share=busy / wall_ms,
                device_kernels=int(sum(r[2] for r in rows)),
                qdq_kernel_ms=qdq, qdq_share_of_busy=qdq / busy,
                packed_kernel_ms=packed, packed_share_of_busy=packed / busy,
                **{f"{name}_ms": ms for name, ms in attention.items()},
                torch_elementwise_ms=torch_ew,
                torch_elementwise_share_of_busy=torch_ew / busy,
                top5=";".join(f"{k[:48].replace(' ', '_')}:{ms:.3f}ms:x{c}"
                              for k, ms, c in rows[:5]))


def logit_parity(got, want) -> dict:
    """Fused against unfused logits: max |difference|, max |logit| and the
    argmax agreement overall and where the unfused top-1 margin clears
    LOGIT_TOL * max|logit|. Raises unless the difference stays within that
    and the argmax is equal wherever the margin clears it."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > LOGIT_TOL * scale
    same = got.argmax(-1) == want.argmax(-1)
    res = dict(max_abs_diff=diff, max_abs_logit=scale,
               argmax_equal=f"{int(same.sum())}/{same.numel()}",
               argmax_equal_clear_margin=f"{int(same[clear].sum())}/"
                                         f"{int(clear.sum())}")
    assert diff <= LOGIT_TOL * scale, (diff, scale)
    assert bool(same[clear].all()), "fused and unfused argmax differ"
    return res


def llama_phase(card: str, weights) -> dict:
    """Phase 11: TinyLlama-1.1B int8 scoring at full width and depth on
    ``weights`` (random, seed 0; shared with phase 15). Returns the launch
    counts of the f32 fused forward at B=4."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.models.llama import llama_causal_lm
    cfg, n = tinyllama(), LLAMA_SEQ
    layers, vocab = cfg["num_hidden_layers"], cfg["vocab_size"]
    t0 = time.perf_counter()
    proto = llama_causal_lm(weights, cfg, batch_size=LLAMA_B, seq_len=n)
    model = Model.from_onnx(proto)
    wte = proto._wte
    del proto
    rng = np.random.default_rng(0)
    # token embeddings of seeded random ids: 2 calibration sequences, then
    # the scored batch
    calib = wte[rng.integers(0, vocab, size=(2, n))]
    embeds = torch.from_numpy(
        wte[rng.integers(0, vocab, size=(LLAMA_B, n))]).cuda()
    t_build = time.perf_counter() - t0
    qmodel = model.quantize(bit_width=8,
                            stats=model.calibration_stats([calib]))
    del model, calib
    say("llama-setup", seconds=time.perf_counter() - t0,
        build_seconds=t_build, nodes=len(qmodel.nodes), device=qmodel.device)

    def forward(x=embeds):
        return qmodel([x], as_numpy=False)[0]

    one = embeds[:1]
    torch.cuda.reset_peak_memory_stats()
    unfused = forward(one)
    peak_unfused = torch.cuda.max_memory_allocated()
    # the unfused walk in the bf16 serving mode: a second witness for that
    # mode's distance from f32, with no fused op in it
    with config.low_precision_floats():
        unfused_bf = forward(one)
    report = qmodel.optimize()
    plain = qmodel.fusion_report.get("plain_fusions", [])
    fnodes = [nd for nd in qmodel.nodes if nd.op == "FusedAttention"]
    hs = [nd for nd in qmodel.nodes if nd.op == "FusedAttentionHS"]
    say("llama-optimize", fuse_attention=report["fuse_attention"],
        fused_attention_nodes=len(fnodes), hs_nodes=len(hs),
        plain_fusions=len(plain), int8_dataflow=report["int8_dataflow"],
        fusion_failures=len(report["fusion_failures"]),
        out_requant=sum(nd.attrs.get("out_requant") is not None
                        for nd in fnodes),
        causal_mask_vals=",".join(f"{nd.attrs.get('causal_mask_val'):.6g}"
                                  for nd in fnodes[:3]) + ",...")
    assert report["fuse_attention"] == layers and not report["fusion_failures"]
    assert len(fnodes) == layers and not hs and len(plain) == layers
    assert all(nd.attrs.get("causal_mask_val") is not None
               and "causal_window" not in nd.attrs for nd in fnodes)

    fused_one, counts_one = counted(lambda: forward(one))
    assert fused_one.shape == (1, n, vocab) and bool(fused_one.isfinite().all())
    skips = []
    flips, blocks = attention_flips(qmodel, one, skips)
    say("llama-f32-b1", batch=1, seq=n,
        fused_attention_launches=counts_one["fused_attention"],
        masked_tiles_skipped=f"{sum(skips)}/{len(skips)}",
        attention_flipped_blocks=f"{flips}/{blocks}",
        fused_equals_unfused_bitwise=bool(torch.equal(fused_one, unfused)),
        **logit_parity(fused_one, unfused))
    assert counts_one["fused_attention"] == layers, counts_one
    assert others(counts_one) == layers, counts_one
    assert flips <= 0.01 * blocks, (flips, blocks)

    # bf16 at B=1: the kernel is exact in both modes, so it must equal its
    # plain version on the bf16 walk's operands too. The unfused bf16 walk
    # takes its softmax in bf16, so it need not equal the fused one; how
    # far each bf16 walk lands from its f32 walk is printed side by side.
    with config.low_precision_floats():
        fused_bf, counts_bf1 = counted(lambda: forward(one))
        flips_bf, blocks_bf = attention_flips(qmodel, one)
    assert bool(fused_bf.isfinite().all()) and bool(unfused_bf.isfinite().all())

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())
    say("llama-bf16-b1", batch=1, seq=n,
        fused_attention_launches=counts_bf1["fused_attention"],
        attention_flipped_blocks=f"{flips_bf}/{blocks_bf}",
        fused_equals_unfused_bitwise=bool(torch.equal(fused_bf, unfused_bf)),
        fused_vs_unfused_max_abs_diff=float((fused_bf - unfused_bf).abs().max()),
        fused_vs_unfused_argmax=agree(fused_bf, unfused_bf),
        fused_vs_f32_argmax=agree(fused_bf, fused_one),
        unfused_vs_f32_argmax=agree(unfused_bf, unfused),
        fused_vs_f32_max_abs_diff=float((fused_bf - fused_one).abs().max()),
        unfused_vs_f32_max_abs_diff=float((unfused_bf - unfused).abs().max()))
    assert counts_bf1["fused_attention"] == layers, counts_bf1
    assert others(counts_bf1) == layers, counts_bf1
    assert not exact_in_order(cfg["num_attention_heads"] * A.plain_tile(n),
                              n) or flips_bf == 0, (flips_bf, blocks_bf)
    del unfused, unfused_bf, fused_bf

    # the main path: the fused f32 forward at B=4
    torch.cuda.reset_peak_memory_stats()
    fused, counts = counted(forward)
    peak_fused = torch.cuda.max_memory_allocated()
    assert fused.shape == (LLAMA_B, n, vocab) and bool(fused.isfinite().all())
    # the graph built for B=4 serves B=1 alike (every reshape copies the
    # batch dim; the RoPE tables and the mask broadcast over it)
    b1 = logit_parity(fused[:1], fused_one)
    say("llama-f32-b4", batch=LLAMA_B, seq=n,
        fused_attention_launches=counts["fused_attention"],
        other_kernel_launches=others(counts) - counts["fused_attention"],
        row0_equals_b1_bitwise=bool(torch.equal(fused[:1], fused_one)),
        row0_vs_b1_max_abs_diff=b1["max_abs_diff"],
        row0_vs_b1_argmax=b1["argmax_equal"])
    assert counts["fused_attention"] == layers, counts
    assert others(counts) == layers, counts
    del fused_one

    with config.low_precision_floats():
        bf, bf_counts = counted(forward)
    assert bf.shape == fused.shape and bf.dtype == torch.float32
    assert bool(bf.isfinite().all())
    say("llama-bf16-b4", batch=LLAMA_B, seq=n,
        fused_attention_launches=bf_counts["fused_attention"],
        argmax_agreement_f32=float((bf.argmax(-1) == fused.argmax(-1))
                                   .float().mean()),
        max_abs_diff_f32=float((bf - fused).abs().max()))
    assert bf_counts["fused_attention"] == layers, bf_counts
    assert others(bf_counts) == layers, bf_counts
    del bf, fused

    for m, runs in forward_seconds(forward, SCORE_REPS).items():
        wall = statistics.median(runs)
        say("llama-throughput", dtype=m, batch=LLAMA_B, seq=n,
            tokens_per_s=LLAMA_B * n / wall, ms_per_forward=wall * 1e3,
            ms_runs=",".join(f"{r * 1e3:.2f}" for r in runs),
            card=card.replace(" ", "_"))
    say("llama-memory", peak_unfused_f32_b1_bytes=peak_unfused,
        peak_fused_f32_b4_bytes=peak_fused)
    say("llama-profile", batch=LLAMA_B, **bf16_profile(forward))
    return counts


def sb_operand(form: str, heads: int, n: int, seed: int):
    """A graph-shaped score-bias constant as the registry hands it to the
    kernels (ops/registry.py::score_bias_operand, broadcast to [H, N, N]
    float32 on the card): "per_head" [1, H, N, N] (T5's relative bias),
    "shared" [1, 1, N, N], or "decoder" [1, H, N, N] plus MASK_VAL above
    the diagonal (T5's combined constant)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.ops.registry import score_bias_operand
    from numpy_quant_tpu_torch.tensor import FTensor
    rng = np.random.default_rng(seed)
    shape = (1, 1, n, n) if form == "shared" else (1, heads, n, n)
    bias = rng.standard_normal(shape, dtype=np.float32) * np.float32(2.0)
    if form == "decoder":
        bias += np.triu(np.full((n, n), MASK_VAL, np.float32), k=1)
    return score_bias_operand(FTensor(torch.from_numpy(bias).cuda()), heads,
                              n, n)


def check_score_bias() -> dict:
    """Phase 12: the score-bias forms of both head-split kernels against
    their plain versions: monolithic and blockwise x exact, fast and fast
    with the static shift x the three bias forms x out_requant off and on
    x zero points nonzero and zero, at H=8, D=64 and N = SB_N (and D = 32,
    128 at N = SB_D_N). The exact forms must show no flipped (row, head)
    block, the fast ones the one-step rule. Then the bias clause of the
    dispatch on the card (N=256 monolithic, 257 blockwise) and narrow q
    with a bias refused. Returns the largest |difference| on f32 out per
    kernel and the variants checked."""
    from numpy_quant_tpu_torch.kernels import attention as A
    kernels = {
        "fused_attention_hs": (A.fused_attention_hs_monolithic,
                               A.fused_attention_hs_reference, False),
        "fused_attention_hs_blockq": (A.fused_attention_hs_blockq,
                                      A.fused_attention_hs_blockq_reference,
                                      True)}
    worst = dict.fromkeys(kernels, 0.0)
    variants = 0
    sizes = [(n, HEAD_DIM) for n in SB_N] + [(SB_D_N, d) for d in (16, 32,
                                                                  128)]
    for n, d in sizes:
        biases = {f: sb_operand(f, SB_HEADS, n, seed=n + i)
                  for i, f in enumerate(SB_FORMS)}
        q, k, v = attention_inputs(SB_B, n, seed=n + d, n=n, heads=SB_HEADS,
                                   d=d)
        for (kname, (fn, plain, tiled)), mode in itertools.product(
                kernels.items(), ATT_MODES):
            flips = blocks = 0
            err = 0.0
            cases = list(itertools.product(SB_FORMS, (None, OUT_REQUANT),
                                           ("nonzero", "zero")))
            for form, rq, zp in cases:
                qp = QP if zp == "nonzero" else QP_ZERO
                kw = attention_kw(SB_HEADS, mode, "none", rq, qp,
                                  score_bias=biases[form])
                f, bl, e = attention_diff(
                    fn(q, k, v, **kw), plain(q, k, v, **kw), SB_HEADS, rq, qp,
                    f"score bias {kname} N{n} D{d} {mode} {form} rq={rq} "
                    f"zp={zp}")
                flips, blocks = flips + f, blocks + bl
                if rq is None:
                    err = max(err, e)
            variants += len(cases)
            say("kernel-check", kernel=kname, form="score_bias", mode=mode,
                shape=f"B{SB_B}xN{n}xH{SB_HEADS}xD{d}",
                cases="per_head/shared/decoder:rq_off/on:zp_nonzero/zero",
                variants=len(cases), flipped_blocks=f"{flips}/{blocks}",
                max_abs_err_f32_out=err)
            if mode == "exact":
                # the plain version's softmax: [B, H, rows of a q tile, N]
                rows = SB_B * SB_HEADS * (min(n, A.BLOCK_Q) if tiled else n)
                assert exact_in_order(rows, n) and flips == 0, \
                    (kname, n, d, flips, blocks)
            worst[kname] = max(worst[kname], err)
    # the bias clause: at H=8 a [8, 256, 256] bias is exactly 2 MiB
    # (monolithic), N=257 pads to 264 x 384 (blockwise); both against plain
    for n, want in ((256, "fused_attention_hs"),
                    (257, "fused_attention_hs_blockq")):
        q, k, v = attention_inputs(1, n, seed=n, n=n, heads=SB_HEADS)
        kw = attention_kw(SB_HEADS, "exact", "none", None, QP,
                          score_bias=sb_operand("per_head", SB_HEADS, n, n))
        out, counts = counted(lambda: A.fused_attention_hs(q, k, v, **kw))
        flips, blocks, _ = attention_diff(out, kernels[want][1](q, k, v, **kw),
                                          SB_HEADS, None, QP,
                                          f"bias clause N{n}")
        say("kernel-check", kernel=want, form="score_bias_dispatch",
            shape=f"B1xN{n}xH{SB_HEADS}", launches=counts[want],
            flipped_blocks=f"{flips}/{blocks}")
        assert counts[want] == 1 and others(counts) == 1, counts
        try:
            A.fused_attention_hs(q[:, :1].contiguous(), k, v, **kw)
        except ValueError:
            pass
        else:
            raise AssertionError("narrow q with a score bias was not refused")
    say("kernel-check", form="score_bias_narrow_q", refused=True)
    return dict(worst=worst, variants=variants)


def time_score_bias(name: str) -> dict:
    """Phase 12's timing: the head-split forms at t5-small's three
    attention shapes (B=8, H=8, D=64, int8 out) as the path dispatches them
    -- encoder self-attention (N=512, per-head bias, blockwise), decoder
    self-attention (N=128, the combined constant, monolithic) and
    cross-attention (128 query rows against N=512 keys, no bias, unscaled,
    monolithic) -- each in the exact, fast and static-shift forms: median
    of 20 CUDA-event calls, each queued behind a device sleep so that the
    device time is measured, not the host's wrapper; the plain version and
    the bound. The exact and
    fast forms are first held against the plain version (no flip on the
    exact one). Returns {kernel: {shape: {form: numbers}}}."""
    from numpy_quant_tpu_torch.kernels import attention as A
    rates = peaks(name)
    shapes = (("encoder_self", T5_SRC, T5_SRC, "per_head"),
              ("decoder_self", T5_TGT, T5_TGT, "decoder"),
              ("cross", T5_TGT, T5_SRC, None))
    res: dict = {}
    for label, nq, n, form in shapes:
        q, k, v = attention_inputs(T5_B, nq, seed=nq + n, n=n, heads=SB_HEADS)
        bias = None if form is None else sb_operand(form, SB_HEADS, n, seed=n)
        blockq = A.blockwise(n, None, nq=nq,
                             bias_heads=None if bias is None else SB_HEADS)
        kname = "fused_attention_hs_blockq" if blockq else "fused_attention_hs"
        plain = A.fused_attention_hs_blockq_reference if blockq \
            else A.fused_attention_hs_reference
        # q, k, v and the f32 bias read once, the int8 output written once
        nbytes = 2 * q.numel() + k.numel() + v.numel() \
            + (0 if bias is None else 4 * bias.numel())
        # both products; the decoder's constant hides the upper triangle,
        # whose probabilities are exactly zp_p and whose scores are unused
        pairs = nq * (nq + 1) // 2 if form == "decoder" else nq * n
        ops = 2 * 2 * T5_B * SB_HEADS * pairs * HEAD_DIM
        t_bytes, t_ops = nbytes / rates["bytes"] * 1e3, ops / rates["int8"] * 1e3
        for mode in ATT_MODES:
            kw = attention_kw(SB_HEADS, mode, "none", OUT_REQUANT, QP,
                              score_bias=bias)
            if form is None:
                kw["scaling"] = 1.0  # T5 attention is unscaled
            if mode != "fast_shift":
                flips, blocks, _ = attention_diff(
                    A.fused_attention_hs(q, k, v, **kw), plain(q, k, v, **kw),
                    SB_HEADS, OUT_REQUANT, QP, f"t5 {label} {mode}")
                if mode == "exact":
                    rows = T5_B * SB_HEADS * (min(nq, A.BLOCK_Q) if blockq
                                              else nq)
                    assert exact_in_order(rows, n) and flips == 0, \
                        (label, flips, blocks)
            ms = cuda_ms(lambda: A.fused_attention_hs(q, k, v, **kw),
                         lead=True)
            plain_ms = cuda_ms(lambda: plain(q, k, v, **kw), lead=True)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            res.setdefault(kname, {}).setdefault(label, {})[mode] = row
            say("kernel-time", kernel=kname, form=f"score_bias_{mode}",
                t5=label, bias=form or "none",
                shape=f"B{T5_B}xNq{nq}xN{n}xH{SB_HEADS}xD{HEAD_DIM}",
                out="int8", ms=ms, plain_ms=plain_ms, bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], bytes=nbytes, ops=ops,
                library="none", card=name.replace(" ", "_"))
    return res


def requantize_differences(qmodel, x, cfg: dict) -> tuple[int, int]:
    """One recorded unfused forward of the T5 QModel: the q, k and v
    operand entries of every attention chain (the unfused executor's: the
    projection accumulator dequantized at the head split, quantized at the
    score or context MatMul, x / scale) that the reference's requantize of
    the accumulator (x * (1 / scale)) would round otherwise -- why a fused
    node narrows its accumulator operands the unfused way
    (model.py::QModel._narrow). Returns (differing entries, entries)."""
    from numpy_quant_tpu_torch.graph import Variable
    from numpy_quant_tpu_torch.tensor import quantize_tensor
    qmodel(x, record=True, as_numpy=False)
    rec = {v.name: v.data for v in qmodel.values if v.data is not None}
    pres = [f"encoder.block.{i}.attn" for i in range(cfg["num_layers"])]
    pres += [f"decoder.block.{i}.{kind}" for i in range(cfg["num_decoder_layers"])
             for kind in ("self", "cross")]
    differ = entries = 0
    for pre, (val, proj) in itertools.product(
            pres, (("q_Transpose", "q"), ("k_T", "k"), ("v_Transpose", "v"))):
        qp = qmodel.quant_params[f"{pre}/{val}"]
        t = quantize_tensor(rec[f"{pre}/{val}"], qmodel.bit_width, qp.scale,
                            qp.zero_point).data
        t = t.transpose(-1, -2) if val == "k_T" else t
        acc = rec[f"{pre}.{proj}/MatMul_out"]
        pp = qmodel.quant_params[f"{pre}.{proj}/MatMul_out"]
        req = acc.requantize(qmodel.bit_width, pp.scale, pp.zero_point).data
        b, n, hd = req.shape  # [B, N, H*D] -> [B, H, N, D]
        req = req.reshape(b, n, t.shape[1], -1).permute(0, 2, 1, 3)
        differ += int((req != t).sum())
        entries += t.numel()
    del rec
    for v in qmodel.values:
        if isinstance(v, Variable):
            v.data = None
    return differ, entries


def t5_phase(card: str) -> tuple[dict, dict]:
    """Phase 13: t5-small int8 teacher-forced scoring at full width and
    depth. Returns the launch counts of the f32 fused forward and the host
    cost of its quantize boundaries (``boundary_cost``)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.models.t5 import (T5_SMALL, random_t5_weights,
                                                 t5_conditional_generation)
    cfg = T5_SMALL
    vocab = cfg["vocab_size"]
    enc, dec = cfg["num_layers"], cfg["num_decoder_layers"]
    n_att = enc + 2 * dec
    t0 = time.perf_counter()
    proto = t5_conditional_generation(random_t5_weights(cfg, seed=0), cfg,
                                      batch_size=T5_B, src_len=T5_SRC,
                                      tgt_len=T5_TGT)
    model = Model.from_onnx(proto)
    wte = proto._wte
    del proto
    rng = np.random.default_rng(0)
    # token embeddings of seeded random ids through `shared`: 2 calibration
    # (source, target) pairs, then the scored batch
    calib = [wte[rng.integers(0, vocab, size=(2, n))] for n in (T5_SRC, T5_TGT)]
    x = [torch.from_numpy(wte[rng.integers(0, vocab, size=(T5_B, n))]).cuda()
         for n in (T5_SRC, T5_TGT)]
    t_build = time.perf_counter() - t0
    qmodel = model.quantize(bit_width=8, stats=model.calibration_stats(calib))
    del model, calib
    say("t5-setup", seconds=time.perf_counter() - t0, build_seconds=t_build,
        nodes=len(qmodel.nodes), device=qmodel.device)

    def forward():
        return qmodel(x, as_numpy=False)[0]

    torch.cuda.reset_peak_memory_stats()
    unfused = forward()
    peak_unfused = torch.cuda.max_memory_allocated()
    op_differ, op_entries = requantize_differences(qmodel, x, cfg)
    report = qmodel.optimize()
    plain = qmodel.fusion_report.get("plain_fusions", [])
    fnodes = [nd for nd in qmodel.nodes if nd.op == "FusedAttentionHS"]
    biased = sum(len(nd.inputs) == 4 for nd in fnodes)
    say("t5-optimize", fuse_attention=report["fuse_attention"],
        hs_nodes=len(fnodes), with_score_bias=biased, plain_fusions=len(plain),
        int8_dataflow=report["int8_dataflow"],
        fusion_failures=len(report["fusion_failures"]),
        out_requant=sum(nd.attrs.get("out_requant") is not None
                        for nd in fnodes),
        score_max=sum(nd.attrs.get("score_max") is not None for nd in fnodes),
        unscaled=sum(nd.attrs.get("scaling") == 1.0 for nd in fnodes))
    assert report["fuse_attention"] == n_att and len(fnodes) == n_att
    assert biased == enc + dec and not plain and not report["fusion_failures"]

    torch.cuda.reset_peak_memory_stats()
    fused, counts = counted(forward)
    peak_fused = torch.cuda.max_memory_allocated()
    assert fused.shape == (T5_B, T5_TGT, vocab), fused.shape
    assert bool(fused.isfinite().all())
    # every exact kernel call sums its rows in torch's order, so it equals
    # its plain version on the path's operands, and the fused forward
    # equals the unfused one bit for bit
    heads = cfg["num_heads"]
    for rows, n in ((T5_B * heads * A.BLOCK_Q, T5_SRC),
                    (T5_B * heads * T5_TGT, T5_TGT),
                    (T5_B * heads * T5_TGT, T5_SRC)):
        assert exact_in_order(rows, n), (rows, n)
    flips, blocks = attention_flips(qmodel, x)
    equal = bool(torch.equal(fused, unfused))
    say("t5-f32", batch=T5_B, src=T5_SRC, tgt=T5_TGT,
        blockq_launches=counts["fused_attention_hs_blockq"],
        monolithic_launches=counts["fused_attention_hs"],
        attention_flipped_blocks=f"{flips}/{blocks}",
        operand_entries_requantize_would_change=f"{op_differ}/{op_entries}",
        fused_equals_unfused_bitwise=equal, **logit_parity(fused, unfused))
    assert counts["fused_attention_hs_blockq"] == enc, counts
    assert counts["fused_attention_hs"] == 2 * dec, counts
    assert others(counts) == n_att, counts
    assert flips == 0 and equal, (flips, blocks, equal)
    del unfused

    with config.low_precision_floats():
        torch.cuda.reset_peak_memory_stats()
        bf, bf_counts = counted(forward)
        peak_bf16 = torch.cuda.max_memory_allocated()
    assert bf.shape == fused.shape and bf.dtype == torch.float32
    assert bool(bf.isfinite().all())
    say("t5-bf16", batch=T5_B, src=T5_SRC, tgt=T5_TGT,
        blockq_launches=bf_counts["fused_attention_hs_blockq"],
        monolithic_launches=bf_counts["fused_attention_hs"],
        argmax_agreement_f32=float((bf.argmax(-1) == fused.argmax(-1))
                                   .float().mean()),
        max_abs_diff_f32=float((bf - fused).abs().max()),
        max_abs_logit_f32=float(fused.abs().max()))
    assert bf_counts["fused_attention_hs_blockq"] == enc, bf_counts
    assert bf_counts["fused_attention_hs"] == 2 * dec, bf_counts
    assert others(bf_counts) == n_att, bf_counts
    del bf, fused

    for m, runs in forward_seconds(forward, SCORE_REPS).items():
        wall = statistics.median(runs)
        say("t5-throughput", dtype=m, batch=T5_B, src=T5_SRC, tgt=T5_TGT,
            target_tokens_per_s=T5_B * T5_TGT / wall,
            source_tokens_per_s=T5_B * T5_SRC / wall,
            ms_per_forward=wall * 1e3,
            ms_runs=",".join(f"{r * 1e3:.2f}" for r in runs),
            card=card.replace(" ", "_"))
    say("t5-memory", peak_unfused_f32_bytes=peak_unfused,
        peak_fused_f32_bytes=peak_fused, peak_fused_bf16_bytes=peak_bf16)
    say("t5-profile", **bf16_profile(forward))
    cost = boundary_cost(forward)
    say("t5-boundaries", **cost)
    # phase 18 (c): the scoring forward captured
    for dtype in ("f32", "bf16"):
        with config.low_precision_floats() if dtype == "bf16" \
                else contextlib.nullcontext():
            captured_forward("t5_int8", card, qmodel, x, T5_B * T5_TGT,
                             "target_tokens", dtype=dtype, batch=T5_B,
                             src=T5_SRC, tgt=T5_TGT)
    return counts, cost


@contextlib.contextmanager
def plain_chain():
    """Swap the torch chains (the kernels' plain versions) in for the
    elementwise kernels at every quantize boundary: the module functions
    quantization.quantize/dequantize/fake_quantize call. The forwards
    inside walk eagerly (a captured graph would replay the kernels)."""
    from numpy_quant_tpu_torch import config
    from numpy_quant_tpu_torch.kernels import elementwise as E
    saved = E.quantize, E.dequantize, E.fake_quantize
    E.quantize, E.dequantize, E.fake_quantize = (
        E.quantize_reference, E.dequantize_reference,
        E.fake_quantize_reference)
    try:
        with config.eager_forward():
            yield
    finally:
        E.quantize, E.dequantize, E.fake_quantize = saved


def ew_layout(x, layout: str):
    """``x`` (2-D, on the card) in one of the layouts the executor hands
    the kernels: contiguous, contiguous from an odd element (no vector
    access), transposed (dense, another dim order), strided (not dense:
    copied first) or dense rows with a row stride (read in place, as
    DecodeAttention's probs[..., :L])."""
    import torch
    if layout == "rows":
        wide = torch.zeros(x.shape[0], x.shape[1] + 3, dtype=x.dtype,
                           device=x.device)
        wide[:, :x.shape[1]] = x
        return wide[:, :x.shape[1]]
    if layout == "offset":
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)
    if layout == "transposed":
        return x.t().contiguous().t()
    if layout == "strided":
        big = torch.zeros(x.shape[0], 2 * x.shape[1], dtype=x.dtype,
                          device=x.device)
        big[:, ::2] = x
        return big[:, ::2]
    return x


def ew_floats(bits: int, scale: float, rng):
    """f32 [37, 29]: values across the grid and past the clip, exact ties
    (k + 1/2) * scale, zeros of both signs, infinities and NaN."""
    import numpy as np
    n = EW_SHAPE[0] * EW_SHAPE[1]
    top = 2.0 ** (bits - 1)
    x = rng.uniform(-1.3, 1.3, size=n) * top * scale
    kmax = int(min(top, 2 ** 20))
    k = rng.integers(-kmax, kmax, size=n // 8, endpoint=True)
    x[:k.size] = (k + 0.5) * scale
    specials = [0.0, -0.0, np.inf, -np.inf, np.nan, 8 * top * scale,
                -8 * top * scale, (top - 1) * scale, -top * scale]
    x[-len(specials):] = specials
    return x.astype(np.float32).reshape(EW_SHAPE)


def ew_report(kname: str, label: str, got, want, state: dict) -> None:
    """Hold one kernel output against the plain version's, bit for bit."""
    import torch
    state["variants"][kname] += 1
    a, b = got, want
    if got.dtype.is_floating_point:  # compare the bits
        view = torch.int32 if got.dtype == torch.float32 else torch.int16
        a, b = got.view(view), want.view(view)
    diff = (got.double() - want.double()).abs()
    diff = diff[torch.isfinite(diff)]
    err = float(diff.max()) if diff.numel() else 0.0
    state["worst"][kname] = max(state["worst"][kname], err)
    if got.stride() != want.stride():
        state["stride_differs"] += 1
    if not torch.equal(a, b):
        state["mismatches"] += 1
        if state["first"] is None:
            idx = tuple((a != b).nonzero()[0].tolist())
            state["first"] = (f"{kname}:{label}:at{list(idx)}:got="
                              f"{got[idx].item()}:want={want[idx].item()}")


def check_elementwise() -> dict:
    """Phase 14(a): both kernels against their plain versions on the card,
    in every form; 0 mismatches required."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.kernels import elementwise as E
    state = {"variants": {k: 0 for k in ELEMENTWISE},
             "worst": {k: 0.0 for k in ELEMENTWISE}, "mismatches": 0,
             "stride_differs": 0, "first": None}
    rng = np.random.default_rng(14)
    rows, cols = EW_SHAPE
    for bits in EW_WIDTHS:
        # a power-of-two scale keeps (k + 1/2) * scale an exact tie; the
        # per-channel scales are not
        scale = np.float32(2.0 ** -(max(bits, 8) - 2))
        channel = (scale * rng.uniform(0.5, 2.0, size=(1, cols))).astype(
            np.float32)
        zp_scalar = np.int64(3 - 2 ** (bits - 2)) if bits >= 2 else np.int64(0)
        span = 2 ** (min(bits, 20) - 1)
        x32 = torch.from_numpy(ew_floats(bits, float(scale), rng)).cuda()
        outs = ([torch.int8] if bits <= 8 else []) + [torch.int32,
                                                      torch.int64]
        for in_dtype, out, zp_kind, per_channel, layout in itertools.product(
                (torch.float32, torch.bfloat16), outs,
                ("none", "scalar", "tensor"), (False, True), EW_LAYOUTS):
            zp = {"none": None, "scalar": zp_scalar,
                  "tensor": torch.from_numpy(rng.integers(
                      -span, span, size=(rows, 1))).to(
                      torch.int64 if out == torch.int64 else torch.int32)
                  .cuda()}[zp_kind]
            s = channel if per_channel else scale
            x = ew_layout(x32.to(in_dtype), layout)
            label = (f"b{bits}:{str(in_dtype)[6:]}->{str(out)[6:]}:zp_"
                     f"{zp_kind}:{'channel' if per_channel else 'scalar'}:"
                     f"{layout}")
            ew_report("quantize", label, E.quantize(x, bits, s, zp, out),
                      E.quantize_reference(x, bits, s, zp, out), state)
            if out != torch.int32 or bits <= 32:  # the container holds it
                ew_report("fake_quantize", label,
                          E.fake_quantize(x, bits, s, zp, out),
                          E.fake_quantize_reference(x, bits, s, zp, out),
                          state)
    # a zero scale: 0/0 -> 0, x/0 -> the clip bounds
    for bits, out, zp in itertools.product((8, 16, 32), (torch.int32,
                                                         torch.int64),
                                           (None, np.int64(5))):
        x = torch.from_numpy(ew_floats(bits, 0.01, rng)).cuda()
        for s in (np.float32(0.0), np.array([[0.0] + [0.01] * (cols - 1)],
                                            np.float32)):
            ew_report("quantize", f"zero_scale:b{bits}:{out}:{zp}",
                      E.quantize(x, bits, s, zp, out),
                      E.quantize_reference(x, bits, s, zp, out), state)
            ew_report("fake_quantize", f"zero_scale:b{bits}:{out}:{zp}",
                      E.fake_quantize(x, bits, s, zp, out),
                      E.fake_quantize_reference(x, bits, s, zp, out), state)
    # dequantize: int8, int32 (8-bit values, 32-bit accumulators with
    # wrapping corrections) and int64 (x64-mode accumulators past 2^24)
    sources = {
        torch.int8: rng.integers(-128, 128, size=EW_SHAPE),
        torch.int32: np.concatenate([
            rng.integers(-2 ** 31, 2 ** 31, size=rows * cols - 2),
            [-2 ** 31, 2 ** 31 - 1]]).reshape(EW_SHAPE),
        torch.int64: np.concatenate([
            rng.integers(-2 ** 62, 2 ** 62, size=rows * cols - 4),
            [-2 ** 63, 2 ** 63 - 1, 2 ** 24 + 1, -(2 ** 40) - 3]]
        ).reshape(EW_SHAPE)}
    # a float32 scalar, a Python float (f64: the int64 form multiplies by
    # it unrounded) and a per-channel row
    scales = {"scalar": np.float32(0.0137), "f64_scalar": 0.0137,
              "channel": rng.uniform(1e-4, 0.1, size=(1, cols)).astype(
                  np.float32)}
    for in_dtype, q_np in sources.items():
        q32 = torch.from_numpy(q_np).to(in_dtype).cuda()
        zdt = torch.int64 if in_dtype == torch.int64 else torch.int32
        big = 2 ** 62 if in_dtype == torch.int64 else 2 ** 31
        zps = {"none": None, "scalar": np.int64(-3),
               "rows": rng.integers(-big, big, size=(rows, 1)),
               "cols": rng.integers(-big, big, size=(1, cols)),
               "full": rng.integers(-big, big, size=EW_SHAPE),
               "int64_cols": rng.integers(-2 ** 40, 2 ** 40, size=(1, cols))}
        for (zp_kind, zp_np), (s_kind, s), out, layout in itertools.product(
                zps.items(), scales.items(), (torch.float32, torch.bfloat16),
                EW_LAYOUTS):
            zp = zp_np if zp_np is None or np.ndim(zp_np) == 0 else \
                torch.from_numpy(np.asarray(zp_np)).to(
                    torch.int64 if zp_kind == "int64_cols" else zdt).cuda()
            q = ew_layout(q32, layout)
            label = (f"{str(in_dtype)[6:]}->{str(out)[6:]}:zp_{zp_kind}:"
                     f"{s_kind}:{layout}")
            ew_report("dequantize", label, E.dequantize(q, s, zp, out),
                      E.dequantize_reference(q, s, zp, out), state)
    forms = ew_plan_forms(state, rng)
    torch.cuda.synchronize()
    say("kernel-check", kernel="quantize,dequantize,fake_quantize",
        **{f"variants_{k}": state["variants"][k] for k in ELEMENTWISE},
        mismatches=state["mismatches"], first_mismatch=state["first"],
        layouts_with_other_strides=state["stride_differs"],
        plan_forms=",".join(sorted(forms)),
        **{f"max_abs_err_{k}": state["worst"][k] for k in ELEMENTWISE})
    assert state["mismatches"] == 0, state["first"]
    assert forms == {"scalar", "scalar_narrow", "inner", "outer", "full",
                     "general"}, forms
    return state


def ew_plan_layouts(rng):
    """(label, x, operand) on the card in the layouts the executor hands
    the kernels at 4-D and 3-D, each broadcast operand in one of the
    plan's forms: a conv's NHWC accumulator with [1, C, 1, 1] column sums
    or its own full walk, [B, H, N, D] heads over [B, N, H, D] memory with
    permuted [B, H, N, 1] row sums (a three-digit row walk) or another
    dim order (general), DecodeAttention's dense rows probs[..., :L] with
    [B, H, 1, 1] row values, a transposed accumulator; scalar operands
    on a small tensor and on dense rows (the narrow vectors) and on one
    that fills the card (the wide ones)."""
    import torch

    def ints(*shape):
        return torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, size=shape)
                                ).to(torch.int32).cuda()

    conv = ints(4, 9, 11, 40).permute(0, 3, 1, 2)
    heads = ints(3, 33, 5, 24).permute(0, 2, 1, 3)
    rows = ints(3, 5, 1, 130)[..., :129]
    acc = ints(37, 29)
    return [("conv_colsum", conv, ints(1, 40, 1, 1)),
            ("conv_full", conv, ints(4, 9, 11, 40).permute(0, 3, 1, 2)),
            ("heads_rowsum", heads, ints(3, 5, 33, 1)),
            ("heads_general", heads,
             ints(3, 5, 24, 33).transpose(-1, -2)),
            ("rows_outer", rows, ints(3, 5, 1, 1)),
            ("rows_inner", rows, ints(1, 1, 1, 129)),
            ("transposed_rows", acc.t(), ints(29, 1)),
            ("scalar", acc, None),
            ("rows_scalar", rows, None),
            ("scalar_wide", ints(2048, 1100), None)]


def ew_plan_forms(state: dict, rng) -> set:
    """Phase 14(a), the plan: dequantize (the layouts' int32 data and
    zero points), quantize and fake quantize (their values as floats, the
    operands' magnitudes as f32 scales) in every form of
    kernels/elementwise.py::plan, against the plain versions; returns the
    forms the plan named ("scalar_narrow": scalar operands on narrow
    vectors)."""
    import torch
    from numpy_quant_tpu_torch.kernels import elementwise as E
    forms = set()
    for label, x, op in ew_plan_layouts(rng):
        pl = E.plan(tuple(x.shape), x.stride(), 4, 4, None,
                    None if op is None else (tuple(op.shape), op.stride()))
        forms.add(pl.zp.form if op is not None else
                  "scalar_narrow" if pl.narrow else "scalar")
        for out in (torch.float32, torch.bfloat16):
            ew_report("dequantize", f"plan:{label}:{str(out)[6:]}",
                      E.dequantize(x, 0.0137, op, out),
                      E.dequantize_reference(x, 0.0137, op, out), state)
        xf = x.to(torch.float32) * 1e-5
        scale = None if op is None else (op.abs().float() + 1.0) * 1e-4
        zp = None if op is None else (op % 7 - 3)
        for kname, kernel, plain in (
                ("quantize", E.quantize, E.quantize_reference),
                ("fake_quantize", E.fake_quantize,
                 E.fake_quantize_reference)):
            for s, z in ((scale if scale is not None else 0.01, None),
                         (0.01, zp)):
                ew_report(kname, f"plan:{label}", kernel(
                    xf, 8, s, z, torch.int8), plain(xf, 8, s, z, torch.int8),
                    state)
    return forms


def same_bits(a, b) -> bool:
    """Two tensors (or numpy arrays) equal bit for bit: same shape and
    dtype, floats compared as their bit patterns."""
    import numpy as np
    import torch
    if isinstance(a, np.ndarray):
        a, b = torch.from_numpy(np.ascontiguousarray(a)), \
            torch.from_numpy(np.ascontiguousarray(b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return torch.equal(a, b)


def time_elementwise(name: str) -> dict:
    """Phase 14(b): both kernels and their plain chains at the largest ViT
    boundary (bf16, B=96 fc1 output), the GPT-2 and TinyLlama scoring
    shapes (f32) and ViT W8A16's fc1 output (f32 -> int64 at 16 bits,
    int64 accumulators), device time alone, beside the bytes bound; and
    each kernel's and each chain's host time per call at a small shape.
    At each shape both kernels first equal their chains bit for bit in
    the forms the paths pass there: f32 and bf16 in and out (f32 only in
    int64), a scalar and a per-channel [1, N] scale, zero points scalar,
    [1, N] (column sums) and [M, 1] (row sums)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.kernels import elementwise as E
    from numpy_quant_tpu_torch.models.llama import TINYLLAMA_1_1B
    rate = peaks(name)["bytes"]
    # label: ((rows, cols), float dtype, container, bits)
    shapes = {"vit_fc1_bf16": ((B_TIME * N_TOK, 3072), torch.bfloat16,
                               torch.int32, 8),
              "gpt2_fc_f32": ((GPT_B * GPT_SEQ, 3072), torch.float32,
                              torch.int32, 8),
              "tinyllama_mlp_f32": ((LLAMA_B * LLAMA_SEQ,
                                     TINYLLAMA_1_1B["intermediate_size"]),
                                    torch.float32, torch.int32, 8),
              "vit_w8a16_fc1_f32": ((B_F32 * N_TOK, 3072), torch.float32,
                                    torch.int64, 16)}
    res = {k: {"shapes": {}} for k in ("quantize", "dequantize")}
    g = torch.Generator(device="cuda").manual_seed(14)
    compared = {"forms": 0, "elements": 0, "mismatched_forms": []}

    def hold(label: str, got, want) -> None:
        compared["forms"] += 1
        compared["elements"] += want.numel()
        if not same_bits(got, want):
            compared["mismatched_forms"].append(label)

    for label, ((rows, cols), dtype, container, bits) in shapes.items():
        x32 = torch.randn(rows, cols, device="cuda", generator=g)
        x = x32.to(dtype)
        span = 2 ** 40 if container == torch.int64 else 2 ** 20
        acc = torch.randint(-span, span, (rows, cols), device="cuda",
                            dtype=container, generator=g)
        zrow = torch.randint(-span, span, (1, cols), device="cuda",
                             dtype=container, generator=g)
        zcol = torch.randint(-span, span, (rows, 1), device="cuda",
                             dtype=container, generator=g)
        channel = (EW_SCALE * np.random.default_rng(rows).uniform(
            0.5, 2.0, size=(1, cols))).astype(np.float32)
        n = rows * cols
        # the path's forms at this shape, each kernel against its chain
        floats = (torch.float32,) if container == torch.int64 \
            else (torch.float32, torch.bfloat16)
        for fdt in floats:
            xf = x32.to(fdt)
            for s, zp in ((EW_SCALE, EW_ZP), (channel, None)):
                form = f"{label}:quantize:{str(fdt)[6:]}:" \
                    f"{'channel' if zp is None else 'scalar'}"
                hold(form, E.quantize(xf, bits, s, zp, container),
                     E.quantize_reference(xf, bits, s, zp, container))
            for (zname, z), s in itertools.product(
                    (("scalar", EW_ZP), ("cols", zrow), ("rows", zcol)),
                    (EW_SCALE, channel)):
                form = f"{label}:dequantize:{str(fdt)[6:]}:zp_{zname}:" \
                    f"{'scalar' if np.ndim(s) == 0 else 'channel'}"
                hold(form, E.dequantize(acc, s, z, fdt),
                     E.dequantize_reference(acc, s, z, fdt))
        # each path form timed beside its bytes bound (and its chain at
        # the ViT shape; the other shapes time the chain in `calls`):
        # quantize with a scalar and a per-channel scale, dequantize with a
        # scalar, a [1, N] and an [M, 1] zero point
        isz, asz = x.element_size(), acc.element_size()
        for form, kernel, plain, nbytes in (
                ("quantize_scalar",
                 lambda: E.quantize(x, bits, EW_SCALE, EW_ZP, container),
                 lambda: E.quantize_reference(x, bits, EW_SCALE, EW_ZP,
                                              container),
                 n * (isz + asz)),
                ("quantize_channel",
                 lambda: E.quantize(x, bits, channel, None, container),
                 lambda: E.quantize_reference(x, bits, channel, None,
                                              container),
                 n * (isz + asz) + 4 * cols),
                ("dequantize_scalar",
                 lambda: E.dequantize(acc, EW_SCALE, EW_ZP, dtype),
                 lambda: E.dequantize_reference(acc, EW_SCALE, EW_ZP, dtype),
                 n * (isz + asz)),
                ("dequantize_cols",
                 lambda: E.dequantize(acc, EW_SCALE, zrow, dtype),
                 lambda: E.dequantize_reference(acc, EW_SCALE, zrow, dtype),
                 n * (isz + asz) + asz * cols),
                ("dequantize_rows",
                 lambda: E.dequantize(acc, EW_SCALE, zcol, dtype),
                 lambda: E.dequantize_reference(acc, EW_SCALE, zcol, dtype),
                 n * (isz + asz) + asz * rows)):
            row = dict(ms=cuda_ms(kernel, lead=True),
                       bound_ms=nbytes / rate * 1e3, bytes=nbytes)
            if label == "vit_fc1_bf16":
                row["plain_ms"] = cuda_ms(plain, lead=True)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            res[form.split("_")[0]].setdefault("forms", {})[
                f"{label}:{form}"] = row
            say("kernel-time", kernel=form.split("_")[0], form=form,
                shape=f"{rows}x{cols}", dtype=str(dtype)[6:],
                container=str(container)[6:], bits=bits, label=label, **row,
                card=name.replace(" ", "_"))
        # torch's own quantized-tensor calls compute another function
        # (rounding before the zero point, a reciprocal multiply; a scalar
        # zero point): timed as a yardstick only
        qt = torch.quantize_per_tensor(x32, EW_SCALE, EW_ZP, torch.qint32)
        calls = {
            "quantize": (lambda: E.quantize(x, bits, EW_SCALE, EW_ZP,
                                            container),
                         lambda: E.quantize_reference(x, bits, EW_SCALE,
                                                      EW_ZP, container),
                         lambda: torch.quantize_per_tensor(
                             x32, EW_SCALE, EW_ZP, torch.qint32),
                         n * x.element_size() + n * acc.element_size()),
            "dequantize": (lambda: E.dequantize(acc, EW_SCALE, zrow, dtype),
                           lambda: E.dequantize_reference(acc, EW_SCALE,
                                                          zrow, dtype),
                           qt.dequantize,
                           (n + cols) * acc.element_size()
                           + n * x.element_size())}
        for kname, (kernel, plain, other, nbytes) in calls.items():
            row = dict(ms=cuda_ms(kernel, lead=True),
                       plain_ms=cuda_ms(plain, lead=True),
                       different_function_ms=cuda_ms(other, lead=True),
                       bound_ms=nbytes / rate * 1e3, bytes=nbytes)
            res[kname]["shapes"][label] = row
            say("kernel-time", kernel=kname, shape=f"{rows}x{cols}",
                dtype=str(dtype)[6:], container=str(container)[6:],
                bits=bits, label=label, **row,
                different_function="torch.quantize_per_tensor" if
                kname == "quantize" else "QTensor.dequantize(qint32)",
                card=name.replace(" ", "_"))
        del x32, x, acc, zcol, qt
    torch.cuda.synchronize()
    say("kernel-check", kernel="quantize,dequantize", scope="path_shapes",
        forms=compared["forms"], elements_compared=compared["elements"],
        mismatched_forms="|".join(compared["mismatched_forms"]) or None)
    assert not compared["mismatched_forms"], compared["mismatched_forms"]
    for kname in ("quantize", "dequantize"):
        res[kname].update(res[kname]["shapes"]["vit_fc1_bf16"])
    # host time per call where the device is not the limit
    small = torch.randn(8, 64, device="cuda")
    small_acc = torch.randint(-99, 99, (8, 64), device="cuda",
                              dtype=torch.int32)
    zs = torch.randint(-99, 99, (1, 64), device="cuda", dtype=torch.int32)
    host = {}
    for label, fn in (
            ("fake_quantize_kernel", lambda: E.fake_quantize(
                small, 8, EW_SCALE, EW_ZP)),
            ("quantize_kernel", lambda: E.quantize(small, 8, EW_SCALE, EW_ZP)),
            ("quantize_plain", lambda: E.quantize_reference(
                small, 8, EW_SCALE, EW_ZP)),
            ("dequantize_kernel", lambda: E.dequantize(small_acc, EW_SCALE,
                                                       zs)),
            ("dequantize_plain", lambda: E.dequantize_reference(
                small_acc, EW_SCALE, zs))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        torch.cuda.synchronize()
        host[f"{label}_us"] = (time.perf_counter() - t0) / 500 * 1e6
    say("host-per-call", **host)
    return res


def boundary_cost(forward) -> dict:
    """The host's share of the quantize boundaries in one f32 forward:
    aten calls (the profiler's count of every aten op, nested ones
    included) and wall ms with the kernels, then with the plain chains,
    the two in turns (3 forwards each); both eager walks (the host cost of
    the walk's boundaries)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def aten_calls():
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            forward()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.key.startswith("aten::"))

    def wall_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with eager():
        res = {"aten_calls_kernel": aten_calls()}
        with plain_chain():
            res["aten_calls_plain"] = aten_calls()
        runs = {"kernel": [], "plain": []}
        for rep in range(3):
            for mode in (("kernel", "plain") if rep % 2 == 0
                         else ("plain", "kernel")):
                with plain_chain() if mode == "plain" \
                        else contextlib.nullcontext():
                    runs[mode].append(wall_ms())
    res.update({f"ms_{m}": statistics.median(r) for m, r in runs.items()})
    res.update({f"ms_runs_{m}": ",".join(f"{v:.2f}" for v in r)
                for m, r in runs.items()})
    return res


def routing_phase(qmodel, x8, launches: dict, t5_cost: dict) -> None:
    """Phase 14(c): every path took the boundary kernels; the ViT-Base
    int8 f32 forward equals itself with the plain chains swapped in, bit
    for bit."""
    kernel, kc = counted(lambda: qmodel([x8])[0])
    with plain_chain():
        plain, pc = counted(lambda: qmodel([x8])[0])
    equal = same_bits(kernel, plain)
    say("routing", vit_int8_f32_kernel_equals_plain_chain=equal,
        logits_compared=plain.size,
        vit_kernel_launches=f"{kc['quantize']}+{kc['dequantize']}",
        vit_plain_chain_launches=f"{pc['quantize']}+{pc['dequantize']}",
        **{f"{path}_launches": f"{c['quantize']}+{c['dequantize']}"
           for path, c in launches.items()})
    assert equal, "kernel and plain-chain ViT-Base forwards differ"
    assert pc["quantize"] == pc["dequantize"] == 0, pc
    for path, c in launches.items():
        assert c["quantize"] > 0 and c["dequantize"] > 0, (path, c)
    cost = boundary_cost(lambda: qmodel([x8], as_numpy=False)[0])
    say("vit-boundaries", **cost)
    assert t5_cost["aten_calls_kernel"] < t5_cost["aten_calls_plain"]


def mlp_sweep_phase() -> None:
    """Phase 14(d): the reference's bit-width sweep on the card. mlp.onnx
    at 1-16 bits on the two-circles data (numpy, seed 3), calibrated once
    on the CPU; the card's integer intermediates equal the CPU port's, its
    labels equal, its accuracy above 0.9 from 6 bits."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.mlp import load_mlp, two_circles
    from numpy_quant_tpu_torch.tensor import QTensor
    x, y = two_circles()
    cpu = Model.from_onnx(load_mlp(), device="cpu")
    card = Model.from_onnx(load_mlp())
    stats = cpu.calibration_stats([x])
    accs, compared = [], 0
    for bits in range(1, 17):
        qc = cpu.quantize(bit_width=bits, stats=stats)
        qg = card.quantize(bit_width=bits, stats=stats)
        (yc,), (yg,) = qc([x], record=True), qg([x], record=True)
        ref = {v.name: v.data for v in qc.values}
        for v in qg.values:
            if isinstance(v.data, QTensor):
                assert torch.equal(v.data.data.cpu(), ref[v.name].data), \
                    (bits, v.name)
                compared += 1
        assert np.array_equal(yg.argmax(1), yc.argmax(1)), bits
        assert np.abs(yg - yc).max() <= 1e-6, (bits, np.abs(yg - yc).max())
        acc = float(np.mean(yg.argmax(1) == y))
        accs.append(acc)
        if bits >= MLP_ACC_RULE:
            assert acc > 0.9, (bits, acc)
    say("mlp-sweep", widths="1-16", integer_values_compared=compared,
        accuracy=",".join(f"{a:.3f}" for a in accs),
        min_accuracy_from_6_bits=min(accs[MLP_ACC_RULE - 1:]))


def w8a16_phase(card: str, model, stats, x8, int8_logits) -> None:
    """Phase 14(e): ViT-Base in W8A16 at full width and depth, f32, B=8,
    after optimize(): no fused attention (JAX's reason), logits against
    the float forward beside int8's, images/s, idle share, peak memory."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.models.vit import WEIGHT_CONFIGS
    t0 = time.perf_counter()
    q16 = model.quantize(stats=stats, quantize_conv=True,
                         **WEIGHT_CONFIGS["w8a16"])
    report = q16.optimize()
    reasons = {r for _, r in report["fusion_failures"]}
    say("w8a16-optimize", seconds=time.perf_counter() - t0,
        fuse_attention=report["fuse_attention"],
        fuse_gelu=report["fuse_gelu"], narrow_gather=report["narrow_gather"],
        int8_dataflow=report["int8_dataflow"],
        fusion_failures=len(report["fusion_failures"]),
        reasons="|".join(sorted(reasons)).replace(" ", "_"))
    assert report["fuse_attention"] == 0
    assert len(report["fusion_failures"]) == 12
    assert reasons == {"bit_width 16 > 8: the int8 attention kernels do "
                       "not apply"}, reasons
    ref = model([x8])[0]
    torch.cuda.reset_peak_memory_stats()
    logits, counts = counted(lambda: q16([x8])[0])
    peak = torch.cuda.max_memory_allocated()
    assert logits.shape == ref.shape and np.isfinite(logits).all()
    # the int64 boundary forms at the path's shapes: the forward with the
    # plain chains swapped in gives the same logits bit for bit
    with plain_chain():
        plain_equal = same_bits(logits, q16([x8])[0])
    d16 = float(np.abs(logits - ref).max())
    d8 = float(np.abs(int8_logits - ref).max())
    agree16 = float((logits.argmax(1) == ref.argmax(1)).mean())
    agree8 = float((int8_logits.argmax(1) == ref.argmax(1)).mean())

    def forward():
        return q16([x8], as_numpy=False)[0]

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        forward()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5

    def timed():
        t1 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    wall_prof, events, busy, tries = profiled(timed)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    say("w8a16", batch=B_F32, quantize_launches=counts["quantize"],
        dequantize_launches=counts["dequantize"],
        other_kernel_launches=others(counts),
        kernel_equals_plain_chain_bitwise=plain_equal,
        logits_compared=logits.size,
        max_abs_diff_float=d16, int8_max_abs_diff_float=d8,
        max_abs_logit_float=float(np.abs(ref).max()),
        argmax_agreement_float=agree16, int8_argmax_agreement_float=agree8,
        images_per_s=B_F32 / wall, ms_per_forward=wall * 1e3,
        device_busy_ms=busy, profile_tries=tries,
        idle_share=None if busy is None
        else max(0.0, 1 - busy / (wall_prof * 1e3)),
        peak_bytes=peak,
        top5=";".join(f"{k[:48].replace(' ', '_')}:{ms:.3f}ms:x{c}"
                      for k, ms, c in rows[:5]),
        card=card.replace(" ", "_"))
    assert counts["quantize"] > 0 and counts["dequantize"] > 0, counts
    assert others(counts) == 0, counts
    assert plain_equal, "W8A16: kernel and plain-chain logits differ"
    assert d16 < d8, (d16, d8)


def ew_path_check(name: str) -> dict:
    """Phase 14(b), the decode shapes: quantize/dequantize/fake_quantize
    at the decode and serving paths' shapes, each against its chain bit
    for bit, then timed beside the bytes bound: the int8 cache write
    [8, 4, 1, 64] (a present, f32 -> int8), a prefill admission's cache
    write [1, 4, 512, 64] (its presents, f32 -> int8; phase 16(c)),
    DecodeAttention's cache probabilities p_past [8, 32, 1, 2048] (dense
    rows of the [.., 2049] softmax, read in place: f32 and bf16 -> int8
    and back, and fake-quantized) and its cache fake-quant
    [8, 32, 2048, 64] (f32 and bf16): one fake_quantize launch against
    the two-launch chain quantize -> dequantize."""
    import torch
    from numpy_quant_tpu_torch.kernels import elementwise as E
    rate = peaks(name)["bytes"]
    g = torch.Generator(device="cuda").manual_seed(15)
    heads, n_kv, hd = 32, 4, 64
    shapes = {"cache_write": ((DEC_B, n_kv, 1, hd), None),
              "prefill_cache_write": ((1, n_kv, PREFILL_N, hd), None),
              "p_past": ((DEC_B, heads, 1, DEC_LEN + 1), DEC_LEN),
              "cache_fake_quant": ((DEC_B, heads, DEC_LEN, hd), None)}
    res, forms = {}, 0
    for label, (shape, cut) in shapes.items():
        full = torch.randn(shape, device="cuda", generator=g)
        if label == "p_past":
            full = torch.softmax(full * 4.0, dim=-1)
        x32 = full[..., :cut] if cut else full
        scale, zp = (1.0 / 255.0, -128) if label == "p_past" \
            else (EW_SCALE, EW_ZP)
        path = "tinyllama_prefill_admission" \
            if label == "prefill_cache_write" else "tinyllama_decode"
        for fdt in (torch.float32, torch.bfloat16):
            if label.endswith("cache_write") and fdt == torch.bfloat16:
                continue  # presents leave the graph as f32
            x = x32.to(fdt) if cut is None else full.to(fdt)[..., :cut]
            q = E.quantize(x, 8, scale, zp, torch.int8)
            want = E.quantize_reference(x, 8, scale, zp, torch.int8)
            assert same_bits(q, want), f"quantize {label} {fdt}"
            deq = E.dequantize(q, scale, zp, torch.float32)
            assert same_bits(deq, E.dequantize_reference(
                q, scale, zp, torch.float32)), f"dequantize {label} {fdt}"
            forms += 2
            n = x.numel()
            timed = []
            if label in ("p_past", "cache_fake_quant"):
                fq, c = counted(lambda: E.fake_quantize(x, 8, scale, zp,
                                                        torch.int8))
                assert c["fake_quantize"] == 1 and c["quantize"] == 0 \
                    and c["dequantize"] == 0, c
                assert same_bits(fq, E.fake_quantize_reference(
                    x, 8, scale, zp, torch.int8)) and same_bits(fq, deq), \
                    f"fake_quantize {label} {fdt}"
                forms += 1
                in_place = not E.plan(tuple(x.shape), x.stride(),
                                      x.element_size(), 4).copy
                say("kernel-check", kernel="fake_quantize", label=label,
                    dtype=str(fdt)[6:], launches=c["fake_quantize"],
                    read_in_place=in_place)
                if label == "p_past":
                    assert in_place, "p_past is copied before the kernel"
                timed = [
                    ("fake_quantize",
                     lambda: E.fake_quantize(x, 8, scale, zp, torch.int8),
                     lambda: E.fake_quantize_reference(x, 8, scale, zp,
                                                       torch.int8),
                     n * x.element_size() + 4 * n),
                    ("fake_quantize_chain",
                     lambda: E.dequantize(E.quantize(x, 8, scale, zp,
                                                     torch.int8), scale, zp),
                     lambda: E.fake_quantize_reference(x, 8, scale, zp,
                                                       torch.int8),
                     n * x.element_size() + 4 * n)]
            for kname, kernel, plain, nbytes in timed + [
                    ("quantize",
                     lambda: E.quantize(x, 8, scale, zp, torch.int8),
                     lambda: E.quantize_reference(x, 8, scale, zp,
                                                  torch.int8),
                     n * x.element_size() + n),
                    ("dequantize",
                     lambda: E.dequantize(q, scale, zp, torch.float32),
                     lambda: E.dequantize_reference(q, scale, zp,
                                                    torch.float32),
                     n + 4 * n)]:
                row = dict(ms=cuda_ms(kernel, lead=True),
                           plain_ms=cuda_ms(plain, lead=True),
                           bound_ms=nbytes / rate * 1e3, bytes=nbytes)
                key = f"{label}_{str(fdt)[6:]}"
                res.setdefault(kname, {})[key] = row
                say("kernel-time", kernel=kname, path=path, label=label, shape="x".join(map(str, x.shape)),
                    dtype=str(fdt)[6:], container="int8",
                    contiguous=x.is_contiguous(), **row,
                    card=name.replace(" ", "_"))
        del full, x32
    say("kernel-check", kernel="quantize,dequantize,fake_quantize",
        scope="tinyllama_decode_and_admission_shapes", forms=forms, mismatched_forms=0)
    return res


def plain_decode_shape(name: str) -> dict:
    """Phase 15(f): fused_attention at the int8 prefill's shape (BH = 32,
    N = 512, D = 64, causal), int8 and f32 out, against its plain version
    (no flipped block where torch sums its rows in the kernel's order),
    then timed beside its bound and the plain version."""
    from numpy_quant_tpu_torch.kernels import attention as A
    rates = peaks(name)
    bh, n, d = 32, PREFILL_N, 64
    q, kt, v = plain_inputs(bh, n, d, seed=15)
    in_order = exact_in_order(bh * A.plain_tile(n), n)
    res = {}
    for out, rq in (("int8", OUT_REQUANT), ("f32", None)):
        kw = dict(QP, out_requant=rq, causal_mask_val=MASK_VAL)
        flips, blocks, err = attention_diff(
            A.fused_attention(q, kt, v, **kw),
            A.fused_attention_reference(q, kt, v, **kw), 1, rq, QP,
            f"plain BH{bh} N{n} prefill {out}")
        assert not in_order or flips == 0, (out, flips, blocks)
        ms = cuda_ms(lambda: A.fused_attention(q, kt, v, **kw), lead=True)
        plain_ms = cuda_ms(lambda: A.fused_attention_reference(
            q, kt, v, **kw), lead=True)
        nbytes = 3 * q.numel() + q.numel() * (1 if rq else 4)
        ops = 2 * 2 * bh * (n * (n + 1) // 2) * d
        t_bytes = nbytes / rates["bytes"] * 1e3
        t_ops = ops / rates["int8"] * 1e3
        res[out] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                        flipped_blocks=f"{flips}/{blocks}",
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations")
        say("kernel-time", kernel="fused_attention", path="tinyllama_prefill",
            form="exact", shape=f"BH{bh}xN{n}xD{d}", causal=True, out=out,
            in_torch_order=in_order, **res[out], bytes=nbytes, ops=ops,
            library="none", card=name.replace(" ", "_"))
    return res


def float_prefill_check(weights, step, last, prompt, wte) -> None:
    """Phase 15(e): the float prefill of the prompt (P = DEC_PROMPT, one
    graph built for B=1 serving all DEC_B rows) against the caches that
    decode_calibration built for it: slots 0..P-2 from its last input list,
    slot P-1 from one more step. Bounded like phase 7's teacher-forced
    logits, relative to max|cache|."""
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.llama import llama_prefill
    t0 = time.perf_counter()
    model = Model.from_onnx(llama_prefill(weights, tinyllama(),
                                          DEC_PROMPT))
    outs = model([torch.from_numpy(wte[prompt]).cuda()], as_numpy=False)
    res = step(last, as_numpy=False)
    worst = rel = 0.0
    for i in range(len(res) - 1):
        cache = last[4 + i][:, :, :DEC_PROMPT].clone()
        cache[:, :, DEC_PROMPT - 1:] = res[1 + i]
        diff = float((outs[1 + i] - cache).abs().max())
        worst = max(worst, diff)
        rel = max(rel, diff / float(cache.abs().max()))
    say("llama-prefill-f32", prefill=DEC_PROMPT, batch=DEC_B,
        presents=len(res) - 1, max_abs_diff_vs_decode_caches=worst,
        max_diff_over_max_cache=rel, tolerance=TEACHER_TOL,
        seconds=time.perf_counter() - t0)
    assert rel <= TEACHER_TOL, (worst, rel)


def int8_prefill_phase(card: str, weights):
    """Phase 15(e): the int8 prefill at P = PREFILL_N, B=1: calibration on
    2 sequences, quantize(int8), unfused forward, optimize() (22 plain
    fusions), fused f32 forward equal to the unfused one bit for bit
    wherever torch sums the rows in the kernel's order (probed) with 22
    fused_attention launches; prefill tokens/s in f32 and bf16 (median of
    3, in turns). Returns the fused forward's launch counts and the
    optimized int8 prefill model (phase 16 admits prompts with it)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.models.llama import llama_prefill
    cfg, n = tinyllama(), PREFILL_N
    layers, vocab = cfg["num_hidden_layers"], cfg["vocab_size"]
    t0 = time.perf_counter()
    proto = llama_prefill(weights, cfg, n)
    wte = proto._wte
    model = Model.from_onnx(proto)
    del proto
    rng = np.random.default_rng(151)
    calib = wte[rng.integers(0, vocab, size=(2, n))]
    x = torch.from_numpy(wte[rng.integers(0, vocab, size=(1, n))]).cuda()
    qmodel = model.quantize(bit_width=8, stats=model.calibration_stats([calib]))
    del model

    def forward():
        return qmodel([x], as_numpy=False)

    unfused = forward()
    report = qmodel.optimize()
    fused, counts = counted(forward)
    equal = all(torch.equal(a, b) for a, b in zip(fused, unfused))
    in_order = exact_in_order(cfg["num_attention_heads"] * A.plain_tile(n), n)
    diff = max(float((a - b).abs().max()) for a, b in zip(fused, unfused))
    say("llama-prefill-int8", prefill=n, batch=1,
        fuse_attention=report["fuse_attention"],
        plain_fusions=len(qmodel.fusion_report.get("plain_fusions", [])),
        fuse_decode_attention=report["fuse_decode_attention"],
        fusion_failures=len(report["fusion_failures"]),
        fused_attention_launches=counts["fused_attention"],
        outputs=len(fused), fused_equals_unfused_bitwise=equal,
        max_abs_diff=diff, in_torch_order=in_order,
        setup_seconds=time.perf_counter() - t0)
    assert report["fuse_attention"] == layers, report
    assert not report["fusion_failures"], report["fusion_failures"]
    assert counts["fused_attention"] == layers, counts
    assert others(counts) == layers, counts
    assert all(bool(t.isfinite().all()) for t in fused)
    assert not in_order or equal, "prefill: fused != unfused in torch order"
    del fused, unfused
    for m, runs in forward_seconds(forward, 3).items():
        wall = statistics.median(runs)
        say("llama-prefill-throughput", dtype=m, prefill=n, batch=1,
            tokens_per_s=n / wall, ms_per_prefill=wall * 1e3,
            ms_runs=",".join(f"{r * 1e3:.2f}" for r in runs),
            card=card.replace(" ", "_"))
    # phase 18 (d): the prefill captured
    captured_forward("llama_prefill_int8", card, qmodel, [x], n, "tokens",
                     reps=5, dtype="f32", prefill=n, batch=1)
    return counts, qmodel


def decode_profile(model, prompt, wte, rope, cache) -> dict:
    """One profiled greedy decode of DEC_PROFILE_PROMPT + DEC_PROFILE_NEW
    tokens (the step's cost does not depend on the position: every step
    reads the whole cache): device busy time (None where no trace saw
    device time, profiled) and aten calls per step."""
    from numpy_quant_tpu_torch.utils import generate_kv
    steps = DEC_PROFILE_PROMPT + DEC_PROFILE_NEW - 1
    short = prompt[:, :DEC_PROFILE_PROMPT]
    _, events, busy, tries = profiled(
        lambda: generate_kv(model, short, wte, None, DEC_PROFILE_NEW,
                            rope=rope, kv_cache_dtype=cache))
    return dict(busy_ms_per_step=None if busy is None else busy / steps,
                aten_calls_per_step=aten_count(events) / steps,
                profile_tries=tries)


def cache_bytes(model, prompt, wte, rope, cache) -> int:
    """Device bytes of the KV caches generate_kv hands the step model (one
    step, seen by a wrapper on the model)."""
    from numpy_quant_tpu_torch.utils import generate_kv
    seen = []

    class Spy:
        def __getattr__(self, key):
            return getattr(model, key)

        def __call__(self, inputs, **kw):
            seen.append(sum(t.numel() * t.element_size() for t in inputs[4:]))
            return model(inputs, **kw)
    generate_kv(Spy(), prompt[:, :1], wte, None, 1, rope=rope,
                kv_cache_dtype=cache)
    return seen[0]


def llama_decode_phase(card: str, weights) -> dict:
    """Phase 15: TinyLlama-1.1B decode at full width and depth. Returns
    the launch counts and timings the kernels line reports, and for phase
    16 the int8 fused and the W4 g=128 step models with the embedding and
    RoPE tables."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.llama import llama_decode_step
    from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                             merge_calibration_stats)
    cfg = tinyllama()
    layers, vocab = cfg["num_hidden_layers"], cfg["vocab_size"]
    # (a) build, calibrate on the teacher-forced prompt, quantize, fuse
    t0 = time.perf_counter()
    proto = llama_decode_step(weights, cfg, batch_size=DEC_B,
                              max_len=DEC_LEN)
    wte, rope = proto._wte, proto._rope_tables
    model = Model.from_onnx(proto)
    del proto
    t_build = time.perf_counter() - t0
    prompt = np.random.default_rng(15).integers(
        0, vocab, size=(DEC_B, DEC_PROMPT)).astype(np.int32)
    batches = decode_calibration(model, prompt, wte, None, rope=rope)
    stats = merge_calibration_stats(*[model.calibration_stats(b)
                                      for b in batches])
    last = batches[-1]
    del batches
    t_calib = time.perf_counter() - t0 - t_build
    unfused = model.quantize(bit_width=8, stats=stats)
    fused = model.quantize(bit_width=8, stats=stats)
    report = fused.optimize()
    n_dec = sum(nd.op == "DecodeAttention" for nd in fused.nodes)
    say("llama-decode-setup", build_seconds=t_build,
        calibration_seconds=t_calib, calibration_steps=DEC_PROMPT,
        stats=len(stats), nodes_unfused=len(unfused.nodes),
        nodes_fused=len(fused.nodes), decode_attention_nodes=n_dec,
        fuse_attention=report["fuse_attention"],
        int8_dataflow=report["int8_dataflow"],
        fusion_failures=len(report["fusion_failures"]),
        seconds=time.perf_counter() - t0)
    assert report["fuse_decode_attention"] == n_dec == layers, report
    assert not report["fusion_failures"], report["fusion_failures"]
    # (e) the float prefill against the calibration caches
    float_prefill_check(weights, model, last, prompt, wte)
    del last
    t0 = time.perf_counter()
    converted = model.quantize_weights(bit_width=4, group_size=WO_GROUP)
    say("llama-decode-w4", converted=converted,
        seconds=time.perf_counter() - t0)
    assert converted == LLAMA_WO_PER_STEP, converted
    # mode: (model, kv cache dtype, packed execution)
    modes = {"int8_unfused": (unfused, None, "unpack"),
             "int8_fused": (fused, None, "unpack"),
             "int8_fused_int8_cache": (fused, "int8", "unpack"),
             "w4_kernel": (model, None, "kernel"),
             "w4_unpack": (model, None, "unpack")}
    runs = [(d, m) for d in ("f32", "bf16") for m in modes]
    # the unfused int8 step is the slowest: its runs are cut short
    new_tokens = {m: DEC_UNFUSED_NEW if m == "int8_unfused" else DEC_NEW
                  for m in modes}
    steps = {m: DEC_PROMPT + n - 1 for m, n in new_tokens.items()}

    def decode(run, rows=None, new=None, **kw):
        qm, cache, _ = modes[run[1]]
        return generate_kv(qm, prompt, wte, None,
                           new or new_tokens[run[1]], rope=rope,
                           kv_cache_dtype=cache, step_logits=rows, **kw)

    kv_bytes = {}
    for run in runs:  # one step each: uploads the tables, warms up
        with decode_mode(run[0], modes[run[1]][2]):
            kv_bytes[run[1]] = cache_bytes(modes[run[1]][0], prompt, wte,
                                           rope, modes[run[1]][1])
    say("llama-decode-kv-cache", layers=layers, batch=DEC_B,
        cache_len=DEC_LEN, kv_heads=cfg["num_key_value_heads"],
        int8_cache_bytes=kv_bytes["int8_fused_int8_cache"],
        f32_cache_bytes=kv_bytes["int8_fused"],
        ratio=kv_bytes["int8_fused"] / kv_bytes["int8_fused_int8_cache"])
    assert kv_bytes["int8_fused"] == 4 * kv_bytes["int8_fused_int8_cache"]
    # (b), (c) greedy decodes of every mode, taken in turns
    results, seconds = {}, {run: [] for run in runs}
    for rep in range(DEC_REPS):
        for run in (runs if rep % 2 == 0 else runs[::-1]):
            with decode_mode(run[0], modes[run[1]][2]):
                torch.cuda.synchronize()
                start = time.perf_counter()
                if rep == 0:
                    rows = []
                    ids, counts = counted(lambda: decode(run, rows))
                    results[run] = ids, rows, counts
                else:
                    decode(run)
                torch.cuda.synchronize()
                seconds[run].append(time.perf_counter() - start)
    for run in runs:
        with decode_mode(run[0], modes[run[1]][2]):
            prof = decode_profile(modes[run[1]][0], prompt, wte, rope,
                                  modes[run[1]][1])
        ids, rows, counts = results[run]
        wall = statistics.median(seconds[run])
        wo = counts["splitk_wo_matmul"]
        finite = all(bool(r.isfinite().all()) for r in rows)
        new, n = new_tokens[run[1]], steps[run[1]]
        say("llama-decode", dtype=run[0], mode=run[1], batch=DEC_B,
            prompt=DEC_PROMPT, new_tokens=new, steps=n,
            cut_short=new < DEC_NEW,
            tokens_per_s=DEC_B * new / wall,
            ms_per_step=wall / n * 1e3,
            ms_per_step_runs=",".join(f"{t / n * 1e3:.2f}"
                                      for t in seconds[run]),
            aten_calls_per_step=prof["aten_calls_per_step"],
            device_busy_ms_per_step=prof["busy_ms_per_step"],
            profile_tries=prof["profile_tries"],
            idle_share=None if prof["busy_ms_per_step"] is None
            else max(0.0, 1 - prof["busy_ms_per_step"] / (wall / n * 1e3)),
            splitk_wo_launches_per_step=wo / n,
            quantize_launches_per_step=counts["quantize"] / n,
            dequantize_launches_per_step=counts["dequantize"] / n,
            fake_quantize_launches_per_step=counts["fake_quantize"] / n,
            finite=finite, card=card.replace(" ", "_"))
        assert ids.shape == (DEC_B, DEC_PROMPT + new), ids.shape
        assert (ids[:, :DEC_PROMPT] == prompt).all() and finite, run
        want_wo = LLAMA_WO_PER_STEP * n if run[1] == "w4_kernel" else 0
        assert wo == want_wo and others(counts) == wo, (run, counts)
        # DecodeAttention's fake quantizations: one launch each
        assert (counts["fake_quantize"] > 0) == run[1].startswith(
            "int8_fused"), (run, counts)
    gen = slice(DEC_PROMPT, None)

    def agree(a, b):
        return f"{int((a[:, gen] == b[:, gen]).sum())}/{a[:, gen].size}"
    for dtype in ("f32", "bf16"):
        a = results[dtype, "int8_fused_int8_cache"][0]
        b = results[dtype, "int8_fused"][0]
        say("llama-decode-int8-cache", dtype=dtype,
            int8_cache_equals_float_cache=bool(np.array_equal(a, b)))
        assert np.array_equal(a, b), f"{dtype}: int8 cache != float cache"
    for label, (ka, kb), tol in (
            ("fused_vs_unfused", ("int8_fused", "int8_unfused"), None),
            ("w4_kernel_vs_unpack", ("w4_kernel", "w4_unpack"), TEACHER_TOL)):
        ids_a, rows_a, _ = results["f32", ka]
        ids_b, rows_b, _ = results["f32", kb]
        cmp = compare_decodes(ids_a, rows_a, ids_b, rows_b, DEC_PROMPT)
        # where greedy rows part, the runs' logits at that step may differ
        # by max_diff each, so the top-2 margin there is at most twice it
        unexplained = [c for c in cmp["parted"] if c[2] > 2 * cmp["max_diff"]]
        say("llama-decode-f32", compare=label,
            tokens_equal=agree(ids_a[:, :ids_b.shape[1]], ids_b),
            first_step_max_diff=float((rows_a[0] - rows_b[0]).abs().max()),
            rows_equal=f"{DEC_B - len(cmp['parted'])}/{DEC_B}",
            rows_parted_within_margin=len(cmp["parted"]) - len(unexplained),
            parted=";".join(f"row{b}@{p}:margin{m:.3g}"
                            for b, p, m in cmp["parted"]) or "none",
            max_abs_logit_diff=cmp["max_diff"],
            teacher_forced_max_diff=cmp["forced_diff"],
            max_abs_logit=cmp["max_logit"])
        assert not unexplained, (label, unexplained)
        assert tol is None or cmp["forced_diff"] <= tol * cmp["max_logit"], cmp
    for mode in modes:
        say("llama-decode-bf16-vs-f32", mode=mode, tokens_equal=agree(
            results["bf16", mode][0], results["f32", mode][0]))
    # (d) sampling on the int8-cache server
    run = ("f32", "int8_fused_int8_cache")
    kw = dict(temperature=0.8, top_k=50, top_p=0.95, min_p=0.02,
              repetition_penalty=1.1)
    sampled = [decode(run, new=DEC_SAMPLED_NEW, generator=torch.Generator(
        device="cuda").manual_seed(5), **kw) for _ in range(2)]
    top1 = decode(run, new=DEC_SAMPLED_NEW, temperature=0.8, top_k=1,
                  generator=torch.Generator(device="cuda").manual_seed(6))
    greedy = results[run][0][:, :DEC_PROMPT + DEC_SAMPLED_NEW]
    say("llama-decode-sampling", new_tokens=DEC_SAMPLED_NEW,
        seeded_twice_equal=bool(np.array_equal(*sampled)),
        in_vocab=bool(sampled[0].min() >= 0 and sampled[0].max() < vocab),
        sampled_vs_greedy=agree(sampled[0][:, :greedy.shape[1]], greedy),
        top_k_1_equals_greedy=bool(np.array_equal(top1, greedy)))
    assert np.array_equal(*sampled) and np.array_equal(top1, greedy)
    assert sampled[0].min() >= 0 and sampled[0].max() < vocab
    # phase 18 (e): the decode step captured, through generate_kv
    for mode in ("int8_fused_int8_cache", "w4_kernel"):
        qm, cache, execution = modes[mode]
        with decode_mode("f32", execution):
            captured_decode(
                "llama_decode", card, qm,
                lambda m: (generate_kv(m, prompt, wte, None, DEC_NEW,
                                       rope=rope, kv_cache_dtype=cache),
                           steps[mode]),
                np.array_equal, lambda ids: DEC_B * DEC_NEW, mode=mode,
                dtype="f32", batch=DEC_B, cache_len=DEC_LEN)
    del unfused
    return {"counts": {run[1]: results[run][2] for run in runs
                       if run[0] == "f32"},
            "steps": steps, "int8_fused": fused, "w4": model, "wte": wte,
            "rope": rope}


def vit_serving_phase(card: str, qmodel) -> dict:
    """Phase 16(a): the optimized, packed int8 ViT-Base of phase 3 in bf16
    at B=96 under map_batches and serve_stream(depth=2), over VIT_STEPS
    seeded batches, under "unpack" and "kernel": each output equal to the
    batch's own __call__ bit for bit; images/s of map_batches, serve_stream
    and a plain __call__ loop (one sync per batch); launches per forward.
    Returns the "kernel" map_batches launches per forward."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import config
    from numpy_quant_tpu_torch.serving import map_batches, serve_stream
    rng = np.random.default_rng(16)
    image = tuple(qmodel.inputs[0].shape_hint[1:])
    xs = rng.normal(size=(VIT_STEPS, B_SERVE) + image).astype(
        np.float32) * 0.5
    images = VIT_STEPS * B_SERVE
    per_forward = {}
    with config.low_precision_floats():
        for mode in ("unpack", "kernel"):
            with packed_execution(mode):
                want = np.stack([qmodel([x])[0] for x in xs])
                mapped, counts = counted(
                    lambda: map_batches(qmodel, [xs])[0])
                streamed = np.stack([o[0] for o in serve_stream(
                    qmodel, ([x] for x in xs), depth=2)])
                seconds = {"map_batches": [], "serve_stream": [],
                           "call_loop": []}
                runs = {
                    "map_batches": lambda: map_batches(qmodel, [xs]),
                    "serve_stream": lambda: list(serve_stream(
                        qmodel, ([x] for x in xs), depth=2)),
                    "call_loop": lambda: [qmodel([x]) for x in xs]}
                for turn in ("map_batches", "serve_stream", "call_loop",
                             "call_loop", "serve_stream", "map_batches"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs[turn]()
                    torch.cuda.synchronize()
                    seconds[turn].append(time.perf_counter() - t0)
            per = {k: v / VIT_STEPS for k, v in counts.items()}
            per_forward[mode] = per
            map_equal = bool(np.array_equal(mapped, want))
            stream_equal = bool(np.array_equal(streamed, want))
            say("serve-vit", mode=mode, batch=B_SERVE, steps=VIT_STEPS,
                map_batches_equals_call=map_equal,
                serve_stream_equals_call=stream_equal,
                **{f"images_per_s_{k}": images / statistics.median(v)
                   for k, v in seconds.items()},
                **{f"ms_runs_{k}": ",".join(f"{t * 1e3:.1f}" for t in v)
                   for k, v in seconds.items()},
                attention_launches_per_forward=per["fused_attention_hs"],
                splitk_qmatmul_launches_per_forward=per["splitk_qmatmul"],
                quantize_launches_per_forward=per["quantize"],
                dequantize_launches_per_forward=per["dequantize"],
                card=card.replace(" ", "_"))
            assert map_equal and stream_equal, mode
            assert np.isfinite(want).all() and want.shape == (
                VIT_STEPS, B_SERVE, 1000)
            assert per["fused_attention_hs"] == SERVE_LAUNCHES[
                "fused_attention_hs_per_vit_forward"], per
            assert per["splitk_qmatmul"] == (SERVE_LAUNCHES[
                "splitk_qmatmul_per_vit_forward_kernel"]
                if mode == "kernel" else 0), per
    return per_forward["kernel"]


def serve_workload(vocab: int):
    """Phase 16(b)'s 24 requests from seed 16: SERVE_PER_GROUP prompts of
    each length in SERVE_PLENS, budgets uniform in SERVE_BUDGETS, submitted
    interleaved (request 3i + g is group g's i-th). Returns the request
    tuples and, per group, (prompts [8, plen], budgets [8])."""
    import numpy as np
    rng = np.random.default_rng(16)
    groups = [(rng.integers(0, vocab, size=(SERVE_PER_GROUP, plen))
               .astype(np.int32),
               rng.integers(SERVE_BUDGETS[0], SERVE_BUDGETS[1] + 1,
                            size=SERVE_PER_GROUP))
              for plen in SERVE_PLENS]
    reqs = [(groups[g][0][i], int(groups[g][1][i]))
            for i in range(SERVE_PER_GROUP) for g in range(len(groups))]
    return reqs, groups


def schedule_steps(lengths: list, slots: int, k: int) -> int:
    """The steps a dense engine with ``slots`` slots and steps_per_sync=k
    takes to serve requests that need ``lengths`` steps each (prompt +
    budget - 1: teacher forced, no EOS), each admitted into the lowest free
    slot at the start of a chunk: the schedule the engine must keep,
    computed without it."""
    queue, left, steps = list(lengths), [0] * slots, 0
    while queue or any(left):
        for s in range(slots):
            if not left[s] and queue:
                left[s] = queue.pop(0)
        left = [max(0, n - k) for n in left]
        steps += k
    return steps


def host_syncs(fn):
    """Run ``fn()`` noting the synchronizing CUDA calls it makes (torch's
    sync debug mode warns at each); returns its result and a Counter of
    the (file, line) that made them."""
    import collections
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        (os.path.relpath(w.filename), w.lineno) for w in seen
        if "synchroniz" in str(w.message))


def engine_run(make, reqs):
    """One drain of ``reqs`` by a fresh engine ``make()`` from a
    synchronize to a synchronize, counting launches and host syncs.
    Returns (results, engine, wall seconds, launch counts, syncs)."""
    import torch
    engine = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (out, counts), syncs = host_syncs(lambda: counted(
        lambda: engine.run(reqs)))
    torch.cuda.synchronize()
    return out, engine, time.perf_counter() - t0, counts, \
        sum(syncs.values())


def sync_sources(make, reqs, steps: int = 3) -> float:
    """Prints, per source line, the host syncs of ``steps`` steady engine
    steps (a fresh engine ``make()`` on ``reqs``, past their admission and
    before any retires); returns the syncs per step."""
    import torch
    engine = make()
    for req in reqs:
        engine.submit(*req)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    _, where = host_syncs(lambda: [engine.step() for _ in range(steps)])
    for (path, line), n in where.most_common():
        say("serve-sync", per_step=n / steps, at=f"{path}:{line}")
    return sum(where.values()) / steps


def generated(out: dict, reqs) -> int:
    return sum(len(out[i]) - len(r[0]) for i, r in enumerate(reqs))


def engine_step_profile(make, reqs, wall_step: float) -> dict:
    """Device busy time of one profiled engine step (the third of a fresh
    engine on ``reqs``, or a later one where the trace is taken again),
    against ``wall_step``, the unprofiled wall seconds per step; None
    where no trace saw device time (profiled)."""
    import torch
    engine = make()
    for req in reqs:
        engine.submit(*req)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    _, events, busy, tries = profiled(engine.step)
    return dict(busy_ms_per_step=busy, aten_calls_per_step=aten_count(events),
                profile_tries=tries, idle_share=None if busy is None
                else max(0.0, 1 - busy / (wall_step * 1e3)))


def engine_phase(card: str, step, w4, wte, rope) -> dict:
    """Phase 16(b): the continuous-batching engine on the int8 fused
    TinyLlama step of phase 15 (B=8, cache 2048) over the 24-request
    workload, and on its W4 g=128 float step. Returns the launch counts
    per step of E1 and E5."""
    import numpy as np
    from numpy_quant_tpu_torch.utils import ContinuousBatcher, generate_kv
    reqs, groups = serve_workload(wte.shape[0])
    n_slots = step.inputs[0].shape_hint[0]
    lengths = [len(p) + n - 1 for p, n in reqs]

    def make(model=step, cache="int8", **kw):
        return lambda: ContinuousBatcher(model, wte, None, rope=rope,
                                         kv_cache_dtype=cache, **kw)

    # the oracle: generate_kv on the same step model over each group, to
    # the group's largest budget, truncated per request (greedy tokens are
    # prefix-consistent)
    oracle = {}
    for g, (prompts, budgets) in enumerate(groups):
        ids = generate_kv(step, prompts, wte, None, int(budgets.max()),
                          rope=rope, kv_cache_dtype="int8")
        for i in range(SERVE_PER_GROUP):
            oracle[3 * i + g] = ids[i, :prompts.shape[1] + budgets[i]]
    results, rates, walls = {}, {}, {}
    for label, kw in (("E1", {}), ("E2", dict(paged_kv=SERVE_PAGED)),
                      ("E3", dict(steps_per_sync=SERVE_K))):
        out, engine, wall, counts, syncs = engine_run(make(**kw), reqs)
        results[label] = out, engine.stats, counts
        st = engine.stats
        calls = st["steps"] // kw.get("steps_per_sync", 1)
        equal = sum(np.array_equal(out[i], oracle[i]) for i in oracle)
        rates[label] = generated(out, reqs) / wall
        walls[label] = wall / st["steps"]
        say("serve-engine", run=label, requests=len(reqs), slots=n_slots,
            cache="int8", **{k: v for k, v in kw.items()},
            tokens_equal_oracle=f"{equal}/{len(reqs)}",
            steps=st["steps"], step_calls=calls,
            slot_steps=st["slot_steps"], preemptions=st["preemptions"],
            generated_tokens=generated(out, reqs),
            tokens_per_s=rates[label], ms_per_step=wall / st["steps"] * 1e3,
            host_syncs_per_step_call=syncs / calls,
            quantize_launches_per_step=counts["quantize"] / st["steps"],
            dequantize_launches_per_step=counts["dequantize"] / st["steps"],
            fake_quantize_launches_per_step=(counts["fake_quantize"]
                                             / st["steps"]),
            seconds=wall, card=card.replace(" ", "_"))
        assert equal == len(reqs), (label, equal)
        assert others(counts) == 0, (label, counts)
    e1, e2, e3 = (results[k][1] for k in ("E1", "E2", "E3"))
    want1 = schedule_steps(lengths, n_slots, 1)
    want3 = schedule_steps(lengths, n_slots, SERVE_K)
    say("serve-engine-schedule", steps_k1=e1["steps"], steps_k4=e3["steps"],
        scheduled_k1=want1, scheduled_k4=want3,
        k4_over_k1_steps=e3["steps"] - e1["steps"],
        paged_preemptions=e2["preemptions"],
        paged_pool_rows=(SERVE_PAGED[1] - 1) * SERVE_PAGED[0],
        dense_cache_rows=n_slots * step.inputs[4].shape_hint[2])
    assert e1["steps"] == want1 and e3["steps"] == want3, (e1, e3)
    assert e2["preemptions"] >= 1, e2
    assert e1["slot_steps"] == e3["slot_steps"] == sum(lengths)

    # phase 18 (f): the dense engine's step captured (E1)
    def drain(m):
        eng = ContinuousBatcher(m, wte, None, rope=rope,
                                kv_cache_dtype="int8")
        return eng.run(reqs), eng.stats["steps"]

    captured_decode(
        "engine_E1", card, step, drain,
        lambda a, b: a.keys() == b.keys()
        and all(np.array_equal(a[i], b[i]) for i in a),
        lambda out: generated(out, reqs), engine="E1", requests=len(reqs),
        slots=n_slots, cache="int8")
    prof = engine_step_profile(make(), reqs[:n_slots], walls["E1"])
    prof["steady_host_syncs_per_step"] = sync_sources(make(),
                                                      reqs[:n_slots])
    say("serve-engine-profile", run="E1", **prof, card=card.replace(" ", "_"))
    # E4: every 4th request sampled, the rest greedy
    sampled = [r + ((None, SERVE_TEMP) if i % 4 == 0 else ())
               for i, r in enumerate(reqs)]
    out4, _, _, _, _ = engine_run(make(seed=16), sampled)
    greedy_equal = all(np.array_equal(out4[i], results["E1"][0][i])
                       for i in range(len(reqs)) if i % 4)
    g1 = [sampled[3 * i + 1] for i in range(SERVE_PER_GROUP)]
    runs = [engine_run(make(seed=16, steps_per_sync=k), g1)[0]
            for k in (1, 1, SERVE_K)]
    same = [all(np.array_equal(a[i], b[i]) for i in a)
            for a, b in ((runs[0], runs[1]), (runs[0], runs[2]))]
    moved = sum(not np.array_equal(out4[i], results["E1"][0][i])
                for i in range(0, len(reqs), 4))
    say("serve-engine-sampled", run="E4", temperature=SERVE_TEMP,
        sampled_requests=len(range(0, len(reqs), 4)),
        sampled_differ_from_greedy=moved,
        greedy_requests_equal_E1=greedy_equal,
        group1_seeded_twice_equal=same[0], group1_k4_equals_k1=same[1])
    assert greedy_equal and all(same), (greedy_equal, same)
    # E5: the W4 g=128 float step under "kernel", float cache, group 1
    prompts, budgets = groups[1]
    g1_reqs = [(prompts[i], int(budgets[i])) for i in range(SERVE_PER_GROUP)]
    with packed_execution("kernel"):
        want = generate_kv(w4, prompts, wte, None, int(budgets.max()),
                           rope=rope)
        out5, eng5, wall5, counts5, _ = engine_run(make(w4, None), g1_reqs)
    st5 = eng5.stats
    equal5 = sum(np.array_equal(out5[i], want[i, :prompts.shape[1]
                                                  + budgets[i]])
                 for i in range(SERVE_PER_GROUP))
    per_step5 = counts5["splitk_wo_matmul"] / st5["steps"]
    say("serve-engine", run="E5", model="w4_g128_kernel", cache="float",
        requests=SERVE_PER_GROUP, tokens_equal_generate_kv=
        f"{equal5}/{SERVE_PER_GROUP}", steps=st5["steps"],
        splitk_wo_launches_per_step=per_step5,
        tokens_per_s=generated(out5, g1_reqs) / wall5,
        ms_per_step=wall5 / st5["steps"] * 1e3, card=card.replace(" ", "_"))
    assert equal5 == SERVE_PER_GROUP, equal5
    assert per_step5 == SERVE_LAUNCHES[
        "splitk_wo_matmul_per_w4_engine_step"], per_step5
    assert others(counts5) == counts5["splitk_wo_matmul"], counts5
    st1, c1 = results["E1"][1], results["E1"][2]
    return {"tokens_per_s": rates, "profile": prof,
            "per_step": {"E1": {k: v / st1["steps"] for k, v in c1.items()},
                         "E5": {k: v / st5["steps"]
                                for k, v in counts5.items()}}}


def admission_phase(card: str, step, prefill, wte, rope) -> dict:
    """Phase 16(c): prefill admission with the int8 llama_prefill (P=512)
    of phase 15 into the int8 fused step's engine (int8 cache): 8 requests
    from seed 17. Every request is admitted by prefill (22 fused_attention
    launches each); its first token is the argmax of the prefill logits at
    row plen-1; its slot's int8 cache rows [0, plen) equal the plain
    quantize (quantize_reference) of the prefill presents. The tokens after admission are reported against a
    teacher-forced engine on the two shortest prompts, not held equal (the
    prefill's float work differs from the step's). Returns the launch
    counts per admission."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.kernels import elementwise as E
    from numpy_quant_tpu_torch.utils import ContinuousBatcher
    rng = np.random.default_rng(17)
    n = SERVE_PER_GROUP
    plens = rng.integers(ADMIT_PLENS[0], ADMIT_PLENS[1] + 1, size=n)
    budgets = rng.integers(ADMIT_BUDGETS[0], ADMIT_BUDGETS[1] + 1, size=n)
    reqs = [(rng.integers(0, wte.shape[0], size=int(p)).astype(np.int32),
             int(b)) for p, b in zip(plens, budgets)]

    def make(prefill_model):
        return lambda: ContinuousBatcher(step, wte, None, rope=rope,
                                         kv_cache_dtype="int8",
                                         prefill_model=prefill_model)

    out, engine, wall, counts, syncs = engine_run(make(prefill), reqs)
    st = engine.stats
    layers = (len(step.inputs) - 4) // 2
    # each cache's params, for the plain quantize of the presents
    qps = [step.quant_params[v.name] for v in step.inputs[4:]]
    # the slots took the requests in order (8 requests, 8 slots, none
    # finished at admission); the prefill again, per request
    first_ok = rows_ok = 0
    for slot, (prompt, _) in enumerate(reqs):
        p = len(prompt)
        emb = torch.zeros((1, prefill.inputs[0].shape_hint[1], wte.shape[1]),
                          device=step.device)
        emb[0, :p] = torch.from_numpy(wte[prompt])
        outs = prefill([emb], as_numpy=False)
        first_ok += int(torch.argmax(outs[0][0, p - 1])) == int(out[slot][p])
        rows_ok += all(torch.equal(cache[slot, :, :p], E.quantize_reference(
            present, step.bit_width, qp.scale, qp.zero_point,
            torch.int8)[0, :, :p])
                       for cache, present, qp in zip(
                           engine._caches, outs[1:], qps))
        del outs
    short = sorted(range(n), key=lambda i: len(reqs[i][0]))[:2]
    forced, _, forced_wall, _, _ = engine_run(make(None),
                                              [reqs[i] for i in short])
    parted = []
    for j, i in enumerate(short):
        a, b = out[i], forced[j]
        diff = np.flatnonzero(a != b)
        parted.append(f"req{i}:plen{len(reqs[i][0])}:"
                      + (f"part@{int(diff[0])}" if diff.size else "equal"))
    say("serve-prefill", requests=n, prefill=prefill.inputs[0].shape_hint[1],
        plens=",".join(str(int(p)) for p in plens),
        prefills=st["prefills"], steps=st["steps"],
        fused_attention_launches_per_admission=counts["fused_attention"]
        / max(st["prefills"], 1),
        first_token_is_prefill_argmax=f"{first_ok}/{n}",
        cache_rows_equal_quantized_presents=f"{rows_ok}/{n}",
        teacher_forced_agreement=";".join(parted),
        generated_tokens=generated(out, reqs),
        tokens_per_s=generated(out, reqs) / wall,
        prompt_and_generated_tokens_per_s=(generated(out, reqs)
                                           + int(plens.sum())) / wall,
        host_syncs_per_step_call=syncs / max(st["steps"], 1),
        seconds=wall, card=card.replace(" ", "_"))
    assert st["prefills"] == n, st
    assert counts["fused_attention"] == n * SERVE_LAUNCHES[
        "fused_attention_per_prefill_admission"] == n * layers, counts
    assert others(counts) == counts["fused_attention"], counts
    assert first_ok == n and rows_ok == n, (first_ok, rows_ok)
    return {"tokens_per_s": generated(out, reqs) / wall,
            "per_admission": {k: v / n for k, v in counts.items()}}


def generators_phase(card: str, weights) -> dict:
    """Phase 16(d): generate, beam_search and generate_speculative on an
    int8, optimize()d llama_causal_lm at full width with L=GEN_LEN and
    batch BEAM_W, calibrated on one seeded batch; generate_speculative
    with the 2-layer draft (which rarely matches) and with the target as
    its own draft (every proposal accepted). Returns the launch counts per
    forward."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.llama import llama_causal_lm
    from numpy_quant_tpu_torch.utils import (beam_search, generate,
                                             generate_speculative)
    from numpy_quant_tpu_torch.utils.generate import _log_softmax
    cfg = tinyllama()
    t0 = time.perf_counter()
    proto = llama_causal_lm(weights, cfg, batch_size=BEAM_W, seq_len=GEN_LEN)
    wte = proto._wte
    model = Model.from_onnx(proto)
    del proto
    rng = np.random.default_rng(18)
    vocab = cfg["vocab_size"]
    calib = wte[rng.integers(0, vocab, size=(BEAM_W, GEN_LEN))]
    target = model.quantize(bit_width=8,
                            stats=model.calibration_stats([calib]))
    del model
    report = target.optimize()
    draft_proto = llama_causal_lm(weights, dict(cfg, num_hidden_layers=
                                                DRAFT_LAYERS),
                                  batch_size=BEAM_W, seq_len=GEN_LEN)
    draft = Model.from_onnx(draft_proto)
    del draft_proto
    setup = time.perf_counter() - t0

    def logits_of(ids):
        x = torch.from_numpy(np.ascontiguousarray(wte[ids]))
        return target([x.to(target.device)], as_numpy=False)[0]

    prompt = rng.integers(0, vocab, size=(GEN_B, GEN_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    ids, counts = counted(lambda: generate(target, prompt, wte, GEN_NEW))
    gen_s = time.perf_counter() - t0
    pad = np.zeros((GEN_B, GEN_LEN), np.int64)
    pad[:, :ids.shape[1]] = ids
    picks = logits_of(pad).argmax(-1).cpu().numpy()
    gen_ok = bool(np.array_equal(
        ids[:, GEN_PROMPT:], picks[:, GEN_PROMPT - 1:ids.shape[1] - 1]))
    beam_prompt = prompt[:1]
    t0 = time.perf_counter()
    beams, scores = beam_search(target, beam_prompt, wte, BEAM_NEW, BEAM_W)
    beam_s = time.perf_counter() - t0
    pad = np.zeros((BEAM_W, GEN_LEN), np.int64)
    pad[:, :beams.shape[2]] = beams[0]
    logp = _log_softmax(logits_of(pad).to(torch.float32)).cpu().numpy()
    pos = np.arange(GEN_PROMPT, GEN_PROMPT + BEAM_NEW)
    summed = logp[:, pos - 1][np.arange(BEAM_W)[:, None], np.arange(
        BEAM_NEW)[None, :], beams[0][:, pos]].sum(axis=1)
    rel = float(np.abs(summed - scores[0]).max() / np.abs(scores[0]).max())
    ordered = bool((np.diff(scores[0]) <= 0).all())
    t0 = time.perf_counter()
    spec, rounds = generate_speculative(target, draft, prompt, wte, wte,
                                        GEN_NEW, k=SPEC_K)
    spec_s = time.perf_counter() - t0
    spec_ok = bool(np.array_equal(spec, ids))
    # the target as its own draft accepts all k proposals every round:
    # rows advance k + 1 tokens per verify forward
    t0 = time.perf_counter()
    perfect, perfect_rounds = generate_speculative(
        target, target, prompt, wte, wte, GEN_NEW, k=SPEC_K)
    perfect_s = time.perf_counter() - t0
    perfect_ok = bool(np.array_equal(perfect, ids))
    want_rounds = -(-GEN_NEW // (SPEC_K + 1))
    say("serve-generators", length=GEN_LEN, batch=GEN_B, prompt=GEN_PROMPT,
        new_tokens=GEN_NEW, fuse_attention=report["fuse_attention"],
        setup_seconds=setup,
        generate_equals_final_forward_argmax=gen_ok,
        generate_fused_attention_launches_per_forward=
        counts["fused_attention"] / GEN_NEW,
        generate_seconds=gen_s, beam_width=BEAM_W, beam_new=BEAM_NEW,
        beam_scores=",".join(f"{s:.4f}" for s in scores[0]),
        beam_scores_sorted=ordered, beam_score_max_rel_err=rel,
        beam_seconds=beam_s, draft_layers=DRAFT_LAYERS, spec_k=SPEC_K,
        speculative_equals_generate=spec_ok, target_forwards=rounds,
        speculative_seconds=spec_s,
        perfect_draft_equals_generate=perfect_ok,
        perfect_draft_target_forwards=perfect_rounds,
        perfect_draft_seconds=perfect_s, card=card.replace(" ", "_"))
    assert report["fuse_attention"] == cfg["num_hidden_layers"], report
    assert counts["fused_attention"] == GEN_NEW * SERVE_LAUNCHES[
        "fused_attention_per_generate_forward"], counts
    assert gen_ok and ordered and spec_ok, (gen_ok, ordered, spec_ok)
    assert perfect_ok and perfect_rounds == want_rounds, (perfect_ok,
                                                          perfect_rounds)
    assert rel <= BEAM_TOL, rel
    return {k: v / GEN_NEW for k, v in counts.items()}


def conformance_phase(card: str) -> dict:
    """Phase 17(a): the 13 conformance vectors (conformance/manifest.json:
    QDQ, QOperator, dynamic quantization, LSTM/GRU, float graphs) imported
    and run on the card in f32 with TF32 off; each output within its
    vector's atol of the committed expected array. Returns the worst
    error by vector."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch import onnx as O
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    vectors = os.path.join(REPO, "conformance")
    with open(os.path.join(vectors, "manifest.json")) as f:
        manifest = json.load(f)
    worst, misses = {}, []
    for entry in manifest:
        arrays = np.load(os.path.join(vectors, entry["arrays"]))
        model = Model.from_onnx(O.load(os.path.join(vectors, entry["model"])))
        assert model.device.type == "cuda"
        got, counts = counted(lambda: model(
            [arrays[n] for n in entry["inputs"]]))
        errs = []
        for name, g in zip(entry["outputs"], got):
            want = arrays[f"expected::{name}"]
            assert g.shape == want.shape and np.isfinite(g).all(), name
            errs.append(float(np.abs(g.astype(np.float64) - want).max()))
        worst[entry["name"]] = max(errs)
        ok = len(errs) == len(entry["outputs"]) \
            and worst[entry["name"]] <= entry["atol"]
        say("interop-vector", name=entry["name"], atol=entry["atol"],
            max_abs_err=worst[entry["name"]], within_atol=ok,
            ops=",".join(sorted({n.op for n in model.nodes})),
            dequantize_launches=counts["dequantize"])
        if not ok:
            misses.append(entry["name"])
    say("interop-vectors", replayed=f"{len(manifest) - len(misses)}/"
        f"{len(manifest)}", misses=",".join(misses) or "none",
        card=card.replace(" ", "_"))
    assert len(manifest) == 13 and not misses, misses
    return worst


def forward_cost(forward) -> dict:
    """Device busy ms (None where no trace saw device time, profiled) and
    aten calls of one profiled forward (after one unprofiled)."""
    import torch
    forward()
    torch.cuda.synchronize()
    _, events, busy, tries = profiled(forward)
    return dict(device_busy_ms=busy, aten_calls=aten_count(events),
                profile_tries=tries)


def interop_phase(card: str, proto, model, stats, x8, x, optimized) -> dict:
    """Phase 17(b-d) on phase 3's ViT-Base (``proto``, its float ``model``,
    ``stats``; ``optimized``: phase 3's optimize()d, pack_weights()ed int8
    QModel). (b) export_qdq and export_qoperator of quantize(8,
    quantize_conv=True), and of the optimized packed model (its source
    forward under "kernel": fused_attention_hs and splitk_qmatmul),
    re-imported with Model.from_onnx on the card and run at f32 B=8: mean
    |dlogit| against the source forward within EXPORT_RULES, equal labels;
    of the int8 model every quantized MatMul but each layer's probs @ v a
    QLinearMatMul and the patch Conv a QLinearConv; (c) save_qmodel -> load_qmodel of the
    int8 model and of W4A8 per-channel packed under "kernel": the loaded
    forward equal to the saved one bit for bit at f32 B=8 and bf16 B=96;
    (d) images/s at bf16 B=96 of the re-imported QDQ and QOperator models
    and of the native optimized QModel under "unpack" and "kernel" (runs
    in turns, twice each), with device busy ms and aten calls of one
    profiled forward of each. Files go to a temporary directory only.
    Returns the launches per forward of each re-imported model."""
    import tempfile

    import numpy as np
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models.vit import VIT_BASE, WEIGHT_CONFIGS
    from numpy_quant_tpu_torch.utils import (export_qdq, export_qoperator,
                                             load_qmodel, save_qmodel)
    layers = VIT_BASE["num_hidden_layers"]
    n_matmul = sum(n.op_type == "MatMul" for n in proto.graph.node)
    q8 = model.quantize(bit_width=8, stats=stats, quantize_conv=True)
    sources = {"int8": (q8, "unpack"), "int8_optimized_packed":
               (optimized, "kernel")}
    reimported, launches = {}, {}
    for label, (src, mode) in sources.items():
        ref, ref_counts = packed_forward(src, x8, mode)
        if label != "int8":
            assert ref_counts["fused_attention_hs"] == layers, ref_counts
            assert ref_counts["splitk_qmatmul"] == PACKED_PER_FORWARD, \
                ref_counts
        for fmt, export in (("qdq", export_qdq),
                            ("qoperator", export_qoperator)):
            t0 = time.perf_counter()
            exported = export(src, proto)
            ops = [n.op_type for n in exported.graph.node]
            loaded = Model.from_onnx(exported)
            seconds = time.perf_counter() - t0
            got, counts = counted(lambda: loaded([x8])[0])
            mean = float(np.abs(got - ref).mean())
            labels = int((got.argmax(1) == ref.argmax(1)).sum())
            say("interop-export", source=label, source_execution=mode,
                format=fmt, batch=B_F32, mean_abs_dlogit=mean,
                rule=EXPORT_RULES[fmt], labels_equal=f"{labels}/{B_F32}",
                max_abs_dlogit=float(np.abs(got - ref).max()),
                max_abs_logit=float(np.abs(ref).max()),
                qlinear_matmul=ops.count("QLinearMatMul"),
                qlinear_conv=ops.count("QLinearConv"),
                quantize_linear=ops.count("QuantizeLinear"),
                dequantize_linear=ops.count("DequantizeLinear"),
                export_import_seconds=seconds,
                source_attention_launches=ref_counts["fused_attention_hs"],
                source_splitk_qmatmul_launches=ref_counts["splitk_qmatmul"],
                **{f"{k}_launches": v for k, v in counts.items() if v})
            assert np.isfinite(got).all() and got.shape == ref.shape
            assert mean < EXPORT_RULES[fmt], (label, fmt, mean)
            assert labels == B_F32, (label, fmt, labels)
            assert others(counts) == 0 and counts["dequantize"] > 0, counts
            if fmt == "qoperator" and label == "int8":
                assert ops.count("QLinearMatMul") == n_matmul - layers, ops
                assert ops.count("QLinearConv") == 1, ops
            elif fmt == "qoperator":
                # JAX's rule after optimize(): the narrowed last layer's
                # values carry no params of their source names, so its
                # MatMuls keep the float form
                assert ops.count("QLinearMatMul") > 0, ops
            reimported.setdefault(fmt, loaded)
            launches[f"{label}_{fmt}"] = counts

    with tempfile.TemporaryDirectory() as tmp:
        w4 = model.quantize(stats=stats, quantize_conv=True,
                            **WEIGHT_CONFIGS["w4a8"])
        assert w4.pack_weights() == PACKED_PER_FORWARD
        for label, qm, mode in (("int8", q8, "unpack"),
                                ("w4a8_packed", w4, "kernel")):
            path = os.path.join(tmp, f"{label}.onnx")
            t0 = time.perf_counter()
            save_qmodel(qm, path, proto)
            saved = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = load_qmodel(path)
            loaded_s = time.perf_counter() - t0
            assert back.device.type == "cuda"
            for dtype, xin in (("f32", x8), ("bf16", x)):
                with (config.low_precision_floats() if dtype == "bf16"
                      else contextlib.nullcontext()):
                    want, cw = packed_forward(qm, xin, mode)
                    got, cg = packed_forward(back, xin, mode)
                equal = bool(np.array_equal(got, want))
                say("interop-save-load", model=label, execution=mode,
                    dtype=dtype, batch=xin.shape[0], loaded_equals_saved=equal,
                    file_mb=os.path.getsize(path) / 1e6,
                    save_seconds=saved, load_seconds=loaded_s,
                    splitk_qmatmul_launches=cg["splitk_qmatmul"],
                    dequantize_launches=cg["dequantize"])
                assert equal and np.isfinite(got).all(), (label, dtype)
                assert cg == cw, (cg, cw)
                if mode == "kernel":
                    assert cg["splitk_qmatmul"] == PACKED_PER_FORWARD, cg
        del w4

    forms = {"qdq": (reimported["qdq"], "unpack"),
             "qoperator": (reimported["qoperator"], "unpack"),
             "native_unpack": (optimized, "unpack"),
             "native_kernel": (optimized, "kernel")}
    runs = {k: [] for k in forms}
    with config.low_precision_floats():
        for turn in list(forms) + list(forms)[::-1]:
            qm, mode = forms[turn]
            runs[turn].append(images_per_s(qm, x, mode, reps=INTEROP_REPS))
        for form, (qm, mode) in forms.items():
            with packed_execution(mode):
                cost = forward_cost(lambda: qm([x], as_numpy=False))
            say("interop-serve", form=form, dtype="bf16", batch=B_SERVE,
                images_per_s=statistics.median(runs[form]),
                images_per_s_runs=",".join(f"{v:.1f}" for v in runs[form]),
                **cost, card=card.replace(" ", "_"))
    return launches


# -- phase 18: captured forwards ------------------------------------------

# each hand kernel's name in a device trace, and the wrappers counting it
TRACE_KERNELS = (("attention_hs_kernel", ("fused_attention_hs",)),
                 ("blockq_kernel", ("fused_attention_hs_blockq",)),
                 ("plain_kernel", ("fused_attention",)),
                 ("qmatmul_kernel", ("splitk_qmatmul", "packed_qmatmul")),
                 ("wo_kernel", ("splitk_wo_matmul",)),
                 ("qdq_kernel", ("quantize", "dequantize", "fake_quantize")))
CAPTURE_REPS = 10  # timed forwards per turn of a single-forward path


def eager():
    from numpy_quant_tpu_torch import config
    return config.eager_forward()


def device_rows(fn):
    """(result, [(kernel, device ms, count)]) of one profiled ``fn()``,
    50 ms of host time and a one-element fill (synchronized) on either
    side. Late in this script the tracer left out up to 4 of a replay's
    kernels, three traces in a row, where a fresh process saw them all;
    the margins keep fn's events clear of the window's edges, in case
    the device clock, mapped onto the host's, had drifted (a guess). The
    pads are two fill kernels (a few µs in the rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    pad = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        pad.fill_(0.0)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        pad.fill_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.05)
    return out, [(e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]


def hand_kernels(named_counts, mangled: bool = False) -> dict:
    """{hand kernel: count} of (kernel name, count) pairs: the demangled
    names of a trace, or the mangled symbols of a graph's nodes (where an
    identifier carries its length, as in ``10qdq_kernelI...``)."""
    import re
    out = {}
    for name, _ in TRACE_KERNELS:
        pat = rf"{len(name)}{name}(?![a-z0-9_])" if mangled \
            else rf"\b{name}\b"
        out[name] = sum(c for k, c in named_counts if re.search(pat, k))
    return out


def eager_kernels(counts: dict) -> dict:
    """{hand kernel: launches} of the eager launch counters."""
    return {name: sum(counts[w] for w in wrappers)
            for name, wrappers in TRACE_KERNELS}


def graph_check(model, counts: dict) -> tuple[str, bool]:
    """The model's one captured graph, read node by node
    (utils/profiling.py::graph_kernels), against the eager launch counters
    of the same call: ("kernel:nodes=eager;...", all equal)."""
    from numpy_quant_tpu_torch.utils.profiling import graph_kernels
    (_, nodes), = graph_kernels(model)
    seen = hand_kernels(nodes.items(), mangled=True)
    want = eager_kernels(counts)
    table = ";".join(f"{k}:{seen[k]}={want[k]}" for k in want
                     if seen[k] or want[k])
    return table, seen == want


def replay_trace(fn, counts: dict, tries: int = 3):
    """Profile ``fn()`` (one replay) until its trace shows every hand
    kernel as often as ``counts`` (the eager launch counters of the same
    call), at most ``tries`` times. Late in this script the tracer left
    out 4 of a T5 replay's 249 quantize kernels in three traces in a row,
    while the graph itself held all 249 (graph_check): a trace shows which
    kernels ran, the graph how many; and it has come back with no device
    record at all (profiled). Returns (rows of the fullest trace, its
    "kernel:seen=eager;...", its every count equal, its every hand kernel
    of the call seen at most as often as launched and at least once, the
    table of every try)."""
    history, best = [], None
    want = eager_kernels(counts)
    for _ in range(tries):
        _, rows = device_rows(fn)
        seen = hand_kernels([(k, c) for k, _, c in rows])
        table = ";".join(f"{k}:{seen[k]}={want[k]}" for k in want
                         if seen[k] or want[k])
        history.append(table)
        if best is None or sum(seen.values()) > sum(best[1].values()):
            best = rows, seen, table
        if seen == want:
            break
    rows, seen, table = best
    present = all((seen[k] > 0) == (want[k] > 0) and seen[k] <= want[k]
                  for k in want)
    return rows, table, seen == want, present, history


def pool_mb(model):
    """MB of the device segments in the model's graph memory pool, or
    None where torch's snapshot does not name a segment's pool."""
    import torch
    pool = getattr(model, "_graph_pool", None)
    if pool is None:
        return 0.0
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool)) / 1e6


def capture_seconds(model) -> float:
    return sum(e.seconds for e in model._graphs.values())


def outputs_equal(a, b) -> bool:
    return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))


def captured_forward(path: str, card: str, model, inputs: list,
                     units: int, unit: str, reps: int = CAPTURE_REPS,
                     trace_tries: int = 3, **labels) -> dict:
    """Phase 18 on a single-forward path: ``model(inputs)`` eager
    (config.eager_forward) and captured. The first captured call
    captures; a steady one must equal the eager outputs bit for bit,
    launch what eager launches, and sync the host 0 times; the captured
    graph must hold each hand kernel as often as eager launches it, and a
    trace of one replay must show each (replay_trace, at most
    ``trace_tries`` traces).
    Prints eager and captured ``unit``s/s (``units`` per forward) in
    turns (eager, captured, eager, captured), the copy into the graph's
    input buffers, the capture's seconds and pool, busy ms, the idle
    share and host µs per captured call."""
    import torch
    model.invalidate_graphs()

    def call():
        return model(inputs, as_numpy=False)

    with eager():
        ref, counts_eager = counted(call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_, counts_first), first_syncs = host_syncs(lambda: counted(call))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (out, counts_steady), steady_syncs = host_syncs(lambda: counted(call))
    equal = outputs_equal(out, ref)
    graph_table, graph_equal = graph_check(model, counts_eager)
    rows, table, trace_equal, present, traces = replay_trace(
        call, counts_eager, trace_tries)
    busy = sum(ms for _, ms, _ in rows)
    walls = {"eager": [], "captured": []}
    host = []
    for mode in ("eager", "captured", "eager", "captured"):
        with eager() if mode == "eager" else contextlib.nullcontext():
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                h0 = time.perf_counter()
                call()
                if mode == "captured":
                    host.append(time.perf_counter() - h0)
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) / reps)
    eager_s = statistics.median(walls["eager"])
    captured_s = statistics.median(walls["captured"])
    copied = sum(t.numel() * t.element_size() for t in inputs
                 if isinstance(t, torch.Tensor))
    res = dict(path=path, **labels,
               captured_equals_eager_bitwise=equal,
               kernels_in_graph_eq_eager=graph_table,
               kernels_in_replay_trace_eq_eager=table,
               trace_equals_eager=trace_equal,
               trace_tries=len(traces), traces="|".join(traces),
               launches_equal_eager=counts_steady == counts_eager,
               first_call_launches_equal_eager=counts_first == counts_eager,
               first_call_syncs=sum(first_syncs.values()),
               steady_replay_syncs=sum(steady_syncs.values()),
               copied_bytes_per_call=copied, capture_s=capture_seconds(model),
               first_call_s=first_s, pool_mb=pool_mb(model),
               **{f"eager_{unit}_per_s": units / eager_s,
                  f"captured_{unit}_per_s": units / captured_s},
               eager_ms=eager_s * 1e3, captured_ms=captured_s * 1e3,
               ms_runs_eager=",".join(f"{w * 1e3:.2f}" for w in walls["eager"]),
               ms_runs_captured=",".join(f"{w * 1e3:.2f}"
                                         for w in walls["captured"]),
               speedup=eager_s / captured_s, busy_ms=busy,
               idle_share=max(0.0, 1 - busy / (captured_s * 1e3)),
               host_us_per_call=statistics.median(host) * 1e6,
               card=card.replace(" ", "_"))
    say("captured", **{k: v for k, v in res.items() if k != "path"},
        at=path)
    assert equal, f"{path}: captured outputs differ from eager"
    assert graph_equal and present, (path, graph_table, traces)
    assert counts_steady == counts_eager, (path, counts_steady, counts_eager)
    assert counts_first == counts_eager, (path, counts_first, counts_eager)
    assert res["steady_replay_syncs"] == 0, (path, steady_syncs)
    CAPTURED.append(res)
    return res


class StepProbe:
    """A step model as a decode loop or the engine calls it: per call, the
    host seconds, the host syncs, the bytes copied into the captured
    graph's input buffers and those read in place, the captured graphs
    after it; the last call's arguments (one more replay of them is
    profiled)."""

    def __init__(self, model):
        self.__dict__.update(_model=model, log=[], last=None)

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, inputs, **kw):
        import torch
        inplace = set(kw.get("inplace", ()))
        sizes = [t.numel() * t.element_size() if isinstance(t, torch.Tensor)
                 else 0 for t in inputs]
        t0 = time.perf_counter()
        out, syncs = host_syncs(lambda: self._model(inputs, **kw))
        self.log.append(dict(
            host_s=time.perf_counter() - t0, syncs=sum(syncs.values()),
            copied=sum(s for i, s in enumerate(sizes) if i not in inplace),
            in_place=sum(s for i, s in enumerate(sizes) if i in inplace),
            graphs=tuple(id(g) for g in self._model._graphs.values())))
        self.__dict__["last"] = (list(inputs), dict(kw))
        return out


def captured_decode(path: str, card: str, model, run, equal, tokens,
                    **labels) -> dict:
    """Phase 18 on a decode path: ``run(step_model) -> (result, steps)``
    (generate_kv or an engine drain) eager and captured, through a
    StepProbe. The captured run's result must ``equal`` the eager one, its
    launches the eager run's; a steady captured run (the graph captured
    in the first) syncs the host 0 times inside any step call, copies no
    KV cache and captures at most once, at its first step call (a new
    engine's own caches); the graph holds each hand kernel as often as one
    eager step call launches it, and a trace of one replay of the last
    step shows each (replay_trace). ``tokens(result)``
    counts the generated tokens. ms/step and tokens/s in turns (eager,
    captured, eager, captured)."""
    import torch
    model.invalidate_graphs()
    probe = StepProbe(model)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with eager():
        ((ref, steps), counts_eager), wall_e = timed(
            lambda: counted(lambda: run(probe)))
    eager_calls = len(probe.log)
    ((first, _), counts_first), first_s = timed(
        lambda: counted(lambda: run(probe)))
    del probe.log[:]
    before = tuple(id(g) for g in model._graphs.values())
    (steady, _), wall_c = timed(lambda: run(probe))
    steady_log = list(probe.log)
    # captures in the steady run: none for a decode loop over the model's
    # kept caches; one, at its first step, for a new engine (its own caches)
    seen = [before] + [e["graphs"] for e in steady_log]
    captures = [i for i in range(1, len(seen)) if seen[i] != seen[i - 1]]
    args, kw = probe.last
    with eager():
        _, counts_step = counted(lambda: model(args, **kw))
    graph_table, graph_equal = graph_check(model, counts_step)
    rows, table, trace_equal, present, traces = replay_trace(
        lambda: model(args, **kw), counts_step)
    busy = sum(ms for _, ms, _ in rows)
    walls = {"eager": [wall_e], "captured": [wall_c]}
    for mode in ("eager", "captured"):
        with eager() if mode == "eager" else contextlib.nullcontext():
            walls[mode].append(timed(lambda: run(probe))[1])
    eager_s = statistics.median(walls["eager"])
    captured_s = statistics.median(walls["captured"])
    n_tok = tokens(ref)
    res = dict(path=path, **labels, steps=steps,
               captured_equals_eager=equal(first, ref) and equal(steady, ref),
               kernels_in_graph_eq_eager=graph_table,
               kernels_in_replay_trace_eq_eager=table,
               trace_equals_eager=trace_equal,
               trace_tries=len(traces), traces="|".join(traces),
               launches_equal_eager=counts_first == counts_eager,
               step_calls=eager_calls,
               steady_run_captures_at_calls=",".join(
                   str(i) for i in captures) or "none",
               steady_syncs_max_per_call=max(
                   e["syncs"] for i, e in enumerate(steady_log, 1)
                   if i not in captures),
               copied_bytes_per_call=statistics.median(
                   e["copied"] for e in steady_log),
               in_place_bytes_per_call=statistics.median(
                   e["in_place"] for e in steady_log),
               capture_s=capture_seconds(model), first_run_s=first_s,
               pool_mb=pool_mb(model),
               eager_ms_per_step=eager_s / steps * 1e3,
               captured_ms_per_step=captured_s / steps * 1e3,
               eager_tokens_per_s=n_tok / eager_s,
               captured_tokens_per_s=n_tok / captured_s,
               s_runs_eager=",".join(f"{w:.3f}" for w in walls["eager"]),
               s_runs_captured=",".join(f"{w:.3f}" for w in walls["captured"]),
               speedup=eager_s / captured_s, busy_ms_per_step=busy,
               idle_share=max(0.0, 1 - busy / (captured_s / steps * 1e3)),
               host_us_per_call=statistics.median(
                   e["host_s"] for e in steady_log) * 1e6,
               card=card.replace(" ", "_"))
    say("captured", **{k: v for k, v in res.items() if k != "path"},
        at=path)
    assert res["captured_equals_eager"], f"{path}: captured != eager"
    assert graph_equal and present, (path, graph_table, traces)
    assert counts_first == counts_eager, (path, counts_first, counts_eager)
    assert res["steady_syncs_max_per_call"] == 0, (path, steady_log)
    assert captures in ([], [1]), (path, captures)
    # the dense caches are the graph's own input buffers: never copied
    assert 0 < res["copied_bytes_per_call"] < res["in_place_bytes_per_call"]
    CAPTURED.append(res)
    return res


CAPTURED: list = []


# -- phase 19: the PTQ accuracy passes ---------------------------------------
PTQ_CALIB, PTQ_EVAL, PTQ_EVAL_B = 32, 256, 32  # 19a images: calib, held out
PTQ_PCT = 99.99  # 19a's percentile row
PTQ_IPS_REPS = 10  # timed bf16 B=96 replays per 19a row
PTQ_GPTQ_CALIB = 8  # random images GPTQ reads on 12-layer ViT-Base (19b)
PTQ_WO_M = (B_F32 * N_TOK, B_SERVE * N_TOK)  # splitk_wo_matmul's ViT rows
REPARAM_TOL = 1e-3  # float logits after an exact rewrite, of max|logits|
# the JAX package's capstone rules (tests/long_running/
# test_modsum_capstone.py) over the accuracy ladder's rows
MODSUM_RULES = (
    ("float >= 0.999", lambda r: r["float"] >= 0.999),
    ("w4-perchan-plain >= 0.995", lambda r: r["w4-perchan-plain"] >= 0.995),
    ("w4a8-perchan-plain >= 0.995",
     lambda r: r["w4a8-perchan-plain"] >= 0.995),
    ("w2a8 plain <= 0.96", lambda r: r["w2a8-perchan-plain"] <= 0.96),
    ("w2a8 gptq >= 0.995", lambda r: r["w2a8-perchan-gptq"] >= 0.995),
    ("w2a8 adaround >= plain + 0.02",
     lambda r: r["w2a8-perchan-adaround"] >= r["w2a8-perchan-plain"] + 0.02),
    ("w3 per-tensor plain <= 0.9", lambda r: r["w3-pertensor-plain"] <= 0.9),
    ("|w3 per-tensor awq - plain| <= 0.1",
     lambda r: abs(r["w3-pertensor-awq"] - r["w3-pertensor-plain"]) <= 0.1))
# the ladder's rows those rules read: the script runs these alone (the
# whole ladder is `python -m numpy_quant_tpu_torch.accuracy_ladder`)
MODSUM_ROWS = ("float", "w4-perchan-plain", "w4a8-perchan-plain",
               "w2a8-perchan-plain", "w2a8-perchan-gptq",
               "w2a8-perchan-adaround", "w3-pertensor-plain",
               "w3-pertensor-awq")


def synced_seconds(fn):
    """(fn(), wall seconds with the device synchronized after it)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def exact_rewrite(label: str, model, batches: list, ref) -> float:
    """The float logits of ``model`` (eager, over each input list of
    ``batches``) after an exact reparameterization against ``ref`` before
    it: max |diff| / max|ref|, which must stay within REPARAM_TOL."""
    import numpy as np
    with eager():
        got = np.concatenate([model(b)[0] for b in batches])
    rel = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
    say("ptq-reparam", rewrite=label, max_diff_over_max_logit=rel,
        tolerance=REPARAM_TOL)
    assert rel <= REPARAM_TOL, (label, rel)
    return rel


def margin_parted(got, want) -> tuple[int, int, float]:
    """(rows whose labels part, rows of them whose top-2 margin exceeds
    twice the measured max |logit diff| -- the decode margin rule: a row
    may part only where the two top logits lie within the difference --,
    that max |diff|)."""
    import numpy as np
    diff = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    parted = got.argmax(1) != want.argmax(1)
    clear = (top2[:, 1] - top2[:, 0]) > 2 * diff
    return int(parted.sum()), int((parted & clear).sum()), diff


def ptq_fixture_phase(card: str) -> dict:
    """Phase 19a: the trained ViT-Base-width fixture (2 layers) through
    every accuracy pass. Each row: held-out accuracy on PTQ_EVAL images,
    label agreement and max |logit diff| against float, the pass's
    seconds; then optimize() + pack_weights() (weight-only rows:
    quantize_weights(4, group_size=128, pack=True)), the f32 held-out
    logits under "kernel" equal to "unpack" (bit for bit; weight-only rows
    under the margin rule), and a captured bf16 B=96 "kernel" forward:
    images/s, its launches, equal to "unpack" bit for bit (weight-only:
    labels under the margin rule). Returns {row: launches per bf16
    forward}."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models import fixtures as F
    from numpy_quant_tpu_torch.models.vit import WEIGHT_CONFIGS
    from numpy_quant_tpu_torch.utils.calibration import (kl_calibrated_stats,
                                                         mse_clipped_stats)
    from numpy_quant_tpu_torch.utils.sensitivity import plan_mixed_precision
    t_phase = time.perf_counter()
    size = F.BASE_IMAGE_SIZE
    layers = F.BASE_FIXTURE_CONFIG["num_hidden_layers"]
    proto = F.trained_vit_base_onnx()
    calib = torch.from_numpy(F.make_batch(np.random.default_rng(7),
                                          PTQ_CALIB, size)[0]).cuda()
    x_eval, y_eval = F.make_batch(np.random.default_rng(1), PTQ_EVAL, size)
    xs = [torch.from_numpy(x_eval[i:i + PTQ_EVAL_B]).cuda()
          for i in range(0, PTQ_EVAL, PTQ_EVAL_B)]
    x96 = torch.from_numpy(x_eval[:B_SERVE]).cuda()

    def fresh():
        return Model.from_onnx(proto)

    def logits(model, mode="unpack"):
        with eager(), packed_execution(mode):
            return np.concatenate([model([x])[0] for x in xs])

    fm = fresh()
    ref = logits(fm)
    flabels = ref.argmax(1)
    stats, stats_s = synced_seconds(lambda: fm.calibration_stats([calib]))
    q8 = dict(bit_width=8, quantize_conv=True)
    w4a8 = dict(WEIGHT_CONFIGS["w4a8"], quantize_conv=True)
    w3a8 = dict(WEIGHT_CONFIGS["w3a8"], quantize_conv=True)

    def quantized(kw, passes=()):
        q = fm.quantize(stats=stats, **kw)
        for p in passes:
            if p == "bias":
                q.correct_biases(fm, [calib])
            else:
                getattr(q, p)(fm, [calib])
        return q

    def smooth():
        m = fresh()
        m.smooth_outliers([calib], alpha=0.5)
        exact_rewrite("smooth_outliers", m, [[x] for x in xs], ref)
        return m.quantize([calib], **q8)

    def rotated():
        m = fresh()
        m.rotate_vo(seed=0)
        exact_rewrite("rotate_vo", m, [[x] for x in xs], ref)
        return m.quantize([calib], **w3a8)

    def mixed():
        plan = plan_mixed_precision(fm, [calib], low_frac=0.5, bit_width=8,
                                    low_bits=4, stats=stats,
                                    quantize_conv=True)
        say("ptq-plan", low_weights=len(plan), names="|".join(sorted(plan)))
        return fm.quantize(stats=stats, weight_bit_width=plan, **q8)

    def weight_only(awq: bool):
        m = fresh()
        if awq:
            alphas = m.awq_scale_weights([calib], bit_width=4,
                                         group_size=WO_GROUP)
            say("ptq-awq", alphas=",".join(f"{a:g}" for a in alphas.values()))
            exact_rewrite("awq_scale_weights", m, [[x] for x in xs], ref)
        m.quantize_weights(bit_width=4, group_size=WO_GROUP, pack=True)
        return m

    rows = {
        "float": ("float", lambda: fm),
        "int8": ("static", lambda: quantized(q8)),
        "int8_p99.99": ("static", lambda: fm.quantize(
            stats=fm.calibration_stats([calib], percentile=PTQ_PCT), **q8)),
        "int8_mse": ("static", lambda: fm.quantize(
            stats=mse_clipped_stats(fm, [calib]), **q8)),
        "int8_kl": ("static", lambda: fm.quantize(
            stats=kl_calibrated_stats(fm, [calib]), **q8)),
        "int8_smoothquant": ("static", smooth),
        "w4a8": ("static", lambda: quantized(w4a8)),
        "w4a8_gptq": ("static", lambda: quantized(w4a8, ("gptq",))),
        "w4a8_adaround": ("static", lambda: quantized(w4a8, ("adaround",))),
        "w4a8_gptq_bias": ("static", lambda: quantized(w4a8,
                                                       ("gptq", "bias"))),
        "w3a8": ("static", lambda: quantized(w3a8)),
        "w3a8_rotate_vo": ("static", rotated),
        "mixed_w4_w8": ("static", mixed),
        "wo_w4_g128": ("weight_only", lambda: weight_only(False)),
        "wo_w4_g128_awq": ("weight_only", lambda: weight_only(True)),
        "dynamic_int8_row": ("dynamic",
                             lambda: fm.quantize_dynamic(8, granularity="row")),
    }
    launches = {}
    for row, (kind, build) in rows.items():
        model, seconds = synced_seconds(build)
        if kind == "static":
            report = model.optimize()
            assert not report["fusion_failures"], report
            assert report["fuse_attention"] == layers, report
            assert model.pack_weights() == 6 * layers
        kernel = logits(model, "kernel")
        unpack = logits(model, "unpack") if kind != "float" else kernel
        if kind == "weight_only":
            parted, clear, kdiff = margin_parted(kernel, unpack)
            equal = clear == 0
        else:
            parted, clear, kdiff = 0, 0, float(np.abs(kernel - unpack).max())
            equal = bool(np.array_equal(kernel, unpack))
        fields = dict(
            row=row, accuracy=float((kernel.argmax(1) == y_eval).mean()),
            labels_equal_float=f"{int((kernel.argmax(1) == flabels).sum())}"
                               f"/{PTQ_EVAL}",
            max_abs_dlogit=float(np.abs(kernel - ref).max()),
            mean_abs_dlogit=float(np.abs(kernel - ref).mean()),
            pass_s=seconds + (stats_s if row in ("int8", "w4a8", "w3a8")
                              else 0.0),
            f32_kernel_equals_unpack=equal, f32_kernel_unpack_max_diff=kdiff,
            labels_parted=parted)
        if kind != "float":
            with config.low_precision_floats(), packed_execution("kernel"):
                out_k, counts = counted(lambda: model([x96])[0])
                ips = images_per_s(model, x96, "kernel", reps=PTQ_IPS_REPS)
            with config.low_precision_floats(), packed_execution("unpack"):
                out_u = model([x96])[0]
            if kind == "weight_only":
                b_parted, b_clear, _ = margin_parted(out_k, out_u)
                bf16_equal = b_clear == 0
            else:
                b_parted, bf16_equal = 0, same_bits(out_k, out_u)
            launches[row] = counts
            fields.update(images_per_s_bf16_b96_kernel=ips,
                          bf16_kernel_equals_unpack=bf16_equal,
                          bf16_labels_parted=b_parted,
                          **{f"launches_{k}": v for k, v in counts.items()
                             if v})
            assert bf16_equal, f"{row}: bf16 kernel != unpack"
            assert np.isfinite(out_k).all()
            kname = {"static": "packed_qmatmul" if row.startswith("w3a8")
                     else "splitk_qmatmul",
                     "weight_only": "splitk_wo_matmul"}.get(kind)
            if kname is not None:
                assert counts[kname] >= 6 * layers, (row, counts)
            if kind == "static":
                assert counts["fused_attention_hs"] == layers, (row, counts)
        say("ptq-row", **fields, card=card.replace(" ", "_"))
        assert equal, f"{row}: f32 kernel != unpack"
        if model is not fm:
            del model
        torch.cuda.empty_cache()
    say("ptq-fixture-phase", seconds=time.perf_counter() - t_phase)
    return launches


def ptq_vit_base_phase(card: str) -> dict:
    """Phase 19b, the passes' main path: 12-layer ViT-Base (random weights,
    seed 0), W4A8 per channel; GPTQ on every 2-D weight, timed on the
    card; then optimize() + pack_weights() (72) and the captured bf16 B=96
    "kernel" forward, counted (the counts set to 0 just before), images/s
    beside plain W4A8's (in turns), mean |dlogit| against float for both
    (f32, B=96; reported). Returns the GPTQ forward's launch counts."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models.vit import (VIT_BASE, WEIGHT_CONFIGS,
                                                  random_vit_weights,
                                                  vit_image_classifier)
    t_phase = time.perf_counter()
    fm = Model.from_onnx(vit_image_classifier(
        random_vit_weights(VIT_BASE, seed=0), VIT_BASE))
    rng = np.random.default_rng(19)
    calib = torch.from_numpy(rng.normal(size=(PTQ_GPTQ_CALIB, 3, 224, 224))
                             .astype(np.float32) * 0.5).cuda()
    x = torch.from_numpy(rng.normal(size=(B_SERVE, 3, 224, 224))
                         .astype(np.float32) * 0.5).cuda()
    with eager():
        ref = fm([x])[0]
    stats = fm.calibration_stats([calib])
    kw = dict(WEIGHT_CONFIGS["w4a8"], quantize_conv=True)
    plain = fm.quantize(stats=stats, **kw)
    gptq = fm.quantize(stats=stats, **kw)
    tuned, gptq_s = synced_seconds(lambda: gptq.gptq(fm, [calib]))
    del fm
    res = {}
    for label, q in (("plain", plain), ("gptq", gptq)):
        q.optimize()
        assert q.pack_weights() == PACKED_PER_FORWARD
        with eager(), packed_execution("kernel"):
            y = q([x])[0]
        res[label] = float(np.abs(y - ref).mean())
    ips = {"plain": [], "gptq": []}
    with config.low_precision_floats():
        with packed_execution("kernel"):
            for label, q in (("plain", plain), ("gptq", gptq)):
                q([x])
            out, counts = counted(lambda: gptq([x])[0])
        for label in ("plain", "gptq", "gptq", "plain"):
            q = plain if label == "plain" else gptq
            ips[label].append(images_per_s(q, x, "kernel",
                                           reps=PTQ_IPS_REPS))
    say("ptq-vit-base", layers=VIT_BASE["num_hidden_layers"],
        gptq_weights=tuned, gptq_s=gptq_s, calib_images=PTQ_GPTQ_CALIB,
        images_per_s_bf16_b96_gptq=statistics.median(ips["gptq"]),
        images_per_s_bf16_b96_plain=statistics.median(ips["plain"]),
        runs_gptq=",".join(f"{v:.1f}" for v in ips["gptq"]),
        runs_plain=",".join(f"{v:.1f}" for v in ips["plain"]),
        mean_abs_dlogit_f32_gptq=res["gptq"],
        mean_abs_dlogit_f32_plain=res["plain"],
        **{f"launches_{k}": v for k, v in counts.items()},
        seconds=time.perf_counter() - t_phase, card=card.replace(" ", "_"))
    assert tuned == PACKED_PER_FORWARD + 1, tuned  # and the classifier Gemm
    assert np.isfinite(out).all()
    assert counts["splitk_qmatmul"] == PACKED_PER_FORWARD, counts
    assert counts["fused_attention_hs"] == 12, counts
    for kname in ("quantize", "dequantize"):
        assert counts[kname] > 0, counts
    return counts


def ptq_llama_phase(card: str, weights) -> dict:
    """Phase 19c: TinyLlama-1.1B int8 prefill (P = PREFILL_N, B=1, full
    width and depth): smooth_outliers(alpha=0.5) leaves the float logits
    within REPARAM_TOL; then calibration, quantize(8), optimize() (22
    plain fusions) and the fused f32 forward, counted: 22 fused_attention
    launches, equal to the unfused forward bit for bit wherever torch sums
    the rows in the kernel's order (probed). Returns the counts."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.models.llama import llama_prefill
    t_phase = time.perf_counter()
    cfg, n = tinyllama(), PREFILL_N
    layers, vocab = cfg["num_hidden_layers"], cfg["vocab_size"]
    proto = llama_prefill(weights, cfg, n)
    wte = proto._wte
    model = Model.from_onnx(proto)
    del proto
    rng = np.random.default_rng(191)
    calib = wte[rng.integers(0, vocab, size=(2, n))]
    x = torch.from_numpy(wte[rng.integers(0, vocab, size=(1, n))]).cuda()
    with eager():
        before = model([x])[0]
    groups, smooth_s = synced_seconds(
        lambda: model.smooth_outliers([calib], alpha=0.5))
    rel = exact_rewrite("smooth_outliers_tinyllama", model, [[x]], before)
    qmodel = model.quantize(bit_width=8,
                            stats=model.calibration_stats([calib]))
    del model

    def forward():
        return qmodel([x], as_numpy=False)

    unfused = forward()
    report = qmodel.optimize()
    fused, counts = counted(forward)
    equal = all(torch.equal(a, b) for a, b in zip(fused, unfused))
    in_order = exact_in_order(cfg["num_attention_heads"] * A.plain_tile(n), n)
    say("ptq-llama", prefill=n, smoothed_groups=groups, smooth_s=smooth_s,
        float_max_diff_over_max_logit=rel,
        fuse_attention=report["fuse_attention"],
        fused_attention_launches=counts["fused_attention"],
        fused_equals_unfused_bitwise=equal, in_torch_order=in_order,
        seconds=time.perf_counter() - t_phase, card=card.replace(" ", "_"))
    assert groups == 2 * layers + 1, groups
    assert report["fuse_attention"] == layers, report
    assert counts["fused_attention"] == layers, counts
    assert all(bool(t.isfinite().all()) for t in fused)
    assert not in_order or equal, "smoothed prefill: fused != unfused"
    return counts


def ptq_modsum_phase(card: str) -> dict:
    """Phase 19d: the modular-sum accuracy ladder (accuracy_ladder.py) at
    B=256 on the card, its rows that the JAX package's capstone rules
    read, held to those rules."""
    from numpy_quant_tpu_torch.accuracy_ladder import ladder
    t_phase = time.perf_counter()
    rows = ladder(emit=lambda line: say("ptq-modsum", row=line.replace(
        " ", "")), only=set(MODSUM_ROWS))
    assert set(rows) == set(MODSUM_ROWS), sorted(rows)
    held = {rule: bool(check(rows)) for rule, check in MODSUM_RULES}
    say("ptq-modsum-rules", **{k.replace(" ", "_"): v
                               for k, v in held.items()},
        seconds=time.perf_counter() - t_phase, card=card.replace(" ", "_"))
    assert all(held.values()), held
    return rows


def ptq_t5_phase(card: str) -> dict:
    """Phase 19e: T5-small at full width and depth, B=2, 512 + 128:
    equalize() on the 12 ReLU feed-forward pairs leaves the float logits
    within REPARAM_TOL; then quantize(8) and optimize(): the scoring
    forward launches both head-split kernels (6 blockwise encoder, 12
    monolithic decoder). Returns the counts."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.t5 import (T5_SMALL, random_t5_weights,
                                                 t5_conditional_generation)
    t_phase = time.perf_counter()
    cfg, vocab = T5_SMALL, T5_SMALL["vocab_size"]
    proto = t5_conditional_generation(random_t5_weights(cfg, seed=0), cfg,
                                      batch_size=2, src_len=T5_SRC,
                                      tgt_len=T5_TGT)
    wte = proto._wte
    model = Model.from_onnx(proto)
    del proto
    rng = np.random.default_rng(195)
    calib = [wte[rng.integers(0, vocab, size=(2, k))]
             for k in (T5_SRC, T5_TGT)]
    x = [torch.from_numpy(wte[rng.integers(0, vocab, size=(2, k))]).cuda()
         for k in (T5_SRC, T5_TGT)]
    with eager():
        before = model(x)[0]
    pairs, eq_s = synced_seconds(model.equalize)
    rel = exact_rewrite("equalize_t5", model, [x], before)
    qmodel = model.quantize(bit_width=8, stats=model.calibration_stats(calib))
    report = qmodel.optimize()
    out, counts = counted(lambda: qmodel(x)[0])
    layers = cfg["num_layers"]
    say("ptq-t5", pairs=pairs, equalize_s=eq_s,
        float_max_diff_over_max_logit=rel, tolerance=REPARAM_TOL,
        fuse_attention=report["fuse_attention"],
        blockq_launches=counts["fused_attention_hs_blockq"],
        hs_launches=counts["fused_attention_hs"],
        seconds=time.perf_counter() - t_phase, card=card.replace(" ", "_"))
    assert pairs == 2 * layers, pairs
    assert np.isfinite(out).all()
    assert counts["fused_attention_hs_blockq"] == layers, counts
    assert counts["fused_attention_hs"] == 2 * layers, counts
    return counts


def ptq_phase(card: str, name: str, llama_weights) -> dict:
    """Phase 19: 19a-e in turn, with splitk_wo_matmul held against its
    plain version and timed at the ViT rows M = 8 * 197 and 96 * 197.
    Returns each path's launch counts and the kernel times."""
    t0 = time.perf_counter()
    wo = {m: time_wo(name, QMM_SHAPES, "vit_base", m=m) for m in PTQ_WO_M}
    res = dict(wo=wo, fixture=ptq_fixture_phase(card))
    res["vit_base"] = ptq_vit_base_phase(card)
    res["llama"] = ptq_llama_phase(card, llama_weights)
    res["modsum"] = ptq_modsum_phase(card)
    res["t5"] = ptq_t5_phase(card)
    say("ptq-phase", seconds=time.perf_counter() - t0,
        card=card.replace(" ", "_"))
    return res


# -- phase 20: the CNN and GNN zoo -------------------------------------------

ZOO_B, ZOO_IMAGE = 32, 224
# ResNet-18's stage widths (He et al. 2016, Table 1; one basic block per
# stage as the graph draws it) and MobileNet-V1's channel progression
# (Howard et al. 2017, Table 1), both with ImageNet's 1000 classes
RESNET18_WIDTHS = (64, 128, 256, 512)
MOBILENET_V1_WIDTHS = (64, 128, 256, 512, 1024)
# Cora (Kipf & Welling 2017): nodes, directed edges, bag-of-words
# features (binary, ~1.27% set), hidden units, classes
CORA = dict(n_nodes=2708, n_edges=10556, in_feat=1433, hidden=16,
            n_classes=7)
CORA_FEATURE_DENSITY = 0.0127
# the small models at their default widths, at ZOO_B (LSTM: ZOO_SEQ steps)
ZOO_SEQ = 32
ZOO_FLOAT_TOL = 1e-4  # float forward against the torch oracle, x max|logit|
FOLD_TOL = 1e-5       # folded against unfolded ResNet, x max|logit|
ZOO_REPS = 3          # timed forwards per turn in phase 20's captured checks
ZOO_KERNELS = ("quantize", "dequantize", "splitk_qmatmul")


@contextlib.contextmanager
def shadowed(state: dict, extra: tuple = (), note=None):
    """Every quantize, dequantize, fake-quantize and packed-matmul launch of
    the forwards
    inside also runs the kernel's plain version on the same operands;
    ``state[kernel]`` gathers [calls, mismatching outputs, max |diff|,
    max |plain output|]. ``extra``: more (module, wrapper name, plain
    version) to shadow; ``note(name, args, kwargs, got, want)``, if given,
    sees each shadowed launch. The forwards walk eagerly (a replay runs no
    Python)."""
    import torch
    from numpy_quant_tpu_torch import config
    from numpy_quant_tpu_torch.kernels import elementwise as E
    from numpy_quant_tpu_torch.kernels import qmatmul as Q

    def shadow(mod, name, ref):
        fn = getattr(mod, name)

        def run(*a, **kw):
            # the wrapper counts its launch on its module-level name
            setattr(mod, name, fn)
            try:
                got = fn(*a, **kw)
            finally:
                setattr(mod, name, run)
            if not (isinstance(got, torch.Tensor) and got.is_cuda):
                return got
            want = ref(*a, **kw)
            row = state.setdefault(name, [0, 0, 0.0, 0.0])
            row[0] += 1
            if not same_bits(got, want):
                row[1] += int((got != want).sum())
            row[2] = max(row[2], float((got.double() - want.double())
                                       .abs().max()))
            row[3] = max(row[3], float(want.double().abs().max()))
            if note is not None:
                note(name, a, kw, got, want)
            return got
        return run

    saved = [(m, n, getattr(m, n), getattr(m, n + "_reference")) for m, n in
             ((E, "quantize"), (E, "dequantize"), (E, "fake_quantize"),
              (Q, "splitk_qmatmul"), (Q, "packed_qmatmul"))]
    saved += [(m, n, getattr(m, n), ref) for m, n, ref in extra]
    for m, n, _, ref in saved:
        setattr(m, n, shadow(m, n, ref))
    try:
        with config.eager_forward():
            yield state
    finally:
        for m, n, f, _ in saved:
            setattr(m, n, f)


def depthwise_plain(xq, wq, zp: int, pads, strides, dils):
    """A depthwise conv's zero-point-corrected accumulator in plain int64
    ops: sum over the window of (x - zp) * w, x padded with zp."""
    import torch
    import torch.nn.functional as F
    ph0, pw0, ph1, pw1 = pads
    x = F.pad(xq.to(torch.int64), (pw0, pw1, ph0, ph1), value=zp) - zp
    w = wq.to(torch.int64)
    o, _, kh, kw = w.shape
    sh, sw = strides
    dh, dw = dils
    oh = (x.shape[2] - dh * (kh - 1) - 1) // sh + 1
    ow = (x.shape[3] - dw * (kw - 1) - 1) // sw + 1
    acc = torch.zeros((x.shape[0], o, oh, ow), dtype=torch.int64,
                      device=x.device)
    for i in range(kh):
        for j in range(kw):
            tap = x[:, :, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                    j * dw:j * dw + (ow - 1) * sw + 1:sw]
            acc += tap * w[:, 0, i, j].reshape(1, o, 1, 1)
    return acc


def grouped_conv_check(qmodel, x) -> list:
    """Each grouped int8 Conv of ``qmodel`` on its operands of one recorded
    forward: the accumulator of tensor.qconv2d (one batched float64
    product) against depthwise_plain's int64 version, bit for bit.
    Returns (node, groups, outputs) per Conv."""
    import torch
    from numpy_quant_tpu_torch.graph import Constant
    from numpy_quant_tpu_torch.tensor import qconv2d
    with eager():
        qmodel([x], record=True)
    data = {v.name: qmodel._wrap_constant(v) if isinstance(v, Constant)
            else v.data for v in qmodel.values}
    rows = []
    for node in qmodel.nodes:
        group = int(node.attrs.get("group", 1))
        if node.op != "Conv" or group == 1:
            continue
        xq, wq = qmodel._node_inputs(node, data)[:2]
        pads = tuple(node.attrs.get("pads", (0, 0, 0, 0)))
        strides = tuple(node.attrs.get("strides", (1, 1)))
        dils = tuple(node.attrs.get("dilations", (1, 1)))
        assert wq.data.shape[1] == 1, "the zoo's grouped convs are depthwise"
        acc = qconv2d(xq, wq, None, pads, strides, dils, group)
        got = acc.data.to(torch.int64)
        if acc.zero_point is not None:
            got = got - acc.zero_point.to(torch.int64)
        zp = 0 if xq.zero_point is None else int(xq.zero_point)
        want = depthwise_plain(xq.data, wq.data, zp, pads, strides, dils)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        rows.append((node.name, group, got.numel()))
        say("zoo-grouped-conv", node=node.name, groups=group,
            k=int(wq.data.shape[2] * wq.data.shape[3]),
            shape="x".join(str(d) for d in got.shape),
            accumulator_equals_int64_plain=equal)
        assert equal, f"{node.name}: grouped conv accumulator differs"
    for v in qmodel.values:
        if not isinstance(v, Constant):
            v.data = None
    return rows


def zoo_bf16(model, inputs, units: int) -> dict:
    """The captured bf16 forward: units/s over ZOO_REPS*3 replays, and one
    profiled replay (busy ms, top kernels). Late in this script the tracer
    can leave a replay's records out (replay_trace), so up to three
    replays are profiled, until one trace holds as many device kernels as
    the captured graph has kernel nodes; the fullest trace is reported
    beside that count, and busy ms is None where no trace saw device
    time."""
    import torch
    from numpy_quant_tpu_torch import config
    from numpy_quant_tpu_torch.utils.profiling import graph_kernels
    model.invalidate_graphs()
    with config.low_precision_floats():
        model(inputs, as_numpy=False)
        model(inputs, as_numpy=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ZOO_REPS * 3):
            model(inputs, as_numpy=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (ZOO_REPS * 3) * 1e3
    (_, nodes), = graph_kernels(model)
    graph_nodes = sum(nodes.values())
    prof, tries = None, 0
    while tries < 3 and (prof is None
                         or prof["device_kernels"] < graph_nodes):
        tries += 1
        p = bf16_profile(lambda: model(inputs, as_numpy=False)[0])
        if p["device_busy_ms"] is None:  # no trace held device time
            continue
        if prof is None or p["device_kernels"] > prof["device_kernels"]:
            prof = p
    busy = None if prof is None else prof["device_busy_ms"]
    return dict(bf16_captured_ms=ms, bf16_units_per_s=units / ms * 1e3,
                busy_ms=busy, idle_share=None if busy is None
                else max(0.0, 1 - busy / ms),
                trace_kernels=None if prof is None else prof["device_kernels"],
                graph_kernel_nodes=graph_nodes, profile_tries=tries,
                top5=None if prof is None else prof["top5"])


def zoo_model(card: str, label: str, fmodel, inputs: list, oracle,
              units: int, unit: str, quantize_kw: dict, modes=("unpack",),
              pack: bool = False, grouped: bool = False) -> dict:
    """One zoo model: the float forward against ``oracle`` (the model's
    torch forward on the card), then quantize(8) -> optimize()
    [-> pack_weights()]: every quantize/dequantize/packed-matmul launch
    against its plain version (shadowed), each grouped Conv's accumulator
    against int64, per ``packed_execution`` mode the captured int8 forward
    against the eager one (phase 18's captured_forward) with the launches
    of one counted replay, "kernel" against "unpack" bit for bit, labels
    against float, and the captured bf16 forward's units/s and profile.
    Returns the launches per forward by mode."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    flt = fmodel(inputs)[0]
    want = oracle()
    scale = float(np.abs(want).max())
    fdiff = float(np.abs(flt - want).max())
    stats = fmodel.calibration_stats(inputs)
    qmodel = fmodel.quantize(bit_width=8, stats=stats, **quantize_kw)
    report = qmodel.optimize()
    packed = qmodel.pack_weights() if pack else 0
    shadow = {}
    with shadowed(shadow):
        for mode in modes:
            with packed_execution(mode):
                qmodel(inputs)
    if grouped:
        grouped_conv_check(qmodel, inputs[0])
    outs, launches = {}, {}
    for mode in modes:
        with packed_execution(mode):
            captured_forward(f"zoo_{label}", card, qmodel, inputs, units,
                             unit, reps=ZOO_REPS, dtype="f32",
                             packed_execution=mode)
            outs[mode], counts = counted(lambda: qmodel(inputs)[0])
            launches[mode] = {k: counts[k] for k in ZOO_KERNELS}
    out = outs[modes[-1]]
    kernel_eq_unpack = None
    if len(modes) > 1:
        kernel_eq_unpack = same_bits(outs["kernel"], outs["unpack"])
    with packed_execution(modes[-1]):
        bf16 = zoo_bf16(qmodel, inputs, units)
    cls = 1 if out.ndim == 4 else -1  # the segmenter's classes: axis 1
    agree = float((out.argmax(cls) == flt.argmax(cls)).mean())
    say("zoo", model=label, float_max_abs_diff_oracle=fdiff,
        max_abs_logit=scale, float_tol=ZOO_FLOAT_TOL * scale,
        nodes=len(qmodel.nodes), optimize=",".join(
            f"{k}:{v}" for k, v in report.items() if k != "fusion_failures"),
        packed=packed, kernel_equals_unpack=kernel_eq_unpack,
        label_agreement_float=agree,
        mean_abs_dlogit=float(np.abs(out - flt).mean()),
        **{f"shadow_{k}": f"{v[0]}calls:{v[1]}mismatches:{v[2]:.3g}"
           for k, v in shadow.items()},
        **{f"launches_{m}": ",".join(f"{k}:{v}" for k, v in c.items())
           for m, c in launches.items()},
        **{f"{k}": v for k, v in bf16.items()},
        **{f"bf16_{unit}_per_s": bf16["bf16_units_per_s"]},
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        seconds=time.perf_counter() - t0, card=card.replace(" ", "_"))
    assert np.isfinite(out).all() and np.isfinite(flt).all()
    assert fdiff <= ZOO_FLOAT_TOL * scale, (label, fdiff, scale)
    assert all(v[1] == 0 for v in shadow.values()), (label, shadow)
    assert shadow.get("quantize") and shadow.get("dequantize"), shadow
    for mode, c in launches.items():
        assert c["quantize"] > 0 and c["dequantize"] > 0, (label, c)
        if mode == "kernel":
            assert c["splitk_qmatmul"] > 0, (label, c)
    if kernel_eq_unpack is not None:
        assert kernel_eq_unpack, f"{label}: kernel and unpack differ"
    return launches


def zoo_phase(card: str) -> dict:
    """Phase 20: the CNN and GNN zoo at full width. Returns each model's
    launches per forward."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models import cnn, gnn
    t_phase = time.perf_counter()
    rng = np.random.default_rng(20)
    res = {}
    x = rng.standard_normal((ZOO_B, 3, ZOO_IMAGE, ZOO_IMAGE)) \
        .astype(np.float32)
    xd = torch.from_numpy(x).cuda()

    # ResNet-18 widths: fold_batchnorm -> quantize(8, quantize_conv)
    proto = cnn.resnet_classifier(batch=ZOO_B, image_size=ZOO_IMAGE,
                                  widths=RESNET18_WIDTHS, n_classes=1000)
    model = Model.from_onnx(proto)
    unfolded = model([xd])[0]
    folded_n = model.fold_batchnorm()
    folded = model([xd])[0]
    fold_diff = float(np.abs(folded - unfolded).max())
    fold_scale = float(np.abs(unfolded).max())
    say("zoo-fold", model="resnet18", folded=folded_n,
        max_abs_diff=fold_diff, max_abs_logit=fold_scale,
        tol=FOLD_TOL * fold_scale)
    assert folded_n == 1 + 2 * len(RESNET18_WIDTHS) + 3, folded_n
    assert fold_diff <= FOLD_TOL * fold_scale, (fold_diff, fold_scale)
    res["resnet18"] = zoo_model(
        card, "resnet18", model, [xd],
        lambda: proto._torch_forward(x, device="cuda"), ZOO_B, "images",
        dict(quantize_conv=True))
    del model, proto

    proto = cnn.mobilenet_classifier(batch=ZOO_B, image_size=ZOO_IMAGE,
                                     widths=MOBILENET_V1_WIDTHS,
                                     n_classes=1000)
    res["mobilenet_v1"] = zoo_model(
        card, "mobilenet_v1", Model.from_onnx(proto), [xd],
        lambda: proto._torch_forward(x, device="cuda"), ZOO_B, "images",
        dict(quantize_conv=True), grouped=True)
    del proto

    # Cora-size GCNs, packed, under both packed_execution settings
    feats = (rng.random((CORA["n_nodes"], CORA["in_feat"]))
             < CORA_FEATURE_DENSITY).astype(np.float32)
    fd = torch.from_numpy(feats).cuda()
    proto = gnn.gcn_dense(**CORA, seed=0)
    w = {k: torch.from_numpy(v).cuda() for k, v in proto._weights.items()}

    def dense_oracle():
        h1 = torch.relu((w["a_hat"] @ fd) @ w["w1"] + w["b1"])
        return ((w["a_hat"] @ h1) @ w["w2"] + w["b2"]).cpu().numpy()

    res["gcn_dense"] = zoo_model(
        card, "gcn_dense", Model.from_onnx(proto), [fd], dense_oracle,
        CORA["n_nodes"], "nodes", {}, modes=("unpack", "kernel"), pack=True)
    proto = gnn.gcn_scatter(CORA["n_nodes"], CORA["n_edges"],
                            CORA["in_feat"], CORA["n_classes"], seed=0)
    ws = proto._weights
    src = ws["src"]

    def scatter_oracle():
        s, d = (torch.from_numpy(ws[k]).cuda() for k in ("src", "dst"))
        agg = torch.zeros_like(fd).index_add_(0, d, fd[s]) + fd
        return (agg @ torch.from_numpy(ws["w"]).cuda()
                + torch.from_numpy(ws["b"]).cuda()).cpu().numpy()

    res["gcn_scatter"] = zoo_model(
        card, "gcn_scatter", Model.from_onnx(proto), [fd, src],
        scatter_oracle, CORA["n_nodes"], "nodes", {},
        modes=("unpack", "kernel"), pack=True)
    del proto

    # the small models at their default widths
    for label, proto, inp in (
            ("cnn", cnn.cnn_classifier(batch=ZOO_B), (ZOO_B, 3, 32, 32)),
            ("unet", cnn.unet_segmenter(batch=ZOO_B), (ZOO_B, 3, 32, 32)),
            ("lstm", cnn.lstm_classifier(seq=ZOO_SEQ, batch=ZOO_B),
             (ZOO_SEQ, ZOO_B, 8))):
        xs = rng.standard_normal(inp).astype(np.float32)
        res[label] = zoo_model(
            card, label, Model.from_onnx(proto), [torch.from_numpy(xs).cuda()],
            lambda p=proto, v=xs: p._torch_forward(v, device="cuda"),
            ZOO_B, "sequences" if label == "lstm" else "images",
            dict(quantize_conv=label != "lstm"))
    say("zoo-phase", seconds=time.perf_counter() - t_phase,
        card=card.replace(" ", "_"))
    return res


# -- phase 21: encoder-decoder generation ------------------------------------
ED_B = 8                 # batch (slots) of every phase 21 path
T5_LEN, T5_SRC = 128, 512  # T5-small decode: cache slots, source tokens
T5_PROMPT, T5_NEW = 4, 28  # teacher-forced ids (start first), new tokens
ED_REQS = 16             # engine requests over ED_B slots
ED_BUDGETS = (8, 24)     # their new tokens, uniform, inclusive
BART_SRC, BART_TGT = 1024, 128
ED_NEW = 32              # new tokens of each seq2seq generation
WHISPER_TGT = 128
FIXTURE_FLOOR, FIXTURE_DROP = 0.97, 0.02  # JAX's capstone rules
ED_REPS = 3              # timed forwards per turn of a captured forward
ED_ATTN = ("fused_attention_hs", "fused_attention_hs_blockq")
ED_KERNELS = ("quantize", "dequantize", "fake_quantize", "fused_attention_hs",
              "fused_attention_hs_blockq", "fused_attention",
              "splitk_qmatmul", "packed_qmatmul", "splitk_wo_matmul")


def ed_note(shapes: dict, plans: dict):
    """A shadowed() note. Each head-split launch's shape: (kernel, nq, N,
    heads, head dim, softmax form, bias) -> [calls, flipped (row, head)
    blocks, (row, head) blocks, hs_plan's choice, exact_in_order]; the
    plain [BH, N, D] attention kernel's: ("plain", BH, N, D) -> [calls,
    mismatching outputs, outputs, exact_in_order]; the packed and
    weight-only matmuls': (kernel, M, K, N, bits) -> [calls, qmm_plan's or
    wo_plan's choice]."""
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.kernels import qmatmul as Q

    def note(name, a, kw, got, want):
        sms = A.sm_count(got.device.index or 0)
        if name == "fused_attention":
            bh, n, d = a[0].shape
            row = plans.setdefault(("plain", bh, n, d), [0, 0, 0, None])
            row[0] += 1
            row[1] += int((got != want).sum())
            row[2] += got.numel()
            row[3] = exact_in_order(bh * A.plain_tile(n), n)
            return
        if name in ("splitk_qmatmul", "packed_qmatmul", "splitk_wo_matmul"):
            m, k = a[0].shape
            if name == "splitk_wo_matmul":
                p = Q.wo_plan(m, a[1].shape[1], a[1].shape[0], kw["bits"],
                              sms)
                plan = f"cluster{p['cluster']}:blocks{p['blocks']}"
                n = a[1].shape[1]
            else:
                n = a[2].shape[1]
                p = Q.qmm_plan(m, n, k, kw["bits"], "splitk", sms)
                plan = f"bn{p['bn']}:stages{p['stages']}:" \
                    f"blocks{p['blocks']}:slabs{p['slabs']}:turns{p['turns']}"
            row = plans.setdefault((name, m, k, n, kw["bits"]), [0, None])
            row[0] += 1
            row[1] = plan
            return
        if not name.startswith("fused_attention_hs"):
            return
        xq, xk = a[0], a[1]
        heads = kw["num_heads"]
        d = xq.shape[2] // heads
        form = A.softmax_form(kw.get("fast", False), kw.get("score_max"))
        key = ("blockq" if "blockq" in name else "mono", xq.shape[1],
               xk.shape[1], heads, d, form, kw.get("score_bias") is not None)
        b, nq, hd = got.shape
        diff = (got.double() - want.double()).abs()
        per_block = diff.reshape(b, nq, heads, -1).amax(dim=-1)
        row = shapes.setdefault(key, [0, 0, 0, None, None])
        row[0] += 1
        row[1] += int((per_block > 0).sum())
        row[2] += per_block.numel()
        if "blockq" not in name:
            plan = A.hs_plan(nq, xk.shape[1], d, b * heads, sms,
                             exact=form == "exact")
            row[3] = f"warps{plan['warps']}:passes{plan['passes']}:" \
                f"kv_both{int(plan['kv_both'])}"
        else:
            row[3] = f"blockq{A.BLOCK_Q}:tiles{-(-nq // A.BLOCK_Q)}"
        if form == "exact":
            row[4] = exact_in_order(b * heads * nq, xk.shape[1])
    return note


def ed_shadow_check(label: str, run, card: str) -> dict:
    """One eager ``run()`` with every quantize/dequantize, head-split,
    plain-attention, packed and weight-only launch held against its plain
    version: 0 mismatching outputs for the exact kernels where the exact
    attention forms sum in torch's order (else at most 1% of head-split
    (row, head) blocks, each within one output step, or of the plain
    kernel's outputs), splitk_wo_matmul within WO_TOL. Prints hs_plan's,
    qmm_plan's and wo_plan's choice at each shape. Returns {kernel:
    [calls, mismatches, ...]}."""
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    state, shapes, plans = {}, {}, {}
    extra = ((A, "fused_attention_hs_monolithic",
              A.fused_attention_hs_reference),
             (A, "fused_attention_hs_blockq",
              A.fused_attention_hs_blockq_reference),
             (A, "fused_attention", A.fused_attention_reference),
             (Q, "splitk_wo_matmul", Q.splitk_wo_matmul_reference))
    with shadowed(state, extra=extra, note=ed_note(shapes, plans)):
        run()
    cardw = card.replace(" ", "_")
    for key, (calls, flips, blocks, plan, ordered) in shapes.items():
        kind, nq, n, heads, d, form, bias = key
        say("ed-attention", path=label, kernel=kind, nq=nq, n=n, heads=heads,
            head_dim=d, softmax=form, score_bias=bias, calls=calls,
            plan=plan, exact_in_order=ordered,
            flipped_blocks=f"{flips}/{blocks}", card=cardw)
        if form == "exact" and ordered:
            assert flips == 0, (label, key, flips)
        else:
            assert flips <= 0.01 * blocks, (label, key, flips, blocks)
    for key, row in plans.items():
        if key[0] == "plain":
            _, bh, n, d = key
            calls, bad, total, ordered = row
            say("ed-plain-attention", path=label, bh=bh, n=n, head_dim=d,
                calls=calls, exact_in_order=ordered,
                mismatching=f"{bad}/{total}", card=cardw)
            assert bad == 0 if ordered else bad <= 0.01 * total, \
                (label, key, bad, total)
        else:
            name, m, k, n, bits = key
            say("ed-plan", path=label, kernel=name, m=m, k=k, n=n, bits=bits,
                calls=row[0], plan=row[1], card=cardw)
    say("ed-shadow", path=label, **{
        f"shadow_{k}": f"{v[0]}calls:{v[1]}mismatches:{v[2]:.3g}max_diff"
        for k, v in state.items()})
    for name, (calls, bad, diff, scale) in state.items():
        if name == "splitk_wo_matmul":
            assert diff <= WO_TOL["f32"] * max(scale, 1e-30), (label, diff)
        elif not name.startswith("fused_attention"):  # held per shape
            assert bad == 0, (label, name, bad, diff)
    return state


def ed_launches(fn, steps: int = 1) -> dict:
    """Launches of the phase's kernels per step (or forward) of one
    ``fn()``, which runs ``steps`` of them."""
    _, c = counted(fn)
    return {k: c[k] / steps for k in ED_KERNELS}


def ed_generate_seconds(enc, dec, src, wte, start: int) -> tuple:
    """(ids, {"eager": s, "captured": s}) of generate_seq2seq over ED_NEW
    tokens: one run walking eagerly, then the median of two captured runs
    after a first that captures; the captured ids equal the eager ones."""
    import numpy as np
    from numpy_quant_tpu_torch.utils import generate_seq2seq

    def run():
        return generate_seq2seq(enc, dec, src, wte, ED_NEW,
                                decoder_start_id=start)
    with eager():
        ref, eager_s = synced_seconds(run)
    run()
    ids, s1 = synced_seconds(run)
    _, s2 = synced_seconds(run)
    assert np.array_equal(ids, ref), "generate_seq2seq: captured != eager"
    return ids, {"eager": eager_s, "captured": statistics.median((s1, s2))}


def ed_rates(float_s: dict, int8_s: dict) -> dict:
    """Tokens/s and ms per token step of two ed_generate_seconds runs."""
    return {f"{kind}_{mode}_{unit}": (ED_B * ED_NEW / sec if unit ==
                                      "tokens_per_s" else sec / ED_NEW * 1e3)
            for kind, runs in (("float", float_s), ("int8", int8_s))
            for mode, sec in runs.items()
            for unit in ("tokens_per_s", "ms_per_step")}


def ed_packed(label: str, qmodel, inputs: list, card: str,
              kernel: str = "splitk_qmatmul") -> dict:
    """pack_weights() on an optimize()d QModel, then one forward under
    "kernel" (its launches shadowed by their plain versions, ``kernel``
    launched once per packed weight) against the "unpack" forward, bit for
    bit. Returns the "kernel" launches."""
    n = qmodel.pack_weights()
    with packed_execution("kernel"):
        ed_shadow_check(f"{label}_kernel", lambda: qmodel(inputs), card)
        kern, counts = counted(lambda: qmodel(inputs)[0])
    unpacked = qmodel(inputs)[0]
    equal = same_bits(kern, unpacked)
    say("ed-packed", path=label, packed=n,
        **{f"{kernel}_launches": counts[kernel]},
        kernel_equals_unpack_bitwise=equal, card=card.replace(" ", "_"))
    assert equal and counts[kernel] == n > 0, (label, counts, n)
    return {k: counts[k] for k in ED_KERNELS}


def step_margin_rule(label: str, ids_step, rows_step, ids_full,
                     logits_full) -> dict:
    """The decode-step form's greedy ids against the full form's on one
    model: equal, or each row parts only where the full form's top-2 margin
    at that position lies within the largest |logit difference| of the
    positions both forms saw alike (phase 7's rule). ``rows_step``: the
    step logits per step; ``logits_full``: the full graph's [B, T, V] logits
    over the full form's ids. Returns the comparison."""
    import numpy as np
    n = min(ids_step.shape[1], ids_full.shape[1])
    same = np.cumprod(ids_step[:, :n] == ids_full[:, :n], axis=1).astype(bool)
    diff = 0.0
    for t in range(n - 1):
        live = same[:, t]
        if live.any():
            d = (rows_step[t] - logits_full[:, t].to(rows_step[t].dtype)) \
                .abs().amax(dim=1).cpu().numpy()
            diff = max(diff, float(d[live].max()))
    parted = []
    for b in range(ids_step.shape[0]):
        if same[b, n - 1]:
            continue
        p = int(np.argmin(same[b]))
        top2 = logits_full[b, p - 1].float().topk(2).values
        parted.append((b, p, float(top2[0] - top2[1])))
    say("ed-step-vs-full", path=label, tokens_equal=not parted,
        max_logit_diff=diff, parted=";".join(
            f"row{b}@{p}:margin{m:.3g}" for b, p, m in parted) or "none")
    assert all(m <= diff for _, _, m in parted), (label, parted, diff)
    return dict(parted=parted, diff=diff)


def t5_decode_ed(card: str) -> dict:
    """Phase 21(a): T5-small's KV-cache decode step at full width."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models import t5 as T5M
    from numpy_quant_tpu_torch.utils import (ContinuousBatcher,
                                             decode_calibration, generate_kv,
                                             merge_calibration_stats)
    t0 = time.perf_counter()
    cfg = T5M.T5_SMALL
    w = T5M.random_t5_weights(cfg, seed=0)
    vocab = cfg["vocab_size"]
    rng = np.random.default_rng(21)
    enc_p = T5M.t5_encoder(w, cfg, batch_size=ED_B, seq_len=T5_SRC)
    enc = Model.from_onnx(enc_p)
    wte = enc_p._wte
    mems = [enc([torch.from_numpy(wte[rng.integers(0, vocab, (ED_B, T5_SRC))])
                 .cuda()], as_numpy=False)[0] for _ in range(2)]
    memory = mems[0]
    proto = T5M.t5_decode_step(w, cfg, batch_size=ED_B, max_len=T5_LEN,
                               src_len=T5_SRC)
    bias = proto._decode_bias
    step = Model.from_onnx(proto)
    start = 0  # T5's decoder start is the pad token
    prompt = np.concatenate([np.full((ED_B, 1), start), rng.integers(
        0, vocab, (ED_B, T5_PROMPT - 1))], axis=1).astype(np.int32)
    steps = T5_PROMPT + T5_NEW - 1
    res = {"setup_s": time.perf_counter() - t0}

    def gen(model, **kw):
        return generate_kv(model, prompt, wte, None, T5_NEW, score_bias=bias,
                           memory=memory, **kw)

    def toks(ids):
        return ids.shape[0] * T5_NEW

    eq = np.array_equal
    res["float"] = captured_decode("t5_decode_float", card, step,
                                   lambda m: (gen(m), steps), eq, toks,
                                   dtype="f32", batch=ED_B, cache=T5_LEN,
                                   source=T5_SRC)
    ids_f = gen(step)
    batches = decode_calibration(step, prompt, wte, None, score_bias=bias,
                                 memory=memory)
    stats = merge_calibration_stats(*[step.calibration_stats(b)
                                      for b in batches])
    qstep = step.quantize(stats=stats, bit_width=8)
    report = qstep.optimize()
    say("ed-optimize", path="t5_decode_int8", **report)
    assert report["fuse_decode_attention"] == cfg["num_decoder_layers"]
    assert report["fuse_attention"] == cfg["num_decoder_layers"]
    assert report["fusion_failures"] == [], report
    ed_shadow_check("t5_decode_int8", lambda: generate_kv(
        qstep, prompt, wte, None, 2, score_bias=bias, memory=memory,
        kv_cache_dtype="int8"), card)
    res["int8"] = captured_decode("t5_decode_int8", card, qstep,
                                  lambda m: (gen(m), steps), eq, toks,
                                  dtype="f32", cache_dtype="float")
    res["int8_cache"] = captured_decode(
        "t5_decode_int8", card, qstep,
        lambda m: (gen(m, kv_cache_dtype="int8"), steps), eq, toks,
        dtype="f32", cache_dtype="int8")
    ids_q, ids_q8 = gen(qstep), gen(qstep, kv_cache_dtype="int8")
    assert eq(ids_q8, ids_q), "T5 int8 cache tokens differ from float carry"
    res["launches_int8"] = ed_launches(
        lambda: gen(qstep, kv_cache_dtype="int8"), steps)
    # W4 g=128 weight-only under "kernel": splitk_wo_matmul at M = 8 and,
    # for the cross K/V projections, M = 8 * 512
    wstep = Model.from_onnx(proto)
    n_w4 = wstep.quantize_weights(bit_width=4, group_size=128)
    with packed_execution("kernel"):
        ed_shadow_check("t5_decode_w4", lambda: generate_kv(
            wstep, prompt, wte, None, 2, score_bias=bias, memory=memory),
            card)
        res["w4"] = captured_decode("t5_decode_w4", card, wstep,
                                    lambda m: (gen(m), steps), eq, toks,
                                    dtype="f32", packed_execution="kernel")
        res["launches_w4"] = ed_launches(lambda: gen(wstep), steps)
        ids_w4 = gen(wstep)
    assert res["launches_w4"]["splitk_wo_matmul"] == n_w4, res["launches_w4"]
    say("ed-t5-tokens", w4_weights=n_w4,
        int8_agreement_float=float((ids_q == ids_f)[:, T5_PROMPT:].mean()),
        w4_agreement_float=float((ids_w4 == ids_f)[:, T5_PROMPT:].mean()),
        int8_cache_equals_float_carry=True)
    # the cross K/V projections the captured step recomputes: 12 products
    # [8 * 512, 512] x [512, 512] per token, timed alone
    from numpy_quant_tpu_torch import intops
    m2 = memory.reshape(-1, cfg["d_model"])
    wkv = torch.from_numpy(w["decoder.block.0.layer.1.EncDecAttention.k."
                             "weight"].T.copy()).cuda()
    f_ms = cuda_ms(lambda: torch.matmul(m2, wkv), lead=True)
    x8 = torch.randint(-128, 128, m2.shape, dtype=torch.int8,
                       device=m2.device)
    w8 = torch.randint(-128, 128, wkv.shape, dtype=torch.int8,
                       device=m2.device)
    i_ms = cuda_ms(lambda: intops.int_matmul(x8, w8), lead=True)
    n_kv = 2 * cfg["num_decoder_layers"]
    res["cross_kv"] = dict(
        float_ms=n_kv * f_ms, int8_ms=n_kv * i_ms,
        float_share=n_kv * f_ms / res["float"]["captured_ms_per_step"],
        int8_share=n_kv * i_ms / res["int8_cache"]["captured_ms_per_step"])
    say("ed-cross-kv", products_per_step=n_kv,
        shape="x".join(str(v) for v in (*m2.shape, wkv.shape[1])),
        **{k: v for k, v in res["cross_kv"].items()},
        card=card.replace(" ", "_"))

    # the engine: score-bias rows and per-slot memory rows, int8 cache
    reqs = []
    for i in range(ED_REQS):
        plen = int(rng.integers(1, 9))
        new = int(rng.integers(ED_BUDGETS[0], ED_BUDGETS[1] + 1))
        p = np.concatenate([[start], rng.integers(0, vocab, plen - 1)])
        reqs.append((p.astype(np.int32), new, mems[i // ED_B][i % ED_B]))

    def engine(m):
        eng = ContinuousBatcher(m, wte, None, score_bias=bias,
                                has_memory=True, kv_cache_dtype="int8")
        out = eng.run(reqs)
        return out, eng.stats["steps"]

    res["engine"] = captured_decode(
        "t5_engine", card, qstep, engine,
        lambda a, b: a.keys() == b.keys() and all(
            eq(a[k], b[k]) for k in a),
        lambda out: generated(out, reqs), dtype="f32", cache_dtype="int8",
        slots=ED_B, requests=ED_REQS)
    got, _ = engine(qstep)
    for rid, (p, new, mem) in enumerate(reqs):
        solo = generate_kv(qstep, np.repeat(p[None], ED_B, 0), wte, None,
                           new, score_bias=bias, kv_cache_dtype="int8",
                           memory=mem[None].expand(ED_B, -1, -1))[0]
        assert eq(got[rid], solo), f"T5 engine request {rid} != generate_kv"
    say("ed-t5-engine", requests=ED_REQS, slots=ED_B,
        tokens_equal_generate_kv_alone=True,
        seconds=time.perf_counter() - t0)
    res["seconds"] = time.perf_counter() - t0
    return res


def bart_ed(card: str) -> dict:
    """Phase 21(b): BART-base at full width."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models import seq2seq as BM
    from numpy_quant_tpu_torch.utils import generate_kv
    t0 = time.perf_counter()
    cfg = BM.BART_BASE
    w = BM.random_bart_weights(cfg, seed=0)
    vocab, d = cfg["vocab_size"], cfg["d_model"]
    rng = np.random.default_rng(22)
    proto = BM.bart_seq2seq(w, cfg, batch_size=ED_B, src_len=BART_SRC,
                            tgt_len=BART_TGT)
    wte = proto._wte
    model = Model.from_onnx(proto)
    calib = [torch.from_numpy(wte[rng.integers(0, vocab, (2, n))]).cuda()
             for n in (BART_SRC, BART_TGT)]
    x = [torch.from_numpy(wte[rng.integers(0, vocab, (ED_B, n))]).cuda()
         for n in (BART_SRC, BART_TGT)]
    qm = model.quantize(bit_width=8, stats=model.calibration_stats(calib))
    with eager():
        unfused = qm(x)[0]
    report = qm.optimize()
    say("ed-optimize", path="bart_base", **report)
    n_att = 3 * cfg["decoder_layers"]
    assert report["fuse_attention"] == n_att, report
    assert report["fusion_failures"] == [], report
    ed_shadow_check("bart_base_int8", lambda: qm(x), card)
    heads = cfg["encoder_attention_heads"]
    for nq, n in ((BART_SRC, BART_SRC), (BART_TGT, BART_TGT),
                  (BART_TGT, BART_SRC)):
        assert exact_in_order(ED_B * heads * nq, n), (nq, n)
    fused, counts = counted(lambda: qm(x)[0])
    launches = {k: counts[k] for k in ED_KERNELS}
    equal = same_bits(fused, unfused)
    say("ed-bart", batch=ED_B, source=BART_SRC, target=BART_TGT,
        fused_equals_unfused_bitwise=equal, **{
            f"launches_{k}": v for k, v in launches.items()})
    assert equal, "BART-base fused f32 forward != unfused"
    assert launches["fused_attention_hs_blockq"] == 2 * cfg["encoder_layers"]
    assert launches["fused_attention_hs"] == cfg["decoder_layers"]
    res = {"launches": launches}
    res["f32"] = captured_forward("bart_base_int8", card, qm, x,
                                  ED_B * BART_TGT, "tokens", reps=ED_REPS,
                                  dtype="f32")
    with config.low_precision_floats():
        b16, c16 = counted(lambda: qm(x)[0])
        res["bf16"] = captured_forward("bart_base_int8", card, qm, x,
                                       ED_B * BART_TGT, "tokens",
                                       reps=ED_REPS, dtype="bf16")
    agree = float((b16.argmax(-1) == fused.argmax(-1)).mean())
    say("ed-bart-bf16", label_agreement_f32=agree, launches_blockq=c16[
        "fused_attention_hs_blockq"], launches_mono=c16["fused_attention_hs"])
    assert np.isfinite(b16).all()
    res["packed"] = ed_packed("bart_base_int8", qm, x, card)
    launches["splitk_qmatmul"] = res["packed"]["splitk_qmatmul"]
    del qm, model, unfused, fused

    # generate_seq2seq over the encoder and decoder graphs, float and int8
    src = rng.integers(0, vocab, (ED_B, BART_SRC)).astype(np.int32)
    start = cfg["decoder_start_token_id"]
    enc = Model.from_onnx(BM.bart_encoder(w, cfg, ED_B, BART_SRC))
    dec = Model.from_onnx(BM.bart_decoder(w, cfg, ED_B, BART_SRC, BART_TGT))
    ids_f, gen_s = ed_generate_seconds(enc, dec, src, wte, start)
    memory = enc([torch.from_numpy(wte[src]).cuda()], as_numpy=False)[0]
    emb = torch.from_numpy(wte[ids_f.astype(np.int64)]).cuda()
    emb = torch.nn.functional.pad(emb, (0, 0, 0, BART_TGT - emb.shape[1]))
    logits_full = dec([emb, memory], as_numpy=False)[0]
    qenc = enc.quantize(bit_width=8, stats=enc.calibration_stats(
        [calib[0]]))
    qdec = dec.quantize(bit_width=8, stats=dec.calibration_stats(
        [emb[:2], memory[:2]]))
    for qq in (qenc, qdec):
        assert qq.optimize()["fusion_failures"] == []
    ids_q, qgen_s = ed_generate_seconds(qenc, qdec, src, wte, start)
    res["launches_int8_encoder"] = ed_launches(lambda: qenc(
        [torch.from_numpy(wte[src]).cuda()]))
    res["launches_int8_decoder"] = ed_launches(lambda: qdec([emb, memory]))
    say("ed-bart-generate", new_tokens=ED_NEW, **ed_rates(gen_s, qgen_s),
        int8_agreement_float=float((ids_q == ids_f)[:, 1:].mean()),
        captured_equals_eager=True, card=card.replace(" ", "_"))

    # the decode step through generate_kv(memory=) against the full form
    sp = BM.bart_decode_step(w, cfg, ED_B, BART_TGT, BART_SRC)
    step = Model.from_onnx(sp)
    rows = []
    prompt = np.full((ED_B, 1), start, np.int32)
    ids_s = generate_kv(step, prompt, sp._wte, sp._dec_pos, ED_NEW,
                        memory=memory, step_logits=rows)
    res["step_vs_full"] = step_margin_rule("bart_base", ids_s, rows, ids_f,
                                           logits_full)
    res["step"] = captured_decode(
        "bart_decode_float", card, step,
        lambda m: (generate_kv(m, prompt, sp._wte, sp._dec_pos, ED_NEW,
                               memory=memory), ED_NEW),
        np.array_equal, lambda ids: ED_B * ED_NEW, dtype="f32")
    res["seconds"] = time.perf_counter() - t0
    return res


def whisper_ed(card: str) -> dict:
    """Phase 21(c): Whisper-tiny at full width."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models import whisper as WM
    from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                             merge_calibration_stats)
    t0 = time.perf_counter()
    cfg = WM.WHISPER_TINY
    w = WM.random_whisper_weights(cfg, seed=0)
    rng = np.random.default_rng(23)
    feats = torch.from_numpy(rng.normal(size=(
        ED_B, cfg["num_mel_bins"], 2 * cfg["max_source_positions"]))
        .astype(np.float32) * 0.5).cuda()
    enc = Model.from_onnx(WM.whisper_encoder(w, cfg, ED_B))
    dp = WM.whisper_decoder(w, cfg, ED_B, WHISPER_TGT)
    dec = Model.from_onnx(dp)
    wte, start = dp._wte, cfg["decoder_start_token_id"]
    memory = enc([feats], as_numpy=False)[0]
    ids_f, gen_s = ed_generate_seconds(enc, dec, feats, wte, start)
    emb = torch.from_numpy(wte[ids_f.astype(np.int64)]).cuda()
    emb = torch.nn.functional.pad(emb, (0, 0, 0, WHISPER_TGT - emb.shape[1]))
    logits_full = dec([emb, memory], as_numpy=False)[0]
    sp = WM.whisper_decode_step(w, cfg, ED_B, WHISPER_TGT)
    step = Model.from_onnx(sp)
    rows = []
    prompt = np.full((ED_B, 1), start, np.int32)
    ids_s = generate_kv(step, prompt, sp._wte, sp._wpe, ED_NEW,
                        memory=memory, step_logits=rows)
    res = {"step_vs_full": step_margin_rule("whisper_tiny", ids_s, rows,
                                            ids_f, logits_full)}
    # int8: the encoder (Conv1d front end into the blockwise kernel at
    # N = 1500), the decoder (cross-attention 128 x 1500) and the step
    # (cross-attention 1 x 1500)
    qenc = enc.quantize(bit_width=8, stats=enc.calibration_stats(
        [feats[:2]]))
    qdec = dec.quantize(bit_width=8, stats=dec.calibration_stats(
        [emb[:2], memory[:2]]))
    for label, qq in (("encoder", qenc), ("decoder", qdec)):
        rep = qq.optimize()
        say("ed-optimize", path=f"whisper_{label}", **rep)
        assert rep["fusion_failures"] == [], rep
    ed_shadow_check("whisper_encoder_int8", lambda: qenc([feats]), card)
    ed_shadow_check("whisper_decoder_int8", lambda: qdec([emb, memory]),
                    card)
    res["launches_encoder"] = ed_launches(lambda: qenc([feats]))
    res["launches_decoder"] = ed_launches(lambda: qdec([emb, memory]))
    assert res["launches_encoder"]["fused_attention_hs_blockq"] == \
        cfg["encoder_layers"], res["launches_encoder"]
    res["encoder"] = captured_forward("whisper_encoder_int8", card, qenc,
                                      [feats], ED_B, "utterances",
                                      reps=ED_REPS, dtype="f32")
    res["packed"] = ed_packed("whisper_encoder_int8", qenc, [feats], card)
    res["launches_encoder"]["splitk_qmatmul"] = \
        res["packed"]["splitk_qmatmul"]
    ids_q, qgen_s = ed_generate_seconds(qenc, qdec, feats, wte, start)
    batches = decode_calibration(step, np.concatenate(
        [prompt, ids_f[:, 1:4]], axis=1), sp._wte, sp._wpe, memory=memory)
    qstep = step.quantize(bit_width=8, stats=merge_calibration_stats(
        *[step.calibration_stats(b) for b in batches]))
    rep = qstep.optimize()
    say("ed-optimize", path="whisper_decode_step", **rep)
    assert rep["fusion_failures"] == [], rep
    ed_shadow_check("whisper_step_int8", lambda: generate_kv(
        qstep, prompt, sp._wte, sp._wpe, 2, memory=memory,
        kv_cache_dtype="int8"), card)
    res["launches_step"] = ed_launches(lambda: generate_kv(
        qstep, prompt, sp._wte, sp._wpe, 1, memory=memory,
        kv_cache_dtype="int8"))
    res["step"] = captured_decode(
        "whisper_decode_int8", card, qstep,
        lambda m: (generate_kv(m, prompt, sp._wte, sp._wpe, ED_NEW,
                               memory=memory, kv_cache_dtype="int8"),
                   ED_NEW),
        np.array_equal, lambda ids: ED_B * ED_NEW, dtype="f32",
        cache_dtype="int8")
    ids_qs = generate_kv(qstep, prompt, sp._wte, sp._wpe, ED_NEW,
                         memory=memory, kv_cache_dtype="int8")
    say("ed-whisper", features="x".join(str(s) for s in feats.shape),
        new_tokens=ED_NEW, **ed_rates(gen_s, qgen_s),
        int8_agreement_float=float((ids_q == ids_f)[:, 1:].mean()),
        int8_step_agreement_float=float((ids_qs == ids_f)[:, 1:].mean()),
        card=card.replace(" ", "_"))
    res["seconds"] = time.perf_counter() - t0
    return res


def fixture_ed(card: str) -> dict:
    """Phase 21(d): the copy-task fixture through JAX's capstone rows."""
    import numpy as np
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models import text_fixture as TF
    from numpy_quant_tpu_torch.utils import (ContinuousBatcher,
                                             decode_calibration, generate,
                                             generate_kv,
                                             merge_calibration_stats)
    t0 = time.perf_counter()
    prompts, expected = TF.make_prompts(np.random.default_rng(11), ED_B)
    prompts = prompts.astype(np.int32)
    full = TF.trained_gpt_onnx(batch_size=ED_B)
    wte = full._wte
    calib = wte[TF.make_copy_batch(np.random.default_rng(3), ED_B)]
    rows, launches = {}, {}

    def acc_of(seq):
        return TF.copy_accuracy(seq[:, TF.COPY_LEN + 1:], expected)

    def gen(m):
        return generate(m, prompts, wte, TF.COPY_LEN)

    fm = Model.from_onnx(full)
    f_seq = gen(fm)
    f_acc = rows["float"] = acc_of(f_seq)
    assert f_acc >= FIXTURE_FLOOR, f_acc

    m8 = Model.from_onnx(full)
    assert m8.quantize_weights(bit_width=8) > 0
    seq = gen(m8)
    rows["w8_weight_only"] = acc_of(seq)
    assert np.array_equal(seq, f_seq), "W8 weight-only tokens != float"
    m4 = Model.from_onnx(full)
    m4.awq_scale_weights([calib], bit_width=4, group_size=32)
    assert m4.quantize_weights(bit_width=4, group_size=32) > 0
    with packed_execution("kernel"):
        ed_shadow_check("fixture_w4_awq", lambda: gen(m4), card)
        rows["w4_g32_awq"] = acc_of(gen(m4))
        launches["w4_g32_awq"] = ed_launches(
            lambda: generate(m4, prompts, wte, 1))
    q = fm.quantize([calib], bit_width=8)
    q.optimize()
    ed_shadow_check("fixture_int8", lambda: gen(q), card)
    rows["int8_ptq"] = acc_of(gen(q))
    launches["int8_ptq"] = ed_launches(lambda: generate(q, prompts, wte, 1))
    q2 = fm.quantize([calib], bit_width=8)
    assert q2.gptq(fm, [calib]) > 0
    rows["int8_gptq"] = acc_of(gen(q2))

    sp = TF.trained_gpt_decode_onnx(batch_size=ED_B)
    step = Model.from_onnx(sp)
    s_seq = generate_kv(step, prompts, wte, sp._wpe, TF.COPY_LEN)
    stats = merge_calibration_stats(*[step.calibration_stats(b) for b in
                                      decode_calibration(step, prompts, wte,
                                                         sp._wpe)])
    qs = step.quantize(stats=stats, bit_width=8)
    seq_f = generate_kv(qs, prompts, wte, sp._wpe, TF.COPY_LEN)
    seq_8 = generate_kv(qs, prompts, wte, sp._wpe, TF.COPY_LEN,
                        kv_cache_dtype="int8")
    assert np.array_equal(seq_8, seq_f), "fixture int8 cache != float carry"
    rows["int8_kv_cache"] = acc_of(seq_8)
    launches["int8_kv_cache"] = ed_launches(
        lambda: generate_kv(qs, prompts, wte, sp._wpe, TF.COPY_LEN,
                            kv_cache_dtype="int8"),
        prompts.shape[1] + TF.COPY_LEN - 1)
    res = {"step": captured_decode(
        "fixture_int8_cache", card, qs,
        lambda m: (generate_kv(m, prompts, wte, sp._wpe, TF.COPY_LEN,
                               kv_cache_dtype="int8"),
                   prompts.shape[1] + TF.COPY_LEN - 1),
        np.array_equal, lambda ids: ED_B * TF.COPY_LEN, dtype="f32",
        cache_dtype="int8")}

    pre = Model.from_onnx(TF.trained_gpt_prefill_onnx(TF.COPY_LEN + 1))
    cb = ContinuousBatcher(step, wte, sp._wpe, prefill_model=pre,
                           paged_kv=(4, 2 * ED_B * 6 + 1))
    out = cb.run([(prompts[i], TF.COPY_LEN) for i in range(ED_B)] * 2)
    accs = []
    for rid in sorted(out):
        assert np.array_equal(out[rid][:s_seq.shape[1]], s_seq[rid % ED_B]), \
            f"fixture engine request {rid} != lockstep float decode"
        accs.append(TF.copy_accuracy(out[rid][None, TF.COPY_LEN + 1:],
                                     expected[rid % ED_B]))
    rows["paged_engine_2x"] = float(np.mean(accs))
    say("ed-fixture", float_acc_floor=FIXTURE_FLOOR,
        max_acc_drop=FIXTURE_DROP, engine_preemptions=cb.stats[
            "preemptions"], **{f"acc_{k}": v for k, v in rows.items()},
        seconds=time.perf_counter() - t0, card=card.replace(" ", "_"))
    for k, v in rows.items():
        assert v >= f_acc - FIXTURE_DROP, (k, v, f_acc)
    res.update(rows=rows, launches=launches,
               seconds=time.perf_counter() - t0)
    return res


def ed_paths(ed: dict) -> dict:
    """{path: launches per step or forward} of phase 21's results."""
    return {"per_t5_int8_step": ed["t5"]["launches_int8"],
            "per_t5_w4_step_kernel": ed["t5"]["launches_w4"],
            "per_bart_base_forward": ed["bart"]["launches"],
            "per_bart_base_encoder_forward": ed["bart"][
                "launches_int8_encoder"],
            "per_bart_base_decoder_forward": ed["bart"][
                "launches_int8_decoder"],
            "per_whisper_encoder_forward": ed["whisper"]["launches_encoder"],
            "per_whisper_decoder_forward": ed["whisper"]["launches_decoder"],
            "per_whisper_int8_step": ed["whisper"]["launches_step"],
            "per_fixture_int8_step": ed["fixture"]["launches"][
                "int8_kv_cache"],
            "per_fixture_int8_forward": ed["fixture"]["launches"][
                "int8_ptq"],
            "per_fixture_w4_awq_forward_kernel": ed["fixture"]["launches"][
                "w4_g32_awq"]}


ED_ATTN_SHAPES = (  # (label, batch, q rows, keys, heads): phase 21's paths
    ("t5_step_cross", ED_B, 1, T5_SRC, 8),
    ("bart_encoder_self", ED_B, BART_SRC, BART_SRC, 12),
    ("bart_cross", ED_B, BART_TGT, BART_SRC, 12),
    ("whisper_encoder_self", ED_B, 1500, 1500, 6),
    ("whisper_cross", ED_B, WHISPER_TGT, 1500, 6),
    ("whisper_step_cross", ED_B, 1, 1500, 6))


def time_encdec_attention(name: str) -> dict:
    """The head-split kernels at phase 21's shapes (D=64, no bias, scaling
    1 as the pre-scaled and unscaled paths dispatch them, int8 out), exact
    and fast forms: held against the plain version (no flipped block on
    the exact form where it sums in torch's order), then the median of 20
    CUDA-event calls behind a device sleep beside the plain version and the
    bound (q, k and v read once, the int8 output written once; both
    products' int8 operations). Returns {label: {form: numbers}}."""
    from numpy_quant_tpu_torch.kernels import attention as A
    rates = peaks(name)
    res: dict = {}
    for label, b, nq, n, heads in ED_ATTN_SHAPES:
        q, k, v = attention_inputs(b, nq, seed=nq + n, n=n, heads=heads)
        blockq = A.blockwise(n, None, nq=nq)
        kname = "fused_attention_hs_blockq" if blockq else "fused_attention_hs"
        plain = A.fused_attention_hs_blockq_reference if blockq \
            else A.fused_attention_hs_reference
        nbytes = 2 * q.numel() + k.numel() + v.numel()
        ops = 2 * 2 * b * heads * nq * n * HEAD_DIM
        t_bytes, t_ops = nbytes / rates["bytes"] * 1e3, ops / rates["int8"] * 1e3
        for mode in ("exact", "fast"):
            kw = attention_kw(heads, mode, "none", OUT_REQUANT, QP)
            kw["scaling"] = 1.0
            flips, blocks, _ = attention_diff(
                A.fused_attention_hs(q, k, v, **kw), plain(q, k, v, **kw),
                heads, OUT_REQUANT, QP, f"{label} {mode}")
            if mode == "exact":
                rows = b * heads * (min(nq, A.BLOCK_Q) if blockq else nq)
                assert exact_in_order(rows, n) and flips == 0, (label, flips)
            ms = cuda_ms(lambda: A.fused_attention_hs(q, k, v, **kw),
                         lead=True)
            plain_ms = cuda_ms(lambda: plain(q, k, v, **kw), lead=True)
            row = dict(kernel=kname, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       flipped_blocks=flips)
            res.setdefault(label, {})[mode] = row
            say("kernel-time", kernel=kname, form=mode, path=label,
                shape=f"B{b}xNq{nq}xN{n}xH{heads}xD{HEAD_DIM}", out="int8",
                ms=ms, plain_ms=plain_ms, bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], bytes=nbytes, ops=ops,
                flipped_blocks=f"{flips}/{blocks}", library="none",
                card=name.replace(" ", "_"))
    return res


def encdec_phase(card: str) -> dict:
    """Phase 21: encoder-decoder generation at full width (T5-small's
    decode step and engine, BART-base, Whisper-tiny, the copy fixture).
    Returns the launches per step or forward by path."""
    import torch
    t_phase = time.perf_counter()
    res = {"t5": t5_decode_ed(card), "bart": bart_ed(card),
           "whisper": whisper_ed(card), "fixture": fixture_ed(card),
           "attention": time_encdec_attention(torch.cuda.get_device_name(0))}
    say("ed-phase", seconds=time.perf_counter() - t_phase,
        **{f"{k}_s": v["seconds"] for k, v in res.items()
           if "seconds" in v},
        card=card.replace(" ", "_"))
    return res


# -- phase 22: QAT and the rest of the model zoo --------------------------------

Z_REPS = 2               # timed calls per turn of a phase 22 captured forward
QAT_MLP_POINTS = 600     # JAX's tests/test_qat.py: circles, 4-bit rules
QAT_MLP_STEPS, QAT_FILTER_STEPS, QAT_MLP_LR = 150, 120, 3e-3
QAT_B, QAT_STEPS, QAT_LR, QAT_BITS = 64, 60, 1e-3, 3  # JAX's ViT capstone
QAT_CALIB_SEED, QAT_EVAL_SEEDS = 1, (100, 101, 102, 103)
QAT_GAIN = 0.015         # the capstone rule: QAT > PTQ + 0.015 held out
QAT_SERVE_B = 96         # the QAT'd ViT-Base-width fixture's serving batch
BERT_QAT_B, BERT_QAT_STEPS, BERT_QAT_LR = 8, 40, 1e-3  # test_qat.py's
MAMBA_B, MAMBA_L = 8, 128
MAMBA_LAYERS = 2  # of Mamba-130m's 24: cut for the script's time limit
# prompt + new = MAMBA_L: the step is held to the full form's logits over
# all of its L positions
MAMBA_PROMPT, MAMBA_NEW = 32, 96
MAMBA_CHECK_NEW = 16     # new tokens of the captured-against-eager decodes
MAMBA_REQS, MAMBA_BUDGETS, MAMBA_IDS = 16, (4, 24), 40
# of Mixtral-8x7B's 32 layers: the depth is the only cut. Two layers took
# phase 22 to 390 s (170 s of it Mixtral: three graph builds and
# quantize_weights of 2.8 B weights on the host), past the script's limit
MIXTRAL_LAYERS = 1
MIXTRAL_N, MIXTRAL_B, MIXTRAL_CACHE = 2048, 8, 512
MIXTRAL_L, MIXTRAL_PROMPT = 32, 16  # the full form the step is held to
CLIP_IMAGES, CLIP_PROMPTS, CLIP_T = 96, 1000, 77
BERT_B, BERT_T = 32, 128


def qat_mlp(card: str) -> dict:
    """Phase 22(a): the reference MLP at 4 bits under JAX's test_qat.py
    rules, trained on the card."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.graph import Constant
    from numpy_quant_tpu_torch.models.mlp import load_mlp, two_circles
    t0 = time.perf_counter()
    x, y = two_circles(QAT_MLP_POINTS, 0.03, 3)
    model = Model.from_onnx(load_mlp())
    with eager():
        f_out = model([x])[0]
    ptq = model.quantize([x], bit_width=4)
    ts = time.perf_counter()
    qat = model.qat_quantize([x], bit_width=4, steps=QAT_MLP_STEPS,
                             lr=QAT_MLP_LR)
    step_ms = (time.perf_counter() - ts) / QAT_MLP_STEPS * 1e3
    hist = qat.qat_loss_history
    mse = {k: float(np.mean((m([x])[0] - f_out) ** 2))
           for k, m in (("ptq", ptq), ("qat", qat))}
    with eager():
        untouched = np.array_equal(model([x])[0], f_out)
    yt = torch.from_numpy(y.astype(np.float32)).cuda()

    def loss_fn(outs):
        p = torch.clamp(outs[0][:, 0], 1e-6, 1 - 1e-6)
        return -torch.mean(yt * torch.log(p) + (1 - yt) * torch.log(1 - p))
    filt = model.qat_quantize([x], bit_width=4, steps=QAT_FILTER_STEPS,
                              lr=QAT_MLP_LR, loss_fn=loss_fn,
                              train_filter=lambda n: n.startswith("fc2."))

    def payload(m, name):
        return next(v.data.data for v in m.values
                    if v.name == name and isinstance(v, Constant))

    def acc(m):
        return float(((m([x])[0][:, 0] > 0.5) == y).mean())
    res = dict(loss_first=float(hist[0]), loss_min=float(hist.min()),
               ptq_mse=mse["ptq"], qat_mse=mse["qat"],
               float_untouched=untouched,
               fc1_equals_ptq=bool(torch.equal(payload(filt, "fc1.weight"),
                                               payload(ptq, "fc1.weight"))),
               fc2_moved=not torch.equal(payload(filt, "fc2.weight"),
                                         payload(ptq, "fc2.weight")),
               filter_loss_fell=bool(filt.qat_loss_history.min()
                                     < filt.qat_loss_history[0]),
               ptq_acc=acc(ptq), qat_acc=acc(filt), ms_per_step=step_ms,
               seconds=time.perf_counter() - t0)
    say("z-qat-mlp", **res, card=card.replace(" ", "_"))
    assert res["loss_min"] < 0.8 * res["loss_first"], res
    assert res["qat_mse"] < res["ptq_mse"] and untouched, res
    assert res["fc1_equals_ptq"] and res["fc2_moved"], res
    assert res["filter_loss_fell"] and res["qat_acc"] >= res["ptq_acc"], res
    return res


def qat_vit(card: str, base: bool) -> dict:
    """Phase 22(a): JAX's ViT capstone recipe (3 bits, one 64-image
    calibration batch of seed 1, 60 self-distilled steps at lr 1e-3,
    held-out seeds 100-103) on the small fixture, where JAX's rule holds,
    or on the ViT-Base-width fixture, where it is a finding and the QAT'd
    model is then deployed: optimize() -> pack_weights() -> bf16 B=96
    under "kernel" (packed_qmatmul at 3 bits)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models import fixtures as F
    t0 = time.perf_counter()
    size = F.BASE_IMAGE_SIZE if base else F.IMAGE_SIZE
    proto = F.trained_vit_base_onnx() if base \
        else F.trained_vit_onnx(batch_size=QAT_B)
    model = Model.from_onnx(proto)
    evals = [F.make_batch(np.random.default_rng(s), QAT_B, size)
             for s in QAT_EVAL_SEEDS]
    evals = [(torch.from_numpy(x).cuda(), y) for x, y in evals]

    def acc(m):
        hits = sum(int((m([x])[0].argmax(-1) == y).sum()) for x, y in evals)
        return hits / (len(evals) * QAT_B)
    calib, _ = F.make_batch(np.random.default_rng(QAT_CALIB_SEED), QAT_B,
                            size)
    float_acc = acc(model)
    ptq_acc = acc(model.quantize([calib], bit_width=QAT_BITS))
    ts = time.perf_counter()
    qat = model.qat_quantize([calib], bit_width=QAT_BITS, steps=QAT_STEPS,
                             lr=QAT_LR)
    step_s = (time.perf_counter() - ts) / QAT_STEPS
    hist = qat.qat_loss_history
    qat_acc = acc(qat)
    label = "vit_base_fixture" if base else "vit_fixture"
    res = dict(float_acc=float_acc, ptq_acc=ptq_acc, qat_acc=qat_acc,
               loss_first=float(hist[0]), loss_min=float(hist.min()),
               s_per_step=step_s, steps=QAT_STEPS, bits=QAT_BITS)
    say("z-qat-vit", fixture=label, image_size=size, **res,
        card=card.replace(" ", "_"))
    if not base:
        assert qat_acc > ptq_acc + QAT_GAIN, res
        assert res["loss_min"] < 0.5 * res["loss_first"], res
        res["seconds"] = time.perf_counter() - t0
        return res
    assert res["loss_min"] < res["loss_first"], res
    # deploy: the 3-bit weights pack as bit-planes (packed_qmatmul)
    report = qat.optimize()
    assert report["fusion_failures"] == [], report
    x8 = evals[0][0][:B_F32]
    res["launches_f32"] = ed_packed(f"qat_{label}", qat, [x8], card,
                                    "packed_qmatmul")
    x96 = torch.from_numpy(F.make_batch(np.random.default_rng(7),
                                        QAT_SERVE_B, size)[0]).cuda()
    with packed_execution("kernel"), config.low_precision_floats():
        res["launches"] = ed_launches(lambda: qat([x96], as_numpy=False))
        res["bf16"] = captured_forward(
            f"qat_{label}_bf16", card, qat, [x96], QAT_SERVE_B, "images",
            reps=Z_REPS, dtype="bf16", batch=QAT_SERVE_B,
            packed_execution="kernel")
    say("z-qat-deploy", fixture=label, batch=QAT_SERVE_B,
        packed_qmatmul_launches=res["launches"]["packed_qmatmul"],
        images_per_s=res["bf16"]["captured_images_per_s"],
        card=card.replace(" ", "_"))
    assert res["launches"]["packed_qmatmul"] > 0, res["launches"]
    res["seconds"] = time.perf_counter() - t0
    return res


def qat_bert(card: str) -> dict:
    """Phase 22(a): BERT-base at W4A8, 40 QAT steps on int64 ids at
    tests/test_qat.py's lr; every MatMul weight is 4 bits afterwards, the
    output finite (that test's rules). Its third rule, a loss falling
    below step 0's, is printed, not held: at BERT-base widths the first
    Adam step flips W4 levels across every weight tensor and the
    self-distillation loss jumps (the JAX package's qat_quantize gives the
    same history step for step on the CPU)."""
    import numpy as np
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.graph import Constant
    from numpy_quant_tpu_torch.models import text as TT
    from numpy_quant_tpu_torch.tensor import QTensor
    t0 = time.perf_counter()
    cfg = TT.BERT_BASE
    model = Model.from_onnx(TT.bert_text_classifier(
        TT.random_bert_weights(cfg, seed=0), cfg, batch_size=BERT_QAT_B,
        seq_len=BERT_T))
    ids = np.random.default_rng(22).integers(
        0, cfg["vocab_size"], (BERT_QAT_B, BERT_T)).astype(np.int64)
    ts = time.perf_counter()
    qat = model.qat_quantize([ids], bit_width=8, weight_bit_width=4,
                             steps=BERT_QAT_STEPS, lr=BERT_QAT_LR)
    step_s = (time.perf_counter() - ts) / BERT_QAT_STEPS
    hist = qat.qat_loss_history
    out = qat([ids])[0]
    widths = {v.data.bit_width for v in qat.values
              if isinstance(v, Constant) and isinstance(v.data, QTensor)
              and v.name.endswith("weight_t")}
    res = dict(loss_first=float(hist[0]), loss_min=float(hist.min()),
               loss_last=float(hist[-1]), loss_fell=bool(hist.min() < hist[0]),
               s_per_step=step_s, weight_widths=sorted(widths),
               finite=bool(np.isfinite(out).all()),
               seconds=time.perf_counter() - t0)
    say("z-qat-bert", batch=BERT_QAT_B, seq=BERT_T, lr=BERT_QAT_LR, **res,
        card=card.replace(" ", "_"))
    assert widths == {4}, res
    assert res["finite"] and out.shape == (BERT_QAT_B, cfg["num_labels"])
    return res


def mamba_z(card: str) -> dict:
    """Phase 22(b): Mamba-130m widths at B=8."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models import mamba as MB
    from numpy_quant_tpu_torch.utils import (ContinuousBatcher, generate,
                                             generate_mamba,
                                             mamba_decode_calibration,
                                             merge_calibration_stats)
    t0 = time.perf_counter()
    cfg = dict(MB.MAMBA_130M, num_hidden_layers=MAMBA_LAYERS)
    w = MB.random_mamba_weights(cfg, seed=0)
    vocab = cfg["vocab_size"]
    rng = np.random.default_rng(22)
    full_p = MB.mamba_causal_lm(w, cfg, batch_size=MAMBA_B, seq_len=MAMBA_L)
    wte = full_p._wte
    full = Model.from_onnx(full_p)
    step_p = MB.mamba_decode_step(w, cfg, batch_size=MAMBA_B)
    step = Model.from_onnx(step_p)
    del full_p, step_p, w
    res = {"build_s": time.perf_counter() - t0, "nodes_full": len(full.nodes),
           "nodes_step": len(step.nodes)}
    x = torch.from_numpy(wte[rng.integers(0, vocab, (MAMBA_B, MAMBA_L))]) \
        .cuda()
    res["full_float"] = captured_forward(
        "mamba_full_float", card, full, [x], MAMBA_B * MAMBA_L, "tokens",
        reps=1, trace_tries=1, dtype="f32", batch=MAMBA_B, seq=MAMBA_L)
    ts = time.perf_counter()
    stats = full.calibration_stats([x])
    qfull = full.quantize(bit_width=8, stats=stats)
    res["calibrate_quantize_s"] = time.perf_counter() - ts
    ed_shadow_check("mamba_full_int8", lambda: qfull([x]), card)
    res["launches_full_int8"] = ed_launches(lambda: qfull([x]))
    res["full_int8"] = captured_forward(
        "mamba_full_int8", card, qfull, [x], MAMBA_B * MAMBA_L, "tokens",
        reps=1, trace_tries=1, dtype="f32", batch=MAMBA_B, seq=MAMBA_L)
    del qfull
    say("z-mamba-full", nodes=res["nodes_full"],
        build_s=res["build_s"],
        calibrate_quantize_s=res["calibrate_quantize_s"],
        float_capture_s=res["full_float"]["capture_s"],
        int8_capture_s=res["full_int8"]["capture_s"],
        float_pool_mb=res["full_float"]["pool_mb"],
        int8_pool_mb=res["full_int8"]["pool_mb"],
        scan_matmuls=cfg["num_hidden_layers"] * MAMBA_L,
        card=card.replace(" ", "_"))

    prompt = rng.integers(0, vocab, (MAMBA_B, MAMBA_PROMPT)).astype(np.int32)
    steps = MAMBA_PROMPT + MAMBA_NEW - 1
    eq = np.array_equal

    def gen(m, new=MAMBA_NEW):
        return generate_mamba(m, prompt, wte, new)

    def checked(m):  # the captured-against-eager decode
        return gen(m, MAMBA_CHECK_NEW), MAMBA_PROMPT + MAMBA_CHECK_NEW - 1

    def toks(ids):
        return ids.shape[0] * (ids.shape[1] - MAMBA_PROMPT)
    res["step_float"] = captured_decode(
        "mamba_step_float", card, step, checked, eq, toks, dtype="f32",
        batch=MAMBA_B, prompt=MAMBA_PROMPT, new=MAMBA_CHECK_NEW)
    rows = []
    ids_f, res["float_s"] = synced_seconds(lambda: generate_mamba(
        step, prompt, wte, MAMBA_NEW, step_logits=rows))
    ids_full = generate(full, prompt, wte, MAMBA_NEW)
    logits_full = full([torch.from_numpy(wte[ids_full]).cuda()],
                       as_numpy=False)[0]
    res["step_vs_full"] = step_margin_rule("mamba_step_float", ids_f, rows,
                                           ids_full, logits_full)
    del full

    batches = mamba_decode_calibration(step, prompt, wte)
    stats = merge_calibration_stats(*[step.calibration_stats(b)
                                      for b in batches])
    qstep = step.quantize(stats=stats, bit_width=8)
    report = qstep.optimize()
    say("z-optimize", path="mamba_step_int8", **report)
    res["launches_step_int8"] = ed_launches(lambda: gen(qstep), steps)
    # the "unpack" step signature: captured == eager on one step
    one = [b.clone() for b in batches[-1]]
    with eager():
        ref = qstep(one, as_numpy=False)
    qstep(one, as_numpy=False)
    assert outputs_equal(qstep(one, as_numpy=False), ref), "Mamba unpack"
    res["launches_step_kernel_forward"] = ed_packed(
        "mamba_step_int8", qstep, [b.clone() for b in batches[-1]], card)
    with packed_execution("kernel"):
        ed_shadow_check("mamba_step_int8_kernel",
                 lambda: generate_mamba(qstep, prompt[:, :2], wte, 2), card)
        ids_k, res["int8_kernel_s"] = synced_seconds(lambda: gen(qstep))
        res["launches_step_kernel"] = ed_launches(lambda: gen(qstep), steps)
        res["step_int8_kernel"] = captured_decode(
            "mamba_step_int8", card, qstep, checked, eq, toks, dtype="f32",
            packed_execution="kernel", new=MAMBA_CHECK_NEW)
    ids_u, res["int8_unpack_s"] = synced_seconds(lambda: gen(qstep))
    say("z-mamba-step", new=MAMBA_NEW, int8_agreement_float=float(
        (ids_u == ids_f)[:, MAMBA_PROMPT:].mean()),
        **{f"{k}_ms_per_step": res[f"{k}_s"] / steps * 1e3
           for k in ("float", "int8_kernel", "int8_unpack")},
        kernel_tokens_equal_unpack=bool(eq(ids_k, ids_u)),
        splitk_qmatmul_per_step=res["launches_step_kernel"][
            "splitk_qmatmul"], card=card.replace(" ", "_"))
    assert eq(ids_k, ids_u), "Mamba int8 step: kernel tokens != unpack"

    # the engine: the state_carry layout, 16 ragged requests on 8 slots
    reqs = []
    for _ in range(MAMBA_REQS):
        plen = int(rng.integers(1, 9))
        new = int(rng.integers(MAMBA_BUDGETS[0], MAMBA_BUDGETS[1] + 1))
        reqs.append((rng.integers(0, vocab, plen).astype(np.int32), new))

    def engine(m):
        eng = ContinuousBatcher(m, wte, state_carry=True, max_len=MAMBA_IDS)
        out = eng.run(reqs)
        return out, eng.stats["steps"]
    with packed_execution("kernel"):
        res["engine"] = captured_decode(
            "mamba_engine", card, qstep, engine,
            lambda a, b: a.keys() == b.keys() and all(eq(a[k], b[k])
                                                      for k in a),
            lambda out: generated(out, reqs), dtype="f32", slots=MAMBA_B,
            requests=MAMBA_REQS, packed_execution="kernel")
        got, _ = engine(qstep)
        for rid, (p, new) in enumerate(reqs):
            solo = generate_mamba(qstep, np.repeat(p[None], MAMBA_B, 0), wte,
                                  new)[0]
            assert eq(got[rid], solo), f"Mamba engine request {rid}"
    say("z-mamba-engine", requests=MAMBA_REQS, slots=MAMBA_B,
        tokens_equal_generate_mamba_alone=True,
        seconds=time.perf_counter() - t0, card=card.replace(" ", "_"))
    res["seconds"] = time.perf_counter() - t0
    return res


def mixtral_z(card: str) -> dict:
    """Phase 22(c): Mixtral-8x7B widths, MIXTRAL_LAYERS of its 32 layers."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.models import moe as MX
    from numpy_quant_tpu_torch.utils import (decode_calibration, generate,
                                             generate_kv,
                                             merge_calibration_stats)
    t0 = time.perf_counter()
    cfg = dict(MX.MIXTRAL_8X7B, num_hidden_layers=MIXTRAL_LAYERS)
    vocab, heads = cfg["vocab_size"], cfg["num_attention_heads"]
    torch.cuda.reset_peak_memory_stats()
    w = MX.random_mixtral_weights(cfg, seed=0, device="cuda")
    res = {"draw_s": time.perf_counter() - t0}
    rng = np.random.default_rng(22)

    # the int8 full form at B=1, N=2048: 2 plain fusions at D=128
    ts = time.perf_counter()
    proto = MX.mixtral_causal_lm(w, cfg, batch_size=1, seq_len=MIXTRAL_N)
    wte = proto._wte
    model = Model.from_onnx(proto)
    del proto
    res["build_full_s"] = time.perf_counter() - ts
    calib = wte[rng.integers(0, vocab, (1, MIXTRAL_N))]
    x = torch.from_numpy(wte[rng.integers(0, vocab, (1, MIXTRAL_N))]).cuda()
    ts = time.perf_counter()
    stats = model.calibration_stats([calib])
    qmodel = model.quantize(bit_width=8, stats=stats)
    res["calibrate_quantize_s"] = time.perf_counter() - ts
    with eager():
        f_logits = model([x], as_numpy=False)[0]
    del model, stats
    with eager():
        unfused = qmodel([x], as_numpy=False)[0]
    report = qmodel.optimize()
    plain = qmodel.fusion_report.get("plain_fusions", [])
    say("z-optimize", path="mixtral_full_int8", **report)
    assert report["fuse_attention"] == MIXTRAL_LAYERS == len(plain), report
    assert len(report["fusion_failures"]) == MIXTRAL_LAYERS, report  # routers
    ed_shadow_check("mixtral_full_int8", lambda: qmodel([x]), card)
    with eager():
        fused, counts = counted(lambda: qmodel([x], as_numpy=False)[0])
    ordered = exact_in_order(heads * A.plain_tile(MIXTRAL_N), MIXTRAL_N)
    equal = bool(torch.equal(fused, unfused))
    res["launches_full_int8"] = {k: counts[k] for k in ED_KERNELS}
    say("z-mixtral-full", batch=1, seq=MIXTRAL_N, head_dim=cfg["hidden_size"]
        // heads, fused_attention_launches=counts["fused_attention"],
        exact_in_order=ordered, fused_equals_unfused_bitwise=equal,
        int8_top1_agreement_float=float(
            (fused.argmax(-1) == f_logits.argmax(-1)).float().mean()),
        card=card.replace(" ", "_"))
    assert counts["fused_attention"] == MIXTRAL_LAYERS, counts
    assert equal or not ordered, "Mixtral: fused f32 != unfused"
    res["full_int8"] = captured_forward(
        "mixtral_full_int8", card, qmodel, [x], MIXTRAL_N, "tokens",
        reps=Z_REPS, dtype="f32", batch=1, seq=MIXTRAL_N)
    del qmodel, fused, unfused, f_logits

    # the full form at L=64, B=8: the greedy tokens the step is held to,
    # and its router choices at every position
    ts = time.perf_counter()
    proto = MX.mixtral_causal_lm(w, cfg, batch_size=MIXTRAL_B,
                                 seq_len=MIXTRAL_L)
    full = Model.from_onnx(proto)
    del proto
    prompt = rng.integers(0, vocab, (MIXTRAL_B, MIXTRAL_PROMPT)) \
        .astype(np.int32)
    new = MIXTRAL_L - MIXTRAL_PROMPT
    ids_full = generate(full, prompt, wte, new)
    emb = torch.from_numpy(wte[ids_full]).cuda()
    logits_full = full([emb], as_numpy=False, record=True)[0]
    topk = [next(v for v in full.values
                 if v.name == f"layers.{i}.moe/TopK_1").data.data.clone()
            for i in range(MIXTRAL_LAYERS)]
    del full
    res["full_l64_s"] = time.perf_counter() - ts

    # the decode step at B=8, cache 512: float, int8 (int8 cache), W4
    ts = time.perf_counter()
    proto = MX.mixtral_decode_step(w, cfg, batch_size=MIXTRAL_B,
                                   max_len=MIXTRAL_CACHE)
    rope = proto._rope_tables
    step = Model.from_onnx(proto)
    del proto, w
    res["build_step_s"] = time.perf_counter() - ts
    steps = MIXTRAL_L - 1
    eq = np.array_equal

    def gen(m, **kw):
        return generate_kv(m, prompt, wte, None, new, rope=rope, **kw)

    def toks(ids):
        return ids.shape[0] * new
    res["step_float"] = captured_decode(
        "mixtral_step_float", card, step, lambda m: (gen(m), steps), eq,
        toks, dtype="f32", batch=MIXTRAL_B, cache=MIXTRAL_CACHE)
    rows = []
    ids_f = gen(step, step_logits=rows)
    res["step_vs_full"] = step_margin_rule("mixtral_step_float", ids_f, rows,
                                           ids_full, logits_full)
    # the step's router choices replayed on the full form's tokens
    batches = decode_calibration(step, ids_full, wte, None, rope=rope)
    same, total = 0, 0
    with eager():
        for t, inputs in enumerate(batches):
            step(inputs, record=True)
            for i in range(MIXTRAL_LAYERS):
                got = next(v for v in step.values if v.name ==
                           f"layers.{i}.moe/TopK_1").data.data[:, 0]
                same += int((got == topk[i][:, t]).all(dim=-1).sum())
                total += MIXTRAL_B
    say("z-mixtral-routing", positions=len(batches), layers=MIXTRAL_LAYERS,
        top2_equal=f"{same}/{total}", card=card.replace(" ", "_"))
    assert same == total, (same, total)
    stats = merge_calibration_stats(*[step.calibration_stats(b)
                                      for b in batches[:MIXTRAL_PROMPT]])
    del batches
    qstep = step.quantize(stats=stats, bit_width=8)
    report = qstep.optimize()
    say("z-optimize", path="mixtral_step_int8", **report)
    assert report["fuse_decode_attention"] == MIXTRAL_LAYERS, report
    ed_shadow_check("mixtral_step_int8", lambda: generate_kv(
        qstep, prompt[:, :2], wte, None, 2, rope=rope, kv_cache_dtype="int8"),
        card)
    res["step_int8_cache"] = captured_decode(
        "mixtral_step_int8", card, qstep,
        lambda m: (gen(m, kv_cache_dtype="int8"), steps), eq, toks,
        dtype="f32", cache_dtype="int8")
    ids_q = gen(qstep, kv_cache_dtype="int8")
    res["launches_step_int8"] = ed_launches(
        lambda: gen(qstep, kv_cache_dtype="int8"), steps)
    del qstep
    n_w4 = step.quantize_weights(bit_width=4, group_size=128)
    with packed_execution("kernel"):
        ed_shadow_check("mixtral_step_w4", lambda: generate_kv(
            step, prompt[:, :2], wte, None, 2, rope=rope), card)
        res["step_w4"] = captured_decode(
            "mixtral_step_w4", card, step, lambda m: (gen(m), steps), eq,
            toks, dtype="f32", packed_execution="kernel")
        res["launches_step_w4"] = ed_launches(lambda: gen(step), steps)
        ids_w4 = gen(step)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    say("z-mixtral-step", int8_agreement_float=float(
        (ids_q == ids_f)[:, MIXTRAL_PROMPT:].mean()),
        w4_agreement_float=float((ids_w4 == ids_f)[:, MIXTRAL_PROMPT:].mean()),
        w4_weights=n_w4, splitk_wo_per_step=res["launches_step_w4"][
            "splitk_wo_matmul"], peak_device_bytes=res["peak_bytes"],
        draw_s=res["draw_s"], build_full_s=res["build_full_s"],
        build_step_s=res["build_step_s"],
        calibrate_quantize_s=res["calibrate_quantize_s"],
        seconds=time.perf_counter() - t0, card=card.replace(" ", "_"))
    assert res["launches_step_w4"]["splitk_wo_matmul"] == n_w4
    res["seconds"] = time.perf_counter() - t0
    return res


def clip_z(card: str) -> dict:
    """Phase 22(d): CLIP ViT-B/32 widths, 96 images against 1,000 prompts
    of 77 tokens (EOS at position 76)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models import clip as CL
    t0 = time.perf_counter()
    cfg = CL.CLIP_VIT_B32
    w = CL.random_clip_weights(cfg, seed=0)
    proto = CL.clip_dual_encoder(w, cfg, batch_images=CLIP_IMAGES,
                                 batch_texts=CLIP_PROMPTS, seq_len=CLIP_T)
    model = Model.from_onnx(proto)
    rng = np.random.default_rng(22)
    vocab = cfg["text"]["vocab_size"]
    ids = rng.integers(1, vocab - 1, (CLIP_PROMPTS, CLIP_T))
    ids[:, -1] = vocab - 1  # EOS at the pooled position
    emb = torch.from_numpy((proto._wte[ids] + proto._wpe[None, :CLIP_T])
                           .astype(np.float32)).cuda()
    px = torch.from_numpy(rng.normal(size=(CLIP_IMAGES, 3, 224, 224))
                          .astype(np.float32)).cuda()
    del proto, w
    inputs = [px, emb]
    with eager():
        f_logits = model(inputs, as_numpy=False)[0]
    qmodel = model.quantize(bit_width=8,
                            stats=model.calibration_stats(inputs))
    del model
    with eager():
        unfused = qmodel(inputs, as_numpy=False)[0]
    report = qmodel.optimize()
    say("z-optimize", path="clip_int8", **report)
    n_layers = cfg["vision"]["num_hidden_layers"] \
        + cfg["text"]["num_hidden_layers"]
    assert report["fuse_attention"] == n_layers, report
    assert report["fusion_failures"] == [], report
    ed_shadow_check("clip_int8", lambda: qmodel(inputs), card)
    with eager():
        fused, counts = counted(lambda: qmodel(inputs, as_numpy=False)[0])
    equal = bool(torch.equal(fused, unfused))
    agree = float((fused.argmax(-1) == f_logits.argmax(-1)).float().mean())
    res = {"launches": {k: counts[k] for k in ED_KERNELS}}
    say("z-clip", images=CLIP_IMAGES, prompts=CLIP_PROMPTS, tokens=CLIP_T,
        hs_launches=counts["fused_attention_hs"],
        fused_equals_unfused_bitwise=equal,
        int8_top1_agreement_float=agree, card=card.replace(" ", "_"))
    assert equal and counts["fused_attention_hs"] == n_layers, counts
    res["f32"] = captured_forward("clip_int8_f32", card, qmodel, inputs,
                                  CLIP_IMAGES, "images", reps=Z_REPS,
                                  dtype="f32")
    with config.low_precision_floats():
        bf = qmodel(inputs, as_numpy=False)[0]
        res["bf16"] = captured_forward("clip_int8_bf16", card, qmodel,
                                       inputs, CLIP_IMAGES, "images",
                                       reps=Z_REPS, dtype="bf16")
    say("z-clip-bf16", top1_agreement_f32=float(
        (bf.argmax(-1) == fused.argmax(-1)).float().mean()),
        card=card.replace(" ", "_"))
    res["seconds"] = time.perf_counter() - t0
    return res


def bert_z(card: str) -> dict:
    """Phase 22(e): BERT-base widths at B=32, 128 tokens, the ids a device
    int64 tensor (one capture serves every batch)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models import text as TT
    t0 = time.perf_counter()
    cfg = TT.BERT_BASE
    model = Model.from_onnx(TT.bert_text_classifier(
        TT.random_bert_weights(cfg, seed=0), cfg, batch_size=BERT_B,
        seq_len=BERT_T))
    rng = np.random.default_rng(23)
    batches = [torch.from_numpy(rng.integers(
        0, cfg["vocab_size"], (BERT_B, BERT_T))).cuda() for _ in range(3)]
    ids = batches[0]
    with eager():
        f_logits = model([ids], as_numpy=False)[0]
    qmodel = model.quantize(bit_width=8, stats=model.calibration_stats(
        [ids.cpu().numpy()]))
    del model
    with eager():
        unfused = qmodel([ids], as_numpy=False)[0]
    report = qmodel.optimize()
    say("z-optimize", path="bert_int8", **report)
    assert report["fuse_attention"] == cfg["num_hidden_layers"], report
    assert report["fusion_failures"] == [], report
    ed_shadow_check("bert_int8", lambda: qmodel([ids]), card)
    with eager():
        fused, counts = counted(lambda: qmodel([ids], as_numpy=False)[0])
    equal = bool(torch.equal(fused, unfused))
    res = {"launches": {k: counts[k] for k in ED_KERNELS}}
    assert equal, "BERT: fused f32 != unfused"
    res["f32"] = captured_forward("bert_int8_f32", card, qmodel, [ids],
                                  BERT_B, "sequences", reps=Z_REPS,
                                  dtype="f32")
    # every batch of ids replays the one captured graph
    outs = [qmodel([b], as_numpy=False)[0] for b in batches]
    with eager():
        want = [qmodel([b], as_numpy=False)[0] for b in batches]
    graphs = len(qmodel._graphs)
    with config.low_precision_floats():
        bf = qmodel([ids], as_numpy=False)[0]
        res["bf16"] = captured_forward("bert_int8_bf16", card, qmodel, [ids],
                                       BERT_B, "sequences", reps=Z_REPS,
                                       dtype="bf16")
    say("z-bert", batch=BERT_B, seq=BERT_T,
        hs_launches=counts["fused_attention_hs"],
        fused_equals_unfused_bitwise=equal,
        label_agreement_float=float(
            (fused.argmax(-1) == f_logits.argmax(-1)).float().mean()),
        bf16_label_agreement_f32=float(
            (bf.argmax(-1) == fused.argmax(-1)).float().mean()),
        captures_for_3_batches=graphs, card=card.replace(" ", "_"))
    assert graphs == 1 and all(same_bits(a, b) for a, b in zip(outs, want))
    assert counts["fused_attention_hs"] == cfg["num_hidden_layers"], counts
    res["seconds"] = time.perf_counter() - t0
    return res


# (K, N) of Mixtral-8x7B's decode MatMuls: q/o, k/v, the router, w1/w3,
# w2 and the head
MIXTRAL_WO_SHAPES = ((4096, 4096), (4096, 1024), (4096, 8), (4096, 14336),
                     (14336, 4096), (4096, 32000))


def time_mixtral_attention(name: str) -> dict:
    """fused_attention at Mixtral's full-form shape (BH = 32, N = 2048,
    D = 128, causal), int8 and f32 out: held against its plain version (no
    flipped block where torch sums its rows in the kernel's order), then
    timed (median of 20 CUDA-event calls behind a device sleep) beside its
    bound and the plain version."""
    from numpy_quant_tpu_torch.kernels import attention as A
    rates = peaks(name)
    bh, n, d = 32, MIXTRAL_N, 128
    q, kt, v = plain_inputs(bh, n, d, seed=22)
    in_order = exact_in_order(bh * A.plain_tile(n), n)
    res = {}
    for out, rq in (("int8", OUT_REQUANT), ("f32", None)):
        kw = dict(QP, out_requant=rq, causal_mask_val=MASK_VAL)
        flips, blocks, err = attention_diff(
            A.fused_attention(q, kt, v, **kw),
            A.fused_attention_reference(q, kt, v, **kw), 1, rq, QP,
            f"plain BH{bh} N{n} D{d} {out}")
        assert not in_order or flips == 0, (out, flips, blocks)
        ms = cuda_ms(lambda: A.fused_attention(q, kt, v, **kw), lead=True)
        plain_ms = cuda_ms(lambda: A.fused_attention_reference(
            q, kt, v, **kw), lead=True)
        nbytes = 3 * q.numel() + q.numel() * (1 if rq else 4)
        ops = 2 * 2 * bh * (n * (n + 1) // 2) * d
        t_bytes = nbytes / rates["bytes"] * 1e3
        t_ops = ops / rates["int8"] * 1e3
        res[out] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                        flipped_blocks=f"{flips}/{blocks}",
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations")
        say("kernel-time", kernel="fused_attention", path="mixtral_full",
            form="exact", shape=f"BH{bh}xN{n}xD{d}", causal=True, out=out,
            in_torch_order=in_order, **res[out], bytes=nbytes, ops=ops,
            library="none", card=name.replace(" ", "_"))
    return res


def qat_zoo_phase(card: str) -> dict:
    """Phase 22: QAT (the MLP rules, JAX's ViT capstone on the small and
    the ViT-Base-width fixtures, BERT-base W4A8) and the rest of the model
    zoo at published widths (Mamba-130m, Mixtral-8x7B at MIXTRAL_LAYERS
    layers, CLIP ViT-B/32, BERT-base). Returns the results by part."""
    t_phase = time.perf_counter()
    res = {"qat_mlp": qat_mlp(card), "qat_vit": qat_vit(card, base=False),
           "qat_vit_base": qat_vit(card, base=True), "qat_bert": qat_bert(card),
           "mamba": mamba_z(card), "mixtral": mixtral_z(card),
           "clip": clip_z(card), "bert": bert_z(card)}
    import torch
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    res["times"] = {"attention": time_mixtral_attention(name),
                    "wo": time_wo(name, MIXTRAL_WO_SHAPES, "mixtral_decode"),
                    "seconds": None}
    res["times"]["seconds"] = time.perf_counter() - t0
    say("z-phase", seconds=time.perf_counter() - t_phase,
        **{f"{k}_s": v["seconds"] for k, v in res.items()},
        card=card.replace(" ", "_"))
    return res


def z_paths(z: dict) -> dict:
    """{path: launches per step or forward} of phase 22's results."""
    return {"per_mamba_full_int8_forward": z["mamba"]["launches_full_int8"],
            "per_mamba_int8_step_unpack": z["mamba"]["launches_step_int8"],
            "per_mamba_int8_step_kernel": z["mamba"]["launches_step_kernel"],
            "per_mixtral_full_int8_forward": z["mixtral"][
                "launches_full_int8"],
            "per_mixtral_int8_step": z["mixtral"]["launches_step_int8"],
            "per_mixtral_w4_step_kernel": z["mixtral"]["launches_step_w4"],
            "per_clip_int8_forward": z["clip"]["launches"],
            "per_bert_int8_forward": z["bert"]["launches"],
            "per_qat_vit_base_bf16_forward_kernel": z["qat_vit_base"][
                "launches"]}


PAR_WORLD = 4            # ranks of phase 23, all on the one card (gloo)
PAR_B = 32               # ViT-Base batch of 23(a) and 23(c)
PAR_MICRO = 4            # microbatches of the pipelines
PAR_LLAMA_LAYERS = 2     # TinyLlama-1.1B depth in 23(b) (of 22)
PAR_NEW = 12             # new tokens of each TP decode (prompt GPT_PROMPT)
PAR_REQS, PAR_SLOTS = 16, 8  # the TP engine's requests and slots
PAR_TIMEOUT = 600        # seconds any one rank call may take


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _par_quiet():
    """Ranks other than 0 print nothing (their checks still raise)."""
    if _rank():
        sys.stdout = open(os.devnull, "w")
    return _rank()


def _par_images(n: int, seed: int):
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, 3, 224, 224)).astype(np.float32) * 0.5).cuda()


def _par_mesh(kind: str):
    from numpy_quant_tpu_torch import parallel as par
    if kind == "dptp":
        return par.make_dp_tp_mesh(PAR_WORLD, tp=2)
    if kind == "tp":
        return par.make_dp_tp_mesh(PAR_WORLD, tp=PAR_WORLD)
    return par.make_mesh(PAR_WORLD, axes=("pipe", "model"), shape=(2, 2))


def rank_vit(path: str, kind: str, modes: tuple, card: str) -> dict:
    """23(a) on one rank: the saved int8 (or W3A8) ViT-Base loaded, sharded
    (DP x TP 2 x 2 or TP 4), optimize() (merges Q/K/V under TP),
    pack_weights() (row shards stacked), then one forward per packed
    execution with its launches counted, and one eager forward with every
    kernel launch held against its plain version at the shard shapes."""
    import torch.distributed as dist
    from numpy_quant_tpu_torch import parallel as par
    from numpy_quant_tpu_torch.utils.serialization import load_qmodel
    from numpy_quant_tpu_torch.ops import registry as R
    t0 = time.perf_counter()
    x = _par_images(PAR_B, 23)
    q = load_qmodel(path, device="cuda")
    mesh = _par_mesh(kind)
    par.shard_model(q, mesh, rules=par.vit_tp_rules)
    report = q.optimize()
    packed = q.pack_weights()
    layouts = {}
    for v in q.values:
        lay = getattr(getattr(v, "data", None), "layout", None)
        if lay is not None:
            layouts[lay] = layouts.get(lay, 0) + 1
    res = dict(report={k: v for k, v in report.items()
                       if k != "fusion_failures"},
               failures=len(report["fusion_failures"]), packed=packed,
               layouts=layouts, rank=dist.get_rank(),
               coords=mesh.coords, logits={}, counts={})
    heads = []
    orig = R.attention_call

    def spy(*a, **kw):
        out = orig(*a, **kw)
        heads.append(out[3]["num_heads"])
        return out

    for mode in modes:
        with packed_execution(mode):
            R.attention_call = spy
            try:
                logits, counts = counted(lambda: q([x])[0])
            finally:
                R.attention_call = orig
        res["logits"][mode] = logits
        res["counts"][mode] = counts
    res["heads"] = sorted(set(heads))
    tp = mesh.shape["model"]
    b_local = PAR_B // mesh.shape["data"]
    for nq in (N_TOK, 1):
        assert exact_in_order(b_local * HEADS // tp * nq, N_TOK)
    with packed_execution(modes[-1]):
        res["shadow"] = {k: v[:2] for k, v in ed_shadow_check(
            f"par_vit_{kind}_r{dist.get_rank()}", lambda: q([x])[0],
            card).items()}
    res["seconds"] = time.perf_counter() - t0
    return res


def rank_decode(paths: dict, card: str) -> dict:
    """23(b) on one rank. Pipe row 0 (ranks 0, 1) runs TP 2 decodes of the
    GPT-2 int8 step and the TinyLlama int8 step (built on the CPU, each
    rank moving its own shard to the card); row 1 (ranks 2, 3) runs the
    GPT-2 W4 g=128 step under "kernel" and the engine over the int8 GPT-2
    step. Returns the tokens."""
    import numpy as np
    from numpy_quant_tpu_torch import parallel as par
    from numpy_quant_tpu_torch.utils import generate_kv
    from numpy_quant_tpu_torch.utils.serialization import (load_qmodel,
                                                           load_weight_only)
    from numpy_quant_tpu_torch.utils.serving import ContinuousBatcher
    t0 = time.perf_counter()
    grid = _par_mesh("rows")
    row = grid.index("pipe")
    mesh = [grid.row("pipe", r, ("model",)) for r in range(2)][row]
    gpt = np.load(paths["gpt_tables"])
    prompt = np.load(paths["prompt"])
    res = {"row": row, "counts": {}}
    if row == 0:
        q = load_qmodel(paths["gpt_int8"], device="cuda")
        par.shard_model(q, mesh, rules=par.gpt_tp_rules)
        q.optimize()
        ids, counts = counted(lambda: generate_kv(
            q, prompt, gpt["wte"], gpt["wpe"], PAR_NEW))
        res["gpt_int8"], res["counts"]["gpt_int8"] = ids, counts
        llama = np.load(paths["llama_tables"])
        # built on the CPU: optimize() there (the merge forced, as the
        # mesh's gate would), then each rank moves its own shard
        lq = load_qmodel(paths["llama_int8"], device="cpu")
        lq._opt_merge_matmuls = True
        rep = lq.optimize()
        par.shard_model(lq, mesh, rules=par.llama_tp_rules)
        res["llama_merges"] = rep["merge_parallel_matmuls"]
        ids, counts = counted(lambda: generate_kv(
            lq, np.load(paths["llama_prompt"]), llama["wte"], None, PAR_NEW,
            rope=(llama["cos"], llama["sin"])))
        res["llama_int8"], res["counts"]["llama_int8"] = ids, counts
    else:
        w4 = load_weight_only(paths["gpt_w4"], device="cuda")
        par.shard_model(w4, mesh, rules=par.gpt_tp_rules)
        with packed_execution("kernel"):
            ids, counts = counted(lambda: generate_kv(
                w4, prompt, gpt["wte"], gpt["wpe"], PAR_NEW))
        res["gpt_w4"], res["counts"]["gpt_w4"] = ids, counts
        q = load_qmodel(paths["gpt_int8"], device="cuda")
        par.shard_model(q, mesh, rules=par.gpt_tp_rules)
        q.optimize()
        reqs = [(r[0], int(r[1])) for r in np.load(paths["reqs"],
                                                   allow_pickle=True)]
        eng = ContinuousBatcher(q, gpt["wte"], gpt["wpe"])
        res["engine"] = eng.run(reqs)
        res["engine_steps"] = eng.stats["steps"]
    res["seconds"] = time.perf_counter() - t0
    return res


def rank_pipe(path: str) -> dict:
    """23(c) on one rank: the saved int8 ViT-Base, optimize() (no mesh: no
    merge), split_stages(2); a GPipe of 2 stages x PAR_MICRO microbatches
    on ranks 0 and 1, then PP x TP (2 x 2) over every rank."""
    from numpy_quant_tpu_torch import parallel as par
    from numpy_quant_tpu_torch.utils.serialization import load_qmodel
    t0 = time.perf_counter()
    x = _par_images(PAR_B, 23)
    q = load_qmodel(path, device="cuda")
    q.optimize()
    pipe = par.make_mesh(2, axes=("pipe",))
    res = {}
    if pipe.member:
        stages = par.split_stages(q, 2)
        res["cut"] = stages[1].inputs[0].name
        res["gpipe"], res["gpipe_counts"] = counted(
            lambda: par.pipeline_forward(stages, pipe, x,
                                         ((PAR_B, 1000), "float32"),
                                         PAR_MICRO))
    stages = par.split_stages(q, 2)
    res["pp_tp"], res["pp_tp_counts"] = counted(
        lambda: par.pipeline_forward_stagewise(
            stages, _par_mesh("rows"), x, PAR_MICRO, rules=par.vit_tp_rules))
    res["seconds"] = time.perf_counter() - t0
    return res


def par_kernel_row(name: str, label: str, shape: str, fn, ref, nbytes: int,
                   ops: int, rate: str, equal) -> dict:
    """One kernel at a shard shape: against its plain version (``equal``
    (got, want) -> mismatches), then timed beside its plain version and
    its bound."""
    import torch
    rates = peaks(name)
    got, want = fn(), ref()
    torch.cuda.synchronize()
    mismatches = equal(got, want)
    del got, want
    ms = cuda_ms(fn, lead=True)
    plain_ms = cuda_ms(ref, lead=True)
    t_bytes = nbytes / rates["bytes"] * 1e3
    t_ops = ops / rates[rate] * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               mismatches=mismatches)
    say("par-kernel", kernel=label, shape=shape, **row, bytes=nbytes,
        ops=ops, card=name.replace(" ", "_"))
    return row


PAR_PLAIN_N = 510  # 23(d)'s rank rows of fused_attention: N % 4 == 2


def par_kernels(name: str) -> dict:
    """23(d): every kernel at the shard shapes phase 23 gives it, in this
    process, against its plain version (0 mismatches; the exact attention
    forms where torch sums their rows in the kernels' order), timed; and
    merged against unmerged Q/K/V products (torch._int_mm) at ViT-Base's
    N = 768, 384 and 192."""
    import torch
    from numpy_quant_tpu_torch import intops
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}

    def neq(a, b):
        return int((a != b).sum())

    # head-split attention: ViT-Base at H/tp = 6 (B 16) and 3 (B 32),
    # exact f32 out (the f32 path) and serving int8 out
    for b, heads in ((PAR_B // 2, HEADS // 2), (PAR_B, HEADS // 4)):
        q, k, v = attention_inputs(b, N_TOK, seed=230 + heads, heads=heads)
        for form, rq in (("exact", None), ("fast", OUT_REQUANT)):
            # the second rank's heads: each row summed where it lies
            # among all HEADS (kernels/attention.py::_row_sums)
            kw = attention_kw(heads, form, "none", rq, QP, head_base=heads,
                              head_total=HEADS)
            in_order = form != "exact" or exact_in_order(b * HEADS * N_TOK,
                                                         N_TOK)
            plan = A.hs_plan(N_TOK, N_TOK, HEAD_DIM, b * heads,
                             exact=form == "exact")
            row = par_kernel_row(
                name, "fused_attention_hs", f"B{b}xN{N_TOK}xH{heads}",
                lambda: A.fused_attention_hs(q, k, v, **kw),
                lambda: A.fused_attention_hs_reference(q, k, v, **kw),
                3 * q.numel() + q.numel() * (1 if rq else 4),
                4 * b * heads * N_TOK * N_TOK * HEAD_DIM, "int8",
                neq if form == "exact" and in_order else
                lambda g, w: attention_diff(g, w, heads, rq, QP,
                                            f"par {b}x{heads} {form}")[0])
            row["plan"] = str(plan).replace(" ", "")
            res[f"fused_attention_hs:B{b}xH{heads}:{form}"] = row
            if form == "exact":
                assert row["mismatches"] == 0, row
    # blockwise: GPT-2 scoring under TP 2 (B 8, N 1024, H 6, causal)
    q, k, v = attention_inputs(8, GPT_SEQ, seed=236, n=GPT_SEQ,
                               heads=HEADS // 2)
    kw = attention_kw(HEADS // 2, "exact", "full", OUT_REQUANT, QP,
                      head_base=HEADS // 2, head_total=HEADS)
    row = par_kernel_row(
        name, "fused_attention_hs_blockq", f"B8xN{GPT_SEQ}xH6",
        lambda: A.fused_attention_hs_blockq(q, k, v, **kw),
        lambda: A.fused_attention_hs_blockq_reference(q, k, v, **kw),
        4 * q.numel(), 2 * 8 * 6 * GPT_SEQ * (GPT_SEQ + 1) * HEAD_DIM,
        "int8", lambda g, w: attention_diff(g, w, HEADS // 2, OUT_REQUANT,
                                            QP, "par blockq H6")[0])
    res["fused_attention_hs_blockq:B8xN1024xH6"] = row
    # pre-split attention: TinyLlama prefill under TP 2 (BH = 4 * 16)
    bh = LLAMA_B * 16
    q, kt, v = plain_inputs(bh, LLAMA_SEQ, 64, seed=237)
    kw = dict(QP, out_requant=OUT_REQUANT, causal_mask_val=MASK_VAL)
    in_order = exact_in_order(bh * A.plain_tile(LLAMA_SEQ), LLAMA_SEQ)
    row = par_kernel_row(
        name, "fused_attention", f"BH{bh}xN{LLAMA_SEQ}xD64",
        lambda: A.fused_attention(q, kt, v, **kw),
        lambda: A.fused_attention_reference(q, kt, v, **kw),
        4 * q.numel(), 2 * 2 * bh * (LLAMA_SEQ * (LLAMA_SEQ + 1) // 2) * 64,
        "int8", lambda g, w: attention_diff(g, w, 1, OUT_REQUANT, QP,
                                            "par plain BH64")[0])
    assert not in_order or row["mismatches"] == 0, row
    res[f"fused_attention:BH{bh}"] = row
    # the same kernel's rows at N % 4 != 0: each rank's heads (TP 2, 16 of
    # TinyLlama's 32 per batch row) sum their softmax rows where they lie
    # among all heads (num_heads / head_base / head_total), so each rank's
    # result equals the single process's bit for bit
    heads, n = 32, PAR_PLAIN_N
    q, kt, v = plain_inputs(LLAMA_B * heads, n, 64, seed=239)
    kw = dict(QP, causal_mask_val=MASK_VAL)
    whole = A.fused_attention(q, kt, v, **kw) \
        .reshape(LLAMA_B, heads, n, 64)
    in_order = exact_in_order(LLAMA_B * heads * A.plain_tile(n), n)
    apart = {"placed": 0, "local": 0}
    for r in range(2):
        sl = slice(r * heads // 2, (r + 1) * heads // 2)
        qr, ktr, vr = (t.reshape(LLAMA_B, heads, *t.shape[1:])[:, sl]
                       .reshape(-1, *t.shape[1:]).contiguous()
                       for t in (q, kt, v))
        want = whole[:, sl].reshape(-1, n, 64)
        apart["placed"] += neq(A.fused_attention(
            qr, ktr, vr, num_heads=heads // 2, head_base=r * heads // 2,
            head_total=heads, **kw), want)
        apart["local"] += neq(A.fused_attention(qr, ktr, vr, **kw), want)
    say("par-plain-rows", shape=f"B{LLAMA_B}xH{heads}xN{n}xD64", tp=2,
        n_mod_4=n % 4, in_torch_order=in_order,
        rank_mismatches_placed=apart["placed"],
        rank_mismatches_local_alignment=apart["local"])
    assert not in_order or apart["placed"] == 0, apart
    res[f"fused_attention:tp_rows:N{n}"] = dict(
        mismatches=apart["placed"], local_alignment=apart["local"])
    # packed products at N/tp (merged Q/K/V, fc1) and K/tp (the stacked
    # row groups' widths), W8 split-K, W4 per channel and W3 bit-planes
    for kname, layout, bits, per_channel in (
            ("splitk_qmatmul", "splitk", 8, False),
            ("splitk_qmatmul", "splitk", 4, True),
            ("packed_qmatmul", "bitplanes", 3, True)):
        fn, ref = getattr(Q, kname), getattr(Q, kname + "_reference")
        for m, k, n in ((PAR_B // 2 * N_TOK, 768, 3 * 768 // 2),
                        (PAR_B // 2 * N_TOK, 768, 3072 // 2),
                        (PAR_B * N_TOK, 768, 768 // 4),
                        (PAR_B * N_TOK, 768, 3072 // 4),
                        (PAR_B // 2 * N_TOK, 3072 // 2, 768),
                        (PAR_B * N_TOK, 768 // 4, 768)):
            x, payload, colsum, _, wvec, kw, _ = qmm_operands(
                layout, bits, m, k, n, seed=238, per_channel=per_channel,
                quantize_x=False, bias=False, requant=False)
            plan = Q.qmm_plan(m, n, k, bits, layout, sms)
            row = par_kernel_row(
                name, kname, f"W{bits}:M{m}xK{k}xN{n}",
                lambda: fn(x, payload, colsum, None, wvec, **kw),
                lambda: ref(x, payload, colsum, None, wvec, **kw),
                x.numel() + payload.numel() + 8 * n + 4 * m * n,
                2 * m * n * k, "int8", neq)
            row["plan"] = ",".join(f"{key}={plan[key]}" for key in (
                "bn", "stages", "panels", "ranges", "slabs"))
            res[f"{kname}:W{bits}:M{m}xK{k}xN{n}"] = row
            assert row["mismatches"] == 0, row
    # weight-only at the GPT-2 TP 2 decode widths (M = 8, W4 g = 128)
    for k, n in ((768, 2304 // 2), (768, 3072 // 2)):
        for dtype, tol in ((torch.float32, WO_TOL["f32"]),
                           (torch.bfloat16, WO_TOL["bf16"])):
            x, payload, scale = wo_operands(4, GPT_B, k, n, k // WO_GROUP,
                                            seed=239, dtype=dtype)
            plan = Q.wo_plan(GPT_B, n, payload.shape[0], 4, sms)

            def within(g, w, tol=tol):
                top = float(w.float().abs().max())
                return int(float((g.float() - w.float()).abs().max())
                           > tol * top)
            row = par_kernel_row(
                name, "splitk_wo_matmul",
                f"{str(dtype)[6:]}:M{GPT_B}xK{k}xN{n}",
                lambda: Q.splitk_wo_matmul(x, payload, scale, bits=4),
                lambda: Q.splitk_wo_matmul_reference(x, payload, scale,
                                                     bits=4),
                x.numel() * x.element_size() + payload.numel()
                + 4 * scale.numel() + GPT_B * n * x.element_size(),
                2 * GPT_B * n * k,
                "f32" if dtype == torch.float32 else "bf16", within)
            row["plan"] = f"cluster={plan['cluster']}"
            res[f"splitk_wo_matmul:{str(dtype)[6:]}:K{k}xN{n}"] = row
            assert row["mismatches"] == 0, row
    # merged against unmerged Q/K/V products at ViT-Base's N per rank
    m = PAR_B // 2 * N_TOK
    x8 = torch.randint(-128, 128, (m, 768), dtype=torch.int8, device="cuda")
    merge = {}
    for n in (768, 384, 192):
        ws = [torch.randint(-127, 128, (768, n), dtype=torch.int8,
                            device="cuda") for _ in range(3)]
        wm = torch.cat(ws, 1)
        sep = cuda_ms(lambda: [intops.int_matmul(x8, w) for w in ws],
                      lead=True)
        one = cuda_ms(lambda: intops.int_matmul(x8, wm), lead=True)
        merge[n] = dict(unmerged_ms=sep, merged_ms=one,
                        merged_over_unmerged=one / sep)
        say("par-merge", m=m, k=768, n=n, unmerged_ms=sep, merged_ms=one,
            merged_over_unmerged=one / sep, card=name.replace(" ", "_"))
    res["merge"] = merge
    return res


def par_models(tmp: str) -> tuple[dict, dict]:
    """23's models, quantized once here and saved under ``tmp`` for the
    ranks: (paths, the single-process port's results on this card)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.gpt import (GPT2_SMALL, gpt_decode_step,
                                                  random_gpt2_weights)
    from numpy_quant_tpu_torch.models.llama import (TINYLLAMA_1_1B,
                                                    llama_decode_step,
                                                    random_llama_weights)
    from numpy_quant_tpu_torch.models.vit import (VIT_BASE, WEIGHT_CONFIGS,
                                                  random_vit_weights,
                                                  vit_image_classifier)
    from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                             merge_calibration_stats)
    from numpy_quant_tpu_torch.utils.serialization import (save_qmodel,
                                                           save_weight_only)
    t0 = time.perf_counter()
    proto = vit_image_classifier(random_vit_weights(VIT_BASE, seed=0),
                                 VIT_BASE)
    fmodel = Model.from_onnx(proto)
    calib = _par_images(2, 0)
    stats = fmodel.calibration_stats([calib])
    paths = {}
    singles = {}
    x = _par_images(PAR_B, 23)
    for mode in ("int8", "w3a8"):
        kw = dict(bit_width=8, quantize_conv=True) if mode == "int8" \
            else dict(WEIGHT_CONFIGS[mode], quantize_conv=True)
        q = fmodel.quantize(stats=stats, **kw)
        paths[mode] = os.path.join(tmp, f"vit_{mode}.onnx")
        save_qmodel(q, paths[mode], proto)
        q.optimize()
        q.pack_weights()
        singles[mode] = {m: packed_forward(q, x, m)[0]
                         for m in ("unpack", "kernel")}
    say("par-setup", part="vit", seconds=time.perf_counter() - t0)

    gw = random_gpt2_weights(GPT2_SMALL, seed=0)
    gproto = gpt_decode_step(gw, GPT2_SMALL, batch_size=GPT_B,
                             max_len=GPT_MAX_LEN)
    del gw
    vocab = GPT2_SMALL["vocab_size"]
    prompt = np.random.default_rng(23).integers(
        0, vocab, size=(GPT_B, GPT_PROMPT)).astype(np.int32)
    gmodel = Model.from_onnx(gproto)
    batches = decode_calibration(gmodel, prompt, gproto._wte,
                                 gproto._wpe)
    gstats = merge_calibration_stats(*[gmodel.calibration_stats(b)
                                       for b in batches])
    del batches
    gq = gmodel.quantize(bit_width=8, stats=gstats)
    paths["gpt_int8"] = os.path.join(tmp, "gpt_int8.onnx")
    save_qmodel(gq, paths["gpt_int8"], gproto)
    gq.optimize()
    gmodel.quantize_weights(bit_width=4, group_size=WO_GROUP)
    paths["gpt_w4"] = os.path.join(tmp, "gpt_w4.onnx")
    save_weight_only(gmodel, paths["gpt_w4"], gproto)
    paths["gpt_tables"] = os.path.join(tmp, "gpt_tables.npz")
    np.savez(paths["gpt_tables"], wte=gproto._wte, wpe=gproto._wpe)
    paths["prompt"] = os.path.join(tmp, "prompt.npy")
    np.save(paths["prompt"], prompt)
    rng = np.random.default_rng(24)
    reqs = [(rng.integers(0, vocab, size=(int(rng.integers(1, 9)),))
             .astype(np.int32), int(rng.integers(8, 25)))
            for _ in range(PAR_REQS)]
    paths["reqs"] = os.path.join(tmp, "reqs.npy")
    arr = np.empty(len(reqs), dtype=object)
    arr[:] = [np.array([p, n], dtype=object) for p, n in reqs]
    np.save(paths["reqs"], arr, allow_pickle=True)

    lcfg = dict(TINYLLAMA_1_1B, num_hidden_layers=PAR_LLAMA_LAYERS)
    lproto = llama_decode_step(random_llama_weights(lcfg, seed=0), lcfg,
                               batch_size=GPT_B, max_len=GPT_MAX_LEN)
    lmodel = Model.from_onnx(lproto)
    lprompt = np.random.default_rng(25).integers(
        0, lcfg["vocab_size"], size=(GPT_B, GPT_PROMPT)).astype(np.int32)
    rope = lproto._rope_tables
    batches = decode_calibration(lmodel, lprompt, lproto._wte, None,
                                 rope=rope)
    lstats = merge_calibration_stats(*[lmodel.calibration_stats(b)
                                       for b in batches])
    del batches
    lq = lmodel.quantize(bit_width=8, stats=lstats)
    del lmodel
    paths["llama_int8"] = os.path.join(tmp, "llama_int8.onnx")
    save_qmodel(lq, paths["llama_int8"], lproto)
    lq.optimize()
    paths["llama_tables"] = os.path.join(tmp, "llama_tables.npz")
    np.savez(paths["llama_tables"], wte=lproto._wte, cos=rope[0],
             sin=rope[1])
    paths["llama_prompt"] = os.path.join(tmp, "llama_prompt.npy")
    np.save(paths["llama_prompt"], lprompt)
    say("par-setup", part="decoders", seconds=time.perf_counter() - t0)

    # the single-process port on this card
    want = {"gpt_int8": generate_kv(gq, prompt, gproto._wte, gproto._wpe,
                                    PAR_NEW),
            "llama_int8": generate_kv(lq, lprompt, lproto._wte, None,
                                      PAR_NEW, rope=rope)}
    with packed_execution("kernel"):
        want["gpt_w4"] = generate_kv(gmodel, prompt, gproto._wte,
                                     gproto._wpe, PAR_NEW)
    solo = {}
    for rid, (p, n) in enumerate(reqs):
        solo[rid] = generate_kv(gq, np.repeat(p[None], GPT_B, 0),
                                gproto._wte, gproto._wpe, n)[0]
    del lq, lproto
    torch.cuda.empty_cache()
    say("par-setup", part="single_process", seconds=time.perf_counter()
        - t0)

    ref = dict(singles=singles, want=want, solo=solo, proto=proto,
               fmodel=fmodel, stats=stats, x=x)
    return paths, ref


def parallel_phase(card: str) -> dict:
    """Phase 23: data, tensor and pipeline parallelism on the card. The
    parent quantizes each model once and hands the ranks the files; four
    ranks share the one card over gloo (every collective through the
    host), so no time here is a scaling figure. Each sharded result is held
    against this process's single-process port on the same card."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, parallel as par
    from numpy_quant_tpu_torch.models.vit import WEIGHT_CONFIGS
    from numpy_quant_tpu_torch.parallel.mesh import Mesh
    from numpy_quant_tpu_torch.utils.serialization import (
        export_qdq, load_qmodel, save_qmodel)
    name = torch.cuda.get_device_name(0)
    cardw = card.replace(" ", "_")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="nq_par_")
    res = {"launches": {}}
    try:
        paths, ref = par_models(tmp)
        singles, want, solo = ref["singles"], ref["want"], ref["solo"]
        proto, fmodel, stats, x = (ref["proto"], ref["fmodel"], ref["stats"],
                                   ref["x"])
        # ---- the ranks ----
        t_ranks = time.perf_counter()
        with par.Ranks(PAR_WORLD, backend="gloo", device="cuda",
                       timeout_s=PAR_TIMEOUT) as ranks:
            ranks.run(_par_quiet)
            say("par-ranks", world=PAR_WORLD, backend="gloo", device="cuda:0",
                up_seconds=time.perf_counter() - t_ranks,
                note="one_card_time_slices_the_ranks:no_time_here_is_a_"
                     "scaling_figure")
            # (a) ViT-Base: DP x TP 2 x 2 and TP 4, int8, both executions
            for kind in ("dptp", "tp"):
                t0 = time.perf_counter()
                out = ranks.run(rank_vit, paths["int8"], kind,
                                ("unpack", "kernel"), card)
                tp = 2 if kind == "dptp" else 4
                for r in out:
                    for mode in ("unpack", "kernel"):
                        assert np.array_equal(r["logits"][mode],
                                              singles["int8"][mode]), \
                            (kind, r["rank"], mode)
                    assert r["report"]["merge_parallel_matmuls"] == 12, r
                    assert r["layouts"].get("splitk_stacked") == 24, r
                    assert r["heads"] == [HEADS // tp], r["heads"]
                    c = r["counts"]["kernel"]
                    assert c["fused_attention_hs"] == 12, c
                    assert c["splitk_qmatmul"] == 24, c
                res["launches"][f"vit_int8_{kind}_kernel"] = \
                    out[0]["counts"]["kernel"]
                say("par-vit", mesh=kind, world=PAR_WORLD,
                    groups=f"data{4 // tp}xmodel{tp}", batch=PAR_B,
                    heads_per_rank=out[0]["heads"][0],
                    merges=out[0]["report"]["merge_parallel_matmuls"],
                    stacked=out[0]["layouts"].get("splitk_stacked"),
                    logits_equal_single_process_bitwise=True,
                    kernel_launches_per_rank=",".join(
                        f"{k}:{v}" for k, v in
                        out[0]["counts"]["kernel"].items() if v),
                    shadow=",".join(f"{k}:{v[0]}calls:{v[1]}mismatches"
                                    for k, v in out[0]["shadow"].items()),
                    seconds=time.perf_counter() - t0, card=cardw)
            t0 = time.perf_counter()
            out = ranks.run(rank_vit, paths["w3a8"], "dptp", ("kernel",),
                            card)
            for r in out:
                assert np.array_equal(r["logits"]["kernel"],
                                      singles["w3a8"]["kernel"]), r["rank"]
                assert r["counts"]["kernel"]["packed_qmatmul"] > 0, r
            res["launches"]["vit_w3a8_dptp_kernel"] = \
                out[0]["counts"]["kernel"]
            say("par-vit", mesh="dptp", mode="w3a8", world=PAR_WORLD,
                logits_equal_single_process_bitwise=True,
                packed_qmatmul_per_rank=out[0]["counts"]["kernel"][
                    "packed_qmatmul"],
                seconds=time.perf_counter() - t0, card=cardw)
            # (b) decode under TP 2
            t0 = time.perf_counter()
            out = ranks.run(rank_decode, paths, card)
            by_row = {r["row"]: r for r in out}
            for rank, r in enumerate(out):
                for key in ("gpt_int8", "llama_int8", "gpt_w4"):
                    if key not in r:
                        continue
                    apart = np.argwhere(r[key] != want[key])
                    say("par-decode-tokens", rank=rank, path=key,
                        tokens_apart=len(apart),
                        first_apart=apart[:1].tolist(),
                        prompt=GPT_PROMPT, new_tokens=PAR_NEW)
                    assert len(apart) == 0, (rank, key)
            for r in out:
                if r["row"] == 1:
                    assert sorted(r["engine"]) == list(range(PAR_REQS))
                    for rid, toks in r["engine"].items():
                        assert np.array_equal(np.asarray(toks), solo[rid]), \
                            rid
            for key, r in (("gpt_int8", by_row[0]), ("llama_int8", by_row[0]),
                           ("gpt_w4", by_row[1])):
                res["launches"][f"decode_{key}"] = r["counts"][key]
            say("par-decode", world=PAR_WORLD, groups="2_rows_of_model2",
                new_tokens=PAR_NEW, gpt2_int8_tokens_equal=True,
                gpt2_w4_tokens_equal=True, tinyllama_int8_tokens_equal=True,
                tinyllama_layers=PAR_LLAMA_LAYERS,
                tinyllama_merges=by_row[0]["llama_merges"],
                engine_requests=PAR_REQS, engine_slots=PAR_SLOTS,
                engine_steps=by_row[1]["engine_steps"],
                engine_equals_generate_kv_alone=True,
                w4_wo_launches_per_rank=by_row[1]["counts"]["gpt_w4"][
                    "splitk_wo_matmul"],
                seconds=time.perf_counter() - t0, card=cardw)
            # (c) pipelines
            t0 = time.perf_counter()
            out = ranks.run(rank_pipe, paths["int8"])
            single = load_qmodel(paths["int8"])
            single.optimize()
            ref = single([x])[0]
            for r in out:
                if "gpipe" in r:
                    assert np.array_equal(r["gpipe"], ref), "gpipe"
                assert np.array_equal(r["pp_tp"], ref), "pp x tp"
            res["launches"]["gpipe_stage0"] = out[0]["gpipe_counts"]
            res["launches"]["gpipe_stage1"] = out[1]["gpipe_counts"]
            res["launches"]["pp_tp_rank0"] = out[0]["pp_tp_counts"]
            res["launches"]["pp_tp_rank2"] = out[2]["pp_tp_counts"]
            say("par-pipeline", gpipe_stages=2, microbatches=PAR_MICRO,
                cut=out[0]["cut"], pp_tp="pipe2xmodel2",
                gpipe_equal_bitwise=True, pp_tp_equal_bitwise=True,
                seconds=time.perf_counter() - t0, card=cardw)
            del single
        res["ranks_seconds"] = time.perf_counter() - t_ranks

        # (d) the kernels at the shard shapes, in this process
        t0 = time.perf_counter()
        res["kernels"] = par_kernels(name)
        say("par-kernels", seconds=time.perf_counter() - t0, card=cardw)

        # (e) a saved stacked model loads back byte for byte; a QDQ export
        # after the merge re-imports to the unmerged graph's logits
        t0 = time.perf_counter()
        q = fmodel.quantize(stats=stats, **dict(WEIGHT_CONFIGS["w4a8"],
                                                quantize_conv=True))
        layout = Mesh(np.arange(4).reshape(2, 2), ("data", "model"), "cuda")
        par.shard_model(q, layout, rules=par.vit_tp_rules)
        q.pack_weights()
        q.mesh = None
        path = os.path.join(tmp, "stacked.onnx")
        save_qmodel(q, path, proto)
        back = load_qmodel(path)
        mine = {v.name: v.data for v in q.values}
        stacked = 0
        for v in back.values:
            if getattr(v.data, "layout", None) == "splitk_stacked":
                src = mine[v.name]
                assert src.planes.cpu().numpy().tobytes() == \
                    v.data.planes.cpu().numpy().tobytes(), v.name
                stacked += 1
        assert stacked == 24, stacked
        assert np.array_equal(back([x[:B_F32]])[0], q([x[:B_F32]])[0])
        # the same passes but the merge on the other model
        unmerged = fmodel.quantize(stats=stats, bit_width=8,
                                   quantize_conv=True)
        unmerged._opt_merge_matmuls = False
        unmerged.optimize()
        merged = fmodel.quantize(stats=stats, bit_width=8,
                                 quantize_conv=True)
        merged._opt_merge_matmuls = True
        assert merged.optimize()["merge_parallel_matmuls"] == 12
        ua, ma = export_qdq(unmerged, proto), export_qdq(merged, proto)
        assert ua.SerializeToString() == ma.SerializeToString()
        a = Model.from_onnx(ua)([x[:B_F32]])[0]
        b = Model.from_onnx(ma)([x[:B_F32]])[0]
        assert np.array_equal(a, b), "merged export != unmerged export"
        say("par-serialization", stacked_payloads_equal_bytewise=stacked,
            qdq_after_merge_equals_unmerged_bitwise=True,
            seconds=time.perf_counter() - t0, card=cardw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    say("par-phase", seconds=res["seconds"], ranks_seconds=res["ranks_seconds"],
        backend="gloo", world=PAR_WORLD,
        note="one_card_time_slices_the_ranks:no_time_here_is_a_scaling_"
             "figure", card=cardw)
    return res


# -- phase 24: deployment artifacts ------------------------------------------

AOT_DIR = os.path.join(REPO, "build", "aot")
AOT_NEW = 16  # 24(b): GPT-2 small W4 decode, GPT_PROMPT + AOT_NEW tokens
AOT_TURNS = 2  # rounds of timed decodes, each (generate_kv, loaded x 2, generate_kv)
AOT_IPS_REPS = 20  # forwards per images/s run
# 24(b): TinyLlama-1.1B widths: layers, batch, cache, prompt, new tokens
AOT_LLAMA_LAYERS, AOT_LLAMA_B, AOT_LLAMA_LEN = 2, 8, 64
AOT_LLAMA_PROMPT, AOT_LLAMA_NEW = 16, 16
AOT_DEPTH = 2  # 24(c): layers of the W3A8 ViT-Base, GPT-2 and the prefill
AOT_SCORE_B = 2  # 24(c): GPT-2 scoring batch at GPT_SEQ
# a fresh process given only artifacts' paths and input .npy files: for each
# in turn, load, the first call (the capture), one counted call (its output
# saved), and images/s over AOT_IPS_REPS replays
AOT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from numpy_quant_tpu_torch import kernels as K
from numpy_quant_tpu_torch.utils import load_compiled
t_import = time.perf_counter() - t0
reps, jobs = int(sys.argv[1]), json.loads(sys.argv[2])
reports = []
for path, xpath, outpath in jobs:
    t0 = time.perf_counter()
    fn = load_compiled(path)
    t_load = time.perf_counter() - t0
    x = torch.from_numpy(np.load(xpath)).cuda()
    t0 = time.perf_counter()
    fn([x], as_numpy=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    K.set_launch_counts({k: 0 for k in K.launch_counts()})
    out = fn([x], as_numpy=False)[0]
    counts = {f.__name__: f.launches for f in K.COUNTED}
    np.save(outpath, out.cpu().numpy())
    for _ in range(3):
        fn([x], as_numpy=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn([x], as_numpy=False)
    torch.cuda.synchronize()
    ips = x.shape[0] * reps / (time.perf_counter() - t0)
    reports.append(dict(import_seconds=t_import, load_seconds=t_load,
                        first_call_seconds=t_first, counts=counts,
                        images_per_s=ips, graphs=len(fn.program.graphs),
                        replays=fn.program.replays))
    del fn, x, out
print(json.dumps(reports))
"""


def aot_child(jobs: list) -> list:
    """[(output, report)] of AOT_CHILD on each (artifact path, input) of
    ``jobs``, in one fresh process (the import is paid once: each report
    carries its seconds)."""
    import numpy as np
    args = []
    for path, x in jobs:
        stem = os.path.splitext(path)[0]
        np.save(stem + "_x.npy", x.cpu().numpy())
        args.append((path, stem + "_x.npy", stem + "_y.npy"))
    proc = subprocess.run(
        [sys.executable, "-c", AOT_CHILD, str(AOT_IPS_REPS),
         json.dumps(args)], capture_output=True, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"loading {[a[0] for a in args]} in a fresh "
                           f"process failed:\n{proc.stderr[-4000:]}")
    reports = json.loads(proc.stdout.strip().splitlines()[-1])
    return [(np.load(a[2]), r) for a, r in zip(args, reports)]


def aot_forward_phase(card: str, qmodel, x8, x) -> dict:
    """Phase 24(a): the main path's int8 ViT-Base (optimized, packed,
    ``"kernel"``) saved with save_compiled at f32 B=8 and bf16 B=96, both
    artifacts loaded in one fresh process: each one's logits equal the
    live captured forward's bit for bit, and one loaded forward launches
    what one live forward does. Returns the loaded forwards' launch
    counts."""
    import numpy as np
    from numpy_quant_tpu_torch import config
    from numpy_quant_tpu_torch.utils import save_compiled
    os.makedirs(AOT_DIR, exist_ok=True)
    cardw = card.replace(" ", "_")
    forms = (("f32_b8", x8, contextlib.nullcontext),
             ("bf16_b96", x, config.low_precision_floats))
    live = {}
    for label, inp, mode in forms:
        with packed_execution("kernel"), mode():
            out, lc = counted(lambda: qmodel([inp])[0])
            path = os.path.join(AOT_DIR, f"vit_int8_{label}.pt2")
            saved = save_compiled(qmodel, path, [inp])
            ips = [images_per_s(qmodel, inp, "kernel", AOT_IPS_REPS)]
        live[label] = out, lc, path, saved, ips
    loaded = aot_child([(live[label][2], inp) for label, inp, _ in forms])
    res = {}
    for (label, inp, mode), (got, child) in zip(forms, loaded):
        out, lc, path, saved, ips_live = live[label]
        with packed_execution("kernel"), mode():
            ips_live.append(images_per_s(qmodel, inp, "kernel",
                                         AOT_IPS_REPS))
        equal = bool(np.array_equal(got, out))
        gc = child["counts"]
        say("aot-forward", model="vit_base_int8", form=label,
            batch=inp.shape[0], packed_execution="kernel",
            loaded_equals_live_bitwise=equal,
            launches_loaded=",".join(f"{k}:{v}" for k, v in gc.items() if v),
            launches_equal_live=gc == lc,
            images_per_s_loaded=child["images_per_s"],
            images_per_s_live=",".join(f"{v:.1f}" for v in ips_live),
            export_seconds=saved["export_seconds"],
            save_seconds=saved["save_seconds"],
            import_seconds=child["import_seconds"],
            load_seconds=child["load_seconds"],
            first_call_seconds=child["first_call_seconds"],
            graphs=child["graphs"], artifact_mb=saved["bytes"] / 1e6,
            payload_mb=saved["payload_bytes"] / 1e6, card=cardw)
        assert equal, f"{label}: the loaded forward differs from the live one"
        assert gc == lc, (gc, lc)
        assert gc["fused_attention_hs"] == 12, gc
        assert gc["splitk_qmatmul"] == PACKED_PER_FORWARD, gc
        res[f"vit_int8_{label}"] = gc
    return res


def aot_loop(label: str, card: str, model, wte, wpe, prompt, new: int,
             turns: int = 0, **kw) -> dict:
    """One decode artifact: generate_kv, save_decode_loop, load_decode_loop;
    the loaded loop's tokens equal generate_kv's (each sampled run from a
    generator seeded alike); with ``turns``, ms per token of both over
    that many rounds of (generate_kv, loaded, loaded, generate_kv).
    Returns the loaded call's launch counts and the timings."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.utils import (generate_kv, load_decode_loop,
                                             save_decode_loop)
    path = os.path.join(AOT_DIR, f"{label}.pt2")
    seed = kw.pop("seed", None)

    def gen():
        return None if seed is None else \
            torch.Generator(device="cuda").manual_seed(seed)

    want, wc = counted(lambda: generate_kv(model, prompt, wte, wpe, new,
                                           generator=gen(), **kw))
    saved = save_decode_loop(model, path, wte, wpe, prompt, new, **kw)
    t0 = time.perf_counter()
    fn = load_decode_loop(path)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, gc = counted(lambda: fn(prompt, generator=gen()))
    t_first = time.perf_counter() - t0
    steps = prompt.shape[1] + new - 1
    runs = {"generate_kv": [], "loaded": []}
    for form in ("generate_kv", "loaded", "loaded", "generate_kv") * turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_kv(model, prompt, wte, wpe, new, generator=gen(),
                          **kw) if form == "generate_kv" \
            else fn(prompt, generator=gen())
        runs[form].append((time.perf_counter() - t0) / steps * 1e3)
        assert np.array_equal(out, want), form
    equal = bool(np.array_equal(got, want))
    res = dict(tokens_equal_generate_kv=equal,
               launches_equal_generate_kv=gc == wc,
               launches_loaded=",".join(f"{k}:{v}" for k, v in gc.items()
                                        if v),
               steps=steps, graphs=len(fn.program.graphs),
               replays_per_call=fn.program.replays / (1 + len(runs["loaded"])),
               export_seconds=saved["export_seconds"],
               save_seconds=saved["save_seconds"], load_seconds=t_load,
               first_call_seconds=t_first, artifact_mb=saved["bytes"] / 1e6,
               payload_mb=saved["payload_bytes"] / 1e6)
    for form, r in runs.items():
        if r:
            res[f"ms_per_token_{form}"] = statistics.median(r)
            res[f"ms_per_token_runs_{form}"] = ",".join(f"{v:.3f}" for v in r)
    say("aot-decode", path=label, batch=prompt.shape[0],
        prompt=prompt.shape[1], new_tokens=new, **res,
        card=card.replace(" ", "_"))
    assert equal, f"{label}: loaded tokens differ from generate_kv's"
    assert gc == wc, (label, gc, wc)
    return dict(res, counts=gc, ids=got)


def aot_decode_phase(card: str, gpt) -> dict:
    """Phase 24(b): decode loops saved with save_decode_loop and loaded:
    GPT-2 small W4 g=128 ``"kernel"`` (B=8, greedy, GPT_PROMPT + AOT_NEW;
    ms per token against generate_kv's captured step), TinyLlama-1.1B
    widths at AOT_LLAMA_LAYERS layers (int8, fused, int8 cache, RoPE), and
    the copy-task fixture greedy and sampled. Every loaded loop's tokens
    equal generate_kv's. Returns the launch counts by loop and the
    TinyLlama weights (24(c)'s prefill)."""
    import numpy as np
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models import text_fixture as TF
    from numpy_quant_tpu_torch.models.gpt import GPT2_SMALL
    from numpy_quant_tpu_torch.models.llama import (llama_decode_step,
                                                    random_llama_weights)
    from numpy_quant_tpu_torch.utils import (decode_calibration,
                                             merge_calibration_stats)
    os.makedirs(AOT_DIR, exist_ok=True)
    res = {}
    model, proto = gpt
    prompt = np.random.default_rng(24).integers(
        0, GPT2_SMALL["vocab_size"], size=(GPT_B, GPT_PROMPT)) \
        .astype(np.int32)
    with packed_execution("kernel"):
        r = aot_loop("gpt2_w4_loop", card, model, proto._wte, proto._wpe,
                     prompt, AOT_NEW, turns=AOT_TURNS)
    steps = r["steps"]
    # the functional caches: each step writes a new copy of every cache
    cache = GPT_B * GPT2_SMALL["n_head"] * GPT_MAX_LEN * 64 * 4
    say("aot-decode-copies", path="gpt2_w4_loop",
        caches=2 * GPT2_SMALL["n_layer"],
        bytes_copied_per_step=2 * GPT2_SMALL["n_layer"] * cache,
        cache_bytes=2 * GPT2_SMALL["n_layer"] * cache)
    assert r["counts"]["splitk_wo_matmul"] == WO_PER_STEP * steps, r
    res["gpt2_w4_loop"] = r["counts"]
    # TinyLlama widths, int8 step with int8 caches and RoPE
    t0 = time.perf_counter()
    cfg = dict(tinyllama(), num_hidden_layers=AOT_LLAMA_LAYERS)
    weights = random_llama_weights(cfg, seed=0)
    lproto = llama_decode_step(weights, cfg, batch_size=AOT_LLAMA_B,
                               max_len=AOT_LLAMA_LEN)
    wte, rope = lproto._wte, lproto._rope_tables
    fmodel = Model.from_onnx(lproto)
    del lproto
    lprompt = np.random.default_rng(241).integers(
        0, cfg["vocab_size"], size=(AOT_LLAMA_B, AOT_LLAMA_PROMPT)) \
        .astype(np.int32)
    stats = merge_calibration_stats(*[
        fmodel.calibration_stats(b)
        for b in decode_calibration(fmodel, lprompt, wte, None, rope=rope)])
    q = fmodel.quantize(bit_width=8, stats=stats)
    del fmodel
    assert q.optimize()["fuse_decode_attention"] == AOT_LLAMA_LAYERS
    say("aot-llama-setup", layers=AOT_LLAMA_LAYERS,
        seconds=time.perf_counter() - t0)
    r = aot_loop("tinyllama_int8_loop", card, q, wte, None, lprompt,
                 AOT_LLAMA_NEW, rope=rope, kv_cache_dtype="int8")
    res["tinyllama_int8_loop"] = r["counts"]
    del q
    # the copy-task fixture: greedy (full accuracy) and sampled
    fproto = TF.trained_gpt_decode_onnx(batch_size=4)
    fix = Model.from_onnx(fproto)
    fprompt, expected = TF.make_prompts(np.random.default_rng(9), 4)
    fprompt = fprompt.astype(np.int32)
    r = aot_loop("copy_greedy_loop", card, fix, fproto._wte, fproto._wpe,
                 fprompt, TF.COPY_LEN)
    acc = TF.copy_accuracy(r["ids"][:, TF.COPY_LEN + 1:], expected)
    say("aot-copy-accuracy", greedy=acc)
    assert acc == 1.0, acc
    aot_loop("copy_sampled_loop", card, fix, fproto._wte, fproto._wpe,
             fprompt, TF.COPY_LEN, temperature=0.8, top_k=5, seed=5)
    return {"counts": res, "llama_weights": weights}


def aot_ops_check(card: str) -> dict:
    """Phase 24(c) first half: torch.library.opcheck of each custom op on
    the card, at one shape per form, its arguments as its wrapper hands
    them over."""
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from numpy_quant_tpu_torch import kernels as K
    from numpy_quant_tpu_torch.kernels.pack import pack_bitplanes, pack_splitk

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.namespace == "nqt":
                self.calls.append((func, args, kwargs))
            return func(*args, **kwargs)

    g = torch.Generator(device="cuda").manual_seed(24)
    rng = np.random.default_rng(24)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    x = torch.randn(64, 128, device="cuda", generator=g)
    w4 = rng.integers(-8, 8, size=(256, 128))
    w3 = rng.integers(-4, 4, size=(256, 128))
    xa = torch.randn(70, 256, device="cuda", generator=g)
    qmm = dict(bit_width=8, x_scale=X_SCALE, x_zp=X_ZP, w_scale=W_SCALE)

    def col(w):
        return torch.from_numpy(w.sum(0, keepdims=True).astype(np.int32)) \
            .cuda()

    cases = {
        "quantize:int8": lambda: K.quantize(x, 8, EW_SCALE, EW_ZP,
                                            torch.int8),
        "quantize:bf16_channel": lambda: K.quantize(
            x.to(torch.bfloat16), 8, torch.full((1, 128), EW_SCALE,
                                                device="cuda"), None),
        "dequantize:int32_zp_row": lambda: K.dequantize(
            i8(64, 128).to(torch.int32), EW_SCALE,
            torch.zeros((1, 128), dtype=torch.int32, device="cuda")),
        "dequantize:int8_bf16": lambda: K.dequantize(i8(64, 128), EW_SCALE,
                                                     EW_ZP, torch.bfloat16),
        "fake_quantize:int8": lambda: K.fake_quantize(x, 8, EW_SCALE, EW_ZP),
        "fake_quantize:rows_bf16": lambda: K.fake_quantize(
            x.to(torch.bfloat16)[:, :100], 8, 1.0 / 255.0, -128),
        "fused_attention_hs:exact": lambda: K.fused_attention_hs(
            i8(2, N_TOK, 768), i8(2, N_TOK, 768), i8(2, N_TOK, 768),
            **attention_kw(HEADS, "exact", "none", None, QP)),
        "fused_attention_hs:shift_int8": lambda: K.fused_attention_hs(
            i8(2, N_TOK, 768), i8(2, N_TOK, 768), i8(2, N_TOK, 768),
            **attention_kw(HEADS, "fast_shift", "none", OUT_REQUANT, QP)),
        "fused_attention_hs_blockq:causal": lambda: K.fused_attention_hs_blockq(
            i8(1, GPT_SEQ, 256), i8(1, GPT_SEQ, 256), i8(1, GPT_SEQ, 256),
            **attention_kw(4, "exact", "full", OUT_REQUANT, QP)),
        "fused_attention:causal": lambda: K.fused_attention(
            i8(8, 130, 64), i8(8, 64, 130), i8(8, 130, 64),
            **dict(QP, causal_mask_val=MASK_VAL)),
        "fused_attention:tp": lambda: K.fused_attention(
            i8(8, 130, 64), i8(8, 64, 130), i8(8, 130, 64), num_heads=2,
            head_base=2, head_total=4, **QP),
        "splitk_qmatmul:w4": lambda: K.splitk_qmatmul(
            xa, torch.from_numpy(pack_splitk(w4, 4)).cuda(), col(w4), bits=4,
            **qmm),
        "splitk_qmatmul:w8_int8_x_requant": lambda: K.splitk_qmatmul(
            i8(70, 256), torch.from_numpy(w4.astype(np.int8)).cuda(),
            col(w4), bits=8, quantize_x=False, out_requant=(0.1, 2, 8),
            **qmm),
        "packed_qmatmul:w3": lambda: K.packed_qmatmul(
            xa, torch.from_numpy(pack_bitplanes(w3, 3)).cuda(), col(w3),
            bits=3, **qmm),
        "splitk_wo_matmul:grouped_f32": lambda: K.splitk_wo_matmul(
            torch.randn(8, 256, device="cuda"),
            torch.from_numpy(pack_splitk(w4, 4)).cuda(),
            np.full((2, 128), 0.01, np.float32), bits=4),
        "splitk_wo_matmul:channel_bf16": lambda: K.splitk_wo_matmul(
            torch.randn(8, 256, device="cuda", dtype=torch.bfloat16),
            torch.from_numpy(pack_splitk(w4, 4)).cuda(),
            np.full((1, 128), 0.01, np.float32), bits=4),
    }
    res = {}
    for case, run in cases.items():
        with Calls() as rec:
            run()
        assert len(rec.calls) == 1, (case, len(rec.calls))
        op, args, kwargs = rec.calls[0]
        out = torch.library.opcheck(op, args, kwargs)
        torch.cuda.synchronize()
        res[case] = all(v == "SUCCESS" for v in out.values())
    say("aot-opcheck", device="cuda", cases=len(res),
        passed=sum(res.values()), ops=len({c.split(":")[0] for c in res}),
        failed="|".join(c for c, ok in res.items() if not ok) or None,
        card=card.replace(" ", "_"))
    assert all(res.values()), res
    assert {c.split(":")[0] for c in res} == {f.__name__ for f in K.COUNTED}
    return res


def aot_forward(label: str, card: str, model, inputs: list) -> dict:
    """One forward artifact loaded in this process: its outputs equal the
    live captured forward's bit for bit, with the same launches. Returns
    the loaded forward's launch counts."""
    import numpy as np
    from numpy_quant_tpu_torch.utils import load_compiled, save_compiled
    live, lc = counted(lambda: model(inputs))
    path = os.path.join(AOT_DIR, f"{label}.pt2")
    saved = save_compiled(model, path, inputs)
    fn = load_compiled(path)
    got, gc = counted(lambda: fn(inputs))
    equal = all(np.array_equal(a, b) for a, b in zip(got, live))
    say("aot-forward", model=label, loaded_equals_live_bitwise=equal,
        launches_equal_live=gc == lc,
        launches_loaded=",".join(f"{k}:{v}" for k, v in gc.items() if v),
        export_seconds=saved["export_seconds"],
        save_seconds=saved["save_seconds"], artifact_mb=saved["bytes"] / 1e6,
        payload_mb=saved["payload_bytes"] / 1e6, card=card.replace(" ", "_"))
    assert equal, f"{label}: the loaded forward differs from the live one"
    assert gc == lc, (label, gc, lc)
    return gc


def aot_ops_phase(card: str, llama_weights) -> dict:
    """Phase 24(c): every custom op inside a loaded artifact (W3A8
    ViT-Base, int8 GPT-2 scoring at GPT_SEQ and the int8 TinyLlama-width
    prefill at PREFILL_N, each at AOT_DEPTH layers; splitk_wo_matmul in
    24(b)'s GPT-2 loop), and each op through opcheck on the card. Returns
    the launch counts by artifact."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.gpt import (GPT2_SMALL, gpt_causal_lm,
                                                  random_gpt2_weights)
    from numpy_quant_tpu_torch.models.llama import llama_prefill
    from numpy_quant_tpu_torch.models.vit import (VIT_BASE, WEIGHT_CONFIGS,
                                                  random_vit_weights,
                                                  vit_image_classifier)
    aot_ops_check(card)
    res = {}
    rng = np.random.default_rng(242)
    # W3A8 ViT-Base: packed_qmatmul
    cfg = dict(VIT_BASE, num_hidden_layers=AOT_DEPTH)
    vit = Model.from_onnx(vit_image_classifier(
        random_vit_weights(cfg, seed=0), cfg))
    x = rng.normal(size=(B_F32, 3, 224, 224)).astype(np.float32) * 0.5
    q = vit.quantize(stats=vit.calibration_stats([x[:2]]),
                     quantize_conv=True, **WEIGHT_CONFIGS["w3a8"])
    del vit
    q.optimize()
    assert q.pack_weights() == 6 * AOT_DEPTH
    with packed_execution("kernel"):
        res["vit_w3a8"] = aot_forward("vit_w3a8", card, q, [x])
    assert res["vit_w3a8"]["packed_qmatmul"] == 6 * AOT_DEPTH, res
    del q
    # GPT-2 scoring at the full context: fused_attention_hs_blockq
    cfg = dict(GPT2_SMALL, n_layer=AOT_DEPTH)
    proto = gpt_causal_lm(random_gpt2_weights(cfg, seed=0), cfg,
                          batch_size=AOT_SCORE_B, seq_len=GPT_SEQ)
    gpt = Model.from_onnx(proto)
    vocab = cfg["vocab_size"]
    calib = proto._wte[rng.integers(0, vocab, size=(2, GPT_SEQ))]
    embeds = torch.from_numpy(proto._wte[rng.integers(
        0, vocab, size=(AOT_SCORE_B, GPT_SEQ))]).cuda()
    q = gpt.quantize(bit_width=8, stats=gpt.calibration_stats([calib]))
    del gpt, proto
    q.optimize()
    res["gpt2_scoring"] = aot_forward("gpt2_scoring", card, q, [embeds])
    assert res["gpt2_scoring"]["fused_attention_hs_blockq"] == AOT_DEPTH
    del q
    # the TinyLlama-width int8 prefill: fused_attention
    lcfg = dict(tinyllama(), num_hidden_layers=AOT_DEPTH)
    proto = llama_prefill(llama_weights, lcfg, PREFILL_N)
    wte = proto._wte
    pm = Model.from_onnx(proto)
    del proto
    calib = wte[rng.integers(0, lcfg["vocab_size"], size=(2, PREFILL_N))]
    xp = torch.from_numpy(wte[rng.integers(0, lcfg["vocab_size"],
                                           size=(1, PREFILL_N))]).cuda()
    q = pm.quantize(bit_width=8, stats=pm.calibration_stats([calib]))
    del pm
    q.optimize()
    res["tinyllama_prefill"] = aot_forward("tinyllama_prefill", card, q, [xp])
    assert res["tinyllama_prefill"]["fused_attention"] == AOT_DEPTH, res
    return res


# -- phase 25: serve_ring and the fixture trainers ---------------------------

RING_STEPS = 20          # batches from a live generator per ring session
RING_DISTINCT = 4        # distinct seeded batches the generator cycles
TRAIN_GPT_STEPS = 200    # 25(c): steps of each GPT trainer
# 25(c): the last step's loss below step 0's by at least this factor,
# stated before the first run on the card
LOSS_DROP = {"copy": 1.8, "modsum": 1.05}
BASE_ACC_SLACK = 0.05    # 25(b): fresh held-out accuracy >= committed - this


class event_waits:
    """Counts the host's waits on CUDA events (torch.cuda.Event.synchronize)
    while in the block: the ring's reads of its output slots."""

    def __enter__(self):
        import torch
        self.n = 0
        self._orig = torch.cuda.Event.synchronize

        def counting(event):
            self.n += 1
            return self._orig(event)

        torch.cuda.Event.synchronize = counting
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.Event.synchronize = self._orig


def ring_phase(card: str, qmodel) -> dict:
    """25(a): the optimized, packed int8 ViT-Base under serve_ring at f32
    B=8 "unpack" and bf16 B=96 "kernel". Returns {label: launches per ring
    step} and the probe's seconds."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import config
    from numpy_quant_tpu_torch.serving import (map_batches, ring_supported,
                                               serve_stream)
    t0 = time.perf_counter()
    assert ring_supported(), "the ring probe failed on the card"
    probe_s = time.perf_counter() - t0
    rng = np.random.default_rng(25)
    image = tuple(qmodel.inputs[0].shape_hint[1:])
    out = {"probe_seconds": probe_s, "launches": {}}
    for label, batch, mode, low in (("f32_b8_unpack", B_F32, "unpack",
                                     False),
                                    ("bf16_b96_kernel", B_SERVE, "kernel",
                                     True)):
        xs = rng.standard_normal((RING_DISTINCT, batch) + image,
                                 dtype=np.float32) * 0.5
        pulled = []

        def live():
            for i in range(RING_STEPS):
                pulled.append(i)
                yield [xs[i % RING_DISTINCT]]

        floats = config.low_precision_floats() if low \
            else contextlib.nullcontext()
        with floats, packed_execution(mode):
            want = [qmodel([x])[0] for x in xs]
            _, one = counted(lambda: qmodel([xs[0]]))
            with event_waits() as ew:
                (got, where), counts = counted(lambda: host_syncs(
                    lambda: qmodel.serve_ring(live())))
            waits = ew.n
            pulls = list(pulled)
            equal = len(got) == RING_STEPS and all(
                np.array_equal(g[0], want[i % RING_DISTINCT])
                for i, g in enumerate(got))
            stacked = np.stack([xs[i % RING_DISTINCT]
                                for i in range(RING_STEPS)])
            runs = {
                "serve_ring": lambda: qmodel.serve_ring(live()),
                "map_batches": lambda: map_batches(qmodel, [stacked]),
                "serve_stream": lambda: list(serve_stream(
                    qmodel, ([xs[i % RING_DISTINCT]]
                             for i in range(RING_STEPS)), depth=2))}
            seconds = {k: [] for k in runs}
            for turn in ("serve_ring", "map_batches", "serve_stream",
                         "serve_stream", "map_batches", "serve_ring"):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                runs[turn]()
                torch.cuda.synchronize()
                seconds[turn].append(time.perf_counter() - t1)
            wall = statistics.median(seconds["serve_ring"]) * 1e3
            _, _, busy, tries = profiled(lambda: qmodel.serve_ring(live()))
        per_step = {k: v / RING_STEPS for k, v in counts.items()}
        images = RING_STEPS * batch
        say("ring", path=label, batch=batch, steps=RING_STEPS,
            ring_equals_call_bitwise=equal, pulls=len(pulls),
            **{f"{k}_per_step": v for k, v in per_step.items()},
            **{f"images_per_s_{k}": images / statistics.median(v)
               for k, v in seconds.items()},
            **{f"ms_runs_{k}": ",".join(f"{t * 1e3:.1f}" for t in v)
               for k, v in seconds.items()},
            host_syncs_per_step=sum(where.values()) / RING_STEPS,
            event_waits_per_step=waits / RING_STEPS,
            session_wall_ms=wall, session_busy_ms=busy,
            idle_share=None if busy is None else 1 - busy / wall,
            profile_tries=tries, probe_seconds=probe_s,
            card=card.replace(" ", "_"))
        for (path, line), n in where.most_common():
            say("ring-sync", path=label, per_step=n / RING_STEPS,
                at=f"{path}:{line}")
        assert equal, f"{label}: serve_ring outputs differ from __call__'s"
        assert pulls == list(range(RING_STEPS)), pulls
        assert per_step == {k: float(v) for k, v in one.items()}, \
            (per_step, one)
        assert per_step["fused_attention_hs"] == 12, per_step
        assert per_step["splitk_qmatmul"] == (
            PACKED_PER_FORWARD if mode == "kernel" else 0), per_step
        assert waits == RING_STEPS, waits
        out["launches"][label] = per_step
    return out


def train_base_phase(card: str, tmp: str) -> dict:
    """25(b): train_base_fixture at its defaults on the card, its held-out
    accuracy beside the committed fixture's, then the fresh weights served
    through the int8 main path. Returns the served forward's launches."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models import fixtures as F
    from numpy_quant_tpu_torch.models.vit import vit_image_classifier
    path = os.path.join(tmp, "vit_base_fresh.npz")
    history = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = F.train_base_fixture(path=path, history=history)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    committed = F.held_out_accuracy(F.trained_vit_base_weights(),
                                     F.BASE_FIXTURE_CONFIG, 0,
                                     F.BASE_IMAGE_SIZE, "cuda")
    eval_s = time.perf_counter() - t0
    steps = len(history)
    # the fresh weights through the main path: int8, optimize(),
    # pack_weights(), bf16 B=96 "kernel"
    fresh = F.load_weights(path)
    proto = vit_image_classifier(fresh, F.BASE_FIXTURE_CONFIG)
    fm = Model.from_onnx(proto)
    calib, _ = F.make_batch(np.random.default_rng(7), 32,
                            image_size=F.BASE_IMAGE_SIZE)
    q = fm.quantize(bit_width=8, stats=fm.calibration_stats([calib]),
                    quantize_conv=True)
    q.optimize()
    q.pack_weights()
    xh, yh = F.make_batch(np.random.default_rng(1), B_SERVE,
                          image_size=F.BASE_IMAGE_SIZE)
    ref = fm([xh])[0]
    with config.low_precision_floats(), packed_execution("kernel"):
        q([xh])
        logits, counts = counted(lambda: q([xh])[0])
    agree = float((logits.argmax(1) == ref.argmax(1)).mean())
    say("train-base", steps=steps, batch=32, s_per_step_call=call_s / steps,
        s_per_step_less_held_out=(call_s - eval_s) / steps,
        call_seconds=call_s, held_out_pass_seconds=eval_s,
        loss_first=history[0], loss_last=history[-1],
        held_out_fresh=acc, held_out_committed=committed,
        int8_bf16_kernel_label_agreement_float=agree,
        int8_held_out=float((logits.argmax(1) == yh).mean()),
        fused_attention_hs=counts["fused_attention_hs"],
        splitk_qmatmul=counts["splitk_qmatmul"],
        quantize=counts["quantize"], dequantize=counts["dequantize"],
        card=card.replace(" ", "_"))
    assert steps == 180 and np.isfinite(history).all()
    assert acc >= committed - BASE_ACC_SLACK, (acc, committed)
    assert counts["fused_attention_hs"] == 2, counts
    assert np.isfinite(logits).all()
    return counts


def train_gpt_phase(card: str) -> None:
    """25(c): the copy and modsum trainers at full width, TRAIN_GPT_STEPS
    steps each with dropout on: the loss falls by LOSS_DROP; s/step and the
    full runs reckoned from it."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.models import modsum_fixture, text_fixture
    for label, mod, full in (("copy", text_fixture, 3000),
                             ("modsum", modsum_fixture, 8000)):
        history = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = mod.train_fixture(steps=TRAIN_GPT_STEPS, history=history)
        torch.cuda.synchronize()
        per_step = (time.perf_counter() - t0) / TRAIN_GPT_STEPS
        drop = history[0] / history[-1]
        say("train-gpt", fixture=label, steps=TRAIN_GPT_STEPS,
            loss_first=history[0], loss_last=history[-1], drop=drop,
            drop_required=LOSS_DROP[label], held_out=acc,
            s_per_step_call=per_step, full_steps=full,
            full_run_seconds_reckoned=per_step * full,
            card=card.replace(" ", "_"))
        assert np.isfinite(history).all() and len(history) == TRAIN_GPT_STEPS
        assert drop >= LOSS_DROP[label], (label, drop)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # Keep CUPTI set up between the profiler's sessions. torch turns the
    # teardown off itself where its compiler captures CUDA graphs
    # (torch/profiler/profiler.py: CUDA graphs do not work well with a
    # CUPTI torn down and set up again); this script captures dozens, and
    # late in it the tracer has dropped records (profiled, replay_trace).
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    sys.path.insert(0, REPO)
    import numpy as np
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models.vit import (VIT_BASE, WEIGHT_CONFIGS,
                                                  random_vit_weights,
                                                  vit_image_classifier)
    t_start = time.perf_counter()

    def mark(upto: str) -> None:
        say("elapsed", upto=upto, seconds=time.perf_counter() - t_start)

    card = card_line()
    name = torch.cuda.get_device_name(0)
    say("card", nvidia_smi=card.replace(" ", "_"), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    say("build", seconds=build_kernels())

    check_int_matmul()
    worst = check_attention()
    timing = time_attention(name)
    qworst, qforms = check_qmatmul()
    qtiming = time_qmatmul(name)

    mark("phase_1")

    # -- phase 2: the main path in f32 --------------------------------
    t0 = time.perf_counter()
    weights = random_vit_weights(VIT_BASE, seed=0)
    vit_proto = vit_image_classifier(weights, VIT_BASE)
    model = Model.from_onnx(vit_proto)
    rng = np.random.default_rng(0)
    calib = rng.normal(size=(2, 3, 224, 224)).astype(np.float32) * 0.5
    stats = model.calibration_stats([calib])
    qmodel = model.quantize(bit_width=8, stats=stats, quantize_conv=True)
    say("setup", seconds=time.perf_counter() - t0,
        nodes=len(qmodel.nodes), device=qmodel.device)
    x8 = torch.from_numpy(rng.normal(size=(B_F32, 3, 224, 224))
                          .astype(np.float32) * 0.5).cuda()
    unfused = qmodel([x8])[0]
    report = qmodel.optimize()
    say("optimize", **{k: v for k, v in report.items()})
    assert report["fuse_attention"] == 12 and not report["fusion_failures"]
    packed = qmodel.pack_weights()
    say("pack_weights", mode="int8", packed=packed,
        packed_execution=config.packed_execution)
    assert packed == PACKED_PER_FORWARD, packed
    assert config.packed_execution == "unpack"
    fused, counts = counted(lambda: qmodel([x8])[0])
    counts_f32 = counts
    launches_f32 = counts["fused_attention_hs"]
    assert fused.shape == (B_F32, 1000) and np.isfinite(fused).all()
    # The exact kernel sums softmax rows in torch's order, so it equals its
    # plain version on every layer's operands (no flipped block, N=197 and
    # the narrowed last layer's one query row). The narrowed LayerNorm
    # before that layer reduces its rows in another torch order than the
    # full one, so the logits may still move: labels must agree wherever
    # the unfused top-1 margin exceeds LOGIT_TOL * max|logits|, and no
    # logit may move further than that.
    scale = float(np.abs(unfused).max())
    diff = float(np.abs(fused - unfused).max())
    top2 = np.sort(unfused, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    clear = margin > LOGIT_TOL * scale
    same = fused.argmax(1) == unfused.argmax(1)
    flips, blocks = attention_flips(qmodel, x8)
    say("f32", batch=B_F32, launches=launches_f32,
        packed_launches=counts["splitk_qmatmul"] + counts["packed_qmatmul"],
        labels_equal=f"{int(same.sum())}/{B_F32}",
        labels_equal_clear_margin=f"{int(same[clear].sum())}/{int(clear.sum())}",
        max_abs_diff=diff, max_abs_logit=scale,
        top1_margins=",".join(f"{m:.4f}" for m in margin),
        attention_flipped_blocks=f"{flips}/{blocks}",
        fused_equals_unfused_bitwise=bool(np.array_equal(fused, unfused)))
    assert launches_f32 == 12, launches_f32
    assert counts["splitk_qmatmul"] == counts["packed_qmatmul"] == 0, counts
    assert diff <= LOGIT_TOL * scale, (diff, scale)
    assert same[clear].all(), "fused and unfused labels differ"
    for nq in (N_TOK, 1):
        assert exact_in_order(B_F32 * HEADS * nq, N_TOK)
    assert flips == 0, (flips, blocks)

    mark("phase_2")

    # -- phase 3: bf16 serving mode at batch 96 (bench.py's form) -----
    x = torch.from_numpy(rng.normal(size=(B_SERVE, 3, 224, 224))
                         .astype(np.float32) * 0.5).cuda()
    ref32 = qmodel([x])[0]
    with config.low_precision_floats():
        logits, counts = counted(lambda: qmodel([x])[0])
        launches = counts["fused_attention_hs"]
        assert logits.shape == (B_SERVE, 1000) and np.isfinite(logits).all()
        assert launches == 12, launches
        # the boundary kernels against the plain chains, in turns, both
        # eager walks (a swap shows only there; phase 18 captures)
        ips_runs = {"kernel": [], "plain": []}
        for mode in ("kernel", "plain", "plain", "kernel"):
            with plain_chain() if mode == "plain" else eager():
                ips_runs[mode].append(images_per_s(qmodel, x, "unpack"))
        ips = statistics.median(ips_runs["kernel"])
        # the bf16 boundary forms at the path's shapes: the forward with
        # the plain chains swapped in gives the same logits bit for bit
        with plain_chain():
            plain_logits = qmodel([x])[0]
    bf16_equal = same_bits(logits, plain_logits)
    agree = float((logits.argmax(1) == ref32.argmax(1)).mean())
    say("bf16", batch=B_SERVE, launches=launches, label_agreement_f32=agree,
        kernel_equals_plain_chain_bitwise=bf16_equal,
        logits_compared=plain_logits.size,
        images_per_s=ips, ms_per_forward=B_SERVE / ips * 1e3,
        images_per_s_runs_kernel=",".join(f"{v:.1f}"
                                          for v in ips_runs["kernel"]),
        images_per_s_runs_plain_chain=",".join(f"{v:.1f}"
                                               for v in ips_runs["plain"]),
        quantize_launches=counts["quantize"],
        dequantize_launches=counts["dequantize"],
        card=card.replace(" ", "_"))
    assert bf16_equal, "bf16 B=96: kernel and plain-chain logits differ"
    say("bf16-profile", **bf16_profile(lambda: qmodel([x], as_numpy=False)[0]))

    mark("phase_3")

    # -- phase 4: the packed paths in f32 at batch 8 ------------------
    main_launches = {}
    qmodels = {"int8": qmodel}
    # the 8-bit-activation configurations, whose weights pack for the
    # int8 kernels
    for mode in (k for k, c in WEIGHT_CONFIGS.items() if c["bit_width"] <= 8):
        t0 = time.perf_counter()
        qm = qmodels.get(mode)
        if qm is None:
            qm = model.quantize(stats=stats, quantize_conv=True,
                                **WEIGHT_CONFIGS[mode])
            qm.optimize()
            packed = qm.pack_weights()
            say("pack_weights", mode=mode, packed=packed)
            assert packed == PACKED_PER_FORWARD, packed
            qmodels[mode] = qm
        kname = "packed_qmatmul" if mode == "w3a8" else "splitk_qmatmul"
        other = "splitk_qmatmul" if mode == "w3a8" else "packed_qmatmul"
        unpacked, cu = packed_forward(qm, x8, "unpack")
        kernel, ck = packed_forward(qm, x8, "kernel")
        assert kernel.shape == (B_F32, 1000) and np.isfinite(kernel).all()
        equal = bool(np.array_equal(kernel, unpacked))
        say("packed-f32", mode=mode, batch=B_F32, kernel=kname,
            launches=ck[kname], other_launches=ck[other],
            attention_launches=ck["fused_attention_hs"],
            unpack_mode_launches=cu[kname], kernel_equals_unpack=equal,
            max_abs_diff=float(np.abs(kernel - unpacked).max()),
            labels_equal_int8=f"{int((kernel.argmax(1) == fused.argmax(1)).sum())}/{B_F32}",
            seconds=time.perf_counter() - t0)
        assert ck[kname] == PACKED_PER_FORWARD and ck[other] == 0, ck
        assert ck["fused_attention_hs"] == 12 and cu[kname] == 0, (ck, cu)
        assert equal, f"{mode}: kernel and unpack logits differ"
        if mode == "w3a8":
            main_launches[kname] = ck[kname]

    mark("phase_4")

    # -- phase 5: the packed paths in bf16 serving at batch 96 ---------
    for mode in ("int8", "w4a8", "w3a8"):
        qm = qmodels[mode]
        kname = "packed_qmatmul" if mode == "w3a8" else "splitk_qmatmul"
        ref32 = qm([x])[0]
        with config.low_precision_floats():
            kernel, ck = packed_forward(qm, x, "kernel")
            unpacked, cu = packed_forward(qm, x, "unpack")
            ips_runs = {"kernel": [], "unpack": []}
            for run in ("kernel", "unpack", "unpack", "kernel"):
                ips_runs[run].append(images_per_s(qm, x, run))
        assert np.isfinite(kernel).all() and np.isfinite(unpacked).all()
        assert ck[kname] == PACKED_PER_FORWARD and cu[kname] == 0, (ck, cu)
        assert ck["fused_attention_hs"] == 12, ck
        equal = bool(np.array_equal(kernel, unpacked))
        ips = {m: statistics.median(v) for m, v in ips_runs.items()}
        if mode == "w4a8":
            main_launches[kname] = ck[kname]
        say("packed-bf16", mode=mode, batch=B_SERVE, kernel=kname,
            kernel_launches=ck[kname],
            attention_launches=ck["fused_attention_hs"],
            images_per_s_kernel=ips["kernel"],
            images_per_s_unpack=ips["unpack"],
            kernel_over_unpack=ips["kernel"] / ips["unpack"],
            images_per_s_runs_kernel=",".join(
                f"{v:.1f}" for v in ips_runs["kernel"]),
            images_per_s_runs_unpack=",".join(
                f"{v:.1f}" for v in ips_runs["unpack"]),
            label_agreement_f32_kernel=float(
                (kernel.argmax(1) == ref32.argmax(1)).mean()),
            kernel_equals_unpack=equal, card=card.replace(" ", "_"))
        assert equal, f"{mode} bf16 B=96: kernel and unpack logits differ"
        if mode != "int8":
            with packed_execution("kernel"):
                say("packed-bf16-profile", mode=mode, **bf16_profile(
                    lambda: qm([x], as_numpy=False)[0]))

    mark("phase_5")

    # -- phase 18 (a, b): the ViT-Base forwards captured ---------------
    for mode in ("unpack", "kernel"):
        with packed_execution(mode):
            captured_forward("vit_int8", card, qmodel, [x8], B_F32, "images",
                             dtype="f32", packed_execution=mode, batch=B_F32)
            with config.low_precision_floats():
                captured_forward("vit_int8", card, qmodel, [x], B_SERVE,
                                 "images", dtype="bf16",
                                 packed_execution=mode, batch=B_SERVE)
    with packed_execution("kernel"), config.low_precision_floats():
        for mode in ("w4a8", "w3a8"):
            captured_forward(f"vit_{mode}", card, qmodels[mode], [x],
                             B_SERVE, "images", dtype="bf16",
                             packed_execution="kernel", batch=B_SERVE)

    mark("phase_18ab")

    # -- phase 24(a): the main path's ViT-Base as a loaded artifact ------
    t24 = time.perf_counter()
    aot = aot_forward_phase(card, qmodel, x8, x)
    t24 = time.perf_counter() - t24

    mark("phase_24a")

    # -- phase 6: the weight-only kernel against its plain version -----
    wo_worst = check_wo()
    wo_timing = {t: rows["768x3072"] for t, rows in time_wo(name).items()}

    mark("phase_6")

    # -- phase 7: the weight-only GPT-2 decode path at full width ------
    wo_counts, gpt2_w4 = decode_phase(card)
    main_launches["splitk_wo_matmul"] = wo_counts["splitk_wo_matmul"]

    mark("phase_7")

    # -- phase 24(b, c): decode loops and every op through an artifact ---
    t0 = time.perf_counter()
    loops = aot_decode_phase(card, gpt2_w4)
    del gpt2_w4
    aot.update(loops["counts"])
    aot.update(aot_ops_phase(card, loops.pop("llama_weights")))
    t24 += time.perf_counter() - t0
    say("aot-phase", seconds=t24, card=card.replace(" ", "_"))

    mark("phase_24bc")

    # -- phase 8: the blockwise attention kernel ----------------------
    bq_worst = check_blockq()
    bq_timing = time_blockq(name)

    mark("phase_8")

    # -- phase 9: the int8 GPT-2 scoring path at full context ---------
    score_counts = scoring_phase(card)
    main_launches["fused_attention_hs_blockq"] = \
        score_counts["fused_attention_hs_blockq"]

    mark("phase_9")

    # -- phase 10: the pre-split attention kernel ---------------------
    plain_worst, plain_flips, plain_blocks = check_plain()
    say("kernel-check", kernel="fused_attention", scope="phase_10_total",
        flipped_blocks=f"{plain_flips}/{plain_blocks}",
        flipped_share=plain_flips / plain_blocks, max_abs_err_f32_out=plain_worst)
    assert plain_flips <= 0.001 * plain_blocks, (plain_flips, plain_blocks)
    plain_timing = time_plain(name)

    mark("phase_10")

    # -- phase 11: TinyLlama-1.1B int8 scoring at full context --------
    from numpy_quant_tpu_torch.models.llama import random_llama_weights
    t0 = time.perf_counter()
    llama_weights = random_llama_weights(tinyllama(), seed=0)
    say("llama-weights", seconds=time.perf_counter() - t0,
        bytes=sum(w.nbytes for w in llama_weights.values()))
    llama_counts = llama_phase(card, llama_weights)
    main_launches["fused_attention"] = llama_counts["fused_attention"]

    mark("phase_11")

    # -- phase 12: the score-bias forms of the head-split kernels -----
    sb_check = check_score_bias()
    sb_timing = time_score_bias(name)
    forms = forms_launched()

    mark("phase_12")

    # -- phase 13: T5-small int8 scoring ------------------------------
    t5_counts, t5_cost = t5_phase(card)

    mark("phase_13")

    # -- phase 14: quantize/dequantize at every boundary; 9-16 bits -----
    ew_check = check_elementwise()
    ew_timing = time_elementwise(name)
    dec_ew = ew_path_check(name)
    ew_launches = {"vit_int8_f32_b8": counts_f32, "gpt2_scoring": score_counts,
                   "tinyllama_scoring": llama_counts, "t5_scoring": t5_counts}
    routing_phase(qmodel, x8, ew_launches, t5_cost)
    mlp_sweep_phase()
    w8a16_phase(card, model, stats, x8, fused)

    mark("phase_14")

    # -- phase 16(a): ViT-Base under map_batches and serve_stream -------
    t16 = time.perf_counter()
    vit_serving = vit_serving_phase(card, qmodel)
    t16 = time.perf_counter() - t16

    mark("phase_16a")

    # -- phase 25: serve_ring on the main path; the fixture trainers -----
    t25 = time.perf_counter()
    ring = ring_phase(card, qmodel)
    mark("phase_25a")
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_base_phase(card, tmp)
    train_gpt_phase(card)
    say("ring-train-phase", seconds=time.perf_counter() - t25,
        card=card.replace(" ", "_"))

    mark("phase_25bc")

    # -- phase 17: ONNX interop (run here, on phase 3's models) -------
    t17 = time.perf_counter()
    vectors = conformance_phase(card)
    interop = interop_phase(card, vit_proto, model, stats, x8, x,
                            qmodels["int8"])
    say("interop-phase", seconds=time.perf_counter() - t17,
        card=card.replace(" ", "_"))

    mark("phase_17")

    # -- phase 15: TinyLlama-1.1B decode and prefill ------------------
    t15 = time.perf_counter()
    dec_wo = time_wo(name, LLAMA_WO_SHAPES, "tinyllama")
    dec_plain = plain_decode_shape(name)
    del model, qmodel, qmodels, vit_proto
    decode = llama_decode_phase(card, llama_weights)
    prefill_counts, prefill_model = int8_prefill_phase(card, llama_weights)
    say("llama-decode-phase", seconds=time.perf_counter() - t15)

    mark("phase_15")

    # -- phase 16(b-d): serving TinyLlama-1.1B ------------------------
    t0 = time.perf_counter()
    step, w4 = decode.pop("int8_fused"), decode.pop("w4")
    wte, rope = decode.pop("wte"), decode.pop("rope")
    engine = engine_phase(card, step, w4, wte, rope)
    admission = admission_phase(card, step, prefill_model, wte, rope)
    del step, w4, prefill_model
    gen_counts = generators_phase(card, llama_weights)
    say("serve-phase", seconds=t16 + time.perf_counter() - t0,
        vit_seconds=t16, engine_tokens_per_s=",".join(
            f"{k}:{v:.1f}" for k, v in engine["tokens_per_s"].items()),
        admission_tokens_per_s=admission["tokens_per_s"],
        engine_step_idle_share=engine["profile"]["idle_share"],
        card=card.replace(" ", "_"))

    mark("phase_16bcd")

    # -- phase 19: the PTQ accuracy passes ----------------------------
    ptq = ptq_phase(card, name, llama_weights)
    del llama_weights

    mark("phase_19")

    # -- phase 20: the CNN and GNN zoo ---------------------------------
    zoo = zoo_phase(card)

    mark("phase_20")

    # -- phase 21: encoder-decoder generation ---------------------------
    ed = encdec_phase(card)

    mark("phase_21")

    # -- phase 22: QAT and the rest of the model zoo ---------------------
    z = qat_zoo_phase(card)

    mark("phase_22")

    # -- phase 23: data, tensor and pipeline parallelism ----------------
    par = parallel_phase(card)
    say("done", seconds=time.perf_counter() - t_start)
    e1, e5 = engine["per_step"]["E1"], engine["per_step"]["E5"]
    admit = admission["per_admission"]

    def score_bias(kname: str) -> dict:
        return {"launches_per_t5_forward": t5_counts[kname],
                "variants_checked": sb_check["variants"] // 2,
                "max_abs_err": sb_check["worst"][kname],
                "t5_shapes": sb_timing[kname]}

    rows = [{
        "name": "fused_attention_hs", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/attention_hs.cu",
        "replaces": "numpy_quant_tpu/kernels/attention.py:530",
        "launches": launches, "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "score_bias": score_bias("fused_attention_hs"),
        "instantiations_launched": forms["fused_attention_hs"],
        "serving": {"per_vit_forward_map_batches":
                    vit_serving["fused_attention_hs"]}}]
    for kname, line in (("splitk_qmatmul", 246), ("packed_qmatmul", 533)):
        t = qtiming[kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "numpy_quant_tpu_torch/csrc/qmatmul.cu",
            "replaces": f"numpy_quant_tpu/kernels/qmatmul.py:{line}",
            "launches": main_launches[kname], "max_abs_err": qworst[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "launches_by_form_checked": qforms[kname],
            "serving": {"per_vit_forward_map_batches_kernel":
                        vit_serving[kname]},
            "shapes": {shape: dict(row, launches_per_forward=QMM_PER_FORWARD[
                shape]) for shape, row in t["shapes"].items()}})
    wo32, wo16 = wo_timing["f32"], wo_timing["bf16"]
    rows.append({
        "name": "splitk_wo_matmul", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/qmatmul_wo.cu",
        "replaces": "numpy_quant_tpu/kernels/qmatmul.py:411",
        "launches": main_launches["splitk_wo_matmul"],
        "max_abs_err": wo_worst, "ms": wo32["ms"],
        "plain_ms": wo32["plain_ms"], "bound_ms": wo32["bound_ms"],
        "bound_by": wo32["bound_by"], "library_ms": wo32["library_ms"],
        "bf16": {key: wo16[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
        "tinyllama_decode": {
            "launches_per_step": decode["counts"]["w4_kernel"][
                "splitk_wo_matmul"] / decode["steps"]["w4_kernel"],
            "shapes": dec_wo},
        "serving": {"per_w4_engine_step": e5["splitk_wo_matmul"],
                    "per_int8_engine_step": e1["splitk_wo_matmul"]}})
    rows.append({
        "name": "fused_attention_hs_blockq", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/attention_hs_blockq.cu",
        "replaces": "numpy_quant_tpu/kernels/attention.py:634",
        "launches": main_launches["fused_attention_hs_blockq"],
        "max_abs_err": bq_worst, "ms": bq_timing["ms"],
        "plain_ms": bq_timing["plain_ms"], "bound_ms": bq_timing["bound_ms"],
        "bound_by": bq_timing["bound_by"], "library_ms": None,
        "score_bias": score_bias("fused_attention_hs_blockq"),
        "instantiations_launched": forms["fused_attention_hs_blockq"],
        "serving": {"per_vit_forward_map_batches":
                    vit_serving["fused_attention_hs_blockq"],
                    "per_prefill_admission":
                    admit["fused_attention_hs_blockq"]}})
    rows.append({
        "name": "fused_attention", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/attention_plain.cu",
        "replaces": "numpy_quant_tpu/kernels/attention.py:724",
        "launches": main_launches["fused_attention"],
        "max_abs_err": plain_worst, "ms": plain_timing["ms"],
        "plain_ms": plain_timing["plain_ms"],
        "bound_ms": plain_timing["bound_ms"],
        "bound_by": plain_timing["bound_by"], "library_ms": None,
        "tinyllama_prefill": {
            "launches_per_prefill": prefill_counts["fused_attention"],
            "shape": f"BH32xN{PREFILL_N}xD64", "by_out": dec_plain},
        "serving": {"per_prefill_admission": admit["fused_attention"],
                    "per_generate_forward": gen_counts["fused_attention"],
                    "per_int8_engine_step": e1["fused_attention"]}})
    for kname, line in (("quantize", 39), ("dequantize", 64)):
        t = ew_timing[kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "numpy_quant_tpu_torch/csrc/elementwise.cu",
            "replaces": f"numpy_quant_tpu/kernels/elementwise.py:{line}",
            "launches": counts_f32[kname],
            "max_abs_err": ew_check["worst"][kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "different_function_ms": t["different_function_ms"],
            "variants_checked": ew_check["variants"][kname],
            "launches_per_forward": {p: c[kname]
                                     for p, c in ew_launches.items()},
            "shapes": t["shapes"],
            "tinyllama_decode": {
                "launches_per_step": {
                    mode: c[kname] / decode["steps"][mode]
                    for mode, c in decode["counts"].items()},
                "launches_per_int8_prefill": prefill_counts[kname],
                "shapes": dec_ew[kname]},
            "serving": {"per_vit_forward_map_batches_kernel":
                        vit_serving[kname],
                        "per_int8_engine_step": e1[kname],
                        "per_prefill_admission": admit[kname],
                        "per_generate_forward": gen_counts[kname]},
            "interop": {f"per_reimported_{k}_forward": c[kname]
                        for k, c in interop.items()}})
    # fake_quantize: the one-pass form of row 7, on the decode path
    # (DecodeAttention's q, key-cache and p_past fake quantization)
    fq = dec_ew["fake_quantize"]["cache_fake_quant_float32"]
    rows.append({
        "name": "fake_quantize", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/elementwise.cu",
        "replaces": "numpy_quant_tpu/ops/registry.py:775",
        "launches": decode["counts"]["int8_fused"]["fake_quantize"],
        "max_abs_err": ew_check["worst"]["fake_quantize"],
        "ms": fq["ms"], "plain_ms": fq["plain_ms"], "bound_ms": fq["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "two_launch_chain_ms": dec_ew["fake_quantize_chain"][
            "cache_fake_quant_float32"]["ms"],
        "variants_checked": ew_check["variants"]["fake_quantize"],
        "shapes": {k: v for k, v in dec_ew["fake_quantize"].items()},
        "tinyllama_decode": {"launches_per_step": {
            mode: c["fake_quantize"] / decode["steps"][mode]
            for mode, c in decode["counts"].items()}},
        "serving": {"per_int8_engine_step": e1["fake_quantize"]}})
    # phase 19's paths: launches per forward (zeros left out), and
    # splitk_wo_matmul at ViT-Base's rows
    for row in rows:
        kname = row["name"]
        paths = {"per_vit_base_gptq_forward": ptq["vit_base"][kname],
                 "per_smoothed_tinyllama_prefill": ptq["llama"][kname],
                 "per_equalized_t5_forward": ptq["t5"][kname],
                 "per_fixture_bf16_forward": {
                     r: c[kname] for r, c in ptq["fixture"].items()
                     if c[kname]}}
        row["ptq"] = {k: v for k, v in paths.items() if v}
        # phase 20: launches per forward of each zoo model (zeros left
        # out), by packed_execution mode
        row["zoo"] = {f"per_{model}_forward_{mode}": c[kname]
                      for model, by_mode in zoo.items()
                      for mode, c in by_mode.items() if c.get(kname)}
        if not row["zoo"]:
            del row["zoo"]
        # phase 21: launches per step or forward of each path (zeros left
        # out)
        paths = {k: v[kname] for k, v in ed_paths(ed).items()
                 if v.get(kname)}
        if paths:
            row["encdec"] = paths
        shapes = {label: forms for label, forms in ed["attention"].items()
                  if forms["exact"]["kernel"] == kname}
        if shapes:
            row["encdec_shapes"] = shapes
        # phase 22: launches per step or forward of each path (zeros left
        # out)
        paths = {k: v[kname] for k, v in z_paths(z).items()
                 if v.get(kname)}
        if paths:
            row["qat_zoo"] = paths
        # phase 23: launches per rank of each sharded path (zeros left
        # out), and the kernel at its shard shapes
        row["parallel"] = {
            f"per_rank_{k}": c[kname] for k, c in par["launches"].items()
            if c.get(kname)}
        shapes = {k.split(":", 1)[1]: v for k, v in par["kernels"].items()
                  if k.split(":", 1)[0] == kname}
        if shapes:
            row["parallel_shard_shapes"] = shapes
        # phase 24: launches per loaded forward or loaded decode loop
        # (zeros left out)
        row["aot"] = {f"per_loaded_{k}": c[kname] for k, c in aot.items()
                      if c.get(kname)}
        # phase 25: launches per ring step of each path, and per forward
        # of the freshly trained fixture through the int8 main path
        row["ring"] = {f"per_ring_step_{k}": c[kname]
                       for k, c in ring["launches"].items()}
        row["trained_base"] = {
            "per_int8_bf16_kernel_forward": trained[kname]}
    wo_row = next(r for r in rows if r["name"] == "splitk_wo_matmul")
    wo_row["ptq"]["vit_rows"] = {f"M{m}": t for m, t in ptq["wo"].items()}
    wo_row["mixtral_decode_shapes"] = z["times"]["wo"]
    next(r for r in rows if r["name"] == "fused_attention")[
        "mixtral_full_shape"] = z["times"]["attention"]
    say("interop-summary", vectors=",".join(
        f"{k}:{v:.3g}" for k, v in vectors.items()))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

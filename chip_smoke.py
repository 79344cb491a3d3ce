#!/usr/bin/env python3
"""Smoke test of the PyTorch port (diffusionkit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. the card: name and power limit, TF32 off;
  2. build the hand-written kernels from csrc/ (one nvcc per source, in
     parallel; sm_90a) and print each kernel's registers and spill bytes
     from ptxas's report, failing on a C7512 ("wgmma serialized") or on a
     spill in the d=512 and 3xTF32 flash kernels, the Hopper main loops of
     kernels E, C and #13, the M <= 16 GEMVs of C, #13, E and #11, the row
     kernels A', D and #4, #11's 64-deep Hopper loop, #10 or the GPTQ
     group step;
  3. each kernel against its plain torch version at the main paths' shapes,
     in bf16, against the plain math run in fp32 on the same bf16 inputs:
     mod_ln at the SD3 and FLUX shapes, flash attention at the SD3 shapes,
     flash attention at d=128
     and the int4 dequant-matmul at the FLUX shapes, kernel B also at
     ragged tile edges, at the VAE mid-block of a 1024² decode (16384
     positions, d=512) and, head by head, at FLUX 2048²'s 16640 tokens;
  4. each kernel's device time against its plain version's (CUDA graph
     replays timed with CUDA events; kernel B's plain version on one head at
     16640 tokens; the M <= 16 GEMVs of C, #13 and E, each its own entry of
     the kernels line, also with the weight cold in L2, over copies of it
     that pass 100 MB, the time held against their bound), the flash kernels' with their TFLOP/s and their ratio to
     F.scaled_dot_product_attention's time; kernel B and #15 also at the VAE
     mid-block of a 2048² decode (65536 positions), checked against their
     plain version 4096 query rows at a time (all its scores would take 17
     GB) and timed beside F.scaled_dot_product_attention;
  3-4b. the w4a8 kernels (mod_ln_quantize, quantize and w4a8_matmul in its
     four modes) against their plain versions run on the card on the same
     inputs, at the FLUX w4a8 shapes plus M=1, a ragged M and group 32
     (mod_ln_quantize also at FLUX 2048²'s image rows, SD3-medium's and
     SD3.5-large's hidden 2432; quantize also at FLUX 2048²'s rows, the
     inputs of SD3-medium w8a8's GEMVs and embedders, T5-XXL's, in fp32,
     at ragged M and on rows holding +-0, subnormals, 1e30, 3e38, +-inf and
     NaN), and their device times beside the plain versions' and kernel
     C's at the same (M, K, N) (mod_ln_quantize, quantize, and
     gelu_quantize in 3-4c, with the input cold in L2, over copies that
     pass 100 MB, beside warm), and mode plain above 16 rows (FLUX's text,
     image and unified rows at 1024² and 2048², and group 32): kernel E's
     Hopper loop held against its plain version, then the A/B of E against
     #10 then #11, the reference's materialised dataflow, warm and with the
     weights cold in L2, the routed call (w4a8_route) bit-identical to E
     and the route required to have taken the faster dataflow, cold and
     warm;
  3-4c. the kernels of the w8a8 and int8 modes against their plain versions
     on the card: gelu_quantize and w8_matmul at the SD3-medium w8a8 and
     T5-XXL w8a8 shapes (at M <= 16 #11's GEMV, its int8 entry and its
     quantizing entry, also at M = 1, 3 and 16), int8_matmul at the
     SD3-medium int8 shapes, kernel D on 10240- and 12288-wide rows, each
     with a ragged M; their device times beside the plain versions'
     (w8_matmul beside torch._int_mm's int32 product alone, its GEMV's two
     entries beside kernel D then #11, warm and with the weight cold in L2,
     int8_matmul beside kernel C's);
  3-4d. the (B, H, S, D) flash kernels: #15 flash_attention at the SD3,
     VAE and FLUX 1024² shapes, #14 flash_attention_stats at FLUX 2048²'s
     one-rank ring call and its four-rank chunk at three valid lengths, and
     at d=64 SD3 512²'s padded four-rank chunk (three valid lengths, none
     among them), SD3 1024²'s (two) and SD3 1024²'s one-rank ring call (path
     h), against their plain versions on fp32 upcasts (head by head where
     all heads' scores would not fit), and their device times beside
     F.scaled_dot_product_attention on the same q/k/v; then the four-rank
     ring's arithmetic on one card: each query slice against every key
     chunk through #14 in the ring's order, merged by merge_chunk_stats,
     against kernel B over the whole sequence (FLUX 2048², SD3 512² CFG and
     SD3 1024² CFG); and the fp32 instantiations of
     kernel B, #15 and #14 (B and #15 at the SD3, VAE and FLUX 1024² shapes,
     #14 at SD3's padded chunk and a FLUX 2048² four-rank chunk) against
     their fp32 plain versions within 2^-16 of the largest |output|, timed
     beside F.scaled_dot_product_attention on the same fp32 inputs (TF32
     off), each bound at the 3xTF32 rate (495 / 3 TFLOP/s) with the fp32
     FMA rate's bound beside it; kernel B's fp32 form also at the VAE
     encoder's mid-block of a 1024² img2img request (1, 16384, 1, 512),
     checked 4096 query rows at a time;
  3-4e. #10 dequant_w8 (bit-identical at FLUX fc1, fc2, q and q at group
     32; timed with the weights cold in L2 and warm), #10 then #11 against
     kernel E on the same layer (bit-identical at M = 4352 and a ragged M)
     and #16 int8_dot (bit-identical to the exact
     int32 product at the microbench's shape, M = 1 and a ragged M), timed
     beside their bounds (#16 beside torch._int_mm); then the two tool
     paths, bench-w4a8-mat and microbench-int8, through their ``run`` at
     the reference's default shape: every row timed, mat_pl and mat_xla
     equal to kernel and int8_dot to torch._int_mm bit for bit, each
     counter rising by exactly the launches one run makes;
  3-4f. SD3.5-large's kernels: C and #13 on fp32 x (csrc/dequant_f32.cu:
     3xTF32 wgmma above 16 rows, an FMA tile at M <= 16; block 35's
     linears, image and text rows and the
     `ada` shape) within one fp32 ulp + 2K 2^-24 (|x| @ |w|) of fp32 math,
     kernel E with block 35's fp32 bias (and fp32 output) in the GEMV, on
     #10 then #11, in gelu_quant and grouped_xs, bit-identical to its plain
     version (gelu_quant as in bf16), each timed beside its bound (fp32
     products at the 3xTF32 rate, the FMA rate's bound beside it); then
     every kernel of the SD3.5 paths at the 19 x 128 widths (hidden 2432,
     FFN 9728, `ada` 14592 / 4864, 38 heads of 64): A and A' (bf16 and
     fp32), D, #4, E by mode (mode plain above 16 rows also on E's own
     loop), #10, #11 (a ragged BN = 256 edge; M = 2 at K = 2432 on the
     mma.sync tile), C and #13 with their GEMVs, kernel B in bf16 and fp32
     at 4250 and 4685 tokens, the first of each timed;
  3-4g. the GPTQ group kernel (csrc/gptq.cu, the body of the reference's
     lax.scan, no Pallas call): inside a whole GPTQ of a random (6144,
     1536) and a (12288, 3072) weight, each with H from correlated random
     rows, every group step against its plain version on the same inputs,
     bit for bit (codes, scales, zeros, err); each GPTQ timed with the
     kernel (with the phase timer off and on) and with the plain version,
     the group loop's wall time a step beside its device spans; the group
     step at gs 32, 64 and 128 at SD3's q/k/v, those weights' and FLUX's
     q/k/v + fc1 widths timed beside its plain version (gs 32), its bytes
     bound and (gs 32, in the log) the one-thread-a-column design's times;
  3-4h. the two-pass D and #4 (a row split over tensor-parallel ranks) at
     the split paths' shapes, D at (256, 5120) and (4352, 1536), #4 at
     (2048, 3072): on whole rows and over two halves (their absmaxes
     combined by max), bit for bit the one-pass kernels, both forms timed;
  3-4i. C and #13 on bf16 x with an fp32 output (a row-parallel linear's
     partial product) at SD3-medium's o and fc2 split over two ranks ((M,
     768, 1536) and (M, 3072, 1536) at M = 2048 and 308, a ragged M, and the
     GEMV's M = 2): rounded to bf16, the bf16 form's output bit for bit;
     within one fp32 ulp + 2K 2^-24 (|x| @ |w|) of the plain fp32 product;
     timed beside the bf16 form and the plain version;
  every kernel's time is printed beside its bound (the larger of its
  operations over the card's peak for their type and its bytes over
  3.35 TB/s) and, for flash attention, beside F.scaled_dot_product_attention
  on the same inputs (a yardstick; the port never calls it);
  5. reduced-depth, full-width models in bf16 on the card (kernels on)
     against the same weights in fp32 on the CPU (plain path): SD3-medium
     in bf16, w8a8 and int8 (2 blocks each), FLUX.1-schnell int4 and w4a8
     (1 dual-stream + 2 single-stream blocks each), and T5-XXL in w8a8 after
     SmoothQuant (2 layers); SD3-medium in fp32 on the card (every joint
     attention on kernel B's fp32 instantiation) against fp32 on the CPU;
     and SD3.5-large at full width, 3 blocks with block 1 upcast to fp32
     (its calls on the fp32 entries, counted apart), in bf16, int4, w4a8,
     int8 (a float model quantized whole at group 32), w8a8 (random w8a8
     block linears) and w4a8-mixed (a float model on the ALS grid with
     MIXED_OVERRIDES, then the wscale) against fp32 on the CPU, every
     counter at the forward's count; then the generic Autoencoder: a full-width one
     written as an HF diffusers mirror (config.json and weights, by
     model_io.save_safetensors) under DIFFUSIONKIT_TPU_CKPT_DIR, read back by
     model_io.load_autoencoder bit for bit, a 256² image encoded and
     decoded on the card against fp32 on the CPU; then loading: an F16
     file of every 16-bit pattern read by the loader into a bf16 module on
     the card, bit for bit the CPU's cast, and the 4-bit releases' packed
     final layer ((4096, 3072) and (8192, 2432) -> 64, group 64, int4 and
     w4a8) through ops/common.linear on the dequantise path, with no
     kernel launched, against fp32 math; then the T5 outlier A/B
     (tools/t5_outlier_ab.run): T5-XXL at full width, random weights at HF
     T5's scales, 16 residual channels made 50x hotter, w8a8 with and
     without the SmoothQuant fold against bf16, the fold's margin on the
     non-outlier channels at least 3 dB (the JAX package's
     tests/test_smoothquant.py gate);
  6. the main paths, with random weights from a seed, each serving two
     requests through generate_image and repeating the first through the
     phase methods, all under the default use_scan=True, the denoise loop a
     CUDA graph of one step replayed once a step (the repeat must give the
     identical image, the two requests different ones, and every kernel's
     launch counter must rise by the path's launch count, a replay counting
     the capture's launches; each request's decoding time is printed beside
     its steps); then request 0's denoise again through the synced loop
     (use_scan=False), whose latents must be the graph's bit for bit with
     the same launches (on a difference one step of each is profiled and
     the kernels that differ named), its median ms/step logged beside the
     graph's (total / n); on a's and c's models also the batch phase:
     request 0 through generate_image(num_images=4) and the two requests
     through generate_images_batched, each against the same batch split
     into chunks of one image (DIFFUSIONKIT_TPU_DENOISE_BATCH=1): image 0's
     noise and a chunk of one bit for bit the single run's, each image's
     latents within 3e-2 relative L2 of its single run, the images
     distinct:
     a. SD3-medium (24 blocks, hidden 1536), CLIP-L/G and the VAE decoder in
        bf16: 512², 50 Euler steps, CFG 5.0;
     h. a's models at SD3-medium's native 1024² (4096 image + 154 text
        tokens) behind DiffusionPipeline(sdpa_impl="ring", mesh=local_mesh()),
        one NCCL rank: every joint attention one #14 call at d=64 (2, 24,
        4250, 4250, 64), kernel B only in the VAE mid-block (16384
        positions); then request 0 through the default dispatch, on kernel
        B only, its latents within 3e-2 relative L2 of the ring's (h');
     b. FLUX.1-schnell int4 (19 + 38 blocks, hidden 3072, int4 block linears
        at group 64), T5-XXL, CLIP-L and the VAE decoder in bf16: 1024²,
        4 Euler steps, no CFG;
     c. FLUX.1-schnell w4a8, the FLUX serving configuration: a freshly drawn
        packed model given to FluxPipeline(quantize_mmdit="w4a8"), which adds
        the per-channel wscale; b's T5-XXL, CLIP-L, VAE and tokenizers;
        kernel C must not run;
     d. SD3-medium w8a8: a float bf16 SD3-medium drawn on the card and given
        to DiffusionPipeline(quantize_mmdit="w8a8"), which converts it on
        the card; a's encoders, decoder and settings; kernels C, E and
        int8_matmul must not run;
     e. SD3-medium int8 weight-only: the same with quantize_mmdit="int8";
        w8_matmul, C and E must not run;
     f. the FLUX serving configuration of bench.py's flux-e2e: c's packed
        w4a8 MMDiT with FluxPipeline(quantize_mmdit="w4a8",
        quantize_t5=True), which smooths b's bf16 T5-XXL and converts it to
        w8a8 on the card; c's settings; first a float FLUX.1-schnell MMDiT
        at FLUX_GPTQ_DEPTH (full width; GPTQ at full size runs in path t)
        through the same setter, converted by GPTQ (the reference's
        default), timed by phase;
     a'. after a, one request of a's first prompt and seed under
        DIFFUSIONKIT_TPU_ATTN_LAYOUT=bhsd: every attention on #15, none on
        kernel B, its image within 3e-2 relative L2 of a's;
     a''. a's first request's latents decoded by DiffusionPipeline(
        a16=False) with the decoder's weights in fp32: the mid-block
        attention on kernel B's fp32 instantiation (one launch), the image's
        shape, and the fp32 output against the same latents decoded in fp32
        on the CPU;
     g. FLUX.1-schnell w4a8 at 2048² (16384 image + 256 text tokens), c's
        models behind FluxPipeline(quantize_mmdit="w4a8", sdpa_impl="ring",
        mesh=local_mesh()), one NCCL rank: every joint attention on #14
        through the ring, kernel B only in the VAE mid-block (65536
        positions); then request 0 through the default dispatch, on kernel
        B only, its latents within 3e-2 relative L2 of the ring's;
     i. SD3.5-large w4a8 (38 blocks, hidden 2432, block 35 fp32), bench.py's
        bench_sd35_w4a8: a random packed model (group 64) given to
        DiffusionPipeline(model_version=...-3.5-large, use_t5=False,
        quantize_mmdit="w4a8"), which adds the wscale; 1024², 8 steps, CFG
        5.0; f's CLIP-L and VAE, a CLIP-G drawn anew;
     i'. the 4-bit release (...-3.5-large-4bit-quantized): the same settings
        on a packed int4 model, weight-only (kernel C; block 35 on C's fp32
        tile); one request (and its repeat), for the smoke's time;
     k. SD3.5-large bf16 with use_t5=True: T5-XXL at 512 tokens (4685 joint
        tokens), block 35 in fp32 (kernel A and B's fp32 kernels); one
        request (and its repeat);
     t. SD3.5-large w4a8-mixed by GPTQ at 8B: a float bf16 SD3.5-large
        (block 35 fp32) drawn on the card and given to DiffusionPipeline(
        model_version=...-3.5-large, use_t5=False, quantize_mmdit=
        "w4a8-mixed"): the quantizer "gptq" (no fallback), its seconds by
        phase and the peak printed; every block linear w4a8 but the `ada`,
        int8 on #13's GEMV; the embedders and the final layer float; i's
        settings; k's CLIP-L/G, VAE and tokenizers (k's T5 carried along,
        unused, for j);
     u. the same float model drawn again with quantize_mmdit="int8": #13 on
        every block linear, block 35's 12 others on its fp32 tile
        (dequant_mm_3xtf32<8>); C, E and #11 do not run; one request (and
        its repeat), for the smoke's time;
     v. again with quantize_mmdit="w8a8", one request: #11 everywhere,
        block 35 on its fp32 entries; D, A' and #4 run, C, E and #13 do not;
     j. FLUX.1-dev bf16 (its guidance embedder, guidance 3.5) through
        FluxPipeline(model_version=...FLUX.1-dev), T5 at 512 tokens (4608
        joint tokens), 1024², 4 steps; k's T5, CLIP-L and VAE;
     w. FLUX.1-dev w4a8 by GPTQ from its float model: a float bf16
        FLUX.1-dev at full width and FLUX_GPTQ_DEPTH blocks, first served
        through j's pipeline as it is (its bf16 twin), then written as
        FLUX.1-dev's file (the MLX namespace) and loaded by FluxPipeline(
        model_version=...FLUX.1-dev, quantize_mmdit="w4a8") with
        check_and_load_models(): request 0 converts it by the pipelines'
        default GPTQ (the guidance embedder's calibration site at 3.5;
        seconds by phase) and writes the quantized-tree cache, request 1
        (the MMDiT dropped) reads the cache, the packed state bit for bit;
        every block linear and the guidance embedder w4a8; then served at
        j's settings as every path is (E's three fused modes, E's GEMV on
        every `ada`, D, #10 then #11 at the config's counts), its images
        those of the conversion's requests bit for bit, each image's PSNR
        against the twin's printed, and GPTQ's block-linear error at most
        1.1x ALS's (as p's);
     l. img2img on a's models: a's request-1 image (a 530 x 520 copy, so
        read_image's LANCZOS resize runs) through DiffusionPipeline(
        local_ckpt=...) at 512², 50 steps at denoise 0.6 (the last 30 run),
        CFG 5.0; the fp32 VAE encoder loaded at the first request by
        model_io.load_vae_encoder from a full-width file the smoke writes in
        SD3's namespace (first_stage_model.encoder.*, F16); its mid-block on
        kernel B's fp32 form (4096 positions) once an encode; the encode
        against fp32 on the CPU; the graph against the synced loop; the
        img2img latents after a txt2img request on the same pipeline (a
        longer cached schedule) the first request's bit for bit;
     m. the same on c's models (FLUX.1-schnell w4a8) from c's request-0
        image at 1024², 4 steps at denoise 0.5 (2 run), the encoder from a
        FLUX ae.safetensors (encoder.*, BF16), kernel B's fp32 form at
        16384 positions; no CPU encode (4 TFLOP on the host);
     n. a's two requests through DiffusionPipeline(use_t5=False,
        load=True, low_memory_mode=True) from a's models written (BF16) as
        SD3-medium's files under a temporary DIFFUSIONKIT_TPU_CKPT_DIR
        (sd3_medium.safetensors: the MMDiT in the sgm namespace and the
        decoder under first_stage_model.; the HF CLIP-L/G directories; the
        tokenizers' vocab.json and a merges.txt of the header line): the
        text encoders loaded at construction (a's bit for bit), every other
        model before its phase and each dropped after it, the graph
        captured anew each request; the images a's bit for bit, each
        request's launches a's per-request count, the peak above the
        starting allocation below a's peak; load and capture times printed;
     p. SD3-medium int4 by GPTQ from n's files: DiffusionPipeline(load=True,
        low_memory_mode=True, quantize_mmdit="int4", local_ckpt=...) with
        the quantized-model cache in a scratch directory, a's request 0
        twice: request 0 loads the float file, runs GPTQ on the card and
        writes the cache, request 1 reads the cache; the quantizers
        "gptq" then "cached", request 1's packed state dict and latents
        request 0's bit for bit, every block linear a QuantizedLinear with
        f16-representable scales, the group kernel launched in request 0
        only; GPTQ's seconds by phase, the load, the cache write and read,
        ms a step under the graph and the peak printed; then the quality
        check: from a's float MMDiT the GPTQ (the cache's), ALS and min/max
        int4 models, one forward each on calib_batch(seed=99) with fp32
        activations and in bf16, each error against the float output
        printed; then each model's block linears (q, k, v, o, fc1, fc2)
        alone in the float model, GPTQ's error at most 1.1x ALS's;
     6t (the mode table). tools/quant_quality.run on n's files, bf16 and
        each quantize mode (int8, int4, w8a8, w4a8, int4-mixed, w4a8-mixed)
        at the JAX gate's config (256², 6 steps, CFG 5.0, seed 42), the
        pipelines' default quantizers (GPTQ for the 4-bit modes), then the
        4-bit modes again on the ALS grid (DIFFUSIONKIT_TPU_GPTQ=0), no
        quantized-model cache: each mode's launches one request's count,
        its PSNR against bf16, quantizer and conversion seconds printed,
        int8 at least 38 dB and w8a8 31 (tests/test_quant_quality.py's
        floors); then n's MMDiT file loaded onto the card from a cold page
        cache (the smoke's own file, fsync then POSIX_FADV_DONTNEED) with
        native.prefetch off, as it is and eager, and once warm, the seconds
        printed (o's MLX file the same after o);
     q. f's pipeline served over HTTP: GenerationServer(max_batch=8)
        (diffusionkit_tpu_torch.serve) on a ThreadingHTTPServer at
        127.0.0.1 in this process, at f's settings: /healthz 200 with
        backend "cuda" and the card's name; /warmup to batch 8 (buckets 1,
        2, 4, 8; the graphs it captured, their seconds and the memory
        after printed), /healthz and /metrics polled meanwhile, every
        answer 200; then SERVE_RUNS rounds each of 1, 4 and 8 concurrent
        clients (bench_serving's prompts, round r's seeds shifted by r, as
        the tool's timed runs shift them): each reply
        a PNG equal bit for bit to the uint8 image the pipeline decoded
        for that job (read at _decode_batched_u8), a round's images
        distinct, each first round's latents within 3e-2 relative L2 of
        the request's single run, no graph captured after /warmup; one
        num_images=2 request on the JSON path, two distinct images;
        /metrics served = the requests sent, no error, timeout or
        rejection (batches, occupancy, latency p50 and p95 printed); the
        kernels launched those of f's requests, every one of them;
        images/min at batches 1, 4 and 8 through HTTP (first send to last
        reply) beside bench_serving.run on the same pipeline; drain()
        drains and a request after it gets 503. In path n, the CLI (python
        -m diffusionkit_tpu_torch.scripts.generate_images) in a subprocess
        on a's request 0 from n's files, with its default flags (low
        memory) and with --benchmark-mode: each PNG a's image bit for bit,
        each wall time printed;
     r1. f's request 0 through a copy of f's pipeline under
        FluxPipeline's mesh=local_mesh() (one NCCL rank): captured, its
        latents f's bit for bit with f's launches;
     r. f's models over create_mesh(1, 2, backend="gloo"): f's MMDiT and
        T5 written once in the quantized-model cache format (CLIP-L, the
        decoder and the tokenizers pickled), then this script started twice
        as `--tp-rank i DIR`, two processes on the one card, each reading
        the files to the host and keeping its shard on the card; f's
        request 0 uncaptured: both ranks' latents and images bit for bit,
        the latents within 3e-2 relative L2 of f's, the T5 output f's bit
        for bit, each
        rank's peak memory below f's, every kernel of the split path
        launched (int8_dot and the two-pass D once for each row-parallel
        linear: 76 a step and the T5's 48), C none; the ms a step, the load
        and the collectives a step (calls, elements, host seconds) printed;
        then in the same ranks SD3-medium w8a8 (24 blocks, random w8a8
        weights) one CFG forward at 512² split over the same mesh, within
        3e-2 of the whole model, and bit for bit with the split float
        linears (the t / y embedders, the final layer's ada) kept whole; its
        block-0 o and fc2 split bit for bit the whole ones (the two-pass
        #4's path); then SD3-medium int4 and int8 (random packed block
        linears) the same way, each within 3e-2 of the whole model, its 94
        split o and fc2 on C / #13's fp32 output, printed beside the same
        split forward with those partials rounded to bf16 before the sum;
     x. after i: i's request 0 at SD35_TP.steps steps (of i's 8) over
        create_mesh(1, 2, backend="gloo"): i's MMDiT written in the cache
        format, this script started twice as `--sd35-rank 2 i DIR`, each
        rank reading it to the host and keeping its shard: both ranks'
        latents bit for bit, within 3e-2 relative L2 of i's unsharded run
        at those steps; every route off_kernel(SD3.5-large w4a8, 2) lists
        (q, k, v col and o row off E's shapes, fc1 on E with the FFN off
        E's fused modes) seen taken, and the kernels they reach launched
        (#10 then #11, the two-pass D, #16), the fused modes and #4 never;
     x4. one CFG forward at 512² of SD3.5-large int4 (X4_DEPTH blocks,
        full width, block X4_UPCAST fp32; 38 heads over 4 ranks take the
        materialised-score attention, too large at 1024² for four ranks
        on one card) over create_mesh(1, 4): four
        ranks (`--sd35-rank 4 i DIR`), each drawing the model from one seed
        and holding its split forward within 3e-2 of the unsharded one;
        every route off_kernel(SD3.5-large int4, 4) lists (heads gathered,
        `ada` off C's shapes, o gathered onto C) seen taken;
     s. f's models whole on each rank over create_mesh(2, 1): num_images=2
        and generate_images_batched of f's two prompts, an image a rank,
        both ranks returning both images, latents and pixels bit for bit f's
        pipeline with DIFFUSIONKIT_TPU_DENOISE_BATCH=1;
     o. b's two requests through FluxPipeline(model_version=
        ...-schnell-4bit-quantized, load=False, low_memory_mode=False) with
        SyntheticT5Tokenizer(256) assigned, then check_and_load_models(),
        from b's models written as the 4-bit release's files (the MMDiT in
        the MLX namespace: words transposed back, q/k columns in the
        interleaved RoPE order, scales and biases F32; ae.safetensors;
        T5-XXL's and CLIP-L's HF files): every loaded model b's bit for bit,
        the images b's, the launches b's;
     (run in the order a, a', a'', l, n (and the CLI), p, the mode table,
     h, h', d, e, b, o, c, m, g, g', f, q, r1, r, s, i, x, x4, i', k, t, u,
     v, j, w, so h, d and e share a's encoders, h a's MMDiT, g c's models
     and f g's, before f converts the T5; each later path frees the
     previous MMDiT);
  7. two denoise steps of each path (the graph's replays; the synced
     loop's if the profiler sees no kernel inside a replay) under
     torch.profiler: device-busy time per step by kernel family and by
     tools/profile_step's categories (attention, each quantized GEMM
     family, cuBLAS GEMMs, row kernels, elementwise, copies), and the
     device's idle share against the graph's ms/step and the loop's; for
     FLUX also the text encoding (T5-XXL and CLIP-L); and a summary line of
     each path's graph and loop ms/step, busy time and idle shares.

A phase's first line carries the seconds since the script started, and the
whole smoke's seconds are printed before the kernels' summary.

The last line is {"ok": true, "device": {...}}; the line before it the
kernels' summary as JSON, and before that the card's name and power limit.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.nn.functional as F

from diffusionkit_tpu_torch.config import (
    CLIP_G,
    CLIP_L,
    FLUX_DEV,
    FLUX_DEV_VERSION,
    FLUX_SCHNELL,
    FLUX_SCHNELL_4BIT,
    FLUX_SCHNELL_VERSION,
    SD35_LARGE,
    SD35_LARGE_4BIT,
    SD3_2b,
    SD3_MEDIUM,
    SD3_8b,
    T5_XXL,
    AutoencoderConfig,
    VAEDecoderConfig,
    VAEEncoderConfig,
)
from diffusionkit_tpu_torch import model_io, native
from diffusionkit_tpu_torch.flops import device_peak_flops, mmdit_step_flops
from diffusionkit_tpu_torch.graphs import StepGraph
from diffusionkit_tpu_torch.models import (
    Autoencoder,
    VAEEncoder,
    init_autoencoder,
    init_clip,
    init_mmdit,
    init_t5,
    init_vae_decoder,
    init_vae_encoder,
)
from diffusionkit_tpu_torch.models.mmdit import MMDiT
from diffusionkit_tpu_torch.models.t5 import T5Encoder
from diffusionkit_tpu_torch.ops import common as common_ops
from diffusionkit_tpu_torch.ops import gptq as gptq_ops
from diffusionkit_tpu_torch.ops.attention import FLASH_ATTN_THRESHOLD
from diffusionkit_tpu_torch.ops import kernels
from diffusionkit_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bshd,
    flash_attention_bshd_plain,
    flash_attention_plain,
    flash_attention_stats,
    flash_attention_stats_plain,
)
from diffusionkit_tpu_torch.ops.common import linear
from diffusionkit_tpu_torch.ops.gptq import gptq_group, gptq_group_plain
from diffusionkit_tpu_torch.ops.fused_quant import (
    gelu_quantize,
    gelu_quantize_plain,
    mod_ln,
    mod_ln_plain,
    mod_ln_quantize,
    mod_ln_quantize_plain,
    quantize,
    quantize_amax,
    quantize_amax_plain,
    quantize_plain,
    quantize_two_pass,
    row_absmax,
    row_absmax_plain,
    straddled_tiles,
    tile_absmax,
    tile_absmax_plain,
    tile_quantize,
    tile_quantize_plain,
)
from diffusionkit_tpu_torch.ops.int4_matmul import (
    dequantize_int4,
    dequantize_int8,
    int4_matmul,
    int4_matmul_plain,
    int8_matmul,
    int8_matmul_plain,
)
from diffusionkit_tpu_torch.ops.quantized import (
    MIXED_OVERRIDES,
    QuantizedLinear,
    add_wscale_,
    quantize_module_,
    wscale_from_q4,
)
from diffusionkit_tpu_torch.ops.smoothquant import smooth_t5
from diffusionkit_tpu_torch.ops.w4a8_matmul import (
    MODES,
    dequant_w8,
    dequant_w8_plain,
    int8_dot,
    int8_dot_plain,
    quantize_w8_matmul,
    quantize_w8_matmul_plain,
    scaled_affine,
    w4a8_matmul,
    w4a8_matmul_plain,
    w4a8_route,
    w8_matmul,
    w8_matmul_plain,
)
from diffusionkit_tpu_torch.ops.w8a8 import W8A8Linear, w8a8_module_
from diffusionkit_tpu_torch.parallel import (
    collectives,
    create_mesh,
    init_distributed,
    local_mesh,
    merge_chunk_stats,
    shard_module_,
)
from diffusionkit_tpu_torch.parallel.sharding import off_kernel
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline, _encode_step
from diffusionkit_tpu_torch.serve import GenerationServer
from diffusionkit_tpu_torch.tokenizer import (
    CLIPTokenizer,
    SyntheticT5Tokenizer,
    synthetic_clip_vocab,
)
from diffusionkit_tpu_torch.utils import image_psnr
from diffusionkit_tpu_torch.tools import (
    DEFAULT_ITERS,
    DEFAULT_SHAPE,
    bench_gemv,
    bench_mat,
    bench_rows,
    bench_serving,
    bench_w4a8_mat,
    device_ms,
    device_ms_cold,
    microbench_int8,
    profile_step,
    quant_quality,
    t5_outlier_ab,
)

GEMV_SOURCE = "diffusionkit_tpu_torch/csrc/gemv_sm90.cu"
F32_DEQUANT_SOURCE = "diffusionkit_tpu_torch/csrc/dequant_f32.cu"
KERNELS = {
    "mod_ln": ("diffusionkit_tpu_torch/csrc/mod_ln.cu",
               "diffusionkit_tpu/ops/fused_quant.py:284"),
    "flash_attention_bshd": ("diffusionkit_tpu_torch/csrc/flash_attention_sm90.cu",
                             "diffusionkit_tpu/ops/flash_attention.py:343"),
    "int4_matmul": ("diffusionkit_tpu_torch/csrc/int4_matmul_sm90.cu",
                    "diffusionkit_tpu/ops/int4_matmul.py:74"),
    "mod_ln_quantize": ("diffusionkit_tpu_torch/csrc/mod_ln.cu",
                        "diffusionkit_tpu/ops/fused_quant.py:313"),
    "quantize": ("diffusionkit_tpu_torch/csrc/mod_ln.cu",
                 "diffusionkit_tpu/ops/fused_quant.py:246"),
    **{f"w4a8_matmul[{mode}]": ("diffusionkit_tpu_torch/csrc/w4a8_matmul_sm90.cu",
                                "diffusionkit_tpu/ops/w4a8_matmul.py:268")
       for mode in MODES},
    "gelu_quantize": ("diffusionkit_tpu_torch/csrc/mod_ln.cu",
                      "diffusionkit_tpu/ops/fused_quant.py:229"),
    "w8_matmul": ("diffusionkit_tpu_torch/csrc/w8_matmul_sm90.cu",
                  "diffusionkit_tpu/ops/w4a8_matmul.py:530"),
    "int8_matmul": ("diffusionkit_tpu_torch/csrc/int4_matmul_sm90.cu",
                    "diffusionkit_tpu/ops/int4_matmul.py:244"),
    "flash_attention_stats": ("diffusionkit_tpu_torch/csrc/flash_attention_sm90.cu",
                              "diffusionkit_tpu/ops/flash_attention.py:432"),
    "flash_attention": ("diffusionkit_tpu_torch/csrc/flash_attention_sm90.cu",
                        "diffusionkit_tpu/ops/flash_attention.py:513"),
    "dequant_w8": ("diffusionkit_tpu_torch/csrc/w8_matmul.cu",
                   "diffusionkit_tpu/ops/w4a8_matmul.py:453"),
    "int8_dot": ("diffusionkit_tpu_torch/csrc/w8_matmul_sm90.cu",
                 "tools/microbench_pallas_int8.py:42"),
    # The M <= 16 `ada` GEMVs of C, #13 and E (mode plain): one split-K source.
    "int4_matmul[gemv]": (GEMV_SOURCE, "diffusionkit_tpu/ops/int4_matmul.py:74"),
    "int8_matmul[gemv]": (GEMV_SOURCE, "diffusionkit_tpu/ops/int4_matmul.py:244"),
    "w4a8_matmul[gemv]": (GEMV_SOURCE, "diffusionkit_tpu/ops/w4a8_matmul.py:268"),
    # #11's M <= 16 GEMV, with its quantizing entry (kernel D in its prologue).
    "w8_matmul[gemv]": (GEMV_SOURCE, "diffusionkit_tpu/ops/w4a8_matmul.py:530"),
    # Kernel C on fp32 x (SD3.5-large's block 35): 3xTF32 wgmma above 16
    # rows, an FMA tile at M <= 16.
    "int4_matmul[f32]": (F32_DEQUANT_SOURCE, "diffusionkit_tpu/ops/int4_matmul.py:74"),
    # The GPTQ group step: the body of the reference's lax.scan (gbody), which
    # XLA compiles there; no Pallas call.
    "gptq_group": ("diffusionkit_tpu_torch/csrc/gptq.cu", "diffusionkit_tpu/ops/gptq.py:313"),
    # D's and #4's two-pass form (a row split over tensor-parallel ranks):
    # pass 1 the rows' local absmax, pass 2 the quantization on the group's.
    "quantize[two-pass]": ("diffusionkit_tpu_torch/csrc/mod_ln.cu",
                           "diffusionkit_tpu/ops/fused_quant.py:246"),
    "gelu_quantize[two-pass]": ("diffusionkit_tpu_torch/csrc/mod_ln.cu",
                                "diffusionkit_tpu/ops/fused_quant.py:229"),
    # Kernel E's gelu_quant epilogue in two passes over scale tiles split
    # between ranks (a split w4a8 FFN whose local hidden is not whole tiles).
    "gelu_quant[tiles]": ("diffusionkit_tpu_torch/csrc/mod_ln.cu",
                          "diffusionkit_tpu/ops/w4a8_matmul.py:268"),
    # C and #13 on bf16 x with an fp32 output (a row-parallel linear's
    # partial product, summed over the ranks and rounded once): the Hopper
    # loop's fp32 store above 16 rows, the GEMV's at M <= 16.
    "int4_matmul[f32out]": ("diffusionkit_tpu_torch/csrc/int4_matmul_sm90.cu",
                            "diffusionkit_tpu/ops/int4_matmul.py:74"),
    "int8_matmul[f32out]": ("diffusionkit_tpu_torch/csrc/int4_matmul_sm90.cu",
                            "diffusionkit_tpu/ops/int4_matmul.py:244"),
    # #13 on fp32 x (SD3.5-large int8's block 35): C's fp32 tile with bytes.
    "int8_matmul[f32]": (F32_DEQUANT_SOURCE, "diffusionkit_tpu/ops/int4_matmul.py:244"),
}
# Each GEMV's entry in the line and that of its function at M > 16 (the same
# bound; that entry points here as `small_m`).
GEMVS = {"int4_matmul[gemv]": "int4_matmul", "int8_matmul[gemv]": "int8_matmul",
         "w4a8_matmul[gemv]": "w4a8_matmul[plain]", "w8_matmul[gemv]": "w8_matmul"}
# The kernel (template) that runs each function's main-path shapes in bf16;
# the fp32 flash instantiations and the other tiles are in the sources the
# summary names beside it.
SYMBOLS = {
    "mod_ln": "mod_ln_kernel", "flash_attention_bshd": "flash_fwd_sm90<D, false>",
    "int4_matmul": "int4_mm_sm90<BN, bf16>", "mod_ln_quantize": "mod_ln_quant_kernel",
    "quantize": "quantize_kernel<T, NV>",
    **{f"w4a8_matmul[{mode}]": "w4a8_mm_sm90<MODE, BN>" for mode in MODES},
    "gelu_quantize": "gelu_quantize_kernel", "w8_matmul": "w8_mm_sm90<bf16|float, BN>",
    "int8_matmul": "int8_mm_sm90<BN, bf16>", "flash_attention_stats": "flash_fwd_sm90_stats<128>",
    "flash_attention": "flash_fwd_sm90<D, true>", "dequant_w8": "dequant_w8_kernel<G>",
    "int8_dot": "w8_mm_sm90<int, BN>", "int4_matmul[gemv]": "int4_gemv",
    "int8_matmul[gemv]": "int8_gemv", "w4a8_matmul[gemv]": "w4a8_gemv",
    "w8_matmul[gemv]": "w8_gemv<XT, OutT>",
    "int4_matmul[f32]": "dequant_mm_3xtf32<4> (M > 16), dequant_mm_f32<4> (M <= 16)",
    "gptq_group": "gptq_group_kernel<GS>",
    "quantize[two-pass]": ("row_absmax_kernel<T, NV, ACT_NONE>, "
                           "quantize_amax_kernel<T, NV, ACT_NONE>"),
    "gelu_quantize[two-pass]": ("row_absmax_kernel<T, NV, GELU_ERF>, "
                                "quantize_amax_kernel<T, NV, GELU_ERF>"),
    "gelu_quant[tiles]": "tile_absmax_kernel, tile_quantize_kernel",
    "int4_matmul[f32out]": "int4_mm_sm90<BN, float> (M > 16), int4_gemv with out_f32 (M <= 16)",
    "int8_matmul[f32out]": "int8_mm_sm90<BN, float> (M > 16), int8_gemv with out_f32 (M <= 16)",
    "int8_matmul[f32]": "dequant_mm_3xtf32<8> (M > 16), dequant_mm_f32<8> (M <= 16)",
}
# The sources and kernels of each function's other shapes: the fp32 flash
# kernels (3xTF32 on wgmma at d = 64 and 128, on mma.sync at d = 512);
# kernel B and #15 at d = 512 (the split-KV wgmma kernel and its
# merge); #14 at d = 64 (flash_fwd_sm90_stats64, 64-row blocks; its launches
# on path h); #16 at M <= 16
# (w8_mm, the mma.sync main loop); #11 and #16 at M > 16 and K % 128 != 0
# (w8_mm_sm90_k64, the 64-deep Hopper loop); C, #13 and #11 at M <= 16 and
# E's mode plain there: the GEMV entries of the line.
FP32_SOURCE = "diffusionkit_tpu_torch/csrc/flash_attention_f32.cu"
FP32_SYMBOLS = ("flash_fwd_3xtf32_sm90<64 | 128, mode> (d = 64, 128), "
                "flash_fwd_3xtf32<mode> (d = 512)")
WIDE_SOURCE = "diffusionkit_tpu_torch/csrc/flash_attention_wide_sm90.cu"
W8_SMALL_SOURCE = "diffusionkit_tpu_torch/csrc/w8_matmul.cu"
FLASH_KERNELS = ("flash_attention_bshd", "flash_attention", "flash_attention_stats")
OTHER_SOURCES = {
    "flash_attention_bshd": {"fp32_source": FP32_SOURCE, "fp32_symbols": FP32_SYMBOLS,
                             "d512_source": WIDE_SOURCE,
                             "d512_symbols": "flash_fwd_wide_sm90<false>, flash_wide_merge<false>"},
    "flash_attention": {"fp32_source": FP32_SOURCE, "fp32_symbols": FP32_SYMBOLS,
                        "d512_source": WIDE_SOURCE,
                        "d512_symbols": "flash_fwd_wide_sm90<true>, flash_wide_merge<true>"},
    "flash_attention_stats": {"fp32_source": FP32_SOURCE, "fp32_symbols": FP32_SYMBOLS,
                              "d64_source": "diffusionkit_tpu_torch/csrc/flash_attention_sm90.cu",
                              "d64_symbols": "flash_fwd_sm90_stats64"},
    "int8_dot": {"small_m_source": W8_SMALL_SOURCE},
    **{base: {"small_m": name} for name, base in GEMVS.items()},
    **{f"{name}[f32out]": {"small_m_source": GEMV_SOURCE}
       for name in ("int4_matmul", "int8_matmul")},
    "gptq_group": {"replaces_kind": "the body (gbody) of the reference's lax.scan over weight "
                                    "groups, compiled by XLA; not a Pallas call"},
    "w8_matmul": {"small_m": "w8_matmul[gemv]",
                  "k64_source": "diffusionkit_tpu_torch/csrc/w8_matmul_sm90.cu",
                  "k64_symbols": "w8_mm_sm90_k64<bf16|float>"},
}
COUNTED = {"mod_ln": mod_ln, "flash_attention_bshd": flash_attention_bshd,
           "int4_matmul": int4_matmul, "mod_ln_quantize": mod_ln_quantize,
           "quantize": quantize, "gelu_quantize": gelu_quantize, "w8_matmul": w8_matmul,
           "int8_matmul": int8_matmul, "flash_attention_stats": flash_attention_stats,
           "flash_attention": flash_attention, "dequant_w8": dequant_w8, "int8_dot": int8_dot,
           "gptq_group": gptq_group}
# The wrappers that count their fp32 launches apart (``f32_launches``).
F32_COUNTED = {"mod_ln": mod_ln, "mod_ln_quantize": mod_ln_quantize, "quantize": quantize,
               "flash_attention_bshd": flash_attention_bshd, "int4_matmul": int4_matmul,
               "int8_matmul": int8_matmul, "w4a8_matmul": w4a8_matmul, "w8_matmul": w8_matmul}
# The path whose launches the kernels line reports for each kernel: the
# slice that brought it, or for kernel C, which the w4a8 path must not run,
# the FLUX int4 path; #10 the FLUX w4a8 path (mode plain above 16 rows).
# Kernel E's mode plain Hopper loop runs on no model path since that route
# (0 launches on each, in launches_by_path): the tool path's kernel row.
MAIN_PATH = {"mod_ln": "sd3", "flash_attention_bshd": "sd3", "int4_matmul": "flux",
             "int4_matmul[gemv]": "flux", "int8_matmul[gemv]": "sd3-int8",
             "w8_matmul[gemv]": "sd3-w8a8",
             "gelu_quantize": "sd3-w8a8", "w8_matmul": "sd3-w8a8", "int8_matmul": "sd3-int8",
             "flash_attention_stats": "flux-w4a8-2048-ring", "flash_attention": "sd3-bhsd",
             "int8_dot": "microbench-int8", "w4a8_matmul[plain]": "bench-w4a8-mat",
             "int4_matmul[f32]": "sd35-4bit", "gptq_group": "sd3-int4-gptq",
             "quantize[two-pass]": "flux-w4a8-t5w8a8-tp2",
             "gelu_quantize[two-pass]": "sd3-w8a8-tp2",
             "int4_matmul[f32out]": "sd3-int4-tp2", "int8_matmul[f32out]": "sd3-int8-tp2",
             "int8_matmul[f32]": "sd35-int8", "gelu_quant[tiles]": "sd35-w4a8-tp2"}
# The two tool paths: each tool's run at the reference's default shape.
TOOLS = {"bench-w4a8-mat": bench_w4a8_mat, "microbench-int8": microbench_int8}
# Per-request launches the attention kernels must match exactly.
EXACT = ("flash_attention_bshd", "flash_attention", "flash_attention_stats")


@dataclasses.dataclass(frozen=True)
class Path:
    """One main path: its requests and per-request settings."""

    name: str
    steps: int
    cfg: float
    latent: tuple
    txt_tokens: int
    requests: tuple


SD3 = Path("sd3", 50, 5.0, (64, 64), 154, (
    ("a photo of an astronaut riding a horse on the moon", 42),
    ("a watercolor painting of a lighthouse at dusk, soft light", 7),
))
FLUX = Path("flux", 4, 0.0, (128, 128), 256, (
    ("a photo of a red fox in the snow, morning light", 3),
    ("an isometric illustration of a tiny island city", 11),
))
FLUX_W4A8 = dataclasses.replace(FLUX, name="flux-w4a8")
SD3_W8A8 = dataclasses.replace(SD3, name="sd3-w8a8")
SD3_INT8 = dataclasses.replace(SD3, name="sd3-int8")
FLUX_E2E = dataclasses.replace(FLUX, name="flux-w4a8-t5w8a8")
# The dual + single blocks of f's float FLUX.1-schnell converted by GPTQ
# (full width; all 19 + 38 took 48-61 s of the smoke on an H100).
FLUX_GPTQ_DEPTH = (2, 4)
# Path q: f's pipeline behind GenerationServer over HTTP, at f's settings;
# its requests bench_serving's prompts and seeds.
FLUX_SERVE = dataclasses.replace(FLUX_E2E, name="flux-w4a8-serve")
SERVE_BATCHES = (1, 4, 8)
SERVE_RUNS = 1  # rounds a batch, and bench_serving's timed runs; 1 keeps the smoke near 600 s
# bench.py's flux-2048: 16384 image + 256 text tokens; and its request 0
# through the default dispatch, the ring's flash twin.
FLUX_RING = dataclasses.replace(FLUX, name="flux-w4a8-2048-ring", latent=(256, 256))
FLUX_RING_TWIN = dataclasses.replace(FLUX_RING, name="flux-w4a8-2048-flash",
                                     requests=FLUX.requests[:1])
SD3_BHSD = dataclasses.replace(SD3, name="sd3-bhsd", requests=SD3.requests[:1])
# SD3-medium at its native 1024² (4096 image + 154 text tokens) through the
# ring on one rank (path h: #14 at d=64), and its request 0 through the
# default dispatch, the ring's flash twin (h').
SD3_RING = dataclasses.replace(SD3, name="sd3-1024-ring", latent=(128, 128))
SD3_RING_TWIN = dataclasses.replace(SD3_RING, name="sd3-1024-flash", requests=SD3.requests[:1])
# SD3.5-large at its native 1024² (4096 image + 154 text tokens), CFG 5.0,
# T5 off, bench.py's bench_sd35_w4a8 (8 steps, its n): i, w4a8 (a random
# packed init given to quantize_mmdit="w4a8", which adds the wscale); i',
# the 4-bit release (int4 weight-only, packed at group 64: kernel C); k,
# bf16 with T5-XXL at 512 tokens (77 + 512 = 589 text tokens, 4685 joint).
# j: FLUX.1-dev bf16 at 1024², guidance 3.5 (the default), T5 at 512 tokens
# (4608 joint), 4 steps.
SD35 = Path("sd35-w4a8", 8, 5.0, (128, 128), 154, SD3.requests)
# i' and k serve one request each (and its repeat), for the smoke's time.
SD35_4BIT = dataclasses.replace(SD35, name="sd35-4bit", requests=SD35.requests[:1])
SD35_T5 = dataclasses.replace(SD35, name="sd35-t5", txt_tokens=589, requests=SD35.requests[:1])
# t, u, v: a float bf16 SD3.5-large drawn on the card and converted by
# DiffusionPipeline(quantize_mmdit=...): w4a8-mixed by GPTQ (the first GPTQ
# at 8B), int8 (#13 on every block linear, block 35's on its fp32 tile) and
# w8a8 (#11 everywhere); i's settings.
SD35_W4A8_MIXED = dataclasses.replace(SD35, name="sd35-w4a8-mixed")
# u and v serve one request each (and its repeat), for the smoke's time.
SD35_INT8 = dataclasses.replace(SD35, name="sd35-int8", requests=SD35.requests[:1])
SD35_W8A8 = dataclasses.replace(SD35, name="sd35-w8a8", requests=SD35.requests[:1])
# The quantize mode of each SD3.5 path, and whether its float model went
# through the conversion whole (the embedders and the final layer too: a
# float model given to the pipeline) or was drawn packed (block linears).
SD35_MODES = {SD35.name: ("w4a8", False), SD35_4BIT.name: ("int4", False),
              SD35_W4A8_MIXED.name: ("w4a8-mixed", True), SD35_INT8.name: ("int8", True),
              SD35_W8A8.name: ("w8a8", True)}
FLUX_DEV_PATH = Path("flux-dev", 4, 0.0, (128, 128), 512, FLUX.requests)
# w: a float FLUX.1-dev (full width, FLUX_GPTQ_DEPTH blocks: the smoke's
# time) written as its file and loaded by FluxPipeline(model_version=
# FLUX.1-dev, quantize_mmdit="w4a8"): GPTQ at the first request, the
# quantized-tree cache at the second; j's settings. Its bf16 twin is the same
# float model through j's pipeline.
FLUX_DEV_GPTQ = dataclasses.replace(FLUX_DEV_PATH, name="flux-dev-w4a8-gptq")
FLUX_DEV_GPTQ_SEED = 24
# x: i's SD3.5-large w4a8 over create_mesh(1, 2), two gloo processes on the
# one card, SD35_TP.steps of i's 8 steps (each step's 152 row-parallel sums
# and 76 chained FFN sums go through the host, ~17.6 s a step); x4: one CFG forward of SD3.5-large int4 over
# create_mesh(1, 4) against the unsharded one, X4_DEPTH blocks (every block
# takes the same routes) with the fp32-upcast block kept, at 512² (1024 +
# 154 tokens): 38 heads do not divide over 4 ranks, so every joint
# attention takes the materialised-score attention (the reference's rule
# for flash under a mesh), whose fp32 scores at 1024² (5.5 GB a call) put
# four ranks' peaks past the one card's 80 GB.
SD35_TP = dataclasses.replace(SD35, name="sd35-w4a8-tp2", steps=1, requests=SD35.requests[:1])
SD35_TP4 = "sd35-int4-tp4"
X4_DEPTH, X4_UPCAST, X4_LATENT = 4, (2,), (64, 64)
# img2img: l, SD3-medium 512² on a's models from a's request-1 image (a
# 530 x 520 copy, so read_image's LANCZOS resize runs), 50 steps at denoise
# 0.6, so the last 30 run, CFG 5.0; m, FLUX.1-schnell w4a8 1024² on c's
# models from c's request-0 image, 4 steps at denoise 0.5, so 2 run. Each
# path's encoder is loaded from a checkpoint file the smoke writes, at the
# first img2img request: SD3's namespace (first_stage_model.encoder.*, F16)
# for l, FLUX's ae.safetensors (encoder.*, BF16) for m.
SD3_IMG2IMG = dataclasses.replace(SD3, name="sd3-img2img", requests=SD3.requests[:1])
# Loading every model from its files: n, a's requests through
# DiffusionPipeline(load=True, low_memory_mode=True) from a's models written
# as SD3-medium's files; o, b's requests through the FLUX.1-schnell 4-bit
# release's files (the MLX namespace) written from b's models.
SD3_LOADED = dataclasses.replace(SD3, name="sd3-loaded")
# Path p: a's request 0 twice, the second from the quantized-model cache.
SD3_GPTQ = dataclasses.replace(SD3, name="sd3-int4-gptq", requests=(SD3.requests[0],) * 2)
# Phase 6t, the mode table: quant_quality.run on path n's files at the JAX
# gate's config (tests/test_quant_quality.py: 256², 6 steps, CFG 5.0, seed
# 42), bf16 and each quantize mode, the pipelines' default quantizers; the
# int8 family held to that gate's floors (:42-45).
QUALITY_STEPS, QUALITY_LATENT = 6, (32, 32)
QUALITY = {mode: Path(f"sd3-quality-{mode or 'bf16'}", QUALITY_STEPS, 5.0, QUALITY_LATENT, 154,
                      ((quant_quality.PROMPT, 42),)) for mode in quant_quality.MODES}
QUALITY_FLOORS = {"int8": 38.0, "w8a8": 31.0}
GPTQ_MODES = ("int4", "w4a8", "int4-mixed", "w4a8-mixed")
FLUX_LOADED = dataclasses.replace(FLUX, name="flux-4bit-loaded")
FLUX_IMG2IMG = dataclasses.replace(FLUX, name="flux-w4a8-img2img", requests=FLUX.requests[:1])
DENOISE = {SD3_IMG2IMG.name: 0.6, FLUX_IMG2IMG.name: 0.5}
IMG2IMG_SOURCE_SIZE = (530, 520)
LAYOUT_ENV = "DIFFUSIONKIT_TPU_ATTN_LAYOUT"
# Relative L2 between two runs of one request that differ only in the
# attention's numerics (a' against a, the flash twins g' and h' against g
# and h).
TWIN_RTOL = 3e-2
# Phase 6 batch: images of one request (path a's and c's models), one
# denoise chunk under the auto-split; and its override, one image a chunk.
NUM_IMAGES = 4
SPLIT_ENV = "DIFFUSIONKIT_TPU_DENOISE_BATCH"
T5_LAYERS = T5_XXL.num_layers

# SD3 image / text stream sites; FLUX.1-schnell 1024²'s image / text stream
# sites (path b; its 38 single blocks' sites are 4352 rows).
MOD_LN_SHAPES = [(2, 1024, 1536), (2, 154, 1536), (1, 4096, 3072), (1, 256, 3072)]
# SD3 joint attention / VAE mid-block at 512² / FLUX joint attention at
# 1024² / VAE mid-block at 1024² (FLUX's decode).
FLASH_SHAPES = [(2, 1178, 24, 64), (1, 4096, 1, 512), (1, 4352, 24, 128), (1, 16384, 1, 512)]
# The fp32 kernels' shapes: the first three (the a16=False decode at 512²,
# fp32 MMDiTs).
FP32_FLASH_SHAPES = FLASH_SHAPES[:3]
# The VAE mid-block at 2048² (path g's decode): kernel B and #15 checked
# against their plain version in blocks of PLAIN_ROWS query rows (all 65536²
# fp32 scores would take 17 GB; each block's, 1 GB) and timed beside
# F.scaled_dot_product_attention.
FLASH_VAE_2048 = (1, 65536, 1, 512)
PLAIN_ROWS = 4096
# Checked but not timed: kv edges short of a key tile (77: 51 keys short of
# 128), one key past one (129) and one past nine (1153), where an unmasked
# pad would move the outputs by far more than the bound.
FLASH_RAGGED = [(1, s, 3, d) for s in (77, 129, 1153) for d in (64, 128)]
# Kernel B at path g′'s shape (FLUX.1-schnell 2048²: 16384 image + 256 text
# tokens, 24 heads of 128): checked head by head (all heads' fp32 scores
# would take 26.6 GB), timed beside F.scaled_dot_product_attention, its
# plain version timed on one head.
FLASH_LONG = (1, 16640, 24, 128)
# (M, K, N, group) of kernel C on the FLUX path: the unified blocks' q/k/v/o
# and fc1, the dual blocks' fc2 (image stream), the text stream, a dual and
# a single block's `ada` GEMV; the same q shape at the quantize-at-load
# group 32; and a ragged M (checked, not timed).
INT4_SHAPES = [(4352, 3072, 3072, 64), (4352, 3072, 12288, 64), (4352, 12288, 3072, 64),
               (256, 3072, 3072, 64), (1, 3072, 18432, 64), (1, 3072, 9216, 64),
               (4352, 3072, 3072, 32)]
INT4_RAGGED = [(77, 3072, 3072, 64)]
# Kernels A' (B, S, H) and D (M, K) at the FLUX w4a8 shapes: the AdaLN sites
# of the image stream, the text stream and the unified blocks; the `ada`
# input silu(c) and the `o` inputs; then at SD3-medium w8a8's (path d, 512²
# CFG): the image and text stream sites, the `o` inputs; A' also at FLUX
# 2048²'s image stream (path g). A ragged S of 77 and SD3.5-large's hidden
# 2432 (304 bf16 vectors, not a multiple of 32 lanes) at a ragged S are
# checked, not timed.
MOD_LN_QUANT_SHAPES = [(1, 4096, 3072), (1, 256, 3072), (1, 4352, 3072), (2, 1024, 1536),
                       (2, 154, 1536), (1, 16384, 3072)]
# D also at FLUX 2048²'s image and unified rows (path g), at the inputs of
# SD3-medium w8a8's M = 2 GEMVs (path d runs them through #11's quantizing
# GEMV instead), its context embedder (308 x 4096) and x_embedder (2048 x
# 64), and T5-XXL w8a8's q/k/v and wi inputs (256 x 4096); fp32 rows and
# ragged M (QUANTIZE_CHECKED) checked, not timed. Timed cold (bench_rows,
# input copies past 100 MB) where the input is at least COLD_MIN_BYTES;
# below that only warm: a few KB, in L2 from their producer.
QUANTIZE_SHAPES = [(1, 3072), (4096, 3072), (256, 3072), (4352, 3072), (2048, 1536),
                   (308, 1536), (16384, 3072), (16640, 3072), (2, 1536), (2, 256), (2, 2048),
                   (308, 4096), (2048, 64), (256, 4096)]
QUANTIZE_CHECKED = [((4352, 3072), torch.float32), ((2, 1536), torch.float32),
                    ((256, 10240), torch.float32), ((16384, 3072), torch.float32),
                    ((77, 3072), torch.bfloat16), ((701, 1536), torch.bfloat16),
                    ((4099, 64), torch.bfloat16), ((3, 16384), torch.bfloat16)]
COLD_MIN_BYTES = 1 << 18
QUANT_RAGGED = [(1, 77, 3072), (2, 333, 2432)]
# (M, K, N, group) of kernel E by mode on the FLUX w4a8 path: `ada` GEMVs
# (dual and single), v/o of the image stream and the unified blocks, the
# text stream; q/k; fc1; fc2; the quantize-at-load group 32 at one shape of
# each mode; mode plain also at 2048²'s image and unified rows (path g).
# Ragged M (checked, not timed) in W4A8_RAGGED. Mode plain above 16 rows:
# kernel E's Hopper loop held against its plain version and timed, beside
# #10 then #11, the route those shapes take (plain_ab).
W4A8_SHAPES = {
    "plain": [(1, 3072, 18432, 64), (1, 3072, 9216, 64), (4096, 3072, 3072, 64),
              (4352, 3072, 3072, 64), (256, 3072, 3072, 64), (4352, 3072, 3072, 32),
              (16384, 3072, 3072, 64), (16640, 3072, 3072, 64)],
    "norm_rope": [(4096, 3072, 3072, 64), (4352, 3072, 3072, 64), (4352, 3072, 3072, 32)],
    "gelu_quant": [(4096, 3072, 12288, 64), (256, 3072, 12288, 64), (4352, 3072, 12288, 64),
                   (4352, 3072, 12288, 32)],
    "grouped_xs": [(4096, 12288, 3072, 64), (256, 12288, 3072, 64), (4352, 12288, 3072, 64),
                   (4352, 12288, 3072, 32)],
}
W4A8_RAGGED = {"plain": [(77, 3072, 3072, 64)], "norm_rope": [(77, 3072, 3072, 64)],
               "gelu_quant": [(77, 3072, 12288, 64)], "grouped_xs": [(77, 12288, 3072, 64)]}
# Tolerances of the w4a8 kernels against their plain versions on the card:
# - plain and grouped_xs: bit-identical (the int32 products are exact and
#   the fp32 epilogue runs in the same order, each step rounded);
# - norm_rope: one bf16 ulp of the plain output plus 2^-21 of the largest
#   |output| per element (the order of the 128-term mean and rsqrt's last
#   bits move the fp32 terms by ~1e-7 relative, which crosses a bf16
#   rounding boundary now and then, and a near-zero rotated output
#   x1 cos - x2 sin keeps the terms' absolute error: 209 of 13.4M elements
#   differed at (4352, 3072, 3072), the worst by 3e-8 at |out| ~ 4e-6);
# - gelu_quant: y8 one step apart on at most 0.1 % of the elements (exp's
#   last bit), scales within 1e-6 relative;
# - mod_ln_quantize: x8 one step apart on at most 1 % (the LayerNorm's fp32
#   sums in another order; rsqrt correctly rounded), scales within 1e-5;
# - quantize: bit-identical (max, IEEE division and round-half-even).
INT8_FLIP_SHARE = {"gelu_quant": 1e-3, "mod_ln_quantize": 1e-2}
# Kernel B against fp32 math, per element: one bf16 ulp of the exact value
# (half for the output rounding, half for crossing a binade) plus 2^-8 of
# the largest |output| for P rounded to bf16 before P.V. The same numerics
# in plain torch on the CPU reach 0.31-0.40 of this bound at these shapes;
# leaving the 38 pad keys of (2, 1178, 24, 64) unmasked reaches 2.
FLASH_SLACK = 2.0**-8
# The fp32 flash kernels against their fp32 plain versions on the card, per
# element: 2^-16 of the largest |output| (each of #14's o, m, l to its own
# largest magnitude). fp32 sums in another order: the plain version against
# the Pallas kernels' tiled order reaches 0.008-0.13 of it on the CPU
# (tests/test_torch_ops.py); a TF32 product or P rounded to bf16 would
# exceed it by 100x or more.
FP32_FLASH_SLACK = 2.0**-16
# Relative L2 of an fp32 model on the card (kernels on, TF32 off) against
# the same weights in fp32 on the CPU: the order of fp32 sums only.
FP32_RTOL = 1e-4
# Kernel C against fp32 math on the same bf16-rounded weights, per element:
# one bf16 ulp (the output rounding, across a binade edge) plus twice the
# worst-case fp32 summation error of K terms, K * 2^-24 * (|x| @ |w|): the
# kernel and the reference differ only in the order of the fp32 sums. A
# wrong nibble, group or scale moves an output by O(|x| @ |w|), far above.
# bf16 activations through full-width blocks: the plain bf16 SD3 path on the
# CPU lands at a relative L2 error of 8.5e-3 on its check; the same bound
# holds FLUX's three blocks (the int4 weights are identical on both sides).
REF_RTOL = 3e-2

# The H100 SXM's published dense peaks and memory rate (NVIDIA's data
# sheet), against which each kernel's bound is computed. fp32-accurate
# products on the tensor cores are 3xTF32: three passes at the 495 TFLOP/s
# TF32 rate; "fp32" is the CUDA cores' FMA rate.
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "tf32x3": 495e12 / 3}
# Weight bytes the cold GEMV timings rotate through: twice the 50 MB L2.
COLD_BYTES = bench_gemv.COLD_BYTES
HBM = 3.35e12
# Non-tensor fp32 operations an element of the row kernels: mod_ln's sums,
# centring, squares and modulation; A' adds the absmax and the rounding;
# D the absmax, division and rounding; #4 the A&S GELU (~25) and D's.
ROW_OPS = {"mod_ln": 9, "mod_ln_quantize": 12, "quantize": 3, "gelu_quantize": 30}


def bound(ops: float, peak: str, nbytes: float) -> tuple:
    """(ms, what sets it): the larger of ``ops`` at the card's peak rate for
    their type and ``nbytes`` (each input read once, each output written
    once) at the memory rate."""
    t_ops, t_bytes = ops / PEAK[peak], nbytes / HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_bound(name: str, shape, dtype: str = "bf16", fp32_peak: str = "tf32x3") -> tuple:
    """The bound of one call of kernel ``name`` at ``shape`` (bf16
    activations; the flash kernels also in fp32, their products then at
    ``fp32_peak``: the 3xTF32 rate, or "fp32" for the FMA rate), in the
    layout each phase times it."""
    size = 4 if dtype == "fp32" else 2  # bytes an element of q, k, v (x, y)
    if dtype == "fp32":
        dtype = fp32_peak
    name = name.replace("[f32]", "")  # C / #13's fp32 tile: the same function
    out_size = size
    if "[f32out]" in name:  # C / #13 on bf16 x, the fp32 partial product written
        name, out_size = name.replace("[f32out]", ""), 4
    name = name.replace("[two-pass]", "")  # D / #4 in two passes: the same function
    if name == "gelu_quant[tiles]":
        # (M, N, T): one rank's fp32 y read once, its int8 hidden written,
        # its T tiles' absmax and scale written (the all-reduce between the
        # passes apart); the GELU and the grid an element.
        m, n, t = shape
        return bound(ROW_OPS["gelu_quantize"] * m * n, "fp32", 5 * m * n + 8 * m * t)
    if name == "w8_matmul[gemv]":  # the quantizing entry: bf16 x read once, no scales
        m, k, n = shape
        return bound(2 * m * k * n, "int8", 2 * m * k + n * k + 6 * n + 2 * m * n)
    name = GEMVS.get(name, name)  # a GEMV's bound is its function's
    if name == "gptq_group":
        # (G, gs, N): w read once, codes and err written once, the scales,
        # zeros and U's block; 9 ALS passes of ~12 fp32 operations a weight
        # and the recursion's gs / 2 multiply-subtracts.
        g, gs, n = shape
        return bound(g * n * gs * (9 * 12 + gs), "fp32", g * (n * (9 * gs + 8) + 4 * gs * gs))
    if name == "mod_ln":
        b, s_, h = shape
        return bound(ROW_OPS[name] * b * s_ * h, "fp32", 2 * size * (b * s_ * h + b * h))
    if name == "mod_ln_quantize":
        b, s_, h = shape
        return bound(ROW_OPS[name] * b * s_ * h, "fp32",
                     (size + 1) * b * s_ * h + 4 * b * s_ + 2 * size * b * h)
    if name in ("quantize", "gelu_quantize"):
        m, k = shape
        return bound(ROW_OPS[name] * m * k, "fp32", 3 * m * k + 4 * m)
    if name == "flash_attention_bshd":
        b, s_, h, d = shape
        return bound(4 * b * h * s_ * s_ * d, dtype, 4 * size * b * s_ * h * d)
    if name == "flash_attention":
        b, h, s_, d = shape
        return bound(4 * b * h * s_ * s_ * d, dtype, 4 * size * b * s_ * h * d)
    if name == "flash_attention_stats":
        # This run's data needs the vlen valid keys only: the products over
        # them, q and k/v's valid rows read once (nothing at vlen 0), the
        # fp32 o and the fp32 m and l written.
        b, h, sq, skv, d, vlen = shape
        reads = size * b * h * (sq + 2 * vlen) * d if vlen else 0
        return bound(4 * b * h * sq * vlen * d, dtype, reads + 4 * b * h * sq * (d + 2))
    if name == "w8_matmul":
        m, k, n = shape
        return bound(2 * m * k * n, "int8", m * k + n * k + 4 * m + 6 * n + 2 * m * n)
    if name == "int8_dot":
        m, k, n = shape
        return bound(2 * m * k * n, "int8", m * k + n * k + 4 * m * n)
    if name == "dequant_w8":
        # (K, N, group): a product and a sum an element; words, s8 and z8
        # read once, the (N, K) grid written once.
        k, n, g = shape
        return bound(2 * k * n, "fp32", k * n // 2 + 8 * (k // g) * n + k * n)
    m, k, n, g = shape
    affine = 8 * (k // g) * n  # scales and zeros
    if name == "int4_matmul":
        return bound(2 * m * k * n, dtype, size * m * k + k * n // 2 + affine + out_size * m * n)
    if name == "int8_matmul":
        return bound(2 * m * k * n, dtype, size * m * k + k * n + affine + out_size * m * n)
    mode = name[len("w4a8_matmul["):-1]
    # An fp32 row of kernel E (block 35's): the bias and the output in fp32.
    out = m * n + 4 * m * (n // 512) if mode == "gelu_quant" else size * m * n
    xs = 4 * m * (k // 512 if mode == "grouped_xs" else 1)
    extra = 2 * m * 64 * 4 + 256 if mode == "norm_rope" else 0  # cos/sin tables, norm weight
    return bound(2 * m * k * n, "int8",
                 m * k + k * n // 2 + affine + (4 + size) * n + xs + out + extra)


def timing(name: str, shape, ms: float, plain: float, dtype: str = "bf16", **extra) -> dict:
    """One timed shape of a kernel: its time, its plain version's, its bound
    and any yardstick (``library_ms``, kernel C's time)."""
    b_ms, b_by = kernel_bound(name, shape, dtype)
    return {"shape": list(shape), "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, **({"dtype": dtype} if dtype != "bf16" else {}), **extra}


def bound_note(t: dict) -> str:
    return f"bound {t['bound_ms']!r} ms ({t['bound_by']}), at {t['bound_ms'] / t['ms']!r} of it"


STARTED = time.perf_counter()


def log(msg: str) -> None:
    """A line of the smoke's output; a phase's first line carries the
    seconds since the script started."""
    if msg.startswith("phase "):
        msg += f" [t={time.perf_counter() - STARTED:.1f} s]"
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 7)


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
    w4a8_matmul.launches = 0
    w4a8_matmul.mode_launches = dict.fromkeys(MODES, 0)
    w4a8_matmul.mat_launches = 0
    for fn in (int4_matmul, int8_matmul, w4a8_matmul, w8_matmul):
        fn.gemv_launches = 0
    int4_matmul.f32out_launches = int8_matmul.f32out_launches = 0
    w8_matmul.quantizing_launches = 0
    for fn in F32_COUNTED.values():
        fn.f32_launches = 0
    for fn in (row_absmax, quantize_amax):
        fn.launches = dict.fromkeys(fn.launches, 0)
    tile_absmax.launches = tile_quantize.launches = 0


def counts() -> dict:
    out = {name: fn.launches for name, fn in COUNTED.items()}
    out.update({f"w4a8_matmul[{m}]": n for m, n in w4a8_matmul.mode_launches.items()})
    # Mode plain's entry is kernel E's Hopper loop alone; its GEMV is [gemv].
    out["w4a8_matmul[plain]"] -= w4a8_matmul.gemv_launches
    out.update({"int4_matmul[gemv]": int4_matmul.gemv_launches,
                "int8_matmul[gemv]": int8_matmul.gemv_launches,
                "w4a8_matmul[gemv]": w4a8_matmul.gemv_launches,
                "w8_matmul[gemv]": w8_matmul.gemv_launches,
                # mode plain's calls run as #10 then #11 (not kernel E's)
                "w4a8_matmul[mat]": w4a8_matmul.mat_launches,
                # of #11's GEMV launches, those of its quantizing entry
                "w8_matmul[quantizing]": w8_matmul.quantizing_launches,
                # of C's and #13's, those on bf16 x with an fp32 output
                "int4_matmul[f32out]": int4_matmul.f32out_launches,
                "int8_matmul[f32out]": int8_matmul.f32out_launches})
    # Of each wrapper's launches, those on fp32 (an fp32-upcast block's, an
    # fp32 model's or decoder's): fp32 inputs, or for E and #11 an fp32 bias
    # or output.
    out.update({f"{name}[f32]": fn.f32_launches for name, fn in F32_COUNTED.items()})
    # The two-pass D and #4: pass 2's launches (pass 1 runs as often).
    if row_absmax.launches != quantize_amax.launches:
        raise AssertionError(f"two-pass quantizers: pass 1 launched {row_absmax.launches}, "
                             f"pass 2 {quantize_amax.launches}")
    out.update({f"{name}[two-pass]": n for name, n in quantize_amax.launches.items()})
    # The tiles form of E's gelu_quant: pass 2's launches (pass 1 runs as often).
    if tile_absmax.launches != tile_quantize.launches:
        raise AssertionError(f"tile passes: pass 1 launched {tile_absmax.launches}, pass 2 "
                             f"{tile_quantize.launches}")
    out["gelu_quant[tiles]"] = tile_quantize.launches
    return out


def gemv_cold_ms(name: str, shape) -> tuple:
    """A GEMV's device time as the path finds it, its weight cold in L2:
    one call on each of enough weight copies to pass COLD_BYTES
    (``device_ms_cold``); and the copies. ``shape`` (M, K, N, group), or
    (M, K, N) for #11's names."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    copies = -(-int(COLD_BYTES) // bench_gemv.weight_bytes(name, *shape[1:])) + 1
    fns = bench_gemv.calls(name, shape, copies, gen, torch.device("cuda"))
    ms = device_ms_cold(fns)
    del fns
    torch.cuda.empty_cache()
    return ms, copies


def rows_timing(name: str, shape, warm: float, plain: float, tag: str) -> dict:
    """One shape of kernel A' or #4: cold (``device_ms_cold`` over
    ``bench_rows.calls`` on input copies that pass 100 MB: each call reads
    its rows from device memory; the number held against the bound) beside
    warm (``device_ms``: the input stays in L2 where it fits)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    copies = -(-int(COLD_BYTES) // bench_rows.input_bytes(shape)) + 1
    fns = bench_rows.calls(name, shape, copies, gen, torch.device("cuda"))
    cold = device_ms_cold(fns)
    del fns
    torch.cuda.empty_cache()
    t = timing(name, shape, cold, plain, warm_ms=warm, cold_copies=copies)
    moved = bench_rows.moved_bytes(name, shape)
    log(f"  {name} {shape}: kernel cold {cold!r} ms ({moved / cold / 1e9!r} TB/s; {copies} input "
        f"copies), warm {warm!r} ms ({moved / warm / 1e9!r} TB/s), plain {plain!r} ms, "
        f"{bound_note(t)} [{tag}]")
    return t


def random_int4(shape, gen):
    """Random packed words, and scales/zeros giving weights of about
    +-1/sqrt(K), like a trained layer's."""
    m, k, n, group = shape
    dev = torch.device("cuda")
    q4 = torch.randint(-(2**31), 2**31, (k // 8, n), generator=gen, device=dev,
                       dtype=torch.int32)
    scales = (torch.rand(k // group, n, generator=gen, device=dev) + 0.5) * (2 / 15 / k**0.5)
    zeros = -(torch.rand(k // group, n, generator=gen, device=dev) + 0.5) / k**0.5
    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    return x, q4, scales, zeros


def kernel_inputs(gen):
    dev = torch.device("cuda")
    mod = []
    for b, s, h in MOD_LN_SHAPES:
        x = (torch.randn(b, s, h, generator=gen, device=dev) * 2 + 0.5).bfloat16()
        vec = torch.randn(b, 6 * h, generator=gen, device=dev).bfloat16()
        # shift/scale as the model passes them: strided views of one vector.
        mod.append((x, vec[:, None, :h], vec[:, None, h : 2 * h]))
    flash = [
        tuple(torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        for shape in FLASH_SHAPES
    ]
    int4 = [random_int4(shape, gen) for shape in INT4_SHAPES]
    return mod, flash, int4


def check_kernels(mod, flash, int4) -> dict:
    """Phase 3: kernel against plain math in fp32. Returns errors."""
    errs = {name: [] for name in KERNELS}
    for x, sh, sc in mod:
        got = mod_ln(x, sh, sc)
        torch.cuda.synchronize()
        want = mod_ln_plain(x.float(), sh.float(), sc.float())
        diff = (got.float() - want).abs()
        ok = bool((diff <= 0.5 * bf16_ulp(want) + 1e-5).all())
        err = diff.max().item()
        log(f"  mod_ln {tuple(x.shape)}: max_abs_err {err!r}, "
            f"tolerance half a bf16 ulp + 1e-5 per element: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mod_ln {tuple(x.shape)} disagrees with its plain version")
        errs["mod_ln"].append(err)
    gen = torch.Generator(device="cuda").manual_seed(1)
    ragged = [
        tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        for shape in FLASH_RAGGED
    ]
    for q, k, v in flash + ragged:
        scale = q.shape[-1] ** -0.5
        got = flash_attention_bshd(q, k, v, scale)
        torch.cuda.synchronize()
        want = flash_attention_bshd_plain(q.float(), k.float(), v.float(), scale)
        diff = (got.float() - want).abs()
        bound = bf16_ulp(want) + FLASH_SLACK * want.abs().max()
        err, ratio = diff.max().item(), (diff / bound).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        log(f"  flash_attention_bshd {tuple(q.shape)}: max_abs_err {err!r}, "
            f"max |want| {want.abs().max().item()!r}; tolerance one bf16 ulp + "
            f"2^-8 max|want| per element, worst element at {ratio!r} of it: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_bshd {tuple(q.shape)} disagrees")
        errs["flash_attention_bshd"].append(err)
    for shape, (x, q4, s, z) in zip(INT4_SHAPES + INT4_RAGGED,
                                    int4 + [random_int4(sh, gen) for sh in INT4_RAGGED]):
        got = int4_matmul(x, q4, s, z)
        torch.cuda.synchronize()
        w = dequantize_int4(q4, s, z, torch.bfloat16).float()
        want = x.float() @ w
        bound = bf16_ulp(want) + 2 * shape[1] * 2.0**-24 * (x.float().abs() @ w.abs())
        diff = (got.float() - want).abs()
        err, ratio = diff.max().item(), (diff / bound).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        log(f"  int4_matmul (M, K, N, group) {shape}: max_abs_err {err!r}, max |want| "
            f"{want.abs().max().item()!r}; tolerance one bf16 ulp + 2K 2^-24 (|x|@|w|) per "
            f"element, worst element at {ratio!r} of it: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"int4_matmul {shape} disagrees")
        errs["int4_matmul[gemv]" if shape[0] <= 16 else "int4_matmul"].append(err)
        del w, want, bound, diff
    return errs


def time_kernels(mod, flash, int4, tag: str) -> dict:
    """Phase 4: kernel vs plain version on the same bf16 inputs."""
    times = {name: [] for name in KERNELS}
    for x, sh, sc in mod:
        ms = device_ms(lambda: mod_ln(x, sh, sc))
        plain = device_ms(lambda: mod_ln_plain(x, sh, sc))
        moved = 2 * x.numel() * x.element_size()
        t = timing("mod_ln", tuple(x.shape), ms, plain)
        log(f"  mod_ln {tuple(x.shape)}: kernel {ms!r} ms ({moved / ms / 1e9!r} TB/s), "
            f"plain {plain!r} ms, {bound_note(t)} [{tag}]")
        times["mod_ln"].append(t)
    for q, k, v in flash:
        scale = q.shape[-1] ** -0.5
        ms = device_ms(lambda: flash_attention_bshd(q, k, v, scale))
        plain = device_ms(lambda: flash_attention_bshd_plain(q, k, v, scale), reps=5)
        qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))  # (B, H, S, D) views
        lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        b, s, h, d = q.shape
        tflops = 4 * b * h * s * s * d / (ms / 1e3) / 1e12
        t = timing("flash_attention_bshd", tuple(q.shape), ms, plain, library_ms=lib)
        log(f"  flash_attention_bshd {tuple(q.shape)}: kernel {ms!r} ms ({tflops!r} TFLOP/s), "
            f"plain {plain!r} ms, F.scaled_dot_product_attention {lib!r} ms (kernel at "
            f"{ms / lib!r}x its time), {bound_note(t)} [{tag}]")
        times["flash_attention_bshd"].append(t)
    for shape, (x, q4, s, z) in zip(INT4_SHAPES, int4):
        m, k, n, _ = shape
        ms = device_ms(lambda: int4_matmul(x, q4, s, z))
        plain = device_ms(lambda: int4_matmul_plain(x, q4, s, z))
        tflops = 2 * m * k * n / (ms / 1e3) / 1e12
        wbytes = q4.numel() * 4 + 2 * s.numel() * 4
        if m <= 16:
            times["int4_matmul[gemv]"].append(gemv_timing("int4_matmul[gemv]", shape, ms, plain,
                                                          wbytes, tag))
            continue
        t = timing("int4_matmul", shape, ms, plain)
        log(f"  int4_matmul (M, K, N, group) {shape}: kernel {ms!r} ms ({tflops!r} TFLOP/s, "
            f"{wbytes / ms / 1e9!r} TB/s of packed weight), plain {plain!r} ms, {bound_note(t)} "
            f"[{tag}]")
        times["int4_matmul"].append(t)
    return times


def gemv_timing(name: str, shape, warm: float, plain: float, wbytes: int, tag: str,
                **extra) -> dict:
    """One GEMV shape's timing: cold (``gemv_cold_ms``, the number held
    against the bound) beside warm (``device_ms``: the weight stays in L2)."""
    cold, copies = gemv_cold_ms(GEMVS[name].split("[")[0], shape)
    t = timing(name, shape, cold, plain, warm_ms=warm, cold_copies=copies, **extra)
    log(f"  {name} (M, K, N, group) {shape}: kernel cold {cold!r} ms ({wbytes / cold / 1e9!r} "
        f"TB/s of weight, scales and zeros; {copies} weight copies), warm {warm!r} ms, plain "
        f"{plain!r} ms, {bound_note(t)} [{tag}]")
    return t


def flash_long(gen, tag: str):
    """Phase 3-4, kernel B at FLASH_LONG: against its plain version on fp32
    upcasts head by head, within one bf16 ulp + 2^-8 max|want| (the largest
    over all heads), then its device time beside F.scaled_dot_product_attention
    and its bound; the plain version's time on one head (all heads at once
    do not fit). Returns (max abs error, the timing row)."""
    b, s, h, d = FLASH_LONG
    q, k, v = (torch.randn(FLASH_LONG, generator=gen, device="cuda").bfloat16() for _ in range(3))
    scale = d**-0.5
    got = flash_attention_bshd(q, k, v, scale)
    torch.cuda.synchronize()
    want = torch.cat([flash_attention_bshd_plain(q[:, :, i:i + 1].float(), k[:, :, i:i + 1].float(),
                                                 v[:, :, i:i + 1].float(), scale)
                      for i in range(h)], dim=2)
    diff = (got.float() - want).abs()
    bnd = bf16_ulp(want) + FLASH_SLACK * want.abs().max()
    err, ratio = diff.max().item(), (diff / bnd).max().item()
    ok = ratio <= 1 and bool(torch.isfinite(got).all())
    log(f"  flash_attention_bshd {FLASH_LONG} (head by head): max_abs_err {err!r}, max |want| "
        f"{want.abs().max().item()!r}; tolerance one bf16 ulp + 2^-8 max|want| per element, "
        f"worst element at {ratio!r} of it: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention_bshd {FLASH_LONG} disagrees")
    del got, want, diff, bnd
    torch.cuda.empty_cache()
    ms = device_ms(lambda: flash_attention_bshd(q, k, v, scale))
    head = tuple(t[:, :, :1] for t in (q, k, v))
    plain_head = device_ms(lambda: flash_attention_bshd_plain(*head, scale), reps=2)
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
    lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
    t = timing("flash_attention_bshd", FLASH_LONG, ms, None, library_ms=lib,
               plain_one_head_ms=plain_head)
    log(f"  flash_attention_bshd {FLASH_LONG}: kernel {ms!r} ms "
        f"({4 * b * h * s * s * d / (ms / 1e3) / 1e12!r} TFLOP/s), plain on one of the {h} "
        f"heads {plain_head!r} ms, F.scaled_dot_product_attention {lib!r} ms (kernel at "
        f"{ms / lib!r}x its time), {bound_note(t)} [{tag}]")
    del q, k, v, qh, kh, vh, head
    torch.cuda.empty_cache()
    return err, t


def flash_vae_2048(gen, tag: str) -> dict:
    """Phase 3-4, kernel B and #15 at FLASH_VAE_2048 (the VAE mid-block of
    a 2048² decode): each against its plain version on fp32 upcasts,
    PLAIN_ROWS query rows at a time against every key, within one bf16 ulp
    + 2^-8 max|want|; then their device times beside
    F.scaled_dot_product_attention on the same tensors and their bounds.
    Returns each function's (max abs error, timing row)."""
    b, s, h, d = FLASH_VAE_2048
    q, k, v = (torch.randn(FLASH_VAE_2048, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    scale = d**-0.5
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))  # (B, H, S, D) views
    lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), reps=2)
    rows = {}
    for name, fn, plain, args, axis in (
            ("flash_attention_bshd", flash_attention_bshd, flash_attention_bshd_plain,
             (q, k, v), 1),
            ("flash_attention", flash_attention, flash_attention_plain, (qh, kh, vh), 2)):
        shape = tuple(args[0].shape)
        got = fn(*args, scale)
        torch.cuda.synchronize()
        kf, vf = args[1].float(), args[2].float()
        want = torch.cat([plain(args[0].narrow(axis, r, min(PLAIN_ROWS, s - r)).float(), kf, vf,
                                scale) for r in range(0, s, PLAIN_ROWS)], dim=axis)
        del kf, vf
        diff = (got.float() - want).abs()
        bnd = bf16_ulp(want) + FLASH_SLACK * want.abs().max()
        err, ratio = diff.max().item(), (diff / bnd).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        log(f"  {name} {shape} ({PLAIN_ROWS} query rows at a time): max_abs_err {err!r}, "
            f"max |want| {want.abs().max().item()!r}; tolerance one bf16 ulp + 2^-8 max|want| "
            f"per element, worst element at {ratio!r} of it: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {shape} disagrees")
        del got, want, diff, bnd
        torch.cuda.empty_cache()
        ms = device_ms(lambda: fn(*args, scale), reps=5)
        t = timing(name, shape, ms, None, library_ms=lib,
                   plain_note=f"not timed (run {PLAIN_ROWS} query rows at a time)")
        log(f"  {name} {shape}: kernel {ms!r} ms ({4 * b * h * s * s * d / (ms / 1e3) / 1e12!r} "
            f"TFLOP/s), F.scaled_dot_product_attention {lib!r} ms (kernel at {ms / lib!r}x its "
            f"time), {bound_note(t)} [{tag}]")
        rows[name] = (err, t)
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return rows


def random_w4a8(k, n, group, gen) -> QuantizedLinear:
    """A packed layer with random words and scales/zeros as random_int4's,
    its exact per-channel wscale and a random bf16 bias."""
    _, q4, scales, zeros = random_int4((1, k, n, group), gen)
    layer = QuantizedLinear(k, n, group, dtype=torch.bfloat16, device="cuda")
    layer.q4.copy_(q4)
    layer.scales.copy_(scales)
    layer.zeros.copy_(zeros)
    layer.bias.copy_(0.1 * torch.randn(n, generator=gen, device="cuda"))
    layer.wscale = wscale_from_q4(layer)
    return layer


def w4a8_case(mode, shape, gen):
    """Inputs of one kernel E call: int8 activations as kernels A'/D give
    them, per-row scales (per (row, 512-k group) for grouped_xs), and for
    norm_rope a bf16 norm weight and (S, 64) fp32 RoPE tables."""
    m, k, n, group = shape
    layer = random_w4a8(k, n, group, gen)
    x8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    cols = k // 512 if mode == "grouped_xs" else 1
    xs = (torch.rand(m, cols, generator=gen, device="cuda") + 0.5) / (127 * k**0.5)
    extra = {}
    if mode == "norm_rope":
        ang = torch.rand(m, 64, generator=gen, device="cuda") * 6.28
        extra = dict(norm_w=(torch.rand(128, generator=gen, device="cuda") + 0.5).bfloat16(),
                     cos=torch.cos(ang), sin=torch.sin(ang))
    args = (x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, layer.bias)
    return args, extra


def int8_flips(got8, want8) -> tuple:
    diff = (got8.int() - want8.int()).abs()
    return diff.max().item(), (diff > 0).float().mean().item()


def check_w4a8_result(mode, got, want, label) -> float:
    """Hold one kernel E result against its plain version (tolerances at
    W4A8_SHAPES); returns the max abs error."""
    if mode == "gelu_quant":
        worst, share = int8_flips(got[0], want[0])
        srel = ((got[1] - want[1]).abs() / want[1]).max().item()
        ok = worst <= 1 and share <= INT8_FLIP_SHARE[mode] and srel <= 1e-6
        log(f"  w4a8_matmul[{mode}] {label}: y8 max step {worst}, on {share!r} of the "
            f"elements (<= 1 on <= {INT8_FLIP_SHARE[mode]}); scales max rel {srel!r} (<= 1e-6): "
            f"{'ok' if ok else 'FAIL'}")
        err = float(worst)
    elif mode == "norm_rope":
        want = want.float()
        diff = (got.float() - want).abs()
        ratio = (diff / (bf16_ulp(want) + 2.0**-21 * want.abs().max())).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        err = diff.max().item()
        log(f"  w4a8_matmul[{mode}] {label}: max_abs_err {err!r}, worst element at {ratio!r} "
            f"of one bf16 ulp + 2^-21 max|out|: {'ok' if ok else 'FAIL'}")
    else:
        ok = got.dtype == torch.bfloat16 and torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        log(f"  w4a8_matmul[{mode}] {label}: bit-identical to its plain version: "
            f"{'ok' if ok else 'FAIL'} (max_abs_err {err!r})")
    if not ok:
        raise AssertionError(f"w4a8_matmul[{mode}] {label} disagrees with its plain version")
    return err


def plain_ab(args, shape, tag: str) -> dict:
    """Mode plain's two dataflows at one shape above 16 rows: kernel E's
    Hopper loop (``_route="sm90"``) and #10 then #11 (``"mat"``), the routed
    call (``w4a8_route``) checked bit-identical to E and counted as its
    route's first; each timed warm (``device_ms`` on these inputs) and cold
    (``bench_w4a8_mat.dataflows``: one call on each of enough layers to pass
    100 MB, as a denoise step reads each layer once). The route must have
    taken the faster dataflow, cold and warm."""
    m = shape[0]
    route = w4a8_route(m, "plain")
    e = w4a8_matmul(*args, _route="sm90")
    mat = w4a8_matmul.mat_launches
    routed = w4a8_matmul(*args)
    torch.cuda.synchronize()
    ok = torch.equal(routed, e) and w4a8_matmul.mat_launches - mat == (route == "mat")
    log(f"  w4a8_matmul[plain] (M, K, N, group) {shape}: routed call ({route}) bit-identical to "
        f"kernel E's Hopper loop: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"w4a8_matmul[plain] {shape}: route {route} disagrees with kernel E")
    warm = {flow: device_ms(lambda flow=flow: w4a8_matmul(*args, _route=flow))
            for flow in ("sm90", "mat")}
    gen = torch.Generator(device="cuda").manual_seed(3)
    copies = -(-int(COLD_BYTES) // bench_w4a8_mat.weight_bytes(*shape[1:])) + 1
    fns = bench_w4a8_mat.dataflows(shape, copies, gen, torch.device("cuda"))
    cold = {flow: device_ms_cold(fns[flow]) for flow in ("sm90", "mat")}
    del fns
    torch.cuda.empty_cache()
    other = "mat" if route == "sm90" else "sm90"
    wins = cold[route] < cold[other] and warm[route] < warm[other]
    log(f"  w4a8_matmul[plain] (M, K, N, group) {shape} A/B: kernel E cold {cold['sm90']!r} / "
        f"warm {warm['sm90']!r} ms, #10 then #11 cold {cold['mat']!r} / warm {warm['mat']!r} ms "
        f"(E at {cold['sm90'] / cold['mat']!r}x / {warm['sm90'] / warm['mat']!r}x its time; "
        f"{copies} weight copies); route {route}: "
        f"{'the faster, ok' if wins else 'NOT the faster, FAIL'} [{tag}]")
    if not wins:
        raise AssertionError(f"w4a8_route sends {shape} to {route}, the slower dataflow")
    return {"route": route, "cold_ms": cold["sm90"], "mat_ms": warm["mat"],
            "mat_cold_ms": cold["mat"], "cold_copies": copies}


def plain_ab_edges(tag: str) -> None:
    """Mode plain's A/B off the FLUX paths, where ``w4a8_route``'s rule
    reaches beyond their shapes (``bench_w4a8_mat.AB_EDGES``: 17 to 128
    rows, groups of 128 and 256): the two dataflows' outputs bit-identical
    and the route's the faster, cold and warm."""
    for r in bench_w4a8_mat.ab(bench_w4a8_mat.AB_EDGES):
        shape = r["shape"]
        route = w4a8_route(shape[0], "plain")
        other = "mat" if route == "sm90" else "sm90"
        wins = all(r[f"{route}_{t}_ms"] < r[f"{other}_{t}_ms"] for t in ("cold", "warm"))
        log(f"  w4a8_matmul[plain] (M, K, N, group) {shape} A/B: kernel E cold "
            f"{r['sm90_cold_ms']!r} / warm {r['sm90_warm_ms']!r} ms, #10 then #11 cold "
            f"{r['mat_cold_ms']!r} / warm {r['mat_warm_ms']!r} ms ({r['copies']} layers); outputs "
            f"{'bit-identical' if r['same'] else 'DIFFER'}; route {route}: "
            f"{'the faster, ok' if wins else 'NOT the faster, FAIL'} [{tag}]")
        if not (r["same"] and wins):
            raise AssertionError(f"w4a8_matmul[plain] {shape}: the dataflows differ or the route "
                                 f"{route} is the slower")


def quantize_rule(y: torch.Tensor):
    """Kernel D's x8 and scale on any input, the plain version's where the
    rows are finite: amax the largest |y| that is not NaN, s = max(amax,
    1e-8) / 127 (inf in a row holding an infinity), x8 = clip(rne(y / s))
    with a NaN quotient at -127, both divisions IEEE."""
    v = y.float()
    a = torch.where(torch.isnan(v), torch.zeros_like(v), v.abs()).amax(dim=-1, keepdim=True)
    s = a.clamp_min(1e-8) / torch.full_like(a, 127.0)
    q = v / s
    q = torch.where(torch.isnan(q), torch.full_like(q, -127.0), q)
    return torch.round(q.clamp(-127.0, 127.0)).to(torch.int8), s


def quantize_special_values(gen) -> None:
    """Kernel D on nine rows (K = 1536 and 10240, bf16 and fp32): random
    values with +-0 and subnormals set in them, all zeros, one 1e30, one
    -3e38, +inf, -inf, NaN, subnormals only and NaN only; its x8 and scales
    bit for bit ``quantize_rule`` (the plain version on the finite rows),
    and #11's quantizing GEMV on the same rows equal to D then #11 bit for
    bit, NaN and inf outputs included."""
    for k in (1536, 10240):
        for dtype in (torch.bfloat16, torch.float32):
            rows = torch.randn(9, k, generator=gen, device="cuda") * 3
            rows[0, :6] = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e-39, -3e-39])
            rows[1] = 0.0
            rows[2, 5] = 1e30
            rows[3, 7] = -3e38
            rows[4, 1] = float("inf")
            rows[5, k - 1] = float("-inf")
            rows[6, 3] = float("nan")
            rows[7] = rows[7].sign() * 1e-39
            rows[8] = float("nan")
            y = rows.to(dtype)
            got = quantize(y)
            x8, s = quantize_rule(y)
            ok = torch.equal(got.x8, x8) and torch.equal(got.xscale.view(torch.int32),
                                                         s.view(torch.int32))
            w8 = torch.randint(-127, 128, (256, k), generator=gen, device="cuda", dtype=torch.int8)
            ws = (torch.rand(256, generator=gen, device="cuda") + 0.5) / (127 * k**0.5)
            b = (0.1 * torch.randn(256, generator=gen, device="cuda")).to(dtype)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            fused = quantize_w8_matmul(y, w8, ws, b, out_dtype=dtype)
            staged = w8_matmul(got.x8, w8, ws, got.xscale, b, out_dtype=dtype)
            same = torch.equal(fused.view(bits), staged.view(bits))
            log(f"  quantize (9, {k}) {dtype} on +-0, subnormals, 1e30, 3e38, +-inf, zeros, NaN: "
                f"bit-identical to its rule: {'ok' if ok else 'FAIL'}; #11's quantizing GEMV on "
                f"them bit-identical to D then #11: {'ok' if same else 'FAIL'}")
            if not (ok and same):
                raise AssertionError(f"quantize on special values (K {k}, {dtype}) disagrees")


def w4a8_kernels(gen, tag: str):
    """Phases 3-4b: kernels A', D and E against their plain versions on the
    card, then each one's device time beside its plain version's (and, for
    E, kernel C's at the same (M, K, N)). One shape's inputs at a time."""
    errs = {name: [] for name in KERNELS if name.startswith(("w4a8", "mod_ln_q", "quantize"))}
    times = {name: [] for name in errs}
    for shape in MOD_LN_QUANT_SHAPES + QUANT_RAGGED:
        b, s_, h = shape
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).bfloat16()
        vec = torch.randn(b, 6 * h, generator=gen, device="cuda").bfloat16()
        sh, sc = vec[:, None, :h], vec[:, None, h : 2 * h]
        got, want = mod_ln_quantize(x, sh, sc), mod_ln_quantize_plain(x, sh, sc)
        torch.cuda.synchronize()
        worst, share = int8_flips(got.x8, want.x8)
        srel = ((got.xscale - want.xscale).abs() / want.xscale).max().item()
        ok = worst <= 1 and share <= INT8_FLIP_SHARE["mod_ln_quantize"] and srel <= 1e-5
        log(f"  mod_ln_quantize {shape}: x8 max step {worst} on {share!r} of the elements "
            f"(<= 1 on <= 0.01), scales max rel {srel!r} (<= 1e-5): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mod_ln_quantize {shape} disagrees with its plain version")
        errs["mod_ln_quantize"].append(float(worst))
        if shape in MOD_LN_QUANT_SHAPES:
            warm = device_ms(lambda: mod_ln_quantize(x, sh, sc))
            plain = device_ms(lambda: mod_ln_quantize_plain(x, sh, sc))
            times["mod_ln_quantize"].append(rows_timing("mod_ln_quantize", shape, warm, plain, tag))
    for shape, dtype in [(s, torch.bfloat16) for s in QUANTIZE_SHAPES] + QUANTIZE_CHECKED:
        y = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
        got, want = quantize(y), quantize_plain(y)
        torch.cuda.synchronize()
        ok = torch.equal(got.x8, want.x8) and torch.equal(got.xscale, want.xscale)
        log(f"  quantize {shape} {dtype}: bit-identical to its plain version: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"quantize {shape} {dtype} disagrees with its plain version")
        errs["quantize"].append(0.0)
        if (shape, dtype) in QUANTIZE_CHECKED:
            continue
        warm, plain = device_ms(lambda: quantize(y)), device_ms(lambda: quantize_plain(y))
        if bench_rows.input_bytes(shape) >= COLD_MIN_BYTES:
            times["quantize"].append(rows_timing("quantize", shape, warm, plain, tag))
            continue
        t = timing("quantize", shape, warm, plain, warm_ms=warm,
                   cold_note=f"not timed ({bench_rows.input_bytes(shape)} bytes of input)")
        log(f"  quantize {shape}: kernel warm {warm!r} ms, plain {plain!r} ms, {bound_note(t)} "
            f"[{tag}]")
        times["quantize"].append(t)
    quantize_special_values(gen)
    for mode in MODES:
        name = f"w4a8_matmul[{mode}]"
        for shape in W4A8_SHAPES[mode] + W4A8_RAGGED[mode]:
            args, extra = w4a8_case(mode, shape, gen)
            gemv = mode == "plain" and shape[0] <= 16
            # Kernel E's own loop: above 16 rows mode plain is routed elsewhere.
            route = {} if gemv else {"_route": "sm90"}
            got = w4a8_matmul(*args, mode=mode, **extra, **route)
            torch.cuda.synchronize()
            want = w4a8_matmul_plain(*args, mode=mode, **extra)
            errs["w4a8_matmul[gemv]" if gemv else name].append(
                check_w4a8_result(mode, got, want, f"(M, K, N, group) {shape}"))
            if mode == "plain" and not gemv and shape not in W4A8_SHAPES[mode]:
                routed = w4a8_matmul(*args)
                torch.cuda.synchronize()
                if not torch.equal(routed, got):
                    raise AssertionError(f"w4a8_matmul[plain] {shape}: its route disagrees with E")
                log(f"  w4a8_matmul[plain] (M, K, N, group) {shape}: routed call "
                    f"({w4a8_route(shape[0], mode)}) bit-identical to kernel E's Hopper loop: ok")
                del routed
            del got, want
            if shape not in W4A8_SHAPES[mode]:
                continue
            m, k, n, group = shape
            ms = device_ms(lambda: w4a8_matmul(*args, mode=mode, **extra, **route))
            plain = device_ms(lambda: w4a8_matmul_plain(*args, mode=mode, **extra), reps=5)
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            c_ms = device_ms(lambda: int4_matmul(x, *args[1:4]))
            more = plain_ab(args, shape, tag) if mode == "plain" and not gemv else {}
            if gemv:
                times["w4a8_matmul[gemv]"].append(gemv_timing(
                    "w4a8_matmul[gemv]", shape, ms, plain, args[1].numel() * 4 + 8 * n * (k // group),
                    tag, int4_matmul_ms=c_ms))
                del args, extra, x
                continue
            tops = 2 * m * k * n / (ms / 1e3) / 1e12
            t = timing(name, shape, ms, plain, int4_matmul_ms=c_ms, **more)
            mat = (f", #10 then #11 {more['mat_ms']!r} ms (kernel at {ms / more['mat_ms']!r}x "
                   f"its time)" if more else "")
            log(f"  {name} (M, K, N, group) {shape}: kernel {ms!r} ms ({tops!r} TOP/s, "
                f"{args[1].numel() * 4 / ms / 1e9!r} TB/s of packed weight), plain {plain!r} ms, "
                f"kernel C at this shape {c_ms!r} ms{mat}, {bound_note(t)} [{tag}]")
            times[name].append(t)
            del args, extra, x
        torch.cuda.empty_cache()
    plain_ab_edges(tag)
    return errs, times


# Kernel D on rows wider than 8192: T5-XXL's wo input (256 tokens x d_ff
# 10240) and a FLUX w8a8 FFN hidden (4352 x 12288). Bit-identical.
WIDE_ROWS = [(256, 10240), (4352, 12288)]
# Kernel #4 at the SD3-medium w8a8 FFN hiddens: image rows (2 x 1024) and
# text rows (2 x 154), 6144 wide; a ragged M checked, not timed.
GELU_SHAPES = [(2048, 6144), (308, 6144)]
GELU_RAGGED = [(77, 6144)]
# (M, K, N) of kernel #11: SD3-medium w8a8 at 512² with CFG (image rows
# 2048, text rows 308): q/k/v/o, fc1, fc2; the AdaLN `ada` GEMVs of the
# blocks and the final layer, the y/t embedders' GEMVs; the x_embedder
# (K = 64), the context embedder and the final linear (N = 64); T5-XXL's
# projections at 256 tokens. A ragged M checked, not timed.
W8_SHAPES = [(2048, 1536, 1536), (308, 1536, 1536), (2048, 1536, 6144), (308, 1536, 6144),
             (2048, 6144, 1536), (308, 6144, 1536), (2, 1536, 9216), (2, 1536, 3072),
             (2, 2048, 1536), (2, 256, 1536), (2, 1536, 1536), (2048, 64, 1536),
             (308, 4096, 1536), (2048, 1536, 64), (256, 4096, 4096), (256, 4096, 10240),
             (256, 10240, 4096)]
W8_RAGGED = [(77, 1536, 1536)]
# #11's GEMV also at M = 1, 3 and 16 on the blocks' `ada` (checked, both
# entries, not timed).
W8_GEMV_ROWS = [(1, 1536, 9216), (3, 1536, 9216), (16, 1536, 9216)]
# (M, K, N, group) of kernel #13: SD3-medium int8 at the quantize-at-load
# group 32 (the x_embedder and final linear stay float: MIN_DIM). A ragged
# M checked, not timed.
INT8_SHAPES = [(2048, 1536, 1536, 32), (308, 1536, 1536, 32), (2048, 1536, 6144, 32),
               (308, 1536, 6144, 32), (2048, 6144, 1536, 32), (308, 6144, 1536, 32),
               (2, 1536, 9216, 32), (2, 1536, 3072, 32), (2, 2048, 1536, 32),
               (2, 256, 1536, 32), (2, 1536, 1536, 32), (308, 4096, 1536, 32)]
INT8_RAGGED = [(77, 1536, 1536, 32)]


def w8_gemv_timing(shape, x, args, tag: str) -> dict:
    """One shape of #11's GEMV: its quantizing entry on bf16 x (what path d
    runs; the row's ``ms``, cold, held against the bound), its int8 entry,
    and kernel D then #11 (what path d ran before), each warm (``device_ms``)
    and cold (``gemv_cold_ms``: bench_gemv's calls on weight copies past
    100 MB); the plain version's time warm."""
    _, w8, ws, _, b = args

    def staged():
        aq = quantize(x)
        return w8_matmul(aq.x8, w8, ws, aq.xscale, b)

    warm = {"quantize_w8_matmul": device_ms(lambda: quantize_w8_matmul(x, w8, ws, b)),
            "w8_matmul": device_ms(lambda: w8_matmul(*args)), "quantize+w8_matmul": device_ms(staged)}
    plain = device_ms(lambda: quantize_w8_matmul_plain(x, w8, ws, b), reps=5)
    cold, copies = {}, 0
    for name in bench_gemv.W8_NAMES:
        cold[name], copies = gemv_cold_ms(name, shape)
    t = timing("w8_matmul[gemv]", shape, cold["quantize_w8_matmul"], plain,
               warm_ms=warm["quantize_w8_matmul"], cold_copies=copies,
               int8_entry_ms=cold["w8_matmul"], int8_entry_warm_ms=warm["w8_matmul"],
               d_then_gemv_ms=cold["quantize+w8_matmul"],
               d_then_gemv_warm_ms=warm["quantize+w8_matmul"])
    wbytes = bench_gemv.weight_bytes("w8_matmul", *shape[1:])
    log(f"  w8_matmul[gemv] (M, K, N) {shape}: quantizing entry cold {cold['quantize_w8_matmul']!r} "
        f"ms ({wbytes / cold['quantize_w8_matmul'] / 1e9!r} TB/s of w8 and wscale; {copies} weight "
        f"copies), warm {warm['quantize_w8_matmul']!r} ms; int8 entry cold {cold['w8_matmul']!r} / "
        f"warm {warm['w8_matmul']!r} ms; kernel D then #11 cold {cold['quantize+w8_matmul']!r} / "
        f"warm {warm['quantize+w8_matmul']!r} ms; plain {plain!r} ms, {bound_note(t)} [{tag}]")
    return t


def w8a8_kernels(gen, tag: str):
    """Phase 3-4c: kernel D on wide rows and kernels #4, #11 and #13 against
    their plain versions on the card, then each one's device time beside its
    plain version's and its bound (and #11's beside the int32 product of
    ``torch._int_mm`` alone, where its shape rules allow; #11's GEMV, both
    entries, beside kernel D then #11; #13's beside kernel C's at the same
    shape). Tolerances: D and #11 bit-identical (the quantizing GEMV to
    ``quantize_plain`` then ``w8_matmul_plain``); #4 one step on <= 0.1 %,
    scales within 1e-6; #13 kernel C's bound."""
    dev = torch.device("cuda")
    errs = {"quantize": [], "gelu_quantize": [], "w8_matmul": [], "w8_matmul[gemv]": [],
            "int8_matmul": [], "int8_matmul[gemv]": []}
    times = {name: [] for name in errs}
    for shape in WIDE_ROWS:
        y = (torch.randn(shape, generator=gen, device=dev) * 3).bfloat16()
        got, want = quantize(y), quantize_plain(y)
        torch.cuda.synchronize()
        ok = torch.equal(got.x8, want.x8) and torch.equal(got.xscale, want.xscale)
        log(f"  quantize {shape} (wide rows): bit-identical to its plain version: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"quantize {shape} disagrees with its plain version")
        errs["quantize"].append(0.0)
        ms, plain = device_ms(lambda: quantize(y)), device_ms(lambda: quantize_plain(y))
        t = timing("quantize", shape, ms, plain)
        log(f"  quantize {shape}: kernel {ms!r} ms ({y.numel() * 3 / ms / 1e9!r} TB/s), "
            f"plain {plain!r} ms, {bound_note(t)} [{tag}]")
        times["quantize"].append(t)
    for shape in GELU_SHAPES + GELU_RAGGED:
        y = (torch.randn(shape, generator=gen, device=dev) * 2).bfloat16()
        got, want = gelu_quantize(y), gelu_quantize_plain(y)
        torch.cuda.synchronize()
        worst, share = int8_flips(got.x8, want.x8)
        srel = ((got.xscale - want.xscale).abs() / want.xscale).max().item()
        ok = worst <= 1 and share <= 1e-3 and srel <= 1e-6
        log(f"  gelu_quantize {shape}: y8 max step {worst} on {share!r} of the elements "
            f"(<= 1 on <= 0.001), scales max rel {srel!r} (<= 1e-6): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"gelu_quantize {shape} disagrees with its plain version")
        errs["gelu_quantize"].append(float(worst))
        if shape in GELU_SHAPES:
            warm = device_ms(lambda: gelu_quantize(y))
            plain = device_ms(lambda: gelu_quantize_plain(y))
            times["gelu_quantize"].append(rows_timing("gelu_quantize", shape, warm, plain, tag))
    for shape in W8_SHAPES + W8_RAGGED + W8_GEMV_ROWS:
        m, k, n = shape
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        xs = (torch.rand(m, 1, generator=gen, device=dev) + 0.5) / (127 * k**0.5)
        ws = (torch.rand(n, generator=gen, device=dev) + 0.5) / 127
        b = (0.1 * torch.randn(n, generator=gen, device=dev)).bfloat16()
        args = (x8, w8, ws, xs, b)
        got, want = w8_matmul(*args), w8_matmul_plain(*args)
        torch.cuda.synchronize()
        ok = got.dtype == torch.bfloat16 and torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        log(f"  w8_matmul (M, K, N) {shape}: bit-identical to its plain version: "
            f"{'ok' if ok else 'FAIL'} (max_abs_err {err!r})")
        if not ok:
            raise AssertionError(f"w8_matmul {shape} disagrees with its plain version")
        gemv = m <= 16
        if gemv:
            x = (2 * torch.randn(m, k, generator=gen, device=dev)).bfloat16()
            aq = quantize_plain(x)
            fused = quantize_w8_matmul(x, w8, ws, b)
            torch.cuda.synchronize()
            fwant = w8_matmul_plain(aq.x8, w8, ws, aq.xscale, b)
            ok = torch.equal(fused, fwant) and torch.equal(
                quantize_w8_matmul_plain(x, w8, ws, b), fwant)
            log(f"  quantize_w8_matmul (M, K, N) {shape}: bit-identical to quantize_plain then "
                f"w8_matmul_plain: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"quantize_w8_matmul {shape} disagrees with its plain version")
        errs["w8_matmul[gemv]" if gemv else "w8_matmul"].append(err)
        if shape in W8_SHAPES and gemv:
            times["w8_matmul[gemv]"].append(w8_gemv_timing(shape, x, args, tag))
        elif shape in W8_SHAPES:
            ms = device_ms(lambda: w8_matmul(*args))
            plain = device_ms(lambda: w8_matmul_plain(*args), reps=5)
            w8t = w8.t()
            int_mm = device_ms(lambda: torch._int_mm(x8, w8t)) if m > 16 else None
            t = timing("w8_matmul", shape, ms, plain, int32_product_only_ms=int_mm)
            ratio = f" (kernel at {ms / int_mm!r}x its time)" if int_mm else ""
            log(f"  w8_matmul (M, K, N) {shape}: kernel {ms!r} ms "
                f"({2 * m * k * n / (ms / 1e3) / 1e12!r} TOP/s, {n * k / ms / 1e9!r} TB/s of w8), "
                f"plain {plain!r} ms, torch._int_mm's int32 product alone {int_mm!r} ms{ratio}, "
                f"{bound_note(t)} [{tag}]")
            times["w8_matmul"].append(t)
        del args, x8, w8, got, want
    for shape in INT8_SHAPES + INT8_RAGGED:
        m, k, n, group = shape
        q8 = torch.randint(0, 256, (k, n), generator=gen, device=dev, dtype=torch.uint8)
        sc = (torch.rand(k // group, n, generator=gen, device=dev) + 0.5) * (2 / 255 / k**0.5)
        zr = -(torch.rand(k // group, n, generator=gen, device=dev) + 0.5) / k**0.5
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        got = int8_matmul(x, q8, sc, zr)
        torch.cuda.synchronize()
        w = dequantize_int8(q8, sc, zr, torch.bfloat16).float()
        want = x.float() @ w
        bnd = bf16_ulp(want) + 2 * k * 2.0**-24 * (x.float().abs() @ w.abs())
        diff = (got.float() - want).abs()
        err, ratio = diff.max().item(), (diff / bnd).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        log(f"  int8_matmul (M, K, N, group) {shape}: max_abs_err {err!r}; tolerance one bf16 "
            f"ulp + 2K 2^-24 (|x|@|w|) per element, worst element at {ratio!r} of it: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"int8_matmul {shape} disagrees")
        name = "int8_matmul[gemv]" if m <= 16 else "int8_matmul"
        errs[name].append(err)
        del w, want, bnd, diff
        if shape in INT8_SHAPES:
            ms = device_ms(lambda: int8_matmul(x, q8, sc, zr))
            plain = device_ms(lambda: int8_matmul_plain(x, q8, sc, zr))
            _, q4, s4, z4 = random_int4(shape, gen)
            c_ms = device_ms(lambda: int4_matmul(x, q4, s4, z4))
            if m <= 16:
                times[name].append(gemv_timing(name, shape, ms, plain, k * n + 8 * n * (k // group),
                                               tag, int4_matmul_ms=c_ms))
                torch.cuda.empty_cache()
                continue
            t = timing("int8_matmul", shape, ms, plain, int4_matmul_ms=c_ms)
            log(f"  int8_matmul (M, K, N, group) {shape}: kernel {ms!r} ms "
                f"({2 * m * k * n / (ms / 1e3) / 1e12!r} TFLOP/s, "
                f"{k * n / ms / 1e9!r} TB/s of q8), "
                f"plain {plain!r} ms, kernel C at this shape {c_ms!r} ms, {bound_note(t)} [{tag}]")
            times["int8_matmul"].append(t)
        torch.cuda.empty_cache()
    return errs, times


# #14 at path g's one-rank ring call (FLUX.1-schnell 2048²: 16384 image +
# 256 text tokens), at a four-rank chunk of the same sequence; at d=64 SD3
# 512² CFG's four-rank chunk (1178 tokens padded to 1180), SD3 1024² CFG's
# (4250 tokens padded to 4252) and path h's one-rank ring call: (B, H, Sq,
# Skv, D) and the valid lengths checked and timed at each.
STATS_SHAPES = [((1, 24, 16640, 16640, 128), (16640,)),
                ((1, 24, 4160, 4160, 128), (4160, 1000, 0)),
                ((2, 24, 295, 295, 64), (295, 293, 0)),
                ((2, 24, 1063, 1063, 64), (1063, 1061)),
                ((2, 24, 4250, 4250, 64), (4250,))]
# #15 in (B, H, S, D): SD3's joint attention, the VAE mid-block at 512²,
# FLUX's joint attention at 1024² and the VAE mid-block at 1024² (path a'
# runs the first two).
BHSD_SHAPES = [(2, 24, 1178, 64), (1, 1, 4096, 512), (1, 24, 4352, 128), (1, 1, 16384, 512)]
# A plain version whose fp32 scores over all heads would exceed this runs
# head by head (16640 tokens x 24 heads: 26.6 GB).
PLAIN_SCORE_BYTES = 4 << 30
# The ring whose arithmetic phase 3-4d runs chunk by chunk on one card, and
# the (B, H, S, D) sequences it splits: FLUX 2048², SD3 512² CFG and SD3
# 1024² CFG.
RING_N = 4
COMBINE_SHAPES = [(1, 24, 16640, 128), (2, 24, 1178, 64), (2, 24, 4250, 64)]


def stats_plain_by_heads(q, k, v, scale: float, vlen: int):
    """#14's plain version on all heads at once, or head by head (outputs
    joined on the head axis) where the scores would exceed
    PLAIN_SCORE_BYTES."""
    b, h, sq, _ = q.shape
    if 4 * b * h * sq * k.shape[2] <= PLAIN_SCORE_BYTES:
        return flash_attention_stats_plain(q, k, v, scale, vlen)
    parts = [flash_attention_stats_plain(q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1], scale, vlen)
             for i in range(h)]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def check_stats(got, want, label: str) -> float:
    """#14 against its plain version on fp32 upcasts: o within 2^-8 max|o| +
    1e-6 (P rounded to bf16 at other running maxima), m within 1e-5 and l
    within 1e-4 relative (fp32 sums in another order); with no valid key
    exactly o = 0, l = 0, m = -1e30. Returns o's max abs error."""
    o, m, l = got
    finite = all(bool(torch.isfinite(t).all()) for t in (o, l))
    if want is None:
        ok = finite and bool((o == 0).all() and (l == 0).all() and (m == NEG_INF).all())
        log(f"  flash_attention_stats {label}: no valid key, exactly o = 0, l = 0, m = -1e30: "
            f"{'ok' if ok else 'FAIL'}")
        err = 0.0
    else:
        ow, mw, lw = want
        err = (o - ow).abs().max().item()
        ratios = [((o - ow).abs() / (2.0**-8 * ow.abs().max() + 1e-6)).max().item(),
                  ((m - mw).abs() / (1e-5 * mw.abs() + 1e-6)).max().item(),
                  ((l - lw).abs() / (1e-4 * lw)).max().item()]
        ok = finite and max(ratios) <= 1
        log(f"  flash_attention_stats {label}: o max_abs_err {err!r} (max |o| "
            f"{ow.abs().max().item()!r}), worst element of o, m, l at {ratios!r} of "
            f"2^-8 max|o| + 1e-6, 1e-5 |m| + 1e-6, 1e-4 l: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention_stats {label} disagrees with its plain version")
    return err


def bhsd_kernels(gen, tag: str):
    """Phase 3-4d: #15 and #14 against their plain versions on fp32 upcasts
    of the same bf16 inputs, then each one's device time beside its plain
    version's, its bound and a yardstick: F.scaled_dot_product_attention
    on the same (B, H, S, D) tensors, #15's function (its library_ms); for
    #14, which no single PyTorch call computes, the same call's time on its
    q/k/v at vlen = Skv, the attention-work yardstick."""
    dev = torch.device("cuda")
    errs = {"flash_attention": [], "flash_attention_stats": []}
    times = {name: [] for name in errs}
    for shape in BHSD_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        scale = shape[-1] ** -0.5
        got = flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        want = flash_attention_plain(q.float(), k.float(), v.float(), scale)
        diff = (got.float() - want).abs()
        bnd = bf16_ulp(want) + FLASH_SLACK * want.abs().max()
        err, ratio = diff.max().item(), (diff / bnd).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        log(f"  flash_attention (B, H, S, D) {shape}: max_abs_err {err!r}, max |want| "
            f"{want.abs().max().item()!r}; tolerance one bf16 ulp + 2^-8 max|want| per element, "
            f"worst element at {ratio!r} of it: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention {shape} disagrees")
        errs["flash_attention"].append(err)
        del got, want, diff
        ms = device_ms(lambda: flash_attention(q, k, v, scale))
        plain = device_ms(lambda: flash_attention_plain(q, k, v, scale), reps=5)
        lib = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        b, h, s_, d = shape
        t = timing("flash_attention", shape, ms, plain, library_ms=lib)
        log(f"  flash_attention (B, H, S, D) {shape}: kernel {ms!r} ms "
            f"({4 * b * h * s_ * s_ * d / (ms / 1e3) / 1e12!r} TFLOP/s), plain {plain!r} ms, "
            f"F.scaled_dot_product_attention {lib!r} ms (kernel at {ms / lib!r}x its time), "
            f"{bound_note(t)} [{tag}]")
        times["flash_attention"].append(t)
        torch.cuda.empty_cache()
    for (b, h, sq, skv, d), vlens in STATS_SHAPES:
        q = torch.randn(b, h, sq, d, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(b, h, skv, d, generator=gen, device=dev).bfloat16() for _ in range(2))
        scale = d**-0.5
        for vlen in vlens:
            label = f"(B, H, Sq, Skv, D) {(b, h, sq, skv, d)} vlen {vlen}"
            got = flash_attention_stats(q, k, v, scale, vlen)
            torch.cuda.synchronize()
            want = None if vlen == 0 else stats_plain_by_heads(
                q.float(), k.float(), v.float(), scale, vlen)
            errs["flash_attention_stats"].append(check_stats(got, want, label))
            del got, want
            torch.cuda.empty_cache()
            big = 4 * b * h * sq * skv > PLAIN_SCORE_BYTES
            ms = device_ms(lambda: flash_attention_stats(q, k, v, scale, vlen))
            plain = device_ms(lambda: stats_plain_by_heads(q, k, v, scale, vlen),
                              reps=1 if big else 5)
            extra = {}
            if vlen == skv:
                extra["sdpa_yardstick_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            t = timing("flash_attention_stats", (b, h, sq, skv, d, vlen), ms, plain,
                       library_ms=None, **extra)
            rate = 4 * b * h * sq * vlen * d / (ms / 1e3) / 1e12
            sdpa = extra.get("sdpa_yardstick_ms")
            ratio = f", kernel at {ms / sdpa!r}x its time" if sdpa else ""
            log(f"  flash_attention_stats {label}: kernel {ms!r} ms ({rate!r} TFLOP/s), plain "
                f"{plain!r} ms{' (head by head)' if big else ''}, no single PyTorch call "
                f"(attention-work yardstick, F.scaled_dot_product_attention on the same q/k/v: "
                f"{sdpa!r} ms{ratio}), {bound_note(t)} [{tag}]")
            times["flash_attention_stats"].append(t)
            torch.cuda.empty_cache()
        del q, k, v
    return errs, times


def ring_combine_checks(gen) -> None:
    """Phase 3-4d: the RING_N-rank ring's arithmetic on one card, the only
    check of #14's m and l across chunks. Each rank's query slice against
    every key chunk in the ring's rotation order, with the ring's
    vlen_local, through #14, merged by merge_chunk_stats; the joined output
    against kernel B over the whole sequence, within kernel B's bound."""
    for shape in COMBINE_SHAPES:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        scale = d**-0.5
        want = flash_attention_bshd(*(t.transpose(1, 2) for t in (q, k, v)), scale)
        want = want.transpose(1, 2).float()
        pad = (-s) % RING_N
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        s_local = (s + pad) // RING_N
        outs, vlens = [], []
        for me in range(RING_N):
            rows = slice(me * s_local, (me + 1) * s_local)
            m = torch.full((b, h, s_local, 1), NEG_INF, device="cuda")
            l, acc = torch.zeros_like(m), torch.zeros(b, h, s_local, d, device="cuda")
            for step in range(RING_N):
                src = (me - step) % RING_N
                cols = slice(src * s_local, (src + 1) * s_local)
                vlen = min(max(s - src * s_local, 0), s_local)
                vlens.append(vlen)
                m, l, acc = merge_chunk_stats(m, l, acc, *flash_attention_stats(
                    q[:, :, rows], k[:, :, cols], v[:, :, cols], scale, vlen))
            outs.append((acc / l.clamp_min(1e-30)).bfloat16())
        got = torch.cat(outs, dim=2)[:, :, :s].float()
        diff = (got - want).abs()
        ratio = (diff / (bf16_ulp(want) + FLASH_SLACK * want.abs().max())).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        log(f"  {RING_N}-rank ring on one card, (B, H, S, D) {shape}: {RING_N}x{RING_N} #14 chunks "
            f"(vlen_local {sorted(set(vlens))}) merged, against kernel B over the whole sequence: "
            f"max_abs_err {diff.max().item()!r}, worst element at {ratio!r} of one bf16 ulp + "
            f"2^-8 max|out|: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the chunk-by-chunk ring at {shape} disagrees with kernel B")
        del q, k, v, want, got, diff, outs
        torch.cuda.empty_cache()


# #14 in fp32 at SD3 512² CFG's four-rank chunk and at a FLUX 2048²
# four-rank chunk: (B, H, Sq, Skv, D) and the valid lengths checked and timed.
FP32_STATS_SHAPES = [((2, 24, 295, 295, 64), (295, 293)), ((1, 24, 4160, 4160, 128), (4160,))]
# Kernel B's fp32 form at the VAE encoder's mid-block of a 1024² img2img
# request (path m: one head of 512 over 16384 positions), checked against
# its plain version PLAIN_ROWS query rows at a time.
FP32_VAE_1024 = (1, 16384, 1, 512)


def check_fp32(got, want, label: str) -> float:
    """An fp32 flash result (a tensor or #14's (o, m, l)) against its fp32
    plain version within FP32_FLASH_SLACK of each output's largest
    magnitude; returns the largest abs error."""
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    ratios = [((g - w).abs().max() / (FP32_FLASH_SLACK * w.abs().max())).item() for g, w in pairs]
    ok = max(ratios) <= 1 and all(bool(torch.isfinite(g).all()) for g, _ in pairs)
    err = max((g - w).abs().max().item() for g, w in pairs)
    log(f"  {label} fp32: max_abs_err {err!r}, worst element at {ratios!r} of 2^-16 of the "
        f"largest |output| (o{', m, l' if len(pairs) > 1 else ''}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} in fp32 disagrees with its fp32 plain version")
    return err


def fp32_flash_kernels(gen, tag: str):
    """Phase 3-4d, fp32: kernel B and #15 at FLASH_SHAPES and #14 at
    FP32_STATS_SHAPES on fp32 inputs, each counted as a launch of its
    kernel, against its fp32 plain version on the card (TF32 off), then
    timed beside its plain version and F.scaled_dot_product_attention on the
    same fp32 tensors (#14: at vlen = Skv, the attention-work yardstick)."""
    dev = torch.device("cuda")
    errs = {name: [] for name in FLASH_KERNELS}
    times = {name: [] for name in FLASH_KERNELS}
    for shape in FP32_FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
        scale = shape[-1] ** -0.5
        b, s_, h, d = shape
        for name, fn, plain_fn, args in (
                ("flash_attention_bshd", flash_attention_bshd, flash_attention_bshd_plain,
                 (q, k, v)),
                ("flash_attention", flash_attention, flash_attention_plain,
                 tuple(t.transpose(1, 2).contiguous() for t in (q, k, v)))):
            before = fn.launches
            got = fn(*args, scale)
            torch.cuda.synchronize()
            if fn.launches != before + 1:
                raise AssertionError(f"{name} fp32 did not launch its kernel")
            errs[name].append(check_fp32(got, plain_fn(*args, scale),
                                         f"{name} {tuple(args[0].shape)}"))
            del got
            ms = device_ms(lambda: fn(*args, scale))
            plain = device_ms(lambda: plain_fn(*args, scale), reps=5)
            lib_args = args if name == "flash_attention" else tuple(t.transpose(1, 2) for t in args)
            lib = device_ms(lambda: F.scaled_dot_product_attention(*lib_args, scale=scale))
            t = timing(name, tuple(args[0].shape), ms, plain, "fp32", library_ms=lib)
            log(f"  {name} {tuple(args[0].shape)} fp32: kernel {ms!r} ms "
                f"({4 * b * h * s_ * s_ * d / (ms / 1e3) / 1e12!r} TFLOP/s), plain {plain!r} ms, "
                f"F.scaled_dot_product_attention (fp32, TF32 off) {lib!r} ms, {bound_note(t)} "
                f"[{tag}]")
            times[name].append(t)
        del q, k, v, args, lib_args
        torch.cuda.empty_cache()
    err, t = fp32_vae_1024(gen, tag)
    errs["flash_attention_bshd"].append(err)
    times["flash_attention_bshd"].append(t)
    name = "flash_attention_stats"
    for (b, h, sq, skv, d), vlens in FP32_STATS_SHAPES:
        q = torch.randn(b, h, sq, d, generator=gen, device=dev)
        k, v = (torch.randn(b, h, skv, d, generator=gen, device=dev) for _ in range(2))
        scale = d**-0.5
        for vlen in vlens:
            label = f"{name} (B, H, Sq, Skv, D) {(b, h, sq, skv, d)} vlen {vlen}"
            before = flash_attention_stats.launches
            got = flash_attention_stats(q, k, v, scale, vlen)
            torch.cuda.synchronize()
            if flash_attention_stats.launches != before + 1:
                raise AssertionError(f"{name} fp32 did not launch its kernel")
            errs[name].append(check_fp32(got, flash_attention_stats_plain(q, k, v, scale, vlen),
                                         label))
            del got
            ms = device_ms(lambda: flash_attention_stats(q, k, v, scale, vlen))
            plain = device_ms(lambda: flash_attention_stats_plain(q, k, v, scale, vlen), reps=5)
            extra = {}
            if vlen == skv:
                extra["sdpa_yardstick_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            t = timing(name, (b, h, sq, skv, d, vlen), ms, plain, "fp32", library_ms=None, **extra)
            log(f"  {label} fp32: kernel {ms!r} ms "
                f"({4 * b * h * sq * vlen * d / (ms / 1e3) / 1e12!r} TFLOP/s), plain {plain!r} ms, "
                f"no single PyTorch call (F.scaled_dot_product_attention on the same fp32 q/k/v: "
                f"{extra.get('sdpa_yardstick_ms')!r} ms), {bound_note(t)} [{tag}]")
            times[name].append(t)
        del q, k, v
        torch.cuda.empty_cache()
    return errs, times


def fp32_vae_1024(gen, tag: str):
    """Phase 3-4d, fp32: kernel B at FP32_VAE_1024, counted as one launch,
    against its fp32 plain version PLAIN_ROWS query rows at a time against
    every key (TF32 off), within 2^-16 of the largest |output|; then timed
    beside its plain version on the whole shape and
    F.scaled_dot_product_attention on the same fp32 tensors. Returns (max
    abs error, the timing row)."""
    b, s_, h, d = FP32_VAE_1024
    q, k, v = (torch.randn(FP32_VAE_1024, generator=gen, device="cuda") for _ in range(3))
    scale = d**-0.5
    before = flash_attention_bshd.launches
    got = flash_attention_bshd(q, k, v, scale)
    torch.cuda.synchronize()
    if flash_attention_bshd.launches != before + 1:
        raise AssertionError("flash_attention_bshd fp32 did not launch its kernel")
    want = torch.cat([flash_attention_bshd_plain(q[:, r:r + PLAIN_ROWS], k, v, scale)
                      for r in range(0, s_, PLAIN_ROWS)], dim=1)
    err = check_fp32(got, want, f"flash_attention_bshd {FP32_VAE_1024} ({PLAIN_ROWS} query rows "
                                f"at a time)")
    del got, want
    torch.cuda.empty_cache()
    ms = device_ms(lambda: flash_attention_bshd(q, k, v, scale))
    plain = device_ms(lambda: flash_attention_bshd_plain(q, k, v, scale), reps=2)
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
    lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), reps=2)
    t = timing("flash_attention_bshd", FP32_VAE_1024, ms, plain, "fp32", library_ms=lib)
    log(f"  flash_attention_bshd {FP32_VAE_1024} fp32: kernel {ms!r} ms "
        f"({4 * b * h * s_ * s_ * d / (ms / 1e3) / 1e12!r} TFLOP/s), plain {plain!r} ms, "
        f"F.scaled_dot_product_attention (fp32, TF32 off) {lib!r} ms, {bound_note(t)} [{tag}]")
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return err, t


# (K, N, group) of #10: FLUX fc1, fc2 and q/k/v/o at group 64, and q/k/v/o
# at the quantize-at-load group 32. Timed cold (one call on each of enough
# weight copies to pass 100 MB, the number held against the bound: the path
# reads each layer's words once a step) and warm.
DEQUANT_SHAPES = [(3072, 12288, 64), (12288, 3072, 64), (3072, 3072, 64), (3072, 3072, 32)]
# #10 then #11 against kernel E's Hopper loop on FLUX fc1's layer, at the
# unified blocks' 4352 rows and a ragged M.
MATERIALIZED_M = (4352, 77)
# (M, K, N) of #16: the microbench's default (timed), M = 1 (timed) and a
# ragged M (checked, not timed).
INT8_DOT_SHAPES = [(4352, 3072, 12288), (1, 3072, 12288)]
INT8_DOT_RAGGED = [(77, 3072, 12288)]


def w8_tool_kernels(gen, tag: str):
    """Phase 3-4e: #10 and #16 against their plain versions on the card
    (bit-identical), #10 then #11 against kernel E, and each one's device
    time beside its plain version's and its bound (#16 beside
    torch._int_mm, which computes the same function)."""
    dev = torch.device("cuda")
    errs = {"dequant_w8": [], "int8_dot": []}
    times = {name: [] for name in errs}
    for shape in DEQUANT_SHAPES:
        k, n, group = shape
        layer = random_w4a8(k, n, group, gen)
        s8, z8 = scaled_affine(layer.scales, layer.zeros, layer.wscale)
        got, want = dequant_w8(layer.q4, s8, z8), dequant_w8_plain(layer.q4, s8, z8)
        torch.cuda.synchronize()
        ok = got.shape == (n, k) and torch.equal(got, want)
        log(f"  dequant_w8 (K, N, group) {shape}: (N, K) grid bit-identical to its plain "
            f"version: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"dequant_w8 {shape} disagrees with its plain version")
        errs["dequant_w8"].append(0.0)
        if shape == DEQUANT_SHAPES[0]:
            bias = layer.bias
            for m in MATERIALIZED_M:
                x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
                xs = (torch.rand(m, 1, generator=gen, device=dev) + 0.5) / (127 * k**0.5)
                args = (x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, bias)
                fused = w4a8_matmul(*args, _route="sm90")
                fused_plain = w4a8_matmul_plain(*args)
                mat = w8_matmul(x8, got, layer.wscale, xs, bias)
                torch.cuda.synchronize()
                ok = torch.equal(mat, fused) and torch.equal(mat, fused_plain)
                log(f"  dequant_w8 then w8_matmul, M {m} on (K, N, group) {shape}: bit-identical "
                    f"to kernel E (plain) and to its plain version: {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"#10 then #11 at M {m} disagrees with kernel E")
                del x8, xs, args, fused, fused_plain, mat
        warm = device_ms(lambda: dequant_w8(layer.q4, s8, z8))
        plain = device_ms(lambda: dequant_w8_plain(layer.q4, s8, z8), reps=5)
        copies = -(-int(COLD_BYTES) // bench_mat.weight_bytes("dequant", shape)) + 1
        fns = bench_mat.calls("dequant", shape, copies, torch.Generator(device="cuda").manual_seed(3),
                              dev)["dequant_w8"]
        ms = device_ms_cold(fns)
        del fns
        t = timing("dequant_w8", shape, ms, plain, library_ms=None, warm_ms=warm,
                   cold_copies=copies)
        moved = bench_mat.moved_bytes("dequant", shape)
        log(f"  dequant_w8 (K, N, group) {shape}: kernel cold {ms!r} ms ({moved / ms / 1e9!r} "
            f"TB/s; {copies} weight copies), warm {warm!r} ms ({moved / warm / 1e9!r} TB/s), "
            f"plain {plain!r} ms, no single PyTorch call, {bound_note(t)} [{tag}]")
        times["dequant_w8"].append(t)
        del layer, got, want
        torch.cuda.empty_cache()
    for shape in INT8_DOT_SHAPES + INT8_DOT_RAGGED:
        m, k, n = shape
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        got, want = int8_dot(x8, w8), int8_dot_plain(x8, w8)
        torch.cuda.synchronize()
        ok = got.dtype == torch.int32 and torch.equal(got, want)
        log(f"  int8_dot (M, K, N) {shape}: bit-identical to the exact int32 product: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"int8_dot {shape} disagrees with its plain version")
        errs["int8_dot"].append(0.0)
        del got, want
        if shape in INT8_DOT_SHAPES:
            ms = device_ms(lambda: int8_dot(x8, w8))
            plain = device_ms(lambda: int8_dot_plain(x8, w8), reps=5)
            w8t = w8.t()
            lib = device_ms(lambda: torch._int_mm(x8, w8t)) if m > 16 else None
            t = timing("int8_dot", shape, ms, plain, library_ms=lib)
            lib_note = (f" ({2 * m * k * n / (lib / 1e3) / 1e12!r} TOP/s; kernel at "
                        f"{ms / lib!r}x its time)" if lib else " (it takes M > 16 only)")
            log(f"  int8_dot (M, K, N) {shape}: kernel {ms!r} ms "
                f"({2 * m * k * n / (ms / 1e3) / 1e12!r} TOP/s), plain (float64) {plain!r} ms, "
                f"torch._int_mm {lib!r} ms{lib_note}, {bound_note(t)} [{tag}]")
            times["int8_dot"].append(t)
        del x8, w8
        torch.cuda.empty_cache()
    return errs, times


# -- SD3.5-large: the fp32 forms and the 19 x 128 widths ---------------------

# SD3.5-large at 1024² with CFG: 2 x 4096 image rows, 2 x 154 text rows (2 x
# 589 with T5), hidden 2432 = 19 x 128, FFN 9728 = 19 x 512, 38 heads of 64,
# `ada` 14592 (4864 in the last block's text stream), group 64.
# Kernels C and #13 in fp32 (block 35's linears; csrc/dequant_f32.cu): q/k/v/o,
# fc1 and fc2 at the image rows, q/k/v/o at the text rows, and the `ada`
# shape at M = 2 (an fp32 model's: block 35's own `ada` takes the bf16 c).
# Timed: every C shape, #13's image-row shapes and its GEMV shape.
F32_DEQUANT_SHAPES = [(8192, 2432, 2432, 64), (8192, 2432, 9728, 64), (8192, 9728, 2432, 64),
                      (308, 2432, 2432, 64), (2, 2432, 14592, 64)]
# Kernel E with block 35's fp32 bias (and fp32 output but for gelu_quant's
# int8): the `ada` GEMV with a bf16 output (its input is the bf16 c) and
# with an fp32 one, mode plain above 16 rows on #10 then #11 ("mat", fp32
# out), gelu_quant at fc1 and grouped_xs at fc2, image and text rows.
W4A8_F32_CASES = [("plain", (2, 2432, 14592, 64), torch.bfloat16),
                  ("plain", (2, 2432, 14592, 64), torch.float32),
                  ("plain", (8192, 2432, 2432, 64), torch.float32),
                  ("plain", (308, 2432, 2432, 64), torch.float32),
                  ("gelu_quant", (8192, 2432, 9728, 64), None),
                  ("gelu_quant", (308, 2432, 9728, 64), None),
                  ("grouped_xs", (8192, 9728, 2432, 64), torch.float32),
                  ("grouped_xs", (308, 9728, 2432, 64), torch.float32)]
# The 19 x 128 widths in bf16 on every kernel of the SD3.5 paths (checked;
# the first of each timed): A and A' at the image, text and T5-on text
# sites ((B, S, H), A' also in fp32, block 35's), D at the `o` inputs and
# the `ada` input (fp32 too), #4 at w8a8's FFN hidden, E by mode, #10 at
# each layer shape, #11 at M > 16 (a ragged BN = 256 edge: 2432 = 9.5 x 256)
# and at M = 2 (K = 2432: the mma.sync tile, off the GEMV's K % 256), C and
# #13 at the paths' shapes and their `ada` GEMVs.
SD35_MOD_LN = [(2, 4096, 2432), (2, 154, 2432), (2, 589, 2432)]
SD35_QUANT = [(8192, 2432), (308, 2432), (2, 2432)]
SD35_GELU = [(8192, 9728), (308, 9728)]
SD35_W4A8_SHAPES = {"plain": [(2, 2432, 14592, 64), (2, 2432, 4864, 64), (8192, 2432, 2432, 64),
                       (308, 2432, 2432, 64)],
             "gelu_quant": [(8192, 2432, 9728, 64), (308, 2432, 9728, 64)],
             "grouped_xs": [(8192, 9728, 2432, 64), (308, 9728, 2432, 64)]}
SD35_DEQUANT = [(2432, 2432, 64), (2432, 9728, 64), (9728, 2432, 64)]
SD35_W8 = [(8192, 2432, 2432), (308, 2432, 9728), (2, 2432, 14592)]
SD35_C = [(8192, 2432, 9728, 64), (8192, 2432, 2432, 64), (8192, 9728, 2432, 64),
          (308, 2432, 2432, 64), (2, 2432, 14592, 64), (2, 2432, 4864, 64)]
# Kernel B at SD3.5's joint attention, 1024² CFG: 4096 + 154 and, with T5,
# 4096 + 589 tokens, 38 heads of 64; bf16 and fp32 (block 35). The plain
# version runs 19 heads at a time (all 38 heads' fp32 scores: 6.7 GB).
SD35_FLASH = [(2, 4250, 38, 64), (2, 4685, 38, 64)]


def fp32_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 23)


def random_int8(shape, gen, dtype):
    m, k, n, group = shape
    q8 = torch.randint(0, 256, (k, n), generator=gen, device="cuda", dtype=torch.uint8)
    sc = (torch.rand(k // group, n, generator=gen, device="cuda") + 0.5) * (2 / 255 / k**0.5)
    zr = -(torch.rand(k // group, n, generator=gen, device="cuda") + 0.5) / k**0.5
    return torch.randn(m, k, generator=gen, device="cuda").to(dtype), q8, sc, zr


def check_dequant(name: str, shape, x, qw, sc, zr, got) -> float:
    """Kernel C or #13 against fp32 math on the same weights rounded to x's
    dtype: one ulp of the output dtype + 2K 2^-24 (|x| @ |w|) per element
    (the fp32 sums in another order; TF32 off). Returns the max abs error."""
    deq = dequantize_int4 if name.startswith("int4") else dequantize_int8
    w = deq(qw, sc, zr, x.dtype).float()
    want = x.float() @ w
    ulp = fp32_ulp(want) if x.dtype == torch.float32 else bf16_ulp(want)
    bnd = ulp + 2 * shape[1] * 2.0**-24 * (x.float().abs() @ w.abs())
    diff = (got.float() - want).abs()
    err, ratio = diff.max().item(), (diff / bnd).max().item()
    ok = ratio <= 1 and bool(torch.isfinite(got).all()) and got.dtype == x.dtype
    kind = "fp32" if x.dtype == torch.float32 else "bf16"
    log(f"  {name} {kind} (M, K, N, group) {shape}: max_abs_err {err!r}; tolerance one {kind} "
        f"ulp + 2K 2^-24 (|x|@|w|) per element, worst element at {ratio!r} of it: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {kind} {shape} disagrees with fp32 math")
    return err


def sd35_f32_kernels(gen, tag: str, errs: dict, times: dict) -> None:
    """Phase 3-4f, fp32: kernels C and #13 on fp32 x (csrc/dequant_f32.cu,
    counted as fp32 launches) at F32_DEQUANT_SHAPES,
    and kernel E with block 35's fp32 bias and output (W4A8_F32_CASES; mode
    plain above 16 rows on #10 then #11) against their plain versions (E:
    bit-identical in plain and grouped_xs, gelu_quant as in bf16), timed
    beside their bounds (fp32 products at the 3xTF32 rate, the FMA rate's
    bound beside it)."""
    for bits, fn, plain_fn in ((4, int4_matmul, int4_matmul_plain),
                               (8, int8_matmul, int8_matmul_plain)):
        name = fn.__name__
        for shape in F32_DEQUANT_SHAPES:
            m, k, n, group = shape
            if bits == 4:
                x, qw, sc, zr = random_int4(shape, gen)
                x = x.float()
            else:
                x, qw, sc, zr = random_int8(shape, gen, torch.float32)
            before = (fn.launches, fn.f32_launches)
            got = fn(x, qw, sc, zr)
            torch.cuda.synchronize()
            if (fn.launches, fn.f32_launches) != (before[0] + 1, before[1] + 1):
                raise AssertionError(f"{name} fp32 did not launch its fp32 kernel")
            key = f"{name}[f32]"
            errs.setdefault(key, []).append(check_dequant(name, shape, x, qw, sc, zr, got))
            del got
            if bits == 8 and m == 308:
                continue
            reps = 5 if m > 16 else 20
            ms = device_ms(lambda: fn(x, qw, sc, zr), reps=reps)
            plain = device_ms(lambda: plain_fn(x, qw, sc, zr), reps=reps)
            t = timing(f"{name}[f32]", shape, ms, plain, "fp32", library_ms=None)
            fma_ms = kernel_bound(f"{name}[f32]", shape, "fp32", fp32_peak="fp32")[0]
            log(f"  {name} fp32 (M, K, N, group) {shape}: kernel {ms!r} ms "
                f"({2 * m * k * n / (ms / 1e3) / 1e12!r} TFLOP/s), plain {plain!r} ms, "
                f"{bound_note(t)}; the FMA rate's bound {fma_ms!r} ms [{tag}]")
            times.setdefault(key, []).append(t)
            del x, qw, sc, zr
            torch.cuda.empty_cache()
    for mode, shape, out in W4A8_F32_CASES:
        args, extra = w4a8_case(mode, shape, gen)
        bias = args[6].float() + 1e-3 * torch.randn(shape[2], generator=gen, device="cuda")
        args = (*args[:6], bias)
        kw = dict(mode=mode, **({"out_dtype": out} if out is not None else {}))
        route = w4a8_route(shape[0], mode)
        before = (w4a8_matmul.f32_launches, w4a8_matmul.mat_launches)
        got = w4a8_matmul(*args, **kw)
        torch.cuda.synchronize()
        grew = (w4a8_matmul.f32_launches - before[0], w4a8_matmul.mat_launches - before[1])
        if grew != ((0, 1) if route == "mat" else (1, 0)):
            raise AssertionError(f"w4a8_matmul[{mode}] {shape}: fp32 launches {grew}")
        want = w4a8_matmul_plain(*args, **kw)
        label = (f"(M, K, N, group) {shape}, fp32 bias, {out or 'int8'} out, "
                 f"route {route}")
        if mode == "gelu_quant":
            err = check_w4a8_result(mode, got, want, label)
        else:
            ok = got.dtype == out and torch.equal(got, want)
            err = (got.float() - want.float()).abs().max().item()
            log(f"  w4a8_matmul[{mode}] {label}: bit-identical to its plain version: "
                f"{'ok' if ok else 'FAIL'} (max_abs_err {err!r})")
            if not ok:
                raise AssertionError(f"w4a8_matmul[{mode}] {label} disagrees with its plain version")
        # Mode plain's "mat" route (#10 then #11) is filed under mode plain.
        key = "w4a8_matmul[gemv]" if route == "tile" else f"w4a8_matmul[{mode}]"
        errs[key].append(err)
        del got, want
        m, k, n, group = shape
        ms = device_ms(lambda: w4a8_matmul(*args, **kw))
        plain = device_ms(lambda: w4a8_matmul_plain(*args, **kw), reps=5)
        t = timing(key, shape, ms, plain, "fp32" if out == torch.float32 else "bf16",
                   library_ms=None, bias="fp32", route=route, out=str(out or torch.int8))
        log(f"  w4a8_matmul[{mode}] {label}: {ms!r} ms ({2 * m * k * n / (ms / 1e3) / 1e12!r} "
            f"TOP/s), plain {plain!r} ms, {bound_note(t)} [{tag}]")
        times[key].append(t)
        del args, extra
        torch.cuda.empty_cache()


def sd35_width_kernels(gen, tag: str, errs: dict, times: dict) -> None:
    """Phase 3-4f: every kernel of the SD3.5 paths at the 19 x 128 widths
    against its plain version (the bounds of phases 3-4 to 3-4e), the first
    shape of each timed: A, A' (bf16 and fp32), D, #4, E by mode, #10,
    #11, C, #13 and kernel B in bf16 and fp32."""
    dev = torch.device("cuda")
    for shape in SD35_MOD_LN:
        b, s_, h = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
            vec = torch.randn(b, 6 * h, generator=gen, device=dev).to(dtype)
            sh, sc = vec[:, None, :h], vec[:, None, h : 2 * h]
            got = mod_ln(x, sh, sc)
            want = mod_ln_plain(x.float(), sh.float(), sc.float())
            ulp = bf16_ulp(want) if dtype == torch.bfloat16 else fp32_ulp(want)
            diff = (got.float() - want).abs()
            ok = bool((diff <= 0.5 * ulp + 1e-5).all())
            aq, aw = mod_ln_quantize(x, sh, sc), mod_ln_quantize_plain(x, sh, sc)
            torch.cuda.synchronize()
            worst, share = int8_flips(aq.x8, aw.x8)
            srel = ((aq.xscale - aw.xscale).abs() / aw.xscale).max().item()
            ok_q = worst <= 1 and share <= INT8_FLIP_SHARE["mod_ln_quantize"] and srel <= 1e-5
            log(f"  mod_ln {shape} {dtype}: max_abs_err {diff.max().item()!r} (half an ulp + "
                f"1e-5): {'ok' if ok else 'FAIL'}; mod_ln_quantize: x8 max step {worst} on "
                f"{share!r} (<= 1 on <= 0.01), scales max rel {srel!r}: "
                f"{'ok' if ok_q else 'FAIL'}")
            if not (ok and ok_q):
                raise AssertionError(f"mod_ln / mod_ln_quantize {shape} {dtype} disagree")
            errs["mod_ln"].append(diff.max().item())
            errs["mod_ln_quantize"].append(float(worst))
            if shape == SD35_MOD_LN[0]:
                for name, fn, pfn in (("mod_ln", mod_ln, mod_ln_plain),
                                      ("mod_ln_quantize", mod_ln_quantize, mod_ln_quantize_plain)):
                    ms, plain = device_ms(lambda: fn(x, sh, sc)), device_ms(lambda: pfn(x, sh, sc))
                    kind = "fp32" if dtype == torch.float32 else "bf16"
                    t = timing(name, shape, ms, plain, kind, library_ms=None)
                    log(f"  {name} {shape} {kind}: kernel {ms!r} ms, plain {plain!r} ms, "
                        f"{bound_note(t)} [{tag}]")
                    times[name].append(t)
    for shape in SD35_QUANT:
        for dtype in (torch.bfloat16, torch.float32):
            y = (torch.randn(shape, generator=gen, device=dev) * 3).to(dtype)
            got, want = quantize(y), quantize_plain(y)
            torch.cuda.synchronize()
            ok = torch.equal(got.x8, want.x8) and torch.equal(got.xscale, want.xscale)
            log(f"  quantize {shape} {dtype}: bit-identical: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"quantize {shape} {dtype} disagrees with its plain version")
            errs["quantize"].append(0.0)
    for shape in SD35_GELU:
        y = (torch.randn(shape, generator=gen, device=dev) * 2).bfloat16()
        got, want = gelu_quantize(y), gelu_quantize_plain(y)
        torch.cuda.synchronize()
        worst, share = int8_flips(got.x8, want.x8)
        srel = ((got.xscale - want.xscale).abs() / want.xscale).max().item()
        ok = worst <= 1 and share <= 1e-3 and srel <= 1e-6
        log(f"  gelu_quantize {shape}: x8 max step {worst} on {share!r} (<= 1 on <= 1e-3), "
            f"scales max rel {srel!r}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"gelu_quantize {shape} disagrees with its plain version")
        errs["gelu_quantize"].append(float(worst))
    for mode, shapes in SD35_W4A8_SHAPES.items():
        for shape in shapes:
            args, extra = w4a8_case(mode, shape, gen)
            route = w4a8_route(shape[0], mode)
            got = w4a8_matmul(*args, mode=mode)
            torch.cuda.synchronize()
            want = w4a8_matmul_plain(*args, mode=mode)
            key = "w4a8_matmul[gemv]" if route == "tile" else f"w4a8_matmul[{mode}]"
            errs[key].append(check_w4a8_result(mode, got, want,
                                               f"(M, K, N, group) {shape}, route {route}"))
            if route == "mat":  # and kernel E's own Hopper loop at the same shape
                e = w4a8_matmul(*args, mode=mode, _route="sm90")
                torch.cuda.synchronize()
                errs["w4a8_matmul[plain]"].append(
                    check_w4a8_result(mode, e, want, f"(M, K, N, group) {shape}, route sm90"))
                del e
            if shape == shapes[0] or (mode == "plain" and shape[0] > 16 and shape[0] == 8192):
                m, k, n, _ = shape
                ms = device_ms(lambda: w4a8_matmul(*args, mode=mode))
                plain = device_ms(lambda: w4a8_matmul_plain(*args, mode=mode), reps=5)
                t = timing(key, shape, ms, plain, library_ms=None, route=route)
                log(f"  w4a8_matmul[{mode}] (M, K, N, group) {shape} ({route}): kernel {ms!r} ms "
                    f"({2 * m * k * n / (ms / 1e3) / 1e12!r} TOP/s), plain {plain!r} ms, "
                    f"{bound_note(t)} [{tag}]")
                times[key].append(t)
            del args, extra, got, want
            torch.cuda.empty_cache()
    for k, n, g in SD35_DEQUANT:
        _, q4, sc, zr = random_int4((1, k, n, g), gen)
        s8, z8 = scaled_affine(sc, zr, torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4)
        ok = torch.equal(dequant_w8(q4, s8, z8), dequant_w8_plain(q4, s8, z8))
        log(f"  dequant_w8 (K, N, group) {(k, n, g)}: bit-identical: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"dequant_w8 {(k, n, g)} disagrees with its plain version")
        errs["dequant_w8"].append(0.0)
    for shape in SD35_W8:
        m, k, n = shape
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand(n, generator=gen, device=dev) * 1e-3
        xs = torch.rand(m, 1, generator=gen, device=dev) * 1e-2
        for out in (torch.bfloat16, torch.float32):
            b = torch.randn(n, generator=gen, device=dev).to(out)
            got = w8_matmul(x8, w8, ws, xs, b, out)
            torch.cuda.synchronize()
            ok = torch.equal(got, w8_matmul_plain(x8, w8, ws, xs, b, out))
            log(f"  w8_matmul (M, K, N) {shape} {out} out (route "
                f"{'gemv' if m <= 16 and k % 256 == 0 else 'tile' if m <= 16 else 'sm90'}): "
                f"bit-identical: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"w8_matmul {shape} {out} disagrees with its plain version")
            errs["w8_matmul"].append(0.0)
    for shape in SD35_C:
        m, k, n, group = shape
        x, q4, sc, zr = random_int4(shape, gen)
        got = int4_matmul(x, q4, sc, zr)
        torch.cuda.synchronize()
        key = "int4_matmul[gemv]" if m <= 16 else "int4_matmul"
        errs[key].append(check_dequant("int4_matmul", shape, x, q4, sc, zr, got))
        x8_, q8, s8_, z8_ = random_int8(shape, gen, torch.bfloat16)
        got8 = int8_matmul(x8_, q8, s8_, z8_)
        torch.cuda.synchronize()
        errs["int8_matmul[gemv]" if m <= 16 else "int8_matmul"].append(
            check_dequant("int8_matmul", shape, x8_, q8, s8_, z8_, got8))
        if shape in (SD35_C[0], SD35_C[4]):
            ms = device_ms(lambda: int4_matmul(x, q4, sc, zr))
            plain = device_ms(lambda: int4_matmul_plain(x, q4, sc, zr))
            if m <= 16:
                times[key].append(gemv_timing(key, shape, ms, plain,
                                              q4.numel() * 4 + 8 * n * (k // group), tag))
            else:
                t = timing("int4_matmul", shape, ms, plain)
                log(f"  int4_matmul (M, K, N, group) {shape}: kernel {ms!r} ms "
                    f"({2 * m * k * n / (ms / 1e3) / 1e12!r} TFLOP/s), plain {plain!r} ms, "
                    f"{bound_note(t)} [{tag}]")
                times[key].append(t)
        del x, q4, sc, zr, got, x8_, q8, s8_, z8_, got8
        torch.cuda.empty_cache()
    for shape in SD35_FLASH:
        b, s_, h, d = shape
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
            scale = d**-0.5
            before = flash_attention_bshd.f32_launches
            got = flash_attention_bshd(q, k, v, scale)
            torch.cuda.synchronize()
            if flash_attention_bshd.f32_launches != before + (dtype == torch.float32):
                raise AssertionError("flash_attention_bshd fp32 did not count its fp32 launch")
            want = torch.cat([flash_attention_bshd_plain(q[:, :, i:i + 19].float(),
                                                         k[:, :, i:i + 19].float(),
                                                         v[:, :, i:i + 19].float(), scale)
                              for i in range(0, h, 19)], dim=2)
            if dtype == torch.float32:
                err = check_fp32(got, want, f"flash_attention_bshd {shape}")
            else:
                diff = (got.float() - want).abs()
                bnd = bf16_ulp(want) + FLASH_SLACK * want.abs().max()
                err, ratio = diff.max().item(), (diff / bnd).max().item()
                log(f"  flash_attention_bshd {shape}: max_abs_err {err!r}, worst element at "
                    f"{ratio!r} of one bf16 ulp + 2^-8 max|want|: {'ok' if ratio <= 1 else 'FAIL'}")
                if ratio > 1:
                    raise AssertionError(f"flash_attention_bshd {shape} disagrees")
            errs["flash_attention_bshd"].append(err)
            del got, want
            ms = device_ms(lambda: flash_attention_bshd(q, k, v, scale), reps=5)
            qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
            lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), reps=5)
            kind = "fp32" if dtype == torch.float32 else "bf16"
            t = timing("flash_attention_bshd", shape, ms, None, kind, library_ms=lib,
                       plain_note="the plain version runs 19 heads at a time; not timed")
            log(f"  flash_attention_bshd {shape} {kind}: kernel {ms!r} ms "
                f"({4 * b * h * s_ * s_ * d / (ms / 1e3) / 1e12!r} TFLOP/s), "
                f"F.scaled_dot_product_attention {lib!r} ms, {bound_note(t)} [{tag}]")
            times["flash_attention_bshd"].append(t)
            del q, k, v, qh, kh, vh
            torch.cuda.empty_cache()


# Phase 3-4g: whole GPTQs of these (in, out) weights, every group step held
# against its plain version; then the group step (G, gs, N) timed at each
# group size at SD3's q/k/v (3 x 1536), those weights' widths and FLUX's
# q/k/v + fc1 (3 x 3072 + 12288).
# Phase 3-4i: C and #13 with an fp32 output at the row-parallel shapes of
# SD3-medium over two ranks: o (K 768) and fc2 (K 3072) at N 1536, at the
# 512² image rows (2048) and the text rows (308), a ragged M, and the GEMV's
# M = 2 (the y / t embedders' fc2), at the quantize-at-load group 32.
F32OUT_SHAPES = [(2048, 768, 1536, 32), (2048, 3072, 1536, 32), (308, 768, 1536, 32),
                 (308, 3072, 1536, 32), (77, 3072, 1536, 32), (2, 768, 1536, 32)]


def f32out_kernels(gen, tag: str):
    """Phase 3-4i: kernels C and #13 on bf16 x with ``out_dtype=float32``
    (the ``_f32out`` entries, counted in ``f32out_launches`` and not as fp32
    launches) at F32OUT_SHAPES: the fp32 output rounded to bf16 is the bf16
    form's output bit for bit (the same products, the last rounding left
    out), and it is within one fp32 ulp + 2K 2^-24 (|x| @ |w|) of its plain
    version on the card (the fp32 product of the bf16-rounded weights, TF32
    off); each timed beside the bf16 form, the plain version and its bound
    (the output's 4 bytes an element)."""
    errs, times = {}, {}
    for bits, fn, plain_fn in ((4, int4_matmul, int4_matmul_plain),
                               (8, int8_matmul, int8_matmul_plain)):
        key = f"{fn.__name__}[f32out]"
        errs[key], times[key] = [], []
        for shape in F32OUT_SHAPES:
            m, k, n, group = shape
            x, qw, sc, zr = (random_int4(shape, gen) if bits == 4
                             else random_int8(shape, gen, torch.bfloat16))
            before = (fn.launches, fn.f32out_launches, fn.f32_launches)
            got = fn(x, qw, sc, zr, out_dtype=torch.float32)
            torch.cuda.synchronize()
            if (fn.launches, fn.f32out_launches, fn.f32_launches) != (
                    before[0] + 1, before[1] + 1, before[2]):
                raise AssertionError(f"{key} {shape}: launch counters {before} -> "
                                     f"{(fn.launches, fn.f32out_launches, fn.f32_launches)}")
            same = torch.equal(got.bfloat16(), fn(x, qw, sc, zr))
            want = plain_fn(x, qw, sc, zr, torch.float32)
            deq = dequantize_int4 if bits == 4 else dequantize_int8
            w = deq(qw, sc, zr, torch.bfloat16).float()
            bnd = fp32_ulp(want) + 2 * k * 2.0**-24 * (x.float().abs() @ w.abs())
            diff = (got - want).abs()
            err, ratio = diff.max().item(), (diff / bnd).max().item()
            ok = (same and ratio <= 1 and got.dtype == torch.float32
                  and bool(torch.isfinite(got).all()))
            log(f"  {key} (M, K, N, group) {shape}: rounded to bf16 the bf16 form bit for bit: "
                f"{same}; max_abs_err {err!r} against the plain fp32 product, worst element at "
                f"{ratio!r} of one fp32 ulp + 2K 2^-24 (|x|@|w|): {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{key} {shape} disagrees with its plain version")
            errs[key].append(err)
            del got, want, w, bnd, diff
            reps = 20 if m <= 16 else 10
            ms = device_ms(lambda: fn(x, qw, sc, zr, out_dtype=torch.float32), reps=reps)
            bf16_ms = device_ms(lambda: fn(x, qw, sc, zr), reps=reps)
            plain = device_ms(lambda: plain_fn(x, qw, sc, zr, torch.float32), reps=reps)
            t = timing(key, shape, ms, plain, library_ms=None, bf16_out_ms=bf16_ms)
            log(f"  {key} (M, K, N, group) {shape}: {ms!r} ms "
                f"({2 * m * k * n / (ms / 1e3) / 1e12!r} TFLOP/s), the bf16 form {bf16_ms!r} ms, "
                f"plain {plain!r} ms, {bound_note(t)} [{tag}]")
            times[key].append(t)
            del x, qw, sc, zr
            torch.cuda.empty_cache()
    return errs, times


GPTQ_WEIGHTS = [(6144, 1536), (12288, 3072)]
GPTQ_STEPS = [(1, gs, n) for gs in (32, 64, 128) for n in (4608, 1536, 3072, 21504)]
# The first design's times (one thread a column; PERF.md's "XLA" row, run AB
# on an H100 80GB HBM3 at 700 W), gs 32, by N: printed in the log beside the
# new ones, kept out of the kernels line.
GPTQ_THREAD_A_COLUMN_MS = {4608: 0.02784, 1536: 0.02733, 3072: 0.02724, 21504: 0.03034}
GPTQ_CALIB_ROWS = 4096


def correlated_hessian(k: int, gen) -> torch.Tensor:
    """X^T X of GPTQ_CALIB_ROWS rows with a rank-64 shared component (fp32)."""
    x = torch.randn(GPTQ_CALIB_ROWS, k, generator=gen, device="cuda")
    x += 0.5 * torch.randn(GPTQ_CALIB_ROWS, 64, generator=gen, device="cuda") @ torch.randn(
        64, k, generator=gen, device="cuda")
    return x.t() @ x


def checked_group(counter: list):
    """``gptq_group`` that also runs its plain version on the same inputs
    and raises unless all four outputs agree bit for bit."""

    def step(w, u, qmax, out=None):
        want = gptq_group_plain(w, u, qmax)
        got = gptq_group(w, u, qmax, out)
        for a, b, label in zip(got, want, ("codes", "scales", "zeros", "err")):
            if not torch.equal(a, b):
                raise AssertionError(f"gptq_group: {label} differ from the plain version's at "
                                     f"{tuple(w.shape)} ({int((a != b).sum())} elements)")
        counter[0] += 1
        return got

    return step


@contextlib.contextmanager
def gptq_timed():
    """``ops/gptq``'s seconds by phase while inside; the dict yielded holds
    them after: ``phases`` (the device spans), ``loop`` (the group loops'
    wall on the host clock) and ``steps`` (the group kernel's launches; a
    path that resets the counts inside sets it from its own)."""
    got = {}
    gptq_ops.PHASE_SECONDS = {}
    launches = gptq_group.launches
    try:
        yield got
    finally:
        phases, gptq_ops.PHASE_SECONDS = gptq_ops.PHASE_SECONDS, None
        got["loop"] = phases.pop("loop", 0.0)
        got["phases"], got["steps"] = phases, gptq_group.launches - launches


def loop_note(timed: dict) -> str:
    """The group loops' wall time a step (host clock, the phase timer's
    events on) beside the device spans (CUDA events) of its group kernels
    and tail GEMMs a step: where the spans fill less than the wall, the
    device waited for the host's launches."""
    steps, wall, phases = timed["steps"], timed["loop"], timed["phases"]
    if not steps:
        return "no group loop"
    group, tail = phases.get("group", 0.0), phases.get("tail", 0.0)
    return (f"{steps} group launches: loop wall {wall!r} s, {1e3 * wall / steps!r} ms a step; "
            f"device spans: group {group!r} s ({1e3 * group / steps!r} ms a step), tail "
            f"{tail!r} s ({1e3 * tail / steps!r} ms a step)")


def gptq_kernel_phase(gen, tag: str):
    errs, times = {"gptq_group": []}, {"gptq_group": []}
    for k, n in GPTQ_WEIGHTS:
        w = 0.02 * torch.randn(k, n, generator=gen, device="cuda")
        H = correlated_hessian(k, gen)
        steps = [0]
        gptq_ops.gptq_quantize(w, H, 4, 32, group_step=checked_group(steps))
        if steps[0] != k // 32:
            raise AssertionError(f"gptq_group: {steps[0]} group steps checked, {k // 32} expected")
        errs["gptq_group"].append(0.0)
        # The kernel's GPTQ with the phase timer off and on (their walls'
        # difference is the timer's own cost), then the plain version's.
        walls = {}
        for label, step in (("kernel", gptq_group), ("timed", gptq_group),
                            ("plain", gptq_group_plain)):
            torch.cuda.synchronize()
            with gptq_timed() if label == "timed" else contextlib.nullcontext({}) as timed:
                t0 = time.perf_counter()
                got = gptq_ops.gptq_quantize(w, H, 4, 32, group_step=step)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            walls[label] = (wall, got, timed)
        for label in ("kernel", "timed"):
            if not all(torch.equal(a, b) for a, b in zip(walls[label][1], walls["plain"][1])):
                raise AssertionError(f"GPTQ of ({k}, {n}): the kernel's result is not the plain "
                                     "one's")
        timed, steps = walls["timed"][2], k // 32
        untimed_loop = timed["loop"] - (walls["timed"][0] - walls["kernel"][0])
        log(f"  GPTQ of a ({k}, {n}) weight: {steps} group steps each bit for bit its plain "
            f"version (codes, scales, zeros, err); whole GPTQ {walls['kernel'][0]!r} s with the "
            f"kernel ({walls['timed'][0]!r} s with the phase timer on), {walls['plain'][0]!r} s "
            f"with the plain version (the same codes); timed: {loop_note(timed)}; the loop's wall "
            f"less the timer's cost {1e3 * untimed_loop / steps!r} ms a step [{tag}]")
        del w, H, walls
        torch.cuda.empty_cache()
    # The draws past gs 32's shapes come from a generator of their own, so
    # the later phases' random models are those of earlier runs.
    own = torch.Generator(device="cuda").manual_seed(25)
    for shape in GPTQ_STEPS:
        g, gs, n = shape
        draw = gen if gs == 32 else own
        w = 0.02 * torch.randn(shape, generator=draw, device="cuda")
        u = (torch.triu(torch.rand(gs, gs, generator=draw, device="cuda"), 1) * 0.1
             + torch.eye(gs, device="cuda")).expand(g, gs, gs)
        outs = tuple(torch.empty_like(t) for t in gptq_group_plain(w, u, 15))
        want = gptq_group_plain(w, u, 15)
        got = gptq_group(w, u, 15, outs)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"gptq_group at {shape}: not its plain version's")
        ms = device_ms(lambda: gptq_group(w, u, 15, outs))
        # The plain version (gs python steps) timed at the main path's group
        # size only.
        plain = device_ms(lambda: gptq_group_plain(w, u, 15, outs)) if gs == 32 else None
        before = GPTQ_THREAD_A_COLUMN_MS.get(n) if gs == 32 else None
        t = timing("gptq_group", shape, ms, plain)
        times["gptq_group"].append(t)
        was = f" (one thread a column: {before!r} ms)" if before else ""
        vs = f"plain {plain!r} ms ({plain / ms!r}x), " if plain else ""
        log(f"  gptq_group {shape}: {ms!r} ms{was}, {vs}{bound_note(t)} [{tag}]")
    return errs, times



def tool_paths(tag: str) -> dict:
    """The two tool paths: each tool's run at the reference's default shape
    and iteration count, counters zeroed right before and read right after;
    each counter must rise by exactly the launches one run makes (the
    others stay at 0), every row must print a time, mat_pl and mat_xla must
    equal kernel and int8_dot torch._int_mm, bit for bit."""
    m, k, n = DEFAULT_SHAPE
    launches = {}
    for path, tool in TOOLS.items():
        reset_counts()
        rows = tool.run(m, k, n, DEFAULT_ITERS)
        torch.cuda.synchronize()
        launches[path] = counts()
        want = tool.launches(DEFAULT_ITERS)
        for name, got in launches[path].items():
            if got != want.get(name, 0):
                raise AssertionError(f"{path}: {name} launched {got} times in one run, expected "
                                     f"{want.get(name, 0)}")
        for r in rows:
            log(f"  {path} (M, K, N) {(m, k, n)} {r['name']}: {r['ms']!r} ms, {r['rate']!r} "
                f"{r['unit']} ({DEFAULT_ITERS} chained calls) [{tag}]")
        by = {r["name"]: r for r in rows}
        pairs = ([("mat_pl", "kernel"), ("mat_xla", "kernel")] if path == "bench-w4a8-mat"
                 else [("int8_dot", "int_mm")])
        for a, b in pairs:
            same = all(torch.equal(by[a][key], by[b][key]) for key in ("y0", "y"))
            log(f"  {path}: {a} bit-identical to {b} (first and last call): "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"{path}: {a} disagrees with {b}")
        log(f"  {path}: launches in one run {launches[path]} (exactly {want})")
        del rows, by
        torch.cuda.empty_cache()
    return launches


def fp32_cpu_mirror(model: torch.nn.Module, make) -> torch.nn.Module:
    """An fp32 copy of ``model`` on the CPU: ``make()`` builds the float
    structure, every packed or w8a8 linear of ``model`` is mirrored by a
    layer of the same form, and the weights (and scales) are loaded."""
    with torch.device("meta"):
        ref = make()
        for name, m in model.named_modules():
            if not isinstance(m, (QuantizedLinear, W8A8Linear)):
                continue
            parent, _, leaf = name.rpartition(".")
            owner = ref.get_submodule(parent) if parent else ref
            bias = m.bias is not None
            if isinstance(m, W8A8Linear):
                twin = W8A8Linear(m.in_features, m.out_features, bias=bias, dtype=torch.float32)
            else:
                twin = QuantizedLinear(m.in_features, m.out_features, m.group_size, bias=bias,
                                       dtype=torch.float32, wscale=m.wscale is not None,
                                       bits=m.bits)
            setattr(owner, leaf, twin)
    ref.to_empty(device="cpu")
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return ref.eval()


def reference_check(model, ref, inputs, want_counts: dict, label: str,
                    rtol: float = REF_RTOL) -> None:
    """Phase 5: a full-width, reduced-depth model in bf16 (or fp32) with the
    kernels on the card against the same weights in fp32 on the CPU (plain
    path), within ``rtol`` relative L2. A counter the check does not name
    must stay at 0."""
    reset_counts()
    with torch.inference_mode():
        got = model(*(t.cuda() for t in inputs)).float().cpu()
        have = counts()
        want = ref(*inputs).float()
    off = {name: (have[name], want_counts.get(name, 0)) for name in have
           if have[name] != want_counts.get(name, 0)}
    if off:
        raise AssertionError(f"{label}: launches (got, expected) {off}; all launches {have}")
    rel = ((got - want).norm() / want.norm()).item()
    log(f"  {label}: kernels on the card vs fp32 CPU: relative L2 error {rel!r} "
        f"(tolerance {rtol}), finite {bool(torch.isfinite(got).all())}, launches {have}")
    if not (rel < rtol and torch.isfinite(got).all()):
        raise AssertionError(f"{label}: the model on the card disagrees with fp32 on the CPU")


def mmdit_check(cfg, inputs, want_counts: dict, label: str, gen, quantize_bits=None,
                convert=None, rtol: float = REF_RTOL) -> None:
    """``reference_check`` of a random MMDiT drawn on the card (packed
    blocks with ``quantize_bits``), then converted in place by
    ``convert``."""
    model = init_mmdit(cfg, gen, "cuda", quantize_bits=quantize_bits)
    if convert is not None:
        convert(model)
    ref = fp32_cpu_mirror(model, lambda: MMDiT(dataclasses.replace(cfg, dtype=torch.float32)))
    reference_check(model, ref, inputs, want_counts, label, rtol)


def per_forward_sd3(depth: int, mode=None) -> dict:
    """Launches of one SD3 forward (CFG batch) with ``depth`` dual blocks,
    the last K/V-only, by quantize mode, for a float model converted whole
    (the pipelines' quantize-at-load). Float: kernel A at 4 AdaLN sites a
    block (3 in the last) and the final layer. int8 and int4 (GPTQ): the
    same, and #13 (C) for the 14 block linears of a block (11 in the last:
    its text stream has no o/fc1/fc2), the context embedder, the y/t
    embedders' four and the final ``ada`` (the x_embedder and final linear
    are below MIN_DIM), of them at M = 2 each block's two ``ada``, the y/t
    embedders' four and the final ``ada`` on the GEMV. int4-mixed: C for
    the 12 q/k/v/o/fc1/fc2 of a block (9 in the last), every block ``ada``
    on #13's GEMV (the embedders and the final layer float). w8a8 (every
    linear converted, min_dim 0): #11 for those and the x_embedder and
    final linear (14 a block, 11 in the last, 8 outside), of them at M = 2
    each block's two `ada`, the final `ada` and the y/t embedders' four on
    #11's GEMV, which quantizes their float input itself; kernel D before
    every other float input (o x2 a block, o in the last, the x_embedder
    and the context embedder); A' at every AdaLN site and the final
    layer's; #4 in each FFN. w4a8: q/k/v/o on #10 then #11 (8 a block, 7 in
    the last) and the context embedder, gelu_quant and grouped_xs per FFN,
    the M = 2 linears (a block's two ``ada``, the y/t embedders', the final
    ``ada``) on E's GEMV, kernel D before each of those and each ``o`` and
    the context embedder, A' at every block site, kernel A in the final
    layer (its linear is float). w4a8-mixed: the block linears as w4a8,
    every ``ada`` on #13's GEMV, D before each ``o`` only."""
    dual = depth - 1
    per = {"flash_attention_bshd": depth}
    if mode == "w8a8":
        gemv = 2 * depth + 5
        return {**per, "w8_matmul": 14 * dual + 19, "w8_matmul[gemv]": gemv,
                "w8_matmul[quantizing]": gemv, "quantize": 2 * dual + 3,
                "mod_ln_quantize": 4 * dual + 4, "gelu_quantize": 2 * dual + 1}
    if mode in ("w4a8", "w4a8-mixed"):
        mixed = mode == "w4a8-mixed"
        mat = 8 * dual + 7 + (0 if mixed else 1)
        per.update({"w4a8_matmul[mat]": mat, "dequant_w8": mat, "w8_matmul": mat,
                    "w4a8_matmul[gelu_quant]": 2 * dual + 1,
                    "w4a8_matmul[grouped_xs]": 2 * dual + 1,
                    "quantize": 2 * dual + 1 if mixed else 4 * dual + 9,
                    "mod_ln_quantize": 4 * dual + 3, "mod_ln": 1})
        if mixed:
            per.update({"int8_matmul": 2 * depth, "int8_matmul[gemv]": 2 * depth})
        else:
            per["w4a8_matmul[gemv]"] = 2 * depth + 5
        return per
    per["mod_ln"] = 4 * dual + 4
    if mode in ("int8", "int4"):
        name = f"{mode}_matmul"
        per[name] = 14 * dual + 17
        per[f"{name}[gemv]"] = 2 * depth + 5
    if mode == "int4-mixed":
        per.update({"int4_matmul": 12 * dual + 9, "int8_matmul": 2 * depth,
                    "int8_matmul[gemv]": 2 * depth})
    return per


def per_forward_sd35(depth: int, upcast: int, mode=None, converted: bool = False) -> dict:
    """Launches of one SD3.5 forward (CFG batch, a text stream of more than
    16 rows) with ``depth`` dual blocks, the last K/V-only, ``upcast`` of
    them fp32 (their calls also counted on the fp32 entries: ``[f32]``), by
    mode; ``converted``: a float model converted whole (its embedders and
    final layer too, as the pipelines' quantize-at-load does), else drawn
    with packed (or w8a8) block linears. Float: per_forward_sd3's. int4
    (block linears packed): kernel C for the 14 block linears of a block (11
    in the last), of them at M = 2 the two `ada` a block on the bf16 GEMV (an
    upcast block's too: c stays bf16), the 12 others of an upcast block on
    the fp32 tile. int8: the same on #13, converted as per_forward_sd3's
    int8 (the embedders' and the final ``ada``). w4a8: a block's two `ada`
    on E's GEMV (an fp32 bias in an upcast block), q/k/v/o on #10 then #11
    (8 a block, 7 in the last; fp32 out in an upcast block), gelu_quant and
    grouped_xs per FFN (an fp32 bias, grouped_xs fp32 out), D before each
    `ada` and `o` (the `o` inputs fp32), A' at every site, kernel A in the
    final layer only (its linear is float). w4a8-mixed: the same with every
    `ada` on #13's bf16 GEMV and no D before it. w8a8: #11 for the block
    linears (the `ada` on its quantizing GEMV, bf16 out; the 12 others of
    an upcast block fp32 out), D before each `o`, A' at every site, #4 per
    FFN; converted, per_forward_sd3's w8a8 (kernel A' in the final layer),
    else kernel A in the final layer; the M = 2 rows of K 2432 on D then
    #11's tile, not its quantizing GEMV (K is not a multiple of 256)."""
    dual = depth - 1
    per = {"flash_attention_bshd": depth, "flash_attention_bshd[f32]": upcast}
    if mode in ("w4a8", "w4a8-mixed"):
        mixed = mode == "w4a8-mixed"
        mat = 8 * dual + 7
        per.update({"w4a8_matmul[mat]": mat, "dequant_w8": mat,
                    "w8_matmul": mat, "w4a8_matmul[gelu_quant]": 2 * dual + 1,
                    "w4a8_matmul[grouped_xs]": 2 * dual + 1,
                    "quantize": 2 * dual + 1 if mixed else 4 * dual + 3,
                    "mod_ln_quantize": 4 * dual + 3, "mod_ln": 1,
                    "w4a8_matmul[f32]": (4 if mixed else 6) * upcast, "w8_matmul[f32]": 8 * upcast,
                    "quantize[f32]": 2 * upcast, "mod_ln_quantize[f32]": 4 * upcast})
        if mixed:
            per.update({"int8_matmul": 2 * depth, "int8_matmul[gemv]": 2 * depth})
        else:
            per["w4a8_matmul[gemv]"] = 2 * depth
        return per
    if mode == "w8a8":
        # #11's GEMV takes K a multiple of 256 (w8_route): at SD3.5's hidden
        # 2432 the M = 2 rows of K 2432 (every `ada`; converted, the y / t
        # embedders' fc2 too) take kernel D then #11's M <= 16 tile, and
        # only the embedders' fc1 (K 2048 and 256) its quantizing GEMV.
        gemv = 2 if converted else 0
        tile = 2 * depth + (3 if converted else 0)
        per.update({"w8_matmul": 14 * dual + (19 if converted else 11), "w8_matmul[gemv]": gemv,
                    "w8_matmul[quantizing]": gemv,
                    "quantize": 2 * dual + (3 if converted else 1) + tile,
                    "mod_ln_quantize": 4 * dual + (4 if converted else 3),
                    "gelu_quantize": 2 * dual + 1, "w8_matmul[f32]": 12 * upcast,
                    "quantize[f32]": 2 * upcast, "mod_ln_quantize[f32]": 4 * upcast})
        if not converted:
            per["mod_ln"] = 1
        return per
    per.update({"mod_ln": 4 * dual + 4, "mod_ln[f32]": 4 * upcast})
    if mode in ("int4", "int8"):
        name = f"{mode}_matmul"
        per.update({name: 14 * dual + (17 if converted else 11),
                    f"{name}[gemv]": 2 * depth + (5 if converted else 0),
                    f"{name}[f32]": 12 * upcast})
    return per


def reference_checks(gen) -> None:
    rs = np.random.RandomState(0)
    sd3 = dataclasses.replace(SD3_2b, depth_multimodal=2, hidden_size_override=1536)
    inputs = [torch.from_numpy(rs.randn(2, 64, 64, 16).astype(np.float32)),
              torch.from_numpy(rs.randn(2, 154, 4096).astype(np.float32)),
              torch.from_numpy(rs.randn(2, 2048).astype(np.float32)),
              torch.tensor([900.0, 900.0])]
    mmdit_check(sd3, inputs, per_forward_sd3(2),
                "SD3 MMDiT 2 blocks x hidden 1536, 512² CFG batch", gen)
    # The same in fp32 on the card: every joint attention (1178 tokens) on
    # kernel B's fp32 instantiation, kernel A in fp32.
    per = per_forward_sd3(2)
    mmdit_check(dataclasses.replace(sd3, dtype=torch.float32), inputs,
                {**per, **{f"{k}[f32]": v for k, v in per.items() if k in F32_COUNTED}},
                "SD3 MMDiT fp32 2 blocks x hidden 1536, 512² CFG batch", gen, rtol=FP32_RTOL)
    # SD3.5-large at full width (hidden 2432 = 19 x 128, 38 heads of 64), 3
    # blocks with block 1 upcast to fp32 (the reference's block 35; its
    # calls on the fp32 entries), at the same 512² CFG batch: bf16, the
    # 4-bit release's int4 (block linears drawn packed at group 64) and w4a8
    # (the same with each layer's wscale).
    sd35 = dataclasses.replace(SD3_8b, depth_multimodal=3, upcast_multimodal_blocks=(1,),
                               hidden_size_override=SD3_8b.hidden_size)
    label = "SD3.5-large MMDiT 3 blocks (block 1 fp32) x hidden 2432, 512² CFG batch"
    mmdit_check(sd35, inputs, per_forward_sd35(3, 1), label, gen)
    mmdit_check(sd35, inputs, per_forward_sd35(3, 1, "int4"), f"{label}, int4", gen,
                quantize_bits=4)
    mmdit_check(sd35, inputs, per_forward_sd35(3, 1, "w4a8"), f"{label}, w4a8", gen,
                quantize_bits=4, convert=add_wscale_)
    # Paths u, v and t's modes: int8 converted whole from a float model at
    # group 32 (the embedders' and the final ``ada`` too), w8a8 as the
    # reference's random w8a8 init draws it (block linears; see the SD3
    # w8a8 check below), w4a8-mixed from a float model on the ALS grid with
    # MIXED_OVERRIDES (every ``ada`` int8, the embedders and final layer
    # float), then each int4 layer's wscale.
    mmdit_check(sd35, inputs, per_forward_sd35(3, 1, "int8", converted=True), f"{label}, int8",
                gen, convert=lambda m: quantize_module_(m, 32, bits=8))
    mmdit_check(sd35, inputs, per_forward_sd35(3, 1, "w8a8"), f"{label}, w8a8", gen,
                quantize_bits="w8a8")
    mmdit_check(sd35, inputs, per_forward_sd35(3, 1, "w4a8-mixed"), f"{label}, w4a8-mixed",
                gen, convert=lambda m: add_wscale_(quantize_module_(m, 32,
                                                                   overrides=MIXED_OVERRIDES)))
    # SD3 w8a8 as the reference's random w8a8 init draws it (block linears
    # in w8a8; embedders and final layer float, so kernel A runs once, in
    # the final layer): per block #11 for 14 linears (11 in the last), of
    # them ada x2 on its quantizing GEMV, D before o x2 (o), A' at 4 sites
    # (3), #4 per FFN.
    # Converting every linear of a float model, as path d does, puts the
    # bf16-vs-fp32 difference at the w8a8 grid's own error (3.35e-2 in
    # bf16 vs fp32 on the CPU at this size): the int8 steps that bf16
    # rounding flips are as large as the quantization noise.
    mmdit_check(sd3, inputs, {"w8_matmul": 14 + 11, "w8_matmul[gemv]": 2 + 2,
                              "w8_matmul[quantizing]": 2 + 2, "quantize": 2 + 1,
                              "mod_ln_quantize": 4 + 3, "gelu_quantize": 2 + 1, "mod_ln": 1,
                              "flash_attention_bshd": 2},
                "SD3 w8a8 MMDiT 2 blocks x hidden 1536, 512² CFG batch", gen,
                quantize_bits="w8a8")
    # SD3 int8: a float model quantized at load on the card at group 32.
    mmdit_check(sd3, inputs, per_forward_sd3(2, "int8"),
                "SD3 int8 MMDiT 2 blocks x hidden 1536, 512² CFG batch", gen,
                convert=lambda m: quantize_module_(m, 32, bits=8))
    # 512²: 1024 image + 256 text tokens, above the flash threshold.
    flux = dataclasses.replace(FLUX_SCHNELL, depth_multimodal=1, depth_unified=2)
    inputs = [torch.from_numpy(rs.randn(1, 64, 64, 16).astype(np.float32)),
              torch.from_numpy(rs.randn(1, 256, 4096).astype(np.float32)),
              torch.from_numpy(rs.randn(1, 768).astype(np.float32)),
              torch.tensor([1000.0])]
    mmdit_check(flux, inputs, {"mod_ln": 4 + 2 + 1, "flash_attention_bshd": 3,
                               "int4_matmul": 2 * 7 + 2 * 7, "int4_matmul[gemv]": 2 + 2},
                "FLUX.1-schnell int4 MMDiT 1 dual + 2 single blocks x hidden 3072, 512²",
                gen, quantize_bits=4)
    # The same at w4a8: per dual block plain 8 (ada x2, v and o of the image
    # stream, the text stream's q/k/v/o), norm_rope 2, gelu_quant 2,
    # grouped_xs 2; per single block 3 (ada, v, o), 2, 1, 1; mode plain
    # above 16 rows on #10 then #11; kernel D before each ada and o; kernel
    # A' at each quantizing AdaLN site; kernel A in the final layer only; no
    # kernel C.
    want = per_block_w4a8(1, 2, 1024, 256)
    want.update({"mod_ln": 1, "flash_attention_bshd": 3})
    mmdit_check(flux, inputs, want,
                "FLUX.1-schnell w4a8 MMDiT 1 dual + 2 single blocks x hidden 3072, 512²",
                gen, quantize_bits=4, convert=add_wscale_)
    # T5-XXL w8a8 after SmoothQuant, 2 layers at 256 tokens: per layer 7
    # w8a8 products, kernel D once for q/k/v, once for wi_0/wi_1 and before
    # out_proj and wo (10240 wide). The weights are drawn at HF T5's
    # initialisation scales, a trained T5's magnitudes: at std 0.02
    # everywhere the unscaled attention's softmax is so sharp that bf16
    # rounding alone moves the output by 1.9 % at d_model 1024 (0.4 % at
    # these scales; both on the CPU).
    t5 = dataclasses.replace(T5_XXL, num_layers=2)
    model = init_t5(t5, gen, "cuda", dtype=torch.bfloat16)
    t5_outlier_ab.hf_init_scales_(model, gen)
    smooth_t5(model, SyntheticT5Tokenizer(max_length=256))
    w8a8_module_(model)
    ref = fp32_cpu_mirror(model, lambda: T5Encoder(t5, torch.float32))
    tokens = torch.from_numpy(rs.randint(1, t5.vocab_size, size=(1, 256)).astype(np.int64))
    reference_check(model, ref, [tokens], {"w8_matmul": 2 * 7, "quantize": 2 * 4},
                    "T5-XXL w8a8 (SmoothQuant) 2 layers x d_model 4096, d_ff 10240, 256 tokens")


@torch.no_grad()
def per_block_w4a8(dual: int, uni: int, img: int, txt: int) -> dict:
    """Launches of the w4a8 kernels in one forward of dual + uni blocks over
    img image and txt text rows (batch 1). Mode plain's calls: the `ada`
    GEMVs at M = 1 (two a dual block, one a single), v and o of the image
    stream (img rows), the text stream's q/k/v/o (txt), a single block's v
    and o (img + txt); each on its ``w4a8_route``: kernel E's GEMV, its
    Hopper loop (``w4a8_matmul[plain]``) or #10 then #11
    (``w4a8_matmul[mat]``, one launch of each)."""
    calls = ((img, 2 * dual), (txt, 4 * dual), (img + txt, 2 * uni))
    mat = sum(n for m, n in calls if w4a8_route(m, "plain") == "mat")
    return {"w4a8_matmul[plain]": 6 * dual + 2 * uni - mat, "w4a8_matmul[gemv]": 2 * dual + uni,
            "w4a8_matmul[mat]": mat, "dequant_w8": mat, "w8_matmul": mat,
            "w4a8_matmul[norm_rope]": 2 * dual + 2 * uni,
            "w4a8_matmul[gelu_quant]": 2 * dual + uni, "w4a8_matmul[grouped_xs]": 2 * dual + uni,
            "quantize": 4 * dual + 2 * uni, "mod_ln_quantize": 4 * dual + uni}


def per_request_launches(path: Path, cfg) -> dict:
    """Each kernel's launches per request, from the model config: per step
    one flash call per block, the AdaLN sites (4 a dual block with a text
    MLP, 3 in SD3's K/V-only last block, 1 a single-stream block, 1 the final
    layer), and for the int4 model the 7 block linears of each stream
    (q, k, v, o, fc1, fc2, ada); for the w4a8 model per_block_w4a8 (mode
    plain above 16 rows on #10 then #11) and kernel A in the final layer
    only; for SD3 per_forward_sd3 by mode; plus
    the VAE mid-block's attention, and with the w8a8 T5 its 7 products and
    4 quantizations a layer. Under the bhsd switch (a') every attention
    takes #15 instead of kernel B; through the ring (g, h) every joint
    attention takes #14 and kernel B runs only in the VAE. A kernel a path
    must not run has 0 (kernel C on the w4a8 paths, C, E and #13 on SD3
    w8a8, #11, C and E on SD3 int8, #14 and #15 off their paths)."""
    if path.name.startswith("sd35"):
        mode, converted = SD35_MODES.get(path.name, (None, False))
        per = {k: path.steps * v for k, v in per_forward_sd35(
            cfg.depth_multimodal, len(cfg.upcast_multimodal_blocks), mode, converted).items()}
        per["flash_attention_bshd"] += 1  # the VAE mid-block, bf16
        return per
    if path.name.startswith("sd3"):
        mode = {"sd3-w8a8": "w8a8", "sd3-int8": "int8",
                **{p.name: m for m, p in QUALITY.items()}}.get(path.name)
        per = {k: path.steps * v for k, v in per_forward_sd3(cfg.depth_multimodal, mode).items()}
        # Kernel B runs where a sequence passes FLASH_ATTN_THRESHOLD: the
        # joint attention (image + text tokens) and the VAE mid-block (the
        # latent's positions); at 256² neither does.
        if (path.latent[0] // 2) * (path.latent[1] // 2) + path.txt_tokens <= FLASH_ATTN_THRESHOLD:
            per["flash_attention_bshd"] = 0
        per["flash_attention_bshd"] += path.latent[0] * path.latent[1] > FLASH_ATTN_THRESHOLD
        if path.name == SD3_BHSD.name:
            per["flash_attention"] = per.pop("flash_attention_bshd")
        if path.name == SD3_RING.name:
            per["flash_attention_stats"] = per["flash_attention_bshd"] - 1
            per["flash_attention_bshd"] = 1
        return per
    dual, uni = cfg.depth_multimodal, cfg.depth_unified
    if path.name == FLUX_DEV_PATH.name:  # bf16: kernels A and B only
        return {"mod_ln": path.steps * (4 * dual + uni + 1),
                "flash_attention_bshd": path.steps * (dual + uni) + 1}
    if path.name == FLUX.name:
        return {"mod_ln": path.steps * (4 * dual + uni + 1),
                "flash_attention_bshd": path.steps * (dual + uni) + 1,
                "int4_matmul": path.steps * (2 * 7 * dual + 7 * uni),
                "int4_matmul[gemv]": path.steps * (2 * dual + uni)}
    img = (path.latent[0] // 2) * (path.latent[1] // 2)  # 2 x 2 latent patches a token
    per = {k: path.steps * v for k, v in per_block_w4a8(dual, uni, img, path.txt_tokens).items()}
    per.update({"mod_ln": path.steps, "int4_matmul": 0,
                "flash_attention_bshd": path.steps * (dual + uni) + 1})
    if path.name == FLUX_E2E.name:
        per["w8_matmul"] += 7 * T5_LAYERS
        per["quantize"] += 4 * T5_LAYERS
    if path.name == FLUX_RING.name:
        per["flash_attention_stats"] = path.steps * (dual + uni)
        per["flash_attention_bshd"] = 1
    return per


def check_launches(launches: dict, per: dict, n: int, label: str) -> None:
    """Each kernel's launches in ``n`` requests against ``per`` request:
    the attention kernels (EXACT) and every kernel the path must not run
    exactly, the others at least (a kernel may also run outside the
    denoiser)."""
    need = {name: n * per.get(name, 0) for name in launches}
    log(f"  launches during {label}: {launches} (needed {need}; exactly for "
        f"{', '.join(EXACT)} and the zeros)")
    for name in need:
        exact = name in EXACT or need[name] == 0
        if launches[name] < need[name] or (exact and launches[name] != need[name]):
            raise AssertionError(f"{name} launched {launches[name]} times during {label}, "
                                 f"expected {'' if exact else '>= '}{need[name]}")


def rel_l2(got, want) -> float:
    got, want = (np.asarray(t.float().cpu() if torch.is_tensor(t) else t, dtype=np.float64)
                 for t in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def build_sd3(gen, _prev) -> DiffusionPipeline:
    pipe = DiffusionPipeline(load=False, low_memory_mode=False, device="cuda", use_t5=False)
    pipe.mmdit = init_mmdit(SD3_2b, gen, "cuda")
    pipe.clip_l = init_clip(CLIP_L, gen, "cuda", dtype=torch.bfloat16)
    pipe.clip_g = init_clip(CLIP_G, gen, "cuda", dtype=torch.bfloat16)
    pipe.decoder = init_vae_decoder(VAEDecoderConfig(), gen, "cuda", dtype=torch.bfloat16)
    vocab = synthetic_clip_vocab()
    pipe.tokenizer_l = CLIPTokenizer({}, vocab, pad_with_eos=True)
    pipe.tokenizer_g = CLIPTokenizer({}, vocab, pad_with_eos=False)
    return pipe


def build_flux(gen, _prev) -> FluxPipeline:
    """FLUX.1-schnell with int4 block linears drawn packed (group 64, as the
    MLX 4-bit file), T5-XXL, CLIP-L and the VAE decoder, all in bf16."""
    pipe = FluxPipeline(load=False, low_memory_mode=False, device="cuda")
    pipe.mmdit = init_mmdit(FLUX_SCHNELL, gen, "cuda", quantize_bits=4)
    pipe.t5 = init_t5(T5_XXL, gen, "cuda", dtype=torch.bfloat16)
    pipe.clip_l = init_clip(CLIP_L, gen, "cuda", dtype=torch.bfloat16)
    pipe.decoder = init_vae_decoder(VAEDecoderConfig(), gen, "cuda", dtype=torch.bfloat16)
    pipe.tokenizer_l = CLIPTokenizer({}, synthetic_clip_vocab(), pad_with_eos=True)
    pipe.t5_tokenizer = SyntheticT5Tokenizer(max_length=256)
    return pipe


def build_sd3_quantized(mode: str):
    """Path d / e: a fresh float bf16 SD3-medium drawn on the card and given
    to DiffusionPipeline(quantize_mmdit=mode), which converts it on the
    card; the previous SD3 path's CLIP-L/G, VAE decoder and tokenizers,
    whose MMDiT is freed first."""
    form = W8A8Linear if mode == "w8a8" else QuantizedLinear

    def build(gen, prev: DiffusionPipeline) -> DiffusionPipeline:
        prev.mmdit = None
        gc.collect()
        torch.cuda.empty_cache()
        pipe = DiffusionPipeline(load=False, low_memory_mode=False,
                                 device="cuda", use_t5=False, quantize_mmdit=mode)
        for name in ("clip_l", "clip_g", "decoder", "tokenizer_l", "tokenizer_g"):
            setattr(pipe, name, getattr(prev, name))
        t0 = time.perf_counter()
        pipe.mmdit = init_mmdit(SD3_2b, gen, "cuda")
        torch.cuda.synchronize()
        blocks = pipe.mmdit.mm_blocks[0].img
        if not all(isinstance(getattr(blocks, n), form) for n in ("q", "ada", "fc1", "fc2")):
            raise AssertionError(f"quantize_mmdit={mode!r} left a block linear unconverted")
        log(f"  float SD3-medium drawn and converted to {mode} on the card in "
            f"{time.perf_counter() - t0!r} s")
        return pipe

    return build


def build_flux_e2e(gen, prev: FluxPipeline) -> FluxPipeline:
    """Path f, bench.py's flux-e2e configuration: the w4a8 path's packed
    MMDiT (with its wscale: it passes through) and FluxPipeline(
    quantize_mmdit="w4a8", quantize_t5=True), whose T5 setter smooths the
    int4 path's bf16 T5-XXL with the synthetic tokenizer's calibration
    tokens and converts it to w8a8 on the card; CLIP-L and the VAE shared.
    Both conversions are timed, as what a ``low_memory_mode`` request of
    this pipeline from float checkpoints does again each time: first a
    float bf16 FLUX.1-schnell MMDiT (drawn from its own seed) through the
    setter's w4a8 conversion, GPTQ by default, timed by phase, then freed
    (at FLUX_GPTQ_DEPTH blocks, for the smoke's time: path t runs GPTQ on
    a whole 8B model)."""
    pipe = FluxPipeline(load=False, low_memory_mode=False,
                        device="cuda", quantize_mmdit="w4a8", quantize_t5=True)
    for name in ("clip_l", "decoder", "tokenizer_l", "t5_tokenizer"):
        setattr(pipe, name, getattr(prev, name))
    cfg = dataclasses.replace(FLUX_SCHNELL, depth_multimodal=FLUX_GPTQ_DEPTH[0],
                              depth_unified=FLUX_GPTQ_DEPTH[1])
    model = init_mmdit(cfg, torch.Generator(device="cuda").manual_seed(19), "cuda")
    torch.cuda.synchronize()
    with gptq_timed() as timed:
        t0 = time.perf_counter()
        pipe.mmdit = model
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    phases = timed["phases"]
    if pipe.quantizer["name"] != "gptq":
        raise AssertionError(f"path f: the float FLUX MMDiT took {pipe.quantizer['name']}, "
                             "not GPTQ")
    block = model.mm_blocks[0].img
    if not all(isinstance(getattr(block, n), QuantizedLinear) and getattr(block, n).wscale
               is not None for n in ("q", "ada", "fc1", "fc2")):
        raise AssertionError("quantize_mmdit='w4a8' left a block linear of the float FLUX "
                             "MMDiT unconverted")
    packed = sum(isinstance(m, QuantizedLinear) for m in model.modules())
    log(f"  float FLUX.1-schnell MMDiT ({cfg.depth_multimodal} + {cfg.depth_unified} blocks) "
        f"converted to w4a8 by GPTQ on the card in {seconds!r} s "
        f"({packed} linears; by phase {phases}; {loop_note(timed)}; "
        f"the min/max grid took 1.02 s in an earlier "
        f"run on an NVIDIA H100 80GB HBM3 at 700 W)")
    del model, block
    pipe.mmdit = None
    gc.collect()
    torch.cuda.empty_cache()
    pipe.mmdit = prev.mmdit
    t0 = time.perf_counter()
    pipe.t5 = prev.t5
    torch.cuda.synchronize()
    linears = [m for m in pipe.t5.modules() if isinstance(m, (torch.nn.Linear, W8A8Linear))]
    if not all(isinstance(m, W8A8Linear) for m in linears):
        raise AssertionError("quantize_t5 left a T5 linear unconverted")
    log(f"  T5-XXL smoothed (8 calibration prompts) and converted to w8a8 on the card in "
        f"{time.perf_counter() - t0!r} s ({len(linears)} linears)")
    return pipe


def build_flux_w4a8(gen, prev: FluxPipeline) -> FluxPipeline:
    """FLUX.1-schnell w4a8: a freshly drawn packed model (group 64) given to
    FluxPipeline(quantize_mmdit="w4a8"), which passes it through and adds
    each packed linear's exact wscale on the card; the int4 path's T5-XXL,
    CLIP-L, VAE decoder and tokenizers, whose MMDiT is freed first."""
    prev.mmdit = None
    gc.collect()
    torch.cuda.empty_cache()
    pipe = FluxPipeline(load=False, low_memory_mode=False, device="cuda", quantize_mmdit="w4a8")
    for name in ("t5", "clip_l", "decoder", "tokenizer_l", "t5_tokenizer"):
        setattr(pipe, name, getattr(prev, name))
    pipe.mmdit = init_mmdit(FLUX_SCHNELL, gen, "cuda", quantize_bits=4)
    if not all(m.wscale is not None for m in pipe.mmdit.modules()
               if isinstance(m, QuantizedLinear)):
        raise AssertionError("quantize_mmdit='w4a8' left a packed linear without wscale")
    return pipe


def denoise_request(pipe, path: Path, use_scan: bool, num_steps=None, **img2img):
    """Request 0's denoise through the phase methods, under the graph
    (``use_scan=True``, the default) or the synced loop: its latents, the
    median of its ``iter_time`` in ms (under the graph the reference's
    total / n, which every entry holds; in the loop the median step) and
    the launches its denoise made (with ``img2img``'s ``image_path`` and
    ``denoise``, the encode's too)."""
    text, seed = path.requests[0]
    cond, pooled = pipe.encode_text(text, path.cfg)
    torch.cuda.synchronize()
    before = counts()
    saved, pipe.use_scan = pipe.use_scan, use_scan
    try:
        latents, it = pipe.denoise_latents(cond, pooled, num_steps=num_steps or path.steps,
                                           cfg_weight=path.cfg, latent_size=path.latent,
                                           seed=seed, **img2img)
        torch.cuda.synchronize()
    finally:
        pipe.use_scan = saved
    after = counts()
    return latents, 1e3 * statistics.median(it), {k: after[k] - before[k] for k in after}


def device_kernels(pipe, path: Path, use_scan: bool) -> collections.Counter:
    """The device kernels (by the profiler's name) of one denoise step of
    request 0, under the graph or in the loop."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        denoise_request(pipe, path, use_scan, num_steps=1)
    return profile_step.kernel_counts(prof)


def loop_beside(pipe, path: Path, graph_latents, graph_launches: dict, graph_ms: float,
                tag: str, **img2img) -> float:
    """Phase 6, the synced loop beside the graph: request 0's denoise
    through ``use_scan=False`` must give the graph's latents bit for bit
    with the graph's launches (the same kernels in the same order). On a
    difference, one step of each is profiled and the kernels that differ
    are named. Returns the loop's median ms/step."""
    latents, loop_ms, launches = denoise_request(pipe, path, use_scan=False, **img2img)
    log(f"  {path.name}: denoise {graph_ms!r} ms/step under the CUDA graph (a warm request's "
        f"total / n), median {loop_ms!r} ms/step in the synced loop (use_scan=False) [{tag}]")
    if launches != graph_launches:
        diff = {k: (graph_launches[k], launches[k]) for k in launches
                if launches[k] != graph_launches[k]}
        raise AssertionError(f"{path.name}: the loop's launches differ from the graph's "
                             f"(graph, loop): {diff}")
    if not torch.equal(latents, graph_latents):
        graph_k, loop_k = device_kernels(pipe, path, True), device_kernels(pipe, path, False)
        raise AssertionError(
            f"{path.name}: the synced loop's latents differ from the graph's (max abs "
            f"{(latents - graph_latents).abs().max().item()!r}); kernels of one step only under "
            f"the graph: {dict(graph_k - loop_k)}, only in the loop: {dict(loop_k - graph_k)}")
    log(f"  {path.name}: the synced loop's latents are the graph's bit for bit, with the same "
        f"launches")
    return loop_ms


def serve(pipe, path: Path, tag: str):
    """Phase 6: the two requests under the default (the CUDA graph), then
    the first again through the phase methods, and then through the synced
    loop (``loop_beside``). Counters are zeroed right before the requests
    and read right after the repeat."""
    kw = dict(num_steps=path.steps, cfg_weight=path.cfg, latent_size=path.latent, verbose=False)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    images, logs = [], []
    for text, seed in path.requests:
        image, phase_log = pipe.generate_image(text, seed=seed, **kw)
        images.append(np.asarray(image))
        logs.append(phase_log)
    latents, graph_ms, graph_launches = denoise_request(pipe, path, use_scan=True)
    repeat = pipe.decode_latents_to_u8(latents).cpu().numpy()[0]
    torch.cuda.synchronize()
    launches = counts()
    check_launches(launches, per_request_launches(path, pipe.mmdit.config),
                   len(path.requests) + 1, f"the {path.name} main path")

    finite = bool(torch.isfinite(latents).all())
    log(f"  latents {tuple(latents.shape)} finite: {finite}, "
        f"mean {latents.mean().item()!r}, std {latents.std().item()!r}")
    if not finite:
        raise AssertionError("non-finite latents")
    side = 8 * path.latent[0]
    for i, img in enumerate(images):
        log(f"  request {i}: image {img.shape} {img.dtype}, pixel std {img.std()!r}, "
            f"levels {len(np.unique(img))}")
        if img.shape != (side, side, 3) or img.std() == 0:
            raise AssertionError(f"request {i}: wrong shape or constant image")
    if not np.array_equal(repeat, images[0]):
        raise AssertionError("repeating the first request gave a different image")
    log("  repeat of request 0: bit-identical image")
    if len(images) > 1 and np.array_equal(images[0], images[1]):
        raise AssertionError("two different requests gave the same image")

    cfg = pipe.mmdit.config
    flops = mmdit_step_flops(cfg, path.latent, path.txt_tokens, cfg=path.cfg > 1)["total"]
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    rate, peak_name = "TFLOP/s", "bf16"
    if path.name in (FLUX_W4A8.name, FLUX_E2E.name, SD3_W8A8.name, FLUX_RING.name, SD35.name,
                     SD35_W4A8_MIXED.name, SD35_W8A8.name, FLUX_DEV_GPTQ.name):
        rate, peak_name, peak = "TOP/s", "int8", 2 * peak  # the int8 tensor cores
    for i, lg in enumerate(logs):
        it = lg["denoising"]["iter_time"]
        median_ms = 1e3 * statistics.median(it)
        tflops = flops / (median_ms / 1e3) / 1e12  # TOP/s on the int8 paths
        log(f"  request {i}: text_encoding {lg['text_encoding']['time']!r} s, "
            f"denoising {lg['denoising']['time']!r} s, decoding {lg['decoding']['time']!r} s, "
            f"total {lg['total_time']!r} s/image [{tag}]")
        log(f"  request {i}: denoise {1e3 * lg['denoising']['time']!r} ms, median "
            f"{median_ms!r} ms/step (the graph's total / n), decoding "
            f"{1e3 * lg['decoding']['time']!r} ms; {tflops!r} {rate} at the "
            f"median ({flops / 1e12!r} T ops/step), {tflops * 1e12 / peak if peak else None!r} "
            f"of the {peak / 1e12!r} {rate} {peak_name} peak [{tag}]")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak memory {peak!r} GiB [{tag}]")
    loop_ms = loop_beside(pipe, path, latents, graph_launches, graph_ms, tag)
    return {"launches": launches, "latents": latents, "image": images[0], "images": images,
            "step_ms": graph_ms, "loop_ms": loop_ms, "peak": peak}


@contextlib.contextmanager
def env_set(name: str, value: str):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name)
        else:
            os.environ[name] = saved


def serve_bhsd(pipe, ref_image, tag: str) -> dict:
    """Path a': path a's first request again, with
    DIFFUSIONKIT_TPU_ATTN_LAYOUT=bhsd set around it only; every attention
    on #15, none on kernel B; its image against a's."""
    path = SD3_BHSD
    text, seed = path.requests[0]
    with env_set(LAYOUT_ENV, "bhsd"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        image, lg = pipe.generate_image(text, seed=seed, num_steps=path.steps, cfg_weight=path.cfg,
                                        latent_size=path.latent, verbose=False)
        torch.cuda.synchronize()
        launches = counts()
        check_launches(launches, per_request_launches(path, pipe.mmdit.config), 1,
                       f"the {path.name} request")
        rel = rel_l2(np.asarray(image), ref_image)
        # The request captured the bhsd graph; its repeat is warm.
        latents, step_ms, graph_launches = denoise_request(pipe, path, use_scan=True)
        loop_ms = loop_beside(pipe, path, latents, graph_launches, step_ms, tag)
        log(f"  {path.name}: image relative L2 against path a's request 0 {rel!r} (tolerance "
            f"{TWIN_RTOL}); denoise {step_ms!r} ms/step (warm), total {lg['total_time']!r} "
            f"s/image, peak memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB [{tag}]")
        if not rel < TWIN_RTOL:
            raise AssertionError(f"{path.name}: the bhsd request's image is off path a's")
        log(f"phase 7a': where a {path.name} step's device time goes (torch.profiler)")
        families = profile_steps(pipe, path, step_ms, loop_ms, tag)
    return {"launches": launches, "families": families, "step_ms": step_ms, "loop_ms": loop_ms}


def decode_fp32(pipe, latents, tag: str) -> dict:
    """Path a'': ``latents`` decoded by DiffusionPipeline(a16=False) with an
    fp32 copy of ``pipe``'s decoder: the mid-block attention (4096
    positions, one head of 512) on kernel B's fp32 instantiation, launched
    once, nothing else counted; the fp32 output against the same latents
    decoded by the same weights in fp32 on the CPU within FP32_RTOL."""
    pipe32 = DiffusionPipeline(load=False, low_memory_mode=False,
                               device="cuda", use_t5=False, a16=False)
    pipe32.decoder = copy.deepcopy(pipe.decoder).float()
    reset_counts()
    t0 = time.perf_counter()
    pixels = pipe32.decode_latents_to_u8(latents)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    check_launches(launches, {"flash_attention_bshd": 1, "flash_attention_bshd[f32]": 1}, 1,
                   "the a16=False decode")
    side = 8 * latents.shape[1]
    if pixels.shape != (1, side, side, 3) or pixels.float().std() == 0:
        raise AssertionError("the a16=False decode gave a wrong shape or a constant image")
    with torch.inference_mode():
        got = pipe32.decoder(latents.float()).cpu()
        want = pipe32.decoder.cpu()(latents.float().cpu())
    rel = rel_l2(got, want)
    log(f"  a16=False decode: image {tuple(pixels.shape)}, fp32 output relative L2 against the "
        f"CPU's {rel!r} (tolerance {FP32_RTOL}), decoding {seconds!r} s, launches {launches} "
        f"[{tag}]")
    if not (rel < FP32_RTOL and torch.isfinite(got).all()):
        raise AssertionError("the a16=False decode on the card disagrees with fp32 on the CPU")
    return launches


def flash_twin(pipe, path: Path, twin: Path, ring_latents, ring_step_ms: float,
               tag: str) -> dict:
    """A ring path's request 0 through the default dispatch (no ring), on
    the same models (a shallow copy of ``pipe`` without ``sdpa_impl`` and
    ``mesh``): kernel B at every attention, #14 never, each kernel launched
    as on ``twin``; its latents against the ring request's."""
    plain = copy.copy(pipe)
    plain.sdpa_impl, plain.mesh = None, None
    denoise_request(plain, path, use_scan=True)  # captures the twin's graph
    reset_counts()
    latents, step_ms, graph_launches = denoise_request(plain, path, use_scan=True)
    plain.decode_latents_to_u8(latents)
    torch.cuda.synchronize()
    launches = counts()
    check_launches(launches, per_request_launches(twin, plain.mmdit.config), 1,
                   f"{path.name}'s request 0 without the ring")
    rel = rel_l2(latents, ring_latents)
    log(f"  {twin.name}: final latents relative L2 against the ring request's {rel!r} "
        f"(tolerance {TWIN_RTOL}); denoise {step_ms!r} ms/step against the ring's "
        f"{ring_step_ms!r} [{tag}]")
    if not rel < TWIN_RTOL:
        raise AssertionError("the ring's latents are off the default dispatch's")
    loop_beside(plain, twin, latents, graph_launches, step_ms, tag)
    return launches


def serve_batch(pipe, path: Path, single_latents, tag: str) -> None:
    """Phase 6 batch, on path a's and path c's models: request 0 with
    ``generate_image(num_images=NUM_IMAGES)`` and the path's two requests
    through ``generate_images_batched``, each denoise batch in one chunk
    (the auto-split's budget), against the same batch split into chunks of
    one image (``DIFFUSIONKIT_TPU_DENOISE_BATCH=1``), each image's single
    run. Image 0's noise must be the single run's bit for bit, a chunk of
    one the single request's latents bit for bit, each batched image's
    latents within TWIN_RTOL relative L2 of its single run (a larger GEMM M
    may take another cuBLAS kernel), and the images distinct. The latents
    are read where the pipeline hands them to ``_decode_batched_u8``. A
    first call of each entry captures its batch's graph; the logged times
    are the second's."""
    kw = dict(num_steps=path.steps, cfg_weight=path.cfg, latent_size=path.latent)
    text, seed = path.requests[0]
    texts, seeds = (list(v) for v in zip(*path.requests))
    per = pipe._denoise_chunk_images(path.latent)
    if per < NUM_IMAGES:
        raise AssertionError(f"{path.name}: the auto-split takes {per} images a chunk, "
                             f"under {NUM_IMAGES}")
    x_t = pipe.get_empty_latent(*path.latent)
    if not np.array_equal(pipe.get_noise(seed, np.tile(x_t, (NUM_IMAGES, 1, 1, 1)))[:1],
                          pipe.get_noise(seed, x_t)):
        raise AssertionError("image 0's noise differs from the single run's")
    pipe.generate_image(text, seed=seed, num_images=NUM_IMAGES, verbose=False, **kw)
    pipe.generate_images_batched(texts, seeds=seeds, **kw)
    seen = []
    decode = pipe._decode_batched_u8
    pipe._decode_batched_u8 = lambda latents: (seen.append(latents), decode(latents))[1]
    try:
        torch.cuda.reset_peak_memory_stats()
        images, lg = pipe.generate_image(text, seed=seed, num_images=NUM_IMAGES, verbose=False,
                                         **kw)
        with env_set(SPLIT_ENV, "1"):
            pipe.generate_image(text, seed=seed, num_images=NUM_IMAGES, verbose=False, **kw)
        t0 = time.perf_counter()
        batched = pipe.generate_images_batched(texts, seeds=seeds, **kw)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        with env_set(SPLIT_ENV, "1"):
            pipe.generate_images_batched(texts, seeds=seeds, **kw)
    finally:
        del pipe._decode_batched_u8
    peak = torch.cuda.max_memory_allocated() / 2**30
    for label, imgs, (whole, single) in (("num_images", images, seen[:2]),
                                         ("generate_images_batched", batched, seen[2:])):
        n = len(imgs)
        side = 8 * path.latent[0]
        arrays = [np.asarray(im) for im in imgs]
        if any(a.shape != (side, side, 3) for a in arrays) or whole.shape[0] != n:
            raise AssertionError(f"{path.name} {label}: wrong shapes")
        if any(np.array_equal(arrays[i], arrays[j]) for i in range(n) for j in range(i)):
            raise AssertionError(f"{path.name} {label}: two images are the same")
        if not torch.equal(single[:1], single_latents):
            raise AssertionError(f"{path.name} {label}: a chunk of one is not request 0's "
                                 f"single run")
        rels = [rel_l2(whole[i], single[i]) for i in range(n)]
        log(f"  {path.name} {label} ({n} images, one chunk): latents relative L2 against each "
            f"image's single run {rels!r} (tolerance {TWIN_RTOL}); images distinct; a chunk of "
            f"one is request 0's single run bit for bit [{tag}]")
        if not max(rels) < TWIN_RTOL:
            raise AssertionError(f"{path.name} {label}: batched latents off their single runs")
    it = lg["denoising"]["iter_time"]
    log(f"  {path.name} num_images={NUM_IMAGES}: denoise {1e3 * lg['denoising']['time']!r} ms, "
        f"{1e3 * statistics.median(it)!r} ms/step for {NUM_IMAGES} images, decoding "
        f"{1e3 * lg['decoding']['time']!r} ms, total {lg['total_time']!r} s; "
        f"generate_images_batched of {len(texts)} prompts {batched_s!r} s; peak memory "
        f"{peak!r} GiB [{tag}]")


# -- serving over HTTP (path q) and the CLI (in path n) ------------------------


def http_post(url: str, payload: dict, path: str = "/generate"):
    """(status, headers, body) of a POST; an HTTP error's own status."""
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def http_get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def png_array(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def serve_round(url: str, jobs: list) -> tuple:
    """``jobs`` ((prompt, seed) each) sent at once, one client thread a
    job: (the replies in job order, seconds from the first send to the last
    reply)."""
    side = 8 * FLUX_SERVE.latent[0]
    replies = [None] * len(jobs)

    def send(i, text, seed):
        replies[i] = http_post(url, {"prompt": text, "seed": seed, "height": side,
                                     "width": side, "steps": FLUX_SERVE.steps,
                                     "cfg": FLUX_SERVE.cfg})

    threads = [threading.Thread(target=send, args=(i, *job)) for i, job in enumerate(jobs)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{FLUX_SERVE.name}: a client got no reply in 600 s")
    return replies, seconds


def http_path(pipe, f_launches: dict, tag: str) -> dict:
    """Path q (module docstring): f's pipeline behind GenerationServer on a
    ThreadingHTTPServer at 127.0.0.1, in this process. Returns its
    launches."""
    path = FLUX_SERVE
    side = 8 * path.latent[0]
    srv = GenerationServer(pipe, max_batch=8)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.handler_class())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status, health = http_get(url, "/healthz")
        if not (status == 200 and health["backend"] == "cuda"
                and health["device_kind"] == torch.cuda.get_device_name(0)):
            raise AssertionError(f"{path.name}: /healthz said {status} {health}")
        log(f"  /healthz: {health}")

        # /warmup, with a client polling /healthz and /metrics meanwhile.
        polls, warming = [], threading.Event()

        def poll():
            while not warming.is_set():
                for probe in ("/healthz", "/metrics"):
                    try:
                        polls.append(http_get(url, probe)[0])
                    except Exception as e:  # noqa: BLE001 - recorded as a failed poll
                        polls.append(repr(e))
                time.sleep(0.05)

        poller = threading.Thread(target=poll, daemon=True)
        captures, capture_s = StepGraph.captures, StepGraph.capture_s
        poller.start()
        t0 = time.perf_counter()
        try:
            status, _, body = http_post(url, {"batch": 8, "height": side, "width": side,
                                              "steps": path.steps, "cfg": path.cfg}, "/warmup")
        finally:
            warming.set()
            poller.join(timeout=60)
        seconds = time.perf_counter() - t0
        body = json.loads(body)
        log(f"  /warmup (batch 8): {status} {body}; {StepGraph.captures - captures} step graphs "
            f"captured ({pipe._denoise_chunk_images(path.latent)} images a denoise chunk), "
            f"capture {StepGraph.capture_s - capture_s!r} s, warmup {seconds!r} s, "
            f"{torch.cuda.memory_allocated() / 2**30!r} GiB allocated after; "
            f"{len(polls)} /healthz and /metrics polls meanwhile [{tag}]")
        if status != 200 or body["compiled_buckets"] != [1, 2, 4, 8]:
            raise AssertionError(f"{path.name}: /warmup said {status} {body}")
        if not polls or any(p != 200 for p in polls):
            raise AssertionError(f"{path.name}: a poll during /warmup failed: {polls}")

        # The served requests: what the pipeline decoded for each batch is
        # read where it hands the latents to _decode_batched_u8.
        decoded, batches = [], []
        decode, batched = pipe._decode_batched_u8, pipe.generate_images_batched

        def decode_hook(latents):
            u8 = decode(latents)
            decoded.append((latents.clone(), u8))
            return u8

        def batched_hook(texts, **kw):
            images = batched(texts, **kw)
            batches.append((list(texts), list(kw["seeds"]), decoded[-1]))
            return images

        pipe._decode_batched_u8, pipe.generate_images_batched = decode_hook, batched_hook
        try:
            capture_s = StepGraph.capture_s
            torch.cuda.synchronize()
            reset_counts()
            sent, http_rows, served = 0, [], []
            for b in SERVE_BATCHES:
                times = []
                for r in range(SERVE_RUNS):
                    jobs = [(bench_serving.PROMPTS[i], i + r) for i in range(b)]
                    first = len(batches)
                    replies, dt = serve_round(url, jobs)
                    sent += b
                    times.append(dt)
                    images = []
                    for (text, seed), (status, headers, data) in zip(jobs, replies):
                        if status != 200 or headers["Content-Type"] != "image/png":
                            raise AssertionError(f"{path.name}: {status} for {text!r}, seed {seed}")
                        got = png_array(data)
                        texts, seeds, (latents, u8) = next(
                            c for c in batches[first:] if (text, seed) in zip(c[0], c[1]))
                        i = list(zip(texts, seeds)).index((text, seed))
                        if got.shape != (side, side, 3) or not np.array_equal(got, u8[i]):
                            raise AssertionError(f"{path.name}: the PNG for {text!r}, seed {seed} "
                                                 "is not what the pipeline decoded for it")
                        images.append(got)
                        if r == 0:
                            served.append((text, seed, latents[i]))
                    if any(np.array_equal(images[i], images[j])
                           for i in range(b) for j in range(i)):
                        raise AssertionError(f"{path.name}: two requests of a round of {b} "
                                             "got the same image")
                http_rows.append({"batch": b, "s_per_batch": statistics.mean(times),
                                  "images_per_min": 60.0 * b / statistics.mean(times)})
            status, _, data = http_post(url, {"prompt": bench_serving.PROMPTS[0], "seed": 0,
                                              "height": side, "width": side,
                                              "num_images": 2})
            sent += 1
            pair = [png_array(base64.b64decode(im)) for im in json.loads(data)["images"]]
            if status != 200 or len(pair) != 2 or np.array_equal(*pair):
                raise AssertionError(f"{path.name}: num_images=2 gave {status}, not two distinct "
                                     "images")
            if not all(np.array_equal(pair[i], decoded[-1][1][i]) for i in range(2)):
                raise AssertionError(f"{path.name}: num_images=2's images are not what the "
                                     "pipeline decoded")
            torch.cuda.synchronize()
            launches = counts()
            if StepGraph.capture_s != capture_s:
                raise AssertionError(f"{path.name}: a request after /warmup captured a graph")
            log(f"  {sent} requests: every PNG the pipeline's decode bit for bit, the images of "
                f"each round distinct; num_images=2 on the JSON path; no graph captured after "
                f"/warmup")

            # Each first round's latents against the request's single run.
            singles, rels = {}, []
            for text, seed, latents in served:
                if (text, seed) not in singles:
                    pipe.generate_image(text, seed=seed, num_steps=path.steps,
                                        cfg_weight=path.cfg, latent_size=path.latent,
                                        verbose=False)
                    singles[(text, seed)] = decoded[-1][0][0]
                rels.append(rel_l2(latents, singles[(text, seed)]))
            log(f"  served latents (the first round at each batch) relative L2 against each "
                f"request's single run {rels!r} (tolerance {TWIN_RTOL})")
            if not max(rels) < TWIN_RTOL:
                raise AssertionError(f"{path.name}: served latents off their single runs")
        finally:
            del pipe._decode_batched_u8, pipe.generate_images_batched

        m = http_get(url, "/metrics")[1]
        log(f"  /metrics: {m}")
        if m["served"] != sent or any(m[k] for k in ("errors", "timeouts", "rejected")):
            raise AssertionError(f"{path.name}: /metrics after {sent} requests: {m}")
        log(f"  batches {m['batches']!r}, batch occupancy {m['batch_occupancy']!r}, latency "
            f"p50 {m['latency_p50_s']!r} s, p95 {m['latency_p95_s']!r} s [{tag}]")

        used = {k for k, n in launches.items() if n}
        want = {k for k, n in f_launches.items() if n}
        named = {"mod_ln", "flash_attention_bshd", "mod_ln_quantize", "quantize",
                 "w4a8_matmul[gelu_quant]", "w4a8_matmul[grouped_xs]", "w4a8_matmul[norm_rope]",
                 "w4a8_matmul[gemv]", "w8_matmul", "dequant_w8"}
        log(f"  launches during {path.name}'s requests: {launches}")
        if used != want or not named <= used:
            raise AssertionError(f"{path.name}: kernels launched {sorted(used)}, path f's "
                                 f"{sorted(want)}")

        rows = bench_serving.run(pipe, side, SERVE_BATCHES, n_runs=SERVE_RUNS)
        for http_row, row in zip(http_rows, rows):
            log(f"  batch {row['batch']}: {http_row['images_per_min']!r} images/min through "
                f"HTTP ({http_row['s_per_batch']!r} s a round, first send to last reply), "
                f"{row['images_per_min']!r} images/min by bench_serving.run "
                f"({row['s_per_batch']!r} s a batch) [{tag}]")

        status = srv.drain(deadline_s=60.0)
        late = http_post(url, {"prompt": "late", "height": side, "width": side})[0]
        log(f"  drain: {status}; a request after it: {late}")
        if status["drained"] is not True or late != 503:
            raise AssertionError(f"{path.name}: drain said {status}, a late request {late}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.pipeline = None  # the idle worker thread keeps the server, not the models
    return launches


def cli_runs(want: np.ndarray, scratch: str, tag: str) -> None:
    """In path n, under its DIFFUSIONKIT_TPU_CKPT_DIR: the CLI in a
    subprocess on a's request 0, once with its default flags (low memory)
    and once with --benchmark-mode; each PNG a's image bit for bit."""
    text, seed = SD3.requests[0]
    side = str(8 * SD3.latent[0])
    for flags in ((), ("--benchmark-mode",)):
        out = os.path.join(scratch, f"cli_{len(flags)}.png")
        cmd = [sys.executable, "-m", "diffusionkit_tpu_torch.scripts.generate_images",
               "--model-version", SD3_MEDIUM, "--prompt", text, "--seed", str(seed),
               "--steps", str(SD3.steps), "--cfg", str(SD3.cfg), "--height", side,
               "--width", side, "-o", out, *flags]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the CLI {' '.join(flags)} exited {proc.returncode}: "
                                 f"{proc.stderr[-4000:]}")
        got = png_array(open(out, "rb").read())
        log(f"  CLI {' '.join(cmd[3:])}: {wall!r} s wall [{tag}]")
        if not np.array_equal(got, want):
            raise AssertionError(f"the CLI {' '.join(flags)}: its PNG is not path a's request-0 "
                                 "image")
    log("  both CLI PNGs are path a's request-0 image bit for bit")


# -- img2img (paths l and m) and the generic Autoencoder ----------------------

# The smoke's checkpoint files are written by the port's own writer (the
# card's machine has no safetensors package).
write_safetensors = model_io.save_safetensors


def rename(sd: dict, rules) -> dict:
    """``sd`` with each key rewritten by ``rules`` ((pattern, replacement)
    in turn)."""
    out = {}
    for key, t in sd.items():
        for pattern, repl in rules:
            key = re.sub(pattern, repl, key)
        out[key] = t
    return out


def renamed(sd: dict, rules) -> dict:
    """A VAE's ``sd`` renamed by ``rules``, every 2-d weight but those the
    diffusers names keep as linears stored as a 1x1 convolution."""
    return {k: t[:, :, None, None] if t.ndim == 2 and not re.search(
        r"\.(to_[qkv]|to_out\.0)\.weight$", k) else t for k, t in rename(sd, rules).items()}


# The port's VAEEncoder state-dict names -> the raw sgm namespace (the
# inverse of model_io.vae_encoder_from_ckpt).
SGM_ATTN = {"group_norm": "norm", "query_proj": "q", "key_proj": "k", "value_proj": "v",
            "out_proj": "proj_out"}
SGM_ENCODER = [(r"^down_blocks\.(\d+)\.resnets\.(\d+)\.", r"down.\1.block.\2."),
               (r"^down_blocks\.(\d+)\.downsample\.", r"down.\1.downsample.conv."),
               (r"^mid_blocks\.([02])\.", lambda m: f"mid.block_{int(m[1]) // 2 + 1}."),
               (r"^mid_blocks\.1\.(\w+)\.", lambda m: f"mid.attn_1.{SGM_ATTN[m[1]]}."),
               (r"\.conv_shortcut\.", ".nin_shortcut."), (r"^conv_norm_out\.", "norm_out.")]
SGM_DECODER = [(r"^up_blocks\.(\d+)\.resnets\.(\d+)\.", r"up.\1.block.\2."),
               (r"^up_blocks\.(\d+)\.upsample\.", r"up.\1.upsample.conv."),
               *SGM_ENCODER[2:]]
DIFFUSERS_ATTN = {"group_norm": "group_norm", "query_proj": "to_q", "key_proj": "to_k",
                  "value_proj": "to_v", "out_proj": "to_out.0"}


def diffusers_rules(n_blocks: int):
    """The port's Autoencoder names -> HF diffusers AutoencoderKL (the
    inverse of model_io.autoencoder_from_diffusers_ckpt): the decoder's
    up_blocks flipped into application order, the modern attention names
    (linears), the quant projections as 1x1 convolutions."""
    return [(r"^(encoder|decoder)\.mid_blocks\.([02])\.",
             lambda m: f"{m[1]}.mid_block.resnets.{int(m[2]) // 2}."),
            (r"^(encoder|decoder)\.mid_blocks\.1\.(\w+)\.",
             lambda m: f"{m[1]}.mid_block.attentions.0.{DIFFUSERS_ATTN[m[2]]}."),
            (r"^encoder\.down_blocks\.(\d+)\.downsample\.",
             r"encoder.down_blocks.\1.downsamplers.0.conv."),
            (r"^decoder\.up_blocks\.(\d+)\.",
             lambda m: f"decoder.up_blocks.{n_blocks - 1 - int(m[1])}."),
            (r"\.upsample\.", ".upsamplers.0.conv."),
            (r"^quant_proj\.", "quant_conv."), (r"^post_quant_proj\.", "post_quant_conv.")]


def write_encoder_ckpt(gen, path, prefix: str, dtype) -> dict:
    """A full-width SD3 / FLUX VAE encoder drawn on the card, written to
    ``path`` in the raw sgm namespace under ``prefix`` in ``dtype``;
    returns its weights as a loader must give them back in fp32 (rounded
    to ``dtype``), on the card."""
    encoder = init_vae_encoder(VAEEncoderConfig(), gen, "cuda")
    sd = {k: v.to(dtype) for k, v in encoder.state_dict().items()}
    write_safetensors(path, {prefix + "encoder." + k: v
                             for k, v in renamed(sd, SGM_ENCODER).items()})
    return {k: v.float() for k, v in sd.items()}


def autoencoder_check(gen, scratch: str, tag: str) -> dict:
    """Phase 5, the generic Autoencoder: a full-width one ((128, 256, 512,
    512), SD3's 16 latent channels) drawn on the card and written as a
    diffusers mirror (``config.json`` and F32 weights) under
    DIFFUSIONKIT_TPU_CKPT_DIR; ``model_io.load_autoencoder`` must read back
    its config and its weights bit for bit on the card; a 256² image
    encoded (mean, logvar) and the mean decoded on the card against the
    same weights in fp32 on the CPU within FP32_RTOL."""
    config = AutoencoderConfig(latent_channels_out=32, latent_channels_in=16,
                               scaling_factor=1.5305)
    src = init_autoencoder(config, gen, "cuda")
    vae_dir = os.path.join(scratch, "mirror", model_io.AUX_REPO, "vae")
    os.makedirs(vae_dir)
    with open(os.path.join(vae_dir, "config.json"), "w") as f:
        json.dump({"in_channels": 3, "out_channels": 3, "latent_channels": 16,
                   "block_out_channels": list(config.block_out_channels),
                   "layers_per_block": config.layers_per_block,
                   "norm_num_groups": config.norm_num_groups,
                   "scaling_factor": config.scaling_factor}, f)
    rules = diffusers_rules(len(config.block_out_channels))
    write_safetensors(os.path.join(vae_dir, "diffusion_pytorch_model.safetensors"),
                      renamed(src.state_dict(), rules))
    t0 = time.perf_counter()
    with env_set("DIFFUSIONKIT_TPU_CKPT_DIR", os.path.join(scratch, "mirror")):
        model, loaded = model_io.load_autoencoder()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same = all(torch.equal(v, src.state_dict()[k]) for k, v in model.state_dict().items())
    if loaded != config or not same or not isinstance(model, Autoencoder):
        raise AssertionError("load_autoencoder did not give back the mirror's config and weights")
    del src
    x = torch.rand(1, 256, 256, 3, generator=gen, device="cuda") * 2 - 1
    reset_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        mean, logvar = model.encode(x)
        x_hat = model.decode(mean)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = counts()
        ref = copy.deepcopy(model).cpu()
        want_mean, want_logvar = ref.encode(x.cpu())
        want_x = ref.decode(want_mean)
    rels = [rel_l2(a, b) for a, b in ((mean, want_mean), (logvar, want_logvar), (x_hat, want_x))]
    finite = all(bool(torch.isfinite(t).all()) for t in (mean, logvar, x_hat))
    log(f"  Autoencoder (128, 256, 512, 512), 16 latent channels: load_autoencoder from the "
        f"diffusers mirror in {load_s!r} s (config and weights bit for bit); a 256² image's "
        f"mean {tuple(mean.shape)}, logvar, and the mean's decode {tuple(x_hat.shape)} on the "
        f"card in {ms!r} ms (first call), relative L2 against fp32 on the CPU {rels!r} "
        f"(tolerance {FP32_RTOL}), finite {finite}, launches "
        f"{ {k: v for k, v in launches.items() if v} } [{tag}]")
    if not (max(rels) < FP32_RTOL and finite and tuple(x_hat.shape) == (1, 256, 256, 3)):
        raise AssertionError("the Autoencoder on the card disagrees with fp32 on the CPU")
    return launches


def img2img_source(image: np.ndarray, scratch: str, name: str, size=None) -> str:
    """``image`` written as a PNG (resized to ``size`` (w, h) first)."""
    from PIL import Image

    img = Image.fromarray(image)
    if size is not None:
        img = img.resize(size, Image.BICUBIC)
    path = os.path.join(scratch, f"{name}.png")
    img.save(path)
    return path


def serve_img2img(pipe, path: Path, src: str, source: np.ndarray, want_encoder: dict, tag: str,
                  cpu_check: bool) -> dict:
    """Paths l and m: request 0 through ``generate_image(image_path=src,
    denoise=...)`` twice (the first loads the encoder from the pipeline's
    ``local_ckpt`` through ``model_io.load_vae_encoder`` and captures the
    graph; the repeat is warm and must give the identical image, unlike
    ``source``), ``int(num_steps * denoise)`` steps each, every kernel's
    launches the config's count for those steps plus the decode's and the
    encode's (kernel B's fp32 form, once); the encoder fp32 on the card
    with the file's weights; one encode alone (B's fp32 form once, timed
    warm) and, with ``cpu_check``, against the same weights in fp32 on the
    CPU within FP32_RTOL; the graph's latents the synced loop's bit for
    bit; and after a txt2img request on the same pipeline (which caches a
    longer schedule) the img2img latents the first ones bit for bit."""
    text, seed = path.requests[0]
    img2img = dict(image_path=src, denoise=DENOISE[path.name])
    ran = path.steps - int(path.steps * (1 - img2img["denoise"]))
    per = per_request_launches(dataclasses.replace(path, steps=ran), pipe.mmdit.config)
    per["flash_attention_bshd"] += 1  # the encoder's mid-block, on B's fp32 form
    per["flash_attention_bshd[f32]"] = 1
    if pipe.encoder is not None:
        raise AssertionError(f"{path.name}: the encoder must load at the first request")
    kw = dict(num_steps=path.steps, cfg_weight=path.cfg, latent_size=path.latent, verbose=False)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    images, logs = [], []
    for _ in range(2):
        image, lg = pipe.generate_image(text, seed=seed, **kw, **img2img)
        images.append(np.asarray(image))
        logs.append(lg)
    torch.cuda.synchronize()
    launches = counts()
    check_launches(launches, per, 2, f"the {path.name} requests")
    enc = pipe.encoder
    state = enc.state_dict() if isinstance(enc, VAEEncoder) else {}
    if not (state.keys() == want_encoder.keys() and all(
            v.dtype == torch.float32 and v.is_cuda and torch.equal(v, want_encoder[k])
            for k, v in state.items())):
        raise AssertionError(f"{path.name}: the lazily loaded encoder is not the file's, in fp32 "
                             f"on the card")
    steps = [len(lg["denoising"]["iter_time"]) for lg in logs]
    side = 8 * path.latent[0]
    log(f"  {path.name}: encoder loaded from {pipe.local_ckpt} at the first request; "
        f"{steps} steps of {path.steps} at denoise {img2img['denoise']}; image "
        f"{images[0].shape}, pixel std {images[0].std()!r}, relative L2 against the source "
        f"{rel_l2(images[0], source)!r}")
    if steps != [ran, ran] or images[0].shape != (side, side, 3) or images[0].std() == 0:
        raise AssertionError(f"{path.name}: wrong step count, shape or a constant image")
    if not np.array_equal(images[0], images[1]):
        raise AssertionError(f"{path.name}: repeating the request gave a different image")
    if np.array_equal(images[0], source):
        raise AssertionError(f"{path.name}: the image is the source")
    log("  repeat of request 0: bit-identical image, not the source")

    reset_counts()
    t0 = time.perf_counter()
    latents = pipe.encode_image_to_latents(src, seed=seed)
    torch.cuda.synchronize()
    encode_ms = 1e3 * (time.perf_counter() - t0)
    check_launches(counts(), {"flash_attention_bshd": 1, "flash_attention_bshd[f32]": 1}, 1,
                   f"one {path.name} encode")
    if cpu_check:
        with torch.inference_mode():
            image = torch.from_numpy(pipe.read_image(src))
            b, h, w, _ = image.shape
            noise = torch.from_numpy(pipe.get_noise(seed, np.zeros((b, h // 8, w // 8, 16),
                                                                  np.float32)))
            want = _encode_step(copy.deepcopy(enc).cpu(), image, noise)
        rel = rel_l2(latents, want)
        log(f"  {path.name}: encoded latents {tuple(latents.shape)} against the same weights "
            f"in fp32 on the CPU: relative L2 {rel!r} (tolerance {FP32_RTOL})")
        if not (rel < FP32_RTOL and torch.isfinite(latents).all()):
            raise AssertionError(f"{path.name}: the encode on the card disagrees with the CPU's")

    latents, graph_ms, graph_launches = denoise_request(pipe, path, True, **img2img)
    loop_ms = loop_beside(pipe, path, latents, graph_launches, graph_ms, tag, **img2img)
    pipe.generate_image(text, seed=seed, **kw)  # txt2img: all path.steps steps, cached
    scans = [scan.n_sigmas for scan in pipe._scans.values()]
    again, _, _ = denoise_request(pipe, path, True, **img2img)
    if scans != [len(pipe.get_sigmas(path.steps))] or not torch.equal(again, latents):
        raise AssertionError(f"{path.name}: img2img after txt2img (its cached schedule "
                             f"{scans}) is not the first request's")
    log(f"  {path.name}: after a txt2img request ({scans[0]} sigmas cached) the img2img latents "
        f"reuse its schedule and are the first request's bit for bit")
    lg = logs[1]
    log(f"  {path.name}: denoise {graph_ms!r} ms/step under the CUDA graph, {loop_ms!r} in the "
        f"synced loop; encode {encode_ms!r} ms (warm, host clock); request 1: denoising "
        f"{lg['denoising']['time']!r} s (encode included), decoding {lg['decoding']['time']!r} "
        f"s, total {lg['total_time']!r} s/image; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB [{tag}]")
    return {"launches": launches, "step_ms": graph_ms, "loop_ms": loop_ms,
            "encode_ms": encode_ms}


def img2img_path(prev, path: Path, source: np.ndarray, gen, scratch: str, tag: str) -> dict:
    """Path l (``prev`` is a's pipeline) or m (c's): a new pipeline on
    ``prev``'s models with ``local_ckpt`` a freshly written encoder file and
    no encoder, served by ``serve_img2img``; freed after."""
    sd3 = path is SD3_IMG2IMG
    name, prefix, dtype = (("sd3_medium.safetensors", "first_stage_model.", torch.float16) if sd3
                           else ("ae.safetensors", "", torch.bfloat16))
    ckpt = os.path.join(scratch, name)
    want = write_encoder_ckpt(gen, ckpt, prefix, dtype)
    if sd3:
        pipe = DiffusionPipeline(load=False, low_memory_mode=False,
                                 device="cuda", use_t5=False, local_ckpt=ckpt)
        shared = ("mmdit", "clip_l", "clip_g", "decoder", "tokenizer_l", "tokenizer_g")
        src = img2img_source(source, scratch, path.name, IMG2IMG_SOURCE_SIZE)
    else:
        pipe = FluxPipeline(load=False, low_memory_mode=False,
                            device="cuda", quantize_mmdit="w4a8", local_ckpt=ckpt)
        shared = ("mmdit", "t5", "clip_l", "decoder", "tokenizer_l", "t5_tokenizer")
        src = img2img_source(source, scratch, path.name)
    for attr in shared:
        setattr(pipe, attr, getattr(prev, attr))
    served = serve_img2img(pipe, path, src, source, want, tag, cpu_check=sd3)
    del pipe, want
    gc.collect()
    torch.cuda.empty_cache()
    return served


# -- loading every model from its files (paths n and o) -------------------------

# The port's names -> the HF CLIPTextModel's, and the HF T5 encoder's (the
# inverses of model_io.clip_from_hf_ckpt and model_io.t5_from_ckpt).
HF_CLIP = [(r"^(token|position)_embedding\.", r"text_model.embeddings.\1_embedding."),
           (r"^layers\.(\d+)\.ln(\d)\.", r"text_model.encoder.layers.\1.layer_norm\2."),
           (r"^layers\.(\d+)\.(q|k|v)\w+_proj\.", r"text_model.encoder.layers.\1.self_attn.\2_proj."),
           (r"^layers\.(\d+)\.out_proj\.", r"text_model.encoder.layers.\1.self_attn.out_proj."),
           (r"^layers\.(\d+)\.linear(\d)\.", r"text_model.encoder.layers.\1.mlp.fc\2."),
           (r"^final_layer_norm\.", "text_model.final_layer_norm.")]
HF_T5 = [(r"^wte\.", "encoder.embed_tokens."),
         (r"^relative_attention_bias\.",
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias."),
         (r"^final_ln\.", "encoder.final_layer_norm."),
         (r"^layers\.(\d+)\.ln(\d)\.", lambda m: f"encoder.block.{m[1]}.layer.{int(m[2]) - 1}"
                                                 f".layer_norm."),
         (r"^layers\.(\d+)\.(\w)\w*_proj\.", r"encoder.block.\1.layer.0.SelfAttention.\2."),
         (r"^layers\.(\d+)\.(wi_0|wi_1|wo)\.", r"encoder.block.\1.layer.1.DenseReluDense.\2.")]
# The port's MMDiT projections -> the MLX module tree of the 4-bit releases.
MLX_PROJ = {"q": "attn.q_proj", "k": "attn.k_proj", "v": "attn.v_proj", "o": "attn.o_proj",
            "fc1": "mlp.fc1", "fc2": "mlp.fc2", "ada": "adaLN_modulation.layers.1"}


def sgm_mmdit_ckpt(model: MMDiT) -> dict:
    """An SD3 MMDiT in the raw sgm namespace (``model.diffusion_model.``),
    the inverse of model_io.mmdit_from_sd3_ckpt: q, k, v fused into qkv
    (the key's bias zero), the x_embedder as its patch convolution, the
    position table (1, R*R, H)."""
    sd, cfg, out = model.state_dict(), model.config, {}
    pre = "model.diffusion_model."

    def block(src: str, dst: str, final: bool) -> None:
        q, k, v = (sd[f"{src}.{n}.weight"] for n in "qkv")
        out[dst + ".attn.qkv.weight"] = torch.cat([q, k, v])
        out[dst + ".attn.qkv.bias"] = torch.cat([sd[src + ".q.bias"],
                                                 torch.zeros_like(sd[src + ".q.bias"]),
                                                 sd[src + ".v.bias"]])
        names = [("ada", "adaLN_modulation.1")]
        if not final:
            names += [("o", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")]
        for a, b in names:
            for leaf in ("weight", "bias"):
                out[f"{dst}.{b}.{leaf}"] = sd[f"{src}.{a}.{leaf}"]
        if cfg.use_qk_norm:
            out[dst + ".attn.ln_q.weight"] = sd[src + ".qk_norm.q_scale"]
            out[dst + ".attn.ln_k.weight"] = sd[src + ".qk_norm.k_scale"]

    n = cfg.depth_multimodal
    for i in range(n):
        src = f"mm_blocks.{i}" if i < n - 1 else "mm_final"
        block(f"{src}.img", f"{pre}joint_blocks.{i}.x_block", False)
        block(f"{src}.txt", f"{pre}joint_blocks.{i}.context_block", i == n - 1)
    H, p = cfg.hidden_size, cfg.patch_size
    out[pre + "x_embedder.proj.weight"] = sd["x_embedder.weight"].reshape(H, -1, p, p)
    out[pre + "x_embedder.proj.bias"] = sd["x_embedder.bias"]
    out[pre + "pos_embed"] = sd["pos_embed"][None]
    for a, b in (("context_embedder", "context_embedder"), ("t_embedder.fc1", "t_embedder.mlp.0"),
                 ("t_embedder.fc2", "t_embedder.mlp.2"), ("y_embedder.fc1", "y_embedder.mlp.0"),
                 ("y_embedder.fc2", "y_embedder.mlp.2"),
                 ("final_layer.ada", "final_layer.adaLN_modulation.1"),
                 ("final_layer.linear", "final_layer.linear")):
        for leaf in ("weight", "bias"):
            out[f"{pre}{b}.{leaf}"] = sd[f"{a}.{leaf}"]
    return out


def mlx_mmdit_ckpt(model: MMDiT) -> dict:
    """A FLUX MMDiT in the MLX module namespace of the 4-bit release, the
    inverse of model_io.mmdit_from_mlx_ckpt: a packed linear's (K/8, N)
    words transposed back to MLX's (N, K/8) uint32, its scales and zeros
    as F32 ``scales`` / ``biases`` (N, K/g); the q/k columns (and the
    QK-norm scales) put back into the checkpoint's interleaved RoPE order;
    the shared bias copied onto each unified block's fc2, as the release
    carries it; the x_embedder as an OHWI 1x1 convolution."""
    from diffusionkit_tpu_torch.ops.rope import rope_head_permutation

    cfg, out = model.config, {}
    d, dev = cfg.head_dim, model.x_embedder.weight.device
    perm = torch.from_numpy(rope_head_permutation(d)).to(dev)
    col = (torch.arange(cfg.num_heads, device=dev)[:, None] * d + perm[None, :]).reshape(-1)
    inv, inv_col = torch.argsort(perm), torch.argsort(col)

    def lin(layer, dst: str, rope: bool = False) -> None:
        if isinstance(layer, QuantizedLinear):
            cols = inv_col if rope else slice(None)
            out[dst + ".weight"] = layer.q4[:, cols].t().contiguous().view(torch.uint32)
            out[dst + ".scales"] = layer.scales[:, cols].t().contiguous()
            out[dst + ".biases"] = layer.zeros[:, cols].t().contiguous()
        else:
            out[dst + ".weight"] = layer.weight[inv_col] if rope else layer.weight
        if layer.bias is not None:
            out[dst + ".bias"] = layer.bias[inv_col] if rope else layer.bias

    def block(proj, dst: str, shared_bias: bool = False) -> None:
        for name, mlx in MLX_PROJ.items():
            lin(getattr(proj, name), f"{dst}.{mlx}", rope=name in ("q", "k"))
        out[dst + ".qk_norm.q_norm.weight"] = proj.qk_norm.q_scale[inv]
        out[dst + ".qk_norm.k_norm.weight"] = proj.qk_norm.k_scale[inv]
        if shared_bias:
            out[dst + ".mlp.fc2.bias"] = proj.o.bias

    for i, blk in enumerate(model.mm_blocks):
        block(blk.img, f"multimodal_transformer_blocks.{i}.image_transformer_block")
        block(blk.txt, f"multimodal_transformer_blocks.{i}.text_transformer_block")
    for i, blk in enumerate(model.uni_blocks):
        block(blk, f"unified_transformer_blocks.{i}.transformer_block", shared_bias=True)
    H = cfg.hidden_size
    out["x_embedder.proj.weight"] = model.x_embedder.weight.reshape(H, 1, 1, -1)
    out["x_embedder.proj.bias"] = model.x_embedder.bias
    lin(model.context_embedder, "context_embedder")
    for name in ("t_embedder", "y_embedder"):
        lin(getattr(model, name).fc1, f"{name}.mlp.layers.0")
        lin(getattr(model, name).fc2, f"{name}.mlp.layers.2")
    if model.guidance_embedder is not None:  # FLUX.1-dev
        lin(model.guidance_embedder.fc1, "guidance_in.mlp.layers.0")
        lin(model.guidance_embedder.fc2, "guidance_in.mlp.layers.2")
    lin(model.final_layer.ada, "final_layer.adaLN_modulation.layers.1")
    lin(model.final_layer.linear, "final_layer.linear")
    return out


def write_clip_dir(root: str, which: str, clip, vocab: dict) -> None:
    """An HF CLIP text model under the auxiliary repo (``config.json`` and
    ``model.fp16.safetensors``, here holding the model's BF16 weights), and
    its tokenizer's ``vocab.json`` and a ``merges.txt`` of the header line
    alone."""
    c = clip.config
    base = os.path.join(root, model_io.AUX_REPO)
    os.makedirs(os.path.join(base, which), exist_ok=True)
    cfg = {"num_hidden_layers": c.num_layers, "hidden_size": c.model_dims,
           "num_attention_heads": c.num_heads, "max_position_embeddings": c.max_length,
           "vocab_size": c.vocab_size, "hidden_act": c.hidden_act}
    if c.projection_dim is not None:
        cfg["projection_dim"] = c.projection_dim
    with open(os.path.join(base, model_io.AUX_FILES[which + "_config"]), "w") as f:
        json.dump(cfg, f)
    write_safetensors(os.path.join(base, model_io.AUX_FILES[which]),
                      rename(clip.state_dict(), HF_CLIP))
    tok = "tokenizer_" + which[-1]
    os.makedirs(os.path.join(base, tok), exist_ok=True)
    with open(os.path.join(base, model_io.AUX_FILES[tok + "_vocab"]), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(base, model_io.AUX_FILES[tok + "_merges"]), "w") as f:
        f.write("#version: 0.2\n")


def same_state(got: torch.nn.Module, want: torch.nn.Module) -> bool:
    g, w = got.state_dict(), want.state_dict()
    return g.keys() == w.keys() and all(
        g[k].dtype == w[k].dtype and g[k].device == w[k].device and torch.equal(g[k], w[k])
        for k in g)


def serve_loaded(pipe, path: Path, counted_as: Path, cfg, want: dict, models: tuple,
                 tag: str) -> dict:
    """Paths n and o: ``path``'s requests through ``generate_image`` of a
    pipeline that loads its models from files. Counters are zeroed before
    each request and read after it: each request's launches must be the
    served path's per-request count (its three requests' counts / 3) and
    the config's, and each image the served path's bit for bit. Under
    low_memory_mode every model in ``models`` must be None after its
    request. Prints each request's load, capture and phase times."""
    kw = dict(num_steps=path.steps, cfg_weight=path.cfg, latent_size=path.latent, verbose=False)
    per = per_request_launches(counted_as, cfg)
    out = {"images": [], "launches": collections.Counter(), "step_ms": [], "replay_ms": []}
    for i, (text, seed) in enumerate(path.requests):
        reset_counts()
        image, lg = pipe.generate_image(text, seed=seed, **kw)
        torch.cuda.synchronize()
        launches = counts()
        check_launches(launches, per, 1, f"{path.name} request {i} (loaded)")
        served = {k: n // 3 for k, n in want["launches"].items()}
        if launches != served or any(n % 3 for n in want["launches"].values()):
            raise AssertionError(f"{path.name} request {i}: launches {launches} are not the "
                                 f"served path's per request {served}")
        image = np.asarray(image)
        if not np.array_equal(image, want["images"][i]):
            raise AssertionError(f"{path.name} request {i}: the image differs from the served "
                                 f"path's (max {np.abs(image.astype(int) - want['images'][i]).max()})")
        if pipe.low_memory_mode and any(getattr(pipe, m) is not None for m in models):
            raise AssertionError(f"{path.name}: low_memory_mode kept a model after its phase")
        den = lg["denoising"]
        step_ms = 1e3 * statistics.median(den["iter_time"])
        replays = path.steps - 1 if den["capture_time"] else path.steps
        replay_ms = 1e3 * (den["time"] - den["capture_time"]) / replays
        out["images"].append(image)
        out["launches"] += collections.Counter(launches)
        out["step_ms"].append(step_ms)
        out["replay_ms"].append(replay_ms)
        log(f"  request {i}: image the served path's bit for bit, launches its per-request count; "
            f"load: text encoders {lg['text_encoding']['load_time']!r} s, MMDiT "
            f"{den['load_time']!r} s, decoder {lg['decoding']['load_time']!r} s; graph capture "
            f"(warm-up step and capture) {den['capture_time']!r} s; denoising {den['time']!r} s, "
            f"{step_ms!r} ms/step (total / n), {replay_ms!r} ms/step over the replays; "
            f"text_encoding {lg['text_encoding']['time']!r} s, decoding "
            f"{lg['decoding']['time']!r} s, total {lg['total_time']!r} s [{tag}]")
    return out


def loaded_sd3_path(prev: DiffusionPipeline, served: dict, scratch: str, tag: str) -> dict:
    """Path n: a's models written as SD3-medium's files (``sd3_medium.
    safetensors``: the MMDiT in the sgm namespace and the decoder under
    ``first_stage_model.``; the HF CLIP-L/G directories; the tokenizers'
    vocabulary and merges), all BF16, under a temporary
    DIFFUSIONKIT_TPU_CKPT_DIR; then ``DiffusionPipeline(use_t5=False)``
    with ``load=True`` and ``low_memory_mode=True`` serves a's two requests,
    loading the text encoders at construction and every other model before
    its phase, dropping each after: the images a's bit for bit, the
    launches a's, the peak above the starting allocation below a's peak."""
    root = tempfile.mkdtemp(prefix="ckpt_", dir=scratch)
    t0 = time.perf_counter()
    d = os.path.join(root, SD3_MEDIUM)
    os.makedirs(d)
    decoder = {"first_stage_model.decoder." + k: v
               for k, v in renamed(prev.decoder.state_dict(), SGM_DECODER).items()}
    write_safetensors(os.path.join(d, model_io.MMDIT_CKPT[SD3_MEDIUM]),
                      {**sgm_mmdit_ckpt(prev.mmdit), **decoder})
    for which in ("clip_l", "clip_g"):
        write_clip_dir(root, which, getattr(prev, which), prev.tokenizer_l.vocab)
    log(f"  SD3-medium's files written (BF16) in {time.perf_counter() - t0!r} s")
    try:
        with env_set("DIFFUSIONKIT_TPU_CKPT_DIR", root):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pipe = DiffusionPipeline(device="cuda", use_t5=False, load=True, low_memory_mode=True)
            torch.cuda.synchronize()
            log(f"  DiffusionPipeline(load=True, low_memory_mode=True): text encoders loaded in "
                f"{time.perf_counter() - t0!r} s")
            if not (same_state(pipe.clip_l, prev.clip_l) and same_state(pipe.clip_g, prev.clip_g)
                    and pipe.mmdit is None and pipe.decoder is None):
                raise AssertionError("path n: the loaded CLIP-L/G are not a's, or a model loaded "
                                     "before its phase")
            for name in ("tokenizer_l", "tokenizer_g"):
                if getattr(pipe, name).tokenize(SD3.requests[0][0]) != getattr(
                        prev, name).tokenize(SD3.requests[0][0]):
                    raise AssertionError(f"path n: {name} tokenizes differently")
            got = serve_loaded(pipe, SD3_LOADED, SD3, SD3_2b, served,
                               ("mmdit", "decoder", "clip_l", "clip_g"), tag)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            log("phase 6n, CLI: python -m diffusionkit_tpu_torch.scripts.generate_images on a's "
                "request 0 from these files, in a subprocess")
            cli_runs(served["images"][0], scratch, tag)
        log(f"  {SD3_LOADED.name}: peak {peak!r} GiB above the {base / 2**30!r} GiB allocated "
            f"before it (a's peak {served['peak']!r} GiB) [{tag}]")
        if peak >= served["peak"]:
            raise AssertionError("path n: low_memory_mode's peak is not below a's")
        got["peak"] = peak
        log(f"phase 6p: main path {SD3_GPTQ.name}: a's request 0 twice through "
            f"DiffusionPipeline(load=True, low_memory_mode=True, quantize_mmdit='int4') from "
            f"path n's files (GPTQ on the card, then the cache)")
        with env_set("DIFFUSIONKIT_TPU_CKPT_DIR", root):
            got["p"] = gptq_sd3_path(os.path.join(d, model_io.MMDIT_CKPT[SD3_MEDIUM]), scratch,
                                     tag)
        log("phase 6p, quality: a's float MMDiT against its GPTQ, ALS and min/max int4 models")
        gptq_quality(prev.mmdit, model_io.load_mmdit_cache(got["p"]["cache"], SD3_MEDIUM,
                                                           torch.bfloat16, "cuda"),
                     "SD3-medium int4 at group 32", tag)
        log("phase 6t: the mode table: tools/quant_quality.run on path n's files, bf16 and each "
            "quantize mode (256², 6 steps, CFG 5.0, seed 42)")
        with env_set("DIFFUSIONKIT_TPU_CKPT_DIR", root):
            got["t"] = mode_table(tag)
            log("phase 6n, cold loads: n's MMDiT file from a cold page cache")
            got["cold"] = cold_loads(SD3_MEDIUM, os.path.join(d, model_io.MMDIT_CKPT[SD3_MEDIUM]),
                                     tag)
        return got
    finally:
        shutil.rmtree(root)


def is_f16(t: torch.Tensor) -> bool:
    return torch.equal(t, t.half().float())


def check_gptq_model(model: MMDiT) -> None:
    """Every block linear packed, with scales and zeros on the f16 grid."""
    for name, layer in block_linears(model):
        if not isinstance(layer, QuantizedLinear) or layer.bits != 4:
            raise AssertionError(f"path p: block linear {name} is not an int4 QuantizedLinear")
        if not (is_f16(layer.scales) and is_f16(layer.zeros)):
            raise AssertionError(f"path p: {name}'s scales are not f16 values")


def gptq_sd3_path(ckpt: str, scratch: str, tag: str) -> dict:
    """Path p (module docstring): returns its launches, replay ms/step and
    the cache file."""
    cache_dir = tempfile.mkdtemp(prefix="quant_cache_", dir=scratch)
    kept, latents, writes = [], [], []
    out = {"launches": collections.Counter(), "replay_ms": []}
    save = model_io.save_module_cache

    def timed_save(module, path):
        t0 = time.perf_counter()
        save(module, path)
        writes.append((time.perf_counter() - t0, path))

    model_io.save_module_cache = timed_save
    try:
        with gptq_timed() as timed, env_set("DIFFUSIONKIT_TPU_CACHE_DIR", cache_dir):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pipe = DiffusionPipeline(device="cuda", use_t5=False, load=True, low_memory_mode=True,
                                     quantize_mmdit="int4", local_ckpt=ckpt)
            drop, denoise = pipe._drop, pipe.denoise_latents

            def drop_keeping(*names):
                if "mmdit" in names and pipe.mmdit is not None:
                    check_gptq_model(pipe.mmdit)
                    kept.append({k: v.clone() for k, v in pipe.mmdit.state_dict().items()})
                drop(*names)

            def denoise_keeping(*args, **kw):
                lat, it = denoise(*args, **kw)
                latents.append(lat.clone())
                return lat, it

            pipe._drop, pipe.denoise_latents = drop_keeping, denoise_keeping
            kw = dict(num_steps=SD3_GPTQ.steps, cfg_weight=SD3_GPTQ.cfg,
                      latent_size=SD3_GPTQ.latent, verbose=False)
            per = []
            for i, (text, seed) in enumerate(SD3_GPTQ.requests):
                reset_counts()
                _, lg = pipe.generate_image(text, seed=seed, **kw)
                torch.cuda.synchronize()
                per.append(counts())
                den = lg["denoising"]
                replay_ms = 1e3 * (den["time"] - den["capture_time"]) / (SD3_GPTQ.steps - 1)
                out["replay_ms"].append(replay_ms)
                out.setdefault("quantizers", []).append(den.get("quantizer"))
                log(f"  request {i}: quantizer {den.get('quantizer')!r} in "
                    f"{den.get('quantize_time')!r} s; MMDiT load {den['load_time']!r} s (file or "
                    f"cache, conversion, cache write); capture {den['capture_time']!r} s; "
                    f"{replay_ms!r} ms/step over the replays; total {lg['total_time']!r} s "
                    f"[{tag}]")
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    finally:
        model_io.save_module_cache = save
    phases = timed["phases"]
    if out["quantizers"] != ["gptq", "cached"]:
        raise AssertionError(f"path p: quantizers {out['quantizers']}, expected gptq then cached")
    if len(kept) != 2 or kept[0].keys() != kept[1].keys() or not all(
            torch.equal(kept[0][k], kept[1][k]) for k in kept[0]):
        raise AssertionError("path p: request 1's packed state dict is not request 0's")
    if not torch.equal(latents[0], latents[1]):
        raise AssertionError("path p: request 1's latents are not request 0's")
    if len(writes) != 1:
        raise AssertionError(f"path p: {len(writes)} cache writes, expected one")
    first, second = per
    timed["steps"] = first["gptq_group"]
    if first["gptq_group"] == 0 or second["gptq_group"] != 0:
        raise AssertionError(f"path p: group kernel launches {first['gptq_group']} / "
                             f"{second['gptq_group']}, expected some / none")
    if {k: v for k, v in first.items() if k != "gptq_group"} != {
            k: v for k, v in second.items() if k != "gptq_group"}:
        raise AssertionError(f"path p: the requests' launches differ: {first} / {second}")
    for name in ("mod_ln", "flash_attention_bshd", "int4_matmul", "int4_matmul[gemv]"):
        if first[name] == 0:
            raise AssertionError(f"path p: {name} was not launched")
    gptq_s = sum(phases.values())
    log(f"  {SD3_GPTQ.name}: quantizers gptq then cached, packed state and latents bit for bit, "
        f"every block linear int4 on the f16 grid; GPTQ by phase {phases} ({gptq_s!r} s timed; "
        f"{loop_note(timed)}), "
        f"cache written in {writes[0][0]!r} s "
        f"({os.path.getsize(writes[0][1]) / 2**30!r} GiB), peak {peak!r} GiB above the "
        f"{base / 2**30!r} GiB allocated before it; launches {dict(first)} then "
        f"{dict(second)} [{tag}]")
    for launches in per:
        out["launches"] += collections.Counter(launches)
    out["cache"] = writes[0][1]
    return out


def gptq_quality(float_model: MMDiT, gptq_model: MMDiT, label: str, tag: str) -> None:
    """The quality check beside paths p and w (module docstring): each
    model's error against the float model's output on calib_batch(seed=99)
    (4 images at 256²), with fp32 activations (the mirror, as the
    reference's test runs its models in fp32) and through the bf16 forward.
    The criterion, GPTQ's error at most 1.1x ALS's, is asserted on the block
    linears that read activations (q, k, v, o, fc1, fc2: everything else
    float): at SD3's 2048-wide pooled input the reference's calibration
    leaves the conditioning sites (y_embedder, every ``ada``) under-sampled
    and its GPTQ loses to ALS there, as the JAX package's own does
    (PERF.md)."""
    ev = gptq_ops.calib_batch(float_model.config, batch=4, seed=99)
    args = [torch.from_numpy(ev[k]).cuda() for k in ("latent", "cond", "pooled", "t")]

    def run(model):
        with torch.no_grad():
            return gptq_ops.mirror_forward(model, *args), model(*args).float()

    ref32, ref16 = run(float_model)
    models = {"gptq": gptq_model}
    for name, refine in (("als", True), ("minmax", False)):
        models[name] = quantize_module_(copy.deepcopy(float_model), 32, refine=refine)
    full, blocks = {}, {}
    hybrid = copy.deepcopy(float_model)
    names = [n for n, m in float_model.named_modules() if isinstance(m, torch.nn.Linear)
             and n.startswith(("mm_", "uni_")) and n.rpartition(".")[2] in (
                 "q", "k", "v", "o", "fc1", "fc2")]
    for name, model in models.items():
        got32, got16 = run(model)
        full[name] = (float(torch.linalg.norm(got32 - ref32)), float(torch.linalg.norm(got16 - ref16)))
        for n in names:
            parent, _, attr = n.rpartition(".")
            setattr(hybrid.get_submodule(parent), attr, model.get_submodule(n))
        blocks[name] = float(torch.linalg.norm(run(hybrid)[0] - ref32))
    del models, hybrid
    torch.cuda.empty_cache()
    log(f"  quality, {label}, one forward on calib_batch(seed=99) (4 images at 256², the float "
        f"output's norm {float(torch.linalg.norm(ref32))!r}): error (fp32 activations, bf16 "
        f"forward) gptq {full['gptq']!r}, als {full['als']!r}, minmax {full['minmax']!r}; the "
        f"{len(names)} block linears alone quantized (fp32): gptq {blocks['gptq']!r}, als "
        f"{blocks['als']!r}, minmax {blocks['minmax']!r}; gptq / als "
        f"{full['gptq'][0] / full['als'][0]!r} whole, {blocks['gptq'] / blocks['als']!r} blocks "
        f"[{tag}]")
    if not blocks["gptq"] <= 1.1 * blocks["als"]:
        raise AssertionError(f"{label}: GPTQ's block-linear error {blocks['gptq']} exceeds 1.1x "
                             f"ALS's {blocks['als']}")


def mode_table(tag: str) -> dict:
    """Phase 6t (module docstring): ``quant_quality.run`` for bf16 and each
    quantize mode on the SD3-medium files under DIFFUSIONKIT_TPU_CKPT_DIR,
    with the pipelines' default quantizers and then, for the 4-bit modes,
    the ALS grid (DIFFUSIONKIT_TPU_GPTQ=0); no quantized-model cache, so
    every mode converts. Each run's launches (the conversion's GPTQ group
    steps apart) are one request's count; each image's PSNR against bf16,
    its conversion seconds and its quantizer are printed, and the int8
    family held to the JAX gate's floors. Returns each mode's launches."""
    base, table, out = None, {}, {}
    runs = [(mode, "default") for mode in quant_quality.MODES]
    runs += [(mode, "als") for mode in GPTQ_MODES]
    with env_set("DIFFUSIONKIT_TPU_QUANT_CACHE", "0"):
        for mode, grid in runs:
            name = mode or "bf16"
            stats = {}
            reset_counts()
            with env_set("DIFFUSIONKIT_TPU_GPTQ", "0" if grid == "als" else "1"):
                image, wall = quant_quality.run(mode, QUALITY_STEPS, QUALITY_LATENT, stats=stats)
            torch.cuda.synchronize()
            launches = counts()
            groups = launches.pop("gptq_group")
            path = QUALITY[mode]
            check_launches(launches, per_request_launches(path, SD3_2b), 1,
                           f"{path.name} ({grid} grid)")
            launches["gptq_group"] = groups
            q = stats["quantizer"]
            if base is None:
                base = image
            psnr = None if mode is None else image_psnr(base, image)
            if grid == "default":
                out[path.name] = launches
                table[name] = psnr
                want = "gptq" if mode in GPTQ_MODES else {"int8": "minmax"}.get(mode, mode)
            else:
                want = "als"
            if (q and q["name"]) != want:
                raise AssertionError(f"mode table {name}: quantizer {q}, expected {want}")
            log(f"  {name} ({grid}): PSNR against bf16 {psnr!r} dB; quantizer "
                f"{q and q['name']!r} in {q and q['seconds']!r} s ({groups} group steps); "
                f"wall {wall!r} s, pipeline construction and loading included; image "
                f"{image.shape}, pixel std {float(image.std())!r} [{tag}]")
            if image.shape != (8 * QUALITY_LATENT[0], 8 * QUALITY_LATENT[1], 3) or image.std() == 0:
                raise AssertionError(f"mode table {name}: wrong shape or constant image")
    log(f"  the mode table, PSNR against bf16 (256², 6 steps, CFG 5.0, seed 42, the pipelines' "
        f"default quantizers): {table} [{tag}]")
    for mode, floor in QUALITY_FLOORS.items():
        if not table[mode] >= floor:
            raise AssertionError(f"mode table: {mode} at {table[mode]} dB, under the JAX "
                                 f"gate's floor of {floor} dB")
    return out


def evict(paths) -> None:
    """Drop ``paths`` (files this script wrote) from the page cache: their
    dirty pages written back (``fsync``), then ``POSIX_FADV_DONTNEED``. Only
    these files are touched."""
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def cold_loads(version: str, path: str, tag: str) -> dict:
    """The MMDiT file load of ``version`` (``model_io.load_mmdit`` onto the
    card, to a synchronise) from a cold page cache (``evict``), three ways:
    ``native.prefetch`` replaced by a no-op, as it is (``madvise(
    MADV_WILLNEED)``), and eager (one byte a page read first); then once
    warm, as the cache holds it after the eager load. A measurement, not a
    gate: the seconds printed and returned."""
    real = native.prefetch
    ways = {"off": lambda buf, eager=False: None, "madvise": real,
            "eager": lambda buf, eager=False: real(buf, True), "warm": real}
    size = os.path.getsize(path) / 2**30
    seconds = {}
    try:
        for way, fn in ways.items():
            native.prefetch = fn
            gc.collect()
            if way != "warm":
                evict([path])
            t0 = time.perf_counter()
            model, _ = model_io.load_mmdit(version, torch.bfloat16, device="cuda")
            torch.cuda.synchronize()
            seconds[way] = time.perf_counter() - t0
            del model
            torch.cuda.empty_cache()
    finally:
        native.prefetch = real
    log(f"  cold load of {version}'s MMDiT file ({size!r} GiB): prefetch off "
        f"{seconds['off']!r} s, madvise {seconds['madvise']!r} s, eager {seconds['eager']!r} s "
        f"(page cache evicted before each); warm, right after, {seconds['warm']!r} s [{tag}]")
    return seconds


def loaded_flux_path(prev: FluxPipeline, served: dict, scratch: str, tag: str) -> dict:
    """Path o: b's models written as the FLUX.1-schnell 4-bit release's
    files (the MMDiT in the MLX namespace, ``ae.safetensors``, T5-XXL's
    HF file, CLIP-L's directory and tokenizer) under a temporary
    DIFFUSIONKIT_TPU_CKPT_DIR; ``FluxPipeline(model_version=...-4bit-
    quantized, load=False, low_memory_mode=False)`` with the synthetic T5
    tokenizer assigned, then ``check_and_load_models()``: every loaded
    model b's bit for bit, the images b's, the launches b's."""
    root = tempfile.mkdtemp(prefix="ckpt_", dir=scratch)
    t0 = time.perf_counter()
    d = os.path.join(root, FLUX_SCHNELL_4BIT)
    os.makedirs(d)
    write_safetensors(os.path.join(d, model_io.MMDIT_CKPT[FLUX_SCHNELL_4BIT]),
                      mlx_mmdit_ckpt(prev.mmdit))
    decoder = {"decoder." + k: v for k, v in renamed(prev.decoder.state_dict(), SGM_DECODER).items()}
    write_safetensors(os.path.join(d, model_io.VAE_CKPT[FLUX_SCHNELL_4BIT]), decoder)
    t5 = os.path.join(root, model_io.AUX_REPO, model_io.AUX_FILES["t5"])
    os.makedirs(os.path.dirname(t5))
    write_safetensors(t5, rename(prev.t5.state_dict(), HF_T5))
    write_clip_dir(root, "clip_l", prev.clip_l, prev.tokenizer_l.vocab)
    written = time.perf_counter() - t0
    log(f"  the FLUX.1-schnell 4-bit release's files written in {written!r} s")
    try:
        with env_set("DIFFUSIONKIT_TPU_CKPT_DIR", root):
            pipe = FluxPipeline(device="cuda", model_version=FLUX_SCHNELL_4BIT, load=False,
                                low_memory_mode=False)
            pipe.t5_tokenizer = SyntheticT5Tokenizer(max_length=256)
            t0 = time.perf_counter()
            pipe.check_and_load_models()
            pipe.ensure_models_are_loaded()
            load_s = time.perf_counter() - t0
            log(f"  check_and_load_models(): MMDiT (MLX namespace), T5-XXL, CLIP-L, the decoder "
                f"loaded in {load_s!r} s [{tag}]")
            for name in ("mmdit", "t5", "clip_l", "decoder"):
                if not same_state(getattr(pipe, name), getattr(prev, name)):
                    raise AssertionError(f"path o: the loaded {name} is not b's bit for bit")
            packed = sum(isinstance(m, QuantizedLinear) for m in pipe.mmdit.modules())
            log(f"  every loaded model b's bit for bit ({packed} packed linears)")
            got = serve_loaded(pipe, FLUX_LOADED, FLUX, FLUX_SCHNELL, served, (), tag)
            del pipe
            log("phase 6o, cold loads: o's MMDiT file (the MLX namespace) from a cold page cache")
            got["cold"] = cold_loads(FLUX_SCHNELL_4BIT, os.path.join(
                d, model_io.MMDIT_CKPT[FLUX_SCHNELL_4BIT]), tag)
        got["load_s"] = load_s
        return got
    finally:
        shutil.rmtree(root)
        gc.collect()
        torch.cuda.empty_cache()


def f16_cast_check(scratch: str) -> None:
    """An F16 file of every 16-bit pattern, read by the loader into a bf16
    module on the card: every value the CPU's cast of the same tensor bit
    for bit (round to nearest even, as the reference's host cast; NaNs
    NaN)."""
    path = os.path.join(scratch, "f16_patterns.safetensors")
    write_safetensors(path, {"weight": torch.arange(-32768, 32768, dtype=torch.int32)
                             .to(torch.int16).view(torch.float16).reshape(256, 256)})
    sd = model_io.load_safetensors(path)
    with torch.device("meta"):
        layer = torch.nn.Linear(256, 256, bias=False, dtype=torch.bfloat16)
    got = model_io._build(layer, sd, "cuda").weight.detach().cpu()
    want = sd["weight"].to(torch.bfloat16)
    nan = torch.isnan(want)
    same = torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16)) and bool(
        torch.isnan(got[nan]).all())
    log(f"  F16 -> bf16 on the card against the CPU cast: {65536 - int(nan.sum())} values bit "
        f"for bit, {int(nan.sum())} NaNs NaN: {same}")
    if not same:
        raise AssertionError("the F16 file's cast on the card differs from the CPU's")
    os.remove(path)


# The releases' final layers: FLUX.1-schnell 4-bit at 1024² (4096 image
# rows) and SD3.5-large 4-bit at 1024² with CFG (2 x 4096), K -> 64 at
# group 64, int4 and with a w4a8 wscale.
FINAL_LAYER_SHAPES = [(4096, 3072), (8192, 2432)]


def packed_final_layer_check(gen) -> None:
    """The packed (K -> 64) final layer of the 4-bit releases: no kernel
    takes N = 64, so ``ops/common.linear`` runs it on the reference's
    dequantise path (``dequant_linear``), decided by shape; on the card it
    must not raise, launch no kernel (every counter 0), and match fp32 math
    on the bf16-rounded weight within one bf16 ulp + 2K 2^-24 (|x| @ |w|)."""
    for m, k in FINAL_LAYER_SHAPES:
        for w4a8 in (False, True):
            x, q4, scales, zeros = random_int4((m, k, 64, 64), gen)
            layer = QuantizedLinear(k, 64, 64, dtype=torch.bfloat16, device="cuda")
            with torch.no_grad():
                for name, t in (("q4", q4), ("scales", scales), ("zeros", zeros)):
                    getattr(layer, name).copy_(t)
                layer.bias.normal_(0.0, 0.1, generator=gen)
            if w4a8:
                add_wscale_(layer)
            reset_counts()
            y = linear(layer, x)
            torch.cuda.synchronize()
            launched = {n: c for n, c in counts().items() if c}
            w = dequantize_int4(layer.q4, layer.scales, layer.zeros, torch.bfloat16).double()
            ref = x.double() @ w + layer.bias.double()
            err = (y.double() - ref).abs()
            tol = bf16_ulp(ref.float()).double() + 2 * k * 2.0**-24 * (x.double().abs() @ w.abs())
            ok = bool((err <= tol).all()) and not launched and y.dtype == torch.bfloat16
            log(f"  packed final layer ({m}, {k}) -> 64, group 64{', w4a8' if w4a8 else ''}: "
                f"max abs err {err.max().item()!r} against fp32 math, launches {launched or 0}: "
                f"{ok}")
            if not ok:
                raise AssertionError("the packed final layer left the dequantise path or "
                                     "disagrees with fp32 math")


def upcast_block_check(model: MMDiT) -> None:
    """Block 35 holds its float leaves in fp32, every other block bf16."""
    for i, block in enumerate(model.mm_blocks):
        want = torch.float32 if i in model.config.upcast_multimodal_blocks else torch.bfloat16
        if {p.dtype for p in block.parameters()} != {want}:
            raise AssertionError(f"SD3.5 block {i}: float leaves not all {want}")


def build_sd35(mode):
    """Paths i (``mode`` "w4a8"), i' ("4bit") and k (None: bf16 with T5):
    SD3.5-large on the card through DiffusionPipeline(model_version=...),
    T5 off but on k. i and i' draw the block linears packed at group 64 (the
    4-bit release's layout), i gives them to quantize_mmdit="w4a8", which
    adds each layer's wscale; k draws the float model and a T5-XXL in bf16,
    its tokenizer at the version's 512 tokens. CLIP-L, the VAE decoder and
    CLIP-L's tokenizer come from the previous path (FLUX's first), CLIP-G is
    drawn for the first; the previous MMDiT (and a FLUX path's T5) is freed
    first."""

    def build(gen, prev) -> DiffusionPipeline:
        prev.mmdit = None
        if isinstance(prev, FluxPipeline):
            prev.t5 = None
        gc.collect()
        torch.cuda.empty_cache()
        version = SD35_LARGE_4BIT if mode == "4bit" else SD35_LARGE
        quant = "w4a8" if mode == "w4a8" else False
        pipe = DiffusionPipeline(load=False, low_memory_mode=False,
                                 device="cuda", model_version=version, use_t5=mode is None,
                                 quantize_mmdit=quant)
        for name in ("clip_l", "decoder", "tokenizer_l"):
            setattr(pipe, name, getattr(prev, name))
        if isinstance(prev, FluxPipeline):
            pipe.clip_g = init_clip(CLIP_G, gen, "cuda", dtype=torch.bfloat16)
            pipe.tokenizer_g = CLIPTokenizer({}, synthetic_clip_vocab(), pad_with_eos=False)
        else:
            pipe.clip_g, pipe.tokenizer_g = prev.clip_g, prev.tokenizer_g
        if mode is None:
            pipe.t5_tokenizer = SyntheticT5Tokenizer(max_length=pipe.t5_max_length)
            pipe.t5 = init_t5(T5_XXL, gen, "cuda", dtype=torch.bfloat16)
        pipe.mmdit = init_mmdit(SD3_8b, gen, "cuda", quantize_bits=4 if mode else None)
        upcast_block_check(pipe.mmdit)
        packed = [m for m in pipe.mmdit.modules() if isinstance(m, QuantizedLinear)]
        if mode and (not packed or (mode == "w4a8") != all(m.wscale is not None for m in packed)):
            raise AssertionError(f"SD3.5 {mode}: the packed linears' wscale is not as the mode")
        return pipe

    return build


def block_linears(model: MMDiT):
    """(name, layer) of every dual-stream block linear of ``model``."""
    for i, block in enumerate([*model.mm_blocks, model.mm_final]):
        for side, stream in (("img", block.img), ("txt", block.txt)):
            for name in ("q", "k", "v", "ada", "o", "fc1", "fc2"):
                layer = getattr(stream, name, None)
                if layer is not None:
                    yield f"{i}.{side}.{name}", layer


def quantized_as(mode: str, name: str, layer) -> bool:
    """Whether a block linear is in ``mode``'s form: int8 weight-only,
    w8a8, or for w4a8-mixed int4 with a wscale (the ``ada`` int8 without)."""
    if mode == "w8a8":
        return isinstance(layer, W8A8Linear)
    if not isinstance(layer, QuantizedLinear):
        return False
    if mode == "int8" or name.endswith(".ada"):
        return layer.bits == 8 and layer.wscale is None
    return layer.bits == 4 and layer.wscale is not None


def build_sd35_converted(mode: str):
    """Paths t (``mode`` "w4a8-mixed"), u ("int8") and v ("w8a8"): a float
    bf16 SD3.5-large (block 35 fp32) drawn on the card and given to
    DiffusionPipeline(model_version=...-3.5-large, use_t5=False,
    quantize_mmdit=mode), which converts it on the card: w4a8-mixed by GPTQ
    (it must not fall back), int8 on the min/max grid, w8a8 per channel.
    The conversion's seconds (GPTQ's by phase) and peak memory are printed,
    and every block linear checked in the mode's form (under -mixed the
    embedders and the final layer float). CLIP-L/G, the decoder and the
    tokenizers come from the previous SD3.5 path, and k's T5-XXL rides
    along unused (use_t5=False) for j; the previous MMDiT is freed first."""

    def build(gen, prev) -> DiffusionPipeline:
        t5, t5_tokenizer = prev.t5, prev.t5_tokenizer
        prev.mmdit = None
        gc.collect()
        torch.cuda.empty_cache()
        pipe = DiffusionPipeline(load=False, low_memory_mode=False, device="cuda",
                                 model_version=SD35_LARGE, use_t5=False, quantize_mmdit=mode)
        for name in ("clip_l", "clip_g", "decoder", "tokenizer_l", "tokenizer_g"):
            setattr(pipe, name, getattr(prev, name))
        pipe.t5, pipe.t5_tokenizer = t5, t5_tokenizer
        model = init_mmdit(SD3_8b, gen, "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with gptq_timed() as timed:
            pipe.mmdit = model
            torch.cuda.synchronize()
        phases = timed["phases"]
        wall = time.perf_counter() - t0
        del model
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        q = pipe.quantizer
        log(f"  SD3.5-large {mode}: quantizer {q['name']!r} in {q['seconds']!r} s (the setter "
            f"{wall!r} s); by phase {phases} ({sum(phases.values())!r} s timed; "
            f"{loop_note(timed)}); peak "
            f"{peak!r} GiB above the {base / 2**30!r} GiB allocated before it, "
            f"{torch.cuda.memory_allocated() / 2**30!r} GiB after [{card()}]")
        want = "gptq" if mode == "w4a8-mixed" else {"int8": "minmax"}.get(mode, mode)
        if q["name"] != want:
            raise AssertionError(f"SD3.5-large {mode}: quantizer {q['name']}, expected {want}")
        upcast_block_check(pipe.mmdit)
        wrong = [n for n, layer in block_linears(pipe.mmdit) if not quantized_as(mode, n, layer)]
        if wrong:
            raise AssertionError(f"SD3.5-large {mode}: block linears not in the mode's form: "
                                 f"{wrong[:6]}")
        if mode == "w4a8-mixed" and any(isinstance(m, (QuantizedLinear, W8A8Linear)) for m in (
                pipe.mmdit.context_embedder, pipe.mmdit.final_layer.ada,
                pipe.mmdit.y_embedder.fc1)):
            raise AssertionError("SD3.5-large w4a8-mixed: an embedder or the final layer packed")
        return pipe

    return build


def build_flux_dev(gen, prev: DiffusionPipeline) -> FluxPipeline:
    """Path j: FLUX.1-dev in bf16 (its guidance embedder) through
    FluxPipeline(model_version=FLUX.1-dev), T5 at the version's 512 tokens;
    path k's T5-XXL, CLIP-L, VAE decoder and tokenizers, whose SD3.5 is
    freed first."""
    prev.mmdit = None
    gc.collect()
    torch.cuda.empty_cache()
    pipe = FluxPipeline(load=False, low_memory_mode=False,
                        device="cuda", model_version=FLUX_DEV_VERSION)
    for name in ("t5", "clip_l", "decoder", "tokenizer_l"):
        setattr(pipe, name, getattr(prev, name))
    pipe.t5_tokenizer = SyntheticT5Tokenizer(max_length=pipe.t5_max_length)
    pipe.mmdit = init_mmdit(FLUX_DEV, gen, "cuda")
    if pipe.t5_max_length != 512 or pipe.mmdit.guidance_embedder is None:
        raise AssertionError("FLUX.1-dev: 512 T5 tokens and the guidance embedder expected")
    return pipe


# Path w's bf16 twin (its images and its float model) and its conversion's
# record, from build_flux_dev_gptq until flux_dev_gptq_checks reads them.
FLUX_DEV_TWIN: dict = {}


def build_flux_dev_gptq(gen, prev: FluxPipeline) -> FluxPipeline:
    """Path w: a float bf16 FLUX.1-dev at full width and FLUX_GPTQ_DEPTH
    blocks, drawn from its own seed, served first as it is through
    FluxPipeline(model_version=FLUX.1-dev) (its bf16 twin: j's pipeline on
    these weights), then written as FLUX.1-dev's file (the MLX namespace)
    under a temporary DIFFUSIONKIT_TPU_CKPT_DIR and loaded by
    FluxPipeline(model_version=FLUX.1-dev, quantize_mmdit="w4a8"), the
    pipelines' default GPTQ: request 0 reads the file and converts it
    (GPTQ, timed by phase; the quantized tree written to the cache),
    request 1, the MMDiT dropped, reads the cache. Both give the same packed
    state bit for bit; every block linear and the guidance embedder are
    w4a8. j's T5-XXL (512 tokens), CLIP-L, decoder and tokenizers; j's
    MMDiT is freed first. Returns the pipeline, its model resident."""
    cfg = dataclasses.replace(FLUX_DEV, depth_multimodal=FLUX_GPTQ_DEPTH[0],
                              depth_unified=FLUX_GPTQ_DEPTH[1])
    prev.mmdit = None
    gc.collect()
    torch.cuda.empty_cache()
    small = {name: getattr(prev, name)
             for name in ("t5", "clip_l", "decoder", "tokenizer_l", "t5_tokenizer")}
    float_model = init_mmdit(cfg, torch.Generator(device="cuda").manual_seed(FLUX_DEV_GPTQ_SEED),
                             "cuda")
    kw = dict(num_steps=FLUX_DEV_GPTQ.steps, cfg_weight=FLUX_DEV_GPTQ.cfg,
              latent_size=FLUX_DEV_GPTQ.latent, verbose=False)
    twin = FluxPipeline(load=False, low_memory_mode=False, device="cuda",
                        model_version=FLUX_DEV_VERSION)
    for name, value in small.items():
        setattr(twin, name, value)
    twin.mmdit = float_model
    twin_images = [np.asarray(twin.generate_image(text, seed=seed, **kw)[0])
                   for text, seed in FLUX_DEV_GPTQ.requests]
    twin.mmdit = None
    del twin
    quantizers, states, images, per = [], [], [], []
    saved_cfg = model_io.MMDIT_CONFIG[FLUX_DEV_VERSION]
    with tempfile.TemporaryDirectory(prefix="flux_dev_") as root:
        ckpt = os.path.join(root, FLUX_DEV_VERSION, model_io.MMDIT_CKPT[FLUX_DEV_VERSION])
        os.makedirs(os.path.dirname(ckpt))
        t0 = time.perf_counter()
        write_safetensors(ckpt, mlx_mmdit_ckpt(float_model))
        log(f"  float FLUX.1-dev ({cfg.depth_multimodal} + {cfg.depth_unified} blocks, hidden "
            f"{cfg.hidden_size}) served in bf16 (the twin) and written as "
            f"{model_io.MMDIT_CKPT[FLUX_DEV_VERSION]} ({os.path.getsize(ckpt) / 2**30!r} GiB) "
            f"in {time.perf_counter() - t0!r} s")
        model_io.MMDIT_CONFIG[FLUX_DEV_VERSION] = cfg  # the file's depth
        try:
            with gptq_timed() as timed, env_set("DIFFUSIONKIT_TPU_CKPT_DIR", root), \
                    env_set("DIFFUSIONKIT_TPU_CACHE_DIR", os.path.join(root, "cache")):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                pipe = FluxPipeline(load=False, low_memory_mode=False, device="cuda",
                                    model_version=FLUX_DEV_VERSION, quantize_mmdit="w4a8")
                for name, value in small.items():
                    setattr(pipe, name, value)
                for i, (text, seed) in enumerate(FLUX_DEV_GPTQ.requests):
                    if i:  # dropped: the second request loads it again, from the cache
                        pipe.mmdit = None
                        gc.collect()
                    reset_counts()
                    t0 = time.perf_counter()
                    pipe.check_and_load_models()
                    torch.cuda.synchronize()
                    load_s, q = time.perf_counter() - t0, pipe.quantizer
                    image, lg = pipe.generate_image(text, seed=seed, **kw)
                    torch.cuda.synchronize()
                    per.append(counts())
                    quantizers.append(q["name"])
                    images.append(np.asarray(image))
                    states.append({k: v.clone() for k, v in pipe.mmdit.state_dict().items()})
                    log(f"  request {i}: check_and_load_models() {load_s!r} s (the file or the "
                        f"cache, the conversion, the cache write): quantizer {q['name']!r} in "
                        f"{q['seconds']!r} s; then generate_image: capture "
                        f"{lg['denoising']['capture_time']!r} s, total {lg['total_time']!r} s "
                        f"[{card()}]")
                peak = (torch.cuda.max_memory_allocated() - base) / 2**30
                caches = sorted(pathlib.Path(root, "cache", "params").glob("*.safetensors"))
                cache_gib = [os.path.getsize(c) / 2**30 for c in caches]
        finally:
            model_io.MMDIT_CONFIG[FLUX_DEV_VERSION] = saved_cfg
        phases = timed["phases"]
    if quantizers != ["gptq", "cached"]:
        raise AssertionError(f"path w: quantizers {quantizers}, expected gptq then cached")
    if len(caches) != 1:
        raise AssertionError(f"path w: {len(caches)} cache files, expected one")
    if states[0].keys() != states[1].keys() or not all(
            torch.equal(states[0][k], states[1][k]) for k in states[0]):
        raise AssertionError("path w: the cached packed state is not the GPTQ one bit for bit")
    timed["steps"] = per[0]["gptq_group"]
    if per[0]["gptq_group"] == 0 or per[1]["gptq_group"] != 0:
        raise AssertionError(f"path w: group kernel launches {per[0]['gptq_group']} / "
                             f"{per[1]['gptq_group']}, expected some / none")
    model = pipe.mmdit
    linears = [getattr(blk, n) for blk in (*[b.img for b in model.mm_blocks],
                                            *[b.txt for b in model.mm_blocks], *model.uni_blocks)
               for n in ("q", "k", "v", "o", "fc1", "fc2", "ada")]
    linears += [model.guidance_embedder.fc1, model.guidance_embedder.fc2]
    if not all(isinstance(m, QuantizedLinear) and m.bits == 4 and m.wscale is not None
               for m in linears):
        raise AssertionError("path w: a block linear or the guidance embedder is not w4a8")
    log(f"  {FLUX_DEV_GPTQ.name}: quantizers gptq then cached, the cached packed state the GPTQ "
        f"one bit for bit, every block linear and the guidance embedder w4a8; GPTQ by phase "
        f"{phases} ({sum(phases.values())!r} s timed; {loop_note(timed)}), "
        f"{per[0]['gptq_group']} group steps; the "
        f"cache {cache_gib!r} GiB; peak {peak!r} GiB above the {base / 2**30!r} GiB allocated "
        f"before it [{card()}]")
    FLUX_DEV_TWIN.update(images=twin_images, float_model=float_model, gptq_images=images)
    return pipe


def flux_dev_gptq_checks(pipe: FluxPipeline, served: dict, tag: str) -> None:
    """Path w after its serve: its images are those of the conversion's two
    requests bit for bit (the model resident, then from the cache), each
    image's PSNR against the bf16 twin's on the same weights, and GPTQ's
    block-linear error at most 1.1x ALS's (``gptq_quality``, the GPTQ codes
    taken as int4: wscale dropped, as the ALS model has none)."""
    twin, float_model = FLUX_DEV_TWIN.pop("images"), FLUX_DEV_TWIN.pop("float_model")
    for i, (got, conv) in enumerate(zip(served["images"], FLUX_DEV_TWIN.pop("gptq_images"))):
        if not np.array_equal(got, conv):
            raise AssertionError(f"path w: request {i}'s image differs from the conversion "
                                 f"request's")
    psnr = [image_psnr(t.astype(np.float32), g.astype(np.float32))
            for t, g in zip(twin, served["images"])]
    log(f"  {FLUX_DEV_GPTQ.name}: images bit for bit those of the conversion's requests; PSNR "
        f"against the bf16 twin's images (the same float weights) {psnr!r} dB [{tag}]")
    int4 = copy.deepcopy(pipe.mmdit)
    for m in int4.modules():
        if isinstance(m, QuantizedLinear):
            m.wscale = None
    gptq_quality(float_model, int4, f"FLUX.1-dev ({FLUX_GPTQ_DEPTH[0]} + {FLUX_GPTQ_DEPTH[1]} "
                 f"blocks) int4 codes of its w4a8 GPTQ at group 32", tag)
    del int4, float_model
    gc.collect()
    torch.cuda.empty_cache()


def build_sd3_ring(gen, prev: DiffusionPipeline) -> DiffusionPipeline:
    """Path h: a's models (SD3-medium, CLIP-L/G, the VAE decoder and the
    tokenizers) behind DiffusionPipeline(sdpa_impl="ring",
    mesh=local_mesh()), a one-rank NCCL mesh."""
    mesh = local_mesh()
    log(f"  local_mesh(): {mesh}, backend {torch.distributed.get_backend()}")
    pipe = DiffusionPipeline(load=False, low_memory_mode=False,
                             device="cuda", use_t5=False, sdpa_impl="ring", mesh=mesh)
    for name in ("mmdit", "clip_l", "clip_g", "decoder", "tokenizer_l", "tokenizer_g"):
        setattr(pipe, name, getattr(prev, name))
    return pipe


def build_flux_ring(gen, prev: FluxPipeline) -> FluxPipeline:
    """Path g: c's models (the packed w4a8 MMDiT with its wscale, T5-XXL,
    CLIP-L, the VAE decoder) behind FluxPipeline(quantize_mmdit="w4a8",
    sdpa_impl="ring", mesh=local_mesh()), a one-rank NCCL mesh."""
    mesh = local_mesh()
    log(f"  local_mesh(): {mesh}, backend {torch.distributed.get_backend()}")
    pipe = FluxPipeline(load=False, low_memory_mode=False,
                        device="cuda", quantize_mmdit="w4a8", sdpa_impl="ring", mesh=mesh)
    for name in ("mmdit", "t5", "clip_l", "decoder", "tokenizer_l", "t5_tokenizer"):
        setattr(pipe, name, getattr(prev, name))
    return pipe


def profile_steps(pipe, path: Path, step_ms: float, loop_ms: float, tag: str) -> dict:
    """Phase 7: two denoise steps (the CUDA graph's replays) under
    torch.profiler: device-busy time per step by kernel family, the largest
    kernels outside the named families, and the idle share against the
    graph's ms/step (``step_ms``, a warm request's total / n) and the
    synced loop's (``loop_ms``); for FLUX the text encoding's device time
    too. If the profiler sees no kernel inside the replays, it says so and
    the synced loop's two steps are profiled instead."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    text = path.requests[0][0]
    with profile(activities=acts) as prof:
        cond, pooled = pipe.encode_text(text, path.cfg)
        torch.cuda.synchronize()
    if path.name.startswith("flux"):
        fams, _ = profile_step.device_split(prof, 1)
        log(f"  text encoding (T5-XXL + CLIP-L): device busy {sum(fams.values())!r} ms "
            f"{dict(sorted(fams.items()))} [{tag}]")
    what = "the CUDA graph's replays"
    for use_scan in (True, False):
        saved, pipe.use_scan = pipe.use_scan, use_scan
        try:
            with profile(activities=acts) as prof:
                _, it = pipe.denoise_latents(cond, pooled, num_steps=2, cfg_weight=path.cfg,
                                             latent_size=path.latent, seed=1)
                torch.cuda.synchronize()
        finally:
            pipe.use_scan = saved
        families, other = profile_step.device_split(prof, 2)
        if any(fam != "other" for fam in families):
            break
        log(f"  the profiler saw no kernel inside {what}: profiling the synced loop instead")
        what = "the synced loop"
    busy = sum(families.values())
    log(f"  {path.name} device busy {busy!r} ms/step ({what}): "
        f"{dict(sorted(families.items()))} [{tag}]")
    for ms, count, name in sorted(other, reverse=True)[:6]:
        log(f"    other: {ms!r} ms/step in {count} launches/step of {name[:90]}")
    categories = profile_step.by_category(prof, 2)
    log(f"  {path.name} by profile_step's categories: {categories} [{tag}]")
    profiled_ms = 1e3 * statistics.mean(it)
    log(f"  {path.name} idle share: {1 - busy / step_ms!r} at the graph's ms/step (a warm "
        f"request's total / n, {step_ms!r} ms, unprofiled); {1 - busy / loop_ms!r} at the "
        f"synced loop's median step of request 0 ({loop_ms!r} ms); "
        f"{1 - busy / profiled_ms!r} at the profiled "
        f"steps' own mean ({profiled_ms!r} ms, profiler overhead included) [{tag}]")
    return {"families": families, "categories": categories, "busy_ms": busy, "profiled": what,
            "idle_graph": 1 - busy / step_ms, "idle_loop": 1 - busy / loop_ms}


# The redesigned kernels, held to 0 spill bytes (and, with the rest, to no
# C7512, "wgmma serialized"): the d = 512 wgmma kernel and its merge, the
# 3xTF32 fp32 flash kernels, #14's 64-row kernel at d = 64, the Hopper main
# loops of E, C and #13, the M <= 16 GEMVs of C, #13, E and #11, the row
# kernels A', D and #4, #11's 64-deep Hopper loop, #10 and the GPTQ group
# step at every group size.
NO_SPILL = ("flash_fwd_wide_sm90", "flash_wide_merge", "flash_fwd_3xtf32", "flash_fwd_sm90_stats64",
            "w4a8_mm_sm90", "int4_mm_sm90", "int8_mm_sm90", "int4_gemv", "int8_gemv", "w4a8_gemv",
            "w8_gemv", "mod_ln_quant_kernel", "quantize_kernel", "gelu_quantize_kernel",
            "w8_mm_sm90_k64", "dequant_w8_kernel", "dequant_mm_3xtf32", "dequant_mm_f32",
            "gptq_group_kernel")
PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(path) -> None:
    """Phase 2: each kernel's registers and spill bytes from ptxas's report
    (``-Xptxas -v``, the build's log); raises on a C7512 warning anywhere or
    on a spill in a NO_SPILL kernel."""
    entry, spill = None, None
    bad = []
    for line in path.read_text().splitlines():
        if "C7512" in line:
            bad.append(line.strip())
        m = PTXAS_ENTRY.search(line)
        if m:
            entry = m.group(1)
            continue
        m = PTXAS_SPILL.search(line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = PTXAS_REGS.search(line)
        if m and entry:
            log(f"  ptxas: {entry}: {m.group(1)} registers, {spill} spill bytes")
            if spill and any(k in entry for k in NO_SPILL):
                bad.append(f"{entry} spills {spill} bytes")
            entry, spill = None, None
    if bad:
        raise AssertionError(f"ptxas: {bad}")
    log(f"  ptxas: no C7512; no spill in {', '.join(NO_SPILL)}")


# -- tensor and data parallelism: the two-pass quantizers, paths r1, r and s --

# The two-pass D and #4 at the shapes the sharded paths give them: D at the
# T5's wo input over two ranks (256 tokens x 10240 / 2) and FLUX's o input
# over two (the unified blocks' 4352 rows x 3072 / 2); #4 at SD3-medium
# w8a8's fc1 hidden over two (2048 image rows x 6144 / 2).
TWO_PASS_SHAPES = {"quantize": [(256, 5120), (4352, 1536)], "gelu_quantize": [(2048, 3072)]}
# D at path x's shapes: o's input over two ranks (SD3.5-large's 2432 / 2),
# the CFG batch's 8192 image rows and 308 text rows; drawn from a generator
# of their own, so the smoke's generator stays as it was.
X_TWO_PASS_SHAPES = [(8192, 1216), (308, 1216)]
TWO_PASS_FORM = {"quantize": None, "gelu_quantize": "erf"}
# r1: f's pipeline under a one-rank NCCL mesh (captured); r: f's models over
# a (1, 2) mesh of two gloo processes on the one card; s: over (2, 1), the
# image batch split; and SD3-medium w8a8's sharded forward, the path of #4's
# two-pass form.
FLUX_LOCAL_MESH = dataclasses.replace(FLUX_E2E, name="flux-w4a8-t5w8a8-local-mesh")
FLUX_TP = dataclasses.replace(FLUX_E2E, name="flux-w4a8-t5w8a8-tp2")
FLUX_DP = dataclasses.replace(FLUX_E2E, name="flux-w4a8-t5w8a8-dp2")
SD3_W8A8_TP = "sd3-w8a8-tp2"
# SD3-medium int4 and int8 weight-only (random packed block linears) over the
# same mesh: the row-parallel o and fc2 on C / #13's fp32 output.
SD3_WEIGHT_ONLY_TP = {4: "sd3-int4-tp2", 8: "sd3-int8-tp2"}
TP_RANKS = 2
# r against f: the batch limit of relative L2 (PERF.md section 2); the CPU
# tests hold the split w4a8 model within 1e-5 of the whole one in fp32, and
# in bf16 the fp32 sums of fc2's and the embedders' partials in another
# order flip roundings that four steps carry.
TP_RTOL = REF_RTOL


def two_pass_kernels(gen, tag: str):
    """The kernel phase of the two-pass D and #4: at each shape, the two
    passes on whole rows and over the row's two halves (two ranks' columns,
    their absmaxes combined by max on the card) against the one-pass kernel,
    bit for bit (x8 and xscale); both forms timed (``device_ms``) beside the
    plain version's, the function's bound and the form's floor by bytes
    (its second read of y counted too; ``device_ms`` leaves y in L2 where
    it fits, so a time may beat it)."""
    errs, times = {}, {}
    x_gen = torch.Generator(device="cuda").manual_seed(53)
    cases = [(name, shape, gen) for name, shapes in TWO_PASS_SHAPES.items() for shape in shapes]
    cases += [("quantize", shape, x_gen) for shape in X_TWO_PASS_SHAPES]
    for name, (m, k), g in cases:
        key, form = f"{name}[two-pass]", TWO_PASS_FORM[name]
        one_pass = quantize if form is None else (lambda y: gelu_quantize(y, "erf"))
        errs.setdefault(key, [])
        times.setdefault(key, [])
        y = (torch.randn(m, k, generator=g, device="cuda") * 2.0).to(torch.bfloat16)
        y[m // 3, k // 5] = 60.0  # an outlier sets one row's scale
        want = one_pass(y)
        got = quantize_amax(y, row_absmax(y, form), form)
        halves = [h.contiguous() for h in y.chunk(TP_RANKS, dim=-1)]
        amax = torch.stack([row_absmax(h, form) for h in halves]).amax(dim=0)
        split = [quantize_amax(h, amax, form) for h in halves]
        plain = quantize_amax_plain(y, row_absmax_plain(y, form), form)
        torch.cuda.synchronize()
        for label, x8, xs in (("whole rows", got.x8, got.xscale),
                              ("two halves", torch.cat([a.x8 for a in split], dim=-1),
                               split[0].xscale)):
            if not (torch.equal(x8, want.x8) and torch.equal(xs, want.xscale)):
                raise AssertionError(f"{key} {(m, k)} ({label}) differs from the one-pass "
                                     f"kernel")
        err = (plain.x8.int() - want.x8.int()).abs().max().item()
        if err != 0 or not torch.equal(plain.xscale, want.xscale):
            raise AssertionError(f"{key} {(m, k)}: the plain version differs from the "
                                 f"one-pass kernel ({err} int8 steps)")
        errs[key].append(float(err))
        ms = device_ms(lambda: quantize_amax(y, row_absmax(y, form), form))
        one_ms = device_ms(lambda: one_pass(y))
        plain_ms = device_ms(lambda: quantize_amax_plain(y, row_absmax_plain(y, form), form))
        # bf16 y read twice, x8 and the scales written once.
        floor_ms = 1e3 * (2 * 2 * m * k + m * k + 4 * m) / HBM
        t = timing(key, (m, k), ms, plain_ms, one_pass_ms=one_ms)
        times[key].append(t)
        log(f"  {key} {(m, k)}: bit-identical to the one-pass kernel on whole rows and over "
            f"two halves, as is the plain version; two-pass {ms!r} ms, one-pass {one_ms!r} ms, "
            f"plain {plain_ms!r} ms, {bound_note(t)}; the form's floor by bytes (a second "
            f"read) {floor_ms!r} ms [{tag}]")
    return errs, times


# (M, K, hidden) of the tiles route on path x: an FFN's fc1 over the CFG
# batch's 4096 image tokens at 1024² (M 8192), SD3.5-large's width and
# hidden, the hidden split over TP_RANKS ranks (4864 columns a rank: scale
# tile 9 straddles them) and over four (2432 a rank: tiles 4, 9 and 14).
TILE_SHAPES = [(8192, 2432, 9728)]
# Ranks the hidden is split over, and the rank timed at each: x's rank 0 (9
# whole tiles and one part), and over four rank 1 (4 whole tiles between
# two straddled parts).
TILE_SPLITS = {TP_RANKS: 0, 4: 1}


def tile_kernels(tag: str):
    """The kernel phase of gelu_quant[tiles]: E's fp32 mode-plain output of
    a random SD3.5-large fc1 split over 2 and 4 ranks' columns, the two
    passes on each rank's part (pass 1 0 in the tiles no rank boundary
    cuts; the absmaxes combined by max on the card) against E's gelu_quant
    on the whole hidden (its bytes side by side, its scales in each rank's
    tiles) bit for bit, as is the plain version; the two passes of one rank
    of each split timed (``device_ms``) beside the plain version's and the
    function's bound. Its inputs come from a generator of its own, so the
    smoke's generator, and so every later path's weights, stay as they
    were."""
    gen = torch.Generator(device="cuda").manual_seed(47)
    key = "gelu_quant[tiles]"
    errs, times = {key: []}, {key: []}
    for m, k, hidden in TILE_SHAPES:
        layer = random_w4a8(k, hidden, 64, gen)
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        xs = torch.rand(m, 1, generator=gen, device="cuda") * 0.02
        args = (x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, layer.bias.float())
        want8, want_s = w4a8_matmul(*args, mode="gelu_quant")
        y = w4a8_matmul(*args, out_dtype=torch.float32)
        tiles = hidden // 512
        for ranks, timed in TILE_SPLITS.items():
            n1 = hidden // ranks
            parts = [y[:, r * n1:(r + 1) * n1].contiguous() for r in range(ranks)]
            uncut = [t for t in range(tiles) if t not in straddled_tiles(hidden, ranks)]
            outs = {}
            for label, absmax, quant in (("kernels", tile_absmax, tile_quantize),
                                         ("plain version", tile_absmax_plain,
                                          tile_quantize_plain)):
                amaxes = [absmax(t, r * n1, tiles) for r, t in enumerate(parts)]
                if any(a[:, uncut].any() for a in amaxes):
                    raise AssertionError(f"{key}: the {label}'s pass 1 over {ranks} ranks is "
                                         f"not 0 in the tiles no rank boundary cuts")
                amax = torch.stack(amaxes).amax(0)
                outs[label] = [quant(t, amax, r * n1) for r, t in enumerate(parts)]
            torch.cuda.synchronize()
            for label, got in outs.items():
                if not torch.equal(torch.cat([a for a, _ in got], dim=-1), want8):
                    raise AssertionError(f"{key} {(m, k, hidden)} over {ranks} ranks: the "
                                         f"{label}'s bytes differ from E's gelu_quant")
                for r, (_, ys) in enumerate(got):
                    held = slice(r * n1 // 512, ((r + 1) * n1 - 1) // 512 + 1)
                    if not torch.equal(ys[:, held], want_s[:, held]):
                        raise AssertionError(f"{key} {(m, k, hidden)}: the {label}'s scales on "
                                             f"rank {r} of {ranks} differ from E's gelu_quant")
            err = (torch.cat([a for a, _ in outs["kernels"]], dim=-1).int()
                   - torch.cat([a for a, _ in outs["plain version"]], dim=-1).int()).abs().max()
            errs[key].append(float(err.item()))
            part, col0 = parts[timed], timed * n1
            local = (col0 + n1 - 1) // 512 - col0 // 512 + 1
            ms = device_ms(lambda: tile_quantize(part, tile_absmax(part, col0, tiles), col0))
            plain_ms = device_ms(lambda: tile_quantize_plain(
                part, tile_absmax_plain(part, col0, tiles), col0))
            t = timing(key, (m, n1, local), ms, plain_ms, library_ms=None)
            times[key].append(t)
            log(f"  {key} (M {m}, hidden {hidden} over {ranks} ranks, {n1} columns a rank): "
                f"the ranks' bytes side by side and their scales bit for bit E's gelu_quant on "
                f"the whole hidden, as the plain version's; rank {timed}'s two passes ({local} "
                f"tiles) {ms!r} ms, plain {plain_ms!r} ms, {bound_note(t)} [{tag}]")
            del parts, outs
        del layer, x8, y
    return errs, times


def local_mesh_path(pipe, tag: str) -> dict:
    """Path r1: f's request 0 through a copy of f's pipeline under
    ``local_mesh()`` (one NCCL rank) with the default dispatch: captured,
    its latents f's bit for bit with the same launches. Returns them."""
    want, f_ms, want_launches = denoise_request(pipe, FLUX_E2E, use_scan=True)
    r1 = copy.copy(pipe)
    r1.mesh = local_mesh()
    if any(hasattr(m, "tp") for m in r1.mmdit.modules()):
        raise AssertionError("r1: a one-rank mesh marked a split linear")
    denoise_request(r1, FLUX_LOCAL_MESH, use_scan=True)  # its capture
    got, ms, launches = denoise_request(r1, FLUX_LOCAL_MESH, use_scan=True)
    graphs = [sc.graph for key, sc in r1._scans.items() if key[3] == id(r1.mesh)]
    if not graphs or any(g is None for g in graphs):
        raise AssertionError("r1: the one-rank mesh's step was not captured")
    if launches != want_launches:
        diff = {k: (want_launches[k], launches[k]) for k in launches
                if launches[k] != want_launches[k]}
        raise AssertionError(f"r1: launches differ from f's (f, r1): {diff}")
    if not torch.equal(got, want):
        raise AssertionError(f"r1: latents differ from f's (max abs "
                             f"{(got - want).abs().max().item()!r})")
    log(f"  {FLUX_LOCAL_MESH.name}: captured under local_mesh(); latents f's bit for bit with "
        f"the same launches; {ms!r} ms/step (f: {f_ms!r}) [{tag}]")
    return launches


def _decoded_latents(pipe, run):
    """``run()``'s result and the latents the pipeline handed to its
    decoder."""
    seen = []
    decode = pipe._decode_batched_u8
    pipe._decode_batched_u8 = lambda latents: (seen.append(latents), decode(latents))[1]
    try:
        return run(), seen[0]
    finally:
        del pipe._decode_batched_u8


def tp_rank(rank: int, root: str) -> None:
    """One of the two gloo ranks of paths r and s (and SD3-medium w8a8's
    sharded forward) on the one card: the files ``tp_paths`` wrote, the
    results saved to ``root/rank{rank}.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = pathlib.Path(root)
    init_distributed(f"file://{root / 'rendezvous'}", TP_RANKS, rank, device="cuda",
                     backend="gloo")
    kernels.library()
    small = torch.load(root / "small.pt", weights_only=False)
    out = {}
    text, seed = FLUX.requests[0]
    kw = dict(num_steps=FLUX.steps, cfg_weight=FLUX.cfg, latent_size=FLUX.latent)

    # r: f's models split over a (1, 2) mesh, read to the host and sharded.
    mesh = create_mesh(1, TP_RANKS, device="cuda", backend="gloo")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = FluxPipeline(load=False, low_memory_mode=False, device="cuda", quantize_mmdit="w4a8",
                        quantize_t5=True, mesh=mesh)
    for name, value in small.items():
        setattr(pipe, name, value)
    pipe.t5 = model_io.load_t5_cache(root / "t5.safetensors", torch.bfloat16, device="cpu")
    pipe.mmdit = model_io.load_mmdit_cache(root / "mmdit.safetensors", FLUX_SCHNELL_VERSION,
                                           torch.bfloat16, device="cpu")
    gc.collect()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded = torch.cuda.memory_allocated() / 2**30
    reset_counts()
    collectives.stats.reset()
    t0 = time.perf_counter()
    cond, pooled = pipe.encode_text(text, FLUX.cfg)
    torch.cuda.synchronize()
    encode_s, t5_coll = time.perf_counter() - t0, collectives.stats.snapshot()
    collectives.stats.reset()
    t0 = time.perf_counter()
    latents, _ = pipe.denoise_latents(cond, pooled, seed=seed, **kw)
    torch.cuda.synchronize()
    denoise_s, step_coll = time.perf_counter() - t0, collectives.stats.snapshot()
    image = pipe.decode_latents_to_u8(latents).cpu().numpy()[0]
    log(f"  rank {rank}: r's request in {encode_s + denoise_s!r} s (T5 {encode_s!r} s)")
    out["r"] = {"latents": latents.cpu(), "t5": cond.cpu(), "image": image, "launches": counts(),
                "load_s": load_s, "loaded_gib": loaded, "encode_s": encode_s,
                "step_ms": 1e3 * denoise_s / FLUX.steps,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "t5_collectives": t5_coll, "step_collectives": step_coll}
    del pipe, cond, pooled, latents
    gc.collect()
    torch.cuda.empty_cache()

    # SD3-medium w8a8 (24 blocks, random w8a8 weights) over the same mesh:
    # one CFG forward at 512², the path of #4's two-pass form, against the
    # whole model on the same inputs.
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = init_mmdit(SD3_2b, gen, "cuda", quantize_bits="w8a8")
    inputs = (torch.randn(2, 64, 64, 16, generator=gen, device="cuda"),
              torch.randn(2, 154, 4096, generator=gen, device="cuda"),
              torch.randn(2, 2048, generator=gen, device="cuda"),
              torch.full((2,), 700.0, device="cuda"))
    # Block 0's image-stream o and fc2 at 512² CFG's rows, whole and split:
    # the int32 reduction and the two-pass D and #4 make the split product
    # the whole one bit for bit.
    block = model.mm_blocks[0].img
    o_whole, fc2_whole = copy.deepcopy(block.o), copy.deepcopy(block.fc2)
    x = torch.randn(2048, 1536, generator=gen, device="cuda").to(torch.bfloat16)
    h = torch.randn(2048, 6144, generator=gen, device="cuda").to(torch.bfloat16)
    # The float linears the plan splits (the t / y embedders' fc1 and fc2,
    # the final layer's ada), kept whole for a second sharded forward: the
    # split model's only steps that are not exact (fp32 sums in another
    # order, cuBLAS at another N).
    floats = ("t_embedder", "y_embedder", "final_layer")
    with torch.no_grad():
        want = model(*inputs)
        want_o, want_fc2 = linear(o_whole, x), linear(fc2_whole, gelu_quantize(h))
        whole = {name: copy.deepcopy(getattr(model, name)) for name in floats}
        shard_module_(model, mesh)
        reset_counts()
        got = model(*inputs, mesh=mesh)
        torch.cuda.synchronize()
        launches = counts()
        split = {name: getattr(model, name) for name in floats}
        for name in floats:
            setattr(model, name, whole[name])
        got_floats_whole = model(*inputs, mesh=mesh)
        for name in floats:
            setattr(model, name, split[name])
        grp = mesh.get_group("model")
        x_l, h_l = (t.chunk(TP_RANKS, dim=-1)[rank].contiguous() for t in (x, h))
        got_o = linear(block.o, x_l)
        got_fc2 = linear(block.fc2, quantize_two_pass(h_l, grp, "erf"))
    out["sd3"] = {"rel_l2": rel_l2(got, want), "launches": launches,
                  "finite": bool(torch.isfinite(got).all()),
                  "floats_whole_exact": torch.equal(got_floats_whole, want),
                  "floats_whole_rel_l2": rel_l2(got_floats_whole, want),
                  "rows_exact": torch.equal(got_o, want_o) and torch.equal(got_fc2, want_fc2)}
    del model, want, got, got_floats_whole, whole, split, block, o_whole, fc2_whole
    gc.collect()
    torch.cuda.empty_cache()

    sd3_weight_only_split(mesh, out)

    # s: f's models whole on each rank, the image batch over a (2, 1) mesh.
    mesh = create_mesh(TP_RANKS, 1, device="cuda", backend="gloo")
    pipe = FluxPipeline(load=False, low_memory_mode=False, device="cuda", quantize_mmdit="w4a8",
                        quantize_t5=True, mesh=mesh)
    for name, value in small.items():
        setattr(pipe, name, value)
    pipe.t5 = model_io.load_t5_cache(root / "t5.safetensors", torch.bfloat16, device="cuda")
    pipe.mmdit = model_io.load_mmdit_cache(root / "mmdit.safetensors", FLUX_SCHNELL_VERSION,
                                           torch.bfloat16, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    cond, pooled = pipe.encode_text(text, FLUX.cfg)
    latents, _ = pipe.denoise_latents(cond, pooled, seed=seed, num_images=TP_RANKS, **kw)
    pixels = pipe.decode_latents_to_u8(latents).cpu().numpy()
    texts, seeds = (list(v) for v in zip(*FLUX.requests))
    images, batched = _decoded_latents(pipe, lambda: pipe.generate_images_batched(
        texts, seeds=seeds, **kw))
    torch.cuda.synchronize()
    out["s"] = {"latents": latents.cpu(), "pixels": pixels, "batched_latents": batched.cpu(),
                "batched": np.stack([np.asarray(im) for im in images]), "launches": counts(),
                "seconds": time.perf_counter() - t0}
    torch.save(out, root / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def sd3_weight_only_split(mesh, out: dict) -> None:
    """In a rank of ``tp_rank``: SD3-medium int4 and int8 (24 blocks, random
    packed block linears at group 64) over ``mesh``: one CFG forward at 512²
    against the whole model, each rank's o and fc2 partials from C / #13 in
    fp32, summed and rounded once; then the same split forward with those
    partials rounded to bf16 before the sum (the form before that repair,
    kept here only as a measurement). Into ``out`` by path name."""
    for bits in SD3_WEIGHT_ONLY_TP:
        gen = torch.Generator(device="cuda").manual_seed(6 + bits)
        model = init_mmdit(SD3_2b, gen, "cuda", quantize_bits=bits)
        inputs = (torch.randn(2, 64, 64, 16, generator=gen, device="cuda"),
                  torch.randn(2, 154, 4096, generator=gen, device="cuda"),
                  torch.randn(2, 2048, generator=gen, device="cuda"),
                  torch.full((2,), 700.0, device="cuda"))
        with torch.no_grad():
            want = model(*inputs)
            shard_module_(model, mesh)
            reset_counts()
            got = model(*inputs, mesh=mesh)
            torch.cuda.synchronize()
            launches = counts()
            with bf16_rounded_partials():
                old = model(*inputs, mesh=mesh)
        out[SD3_WEIGHT_ONLY_TP[bits]] = {
            "rel_l2": rel_l2(got, want), "old_rel_l2": rel_l2(old, want), "launches": launches,
            "finite": bool(torch.isfinite(got).all())}
        del model, want, got, old
        gc.collect()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def bf16_rounded_partials():
    """Row-parallel int4 / int8 linears as they were before their partial
    products were summed in fp32: ``ops/common``'s C and #13 calls asked for
    x's dtype, so each rank's partial is rounded to bf16 before the fp32
    sum."""
    saved = common_ops.int4_matmul, common_ops.int8_matmul

    def rounded(fn):
        return lambda x, qw, scales, zeros, out_dtype=None: fn(x, qw, scales, zeros)

    common_ops.int4_matmul, common_ops.int8_matmul = (rounded(fn) for fn in saved)
    try:
        yield
    finally:
        common_ops.int4_matmul, common_ops.int8_matmul = saved


def tp_paths(pipe, served: dict, scratch: str, tag: str) -> dict:
    """Paths r and s (and SD3-medium w8a8's sharded forward): f's models
    written once (the quantized-model cache format; CLIP-L, the decoder and
    the tokenizers pickled), two gloo ranks of this script started on the one
    card (``tp_rank``), and their results held against f's: r's two ranks
    agree bit for bit, r's latents within TP_RTOL relative L2 of f's and
    its T5 output f's bit for bit, each rank's peak memory below f's; s's
    images, latents and pixels bit for bit the one-rank run in chunks of one
    image (DIFFUSIONKIT_TPU_DENOISE_BATCH=1). Returns each path's
    launches."""
    root = pathlib.Path(scratch) / "tp"
    root.mkdir()
    t0 = time.perf_counter()
    model_io.save_module_cache(pipe.mmdit, root / "mmdit.safetensors")
    model_io.save_module_cache(pipe.t5, root / "t5.safetensors")
    torch.save({name: getattr(pipe, name) for name in ("clip_l", "decoder", "tokenizer_l",
                                                        "t5_tokenizer")}, root / "small.pt")
    write_s = time.perf_counter() - t0
    # f's references: request 0's T5 output and latents, and s's chunks of one.
    text, seed = FLUX.requests[0]
    kw = dict(num_steps=FLUX.steps, cfg_weight=FLUX.cfg, latent_size=FLUX.latent)
    cond, pooled = pipe.encode_text(text, FLUX.cfg)
    texts, seeds = (list(v) for v in zip(*FLUX.requests))
    with env_set(SPLIT_ENV, "1"):
        lat_s, _ = pipe.denoise_latents(cond, pooled, seed=seed, num_images=TP_RANKS, **kw)
        pix_s = pipe.decode_latents_to_u8(lat_s).cpu().numpy()
        imgs_b, lat_b = _decoded_latents(pipe, lambda: pipe.generate_images_batched(
            texts, seeds=seeds, **kw))
    imgs_b = np.stack([np.asarray(im) for im in imgs_b])
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card
    t0 = time.perf_counter()
    res = spawn_ranks(["--tp-rank"], TP_RANKS, root)
    ranks_s = time.perf_counter() - t0
    log(f"  f's models written in {write_s!r} s; two gloo ranks ran r, SD3-medium w8a8's "
        f"forward and s in {ranks_s!r} s")

    r0, r1 = res[0]["r"], res[1]["r"]
    if not (torch.equal(r0["latents"], r1["latents"]) and np.array_equal(r0["image"],
                                                                         r1["image"])):
        raise AssertionError("r: the two ranks' latents or images differ")
    f_lat, f_t5 = served["latents"].cpu(), cond.cpu()
    rl, rt = rel_l2(r0["latents"], f_lat), rel_l2(r0["t5"], f_t5)
    pix = np.abs(r0["image"].astype(int) - served["image"].astype(int))
    log(f"  {FLUX_TP.name}: both ranks' latents and images bit for bit; latents relative L2 "
        f"{rl!r} against f's (tolerance {TP_RTOL}), the T5 output {rt!r} (bit for bit: "
        f"{torch.equal(r0['t5'], f_t5)}); the image against f's: max {pix.max()} levels, "
        f"{(pix > 0).mean()!r} of the pixels moved")
    if not rl < TP_RTOL:
        raise AssertionError(f"r: the latents are off f's by more than {TP_RTOL}")
    # The split T5 sums its row-parallel products in int32 and quantizes them
    # with the whole rows' scales; every other step is per head or column.
    if not torch.equal(r0["t5"], f_t5):
        raise AssertionError("r: the T5 output is not f's bit for bit")
    for r, rr in enumerate((r0, r1)):
        log(f"  {FLUX_TP.name} rank {r}: models read and sharded in {rr['load_s']!r} s "
            f"({rr['loaded_gib']!r} GiB on the card); T5 encode {rr['encode_s']!r} s; "
            f"{rr['step_ms']!r} ms/step (4 steps, uncaptured, the schedule's total / n); "
            f"peak memory {rr['peak_gib']!r} GiB (f: {served['peak']!r}) [{tag}]")
        if not rr["peak_gib"] < served["peak"]:
            raise AssertionError(f"r: rank {r}'s peak memory is not below f's")
    for label, coll, n in (("a denoise step", r0["step_collectives"], FLUX.steps),
                           ("the T5 encode", r0["t5_collectives"], 1)):
        per = {k: {"calls": v["calls"] / n, "elements": v["elements"] / n,
                   "seconds": v["seconds"] / n} for k, v in coll.items()}
        log(f"  {FLUX_TP.name} rank 0, collectives of {label}: {per} [{tag}]")
    launches = r0["launches"]
    rows = FLUX.steps * (2 * FLUX_SCHNELL.depth_multimodal + FLUX_SCHNELL.depth_unified) \
        + 2 * T5_LAYERS
    want = {"int8_dot": rows, "quantize[two-pass]": rows, "int4_matmul": 0}
    for name in ("w4a8_matmul[gelu_quant]", "w4a8_matmul[grouped_xs]", "w4a8_matmul[norm_rope]",
                 "w4a8_matmul[gemv]", "w4a8_matmul[mat]", "dequant_w8", "w8_matmul", "quantize",
                 "mod_ln_quantize", "flash_attention_bshd", "mod_ln"):
        if launches[name] == 0:
            raise AssertionError(f"r: {name} was launched no time")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"r: {name} launched {launches[name]} times, expected {n}")
    log(f"  {FLUX_TP.name} launches (rank 0): {launches}")

    sd3 = [rr["sd3"] for rr in res]
    log(f"  {SD3_W8A8_TP}: the sharded forward against the whole model, relative L2 "
        f"{[x['rel_l2'] for x in sd3]!r} (tolerance {TWIN_RTOL}); with the split float "
        f"linears (the t / y embedders, the final layer's ada) whole: relative L2 "
        f"{[x['floats_whole_rel_l2'] for x in sd3]!r}, bit for bit "
        f"{[x['floats_whole_exact'] for x in sd3]}; block 0's o and fc2 split "
        f"(two-pass D / #4, #16, the int32 sum) bit for bit the whole ones: "
        f"{[x['rows_exact'] for x in sd3]}; launches (rank 0) {sd3[0]['launches']}")
    # Every split w8a8 step is exact (int32 sums, the whole rows' scales,
    # per-head attention), so with the float linears whole the forward is
    # the whole model's bit for bit; the float linears' fp32 sums in another
    # order move the last bits of the conditioning, which 24 random blocks
    # carry as a batch's other GEMM M does (TWIN_RTOL).
    if not all(x["finite"] and x["rel_l2"] < TWIN_RTOL and x["rows_exact"]
               and x["floats_whole_exact"] for x in sd3):
        raise AssertionError("SD3-medium w8a8 sharded forward off the whole model's")
    if sd3[0]["launches"]["gelu_quantize[two-pass]"] == 0:
        raise AssertionError("SD3-medium w8a8 sharded forward ran no two-pass #4")
    # Each split o and fc2 of a block (the last block's text stream has
    # neither): 4 a dual block, 2 in the last, on C / #13's fp32 output.
    rows = 4 * (SD3_2b.depth_multimodal - 1) + 2
    for bits, name in SD3_WEIGHT_ONLY_TP.items():
        got = [rr[name] for rr in res]
        key = f"int{bits}_matmul[f32out]"
        log(f"  {name}: the sharded forward against the whole model, relative L2 "
            f"{[x['rel_l2'] for x in got]!r} (tolerance {TP_RTOL}); with the partials rounded to "
            f"bf16 before the sum (the form before the repair) {[x['old_rel_l2'] for x in got]!r}; "
            f"{key} launches (rank 0) {got[0]['launches'][key]} (expected {rows}); launches "
            f"{got[0]['launches']} [{tag}]")
        if not all(x["finite"] and x["rel_l2"] < TP_RTOL for x in got):
            raise AssertionError(f"{name}: the sharded forward is off the whole model's")
        if got[0]["launches"][key] != rows:
            raise AssertionError(f"{name}: {key} launched {got[0]['launches'][key]} times, "
                                 f"expected {rows}")

    for r, rr in enumerate(res):
        s_ = rr["s"]
        if not (torch.equal(s_["latents"], lat_s.cpu()) and np.array_equal(s_["pixels"], pix_s)
                and torch.equal(s_["batched_latents"], lat_b.cpu())
                and np.array_equal(s_["batched"], imgs_b)):
            raise AssertionError(f"s: rank {r}'s images differ from the chunks of one")
    log(f"  {FLUX_DP.name}: both ranks return both images of num_images={TP_RANKS} and of "
        f"generate_images_batched({len(texts)} prompts), latents and pixels bit for bit the "
        f"one-rank run in chunks of one; {res[0]['s']['seconds']!r} s on rank 0 [{tag}]")
    return {FLUX_TP.name: launches, SD3_W8A8_TP: sd3[0]["launches"],
            FLUX_DP.name: res[0]["s"]["launches"],
            **{name: res[0][name]["launches"] for name in SD3_WEIGHT_ONLY_TP.values()}}


@contextlib.contextmanager
def recorded_routes(model: torch.nn.Module):
    """The routes ``ops/common`` dispatches ``model``'s linears to while
    it is on, and the kernels each launched: yields (seen, launched).
    ``seen`` is a set of (attribute, layout, route) from each
    ``linear_route`` call (layout "whole" for an unsplit linear) and
    ("ffn", fc1's attribute, route) from each ``ffn_route`` call;
    ``launched`` maps (attribute, layout) of a linear, and ("ffn", fc1's
    attribute) of a "tiles" FFN, to the launch counts (``counts``) made
    inside its calls."""
    names = {id(m): n.rsplit(".", 1)[-1] for n, m in model.named_modules()}
    seen, launched = set(), {}
    wrapped = ("linear_route", "ffn_route", "_whole_linear", "_row_linear", "_w4a8_ffn_tiles")
    originals = {name: getattr(common_ops, name) for name in wrapped}

    def layout(layer):
        tp = getattr(layer, "tp", None)
        return tp.kind if tp is not None else "whole"

    def recorded_linear(layer):
        route = originals["linear_route"](layer)
        seen.add((names.get(id(layer), "?"), layout(layer), route))
        return route

    def recorded_ffn(fc1, fc2):
        route = originals["ffn_route"](fc1, fc2)
        seen.add(("ffn", names.get(id(fc1), "?"), route))
        return route

    def counted(name, key):
        def run(layer, *args, **kw):
            before = counts()
            y = originals[name](layer, *args, **kw)
            after = counts()
            launched.setdefault(key(layer), collections.Counter()).update(
                {k: n - before[k] for k, n in after.items() if n != before[k]})
            return y
        return run

    linear_key = lambda layer: (names.get(id(layer), "?"), layout(layer))  # noqa: E731
    common_ops.linear_route, common_ops.ffn_route = recorded_linear, recorded_ffn
    common_ops._whole_linear = counted("_whole_linear", linear_key)
    common_ops._row_linear = counted("_row_linear", linear_key)
    common_ops._w4a8_ffn_tiles = counted("_w4a8_ffn_tiles",
                                         lambda fc1: ("ffn", names.get(id(fc1), "?")))
    try:
        yield seen, launched
    finally:
        for name, fn in originals.items():
            setattr(common_ops, name, fn)


def sd35_meta(mode) -> MMDiT:
    """SD3.5-large at full width and depth on ``meta``, packed for ``mode``
    (4, or "w4a8" with a wscale), for ``parallel.sharding.off_kernel``."""
    with torch.device("meta"):
        model = MMDiT(SD3_8b, quantize_bits=4)
        if mode == "w4a8":
            for layer in model.modules():
                if isinstance(layer, QuantizedLinear):
                    layer.wscale = torch.empty(layer.out_features)
    return model


def unseen_routes(entries, seen: set, gathered: bool) -> list:
    """The ``off_kernel`` entries ("name: layout, route[, FFN unfused][,
    heads gathered]") that a run's ``recorded_routes`` did not see taken;
    ``gathered``: whether the attention gathered its heads."""
    missing = []
    for entry in entries:
        attr, rest = entry.split(": ", 1)
        layout, route, *flags = rest.split(", ")
        ok = (attr, layout, route) in seen
        if "FFN unfused" in flags:
            ok = ok and any(s[0] == "ffn" and s[1] == attr and s[2] != "fused" for s in seen)
        if "heads gathered" in flags:
            ok = ok and gathered
        if not ok:
            missing.append(entry)
    return missing


def sd35_tp_rank(rank: int, world: int, root: str) -> None:
    """One of the gloo ranks of path x (``world`` 2: i's SD3.5-large w4a8
    request over create_mesh(1, 2), from the cache file ``sd35_tp_paths``
    wrote) or x4 (``world`` 4: one CFG forward of a cut SD3.5-large int4
    over create_mesh(1, 4) against the unsharded forward, the model drawn
    from one seed on every rank) on the one card; the results saved to
    ``root/rank{rank}.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = pathlib.Path(root)
    init_distributed(f"file://{root / 'rendezvous'}", world, rank, device="cuda",
                     backend="gloo")
    kernels.library()
    mesh = create_mesh(1, world, device="cuda", backend="gloo")
    torch.cuda.reset_peak_memory_stats()
    if world == 2:
        t0 = time.perf_counter()
        pipe = DiffusionPipeline(load=False, low_memory_mode=False, device="cuda",
                                 model_version=SD35_LARGE, use_t5=False, quantize_mmdit="w4a8",
                                 mesh=mesh)
        for name, value in torch.load(root / "small.pt", weights_only=False).items():
            setattr(pipe, name, value)
        pipe.mmdit = model_io.load_mmdit_cache(root / "sd35.safetensors", SD35_LARGE,
                                               torch.bfloat16, device="cpu")
        gc.collect()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        text, seed = SD35_TP.requests[0]
        cond, pooled = pipe.encode_text(text, SD35_TP.cfg)
        kw = dict(num_steps=SD35_TP.steps, cfg_weight=SD35_TP.cfg, latent_size=SD35_TP.latent,
                  seed=seed)
        reset_counts()
        collectives.stats.reset()
        # The two-pass quantizer's calls by (rows, K, dtype, form).
        two_pass = collections.Counter()
        two_pass_fn = common_ops.quantize_two_pass

        def counting(y, group, form=None):
            k = y.shape[-1]
            two_pass[(y.numel() // k, k, str(y.dtype).removeprefix("torch."), form)] += 1
            return two_pass_fn(y, group, form)

        common_ops.quantize_two_pass = counting
        try:
            with recorded_routes(pipe.mmdit) as (seen, launched):
                t0 = time.perf_counter()
                latents, _ = pipe.denoise_latents(cond, pooled, **kw)
                torch.cuda.synchronize()
                denoise_s = time.perf_counter() - t0
        finally:
            common_ops.quantize_two_pass = two_pass_fn
        model = pipe.mmdit
        out = {"latents": latents.cpu(), "load_s": load_s,
               "step_ms": 1e3 * denoise_s / SD35_TP.steps, "two_pass_shapes": dict(two_pass)}
    else:
        cfg = dataclasses.replace(SD3_8b, depth_multimodal=X4_DEPTH,
                                  hidden_size_override=SD3_8b.hidden_size,
                                  upcast_multimodal_blocks=X4_UPCAST)
        gen = torch.Generator(device="cuda").manual_seed(44)
        model = init_mmdit(cfg, gen, "cuda", quantize_bits=4)
        inputs = (torch.randn(2, *X4_LATENT, 16, generator=gen, device="cuda"),
                  torch.randn(2, 154, 4096, generator=gen, device="cuda"),
                  torch.randn(2, 2048, generator=gen, device="cuda"),
                  torch.full((2,), 700.0, device="cuda"))
        with torch.no_grad():
            want = model(*inputs)
            shard_module_(model, mesh)
            reset_counts()
            collectives.stats.reset()
            with recorded_routes(model) as (seen, launched):
                t0 = time.perf_counter()
                got = model(*inputs, mesh=mesh)
                torch.cuda.synchronize()
        out = {"rel_l2": rel_l2(got, want), "finite": bool(torch.isfinite(got).all()),
               "forward_s": time.perf_counter() - t0}
    out.update(launches=counts(), collectives=collectives.stats.snapshot(),
               collective_sizes={k: dict(v) for k, v in collectives.stats.sizes.items()},
               seen=seen,
               route_launches={key: dict(c) for key, c in launched.items()},
               holds_heads=model.mm_blocks[0].img.holds_heads(model.config.head_dim),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"  rank {rank} of {world}: done")
    torch.save(out, root / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def spawn_ranks(args, world: int, root: pathlib.Path, timeout: int = 600) -> list:
    """``world`` processes of this script, rank r given ``args`` then r and
    ``root``, on the one card; waits for them (killing any left), echoes
    their ``  rank`` lines, fails on a rank's failure and returns each
    rank's ``root/rank{r}.pt``."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args, str(r),
                               str(root)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} failed (exit {p.returncode}):\n"
                                 f"{out[-6000:]}")
        for line in out.splitlines():
            if line.startswith("  rank"):
                log(line)
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]


def sd35_tp_paths(pipe: DiffusionPipeline, scratch: str, tag: str) -> dict:
    """Paths x and x4 (module docstring) after i: i's request 0 at
    SD35_TP.steps steps unsharded (the reference), i's MMDiT written in the
    cache format and CLIP-L/G with their tokenizers pickled, two gloo ranks
    of this script for x and four for x4 (``sd35_tp_rank``). x: both ranks'
    latents bit for bit, within TP_RTOL relative L2 of the reference; x4:
    each rank's split forward within TP_RTOL of the whole one. Each route
    ``off_kernel`` lists for the mode and rank count seen taken
    (``recorded_routes``), and the kernels those routes reach launched
    (the launch counters). Returns each path's launches (rank 0)."""
    root = pathlib.Path(scratch) / "sd35_tp"
    root.mkdir()
    want, want_ms, _ = denoise_request(pipe, SD35_TP, use_scan=True)
    t0 = time.perf_counter()
    model_io.save_module_cache(pipe.mmdit, root / "sd35.safetensors")
    torch.save({name: getattr(pipe, name) for name in ("clip_l", "clip_g", "tokenizer_l",
                                                        "tokenizer_g")}, root / "small.pt")
    write_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card
    out = {}
    for world, name, mode in ((2, SD35_TP.name, "w4a8"), (4, SD35_TP4, 4)):
        gc.collect()
        torch.cuda.empty_cache()
        sub = root / f"tp{world}"
        sub.mkdir()
        if world == 2:
            (sub / "sd35.safetensors").symlink_to(root / "sd35.safetensors")
            (sub / "small.pt").symlink_to(root / "small.pt")
        t0 = time.perf_counter()
        res = spawn_ranks(["--sd35-rank", str(world)], world, sub)
        ranks_s = time.perf_counter() - t0
        r0 = res[0]
        entries = off_kernel(sd35_meta(mode), world)
        missing = unseen_routes(entries, r0["seen"], not r0["holds_heads"]
                                and r0["collectives"].get("all_gather", {}).get("calls", 0) > 0)
        launches = r0["launches"]
        log(f"  {name}: {world} gloo ranks in {ranks_s!r} s; off_kernel(SD3.5-large {mode}, "
            f"{world}) lists {entries}; seen taken: "
            f"{sorted(s for s in r0['seen'] if s[1] != 'whole')}; launches (rank 0) {launches}; "
            f"collectives (rank 0) {r0['collectives']}; peak GiB a rank "
            f"{[rr['peak_gib'] for rr in res]!r} [{tag}]")
        if missing:
            raise AssertionError(f"{name}: off-kernel routes not taken: {missing}")
        if world == 2:
            if not all(torch.equal(rr["latents"], r0["latents"]) for rr in res):
                raise AssertionError("x: the two ranks' latents differ")
            rl = rel_l2(r0["latents"], want)
            log(f"  {name}: i's request 0 at {SD35_TP.steps} steps (of i's {SD35.steps}), CFG "
                f"{SD35_TP.cfg}, 1024²; i's MMDiT written in {write_s!r} s, read and sharded in "
                f"{[rr['load_s'] for rr in res]!r} s; {[rr['step_ms'] for rr in res]!r} ms/step "
                f"(uncaptured, the schedule's total / n; i unsharded {want_ms!r}); both ranks' "
                f"latents bit for bit, relative L2 {rl!r} against i's unsharded latents "
                f"(tolerance {TP_RTOL}; bit for bit: {torch.equal(r0['latents'], want.cpu())}) "
                f"[{tag}]")
            if not rl < TP_RTOL:
                raise AssertionError(f"x: the latents are off i's by more than {TP_RTOL}")
            # The max all-reduces: one value a row for o's input (the
            # two-pass D) and for each scale tile the ranks share in the
            # tiles route, none for the tiles a rank holds whole.
            maxes = r0["collectives"]["all_reduce_max"]
            shared = straddled_tiles(SD3_8b.mlp_ratio * SD3_8b.hidden_size, world)
            by_size = r0["collective_sizes"]["all_reduce_max"]
            log(f"  {name}: max all-reduces a step (rank 0): {maxes['calls']} calls, "
                f"{maxes['elements']} elements, {maxes['seconds']!r} s; calls by elements "
                f"{by_size}; the tiles route's straddled tiles {shared}; the two-pass quantizer's "
                f"calls by (rows, K, dtype, form) {r0['two_pass_shapes']} [{tag}]")
            rows = 2 * (SD35_TP.latent[0] // 2) * (SD35_TP.latent[1] // 2)  # CFG's image rows
            if max(by_size) > rows * len(shared):
                raise AssertionError(f"{name}: a max all-reduce carried more than one value a "
                                     f"row and straddled tile: {by_size}")
            # q/k/v and o off E's shapes: E's arithmetic on #10's grid and
            # #16 (o's input by the two-pass D); the FFN off E's fused modes
            # ("tiles": the fused pair's arithmetic over the scale tile the
            # two ranks share): fc1 on E's mode plain (#10 then #11, fp32
            # out), its GELU and int8 hidden by gelu_quant[tiles], fc2's tile
            # parts on #10's grid and #16; the fused modes and #4 never.
            need = ("w4a8_matmul[mat]", "dequant_w8", "w8_matmul", "w8_matmul[f32]",
                    "quantize[two-pass]", "int8_dot", "w4a8_matmul[gemv]",
                    "flash_attention_bshd", "gelu_quant[tiles]")
            never = ("w4a8_matmul[gelu_quant]", "w4a8_matmul[grouped_xs]",
                     "w4a8_matmul[norm_rope]", "gelu_quantize", "gelu_quantize[two-pass]")
            # Each off-kernel route's own calls launched its kernels.
            by_route = {entry: r0["route_launches"].get(
                (entry.split(": ")[0], entry.split(": ")[1].split(", ")[0]), {})
                for entry in entries if "dequant_linear" in entry}
            by_route["ffn: tiles"] = r0["route_launches"].get(("ffn", "fc1"), {})
            want_route = {entry: ("dequant_w8", "int8_dot") for entry in by_route}
            want_route["ffn: tiles"] = ("w4a8_matmul[mat]", "gelu_quant[tiles]", "dequant_w8",
                                        "int8_dot")
            log(f"  {name}: launches inside each off-kernel route's calls (rank 0): "
                f"{by_route} [{tag}]")
            for entry, kinds in want_route.items():
                short = [k for k in kinds if by_route[entry].get(k, 0) == 0]
                if short:
                    raise AssertionError(f"{name}: {entry} launched no {short}")
        else:
            rls = [rr["rel_l2"] for rr in res]
            log(f"  {name}: one CFG forward at {8 * X4_LATENT[0]}² of SD3.5-large int4 "
                f"({X4_DEPTH} blocks, block {X4_UPCAST[0]} fp32, full width) over "
                f"create_mesh(1, 4): relative L2 "
                f"against the unsharded forward {rls!r} (tolerance {TP_RTOL}); "
                f"{[rr['forward_s'] for rr in res]!r} s a forward [{tag}]")
            if not all(rr["finite"] and rr["rel_l2"] < TP_RTOL for rr in res):
                raise AssertionError("x4: the split forward is off the whole one")
            # o gathered onto C (its bf16 and fp32 forms), heads gathered.
            need, never = ("int4_matmul", "int4_matmul[f32]", "mod_ln"), ()
        for k in need:
            if launches[k] == 0:
                raise AssertionError(f"{name}: {k} was launched no time")
        for k in never:
            if launches[k] != 0:
                raise AssertionError(f"{name}: {k} launched {launches[k]} times, expected none")
        out[name] = launches
    return out




def main() -> None:
    log("phase 1: card")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")
    tag = card()
    log(f"  {tag}")
    # Every checkpoint the smoke loads is a file it writes itself (under
    # ``scratch``): no loader may reach for the hub.
    os.environ["HF_HUB_OFFLINE"] = "1"
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    log("phase 2: build")
    t0 = time.perf_counter()
    kernels.library()
    log(f"  {kernels.library_path().name}: built and loaded in {time.perf_counter() - t0!r} s")
    ptxas_report(kernels.library_path().with_suffix(".log"))

    gen = torch.Generator(device="cuda").manual_seed(0)
    mod, flash, int4 = kernel_inputs(gen)
    log("phase 3: kernels against their plain versions (bf16 vs fp32 math)")
    errs = check_kernels(mod, flash, int4)
    log("phase 4: kernel device times (20 calls per CUDA graph, median of 5 replays)")
    times = time_kernels(mod, flash, int4, tag)
    del mod, flash, int4
    torch.cuda.empty_cache()
    err, t = flash_long(gen, tag)
    errs["flash_attention_bshd"].append(err)
    times["flash_attention_bshd"].append(t)
    vae_2048 = flash_vae_2048(gen, tag)
    errs["flash_attention_bshd"].append(vae_2048["flash_attention_bshd"][0])
    times["flash_attention_bshd"].append(vae_2048["flash_attention_bshd"][1])
    log("phase 3-4b: the w4a8 kernels against their plain versions on the card, their device "
        "times, and mode plain's two dataflows at the paths' shapes and off them")
    w_errs, w_times = w4a8_kernels(gen, tag)
    errs.update(w_errs)
    times.update(w_times)
    torch.cuda.empty_cache()
    log("phase 3-4c: the w8a8 and int8 kernels (gelu_quantize, w8_matmul, int8_matmul, and "
        "quantize on wide rows) against their plain versions on the card, and their device times")
    w_errs, w_times = w8a8_kernels(gen, tag)
    for name in w_errs:
        errs.setdefault(name, []).extend(w_errs[name])
        times.setdefault(name, []).extend(w_times[name])
    torch.cuda.empty_cache()
    log("phase 3-4d: the (B, H, S, D) flash kernels (flash_attention, flash_attention_stats) "
        "against their plain versions on the card, their device times, and the 4-rank ring's "
        "chunks merged on one card")
    w_errs, w_times = bhsd_kernels(gen, tag)
    errs.update(w_errs)
    times.update(w_times)
    errs["flash_attention"].append(vae_2048["flash_attention"][0])
    times["flash_attention"].append(vae_2048["flash_attention"][1])
    ring_combine_checks(gen)
    torch.cuda.empty_cache()
    log("phase 3-4d, fp32: kernel B, flash_attention and flash_attention_stats on fp32 inputs "
        "against their fp32 plain versions on the card, and their device times")
    w_errs, w_times = fp32_flash_kernels(gen, tag)
    for name in w_errs:
        errs[name].extend(w_errs[name])
        times[name].extend(w_times[name])
    torch.cuda.empty_cache()
    log("phase 3-4e: dequant_w8 (#10) and int8_dot (#16) against their plain versions on the "
        "card, #10 then #11 against kernel E, their device times; the two tool paths")
    w_errs, w_times = w8_tool_kernels(gen, tag)
    errs.update(w_errs)
    times.update(w_times)
    launches = tool_paths(tag)
    torch.cuda.empty_cache()
    log("phase 3-4f: SD3.5-large's kernels: C and #13 on fp32 x, kernel E with an fp32 bias and "
        "output, and every kernel of the SD3.5 paths at the 19 x 128 widths, against their "
        "plain versions on the card, and their device times")
    sd35_f32_kernels(gen, tag, errs, times)
    sd35_width_kernels(gen, tag, errs, times)
    torch.cuda.empty_cache()
    log("phase 3-4g: the GPTQ group kernel against its plain version inside whole GPTQs, and "
        "its device times")
    w_errs, w_times = gptq_kernel_phase(gen, tag)
    errs.update(w_errs)
    times.update(w_times)
    torch.cuda.empty_cache()

    log("phase 3-4h: the two-pass D and #4 (rows split over tensor-parallel ranks) against "
        "their one-pass kernels on the card, and both forms' device times; E's gelu_quant "
        "over scale tiles split between ranks against E's on the whole hidden")
    w_errs, w_times = two_pass_kernels(gen, tag)
    errs.update(w_errs)
    times.update(w_times)
    w_errs, w_times = tile_kernels(tag)
    errs.update(w_errs)
    times.update(w_times)
    torch.cuda.empty_cache()
    log("phase 3-4i: C and #13 with an fp32 output (a row-parallel linear's partial product) "
        "against their plain versions and their bf16 form on the card, and their device times")
    w_errs, w_times = f32out_kernels(gen, tag)
    errs.update(w_errs)
    times.update(w_times)
    torch.cuda.empty_cache()

    log("phase 5: reference checks")
    reference_checks(gen)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 5, Autoencoder: the generic SD autoencoder through model_io.load_autoencoder")
    launches["autoencoder"] = autoencoder_check(gen, scratch.name, tag)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 5, loading: an F16 file cast on the card, and the 4-bit releases' packed final "
        "layer (N = 64) on the dequantise path")
    f16_cast_check(scratch.name)
    packed_final_layer_check(gen)
    torch.cuda.empty_cache()
    log(f"phase 5, T5 outlier A/B: tools/t5_outlier_ab.run, T5-XXL (random weights at HF T5's "
        f"scales) with {t5_outlier_ab.N_OUT} residual channels x{t5_outlier_ab.FACTOR}, w8a8 "
        f"with and without the SmoothQuant fold against bf16")
    t0 = time.perf_counter()
    ab = t5_outlier_ab.run(device="cuda")
    log(f"  encoder-output SNR on the non-outlier channels: w8a8 plain {ab['w8a8_plain']!r} dB, "
        f"smoothed {ab['w8a8_smooth']!r} dB, margin {ab['margin_db']!r} dB (gate 3 dB, the JAX "
        f"package's tests/test_smoothquant.py); on all channels {ab['w8a8_plain_all_channels']!r}"
        f" / {ab['w8a8_smooth_all_channels']!r} dB; {time.perf_counter() - t0!r} s [{tag}]")
    if not ab["margin_db"] >= 3.0:
        raise AssertionError(f"T5 outlier A/B: the fold's margin {ab['margin_db']} dB is under 3")
    gc.collect()
    torch.cuda.empty_cache()

    families, walls = {}, {}
    pipe = None
    # h reuses a's models, d and e a's encoders and decoder, c b's, g c's
    # models, f g's (f converts the T5 to w8a8 in place, so g, with the bf16
    # T5, comes first).
    plan = (("a", SD3, build_sd3, False), ("h", SD3_RING, build_sd3_ring, True),
            ("d", SD3_W8A8, build_sd3_quantized("w8a8"), True),
            ("e", SD3_INT8, build_sd3_quantized("int8"), True), ("b", FLUX, build_flux, False),
            ("c", FLUX_W4A8, build_flux_w4a8, True), ("g", FLUX_RING, build_flux_ring, True),
            ("f", FLUX_E2E, build_flux_e2e, True), ("i", SD35, build_sd35("w4a8"), True),
            ("i'", SD35_4BIT, build_sd35("4bit"), True), ("k", SD35_T5, build_sd35(None), True),
            ("t", SD35_W4A8_MIXED, build_sd35_converted("w4a8-mixed"), True),
            ("u", SD35_INT8, build_sd35_converted("int8"), True),
            ("v", SD35_W8A8, build_sd35_converted("w8a8"), True),
            ("j", FLUX_DEV_PATH, build_flux_dev, True),
            ("w", FLUX_DEV_GPTQ, build_flux_dev_gptq, True))
    for letter, path, build, reuse in plan:
        if not reuse:
            pipe = None
            gc.collect()
            torch.cuda.empty_cache()
        log(f"phase 6{letter}: main path {path.name} ({path.latent[0] * 8}², "
            f"{path.steps} steps, CFG {path.cfg}, random weights)")
        t0 = time.perf_counter()
        pipe = build(gen, pipe)
        torch.cuda.synchronize()
        log(f"  random {path.name} models on the card in {time.perf_counter() - t0!r} s, "
            f"{torch.cuda.memory_allocated() / 2**30!r} GiB allocated")
        served = serve(pipe, path, tag)
        launches[path.name] = served["launches"]
        log(f"phase 7{letter}: where a {path.name} step's device time goes (torch.profiler)")
        families[path.name] = profile_steps(pipe, path, served["step_ms"], served["loop_ms"], tag)
        walls[path.name] = (served["step_ms"], served["loop_ms"])
        if path is FLUX_DEV_GPTQ:
            log(f"phase 6w, checks: {path.name} against its bf16 twin, and GPTQ against ALS")
            flux_dev_gptq_checks(pipe, served, tag)
        if path is SD35:
            log(f"phase 6x/6x4: main paths {SD35_TP.name} (i's models over create_mesh(1, 2)) "
                f"and {SD35_TP4} (SD3.5-large int4 over create_mesh(1, 4)), gloo processes on "
                f"the one card")
            launches.update(sd35_tp_paths(pipe, scratch.name, tag))
        if path is FLUX_E2E:
            log(f"phase 6q: main path {FLUX_SERVE.name}: path f's pipeline behind "
                f"GenerationServer(max_batch=8) on an HTTP server at 127.0.0.1 in this process "
                f"({8 * FLUX_SERVE.latent[0]}², {FLUX_SERVE.steps} steps, CFG {FLUX_SERVE.cfg})")
            launches[FLUX_SERVE.name] = http_path(pipe, served["launches"], tag)
            log(f"phase 6r1: main path {FLUX_LOCAL_MESH.name}: f's request 0 under "
                f"FluxPipeline(mesh=local_mesh()), one NCCL rank, captured")
            launches[FLUX_LOCAL_MESH.name] = local_mesh_path(pipe, tag)
            log(f"phase 6r/6s: main paths {FLUX_TP.name} (f's models over create_mesh(1, 2)) and "
                f"{FLUX_DP.name} (over create_mesh(2, 1)), two gloo processes on the one card")
            launches.update(tp_paths(pipe, served, scratch.name, tag))
        if path in (SD3, FLUX_W4A8):
            log(f"phase 6{letter}, batch: generate_image(num_images={NUM_IMAGES}) and "
                f"generate_images_batched on {path.name}'s models")
            serve_batch(pipe, path, served["latents"], tag)
        if path is SD3:
            log(f"phase 6a': main path {SD3_BHSD.name} (path a's request 0 under "
                f"{LAYOUT_ENV}=bhsd)")
            bhsd = serve_bhsd(pipe, served["image"], tag)
            launches[SD3_BHSD.name], families[SD3_BHSD.name] = bhsd["launches"], bhsd["families"]
            walls[SD3_BHSD.name] = (bhsd["step_ms"], bhsd["loop_ms"])
            log("phase 6a'': path a's request 0 latents decoded by DiffusionPipeline(a16=False)")
            launches["sd3-decode-fp32"] = decode_fp32(pipe, served["latents"], tag)
        img2img = {SD3.name: SD3_IMG2IMG, FLUX_W4A8.name: FLUX_IMG2IMG}.get(path.name)
        if img2img is not None:
            side = 8 * img2img.latent[0]
            log(f"phase 6{'l' if img2img is SD3_IMG2IMG else 'm'}: main path {img2img.name} "
                f"({side}², {img2img.steps} steps at denoise {DENOISE[img2img.name]}, CFG "
                f"{img2img.cfg}, path {letter}'s models, the encoder from a file)")
            source = served["images"][1 if img2img is SD3_IMG2IMG else 0]
            done = img2img_path(pipe, img2img, source, gen, scratch.name, tag)
            launches[img2img.name] = done["launches"]
            walls[img2img.name] = (done["step_ms"], done["loop_ms"])
        loaded = {SD3.name: ("n", loaded_sd3_path, SD3_LOADED),
                  FLUX.name: ("o", loaded_flux_path, FLUX_LOADED)}.get(path.name)
        if loaded is not None:
            mark, run, lpath = loaded
            log(f"phase 6{mark}: main path {lpath.name}: path {letter}'s requests, every model "
                f"loaded from files written from path {letter}'s models")
            done = run(pipe, served, scratch.name, tag)
            launches[lpath.name] = done["launches"]
            walls[lpath.name] = (statistics.median(done["replay_ms"]), None)
            if "p" in done:
                launches[SD3_GPTQ.name] = done["p"]["launches"]
                walls[SD3_GPTQ.name] = (statistics.median(done["p"]["replay_ms"]), None)
            launches.update(done.get("t", {}))
        twin = {SD3_RING.name: SD3_RING_TWIN, FLUX_RING.name: FLUX_RING_TWIN}.get(path.name)
        if twin is not None:
            log(f"phase 6{letter}': {path.name}'s request 0 through the default dispatch")
            launches[twin.name] = flash_twin(pipe, path, twin, served["latents"],
                                             served["step_ms"], tag)
        del served
    for name, (graph_ms, loop_ms) in walls.items():
        if name not in families:  # the img2img paths: not profiled
            log(f"  {name}: graph {graph_ms!r} ms/step, loop {loop_ms!r} ms/step [{tag}]")
            continue
        prof = families[name]
        log(f"  {name}: graph {graph_ms!r} ms/step, loop {loop_ms!r} ms/step, busy "
            f"{prof['busy_ms']!r} ms/step ({prof['profiled']}), idle {prof['idle_graph']!r} "
            f"(graph) / {prof['idle_loop']!r} (loop) [{tag}]")
    log(f"  elementwise 'other' per FLUX step: w4a8 "
        f"{families['flux-w4a8']['families']['other']!r} ms, "
        f"int4 {families['flux']['families']['other']!r} ms (the int4 path's fp32 bias and "
        f"QK-norm+RoPE chains ride kernel E's epilogues on the w4a8 path) [{tag}]")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    summary = []
    for name, (source, replaces) in KERNELS.items():
        first = times[name][0]  # the main path's first shape
        main_path = MAIN_PATH.get(name, FLUX_W4A8.name)
        if launches[main_path][name] == 0:
            raise AssertionError(f"{name} was launched no time on its main path {main_path}")
        summary.append({
            "name": name, "route": "cuda", "source": source, "symbol": SYMBOLS[name],
            "replaces": replaces,
            **OTHER_SOURCES.get(name, {}),
            "launches": launches[main_path][name], "launches_path": main_path,
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": max(errs[name]),
            "ms": first["ms"], **({"ms_warm": first["warm_ms"]} if "warm_ms" in first else {}),
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first.get("library_ms"),
            "shape": first["shape"], "shapes": times[name],
        })
    scratch.cleanup()
    log(f"  the whole smoke: {time.perf_counter() - STARTED!r} s, the kernels' build included "
        f"[{tag}]")
    log(tag)
    log(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:  # a rank of paths r and s, started by tp_paths
        tp_rank(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--sd35-rank"]:  # a rank of paths x and x4, by sd35_tp_paths
        sd35_tp_rank(int(sys.argv[3]), int(sys.argv[2]), sys.argv[4])
    else:
        main()

"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile the engine's CUDA kernels from ``csrc/`` (timed), with
   ptxas's registers and spills per kernel instance and the attention
   kernel's resident blocks an SM at each built (seq, head_dim);
3. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the main path gives it (layer 0 of BERT-base at B=128,
   S=128): max level difference, mismatches, kernel / plain / bound ms,
   and for the matmul ``torch._int_mm`` ms (the int32 product only),
   TOP/s and the share of the int8 peak, and its ms per layer against
   ``torch._int_mm`` on the same four products; then
   the composed chains against their plain versions; then the kernels'
   other built shapes (the matmul on ragged tiles, M = 8, N = 200 and
   K = 784 over every activation and output; the attention through
   ``int8_attention`` at every built (seq, head_dim), B = 1, 7 and 133,
   skip_max both ways, a fully padded row, saturating, fractional and
   large shifts (``attention_cases``); add+LN at H=256). Every
   comparison must be bit-identical;
4. main path at full BERT-base width: random init from ``--seed``,
   one-batch W8A8 calibration, int8 packing, the engine plan, and three
   request batches (B=128, S=128, seeded padding) through
   ``bert_engine_apply``; launch counts per forward, logits against the
   same engine on the plain versions (rtol 1e-3 / atol 2e-3), and engine
   / fake-quant simulation / bf16 dense seq/s as the median and range of
   five host-clock windows of at least one second each;
5. the flex kernels, per recipe (``w8a8-mixed``: 16-bit x/h/y sites,
   ``w8a8-peg``: 6 permuted groups with shared-h ranges), on layer 0's
   inputs: the float-edge inter matmul (K4: the whole call, then its
   level pass alone and its GEMM alone, each with its bound), the dense
   matmul's fold on the h grid, the two flex add+LNs, then the flex
   ``int8_attn_ln`` and ``int8_ffn_ln`` chains, each against its plain
   version (bit-identical); then K4 at ``EDGE_SHAPES`` (M = 1000, N = 136:
   8-bit edges in 1, 2 and 6 permuted groups, in groups of 64 and 256
   columns; 16-bit edges in one group at K = 1024 and in 2 and 3 groups)
   and ``EDGE_TILE_SHAPES`` (M = 16350: the grouped folds over 512 tiles)
   and K5 at H=256; then the add+LN kernels (K3, K5, ``fused_add_ln``,
   all instances of ``csrc/add_ln.cuh``) at every built H (128..1024)
   and M = 999 and 16384, res_quant both ways, over every form (payload
   or float32 residual; 8-bit, 16-bit or per-column sites; payload, value
   or both out), and at saturating scales with float32 outliers up to
   +-3e38, outliers with no res site, and shifts off the integers
   (``check_ln_shapes``), bit-identical;
6. each recipe's engine, from the same ``--seed`` params: calibration with
   the PEG pre-pass, three request batches through ``bert_engine_apply``
   with the launch counts read just after (per forward 36 matmul, 12
   attention, 12 float-edge matmul and 12 level-pass, 24 flex add+LN
   launches), logits against the plain engine, the forward / encoder
   split, engine and fake-quant simulation seq/s (five windows);
6b. the JAX CLI's PTQ recipes as it defines them (``CAL.CLI_RECIPES``:
   MSE golden-section weight ranges, current-minmax act ranges, one
   calibration sequence), from the same ``--seed`` params: ``w8a8``,
   ``w8a8-mixed`` and ``w8a8-peg`` each calibrated on the card (seconds;
   ``w8a8`` also on the CPU, its weight ranges held card against CPU by
   the MSE tolerance: scales within rtol 1e-5, else the card's float64
   loss no more than 1e-6 relative above the CPU's), packed, planned and
   driven with three request batches through ``bert_engine_apply``
   (launches read just after, logits against the plain engine) and
   engine seq/s (five windows); then one MSE-grid per-channel weight
   calibration (layer 0's inter weight, card and CPU, timed, the grid
   rule) and the STS-B variant's ``MSE_logits`` classifier site
   (its recipe calibrated on the card, and the site's nested
   golden-section search alone, timed);
7. MobileBERT-uncased (24 layers, H=512, bottleneck 128, 4 heads of 32,
   3 stacked FFNs, relu, NoNorm): random init from ``--seed``, one-batch
   W8A8 calibration, packing, the engine plan; on layer 0's inputs (B=128,
   S=128) the int8 matmul with relu and the [q|k] / v matmuls,
   ``int8_matmul_norm`` with and without a residual (128- and 512-wide
   outputs), ``int8_attention_qkv`` at head_dim 32 and the whole-layer
   ``int8_mb_layer_ln`` against their plain versions, and the layer
   kernel against the chain of the other three, at every seq it is built
   for (B = 128 at S = 128, 64 and 32: kernel, chain and plain ms); then
   their other shapes (K6 with and without a residual at
   ``NORM_SHAPES``: ragged M, N % 16 != 0, three column tiles ragged in
   every dimension, a partial last column tile at M = 16384; K7 through
   ``int8_attention_qkv`` on ``attention_cases`` in two layouts,
   MobileBERT's [q|k] + v at cols (0, 1, 0) and three arrays of distinct
   row strides at (1, 2, 0); K8 with the 'bottleneck' attention case at
   each built seq, and at ``MB_CASES`` on seeded plans: ragged batches,
   both attention cases, the integer and the general path, skip_max both
   ways, and one or two sequences, the serving buckets' smallest). Every
   comparison must be bit-identical;
8. MobileBERT's main path: the plan's layer route by seq (the layer
   kernel at each seq it is built for, ``EK.MB_LAYER_SHAPES``, the chain
   elsewhere); three request batches through ``mobilebert_engine_apply``
   on the default route (24 launches of the layer kernel per forward),
   on the chain route (``fuse_layer=False``: 144 matmul, 192
   NoNorm-matmul and 24 attention launches), and at S = 64 and 32 on the
   default route (the plan's), each with the counts read just after and
   logits against the plain engine; the forward / encoder split of both
   routes, engine seq/s on each route and at S = 64 and 32, and
   fake-quant simulation seq/s (five windows);
9. the leave-one-out FP32 kernels, on BERT-base's layer-0 inputs: the
   generic int path's fused linear on the calls one W8A8 forward makes
   (q with a float32 x, attn_out, inter with gelu emitting the payload,
   dense on the payload, the pooler at M = B) and on ``{'x': 'fp32'}``'s
   dense (a float32 x of K=3072), a ragged M and symmetric input / output
   sites; its quantize pass alone on the float32 x of q and of that
   dense; its A-S erf's branch-free reciprocal against the IEEE quotient
   on every float32 in [1, 2^126]; the edges the GEMM's TMA loads
   zero-fill (M = 8, N = 200, K = 784, each on a float32 x and on a
   payload, over every activation and output); ``fused_add_ln`` (both
   add+LNs) and the matmul's fold / float outputs on layer 0 of the
   ``{'h': 'fp32'}`` engine. Every comparison must be bit-identical;
10. the leave-one-out routes: three request batches through
   ``bert_apply(fused_linear=True)`` under W8A8 (73 fused linears per
   forward, 61 of them on a float32 x, so 61 quantize passes) and
   ``{'x': 'fp32'}`` (61 and 61), and through ``bert_engine_apply``
   under ``{'h': 'fp32'}`` (the non-payload route: 48 matmul, 12
   attention, 24 ``fused_add_ln`` launches), each with the counts read
   just after and logits against the same path on the plain versions;
   seq/s of the generic path on the fused linear and on the int path,
   of the ``{'h': 'fp32'}`` engine (with its forward / encoder split) and
   its fake-quant simulation (five windows).

11. serving: phase 4's BERT-base and phase 7's MobileBERT-uncased W8A8
   calibrations written as checkpoint directories (``save_checkpoint``)
   and served by ``build_engine_from_checkpoint(dir, device='cuda')``
   with the JAX bench's settings (seq buckets 32 / 64 / 128, batch
   buckets 8 / 32 / 64, max_batch 64, a 2 ms wait, pipeline depth 5, the
   fused transfer): the nine buckets captured largest first, one CUDA
   graph each, with the launch counts read over the captures (the eager
   warm-up and the capture: twice a forward's a bucket); at every bucket
   and at B = 1 and 2 the graph replay equal to the eager forward bit
   for bit and the eager forward within the logit tolerance of the
   plain versions', graph and eager ms at the bench's buckets (five
   windows of >= 0.25 s); the closed loop (512 requests of seeded
   lengths 8-127 at concurrency 64: seq/s, tokens/s, latency p50 / p99,
   average batch) on the graphs with no launch outside them, every served
   batch equal to the eager forward on it and every request to its row;
   for BERT-base the same loop on the eager forward (its launches read
   just after) and the HTTP front end (``make_server`` on a free
   localhost port: three /classify answers equal ``classify()`` bit for
   bit, /metrics, /healthz), and ``precompile=False`` (the JAX default)
   on a fresh ``BucketGraphs``: 15 bursts of requests of new shapes,
   each captured on first use on the scheduler thread while the
   resolver copies the batch before, every batch and request checked
   as above. Then two more BERT-base checkpoints: the W8A8 one served
   with ``bf16=True`` (the engine at ``engine_dtype`` bfloat16) and one
   written without quant state, which the server sends to the generic
   fallback (the float model, its attention in bfloat16: no kernel of the
   port's runs there): the route each is served by, the launches over
   the nine captures, and at every bucket the graph replay equal to the
   eager forward bit for bit and within the logit tolerance of the plain
   versions' (untimed).
12. W4A8 (split-half packed int4 weights): BERT-base from ``--seed``'s
   params calibrated with current-minmax 4-bit symmetric weights and
   8-bit activations, packed int4 (``build_bert_int_params(use_int4=
   True)``) and planned (every matmul's ``w4`` flag set), with the packed
   encoder weights' bytes beside W8A8's; K1's packed-int4 instance on
   layer 0's four matmuls at B=128, S=128 (M = 16384) and on their first
   256 rows (the (8, 32) serving bucket's M), each bit-identical to its
   plain version and to K1 int8 on the unpacked weight, with w4, K1 int8,
   plain and ``torch._int_mm`` (on the unpacked weight) ms and the bound
   (the weight at K/2 bytes a row); the fused linear's packed-int4
   instance on the int4 calls of one W4A8 generic forward (q, attn_out,
   inter, dense, the pooler), bit-identical to its plain version and to
   the int8 kernel on the unpacked weight; both at ragged shapes (M = 8,
   N = 200, K = 800 and 864, whose last packed box TMA zero-fills) over
   every activation and output; K = 784 raising in K1's wrapper and
   declined by the fused linear; then three request batches through
   ``bert_engine_apply`` (48 w4 matmul, 12 attention, 24 add+LN launches a
   forward) and ``bert_apply(fused_linear=True)`` (73 w4 fused linears,
   61 quantize passes), each with the counts read just after and logits
   against the same path on the plain versions, and engine and generic
   seq/s (five windows).
13. QAT: the JAX CLI's ``qat-w4a8`` recipe (``CAL.CLI_RECIPES`` /
   ``TT.QAT_RECIPES``) at BERT-base width and depth, both dropouts 0, from
   ``--seed``'s params on synthetic RTE examples (``utils/glue.py`` through
   the hash tokenizer, 128 tokens): calibration (MSE golden-section 4-bit
   weights, one padded batch of 16); the int8 QAT forward's 74 products a
   forward, recorded on one training batch, with layer 0's four and the
   classifier's (M = 8, N = 2, zero-padded) ``torch._int_mm`` products
   equal to the exact plain product bit for bit; 40 optimizer steps of
   ``TT.train`` at B = 8 on the int8 forward and 20 on the float
   fake-quant forward (ms a step as the median of steps 10-40 / 10-20 on
   the host clock, the first and last loss, the range entries that moved
   and their largest relative change); then the learned ranges merged,
   packed int4 and planned: K1 w4 (layer 0's four matmuls), K2 and K3
   (both add+LNs) against their plain versions bit for bit, three request
   batches through ``bert_engine_apply`` (48 / 12 / 24 launches a forward,
   logits against the plain engine); the W4A8 engine, the int8 QAT
   forward and the float fake-quant forward on 128 synthetic RTE
   examples drawn as the calibration examples are, with the share of
   their logits at an end of the learned classifier.out grid, compared
   with that site off by the route-ratio rule (``route_gaps``: the
   engine's gaps within ``ROUTE_RATIO`` times the int8 forward's gap to
   the fake-quant forward; a compared logit at an end of the grid agrees
   across routes whatever came before, and at most ``ROUTE_MAX_CLIPPED``
   may); and engine seq/s.
14. AdaRound: the JAX CLI's ``w4-adaround`` recipe (``CAL.
   ADAROUND_RECIPES``) at BERT-base width and depth from ``--seed``'s
   params on synthetic RTE examples, cut to ``ADAROUND_SAMPLES`` samples
   and ``ADAROUND_ITERS`` iterations a layer (each cut printed beside the
   preset's value): the 4-bit MSE-grid weight calibration, AdaRound over
   all 102 layer specs with the optimizer loop held to never wait on the
   host (``torch.cuda.set_sync_debug_mode('error')``), the capture
   seconds, ms an iteration by layer shape (the median from iteration
   ``ADAROUND_TIMED_FROM``), the full preset's time extrapolated (an
   estimate), the layers whose hard local loss fell, the W4A32 accuracy
   on the fake-quant forward (``adaround_multi_eval``); then post_adaround
   8-bit asymmetric act ranges on one batch of 16 trimmed to its real
   length (the recipe's ``est_pad=False``), the alphas packed as
   int8 storage of their 4-bit levels (each equal to its hard-alpha
   fake-quant weight bit for bit) and planned: K1, K2 and K3 on layer 0
   against their plain versions bit for bit, three request batches
   through ``bert_engine_apply`` (48 / 12 / 24 launches a forward, logits
   against the plain engine), the gaps between the engine, the generic
   int path and the hard-alpha fake-quant forward by the rule the JAX
   package's routes keep at 12 layers (``route_gaps``, ``ROUTE_RATIO``
   from tests/test_torch_adaround_depth.py: the engine's gaps within
   that many times the generic int path's, and the AdaRound model's
   within that many times the nearest-rounding model's), and engine
   seq/s.
15. the BERT-shaped families at their published base configurations
   (``FAMILY_MODELS``: RoBERTa-base, DistilBERT-base-uncased, 6 layers,
   ALBERT-base-v2, one shared layer applied 12 times on 128-wide
   factorized embeddings, SqueezeBERT-uncased, groups 4/4/4/1/4/4): random
   init from ``--seed`` through the registry's ``build_model``, one-batch
   W8A8 calibration (B = 8), the family's engine plan (ALBERT's layers on
   one weight storage, SqueezeBERT's grouped kernels densified
   block-diagonal); on request batches (B = 128, S = 128, seeded padding,
   pads carrying the pad id) K1 / K2 / K3 on layer 0 bit-identical to
   their plain versions, with K1's device ms on the four matmuls; three
   request batches through the family's ``engine_apply`` (4L / L / 2L
   launches a forward) and through its generic int path on the fused
   linear, each against the same path on the plain versions; the engine,
   the generic int path and the fake-quant forward by the route-ratio
   rule; engine seq/s (five windows); the phase's seconds. Then the
   registry's two large presets at their published widths and depth
   (``LARGE_MODELS``: BERT-large-uncased and ALBERT-large-v2, H = 1024,
   16 heads of 64, I = 4096, 24 layers; ALBERT's one shared layer applied
   24 times): the same init, calibration and plan, K1 / K2 / K3 on layer
   0 bit-identical with K1's device ms, three request batches through the
   engine (96 / 24 / 48 launches a forward, logits against the plain
   engine) and engine seq/s; no generic path.

16. leave-one-out: the engine's float edges at BERT-base width and depth
   (``FLOAT_EDGE_CONFIGS``: quant_dict ``{'s': 'fp32'}``, ``{'p':
   'fp32'}``, ``{'c': 'fp32'}``, ``{'s': 16, 'p': 16}``, ``{'c': 16}``,
   ``{'z': 16}``, ``{'L': 16}``, and global W8A16 and W8A6), from
   ``--seed``'s params, each calibrated on one batch (B = 8) with
   ``calibrated_bert(quant_dict=...)``, packed and planned; on one request
   batch (B = 128, S = 128) every call the engine makes to the new
   kernels is recorded (``record_calls``) and each distinct form, layer
   0's first, held against its plain version on those inputs: the
   attention's second kernel (``int8_attention_flex``: disabled, 16-bit
   and sub-8 scores / probs / context sites, the value-space form), the
   float-edge matmul's fold and float epilogues (K4; the float one off
   the path, on the 16-bit context's inputs) and the float x int8 matmul
   (K9; its fold and float epilogues off the path): the integer forms
   bit-identical, the float-dot forms (float64 sums) within one level or
   one float32 ulp on at most ``TIE_FRAC`` of the elements; kernel, plain
   and library ms and the bound; then three request batches through
   ``bert_engine_apply`` per configuration (``float_edge_launches`` a
   forward, logits against the plain engine) and engine seq/s beside
   W8A8's (five windows of >= 0.5 s). Before the configurations, both
   redesigned kernels off the main path's shapes: the attention's second
   kernel on both routes (``EK.attn_flex_route``) at every
   ``EK.ATTN_SHAPES`` x ``ATTN_BATCHES`` x skip_max for one form of each
   route class (``FLEX_FORMS``) and with the 'saturate', 'fractional' and
   'big_shift' scalars at seq 128 (``check_flex_attention_shapes``: the
   integer route bit-identical, the float64 one within the ties), and K9
   at ragged M and N, K = 16 and ``EK.FI_MAX_K``, with every epilogue
   (``check_float_int8_shapes``).
17. the inference options at BERT-base width and depth, from ``--seed``'s
   params (W8A8, ``{'h': 'fp32'}`` and ``w8a8-mixed`` calibrated on one
   batch of 8): the kernels' new forms on the calls the options' forwards
   make on layer 0 (B = 128, S = 128), each against its plain version:
   K1's inter matmul with the A-S gelu and the degree-10 polynomial
   (``gelu_impl`` 'exact' / 'poly') and tanh, and its bfloat16 fold and
   float outputs (the non-payload route's attn_out and dense at
   ``engine_dtype`` bfloat16); K4 with the three activations on the mixed
   recipe's inter call and its bfloat16 fold / float outputs; K9 with the
   three activations and bfloat16 outputs on a seeded float x against
   layer 0's inter weight (off every path; within the float64 ties);
   ``fused_add_ln``'s bfloat16 form (both add+LNs of the bf16 non-payload
   route); the fused linear on a bfloat16 x (q, attn_out, inter of the
   generic bf16 path) and with ``gelu_poly10``; kernel, plain and library
   ms and the bound. Then three request batches through each option's
   forward (``option_forwards``: W8A8 at ``gelu_impl`` 'exact' and 'poly',
   W8A8, ``{'h': 'fp32'}`` and ``w8a8-mixed`` (with 'exact') at
   ``engine_dtype`` bfloat16, W8A8 under ``mix:kernels,plain,kernels``,
   and the generic W8A8 path at ``compute_dtype`` / ``attention_dtype``
   bfloat16 with and without ``int8_attention``), launches read just
   after and logits against the same path on the plain versions, and
   seq/s beside W8A8's (five windows of >= 0.5 s).

18. the command line (``cli.py``) in process, at BERT-base width and
   depth (random weights from ``--seed``, ``--synthetic-data --task rte
   --max-seq-length 128``, on the card): ``validate-quantized --recipe
   w8a8 --engine auto``, its evaluation's launches read just after (K1 48,
   K2 12, K3 24 an engine forward) and its phase timings printed; the same
   command on the plain versions (``--engine plain``) from the checkpoint
   it saved, under ``--profile-dir`` (the trace file must exist): equal
   eval results; ``train-quantized --recipe qat-w4a8 --max-steps 8``
   without and with ``--remat`` (losses equal step by step within rtol
   1e-5; peak memory and ms a step) and with ``--amp``, each evaluated on
   the W4A8 engine (K1 w4 48, K2 12, K3 24 an engine forward).
19. MobileBERT at W4A8 from training to the engine: MobileBERT-uncased
   (24 layers, H = 512, bottleneck 128, 4 heads of 32, 4 FFNs, both
   dropouts 0) from ``--seed`` through the JAX CLI's ``qat-w4a8`` recipe
   (its calibration: MSE golden-section 4-bit weights, one padded batch of
   16; the int8 QAT forward's 361 products a forward, five of them held
   against the exact plain product bit for bit), ``MB_QAT_STEPS``
   optimizer steps at B = 8, S = 128 on the int8 QAT forward and
   ``MB_QAT_FLOAT_STEPS`` on the float fake-quant forward (ms a step from
   step ``MB_QAT_TIMED_FROM``, peak MiB); then the learned ranges packed
   split-half int4 and planned (every matmul's ``w4`` flag, the layer
   kernel's route at S = 32, 64 and 128): on layer 0 (B = 128) K6's packed
   int4 form on the five NoNorm matmuls (K = 512 and 128, with and without
   the residual, res_quant both ways) against its plain version and K6
   int8 on the unpacked weight, and K8's at every built seq against its
   plain version, the w4 chain, K8 with mixed flags and K8 int8 on the
   unpacked weights, all bit for bit, with w4, int8, plain, library
   (``torch._int_mm`` on the unpacked weight) and chain ms and the bound;
   three request batches through ``mobilebert_engine_apply`` on the K8
   route (24 w4 layer launches a forward), on the chain (144 K1 w4, 192
   K6 w4, 24 K7) and at S = 64 and 32, launches read just after and logits
   against the plain engine; the engine, the generic int path and the
   fake-quant forward by the route-ratio rule (``route_gaps``); forward ms
   and seq/s on both routes and at S = 64 and 32.

20. the families train: RoBERTa-base, DistilBERT-base-uncased,
   ALBERT-base-v2 and SqueezeBERT-uncased (``FAMILY_MODELS``) at their
   published widths and depth, both dropouts 0, from ``--seed`` through
   the registry, each through the JAX CLI's ``qat-w4a8`` recipe on
   synthetic RTE examples (RoBERTa's token types 0): its calibration (MSE
   golden-section 4-bit weights, one padded batch of 16); the int8 QAT
   forward's products a forward (``FAM_QAT_CALLS``: SqueezeBERT's grouped
   layers stay on fake-quant, as in JAX), some held against the exact
   plain product bit for bit; ``FAM_QAT_STEPS`` optimizer steps at B = 8,
   S = 128 on the int8 QAT forward and ``FAM_QAT_FLOAT_STEPS`` on the
   float fake-quant forward (ms a step from step ``FAM_QAT_TIMED_FROM``,
   peak MiB); then the learned ranges packed split-half int4 and planned
   (every matmul's ``w4`` flag; ALBERT's layers on one packed storage,
   SqueezeBERT's block-diagonal weights densified and packed): K1 w4 on
   layer 0's four matmuls, K2 and K3 against their plain versions bit for
   bit (K1 w4's device ms), three request batches through the family's
   ``engine_apply`` (4L / L / 2L launches a forward, logits against the
   plain engine), the engine, the int8 QAT forward and the fake-quant
   forward by the route-ratio rule (the logits site off), engine seq/s.
   Then ``cli.main train-quantized --recipe qat-w4a8 --max-steps 2`` on
   ``CLI_FAMILY`` (ALBERT-base-v2; 64 training and 128 validation
   examples) on the card, its evaluation's launches read just after (K1
   w4 / K2 / K3 an engine forward).

``python3 chip_smoke.py --only 13,14,15,16,17,18,19,20`` runs phases 1 and
2 and the named ones of 13-20 alone (the kernels JSON only comes with
every phase; ``--only 16``: the float edges alone).

The last lines are the kernels JSON (times per encoder layer: the sum
over that layer's launches of each kernel; the flex kernels' top-level
numbers are the mixed recipe's, and ``variants`` holds each recipe's,
for ``int8_matmul`` its dense fold on the h grid and MobileBERT's layer;
K4's entry holds its level pass (``level_pass``, with its launches) and
the GEMM alone per recipe (``gemm_alone``);
the MobileBERT kernels' numbers are MobileBERT-uncased layer 0's, with
K6's five calls under ``variants`` and the chain's ms per layer beside
``int8_mb_layer_ln``, which has an entry of its own at each other seq it
is built for (``int8_mb_layer_ln (S=64)``: that bucket's path); the fused
linear's and ``fused_add_ln``'s numbers are per encoder layer of the
generic W8A8 path and of the ``{'h': 'fp32'}`` engine, with the fused
linear's other calls under ``variants`` and its quantize pass (5 a layer
at K = 768, and on the ``{'x': 'fp32'}`` dense) under
``quantize_pass``; ``int8_matmul_w4`` and ``fused_int8_linear_w4`` are
the W4A8 engine's and generic path's per layer, the first with K1 int8's
ms on the unpacked weights (``int8_ms``) and the M = 256 sum under
``variants``, the second with the pooler there; ``launches`` sums the
three runs of every path, ``launches_by_path`` splits them (``qat-w4a8``:
phase 13's trained model on the W4A8 engine; ``adaround-w4a8``: phase
14's AdaRound model on the all-int8 engine; ``<family>`` and
``<family>-generic``: phase 15's engines and generic int paths, and
``bert_large_uncased`` / ``albert_large_v2`` its large presets' engines;
``<family>-w4a8``: phase 20's trained W4A8 engines and
``cmdline-albert-qat-w4a8`` its command line's evaluation; phase
16's configurations by name, whose new kernels close the list:
``int8_attention_flex``, ``float_edge_matmul (fold / float)`` and
``float_int8_matmul``, each with one form's numbers on top and every
form's under ``variants``; phase 17's forms under ``variants`` of their
kernels' rows, named ``<form> (phase 17)``, and its paths by the names
of ``option_forwards``; ``cmdline-w8a8`` / ``cmdline-qat-w4a8``: phase 18's
evaluations; ``mobilebert-w4a8``, ``-chain``, ``-s64``, ``-s32``: phase
19's, whose packed int4 forms of K6 and K8 sit under ``variants`` of the
``int8_matmul_norm`` and ``int8_mb_layer_ln`` rows, each with its own
launches, ``int8_ms`` and numbers); the
serving paths
``serve-bert`` / ``serve-mobilebert`` count the launches the wrappers
made while their buckets were captured, ``serve-bert-eager`` those of
the eager loop, ``serve-bert-bf16`` / ``serve-bert-bare`` phase 11's
option cases'), the
nvidia-smi line, and ``{"ok": true, "device": {...}}``. Imports torch and
the port only.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from transformer_quantization_tpu_torch import cli as CLI
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.models import mobilebert as MB
from transformer_quantization_tpu_torch.models import registry as REG
from transformer_quantization_tpu_torch.ops import engine as ENG
from transformer_quantization_tpu_torch.ops import int_linear as IL
from transformer_quantization_tpu_torch.ops import layers as LY
from transformer_quantization_tpu_torch.ops.kernels import build as KB
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.ops.kernels import int_matmul as IM
from transformer_quantization_tpu_torch.quant import adaround as AR
from transformer_quantization_tpu_torch.quant import quantizers as Q
from transformer_quantization_tpu_torch.quant import ranges as R
from transformer_quantization_tpu_torch.quant.manager import reset_act_ranges
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.serving import engine as SE
from transformer_quantization_tpu_torch.serving import graphs as SG
from transformer_quantization_tpu_torch.serving import server as SVS
from transformer_quantization_tpu_torch.training import adaround_driver as AD
from transformer_quantization_tpu_torch.training import calibration as CAL
from transformer_quantization_tpu_torch.training import int8_qat as TI
from transformer_quantization_tpu_torch.training import qat as TQAT
from transformer_quantization_tpu_torch.training import trainer as TT
from transformer_quantization_tpu_torch.utils import checkpoint as CK
from transformer_quantization_tpu_torch.utils import data as DATA
from transformer_quantization_tpu_torch.utils import glue as GL
from transformer_quantization_tpu_torch.utils import profiling as PROF

# H100 SXM dense peaks (NVIDIA data sheet) used for the bounds
PEAK_INT8_OPS = 1979e12
PEAK_F32_OPS = 67e12   # outside the tensor cores
PEAK_F64_OPS = 67e12   # float64 on the tensor cores (DMMA)
PEAK_BYTES = 3.35e12
BATCH, SEQ = 128, 128
LOGIT_RTOL, LOGIT_ATOL = 1e-3, 2e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph, the graph replayed between CUDA events (median of
    ``replays``), so the host's enqueue time is not counted (at 20-60 us
    a kernel launched through a Python wrapper is host-bound). ``fn`` runs
    once before, outside the capture (builds, first-use set-up)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.median(times))


def bound_ms(ops: float, nbytes: float, peak: float = PEAK_INT8_OPS):
    """(least ms, 'operations' | 'bytes') on the H100 SXM peaks."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(got: torch.Tensor, want: torch.Tensor, name: str,
            quiet: bool = False) -> dict:
    """Level differences of two int8 payloads; fails unless bit-identical
    (kernels and plain versions sum in float64 and round once, so no
    summation order or device moves a level). ``quiet``: print only on a
    failure."""
    torch.cuda.synchronize()
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    max_diff = int(diff.max())
    n_bad = int((diff > 0).sum())
    if not quiet or max_diff:
        print(f"  {name}: max_level_diff={max_diff} mismatches={n_bad} "
              f"(of {diff.numel()})")
    if max_diff:
        fail(f"{name}: expected bit-identical, max level diff {max_diff} "
             f"on {n_bad} elements")
    return {"max_abs_err": max_diff, "mismatches": n_bad}


def compare_values(got: torch.Tensor, want: torch.Tensor, step,
                   name: str, quiet: bool = False) -> dict:
    """Float value edges on a grid of ``step`` (per column or per tensor):
    the difference in levels; fails unless bit-identical. ``quiet``: print
    only on a failure."""
    torch.cuda.synchronize()
    diff = (got - want).abs() / step
    max_diff = float(diff.max())
    n_bad = int((got != want).sum())
    if not quiet or n_bad:
        print(f"  {name}: max_level_diff={max_diff:.3g} mismatches={n_bad} "
              f"(of {diff.numel()})")
    if n_bad:
        fail(f"{name}: expected bit-identical, max level diff {max_diff} "
             f"on {n_bad} elements")
    return {"max_abs_err": max_diff, "mismatches": n_bad}


def ptxas_lines(log: str) -> list:
    """An nvcc -Xptxas -v log, shortened: each GEMM policy instance's (``W4
    SiteEpi<0,0>`` for its packed-int4 instance), each attention
    instance's (``attn_kernel<T,D>``, the second kernel's
    ``attn_flex_i8_kernel<T,D,PV>`` / ``attn_flex_f32_kernel<T,D>``) and
    K9's (``float_int8_kernel<ACT,OUT>``)
    registers and spills by name (``NormEpi<1,0>: Used 168 registers, ...;
    0 bytes stack frame, ...``; with ptxas's warning where it serializes
    wgmma for want of registers), then the other kernels' distinct
    register / static shared memory and stack / spill lines (dynamic
    shared memory is the source's)."""
    by_inst, other, inst = {}, set(), None
    for ln in log.splitlines():
        ln = ln.strip().replace("ptxas info    : ", "")
        if ln.startswith("Compiling entry function"):
            m = (re.search(r"\d([A-Z][A-Za-z]*Epi)I((?:L[ib]\d+E)+)E", ln)
                 or re.search(r"((?:attn|attn_flex_i8|attn_flex_f32|"
                              r"float_int8)_kernel)I((?:Li\d+E)+)E", ln))
            inst = None if m is None else "{}{}<{}>".format(
                "W4 " if "W4Epi" in ln else "", m.group(1),
                ",".join(re.findall(r"L[ib](\d+)E", m.group(2))))
        elif "register" in ln or "spill" in ln:
            if inst is None:
                other.add(ln)
            else:
                by_inst.setdefault(inst, []).append(ln)
    return ([f"{k}: {'; '.join(v)}" for k, v in by_inst.items()]
            + sorted(other))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def request_batches(cfg, n: int, seed: int, seq: int = SEQ):
    """``n`` (B, seq) request batches with seeded padding lengths."""
    rng = np.random.RandomState(seed + 1)
    out = []
    for _ in range(n):
        lens = rng.randint(seq // 4, seq + 1, (BATCH, 1))
        out.append({
            "input_ids": rng.randint(0, cfg.vocab_size,
                                     (BATCH, seq)).astype(np.int32),
            "attention_mask": (np.arange(seq)[None, :] < lens
                               ).astype(np.float32),
            "token_type_ids": np.zeros((BATCH, seq), np.int32)})
    return out


def entry_value(params, cfg, qcfg, qstate, int_params, batch, dev):
    """The encoder's inputs on ``batch`` as ``bert_engine_apply`` makes
    them: the entry-site value (B, S, H) and the (B, S) mask bias."""
    ctx = B.make_ctx(qcfg, qstate, QuantMode(), int_params=int_params)
    ids, tt, pos, _ = B.prepare_inputs(batch, dev)
    with torch.no_grad():
        h = B._embeddings(ctx, params, cfg, ids, tt, pos, False, None)
    mask = (1.0 - torch.as_tensor(batch["attention_mask"], device=dev)
            ) * -10000.0
    return h, mask.contiguous()


def layer0_inputs(params, cfg, qcfg, qstate, int_params, plan, batch, dev):
    """The payloads layer 0 of the engine consumes and produces on
    ``batch``, computed with the plain versions."""
    h, mask = entry_value(params, cfg, qcfg, qstate, int_params, batch, dev)
    es = plan["entry_scal"]
    x8 = EK.quantize_payload(h.reshape(BATCH * SEQ, -1), es[0, 0], es[0, 1])
    lp = plan["layers"][0]
    qkv8 = EK.int8_matmul_ref(x8, lp["qkv"]["w"], lp["qkv"]["vecs"],
                              lp["qkv"]["scal"])
    return x8, mask, lp, qkv8


def check_kernels(params, cfg, qcfg, qstate, int_params, static, plan,
                  batch, dev) -> dict:
    """Phase 3: each kernel against its plain version on the card."""
    x8, mask, lp, qkv8 = layer0_inputs(params, cfg, qcfg, qstate,
                                       int_params, plan, batch, dev)
    m, h = x8.shape
    nh = cfg.num_attention_heads
    akw = dict(n_heads=nh, seq=SEQ, skip_max=static.attn_skip_max)
    c8 = EK.int8_attention_ref(qkv8, mask, lp["attn_scal"], **akw)
    ln1 = EK.fold_ln_scalars(lp["attn_out"]["vecs"], lp["ln1"]["scal"])
    if not torch.equal(ln1, lp["ln1"]["scal"]):
        fail("ln1 scalars [0:2] differ from the attn_out fold site")
    y8 = EK.int8_matmul_ref(c8, lp["attn_out"]["w"], lp["attn_out"]["vecs"],
                            lp["attn_out"]["scal"])
    hx8 = EK.fused_add_ln_payload_ref(y8, x8, lp["ln1"]["gb"], ln1,
                                      eps=static.ln_eps)
    i8 = EK.int8_matmul_ref(hx8, lp["inter"]["w"], lp["inter"]["vecs"],
                            lp["inter"]["scal"], activation="gelu_new")
    report = {}

    # K1: the four matmuls of a layer
    k1 = per_layer([
        (matmul_case("qkv", x8, lp["qkv"], None), 1),
        (matmul_case("attn_out", c8, lp["attn_out"], None), 1),
        (matmul_case("inter", hx8, lp["inter"], "gelu_new"), 1),
        (matmul_case("dense", i8, lp["dense"], None), 1)])
    print(f"  int8_matmul per layer: {k1['ms']:.4f} ms, torch._int_mm on the "
          f"same four products {k1['library_ms']:.4f} ms "
          f"({k1['ms'] / k1['library_ms']:.2f}x), bound {k1['bound_ms']:.4f} "
          f"ms ({k1['bound_by']})")
    report["int8_matmul"] = k1

    # K2: attention
    d = h // nh
    k2 = kernel_case(
        f"int8_attention B={BATCH} T={SEQ} heads={nh}",
        lambda: EK.int8_attention(qkv8, mask, lp["attn_scal"], **akw),
        lambda: c8, 4.0 * BATCH * nh * SEQ * SEQ * d,
        4 * m * h + mask.numel() * 4,
        plain_fn=lambda: EK.int8_attention_ref(qkv8, mask, lp["attn_scal"],
                                               **akw))
    report["int8_attention"] = per_layer([(k2, 1)])

    # K3: add + LayerNorm (twice per layer, same shape)
    gb, eps = lp["ln1"]["gb"], static.ln_eps
    k3 = kernel_case(
        f"fused_add_ln_payload {m}x{h}",
        lambda: EK.fused_add_ln_payload(y8, x8, gb, ln1, eps=eps),
        lambda: EK.fused_add_ln_payload_ref(y8, x8, gb, ln1, eps=eps),
        12.0 * m * h, 3.0 * m * h + 2 * h * 4 + 32, peak=PEAK_F32_OPS)
    report["fused_add_ln_payload"] = per_layer([(k3, 2)])

    # the TPU's fused forms as chains of the kernels, each against its
    # plain version and its own bound (bytes: each input read once, the
    # int8 output written once)
    ao, ffn = lp["attn_out"], (lp["inter"], lp["dense"])
    w_bytes = lambda *mps: sum(mp["w"].numel() + 20 * mp["w"].shape[0]
                               for mp in mps)
    eps = static.ln_eps
    n1 = ffn[0]["w"].shape[0]
    margs = (c8, ao["w"], ao["vecs"], ao["scal"], x8, lp["ln1"]["gb"],
             lp["ln1"]["scal"])
    fargs = (hx8, ffn[0]["w"], ffn[0]["vecs"], ffn[0]["scal"], ffn[1]["w"],
             ffn[1]["vecs"], ffn[1]["scal"], hx8, lp["ln2"]["gb"],
             lp["ln2"]["scal"])
    fkw = dict(activation="gelu_new", eps=eps)
    largs = (x8, lp["qkv"]["w"], lp["qkv"]["vecs"], lp["qkv"]["scal"], mask,
             lp["attn_scal"], ao["w"], ao["vecs"], ao["scal"],
             lp["ln1"]["gb"], lp["ln1"]["scal"], ffn[0]["w"], ffn[0]["vecs"],
             ffn[0]["scal"], ffn[1]["w"], ffn[1]["vecs"], ffn[1]["scal"],
             lp["ln2"]["gb"], lp["ln2"]["scal"])
    lkw = dict(n_heads=nh, seq=SEQ, eps=eps, activation="gelu_new",
               res1=static.res_quant[0][0], res2=static.res_quant[0][1],
               skip_max=static.attn_skip_max)
    chains = {  # name: (chain, plain, ops, bytes)
        "int8_matmul_add_ln": (
            lambda: EK.int8_matmul_add_ln(*margs, eps=eps),
            lambda: EK.int8_matmul_add_ln_ref(*margs, eps=eps),
            2.0 * m * h * h, 3 * m * h + w_bytes(ao)),
        "int8_ffn_ln": (
            lambda: EK.int8_ffn_ln(*fargs, **fkw),
            lambda: EK.int8_ffn_ln_ref(*fargs, **fkw),
            4.0 * m * h * n1, 3 * m * h + w_bytes(*ffn)),
        "int8_layer_ln": (
            lambda: EK.int8_layer_ln(*largs, **lkw),
            lambda: EK.int8_layer_ln_ref(*largs, **lkw),
            2.0 * m * h * (3 * h + h + 2 * n1) + 4.0 * BATCH * nh * SEQ * SEQ
            * d, 2 * m * h + w_bytes(lp["qkv"], ao, *ffn) + mask.numel() * 4),
    }
    for name, (chain, ref, ops, nbytes) in chains.items():
        compare(chain(), ref(), f"{name} (chain vs plain)")
        t_k = device_ms(chain)
        t_p = timed_ms(ref, iters=5)
        bnd, by = bound_ms(ops, nbytes)
        print(f"  {name}: chain {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{bnd:.4f} ms ({by})")
    return report


def check_other_shapes(plan, dev) -> None:
    """The kernels' other built shapes and ragged edges (not on the main
    path): random payloads against the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(7)
    lp = plan["layers"][0]

    def ints(*shape, lo=-40, hi=40):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    # ragged matmuls against K1's 128 x 128 tiles and 128-byte K stages:
    # M, N off the tiles (N = 136: a 16-byte row only every other row),
    # K off the stage (80, 784); M = 8, below one tile; N = 200, a
    # multiple of 8 but not of 16 or 128; each over every activation and
    # output, and the fold on a 16-bit grid
    scal = torch.tensor([[0.03, 5.0]], device=dev)
    for m, n, k in ((1000, 136, 80), (8, 136, 784), (300, 200, 784)):
        w = ints(n, k)
        vecs = torch.stack([torch.full((n,), 2e-4, device=dev),
                            w.float().sum(1), torch.zeros(n, device=dev),
                            torch.full((n,), 0.05, device=dev),
                            torch.full((n,), 3.0, device=dev)])
        x = ints(m, k)
        cases = [(a, mode, 8) for a in (None, "gelu_new", "relu")
                 for mode in ("emit", "fold", "float")] + [(None, "fold", 16)]
        for act, mode, bits in cases:
            kw = dict(activation=act, out_mode=mode, out_bits=bits)
            got = EK.int8_matmul(x, w, vecs, scal, **kw)
            want = EK.int8_matmul_ref(x, w, vecs, scal, **kw)
            tag = f"int8_matmul {m}x{k}->{n} act={act} {mode} {bits}-bit"
            if mode == "emit":
                compare(got, want, tag)
            elif not torch.equal(got, want):
                fail(f"{tag}: max err {(got - want).abs().max().item()}")
        print(f"  int8_matmul {m}x{k}->{n}: {len(cases)} act x output cases "
              "bit-identical")
    check_attention_shapes(dev, ("fused",))
    # add + LayerNorm at another width, ragged rows
    h = 256
    gb = torch.stack([torch.ones(h, device=dev), torch.zeros(h, device=dev)])
    y8, r8 = ints(999, h), ints(999, h)
    for res_quant in (True, False):
        compare(EK.fused_add_ln_payload(y8, r8, gb, lp["ln1"]["scal"],
                                        eps=1e-12, res_quant=res_quant),
                EK.fused_add_ln_payload_ref(y8, r8, gb, lp["ln1"]["scal"],
                                            eps=1e-12, res_quant=res_quant),
                f"fused_add_ln_payload 999x{h} res_quant={res_quant}")


# The attention kernel off the main path's inputs: every built (seq,
# head_dim) with heads as BERT-base (d = 64: 12) and MobileBERT (d = 32: 4)
# have them, at B = 1 (fewer items than resident blocks), 7 and 133 (a
# ragged last group of items)
ATTN_BATCHES = (1, 7, 133)
ATTN_HEADS = {64: 12, 32: 4}
# site scalars [q_s, q_sh, k_s, k_sh, v_s, v_sh, sc_s, sc_sh, p_s, p_sh,
# c_s, c_sh]: levels spread over every grid ('spread'); scores and context
# levels clipped at -128 / 127 and probs at 127 ('saturate'); shifts that
# are not integers, and a context shift beyond 2^22, which the kernel
# takes through the reference's formulas with rintf ('fractional',
# 'big_shift')
ATTN_SCALARS = {
    "spread": (0.05, 3.0, 0.05, -2.0, 0.04, 5.0, 0.25, 2.0, 1 / 255, 128.0,
               0.02, -1.0),
    "saturate": (0.05, 3.0, 0.05, -2.0, 0.04, 5.0, 0.002, 2.0, 1 / 1024,
                 128.0, 2e-4, -1.0),
    "fractional": (0.05, 3.5, 0.05, -2.25, 0.04, 5.0, 0.25, 2.5, 1 / 255,
                   127.5, 0.02, -1.5),
    "big_shift": (0.05, 3.0, 0.05, -2.0, 0.04, 5.0, 0.25, 2.0, 1 / 255,
                  128.0, 0.02, -5e6),
}


def attn_inputs(b: int, seq: int, d: int, n_heads: int, seed: int,
                scalars: str = "spread", full_pad: bool = True):
    """Seeded numpy inputs of one attention call, ``(qkv, mask, scal)``:
    the fused (b*seq, 3H) q|k|v payload in [-60, 60), a (b, seq) mask bias
    with seeded padding (every row keeps at least one key; with
    ``full_pad`` and b > 1 the last row is padded whole), and the (1, 12)
    site scalars ``ATTN_SCALARS[scalars]``.
    ``tests/test_torch_attention.py`` holds the plain versions against
    JAX's on these inputs."""
    rng = np.random.RandomState(seed)
    qkv = rng.randint(-60, 60, (b * seq, 3 * n_heads * d)).astype(np.int8)
    lens = rng.randint(1, seq + 1, b)
    if full_pad and b > 1:
        lens[-1] = 0
    mask = np.where(np.arange(seq)[None, :] < lens[:, None], 0.0,
                    -10000.0).astype(np.float32)
    scal = np.array([ATTN_SCALARS[scalars]], np.float32)
    return qkv, mask, scal


def attn_split(qkv, hidden: int, layout: str):
    """q, k and v of a fused q|k|v payload in separate arrays, for
    ``int8_attention_qkv``: ``(q_arr, k_arr, v_arr, cols)``. 'mobilebert':
    q and k the column blocks 0 and 1 of one [q|k] array of 2H + 16
    columns, v block 0 of an array of H + 48 (MobileBERT's cols (0, 1, 0));
    'three': three arrays of distinct row strides (2H + 16, 3H, H + 48) at
    blocks (1, 2, 0). The columns outside the blocks are filler."""
    m = qkv.shape[0]
    q, k, v = (qkv[:, i * hidden:(i + 1) * hidden] for i in range(3))
    filler = lambda w: np.full((m, w), 77, np.int8)  # noqa: E731
    v_arr = np.concatenate([v, filler(48)], axis=1)
    if layout == "mobilebert":
        qk = np.concatenate([q, k, filler(16)], axis=1)
        return qk, qk, v_arr, (0, 1, 0)
    q_arr = np.concatenate([filler(hidden), q, filler(16)], axis=1)
    k_arr = np.concatenate([filler(2 * hidden), k], axis=1)
    return q_arr, k_arr, v_arr, (1, 2, 0)


def attn_call(entry: str, qkv, mask, scal, *, n_heads: int, seq: int,
              skip_max: bool, plain: bool = False):
    """One attention call on torch tensors through ``entry``: 'fused'
    (``int8_attention`` over the q|k|v array) or a layout of
    :func:`attn_split` (``int8_attention_qkv``); ``plain`` calls the
    plain version."""
    hidden = qkv.shape[1] // 3
    if entry == "fused":
        fn = EK.int8_attention_ref if plain else EK.int8_attention
        return fn(qkv, mask, scal, n_heads=n_heads, seq=seq,
                  skip_max=skip_max)
    arrays = attn_split(qkv.cpu().numpy(), hidden, entry)
    q, k, v = (torch.from_numpy(a).to(qkv.device) for a in arrays[:3])
    fn = EK.int8_attention_qkv_ref if plain else EK.int8_attention_qkv
    return fn(q, k, v, mask, scal, n_heads=n_heads, seq=seq, hidden=hidden,
              cols=arrays[3], skip_max=skip_max)


def attention_cases():
    """(seq, head_dim, B, scalars, skip_max) of :func:`check_attention_shapes`;
    case i's inputs are seeded 60 + i."""
    return ([(seq, d, b, "spread", skip)
             for seq, d in EK.ATTN_SHAPES for b in ATTN_BATCHES
             for skip in (False, True)]
            + [(128, d, 7, sc, skip) for d in (64, 32)
               for sc in ("saturate", "fractional", "big_shift")
               for skip in (False, True)])


def check_attention_shapes(dev, entries) -> None:
    """The attention kernel through each of ``entries`` (see
    :func:`attn_call`) against its plain version, bit-identical or fail:
    every (seq, head_dim) of ``EK.ATTN_SHAPES`` at ``ATTN_BATCHES``,
    skip_max both ways ('spread' scalars; the last row fully padded under
    skip_max=False: under skip_max=True a fully padded row has a zero
    denominator, whose payload is not defined alike by JAX's kernel and
    its plain version), then the 'saturate', 'fractional' and
    'big_shift' scalars at seq 128 and B = 7, skip_max both ways."""
    for i, (seq, d, b, sc, skip) in enumerate(attention_cases()):
        nh = ATTN_HEADS[d]
        qkv, mask, scal = (torch.from_numpy(a).to(dev) for a in attn_inputs(
            b, seq, d, nh, 60 + i, sc, full_pad=not skip))
        for entry in entries:
            kw = dict(n_heads=nh, seq=seq, skip_max=skip)
            compare(attn_call(entry, qkv, mask, scal, **kw),
                    attn_call(entry, qkv, mask, scal, plain=True, **kw),
                    f"attention[{entry}] B={b} T={seq} d={d} heads={nh} "
                    f"{sc} skip_max={skip}")


def check_flex_kernels(params, cfg, qcfg, qstate, int_params, static, plan,
                       batch, dev) -> dict:
    """Phase 5, one recipe: the flex kernels and chains against their plain
    versions on the layer-0 inputs of ``batch``."""
    x8, mask, lp, qkv8 = layer0_inputs(params, cfg, qcfg, qstate,
                                       int_params, plan, batch, dev)
    m, h = x8.shape
    nh = cfg.num_attention_heads
    eps = static.ln_eps
    x_mode, x_bits, h_bits, y_bits, _, _ = static.layer_flex(0)
    g_bits, u_bits = static.layer_io(0)[5:7]
    res1, res2 = static.res_quant[0]
    if x_mode != "f":
        fail(f"the recipe's x site rides a payload (flex {static.flex[0]})")
    akw = dict(n_heads=nh, seq=SEQ, skip_max=static.attn_skip_max)
    ao, inter, dense = lp["attn_out"], lp["inter"], lp["dense"]
    ln1, ln2, grid = lp["ln1"], lp["ln2"], lp["inter"]["grid"]
    c8 = EK.int8_attention_ref(qkv8, mask, lp["attn_scal"], **akw)
    y1 = EK.int8_matmul_ref(c8, ao["w"], ao["vecs"], ao["scal"],
                            out_mode="fold", out_bits=g_bits)
    k5a = dict(eps=eps, res_quant=res1, res_mode="i8", res_bits=u_bits,
               ln_bits=x_bits, ln_out="f")
    hx = EK.flex_add_ln_ref(y1, x8, ln1["gb"], ln1["scal"], ln1.get("lnv"),
                            **k5a)
    i8 = EK.float_edge_matmul_ref(hx, inter["vecs"], grid,
                                  activation="gelu_new")
    y2 = EK.int8_matmul_ref(i8, dense["w"], dense["vecs"], dense["scal"],
                            out_mode="fold", out_bits=h_bits)
    k5b = dict(eps=eps, res_quant=res2, res_mode="f", res_bits=y_bits)
    z8 = EK.flex_add_ln_ref(y2, hx, ln2["gb"], ln2["scal"], ln2.get("lnv"),
                            **k5b)
    x_step = ln1["lnv"][2] if "lnv" in ln1 else ln1["scal"][0, 6]
    n1 = inter["w"].shape[0]
    report = {}

    # K4: the float-edge inter matmul (gelu_new, emit): the level pass and
    # the GEMM, then each alone
    tag = (f"{m}x{h}->{n1} {grid['bits']}-bit, {grid['s'].numel()} groups")
    res = compare(EK.float_edge_matmul(hx, inter["vecs"], grid,
                                       activation="gelu_new"), i8,
                  f"float_edge_matmul[inter] {tag}")
    t_k = device_ms(lambda: EK.float_edge_matmul(hx, inter["vecs"], grid,
                                                activation="gelu_new"))
    t_p = timed_ms(lambda: EK.float_edge_matmul_ref(
        hx, inter["vecs"], grid, activation="gelu_new"), iters=5)
    w_f = inter["w"].float()
    t_l = device_ms(lambda: torch.matmul(hx, w_f.t()))
    # one m x h x n1 product, whatever the edge's width (the kernel's u8
    # planes are its own choice); bytes: f32 x, int8 w and out, vecs, grid
    ops = 2.0 * m * n1 * h
    nbytes = 4 * m * h + n1 * h + m * n1 + 5 * n1 * 4 + 2 * h * 4
    bnd, by = bound_ms(ops, nbytes)
    print(f"  float_edge_matmul: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"torch.matmul f32 (TF32 off; the product only) {t_l:.4f} ms, "
          f"bound {bnd:.4f} ms ({by}), {ops / t_k / 1e9:.1f} TOP/s")
    report["float_edge_matmul"] = {"ms": t_k, "plain_ms": t_p,
                                   "bound_ms": bnd, "bound_by": by,
                                   "library_ms": t_l, **res}
    lv_want = EK.float_edge_levels_ref(hx, grid)
    lv = EK.float_edge_levels(hx, grid)
    lres = compare(lv, lv_want, f"float_edge_levels[inter] {tag}")
    t_lk = device_ms(lambda: EK.float_edge_levels(hx, grid))
    t_lp = timed_ms(lambda: EK.float_edge_levels_ref(hx, grid), iters=5)
    # bytes: f32 x read once, the levels written once, cols and the grid
    lbnd, lby = bound_ms(0.0, 4 * m * h + lv.numel() + 8 * h
                         + 2 * 4 * grid["s"].numel())
    gres = compare(EK.float_edge_gemm(lv, m, inter["vecs"], grid,
                                      activation="gelu_new"), i8,
                   f"float_edge_gemm[inter] {tag}")
    t_gk = device_ms(lambda: EK.float_edge_gemm(lv, m, inter["vecs"], grid,
                                               activation="gelu_new"))
    t_gp = timed_ms(lambda: EK.float_edge_gemm_ref(
        lv, m, inter["vecs"], grid, activation="gelu_new"), iters=5)
    gbnd, gby = bound_ms(ops, lv.numel() + n1 * h + m * n1 + 5 * n1 * 4
                         + grid["gcs"].numel() * 4)
    print(f"  float_edge_levels (the pass alone): kernel {t_lk:.4f} ms, "
          f"plain {t_lp:.4f} ms, bound {lbnd:.4f} ms ({lby}); "
          f"float_edge_gemm (the GEMM alone): kernel {t_gk:.4f} ms, plain "
          f"{t_gp:.4f} ms, bound {gbnd:.4f} ms ({gby}), "
          f"{ops / t_gk / 1e9:.1f} TOP/s")
    report["float_edge_levels"] = {"ms": t_lk, "plain_ms": t_lp,
                                   "bound_ms": lbnd, "bound_by": lby,
                                   "library_ms": None, **lres}
    report["float_edge_gemm"] = {"ms": t_gk, "plain_ms": t_gp,
                                 "bound_ms": gbnd, "bound_by": gby,
                                 "library_ms": None, **gres}

    # K1: the dense matmul's fold on the h grid (float32 out)
    res = compare_values(
        EK.int8_matmul(i8, dense["w"], dense["vecs"], dense["scal"],
                       out_mode="fold", out_bits=h_bits), y2, dense["vecs"][3],
        f"int8_matmul[dense] fold {h_bits}-bit {m}x{n1}->{h}")
    t_k = device_ms(lambda: EK.int8_matmul(i8, dense["w"], dense["vecs"],
                                          dense["scal"], out_mode="fold",
                                          out_bits=h_bits))
    t_p = timed_ms(lambda: EK.int8_matmul_ref(
        i8, dense["w"], dense["vecs"], dense["scal"], out_mode="fold",
        out_bits=h_bits), iters=5)
    w_t = dense["w"].t()
    t_l = device_ms(lambda: torch._int_mm(i8, w_t))
    ops, nbytes = 2.0 * m * h * n1, m * n1 + h * n1 + 4 * m * h + 5 * h * 4
    bnd, by = bound_ms(ops, nbytes)
    print(f"  int8_matmul[dense fold]: kernel {t_k:.4f} ms, plain {t_p:.4f} "
          f"ms, torch._int_mm {t_l:.4f} ms, bound {bnd:.4f} ms ({by}), "
          f"{ops / t_k / 1e9:.1f} TOP/s "
          f"({100 * ops / t_k / PEAK_INT8_OPS * 1e3:.1f}% of peak)")
    report["int8_matmul_fold"] = {"ms": t_k, "plain_ms": t_p,
                                  "bound_ms": bnd, "bound_by": by,
                                  "library_ms": t_l, **res}

    # K5: the attention block's add+LN (f32 y, payload r, f32 x out) and
    # the FFN block's (f32 y, f32 r, payload out)
    k5 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
          "library_ms": None}
    for tag, yv, rv, lnp, kw, want, in_b, out_b in (
            ("ln1", y1, x8, ln1, k5a, hx, 1, 4),
            ("ln2", y2, hx, ln2, k5b, z8, 4, 1)):
        args = (yv, rv, lnp["gb"], lnp["scal"], lnp.get("lnv"))
        got = EK.flex_add_ln(*args, **kw)
        res = (compare_values(got, want, x_step, f"flex_add_ln[{tag}] {m}x{h}")
               if want.dtype == torch.float32 else
               compare(got, want, f"flex_add_ln[{tag}] {m}x{h}"))
        t_k = device_ms(lambda: EK.flex_add_ln(*args, **kw))
        t_p = timed_ms(lambda: EK.flex_add_ln_ref(*args, **kw), iters=5)
        ops, nbytes = 20.0 * m * h, m * h * (4 + in_b + out_b) + 6 * h * 4
        bnd, by = bound_ms(ops, nbytes, PEAK_F32_OPS)
        print(f"  flex_add_ln[{tag}]: kernel {t_k:.4f} ms, plain {t_p:.4f} "
              f"ms, bound {bnd:.4f} ms ({by})")
        for key, val in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", bnd)):
            k5[key] += val
        k5["max_abs_err"] = max(k5["max_abs_err"], res["max_abs_err"])
        k5["bound_by"] = by
    report["flex_add_ln"] = k5

    # the flex chains against their plain versions
    aargs = (x8, lp["qkv"]["w"], lp["qkv"]["vecs"], lp["qkv"]["scal"], mask,
             lp["attn_scal"], ao["w"], ao["vecs"], ao["scal"], ln1["gb"],
             ln1["scal"], ln1.get("lnv"))
    akw2 = dict(akw, eps=eps, res_quant=res1, ln_out="f", ln_bits=x_bits,
                g_bits=g_bits, u_bits=u_bits)
    fargs = (hx, inter["w"], inter["vecs"], inter["scal"], dense["w"],
             dense["vecs"], dense["scal"], hx, ln2["gb"], ln2["scal"],
             ln2.get("lnv"))
    fkw = dict(activation="gelu_new", eps=eps, res_quant=res2, in_mode="f",
               res_mode="f", h_bits=h_bits, y_bits=y_bits, x_grid=grid)
    w_bytes = lambda *mps: sum(mp["w"].numel() + 20 * mp["w"].shape[0]
                               for mp in mps)
    d = h // nh
    chains = {
        "int8_attn_ln": (
            lambda: EK.int8_attn_ln(*aargs, **akw2),
            lambda: EK.int8_attn_ln_ref(*aargs, **akw2),
            2.0 * m * h * 4 * h + 4.0 * BATCH * nh * SEQ * SEQ * d,
            m * h * (1 + 4) + w_bytes(lp["qkv"], ao) + mask.numel() * 4),
        "int8_ffn_ln (flex)": (
            lambda: EK.int8_ffn_ln(*fargs, **fkw),
            lambda: EK.int8_ffn_ln_ref(*fargs, **fkw),
            2.0 * 2 * m * h * n1, m * h * (4 + 1)
            + w_bytes(inter, dense)),
    }
    for name, (chain, ref, ops, nbytes) in chains.items():
        got, want = chain(), ref()
        if want.dtype == torch.float32:
            compare_values(got, want, x_step, f"{name} (chain vs plain)")
        else:
            compare(got, want, f"{name} (chain vs plain)")
        t_k = device_ms(chain)
        t_p = timed_ms(ref, iters=5)
        bnd, by = bound_ms(ops, nbytes)
        print(f"  {name}: chain {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{bnd:.4f} ms ({by})")
    return report


# K4's shapes off the main path, (M, K, N, bits, groups): M not a multiple
# of 64 and N % 16 != 0 throughout; 8 bits in one group, in 2 and 6
# permuted groups of whole stages (a fold a stage), in 5 groups of 64 (a
# fold every two k32 steps) and in 2 groups of 256 (the int32 -> float
# conversion); 16 bits in one group at K = 1024, and in 2 and 3 groups (of
# 128, of 64). Each is 32 tiles of 64 x 128: one a consumer warpgroup.
EDGE_SHAPES = ((1000, 256, 136, 8, 1), (1000, 256, 136, 8, 2),
               (1000, 768, 136, 8, 6), (1000, 320, 136, 8, 5),
               (1000, 512, 136, 8, 2), (1000, 1024, 136, 16, 1),
               (1000, 256, 136, 16, 2), (1000, 192, 136, 16, 3))
# the grouped folds at 512 tiles, so that every consumer warpgroup of an
# H100's 132 blocks takes one tile after another (the group table
# rewritten, the sums and the ring carried from tile to tile): 16 bits in
# groups of 64 and of 128, 8 bits in groups of 64 and of 256
EDGE_TILE_SHAPES = ((16350, 192, 136, 16, 3), (16350, 256, 136, 16, 2),
                    (16350, 320, 136, 8, 5), (16350, 512, 136, 8, 2))
EDGE_SEED = 30   # edge_inputs' seed of case i: EDGE_SEED + i


def edge_inputs(m: int, k: int, n: int, bits: int, groups: int, seed: int):
    """Seeded numpy inputs of one K4 call, ``(x, w8, vecs, s, zp, cols)``:
    a float32 edge ``x = s_c (q - zp_c)`` on random levels q of ``bits``
    bits, one scale and zero point per group of ``k / groups`` columns in
    the permutation order ``cols`` (the identity for one group), an int8
    weight, and a weight scale that spreads the output site over tens of
    levels. ``tests/test_torch_float_edge.py`` holds the plain versions
    against JAX's ``int8_matmul(in_mode='f')`` on these inputs."""
    rng = np.random.RandomState(seed)
    cols = rng.permutation(k) if groups > 1 else np.arange(k)
    grp = np.empty(k, np.int64)
    grp[cols] = np.arange(k) // (k // groups)
    top = 2 ** bits - 1
    s_g = ((0.5 + rng.rand(groups)) / 2 ** (bits - 1)).astype(np.float32)
    zp_g = rng.randint(top // 4, 3 * top // 4 + 1, groups).astype(np.float32)
    q = rng.randint(0, top + 1, (m, k)).astype(np.float32)
    x = (s_g[grp] * (q - zp_g[grp])).astype(np.float32)
    w = rng.randint(-127, 128, (n, k)).astype(np.int8)
    ws = 1.0 / (np.sqrt(k) * x.std() * w.astype(np.float32).std())
    vecs = np.stack([np.full(n, ws), w.astype(np.float32).sum(1),
                     0.1 * rng.randn(n), 0.03 + 0.02 * rng.rand(n),
                     np.full(n, 3.0)]).astype(np.float32)
    return x, w, vecs, s_g[grp], zp_g[grp], cols


def check_flex_shapes(dev) -> None:
    """The flex kernels off the main path's shapes: K4 (the whole call, its
    level pass and its GEMM) at ``EDGE_SHAPES`` and ``EDGE_TILE_SHAPES``
    with and without gelu_new; K5 at H=256 with and without per-column
    sites."""
    gen = torch.Generator(device=dev).manual_seed(11)
    for i, (m, k, n, bits, groups) in enumerate(EDGE_SHAPES
                                                + EDGE_TILE_SHAPES):
        x, w, vecs, s, zp, cols = (
            torch.from_numpy(a).to(dev) for a in
            edge_inputs(m, k, n, bits, groups, EDGE_SEED + i))
        grid = EK.edge_grid(w, s, zp, bits, groups, cols)
        tag = f"{m}x{k}->{n} {bits}-bit, {groups} groups"
        lv = EK.float_edge_levels(x, grid)
        compare(lv, EK.float_edge_levels_ref(x, grid),
                f"float_edge_levels {tag}")
        for act in (None, "gelu_new"):
            want = EK.float_edge_matmul_ref(x, vecs, grid, activation=act)
            compare(EK.float_edge_matmul(x, vecs, grid, activation=act),
                    want, f"float_edge_matmul {tag} act={act}")
            compare(EK.float_edge_gemm(lv, m, vecs, grid, activation=act),
                    want, f"float_edge_gemm {tag} act={act}")
    h = 256
    gb = torch.stack([torch.linspace(0.5, 1.5, h, device=dev),
                      torch.linspace(-0.1, 0.1, h, device=dev)])
    scal = torch.tensor([[1.0, 0.0, 0.03, 4.0, 0.02, 5.0, 0.01, 2.0]],
                        device=dev)
    lnv = torch.stack([torch.linspace(0.01, 0.03, h, device=dev),
                       torch.full((h,), 3.0, device=dev),
                       torch.linspace(2e-5, 5e-5, h, device=dev),
                       torch.full((h,), -7.0, device=dev)])
    y = torch.randn(999, h, generator=gen, device=dev)
    r8 = torch.randint(-128, 128, (999, h), generator=gen, device=dev,
                       dtype=torch.int8)
    for rv, res_mode in ((r8, "i8"), (y.flip(0).contiguous(), "f")):
        for lv, bits in ((None, 8), (lnv, 16)):
            for ln_out in ("emit", "f"):
                ln_bits = 8 if ln_out == "emit" else bits
                kw = dict(eps=1e-12, res_mode=res_mode, res_bits=bits,
                          ln_bits=ln_bits, ln_out=ln_out)
                got = EK.flex_add_ln(y, rv, gb, scal, lv, **kw)
                want = EK.flex_add_ln_ref(y, rv, gb, scal, lv, **kw)
                tag = (f"flex_add_ln 999x{h} r={res_mode} sites="
                       f"{'lnv' if lv is not None else 'scalar'} {ln_out}")
                if ln_out == "emit":
                    compare(got, want, tag)
                else:
                    compare_values(got, want, 1.0, tag)


# The add+LN kernels (K3, K5 and fused_add_ln: add_ln.cuh's template) off
# the main path: every built H, a ragged M and a full one
LN_WIDTHS = tuple(range(128, 1025, 128))
LN_ROWS = (999, 16384)
# [y_s, y_sh, r_s, r_sh, res_s, res_sh, ln_s, ln_sh] of 8-bit sites (the
# levels spread over the grid, the tails clip) and of 16-bit ones
LN_SCAL8 = (0.02, 3.0, 0.03, -5.0, 0.02, 4.0, 0.03, -2.0)
LN_SCAL16 = (0.02, 3.0, 0.03, -5.0, 1e-4, 7.0, 1e-4, -3.0)
# the special cases, (scalars, y's outliers, res_quant, gamma's scale):
# every level clips (res_s and ln_s of 1e-30, below the fast division's
# divisors, and float32 outliers up to +-3e38 in y); outliers up to +-1e15
# with no res site to clip them; shifts off the integers (the general
# path); a gamma of ~1e30, whose z passes the fast division's dividends
LN_SPECIAL = {
    "saturating": ((0.02, 3.0, 0.03, -5.0, 1e-30, 4.0, 1e-30, -2.0), 3e38,
                   (True,), 1.0),
    "outliers": (LN_SCAL8, 1e15, (False,), 1.0),
    "fractional": ((0.02, 3.5, 0.03, -5.25, 0.02, 4.5, 0.03, -2.25), 0.0,
                   (True, False), 1.0),
    "huge_gamma": (LN_SCAL8, 0.0, (True,), 1e30),
}


def ln_inputs(m: int, h: int, seed: int, outlier: float = 0.0,
              frac_shift: bool = False, gamma: float = 1.0):
    """Seeded numpy inputs of the add+LN kernels, ``(y8, r8, y, r, gb,
    lnv)``: int8 payloads, float32 values (with +-``outlier`` on one
    element in 97 of y where it is not 0), gamma (times ``gamma``) / beta,
    and PEG's per-column (4, h) site rows [res_s; res_sh; ln_s; ln_sh] on
    16-bit grids (shifts off the integers with ``frac_shift``).
    ``tests/test_torch_add_ln_exact.py`` holds the kernels' exact forms
    to the plain versions on these inputs."""
    rng = np.random.RandomState(seed)
    y8 = rng.randint(-128, 128, (m, h)).astype(np.int8)
    r8 = rng.randint(-128, 128, (m, h)).astype(np.int8)
    y = (0.5 * rng.randn(m, h)).astype(np.float32)
    r = (0.5 * rng.randn(m, h)).astype(np.float32)
    if outlier:
        hit = rng.rand(m, h) < 1.0 / 97
        y[hit] = outlier * rng.choice([-1.0, 1.0], int(hit.sum()))
    gb = np.stack([gamma * (0.5 + rng.rand(h)),
                   0.2 * rng.randn(h)]).astype(np.float32)
    lnv = np.stack([4e-4 * (1 + rng.rand(h)), rng.randint(-100, 100, h),
                    1e-4 * (1 + rng.rand(h)), rng.randint(-100, 100, h)])
    if frac_shift:
        lnv[[1, 3]] += 0.25
    return y8, r8, y, r, gb, lnv.astype(np.float32)


def _ln_forms(arrays, scal8, scal16, res_quant: bool, tag: str) -> int:
    """Every form of the add+LN kernels on one input set against its plain
    version: K3; fused_add_ln (both outputs); K5 with a payload or float32
    residual, 8-bit, 16-bit or per-column (PEG, 16-bit) sites, an int8 or
    a float value out. Returns the number of comparisons."""
    y8, r8, y, r, gb, lnv = arrays
    kw = dict(eps=1e-12, res_quant=res_quant)
    n = 0
    compare(EK.fused_add_ln_payload(y8, r8, gb, scal8, **kw),
            EK.fused_add_ln_payload_ref(y8, r8, gb, scal8, **kw),
            f"fused_add_ln_payload {tag}", quiet=True)
    (g8, gf), (w8, wf) = (EK.fused_add_ln(y, r, gb, scal8, **kw),
                          EK.fused_add_ln_ref(y, r, gb, scal8, **kw))
    compare(g8, w8, f"fused_add_ln {tag} payload", quiet=True)
    compare_values(gf, wf, scal8[0, 6], f"fused_add_ln {tag} value",
                   quiet=True)
    n += 3
    for rv, res_mode in ((r8, "i8"), (r, "f")):
        for sites, sc, lv, bits in (("8-bit", scal8, None, 8),
                                    ("16-bit", scal16, None, 16),
                                    ("PEG", scal8, lnv, 16)):
            for ln_out in ("emit", "f"):
                fkw = dict(kw, res_mode=res_mode, res_bits=bits,
                           ln_bits=8 if ln_out == "emit" else bits,
                           ln_out=ln_out)
                got = EK.flex_add_ln(y, rv, gb, sc, lv, **fkw)
                want = EK.flex_add_ln_ref(y, rv, gb, sc, lv, **fkw)
                name = f"flex_add_ln {tag} r={res_mode} {sites} {ln_out}"
                if ln_out == "emit":
                    compare(got, want, name, quiet=True)
                else:
                    compare_values(got, want, 1.0, name, quiet=True)
                n += 1
    return n


# the divisors tq_ln_div_check holds the add+LN kernels' fast division at
# over every dividend: the ends of its range, mantissas of all ones and of
# one ulp, ln scales like the main path's, every built H (the row
# statistics' divisor), and log-uniform draws
def ln_divisors(seed: int = 17) -> np.ndarray:
    edges = np.array([2.0 ** -30, 2.0 ** 30, 1.0, 2.0 - 2.0 ** -23,
                      1.0 + 2.0 ** -23, 0.03, 1e-4, 0.5 - 2.0 ** -25,
                      *LN_WIDTHS], np.float32)
    rng = np.random.RandomState(seed)
    draws = np.exp2(rng.uniform(-30, 30, 24)).astype(np.float32)
    return np.concatenate([edges, np.nextafter(np.float32(2.0 ** 30),
                                               np.float32(0))[None],
                           np.nextafter(np.float32(2.0 ** -30),
                                        np.float32(1))[None], draws])


# the random pairs of add_ln.cuh's div_check: SWEEP_K at each pair of the
# dividend's biased exponents below 2^96's and the divisor's in [2^-30,
# 2^30]
LN_DIV_SWEEP = 223 * 61 * 4096


def check_ln_division(dev) -> None:
    """The add+LN kernels' division (``add_ln.cuh`` div_fast) against the
    IEEE quotient on the card: every float32 dividend below 2^96 in
    magnitude, both signs, at each of ``ln_divisors``; every divisor in
    [2^-30, 2^30] at four dividends (the row statistics' reciprocal); and
    4096 seeded random pairs at each of the domain's 223 x 61 pairs of
    exponents (``LN_DIV_SWEEP``); fails on any pair that differs."""
    b = torch.from_numpy(ln_divisors()).to(dev)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    fn = KB.load("ln_div_check")
    t0 = time.perf_counter()
    KB.check(fn(b.data_ptr(), b.numel(), bad.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "ln_div_check")
    n_bad = int(bad.item())
    pairs = (b.numel() * 2 * int(np.float32(2.0 ** 96).view(np.uint32))
             + 4 * (int(np.float32(2.0 ** 30).view(np.uint32))
                    - int(np.float32(2.0 ** -30).view(np.uint32)) + 1)
             + LN_DIV_SWEEP)
    print(f"  the add+LN division against __fdiv_rn: {pairs} (dividend, "
          f"divisor) pairs, {n_bad} differ ({time.perf_counter() - t0:.2f} "
          "s)", flush=True)
    if n_bad:
        fail(f"add+LN fast division: {n_bad} quotients differ from the "
             "IEEE ones")


def check_ln_shapes(dev) -> int:
    """The add+LN kernels (K3, K5, fused_add_ln) off the main path, each
    form of ``_ln_forms`` against its plain version, bit-identical: every
    built H at M = 999 and 16384 with res_quant both ways, then
    ``LN_SPECIAL``'s scalars at H = 768 and 1024. Returns the number of
    comparisons."""
    t = lambda v: torch.tensor([v], dtype=torch.float32, device=dev)
    n = 0
    for h in LN_WIDTHS:
        for m in LN_ROWS:
            arrays = [torch.from_numpy(a).to(dev)
                      for a in ln_inputs(m, h, seed=m + h)]
            for rq in (True, False):
                n += _ln_forms(arrays, t(LN_SCAL8), t(LN_SCAL16), rq,
                               f"{m}x{h} res_quant={rq}")
        print(f"  add+LN at H={h}: M = {' and '.join(map(str, LN_ROWS))}, "
              f"res_quant both ways, {n} comparisons so far, bit-identical",
              flush=True)
    for name, (scal, outlier, rqs, gamma) in LN_SPECIAL.items():
        for m, h in ((999, 768), (16384, 1024)):
            arrays = [torch.from_numpy(a).to(dev) for a in ln_inputs(
                m, h, seed=m + h + 1, outlier=outlier,
                frac_shift=name == "fractional", gamma=gamma)]
            for rq in rqs:
                n += _ln_forms(arrays, t(scal), t(scal), rq,
                               f"{m}x{h} {name} res_quant={rq}")
        print(f"  add+LN, {name}: {n} comparisons so far, bit-identical",
              flush=True)
    return n


def kernel_case(tag, got_fn, want_fn, ops, nbytes, lib_fn=None,
                peak=PEAK_INT8_OPS, plain_fn=None, step=None) -> dict:
    """One kernel call against its plain version ``want_fn``: bit-identical
    or fail; kernel (device), plain and library ms, and the bound from
    ``ops`` / ``nbytes``. ``plain_fn``: what to time as the plain version
    when ``want_fn`` only returns a result computed before. ``step``: the
    output is a float value on that grid (else an int8 payload)."""
    res = (compare(got_fn(), want_fn(), tag) if step is None else
           compare_values(got_fn(), want_fn(), step, tag))
    t_k = device_ms(got_fn)
    t_p = timed_ms(plain_fn or want_fn, iters=5)
    t_l = device_ms(lib_fn) if lib_fn is not None else None
    bnd, by = bound_ms(ops, nbytes, peak)
    lib = f", library {t_l:.4f} ms" if t_l is not None else ""
    print(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms{lib}, bound "
          f"{bnd:.4f} ms ({by}), {ops / t_k / 1e9:.1f} TOP/s "
          f"({100 * ops / t_k / peak * 1e3:.1f}% of peak)")
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "ops": ops,
            "bytes": nbytes, "peak": peak, **res}


def per_layer(cases) -> dict:
    """A kernel's numbers per encoder layer: the sum over ``(case,
    launches per layer)`` pairs; the bound from the summed work."""
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0}
    ops = nbytes = 0.0
    for c, n in cases:
        for k in ("ms", "plain_ms"):
            out[k] += n * c[k]
        out["library_ms"] = (None if c["library_ms"] is None
                             or out["library_ms"] is None
                             else out["library_ms"] + n * c["library_ms"])
        out["max_abs_err"] = max(out["max_abs_err"], c["max_abs_err"])
        ops += n * c["ops"]
        nbytes += n * c["bytes"]
    out["bound_ms"], out["bound_by"] = bound_ms(ops, nbytes,
                                                cases[0][0]["peak"])
    return out


def matmul_case(tag, x, mp, act) -> dict:
    """K1 on ``x`` with the matmul plan ``mp``; the library yardstick is
    ``torch._int_mm``, the int32 product only."""
    m, (n, k) = x.shape[0], mp["w"].shape
    w_t = mp["w"].t()
    return kernel_case(
        f"int8_matmul[{tag}] {m}x{k}->{n}",
        lambda: EK.int8_matmul(x, *_mm(mp), activation=act),
        lambda: EK.int8_matmul_ref(x, *_mm(mp), activation=act),
        2.0 * m * n * k, m * k + n * k + 5 * n * 4 + m * n,
        lib_fn=lambda: torch._int_mm(x, w_t))


def _mm(p):
    return (p["w"], p["vecs"], p["scal"])


def _nrm(p):
    return (p["gb"], p["scal"])


def mb_layer_kwargs(cfg, static, i: int = 0, seq: int = SEQ) -> dict:
    return dict(n_heads=static.n_heads, seq=seq, hidden=static.hidden,
                attn_case=static.attn_case, activation=cfg.hidden_act,
                res=static.res_quant[i], w4=static.w4[i], n_ffn=static.n_ffn,
                skip_max=static.attn_skip_max)


def mb_seqs() -> tuple:
    """The seqs the layer kernel is built for (MobileBERT-uncased's
    head_dim 32 and 4 heads), longest first."""
    return tuple(sorted((t for t, d, n in EK.MB_LAYER_SHAPES
                         if (d, n) == (32, 4)), reverse=True))


def mb_layer0_payloads(params, cfg, qcfg, qstate, int_params, static, plan,
                       batch, dev):
    """Layer 0's entry payload h8 (B=128, S=128), its mask bias and the
    payloads between its matmuls on the plain versions (the plan's ``w4``
    flags): li8, sh8, qk8, v8, c8, x8 (after attn_out), i8 (FFN 0's
    inter) and y8 (after the output FFN)."""
    h, mask = MB.entry_value(params, batch, cfg, qcfg, qstate, int_params,
                             device=dev)
    es = plan["entry_scal"]
    h8 = EK.quantize_payload(h.reshape(BATCH * SEQ, -1), es[0, 0], es[0, 1])
    mask = mask.contiguous()
    lp = plan["layers"][0]
    w4 = iter(static.w4[0])
    res_ao, res_ffn, res_out, _ = static.res_quant[0]
    nk = dict(eps=0.0, norm="nonorm")
    akw = dict(n_heads=static.n_heads, seq=SEQ, hidden=static.hidden,
               cols=(0, 1, 0), skip_max=static.attn_skip_max)
    out = {"li8": EK.int8_matmul_norm_ref(h8, *_mm(lp["bn_in"]),
                                          *_nrm(lp["bn_in_norm"]),
                                          w4=next(w4), **nk)}
    out["sh8"] = EK.int8_matmul_norm_ref(h8, *_mm(lp["bn_attn"]),
                                         *_nrm(lp["bn_attn_norm"]),
                                         w4=next(w4), **nk)
    out["qk8"] = EK.int8_matmul_ref(out["sh8"], *_mm(lp["qk"]), w4=next(w4))
    out["v8"] = EK.int8_matmul_ref(h8, *_mm(lp["v"]), w4=next(w4))
    out["c8"] = EK.int8_attention_qkv_ref(out["qk8"], out["qk8"], out["v8"],
                                          mask, lp["attn_scal"], **akw)
    out["x8"] = EK.int8_matmul_add_ln_ref(
        out["c8"], *_mm(lp["attn_out"]), out["li8"],
        *_nrm(lp["attn_out_norm"]), res_quant=res_ao, w4=next(w4), **nk)
    xj = out["x8"]
    for j, f in enumerate(lp["ffns"]):
        w4i, w4d = next(w4), next(w4)
        if j == 0:
            out["i8"] = EK.int8_matmul_ref(xj, *_mm(f["inter"]),
                                           activation="relu", w4=w4i)
        xj = EK.int8_ffn_ln_ref(xj, *_mm(f["inter"]), *_mm(f["dense"]), xj,
                                *_nrm(f["norm"]), activation="relu",
                                res_quant=res_ffn[j], w4i=w4i, w4d=w4d, **nk)
    out["y8"] = EK.int8_ffn_ln_ref(xj, *_mm(lp["inter"]), *_mm(lp["out"]), xj,
                                   *_nrm(lp["out_norm"]), activation="relu",
                                   res_quant=res_out, w4i=next(w4),
                                   w4d=next(w4), **nk)
    return h8, mask, out


def check_mobilebert_kernels(params, cfg, qcfg, qstate, int_params, static,
                             plan, batch, dev, seed: int = 0) -> dict:
    """Phase 7: K1 + relu, K6, K7 and K8 against their plain versions on
    layer 0 of MobileBERT-uncased (B=128, S=128; K8 also at its other
    built seqs, B=128), and K8 against the chain of the other kernels;
    per-layer times."""
    h8, mask, pl = mb_layer0_payloads(params, cfg, qcfg, qstate, int_params,
                                      static, plan, batch, dev)
    li8, sh8, qk8, v8, c8, x8, i8, y8 = (
        pl[k] for k in ("li8", "sh8", "qk8", "v8", "c8", "x8", "i8", "y8"))
    lp = plan["layers"][0]
    es = plan["entry_scal"]
    m = h8.shape[0]
    th, nh = static.hidden, static.n_heads
    d = th // nh
    res_ao, res_ffn, res_out, res_obn = static.res_quant[0]
    nk = dict(eps=0.0, norm="nonorm")
    akw = dict(n_heads=nh, seq=SEQ, hidden=th, cols=(0, 1, 0),
               skip_max=static.attn_skip_max)
    f0 = lp["ffns"][0]
    report = {}

    # K1: [q|k], v and the four relu inter matmuls of a layer
    k1 = [(matmul_case("qk", sh8, lp["qk"], None), 1),
          (matmul_case("v", h8, lp["v"], None), 1),
          (matmul_case("inter relu", x8, f0["inter"], "relu"), 4)]
    report["int8_matmul"] = per_layer(k1)

    def norm_case(tag, x, mp, r, np_, res_quant):
        n, k = mp["w"].shape
        w_t = mp["w"].t()
        if r is None:
            got = lambda: EK.int8_matmul_norm(x, *_mm(mp), *_nrm(np_), **nk)
            want = lambda: EK.int8_matmul_norm_ref(x, *_mm(mp), *_nrm(np_),
                                                   **nk)
        else:
            got = lambda: EK.int8_matmul_add_ln(
                x, *_mm(mp), r, *_nrm(np_), res_quant=res_quant, **nk)
            want = lambda: EK.int8_matmul_add_ln_ref(
                x, *_mm(mp), r, *_nrm(np_), res_quant=res_quant, **nk)
        nbytes = (m * k + n * k + 7 * n * 4 + 10 * 4
                  + m * n * (1 if r is None else 2))
        return kernel_case(
            f"int8_matmul_norm[{tag}] {m}x{k}->{n} "
            f"{'no residual' if r is None else 'residual'}", got, want,
            2.0 * m * n * k, nbytes, lib_fn=lambda: torch._int_mm(x, w_t))

    # K6: bn_in, bn_attn, attn_out, the four FFN dense and out_bn
    k6 = [(norm_case("bn_in", h8, lp["bn_in"], None, lp["bn_in_norm"],
                     False), 1),
          (norm_case("bn_attn", h8, lp["bn_attn"], None,
                     lp["bn_attn_norm"], False), 1),
          (norm_case("attn_out", c8, lp["attn_out"], li8,
                     lp["attn_out_norm"], res_ao), 1),
          (norm_case("ffn dense", i8, f0["dense"], x8, f0["norm"],
                     res_ffn[0]), 4),
          (norm_case("out_bn", y8, lp["out_bn"], h8, lp["out_bn_norm"],
                     res_obn), 1)]
    report["int8_matmul_norm"] = per_layer(k6)
    report["int8_matmul_norm"]["variants"] = {
        tag: per_layer([(c, 1)]) for tag, (c, _) in zip(
            ("bn_in", "bn_attn", "attn_out", "ffn dense", "out_bn"), k6)}

    # K7: the attention over [q|k] cols 0, 1 and v, head_dim 32
    k7 = kernel_case(
        f"int8_attention_qkv B={BATCH} T={SEQ} heads={nh} d={d}",
        lambda: EK.int8_attention_qkv(qk8, qk8, v8, mask, lp["attn_scal"],
                                      **akw),
        lambda: EK.int8_attention_qkv_ref(qk8, qk8, v8, mask,
                                          lp["attn_scal"], **akw),
        4.0 * BATCH * nh * SEQ * SEQ * d, 4 * m * th + mask.numel() * 4)
    report["int8_attention_qkv"] = per_layer([(k7, 1)])

    # K8: the whole layer at each built seq (B = 128, the seq's request
    # batch), against its plain version and the chain
    flat = EK.mb_layer_flat(lp, static.attn_case)
    report["int8_mb_layer_ln"] = {}
    for seq in mb_seqs():
        if seq == SEQ:
            hs, ms = h8, mask
        else:
            hb, mb = MB.entry_value(params,
                                    request_batches(cfg, 1, seed, seq)[0],
                                    cfg, qcfg, qstate, int_params, device=dev)
            hs = EK.quantize_payload(hb.reshape(BATCH * seq, -1), es[0, 0],
                                     es[0, 1])
            ms = mb.contiguous()
        report["int8_mb_layer_ln"][seq] = mb_layer_case(
            flat, hs, ms, lp["attn_scal"], mb_layer_kwargs(cfg, static,
                                                           seq=seq))
    return report


def mb_layer_case(flat, h8, mask, ascal, kw) -> dict:
    """K8 on one layer's inputs against its plain version and the chain
    (bit-identical or fail), with its kernel, plain and bound ms and the
    chain's device ms."""
    args = (h8, mask, ascal, flat)
    seq, m, b = kw["seq"], h8.shape[0], mask.shape[0]

    def layer():
        return EK.int8_mb_layer_ln(*args, **kw)

    def chain():
        return EK.mb_layer_chain(*args, **kw)

    def plain():
        return EK.int8_mb_layer_ln_ref(*args, **kw)

    compare(chain(), plain(), f"mb_layer_chain (K1 + K6 + K7) S={seq} vs "
            "plain")
    compare(layer(), chain(), f"int8_mb_layer_ln S={seq} vs the chain")
    nh, d = kw["n_heads"], kw["hidden"] // kw["n_heads"]
    ops = (sum(2.0 * m * a.shape[0] * a.shape[1] for a in flat
               if a.dtype == torch.int8)
           + 4.0 * b * nh * seq * seq * d)
    nbytes = (2 * m * h8.shape[1] + mask.numel() * 4 + ascal.numel() * 4
              + sum(a.numel() * a.element_size() for a in flat))
    k8 = kernel_case(f"int8_mb_layer_ln B={b} T={seq} (one layer)", layer,
                     plain, ops, nbytes)
    t_chain = device_ms(chain)
    print(f"  mb_layer_chain S={seq} (15 launches): {t_chain:.4f} ms per "
          f"layer; int8_mb_layer_ln {k8['ms']:.4f} ms "
          f"({t_chain / k8['ms']:.2f}x the chain's speed)")
    return dict(per_layer([(k8, 1)]), chain_ms=t_chain)


# K6's shapes off the main path, (M, K, N): ragged M and N % 16 != 0 (the
# residual's and the output's 8-byte halves); three column tiles, ragged in
# every dimension; a partial last column tile at full M
NORM_SHAPES = ((1000, 80, 136), (1000, 80, 264), (16384, 128, 520))


def norm_inputs(m: int, k: int, n: int, seed: int):
    """Seeded numpy inputs of one K6 call, ``(x8, w8, vecs, scal, r8, gb,
    ls)``: int8 payloads in [-40, 40), a weight scale that spreads the
    fold site over tens of levels at any K, per-column out scales, and a
    residual, res site and norm site that clip only the tails.
    ``tests/test_torch_mobilebert.py`` holds the plain versions against
    JAX's on these inputs."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-40, 40, (m, k)).astype(np.int8)
    w = rng.randint(-40, 40, (n, k)).astype(np.int8)
    r = rng.randint(-40, 40, (m, n)).astype(np.int8)
    vecs = np.stack([np.full(n, 0.09 / np.sqrt(k)),
                     w.astype(np.float32).sum(1), 0.1 * rng.randn(n),
                     0.04 + 0.02 * rng.rand(n),
                     np.full(n, 3.0)]).astype(np.float32)
    scal = np.array([[0.03, 5.0]], np.float32)
    gb = np.stack([np.linspace(0.5, 1.5, n),
                   np.linspace(-0.1, 0.1, n)]).astype(np.float32)
    ls = np.array([[1.0, 0.0, 0.04, 2.0, 0.06, -3.0, 0.05, 1.0]], np.float32)
    return x, w, vecs, scal, r, gb, ls


def check_norm_shapes(dev) -> None:
    """K6 at ``NORM_SHAPES``, with a residual (res_quant True and False)
    and without, against its plain versions: bit-identical or fail."""
    for i, (m, k, n) in enumerate(NORM_SHAPES):
        x, w, vecs, scal, r, gb, ls = (torch.from_numpy(a).to(dev)
                                       for a in norm_inputs(m, k, n, 20 + i))
        for res_quant in (True, False):
            kw = dict(eps=0.0, res_quant=res_quant, norm="nonorm")
            compare(EK.int8_matmul_add_ln(x, w, vecs, scal, r, gb, ls, **kw),
                    EK.int8_matmul_add_ln_ref(x, w, vecs, scal, r, gb, ls,
                                              **kw),
                    f"int8_matmul_norm {m}x{k}->{n} residual "
                    f"res_quant={res_quant}")
        compare(EK.int8_matmul_norm(x, w, vecs, scal, gb, ls, eps=0.0),
                EK.int8_matmul_norm_ref(x, w, vecs, scal, gb, ls, eps=0.0),
                f"int8_matmul_norm {m}x{k}->{n} no residual")


def mb_inputs(b: int, seq: int, seed: int, *, h: int = 512,
              inter: int = 512, n_ffn: int = 3, shared_kq: bool = True,
              scalars: str = "spread"):
    """Seeded numpy inputs of one layer-kernel call at MobileBERT-uncased
    widths (bottleneck 128, 4 heads of 32), ``(h8, mask, ascal, flat)``:
    an int8 payload in [-60, 60), a (b, seq) mask bias with seeded padding
    (every sequence keeps a key), the attention scalars
    ``ATTN_SCALARS[scalars]`` and a layer plan in ``mb_layer_flat``'s
    order whose fold and norm sites spread over tens of levels."""
    rng = np.random.RandomState(seed)
    th = 128

    def mm(n, k):
        w = rng.randint(-60, 60, (n, k)).astype(np.int8)
        vecs = np.stack([0.05 / np.sqrt(k) * (0.5 + rng.rand(n)),
                         w.astype(np.float32).sum(1), 0.1 * rng.randn(n),
                         0.04 + 0.02 * rng.rand(n),
                         np.full(n, 3.0)]).astype(np.float32)
        return [w, vecs, np.array([[0.03, 5.0]], np.float32)]

    def nrm(n):
        gb = np.stack([np.linspace(0.5, 1.5, n),
                       np.linspace(-0.1, 0.1, n)]).astype(np.float32)
        return [gb, np.array([[1.0, 0.0, 0.04, 2.0, 0.06, -3.0, 0.05, 1.0]],
                             np.float32)]

    flat = mm(th, h) + nrm(th)
    if shared_kq:
        flat += mm(th, h) + nrm(th)
    flat += mm(2 * th, th) + mm(th, h if shared_kq else th)
    flat += mm(th, th) + nrm(th)
    for _ in range(n_ffn + 1):
        flat += mm(inter, th) + mm(th, inter) + nrm(th)
    flat += mm(h, th) + nrm(h)
    h8 = rng.randint(-60, 60, (b * seq, h)).astype(np.int8)
    lens = rng.randint(1, seq + 1, b)
    mask = np.where(np.arange(seq)[None, :] < lens[:, None], 0.0,
                    -10000.0).astype(np.float32)
    return h8, mask, np.array([ATTN_SCALARS[scalars]], np.float32), flat


def mb_kwargs(seq: int, shared_kq: bool = True, n_ffn: int = 3,
              skip_max: bool = False) -> dict:
    """The keyword arguments of ``int8_mb_layer_ln`` for ``mb_inputs``."""
    return dict(n_heads=4, seq=seq, hidden=128,
                attn_case="shared_kq" if shared_kq else "bottleneck",
                activation="relu", res=(True, (True,) * n_ffn, False, True),
                w4=(False,) * (7 + shared_kq + 2 * n_ffn), n_ffn=n_ffn,
                skip_max=skip_max)


# K8 off the main path, per built seq: (batch, shared_kq, scalars,
# skip_max) on ``mb_inputs``: a ragged batch (B * S not a multiple of
# 128) and a whole tile's, both attention cases, the integer path
# ('spread', 'saturate') and the general one ('fractional'); at S <= 64
# also a ragged batch of more 64-row tiles than the card's SMs, which
# takes 128-row tiles
MB_CASES = {32: ((9, True, "spread", False), (9, False, "fractional", True),
                 (4, True, "saturate", True), (4, False, "spread", False),
                 (533, True, "spread", False)),
            64: ((7, True, "spread", False), (7, False, "fractional", True),
                 (2, True, "saturate", True), (2, False, "spread", False),
                 (267, False, "fractional", False)),
            128: ((3, True, "fractional", False), (3, False, "spread", True),
                  (1, True, "saturate", False))}
# the serving buckets' smallest batches (phase 11): one or two sequences,
# under one 64- or 128-row tile at S = 32 / 64
for _seq, _b in ((32, 1), (32, 2), (64, 1), (128, 2)):
    MB_CASES[_seq] += ((_b, True, "spread", False),)


def check_mb_layer_shapes(dev) -> int:
    """K8 at ``MB_CASES`` against its plain version; returns the number
    of comparisons (each bit-identical or fail)."""
    n = 0
    for seq in mb_seqs():
        for i, (b, shared_kq, scalars, skip) in enumerate(MB_CASES[seq]):
            h8, mask, ascal, flat = mb_inputs(b, seq, 90 + i,
                                              shared_kq=shared_kq,
                                              scalars=scalars)
            h8, mask, ascal = (torch.from_numpy(a).to(dev)
                               for a in (h8, mask, ascal))
            flat = [torch.from_numpy(a).to(dev) for a in flat]
            kw = mb_kwargs(seq, shared_kq=shared_kq, skip_max=skip)
            compare(EK.int8_mb_layer_ln(h8, mask, ascal, flat, **kw),
                    EK.int8_mb_layer_ln_ref(h8, mask, ascal, flat, **kw),
                    f"int8_mb_layer_ln S={seq} B={b} {kw['attn_case']} "
                    f"{scalars} skip_max={skip}", quiet=True)
            n += 1
    return n


def check_mobilebert_shapes(plan, static, dev) -> None:
    """The new kernels off the main path's shapes: K6 at ``NORM_SHAPES``
    with and without a residual, K7 through both ``attn_split`` layouts
    on ``attention_cases``, K8 with the 'bottleneck' attention case on
    layer 0's weights at each built seq and at ``MB_CASES``, against
    their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(13)

    def ints(*shape, lo=-40, hi=40):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    lp = plan["layers"][0]
    check_norm_shapes(dev)
    check_attention_shapes(dev, ("mobilebert", "three"))
    # the 'bottleneck' case: q, k and v from the bottleneck-in payload (v's
    # weight is attn_out's, a 128 x 128 stand-in); 8 sequences
    bl = dict(lp, bn_attn=None, bn_attn_norm=None,
              v=dict(lp["v"], w=lp["attn_out"]["w"]))
    flat = EK.mb_layer_flat(bl, "bottleneck")
    for seq in mb_seqs():
        kw = dict(n_heads=static.n_heads, seq=seq, hidden=static.hidden,
                  attn_case="bottleneck", activation="relu",
                  res=static.res_quant[0], w4=static.w4[0][1:],
                  n_ffn=static.n_ffn, skip_max=False)
        h8 = ints(8 * seq, lp["bn_in"]["w"].shape[1])
        mask = torch.zeros(8, seq, device=dev)
        mask[:, 3 * seq // 4:] = -10000.0
        compare(EK.int8_mb_layer_ln(h8, mask, lp["attn_scal"], flat, **kw),
                EK.int8_mb_layer_ln_ref(h8, mask, lp["attn_scal"], flat,
                                        **kw),
                f"int8_mb_layer_ln S={seq} attn_case=bottleneck")
    n = check_mb_layer_shapes(dev)
    print(f"  int8_mb_layer_ln off the main path: {n} more comparisons, all "
          "bit-identical", flush=True)


def mobilebert_runner(params, cfg, qcfg, qstate, static, plan, int_params,
                      dev, fuse_layer=None):
    def run(batch, backend):
        return MB.mobilebert_engine_apply(
            params, batch, cfg, qcfg, qstate, static, plan, int_params,
            backend=backend, fuse_layer=fuse_layer if backend == "kernels"
            else None, device=dev)
    return run


def window_ms(fn, window_s: float = 1.0, windows: int = 5):
    """Median, least and most milliseconds per call over ``windows``
    host-clock windows of at least ``window_s`` seconds each: calls are
    enqueued back to back and each window ends in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = max(1, int(np.ceil(window_s / (time.perf_counter() - t0))))
    per_call = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3 / iters)
    return float(np.median(per_call)), min(per_call), max(per_call)


def seq_per_s(ms) -> str:
    """seq/s at the median window, with the range over the windows."""
    med, lo, hi = (BATCH * 1e3 / t for t in ms)
    return f"{med:.1f} ({hi:.1f}-{lo:.1f})"


def bert_runner(params, cfg, qcfg, qstate, static, plan, int_params, dev):
    def run(batch, backend):
        return B.bert_engine_apply(params, batch, cfg, qcfg, qstate, static,
                                   plan, int_params, backend=backend,
                                   device=dev)
    return run


def per_forward(**counts) -> dict:
    """Expected launches per forward: the given kernels, 0 for the rest."""
    return {k: counts.get(k, 0) for k in EK.LAUNCHES}


def drive_path(name, run, cfg, batches, want):
    """One main path: the launch counts set to 0 just before and read just
    after three request batches through ``run(batch, backend)`` (an
    engine entry point); the logits against the same engine on the plain
    versions (``backend='plain'``). Returns the counts."""
    EK.reset_launches()
    logits = [run(b, "kernels")["logits"] for b in batches]
    torch.cuda.synchronize()
    launches = dict(EK.LAUNCHES)
    per_fwd = {k: v / len(batches) for k, v in launches.items()}
    print(f"  [{name}] launches over {len(batches)} forwards: {launches}; "
          f"per forward: {per_fwd}")
    if per_fwd != want:
        fail(f"{name}: launches per forward {per_fwd}, expected {want}")
    for i, (b, lg) in enumerate(zip(batches, logits)):
        ref = run(b, "plain")["logits"]
        if tuple(lg.shape) != (BATCH, cfg.num_labels):
            fail(f"{name}: logits shape {tuple(lg.shape)}")
        if not torch.isfinite(lg).all():
            fail(f"{name}: non-finite logits")
        err = (lg - ref).abs().max().item()
        ok = torch.allclose(lg, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        print(f"  [{name}] batch {i}: logits max |kernels - plain| = "
              f"{err:.3e} (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}); logit "
              f"scale {ref.abs().max().item():.3e}")
        if not ok:
            fail(f"{name} batch {i}: engine logits disagree with the plain "
                 "engine")
    return launches


def record_calls(run, *targets) -> list:
    """Run ``run()`` with each ``(module, name)`` function of ``targets``
    wrapped to record its calls; returns, per target, the ``(args,
    kwargs)`` of every call in order (the functions are restored after)."""
    calls = [[] for _ in targets]
    reals = [getattr(mod, name) for mod, name in targets]
    for (mod, name), real, log in zip(targets, reals, calls):
        def rec(*a, _real=real, _log=log, **k):
            _log.append((a, k))
            return _real(*a, **k)
        setattr(mod, name, rec)
    try:
        run()
    finally:
        for (mod, name), real in zip(targets, reals):
            setattr(mod, name, real)
    return calls


def linear_case(tag, args, kw) -> dict:
    """The fused linear kernel on one call of the generic path against its
    plain version on the same inputs; the library yardstick is
    ``torch._int_mm`` of the int8 product (a float32 x quantized
    beforehand)."""
    kw = dict(kw, plain=False)
    x, packed, in_spec, in_qp = args[:4]
    k = x.shape[-1]
    w4 = "w_packed" in packed
    w8 = IL.unpack_int4(packed["w_packed"], k) if w4 else packed["w_int"]
    m, n = x.numel() // k, w8.shape[0]
    x8 = (x.reshape(m, k) if x.dtype == torch.int8 else
          IL.quantize_activation_int8(in_spec, in_qp, x.reshape(m, k))[0])
    x8, w_t = x8.contiguous(), w8.t()
    emit = kw.get("emit_int8", False)
    step = None if emit else Q.scale_of(kw["out_spec"], kw["out_qp"])
    plain = lambda: IM.fused_int8_linear(*args, **dict(kw, plain=True))
    want = plain()
    out_b = 1 if emit else (2 if x.dtype == torch.bfloat16 else 4)
    nbytes = (x.numel() * x.element_size() + n * k // (2 if w4 else 1)
              + 3 * n * 4 + 32 + m * n * out_b)
    in_name = {torch.int8: "int8", torch.bfloat16: "bf16"}.get(x.dtype, "f32")
    return kernel_case(
        f"fused_int8_linear{'_w4' if w4 else ''}[{tag}] {m}x{k}->{n} "
        f"{in_name} in, {kw.get('activation')}, {'emit' if emit else 'fold'}",
        lambda: IM.fused_int8_linear(*args, **kw), lambda: want,
        2.0 * m * n * k, nbytes, lib_fn=lambda: torch._int_mm(x8, w_t),
        plain_fn=plain, step=step)


def generic_runner(params, cfg, qcfg, qstate, int_params, dev):
    """The generic int path with the fused linear: ``backend`` 'kernels'
    runs the kernel, 'plain' its plain version (bert_apply's
    ``fused_linear='plain'``)."""
    def run(batch, backend):
        return B.bert_apply(params, batch, cfg, qcfg, qstate, QuantMode(),
                            int_params=int_params,
                            fused_linear=(True if backend == "kernels"
                                          else "plain"),
                            device=dev)[0]
    return run


def check_linear_kernels(params, cfg, w8a8, x_fp32, batch, dev) -> dict:
    """Phase 9, the fused linear: its calls in one generic forward on the
    plain version (W8A8: layer 0's q, attn_out, inter with gelu emitting
    the payload, dense on the payload, and the pooler at M = B; and
    ``{'x': 'fp32'}``'s dense on a float32 x of K=3072), then a ragged M
    and symmetric input / output sites, each against its plain version."""
    def calls_of(qc, qs, ip):
        run = generic_runner(params, cfg, qc, qs, ip, dev)
        return record_calls(lambda: run(batch, "plain"),
                            (LY, "fused_int8_linear"))[0]
    L = cfg.num_hidden_layers
    calls = calls_of(*w8a8)
    xcalls = calls_of(*x_fp32)
    # the last call is the classifier's (N=2), which the kernel refuses
    if len(calls) != 6 * L + 2 or len(xcalls) != 5 * L + 2:
        fail(f"fused linear calls per forward: {len(calls)} (W8A8), "
             f"{len(xcalls)} (x fp32)")
    cases = {"q": calls[0], "attn_out": calls[3], "inter": calls[4],
             "dense": calls[5], "pooler": calls[-2],
             "dense x-fp32": xcalls[4]}
    del calls, xcalls
    args, kw = cases["q"]
    cases["ragged M=1000"] = ((args[0].reshape(-1, args[0].shape[-1])[:1000],
                               ) + args[1:], kw)
    args, kw = cases["attn_out"]
    sym = Q.QuantizerSpec(n_bits=8, method=Q.QMethod.symmetric_uniform)
    x = args[0]
    in_qp = Q.set_quant_range(sym, x.min(), x.max())
    y = IM.fused_int8_linear(x, args[1], sym, in_qp, bias=kw["bias"],
                             plain=True)
    cases["symmetric sites"] = (
        (x, args[1], sym, in_qp),
        dict(kw, out_spec=sym, out_qp=Q.set_quant_range(sym, y.min(),
                                                         y.max())))
    if cases["dense"][0][0].dtype != torch.int8 or cases[
            "dense x-fp32"][0][0].dtype != torch.float32:
        fail("the dense matmul's inputs: a payload (W8A8) and float32 "
             "(x fp32) expected")
    res = {tag: linear_case(tag, a, k) for tag, (a, k) in cases.items()}
    out = per_layer([(res["q"], 3), (res["attn_out"], 1), (res["inter"], 1),
                     (res["dense"], 1)])
    out["variants"] = {tag: per_layer([(res[tag], 1)]) for tag in (
        "pooler", "dense x-fp32", "ragged M=1000", "symmetric sites")}
    # the quantize pass alone, on the float32 x of q (the shape of all 5
    # of a W8A8 layer's passes) and of the {'x': 'fp32'} dense
    qp = {tag: quantize_case(tag, *cases[tag]) for tag in ("q",
                                                            "dense x-fp32")}
    out["quantize_pass"] = per_layer([(qp["q"], 5)])
    out["quantize_pass"]["variants"] = {
        "dense x-fp32": per_layer([(qp["dense x-fp32"], 1)])}
    print(f"  fused linear per layer {out['ms']:.4f} ms, of which the "
          f"quantize pass {out['quantize_pass']['ms']:.4f} ms "
          f"({100 * out['quantize_pass']['ms'] / out['ms']:.1f}%); "
          f"{{'x': 'fp32'}} dense {res['dense x-fp32']['ms']:.4f} ms, its "
          f"pass {qp['dense x-fp32']['ms']:.4f} ms")
    return out


def quantize_case(tag, args, kw) -> dict:
    """The fused linear's quantize pass alone on the float32 x of one of
    its calls, against its plain version (bytes: x read once, the payload
    written once; 5 float operations an element)."""
    x, _, in_spec, in_qp = args[:4]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    m, k = x2d.shape
    scal = torch.zeros(1, 8, device=x.device)
    scal[0, 0] = Q.scale_of(in_spec, in_qp).reshape(())
    scal[0, 1] = Q.zero_point_of(in_spec, in_qp).reshape(())
    asym = not in_spec.symmetric
    return kernel_case(
        f"fused_linear_quantize[{tag}] {m}x{k}",
        lambda: IM.quantize_input(x2d, scal, asym),
        lambda: IM.quantize_input_ref(x2d, scal, asym),
        5.0 * m * k, 5 * m * k + 32, peak=PEAK_F32_OPS)


def check_erf_reciprocal(dev) -> None:
    """The fused linear's A-S erf takes 1 / (1 + p |x|) branch-free
    (``rcp_ge1`` in ``fused_int8_linear.cu``); it must give the IEEE
    quotient's bits on every float32 in [1, 2^126], its whole domain."""
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    KB.check(KB.load("fused_rcp_check")(bad.data_ptr(), EK._stream()),
             "fused_rcp_check")
    n_bad = int(bad.item())
    print(f"  the A-S erf's reciprocal against 1.0f / d on every float32 d "
          f"in [1, 2^126]: {n_bad} differ")
    if n_bad:
        fail(f"the A-S erf's reciprocal differs from the IEEE quotient on "
             f"{n_bad} float32 values")


def check_linear_shapes(dev) -> None:
    """The fused linear at the edges its GEMM's TMA loads zero-fill: M = 8
    (below one 128-row tile), N = 200 (a multiple of 8, not of 16 or
    128), K = 784 (off the 128-byte K stage); each on a float32 x and on
    a payload, over every activation and output, against the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(11)
    asym = Q.QuantizerSpec(n_bits=8, method=Q.QMethod.asymmetric_uniform)
    for m, n, k in ((8, 768, 768), (1000, 200, 768), (304, 136, 784)):
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        packed = {"w_int": w,
                  "scale": 1e-3 * (1 + torch.rand(n, generator=gen,
                                                  device=dev)),
                  "colsum": w.float().sum(1)}
        bias = 0.1 * torch.randn(n, generator=gen, device=dev)
        x = 1.5 * torch.randn(m, k, generator=gen, device=dev)
        in_qp = Q.set_quant_range(asym, x.min(), x.max())
        scal = torch.zeros(1, 8, device=dev)
        scal[0, 0] = Q.scale_of(asym, in_qp)
        scal[0, 1] = Q.zero_point_of(asym, in_qp)
        n_cases = 0
        for xin in (x, IM.quantize_input_ref(x, scal, True)):
            for act in (None, "gelu", "gelu_new", "tanh", "relu"):
                y = IM.fused_int8_linear(xin, packed, asym, in_qp, bias=bias,
                                         activation=act, plain=True)
                oqp = Q.set_quant_range(asym, y.min(), y.max())
                for out in ("none", "fold", "emit"):
                    kw = dict(bias=bias, activation=act)
                    if out != "none":
                        kw.update(out_spec=asym, out_qp=oqp,
                                  emit_int8=out == "emit")
                    got = IM.fused_int8_linear(xin, packed, asym, in_qp, **kw)
                    want = IM.fused_int8_linear(xin, packed, asym, in_qp,
                                                plain=True, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        fail(f"fused_int8_linear {m}x{k}->{n} "
                             f"{'int8' if xin.dtype == torch.int8 else 'f32'}"
                             f" in, act={act} {out}: max err "
                             f"{(got.float() - want.float()).abs().max()}")
                    n_cases += 1
        print(f"  fused_int8_linear {m}x{k}->{n}: {n_cases} input x act x "
              "output cases bit-identical")


def check_engine_fp32_kernels(params, cfg, h_fp32, batch, dev) -> dict:
    """Phase 9, the non-payload route: layer 0 of the ``{'h': 'fp32'}``
    engine on the plain versions; ``fused_add_ln`` (both add+LNs) and the
    matmul's ``fold`` (attn_out) and ``float`` (dense) outputs against
    their plain versions."""
    qc, qs, static, plan, ip = h_fp32
    run = bert_runner(params, cfg, qc, qs, static, plan, ip, dev)
    lns, mms = record_calls(lambda: run(batch, "plain"),
                            (EK, "fused_add_ln_ref"), (EK, "int8_matmul_ref"))
    L = cfg.num_hidden_layers
    if len(lns) != 2 * L or len(mms) != 4 * L:
        fail(f"non-payload route calls: {len(lns)} add+LN, {len(mms)} "
             "matmul")
    for tag, (args, kw) in (("attn_out fold", mms[1]),
                            ("dense float", mms[3])):
        got, want = EK.int8_matmul(*args, **kw), EK.int8_matmul_ref(*args,
                                                                    **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"int8_matmul[{tag}]: max err "
                 f"{(got - want).abs().max().item()}")
        print(f"  int8_matmul[{tag}] {tuple(args[0].shape)}: bit-identical")
    cases = []
    for tag, (args, kw) in (("ln1", lns[0]), ("ln2", lns[1])):
        m, h = args[0].shape
        w8, wf = EK.fused_add_ln_ref(*args, **kw)
        g8, gf = EK.fused_add_ln(*args, **kw)
        compare_values(gf, wf, args[3][0, 6],
                       f"fused_add_ln[{tag}] float out {m}x{h}")
        cases.append((kernel_case(
            f"fused_add_ln[{tag}] {m}x{h} payload out",
            lambda: EK.fused_add_ln(*args, **kw)[0], lambda: w8,
            12.0 * m * h, m * h * (4 + 4 + 1 + 4) + 2 * h * 4 + 32,
            peak=PEAK_F32_OPS,
            plain_fn=lambda: EK.fused_add_ln_ref(*args, **kw)), 1))
        del g8
    return per_layer(cases)


# the JAX CLI's PTQ presets the recipes phase drives (MSE golden-section
# weight ranges), each with the launches per forward of its engine route
def cli_recipe_launches(L: int) -> dict:
    flex = per_forward(int8_matmul=3 * L, int8_attention=L,
                       float_edge_matmul=L, float_edge_levels=L,
                       flex_add_ln=2 * L)
    return {"w8a8": per_forward(int8_matmul=4 * L, int8_attention=L,
                                fused_add_ln_payload=2 * L),
            "w8a8-mixed": flex, "w8a8-peg": flex}


def timed_s(fn):
    """``fn()`` and its seconds on the host clock, the card synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def qp_loss64(spec, w, qp) -> float:
    """The MSE objective of params ``qp`` on the CPU tensor ``w``, summed
    in float64."""
    y = Q.fake_quant(spec, qp, w).double()
    return float(((w.double() - y) ** 2).sum())


def check_weight_ranges(qcfg, card_qs, cpu_qs, cpu_tensors) -> None:
    """Every weight site of a card calibration against the CPU one by the
    MSE tolerance: the scale within rtol 1e-5, else the card's float64
    loss no more than 1e-6 relative above the CPU's (printed)."""
    worst, n_equal, n_sites = 0.0, 0, 0
    for name, site in qcfg.items():
        if site.kind != "weight":
            continue
        n_sites += 1
        gq = Q.QuantParams(*(getattr(card_qs[name]["qp"], f).cpu()
                             for f in ("delta", "zero_float", "signed")))
        cq = cpu_qs[name]["qp"]
        rel = ((gq.delta - cq.delta).abs() / cq.delta.abs()).max().item()
        worst = max(worst, rel)
        n_equal += int(torch.equal(gq.delta, cq.delta))
        if rel <= 1e-5:
            continue
        lg = qp_loss64(site.spec, cpu_tensors[name], gq)
        lc = qp_loss64(site.spec, cpu_tensors[name], cq)
        print(f"  {name}: card scale {gq.delta.item()!r} loss {lg!r}, CPU "
              f"scale {cq.delta.item()!r} loss {lc!r}")
        if lg > lc * (1 + 1e-6):
            fail(f"{name}: the card's MSE weight range is worse than the "
                 "CPU's beyond the near-tie rule")
    print(f"  weight ranges, card against CPU: {n_sites} MSE golden-section "
          f"sites, {n_equal} bit-equal, largest scale difference "
          f"{worst:.3e} relative (rtol 1e-5, else the near-tie rule)")


def check_mse_estimators(params, cfg, seed: int, dev) -> None:
    """One MSE-grid per-channel weight calibration (BERT-base's layer-0
    inter weight, 3072 channels, 100 candidates) on the card, timed and
    held to the CPU's by the grid rule (the same candidate per channel,
    or the CPU's two smallest losses within 1e-6 relative); then the
    STS-B variant's MSE_logits classifier site: that recipe's calibration
    on the card, and its classifier output's nested golden-section search
    alone on the calibration batch's logits, timed."""
    site = dataclasses.replace(
        CAL.cli_w8a8_defaults(), per_channel_weights=True,
        weight_range_opt=R.OptMethod.grid).weight_site()
    w = params["layers"][0]["ffn"]["inter"]["kernel"]
    ests = []
    for x in (w, w.cpu()):
        est = R.make_estimator(site.spec, site.range_cfg, per_channel=True)
        _, t = timed_s(lambda: est.update(x))
        ests.append((est, t))
    (ge, tg), (ce, tc) = ests
    gl, cl = ge.loss_array.cpu(), ce.loss_array
    gi, ci = gl.argmin(dim=1), cl.argmin(dim=1)
    two = cl.sort(dim=1).values[:, :2]
    ties = (two[:, 1] - two[:, 0]) <= 1e-6 * two[:, 0].abs()
    bad = ((gi != ci) & ~ties).sum().item()
    print(f"  MSE grid, per channel ({tuple(w.shape)}, "
          f"{site.range_cfg.num_candidates} candidates): card {tg:.3f} s, "
          f"CPU {tc:.3f} s; candidate per channel equal to the CPU's on "
          f"{(gi == ci).sum().item()} of {len(ci)} channels, the rest "
          f"near-ties of the CPU's losses")
    if bad:
        fail(f"MSE grid: {bad} channels chose another candidate than the "
             "CPU without a near-tie")
    (_, sq, ss), t_cal = timed_s(lambda: CAL.calibrated_bert(
        cfg, batch_size=CAL.CLI_RECIPES["w8a8-mixed-stsb"].est_batch_size,
        seq=SEQ, seed=seed, device=dev, params=params,
        recipe="w8a8-mixed-stsb"))
    name = "classifier.out"
    off = sq.replace_site(name, enabled=False)
    batch = CAL.calibration_batch(cfg.vocab_size, 1, SEQ, seed)
    logits = B.bert_apply(params, batch, cfg, off, ss, QuantMode(),
                          device=dev)[0]["logits"]
    rc = sq[name].range_cfg
    est = R.make_estimator(sq[name].spec, rc)
    _, t_site = timed_s(lambda: est.update(logits))
    lo, hi = (v.item() for v in est.finalize())
    qp = ss[name]["qp"]
    print(f"  STS-B variant (quant_setup MSE_logits): calibration "
          f"{t_cal:.3f} s on the card; {name} ({rc.method.name}, "
          f"{rc.opt_method.name}) on logits {tuple(logits.shape)}: the "
          f"search alone {t_site:.3f} s, range ({lo:.6g}, {hi:.6g}), the "
          f"calibrated scale {qp.delta.item():.6g}")
    if not (np.isfinite(lo) and np.isfinite(hi) and lo < hi):
        fail(f"{name}: MSE range ({lo}, {hi})")


def run_cli_recipes(params, cfg, batches, by_path, seed: int, kind: str,
                    smi: str, dev) -> None:
    """The JAX CLI's ``w8a8``, ``w8a8-mixed`` and ``w8a8-peg`` from the
    same params: calibration on the card (timed; for ``w8a8`` also on
    the CPU, and the weight ranges held card against CPU), packing, the
    plan, three request batches through the engine (launches, logits
    against the plain engine) and engine seq/s."""
    L = cfg.num_hidden_layers
    want = cli_recipe_launches(L)
    b0 = batches[0]
    for rname in ("w8a8", "w8a8-mixed", "w8a8-peg"):
        recipe = CAL.CLI_RECIPES[rname]
        (_, rq, rs), t_cal = timed_s(lambda: CAL.calibrated_bert(
            cfg, batch_size=recipe.est_batch_size, seq=SEQ, seed=seed,
            device=dev, params=params, recipe=rname))
        line = (f"  [cli-{rname}] calibration (MSE golden-section weight "
                f"ranges, {recipe.est_batch_size} x {SEQ} tokens): "
                f"{t_cal:.3f} s on the card")
        if rname == "w8a8":
            cpu_params = B.params_to(params, device="cpu")
            t0 = time.perf_counter()
            _, cq, cs = CAL.calibrated_bert(
                cfg, batch_size=recipe.est_batch_size, seq=SEQ, seed=seed,
                device="cpu", params=cpu_params, recipe=rname)
            line += (f", {time.perf_counter() - t0:.3f} s on the CPU "
                     f"({torch.get_num_threads()} threads)")
        print(line, flush=True)
        if rname == "w8a8":
            check_weight_ranges(rq, rs, cs,
                                B.bert_weight_site_tensors(cpu_params))
            del cpu_params, cq, cs
        rstatic, rplan, rint = B.build_bert_engine(params, cfg, rq, rs,
                                                   device=dev)
        by_path[f"cli-{rname}"] = drive_path(
            f"cli-{rname}", bert_runner(params, cfg, rq, rs, rstatic, rplan,
                                        rint, dev), cfg, batches,
            want[rname])
        t_eng = window_ms(lambda: B.bert_engine_apply(
            params, b0, cfg, rq, rs, rstatic, rplan, rint, device=dev))
        print(f"  [cli-{rname}] seq/s at B={BATCH}, S={SEQ}, median (range) "
              f"of 5 windows ({kind}, {smi}): engine {seq_per_s(t_eng)}; "
              f"forward {t_eng[0]:.3f} ms ({t_eng[1]:.3f}-{t_eng[2]:.3f})",
              flush=True)
    check_mse_estimators(params, cfg, seed, dev)


# phase 11: the JAX bench's serving settings (bench.py ``bench_serving``):
# seq buckets, batch buckets, closed-loop requests and concurrency; the
# smallest batches of ``ServeConfig``'s default buckets beside them
SERVE_SEQS = (32, 64, 128)
SERVE_BATCHES = (8, 32, 64)
SERVE_SMALL = (1, 2)
SERVE_REQUESTS, SERVE_CONCURRENCY = 512, 64
SERVE_TEXTS = (("the quick brown fox", "jumps over the lazy dog"),
               ("hello world", None), ("word " * 200, None))


def serve_config() -> SE.ServeConfig:
    """The JAX bench's closed-loop settings: max_batch 64, a 2 ms wait,
    pipeline depth 5, the fused transfer, every bucket warmed at start."""
    return SE.ServeConfig(max_batch=64, max_wait_ms=2.0,
                          seq_buckets=SERVE_SEQS,
                          batch_buckets=SERVE_BATCHES, precompile=True,
                          fused_transfer=True, pipeline_depth=5)


def packed_batch(vocab: int, b: int, s: int, seed: int, dev) -> torch.Tensor:
    """A seeded (3, b, s) int32 fused-transfer batch as the engine
    assembles one: ids of seeded lengths in [1, s], zero past them, the
    mask, zero type ids."""
    rng = np.random.RandomState(seed)
    out = np.zeros((3, b, s), np.int32)
    out[1] = np.arange(s)[None, :] < rng.randint(1, s + 1, (b, 1))
    out[0] = rng.randint(4, vocab, (b, s)) * out[1]
    return torch.from_numpy(out).to(dev)


def serve_requests(vocab: int, seed: int) -> list:
    """The bench's closed-loop requests: seeded ids of lengths 8-127."""
    rng = np.random.RandomState(seed)
    return [rng.randint(4, vocab, rng.randint(8, 128)).astype(np.int32)
            for _ in range(SERVE_REQUESTS)]


def check_buckets(name, graphs, plain, vocab, seed, dev, kind, smi,
                  timed: bool = True) -> None:
    """Every served bucket (``SERVE_SEQS`` x ``SERVE_SMALL`` +
    ``SERVE_BATCHES``) on a seeded padded batch: the graph replay equals
    the eager forward bit for bit, and the eager forward (the kernels)
    agrees with the plain versions' forward within the logit tolerance;
    the bench's buckets timed eagerly and as replays (5 windows of >=
    0.25 s; with ``timed``)."""
    eager = graphs.forward
    for s in SERVE_SEQS:
        for b in SERVE_SMALL + SERVE_BATCHES:
            x = packed_batch(vocab, b, s, seed + 1000 * s + b, dev)
            got, want = graphs(x), eager(x)
            ref = plain(SE.unpack_batch(x), "plain")["logits"]
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{name} B={b} S={s}: the graph replay differs from "
                     "the eager forward")
            if not (torch.isfinite(want).all() and torch.allclose(
                    want, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)):
                fail(f"{name} B={b} S={s}: the kernels' logits disagree "
                     "with the plain versions'")
            line = (f"  [{name}] B={b} S={s}: graph == eager bit for bit; "
                    f"|eager - plain| {(want - ref).abs().max().item():.3e}")
            if timed and b in SERVE_BATCHES:
                tg = window_ms(lambda: graphs(x), window_s=0.25)
                te = window_ms(lambda: eager(x), window_s=0.25)
                line += (f"; ms per call, median (least-most) of 5 windows "
                         f"({kind}, {smi}): graph {tg[0]:.3f} ({tg[1]:.3f}-"
                         f"{tg[2]:.3f}), eager {te[0]:.3f} ({te[1]:.3f}-"
                         f"{te[2]:.3f}), eager / graph {te[0] / tg[0]:.2f}")
            print(line, flush=True)


def closed_loop(name, eng, vocab, seed, kind, smi) -> tuple:
    """The bench's closed loop through ``eng`` (started and stopped here),
    then every request once more for its answer; every batch's input and
    logits recorded by a wrapper of its forward (references only: each is
    a fresh tensor). Returns (log, requests, answers)."""
    log, forward = [], eng.forward

    def recording(batch):
        out = forward(batch)
        log.append((batch, out))
        return out

    eng.forward = recording
    reqs = serve_requests(vocab, seed)
    try:
        with eng:
            del log[:]  # the warm-up's batches
            # garbage of earlier phases (an engine kept by a reference
            # cycle frees its graphs and pool when collected) is freed
            # now, not inside the timed loop
            gc.collect()
            snap = eng.run_closed_loop(reqs, concurrency=SERVE_CONCURRENCY)
            # every request again, for its answer (run_closed_loop keeps
            # its futures to itself)
            futs = [eng.submit_ids(r) for r in reqs]
            answers = [f.result(120) for f in futs]
    finally:
        eng.forward = forward
    print(f"  [{name}] closed loop, {SERVE_REQUESTS} requests of 8-127 "
          f"tokens at concurrency {SERVE_CONCURRENCY} ({kind}, {smi}): "
          f"seq/s {snap['seq_per_sec']:.1f}, tokens/s "
          f"{snap['tokens_per_sec']:.1f}, latency ms p50 "
          f"{snap['latency_ms_p50']:.3f} p99 {snap['latency_ms_p99']:.3f}, "
          f"avg_batch {snap['avg_batch']:.2f} over {snap['batches']} "
          f"batches, {snap['wall_s']:.3f} s", flush=True)
    if snap["requests"] != SERVE_REQUESTS:
        fail(f"{name}: {snap['requests']} requests answered")
    return log, reqs, answers


def check_requests(name, eager, log, reqs, answers) -> None:
    """Every recorded batch's logits equal the eager forward's on the same
    padded bucket batch bit for bit, and each request was answered with
    its row in a batch that held it (found by its ids and length)."""
    rows = {}
    for batch, out in log:
        if not torch.equal(out, eager(batch)):
            fail(f"{name}: a served batch {tuple(batch.shape)} differs from "
                 "the eager forward on it")
        ids, n = batch[0].cpu().numpy(), batch[1].sum(1).cpu().numpy()
        for i in np.flatnonzero(n):
            rows.setdefault(ids[i, :n[i]].tobytes(), []).append(
                out[i].cpu().numpy())
    for r, got in zip(reqs, answers):
        if not any(np.array_equal(got, w) for w in rows.get(r.tobytes(), [])):
            fail(f"{name}: a request's logits are not its batch row's")
    print(f"  [{name}] {len(log)} served batches equal the eager forward "
          f"bit for bit; {len(reqs)} requests' logits equal their rows",
          flush=True)


def check_lazy_capture(tag, eager, vocab, seed, dev) -> None:
    """``precompile=False`` (the JAX default) on a fresh ``BucketGraphs``
    over the eager forward, with the dict transfer and ``ServeConfig``'s
    default batch buckets up to 64: 15 seeded bursts (1, 3, 7, 20 or 50
    requests, all of one seq bucket), each sent once the one before is
    dispatched, so each batch is of a new shape, captured on first use
    on the scheduler thread while the resolver copies the batch before;
    every served batch equals the eager forward on it bit for bit and
    every request its row."""
    graphs = SG.BucketGraphs(eager, dev)
    log = []

    def recording(batch):
        out = graphs(batch)
        log.append((torch.stack([batch["input_ids"],
                                 batch["attention_mask"].to(torch.int32),
                                 batch["token_type_ids"]]), out))
        return out

    cfg = SE.ServeConfig(max_batch=64, seq_buckets=SERVE_SEQS,
                         batch_buckets=(1, 2, 4, 8, 16, 32, 64),
                         pipeline_depth=5)
    rng = np.random.RandomState(seed + 2)
    bursts = [(n, s) for n in (1, 3, 7, 20, 50) for s in SERVE_SEQS]
    rng.shuffle(bursts)
    reqs, futs = [], []
    with SE.ServingEngine(recording, cfg, device=dev) as eng:
        for k, (n, s) in enumerate(bursts):
            for length in rng.randint(s // 2 + 1, s + 1, n):
                reqs.append(rng.randint(4, vocab, length).astype(np.int32))
                futs.append(eng.submit_ids(reqs[-1]))
            # the next burst once this one is dispatched: its batch is
            # captured while the resolver copies this one's logits
            deadline = time.perf_counter() + 120
            while len(log) <= k and time.perf_counter() < deadline:
                time.sleep(0.0002)
        answers = [f.result(120) for f in futs]
    print(f"  [{tag} lazy] {len(graphs.graphs)} buckets captured on first "
          f"use while serving {len(log)} batches of {len(reqs)} requests",
          flush=True)
    shapes = {tuple(b.shape) for b, _ in log}
    if len(graphs.graphs) != len(shapes) or len(shapes) < len(bursts) // 2:
        fail(f"{tag} lazy: {len(graphs.graphs)} captures for {len(shapes)} "
             f"batch shapes from {len(bursts)} bursts")
    check_requests(f"{tag} lazy", lambda x: eager(SE.unpack_batch(x)), log,
                   reqs, answers)


def check_http(eng) -> None:
    """``make_server`` (``serve``'s socket) on a free localhost port in a
    thread: /classify on ``SERVE_TEXTS`` equals ``classify()`` bit for
    bit, /metrics counts them, /healthz answers; stopped after."""
    import urllib.request

    eng.metrics = SE.Metrics()
    eng.start()
    httpd = SVS.make_server(eng, 0, "127.0.0.1")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for a, b in SERVE_TEXTS:
            body = json.dumps({"text": a, "pair": b}).encode()
            req = urllib.request.Request(
                url + "/classify", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                got = np.float32(json.loads(r.read())["logits"])
            if not np.array_equal(got, eng.classify(a, b)):
                fail(f"HTTP /classify {a[:20]!r}: differs from classify()")
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            m = json.loads(r.read())
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
        eng.stop()
    if m["requests"] != 2 * len(SERVE_TEXTS) or health != {"status": "ok"}:
        fail(f"HTTP /metrics {m} or /healthz {health}")
    print(f"  [http] {len(SERVE_TEXTS)} /classify answers equal classify() "
          f"bit for bit; /metrics requests={m['requests']}; /healthz ok",
          flush=True)


def serve_checkpoint(family, cfg, params, qstate, dev) -> SE.ServingEngine:
    """The W8A8 model written as a checkpoint directory (a temporary one)
    and served from it by ``build_engine_from_checkpoint`` on ``dev``
    with :func:`serve_config` (not started)."""
    with tempfile.TemporaryDirectory() as d:
        CK.save_checkpoint(d, params=params, family=family, cfg=cfg,
                           qstate=qstate)
        eng = SVS.build_engine_from_checkpoint(d, device=dev,
                                               serve_cfg=serve_config())
    torch.cuda.synchronize()
    return eng


def serve_phase(tag, cfg, params, qstate, plain, per_fwd, seed, dev, kind,
                smi, by_path, eager_loop=False) -> None:
    """Phase 11 for one model: its W8A8 checkpoint written and served by
    ``build_engine_from_checkpoint`` on the card; the bench's buckets
    captured largest first (launch counts read over the captures: the
    eager warm-up and the capture of each), every bucket checked, the
    closed loop on the graphs (no Python-counted launch: replays only),
    its requests checked; with ``eager_loop`` the same loop on the eager
    forward and the HTTP front end."""
    t0 = time.perf_counter()
    eng = serve_checkpoint(tag, cfg, params, qstate, dev)
    t_load = time.perf_counter() - t0
    graphs = eng.forward
    EK.reset_launches()
    t0 = time.perf_counter()
    eng.warmup()
    t_cap = time.perf_counter() - t0
    n = len(eng.buckets())
    caps = dict(EK.LAUNCHES)
    print(f"  [{tag}] checkpoint written and served: {t_load:.1f} s; "
          f"{n} buckets captured largest first in {t_cap:.2f} s; launches "
          f"over the captures {caps}", flush=True)
    if caps != {k: 2 * n * v for k, v in per_fwd.items()}:
        fail(f"{tag}: launches over {n} captures {caps}, expected twice "
             f"{per_fwd} a bucket")
    by_path[f"serve-{tag}"] = caps
    check_buckets(tag, graphs, plain, cfg.vocab_size, seed, dev, kind, smi)
    EK.reset_launches()
    log, reqs, answers = closed_loop(f"{tag} graphs", eng, cfg.vocab_size,
                                     seed, kind, smi)
    if any(EK.LAUNCHES.values()):
        fail(f"{tag}: the closed loop launched outside its graphs: "
             f"{EK.LAUNCHES}")
    check_requests(f"{tag} graphs", graphs.forward, log, reqs, answers)
    if not eager_loop:
        return
    eager = SE.ServingEngine(graphs.forward, serve_config(), device=dev)
    EK.reset_launches()
    elog, reqs, answers = closed_loop(f"{tag} eager", eager, cfg.vocab_size,
                                      seed, kind, smi)
    launches = dict(EK.LAUNCHES)
    fwds = n + len(elog)  # the warm-up's and the served batches'
    print(f"  [{tag} eager] launches over {fwds} forwards: {launches}",
          flush=True)
    if launches != {k: fwds * v for k, v in per_fwd.items()}:
        fail(f"{tag} eager: launches {launches}, expected {per_fwd} a "
             "forward")
    by_path[f"serve-{tag}-eager"] = launches
    check_requests(f"{tag} eager", graphs.forward, elog, reqs, answers)
    check_lazy_capture(tag, graphs.forward, cfg.vocab_size, seed, dev)
    check_http(eng)


def serve_option_case(tag, cfg, params, qstate, bf16, route, plain, per_fwd,
                      seed, dev, kind, smi, by_path) -> None:
    """Phase 11's option cases: BERT-base's checkpoint served with
    ``bf16`` (the engine at ``engine_dtype`` bfloat16) or, without quant
    state, through the generic fallback (bfloat16 attention): the served
    route, the launches over the nine bucket captures (twice ``per_fwd``
    a bucket), and at every bucket the graph replay equal to the eager
    forward bit for bit and the eager forward within the logit tolerance
    of ``plain``'s."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        CK.save_checkpoint(d, params=params, family="bert", cfg=cfg,
                           **({} if qstate is None else {"qstate": qstate}))
        eng = SVS.build_engine_from_checkpoint(d, device=dev, bf16=bf16,
                                               serve_cfg=serve_config())
    graphs = eng.forward
    if graphs.route != route:
        fail(f"{tag}: served by the {graphs.route} route, expected {route}")
    EK.reset_launches()
    eng.warmup()
    n = len(eng.buckets())
    caps = dict(EK.LAUNCHES)
    print(f"  [{tag}] served by the {route} route: {n} buckets captured in "
          f"{time.perf_counter() - t0:.1f} s with the checkpoint; launches "
          f"over the captures {caps}", flush=True)
    if caps != {k: 2 * n * v for k, v in per_fwd.items()}:
        fail(f"{tag}: launches over {n} captures {caps}, expected twice "
             f"{per_fwd} a bucket")
    by_path[f"serve-{tag}"] = caps
    check_buckets(tag, graphs, plain, cfg.vocab_size, seed, dev, kind, smi,
                  timed=False)


# phase 12: W4A8, split-half packed int4 weights (K1's and the fused
# linear's packed-int4 instances). The ragged shapes: M = 8 and N = 200 as
# check_other_shapes, K = 800 and 864 (K/2 = 400, 432: a ragged last
# packed box, which TMA zero-fills) and M, N off the tiles
W4_SHAPES = ((8, 200, 800), (1000, 136, 864), (300, 200, 800))
W4_REFUSED_K = 784   # K/2 = 392: packed rows off TMA's 16-byte stride


def w4a8_defaults():
    """The W4A8 recipe: current-minmax 4-bit symmetric weights, 8-bit
    asymmetric activations (the JAX package's tests/test_engine.py W4A8
    engine test)."""
    return dataclasses.replace(CAL.w8a8_defaults(), n_bits=4, n_bits_act=8)


def w4_matmul_case(tag, x, mp, act) -> dict:
    """K1's packed-int4 instance on ``x`` with the int4 matmul plan ``mp``:
    bit-identical to its plain version and to K1 int8 on the unpacked
    weight; kernel, K1 int8 (``int8_ms``), plain and ``torch._int_mm`` (on
    the unpacked weight, the int32 product only) ms; the bound with the
    weight at K/2 bytes a row."""
    m = x.shape[0]
    n, k2 = mp["w"].shape
    k = 2 * k2
    w8 = IL.unpack_int4(mp["w"], k)
    vecs, scal = mp["vecs"], mp["scal"]
    w4 = lambda: EK.int8_matmul(x, mp["w"], vecs, scal, activation=act,
                                w4=True)
    int8 = lambda: EK.int8_matmul(x, w8, vecs, scal, activation=act)
    name = f"int8_matmul_w4[{tag}] {m}x{k}->{n}"
    compare(w4(), int8(), f"{name} vs K1 int8 on the unpacked weight")
    w_t = w8.t()
    res = kernel_case(
        name, w4,
        lambda: EK.int8_matmul_ref(x, mp["w"], vecs, scal, activation=act,
                                   w4=True),
        2.0 * m * n * k, m * k + n * k2 + 5 * n * 4 + m * n,
        lib_fn=lambda: torch._int_mm(x, w_t))
    res["int8_ms"] = device_ms(int8)
    print(f"  {name}: w4 {res['ms']:.4f} ms, K1 int8 {res['int8_ms']:.4f} "
          f"ms, torch._int_mm {res['library_ms']:.4f} ms")
    return res


def w4_layer_cases(x8, c8, hx8, i8, lp, rows=None) -> dict:
    """The four matmuls of a W4A8 layer (on the first ``rows`` rows of
    their inputs), per layer."""
    sl = slice(None) if rows is None else slice(0, rows)
    cases = [(w4_matmul_case("qkv", x8[sl], lp["qkv"], None), 1),
             (w4_matmul_case("attn_out", c8[sl], lp["attn_out"], None), 1),
             (w4_matmul_case("inter", hx8[sl], lp["inter"], "gelu_new"), 1),
             (w4_matmul_case("dense", i8[sl], lp["dense"], None), 1)]
    out = per_layer(cases)
    out["int8_ms"] = sum(c["int8_ms"] for c, _ in cases)
    return out


def check_w4_kernels(params, cfg, q4, s4, int4, static4, plan4, batch,
                     dev) -> dict:
    """Phase 12, the matmul: K1 w4 on layer 0's inputs of the W4A8 engine
    (plain versions) at B=128, S=128 (M = 16384) and on their first 256
    rows (M = 256, the (8, 32) serving bucket's rows)."""
    h, mask = entry_value(params, cfg, q4, s4, int4, batch, dev)
    es = plan4["entry_scal"]
    x8 = EK.quantize_payload(h.reshape(BATCH * SEQ, -1), es[0, 0], es[0, 1])
    lp = plan4["layers"][0]
    w4q, w4o, w4i, w4d = static4.w4[0]
    if not (w4q and w4o and w4i and w4d):
        fail(f"W4A8 layer 0's matmuls are not all int4: {static4.w4[0]}")
    qkv8 = EK.int8_matmul_ref(x8, *_mm(lp["qkv"]), w4=True)
    c8 = EK.int8_attention_ref(qkv8, mask, lp["attn_scal"],
                               n_heads=cfg.num_attention_heads, seq=SEQ,
                               skip_max=static4.attn_skip_max)
    hx8 = EK.int8_matmul_add_ln_ref(c8, *_mm(lp["attn_out"]), x8,
                                    lp["ln1"]["gb"], lp["ln1"]["scal"],
                                    eps=static4.ln_eps, w4=True)
    i8 = EK.int8_matmul_ref(hx8, *_mm(lp["inter"]), activation="gelu_new",
                            w4=True)
    out = w4_layer_cases(x8, c8, hx8, i8, lp)
    small = w4_layer_cases(x8, c8, hx8, i8, lp, rows=256)
    out["variants"] = {"M=256": small}
    for tag, r in (("M=16384", out), ("M=256", small)):
        print(f"  int8_matmul_w4 per layer at {tag}: w4 {r['ms']:.4f} ms, "
              f"K1 int8 {r['int8_ms']:.4f} ms, torch._int_mm "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return out


def check_w4_linear_kernels(params, cfg, q4, s4, int4, batch, dev) -> dict:
    """Phase 12, the fused linear: its int4 calls in one W4A8 generic
    forward on the plain version (layer 0's q with a float32 x, attn_out,
    inter with gelu emitting the payload, dense on the payload, the pooler
    at M = B), each bit-identical to its plain version and to the int8
    kernel on the unpacked weight."""
    run = generic_runner(params, cfg, q4, s4, int4, dev)
    calls = record_calls(lambda: run(batch, "plain"),
                         (LY, "fused_int8_linear"))[0]
    L = cfg.num_hidden_layers
    if len(calls) != 6 * L + 2:
        fail(f"W4A8 fused linear calls per forward: {len(calls)}")
    cases = {"q": calls[0], "attn_out": calls[3], "inter": calls[4],
             "dense": calls[5], "pooler": calls[-2]}
    res = {}
    for tag, (args, kw) in cases.items():
        packed = args[1]
        if "w_packed" not in packed:
            fail(f"W4A8 fused linear [{tag}]: an int8 weight")
        k = args[0].shape[-1]
        p8 = {key: v for key, v in packed.items()
              if key not in ("w_packed", "in_features")}
        p8["w_int"] = IL.unpack_int4(packed["w_packed"], k)
        got = IM.fused_int8_linear(*args, **dict(kw, plain=False))
        int8 = IM.fused_int8_linear(args[0], p8, *args[2:],
                                    **dict(kw, plain=False))
        torch.cuda.synchronize()
        if not torch.equal(got, int8):
            fail(f"fused_int8_linear_w4[{tag}] differs from the int8 kernel "
                 "on the unpacked weight")
        res[tag] = linear_case(tag, args, kw)
    out = per_layer([(res["q"], 3), (res["attn_out"], 1), (res["inter"], 1),
                     (res["dense"], 1)])
    out["variants"] = {"pooler": per_layer([(res["pooler"], 1)])}
    print(f"  fused_int8_linear_w4 per layer {out['ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
    return out


def check_w4_shapes(dev) -> None:
    """Phase 12, the edges: K1 w4 at ``W4_SHAPES`` over every activation and
    output (and the 16-bit fold), and the fused linear w4 on a float32 x
    and a payload over its outputs, each against its plain version and the
    int8 kernel on the unpacked weight; K = 784 raises in K1's wrapper and
    the fused linear declines it (None: the caller's int path)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    asym = Q.QuantizerSpec(n_bits=8, method=Q.QMethod.asymmetric_uniform)
    scal = torch.tensor([[0.03, 5.0]], device=dev)
    for m, n, k in W4_SHAPES:
        wp = torch.randint(0, 256, (n, k // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
        w8 = IL.unpack_int4(wp, k)
        vecs = torch.stack([torch.full((n,), 2e-3, device=dev),
                            w8.float().sum(1), torch.zeros(n, device=dev),
                            torch.full((n,), 0.05, device=dev),
                            torch.full((n,), 3.0, device=dev)])
        x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        cases = [(a, mode, 8) for a in (None, "gelu_new", "relu")
                 for mode in ("emit", "fold", "float")] + [(None, "fold", 16)]
        for act, mode, bits in cases:
            kw = dict(activation=act, out_mode=mode, out_bits=bits)
            got = EK.int8_matmul(x, wp, vecs, scal, w4=True, **kw)
            tag = f"int8_matmul_w4 {m}x{k}->{n} act={act} {mode} {bits}-bit"
            for want, what in ((EK.int8_matmul_ref(x, wp, vecs, scal,
                                                   w4=True, **kw), "plain"),
                               (EK.int8_matmul(x, w8, vecs, scal, **kw),
                                "K1 int8")):
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"{tag} vs {what}: max err "
                         f"{(got.float() - want.float()).abs().max()}")
        print(f"  int8_matmul_w4 {m}x{k}->{n}: {len(cases)} act x output "
              "cases bit-identical to the plain version and to K1 int8")
        packed = {"w_packed": wp, "in_features": k,
                  "scale": 1e-2 * (1 + torch.rand(n, generator=gen,
                                                  device=dev)),
                  "colsum": w8.float().sum(1)}
        p8 = {"w_int": w8, "scale": packed["scale"],
              "colsum": packed["colsum"]}
        bias = 0.1 * torch.randn(n, generator=gen, device=dev)
        xf = 1.5 * torch.randn(m, k, generator=gen, device=dev)
        if m % 8:
            continue   # the fused linear takes M % 8 == 0
        in_qp = Q.set_quant_range(asym, xf.min(), xf.max())
        n_cases = 0
        for xin in (xf, IL.quantize_activation_int8(asym, in_qp, xf)[0]):
            for act in (None, "gelu", "relu"):
                y = IM.fused_int8_linear(xin, packed, asym, in_qp, bias=bias,
                                         activation=act, plain=True)
                oqp = Q.set_quant_range(asym, y.min(), y.max())
                for out in ("none", "fold", "emit"):
                    kw = dict(bias=bias, activation=act)
                    if out != "none":
                        kw.update(out_spec=asym, out_qp=oqp,
                                  emit_int8=out == "emit")
                    got = IM.fused_int8_linear(xin, packed, asym, in_qp, **kw)
                    for want in (IM.fused_int8_linear(xin, packed, asym,
                                                      in_qp, plain=True, **kw),
                                 IM.fused_int8_linear(xin, p8, asym, in_qp,
                                                      **kw)):
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            fail(f"fused_int8_linear_w4 {m}x{k}->{n} act="
                                 f"{act} {out}: max err "
                                 f"{(got.float() - want.float()).abs().max()}")
                    n_cases += 1
        print(f"  fused_int8_linear_w4 {m}x{k}->{n}: {n_cases} input x act "
              "x output cases bit-identical to the plain version and to the "
              "int8 kernel")
    k = W4_REFUSED_K
    wp = torch.zeros((136, k // 2), device=dev, dtype=torch.uint8)
    x = torch.zeros((8, k), device=dev, dtype=torch.int8)
    vecs = torch.ones((5, 136), device=dev)
    try:
        EK.int8_matmul(x, wp, vecs, scal, w4=True)
    except ValueError as e:
        print(f"  int8_matmul_w4 at K = {k} raises: {e}")
    else:
        fail(f"int8_matmul_w4 took K = {k}")
    packed = {"w_packed": wp, "in_features": k,
              "scale": torch.ones(136, device=dev),
              "colsum": torch.zeros(136, device=dev)}
    xf = torch.randn(8, k, generator=gen, device=dev)
    if IM.fused_int8_linear(xf, packed, asym,
                            Q.set_quant_range(asym, xf.min(),
                                              xf.max())) is not None:
        fail(f"fused_int8_linear_w4 took K = {k}")
    print(f"  fused_int8_linear at K = {k} on an int4 weight: None (the int "
          "path)")


def encoder_weight_bytes(plan) -> int:
    """Bytes of an engine plan's encoder weights as stored on the card,
    a tensor that several layers share (ALBERT's) counted once."""
    return sum({lp[k]["w"].data_ptr(): lp[k]["w"].numel()
                * lp[k]["w"].element_size()
                for lp in plan["layers"]
                for k in ("qkv", "attn_out", "inter", "dense")}.values())


def w4a8_phase(params, cfg, plan8, batches, by_path, seed, dev, kind,
               smi) -> dict:
    """Phase 12: BERT-base W4A8 from ``seed``'s params: calibration,
    int4 packing and the engine plan; K1 w4 and the fused linear w4 on the
    main path's inputs and at the edges; three request batches through the
    engine and the generic path, with the launch counts read just after;
    engine and generic seq/s; the packed encoder weights' bytes."""
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    _, q4, s4 = CAL.calibrated_bert(cfg, batch_size=8, seq=SEQ, seed=seed,
                                    device=dev, params=params,
                                    defaults=w4a8_defaults())
    int4 = B.build_bert_int_params(params, q4, s4, use_int4=True)
    static4, plan4, _ = B.build_bert_engine(params, cfg, q4, s4,
                                            int_params=int4, device=dev)
    torch.cuda.synchronize()
    b4, b8 = encoder_weight_bytes(plan4), encoder_weight_bytes(plan8)
    print(f"  set-up (W4A8 calibration, int4 packing, plan): "
          f"{time.perf_counter() - t0:.1f} s; w4 flags {static4.w4[0]} a "
          f"layer; packed encoder weights {b4} bytes (int4) against {b8} "
          f"(int8), {b4 / b8:.3f}x", flush=True)
    b0 = batches[0]
    report = {"int8_matmul_w4": check_w4_kernels(
        params, cfg, q4, s4, int4, static4, plan4, b0, dev)}
    report["fused_int8_linear_w4"] = check_w4_linear_kernels(
        params, cfg, q4, s4, int4, b0, dev)
    check_w4_shapes(dev)
    eng = bert_runner(params, cfg, q4, s4, static4, plan4, int4, dev)
    by_path["w4a8"] = drive_path(
        "w4a8", eng, cfg, batches,
        per_forward(int8_matmul_w4=4 * L, int8_attention=L,
                    fused_add_ln_payload=2 * L))
    gen = generic_runner(params, cfg, q4, s4, int4, dev)
    by_path["generic-w4a8"] = drive_path(
        "generic-w4a8", gen, cfg, batches,
        per_forward(fused_int8_linear_w4=6 * L + 1,
                    fused_linear_quantize=5 * L + 1))
    t_eng = window_ms(lambda: eng(b0, "kernels"))
    t_gen = window_ms(lambda: gen(b0, "kernels"))
    print(f"  seq/s at B={BATCH}, S={SEQ}, median (range) of 5 windows "
          f"({kind}, {smi}): W4A8 engine {seq_per_s(t_eng)} (forward "
          f"{t_eng[0]:.3f} ms), W4A8 generic on the fused linear "
          f"{seq_per_s(t_gen)} (forward {t_gen[0]:.3f} ms)")
    return report


# phase 13: the JAX CLI's qat-w4a8 recipe, trained for QAT_STEPS optimizer
# steps on synthetic RTE examples (QAT_EXAMPLES: every step in the first
# epoch), its float fake-quant forward for QAT_FLOAT_STEPS beside it
QAT_STEPS, QAT_FLOAT_STEPS, QAT_TIMED_FROM = 40, 20, 10
QAT_EXAMPLES = 8 * 48
# the route-ratio rule between three routes of one model at 12 layers
# (tests/test_torch_adaround_depth.py's ROUTE_RATIO): a level flip from
# another rounding order spreads through its sequence (the parity
# contract's depth rule), so no two routes meet the logit tolerance, but
# the JAX package's own routes keep their gaps within ROUTE_RATIO of each
# other: the engine's gaps to the fake-quant forward and to the middle
# route (the generic int path, or the int8 QAT forward) at most
# ROUTE_RATIO times the middle route's gap to the fake-quant forward
ROUTE_RATIO = 2.0
# the most of the fake-quant logits that may sit at an end of the
# classifier.out grid, where every route agrees whatever came before
ROUTE_MAX_CLIPPED = 0.5


def grid_end_frac(logits, spec, qp) -> float:
    """The share of ``logits`` whose level on the classifier.out grid is
    its smallest or largest: a clipped logit agrees across routes
    whatever came before it."""
    lv = Q.to_int(spec, qp, logits)
    lo, hi = Q.int_min_max(spec, qp.signed)
    return float(((lv == lo) | (lv == hi)).float().mean())


def route_gaps(tag, engine, mid, flt, mid_name, step, clipped) -> dict:
    """The gaps between an engine's logits, a middle route's (``mid``,
    named ``mid_name``) and the fake-quant forward's (``flt``) on one
    batch, in logits and in levels of the classifier.out grid (``step``),
    beside ``clipped``, the share of the compared fake-quant logits at an
    end of that grid. Fails on non-finite logits, past
    ``ROUTE_MAX_CLIPPED`` clipped, or where an engine gap exceeds
    ``ROUTE_RATIO`` times the middle route's gap to the fake-quant
    forward. Returns {pair: max |diff|}."""
    print(f"  {tag}: logit scale {float(flt.abs().max()):.4e}, "
          f"classifier.out step {step:.4e}, {clipped:.4f} of {flt.numel()} "
          "compared fake-quant logits at an end of its grid")
    if clipped > ROUTE_MAX_CLIPPED:
        fail(f"{tag}: {clipped:.4f} of the logits clipped, the routes' "
             "gaps would not show")
    ref = f"{mid_name}-fq"
    gaps = {}
    for pair, a, b in (("engine-fq", engine, flt), (ref, mid, flt),
                       (f"engine-{mid_name}", engine, mid)):
        if not torch.isfinite(a).all():
            fail(f"{tag} {pair}: non-finite logits")
        d = (a - b).abs()
        gaps[pair] = float(d.max())
        print(f"    {pair}: max |diff| {gaps[pair]:.4e} = "
              f"{gaps[pair] / step:.2f} levels, "
              f"{float((d / step > 0.5).float().mean()):.4f} of "
              f"{d.numel()} logits off")
    for pair in ("engine-fq", f"engine-{mid_name}"):
        if gaps[pair] > ROUTE_RATIO * gaps[ref]:
            fail(f"{tag}: {pair} {gaps[pair]:.4e} beyond {ROUTE_RATIO} x "
                 f"{ref} {gaps[ref]:.4e}")
    print(f"  {tag}: engine gaps within {ROUTE_RATIO} x {ref} (ratios "
          + ", ".join(f"{pair} / {ref} {gaps[pair] / max(gaps[ref], 1e-30):.2f}"
                      for pair in ("engine-fq", f"engine-{mid_name}"))
          + ")")
    return gaps


def site_gaps(tag, engine, mid, flt, mid_name, spec, qp) -> dict:
    """:func:`route_gaps` on logits quantized on the classifier.out grid
    (``spec``, ``qp``)."""
    return route_gaps(tag, engine, mid, flt, mid_name,
                      float(Q.scale_of(spec, qp)),
                      grid_end_frac(flt, spec, qp))


def rte_arrays(cfg, split: str, n: int, seed: int) -> dict:
    """``n`` synthetic RTE examples of ``split`` through the hash tokenizer
    (``SEQ`` tokens), the token types 0 where the model has one type (a
    RoBERTa tokenizer gives no other)."""
    task = GL.TASKS["rte"]
    arrays = DATA.encode_examples(
        DATA.SyntheticTokenizer(cfg.vocab_size), task,
        GL.synthetic_examples(task, split, n, seed=seed), SEQ)
    if cfg.type_vocab_size == 1:
        arrays["token_type_ids"] = np.zeros_like(arrays["token_type_ids"])
    return arrays


def rte_batch(cfg, seed: int, n: int = BATCH) -> dict:
    """``n`` synthetic RTE validation examples (:func:`rte_arrays`), drawn
    as the QAT and AdaRound recipes' calibration examples are: the model
    inputs only."""
    arrays = rte_arrays(cfg, "validation", n, seed)
    return {k: arrays[k] for k in ("input_ids", "attention_mask",
                                   "token_type_ids")}


def check_qat_products(apply_fn, params, qcfg, qstate, qat, batch, *,
                       per_layer=6, extra=2,
                       picks=(("L0.attn.q", 0), ("L0.attn_out", 3),
                              ("L0.ffn.inter", 4), ("L0.ffn.dense", 5)),
                       n_layers=None, last="classifier") -> None:
    """The int8 QAT forward's products on one training batch's calls
    (``per_layer`` a layer of ``n_layers``, default the params' layers,
    and ``extra`` more): the ``picks`` (name, call index; BERT's: layer
    0's four matmuls q, attn_out, inter, dense) and the last call, named
    ``last`` (BERT's classifier, M = 8, N = 2: ``torch._int_mm`` on
    zero-padded operands), each ``int8_product`` (``torch._int_mm``)
    against the exact plain product, bit for bit."""
    calls, = record_calls(
        lambda: apply_fn(params, batch, qcfg=qcfg, qstate=qstate,
                         mode=QuantMode(),
                         int8_qat_sites=qat.int8_sites),
        (TI, "int8_qat_linear"))
    if n_layers is None:
        n_layers = len(params["layers"])
    print(f"  int8 QAT forward: {len(calls)} int8 matmuls a forward")
    if len(calls) != per_layer * n_layers + extra:
        fail(f"int8 QAT forward: {len(calls)} int8 matmuls, expected "
             f"{per_layer * n_layers + extra}")
    for tag, i in picks + ((last, len(calls) - 1),):
        a = calls[i][0]
        p_x, p_w, _, _ = TI.int8_payloads(a[0], a[1], a[3], a[4], a[5],
                                          a[6], a[7])
        p_x = p_x.reshape(-1, p_x.shape[-1])
        got = TI.int8_product(p_x, p_w)
        want = IL.exact_int_matmul(p_x, p_w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"int8 QAT {tag}: torch._int_mm product differs from the "
                 "exact plain product")
        print(f"  int8 QAT {tag} {tuple(p_x.shape)} x {tuple(p_w.shape)}: "
              f"torch._int_mm product == exact plain product (bit for bit)")


def qat_train(apply_fn, params, task, arrays, tcfg, qcfg, qstate, qat,
              steps, timed_from=QAT_TIMED_FROM):
    """``TT.train`` for ``steps`` optimizer steps: the trained ``(params,
    qstate)``, each step's loss and the median ms a step over steps
    ``timed_from``.. (host clock between steps, each step's loss read
    back)."""
    marks, losses = [], []

    def cb(i, loss):
        losses.append(float(loss))
        marks.append(time.perf_counter())

    out = TT.train(apply_fn, params, task, arrays,
                   dataclasses.replace(tcfg, max_steps=steps, log_every=10),
                   qcfg=qcfg, qstate=qstate, qat_cfg=qat,
                   log_fn=lambda s: print(f"    {s}"), step_callback=cb)
    ms = float(np.median(np.diff(marks[timed_from - 1:]))) * 1e3
    return out, losses, ms


def engine_entry(run, batch):
    """The entry value (B, S, H) and (B, S) mask bias that the engine
    forward ``run`` hands ``encoder_engine`` on ``batch`` (one forward on
    the plain versions, recorded)."""
    (call,), = record_calls(lambda: run(batch, "plain"),
                            (ENG, "encoder_engine"))
    h, mask = call[0][:2]
    return h, mask


def check_layer0_kernels(tag, h, mask, n_heads, static, plan, w4,
                         timed=False):
    """K1 (layer 0's four matmuls; the packed int4 instance with ``w4``),
    K2 and K3 (both add+LNs) on an engine's layer-0 payloads from the
    entry value ``h`` and mask bias ``mask``, each against its plain
    version, bit for bit. With ``timed``, returns K1's device ms on each
    of the four matmuls (CUDA-graph replay)."""
    es = plan["entry_scal"]
    x8 = EK.quantize_payload(h.reshape(BATCH * SEQ, -1), es[0, 0], es[0, 1])
    lp = plan["layers"][0]
    akw = dict(n_heads=n_heads, seq=SEQ, skip_max=static.attn_skip_max)
    eps = static.ln_eps
    k1 = f"{tag} K1" + (" w4" if w4 else "")
    qkv = lambda f: f(x8, *_mm(lp["qkv"]), w4=w4)
    qkv8 = qkv(EK.int8_matmul_ref)
    compare(qkv(EK.int8_matmul), qkv8, f"{k1} qkv")
    c8 = EK.int8_attention_ref(qkv8, mask, lp["attn_scal"], **akw)
    compare(EK.int8_attention(qkv8, mask, lp["attn_scal"], **akw), c8,
            f"{tag} K2")
    ao = lambda f: f(c8, *_mm(lp["attn_out"]), w4=w4)
    y8 = ao(EK.int8_matmul_ref)
    compare(ao(EK.int8_matmul), y8, f"{k1} attn_out")
    ln1 = EK.fold_ln_scalars(lp["attn_out"]["vecs"], lp["ln1"]["scal"])
    hx8 = EK.fused_add_ln_payload_ref(y8, x8, lp["ln1"]["gb"], ln1, eps=eps)
    compare(EK.fused_add_ln_payload(y8, x8, lp["ln1"]["gb"], ln1, eps=eps),
            hx8, f"{tag} K3 ln1")
    inter = lambda f: f(hx8, *_mm(lp["inter"]), activation="gelu_new",
                        w4=w4)
    i8 = inter(EK.int8_matmul_ref)
    compare(inter(EK.int8_matmul), i8, f"{k1} inter")
    dense = lambda f: f(i8, *_mm(lp["dense"]), w4=w4)
    d8 = dense(EK.int8_matmul_ref)
    compare(dense(EK.int8_matmul), d8, f"{k1} dense")
    ln2 = EK.fold_ln_scalars(lp["dense"]["vecs"], lp["ln2"]["scal"])
    compare(EK.fused_add_ln_payload(d8, hx8, lp["ln2"]["gb"], ln2, eps=eps),
            EK.fused_add_ln_payload_ref(d8, hx8, lp["ln2"]["gb"], ln2,
                                        eps=eps), f"{tag} K3 ln2")
    if not timed:
        return None
    return {name: device_ms(lambda f=f: f(EK.int8_matmul))
            for name, f in (("qkv", qkv), ("attn_out", ao), ("inter", inter),
                            ("dense", dense))}


def qat_phase(params, batches, by_path, seed, dev, kind, smi) -> None:
    """Phase 13: the JAX CLI's ``qat-w4a8`` at BERT-base width and depth
    from ``seed``'s params on synthetic RTE examples: calibration; the
    int8 QAT forward's ``torch._int_mm`` products against the exact plain
    product; ``QAT_STEPS`` optimizer steps on the int8 forward (ms a step
    beside the float fake-quant forward's); the trained model's int8 and
    float forwards; then the learned ranges merged, packed int4 and
    served by the W4A8 engine (K1 w4 / K2 / K3 against their plain
    versions, three request batches with the launches read just after,
    logits against the plain engine and the fake-quant forward, seq/s)."""
    tcfg, qat0 = TT.QAT_RECIPES["qat-w4a8"]
    cfg = dataclasses.replace(B.BertConfig(), hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    task = GL.TASKS["rte"]
    arrays = DATA.encode_examples(
        DATA.SyntheticTokenizer(cfg.vocab_size), task,
        GL.synthetic_examples(task, "train", QAT_EXAMPLES, seed=seed), SEQ)
    rec = CAL.CLI_RECIPES["qat-w4a8"]
    qcfg = B.declare_bert_sites(rec.defaults, cfg, quant_setup=rec.quant_setup)
    apply_fn = functools.partial(B.bert_apply, cfg=cfg, device=dev)
    (qstate, qat), t_cal = timed_s(lambda: TT.prepare_qat(
        apply_fn, params, qcfg, arrays, B.bert_weight_site_tensors(params),
        qat0, rec, device=dev))
    print(f"  calibration (MSE golden-section 4-bit weights, one batch of "
          f"{rec.est_batch_size} x {SEQ} padded): {t_cal:.3f} s", flush=True)
    b8 = {k: v[:tcfg.batch_size] for k, v in arrays.items()}
    check_qat_products(apply_fn, params, qcfg, qstate, qat, b8)

    (p2, q2), losses, ms_i8 = qat_train(apply_fn, params, task, arrays, tcfg,
                                        qcfg, qstate, qat, QAT_STEPS)
    _, _, ms_f = qat_train(apply_fn, params, task, arrays, tcfg, qcfg,
                           qstate, dataclasses.replace(qat, int8_sites=None),
                           QAT_FLOAT_STEPS)
    moved, total, rel = ranges_moved(qcfg, qstate, q2)
    if not all(np.isfinite(losses)):
        fail(f"qat-w4a8: non-finite losses {losses}")
    print(f"  [qat-w4a8] {QAT_STEPS} steps at B={tcfg.batch_size}, S={SEQ} "
          f"({kind}, {smi}): int8 forward {ms_i8:.2f} ms a step (median of "
          f"steps {QAT_TIMED_FROM}-{QAT_STEPS}), float fake-quant forward "
          f"{ms_f:.2f} ms a step (steps {QAT_TIMED_FROM}-{QAT_FLOAT_STEPS}); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; range entries moved "
          f"{moved} of {total}, largest relative change {rel:.4e}",
          flush=True)
    if moved == 0:
        fail("qat-w4a8: no learned range moved")

    b0 = batches[0]
    int4 = B.build_bert_int_params(p2, qcfg, q2, use_int4=True)
    static, plan, _ = B.build_bert_engine(p2, cfg, qcfg, q2, int_params=int4,
                                          device=dev)
    if not all(all(f) for f in static.w4):
        fail(f"qat-w4a8: the engine's matmuls are not all int4: {static.w4}")
    eng = bert_runner(p2, cfg, qcfg, q2, static, plan, int4, dev)
    check_layer0_kernels("qat-w4a8", *engine_entry(eng, b0),
                         cfg.num_attention_heads, static, plan, w4=True)
    by_path["qat-w4a8"] = drive_path(
        "qat-w4a8", eng, cfg, batches,
        per_forward(int8_matmul_w4=4 * L, int8_attention=L,
                    fused_add_ln_payload=2 * L))
    # the trained model's three routes on examples drawn as its
    # calibration and training examples are, by the route-ratio rule.
    # Training shrinks the learned classifier.out range inside the two
    # classes' logit clusters, so most quantized logits clip to an end of
    # the grid, where every route agrees: the routes are compared with
    # the classifier.out site off (its step the unit)
    rb = rte_batch(cfg, seed)
    spec, qp = qcfg["classifier.out"].spec, q2["classifier.out"]["qp"]
    open_q = qcfg.replace_site("classifier.out", enabled=False)
    with torch.no_grad():
        clipped = grid_end_frac(
            apply_fn(p2, rb, qcfg=qcfg, qstate=q2)[0]["logits"], spec, qp)
        flt = apply_fn(p2, rb, qcfg=open_q, qstate=q2)[0]["logits"]
        i8 = apply_fn(p2, rb, qcfg=open_q, qstate=q2,
                      int8_qat_sites=qat.int8_sites)[0]["logits"]
    print(f"  [qat-w4a8] on {BATCH} synthetic RTE examples {clipped:.4f} of "
          "the fake-quant logits sit at an end of the learned classifier.out "
          "grid; compared below with that site off")
    route_gaps(f"[qat-w4a8] W4A8 engine, int8 QAT forward, fake-quant "
               f"forward on {BATCH} synthetic RTE examples, classifier.out "
               "off", bert_runner(p2, cfg, open_q, q2, static, plan, int4,
                                  dev)(rb, "kernels")["logits"],
               i8, flt, "int8", float(Q.scale_of(spec, qp)), 0.0)
    t_eng = window_ms(lambda: eng(b0, "kernels"))
    print(f"  [qat-w4a8] seq/s at B={BATCH}, S={SEQ}, median (range) of 5 "
          f"windows ({kind}, {smi}): trained W4A8 engine {seq_per_s(t_eng)} "
          f"(forward {t_eng[0]:.3f} ms)")


# phase 14: the JAX CLI's w4-adaround recipe (CAL.ADAROUND_RECIPES), cut to
# ADAROUND_SAMPLES samples and ADAROUND_ITERS iterations a layer, on
# synthetic RTE examples; per-iteration times from ADAROUND_TIMED_FROM on
ADAROUND_SAMPLES, ADAROUND_ITERS, ADAROUND_TIMED_FROM = 64, 200, 10
ADAROUND_EVAL = 128
# a layer's shape class, for the per-iteration times
ADAROUND_SHAPES = (("768x768", ("attn.q", "attn.k", "attn.v",
                                "attn_out.dense", "pooler.dense")),
                   ("768x3072 gelu", ("ffn.inter",)),
                   ("3072x768", ("ffn.dense",)),
                   ("word table", ("emb.word",)),
                   ("LayerNorm", ("ln",)))


def adaround_shape(name: str) -> str:
    for label, keys in ADAROUND_SHAPES:
        if any(name.endswith(k) for k in keys):
            return label
    return "other"


class AdaRoundClock:
    """Wraps ``AR.optimize_layer_rounding`` and ``AD._capture_layer_io``
    (the driver calls both through their modules) while AdaRound runs:
    the capture seconds (synchronized) and each layer's optimizer
    iterations on CUDA events. The loop runs ``layer_apply`` once a step,
    then four times for the local losses, so an event is recorded as each
    call starts: the first ``iters + 1`` events bound the ``iters``
    steps. From the start of step 1 to the end of the last step
    ``torch.cuda.set_sync_debug_mode('error')`` makes any synchronizing
    call in the loop raise."""

    def __init__(self):
        self.capture_s = 0.0
        self.captures = 0
        self.step_ms = []

    def __enter__(self):
        self.real = AR.optimize_layer_rounding, AD._capture_layer_io

        def capture(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real[1](*a, **k)
            torch.cuda.synchronize()
            self.capture_s += time.perf_counter() - t0
            self.captures += 1
            return out

        def optimize(layer_apply, spec, qp, w, inp, out, cfg, **k):
            events = []

            def timed_apply(w_q, x):
                t = len(events)
                if t <= cfg.iters:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    events.append(ev)
                if t == 1:
                    torch.cuda.set_sync_debug_mode("error")
                elif t == cfg.iters:
                    torch.cuda.set_sync_debug_mode(0)
                return layer_apply(w_q, x)
            try:
                res = self.real[0](timed_apply, spec, qp, w, inp, out, cfg,
                                   **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            if len(events) != cfg.iters + 1:
                fail(f"adaround clock: {len(events)} layer calls seen, "
                     f"expected {cfg.iters + 1}")
            self.step_ms.append([a.elapsed_time(b)
                                 for a, b in zip(events, events[1:])])
            return res

        AR.optimize_layer_rounding, AD._capture_layer_io = optimize, capture
        return self

    def __exit__(self, *exc):
        AR.optimize_layer_rounding, AD._capture_layer_io = self.real


def decisions_off_nearest(qcfg, qstate, tensors, names) -> tuple:
    """(hard decisions that differ from round-to-nearest, entries) over the
    weight sites ``names`` (the engine deploys those sites' nearest
    rounding, as the JAX package does)."""
    off = total = 0
    for n in names:
        st, c = qstate[n], qcfg[n]
        w = tensors[n]
        hard = Q.adaround_fake_quant(Q.AdaRoundMode.learned_hard_sigmoid,
                                     c.spec, st["qp"], w, st["alpha"],
                                     soft=False)
        off += int((hard != Q.fake_quant(c.spec, st["qp"], w)).sum())
        total += w.numel()
    return off, total


def adaround_phase(params, batches, by_path, seed, dev, kind, smi) -> None:
    """Phase 14: the JAX CLI's ``w4-adaround`` at BERT-base width and depth
    from ``seed``'s params on synthetic RTE examples, cut to
    ``ADAROUND_SAMPLES`` samples and ``ADAROUND_ITERS`` iterations: the
    weight calibration, AdaRound over all 102 layer specs (capture
    seconds, ms an optimizer iteration by layer shape, the full preset's
    time extrapolated, the layers whose hard local loss fell), the W4A32
    score on the fake-quant forward; then post_adaround 8-bit asymmetric
    act ranges on one batch of 16, the alphas packed as int8 storage of
    their 4-bit levels and planned: K1, K2 and K3 on layer 0 against their
    plain versions bit for bit, three request batches through
    ``bert_engine_apply`` (48 / 12 / 24 launches a forward, logits against
    the plain engine), the gaps between the engine, the generic int path
    and the hard-alpha fake-quant forward by ``ROUTE_RATIO``,
    and engine seq/s."""
    rec, arc0 = CAL.ADAROUND_RECIPES["w4-adaround"]
    arc = dataclasses.replace(arc0, num_samples=ADAROUND_SAMPLES,
                              iters=ADAROUND_ITERS)
    print(f"  cuts of the preset: num_samples {arc.num_samples} (preset "
          f"{arc0.num_samples}), iters {arc.iters} (preset {arc0.iters}); "
          f"kept: init {arc.init.name}, mode {arc.round_mode.name}, "
          f"minibatch {arc.batch_size}, lr {arc.lr}, annealing "
          f"{arc.annealing} {arc.decay_type.name}, warmup {arc.warmup}, "
          f"{arc.act_quant_mode.name}")
    cfg = B.BertConfig()
    task = GL.TASKS["rte"]
    tok = DATA.SyntheticTokenizer(cfg.vocab_size)
    train = DATA.encode_examples(tok, task, GL.synthetic_examples(
        task, "train", ADAROUND_SAMPLES, seed=seed), SEQ)
    val = DATA.encode_examples(tok, task, GL.synthetic_examples(
        task, "validation", ADAROUND_EVAL, seed=seed), SEQ)
    qcfg = B.declare_bert_sites(rec.defaults, cfg,
                                quant_setup=rec.quant_setup)
    apply_fn = functools.partial(B.bert_apply, cfg=cfg, device=dev)
    tensors = B.bert_weight_site_tensors(params)
    est = [DATA.trim_to_real_length(
        {k: v for k, v in b.items() if k not in ("labels", "example_mask")})
        for b in DATA.batch_iterator(train, rec.est_batch_size,
                                     drop_last=True)][:1]
    (q0, _), t_cal = timed_s(lambda: CAL.prepare_quantized_model(
        apply_fn, params, qcfg, est, weight_tensors=tensors,
        act_quant=rec.act_quant, device=dev))
    print(f"  weight calibration (MSE grid, "
          f"{rec.defaults.weight_num_candidates} candidates, 4-bit "
          f"symmetric): {t_cal:.3f} s", flush=True)
    specs = B.bert_adaround_specs(params, cfg)
    stats = []
    with AdaRoundClock() as clock:
        q_ar, t_ar = timed_s(lambda: AD.apply_adaround_to_model(
            apply_fn, params, qcfg, q0, specs,
            list(DATA.batch_iterator(train, arc.batch_size, drop_last=True)),
            arc, batch_size=arc.batch_size, seed=seed, stats_out=stats,
            device=dev))
    if len(stats) != len(specs) or len(specs) != 8 * cfg.num_hidden_layers + 6:
        fail(f"adaround: {len(stats)} layers optimized of {len(specs)} specs")
    if len(clock.step_ms) != len(specs) or clock.captures != len(specs):
        fail(f"adaround clock: {len(clock.step_ms)} loops and "
             f"{clock.captures} captures timed for {len(specs)} specs")
    fell = sum(s["loss_hard_after"] < s["loss_hard_before"] for _, s in stats)
    if not all(np.isfinite(list(s.values())).all() for _, s in stats):
        fail("adaround: non-finite local losses")
    by_shape = {}
    layer_ms = []
    for i, (name, _) in enumerate(stats):
        ms = clock.step_ms[i][ADAROUND_TIMED_FROM - 1:]
        layer_ms.append(float(np.median(ms)))
        by_shape.setdefault(adaround_shape(name), []).extend(ms)
    print(f"  [w4-adaround] {len(specs)} layers, {ADAROUND_SAMPLES} samples, "
          f"{ADAROUND_ITERS} iterations a layer ({kind}, {smi}): {t_ar:.1f} s"
          f", of it capture {clock.capture_s:.1f} s; the loop never waited on "
          f"the host (sync debug mode 'error' from step 1 to the last)",
          flush=True)
    for label, ms in by_shape.items():
        print(f"    ms an iteration, {label}: {float(np.median(ms)):.3f} "
              f"(median of iterations {ADAROUND_TIMED_FROM}-{ADAROUND_ITERS}"
              f", {len(ms)} of them)")
    est_s = (sum(layer_ms) * arc0.iters / 1e3
             + clock.capture_s * arc0.num_samples / ADAROUND_SAMPLES)
    print(f"    estimate, not measured: the full preset ({arc0.iters} "
          f"iterations x {len(specs)} layers, {arc0.num_samples} samples) "
          f"{est_s:.0f} s = {est_s / 60:.1f} min (each layer's median ms an "
          f"iteration x {arc0.iters}, capture scaled by the samples)")
    print(f"    hard local loss fell in {fell} of {len(stats)} layers")
    if fell == 0:
        fail("adaround: no layer's hard local loss fell")

    def score(qs, mode):
        m = TT.evaluate(apply_fn, params, qs, task, val, qcfg=qcfg,
                        mode=mode)
        return m[task.final_metric], m
    fp_score = score({}, QuantMode(weight_quant=False, act_quant=False))[0]
    w4, det = AD.adaround_multi_eval(
        apply_fn, params, qcfg, q_ar, eval_fn=score, est_arrays=train,
        act_quant_mode=arc.act_quant_mode, act_quant=rec.act_quant,
        est_pad=rec.est_pad, log_fn=lambda s: None, device=dev)
    nearest = score(q0, QuantMode(act_quant=False))[0]
    print(f"  [w4-adaround] {task.final_metric} on {ADAROUND_EVAL} synthetic "
          f"validation examples (random weights: chance): W4A32 fake-quant "
          f"{w4:.4f} (nearest rounding {nearest:.4f}, float {fp_score:.4f})")

    # post_adaround: 8-bit asymmetric act ranges on one batch of 16,
    # trimmed to its real length as the recipe's est_pad=False asks
    b16 = DATA.trim_to_real_length(
        {k: v for k, v in next(DATA.batch_iterator(
            train, 16, drop_last=True)).items()
         if k not in ("labels", "example_mask")})
    qs = CAL.calibrate_model(apply_fn, params, qcfg, [b16],
                             act_quant=True, device=dev,
                             qstate=reset_act_ranges(qcfg, q_ar))
    int_params = B.build_bert_int_params(params, qcfg, qs, use_int4=True)
    lin = [n for n, p in int_params.items() if "w_int" in p]
    if (any("w_packed" in p for p in int_params.values())
            or any(int_params[n]["n_bits"] != 4 for n in lin)):
        fail("adaround: an alpha site did not pack as int8 storage of 4-bit "
             "levels")
    for n in lin:
        want = Q.adaround_fake_quant(
            Q.AdaRoundMode.learned_hard_sigmoid, qcfg[n + ".w"].spec,
            qs[n + ".w"]["qp"], tensors[n + ".w"], qs[n + ".w"]["alpha"],
            soft=False)
        if not torch.equal(IL.dequantize_packed_weight(int_params[n]), want):
            fail(f"adaround: {n}'s packed levels are not its hard decisions")
    print(f"  [adaround-w4a8] {len(lin)} matmul weights packed as int8 "
          f"storage of their 4-bit levels, each equal to its hard-alpha "
          f"fake-quant weight bit for bit")
    static, plan, _ = B.build_bert_engine(params, cfg, qcfg, qs,
                                          int_params=int_params, device=dev)
    if any(any(f) for f in static.w4) or not all(static.int8_layer):
        fail(f"adaround: the engine is not all-int8: w4 {static.w4}, "
             f"int8 {static.int8_layer}")
    b0 = batches[0]
    L = cfg.num_hidden_layers
    eng = bert_runner(params, cfg, qcfg, qs, static, plan, int_params, dev)
    check_layer0_kernels("adaround-w4a8", *engine_entry(eng, b0),
                         cfg.num_attention_heads, static, plan, w4=False)
    by_path["adaround-w4a8"] = drive_path(
        "adaround-w4a8", eng, cfg, batches,
        per_forward(int8_matmul=4 * L, int8_attention=L,
                    fused_add_ln_payload=2 * L))
    off, total = decisions_off_nearest(
        qcfg, qs, tensors, [n for n in tensors if n.startswith("emb.")
                            or n.endswith("ln.w")])
    print(f"  [adaround-w4a8] the embedding tables and LayerNorm gammas pack "
          f"round-to-nearest (the JAX package's packing): {off} of {total} "
          f"of their hard decisions differ from it")
    # the engine against the hard-alpha fake-quant forward. At 12 layers
    # no two of a model's routes (engine, generic int path, fake-quant
    # forward) meet the logit tolerance, in the JAX package as in the
    # port: a rounding-order level flip spreads through its sequence
    # (ROADMAP, "Parity contract"). tests/test_torch_adaround_depth.py
    # holds the port's engine to the JAX engine there and records JAX's
    # own three gaps, which keep within ROUTE_RATIO of each other, with
    # and without alphas; the gate here is that rule, in logit units
    # (route_gaps), and the AdaRound model's three gaps at most
    # ROUTE_RATIO times those of the same model at nearest rounding (the
    # same act calibration)
    gaps = {}
    for tag, qs_, ip_ in (("adaround", qs, int_params),
                          ("nearest", None, None)):
        if qs_ is None:
            qs_ = CAL.calibrate_model(apply_fn, params, qcfg, [b16],
                                      act_quant=True, device=dev,
                                      qstate=reset_act_ranges(qcfg, q0))
            ip_ = B.build_bert_int_params(params, qcfg, qs_)
            st_, pl_, _ = B.build_bert_engine(params, cfg, qcfg, qs_,
                                              int_params=ip_, device=dev)
            run = bert_runner(params, cfg, qcfg, qs_, st_, pl_, ip_, dev)
        else:
            run = eng
        with torch.no_grad():
            flt = apply_fn(params, b0, qcfg=qcfg, qstate=qs_)[0]["logits"]
            gen = apply_fn(params, b0, qcfg=qcfg, qstate=qs_,
                           int_params=ip_)[0]["logits"]
        for route, gap in site_gaps(
                f"[adaround-w4a8] {tag} model", run(b0, "kernels")["logits"],
                gen, flt, "generic", qcfg["classifier.out"].spec,
                qs_["classifier.out"]["qp"]).items():
            gaps[tag, route] = gap
    r = ROUTE_RATIO
    for route in ("engine-fq", "generic-fq", "engine-generic"):
        if gaps["adaround", route] > r * gaps["nearest", route]:
            fail(f"adaround-w4a8: {route} {gaps['adaround', route]:.4e} "
                 f"beyond {r} x the nearest model's "
                 f"{gaps['nearest', route]:.4e}")
    print(f"  [adaround-w4a8] route gaps within {r} x of each other and of "
          f"the nearest-rounding model's (the JAX package's rule at 12 "
          f"layers, tests/test_torch_adaround_depth.py)")
    t_eng = window_ms(lambda: eng(b0, "kernels"))
    print(f"  [adaround-w4a8] seq/s at B={BATCH}, S={SEQ}, median (range) of "
          f"5 windows ({kind}, {smi}): engine {seq_per_s(t_eng)} (forward "
          f"{t_eng[0]:.3f} ms)")


# phase 15: the BERT-shaped families at their published base
# configurations, and the fused linears and quantize passes of one
# generic-path forward by family and depth L (every linear whose input
# site is per-tensor and whose N % 8 == 0 takes the fused linear on a
# float32 x: none emits a payload for the next)
FAMILY_MODELS = ("roberta_base", "distilbert_base_uncased", "albert_base_v2",
                 "squeezebert_uncased")
# the registry's two large presets (H = 1024, 16 heads, I = 4096, 24
# layers): their W8A8 engines alone, each path named by its model
LARGE_MODELS = ("bert_large_uncased", "albert_large_v2")
# float32 x: none emits a payload for the next), and its logits site
FAMILY_GENERIC = {
    "roberta": (lambda L: 6 * L + 1, "clf.out_proj.out"),  # + clf.dense
    "distilbert": (lambda L: 6 * L + 1, "clf.out.out"),    # + clf.pre
    "albert": (lambda L: 6 * L + 2, "classifier.out"),     # + emb_proj, pooler
    # attn_out (one group) + pooler
    "squeezebert": (lambda L: L + 1, "classifier.out"),
}


def family_batches(cfg, seed: int) -> list:
    """Three request batches, the padded positions carrying the model's
    pad id (RoBERTa numbers its positions from the non-pad ids)."""
    out = request_batches(cfg, 3, seed)
    pad = getattr(cfg, "pad_token_id", 0)
    for b in out:
        b["input_ids"] = np.where(b["attention_mask"] > 0, b["input_ids"],
                                  pad).astype(np.int32)
    return out


def check_shared_storage(tag, plan) -> None:
    """ALBERT's plan: every layer's matmul weights one storage a matmul
    (the shared layer's, int8 or packed int4)."""
    ptrs = {mm: {lp[mm]["w"].untyped_storage().data_ptr()
                 for lp in plan["layers"]}
            for mm in ("qkv", "attn_out", "inter", "dense")}
    if any(len(v) != 1 for v in ptrs.values()):
        fail(f"{tag}: the plan's layers hold {ptrs} weight storages")
    print(f"  [{tag}] the {len(plan['layers'])} plan layers share one weight "
          "storage a matmul (q|k|v, attn_out, inter, dense)")


def family_phase(model: str, seed: int, by_path, dev, kind, smi,
                 generic: bool = True) -> dict:
    """One model of phase 15 (see the module docstring); without
    ``generic``, the engine alone (no generic int path and no route
    gaps), its path named by the model. Returns K1's device ms on layer
    0's four matmuls."""
    t0 = time.perf_counter()
    fam, cfg, params = REG.build_model(model, seed=seed, device=dev)
    qcfg = fam.declare_sites(CAL.w8a8_defaults(), cfg)

    def apply_fn(p, b, **kw):
        return fam.apply(p, b, cfg, **kw)

    qstate, _ = CAL.prepare_quantized_model(
        apply_fn, params, qcfg,
        [CAL.calibration_batch(cfg.vocab_size, 8, SEQ, seed)],
        weight_tensors=fam.weight_site_tensors(params), device=dev)
    static, plan, ip = fam.build_engine(params, cfg, qcfg, qstate,
                                        device=dev)
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    print(f"  [{fam.name}] {model}: {L} layers, H={cfg.hidden_size}, "
          f"I={cfg.intermediate_size}, {cfg.num_attention_heads} heads, "
          f"vocab {cfg.vocab_size}, LayerNorm eps {cfg.layer_norm_eps:g}; "
          f"init, W8A8 calibration, packing, plan "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not all(static.int8_layer):
        fail(f"{model}: not every layer on the all-int8 route")
    if fam.name == "albert":
        check_shared_storage(model, plan)
    batches = family_batches(cfg, seed)
    b0 = batches[0]

    def engine(batch, backend):
        return fam.engine_apply(params, batch, cfg, qcfg, qstate, static,
                                plan, ip, backend=backend, device=dev)

    def generic_int(batch, backend):
        return apply_fn(params, batch, qcfg=qcfg, qstate=qstate,
                        mode=QuantMode(), int_params=ip,
                        fused_linear=(True if backend == "kernels"
                                      else "plain"), device=dev)[0]

    tag = fam.name if generic else model
    k1 = check_layer0_kernels(tag, *engine_entry(engine, b0),
                              cfg.num_attention_heads, static, plan,
                              w4=False, timed=True)
    print(f"  [{tag}] K1 device ms, layer 0 (B={BATCH}, S={SEQ}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in k1.items())
          + f"; per layer {sum(k1.values()):.4f}")
    by_path[tag] = drive_path(
        tag, engine, cfg, batches,
        per_forward(int8_matmul=4 * L, int8_attention=L,
                    fused_add_ln_payload=2 * L))
    if generic:
        linears, logits_site = FAMILY_GENERIC[fam.name]
        n_lin = linears(L)
        by_path[f"{fam.name}-generic"] = drive_path(
            f"{fam.name}-generic", generic_int, cfg, batches,
            per_forward(fused_int8_linear=n_lin, fused_linear_quantize=n_lin))
        with torch.no_grad():
            flt = apply_fn(params, b0, qcfg=qcfg, qstate=qstate,
                           mode=QuantMode(), device=dev)[0]["logits"]
        site_gaps(f"[{fam.name}] engine, generic int path, fake-quant "
                  "forward", engine(b0, "kernels")["logits"],
                  generic_int(b0, "kernels")["logits"], flt, "generic",
                  qcfg[logits_site].spec, qstate[logits_site]["qp"])
    t_eng = window_ms(lambda: engine(b0, "kernels"))
    print(f"  [{tag}] seq/s at B={BATCH}, S={SEQ}, median (range) of 5 "
          f"windows ({kind}, {smi}): engine {seq_per_s(t_eng)} (forward "
          f"{t_eng[0]:.3f} ms)", flush=True)
    return k1


def families_phase(by_path, seed: int, dev, kind, smi) -> None:
    """Phase 15: each of ``FAMILY_MODELS``, then of ``LARGE_MODELS``, in
    turn (its weights freed before the next); K1's ms a layer of
    SqueezeBERT's block-diagonal weights beside RoBERTa-base's dense ones
    (BERT-base's shapes), and of the large presets."""
    k1 = {}
    for model in FAMILY_MODELS + LARGE_MODELS:
        k1[model] = sum(family_phase(
            model, seed, by_path, dev, kind, smi,
            generic=model not in LARGE_MODELS).values())
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  K1 device ms a layer ({kind}, {smi}): "
          + ", ".join(f"{m} {t:.4f}" for m, t in k1.items())
          + "; SqueezeBERT's block-diagonal weights against RoBERTa's dense "
          f"ones {k1['squeezebert_uncased'] / k1['roberta_base']:.3f}x")


# phase 16: the leave-one-out and bit-width study's configurations
# (quant_dict keys, activation bits) at BERT-base width and depth
FLOAT_EDGE_CONFIGS = (
    ("s-fp32", {"s": "fp32"}, 8), ("p-fp32", {"p": "fp32"}, 8),
    ("c-fp32", {"c": "fp32"}, 8), ("s16-p16", {"s": 16, "p": 16}, 8),
    ("c16", {"c": 16}, 8), ("z16", {"z": 16}, 8), ("L16", {"L": 16}, 8),
    ("w8a16", {}, 16), ("w8a6", {}, 6))
# a float-dot form against its plain version: both sum in float64, so
# they part only where a float64 sum's rounding meets a float32 tie: at
# most one level (one float32 unit in the last place of a raw value) on
# at most this share of the elements
TIE_FRAC = 1e-5


def float_edge_launches(name: str, L: int) -> dict:
    """The launches a forward of each configuration makes (see
    ``ops/engine.py``): the all-int8 layer chain with the attention's
    second kernel and a float context on K4 (16-bit) or K9 (disabled);
    the flex route with float layer inputs (K4 emit), value-space
    attention and float inter edges (K4 fold)."""
    chain = dict(int8_matmul=4 * L, int8_attention_flex=L,
                 fused_add_ln_payload=2 * L)
    return per_forward(**{
        "s-fp32": chain, "p-fp32": chain, "s16-p16": chain,
        "c-fp32": dict(chain, int8_matmul=3 * L, float_int8_matmul=L),
        "c16": dict(chain, int8_matmul=3 * L, float_edge_levels=L,
                    float_edge_matmul=L),
        "z16": dict(int8_matmul=3 * L + 1, int8_attention=L,
                    float_edge_levels=L - 1, float_edge_matmul=L - 1,
                    flex_add_ln=2 * L),
        "L16": dict(int8_matmul=1, int8_attention_flex=L,
                    float_edge_levels=4 * L - 1,
                    float_edge_matmul_fold=4 * L - 1, flex_add_ln=2 * L),
        "w8a16": dict(int8_attention_flex=L, float_edge_levels=4 * L,
                      float_edge_matmul_fold=4 * L, flex_add_ln=2 * L),
        "w8a6": dict(int8_matmul=L, int8_attention_flex=L,
                     float_edge_levels=3 * L, float_edge_matmul_fold=3 * L,
                     flex_add_ln=2 * L),
    }[name])


def compare_ties(got, want, step, name, quiet: bool = False) -> dict:
    """A float-dot form's output against its plain version's: at most one
    level (``step``: a float grid's step; None: an int8 payload; 'ulp': a
    raw float, one float32 unit in the last place) on at most ``TIE_FRAC``
    of the elements, else fail. ``quiet``: print only where they part."""
    torch.cuda.synchronize()
    if step is None:
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs().double()
    elif isinstance(step, str):
        diff = ((got.double() - want.double()).abs()
                / (want.double().abs() * 2.0 ** -23 + 1e-30))
    else:
        diff = (got.double() - want.double()).abs() / step
    max_diff = float(diff.max())
    n_bad = int((got != want).sum())
    if not quiet or n_bad:
        print(f"  {name}: max_diff={max_diff:.3g} (levels / ulps) "
              f"mismatches={n_bad} (of {diff.numel()}; float64 ties)")
    if max_diff > 1.0 + 1e-6 or n_bad > TIE_FRAC * diff.numel():
        fail(f"{name}: {n_bad} elements off by up to {max_diff:.3g} levels "
             f"(allowed: one level on {TIE_FRAC} of them)")
    return {"max_abs_err": max_diff, "mismatches": n_bad}


def flex_form_case(tag, got_fn, want_fn, step, ties, ops_i8, ops_f,
                   nbytes, lib_fn=None, first_ms=None, lib64_fn=None) -> dict:
    """One call of a redesigned kernel against its plain version on the
    main path's inputs: bit-identical (an integer form) or within the
    float64 ties (``ties``); kernel device ms, plain and library ms (and,
    with ``lib64_fn``, the float64 library product's); the bound from the
    integer products at the int8 peak, the float64 ones at the float64
    tensor-core one, and the bytes; ``first_ms``, the first design's ms
    on the same form (``FLEX_FIRST_MS``), printed beside."""
    got, want = got_fn(), want_fn()
    if ties:
        res = compare_ties(got, want, step, tag)
    elif step is None:
        res = compare(got, want, tag)
    else:
        res = compare_values(got, want, 1.0 if isinstance(step, str)
                             else step, tag)
    t_k = device_ms(got_fn)
    t_p = timed_ms(want_fn, iters=3, warmup=1)
    t_l = device_ms(lib_fn) if lib_fn is not None else None
    t_l64 = device_ms(lib64_fn) if lib64_fn is not None else None
    t_ops = (ops_i8 / PEAK_INT8_OPS + ops_f / PEAK_F64_OPS) * 1e3
    t_b = nbytes / PEAK_BYTES * 1e3
    bnd, by = (t_ops, "operations") if t_ops >= t_b else (t_b, "bytes")
    lib = f", library {t_l:.4f} ms" if t_l is not None else ""
    lib += (f", float64 library product {t_l64:.4f} ms"
            if t_l64 is not None else "")
    first = (f", first design {first_ms:.4f} ms (its own run)"
             if first_ms is not None else "")
    print(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms{lib}, bound "
          f"{bnd:.4f} ms ({by}), {bnd / t_k * 100:.1f}% of the bound{first}")
    out = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": bnd,
           "bound_by": by, **res}
    if t_l64 is not None:
        out["library_f64_ms"] = t_l64
    return out


def flex_attention_cases(name, call, seen) -> list:
    """The attention's second kernel on one recorded call, unless its form
    (site bits and dots) was held already (``seen``)."""
    (qkv, mask, scal), kw = call
    ab, dots = EK._attn3(kw["attn_bits"]), kw.get("dots", "i8")
    form = f"{ab} {dots}"
    if form in seen:
        return []
    nh, seq = kw["n_heads"], kw["seq"]
    m, h = qkv.shape[0], qkv.shape[1] // 3
    b, d = m // seq, h // nh
    c_bits = ab[2]
    out_b = 1 if 1 <= c_bits <= 8 else 4
    qk_i8 = dots == "i8"   # q.k on payloads
    ops = 2.0 * b * nh * seq * seq * d
    step = (None if 1 <= c_bits <= 8 else
            float(scal[0, 10]) if c_bits > 8 else "ulp")
    route = EK.attn_flex_route(ab, dots)
    # the integer route's 9-16-bit probs: p.v on the int8 tensor cores,
    # two byte planes
    pv_ops = ops * (2 if ab[1] > 8 else 1) if route == "int" else 0.0
    r = flex_form_case(
        f"int8_attention_flex[{name}: {form}, route {route}] B={b} T={seq} "
        f"{nh}x{d}",
        lambda: EK.int8_attention_flex(qkv, mask, scal, **kw),
        lambda: EK.int8_attention_ref(qkv, mask, scal, **kw), step,
        route == "f64", ops * qk_i8 + pv_ops,
        ops * (2 - qk_i8 - (route == "int")),
        qkv.numel() * qkv.element_size() + mask.numel() * 4 + m * h * out_b,
        first_ms=FLEX_FIRST_MS.get(form))
    return [(form, dict(r, route=route))]


def _out_step(vecs, mode):
    return None if mode == "emit" else (vecs[3] if mode == "fold" else "ulp")


def edge_matmul_cases(name, call, seen) -> list:
    """The float-edge matmul (its level pass and GEMM) on one recorded
    call, unless its form was held already; the library yardstick
    ``torch.matmul`` of the float x against the dequantized weight. A
    one-group call that emits (attn_out on a 16-bit context) is also held
    with the raw float out, the epilogue of a disabled fold site, off the
    path."""
    (x, vecs, grid), kw = call
    m, k = x.shape
    n = grid["w"].shape[0]
    w_f = (grid["w"].float() * vecs[0][:, None]).t().contiguous()
    xg = x.index_select(1, grid["cols"]) if grid["s"].numel() > 1 else x
    mode = kw.get("out_mode", "emit")
    extra = ([("float", "off the path")]
             if mode == "emit" and grid["s"].numel() == 1 else [])
    out = []
    for mode, where in [(mode, "")] + extra:
        kwm = dict(kw, out_mode=mode, out_bits=kw.get("out_bits", 8))
        form = (f"{kw.get('activation')} {mode} {kwm['out_bits']}-bit out, "
                f"{grid['bits']}-bit x, K={k}, N={n}")
        if form in seen:
            continue
        seen.add(form)
        r = flex_form_case(
            f"float_edge_matmul[{name}{' ' + where if where else ''}: "
            f"{form}] {m}x{k}->{n}",
            lambda kwm=kwm: EK.float_edge_matmul(x, vecs, grid, **kwm),
            lambda kwm=kwm: EK.float_edge_matmul_ref(x, vecs, grid, **kwm),
            _out_step(vecs, mode), False,
            2.0 * m * n * k * EK.edge_planes(grid), 0.0,
            m * k * 4 + n * k + m * n * (1 if mode == "emit" else 4),
            lib_fn=lambda: torch.matmul(xg, w_f))
        out.append((form, dict(r, where=where)))
    return out


def float_int8_cases(name, call, seen) -> list:
    """K9 on one recorded call (and, off the path, its fold and float
    epilogues on the same inputs); the library yardstick ``torch.matmul``
    of x against the dequantized weight (float32, TF32 off), and beside it
    the float64 product of the same sums (``torch.matmul`` on float64
    operands, the conversions made before)."""
    (x, w8, vecs), kw = call
    m, k = x.shape
    n = w8.shape[0]
    w_f = (w8.float() * vecs[0][:, None]).t().contiguous()
    x64, w64 = x.double(), w8.double().t().contiguous()
    mode = kw.get("out_mode", "emit")
    out = []
    for md in [mode] + [o for o in ("fold", "float") if o != mode]:
        kwm = dict(kw, out_mode=md)
        form = f"{kw.get('activation')} {md} {kw.get('out_bits', 8)}-bit"
        if form in seen:
            continue
        seen.add(form)
        where = "" if md == mode else "off the path"
        r = flex_form_case(
            f"float_int8_matmul[{name}{' ' + where if where else ''}: "
            f"{form}] {m}x{k}->{n}",
            lambda kwm=kwm: EK.float_int8_matmul(x, w8, vecs, **kwm),
            lambda kwm=kwm: EK.float_int8_matmul_ref(x, w8, vecs, **kwm),
            _out_step(vecs, md), True, 0.0, 2.0 * m * n * k,
            m * k * 4 + n * k + m * n * (1 if md == "emit" else 4),
            lib_fn=lambda: torch.matmul(x, w_f),
            first_ms=K9_FIRST_MS.get(md) if (m, k, n) == (
                BATCH * SEQ, 768, 768) else None,
            lib64_fn=lambda: torch.matmul(x64, w64))
        out.append((form, dict(r, where=where)))
    return out


# the first designs' device ms at B = 128, S = 128 (this script's phase 16
# on the float64 FMA-unit designs, an H100 80GB HBM3 at 700 W), printed
# beside the second's
FLEX_FIRST_MS = {"(0, 8, 8) i8": 0.8156, "(8, 0, 8) i8": 0.7785,
                 "(8, 8, 0) i8": 0.8312, "(16, 16, 8) i8": 0.7807,
                 "(8, 8, 16) i8": 0.8298, "(16, 16, 16) f32": 0.7410,
                 "(6, 6, 6) f32": 0.7220}
K9_FIRST_MS = {"emit": 1.1527, "fold": 1.1539, "float": 1.1473}

# The attention's second kernel off the main path: one form of each route
# class (attn_bits, dots): the scores site disabled, 16-bit probs (the
# byte planes), a 16-bit context, the probs site disabled (p.v on DMMA),
# value space
FLEX_FORMS = (((0, 8, 8), "i8"), ((16, 16, 8), "i8"), ((8, 8, 16), "i8"),
              ((8, 0, 8), "i8"), ((16, 16, 16), "f32"))


def flex_attn_case(qkv8, scal, bits, dots):
    """``ATTN_SCALARS``-style inputs for a flex form: a site of more than 8
    bits gets a step 256 times finer and its shift's integer part 256
    times larger (an 8-bit shift of 128 becomes 32768; a fractional part
    stays); ``dots='f32'`` takes q, k and v as their float32 values
    through the scalars (q_s (q8 + q_sh), ...) with identity q / k / v
    site scalars, as the engine's value-space attention does."""
    s = scal.clone()
    for site, b in zip((6, 8, 10), bits):
        if b > 8:
            sh = s[0, site + 1]
            s[0, site] = s[0, site] / 256.0
            s[0, site + 1] = torch.floor(sh) * 256.0 + (sh - torch.floor(sh))
    if dots == "i8":
        return qkv8, s
    h = qkv8.shape[1] // 3
    vals = torch.cat([s[0, 2 * i] * (qkv8[:, i * h:(i + 1) * h].float()
                                     + s[0, 2 * i + 1]) for i in range(3)],
                     dim=1).contiguous()
    s[0, :6] = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0, 0.0])
    return vals, s


def check_flex_attention_shapes(dev) -> int:
    """The attention's second kernel through ``int8_attention_flex``
    against its plain version: each of ``FLEX_FORMS`` at every (seq,
    head_dim) of ``EK.ATTN_SHAPES`` x ``ATTN_BATCHES`` x skip_max
    ('spread' scalars, as :func:`check_attention_shapes`), then with the
    'saturate', 'fractional' and 'big_shift' scalars at seq 128, B = 7:
    the integer route bit-identical, the float64 one within the float64
    ties (``compare_ties``). Returns the comparisons made and the float64
    route's ties (elements that part from the plain version's)."""
    n = ties = 0
    for i, (seq, d, b, sc, skip) in enumerate(attention_cases()):
        nh = ATTN_HEADS[d]
        qkv8, mask, scal = (torch.from_numpy(a).to(dev) for a in attn_inputs(
            b, seq, d, nh, 160 + i, sc, full_pad=not skip))
        for bits, dots in FLEX_FORMS:
            qkv, s = flex_attn_case(qkv8, scal, bits, dots)
            kw = dict(n_heads=nh, seq=seq, skip_max=skip, attn_bits=bits,
                      dots=dots)
            got = EK.int8_attention_flex(qkv, mask, s, **kw)
            want = EK.int8_attention_ref(qkv, mask, s, **kw)
            c_bits = bits[2]
            step = (None if 1 <= c_bits <= 8 else
                    float(s[0, 10]) if c_bits > 8 else "ulp")
            tag = (f"int8_attention_flex {bits} {dots} route "
                   f"{EK.attn_flex_route(bits, dots)} B={b} T={seq} d={d} "
                   f"heads={nh} {sc} skip_max={skip}")
            if EK.attn_flex_route(bits, dots) == "f64":
                ties += compare_ties(got, want, step, tag,
                                     quiet=True)["mismatches"]
            elif step is None:
                compare(got, want, tag, quiet=True)
            else:
                compare_values(got, want, 1.0 if step == "ulp" else step,
                               tag, quiet=True)
            n += 1
    return n, ties


# K9 off the main path: (M, K, N) ragged against its 128 x 128 tiles, at
# the least K it takes and at FI_MAX_K
K9_SHAPES = ((1000, 16, 136), (999, 784, 200), (300, EK.FI_MAX_K, 72))
K9_EPILOGUES = tuple((act, mode, bits) for act in (None, "gelu_new", "relu")
                     for mode, bits in (("emit", 8), ("fold", 8),
                                        ("fold", 16), ("float", 8)))


def check_float_int8_shapes(dev) -> int:
    """K9 through ``float_int8_matmul`` against its plain version at
    ``K9_SHAPES`` with every epilogue of ``K9_EPILOGUES``, within the
    float64 ties; returns the comparisons made and the ties."""
    gen = torch.Generator(device=dev).manual_seed(19)
    n = ties = 0
    for m, k, nn in K9_SHAPES:
        x = torch.randn(m, k, generator=gen, device=dev)
        w8 = torch.randint(-128, 128, (nn, k), generator=gen, device=dev,
                           dtype=torch.int8)
        vecs = torch.stack([
            torch.rand(nn, generator=gen, device=dev) * 2e-3 + 1e-4,
            torch.zeros(nn, device=dev),
            torch.randn(nn, generator=gen, device=dev) * 0.1,
            0.02 * (1 + torch.rand(nn, generator=gen, device=dev)),
            torch.full((nn,), 3.0, device=dev)]).contiguous()
        for act, mode, bits in K9_EPILOGUES:
            kw = dict(activation=act, out_mode=mode, out_bits=bits)
            ties += compare_ties(
                EK.float_int8_matmul(x, w8, vecs, **kw),
                EK.float_int8_matmul_ref(x, w8, vecs, **kw),
                _out_step(vecs, mode), f"float_int8_matmul {m}x{k}->{nn} "
                f"{act} {mode} {bits}-bit", quiet=True)["mismatches"]
            n += 1
    return n, ties


NEW_KERNEL_CASES = (("int8_attention_flex", flex_attention_cases),
                    ("float_edge_matmul", edge_matmul_cases),
                    ("float_int8_matmul", float_int8_cases))


def float_edges_phase(params, batches, by_path, seed, dev, kind,
                      smi) -> dict:
    """Phase 16 (see the module docstring); returns each new kernel's
    numbers by form, for the kernels JSON."""
    t0 = time.perf_counter()
    n_flex, t_flex = check_flex_attention_shapes(dev)
    n_k9, t_k9 = check_float_int8_shapes(dev)
    print(f"  off the main path: {n_flex} attention (second kernel) "
          f"comparisons (the integer route bit-identical; float64 ties "
          f"{t_flex}) and {n_k9} K9 comparisons (float64 ties {t_k9}) "
          f"passed, {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = B.BertConfig()
    L = cfg.num_hidden_layers
    b0 = batches[0]
    forms = {k: {} for k, _ in NEW_KERNEL_CASES}
    seqs = {}
    for name, qd, bits in (("w8a8", {}, 8),) + FLOAT_EDGE_CONFIGS:
        t0 = time.perf_counter()
        defaults = dataclasses.replace(CAL.w8a8_defaults(), n_bits_act=bits)
        _, qcfg, qstate = CAL.calibrated_bert(
            cfg, batch_size=8, seq=SEQ, seed=seed, device=dev, params=params,
            quant_dict=qd or None, defaults=defaults)
        static, plan, ip = B.build_bert_engine(params, cfg, qcfg, qstate,
                                               device=dev)
        torch.cuda.synchronize()
        run = bert_runner(params, cfg, qcfg, qstate, static, plan, ip, dev)
        print(f"  [{name}] quant_dict {qd}, activations {bits}-bit: "
              f"calibration, packing, plan {time.perf_counter() - t0:.1f} s;"
              f" layer 0 io {static.layer_io(0)}, attn_bits "
              f"{static.layer_attn_bits(0)}, flex {static.layer_flex(0)}; "
              f"all-int8 layers {sum(static.int8_layer)}, skip_max "
              f"{static.attn_skip_max}", flush=True)
        if name != "w8a8":
            # layer 0's call of each new kernel as the main path makes it
            calls = record_calls(lambda: run(b0, "kernels"),
                                 *((EK, k) for k, _ in NEW_KERNEL_CASES))
            for (kname, cases), kcalls in zip(NEW_KERNEL_CASES, calls):
                seen = set(forms[kname])
                for c in kcalls:
                    for form, r in cases(name, c, seen):
                        seen.add(form)
                        forms[kname][form] = dict(r, config=name)
            del calls
            by_path[name] = drive_path(name, run, cfg, batches,
                                       float_edge_launches(name, L))
        seqs[name] = window_ms(lambda: run(b0, "kernels"), window_s=0.5)
        del static, plan, ip, qstate
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  seq/s at B={BATCH}, S={SEQ}, median (range) of 5 windows of "
          f">= 0.5 s ({kind}, {smi}): " + "; ".join(
              f"{n} {seq_per_s(t)} (forward {t[0]:.3f} ms)"
              for n, t in seqs.items()), flush=True)
    for kname, f in forms.items():
        if not f:
            fail(f"phase 16 launched no {kname}")
    if all(" emit " in f for f in forms["float_edge_matmul"]):
        fail("phase 16 held no fold / float form of the float-edge matmul")
    return forms


# phase 17: the engine's and the generic path's inference options. Each
# forward: (name, recipe, engine kwargs or None for the generic path,
# backend for 'kernels', launches a forward)
def option_forwards(L: int) -> tuple:
    chain = per_forward(int8_matmul=4 * L, int8_attention=L,
                        fused_add_ln_payload=2 * L)
    bf16 = torch.bfloat16
    return (
        ("gelu-exact", "w8a8", dict(gelu_impl="exact"), "kernels", chain),
        ("gelu-poly", "w8a8", dict(gelu_impl="poly"), "kernels", chain),
        ("w8a8-bf16", "w8a8", dict(engine_dtype=bf16), "kernels", chain),
        ("h-fp32-bf16", "h-fp32", dict(engine_dtype=bf16), "kernels",
         per_forward(int8_matmul=4 * L, int8_attention=L,
                     fused_add_ln=2 * L)),
        ("w8a8-mixed-bf16", "w8a8-mixed",
         dict(engine_dtype=bf16, gelu_impl="exact"), "kernels",
         per_forward(int8_matmul=3 * L, int8_attention=L,
                     float_edge_matmul=L, float_edge_levels=L,
                     flex_add_ln=2 * L)),
        ("mix-kernels-plain-kernels", "w8a8", {}, "mix:kernels,plain,kernels",
         per_forward(int8_matmul=4 * L, fused_add_ln_payload=2 * L)),
        ("generic-bf16", "w8a8", None, dict(int8_attention=False),
         per_forward(fused_int8_linear=6 * L + 1,
                     fused_linear_quantize=5 * L + 1)),
        ("generic-bf16-int8-attention", "w8a8", None,
         dict(int8_attention=True),
         per_forward(fused_int8_linear=6 * L + 1,
                     fused_linear_quantize=5 * L + 1)))


def option_runner(params, cfg, qcfg, qstate, static, plan, int_params, dev,
                  engine_kw, backend):
    """The engine with ``engine_kw`` (``engine_dtype``, ``gelu_impl``):
    ``backend`` for 'kernels' (a mix, or the kernels), the plain versions
    for 'plain'."""
    def run(batch, which):
        return B.bert_engine_apply(
            params, batch, cfg, qcfg, qstate, static, plan, int_params,
            backend=backend if which == "kernels" else "plain", device=dev,
            **engine_kw)
    return run


def generic_bf16_runner(params, cfg, qcfg, qstate, int_params, dev,
                        int8_attention: bool):
    """The generic int path at ``compute_dtype`` / ``attention_dtype``
    bfloat16 (the JAX server's fallback) on the fused linear ('kernels')
    or its plain version ('plain')."""
    def run(batch, which):
        return B.bert_apply(params, batch, cfg, qcfg, qstate, QuantMode(),
                            int_params=int_params,
                            fused_linear=True if which == "kernels"
                            else "plain",
                            compute_dtype=torch.bfloat16,
                            attention_dtype=torch.bfloat16,
                            int8_attention=int8_attention, device=dev)[0]
    return run


def first_call(calls, pred, what):
    for a, k in calls:
        if pred(a, k):
            return a, k
    fail(f"phase 17 recorded no {what}")


def option_mm_cases(calls) -> dict:
    """K1's new forms on recorded calls: the inter matmul with each of the
    A-S gelu, the degree-10 polynomial and tanh (emit), and the bfloat16
    fold / float outputs of the non-payload route (attn_out, dense)."""
    out = {}
    (x8, w, vecs, scal), kw = first_call(
        calls["gelu"], lambda a, k: k.get("activation") == "gelu",
        "gelu inter matmul")
    m, (n, k) = x8.shape[0], w.shape
    w_t = w.t()
    for act in ("gelu", "gelu_poly10", "tanh"):
        where = "" if act != "tanh" else "off the path"
        r = flex_form_case(
            f"int8_matmul[{act} emit{' ' + where if where else ''}] "
            f"{m}x{k}->{n}",
            lambda act=act: EK.int8_matmul(x8, w, vecs, scal, activation=act),
            lambda act=act: EK.int8_matmul_ref(x8, w, vecs, scal,
                                               activation=act),
            None, False, 2.0 * m * n * k, 0.0, m * k + n * k + 5 * n * 4 + m * n,
            lib_fn=lambda: torch._int_mm(x8, w_t))
        out[f"{act} emit"] = dict(r, where=where)
    for mode in ("fold", "float"):
        (x8, w, vecs, scal), kw = first_call(
            calls["bf16"], lambda a, k: k.get("out_mode") == mode
            and k.get("out_dtype") == torch.bfloat16, f"bf16 {mode} matmul")
        m, (n, k) = x8.shape[0], w.shape
        w_t = w.t()
        r = flex_form_case(
            f"int8_matmul[{mode} bf16 out] {m}x{k}->{n}",
            lambda kw=kw, a=(x8, w, vecs, scal): EK.int8_matmul(*a, **kw),
            lambda kw=kw, a=(x8, w, vecs, scal): EK.int8_matmul_ref(*a, **kw),
            _out_step(vecs, mode), False, 2.0 * m * n * k, 0.0,
            m * k + n * k + 5 * n * 4 + 2 * m * n,
            lib_fn=lambda w_t=w_t, x8=x8: torch._int_mm(x8, w_t))
        out[f"None {mode} bf16 out"] = dict(r, where="")
    return out


def option_edge_cases(calls) -> tuple:
    """K4's new forms on the mixed recipe's inter call: the A-S gelu (on
    the path: the bf16 forward runs gelu_impl 'exact'), the polynomial
    and tanh (emit, off the path) and the bfloat16 fold / float outputs
    (no activation, off the path). Returns (emit forms, fold / float)."""
    (x, vecs, grid), kw = first_call(
        calls, lambda a, k: k.get("activation") == "gelu", "K4 gelu inter")
    m, k = x.shape
    n = grid["w"].shape[0]
    w_f = (grid["w"].float() * vecs[0][:, None]).t().contiguous()
    ops = 2.0 * m * n * k * EK.edge_planes(grid)
    emit, folds = {}, {}
    for act in ("gelu", "gelu_poly10", "tanh"):
        where = "" if act == "gelu" else "off the path"
        kwa = dict(kw, activation=act)
        r = flex_form_case(
            f"float_edge_matmul[{act} emit{' ' + where if where else ''}, "
            f"{grid['bits']}-bit x] {m}x{k}->{n}",
            lambda kwa=kwa: EK.float_edge_matmul(x, vecs, grid, **kwa),
            lambda kwa=kwa: EK.float_edge_matmul_ref(x, vecs, grid, **kwa),
            None, False, ops, 0.0, m * k * 4 + n * k + m * n,
            lib_fn=lambda: torch.matmul(x, w_f))
        emit[f"{act} emit 8-bit out, {grid['bits']}-bit x, K={k}, N={n}"] = \
            dict(r, where=where)
    for mode in ("fold", "float"):
        kwm = dict(kw, activation=None, out_mode=mode, out_bits=8,
                   out_dtype=torch.bfloat16)
        r = flex_form_case(
            f"float_edge_matmul[None {mode} bf16 out off the path, "
            f"{grid['bits']}-bit x] {m}x{k}->{n}",
            lambda kwm=kwm: EK.float_edge_matmul(x, vecs, grid, **kwm),
            lambda kwm=kwm: EK.float_edge_matmul_ref(x, vecs, grid, **kwm),
            _out_step(vecs, mode), False, ops, 0.0,
            m * k * 4 + n * k + 2 * m * n, lib_fn=lambda: torch.matmul(x, w_f))
        folds[f"None {mode} bf16 out, {grid['bits']}-bit x, K={k}, N={n}"] = \
            dict(r, where="off the path")
    return emit, folds


def option_k9_cases(lp, seed: int, dev) -> dict:
    """K9's new forms off the path (no configuration reaches them): a
    seeded float32 x at B = 128, S = 128 against layer 0's inter weight
    with each new activation (emit), and its bfloat16 fold / float outputs
    (no activation); within the float64 ties, as phase 16 holds K9."""
    w8, vecs = lp["inter"]["w"], lp["inter"]["vecs"]
    n, k = w8.shape
    m = BATCH * SEQ
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    x = torch.randn((m, k), generator=g, device=dev) * 0.5
    w_f = (w8.float() * vecs[0][:, None]).t().contiguous()
    out = {}
    for act, mode, dt in (("gelu", "emit", torch.float32),
                          ("gelu_poly10", "emit", torch.float32),
                          ("tanh", "emit", torch.float32),
                          (None, "fold", torch.bfloat16),
                          (None, "float", torch.bfloat16)):
        kw = dict(activation=act, out_mode=mode, out_dtype=dt)
        ob = 1 if mode == "emit" else 2
        r = flex_form_case(
            f"float_int8_matmul[{act} {mode}{' bf16 out' if ob == 2 else ''}"
            f" off the path] {m}x{k}->{n}",
            lambda kw=kw: EK.float_int8_matmul(x, w8, vecs, **kw),
            lambda kw=kw: EK.float_int8_matmul_ref(x, w8, vecs, **kw),
            _out_step(vecs, mode), True, 0.0, 2.0 * m * n * k,
            m * k * 4 + n * k + m * n * ob, lib_fn=lambda: torch.matmul(x, w_f))
        out[f"{act} {mode} 8-bit{' bf16 out' if ob == 2 else ''}"] = dict(
            r, where="off the path")
    return out


def option_ln_cases(calls) -> dict:
    """``fused_add_ln``'s bfloat16 form on the non-payload bf16 forward's
    two layer-0 calls: the payload and the bfloat16 value, each
    bit-identical to the plain version's."""
    out = {}
    for tag, (a, kw) in zip(("ln1", "ln2"), calls[:2]):
        m, h = a[0].shape
        w8, wf = EK.fused_add_ln_ref(*a, **kw)
        g8, gf = EK.fused_add_ln(*a, **kw)
        if gf.dtype != torch.bfloat16:
            fail(f"fused_add_ln[{tag}] bf16: its value out is {gf.dtype}")
        res = compare(g8, w8, f"fused_add_ln[{tag} bf16] {m}x{h} payload out")
        compare_values(gf, wf, a[3][0, 6],
                       f"fused_add_ln[{tag} bf16] {m}x{h} bf16 value out")
        r = flex_form_case(
            f"fused_add_ln[{tag} bf16 y, r and value out] {m}x{h}",
            lambda a=a, kw=kw: EK.fused_add_ln(*a, **kw)[0],
            lambda a=a, kw=kw: EK.fused_add_ln_ref(*a, **kw)[0], None, False,
            0.0, 0.0, m * h * (2 + 2 + 1 + 2) + 2 * h * 4 + 32)
        out[f"{tag} bf16"] = dict(r, **res, where="")
    return out


def option_linear_cases(calls) -> dict:
    """The fused linear's new forms on the generic bf16 forward's layer-0
    calls: q and attn_out on a bfloat16 x (fold, bfloat16 out), inter on
    a bfloat16 x (the A-S gelu, emit) and, off the path, inter with
    ``gelu_poly10``."""
    out = {}
    names = ("q", "k", "v", "attn_out", "inter")
    for tag, (a, kw) in zip(names, calls[:5]):
        if tag in ("k", "v"):
            continue
        if a[0].dtype != torch.bfloat16:
            fail(f"generic bf16 {tag}: x is {a[0].dtype}")
        r = linear_case(f"{tag} bf16", a, kw)
        r["bound_ms"], r["bound_by"] = bound_ms(r["ops"], r["bytes"])
        out[f"{tag} bf16 x"] = dict(r, where="")
        if tag == "inter":
            r = linear_case("inter bf16, off the path", a,
                            dict(kw, activation="gelu_poly10"))
            r["bound_ms"], r["bound_by"] = bound_ms(r["ops"], r["bytes"])
            out["inter bf16 x gelu_poly10"] = dict(r, where="off the path")
    return out


def options_phase(params, batches, by_path, seed, dev, kind, smi) -> dict:
    """Phase 17 (see the module docstring); returns the new forms' numbers
    by kernel, for the kernels JSON."""
    cfg = B.BertConfig()
    L = cfg.num_hidden_layers
    b0 = batches[0]
    t0 = time.perf_counter()
    recipes = {}
    for rname, qd, shared_h in (("w8a8", None, False),
                                ("h-fp32", {"h": "fp32"}, False),
                                ("w8a8-mixed",
                                 *CAL.MINMAX_RECIPES["w8a8-mixed"])):
        _, q, st = CAL.calibrated_bert(cfg, batch_size=8, seq=SEQ, seed=seed,
                                       device=dev, params=params,
                                       quant_dict=qd, shared_h=shared_h)
        recipes[rname] = (q, st, *B.build_bert_engine(params, cfg, q, st,
                                                      device=dev))
    torch.cuda.synchronize()
    print(f"  set-up (W8A8, {{'h': 'fp32'}} and w8a8-mixed calibrations, "
          f"packing, plans): {time.perf_counter() - t0:.1f} s", flush=True)
    q8, s8, st8, plan8, int8p = recipes["w8a8"]

    def engine_run(rname, kw, backend="kernels"):
        return option_runner(params, cfg, *recipes[rname], dev, kw, backend)

    print("  the new kernel forms against their plain versions, on layer "
          f"0's calls (B={BATCH}, S={SEQ}; {kind}, {smi})", flush=True)
    t1 = time.perf_counter()
    gelu_calls = record_calls(
        lambda: engine_run("w8a8", dict(gelu_impl="exact"))(b0, "plain"),
        (EK, "int8_matmul_ref"))[0]
    bf_mm, bf_ln = record_calls(
        lambda: engine_run("h-fp32", dict(engine_dtype=torch.bfloat16))(
            b0, "plain"), (EK, "int8_matmul_ref"), (EK, "fused_add_ln_ref"))
    edge_calls = record_calls(
        lambda: engine_run("w8a8-mixed", dict(gelu_impl="exact"))(
            b0, "plain"), (EK, "float_edge_matmul_ref"))[0]
    lin_calls = record_calls(
        lambda: generic_bf16_runner(params, cfg, q8, s8, int8p, dev, False)(
            b0, "plain"), (LY, "fused_int8_linear"))[0]
    forms = {"int8_matmul": option_mm_cases({"gelu": gelu_calls,
                                             "bf16": bf_mm})}
    forms["float_edge_matmul"], forms["float_edge_matmul (fold / float)"] = \
        option_edge_cases(edge_calls)
    forms["float_int8_matmul"] = option_k9_cases(plan8["layers"][0], seed,
                                                 dev)
    forms["fused_add_ln"] = option_ln_cases(bf_ln)
    forms["fused_int8_linear"] = option_linear_cases(lin_calls)
    del gelu_calls, bf_mm, bf_ln, edge_calls, lin_calls
    print(f"  {sum(len(f) for f in forms.values())} new forms held, "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    seqs = {}
    for name, rname, ekw, backend, want in option_forwards(L):
        q, st, static, plan, ip = recipes[rname]
        if ekw is None:
            run = generic_bf16_runner(params, cfg, q, st, ip, dev,
                                      backend["int8_attention"])
        else:
            run = option_runner(params, cfg, q, st, static, plan, ip, dev,
                                ekw, backend)
        by_path[name] = drive_path(name, run, cfg, batches, want)
        seqs[name] = window_ms(lambda: run(b0, "kernels"), window_s=0.5)
    seqs["w8a8"] = window_ms(lambda: engine_run("w8a8", {})(b0, "kernels"),
                             window_s=0.5)
    print(f"  seq/s at B={BATCH}, S={SEQ}, median (range) of 5 windows of "
          f">= 0.5 s ({kind}, {smi}): " + "; ".join(
              f"{n} {seq_per_s(t)} (forward {t[0]:.3f} ms)"
              for n, t in seqs.items()), flush=True)
    return forms


# phase 18: the port's command line (cli.py), in process, at BERT-base
# width and depth from --seed's random weights on synthetic RTE examples
CLI_STEPS = 8
# two runs of one QAT step differ in the last bits on the card (the
# embedding gather's backward accumulates with atomics), so --remat's
# losses are held to the same bound as the CPU tests' steps
CLI_LOSS_RTOL = 1e-5


def cli_call(argv) -> dict:
    """``cli.main(argv)`` in this process, recording each train step's
    loss and device-synchronized ms, each evaluation's kernel launches
    (set to 0 just before it) with its engine forwards and metrics, the
    evaluated logits and the logged phase timings."""
    import logging

    out = {"losses": [], "step_ms": [], "evals": [], "logits": [],
           "report": ""}
    real = (TQAT.make_qat_train_step, TT.evaluate, ENG.encoder_engine,
            TT.compute_metrics)
    forwards = [0]

    def make(*a, **k):
        step = real[0](*a, **k)

        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = step(*args)
            torch.cuda.synchronize()
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            out["losses"].append(float(r[-1]))
            return r
        return run

    def evaluate(*a, **k):
        EK.reset_launches()
        forwards[0] = 0
        m = real[1](*a, **k)
        torch.cuda.synchronize()
        out["evals"].append((dict(EK.LAUNCHES), forwards[0], m))
        return m

    def encoder(*a, **k):
        forwards[0] += 1
        return real[2](*a, **k)

    def metrics(task, logits, labels):
        out["logits"].append(np.asarray(logits))
        return real[3](task, logits, labels)

    class Timings(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Phase timings"):
                out["report"] = record.getMessage()

    handler = Timings()
    logging.getLogger("tq_torch").addHandler(handler)
    TQAT.make_qat_train_step, TT.evaluate = make, evaluate
    ENG.encoder_engine, TT.compute_metrics = encoder, metrics
    try:
        out["final"] = CLI.main(argv)
    finally:
        (TQAT.make_qat_train_step, TT.evaluate, ENG.encoder_engine,
         TT.compute_metrics) = real
        logging.getLogger("tq_torch").removeHandler(handler)
    return out


def cli_eval_launches(tag, run, want) -> dict:
    """The launches of ``run``'s one evaluation, checked per engine
    forward against ``want``; returns them."""
    if len(run["evals"]) != 1:
        fail(f"{tag}: {len(run['evals'])} evaluations, expected 1")
    launches, n, _ = run["evals"][0]
    if n == 0:
        fail(f"{tag}: the evaluation ran no engine forward")
    per_fwd = {k: v / n for k, v in launches.items()}
    print(f"  [{tag}] launches over {n} engine forwards: "
          f"{ {k: v for k, v in launches.items() if v} }; per forward: "
          f"{ {k: v for k, v in per_fwd.items() if v} }", flush=True)
    if per_fwd != want:
        fail(f"{tag}: launches per forward {per_fwd}, expected {want}")
    return launches


def read_eval_results(out_dir: str) -> str:
    with open(f"{out_dir}/eval_results_rte.txt") as f:
        return f.read()


def cli_phase(params, batches, by_path, seed, dev, kind, smi) -> None:
    """Phase 18: ``cli.main`` in process at BERT-base width and depth
    (random weights from ``--seed``, ``--synthetic-data --task rte
    --max-seq-length 128``, the card): ``validate-quantized --recipe w8a8
    --engine auto`` (the engine's kernels: K1 48, K2 12, K3 24 launches an
    engine forward) against the same command on the plain versions from
    its checkpoint (equal eval results) under ``--profile-dir``; then
    ``train-quantized --recipe qat-w4a8 --max-steps 8`` without and with
    ``--remat`` (equal losses step by step; peak memory and ms a step),
    each evaluated on the W4A8 engine (K1 w4, K2, K3), and with
    ``--amp``."""
    L = B.BertConfig().num_hidden_layers
    base = ["--synthetic-data", "--task", "rte", "--max-seq-length",
            str(SEQ), "--seed", str(seed), "--model-name",
            "bert_base_uncased"]
    w8a8_want = per_forward(int8_matmul=4 * L, int8_attention=L,
                            fused_add_ln_payload=2 * L)
    w4_want = per_forward(int8_matmul_w4=4 * L, int8_attention=L,
                          fused_add_ln_payload=2 * L)
    with tempfile.TemporaryDirectory() as tmp:
        k = cli_call(["validate-quantized", "--recipe", "w8a8", "--engine",
                      "auto", "--output-dir", f"{tmp}/w8a8"] + base)
        by_path["cmdline-w8a8"] = cli_eval_launches(
            "cli w8a8 --engine auto", k, w8a8_want)
        print(f"  [cli w8a8 --engine auto] final score {k['final']:.4f}; "
              "phase timings:\n    " + k["report"].replace("\n", "\n    "),
              flush=True)
        p = cli_call(["validate-quantized", "--recipe", "w8a8", "--engine",
                      "plain", "--quant-model-path",
                      f"{tmp}/w8a8/checkpoint_rte", "--output-dir",
                      f"{tmp}/plain", "--profile-dir", f"{tmp}/trace"]
                     + base)
        if any(p["evals"][0][0].values()):
            fail(f"cli --engine plain launched kernels: {p['evals'][0][0]}")
        got, want = (read_eval_results(f"{tmp}/{d}")
                     for d in ("w8a8", "plain"))
        err = float(np.abs(k["logits"][0] - p["logits"][0]).max())
        print(f"  [cli w8a8] eval results --engine auto {got.strip()!r}, "
              f"--engine plain {want.strip()!r}; logits max |kernels - "
              f"plain| {err:.3e}", flush=True)
        if got != want:
            fail("cli w8a8: --engine auto's eval results differ from "
                 "--engine plain's")
        trace = f"{tmp}/trace/{PROF.TRACE_FILE}"
        if not os.path.exists(trace):
            fail(f"cli --profile-dir wrote no {PROF.TRACE_FILE}")
        print(f"  [cli --profile-dir] {PROF.TRACE_FILE}: "
              f"{os.path.getsize(trace)} bytes", flush=True)

        qat = ["train-quantized", "--recipe", "qat-w4a8", "--max-steps",
               str(CLI_STEPS), "--engine", "auto", "--log-every", "1"] + base
        runs = {}
        for name, extra in (("qat-w4a8", []), ("qat-w4a8 --remat",
                                                ["--remat"]),
                            ("qat-w4a8 --amp", ["--amp"])):
            torch.cuda.reset_peak_memory_stats()
            r = cli_call(qat + extra + ["--output-dir", f"{tmp}/{len(runs)}"])
            r["peak"] = torch.cuda.max_memory_allocated()
            runs[name] = r
            if len(r["losses"]) != CLI_STEPS or not np.all(
                    np.isfinite(r["losses"])):
                fail(f"cli {name}: losses {r['losses']}")
            launches = cli_eval_launches(f"cli {name} eval", r, w4_want)
            if name == "qat-w4a8":
                by_path["cmdline-qat-w4a8"] = launches
            print(f"  [cli {name}] {CLI_STEPS} steps at B=8, S={SEQ} ({kind}, "
                  f"{smi}): {np.median(r['step_ms'][1:]):.2f} ms a step "
                  f"(median of steps 2-{CLI_STEPS}), peak memory "
                  f"{r['peak'] / 2**20:.1f} MiB; losses "
                  + ", ".join(f"{x:.6f}" for x in r["losses"])
                  + f"; final score {r['final']:.4f}", flush=True)
        a, b = (np.asarray(runs[n]["losses"])
                for n in ("qat-w4a8", "qat-w4a8 --remat"))
        diff = np.abs(a - b) / np.abs(b)
        print(f"  [cli --remat] losses against the plain run: largest "
              f"relative difference {diff.max():.3e} (step "
              f"{int(diff.argmax()) + 1}; {int((diff == 0).sum())} of "
              f"{CLI_STEPS} steps equal bit for bit); peak memory "
              f"{runs['qat-w4a8 --remat']['peak'] / 2**20:.1f} against "
              f"{runs['qat-w4a8']['peak'] / 2**20:.1f} MiB", flush=True)
        if not np.all(diff <= CLI_LOSS_RTOL):
            fail(f"cli --remat: losses {b.tolist()} against {a.tolist()}")


# phase 19: MobileBERT at W4A8 from training to the engine: the JAX CLI's
# qat-w4a8 recipe at MobileBERT-uncased's widths and depth for
# MB_QAT_STEPS optimizer steps on the int8 QAT forward and
# MB_QAT_FLOAT_STEPS on the float fake-quant forward (ms a step the median
# from step MB_QAT_TIMED_FROM), then the trained model packed split-half
# int4 and served by its W4A8 engine (K6's and K8's packed int4 forms)
MB_QAT_STEPS, MB_QAT_FLOAT_STEPS, MB_QAT_TIMED_FROM = 16, 12, 6
# int8 QAT matmuls a MobileBERT forward: a layer's bn_in, bn_attn, q, k,
# v, attn_out, two per stacked FFN, the output FFN's two and out_bn; the
# classifier
MB_QAT_PER_LAYER = 15


def ranges_moved(qcfg, qstate, new) -> tuple:
    """(entries moved, entries, largest relative change) of the enabled
    sites' learned ``delta`` / ``zero_float`` between two quant states."""
    moved = total = 0
    rel = 0.0
    for site, st in qstate.items():
        if "qp" not in st or not qcfg[site].enabled:
            continue
        for f in ("delta", "zero_float"):
            old, nw = getattr(st["qp"], f), getattr(new[site]["qp"], f)
            total += old.numel()
            moved += int((old != nw).sum())
            nz = old != 0
            if nz.any():
                rel = max(rel, float(((nw - old).abs()[nz]
                                      / old.abs()[nz]).max()))
    return moved, total, rel


def w4_norm_case(tag, x, mp, r, np_, res_quant) -> dict:
    """K6's packed int4 form on ``x`` with the int4 matmul plan ``mp``
    (``r``: the residual payload or None): bit-identical to its plain
    version with res_quant both ways and to K6 int8 on the unpacked
    weight; kernel, K6 int8 (``int8_ms``), plain and ``torch._int_mm`` (on
    the unpacked weight, the int32 product only) ms; the bound with the
    weight at K/2 bytes a row."""
    m = x.shape[0]
    n, k2 = mp["w"].shape
    k = 2 * k2
    w8 = IL.unpack_int4(mp["w"], k)
    nk = dict(eps=0.0, norm="nonorm")

    def call(w, w4, rq, plain=False):
        if r is None:
            fn = EK.int8_matmul_norm_ref if plain else EK.int8_matmul_norm
            return fn(x, w, mp["vecs"], mp["scal"], *_nrm(np_),
                      res_quant=rq, w4=w4, **nk)
        fn = EK.int8_matmul_add_ln_ref if plain else EK.int8_matmul_add_ln
        return fn(x, w, mp["vecs"], mp["scal"], r, *_nrm(np_), res_quant=rq,
                  w4=w4, **nk)

    name = (f"int8_matmul_norm_w4[{tag}] {m}x{k}->{n} "
            f"{'no residual' if r is None else 'residual'}")
    for rq in (not res_quant, res_quant):
        compare(call(mp["w"], True, rq), call(mp["w"], True, rq, plain=True),
                f"{name} res_quant={rq}")
    int8 = lambda: call(w8, False, res_quant)
    compare(call(mp["w"], True, res_quant), int8(),
            f"{name} vs K6 int8 on the unpacked weight")
    w_t = w8.t()
    res = kernel_case(
        name, lambda: call(mp["w"], True, res_quant),
        lambda: call(mp["w"], True, res_quant, plain=True),
        2.0 * m * n * k,
        m * k + n * k2 + 7 * n * 4 + 10 * 4 + m * n * (1 if r is None else 2),
        lib_fn=lambda: torch._int_mm(x, w_t))
    res["int8_ms"] = device_ms(int8)
    print(f"  {name}: w4 {res['ms']:.4f} ms, K6 int8 {res['int8_ms']:.4f} "
          f"ms, torch._int_mm {res['library_ms']:.4f} ms")
    return res


def mb_w4_layer_case(flat, h8, mask, ascal, kw) -> dict:
    """K8's packed int4 form on one layer's inputs (``kw['w4']``: the
    plan's flags): bit-identical to its plain version, to the chain of
    K1 w4, K6 w4 and K7, to K8 with mixed flags (every other matmul on its
    unpacked int8 weight) and to K8 int8 on every weight unpacked; kernel,
    K8 int8 (``int8_ms``), plain and chain ms; the bound with the packed
    weights' bytes."""
    seq, m, b = kw["seq"], h8.shape[0], mask.shape[0]
    where = [i for i, a in enumerate(flat)
             if a.dtype in (torch.int8, torch.uint8)]   # each matmul's weight
    # out.dense's weight is the second to last (I / 2 bytes a row packed)
    inter = flat[where[-2]].shape[1] * (2 if kw["w4"][-2] else 1)
    ks = EK._mb_matmul_ks(kw["attn_case"] == "shared_kq", kw["n_ffn"],
                          h8.shape[1], kw["hidden"], inter)

    def unpacked(keep):
        out, flags = list(flat), []
        for j, (i, k, f) in enumerate(zip(where, ks, kw["w4"])):
            if f and not keep(j):
                out[i] = IL.unpack_int4(flat[i], k).contiguous()
            flags.append(bool(f and keep(j)))
        return tuple(out), dict(kw, w4=tuple(flags))

    flat_m, kw_m = unpacked(lambda j: j % 2 == 0)
    flat_8, kw_8 = unpacked(lambda j: False)
    args = (h8, mask, ascal)
    layer = lambda: EK.int8_mb_layer_ln(*args, flat, **kw)
    plain = lambda: EK.int8_mb_layer_ln_ref(*args, flat, **kw)
    chain = lambda: EK.mb_layer_chain(*args, flat, **kw)
    int8 = lambda: EK.int8_mb_layer_ln(*args, flat_8, **kw_8)
    want = plain()
    compare(chain(), want, f"mb_layer_chain w4 (K1 w4 + K6 w4 + K7) S={seq} "
            "vs plain")
    compare(layer(), chain(), f"int8_mb_layer_ln w4 S={seq} vs the w4 chain")
    compare(EK.int8_mb_layer_ln(*args, flat_m, **kw_m), want,
            f"int8_mb_layer_ln w4 S={seq}, mixed flags {kw_m['w4']}, vs "
            "plain")
    compare(int8(), want, f"int8_mb_layer_ln int8 S={seq} on the unpacked "
            "weights vs the w4 plain")
    nh, d = kw["n_heads"], kw["hidden"] // kw["n_heads"]
    ops = (sum(2.0 * m * flat[i].shape[0] * k for i, k in zip(where, ks))
           + 4.0 * b * nh * seq * seq * d)
    nbytes = (2 * m * h8.shape[1] + mask.numel() * 4 + ascal.numel() * 4
              + sum(a.numel() * a.element_size() for a in flat))
    k8 = kernel_case(f"int8_mb_layer_ln w4 B={b} T={seq} (one layer)", layer,
                     plain, ops, nbytes)
    t_int8, t_chain = device_ms(int8), device_ms(chain)
    print(f"  int8_mb_layer_ln S={seq}: w4 {k8['ms']:.4f} ms, int8 on the "
          f"unpacked weights {t_int8:.4f} ms ({k8['ms'] / t_int8:.2f}x), the "
          f"w4 chain (15 launches) {t_chain:.4f} ms per layer")
    return dict(per_layer([(k8, 1)]), int8_ms=t_int8, chain_ms=t_chain)


def check_mb_w4_kernels(params, cfg, qcfg, qstate, int4, static, plan,
                        batch, dev, seed: int) -> dict:
    """Phase 19's kernels on layer 0 of the trained W4A8 MobileBERT-uncased
    (B=128; S=128, and K8 at each other built seq): K6's packed int4 form
    on the layer's five NoNorm matmuls (K = 512 and 128, with and without
    a residual, res_quant both ways) and K8's on the whole layer; per
    layer times."""
    h8, mask, pl = mb_layer0_payloads(params, cfg, qcfg, qstate, int4, static,
                                      plan, batch, dev)
    lp = plan["layers"][0]
    res_ao, res_ffn, _, res_obn = static.res_quant[0]
    f0 = lp["ffns"][0]
    k6 = [(w4_norm_case("bn_in", h8, lp["bn_in"], None, lp["bn_in_norm"],
                        False), 1),
          (w4_norm_case("bn_attn", h8, lp["bn_attn"], None,
                        lp["bn_attn_norm"], False), 1),
          (w4_norm_case("attn_out", pl["c8"], lp["attn_out"], pl["li8"],
                        lp["attn_out_norm"], res_ao), 1),
          (w4_norm_case("ffn dense", pl["i8"], f0["dense"], pl["x8"],
                        f0["norm"], res_ffn[0]), 4),
          (w4_norm_case("out_bn", pl["y8"], lp["out_bn"], h8,
                        lp["out_bn_norm"], res_obn), 1)]
    report = {"int8_matmul_norm_w4": per_layer(k6)}
    report["int8_matmul_norm_w4"]["int8_ms"] = sum(
        n * c["int8_ms"] for c, n in k6)
    report["int8_matmul_norm_w4"]["variants"] = {
        tag: dict(per_layer([(c, 1)]), int8_ms=c["int8_ms"])
        for tag, (c, _) in zip(("bn_in", "bn_attn", "attn_out", "ffn dense",
                                "out_bn"), k6)}
    flat = EK.mb_layer_flat(lp, static.attn_case)
    es = plan["entry_scal"]
    report["int8_mb_layer_ln_w4"] = {}
    for seq in mb_seqs():
        if seq == SEQ:
            hs, ms = h8, mask
        else:
            hb, mb = MB.entry_value(params,
                                    request_batches(cfg, 1, seed, seq)[0],
                                    cfg, qcfg, qstate, int4, device=dev)
            hs = EK.quantize_payload(hb.reshape(BATCH * seq, -1), es[0, 0],
                                     es[0, 1])
            ms = mb.contiguous()
        report["int8_mb_layer_ln_w4"][seq] = mb_w4_layer_case(
            flat, hs, ms, lp["attn_scal"], mb_layer_kwargs(cfg, static,
                                                           seq=seq))
    return report


def mb_w4a8_phase(params, batches, by_path, seed, dev, kind, smi) -> dict:
    """Phase 19 (the module docstring): MobileBERT-uncased through the JAX
    CLI's ``qat-w4a8`` recipe, then its W4A8 engine on K6's and K8's
    packed int4 forms; returns the kernels' reports."""
    del params, batches   # MobileBERT's own, from ``seed``
    tcfg, qat0 = TT.QAT_RECIPES["qat-w4a8"]
    cfg = dataclasses.replace(MB.MobileBertConfig(), hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    task = GL.TASKS["rte"]
    arrays = DATA.encode_examples(
        DATA.SyntheticTokenizer(cfg.vocab_size), task,
        GL.synthetic_examples(task, "train", QAT_EXAMPLES, seed=seed), SEQ)
    rec = CAL.CLI_RECIPES["qat-w4a8"]
    mparams = MB.init_mobilebert_params(cfg, seed=seed, device=dev)
    qcfg = MB.declare_mobilebert_sites(rec.defaults, cfg,
                                       quant_setup=rec.quant_setup)
    apply_fn = functools.partial(MB.mobilebert_apply, cfg=cfg, device=dev)
    (qstate, qat), t_cal = timed_s(lambda: TT.prepare_qat(
        apply_fn, mparams, qcfg, arrays,
        MB.mobilebert_weight_site_tensors(mparams), qat0, rec, device=dev))
    print(f"  calibration (MSE golden-section 4-bit weights, one batch of "
          f"{rec.est_batch_size} x {SEQ} padded): {t_cal:.3f} s", flush=True)
    b8 = {k: v[:tcfg.batch_size] for k, v in arrays.items()}
    check_qat_products(apply_fn, mparams, qcfg, qstate, qat, b8,
                       per_layer=MB_QAT_PER_LAYER, extra=1,
                       picks=(("L0.bn.in.dense", 0), ("L0.attn.q", 2),
                              ("L0.attn_out.dense", 5),
                              ("L0.out.bn.dense", MB_QAT_PER_LAYER - 1)))
    peaks = {}
    torch.cuda.reset_peak_memory_stats()
    (p2, q2), losses, ms_i8 = qat_train(apply_fn, mparams, task, arrays,
                                        tcfg, qcfg, qstate, qat, MB_QAT_STEPS,
                                        timed_from=MB_QAT_TIMED_FROM)
    peaks["int8"] = torch.cuda.max_memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    _, losses_f, ms_f = qat_train(
        apply_fn, mparams, task, arrays, tcfg, qcfg, qstate,
        dataclasses.replace(qat, int8_sites=None), MB_QAT_FLOAT_STEPS,
        timed_from=MB_QAT_TIMED_FROM)
    peaks["float"] = torch.cuda.max_memory_allocated() / 2 ** 20
    moved, total, rel = ranges_moved(qcfg, qstate, q2)
    if not all(np.isfinite(losses + losses_f)):
        fail(f"mobilebert qat-w4a8: non-finite losses {losses} {losses_f}")
    print(f"  [mobilebert qat-w4a8] {MB_QAT_STEPS} steps at "
          f"B={tcfg.batch_size}, S={SEQ} ({kind}, {smi}): int8 forward "
          f"{ms_i8:.2f} ms a step (median of steps {MB_QAT_TIMED_FROM}-"
          f"{MB_QAT_STEPS}), peak {peaks['int8']:.1f} MiB; float fake-quant "
          f"forward {ms_f:.2f} ms a step (steps {MB_QAT_TIMED_FROM}-"
          f"{MB_QAT_FLOAT_STEPS}), peak {peaks['float']:.1f} MiB; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; range entries moved {moved} "
          f"of {total}, largest relative change {rel:.4e}", flush=True)
    if moved == 0:
        fail("mobilebert qat-w4a8: no learned range moved")

    int4 = MB.build_mobilebert_int_params(p2, qcfg, q2, use_int4=True)
    static, plan, _ = MB.build_mobilebert_engine(p2, cfg, qcfg, q2,
                                                 int_params=int4, device=dev)
    if not all(all(f) for f in static.w4):
        fail(f"mobilebert w4a8: the plan's matmuls are not all int4: "
             f"{static.w4}")
    routes = {t: static.layer_route(t) for t in (32, 64, SEQ)}
    wbytes = sum(a.numel() for lp in plan["layers"]
                 for a in EK.mb_layer_flat(lp, static.attn_case)
                 if a.dtype == torch.uint8)
    print(f"  [mobilebert w4a8] packed int4 encoder weights {wbytes} bytes; "
          f"the plan's layer routes by seq: {routes}", flush=True)
    if routes != {t: "k8" for t in routes}:
        fail(f"mobilebert w4a8: layer routes {routes}")
    mbatches = request_batches(cfg, 3, seed)
    report = check_mb_w4_kernels(p2, cfg, qcfg, q2, int4, static, plan,
                                 mbatches[0], dev, seed)

    n_ffn = static.n_ffn + 1
    run = mobilebert_runner(p2, cfg, qcfg, q2, static, plan, int4, dev)
    by_path["mobilebert-w4a8"] = drive_path(
        "mobilebert-w4a8", run, cfg, mbatches,
        per_forward(int8_mb_layer_ln_w4=L))
    by_path["mobilebert-w4a8-chain"] = drive_path(
        "mobilebert-w4a8-chain", mobilebert_runner(
            p2, cfg, qcfg, q2, static, plan, int4, dev, fuse_layer=False),
        cfg, mbatches, per_forward(int8_matmul_w4=(2 + n_ffn) * L,
                                   int8_matmul_norm_w4=(4 + n_ffn) * L,
                                   int8_attention_qkv=L))
    t_seq = {}
    for seq in (64, 32):
        sb = request_batches(cfg, 3, seed, seq=seq)
        by_path[f"mobilebert-w4a8-s{seq}"] = drive_path(
            f"mobilebert-w4a8-s{seq}", run, cfg, sb,
            per_forward(int8_mb_layer_ln_w4=L))
        t_seq[seq] = window_ms(lambda: run(sb[0], "kernels"))

    # the trained model's three routes, classifier.out off (phase 13's
    # reason): the engine, the generic int path on the same packed int4
    # weights and the fake-quant forward
    rb = rte_batch(cfg, seed)
    spec, qp = qcfg["classifier.out"].spec, q2["classifier.out"]["qp"]
    open_q = qcfg.replace_site("classifier.out", enabled=False)
    with torch.no_grad():
        clipped = grid_end_frac(
            apply_fn(p2, rb, qcfg=qcfg, qstate=q2)[0]["logits"], spec, qp)
        flt = apply_fn(p2, rb, qcfg=open_q, qstate=q2)[0]["logits"]
        gen = apply_fn(p2, rb, qcfg=open_q, qstate=q2,
                       int_params=int4)[0]["logits"]
    print(f"  [mobilebert w4a8] on {BATCH} synthetic RTE examples "
          f"{clipped:.4f} of the fake-quant logits sit at an end of the "
          "learned classifier.out grid; compared below with that site off")
    route_gaps(f"[mobilebert w4a8] W4A8 engine, generic int path, "
               f"fake-quant forward on {BATCH} synthetic RTE examples, "
               "classifier.out off",
               mobilebert_runner(p2, cfg, open_q, q2, static, plan, int4,
                                 dev)(rb, "kernels")["logits"],
               gen, flt, "generic", float(Q.scale_of(spec, qp)), 0.0)
    b0 = mbatches[0]
    t_fwd = window_ms(lambda: run(b0, "kernels"))
    t_chain = window_ms(lambda: MB.mobilebert_engine_apply(
        p2, b0, cfg, qcfg, q2, static, plan, int4, fuse_layer=False,
        device=dev))
    print(f"  [mobilebert w4a8] ms per forward, median (least-most) of 5 "
          f"windows of >= 1 s ({kind}, {smi}): K8 route {t_fwd[0]:.3f} "
          f"({t_fwd[1]:.3f}-{t_fwd[2]:.3f}), seq/s {seq_per_s(t_fwd)}; chain "
          f"route {t_chain[0]:.3f} ({t_chain[1]:.3f}-{t_chain[2]:.3f}), seq/s "
          f"{seq_per_s(t_chain)}; " + "; ".join(
              f"S={seq} (K8) {t[0]:.3f} ({t[1]:.3f}-{t[2]:.3f}), seq/s "
              f"{seq_per_s(t)}" for seq, t in t_seq.items()))
    return report


# phase 20: the four families through the qat-w4a8 recipe at their
# published widths and depth, FAM_QAT_STEPS optimizer steps on the int8
# QAT forward and FAM_QAT_FLOAT_STEPS on the float fake-quant forward (ms a
# step the median from step FAM_QAT_TIMED_FROM), then each trained model
# on its W4A8 engine; then the command line on ALBERT-base-v2
FAM_QAT_STEPS, FAM_QAT_FLOAT_STEPS, FAM_QAT_TIMED_FROM = 8, 4, 3
# each family's int8 QAT products a forward (per layer, beyond the layers,
# the picks held against the exact product, the last call's name): BERT's
# encoder matmuls; SqueezeBERT's grouped ones stay on fake-quant (only the
# attention output has one group), RoBERTa's out_proj has no input site
# (the unquantized tanh), ALBERT's emb_proj comes first
FAM_QAT_CALLS = {
    "roberta": dict(per_layer=6, extra=1, last="clf.dense"),
    "distilbert": dict(per_layer=6, extra=2, last="clf.out"),
    "albert": dict(per_layer=6, extra=3, picks=(
        ("emb_proj", 0), ("shared.attn.q", 1), ("shared.attn_out", 4),
        ("shared.ffn.inter", 5), ("shared.ffn.dense", 6))),
    "squeezebert": dict(per_layer=1, extra=2,
                        picks=(("L0.attn_out.dense", 0),)),
}
# the command line's family at its published widths (the tiny presets'
# head_dim 16 has no K2 instance) and its steps
CLI_FAMILY, CLI_FAMILY_STEPS = "albert_base_v2", 2


def family_train_phase(model: str, seed: int, by_path, dev, kind,
                       smi) -> dict:
    """One family of phase 20 (the module docstring); returns K1 w4's
    device ms on layer 0's four matmuls."""
    t0 = time.perf_counter()
    tcfg, qat0 = TT.QAT_RECIPES["qat-w4a8"]
    fam, cfg, params = REG.build_model(model, seed=seed, device=dev,
                                       hidden_dropout_prob=0.0,
                                       attention_probs_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    task = GL.TASKS["rte"]
    arrays = rte_arrays(cfg, "train", QAT_EXAMPLES, seed)
    rec = CAL.CLI_RECIPES["qat-w4a8"]
    qcfg = fam.declare_sites(rec.defaults, cfg, quant_setup=rec.quant_setup)
    apply_fn = functools.partial(fam.apply, cfg=cfg, device=dev)
    (qstate, qat), t_cal = timed_s(lambda: TT.prepare_qat(
        apply_fn, params, qcfg, arrays, fam.weight_site_tensors(params),
        qat0, rec, device=dev))
    print(f"  [{fam.name}] {model}: {L} layers, H={cfg.hidden_size}, "
          f"I={cfg.intermediate_size}, both dropouts 0; calibration (MSE "
          f"golden-section 4-bit weights, one batch of {rec.est_batch_size} x "
          f"{SEQ} padded) {t_cal:.3f} s", flush=True)
    b8 = {k: v[:tcfg.batch_size] for k, v in arrays.items()}
    check_qat_products(apply_fn, params, qcfg, qstate, qat, b8, n_layers=L,
                       **FAM_QAT_CALLS[fam.name])
    peaks = {}
    torch.cuda.reset_peak_memory_stats()
    (p2, q2), losses, ms_i8 = qat_train(apply_fn, params, task, arrays, tcfg,
                                        qcfg, qstate, qat, FAM_QAT_STEPS,
                                        timed_from=FAM_QAT_TIMED_FROM)
    peaks["int8"] = torch.cuda.max_memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    _, losses_f, ms_f = qat_train(
        apply_fn, params, task, arrays, tcfg, qcfg, qstate,
        dataclasses.replace(qat, int8_sites=None), FAM_QAT_FLOAT_STEPS,
        timed_from=FAM_QAT_TIMED_FROM)
    peaks["float"] = torch.cuda.max_memory_allocated() / 2 ** 20
    moved, total, rel = ranges_moved(qcfg, qstate, q2)
    if not all(np.isfinite(losses + losses_f)):
        fail(f"{model} qat-w4a8: non-finite losses {losses} {losses_f}")
    print(f"  [{fam.name} qat-w4a8] {FAM_QAT_STEPS} steps at "
          f"B={tcfg.batch_size}, S={SEQ} ({kind}, {smi}): int8 forward "
          f"{ms_i8:.2f} ms a step (median of steps {FAM_QAT_TIMED_FROM}-"
          f"{FAM_QAT_STEPS}), peak {peaks['int8']:.1f} MiB; float fake-quant "
          f"forward {ms_f:.2f} ms a step (steps {FAM_QAT_TIMED_FROM}-"
          f"{FAM_QAT_FLOAT_STEPS}), peak {peaks['float']:.1f} MiB; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; range entries moved {moved} "
          f"of {total}, largest relative change {rel:.4e}", flush=True)
    if moved == 0:
        fail(f"{model} qat-w4a8: no learned range moved")

    static, plan, ip = fam.build_engine(p2, cfg, qcfg, q2, use_int4=True,
                                        device=dev)
    if not (all(static.int8_layer) and all(all(f) for f in static.w4)):
        fail(f"{model} w4a8: the plan's matmuls are not all int4 on the "
             f"all-int8 route: {static.w4}")
    wbytes = encoder_weight_bytes(plan)
    print(f"  [{fam.name} w4a8] packed int4 encoder weights {wbytes} bytes "
          "on the card", flush=True)
    if fam.name == "albert":
        check_shared_storage(f"{model} w4a8", plan)
    batches = family_batches(cfg, seed)
    b0 = batches[0]

    def engine(batch, backend, q=qcfg):
        return fam.engine_apply(p2, batch, cfg, q, q2, static, plan, ip,
                                backend=backend, device=dev)

    tag = f"{fam.name}-w4a8"
    k1 = check_layer0_kernels(tag, *engine_entry(engine, b0),
                              cfg.num_attention_heads, static, plan, w4=True,
                              timed=True)
    print(f"  [{tag}] K1 w4 device ms, layer 0 (B={BATCH}, S={SEQ}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in k1.items())
          + f"; per layer {sum(k1.values()):.4f}")
    by_path[tag] = drive_path(
        tag, engine, cfg, batches,
        per_forward(int8_matmul_w4=4 * L, int8_attention=L,
                    fused_add_ln_payload=2 * L))
    # the trained model's three routes, its logits site off (phase 13's
    # reason)
    logits_site = FAMILY_GENERIC[fam.name][1]
    rb = rte_batch(cfg, seed)
    spec, qp = qcfg[logits_site].spec, q2[logits_site]["qp"]
    open_q = qcfg.replace_site(logits_site, enabled=False)
    with torch.no_grad():
        clipped = grid_end_frac(
            apply_fn(p2, rb, qcfg=qcfg, qstate=q2)[0]["logits"], spec, qp)
        flt = apply_fn(p2, rb, qcfg=open_q, qstate=q2)[0]["logits"]
        i8 = apply_fn(p2, rb, qcfg=open_q, qstate=q2,
                      int8_qat_sites=qat.int8_sites)[0]["logits"]
    print(f"  [{tag}] on {BATCH} synthetic RTE examples {clipped:.4f} of the "
          f"fake-quant logits sit at an end of the learned {logits_site} "
          "grid; compared below with that site off")
    route_gaps(f"[{tag}] W4A8 engine, int8 QAT forward, fake-quant forward "
               f"on {BATCH} synthetic RTE examples, {logits_site} off",
               engine(rb, "kernels", open_q)["logits"], i8, flt, "int8",
               float(Q.scale_of(spec, qp)), 0.0)
    t_eng = window_ms(lambda: engine(b0, "kernels"))
    print(f"  [{tag}] seq/s at B={BATCH}, S={SEQ}, median (range) of 5 "
          f"windows ({kind}, {smi}): trained W4A8 engine {seq_per_s(t_eng)} "
          f"(forward {t_eng[0]:.3f} ms); {time.perf_counter() - t0:.1f} s",
          flush=True)
    return k1


def families_train_phase(params, batches, by_path, seed, dev, kind,
                         smi) -> None:
    """Phase 20 (the module docstring): each of ``FAMILY_MODELS`` through
    ``qat-w4a8`` to its W4A8 engine (its weights freed before the next),
    then ``cli.main train-quantized --recipe qat-w4a8`` on ``CLI_FAMILY``
    on the card."""
    del params, batches   # each family's own, from ``seed``
    k1 = {}
    for model in FAMILY_MODELS:
        k1[model] = sum(family_train_phase(model, seed, by_path, dev, kind,
                                           smi).values())
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  K1 w4 device ms a layer ({kind}, {smi}): "
          + ", ".join(f"{m} {t:.4f}" for m, t in k1.items()))
    fam = REG.get_family(CLI_FAMILY)
    L = fam.config_cls(**fam.config_presets[CLI_FAMILY]).num_hidden_layers
    with tempfile.TemporaryDirectory() as tmp:
        r = cli_call(["train-quantized", "--recipe", "qat-w4a8",
                      "--max-steps", str(CLI_FAMILY_STEPS), "--engine",
                      "auto", "--log-every", "1", "--synthetic-data",
                      "--task", "rte", "--max-seq-length", str(SEQ),
                      "--num-train-samples", "64", "--num-val-samples",
                      str(BATCH), "--seed", str(seed), "--model-name",
                      CLI_FAMILY, "--output-dir", tmp])
    if (len(r["losses"]) != CLI_FAMILY_STEPS
            or not np.all(np.isfinite(r["losses"]))):
        fail(f"cli {CLI_FAMILY}: losses {r['losses']}")
    by_path[f"cmdline-{fam.name}-qat-w4a8"] = cli_eval_launches(
        f"cli {CLI_FAMILY} qat-w4a8 eval", r,
        per_forward(int8_matmul_w4=4 * L, int8_attention=L,
                    fused_add_ln_payload=2 * L))
    print(f"  [cli {CLI_FAMILY} qat-w4a8] {CLI_FAMILY_STEPS} steps at B=8, "
          f"S={SEQ}: losses " + ", ".join(f"{x:.6f}" for x in r["losses"])
          + f"; final score {r['final']:.4f}", flush=True)


# the phases after serving: (title, runner(params, batches, by_path,
# seed, dev, kind, smi))
LATE_PHASES = {
    13: ("QAT: the JAX CLI's qat-w4a8 recipe trained at BERT-base width and "
         "deployed through the W4A8 engine", qat_phase),
    14: ("AdaRound: the JAX CLI's w4-adaround recipe at BERT-base width and "
         "depth, then post_adaround W4A8 through the int8 engine",
         adaround_phase),
    15: ("the families: RoBERTa-base, DistilBERT-base, ALBERT-base-v2 and "
         "SqueezeBERT through their W8A8 engines and generic int paths",
         lambda params, batches, *a: families_phase(*a)),
    16: ("leave-one-out: the engine's float edges at BERT-base width",
         float_edges_phase),
    17: ("the inference options: gelu_impl, engine_dtype bf16, a mixed "
         "backend and the generic path at bf16 with int8 attention, at "
         "BERT-base width", options_phase),
    18: ("the command line: cli.main's validate-quantized and "
         "train-quantized (--remat, --amp) at BERT-base width on the card",
         cli_phase),
    19: ("MobileBERT at W4A8: the JAX CLI's qat-w4a8 recipe at "
         "MobileBERT-uncased's widths, then its W4A8 engine on K6's and K8's "
         "packed int4 forms", mb_w4a8_phase),
    20: ("the families train: RoBERTa-base, DistilBERT-base, ALBERT-base-v2 "
         "and SqueezeBERT through the qat-w4a8 recipe at their published "
         "widths, then their W4A8 engines (K1 w4, K2, K3)",
         families_train_phase),
}


def late_phases(phases, params, batches, by_path, seed, dev, kind,
                smi) -> dict:
    """Phases 13-18 of ``phases`` in order, each timed; returns what each
    returned."""
    out = {}
    for n in phases:
        title, run = LATE_PHASES[n]
        print(f"[{n}] {title}", flush=True)
        t0 = time.perf_counter()
        out[n] = run(params, batches, by_path, seed, dev, kind, smi)
        print(f"  phase {n}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated phases of 13-19 to run alone, "
                         "after phases 1 and 2")
    args = ap.parse_args(argv)
    only = {int(p) for p in args.only.split(",") if p}
    if only - set(LATE_PHASES):
        ap.error(f"--only takes phases {sorted(LATE_PHASES)}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[1] device: {kind}; nvidia-smi: {smi}", flush=True)

    t_build = KB.build()
    print(f"[2] build: {t_build:.1f} s for {', '.join(KB.SOURCES)}",
          flush=True)
    for name, log in KB.BUILD_LOG.items():
        print(f"  {name}: " + " | ".join(ptxas_lines(log)))
    blocks = KB.load("int8_attention_blocks")
    print("  int8_attention blocks an SM (seq, head_dim): " + ", ".join(
        f"({t}, {d}) {blocks(t, d)}" for t, d in EK.ATTN_SHAPES))
    fblocks = KB.load("int8_attention_flex_blocks")
    print("  int8_attention_flex blocks an SM (seq, head_dim): integer "
          "route / float64 route " + ", ".join(
              f"({t}, {d}) {fblocks(t, d, 0)} / {fblocks(t, d, 1)}"
              for t, d in EK.ATTN_SHAPES))

    cfg = B.BertConfig()
    L = cfg.num_hidden_layers
    if only:
        # the late phases alone, from the BERT-base params and request
        # batches the whole run would give them
        late_phases(sorted(only), B.init_bert_params(cfg, args.seed, dev),
                    request_batches(cfg, 3, args.seed), {}, args.seed, dev,
                    kind, smi)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    t0 = time.perf_counter()
    params, qcfg, qstate = CAL.calibrated_bert(cfg, batch_size=8, seq=SEQ,
                                               seed=args.seed, device=dev)
    static, plan, int_params = B.build_bert_engine(params, cfg, qcfg, qstate,
                                                   device=dev)
    recipes = {}
    for rname, (qd, shared_h) in CAL.MINMAX_RECIPES.items():
        _, rq, rs = CAL.calibrated_bert(cfg, batch_size=8, seq=SEQ,
                                        seed=args.seed, device=dev,
                                        params=params, quant_dict=qd,
                                        shared_h=shared_h)
        recipes[rname] = (rq, rs, *B.build_bert_engine(params, cfg, rq, rs,
                                                       device=dev))
    torch.cuda.synchronize()
    print(f"  set-up (init, W8A8 and recipe calibrations with the PEG "
          f"pre-pass, packing, plans): {time.perf_counter() - t0:.1f} s; "
          f"skip_max={static.attn_skip_max}", flush=True)
    batches = request_batches(cfg, 3, args.seed)

    print("[3] kernels against their plain versions, layer-0 inputs "
          f"(B={BATCH}, S={SEQ})", flush=True)
    report = check_kernels(params, cfg, qcfg, qstate, int_params, static,
                           plan, batches[0], dev)
    check_other_shapes(plan, dev)

    print("[4] main path: BERT-base W8A8 through bert_engine_apply",
          flush=True)
    by_path = {"w8a8": drive_path(
        "w8a8", bert_runner(params, cfg, qcfg, qstate, static, plan,
                            int_params, dev), cfg, batches,
        per_forward(int8_matmul=4 * L, int8_attention=L,
                    fused_add_ln_payload=2 * L))}

    b0 = batches[0]
    # the encoder alone (12 x int8_layer_ln + payload entry/exit) on this
    # batch's entry value and mask, against the whole forward on the same
    # batch: the difference is embeddings and the head
    h0, m0 = entry_value(params, cfg, qcfg, qstate, int_params, b0, dev)
    t_enc = window_ms(lambda: ENG.encoder_engine(h0, m0, static, plan))
    t_fwd = window_ms(lambda: B.bert_engine_apply(
        params, b0, cfg, qcfg, qstate, static, plan, int_params, device=dev))
    print("  ms per call, median (least-most) of 5 windows of >= 1 s: "
          f"engine forward {t_fwd[0]:.3f} ({t_fwd[1]:.3f}-{t_fwd[2]:.3f}), "
          f"encoder {t_enc[0]:.3f} ({t_enc[1]:.3f}-{t_enc[2]:.3f}) "
          f"(kernels), embeddings + head {t_fwd[0] - t_enc[0]:.3f} "
          "(difference of the medians; plain torch)")
    eng_plain = window_ms(lambda: B.bert_engine_apply(
        params, b0, cfg, qcfg, qstate, static, plan, int_params,
        backend="plain", device=dev))
    sim = window_ms(lambda: B.bert_apply(params, b0, cfg, qcfg, qstate,
                                         QuantMode(), device=dev))
    params16 = B.params_to(params, dtype=torch.bfloat16)
    dense16 = window_ms(lambda: B.bert_apply(params16, b0, cfg, None,
                                             device=dev))
    del params16
    print(f"  seq/s at B={BATCH}, S={SEQ}, median (range) of 5 windows "
          f"({kind}, {smi}): engine {seq_per_s(t_fwd)}, engine on plain "
          f"versions {seq_per_s(eng_plain)}, fake-quant simulation (f32, "
          f"TF32 off) {seq_per_s(sim)}, bf16 dense {seq_per_s(dense16)}")

    print("[5] flex kernels against their plain versions, layer-0 inputs "
          f"(B={BATCH}, S={SEQ})", flush=True)
    flex_reports = {}
    for rname, (rq, rs, rstatic, rplan, rint) in recipes.items():
        print(f"  -- {rname}: flex {rstatic.flex[0]}, io {rstatic.io[0]}")
        flex_reports[rname] = check_flex_kernels(params, cfg, rq, rs, rint,
                                                 rstatic, rplan, b0, dev)
    check_flex_shapes(dev)
    n_ln = check_ln_shapes(dev)
    print(f"  add+LN kernels off the main path: {n_ln} comparisons, all "
          "bit-identical", flush=True)
    check_ln_division(dev)

    print("[6] the recipes' engines: BERT-base through bert_engine_apply",
          flush=True)
    for rname, (rq, rs, rstatic, rplan, rint) in recipes.items():
        by_path[rname] = drive_path(
            rname, bert_runner(params, cfg, rq, rs, rstatic, rplan, rint,
                               dev), cfg, batches,
            per_forward(int8_matmul=3 * L, int8_attention=L,
                        float_edge_matmul=L, float_edge_levels=L,
                        flex_add_ln=2 * L))
        rh, rm = entry_value(params, cfg, rq, rs, rint, b0, dev)
        t_enc = window_ms(lambda: ENG.encoder_engine(rh, rm, rstatic, rplan))
        t_eng = window_ms(lambda: B.bert_engine_apply(
            params, b0, cfg, rq, rs, rstatic, rplan, rint, device=dev))
        t_sim = window_ms(lambda: B.bert_apply(params, b0, cfg, rq, rs,
                                               QuantMode(), device=dev))
        print(f"  [{rname}] ms per call, median (least-most) of 5 windows: "
              f"engine forward {t_eng[0]:.3f} ({t_eng[1]:.3f}-"
              f"{t_eng[2]:.3f}), encoder {t_enc[0]:.3f} ({t_enc[1]:.3f}-"
              f"{t_enc[2]:.3f}), embeddings + head {t_eng[0] - t_enc[0]:.3f}")
        print(f"  [{rname}] seq/s at B={BATCH}, S={SEQ}, median (range) of "
              f"5 windows ({kind}, {smi}): engine {seq_per_s(t_eng)}, "
              f"fake-quant simulation (f32, TF32 off) {seq_per_s(t_sim)}")

    print("[6b] the JAX CLI's PTQ recipes (MSE golden-section weight "
          "ranges): BERT-base calibrated on the card and through "
          "bert_engine_apply", flush=True)
    run_cli_recipes(params, cfg, batches, by_path, args.seed, kind, smi, dev)

    mcfg = MB.MobileBertConfig()
    t0 = time.perf_counter()
    mparams, mq, ms = CAL.calibrated_mobilebert(mcfg, batch_size=8, seq=SEQ,
                                                seed=args.seed, device=dev)
    mstatic, mplan, mint = MB.build_mobilebert_engine(mparams, mcfg, mq, ms,
                                                      device=dev)
    torch.cuda.synchronize()
    print(f"[7] MobileBERT-uncased ({mcfg.num_hidden_layers} layers, H="
          f"{mcfg.hidden_size}, bottleneck {mcfg.true_hidden_size}, "
          f"{mcfg.num_attention_heads} heads, {mcfg.num_stacked_ffn} stacked "
          f"FFNs): init, W8A8 calibration, packing, plan "
          f"{time.perf_counter() - t0:.1f} s; attn_case={mstatic.attn_case},"
          f" skip_max={mstatic.attn_skip_max}; its kernels against their "
          f"plain versions, layer-0 inputs (B={BATCH}, S={SEQ})", flush=True)
    mbatches = request_batches(mcfg, 3, args.seed)
    mb_report = check_mobilebert_kernels(mparams, mcfg, mq, ms, mint, mstatic,
                                         mplan, mbatches[0], dev, args.seed)
    check_mobilebert_shapes(mplan, mstatic, dev)

    print("[8] main path: MobileBERT-uncased W8A8 through "
          "mobilebert_engine_apply", flush=True)
    ML = mcfg.num_hidden_layers
    n_ffn = mstatic.n_ffn + 1
    routes = {t: mstatic.layer_route(t) for t in (32, 64, SEQ)}
    print(f"  the plan's layer routes by seq: {routes}", flush=True)
    if routes != {t: "k8" if t in mb_seqs() else "chain" for t in routes}:
        fail(f"MobileBERT-uncased layer routes {routes}")
    chain_fwd = per_forward(int8_matmul=(2 + n_ffn) * ML,
                            int8_matmul_norm=(4 + n_ffn) * ML,
                            int8_attention_qkv=ML)
    by_path["mobilebert"] = drive_path(
        "mobilebert", mobilebert_runner(mparams, mcfg, mq, ms, mstatic, mplan,
                                        mint, dev), mcfg, mbatches,
        per_forward(int8_mb_layer_ln=ML))
    by_path["mobilebert-chain"] = drive_path(
        "mobilebert-chain", mobilebert_runner(mparams, mcfg, mq, ms, mstatic,
                                              mplan, mint, dev,
                                              fuse_layer=False),
        mcfg, mbatches, chain_fwd)
    # the other serving buckets on the default route, the plan's
    t_seq = {}
    for seq in (64, 32):
        sb = request_batches(mcfg, 3, args.seed, seq=seq)
        by_path[f"mobilebert-s{seq}"] = drive_path(
            f"mobilebert-s{seq}", mobilebert_runner(
                mparams, mcfg, mq, ms, mstatic, mplan, mint, dev), mcfg, sb,
            per_forward(int8_mb_layer_ln=ML) if routes[seq] == "k8"
            else chain_fwd)
        t_seq[seq] = window_ms(lambda: MB.mobilebert_engine_apply(
            mparams, sb[0], mcfg, mq, ms, mstatic, mplan, mint, device=dev))
    mb0 = mbatches[0]
    mh, mm_ = MB.entry_value(mparams, mb0, mcfg, mq, ms, mint, device=dev)
    t_enc = window_ms(lambda: MB.mobilebert_encoder_engine(mh, mm_, mstatic,
                                                           mplan))
    t_enc_chain = window_ms(lambda: MB.mobilebert_encoder_engine(
        mh, mm_, mstatic, mplan, fuse_layer=False))
    t_fwd = window_ms(lambda: MB.mobilebert_engine_apply(
        mparams, mb0, mcfg, mq, ms, mstatic, mplan, mint, device=dev))
    t_chain = window_ms(lambda: MB.mobilebert_engine_apply(
        mparams, mb0, mcfg, mq, ms, mstatic, mplan, mint, fuse_layer=False,
        device=dev))
    t_sim = window_ms(lambda: MB.mobilebert_apply(mparams, mb0, mcfg, mq, ms,
                                                  QuantMode(), device=dev))
    print("  [mobilebert] ms per call, median (least-most) of 5 windows of "
          f">= 1 s: engine forward {t_fwd[0]:.3f} ({t_fwd[1]:.3f}-"
          f"{t_fwd[2]:.3f}), encoder {t_enc[0]:.3f} ({t_enc[1]:.3f}-"
          f"{t_enc[2]:.3f}) ({ML} x int8_mb_layer_ln), embeddings + head "
          f"{t_fwd[0] - t_enc[0]:.3f}; chain route: forward {t_chain[0]:.3f} "
          f"({t_chain[1]:.3f}-{t_chain[2]:.3f}), encoder {t_enc_chain[0]:.3f}"
          f" ({t_enc_chain[1]:.3f}-{t_enc_chain[2]:.3f})")
    print(f"  [mobilebert] seq/s at B={BATCH}, S={SEQ}, median (range) of 5 "
          f"windows ({kind}, {smi}): engine (int8_mb_layer_ln) "
          f"{seq_per_s(t_fwd)}, engine (chain) {seq_per_s(t_chain)}, "
          f"fake-quant simulation (f32, TF32 off) {seq_per_s(t_sim)}; "
          + "; ".join(
              f"at S={seq} on the default route ({routes[seq]}): forward "
              f"{t[0]:.3f} ms ({t[1]:.3f}-{t[2]:.3f}), engine "
              f"{seq_per_s(t)}" for seq, t in t_seq.items()))

    print("[9] the leave-one-out kernels against their plain versions, "
          f"layer-0 inputs (B={BATCH}, S={SEQ})", flush=True)
    t0 = time.perf_counter()
    x_fp32, h_fp32 = (CAL.calibrated_bert(
        cfg, batch_size=8, seq=SEQ, seed=args.seed, device=dev,
        params=params, quant_dict=qd)[1:] for qd in ({"x": "fp32"},
                                                     {"h": "fp32"}))
    x_fp32 = (*x_fp32, B.build_bert_int_params(params, *x_fp32))
    h_fp32 = (*h_fp32, *B.build_bert_engine(params, cfg, *h_fp32,
                                            device=dev))
    torch.cuda.synchronize()
    print(f"  set-up ({{'x': 'fp32'}} and {{'h': 'fp32'}} calibrations, "
          f"packing, plan): {time.perf_counter() - t0:.1f} s; "
          f"{{'h': 'fp32'}} fold flags {h_fp32[2].fold[0]}")
    report["fused_int8_linear"] = check_linear_kernels(
        params, cfg, (qcfg, qstate, int_params), x_fp32, b0, dev)
    check_erf_reciprocal(dev)
    check_linear_shapes(dev)
    report["fused_add_ln"] = check_engine_fp32_kernels(params, cfg, h_fp32,
                                                       b0, dev)

    print("[10] the leave-one-out routes at BERT-base: the generic int path "
          "with the fused linear, and the engine's non-payload route",
          flush=True)
    by_path["generic-w8a8"] = drive_path(
        "generic-w8a8", generic_runner(params, cfg, qcfg, qstate, int_params,
                                       dev), cfg, batches,
        per_forward(fused_int8_linear=6 * L + 1,
                    fused_linear_quantize=5 * L + 1))
    by_path["generic-x-fp32"] = drive_path(
        "generic-x-fp32", generic_runner(params, cfg, *x_fp32, dev), cfg,
        batches, per_forward(fused_int8_linear=5 * L + 1,
                             fused_linear_quantize=5 * L + 1))
    hq, hs, hst, hplan, hint = h_fp32
    by_path["engine-h-fp32"] = drive_path(
        "engine-h-fp32", bert_runner(params, cfg, hq, hs, hst, hplan, hint,
                                     dev), cfg, batches,
        per_forward(int8_matmul=4 * L, int8_attention=L, fused_add_ln=2 * L))
    gen = generic_runner(params, cfg, qcfg, qstate, int_params, dev)
    t_gen = window_ms(lambda: gen(b0, "kernels"))
    t_int = window_ms(lambda: B.bert_apply(params, b0, cfg, qcfg, qstate,
                                           QuantMode(), int_params=int_params,
                                           device=dev))
    genx = generic_runner(params, cfg, *x_fp32, dev)
    t_genx = window_ms(lambda: genx(b0, "kernels"))
    hh, hm = entry_value(params, cfg, hq, hs, hint, b0, dev)
    t_enc = window_ms(lambda: ENG.encoder_engine(hh, hm, hst, hplan))
    t_eng = window_ms(lambda: B.bert_engine_apply(
        params, b0, cfg, hq, hs, hst, hplan, hint, device=dev))
    t_sim = window_ms(lambda: B.bert_apply(params, b0, cfg, hq, hs,
                                           QuantMode(), device=dev))
    print("  ms per call, median (least-most) of 5 windows of >= 1 s: "
          f"generic W8A8 fused {t_gen[0]:.3f} ({t_gen[1]:.3f}-{t_gen[2]:.3f})"
          f", generic W8A8 int path {t_int[0]:.3f} ({t_int[1]:.3f}-"
          f"{t_int[2]:.3f}), generic x-fp32 fused {t_genx[0]:.3f} "
          f"({t_genx[1]:.3f}-{t_genx[2]:.3f}); h-fp32 engine forward "
          f"{t_eng[0]:.3f} ({t_eng[1]:.3f}-{t_eng[2]:.3f}), encoder "
          f"{t_enc[0]:.3f} ({t_enc[1]:.3f}-{t_enc[2]:.3f}), embeddings + "
          f"head {t_eng[0] - t_enc[0]:.3f}")
    print(f"  seq/s at B={BATCH}, S={SEQ}, median (range) of 5 windows "
          f"({kind}, {smi}): generic W8A8 on the fused linear "
          f"{seq_per_s(t_gen)}, on the int path {seq_per_s(t_int)}; "
          f"generic {{'x': 'fp32'}} on the fused linear {seq_per_s(t_genx)};"
          f" {{'h': 'fp32'}} engine {seq_per_s(t_eng)}, its fake-quant "
          f"simulation (f32, TF32 off) {seq_per_s(t_sim)}")

    print("[11] serving: the W8A8 checkpoints of phases 4 and 7 served by "
          "build_engine_from_checkpoint, one CUDA graph per (batch, seq) "
          "bucket", flush=True)
    t0 = time.perf_counter()
    serve_phase("bert", cfg, params, qstate,
                bert_runner(params, cfg, qcfg, qstate, static, plan,
                            int_params, dev),
                per_forward(int8_matmul=4 * L, int8_attention=L,
                            fused_add_ln_payload=2 * L),
                args.seed, dev, kind, smi, by_path, eager_loop=True)
    serve_phase("mobilebert", mcfg, mparams, ms,
                mobilebert_runner(mparams, mcfg, mq, ms, mstatic, mplan, mint,
                                  dev),
                per_forward(int8_mb_layer_ln=ML), args.seed, dev, kind, smi,
                by_path)
    serve_option_case(
        "bert-bf16", cfg, params, qstate, True, "engine",
        option_runner(params, cfg, qcfg, qstate, static, plan, int_params,
                      dev, dict(engine_dtype=torch.bfloat16), "kernels"),
        per_forward(int8_matmul=4 * L, int8_attention=L,
                    fused_add_ln_payload=2 * L), args.seed, dev, kind, smi,
        by_path)
    # no quant state: the float model, its attention in bfloat16 (no
    # kernel: nothing of the port's is launched)
    serve_option_case(
        "bert-bare", cfg, params, None, False, "generic",
        lambda batch, _which: B.bert_apply(
            params, batch, cfg, attention_dtype=torch.bfloat16,
            device=dev)[0], per_forward(), args.seed, dev, kind, smi,
        by_path)
    print(f"  phase 11: {time.perf_counter() - t0:.1f} s", flush=True)

    print("[12] W4A8: BERT-base on split-half packed int4 weights through "
          "bert_engine_apply and the generic path", flush=True)
    t0 = time.perf_counter()
    report.update(w4a8_phase(params, cfg, plan, batches, by_path, args.seed,
                             dev, kind, smi))
    print(f"  phase 12: {time.perf_counter() - t0:.1f} s", flush=True)

    late = late_phases(sorted(LATE_PHASES), params, batches, by_path,
                       args.seed, dev, kind, smi)

    report.update({k: mb_report[k] for k in (
        "int8_matmul_norm", "int8_attention_qkv")})
    k8_by_seq = mb_report["int8_mb_layer_ln"]
    report["int8_mb_layer_ln"] = k8_by_seq[SEQ]
    report["float_edge_matmul"] = dict(
        flex_reports["w8a8-mixed"]["float_edge_matmul"],
        level_pass=flex_reports["w8a8-mixed"]["float_edge_levels"])
    report["flex_add_ln"] = flex_reports["w8a8-mixed"]["flex_add_ln"]
    pallas = "transformer_quantization_tpu/ops/pallas/engine_kernels.py"
    sources = {"int8_matmul": ("int8_matmul.cu", f"{pallas}:254"),
               "int8_matmul_w4": ("int8_matmul.cu", f"{pallas}:254"),
               "int8_attention": ("int8_attention.cu", f"{pallas}:804"),
               "fused_add_ln_payload": ("add_ln_payload.cu", f"{pallas}:1073"),
               "float_edge_matmul": ("float_edge_matmul.cu",
                                     f"{pallas}:1425"),
               "flex_add_ln": ("flex_add_ln.cu", f"{pallas}:1648"),
               "int8_matmul_norm": ("int8_matmul_norm.cu", f"{pallas}:1264"),
               "int8_attention_qkv": ("int8_attention.cu", f"{pallas}:833"),
               "int8_mb_layer_ln": ("int8_mb_layer.cu", f"{pallas}:2038"),
               "fused_add_ln": ("flex_add_ln.cu", f"{pallas}:1021"),
               "fused_int8_linear": (
                   "fused_int8_linear.cu",
                   "transformer_quantization_tpu/ops/pallas/int_matmul.py:257"),
               "fused_int8_linear_w4": (
                   "fused_int8_linear.cu",
                   "transformer_quantization_tpu/ops/pallas/int_matmul.py:257")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        entry = {
            "name": name, "route": "cuda",
            "source": "transformer_quantization_tpu_torch/ops/kernels/csrc/"
                      + src,
            "replaces": replaces,
            "launches": sum(p[name] for p in by_path.values()),
            **{k: r[k] for k in keys},
            "launches_by_path": {p: c[name] for p, c in by_path.items()}}
        variant = "int8_matmul_fold" if name == "int8_matmul" else name
        if variant in flex_reports["w8a8-mixed"]:
            entry["variants"] = {rn: {k: fr[variant][k] for k in keys}
                                 for rn, fr in flex_reports.items()}
        if name == "int8_matmul":
            entry["variants"]["mobilebert"] = {
                k: mb_report[name][k] for k in keys}
        if name == "int8_mb_layer_ln":
            entry["chain_ms"] = r["chain_ms"]
        if name == "int8_matmul_norm":
            entry["variants"] = {v: {k: c[k] for k in keys}
                                 for v, c in r["variants"].items()}
        if name == "float_edge_matmul":
            entry["level_pass"] = {
                "name": "float_edge_levels", "route": "cuda",
                "source": entry["source"], "replaces": f"{pallas}:178",
                "launches": sum(p["float_edge_levels"]
                                for p in by_path.values()),
                **{k: r["level_pass"][k] for k in keys},
                "launches_by_path": {p: c["float_edge_levels"]
                                     for p, c in by_path.items()},
                "variants": {rn: {k: fr["float_edge_levels"][k]
                                  for k in keys}
                             for rn, fr in flex_reports.items()}}
            entry["gemm_alone"] = {
                rn: {k: fr["float_edge_gemm"][k] for k in keys}
                for rn, fr in flex_reports.items()}
        if name in ("int8_matmul_w4", "fused_int8_linear_w4"):
            entry["variants"] = {v: {k: c[k] for k in keys}
                                 for v, c in r["variants"].items()}
        if name == "int8_matmul_w4":
            entry["int8_ms"] = r["int8_ms"]
            entry["variants"]["M=256"]["int8_ms"] = r["variants"]["M=256"][
                "int8_ms"]
        if name == "fused_int8_linear":
            entry["variants"] = {v: {k: c[k] for k in keys}
                                 for v, c in r["variants"].items()}
            qp = r["quantize_pass"]
            entry["quantize_pass"] = {
                "name": "fused_linear_quantize", "route": "cuda",
                "source": entry["source"],
                "replaces": "transformer_quantization_tpu/ops/pallas/"
                            "int_matmul.py:126",
                "launches": sum(p["fused_linear_quantize"]
                                for p in by_path.values()),
                **{k: qp[k] for k in keys},
                "launches_by_path": {p: c["fused_linear_quantize"]
                                     for p, c in by_path.items()},
                "variants": {v: {k: c[k] for k in keys}
                             for v, c in qp["variants"].items()}}
        kernels.append(entry)
    # K8 at its other built seqs: their main paths are the serving buckets
    for seq in mb_seqs():
        if seq == SEQ:
            continue
        path, r = f"mobilebert-s{seq}", k8_by_seq[seq]
        kernels.append({
            "name": f"int8_mb_layer_ln (S={seq})", "route": "cuda",
            "source": "transformer_quantization_tpu_torch/ops/kernels/csrc/"
                      "int8_mb_layer.cu",
            "replaces": f"{pallas}:2038",
            "launches": by_path[path]["int8_mb_layer_ln"],
            **{k: r[k] for k in keys}, "chain_ms": r["chain_ms"],
            "launches_by_path": {path: by_path[path]["int8_mb_layer_ln"]}})
    # the new forms of phase 16: each kernel's headline numbers are one
    # form's (the first listed of FLOAT_EDGE_HEADLINE that ran), the rest
    # under ``variants``
    src = "transformer_quantization_tpu_torch/ops/kernels/csrc/"
    for name, (file, replaces, key) in {
            "int8_attention_flex": ("int8_attention.cu", f"{pallas}:804",
                                    "int8_attention_flex"),
            "float_edge_matmul (fold / float)": (
                "float_edge_matmul.cu", f"{pallas}:201",
                "float_edge_matmul_fold"),
            "float_int8_matmul": ("float_int8_gemm.cu", f"{pallas}:178",
                                  "float_int8_matmul")}.items():
        fm = late[16][name.split(" ")[0]]
        if name.startswith("float_edge"):
            fm = {f: r for f, r in fm.items() if " emit " not in f}
        head = next(r for f, r in fm.items())
        kernels.append({
            "name": name, "route": "cuda", "source": src + file,
            "replaces": replaces,
            "launches": sum(p[key] for p in by_path.values()),
            **{k: head[k] for k in keys},
            "launches_by_path": {p: c[key] for p, c in by_path.items()
                                 if c[key]},
            "variants": {f: {**{k: r[k] for k in keys},
                             "config": r["config"],
                             **{x: r[x] for x in ("where", "route",
                                                  "library_f64_ms")
                                if r.get(x)}}
                         for f, r in fm.items()}})
    # phase 17's forms: variants of their kernels' rows
    for entry in kernels:
        for form, r in late[17].get(entry["name"], {}).items():
            entry.setdefault("variants", {})[f"{form} (phase 17)"] = {
                **{k: r[k] for k in keys}, "where": r.get("where", "")}
    # phase 19's packed int4 forms of K6 and K8: variants of their rows,
    # each with its own launches (the W4A8 MobileBERT paths)
    mb4 = late[19]
    k6w4 = mb4["int8_matmul_norm_w4"]
    w4_forms = {
        "int8_matmul_norm": [("w4 per layer (phase 19)", k6w4, None)] + [
            (f"w4 {tag} (phase 19)", r, None)
            for tag, r in k6w4["variants"].items()],
        "int8_mb_layer_ln": [
            (f"w4 S={seq} (phase 19)", r,
             "mobilebert-w4a8" + ("" if seq == SEQ else f"-s{seq}"))
            for seq, r in mb4["int8_mb_layer_ln_w4"].items()]}
    for entry in kernels:
        for form, r, path in w4_forms.get(entry["name"], ()):
            counter = entry["name"] + "_w4"   # the form's LAUNCHES key
            counts = {p: c[counter] for p, c in by_path.items()
                      if c[counter] and (path is None or p == path)}
            entry.setdefault("variants", {})[form] = {
                **{k: r[k] for k in keys}, "int8_ms": r["int8_ms"],
                "launches": sum(counts.values()),
                "launches_by_path": counts}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

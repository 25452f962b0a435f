#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. Device and build: the card's name and power limit, then every CUDA
   kernel under ``src/repro_torch/kernels/csrc`` built with nvcc, one
   process per source, all at once.
2. Kernel vs plain: ``matmul_relu`` at every shape the serving path
   launches — the (1020, 784) and (1020, 1020) layers of the stack below
   at buckets 1, 8, 32 and 128, in f32 and bf16 — plus a ragged
   (1204, 3000) x (3000, 77), each held against its plain PyTorch
   version and timed beside it, beside ``relu(matmul)`` and beside its
   bound, with the bound's two sides (the bytes at HBM rate and the
   operations at the operands' peak).
3. Kernel vs plain: ``gram`` and ``propagate_gram`` at every shape the
   training slice launches — layer 0 (20, 784, 3000) and (1, 784, 60000),
   layers 1 and l >= 2 with W (1020, 784) and (1020, 1020) over M=20
   workers of 3000 samples and one of 60000 — phase 16's readout of
   Danube's taps, (1, 3840, 4096), (4, 3840, 1024) and (1, 3840, 1024),
   plus ragged cases in f32 and bf16, each timed beside its plain
   version, its library call (``baddbmm``; ``relu(matmul)`` then
   ``baddbmm``) and two bounds, at the f32 CUDA-core peak and at the
   tensor-core peak the kernels compute at (three TF32 products per f32
   product; bf16 at the bf16 peak), with its TFLOP/s; the headline, centralized and readout ``gram`` also held
   within 8 f32 ulps of max|G| of a float64 Gram.
4. The serving slice at full width: a Table-I MNIST-geometry stack
   (P=784, Q=10, n=2Q+1000=1020, L=20) with seeded untrained weights is
   exported with the port's ``export_artifact`` and served through
   ``repro_torch.launch.serve_dssfn.main``; the logits are held against
   a float64 numpy forward of the same weights.
4b. The hardened runtime at full width (phase 4's stack, through
   ``repro_torch.serve.ServeRuntime``).  (a) A wall-clock stream through
   ``serve_dssfn.main --runtime`` (512 single-sample requests 100 µs
   apart, a timer flush every 200 µs, max batch 32): all completed, no
   breaker open and no ``degraded_reasons``, 20 ``matmul_relu`` launches
   a batch, logits against float64; p50, p99, throughput and mean batch
   beside phase 4's ``MicroBatcher``; then three more such streams
   straight through ``ServeRuntime``, each split into the submitter's
   wait for the runtime's lock, the wait from arrival to the batch's
   forward and the forward to completion.  (b) Four submitter threads x
   128 requests race the timer thread in bucket 32: every handle
   terminal, every result bit-equal to its own ``engine.forward``.
   (c) ``repro``'s seeded ``ManualClock`` chaos drill
   (``fail=0.25:burst=4:seed=7``, 400 requests, a NaN in every 25th) on
   784-row requests in bucket 32: the stats and per-handle outcomes of
   the port's CPU run of the same drill, its event kinds less the CPU's
   ``degrade`` records, no ``degraded_reasons``, every batch served
   through the kernel (20 launches each, after the breaker's opens as
   before them), each completed result bit-equal to its own forward and
   the logits against float64.  (d) Reload under fire: a
   ``corrupt_artifact`` copy refused (``stale-weights``, results
   unchanged bit for bit), then a second seeded stack swapped in and
   served bit-equal to a fresh engine, also to a request that arrives as
   a card tensor.  It also times the runtime's host cost per batch of 32
   single-sample requests against a direct forward.  A
   ``{"runtime": ...}`` line carries the numbers.
5. The training slice at full width: Table-I MNIST geometry (P=784,
   Q=10, n=1020, L=20, K=100, J=60000 train and 10000 test of the port's
   planted-teacher data) trained through
   ``repro_torch.launch.train_dssfn.main``, decentralized (M=20) and
   centralized (M=1).  It checks finite readouts, one ``gram`` and 20
   ``propagate_gram`` launches per train, a full-width layer-1 step on
   the card against the same step on the CPU through the plain versions,
   the reference's centralized-equivalence bars, and that the exported
   stack serves through ``ServeEngine`` bit for bit like
   ``ssfn.predict``.  It prints where a layer's time goes.
5b. The paper's gossip network at full width (``benchmarks/
   bench_equivalence.py``'s degree-4 circular graph over M=20, with B
   from ``gossip_rounds_for_tolerance(circular_mixing_matrix(20, 4),
   1e-8)``, computed here: 52).  (a) The same train through
   ``train_dssfn.main`` with ``--consensus gossip:B:4``: one ``gram`` and
   20 ``propagate_gram`` launches, finite readouts, eq.-15 scalars of
   2 d B = 416 x the ExactMean run's, each layer's final ADMM consensus
   error within 1e-4 x max|O_l|, and the equivalence bars against phase
   5's centralized run.  (b) A layer-1 step under ``RingGossip(B, 4)``,
   card vs CPU plain, broken down beside ExactMean's.  (c) One
   ``Gossip.mix`` of an (20, 10, 1020) f32 message, compressed (19
   hops), serial and over a bf16 wire: card vs CPU within 1e-6 x max|x|,
   each beside a float64 H^B x, timed.  (d) The benchmark's legacy call,
   ``layerwise.train_decentralized_ssfn(consensus_fn=make_consensus_fn(
   "gossip", ...), gossip_rounds=B)``, held to the same launches and bars
   (its eq.-15 scalars are B x ExactMean's, the legacy accounting).  A
   ``{"gossip": ...}`` line carries the numbers.
5c. The paper's §IV non-ideal links at full width.  (a) Three trains
   through ``train_dssfn.main`` with ``--consensus quantized:8`` (an
   8-bit stochastically rounded all-reduce), ``lossy:0.1:B:4`` (phase
   5b's network with 10% link loss) and ``stale:2``: one ``gram`` and 20
   ``propagate_gram`` launches each, finite readouts, eq.-15 scalars and
   bytes against the ExactMean run's, each layer's final consensus error
   against max|O_l|, agreement and accuracy gap against phase 5's
   centralized run, and the bar ``repro``'s tests set for the policy: the
   layer-0 readout within 5e-2 (quantized), 0.10 (lossy) and 1e-3
   (stale) of a float64 constrained-ridge oracle.  The same lossy network
   and the clean gossip, trained through ``dssfn.train`` at the depth and
   penalty of ``repro``'s lossy accuracy test (3 layers, mu0 = mul =
   1e-2), print the accuracy the links cost.  (b) One mix of a (20, 10, 1020) f32
   message for each of the 8 grammar entries ported (the hypercube over
   16 workers), card vs CPU from the same seed: the draws bit for bit,
   the values within 1e-6 x max|x|, timed (CUDA events, host enqueue,
   device time; the first mix with its host draws).  (c) threefry
   ``random_bits`` and ``bernoulli`` over 20 worker keys x (10, 1020),
   card vs CPU bit for bit, timed.  A ``{"policies": ...}`` line carries
   the numbers.
5d. The fault model and the Byzantine-robust policies at full width, on
   the degree-4 ring.  (a) Four trains through ``train_dssfn.main``:
   ``async:rounds=52:interval=4:drop=0.1:seed=7@ring:4`` (drops, three
   local ADMM rounds per mix), and one attacker (worker 3 sending -x)
   through the vulnerable ``async:rounds=3`` and the screened
   ``trimmed:f=1``, and two NaN bombs (workers 3 and 11) through
   ``median``: one ``gram`` and 20 ``propagate_gram`` launches each,
   finite readouts, eq.-15 scalars of 104x and 24x ExactMean's, the async
   layer-0 readout within 0.35 of the float64 oracle (``repro``'s bar for
   an interval of 4); time, accuracy, agreement with the centralized run,
   each layer's final consensus error, and the attacked trains' layer-0
   distance to the honest-data oracle printed.  (b) One mix of a (20, 10,
   1020) f32 message for each of the 10 grammar entries ported, the four
   train specs and AsyncGossip under a NaN bomb, card vs CPU: the masks,
   link gates and noise bit for bit, values within 1e-6 x max|x|, NaN
   bombs screened by the robust policies and not by AsyncGossip, the mean
   kept under drops; timed cold and warm.  (c) A layer-1 step under the
   async spec, card vs CPU plain, beside ExactMean's.  A ``{"faults":
   ...}`` line carries the numbers.
5e. Elastic training at full width (phase 5's geometry and seed, M=20,
   ExactMean), through ``train_dssfn.main`` in one temporary directory
   under the checkout.  (a) ``--checkpoint-dir D --checkpoint-every 7
   --stop-after-layer 6``: it writes ``dssfn_layer_007.npz`` and returns
   7 readouts with 1 ``gram`` and 6 ``propagate_gram`` launches; then a
   fresh ``main`` with ``--resume`` restores it onto the card, makes 0
   ``gram`` and 14 ``propagate_gram`` launches and writes layers 014 and
   021; all 21 readouts, all 20 R, the eq.-15 scalars and the test
   accuracy equal phase 5's decentralized run bit for bit.  (b) A fresh
   run with ``--checkpoint-every 7 --guard-divergence`` whose monitor is
   made to flag layer 10's first attempt (``repro``'s
   ``tests/test_checkpoint.py`` drill): one rollback, the warning names
   layer 7, O_0..O_6 and R_0..R_5 equal phase 5's bit for bit and R_6 is
   redrawn, every readout finite; its accuracy printed beside phase 5's.
   (c) ``export_from_checkpoint(D, ...)`` takes layer 021, and
   ``serve_dssfn.main`` serves it in bucket 32 with 20 ``matmul_relu``
   launches a forward; its logits equal those of phase 5's readouts
   exported and served the same way, bit for bit.  (d) Each checkpoint's
   bytes, host fetch and ``save_pytree`` (savez and fsync) ms, the
   resume's load ms and each drill's train time beside phase 5's.  An
   ``{"elastic": ...}`` line carries the numbers.
5f. ``MeshBackend`` over ``torch.distributed`` at full width (phase 5's
   geometry and seed; each train traces its layers' last iteration).
   (a) ExactMean through ``train_dssfn.main --backend mesh --ranks 4
   --dist-backend gloo``, 6 layers (depth cut: R is drawn in layer order,
   so its layers are phase 5's first 6): four ranks of five workers share
   the card, each staging its messages through pinned host memory; 4
   ``gram`` and 24 ``propagate_gram`` launches summed over the ranks,
   each layer's readout gap to phase 5's simulated run printed and held
   to 1e-4 at layers 0-2, the equivalence bars against phase 5's
   centralized run cut to 6 layers, the eq.-15 scalars equal to phase
   5's over those layers.  (b) ``gossip:52:4``, 3 layers (depth cut),
   the simulated run and the mesh: readouts within 1e-4, each layer's
   final consensus error within 1e-4 x max|O_l|, the point-to-point
   messages, permutes and bytes the schedule predicts; then the mesh's
   first layer again, its readouts bit-equal to the first run's.  (c) One NCCL rank holding
   all 20 workers, 3 layers: within 1e-4 of phase 5's readouts, its NCCL
   all-reduces counted.  (d) (a)'s stack served through ``ServeEngine``
   (6 ``matmul_relu`` launches; bit-equal to its ``ssfn.predict``,
   within 1e-4 x max of its float64 forward, and off the logits of phase
   5's net cut to 6 layers by no more than the two runs' readouts
   account for), then the chaos
   drill's mesh leg on the card, its stats and outcomes the CPU drill's.
   (e) Per rank: train time, train ms per ADMM iteration, host ms in the
   transport and of it the wait for the card, beside phase 5's.  A
   ``{"mesh": ...}`` line carries the numbers.
5g. The port's static checker, spmdlint (``repro_torch.analysis``).  (a)
   ``python -m repro_torch.launch.lint_dssfn --all-grammar --device cuda
   --format json`` as a subprocess: exit 0 and ``"count": 0`` over all six
   checks, its wire probe on 8 gloo ranks sharing the card, host-staged
   (their kernel launches are the subprocesses' and are not counted
   here).  (b) Layer 1's fused step at Table-I width (phase 5's inputs:
   M=20, n=1020, Q=10, J_m=3000, K=100, f32) on a ``SimulatedBackend``,
   recorded under ExactMean and ``gossip:3:wire=bf16``: zero findings,
   one ``propagate_gram`` record accumulating in f32, every factorization
   under ``guarded_cholesky``.  (c) ``check_serve_contract`` on phase 4's
   stack at buckets 1 and 32, f32: zero findings, 20 ``matmul_relu``
   records a bucket, ``cache_info()`` unchanged; the same stack in bf16
   reports ``numerics-accum``.  (d) Phase 2's ``matmul_relu`` bucket-1
   and bucket-128 times (the recorder hook now in every wrapper) beside
   ``PERF.md``'s earlier ones, and a ``{"lint": ...}`` line with each
   check's wall time, findings and the record's call counts.
6. Kernel vs plain: ``flash_attention`` at the full-width H2O-Danube3-4B
   shapes — (1, 32, 8192, 120) and (1, 32, 4096, 120) with the 4096
   window, in bf16 and f32, and (1, 32, 8192, 120) over KV at 8 heads, as
   the model launches it (GQA read in place) — plus a ragged
   (1, 32, 4100, 120), a (2, 8, 77, 80) and Zamba2-2.7B's (1, 32, 8192,
   80), and the attention of phases 12-14 (Phi-3.5-MoE's (1, 32, 8192,
   128) over 8 KV heads, full causal; Mixtral-8x22B's (1, 48, 8192, 128)
   over 8, window 4096; InternVL2-1B's (1, 14, 8192, 64) over 2;
   MusicGen-medium's (2, 24, 1500, 64); bf16, and f32 where the f32
   checks launch it) and phase 16(d)'s frozen Danube ((2, 32, 2048, 120)
   over 8 KV heads, bf16), each held per element against its plain version
   (bf16 also launched twice, bit for bit) and timed beside it, beside
   ``scaled_dot_product_attention`` and beside its bound, with its
   TFLOP/s and its share of the bound.
7. The inference slice at full width: H2O-Danube3-4B, all 24 layers, with
   seeded weights and tokens from the port's ``TokenStream``.  (a) A bf16
   scoring forward through ``make_loss_fn`` at B=1, S=8192 with the
   kernel on: 24 launches and a finite loss, and where the forward's time
   goes (CUDA events around the whole forward and around each kernel call
   in it).  (b) The same forward in f32, kernel route against the plain
   chunked route.  (c) ``repro_torch.launch.serve.serve`` at batch 2, a
   4608-token prompt (past the window, so the ring cache wraps) and 16
   generated tokens, in bf16.  (d) In f32, prefill + greedy decode
   logits at each generated position against the f32 forward's, and
   where a decode step's time goes (the host's enqueue against the
   synchronized step).
8. Kernel vs plain: ``ssm_scan`` at the full-width Zamba2-2.7B Mamba2
   shapes — (1, 8192, 32, 160), state 64, chunk 256, in bf16 and f32, at
   B=2, and at S=4352 (4100 padded to whole chunks) — plus chunk 64 and
   chunk 16 at the reduced width and an odd dh of 80, each held per element
   against its plain version (and launched twice, bit for bit), timed
   beside it and beside its bound (with its two sides); then
   ``torch.profiler`` over a few headline calls prints each of its
   kernels' device time.
   (``python3 chip_smoke.py --profile-ssm`` builds ``ssm_scan`` and runs
   only that profile, in bf16 and f32.)
9. The hybrid slice at full width: Zamba2-2.7B, all 54 Mamba2 layers and
   9 calls of its shared attention block, seeded weights.  (a) A bf16
   scoring forward at B=1, S=8192 with the kernels on: 54 ``ssm_scan``
   and 9 ``flash_attention`` launches, a finite loss, and each kernel's
   share of the forward.  (b) In f32, every Mamba2 layer's kernel call
   against the plain scan on the same input, and the kernel route's
   logits against the plain route's, beside the model's response to one
   ulp of noise.  (c) ``launch.serve.serve`` at batch 2, a 4608-token
   prompt and 16 generated tokens, in bf16.  (d) In f32, prefill + greedy
   decode logits against the forward's.
10. Kernel vs plain: ``mlstm_scan`` at the full-width xLSTM-350M mLSTM
    shapes — (1, 8192, 4, 256), chunk 256, in bf16 and f32, at B=2 and
    S=4608, and at S=4352 (4100 padded with the model's padding) — plus
    the reduced (2, 128, 4, 64) at chunk 16 and dk 64 != dv 128 at chunk
    64, each held per element against its plain version (y and the final
    C, n, m; launched twice, bit for bit), timed beside it and beside its
    bound; then ``torch.profiler`` over a few headline calls prints each
    of its three kernels' device time, in bf16 and f32.
    (``python3 chip_smoke.py --profile-mlstm`` builds ``mlstm_scan`` and
    runs only that profile.  ``--parent DIR``, with DIR a checkout of
    another commit, builds DIR's ``mlstm_scan.cu`` as well, times it
    beside every case and in the profile, and requires its f32 outputs
    to equal this kernel's bit for bit.)
11. The xLSTM slice at full width: xLSTM-350M, seeded weights, 12 of its
    24 layers (10 mLSTM, 2 sLSTM) in (a), (b) and (d), all 24 in (c).
    (a) A bf16 scoring forward at B=1, S=8192 with the kernel on: 10
    ``mlstm_scan`` launches, a finite loss,
    and the kernel's and the sLSTM layers' shares of the forward; one more
    such forward holds each of its 10 kernel calls against the plain scan
    on the same input with phase 10's per-element bar.  (b) In
    f32, every mLSTM layer's kernel call against the plain scan on the
    same input, and the kernel route's logits against the plain route's,
    beside the model's response to one ulp of noise.  (c)
    ``launch.serve.serve`` at batch 2, a 4608-token prompt and 16
    generated tokens, in bf16.  (d) In f32, prefill + greedy decode logits
    against the forward's, and a decode step's host enqueue against the
    synchronized step.
12. The MoE slice at published widths, seeded weights, the depth cut to
    what one card holds beside the activations.  Phi-3.5-MoE, 24 of 32
    layers (62.9 GB of bf16 weights): (a) a bf16 scoring forward through
    ``make_loss_fn`` at B=1, S=8192 (24 ``flash_attention`` launches, a
    finite loss with the router aux term, each layer's dropped share and
    busiest expert, and where the time goes: attention, expert products,
    routing + dispatch + combine); (c) ``launch.serve.serve`` at batch 2,
    a 4608-token prompt and 16 generated tokens; (b) four layers in f32,
    each layer's MoE call against float64 on the card with the f32 call's
    routing (the tokens whose float64 top-2 differs counted and left out),
    and the kernel route's logits against the plain route's beside the
    response to one ulp of noise (positions whose routing flipped counted
    and left out); (d) two of those layers at capacity factor 8 (the
    reference's no-drop setting), prefill + decode against the forward.
    Mixtral-8x22B, 12 of 56 layers (60.9 GB): (a) and (c), the prompt
    past its 4096 window.
13. The VLM slice: InternVL2-1B whole, 256 seeded patch embeddings (the
    stubbed vision encoder) in front of 7936 tokens.  (a) bf16 forward
    and loss with the visual prefix ignored (24 launches); (b) f32 kernel
    route vs plain route; (c) ``serve`` at batch 2 with patches, a
    4096-token prompt and 16 generated tokens; (d) f32 prefill + decode
    against the forward, offset by the patches.
14. The audio slice: MusicGen-medium whole, B=2 grids of 1500 frames of 4
    codebooks.  (a) bf16 forward and loss (48 launches); (b) f32 kernel
    route vs plain route; (c) ``serve`` at batch 2, a 500-frame prompt
    and 32 generated frames; (d) f32 prefill + decode against the
    forward.
16. Model-zoo training and the layer-wise readout at published widths,
    seeded weights; training takes the plain path (no kernel has a
    backward) and launches no kernel.  (a) H2O-Danube3-4B whole (bf16
    params, f32 moments, remat) through ``launch.train.train``, AdamW(3e-4),
    B=1, S=4096, 6 steps: finite losses whose last two average below the
    first; each step's synchronized ms, tokens/s, peak memory.  (b) One
    Danube layer in f32, one ``make_train_step`` on the card and on a CPU
    copy of the same weights and batch: loss and grad_norm within 1e-5
    relative, every gradient leaf within 1e-4 x max.  (c) Two steps of
    Zamba2-2.7B (one period), xLSTM-350M, Phi-3.5-MoE (2 layers),
    Mixtral-8x22B (1 layer), InternVL2-1B and MusicGen-medium: finite
    losses, every leaf moved.  (d) ``layerwise_backbone_fit`` over the 25
    taps of the frozen whole Danube (kernels on: 24 ``flash_attention``,
    then one ``gram`` a tap), B=2, S=2048, a planted 10-class label; every
    kernel call of (d) held on the same inputs, ``flash_attention`` against
    its plain version and ``gram`` against the float64 Gram;
    the last tap split over M=4 against the centralized readout at K=200
    (printed beside the example's 1e-2, and beside the same two solves in
    float64) and K=1000 (held below a quarter of the K=200 gap); at K=200
    both solves held against an independent float64 consensus within 10x
    the decentralized solve's one-ulp response.  (e)
    ``make_sharded_layer_solver`` on 4 gloo ranks sharing the card against
    the simulated M=4 solve: within 1e-4 x max|z| at mu=1e-6, and within
    10x the simulated solve's one-ulp response at mu=1e-2, where f32
    rounding alone moves z by several 1e-3 x max|z|.  A ``{"zoo_train": ...}``
    line.  (``--zoo-train-only`` builds and runs this phase alone.)
17. The dry-run planners (``launch/dryrun_dssfn.py``, ``launch/dryrun.py``
    over ``launch/cost_analysis.py``, ``launch/specs.py`` and
    ``sharding/rules.py``).  (a) ``repro``'s readout dry run at its
    defaults (n=4096, Q=32, 1048576 tokens, K=100) on the 16x16 plan, both
    schedules, one rank's share solved on the card with a counting
    transport: the collectives the schedule names (ADMM: K all-reduces of
    Q*n*4 bytes and one of K*4; Gram: one of (n+Q)*n*4), FLOPs within 1% of
    the matrix products (the ``gram`` launch credited with 2n^2J through
    the kernels' hook), every ``gram`` launch of the phase held against
    the float64 Gram of its input, the solve's wall time beside its
    compute term.
    (b) The 1x1 plan of 16(a)'s step: params + moments + step within 1% of
    the card's allocation from ``model.init`` to ``opt.init``, the peak
    within 15% of 16(a)'s ``max_memory_allocated``, the FLOPs within 0.1%
    of ``FlopCounterMode``'s count of 16(a)'s first step; the achieved
    TFLOP/s beside the compute term.  (c) ``python -m
    repro_torch.launch.dryrun --shape train_4k`` in a subprocess (it needs
    no card, so it runs on the host beside phase 16): every
    arch OK on the 16x16 plan, its dominant term and peak GB a device
    printed against the card's 80 GB (upper bounds: the plan does not
    split activations under tensor parallelism).  A ``{"dryrun": ...}``
    line.
    (``--dryrun-only`` builds and runs 16(a) and this phase alone.)
18. The model zoo sharded over a (data=2, model=2) grid of 4 gloo ranks
    sharing the card (``launch/mesh.make_host_mesh``,
    ``sharding/parallel.py``), seeded weights drawn by each rank in turn.
    (a) Phi-3.5-MoE at full width, 1 layer, f32, the scoring forward with
    the kernels on (B=2, S=2048): the gathered logits against the same
    layer unsharded on the card within 1e-5 x max, the positions whose
    top-2 routing differs counted and left out; each rank's
    ``flash_attention`` call (its 16 of 32 heads over 4 of 8 KV heads)
    against its plain version; the forward's ms a rank, the transport's
    host ms and of it the wait for the card.  (b) H2O-Danube3-4B at full
    width, 1 layer, f32, one ``make_train_step`` sharded and unsharded
    on the same card and batch (B=2, S=4096): loss and grad_norm within
    1e-5 relative, every gathered gradient leaf within 1e-4 x max, the
    updated params within 2 lr (a first AdamW step moves an element by
    about lr, and a gradient near 0 may take the other sign).  (c)
    ``launch/train.train_grid`` on Danube, 2 bf16 layers with f32 moments,
    3 steps: step ms, tokens/s, peak GB a rank, losses falling, the
    transport's calls and bytes by kind, every sum in f32.  (d) Each of
    (c)'s steps' collectives against ``launch/dryrun.plan_collectives``
    for the 2x2 plan, through ``executor_collectives`` (its stated
    modelling differences): equal kind by kind, calls and bytes.  (e)
    ``launch/serve.py --ranks 4 --model-parallel 2`` on Danube, 2 bf16
    layers, prompt 2048 + 8, against the unsharded launcher: prefill
    logits within 2**-6 x max (four bf16 ulps: a rank rounds its
    row-parallel partial sum before the sum over the row), the greedy
    tokens' agreement and the decode rates printed.  A ``{"sharded": ...}`` line.
    (``--sharded-only`` builds and runs this phase alone.)
19. The examples: each twin of ``examples/*.py`` in ``examples/torch_port/``
    (``main(["--device", "cuda"])``, in this process) at its script's
    defaults (``train_lm`` 200 steps of B=8, S=256), its own asserts, and
    every number it prints that ``repro``'s script printed in the stdout
    stored under ``tests/data/torch_examples_repro/`` held at the bars of
    ``tests/torch_examples_record.py`` (quickstart, gossip_vs_spectral_gap,
    robust_networks, layerwise_readout, serve_decode's dSSFN line, and
    ``train_lm`` once more at its record's 2 steps of B=1, S=32: the
    threefry keys draw ``repro``'s data, matrices and weights); each twin's
    wall time and kernel launches (counters set to 0 before each), the
    dSSFN twins' ``gram``, ``propagate_gram`` and ``matmul_relu`` launches
    checked against their configs, and every one of those calls recorded
    with copies of its inputs and held on them: ``gram`` within 8 f32
    ulps of max|G| of the float64 Gram, ``propagate_gram``'s Y' within
    1e-5 x max|plain| and its G within 8 ulps of the float64 Gram of its
    Y', ``matmul_relu`` within 1e-5 x max|plain| (calls held = launches).
    ``train_lm``'s 200 steps must pass the script's own "improved" (the
    last loss below the first less 0.5).  An ``{"examples": ...}`` line.
    (``--examples-only`` builds and runs this phase alone.)
20. The card line, one ``{"kernels": [...]}`` line, and as the last line
    ``{"ok": true, "device": {...}}``.

It imports no JAX and nothing of the JAX package.  Without CUDA, or
without the repository's ``src/`` beside it, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth,
# f32 on the CUDA cores, bf16 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# TF32 on the tensor cores, the rate the Gram kernels compute f32 at:
# three TF32 products per f32 product (3xTF32).
PEAK_TF32 = 495e12

# Tolerances, as a fraction of max|reference|.  f32: both versions sum
# K <= 3000 products in f32 in different orders, an error of order
# sqrt(K) * 2**-24 of the sum.  bf16: the f32 sums are rounded to bf16
# (8 significant bits), so a sum near a rounding boundary may round one
# ulp (2**-8 relative) either way.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# The full stack: 20 f32 layers of K ~ 1020 against float64 numpy; each
# layer adds an f32 rounding error of order sqrt(K) * 2**-24 ~ 2e-6.
STACK_TOL = 1e-4

# Gram kernels: f32 sums of J products in two orders.  An f32 sum of J
# terms taken in order is off by about sqrt(J) 2**-24 of its size (a
# random walk of roundings), and the library GEMM behind the plain
# version may sum in order.  So the tolerance is 1e-5 x max|plain| up to
# J = 7000 (2 sqrt(7000) 2**-24 = 1.0e-5) and 2 sqrt(J) 2**-24 x
# max|plain| above: 2.9e-5 at J = 60000, the centralized layer.
def gram_tol(j: int) -> float:
    return max(1e-5, 2.0 * j**0.5 * 2.0**-24)


SLICE = {"P": 784, "Q": 10, "L": 20}          # Table-I MNIST, paper §III-B
SLICE_BUCKETS = (1, 8, 32, 128)
SLICE_REQUESTS = 64
HEADLINE = ((1020, 1020), 32, "float32")       # the stream's batch shape


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def roofline(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """Least time (ms): ``nbytes`` at HBM rate or ``ops`` at the peak rate
    of the operands' type, whichever is larger, and which one it is."""
    t_bytes, t_ops = bound_parts(ops, nbytes, dtype)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_parts(ops: float, nbytes: float, dtype: str) -> tuple[float, float]:
    """(ms for ``nbytes`` at HBM rate, ms for ``ops`` at the peak rate of
    the operands' type): the two sides of ``roofline``."""
    return nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3


def elem_bytes(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def matmul_work(m: int, k: int, n: int, dtype: str) -> tuple[float, float]:
    """relu(W @ X): 2mnk operations; each operand read once, the output
    written once."""
    return 2.0 * m * n * k, (m * k + k * n + m * n) * elem_bytes(dtype)


def bound(m: int, k: int, n: int, dtype: str) -> tuple[float, str]:
    return roofline(*matmul_work(m, k, n, dtype), dtype)


def gram_ops(m: int, n: int, j: int) -> float:
    """A symmetric Gram: n(n+1)J operations per worker."""
    return float(n) * (n + 1) * j * m


def gram_bytes(m: int, n: int, j: int, dtype: str) -> float:
    """Y read once, the f32 G written once."""
    return m * n * j * elem_bytes(dtype) + m * n * n * 4


def propagate_ops(n: int, n_prev: int, m: int, j: int) -> tuple[float, float]:
    """(propagation, Gram) operations of propagate_gram: 2 n n_prev J M and
    n(n+1) J M."""
    return 2.0 * n * n_prev * j * m, gram_ops(m, n, j)


def propagate_bytes(n: int, n_prev: int, m: int, j: int, dtype: str) -> float:
    """W and Y read once, Y' and the f32 G written once."""
    return (n * n_prev + m * n_prev * j + m * n * j) * elem_bytes(dtype) + m * n * n * 4


def gram_bound(m: int, n: int, j: int, dtype: str) -> tuple[float, str]:
    """G = Y Y^T + I/mu for M workers at the f32 CUDA-core peak."""
    return roofline(gram_ops(m, n, j), gram_bytes(m, n, j, dtype), dtype)


def propagate_bound(n: int, n_prev: int, m: int, j: int, dtype: str) -> tuple[float, str]:
    """Y' = relu(W @ Y_m), G = Y' Y'^T + I/mu at the f32 CUDA-core peak."""
    return roofline(sum(propagate_ops(n, n_prev, m, j)), propagate_bytes(n, n_prev, m, j, dtype),
                    dtype)


def tensor_core_s(ops: float, dtype: str) -> float:
    """Seconds for ``ops`` operations on ``dtype`` operands on the tensor
    cores: f32 as three TF32 products each (3xTF32) at the TF32 peak,
    bf16 at the bf16 peak."""
    return 3 * ops / PEAK_TF32 if dtype == "float32" else ops / PEAK_FLOPS[dtype]


def tensor_core_bound(t_ops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms): ``t_ops`` seconds of tensor-core work or ``nbytes``
    at HBM rate, whichever is larger, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gram_tensor_core_bound(m: int, n: int, j: int, dtype: str) -> tuple[float, str]:
    """gram_bound's work on the tensor cores (3xTF32 for f32)."""
    return tensor_core_bound(tensor_core_s(gram_ops(m, n, j), dtype), gram_bytes(m, n, j, dtype))


def propagate_tensor_core_bound(n: int, n_prev: int, m: int, j: int,
                                dtype: str) -> tuple[float, str]:
    """propagate_bound's work on the tensor cores: the propagation in
    ``dtype``, the Gram of the f32 Y' in 3xTF32."""
    prop, gram = propagate_ops(n, n_prev, m, j)
    return tensor_core_bound(tensor_core_s(prop, dtype) + tensor_core_s(gram, "float32"),
                             propagate_bytes(n, n_prev, m, j, dtype))


def time_ms(torch, fn, ws, x, iters: int = 60) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    timed with CUDA events around its replay, so the host's launch cost
    is left out.  The calls cycle through ``ws``, copies of W that
    together exceed the 50 MB L2, so each call finds its W in HBM, as a
    layer of the served stack does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for i in range(3):
            fn(ws[i % len(ws)], x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(ws[i % len(ws)], x)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(torch, np):
    from repro_torch.kernels.matmul_relu import matmul_relu_cuda, matmul_relu_ref

    p, q = SLICE["P"], SLICE["Q"]
    n = 2 * q + 1000
    shapes = [((n, p), b) for b in SLICE_BUCKETS] + [((n, n), b) for b in SLICE_BUCKETS]
    shapes.append(((1204, 3000), 77))
    rng = np.random.default_rng(1)
    cases = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for (m, k), cols in shapes:
            w = torch.from_numpy(
                (rng.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
            ).to("cuda", dtype)
            x = torch.from_numpy(
                rng.standard_normal((k, cols)).astype(np.float32)
            ).to("cuda", dtype)
            out = matmul_relu_cuda(w, x)
            ref = matmul_relu_ref(w, x)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"matmul_relu {m}x{k}x{cols}: {out.shape} {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = KERNEL_TOL[dtype_name] * scale
            if not err <= tol:
                raise AssertionError(
                    f"matmul_relu w({m},{k}) x({k},{cols}) {dtype_name}: "
                    f"max|kernel - plain| = {err:.3e} > {tol:.3e}"
                )
            copies = max(1, -(-100_000_000 // (w.numel() * w.element_size())))
            ws = [w.clone() for _ in range(copies)]
            kernel_ms = time_ms(torch, matmul_relu_cuda, ws, x)
            plain_ms = time_ms(torch, matmul_relu_ref, ws, x)
            library_ms = time_ms(torch, lambda a, b: torch.relu(torch.matmul(a, b)), ws, x)
            bound_ms, bound_by = bound(m, k, cols, dtype_name)
            bytes_ms, ops_ms = bound_parts(*matmul_work(m, k, cols, dtype_name), dtype_name)
            del ws
            case = {
                "shape": f"w({m},{k}) x({k},{cols}) {dtype_name}",
                "key": ((m, k), cols, dtype_name),
                "max_abs_err": err,
                "tolerance": tol,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "bytes_ms": bytes_ms,
                "ops_ms": ops_ms,
            }
            rate = "f32 CUDA-core" if dtype_name == "float32" else "bf16 tensor-core"
            print(
                f"matmul_relu {case['shape']}: err {err:.3e} (tol {tol:.3e}) "
                f"kernel {kernel_ms * 1e3:.2f} us plain {plain_ms * 1e3:.2f} us "
                f"library {library_ms * 1e3:.2f} us bound {bound_ms * 1e3:.2f} us "
                f"({bound_by}; bytes {bytes_ms * 1e3:.2f} us, operations {ops_ms * 1e3:.2f} us "
                f"at the {rate} peak)",
                flush=True,
            )
            cases.append(case)
    return cases


# (M, n, J, dtype) of the gram launches: the train's layer 0, decentralized
# (M=20 workers of 3000) and centralized (one of 60000), ragged edges, and
# phase 16's readout of Danube's 3840-wide taps: one tap of J=4096 tokens,
# split over M=4 workers, and one rank's worker of 16(e); phase 17(a)'s
# readout dry run: one rank's share (n=4096, J=4096) of 1048576 tokens
# over 256 ranks.
GRAM_CASES = [(20, 784, 3000, "float32"), (1, 784, 60000, "float32"),
              (3, 33, 65, "float32"), (3, 33, 65, "bfloat16"),
              (1, 3840, 4096, "float32"), (4, 3840, 1024, "float32"),
              (1, 3840, 1024, "float32"), (1, 4096, 4096, "float32")]
# (n, n_prev, M, J, dtype) of the propagate_gram launches: layer 1 (W is
# 1020 x 784) and layers l >= 2 (1020 x 1020), decentralized and
# centralized, and ragged edges.
PROPAGATE_CASES = [(1020, 784, 20, 3000, "float32"), (1020, 1020, 20, 3000, "float32"),
                   (1020, 784, 1, 60000, "float32"), (1020, 1020, 1, 60000, "float32"),
                   (33, 257, 3, 65, "float32"), (33, 257, 3, 65, "bfloat16")]
GRAM_HEADLINE = (20, 784, 3000, "float32")
# gram cases also held against a float64 Gram, within GRAM_F64_ULPS f32
# ulps of max|G| (the bar of test_gram_sums_are_compensated; a 1xTF32 Gram
# misses it): the headline, the centralized layer and the readouts' shapes.
GRAM_F64_CASES = [(20, 784, 3000, "float32"), (1, 784, 60000, "float32"),
                  (1, 3840, 4096, "float32"), (4, 3840, 1024, "float32"),
                  (1, 3840, 1024, "float32"), (1, 4096, 4096, "float32")]
GRAM_F64_ULPS = 8
PROPAGATE_HEADLINE = (1020, 1020, 20, 3000, "float32")
GRAM_MU = 1e-3      # SSFNConfig.mu0, the layer-0 mu
PROPAGATE_MU = 1.0  # SSFNConfig.mul


def max_err(got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def gram_kernel_cases(torch):
    """gram and propagate_gram at the training slice's shapes, each held
    against its plain version and timed beside it, beside one library
    call of the same function and beside two bounds: at the f32 CUDA-core
    peak (``f32_bound_ms``, as before the kernels took the tensor cores)
    and at the TF32 rate they compute at (``bound_ms``).  The headline and
    centralized ``gram`` are also held against a float64 Gram (``ulps``,
    in f32 ulps of max|G|)."""
    from repro_torch.kernels.gram import gram_cuda, gram_ref
    from repro_torch.kernels.propagate_gram import propagate_gram_cuda, propagate_gram_ref

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(2)

    def normal(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtypes[dtype])

    def diag(n, mu, dtype):
        return (torch.eye(n, device="cuda") / mu).to(dtype)

    gram_cases, prop_cases = [], []
    for m, n, j, dt in GRAM_CASES:
        y = normal((m, n, j), 1.0, dt)
        got, want = gram_cuda(y, mu=GRAM_MU), gram_ref(y, mu=GRAM_MU)
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        tol = gram_tol(j) * scale
        if got.shape != (m, n, n) or not err <= tol or not torch.equal(got, got.mT):
            raise AssertionError(
                f"gram y({m},{n},{j}) {dt}: max|kernel - plain| = {err:.3e} > "
                f"{tol:.3e}, or G not exactly symmetric"
            )
        ulps = None
        if (m, n, j, dt) in GRAM_F64_CASES:
            y64 = y.double()
            want64 = y64 @ y64.mT + torch.eye(n, dtype=torch.float64, device="cuda") / GRAM_MU
            ulps = ((got.double() - want64).abs().max()
                    / (2.0**-24 * want64.abs().max())).item()
            del y64, want64
            if not ulps <= GRAM_F64_ULPS:
                raise AssertionError(
                    f"gram y({m},{n},{j}) {dt}: {ulps:.2f} f32 ulps of max|G| from a "
                    f"float64 Gram > {GRAM_F64_ULPS}"
                )
        d = diag(n, GRAM_MU, y.dtype)
        iters = 10 if m * n * j > 1e7 else 60
        ms = time_ms(torch, lambda _w, a: gram_cuda(a, mu=GRAM_MU), [None], y, iters)
        plain_ms = time_ms(torch, lambda _w, a: gram_ref(a, mu=GRAM_MU), [None], y, iters)
        library_ms = time_ms(torch, lambda _w, a: torch.baddbmm(d, a, a.mT), [None], y, iters)
        f32_bound_ms, _ = gram_bound(m, n, j, dt)
        bound_ms, bound_by = gram_tensor_core_bound(m, n, j, dt)
        gram_cases.append({
            "shape": f"y({m},{n},{j}) {dt}", "key": (m, n, j, dt),
            "max_abs_err": err, "tolerance": tol, "ulps": ulps, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "tflops": gram_ops(m, n, j) / ms / 1e9, "bound_ms": bound_ms,
            "bound_by": bound_by, "f32_bound_ms": f32_bound_ms,
        })
        del y, got, want
    for n, n_prev, m, j, dt in PROPAGATE_CASES:
        w = normal((n, n_prev), n_prev**-0.5, dt)
        y = torch.relu(normal((m, n_prev, j), 1.0, dt))
        (y_new, g), (want_y, want_g) = (
            propagate_gram_cuda(w, y, mu=PROPAGATE_MU),
            propagate_gram_ref(w, y, mu=PROPAGATE_MU),
        )
        torch.cuda.synchronize()
        err_y, scale_y = max_err(y_new, want_y)
        err_g, scale_g = max_err(g, want_g)
        tol_y = KERNEL_TOL[dt] * scale_y
        tol_g = gram_tol(j) * scale_g   # G is built from the f32 Y' in both
        if not (err_y <= tol_y and err_g <= tol_g and torch.equal(g, g.mT)):
            raise AssertionError(
                f"propagate_gram w({n},{n_prev}) y({m},{n_prev},{j}) {dt}: "
                f"Y' err {err_y:.3e} (tol {tol_y:.3e}), G err {err_g:.3e} "
                f"(tol {tol_g:.3e}), or G not exactly symmetric"
            )
        d = diag(n, PROPAGATE_MU, y.dtype)

        def library(ww, yy, d=d):
            yn = torch.relu(torch.matmul(ww, yy))
            return torch.baddbmm(d, yn, yn.mT)

        iters = 10 if m * n * j > 1e7 else 60
        ms = time_ms(torch, lambda ww, yy: propagate_gram_cuda(ww, yy, mu=PROPAGATE_MU), [w], y, iters)
        plain_ms = time_ms(torch, lambda ww, yy: propagate_gram_ref(ww, yy, mu=PROPAGATE_MU), [w], y, iters)
        library_ms = time_ms(torch, library, [w], y, iters)
        f32_bound_ms, _ = propagate_bound(n, n_prev, m, j, dt)
        bound_ms, bound_by = propagate_tensor_core_bound(n, n_prev, m, j, dt)
        prop_cases.append({
            "shape": f"w({n},{n_prev}) y({m},{n_prev},{j}) {dt}", "key": (n, n_prev, m, j, dt),
            "max_abs_err": max(err_y, err_g), "max_abs_err_y": err_y, "max_abs_err_g": err_g,
            "tolerance": tol_g, "ulps": None, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "tflops": sum(propagate_ops(n, n_prev, m, j)) / ms / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by, "f32_bound_ms": f32_bound_ms,
        })
        del w, y, y_new, g, want_y, want_g
    for name, cases in (("gram", gram_cases), ("propagate_gram", prop_cases)):
        for c in cases:
            ulps = "" if c["ulps"] is None else f", {c['ulps']:.2f} ulps of max|G| from float64"
            print(
                f"{name} {c['shape']}: err {c['max_abs_err']:.3e} (tol {c['tolerance']:.3e}"
                f"{ulps}) kernel {c['ms']:.3f} ms = {c['tflops']:.1f} TFLOP/s, plain "
                f"{c['plain_ms']:.3f} ms, library {c['library_ms']:.3f} ms, bound "
                f"{c['f32_bound_ms']:.3f} ms at the f32 CUDA-core peak, {c['bound_ms']:.3f} ms "
                f"at the tensor-core peak ({c['bound_by']})",
                flush=True,
            )
    return gram_cases, prop_cases


def random_stack(np, seed: int = 0):
    """Untrained Table-I stack: R_l and O_l ~ N(0, 1) / sqrt(fan_in), as
    ``repro``'s ``init_random_matrices`` scales R."""
    p, q, layers = SLICE["P"], SLICE["Q"], SLICE["L"]
    n = 2 * q + 1000
    rng = np.random.default_rng(seed)

    def draw(rows, fan_in):
        return (rng.standard_normal((rows, fan_in)) / np.sqrt(fan_in)).astype(np.float32)

    o_list = [draw(q, p)] + [draw(q, n) for _ in range(layers)]
    r_list = [draw(n - 2 * q, p if l == 0 else n) for l in range(layers)]
    return o_list, r_list


def forward_f64(np, o_list, r_list, x):
    y = x.astype(np.float64)
    for o, r in zip(o_list[:-1], r_list):
        w = np.concatenate([o, -o, r]).astype(np.float64)
        y = np.maximum(w @ y, 0.0)
    return o_list[-1].astype(np.float64) @ y


def forward_breakdown(torch, engine, bucket: int, reps: int = 20) -> dict:
    """Where one served forward's time goes at ``bucket``: the host clock
    around ``engine.forward`` + synchronize (what a batch waits), against
    the device time of the same forward replayed as a CUDA graph (its
    kernels alone).  The gap is the host's launch and Python cost."""
    x = torch.randn(engine.artifact.input_dim, bucket, device="cuda")
    engine.forward(x)
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.forward(x)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host.sort()
    device_ms = time_ms(torch, lambda _w, xx: engine.forward(xx), [None], x, iters=reps)
    return {"bucket": bucket, "host_ms_p50": host[len(host) // 2],
            "device_ms": device_ms}


def serve_slice(torch, np, card: str) -> tuple[int, dict]:
    """Serve the full-width stack; returns the main path's launch count
    and the launcher's result."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import ssfn
    from repro_torch.kernels.matmul_relu import launch_count, reset_launch_count
    from repro_torch.launch import serve_dssfn
    from repro_torch.serve import ServeEngine, export_artifact, load_artifact

    o_list, r_list = random_stack(np)
    q, layers = SLICE["Q"], SLICE["L"]
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "stack")
        export_artifact(path, params_from_numpy(o_list, r_list, device="cpu"))
        logits_path = os.path.join(tmp, "logits.npz")

        reset_launch_count()
        res = serve_dssfn.main([
            "--artifact", path, "--requests", str(SLICE_REQUESTS),
            "--request-size", "1",
            "--batch-bucket", ",".join(map(str, SLICE_BUCKETS)),
            "--max-batch", "32", "--max-wait-us", "200", "--seed", "0",
            "--save-logits", logits_path,
        ])
        main_path_launches = launch_count()

        if res["device"] != "cuda" or res["completed"] != SLICE_REQUESTS:
            raise AssertionError(f"served {res['completed']} of {SLICE_REQUESTS} on {res['device']}")
        if res["kernel_launches"] != layers * res["batches"]:
            raise AssertionError(
                f"kernel_launches {res['kernel_launches']} != {layers} x "
                f"{res['batches']} batches"
            )
        if main_path_launches == 0 or main_path_launches < res["kernel_launches"]:
            raise AssertionError(
                f"main path counted {main_path_launches} matmul_relu launches"
            )
        with np.load(logits_path) as z:
            x, logits = z["requests"], z["logits"]
        ref = forward_f64(np, o_list, r_list, x)
        err = float(np.abs(logits - ref).max())
        scale = float(np.abs(ref).max())
        if logits.shape != (q, SLICE_REQUESTS) or not np.isfinite(logits).all():
            raise AssertionError(f"logits shape {logits.shape} or non-finite")
        if not err <= STACK_TOL * scale:
            raise AssertionError(
                f"served logits vs float64: {err:.3e} > {STACK_TOL} x {scale:.3e}"
            )
        print(f"slice logits vs float64 numpy: max abs err {err:.3e} "
              f"(max|ref| {scale:.3e}, tol {STACK_TOL} x max|ref|)", flush=True)

        # Within one bucket the engine is the training-time predict, bit
        # for bit, and padding cannot perturb the real columns.
        engine = ServeEngine(load_artifact(path), buckets=(32,))
        xb = torch.from_numpy(x[:, :32].copy())
        out = engine.forward(xb)
        pred = ssfn.predict(
            params_from_numpy(o_list, r_list, device="cuda"), xb.cuda(), q
        )
        padded = engine.forward(xb[:, :5])
        torch.cuda.synchronize()
        if not torch.equal(out, pred):
            raise AssertionError("ServeEngine.forward != ssfn.predict within bucket 32")
        if not torch.equal(padded, out[:, :5]):
            raise AssertionError("padded forward differs from the full bucket")
        print("ServeEngine.forward == ssfn.predict bit for bit (bucket 32, "
              "padded and full)", flush=True)

        engine = ServeEngine(load_artifact(path), buckets=(1, 128))
        for bucket in (1, 128):
            fb = forward_breakdown(torch, engine, bucket)
            print(
                f"forward bucket {bucket}: host {fb['host_ms_p50']:.3f} ms "
                f"(p50, synchronized), device {fb['device_ms']:.3f} ms "
                f"(CUDA graph replay), {layers} kernel launches",
                flush=True,
            )

    lat = res["latency_ms"]
    print(
        f"slice P={SLICE['P']} Q={q} n={2 * q + 1000} L={layers}: "
        f"{SLICE_REQUESTS} requests in {res['batches']} batches, "
        f"p50 {lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms, "
        f"{res['throughput_samples_per_s']:.0f} samples/s, "
        f"kernel_launches {res['kernel_launches']} on {card}",
        flush=True,
    )
    return main_path_launches, res


# Phase 4b: the hardened runtime.  The seeded drill is ``repro``'s
# ``tests/test_serve_runtime.py::test_chaos_drill_end_to_end`` (400
# requests, a NaN in every 25th, 0.5 ms of virtual time a request, a tick
# every 4), here on 784-row requests.
RUNTIME_REQUESTS = 512
RUNTIME_THREADS = 4
RUNTIME_JOIN_S = 120.0
DRILL_REQUESTS = 400
DRILL_CHAOS = "fail=0.25:burst=4:seed=7"
DRILL_RUNTIME = dict(
    max_batch=32, max_pending_samples=32, default_deadline_s=0.02,
    max_retries=1, backoff_base_s=1e-3, breaker_threshold=2,
    breaker_cooldown_s=0.05, drain_timeout_s=10.0,
)
OVERHEAD_REPS = 30
RUNTIME_STREAMS = 3      # more wall-clock streams like (a), instrumented


def chaos_drill(np, serve, engine):
    """The seeded ManualClock drill through ``engine``; returns the
    runtime, the injector and the (request, handle) pairs."""
    clock = serve.ManualClock()
    chaos = serve.parse_chaos(DRILL_CHAOS)
    rt = serve.ServeRuntime(engine, clock=clock, chaos=chaos, **DRILL_RUNTIME).start()
    rng = np.random.default_rng(11)
    entries = []
    for i in range(DRILL_REQUESTS):
        x = rng.standard_normal((SLICE["P"], 1)).astype(np.float32)
        if i % 25 == 12:
            x[0, 0] = np.nan
        entries.append((x, rt.submit(x)))
        clock.advance(5e-4)
        if (i + 1) % 4 == 0:
            rt.tick()
    rt.drain()
    return rt, chaos, entries


def recording_engine(serve, launch_count):
    """A ``ServeEngine`` that records, for each forward, its start on the
    monotonic clock (``WallClock``'s) and the kernel launches it made."""

    class RecordingEngine(serve.ServeEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.calls: list[tuple[float, int]] = []

        def forward(self, x):
            start, before = time.monotonic(), launch_count()
            out = super().forward(x)
            self.calls.append((start, launch_count() - before))
            return out

    return RecordingEngine


class TimedLock:
    """Stands in for a runtime's lock and times each acquire that
    ``thread`` makes (the submitter's wait for the timer's flush)."""

    def __init__(self, lock, thread):
        self._lock, self._thread, self.waits = lock, thread, []

    def __enter__(self):
        t0 = time.perf_counter()
        self._lock.acquire()
        if threading.current_thread() is self._thread:
            self.waits.append(time.perf_counter() - t0)
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


def pct(vals, p):
    """The launcher's percentile: the sorted value at rank p% (ms)."""
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(p / 100 * (len(vals) - 1))))] * 1e3


def runtime_stream(torch, np, serve, engine, seed: int) -> dict:
    """One stream of (a)'s shape straight through ``ServeRuntime``: where
    each request's time goes.  Per submit, the wait for the runtime's
    lock and the whole call; per completed request, the wait from
    arrival to its batch's forward and the forward to completion."""
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal((SLICE["P"], 1)).astype(np.float32))
          for _ in range(RUNTIME_REQUESTS)]
    rt = serve.ServeRuntime(engine, max_batch=32, flush_interval_s=200e-6)
    lock = rt._lock = TimedLock(rt._lock, threading.current_thread())
    rt.start()
    engine.calls.clear()
    submit_s, handles = [], []
    t0 = time.perf_counter()
    for x in xs:
        t1 = time.perf_counter()
        handles.append(rt.submit(x))
        submit_s.append(time.perf_counter() - t1)
        rt.clock.sleep(100e-6)
    rt.drain()
    wall = time.perf_counter() - t0
    if not all(h.ok() for h in handles) or rt.stats["breaker_opens"]:
        raise AssertionError(f"(a) stream {seed}: {rt.snapshot()['stats']}")
    starts = sorted(t for t, _ in engine.calls)
    queue_s, service_s = [], []
    for h in handles:
        start = max(t for t in starts if t <= h.completed_at)
        queue_s.append(start - h.submitted_at)
        service_s.append(h.completed_at - start)
    s = rt.stats
    return {
        "p50_ms": pct([h.latency_s for h in handles], 50),
        "p99_ms": pct([h.latency_s for h in handles], 99),
        "throughput_samples_per_s": len(handles) / wall, "wall_s": wall,
        "batches": s["batches"], "mean_batch": s["batch_samples"] / s["batches"],
        "lock_wait_ms_p50": pct(lock.waits, 50), "lock_wait_ms_p99": pct(lock.waits, 99),
        "lock_wait_share": sum(lock.waits) / wall,
        "submit_ms_p50": pct(submit_s, 50), "submit_share": sum(submit_s) / wall,
        "queue_ms_p50": pct(queue_s, 50), "service_ms_p50": pct(service_s, 50),
        "kernel_launches": sum(n for _, n in engine.calls),
    }


def runtime_overhead(torch, np, serve, engine) -> dict:
    """The runtime's host cost per batch on the card: the host clock
    around 32 single-sample submits (the last one flushes: validation,
    packing, the host concat, one copy to the card, the forward, one
    synchronize, the scatter) against the same 32 columns concatenated
    and forwarded directly and synchronized; medians, in turns."""
    rng = np.random.default_rng(31)
    cols = [rng.standard_normal((SLICE["P"], 1)).astype(np.float32) for _ in range(32)]
    rt = serve.ServeRuntime(engine, clock=serve.ManualClock(), max_batch=32).start()
    t_rt, t_fw = [], []
    for _ in range(OVERHEAD_REPS):
        t0 = time.perf_counter()
        handles = [rt.submit(c) for c in cols]
        t_rt.append((time.perf_counter() - t0) * 1e3)
        if not all(h.ok() for h in handles):
            raise AssertionError("overhead batch not served")
        t0 = time.perf_counter()
        engine.forward(np.concatenate(cols, axis=1))
        torch.cuda.synchronize()
        t_fw.append((time.perf_counter() - t0) * 1e3)
    rt.drain()
    t_rt.sort()
    t_fw.sort()
    mid = OVERHEAD_REPS // 2
    return {"runtime_batch_ms_p50": t_rt[mid], "forward_ms_p50": t_fw[mid],
            "host_cost_ms": t_rt[mid] - t_fw[mid]}


def runtime_slice(torch, np, card: str, micro: dict) -> int:
    """Phase 4b: the full-width stack served through ``ServeRuntime`` in
    four drills; returns their ``matmul_relu`` launches."""
    import repro_torch.serve as serve
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels.matmul_relu import launch_count, reset_launch_count
    from repro_torch.launch import serve_dssfn

    o_list, r_list = random_stack(np)
    p, q, layers = SLICE["P"], SLICE["Q"], SLICE["L"]
    report = {"card": card}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "stack")
        serve.export_artifact(path, params_from_numpy(o_list, r_list, device="cpu"))

        # (a) A healthy wall-clock stream through the launcher.
        logits_path = os.path.join(tmp, "runtime_logits.npz")
        reset_launch_count()
        res = serve_dssfn.main([
            "--artifact", path, "--runtime", "--requests", str(RUNTIME_REQUESTS),
            "--request-size", "1", "--batch-bucket", ",".join(map(str, SLICE_BUCKETS)),
            "--max-batch", "32", "--flush-every-us", "200", "--arrival-us", "100",
            "--seed", "0", "--save-logits", logits_path,
        ])
        launches_a = launch_count()
        s = res["snapshot"]["stats"]
        if (res["device"] != "cuda" or res["completed"] != RUNTIME_REQUESTS
                or res["failed"] or res["rejected"] or res["expired"]):
            raise AssertionError(
                f"(a) on {res['device']}: {res['completed']} completed, {res['failed']} "
                f"failed, {res['rejected']} rejected, {res['expired']} expired"
            )
        if s["breaker_opens"] or res["degraded_reasons"]:
            raise AssertionError(
                f"(a) the healthy stream opened the breaker: {s['breaker_opens']} "
                f"opens, degraded {res['degraded_reasons']}"
            )
        # The launcher's warmup runs each bucket up to --max-batch once.
        warmup = layers * sum(b <= 32 for b in SLICE_BUCKETS)
        if (res["kernel_launches"] != layers * s["batches"]
                or launches_a != res["kernel_launches"] + warmup):
            raise AssertionError(
                f"(a) {res['kernel_launches']} launches ({launches_a} counted) for "
                f"{s['batches']} batches of {layers} layers"
            )
        with np.load(logits_path) as z:
            x, logits = z["requests"], z["logits"]
        ref = forward_f64(np, o_list, r_list, x)
        err_a = float(np.abs(logits - ref).max())
        scale = float(np.abs(ref).max())
        if logits.shape != (q, RUNTIME_REQUESTS) or not err_a <= STACK_TOL * scale:
            raise AssertionError(f"(a) logits {logits.shape} vs float64: {err_a:.3e}")
        lat = res["latency_ms"]
        report["a"] = {
            "completed": res["completed"], "batches": s["batches"],
            "mean_batch": s["batch_samples"] / s["batches"],
            "p50_ms": lat["p50"], "p99_ms": lat["p99"], "wall_s": res["wall_time_s"],
            "throughput_samples_per_s": res["completed"] / res["wall_time_s"],
            "kernel_launches": res["kernel_launches"], "max_abs_err": err_a,
            "micro_batcher": {"p50_ms": micro["latency_ms"]["p50"],
                              "p99_ms": micro["latency_ms"]["p99"],
                              "throughput_samples_per_s": micro["throughput_samples_per_s"],
                              "mean_batch": micro["mean_batch_size"]},
        }
        print(
            f"4b(a) runtime, wall clock: {RUNTIME_REQUESTS} requests, {s['batches']} "
            f"batches (mean {report['a']['mean_batch']:.2f}), p50 {lat['p50']:.3f} ms "
            f"p99 {lat['p99']:.3f} ms, {report['a']['throughput_samples_per_s']:.0f} "
            f"samples/s; phase 4 MicroBatcher p50 {micro['latency_ms']['p50']:.3f} ms "
            f"p99 {micro['latency_ms']['p99']:.3f} ms, "
            f"{micro['throughput_samples_per_s']:.0f} samples/s (mean "
            f"{micro['mean_batch_size']:.2f}); logits vs float64 {err_a:.3e}",
            flush=True,
        )
        engine = recording_engine(serve, launch_count)(
            serve.load_artifact(path), buckets=SLICE_BUCKETS)
        for b in SLICE_BUCKETS:
            if b <= 32:
                engine.forward(np.zeros((p, b), np.float32))
        torch.cuda.synchronize()
        reset_launch_count()
        streams = [runtime_stream(torch, np, serve, engine, seed=100 + k)
                   for k in range(RUNTIME_STREAMS)]
        launches_s = launch_count()
        if launches_s != sum(st["kernel_launches"] for st in streams) or any(
                st["kernel_launches"] != layers * st["batches"] for st in streams):
            raise AssertionError(f"(a) streams: {launches_s} launches for {streams}")
        report["a"]["streams"] = streams
        for k, st in enumerate(streams):
            print(
                f"4b(a) stream {k}: p50 {st['p50_ms']:.3f} ms p99 {st['p99_ms']:.3f} ms, "
                f"{st['throughput_samples_per_s']:.0f} samples/s, mean batch "
                f"{st['mean_batch']:.2f}; per submit: lock wait p50 "
                f"{st['lock_wait_ms_p50']:.3f} ms p99 {st['lock_wait_ms_p99']:.3f} ms "
                f"({100 * st['lock_wait_share']:.1f}% of the stream), call p50 "
                f"{st['submit_ms_p50']:.3f} ms ({100 * st['submit_share']:.1f}%); "
                f"per request: arrival to forward p50 {st['queue_ms_p50']:.3f} ms, "
                f"forward to done p50 {st['service_ms_p50']:.3f} ms",
                flush=True,
            )

        # (b) Four submitter threads race the timer thread, bucket 32.
        engine = serve.ServeEngine(serve.load_artifact(path), buckets=(32,))
        engine.forward(np.zeros((p, 32), np.float32))
        torch.cuda.synchronize()
        rng = np.random.default_rng(21)
        xs = [rng.standard_normal((p, 1)).astype(np.float32) for _ in range(RUNTIME_REQUESTS)]
        handles = [None] * len(xs)
        rt = serve.ServeRuntime(engine, max_batch=32, max_pending_samples=4096,
                                max_pending_requests=4096, flush_interval_s=200e-6).start()

        def submitter(first):
            for i in range(first, len(xs), RUNTIME_THREADS):
                handles[i] = rt.submit(xs[i])

        threads = [threading.Thread(target=submitter, args=(k,)) for k in range(RUNTIME_THREADS)]
        reset_launch_count()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=RUNTIME_JOIN_S)
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"(b) a submitter thread outlived {RUNTIME_JOIN_S} s")
        rt.drain()
        wall_b = time.perf_counter() - t0
        launches_b = launch_count()
        sb = rt.snapshot()["stats"]
        if rt._timer is not None or not all(h is not None and h.done() for h in handles):
            raise AssertionError("(b) a handle or the timer thread was left behind")
        if sb["completed"] != len(xs) or launches_b != layers * sb["batches"]:
            raise AssertionError(
                f"(b) {sb['completed']} completed, {launches_b} launches for "
                f"{sb['batches']} batches"
            )
        for x, h in zip(xs, handles):
            if not torch.equal(h.result(), engine.forward(x)):
                raise AssertionError("(b) a raced result differs from its own forward")
        report["b"] = {"completed": sb["completed"], "batches": sb["batches"],
                       "mean_batch": sb["batch_samples"] / sb["batches"],
                       "wall_s": wall_b, "kernel_launches": launches_b}
        print(f"4b(b) {RUNTIME_THREADS} threads x {len(xs) // RUNTIME_THREADS} requests vs "
              f"the timer: {sb['completed']} completed in {sb['batches']} batches, "
              f"{wall_b:.3f} s, each bit-equal to its own forward", flush=True)

        # (c) The seeded ManualClock chaos drill: the port's CPU run sets
        # the expected stats and events, then the card runs it.  The CPU
        # run records repro's degrade events; the card's route stays the
        # kernel, so its events are the CPU's without them.
        cpu_rt, cpu_chaos, cpu_entries = chaos_drill(
            np, serve, serve.ServeEngine(serve.load_artifact(path), buckets=(32,), device="cpu"))
        engine = recording_engine(serve, launch_count)(serve.load_artifact(path), buckets=(32,))
        engine.forward(np.zeros((p, 32), np.float32))
        torch.cuda.synchronize()
        engine.calls.clear()
        reset_launch_count()
        rt, chaos, entries = chaos_drill(np, serve, engine)
        launches_c = launch_count()
        sc = rt.snapshot()["stats"]
        kinds = [e["kind"] for e in rt.events]
        cpu_kinds = [e["kind"] for e in cpu_rt.events]
        if sc != cpu_rt.snapshot()["stats"] or kinds != [k for k in cpu_kinds if k != "degrade"]:
            raise AssertionError(
                f"(c) card drill differs from the CPU drill: {sc} vs "
                f"{cpu_rt.snapshot()['stats']}, events {kinds} vs {cpu_kinds}"
            )
        if ([(h.status, h.error) for _, h in entries]
                != [(h.status, h.error) for _, h in cpu_entries]
                or chaos.injected_failures != cpu_chaos.injected_failures):
            raise AssertionError("(c) per-handle outcomes or injected faults differ from the CPU")
        if (sc["breaker_opens"] < 1 or rt.degraded_reasons
                or "kernels-disabled" not in cpu_rt.degraded_reasons):
            raise AssertionError(
                f"(c) {sc['breaker_opens']} opens; degraded {rt.degraded_reasons} on the "
                f"card, {cpu_rt.degraded_reasons} on the CPU"
            )
        if (len(engine.calls) != sc["batches"]
                or any(n != layers for _, n in engine.calls)
                or launches_c != layers * sc["batches"]):
            raise AssertionError(
                f"(c) {launches_c} launches in {len(engine.calls)} forwards for "
                f"{sc['batches']} batches of {layers} layers"
            )
        first_open = next(e["t"] for e in rt.events
                          if e["kind"] == "breaker" and "-> open" in e["detail"])
        ref_engine = serve.ServeEngine(serve.load_artifact(path), buckets=(32,))
        done = [(x, h) for x, h in entries if h.ok()]
        for x, h in done:
            if not torch.equal(h.result(), ref_engine.forward(x)):
                raise AssertionError("(c) a completed handle differs from its own forward")
        n_after = sum(h.completed_at > first_open for _, h in done)
        if n_after == 0:
            raise AssertionError("(c) no result was served after the first open")
        xc = np.concatenate([x for x, _ in done], axis=1)
        got = torch.cat([h.result() for _, h in done], dim=1).float().cpu().numpy()
        ref = forward_f64(np, o_list, r_list, xc)
        err_c = float(np.abs(got - ref).max())
        if not err_c <= STACK_TOL * float(np.abs(ref).max()):
            raise AssertionError(f"(c) logits vs float64: {err_c:.3e}")
        report["c"] = {"stats": sc, "events": len(kinds), "cpu_events": len(cpu_kinds),
                       "results_after_first_open": n_after, "t_first_open": first_open,
                       "kernel_launches": launches_c, "max_abs_err": err_c,
                       "injected_failures": chaos.injected_failures}
        print(
            f"4b(c) chaos drill on the card = the CPU drill: {sc['completed']} completed "
            f"/ {sc['failed']} failed / {sc['expired']} expired / {sc['rejected']} "
            f"rejected, {sc['breaker_opens']} opens, {sc['breaker_closes']} closes; "
            f"{len(kinds)} events (the CPU's {len(cpu_kinds)} less its degrade); every one "
            f"of {sc['batches']} batches through the kernel ({launches_c} launches), "
            f"{n_after} of {len(done)} results after the first open at "
            f"t={first_open:.4f} s; each bit-equal to its own forward, vs float64 "
            f"{err_c:.3e}", flush=True,
        )

        # (d) Reload under fire: keep the last good weights, then swap.
        engine = serve.ServeEngine(serve.load_artifact(path), buckets=(32,))
        rt = serve.ServeRuntime(engine, clock=serve.ManualClock(), max_batch=32).start()
        x = np.random.default_rng(41).standard_normal((p, 32)).astype(np.float32)
        bad = os.path.join(tmp, "bad")
        shutil.copytree(path, bad)
        serve.corrupt_artifact(bad)
        path2 = os.path.join(tmp, "stack2")
        o2, r2 = random_stack(np, seed=1)
        serve.export_artifact(path2, params_from_numpy(o2, r2, device="cpu"))
        reset_launch_count()
        h0 = rt.submit(x)
        kept = rt.reload(bad)
        stale = "stale-weights" in rt.degraded_reasons and rt.state == "DEGRADED"
        h1 = rt.submit(x)
        swapped = rt.reload(path2)
        h2 = rt.submit(x)
        h3 = rt.submit(torch.from_numpy(x).cuda())   # admitted with one host copy
        rt.drain()
        launches_d = launch_count()
        fresh = serve.ServeEngine(serve.load_artifact(path2), buckets=(32,)).forward(x)
        if kept or not stale or not torch.equal(h1.result(), h0.result()):
            raise AssertionError("(d) the corrupt reload did not keep the last good weights")
        if not swapped or rt.degraded_reasons or not torch.equal(h2.result(), fresh):
            raise AssertionError("(d) the good reload did not serve the new stack")
        if not torch.equal(h3.result(), h2.result()) or rt.stats["rejected_poison"]:
            raise AssertionError("(d) a request on the card was not served like its host copy")
        if torch.equal(h2.result(), h0.result()) or launches_d != 4 * layers:
            raise AssertionError(f"(d) unchanged results or {launches_d} launches")
        report["d"] = {"corrupt_reload": kept, "good_reload": swapped,
                       "kernel_launches": launches_d}
        print("4b(d) reload: the corrupt copy refused (stale-weights, results bit-equal), "
              "the second stack swapped in and served bit-equal to a fresh engine, "
              "also to a request that arrived on the card", flush=True)

        report["overhead"] = runtime_overhead(torch, np, serve, engine)
        ov = report["overhead"]
        print(f"4b runtime host cost per batch of 32 single-sample requests: "
              f"{ov['runtime_batch_ms_p50']:.3f} ms through the runtime against "
              f"{ov['forward_ms_p50']:.3f} ms forwarded directly: "
              f"{ov['host_cost_ms']:.3f} ms (p50s, host clock) on {card}", flush=True)

    launches = launches_a + launches_s + launches_b + launches_c + launches_d
    report["kernel_launches"] = launches
    print(json.dumps({"runtime": report}), flush=True)
    return launches


# Table-I MNIST geometry (paper §III-B; repro's benchmarks/common.py):
# P=784, Q=10, n=2Q+1000, L=20 layers, K=100 ADMM iterations, M=20
# workers, 60000 training and 10000 test samples of the port's synthetic
# planted-teacher data, SSFNConfig's mu0=1e-3 and mul=1.
TRAIN = {"P": 784, "Q": 10, "n": 1020, "L": 20, "K": 100, "M": 20,
         "J": 60000, "J_test": 10000, "seed": 0}
# Reference bars for centralized equivalence (tests/test_system.py:45-49).
EQUIV_AGREEMENT = 0.85
EQUIV_ACC_GAP = 0.05
STEP_TOL = 1e-4   # o_star, card vs CPU: relative Frobenius gap


def check_equivalence(label: str, rep, acc_gap: float) -> None:
    """Fail unless a decentralized run meets the reference's bars against
    the centralized one."""
    if not (rep.agreement >= EQUIV_AGREEMENT and acc_gap < EQUIV_ACC_GAP):
        raise AssertionError(
            f"{label}: equivalence bars missed: agreement {rep.agreement:.4f} "
            f"(>= {EQUIV_AGREEMENT}), accuracy gap {acc_gap:.4f} (< {EQUIV_ACC_GAP})"
        )


def train_argv(workers: int, artifact: str) -> list[str]:
    t = TRAIN
    return [
        "--workers", str(workers), "--layers", str(t["L"]), "--hidden", str(t["n"]),
        "--classes", str(t["Q"]), "--input-dim", str(t["P"]), "--train", str(t["J"]),
        "--test", str(t["J_test"]), "--admm-iters", str(t["K"]),
        "--seed", str(t["seed"]), "--export-artifact", artifact,
    ]


def card_params(torch, path: str):
    """The readouts and R of an exported artifact, as tensors on the card."""
    from repro_torch.core.ssfn import SSFNParams
    from repro_torch.serve import load_artifact

    p = load_artifact(path).params
    return SSFNParams(o=tuple(o.cuda() for o in p.o), r=tuple(r.cuda() for r in p.r))


def timed(torch, fn):
    """(result, ms): fn's span on the card's timeline, host gaps included."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def layer_breakdown(torch, x_workers, t_workers, w1, cfg, policy=None) -> dict:
    """Where a full-width layer step's time goes on the card (layer 1,
    M workers, the train's own settings, under ``policy``: the backend's
    ExactMean by default), then the same step on the CPU through the
    plain versions from the same inputs, held against it."""
    from repro_torch.core import admm, engine
    from repro_torch.core.backend import SimulatedBackend
    from repro_torch.kernels.propagate_gram import propagate_gram, propagate_gram_ref

    m = x_workers.shape[0]
    x = x_workers.contiguous()
    kw = dict(mu=cfg.mul, eps_radius=cfg.eps_radius, num_iters=cfg.admm_iters)
    step0, ms_step0 = timed(torch, lambda: engine.fused_layer_step(
        SimulatedBackend(m, policy=policy), x, t_workers, None, mu=cfg.mu0,
        eps_radius=cfg.eps_radius, num_iters=cfg.admm_iters))
    step1, ms_step1 = timed(torch, lambda: engine.fused_layer_step(
        SimulatedBackend(m, policy=policy), x, t_workers, w1, **kw))
    (y1, g), ms_kernel = timed(torch, lambda: propagate_gram(w1, x, mu=cfg.mul))
    (chol, _), ms_chol = timed(torch, lambda: admm.guarded_cholesky(g))
    a, ms_a = timed(torch, lambda: torch.matmul(t_workers, y1.mT))
    z0 = torch.zeros_like(a[0])
    _, ms_admm = timed(torch, lambda: admm.worker_admm_iterations(
        SimulatedBackend(m, policy=policy), a, chol, y1, t_workers, z0, trace_every=1, **kw))
    _, ms_admm0 = timed(torch, lambda: admm.worker_admm_iterations(
        SimulatedBackend(m, policy=policy), a, chol, y1, t_workers, z0, trace_every=0, **kw))

    # The same step on the CPU, through the plain versions.
    x_c, t_c, w_c = x.cpu(), t_workers.cpu(), w1.cpu()
    y_ref, g_ref = propagate_gram_ref(w_c, x_c, mu=cfg.mul)
    err_y, scale_y = max_err(y1.cpu(), y_ref)
    err_g, scale_g = max_err(g.cpu(), g_ref)
    j = x.shape[2]
    if not (err_y <= KERNEL_TOL["float32"] * scale_y and err_g <= gram_tol(j) * scale_g):
        raise AssertionError(
            f"layer-1 step: card vs CPU Y' err {err_y:.3e} (max {scale_y:.3e}), "
            f"G err {err_g:.3e} (max {scale_g:.3e})"
        )
    del y_ref, g_ref
    cpu_step = engine.fused_layer_step(
        SimulatedBackend(m, policy=policy), x_c, t_c, w_c, trace_every=0, **kw)
    # Both f32 steps beside a float64 step of the same math on the CPU,
    # so a gap between them can be told apart from f32 rounding.
    f64 = torch.float64
    y64 = torch.relu(w_c.to(f64) @ x_c.to(f64))
    g64 = y64 @ y64.mT + torch.eye(y64.shape[1], dtype=f64) / cfg.mul
    t64 = t_c.to(f64)
    (_, z64, _), _ = admm.worker_admm_iterations(
        SimulatedBackend(m, policy=policy), t64 @ y64.mT, torch.linalg.cholesky(g64), y64, t64,
        torch.zeros_like(z0, device="cpu", dtype=f64), trace_every=0, **kw)
    del y64, g64

    def rel(a, b):
        a, b = a.detach().cpu().to(f64), b.detach().cpu().to(f64)
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    gap = rel(step1.o_star, cpu_step.o_star)
    if not gap <= STEP_TOL:
        raise AssertionError(f"layer-1 o_star card vs CPU: relative gap {gap:.3e} > {STEP_TOL}")
    return {
        "layer0_ms": ms_step0, "layer1_ms": ms_step1, "propagate_gram_ms": ms_kernel,
        "cholesky_ms": ms_chol, "a_ms": ms_a, "admm_ms": ms_admm,
        "admm_untraced_ms": ms_admm0, "err_y": err_y, "err_g": err_g,
        "o_star_gap": gap, "card_f64_gap": rel(step1.o_star, z64[0]),
        "cpu_f64_gap": rel(cpu_step.o_star, z64[0]), "jitter": step1.jitter.tolist(),
    }


def train_slice(torch, card: str) -> tuple[dict, dict]:
    """Train the full-width stack decentralized and centralized through the
    launcher, check it, break a layer's time down, serve what it trained.
    Returns each training kernel's main-path launch count, and the runs
    and inputs the gossip phase compares with."""
    from repro_torch.core import equivalence, ssfn
    from repro_torch.data import make_classification, partition_workers
    from repro_torch.kernels import gram, matmul_relu, propagate_gram
    from repro_torch.launch import train_dssfn
    from repro_torch.serve import ServeEngine, load_artifact

    counters = (gram, propagate_gram, matmul_relu)
    launches = {"gram": 0, "propagate_gram": 0}
    runs = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        for label, workers in (("decentralized", TRAIN["M"]), ("centralized", 1)):
            path = os.path.join(tmp, label)
            for c in counters:
                c.reset_launch_count()
            res = train_dssfn.main(train_argv(workers, path))
            counts = {"gram": gram.launch_count(), "propagate_gram": propagate_gram.launch_count()}
            run = res["runs"][0]
            if res["device"] != "cuda" or run["kernel_launches"]["gram"] != 1 \
                    or run["kernel_launches"]["propagate_gram"] != TRAIN["L"] \
                    or counts != {"gram": 1, "propagate_gram": TRAIN["L"]}:
                raise AssertionError(
                    f"{label} train on {res['device']}: kernel launches "
                    f"{run['kernel_launches']} (counters {counts}); expected 1 "
                    f"gram and {TRAIN['L']} propagate_gram"
                )
            for k in launches:
                launches[k] += counts[k]
            params = card_params(torch, path)
            if not all(bool(torch.isfinite(o).all()) for o in params.o):
                raise AssertionError(f"{label} train: non-finite readouts")
            if run["final_objective"] is None or run["final_objective"] != run["final_objective"]:
                raise AssertionError(f"{label} train: objective {run['final_objective']}")
            runs[label] = (run, params, path)
            print(
                f"train {label} M={workers}: {run['wall_time_s']:.3f} s per train, "
                f"{run['wall_time_s'] / (TRAIN['L'] + 1) * 1e3:.1f} ms per layer (mean), "
                f"objective {run['final_objective']:.4f}, test accuracy "
                f"{run['test_accuracy']:.4f}, jitter events {run['jitter_events']}, "
                f"kernel launches {run['kernel_launches']} on {card}",
                flush=True,
            )

        # The launcher's data and R, made again from the same seeds.
        q = TRAIN["Q"]
        data = make_classification(
            torch.Generator(device="cuda").manual_seed(TRAIN["seed"]),
            num_train=TRAIN["J"], num_test=TRAIN["J_test"],
            input_dim=TRAIN["P"], num_classes=q,
        )
        (run_d, dec, dec_path), (run_c, cen, _) = runs["decentralized"], runs["centralized"]
        rep = equivalence.compare(cen, dec, data.x_test, q)
        acc_gap = abs(run_d["test_accuracy"] - run_c["test_accuracy"])
        print(
            f"equivalence centralized vs decentralized (M={TRAIN['M']}, K={TRAIN['K']}): "
            f"max readout gap {rep.max_readout_gap:.3e}, prediction gap "
            f"{rep.prediction_gap:.3e}, agreement {rep.agreement:.4f}, "
            f"|test accuracy gap| {acc_gap:.4f}",
            flush=True,
        )
        check_equivalence("train", rep, acc_gap)

        cfg = ssfn.SSFNConfig(input_dim=TRAIN["P"], num_classes=q, num_layers=TRAIN["L"],
                              hidden=TRAIN["n"], admm_iters=TRAIN["K"])
        xw, tw = partition_workers(data.x_train, data.t_train, TRAIN["M"])
        w1 = ssfn.build_weight(dec.o[0], dec.r[0], q)
        bd = layer_breakdown(torch, xw, tw, w1, cfg)
        share = bd["propagate_gram_ms"] / bd["layer1_ms"]
        print(
            f"layer step on the card (M={TRAIN['M']}, J_m={TRAIN['J'] // TRAIN['M']}): "
            f"layer 0 {bd['layer0_ms']:.2f} ms, layer 1 {bd['layer1_ms']:.2f} ms = "
            f"propagate_gram {bd['propagate_gram_ms']:.2f} ms ({share:.0%}) + "
            f"guarded Cholesky {bd['cholesky_ms']:.2f} ms + A=TY^T {bd['a_ms']:.2f} ms + "
            f"{TRAIN['K']} ADMM iterations {bd['admm_ms']:.2f} ms traced "
            f"({bd['admm_untraced_ms']:.2f} ms untraced); vs CPU plain: Y' err "
            f"{bd['err_y']:.3e}, G err {bd['err_g']:.3e}, o_star gap "
            f"{bd['o_star_gap']:.3e} (card vs float64 {bd['card_f64_gap']:.3e}, "
            f"CPU f32 vs float64 {bd['cpu_f64_gap']:.3e}), jitter {bd['jitter']}",
            flush=True,
        )

        # The trained stack serves: within one bucket, bit for bit predict.
        engine = ServeEngine(load_artifact(dec_path), buckets=(32,))
        xb = data.x_test[:, :32].contiguous()
        out = engine.forward(xb.cpu())
        pred = ssfn.predict(dec, xb, q)
        torch.cuda.synchronize()
        if not torch.equal(out, pred):
            raise AssertionError("trained stack: ServeEngine.forward != ssfn.predict (bucket 32)")
        print("trained stack served: ServeEngine.forward == ssfn.predict bit for bit "
              "(bucket 32)", flush=True)
    # What the gossip phase compares against: the ExactMean runs, their
    # data, and the ExactMean layer step.
    exact = {"run_d": run_d, "run_c": run_c, "cen": cen, "dec": dec, "data": data, "cfg": cfg,
             "xw": xw, "tw": tw, "w1": w1, "breakdown": bd}
    return launches, exact


# The paper's own network (repro's benchmarks/bench_equivalence.py): a
# degree-4 circular graph over the M=20 workers, with the gossip rounds
# B that bring ||H^B - 11^T/M|| to 1e-8.
GOSSIP_DEGREE = 4
GOSSIP_TOL = 1e-8
# The final ADMM consensus error of each layer, max|mix - mean| at its
# last iteration, against max|O_l| of that layer's readout: the reference
# holds its gossip consensus error to 1e-4 (tests/test_system.py:52) at
# readouts of order 1; here it is made relative to the card's magnitudes.
GOSSIP_CERR = 1e-4
# One mix, card vs CPU: the same weighted sums in the same order, so only
# rounding in the library's elementwise kernels may differ.
MIX_TOL = 1e-6


def gossip_mix_cases(torch, card: str, rounds: int) -> list[dict]:
    """One ``Gossip.mix`` of an (M, Q, n) f32 message under the paper's
    network: compressed to one H^B schedule, serial (B rounds of every
    edge) and compressed over a bf16 wire, each on the card against the
    CPU and against a float64 H^B x, timed by CUDA events, beside the
    host's time to enqueue it and its device time (``torch.profiler``)."""
    import numpy as np

    from repro_torch.core import topology
    from repro_torch.core.policy import ConsensusContext, RingGossip

    m, q, n = TRAIN["M"], TRAIN["Q"], TRAIN["n"]
    x = torch.randn((m, q, n), generator=torch.Generator("cuda").manual_seed(5),
                    device="cuda")
    h_b = np.linalg.matrix_power(topology.circular_mixing_matrix(m, GOSSIP_DEGREE), rounds)
    x64 = x.double().cpu().numpy().reshape(m, -1)
    want = torch.from_numpy((h_b @ x64).reshape(m, q, n))
    scale = float(x.abs().max())
    ctx = ConsensusContext(m)
    out = []
    for label, pol in (
            ("compressed", RingGossip(rounds, GOSSIP_DEGREE)),
            ("serial", RingGossip(rounds, GOSSIP_DEGREE, compress=False)),
            ("compressed, bf16 wire", RingGossip(rounds, GOSSIP_DEGREE, wire_dtype="bf16"))):
        card_out = pol.one_shot(x, ctx)
        cpu_out = pol.one_shot(x.cpu(), ctx)
        err_cpu = float((card_out.cpu() - cpu_out).abs().max())
        if not err_cpu <= MIX_TOL * scale:
            raise AssertionError(f"gossip mix {label}: card vs CPU {err_cpu:.3e} > "
                                 f"{MIX_TOL} x max|x| = {MIX_TOL * scale:.3e}")
        err_f64 = float((card_out.cpu().double() - want).abs().max())
        iters = 20 if label == "serial" else 100
        for _ in range(3):
            pol.one_shot(x, ctx)
        _, ms = timed(torch, lambda: [pol.one_shot(x, ctx) for _ in range(iters)])
        # The host's side: the time to enqueue the mixes, unsynchronized.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            pol.one_shot(x, ctx)
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        device = kernel_profile(torch, card, "gossip mix", label, lambda: pol.one_shot(x, ctx))
        case = {"mix": label, "hops": pol.hops_for(m), "exchanges": pol.exchanges_for(m),
                "card_vs_cpu": err_cpu / scale, "vs_float64": err_f64 / scale,
                "ms": ms / iters, "enqueue_ms": enqueue_ms, "device_ms": device["total_ms"]}
        print(f"gossip mix {label} (M={m}, ({q}, {n}) f32, B={rounds}, "
              f"{case['hops']} hops): {case['ms']:.3f} ms per mix (host enqueue "
              f"{enqueue_ms:.3f} ms, device {case['device_ms']:.3f} ms); card vs CPU "
              f"{case['card_vs_cpu']:.2e} x max|x|, vs float64 H^B x "
              f"{case['vs_float64']:.2e} x max|x| on {card}", flush=True)
        out.append(case)
    return out


def consensus_errors(errors, readouts) -> float:
    """The largest final consensus error of a layer against max|O_l|,
    failing above GOSSIP_CERR."""
    worst = max(float(e) / float(o.abs().max()) for e, o in zip(errors, readouts))
    if not worst <= GOSSIP_CERR:
        raise AssertionError(f"final ADMM consensus error {worst:.3e} x max|O_l| "
                             f"> {GOSSIP_CERR}")
    return worst


def gossip_slice(torch, card: str, exact: dict) -> dict:
    """The paper's gossip network at full width (phase 5b): (a) a train
    through the launcher, (b) a layer-1 step under it, (c) one mix, (d)
    the benchmark's legacy dense-H call.  Returns each training kernel's
    launch count over (a) and (d)."""
    import warnings

    from repro_torch.core import consensus, equivalence, layerwise, topology
    from repro_torch.core.policy import RingGossip
    from repro_torch.kernels import gram, propagate_gram
    from repro_torch.launch import train_dssfn

    m, q, layers = TRAIN["M"], TRAIN["Q"], TRAIN["L"]
    h = topology.circular_mixing_matrix(m, GOSSIP_DEGREE)
    rounds = topology.gossip_rounds_for_tolerance(h, GOSSIP_TOL)
    policy = RingGossip(rounds, GOSSIP_DEGREE)
    print(f"gossip network: M={m}, degree {GOSSIP_DEGREE}, spectral gap "
          f"{topology.spectral_gap(h):.4f}, B={rounds} rounds for {GOSSIP_TOL}, "
          f"{policy.hops_for(m)} hops per mix ({policy.exchanges_for(m)} exchanges, "
          f"eq. 15)", flush=True)
    run_d, run_c, cen, data = exact["run_d"], exact["run_c"], exact["cen"], exact["data"]
    launches = {"gram": 0, "propagate_gram": 0}

    def count(label, depth=layers):
        counts = {"gram": gram.launch_count(), "propagate_gram": propagate_gram.launch_count()}
        if counts != {"gram": 1, "propagate_gram": depth}:
            raise AssertionError(f"{label}: kernel launches {counts}; expected 1 gram and "
                                 f"{depth} propagate_gram")
        for k in launches:
            launches[k] += counts[k]

    # (a) The launcher, with the spec the benchmark's network spells.
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "gossip")
        for c in (gram, propagate_gram):
            c.reset_launch_count()
        res = train_dssfn.main(train_argv(m, path) +
                               ["--consensus", f"gossip:{rounds}:{GOSSIP_DEGREE}"])
        count("gossip train")
        run = res["runs"][0]
        params = card_params(torch, path)
    if res["device"] != "cuda" or run["policy"] != policy.describe():
        raise AssertionError(f"gossip train: {run['policy']} on {res['device']}")
    if not all(bool(torch.isfinite(o).all()) for o in params.o):
        raise AssertionError("gossip train: non-finite readouts")
    if run["comm_scalars"] != policy.exchanges_for(m) * run_d["comm_scalars"] or \
            policy.exchanges_for(m) != 2 * GOSSIP_DEGREE * rounds:
        raise AssertionError(f"gossip train: comm scalars {run['comm_scalars']}, ExactMean "
                             f"{run_d['comm_scalars']}")
    cerr = consensus_errors(run["consensus_error"], params.o)
    rep = equivalence.compare(cen, params, data.x_test, q)
    acc_gap = abs(run["test_accuracy"] - run_c["test_accuracy"])
    print(
        f"gossip train M={m} (launcher, --consensus gossip:{rounds}:{GOSSIP_DEGREE}): "
        f"{run['wall_time_s']:.3f} s per train (ExactMean {run_d['wall_time_s']:.3f} s), "
        f"test accuracy {run['test_accuracy']:.4f}, comm {run['comm_scalars']} scalars = "
        f"{run['comm_scalars'] // run_d['comm_scalars']} x ExactMean's, final consensus "
        f"error <= {cerr:.3e} x max|O_l| (bar {GOSSIP_CERR}), vs centralized: agreement "
        f"{rep.agreement:.4f}, |test accuracy gap| {acc_gap:.4f}, max readout gap "
        f"{rep.max_readout_gap:.3e}; kernel launches {run['kernel_launches']} on {card}",
        flush=True,
    )
    check_equivalence("gossip train", rep, acc_gap)

    # (b) A layer-1 step under the same policy, beside ExactMean's.
    cfg = exact["cfg"]
    bd = layer_breakdown(torch, exact["xw"], exact["tw"], exact["w1"], cfg, policy=policy)
    ex = exact["breakdown"]
    k = TRAIN["K"]
    print(
        f"layer step under gossip (M={m}, B={rounds}): layer 1 {bd['layer1_ms']:.2f} ms "
        f"(ExactMean {ex['layer1_ms']:.2f}) = propagate_gram {bd['propagate_gram_ms']:.2f} + "
        f"guarded Cholesky {bd['cholesky_ms']:.2f} + A=TY^T {bd['a_ms']:.2f} + {k} ADMM "
        f"iterations {bd['admm_ms']:.2f} ms traced, {bd['admm_untraced_ms']:.2f} untraced "
        f"({bd['admm_untraced_ms'] / k:.3f} ms per iteration; ExactMean "
        f"{ex['admm_untraced_ms'] / k:.3f}); vs CPU plain: o_star gap "
        f"{bd['o_star_gap']:.3e} (card vs float64 {bd['card_f64_gap']:.3e}, CPU f32 vs "
        f"float64 {bd['cpu_f64_gap']:.3e}) on {card}",
        flush=True,
    )

    # (c) One mix.
    mixes = gossip_mix_cases(torch, card, rounds)

    # (d) The benchmark's call: the legacy dense-H simulation, with the
    # launcher's data, shards and R (the generator at seed + 1).
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cfn = consensus.make_consensus_fn("gossip", h=h, num_rounds=rounds)
    for c in (gram, propagate_gram):
        c.reset_launch_count()
    gen = torch.Generator(device="cuda").manual_seed(TRAIN["seed"] + 1)
    t0 = time.perf_counter()
    legacy, log = layerwise.train_decentralized_ssfn(
        exact["xw"], exact["tw"], cfg, gen, consensus_fn=cfn, gossip_rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    count("legacy consensus_fn train")
    if not all(bool(torch.isfinite(o).all()) for o in legacy.o):
        raise AssertionError("legacy train: non-finite readouts")
    if log.comm_scalars != rounds * run_d["comm_scalars"]:
        raise AssertionError(f"legacy train: comm scalars {log.comm_scalars}")
    legacy_cerr = consensus_errors(log.consensus_error[:, -1], legacy.o)
    acc = layerwise.accuracy(legacy, data.x_test, data.y_test, q)
    rep_l = equivalence.compare(cen, legacy, data.x_test, q)
    gap_l = abs(acc - run_c["test_accuracy"])
    print(
        f"legacy gossip train M={m} (consensus_fn=make_consensus_fn('gossip', B={rounds}), "
        f"gossip_rounds={rounds}): {wall:.3f} s per train, test accuracy {acc:.4f}, comm "
        f"{log.comm_scalars} scalars = {rounds} x ExactMean's (B per consensus, the legacy "
        f"accounting), final consensus error <= {legacy_cerr:.3e} x max|O_l|, vs "
        f"centralized: agreement {rep_l.agreement:.4f}, |test accuracy gap| {gap_l:.4f}, "
        f"max readout gap {rep_l.max_readout_gap:.3e} on {card}",
        flush=True,
    )
    check_equivalence("legacy gossip train", rep_l, gap_l)
    print(json.dumps({"gossip": {
        "card": card, "rounds": rounds, "train_s": run["wall_time_s"],
        "exact_train_s": run_d["wall_time_s"], "legacy_train_s": wall,
        "agreement": rep.agreement, "legacy_agreement": rep_l.agreement,
        "consensus_error": cerr, "legacy_consensus_error": legacy_cerr,
        "layer1_ms": bd["layer1_ms"], "exact_layer1_ms": ex["layer1_ms"],
        "admm_untraced_ms": bd["admm_untraced_ms"],
        "exact_admm_untraced_ms": ex["admm_untraced_ms"], "o_star_gap": bd["o_star_gap"],
        "mixes": mixes}}), flush=True)
    return launches


# Phase 5c: the paper's §IV non-ideal links at full width, each trained
# through the launcher and held to the bar repro's own test sets for it
# (tests/test_robust.py): the readout of a consensus ADMM solve within a
# relative gap of the exact solution (stale 1e-3 at :68-79, lossy 0.10 at
# :127-138, quantized 5e-2 at :175-187), here the train's own layer-0
# solve (the layer whose features, the data, every run shares) against a
# float64 constrained-ridge oracle on the same 60000 samples.  The lossy
# train runs the paper's gossip network (degree 4, the B of phase 5b)
# with 10% link loss.
POLICY_TRAINS = (("quantized:8", 5e-2), ("lossy:0.1:{B}:4", 0.10), ("stale:2", 1e-3))
# repro's other lossy test asks a lossy train's test accuracy to stay
# within 0.10 of the clean gossip run's, at 3 layers and mu0 = mul = 1e-2
# (:140-170).  The same network and links are trained so at full width,
# through the facade beside the clean gossip, and the two accuracies
# printed: a measurement, not a bar (at this width the links cost more,
# PERF.md §6; the packages agree on lossy trains, tests/test_torch_train.py
# and tests/test_torch_policies.py).
LOSSY_MU = 1e-2
LOSSY_LAYERS = 3
# The grammar entries this slice ports, one mix each (the hypercube over
# 16 workers: it needs a power of two).
POLICY_MIXES = ("quantized", "quantized:4", "quantized:8@ring:2", "lossy:0.2:2:2",
                "lossy:0.1@hypercube", "stale:1", "stale:2", "stale:1@ring:2")


def mix_timing(torch, card: str, label: str, call, iters: int) -> dict:
    """A call's CUDA-event time, the host's time to enqueue it and its
    device time (``torch.profiler``), per call, after warm-up calls."""
    for _ in range(3):
        call()
    _, ms = timed(torch, lambda: [call() for _ in range(iters)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    device = kernel_profile(torch, card, label, "", call)
    return {"ms": ms / iters, "enqueue_ms": enqueue_ms, "device_ms": device["total_ms"],
            "kernel_kinds": len(device["kernels_ms"])}


def policy_mix_cases(torch, card: str) -> list[dict]:
    """One mix of an (M, Q, n) f32 message under each ported grammar
    entry, on the card against the same mix on the CPU from the same
    seed: the draws bit for bit (the quantized wire from the first
    round's subkeys; the lossy link draws), the values within MIX_TOL x
    max|x|; timed cold (the host's key chain and link draws included)
    and warm (those memoized, as every layer after the first finds them)."""
    from repro_torch import dssfn, prng
    from repro_torch.core import consensus
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.policy import ConsensusContext

    q, n = TRAIN["Q"], TRAIN["n"]
    out = []
    for spec in POLICY_MIXES:
        m = 16 if "hypercube" in spec else TRAIN["M"]
        pol, ctx = dssfn.parse_spec(spec), ConsensusContext(m)
        x = torch.randn((m, q, n), generator=torch.Generator("cuda").manual_seed(6),
                        device="cuda")
        scale = float(x.abs().max())
        state = pol.init_state(x, ctx)
        state_cpu = pol.init_state(x.cpu(), ctx)
        draws = "none (no randomness)"
        if spec.startswith("quantized"):
            sub = prng.split(state)[:, 1]
            if not torch.equal(consensus.quantize_stochastic(x, pol.bits, sub).cpu(),
                               consensus.quantize_stochastic(x.cpu(), pol.bits, sub)):
                raise AssertionError(f"{spec}: the card's stochastic rounding != the CPU's")
            draws = "quantized wire bit-equal"
        elif spec.startswith("lossy"):
            _, card_rounds = policy_lib._lossy_draws(pol, state.tobytes(), m, x.device)
            _, cpu_rounds = policy_lib._lossy_draws(pol, state.tobytes(), m, torch.device("cpu"))
            for (c, w), (c_cpu, w_cpu) in zip(card_rounds, cpu_rounds):
                if not (torch.equal(c.cpu(), c_cpu) and torch.equal(w.cpu(), w_cpu)):
                    raise AssertionError(f"{spec}: the card's link draws != the CPU's")
            draws = "link draws bit-equal"
        card_out, _ = pol.mix(x, state, ctx)
        cpu_out, _ = pol.mix(x.cpu(), state_cpu, ctx)
        err = float((card_out.cpu() - cpu_out).abs().max())
        if not err <= MIX_TOL * scale:
            raise AssertionError(f"{spec} mix: card vs CPU {err:.3e} > {MIX_TOL} x max|x|")
        policy_lib._key_chain.cache_clear()
        policy_lib._lossy_draws.cache_clear()
        _, cold_ms = timed(torch, lambda: pol.mix(x, state, ctx))
        case = {"spec": spec, "policy": pol.describe(), "M": m, "draws": draws,
                "card_vs_cpu": err / scale, "cold_ms": cold_ms,
                **mix_timing(torch, card, f"mix {spec}", lambda: pol.mix(x, state, ctx), 20)}
        print(f"policy mix {spec} (M={m}, ({q}, {n}) f32): {case['ms']:.3f} ms per mix "
              f"(host enqueue {case['enqueue_ms']:.3f} ms, device {case['device_ms']:.3f} ms "
              f"in {case['kernel_kinds']} kinds of kernel; first mix with the host's draws "
              f"{cold_ms:.3f} ms); card vs CPU {case['card_vs_cpu']:.2e} x max|x|, draws: "
              f"{draws} on {card}", flush=True)
        out.append(case)
    return out


def threefry_cases(torch, card: str) -> list[dict]:
    """The card's threefry words for an (M, Q, n) draw from M worker keys
    against the CPU's, bit for bit, and their time."""
    import numpy as np

    from repro_torch import prng

    m, q, n = TRAIN["M"], TRAIN["Q"], TRAIN["n"]
    keys = prng.fold_in(prng.PRNGKey(0), np.arange(m))
    dev = torch.from_numpy(keys.astype(np.int64)).cuda()
    p = torch.rand((m, q, n), generator=torch.Generator().manual_seed(2))
    p_dev = p.cuda()
    out = []
    for label, card_call, cpu_call in (
            ("random_bits", lambda: prng.random_bits(dev, (q, n)),
             lambda: prng.random_bits(keys, (q, n), device="cpu")),
            ("bernoulli", lambda: prng.bernoulli(dev, p_dev, (q, n)),
             lambda: prng.bernoulli(keys, p, (q, n), device="cpu"))):
        if not torch.equal(card_call().cpu(), cpu_call()):
            raise AssertionError(f"threefry {label}: the card's words != the CPU's")
        case = {"draw": label, "shape": [m, q, n],
                **mix_timing(torch, card, f"threefry {label}", card_call, 20)}
        print(f"threefry {label} ({m} keys x ({q}, {n})): bit-equal to the CPU; "
              f"{case['ms']:.3f} ms per draw (host enqueue {case['enqueue_ms']:.3f} ms, "
              f"device {case['device_ms']:.3f} ms in {case['kernel_kinds']} kinds of kernel) "
              f"on {card}", flush=True)
        out.append(case)
    return out


def policy_slice(torch, card: str, exact: dict) -> dict:
    """The quantized, lossy and stale links at full width (phase 5c): (a)
    three trains through the launcher, each held to its policy's bar,
    (b) one mix per ported grammar entry, card vs CPU, (c) threefry
    draws, card vs CPU.  Returns each training kernel's launch count
    over (a)."""
    from repro_torch import dssfn
    from repro_torch.core import admm, equivalence, topology
    from repro_torch.kernels import gram, propagate_gram
    from repro_torch.launch import train_dssfn

    m, q, layers = TRAIN["M"], TRAIN["Q"], TRAIN["L"]
    rounds = topology.gossip_rounds_for_tolerance(
        topology.circular_mixing_matrix(m, GOSSIP_DEGREE), GOSSIP_TOL)
    run_d, run_c, cen, data = exact["run_d"], exact["run_c"], exact["cen"], exact["data"]
    oracle = admm.exact_constrained_ridge(data.x_train, data.t_train,
                                          eps_radius=exact["cfg"].eps_radius)

    def oracle_gap(o):
        o = o.double()
        return float(torch.linalg.vector_norm(o - oracle) / torch.linalg.vector_norm(oracle))

    exact_gap = oracle_gap(exact["dec"].o[0])
    print(f"layer-0 oracle (float64 constrained ridge on {TRAIN['J']} samples): ExactMean "
          f"train's O_0 within {exact_gap:.3e} of it", flush=True)
    launches = {"gram": 0, "propagate_gram": 0}

    def count(label, depth=layers):
        counts = {"gram": gram.launch_count(), "propagate_gram": propagate_gram.launch_count()}
        if counts != {"gram": 1, "propagate_gram": depth}:
            raise AssertionError(f"{label}: kernel launches {counts}; expected 1 gram and "
                                 f"{depth} propagate_gram")
        for k in launches:
            launches[k] += counts[k]
        return counts

    trains = []
    for spec, bar in POLICY_TRAINS:
        spec = spec.format(B=rounds)
        policy = dssfn.parse_spec(spec)
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
            path = os.path.join(tmp, "policy")
            for c in (gram, propagate_gram):
                c.reset_launch_count()
            res = train_dssfn.main(train_argv(m, path) + ["--consensus", spec])
            counts = count(f"{spec} train")
            run = res["runs"][0]
            params = card_params(torch, path)
        if res["device"] != "cuda":
            raise AssertionError(f"{spec} train on {res['device']}")
        if run["policy"] != policy.describe():
            raise AssertionError(f"{spec} train: policy {run['policy']}")
        if not all(bool(torch.isfinite(o).all()) for o in params.o):
            raise AssertionError(f"{spec} train: non-finite readouts")
        exchanges = policy.exchanges_for(m)
        if run["comm_scalars"] != exchanges * run_d["comm_scalars"]:
            raise AssertionError(f"{spec} train: comm scalars {run['comm_scalars']}, "
                                 f"ExactMean {run_d['comm_scalars']} x {exchanges}")
        wire_bytes = run["comm_scalars"] * run["wire_bits"] // 8
        exact_bytes = run_d["comm_scalars"] * 32 // 8
        cerrs = [float(e) / float(o.abs().max())
                 for e, o in zip(run["consensus_error"], params.o)]
        rep = equivalence.compare(cen, params, data.x_test, q)
        acc_gap = abs(run["test_accuracy"] - run_c["test_accuracy"])
        gap0 = oracle_gap(params.o[0])
        held = gap0 <= bar
        bar_text = (f"layer-0 readout within {gap0:.3e} of the oracle (bar {bar}): "
                    f"{'held' if held else 'MISSED'}")
        print(
            f"policy train {spec} M={m} (launcher): {run['wall_time_s']:.3f} s per train "
            f"(ExactMean {run_d['wall_time_s']:.3f} s), {bar_text}; "
            f"test accuracy {run['test_accuracy']:.4f}; eq. 15: {run['comm_scalars']} scalars = "
            f"{exchanges} x ExactMean's, {wire_bytes} bytes = "
            f"{wire_bytes / exact_bytes:.4g} x ExactMean's ({run['wire_bits']}-bit wire); "
            f"final consensus error per layer / max|O_l|: max {max(cerrs):.3e}, "
            f"{['%.2e' % c for c in cerrs]}; layer-0 oracle gap {gap0:.3e}; vs centralized: "
            f"agreement {rep.agreement:.4f}, |test accuracy gap| {acc_gap:.4f}; kernel "
            f"launches {counts} on {card}",
            flush=True,
        )
        if not held:
            raise AssertionError(f"{spec} train: {bar_text}")
        trains.append({"spec": spec, "train_s": run["wall_time_s"],
                       "exact_train_s": run_d["wall_time_s"], "bar": bar_text,
                       "oracle_gap": gap0, "exact_oracle_gap": exact_gap,
                       "comm_scalars_x": exchanges, "wire_bytes_x": wire_bytes / exact_bytes,
                       "consensus_error": cerrs, "agreement": rep.agreement,
                       "accuracy": run["test_accuracy"], "accuracy_gap": acc_gap})
    del oracle

    # The lossy network at the depth and penalty of repro's accuracy test,
    # beside the clean gossip, through the facade, on the launcher's data,
    # shards and R (the generator at seed + 1).
    cfg = dataclasses.replace(exact["cfg"], mu0=LOSSY_MU, mul=LOSSY_MU,
                              num_layers=LOSSY_LAYERS)
    accs = {}
    for label, spec in (("clean", f"gossip:{rounds}:{GOSSIP_DEGREE}"),
                        ("lossy", POLICY_TRAINS[1][0].format(B=rounds))):
        for c in (gram, propagate_gram):
            c.reset_launch_count()
        t0 = time.perf_counter()
        res = dssfn.train(dssfn.TrainSpec(cfg=cfg, workers=m, policy=spec), exact["xw"],
                          exact["tw"],
                          torch.Generator(device="cuda").manual_seed(TRAIN["seed"] + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = count(f"{spec} train, {LOSSY_LAYERS} layers", LOSSY_LAYERS)
        if not all(bool(torch.isfinite(o).all()) for o in res.params.o):
            raise AssertionError(f"{spec} train, {LOSSY_LAYERS} layers: non-finite readouts")
        accs[label] = dssfn.evaluate(res, data.x_test, data.y_test)
        print(f"policy train {spec} M={m}, {LOSSY_LAYERS} layers at mu0 = mul = {LOSSY_MU} "
              f"(dssfn.train): {wall:.3f} s per train, test accuracy {accs[label]:.4f}; "
              f"kernel launches {counts} on {card}", flush=True)
    drop = accs["clean"] - accs["lossy"]
    print(f"policy train {spec}, {LOSSY_LAYERS} layers at mu {LOSSY_MU}: 10% link loss costs "
          f"{drop:.4f} of test accuracy against the clean gossip (repro's test asks < 0.10 "
          f"at its own width; measured here, not held)", flush=True)
    trains.append({"spec": spec, "layers": LOSSY_LAYERS, "mu": LOSSY_MU,
                   "accuracy": accs["lossy"], "clean_accuracy": accs["clean"],
                   "accuracy_drop": drop})
    mixes = policy_mix_cases(torch, card)
    draws = threefry_cases(torch, card)
    print(json.dumps({"policies": {"card": card, "trains": trains, "mixes": mixes,
                                   "threefry": draws}}), flush=True)
    return launches


# Phase 5d: the fault model and the Byzantine-robust policies at full
# width, on the paper's degree-4 ring: (spec, eq.-15 scalars as a multiple
# of ExactMean's, the layer-0 oracle bar or None, the Byzantine workers).
# The async train talks on one ADMM iteration in 4 (52 rounds x 8
# exchanges / 4 = 104x); the attacked trains mix 3 rounds (24x).  0.35 is
# repro's bar for an interval of 4 (tests/test_faults.py:283-300);
# repro's Byzantine bounds fail in repro itself (ROADMAP Queue 3) and are
# not made bars here: the attacked trains print their distances instead.
FAULT_TRAINS = (
    ("async:rounds=52:interval=4:drop=0.1:seed=7@ring:4", 104, 0.35, ()),
    ("async:rounds=3:byz=3:attack=signflip@ring:4", 24, None, (3,)),
    ("trimmed:f=1:rounds=3:byz=3:attack=signflip@ring:4", 24, None, (3,)),
    ("median:rounds=3:byz=3+11:attack=nanbomb@ring:4", 24, None, (3, 11)),
)
# One mix each: the ten grammar entries this slice ports, at an M each
# admits (the hypercube over 16 workers, the 2x4 torus over 8), the four
# train specs, and the vulnerable baseline under a NaN bomb.
FAULT_MIXES = (
    "async:rounds=2", "async:interval=2:rounds=2", "async:interval=4@ring:2",
    "async:drop=0.2:seed=3@hypercube", "async:rounds=2@ring:1+hypercube",
    "trimmed:f=1:attack=signflip", "trimmed:f=1:attack=scale:10@hypercube",
    "median:attack=noise:0.5@ring:2", "clipped:0.5:attack=nanbomb",
    "clipped:tau=2.0:byz=0+3:attack=replay:2@torus:2x4",
) + tuple(spec for spec, _, _, _ in FAULT_TRAINS) + (
    "async:rounds=3:byz=3:attack=nanbomb@ring:4",
)


def fault_mix_cases(torch, card: str) -> list[dict]:
    """One mix of an (M, Q, n) f32 message under each FAULT_MIXES spec, on
    the card against the same mix on the CPU from the same state: the
    host-made masks, link gates and noise draws bit for bit on both
    devices, values within MIX_TOL x max|x| with the same non-finite
    entries; a NaN bomb screened out by the robust policies and passed
    through by AsyncGossip; the all-worker mean kept by a mix with drops
    (dead links reroute their weight symmetrically); timed cold (the
    host's draws included) and warm."""
    from repro_torch import dssfn
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.policy import AsyncGossip, ConsensusContext

    q, n = TRAIN["Q"], TRAIN["n"]
    caches = (policy_lib._alive_rows, policy_lib._async_link_weights,
              policy_lib._robust_alive, policy_lib._noise)
    out = []
    for spec in FAULT_MIXES:
        m = 16 if "hypercube" in spec else 8 if "torus" in spec else TRAIN["M"]
        pol, ctx = dssfn.parse_spec(spec), ConsensusContext(m)
        pol.validate(m)
        faults = pol.faults
        x = torch.randn((m, q, n), generator=torch.Generator("cuda").manual_seed(7),
                        device="cuda")
        scale = float(x.abs().max())
        state, state_cpu = pol.init_state(x, ctx), pol.init_state(x.cpu(), ctx)
        draws = []
        if faults.drop > 0.0 or faults.failed:
            if isinstance(pol, AsyncGossip):
                card_gates = policy_lib._async_link_weights(pol, 0, m, x.dtype, x.device)
                cpu_gates = policy_lib._async_link_weights(pol, 0, m, x.dtype,
                                                           torch.device("cpu"))
                same = all(torch.equal(a.cpu(), b) for ga, gb in zip(card_gates, cpu_gates)
                           for a, b in zip(ga, gb))
            else:
                card_alive, cpu_alive = (
                    policy_lib._robust_alive(faults, 0, pol.rounds, m, x.dtype, dev)
                    for dev in (x.device, torch.device("cpu")))
                same = (card_alive is None and cpu_alive is None) or \
                    torch.equal(card_alive.cpu(), cpu_alive)
            if not same:
                raise AssertionError(f"{spec}: the card's fault masks != the CPU's")
            draws.append("masks bit-equal")
        if faults.byzantine and faults.attack_kind == "noise":
            pays = [faults.corrupted_payload(v, iteration=0, round_idx=0) - v
                    for v in (x, x.cpu())]
            if not torch.equal(pays[0].cpu(), pays[1]):
                raise AssertionError(f"{spec}: the card's noise draw != the CPU's")
            draws.append("noise bit-equal")
        card_out, _ = pol.mix(x, state, ctx)
        cpu_out, _ = pol.mix(x.cpu(), state_cpu, ctx)
        card_out = card_out.cpu()
        finite = torch.isfinite(cpu_out)
        if not torch.equal(torch.isfinite(card_out), finite):
            raise AssertionError(f"{spec} mix: card and CPU differ in their non-finite entries")
        err = float((card_out[finite] - cpu_out[finite]).abs().max()) if bool(finite.any()) \
            else 0.0
        if not err <= MIX_TOL * scale:
            raise AssertionError(f"{spec} mix: card vs CPU {err:.3e} > {MIX_TOL} x max|x|")
        nan_bomb = faults.byzantine and faults.attack_kind == "nanbomb"
        if nan_bomb and bool(finite.all()) == isinstance(pol, AsyncGossip):
            raise AssertionError(f"{spec} mix: a NaN bomb through {type(pol).__name__} gave "
                                 f"{'finite' if bool(finite.all()) else 'non-finite'} values")
        mean_err = None
        if isinstance(pol, AsyncGossip) and faults.drop > 0.0 and not faults.byzantine:
            mean_err = float((card_out.mean(0) - x.cpu().mean(0)).abs().max())
            if not mean_err <= MIX_TOL * scale:
                raise AssertionError(f"{spec} mix: the mean moved by {mean_err:.3e}")
        for cache in caches:
            cache.cache_clear()
        _, cold_ms = timed(torch, lambda: pol.mix(x, state, ctx))
        case = {"spec": spec, "policy": type(pol).__name__, "M": m,
                "draws": ", ".join(draws) or "none", "card_vs_cpu": err / scale,
                "finite": bool(finite.all()), "mean_err": mean_err, "cold_ms": cold_ms,
                **mix_timing(torch, card, f"mix {spec}", lambda: pol.mix(x, state, ctx), 10)}
        print(f"fault mix {spec} (M={m}, ({q}, {n}) f32): {case['ms']:.3f} ms per mix (host "
              f"enqueue {case['enqueue_ms']:.3f} ms, device {case['device_ms']:.3f} ms in "
              f"{case['kernel_kinds']} kinds of kernel; first mix with the host's draws "
              f"{cold_ms:.3f} ms); card vs CPU {case['card_vs_cpu']:.2e} x max|x|, finite "
              f"{case['finite']}, draws: {case['draws']}"
              + ("" if mean_err is None else f", mean moved {mean_err / scale:.2e} x max|x|")
              + f" on {card}", flush=True)
        out.append(case)
    return out


def fault_slice(torch, card: str, exact: dict) -> dict:
    """The fault model and the robust policies at full width (phase 5d):
    (a) four trains through the launcher, (b) one mix per FAULT_MIXES
    spec, card vs CPU, (c) a layer-1 step under the async spec beside
    ExactMean's.  Returns each training kernel's launch count over (a)."""
    from repro_torch import dssfn
    from repro_torch.core import admm, equivalence
    from repro_torch.kernels import gram, propagate_gram
    from repro_torch.launch import train_dssfn

    m, q, layers = TRAIN["M"], TRAIN["Q"], TRAIN["L"]
    run_d, run_c, cen, data = exact["run_d"], exact["run_c"], exact["cen"], exact["data"]
    eps = exact["cfg"].eps_radius
    xw, tw = exact["xw"], exact["tw"]
    oracle = admm.exact_constrained_ridge(data.x_train, data.t_train, eps_radius=eps)

    def gap(o, ref):
        o = o.double()
        return float(torch.linalg.vector_norm(o - ref) / torch.linalg.vector_norm(ref))

    launches = {"gram": 0, "propagate_gram": 0}
    trains = []
    for spec, ratio, bar, byz in FAULT_TRAINS:
        policy = dssfn.parse_spec(spec)
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
            path = os.path.join(tmp, "fault")
            for c in (gram, propagate_gram):
                c.reset_launch_count()
            res = train_dssfn.main(train_argv(m, path) + ["--consensus", spec])
            counts = {"gram": gram.launch_count(), "propagate_gram": propagate_gram.launch_count()}
            run = res["runs"][0]
            params = card_params(torch, path)
        if counts != {"gram": 1, "propagate_gram": layers}:
            raise AssertionError(f"{spec} train: kernel launches {counts}; expected 1 gram "
                                 f"and {layers} propagate_gram")
        for k in launches:
            launches[k] += counts[k]
        if res["device"] != "cuda" or run["policy"] != policy.describe():
            raise AssertionError(f"{spec} train: {run['policy']} on {res['device']}")
        if run["comm_scalars"] != ratio * run_d["comm_scalars"]:
            raise AssertionError(f"{spec} train: comm scalars {run['comm_scalars']}, "
                                 f"ExactMean {run_d['comm_scalars']} x {ratio}")
        if not all(bool(torch.isfinite(o).all()) for o in params.o):
            raise AssertionError(f"{spec} train: non-finite readouts")
        cerrs = [float(e) / float(o.abs().max())
                 for e, o in zip(run["consensus_error"], params.o)]
        rep = equivalence.compare(cen, params, data.x_test, q)
        gap0 = gap(params.o[0], oracle)
        case = {"spec": spec, "train_s": run["wall_time_s"],
                "exact_train_s": run_d["wall_time_s"], "comm_scalars_x": ratio,
                "accuracy": run["test_accuracy"], "agreement": rep.agreement,
                "accuracy_gap": abs(run["test_accuracy"] - run_c["test_accuracy"]),
                "consensus_error": cerrs, "oracle_gap": gap0}
        text = f"layer-0 readout within {gap0:.3e} of the float64 oracle"
        if bar is not None:
            held = gap0 <= bar
            text += f" (bar {bar}): {'held' if held else 'MISSED'}"
            case["bar"] = text
        if byz:
            keep = [i for i in range(m) if i not in byz]
            honest = admm.exact_constrained_ridge(
                xw[keep].permute(1, 0, 2).reshape(TRAIN["P"], -1),
                tw[keep].permute(1, 0, 2).reshape(q, -1), eps_radius=eps)
            case["honest_oracle_gap"] = gap(params.o[0], honest)
            text += (f", {case['honest_oracle_gap']:.3e} of the honest-data oracle (worker(s) "
                     f"{'+'.join(map(str, byz))} left out)")
            del honest
        print(
            f"fault train {spec} M={m} (launcher): {run['wall_time_s']:.3f} s per train "
            f"(ExactMean {run_d['wall_time_s']:.3f} s), {text}; test accuracy "
            f"{run['test_accuracy']:.4f}; vs centralized: agreement {rep.agreement:.4f}, "
            f"|test accuracy gap| {case['accuracy_gap']:.4f}; eq. 15: {run['comm_scalars']} "
            f"scalars = {ratio} x ExactMean's; final consensus error per layer / max|O_l|: max "
            f"{max(cerrs):.3e}, {['%.2e' % c for c in cerrs]}; kernel launches {counts} on {card}",
            flush=True,
        )
        if bar is not None and not held:
            raise AssertionError(f"{spec} train: {text}")
        trains.append(case)
    del oracle

    mixes = fault_mix_cases(torch, card)

    # (c) A layer-1 step under the async train's policy, beside ExactMean's.
    policy = dssfn.parse_spec(FAULT_TRAINS[0][0])
    bd = layer_breakdown(torch, xw, tw, exact["w1"], exact["cfg"], policy=policy)
    ex = exact["breakdown"]
    k = TRAIN["K"]
    print(
        f"layer step under {FAULT_TRAINS[0][0]} (M={m}): layer 1 {bd['layer1_ms']:.2f} ms "
        f"(ExactMean {ex['layer1_ms']:.2f}) = propagate_gram {bd['propagate_gram_ms']:.2f} + "
        f"guarded Cholesky {bd['cholesky_ms']:.2f} + A=TY^T {bd['a_ms']:.2f} + {k} ADMM "
        f"iterations ({k // policy.interval} mixes) {bd['admm_ms']:.2f} ms traced, "
        f"{bd['admm_untraced_ms']:.2f} untraced ({bd['admm_untraced_ms'] / k:.3f} ms per "
        f"iteration; ExactMean {ex['admm_untraced_ms'] / k:.3f}); vs CPU plain: o_star gap "
        f"{bd['o_star_gap']:.3e} (card vs float64 {bd['card_f64_gap']:.3e}, CPU f32 vs float64 "
        f"{bd['cpu_f64_gap']:.3e}) on {card}",
        flush=True,
    )
    print(json.dumps({"faults": {
        "card": card, "trains": trains, "mixes": mixes,
        "layer_step": {k: v for k, v in bd.items() if k != "jitter"},
        "exact_layer_step": {k: v for k, v in ex.items() if k != "jitter"}}}), flush=True)
    return launches


# Phase 5e: the elastic-training drills.  Checkpoints every 7 layers, so
# L = 20 saves after layers 6, 13 and 20 (layer_next 7, 14, 21), and the
# kill falls after layer 6.  The divergence drill flags layer 10's first
# attempt, the monitor's 11th call, as repro's test flags layer 2's.
ELASTIC_EVERY = 7
ELASTIC_STOP = 6
ELASTIC_FLAG_LAYER = 10


class CheckpointTimer:
    """Times the port's checkpoint I/O inside the launcher's train: each
    save's host fetch and its ``save_pytree`` (savez and the two fsyncs),
    each resume load (npz read and the copy to the card) and each
    ``latest_checkpoint`` scan (which reads every candidate once to
    validate it), by wrapping the module functions the loop calls.  The
    card is synchronized before each span, so a span holds no queued
    layer work."""

    def __init__(self, torch):
        from repro_torch.checkpoint import store
        from repro_torch.core import layerwise

        self.torch, self.store, self.layerwise = torch, store, layerwise
        self.saves, self.loads, self.scans = [], [], []

    def __enter__(self):
        torch, store, lw = self.torch, self.store, self.layerwise
        self.real = (lw._save_checkpoint, lw._load_checkpoint, lw.latest_checkpoint,
                     store.save_pytree)
        real_save, real_load, real_scan, real_pytree = self.real
        inner = {}

        def save_pytree(path, tree):
            t0 = time.perf_counter()
            real_pytree(path, tree)
            inner["save_ms"] = (time.perf_counter() - t0) * 1e3

        def save_checkpoint(directory, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = real_save(directory, **kw)
            total = (time.perf_counter() - t0) * 1e3
            self.saves.append({
                "layer_next": kw["layer_next"], "path": os.path.basename(path),
                "bytes": os.path.getsize(path) + os.path.getsize(path + ".meta.json"),
                "fetch_ms": total - inner["save_ms"], "save_ms": inner["save_ms"],
                "total_ms": total})
            return path

        def load_checkpoint(path, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_load(path, **kw)
            torch.cuda.synchronize()
            self.loads.append({"path": os.path.basename(path),
                               "ms": (time.perf_counter() - t0) * 1e3,
                               "device": str(out["y_workers"].device)})
            return out

        def latest_checkpoint(directory):
            t0 = time.perf_counter()
            out = real_scan(directory)
            self.scans.append((time.perf_counter() - t0) * 1e3)
            return out

        store.save_pytree = save_pytree
        lw._save_checkpoint, lw._load_checkpoint = save_checkpoint, load_checkpoint
        lw.latest_checkpoint = latest_checkpoint
        return self

    def __exit__(self, *exc):
        lw = self.layerwise
        (lw._save_checkpoint, lw._load_checkpoint, lw.latest_checkpoint,
         self.store.save_pytree) = self.real
        return False


def checkpoint_files(directory: str) -> list[str]:
    return sorted(f for f in os.listdir(directory) if f.endswith(".npz"))


def elastic_slice(torch, np, card: str, exact: dict) -> dict:
    """Phase 5e: (a) the kill/resume drill, (b) the divergence drill,
    (c) the checkpoint's export served beside phase 5's, (d) the
    checkpoint I/O timed.  Returns each kernel's launch count over the
    drills and the serve."""
    import warnings

    from repro_torch.core import layerwise
    from repro_torch.kernels import gram, matmul_relu, propagate_gram
    from repro_torch.launch import serve_dssfn, train_dssfn
    from repro_torch.serve import export_artifact, export_from_checkpoint, load_artifact

    m, layers = TRAIN["M"], TRAIN["L"]
    run_d, dec = exact["run_d"], exact["dec"]
    counters = {"gram": gram, "propagate_gram": propagate_gram, "matmul_relu": matmul_relu}
    launches = dict.fromkeys(counters, 0)

    def drive(fn):
        """fn's result and each kernel's launches, counted from zero."""
        for c in counters.values():
            c.reset_launch_count()
        out = fn()
        counts = {k: c.launch_count() for k, c in counters.items()}
        for k in launches:
            launches[k] += counts[k]
        return out, counts

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)

    ck_flags = ["--checkpoint-every", str(ELASTIC_EVERY)]
    out = {"card": card, "phase5_train_s": run_d["wall_time_s"]}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        # (a) Kill after layer 6, resume in a fresh launcher call.
        ck_a = os.path.join(tmp, "ck_a")
        with CheckpointTimer(torch) as tim_a:
            res1, c1 = drive(lambda: train_dssfn.main(
                train_argv(m, os.path.join(tmp, "part")) + ["--checkpoint-dir", ck_a]
                + ck_flags + ["--stop-after-layer", str(ELASTIC_STOP)]))
            files1 = checkpoint_files(ck_a)
            res2, c2 = drive(lambda: train_dssfn.main(
                train_argv(m, os.path.join(tmp, "resumed")) + ["--checkpoint-dir", ck_a]
                + ck_flags + ["--resume"]))
        files2 = checkpoint_files(ck_a)
        run1, run2 = res1["runs"][0], res2["runs"][0]
        if files1 != ["dssfn_layer_007.npz"] or res1["export"]["num_layers"] + 1 != 7 \
                or (c1["gram"], c1["propagate_gram"]) != (1, ELASTIC_STOP):
            raise AssertionError(f"(a) kill half: files {files1}, "
                                 f"{res1['export']['num_layers'] + 1} readouts, launches {c1}")
        if files2 != ["dssfn_layer_007.npz", "dssfn_layer_014.npz", "dssfn_layer_021.npz"] \
                or (c2["gram"], c2["propagate_gram"]) != (0, layers - ELASTIC_STOP):
            raise AssertionError(f"(a) resume half: files {files2}, launches {c2}")
        if [ld["device"] for ld in tim_a.loads] != ["cuda:0"]:
            raise AssertionError(f"(a) resume restored onto {tim_a.loads}")
        resumed = card_params(torch, os.path.join(tmp, "resumed"))
        o_same, r_same = same(resumed.o, dec.o), same(resumed.r, dec.r)
        if not (o_same and r_same and len(resumed.o) == layers + 1
                and run2["comm_scalars"] == run_d["comm_scalars"]
                and run2["test_accuracy"] == run_d["test_accuracy"]):
            gaps = [float((a - b).abs().max()) for a, b in zip(resumed.o, dec.o)]
            raise AssertionError(
                f"(a) resumed run != phase 5's: readouts equal {o_same} (max abs gaps {gaps}), "
                f"R equal {r_same}, comm {run2['comm_scalars']} vs {run_d['comm_scalars']}, "
                f"accuracy {run2['test_accuracy']} vs {run_d['test_accuracy']}")
        out["kill_resume"] = {
            "kill_train_s": run1["wall_time_s"], "resume_train_s": run2["wall_time_s"],
            "launches_kill": c1, "launches_resume": c2, "files": files2,
            "saves": tim_a.saves, "loads": tim_a.loads, "scans_ms": tim_a.scans,
            "accuracy": run2["test_accuracy"]}
        print(
            f"elastic (a) kill/resume (M={m}, L={layers}, --checkpoint-every {ELASTIC_EVERY}): "
            f"--stop-after-layer {ELASTIC_STOP} {run1['wall_time_s']:.3f} s (wrote {files1}, "
            f"launches {c1}), --resume {run2['wall_time_s']:.3f} s (wrote {files2[1:]}, launches "
            f"{c2}) against phase 5's {run_d['wall_time_s']:.3f} s uninterrupted; all "
            f"{layers + 1} readouts, {layers} R and {run2['comm_scalars']} eq.-15 scalars equal "
            f"phase 5's bit for bit; test accuracy {run2['test_accuracy']:.4f} == "
            f"{run_d['test_accuracy']:.4f} on {card}", flush=True)

        # (b) Flag layer 10's first attempt: roll back to layer 7's checkpoint.
        ck_b = os.path.join(tmp, "ck_b")
        real = layerwise._step_diverged
        calls = {"n": 0}

        def flag(step, prev_cost, blowup=1e3):
            calls["n"] += 1
            return calls["n"] == ELASTIC_FLAG_LAYER + 1 or real(step, prev_cost, blowup)

        layerwise._step_diverged = flag
        try:
            with CheckpointTimer(torch) as tim_b, warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res3, c3 = drive(lambda: train_dssfn.main(
                    train_argv(m, os.path.join(tmp, "healed")) + ["--checkpoint-dir", ck_b]
                    + ck_flags + ["--guard-divergence"]))
        finally:
            layerwise._step_diverged = real
        run3 = res3["runs"][0]
        rolled = [str(w.message) for w in caught if "rolling back" in str(w.message)]
        healed = card_params(torch, os.path.join(tmp, "healed"))
        keep = ELASTIC_EVERY
        if run3["rollbacks"] != 1 or len(rolled) != 1 or "rolling back to layer 7" not in rolled[0]:
            raise AssertionError(f"(b) rollbacks {run3['rollbacks']}, warnings {rolled}")
        if not (same(healed.o[:keep], dec.o[:keep]) and same(healed.r[:keep - 1], dec.r[:keep - 1])
                and not torch.equal(healed.r[keep - 1], dec.r[keep - 1])):
            raise AssertionError(f"(b) O_0..O_{keep - 1} / R_0..R_{keep - 2} not restored "
                                 f"verbatim, or R_{keep - 1} not redrawn")
        if len(healed.o) != layers + 1 or not all(bool(torch.isfinite(o).all()) for o in healed.o):
            raise AssertionError("(b) healed run: missing or non-finite readouts")
        want = (1, ELASTIC_FLAG_LAYER + layers - ELASTIC_EVERY + 1)
        if (c3["gram"], c3["propagate_gram"]) != want:
            raise AssertionError(f"(b) launches {c3}, expected gram/propagate_gram {want}")
        out["rollback"] = {
            "train_s": run3["wall_time_s"], "rollbacks": run3["rollbacks"], "warning": rolled[0],
            "launches": c3, "accuracy": run3["test_accuracy"], "saves": tim_b.saves,
            "loads": tim_b.loads, "scans_ms": tim_b.scans}
        print(
            f"elastic (b) divergence guard: layer {ELASTIC_FLAG_LAYER}'s first attempt flagged; "
            f"{rolled[0]!r}; rollbacks {run3['rollbacks']}; O_0..O_{keep - 1} and "
            f"R_0..R_{keep - 2} equal phase 5's bit for bit, R_{keep - 1} redrawn; "
            f"{run3['wall_time_s']:.3f} s (phase 5 {run_d['wall_time_s']:.3f} s), launches {c3}; "
            f"test accuracy {run3['test_accuracy']:.4f} (phase 5 {run_d['test_accuracy']:.4f}) "
            f"on {card}", flush=True)
        shutil.rmtree(ck_b)

        # (c) Export drill (a)'s checkpoint directory and serve it beside
        # phase 5's readouts exported again.
        art, art5 = os.path.join(tmp, "from_ckpt"), os.path.join(tmp, "phase5")
        export_from_checkpoint(ck_a, art)
        source = load_artifact(art).manifest["source"]
        if not source.endswith("dssfn_layer_021.npz"):
            raise AssertionError(f"(c) export_from_checkpoint took {source}")
        export_artifact(art5, dec)
        served = {}
        for label, path in (("checkpoint", art), ("phase5", art5)):
            logits = os.path.join(tmp, f"{label}_logits.npz")
            argv = ["--artifact", path, "--requests", str(SLICE_REQUESTS), "--request-size", "1",
                    "--batch-bucket", "32", "--max-batch", "32", "--max-wait-us", "200",
                    "--seed", "0", "--save-logits", logits]
            if label == "checkpoint":
                res, c5 = drive(lambda: serve_dssfn.main(argv))
                if res["device"] != "cuda" or res["completed"] != SLICE_REQUESTS \
                        or res["kernel_launches"] != layers * res["batches"] \
                        or c5["matmul_relu"] < res["kernel_launches"]:
                    raise AssertionError(
                        f"(c) served {res['completed']} on {res['device']}: kernel_launches "
                        f"{res['kernel_launches']} for {res['batches']} batches, counted {c5}")
            else:
                serve_dssfn.main(argv)
            with np.load(logits) as z:
                served[label] = (z["requests"], z["logits"])
        (xa, la), (xb, lb) = served["checkpoint"], served["phase5"]
        if not (np.array_equal(xa, xb) and np.array_equal(la, lb) and np.isfinite(la).all()):
            raise AssertionError("(c) the checkpoint's export serves other logits than phase 5's")
        out["export_serve"] = {"source": os.path.basename(source), "batches": res["batches"],
                               "kernel_launches": res["kernel_launches"],
                               "p50_ms": res["latency_ms"]["p50"]}
        print(
            f"elastic (c) export_from_checkpoint -> {os.path.basename(source)}; served "
            f"{SLICE_REQUESTS} requests in {res['batches']} batches of bucket 32, "
            f"{res['kernel_launches']} matmul_relu launches ({layers} a forward); logits equal "
            f"phase 5's artifact's bit for bit on {card}", flush=True)

    # (d) The checkpoint I/O.
    for label, tim in (("(a)", tim_a), ("(b)", tim_b)):
        for sv in tim.saves:
            print(
                f"elastic (d) {label} save {sv['path']}: {sv['bytes']} bytes, host fetch "
                f"{sv['fetch_ms']:.1f} ms, save_pytree (savez + fsync) {sv['save_ms']:.1f} ms "
                f"({sv['bytes'] / sv['save_ms'] / 1e6:.3f} GB/s) on {card}", flush=True)
        for ld in tim.loads:
            print(f"elastic (d) {label} load {ld['path']} onto {ld['device']}: {ld['ms']:.1f} ms; "
                  f"latest_checkpoint scans {['%.1f' % t for t in tim.scans]} ms on {card}",
                  flush=True)
    print(f"elastic (d) trains: kill {run1['wall_time_s']:.3f} s + resume "
          f"{run2['wall_time_s']:.3f} s, guarded with one rollback {run3['wall_time_s']:.3f} s, "
          f"against phase 5's {run_d['wall_time_s']:.3f} s on {card}", flush=True)
    print(json.dumps({"elastic": out}), flush=True)
    return launches


# Phase 5f: MeshBackend over torch.distributed at full width.  W=4 gloo
# ranks of 5 workers each share the one card (NCCL refuses two ranks on
# one card), each rank staging its messages through pinned host memory;
# NCCL runs as one rank holding all 20 workers.  Bars: readouts within
# 1e-4 of the simulated run at layers 0-2 (MESH_GAP, the reference's
# sim-vs-mesh bar, tests/test_multidevice.py:128-131; the deeper layers
# are printed), the equivalence bars, and bit-equal repeats.  The trains
# trace only each layer's last iteration (--trace-every K: its objective
# and consensus error are what the checks read; the iterates do not
# depend on tracing), so an iteration's only collective is its mix.
MESH_RANKS = 4
MESH_GAP = 1e-4
MESH_BAR_LAYERS = 3
MESH_DEPTH = 3          # (b) and (c): depth cut, width full
# (a)'s depth cut.  The launcher draws R_1..R_L from its generator in layer
# order and layer l's solve reads only the layers before it, so a 6-layer
# train's O_0..O_6 are phase 5's 20-layer train's, and phase 5's nets cut
# to their first 6 layers are what (a) is held to.
MESH_DEPTH_A = 6
# (b)'s second mesh run repeats its first layer solves: bit for bit the
# first run's O_0 and O_1.
MESH_REPEAT_DEPTH = 1


def mesh_argv(artifact: str, ranks: int, dist: str, *extra: str) -> list[str]:
    return train_argv(TRAIN["M"], artifact) + [
        "--backend", "mesh", "--ranks", str(ranks), "--dist-backend", dist,
        "--trace-every", str(TRAIN["K"]), *extra]


def rel_gaps(torch, got, want) -> list[float]:
    f64 = torch.float64
    return [float(torch.linalg.vector_norm(a.to(f64) - b.to(f64))
                  / torch.linalg.vector_norm(b.to(f64))) for a, b in zip(got, want)]


def predicted_messages(perms, m: int, ranks: int) -> tuple[int, int]:
    """(point-to-point messages, rows) that crossing a rank boundary takes
    for one mix over ``perms``, summed over the ranks: a rank sends one
    message to each other rank that holds a destination of its rows."""
    block = m // ranks
    msgs = rows = 0
    for perm in perms:
        pairs = [(s // block, d // block) for s, d in perm if s // block != d // block]
        msgs += len(set(pairs))
        rows += len(pairs)
    return msgs, rows


def mesh_slice(torch, np, card: str, exact: dict) -> dict:
    """Phase 5f: (a) ExactMean under --backend mesh on 4 gloo ranks,
    6 layers; (b) the paper's gossip on the same ranks, 3 layers, beside
    the simulated run, and its first layer again; (c) one NCCL rank
    holding all 20 workers;
    (d) (a)'s stack served and drilled; (e) where the time goes.  Returns
    each kernel's launches over the phase."""
    from repro_torch.core import equivalence, layerwise, ssfn, topology
    from repro_torch.core.policy import RingGossip
    from repro_torch.kernels import matmul_relu
    from repro_torch.launch import train_dssfn
    from repro_torch import serve

    m, q, k, layers = TRAIN["M"], TRAIN["Q"], TRAIN["K"], TRAIN["L"]
    run_d, dec, cen, data = (exact[x] for x in ("run_d", "dec", "cen", "data"))
    launches = {"gram": 0, "propagate_gram": 0, "matmul_relu": 0}
    out = {"card": card, "ranks": MESH_RANKS}

    def count(label, run, ranks, depth):
        got = run["kernel_launches"]
        if got["gram"] != ranks or got["propagate_gram"] != ranks * depth:
            raise AssertionError(f"5f{label}: kernel launches {got} summed over {ranks} "
                                 f"rank(s); expected {ranks} gram, {ranks * depth} "
                                 "propagate_gram")
        for key in launches:
            launches[key] += got[key]

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        # (a) ExactMean, MESH_DEPTH_A layers, 4 gloo ranks on the card.
        depth_a = MESH_DEPTH_A
        dec_a = ssfn.SSFNParams(o=dec.o[:depth_a + 1], r=dec.r[:depth_a])
        cen_a = ssfn.SSFNParams(o=cen.o[:depth_a + 1], r=cen.r[:depth_a])
        path_a = os.path.join(tmp, "mesh_exact")
        res = train_dssfn.main(mesh_argv(path_a, MESH_RANKS, "gloo", "--layers", str(depth_a)))
        run = res["runs"][0]
        count("(a)", run, MESH_RANKS, depth_a)
        params = card_params(torch, path_a)
        if not all(bool(torch.isfinite(o).all()) for o in params.o):
            raise AssertionError("5f(a): non-finite readouts")
        gaps = rel_gaps(torch, params.o, dec_a.o)
        if not max(gaps[:MESH_BAR_LAYERS]) <= MESH_GAP:
            raise AssertionError(f"5f(a) readouts vs phase 5's simulated run: {gaps[:3]} "
                                 f"> {MESH_GAP} at layers 0-2")
        # Eq. 15 counts K Q n_l scalars a layer: phase 5's less its last layers.
        want_comm = run_d["comm_scalars"] * (TRAIN["P"] + depth_a * TRAIN["n"]) \
            // (TRAIN["P"] + layers * TRAIN["n"])
        if run["comm_scalars"] != want_comm:
            raise AssertionError(f"5f(a) eq.-15 scalars {run['comm_scalars']} != {want_comm}, "
                                 f"phase 5's over its first {depth_a} layers")
        rep = equivalence.compare(cen_a, params, data.x_test, q)
        acc_cen = layerwise.accuracy(cen_a, data.x_test, data.y_test, q)
        acc_gap = abs(run["test_accuracy"] - acc_cen)
        check_equivalence("5f(a)", rep, acc_gap)
        print(f"5f(a) {run['backend']}, {depth_a} layers: {run['wall_time_s']:.3f} s (phase 5's "
              f"{layers} {run_d['wall_time_s']:.3f} s), launches {run['kernel_launches']} summed "
              f"over {run['ranks']} ranks, collectives {run['collective_counts']}; readout gaps "
              f"to phase 5's simulated run by layer {['%.2e' % g for g in gaps]}; test accuracy "
              f"{run['test_accuracy']:.4f}; against phase 5's centralized run cut to "
              f"{depth_a} layers agreement {rep.agreement:.4f}, accuracy gap {acc_gap:.4f}; "
              f"eq.-15 scalars {run['comm_scalars']} == phase 5's over those layers on {card}",
              flush=True)
        out["a"] = {"wall_s": run["wall_time_s"], "gaps": gaps, "agreement": rep.agreement,
                    "acc_gap": acc_gap, "test_accuracy": run["test_accuracy"],
                    "kernel_launches": run["kernel_launches"],
                    "collective_counts": run["collective_counts"],
                    "collective_bytes": run["collective_bytes"], "per_rank": run["per_rank"]}

        # (b) The paper's gossip network, 3 layers: the simulated run,
        # then the mesh, then the mesh's first layer solves again.
        rounds = topology.gossip_rounds_for_tolerance(
            topology.circular_mixing_matrix(m, GOSSIP_DEGREE), GOSSIP_TOL)
        spec = f"gossip:{rounds}:{GOSSIP_DEGREE}"
        perms = RingGossip(rounds, GOSSIP_DEGREE)._compressed_schedule_or_none(m).perms
        msgs_mix, rows_mix = predicted_messages(perms, m, MESH_RANKS)
        gossip = ["--layers", str(MESH_DEPTH), "--consensus", spec,
                  "--trace-every", str(k)]
        path_s = os.path.join(tmp, "sim_gossip")
        run_s = train_dssfn.main(train_argv(m, path_s) + gossip)["runs"][0]
        count("(b) simulated", run_s, 1, MESH_DEPTH)
        runs_b = []
        for i, depth in enumerate((MESH_DEPTH, MESH_REPEAT_DEPTH)):
            path = os.path.join(tmp, f"mesh_gossip_{i}")
            run_b = train_dssfn.main(mesh_argv(path, MESH_RANKS, "gloo", *gossip,
                                               "--layers", str(depth)))["runs"][0]
            count(f"(b) mesh {i + 1}", run_b, MESH_RANKS, depth)
            runs_b.append((run_b, card_params(torch, path)))
        (run_b, params_b), (run_b2, params_b2) = runs_b
        gaps_b = rel_gaps(torch, params_b.o, card_params(torch, path_s).o)
        if not max(gaps_b) <= MESH_GAP:
            raise AssertionError(f"5f(b) mesh vs simulated readouts {gaps_b}")
        if not (len(params_b2.o) == MESH_REPEAT_DEPTH + 1
                and all(torch.equal(a, b) for a, b in zip(params_b.o, params_b2.o))):
            raise AssertionError("5f(b) the second mesh run differs from the first")
        mixes = k * (MESH_DEPTH + 1)
        permutes = MESH_RANKS * mixes * len(perms)
        # Layer 0's messages are Q x P, the later layers' Q x n, f32.
        want_bytes = k * rows_mix * q * 4 * (TRAIN["P"] + MESH_DEPTH * TRAIN["n"])
        if (run_b["messages"] != mixes * msgs_mix
                or run_b["collective_counts"].get("collective-permute") != permutes
                or run_b["collective_bytes"].get("collective-permute") != want_bytes):
            raise AssertionError(
                f"5f(b) {run_b['messages']} messages, {run_b['collective_counts']}, "
                f"{run_b['collective_bytes']} over {mixes} mixes; the schedule predicts "
                f"{msgs_mix} messages a mix, {permutes} permutes, {want_bytes} bytes")
        cerr = consensus_errors(run_b["consensus_error"], params_b.o)
        print(f"5f(b) {spec} on {MESH_RANKS} gloo ranks, {MESH_DEPTH} layers: mesh "
              f"{run_b['wall_time_s']:.3f} s and {run_b2['wall_time_s']:.3f} s "
              f"({MESH_REPEAT_DEPTH} layer), simulated "
              f"{run_s['wall_time_s']:.3f} s; readout gaps {['%.2e' % g for g in gaps_b]}; "
              f"final consensus error <= {cerr:.3e} x max|O_l|; {len(perms)} hops a mix, "
              f"{msgs_mix} cross-rank messages ({rows_mix} rows) a mix as the schedule "
              f"predicts, {want_bytes} bytes in all; the repeat's readouts bit-equal to the "
              f"first run's on {card}", flush=True)
        out["b"] = {"wall_s": [run_b["wall_time_s"], run_b2["wall_time_s"]],
                    "sim_wall_s": run_s["wall_time_s"], "gaps": gaps_b, "cerr": cerr,
                    "hops": len(perms), "messages_per_mix": msgs_mix,
                    "rows_per_mix": rows_mix, "per_rank": run_b["per_rank"]}

        # (c) NCCL: one rank holding all 20 workers, ExactMean, 3 layers.
        res_c = train_dssfn.main(mesh_argv(os.path.join(tmp, "mesh_nccl"), 1, "nccl",
                                           "--layers", str(MESH_DEPTH)))
        run_c3 = res_c["runs"][0]
        count("(c)", run_c3, 1, MESH_DEPTH)
        params_c = card_params(torch, os.path.join(tmp, "mesh_nccl"))
        gaps_c = rel_gaps(torch, params_c.o, dec.o[:MESH_DEPTH + 1])
        n_ar = run_c3["collective_counts"].get("all-reduce", 0)
        # A mix an iteration, and the two trace sums at each layer's last.
        if not (max(gaps_c) <= MESH_GAP and n_ar == (k + 2) * (MESH_DEPTH + 1)
                and "transport=nccl" in run_c3["backend"]):
            raise AssertionError(f"5f(c) {run_c3['backend']}: gaps {gaps_c}, "
                                 f"{n_ar} NCCL all-reduces")
        print(f"5f(c) {run_c3['backend']}: {run_c3['wall_time_s']:.3f} s, {n_ar} NCCL "
              f"all-reduces (a mix an iteration, two trace sums a layer), "
              f"{run_c3['collective_counts']}; readout gaps to phase 5's "
              f"{['%.2e' % g for g in gaps_c]} on {card}", flush=True)
        out["c"] = {"wall_s": run_c3["wall_time_s"], "gaps": gaps_c,
                    "collective_counts": run_c3["collective_counts"]}

        # (d) (a)'s stack served: the net it trained (bit for bit its own
        # ssfn.predict, and its float64 forward within STACK_TOL), and the
        # logits of phase 5's net cut to (a)'s depth off by what the two
        # runs' readouts make them differ in float64, within STACK_TOL more.  Then the drill's mesh
        # leg on the card.
        xb = data.x_test[:, :32].contiguous()
        engine = serve.ServeEngine(serve.load_artifact(path_a), buckets=(32,))
        engine.forward(np.zeros((TRAIN["P"], 32), np.float32))
        torch.cuda.synchronize()
        matmul_relu.reset_launch_count()
        logits = engine.forward(xb.cpu())
        torch.cuda.synchronize()
        n_fwd = matmul_relu.launch_count()
        own = ssfn.predict(params, xb, q)
        x64 = xb.double().cpu().numpy()
        f64_mesh = forward_f64(np, [o.cpu().numpy() for o in params.o],
                               [r.cpu().numpy() for r in params.r], x64)
        f64_dec = forward_f64(np, [o.cpu().numpy() for o in dec_a.o],
                              [r.cpu().numpy() for r in dec_a.r], x64)
        got = logits.double().cpu().numpy()
        scale = float(np.abs(f64_dec).max())
        err_own = float(np.abs(got - f64_mesh).max())
        err_dec = float(np.abs(got - f64_dec).max())
        trained = float(np.abs(f64_mesh - f64_dec).max())
        if not (n_fwd == depth_a and torch.equal(logits.to(own.device), own)
                and err_own <= STACK_TOL * scale
                and err_dec <= trained + STACK_TOL * scale):
            raise AssertionError(
                f"5f(d) {n_fwd} launches; logits vs float64 {err_own:.3e}, vs phase 5's "
                f"{err_dec:.3e} where the readouts account for {trained:.3e} (max {scale:.3e})")
        cpu_rt, _, cpu_entries = chaos_drill(
            np, serve, serve.ServeEngine(serve.load_artifact(path_a), buckets=(32,),
                                         device="cpu"))
        matmul_relu.reset_launch_count()
        rt, _, entries = chaos_drill(np, serve, engine)
        n_drill = matmul_relu.launch_count()
        sd = rt.snapshot()["stats"]
        kinds = [e["kind"] for e in rt.events]
        if (sd != cpu_rt.snapshot()["stats"]
                or kinds != [x["kind"] for x in cpu_rt.events if x["kind"] != "degrade"]
                or [h.status for _, h in entries] != [h.status for _, h in cpu_entries]
                or n_drill != depth_a * sd["batches"]):
            raise AssertionError(f"5f(d) card drill {sd}, {n_drill} launches; CPU drill "
                                 f"{cpu_rt.snapshot()['stats']}")
        launches["matmul_relu"] += n_fwd + n_drill
        print(f"5f(d) (a)'s stack served: {n_fwd} matmul_relu launches a forward, logits "
              f"bit-equal to its ssfn.predict, {err_own / scale:.3e} x max from its float64 "
              f"forward, {err_dec / scale:.3e} x max from phase 5's (its readouts alone "
              f"{trained / scale:.3e}); the drill's "
              f"mesh leg: {sd['completed']} completed in {sd['batches']} batches, "
              f"{n_drill} launches, stats and outcomes equal to the CPU drill's on {card}",
              flush=True)
        out["d"] = {"logit_gap_f64": err_own / scale, "logit_gap_phase5": err_dec / scale,
                    "readouts_account": trained / scale, "drill": sd}

    # (e) Where the time goes: per rank of (a) and (b), its train, that
    # train over its (L+1) K iterations, and the host time inside the
    # transport, with the part each staged copy spent waiting for the
    # card's queue; beside phase 5's train (traced every iteration) and
    # its layer-1 ADMM.
    bd = exact["breakdown"]
    print(f"5f(e) phase 5 simulated: {run_d['wall_time_s'] / ((layers + 1) * k) * 1e3:.3f} "
          f"ms an iteration (train over its {(layers + 1) * k}), layer-1 ADMM "
          f"{bd['admm_ms'] / k:.3f} ms traced, {bd['admm_untraced_ms'] / k:.3f} untraced; "
          f"(b)'s simulated train {out['b']['sim_wall_s'] / ((MESH_DEPTH + 1) * k) * 1e3:.3f} "
          f"ms an iteration on {card}", flush=True)
    for label, depth in (("a", depth_a), ("b", MESH_DEPTH)):
        iters = (depth + 1) * k
        for r in out[label]["per_rank"]:
            print(f"5f(e) ({label}) rank {r['rank']}: train {r['wall_time_s']:.3f} s, "
                  f"{r['wall_time_s'] / iters * 1e3:.3f} ms an ADMM iteration (train over its "
                  f"{iters}); in the transport {r['transport_host_s'] / iters * 1e3:.3f} ms "
                  f"an iteration, of it {r['transport_sync_s'] / iters * 1e3:.3f} waiting "
                  f"for the card before a staged copy; {r['messages']} point-to-point "
                  f"messages on {card}", flush=True)
    print(json.dumps({"mesh": out}), flush=True)
    return launches


# Phase 5g: the port's spmdlint (repro_torch.analysis, launch/lint_dssfn.py).
# (a) runs the CLI over the whole grammar as a user would, its wire probe
# on 8 gloo ranks sharing the card; (b) records layer 1's fused step at
# Table-I width (phase 5's inputs) under two policies; (c) holds phase 4's
# serving stack to the serve contract in f32, and its bf16 twin to the
# numerics rule's mutation.  PERF.md §6 row 1's bucket times before the
# kernels' recorder hook (measured on one H100), beside phase 2's now.
LINT_SPECS = ("exact", "gossip:3:wire=bf16")
LINT_BUCKETS = (1, 32)
ROW1_US = {1: 5.01, 128: 12.85}


def lint_slice(torch, np, card: str, exact: dict, cases: list) -> dict:
    """Phase 5g: (a) ``lint_dssfn --all-grammar --device cuda`` as a
    subprocess, zero findings; (b) numerics of layer 1's fused step at
    full width under ExactMean and a bf16-wire gossip, one
    ``propagate_gram`` record each accumulating in f32 and every
    factorization guarded, zero findings; (c) ``check_serve_contract`` on
    phase 4's stack, f32 zero findings with 20 ``matmul_relu`` records a
    bucket and ``cache_info()`` unchanged, bf16 ``numerics-accum``; (d) a
    ``{"lint": ...}`` line.  Returns the in-process launches."""
    from repro_torch import analysis, dssfn
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import engine
    from repro_torch.core.backend import SimulatedBackend
    from repro_torch.kernels import gram, matmul_relu, propagate_gram
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.export import ARTIFACT_VERSION, ServeArtifact

    out: dict = {"card": card}
    for mod in (gram, propagate_gram, matmul_relu):
        mod.reset_launch_count()

    # (a) The CLI, every check over every grammar entry, on the card.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint_dssfn", "--all-grammar",
         "--device", "cuda", "--format", "json"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"5g(a) lint_dssfn exit {proc.returncode}:\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    if report["count"] != 0:
        raise AssertionError(f"5g(a) lint_dssfn findings: {report['findings']}")
    out["a"] = {"wall_s": wall, "count": report["count"],
                "specs": len(analysis.ALL_GRAMMAR),
                "wire_specs": len(analysis.grammar_specs(wire_only=True))}
    print(f"5g(a) lint_dssfn --all-grammar --device cuda: exit 0, {report['count']} findings "
          f"over {len(analysis.ALL_GRAMMAR)} specs (wire probe on 8 gloo ranks sharing the "
          f"card) in {wall:.2f} s on {card}", flush=True)

    # (b) Layer 1's fused step at Table-I width, recorded.
    cfg, xw, tw, w1 = exact["cfg"], exact["xw"], exact["tw"], exact["w1"]
    out["b"] = {}
    for spec in LINT_SPECS:
        policy = dssfn.parse_spec(spec)
        t0 = time.perf_counter()
        with analysis.recording() as record:
            step = engine.fused_layer_step(
                SimulatedBackend(xw.shape[0], policy=policy), xw.contiguous(), tw, w1,
                mu=cfg.mul, eps_radius=cfg.eps_radius, num_iters=cfg.admm_iters)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        found = analysis.lint_record(record, subject=spec)
        kernels = record.kernels()
        guarded = [c.guarded for c in record.calls
                   if c.name in analysis.numerics.FACTORIZATIONS]
        if found:
            raise AssertionError(f"5g(b) {spec}: findings {found}")
        if [(k.name, k.accum_dtype) for k in kernels] != [("kernel:propagate_gram", "f32")]:
            raise AssertionError(f"5g(b) {spec}: kernel records {kernels}")
        if not guarded or not all(guarded):
            raise AssertionError(f"5g(b) {spec}: factorizations guarded {guarded}")
        if not bool(torch.isfinite(step.o_star).all()):
            raise AssertionError(f"5g(b) {spec}: non-finite o_star")
        counts = record.counts()
        out["b"][spec] = {"wall_s": wall, "calls": len(record.calls), "counts": counts,
                          "kernel": kernels[0].render(), "factorizations": len(guarded)}
        print(f"5g(b) layer 1 (M={xw.shape[0]}, n={w1.shape[0]}, J_m={xw.shape[2]}, "
              f"K={cfg.admm_iters}) under {spec}: 0 findings, {len(record.calls)} calls "
              f"recorded, {kernels[0].render()}, {len(guarded)} factorization(s) all under "
              f"guarded_cholesky, recorded step {wall:.3f} s on {card}", flush=True)
        del step, record

    # (c) Phase 4's stack against the serve contract.
    o_list, r_list = random_stack(np)

    def stack_engine(dtype):
        artifact = ServeArtifact(
            params=params_from_numpy(o_list, r_list, device="cpu"),
            num_classes=SLICE["Q"], input_dim=SLICE["P"], activation="relu", features=None,
            version=ARTIFACT_VERSION, manifest={"source": "chip_smoke phase 5g"})
        return ServeEngine(artifact, buckets=LINT_BUCKETS, dtype=dtype)

    eng = stack_engine(torch.float32)
    eng.forward(torch.zeros(SLICE["P"], 2))
    before = eng.cache_info()
    records = {}
    for bucket in LINT_BUCKETS:
        kernels = eng.lowering_texts(bucket=bucket)["program"].kernels()
        records[bucket] = len(kernels)
        if [k.name for k in kernels] != ["kernel:matmul_relu"] * SLICE["L"] or any(
                k.accum_dtype != "f32" for k in kernels):
            raise AssertionError(f"5g(c) bucket {bucket}: kernel records {kernels}")
    t0 = time.perf_counter()
    found = analysis.check_serve_contract(eng, subject="serve:table-i")
    wall_f32 = time.perf_counter() - t0
    if found or eng.cache_info() != before:
        raise AssertionError(f"5g(c) f32: findings {found}, cache_info {before} -> "
                             f"{eng.cache_info()}")
    t0 = time.perf_counter()
    found16 = analysis.check_serve_contract(stack_engine(torch.bfloat16),
                                            subject="serve:table-i-bf16", buckets=(1,))
    wall_bf16 = time.perf_counter() - t0
    if sorted({f.check for f in found16}) != ["numerics-accum"]:
        raise AssertionError(f"5g(c) bf16: expected numerics-accum, got {found16}")
    out["c"] = {"f32_findings": 0, "kernel_records": records, "cache_info": before,
                "wall_f32_s": wall_f32, "bf16_checks": sorted({f.check for f in found16}),
                "bf16_ops": sorted({f.details["op"] for f in found16}), "wall_bf16_s": wall_bf16}
    print(f"5g(c) serve contract, Table-I stack, buckets {list(LINT_BUCKETS)}: f32 0 findings, "
          f"{records} matmul_relu records by bucket (accumulating f32), cache_info unchanged, "
          f"{wall_f32:.3f} s; bf16: {out['c']['bf16_checks']} on {out['c']['bf16_ops']}, "
          f"{wall_bf16:.3f} s on {card}", flush=True)

    # (d) Phase 2's bucket times, now with the recorder hook in every
    # wrapper, beside PERF.md §6 row 1's.
    by_key = {c["key"]: c for c in cases}
    out["matmul_relu_us"] = {
        b: {"now": by_key[((1020, 1020), b, "float32")]["ms"] * 1e3, "row1": ROW1_US[b]}
        for b in ROW1_US}
    launches = {"gram": gram.launch_count(), "propagate_gram": propagate_gram.launch_count(),
                "matmul_relu": matmul_relu.launch_count()}
    out["launches"] = launches
    for b, v in out["matmul_relu_us"].items():
        print(f"5g(d) matmul_relu w(1020,1020) bucket {b} f32 with the recorder hook: "
              f"{v['now']:.2f} us (PERF.md row 1 before it: {v['row1']:.2f} us) on {card}",
              flush=True)
    print(json.dumps({"lint": out}, default=str), flush=True)
    return launches


# flash_attention at the full-width H2O-Danube3-4B attention (32 heads of
# 120 over 8 KV heads, window 4096; also with KV at 32 heads, the earlier
# slices' headline), Zamba2-2.7B's shared attention (32 heads of 80), and
# the attention of phases 12-14 as their scoring forwards launch it:
# Phi-3.5-MoE (32 heads of 128 over 8, full causal), Mixtral-8x22B (48 of
# 128 over 8, window 4096), InternVL2-1B (14 of 64 over 2: a group of 7)
# and MusicGen-medium (B=2, 24 heads of 64, S=1500), in bf16 and, where
# the f32 checks launch it, f32, and the frozen Danube of phase 16(d)
# (B=2, S=2048): (B, H, H_kv, S, hd, window, dtype).
FLASH_CASES = [(1, 32, 32, 8192, 120, 4096, "bfloat16"),
               (1, 32, 8, 8192, 120, 4096, "bfloat16"),   # what the model launches
               (1, 32, 32, 4096, 120, 4096, "bfloat16"),
               (1, 32, 32, 8192, 120, 4096, "float32"), (1, 32, 32, 4096, 120, 4096, "float32"),
               (1, 32, 32, 4100, 120, 4096, "bfloat16"), (2, 8, 8, 77, 80, None, "float32"),
               (1, 32, 32, 8192, 80, 4096, "bfloat16"),   # Zamba2-2.7B's shared attention
               (1, 32, 8, 8192, 128, None, "bfloat16"), (1, 32, 8, 8192, 128, None, "float32"),
               (1, 48, 8, 8192, 128, 4096, "bfloat16"),
               (1, 14, 2, 8192, 64, None, "bfloat16"), (1, 14, 2, 8192, 64, None, "float32"),
               (2, 24, 24, 1500, 64, None, "bfloat16"), (2, 24, 24, 1500, 64, None, "float32"),
               (2, 32, 8, 2048, 120, 4096, "bfloat16")]
FLASH_HEADLINE = (1, 32, 32, 8192, 120, 4096, "bfloat16")
# flash_attention tolerance, per element: |kernel - plain| <= rel |plain|
# + 1e-5 max|plain|.  The second term is f32's (KERNEL_TOL: sums in other
# orders).  bf16 adds rel = 2**-7: both versions round one f32 result to
# bf16, so an element whose f32 values straddle a rounding boundary may
# differ by one bf16 ulp, at most 2**-7 of its size.  Held per element,
# not against max|plain|: past the first rows an output averages over
# thousands of keys and is some 100x smaller than max|plain|, so a global
# bf16 limit would pass a dropped or mis-weighted KV tile there.
FLASH_REL = {"float32": 0.0, "bfloat16": 2.0**-7}


def flash_excess(got, want, dtype: str) -> tuple[float, float, float]:
    """(max|got - want|, its floor 1e-5 max|want|, max over elements of
    |got - want| - allowed): the last is <= 0 when every element passes."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    floor = KERNEL_TOL["float32"] * want.abs().max().item()
    excess = (diff - FLASH_REL[dtype] * want.abs()).max().item() - floor
    return diff.max().item(), floor, excess


def attended_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs a causal (sliding-window) attention computes:
    query q sees min(q + 1, window) keys."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_ops(b: int, h: int, s: int, hd: int, window) -> float:
    """4 hd operations per attended pair: 2 hd for q.k, 2 hd for p v."""
    return 4.0 * hd * b * h * attended_pairs(s, window)


def flash_bound(b: int, h: int, h_kv: int, s: int, hd: int, window,
                dtype: str) -> tuple[float, str]:
    """q and the H_kv heads of k and v read once, the output written once;
    :func:`flash_ops` at the peak rate of the inputs' type (bf16: tensor
    cores)."""
    return roofline(flash_ops(b, h, s, hd, window),
                    2 * b * (h + h_kv) * s * hd * elem_bytes(dtype), dtype)


def time_calls(torch, fn, iters: int) -> float:
    """Device ms per call: CUDA events around ``iters`` back-to-back calls
    after one warm-up call.  For calls of a millisecond or more the host's
    launch cost hides behind the queued work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_kernel_cases(torch):
    """flash_attention at the inference slice's shapes, each held against
    its plain version, launched twice for bit-identity (bf16), and timed
    beside its plain version, beside one library call
    (``scaled_dot_product_attention``, with ``enable_gqa`` where KV has
    fewer heads) and beside its bound."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for b, h, h_kv, s, hd, window, dt in FLASH_CASES:
        shape = f"({b},{h},{s},{hd}) KV heads {h_kv} window {window} {dt}"
        q = torch.randn((b, h, s, hd), generator=gen, device="cuda").to(dtypes[dt])
        k, v = (torch.randn((b, h_kv, s, hd), generator=gen, device="cuda").to(dtypes[dt])
                for _ in range(2))
        got = flash_attention_cuda(q, k, v, window=window)
        want = flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        err, floor, excess = flash_excess(got, want, dt)
        tol = f"{FLASH_REL[dt]:.3e} |plain| + {floor:.3e}"
        if got.shape != q.shape or got.dtype != q.dtype or not excess <= 0.0:
            raise AssertionError(
                f"flash_attention {shape}: an element exceeds |kernel - plain| <= {tol} by "
                f"{excess:.3e}"
            )
        if dt == "bfloat16" and not torch.equal(got, flash_attention_cuda(q, k, v,
                                                                          window=window)):
            raise AssertionError(f"flash_attention {shape}: two launches differ")
        del got, want
        gqa = {"enable_gqa": True} if h_kv != h else {}
        if window is None or window >= s:   # the window masks nothing
            def library(q=q, k=k, v=v, gqa=gqa):
                return sdpa(q, k, v, is_causal=True, **gqa)
        else:
            pos = torch.arange(s, device="cuda")
            allowed = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)

            def library(q=q, k=k, v=v, allowed=allowed, gqa=gqa):
                return sdpa(q, k, v, attn_mask=allowed, **gqa)
        big = s >= 4096
        ms = time_calls(torch, lambda: flash_attention_cuda(q, k, v, window=window),
                        5 if big else 50)
        plain_ms = time_calls(torch, lambda: flash_attention_ref(q, k, v, window=window),
                              2 if big else 50)
        library_ms = time_calls(torch, library, 5 if big else 50)
        bound_ms, bound_by = flash_bound(b, h, h_kv, s, hd, window, dt)
        f32_ms, _ = flash_bound(b, h, h_kv, s, hd, window, "float32")
        tflops = flash_ops(b, h, s, hd, window) / ms / 1e9
        cases.append({
            "shape": shape, "key": (b, h, h_kv, s, hd, window, dt), "max_abs_err": err,
            "tolerance": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
            "tflops": tflops, "f32_simt_bound_ms": f32_ms,
            "attended_pairs_per_head": attended_pairs(s, window),
        })
        print(
            f"flash_attention {shape}: err {err:.3e} (tol {tol} per element"
            f"{', bit-identical on two launches' if dt == 'bfloat16' else ''}) kernel {ms:.3f} "
            f"ms ({tflops:.1f} TFLOP/s, {bound_ms / ms:.1%} of its bound) plain {plain_ms:.3f} "
            f"ms library (SDPA) {library_ms:.3f} ms bound {bound_ms:.3f} ms ({bound_by}, {dt} "
            f"peak; {f32_ms:.3f} ms at the f32 CUDA-core peak)",
            flush=True,
        )
        del q, k, v, library
        torch.cuda.empty_cache()
    return cases


# The inference slice: H2O-Danube3-4B (arXiv:2401.16818) at its published
# widths and all 24 layers; only the number of requests and the generated
# length are cut.
INFER = {"arch": "h2o_danube3_4b", "score_seq": 8192, "serve_batch": 2,
         "prompt": 4608, "gen": 16, "seed": 0}
# (b) f32 logits, kernel route vs the plain chunked route: each of the 24
# layers' attention sums up to 4096 terms in another order (a disagreement
# of order sqrt(4096) 2**-24 ~ 4e-6 of its output), and the residual
# stream carries it through the later layers; 1e-3 x max|logits| leaves a
# wide margin over that and still fails any masking or indexing fault,
# which moves logits by O(1).
ROUTE_TOL = 1e-3
# (d) f32 prefill (chunked attention) and decode (dense attention over the
# ring cache) against the forward through the kernel: three summation
# orders of the same f32 math, as (b); test_arch_smoke.py holds the reduced
# model to 1e-3 on logits of the same O(1-5) size.
DECODE_TOL = 1e-3


def timed_forward(torch, model, params, batch) -> float:
    """ms of one forward on the card's timeline (CUDA events)."""
    with torch.no_grad():
        _, ms = timed(torch, lambda: model.forward(params, batch))
    return ms


def op_shares(torch, model, params, batch, names) -> tuple[float, dict]:
    """(forward ms, {op: (ms inside it, calls)}): one forward on the card's
    timeline, with CUDA events around the whole and around each call of
    each op in ``names`` made in it: a name is an attribute of
    ``models.blocks``, or a (module, attribute) pair."""
    from repro_torch.models import blocks

    where = {}
    for item in names:
        module, name = (blocks, item) if isinstance(item, str) else item
        where[name] = module
    ops = {name: getattr(module, name) for name, module in where.items()}
    spans = {name: [] for name in where}

    def timed_op(name):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = ops[name](*args, **kwargs)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    for name, module in where.items():
        setattr(module, name, timed_op(name))
    try:
        fwd_ms = timed_forward(torch, model, params, batch)
    finally:
        for name, op in ops.items():
            setattr(where[name], name, op)
    return fwd_ms, {name: (sum(a.elapsed_time(b) for a, b in spans[name]), len(spans[name]))
                    for name in where}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def inference_slice(torch, np, card: str) -> int:
    """Score, serve and check the full-width model; returns the scoring
    forward's flash_attention launch count (the main path)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.steps import make_loss_fn, make_serve_step

    cfg = dataclasses.replace(get_config(INFER["arch"]), use_pallas_kernels=True)
    s = INFER["score_seq"]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(INFER["seed"]))
    stream = iter(TokenStream(cfg.vocab_size, s, 1, seed=INFER["seed"]))
    host = next(stream)
    batch = {k: torch.as_tensor(a, device="cuda") for k, a in host.items()}
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV heads of "
          f"{cfg.hd}, window {cfg.window}, {cfg.dtype}", flush=True)

    # (a) The main path: the scoring forward through the kernel.
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    with torch.no_grad():
        loss = make_loss_fn(model)(params, batch)
    torch.cuda.synchronize()
    main_launches = fa.launch_count()
    loss = float(loss)
    if main_launches != cfg.num_layers or not np.isfinite(loss):
        raise AssertionError(f"scoring forward: {main_launches} flash_attention launches "
                             f"(expected {cfg.num_layers}), loss {loss}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms, shares = op_shares(torch, model, params, batch, ("flash_attention",))
    attn_ms, calls = shares["flash_attention"]
    plain_model = build_model(dataclasses.replace(cfg, use_pallas_kernels=False))
    plain_fwd_ms = timed_forward(torch, plain_model, params, batch)
    print(
        f"(a) scoring forward B=1 S={s} bf16: loss {loss:.4f}, {main_launches} flash_attention "
        f"launches, peak {peak_gb:.2f} GB; {fwd_ms:.3f} ms (CUDA events) = "
        f"flash_attention {attn_ms:.3f} ms over {calls} calls ({attn_ms / fwd_ms:.1%}, CUDA "
        f"events around each call in this forward) + the rest {fwd_ms - attn_ms:.3f} ms; "
        f"through the plain chunked attention {plain_fwd_ms:.3f} ms",
        flush=True,
    )

    # (c) Serving through the launcher's entry point: prefill and decode
    # take the plain attention, as in the reference, so no kernel launches.
    fa.reset_launch_count()
    res = serve.serve(INFER["arch"], batch=INFER["serve_batch"], prompt_len=INFER["prompt"],
                      gen_len=INFER["gen"], reduced=False, seed=INFER["seed"])
    toks = res["tokens"]
    if res["device"] != "cuda" or toks.shape != (INFER["serve_batch"], INFER["gen"]) \
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"serve: tokens {toks.shape} on {res['device']}")
    print(f"(c) serve B={INFER['serve_batch']} prompt {INFER['prompt']} (window {cfg.window}: "
          f"the ring wraps) gen {INFER['gen']} bf16: prefill {res['prefill_s']:.3f} s, decode "
          f"{res['decode_tokens_per_s']:.1f} tok/s ({res['decode_s']:.3f} s), "
          f"{fa.launch_count()} flash_attention launches", flush=True)
    del params
    torch.cuda.empty_cache()

    # (b) f32: the kernel route against the plain chunked route.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(INFER["seed"]))
    plain32 = build_model(dataclasses.replace(cfg32, use_pallas_kernels=False))
    with torch.no_grad():
        routed, _ = model32.forward(params32, {"tokens": batch["tokens"]})
        plain, _ = plain32.forward(params32, {"tokens": batch["tokens"]})
    err, scale = max_err(routed, plain)
    del routed, plain
    if not err <= ROUTE_TOL * scale:
        raise AssertionError(f"(b) f32 logits, kernel vs plain route: {err:.3e} > "
                             f"{ROUTE_TOL} x {scale:.3e}")
    print(f"(b) f32 forward S={s}: logits kernel route vs plain chunked route max abs err "
          f"{err:.3e} (max|logits| {scale:.3e}, tol {ROUTE_TOL} x max)", flush=True)

    # (d) f32 prefill + greedy decode against the f32 forward through the
    # kernel over the prompt and the generated tokens.
    bsz, n0, gen = INFER["serve_batch"], INFER["prompt"], INFER["gen"]
    prompt = torch.as_tensor(
        np.random.default_rng(INFER["seed"]).integers(0, cfg.vocab_size, (bsz, n0)),
        device="cuda")
    step = make_serve_step(model32)
    enqueue, total = [], []      # host ms until a step returns / until the card ran it
    with torch.no_grad():
        logits, cache = model32.prefill(params32, {"tokens": prompt}, max_len=n0 + gen)
        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1)
        seq = [tok]
        for _ in range(gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, logits, cache = step(params32, {"tokens": tok.reshape(bsz, 1)}, cache)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits[:, -1])
            seq.append(tok)
        del cache
        full_toks = torch.cat([prompt, torch.stack(seq[:-1], dim=1)], dim=1)
        fa.reset_launch_count()
        full, _ = model32.forward(params32, {"tokens": full_toks})
    got = torch.stack(steps, dim=1)                     # positions n0-1 .. n0+gen-1
    want = full[:, n0 - 1:n0 + gen]
    err, scale = max_err(got, want)
    if fa.launch_count() != cfg.num_layers or not err <= DECODE_TOL * scale:
        raise AssertionError(f"(d) f32 prefill+decode vs forward: {err:.3e} > "
                             f"{DECODE_TOL} x {scale:.3e}, or {fa.launch_count()} launches")
    print(f"(d) f32 prefill {n0} + {gen} decode steps vs the forward over {full_toks.shape[1]} "
          f"tokens (ragged S, kernel route): max abs err {err:.3e} over {gen + 1} positions "
          f"(max|logits| {scale:.3e}, tol {DECODE_TOL} x max) on {card}", flush=True)
    # Where a decode step's time goes: an enqueue time close to the step
    # time means the host, not the card, sets the pace.  The first step
    # warms up.
    enqueue, total = sorted(enqueue[1:]), sorted(total[1:])
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params32))
    print(f"(d) decode step B={bsz} f32 (median of {len(total)}): {total[len(total) // 2]:.3f} ms "
          f"synchronized, of which {enqueue[len(enqueue) // 2]:.3f} ms for the host to enqueue "
          f"it; reading the f32 weights once takes "
          f"{weight_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at HBM rate", flush=True)
    del params32, full, got, want
    torch.cuda.empty_cache()
    return main_launches


# ssm_scan at the full-width Zamba2-2.7B Mamba2 layer (32 heads of dh =
# 5120 / 32 = 160, state 64, chunk 256): (B, S, H, dh, ds, chunk, valid
# steps, dtype).  4352 is the scoring forward's padding of S = 4100 to
# whole chunks (the steps past 4100 zero, dt = 0); chunk 64 is
# test_kernel_integration.py's and chunk 16 the reduced configs', at the
# reduced width (4 heads of 128, state 16); dh 80 leaves a partial tile.
SSM_CASES = [(1, 8192, 32, 160, 64, 256, None, "bfloat16"),
             (1, 8192, 32, 160, 64, 256, None, "float32"),
             (2, 8192, 32, 160, 64, 256, None, "bfloat16"),
             (1, 4352, 32, 160, 64, 256, 4100, "bfloat16"),
             (2, 512, 4, 128, 16, 64, None, "float32"),
             (2, 256, 4, 128, 16, 16, None, "float32"),
             (1, 2048, 32, 80, 64, 256, None, "bfloat16")]
SSM_HEADLINE = SSM_CASES[0]
# ssm_scan tolerance, per element: |kernel - plain| <= rel |plain| + eps
# y_abs, where y_abs (h_abs for the final state) is the plain scan of |x|,
# |B| and |C|: the sum of the magnitudes of every term that forms the
# element.  eps = 2**-20 max|la| + (chunk + ds) 2**-24.  The first term is
# la's: the kernel forms the in-chunk cumulative sum la = cumsum(a dt) in
# another order than torch.cumsum, and a term's decay exp(la_t - la_s)
# takes the rounding of the difference as a relative error.  la reaches
# about -870 at the headline (a = -16 over 256 steps), where an f32 ulp is
# 6.1e-5, and the run prints the largest |kernel - plain| / |terms| it
# meets (about one such ulp); 2**-20 max|la| is 8 ulps.  The second is an
# f32 sum of chunk + ds terms in another order.  bf16 adds rel = 2**-7: both versions round one f32
# result to bf16 (one bf16 ulp apart at a rounding boundary).
SSM_REL = {"float32": 0.0, "bfloat16": 2.0**-7}


def ssm_inputs(torch, b, s, h, dh, ds, valid, dtype, seed):
    """The layer's distributions: x, B, C ~ N(0, 1) in ``dtype``, dt =
    softplus(N(0, 1) - 2) and a = -linspace(1, 16, H) (the init's
    dt_bias and a_log) in f32; steps past ``valid`` zero, dt = 0."""
    dt_ = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, dh), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda") - 2.0)
    bm = torch.randn((b, s, ds), generator=gen, device="cuda")
    cm = torch.randn((b, s, ds), generator=gen, device="cuda")
    if valid is not None:
        for t in (x, dt, bm, cm):
            t[:, valid:] = 0.0
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x.to(dt_), dt, a, bm.to(dt_), cm.to(dt_)


def ssm_excess(torch, got, want, inputs, chunk: int, dtype: str) -> dict:
    """Max |kernel - plain| and, for y and h, the max over elements of the
    error less its allowance (<= 0 when every element passes)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_ref

    x, dt, a, bm, cm = inputs
    b, s, h, _ = x.shape
    y_abs, h_abs = ssm_scan_ref(x.abs().float(), dt, a, bm.abs().float(), cm.abs().float(),
                                chunk=chunk)
    la_max = (a * dt).reshape(b, s // chunk, chunk, h).sum(2).abs().max().item()
    eps = 2.0**-20 * la_max + (chunk + bm.shape[-1]) * 2.0**-24
    (gy, gh), (wy, wh) = got, want
    dy = (gy.float() - wy.float()).abs()
    dh = (gh - wh).abs()
    rel = (dh / h_abs.clamp_min(1e-30)).max().item()
    if gy.dtype == torch.float32:   # bf16's own rounding would dominate y's ratio
        rel = max(rel, (dy / y_abs.clamp_min(1e-30)).max().item())
    return {"err_y": dy.max().item(), "err_h": dh.max().item(), "eps": eps, "la_max": la_max,
            "rel_terms": rel,
            "excess_y": (dy - SSM_REL[dtype] * wy.float().abs() - eps * y_abs).max().item(),
            "excess_h": (dh - eps * h_abs).max().item()}


def ssm_work(b, s, h, dh, ds, chunk, dtype) -> tuple[float, float]:
    """(operations, bytes) of one call: x, dt, a, B, C read once, y and the
    f32 h written once; the causal half of C B^T once per (b, chunk), and
    per (b, h, chunk) the causal half of the scores' product with x, the
    inter-chunk C h^T and the state update x^T B."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    ops = 2.0 * b * nc * tri * ds + 2.0 * b * h * nc * (tri * dh + 2 * chunk * ds * dh)
    nbytes = ((2 * b * s * h * dh + 2 * b * s * ds) * elem_bytes(dtype)
              + 4 * (b * s * h + h + b * h * dh * ds))
    return ops, nbytes


def ssm_bound(b, s, h, dh, ds, chunk, dtype) -> tuple[float, str]:
    """ssm_work at the peak rate of the inputs' type (bf16: the tensor
    cores) or HBM rate, whichever is slower."""
    return roofline(*ssm_work(b, s, h, dh, ds, chunk, dtype), dtype)


def ssm_kernel_cases(torch):
    """ssm_scan at the hybrid's shapes, each held against its plain
    version and timed beside it and beside its bound; no single library
    call computes it."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_ref

    cases = []
    for n, (b, s, h, dh, ds, chunk, valid, dt) in enumerate(SSM_CASES):
        inputs = ssm_inputs(torch, b, s, h, dh, ds, valid, dt, seed=4 + n)
        got = ssm_scan_cuda(*inputs, chunk=chunk)
        want = ssm_scan_ref(*inputs, chunk=chunk)
        again = ssm_scan_cuda(*inputs, chunk=chunk)
        torch.cuda.synchronize()
        ex = ssm_excess(torch, got, want, inputs, chunk, dt)
        shape = f"({b},{s},{h},{dh}) ds {ds} chunk {chunk} {dt}"
        if not (ex["excess_y"] <= 0.0 and ex["excess_h"] <= 0.0 and got[0].dtype == inputs[0].dtype
                and torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(
                f"ssm_scan {shape}: an element of y or h exceeds |kernel - plain| <= "
                f"{SSM_REL[dt]:.3e} |plain| + {ex['eps']:.3e} |terms| by {ex['excess_y']:.3e} "
                f"/ {ex['excess_h']:.3e}, or two launches differ"
            )
        del got, want, again
        big = s >= 4096
        ms = time_calls(torch, lambda: ssm_scan_cuda(*inputs, chunk=chunk), 10 if big else 50)
        plain_ms = time_calls(torch, lambda: ssm_scan_ref(*inputs, chunk=chunk), 2 if big else 20)
        bound_ms, bound_by = ssm_bound(b, s, h, dh, ds, chunk, dt)
        bytes_ms, ops_ms = bound_parts(*ssm_work(b, s, h, dh, ds, chunk, dt), dt)
        f32_ms, _ = ssm_bound(b, s, h, dh, ds, chunk, "float32")
        cases.append({
            "shape": shape, "key": SSM_CASES[n], "max_abs_err": ex["err_y"],
            "max_abs_err_h": ex["err_h"], "max_err_over_terms": ex["rel_terms"],
            "tolerance": f"{SSM_REL[dt]:.3e} |plain| + "
            f"{ex['eps']:.3e} |terms|", "la_max": ex["la_max"], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "f32_simt_bound_ms": f32_ms,
        })
        print(
            f"ssm_scan {shape}: err y {ex['err_y']:.3e} h {ex['err_h']:.3e}, at most "
            f"{ex['rel_terms']:.3e} of |terms| (tol {cases[-1]['tolerance']} per element, "
            f"max|la| {ex['la_max']:.1f}; bit-identical "
            f"across launches) kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {bound_ms:.3f} ms "
            f"({bound_by}; bytes {bytes_ms:.3f} ms, operations {ops_ms:.3f} ms at the {dt} peak; "
            f"{f32_ms:.3f} ms at the f32 CUDA-core peak)",
            flush=True,
        )
        del inputs
        torch.cuda.empty_cache()
    return cases


PROFILE_CALLS = 5


def kernel_profile(torch, card: str, name: str, shape: str, call) -> dict:
    """Where one kernel call's device time goes: ``torch.profiler`` (CUDA
    activity, so CUPTI records the kernels the ctypes library launches)
    over PROFILE_CALLS calls of ``call`` after a warm-up call; prints and
    returns each kernel's device ms per call, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            call()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            split[evt.key] = us / 1e3 / PROFILE_CALLS
    total = sum(split.values())
    print(f"{name} profile {shape} on {card}: {total:.4f} ms per call over "
          f"{PROFILE_CALLS} calls", flush=True)
    if not split:
        print(f"{name} profile {shape}: the profiler recorded no device time", flush=True)
    for kernel, ms in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"{name} profile {shape}: {ms:.4f} ms per call ({ms / total:.1%}) in {kernel}",
              flush=True)
    return {"total_ms": total, "kernels_ms": split}


def ssm_profile(torch, card: str, cases=(SSM_HEADLINE,)) -> dict:
    """:func:`kernel_profile` of ssm_scan at each case."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    splits = {}
    for b, s, h, dh, ds, chunk, valid, dt in cases:
        inputs = ssm_inputs(torch, b, s, h, dh, ds, valid, dt, seed=4)
        shape = f"({b},{s},{h},{dh}) ds {ds} chunk {chunk} {dt}"
        splits[shape] = kernel_profile(torch, card, "ssm_scan", shape,
                                       lambda: ssm_scan_cuda(*inputs, chunk=chunk))
        del inputs
        torch.cuda.empty_cache()
    return splits


# The hybrid slice: Zamba2-2.7B (arXiv:2411.15242) at its published widths
# and all 54 layers (9 periods of 6 Mamba2 layers and the shared attention
# block); only the number of requests and the generated length are cut.
HYBRID = {"arch": "zamba2_2_7b", "score_seq": 8192, "serve_batch": 2,
          "prompt": 4608, "gen": 16, "seed": 0}
# This random-weight model amplifies rounding: one ulp of relative noise
# on its embeddings moves its f32 logits by about 1% of max|logits| ((b)
# prints it), so whole-model logits separate only faults that move them by
# O(1).  (b) holds each of the 54 kernel calls, on the plain route's own
# input, to 1e-3 of its layer's update (la's rounding, see SSM_REL, keeps
# it far below that), and the logits of the two routes, and (d)
# those of prefill + decode against the forward, to 0.1 x max|logits|,
# which a dropped tile, a wrong mask or a stale state exceeds.
HYBRID_LAYER_TOL = 1e-3
HYBRID_LOGITS_TOL = 0.1


def hybrid_slice(torch, np, card: str) -> tuple[int, dict]:
    """Score, serve and check the full-width hybrid; returns the scoring
    forward's ssm_scan launch count (the main path) and where its time
    goes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models import blocks, build_model
    from repro_torch.models.steps import make_loss_fn, make_serve_step
    from repro_torch.nn.layers import embed_lookup

    cfg = dataclasses.replace(get_config(HYBRID["arch"]), use_pallas_kernels=True)
    s, seed = HYBRID["score_seq"], HYBRID["seed"]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    host = next(iter(TokenStream(cfg.vocab_size, s, 1, seed=seed)))
    batch = {k: torch.as_tensor(a, device="cuda") for k, a in host.items()}
    mamba_layers = cfg.num_layers
    attn_calls = model.num_periods
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters, {mamba_layers} Mamba2 "
          f"layers (d_inner {cfg.d_inner_eff}, {cfg.ssm_heads} heads of "
          f"{cfg.d_inner_eff // cfg.ssm_heads}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}) "
          f"and {attn_calls} calls of one shared attention block ({cfg.num_heads} heads of "
          f"{cfg.hd}, window {cfg.window}), d_model {cfg.d_model}, {cfg.dtype}", flush=True)

    # (a) The main path: the scoring forward through both kernels.
    torch.cuda.reset_peak_memory_stats()
    ss.reset_launch_count()
    fa.reset_launch_count()
    with torch.no_grad():
        loss = make_loss_fn(model)(params, batch)
    torch.cuda.synchronize()
    main_launches, attn_launches = ss.launch_count(), fa.launch_count()
    loss = float(loss)
    if main_launches != mamba_layers or attn_launches != attn_calls or not np.isfinite(loss):
        raise AssertionError(f"hybrid scoring forward: {main_launches} ssm_scan and "
                             f"{attn_launches} flash_attention launches (expected "
                             f"{mamba_layers} and {attn_calls}), loss {loss}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms, shares = op_shares(torch, model, params, batch, ("ssm_scan", "flash_attention"))
    (ssm_ms, ssm_calls), (attn_ms, a_calls) = shares["ssm_scan"], shares["flash_attention"]
    plain_fwd_ms = timed_forward(
        torch, build_model(dataclasses.replace(cfg, use_pallas_kernels=False)), params, batch)
    rest = fwd_ms - ssm_ms - attn_ms
    print(
        f"(a) hybrid scoring forward B=1 S={s} bf16: loss {loss:.4f}, {main_launches} ssm_scan "
        f"and {attn_launches} flash_attention launches, peak {peak_gb:.2f} GB; "
        f"{fwd_ms:.3f} ms (CUDA events) = ssm_scan {ssm_ms:.3f} ms over {ssm_calls} calls "
        f"({ssm_ms / fwd_ms:.1%}) + flash_attention {attn_ms:.3f} ms over {a_calls} calls "
        f"({attn_ms / fwd_ms:.1%}; CUDA events around each call in this forward) + the rest "
        f"{rest:.3f} ms; through the plain scan and attention {plain_fwd_ms:.3f} ms",
        flush=True,
    )
    split = {"forward_ms": fwd_ms, "ssm_scan_ms": ssm_ms, "ssm_scan_calls": ssm_calls,
             "flash_attention_ms": attn_ms, "flash_attention_calls": a_calls, "rest_ms": rest,
             "plain_forward_ms": plain_fwd_ms, "peak_gb": peak_gb}

    # (c) Serving through the launcher's entry point: prefill and decode
    # take the plain scan, recurrence and attention, as in the reference.
    ss.reset_launch_count()
    fa.reset_launch_count()
    res = serve.serve(HYBRID["arch"], batch=HYBRID["serve_batch"], prompt_len=HYBRID["prompt"],
                      gen_len=HYBRID["gen"], reduced=False, seed=seed)
    toks = res["tokens"]
    if res["device"] != "cuda" or toks.shape != (HYBRID["serve_batch"], HYBRID["gen"]) \
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"hybrid serve: tokens {toks.shape} on {res['device']}")
    print(f"(c) hybrid serve B={HYBRID['serve_batch']} prompt {HYBRID['prompt']} (window "
          f"{cfg.window}: the ring wraps) gen {HYBRID['gen']} bf16: prefill "
          f"{res['prefill_s']:.3f} s, decode {res['decode_tokens_per_s']:.1f} tok/s "
          f"({res['decode_s']:.3f} s), {ss.launch_count()} ssm_scan and {fa.launch_count()} "
          f"flash_attention launches", flush=True)
    split.update(prefill_s=res["prefill_s"], decode_tokens_per_s=res["decode_tokens_per_s"])
    del params
    torch.cuda.empty_cache()

    # (b) f32: each kernel call against the plain scan on the same input,
    # then the kernel route's logits against the plain route's.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(seed))
    plain_cfg = dataclasses.replace(cfg32, use_pallas_kernels=False)
    plain32 = build_model(plain_cfg)
    layer_gap = 0.0
    with torch.no_grad():
        x = embed_lookup(params32["embed"], batch["tokens"])
        positions = torch.arange(s, device="cuda")
        for mamba in model32.mamba_layers(params32):
            for mp in mamba:
                plain_x, _ = blocks.apply_mamba_layer(mp, x, plain_cfg, None)
                routed_x, _ = blocks.apply_mamba_layer(mp, x, cfg32, None)
                gap = ((routed_x - plain_x).abs().max() / (plain_x - x).abs().max()).item()
                layer_gap = max(layer_gap, gap)
                x = plain_x
            x, _, _ = blocks.apply_transformer_layer(params32["shared_attn"], x, positions,
                                                     plain_cfg, None)
        del x, plain_x, routed_x
        routed, _ = model32.forward(params32, {"tokens": batch["tokens"]})
        plain, _ = plain32.forward(params32, {"tokens": batch["tokens"]})
        err, scale = max_err(routed, plain)
        del routed
        noise = torch.randn(params32["embed"].shape, generator=torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        nudged, _ = plain32.forward(dict(params32, embed=params32["embed"] * (1 + 2**-24 * noise)),
                                    {"tokens": batch["tokens"]})
        ulp_gap, _ = max_err(nudged, plain)
        del plain, nudged, noise
    if not (layer_gap <= HYBRID_LAYER_TOL and err <= HYBRID_LOGITS_TOL * scale):
        raise AssertionError(f"(b) f32 kernel vs plain route: a layer's update differs by "
                             f"{layer_gap:.3e} (tol {HYBRID_LAYER_TOL}), logits by {err:.3e} "
                             f"(tol {HYBRID_LOGITS_TOL} x {scale:.3e})")
    print(f"(b) f32 forward S={s}: each of the {mamba_layers} Mamba2 layers, kernel vs plain scan "
          f"on the same input, within {layer_gap:.3e} of the layer's update (tol "
          f"{HYBRID_LAYER_TOL}); logits kernel route vs plain route max abs err {err:.3e} "
          f"(max|logits| {scale:.3e}, tol {HYBRID_LOGITS_TOL} x max); one ulp of noise on the "
          f"embeddings moves the plain route's logits by {ulp_gap:.3e}", flush=True)
    split.update(layer_gap=layer_gap, route_err=err / scale, ulp_gap=ulp_gap / scale)

    # (d) f32 prefill + greedy decode against the f32 forward through the
    # kernels over the prompt and the generated tokens.
    bsz, n0, gen = HYBRID["serve_batch"], HYBRID["prompt"], HYBRID["gen"]
    prompt = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, n0)), device="cuda")
    step = make_serve_step(model32)
    enqueue, total = [], []
    with torch.no_grad():
        logits, cache = model32.prefill(params32, {"tokens": prompt}, max_len=n0 + gen)
        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1)
        seq = [tok]
        for _ in range(gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, logits, cache = step(params32, {"tokens": tok.reshape(bsz, 1)}, cache)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits[:, -1])
            seq.append(tok)
        del cache
        full_toks = torch.cat([prompt, torch.stack(seq[:-1], dim=1)], dim=1)
        ss.reset_launch_count()
        full, _ = model32.forward(params32, {"tokens": full_toks})
    got = torch.stack(steps, dim=1)
    want = full[:, n0 - 1:n0 + gen]
    err, scale = max_err(got, want)
    if ss.launch_count() != mamba_layers or not err <= HYBRID_LOGITS_TOL * scale:
        raise AssertionError(f"(d) hybrid f32 prefill+decode vs forward: {err:.3e} > "
                             f"{HYBRID_LOGITS_TOL} x {scale:.3e}, or {ss.launch_count()} "
                             f"ssm_scan launches")
    enqueue, total = sorted(enqueue[1:]), sorted(total[1:])
    print(f"(d) f32 prefill {n0} + {gen} decode steps vs the forward over {full_toks.shape[1]} "
          f"tokens (padded scan, kernel route): max abs err {err:.3e} over {gen + 1} positions "
          f"(max|logits| {scale:.3e}, tol {HYBRID_LOGITS_TOL} x max); a decode step B={bsz} "
          f"(median of {len(total)}) {total[len(total) // 2]:.3f} ms synchronized, of which "
          f"{enqueue[len(enqueue) // 2]:.3f} ms for the host to enqueue it, on {card}",
          flush=True)
    split.update(decode_err=err / scale, decode_step_ms=total[len(total) // 2],
                 decode_enqueue_ms=enqueue[len(enqueue) // 2])
    del params32, full, got, want
    torch.cuda.empty_cache()
    return main_launches, split


# mlstm_scan at the full-width xLSTM-350M mLSTM layer (4 heads of dk = dv
# = 1024 / 4 = 256, chunk 256): (B, S, H, dk, dv, chunk, valid steps,
# dtype).  4608 is the served prompt; 4352 the scoring forward's padding
# of S = 4100 to whole chunks (steps past 4100: q, k, v = 0, i_pre = -1e9,
# f_pre = +1e9); chunk 16 is the reduced config's (4 heads of 64); the
# last case has dk != dv.
MLSTM_CASES = [(1, 8192, 4, 256, 256, 256, None, "bfloat16"),
               (1, 8192, 4, 256, 256, 256, None, "float32"),
               (2, 4608, 4, 256, 256, 256, None, "bfloat16"),
               (1, 4352, 4, 256, 256, 256, 4100, "bfloat16"),
               (2, 128, 4, 64, 64, 16, None, "float32"),
               (1, 512, 2, 64, 128, 64, None, "float32")]
MLSTM_HEADLINE = MLSTM_CASES[0]
# mlstm_scan tolerance, per element: |kernel - plain| <= rel |plain| + eps
# (num_abs + |plain| (den_abs + D)) / D for y, where num_abs and den_abs
# are the plain numerator and denominator computed on |q|, |k|, |v| (the
# sum of the magnitudes of every term that forms them) and D = max(|den|,
# e^{-m_t}) the plain version's floored denominator: y = num / D, so an
# error of eps num_abs in num and eps den_abs in den moves y by eps
# (num_abs + |y| den_abs) / D, and an error of eps in m_t moves the floor
# by eps D.  For the state, eps times the plain state of |k|, |v| (C, n)
# and eps (max|F| + |m|) for m.  eps = 2**-20 max|F| + (2 chunk + dk)
# 2**-24.  The first term is F's: the kernel forms F = cumsum(logsigmoid(
# f_pre)) in another order than torch.cumsum, and each weight e^{F_t - F_s
# + i_s - m_t} takes the rounding of F as a relative error; 2**-20 max|F|
# is 16 ulps of the largest |F| (about 20 at chunk 256).  The second is an
# f32 sum of up to 2 chunk + dk terms in another order (the scores' dk,
# the chunk's keys and the carried state's chunk).  bf16 adds rel =
# 2**-7: both versions round one f32 result to bf16.
MLSTM_REL = {"float32": 0.0, "bfloat16": 2.0**-7}


def mlstm_inputs(torch, b, s, h, dk, dv, valid, dtype, seed):
    """The layer's distributions: q, k, v ~ N(0, 1) in ``dtype`` (rms-normed
    activations through 1/sqrt(d)-scaled weights), i_pre ~ N(0, 1) and
    f_pre ~ N(3, 1) (the +3 forget bias) in f32; steps past ``valid`` are
    the model's padding."""
    dt_ = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn((b, s, h, dk), generator=gen, device="cuda") for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=gen, device="cuda")
    i_pre = torch.randn((b, s, h), generator=gen, device="cuda")
    f_pre = torch.randn((b, s, h), generator=gen, device="cuda") + 3.0
    if valid is not None:
        for t in (q, k, v):
            t[:, valid:] = 0.0
        i_pre[:, valid:] = -1e9
        f_pre[:, valid:] = 1e9
    return q.to(dt_), k.to(dt_), v.to(dt_), i_pre, f_pre


def mlstm_excess(torch, got, want, inputs, chunk: int, dtype: str) -> dict:
    """Max |kernel - plain| and, for y and the state, the max over elements
    of the error less its allowance (<= 0 when every element passes)."""
    from repro_torch.nn.xlstm import init_mlstm_state, mlstm_terms

    q, k, v, i_pre, f_pre = inputs
    b, s, h, dk = q.shape
    zero = init_mlstm_state(b, h, dk, v.shape[-1], device=q.device)
    _, den, floor, _ = mlstm_terms(q, k, v, i_pre, f_pre, zero, chunk=chunk)
    num_a, den_a, _, st_a = mlstm_terms(q.abs(), k.abs(), v.abs(), i_pre, f_pre, zero,
                                        chunk=chunk)
    d = torch.maximum(den.abs(), floor)
    f_max = (torch.nn.functional.logsigmoid(f_pre).reshape(b, s // chunk, chunk, h)
             .cumsum(2).abs().max().item())
    eps = 2.0**-20 * f_max + (2 * chunk + dk) * 2.0**-24
    (gy, (gc, gn, gm)), (wy, (wc, wn, wm)) = got, want
    wy = wy.float()
    terms_y = num_a / d[..., None] + wy.abs() * ((den_a + d) / d)[..., None]
    dy = (gy.float() - wy).abs()
    diffs = ((gc - wc).abs(), (gn - wn).abs(), (gm - wm).abs())
    terms_state = (st_a.c, st_a.n, f_max + wm.abs())
    rel = max((dd / t.clamp_min(1e-30)).max().item() for dd, t in zip(diffs, terms_state))
    if gy.dtype == torch.float32:   # bf16's own rounding would dominate y's ratio
        rel = max(rel, (dy / terms_y.clamp_min(1e-30)).max().item())
    return {"err_y": dy.max().item(), "err_state": max(dd.max().item() for dd in diffs),
            "eps": eps, "f_max": f_max, "rel_terms": rel,
            "excess_y": (dy - MLSTM_REL[dtype] * wy.abs() - eps * terms_y).max().item(),
            "excess_state": max((dd - eps * t).max().item()
                                for dd, t in zip(diffs, terms_state))}


def mlstm_bound(b, s, h, dk, dv, chunk, dtype) -> tuple[float, str]:
    """q, k, v, i_pre, f_pre read once, y and the f32 (C, n, m) written
    once; operations per (b, h, chunk): the causal half of q k^T and of the
    scores' product with v, q C_prev and q . n_prev, and the state update
    k^T v and its n, at the peak rate of the inputs' type."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    ops = 2.0 * b * h * nc * (tri * (dk + dv) + 2 * chunk * dk * dv + 2 * chunk * dk)
    nbytes = ((2 * b * s * h * dk + 2 * b * s * h * dv) * elem_bytes(dtype)
              + 4 * (2 * b * s * h + b * h * (dk * dv + dk + 1)))
    return roofline(ops, nbytes, dtype)


def parent_mlstm(torch, root: str, build: str):
    """``--parent DIR``: the mlstm_scan of another checkout DIR (the parent
    commit, unpacked), built from DIR's sources into ``build`` and called as
    its wrapper calls it: a function with mlstm_scan_cuda's signature."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.nn.xlstm import mlstm_scale

    csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
    lib_path = os.path.join(build, "libparent_mlstm_scan.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(csrc, "mlstm_scan.cu")], check=True)
    with open(os.path.join(csrc, "mlstm_scan.cu")) as f:
        pieced = "void* pieces" in f.read()   # the C ABI with the pieces' scratch
    lib = ctypes.CDLL(lib_path)
    for fn in (lib.mlstm_scan_f32, lib.mlstm_scan_bf16):
        fn.argtypes = ([ctypes.c_void_p] * (12 if pieced else 11) + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def call(q, k, v, i_pre, f_pre, *, chunk=256):
        b, s, h, dk = q.shape
        dv, nc = v.shape[-1], s // chunk
        f32 = dict(dtype=torch.float32, device=q.device)
        y = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
        c, n, m = (torch.empty(shape, **f32) for shape in ((b, h, dk, dv), (b, h, dk), (b, h)))
        states = torch.empty((b, h, nc, dk * dv + dk), **f32)
        scalars = torch.empty((3, b, h, nc), **f32)
        pieces = (torch.empty((b, h, nc, 2, dk, dv), dtype=torch.bfloat16, device=q.device)
                  if pieced and q.dtype == torch.bfloat16 else None)
        fn = lib.mlstm_scan_f32 if q.dtype == torch.float32 else lib.mlstm_scan_bf16
        ptrs = [t.data_ptr() for t in (q, k, v, i_pre, f_pre, y, c, n, m, states, scalars)]
        if pieced:
            ptrs.append(None if pieces is None else pieces.data_ptr())
        err = fn(*ptrs, b, s, h, dk, dv, chunk, mlstm_scale(dk),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's mlstm_scan failed with cudaError_t {err}")
        return y, (c, n, m)

    return call


def mlstm_kernel_cases(torch, parent=None):
    """mlstm_scan at xLSTM's shapes, each held against its plain version and
    timed beside it and beside its bound; no single library call computes
    it.  With ``parent`` (:func:`parent_mlstm`), the parent's kernel is
    timed beside it and its f32 outputs must equal the parent's bit for
    bit."""
    from repro_torch.kernels.mlstm_scan import mlstm_scan_cuda, mlstm_scan_ref

    cases = []
    for n, (b, s, h, dk, dv, chunk, valid, dt) in enumerate(MLSTM_CASES):
        inputs = mlstm_inputs(torch, b, s, h, dk, dv, valid, dt, seed=20 + n)
        got = mlstm_scan_cuda(*inputs, chunk=chunk)
        want = mlstm_scan_ref(*inputs, chunk=chunk)
        again = mlstm_scan_cuda(*inputs, chunk=chunk)
        torch.cuda.synchronize()
        ex = mlstm_excess(torch, got, want, inputs, chunk, dt)
        shape = f"({b},{s},{h},{dk}->{dv}) chunk {chunk} {dt}" + (
            f" valid {valid}" if valid is not None else "")
        same = torch.equal(got[0], again[0]) and all(
            torch.equal(x, y) for x, y in zip(got[1], again[1]))
        if not (ex["excess_y"] <= 0.0 and ex["excess_state"] <= 0.0 and same
                and got[0].dtype == inputs[0].dtype):
            raise AssertionError(
                f"mlstm_scan {shape}: an element of y or (C, n, m) exceeds its allowance "
                f"({MLSTM_REL[dt]:.3e} |plain| + {ex['eps']:.3e} |terms|) by "
                f"{ex['excess_y']:.3e} / {ex['excess_state']:.3e}, or two launches differ"
            )
        if valid is not None and got[0][:, valid:].any():
            raise AssertionError(f"mlstm_scan {shape}: padded rows are not 0")
        if parent is not None and dt == "float32":
            old = parent(*inputs, chunk=chunk)
            if not (torch.equal(got[0], old[0])
                    and all(torch.equal(x, y) for x, y in zip(got[1], old[1]))):
                raise AssertionError(f"mlstm_scan {shape}: the f32 instance's outputs differ "
                                     f"from the parent's")
            del old
        del got, want, again
        big = s >= 4096
        iters = 10 if big else 50
        ms = time_calls(torch, lambda: mlstm_scan_cuda(*inputs, chunk=chunk), iters)
        parent_ms = None if parent is None else time_calls(
            torch, lambda: parent(*inputs, chunk=chunk), iters)
        plain_ms = time_calls(torch, lambda: mlstm_scan_ref(*inputs, chunk=chunk),
                              2 if big else 20)
        bound_ms, bound_by = mlstm_bound(b, s, h, dk, dv, chunk, dt)
        f32_ms, _ = mlstm_bound(b, s, h, dk, dv, chunk, "float32")
        cases.append({
            "shape": shape, "key": MLSTM_CASES[n], "max_abs_err": ex["err_y"],
            "max_abs_err_state": ex["err_state"], "max_err_over_terms": ex["rel_terms"],
            "tolerance": f"{MLSTM_REL[dt]:.3e} |plain| + {ex['eps']:.3e} |terms|",
            "f_max": ex["f_max"], "ms": ms, "parent_ms": parent_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "f32_simt_bound_ms": f32_ms,
        })
        parent_note = "" if parent is None else (
            f" (the parent's {parent_ms:.3f} ms" + (", f32 outputs bit-identical to it)"
                                                   if dt == "float32" else ")"))
        print(
            f"mlstm_scan {shape}: err y {ex['err_y']:.3e} state {ex['err_state']:.3e}, at most "
            f"{ex['rel_terms']:.3e} of |terms| (tol {cases[-1]['tolerance']} per element, "
            f"max|F| {ex['f_max']:.1f}; bit-identical across launches) kernel {ms:.3f} ms"
            f"{parent_note} plain {plain_ms:.3f} ms bound {bound_ms:.3f} ms ({bound_by}, {dt} "
            f"peak; {f32_ms:.3f} ms at the f32 CUDA-core peak)",
            flush=True,
        )
        del inputs
        torch.cuda.empty_cache()
    return cases


def mlstm_profile(torch, card: str, cases=(MLSTM_HEADLINE,), parent=None) -> dict:
    """:func:`kernel_profile` of mlstm_scan at each case: its three kernels
    (states, carry, outputs) by name; with ``parent``, the parent's too."""
    from repro_torch.kernels.mlstm_scan import mlstm_scan_cuda

    splits = {}
    for b, s, h, dk, dv, chunk, valid, dt in cases:
        inputs = mlstm_inputs(torch, b, s, h, dk, dv, valid, dt, seed=20)
        shape = f"({b},{s},{h},{dk}->{dv}) chunk {chunk} {dt}"
        splits[shape] = kernel_profile(torch, card, "mlstm_scan", shape,
                                       lambda: mlstm_scan_cuda(*inputs, chunk=chunk))
        if parent is not None:
            splits[f"parent {shape}"] = kernel_profile(
                torch, card, "mlstm_scan (parent)", shape, lambda: parent(*inputs, chunk=chunk))
        del inputs
        torch.cuda.empty_cache()
    return splits


# The xLSTM slice: xLSTM-350M (arXiv:2405.04517) at its published widths
# and lengths.  The scoring and f32 passes run 12 of its 24 layers (2 of 4
# periods of 5 mLSTM layers and one sLSTM layer: the sLSTM's host loop, a
# few ms a step over 8192 steps a pass, was the smoke's largest share
# beside phase 17, and phase 18's recurrent grid checks needed the time);
# serving runs all 24; the number of requests and the generated length
# are cut.
XLSTM = {"arch": "xlstm_350m", "layers": 12, "score_seq": 8192, "serve_batch": 2,
         "prompt": 4608, "gen": 16, "seed": 0}
# (b) holds each of the 10 kernel calls, on the plain route's own input, to
# 1e-3 of its layer's update (F's rounding, see MLSTM_REL, keeps it far
# below that), and the logits of the two routes, and (d) those of prefill
# + decode against the forward, to 0.1 x max|logits|, as the hybrid's: a
# random-weight model may amplify rounding ((b) prints its response to
# one ulp of noise on the embeddings), and a dropped tile, a wrong mask or
# a stale state moves the logits by O(1).
XLSTM_LAYER_TOL = 1e-3
XLSTM_LOGITS_TOL = 0.1


def xlstm_slice(torch, np, card: str) -> tuple[int, dict]:
    """Score, serve and check the full-width xLSTM; returns the scoring
    forward's mlstm_scan launch count (the main path) and where its time
    goes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.launch import serve
    from repro_torch.models import blocks, build_model
    from repro_torch.models.steps import make_loss_fn, make_serve_step
    from repro_torch.models.transformer import layer_views
    from repro_torch.nn.layers import embed_lookup

    cfg = dataclasses.replace(get_config(XLSTM["arch"]), use_pallas_kernels=True,
                              num_layers=XLSTM["layers"])
    s, seed = XLSTM["score_seq"], XLSTM["seed"]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    host = next(iter(TokenStream(cfg.vocab_size, s, 1, seed=seed)))
    batch = {k: torch.as_tensor(a, device="cuda") for k, a in host.items()}
    mlstm_layers = model.num_periods * model.mlstm_per_period
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{cfg.name}: {n_params / 1e6:.3f} M parameters, {mlstm_layers} mLSTM layers "
          f"({cfg.num_heads} heads of dk = dv = {cfg.hd}, chunk {cfg.ssm_chunk}) and "
          f"{model.num_periods} sLSTM layers ({cfg.num_heads} heads of "
          f"{cfg.d_model // cfg.num_heads}), d_model {cfg.d_model}, vocab {cfg.padded_vocab}, "
          f"{cfg.dtype}", flush=True)

    # (a) The main path: the scoring forward through the kernel.
    torch.cuda.reset_peak_memory_stats()
    ms.reset_launch_count()
    with torch.no_grad():
        loss = make_loss_fn(model)(params, batch)
    torch.cuda.synchronize()
    main_launches = ms.launch_count()
    loss = float(loss)
    if main_launches != mlstm_layers or not np.isfinite(loss):
        raise AssertionError(f"xlstm scoring forward: {main_launches} mlstm_scan launches "
                             f"(expected {mlstm_layers}), loss {loss}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms, shares = op_shares(torch, model, params, batch, ("mlstm_scan", "apply_slstm_layer"))
    (scan_ms, scan_calls), (slstm_ms, slstm_calls) = (shares["mlstm_scan"],
                                                      shares["apply_slstm_layer"])
    plain_fwd_ms = timed_forward(
        torch, build_model(dataclasses.replace(cfg, use_pallas_kernels=False)), params, batch)
    rest = fwd_ms - scan_ms - slstm_ms
    print(
        f"(a) xlstm scoring forward B=1 S={s} bf16: loss {loss:.4f}, {main_launches} mlstm_scan "
        f"launches, peak {peak_gb:.2f} GB; {fwd_ms:.3f} ms (CUDA events) = mlstm_scan "
        f"{scan_ms:.3f} ms over {scan_calls} calls ({scan_ms / fwd_ms:.1%}) + sLSTM layers "
        f"{slstm_ms:.3f} ms over {slstm_calls} calls ({slstm_ms / fwd_ms:.1%}; CUDA events "
        f"around each call in this forward) + the rest {rest:.3f} ms; through the plain scan "
        f"{plain_fwd_ms:.3f} ms",
        flush=True,
    )
    split = {"forward_ms": fwd_ms, "mlstm_scan_ms": scan_ms, "mlstm_scan_calls": scan_calls,
             "slstm_ms": slstm_ms, "slstm_calls": slstm_calls, "rest_ms": rest,
             "plain_forward_ms": plain_fwd_ms, "peak_gb": peak_gb, "loss": loss}

    # Each bf16 kernel call of the scoring forward against the plain scan on
    # its own input, with phase 10's per-element bar: one more forward
    # records the calls' inputs and outputs.
    calls = []
    routed = blocks.mlstm_scan

    def record(*args, **kwargs):
        out = routed(*args, **kwargs)
        calls.append((args, kwargs["chunk"], out))
        return out

    blocks.mlstm_scan = record
    try:
        with torch.no_grad():
            make_loss_fn(model)(params, batch)
    finally:
        blocks.mlstm_scan = routed
    worst_y = worst_state = -float("inf")
    for args, chunk, out in calls:
        ex = mlstm_excess(torch, out, ms.mlstm_scan_ref(*args, chunk=chunk), args, chunk,
                          "bfloat16")
        worst_y, worst_state = max(worst_y, ex["excess_y"]), max(worst_state, ex["excess_state"])
    if len(calls) != mlstm_layers or not (worst_y <= 0.0 and worst_state <= 0.0):
        raise AssertionError(f"(a) xlstm bf16: {len(calls)} mlstm_scan calls recorded, an element "
                             f"of y or (C, n, m) exceeds its allowance by {worst_y:.3e} / "
                             f"{worst_state:.3e}")
    print(f"(a) each of the {len(calls)} bf16 mlstm_scan calls of the forward, kernel vs plain "
          f"scan on the same input, within phase 10's per-element bar (largest excess over the "
          f"allowance: y {worst_y:.3e}, state {worst_state:.3e}; <= 0 passes)", flush=True)
    split.update(call_excess_y=worst_y, call_excess_state=worst_state)
    del calls
    torch.cuda.empty_cache()

    # (c) Serving through the launcher's entry point: prefill and decode
    # take the plain scan and the recurrences, as in the reference.
    ms.reset_launch_count()
    res = serve.serve(XLSTM["arch"], batch=XLSTM["serve_batch"], prompt_len=XLSTM["prompt"],
                      gen_len=XLSTM["gen"], reduced=False, seed=seed)
    toks = res["tokens"]
    if res["device"] != "cuda" or toks.shape != (XLSTM["serve_batch"], XLSTM["gen"]) \
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"xlstm serve: tokens {toks.shape} on {res['device']}")
    print(f"(c) xlstm serve B={XLSTM['serve_batch']} prompt {XLSTM['prompt']} gen "
          f"{XLSTM['gen']} bf16: prefill {res['prefill_s']:.3f} s, decode "
          f"{res['decode_tokens_per_s']:.1f} tok/s ({res['decode_s']:.3f} s), "
          f"{ms.launch_count()} mlstm_scan launches", flush=True)
    split.update(prefill_s=res["prefill_s"], decode_tokens_per_s=res["decode_tokens_per_s"])
    del params
    torch.cuda.empty_cache()

    # (b) f32: each kernel call against the plain scan on the same input,
    # then the kernel route's logits against the plain route's.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(seed))
    plain_cfg = dataclasses.replace(cfg32, use_pallas_kernels=False)
    plain32 = build_model(plain_cfg)
    layer_gap = 0.0
    with torch.no_grad():
        x = embed_lookup(params32["embed"], batch["tokens"])
        slstms = layer_views(params32["slstm"], model32.num_periods)
        for mlstm, slstm in zip(model32.mlstm_layers(params32), slstms):
            for mp in mlstm:
                plain_x, _ = blocks.apply_mlstm_layer(mp, x, plain_cfg, None)
                routed_x, _ = blocks.apply_mlstm_layer(mp, x, cfg32, None)
                gap = ((routed_x - plain_x).abs().max() / (plain_x - x).abs().max()).item()
                layer_gap = max(layer_gap, gap)
                x = plain_x
            x, _ = blocks.apply_slstm_layer(slstm, x, plain_cfg, None)
        del x, plain_x, routed_x
        routed, _ = model32.forward(params32, {"tokens": batch["tokens"]})
        plain, _ = plain32.forward(params32, {"tokens": batch["tokens"]})
        err, scale = max_err(routed, plain)
        del routed
        noise = torch.randn(params32["embed"].shape, generator=torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        nudged, _ = plain32.forward(dict(params32, embed=params32["embed"] * (1 + 2**-24 * noise)),
                                    {"tokens": batch["tokens"]})
        ulp_gap, _ = max_err(nudged, plain)
        del plain, nudged, noise
    if not (layer_gap <= XLSTM_LAYER_TOL and err <= XLSTM_LOGITS_TOL * scale):
        raise AssertionError(f"(b) f32 kernel vs plain route: a layer's update differs by "
                             f"{layer_gap:.3e} (tol {XLSTM_LAYER_TOL}), logits by {err:.3e} "
                             f"(tol {XLSTM_LOGITS_TOL} x {scale:.3e})")
    print(f"(b) f32 forward S={s}: each of the {mlstm_layers} mLSTM layers, kernel vs plain scan "
          f"on the same input, within {layer_gap:.3e} of the layer's update (tol "
          f"{XLSTM_LAYER_TOL}); logits kernel route vs plain route max abs err {err:.3e} "
          f"(max|logits| {scale:.3e}, tol {XLSTM_LOGITS_TOL} x max); one ulp of noise on the "
          f"embeddings moves the plain route's logits by {ulp_gap:.3e}", flush=True)
    split.update(layer_gap=layer_gap, route_err=err / scale, ulp_gap=ulp_gap / scale)

    # (d) f32 prefill + greedy decode against the f32 forward through the
    # kernel over the prompt and the generated tokens.
    bsz, n0, gen = XLSTM["serve_batch"], XLSTM["prompt"], XLSTM["gen"]
    prompt = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, n0)), device="cuda")
    step = make_serve_step(model32)
    enqueue, total = [], []
    with torch.no_grad():
        logits, cache = model32.prefill(params32, {"tokens": prompt}, max_len=n0 + gen)
        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1)
        seq = [tok]
        for _ in range(gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, logits, cache = step(params32, {"tokens": tok.reshape(bsz, 1)}, cache)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits[:, -1])
            seq.append(tok)
        del cache
        full_toks = torch.cat([prompt, torch.stack(seq[:-1], dim=1)], dim=1)
        ms.reset_launch_count()
        full, _ = model32.forward(params32, {"tokens": full_toks})
    got = torch.stack(steps, dim=1)
    want = full[:, n0 - 1:n0 + gen]
    err, scale = max_err(got, want)
    if ms.launch_count() != mlstm_layers or not err <= XLSTM_LOGITS_TOL * scale:
        raise AssertionError(f"(d) xlstm f32 prefill+decode vs forward: {err:.3e} > "
                             f"{XLSTM_LOGITS_TOL} x {scale:.3e}, or {ms.launch_count()} "
                             f"mlstm_scan launches")
    enqueue, total = sorted(enqueue[1:]), sorted(total[1:])
    print(f"(d) f32 prefill {n0} + {gen} decode steps vs the forward over {full_toks.shape[1]} "
          f"tokens (padded scan, kernel route): max abs err {err:.3e} over {gen + 1} positions "
          f"(max|logits| {scale:.3e}, tol {XLSTM_LOGITS_TOL} x max); a decode step B={bsz} "
          f"(median of {len(total)}) {total[len(total) // 2]:.3f} ms synchronized, of which "
          f"{enqueue[len(enqueue) // 2]:.3f} ms for the host to enqueue it, on {card}",
          flush=True)
    split.update(decode_err=err / scale, decode_step_ms=total[len(total) // 2],
                 decode_enqueue_ms=enqueue[len(enqueue) // 2])
    del params32, full, got, want
    torch.cuda.empty_cache()
    return main_launches, split


# Phases 12-14: the MoE, VLM and audio transformers at their published
# widths, seeded weights.  The MoE models are cut in depth to what one
# card holds beside the activations (bf16 weights: Phi-3.5-MoE 24 of 32
# layers, 31.47 B of 41.87 B parameters, 62.9 GB; Mixtral-8x22B 12 of 56,
# 30.45 B, 60.9 GB); InternVL2-1B and MusicGen-medium run whole.
PHI = {"arch": "phi35_moe_42b", "layers": 24, "score_seq": 8192, "serve_batch": 2,
       "prompt": 4608, "gen": 16, "seed": 0, "f32_layers": 4, "decode_layers": 2,
       "reduced": False}
MIXTRAL = {"arch": "mixtral_8x22b", "layers": 12, "score_seq": 8192, "serve_batch": 2,
           "prompt": 4608, "gen": 16, "seed": 0, "reduced": False}
# InternVL2-1B: 256 patches of the stubbed vision encoder (seeded normal)
# in front of 7936 tokens, 8192 positions.
VLM = {"arch": "internvl2_1b", "score_seq": 8192, "serve_batch": 2, "prompt": 4096,
       "gen": 16, "seed": 0, "reduced": False}
# MusicGen-medium: B=2 grids of 1500 frames of 4 codebooks, 30 s at
# EnCodec's 50 Hz (the crop length MusicGen trains on).
AUDIO = {"arch": "musicgen_medium", "score_seq": 1500, "score_batch": 2, "serve_batch": 2,
         "prompt": 500, "gen": 32, "seed": 0, "reduced": False}
# 12(b): each MoE layer in f32 against the same function in float64 on the
# same input, routed as the f32 call routes.  Its expert products sum d =
# 4096 and f = 6400 terms in f32, an error of order sqrt(f) 2**-24 ~ 5e-6
# of an output; 1e-4 x max|out| per layer, on the tokens whose float64
# top-2 is the f32 one (a near-tie may flip, and a flip moves a token's
# output by a step, not by rounding).
MOE_LAYER_TOL = 1e-4
# 12(d): the reference's no-drop setting for its decode check
# (tests/test_arch_smoke.py:74-78).  Without it the forward's capacity
# comes from the whole sequence and decode's from one token, so the two
# legitimately disagree wherever the forward dropped an assignment.
NO_DROP_FACTOR = 8.0


def zoo_config(spec, **over):
    """The spec's config with the kernels on, its depth cut (``layers``)
    and ``over`` applied."""
    from repro_torch.configs import get_config

    cfg = get_config(spec["arch"])
    if spec["reduced"]:
        cfg = cfg.reduced()
    over.setdefault("num_layers", spec.get("layers", cfg.num_layers))
    return dataclasses.replace(cfg, use_pallas_kernels=True, **over)


def describe(cfg) -> str:
    extra = ""
    if cfg.num_experts:
        extra = (f", {cfg.num_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff} (capacity "
                 f"factor {cfg.capacity_factor})")
    if cfg.family == "vlm":
        extra = f", {cfg.num_patches} patches of {cfg.patch_dim}"
    if cfg.family == "audio":
        extra = f", {cfg.num_codebooks} codebooks"
    window = cfg.window if cfg.attention == "swa" else "none (full causal)"
    return (f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters in {cfg.num_layers} "
            f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV heads "
            f"of {cfg.hd}, window {window}, vocab {cfg.padded_vocab}{extra}, {cfg.dtype}")


def free(torch) -> None:
    """Return the freed blocks to the card before a phase that needs most of it."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def slice_layers(tree, n: int):
    """The first ``n`` layers of a stacked (L, ...) parameter tree (views)."""
    return {k: slice_layers(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}


class RouteRecorder:
    """Inside ``with``, every MoE routing call (``nn.moe.route``) made by
    the model keeps its plan and stats in ``calls``, in call order."""

    def __enter__(self):
        from repro_torch.nn import moe

        self.calls, self._route = [], moe.route

        def route(*args, **kwargs):
            plan, stats = self._route(*args, **kwargs)
            self.calls.append((plan, stats))
            return plan, stats

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import moe

        moe.route = self._route


def routing_flips(torch, calls_a, calls_b, b: int, s: int):
    """(B, S) bool: the positions whose expert ids or keep flags differ
    between two runs' routings in any layer."""
    out = torch.zeros((b, s), dtype=torch.bool, device=calls_a[0][0].ids.device)
    for (pa, _), (pb, _) in zip(calls_a, calls_b):
        k = pa.ids.shape[1] // s
        differ = (pa.ids != pb.ids) | (pa.keep != pb.keep)
        out |= differ.reshape(b, s, k).any(-1)
    return out


def scoring_forward(torch, np, model, params, batch, label: str, ops) -> dict:
    """(a): the bf16 scoring forward through ``make_loss_fn``, the main
    path: one flash_attention launch a layer and a finite loss; then one
    more forward with CUDA events around ``ops`` (op_shares)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.steps import make_loss_fn

    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    with torch.no_grad():
        loss = make_loss_fn(model)(params, batch)
    torch.cuda.synchronize()
    launches = fa.launch_count()
    loss = float(loss)
    if launches != cfg.num_layers or not np.isfinite(loss):
        raise AssertionError(f"{label}(a) scoring forward: {launches} flash_attention launches "
                             f"(expected {cfg.num_layers}), loss {loss}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms, shares = op_shares(torch, model, params, batch, ops)
    return {"launches": launches, "loss": loss, "peak_gb": peak_gb, "forward_ms": fwd_ms,
            "shares": shares}


def serve_check(torch, spec, label: str, cfg) -> dict:
    """(c): ``launch.serve.serve`` at the spec's batch, prompt and
    generated length, bf16, seeded weights of the spec's depth."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    fa.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    res = serve.serve(spec["arch"], batch=spec["serve_batch"], prompt_len=spec["prompt"],
                      gen_len=spec["gen"], reduced=spec["reduced"], seed=spec["seed"],
                      device="cuda", layers=spec.get("layers"))
    toks = res["tokens"]
    shape = (spec["serve_batch"], spec["gen"]) + ((cfg.num_codebooks,) if cfg.num_codebooks
                                                  else ())
    if res["device"] != "cuda" or toks.shape != shape \
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{label}(c) serve: tokens {toks.shape} on {res['device']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}(c) serve B={spec['serve_batch']} prompt {spec['prompt']} gen {spec['gen']} "
          f"bf16: prefill {res['prefill_s']:.3f} s, decode {res['decode_tokens_per_s']:.1f} "
          f"tok/s ({res['decode_s']:.3f} s), {fa.launch_count()} flash_attention launches, "
          f"peak {peak_gb:.2f} GB", flush=True)
    return {"prefill_s": res["prefill_s"], "decode_tokens_per_s": res["decode_tokens_per_s"],
            "serve_peak_gb": peak_gb}


def route_check(torch, model32, params32, batch, label: str, tol: float) -> dict:
    """(b): f32 logits, the kernel route against the plain route, beside
    the plain route's response to one ulp of relative noise on the
    embeddings.  For an MoE model, the positions whose routing differs
    between the two runs (a near-tie flipped by rounding) are counted and
    left out of the bar."""
    from repro_torch.models import build_model

    cfg = model32.cfg
    plain32 = build_model(dataclasses.replace(cfg, use_pallas_kernels=False))
    emb = params32["embed"]
    noise = torch.randn(emb.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    nudged = dict(params32, embed=emb * (1 + 2**-24 * noise))
    del noise
    with torch.no_grad(), RouteRecorder() as r_kernel:
        routed, _ = model32.forward(params32, batch)
    with torch.no_grad(), RouteRecorder() as r_plain:
        plain, _ = plain32.forward(params32, batch)
    with torch.no_grad(), RouteRecorder() as r_ulp:
        moved, _ = plain32.forward(nudged, batch)
    del nudged
    b, s = routed.shape[:2]
    ulp_gap, scale = max_err(moved, plain)
    del moved
    diff = (routed - plain).abs_()
    del routed, plain
    flips = ulp_flips = 0
    if cfg.num_experts:
        flipped = routing_flips(torch, r_kernel.calls, r_plain.calls, b, s)
        flips = int(flipped.sum())
        ulp_flips = int(routing_flips(torch, r_ulp.calls, r_plain.calls, b, s).sum())
        diff = diff[~flipped]
    err = diff.max().item()
    del diff
    if not err <= tol * scale:
        raise AssertionError(f"{label}(b) f32 logits, kernel vs plain route: {err:.3e} > "
                             f"{tol} x {scale:.3e} ({flips} positions' routing flipped)")
    where = (f" on the {b * s - flips} of {b * s} positions whose routing agrees in every "
             f"layer ({flips} flipped; one ulp of noise flips {ulp_flips})"
             if cfg.num_experts else "")
    print(f"{label}(b) f32 forward ({cfg.num_layers} layers): logits kernel route vs plain route "
          f"max abs err {err:.3e}{where} (max|logits| {scale:.3e}, tol {tol} x max); one ulp "
          f"of noise on the embeddings moves the plain route's logits by {ulp_gap:.3e}",
          flush=True)
    return {"route_err": err / scale, "ulp_gap": ulp_gap / scale, "route_flips": flips,
            "ulp_flips": ulp_flips}


def decode_check(torch, model32, params32, prompt: dict, n0: int, gen: int, label: str,
                 tol: float, card: str) -> dict:
    """(d): f32 prefill + greedy decode logits at each generated position
    against the f32 forward through the kernel over the prompt and the
    generated tokens (a VLM's positions offset by its patches), and a
    decode step's host enqueue against the synchronized step."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.steps import make_serve_step

    cfg = model32.cfg
    off = cfg.num_patches if "patch_embeds" in prompt else 0
    tokens = prompt["tokens"]
    bsz = tokens.shape[0]
    step_shape = (bsz, 1) + tokens.shape[2:]
    step = make_serve_step(model32)
    enqueue, total = [], []
    with torch.no_grad():
        logits, cache = model32.prefill(params32, prompt, max_len=off + n0 + gen)
        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1)
        seq = [tok]
        for _ in range(gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, logits, cache = step(params32, {"tokens": tok.reshape(step_shape)}, cache)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits[:, -1])
            seq.append(tok)
        del cache
        full_toks = torch.cat([tokens, torch.stack(seq[:-1], dim=1)], dim=1)
        fa.reset_launch_count()
        full, _ = model32.forward(params32, dict(prompt, tokens=full_toks))
    got = torch.stack(steps, dim=1)                 # positions n0-1 .. n0+gen-1
    want = full[:, off + n0 - 1:off + n0 + gen]
    err, scale = max_err(got, want)
    if fa.launch_count() != cfg.num_layers or not err <= tol * scale:
        raise AssertionError(f"{label}(d) f32 prefill+decode vs forward: {err:.3e} > {tol} x "
                             f"{scale:.3e}, or {fa.launch_count()} launches")
    enqueue, total = sorted(enqueue[1:]), sorted(total[1:])
    depth = f"{cfg.num_layers} layers" + (f", capacity factor {cfg.capacity_factor:g}"
                                          if cfg.num_experts else "")
    print(f"{label}(d) f32 ({depth}) prefill {n0} + {gen} decode steps vs the forward over {off + full_toks.shape[1]} "
          f"positions (kernel route): max abs err {err:.3e} over {gen + 1} positions "
          f"(max|logits| {scale:.3e}, tol {tol} x max); a decode step B={bsz} (median of "
          f"{len(total)}) {total[len(total) // 2]:.3f} ms synchronized, of which "
          f"{enqueue[len(enqueue) // 2]:.3f} ms for the host to enqueue it, on {card}",
          flush=True)
    return {"decode_err": err / scale, "decode_step_ms": total[len(total) // 2],
            "decode_enqueue_ms": enqueue[len(enqueue) // 2]}


def moe_layer_checks(torch, model32, params32, tokens, label: str) -> dict:
    """12(b): each MoE layer's f32 call against the same function in
    float64 on the card, on the same input, with the f32 call's routing
    (its expert ids, slots and keep flags; float64 gates at those ids).
    The tokens whose float64 top-k differs from the f32 one are counted
    and left out of the bar."""
    from repro_torch.models import blocks
    from repro_torch.models.transformer import layer_views
    from repro_torch.nn import moe
    from repro_torch.nn.layers import rms_norm

    cfg = model32.cfg
    e, k = cfg.num_experts, cfg.top_k
    window = cfg.window if cfg.attention == "swa" else None
    worst, flips, rows = 0.0, [], []
    with torch.no_grad():
        x = model32._embed(params32, {"tokens": tokens})
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)
        cap = moe.capacity(s, e, k, cfg.capacity_factor)
        for i, lp in enumerate(layer_views(params32["layers"], cfg.num_layers)):
            h, _ = blocks.apply_attention(lp["attn"], rms_norm(x, lp["ln1"]), positions, cfg,
                                          None, window=window)
            x = x + h
            xn = rms_norm(x, lp["ln2"])
            f = lp["ffn"]
            out32, stats = moe.moe_ffn(xn, f["router"], f["wg"], f["wu"], f["wd"], top_k=k,
                                       capacity_factor=cfg.capacity_factor)
            plan, _ = moe.route(xn, f["router"], top_k=k, cap=cap)
            x64 = xn.double()
            probs64 = torch.softmax(x64 @ f["router"].double(), dim=-1)
            ids = plan.ids.reshape(b, s, k)
            g64 = torch.gather(probs64, -1, ids)
            g64 = g64 / torch.clamp(g64.sum(-1, keepdim=True), min=1e-9)
            plan64 = plan._replace(gates=g64.reshape(b, s * k))
            y64 = moe.expert_ffn(moe.dispatch(x64, plan64, e, cap), f["wg"].double(),
                                 f["wu"].double(), f["wd"].double())
            out64 = moe.combine(y64, plan64, s)
            del y64, x64
            flipped = (moe.top_k_stable(probs64, k)[1] != ids).any(-1)
            agree = ~flipped
            err = (out32.double() - out64).abs()[agree].max().item()
            scale = out64.abs().max().item()
            gap = err / scale
            worst = max(worst, gap)
            flips.append(int(flipped.sum()))
            rows.append((i, gap, int(flipped.sum()), float(stats.dropped)))
            del out64, probs64
            x = x + out32
    for i, gap, n, dropped in rows:
        print(f"{label}(b) layer {i}: f32 MoE vs float64 on the same input and routing, "
              f"{gap:.3e} x max|out| on the {b * s - n} tokens whose float64 top-{k} agrees "
              f"({n} flipped; dropped {dropped:.4f})", flush=True)
    if not worst <= MOE_LAYER_TOL:
        raise AssertionError(f"{label}(b) an MoE layer's f32 call differs from float64 by "
                             f"{worst:.3e} x max|out| > {MOE_LAYER_TOL}")
    return {"moe_layer_gap": worst, "f64_router_flips": flips}


def moe_slice(torch, np, card: str, spec: dict, label: str, full: bool) -> tuple[int, dict]:
    """An MoE model at its published widths and the spec's depth: (a) the
    bf16 scoring forward through the kernel, each layer's routing stats
    and where its time goes (attention, expert products, routing +
    dispatch + combine); (c) serving; with ``full`` also (b) f32 layers
    against float64 and the two routes, and (d) f32 prefill + decode at
    the no-drop capacity.  Returns the scoring forward's flash_attention
    launches (the main path) and a summary."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.models.steps import MOE_AUX_COEF
    from repro_torch.nn import moe

    free(torch)
    cfg = zoo_config(spec)
    whole = get_config(spec["arch"])
    s, seed = spec["score_seq"], spec["seed"]
    print(f"{describe(cfg)}; depth cut from {whole.num_layers} layers "
          f"({whole.param_count() / 1e9:.3f} B parameters): one card holds these layers' bf16 weights beside the activations",
          flush=True)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    host = next(iter(TokenStream(cfg.vocab_size, s, 1, seed=seed)))
    batch = {k: torch.as_tensor(a, device="cuda") for k, a in host.items()}

    # (a) The main path, its routing recorded (the recorder launches nothing).
    ops = ("flash_attention", (moe, "route"), (moe, "dispatch"), (moe, "expert_ffn"),
           (moe, "combine"))
    with RouteRecorder() as rec:
        a = scoring_forward(torch, np, model, params, batch, label, ops)
    sh, fwd = a["shares"], a["forward_ms"]
    attn_ms, calls = sh["flash_attention"]
    expert_ms = sh["expert_ffn"][0]
    parts = {name: sh[name][0] for name in ("route", "dispatch", "combine")}
    route_ms = sum(parts.values())
    rest = fwd - attn_ms - expert_ms - route_ms
    cap = moe.capacity(s, cfg.num_experts, cfg.top_k, cfg.capacity_factor)
    print(f"{label}(a) scoring forward B=1 S={s} bf16 ({cap} slots an expert): loss {a['loss']:.4f} (with {MOE_AUX_COEF} x the router aux loss), "
          f"{a['launches']} flash_attention launches, weights {weights_gb:.2f} GB (drawn in "
          f"{init_s:.1f} s), peak {a['peak_gb']:.2f} GB; {fwd:.3f} ms (CUDA events) = "
          f"flash_attention {attn_ms:.3f} ms over {calls} calls ({attn_ms / fwd:.1%}) + expert "
          f"products {expert_ms:.3f} ms ({expert_ms / fwd:.1%}) + routing, dispatch and combine "
          f"{route_ms:.3f} ms ({route_ms / fwd:.1%}: route {parts['route']:.3f}, dispatch "
          f"{parts['dispatch']:.3f}, combine {parts['combine']:.3f}; CUDA events around each "
          f"call in this forward) + the rest {rest:.3f} ms", flush=True)
    layers = rec.calls[:cfg.num_layers]
    dropped = [round(float(st.dropped), 5) for _, st in layers]
    busiest = [round(float(st.load.max()) * cfg.num_experts, 3) for _, st in layers]
    print(f"{label}(a) by layer: dropped share {dropped}; busiest expert's load / uniform "
          f"{busiest}", flush=True)
    summary = {"layers": cfg.num_layers, "params_b": cfg.param_count() / 1e9,
               "loss": a["loss"], "launches": a["launches"], "peak_gb": a["peak_gb"],
               "forward_ms": fwd, "flash_attention_ms": attn_ms, "expert_ms": expert_ms,
               "route_dispatch_combine_ms": route_ms, **{f"{k}_ms": v for k, v in parts.items()},
               "rest_ms": rest, "dropped": dropped,
               "busiest_load": busiest}
    del params, batch["labels"], rec, layers
    free(torch)

    summary.update(serve_check(torch, spec, label, cfg))
    free(torch)
    if not full:
        return a["launches"], summary

    # (b) f32 layers against float64, then the kernel route against the plain one.
    cfg32 = zoo_config(spec, dtype="float32", num_layers=spec["f32_layers"])
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(seed))
    summary.update(moe_layer_checks(torch, model32, params32, batch["tokens"], label))
    summary.update(route_check(torch, model32, params32, {"tokens": batch["tokens"]}, label,
                               ROUTE_TOL))

    # (d) Prefill + decode against the forward, at the no-drop capacity.
    n = spec["decode_layers"]
    cfg_d = dataclasses.replace(cfg32, num_layers=n, capacity_factor=NO_DROP_FACTOR)
    params_d = dict(params32, layers=slice_layers(params32["layers"], n))
    bsz, n0, gen = spec["serve_batch"], spec["prompt"], spec["gen"]
    prompt = {"tokens": torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, n0)), device="cuda")}
    summary.update(decode_check(torch, build_model(cfg_d), params_d, prompt, n0, gen, label,
                                DECODE_TOL, card))
    del params32, params_d
    free(torch)
    return a["launches"], summary


def vlm_slice(torch, np, card: str, spec: dict = VLM, label: str = "13 ") -> tuple[int, dict]:
    """InternVL2-1B whole: (a) the bf16 scoring forward over the patches
    and the text, the prefix ignored by the loss; (b) f32 kernel route vs
    plain route; (c) serving with patches; (d) f32 prefill + decode
    against the forward, offset by the patches."""
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model

    free(torch)
    cfg = zoo_config(spec)
    s, seed = spec["score_seq"], spec["seed"]
    text = s - cfg.num_patches
    print(describe(cfg) + "; the vision encoder stubbed by seeded normal patch embeddings",
          flush=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    host = next(iter(TokenStream(cfg.vocab_size, text, 1, seed=seed)))
    batch = {k: torch.as_tensor(a, device="cuda") for k, a in host.items()}
    patches = np.random.default_rng(seed).normal(size=(1, cfg.num_patches, cfg.patch_dim))
    batch["patch_embeds"] = torch.as_tensor(patches, dtype=torch.float32, device="cuda")
    a = scoring_forward(torch, np, model, params, batch, label, ("flash_attention",))
    fwd = a["forward_ms"]
    attn_ms, calls = a["shares"]["flash_attention"]
    print(f"{label}(a) scoring forward B=1, {cfg.num_patches} patches + {text} tokens = {s} "
          f"positions, bf16: loss {a['loss']:.4f} over the text (the visual prefix ignored), "
          f"{a['launches']} flash_attention launches, peak {a['peak_gb']:.2f} GB; {fwd:.3f} ms "
          f"(CUDA events) = flash_attention {attn_ms:.3f} ms over {calls} calls "
          f"({attn_ms / fwd:.1%}) + the rest {fwd - attn_ms:.3f} ms", flush=True)
    summary = {"loss": a["loss"], "launches": a["launches"], "peak_gb": a["peak_gb"],
               "forward_ms": fwd, "flash_attention_ms": attn_ms, "rest_ms": fwd - attn_ms}
    del params
    free(torch)
    summary.update(serve_check(torch, spec, label, cfg))

    cfg32 = zoo_config(spec, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(seed))
    scored = {"tokens": batch["tokens"], "patch_embeds": batch["patch_embeds"]}
    summary.update(route_check(torch, model32, params32, scored, label, ROUTE_TOL))
    bsz, n0, gen = spec["serve_batch"], spec["prompt"], spec["gen"]
    rng = np.random.default_rng(seed)
    prompt = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (bsz, n0)),
                                        device="cuda"),
              "patch_embeds": torch.as_tensor(rng.normal(size=(bsz, cfg.num_patches,
                                                               cfg.patch_dim)),
                                              dtype=torch.float32, device="cuda")}
    summary.update(decode_check(torch, model32, params32, prompt, n0, gen, label, DECODE_TOL,
                                card))
    del params32
    free(torch)
    return a["launches"], summary


def audio_slice(torch, np, card: str, spec: dict = AUDIO,
                label: str = "14 ") -> tuple[int, dict]:
    """MusicGen-medium whole: (a) the bf16 scoring forward over (B, S, nc)
    codebook grids; (b) f32 kernel route vs plain route; (c) serving
    (B, gen, nc) frames; (d) f32 prefill + decode against the forward."""
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model

    free(torch)
    cfg = zoo_config(spec)
    s, bsz_a, seed = spec["score_seq"], spec["score_batch"], spec["seed"]
    print(describe(cfg) + "; the EnCodec codec stubbed by the token grid", flush=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    host = next(iter(TokenStream(cfg.vocab_size, s, bsz_a, seed=seed,
                                 num_codebooks=cfg.num_codebooks)))
    batch = {k: torch.as_tensor(a, device="cuda") for k, a in host.items()}
    a = scoring_forward(torch, np, model, params, batch, label, ("flash_attention",))
    fwd = a["forward_ms"]
    attn_ms, calls = a["shares"]["flash_attention"]
    print(f"{label}(a) scoring forward B={bsz_a} S={s} frames x {cfg.num_codebooks} codebooks "
          f"bf16: loss {a['loss']:.4f}, {a['launches']} flash_attention launches, peak "
          f"{a['peak_gb']:.2f} GB; {fwd:.3f} ms (CUDA events) = flash_attention {attn_ms:.3f} "
          f"ms over {calls} calls ({attn_ms / fwd:.1%}) + the rest {fwd - attn_ms:.3f} ms",
          flush=True)
    summary = {"loss": a["loss"], "launches": a["launches"], "peak_gb": a["peak_gb"],
               "forward_ms": fwd, "flash_attention_ms": attn_ms, "rest_ms": fwd - attn_ms}
    del params
    free(torch)
    summary.update(serve_check(torch, spec, label, cfg))

    cfg32 = zoo_config(spec, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(seed))
    summary.update(route_check(torch, model32, params32, {"tokens": batch["tokens"]}, label,
                               ROUTE_TOL))
    bsz, n0, gen = spec["serve_batch"], spec["prompt"], spec["gen"]
    grid = np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, n0, cfg.num_codebooks))
    summary.update(decode_check(torch, model32, params32,
                                {"tokens": torch.as_tensor(grid, device="cuda")}, n0, gen,
                                label, DECODE_TOL, card))
    del params32
    free(torch)
    return a["launches"], summary


# ---------------------------------------------------------------- phase 16
# Model-zoo training and the layer-wise readout at published widths.
# (a) H2O-Danube3-4B whole (24 layers, bf16 params, f32 moments, the
# config's remat) through launch.train.train at repro's train_4k sequence
# length, its batch of 256 cut to 1.
ZOO_TRAIN = {"arch": "h2o_danube3_4b", "batch": 1, "seq": 4096, "steps": 6, "lr": 3e-4}
# (b) One layer in f32 (TF32 off), card against a CPU copy of the same
# seeded weights and batch.  Both sum the same f32 products in different
# orders (K up to d_ff = 10240 terms, an error of order sqrt(K) 2**-24 ~
# 6e-6 of a sum), so: loss and grad_norm within 1e-5 relative, each
# gradient leaf within 1e-4 x max|leaf|.
GRAD_CHECK = {"arch": "h2o_danube3_4b", "layers": 1, "batch": 1, "seq": 256, "lr": 3e-4}
GRAD_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "leaf": 1e-4}
# (c) Two steps of every other family, depth cut to what one card holds
# beside the gradients and the f32 moments (16 bytes a parameter).  The
# rate is 1e-2 so that two steps move every bf16 leaf: a norm weight at
# 1.0 has a bf16 spacing of 2**-8 below it, which a 3e-4 step leaves
# unchanged (in repro as here).
FAMILY_STEPS = (
    ("zamba2_2_7b", {"layers": 6, "seq": 2048, "batch": 1}),    # one period + the shared block
    ("xlstm_350m", {"layers": None, "seq": 1024, "batch": 1}),
    ("phi35_moe_42b", {"layers": 2, "seq": 2048, "batch": 1}),
    ("mixtral_8x22b", {"layers": 1, "seq": 2048, "batch": 1}),  # inside its 4096 window
    ("internvl2_1b", {"layers": None, "seq": 2048, "batch": 1}),  # 256 patches + 1792 tokens
    ("musicgen_medium", {"layers": None, "seq": 1500, "batch": 2}),
)
FAMILY_LR = 1e-2
# (d) The readout over the frozen whole Danube (bf16, kernels on): J = B S
# tokens, a planted label (tokens_t + tokens_{t-1}) mod Q, one readout per
# tap (the embedding and each layer's output).  Every flash_attention call
# of (d) is held against its plain version on the same inputs, and every
# gram call against the float64 Gram of its input (``held_gram_calls``).
# The last tap split over M=4 workers of 1024 samples, each fewer than its
# 3840 features, with singular values spanning more than three decades:
# consensus ADMM at mu=1e-2 approaches the centralized readout slowly
# there, so examples/layerwise_readout.py's 1e-2 at K=200 is printed
# beside the gap, not held.  What is held: the K=200 decentralized and
# centralized solves each against the same consensus computed on the same
# blocks in float64 by an independent plain loop (``consensus_f64``),
# within ULP_FACTOR x the decentralized solve's own response to one ulp of
# input noise, and the K=1000 gap below a quarter of the K=200 one.  The
# float64 solves' gap shows the creep is the algorithm's on this tap.
# (e) the sharded solver on 4 gloo ranks against the simulated
# M=4 solve on the same blocks.  A rank factors its own G = Y_m Y_m^T + I/mu
# where the simulated solve factors the four as one batch, and the two
# round differently; at mu=1e-2 the ill-conditioned G turns that into
# gaps of the order of the simulated solve's own response to one ulp of
# input noise, which the phase measures.  So 1e-4 x max|z| is held at
# mu=1e-6 (G near the identity times 1e6), and at mu=1e-2 the gap is held
# to 10x that one-ulp response.
READOUT = {"arch": "h2o_danube3_4b", "batch": 2, "seq": 2048, "q": 10, "mu": 1e-2,
           "iters": 50, "dec_iters": (200, 1000), "workers": 4, "sharded_iters": 100,
           "sharded_mus": (1e-2, 1e-6), "ranks": 4, "seed": 0}
EXAMPLE_GAP = 1e-2
GAP_SHRINK = 4.0
SHARDED_TOL = 1e-4
ULP_FACTOR = 10.0


class GradCapture:
    """An optimizer that keeps the gradients it is given, then updates as
    ``inner`` does: how (b) reads the train step's gradient."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state):
        self.grads = grads
        return self.inner.update(params, grads, state)


def kernel_counters():
    from repro_torch.kernels import (flash_attention, gram, matmul_relu, mlstm_scan,
                                     propagate_gram, ssm_scan)

    return {m.__name__.rsplit(".", 1)[-1]: m for m in (
        matmul_relu, gram, propagate_gram, flash_attention, ssm_scan, mlstm_scan)}


def timed_train(torch, arch: str, count_flops: bool = False, **kw) -> dict:
    """``launch.train.train`` with each train step, and the AdamW update
    inside it, synchronized and timed (``make_train_step``,
    ``build_model`` and ``AdamW`` wrapped for the call), the card's peak
    memory and every kernel counter read around it.  Also the bytes
    allocated on the card from just before ``model.init`` to just after
    ``opt.init`` (params, moments and step), and with ``count_flops`` the
    FLOPs of the first step as ``FlopCounterMode`` counts them (phase
    17(b) holds its dry run to both)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import train as train_lib

    counters = kernel_counters()
    step_ms, update_ms, step_flops, alloc = [], [], [], {}
    real, real_opt, real_build = (train_lib.make_train_step, train_lib.AdamW,
                                  train_lib.build_model)

    def measured_build(cfg):
        model = real_build(cfg)
        init = model.init

        def measured_init(gen):
            torch.cuda.synchronize()
            alloc["before_init"] = torch.cuda.memory_allocated()
            return init(gen)

        model.init = measured_init
        return model

    class TimedAdamW(real_opt):
        def init(self, params):
            state = super().init(params)
            torch.cuda.synchronize()
            alloc["after_opt_init"] = torch.cuda.memory_allocated()
            return state

        def update(self, params, grads, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().update(params, grads, state)
            torch.cuda.synchronize()
            update_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    def timed_make(model, opt):
        step = real(model, opt)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step_flops or not count_flops:
                out = step(*args)
            else:   # the first step, left out of the steady median
                with FlopCounterMode(display=False) as counter:
                    out = step(*args)
                step_flops.append(counter.get_total_flops())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    for c in counters.values():
        c.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.reset_accumulated_memory_stats()
    train_lib.make_train_step, train_lib.AdamW = timed_make, TimedAdamW
    train_lib.build_model = measured_build
    try:
        losses = train_lib.train(arch, reduced=False, device="cuda", log_every=1, **kw)
    finally:
        train_lib.make_train_step, train_lib.AdamW = real, real_opt
        train_lib.build_model = real_build
    launched = {k: c.launch_count() for k, c in counters.items() if c.launch_count()}
    if launched:
        raise AssertionError(f"16 {arch}: training launched kernels {launched}; it must take "
                             "the plain path (no kernel has a backward)")
    return {"losses": losses, "step_ms": step_ms, "update_ms": update_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            # None where the caller passed its own params (no model.init).
            "init_bytes": (alloc["after_opt_init"] - alloc["before_init"]
                           if "before_init" in alloc else None),
            "step_flops": step_flops[0] if step_flops else None,
            "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0)}


def train_danube(torch, np, card: str) -> dict:
    """16(a): H2O-Danube3-4B whole, 6 AdamW steps through launch.train."""
    from repro_torch.configs import get_config


    spec = ZOO_TRAIN
    cfg = get_config(spec["arch"])
    free(torch)
    print(f"16(a) {describe(cfg)}; remat {cfg.remat}, AdamW(lr={spec['lr']}) with f32 "
          f"moments, B={spec['batch']} S={spec['seq']}", flush=True)
    run = timed_train(torch, spec["arch"], count_flops=True, steps=spec["steps"],
                      batch=spec["batch"], seq=spec["seq"], lr=spec["lr"])
    losses, ms = run["losses"], run["step_ms"]
    if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"16(a) losses {losses}: not finite, or the last two's mean is "
                             "not below the first")
    tokens = spec["batch"] * spec["seq"]
    steady = float(np.median(ms[1:]))
    update = float(np.median(run["update_ms"][1:]))
    flops = 6 * cfg.param_count() * tokens
    print(f"16(a) losses {[round(x, 4) for x in losses]}; step ms {[round(x, 1) for x in ms]} "
          f"(synchronized; median of steps 2-{len(ms)} {steady:.1f} ms, "
          f"{tokens / steady * 1e3:.0f} tokens/s; of it the AdamW update {update:.1f} ms, "
          f"the loss, its gradient and grad_norm {steady - update:.1f} ms); peak "
          f"{run['peak_gb']:.2f} GB, caching-allocator retries {run['alloc_retries']} (each "
          f"frees the cached blocks and waits for the card); 6*N*T / step = "
          f"{flops / steady / 1e9:.1f} TFLOP/s (information only: remat runs each layer's "
          f"forward twice) on {card}", flush=True)
    print(f"16(a) card bytes from model.init to opt.init {run['init_bytes']}; the first "
          f"step's FlopCounterMode count {run['step_flops']:.6e} (that step is counted, so "
          f"its time is left out of the median)", flush=True)
    return {"arch": spec["arch"], "layers": cfg.num_layers, "losses": losses, "step_ms": ms,
            "steady_ms": steady, "update_ms": update, "tokens_per_s": tokens / steady * 1e3,
            "peak_gb": run["peak_gb"], "peak_bytes": run["peak_bytes"],
            "init_bytes": run["init_bytes"], "step_flops": run["step_flops"],
            "alloc_retries": run["alloc_retries"], "model_tflops": flops / steady / 1e9}


def grad_check(torch, np, card: str) -> dict:
    """16(b): one make_train_step of one full-width Danube layer in f32 on
    the card and on a CPU copy of the same weights and batch."""
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamW

    spec = GRAD_CHECK
    free(torch)
    cfg = dataclasses.replace(get_config(spec["arch"]), num_layers=spec["layers"],
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    host = _tree.map_(lambda t: t.cpu(), params)
    batch = next(iter(TokenStream(cfg.vocab_size, spec["seq"], spec["batch"], seed=0)))
    out = {}
    for dev, p in (("cuda", params), ("cpu", host)):
        opt = GradCapture(AdamW(lr=spec["lr"]))
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        _, _, metrics = make_train_step(model, opt)(p, opt.init(p), b)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        out[dev] = (loss, gnorm, _tree.leaves(opt.grads), time.perf_counter() - t0)
    (l_c, n_c, g_c, s_c), (l_h, n_h, g_h, s_h) = out["cuda"], out["cpu"]
    worst, names = -1.0, None
    paths = _tree.leaves(_paths(params))
    for name, a, b in zip(paths, g_c, g_h):
        gap = float((a.cpu() - b).abs().max() / b.abs().max())
        if gap > worst:
            worst, names = gap, name
    loss_gap, norm_gap = abs(l_c - l_h) / abs(l_h), abs(n_c - n_h) / abs(n_h)
    print(f"16(b) {cfg.name} 1 layer f32 ({cfg.param_count() / 1e9:.3f} B), B={spec['batch']} "
          f"S={spec['seq']}: loss card {l_c:.7f} cpu {l_h:.7f} (rel {loss_gap:.2e}), grad_norm "
          f"card {n_c:.6f} cpu {n_h:.6f} (rel {norm_gap:.2e}); worst leaf {names} "
          f"{worst:.3e} x max|g|; step {s_c:.2f} s on the card, {s_h:.2f} s on the CPU "
          f"({card})", flush=True)
    if not (loss_gap <= GRAD_TOL["loss"] and norm_gap <= GRAD_TOL["grad_norm"]
            and worst <= GRAD_TOL["leaf"]):
        raise AssertionError(f"16(b) card vs CPU: loss {loss_gap:.2e}, grad_norm "
                             f"{norm_gap:.2e}, leaf {names} {worst:.2e} (bars {GRAD_TOL})")
    del params, host, out
    return {"loss_rel": loss_gap, "grad_norm_rel": norm_gap, "worst_leaf": names,
            "worst_leaf_rel": worst, "card_s": s_c, "cpu_s": s_h}


def _paths(tree, prefix=""):
    """The tree with each leaf replaced by its key path, 'a.b.c'."""
    return {k: _paths(v, f"{prefix}{k}.") if isinstance(v, dict) else f"{prefix}{k}"
            for k, v in tree.items()}


def family_steps(torch, np, card: str) -> dict:
    """16(c): two train steps of each other family at published widths,
    depth cut as FAMILY_STEPS says."""
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    out = {}
    for arch, spec in FAMILY_STEPS:
        free(torch)
        cfg = get_config(arch)
        whole = cfg.num_layers
        if spec["layers"] is not None:
            cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
        params = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
        before = [t.clone() for t in _tree.leaves(params)]
        run = timed_train(torch, arch, steps=2, batch=spec["batch"], seq=spec["seq"],
                          lr=FAMILY_LR, params=params, layers=spec["layers"])
        after = _tree.leaves(params)
        with torch.no_grad():
            same = [i for i, (a, b) in enumerate(zip(before, after)) if torch.equal(a, b)]
            finite = all(bool(torch.isfinite(t).all()) for t in after)
        state_gb = sum(t.numel() * (2 * t.element_size() + 8) for t in after) / 1e9
        cut = f"{cfg.num_layers} of {whole} layers" if spec["layers"] else "whole"
        if cfg.family == "vlm":
            cut += f"; {cfg.num_patches} patches + {spec['seq'] - cfg.num_patches} tokens"
        print(f"16(c) {describe(cfg)} ({cut}), B={spec['batch']} S={spec['seq']}: "
              f"losses {[round(x, 4) for x in run['losses']]}, step ms "
              f"{[round(x, 1) for x in run['step_ms']]} (AdamW "
              f"{[round(x, 1) for x in run['update_ms']]}), peak {run['peak_gb']:.2f} GB "
              f"(params + grads + moments {state_gb:.1f} GB); leaves unchanged {len(same)} of "
              f"{len(after)} on {card}", flush=True)
        if not all(np.isfinite(run["losses"])) or same or not finite:
            raise AssertionError(f"16(c) {arch}: losses {run['losses']}, unchanged leaves "
                                 f"{same}, params finite {finite}")
        out[arch] = {"layers": cfg.num_layers, "losses": run["losses"],
                     "step_ms": run["step_ms"], "update_ms": run["update_ms"],
                     "peak_gb": run["peak_gb"]}
        del params, before, after
    return out


def tap_features(torch, model, params, tokens):
    """The frozen backbone's embedding and every layer's output, each as a
    (d, B*S) f32 feature matrix (examples/layerwise_readout.py's taps)."""
    from repro_torch.models import blocks
    from repro_torch.models.transformer import layer_views
    from repro_torch.nn.layers import embed_lookup

    cfg = model.cfg
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    taps = [x]
    for layer_p in layer_views(params["layers"], cfg.num_layers):
        x, _, _ = blocks.apply_transformer_layer(layer_p, x, positions, cfg, None)
        taps.append(x)
    return [t.reshape(-1, cfg.d_model).T.float().contiguous() for t in taps]


def _clone(out):
    """A copy of a kernel op's result: a tensor or a nest of tuples of them."""
    return tuple(_clone(t) for t in out) if isinstance(out, tuple) else out.clone()


class OpRecorder:
    """Inside ``with``, every call of ``module.name`` (a kernel's op)
    keeps its arguments and a copy of its result in ``calls``, so that
    each can be held against the plain version after the timed work;
    with ``copy_args`` a copy of its tensor arguments too, for callers
    that reuse their buffers.  The copies are made outside any dispatch
    mode, so that a cost analysis recording the call does not count them."""

    def __init__(self, module, name, copy_args: bool = False):
        self.module, self.name, self.calls = module, name, []
        self.copy_args = copy_args

    def __enter__(self):
        self._op = op = getattr(self.module, self.name)

        def call(*args, **kwargs):
            from torch.utils._python_dispatch import _disable_current_modes

            with _disable_current_modes():
                kept = _clone(tuple(args)) if self.copy_args else args
            out = op(*args, **kwargs)
            with _disable_current_modes():
                self.calls.append((kept, kwargs, _clone(out)))
            return out

        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._op)


def held_gram_calls(torch, calls) -> tuple[float, float]:
    """Over the recorded gram calls, the worst distance of the kernel's G
    from the float64 Gram of the same input, in f32 ulps of max|G| (the
    GRAM_F64_CASES bar), and the same for the f32 plain version.  The
    float64 Gram is the judge here: the tap features keep one sign along
    many rows, so the f32 plain Gram's own rounding grows with J (no
    cancellation) past ``gram_tol``.  Each G must be exactly symmetric."""
    from repro_torch.kernels.gram import gram_ref

    worst = worst_plain = 0.0
    for (y,), kw, got in calls:
        if not torch.equal(got, got.mT):
            raise AssertionError(f"gram y{tuple(y.shape)}: G not exactly symmetric")
        y64 = y.double()
        want = y64 @ y64.mT + torch.eye(y.shape[-2], dtype=torch.float64,
                                        device=y.device) / kw["mu"]
        ulp = 2.0**-24 * want.abs().max()
        worst = max(worst, float((got.double() - want).abs().max() / ulp))
        worst_plain = max(worst_plain,
                          float((gram_ref(y, **kw).double() - want).abs().max() / ulp))
        del y64, want
    return worst, worst_plain


def held_flash_calls(calls) -> float:
    """The worst over the recorded flash_attention calls and their
    elements of (|kernel - plain| - FLASH_REL |plain|) / (1e-5 max|plain|)
    (<= 1 passes: ``flash_excess``'s bar)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    worst = -float("inf")
    for (q, k, v), kw, got in calls:
        _, floor, excess = flash_excess(got, flash_attention_ref(q, k, v, **kw),
                                        str(q.dtype).rsplit(".", 1)[-1])
        worst = max(worst, (excess + floor) / floor)
    return worst


def consensus_f64(torch, yw, tw, mu: float, eps: float, iters: int):
    """Consensus ADMM under the exact mean (paper Algorithm 1) in float64,
    written apart from ``core/admm.py``: one inverse of each worker's G,
    the mean over the worker dim, the Frobenius projection.  (Q, n)."""
    y, t = yw.double(), tw.double()
    eye = torch.eye(y.shape[1], dtype=torch.float64, device=y.device)
    g_inv = torch.linalg.inv(y @ y.mT + eye / mu)
    a = t @ y.mT
    z, lam = torch.zeros_like(a[0]), torch.zeros_like(a)
    for _ in range(iters):
        o = (a + (z - lam) / mu) @ g_inv
        avg = (o + lam).mean(0)
        z = avg * torch.clamp(eps / torch.linalg.vector_norm(avg), max=1.0)
        lam = lam + o - z
    return z


def _readout_rank(group, y, t, spec):
    """16(e) on one rank: the sharded solver over this rank's block, at
    each of ``sharded_mus``."""
    import torch

    from repro_torch.core import readout

    y, t = torch.from_numpy(y).to(group.device), torch.from_numpy(t).to(group.device)
    out = []
    for mu in spec["sharded_mus"]:
        solver = readout.make_sharded_layer_solver(
            group, mu=mu, eps_radius=2.0 * spec["q"], num_iters=spec["sharded_iters"])
        out.append(solver(y, t).z.cpu().numpy())
    return out


def readout_slice(torch, np, card: str) -> tuple[dict, dict]:
    """16(d) and (e).  Returns (gram and flash_attention launches, summary)."""
    from repro_torch.configs import get_config
    from repro_torch.core import admm, readout
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import blocks, build_model

    spec = READOUT
    free(torch)
    counters = kernel_counters()
    cfg = dataclasses.replace(get_config(spec["arch"]), use_pallas_kernels=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(spec["seed"]))
    b, s, q, mu = spec["batch"], spec["seq"], spec["q"], spec["mu"]
    rng = np.random.default_rng(spec["seed"])
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    labels = (toks + np.pad(toks, ((0, 0), (1, 0)))[:, :-1]) % q      # token t-1 = 0 at t = 0
    labels = torch.as_tensor(labels.reshape(-1), device="cuda")
    targets = torch.nn.functional.one_hot(labels, q).T.float().contiguous()
    for c in counters.values():
        c.reset_launch_count()
    t0 = time.perf_counter()
    with torch.no_grad(), OpRecorder(blocks, "flash_attention") as flash_calls:
        feats = tap_features(torch, model, params, torch.as_tensor(toks, device="cuda"))
        torch.cuda.synchronize()
    tap_s = time.perf_counter() - t0
    with torch.no_grad(), OpRecorder(admm, "gram") as gram_calls:
        del params
        free(torch)
        t0 = time.perf_counter()
        fit = readout.layerwise_backbone_fit(feats, targets, mu=mu, num_iters=spec["iters"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        costs = fit.layer_costs.tolist()
        acc = [float((torch.argmax(o @ y, dim=0) == labels).float().mean())
               for o, y in zip(fit.readouts, feats)]
        launches = {"flash_attention": counters["flash_attention"].launch_count(),
                    "gram": counters["gram"].launch_count()}
        n, j = feats[0].shape
        print(f"16(d) taps of {cfg.name} whole (bf16, kernels on), B={b} S={s}: J={j} tokens, "
              f"{len(feats)} taps of ({n}, {j}) f32 in {tap_s:.2f} s; layerwise_backbone_fit "
              f"mu={mu} K={spec['iters']} in {fit_s:.2f} s; launches {launches}; costs "
              f"{[round(c, 1) for c in costs]}; train accuracy on (t_i + t_(i-1)) mod {q} "
              f"{[round(a, 4) for a in acc]} on {card}", flush=True)
        if launches != {"flash_attention": cfg.num_layers, "gram": len(feats)} or \
                not all(np.isfinite(costs)):
            raise AssertionError(f"16(d) launches {launches} (expected {cfg.num_layers} "
                                 f"flash_attention, {len(feats)} gram) or costs {costs}")

        # The last tap over M workers, contiguous sample blocks.
        m, y, eps = spec["workers"], feats[-1], 2.0 * q
        sv = torch.linalg.svdvals(y)
        cond = float((sv[0] ** 2 + 1 / mu) / (sv[-1] ** 2 + 1 / mu))
        print(f"16(d) last tap: singular values {float(sv[-1]):.4g} to {float(sv[0]):.4g}; "
              f"Y Y^T + I/mu has condition number {cond:.4g} at mu={mu}", flush=True)
        yw = y.reshape(n, m, j // m).transpose(0, 1).contiguous()
        tw = targets.reshape(q, m, j // m).transpose(0, 1).contiguous()

        def rel(a, b):
            return float(torch.linalg.norm(a.double() - b.double()) / torch.linalg.norm(b))

        gaps, solves = [], {}
        t0 = time.perf_counter()
        for k in spec["dec_iters"]:
            dec = admm.admm_ridge_consensus(yw, tw, mu=mu, eps_radius=eps, num_iters=k,
                                            trace_every=0).o_star
            cen = readout.fit_readout(y, targets, mu=mu, eps_radius=eps, num_iters=k)
            gaps.append(rel(dec, cen))
            solves.setdefault("dec", dec)
            solves.setdefault("cen", cen)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        k0 = spec["dec_iters"][0]
        up = torch.nextafter(yw, torch.full_like(yw, float("inf")))
        moved = admm.admm_ridge_consensus(up, tw, mu=mu, eps_radius=eps, num_iters=k0,
                                          trace_every=0).o_star
        dec_ulp = rel(moved, solves["dec"])
        dec64 = consensus_f64(torch, yw, tw, mu, eps, k0)
        cen64 = consensus_f64(torch, y[None], targets[None], mu, eps, k0)
        errs64 = {"dec": rel(solves["dec"], dec64), "cen": rel(solves["cen"], cen64)}
        gap64 = rel(dec64, cen64)
        del moved, dec64, cen64, solves

        def simulated(y_blocks, mu_):
            return admm.admm_ridge_consensus(y_blocks, tw, mu=mu_, eps_radius=eps,
                                             num_iters=spec["sharded_iters"]).o_star

        sims = [simulated(yw, mu_) for mu_ in spec["sharded_mus"]]
        ulp = float((simulated(up, spec["sharded_mus"][0]) - sims[0]).abs().max()
                    / sims[0].abs().max())
        launches["gram"] = counters["gram"].launch_count()
    expect = len(feats) + 2 * len(gaps) + 1 + len(sims) + 1
    bar64 = ULP_FACTOR * dec_ulp
    print(f"16(d) decentralized M={m} vs centralized readout of the last tap: rel gap "
          f"{gaps[0]:.3e} at K={k0} (the example's bar {EXAMPLE_GAP}; {gap64:.3e} between "
          f"the same two solves in float64), {gaps[1]:.3e} at K={spec['dec_iters'][1]} (held "
          f"below 1/{GAP_SHRINK:g} of the first); at K={k0} against the float64 consensus: "
          f"decentralized {errs64['dec']:.3e}, centralized {errs64['cen']:.3e} (bar "
          f"{bar64:.3e}: {ULP_FACTOR:g}x the decentralized solve's one-ulp response "
          f"{dec_ulp:.3e}); {dec_s:.2f} s; gram launches {launches['gram']} (one more a "
          f"further solve)", flush=True)
    if not gaps[1] < gaps[0] / GAP_SHRINK or launches["gram"] != expect or \
            not max(errs64.values()) <= bar64:
        raise AssertionError(f"16(d) decentralized gaps {gaps}, float64 errors {errs64} "
                             f"(bar {bar64:.3e}), gram launches {launches['gram']} "
                             f"(expected {expect})")
    with torch.no_grad():
        gram_ulps, plain_ulps = held_gram_calls(torch, gram_calls.calls)
        held = {"flash_attention": held_flash_calls(flash_calls.calls),
                "gram": gram_ulps / GRAM_F64_ULPS}
    print(f"16(d) every kernel call of (d) on the same inputs: flash_attention against its "
          f"plain version, worst error over its bar {held['flash_attention']:.3f} over "
          f"{len(flash_calls.calls)} calls; gram against the float64 Gram, worst "
          f"{gram_ulps:.2f} f32 ulps of max|G| (bar {GRAM_F64_ULPS}; the f32 plain version "
          f"{plain_ulps:.2f}) over {len(gram_calls.calls)} calls", flush=True)
    if not (max(held.values()) <= 1.0 and len(flash_calls.calls) == launches["flash_attention"]
            and len(gram_calls.calls) == launches["gram"]):
        raise AssertionError(f"16(d) kernel vs plain {held} (<= 1 passes), calls "
                             f"{len(flash_calls.calls)}/{len(gram_calls.calls)}")
    del flash_calls, gram_calls
    with torch.no_grad():
        y_host, t_host = y.cpu().numpy(), targets.cpu().numpy()
        sims = [z.cpu().numpy() for z in sims]
        del feats, fit, y, yw, tw, up
    free(torch)
    t0 = time.perf_counter()
    zs = mesh_lib.spawn_workers(_readout_rank, spec["ranks"], y_host, t_host, spec,
                                backend="gloo", device="cuda", join_timeout_s=300)
    wall = time.perf_counter() - t0
    errs = [max(float(np.abs(z[i] - sim).max()) for z in zs) / float(np.abs(sim).max())
            for i, sim in enumerate(sims)]
    bars = [ULP_FACTOR * ulp, SHARDED_TOL]
    print(f"16(e) make_sharded_layer_solver on {spec['ranks']} gloo ranks sharing the card, "
          f"K={spec['sharded_iters']}: max|z - simulated| / max|z| = {errs[0]:.3e} at mu="
          f"{spec['sharded_mus'][0]} (bar {bars[0]:.3e}: {ULP_FACTOR:g}x the simulated "
          f"solve's one-ulp response {ulp:.3e}), {errs[1]:.3e} at mu={spec['sharded_mus'][1]} "
          f"(bar {SHARDED_TOL}); {wall:.2f} s wall, the spawn included", flush=True)
    if not all(e <= b for e, b in zip(errs, bars)):
        raise AssertionError(f"16(e) sharded vs simulated {errs} (bars {bars})")
    return launches, {"tap_s": tap_s, "fit_s": fit_s, "costs": costs, "accuracy": acc,
                      "decentralized_gaps": dict(zip(spec["dec_iters"], gaps)),
                      "decentralized_s": dec_s, "ulp_response": ulp,
                      "float64_errs": errs64, "float64_gap": gap64, "dec_ulp_response": dec_ulp,
                      "kernel_vs_plain": held, "gram_f64_ulps": gram_ulps,
                      "gram_plain_f64_ulps": plain_ulps,
                      "singular_values": [float(sv[-1]), float(sv[0])], "condition": cond,
                      "sharded_errs": dict(zip(spec["sharded_mus"], errs)),
                      "sharded_wall_s": wall}


def zoo_train_slice(torch, np, card: str) -> tuple[dict, dict]:
    """Phase 16: (a)-(e).  Returns the main path's gram and
    flash_attention launches (the readout's) and a summary."""
    t0 = time.perf_counter()
    summary = {"card": card, "danube": train_danube(torch, np, card),
               "grad_check": grad_check(torch, np, card),
               "families": family_steps(torch, np, card)}
    launches, summary["readout"] = readout_slice(torch, np, card)
    summary["phase_s"] = time.perf_counter() - t0
    print(f"16 done in {summary['phase_s']:.1f} s", flush=True)
    print(json.dumps({"zoo_train": summary}), flush=True)
    return launches, summary


# Phase 17: the dry-run planners.  (a) repro's readout defaults
# (launch/dryrun_dssfn.py: n=4096, Q=32, 1048576 tokens, K=100) on the
# 16x16 plan of 256 H100s, one rank's share (J=4096) solved on the card
# under the cost analysis.  Its FLOPs are held to the matrix products (the
# count leaves out factors and triangular solves, as repro's hlo_analysis
# does): 2(n+Q)nJ for the local statistics, and for ADMM 2QnJ for each of
# the K objective terms; 1% covers nothing but rounding of the sums, since
# both are exact integer counts.  (b) The 1x1 plan of 16(a)'s train step:
# the plan's params, moments and step against the card's allocation from
# model.init to opt.init within 1% (the caching allocator rounds each
# block up to 512 bytes); the trace's live peak plus arguments against
# 16(a)'s max_memory_allocated within 15% (the trace sees PyTorch's ops,
# not the allocator's blocks, cuBLAS workspaces or fragmentation); its
# FLOPs against FlopCounterMode's count of 16(a)'s first step within 0.1%
# (the same registry on the same ops; the dry run's depth extrapolation is
# exact).  (c) The train_4k sweep of the ten archs on the 16x16 plan, in a
# subprocess, each combination OK.
DRYRUN_DSSFN = {"n": 4096, "q": 32, "tokens": 1048576, "iters": 100}
DRYRUN_FLOPS_REL = 0.01
DRYRUN_INIT_REL = 0.01
DRYRUN_PEAK_REL = 0.15
DRYRUN_STEP_FLOPS_REL = 1e-3
DRYRUN_SWEEP_TIMEOUT_S = 240


def readout_dryrun(torch, card: str) -> tuple[int, dict]:
    """17(a): both readout schedules' dry runs on the card; returns the
    gram launches and the results.  Every gram launch (the recorded solve
    and the timed one) is held against the float64 Gram of its input."""
    from repro_torch.core import admm
    from repro_torch.kernels import gram
    from repro_torch.launch import dryrun_dssfn
    from repro_torch.launch.mesh import make_production_mesh

    spec = DRYRUN_DSSFN
    n, q, k = spec["n"], spec["q"], spec["iters"]
    j = spec["tokens"] // make_production_mesh().size
    gram.reset_launch_count()
    out = {}
    with OpRecorder(admm, "gram") as gram_calls:
        for mode in dryrun_dssfn.MODES:
            out[mode] = dryrun_dssfn.dryrun_solver(mode, n=n, q=q, j_total=spec["tokens"],
                                                   iters=k, device="cuda")
    launches = gram.launch_count()
    with torch.no_grad():
        gram_ulps, plain_ulps = held_gram_calls(torch, gram_calls.calls)
    shapes = sorted({tuple(y.shape) for (y,), _, _ in gram_calls.calls})
    print(f"17(a) every gram launch of (a) on the same input against the float64 Gram: worst "
          f"{gram_ulps:.2f} f32 ulps of max|G| (bar {GRAM_F64_ULPS}; the f32 plain version "
          f"{plain_ulps:.2f}) over {len(gram_calls.calls)} calls at y{shapes}", flush=True)
    if not (gram_ulps <= GRAM_F64_ULPS and len(gram_calls.calls) == launches
            and shapes == [(1, n, j)]):
        raise AssertionError(f"17(a) gram vs float64 {gram_ulps:.2f} ulps (bar "
                             f"{GRAM_F64_ULPS}), {len(gram_calls.calls)} calls held of "
                             f"{launches} launches at {shapes}")
    del gram_calls
    for mode, res in out.items():
        if mode == "admm":
            products = 2 * (n + q) * n * j + k * 2 * q * n * j
            want = ({"all-reduce": k + 1}, {"all-reduce": k * q * n * 4 + k * 4})
        else:
            products = 2 * (n + q) * n * j
            want = ({"all-reduce": 1}, {"all-reduce": (n + q) * n * 4})
        got = (res["collective_counts"], res["collective_bytes"])
        if got != want:
            raise AssertionError(f"17(a) {mode}: collectives {got}, the schedule says {want}")
        if not res["z_finite"] or abs(res["flops_per_device"] - products) > \
                DRYRUN_FLOPS_REL * products:
            raise AssertionError(f"17(a) {mode}: {res['flops_per_device']:.6e} FLOPs against "
                                 f"the products' {products:.6e}, or z not finite")
        if mode == "admm" and res["kernel_launches"].get("gram") != {
                "calls": 1, "flops": 2 * n * n * j}:
            raise AssertionError(f"17(a): the gram launch was not credited with 2n^2J FLOPs: "
                                 f"{res['kernel_launches']}")
        r = res["roofline"]
        print(f"17(a) {mode}: n={n} Q={q} K={k} J={j} a device on the {res['mesh']} plan: "
              f"{res['flops_per_device']:.6e} FLOPs (products {products:.6e}), "
              f"{res['hbm_bytes_per_device']:.6e} B written, collectives {got[0]} of "
              f"{got[1]['all-reduce']} B, wire {res['collective_wire_bytes']:.6e} B; roofline "
              f"compute {r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} ms, "
              f"collective {r['collective_s'] * 1e3:.3f} ms ({r['dominant']}); the solve "
              f"measured {res['solve_wall_s'] * 1e3:.3f} ms on {card}", flush=True)
    print("17(a) ADMM issues K all-reduces of (Q, n) and ONE of (K,) for the objective "
          "trace; repro issues K scalar psums", flush=True)
    return launches, out


def one_card_plan(torch, danube: dict, card: str) -> dict:
    """17(b): the 1x1 plan of 16(a)'s step against what 16(a) measured."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshPlan

    spec = ZOO_TRAIN
    res = dryrun.dryrun_one(spec["arch"], "train_4k", plan=MeshPlan(("data", "model"), (1, 1)),
                            batch=spec["batch"], seq=spec["seq"])
    trees = res["memory"]["argument_bytes_by_tree"]
    state = trees["params"] + trees["opt_state"]
    peak, flops = res["memory"]["peak_bytes_per_device"], res["cost"]["flops_per_device"]
    checks = (("params + moments + step", state, danube["init_bytes"], DRYRUN_INIT_REL),
              ("peak", peak, danube["peak_bytes"], DRYRUN_PEAK_REL),
              ("step FLOPs", flops, danube["step_flops"], DRYRUN_STEP_FLOPS_REL))
    for what, got, want, rel in checks:
        if abs(got - want) > rel * want:
            raise AssertionError(f"17(b) {what}: the plan's {got} against the card's {want}, "
                                 f"beyond {rel}")
    r = res["roofline"]
    achieved = flops / (danube["steady_ms"] / 1e3)
    print(f"17(b) the 1x1 plan of 16(a) ({spec['arch']} whole, B={spec['batch']} "
          f"S={spec['seq']}), traced in {res['lower_compile_s']} s: params + moments + step "
          f"{state} B against the card's {danube['init_bytes']} B; peak {peak / 1e9:.2f} GB "
          f"against the card's {danube['peak_bytes'] / 1e9:.2f} GB; {flops:.6e} FLOPs "
          f"against FlopCounterMode's {danube['step_flops']:.6e}; achieved "
          f"{achieved / 1e12:.1f} TFLOP/s over 16(a)'s median step "
          f"{danube['steady_ms']:.1f} ms, where compute_s at the bf16 peak is "
          f"{r['compute_s'] * 1e3:.1f} ms (memory_s {r['memory_s'] * 1e3:.1f} ms) on {card}",
          flush=True)
    return {"plan": res, "init_bytes": danube["init_bytes"], "peak_bytes": danube["peak_bytes"],
            "step_flops": danube["step_flops"], "achieved_tflops": achieved / 1e12}


class DryrunSweep:
    """17(c): ``python -m repro_torch.launch.dryrun --shape train_4k`` over
    the ten archs on the 16x16 plan, in a subprocess started at once.  It
    needs no card (fake and ``meta`` tensors), so it runs on the host
    beside phase 16, and :meth:`result` waits for it; :meth:`close` stops
    it if it is still running and removes its output."""

    def __init__(self):
        self.tmp = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_")
        self.t0 = time.perf_counter()
        print("17(c) the sweep starts in a subprocess beside phase 16: phase 16's host-bound "
              "times (16(a) step ms and tokens/s, 16(d) fit s) and 17(c)'s traced-in times "
              "are taken under its load", flush=True)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        self.log = open(os.path.join(self.tmp, "sweep.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--shape", "train_4k",
             "--out", self.tmp], cwd=ROOT, env=env, stdout=self.log,
            stderr=subprocess.STDOUT, text=True)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def result(self, card: str) -> dict:
        from repro_torch.configs import ARCHS
        from repro_torch.launch.mesh import HARDWARE

        waited = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=DRYRUN_SWEEP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"17(c) the sweep ran over {DRYRUN_SWEEP_TIMEOUT_S} s")
        waited = time.perf_counter() - waited
        if rc != 0:
            self.log.seek(0)
            raise AssertionError(f"17(c) the sweep exited {rc}:\n{self.log.read()[-6000:]}")
        results = {}
        for arch in ARCHS:
            with open(os.path.join(self.tmp, f"{arch}_train_4k_16x16.json")) as f:
                results[arch] = json.load(f)
        rows = {}
        for arch, res in results.items():
            if res["status"] != "OK":
                raise AssertionError(f"17(c) {arch}: {res['status']}")
            r, peak = res["roofline"], res["memory"]["peak_bytes_per_device"]
            bounded = res["cost"]["upper_bounds"]
            rows[arch] = {"dominant": r["dominant"], "compute_s": r["compute_s"],
                          "memory_s": r["memory_s"], "collective_s": r["collective_s"],
                          "peak_gb": peak / 1e9, "trace_s": res["lower_compile_s"],
                          "useful_flops_ratio": r["useful_flops_ratio"],
                          "upper_bounds": bounded}
            most = "at most " if bounded else ""
            print(f"17(c) {arch} train_4k 16x16: {r['dominant']} (compute {most}"
                  f"{r['compute_s']:.4f} s, memory {most}{r['memory_s']:.4f} s, collective "
                  f"{r['collective_s']:.4f} s), peak {most}{peak / 1e9:.2f} GB a device against "
                  f"the card's {HARDWARE['hbm_bytes'] / 1e9:.0f} GB (activations whole under "
                  f"tensor parallelism), traced in {res['lower_compile_s']} s", flush=True)
        wall = time.perf_counter() - self.t0
        print(f"17(c) the sweep ended {wall:.1f} s after it started beside phase 16 "
              f"({waited:.1f} s waited for here) on {card}'s host", flush=True)
        return {"archs": rows, "wall_s": wall, "waited_s": waited}


def dryrun_slice(torch, card: str, danube: dict, sweep: DryrunSweep) -> tuple[int, dict]:
    """Phase 17: (a)-(c), (c) the ``sweep`` started before phase 16.
    Returns (a)'s gram launches and a summary."""
    t0 = time.perf_counter()
    launches, readout = readout_dryrun(torch, card)
    summary = {"card": card, "readout": readout, "one_card": one_card_plan(torch, danube, card),
               "sweep": sweep.result(card)}
    summary["phase_s"] = time.perf_counter() - t0
    print(f"17 done in {summary['phase_s']:.1f} s", flush=True)
    print(json.dumps({"dryrun": summary}), flush=True)
    return launches, summary



# Phase 18: the model zoo sharded over a (data=2, model=2) grid of 4 gloo
# ranks sharing the card (launch/mesh.make_host_mesh, sharding/parallel.py).
# (a) Phi-3.5-MoE at full width, 1 layer, f32, the scoring forward with the
# kernels on (one flash_attention launch a rank over its 16 of 32 heads and
# 4 of 8 KV heads), B=2, S=2048.
SHARDED = {"ranks": 4, "model_parallel": 2, "backend": "gloo", "seed": 0}
SHARDED_MOE = {"arch": "phi35_moe_42b", "layers": 1, "batch": 2, "seq": 2048}
# The gathered logits against the same layer unsharded on the card: each
# rank's products and the all-reduces over the model row add the same f32
# terms in another order, an error of order sqrt(K) 2**-24 of a sum
# (16(b)'s f32 bar); positions whose top-2 routing differs between the
# runs (a near-tie moved by that rounding) are counted and left out.
SHARDED_LOGIT_TOL = 1e-5
# (b) H2O-Danube3-4B at full width, 1 layer, f32, one make_train_step
# sharded and unsharded on the same card and batch: 16(b)'s card-vs-CPU
# bars (GRAD_TOL) for loss, grad_norm and each gathered gradient leaf.
SHARDED_GRAD = {"arch": "h2o_danube3_4b", "layers": 1, "batch": 2, "seq": 4096, "lr": 3e-4}
# After the first AdamW step each element has moved by lr * g / (|g| +
# eps), about +-lr.  Where |g| > SHARDED_HELD_G = 1e3 eps, a gradient gap
# dg moves the update by lr eps dg / g**2 at most, far below a thousandth
# of lr, so at most SHARDED_HELD_FRAC of those elements may part by more
# than SHARDED_PARAM_NEAR x lr beyond one f32 rounding.  A gradient near 0
# whose sign the sums' order flips moves the other way, so any element may
# part by up to 2 lr, and at most SHARDED_PARAM_FRAC of all the elements by
# more than SHARDED_PARAM_NEAR x lr.  A step not applied, or applied with
# the wrong sign, parts nearly every held element by about lr.
SHARDED_PARAM_ULP = 2.0**-23
SHARDED_PARAM_NEAR, SHARDED_HELD_G = 1e-3, 1e-5
SHARDED_HELD_FRAC, SHARDED_PARAM_FRAC = 1e-6, 1e-3
# (c) Danube at full width, 2 layers, bf16 params with f32 moments (16(a)'s
# setup), AdamW(3e-4), B=2, S=4096, through launch/train.py's grid.
SHARDED_TRAIN = {"arch": "h2o_danube3_4b", "layers": 2, "batch": 2, "seq": 4096, "steps": 3,
                 "lr": 3e-4}
# (e) launch/serve.py on Danube, 2 layers, bf16, sharded and unsharded
# (FSDP re-gathers every weight each decode step, as GSPMD would under
# repro's serving rules, so decode is short).  Each rank rounds its
# row-parallel partial sum to bf16 before the f32 sum over the row, which
# is rounded to bf16 again: an activation may part from the unsharded
# one's by about one bf16 ulp (2**-8) a layer, and the head's 3840-term
# sums carry that into the logits.  Bar: 4 ulps, 2**-6 x max|logits|.
SHARDED_SERVE = {"arch": "h2o_danube3_4b", "layers": 2, "batch": 2, "prompt": 2048, "gen": 8}
SHARDED_SERVE_TOL = 2.0**-6
# Each rank keeps its row-parallel partial in f32 through the sum and
# rounds once; rounding each partial to bf16 before the sum put (e)'s
# prefill logits at this gap x max (on an H100 80GB HBM3 at 700 W).
SHARDED_SERVE_DOUBLE_ROUNDED = 1.11e-2
# (f) Zamba2-2.7B and (g) xLSTM-350M at full width, one period each (6
# Mamba2 layers and the shared block; 5 mLSTM and 1 sLSTM), f32, the
# scoring forward with the kernels on (each rank's ssm_scan over 16 of 32
# heads of 160, flash_attention over 16 of 32 heads of 80, mlstm_scan
# over 2 of 4 heads of 256), each call held against its plain version.
# The gathered logits against the same model unsharded on the card: 1e-4
# x max, or 10 times the unsharded forward's response to one f32 ulp up on
# every embedding output where that is larger (these models amplify
# rounding).
SHARDED_RECURRENT = {
    "hybrid": {"arch": "zamba2_2_7b", "layers": 6, "batch": 2, "seq": 2048,
               "kernels": ("ssm_scan", "flash_attention")},
    "xlstm": {"arch": "xlstm_350m", "layers": 6, "batch": 2, "seq": 1024,
              "kernels": ("mlstm_scan",)},
}
SHARDED_RECURRENT_TOL, SHARDED_ULP_RESPONSES = 1e-4, 10
# Rounding noise: every embedding output moved one ulp up or down at
# random, a quarter of them each way, under SHARDED_NOISE_SEEDS seeds.
SHARDED_NOISE_SEEDS = 3
# (h) one make_train_step of each at that depth, f32, B=2, S=1024, against
# the unsharded step: (b)'s bars, or SHARDED_STEP_NOISE times the largest
# move of the unsharded step under that noise where larger.  On one card
# the noise alone moves the hybrid's worst gradient leaf by up to 2.5e-4 x
# max, and the same step split into two B=1 halves by 2.5e-4, past (b)'s
# 1e-4 (chip_probe_grid.py layers, on an H100 80GB HBM3 at 700 W); the
# planted faults of chip_probe_grid.py faults exceed these bars 3.2x and
# more.
SHARDED_STEP_NOISE = 4
# (i) launch/serve.py on both at that depth, bf16, prompt 512 + 8, against
# the unsharded launcher.  Every layer of the sharded prefill (each Mamba2,
# mLSTM and sLSTM layer, the shared block's attention and FFN, the head)
# within (e)'s 2**-6 x max of the unsharded layer on the sharded input to
# it (models/layer_tap.py), before the layers after it amplify its
# rounding; the prefill logits within the smallest move the noise gives
# the unsharded prefill's, and no further from the same weights' f32
# prefill than the unsharded launcher's are, plus 2**-6 x max.  Their gap
# to the unsharded logits is printed beside 2**-6 x max too: a bf16 ulp
# on about a thousandth of a layer's outputs, amplified through 512
# recurrent steps and the layers after it, puts it past that bar
# (chip_probe_grid.py layers).
SHARDED_RECURRENT_STEP = {"batch": 2, "seq": 1024, "lr": 3e-4}
SHARDED_RECURRENT_SERVE = {"batch": 2, "prompt": 512, "gen": 8}


def _sharded_tokens(np, cfg, b: int, s: int, seed: int):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _spool(spool: str, rank: int, name: str, obj) -> str:
    """Write ``obj`` (a tensor or a tree of CPU tensors) into ``spool`` for
    the parent (a file moves GBs faster than the result queue's pipe)."""
    import torch

    path = os.path.join(spool, f"rank{rank}_{name}.pt")
    torch.save(obj, path)
    return path


def _unspool(torch, path: str):
    return torch.load(path, mmap=True, weights_only=True)


def _sharded_rank(group, spool, moe_spec, grad_spec, train_kw, serve_kw):
    """Phase 18's work on one rank, one spawn for all of it.  (a): the MoE
    layer's scoring forward twice (the first recording each
    flash_attention call and each routing, the second timed); (b): one
    train step; (c): ``launch/train.train_rank``; (e):
    ``launch/serve.serve_rank``.  Returns this rank's shards of the
    logits, gradients and updated params (host numpy), what its kernel
    counter and transports saw, and the launchers' reports."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import blocks, build_model
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding import rules as rules_lib

    stamps = [("start", time.perf_counter())]
    began = time.time()
    grid = mesh_lib.make_host_mesh(group, SHARDED["model_parallel"])
    out = {"rank": grid.rank, "coords": grid.coords, "grid": grid.describe()}
    cfg = zoo_config({"arch": moe_spec["arch"], "reduced": False},
                     num_layers=moe_spec["layers"], dtype="float32")
    model = build_model(cfg)
    params = rules_lib.init_shard(model, grid, SHARDED["seed"])
    bl = moe_spec["batch"] // grid.data_parallel
    rows = slice(grid.data_index * bl, (grid.data_index + 1) * bl)
    tokens = _sharded_tokens(np, cfg, moe_spec["batch"], moe_spec["seq"], SHARDED["seed"])
    batch = {"tokens": torch.as_tensor(tokens[rows], device=grid.device)}
    fa.reset_launch_count()
    with par.use_grid(grid), torch.no_grad():
        with RouteRecorder() as routes, OpRecorder(blocks, "flash_attention") as rec:
            logits, _ = model.forward(params, batch)
        torch.cuda.synchronize()
        grid.reset_stats()
        t0 = time.perf_counter()
        model.forward(params, batch)
        torch.cuda.synchronize()
        out["forward_ms"] = (time.perf_counter() - t0) * 1e3
        stats = grid.stats()
    out["launches"] = fa.launch_count()
    out["host_ms"], out["sync_ms"] = stats["host_s"] * 1e3, stats["sync_s"] * 1e3
    out["flash_held"] = held_flash_calls(rec.calls)
    out["flash_shape"] = tuple(rec.calls[0][0][0].shape), tuple(rec.calls[0][0][1].shape)
    out["logits"] = _spool(spool, grid.rank, "logits", logits.cpu())
    plan = routes.calls[0][0]
    out["ids"], out["keep"] = plan.ids.cpu().numpy(), plan.keep.cpu().numpy()
    del params, logits, rec, routes
    free(torch)
    stamps.append(("(a)", time.perf_counter()))

    cfg = dataclasses.replace(zoo_config({"arch": grad_spec["arch"], "reduced": False},
                                         num_layers=grad_spec["layers"], dtype="float32"),
                              use_pallas_kernels=False)
    model = build_model(cfg)
    params = rules_lib.init_shard(model, grid, SHARDED["seed"])
    bl = grad_spec["batch"] // grid.data_parallel
    rows = slice(grid.data_index * bl, (grid.data_index + 1) * bl)
    from repro_torch.data import TokenStream

    whole = next(iter(TokenStream(cfg.vocab_size, grad_spec["seq"], grad_spec["batch"],
                                  seed=0)))
    batch = {k: torch.as_tensor(v[rows], device=grid.device) for k, v in whole.items()}
    opt = GradCapture(AdamW(lr=grad_spec["lr"]))
    with par.use_grid(grid):
        grid.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _, metrics = make_train_step(model, opt)(params, opt.init(params), batch)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["loss"], out["grad_norm"] = float(metrics["loss"]), float(metrics["grad_norm"])
    out["grads"] = _spool(spool, grid.rank, "grads", _tree.map_(lambda t: t.cpu(), opt.grads))
    out["params"] = _spool(spool, grid.rank, "params",
                           _tree.map_(lambda t: t.detach().cpu(), params))
    del params, opt, metrics, batch
    free(torch)
    stamps.append(("(b)", time.perf_counter()))
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import train as train_lib

    out["train"] = train_lib.train_rank(group, train_kw.pop("arch"), SHARDED["model_parallel"],
                                        False, train_kw)
    free(torch)
    stamps.append(("(c)", time.perf_counter()))
    out["serve"] = serve_lib.serve_rank(group, serve_kw.pop("arch"), SHARDED["model_parallel"],
                                        serve_kw)
    stamps.append(("(e)", time.perf_counter()))
    free(torch)
    for key in SHARDED_RECURRENT:
        out[key] = _recurrent_rank(torch, np, group, grid, spool, key)
        free(torch)
        stamps.append((f"{key} (f)-(i)", time.perf_counter()))
    out["seconds"] = {k: round(t - t0, 1) for (_, t0), (k, t) in zip(stamps, stamps[1:])}
    out["wall"] = (began, time.time())
    return out


def _recurrent_held(torch, name: str, calls) -> float:
    """The largest excess over its allowance (<= 0 passes) of the recorded
    f32 calls of ``name``, each against the plain scan on its own input
    (phases 9-10's per-element bars; ``flash_attention``: the fraction of
    ``held_flash_calls``' bar less one)."""
    if name == "flash_attention":
        return held_flash_calls(calls) - 1.0
    worst = -float("inf")
    for args, kw, got in calls:
        if name == "ssm_scan":
            from repro_torch.kernels.ssm_scan import ssm_scan_ref

            ex = ssm_excess(torch, got, ssm_scan_ref(*args, **kw), args, kw["chunk"], "float32")
            worst = max(worst, ex["excess_y"], ex["excess_h"])
        else:
            from repro_torch.kernels.mlstm_scan import mlstm_scan_ref

            ex = mlstm_excess(torch, got, mlstm_scan_ref(*args, **kw), args, kw["chunk"],
                              "float32")
            worst = max(worst, ex["excess_y"], ex["excess_state"])
    return worst


def _recurrent_rank(torch, np, group, grid, spool, key: str) -> dict:
    """(f)/(g), (h) and (i) of one model on this rank: the scoring forward
    twice with the kernels on (the first recording each kernel call, the
    second timed), one train step, ``launch/serve.serve_rank``."""
    import contextlib

    from repro_torch import _tree
    from repro_torch.data import TokenStream
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import blocks, build_model
    from repro_torch.models.layer_tap import LayerTap
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.sharding import parallel as par
    from repro_torch.sharding import rules as rules_lib

    spec, seed, out = SHARDED_RECURRENT[key], SHARDED["seed"], {}
    counters = kernel_counters()
    cfg = zoo_config({"arch": spec["arch"], "reduced": False}, num_layers=spec["layers"],
                     dtype="float32")
    model = build_model(cfg)
    params = rules_lib.init_shard(model, grid, seed)
    bl = spec["batch"] // grid.data_parallel
    rows = slice(grid.data_index * bl, (grid.data_index + 1) * bl)
    tokens = _sharded_tokens(np, cfg, spec["batch"], spec["seq"], seed)
    batch = {"tokens": torch.as_tensor(tokens[rows], device=grid.device)}
    for name in spec["kernels"]:
        counters[name].reset_launch_count()
    with par.use_grid(grid), torch.no_grad():
        with contextlib.ExitStack() as stack:
            recs = {name: stack.enter_context(OpRecorder(blocks, name))
                    for name in spec["kernels"]}
            logits, _ = model.forward(params, batch)
        torch.cuda.synchronize()
        grid.reset_stats()
        t0 = time.perf_counter()
        model.forward(params, batch)
        torch.cuda.synchronize()
        out["forward_ms"] = (time.perf_counter() - t0) * 1e3
        stats = grid.stats()
    out["launches"] = {name: counters[name].launch_count() for name in spec["kernels"]}
    out["host_ms"], out["sync_ms"] = stats["host_s"] * 1e3, stats["sync_s"] * 1e3
    out["held"] = {name: _recurrent_held(torch, name, rec.calls) for name, rec in recs.items()}
    out["shapes"] = {name: [tuple(a.shape) for a in rec.calls[0][0][:2]]
                     for name, rec in recs.items()}
    out["logits"] = _spool(spool, grid.rank, f"{key}_logits", logits.cpu())
    del params, logits, recs, batch
    free(torch)

    step = SHARDED_RECURRENT_STEP
    cfg = dataclasses.replace(cfg, use_pallas_kernels=False)
    model = build_model(cfg)
    params = rules_lib.init_shard(model, grid, seed)
    bl = step["batch"] // grid.data_parallel
    rows = slice(grid.data_index * bl, (grid.data_index + 1) * bl)
    whole = next(iter(TokenStream(cfg.vocab_size, step["seq"], step["batch"], seed=0)))
    batch = {k: torch.as_tensor(v[rows], device=grid.device) for k, v in whole.items()}
    opt = GradCapture(AdamW(lr=step["lr"]))
    with par.use_grid(grid):
        grid.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _, metrics = make_train_step(model, opt)(params, opt.init(params), batch)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        out["step_stats"] = grid.stats()
    out["loss"], out["grad_norm"] = float(metrics["loss"]), float(metrics["grad_norm"])
    out["grads"] = _spool(spool, grid.rank, f"{key}_grads",
                          _tree.map_(lambda t: t.cpu(), opt.grads))
    del params, opt, metrics, batch
    free(torch)

    serve = SHARDED_RECURRENT_SERVE
    with LayerTap() as tap:
        out["serve"] = serve_lib.serve_rank(
            group, spec["arch"], SHARDED["model_parallel"],
            {"batch": serve["batch"], "prompt_len": serve["prompt"], "gen_len": serve["gen"],
             "reduced": False, "seed": seed, "params": None, "layers": spec["layers"]})
    out["serve_calls"] = _spool(spool, grid.rank, f"{key}_serve_calls", tap.calls)
    out["coords"] = grid.coords
    return out


def _noisy_embed(torch, embed, seed: int):
    """``embed`` with every output moved one ulp of its dtype up or down
    at random, a quarter of them each way (the gradient passes)."""
    def call(*args):
        e = embed(*args)
        gen = torch.Generator(device=e.device).manual_seed(seed)
        r = torch.randint(0, 4, e.shape, generator=gen, device=e.device)
        up = torch.nextafter(e, e.new_full((), float("inf")))
        down = torch.nextafter(e, e.new_full((), -float("inf")))
        return e + (torch.where(r == 0, up, torch.where(r == 1, down, e)) - e).detach()

    return call


def _serve_model(torch, key: str, dtype: str | None = None):
    """(i)'s model as ``launch/serve.py`` builds it unsharded (bf16, or
    ``dtype``), its seeded params on the card and the seeded prompt."""
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch.train import _config
    from repro_torch.models import build_model

    spec, serve = SHARDED_RECURRENT[key], SHARDED_RECURRENT_SERVE
    cfg = _config(spec["arch"], False, spec["layers"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SHARDED["seed"]))
    if dtype is not None:
        from repro_torch import _tree

        model = build_model(dataclasses.replace(cfg, dtype=dtype))
        params = _tree.map_(lambda t: t.to(getattr(torch, dtype)), params)
    prompt = serve_lib._prompt(cfg, serve["batch"], serve["prompt"], SHARDED["seed"])
    return model, params, {"tokens": torch.as_tensor(prompt["tokens"], device="cuda")}


def _prefill_logits(torch, model, params, prompt):
    """The prompt's last-position logits (host f32), as the launcher's
    prefill gives them."""
    serve = SHARDED_RECURRENT_SERVE
    with torch.no_grad():
        logits, _ = model.prefill(params, prompt, max_len=serve["prompt"] + serve["gen"])
    return logits[:, -1].float().cpu()


def sharded_recurrent_reference(torch, np, key: str) -> dict:
    """(f)/(g), (h) and (i) of one model unsharded on the card: the
    forward's logits and its response to one f32 ulp up on every embedding
    output; one train step's loss, grad_norm and gradient (host), and the
    step's largest move under rounding noise on the embedding outputs; the
    serving launcher's result, the smallest move of its prefill logits
    under that noise, and the same weights' prefill logits in f32."""
    from repro_torch import _tree
    from repro_torch.data import TokenStream
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import build_model, hybrid_model, xlstm_model
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamW

    spec, seed = SHARDED_RECURRENT[key], SHARDED["seed"]
    cfg = zoo_config({"arch": spec["arch"], "reduced": False}, num_layers=spec["layers"],
                     dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    tokens = _sharded_tokens(np, cfg, spec["batch"], spec["seq"], seed)
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    module = hybrid_model if key == "hybrid" else xlstm_model
    embed = module.embed_tokens

    def embed_up(*a):
        """The embedding outputs one ulp of their dtype up (the gradient
        passes)."""
        e = embed(*a)
        return e + (torch.nextafter(e, e.new_full((), float("inf"))) - e).detach()

    with torch.no_grad():
        want, _ = model.forward(params, batch)
        module.embed_tokens = embed_up
        try:
            moved, _ = model.forward(params, batch)
        finally:
            module.embed_tokens = embed
    out = {"cfg": cfg, "logits": want.cpu().numpy(),
           "ulp_response": (moved - want).abs().max().item()}
    del params, want, moved, batch
    free(torch)

    step = SHARDED_RECURRENT_STEP
    cfg = dataclasses.replace(cfg, use_pallas_kernels=False)
    model = build_model(cfg)
    whole = next(iter(TokenStream(cfg.vocab_size, step["seq"], step["batch"], seed=0)))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in whole.items()}
    response = {"loss": 0.0, "grad_norm": 0.0, "leaf": 0.0}
    for noise in (None,) + tuple(range(SHARDED_NOISE_SEEDS)):
        # After the plain step, the same step under rounding noise on the
        # embedding outputs: how far it alone moves the loss, grad_norm and
        # gradient.
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        opt = GradCapture(AdamW(lr=step["lr"]))
        if noise is not None:
            module.embed_tokens = _noisy_embed(torch, embed, noise)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, _, metrics = make_train_step(model, opt)(params, opt.init(params), batch)
            torch.cuda.synchronize()
        finally:
            module.embed_tokens = embed
        if noise is None:
            out.update(step_cfg=cfg, step_ms=(time.perf_counter() - t0) * 1e3,
                       loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                       grads=_tree.map_(lambda t: t.cpu(), opt.grads))
        else:
            moved = {
                "loss": abs(float(metrics["loss"]) - out["loss"]) / abs(out["loss"]),
                "grad_norm": abs(float(metrics["grad_norm"]) - out["grad_norm"]) / out["grad_norm"],
                "leaf": max(float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30))
                            for g, w in zip(_tree.leaves(opt.grads), _tree.leaves(out["grads"])))}
            response = {k: max(v, moved[k]) for k, v in response.items()}
        del params, opt, metrics
        free(torch)
    out["step_noise_response"] = response
    del batch
    serve = SHARDED_RECURRENT_SERVE
    out["serve"] = serve_lib.serve(spec["arch"], device="cuda", batch=serve["batch"],
                                   prompt_len=serve["prompt"], gen_len=serve["gen"],
                                   reduced=False, seed=seed, layers=spec["layers"])
    free(torch)
    # The prefill under rounding noise on its bf16 embedding outputs, and
    # the same weights' prefill in f32.
    model, params, prompt = _serve_model(torch, key)
    want = torch.from_numpy(out["serve"]["prefill_logits"])
    moves = []
    for noise in range(SHARDED_NOISE_SEEDS):
        module.embed_tokens = _noisy_embed(torch, embed, noise)
        try:
            moves.append(float((_prefill_logits(torch, model, params, prompt) - want).abs().max()))
        finally:
            module.embed_tokens = embed
    out["serve_noise_response"] = min(moves)
    del params
    free(torch)
    model, params, prompt = _serve_model(torch, key, "float32")
    out["serve_f32"] = _prefill_logits(torch, model, params, prompt)
    del params
    free(torch)
    return out


def sharded_serve_layers(torch, key: str, ranks: list) -> dict:
    """(i)'s layers: every tapped call of the ranks' sharded prefill
    (``models/layer_tap.py``), gathered, against the unsharded layer on
    the same input (a replay of the unsharded prefill), each as max abs
    err / max|unsharded output|; also each input's gap to the unsharded
    run's own input to that layer (how the rounding grows)."""
    from repro_torch.models.layer_tap import LayerTap, gather_calls

    calls, rows_agree = gather_calls([(r[key]["coords"], _unspool(torch, r[key]["serve_calls"]))
                                      for r in ranks])
    model, params, prompt = _serve_model(torch, key)
    with LayerTap() as own:
        _prefill_logits(torch, model, params, prompt)
    with LayerTap(replay=calls) as one:
        _prefill_logits(torch, model, params, prompt)
    del params
    free(torch)
    if [c[0] for c in calls] != [c[0] for c in one.calls]:
        raise AssertionError(f"18(i) the sharded prefill's layers {[c[0] for c in calls]} are "
                             f"not the unsharded one's {[c[0] for c in one.calls]}")

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    gaps = [(name, rel(got, want)) for (name, _, got), (_, _, want) in zip(calls, one.calls)]
    name, worst = max(gaps, key=lambda g: g[1])
    return {"gaps": gaps, "worst": worst, "name": name, "rows_agree": rows_agree,
            "inputs": [rel(x, w) for (_, x, _), (_, w, _) in zip(calls, own.calls)]}


def sharded_recurrent_check(torch, np, card: str, ranks: list, ref: dict, key: str) -> dict:
    """(f)/(g), (h) and (i) of one model: the gathered logits against the
    unsharded forward, each rank's kernel calls against their plain
    versions; the train step against the unsharded one and its transports
    against ``executor_collectives``; the served prefill logits and tokens
    against the unsharded launcher's."""
    from repro_torch import _tree
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshPlan
    from repro_torch.sharding import rules as rules_lib

    spec, cfg = SHARDED_RECURRENT[key], ref["cfg"]
    part = "(f)" if key == "hybrid" else "(g)"
    plan = MeshPlan(("data", "model"), (SHARDED["ranks"] // SHARDED["model_parallel"],
                                        SHARDED["model_parallel"]))
    got = rules_lib.unshard_params(
        [{"x": _unspool(torch, r[key]["logits"]).numpy()} for r in ranks],
        {"x": ("data", None, "model")}, plan)["x"]
    want = ref["logits"]
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    bar = max(SHARDED_RECURRENT_TOL * scale, SHARDED_ULP_RESPONSES * ref["ulp_response"])
    held = {n: max(r[key]["held"][n] for r in ranks) for n in spec["kernels"]}
    launches = {n: sum(r[key]["launches"][n] for r in ranks) for n in spec["kernels"]}
    for r in ranks:
        x = r[key]
        print(f"18{part} rank {r['rank']} {r['coords']}: forward {x['forward_ms']:.1f} ms, "
              f"transport host {x['host_ms']:.1f} ms of which {x['sync_ms']:.1f} ms waiting for "
              f"the card; kernel calls (first two inputs' shapes) {x['shapes']}, launches "
              f"{x['launches']}, worst excess over the per-element allowance {x['held']} "
              f"(<= 0 passes)", flush=True)
    print(f"18{part} {cfg.name} {cfg.num_layers} layers f32, B={spec['batch']} S={spec['seq']} on "
          f"{ranks[0]['grid']}: gathered logits vs unsharded max abs err {err:.3e} (max|logits| "
          f"{scale:.3e}; bar {bar:.3e} = max({SHARDED_RECURRENT_TOL} x max, "
          f"{SHARDED_ULP_RESPONSES} x the unsharded forward's one-ulp response "
          f"{ref['ulp_response']:.3e})), on {card}", flush=True)
    calls = spec["layers"] if key == "hybrid" else spec["layers"] - 1
    want_launches = {n: 2 * SHARDED["ranks"] * (1 if n == "flash_attention" else calls)
                     for n in spec["kernels"]}
    if not (err <= bar and all(v <= 0.0 for v in held.values()) and launches == want_launches):
        raise AssertionError(f"18{part} sharded {key} forward: logits {err:.3e} > {bar:.3e}, "
                             f"kernel calls {held} over their bars, or launches {launches} "
                             f"(want {want_launches})")

    step, scfg = SHARDED_RECURRENT_STEP, ref["step_cfg"]
    specs = rules_lib.param_specs(scfg, rules_lib.AxisRules(mesh=plan, data_axes=("data",),
                                                            model_axis="model"), plan)
    got_g = rules_lib.unshard_params([_unspool(torch, r[key]["grads"]) for r in ranks],
                                     specs, plan)
    worst, worst_name = 0.0, None
    for name, g, w in zip(_tree.leaves(_paths(ref["grads"])), _tree.leaves(got_g),
                          _tree.leaves(ref["grads"])):
        gap = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        if gap > worst:
            worst, worst_name = gap, name
    r0 = ranks[0][key]
    loss_gap = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
    norm_gap = abs(r0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    response = ref["step_noise_response"]
    bars = {k: max(v, SHARDED_STEP_NOISE * response[k]) for k, v in GRAD_TOL.items()}
    wanted = dryrun.executor_collectives(scfg, plan, step["batch"], step["seq"])
    bad = []
    for r in ranks:
        st = r[key]["step_stats"]
        seen = {k: {"count": st["counts"][k], "bytes": st["bytes"][k]} for k in st["counts"]}
        if seen != wanted:
            bad.append((r["rank"], seen))
    sums = {dt for r in ranks for (kind, dt) in r[key]["step_stats"]["dtypes"]
            if kind != "all-gather"}
    print(f"18(h) {cfg.name} {scfg.num_layers} layers f32 (remat {scfg.remat}), "
          f"B={step['batch']} S={step['seq']}: loss sharded {r0['loss']:.7f} unsharded "
          f"{ref['loss']:.7f} (rel {loss_gap:.2e}), grad_norm {r0['grad_norm']:.6f} vs "
          f"{ref['grad_norm']:.6f} (rel {norm_gap:.2e}); worst gradient leaf {worst_name} "
          f"{worst:.3e} x max|g|; bars {bars} (18(b)'s, or {SHARDED_STEP_NOISE} x the largest "
          f"move of the unsharded step under random one-ulp noise on the embedding outputs over "
          f"{SHARDED_NOISE_SEEDS} seeds, {response}, where larger); step {max(r[key]['step_ms'] for r in ranks):.0f} ms a rank "
          f"sharded, {ref['step_ms']:.0f} ms unsharded; transport per rank "
          f"{json.dumps(wanted)} (executor_collectives, every rank equal: {not bad}), host "
          f"{r0['step_stats']['host_s'] * 1e3:.0f} ms of which "
          f"{r0['step_stats']['sync_s'] * 1e3:.0f} ms waiting for the card, on {card}",
          flush=True)
    if not (loss_gap <= bars["loss"] and norm_gap <= bars["grad_norm"]
            and worst <= bars["leaf"] and not bad and sums == {"float32"}):
        raise AssertionError(f"18(h) sharded vs unsharded {key} step: loss {loss_gap:.2e}, "
                             f"grad_norm {norm_gap:.2e}, leaf {worst_name} {worst:.2e} (bars "
                             f"{bars}), sums in {sums}, transports off the planner's "
                             f"{bad[:2]} (want {wanted})")

    serve, grid_s, one = SHARDED_RECURRENT_SERVE, ranks[0][key]["serve"], ref["serve"]
    layers = sharded_serve_layers(torch, key, ranks)
    got_s = torch.from_numpy(grid_s["prefill_logits"])
    want_s = torch.from_numpy(one["prefill_logits"])
    s_err, s_scale = max_err(got_s, want_s)
    f32 = ref["serve_f32"]
    to_f32 = {"sharded": max_err(got_s, f32)[0], "unsharded": max_err(want_s, f32)[0]}
    f32_bar = to_f32["unsharded"] + SHARDED_SERVE_TOL * s_scale
    agree = float((grid_s["tokens"] == one["tokens"]).mean())
    print(f"18(i) {spec['arch']} {spec['layers']} layers bf16 serve B={serve['batch']} prompt "
          f"{serve['prompt']} gen {serve['gen']}: every layer of the sharded prefill vs the "
          f"unsharded layer on its input, worst {layers['worst']:.3e} x max ({layers['name']}; "
          f"bar {SHARDED_SERVE_TOL}; model rows equal {layers['rows_agree']}); prefill logits "
          f"sharded vs unsharded max abs err {s_err:.3e} (max {s_scale:.3e}, "
          f"{s_err / s_scale:.3e} x max, beside 2**-6 = {SHARDED_SERVE_TOL}; bar "
          f"{ref['serve_noise_response'] / s_scale:.3e} x max, the smallest move of the unsharded "
          f"prefill's under random one-ulp noise on the embedding outputs over "
          f"{SHARDED_NOISE_SEEDS} seeds); vs the same weights' f32 prefill: sharded "
          f"{to_f32['sharded'] / s_scale:.3e}, unsharded {to_f32['unsharded'] / s_scale:.3e} x "
          f"max (bar {f32_bar / s_scale:.3e}); greedy tokens agree {agree:.3f}; "
          f"prefill {grid_s['prefill_s']:.3f} s sharded, {one['prefill_s']:.3f} s unsharded; "
          f"decode {grid_s['decode_tokens_per_s']:.1f} tok/s sharded, "
          f"{one['decode_tokens_per_s']:.1f} tok/s unsharded, on {card}", flush=True)
    for i, (name, gap) in enumerate(layers["gaps"]):
        print(f"18(i) {key} prefill call {i} {name}: input vs the unsharded run's "
              f"{layers['inputs'][i]:.3e} x max, output vs the unsharded layer on that input "
              f"{gap:.3e} x max", flush=True)
    if not (layers["worst"] <= SHARDED_SERVE_TOL and layers["rows_agree"]
            and s_err <= ref["serve_noise_response"] and to_f32["sharded"] <= f32_bar):
        raise AssertionError(f"18(i) sharded {key} prefill: worst layer {layers['name']} "
                             f"{layers['worst']:.3e} x max (bar {SHARDED_SERVE_TOL}), model rows "
                             f"equal {layers['rows_agree']}, logits {s_err:.3e} (bar "
                             f"{ref['serve_noise_response']:.3e}), to f32 {to_f32['sharded']:.3e} "
                             f"(bar {f32_bar:.3e})")
    return {"logits_err": err / scale, "bar": bar / scale,
            "ulp_response": ref["ulp_response"] / scale, "held": held, "launches": launches,
            "forward_ms": [r[key]["forward_ms"] for r in ranks],
            "host_ms": [r[key]["host_ms"] for r in ranks],
            "sync_ms": [r[key]["sync_ms"] for r in ranks],
            "step": {"loss_rel": loss_gap, "grad_norm_rel": norm_gap, "worst_leaf": worst_name,
                     "worst_leaf_rel": worst, "noise_response": response, "bars": bars,
                     "step_ms": [r[key]["step_ms"] for r in ranks],
                     "unsharded_step_ms": ref["step_ms"], "transport": wanted},
            "serve": {"prefill_err": s_err / s_scale, "layer_worst": layers["worst"],
                      "layer_worst_name": layers["name"],
                      "noise_response": ref["serve_noise_response"] / s_scale,
                      "to_f32": {k: v / s_scale for k, v in to_f32.items()},
                      "tokens_agree": agree,
                      "prefill_s": grid_s["prefill_s"], "unsharded_prefill_s": one["prefill_s"],
                      "decode_tokens_per_s": grid_s["decode_tokens_per_s"],
                      "unsharded_decode_tokens_per_s": one["decode_tokens_per_s"]}}


def sharded_moe_reference(torch, np) -> dict:
    """18(a)'s layer unsharded on the card: its logits and routing (host)."""
    from repro_torch.models import build_model

    spec = SHARDED_MOE
    cfg = zoo_config({"arch": spec["arch"], "reduced": False}, num_layers=spec["layers"],
                     dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SHARDED["seed"]))
    tokens = _sharded_tokens(np, cfg, spec["batch"], spec["seq"], SHARDED["seed"])
    with torch.no_grad(), RouteRecorder() as routes:
        want, _ = model.forward(params, {"tokens": torch.as_tensor(tokens, device="cuda")})
    plan = routes.calls[0][0]
    out = {"cfg": cfg, "logits": want.cpu().numpy(), "ids": plan.ids.cpu().numpy(),
           "keep": plan.keep.cpu().numpy()}
    del params, routes, plan, want
    free(torch)
    return out


def sharded_moe_check(torch, np, card: str, ranks: list, ref: dict) -> dict:
    """18(a): the ranks' gathered logits against the unsharded layer, the
    positions whose routing flipped left out; each rank's flash_attention
    call against its plain version; the forward's ms a rank, the
    transport's host ms and of those the wait for the card."""
    from repro_torch.launch.mesh import MeshPlan
    from repro_torch.sharding.rules import unshard_params

    spec, cfg = SHARDED_MOE, ref["cfg"]
    want, want_ids, want_keep = ref["logits"], ref["ids"], ref["keep"]
    grid = MeshPlan(("data", "model"), (SHARDED["ranks"] // SHARDED["model_parallel"],
                                        SHARDED["model_parallel"]))
    spec_logits = {"x": ("data", None, "model")}
    got = unshard_params([{"x": _unspool(torch, r["logits"]).numpy()} for r in ranks],
                         spec_logits, grid)["x"]
    ids = unshard_params([{"x": r["ids"]} for r in ranks], {"x": ("data", None)}, grid)["x"]
    keep = unshard_params([{"x": r["keep"]} for r in ranks], {"x": ("data", None)}, grid)["x"]
    b, s = spec["batch"], spec["seq"]
    k = ids.shape[1] // s
    flipped = ((ids != want_ids) | (keep != want_keep)).reshape(b, s, k).any(-1)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want)[~flipped].max())
    held = max(r["flash_held"] for r in ranks)
    launches = sum(r["launches"] for r in ranks)
    for r in ranks:
        print(f"18(a) rank {r['rank']} {r['coords']}: forward {r['forward_ms']:.1f} ms, "
              f"transport host {r['host_ms']:.1f} ms of which {r['sync_ms']:.1f} ms waiting "
              f"for the card; flash_attention q {r['flash_shape'][0]} k {r['flash_shape'][1]}, "
              f"{r['launches']} launches, worst {r['flash_held']:.3f} of its bar", flush=True)
    print(f"18(a) {cfg.name} {cfg.num_layers} layer f32, B={b} S={s} on {ranks[0]['grid']}: "
          f"gathered logits vs unsharded max abs err {err:.3e} (max|logits| {scale:.3e}, tol "
          f"{SHARDED_LOGIT_TOL} x max) over the {b * s - int(flipped.sum())} positions whose "
          f"routing agrees ({int(flipped.sum())} flipped), on {card}", flush=True)
    if not (err <= SHARDED_LOGIT_TOL * scale and held <= 1.0
            and launches == 2 * SHARDED["ranks"] * cfg.num_layers):
        raise AssertionError(f"18(a) sharded MoE forward: logits {err:.3e} > "
                             f"{SHARDED_LOGIT_TOL} x {scale:.3e}, flash_attention {held:.3f} "
                             f"of its bar, or {launches} launches")
    return {"logits_err": err / scale, "flipped": int(flipped.sum()), "flash_held": held,
            "launches": launches, "forward_ms": [r["forward_ms"] for r in ranks],
            "host_ms": [r["host_ms"] for r in ranks], "sync_ms": [r["sync_ms"] for r in ranks]}


def sharded_grad_reference(torch) -> dict:
    """18(b)'s step unsharded on the card: loss, grad_norm, the gradient
    and the updated params (host), the step's ms."""
    from repro_torch import _tree
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamW

    spec = SHARDED_GRAD
    cfg = dataclasses.replace(zoo_config({"arch": spec["arch"], "reduced": False},
                                         num_layers=spec["layers"], dtype="float32"),
                              use_pallas_kernels=False)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SHARDED["seed"]))
    whole = next(iter(TokenStream(cfg.vocab_size, spec["seq"], spec["batch"], seed=0)))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in whole.items()}
    opt = GradCapture(AdamW(lr=spec["lr"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _, metrics = make_train_step(model, opt)(params, opt.init(params), batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    want_g = _tree.map_(lambda t: t.cpu(), opt.grads)
    want_p = _tree.map_(lambda t: t.detach().cpu(), params)
    del params, opt, metrics, batch
    free(torch)
    return {"cfg": cfg, "loss": loss, "grad_norm": gnorm, "grads": want_g, "params": want_p,
            "step_ms": step_ms}


def sharded_grad_check(torch, np, card: str, ranks: list, ref: dict) -> dict:
    """18(b): the sharded step's loss, grad_norm, gathered gradients and
    updated params against one unsharded step on the same card, weights
    and batch."""
    from repro_torch import _tree
    from repro_torch.launch.mesh import MeshPlan
    from repro_torch.sharding import rules as rules_lib

    spec, cfg = SHARDED_GRAD, ref["cfg"]
    loss, gnorm, step_ms = ref["loss"], ref["grad_norm"], ref["step_ms"]
    want_g, want_p = ref["grads"], ref["params"]
    plan = MeshPlan(("data", "model"), (SHARDED["ranks"] // SHARDED["model_parallel"],
                                        SHARDED["model_parallel"]))
    rules = rules_lib.AxisRules(mesh=plan, data_axes=("data",), model_axis="model")
    specs = rules_lib.param_specs(cfg, rules, plan)
    host = [{k: _unspool(torch, r[k]) for k in ("grads", "params")} for r in ranks]
    got_g = rules_lib.unshard_params([h["grads"] for h in host], specs, plan)
    got_p = rules_lib.unshard_params([h["params"] for h in host], specs, plan)
    names = _tree.leaves(_paths(want_g))
    worst, worst_name, p_worst, parted, total = 0.0, None, 0.0, 0, 0
    held_n, held_parted, held_worst = 0, 0, 0.0
    bound, near = 2 * spec["lr"], SHARDED_PARAM_NEAR * spec["lr"]
    for name, g, w, pg, pw in zip(names, _tree.leaves(got_g), _tree.leaves(want_g),
                                  _tree.leaves(got_p), _tree.leaves(want_p)):
        gap = float((g - w).abs().max() / w.abs().max())
        if gap > worst:
            worst, worst_name = gap, name
        dp = (pg - pw).abs() - SHARDED_PARAM_ULP * pw.abs()
        p_worst = max(p_worst, float(dp.max()))
        parted += int((dp > near).sum())
        total += dp.numel()
        held = dp[w.abs() > SHARDED_HELD_G]
        held_n += held.numel()
        held_parted += int((held > near).sum())
        held_worst = max(held_worst, float(held.max()) if held.numel() else 0.0)
    frac, held_frac = parted / total, held_parted / max(held_n, 1)
    r0 = ranks[0]
    loss_gap, norm_gap = abs(r0["loss"] - loss) / abs(loss), abs(r0["grad_norm"] - gnorm) / gnorm
    print(f"18(b) {cfg.name} {cfg.num_layers} layers f32, B={spec['batch']} S={spec['seq']}: "
          f"loss sharded {r0['loss']:.7f} unsharded {loss:.7f} (rel {loss_gap:.2e}), grad_norm "
          f"{r0['grad_norm']:.6f} vs {gnorm:.6f} (rel {norm_gap:.2e}); worst gradient leaf "
          f"{worst_name} {worst:.3e} x max|g|; updated params within {p_worst:.3e} of each other "
          f"beyond one rounding (bar 2 lr = {bound:g}); of the {held_n} elements whose "
          f"|g| > {SHARDED_HELD_G:g}, {held_parted} ({held_frac:.3e}, bar "
          f"{SHARDED_HELD_FRAC:g}) part by more than {SHARDED_PARAM_NEAR:g} lr, the worst by "
          f"{held_worst / spec['lr']:.3e} lr; of all {total}, {parted} ({frac:.3e}, bar "
          f"{SHARDED_PARAM_FRAC:g}); step {max(r['step_ms'] for r in ranks):.0f} ms a rank sharded, "
          f"{step_ms:.0f} ms unsharded, on {card}", flush=True)
    if not (loss_gap <= GRAD_TOL["loss"] and norm_gap <= GRAD_TOL["grad_norm"]
            and worst <= GRAD_TOL["leaf"] and p_worst <= bound
            and held_frac <= SHARDED_HELD_FRAC and frac <= SHARDED_PARAM_FRAC):
        raise AssertionError(f"18(b) sharded vs unsharded step: loss {loss_gap:.2e}, grad_norm "
                             f"{norm_gap:.2e}, leaf {worst_name} {worst:.2e}, params "
                             f"{p_worst:.2e}, {held_frac:.2e} of the held and {frac:.2e} of "
                             f"all elements parted (bars {GRAD_TOL}, 2 lr, "
                             f"{SHARDED_HELD_FRAC:g}, {SHARDED_PARAM_FRAC:g})")
    return {"loss_rel": loss_gap, "grad_norm_rel": norm_gap, "worst_leaf": worst_name,
            "worst_leaf_rel": worst, "param_excess": p_worst, "params_parted": parted,
            "params_parted_frac": frac, "held": held_n, "held_parted": held_parted,
            "held_worst_lr": held_worst / spec["lr"],
            "step_ms": [r["step_ms"] for r in ranks], "unsharded_step_ms": step_ms}


def sharded_train_kw() -> dict:
    """(c)'s ``launch/train.train_rank`` arguments (``train``'s)."""
    spec = SHARDED_TRAIN
    return {"arch": spec["arch"], "steps": spec["steps"], "batch": spec["batch"],
            "seq": spec["seq"], "reduced": False, "lr": spec["lr"], "log_every": 1,
            "checkpoint_path": None, "params": None, "layers": spec["layers"]}


def sharded_serve_kw() -> dict:
    """(e)'s ``launch/serve.serve_rank`` arguments (``serve``'s)."""
    spec = SHARDED_SERVE
    return {"arch": spec["arch"], "batch": spec["batch"], "prompt_len": spec["prompt"],
            "gen_len": spec["gen"], "reduced": False, "seed": SHARDED["seed"], "params": None,
            "layers": spec["layers"]}


def sharded_train(torch, np, card: str, reports: list) -> dict:
    """18(c) and (d): the ranks' ``launch/train.py`` reports (``train_rank``
    in each), then each step's collectives against the planner's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshPlan

    spec = SHARDED_TRAIN
    losses = reports[0]["losses"]
    for r in reports:
        print(f"18(c) rank {r['rank']}: step ms {[round(t, 1) for t in r['step_ms']]}, "
              f"tokens/s {[round(t) for t in r['tokens_per_s']]}, peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB", flush=True)
    steady = reports[0]["step_stats"][-1]
    print(f"18(c) {spec['arch']} {spec['layers']} layers bf16 (f32 moments), B={spec['batch']} "
          f"S={spec['seq']}, {reports[0]['grid']}: losses {[round(x, 4) for x in losses]}; a "
          f"step's transport (rank 0): {json.dumps({k: [steady['counts'][k], steady['bytes'][k]] for k in steady['counts']})} "
          f"(count, bytes), host {steady['host_s'] * 1e3:.0f} ms of which "
          f"{steady['sync_s'] * 1e3:.0f} ms waiting for the card, on {card}", flush=True)
    if not (all(np.isfinite(losses)) and np.mean(losses[-2:]) < losses[0]):
        raise AssertionError(f"18(c) sharded train: losses {losses} not finite and falling")
    sums = {dt for r in reports for s in r["step_stats"] for (kind, dt) in s["dtypes"]
            if kind != "all-gather"}
    if sums != {"float32"}:
        raise AssertionError(f"18(c) a cross-rank sum carried {sums}, not f32 alone")

    cfg = dataclasses.replace(get_config(spec["arch"]), num_layers=spec["layers"])
    plan = MeshPlan(("data", "model"), (SHARDED["ranks"] // SHARDED["model_parallel"],
                                        SHARDED["model_parallel"]))
    want = dryrun.executor_collectives(cfg, plan, spec["batch"], spec["seq"])
    rules = dryrun.layout_rules("2d", plan)
    params = dryrun._init_params(cfg)
    planned: dict = {}
    for op in dryrun.plan_collectives(cfg, "train", params,
                                      dryrun.specs_lib.param_spec_tree(params, rules, plan),
                                      rules, plan, spec["batch"], spec["batch"] // plan.shape[0],
                                      spec["seq"]):
        e = planned.setdefault(op.op, [0, 0])
        e[0] += op.multiplier
        e[1] += op.multiplier * op.result_bytes
    print("18(d) kind: planner (ops, bytes) | planner as the transport counts (calls, bytes) | "
          "transport per rank (calls, bytes)", flush=True)
    bad = []
    for kind in sorted(set(want) | set(planned) | set(steady["counts"])):
        w = want.get(kind, {"count": 0, "bytes": 0})
        for r in reports:
            for i, s in enumerate(r["step_stats"]):
                got = (s["counts"].get(kind, 0), s["bytes"].get(kind, 0))
                if got != (w["count"], w["bytes"]):
                    bad.append((r["rank"], i, kind, got, (w["count"], w["bytes"])))
        print(f"18(d) {kind}: {tuple(planned.get(kind, (0, 0)))} | ({w['count']}, {w['bytes']}) | "
              f"({steady['counts'].get(kind, 0)}, {steady['bytes'].get(kind, 0)})", flush=True)
    for note in dryrun.EXECUTOR_DIFFERENCES:
        print(f"18(d) modelled difference: {note}", flush=True)
    if bad:
        raise AssertionError(f"18(d) the transport's collectives differ from the planner's "
                             f"(rank, step, kind, got, want): {bad[:6]}")
    return {"losses": losses, "step_ms": [r["step_ms"] for r in reports],
            "tokens_per_s": [r["tokens_per_s"] for r in reports],
            "peak_gb": [r["peak_bytes"] / 1e9 for r in reports],
            "transport": {k: [steady["counts"][k], steady["bytes"][k]] for k in steady["counts"]},
            "host_ms": steady["host_s"] * 1e3, "sync_ms": steady["sync_s"] * 1e3,
            "planned": planned}


def sharded_serve_reference() -> dict:
    """18(e)'s unsharded launcher on the same seeded weights and prompts."""
    from repro_torch.launch import serve as serve_lib

    kw = sharded_serve_kw()
    return serve_lib.serve(kw.pop("arch"), device="cuda",
                           **{k: v for k, v in kw.items() if k != "params"})


def sharded_serve(torch, np, card: str, grid: dict, one: dict) -> dict:
    """18(e): the ranks' ``launch/serve.py`` result (``serve_rank`` in
    each; ``grid`` rank 0's) against the unsharded launcher's, ``one``."""
    spec = SHARDED_SERVE
    err, scale = max_err(torch.from_numpy(grid["prefill_logits"]),
                         torch.from_numpy(one["prefill_logits"]))
    agree = float((grid["tokens"] == one["tokens"]).mean())
    print(f"18(e) {spec['arch']} {spec['layers']} layers bf16 serve B={spec['batch']} prompt "
          f"{spec['prompt']} gen {spec['gen']}: prefill logits sharded vs unsharded max abs err "
          f"{err:.3e} (max {scale:.3e}: {err / scale:.3e} x max with f32 row-parallel partials, "
          f"{SHARDED_SERVE_DOUBLE_ROUNDED:.2e} with each partial rounded to bf16 first; tol "
          f"{SHARDED_SERVE_TOL} x max); "
          f"greedy tokens agree "
          f"{agree:.3f}; prefill {grid['prefill_s']:.3f} s sharded, {one['prefill_s']:.3f} s "
          f"unsharded; decode {grid['decode_tokens_per_s']:.1f} tok/s sharded, "
          f"{one['decode_tokens_per_s']:.1f} tok/s unsharded, on {card}", flush=True)
    if not err <= SHARDED_SERVE_TOL * scale:
        raise AssertionError(f"18(e) sharded prefill logits {err:.3e} > "
                             f"{SHARDED_SERVE_TOL} x {scale:.3e}")
    return {"prefill_err": err / scale, "tokens_agree": agree,
            "prefill_s": grid["prefill_s"], "unsharded_prefill_s": one["prefill_s"],
            "decode_tokens_per_s": grid["decode_tokens_per_s"],
            "unsharded_decode_tokens_per_s": one["decode_tokens_per_s"]}


def sharded_slice(torch, np, card: str) -> tuple[dict, dict]:
    """Phase 18: (a)-(i).  Returns the kernel launches of every rank's
    main paths ((a)'s flash_attention, (f)'s ssm_scan and flash_attention,
    (g)'s mlstm_scan) and a summary."""
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    free(torch)
    # The unsharded references run first, alone on the card, so that no
    # time of theirs or of the ranks' is taken while the other works.
    refs = {"moe": sharded_moe_reference(torch, np), "grad": sharded_grad_reference(torch),
            "serve": sharded_serve_reference()}
    free(torch)
    for key in SHARDED_RECURRENT:
        refs[key] = sharded_recurrent_reference(torch, np, key)
    print(f"18 unsharded references done in {time.perf_counter() - t0:.1f} s", flush=True)
    spool = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_spool_")
    spawned = time.time()
    try:
        ranks = mesh_lib.spawn_workers(
            _sharded_rank, SHARDED["ranks"], spool, SHARDED_MOE, SHARDED_GRAD,
            sharded_train_kw(), sharded_serve_kw(), backend=SHARDED["backend"],
            device="cuda", join_timeout_s=900)
        returned = time.time()
        began, ended = min(r["wall"][0] for r in ranks), max(r["wall"][1] for r in ranks)
        print(f"18 ranks done in {time.perf_counter() - t0:.1f} s: {began - spawned:.1f} s to "
              f"start, rank 0's seconds by part {ranks[0]['seconds']}, "
              f"{returned - ended:.1f} s to return", flush=True)
        summary = {"card": card, "moe": sharded_moe_check(torch, np, card, ranks, refs["moe"]),
                   "grad": sharded_grad_check(torch, np, card, ranks, refs["grad"])}
        for key in SHARDED_RECURRENT:
            summary[key] = sharded_recurrent_check(torch, np, card, ranks, refs.pop(key), key)
    finally:
        shutil.rmtree(spool, ignore_errors=True)
    reports, served = [r["train"] for r in ranks], ranks[0]["serve"]
    del ranks
    free(torch)
    summary["train"] = sharded_train(torch, np, card, reports)
    summary["serve"] = sharded_serve(torch, np, card, served, refs["serve"])
    summary["phase_s"] = time.perf_counter() - t0
    print(f"18 done in {summary['phase_s']:.1f} s", flush=True)
    print(json.dumps({"sharded": summary}), flush=True)
    launches = {"flash_attention": summary["moe"]["launches"]}
    for key in SHARDED_RECURRENT:
        for name, n in summary[key]["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches, summary


# Phase 19: the twins of examples/*.py, each at its script's defaults, and
# train_lm once more at the size its record was taken at.  The kernels each
# dSSFN twin launches, by the configs: quickstart's two trains of 6 layers
# (a gram and 6 propagate_gram each), robust_networks' 9 solves, the
# readout's 5 taps and one M=4 solve, serve_decode's train of 2 layers.
EXAMPLES = ("quickstart", "gossip_vs_spectral_gap", "robust_networks", "layerwise_readout",
            "serve_decode", "train_lm")
EXAMPLES_LAUNCHES = {"quickstart": {"gram": 2, "propagate_gram": 12},
                     "robust_networks": {"gram": 9}, "layerwise_readout": {"gram": 6},
                     "serve_decode": {"gram": 1, "propagate_gram": 2}}
EXAMPLES_SERVED = ("quickstart", "serve_decode")     # ssfn.predict and ServeEngine
EXAMPLES_RECORDED = ["--steps", "2", "--batch", "1", "--seq", "32"]
# The port's modules whose kernel ops the twins reach: (module, op).
EXAMPLES_OPS = (("repro_torch.core.admm", "gram"),
                ("repro_torch.core.engine", "propagate_gram"),
                ("repro_torch.core.ssfn", "matmul_relu"),
                ("repro_torch.serve.engine", "matmul_relu"))


def held_example_calls(torch, calls: dict) -> dict:
    """Every kernel call a twin made, held on its own inputs, by kernel:
    gram against the float64 Gram (GRAM_F64_ULPS f32 ulps of max|G|, as
    17(a); a 1xTF32 Gram misses it); propagate_gram's Y' against its
    plain version (KERNEL_TOL x max|plain|) and its G against the float64
    Gram of the kernel's own f32 Y' (GRAM_F64_ULPS), G exactly symmetric;
    matmul_relu against its plain version (KERNEL_TOL x max|plain|).
    Returns, by kernel, the calls held, their shapes and the worst
    distance over its bar (<= 1 passes)."""
    from repro_torch.kernels.matmul_relu import matmul_relu_ref
    from repro_torch.kernels.propagate_gram import propagate_gram_ref

    held = {}
    with torch.no_grad():
        if calls["gram"]:
            ulps, plain = held_gram_calls(torch, calls["gram"])
            held["gram"] = {"worst_of_bar": ulps / GRAM_F64_ULPS, "plain_ulps": plain}
        worst = worst_plain = 0.0
        for (w, y), kw, (y_new, g) in calls["propagate_gram"]:
            if w.dtype != torch.float32:
                raise AssertionError(f"propagate_gram: a {w.dtype} call; the twins' are f32")
            want_y, want_g = propagate_gram_ref(w, y, **kw)
            err, scale = max_err(y_new, want_y)
            y64 = y_new.double()
            g64 = y64 @ y64.mT + torch.eye(w.shape[0], dtype=torch.float64,
                                           device=w.device) / kw["mu"]
            ulp = 2.0**-24 * g64.abs().max()
            worst = max(worst, err / (KERNEL_TOL["float32"] * scale) if scale else err,
                        float((g.double() - g64).abs().max() / ulp) / GRAM_F64_ULPS,
                        0.0 if torch.equal(g, g.mT) else math.inf)
            worst_plain = max(worst_plain, float((want_g.double() - g64).abs().max() / ulp))
        if calls["propagate_gram"]:
            held["propagate_gram"] = {"worst_of_bar": worst, "plain_ulps": worst_plain}
        worst = 0.0
        for (w, x), _, got in calls["matmul_relu"]:
            err, scale = max_err(got, matmul_relu_ref(w, x))
            tol = KERNEL_TOL[str(w.dtype).rsplit(".", 1)[-1]] * scale
            worst = max(worst, err / tol if tol else (0.0 if err == 0 else math.inf))
        if calls["matmul_relu"]:
            held["matmul_relu"] = {"worst_of_bar": worst}
    for name, h in held.items():
        h["calls"] = len(calls[name])
        h["shapes"] = sorted({tuple(tuple(a.shape) for a in args)
                              for args, _, _ in calls[name]})
    return held


def run_twin(torch, rec, counters, name: str, argv: list):
    """One twin's ``main(argv)`` with its stdout captured (and echoed),
    every kernel counter set to 0 just before and read just after, and
    every call of the ops in EXAMPLES_OPS recorded with copies of its
    inputs and result; returns (result, printed lines, launches, wall s,
    recorded calls by kernel)."""
    import contextlib
    import importlib
    import io

    twin = rec.load_twin(name)
    free(torch)
    for c in counters.values():
        c.reset_launch_count()
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        recs = [stack.enter_context(OpRecorder(importlib.import_module(m), op, copy_args=True))
                for m, op in EXAMPLES_OPS]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = twin.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: c.launch_count() for k, c in counters.items()}
    calls = {op: [] for _, op in EXAMPLES_OPS}
    for r in recs:
        calls[r.name] += r.calls
    sys.stdout.write(buf.getvalue())
    return out, buf.getvalue().splitlines(), launched, wall, calls


def examples_slice(torch, card: str) -> tuple[dict, dict]:
    """Phase 19: the six twins of examples/*.py on the card.  Returns the
    kernel launches of their main paths and a summary."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_examples_record as rec

    checkers = {"quickstart": rec.check_quickstart,
                "gossip_vs_spectral_gap": rec.check_gossip_vs_spectral_gap,
                "robust_networks": rec.check_robust_networks,
                "layerwise_readout": rec.check_layerwise_readout,
                "serve_decode": lambda c, out, printed: rec.check_serve_dssfn(
                    c, out["dssfn"], printed),
                "train_lm": rec.check_train_lm}
    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)
    summary, failed = {"card": card, "bars": rec.BARS}, []
    t_phase = time.perf_counter()
    runs = [(name, name, []) for name in EXAMPLES]
    runs.append(("train_lm recorded", "train_lm", EXAMPLES_RECORDED))
    for name, twin, extra in runs:
        out, printed, launched, wall, calls = run_twin(torch, rec, counters, twin,
                                                       ["--device", "cuda", *extra])
        entry = {"wall_s": wall, "launches": {k: n for k, n in launched.items() if n}}
        t_held = time.perf_counter()
        entry["held"] = held_example_calls(torch, calls)
        entry["held_s"] = time.perf_counter() - t_held
        for k, h in entry["held"].items():
            if not h["worst_of_bar"] <= 1.0:
                failed.append({"twin": name, "what": f"{k} calls against the plain or "
                               "float64 version", **h})
        for k, rec_calls in calls.items():
            if len(rec_calls) != launched[k]:
                failed.append({"twin": name, "what": f"{k}: {len(rec_calls)} calls held of "
                               f"{launched[k]} launches"})
        if name == "train_lm":
            # 200 steps: no record at this size.  The script's own verdict
            # ("improved": the last loss below the first less 0.5).
            losses = out["losses"]
            entry["losses"] = [losses[0], losses[-1]]
            if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0] - 0.5
                    and "(improved)" in printed[-1]):
                failed.append({"twin": name, "what": "loss did not fall by 0.5 in 200 steps",
                               "losses": entry["losses"]})
        else:
            checks = rec.Checks()
            checkers[twin](checks, out, printed)
            entry.update(numbers=len(checks.records), worst_of_bar=checks.worst())
            failed += [dict(r, twin=name) for r in checks.failed()]
        want = EXAMPLES_LAUNCHES.get(name, {})
        if any(launched[k] != n for k, n in want.items()) or \
                (name in EXAMPLES_SERVED and not launched["matmul_relu"]):
            failed.append({"twin": name, "what": "launches", "stored": want, "got": launched})
        for k, n in launched.items():
            launches[k] += n
        summary[name] = entry
        print(f"19 {name}: {wall:.2f} s, launches {entry['launches']}"
              + (f", {entry['numbers']} numbers, worst {entry['worst_of_bar']:.3f} of its bar"
                 if "numbers" in entry else f", losses {entry['losses']} (improved)")
              + f" on {card}", flush=True)
        for k, h in entry["held"].items():
            plain = (f"; the f32 plain version {h['plain_ulps']:.2f} f32 ulps of max|G| from "
                     "float64" if "plain_ulps" in h else "")
            print(f"19 {name}: every {k} call on its own inputs: worst {h['worst_of_bar']:.3f} "
                  f"of its bar over {h['calls']} calls at {h['shapes']}{plain}", flush=True)
    summary["phase_s"] = time.perf_counter() - t_phase
    summary["failed"] = failed
    print(f"19 done in {summary['phase_s']:.1f} s", flush=True)
    print(json.dumps({"examples": summary}), flush=True)
    if failed:
        raise RuntimeError(f"phase 19: {len(failed)} checks failed: {failed}")
    return launches, summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    args = sys.argv[1:]
    parent_dir = args[args.index("--parent") + 1] if "--parent" in args else None
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    for flag, name, profiler, cases in (
            ("--profile-ssm", "ssm_scan", ssm_profile, [SSM_HEADLINE, SSM_CASES[1]]),
            ("--profile-mlstm", "mlstm_scan", mlstm_profile, [MLSTM_HEADLINE, MLSTM_CASES[1]])):
        if flag in args:
            # Only this kernel's profile, at the headline in both dtypes.
            _build.build_all([name])
            split = profiler(torch, card, cases)
            print(f"card: {card}", flush=True)
            print(json.dumps({f"{name}_profile": split}), flush=True)
            return 0
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    if "--zoo-train-only" in args:
        # Phase 16 alone, for a short card run while it changes.
        zoo_train_slice(torch, np, card)
        print(f"card: {card}", flush=True)
        return 0
    if "--sharded-only" in args:
        # Phase 18 alone.
        sharded_slice(torch, np, card)
        print(f"card: {card}", flush=True)
        return 0
    if "--examples-only" in args:
        # Phase 19 alone.
        examples_slice(torch, card)
        print(f"card: {card}", flush=True)
        return 0
    if "--dryrun-only" in args:
        # Phase 17 alone, after the 16(a) train it is held against.
        sweep = DryrunSweep()
        try:
            dryrun_slice(torch, card, train_danube(torch, np, card), sweep)
        finally:
            sweep.close()
        print(f"card: {card}", flush=True)
        return 0

    last = [time.perf_counter()]

    def lap(label: str) -> None:
        """Each phase's wall time, for the budget of the whole run."""
        now = time.perf_counter()
        print(f"phase {label} took {now - last[0]:.1f} s ({now - t0:.1f} s since the build "
              "began)", flush=True)
        last[0] = now

    cases = kernel_cases(torch, np)
    gram_cases, prop_cases = gram_kernel_cases(torch)
    lap("2-3")
    launches, micro = serve_slice(torch, np, card)
    launches += runtime_slice(torch, np, card, micro)
    lap("4-4b")
    train_launches, exact = train_slice(torch, card)
    lap("5")
    gossip_launches = gossip_slice(torch, card, exact)
    lap("5b")
    policy_launches = policy_slice(torch, card, exact)
    lap("5c")
    fault_launches = fault_slice(torch, card, exact)
    lap("5d")
    elastic_launches = elastic_slice(torch, np, card, exact)
    lap("5e")
    mesh_launches = mesh_slice(torch, np, card, exact)
    lap("5f")
    lint_launches = lint_slice(torch, np, card, exact, cases)
    lap("5g")
    del exact
    for k in train_launches:
        train_launches[k] += (gossip_launches[k] + policy_launches[k] + fault_launches[k]
                              + elastic_launches[k] + mesh_launches[k] + lint_launches[k])
    launches += (elastic_launches["matmul_relu"] + mesh_launches["matmul_relu"]
                 + lint_launches["matmul_relu"])
    flash_cases = flash_kernel_cases(torch)
    flash_launches = inference_slice(torch, np, card)
    lap("6-7")
    torch.cuda.empty_cache()
    ssm_cases = ssm_kernel_cases(torch)
    ssm_split = ssm_profile(torch, card)
    ssm_launches, split = hybrid_slice(torch, np, card)
    lap("8-9")
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        parent = parent_mlstm(torch, parent_dir, tmp) if parent_dir else None
        mlstm_cases = mlstm_kernel_cases(torch, parent)
        mlstm_split = mlstm_profile(torch, card, [MLSTM_HEADLINE, MLSTM_CASES[1]], parent)
        del parent
    mlstm_launches, xlstm_split = xlstm_slice(torch, np, card)
    lap("10-11")
    zoo = {}
    for key, run in (("phi35_moe", lambda: moe_slice(torch, np, card, PHI, "12 Phi ", True)),
                     ("mixtral", lambda: moe_slice(torch, np, card, MIXTRAL, "12 Mixtral ",
                                                   False)),
                     ("internvl2", lambda: vlm_slice(torch, np, card)),
                     ("musicgen", lambda: audio_slice(torch, np, card))):
        launched, zoo[key] = run()
        flash_launches += launched
        lap(f"12-14 {key}")
    sweep = DryrunSweep()
    try:
        zoo_train_launches, zoo_train = zoo_train_slice(torch, np, card)
        flash_launches += zoo_train_launches["flash_attention"]
        train_launches["gram"] += zoo_train_launches["gram"]
        dryrun_launches, _ = dryrun_slice(torch, card, zoo_train["danube"], sweep)
    finally:
        sweep.close()
    train_launches["gram"] += dryrun_launches
    lap("16-17")
    sharded_launches, _ = sharded_slice(torch, np, card)
    flash_launches += sharded_launches["flash_attention"]
    ssm_launches += sharded_launches["ssm_scan"]
    mlstm_launches += sharded_launches["mlstm_scan"]
    lap("18")
    example_launches, _ = examples_slice(torch, card)
    launches += example_launches["matmul_relu"]
    for k in ("gram", "propagate_gram"):
        train_launches[k] += example_launches[k]
    lap("19")

    def entry(name, source, replaces, launches, cases, headline):
        head = next(c for c in cases if c["key"] == headline)
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "shapes": head["shape"],
            "max_abs_err": head["max_abs_err"],
            "ms": head["ms"],
            "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            **({"bound_rate": "3xTF32: 3 TF32 products per f32 product at 495 TFLOP/s",
                "f32_bound_ms": head["f32_bound_ms"]} if "f32_bound_ms" in head else {}),
            "library_ms": head["library_ms"],
            "cases": [{k: v for k, v in c.items() if k != "key"} for c in cases],
        }

    csrc = "src/repro_torch/kernels/csrc"
    kernels = [
        entry("matmul_relu", f"{csrc}/matmul_relu.cu",
              "src/repro/kernels/matmul_relu/kernel.py:36", launches, cases, HEADLINE),
        entry("gram", f"{csrc}/gram.cu", "src/repro/kernels/gram/kernel.py:47",
              train_launches["gram"], gram_cases, GRAM_HEADLINE),
        entry("propagate_gram", f"{csrc}/propagate_gram.cu",
              "src/repro/kernels/propagate_gram/kernel.py:55",
              train_launches["propagate_gram"], prop_cases, PROPAGATE_HEADLINE),
        entry("flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:75", flash_launches,
              flash_cases, FLASH_HEADLINE),
        entry("ssm_scan", f"{csrc}/ssm_scan.cu", "src/repro/kernels/ssm_scan/kernel.py:69",
              ssm_launches, ssm_cases, SSM_HEADLINE),
        entry("mlstm_scan", f"{csrc}/mlstm_scan.cu",
              "src/repro/kernels/mlstm_scan/kernel.py:87", mlstm_launches, mlstm_cases,
              MLSTM_HEADLINE),
    ]
    kernels[3]["zoo_forwards"] = zoo
    kernels[-2]["hybrid_forward"] = split
    kernels[-2]["profile"] = ssm_split
    kernels[-1]["xlstm_forward"] = xlstm_split
    kernels[-1]["profile"] = mlstm_split
    kernels[-1]["parent_ms"] = next(c["parent_ms"] for c in mlstm_cases
                                    if c["key"] == MLSTM_HEADLINE)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""On-card smoke run of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds the five
hand-written kernel libraries from src/repro_torch/kernels/csrc into
build/repro_torch_kernels/ (one nvcc process each, in parallel).
Phases (any failure exits non-zero):

1. kernel checks: each kernel against its plain PyTorch twin on the card at
   the shape its path gives it (res 16 and 4 envs for the CFD kernels;
   B=1, S=4096 at phi4-mini's and rwkv6-3b's widths in bf16 for flash
   attention and WKV6; flash attention's bf16 tensor-core kernel also
   against the tile-exact oracle flash_attention_tiled, its float32
   CUDA-core kernel at the same shape, and a small sliding-window case,
   held by measures scaled to its output, which must reject two
   deliberately wrong variants; the SASS of the flash library must hold
   HGMMA instructions, that of WKV6 HMMA), with the stated tolerance,
   timed with CUDA events; the fused kernel also at 1 dt, at 32 envs
   (timed, with the cluster size chosen there) and at res 18 (held only),
   the two SOR slab kernels also at res 18 (held only), each cluster
   kernel's cluster size, blocks, the distinct SMs they ran on and its time
   per SOR half-sweep reported, the fused kernel's per-body instantiation
   on a mixed bank batch (cylinder jets, pinball and tandem rotary at
   distinct per-body speeds; res 16, 4 envs, 50 dt; each body's C_D / C_L
   held) and timed beside the scalar one, WKV6's blocks and SMs as its launch
   recorded them and each of its two passes timed, WKV6 also at a head of
   40 and a chunk of 64 and bf16 flash attention at a head dim of 96
   (both padded by their wrappers, held only); the wide heads: flash
   attention at Gemma 2's shape (B 1, S 4096, 16 heads over 8 of dh 256)
   in bf16 against its twin, the tile-exact oracle and the wrong variants,
   timed beside SDPA, in float32 (timed), and bf16 at a head of 160
   (padded to 256, held only); WKV6 at rwkv6-3b's width in heads of 256
   and 512 (its cluster passes: each pass timed, the state pass's blocks
   and SMs), and at a head of 200 (padded to 208, held only); the three
   cluster kernels' checks must reject variants built with a planted fault
   in their shared half-sweep (SOR halo rows one half-sweep stale); the
   float16 instantiations: HGMMA in the SASS of the float16 flash kernels,
   float16 flash at phi4-mini's (dh 128) and Gemma 2's (dh 256) shapes
   against its twin, the tile-exact oracle and the wrong variants, timed
   beside SDPA in float16, and float16 WKV6 at rwkv6-3b's width in heads
   of 64 and 512; past the old limits: the column-split flash kernels at
   dh 320 (H 8 over 2) and 512 (H 6 over 2), bf16 (also against the
   oracle and the wrong variants) and float32, timed beside SDPA (its
   kernels named), the repeated QK^T work beside the bound; WKV6 at heads
   of 1088 (2 heads) and 2560 (1 head) on several clusters a problem, each
   pass (and the add of the clusters' parts) timed; past one cluster, the
   CFD kernels' resident kernels: the fused interval's scalar and per-body
   instantiations at res 48 (4 envs, 50 dt, G 32; the mixed bank batch for
   the per-body one), the packed and the full-grid SOR at res 71 (one
   slab) and res 98 (two slabs), 4 envs, 13 rounds, each held against its
   twin, bit-equal to the global-memory kernel at the same G and timed
   beside it in alternating pairs, its G, clusters, launches, blocks and
   SMs reported, and each check must reject a build whose SOR halo rows
   are stale (its twin's tolerance) and one whose wait on the
   cross-cluster row is missing (the bit gate); then the global-memory
   kernels on their own grids: the fused interval at res 56 (4 envs, 20
   dt; scalar and per-body) and res 96 (4 envs, 10 dt of 0.002), the two
   SOR at res 95 (one slab no resident group holds), each held against its
   twin and timed, each check rejecting a build whose wait on the
   neighbours before a half-sweep is missing; and the synchronisation
   floor: 6100 handoffs at G 32 with no arithmetic through L2 flags, L2
   rows by flags, L2 tagged rows and DSMEM, in us a synchronisation; and
   the odd grid widths on their kernels (packed planes of ceil(nx / 2)
   columns, a dead slot a row), each through its entry point on the tier
   its plan names, with no fallback counted: ``backend="pallas"`` solves
   of 4 grids at iters 60 on (8, 11), res 71 and res 95 one column
   narrower (the full-grid library's full sweeps on the cluster, the
   resident and the global-memory tier) within TOL_SOR of the reference's
   full-grid sweep on the card, and ``backend="fused"`` intervals of 10 dt
   at res 8 (2 envs), 48 and 56 (4 envs) one column narrower, scalar and
   per-body (the three tiers) within TOL_FUSED of the reference scan on
   the card, each timed beside its bound, and a build of both libraries
   with the even row rule planted must fail the solves' and the scalar
   intervals' checks; after the last phase this process may have counted
   no fallback;
2. the main path: ``train()`` on the card at full width (res 16, 50 dt per
   action, 60 SOR iterations, 2x512 MLP, 149 probes, 4 envs,
   backend="fused"), depth cut to 2 episodes; the fused kernel must run;
   then the multi-body path: ``train(scenarios=("cyl_re100",
   "pinball_re100"))`` at the same widths (act_dim 3, the pinball's 59
   probes padded to 149), 1 episode; the fused kernel's per-body
   instantiation must launch once per interval, its scalar one once per
   warmup group; then ``train()`` at res 48 through the default backend
   (4 envs, 1 episode of 4 actions after a 1 t.u. warmup): every fused
   call on the resident kernel (as many launches a call as its plan, the
   card holding 3 such groups of 4 envs at once), none on the
   global-memory one; and the same at res 56, every call on the
   global-memory kernel;
3. the second path: one short episode with backend="pallas"; the
   packed-SOR kernel must run, one launch per pressure solve; then the
   same at res 71 (dt 0.0025: the default 0.005 is past explicit
   diffusion's limit there), one launch a solve of its resident kernel,
   and at res 95 (dt 0.0025, a 0.25 t.u. warmup), one launch a solve of
   its global-memory kernel;
4. the language-model paths: ``lm_loss(backend="pallas")`` of
   phi4-mini-3.8b and of rwkv6-3b at full width and depth (random bf16
   params from a seed), B=1, S=4096, timed at the first and a second
   (steady) call; one launch per layer of the bf16 flash-attention kernel,
   two (its chunk and state passes) of the WKV6 kernel, and none of any
   other, logits and loss held against backend="reference"; then the same
   at the wide heads, 4 of 32 layers: phi4-mini as 12 heads of 256 over 4
   (4 flash launches) and rwkv6-3b as 10 WKV6 heads of 256 and as 5 of 512
   (8 WKV6 launches each); both models at full depth with float16 params
   and compute (32 launches of the float16 flash instantiation and none of
   any other; 64 WKV6 launches, all on its float16 instantiation); past
   the old limits, 4 of 32 layers: phi4-mini as 6 heads of 512 over 2 (4
   launches, all on the column-split kernel) and rwkv6-3b as 2 WKV6 heads
   of 1280 (12 launches, all on 2 clusters a problem: the two passes and
   the add of the clusters' parts a layer); a ``[holds]`` line each before
   the kernels line;
5. the full-grid drop-in solve ``rb_sor(packed=False)``: res 16, 4 grids,
   iters=50, one launch of its kernel, the residual reduced; and at res 71,
   one launch of its resident kernel, at res 95 of its global-memory one;
6. golden physics through the fused kernel: the res-8 fixtures' Strouhal
   number, mean C_D and C_L amplitude within the reference's tolerances,
   the cylinder's through the scalar instantiation, the pinball's through
   the scalar one and through the per-body one (total forces);
7. the attention policy and the robust training path, every run on the
   card at the main path's widths (res 16, 50 dt per action, 4 envs of
   ``scenarios=("cyl_re100", "pinball_re100")``, 149 probes, act_dim 3,
   the attention policy at its own widths: d_model 64, 4 heads over 2 KV
   heads, 2 layers) under ``torch.use_deterministic_algorithms``: (a) 2
   episodes checkpointed every episode; 1 episode then a resume to 2 must
   equal (a) bit for bit (params, Adam moments, generator state, history)
   and the resume must launch no warmup; (b) ``nan_env`` on env 1 at step 4:
   exactly 1 quarantine, the other envs' final fields equal to (a)'s first
   episode's; (c) ``grad_nan`` at PPO step 7: 1 skip, params unchanged
   across that minibatch; (d) a ``watchdog`` fault at episode 1: one
   rollback, the completed run equal to (a).  The per-body instantiation
   must launch once per interval of every run, the scalar one once per
   warmup group; each run's wall time, the attention episode beside the
   MLP one, and the checkpoint's bytes and caller-visible time are printed;
8. the paper's I/O layer at the main path's widths (res 16, 50 dt per
   action, 4 envs, 2x512 MLP, backend="fused"), under
   ``torch.use_deterministic_algorithms``: (a) ``train()`` of 2 episodes
   with ``SinkSpec(kind="dataset")``: 201 fused launches, episodes 0..1
   recorded, the run fingerprint in the manifest; (b) ``replay_sync`` of
   the dataset from the seed: params, Adam moments, PPO step, generator
   state and returns equal to the live run's bit for bit, no fused
   launch; (c) a copy with its last shard cut by 8 bytes and one with a
   payload byte flipped raise ``DatasetError`` and never replay; (d)
   ``MultiEnvInterface.exchange`` of the second episode's batch in each
   mode (bytes and host seconds printed, every record read back), then 1
   episode of ``train(interface=..., sink=...)`` with the optimized
   interface and a binary sink whose file must read back equal to the
   episode's trajectory;
9. the async trainer and the planner at the main path's widths (res 16,
   50 dt per action, 4 envs, 2x512 MLP, backend="fused", 3 episodes of
   100 actions after one warmup): (a) under
   ``torch.use_deterministic_algorithms``, ``RolloutEngine.run_async``
   (the update's pieces issued between the collect's actions, on a
   second CUDA stream) must equal bit for bit (params, Adam moments, PPO
   step, generator state, returns) a serial emulation of its schedule
   (one stream, a synchronise between collect and update) and the same
   schedule with the update issued from a worker thread on a second
   stream, and must differ from
   ``run_sync``; one fused launch per interval in each; (b) each run's
   episode walls and the card's time of every collect and update, with
   their overlap (CUDA events on both streams): no overlap in
   ``run_async``'s steady episodes fails; (c) ``autotune`` at res 16 with
   its artifact validated, which must choose (1, 1) and "fused"; (d)
   ``train(plan="auto")`` for 1 episode: one fused launch per interval and
   one for the warmup beside the probe's; (e) ``async_speedup`` of the
   refit model beside the measured ratio;
10. fleet mode at the main path's widths (res 16, 50 dt per action, 60
   SOR iterations, 2x512 MLP, 149 probes, 4 envs in all, backend="fused"
   with the cluster pinned at 16, 2 episodes of 100 actions after a 30
   t.u. warmup), every run through the port's launcher (``python -m
   repro_torch.launch.fleet``, gloo between the runners, all on the one
   card): (a) a 1-process fleet (4 envs) of 2 episodes, which must launch
   the fused kernel once per interval (and once for its warmup), its
   steady episode wall, gather seconds and bytes per episode printed; (b)
   a 2-process fleet (2 envs each) of 3 episodes whose second runner is
   killed after its second episode: the supervisor must shrink 2 -> 1 and
   resume to the target; the episode-1 checkpoint the two runners wrote
   (its plan a 2-process one) must equal (a)'s bit for bit (params, Adam
   moments, generator state, step, env batch, history but its wall), its
   episode-2 checkpoint (a)'s final one; (c) a 1- and a 2-runner fleet of
   ``--plan 4,2,2`` (2 envs of 2 x-slabs each on the halo backend, one env
   a runner in the second; 1 episode of 2 actions after a 0.5 t.u. warmup)
   whose final checkpoints must be equal bit for bit; (d) ``--plan auto``
   in 2 runners of 4 workers each (``REPRO_TORCH_FORCE_DEVICE_COUNT=4``; 1
   episode of 2 actions after a 0.5 t.u. warmup):
   ``autotune(max_processes=2)`` in every runner, its artifact valid with
   a measured (``estimated: false``) gloo ``t_interhost``, ranks 1, 2 and
   4 timed, a packed-SOR launch in each runner; phase 12's golden (b)
   runs in a child process beside this phase;
11. the user-facing scripts on the card: ``drl_cylinder`` at res 16, 4
   envs, 1 episode of 100 actions (one fused launch per interval),
   ``serve_batch`` from (a)'s checkpoint (p50 / p99 latency, actions/s)
   and ``hybrid_scaling_demo`` in paper mode and ``--auto`` at res 16;
12. the halo decomposition (the paper's N_ranks axis: each env's pressure
   solve as x-slabs with halo messages, every slab on the card; plain
   PyTorch, no kernel of its own), with
   ``REPRO_TORCH_FORCE_DEVICE_COUNT=4`` for the phase only (and its child
   process): (a)
   ``decomposed_solve`` at res 16 (ny 66, nx 352), 4 envs, 60 pairs with
   a polish of 10, at ranks 1, 2 and 4, ``halo_inner`` 1 and 4, packed and
   legacy: rank 1 bit-equal to the monolithic solve of its layout, ranks
   2 and 4 at ``halo_inner=1`` within 1e-5 relative of it, messages of
   (33, 1) packed and (66, 1) legacy or block-Jacobi, 4 x 60 x (r - 1) a
   solve at ``halo_inner=1`` packed, each case's ms per solve; (b) the
   res-8 golden fixture through ``run_uncontrolled(backend="halo")`` at
   two ranks within the golden tolerances (in a child process,
   ``--halo-golden``, started before phase 10 and joined here); (c) a mixed scenario batch
   with 2 fixed actions through the env step on a (2, 2) mesh at res 16,
   within 0.05 of the un-decomposed backend; (d) ``train(plan=
   ParallelPlan(4, 2, 2))`` at the main path's widths, 1 episode of 2
   actions after a 1 t.u. warmup: the plan line names 'halo' and 2 x 2,
   returns finite, no kernel launched; (e) ``autotune`` over the four
   workers, ``t_step_ranks`` at ranks 1, 2 and 4 and the plan chosen;
13. the language model's serving path (``prefill``, ``decode_step``), random
   bf16 params from a seed: (a) phi4-mini-3.8b at full width and depth,
   ``prefill`` of B=1, S=4096 into a cache of 4160 (timed; its K/V of each
   layer bit-equal to ``apply_attention(return_kv=True)`` on its input to
   that layer), 64 greedy ``decode_step``s (ms per token p50 / p99 beside
   the bound of the bytes a token reads), and the decode held block by
   block against ``forward_train(backend="pallas")`` over the 4097 tokens
   and 127 more (the flash kernel's 128-key tile; 32 launches): each
   layer fed the forward's input to it, the decode block's update at
   position 4096 within ``TOL_LM_LAYER`` of the forward's; (b) rwkv6-3b
   the same (64 WKV6 launches), prefill's states held against the
   kernel's; (c) phi4-mini at decode_32k's cache length, ``init_cache(B=8,
   S=32768)`` (the batch cut from 128), 16 steps; (d) llama3-405b (4 of
   126 layers), mistral-large-123b (8 of 88) and qwen1.5-32b (32 of 64)
   decoding 16 steps from a float8_e4m3fn ``init_cache(B=8, S=4096)`` and
   from a bfloat16 one, each block's update within ``TOL_FLOAT8_BLOCK`` of
   the bfloat16 run's and the float8 cache byte for byte the cast of its
   K/V;
14. the language model's training path, which runs no kernel (the
   reference's train step runs the reference mixers; it cannot
   differentiate its Pallas kernels): (a) ``make_train_step`` of
   phi4-mini-3.8b (AdamW, 4 microbatches) and rwkv6-3b (AdamW, 2) at full
   width and depth, bf16, remat "full", ``synthetic_batch`` at train_4k's
   length with one sequence a microbatch, 2 steps (``TRAIN_STEPS``, as in
   every train phase: the first and one steady step; phi4-mini's steady
   step then once more under ``torch.profiler``): every loss finite, the
   first within ``TOL_TRAIN_LOSS`` of a separate ``lm_loss``, no kernel
   launched; s per step, tokens/s, the peak allocation and model FLOPs
   over the H100 preset's peak reported; (b) at phi4-mini's widths, 4
   layers, under deterministic algorithms: the 4-microbatch step's
   gradients within ``TOL_MICROBATCH`` of one full-batch step's, remat
   "full" equal to "" bit for bit, both peaks; a bf16 checkpoint of a layer
   restored bit-equal; (c) Adafactor (bf16 direction, per-layer path) at
   mistral-large-123b's widths, 6 of 88 layers, 4 microbatches, 2 steps;
   (d) ``python -m repro_torch.examples.quickstart`` exits 0 (the
   training script runs in phase 19 (d)); (e)
   ``make_train_step(backend="pallas")`` and a gradient through
   ``forward_train(backend="pallas")`` raise, launching nothing;
15. the mixture of experts, phi3.5-moe-42b-a6.6b at its widths (random
   bf16 params; 42 B params do not fit one card beside activations, so
   depth is cut): (a) ``lm_loss(backend="pallas")`` at 16 of 32 layers,
   B=1, S=4096, one flash launch a layer; each layer fed the reference
   backend's input to it, the attention update held within
   ``TOL_LM_LAYER`` of the reference mixer's, the whole block's update,
   the tokens the two backends route to other experts (with their
   probability gaps), each backend's aux and the share of pairs dropped
   at the config's capacity reported; the flash kernel at this shape (H
   32, Hkv 8) held against its twin and timed beside SDPA; (b) ``prefill``
   of a 4096 prompt and 64 greedy ``decode_step``s (ms per token p50 / p99
   beside the bound of every expert's bytes and of the routed experts'
   only, the card's idle share), the decode held block by block against
   ``forward_train(backend="pallas")`` over 4224 tokens at capacity
   factor 8.0 (dropless, as a one-token decode is): the attention update
   within ``TOL_LM_LAYER``, the whole block within it where the decode and
   the forward route the token alike (reported where they do not); (c)
   one MoE layer at full width, T 4096: the card's dispatch order and
   kept set at capacity factor 1.25 equal to the CPU's for the same router
   output, the dropless dispatch within ``TOL_MOE_DENSE`` of the dense mix
   of each token's top-k experts, the dispatch timed; the shared expert
   and the dense prefix at 2 layers (forward, prefill, decode); (d)
   ``make_train_step`` at 3 layers (2 if 3 run out of memory), AdamW, 4
   microbatches of one 4096-token sequence, 2 steps: losses finite, the
   first within ``TOL_TRAIN_LOSS`` of its microbatches' separate
   ``lm_loss`` (aux included), no kernel launched; (e) the training
   script's ``main(--arch phi3.5-moe-42b-a6.6b --reduced --steps 20)`` in
   this process (as phases 16-18 run theirs) returns;
16. the hybrid family, hymba-1.5b at full width and depth (32 layers,
   random bf16 params; attention with a window of 1024 beside a Mamba
   branch in every block): (a) ``lm_loss(backend="pallas")``, B=1,
   S=4096, 32 launches of the bf16 flash kernel and none of any other,
   held block by block against backend="reference" as phase 4 holds, and
   each layer's attention branch within ``TOL_LM_LAYER`` of the reference
   mixer's; the flash kernel at this shape (H 25 over Hkv 5, dh 64,
   window 1024) against its twin and the tile-exact oracle, timed beside
   SDPA under the window's mask, its bound counting the window's visible
   pairs; (b) one layer's Mamba branch: the two-level doubling scan
   against the step-by-step oracle within ``TOL_MAMBA_SCAN`` on the
   card, its device time, kernels (``torch.profiler``) and peak bytes;
   (c) ``prefill`` of a 4096 prompt (its K/V and Mamba states equal to
   its layers run one by one) and 64 greedy ``decode_step``s (p50 / p99
   beside the bound of the bytes a token reads, the card's idle share),
   the decode held block by block against ``forward_train(backend=
   "pallas")`` over 4224 tokens at position 4096, past the window; (d)
   ``make_train_step``, AdamW, remat "full", 4 microbatches of one
   4096-token sequence, 2 steps, one microbatch's forward and backward
   under ``torch.profiler``, the first loss within ``TOL_TRAIN_LOSS`` of
   its microbatches' separate ``lm_loss``, no kernel launched; (e) the
   training script's ``main`` on the reduced config returns;
17. MLA, the MTP head and deepseek-v3-671b at its widths, random bf16
   params (671 B params do not fit one card: 5 of 61 layers, the 3 dense
   prefix layers and 2 MoE layers of 256 experts top 8, with the MTP
   head, 54.4 GB; no kernel on this path, as in the reference, whose MLA
   takes no backend): (a) ``lm_loss`` with backend "pallas" (first and
   steady call) and "reference", B=1, S=4096: no kernel launched, the
   losses within ``TOL_DS_REPEAT`` (their spread printed); each layer's
   MLA, dense FFN and MoE update within ``TOL_LM_LAYER`` of the card's
   float32 recomputation of that layer on the same input and routing;
   the MTP term, the routers' aux and each MoE layer's share of pairs
   dropped at cf 1.25 printed; (b) ``prefill`` of a 4096 prompt into a
   cache of 4160 and 16 greedy absorbed-form ``decode_step``s (p50 / p99
   beside the bound of every byte a token reads, kernels a step, the idle
   share, the peak; the compressed cache's bytes a token against an
   expanded one's), the first decode's logits within ``TOL_DS_DECODE`` of
   the expanded ``forward_train``'s at position 4096 (dropless); (c) a
   forward and backward of ``lm_loss`` at 3 dense + 1 MoE layer (cut
   further where it runs out of memory, ``DS_GRAD_CUTS``): gradients
   finite, the peak; (d) ``make_train_step`` at the dense prefix and the
   MTP head (no MoE layer), Adafactor with its bf16 update, 4
   microbatches of one 4096-token sequence, 2 steps: the first loss
   within ``TOL_TRAIN_LOSS`` of its microbatches' separate ``lm_loss``;
   (e) the training script's ``main`` on the reduced config returns;
18. the encoder-decoder and the modality frontends, both models at full
   width and depth, random bf16 params from a seed: (a) qwen2-vl-2b (28
   layers, M-RoPE, qkv biases) with 1024 patch embeddings from a seed,
   (b) seamless-m4t-large-v2 (24 encoder and 24 decoder layers, gelu,
   LayerNorm, sinusoidal positions) with 512 frame embeddings; for each:
   ``lm_loss(backend="pallas")``, B=1, S=4096, first and steady call, one
   bf16 flash launch a decoder layer (28, 24) and none of any other, held
   block by block (cross attention included) against backend="reference"
   within ``TOL_LM_LAYER`` and the loss within ``TOL_LM_LOSS``; for (b)
   the encoder alone over its frames launches no kernel; the flash kernel
   at the decoder's shape (H 12 over Hkv 2 at dh 128; H 16 over Hkv 16 at
   dh 64) against its twin within ``TOL_FLASH["bfloat16"]``, timed beside
   SDPA (``is_causal=True, enable_gqa=True``) and its bound; ``prefill``
   of a 4096 prompt with its embeddings into a cache of 4160 and 16
   greedy ``decode_step``s (p50 / p99 beside the bound of the bytes a
   token reads: the decoder's blocks, the head and the whole cache, the
   cross K / V included; kernels a step, the idle share, the peak), the
   first decode's logits within ``TOL_FRONTEND_DECODE`` of
   ``forward_train(backend="reference")``'s at position 4096 and each
   decode block within ``TOL_LM_LAYER`` of the pallas forward's over 4224
   tokens (28 / 24 flash launches); ``make_train_step`` (AdamW, 4
   microbatches of one 4096-token sequence with its embeddings, 2 steps):
   the first loss within ``TOL_TRAIN_LOSS`` of its microbatches' separate
   ``lm_loss``, no kernel launched, the peak; the training script's
   ``main`` on the reduced config returns;
19. the language model's mesh layer on the card, a single controller
   (every shard on the card, the meshes abstract): (a) one phi3.5-moe MoE
   layer at full width (D 4096, 16 experts of 6400, top 2, cf 1.25), bf16,
   B 1 S 4096, through the expert-parallel dispatch under (1, 4) and (1,
   16) meshes: the kept pairs at both hops equal to the CPU's for the
   card's routes, the output within ``TOL_MESH_MOE`` of the CPU's float32
   run, the dropless (cf 8) output within it of ``_moe_dispatch``'s, the
   drop shares at each hop, ms a call beside ``_moe_dispatch``'s; (b)
   ``lm_loss(backend="pallas")`` of phi3.5-moe at 4 of 32 layers under a
   (1, 16) mesh: one flash launch a layer and none of any other, the loss
   finite beside the mesh-less one, s a call; (c) phi4-mini whole under
   the production (16, 16) mesh, B 1: prefill of 4096 and 16 greedy
   decodes (the masked cache write, the decode chain), p50 / p99 beside
   the mesh-less decode's and the bound with the masked write; each
   decode block within ``TOL_LM_LAYER`` of the pallas forward's; a step
   at pos >= S leaves the cache bit-equal; (d) one train step of
   phi4-mini at 8 of 32 layers, 4 x 4096 tokens, under a (2, 1) mesh (2
   microbatches): the loss within ``TOL_MESH_TRAIN_LOSS`` of its
   microbatches' separate mesh forward, the peak beside the mesh-less
   step's; ``python -m repro_torch.launch.train --arch phi4-mini-3.8b
   --reduced --steps 20 --ckpt-dir`` (under its debug mesh) exits 0 and
   its checkpoint restores and saves again byte for byte;
20. the cost counter against the card (``cost_path``), and one
   partitioned count (``launch/partition.py``: DTensor on a fake process
   group, no device) of phi4-mini at 2 of 32 layers on an abstract (2, 4)
   mesh, a decode of B 8 over a 4096 cache: its bytes by kind, each kind
   > 0 where the pass ran;
21. one JSON line listing the five kernels, then the card's line and the
   result.

Each phase prints its seconds (``[phase N]``), and the run its whole
seconds.  ``--phases 10,12,13,14,15,16,17,18,19`` runs any of those nine
phases alone after the build (a partial run: no kernels line, no result
line).  ``--compare TREE`` times phase 1's flash (dh 128) and WKV6 (N 64)
yardsticks and the CFD kernels at the training shape and past one cluster
(res 48 and 71: the resident kernels; with a digest of each output) of
another checkout's ``repro_torch`` (its kernels built into
its own ``build/``) and exits: run it on the older, the newer, the newer
and the older tree in one call to compare two commits on one card.

Imports nothing of jax or of the reference package.
"""
import collections
import contextlib
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# golden tolerances, the reference's (tests/test_golden_physics.py and, for
# the pinball, tests/test_golden_pinball.py)
TOL_ST, TOL_CD, TOL_AMP = 0.015, 0.01, 0.05
TOL_PINBALL = {"strouhal": 0.015, "cd_mean": 0.01, "cl_amp": 0.06}
# kernel vs twin: the kernel contracts a*b+c into FMAs, multiplies by
# float32 reciprocals of the grid constants where the twin divides, and sums
# forces in another order than the twin's op-by-op float32; over 50 dt x 60
# SOR pairs that stays well inside these (u, v are O(1), p and C_D O(5))
TOL_FUSED = {"u": 1e-4, "v": 1e-4, "p": 1e-3, "cd": 1e-3, "cl": 1e-3}
TOL_SOR = 1e-5                 # 52 pairs on unit-variance planes
# flash attention.  An output row averages v over up to S keys, so |o|
# falls as 1/sqrt(keys) along the sequence (about 1 at the first row, 0.02
# at the last of 4096): an absolute limit would be loose for most rows.  So
# the kernel is held by two measures scaled to the output, (rel-RMS: the
# RMS of kernel - plain over the RMS of plain, worst row: the largest
# max|kernel - plain| of a row over max|plain| of that row).  bfloat16: p
# is rounded at the running max in the kernel and after normalising in the
# twin, the twin's scores are rounded, and both round the output, each
# 2^-9 relative at most: 4.3e-3 rel-RMS and 1.7e-2 in the worst of 98304
# rows on the H100.  float32: only the order of the sums differs, 4.6e-7
# and 5.5e-6.  The limits are 2-10x those readings; the wrong variants of
# flash_wrong_kernels read 0.36 and 1.4 rel-RMS.  float16 rounds at the
# same places with 3 more bits (2^-11 relative): 1/8 of the bf16 readings
# predicted (5.4e-4, 2.1e-3), limits ~4x that
TOL_FLASH = {"bfloat16": (1e-2, 5e-2), "float16": (2e-3, 1e-2),
             "float32": (5e-6, 5e-5)}
# the bf16 tensor-core kernel against flash_attention_tiled, which rounds p
# at the same running max: the two fp32 results differ by the order of the
# sums and by exp2f against exp (~1 fp32 ulp of p), so a bf16 output
# differs by one rounding step, one ulp of its row's largest |o| (2^-7 of
# it), and by at most one more where a p lands on the other side of a bf16
# boundary in the two: two steps, 2^-6 (the H100 reads 7.75e-3, a row
# whose largest |o| sits just above a power of two).  Few outputs straddle
# a boundary: rel-RMS 1.2e-4 on the H100, 2e-3 allowed.  The wrong
# variants of flash_wrong_kernels read 0.36 and 1.4.  float16: one step is
# 2^-10 of the row's largest |o|, two 2^-9; rel-RMS 1/8 of bf16's allowed
TOL_FLASH_TILED = {"bfloat16": (2e-3, 2 ** -6), "float16": (2.5e-4, 2 ** -9)}
# WKV6, bf16 in and out: both compute the float32 recurrence on the same
# values (the chunked algebra against the sequential one), ~1e-6 apart, so
# the float32 state agrees to 2e-5 of its scale; the bf16 outputs differ by
# at most one rounding step where the two float32 values straddle a bf16
# boundary: one ulp, at most 2^-7 of the largest |out| (float16: 2^-10).
# Relative to the largest |x|
TOL_WKV_OUT = {"bfloat16": 2 ** -7, "float16": 2 ** -10}
TOL_WKV_STATE = 2e-5
# lm_loss at full width in bf16, backend "pallas" against "reference".  The
# kernels round p and the attention / WKV output to bf16 (8 bits, 2^-8
# relative) at other points than the plain mixers.  Layer by layer, on the
# same input, a block's update then differs by a few bf16 ulps of its RMS:
# 3e-2 allowed, and the logits of the last block likewise.  Through all 32
# random layers those differences grow (the reference package's own two
# backends differ by ~30% of the logits' RMS after 32 bf16 layers at
# reduced width), so the full-depth logits are reported, not held; the loss
# of near-uniform predictions (~ln V) moves little: 5e-2 allowed
TOL_LM_LAYER, TOL_LM_LOSS = 3e-2, 5e-2
FP32_PEAK = 67e12              # H100 SXM, FLOP/s outside the tensor cores
BF16_PEAK = 989e12             # H100 SXM, dense bf16 tensor-core FLOP/s
TF32_PEAK = 495e12             # H100 SXM, dense TF32 tensor-core FLOP/s
HBM_RATE = 3.35e12             # bytes/s
# a mixed bank batch: (geometry, act_mode, per-body speeds) per env; the
# cylinder's jets ride slot 0, tandem's third slot meets zero planes
BANK_ENVS = (("cylinder", 0.0, (0.3, 0.0, 0.0)),
             ("pinball", 1.0, (0.6, -0.3, 0.1)),
             ("tandem", 1.0, (-0.5, 0.8, 0.4)),
             ("pinball", 1.0, (1.0, 0.2, -0.7)))
# ~0.1 s of the card's clock, long enough for the host to queue a timed loop
SLEEP_CYCLES = 200_000_000


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps, warm=True):
    """ms per call of ``fn`` on the card: after a warm-up (skipped where
    the caller has just run ``fn``), ``reps`` calls queued behind a sleep
    kernel, so the events time the card's work and not the host's pace of
    launching it."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_paced_ms(fn, reps):
    """ms per call of ``fn`` in a loop the host paces (events around
    back-to-back calls): the card's time or the host's, whichever is
    longer."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound(nbytes, *work):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over their peaks, ``work`` being (operations, peak
    FLOP/s) pairs of the unit each runs on."""
    t_ops = sum(flops / peak for flops, peak in work)
    t_bytes = nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def fused_case(dev, cfg, n_env, n_steps, **kw):
    """Inputs of a fused-kernel check and its two realizations: n_env
    perturbed impulsive starts mixing jets and rotary (``kw``: the
    kernel's ``cluster`` and ``force_global``).  The plain one is the
    kernel's twin, or on a grid of odd width the reference scan that the
    kernel reproduces there (``solver.step_interval(backend=
    "reference")``)."""
    import numpy as np
    import torch
    from repro_torch.cfd import grid, solver
    from repro_torch.kernels.actuation import ops
    geom = grid.build_geometry(cfg)
    ga = solver.geom_to_arrays(geom, dev)
    rng = np.random.default_rng(0)
    flow = solver.init_state(cfg, geom, dev)
    flow = solver.FlowState(*(
        a.expand(n_env, *a.shape) + torch.tensor(
            0.01 * rng.standard_normal((n_env,) + tuple(a.shape)),
            dtype=torch.float32, device=dev) for a in flow))
    reps = -(-n_env // 4)
    jet = torch.tensor([0.3, -0.5, 0.0, 1.0] * reps, device=dev)[:n_env]
    mode = torch.tensor([0.0, 0.0, 1.0, 1.0] * reps, device=dev)[:n_env]

    def kernel():
        return ops.fused_interval_cuda(cfg, ga, flow, jet, n_steps,
                                       act_mode=mode, **kw)

    def plain():
        if cfg.nx % 2:
            return solver.step_interval(cfg, ga, flow, jet, n_steps,
                                        act_mode=mode, backend="reference")
        return ops.fused_interval_plain(cfg, ga, flow, jet, n_steps,
                                        act_mode=mode)

    return kernel, plain


def bank_case(dev, cfg, n_env, n_steps, **kw):
    """Inputs of a per-body kernel check and its two realizations: the bank
    of every geometry, ``n_env`` envs cycling through BANK_ENVS, each from
    its geometry's perturbed impulsive start (``kw``: the kernel's
    ``cluster`` and ``force_global``).  The plain one as
    :func:`fused_case`'s."""
    import numpy as np
    import torch
    from repro_torch.cfd import grid, solver
    from repro_torch.kernels.actuation import ops
    names = grid.geometry_names()
    geoms = {n: grid.build_geometry(cfg, n) for n in names}
    bank = solver.geometry_bank(
        [solver.geom_to_arrays(geoms[n], dev) for n in names],
        grid.max_bodies())
    envs = [BANK_ENVS[i % len(BANK_ENVS)] for i in range(n_env)]
    rng = np.random.default_rng(1)
    flows = [solver.init_state(cfg, geoms[g], dev) for g, _, _ in envs]
    flow = solver.FlowState(*(
        torch.stack(xs) + torch.tensor(
            0.01 * rng.standard_normal((n_env,) + tuple(xs[0].shape)),
            dtype=torch.float32, device=dev) for xs in zip(*flows)))
    gid = torch.tensor([names.index(g) for g, _, _ in envs], device=dev)
    mode = torch.tensor([m for _, m, _ in envs], device=dev)
    amp = torch.tensor([a for _, _, a in envs], device=dev)

    def kernel():
        return ops.fused_interval_cuda(cfg, bank, flow, amp, n_steps,
                                       act_mode=mode, geom_id=gid, **kw)

    def plain():
        if cfg.nx % 2:
            return solver.step_interval(cfg, bank, flow, amp, n_steps,
                                        act_mode=mode, geom_id=gid,
                                        backend="reference")
        return ops.fused_interval_plain(cfg, bank, flow, amp, n_steps,
                                        act_mode=mode, geom_id=gid)

    return kernel, plain


def fused_errors(kernel, plain):
    """max |kernel - twin| of u, v, p, C_D and C_L."""
    import torch
    (ka, ko), (pa, po) = kernel(), plain()
    torch.cuda.synchronize()
    errs = {n: float((x - y).abs().max())
            for n, x, y in zip("uvp", ka, pa)}
    errs["cd"] = float((ko.cd - po.cd).abs().max())
    errs["cl"] = float((ko.cl - po.cl).abs().max())
    return errs


def fused_report(what, errs):
    """Print the errors beside TOL_FUSED; True when every one is within."""
    print(f"[kernels] {what}: max|kernel - plain| " + ", ".join(
        f"{k} {v:.3e} (tol {TOL_FUSED[k]:.0e})" for k, v in errs.items()))
    return all(v <= TOL_FUSED[k] for k, v in errs.items())


def hold_fused(dev, cfg, n_env, n_steps, case=fused_case, what=""):
    """The kernel against its twin (TOL_FUSED) on ``case``'s inputs;
    returns (errors, kernel, plain)."""
    kernel, plain = case(dev, cfg, n_env, n_steps)
    errs = fused_errors(kernel, plain)
    if not fused_report(f"fused_interval{what} res {cfg.res} N={n_env} "
                        f"{n_steps} dt", errs):
        fail(f"fused_interval{what} res {cfg.res}, {n_env} envs, {n_steps} "
             f"dt differs from its twin: {errs}")
    return errs, kernel, plain


# The planted faults of the CFD kernels' half-sweeps, one build of each of
# the three libraries with both: in the cluster kernels' shared half-sweep
# (csrc/sor_packed.cuh, used by the fused kernel and the two SOR slab
# kernels) the edge rows send their neighbours the value from before the
# half-sweep, so every SOR halo row lags one half-sweep, which is what an
# edge row reads when its wait on the halo exchange is missing or waits on
# the wrong phase; in the global-memory kernels (csrc/grid_sync.cuh) the
# wait on the neighbours before each half-sweep is missing, so an edge row
# reads the other colour's row across its band's edge as it stands, a
# half-sweep stale or ahead.  (file, line, its faulty version)
STALE_HALO = (
    ("sor_packed.cuh", "st_async(to_prev + 4 * k, val, link.prev_bar)",
     "st_async(to_prev + 4 * k, self, link.prev_bar)"),
    ("sor_packed.cuh", "st_async(to_next + 4 * k, val, link.next_bar)",
     "st_async(to_next + 4 * k, self, link.next_bar)"),
    ("grid_sync.cuh", "wait_ranks(flags, lo, hi, rank, gen);",
     "__syncthreads();"))
STALE_HALO_KERNELS = ("fused_interval", "poisson_sor", "poisson_sor_full")
# The planted fault of the resident kernels (csrc/resident.cuh
# wait_tagged): the wait on the cross-cluster neighbour's row is missing,
# each tagged word taken as it stands rather than polled until it carries
# the phase, so an edge row may read the neighbour's row of two
# half-sweeps before, or none yet
NO_CROSS_WAIT = (("resident.cuh",
                  "for (unsigned polls = 0; static_cast<unsigned>(w >> 32) "
                  "!= gen; ++polls) {",
                  "for (unsigned polls = 0; false; ++polls) {"),)
# The planted fault of the odd widths (csrc/sor_packed.cuh sweep_row): the
# even layout's row rule on an odd grid, so a shift row's dead slot is
# swept with the outlet's ghost (-self) and a non-shift row's last point
# reads the other colour's dead slot in place of the outlet's ghost; in the
# two libraries that serve odd widths
ODD_GHOST = (("sor_packed.cuh", "constexpr bool kOddRule = kOddW;",
              "constexpr bool kOddRule = false;"),)
ODD_GHOST_KERNELS = ("fused_interval", "poisson_sor_full")


def start_variant_build(tag, faults, kernels=STALE_HALO_KERNELS):
    """Start nvcc on copies of the CFD kernel libraries ``kernels`` built
    with the planted ``faults`` ((file, line, its faulty version)), beside
    the other builds, into build/.../``tag``; returns {kernel: (library
    path, process)}."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / tag
    out.mkdir(parents=True, exist_ok=True)
    for name in {src for k in kernels for src in build.SOURCES[k]}:
        (out / name).write_bytes((build.CSRC / name).read_bytes())
    for header, line, wrong in faults:
        text = (out / header).read_text()
        if text.count(line) != 1:
            fail(f"{header} no longer holds {line!r} once: the {tag} "
                 f"variant cannot be planted")
        (out / header).write_text(text.replace(line, wrong))
    jobs = {}
    for kernel in kernels:
        lib = out / f"lib{kernel}_{tag}.so"
        jobs[kernel] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(out / build.SOURCES[kernel][0])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return jobs


def start_stale_halo_build():
    """The stale-halo variants of the three CFD kernel libraries."""
    return start_variant_build("stale_halo", STALE_HALO)


def stale_halo_libraries(jobs, tag="stale-halo"):
    """Wait for a variant build's processes; {kernel: loaded library}."""
    import ctypes
    libs = {}
    for kernel, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"the {tag} variant of {kernel} did not build:\n{out}")
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[kernel] = lib
    return libs


@contextlib.contextmanager
def library_swapped(kernel, wrong):
    """Run the kernel's wrapper on the library ``wrong`` in the block."""
    from repro_torch.kernels import build
    right = build.load(kernel)
    build._LIBS[kernel] = wrong
    try:
        yield
    finally:
        build._LIBS[kernel] = right


def stale_halo_rejected(dev, wrong, cfg, n_env, cases, case=fused_case,
                        what=""):
    """The fused kernel's checks, taken together, must reject the
    stale-halo variant: each ``(n_steps, errors of the right kernel)`` of
    ``cases`` is run through the variant on ``case``'s inputs, and at
    least one must fall outside TOL_FUSED.  Returns the variant's errors
    by case."""
    readings, rejected = {}, False
    with library_swapped("fused_interval", wrong):
        for n_steps, right_errs in cases:
            errs = fused_errors(*case(dev, cfg, n_env, n_steps))
            readings[f"{n_steps}_dt"] = errs
            held = fused_report(f"wrong kernel{what}, SOR halo rows stale "
                                f"(planted), res {cfg.res} N={n_env} "
                                f"{n_steps} dt", errs)
            rejected = rejected or not held
            print(f"[kernels]   the right kernel there: " + ", ".join(
                f"{k} {v:.3e}" for k, v in right_errs.items()))
    if not rejected:
        fail(f"TOL_FUSED cannot tell a fused kernel{what} whose SOR halo "
             f"rows are stale from a right one")
    return readings


def blocks_ran(block_sms):
    """(blocks, distinct SMs) of a launch from its record of the SM each
    block ran on, -1 where no block ran."""
    ran = block_sms.cpu()
    ran = ran[ran >= 0]
    return int(ran.numel()), int(ran.unique().numel())


def fused_launch():
    """(cluster size, blocks, distinct SMs) of the fused wrapper's last
    launch, as the launch recorded them."""
    from repro_torch.kernels.actuation import ops
    return (ops.fused_interval_cuda.last_cluster,
            *blocks_ran(ops.fused_interval_cuda.last_block_sms))


def check_fused(dev, cfg, n_env, n_steps):
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels.actuation import ops
    errs, kernel, plain = hold_fused(dev, cfg, n_env, n_steps)
    ms = cuda_ms(kernel, 5)
    cluster, blocks, sms_busy = fused_launch()
    plain_ms = cuda_ms(plain, 2)
    ny, nx = cfg.ny, cfg.nx
    flops, nbytes = ops.work(cfg, n_env, n_steps)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    # the card's occupancy for this launch shape and the others that fit
    active = ops.active_clusters(dev, cfg, cluster)
    by_size = {c: ops.active_clusters(dev, cfg, c) for c in (16, 8, 4)
               if ops.smem_bytes(ny, nx, c) <= ops.SMEM_PER_BLOCK}
    # a half-sweep's time: the interval at 60 and at 20 SOR pairs per dt,
    # the difference over the 40 pairs' half-sweeps
    few = GridConfig(res=cfg.res, poisson_iters=cfg.poisson_iters - 40)
    few_ms = cuda_ms(fused_case(dev, few, n_env, n_steps)[0], 5)
    sweep_us = 1e3 * (ms - few_ms) / (n_steps * 2 * 40)
    # derived, for the text only: the second floor is the phases of an
    # interval in sequence, each waiting for rows other blocks wrote (a
    # neighbour exchange after each SOR half-sweep, a cluster barrier after
    # the predictor and after the correction)
    chain = n_steps * (2 * cfg.poisson_iters + 2)
    sor_share = n_steps * 2 * cfg.poisson_iters * sweep_us / (1e3 * ms)
    print(f"[kernels] fused_interval: kernel {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB); clusters of "
          f"{cluster} blocks, {blocks} blocks ran on {sms_busy} distinct SMs "
          f"({active} such clusters resident at once; by cluster size "
          f"{by_size}); {chain} synchronisations in sequence, "
          f"{1e3 * ms / chain:.4f} us each on average; at "
          f"{few.poisson_iters} SOR pairs {few_ms:.4f} ms, so "
          f"{sweep_us:.4f} us per half-sweep, the SOR {sor_share:.3f} of "
          f"the kernel's time")
    return {"name": "fused_interval", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_interval.cu",
            "replaces": "src/repro/kernels/actuation/kernel.py:39",
            "max_abs_err": max(errs.values()), "errors": errs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library": "no single PyTorch call computes this",
            "cluster": cluster, "blocks": blocks, "sms_busy": sms_busy,
            "active_clusters": active,
            f"ms_at_{few.poisson_iters}_sor_pairs": few_ms,
            "half_sweep_us": sweep_us,
            "shape": f"res {cfg.res} (ny {ny}, nx {nx}), {n_env} envs, "
                     f"{n_steps} dt, {cfg.poisson_iters} SOR pairs per dt"}


def fused_batch_reading(dev, cfg, n_env, n_steps):
    """The kernel at a larger env batch: held against its twin, timed, and
    the launch the wrapper chose there."""
    from repro_torch.kernels.actuation import ops
    errs, kernel, _ = hold_fused(dev, cfg, n_env, n_steps)
    ms = cuda_ms(kernel, 3)
    cluster, blocks, sms_busy = fused_launch()
    active = ops.active_clusters(dev, cfg, cluster)
    print(f"[kernels] fused_interval res {cfg.res}, {n_env} envs, {n_steps} "
          f"dt: {ms:.4f} ms per interval in clusters of {cluster} blocks "
          f"({blocks} blocks ran on {sms_busy} distinct SMs; {active} "
          f"clusters resident at once, so {-(-n_env // active)} waves)")
    return {"envs": n_env, "ms": ms, "cluster": cluster, "blocks": blocks,
            "sms_busy": sms_busy, "active_clusters": active,
            "max_abs_err": max(errs.values())}


def check_fused_bodies(dev, cfg, n_env, n_steps, scalar_ms):
    """The per-body instantiation on a mixed bank batch: held against its
    twin (u, v, p and each body's C_D / C_L), timed beside the scalar
    instantiation's ``scalar_ms`` on the same grid, env count and dt."""
    from repro_torch.cfd import grid
    from repro_torch.kernels.actuation import ops
    errs, kernel, plain = hold_fused(dev, cfg, n_env, n_steps, bank_case,
                                     " per-body (mixed bank)")
    if ops.fused_interval_cuda.last_n_bodies != grid.max_bodies():
        fail(f"the per-body check launched the instantiation for "
             f"{ops.fused_interval_cuda.last_n_bodies} bodies")
    ms = cuda_ms(kernel, 5)
    cluster, blocks, sms_busy = fused_launch()
    plain_ms = cuda_ms(plain, 2)
    nb = grid.max_bodies()
    n_geoms = len({BANK_ENVS[i % len(BANK_ENVS)][0] for i in range(n_env)})
    flops, nbytes = ops.work(cfg, n_env, n_steps, nb, n_geoms)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    active = ops.active_clusters(dev, cfg, cluster, nb)
    print(f"[kernels] fused_interval per-body ({nb} bodies, a bank of "
          f"{len(grid.geometry_names())} geometries, {n_geoms} in the batch):"
          f" kernel {ms:.4f} ms ({ms / scalar_ms:.4f} of the scalar "
          f"instantiation's {scalar_ms:.4f} ms), plain twin {plain_ms:.4f} "
          f"ms, bound {bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.4f} GFLOP"
          f", {nbytes / 1e6:.4f} MB); clusters of {cluster} blocks, {blocks} "
          f"blocks ran on {sms_busy} distinct SMs ({active} such clusters "
          f"resident at once)")
    return {"max_abs_err": max(errs.values()), "errors": errs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "ms_over_scalar": ms / scalar_ms,
            "cluster": cluster,
            "blocks": blocks, "sms_busy": sms_busy,
            "active_clusters": active,
            "shape": f"res {cfg.res}, {n_env} envs of a mixed bank batch "
                     f"(cylinder jets, pinball and tandem rotary), "
                     f"{n_steps} dt, {cfg.poisson_iters} SOR pairs per dt"}


def fused_global_reading(dev, cfg, n_env, n_steps, case, what, plain=True):
    """The fused global-memory kernel on ``case``'s inputs: held against
    its twin, one launch, timed, with its G, blocks, SMs and bound."""
    from repro_torch.kernels.actuation import ops
    errs, kernel, twin = hold_fused(dev, cfg, n_env, n_steps, case, what)
    plan = ops.fused_interval_cuda.last_plan
    if plan.kernel != "global" or plan.launches != 1:
        fail(f"fused_interval{what} res {cfg.res} ran {plan}: expected one "
             f"launch of the global-memory kernel")
    ms = cuda_ms(kernel, 3)
    size, blocks, sms_busy = fused_launch()
    plain_ms = cuda_ms(twin, 1) if plain else None
    nb = ops.fused_interval_cuda.last_n_bodies
    n_geoms = (len({BANK_ENVS[i % len(BANK_ENVS)][0] for i in range(n_env)})
               if nb else 1)
    flops, nbytes = ops.work(cfg, n_env, n_steps, nb, n_geoms)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    resident = ops.resident_blocks(dev, cfg, size, nb)
    chain = n_steps * (2 * cfg.poisson_iters + 2)
    print(f"[kernels] fused_interval{what} res {cfg.res} (ny {cfg.ny}, nx "
          f"{cfg.nx}), {n_env} envs, {n_steps} dt: kernel {ms:.4f} ms"
          + (f", plain twin {plain_ms:.4f} ms" if plain else "")
          + f", bound {bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.4f} "
          f"GFLOP, {nbytes / 1e6:.4f} MB), {ms / bound_ms:.1f}x it; G "
          f"{size}, {blocks} blocks ran on {sms_busy} distinct SMs ({resident}"
          f" blocks resident at once), workspace "
          f"{plan.workspace_bytes / 1e6:.3f} MB; {chain} synchronisations in "
          f"sequence, {1e3 * ms / chain:.4f} us each on average")
    return {"max_abs_err": max(errs.values()), "errors": errs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "group": size, "blocks": blocks,
            "sms_busy": sms_busy, "resident_blocks": resident,
            "workspace_bytes": plan.workspace_bytes,
            "us_per_synchronisation": 1e3 * ms / chain,
            "shape": f"res {cfg.res}, {n_env} envs, {n_steps} dt, "
                     f"{cfg.poisson_iters} SOR pairs per dt"}


def alternating_ms(a, b, reps, pairs=3):
    """ms a call of ``a`` and of ``b`` timed in alternating pairs (a b, b a,
    a b, ...) in this process on this card: two lists."""
    ta, tb = [], []
    for i in range(pairs):
        for fn, out in (((a, ta), (b, tb)) if i % 2 == 0
                        else ((b, tb), (a, ta))):
            out.append(cuda_ms(fn, reps))
    return ta, tb


def outputs_equal(a, b):
    """(bit-equal, max |a - b|) of two fused results (flow, outputs) or two
    tuples of planes."""
    import torch
    if not isinstance(a[0], torch.Tensor):
        a, b = (*a[0], a[1].cd, a[1].cl), (*b[0], b[1].cd, b[1].cl)
    torch.cuda.synchronize()
    return (all(torch.equal(x, y) for x, y in zip(a, b)),
            max(float((x - y).abs().max()) for x, y in zip(a, b)))


def fused_resident_reading(dev, cfg, n_env, n_steps, case, what):
    """The fused resident kernel on ``case``'s inputs: held against its
    twin, bit-equal to the global-memory kernel at the same G (the
    yardstick), the two timed in alternating pairs, with its G, clusters,
    launches, blocks, SMs and bound; returns (reading, its kernel, the
    yardstick)."""
    import statistics
    from repro_torch.kernels.actuation import ops
    errs, kernel, twin = hold_fused(dev, cfg, n_env, n_steps, case, what)
    plan = ops.fused_interval_cuda.last_plan
    if plan.kernel != "resident":
        fail(f"fused_interval{what} res {cfg.res} ran {plan}: expected the "
             f"resident kernel")
    size, blocks, sms_busy = fused_launch()
    nb = ops.fused_interval_cuda.last_n_bodies
    yard = case(dev, cfg, n_env, n_steps, cluster=plan.size,
                force_global=True)[0]
    out = kernel()
    equal, diff = outputs_equal(out, yard())
    if ops.fused_interval_cuda.last_kernel != "global":
        fail(f"the forced fused kernel at res {cfg.res} ran "
             f"{ops.fused_interval_cuda.last_plan}")
    if not equal:
        fail(f"fused_interval{what} res {cfg.res}: the resident kernel at G "
             f"{plan.size} differs from the global-memory kernel at G "
             f"{plan.size} by {diff:.3e}")
    times, yard_times = alternating_ms(kernel, yard, 3)
    ms, yard_ms = statistics.median(times), statistics.median(yard_times)
    plain_ms = cuda_ms(twin, 1)
    n_geoms = (len({BANK_ENVS[i % len(BANK_ENVS)][0] for i in range(n_env)})
               if nb else 1)
    flops, nbytes = ops.work(cfg, n_env, n_steps, nb, n_geoms)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    active = ops.resident_active_clusters(dev, cfg, plan.cluster, plan.size,
                                          nb)
    chain = n_steps * (2 * cfg.poisson_iters + 2)
    print(f"[kernels] fused_interval{what} res {cfg.res} (ny {cfg.ny}, nx "
          f"{cfg.nx}), {n_env} envs, {n_steps} dt: kernel {ms:.4f} ms "
          f"(pairs {[round(t, 4) for t in times]}), the global-memory kernel "
          f"at G {plan.size} {yard_ms:.4f} ms (pairs "
          f"{[round(t, 4) for t in yard_times]}), {yard_ms / ms:.3f}x; "
          f"bit-equal to it; plain twin {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.4f} GFLOP, "
          f"{nbytes / 1e6:.4f} MB), {ms / bound_ms:.1f}x it; G {size} = "
          f"{size // plan.cluster} clusters of {plan.cluster}, "
          f"{plan.per_launch} envs a launch ({active} such clusters "
          f"resident at once), {plan.launches} launch(es), {blocks} blocks "
          f"ran on {sms_busy} distinct SMs, workspace "
          f"{plan.workspace_bytes / 1e6:.3f} MB; {chain} synchronisations "
          f"in sequence a launch, {1e3 * ms / (chain * plan.launches):.4f} us "
          f"each on average")
    return {"max_abs_err": max(errs.values()), "errors": errs, "ms": ms,
            "ms_pairs": times, "global_ms": yard_ms,
            "global_ms_pairs": yard_times, "bit_equal_global": equal,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "group": size, "cluster": plan.cluster,
            "launches_per_call": plan.launches,
            "envs_per_launch": plan.per_launch, "active_clusters": active,
            "blocks": blocks, "sms_busy": sms_busy,
            "workspace_bytes": plan.workspace_bytes,
            "us_per_synchronisation": 1e3 * ms / (chain * plan.launches),
            "shape": f"res {cfg.res}, {n_env} envs, {n_steps} dt, "
                     f"{cfg.poisson_iters} SOR pairs per dt"}, kernel, yard


def no_cross_wait_rejected(kernel_name, wrong, kernel, yard, what):
    """The bit gate against the planted missing cross-cluster wait: the
    resident ``kernel`` run on the variant library ``wrong`` must not give
    the global-memory ``yard``'s bits.  Returns the variant's max
    difference."""
    right = yard()
    with library_swapped(kernel_name, wrong):
        equal, diff = outputs_equal(kernel(), right)
    print(f"[kernels] wrong kernel, no wait on the cross-cluster flag "
          f"(planted), {what}: bit-equal to the global-memory kernel "
          f"{equal}, max diff {diff:.3e}")
    if equal:
        fail(f"the bit gate cannot tell a {what} resident kernel without "
             f"its cross-cluster wait from a right one")
    return diff


def check_fused_resident(dev, stale, no_wait):
    """The fused kernel past one cluster on its resident kernel
    (csrc/fused_interval.cu fused_interval_resident_kernel): the scalar and
    the per-body (mixed bank) instantiation at res 48 (4 envs, 50 dt, G
    32) held against their twins, bit-equal to the global-memory kernel at
    G 32 and timed beside it in alternating pairs; the planted stale halo
    (TOL_FUSED) and the planted missing cross-cluster wait (the bit gate)
    rejected; 1 and 2 envs timed in each cluster size; returns its entry
    under row 1 of the kernels line."""
    from repro_torch.cfd.grid import GridConfig
    res48 = GridConfig(res=48)
    row, kernel, yard = fused_resident_reading(dev, res48, 4, 50, fused_case,
                                               " resident")
    row.update(name="fused_interval_resident", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_interval.cu",
               replaces="src/repro/kernels/actuation/kernel.py:39",
               library="no single PyTorch call computes this")
    short = hold_fused(dev, res48, 4, 1, what=" resident")[0]
    row["stale_halo_variant"] = stale_halo_rejected(
        dev, stale, res48, 4, ((50, row["errors"]), (1, short)),
        what=" resident")
    row["no_cross_wait_variant_max_diff"] = no_cross_wait_rejected(
        "fused_interval", no_wait, kernel, yard, "fused_interval res 48")
    bodies = fused_resident_reading(dev, res48, 4, 50, bank_case,
                                    " resident per-body (mixed bank)")[0]
    bodies["ms_over_scalar"] = bodies["ms"] / row["ms"]
    row["per_body"] = bodies
    row["by_cluster"] = {f"{n}_envs": fused_clusters_compared(dev, res48, n)
                         for n in (1, 2)}
    return row


def fused_clusters_compared(dev, cfg, n_env):
    """The fused resident kernel at ``n_env`` envs (a fleet runner's
    batch, or one env), 50 dt, G 32, in clusters of each C it takes (16,
    8, 4, 2), each pinned in turn (kernels/cluster.py RESIDENT_CLUSTERS,
    which the plan reads): one launch each, bit-equal to one another,
    timed in alternating rounds (each round's order the reverse of the
    last's); returns the C the plan takes and the ms by C."""
    import statistics
    from repro_torch.kernels import cluster as kcluster
    from repro_torch.kernels.actuation import ops
    kernel = fused_case(dev, cfg, n_env, 50)[0]
    order = kcluster.RESIDENT_CLUSTERS

    def pinned(c):
        def run():
            kcluster.RESIDENT_CLUSTERS = (c,)
            try:
                return kernel()
            finally:
                kcluster.RESIDENT_CLUSTERS = order
        return run

    out = kernel()
    chosen = ops.fused_interval_cuda.last_plan.cluster
    runs = {}
    for c in order:
        runs[c] = pinned(c)
        equal, diff = outputs_equal(runs[c](), out)
        plan = ops.fused_interval_cuda.last_plan
        if (plan.kernel, plan.size, plan.cluster, plan.launches) != (
                "resident", 32, c, 1):
            fail(f"fused_interval res {cfg.res}, {n_env} envs, pinned to "
                 f"clusters of {c}, ran {plan}")
        if not equal:
            fail(f"fused_interval res {cfg.res}: clusters of {c} differ from "
                 f"clusters of {chosen} by {diff:.3e}")
    times = {c: [] for c in runs}
    for i in range(3):
        for c in (order if i % 2 == 0 else order[::-1]):
            times[c].append(cuda_ms(runs[c], 3))
    ms = {c: statistics.median(t) for c, t in times.items()}
    print(f"[kernels] fused_interval resident res {cfg.res}, {n_env} envs, "
          f"50 dt, G 32, by cluster size (one launch each, bit-equal): "
          + ", ".join(f"C {c} {ms[c]:.4f} ms (rounds "
                      f"{[round(t, 4) for t in times[c]]})" for c in ms)
          + f"; the plan takes C {chosen}, the fastest is C "
            f"{min(ms, key=ms.get)}")
    return {"plan_cluster": chosen,
            "ms_by_cluster": {str(c): v for c, v in ms.items()},
            "rounds_by_cluster": {str(c): t for c, t in times.items()}}


def check_fused_global(dev, wrong):
    """The fused kernel's global-memory kernel (csrc/fused_interval.cu
    fused_interval_global_kernel) on the grids it serves: the scalar and
    the per-body (mixed bank) instantiation at res 56 (4 envs, 20 dt), the
    scalar at res 96 (4 envs, 10 dt), held against their twins and timed;
    the planted stale halo rejected at res 56; returns its entry under row
    1 of the kernels line."""
    from repro_torch.cfd.grid import GridConfig
    res56 = GridConfig(res=56)
    res96 = GridConfig(res=96, dt=FINE_DT[96])
    row = fused_global_reading(dev, res56, 4, 20, fused_case, " global")
    row.update(name="fused_interval_global", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_interval.cu",
               replaces="src/repro/kernels/actuation/kernel.py:39",
               library="no single PyTorch call computes this")
    short = hold_fused(dev, res56, 4, 1, what=" global")[0]
    row["stale_halo_variant"] = stale_halo_rejected(
        dev, wrong, res56, 4, ((20, row["errors"]), (1, short)),
        what=" global")
    row["res_96"] = fused_global_reading(dev, res96, 4, 10, fused_case,
                                         " global", plain=False)
    bodies = fused_global_reading(dev, res56, 4, 20, bank_case,
                                  " global per-body (mixed bank)")
    bodies["ms_over_scalar"] = bodies["ms"] / row["ms"]
    row["per_body"] = bodies
    return row


def check_sor_resident(dev, full, stale, no_wait):
    """An SOR slab kernel past one cluster on its resident kernel
    (csrc/sor_slabs.cuh sor_slabs_resident): res 71 (one slab, one call a
    solve) and res 98 (two slabs, 13 calls), 4 envs, 13 rounds, held
    against its twin, bit-equal to the global-memory kernel at the same G
    and timed beside it in alternating pairs; the planted stale halo
    (TOL_SOR) and the planted missing cross-cluster wait (the bit gate)
    rejected at res 71; returns its entry under the kernel's row of the
    kernels line."""
    import statistics
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels.poisson import ops
    name, lib, source, replaces, _ = SOR_KERNELS[full]
    wrapper = sor_wrapper(full)
    row = {}
    for res in (71, 98):
        cfg = GridConfig(res=res)
        nslabs = ops._pick_nslabs(cfg.nx)
        solve, plain = sor_case(dev, cfg, 4, 50, full=full)
        n0 = wrapper.launches_resident
        out = solve()
        per_solve = wrapper.launches_resident - n0
        plan = wrapper.last_plan
        if plan.kernel != "resident":
            fail(f"{name} at res {res} ran {plan}: expected the resident "
                 f"kernel")
        size, blocks, sms_busy = sor_launch(full)
        err = outputs_equal(out, plain())[1]
        if not err <= TOL_SOR:
            fail(f"{name} resident at res {res} differs from its twin by "
                 f"{err:.3e}")

        def yard():
            return solve(cluster=plan.size, force_global=True)

        equal, diff = outputs_equal(solve(), yard())
        if wrapper.last_kernel != "global" or not equal:
            fail(f"{name} at res {res}: the resident kernel at G {plan.size}"
                 f" differs from the global-memory kernel ({diff:.3e})")
        times, yard_times = alternating_ms(solve, yard, 10)
        ms, yard_ms = statistics.median(times), statistics.median(yard_times)
        plain_ms = cuda_ms(plain, 1)
        flops, nbytes = ops.work(4, cfg.ny, cfg.nx, 50, 4)
        bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
        bxp = cfg.nx // 2 // nslabs
        active = ops.resident_active_clusters(dev, cfg.ny, bxp, plan.cluster,
                                              plan.size, full)
        sweeps = 2 * 4 * 13 * plan.launches
        print(f"[kernels] {name} resident res {res} (grid ({cfg.ny}, "
              f"{cfg.nx}), {nslabs} slab(s)) N=4, 13 rounds: max|kernel - "
              f"plain| {err:.3e} (tol {TOL_SOR:.0e}); solve {ms:.4f} ms in "
              f"{per_solve} launch(es) (pairs {[round(t, 4) for t in times]})"
              f", the global-memory kernel at G {plan.size} {yard_ms:.4f} ms "
              f"(pairs {[round(t, 4) for t in yard_times]}), "
              f"{yard_ms / ms:.3f}x; bit-equal to it; plain twin "
              f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
              f"{flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.4f} MB), "
              f"{ms / bound_ms:.1f}x it; G {size} = {size // plan.cluster} "
              f"clusters of {plan.cluster}, {plan.per_launch} groups a "
              f"launch ({active} such clusters resident at once), {blocks} "
              f"blocks ran on {sms_busy} distinct SMs; "
              f"{1e3 * ms / sweeps:.4f} us per half-sweep")
        reading = {"max_abs_err": err, "ms": ms, "ms_pairs": times,
                   "global_ms": yard_ms, "global_ms_pairs": yard_times,
                   "bit_equal_global": equal, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "launches_per_solve": per_solve,
                   "group": size, "cluster": plan.cluster,
                   "groups_per_launch": plan.per_launch,
                   "active_clusters": active, "blocks": blocks,
                   "sms_busy": sms_busy,
                   "half_sweep_us": 1e3 * ms / sweeps,
                   "shape": f"13 rounds: res {res}, grid ({cfg.ny}, "
                            f"{cfg.nx}), {nslabs} slab(s), 4 grids"}
        if res == 71:
            with library_swapped(lib, stale):
                stale_err = outputs_equal(solve(), plain())[1]
            print(f"[kernels] wrong kernel, SOR halo rows stale (planted), "
                  f"{name} resident res 71 N=4: max|kernel - plain| "
                  f"{stale_err:.3e} (tol {TOL_SOR:.0e}; the right kernel "
                  f"{err:.3e})")
            if stale_err <= TOL_SOR:
                fail(f"TOL_SOR cannot tell a {name} resident kernel whose "
                     f"halo rows are stale from a right one")
            row.update(reading, name=f"{name}_resident", route="cuda",
                       source=source, replaces=replaces,
                       library="no single PyTorch call computes this",
                       stale_halo_variant_max_abs_err=stale_err,
                       no_cross_wait_variant_max_diff=no_cross_wait_rejected(
                           lib, no_wait, solve, yard, f"{name} res 71"))
        else:
            row[f"res_{res}"] = reading
    return row


def check_sor_global(dev, full, wrong):
    """An SOR slab kernel's global-memory kernel (csrc/sor_slabs.cuh
    sor_slabs_global) on a grid it serves: res 95 (one (390, 1045) slab,
    which no resident group holds; 1 launch a solve), 4 envs, iters 50,
    held against its twin and timed; the planted stale halo rejected;
    returns its entry under the kernel's row of the kernels line."""
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels.poisson import ops
    name, lib, source, replaces, solve = SOR_KERNELS[full]
    wrapper = sor_wrapper(full)
    cfg = GridConfig(res=95)
    nslabs = ops._pick_nslabs(cfg.nx)
    kernel, plain = sor_case(dev, cfg, 4, 50, 2 if full else 1, full)
    n0 = wrapper.launches_global
    err = sor_error(kernel, plain)
    per_solve = wrapper.launches_global - n0
    if wrapper.last_kernel != "global" or per_solve != 1:
        fail(f"{solve} at res 95 took {per_solve} launches of the "
             f"{wrapper.last_kernel} kernel: expected 1 of the global-memory"
             f" kernel")
    if not err <= TOL_SOR:
        fail(f"{name} global at res 95 differs from its twin by {err:.3e}")
    ms = cuda_ms(kernel, 10)
    plain_ms = cuda_ms(plain, 1)
    size, blocks, sms_busy = sor_launch(full)
    flops, nbytes = ops.work(4, cfg.ny, cfg.nx, 50, 4)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    resident = ops.resident_blocks(dev, cfg.ny, cfg.nx // 2 // nslabs, size,
                                   full)
    waits = 2 * 4 * 13
    print(f"[kernels] {name} global res 95 (grid ({cfg.ny}, {cfg.nx}), "
          f"{nslabs} slab(s)) N=4 {solve} at iters=50: max|kernel - plain| "
          f"{err:.3e} (tol {TOL_SOR:.0e}); solve {ms:.4f} ms in "
          f"{per_solve} launch(es), plain twin {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}: {flops / 1e6:.3f} MFLOP, "
          f"{nbytes / 1e6:.4f} MB), {ms / bound_ms:.1f}x it; G {size}, "
          f"{blocks} blocks ran on {sms_busy} distinct SMs ({resident} "
          f"resident at once); {1e3 * ms / waits:.4f} us per half-sweep")
    with library_swapped(lib, wrong):
        stale = sor_error(kernel, plain)
    print(f"[kernels] wrong kernel, SOR halo rows stale (planted), {name} "
          f"global res 95 N=4: max|kernel - plain| {stale:.3e} (tol "
          f"{TOL_SOR:.0e}; the right kernel {err:.3e})")
    if stale <= TOL_SOR:
        fail(f"TOL_SOR cannot tell a {name} global kernel whose halo rows "
             f"are stale from a right one")
    return {"name": f"{name}_global", "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library": "no single PyTorch call computes this",
            "launches_per_solve": per_solve, "group": size,
            "blocks": blocks, "sms_busy": sms_busy,
            "resident_blocks": resident, "half_sweep_us": 1e3 * ms / waits,
            "stale_halo_variant_max_abs_err": stale,
            "shape": f"one {solve} solve: res 95, grid ({cfg.ny}, {cfg.nx}), "
                     f"{nslabs} slab(s), 4 grids, 13 rounds"}


def fused_beside_cluster(dev):
    """On res 38, which both fused kernels serve: the global-memory kernel,
    forced at the cluster kernel's size, against the cluster kernel on one
    input (4 envs, 50 dt), within TOL_FUSED (a point's arithmetic and the
    order of the sums are the same in both, so the bits are expected to
    agree; reported), each timed."""
    import torch
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels.actuation import ops
    cfg = GridConfig(res=38)
    cluster_kernel = fused_case(dev, cfg, 4, 50)[0]
    (ca, co) = cluster_kernel()
    size = ops.fused_interval_cuda.last_cluster
    global_kernel = fused_case(dev, cfg, 4, 50, cluster=size,
                               force_global=True)[0]
    (ga, go) = global_kernel()
    if (ops.fused_interval_cuda.last_kernel != "global"
            or ops.fused_interval_cuda.last_cluster != size):
        fail(f"the forced fused kernel at res 38 ran "
             f"{ops.fused_interval_cuda.last_plan}: expected the "
             f"global-memory kernel at G {size}")
    torch.cuda.synchronize()
    pairs = dict(zip("uvp", zip(ca, ga)), cd=(co.cd, go.cd),
                 cl=(co.cl, go.cl))
    errs = {k: float((x - y).abs().max()) for k, (x, y) in pairs.items()}
    equal = all(torch.equal(x, y) for x, y in pairs.values())
    cluster_ms, global_ms = cuda_ms(cluster_kernel, 3), cuda_ms(global_kernel,
                                                                3)
    print(f"[kernels] fused_interval res 38 N=4 50 dt, global-memory kernel "
          f"at G {size} beside the cluster kernel of {size} blocks: "
          f"bit-equal {equal}, max|global - cluster| " + ", ".join(
              f"{k} {v:.3e} (tol {TOL_FUSED[k]:.0e})" for k, v in errs.items())
          + f"; global {global_ms:.4f} ms, cluster {cluster_ms:.4f} ms")
    if not all(v <= TOL_FUSED[k] for k, v in errs.items()):
        fail(f"the fused global-memory kernel at res 38 differs from the "
             f"cluster kernel: {errs}")
    return {"res": 38, "group": size, "bit_equal": equal,
            "max_abs_err": max(errs.values()), "errors": errs,
            "ms": global_ms, "cluster_ms": cluster_ms}


def sor_beside_cluster(dev, full):
    """On res 70, which both SOR slab kernels serve (two slabs): the
    global-memory kernel, forced at the cluster kernel's size, against
    the cluster kernel on one input (4 grids, 13 rounds, a launch each):
    bit for bit, since a half-sweep's arithmetic on a row is the same in
    both; each timed."""
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels.poisson import ops
    name, _, _, _, _ = SOR_KERNELS[full]
    wrapper = sor_wrapper(full)
    cfg = GridConfig(res=70)
    nslabs = ops._pick_nslabs(cfg.nx)
    solve = sor_case(dev, cfg, 4, 50, full=full)[0]
    a = solve()
    if wrapper.last_kernel != "cluster":
        fail(f"{name} at res 70 ran the {wrapper.last_kernel} kernel: "
             f"expected the cluster kernel")
    size = wrapper.last_cluster
    b = solve(cluster=size, force_global=True)
    if wrapper.last_kernel != "global" or wrapper.last_cluster != size:
        fail(f"the forced {name} at res 70 ran {wrapper.last_plan}: "
             f"expected the global-memory kernel at G {size}")
    equal, err = outputs_equal(a, b)
    cluster_ms = cuda_ms(solve, 5)
    global_ms = cuda_ms(lambda: solve(cluster=size, force_global=True), 5)
    print(f"[kernels] {name} res 70 ({nslabs} slabs) N=4, 13 rounds: "
          f"global-memory kernel at G {size} beside the cluster kernel of "
          f"{size} blocks: bit-equal {equal} (max diff {err:.3e}); global "
          f"{global_ms:.4f} ms, cluster {cluster_ms:.4f} ms a solve")
    if not equal:
        fail(f"the {name} global-memory kernel at res 70 differs from the "
             f"cluster kernel by {err:.3e}")
    return {"res": 70, "group": size, "bit_equal": equal,
            "max_abs_err": err, "ms": global_ms, "cluster_ms": cluster_ms}


def sync_floor(dev):
    """The synchronisation floor of the CFD kernels' chains at the res-48
    interval's shape (kernels/sync_probe.py: G 32, 6100 phases, rows of
    528 floats, 544 threads): us a phase through L2 flags (the
    global-memory kernels' handoff), L2 rows by flags and tagged L2 rows
    (the resident kernels' at a cluster edge) and DSMEM (the cluster
    kernels', two chains of 16)."""
    from repro_torch.kernels.sync_probe import HANDOFFS, MODES, sync_probe
    out = {}
    for mode in MODES:
        out[mode] = 1e3 * cuda_ms(sync_probe(mode, dev), 5) / HANDOFFS
    print(f"[kernels] us a synchronisation, floor ({HANDOFFS} neighbour "
          f"handoffs, G 32, no arithmetic): " + ", ".join(
              f"{m} {us:.4f}" for m, us in out.items()))
    return out


# dt on the finest grids run here: explicit Euler diffusion is stable for
# dt <= Re h^2 / 4 (h the cell size), 4.96e-3 at res 71, 2.77e-3 at res 95
# and 2.72e-3 at res 96 at Re 100, below the default 5e-3; halved and cut
# to 2.5e-3 and 2e-3
FINE_DT = {71: 0.0025, 95: 0.0025, 96: 0.002}


# the two SOR slab kernels: (name, library, source, the TPU kernel it
# replaces, the solve that drives it), by whether it takes the full grid
SOR_KERNELS = {
    False: ("rb_sor_slabs_packed", "poisson_sor",
            "src/repro_torch/kernels/csrc/poisson_sor.cu",
            "src/repro/kernels/poisson/kernel.py:106", "rb_sor_planes"),
    True: ("rb_sor_slabs", "poisson_sor_full",
           "src/repro_torch/kernels/csrc/poisson_sor_full.cu",
           "src/repro/kernels/poisson/kernel.py:37", "rb_sor(packed=False)")}


def sor_wrapper(full):
    from repro_torch.kernels.poisson import ops
    return ops.rb_sor_slabs_cuda if full else ops.rb_sor_slabs_packed_cuda


def sor_case(dev, cfg, n_env, iters, seed=1, full=False):
    """Random inputs of ``n_env`` res-``cfg.res`` grids at the reference's
    slab count and the two realizations of a solve of ``iters`` iterations
    on them, each a tuple of tensors: on packed planes, or (``full``) on
    the grid from a warm start.  ``kernel(iters, **pin)`` makes the slab
    wrapper's calls of an ``rb_sor_planes`` / ``rb_sor(packed=False)``
    solve (one call of every round on one slab, a call a round on
    several), passing ``pin``, the wrapper's ``cluster`` and
    ``force_global``; ``plain()`` runs the plain twin's rounds."""
    import numpy as np
    import torch
    from repro_torch.kernels.poisson import ops
    rng = np.random.default_rng(seed)
    nslabs = ops._pick_nslabs(cfg.nx)
    kw = dict(dx=cfg.dx, dy=cfg.dy, omega=cfg.poisson_omega, nslabs=nslabs,
              inner_iters=4)
    if full:
        # (p0, rhs): a warm start and its right-hand side
        rhs, p0 = (torch.tensor(s * rng.standard_normal((n_env, cfg.ny,
                                                         cfg.nx)),
                                dtype=torch.float32, device=dev)
                   for s in (1.0, 0.1))
        state, fixed = (p0,), (rhs,)
    else:
        planes = [torch.tensor(rng.standard_normal((n_env, cfg.ny,
                                                    cfg.nx // 2)),
                               dtype=torch.float32, device=dev)
                  for _ in range(4)]
        state, fixed = tuple(planes[:2]), tuple(planes[2:])
    wrapper = sor_wrapper(full)
    plain_step = ops.rb_sor_slabs_plain if full else \
        ops.rb_sor_slabs_packed_plain

    def kernel(iters=iters, **pin):
        rounds, out = -(-iters // 4), state
        for _ in range(1 if nslabs == 1 else rounds):
            out = wrapper(*out, *fixed, rounds=rounds if nslabs == 1 else 1,
                          **kw, **pin)
            out = (out,) if full else out
        return out

    def plain():
        out = state
        for _ in range(-(-iters // 4)):
            out = plain_step(*out, *fixed, **kw)
            out = (out,) if full else out
        return out

    return kernel, plain


def sor_error(kernel, plain):
    import torch
    ka, pa = kernel(), plain()
    torch.cuda.synchronize()
    return max(float((x - y).abs().max()) for x, y in zip(ka, pa))


def sor_launch(full):
    """(cluster size, blocks, distinct SMs) of a slab wrapper's last
    launch, as the launch recorded them."""
    fn = sor_wrapper(full)
    return (fn.last_cluster, *blocks_ran(fn.last_block_sms))


def check_sor(dev, cfg, n_env, iters, full=False, wrong=None):
    """An SOR slab kernel (``full``: the full-grid one) against its twin:
    one launch per one-slab solve over more than one block per grid, its
    time, its time per half-sweep, the res-18 grid held, and the planted
    stale halo (the library ``wrong``) rejected."""
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels.poisson import ops
    name, lib, source, replaces, solve = SOR_KERNELS[full]
    wrapper = sor_wrapper(full)
    ny, nx = cfg.ny, cfg.nx
    inner, rounds = 4, -(-iters // 4)
    kernel, plain = sor_case(dev, cfg, n_env, iters, 2 if full else 1, full)
    n0 = wrapper.launches
    err = sor_error(kernel, plain)
    per_solve = wrapper.launches - n0
    cluster, blocks, sms_busy = sor_launch(full)
    print(f"[kernels] {name} res {cfg.res} N={n_env} {solve} at iters="
          f"{iters} = {rounds} rounds x {inner} pairs in {per_solve} "
          f"launch(es): max|kernel - plain| {err:.3e} (tol {TOL_SOR:.0e})")
    if not err <= TOL_SOR:
        fail(f"{name} differs from its twin by {err:.3e}")
    if per_solve != 1 or blocks <= n_env:
        fail(f"{solve} took {per_solve} launches of {blocks} blocks for "
             f"{n_env} grids: expected 1, over more than {n_env} blocks")
    ms = cuda_ms(kernel, 20)
    paced_ms = host_paced_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    # a half-sweep's time: the solve at iters and at 10 (3 rounds), the
    # difference over the rounds' half-sweeps
    few_ms = cuda_ms(lambda: kernel(10), 20)
    sweep_us = 1e3 * (ms - few_ms) / (2 * inner * (rounds - 3))
    active = ops.active_clusters(dev, ny, nx // 2, cluster, full)
    flops, nbytes = ops.work(n_env, ny, nx, iters, inner)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    print(f"[kernels] {name}: solve {ms:.4f} ms (1 launch; {paced_ms:.4f} "
          f"ms a call when the host paces the calls), plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.4f} MB); clusters of "
          f"{cluster} blocks, {blocks} blocks ran on {sms_busy} distinct SMs "
          f"({active} such clusters resident at once); at iters=10 "
          f"{few_ms:.4f} ms, so {sweep_us:.4f} us per half-sweep")
    res18 = GridConfig(res=18)
    err18 = sor_error(*sor_case(dev, res18, n_env, iters, 4 if full else 3,
                                full))
    c18 = sor_launch(full)[0]
    print(f"[kernels] {name} res 18 N={n_env} (grid ({res18.ny}, "
          f"{res18.nx}), over one block's shared memory) in clusters of "
          f"{c18}: max|kernel - plain| {err18:.3e} (tol {TOL_SOR:.0e})")
    if not err18 <= TOL_SOR:
        fail(f"{name} at res 18 differs from its twin by {err18:.3e}")
    stale = None
    if wrong is not None:
        with library_swapped(lib, wrong):
            stale = sor_error(kernel, plain)
        print(f"[kernels] wrong kernel, SOR halo rows stale (planted), "
              f"res {cfg.res} N={n_env}: max|kernel - plain| {stale:.3e} "
              f"(tol {TOL_SOR:.0e}; the right kernel {err:.3e})")
        if stale <= TOL_SOR:
            fail(f"TOL_SOR cannot tell a {name} kernel whose halo rows are "
                 f"stale from a right one")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "library": "no single PyTorch call computes this",
            "host_paced_ms": paced_ms,
            "launches_per_solve": per_solve, "cluster": cluster,
            "blocks": blocks, "sms_busy": sms_busy, "active_clusters": active,
            "ms_at_iters_10": few_ms, "half_sweep_us": sweep_us,
            "res_18_max_abs_err": err18, "res_18_cluster": c18,
            "stale_halo_variant_max_abs_err": stale,
            "shape": f"one {solve} solve: res {cfg.res}, grid ({ny}, {nx}), "
                     f"{n_env} grids, {rounds} rounds"}


def flash_measures(out, ref):
    """(rel-RMS, worst row, max abs) of out against ref, (B, S, H, dh)."""
    d = (out.float() - ref.float()).abs()
    row = d.amax(-1) / ref.float().abs().amax(-1).clamp_min(1e-30)
    return rel_rms(out, ref), float(row.max()), float(d.max())


def flash_held(what, measures, dtype):
    """Print the measures against their limits (TOL_FLASH[dtype], or
    TOL_FLASH_TILED[d] for dtype "tiled d"); False if one is over."""
    rel, row, err = measures
    tol_rel, tol_row = (TOL_FLASH_TILED[dtype.split()[1]]
                        if dtype.startswith("tiled") else TOL_FLASH[dtype])
    print(f"[kernels] flash_attention {what}: rel-RMS {rel:.3e} (tol "
          f"{tol_rel:.0e}), worst row {row:.3e} (tol {tol_row:.0e}), "
          f"max abs {err:.3e}")
    return rel <= tol_rel and row <= tol_row


def flash_case(dev, B, S, H, Hkv, dh, window, seed, dtype="bfloat16"):
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.standard_normal((B, S, h, dh)),
                            dtype=torch.float32, device=dev
                            ).to(getattr(torch, dtype)) for h in (H, Hkv, Hkv))

    def kernel():
        return ops.flash_attention_cuda(q, k, v, causal=True,
                                        sliding_window=window)

    def plain():
        return ops.flash_attention_plain(q, k, v, causal=True,
                                         sliding_window=window)

    ref = plain()
    measures = flash_measures(kernel(), ref)
    if not flash_held(f"{dtype} B={B} S={S} H={H} Hkv={Hkv} dh={dh} causal "
                      f"window={window}, kernel vs plain", measures, dtype):
        fail("flash_attention differs from its twin")
    return measures, (q, k, v), kernel, plain, ref


def flash_wrong_kernels(q, k, v, refs):
    """The held measures must reject two wrong kernels at the path's shape:
    one that maps the query heads to the wrong KV head, one that masks out
    the diagonal key; against each (limits, reference) of ``refs``."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    S = q.shape[1]
    nodiag = ops.causal_mask(S, S, device=q.device) & ~torch.eye(
        S, dtype=torch.bool, device=q.device)[None]
    for what, out in (
            ("KV heads mismapped", ops.flash_attention_plain(
                q, k.roll(1, 2), v.roll(1, 2))),
            ("diagonal key dropped", ops.gqa_attend(q, k, v, nodiag))):
        for limits, ref in refs:
            if flash_held(f"wrong kernel, {what}, vs {limits}",
                          flash_measures(out, ref), limits):
                fail(f"the flash_attention check cannot tell a kernel with "
                     f"the {what} from a right one")


@functools.lru_cache(maxsize=None)
def sass_functions(lib):
    """The SASS of a built library by function: {mangled name: text}."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass {lib} exited {sass.returncode}: "
             f"{sass.stderr.strip()}")
    parts = re.split(r"Function : (\S+)", sass.stdout)
    return dict(zip(parts[1::2], parts[2::2]))


def sass_count(lib, op, function=""):
    """How many ``op`` instructions the SASS of a built library holds (in
    the functions whose mangled name holds ``function``, if given)."""
    return sum(len(re.findall(rf"\b{op}\b", body))
               for name, body in sass_functions(lib).items()
               if function in name)


def sass_profile(lib, function):
    """The SASS of the functions of a built library whose mangled name
    holds ``function``: {name: {opcode: count, "total": instructions}},
    each opcode without its modifiers (LDS, STS, LD, ST, LDG, ...), and
    the registers, stack and local bytes ``cuobjdump -res-usage`` reads
    for it."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(cuobjdump), "-res-usage", str(lib)],
                         capture_output=True, text=True, timeout=120)
    usage = {m[0]: {"REG": int(m[1]), "STACK": int(m[2]),
                    "LOCAL": int(m[3])}
             for m in re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+)"
                                 r" SHARED:\d+ LOCAL:(\d+)", res.stdout)}
    out = {}
    for name, body in sass_functions(lib).items():
        if function not in name:
            continue
        ops = collections.Counter(
            op.split(".")[0] for op in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
                body))
        out[name] = {"total": sum(ops.values()), **usage.get(name, {}),
                     **dict(sorted(ops.items()))}
    return out


def check_flash(dev, cfg, S):
    """The flash kernels at the path's shape (phi4-mini): HGMMA in the
    library's SASS; a small sliding-window case and a head dim of 96
    (padded to 128), held only; the float32 CUDA-core kernel and the bf16
    tensor-core kernel, the latter against its twin, the tile-exact oracle
    and the wrong variants, each timed beside SDPA and its bound."""
    from repro_torch.kernels import build
    hgmma = sass_count(build.library_path("flash_attention"), "HGMMA")
    print(f"[kernels] flash_attention: {hgmma} HGMMA instructions in the "
          f"SASS of {build.library_path('flash_attention').name}")
    if hgmma == 0:
        fail("the flash_attention library holds no HGMMA instruction: the "
             "bf16 kernel is not on the tensor cores")
    small = flash_case(dev, 2, 256, 4, 2, 64, 96, 3)[0]
    padded = flash_case(dev, 1, 1024, 8, 2, 96, 0, 6)[0]
    shape = (1, S, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    fp32 = flash_timed(dev, *shape, 4, "float32", 3)
    out = flash_timed(dev, *shape, 4, "bfloat16", 20, tiled=True)
    out.update(
        name="flash_attention", route="cuda (wgmma, TMA)",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:20",
        hgmma_in_sass=hgmma,
        held_by={"small_window_rel_rms": small[0],
                 "bf16_dh_96_rel_rms": padded[0],
                 "bf16_dh_96_worst_row": padded[1]},
        fp32_kernel={"route": "cuda (CUDA cores)", **fp32},
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True), timed only",
        shape=f"{cfg.name}: {out['shape']}")
    return out


# Gemma 2's attention (arXiv:2408.00118): 16 query heads over 8 KV heads of
# 256, the flash kernels' widest head; B 1, S 4096, causal
GEMMA2_ATTENTION = dict(B=1, S=4096, H=16, Hkv=8, dh=256)


def check_flash_wide(dev):
    """The flash kernels at dh 256 (the tensor-core kernel's
    split-consumer layout, the float32 kernel's one K/V buffer): Gemma 2's
    shape in bf16 against the plain twin, the tile-exact oracle and the
    wrong variants, timed beside SDPA and its bound; the float32 kernel
    there; a head of 160 zero-padded to 256 (held only)."""
    g = GEMMA2_ATTENTION
    shape = (g["B"], g["S"], g["H"], g["Hkv"], g["dh"])
    padded = flash_case(dev, 1, 1024, 8, 2, 160, 0, 11)[0]
    fp32 = flash_timed(dev, *shape, 12, "float32", 3)
    out = flash_timed(dev, *shape, 13, "bfloat16", 20, tiled=True)
    out["held_by"] = {"bf16_dh_160_rel_rms": padded[0],
                      "bf16_dh_160_worst_row": padded[1]}
    out["fp32_kernel"] = {"route": "cuda (CUDA cores)", **fp32}
    out["shape"] = f"Gemma 2's attention: {out['shape']}"
    return out


def wkv6_case(dev, cfg, S, B=1, seed=5, N=None, chunk=None,
              dtype="bfloat16"):
    """rwkv6 inputs at a layer's shape and decays (or at a head of ``N``),
    in ``dtype`` (the decays float32, cast by the wrapper), zero state, and
    the two realizations of a WKV6 call on them (the kernel at ``chunk``
    tokens a chunk, by default its own)."""
    import numpy as np
    import torch
    from repro_torch.kernels.rwkv6 import ops
    H, N = cfg.num_heads, N or cfg.ssm.head_dim
    rng = np.random.default_rng(seed)

    def t(a, dt=getattr(torch, dtype)):
        return torch.tensor(a, dtype=torch.float32, device=dev).to(dt)

    r, k, v = (t(rng.standard_normal((B, S, H, N))) for _ in range(3))
    # the layer's decays: exp(-exp(w0 + d)), w0 = -6 (models/ssm.py)
    w = t(np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal((B, S, H, N)))),
          torch.float32)
    u = t(0.1 * rng.standard_normal((H, N)))
    s0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=dev)
    inputs = (r, k, v, w, u, s0)

    def kernel():
        return ops.wkv6_cuda(*inputs, chunk=chunk or ops.CHUNK)

    def plain():
        return ops.wkv6_plain(*inputs)

    return inputs, kernel, plain


def wkv6_errors(what, kernel, plain):
    """max |kernel - twin| of the output and the state, each over its
    scale, printed beside TOL_WKV_OUT[the output's dtype] and
    TOL_WKV_STATE; fails if one is over.  Returns (out error, its scale,
    state error, its scale)."""
    (ko, ks), (po, ps) = kernel(), plain()
    tol = TOL_WKV_OUT[str(po.dtype).split(".")[-1]]
    scale, s_scale = float(po.float().abs().max()), float(ps.abs().max())
    err = float((ko.float() - po.float()).abs().max())
    s_err = float((ks - ps).abs().max())
    print(f"[kernels] wkv6 {what}: max|kernel - plain| out {err:.3e} (of "
          f"max |out| {scale:.3e}, tol {tol:.1e} of it), state "
          f"{s_err:.3e} (of {s_scale:.3e}, tol {TOL_WKV_STATE:.0e} of it)")
    if not (err <= tol * scale and s_err <= TOL_WKV_STATE * s_scale):
        fail(f"wkv6 {what} differs from its twin: out {err:.3e}, state "
             f"{s_err:.3e}")
    return err, scale, s_err, s_scale


def check_wkv6(dev, cfg, S):
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import ops
    hmma = sass_count(build.library_path("wkv6"), "HMMA")
    print(f"[kernels] wkv6: {hmma} HMMA instructions in the SASS of "
          f"{build.library_path('wkv6').name}")
    if hmma == 0:
        fail("the wkv6 library holds no HMMA instruction: its products are "
             "not on the tensor cores")
    B, H, N = 1, cfg.num_heads, cfg.ssm.head_dim
    # a head the kernel is not built for, zero-padded to 48 by the wrapper,
    # and a chunk of 64 asked for, run at 32 (held only)
    padded = wkv6_errors(f"bf16 B=1 S=1024 H={H} N=40 chunk 64",
                         *wkv6_case(dev, cfg, 1024, N=40, chunk=64)[1:])
    inputs, kernel, plain = wkv6_case(dev, cfg, S, B)
    err, _, s_err, _ = wkv6_errors(f"bf16 B={B} S={S} H={H} N={N}", kernel,
                                   plain)
    blocks, sms_busy = blocks_ran(ops.wkv6_cuda.last_block_sms)
    if blocks <= B * H or blocks != ops.grid_blocks(B, H, N):
        fail(f"wkv6's state pass ran {blocks} blocks: expected "
             f"{ops.grid_blocks(B, H, N)}, more than B*H = {B * H}")
    ms = cuda_ms(kernel, 10)
    call = ops.prepare(*inputs)
    chunk_ms = cuda_ms(lambda: ops.chunk_pass(call), 10)
    state_ms = cuda_ms(lambda: ops.state_pass(call), 10)
    plain_ms = cuda_ms(plain, 1)
    C = ops.pick_chunk(S)
    products, elementwise = ops.flops_by_unit(B, S, H, N, C)
    # the products run as three TF32 products on the tensor cores
    # (3xTF32), the rest on the CUDA cores
    nbytes = ops.work(B, S, H, N, C, inputs[0].element_size())[1]
    bound_ms, bound_by = bound(nbytes, (3 * products, TF32_PEAK),
                               (elementwise, FP32_PEAK))
    print(f"[kernels] wkv6: kernel {ms:.4f} ms (chunk pass {chunk_ms:.4f} "
          f"ms, state pass {state_ms:.4f} ms, {1e3 * state_ms / (S // C):.3f}"
          f" us a link of its chain of {S // C} chunks), plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{products / 1e9:.4f} GFLOP of products, x3 in TF32, "
          f"{elementwise / 1e9:.4f} GFLOP fp32 elementwise, "
          f"{nbytes / 1e6:.4f} MB); a chunk pass of {B * H * (S // C)} "
          f"blocks, then a state pass whose launch recorded {blocks} blocks "
          f"on {sms_busy} distinct SMs (B*H = {B * H}, "
          f"{N // ops.COLUMNS_PER_BLOCK} groups of {ops.COLUMNS_PER_BLOCK} "
          f"state columns a head)")
    return {"name": "wkv6", "route": "cuda (mma.sync 3xTF32)",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:27",
            "max_abs_err": err, "state_max_abs_err": s_err,
            "n_40_chunk_64_errors": {"out": padded[0],
                                     "state": padded[2]}, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library": "no single PyTorch call computes this",
            "chunk_pass_ms": chunk_ms, "state_pass_ms": state_ms,
            "state_pass_blocks": blocks, "state_pass_sms_busy": sms_busy,
            "hmma_in_sass": hmma,
            "shape": f"{cfg.name}: bf16, B={B}, S={S}, H={H}, N={N}, "
                     f"chunk {C}; launches count both passes"}


# the rwkv6-3b width (2560) at WKV6 heads of 256 and 512, the kernel's
# cluster passes (clusters of 4 and 8 blocks)
WKV6_WIDE = (256, 512)


def rwkv_at_head(cfg, N, layers=None):
    """rwkv6-3b's config at WKV6 heads of ``N`` (width kept: H = d_model /
    N), cut to ``layers`` layers if given."""
    H = cfg.d_model // N
    changes = dict(head_dim=N, num_heads=H, num_kv_heads=H,
                   ssm=dataclasses.replace(cfg.ssm, head_dim=N))
    if layers:
        changes["num_layers"] = layers
    return dataclasses.replace(cfg, name=f"{cfg.name}-n{N}", **changes)


def check_wkv6_wide(dev, cfg, S):
    """WKV6's cluster passes at rwkv6-3b's width, heads of 256 and 512
    (wkv6_timed: held against the twin, each pass timed, the state pass's
    blocks and SMs, the bound); a head of 200 zero-padded to 208 (held
    only)."""
    wkv6_errors("bf16 B=1 S=1024 H=2 N=200 (padded to 208)",
                *wkv6_case(dev, dataclasses.replace(cfg, num_heads=2),
                           1024, N=200)[1:])
    return {f"n_{N}": wkv6_timed(dev, rwkv_at_head(cfg, N), S, N, "bfloat16")
            for N in WKV6_WIDE}


def sdpa_kernels(fn):
    """The names of the CUDA kernels one call of ``fn`` runs (the backend
    scaled_dot_product_attention picked), by device time, longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = sorted((e for e in prof.key_averages() if device_us(e) > 0),
                    key=device_us, reverse=True)
    return [e.key[:80] for e in events[:3]]


def flash_timed(dev, B, S, H, Hkv, dh, seed, dtype, reps, tiled=False):
    """The flash kernel of ``dtype`` at one shape: held against its twin
    (and, ``tiled``, against the tile-exact oracle and the wrong
    variants), timed beside its twin and SDPA at the same shape and dtype,
    past dh 256 SDPA's kernels named (up to 256 its flash or cuDNN
    backend); the bound counts the reference's work once
    (4 dh a visible pair and head) and the bytes of q, k, v and out.  Past
    dh 256 the column-split kernel repeats the QK^T half of that work once
    per further column group: stated beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    measures, (q, k, v), kernel, plain, ref = flash_case(
        dev, B, S, H, Hkv, dh, 0, seed, dtype)
    out = {"max_abs_err": measures[2], "rel_rms": measures[0],
           "worst_row": measures[1]}
    if tiled:
        oracle = ops.flash_attention_tiled(q, k, v, causal=True)
        exact = flash_measures(kernel(), oracle)
        if not flash_held(f"{dtype} B={B} S={S} H={H} Hkv={Hkv} dh={dh} "
                          f"causal, kernel vs tiled", exact, f"tiled {dtype}"):
            fail(f"flash_attention {dtype} dh {dh} differs from the "
                 f"tile-exact oracle")
        flash_wrong_kernels(q, k, v, ((dtype, ref), (f"tiled {dtype}",
                                                     oracle)))
        out.update(vs_tiled_rel_rms=exact[0], vs_tiled_worst_row=exact[1])
        del oracle
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    out["ms"] = cuda_ms(kernel, reps)
    out["plain_ms"] = cuda_ms(plain, 1, warm=False)   # flash_case ran it
    out["library_ms"] = cuda_ms(sdpa, reps)
    if dh > ops.KERNEL_DH[-1]:
        out["library_kernels"] = sdpa_kernels(sdpa)
    d = ops.kernel_head_dim(dh)
    groups = ops.column_groups(d, q.dtype)
    flops, nbytes = ops.work(B, S, H, Hkv, dh, q.element_size())
    peak = FP32_PEAK if dtype == "float32" else BF16_PEAK
    out["bound_ms"], out["bound_by"] = bound(nbytes, (flops, peak))
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["tflops"] = flops / out["ms"] / 1e9
    out["column_groups"] = groups
    out["recompute_flops"] = flops / 2 * (groups - 1) * d / dh
    out["shape"] = (f"{dtype}, B={B}, S={S}, H={H}, Hkv={Hkv}, dh={dh} "
                    f"(kernel head dim {d}, {groups} column group(s)), "
                    f"causal")
    print(f"[kernels] flash_attention {dtype} dh {dh} (H {H} over {Hkv}): "
          f"kernel {out['ms']:.4f} ms ({out['tflops']:.1f} TFLOP/s, "
          f"{out['bound_share']:.3f} of the bound), plain twin "
          f"{out['plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention {out['library_ms']:.4f} ms "
          f"(kernels {out.get('library_kernels', 'not named')}), bound "
          f"{out['bound_ms']:.5f} ms ({out['bound_by']}: {flops / 1e9:.3f} "
          f"GFLOP, {nbytes / 1e6:.4f} MB; the {groups} column groups repeat "
          f"{out['recompute_flops'] / 1e9:.3f} GFLOP of QK^T beside it)")
    del q, k, v, qt, kt, vt, kernel, plain, ref
    torch.cuda.empty_cache()
    return out


def check_flash_f16(dev, cfg):
    """The float16 instantiation of the tensor-core kernel: HGMMA in its
    SASS (the split and the column-split kernels), then at phi4-mini's
    shape (dh 128) and Gemma 2's (dh 256) against its twin, the tile-exact
    oracle and the wrong variants, timed beside SDPA in float16."""
    from repro_torch.kernels import build
    lib = build.library_path("flash_attention")
    hgmma = {name: sass_count(lib, "HGMMA", f"{name}I6__half")
             for name in ("flash_attention_tc_kernel",
                          "flash_attention_tc_wide_kernel")}
    print(f"[kernels] flash_attention float16: HGMMA instructions in the "
          f"SASS of its instantiations {hgmma}")
    if not all(hgmma.values()):
        fail("a float16 flash instantiation holds no HGMMA instruction")
    g = GEMMA2_ATTENTION
    out = {"hgmma_in_sass": hgmma}
    for dh, (H, Hkv) in ((cfg.resolved_head_dim,
                          (cfg.num_heads, cfg.num_kv_heads)),
                         (g["dh"], (g["H"], g["Hkv"]))):
        out[f"dh_{dh}"] = flash_timed(dev, 1, 4096, H, Hkv, dh, 20 + dh,
                                      "float16", 20, tiled=True)
    return out


# past dh 256: (dh, H, Hkv) at B 1, S 4096: a 2560 width in heads of 320
# over 2 KV heads, phi4-mini's 3072 in heads of 512
FLASH_COLUMN_SPLIT = ((320, 8, 2), (512, 6, 2))


def check_flash_column_split(dev):
    """The column-split kernels, bf16 (tensor cores, groups of 256 columns)
    and float32 (CUDA cores, groups of 128), at dh 320 and 512: held
    against the twin (bf16 also the oracle and the wrong variants), timed
    beside SDPA at the same shape and dtype."""
    out = {}
    for dh, H, Hkv in FLASH_COLUMN_SPLIT:
        out[f"dh_{dh}"] = {
            dtype: flash_timed(dev, 1, 4096, H, Hkv, dh, 40 + dh, dtype,
                               10 if dtype == "bfloat16" else 2,
                               tiled=dtype == "bfloat16")
            for dtype in ("bfloat16", "float32")}
    return out


def wkv6_timed(dev, cfg, S, N, dtype):
    """One WKV6 call at rwkv6-3b's S and a head of ``N`` (``cfg``'s heads)
    in ``dtype``: held against its twin, its blocks checked against the
    launch's record, timed with each of its passes, beside its twin and
    its bound."""
    import torch
    from repro_torch.kernels.rwkv6 import ops
    H = cfg.num_heads
    inputs, kernel, plain = wkv6_case(dev, cfg, S, N=N, dtype=dtype)
    err, _, s_err, _ = wkv6_errors(f"{dtype} B=1 S={S} H={H} N={N}", kernel,
                                   plain)
    blocks, sms_busy = blocks_ran(ops.wkv6_cuda.last_block_sms)
    if blocks != ops.grid_blocks(1, H, N):
        fail(f"wkv6 N {N}: the state pass ran {blocks} blocks, expected "
             f"{ops.grid_blocks(1, H, N)}")
    ms = cuda_ms(kernel, 5)
    call = ops.prepare(*inputs)
    passes = {"chunk_pass_ms": cuda_ms(lambda: ops.chunk_pass(call), 5),
              "state_pass_ms": cuda_ms(lambda: ops.state_pass(call), 5)}
    if call.parts is not None:
        passes["add_pass_ms"] = cuda_ms(lambda: ops.add_pass(call), 5)
    plain_ms = cuda_ms(plain, 1, warm=False)   # wkv6_errors ran it
    C = ops.pick_chunk(S)
    nc, g = ops.head_split(ops.kernel_head_size(N))
    products, elementwise = ops.flops_by_unit(1, S, H, N, C)
    nbytes = ops.work(1, S, H, N, C, inputs[0].element_size())[1]
    bound_ms, bound_by = bound(nbytes, (3 * products, TF32_PEAK),
                               (elementwise, FP32_PEAK))
    print(f"[kernels] wkv6 {dtype} N {N} (H {H}, {nc} cluster(s) of {g} "
          f"a problem): kernel {ms:.4f} ms ({passes}), plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{products / 1e9:.4f} GFLOP of products, x3 in TF32, "
          f"{elementwise / 1e9:.4f} GFLOP fp32 elementwise, "
          f"{nbytes / 1e6:.4f} MB); the state pass's launch recorded "
          f"{blocks} blocks on {sms_busy} distinct SMs")
    del inputs, kernel, plain, call
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "max_abs_err": err,
            "state_max_abs_err": s_err, **passes, "state_pass_blocks": blocks,
            "state_pass_sms_busy": sms_busy, "clusters": nc, "cluster": g,
            "shape": f"{dtype}, B=1, S={S}, H={H}, N={N}, chunk {C}"}


# past a head of 1024: (N, H) at S 4096, bf16
WKV6_PAST_1024 = ((1088, 2), (2560, 1))


def check_wkv6_f16_and_past_1024(dev, cfg, S):
    """WKV6's float16 instantiation at rwkv6-3b's width in heads of 64 and
    512; then, bf16, heads of 1088 and 2560 on several clusters a problem
    (the add of their parts a third launch)."""
    out = {"float16": {}, "past_1024": {}}
    for N in (64, 512):
        out["float16"][f"n_{N}"] = wkv6_timed(
            dev, rwkv_at_head(cfg, N), S, N, "float16")
    for N, H in WKV6_PAST_1024:
        out["past_1024"][f"n_{N}"] = wkv6_timed(
            dev, dataclasses.replace(cfg, num_heads=H), S, N, "bfloat16")
    return out


def odd_grid(res, **kw):
    """A ``GridConfig`` one column narrower (an odd width):
    ``GridConfig(res=n)`` always has an even one."""
    from repro_torch.cfd.grid import GridConfig

    class Odd(GridConfig):
        nx = property(lambda self: 22 * self.res - 1)
    return Odd(res=res, **kw)


# phase 1's odd grid widths, each grid one column narrower than a grid of
# the tier named (GridConfig(res) has an even width): the pallas solve
# ((tier, grid (ny, nx) or res), 4 grids, iters 60) and the fused interval
# ((tier, res, envs), ODD_STEPS dt, the scalar and the per-body
# instantiation)
ODD_SOLVES = (("cluster", (8, 11)), ("resident", 71), ("global", 95))
ODD_INTERVALS = (("cluster", 8, 2), ("resident", 48, 4), ("global", 56, 4))
ODD_STEPS = 10
ODD_SOLVE_ITERS = 60


def odd_report(row, secs):
    """Print an odd-width case's line: its tier, G and C, launches, device
    ms, the share of the bound, the error, the planted fault's reading and
    the case's seconds."""
    plan = row["plan"]
    print(f"[odd width] {row['shape']}: the {plan['kernel']} kernel, G "
          f"{plan['size']} C {plan['cluster']}, {row['launches']} "
          f"launch(es) ({row['blocks']} blocks on {row['sms_busy']} "
          f"distinct SMs), {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} "
          f"ms), bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
          f"{row['bound_ms'] / row['ms']:.4f} of it; max|kernel - plain| "
          f"{row['max_abs_err']:.3e}; planted even row rule: "
          f"{row['odd_ghost_variant']}; {secs:.2f} s")


def odd_launches_as_planned(launched, name, plan, per_body=None):
    """Whether ``launched`` (counts()) holds ``plan``'s launches of the
    wrapper ``name`` on its tier and none of any other kernel."""
    from repro_torch import kernels
    want = {name: plan.launches}
    if plan.kernel != "cluster":
        want[f"{name}_{plan.kernel}"] = plan.launches
    if per_body:
        want["fused_interval_per_body"] = plan.launches
    return ({k: v for k, v in launched.items() if v} == want
            and not sum(kernels.FALLBACKS.values()))


def odd_solve_case(dev, tier, grid, wrong):
    """One odd-width ``poisson.solve(backend="pallas")`` of 4 grids at
    iters 60 (polish 10) from a warm start: one launch of the full-grid
    library's full sweeps on the tier ``tier``, no fallback, within
    TOL_SOR of the reference's full-grid sweep on the card (``backend=
    "full"``), timed; the planted even rule (the library ``wrong``) must
    fall outside TOL_SOR."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.cfd import poisson
    from repro_torch.kernels.poisson import ops
    t0 = time.perf_counter()
    if isinstance(grid, tuple):
        (ny, nx), dx, dy, what = grid, 0.1, 0.1, f"grid {grid}"
    else:
        cfg = odd_grid(grid)
        ny, nx, dx, dy = cfg.ny, cfg.nx, cfg.dx, cfg.dy
        what = f"res {grid} - 1, grid ({ny}, {nx})"
    rng = np.random.default_rng(21)
    rhs, p0 = (torch.tensor(s * rng.standard_normal((4, ny, nx)),
                            dtype=torch.float32, device=dev)
               for s in (1.0, 0.1))
    iters = ODD_SOLVE_ITERS

    def kernel():
        return poisson.solve(rhs, dx, dy, iters=iters, p0=p0,
                             backend="pallas")

    def plain():
        return poisson.solve(rhs, dx, dy, iters=iters, p0=p0,
                             backend="full")

    reset_counts()
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    launched = counts()
    wrapper = ops.full_sweeps_cuda
    plan = wrapper.last_plan
    if plan.kernel != tier or not odd_launches_as_planned(
            launched, "rb_sor_full_sweeps", plan):
        fail(f"the odd-width pallas solve on {what} ran {plan} with "
             f"launches {launched} and fallbacks {dict(kernels.FALLBACKS)}:"
             f" expected the {tier} kernel's full sweeps and no fallback")
    err = float((out - ref).abs().max())
    if not err <= TOL_SOR:
        fail(f"the odd-width pallas solve on {what} differs from the "
             f"reference's full-grid sweep by {err:.3e}")
    with library_swapped("poisson_sor_full", wrong):
        planted = float((kernel() - ref).abs().max())
    if planted <= TOL_SOR:
        fail(f"TOL_SOR cannot tell full sweeps under the even row rule from "
             f"right ones on {what}")
    ms = cuda_ms(kernel, 10)
    plain_ms = cuda_ms(plain, 1)
    flops, nbytes = ops.work(4, ny, nx, iters, 1)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    blocks, sms_busy = blocks_ran(wrapper.last_block_sms)
    row = {"name": "rb_sor_full_sweeps", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/poisson_sor_full.cu",
           "replaces": "src/repro/kernels/poisson/kernel.py:37",
           "launches": launched["rb_sor_full_sweeps"], "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "library": "no single PyTorch call computes this",
           "plan": dataclasses.asdict(plan), "blocks": blocks,
           "sms_busy": sms_busy,
           "odd_ghost_variant": f"max|kernel - plain| {planted:.3e}, "
                                f"rejected (tol {TOL_SOR:.0e})",
           "shape": f"poisson.solve(backend='pallas'), {what}, 4 grids, "
                    f"iters {iters}"}
    odd_report(row, time.perf_counter() - t0)
    row["seconds"] = time.perf_counter() - t0
    return row


def odd_interval_case(dev, tier, res, n_env, case, wrong):
    """One odd-width ``fused_interval_cuda`` call (``case``: fused_case,
    the scalar instantiation, or bank_case, the per-body one) of ODD_STEPS
    dt at res ``res`` one column narrower: its launches on the tier
    ``tier``, within TOL_FUSED of the reference scan on the card, timed;
    with ``wrong`` (the planted even rule) it must fall outside
    TOL_FUSED."""
    from repro_torch import kernels
    from repro_torch.kernels.actuation import ops
    t0 = time.perf_counter()
    cfg = odd_grid(res)
    per_body = case is bank_case
    kernel, plain = case(dev, cfg, n_env, ODD_STEPS)
    what = (f"{'<3>' if per_body else '<0>'} res {res} - 1, grid "
            f"({cfg.ny}, {cfg.nx}), N={n_env}, {ODD_STEPS} dt")
    reset_counts()
    errs = fused_errors(kernel, plain)
    launched = counts()
    plan = ops.fused_interval_cuda.last_plan
    if plan.kernel != tier or not odd_launches_as_planned(
            launched, "fused_interval", plan, per_body):
        fail(f"the odd-width fused interval {what} ran {plan} with launches"
             f" {launched} and fallbacks {dict(kernels.FALLBACKS)}: "
             f"expected the {tier} kernel and no fallback")
    if not fused_report(f"fused_interval odd width {what} against the "
                        f"reference scan", errs):
        fail(f"the odd-width fused interval {what} differs from the "
             f"reference scan: {errs}")
    planted = "not run"
    if wrong is not None:
        with library_swapped("fused_interval", wrong):
            bad = fused_errors(kernel, plain)
        over = max(bad[k] / TOL_FUSED[k] for k in bad)
        if over <= 1:
            fail(f"TOL_FUSED cannot tell a fused interval under the even row"
                 f" rule from a right one on {what}: {bad}")
        planted = (", ".join(f"{k} {v:.3e}" for k, v in bad.items())
                   + f", rejected ({over:.3g}x its limit at most)")
    ms = cuda_ms(kernel, 3)
    plain_ms = cuda_ms(plain, 1)
    if per_body:
        n_geoms = len({BANK_ENVS[i % len(BANK_ENVS)][0]
                       for i in range(n_env)})
        flops, nbytes = ops.work(cfg, n_env, ODD_STEPS, ops.N_BODIES, n_geoms)
    else:
        flops, nbytes = ops.work(cfg, n_env, ODD_STEPS)
    bound_ms, bound_by = bound(nbytes, (flops, FP32_PEAK))
    _, blocks, sms_busy = fused_launch()
    row = {"name": "fused_interval", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/fused_interval.cu",
           "replaces": "src/repro/kernels/actuation/kernel.py:39",
           "launches": launched["fused_interval"],
           "max_abs_err": max(errs.values()), "errors": errs,
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "library": "no single PyTorch call computes this",
           "plan": dataclasses.asdict(plan), "blocks": blocks,
           "sms_busy": sms_busy, "odd_ghost_variant": planted,
           "shape": f"fused_interval_cuda {what}"}
    odd_report(row, time.perf_counter() - t0)
    row["seconds"] = time.perf_counter() - t0
    return row


def odd_widths(dev, wrong):
    """Phase 1: the odd grid widths on the card, each through its entry
    point and on the tier its plan names, none counted as a fallback: the
    pallas solve (ODD_SOLVES) on the full-grid library's full sweeps,
    against the reference's full-grid sweep on the card; the fused
    interval (ODD_INTERVALS) in its scalar and per-body instantiations,
    against the reference scan on the card; the planted even row rule
    (``wrong``: the odd_ghost variants of the two libraries) rejected on
    every case of the scalar ones.  Returns the rows under the full-grid
    SOR's and the fused interval's entries of the kernels line."""
    sweeps = {tier: odd_solve_case(dev, tier, grid,
                                   wrong["poisson_sor_full"])
              for tier, grid in ODD_SOLVES}
    fused = {}
    for tier, res, n_env in ODD_INTERVALS:
        fused[tier] = odd_interval_case(dev, tier, res, n_env, fused_case,
                                        wrong["fused_interval"])
        fused[f"{tier}_per_body"] = odd_interval_case(dev, tier, res, n_env,
                                                      bank_case, None)
    return fused, sweeps


def wrappers():
    """Each kernel's launching wrapper, by kernel name."""
    from repro_torch.kernels.actuation import ops as aops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.poisson import ops as pops
    from repro_torch.kernels.rwkv6 import ops as wops
    return {"fused_interval": aops.fused_interval_cuda,
            "rb_sor_slabs_packed": pops.rb_sor_slabs_packed_cuda,
            "rb_sor_slabs": pops.rb_sor_slabs_cuda,
            "rb_sor_full_sweeps": pops.full_sweeps_cuda,
            "flash_attention": fops.flash_attention_bf16_cuda,
            "flash_attention_f16": fops.flash_attention_f16_cuda,
            "flash_attention_fp32": fops.flash_attention_fp32_cuda,
            "wkv6": wops.wkv6_cuda}


FLASH_WRAPPERS = ("flash_attention", "flash_attention_f16",
                  "flash_attention_fp32")
# the CFD wrappers, each of which launches a cluster, a resident or a
# global-memory kernel
GLOBAL_WRAPPERS = ("fused_interval", "rb_sor_slabs_packed", "rb_sor_slabs",
                   "rb_sor_full_sweeps")


def reset_counts():
    w = wrappers()
    for fn in w.values():
        fn.launches = 0
    w["fused_interval"].launches_per_body = 0
    for name in GLOBAL_WRAPPERS:
        w[name].launches_resident = 0
        w[name].launches_global = 0
    for name in FLASH_WRAPPERS:
        w[name].column_split_launches = 0
    w["wkv6"].launches_by_dtype = dict.fromkeys(
        w["wkv6"].launches_by_dtype, 0)
    w["wkv6"].multi_cluster_launches = 0


def counts():
    """Launches by kernel since reset_counts; and, as views of those, the
    fused kernel's per-body instantiation (``fused_interval_per_body``),
    the CFD wrappers' resident and global-memory kernels
    (``<name>_resident``, ``<name>_global``), the flash
    kernels' column-split launches past dh 256
    (``flash_attention_column_split``), WKV6's float16 launches
    (``wkv6_float16``) and its launches past a head of 1024
    (``wkv6_multi_cluster``)."""
    w = wrappers()
    out = {name: fn.launches for name, fn in w.items()}
    for name in GLOBAL_WRAPPERS:
        out[f"{name}_resident"] = w[name].launches_resident
        out[f"{name}_global"] = w[name].launches_global
    out["fused_interval_per_body"] = w["fused_interval"].launches_per_body
    out["flash_attention_column_split"] = sum(
        w[name].column_split_launches for name in FLASH_WRAPPERS)
    out["wkv6_float16"] = w["wkv6"].launches_by_dtype["float16"]
    out["wkv6_multi_cluster"] = w["wkv6"].multi_cluster_launches
    return out


# the count keys that are views of another kernel's launches
COUNT_VIEWS = ("fused_interval_per_body", "flash_attention_column_split",
               "wkv6_float16", "wkv6_multi_cluster",
               *(f"{name}_{kind}" for name in GLOBAL_WRAPPERS
                 for kind in ("resident", "global")))


def run_train(backend, env_kw, episodes, grid_kw, scenarios=None):
    import numpy as np
    import torch
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.drl.train import TrainConfig, train
    cfg = TrainConfig(env=EnvConfig(grid=GridConfig(**grid_kw), **env_kw),
                      n_envs=4, episodes=episodes, seed=0, backend=backend,
                      scenarios=scenarios, device="cuda")
    tag = backend if scenarios is None else f"{backend} {'+'.join(scenarios)}"
    reset_counts()
    (hist, model), secs = wall(lambda: train(
        cfg, log_fn=lambda s: print(f"[train {tag}] {s}")))
    launched = counts()
    for k, v in hist.items():
        if len(v) != episodes or not np.isfinite(v).all():
            fail(f"train({tag}) history {k} = {v}")
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        fail(f"train({tag}) left non-finite params")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train {tag}] {episodes} episodes in {secs:.3f} s, "
          f"{n_params} params finite (act_dim {model.log_std.numel()}), "
          f"rewards {hist['reward'].tolist()}, episode walls "
          f"{hist['wall'].tolist()}, kernel launches {launched}")
    return launched, hist


def leaves(tree):
    """The tensors of a nested dict of parameters."""
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def rel_rms(a, b):
    """RMS of a - b over the RMS of b."""
    a, b = a.float(), b.float()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def hold_layers(cfg, params, tokens, frontend_embeds=None):
    """The two backends block by block on the reference's hidden states:
    (worst block-update difference, difference of the last block's logits,
    free-running full-depth logits difference, the logits' RMS), each
    relative to the reference's RMS.  A frontend config's embeddings go
    into the decoder's input (a vision prompt's patches) or through the
    encoder, whose output ``enc_out`` every decoder block attends."""
    import torch
    from repro_torch.models import model
    h_ref = model._embed(cfg, params, tokens, frontend_embeds)
    enc_out = (model._run_encoder(cfg, params, frontend_embeds)
               if cfg.is_encdec else None)
    h_free = h_ref
    pos = model._positions(cfg, tokens)
    worst = 0.0
    for bp in model.all_layers(params):
        k = model._block_body(cfg, h_ref, bp, positions=pos, enc_out=enc_out,
                              backend="pallas")[0]
        r = model._block_body(cfg, h_ref, bp, positions=pos, enc_out=enc_out,
                              backend="reference")[0]
        worst = max(worst, rel_rms(k - h_ref, r - h_ref))
        h_free = model._block_body(cfg, h_free, bp, positions=pos,
                                   enc_out=enc_out, backend="pallas")[0]
        h_ref = r
    logits_r = model._unembed(cfg, params, h_ref)
    if not (bool(torch.isfinite(logits_r).all())
            and logits_r.shape == (*tokens.shape, cfg.vocab_padded)):
        fail(f"{cfg.name}: logits {tuple(logits_r.shape)} not finite or "
             f"not {(*tokens.shape, cfg.vocab_padded)}")
    rms = float(logits_r.float().square().mean().sqrt())
    d_last = rel_rms(model._unembed(cfg, params, k), logits_r)
    d_free = rel_rms(model._unembed(cfg, params, h_free), logits_r)
    return worst, d_last, d_free, rms


def frontend_embeds(cfg, S, rng, dev):
    """A frontend config's embeddings for a prompt of S tokens (its frames
    or patches, N(0, 1) float32 from ``rng``), or None."""
    import torch
    from repro_torch.models import frontend
    if not cfg.frontend:
        return None
    return torch.tensor(rng.standard_normal(
        (1, frontend.num_frontend_tokens(cfg, S), frontend.frontend_dim(cfg))),
        dtype=torch.float32, device=dev)


def run_lm(dev, name, S, kernel, per_layer=1, cfg=None, views=()):
    """lm_loss(backend="pallas") of a full-width config at B=1, S tokens
    (a frontend config's embeddings drawn after them): the kernel must
    launch ``per_layer`` times a decoder layer, every one of them counted
    in each of ``views`` too (count keys of COUNT_VIEWS: the instantiation
    the path must run), and no other kernel; logits and loss held against
    backend="reference" on the same params and inputs.  ``cfg`` (a
    registered config with fields replaced) in place of ``name``'s."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    cfg = cfg or get_config(name)
    (params, secs) = wall(lambda: model.init_params(cfg, seed=0,
                                                    device=dev))
    n_params = sum(x.numel() for x in leaves(params))
    rng = np.random.default_rng(7)
    tokens, labels = (torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                                   device=dev) for _ in range(2))
    batch = {"tokens": tokens, "labels": labels}
    fe = frontend_embeds(cfg, S, rng, dev)
    if fe is not None:
        batch["frontend_embeds"] = fe
    extra = "" if fe is None else (
        f", {cfg.encoder_layers} encoder layers" if cfg.is_encdec else "")
    seen = "" if fe is None else (f"; {cfg.frontend} embeddings "
                                  f"{tuple(fe.shape)}")
    print(f"[lm {name}] {cfg.num_layers} layers{extra}, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_padded}, {n_params / 1e9:.3f} B "
          f"params ({cfg.param_dtype}) drawn on the card in {secs:.3f} s; "
          f"B=1, S={S} (train_4k's length, batch cut from 256 to 1){seen}")
    with torch.inference_mode():
        reset_counts()
        (loss, _), secs = wall(lambda: model.lm_loss(cfg, params, batch,
                                                     backend="pallas"))
        launched = counts()
        _, steady = wall(lambda: model.lm_loss(cfg, params, batch,
                                               backend="pallas"))
        print(f"[lm {name}] lm_loss(backend='pallas') = {float(loss):.6f} "
              f"in {secs:.3f} s (first call), {steady:.3f} s (second call, "
              f"steady), kernel launches {launched}")
        if not math.isfinite(float(loss)):
            fail(f"{name}: lm_loss is {float(loss)}")
        others = sum(n for k, n in launched.items()
                     if k != kernel and k not in views)
        want = per_layer * cfg.num_layers
        if (launched[kernel] != want or others
                or any(launched[v] != want for v in views)):
            fail(f"{name}: {launched[kernel]} {kernel} launches in one "
                 f"forward ({ {v: launched[v] for v in views} }), expected "
                 f"{want} (each of them counted in {views}), and {others} of "
                 f"the other kernels, expected 0")
        (ref_loss, _), ref_secs = wall(lambda: model.lm_loss(
            cfg, params, batch, backend="reference"))
        d_loss = abs(float(loss) - float(ref_loss))
        worst, d_last, d_free, rms = hold_layers(cfg, params, tokens, fe)
    print(f"[lm {name}] backend='reference' loss {float(ref_loss):.6f} in "
          f"{ref_secs:.3f} s; pallas vs reference: loss {d_loss:.3e} (tol "
          f"{TOL_LM_LOSS:.0e}); on the reference's input to each layer, the "
          f"block update {worst:.3e} of its RMS at worst, the last block's "
          f"logits {d_last:.3e} of their RMS (tol {TOL_LM_LAYER:.0e}); "
          f"free-running through {cfg.num_layers} layers the logits differ "
          f"by {d_free:.3e} of their RMS {rms:.4f} (reported)")
    if not (d_loss <= TOL_LM_LOSS and worst <= TOL_LM_LAYER
            and d_last <= TOL_LM_LAYER):
        fail(f"{name}: backend 'pallas' disagrees with 'reference'")
    del params
    torch.cuda.empty_cache()
    return launched[kernel], secs, steady


def run_sor_full(dev, cfg, n_env, iters):
    """The drop-in full-grid solve on random right-hand sides: one launch
    per solve (the grid is one slab), a finite result of the grid's shape,
    the residual cut."""
    import numpy as np
    import torch
    from repro_torch.cfd.poisson import residual
    from repro_torch.kernels.poisson import ops
    rng = np.random.default_rng(8)
    rhs = torch.tensor(rng.standard_normal((n_env, cfg.ny, cfg.nx)),
                       dtype=torch.float32, device=dev)
    reset_counts()
    p, secs = wall(lambda: ops.rb_sor(rhs, cfg.dx, cfg.dy, iters=iters,
                                      omega=cfg.poisson_omega,
                                      packed=False))
    launched = counts()["rb_sor_slabs"]
    kernel = ops.rb_sor_slabs_cuda.last_kernel
    if kernel != ops.slab_kernel(cfg.ny, cfg.nx // 2) or (
            kernel != "cluster"
            and counts()[f"rb_sor_slabs_{kernel}"] != launched):
        fail(f"rb_sor(packed=False) at res {cfg.res} ran the {kernel} "
             f"kernel, expected the "
             f"{ops.slab_kernel(cfg.ny, cfg.nx // 2)} one")
    r0 = float(residual(torch.zeros_like(rhs), rhs, cfg.dx, cfg.dy
                        ).abs().max())
    r1 = float(residual(p, rhs, cfg.dx, cfg.dy).abs().max())
    print(f"[rb_sor full] res {cfg.res}, {n_env} grids, iters={iters}: "
          f"{launched} launches of the {kernel} kernel in {secs:.4f} s, max "
          f"residual {r0:.4e} -> {r1:.4e}")
    if ops._pick_nslabs(cfg.nx) != 1 or launched != 1:
        fail(f"rb_sor(packed=False) launched its kernel {launched} times, "
             f"expected 1 on a one-slab grid")
    if not (bool(torch.isfinite(p).all()) and p.shape == rhs.shape
            and r1 < r0):
        fail("rb_sor(packed=False) gave a non-finite, misshapen or "
             "unconverging result")
    return launched


def golden(dev):
    import numpy as np
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.cfd.validation import measure_shedding, run_uncontrolled
    from repro_torch.convert import flow_state_from_numpy
    ref = np.load(ROOT / "tests" / "golden" / "cyl_re100_res8.npz")
    cfg = GridConfig(res=int(ref["res"]), dt=float(ref["dt"]),
                     poisson_iters=int(ref["poisson_iters"]))
    state = flow_state_from_numpy(ref["u"], ref["v"], ref["p"], device=dev)
    reset_counts()
    (_, cds, cls), secs = wall(lambda: run_uncontrolled(
        cfg, state, int(ref["meas_steps"]), backend="fused"))
    launched = counts()
    stats = measure_shedding(cds, cls, cfg.dt)
    print(f"[golden] res 8, {int(ref['meas_steps'])} dt through the fused "
          f"kernel in {secs:.3f} s, launches {launched}")
    if launched["fused_interval"] < 1:
        fail("the golden run did not go through the fused kernel")
    for key, tol in (("strouhal", TOL_ST), ("cd_mean", TOL_CD),
                     ("cl_amp", TOL_AMP)):
        want, got = float(ref[key]), stats[key]
        rel = abs(got - want) / abs(want)
        print(f"[golden] {key}: {got:.6f} vs fixture {want:.6f} "
              f"(rel {rel:.2e}, tol {tol})")
        if not (math.isfinite(got) and rel <= tol):
            fail(f"golden {key} {got} vs {want} outside rel {tol}")


def golden_pinball(dev):
    """The pinball fixture through the card: its 2000-dt window through the
    scalar instantiation (the scalar zero amplitude, as the reference
    measures it) and through the per-body one (a zero (3,) vector at
    act_mode 0, the per-body forces summed), each one launch, each within
    the reference's pinball tolerances."""
    import numpy as np
    import torch
    from repro_torch.cfd import grid, solver
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.cfd.validation import measure_shedding, run_uncontrolled
    from repro_torch.convert import flow_state_from_numpy
    ref = np.load(ROOT / "tests" / "golden" / "pinball_re100_res8.npz")
    cfg = GridConfig(res=int(ref["res"]), dt=float(ref["dt"]),
                     poisson_iters=int(ref["poisson_iters"]))
    state = flow_state_from_numpy(ref["u"], ref["v"], ref["p"], device=dev)
    n = int(ref["meas_steps"])
    ga = solver.geom_to_arrays(grid.build_geometry(cfg, "pinball"), dev)

    def per_body():
        _, outs = solver.step_interval(
            cfg, ga, state, torch.zeros(3, device=dev), n, act_mode=0.0,
            backend="fused")
        return (None, outs.cd.sum(-1).cpu().numpy(),
                outs.cl.sum(-1).cpu().numpy())

    routes = {"scalar": (lambda: run_uncontrolled(
        cfg, state, n, backend="fused", geometry="pinball"), 0),
              "per_body": (per_body, grid.max_bodies())}
    for name, (run, n_bodies) in routes.items():
        reset_counts()
        (_, cds, cls), secs = wall(run)
        launched = counts()
        from repro_torch.kernels.actuation import ops
        print(f"[golden pinball {name}] res 8, {n} dt through the fused "
              f"kernel in {secs:.3f} s, launches {launched}")
        if (launched["fused_interval"] != 1
                or ops.fused_interval_cuda.last_n_bodies != n_bodies):
            fail(f"the pinball golden run ({name}) did not go through the "
                 f"fused kernel's instantiation for {n_bodies} bodies")
        stats = measure_shedding(cds, cls, cfg.dt)
        for key, tol in TOL_PINBALL.items():
            want, got = float(ref[key]), stats[key]
            rel = abs(got - want) / abs(want)
            print(f"[golden pinball {name}] {key}: {got:.6f} vs fixture "
                  f"{want:.6f} (rel {rel:.2e}, tol {tol})")
            if not (math.isfinite(got) and rel <= tol):
                fail(f"pinball golden ({name}) {key} {got} vs {want} "
                     f"outside rel {tol}")


@contextlib.contextmanager
def observed(module, name, before=None, after=None):
    """Wrap ``module.name`` for the duration: ``before(*args)`` sees each
    call's arguments, ``after(out)`` its result; the call itself is
    unchanged (the phase reads what the path computed, it alters
    nothing)."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        if before is not None:
            before(*args)
        out = fn(*args, **kw)
        if after is not None:
            after(out)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def observed_steps(module, name, first=None, last=None):
    """Wrap the generator function ``module.name`` for the duration:
    ``first()`` runs when its first step starts, ``last()`` when its last
    step ends, each on the stream its caller made current for that step;
    the steps themselves are unchanged."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        def steps():
            if first is not None:
                first()
            out = yield from fn(*args, **kw)
            if last is not None:
                last()
            return out
        return steps()

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def robust_path(mlp_episode_s):
    """Phase 7: the attention policy and the robust training path on the
    card, at full width, every run under torch.use_deterministic_algorithms
    (an op without a deterministic implementation raises).  Returns the
    per-body instantiation's launches over the phase's runs."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.drl import engine as engine_mod
    from repro_torch.drl import ppo, rollout
    from repro_torch.drl import train_state as ts_mod
    from repro_torch.drl.train import TrainConfig, train
    from repro_torch.testing import faults
    scenarios = ("cyl_re100", "pinball_re100")
    intervals, groups = 100, 2
    base = ROOT / "build" / "robust_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    print("[robust] full width: res 16, 50 dt per action, 60 SOR "
          "iterations, 4 envs of cyl_re100+pinball_re100 (149 probes, the "
          "pinball's 59 padded; act_dim 3), attention policy d_model 64, 4 "
          "heads over 2 KV heads, 2 layers; 100 actions per episode after a "
          "30 t.u. warmup per group; deterministic algorithms on")
    per_body_launches = 0

    def run(tag, episodes, ckpt=None, fault=None, policy="attention", **kw):
        nonlocal per_body_launches
        cfg = TrainConfig(
            env=EnvConfig(grid=GridConfig(res=16), steps_per_action=50,
                          actions_per_episode=intervals, warmup_time=30.0),
            n_envs=4, episodes=episodes, seed=0, scenarios=scenarios,
            policy=policy, backend="fused", device="cuda",
            ckpt_dir=None if ckpt is None else str(base / ckpt),
            ckpt_every=1, **kw)
        health = {}
        faults.configure(fault)
        reset_counts()
        try:
            (hist, model), secs = wall(lambda: train(
                cfg, log_fn=lambda m: print(f"[robust {tag}] {m}"),
                health=health))
        finally:
            faults.reset()
        launched = counts()
        per_body_launches += launched["fused_interval_per_body"]
        print(f"[robust {tag}] to episode {episodes} in {secs:.3f} s, episode "
              f"walls {hist['wall'].tolist()}, health {health}, fused "
              f"launches {launched['fused_interval']} (per-body "
              f"{launched['fused_interval_per_body']})")
        for k, v in hist.items():
            if len(v) != episodes or not np.isfinite(v).all():
                fail(f"robust {tag}: history {k} = {v}")
        return hist, model, health, launched

    def expect_launches(tag, launched, episodes, warmups):
        want = (episodes * intervals + warmups, episodes * intervals)
        got = (launched["fused_interval"], launched["fused_interval_per_body"])
        if got != want:
            fail(f"robust {tag}: fused launches (all, per-body) {got}, "
                 f"expected {want}: one per-body launch per interval and "
                 f"{warmups} scalar warmup launches")

    def same_model(tag, a, b):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            if not torch.equal(x, y):
                fail(f"robust {tag}: param {k} differs from the "
                     f"uninterrupted run")

    def same_hist(tag, a, b, n=None):
        for f in ("reward", "cd", "cl", "quarantines", "grad_skips"):
            if not np.array_equal(a[f][:n], b[f][:n]):
                fail(f"robust {tag}: history {f} {b[f]} differs from the "
                     f"uninterrupted run's {a[f]}")

    finals = []

    def final_flow(out):
        finals.append([x.clone() for x in out[0].flow])

    def split_run(tag, episodes, ckpt=None, **kw):
        """run() with each episode's rollout (policy + env steps) and PPO
        update timed on the host clock between synchronisations."""
        split = {"rollout": [], "update": []}
        t0 = [0.0]

        def start(*_):
            torch.cuda.synchronize()
            t0[0] = time.perf_counter()

        def stop(key):
            def after(out):
                torch.cuda.synchronize()
                split[key].append(time.perf_counter() - t0[0])
                if key == "rollout":
                    final_flow(out)
            return after

        with observed(rollout, "rollout_batch", start, stop("rollout")), \
                observed(engine_mod, "ppo_update", start, stop("update")):
            out = run(tag, episodes, ckpt, **kw)
        rest = [float(w - r - u) for w, r, u in zip(out[0]["wall"],
                                             split["rollout"],
                                             split["update"])]
        print(f"[robust {tag}] per episode: rollout {split['rollout']} s, "
              f"PPO update {split['update']} s, the rest (values, GAE, "
              f"history, checkpoint) {rest} s")
        return out

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # (a) the uninterrupted run, its first episode's final fields kept
        hist_a, model_a, health_a, launched = split_run("a", 2, "A")
        expect_launches("a", launched, 2, groups)
        clean_final = finals[0]
        if not all(torch.isfinite(x).all() for x in clean_final):
            fail("robust a: non-finite fields after the first episode")
        path = ck.latest_checkpoint(str(base / "A"))
        ckpt_bytes = Path(path).stat().st_size
        print(f"[robust a] checkpoint {path}: {ckpt_bytes} bytes; "
              f"{health_a['ckpt_saves']} saves, "
              f"{health_a['ckpt_bytes']} bytes written, time_blocked "
              f"{health_a['ckpt_time_blocked']:.6f} s in all "
              f"({health_a['ckpt_time_waited']:.6f} s of it waiting for the "
              f"previous write), "
              f"{health_a['ckpt_time_blocked'] / health_a['ckpt_saves']:.6f} "
              f"s a save")
        print(f"[robust] attention episode {hist_a['wall'][-1]:.3f} s "
              f"(steady, the second), MLP episode {mlp_episode_s:.3f} s "
              f"(phase 2, the second)")

        # 1 episode, then a resume to 2: bit-equal, no warmup on resume
        _, _, _, launched = run("b1", 1, "B")
        expect_launches("b1", launched, 1, groups)
        hist_b, model_b, _, launched = run("resume", 2, "B", resume=True)
        expect_launches("resume", launched, 1, 0)
        same_model("resume", model_a, model_b)
        same_hist("resume", hist_a, hist_b)
        ts_a, _ = ts_mod.load_train_state(path, "cuda")
        ts_b, _ = ts_mod.load_train_state(
            ck.latest_checkpoint(str(base / "B")), "cuda")
        if not torch.equal(ts_a.rng, ts_b.rng) or ts_a.step != ts_b.step:
            fail("robust resume: generator state or PPO step differs")
        for k in ("m", "v"):
            if not all(torch.equal(x, y) for x, y in
                       zip(ts_a.opt_state[k], ts_b.opt_state[k])):
                fail(f"robust resume: Adam {k} differs")
        print("[robust resume] params, Adam m/v, generator state, step "
              f"{ts_b.step} and history equal to the uninterrupted run's, "
              "bit for bit")

        # (b) NaN in env 1's u at step 4: one quarantine, the other envs'
        # final fields those of (a)'s first episode
        finals.clear()
        with observed(rollout, "rollout_batch", after=final_flow):
            hist, _, health, launched = run(
                "nan_env", 1, fault={"nan_env": {"env": 1, "step": 4}})
        expect_launches("nan_env", launched, 1, groups)
        if hist["quarantines"].tolist() != [1.0] or \
                health["quarantines"] != 1:
            fail(f"robust nan_env: quarantines {hist['quarantines']}, "
                 f"expected exactly 1")
        keep = [0, 2, 3]
        for x, y in zip(finals[0], clean_final):
            if not torch.equal(x[keep], y[keep]):
                fail("robust nan_env: the unpoisoned envs' final fields "
                     "differ from the clean run's")
        if not all(torch.isfinite(x).all() for x in finals[0]):
            fail("robust nan_env: non-finite fields after the quarantine")
        print("[robust nan_env] 1 quarantine; envs 0, 2, 3 final u, v, p "
              "equal to the clean run's first episode, bit for bit")

        # (c) a NaN gradient at PPO step 7: skipped, params unchanged across
        # that minibatch (and changed across the next)
        snaps, calls = {}, [0]

        def at_minibatch(cfg, model, batch):
            if calls[0] in (7, 8, 9):
                snaps[calls[0]] = [q.detach().clone()
                                   for q in model.parameters()]
            calls[0] += 1

        with observed(ppo, "ppo_loss", before=at_minibatch):
            hist, _, health, launched = run(
                "grad_nan", 1, fault={"grad_nan": {"step": 7}})
        expect_launches("grad_nan", launched, 1, groups)
        if hist["grad_skips"].tolist() != [1.0] or health["grad_skips"] != 1:
            fail(f"robust grad_nan: grad_skips {hist['grad_skips']}, "
                 f"expected 1")
        if not all(torch.equal(x, y) for x, y in zip(snaps[7], snaps[8])):
            fail("robust grad_nan: the skipped minibatch changed params")
        if all(torch.equal(x, y) for x, y in zip(snaps[8], snaps[9])):
            fail("robust grad_nan: the next minibatch left params unchanged")
        print("[robust grad_nan] 1 update skipped; params equal before and "
              "after minibatch 7, changed by minibatch 8")

        # (d) the watchdog trips at episode 1: one rollback to the episode-1
        # checkpoint, then the run completes as (a)
        hist, model, health, launched = run(
            "watchdog", 2, "D", fault={"watchdog": {"episode": 1}})
        expect_launches("watchdog", launched, 3, groups)
        if health["rollbacks"] != 1:
            fail(f"robust watchdog: {health['rollbacks']} rollbacks, "
                 f"expected 1")
        same_model("watchdog", model_a, model)
        same_hist("watchdog", hist_a, hist)
        print("[robust watchdog] 1 rollback; completed equal to the "
              "uninterrupted run, bit for bit")

        # where an episode's time goes: the MLP on the same batch under the
        # same instrumentation, and the attention policy without
        # deterministic algorithms
        hist, _, _, _ = split_run("mlp", 2, policy="mlp")
        torch.use_deterministic_algorithms(False)
        hist_n, model_n, _, _ = split_run("nondeterministic", 2)
        same = all(torch.equal(x, y) for x, y in
                   zip(model_a.parameters(), model_n.parameters()))
        print(f"[robust] steady episode: attention {hist_a['wall'][-1]:.3f} s"
              f", MLP {hist['wall'][-1]:.3f} s (both deterministic), "
              f"attention without deterministic algorithms "
              f"{hist_n['wall'][-1]:.3f} s (params "
              f"{'equal' if same else 'not equal'} to the deterministic "
              f"run's)")
    finally:
        torch.use_deterministic_algorithms(prev)
        shutil.rmtree(base, ignore_errors=True)
    return per_body_launches


def io_path(card):
    """Phase 8: the paper's I/O layer on the card at the main path's width.
    (a) ``train()`` recording into a dataset sink; (b) ``replay_sync`` of
    that dataset from the seed, bit-equal to the live run under
    deterministic algorithms and launching no fused kernel; (c) a
    truncated and a byte-flipped copy refused; (d) the CFD<->DRL file
    interface in each mode on the second episode's batch, then an episode
    of ``train(interface=..., sink=...)`` spilling to a binary file.
    Returns the fused kernel's launches while recording."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.core.interface import MultiEnvInterface
    from repro_torch.data.trajectory_dataset import (DatasetError,
                                                     TrajectoryReader)
    from repro_torch.drl import engine as engine_mod
    from repro_torch.drl import networks
    from repro_torch.drl import train_state as ts_mod
    from repro_torch.drl.train import TrainConfig, train
    base = ROOT / "build" / "io_path"
    shutil.rmtree(base, ignore_errors=True)
    intervals, episodes = 100, 2
    env_cfg = EnvConfig(grid=GridConfig(res=16), steps_per_action=50,
                        actions_per_episode=intervals, warmup_time=30.0)
    print(f"[io] full width: res 16 (ny 66, nx 352), 50 dt per action, 60 "
          f"SOR iterations, 2x512 MLP, 149 probes, 4 envs, "
          f"backend='fused'; depth cut: {episodes} episodes of {intervals} "
          f"actions after a 30 t.u. warmup; deterministic algorithms on; "
          f"card {card}")

    def cfg_for(n, **kw):
        return TrainConfig(env=env_cfg, n_envs=4, episodes=n, seed=0,
                           backend="fused", device="cuda", **kw)

    def same(what, a, b):
        if not torch.equal(a, b):
            fail(f"io replay: {what} differs from the live run")

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # (a) record
        built, batches = [], []
        cfg = cfg_for(episodes,
                      sink=engine_mod.SinkSpec(kind="dataset",
                                               root=str(base / "ds")),
                      ckpt_dir=str(base / "ck"), ckpt_every=episodes)
        reset_counts()
        with observed(engine_mod.SinkSpec, "build", after=built.append), \
                observed(engine_mod, "ppo_update",
                         before=lambda *a: batches.append(a[4])):
            (hist, model), secs = wall(lambda: train(
                cfg, log_fn=lambda m: print(f"[io record] {m}")))
        launched = counts()["fused_interval"]
        sink = built[0]
        per_ep = sink.bytes_written / sink.episodes
        print(f"[io record] train() with a dataset sink: {episodes} episodes "
              f"in {secs:.3f} s, episode walls {hist['wall'].tolist()}, "
              f"fused launches {launched}; dataset appends: "
              f"{sink.bytes_written} bytes in {sink.episodes} records "
              f"({per_ep:.0f} bytes a record), {sink.time_spent:.6f} s "
              f"caller-visible ({sink.time_spent / sink.episodes:.6f} s an "
              f"episode: the copy to the host, pack, write, fsync, "
              f"manifest), {sink.retries} retries")
        if launched != episodes * intervals + 1:
            fail(f"io record: the fused kernel launched {launched} times, "
                 f"expected {episodes * intervals + 1} (one per interval "
                 f"and the warmup's)")
        reader = TrajectoryReader(str(base / "ds"))
        if reader.episodes != list(range(episodes)):
            fail(f"io record: the dataset holds episodes {reader.episodes}")
        want_meta = json.loads(json.dumps(ts_mod.run_metadata(
            n_envs=4, obs_dim=149, seed=0, grid=env_cfg.grid,
            horizon=intervals, steps_per_action=env_cfg.steps_per_action,
            scenarios=None,
            policy={"policy": "mlp", "obs_dim": 149, "act_dim": 1}),
            default=str))
        if reader.metadata != want_meta:
            fail(f"io record: the manifest's metadata {reader.metadata} is "
                 f"not the run fingerprint {want_meta}")
        live, _ = ts_mod.load_train_state(
            ck.latest_checkpoint(str(base / "ck")), "cuda")

        # (b) replay from the seed, through the same update
        meta = reader.metadata
        engine = engine_mod.RolloutEngine(None, engine_mod.EngineConfig(
            n_envs=meta["n_envs"], horizon=meta["horizon"],
            gamma=cfg.ppo.gamma, lam=cfg.ppo.lam, timing=True))
        pcfg = networks.PolicyConfig(obs_dim=meta["obs_dim"],
                                     act_dim=meta["policy"]["act_dim"])
        rmodel, optimizer, opt_state, gen = engine.init(
            pcfg, cfg.ppo, meta["seed"], "cuda")
        steps = []
        reset_counts()
        (rmodel, opt_state, returns), rsecs = wall(lambda: engine.replay_sync(
            reader, rmodel, opt_state, cfg.ppo, optimizer, len(reader),
            generator=gen, on_state=lambda c: steps.append(c.step)))
        if counts()["fused_interval"] != 0:
            fail("io replay launched the fused kernel")
        for (k, a), b in zip(rmodel.state_dict().items(),
                             model.state_dict().values()):
            same(f"param {k}", a, b)
        for k in ("m", "v"):
            for a, b in zip(opt_state[k], live.opt_state[k]):
                same(f"Adam {k}", a, b)
        same("the generator state", gen.get_state(), live.rng)
        if steps[-1] != live.step:
            fail(f"io replay: PPO step {steps[-1]}, live {live.step}")
        if not np.array_equal(returns, hist["reward"]):
            fail(f"io replay: returns {returns} != live {hist['reward']}")
        print(f"[io replay] replay_sync of {len(reader)} episodes in "
              f"{rsecs:.3f} s (PPO update {engine.stats['update_s']:.3f} s "
              f"of it), no fused launch; params, Adam m/v, PPO step "
              f"{steps[-1]}, generator state and returns {returns.tolist()} "
              f"equal to the live run's, bit for bit")

        # (c) damaged copies are refused, never replayed
        shard = sorted((base / "ds").glob("shard_*.bin"))[-1]
        cut = base / "truncated"
        shutil.copytree(base / "ds", cut)
        with open(cut / shard.name, "r+b") as f:
            f.truncate(shard.stat().st_size - 8)
        flip = base / "flipped"
        shutil.copytree(base / "ds", flip)
        rec = json.loads((flip / "manifest.json").read_text())["episodes"]["1"]
        with open(flip / rec["shard"], "r+b") as f:
            f.seek(rec["offset"] + 8 + rec["length"] // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        for what, root, match in (("truncated", cut, "truncated shard"),
                                  ("flipped", flip, "crc32 mismatch")):
            try:
                engine.replay_sync(TrajectoryReader(str(root)), rmodel,
                                   opt_state, cfg.ppo, optimizer, 2,
                                   generator=gen, start=1 if what ==
                                   "flipped" else 0)
            except DatasetError as e:
                if match not in str(e):
                    fail(f"io {what}: refused with {e}, expected "
                         f"{match!r}")
                print(f"[io durability] {what} copy refused: {e}")
            else:
                fail(f"io {what}: the damaged dataset replayed")
    finally:
        torch.use_deterministic_algorithms(prev)

    # (d) the paper's interface on the second episode's PPO batch
    batch = batches[-1]
    for mode in ("file_baseline", "optimized", "disabled"):
        iface = MultiEnvInterface(mode, str(base / "iface" / mode), 4)
        _, secs = wall(lambda: iface.exchange(batch))
        obs = batch.obs.cpu().numpy().reshape(4, intervals, -1)
        acts = batch.act.cpu().numpy().reshape(4, -1)
        for i, fi in enumerate(iface.envs if mode != "disabled" else ()):
            back = fi.read_actuation(0)
            # the ASCII dump prints 10 significant digits (float32 needs 9)
            # and the config text the action to 8 decimals; binary is exact
            want = obs[i].ravel().astype(np.float64)
            act = float(acts[i, 0])
            if mode == "file_baseline":
                ok = np.allclose(back.obs, want, rtol=1e-9, atol=0.0)
                act = float(f"{act:.8f}")
            else:
                ok = np.array_equal(back.obs, obs[i].ravel())
            if not ok:
                fail(f"io interface {mode}: env {i}'s probes did not read "
                     f"back")
            if back.action != act:
                fail(f"io interface {mode}: env {i}'s action read back "
                     f"{back.action}, wrote {act}")
        print(f"[io interface {mode}] {iface.bytes_moved} bytes per exchange "
              f"({iface.bytes_moved / 4:.0f} per env), {secs:.6f} s host "
              f"per exchange (timed {iface.time_spent:.6f} s inside), every "
              f"record read back; card {card}")
        iface.cleanup()

    fsink = engine_mod.SinkSpec(kind="binary",
                                root=str(base / "spill")).build()
    iface = MultiEnvInterface("optimized", str(base / "iface" / "train"), 4)
    trajs = []
    reset_counts()
    (hist, _), secs = wall(lambda: train(
        cfg_for(1), log_fn=lambda m: print(f"[io train] {m}"),
        interface=iface, sink=fsink,
        on_episode=lambda traj, m: trajs.append(traj)))
    launched = counts()["fused_interval"]
    if launched != intervals + 1 or iface.period != 1:
        fail(f"io train: {launched} fused launches, {iface.period} "
             f"exchanges")
    back = fsink.read(0)
    for f, a, b in zip(back._fields, trajs[0], back):
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a.cpu().numpy(), b)):
            fail(f"io train: the binary file's {f} differs from the "
                 f"episode's trajectory")
    print(f"[io train] 1 episode in {secs:.3f} s with the optimized "
          f"interface ({iface.bytes_moved} bytes, {iface.time_spent:.6f} s) "
          f"and a binary sink: {fsink.bytes_written} bytes, "
          f"{fsink.time_spent:.6f} s caller-visible; the file reads back "
          f"equal to the episode's trajectory; fused launches {launched}; "
          f"card {card}")
    shutil.rmtree(base, ignore_errors=True)
    return dict(io_path_launches=episodes * intervals + 1,
                io_path=("train(sink=SinkSpec(kind='dataset')), warmup + 2 "
                         "episodes; replay_sync launches none"),
                io_record_bytes=per_ep, io_replay_s=rsecs)


def async_path(card):
    """Phase 9: the async trainer and the planner on the card at the
    training shape (res 16, 4 envs, 50 dt per action, 149 probes, 2x512
    MLP, 3 episodes of 100 actions after one warmup).  (a) Under
    deterministic algorithms: ``RolloutEngine.run_async``; a serial
    emulation of its schedule (the same refresh, permutation draws, collect
    and update order, one stream, a synchronise between collect and
    update); the same schedule with the update issued from a worker thread
    on a second stream (the design ``run_async`` does not use: the two
    threads contend for the interpreter lock); ``run_sync``.  The three
    async
    runs must agree bit for bit (params, Adam m / v, PPO step, generator
    state, returns) and differ from ``run_sync``.  (b) Each run's episode
    walls and the device time of each collect and update, with the overlap
    of the two streams (CUDA events at the start and end of each); no
    overlap in the steady episodes of ``run_async`` fails.  (c)
    ``autotune`` at res 16 with its artifact validated: (1, 1) and
    "fused" expected.  (d) ``train(plan="auto")`` for 1 episode: one fused
    launch per interval and the warmup's, beside the probe's.  (e)
    ``async_speedup`` of the refit model beside the measured ratio.
    Returns the launch counts for the kernels line."""
    import copy
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch.cfd.env import CylinderEnv, EnvConfig, \
        broadcast_env_state
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.core import autotune as at
    from repro_torch.drl import engine as engine_mod
    from repro_torch.drl import networks
    from repro_torch.drl.async_train import async_speedup
    from repro_torch.drl.engine import EngineConfig, RolloutEngine
    from repro_torch.drl.ppo import PPOConfig
    from repro_torch.drl.train import TrainConfig, train
    intervals, episodes, n_env = 100, 3, 4
    grid = GridConfig(res=16)
    env_cfg = EnvConfig(grid=grid, steps_per_action=50,
                        actions_per_episode=intervals, warmup_time=30.0)
    ppo_cfg = PPOConfig()
    base = ROOT / "build" / "async_path"
    shutil.rmtree(base, ignore_errors=True)
    print(f"[async] full width: res 16 (ny 66, nx 352), 50 dt per action, "
          f"60 SOR iterations, 2x512 MLP, 149 probes, {n_env} envs, "
          f"backend='fused'; depth cut: {episodes} episodes of {intervals} "
          f"actions after one 30 t.u. warmup; deterministic algorithms on "
          f"in (a); card {card}")
    env = CylinderEnv(env_cfg, backend="fused", device="cuda")
    st0, obs0 = env.reset()
    st_b, obs_b = broadcast_env_state(st0, obs0, n_env)
    pcfg = networks.PolicyConfig(obs_dim=int(obs_b.shape[-1]))
    rec = {}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()                       # on this thread's current stream
        return ev

    def mark(*_):
        rec["host"].append(time.perf_counter())

    def run(tag, loop):
        eng = RolloutEngine.for_env(env, EngineConfig(
            n_envs=n_env, horizon=intervals, gamma=ppo_cfg.gamma,
            lam=ppo_cfg.lam))
        model, optimizer, opt_state, gen = eng.init(pcfg, ppo_cfg, 0, "cuda")
        rec.update(collect=[], update=[], host=[])
        torch.cuda.synchronize()
        t0 = event()
        reset_counts()
        mark()
        with observed(RolloutEngine, "collect",
                      before=lambda *a: rec["collect"].append([event()]),
                      after=lambda o: rec["collect"][-1].append(event())), \
                observed(engine_mod, "ppo_update",
                         before=lambda *a: rec["update"].append([event()]),
                         after=lambda o: rec["update"][-1].append(event())), \
                observed_steps(engine_mod, "ppo_update_steps",
                               first=lambda: rec["update"].append([event()]),
                               last=lambda: rec["update"][-1].append(
                                   event())):
            opt_state, step, returns = loop(eng, model, optimizer,
                                            opt_state, gen)
        torch.cuda.synchronize()
        end = time.perf_counter()
        out = dict(model=model, opt_state=opt_state, step=step,
                   rng=gen.get_state(), returns=np.asarray(returns),
                   launches=counts()["fused_interval"])
        walls = np.diff(rec["host"]).tolist()
        span = [[t0.elapsed_time(a), t0.elapsed_time(b)]
                for a, b in rec["collect"] + rec["update"]]
        c_span, u_span = span[:episodes], span[episodes:]
        # collect e runs beside the update of e-1's batch (the e-th update)
        overlap = [max(0.0, min(c[1], u[1]) - max(c[0], u[0]))
                   for c, u in zip(c_span[1:], u_span)]
        out.update(walls=walls, overlap_ms=overlap,
                   collect_ms=[b - a for a, b in c_span],
                   update_ms=[b - a for a, b in u_span])
        print(f"[async {tag}] {episodes} episodes in "
              f"{end - rec['host'][0]:.3f} s; episode walls {walls} s (the "
              f"last update after them: {end - rec['host'][-1]:.3f} s); on "
              f"the card: collects {out['collect_ms']} ms, updates "
              f"{out['update_ms']} ms, collect e beside update e-1 overlapping "
              f"{overlap} ms; fused launches {out['launches']}, returns "
              f"{out['returns'].tolist()}")
        if out["launches"] != episodes * intervals:
            fail(f"async {tag}: {out['launches']} fused launches, expected "
                 f"one per interval ({episodes * intervals})")
        return out

    def run_async(eng, model, optimizer, opt_state, gen):
        carry = {}
        _, opt_state, returns = eng.run_async(
            model, opt_state, ppo_cfg, optimizer, st_b, obs_b, episodes,
            generator=gen, on_episode=mark,
            on_state=lambda c: carry.update(step=c.step),
            state_every=episodes + 1)
        return opt_state, carry["step"], returns

    def run_sync(eng, model, optimizer, opt_state, gen):
        carry = {}
        _, opt_state, returns = eng.run_sync(
            model, opt_state, ppo_cfg, optimizer, st_b, obs_b, episodes,
            generator=gen, on_episode=mark,
            on_state=lambda c: carry.update(step=c.step))
        return opt_state, carry["step"], returns

    def emulate(worker):
        """run_async's schedule without its interleaving: the same refresh,
        permutation draws, collect and update order, the update either on
        the collect's stream with a synchronise after each collect and each
        update, or (``worker``) issued from a worker thread on a second
        stream beside the collect, events ordering the two."""
        from concurrent.futures import ThreadPoolExecutor

        def loop(eng, model, optimizer, opt_state, gen):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream() if worker else None
            behaviour = copy.deepcopy(model)
            state = dict(opt_state=opt_state, step=0, job=None, held=None)

            def update(batch, perm, opt_state, step, ready):
                with contextlib.nullcontext() if side is None \
                        else torch.cuda.stream(side):
                    if ready is not None:
                        side.wait_event(ready)
                    out = engine_mod.ppo_update(
                        ppo_cfg, optimizer, model, opt_state, batch, step,
                        perms=perm)
                    done = torch.cuda.Event()
                    done.record()
                return out, done

            def issue(batch):
                perm = torch.stack([torch.randperm(batch.obs.shape[0],
                                                   generator=gen)
                                    for _ in range(ppo_cfg.epochs)])
                args = (batch, perm, state["opt_state"], state["step"])
                state["held"] = args       # freed once main is after it
                if worker:
                    ready = torch.cuda.Event()
                    ready.record()
                    state["job"] = pool.submit(update, *args, ready)
                else:
                    state["job"] = update(*args, None)
                    torch.cuda.synchronize()

            def settle():
                job = state["job"]
                if job is None:
                    return
                (opt, step, _), done = job.result() if worker else job
                main.wait_event(done)
                state.update(opt_state=opt, step=step, job=None, held=None)

            pending, returns = None, []
            with ThreadPoolExecutor(max_workers=1) as pool:
                for _ in range(episodes):
                    settle()
                    behaviour.load_state_dict(model.state_dict())
                    if pending is not None:
                        issue(pending)
                    pending, traj = eng.collect(behaviour, st_b, obs_b,
                                                generator=gen, record=False)
                    if not worker:
                        torch.cuda.synchronize()
                    returns.append(float(torch.mean(torch.sum(traj.reward,
                                                              dim=1))))
                    mark()
                settle()
                issue(pending)
                settle()
            return state["opt_state"], state["step"], returns
        return loop

    def same(tag, a, b):
        checks = [("step", a["step"] == b["step"]),
                  ("generator state", torch.equal(a["rng"], b["rng"])),
                  ("returns", np.array_equal(a["returns"], b["returns"]))]
        checks += [(f"param {k}", torch.equal(x, y)) for (k, x), y in zip(
            a["model"].state_dict().items(),
            b["model"].state_dict().values())]
        checks += [(f"Adam {k}[{j}]", torch.equal(x, y))
                   for k in ("m", "v") for j, (x, y) in enumerate(
                       zip(a["opt_state"][k], b["opt_state"][k]))]
        return [what for what, ok in checks if not ok]

    # (a) + (b): the async schedule against its emulations and run_sync
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        sync = run("run_sync", run_sync)
        asyn = run("run_async", run_async)
        serial = run("serial emulation", emulate(worker=False))
        threaded = run("worker-thread emulation", emulate(worker=True))
    finally:
        torch.use_deterministic_algorithms(prev)
    for tag, other in (("the serial emulation", serial),
                       ("the worker-thread emulation", threaded)):
        diff = same(tag, asyn, other)
        if diff:
            fail(f"async: run_async differs from {tag} in {diff[:5]}")
    if not same("run_sync", asyn, sync):
        fail("async: run_async's final params equal run_sync's: the "
             "schedule shows no staleness")
    print(f"[async] run_async equal to the serial emulation and to the "
          f"worker-thread emulation bit for bit (params, Adam m / v, step "
          f"{asyn['step']}, generator state, returns); different from "
          f"run_sync's (step {sync['step']})")
    steady = slice(1, episodes)
    if not any(x > 0 for x in asyn["overlap_ms"]):
        fail(f"async: no steady episode overlaps collect and update on the "
             f"card: {asyn['overlap_ms']} ms")
    sync_ep = float(np.mean(sync["walls"][steady]))
    async_ep = float(np.mean(asyn["walls"][steady]))
    print(f"[async] steady episode (episodes 1-{episodes - 1}): run_sync "
          f"{sync_ep:.4f} s, run_async {async_ep:.4f} s (ratio "
          f"{sync_ep / async_ep:.4f}), worker-thread emulation "
          f"{float(np.mean(threaded['walls'][steady])):.4f} s, serial "
          f"emulation {float(np.mean(serial['walls'][steady])):.4f} s; "
          f"card {card}")

    # (c) the autotuner at res 16
    art = base / "autotune.json"
    reset_counts()
    rp, secs = wall(lambda: at.autotune(grid=grid, device="cuda",
                                        artifact=str(art)))
    tuned = counts()
    record = json.loads(art.read_text())
    at.validate_artifact(record)
    m = record["measured"]
    print(f"[autotune] {secs:.3f} s on {m['device']}; measured: t_step "
          f"{m['t_step_ranks']} s ({m['t_step_backends']}), pressure solve "
          f"{m['t_poisson_layouts']} s, {m['interval_probe_steps']}-dt "
          f"interval {m['t_interval_backends']} s, policy {m['t_policy']} "
          f"s, update {m['t_update']} s, io {m['io']}; predicted: "
          f"{record['predicted']}; plan {record['plan']}; launches {tuned}")
    print(f"[autotune] {rp.describe()}")
    if (rp.n_envs, rp.n_ranks) != (1, 1) or rp.backend != "fused":
        fail(f"autotune chose {(rp.n_envs, rp.n_ranks)} with backend "
             f"{rp.backend!r}, expected (1, 1) and 'fused'")

    # (d) train(plan="auto"): the plan's backend drives the env
    probe = {}
    reset_counts()
    with observed(at, "autotune",
                  before=lambda *a: probe.update(before=counts()),
                  after=lambda o: probe.update(after=counts(), plan=o)):
        (hist, model), secs = wall(lambda: train(
            TrainConfig(env=env_cfg, n_envs=n_env, episodes=1, seed=0,
                        plan="auto", device="cuda"),
            log_fn=lambda msg: print(f"[train plan=auto] {msg}")))
    auto = counts()
    probe_launches = {k: probe["after"][k] - probe["before"][k]
                      for k in auto}
    path_fused = auto["fused_interval"] - probe_launches["fused_interval"]
    print(f"[train plan=auto] 1 episode in {secs:.3f} s, wall "
          f"{hist['wall'].tolist()}; launches {auto}, of them the plan's "
          f"probe {probe_launches}")
    if probe["plan"].backend != "fused" or path_fused != intervals + 1:
        fail(f"train(plan='auto') ran backend {probe['plan'].backend!r} with "
             f"{path_fused} fused launches outside the probe, expected "
             f"'fused' and {intervals + 1} (one per interval, one warmup)")

    # (e) the cost model's async gain beside the measured one
    gain = async_speedup(rp.model, rp.plan)
    per_dt = (m["t_interval_backends"]["fused"] / m["interval_probe_steps"])
    gain_fused = async_speedup(dataclasses.replace(rp.model, t_step_1=per_dt),
                               rp.plan)
    print(f"[async] async_speedup of the refit model {gain}; with t_step_1 "
          f"the fused interval's per dt ({per_dt:.3e} s) {gain_fused}; "
          f"measured steady ratio {sync_ep / async_ep:.4f}")
    shutil.rmtree(base, ignore_errors=True)
    return dict(
        fused=dict(async_path_launches=asyn["launches"],
                   async_path=("RolloutEngine.run_async, 3 episodes after "
                               "one warmup, 1 per interval"),
                   autotune_launches=tuned["fused_interval"],
                   plan_auto_launches=auto["fused_interval"],
                   plan_auto_path=("train(plan='auto'): the probe's, the "
                                   "warmup's and 1 per interval")),
        sor=dict(autotune_launches=tuned["rb_sor_slabs_packed"],
                 autotune_path=("autotune t_step_ranks[1]: solver.step("
                                "backend='pallas'), 1 per solve")),
        async_episode_s=async_ep, sync_episode_s=sync_ep)


HALO_SCENARIOS = ("cyl_re100", "cyl_re100_rotary", "cyl_re200", "cyl_re100")
TOL_HALO_MONOLITHIC = 1e-5     # relative, the reference's bound
TOL_HALO_ROLLOUT = 0.05        # the reference's mixed-batch gate
# (d) train() on plan (4, 2, 2): ~17 s an episode of 8 actions on the card,
# cut to 2
HALO_TRAIN_EPISODES = 1
HALO_TRAIN_ACTIONS = 2
# (c) the halo rollout's fixed actions (of 50 dt each) on the mixed batch,
# cut from 3
HALO_ROLLOUT_ACTIONS = (0.3, -0.2)
# phase 10's autotune fleet (d): 1 episode of this many actions after this
# warmup (t.u.); its gates read autotune's artifact, written before them
FLEET_AUTO_ACTIONS = 2
FLEET_AUTO_WARMUP = 0.5


def halo_solves(dev, card):
    """Phase 12 (a): the decomposed solve at the training shape against
    the monolithic one, its messages recorded."""
    import torch
    from repro_torch.cfd import decomp, poisson
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.launch.mesh import mesh_for_plan
    grid = GridConfig(res=16)
    gen = torch.Generator().manual_seed(12)
    rhs = torch.randn((4, grid.ny, grid.nx), generator=gen).to(dev)
    p0 = (0.1 * torch.randn((4, grid.ny, grid.nx), generator=gen)).to(dev)
    kw = dict(iters=60, polish=10)
    mono = {packed: poisson.solve(rhs, grid.dx, grid.dy, p0=p0,
                                  backend="packed" if packed else "full",
                                  **kw) for packed in (True, False)}
    scale = float(mono[True].abs().max())
    rows = []
    for r in (1, 2, 4):
        mesh = mesh_for_plan((1, r), device=dev)
        for inner in (1, 4):
            for packed in (True, False):
                def solve(mesh=mesh, inner=inner, packed=packed):
                    return decomp.decomposed_solve(
                        rhs, p0, mesh=mesh, dx=grid.dx, dy=grid.dy,
                        inner_iters=inner, packed=packed, **kw)
                with decomp.record_messages() as log:
                    out = solve()
                torch.cuda.synchronize()
                shapes = sorted({shape for shape, _ in log})
                per_env = sum(n for _, n in log)
                nbytes = sum(n * shape[0] * shape[1] * 4 for shape, n in log)
                rel = float((out - mono[packed]).abs().max()) / scale
                row = dict(ranks=r, halo_inner=inner, packed=packed,
                           ms=cuda_ms(solve, 3),
                           host_paced_ms=host_paced_ms(solve, 3),
                           messages_per_env=per_env, message_shapes=shapes,
                           bytes_per_env=nbytes, rel_to_monolithic=rel)
                print(f"[halo solve] ranks {r}, halo_inner {inner}, "
                      f"{'packed' if packed else 'legacy'}: {row['ms']:.4f} "
                      f"ms a solve of 4 envs (host-paced "
                      f"{row['host_paced_ms']:.4f} ms), {per_env} messages "
                      f"{shapes} and {nbytes} bytes an env, max |diff| / "
                      f"max |p| against the monolithic solve {rel:.3e}; card "
                      f"{card}")
                if not torch.isfinite(out).all():
                    fail(f"halo solve {row} is not finite")
                if r == 1 and not torch.equal(out, mono[packed]):
                    fail(f"the rank-1 halo solve {row} differs from the "
                         f"monolithic one")
                if r > 1 and inner == 1 and packed \
                        and rel > TOL_HALO_MONOLITHIC:
                    fail(f"the tight-coupling halo solve at {r} ranks is "
                         f"{rel:.3e} from the monolithic one (> "
                         f"{TOL_HALO_MONOLITHIC})")
                want = (33, 1) if packed and inner == 1 else (66, 1)
                if r > 1 and shapes != [want]:
                    fail(f"halo messages {shapes}, expected [{want}]")
                if r > 1 and packed and inner == 1 \
                        and per_env != 4 * kw["iters"] * (r - 1):
                    fail(f"{per_env} halo messages an env at {r} ranks, "
                         f"expected {4 * kw['iters'] * (r - 1)}")
                if r == 1 and log:
                    fail("a one-rank halo solve sent messages")
                rows.append(row)
    return rows


def halo_golden(dev):
    """Phase 12 (b): the res-8 golden fixture through
    ``run_uncontrolled(backend="halo")`` at two ranks (plain PyTorch, no
    kernel launched), held within the golden tolerances.  Returns its
    seconds."""
    import numpy as np
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.cfd.validation import measure_shedding, run_uncontrolled
    from repro_torch.convert import flow_state_from_numpy
    from repro_torch.launch.mesh import mesh_for_plan
    ref = np.load(ROOT / "tests" / "golden" / "cyl_re100_res8.npz")
    cfg = GridConfig(res=int(ref["res"]), dt=float(ref["dt"]),
                     poisson_iters=int(ref["poisson_iters"]))
    state = flow_state_from_numpy(ref["u"], ref["v"], ref["p"], device=dev)
    reset_counts()
    (_, cds, cls), golden_s = wall(lambda: run_uncontrolled(
        cfg, state, int(ref["meas_steps"]), backend="halo",
        mesh=mesh_for_plan((1, 2), device=dev)))
    launched = counts()
    stats = measure_shedding(cds, cls, cfg.dt)
    print(f"[halo golden] res 8, {int(ref['meas_steps'])} dt at two "
          f"ranks in {golden_s:.3f} s, launches {launched}")
    if any(launched.values()):
        fail(f"the halo golden run launched kernels: {launched}")
    for key, tol in (("strouhal", TOL_ST), ("cd_mean", TOL_CD),
                     ("cl_amp", TOL_AMP)):
        want, got = float(ref[key]), stats[key]
        rel = abs(got - want) / abs(want)
        print(f"[halo golden] {key}: {got:.6f} vs fixture {want:.6f} "
              f"(rel {rel:.2e}, tol {tol})")
        if not (math.isfinite(got) and rel <= tol):
            fail(f"halo golden {key} {got} vs {want} outside rel {tol}")
    return golden_s


# the halo golden's child process: its last line
HALO_GOLDEN_DONE = "HALO_GOLDEN_DONE"


def start_halo_golden():
    """Phase 12 (b) in a child process (``--halo-golden``), started before
    phase 10: the golden is ~1600 dt of host-bound plain PyTorch, which
    then runs beside the fleets' process starts instead of after them.
    It holds ~1 GB of the card and ends before phase 13."""
    import os
    from repro_torch.core import autotune as at
    env = dict(os.environ, **{at.FORCE_DEVICE_COUNT: "4"})
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--halo-golden"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT)


def halo_golden_joined(proc):
    """Wait for the golden's child, print its lines, fail if it failed.
    Returns its golden seconds."""
    out, _ = proc.communicate(timeout=900)
    lines = out.strip().splitlines()
    for line in lines:
        if line.startswith(("[halo golden]", "chip_smoke FAILED")):
            print(line)
    if proc.returncode != 0 or not lines or \
            not lines[-1].startswith(HALO_GOLDEN_DONE):
        fail(f"the halo golden's child exited {proc.returncode}:\n"
             f"{out[-3000:]}")
    return float(lines[-1].split()[1])


def halo_path(card, golden=None):
    """Phase 12: the halo decomposition on the card, four plan workers
    served by the card (``REPRO_TORCH_FORCE_DEVICE_COUNT=4`` for the phase
    only); the golden (b) read from ``golden``, its child process, where
    one was started.  Returns the phase's readings for the kernels
    line."""
    import os
    import numpy as np
    import torch
    from repro_torch.cfd import decomp
    from repro_torch.cfd.env import CylinderEnv, EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.core import autotune as at
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.drl.engine import shard_env_batch
    from repro_torch.drl.train import TrainConfig, train
    from repro_torch.launch.mesh import mesh_for_plan
    dev = torch.device("cuda")
    prev = os.environ.get(at.FORCE_DEVICE_COUNT)
    os.environ[at.FORCE_DEVICE_COUNT] = "4"
    try:
        # (a) the solve
        (solves, secs) = wall(lambda: halo_solves(dev, card))
        print(f"[halo solve] 12 cases in {secs:.3f} s")

        # (b) the golden fixture at two ranks: the child started before
        # phase 10, or here
        if golden is None:
            golden_s = halo_golden(dev)
        else:
            golden_s = halo_golden_joined(golden)

        # (c) a mixed batch with fixed actions on a (2, 2) mesh
        env_cfg = EnvConfig(grid=GridConfig(res=16), steps_per_action=50,
                            warmup_time=1.0)
        mesh = mesh_for_plan(ParallelPlan(4, 2, 2), device=dev)
        outs = {}
        reset_counts()
        for tag, backend, env_mesh in (("halo", "halo", mesh),
                                       ("reference", "reference", None)):
            env = CylinderEnv(env_cfg, backend=backend, mesh=env_mesh,
                              device=dev)
            st_b, _ = env.reset_batch(HALO_SCENARIOS, 4)
            if env_mesh is not None:
                st_b = shard_env_batch(env_mesh, st_b, 2)
            rows = []
            t0 = time.perf_counter()
            for a in HALO_ROLLOUT_ACTIONS:
                st_b, out = env.env_step(st_b, torch.full((4,), a,
                                                          device=dev))
                rows.append(out)
            torch.cuda.synchronize()
            outs[tag] = {f: torch.stack([getattr(o, f) for o in rows])
                         for f in ("reward", "cd", "cl", "obs")}
            print(f"[halo rollout] {tag}: {len(HALO_ROLLOUT_ACTIONS)} actions "
                  f"of 50 dt on 4 envs "
                  f"{HALO_SCENARIOS} in {time.perf_counter() - t0:.3f} s "
                  f"(after the warmup)")
        launched = counts()
        for f in ("reward", "cd", "cl", "obs"):
            d = float((outs["halo"][f] - outs["reference"][f]).abs().max())
            print(f"[halo rollout] {f}: max |halo - reference| {d:.3e} "
                  f"(tol {TOL_HALO_ROLLOUT})")
            if not (torch.isfinite(outs["halo"][f]).all()
                    and d < TOL_HALO_ROLLOUT):
                fail(f"the (2, 2) halo rollout's {f} is {d} from the "
                     f"reference backend's")
        if any(launched.values()):
            fail(f"the halo rollout launched kernels: {launched}")

        # (d) train() with the hybrid plan; its episodes' solves must send
        # 4 half-width messages a sweep pair (the warmup is un-decomposed)
        logs = []
        reset_counts()
        with decomp.record_messages() as messages:
            (hist, model), train_s = wall(lambda: train(
                TrainConfig(env=EnvConfig(grid=GridConfig(res=16),
                                          steps_per_action=50,
                                          actions_per_episode=(
                                              HALO_TRAIN_ACTIONS),
                                          warmup_time=1.0),
                            n_envs=4, episodes=HALO_TRAIN_EPISODES, seed=0,
                            plan=ParallelPlan(4, 2, 2), device="cuda"),
                log_fn=lambda msg: (logs.append(msg),
                                    print(f"[halo train] {msg}"))))
        launched = counts()
        sent = sum(n for _, n in messages)
        steps = HALO_TRAIN_EPISODES * HALO_TRAIN_ACTIONS * 50
        want = 4 * 60 * steps
        print(f"[halo train] {sent} halo messages an env "
              f"{sorted({shape for shape, _ in messages})} (expected {want} "
              f"of (33, 1): 4 a sweep pair, 60 pairs, {steps} dt)")
        if sent != want or {shape for shape, _ in messages} != {(33, 1)}:
            fail(f"the halo train sent {sent} messages, expected {want}")
        line = [msg for msg in logs if "plan[explicit]" in msg]
        print(f"[halo train] {HALO_TRAIN_EPISODES} episode(s) of "
              f"{HALO_TRAIN_ACTIONS} actions "
              f"in {train_s:.3f} s, "
              f"episode walls {hist['wall'].tolist()}, rewards "
              f"{hist['reward'].tolist()}, launches {launched}")
        if not line or "'halo'" not in line[0] or "2 x 2" not in line[0]:
            fail(f"train(plan=ParallelPlan(4, 2, 2)) logged {line}")
        if not all(np.isfinite(v).all() for v in hist.values()) or not all(
                bool(torch.isfinite(p).all()) for p in model.parameters()):
            fail("train(plan=ParallelPlan(4, 2, 2)) is not finite")
        if launched["fused_interval"] or launched["rb_sor_slabs_packed"]:
            fail(f"the halo train launched kernels: {launched}")

        # (e) autotune over the four workers
        reset_counts()
        rp, tune_s = wall(lambda: at.autotune(grid=GridConfig(res=16),
                                              device="cuda"))
        tuned = counts()
        m = rp.measurements["measured"]
        print(f"[halo autotune] {tune_s:.3f} s, 4 workers: t_step_ranks "
              f"{m['t_step_ranks']} s ({m['t_step_backends']}); "
              f"{rp.describe()}; launches {tuned}; card {card}")
        if sorted(m["t_step_ranks"]) != [1, 2, 4]:
            fail(f"autotune over 4 workers timed ranks "
                 f"{sorted(m['t_step_ranks'])}, expected [1, 2, 4]")
    finally:
        if prev is None:
            os.environ.pop(at.FORCE_DEVICE_COUNT, None)
        else:
            os.environ[at.FORCE_DEVICE_COUNT] = prev
    return dict(
        fused=dict(halo_train_launches=launched["fused_interval"],
                   halo_autotune_launches=tuned["fused_interval"],
                   halo_path=(f"train(plan=ParallelPlan(4, 2, 2)), warmup + "
                              f"{HALO_TRAIN_EPISODES} episode of "
                              f"{HALO_TRAIN_ACTIONS} actions: none (the halo "
                              f"backend); autotune over 4 workers: its "
                              f"interval probe")),
        sor=dict(halo_train_launches=launched["rb_sor_slabs_packed"],
                 halo_autotune_launches=tuned["rb_sor_slabs_packed"]),
        solves=solves, golden_s=golden_s, train_s=train_s,
        t_step_ranks=m["t_step_ranks"], plan=rp.describe())


def fleet_path(card):
    """Phase 10: fleet mode through the port's launcher on the card at the
    training shape (res 16, 4 envs in all, 50 dt per action, 60 SOR
    iterations, 2x512 MLP, 149 probes, cluster 16, 100 actions an
    episode).  (a) a 1-process fleet of 2 episodes, one fused launch per
    interval; (b) a 2-process fleet killed after episode 2 of 3 -> shrink
    -> resume: the episode-1 checkpoint its two runners wrote equal to
    (a)'s bit for bit (the fleets of 1 and 2 processes agree), its
    episode-2 checkpoint equal to (a)'s final one, the resumed episode
    completing; (c) plan (4, 2, 2) on the halo backend in 1 and 2
    runners, bit-equal; (d) ``--plan auto`` in 2 runners of 4 workers:
    the autotuner's measured gloo ``t_interhost`` and ranks 1, 2 and 4
    timed.  Returns the launch counts for the kernels line and (a)'s
    checkpoint directory."""
    import os
    import shutil
    import numpy as np
    import torch
    from repro_torch.ckpt.checkpoint import latest_checkpoint, step_path
    from repro_torch.core import autotune as at
    from repro_torch.drl.train_state import load_train_state
    base = ROOT / "build" / "fleet_path"
    shutil.rmtree(base, ignore_errors=True)
    intervals, warmups = 100, 1
    shape = ["--res", "16", "--dt", "0.005", "--poisson-iters", "60",
             "--steps-per-action", "50", "--actions-per-episode",
             str(intervals), "--warmup", "30",
             "--device", "cuda", "--heartbeat-timeout", "180",
             "--launch-timeout", "300"]
    print(f"[fleet] full width: res 16 (ny 66, nx 352), 50 dt per action, 60 "
          f"SOR iterations, 2x512 MLP, 149 probes, 4 envs in all, "
          f"backend='fused', cluster 16; depth cut: {intervals} actions an "
          f"episode after a 30 t.u. warmup; every runner on the one card, "
          f"gloo between them, deterministic algorithms; card {card}")
    torch.cuda.empty_cache()

    def launch(tag, *extra, env_extra=None):
        wd = base / tag
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   **(env_extra or {}))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.fleet", *shape,
             "--workdir", str(wd), *map(str, extra)],
            capture_output=True, text=True, env=env, timeout=420,
            cwd=str(ROOT))
        secs = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"fleet {tag}: the launcher exited {out.returncode}\n"
                 f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        return wd, out.stdout, secs

    def timings(wd, stdout, procs, gen=0):
        """Each runner's FLEET_TIMING, process 0's from the launcher's
        stdout, the others' from their logs."""
        texts = [stdout] + [(wd / f"runner_gen{gen}_p{p:03d}.log").read_text()
                            for p in range(1, procs)]
        out = []
        for p, text in enumerate(texts):
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("FLEET_TIMING")]
            if not lines:
                fail(f"fleet {wd.name}: runner {p} printed no FLEET_TIMING")
            out.append({k: float(v) for k, v in
                        (kv.split("=") for kv in lines[-1].split()[1:])})
        return out

    def stats(stdout):
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("FLEET_STATS")][-1]
        return json.loads(line.split(" ", 1)[1])

    def differs(a, b):
        (ta, ma), (tb, mb) = a, b
        checks = [("episode", ma["episode"] == mb["episode"]),
                  ("step", ta.step == tb.step),
                  ("generator state", torch.equal(ta.rng, tb.rng)),
                  ("obs", torch.equal(ta.obs, tb.obs)),
                  ("flow u", torch.equal(ta.env_state.flow.u,
                                         tb.env_state.flow.u))]
        checks += [(f"param {k}", torch.equal(ta.params[k], tb.params[k]))
                   for k in ta.params]
        checks += [(f"Adam {k}[{j}]", torch.equal(x, y))
                   for k in ("m", "v") for j, (x, y) in enumerate(
                       zip(ta.opt_state[k], tb.opt_state[k]))]
        checks += [(f"history {f}", np.array_equal(v, tb.history[f]))
                   for f, v in ta.history.items() if f != "wall"]
        return [what for what, ok in checks if not ok]

    # (a) a 1-process fleet; (b) holds a 2-process fleet's checkpoint
    # against it
    runs = {}
    for procs in (1,):
        wd, stdout, secs = launch(f"p{procs}", "--processes", procs,
                                  "--episodes", 2)
        tm, st = timings(wd, stdout, procs), stats(stdout)
        final = load_train_state(latest_checkpoint(str(wd / "ckpt")), "cpu")
        fused = [int(t["fused_launches"]) for t in tm]
        runs[procs] = dict(wd=wd, timing=tm, stats=st, final=final,
                           fused=fused)
        steady = st["wall"][1]
        gather_s = [t["gather_s"] / 2 for t in tm]
        gather_b = [int(t["gather_bytes"]) // 2 for t in tm]
        rollout_s = [t["rollout_s"] / 2 for t in tm]
        print(f"[fleet p={procs}] 2 episodes in {secs:.3f} s of launcher "
              f"(process start, build check, warmup included); episode "
              f"walls {st['wall']} s (steady {steady:.4f} s); per episode "
              f"and runner: rollout {rollout_s} s, gather {gather_s} s, "
              f"{gather_b} bytes gathered; fused launches per runner "
              f"{fused}, clusters {[int(t['fused_cluster']) for t in tm]}; "
              f"card {card}")
        want = warmups + 2 * intervals
        if fused != [want] * procs:
            fail(f"fleet p={procs}: fused launches per runner {fused}, "
                 f"expected {want} each (one per interval, one warmup)")
        # pin_cluster fixes the whole batch's cluster in every runner
        clusters = [int(t["fused_cluster"]) for t in tm]
        if clusters != [16] * procs:
            fail(f"fleet p={procs}: fused clusters per runner {clusters}, "
                 f"expected the 4-env batch's 16 in each")
    # (b) a 2-process fleet, killed after episode 2 of 3 -> shrink ->
    # resume: its episode-2 checkpoint, written by both runners, against
    # (a)'s final one
    wd, stdout, secs = launch("elastic", "--processes", 2, "--episodes", 3,
                              "--kill-process", 1, "--kill-episode", 2)
    for want in ("FLEET_SHRINK gen=1 procs=2->1 reason=exit",
                 "FLEET_DONE episodes=3", "resume: "):
        if want not in stdout:
            fail(f"fleet elastic: no {want!r} in the launcher's output:\n"
                 f"{stdout[-3000:]}")
    final = load_train_state(latest_checkpoint(str(wd / "ckpt")), "cpu")
    at2 = load_train_state(str(step_path(str(wd / "ckpt"), 2)), "cpu")
    if final[1]["episode"] != 3:
        fail(f"fleet elastic: final checkpoint at episode "
             f"{final[1]['episode']}, expected 3")
    # the episode-1 checkpoint is the 2-process fleet's (the kill comes
    # after episode 2); the episode-2 one may be the resumed runner's
    at1 = load_train_state(str(step_path(str(wd / "ckpt"), 1)), "cpu")
    p1_at1 = load_train_state(
        str(step_path(str(runs[1]["wd"] / "ckpt"), 1)), "cpu")
    if at1[1]["plan"]["n_processes"] != 2:
        fail(f"fleet elastic: the episode-1 checkpoint records plan "
             f"{at1[1]['plan']}, not the 2-process fleet's")
    diff = differs(at1, p1_at1)
    if diff:
        fail(f"fleet: the 2-process fleet's episode-1 checkpoint differs "
             f"from the 1-process fleet's in {diff[:6]}")
    diff = differs(at2, runs[1]["final"])
    if diff:
        fail(f"fleet elastic: its episode-2 checkpoint differs from the "
             f"uninterrupted fleet's in {diff[:6]}")
    resumed = [ln for ln in stdout.splitlines() if ln.startswith("resume: ")]
    w1, w2 = (float(t[0].history["wall"][0]) for t in (p1_at1, at1))
    print(f"[fleet elastic] 2 runners, runner 1 killed after episode 2 of "
          f"3: shrink 2 -> 1, {resumed[0]}, 3 episodes done in {secs:.3f} s "
          f"of launcher; the 2-process fleet's episode-1 checkpoint equal "
          f"to the 1-process fleet's bit for bit (params, Adam m / v, step "
          f"{at1[0].step}, generator state, env batch, history), its "
          f"episode-2 checkpoint to the uninterrupted fleet's; first "
          f"episode N=1 {w1:.4f} s, N=2 {w2:.4f} s (N=2 / N=1 = "
          f"{w2 / w1:.4f}); card {card}")

    # (c) a multi-rank plan across the fleet: (4, 2, 2), 2 envs of 2
    # x-slabs each on the halo backend, one env a runner in the 2-runner
    # fleet; depth cut to 1 episode of 2 actions after a 0.5 t.u. warmup
    halo_depth = ["--plan", "4,2,2", "--n-envs", 2, "--episodes", 1,
                  "--actions-per-episode", 2, "--warmup", 0.5]
    halo = {}
    for procs in (1, 2):
        wd, stdout, secs = launch(f"halo_p{procs}", "--processes", procs,
                                  *halo_depth)
        for want in ("poisson backend 'halo'",
                     "mesh (data, model) = (2, 2)", "FLEET_DONE episodes=1"):
            if want not in stdout:
                fail(f"fleet halo p={procs}: no {want!r} in the launcher's "
                     f"output:\n{stdout[-3000:]}")
        final = load_train_state(latest_checkpoint(str(wd / "ckpt")), "cpu")
        st = stats(stdout)
        halo[procs] = final
        print(f"[fleet halo p={procs}] plan (4, 2, 2): 2 envs x 2 slabs on "
              f"the halo backend, {procs} runner(s); 1 episode of 2 actions "
              f"after a 0.5 t.u. warmup in {secs:.3f} s of launcher; episode "
              f"wall {st['wall']} s; plan recorded {final[1]['plan']}; "
              f"card {card}")
        if final[1]["plan"] != {"n_envs": 2, "n_ranks": 2, "backend": "halo",
                                "n_processes": procs}:
            fail(f"fleet halo p={procs}: checkpoint plan {final[1]['plan']}")
    diff = differs(halo[1], halo[2])
    if diff:
        fail(f"fleet halo: the 2-runner (4, 2, 2) fleet's final checkpoint "
             f"differs from the 1-runner fleet's in {diff[:6]}")
    print("[fleet halo] 1- and 2-runner fleets at plan (4, 2, 2) write the "
          "same final checkpoint bit for bit (params, Adam m / v, step, "
          "generator state, env batch, history)")

    # (d) autotune(max_processes=2) inside a 2-runner fleet whose runners
    # serve 4 workers each: its artifact valid, a measured 2-process gloo
    # t_interhost, and every candidate rank count timed, as the
    # reference's autotune does
    wd, stdout, secs = launch(
        "auto", "--processes", 2, "--plan", "auto", "--n-envs", 4,
        "--episodes", 1, "--actions-per-episode", FLEET_AUTO_ACTIONS,
        "--warmup", FLEET_AUTO_WARMUP,
        env_extra={at.FORCE_DEVICE_COUNT: "4"})
    record = json.loads((wd / "autotune.json").read_text())
    at.validate_artifact(record)
    ih = record["measured"]["t_interhost"]
    ranks = record["measured"]["t_step_ranks"]
    tm = timings(wd, stdout, 2)
    sor = [int(t["sor_launches"]) for t in tm]
    fused_auto = [int(t["fused_launches"]) for t in tm]
    print(f"[fleet auto] autotune(max_processes=2) in each of 2 runners of 4 "
          f"workers: t_interhost {ih}; t_step_ranks "
          f"{ {int(r): round(v * 1e3, 4) for r, v in ranks.items()} } ms "
          f"(backends {record['measured']['t_step_backends']}); plan "
          f"{record['plan']}; {len(record['candidates'])} candidate "
          f"layouts; launches per runner: packed SOR {sor}, fused "
          f"{fused_auto}; {secs:.3f} s of launcher; card {card}")
    if ih["estimated"] or ih["processes"] != 2:
        fail(f"fleet auto: t_interhost {ih}, expected a measured 2-process "
             f"gather")
    if record["plan"]["n_processes"] != 2 or min(sor) < 1:
        fail(f"fleet auto: plan {record['plan']}, packed-SOR launches {sor}")
    if sorted(int(r) for r in ranks) != [1, 2, 4]:
        fail(f"fleet auto: t_step_ranks at {sorted(ranks)}, expected ranks "
             f"1, 2 and 4")

    return dict(
        fused=dict(fleet_launches=runs[1]["fused"],
                   fleet_path=("python -m repro_torch.launch.fleet, 1 "
                               "runner of 4 envs on the card, warmup + 2 "
                               "episodes: 1 per interval")),
        sor=dict(fleet_launches=sor,
                 fleet_path=("python -m repro_torch.launch.fleet --plan "
                             "auto, 2 runners: autotune(max_processes=2) "
                             "t_step_ranks[1] probe in each")),
        ckpt_dir=runs[1]["wd"] / "ckpt")


def scripts_path(card, ckpt_dir):
    """Phase 11: the three user-facing scripts on the card, through the
    ``main(argv)`` their ``python -m`` entry points run; removes its own
    and phase 10's scratch directories after."""
    import shutil
    import numpy as np
    from repro_torch.core import autotune as at
    from repro_torch.examples import drl_cylinder, hybrid_scaling_demo, \
        serve_batch
    base = ROOT / "build" / "scripts_path"
    base.mkdir(parents=True, exist_ok=True)
    argv = ["--device", "cuda", "--res", "16", "--n-envs", "4", "--actions",
            "100", "--steps-per-action", "50", "--episodes", "1",
            "--warmup", "30", "--out", str(base / "drl_cylinder.json")]
    print(f"[scripts] drl_cylinder {' '.join(argv)}")
    reset_counts()
    hist, secs = wall(lambda: drl_cylinder.main(argv))
    launched = counts()
    if not np.isfinite(hist["reward"]).all() or \
            launched["fused_interval"] != 100 + 1:
        fail(f"drl_cylinder: rewards {hist['reward']}, fused launches "
             f"{launched['fused_interval']} (expected 101: one per "
             f"interval, one warmup)")
    print(f"[scripts] drl_cylinder: 1 episode in {secs:.3f} s, reward "
          f"{hist['reward'].tolist()}, launches {launched}")
    for extra in ([], ["--deterministic"]):
        res = serve_batch.main(["--device", "cuda", "--ckpt", str(ckpt_dir),
                                "--batch", "16", "--requests", "200",
                                *extra])
        print(f"[scripts] serve_batch {' '.join(extra) or '--sampled'} from "
              f"the fleet's checkpoint: p50 {res['p50_s'] * 1e3:.4f} ms, p99 "
              f"{res['p99_s'] * 1e3:.4f} ms, {res['actions_per_s']:.1f} "
              f"actions/s (batch 16, 200 requests, the card synchronised "
              f"around each); card {card}")
    best = hybrid_scaling_demo.main(["--workers", "60"])
    if (best.n_envs, best.n_ranks) != (60, 1):
        fail(f"hybrid_scaling_demo paper mode chose {best}")
    art = base / "autotune_demo.json"
    reset_counts()
    (best, rp), secs = wall(lambda: hybrid_scaling_demo.main(
        ["--auto", "--device", "cuda", "--res", "16", "--artifact",
         str(art)]))
    at.validate_artifact(json.loads(art.read_text()))
    print(f"[scripts] hybrid_scaling_demo --auto at res 16: {rp.describe()} "
          f"in {secs:.3f} s, launches {counts()}")
    shutil.rmtree(base, ignore_errors=True)
    shutil.rmtree(ckpt_dir.parents[1], ignore_errors=True)   # phase 10's


# phase 13: serving.  The prompt of train_4k's length, a cache of 64 more
# positions, 64 greedy decode steps; the yardstick's forward runs the
# flash kernel, which (like the reference's) takes a multiple of its
# 128-key tile, so it covers the 4097 tokens and 127 more (causal: the
# token at 4096 attends to its 4097 alone)
SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 4096, 4160, 64
SERVE_YARDSTICK = 4224
# decode_32k's cache length, its batch cut from 128 to 8 to fit the card
SERVE_32K_BATCH, SERVE_32K_LEN, SERVE_32K_STEPS = 8, 32768, 16
# the float8 configs at cut depth: (name, layers of the config's)
SERVE_FLOAT8 = (("llama3-405b", 4), ("mistral-large-123b", 8),
                ("qwen1.5-32b", 32))
SERVE_F8_BATCH, SERVE_F8_LEN, SERVE_F8_STEPS = 8, 4096, 16
# a float8 cache against a bfloat16 one, block by block on the same input:
# e4m3 keeps 3 mantissa bits, each K/V off by up to 2^-4 of itself; the
# tolerance of tests/test_torch_serve.py, where a block's update moves by
# ~5% of its RMS at reduced width
TOL_FLOAT8_BLOCK = 0.1


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def percentile_ms(times, q):
    import numpy as np
    return float(np.percentile(np.asarray(times) * 1e3, q))


def decode_reading(params, cache):
    """(bytes a decode step must read, its ms at the memory rate): every
    block's weights (both stacks of a dense prefix), the final norm, the
    head, the whole cache."""
    from repro_torch.models import model
    head = params.get("lm_head", params["embed"])
    parts = {"blocks": sum(nbytes(leaves(b))
                           for b in model.block_stacks(params)),
             "head": nbytes([head]) + nbytes(leaves(params["final_norm"])),
             "cache": nbytes(cache.values())}
    total = sum(parts.values())
    return parts, total, 1e3 * total / HBM_RATE


def timed_decode(cfg, params, cache, tokens, pos0, steps=None):
    """``decode_step`` from position ``pos0``, once per column of
    ``tokens``, or with ``steps`` that many times greedily from ``tokens``
    (B, 1); the card synchronised around each step: (host seconds per
    step, the tokens fed, the first step's logits)."""
    import torch
    from repro_torch.models import model
    times, fed, first = [], [], None
    tok = tokens[:, :1]
    for t in range(tokens.shape[1] if steps is None else steps):
        if steps is None:
            tok = tokens[:, t:t + 1]
        fed.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.decode_step(cfg, params, cache, tok, pos0 + t)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if first is None:
            first = logits
        if not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.name}: decode step {t} gave non-finite logits")
    return times, torch.cat(fed, dim=1), first


def profile_decode(cfg, params, cache, tokens, pos0, steps=4):
    """``steps`` more decode steps under ``torch.profiler``: (kernels a
    step, the card's busy ms a step: the sum of its kernels' spans), or
    None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(steps):
            model.decode_step(cfg, params, cache, tokens, pos0 + t)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not kernels or busy_us <= 0:
        return None
    return len(kernels) / steps, busy_us / 1e3 / steps


def profile_note(prof, p50):
    if prof is None:
        return "card busy share: not measured (no device time in the trace)"
    n, busy = prof
    return (f"under torch.profiler {n:.0f} kernels a step, the card busy "
            f"{busy:.4f} ms of it: {100 * (1 - busy / p50):.1f}% idle at "
            f"the p50")


def prefill_equals_its_layers(cfg, params, tokens, logits, cache):
    """Run prefill's layers one by one on its own inputs: each layer's
    cache (K and V from ``apply_attention(return_kv=True)``, a hybrid
    layer's also its Mamba states from ``apply_mamba``, or RWKV's states)
    and the logits must equal ``prefill``'s bit for bit."""
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import hybrid, model, ssm
    from repro_torch.models.layers import apply_norm
    h = model._embed(cfg, params, tokens)
    pos = model._positions(cfg, tokens)
    S = tokens.shape[1]
    for i, bp in enumerate(model.all_layers(params)):
        if cfg.attention_kind == "none":
            x0, s0 = model._rwkv_zero_states(cfg, h)
            h, xt, st, xc = model._rwkv_block(cfg, h, bp, x0, s0, x0)
            got = {"xprev_t": xt, "state": st, "xprev_c": xc}
            same = all(torch.equal(cache[k][i], v) for k, v in got.items())
        else:
            hn = apply_norm(cfg, bp["ln1"], h)
            a, k, v = attn_mod.apply_attention(
                cfg, bp["hyb"]["attn"] if "hyb" in bp else bp["attn"], hn,
                pos, return_kv=True)
            if "hyb" in bp:
                m, conv, st = ssm.apply_mamba(cfg, bp["hyb"]["mamba"], hn)
                a = hybrid.merge(bp["hyb"], a, m)
                if not (torch.equal(cache["conv"][i], conv)
                        and torch.equal(cache["ssm"][i], st)):
                    fail(f"{cfg.name}: prefill's Mamba states of layer {i} "
                         f"differ from its layer run on its input")
            same = (torch.equal(cache["k"][i, :, :S], k)
                    and torch.equal(cache["v"][i, :, :S], v)
                    and not cache["k"][i, :, S:].any()
                    and not cache["v"][i, :, S:].any())
            h = h + a
            h = h + model._ffn(cfg, bp, h)[0]
        if not same:
            fail(f"{cfg.name}: prefill's cache of layer {i} differs from "
                 f"its layer run on prefill's input to it")
    if not torch.equal(model._unembed(cfg, params, h[:, -1:])[:, 0], logits):
        fail(f"{cfg.name}: prefill's logits differ from its layers' run")


def layer_cache(cfg, bp, x_pre, pos, enc_out=None):
    """One layer's K/V cache of SERVE_CACHE positions built from its input
    ``x_pre`` with prefill's layer code (``apply_attention(return_kv=
    True)``), zeros after; a hybrid layer's also its Mamba states after
    ``x_pre`` (``apply_mamba``); an encoder-decoder layer's also its cross
    K / V of ``enc_out`` (``cross_kv``)."""
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model, ssm
    from repro_torch.models.layers import apply_norm
    hn = apply_norm(cfg, bp["ln1"], x_pre)
    _, k, v = attn_mod.apply_attention(
        cfg, bp["hyb"]["attn"] if "hyb" in bp else bp["attn"], hn, pos,
        return_kv=True)
    shape = (k.shape[0], SERVE_CACHE) + tuple(k.shape[2:])
    slices = {n: torch.zeros(shape, dtype=t.dtype, device=t.device)
              for n, t in (("k", k), ("v", v))}
    model._pad_cache(slices["k"], k)
    model._pad_cache(slices["v"], v)
    if "hyb" in bp:
        _, slices["conv"], slices["ssm"] = ssm.apply_mamba(
            cfg, bp["hyb"]["mamba"], hn)
    if "cross" in bp:
        slices["xk"], slices["xv"] = attn_mod.cross_kv(cfg, bp["cross"],
                                                       enc_out)
    return slices


def hold_decode_blocks(cfg, params, seq, at, frontend_embeds=None):
    """The decode block against the pallas forward, block by block: feed
    layer i the forward's input to it (``seq``'s tokens and a frontend
    config's embeddings, ``backend="pallas"``), build that layer's cache
    from the first ``at`` positions with prefill's layer code (and the
    encoder's output), decode position ``at`` through it, and compare the
    block's update there with the forward's.  For RWKV also hold the
    states prefill's layer code gives against the kernel's on the same
    input.  Returns (worst update difference, worst state readings)."""
    import torch
    from repro_torch.models import model
    h = model._embed(cfg, params, seq, frontend_embeds)
    enc_out = (model._run_encoder(cfg, params, frontend_embeds)
               if cfg.is_encdec else None)
    pos = model._positions(cfg, seq)
    p_at = model._pos_tensor(at, seq.device)
    worst, st_worst, xc_worst, xt_equal = 0.0, 0.0, 0.0, True
    for bp in model.all_layers(params):
        h_next = model._block_body(cfg, h, bp, positions=pos,
                                   enc_out=enc_out, backend="pallas")[0]
        x_pre, x_tok = h[:, :at], h[:, at:at + 1]
        if cfg.attention_kind == "none":
            x0, s0 = model._rwkv_zero_states(cfg, x_pre)
            _, xt, st, xc = model._rwkv_block(cfg, x_pre, bp, x0, s0, x0)
            _, xt_k, st_k, xc_k = model._rwkv_block(cfg, x_pre, bp, x0, s0,
                                                    x0, backend="pallas")
            st_worst = max(st_worst, float((st - st_k).abs().max()
                                           / st_k.abs().max()))
            xc_worst = max(xc_worst, rel_rms(xc, xc_k))
            xt_equal &= torch.equal(xt, xt_k)
            slices = {"state": st, "xprev_t": xt, "xprev_c": xc}
        else:
            slices = layer_cache(cfg, bp, x_pre, pos[:, :at], enc_out)
        out, _ = model._decode_block(cfg, x_tok, bp, slices, p_at)
        worst = max(worst, rel_rms(out - x_tok,
                                   h_next[:, at:at + 1] - x_tok))
        h = h_next
    return worst, (st_worst, xc_worst, xt_equal)


def serve_lm(dev, card, name, kernel, per_layer):
    """Phase 13 (a) / (b): prefill, greedy decode and the block-by-block
    hold of one config at full width and depth.  Returns (readings for
    the kernels line, params)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    cfg = get_config(name)
    params = model.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(13)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size,
                                       (1, SERVE_PROMPT)), device=dev)
    tag = f"[serve {name}]"
    with torch.inference_mode():
        torch.cuda.synchronize()
        (logits, cache), first_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE))
        (logits, cache), steady_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE))
        if logits.shape != (1, cfg.vocab_padded) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"{name}: prefill logits {tuple(logits.shape)} not finite "
                 f"or not (1, {cfg.vocab_padded})")
        dtypes = sorted({str(v.dtype) for v in cache.values()})
        print(f"{tag} {cfg.num_layers} layers, d_model {cfg.d_model}, bf16 "
              f"random params (seed 0); prefill B=1, S={SERVE_PROMPT}, "
              f"cache_len {SERVE_CACHE}: {first_s:.4f} s first call, "
              f"{steady_s:.4f} s steady; cache {nbytes(cache.values())} "
              f"bytes ({', '.join(dtypes)}); card {card}")
        prefill_equals_its_layers(cfg, params, prompt, logits, cache)
        what = ("K/V" if cfg.attention_kind != "none"
                else "state / xprev_t / xprev_c")
        print(f"{tag} prefill's {what} of every layer and its logits equal "
              f"its layers run one by one on its input to each, bit for bit")
        times, decoded, first = timed_decode(
            cfg, params, cache, logits.argmax(-1, keepdim=True),
            SERVE_PROMPT, steps=SERVE_STEPS)
        parts, total, bound_ms = decode_reading(params, cache)
        p50, p99 = percentile_ms(times, 50), percentile_ms(times, 99)
        prof = profile_decode(cfg, params, cache, decoded[:, -1:],
                              SERVE_CACHE - 4)
        print(f"{tag} {SERVE_STEPS} greedy decode_steps from position "
              f"{SERVE_PROMPT}: p50 {p50:.4f} ms, p99 {p99:.4f} ms per "
              f"token (host clock, the card synchronised around each); the "
              f"bound {bound_ms:.4f} ms: {total} bytes read a token "
              f"({parts}) at 3.35 TB/s; p50 / bound {p50 / bound_ms:.2f}; "
              f"{profile_note(prof, p50)}")
        pad = torch.tensor(rng.integers(
            0, cfg.vocab_size, (1, SERVE_YARDSTICK - SERVE_PROMPT
                                - SERVE_STEPS)), device=dev)
        seq = torch.cat([prompt, decoded, pad], dim=1)
        reset_counts()
        (fwd, _), fwd_s = wall(lambda: model.forward_train(
            cfg, params, seq, backend="pallas"))
        launched = counts()
        others = sum(n for k, n in launched.items() if k != kernel)
        fwd_at = fwd[:, SERVE_PROMPT]
        del fwd
        free = rel_rms(first, fwd_at)
        agree = bool(first.argmax(-1) == fwd_at.argmax(-1))
        worst, (st_w, xc_w, xt_eq) = hold_decode_blocks(cfg, params, seq,
                                                        SERVE_PROMPT)
    print(f"{tag} yardstick forward_train(backend='pallas') over "
          f"{SERVE_YARDSTICK} tokens (the {SERVE_PROMPT + 1} and "
          f"{SERVE_YARDSTICK - SERVE_PROMPT - 1} more) in {fwd_s:.4f} s: "
          f"{launched[kernel]} {kernel} launches, {others} of the others; "
          f"block by block on the forward's input to each layer, the decode "
          f"block's update at position {SERVE_PROMPT} is {worst:.3e} of its "
          f"RMS from the forward's at worst (tol {TOL_LM_LAYER:.0e}); "
          f"free-running, the first decoded logits differ from the "
          f"forward's by {free:.3e} of their RMS (reported), argmax "
          f"{'equal' if agree else 'different'}")
    if cfg.attention_kind == "none":
        print(f"{tag} on the forward's input to each layer, prefill's layer "
              f"code against the WKV6 kernel's: state {st_w:.3e} of its "
              f"largest |value| at worst (tol {TOL_WKV_STATE:.0e}), xprev_c "
              f"{xc_w:.3e} of its RMS (tol {TOL_LM_LAYER:.0e}), xprev_t "
              f"{'equal' if xt_eq else 'different'}")
        if not (st_w <= TOL_WKV_STATE and xc_w <= TOL_LM_LAYER and xt_eq):
            fail(f"{name}: prefill's states disagree with the kernel's")
    if launched[kernel] != per_layer * cfg.num_layers or others:
        fail(f"{name}: the yardstick launched {launched[kernel]} {kernel} "
             f"(expected {per_layer * cfg.num_layers}) and {others} others")
    if not worst <= TOL_LM_LAYER:
        fail(f"{name}: a decode block differs from the pallas forward's")
    del cache
    return dict(serve_launches=launched[kernel],
                serve_path=(f"forward_train({name}, backend='pallas') over "
                            f"{SERVE_YARDSTICK} tokens: phase 13's yardstick "
                            f"of decode_step"),
                serve_prefill_s=steady_s, serve_decode_p50_ms=p50,
                serve_decode_p99_ms=p99, serve_decode_bound_ms=bound_ms,
                serve_block_worst=worst), params


def serve_decode_32k(dev, card, cfg, params):
    """Phase 13 (c): decode at decode_32k's cache length, batch 8."""
    import numpy as np
    import torch
    from repro_torch.models import model
    cache = model.init_cache(cfg, SERVE_32K_BATCH, SERVE_32K_LEN, device=dev)
    toks = torch.tensor(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (SERVE_32K_BATCH, SERVE_32K_STEPS)), device=dev)
    with torch.inference_mode():
        times, _, _ = timed_decode(cfg, params, cache, toks,
                                   SERVE_32K_LEN - SERVE_32K_STEPS)
        prof = profile_decode(cfg, params, cache, toks[:, :1],
                              SERVE_32K_LEN - 4)
    parts, total, bound_ms = decode_reading(params, cache)
    p50, p99 = percentile_ms(times, 50), percentile_ms(times, 99)
    print(f"[serve decode_32k {cfg.name}] init_cache(B={SERVE_32K_BATCH}, "
          f"S={SERVE_32K_LEN}) ({nbytes(cache.values())} bytes, the batch "
          f"cut from 128 to {SERVE_32K_BATCH}), {SERVE_32K_STEPS} "
          f"decode_steps at the cache's last positions: p50 {p50:.4f} ms, "
          f"p99 {p99:.4f} ms per step of {SERVE_32K_BATCH} tokens; the "
          f"bound {bound_ms:.4f} ms ({total} bytes: {parts}); p50 / bound "
          f"{p50 / bound_ms:.2f}; {profile_note(prof, p50)}; card {card}")
    del cache
    torch.cuda.empty_cache()
    return dict(p50_ms=p50, p99_ms=p99, bound_ms=bound_ms)


def serve_float8(dev, card, name, layers):
    """Phase 13 (d): one float8 config at cut depth.  Decode from a float8
    ``init_cache`` and from a bfloat16 one (each timed); then both block by
    block on the bfloat16 run's inputs: each block's update within
    TOL_FLOAT8_BLOCK, the float8 cache's bytes the cast of the bfloat16
    cache's K/V."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    full = get_config(name)
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    params = model.init_params(cfg, seed=0, device=dev)
    toks = torch.tensor(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (SERVE_F8_BATCH, SERVE_F8_STEPS)), device=dev)
    tag = f"[serve float8 {name}]"

    def cache(dtype=None):
        return model.init_cache(cfg, SERVE_F8_BATCH, SERVE_F8_LEN,
                                dtype=dtype, device=dev)

    # at most one float8 and one bfloat16 cache at a time beside the
    # weights (qwen1.5-32b's 40 KV heads: 10.7 GB and 21.5 GB at 32 layers)
    with torch.inference_mode():
        c8 = cache()
        if c8["k"].dtype != torch.float8_e4m3fn:
            fail(f"{name}: init_cache gave {c8['k'].dtype}")
        t8, _, _ = timed_decode(cfg, params, c8, toks, 0)
        parts8, _, bound8 = decode_reading(params, c8)
        del c8
        cb = cache(torch.bfloat16)
        tb, _, _ = timed_decode(cfg, params, cb, toks, 0)
        del cb
        c8, cb = cache(), cache(torch.bfloat16)
        worst = 0.0
        for t in range(SERVE_F8_STEPS):
            h = model._embed(cfg, params, toks[:, t:t + 1])
            pos = model._pos_tensor(t, dev)
            for i in range(layers):
                bp = model.layer(params["blocks"], i)
                o8, _ = model._decode_block(
                    cfg, h, bp, {k: v[i] for k, v in c8.items()}, pos)
                ob, _ = model._decode_block(
                    cfg, h, bp, {k: v[i] for k, v in cb.items()}, pos)
                worst = max(worst, rel_rms(o8 - h, ob - h))
                h = ob
        same = all(torch.equal(c8[k].view(torch.uint8),
                               cb[k].to(torch.float8_e4m3fn).view(
                                   torch.uint8)) for k in ("k", "v"))
    print(f"{tag} {layers} of {full.num_layers} layers "
          f"({nbytes(leaves(params)) / 1e9:.2f} GB of bf16 weights), "
          f"init_cache(B={SERVE_F8_BATCH}, S={SERVE_F8_LEN}): float8 "
          f"{nbytes(c8.values())} bytes, {SERVE_F8_STEPS} decode_steps p50 "
          f"{percentile_ms(t8, 50):.4f} ms (p99 {percentile_ms(t8, 99):.4f}); "
          f"from a bfloat16 cache p50 {percentile_ms(tb, 50):.4f} ms (p99 "
          f"{percentile_ms(tb, 99):.4f}); the float8 step's bound "
          f"{bound8:.4f} ms ({parts8}); block by block the float8 update is "
          f"{worst:.3e} of the bfloat16 one's RMS at worst (tol "
          f"{TOL_FLOAT8_BLOCK}); the float8 cache "
          f"{'equals' if same else 'differs from'} the cast of the bfloat16 "
          f"cache's K/V byte for byte; card {card}")
    if not (0.0 < worst <= TOL_FLOAT8_BLOCK and same):
        fail(f"{name}: the float8 decode disagrees with the bfloat16 one")
    del params, c8, cb
    torch.cuda.empty_cache()
    return dict(p50_ms=percentile_ms(t8, 50), bf16_p50_ms=percentile_ms(
        tb, 50), bound_ms=bound8, worst=worst)


def serve_path(card):
    """Phase 13: the language model's serving path on the card.  Returns
    the readings of the flash-attention and WKV6 rows."""
    import torch
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    flash, params = serve_lm(dev, card, "phi4-mini-3.8b", "flash_attention",
                             1)
    from repro_torch.configs.base import get_config
    flash["decode_32k"] = serve_decode_32k(dev, card,
                                           get_config("phi4-mini-3.8b"),
                                           params)
    del params
    torch.cuda.empty_cache()
    wkv, params = serve_lm(dev, card, "rwkv6-3b", "wkv6", 2)
    del params
    torch.cuda.empty_cache()
    flash["float8"] = {name: serve_float8(dev, card, name, layers)
                       for name, layers in SERVE_FLOAT8}
    return flash, wkv


# phase 14: training.  train_4k's length; its batch of 256 cut to one
# sequence a microbatch (the config's train_microbatches), 2 steps, random
# bf16 params from a seed, remat "full" (the configs' default)
# the steps of each train phase: the first and one steady step
TRAIN_SEQ, TRAIN_STEPS = 4096, 2
TRAIN_CONFIGS = ("phi4-mini-3.8b", "rwkv6-3b")
# the first step's loss against a separate no-grad forward of lm_loss on
# its batch: the step averages its microbatches' bf16 losses in float32,
# the forward the whole batch's at once
TOL_TRAIN_LOSS = 1e-3
# (b) the microbatched step's accumulated gradients against one full-batch
# step's, per leaf, by rel-RMS, on a float32 copy of the bf16 params (the
# compute bf16 still): then each parameter's gradient sums its tokens in
# float32 in both, and what is left is the bf16 activations of GEMMs of
# other shapes (a batch of 4 against 1) and the order of the sums: 1.9e-3
# on the card at every leaf.  On the bf16 params themselves the
# embedding's gradient, a scatter-add of thousands of repeats of the
# frequent tokens into a bf16 table, reads 0.29 between the two and is
# reported only.  A missing division by the microbatch count would read
# 3, a dropped microbatch ~0.5
TRAIN_HOLD_LAYERS, TOL_MICROBATCH = 4, 1e-2
# (c) Adafactor at mistral-large-123b's widths: 6 of its 88 layers (more
# than 4 stacked layers, so its per-layer update path runs), 4
# microbatches of one sequence, 2 steps
ADAFACTOR_CONFIG, ADAFACTOR_LAYERS, ADAFACTOR_STEPS = \
    "mistral-large-123b", 6, 2


def train_batch(cfg, n, step, seed=0):
    import torch
    from repro_torch.data.pipeline import LMDataConfig, synthetic_batch
    b = synthetic_batch(LMDataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=TRAIN_SEQ, global_batch=n,
                                     seed=seed), step, cfg)
    return {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}


def train_steps(cfg, params, steps_n, n_seq, profiled=False):
    """``steps_n`` steps of ``make_train_step`` -> (losses, seconds of each
    step, peak bytes, and with ``profiled`` one more step's reading under
    ``torch.profiler``, :func:`profile_step`)."""
    import torch
    from repro_torch.launch import steps
    opt_state = steps.make_opt(cfg).init(steps.param_leaves(params))
    train_step = steps.make_train_step(cfg)
    step, losses, secs = 0, [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps_n):
        batch = train_batch(cfg, n_seq, i)
        (params, opt_state, step, m), s = wall(
            lambda: train_step(params, opt_state, step, batch))
        losses.append(float(m["loss"]))
        secs.append(s)
    peak = torch.cuda.max_memory_allocated()
    prof = None
    if profiled:
        batch = train_batch(cfg, n_seq, steps_n)
        prof = profile_step(lambda: train_step(params, opt_state, step,
                                               batch))
    del opt_state
    return losses, secs, peak, prof


def profile_step(fn, top=5):
    """``fn`` once under ``torch.profiler``: (kernels, the card's busy ms:
    the sum of their spans, the ``top`` kernel names by device time as
    (name, ms, count)), or None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the card's activity only: a step runs ~10^5 kernels, and host-side
    # events would multiply the trace the profiler must assemble
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    if not kernels or busy <= 0:
        return None
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return len(kernels), busy, [(k[:70], round(ms, 4), n)
                                for k, (ms, n) in heaviest]


def train_full(card, name):
    """Phase 14 (a): ``make_train_step`` of one config at full width and
    depth, bf16, remat "full"."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import roofline, steps
    from repro_torch.models import model
    cfg = get_config(name)
    n_mb = cfg.train_microbatches
    tag = f"[train {name}]"
    params = model.init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in steps.param_leaves(params))
    with torch.no_grad():
        (ref, _), ref_s = wall(lambda: model.lm_loss(
            cfg, params, train_batch(cfg, n_mb, 0), backend="reference"))
    ref = float(ref)
    torch.cuda.empty_cache()
    reset_counts()
    losses, secs, peak, prof = train_steps(
        cfg, params, TRAIN_STEPS, n_mb, profiled=name == TRAIN_CONFIGS[0])
    launched = counts()
    del params
    torch.cuda.empty_cache()
    steady = sum(secs[1:]) / len(secs[1:])
    if name != TRAIN_CONFIGS[0]:
        where = (f"card busy share: not measured (only "
                 f"{TRAIN_CONFIGS[0]}'s step is profiled)")
    elif prof is None:
        where = "card busy share: not measured (no device time in the trace)"
    else:
        n_k, busy, heaviest = prof
        idle = 100 * (1 - busy / 1e3 / steady)
        where = (f"one more step under torch.profiler: {n_k} kernels, the "
                 f"card busy {busy:.1f} ms, {idle:.1f}% idle against the "
                 f"steady step; the heaviest kernels (name, ms, count): "
                 f"{heaviest}")
    tokens = n_mb * TRAIN_SEQ
    hw = roofline.hardware_spec(device="cuda")
    flops = roofline.model_flops(cfg, InputShape("train", TRAIN_SEQ, n_mb,
                                                 "train"),
                                 steps.abstract_params(cfg))
    mfu = flops / (steady * hw.peak_flops)
    d_loss = abs(losses[0] - ref) / abs(ref)
    print(f"{tag} {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_padded}, {n_params} params bf16, {cfg.optimizer}, "
          f"remat {cfg.remat!r}; batch {n_mb} x {TRAIN_SEQ} (train_4k's "
          f"length, its batch cut from 256 to one sequence a microbatch), "
          f"{n_mb} microbatches; losses {losses}; s per step {secs} (first "
          f"{secs[0]:.4f}, steady {steady:.4f}); {tokens / steady:.1f} "
          f"tokens/s; peak {peak} bytes allocated; model FLOPs {flops:.4e} a "
          f"step, {mfu:.4f} of {hw.name}'s {hw.peak_flops:.3e} FLOP/s; the "
          f"first loss {losses[0]:.6f} against a separate forward's "
          f"{ref:.6f} ({ref_s:.3f} s): {d_loss:.3e} relative (tol "
          f"{TOL_TRAIN_LOSS:.0e}); kernel launches {launched}; card {card}")
    print(f"{tag} {where}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{name}: a training loss is not finite: {losses}")
    if d_loss > TOL_TRAIN_LOSS:
        fail(f"{name}: the first step's loss {losses[0]} differs from "
             f"lm_loss's {ref} by {d_loss:.3e} relative")
    if any(launched.values()):
        fail(f"{name}: the train step launched kernels {launched}; the "
             f"reference's train step runs none")
    return dict(losses=losses, s_per_step=secs, steady_s=steady,
                tokens_per_s=tokens / steady, peak_bytes=peak, mfu=mfu,
                profile=prof)


@contextlib.contextmanager
def gradient_probe():
    """``launch.steps.make_opt`` replaced by an optimizer that leaves the
    gradients it is handed in ``probe["grads"]`` (copies in host memory,
    so that the card holds one step at a time) and changes nothing: a
    train step then shows what it would update with."""
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import Optimizer
    probe = {}

    def update(grads, state, params, step, donate=False):
        probe["grads"] = [g.to("cpu") for g in grads]
        return params, state
    real = steps.make_opt
    steps.make_opt = lambda cfg: Optimizer(lambda p: {}, update)
    try:
        yield probe
    finally:
        steps.make_opt = real


def step_grads(cfg, params, batch):
    """(the gradients one train step hands its optimizer, peak bytes)."""
    import torch
    from repro_torch.launch import steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with gradient_probe() as probe:
        steps.make_train_step(cfg)(params, {}, 0, batch)
    return probe["grads"], torch.cuda.max_memory_allocated()


def train_hold(card):
    """Phase 14 (b): at phi4-mini's width, 4 layers, deterministic
    algorithms, by the gradients each step hands its optimizer: remat
    "full" against "" on the bf16 params, bit for bit; 4 microbatches
    against one full-batch step on a float32 copy of them (the compute
    still bf16), so that each parameter's gradient sums its tokens in
    float32 in both; the same on the bf16 params reported."""
    import dataclasses
    import torch
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"),
                              num_layers=TRAIN_HOLD_LAYERS)
    n_mb = cfg.train_microbatches
    one_cfg = dataclasses.replace(cfg, train_microbatches=1)
    params = model.init_params(cfg, seed=1, device="cuda")
    names = [k for k, _ in steps.leaves_with_paths(params)]
    batch = train_batch(cfg, n_mb, 0, seed=1)

    def per_leaf(a, b):
        return sorted(((rel_rms(x, y), k) for k, x, y in zip(names, a, b)),
                      reverse=True)

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        full_remat, peak_remat = step_grads(cfg, params, batch)
        no_remat, peak_plain = step_grads(
            dataclasses.replace(cfg, remat=""), params, batch)
        one, peak_one = step_grads(one_cfg, params, batch)
        f32 = float32_copy(params)
        mb32, _ = step_grads(cfg, f32, batch)
        one32, _ = step_grads(one_cfg, f32, batch)
        del f32
    finally:
        torch.use_deterministic_algorithms(prev)
    bitwise = all(torch.equal(a, b) for a, b in zip(full_remat, no_remat))
    held, bf16 = per_leaf(mb32, one32), per_leaf(full_remat, one)
    worst = held[0][0]
    print(f"[train hold] phi4-mini-3.8b widths, {TRAIN_HOLD_LAYERS} of 32 "
          f"layers, batch {n_mb} x {TRAIN_SEQ}, deterministic algorithms: "
          f"remat 'full' against '': "
          f"{'bit-equal' if bitwise else 'DIFFERENT'}; peaks {peak_remat} "
          f"bytes (remat 'full'), {peak_plain} (remat ''), {peak_one} (one "
          f"full-batch step, remat 'full'); the {n_mb}-microbatch step's "
          f"gradients against one full-batch step's on float32 params, "
          f"rel-RMS by leaf (worst first): "
          f"{[(k, f'{e:.3e}') for e, k in held[:4]]} (tol "
          f"{TOL_MICROBATCH:.0e}); on the bf16 params (reported): "
          f"{[(k, f'{e:.3e}') for e, k in bf16[:4]]}; card {card}")
    if not bitwise:
        fail("remat 'full' changed the gradients")
    if worst > TOL_MICROBATCH:
        fail(f"microbatched gradients differ from the full batch's by "
             f"{worst:.3e} rel-RMS ({held[0][1]})")
    # a bf16 checkpoint of one layer of these params, restored bit-equal
    path = ROOT / "build" / "train_path" / "layer0.ckpt"
    layer0 = model.layer(params["blocks"], 0)
    ck.save(str(path), layer0, step=1, compress=False)
    back, manifest = ck.restore(str(path))
    flat = dict(steps.leaves_with_paths(layer0))
    same = all(back[k].dtype == torch.bfloat16 and torch.equal(
        back[k], flat[k].cpu()) for k in flat)
    dtypes = sorted({v["dtype"] for v in manifest["arrays"].values()})
    print(f"[train hold] layer 0 ({nbytes(flat.values())} bytes, dtypes "
          f"{dtypes}) saved and restored "
          f"{'bit-equal' if same else 'DIFFERENT'}")
    path.unlink()
    if not same:
        fail("a bf16 checkpoint did not restore bit-equal")
    del params
    torch.cuda.empty_cache()
    return dict(microbatch_rel_rms=worst, remat_bitwise=bitwise,
                peak_remat=peak_remat, peak_no_remat=peak_plain)


def float32_copy(tree):
    return {k: float32_copy(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def train_adafactor(card):
    """Phase 14 (c): Adafactor with its bf16 update direction at
    mistral-large-123b's widths, depth cut."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config(ADAFACTOR_CONFIG),
                              num_layers=ADAFACTOR_LAYERS)
    params = model.init_params(cfg, seed=0, device="cuda")
    stacked = [p for p in steps.param_leaves(params["blocks"])
               if p.dim() >= 3 and min(p.shape[-2:]) >= 128]
    reset_counts()
    losses, secs, peak, _ = train_steps(cfg, params, ADAFACTOR_STEPS,
                                        cfg.train_microbatches)
    launched = counts()
    print(f"[train adafactor] {ADAFACTOR_CONFIG} widths (d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}), "
          f"{ADAFACTOR_LAYERS} of 88 layers: {len(stacked)} stacked "
          f"factored leaves of {ADAFACTOR_LAYERS} layers take the per-layer "
          f"update; batch {cfg.train_microbatches} x {TRAIN_SEQ}, "
          f"{cfg.train_microbatches} microbatches, update_dtype bfloat16; "
          f"losses {losses}; s per step {secs}; peak {peak} bytes "
          f"allocated; kernel launches {launched}; card {card}")
    if not all(math.isfinite(x) for x in losses) or any(launched.values()):
        fail(f"adafactor: losses {losses}, launches {launched}")
    del params
    torch.cuda.empty_cache()
    return dict(losses=losses, s_per_step=secs, peak_bytes=peak)


def run_script(tag, argv):
    """``python -m <argv>`` on the card -> its stdout's lines."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res, secs = wall(lambda: subprocess.run(
        [sys.executable, "-m", *argv], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT), env=env))
    lines = res.stdout.strip().splitlines()
    print(f"{tag} python -m {' '.join(argv)}: exit {res.returncode} in "
          f"{secs:.3f} s; last lines {lines[-3:]}")
    if res.returncode:
        fail(f"{argv[0]} exited {res.returncode}: {res.stderr[-2000:]}")
    return lines


def train_scripts(card):
    """Phase 14 (d): the quickstart as a subprocess on the card (the
    training script runs in phase 19 (d), under its debug mesh)."""
    lines = run_script("[train scripts]",
                       ["repro_torch.examples.quickstart"])
    if lines[-1] != "OK":
        fail("the quickstart did not print OK")


def train_script_checkpoint(card):
    """Phase 19 (d): ``python -m repro_torch.launch.train`` (its step under
    ``make_debug_mesh(1, 1)``) as a subprocess on the card, and its
    checkpoint restored and saved again bit-equal."""
    import shutil
    from repro_torch.ckpt import checkpoint as ck
    base = ROOT / "build" / "train_path"
    shutil.rmtree(base, ignore_errors=True)
    lines = run_script("[mesh train script]", [
        "repro_torch.launch.train", "--arch", "phi4-mini-3.8b", "--reduced",
        "--steps", "20", "--ckpt-dir", str(base / "ckpt")])
    final = [ln for ln in lines if ln.startswith("final loss")][0]
    if not lines[0].startswith("init phi4-mini-3.8b-reduced"):
        fail(f"launch.train printed {lines[0]!r} first")
    path = ck.latest_checkpoint(str(base / "ckpt"))
    arrays, manifest = ck.restore(path)
    again = base / "again.ckpt"
    ck.save(str(again), arrays, step=manifest["step"])
    # every restored leaf saves again with the shape, dtype and crc32 of
    # the bytes first written
    same = ck.read_manifest(str(again))["arrays"] == manifest["arrays"]
    dtypes = sorted({v["dtype"] for v in manifest["arrays"].values()})
    print(f"[mesh train script] {final}; its checkpoint {path} "
          f"({len(arrays)} leaves, dtypes {dtypes}: the reduced config is "
          f"float32) restores, and saves again with every leaf's crc32 "
          f"{'equal' if same else 'DIFFERENT'}; card {card}")
    shutil.rmtree(base, ignore_errors=True)
    if not same:
        fail("the training checkpoint did not restore bit-equal")


def train_refusals():
    """Phase 14 (e): no gradient through a kernel on the card."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model
    try:
        steps.make_train_step(get_config("phi4-mini-3.8b"), backend="pallas")
        fail("make_train_step(backend='pallas') did not raise")
    except NotImplementedError as e:
        print(f"[train refusals] make_train_step(backend='pallas'): {e}")
    for name in TRAIN_CONFIGS:
        cfg = get_config(name).reduced()
        params = model.init_params(cfg, seed=0, device="cuda")
        for p in steps.param_leaves(params):
            p.requires_grad_(True)
        tok = torch.zeros((1, 128), dtype=torch.int64, device="cuda")
        reset_counts()
        try:
            model.forward_train(cfg, params, tok, backend="pallas")
            fail(f"{name}: forward_train(backend='pallas') with params "
                 f"requiring grad did not raise")
        except RuntimeError as e:
            print(f"[train refusals] {name} forward_train(backend='pallas')"
                  f" on params requiring grad: {str(e)[:80]}...; launches "
                  f"{counts()}")
        if any(counts().values()):
            fail(f"{name}: a refused call launched a kernel")


def train_path(card):
    """Phase 14: the language model's training path on the card."""
    import torch
    torch.cuda.empty_cache()
    (ROOT / "build" / "train_path").mkdir(parents=True, exist_ok=True)
    out = {name: train_full(card, name) for name in TRAIN_CONFIGS}
    out["hold"] = train_hold(card)
    out["adafactor"] = train_adafactor(card)
    train_scripts(card)
    train_refusals()
    return out


# phase 15: the mixture of experts.  phi3.5-moe-42b-a6.6b at its widths:
# its 32 layers are 41.9 B params, 83.75 GB in bf16, which do not fit beside
# activations on one card, so depth is cut: 16 layers (42.1 GB) for the
# forward and serving, 3 for training (AdamW's 16 bytes a parameter: 66.6
# GB before activations), 2 (45.8 GB) if 3 run out of memory
MOE_CONFIG = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS, MOE_TRAIN_LAYERS, MOE_SEQ = 16, (3, 2), 4096
# a capacity factor of E / K = 8: C = T, so no pair is dropped
MOE_DROPLESS = 8.0
# (c) the dispatch against the dense per-token mix of the top-k experts,
# bf16: the expert outputs are the same GEMMs' (over other rows); the
# dispatch then rounds p to bf16, each weighted output and their sum (three
# roundings of 2^-9 relative), the float32 mix none: rel-RMS, and the worst
# |difference| over the largest |value| (4 bf16 ulps of it)
TOL_MOE_DENSE = (1e-2, 2.0 ** -6)


def moe_config(layers, **moe):
    """phi3.5-moe at its widths, ``layers`` deep, its ``MoEConfig`` replaced
    by ``moe``."""
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(MOE_CONFIG)
    return dataclasses.replace(cfg, num_layers=layers,
                               moe=dataclasses.replace(cfg.moe, **moe))


def moe_routes(cfg, bp, h):
    """One MoE layer's router on ``h``, the block's hidden state after its
    attention: (the experts of each token as a sorted set (T, K), the
    router's probabilities (T, E))."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_norm
    xf = apply_norm(cfg, bp["ln2"], h).reshape(-1, cfg.d_model)
    _, top_idx, _ = moe.router(cfg, bp["moe"], xf)
    probs = torch.softmax(xf.float() @ bp["moe"]["w_router"].float(), -1)
    return top_idx.sort(-1).values, probs


def kth_gap(probs, k):
    """Each row's gap between its k-th and (k+1)-th largest probability."""
    s = probs.sort(-1, descending=True).values
    return s[:, k - 1] - s[:, k]


def flip_note(gaps):
    if not gaps:
        return "none"
    return (f"{len(gaps)}, their k-th / (k+1)-th probability gaps "
            f"{min(gaps):.3e} to {max(gaps):.3e}")


def moe_hold_layers(cfg, params, tokens):
    """Phase 15 (a)'s hold, each layer fed the reference backend's input to
    it: the attention update of backend "pallas" (the flash kernel) against
    "reference" (worst rel-RMS), the whole block's update (reported), the
    tokens the two route to other experts with their probability gaps, and
    each layer's share of token-expert pairs dropped at the config's
    capacity."""
    from repro_torch.models import model, moe
    h = model._embed(cfg, params, tokens)
    pos = model._positions(cfg, tokens)
    C = moe._capacity(cfg, tokens.numel())
    out = dict(attn=0.0, block=0.0, gaps=[], drops=[])
    for bp in model.all_layers(params):
        mix_p = model._mixer(cfg, bp, h, pos, backend="pallas")
        mix_r = model._mixer(cfg, bp, h, pos, backend="reference")
        out["attn"] = max(out["attn"], rel_rms(mix_p, mix_r))
        f_p, _ = model._ffn(cfg, bp, h + mix_p)
        f_r, _ = model._ffn(cfg, bp, h + mix_r)
        out["block"] = max(out["block"], rel_rms(mix_p + f_p, mix_r + f_r))
        if "moe" in bp:
            i_p, _ = moe_routes(cfg, bp, h + mix_p)
            i_r, probs = moe_routes(cfg, bp, h + mix_r)
            flipped = (i_p != i_r).any(-1)
            out["gaps"] += kth_gap(probs, cfg.moe.top_k)[flipped].tolist()
            keep = moe.dispatch_plan(cfg, i_r, C)[3]
            out["drops"].append(1.0 - float(keep.float().mean()))
        h = h + mix_r + f_r
    return out


def moe_forward(dev, card, cfg, params, tokens, labels):
    """Phase 15 (a): ``lm_loss(backend="pallas")`` at the cut depth, one
    flash launch a layer, held against "reference" layer by layer."""
    import torch
    from repro_torch.models import model
    tag = f"[moe forward {MOE_CONFIG}]"
    batch = {"tokens": tokens, "labels": labels}
    with torch.inference_mode():
        reset_counts()
        (loss, parts), first_s = wall(lambda: model.lm_loss(
            cfg, params, batch, backend="pallas"))
        launched = counts()
        _, steady_s = wall(lambda: model.lm_loss(cfg, params, batch,
                                                 backend="pallas"))
        (ref, ref_parts), ref_s = wall(lambda: model.lm_loss(
            cfg, params, batch, backend="reference"))
        held = moe_hold_layers(cfg, params, tokens)
    others = sum(n for k, n in launched.items() if k != "flash_attention")
    d_loss = abs(float(loss) - float(ref))
    print(f"{tag} lm_loss(backend='pallas') {float(loss):.6f} (aux "
          f"{float(parts['aux']):.6e}) in {first_s:.3f} s first call, "
          f"{steady_s:.3f} s steady; backend='reference' {float(ref):.6f} "
          f"(aux {float(ref_parts['aux']):.6e}) in {ref_s:.3f} s: loss "
          f"{d_loss:.3e} apart (tol {TOL_LM_LOSS:.0e}); kernel launches "
          f"{launched}; card {card}")
    print(f"{tag} on the reference's input to each layer: the attention "
          f"update (the flash kernel) {held['attn']:.3e} of its RMS from the "
          f"reference mixer's at worst (tol {TOL_LM_LAYER:.0e}); the whole "
          f"block {held['block']:.3e} (reported); tokens routed to other "
          f"experts: {flip_note(held['gaps'])}; pairs dropped at capacity "
          f"factor {cfg.moe.capacity_factor}: {min(held['drops']):.4f} to "
          f"{max(held['drops']):.4f} of the {cfg.moe.top_k * tokens.numel()} "
          f"a layer")
    if launched["flash_attention"] != cfg.num_layers or others:
        fail(f"{MOE_CONFIG}: {launched['flash_attention']} flash launches "
             f"(expected {cfg.num_layers}) and {others} of the others")
    if not (math.isfinite(float(loss)) and d_loss <= TOL_LM_LOSS
            and held["attn"] <= TOL_LM_LAYER):
        fail(f"{MOE_CONFIG}: backend 'pallas' disagrees with 'reference'")
    return dict(moe_launches=launched["flash_attention"],
                moe_path=(f"lm_loss({MOE_CONFIG}, {cfg.num_layers} of 32 "
                          f"layers, backend='pallas'), B=1, S={MOE_SEQ}"),
                moe_lm_first_s=first_s, moe_lm_steady_s=steady_s,
                moe_attn_worst=held["attn"], moe_block_worst=held["block"],
                moe_flips=len(held["gaps"]), moe_drop_share=held["drops"],
                moe_aux=(float(parts["aux"]), float(ref_parts["aux"])))


def moe_flash_reading(dev):
    """Phase 15 (a): the flash kernel at phi3.5's attention shape (H 32, Hkv
    8, dh 128), held against its twin and timed beside SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    H, Hkv, dh, S = 32, 8, 128, MOE_SEQ
    measures, (q, k, v), kernel, plain, _ = flash_case(dev, 1, S, H, Hkv,
                                                       dh, 0, 8)
    ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    flops, nb = flash_ops.work(1, S, H, Hkv, dh, 2)
    bound_ms, bound_by = bound(nb, (flops, BF16_PEAK))
    print(f"[moe flash] bf16 B=1 S={S} H={H} Hkv={Hkv} dh={dh} causal: "
          f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.3f} of the bound), scaled_dot_product_attention "
          f"{library_ms:.4f} ms, plain twin {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP)")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(ms=ms, library_ms=library_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, rel_rms=measures[0],
                worst_row=measures[1], shape=f"bf16, B=1, S={S}, H={H}, "
                                            f"Hkv={Hkv}, dh={dh}, causal")


def moe_hold_decode(cfg, params, seq, at):
    """Phase 15 (b)'s hold, as ``hold_decode_blocks`` builds each layer's
    cache from the pallas forward's input to it: the decode's attention
    update at position ``at`` against the forward's (the flash kernel;
    worst rel-RMS), and the whole decode block's update against the
    forward's where the two route that token to the same experts (worst),
    else reported with the token's probability gap."""
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model
    from repro_torch.models.layers import apply_norm
    h = model._embed(cfg, params, seq)
    pos = model._positions(cfg, seq)
    p_at = model._pos_tensor(at, seq.device)
    attn, block, flipped = 0.0, 0.0, []
    for i, bp in enumerate(model.all_layers(params)):
        mix_f = model._mixer(cfg, bp, h, pos, backend="pallas")
        f, _ = model._ffn(cfg, bp, h + mix_f)
        h_next = h + mix_f + f
        x_tok = h[:, at:at + 1]
        slices = layer_cache(cfg, bp, h[:, :at], pos[:, :at])
        mix_d, _, _ = attn_mod.decode_attention(
            cfg, bp["attn"], apply_norm(cfg, bp["ln1"], x_tok), slices["k"],
            slices["v"], p_at)
        attn = max(attn, rel_rms(mix_d, mix_f[:, at:at + 1]))
        out, _ = model._decode_block(cfg, x_tok, bp, slices, p_at)
        err = rel_rms(out - x_tok, h_next[:, at:at + 1] - x_tok)
        i_d, _ = moe_routes(cfg, bp, x_tok + mix_d)
        i_f, probs = moe_routes(cfg, bp, (h + mix_f)[:, at:at + 1])
        if torch.equal(i_d, i_f):
            block = max(block, err)
        else:
            flipped.append((i, err, float(kth_gap(probs, cfg.moe.top_k)[0])))
        h = h_next
    return attn, block, flipped


def moe_serve(dev, card, cfg, params):
    """Phase 15 (b): prefill of a 4096 prompt, 64 greedy decode steps, the
    decode held block by block against the dropless pallas forward."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import model
    tag = f"[moe serve {MOE_CONFIG}]"
    rng = np.random.default_rng(16)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, SERVE_PROMPT)),
                          device=dev)
    with torch.inference_mode():
        (logits, cache), first_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE))
        (logits, cache), steady_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE))
        if logits.shape != (1, cfg.vocab_padded) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"{MOE_CONFIG}: prefill logits not finite or not (1, "
                 f"{cfg.vocab_padded})")
        prefill_equals_its_layers(cfg, params, prompt, logits, cache)
        times, decoded, _ = timed_decode(
            cfg, params, cache, logits.argmax(-1, keepdim=True),
            SERVE_PROMPT, steps=SERVE_STEPS)
        prof = profile_decode(cfg, params, cache, decoded[:, -1:],
                              SERVE_CACHE - 4)
        parts, total, bound_ms = decode_reading(params, cache)
        experts = nbytes(params["blocks"]["moe"][w]
                         for w in ("we1", "we2", "we3"))
        routed = total - experts + experts * cfg.moe.top_k \
            // cfg.moe.num_experts
        routed_ms = 1e3 * routed / HBM_RATE
        p50, p99 = percentile_ms(times, 50), percentile_ms(times, 99)
        print(f"{tag} {cfg.num_layers} of 32 layers, bf16 random params; "
              f"prefill B=1, S={SERVE_PROMPT}, cache_len {SERVE_CACHE}: "
              f"{first_s:.4f} s first call, {steady_s:.4f} s steady, its "
              f"K/V and logits equal its layers run one by one; "
              f"{SERVE_STEPS} greedy decode_steps: p50 {p50:.4f} ms, p99 "
              f"{p99:.4f} ms per token; bounds: every expert read (the "
              f"reference's dispatch runs all {cfg.moe.num_experts} over "
              f"their 8 rows) {total} bytes, {bound_ms:.4f} ms ({parts}); "
              f"the routed experts only {routed} bytes, {routed_ms:.4f} ms; "
              f"p50 / bound {p50 / bound_ms:.2f}; {profile_note(prof, p50)}; "
              f"card {card}")
        pad = torch.tensor(rng.integers(
            0, cfg.vocab_size, (1, SERVE_YARDSTICK - SERVE_PROMPT
                                - SERVE_STEPS)), device=dev)
        seq = torch.cat([prompt, decoded, pad], dim=1)
        del cache
        dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_DROPLESS))
        reset_counts()
        (fwd, _), fwd_s = wall(lambda: model.forward_train(
            dropless, params, seq, backend="pallas"))
        launched = counts()
        del fwd
        attn, block, flipped = moe_hold_decode(dropless, params, seq,
                                               SERVE_PROMPT)
    others = sum(n for k, n in launched.items() if k != "flash_attention")
    print(f"{tag} yardstick forward_train(backend='pallas') over "
          f"{SERVE_YARDSTICK} tokens at capacity factor {MOE_DROPLESS} "
          f"(dropless, as a one-token decode is) in {fwd_s:.4f} s: "
          f"{launched['flash_attention']} flash launches, {others} of the "
          f"others; block by block at position {SERVE_PROMPT}: the decode's "
          f"attention update {attn:.3e} of its RMS from the forward's at "
          f"worst (tol {TOL_LM_LAYER:.0e}); the whole block "
          f"{block:.3e} where the two route the token alike (tol "
          f"{TOL_LM_LAYER:.0e}); layers where they route it otherwise "
          f"(layer, block difference, probability gap): {flipped}")
    if launched["flash_attention"] != cfg.num_layers or others:
        fail(f"{MOE_CONFIG}: the yardstick launched "
             f"{launched['flash_attention']} flash (expected "
             f"{cfg.num_layers}) and {others} others")
    if not (attn <= TOL_LM_LAYER and block <= TOL_LM_LAYER):
        fail(f"{MOE_CONFIG}: a decode block differs from the forward's")
    return dict(moe_serve_launches=launched["flash_attention"],
                moe_prefill_s=steady_s, moe_decode_p50_ms=p50,
                moe_decode_p99_ms=p99, moe_decode_bound_ms=bound_ms,
                moe_decode_routed_bound_ms=routed_ms,
                moe_decode_profile=prof, moe_decode_attn_worst=attn,
                moe_decode_block_worst=block, moe_decode_flips=flipped)


def dense_mix(cfg, p, xf, top_p, top_idx):
    """Every expert run on every token, each token's top-k outputs mixed by
    their probabilities in float32 (the twin of tests/test_substrates.py's
    dropless parity)."""
    import torch
    import torch.nn.functional as F
    out = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    for e in range(cfg.moe.num_experts):
        h = F.silu(xf @ p["we1"][e]) * (xf @ p["we3"][e])
        o = (h @ p["we2"][e]).float()
        for k in range(cfg.moe.top_k):
            w = torch.where(top_idx[:, k] == e, top_p[:, k], 0.0)
            out += o * w[:, None]
    return out


def moe_dispatch_card(dev, card):
    """Phase 15 (c): one MoE layer at full width, bf16, T 4096: the kept set
    on the card equal to the CPU's for the same router output; the dropless
    dispatch against the dense mix; the dispatch's time."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import moe
    cfg = moe_config(1)
    T, D = MOE_SEQ, cfg.d_model
    E, K, Fe = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert
    tag = "[moe dispatch]"
    p = moe.init_moe(cfg, torch.Generator(device=dev).manual_seed(3))
    x = torch.tensor(np.random.default_rng(17).standard_normal((1, T, D)),
                     dtype=torch.float32, device=dev).to(torch.bfloat16)
    xf = x.reshape(T, D)
    C = moe._capacity(cfg, T)
    with torch.inference_mode():
        top_p, top_idx, _ = moe.router(cfg, p, xf)
        card_plan = moe.dispatch_plan(cfg, top_idx, C)
        cpu_plan = moe.dispatch_plan(cfg, top_idx.cpu(), C)
        same = all(torch.equal(a.cpu(), b)
                   for a, b in zip(card_plan, cpu_plan))
        keep = card_plan[3]
        _, cpu_idx, _ = moe.router(cfg, {"w_router": p["w_router"].cpu()},
                                   xf.cpu())
        other = (cpu_idx.sort(-1).values
                 != top_idx.cpu().sort(-1).values).any(-1)
        probs = torch.softmax(xf.float() @ p["w_router"], -1)
        gaps = kth_gap(probs, K).cpu()[other].tolist()
        dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_DROPLESS))
        out, _ = moe._moe_dispatch(dropless, p, x)
        ref = dense_mix(cfg, p, xf, top_p, top_idx)
        out = out.reshape(T, D).float()
        rel = rel_rms(out, ref)
        worst = float((out - ref).abs().max() / ref.abs().max())
        ms = cuda_ms(lambda: moe._moe_dispatch(cfg, p, x), 10)
    flops = 3 * 2 * E * C * D * Fe
    bound_ms, bound_by = bound(3 * E * D * Fe * 2 + 2 * T * D * 2,
                               (flops, BF16_PEAK))
    print(f"{tag} {MOE_CONFIG} widths (E {E}, top {K}, D {D}, F {Fe}), bf16, "
          f"T {T}: at capacity factor {cfg.moe.capacity_factor} (C {C}) the "
          f"card's dispatch order, expert rows and kept set "
          f"{'equal' if same else 'DIFFER FROM'} the CPU's for the same "
          f"router output; {int(keep.sum())} of {T * K} pairs kept "
          f"({1 - float(keep.float().mean()):.4f} dropped); the CPU's "
          f"float32 router on the same input routes tokens otherwise: "
          f"{flip_note(gaps)} (reported); dropless (C {T}) against the "
          f"dense mix of each token's top-{K} experts: rel-RMS {rel:.3e} "
          f"(tol {TOL_MOE_DENSE[0]:.0e}), worst {worst:.3e} of the largest "
          f"|value| (tol {TOL_MOE_DENSE[1]:.1e}); _moe_dispatch at C {C} "
          f"{ms:.4f} ms on the card, plain PyTorch, against a bound of "
          f"{bound_ms:.4f} ms ({bound_by}); card {card}")
    if not same:
        fail("the kept set on the card differs from the CPU's")
    if not (rel <= TOL_MOE_DENSE[0] and worst <= TOL_MOE_DENSE[1]):
        fail("the dropless dispatch differs from the dense mix")
    del p, x, out, ref
    torch.cuda.empty_cache()
    return dict(kept_equal=same, dense_rel_rms=rel, dense_worst=worst,
                dispatch_ms=ms, dispatch_bound_ms=bound_ms,
                cpu_router_flips=len(gaps))


def moe_branches(dev, card):
    """Phase 15 (c): the shared expert and the dense prefix at phi3.5's
    widths, 2 layers: lm_loss(backend="pallas") (two flash launches, held
    as (a) holds), prefill and 4 decode steps through both stacks."""
    import numpy as np
    import torch
    from repro_torch.models import model
    cfg = moe_config(2, num_shared_experts=1, first_dense_layers=1)
    params = model.init_params(cfg, seed=4, device=dev)
    rng = np.random.default_rng(18)
    tokens, labels = (torch.tensor(rng.integers(0, cfg.vocab_size,
                                                (1, MOE_SEQ)), device=dev)
                      for _ in range(2))
    with torch.inference_mode():
        reset_counts()
        loss, parts = model.lm_loss(cfg, params, {"tokens": tokens,
                                                  "labels": labels},
                                    backend="pallas")
        launched = counts()
        held = moe_hold_layers(cfg, params, tokens)
        logits, cache = model.prefill(cfg, params, tokens[:, :-4],
                                      cache_len=MOE_SEQ)
        for t in range(4):
            logits, _ = model.decode_step(cfg, params, cache,
                                          tokens[:, t - 4:t - 3 or None],
                                          MOE_SEQ - 4 + t)
    finite = math.isfinite(float(loss)) and bool(
        torch.isfinite(logits).all())
    print(f"[moe branches] {MOE_CONFIG} widths, 2 layers: blocks_dense "
          f"{'blocks_dense' in params} (1 layer, d_ff {cfg.d_ff}), a shared "
          f"expert of width {params['blocks']['moe']['shared']['w1'].shape[-1]}"
          f"; lm_loss(backend='pallas') {float(loss):.6f}, aux "
          f"{float(parts['aux']):.6e}, launches {launched}; the attention "
          f"update {held['attn']:.3e} of its RMS from the reference's at "
          f"worst (tol {TOL_LM_LAYER:.0e}), the block {held['block']:.3e}; "
          f"prefill of {MOE_SEQ - 4} and 4 decode steps over both stacks "
          f"{'finite' if finite else 'NOT FINITE'}, the cache "
          f"{tuple(cache['k'].shape)}; card {card}")
    if not (finite and launched["flash_attention"] == 2
            and float(parts["aux"]) > 0 and held["attn"] <= TOL_LM_LAYER
            and cache["k"].shape[0] == 2):
        fail("the shared expert or the dense prefix failed on the card")
    del params, cache
    torch.cuda.empty_cache()


def moe_train_at(card, layers):
    """Phase 15 (d) at ``layers`` of phi3.5's layers."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import roofline, steps
    from repro_torch.models import model
    cfg = moe_config(layers)
    n_mb = cfg.train_microbatches
    params = model.init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in steps.param_leaves(params))
    batch = train_batch(cfg, n_mb, 0)
    with torch.no_grad():
        # the step's loss is the mean of its microbatches' (loss + aux),
        # each dispatched with its own capacity
        ref = sum(float(model.lm_loss(cfg, params, {
            k: v[i:i + 1] for k, v in batch.items()})[0])
            for i in range(n_mb)) / n_mb
    del batch
    torch.cuda.empty_cache()
    reset_counts()
    losses, secs, peak, _ = train_steps(cfg, params, TRAIN_STEPS, n_mb)
    launched = counts()
    del params
    torch.cuda.empty_cache()
    steady = sum(secs[1:]) / len(secs[1:])
    hw = roofline.hardware_spec(device="cuda")
    flops = roofline.model_flops(cfg, InputShape("train", TRAIN_SEQ, n_mb,
                                                 "train"),
                                 steps.abstract_params(cfg))
    d_loss = abs(losses[0] - ref) / abs(ref)
    print(f"[moe train] {MOE_CONFIG} widths, {layers} of 32 layers, "
          f"{n_params} params bf16, AdamW, remat {cfg.remat!r}; {n_mb} "
          f"microbatches of one {TRAIN_SEQ}-token sequence; losses {losses}; "
          f"s per step {secs} (steady {steady:.4f}); "
          f"{n_mb * TRAIN_SEQ / steady:.1f} tokens/s; peak {peak} bytes "
          f"allocated; active model FLOPs {flops:.4e} a step, "
          f"{flops / (steady * hw.peak_flops):.4f} of {hw.name}'s "
          f"{hw.peak_flops:.3e} FLOP/s; the first loss against its "
          f"microbatches' separate lm_loss (aux included) {ref:.6f}: "
          f"{d_loss:.3e} relative (tol {TOL_TRAIN_LOSS:.0e}); kernel "
          f"launches {launched}; card {card}")
    if not all(math.isfinite(x) for x in losses) or d_loss > TOL_TRAIN_LOSS:
        fail(f"{MOE_CONFIG}: train losses {losses}, separate {ref}")
    if any(launched.values()):
        fail(f"{MOE_CONFIG}: the train step launched kernels {launched}")
    return dict(layers=layers, losses=losses, s_per_step=secs,
                steady_s=steady, tokens_per_s=n_mb * TRAIN_SEQ / steady,
                peak_bytes=peak, mfu=flops / (steady * hw.peak_flops))


def moe_train(card):
    """Phase 15 (d): ``make_train_step`` at phi3.5's widths, 3 layers, or 2
    where 3 run out of the card's memory."""
    import gc
    import torch
    for layers in MOE_TRAIN_LAYERS:
        try:
            return moe_train_at(card, layers)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[moe train] {layers} layers ran out of memory "
                  f"({str(e)[:120]}...); next: fewer layers")
        gc.collect()
        torch.cuda.empty_cache()
    fail(f"{MOE_CONFIG}: no depth of {MOE_TRAIN_LAYERS} trained on the card")


def train_script(card, name):
    """The training script on ``name``'s reduced config, on the card,
    through the ``main(argv)`` its ``python -m`` entry point runs (phase
    19 (d) runs it as a subprocess)."""
    import io
    from repro_torch.launch import train as train_mod
    argv = ["--arch", name, "--reduced", "--steps", "20"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            _, secs = wall(lambda: train_mod.main(argv))
    except (AssertionError, RuntimeError) as e:
        fail(f"launch.train {name}: {e!r}\n{buf.getvalue()[-2000:]}")
    lines = buf.getvalue().strip().splitlines()
    print(f"[script] repro_torch.launch.train.main({' '.join(argv)}): "
          f"returned in {secs:.3f} s; last lines {lines[-2:]}; card {card}")


def moe_path(card):
    """Phase 15: the mixture of experts on the card.  Returns the flash
    row's readings."""
    import numpy as np
    import torch
    from repro_torch.models import model
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    cfg = moe_config(MOE_LAYERS)
    params, secs = wall(lambda: model.init_params(cfg, seed=0, device=dev))
    n = sum(x.numel() for x in leaves(params))
    print(f"[moe] {MOE_CONFIG}: {MOE_LAYERS} of 32 layers at full width, "
          f"{n} params ({2 * n / 1e9:.2f} GB bf16) drawn on the card in "
          f"{secs:.3f} s; capacity factor {cfg.moe.capacity_factor}, impl "
          f"{cfg.moe.impl!r} (no mesh: one dispatch, no waves)")
    rng = np.random.default_rng(19)
    tokens, labels = (torch.tensor(rng.integers(0, cfg.vocab_size,
                                                (1, MOE_SEQ)), device=dev)
                      for _ in range(2))
    out = moe_forward(dev, card, cfg, params, tokens, labels)
    out.update(moe_serve(dev, card, cfg, params))
    del params
    torch.cuda.empty_cache()
    out["moe_shape"] = moe_flash_reading(dev)
    out["moe_dispatch"] = moe_dispatch_card(dev, card)
    moe_branches(dev, card)
    out["moe_train"] = moe_train(card)
    train_script(card, MOE_CONFIG)
    return out


HYBRID_CONFIG = "hymba-1.5b"
# (b) the two-level doubling scan against the step-by-step oracle on one
# layer's own dA, dBx and C, float32 on the card: the same products in
# another order, a few ulp apart (the CPU reads 1.2e-7 to 5.5e-7 of the
# output's RMS at reduced width): the rel-RMS of y, and the last state's
# worst |difference| over its largest |value|
TOL_MAMBA_SCAN = 1e-5


def hybrid_attention_hold(cfg, params, tokens):
    """Phase 16 (a): on the reference backend's input to each layer, the
    attention branch through the flash kernel (backend "pallas") against
    the reference mixer's; -> the worst rel-RMS."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model
    from repro_torch.models.layers import apply_norm
    h = model._embed(cfg, params, tokens)
    pos = model._positions(cfg, tokens)
    worst = 0.0
    for bp in model.all_layers(params):
        hn = apply_norm(cfg, bp["ln1"], h)
        a_p, a_r = (attn_mod.apply_attention(cfg, bp["hyb"]["attn"], hn, pos,
                                             backend=b)
                    for b in ("pallas", "reference"))
        worst = max(worst, rel_rms(a_p, a_r))
        h = model._block_body(cfg, h, bp, positions=pos)[0]
    return worst


def hybrid_flash_reading(dev, card):
    """Phase 16 (a): the flash kernel at hymba's attention shape (H 25 over
    Hkv 5, dh 64, window 1024: from query tile 9 on, the key tiles before
    the window are skipped) held against its plain twin and the tile-exact
    oracle, timed beside SDPA under the window's mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops
    cfg = get_config(HYBRID_CONFIG)
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    S, W = TRAIN_SEQ, cfg.sliding_window
    measures, (q, k, v), kernel, plain, ref = flash_case(dev, 1, S, H, Hkv,
                                                         dh, W, 9)
    tiled = flash_measures(kernel(), ops.flash_attention_tiled(
        q, k, v, causal=True, sliding_window=W))
    if not flash_held(f"bfloat16 B=1 S={S} H={H} Hkv={Hkv} dh={dh} causal "
                      f"window={W}, kernel vs tiled", tiled,
                      "tiled bfloat16"):
        fail("flash_attention at hymba's shape differs from the tile-exact "
             "oracle")
    ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
    # SDPA: K / V repeated to the query heads (query head h reads KV head
    # h // 5), the window as an additive bf16 mask built once
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
              .contiguous() for x in (k, v))
    mask = torch.zeros((S, S), dtype=q.dtype, device=dev).masked_fill(
        ~ops.causal_mask(S, S, W, dev)[0], float("-inf"))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    sdpa_rel = rel_rms(sdpa().transpose(1, 2), ref)
    library_ms = cuda_ms(sdpa, 20)
    # the backend SDPA's dispatcher picks for these inputs
    from torch.nn.attention import SDPBackend
    names = {b.value: name for name, b in SDPBackend.__members__.items()}
    sdpa_ran = names.get(int(torch._fused_sdp_choice(qt, kt, vt,
                                                     attn_mask=mask)))
    flops, nb = ops.work(1, S, H, Hkv, dh, 2, sliding_window=W)
    bound_ms, bound_by = bound(nb, (flops, BF16_PEAK))
    print(f"[hybrid flash] bf16 B=1 S={S} H={H} Hkv={Hkv} dh={dh} causal, "
          f"window {W}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.3f} of the windowed bound), plain twin "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention (mask, K/V "
          f"repeated) {library_ms:.4f} ms on its {sdpa_ran} backend, its "
          f"output {sdpa_rel:.3e} of the twin's RMS away; bound "
          f"{bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP bf16 over "
          f"the window's visible pairs, {nb / 1e6:.4f} MB); card {card}")
    if bound_ms / ms >= 1:
        fail(f"the flash kernel at hymba's shape reads {bound_ms / ms:.3f} of "
             f"its bound: the bound's count is wrong")
    del q, k, v, qt, kt, vt, mask, ref
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library_backend=sdpa_ran, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / ms,
                tflops=flops / ms / 1e9, rel_rms=measures[0],
                worst_row=measures[1], vs_tiled_rel_rms=tiled[0],
                vs_tiled_worst_row=tiled[1],
                shape=f"bf16, B=1, S={S}, H={H}, Hkv={Hkv}, dh={dh}, causal, "
                      f"window {W}")


def hybrid_mamba(dev, card, cfg, params):
    """Phase 16 (b): the Mamba branch of one layer at full width, B 1, S
    4096: the two-level scan against the step-by-step oracle on the
    layer's own inputs in float32; the branch's ms, kernels and peak bytes,
    forward and forward + backward."""
    import numpy as np
    import torch
    from repro_torch.models import model, ssm
    mp = model.layer(params["blocks"], 0)["hyb"]["mamba"]
    S, D = TRAIN_SEQ, cfg.d_model
    x = torch.tensor(np.random.default_rng(21).standard_normal((1, S, D)),
                     dtype=torch.float32, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        dA, dBx, C, _, _, _ = ssm.mamba_discretize(cfg, mp, x)
        h0 = torch.zeros(dA.shape[:1] + dA.shape[2:], device=dev)
        (y2, s2), scan_s = wall(lambda: ssm.mamba_scan(dA, dBx, C, h0))
        (y1, s1), seq_s = wall(lambda: ssm.mamba_scan_sequential(dA, dBx, C,
                                                                 h0))
        rel = rel_rms(y2, y1)
        st = float((s2 - s1).abs().max() / s1.abs().max())
        del y1, y2, s1, s2
        scan_ms = cuda_ms(lambda: ssm.mamba_scan(dA, dBx, C, h0), 5)
        prof_scan = profile_step(lambda: ssm.mamba_scan(dA, dBx, C, h0))
        del dA, dBx, C
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ssm.apply_mamba(cfg, mp, x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cuda_ms(lambda: ssm.apply_mamba(cfg, mp, x), 5)
        prof = profile_step(lambda: ssm.apply_mamba(cfg, mp, x))
    xg = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, _, _ = ssm.apply_mamba(cfg, mp, xg)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    grad_peak = torch.cuda.max_memory_allocated() - base
    del out, xg
    torch.cuda.empty_cache()
    kernels = prof[0] if prof else "not measured"
    scan_kernels = prof_scan[0] if prof_scan else "not measured"
    print(f"[hybrid mamba] one layer's Mamba branch at full width (D {D}, "
          f"d_inner {mp['Dskip'].shape[0]}, n {cfg.ssm.state_size}), bf16, B=1, "
          f"S={S}: the two-level doubling scan against the step-by-step "
          f"oracle on the layer's own float32 inputs, y {rel:.3e} of its "
          f"RMS (tol {TOL_MAMBA_SCAN:.0e}), the last state {st:.3e} of its "
          f"largest |value| (tol {TOL_MAMBA_SCAN:.0e}); the scan {scan_s:.4f} "
          f"s first call, the oracle {seq_s:.4f} s; device times: "
          f"apply_mamba {ms:.4f} ms ({kernels} kernels, torch.profiler), the "
          f"scan alone {scan_ms:.4f} ms ({scan_kernels} kernels); peak "
          f"{peak} bytes above the inputs (forward, inference), {grad_peak} "
          f"bytes (forward and backward of the input's gradient); card "
          f"{card}")
    if not (rel <= TOL_MAMBA_SCAN and st <= TOL_MAMBA_SCAN):
        fail("the Mamba scan on the card differs from its step-by-step "
             "oracle")
    return dict(ms=ms, kernels=kernels, top=prof[2] if prof else None,
                scan_ms=scan_ms, scan_kernels=scan_kernels,
                peak_bytes=peak, grad_peak_bytes=grad_peak,
                scan_vs_sequential_rel_rms=rel, state_worst=st)


def hybrid_serve(dev, card, cfg, params):
    """Phase 16 (c): prefill of a 4096 prompt (its cache, Mamba states
    included, equal to its layers run one by one), 64 greedy decode steps,
    the decode held block by block against the pallas forward at position
    4096, past the window of 1024."""
    import numpy as np
    import torch
    from repro_torch.models import model
    tag = f"[hybrid serve {HYBRID_CONFIG}]"
    rng = np.random.default_rng(22)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, SERVE_PROMPT)),
                          device=dev)
    with torch.inference_mode():
        (logits, cache), first_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE))
        (logits, cache), steady_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE))
        if logits.shape != (1, cfg.vocab_padded) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"{HYBRID_CONFIG}: prefill logits not finite or not (1, "
                 f"{cfg.vocab_padded})")
        prefill_equals_its_layers(cfg, params, prompt, logits, cache)
        leaves_bytes = {k: nbytes([v]) for k, v in cache.items()}
        times, decoded, _ = timed_decode(
            cfg, params, cache, logits.argmax(-1, keepdim=True),
            SERVE_PROMPT, steps=SERVE_STEPS)
        prof = profile_decode(cfg, params, cache, decoded[:, -1:],
                              SERVE_CACHE - 4)
        parts, total, bound_ms = decode_reading(params, cache)
        p50, p99 = percentile_ms(times, 50), percentile_ms(times, 99)
        print(f"{tag} 32 layers, bf16 random params; prefill B=1, "
              f"S={SERVE_PROMPT}, cache_len {SERVE_CACHE}: {first_s:.4f} s "
              f"first call, {steady_s:.4f} s steady; cache bytes "
              f"{leaves_bytes}; its K/V, conv and SSM states and logits "
              f"equal its layers run one by one; {SERVE_STEPS} greedy "
              f"decode_steps: p50 {p50:.4f} ms, p99 {p99:.4f} ms per token; "
              f"the bound {bound_ms:.4f} ms: {total} bytes read a token "
              f"({parts}) at 3.35 TB/s; p50 / bound {p50 / bound_ms:.2f}; "
              f"{profile_note(prof, p50)}; card {card}")
        pad = torch.tensor(rng.integers(
            0, cfg.vocab_size, (1, SERVE_YARDSTICK - SERVE_PROMPT
                                - SERVE_STEPS)), device=dev)
        seq = torch.cat([prompt, decoded, pad], dim=1)
        del cache
        reset_counts()
        (fwd, _), fwd_s = wall(lambda: model.forward_train(
            cfg, params, seq, backend="pallas"))
        launched = counts()
        del fwd
        worst, _ = hold_decode_blocks(cfg, params, seq, SERVE_PROMPT)
    others = sum(n for k, n in launched.items() if k != "flash_attention")
    print(f"{tag} yardstick forward_train(backend='pallas') over "
          f"{SERVE_YARDSTICK} tokens in {fwd_s:.4f} s: "
          f"{launched['flash_attention']} flash launches, {others} of the "
          f"others; block by block on the forward's input to each layer "
          f"(its K/V, conv and SSM states built from the first "
          f"{SERVE_PROMPT} positions), the decode block's update at "
          f"position {SERVE_PROMPT} (window {cfg.sliding_window}) is "
          f"{worst:.3e} of its RMS from the forward's at worst (tol "
          f"{TOL_LM_LAYER:.0e})")
    if launched["flash_attention"] != cfg.num_layers or others:
        fail(f"{HYBRID_CONFIG}: the yardstick launched "
             f"{launched['flash_attention']} flash (expected "
             f"{cfg.num_layers}) and {others} others")
    if not worst <= TOL_LM_LAYER:
        fail(f"{HYBRID_CONFIG}: a decode block differs from the pallas "
             f"forward's")
    return dict(hymba_serve_launches=launched["flash_attention"],
                hymba_prefill_s=steady_s, hymba_prefill_first_s=first_s,
                hymba_cache_bytes=sum(leaves_bytes.values()),
                hymba_decode_p50_ms=p50, hymba_decode_p99_ms=p99,
                hymba_decode_bound_ms=bound_ms,
                hymba_decode_profile=prof, hymba_decode_block_worst=worst)


def hybrid_train(card):
    """Phase 16 (d): ``make_train_step`` of hymba-1.5b at full width and
    depth, AdamW, remat "full", 4 microbatches of one 4096-token
    sequence, 2 steps; then one microbatch's forward and backward under
    ``torch.profiler``."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import roofline, steps
    from repro_torch.models import model
    cfg = get_config(HYBRID_CONFIG)
    n_mb = cfg.train_microbatches
    params = model.init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in steps.param_leaves(params))
    batch = train_batch(cfg, n_mb, 0)
    with torch.no_grad():
        ref = sum(float(model.lm_loss(cfg, params, {
            k: v[i:i + 1] for k, v in batch.items()})[0])
            for i in range(n_mb)) / n_mb
    del batch
    torch.cuda.empty_cache()
    reset_counts()
    losses, secs, peak, _ = train_steps(cfg, params, TRAIN_STEPS, n_mb)
    launched = counts()
    # one microbatch's forward and backward under torch.profiler: a quarter
    # of a step's kernels (the profiler takes ~40 s over a whole step's)
    trainable = steps.param_leaves(params)
    mb = train_batch(cfg, 1, TRAIN_STEPS)
    for p in trainable:
        p.requires_grad_(True)
    prof = profile_step(lambda: torch.autograd.grad(
        model.lm_loss(cfg, params, mb)[0], trainable))
    del params, trainable, mb
    torch.cuda.empty_cache()
    steady = sum(secs[1:]) / len(secs[1:])
    hw = roofline.hardware_spec(device="cuda")
    flops = roofline.model_flops(cfg, InputShape("train", TRAIN_SEQ, n_mb,
                                                 "train"),
                                 steps.abstract_params(cfg))
    d_loss = abs(losses[0] - ref) / abs(ref)
    note = "not measured (no device time in the trace)" if prof is None \
        else (f"{prof[0]} kernels, the card busy {prof[1]:.1f} ms "
              f"({100 * (1 - prof[1] * n_mb / (1e3 * steady)):.1f}% idle "
              f"against a quarter of the steady step), the heaviest "
              f"{prof[2]}")
    print(f"[hybrid train] {HYBRID_CONFIG}, 32 layers, {n_params} params "
          f"bf16, AdamW, remat {cfg.remat!r}; {n_mb} microbatches of one "
          f"{TRAIN_SEQ}-token sequence; losses {losses}; s per step {secs} "
          f"(steady {steady:.4f}); {n_mb * TRAIN_SEQ / steady:.1f} "
          f"tokens/s; peak {peak} bytes allocated; model FLOPs "
          f"{flops:.4e} a step, {flops / (steady * hw.peak_flops):.4f} of "
          f"{hw.name}'s {hw.peak_flops:.3e} FLOP/s; the first loss against "
          f"its microbatches' separate lm_loss {ref:.6f}: {d_loss:.3e} "
          f"relative (tol {TOL_TRAIN_LOSS:.0e}); kernel launches "
          f"{launched}; one microbatch's forward and backward under "
          f"torch.profiler: {note}; card {card}")
    if not all(math.isfinite(x) for x in losses) or d_loss > TOL_TRAIN_LOSS:
        fail(f"{HYBRID_CONFIG}: train losses {losses}, separate {ref}")
    if any(launched.values()):
        fail(f"{HYBRID_CONFIG}: the train step launched kernels {launched}")
    return dict(losses=losses, s_per_step=secs, steady_s=steady,
                tokens_per_s=n_mb * TRAIN_SEQ / steady, peak_bytes=peak,
                mfu=flops / (steady * hw.peak_flops), profile=prof)


def hybrid_path(card):
    """Phase 16: the hybrid family on the card.  Returns the flash row's
    readings."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    out = {}
    (out["hymba_launches"], out["hymba_lm_first_s"],
     out["hymba_lm_steady_s"]) = run_lm(dev, HYBRID_CONFIG, TRAIN_SEQ,
                                        "flash_attention")
    out["hymba_path"] = (f"lm_loss({HYBRID_CONFIG}, backend='pallas'), B=1, "
                         f"S={TRAIN_SEQ}, window 1024")
    cfg = get_config(HYBRID_CONFIG)
    params = model.init_params(cfg, seed=0, device=dev)
    tokens = torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, TRAIN_SEQ)), device=dev)
    with torch.inference_mode():
        attn = hybrid_attention_hold(cfg, params, tokens)
    print(f"[hybrid forward] on the reference's input to each layer, the "
          f"attention branch through the flash kernel (window "
          f"{cfg.sliding_window}) {attn:.3e} of its RMS from the reference "
          f"mixer's at worst (tol {TOL_LM_LAYER:.0e})")
    if attn > TOL_LM_LAYER:
        fail(f"{HYBRID_CONFIG}: the flash kernel's attention branch differs "
             f"from the reference mixer's")
    out["hymba_attn_worst"] = attn
    out["hymba_shape"] = hybrid_flash_reading(dev, card)
    out["hymba_mamba"] = hybrid_mamba(dev, card, cfg, params)
    out.update(hybrid_serve(dev, card, cfg, params))
    del params
    torch.cuda.empty_cache()
    out["hymba_train"] = hybrid_train(card)
    train_script(card, HYBRID_CONFIG)
    return out


DEEPSEEK_CONFIG = "deepseek-v3-671b"
# phase 17's depths of deepseek-v3's 61 layers, every width kept (random
# bf16 params; 671 B params do not fit one card): (a) and (b) the 3 dense
# prefix layers and 2 MoE layers with the MTP head (27.2 B params, 54.4
# GB); (c) the gradient at 3 dense + 1 MoE layer (31.4 GB of params and as
# much of gradients) over 4096 tokens, which runs out of the card's memory
# on an H100 (the two float32 logits of 2.1 GB each and their softmax
# beside 62.8 GB), so over 1024 tokens (the first cut tried), else 1 + 1
# layers; (d)
# the train step at the dense prefix and the MTP head alone (no MoE
# layer: Adafactor's float32 temporaries of one (1, 256, 7168, 2048)
# expert leaf are 15 GB each beside the params and gradients)
DS_LAYERS, DS_TRAIN_LAYERS = 5, 3
DS_GRAD_CUTS = ((4, 1024), (2, 4096))      # (layers, tokens)
DS_SEQ, DS_DECODE_STEPS = 4096, 16
# (b) the yardstick forward over 4097 tokens is dropless, as a one-token
# decode is: capacity factor E / K (C >= every wave's tokens, whatever the
# routing; random weights route so lopsidedly that at cf 8, C 1032, a
# pair of the held token was dropped on the card), its MoE dispatched in
# waves of 241 tokens (4097 = 17 x 241) through the config's "gspmd"
# path so that the (E, C, D) buffer stays ~1 GB; every pair kept is
# checked
DS_YARDSTICK_WAVE = 241
# (a) each layer's update in bf16 against the card's own float32
# recomputation of the same layer on the same input and the same routing
# (float32 copies of the layer's weights, float32 compute): MLA rounds its
# six products, its two latent norms and its softmax weights to bf16 (2^-9
# relative each), the SwiGLU and the experts their three products, the
# combine its K adds; a few bf16 ulps of the update's RMS, as phase 4
# holds two bf16 paths: TOL_LM_LAYER.  Repeats of the bf16 forward: the
# combine adds in one fixed order and the GEMMs' are fixed for a shape, so
# they should agree to the bit; held within TOL_DS_REPEAT of the loss,
# the spread printed
TOL_DS_REPEAT = 1e-3
# (b) the reference's test_prefill_decode_consistency gate: max |decode -
# forward| over max |forward| of the logits at the decoded position
TOL_DS_DECODE = 0.05


def ds_config(layers, moe=True):
    """deepseek-v3 at its widths, ``layers`` deep: its 3 dense prefix
    layers (fewer where ``layers`` is 3 or less, leaving one MoE layer)
    and MoE layers after them, or with ``moe=False`` dense layers only."""
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(DEEPSEEK_CONFIG)
    if not moe:
        return dataclasses.replace(cfg, num_layers=layers, moe=None)
    dense = min(cfg.moe.first_dense_layers, layers - 1)
    return dataclasses.replace(cfg, num_layers=layers, moe=dataclasses.replace(
        cfg.moe, first_dense_layers=dense))


def ds_moe_float32(cfg, p, x):
    """One MoE layer in float32 on ``x``, with the bf16 run's routing and
    kept pairs (the router is float32 in both): each expert's kept rows
    through float32 copies of its weights, their outputs times their
    probabilities summed per token in float32, plus the shared expert."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    xf = x.reshape(T, D)
    top_p, top_idx, _ = moe.router(cfg, p, xf)
    order, e_s, _, keep = moe.dispatch_plan(cfg, top_idx,
                                            moe._capacity(cfg, T))
    t_s, p_s = order // cfg.moe.top_k, top_p.reshape(-1)[order]
    x32 = xf.float()
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e in range(cfg.moe.num_experts):
        sel = (e_s == e) & keep
        t = t_s[sel]
        xe = x32[t]
        h = F.silu(xe @ p["we1"][e].float()) * (xe @ p["we3"][e].float())
        y.index_add_(0, t, (h @ p["we2"][e].float()) * p_s[sel][:, None])
    sp = float32_copy(p["shared"])
    y += (F.silu(x32 @ sp["w1"]) * (x32 @ sp["w3"])) @ sp["w2"]
    return y.reshape(x.shape), 1.0 - float(keep.float().mean())


def ds_hold_layers(cfg, params, tokens):
    """Phase 17 (a)'s hold on the bf16 forward's own hidden states: each
    layer's MLA update and FFN (or MoE) update against the card's float32
    recomputation of that layer (worst rel-RMS of each), each MoE layer's
    share of pairs dropped at the config's capacity, and the MTP term of
    the blocks' output."""
    import dataclasses
    from repro_torch.models import mla, model
    from repro_torch.models.layers import apply_mlp, apply_norm
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    h = model._embed(cfg, params, tokens)
    pos = model._positions(cfg, tokens)
    out = dict(mla=0.0, ffn=0.0, moe=0.0, drops=[])
    for bp in model.all_layers(params):
        hn = apply_norm(cfg, bp["ln1"], h)
        mix = model._mixer(cfg, bp, h, pos)
        mix32 = mla.apply_mla(cfg32, float32_copy(bp["mla"]), hn.float(), pos)
        out["mla"] = max(out["mla"], rel_rms(mix, mix32))
        h = h + mix
        f, _ = model._ffn(cfg, bp, h)
        hn = apply_norm(cfg, bp["ln2"], h)
        if "moe" in bp:
            f32, dropped = ds_moe_float32(cfg, bp["moe"], hn)
            out["moe"] = max(out["moe"], rel_rms(f, f32))
            out["drops"].append(dropped)
        else:
            f32 = apply_mlp(cfg32, float32_copy(bp["ffn"]), hn.float())
            out["ffn"] = max(out["ffn"], rel_rms(f, f32))
        h = h + f
    out["mtp"] = float(model._mtp_loss(cfg, params, h, tokens))
    return out


def ds_forward(dev, card, cfg, params, tokens, labels):
    """Phase 17 (a): ``lm_loss`` with backend "pallas" (a first and a
    steady call) and "reference": no kernel launched, the three losses
    alike; the layers held against their float32 recomputation."""
    import torch
    from repro_torch.models import model
    tag = f"[deepseek forward {DEEPSEEK_CONFIG}]"
    batch = {"tokens": tokens, "labels": labels}
    with torch.inference_mode():
        reset_counts()
        (loss, parts), first_s = wall(lambda: model.lm_loss(
            cfg, params, batch, backend="pallas"))
        (again, _), steady_s = wall(lambda: model.lm_loss(
            cfg, params, batch, backend="pallas"))
        (ref, ref_parts), ref_s = wall(lambda: model.lm_loss(
            cfg, params, batch, backend="reference"))
        launched = counts()
        held = ds_hold_layers(cfg, params, tokens)
    losses = [float(loss), float(again), float(ref)]
    spread = max(losses) - min(losses)
    router = float(parts["aux"]) - held["mtp"]
    print(f"{tag} lm_loss(backend='pallas') {losses[0]:.6f} in {first_s:.3f} "
          f"s first call, {losses[1]:.6f} in {steady_s:.3f} s steady; "
          f"backend='reference' {losses[2]:.6f} in {ref_s:.3f} s: spread "
          f"{spread:.3e} (tol {TOL_DS_REPEAT:.0e}; bit-equal "
          f"{len(set(losses)) == 1}); kernel launches over the three "
          f"{launched}; aux {float(parts['aux']):.6f}: the MTP term "
          f"{held['mtp']:.6f}, the routers' {router:.6e}; card {card}")
    print(f"{tag} on the bf16 forward's input to each layer against the "
          f"card's float32 recomputation of it (same routing): MLA's "
          f"update {held['mla']:.3e} of its RMS at worst, the dense FFN's "
          f"{held['ffn']:.3e}, the MoE's {held['moe']:.3e} (tol "
          f"{TOL_LM_LAYER:.0e}); pairs dropped at capacity factor "
          f"{cfg.moe.capacity_factor} per MoE layer {held['drops']}")
    if any(launched.values()):
        fail(f"{DEEPSEEK_CONFIG}: the forward launched kernels {launched}; "
             f"MLA and the experts run none")
    if not (all(math.isfinite(x) for x in losses) and spread <= TOL_DS_REPEAT
            and math.isfinite(held["mtp"]) and held["mtp"] > 0):
        fail(f"{DEEPSEEK_CONFIG}: losses {losses}, MTP {held['mtp']}")
    if max(held["mla"], held["ffn"], held["moe"]) > TOL_LM_LAYER:
        fail(f"{DEEPSEEK_CONFIG}: a layer differs from its float32 "
             f"recomputation")
    return dict(lm_first_s=first_s, lm_steady_s=steady_s, losses=losses,
                spread=spread, aux=float(parts["aux"]), mtp=held["mtp"],
                mla_worst=held["mla"], ffn_worst=held["ffn"],
                moe_worst=held["moe"], drop_share=held["drops"],
                launches=sum(launched.values()))


def ds_serve(dev, card, cfg, params):
    """Phase 17 (b): prefill of a 4096 prompt into a cache of 4160, 16
    greedy absorbed-form decode steps, the first held against the expanded
    forward's logits at position 4096."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import model, moe
    tag = f"[deepseek serve {DEEPSEEK_CONFIG}]"
    rng = np.random.default_rng(23)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, SERVE_PROMPT)),
                          device=dev)
    with torch.inference_mode():
        (logits, cache), first_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE))
        (logits, cache), steady_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE))
        if logits.shape != (1, cfg.vocab_padded) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"{DEEPSEEK_CONFIG}: prefill logits not finite or not (1, "
                 f"{cfg.vocab_padded})")
        cache_bytes = {k: nbytes([v]) for k, v in cache.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        dec_routes = []
        with observed(moe, "router", after=lambda out: dec_routes.append(
                out[1][-1].sort().values)):
            times, decoded, first = timed_decode(
                cfg, params, cache, logits.argmax(-1, keepdim=True),
                SERVE_PROMPT, steps=DS_DECODE_STEPS)
        launched = counts()
        prof = profile_decode(cfg, params, cache, decoded[:, -1:],
                              SERVE_PROMPT + DS_DECODE_STEPS)
        peak = torch.cuda.max_memory_allocated()
        parts, total, bound_ms = decode_reading(params, cache)
        p50, p99 = percentile_ms(times, 50), percentile_ms(times, 99)
        del cache
        torch.cuda.empty_cache()
        # the expanded forward over the prompt and the first decoded token,
        # dropless; its logits at position 4096
        seq = torch.cat([prompt, decoded[:, :1]], dim=1)
        dropless = dataclasses.replace(cfg, mtp=False, moe=dataclasses.replace(
            cfg.moe, impl="gspmd",
            capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        kept, fwd_routes = [], []
        wave = moe.MOE_TOKEN_WAVE
        moe.MOE_TOKEN_WAVE = DS_YARDSTICK_WAVE
        try:
            with observed(moe, "dispatch_plan",
                          after=lambda out: kept.append(bool(out[3].all()))), \
                    observed(moe, "router", after=lambda out:
                             fwd_routes.append(out[1][-1].sort().values)):
                (fwd, _), fwd_s = wall(lambda: model.forward_train(
                    dropless, params, seq))
        finally:
            moe.MOE_TOKEN_WAVE = wave
        ref = fwd[:, SERVE_PROMPT]
        del fwd
        # the held token's experts at each MoE layer: the last wave's last
        # row in the forward, the first decode step's
        waves = seq.shape[1] // DS_YARDSTICK_WAVE
        fwd_routes = fwd_routes[waves - 1::waves]
        alike = [bool(torch.equal(a, b))
                 for a, b in zip(fwd_routes, dec_routes[:len(fwd_routes)])]
    ratio = float((first - ref).abs().max() / ref.abs().max())
    m = cfg.mla
    per_token = (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    expanded = 2 * cfg.num_heads * m.v_head_dim * 2
    print(f"{tag} {cfg.num_layers} of 61 layers (3 dense, "
          f"{cfg.num_layers - 3} MoE), bf16 random params; prefill B=1, "
          f"S={SERVE_PROMPT}, cache_len {SERVE_CACHE}: {first_s:.4f} s first "
          f"call, {steady_s:.4f} s steady; cache bytes {cache_bytes}: "
          f"{per_token} bytes a token and layer ((512 + 64) x 2) against "
          f"{expanded} for an expanded K/V cache (2 x 128 x 128 x 2); "
          f"{DS_DECODE_STEPS} greedy absorbed-form decode_steps: p50 "
          f"{p50:.4f} ms, p99 {p99:.4f} ms per token, kernel launches "
          f"{launched}; the bound {bound_ms:.4f} ms: {total} bytes read a "
          f"token ({parts}; the reference's dispatch runs all "
          f"{cfg.moe.num_experts} experts over their 8 rows) at 3.35 TB/s; "
          f"p50 / bound {p50 / bound_ms:.2f}; {profile_note(prof, p50)}; "
          f"peak {peak} bytes allocated while decoding; card {card}")
    print(f"{tag} the absorbed-form decode at position {SERVE_PROMPT} "
          f"against the expanded forward_train over {seq.shape[1]} tokens "
          f"(dropless: capacity factor {dropless.moe.capacity_factor}, "
          f"waves of {DS_YARDSTICK_WAVE} tokens; every pair kept: "
          f"{all(kept)}) in {fwd_s:.3f} s: max|decode - forward| / "
          f"max|forward| of the logits {ratio:.4e} (tol {TOL_DS_DECODE}); "
          f"the held token routed alike at each MoE layer: {alike}")
    if any(launched.values()):
        fail(f"{DEEPSEEK_CONFIG}: decode launched kernels {launched}")
    if not (all(kept) and ratio < TOL_DS_DECODE):
        fail(f"{DEEPSEEK_CONFIG}: the decode at {SERVE_PROMPT} differs from "
             f"the forward's logits")
    return dict(prefill_s=steady_s, prefill_first_s=first_s,
                cache_bytes=sum(cache_bytes.values()), decode_p50_ms=p50,
                decode_p99_ms=p99, decode_bound_ms=bound_ms,
                decode_profile=prof, decode_peak_bytes=peak,
                decode_vs_forward=ratio, decode_routed_alike=alike)


def ds_grad(card):
    """Phase 17 (c): one forward and backward of ``lm_loss`` at 3 dense + 1
    MoE layer with the MTP head, remat "full", B=1, at the first cut of
    DS_GRAD_CUTS that fits the card: every gradient finite, the peak."""
    import gc
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model
    for layers, S in DS_GRAD_CUTS:
        cfg = ds_config(layers)
        dense = cfg.moe.first_dense_layers
        try:
            params = model.init_params(cfg, seed=1, device="cuda")
            leaves_ = steps.param_leaves(params)
            n = sum(p.numel() for p in leaves_)
            rng = np.random.default_rng(24)
            tokens, labels = (torch.tensor(rng.integers(
                0, cfg.vocab_size, (1, S)), device="cuda")
                for _ in range(2))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for p in leaves_:
                p.requires_grad_(True)
            reset_counts()
            (loss, parts), secs = wall(lambda: model.lm_loss(
                cfg, params, {"tokens": tokens, "labels": labels}))
            grads, bwd_s = wall(lambda: torch.autograd.grad(loss, leaves_))
            peak = torch.cuda.max_memory_allocated()
            launched = counts()
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            norm = float(torch.stack([g.float().norm() for g in grads]).norm())
            print(f"[deepseek grad] {layers} layers ({dense} dense, "
                  f"{layers - dense} MoE) and the MTP head, {n} params bf16, "
                  f"remat {cfg.remat!r}, B=1, S={S}: loss "
                  f"{float(loss.detach()):.6f} (aux "
                  f"{float(parts['aux'].detach()):.6f}) in "
                  f"{secs:.3f} s, its gradient in {bwd_s:.3f} s: "
                  f"{len(grads)} leaves, finite {finite}, global norm "
                  f"{norm:.4e}; peak {peak} bytes allocated; kernel launches "
                  f"{launched}; card {card}")
            del params, leaves_, grads, loss, parts
            torch.cuda.empty_cache()
            if not (finite and math.isfinite(norm)) or any(launched.values()):
                fail(f"{DEEPSEEK_CONFIG}: the gradient is not finite or "
                     f"launched kernels")
            return dict(layers=layers, tokens=S, peak_bytes=peak, fwd_s=secs,
                        bwd_s=bwd_s, grad_norm=norm)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[deepseek grad] {layers} layers over {S} tokens ran out "
                  f"of memory ({str(e)[:120]}...); next cut")
        params = leaves_ = grads = loss = parts = None
        gc.collect()
        torch.cuda.empty_cache()
    fail(f"{DEEPSEEK_CONFIG}: no cut of {DS_GRAD_CUTS} took a gradient")


def ds_train(card):
    """Phase 17 (d): ``make_train_step`` at the dense prefix and the MTP
    head (3 layers, no MoE layer), every width kept: the config's
    Adafactor (bf16 update direction), 4 microbatches of one 4096-token
    sequence, remat "full", 2 steps."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model
    cfg = ds_config(DS_TRAIN_LAYERS, moe=False)
    n_mb = cfg.train_microbatches
    params = model.init_params(cfg, seed=2, device="cuda")
    n_params = sum(p.numel() for p in steps.param_leaves(params))
    batch = train_batch(cfg, n_mb, 0)
    with torch.no_grad():
        ref = sum(float(model.lm_loss(cfg, params, {
            k: v[i:i + 1] for k, v in batch.items()})[0])
            for i in range(n_mb)) / n_mb
    del batch
    torch.cuda.empty_cache()
    reset_counts()
    losses, secs, peak, _ = train_steps(cfg, params, TRAIN_STEPS, n_mb)
    launched = counts()
    del params
    torch.cuda.empty_cache()
    steady = sum(secs[1:]) / len(secs[1:])
    d_loss = abs(losses[0] - ref) / abs(ref)
    print(f"[deepseek train] {DEEPSEEK_CONFIG} widths, {cfg.num_layers} dense "
          f"layers (d_ff {cfg.d_ff}) and the MTP head, no MoE layer, "
          f"{n_params} params bf16, {cfg.optimizer} (bf16 update), remat "
          f"{cfg.remat!r}; {n_mb} microbatches of one {TRAIN_SEQ}-token "
          f"sequence; losses {losses}; s per step {secs} (steady "
          f"{steady:.4f}); {n_mb * TRAIN_SEQ / steady:.1f} tokens/s; peak "
          f"{peak} bytes allocated; the first loss against its microbatches' "
          f"separate lm_loss (MTP included) {ref:.6f}: {d_loss:.3e} relative "
          f"(tol {TOL_TRAIN_LOSS:.0e}); kernel launches {launched}; card "
          f"{card}")
    if not all(math.isfinite(x) for x in losses) or d_loss > TOL_TRAIN_LOSS:
        fail(f"{DEEPSEEK_CONFIG}: train losses {losses}, separate {ref}")
    if any(launched.values()):
        fail(f"{DEEPSEEK_CONFIG}: the train step launched kernels {launched}")
    return dict(losses=losses, s_per_step=secs, steady_s=steady,
                tokens_per_s=n_mb * TRAIN_SEQ / steady, peak_bytes=peak)


def deepseek_path(card):
    """Phase 17: MLA, the MTP head and deepseek-v3 on the card.  Runs no
    kernel; returns its readings."""
    import numpy as np
    import torch
    from repro_torch.models import model
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    cfg = ds_config(DS_LAYERS)
    params, secs = wall(lambda: model.init_params(cfg, seed=0, device=dev))
    n = sum(x.numel() for x in leaves(params))
    print(f"[deepseek] {DEEPSEEK_CONFIG}: {DS_LAYERS} of 61 layers at full "
          f"width (the 3 dense prefix layers, 2 MoE layers of 256 experts "
          f"top 8) and the MTP head, {n} params ({2 * n / 1e9:.2f} GB bf16) "
          f"drawn on the card in {secs:.3f} s; capacity factor "
          f"{cfg.moe.capacity_factor}, impl {cfg.moe.impl!r} (no mesh: one "
          f"dispatch, no waves); depth cuts: the gradient at "
          f"{DS_GRAD_CUTS[0][0]} layers, the train step at "
          f"{DS_TRAIN_LAYERS} dense layers with no MoE layer")
    rng = np.random.default_rng(25)
    tokens, labels = (torch.tensor(rng.integers(0, cfg.vocab_size,
                                                (1, DS_SEQ)), device=dev)
                      for _ in range(2))
    out = {"forward": ds_forward(dev, card, cfg, params, tokens, labels)}
    out["serve"] = ds_serve(dev, card, cfg, params)
    del params
    torch.cuda.empty_cache()
    out["grad"] = ds_grad(card)
    out["train"] = ds_train(card)
    train_script(card, DEEPSEEK_CONFIG)
    return out


# the two configs and their keys in the kernels line's flash row
FRONTEND_CONFIGS = {"qwen2-vl-2b": "qwen2_vl",
                    "seamless-m4t-large-v2": "seamless"}
# (b) / (c) of phase 18: 16 greedy decode steps from the 4096 prompt
FRONTEND_DECODE_STEPS = 16
# the first decode's logits against forward_train(backend="reference")'s at
# position 4096, the forward that runs the mixers prefill filled the cache
# with: max |decode - forward| / max |forward|, the reference's
# test_prefill_decode_consistency gate (phase 17's TOL_DS_DECODE)
TOL_FRONTEND_DECODE = 0.05


def frontend_flash_reading(dev, card, cfg):
    """Phase 18: the flash kernel at the decoder's shape (qwen2-vl: H 12
    over Hkv 2, a group of 6, dh 128; seamless: H 16 over Hkv 16, dh 64),
    causal, B 1, S 4096, held against its plain twin, timed beside SDPA
    and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    S = TRAIN_SEQ
    measures, (q, k, v), kernel, plain, ref = flash_case(dev, 1, S, H, Hkv,
                                                         dh, 0, 10)
    ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    sdpa_rel = rel_rms(sdpa().transpose(1, 2), ref)
    library_ms = cuda_ms(sdpa, 20)
    flops, nb = flash_ops.work(1, S, H, Hkv, dh, 2)
    bound_ms, bound_by = bound(nb, (flops, BF16_PEAK))
    print(f"[frontend flash {cfg.name}] bf16 B=1 S={S} H={H} Hkv={Hkv} "
          f"dh={dh} causal: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s, {bound_ms / ms:.3f} of the bound), plain twin "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention(is_causal=True, "
          f"enable_gqa=True) {library_ms:.4f} ms, its output {sdpa_rel:.3e} "
          f"of the twin's RMS away; bound {bound_ms:.5f} ms ({bound_by}: "
          f"{flops / 1e9:.3f} GFLOP bf16, {nb / 1e6:.4f} MB); card {card}")
    if bound_ms / ms >= 1:
        fail(f"the flash kernel at {cfg.name}'s shape reads "
             f"{bound_ms / ms:.3f} of its bound: the bound's count is wrong")
    del q, k, v, qt, kt, vt, ref
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, tflops=flops / ms / 1e9,
                rel_rms=measures[0], worst_row=measures[1],
                max_abs_err=measures[2], sdpa_rel_rms=sdpa_rel,
                shape=f"bf16, B=1, S={S}, H={H}, Hkv={Hkv}, dh={dh}, causal")


def frontend_encoder_launches(dev, card, cfg, params):
    """Phase 18 (b): the encoder alone over 512 frames launches no kernel
    (its non-causal attention is the dense plain one, as the reference's
    encoder scan takes its default backend); its time."""
    import numpy as np
    import torch
    from repro_torch.models import model
    fe = frontend_embeds(cfg, TRAIN_SEQ, np.random.default_rng(27), dev)
    with torch.inference_mode():
        reset_counts()
        enc, secs = wall(lambda: model._run_encoder(cfg, params, fe))
        launched = counts()
    print(f"[frontend encoder {cfg.name}] _run_encoder over "
          f"{fe.shape[1]} frames of {fe.shape[2]}: {cfg.encoder_layers} "
          f"layers, out {tuple(enc.shape)} finite "
          f"{bool(torch.isfinite(enc).all())}, {secs:.4f} s; kernel "
          f"launches {launched}; card {card}")
    if any(launched.values()) or not bool(torch.isfinite(enc).all()):
        fail(f"{cfg.name}: the encoder launched kernels {launched} or gave "
             f"non-finite output")
    return secs


def frontend_serve(dev, card, cfg, params):
    """Phase 18 (a) / (b): prefill of a 4096 prompt with its frontend
    embeddings into a cache of 4160, 16 greedy decode steps (p50 / p99
    beside the bound of the bytes a token reads: the decoder's blocks,
    the head and the whole cache, cross K / V included, not the encoder,
    which a decode does not run), kernels a step, the idle share, the
    peak; the first decode held against the forward's logits at position
    4096 and block by block against the pallas forward."""
    import numpy as np
    import torch
    from repro_torch.models import model
    tag = f"[frontend serve {cfg.name}]"
    rng = np.random.default_rng(26)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, SERVE_PROMPT)),
                          device=dev)
    fe = frontend_embeds(cfg, SERVE_PROMPT, rng, dev)
    n = FRONTEND_DECODE_STEPS
    with torch.inference_mode():
        (logits, cache), first_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE, frontend_embeds=fe))
        (logits, cache), steady_s = wall(lambda: model.prefill(
            cfg, params, prompt, cache_len=SERVE_CACHE, frontend_embeds=fe))
        if logits.shape != (1, cfg.vocab_padded) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.name}: prefill logits not finite or not (1, "
                 f"{cfg.vocab_padded})")
        cache_bytes = {k: nbytes([v]) for k, v in cache.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, decoded, first = timed_decode(
            cfg, params, cache, logits.argmax(-1, keepdim=True),
            SERVE_PROMPT, steps=n)
        launched = counts()
        prof = profile_decode(cfg, params, cache, decoded[:, -1:],
                              SERVE_PROMPT + n)
        peak = torch.cuda.max_memory_allocated()
        parts, total, bound_ms = decode_reading(params, cache)
        p50, p99 = percentile_ms(times, 50), percentile_ms(times, 99)
        del cache
        torch.cuda.empty_cache()
        pad = torch.tensor(rng.integers(
            0, cfg.vocab_size, (1, SERVE_YARDSTICK - SERVE_PROMPT - n)),
            device=dev)
        seq = torch.cat([prompt, decoded, pad], dim=1)
        (ref, _), ref_s = wall(lambda: model.forward_train(
            cfg, params, seq, fe, backend="reference"))
        ref = ref[:, SERVE_PROMPT]
        reset_counts()
        (fwd, _), fwd_s = wall(lambda: model.forward_train(
            cfg, params, seq, fe, backend="pallas"))
        fwd_launched = counts()
        fwd = fwd[:, SERVE_PROMPT]
        ratio = float((first - ref).abs().max() / ref.abs().max())
        free = rel_rms(first, fwd)
        agree = bool(first.argmax(-1) == ref.argmax(-1))
        worst, _ = hold_decode_blocks(cfg, params, seq, SERVE_PROMPT, fe)
    others = sum(v for k, v in fwd_launched.items() if k != "flash_attention")
    leaves_note = ", cross K / V of the prompt's frames read by every step" \
        if cfg.is_encdec else ""
    print(f"{tag} {cfg.num_layers} decoder layers, bf16 random params; "
          f"prefill B=1, S={SERVE_PROMPT} with {fe.shape[1]} {cfg.frontend} "
          f"embeddings, cache_len {SERVE_CACHE}: {first_s:.4f} s first call, "
          f"{steady_s:.4f} s steady; cache bytes {cache_bytes}{leaves_note}; "
          f"{n} greedy decode_steps: p50 {p50:.4f} ms, p99 {p99:.4f} ms per "
          f"token, kernel launches {launched}; the bound {bound_ms:.4f} ms: "
          f"{total} bytes read a token ({parts}; not the encoder) at 3.35 "
          f"TB/s; p50 / bound {p50 / bound_ms:.2f}; "
          f"{profile_note(prof, p50)}; peak {peak} bytes allocated while "
          f"decoding; card {card}")
    print(f"{tag} the first decode at position {SERVE_PROMPT} against "
          f"forward_train over {SERVE_YARDSTICK} tokens: backend 'reference' "
          f"({ref_s:.4f} s), max|decode - forward| / max|forward| of the "
          f"logits {ratio:.4e} (tol {TOL_FRONTEND_DECODE}), argmax "
          f"{'equal' if agree else 'different'}; backend 'pallas' "
          f"({fwd_s:.4f} s, {fwd_launched['flash_attention']} flash "
          f"launches, {others} of the others): the logits {free:.3e} of "
          f"their RMS apart (reported); block by block on its input to each "
          f"layer, the decode block's update {worst:.3e} of its RMS from the "
          f"forward's at worst (tol {TOL_LM_LAYER:.0e})")
    if any(launched.values()):
        fail(f"{cfg.name}: decode launched kernels {launched}")
    if fwd_launched["flash_attention"] != cfg.num_layers or others:
        fail(f"{cfg.name}: the yardstick launched "
             f"{fwd_launched['flash_attention']} flash (expected "
             f"{cfg.num_layers}) and {others} others")
    if not (ratio < TOL_FRONTEND_DECODE and worst <= TOL_LM_LAYER):
        fail(f"{cfg.name}: the decode at {SERVE_PROMPT} differs from the "
             f"forward's")
    return dict(prefill_s=steady_s, prefill_first_s=first_s,
                cache_bytes=sum(cache_bytes.values()), decode_p50_ms=p50,
                decode_p99_ms=p99, decode_bound_ms=bound_ms,
                decode_profile=prof, decode_peak_bytes=peak,
                decode_vs_forward=ratio, decode_block_worst=worst,
                yardstick_launches=fwd_launched["flash_attention"])


def frontend_train(card, name):
    """Phase 18 (a) / (b): ``make_train_step`` at full width and depth,
    AdamW, remat "full", 4 microbatches of one 4096-token sequence with
    its frontend embeddings (``synthetic_batch``), 2 steps."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import roofline, steps
    from repro_torch.models import model
    cfg = get_config(name)
    n_mb = cfg.train_microbatches
    params = model.init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in steps.param_leaves(params))
    batch = train_batch(cfg, n_mb, 0)
    fe_shape = tuple(batch["frontend_embeds"].shape)
    with torch.no_grad():
        ref = sum(float(model.lm_loss(cfg, params, {
            k: v[i:i + 1] for k, v in batch.items()})[0])
            for i in range(n_mb)) / n_mb
    del batch
    torch.cuda.empty_cache()
    reset_counts()
    losses, secs, peak, _ = train_steps(cfg, params, TRAIN_STEPS, n_mb)
    launched = counts()
    del params
    torch.cuda.empty_cache()
    steady = sum(secs[1:]) / len(secs[1:])
    hw = roofline.hardware_spec(device="cuda")
    flops = roofline.model_flops(cfg, InputShape("train", TRAIN_SEQ, n_mb,
                                                 "train"),
                                 steps.abstract_params(cfg))
    d_loss = abs(losses[0] - ref) / abs(ref)
    print(f"[frontend train {name}] {n_params} params bf16, AdamW, remat "
          f"{cfg.remat!r}; {n_mb} microbatches of one {TRAIN_SEQ}-token "
          f"sequence with its {cfg.frontend} embeddings (batch {fe_shape}); "
          f"losses {losses}; s per step {secs} (steady {steady:.4f}); "
          f"{n_mb * TRAIN_SEQ / steady:.1f} tokens/s; peak {peak} bytes "
          f"allocated; model FLOPs {flops:.4e} a step (the encoder's over "
          f"the frames), {flops / (steady * hw.peak_flops):.4f} of "
          f"{hw.name}'s {hw.peak_flops:.3e} FLOP/s; the first loss against "
          f"its microbatches' separate lm_loss {ref:.6f}: {d_loss:.3e} "
          f"relative (tol {TOL_TRAIN_LOSS:.0e}); kernel launches {launched}; "
          f"card {card}")
    if not all(math.isfinite(x) for x in losses) or d_loss > TOL_TRAIN_LOSS:
        fail(f"{name}: train losses {losses}, separate {ref}")
    if any(launched.values()):
        fail(f"{name}: the train step launched kernels {launched}")
    return dict(losses=losses, s_per_step=secs, steady_s=steady,
                tokens_per_s=n_mb * TRAIN_SEQ / steady, peak_bytes=peak,
                mfu=flops / (steady * hw.peak_flops))


def frontend_model(dev, card, name):
    """Phase 18 (a) / (b): one frontend model whole on the card."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    torch.cuda.empty_cache()
    out = {}
    out["launches"], out["lm_first_s"], out["lm_steady_s"] = run_lm(
        dev, name, TRAIN_SEQ, "flash_attention")
    cfg = get_config(name)
    params = model.init_params(cfg, seed=0, device=dev)
    if cfg.is_encdec:
        out["encoder_s"] = frontend_encoder_launches(dev, card, cfg, params)
        out["encoder_launches"] = 0
    out["flash"] = frontend_flash_reading(dev, card, cfg)
    out["serve"] = frontend_serve(dev, card, cfg, params)
    del params
    torch.cuda.empty_cache()
    out["train"] = frontend_train(card, name)
    train_script(card, name)
    return out


def frontend_path(card):
    """Phase 18: the encoder-decoder and the modality frontends on the
    card.  Returns the flash row's readings."""
    import torch
    dev = torch.device("cuda")
    out = {}
    for name, key in FRONTEND_CONFIGS.items():
        r = frontend_model(dev, card, name)
        out[f"{key}_launches"] = r.pop("launches")
        out[f"{key}_path"] = (f"lm_loss({name}, backend='pallas'), B=1, "
                              f"S={TRAIN_SEQ}, with its frontend embeddings")
        out[f"{key}_shape"] = r.pop("flash")
        out[key] = r
    return out


# phase 19: the language model's mesh layer on one card, a single
# controller: every shard on the card, the mesh an abstract map from axis
# names to sizes
MESH_MOE_MESHES = ((1, 4), (1, 16))
MESH_LM_LAYERS, MESH_LM_MESH = 4, (1, 16)
MESH_SERVE_CONFIG, MESH_SERVE_STEPS = "phi4-mini-3.8b", 16
MESH_TRAIN_LAYERS, MESH_TRAIN_MESH, MESH_TRAIN_BATCH = 8, (2, 1), 4
# (a) the card's expert-parallel output (bf16) against the CPU's on the
# same routes and kept pairs in float32 (the card rounds each expert
# product, its hidden rows and each weighted term to bf16), and the
# dropless dispatch on the card against _moe_dispatch's (the same GEMMs
# over other row groupings, a token's terms added in another order): the
# rel-RMS and worst-element tolerances of phase 15's dense mix
TOL_MESH_MOE = TOL_MOE_DENSE
# (d) the train step's first loss against its microbatches' separate mesh
# forward: the same operations on the same card
TOL_MESH_TRAIN_LOSS = 1e-6


def mesh_moe(dev, card):
    """Phase 19 (a): one phi3.5-moe MoE layer at full width, bf16, B 1 S
    4096, through the expert-parallel dispatch under abstract (1, 4) and
    (1, 16) meshes: the kept pairs at both hops equal to the CPU's for the
    same routes, the output against the CPU's float32 run, the dropless
    (cf 8) output against ``_moe_dispatch``'s, the drop shares at cf 1.25,
    ms per call beside ``_moe_dispatch``'s."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models import act_sharding, moe
    from repro_torch.models import moe_shard_map as msm
    cfg = moe_config(1)
    cf = cfg.moe.capacity_factor
    T, D = MOE_SEQ, cfg.d_model
    p = moe.init_moe(cfg, torch.Generator(device=dev).manual_seed(3))
    x = torch.tensor(np.random.default_rng(17).standard_normal((1, T, D)),
                     dtype=torch.float32, device=dev).to(torch.bfloat16)
    p_cpu = {k: v.float().cpu() for k, v in p.items()}
    dropless = moe_config(1, capacity_factor=MOE_DROPLESS)
    out = {}
    for shape in MESH_MOE_MESHES:
        mesh = make_abstract_mesh(shape, ("data", "model"))
        tag = f"[mesh moe {shape}]"
        lay = msm.layout(cfg, mesh, 1, T)
        with torch.inference_mode():
            xs = msm.to_shards(x, lay)
            top_p, top_idx, aux = msm.route(cfg, p, xs, lay)
            info, info_cpu = {}, {}
            y = msm.exchange(cfg, p, xs, top_p, top_idx, lay, info)
            y_cpu = msm.exchange(cfg, p_cpu, xs.float().cpu(), top_p.cpu(),
                                 top_idx.cpu(), lay, info_cpu)
            same = all(torch.equal(info[k].cpu(), info_cpu[k])
                       for k in ("sent", "kept"))
            rel = rel_rms(y.float().cpu(), y_cpu)
            worst = float((y.float().cpu() - y_cpu).abs().max()
                          / y_cpu.abs().max())
            sent, kept = info["sent"], info["kept"]
            drop1 = 1 - float(sent.float().mean())
            drop2 = float((sent & ~kept).float().mean())

            def ep():
                with act_sharding.activation_mesh(mesh):
                    return msm.apply_moe_expert_parallel(cfg, p, x)
            ms = cuda_ms(ep, 5)
            ms_dispatch = cuda_ms(lambda: moe._moe_dispatch(cfg, p, x), 5)
            with act_sharding.activation_mesh(mesh):
                info8 = {}
                y8, aux8 = msm.apply_moe_expert_parallel(dropless, p, x,
                                                         info8)
            yd, auxd = moe._moe_dispatch(dropless, p, x)
            rel8 = rel_rms(y8, yd)
            worst8 = float((y8.float() - yd.float()).abs().max()
                           / yd.float().abs().max())
            lay8 = info8["layout"]
            all8 = bool(info8["kept"].all())
        shards = lay["n_dp"] * lay["EP"]
        verdict = "equal" if same else "DIFFER FROM"
        print(f"{tag} {MOE_CONFIG} widths (E 16, top 2, D {D}, F "
              f"{cfg.moe.d_ff_expert}), bf16, B 1 S {T}: {shards} shards of "
              f"{lay['T_loc']} tokens, c_send {lay['c_send']}, c_exp "
              f"{lay['c_exp']} at cf {cf}; the card's kept pairs at both "
              f"hops {verdict} the CPU's for the same routes; dropped "
              f"{drop1:.4f} of the pairs at the first hop, {drop2:.4f} more "
              f"at the second; the card's bf16 output against the CPU's "
              f"float32 run: rel-RMS {rel:.3e}, worst {worst:.3e} of the "
              f"largest |value| (tol {TOL_MESH_MOE[0]:.0e}, "
              f"{TOL_MESH_MOE[1]:.1e}); aux {float(aux):.6e}; dropless (cf "
              f"{MOE_DROPLESS}: c_send {lay8['c_send']}, c_exp "
              f"{lay8['c_exp']}, every pair kept: {all8}) against "
              f"_moe_dispatch's: rel-RMS {rel8:.3e}, worst {worst8:.3e}, "
              f"aux {float(aux8):.6e} against {float(auxd):.6e}; "
              f"{ms:.4f} ms a call (router, two hops, experts) beside "
              f"_moe_dispatch's {ms_dispatch:.4f} ms at cf {cf} (CUDA "
              f"events); card {card}")
        if not same:
            fail(f"mesh moe {shape}: the kept pairs on the card differ "
                 f"from the CPU's")
        if not (rel <= TOL_MESH_MOE[0] and worst <= TOL_MESH_MOE[1]):
            fail(f"mesh moe {shape}: the card's output differs from the "
                 f"CPU's")
        if not (all8 and rel8 <= TOL_MESH_MOE[0]
                and worst8 <= TOL_MESH_MOE[1]):
            fail(f"mesh moe {shape}: the dropless expert-parallel output "
                 f"differs from _moe_dispatch's")
        out[f"{shape[0]}x{shape[1]}"] = dict(
            c_send=lay["c_send"], c_exp=lay["c_exp"], drop_hop1=drop1,
            drop_hop2=drop2, cpu_rel_rms=rel, dropless_rel_rms=rel8, ms=ms,
            dispatch_ms=ms_dispatch)
        del y, y_cpu, y8, yd, xs, info, info_cpu, info8
        torch.cuda.empty_cache()
    del p, p_cpu, x
    torch.cuda.empty_cache()
    return out


def mesh_lm(dev, card):
    """Phase 19 (b): ``lm_loss(backend="pallas")`` of phi3.5-moe at 4 of
    32 layers under an abstract (1, 16) mesh: one flash launch a layer,
    the loss finite beside the mesh-less one (they differ by the
    expert-parallel capacities), s per call."""
    import math
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models import act_sharding, model
    cfg = moe_config(MESH_LM_LAYERS)
    params = model.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(19)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (1, MOE_SEQ)),
                             device=dev) for k in ("tokens", "labels")}
    mesh = make_abstract_mesh(MESH_LM_MESH, ("data", "model"))

    def loss(m):
        with act_sharding.activation_mesh(m):
            return model.lm_loss(cfg, params, batch, backend="pallas")
    with torch.inference_mode():
        reset_counts()
        (l_mesh, parts), first_s = wall(lambda: loss(mesh))
        launched = counts()
        (_, _), steady_s = wall(lambda: loss(mesh))
        (l_plain, parts0), plain_s = wall(lambda: loss(None))
    others = sum(n for k, n in launched.items() if k != "flash_attention")
    print(f"[mesh lm {MOE_CONFIG}] {MESH_LM_LAYERS} of 32 layers at full "
          f"width, bf16, B 1 S {MOE_SEQ}, lm_loss(backend='pallas') under "
          f"an abstract {MESH_LM_MESH} mesh (the one-hot lookup, the "
          f"expert-parallel MoE at cf {cfg.moe.capacity_factor}): loss "
          f"{float(l_mesh):.6f} (aux {float(parts['aux']):.6e}); without "
          f"the mesh (one dispatch) {float(l_plain):.6f} (aux "
          f"{float(parts0['aux']):.6e}); {launched['flash_attention']} "
          f"flash launches, {others} of the others; {first_s:.4f} s first "
          f"call, {steady_s:.4f} s steady, {plain_s:.4f} s without the "
          f"mesh; card {card}")
    if not math.isfinite(float(l_mesh)):
        fail("mesh lm: the loss under the mesh is not finite")
    if launched["flash_attention"] != MESH_LM_LAYERS or others:
        fail(f"mesh lm: launches {launched}, expected "
             f"{MESH_LM_LAYERS} flash and none of any other")
    del params
    torch.cuda.empty_cache()
    return dict(launches=launched["flash_attention"],
                loss=float(l_mesh), loss_no_mesh=float(l_plain),
                first_s=first_s, steady_s=steady_s, no_mesh_s=plain_s)


def mesh_serve(dev, card):
    """Phase 19 (c): phi4-mini whole under the production (16, 16) mesh, B
    1 (the tiny-batch cache spec): prefill of 4096 and 16 greedy decodes,
    p50 / p99 beside the mesh-less decode and the bound with the masked
    write; each decode block within ``TOL_LM_LAYER`` of the pallas
    forward's; a step at pos >= S leaves the cache bit-equal."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import act_sharding, model
    from repro_torch.models.sharding import cache_leaf_spec
    cfg = get_config(MESH_SERVE_CONFIG)
    params = model.init_params(cfg, seed=0, device=dev)
    mesh = make_production_mesh()
    rng = np.random.default_rng(13)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, SERVE_PROMPT)),
                          device=dev)
    tag = f"[mesh serve {MESH_SERVE_CONFIG}]"
    with torch.inference_mode():
        with act_sharding.activation_mesh(mesh):
            logits, cache = model.prefill(cfg, params, prompt,
                                          cache_len=SERVE_CACHE)
            specs = {k: tuple(cache_leaf_spec(mesh, k, v.shape))
                     for k, v in cache.items()}
            times, decoded, _ = timed_decode(
                cfg, params, cache, logits.argmax(-1, keepdim=True),
                SERVE_PROMPT, steps=MESH_SERVE_STEPS)
            before = {k: v.clone() for k, v in cache.items()}
            past, _ = model.decode_step(cfg, params, cache,
                                        decoded[:, -1:], SERVE_CACHE)
            untouched = all(torch.equal(before[k], cache[k]) for k in cache)
            del before
        logits0, cache0 = model.prefill(cfg, params, prompt,
                                        cache_len=SERVE_CACHE)
        times0, decoded0, _ = timed_decode(
            cfg, params, cache0, logits0.argmax(-1, keepdim=True),
            SERVE_PROMPT, steps=MESH_SERVE_STEPS)
        same_tokens = torch.equal(decoded, decoded0)
        del cache0
        parts, total, _ = decode_reading(params, cache)
        write = 2 * nbytes([cache["k"], cache["v"]])
        bound_ms = 1e3 * (total + write) / HBM_RATE
        pad = torch.tensor(rng.integers(
            0, cfg.vocab_size, (1, SERVE_YARDSTICK - SERVE_PROMPT
                                - MESH_SERVE_STEPS)), device=dev)
        seq = torch.cat([prompt, decoded, pad], dim=1)
        del cache
        with act_sharding.activation_mesh(mesh):
            worst, _ = hold_decode_blocks(cfg, params, seq, SERVE_PROMPT)
    p50, p99 = percentile_ms(times, 50), percentile_ms(times, 99)
    q50, q99 = percentile_ms(times0, 50), percentile_ms(times0, 99)
    print(f"{tag} {cfg.num_layers} layers, bf16 random params (seed 0), "
          f"under the production mesh {dict(mesh.shape)} (abstract; B 1 "
          f"takes the tiny-batch cache spec {specs['k']}): prefill of "
          f"{SERVE_PROMPT}, {MESH_SERVE_STEPS} greedy decode_steps: p50 "
          f"{p50:.4f} ms, p99 {p99:.4f} ms a token (host clock, the card "
          f"synchronised around each); without the mesh p50 {q50:.4f} ms, "
          f"p99 {q99:.4f} ms (greedy tokens "
          f"{'equal' if same_tokens else 'different'}); the bound "
          f"{bound_ms:.4f} ms: {total + write} bytes a token ({parts} and "
          f"the masked write's read and write of every K/V slot, {write}) "
          f"at 3.35 TB/s; p50 / bound {p50 / bound_ms:.2f}; a step at pos "
          f"{SERVE_CACHE} >= S leaves the cache "
          f"{'bit-equal' if untouched else 'CHANGED'} (logits finite: "
          f"{bool(torch.isfinite(past).all())}); block by block on the "
          f"pallas forward's input to each layer, the mesh decode block's "
          f"update at position {SERVE_PROMPT} is {worst:.3e} of its RMS "
          f"from the forward's at worst (tol {TOL_LM_LAYER:.0e}); card "
          f"{card}")
    if not untouched:
        fail("mesh serve: a decode step at pos >= S changed the cache")
    if not worst <= TOL_LM_LAYER:
        fail("mesh serve: a mesh decode block differs from the pallas "
             "forward's")
    del params
    torch.cuda.empty_cache()
    return dict(decode_p50_ms=p50, decode_p99_ms=p99,
                no_mesh_decode_p50_ms=q50, no_mesh_decode_p99_ms=q99,
                decode_bound_ms=bound_ms, block_worst=worst)


def mesh_train(card):
    """Phase 19 (d): one train step of phi4-mini at 8 of 32 layers, 4 x
    4096 tokens, under an abstract (2, 1) mesh (2 microbatches: each must
    divide the 2 dp ways): its loss against its microbatches' separate
    mesh forward, its peak beside the mesh-less step's (4 microbatches);
    then ``python -m repro_torch.launch.train``, under its debug mesh."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models import act_sharding, model
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"),
                              num_layers=MESH_TRAIN_LAYERS)
    mesh = make_abstract_mesh(MESH_TRAIN_MESH, ("data", "model"))
    B = MESH_TRAIN_BATCH
    n_mb = steps.microbatches(cfg.train_microbatches, B,
                              MESH_TRAIN_MESH[0])
    n_plain = steps.microbatches(cfg.train_microbatches, B)
    params = model.init_params(cfg, seed=0, device="cuda")
    batch = train_batch(cfg, B, 0)
    b = B // n_mb
    with torch.no_grad(), act_sharding.activation_mesh(mesh):
        parts = [model.lm_loss(cfg, params, {k: v[i * b:(i + 1) * b]
                                             for k, v in batch.items()})[0]
                 for i in range(n_mb)]
        ref = torch.zeros((), dtype=torch.float32,
                          device=batch["tokens"].device)
        for p_ in parts:
            ref = ref + p_
        ref = float(ref / n_mb)
    del parts
    peaks, losses, secs = {}, {}, {}
    # in turns: the first mesh step, the mesh-less one, a steady mesh step
    for what, m in (("mesh", mesh), ("no mesh", None),
                    ("mesh steady", mesh)):
        opt_state = steps.make_opt(cfg).init(steps.param_leaves(params))
        fn = steps.make_train_step(cfg, m)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (params, opt_state, _, metrics), secs[what] = wall(
            lambda: fn(params, opt_state, 0, batch))
        peaks[what] = torch.cuda.max_memory_allocated()
        losses[what] = float(metrics["loss"])
        del opt_state
    d = abs(losses["mesh"] - ref) / abs(ref)
    print(f"[mesh train phi4-mini-3.8b] {MESH_TRAIN_LAYERS} of 32 layers, "
          f"bf16, AdamW, batch {B} x {TRAIN_SEQ}, under an abstract "
          f"{MESH_TRAIN_MESH} mesh: {n_mb} microbatches (clamped from "
          f"{cfg.train_microbatches} by the 2 dp ways; {n_plain} without "
          f"the mesh), each one-hot lookup {b} x {TRAIN_SEQ} x "
          f"{cfg.vocab_padded} bf16 = {2 * b * TRAIN_SEQ * cfg.vocab_padded}"
          f" bytes; the first loss {losses['mesh']:.6f} against its "
          f"microbatches' separate mesh forward {ref:.6f}: {d:.3e} relative "
          f"(tol {TOL_MESH_TRAIN_LOSS:.0e}); {secs['mesh']:.4f} s, peak "
          f"{peaks['mesh']} bytes allocated; then on the updated params "
          f"the mesh-less step (gather lookup, {n_plain} microbatches): "
          f"loss {losses['no mesh']:.6f}, {secs['no mesh']:.4f} s, peak "
          f"{peaks['no mesh']} bytes; a steady mesh step: loss "
          f"{losses['mesh steady']:.6f}, {secs['mesh steady']:.4f} s, peak "
          f"{peaks['mesh steady']} bytes; card {card}")
    if not (math.isfinite(losses["mesh"]) and d <= TOL_MESH_TRAIN_LOSS):
        fail("mesh train: the step's loss differs from its separate mesh "
             "forward's")
    if n_mb != 2:
        fail(f"mesh train: {n_mb} microbatches under the (2, 1) mesh")
    del params, batch
    torch.cuda.empty_cache()
    train_script_checkpoint(card)
    return dict(loss=losses["mesh"], forward_loss=ref, peak_mesh=peaks["mesh"],
                peak_no_mesh=peaks["no mesh"], first_s=secs["mesh"],
                steady_s=secs["mesh steady"], no_mesh_s=secs["no mesh"])


def mesh_path(card):
    """Phase 19: the language model's mesh layer on one card.  Returns the
    flash row's readings."""
    import torch
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    moe_r = mesh_moe(dev, card)
    lm_r = mesh_lm(dev, card)
    serve_r = mesh_serve(dev, card)
    train_r = mesh_train(card)
    return dict(mesh_launches=lm_r.pop("launches"),
                mesh_path=(f"lm_loss({MOE_CONFIG}, {MESH_LM_LAYERS} layers, "
                           f"backend='pallas') under an abstract "
                           f"{MESH_LM_MESH} mesh, B=1, S={MOE_SEQ}"),
                mesh=dict(moe=moe_r, lm=lm_r, serve=serve_r, train=train_r))


# phases that need no other phase's results: ``--phases`` runs them alone
# phase 20: phi4-mini-3.8b cut to 2 of 32 layers, B 1, S 4096
COST_CONFIG, COST_LAYERS = "phi4-mini-3.8b", 2
# the counted peak against torch.cuda.max_memory_allocated()'s rise: the
# margin takes cuBLAS workspaces, allocator rounding and the kernels'
# padding copies and scratch, freed inside their wrappers
TOL_PEAK_SHARE, TOL_PEAK_BYTES = 0.05, 64 * 2 ** 20


def measured_run(make_args, fn):
    """``fn(*make_args())`` on the card -> (the rise of
    ``max_memory_allocated`` in its first call over the bytes allocated
    before the arguments were made (their initialization's own peak left
    out), the first call's seconds, a second call's)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = make_args()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, first = wall(lambda: fn(*args))
    rise = torch.cuda.max_memory_allocated() - base
    _, steady = wall(lambda: fn(*args))
    del args
    torch.cuda.empty_cache()
    return rise, first, steady


def cost_path(card):
    """Phase 20: ``launch/cost_analysis``'s counter against the card.  (a)
    phi4-mini at 2 of 32 layers, B 1, S 4096: ``lm_loss`` under no_grad
    (backend "pallas") and the train step (backend "reference") counted on
    meta tensors, then run once each on the card: the counted
    ``peak_per_device_bytes`` within 5% + 64 MiB of the rise of
    ``max_memory_allocated``; (b) the ``lm_loss`` run on the card under
    the counter: its ``flash_attention`` entry has the launches the
    wrapper recorded (2) and twice the work phase 1's bound counts at that
    shape; (c) one interval of ``env_step(backend="fused")`` at the
    training shape (res 16, 4 envs, 50 dt) under the counter on the card:
    one ``fused_interval`` launch of the kernel's ``work(...)``; (d) the
    counted flops over each run's seconds as a share of ``h100_sxm``'s
    peak, beside the roofline's ``bound_s``."""
    import numpy as np
    import torch
    from repro_torch.cfd import scenarios as scn_mod
    from repro_torch.cfd import solver
    from repro_torch.cfd.env import CylinderEnv, EnvConfig, EnvState
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.actuation import ops as aops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import cost_analysis, roofline, steps
    from repro_torch.models import model
    base = get_config(COST_CONFIG)
    cfg = cost_analysis.with_depths(base, {"blocks": COST_LAYERS})
    S = TRAIN_SEQ
    rng = np.random.default_rng(11)
    tokens, labels = (rng.integers(0, cfg.vocab_size, (1, S))
                      for _ in range(2))

    def batch(device):
        return {k: (torch.tensor(v, device=device) if device != "meta"
                    else torch.empty(v.shape, dtype=torch.int64,
                                     device="meta"))
                for k, v in (("tokens", tokens), ("labels", labels))}

    def lm(params, b):
        with torch.no_grad():
            return model.lm_loss(cfg, params, b, backend="pallas")[0]

    def train_args(device):
        params = model.init_params(cfg, seed=0, device=device)
        opt = steps.make_opt(cfg).init(steps.param_leaves(params))
        return params, opt, 0, batch(device)

    runs = {
        "lm_loss": (lambda d: (model.init_params(cfg, seed=0, device=d),
                               batch(d)), lm),
        "train_step": (train_args, steps.make_train_step(cfg)),
    }
    hw = roofline.hardware_spec("h100_sxm")
    out = {}
    for name, (make_args, fn) in runs.items():
        (cost, mem), counted_s = wall(lambda: cost_analysis.count(
            fn, *make_args("meta")))
        rise, first, secs = measured_run(lambda: make_args("cuda"), fn)
        peak = mem["peak_per_device_bytes"]
        limit = TOL_PEAK_SHARE * rise + TOL_PEAK_BYTES
        rl = roofline.build(cfg.name, f"{name} B=1 S={S}", "one card", 1,
                            cost, 0.0, hw=hw)
        share = cost["flops"] / secs / hw.peak_flops
        print(f"[cost {name}] {cfg.name} at {COST_LAYERS} of "
              f"{base.num_layers} layers, B=1, S={S}: counted on meta in "
              f"{counted_s:.3f} s: {cost['flops'] / 1e12:.4f} TFLOP, "
              f"{cost['bytes'] / 1e9:.4f} GB, argument "
              f"{mem['argument_bytes'] / 2**30:.4f} GiB, temp "
              f"{mem['temp_bytes'] / 2**30:.4f} GiB, output "
              f"{mem['output_bytes'] / 2**30:.4f} GiB, peak "
              f"{peak / 2**30:.4f} GiB, kernels {cost['kernels']}; on the "
              f"card the rise of max_memory_allocated {rise / 2**30:.4f} GiB "
              f"(counted - measured {(peak - rise) / 2**20:.1f} MiB, tol "
              f"{limit / 2**20:.1f} MiB); {first:.4f} s first call, "
              f"{secs:.4f} s second: {cost['flops'] / secs / 1e12:.2f} "
              f"TFLOP/s counted over measured, {share:.4f} of h100_sxm's "
              f"peak; roofline bound_s {rl.bound_s:.6f} ({rl.dominant}), "
              f"{rl.bound_s / secs:.4f} of the measured seconds")
        if not abs(peak - rise) <= limit:
            fail(f"cost {name}: counted peak {peak} bytes, measured rise "
                 f"{rise} bytes, over {limit:.0f} apart")
        out[name] = {"flops": cost["flops"], "bytes": cost["bytes"],
                     "kernels": cost["kernels"], "peak_bytes": peak,
                     "measured_rise_bytes": rise, "first_s": first,
                     "seconds": secs, "flops_share_of_peak": share,
                     "bound_s": rl.bound_s, "dominant": rl.dominant}
    if out["train_step"]["kernels"]:
        fail(f"cost train: the train step counted kernels "
             f"{out['train_step']['kernels']}, expected none")
    # (b) the flash kernel as the counter saw it on the card
    args = runs["lm_loss"][0]("cuda")
    reset_counts()
    with cost_analysis.CostCounter() as c:
        lm(*args)
        torch.cuda.synchronize()
    wrapper = counts()["flash_attention"]
    entry = c.result()["kernels"].get("flash_attention", {})
    del args
    want = fops.work(1, S, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim, 2)[0]
    print(f"[cost flash] lm_loss counted on the card: {entry}; the wrapper "
          f"recorded {wrapper} launches; the bound's count a call "
          f"{want / 1e9:.3f} GFLOP")
    if not (entry.get("launches") == wrapper == COST_LAYERS
            and entry.get("flops") == COST_LAYERS * want
            and entry == out["lm_loss"]["kernels"]["flash_attention"]):
        fail(f"cost flash: counted {entry} on the card, the wrapper "
             f"launched {wrapper}, expected {COST_LAYERS} launches of {want} "
             f"flops each, as counted on meta")
    out["lm_loss"]["kernels_on_card"] = c.result()["kernels"]
    # (c) one fused interval at the training shape
    grid = GridConfig(res=16)
    env = CylinderEnv(EnvConfig(grid=grid, steps_per_action=50),
                      backend="fused", device="cuda")
    n = 4
    scn = scn_mod.batch_params([env.cfg.scenario()] * n, grid,
                               cd0s=[0.0] * n, device="cuda")
    st = EnvState(flow=solver.FlowState(
        torch.zeros(n, grid.ny, grid.nx + 1, device="cuda"),
        torch.zeros(n, grid.ny + 1, grid.nx, device="cuda"),
        torch.zeros(n, grid.ny, grid.nx, device="cuda")),
        jet_vel=torch.zeros(n, device="cuda"),
        t=torch.zeros(n, dtype=torch.int64, device="cuda"), scn=scn)
    reset_counts()
    with cost_analysis.CostCounter() as c:
        env.env_step(st, torch.full((n,), 0.5, device="cuda"))
        torch.cuda.synchronize()
    entry = c.result()["kernels"].get("fused_interval", {})
    flops, nbytes = aops.work(grid, n, 50)
    launched = counts()["fused_interval"]
    print(f"[cost fused] env_step(backend='fused'), res 16, {n} envs, 50 dt, "
          f"counted on the card: {entry} ({entry.get('flops', 0) / 1e9:.4f} "
          f"GFLOP, {entry.get('bytes', 0) / 1e6:.4f} MB); the wrapper "
          f"launched {launched}")
    if (entry != {"launches": 1, "flops": flops, "bytes": nbytes}
            or launched != 1):
        fail(f"cost fused: counted {entry}, launched {launched}, expected "
             f"one launch of {flops} flops and {nbytes} bytes")
    out["fused_interval"] = entry
    del env, st
    torch.cuda.empty_cache()
    out["partition"] = partition_count()
    print(f"[cost] {json.dumps(out)}")
    return out


def partition_count():
    """Phase 20 (e): the partition pass (``launch/partition.py``) of
    phi4-mini at ``COST_LAYERS`` of 32 layers on an abstract (2, 4) mesh,
    a decode of B 8 over a 4096 cache: DTensor on a fake process group of
    8 ranks, meta tensors, no device.  Prints one device's bytes by kind;
    fails unless the FSDP all-gathers are counted and every kind the pass
    counts is positive."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import cost_analysis, partition
    from repro_torch.launch.mesh import make_abstract_mesh
    cfg = cost_analysis.with_depths(get_config(COST_CONFIG),
                                    {"blocks": COST_LAYERS})
    mesh = make_abstract_mesh((2, 4), ("data", "model"))
    got, secs = wall(lambda: partition.count(
        cfg, InputShape("decode", 4096, 8, "decode"), mesh))
    kinds = {k[5:]: v for k, v in got.items()
             if k.startswith("coll_") and k != "coll_bytes"}
    print(f"[partition] {cfg.name} at {COST_LAYERS} of 32 layers, decode B 8 "
          f"over a 4096 cache, abstract (2, 4) mesh, torch "
          f"{torch.__version__}: {got['coll_bytes']} bytes a device "
          f"({', '.join(f'{k} {v}' for k, v in sorted(kinds.items()))}); "
          f"ops run replicated {got['replicated']}; counted in {secs:.3f} s")
    if not (kinds.get("all-gather", 0) > 0
            and all(v > 0 for v in kinds.values())):
        fail(f"partition: counted {got}, expected the FSDP all-gathers")
    return {**got, "seconds": secs}


STANDALONE_PHASES = ("10", "12", "13", "14", "15", "16", "17", "18", "19",
                     "20")


def compare_tree(card):
    """``--compare TREE``: phase 1's yardsticks of the shapes the registered
    configs run, read from TREE's ``repro_torch`` (its kernels built into
    TREE's ``build/``) with this script's helpers, so that two commits are
    timed alike: the bf16 flash kernel at phi4-mini's shape (dh 128, held
    against its twin first), the WKV6 call at rwkv6-3b's (N 64), and the
    CFD kernels at the training shape (res 16, 4 envs: the fused interval's
    scalar and per-body instantiations over 50 dt, the packed and the
    full-grid SOR solve at iters 50), on the largest grids their
    cluster kernels serve (the scalar fused interval at res 38, the packed
    solve at res 70) and past one cluster (the scalar fused interval at res
    48, 4 envs, 50 dt; the packed solve at res 71: the resident kernels, or
    in an older tree the global-memory ones, whose bits they give), each
    with a digest of its output's bytes, which two trees that compute
    alike share; and the SASS of the cluster kernels
    (:func:`sass_profile`: registers and instructions by opcode), where
    two builds that time apart differ.  One process reads
    one tree: run it in turns on the older, the newer, the newer and the
    older tree in one call on one card.  Prints one JSON line; no result
    line."""
    import hashlib
    import torch
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    _, secs = wall(lambda: build.build(["flash_attention", "wkv6",
                                        *STALE_HALO_KERNELS]))
    phi, rwkv = get_config("phi4-mini-3.8b"), get_config("rwkv6-3b")
    flash = flash_case(dev, 1, 4096, phi.num_heads, phi.num_kv_heads,
                       phi.resolved_head_dim, 0, 4)[2]
    wkv6 = wkv6_case(dev, rwkv, 4096)[1]
    res16, res38, res70, res48, res71 = (GridConfig(res=r)
                                         for r in (16, 38, 70, 48, 71))
    cfd = {"fused_interval_scalar": fused_case(dev, res16, 4, 50)[0],
           "fused_interval_per_body": bank_case(dev, res16, 4, 50)[0],
           "rb_sor_planes": sor_case(dev, res16, 4, 50)[0],
           "rb_sor_full": sor_case(dev, res16, 4, 50, 2, True)[0],
           "fused_interval_scalar_res38": fused_case(dev, res38, 4, 50)[0],
           "rb_sor_planes_res70": sor_case(dev, res70, 4, 50)[0],
           "fused_interval_scalar_res48": fused_case(dev, res48, 4, 50)[0],
           "rb_sor_planes_res71": sor_case(dev, res71, 4, 50)[0]}
    readings = {}
    for name, kernel in cfd.items():
        out = kernel()
        if name.startswith("fused"):
            out = (*out[0], out[1].cd, out[1].cl)
        digest = hashlib.sha256()
        for t in out:
            digest.update(t.cpu().numpy().tobytes())
        readings[name] = {"ms": cuda_ms(kernel, 50 if "res48" not in name
                                        else 10, warm=False),
                          "sha256": digest.hexdigest()[:16]}
    print(json.dumps({
        "tree": str(build.CSRC.parents[3]), "card": card,
        "build_s": secs,
        "flash_phi4_mini_bf16_S4096_ms": cuda_ms(flash, 20),
        "wkv6_rwkv6_3b_bf16_S4096_ms": cuda_ms(wkv6, 10),
        "cfd": readings,
        "sass": {**sass_profile(build.library_path("fused_interval"),
                                "fused_interval_kernel"),
                 **sass_profile(build.library_path("poisson_sor"),
                                "cluster")}}))


def main():
    import argparse
    script_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="",
                    help=f"run only these of the phases "
                         f"{', '.join(STANDALONE_PHASES)} (comma-separated) "
                         f"after the build: a partial run, which prints no "
                         f"kernels line and no result line")
    ap.add_argument("--halo-golden", action="store_true",
                    help="run phase 12's golden at two ranks alone and "
                         "exit (the child process the whole run starts "
                         "before phase 10)")
    ap.add_argument("--compare", metavar="TREE", default="",
                    help="time phase 1's flash (dh 128) and WKV6 (N 64) "
                         "yardsticks and the CFD kernels at the training "
                         "shape and past one cluster (each output's digest "
                         "beside its time) "
                         "of TREE's repro_torch (a checkout "
                         "root, e.g. an older commit unpacked with git "
                         "archive) and exit: no kernels line, no result")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(STANDALONE_PHASES):
        ap.error(f"--phases takes {STANDALONE_PHASES}, got {phases}")
    sys.path.insert(0, str(Path(args.compare).resolve() / "src"
                           if args.compare else ROOT / "src"))
    import os
    # cuBLAS is repeatable under torch.use_deterministic_algorithms (phase
    # 7) only with a fixed workspace, set before its first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # float16 products of the twins and the reference mixers accumulate in
    # float32, as the kernels' do
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    if args.compare:
        compare_tree(card)
        return
    if args.halo_golden:
        secs = halo_golden(torch.device("cuda"))
        print(f"{HALO_GOLDEN_DONE} {secs}")
        return
    if phases:
        _, secs = wall(lambda: build.build(verbose=True))
        print(f"[build] {len(build.SOURCES)} kernels built in {secs:.2f} s")
        # with phase 10 before it, phase 12's golden runs beside it
        child = (start_halo_golden() if {"10", "12"} <= set(phases)
                 and phases.index("10") < phases.index("12") else None)
        run = {"10": fleet_path, "12": lambda c: halo_path(c, child),
               "13": serve_path, "14": train_path, "15": moe_path,
               "16": hybrid_path, "17": deepseek_path, "18": frontend_path,
               "19": mesh_path, "20": cost_path}
        try:
            for p in phases:
                _, secs = wall(lambda: run[p](card))
                print(f"[phase {p}] {secs:.3f} s")
        finally:
            if child is not None and child.poll() is None:
                child.kill()
                child.wait()
        print(f"partial run of phases {', '.join(phases)}: no kernels line, "
              f"no result")
        return
    stale_halo_jobs = start_stale_halo_build()
    no_cross_wait_jobs = start_variant_build("no_cross_wait", NO_CROSS_WAIT)
    odd_ghost_jobs = start_variant_build("odd_ghost", ODD_GHOST,
                                         ODD_GHOST_KERNELS)
    _, secs = wall(lambda: build.build(verbose=True))
    print(f"[build] {len(build.SOURCES)} kernels built in {secs:.2f} s -> "
          f"{build.BUILD_DIR}")
    stale_halo = stale_halo_libraries(stale_halo_jobs)
    no_cross_wait = stale_halo_libraries(no_cross_wait_jobs,
                                         "no-cross-wait")
    odd_ghost = stale_halo_libraries(odd_ghost_jobs, "odd-ghost")
    dev = torch.device("cuda")

    # each phase's seconds, phases 1-13 here (14-19 print their own)
    lap = {"t": time.perf_counter(), "start": time.perf_counter()}

    def done(n):
        now = time.perf_counter()
        print(f"[phase {n}] {now - lap['t']:.3f} s")
        lap["t"] = now

    # 1. each kernel against its plain twin at the training shape
    res16 = GridConfig(res=16)
    fused = check_fused(dev, res16, n_env=4, n_steps=50)
    short = hold_fused(dev, res16, n_env=4, n_steps=1)[0]
    fused["stale_halo_variant"] = stale_halo_rejected(
        dev, stale_halo["fused_interval"], res16, 4,
        ((50, fused["errors"]), (1, short)))
    fused["envs_32"] = fused_batch_reading(dev, res16, n_env=32, n_steps=50)
    fused["res_18_max_abs_err"] = max(hold_fused(
        dev, GridConfig(res=18), n_env=4, n_steps=10)[0].values())
    bodies = check_fused_bodies(dev, res16, n_env=4, n_steps=50,
                                scalar_ms=fused["ms"])
    bodies_short = hold_fused(dev, res16, 4, 1, bank_case,
                              " per-body (mixed bank)")[0]
    bodies["stale_halo_variant"] = stale_halo_rejected(
        dev, stale_halo["fused_interval"], res16, 4,
        ((50, bodies["errors"]), (1, bodies_short)), bank_case,
        " per-body (mixed bank)")
    fused["per_body"] = bodies
    sor = check_sor(dev, res16, n_env=4, iters=50,
                    wrong=stale_halo["poisson_sor"])
    sor_full = check_sor(dev, res16, n_env=4, iters=50, full=True,
                         wrong=stale_halo["poisson_sor_full"])
    # past one cluster: the resident kernels, the global-memory kernels
    # beside them as their yardstick, then on their own grids
    fused["resident"] = check_fused_resident(
        dev, stale_halo["fused_interval"], no_cross_wait["fused_interval"])
    sor["resident"] = check_sor_resident(dev, False, stale_halo["poisson_sor"],
                                         no_cross_wait["poisson_sor"])
    sor_full["resident"] = check_sor_resident(
        dev, True, stale_halo["poisson_sor_full"],
        no_cross_wait["poisson_sor_full"])
    fused["global"] = check_fused_global(dev, stale_halo["fused_interval"])
    sor["global"] = check_sor_global(dev, False, stale_halo["poisson_sor"])
    sor_full["global"] = check_sor_global(dev, True,
                                          stale_halo["poisson_sor_full"])
    fused["sync_floor_us"] = sync_floor(dev)
    # the two kernels of each function on a grid both serve
    fused["global"]["beside_cluster"] = fused_beside_cluster(dev)
    sor["global"]["beside_cluster"] = sor_beside_cluster(dev, False)
    sor_full["global"]["beside_cluster"] = sor_beside_cluster(dev, True)
    flash = check_flash(dev, get_config("phi4-mini-3.8b"), S=4096)
    flash["dh_256"] = check_flash_wide(dev)
    flash["float16"] = check_flash_f16(dev, get_config("phi4-mini-3.8b"))
    flash["column_split"] = check_flash_column_split(dev)
    wkv = check_wkv6(dev, get_config("rwkv6-3b"), S=4096)
    wkv.update(check_wkv6_wide(dev, get_config("rwkv6-3b"), S=4096))
    wkv.update(check_wkv6_f16_and_past_1024(dev, get_config("rwkv6-3b"),
                                            S=4096))
    fused["odd_width"], sor_full["odd_width"] = odd_widths(dev, odd_ghost)
    done(1)

    # 2. the main path: training at full width, depth cut to 2 episodes
    main_env = dict(steps_per_action=50, actions_per_episode=100,
                    warmup_time=30.0)
    print("[train fused] full width: res 16 (ny 66, nx 352), 50 dt per "
          "action, 60 SOR iterations, 2x512 MLP, 149 probes, 4 envs; depth "
          "cut: 2 episodes of 100 actions after a 30 t.u. warmup")
    launched, main_hist = run_train("fused", main_env, 2, dict(res=16))
    if launched["fused_interval"] < 1:
        fail("the main path did not launch the fused_interval kernel")
    fused["launches"] = launched["fused_interval"]
    fused["path"] = "train(backend='fused'), warmup + 2 episodes"

    # the multi-body path: a mixed cylinder + pinball batch, per-body
    # actuation through the per-body instantiation
    scenarios = ("cyl_re100", "pinball_re100")
    print("[train fused cyl_re100+pinball_re100] full width: res 16, 50 dt "
          "per action, 60 SOR iterations, 2x512 MLP, 149 probes (the "
          "pinball's 59 padded), act_dim 3, 4 envs (2 cylinder jets, 2 "
          "pinball rotary); depth cut: 1 episode of 100 actions after a "
          "30 t.u. warmup per (Re, actuation, geometry) group")
    launched, _ = run_train("fused", main_env, 1, dict(res=16), scenarios)
    intervals = main_env["actions_per_episode"]
    groups = 2                    # (100, jets, cylinder), (100, rotary, pinball)
    if (launched["fused_interval_per_body"] != intervals
            or launched["fused_interval"] != intervals + groups):
        fail(f"the multi-body path launched the per-body instantiation "
             f"{launched['fused_interval_per_body']} times (expected one "
             f"per interval, {intervals}) and the fused kernel "
             f"{launched['fused_interval']} times in all (expected "
             f"{intervals + groups}: the warmups' {groups} scalar launches)")
    bodies["launches"] = launched["fused_interval_per_body"]
    bodies["path"] = ("train(scenarios=('cyl_re100', 'pinball_re100'), "
                      "backend='fused'), warmup + 1 episode")

    # past one cluster: the default backend at res 48 runs the fused
    # resident kernel, one call for the warmup and one an interval, each
    # as many launches as groups of 4 envs the card holds at once; at res
    # 56 the global-memory kernel, one launch a call
    from repro_torch.kernels.actuation import ops as aops
    wide_env = dict(steps_per_action=50, actions_per_episode=4,
                    warmup_time=1.0)
    intervals = 1 + wide_env["actions_per_episode"]
    for res, kind in ((48, "resident"), (56, "global")):
        print(f"[train fused res {res}] full width: res {res}, 50 dt per "
              f"action, 60 SOR iterations, 2x512 MLP, 149 probes, 4 envs, "
              f"the default backend; depth cut: 1 episode of 4 actions after "
              f"a 1 t.u. warmup")
        plan = aops.launch_plan(GridConfig(res=res), 4, dev)
        want = intervals * plan.launches
        launched, _ = run_train("fused", wide_env, 1, dict(res=res))
        if (plan.kernel != kind
                or launched[f"fused_interval_{kind}"] != want
                or launched["fused_interval"] != want):
            fail(f"train() at res {res} launched the fused kernel "
                 f"{launched['fused_interval']} times, "
                 f"{launched[f'fused_interval_{kind}']} of them the {kind} "
                 f"kernel ({plan}): expected {want}, all {kind} ({intervals} "
                 f"calls)")
        fused[kind]["launches"] = launched[f"fused_interval_{kind}"]
        fused[kind]["path"] = (f"train(backend='fused') at res {res}, warmup "
                               f"+ 1 episode of 4 actions")
        fused[f"launches_{kind}"] = launched[f"fused_interval_{kind}"]
    done(2)

    # 3. the second path: one short episode with the packed-SOR kernel
    print("[train pallas] res 16, 4 envs; depth cut: 1 episode of 2 actions "
          "after a 1 t.u. warmup")
    launched, _ = run_train("pallas", dict(steps_per_action=50,
                                        actions_per_episode=2,
                                        warmup_time=1.0), 1, dict(res=16))
    if launched["rb_sor_slabs_packed"] < 1:
        fail("the pallas path did not launch the rb_sor_slabs_packed kernel")
    # one pressure solve per dt: the 1 t.u. warmup's dt and 2 actions' 50
    solves = max(1, round(1.0 / GridConfig(res=16).dt)) + 2 * 50
    print(f"[train pallas] {launched['rb_sor_slabs_packed']} packed-SOR "
          f"launches for the path's {solves} pressure solves")
    if launched["rb_sor_slabs_packed"] != solves:
        fail(f"the pallas path launched rb_sor_slabs_packed "
             f"{launched['rb_sor_slabs_packed']} times, expected one per "
             f"solve ({solves})")
    sor["launches"] = launched["rb_sor_slabs_packed"]
    sor["path"] = "train(backend='pallas'), warmup + 1 episode"

    # past one cluster: res 71, one slab no cluster holds, on the packed
    # SOR's resident kernel, and res 95, one slab no resident group holds,
    # on its global-memory kernel, one launch a solve each
    from repro_torch.kernels.poisson import ops as pops
    for res, warmup, kind in ((71, 1.0, "resident"), (95, 0.25, "global")):
        cfg = GridConfig(res=res, dt=FINE_DT[res])
        print(f"[train pallas res {res}] res {res} (ny {cfg.ny}, nx "
              f"{cfg.nx}: one slab), dt {FINE_DT[res]}, 4 envs; depth cut: 1 "
              f"episode of 2 actions after a {warmup} t.u. warmup")
        plan = pops.launch_plan(cfg.ny, cfg.nx // 2, 1, 4, dev)
        launched, _ = run_train("pallas", dict(steps_per_action=50,
                                            actions_per_episode=2,
                                            warmup_time=warmup), 1,
                                dict(res=res, dt=FINE_DT[res]))
        solves = round(warmup / FINE_DT[res]) + 2 * 50
        want = solves * plan.launches
        if (plan.kernel != kind
                or launched[f"rb_sor_slabs_packed_{kind}"] != want
                or launched["rb_sor_slabs_packed"] != want):
            fail(f"the pallas path at res {res} launched rb_sor_slabs_packed "
                 f"{launched['rb_sor_slabs_packed']} times, "
                 f"{launched[f'rb_sor_slabs_packed_{kind}']} of them the "
                 f"{kind} kernel ({plan}): expected {want}, all {kind}")
        sor[kind]["launches"] = launched[f"rb_sor_slabs_packed_{kind}"]
        sor[kind]["path"] = (f"train(backend='pallas') at res {res}, warmup "
                             f"+ 1 episode of 2 actions")
        sor[f"launches_{kind}"] = launched[f"rb_sor_slabs_packed_{kind}"]
    done(3)

    # 4. the language-model loss paths at full width
    flash["launches"], flash["lm_first_s"], flash["lm_steady_s"] = run_lm(
        dev, "phi4-mini-3.8b", 4096, "flash_attention")
    flash["path"] = "lm_loss(phi4-mini-3.8b, backend='pallas'), B=1, S=4096"
    wkv["launches"], wkv["lm_first_s"], wkv["lm_steady_s"] = run_lm(
        dev, "rwkv6-3b", 4096, "wkv6", per_layer=2)
    wkv["path"] = "lm_loss(rwkv6-3b, backend='pallas'), B=1, S=4096"
    # the wide heads through the same entry point, at the models' widths,
    # 4 of 32 layers: phi4-mini's 3072 as 12 heads of 256 over 4 KV heads,
    # rwkv6-3b's 2560 as WKV6 heads of 256 and 512
    phi = get_config("phi4-mini-3.8b")
    phi256 = dataclasses.replace(phi, name=f"{phi.name}-dh256", head_dim=256,
                                 num_heads=12, num_kv_heads=4, num_layers=4)
    wide = flash["dh_256"]
    wide["launches"], wide["lm_first_s"], wide["lm_steady_s"] = run_lm(
        dev, phi256.name, 4096, "flash_attention", cfg=phi256)
    wide["path"] = ("lm_loss(phi4-mini-3.8b at dh 256: 12 heads over 4, 4 "
                    "layers, backend='pallas'), B=1, S=4096")
    for N in WKV6_WIDE:
        c = rwkv_at_head(get_config("rwkv6-3b"), N, layers=4)
        wide = wkv[f"n_{N}"]
        wide["launches"], wide["lm_first_s"], wide["lm_steady_s"] = run_lm(
            dev, c.name, 4096, "wkv6", per_layer=2, cfg=c)
        wide["path"] = (f"lm_loss(rwkv6-3b at N {N}: {c.num_heads} heads, 4 "
                        f"layers, backend='pallas'), B=1, S=4096")
    # float16 params and compute at full width and depth: the float16
    # flash instantiation 32 times, the float16 WKV6 one 64 times
    f16 = dict(param_dtype="float16", compute_dtype="float16")
    holds = {}
    for cfg, kernel, per_layer, views, row in (
            (phi, "flash_attention_f16", 1, (), flash["float16"]),
            (get_config("rwkv6-3b"), "wkv6", 2, ("wkv6_float16",),
             wkv["float16"])):
        c = dataclasses.replace(cfg, name=f"{cfg.name}-float16", **f16)
        row["launches"], row["lm_first_s"], row["lm_steady_s"] = run_lm(
            dev, c.name, 4096, kernel, per_layer, cfg=c, views=views)
        row["path"] = (f"lm_loss({cfg.name}, float16 params and compute, "
                       f"backend='pallas'), B=1, S=4096")
        holds[c.name] = row["launches"]
    # past dh 256 and N 1024, 4 of 32 layers at the models' widths:
    # phi4-mini's 3072 as 6 heads of 512 over 2 (the column-split kernel),
    # rwkv6-3b's 2560 as 2 WKV6 heads of 1280 (2 clusters a problem: the
    # two passes and the add of the clusters' parts, 3 launches a layer)
    phi512 = dataclasses.replace(phi, name=f"{phi.name}-dh512", head_dim=512,
                                 num_heads=6, num_kv_heads=2, num_layers=4)
    row = flash["column_split"]["dh_512"]["bfloat16"]
    row["launches"], row["lm_first_s"], row["lm_steady_s"] = run_lm(
        dev, phi512.name, 4096, "flash_attention", cfg=phi512,
        views=("flash_attention_column_split",))
    row["path"] = ("lm_loss(phi4-mini-3.8b at dh 512: 6 heads over 2, 4 "
                   "layers, backend='pallas'), B=1, S=4096")
    holds[phi512.name] = row["launches"]
    c = rwkv_at_head(get_config("rwkv6-3b"), 1280, layers=4)
    row = wkv["past_1024"]["n_1280"] = {}
    row["launches"], row["lm_first_s"], row["lm_steady_s"] = run_lm(
        dev, c.name, 4096, "wkv6", per_layer=3, cfg=c,
        views=("wkv6_multi_cluster",))
    row["path"] = ("lm_loss(rwkv6-3b at N 1280: 2 heads, 4 layers, "
                   "backend='pallas'), B=1, S=4096: chunk pass, state pass "
                   "and add a layer")
    holds[c.name] = row["launches"]
    done(4)

    # 5. the full-grid drop-in solve
    sor_full["launches"] = run_sor_full(dev, res16, n_env=4, iters=50)
    sor_full["path"] = "rb_sor(packed=False), res 16, 4 grids, iters=50"
    for res, kind in ((71, "resident"), (95, "global")):
        sor_full[kind]["launches"] = run_sor_full(
            dev, GridConfig(res=res), n_env=4, iters=50)
        sor_full[kind]["path"] = (f"rb_sor(packed=False), res {res}, 4 grids,"
                                  f" iters=50")
        sor_full[f"launches_{kind}"] = sor_full[kind]["launches"]
    done(5)

    # 6. golden physics through the fused kernel
    golden(dev)
    golden_pinball(dev)
    done(6)

    # 7. the attention policy and the robust training path
    bodies["robust_path_launches"] = robust_path(float(main_hist["wall"][-1]))
    bodies["robust_path"] = (
        "train(policy='attention', scenarios=('cyl_re100', 'pinball_re100'),"
        " ckpt_dir=..., resume=..., watchdog=True): 2 + 1 + resumed 1 + "
        "nan_env 1 + grad_nan 1 + watchdog 3 episodes, then 2 of the MLP "
        "and 2 without deterministic algorithms")
    if bodies["robust_path_launches"] < 1:
        fail("the robust path did not launch the per-body instantiation")
    done(7)

    # 8. the I/O path: record, replay, durability, the file interface
    fused.update(io_path(card))
    done(8)

    # 9. the async trainer and the planner
    planned = async_path(card)
    fused.update(planned["fused"])
    sor.update(planned["sor"])
    done(9)

    # 10. fleet mode through the launcher, phase 12's golden beside it in
    # a child process
    child = start_halo_golden()
    try:
        fleet = fleet_path(card)
        fused.update(fleet["fused"])
        sor.update(fleet["sor"])
        done(10)

        # 11. the user-facing scripts
        scripts_path(card, fleet["ckpt_dir"])
        done(11)

        # 12. the halo decomposition: multi-rank plans on the card
        halo = halo_path(card, child)
        fused.update(halo["fused"])
        sor.update(halo["sor"])
        done(12)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()

    # 13. the language model's serving path
    serve_flash, serve_wkv = serve_path(card)
    flash.update(serve_flash)
    wkv.update(serve_wkv)
    done(13)

    # 14. the language model's training path (no kernel on it)
    _, secs = wall(lambda: train_path(card))
    print(f"[phase 14] {secs:.3f} s")

    # 15. the mixture of experts
    moe, secs = wall(lambda: moe_path(card))
    flash.update(moe)
    print(f"[phase 15] {secs:.3f} s")

    # 16. the hybrid family
    hyb, secs = wall(lambda: hybrid_path(card))
    flash.update(hyb)
    print(f"[phase 16] {secs:.3f} s")

    # 17. MLA, the MTP head and deepseek-v3 (no kernel on its path)
    _, secs = wall(lambda: deepseek_path(card))
    print(f"[phase 17] {secs:.3f} s")

    # 18. the encoder-decoder and the modality frontends
    fronts, secs = wall(lambda: frontend_path(card))
    flash.update(fronts)
    print(f"[phase 18] {secs:.3f} s")

    # 19. the language model's mesh layer, one controller on the card
    meshed, secs = wall(lambda: mesh_path(card))
    if meshed["mesh_launches"] < 1:
        fail("the mesh path did not launch the flash kernel")
    flash.update(meshed)
    print(f"[phase 19] {secs:.3f} s")

    # 20. the cost counter against the card
    costs, secs = wall(lambda: cost_path(card))
    fused["counted_interval"] = costs["fused_interval"]
    flash["counted_lm_loss"] = costs["lm_loss"]["kernels_on_card"]
    print(f"[phase 20] {secs:.3f} s")
    from repro_torch import kernels as kernels_mod
    if sum(kernels_mod.FALLBACKS.values()):
        fail(f"fallbacks counted in this process: "
             f"{dict(kernels_mod.FALLBACKS)}")
    print("[fallbacks] none counted in this process (phases 1-20), phase "
          "1's odd widths included (each on its kernel); the child "
          "processes run on the card, which counts none either")
    now = time.perf_counter()
    print(f"[chip_smoke] phases 1-20 in {now - lap['start']:.3f} s after "
          f"the build; the whole script {now - script_start:.3f} s")
    for name, n in holds.items():
        print(f"[holds] {name}: lm_loss(backend='pallas') held block by "
              f"block against backend='reference' (phase 4), {n} launches "
              f"of its instantiation")

    # 21. the kernels, the card, the result
    print(json.dumps({"kernels": [fused, sor, sor_full, flash, wkv]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

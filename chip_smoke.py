#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card: ``nvidia-smi`` name and power limit; CUDA must be available;
2. build: every CUDA kernel from ``distributed_pipeline_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel), with each kernel's registers,
   shared memory and spills from the compiler's report;
3. decode kernel: ``flash_decode`` against its plain version
   ``torch_paged_decode`` at the serving shapes (H=12, Dh=64, page_size 16,
   32 slots, 64-page reservations; an empty slot, page edges, interior and
   full-reservation positions, a shared page), over fp pools in f32 and
   bf16 and int8 pools (per-page scales) with f32 and bf16 q, plus one slot
   at position 1023 (64 one-page chunks) and positions on both sides of
   every chunk edge; two calls on the same inputs must be bitwise equal.
   The bf16 and int8 kernels are timed by ``torch.profiler`` device time
   (clean cold L2, and after a dirty flush) in turns beside one
   ``scaled_dot_product_attention`` call over pre-gathered (and, for int8,
   dequantized) K/V (a yardstick the port never calls), with the plain
   version's time and the bound: the kernel's own bytes,
   ``decode_hbm_bytes(step_table=False)``, over the card's memory rate;
4. flash kernels: ``flash_forward`` / ``flash_backward`` against
   ``torch_flash_forward`` / ``torch_flash_backward`` at the training shape
   (B=4, H=12, L=1024, Dh=64, causal, bf16, the all-ones pad mask the model
   passes), a padded ragged bf16 case (L=1000, lengths 1000/733/1/0),
   small f32 cases (Dh 64 and 128), and bf16 cases at Dh=128 (L=1024),
   at L = 1, 65 and 129 (ragged against the 128-row tile) and non-causal
   with a dead row; bf16 is held against the plain version evaluated in
   f32 from the same bf16 inputs, and two bf16 backward calls on the same
   inputs must give bitwise-equal dq, dk and dv (dq's parts are summed in a
   fixed order), as must a call whose key tiles are split over several
   launches (the dq scratch cap made small). Times at the training
   shape beside ``scaled_dot_product_attention(is_causal)`` and its
   autograd backward (yardsticks), in turns in one call: device time from
   ``torch.profiler`` (the CUDA-event time, which also counts the host's
   enqueue, beside it), with the plain versions' times, achieved TFLOP/s,
   share of the bound and the ratio to the library;
5. fused update: ``fused_adamw_ema`` against ``torch_fused_update`` over
   GPT-2 base's parameter count with 3 EMA rates, bitwise over 3 steps,
   timed beside its byte bound and ``torch.optim.AdamW(fused=True)`` (a
   yardstick only: another op order and no EMA);
6. small-model check: greedy serving of a small f32 GPT-2 on the GPU
   (through the kernel) gives the same tokens as on the CPU (plain
   version);
7. serve: GPT-2 base at full width (hidden 768, 12 layers, 12 heads, vocab
   50257, seq_len 1024) with seeded random weights, through ``run.serve``
   on 32 slots, 64 requests of 256 prompt tokens, 128 new tokens each,
   greedy, twice: over a bf16 KV pool and with ``--kv_quant int8``. Every
   request must get its tokens, the kernel must have run 12 x decode_span
   x decode_steps times over that run's page type (and never over the
   other); then one decode step from a live state through the kernel and
   through the plain version, logits compared and next tokens equal (the
   int8 pool at f32 compute, where both arms read the same K/V values; its
   bf16 comparison is printed), and the kernel timed at that state's
   depths beside its bound there. The int8 pool must hold at most 0.55x
   the fp pool's bytes;
7b. speculative decoding: the span seam's kernel arm at the serve shapes
   (32 slots x (K + 1) links, K = 4) over bf16 and int8 pools against
   ``torch_paged_span_decode``: bf16 q on the span kernel ``flash_span``
   (launches on its counter, none on the decode kernel's), f32 q on the
   decode kernel over 32 x (K + 1) pseudo-slots (the decode phase's bars;
   two calls bitwise equal); the span kernel timed beside its bound
   (``span_hbm_bytes``), the pseudo-slot route on the same bf16 inputs and
   one ``scaled_dot_product_attention`` call over pre-gathered K/V with a
   [K + 1, Lmax] mask; then ``run.serve --spec_tokens 4`` at GPT-2 base
   width: the ngram draft over a bf16 pool (the serve phase's 64
   requests) and the model draft (``--draft_layers 2``) over an int8 pool
   (16 requests): every request's tokens, the span launches (12 a verify
   round, all on the span kernel), tokens/s and ``accept_rate`` beside the
   non-spec run's; in bf16 the share of streams identical to the non-spec
   run's and the top-2 logit gap at every first divergence (each at most
   2% of that position's largest |logit|); and at f32 compute (the pseudo-slot
   route), 32 requests of 64 tokens on each pool, the spec streams equal
   the non-spec ones token for token;
7c. serving options, at GPT-2 base width: the serve phase's runs above go
   through the engine that captures each phase once as a CUDA graph and
   replays it (run.serve's default); each is served again through the
   eager engine (bf16 pool, int8 pool, ``--spec_tokens 4`` ngram): every
   stream identical token for token, every launch counter equal (the
   graph's counted through its replays), tokens/s and TTFT p50/p95 of
   both (no profiled pass, for the script's wall:
   ``scripts/profile_torch_serve.py`` measures the engines' idle shares);
   ``--sanitize true`` on the bf16 workload (``recompile_count``
   0, one capture per phase, no violation in ``sanitize_report.json``,
   then a sync injected into a dispatch through the engine's test hook
   raises and is recorded); whether a prefill's K/V rows are bitwise
   equal at another batch row (printed: the prefix cache does not rely
   on it); ``--prefix_cache true --shared_prefix_len 256
   --synthetic_prompt_len 384 --traffic poisson`` (32 requests) against
   the same run without the cache (streams equal, hits > 0, the pool
   whole after the drain); ``--serve_quant int8 --cost_ledger true``
   (every request's tokens, tokens/s, the share of streams equal to the
   unquantized run's; ``serve_decode`` and ``serve_prefill`` rows, the
   gap-sum identity within 1e-9, ``mfu`` in (0, 1));
8. train: GPT-2 base at full width and its 1024 context through
   ``run.train`` (synthetic-lm, batch 8 in microbatches of 4, 20 steps, lr
   3e-4, EMA 0.5/0.9/0.99, attention and update ``auto``): the flash
   kernels must run 12 x 2 x 20 times each and the update once a step,
   every loss must be finite and the last below the first, the run dir
   must hold the final model/EMA/optimizer files and ``run.serve`` must
   answer 4 requests from it; then one step from the saved state with the
   kernels and with the plain versions, loss and grad norm compared, and a
   second kernel step from the same state bitwise equal to the first
   (loss, grad norm, every gradient);
9. diffuseq: DiffuSeq-base at full width (hidden 768, 12 layers, 12 heads,
   emb_dim 128, vocab 8192, seq_len 128, 2000 ``sqrt`` diffusion steps;
   91,039,872 parameters) through ``run.train`` with the JAX package's
   defaults (no family flag; batch 256 in microbatches of 64, 20 steps,
   EMA 0.5/0.9/0.99, attention and update ``auto``): the update must run
   once a step and the flash kernels never (the dense arm at 128, the JAX
   rule), every loss finite and the last below the first, the run dir's
   final files present; one step from the saved state with the fused
   update and with its plain version; then DiffuSeq-base at seq_len 1024
   (batch 8 in microbatches of 4, padded rows), one step through ``auto``
   (the flash kernels' bidirectional, pad-masked arm: 24 + 24 launches, 1
   update) and one through the plain versions (none), loss within 0.5% and
   grad norm within 3%; then ``run.sample`` on the trained run dir (2
   batches of 32, 20 reverse-diffusion steps): ``decode_acc`` in [0, 1],
   ``eval_loss`` finite. The fused update is also held against its plain
   version and timed at DiffuSeq-base's parameter count (phase 5's checks);
10. GPT-2 decoding and eval, on the train phase's run dir (GPT-2 base,
   step 20; run between phases 8 and 9): ``run.sample`` greedy, 2 batches
   of 8 rows with 512-token prompts, through the graph engine (every row
   gets 512 generated tokens, the decode kernel runs 12 x 2 x 511 times
   and its plain version never; ``decode_acc`` in [0, 1], ``eval_loss``
   finite; wall and generated tokens/s); ``gpt2_decode`` (dense KV cache)
   on batch 0 in bf16 (the flash forward 12 times, the prefill; each row
   equal to run.sample's or parting at a near-tie, the share printed); at
   f32, 4 rows with 960-token prompts, ``one_shot_decode`` and
   ``gpt2_decode`` token-identical (both prefills on the flash forward);
   ``--temperature 1.0 --top_k 50`` seeds 0 and 1 on one reused graph
   server, each equal to a fresh eager server at that seed, the two
   different; ``run.sample --ema 0.99`` (``"params": "ema_0.99"``) and
   ``run.serve --ema 0.99`` (4 requests); ``run.train --model_family gpt2
   --eval_decode true``, 4 steps, an eval every 2 (``decode_acc`` in
   ``progress.csv``, the flash forward launched by the training and eval
   passes plus 12 a callback); the port's native library built and
   loaded, native and Python BPE ids equal over a seeded corpus (host
   times), and the tokenizer CLI writing ``bpe.json``. Its JSON line is
   ``{"gpt2_decoding": {...}}``;
11. serving fleet, on the same run dir after phase 10: ``run.serve
   --replicas 2`` (two supervised replica processes on the one card, each
   32 slots, the serve workload's geometry, greedy, bf16 pool, graph
   engine, 64 poisson requests at 2.5/s) against the single-replica
   ``run.serve`` of the same requests: every request completes, every
   stream equal or parting at a bf16 near-tie, every replica's exit code
   0, and each replica's sidecar shows the decode kernel launched and the
   plain version never called (with its peak device memory); the same
   with a ``kill_replica`` fault on replica 1 (``replayed >= 1``, a
   second attempt in its ``attempts.jsonl``); a hot swap after 32
   completions to a step-21 checkpoint (step 20 plus seeded noise): both
   replicas moved, one at a time, requests after the swap equal a fresh
   server at step 21; a ``corrupt_swap_checkpoint``: the
   canary refuses, no replica moves, every request served off step 20,
   over ``--serve_transport socket`` (one run holds both checks);
   ``--replicas 1 --disagg 1`` (16
   requests; the decode worker's decode kernel launched, plain never).
   The fleet runs are ``run.serve`` processes side by side in two
   groups, the plain, killed and disaggregated runs, then the two swaps
   (their walls, rates and TTFTs printed as contended). Tokens/s and
   TTFT p50/p95 beside the single run's; its line is
   ``{"serving_fleet": {...}}``;
12. data-parallel training: GPT-2 base at full width (seq 1024,
   synthetic-lm, global batch 8 in global microbatches of 4, 5 steps from
   seed 0) through ``python -m distributed_pipeline_tpu_torch.run.train``
   as subprocesses: without ``--distributed``, alone (its step time is
   the one read), then side by side (their step and all-reduce seconds
   share the card and the host, printed as contended): with
   ``--distributed --nprocs 1`` (a one-rank NCCL group), whose losses,
   grad norms and final parameters (``train_summary.json``'s SHA-256) must
   be bitwise the first run's; and with ``--distributed --nprocs 2`` (two
   gloo ranks sharing ``cuda:0``, batch 4 in microbatches of 2 each),
   whose two ranks' final parameters must be bitwise equal and whose
   losses and grad norms must match the one-rank run's within bf16
   rounding at the other microbatch shape (loss 5e-3, grad norm 3e-2
   relative: the bars of phase 8's kernel-against-plain step). Every rank
   must launch the flash forward and backward 12 x 2 x 5 times and the
   fused update 5 times, and call no plain version; each rank's backend,
   device, launches, all-reduce seconds a step, step time, tokens/s and
   peak memory are printed from its sidecar. Its line is
   ``{"data_parallel": {...}}``;
13. mixture of experts and remat: GPT-2 base moe8 (8 experts,
   top-2, every 2nd block, capacity factor 1.25; 322,574,592 parameters,
   152,705,280 active a token) through ``run.train`` (synthetic-lm,
   global batch 8 in microbatches of 4, seed 0, 5 steps), without and with
   ``--remat true``: losses, ``moe_aux``, grad norms and the final
   parameters' SHA-256 bitwise equal, peak memory lower with remat, the
   flash forward launched 120 times without remat and 240 with it, the
   backward 120, the update 5, the plain versions never; tokens/s,
   ``mfu``, ``mfu_active``, step time and peak memory of each; one step
   from the saved state with the kernels (twice, bitwise) and with the
   plain versions (the train phase's bars); ``run.serve`` on that run dir
   (bf16 pool, 32 slots, 16 requests of 256 tokens, 64 new each, greedy)
   through the graph engine under ``--sanitize`` (0 recompiles) and the
   eager engine, streams equal, the decode kernel launched, the first 4
   streams against ``gpt2_decode`` (equal or parting at a near-tie);
   DiffuSeq-base moe8 (289,257,600 parameters, 119,388,288 active; batch
   256 in microbatches of 64) 20 steps, the update 20 times, no flash
   launch (the dense arm at 128), then ``run.sample`` (2 x 32 rows, 20
   steps); DiffuSeq-large at seq 512 (batch 128 in microbatches of 8) 3
   steps without and with remat, bitwise equal, peak lower with remat.
   The three DiffuSeq runs are ``run.train`` processes beside the GPT-2
   runs in this one (read from their sidecars, their peak the process's;
   contended), and so is phase 21 (d)'s stacked moe8 process. The fused update is also held against its plain version
   and timed at GPT-2 base moe8's parameter count. Its line is
   ``{"moe_remat": {...}}``;
14. sequence parallelism: ``flash_attention_lse`` on the kernels
   (forward ``(out, lse)``, and the backward of a random ``(g_out,
   g_lse)``: the kernel backward's ``g_lse`` arm) against the plain
   versions, bf16 and f32, Dh 64 and 128, causal and not, at GPT-2's hop
   shape [4, 12, 512, 64] and with fully masked rows (out 0, a finite lse
   below NEG_INF / 2, zero gradients; the bars must fail a backward that
   drops ``g_lse``), at ``flash_check``'s bars; the bf16 backward timed
   with and without ``g_lse`` at [4, 12, 512, 64] and [4, 12, 1024, 64]
   (causal, in turns, each by CUDA-graph replays behind an L2 flush);
   then ``run.train --distributed --nprocs 2 --sequence 2`` (two gloo
   ranks on ``cuda:0``, one data group, 512 tokens a rank) on phase 12's
   GPT-2 base workload (batch 8 in microbatches of 4, 5 steps, seed 0):
   losses and grad norms held to phase 12's run without a group (phase
   12's bars), the ranks' final
   parameters bitwise equal, rank 0 launching the flash forward and
   backward 120 times (its diagonal hops) and rank 1 240, every backward
   on the ``g_lse`` arm, the update 5 times, no plain call; each rank's
   ring-shift seconds a step, step time and peak memory; and DiffuSeq-base
   at seq 1024 (bidirectional and pad-masked: both ranks launch on both
   hops and the mask rotates; batch 8 in microbatches of 4, 3 steps) with
   ``--sequence 2`` held to the same run in one process; the three runs
   side by side, after the kernel timings (their seconds printed as
   contended). Its line is
   ``{"sequence_parallel": {...}}``, and the kernels line gains the
   ``flash_attention_lse`` row (the ``g_lse`` arm);
15. training tooling, last: DiffuSeq-base at full width (phase 5's batch,
   256 in microbatches of 64, seed 0, 6 steps, a save every 2, keeping
   2) through ``run.train --distributed --nprocs 1 --max_restarts 3``,
   three rings, (b) alone (its laps are the ones read), then (a) beside
   (c) (printed as contended): (a) ``corrupt_checkpoint`` + ``kill`` at
   step 4 in ``DPT_CHAOS_PLAN``: attempts ``(-9, end 4)`` and ``(0, end
   6)``, both ``.chaos_fired_*`` markers, the walk-back to step 2 in the
   log,
   ``aggregate_run`` with ``recompute_s > 0`` and ``accounted_frac``
   within 0.01 of 1 (this ring also arms ``--cost_ledger``, for phase
   16); (b) the uninterrupted twin with ``--trace
   --cost_ledger --sanitize --profile_dir D --profile_steps 2:4``: step-6
   parameters bitwise (a)'s, the fused update launched once a step in
   each finished attempt and its plain version never, the profiler trace
   naming the fused update kernel exactly twice, an empty
   ``sanitize_report.json``, a ``train_step`` ledger row whose gaps sum
   to 1 and whose ``mfu`` is the logged one, the step spans within 2% of
   the goodput step time (useful + recompute + data stall), one compile
   span of ``compile_s``; the twin saves once, at step 6 (its laps
   overlap no background write), its copy and its wait a span each,
   summing to ``save_s``; (c) ``stall_step`` at step 3 for 600 s under
   ``--hang_timeout_s 12 --hang_startup_timeout_s 120 --log_interval
   0``: the watchdog kills attempt 0 (``hung``, ``hang_s`` in [12, 17]),
   attempt 1 finishes, the fold books ``hang_s``; the twin's logged
   losses (each row the step before its own: the metrics stay one step
   in flight at a log) equal this ring's history at steps 3-5. Its line
   is ``{"training_tooling": {...}}`` (each attempt's seconds, the goodput
   folds, the beacon's cost a step, the twin's step times, steady lap,
   saves (copy and wait seconds each) and peak memory), and the DiffuSeq
   update row gains ``launches_tooling``;
16. the run readers: ``obs/export.py`` (the twin's Perfetto timeline
   loads as JSON with its 6 step and 2 save spans; the Prometheus
   snapshots of the twin and the fleet dir parse), ``run/status.py`` (each
   ring's goodput is ``aggregate_run``'s), ``run/perf_report.py`` (the
   ``train_step`` row renders), ``obs/regress.py`` (``compare_runs`` over
   the chaos ring's and the twin's ledger rows gives a verdict), the fleet
   dir of phase 11's kill run (its journal's completed and replayed
   counts are the fleet summary's), and the three CLIs as subprocesses;
   no new training. Its line is ``{"run_readers": {...}}``;
17. MoE and ``--eval_decode`` under ``--sequence 2``: GPT-2 base moe8
   (phase 13's shapes and flags) 5 steps on two sequence ranks sharing
   ``cuda:0`` over gloo against phase 13's run in one process without a
   group (every step's loss and step 1's grad norm within bf16
   rounding; the later grad norms recorded: a flipped expert choice moves
   the capacity claims after it; the ranks' parameters bitwise equal;
   launches a rank: the flash kernels 120 and 240, the update 5); then
   GPT-2 base at
   ``--sequence 2 --eval_decode true --eval_interval 2``: the step-2
   eval's ``decode_acc`` (decoded by the first sequence rank outside the
   ring) equals the one-process callback's on the saved step-2 weights;
   the two runs side by side (their seconds printed as contended). Its
   line is ``{"moe_eval_decode_sequence": {...}}``; the flash,
   ``flash_attention_lse`` and update rows gain ``launches_moe_sp2`` and
   (flash and GPT-2 update) ``launches_eval_decode_sp2``;
18. the sharded training state, last: phase 12's GPT-2 base workload
   (batch 4 in microbatches of 2 a rank, 5 steps, two gloo ranks sharing
   ``cuda:0``) through ``run.train`` three times ((a) alone, then (b)
   beside (c), printed as contended), each held to phase 12's
   ``--nprocs 2`` run: (a) ``--shard_optimizer true --save_interval 3``:
   losses and the final parameters' SHA-256 bitwise, grad norms within
   1e-6 relative, the flash kernels 120 launches each way and the fused
   update 5 a rank over the shard's elements (printed), no plain call,
   ``opt_state_bytes_per_replica`` and ``ema_bytes_per_replica`` half of
   phase 12's within the padding, each rank's peak memory printed beside
   phase 12's; (b) ``--fsdp 2`` (dp 1, the same global batch): losses and
   grad norms within phase 12's bars (5e-3, 3e-2; the gradients are
   reduced a microbatch at a time), the ranks bitwise equal,
   ``params_bytes_per_replica`` below the whole, the peak below phase
   12's and printed beside (a)'s, the largest gathered unit's bytes
   printed; (c) (a)'s step-3 checkpoint (full tensors) resumed at
   ``--nprocs 2`` without ZeRO-1 into a fresh run dir through
   ``--resume_checkpoint``, run beside (b) (so (b)'s seconds share the
   card and the host): steps 4-5 and the final parameters bitwise phase
   12's. The fused update is held against its plain version and timed at
   the shard's element count with the other update rows (the kernels
   line's ``fused_adamw_ema_gpt2_zero1_shard`` row, ``AdamW(fused=True)``
   at that size beside it; phase 18 checks its element count is the
   runs'). Its line is ``{"sharded_state": {...}}``; the flash rows gain
   ``launches_zero1``/``launches_fsdp2``.
19. stacked layers and pipeline parallelism (budget 200 s): phase
   12's GPT-2 base workload (batch 8 in microbatches of 4, 5 steps) with
   ``--scan_layers true``, through ``run.train``: (a) no group, each loss
   within 2e-3 relative of phase 12's run without a group (named blocks;
   the largest difference printed); (b) ``--nprocs 2 --pipe 2
   --pp_schedule 1f1b --pp_chunks 4 --save_interval 3`` beside (a): both
   ranks' losses equal; step 1's loss within 1e-6 relative of (a)'s (the
   chunks' f32 loss sums) and its grad norm within 1e-3, every loss
   within 5e-3 relative (phase 12's bar
   across a change of microbatch split: each one-row chunk's weight
   gradient rounds to bf16 before the f32 sum, and Adam turns that into
   differences of ~3e-3 by step 5, over the 1e-3 absolute first set for
   this phase); the 1F1B stash's peak ``stash_size(4, 2) = 3`` at stage
   0; (c) gpipe with ``--eval_decode true --eval_interval 3
   --save_interval 3`` (8 rows, prompt 512; one eval, so the last log
   window is a plain step): held to (a) as (b), ``decode_acc`` logged and
   the step-3 decode's token digest equal to ``gpt2_decode`` of the
   step-3 checkpoint at ``--pipe 1``; (d)
   ``interleaved --pp_virtual 2``: held to (a) as (b), rank 0 holding
   layers 0-2 and 6-8, rank 1 3-5 and 9-11; (e) (b)'s step-3 checkpoint
   (block tensors of leading dim 12) resumed with no group to step 5,
   step 4 within 1e-6 relative of (b)'s and step 5 within 5e-3; (f) DiffuSeq-base
   at the DiffuSeq phase's flags (batch 256 / 64, 20 steps, seed 0) on
   ``--nprocs 2 --pipe 2``, the first 3 losses within 2e-3 relative of
   that phase's. (b) runs alone (its step and exchange seconds are the
   ones read), then (a), (c), (d), (e) and (f) together, so their seconds
   share the card (printed as contended). (c) and (d) run
   5 steps, not 3: the learning rate
   anneals over ``--learning_steps``, and a 3-step run's third loss would
   follow another rate than (a)'s. Launches, exact, from each rank's
   sidecar: a rank holds 6 layers and a step runs 2 microbatches of 4
   one-row chunks, so 1F1B and interleaved launch the flash forward
   2 x 4 x 6 x 2 = 96 times a step (the B slot recomputes the stage) and the backward
   48, GPipe 48 and 48; (c)'s eval pass (the forward-only stream) 48
   forwards, and stage 0's decode 12 (the prefill at L 1024); the fused
   update once a step over the rank's 81,871,104 elements (its stage's 6
   x 7,080,960 block elements and the 39,385,344 of the rest). Each run
   prints its step time, ``pipe_p2p_s_per_step``, the bytes sent and each
   rank's peak memory. The update is timed at that element count with
   the other update rows (``fused_adamw_ema_gpt2_pipe2_stage``). Its
   line is ``{"pipeline": {...}}``; the flash rows gain
   ``launches_pipe_1f1b``/``_gpipe``/``_interleaved``.
20. the MPMD pipeline runtime (budget 120 s): phase 19's GPT-2 base
   flags (batch 8, 5 steps, seed 0) through ``run.train --mpmd true
   --mpmd_stages 2 --pp_schedule 1f1b --pp_chunks 4`` (a torch-free
   driver, two stage rings of one process each on ``cuda:0``, the frames
   through files), three runs side by side (their seconds share the card
   and the host, printed as contended: with (a) alone the phase does not
   fit its budget): (a) the 5 losses within 1e-6 relative of
   ``run_pipeline_inprocess`` of the same config on the card, step 1
   within 1e-6 relative of phase 19 (a)'s and step 2 within 5e-3 (later
   steps part: the stages' learning rate is constant, run.train's
   anneals), ``rewinds`` 0, ``accounted_frac`` within 0.01 of 1 with
   ``link_wait_s`` in the fold; stage 0 launches the flash forward 240
   times (its B recomputes the stage) and the backward 120, stage 1 120
   and 120, the fused update and the plain versions never; each stage's
   peak memory, step seconds (and of them the data's and the math's),
   link wait, save seconds, act-frame and snapshot bytes printed; (b)
   the same with ``DPT_MPMD_KILL=1:3``: ``rewinds`` 1, attempts [1, 2],
   the losses bitwise (a)'s; (c) DiffuSeq-base at seq 128, batch 8 in 4
   chunks, 3 steps (the JAX bench leg
   ``diffuseq-base-seq128-mpmd-pipe``'s traffic at full width): losses
   within 1e-5 relative of the in-process runner, ``accounted_frac``
   within 0.01 of 1. The in-process references run beside the three.
   Each run dir's bytes are printed before it is removed (a GPT-2 stage
   snapshot is ~0.98 GB a step). Its line is ``{"mpmd": {...}}``; the
   flash and GPT-2 update rows gain ``launches_mpmd`` (per stage).

21. the pipe's compositions, after phase 20 (budget 120 s, aiming at
   90): GPT-2 base at full width and depth through ``run.train
   --distributed --nprocs 4 --pipe 2 --scan_layers true`` (four gloo
   ranks on ``cuda:0``), phase 19's flags with one EMA rate (5 steps:
   the learning rate anneals over them, and phase 19's runs hold these):
   (a) alone, ``--fsdp 2`` under 1F1B, batch 8 (4
   a row group) in microbatches of 4 (2), one-row chunks as phase 19's
   1F1B: within 1e-6 of phase 19's 1F1B at step 1 and 5e-3 at every
   step, grad norm 1e-3 at step 1; launches 240 / 120 / 5 a rank (2
   microbatches x 2 chunks x 6 layers, the B slot recomputing); each
   rank's update over its 60,637,440 local elements (its fsdp piece of
   its stage's cut weights, its stage's LayerNorm rows, the rest whole),
   the ranks' update shares summing to the model; one stage gather a
   microbatch (4 x 42,467,328 B); peak memory a rank beside phase 19's
   1F1B peaks. Then side by side (contended): (b) ``--dp 2
   --shard_optimizer`` under 1F1B, the same batches, each rank owning
   40,935,552 of its 81,871,104, within (a)'s bar of (a) (bitwise where
   the two-term sums allow it is printed); (c) ``--sequence 2`` (a 1F1B
   request: the ring inside a stage takes GPipe) at L 1024 with phase
   19's GPipe flags: the ring's partners from the mesh (ranks 0 and 2,
   1 and 3), ``flash_attention_lse`` 240 / 480 launches by sequence
   index, step 1 within 1.109e-4 of phase 19's GPipe and every step 5e-3;
   (d) GPT-2 base moe8 stacked (``MoEScanBlocks``) in one process with
   phase 13's flags, run beside phase 13's runs, against its named-block
   run (launches 120 / 120 / 5), and at ``--pipe 2`` (GPipe, 3 groups a stage; launches 240 / 240 / 5 a
   rank; the update over 180,979,968 elements) against the one process,
   ``moe_aux`` within 1e-6 at step 1. The update is timed at the three
   new element counts (``fused_adamw_ema_gpt2_pipe2_fsdp2``,
   ``_pipe2_zero1``, ``_moe8_pipe2``). Its line is ``{"compositions":
   {...}}``; the flash rows gain ``launches_compose_*``.

Before and after every timed phase a ``# clocks`` line gives the card's SM
and memory clocks, power draw and temperature (``nvidia-smi``). The line
before the last is ``{"kernels": [...]}`` and the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

GPT2_BASE = dict(model_family="gpt2", model_size="base", vocab_size=50257,
                 seq_len=1024, hidden_size=768, num_layers=12, num_heads=12,
                 dtype="bfloat16")
DIFFUSEQ_BASE = dict(model_family="diffuseq", model_size="base",
                     vocab_size=8192, seq_len=128, hidden_size=768,
                     num_layers=12, num_heads=12, diffusion_steps=2000,
                     noise_schedule="sqrt", dtype="bfloat16")


# the card's `nvidia-smi --query-gpu=name,power.limit` line, set by main()
CARD = ""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def clocks(tag: str) -> None:
    """The card's SM and memory clocks, power draw and temperature, on a
    line of their own beside a timed phase."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# clocks {tag}: {out}", flush=True)


def clocked(tag: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` between two ``# clocks`` lines; the second
    also gives the phase's wall time."""
    clocks(f"before {tag}")
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        clocks(f"after {tag} ({time.perf_counter() - t0:.1f} s)")


def time_ms(fn, torch, flush, reps: int = 30) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up,
    each launch with a cold L2 (``flush`` overwrites a buffer larger than
    the cache between launches, outside the timed window)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, torch, flush, reps: int = 20,
              clean_l2: bool = False) -> tuple:
    """Device time of one ``fn()`` call and its split by kernel name: the
    kernels (and memsets) it launches, summed from ``torch.profiler``'s CUDA
    activity over ``reps`` calls, each after an L2 flush whose own kernels
    are left out. The flush writes ``flush`` (``zero_``), which leaves the
    cache full of dirty lines that the call's reads must first evict, or
    with ``clean_l2`` reads it, which leaves the cache cold and clean.
    Unlike ``time_ms`` it does not count the host's enqueue time, which
    exceeds the device time of a call this short."""
    wipe = (lambda: flush.max()) if clean_l2 else flush.zero_
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):   # a reduction's memsets come and go
            wipe()
        torch.cuda.synchronize()
    skip = {e.key for e in prof.key_averages()}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            wipe()
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        if us > 0 and e.key not in skip:
            split[e.key[:80]] = us / reps / 1e3
    return sum(split.values()), split


def decode_case(torch, B, n, pos, seed, shared=True, H=12, Dh=64, ps=16):
    """Seeded q and pools on the card (f32), the same pools as int8 pages
    with per-page scales (absmax / 127, as the serving writers make them),
    a block table of distinct pages (slot 2's first page shared with slot
    1's when ``shared``) and the positions."""
    dev = torch.device("cuda")
    P = 1 + B * n
    g = torch.Generator(device=dev).manual_seed(seed)
    table = 1 + torch.arange(B * n, dtype=torch.int32, device=dev).view(B, n)
    if shared:
        table[2, 0] = table[1, 0]
    c = {"table": table, "ps": ps, "H": H, "Dh": Dh,
         "positions": torch.tensor(pos, dtype=torch.int32, device=dev),
         "q": torch.randn((B, H, Dh), generator=g, device=dev)}
    for name in ("k", "v"):
        pages = torch.randn((P, ps, H, Dh), generator=g, device=dev)
        scale = pages.abs().amax(dim=(1, 2, 3)) / 127.0
        c["p" + name] = pages
        c[name + "8"] = torch.clamp(torch.round(pages / scale[:, None, None,
                                                              None]),
                                    -127, 127).to(torch.int8)
        c["s" + name] = scale
    return c


def decode_args(c, dtype, int8: bool) -> tuple:
    """flash_decode's arguments for a case: q in ``dtype``, and fp pools in
    ``dtype`` or the int8 pools with their scales."""
    q = c["q"].to(dtype)
    if int8:
        return (q, c["k8"], c["v8"], c["table"], c["positions"], c["sk"],
                c["sv"])
    return (q, c["pk"].to(dtype), c["pv"].to(dtype), c["table"],
            c["positions"])


def decode_check(torch, fd, c, dtype, int8: bool) -> float:
    """One kernel call against the plain version evaluated in f32 from the
    same inputs (int8: the same int8 pages and scales); dead slots must be
    zero. f32 within 1e-4 rel / 1e-5 abs (another summation order); bf16
    within 8e-3 rel and abs (the kernel rounds its f32 result to bf16
    once). Returns the max abs error."""
    args = decode_args(c, dtype, int8)
    got = fd.flash_decode(*args)
    torch.cuda.synchronize()
    f32 = [a.float() if a.dtype in (torch.float32, torch.bfloat16) else a
           for a in args]
    ref = fd.torch_paged_decode(*f32)
    tol = (1e-4, 1e-5) if dtype == torch.float32 else (8e-3, 8e-3)
    err = (got.float() - ref).abs()
    check(bool(torch.all(err <= tol[1] + tol[0] * ref.abs())),
          f"flash_decode {dtype} {'int8' if int8 else 'fp'} pools disagree "
          f"with the plain version: max abs err {float(err.max())}")
    dead = (c["positions"] < 0).nonzero().flatten().tolist()
    check(all(bool(torch.all(got[b] == 0)) for b in dead),
          "a dead slot is not zero")
    return float(err.max())


def kernel_phase(torch, fd, bw, bf16_peak) -> list:
    """flash_decode vs torch_paged_decode over fp and int8 pools at the
    serving shapes, a long split slot and chunk-edge positions; two calls
    bitwise equal; both branches timed beside their bounds and the library
    in one call."""
    from distributed_pipeline_tpu_torch.serving.paged_kv import (
        dequant_gathered, gather_kv)

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    B, n = 32, 64
    # dead slot, one live key, exact page ends and starts, interior, full
    # reservation, then the serve phase's depths (256 prompt + decode)
    main = decode_case(torch, B, n, [-1, 0, 15, 16, 31, 255, 256, 1023]
                       + [256 + 5 * i for i in range(B - 8)], seed=0)
    # one slot at the end of its reservation: one page a chunk, 64 chunks
    long_slot = decode_case(torch, 1, n, [1023], seed=1, shared=False)
    # both sides of every 4-page chunk edge of the serving plan
    edges = decode_case(torch, B, n, [min(64 * k + d, 1023)
                                      for k in range(1, 17)
                                      for d in (-1, 0)], seed=2)
    plans = {name: fd.decode_plan(len(c["positions"]), 12, 64, 16, n, kb,
                                  *fd.device_limits(dev))._asdict()
             for name, c, kb in (("main_bf16", main, 2), ("main_int8", main, 1),
                                 ("long_slot", long_slot, 2))}
    print(f"# decode plans: {json.dumps(plans)}", flush=True)
    errs = {}
    for int8 in (False, True):
        kind = "int8" if int8 else "fp"
        for dtype in (f32, bf16):
            errs[f"{kind}_{str(dtype)[6:]}"] = decode_check(torch, fd, main,
                                                            dtype, int8)
        errs[f"{kind}_long_slot"] = decode_check(torch, fd, long_slot, bf16,
                                                 int8)
        errs[f"{kind}_chunk_edges"] = decode_check(torch, fd, edges, bf16,
                                                   int8)
        args = decode_args(main, bf16, int8)
        a, b = fd.flash_decode(*args), fd.flash_decode(*args)
        check(torch.equal(a, b), f"two {kind} calls on the same inputs "
              f"differ by {float((a.float() - b.float()).abs().max())}")
    print(f"# decode check: max abs err {json.dumps(errs)}; two calls "
          f"bitwise equal (fp and int8 pools)", flush=True)

    # times at the main path's dtype (bf16 q), both pool types
    table, positions = main["table"], main["positions"]
    ps = main["ps"]
    fp_args, q8_args = decode_args(main, bf16, False), decode_args(main, bf16,
                                                                   True)
    q = fp_args[0][:, :, None]
    live = (torch.arange(n * ps, device=dev)[None, :]
            <= positions[:, None])[:, None, None, :]
    # the library's inputs are gathered (and dequantized) beforehand: only
    # the attention itself is timed
    ks, vs = gather_kv(fp_args[1], table), gather_kv(fp_args[2], table)
    ks8 = dequant_gathered(gather_kv(main["k8"], table), main["sk"], table,
                           ps, bf16)
    vs8 = dequant_gathered(gather_kv(main["v8"], table), main["sv"], table,
                           ps, bf16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {"fp": lambda: fd.flash_decode(*fp_args),
           "fp_lib": lambda: sdpa(q, ks, vs, attn_mask=live),
           "int8": lambda: fd.flash_decode(*q8_args),
           "int8_lib": lambda: sdpa(q, ks8, vs8, attn_mask=live)}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    # device ms, one per turn: after a clean flush of L2 (the bound's
    # assumption: every input comes from device memory, nothing is written
    # back), and after a dirty one (a write of the flush buffer)
    runs = {name: [] for name in fns}
    dirty = {name: [] for name in fns}
    event = {name: [] for name in fns}      # CUDA-event ms, host included
    split = {}
    for order in (("fp", "fp_lib", "int8", "int8_lib"),
                  ("fp_lib", "fp", "int8_lib", "int8")):
        for name in order:
            total, split[name] = device_ms(fns[name], torch, flush,
                                           clean_l2=True)
            runs[name].append(total)
            dirty[name].append(device_ms(fns[name], torch, flush)[0])
            event[name].append(time_ms(fns[name], torch, flush))
    ms = {name: statistics.median(t) for name, t in runs.items()}
    plain = {"fp": time_ms(lambda: fd.torch_paged_decode(*fp_args), torch,
                           flush),
             "int8": time_ms(lambda: fd.torch_paged_decode(*q8_args), torch,
                             flush)}
    rows = []
    for kind in ("fp", "int8"):
        int8 = kind == "int8"
        row = {
            "name": "flash_decode_int8" if int8 else "flash_decode",
            "route": "cuda",
            "source": "distributed_pipeline_tpu_torch/ops/csrc/"
                      "flash_decode.cu",
            "replaces": "distributed_pipeline_tpu/ops/flash_decode.py:155",
            "launches": None,
            "max_abs_err": errs[f"{kind}_bfloat16"],
            "max_abs_err_f32": errs[f"{kind}_float32"],
            "max_abs_err_long_slot": errs[f"{kind}_long_slot"],
            "max_abs_err_chunk_edges": errs[f"{kind}_chunk_edges"],
            "ms": ms[kind], "ms_runs": runs[kind],
            "ms_dirty_l2": statistics.median(dirty[kind]),
            "event_ms": event[kind], "kernels_ms": split[kind],
            "plain_ms": plain[kind],
            **kernel_bound(fd, table, positions, ps, 12, 64, bw, bf16_peak,
                           quantized=int8),
            "library_ms": ms[kind + "_lib"],
            "library_ms_runs": runs[kind + "_lib"],
            "library_ms_dirty_l2": statistics.median(dirty[kind + "_lib"]),
            "library_event_ms": event[kind + "_lib"],
            "library_kernels_ms": split[kind + "_lib"],
            "library_call": "scaled_dot_product_attention over pre-gathered "
                            + ("and dequantized bf16 K/V (gather and "
                               "dequant excluded)" if int8 else
                               "K/V (the gather excluded)"),
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["x_library"] = row["ms"] / row["library_ms"]
        print(f"# decode timing: {row['name']} {row['ms']:.6f} ms "
              f"({row['share_of_bound']:.3f} of the bound "
              f"{row['bound_ms']:.6f} ms, {row['x_library']:.3f}x the "
              f"library's {row['library_ms']:.6f} ms; device time, clean "
              f"cold L2; after a dirty flush {row['ms_dirty_l2']:.6f} vs "
              f"{row['library_ms_dirty_l2']:.6f} ms; CUDA events, host "
              f"enqueue included: {row['event_ms']} vs "
              f"{row['library_event_ms']}; plain {row['plain_ms']:.5f} ms)",
              flush=True)
        rows.append(row)
    return rows


def kernel_bound(fd, table, positions, ps, H, Dh, bw, bf16_peak,
                 quantized: bool = False) -> dict:
    """The least time the card could take for one flash_decode call with
    bf16 q on these inputs: the larger of the kernel's own bytes
    (``decode_hbm_bytes(step_table=False)``: distinct live K/V pages, 2
    bytes an element or 1 for int8 pools, q, out, live table entries,
    positions, and for int8 the two scales of each live entry) over the
    memory rate and its flops (q.k and p.v over the live keys) over the
    bf16 peak."""
    bt, pos = table.cpu().numpy(), positions.cpu().numpy()
    hbm_bytes = fd.decode_hbm_bytes(bt, pos, ps, H, Dh, dtype_bytes=2,
                                    quantized=quantized, step_table=False)
    live_keys = sum(min(int(p) + 1, bt.shape[1] * ps) for p in pos if p >= 0)
    flops = 4 * live_keys * H * Dh                 # q.k and p.v, 2 each
    bytes_ms, ops_ms = hbm_bytes / bw * 1e3, flops / bf16_peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "hbm_bytes": hbm_bytes}


def span_bound(fd, table, positions, ps, H, Dh, bw, bf16_peak,
               quantized: bool = False) -> dict:
    """The least time the card could take for one span call with bf16 q
    (``positions`` [B, L]): the larger of the span kernel's own bytes
    (``span_hbm_bytes``: distinct live K/V pages once, 2 bytes an element
    or 1 for int8 pools, q and out per link, each slot's live table
    entries once, a position a link, and for int8 the two scales of each
    live entry) over the memory rate and its flops (q.k and p.v over each
    link's live keys) over the bf16 peak."""
    bt, pos = table.cpu().numpy(), positions.cpu().numpy()
    live_keys = sum(min(int(p) + 1, bt.shape[1] * ps)
                    for p in pos.reshape(-1) if p >= 0)
    return bound(fd.span_hbm_bytes(bt, pos, ps, H, Dh, dtype_bytes=2,
                                   quantized=quantized),
                 4 * live_keys * H * Dh, bw, bf16_peak)  # q.k and p.v


def span_phase(torch, fd, bw, bf16_peak) -> list:
    """The span seam's kernel arm (``paged_span_attention``) against its
    plain twin ``torch_paged_span_decode`` at the serve shapes (32 slots,
    H=12, Dh=64, page 16, 64-page reservations, K=4), over bf16 and int8
    pools: bf16 q on the span kernel (``flash_span``: one launch on its
    counter, none on the decode kernel's), f32 q on the decode kernel over
    B*(K+1) pseudo-slots (the strict bar), with the decode check's bars;
    two bf16 calls bitwise equal. Timed in turns (clean cold L2): the span
    kernel beside its bound (``span_hbm_bytes``), the pseudo-slot route
    on the same bf16 inputs, and one ``scaled_dot_product_attention`` over
    pre-gathered K/V with a [K+1, Lmax] mask."""
    from distributed_pipeline_tpu_torch.serving.paged_kv import (
        dequant_gathered, gather_kv)

    dev = torch.device("cuda")
    B, n, K, H, Dh, ps = 32, 64, 4, 12, 64, 16
    L = K + 1
    # the serve phase's depths, a slot at position 0, one straddling a
    # page edge, and two at the end of the reservation (clamped links)
    idx = [0, 12, 1019, 1022] + [256 + 5 * i for i in range(B - 4)]
    c = decode_case(torch, B, n, idx, seed=4)
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((B, H, L, Dh), generator=g, device=dev)
    pos = torch.clamp(c["positions"][:, None] + torch.arange(
        L, dtype=torch.int32, device=dev)[None, :], max=n * ps - 1)
    table = c["table"]
    pools = {"fp": lambda dt: (c["pk"].to(dt), c["pv"].to(dt)),
             "int8": lambda dt: (c["k8"], c["v8"], c["sk"], c["sv"])}

    def span(kind, dt, impl="cuda", upcast=False):
        # upcast: the same ``dt`` inputs, evaluated in f32
        pk, pv, *sc = pools[kind](dt)
        qd = q.to(dt)
        if upcast:
            qd = qd.float()
            pk, pv = (t.float() if t.is_floating_point() else t
                      for t in (pk, pv))
        return fd.paged_span_attention(qd, pk, pv, table, pos,
                                       impl=impl, scales_k=(sc or [None])[0],
                                       scales_v=(sc or [None, None])[1])

    errs = {}
    for kind in ("fp", "int8"):
        for dt in (torch.float32, torch.bfloat16):
            fd.reset_launch_count()
            got = span(kind, dt)
            torch.cuda.synchronize()
            # bf16 on the span kernel, f32 on the decode kernel
            routed = ((fd.span_kernel_launch_count(kind), fd.launch_count())
                      if dt == torch.bfloat16 else
                      (fd.launch_count(kind), fd.span_kernel_launch_count()))
            check(routed == (1, 0), f"span {kind} {dt}: launches (route, "
                  f"other kernel) {routed}, expected (1, 0)")
            ref = span(kind, dt, impl="torch", upcast=True)
            tol = (1e-4, 1e-5) if dt == torch.float32 else (8e-3, 8e-3)
            err = (got.float() - ref).abs()
            check(bool(torch.all(err <= tol[1] + tol[0] * ref.abs())),
                  f"span kernel {kind} {dt} disagrees with the plain twin: "
                  f"max abs err {float(err.max())}")
            errs[f"{kind}_{str(dt)[6:]}"] = float(err.max())
        a, b = span(kind, torch.bfloat16), span(kind, torch.bfloat16)
        check(torch.equal(a, b), f"two {kind} span calls differ")
    print(f"# span check: max abs err {json.dumps(errs)} (bf16: the span "
          f"kernel, f32: the decode kernel over pseudo-slots); two bf16 "
          f"calls bitwise equal (fp and int8 pools)", flush=True)
    plans = {kind: fd.span_plan(B, L, H, Dh, ps, n, kb,
                                *fd.device_limits(dev))._asdict()
             for kind, kb in (("fp", 2), ("int8", 1))}
    print(f"# span plans: {json.dumps(plans)}", flush=True)

    bf16 = torch.bfloat16
    live = (torch.arange(n * ps, device=dev)[None, None, :]
            <= pos[:, :, None])[:, None]                 # [B, 1, L, Lmax]
    ks, vs = gather_kv(c["pk"].to(bf16), table), gather_kv(c["pv"].to(bf16),
                                                           table)
    ks8 = dequant_gathered(gather_kv(c["k8"], table), c["sk"], table, ps,
                           bf16)
    vs8 = dequant_gathered(gather_kv(c["v8"], table), c["sv"], table, ps,
                           bf16)
    qb = q.to(bf16)
    args = {"fp": (qb, *pools["fp"](bf16), table, pos),
            "int8": (qb, c["k8"], c["v8"], table, pos)}
    scales = {"fp": {}, "int8": {"scales_k": c["sk"], "scales_v": c["sv"]}}

    def seam(kind, impl="cuda"):
        return fd.paged_span_attention(*args[kind], impl=impl,
                                       **scales[kind])

    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {"fp": lambda: seam("fp"),
           "fp_pseudo": lambda: fd.pseudo_slot_span(*args["fp"]),
           "fp_lib": lambda: sdpa(qb, ks, vs, attn_mask=live),
           "int8": lambda: seam("int8"),
           "int8_pseudo": lambda: fd.pseudo_slot_span(*args["int8"],
                                                      **scales["int8"]),
           "int8_lib": lambda: sdpa(qb, ks8, vs8, attn_mask=live)}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    runs = {name: [] for name in fns}
    split = {}
    for order in (("fp", "fp_pseudo", "fp_lib", "int8", "int8_pseudo",
                   "int8_lib"),
                  ("fp_lib", "fp_pseudo", "fp", "int8_lib", "int8_pseudo",
                   "int8")):
        for name in order:
            total, split[name] = device_ms(fns[name], torch, flush,
                                           clean_l2=True)
            runs[name].append(total)
    ms = {name: statistics.median(t) for name, t in runs.items()}
    rows = []
    for kind in ("fp", "int8"):
        plain = time_ms(lambda: seam(kind, impl="torch"), torch, flush,
                        reps=10)
        kernel = [v for k, v in split[kind].items() if "flash_span" in k]
        row = {"name": "flash_decode_span" + ("_int8" if kind == "int8"
                                              else ""),
               "route": "cuda",
               "source": "distributed_pipeline_tpu_torch/ops/csrc/"
                         "flash_span.cu",
               "replaces": "distributed_pipeline_tpu/ops/flash_decode.py:328",
               "call_site": "ops/flash_decode.py paged_span_attention, "
                            f"{B} slots x {L} links",
               "launches": None, "max_abs_err": errs[f"{kind}_bfloat16"],
               "max_abs_err_f32_pseudo_slot": errs[f"{kind}_float32"],
               "ms": ms[kind], "ms_runs": runs[kind],
               "kernels_ms": split[kind], "span_kernel_ms": sum(kernel),
               "pseudo_slot_ms": ms[kind + "_pseudo"],
               "pseudo_slot_ms_runs": runs[kind + "_pseudo"],
               "pseudo_slot_kernels_ms": split[kind + "_pseudo"],
               "plain_ms": plain,
               **span_bound(fd, table, pos, ps, H, Dh, bw, bf16_peak,
                            quantized=kind == "int8"),
               "library_ms": ms[kind + "_lib"],
               "library_ms_runs": runs[kind + "_lib"],
               "library_call": "scaled_dot_product_attention over "
                               "pre-gathered " + ("and dequantized " if
                                                  kind == "int8" else "")
                               + "K/V with a [K+1, Lmax] mask"}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["x_library"] = row["ms"] / row["library_ms"]
        row["x_pseudo_slot"] = row["ms"] / row["pseudo_slot_ms"]
        print(f"# span timing: {row['name']} {row['ms']:.6f} ms, of it "
              f"the span kernel {row['span_kernel_ms']:.6f} ms "
              f"({row['share_of_bound']:.3f} of the bound "
              f"{row['bound_ms']:.6f} ms, {row['x_library']:.3f}x the "
              f"library's {row['library_ms']:.6f} ms, "
              f"{row['x_pseudo_slot']:.3f}x the pseudo-slot route's "
              f"{row['pseudo_slot_ms']:.6f} ms; device time, clean cold "
              f"L2; plain {plain:.5f} ms)", flush=True)
        rows.append(row)
    return rows


def spec_run(torch, fd, run, draft: str, kv_quant: str, requests: int,
             base: dict) -> dict:
    """``run.serve --spec_tokens 4`` at GPT-2 base width: every request's
    tokens, the span launches (12 a verify round, over the run's page
    type only), and, against the non-spec run of the same pool (``base``:
    its summary and streams), tokens/s, the share of identical streams
    and the top-2 logit gap at each first divergence (bf16: the two paths
    run different GEMM shapes and split-K plans)."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.run.serve import serve

    K, new_tokens, layers = 4, 128, GPT2_BASE["num_layers"]
    settings_argv = serve_argv(run, kv_quant, requests) + [
        "--spec_tokens", str(K), "--spec_draft", draft,
        "--draft_layers", "2"]
    settings = parse_settings(settings_argv)
    fd.reset_launch_count()
    summary, server, reqs = serve(settings)
    counters = fd.launch_counters()
    check(len(reqs) == requests, f"{len(reqs)} requests served")
    for r in reqs:
        check(len(r.tokens) == new_tokens
              and all(0 <= t < GPT2_BASE["vocab_size"] for t in r.tokens),
              f"spec request {r.id} returned {len(r.tokens)} tokens")
    rounds = server.spec_rounds
    span = fd.span_launch_count()
    span_kernel = fd.span_kernel_launch_count(kv_quant)
    draft_launches = 2 * K * rounds if draft == "model" else 0
    other = "fp" if kv_quant == "int8" else "int8"
    # every verify (bf16 q) runs on the span kernel, over the run's page
    # type; the decode kernel runs only the model draft's steps
    check(span == span_kernel == summary["span_kernel_launches"]
          == layers * rounds
          and fd.launch_count(kv_quant) == draft_launches
          and fd.launch_count(other) == 0
          and fd.span_kernel_launch_count(other) == 0,
          f"spec {draft}/{kv_quant}: span launches {span} ({span_kernel} "
          f"on the span kernel) over {rounds} rounds, "
          f"{fd.launch_count(kv_quant)} decode kernel launches")
    # against the non-spec run's streams of the same requests
    same, gaps = divergence_gaps(torch, server.engine.model, reqs,
                                 base["streams"][:requests])
    out = {"draft": draft, "kv_quant": kv_quant, "requests": requests,
           "spec_rounds": rounds, "span_launches": span,
           "span_kernel_launches": span_kernel,
           "draft_decode_launches": draft_launches,
           "accept_rate": summary["accept_rate"],
           "decode_tokens_per_s_per_chip":
               summary["decode_tokens_per_s_per_chip"],
           "nonspec_tokens_per_s_per_chip":
               base["decode_tokens_per_s_per_chip"],
           "nonspec_requests": len(base["streams"]),
           "identical_streams": same / requests,
           "first_divergence_gaps": gaps, "wall_s": summary["wall_s"]}
    print(f"# spec serve: {json.dumps(out)}", flush=True)
    check_near_ties(gaps, f"spec {draft}/{kv_quant}")
    out.update(argv=settings_argv, streams=[list(r.tokens) for r in reqs],
               counters=counters, summary=summary)
    del server
    torch.cuda.empty_cache()
    return out


def divergence_gaps(torch, model, reqs, refs) -> tuple:
    """(identical streams, one record a diverging stream): the position of
    its first divergence from ``refs`` and the top-2 gap of ``model``'s
    next-token logits there, from a dense forward over the prompt and the
    common prefix."""
    same, gaps = 0, []
    for r, ref in zip(reqs, refs):
        if r.tokens == ref:
            same += 1
            continue
        i = next(i for i, (a, b) in enumerate(zip(r.tokens, ref)) if a != b)
        ids = torch.tensor(list(r.prompt) + ref[:i], device="cuda")
        with torch.inference_mode():
            # no-drop routing, as the servers and decoders route
            logits = model(ids[None], moe_no_drop=True)[0, -1].float()
        top = logits.topk(2).values
        gaps.append({"request": r.id, "position": i,
                     "gap": float(top[0] - top[1]),
                     "max_abs_logit": float(logits.abs().max())})
    return same, gaps


def check_near_ties(gaps, what: str) -> None:
    """Streams may part only at a near-tie: the top-2 gap at a first
    divergence is at most 2% of that position's largest |logit| (the bar
    stated before the first run)."""
    bad = [d for d in gaps if d["gap"] > 0.02 * d["max_abs_logit"]]
    check(not bad, f"{what}: streams diverge from the non-spec run where "
          f"the top-2 gap is not a near-tie: {bad}")


def spec_identity_f32(torch, fd, run) -> dict:
    """At f32 compute, 32 requests of 256 prompt tokens and 64 new ones:
    over an fp (f32) pool with the ngram draft the greedy spec streams
    equal the non-spec streams token for token. Over an int8 pool (the
    model draft) they need not: a verify writes all K+1 links' rows
    before it attends, and rescale-on-grow then quantizes a page under
    the largest row of the whole span (rejected links included), where
    the non-spec path saw the rows one at a time; so the pool's int8
    values differ between the paths (the JAX writers behave the same).
    There the share of identical streams is printed and every first
    divergence must be a near-tie (``check_near_ties``)."""
    import numpy as np
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.run.sample import load_run
    from distributed_pipeline_tpu_torch.serving.scheduler import \
        DecodeServer

    bf, _, _ = load_run(run, device=torch.device("cuda"))
    m32 = create_model_from_config(**{**GPT2_BASE, "dtype": "float32"},
                                   device="cuda")
    m32.load_state_dict(bf.state_dict())
    del bf
    rng = np.random.default_rng(11)
    prompts = [rng.integers(4, GPT2_BASE["vocab_size"], (256,))
               .astype(np.int32) for _ in range(32)]
    out = {}
    for kv_quant, draft in (("fp", "ngram"), ("int8", "model")):
        streams = {}
        for spec in (0, 4):
            srv = DecodeServer(m32, decode_slots=32, page_size=16,
                               max_prompt_len=512, kv_quant=kv_quant,
                               spec_tokens=spec, spec_draft=draft,
                               draft_layers=2, device="cuda")
            fd.reset_launch_count()
            reqs = [srv.submit(p, max_new_tokens=64) for p in prompts]
            srv.drain()
            streams[spec] = reqs
            if spec:
                # f32 verifies take the decode kernel over pseudo-slots
                check(fd.span_launch_count() == 12 * srv.spec_rounds > 0
                      and fd.span_kernel_launch_count() == 0,
                      f"f32 spec run: {fd.span_launch_count()} span "
                      f"launches over {srv.spec_rounds} rounds, "
                      f"{fd.span_kernel_launch_count()} of them on the "
                      f"span kernel")
                out[f"{kv_quant}_{draft}_accept_rate"] = srv.accept_rate
            del srv
        same, gaps = divergence_gaps(torch, m32, streams[4],
                                     [r.tokens for r in streams[0]])
        out[f"{kv_quant}_{draft}_identical"] = same / len(prompts)
        out[f"{kv_quant}_{draft}_first_divergence_gaps"] = gaps
        if kv_quant == "fp":
            check(same == len(prompts), f"f32 fp pool, {draft} draft: "
                  f"{len(prompts) - same} spec streams differ from "
                  f"non-spec: {gaps}")
        check_near_ties(gaps, f"f32 {kv_quant} pool, {draft} draft")
    print(f"# spec identity at f32 compute: {json.dumps(out)}", flush=True)
    del m32
    torch.cuda.empty_cache()
    return out


def small_model_phase(torch) -> None:
    """Greedy tokens of a small f32 GPT-2 on the GPU (kernel) equal those
    on the CPU (plain version)."""
    from distributed_pipeline_tpu_torch.convert import init_params
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.ops import flash_decode as fd
    from distributed_pipeline_tpu_torch.serving.scheduler import DecodeServer

    cfg = dict(vocab_size=256, seq_len=64, hidden_size=128, num_layers=2,
               num_heads=2)
    sd = init_params(cfg, seed=3)
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(4, 256, (int(k),), generator=rng).numpy()
               for k in (3, 17, 9, 30, 1, 12)]
    outs = {}
    for device in ("cuda", "cpu"):
        model = create_model_from_config(model_family="gpt2", dtype="float32",
                                         device=device, **cfg)
        model.load_state_dict(sd)
        srv = DecodeServer(model, decode_slots=2, page_size=16,
                           max_prompt_len=32, decode_span=3, device=device)
        before = fd.launch_count()
        reqs = [srv.submit(p, max_new_tokens=10 + i)
                for i, p in enumerate(prompts)]
        srv.drain()
        outs[device] = [r.tokens for r in reqs]
        if device == "cuda":
            check(fd.launch_count() > before, "small model never launched "
                  "the kernel")
    check(outs["cuda"] == outs["cpu"],
          "small-model greedy tokens differ between GPU kernel and CPU")
    print("# small-model check: GPU (kernel) tokens == CPU (plain) tokens",
          flush=True)


def serve_phase(torch, fd, bw, bf16_peak) -> tuple:
    """GPT-2 base at full width through run.serve, once over an fp (bf16)
    KV pool and once with ``--kv_quant int8``; the int8 pool must hold at
    most 0.55x the fp pool's bytes. Then the speculative runs on the same
    weights (``spec_run``, ``spec_identity_f32``), and the serving options
    (``options_phase``). Returns the non-spec, the spec and the options'
    results."""
    from distributed_pipeline_tpu_torch.convert import init_params
    from distributed_pipeline_tpu_torch.utils.checkpoint import save_run

    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "gpt2_base")
        t0 = time.perf_counter()
        save_run(run, GPT2_BASE, init_params(GPT2_BASE, seed=0), step=1)
        print(f"# serve: wrote seeded GPT-2 base weights in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        runs = {kv: clocked(f"serve {kv}", serve_run, torch, fd, run, kv,
                            bw, bf16_peak) for kv in ("fp", "int8")}
        spec = {"ngram_fp": clocked("spec serve ngram fp", spec_run, torch,
                                    fd, run, "ngram", "fp", 64, runs["fp"]),
                "model_int8": clocked("spec serve model int8", spec_run,
                                      torch, fd, run, "model", "int8", 16,
                                      runs["int8"]),
                "identity_f32": spec_identity_f32(torch, fd, run)}
        options = options_phase(torch, fd, run, runs, spec)
    for r in (*runs.values(), spec["ngram_fp"], spec["model_int8"]):
        for key in ("streams", "counters", "summary", "argv"):
            del r[key]
    ratio = runs["int8"]["kv_pool_bytes"] / runs["fp"]["kv_pool_bytes"]
    print(f"# serve: int8 KV pool {runs['int8']['kv_pool_bytes']} bytes, "
          f"{ratio:.4f} of the fp pool's {runs['fp']['kv_pool_bytes']}",
          flush=True)
    check(ratio <= 0.55, f"the int8 KV pool is {ratio:.4f} of the fp pool "
          f"(at most 0.55)")
    return runs, spec, options


def options_phase(torch, fd, run, runs, spec) -> dict:
    """The serving options at GPT-2 base width (phase 7c): graph against
    eager over the bf16 and int8 pools and with ``--spec_tokens 4``, the
    sanitizer, the prefix cache under wall-clock traffic, and
    ``--serve_quant int8`` with the cost ledger."""
    out = {"card": CARD}
    # no profiled pass (a depth cut for the script's wall: each cost
    # about 20 s in set-up and trace processing;
    # scripts/profile_torch_serve.py measures the engines' idle shares)
    for key, base in (("fp", runs["fp"]), ("int8", runs["int8"]),
                      ("spec_ngram_fp", spec["ngram_fp"])):
        out[f"graph_vs_eager_{key}"] = clocked(
            f"graph vs eager {key}", graph_vs_eager, torch, fd, key, base)
    out["sanitize"] = clocked("sanitize", sanitize_run, torch, fd, run)
    out["prefill_rows_bitwise"] = prefill_rows_bitwise(torch, run)
    out["prefix_cache"] = clocked("prefix cache", prefix_run, torch, fd, run)
    out["serve_quant"] = clocked("serve_quant", quant_ledger_run, torch,
                                 fd, run, runs["fp"]["streams"])
    return out


def graph_vs_eager(torch, fd, key: str, base: dict) -> dict:
    """The run of ``base`` (graph engine: its argv, streams, launch
    counters and summary) served again through the eager engine: streams
    identical token for token, every launch counter equal."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.run.serve import serve
    fd.reset_launch_count()
    summary, server, reqs = serve(parse_settings(base["argv"]),
                                  cuda_graphs=False)
    counters = fd.launch_counters()
    check(server.engine.executables() == {} and server.compile_time_s == 0,
          f"{key}: the eager engine captured graphs")
    del server
    torch.cuda.empty_cache()
    streams = [list(r.tokens) for r in reqs]
    differ = sum(a != b for a, b in zip(streams, base["streams"]))
    check(len(streams) == len(base["streams"]) and differ == 0,
          f"{key}: {differ} of {len(streams)} graph-engine streams differ "
          f"from the eager engine's")
    check(counters == base["counters"] and sum(counters.values()) > 0,
          f"{key}: launches through graph replays {base['counters']} vs "
          f"eager {counters}")
    g, e = base["summary"], summary
    out = {"streams": len(streams), "identical": True,
           "launches": counters,
           "graph": {k: g[k] for k in ("decode_tokens_per_s_per_chip",
                                       "ttft_p50_s", "ttft_p95_s", "wall_s",
                                       "compile_time_s")},
           "eager": {k: e[k] for k in ("decode_tokens_per_s_per_chip",
                                       "ttft_p50_s", "ttft_p95_s", "wall_s",
                                       "compile_time_s")}}
    out["speedup"] = (g["decode_tokens_per_s_per_chip"]
                      / e["decode_tokens_per_s_per_chip"])
    print(f"# graph vs eager {key} ({CARD}): {json.dumps(out)}", flush=True)
    return out


def sanitize_run(torch, fd, run) -> dict:
    """``run.serve --sanitize true`` on the bf16 workload: no capture after
    the first fetched token, one per phase, an empty report; then a host
    sync injected into a dispatch (the engine's test hook) raises and is
    recorded as a ``transfer_guard`` violation."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.run.serve import serve
    summary, server, reqs = serve(parse_settings(
        serve_argv(run, "fp") + ["--sanitize", "true"]))
    eng = server.engine
    with open(os.path.join(run, "sanitize_report.json")) as f:
        report = json.load(f)
    check(summary["recompile_count"] == 0
          and summary["xla_compiles_total"] == 2
          and eng.captures == {"prefill": 1, "decode": 1}
          and set(eng.executables()) == {"prefill", "decode"},
          f"sanitize: recompile_count {summary['recompile_count']}, "
          f"captures {eng.captures} ({summary['xla_compiles_total']})")
    check(report == {"version": 1, "violations": []},
          f"sanitize: the report lists violations: {report}")
    check(all(len(r.tokens) == 128 for r in reqs),
          "sanitize: a request lacks tokens")
    eng._dispatch_hook = lambda phase: eng.tokens.cpu()
    server.submit(reqs[0].prompt, max_new_tokens=4)
    tripped = ""
    try:
        server.step()
    except RuntimeError as err:
        tripped = str(err)
    kinds = [v["kind"] for v in server.sanitize_report.violations]
    check("synchronizing" in tripped and kinds == ["transfer_guard"]
          and torch.cuda.get_sync_debug_mode() == 0,
          f"sanitize: an injected sync gave {tripped!r}, violations "
          f"{kinds}")
    out = {"recompile_count": summary["recompile_count"],
           "captures": eng.captures,
           "compile_time_s": summary["compile_time_s"],
           "decode_tokens_per_s_per_chip":
               summary["decode_tokens_per_s_per_chip"],
           "injected_sync": server.sanitize_report.violations[0]}
    print(f"# sanitize ({CARD}): {json.dumps(out)}", flush=True)
    del server, eng
    torch.cuda.empty_cache()
    return out


def prefill_rows_bitwise(torch, run) -> dict:
    """Is a prompt's K/V bitwise the same when its prefill runs at another
    row of a batch among other prompts? (bf16 GEMMs need not give
    bitwise-equal rows across batches; the prefix cache never rewrites an
    acquired page, so it does not depend on the answer.)"""
    import numpy as np
    from distributed_pipeline_tpu_torch.run.sample import load_run
    from distributed_pipeline_tpu_torch.serving.engine import DecodeEngine
    model, _, _ = load_run(run, device=torch.device("cuda"))
    rng = np.random.default_rng(4)
    prompt = rng.integers(4, GPT2_BASE["vocab_size"], (384,))
    pools = []
    for row in (0, 5):
        eng = DecodeEngine(model, decode_slots=8, page_size=16,
                           max_pages=1 + 8 * 32, max_prompt_len=512,
                           max_len=512, prefill_batch=8, cuda_graphs=False)
        ids = rng.integers(4, GPT2_BASE["vocab_size"], (8, 512))
        ids[row, :384] = prompt
        ids[row, 384:] = 0
        lens = rng.integers(200, 512, (8,))
        lens[row] = 384
        tables = np.arange(1, 1 + 8 * 32).reshape(8, 32)
        eng.prefill(ids, lens, np.arange(8), tables)
        pools.append([(e[0][tables[row, :16]].clone(),
                       e[1][tables[row, :16]].clone())
                      for e in eng.kv_cache])
        del eng
    same = all(torch.equal(a, b) for x, y in zip(*pools)
               for a, b in zip(x, y))
    diff = max(float((a.float() - b.float()).abs().max())
               for x, y in zip(*pools) for a, b in zip(x, y))
    out = {"bitwise_equal": same, "max_abs_diff": diff}
    print(f"# prefill K/V of one prompt at batch rows 0 and 5, 16 full "
          f"pages, 12 layers: {json.dumps(out)}", flush=True)
    del model, pools
    torch.cuda.empty_cache()
    return out


def prefix_run(torch, fd, run) -> dict:
    """``--prefix_cache true --shared_prefix_len 256
    --synthetic_prompt_len 384 --traffic poisson`` against the same
    requests without the cache: streams equal, hits > 0, the pool whole
    after the drain (free + cache-resident pages = capacity)."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.run.serve import serve
    rate = 16.0
    argv = ["--checkpoint_path", run, "--decode_slots", "32",
            "--page_size", "16", "--max_prompt_len", "512",
            "--synthetic_requests", "32", "--synthetic_prompt_len", "384",
            "--shared_prefix_len", "256", "--max_new_tokens", "128",
            "--temperature", "0", "--traffic", "poisson",
            "--rate_rps", str(rate)]
    print(f"# prefix cache: poisson arrivals at {rate} requests/s",
          flush=True)
    results = {}
    for cache in (True, False):
        summary, server, reqs = serve(parse_settings(
            argv + ["--prefix_cache", str(cache).lower()]))
        results[cache] = (summary, [list(r.tokens) for r in reqs])
        if cache:
            whole = (server.mgr.free_pages + summary["prefix_resident_pages"]
                     == server.mgr.capacity)
        del server
        torch.cuda.empty_cache()
    (hot, hot_streams), (cold, cold_streams) = results[True], results[False]
    same = sum(a == b for a, b in zip(hot_streams, cold_streams))
    out = {"rate_rps": rate, "requests": len(hot_streams),
           "identical_streams": same / len(hot_streams),
           **{k: v for k, v in hot.items() if k.startswith("prefix_")},
           "pool_whole": whole,
           "cached": {k: hot[k] for k in ("decode_tokens_per_s_per_chip",
                                          "ttft_p50_s", "ttft_p95_s",
                                          "wall_s")},
           "uncached": {k: cold[k] for k in (
               "decode_tokens_per_s_per_chip", "ttft_p50_s", "ttft_p95_s",
               "wall_s")}}
    print(f"# prefix cache ({CARD}): {json.dumps(out)}", flush=True)
    check(same == len(hot_streams), f"prefix cache: {len(hot_streams) - same}"
          f" streams differ from the run without the cache")
    check(hot["prefix_hits"] > 0 and whole,
          f"prefix cache: hits {hot['prefix_hits']}, pool whole {whole}")
    return out


def quant_ledger_run(torch, fd, run, fp_streams) -> dict:
    """``--serve_quant int8 --cost_ledger true`` on the bf16 workload:
    every request's tokens, tokens/s, the share of streams equal to the
    unquantized run's; the ledger's decode and prefill rows, the gap-sum
    identity within 1e-9 and ``mfu`` in (0, 1)."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.obs.ledger import gap_sum_identity
    from distributed_pipeline_tpu_torch.run.serve import serve
    summary, server, reqs = serve(parse_settings(
        serve_argv(run, "fp") + ["--serve_quant", "int8",
                                 "--cost_ledger", "true"]))
    del server
    torch.cuda.empty_cache()
    check(len(reqs) == 64 and all(len(r.tokens) == 128 for r in reqs),
          "serve_quant: a request lacks tokens")
    same = sum(list(r.tokens) == s for r, s in zip(reqs, fp_streams))
    rows = summary["ledger"]
    decode = rows.get("serve_decode", {})
    identity = gap_sum_identity(decode)
    out = {"decode_tokens_per_s_per_chip":
               summary["decode_tokens_per_s_per_chip"],
           "identical_to_unquantized": same / len(reqs),
           "ledger": rows, "gap_sum_identity": identity}
    print(f"# serve_quant int8 + cost ledger ({CARD}): {json.dumps(out)}",
          flush=True)
    check({"serve_decode", "serve_prefill"} <= set(rows)
          and abs(identity - 1.0) <= 1e-9 and 0.0 < decode["mfu"] < 1.0,
          f"cost ledger rows {sorted(rows)}, identity {identity}, mfu "
          f"{decode.get('mfu')}")
    return out


def serve_argv(run: str, kv_quant: str, requests: int = 64) -> list:
    """run.serve's flags for the serve workload: GPT-2 base on 32 slots,
    pages of 16, prompts of 256 tokens padded to 512, 128 new tokens
    each, greedy."""
    return ["--checkpoint_path", run, "--decode_slots", "32",
            "--page_size", "16", "--max_prompt_len", "512",
            "--synthetic_requests", str(requests),
            "--synthetic_prompt_len", "256", "--max_new_tokens", "128",
            "--temperature", "0", "--decode_impl", "auto",
            "--kv_quant", kv_quant]


def serve_run(torch, fd, run, kv_quant: str, bw, bf16_peak) -> dict:
    """One run.serve pass (which prints its JSON summary) over a KV pool of
    ``kv_quant`` pages: the kernel's launches over that page type, every
    request's tokens, one decode step from a live state through the kernel
    and through the plain version, and the kernel's time and bound at that
    state's depths."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.run.serve import serve

    new_tokens = 128
    settings = parse_settings(serve_argv(run, kv_quant))
    fd.reset_launch_count()
    summary, server, reqs = serve(settings)
    counters = fd.launch_counters()
    other = "fp" if kv_quant == "int8" else "int8"
    launches = fd.launch_count(kv_quant)

    eng = server.engine
    streams = [list(r.tokens) for r in reqs]
    check(len(reqs) == 64, f"{len(reqs)} requests served")
    for r in reqs:
        check(len(r.tokens) == new_tokens
              and all(0 <= t < GPT2_BASE["vocab_size"] for t in r.tokens),
              f"request {r.id} returned {len(r.tokens)} tokens")
    want = GPT2_BASE["num_layers"] * eng.decode_span * server.decode_steps
    check(launches == want == summary["decode_kernel_launches"]
          and fd.launch_count(other) == 0,
          f"{kv_quant} kernel launches {launches} ({other}: "
          f"{fd.launch_count(other)}), expected {want}")
    check(all(t.is_cuda for entry in eng.kv_cache for t in entry),
          "the KV pool is not on the GPU")
    check(summary["kv_quant"] == kv_quant
          and eng.kv_cache[0][0].dtype == (torch.int8 if kv_quant == "int8"
                                           else torch.bfloat16),
          f"the {kv_quant} run's pool is {eng.kv_cache[0][0].dtype}")

    # one decode step from a live state, kernel vs plain version
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    prompts = [r.prompt for r in reqs[:32]]
    for p in prompts:
        server.submit(p, max_new_tokens=8)
    server.step()
    server.step()
    saved = [tuple(t.clone() for t in entry) for entry in eng.kv_cache]
    logits = one_step(torch, eng, eng.model, saved, kv_quant)
    if kv_quant == "int8":
        # An int8 pool holds the same values for any compute dtype. In
        # bf16 the plain version rounds the dequantized K/V to bf16 where
        # the kernel (like the JAX kernel) keeps them in f32, so near-tied
        # slots may pick differently; that comparison is printed with the
        # flipped slots' top-2 gaps, and the check runs at f32 compute,
        # where both arms read the same K/V values.
        report_step(torch, logits, "int8 pool, bf16 compute")
        from distributed_pipeline_tpu_torch.models import \
            create_model_from_config
        m32 = create_model_from_config(**{**GPT2_BASE, "dtype": "float32"},
                                       device="cuda")
        m32.load_state_dict(eng.model.state_dict())
        logits = one_step(torch, eng, m32, saved, kv_quant)
        del m32

    # the kernel alone at this live state's depths (layer 0's pool, a fresh
    # bf16 q), beside its bound on the same inputs
    pool = eng.kv_cache[0]
    H = GPT2_BASE["num_heads"]
    q = torch.randn((eng.decode_slots, H, pool[0].shape[-1]), device="cuda",
                    dtype=torch.bfloat16)
    table, positions = eng.block_table, eng.positions
    depth_ms, depth_split = device_ms(
        lambda: fd.flash_decode(q, pool[0], pool[1], table, positions,
                                *pool[2:]), torch, flush, clean_l2=True)
    depth = {"serve_depth_ms": depth_ms,
             "serve_depth_kernels_ms": depth_split}
    depth.update({f"serve_depth_{key}": val for key, val in kernel_bound(
        fd, table, positions, pool[0].shape[1], H, pool[0].shape[-1], bw,
        bf16_peak, quantized=kv_quant == "int8").items()})
    pos = positions.cpu()
    print(f"# serve {kv_quant}: kernel at the live state (depths "
          f"{int(pos.min())}-{int(pos.max())}): {depth}", flush=True)
    server.drain()
    pool_bytes = eng.kv_pool_bytes()
    check(pool_bytes == summary["kv_pool_bytes"],
          f"kv_pool_bytes {pool_bytes} vs the summary's "
          f"{summary['kv_pool_bytes']}")

    report_step(torch, logits, f"{kv_quant} pool, "
                f"{'f32' if kv_quant == 'int8' else 'bf16'} compute",
                strict=True)
    del server, eng, saved, pool
    torch.cuda.empty_cache()
    return {"launches": launches, "kv_pool_bytes": pool_bytes,
            "streams": streams, "counters": counters, "summary": summary,
            "argv": serve_argv(run, kv_quant),
            "decode_tokens_per_s_per_chip":
                summary["decode_tokens_per_s_per_chip"],
            "ttft_p50_s": summary["ttft_p50_s"],
            "ttft_p95_s": summary["ttft_p95_s"], **depth}


def one_step(torch, eng, model, saved, kv_quant: str) -> dict:
    """The logits of one decode step of ``model`` from the engine's live
    state, through the kernel and through the plain version, each from the
    same saved pool."""
    logits = {}
    with torch.inference_mode():
        for impl in ("cuda", "torch"):
            for entry, entry0 in zip(eng.kv_cache, saved):
                for t, t0 in zip(entry, entry0):
                    t.copy_(t0)
            logits[impl] = model(
                eng.tokens[:, None], None, cache_index=eng.positions,
                block_table=eng.block_table, kv_cache=eng.kv_cache,
                decode_impl=impl, kv_quant=kv_quant)[:, 0].float()
    return logits


def report_step(torch, logits, what: str, strict: bool = False) -> None:
    """Kernel-path logits against the plain version's: finite, within 5% of
    the logit scale (through 12 layers the plain version rounds logits and
    probabilities to the compute dtype in every layer, the kernel keeps
    f32), and, when ``strict``, the same next token in every slot. Prints
    the top-2 gap of the plain logits in any slot whose pick differs."""
    a, b = logits["cuda"], logits["torch"]
    check(bool(torch.isfinite(a).all()), "kernel-path logits not finite")
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    differ = (a.argmax(-1) != b.argmax(-1)).nonzero().flatten().tolist()
    agree = 1.0 - len(differ) / a.shape[0]
    top2 = b.topk(2, dim=-1).values
    gaps = {s: float(top2[s, 0] - top2[s, 1]) for s in differ}
    print(f"# serve: one decode step ({what}), kernel vs plain: max |logit| "
          f"{scale}, max abs diff {diff}, argmax agreement {agree}"
          + (f"; slots that differ and their top-2 gaps {gaps}"
             if differ else ""), flush=True)
    check(diff <= 0.05 * scale, f"decode logits differ by {diff} "
          f"(scale {scale})")
    if strict:
        check(agree == 1.0, f"kernel and plain version pick different next "
              f"tokens for {1 - agree:.4f} of the slots")


def close_enough(got, ref, rtol: float, atol: float) -> float:
    """Max abs error; raises unless |got - ref| <= atol + rtol |ref|."""
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    check(not bool(bad.any()), f"{int(bad.sum())} of {bad.numel()} "
          f"entries off (max abs err {float(err.max())}, rtol {rtol}, "
          f"atol {atol})")
    return float(err.max())


def bound(hbm_bytes: float, flops: float, bw: float, peak: float) -> dict:
    bytes_ms, ops_ms = hbm_bytes / bw * 1e3, flops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "hbm_bytes": hbm_bytes, "flops": flops}


def flash_check(torch, fa, B, H, L, Dh, dtype, causal, lens, seed,
                long_rows: bool = False):
    """Kernel forward and backward vs the plain versions on one case; bf16
    against the plain version in f32 from the same bf16 inputs. Returns
    the max abs errors, and for bf16 the max difference between two
    backward calls on the same inputs, which must be bitwise equal (dq's
    parts are summed in a fixed order).
    ``long_rows`` (bf16, every row hundreds of live keys) holds ``out`` to
    its rounding bound instead (``long_rows_out``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn((B, H, L, Dh), generator=g, device=dev)
                     .to(dtype) for _ in range(4))
    mask = (torch.arange(L, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
    out, lse = fa.flash_forward(q, k, v, mask, causal)
    dq, dk, dv = fa.flash_backward(q, k, v, mask, causal, out, lse, dout)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = fa.torch_flash_forward(*f, mask, causal)
    # the backward's reference takes the kernel's own (rounded) out and lse
    refs = fa.torch_flash_backward(*f, mask, causal, out.float(), lse,
                                   dout.float())
    if dtype == torch.float32:
        tol = dict(rtol=1e-4, atol=1e-5)   # another summation order
        tol_b = dict(rtol=1e-4, atol=1e-4)
    else:
        # one bf16 rounding of an f32 result (2^-8 relative), p rounded to
        # bf16 before p.v (as the JAX kernel's p.astype(v.dtype)), plus f32
        # cancellation in the sums: atol 1e-3 of the largest entry
        tol = dict(rtol=8e-3, atol=1e-3 * float(ref_out.abs().max()))
        tol_b = None
    if long_rows:
        errs = long_rows_out(torch, fa, q, k, v, mask, causal, out, ref_out,
                             ref_lse)
    else:
        errs = {"out": close_enough(out, ref_out, **tol)}
    errs["lse"] = close_enough(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        # bf16: p and ds enter their products as bf16 (2^-9 relative each)
        # and dq's parts are summed in f32 in another order. A row with
        # few live keys has ds = p (dp - delta), a difference of nearly
        # equal terms, so those roundings are large against that row's own
        # gradient: entrywise atol 1e-2 of the largest entry (at least
        # 1e-4, for gradients that are zero in exact arithmetic), and the
        # whole tensor within 1e-2 in relative Frobenius norm
        if tol_b is None:
            ref = ref.float()
            rel = float((got.float() - ref).norm() / ref.norm().clamp_min(
                1e-30))
            check(rel <= 1e-2 or float(ref.norm()) < 1e-3,
                  f"{name}: relative Frobenius error {rel}")
            errs[name + "_rel_fro"] = rel
        t = tol_b or dict(rtol=1e-2,
                          atol=max(1e-2 * float(ref.abs().max()), 1e-4))
        errs[name] = close_enough(got, ref, **t)
    dead = [b for b, n in enumerate(lens) if n == 0]
    for b in dead:   # fully masked rows: zero output, zero gradients
        check(bool(torch.all(out[b] == 0)) and bool(torch.all(dq[b] == 0))
              and bool(torch.all(dk[b] == 0))
              and bool(torch.all(dv[b] == 0)), "masked rows not zero")
    if dtype == torch.bfloat16:
        again = fa.flash_backward(q, k, v, mask, causal, out, lse, dout)
        errs["rerun_max_diff"] = max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(again, (dq, dk, dv)))
        check(all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))),
              f"two bf16 backward calls on the same inputs differ by "
              f"{errs['rerun_max_diff']}")
        # the key tiles split over several launches (a small dq scratch
        # cap): the same sums in the same order, so the same bits
        cap = fa.DQ_SCRATCH_CAP
        fa.DQ_SCRATCH_CAP = max(1, B * H * L * Dh * 4 * 2)
        try:
            errs["dq_launches_split"] = fa.dq_launch_plan(B, H, L, Dh)[2]
            split = fa.flash_backward(q, k, v, mask, causal, out, lse, dout)
        finally:
            fa.DQ_SCRATCH_CAP = cap
        check(all(torch.equal(a, b) for a, b in zip(split, (dq, dk, dv))),
              f"the backward split over {errs['dq_launches_split']} "
              f"launches differs from one launch")
    return errs


def long_rows_out(torch, fa, q, k, v, mask, causal, out, ref_out,
                  ref_lse) -> dict:
    """The bf16 forward's ``out`` where every row attends to hundreds of
    keys. Each p is rounded to bf16 (2^-9 relative) before p.v and ``out``
    once more, so |out - ref| <= 2^-9 (p.|v|) + 2^-9 |ref| in exact
    arithmetic: held entrywise at twice that, and in relative Frobenius
    norm within 1e-2. A bar of 1e-3 of the largest entry (the short and
    causal cases') is not met here by the plain version itself in bf16:
    the p-rounding error of an entry scales with p.|v|, which stays near
    E|v| while the entry itself averages towards 0 over long rows; both
    are printed. The plain version with the pad mask dropped must fall
    outside the bars."""
    f = [t.float() for t in (q, k, v)]
    live = mask.bool()[:, None, None, :]
    if causal:
        L = q.shape[-2]
        live = live & torch.ones((L, L), dtype=torch.bool,
                                 device=q.device).tril()
    s = torch.einsum("bhld,bhmd->bhlm", f[0], f[1]) * q.shape[-1] ** -0.5
    p = torch.where(live, torch.exp(s - ref_lse[..., None]), 0.0)
    del s
    bound = 2.0 ** -8 * (p @ f[2].abs() + ref_out.abs())
    del p
    ref = ref_out.float()

    def judge(got) -> dict:
        err = (got.float() - ref).abs()
        return {"max_abs_err": float(err.max()),
                "max_err_over_bound": float((err / bound).max()),
                "rel_fro": float((got.float() - ref).norm() / ref.norm()),
                "outside_global_max_bar": int((err > 1e-3 * float(
                    ref.abs().max()) + 8e-3 * ref.abs()).sum())}

    kernel = judge(out)
    plain = judge(fa.torch_flash_forward(q, k, v, mask, causal)[0])
    wrong = judge(fa.torch_flash_forward(*f, None, causal)[0])
    print(f"# flash check, long rows: kernel {kernel}; the plain version "
          f"in bf16 {plain}; the plain version without the pad mask "
          f"{wrong}", flush=True)
    check(kernel["max_err_over_bound"] <= 1.0 and kernel["rel_fro"] <= 1e-2,
          f"long rows: out outside its rounding bound: {kernel}")
    check(wrong["max_err_over_bound"] > 1.0 and wrong["rel_fro"] > 1e-2,
          f"long rows: the bars cannot tell a dropped pad mask: {wrong}")
    return {"out": kernel["max_abs_err"], "out_rel_fro": kernel["rel_fro"],
            "out_err_over_bound": kernel["max_err_over_bound"],
            "plain_bf16_out_err_over_bound": plain["max_err_over_bound"],
            "out_outside_global_max_bar": kernel["outside_global_max_bar"],
            "plain_bf16_outside_global_max_bar":
                plain["outside_global_max_bar"]}


def build_report(log_path: str) -> list:
    """Registers, shared memory and spills of every kernel in the build
    log's ``-Xptxas -v`` report."""
    import re
    rows, name = [], None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and name:
                rows.append({"kernel": name, "spill_stores": int(m.group(1)),
                             "spill_loads": int(m.group(2))})
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and rows and rows[-1]["kernel"] == name:
                smem = re.search(r"(\d+) bytes smem", line)
                rows[-1].update(registers=int(m.group(1)),
                                smem_bytes=int(smem.group(1)) if smem else 0)
    return rows


def flash_phase(torch, bw, bf16_peak) -> list:
    """The flash kernels vs their plain versions on every case, and their
    times at the training shape beside the library calls, in turns."""
    from distributed_pipeline_tpu_torch.ops import flash_attention as fa

    B, H, L, Dh = 4, 12, 1024, 64
    bf16 = torch.bfloat16
    cases = {
        "train_bf16": (B, H, L, Dh, bf16, True, [L] * B),
        "ragged_bf16": (B, H, 1000, Dh, bf16, True, [1000, 733, 1, 0]),
        "f32_dh64": (2, 3, 200, 64, torch.float32, True, [200, 77]),
        "f32_dh128_noncausal": (2, 3, 130, 128, torch.float32, False,
                                [130, 0]),
        "dh128_bf16": (2, 4, 1024, 128, bf16, True, [1024, 1024]),
        "l1_bf16": (2, 4, 1, Dh, bf16, True, [1, 1]),
        "l65_bf16": (2, 4, 65, Dh, bf16, True, [65, 30]),
        "l129_bf16": (2, 4, 129, 128, bf16, True, [129, 129]),
        "noncausal_dead_bf16": (2, 4, 200, Dh, bf16, False, [200, 0]),
    }
    # the DiffuSeq seq-1024 step's two microbatches: bidirectional, with the
    # pad mask live inside every row (diffuseq_long_step drives this path)
    lens = long_batch()["pad_mask"].sum(1).tolist()
    for mb in range(2):
        cases[f"diffuseq_seq1024_mb{mb}_bf16"] = (
            B, H, L, Dh, bf16, False, lens[4 * mb:4 * mb + 4])
    errs = {name: flash_check(torch, fa, *c, seed=i,
                              long_rows=name.startswith("diffuseq"))
            for i, (name, c) in enumerate(cases.items())}
    print(f"# flash check: max abs err {json.dumps(errs)}", flush=True)
    split = {n: e["dq_launches_split"] for n, e in errs.items()
             if "dq_launches_split" in e}
    print(f"# flash determinism: two bf16 backward calls on the same inputs "
          f"bitwise equal in all {len(split)} bf16 cases, and equal to the "
          f"backward split over several launches {split}", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, dout = (torch.randn((B, H, L, Dh), generator=g, device=dev)
                     .to(bf16) for _ in range(4))
    mask = torch.ones((B, L), dtype=torch.int32, device=dev)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    out, lse = fa.flash_forward(q, k, v, mask, True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(ql, kl, vl, is_causal=True)
    fns = {
        "fwd": lambda: fa.flash_forward(q, k, v, mask, True),
        "fwd_lib": lambda: sdpa(q, k, v, is_causal=True),
        "bwd": lambda: fa.flash_backward(q, k, v, mask, True, out, lse,
                                         dout),
        "bwd_lib": lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dout, retain_graph=True),
    }
    runs = {name: [] for name in fns}      # device ms, one per turn
    event = {name: [] for name in fns}     # CUDA-event ms, host included
    split = {}
    for order in (("fwd_lib", "fwd", "bwd_lib", "bwd"),
                  ("fwd", "fwd_lib", "bwd", "bwd_lib")):
        for name in order:
            total, split[name] = device_ms(fns[name], torch, flush)
            runs[name].append(total)
            event[name].append(time_ms(fns[name], torch, flush))
    ms = {name: statistics.median(t) for name, t in runs.items()}
    fwd_plain = time_ms(lambda: fa.torch_flash_forward(q, k, v, mask, True),
                        torch, flush, reps=20)
    bwd_plain = time_ms(lambda: fa.torch_flash_backward(
        q, k, v, mask, True, out, lse, dout), torch, flush, reps=20)
    src = "distributed_pipeline_tpu_torch/ops/csrc/flash_attention.cu"
    main = errs["train_bf16"]
    rows = [
        {"name": "flash_forward", "route": "cuda", "source": src,
         "replaces": "distributed_pipeline_tpu/ops/flash_attention.py:185",
         "launches": None,
         "max_abs_err": max(main["out"], main["lse"]),
         "ms": ms["fwd"], "ms_runs": runs["fwd"], "event_ms": event["fwd"],
         "kernels_ms": split["fwd"], "plain_ms": fwd_plain,
         **bound(fa.flash_hbm_bytes(B, H, L, Dh, 2, True),
                 fa.flash_flops(B, H, L, Dh, True), bw, bf16_peak),
         "library_ms": ms["fwd_lib"], "library_ms_runs": runs["fwd_lib"],
         "library_event_ms": event["fwd_lib"],
         "library_kernels_ms": split["fwd_lib"],
         "library_call": "scaled_dot_product_attention(is_causal=True)"},
        {"name": "flash_backward", "route": "cuda", "source": src,
         "replaces": "distributed_pipeline_tpu/ops/flash_attention.py:240",
         "launches": None,
         "max_abs_err": max(main["dq"], main["dk"], main["dv"]),
         "rerun_max_diff": main["rerun_max_diff"],
         "ms": ms["bwd"], "ms_runs": runs["bwd"], "event_ms": event["bwd"],
         "kernels_ms": split["bwd"], "plain_ms": bwd_plain,
         **bound(fa.flash_hbm_bytes(B, H, L, Dh, 2, True, backward=True),
                 fa.flash_flops(B, H, L, Dh, True, backward=True), bw,
                 bf16_peak),
         "library_ms": ms["bwd_lib"], "library_ms_runs": runs["bwd_lib"],
         "library_event_ms": event["bwd_lib"],
         "library_kernels_ms": split["bwd_lib"],
         "library_call": "autograd backward of scaled_dot_product_attention"
                         "(is_causal=True)"},
    ]
    for row in rows:
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["x_library"] = row["ms"] / row["library_ms"]
        print(f"# flash timing: {row['name']} {row['ms']:.5f} ms "
              f"({row['tflops']:.1f} TFLOP/s, {row['share_of_bound']:.3f} of "
              f"the bound {row['bound_ms']:.6f} ms, {row['x_library']:.2f}x "
              f"the library's {row['library_ms']:.5f} ms; device time; "
              f"CUDA events, host enqueue included: {row['event_ms']} vs "
              f"{row['library_event_ms']})", flush=True)
    return rows


def param_shapes(cfg: dict) -> list:
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    model = create_model_from_config(**cfg, device="meta")
    return [tuple(p.shape) for p in model.parameters()]


def update_phase(torch, bw, f32_peak, cfg: dict,
                 name: str = "fused_adamw_ema",
                 elements: int = 0) -> dict:
    """The fused update vs its plain version, bitwise over 3 steps, at the
    parameter count of the model ``cfg`` (or at ``elements``, one leaf: a
    ZeRO-1 shard) with 3 EMA rates; its time beside its bound."""
    from distributed_pipeline_tpu_torch.ops import fused_update as fu

    dev = torch.device("cuda")
    shapes = [(elements,)] if elements else param_shapes(cfg)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    n, rates = sum(sizes), [0.5, 0.9, 0.99]
    g = torch.Generator(device=dev).manual_seed(11)
    base = [torch.randn(n, generator=g, device=dev) * 0.02 for _ in range(4)]
    base[3] = base[3] * base[3]                      # nu >= 0
    ema0 = torch.randn((3, n), generator=g, device=dev) * 0.02
    arms = {name: [t.clone() for t in base] + [ema0.clone()]
            for name in ("kernel", "plain")}
    count = torch.zeros((), dtype=torch.int32, device=dev)

    def lr_fn(c):
        return torch.tensor(3e-4, device=dev) * torch.clamp(
            1.0 - c.float() / 20, min=0.0)

    for _ in range(3):
        scal = fu.update_scalars(count, lr_fn)
        fu.fused_adamw_ema(*arms["kernel"], scal, rates, weight_decay=0.01)
        fu.torch_fused_update(*arms["plain"], scal, rates, weight_decay=0.01)
        count += 1
    torch.cuda.synchronize()
    for a, b in zip(arms["kernel"], arms["plain"]):
        check(torch.equal(a, b), "fused update differs from its plain "
              "version (must be bitwise)")
    print(f"# update check ({cfg['model_family']}): {n} elements x 3 steps, "
          f"kernel == plain bitwise", flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    scal = fu.update_scalars(count, lr_fn)
    st = arms["kernel"]
    ms = time_ms(lambda: fu.fused_adamw_ema(*st, scal, rates,
                                            weight_decay=0.01), torch, flush)
    plain_ms = time_ms(lambda: fu.torch_fused_update(
        *st, scal, rates, weight_decay=0.01), torch, flush, reps=20)
    leaves = [torch.zeros(s, device=dev, requires_grad=True) for s in shapes]
    for p in leaves:
        p.grad = torch.randn(p.shape, generator=g, device=dev) * 0.02
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.01, fused=True)
    library_ms = time_ms(opt.step, torch, flush)
    del arms, base, ema0, leaves, opt
    return {"name": name, "route": "cuda",
            "source": "distributed_pipeline_tpu_torch/ops/csrc/"
                      "fused_update.cu",
            "replaces": "distributed_pipeline_tpu/ops/fused_update.py:90",
            "launches": None, "max_abs_err": 0.0, "elements": n,
            "ms": ms, "plain_ms": plain_ms,
            # 16 f32 operations per element for the Adam tail, 3 per EMA
            **bound(fu.update_hbm_bytes([n], 3, per_leaf_scalars=False),
                    25.0 * n, bw, f32_peak),
            "library_ms": library_ms,
            "library_call": "torch.optim.AdamW(fused=True).step() over the "
                            "same leaves (yardstick only: another op order, "
                            "no EMA)"}


def train_phase(torch, fa, fu, run: str) -> dict:
    """GPT-2 base, seq 1024, 20 steps through run.train into ``run`` (kept
    for the decoding phase); then the run dir served, and one step from
    the saved state through the kernels and through the plain versions."""
    from distributed_pipeline_tpu_torch.run import serve as serve_mod
    from distributed_pipeline_tpu_torch.run.train import main as train_main

    steps, layers, n_micro = 20, GPT2_BASE["num_layers"], 2
    argv = ["--checkpoint_path", run, "--model_family", "gpt2",
            "--model_size", "base", "--vocab_size", "50257",
            "--seq_len", "1024", "--hidden_size", "768",
            "--num_layers", "12", "--num_heads", "12",
            "--dtype", "bfloat16", "--dataset", "synthetic-lm",
            "--batch_size", "8", "--microbatch", "4",
            "--learning_steps", str(steps), "--lr", "3e-4",
            "--ema_rate", "0.5,0.9,0.99", "--attention_impl", "auto",
            "--fused_update", "auto", "--log_interval", "5",
            "--save_interval", "0", "--seed", "0"]
    fa.reset_launch_counts()
    fu.reset_launch_count()
    t0 = time.perf_counter()
    loop = train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_forward": fa.forward_launch_count(),
                "flash_backward": fa.backward_launch_count(),
                "fused_adamw_ema": fu.launch_count()}
    want = layers * n_micro * steps
    check(launches["flash_forward"] == want
          and launches["flash_backward"] == want,
          f"flash launches {launches}, expected {want} each")
    check(launches["fused_adamw_ema"] == steps,
          f"update launches {launches['fused_adamw_ema']}, expected "
          f"{steps} (one a step)")
    losses = [h["loss"] for h in loop.history]
    check(len(losses) == steps and all(
        x == x and abs(x) < float("inf") for x in losses),
        f"losses not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    with open(os.path.join(run, "progress.csv")) as f:
        rows = f.read().splitlines()
    last = dict(zip(rows[0].split(","), rows[-1].split(",")))
    gauges = {k: float(last[k]) for k in
              ("tokens_per_sec_per_chip", "mfu", "step_time_s")}
    print(f"# train: {steps} steps in {wall:.1f} s, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches}, "
          f"last window {gauges}", flush=True)
    for name in ("model_000020.pt", "opt_000020.pt", "meta_000020.json",
                 "ema_0.5_000020.pt", "ema_0.9_000020.pt",
                 "ema_0.99_000020.pt"):
        check(os.path.exists(os.path.join(run, name)), f"no {name}")
    del loop
    torch.cuda.empty_cache()

    summary = serve_mod.main([
        "--checkpoint_path", run, "--decode_slots", "4",
        "--max_prompt_len", "128", "--synthetic_requests", "4",
        "--max_new_tokens", "16"])
    check(summary["requests"] == 4 and summary["decode_tokens"] == 64
          and summary["step"] == steps,
          f"serving the trained run dir: {summary}")
    torch.cuda.empty_cache()
    twice = one_step_twice(torch, fa, fu, run, argv)
    return {"launches": launches, "losses": losses, "wall_s": wall,
            **gauges, **twice}


def one_step_twice(torch, fa, fu, run, argv, cfg=None, step: int = 20
                   ) -> dict:
    """One step from the run dir's saved state (GPT-2 ``cfg``, default
    base, at ``step``) with the kernels, twice, and one with
    ``attention_impl torch`` and ``fused_update false``."""
    from distributed_pipeline_tpu_torch.config.train import parse_settings
    from distributed_pipeline_tpu_torch.data import load_data_from_args
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.utils.logger import Logger
    from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop

    cfg = cfg or GPT2_BASE
    args = parse_settings(argv)
    batch = next(load_data_from_args(
        "train", batch_size=8, dataset="synthetic-lm", seq_len=1024,
        vocab_size=50257, seed=0, skip_batches=step))
    out, grads = {}, {}
    # the saved parameters as the loops' initial ones (the resume loads
    # them again with the rest of the state): no random init per arm
    saved = torch.load(os.path.join(run, f"model_{step:06d}.pt"),
                       map_location="cuda", weights_only=True)
    per_step = 2 * cfg["num_layers"]
    for arm, (attn, fused) in (("kernels", ("auto", "auto")),
                               ("kernels_again", ("auto", "auto")),
                               ("plain", ("torch", "false"))):
        model = create_model_from_config(**{**cfg, "attention_impl": attn},
                                         device="cuda")
        loop = TrainLoop(
            model=model, data=None, batch_size=8, microbatch=4, lr=args.lr,
            ema_rate=args.ema_rate, learning_steps=args.learning_steps,
            checkpoint_dir=run, fused_update=fused, init_params=saved,
            logger=Logger(""))
        check(loop.step == step, f"resumed at step {loop.step}, not {step}")
        fa.reset_launch_counts()
        fu.reset_launch_count()
        m = loop.run_step(batch)
        out[arm] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
        grads[arm] = loop.grads.clone()
        n = (fa.forward_launch_count(), fa.backward_launch_count(),
             fu.launch_count())
        check(n == ((0, 0, 0) if arm == "plain"
                    else (per_step, per_step, 1)),
              f"{arm} arm launches {n}")
        del loop, model
        torch.cuda.empty_cache()
    a, b = out["kernels"], out["plain"]
    same = torch.equal(grads["kernels"], grads["kernels_again"])
    print(f"# train: one step from the saved state, kernels {a}, again "
          f"{out['kernels_again']} (every gradient bitwise equal: {same}), "
          f"plain {b}", flush=True)
    check(out["kernels_again"] == a and same,
          f"two kernel steps from one saved state differ: {a} vs "
          f"{out['kernels_again']}, gradients equal {same}")
    del grads
    # bf16 through 12 layers: both arms round p to bf16 before p.v; the
    # plain backward runs f32 einsums where the kernel feeds p and ds to
    # its products as bf16; allow 0.5% of the loss and 3% of the gradient
    # norm
    check(abs(a["loss"] - b["loss"]) <= 5e-3 * abs(b["loss"]),
          f"one-step loss differs: {a} vs {b}")
    check(abs(a["grad_norm"] - b["grad_norm"]) <= 3e-2 * b["grad_norm"],
          f"one-step grad norm differs: {a} vs {b}")
    return {"one_step": out}


def diffuseq_phase(torch, fa, fu) -> dict:
    """DiffuSeq-base through run.train with the JAX package's defaults, one
    step from its saved state with the fused update and with the plain
    one, one step at seq_len 1024 through the flash kernels and through
    their plain versions, and run.sample on the trained run dir."""
    from distributed_pipeline_tpu_torch.run import sample as sample_mod
    from distributed_pipeline_tpu_torch.run.train import main as train_main

    steps = 20
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "diffuseq_base_train")
        argv = ["--checkpoint_path", run, "--batch_size", "256",
                "--microbatch", "64", "--learning_steps", str(steps),
                "--ema_rate", "0.5,0.9,0.99", "--attention_impl", "auto",
                "--fused_update", "auto", "--log_interval", "5",
                "--save_interval", "0", "--seed", "0"]
        fa.reset_launch_counts()
        fu.reset_launch_count()
        t0 = time.perf_counter()
        loop = train_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_forward": fa.forward_launch_count(),
                    "flash_backward": fa.backward_launch_count(),
                    "fused_adamw_ema": fu.launch_count()}
        check(loop.model.family == "diffuseq"
              and loop.n_params == 91_039_872,
              f"trained {loop.model.family} with {loop.n_params} parameters")
        check(launches == {"flash_forward": 0, "flash_backward": 0,
                           "fused_adamw_ema": steps},
              f"launches {launches}: expected the update once a step and "
              f"no flash kernel (dense arm at seq_len 128)")
        losses = [h["loss"] for h in loop.history]
        check(len(losses) == steps and all(
            x == x and abs(x) < float("inf") for x in losses),
            f"losses not finite: {losses}")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        with open(os.path.join(run, "progress.csv")) as f:
            rows = f.read().splitlines()
        last = dict(zip(rows[0].split(","), rows[-1].split(",")))
        gauges = {k: float(last[k]) for k in
                  ("tokens_per_sec_per_chip", "mfu", "step_time_s")}
        print(f"# diffuseq train: {steps} steps in {wall:.1f} s, losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches}, "
              f"last window {gauges}", flush=True)
        for name in (f"model_{steps:06d}.pt", f"opt_{steps:06d}.pt",
                     f"meta_{steps:06d}.json", f"ema_0.5_{steps:06d}.pt",
                     f"ema_0.9_{steps:06d}.pt", f"ema_0.99_{steps:06d}.pt"):
            check(os.path.exists(os.path.join(run, name)), f"no {name}")
        del loop
        torch.cuda.empty_cache()
        update_step = diffuseq_update_step(torch, fu, run, steps)

        t0 = time.perf_counter()
        pred_path = os.path.join(tmp, "pred.jsonl")
        sampled = sample_mod.main(["--checkpoint_path", run,
                                   "--batch_size", "32", "--num_batches",
                                   "2", "--sample_steps", "20", "--mbr", "1",
                                   "--out", pred_path])
        sample_wall = time.perf_counter() - t0
        check(sampled["step"] == steps
              and 0.0 <= sampled["decode_acc"] <= 1.0
              and math.isfinite(sampled["eval_loss"]),
              f"run.sample on the trained run dir: {sampled}")
        check_predictions(pred_path, run, sampled["decode_acc"])
        print(f"# diffuseq sample: decode_acc {sampled['decode_acc']}, "
              f"eval_loss {sampled['eval_loss']}, {sample_wall:.2f} s",
              flush=True)
    long_ctx = diffuseq_long_step(torch, fa, fu)
    return {"launches": launches, "losses": losses, "wall_s": wall,
            **gauges, "update_step": update_step, "seq1024": long_ctx,
            "sample": {**sampled, "wall_s": sample_wall}}


def check_predictions(path: str, run: str, decode_acc: float) -> None:
    """run.sample's ``--out`` rows against the valid batches it decoded:
    the gold ids are those batches, the prediction keeps every id off the
    target span (the anchored source, the padding), its ids are in the
    vocabulary, and the target-span accuracy recomputed from the rows is
    the ``decode_acc`` it printed."""
    import numpy as np
    from distributed_pipeline_tpu_torch.data import load_data_from_args

    with open(os.path.join(run, "training_args.json")) as f:
        targs = json.load(f)
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    data = load_data_from_args("valid", **{
        **targs, "batch_size": 32, "deterministic": True,
        "num_loader_proc": 0, "data_loader_workers": 0})
    check(len(rows) == 64, f"run.sample wrote {len(rows)} rows, not 64")
    accs = []
    for b in range(2):
        batch = next(data)
        gold = np.array([r["gold"] for r in rows[32 * b:32 * b + 32]])
        pred = np.array([r["pred"] for r in rows[32 * b:32 * b + 32]])
        tgt = batch["input_mask"] * batch["pad_mask"]
        check(np.array_equal(gold, batch["input_ids"]),
              f"batch {b}: the written gold ids are not the valid batch")
        check(pred.shape == gold.shape and np.array_equal(
            pred[batch["input_mask"] == 0], gold[batch["input_mask"] == 0]),
            f"batch {b}: the prediction changed ids off the target span")
        check(int(pred.min()) >= 0 and int(pred.max()) < targs["vocab_size"],
              f"batch {b}: predicted ids outside the vocabulary")
        accs.append(float(((pred == gold) * tgt).sum() / max(tgt.sum(), 1)))
    check(abs(sum(accs) / 2 - decode_acc) <= 1e-6,
          f"decode_acc {decode_acc} is not the rows' {sum(accs) / 2}")


def diffuseq_update_step(torch, fu, run, steps: int) -> dict:
    """One step from the run dir's saved state with the fused update and
    one with its plain version (attention on the dense arm in both). The
    forward is the same computation, so the losses must agree to 1e-6; the
    embedding gradient is summed by atomics, so the grad norms are held to
    1e-4; the updated state must be bitwise equal where the gradients are
    (the update is bitwise its plain version)."""
    from distributed_pipeline_tpu_torch.data import load_data_from_args
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.utils.logger import Logger
    from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop

    batch = next(load_data_from_args("train", batch_size=256, seq_len=128,
                                     vocab_size=8192, seed=0,
                                     skip_batches=steps))
    out, state = {}, {}
    saved = torch.load(os.path.join(run, f"model_{steps:06d}.pt"),
                       map_location="cuda", weights_only=True)
    for arm, fused in (("kernel", "auto"), ("plain", "false")):
        loop = TrainLoop(
            model=create_model_from_config(**DIFFUSEQ_BASE, device="cuda"),
            data=None, batch_size=256, microbatch=64,
            ema_rate="0.5,0.9,0.99", learning_steps=steps + 1, seed=0,
            checkpoint_dir=run, fused_update=fused, init_params=saved,
            logger=Logger(""))
        check(loop.step == steps, f"resumed at step {loop.step}")
        fu.reset_launch_count()
        m = loop.run_step(batch)
        out[arm] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
        check(fu.launch_count() == (1 if arm == "kernel" else 0),
              f"{arm} arm: {fu.launch_count()} update launches")
        state[arm] = [t.clone() for t in (loop.grads, loop.params, loop.mu,
                                          loop.nu, loop.ema)]
        del loop
    a, b = out["kernel"], out["plain"]
    same_grads = torch.equal(state["kernel"][0], state["plain"][0])
    same_state = all(torch.equal(x, y) for x, y in zip(state["kernel"][1:],
                                                       state["plain"][1:]))
    del state
    torch.cuda.empty_cache()
    print(f"# diffuseq: one step from the saved state, fused update {a}, "
          f"plain {b}; gradients bitwise equal {same_grads}, updated state "
          f"bitwise equal {same_state}", flush=True)
    check(abs(a["loss"] - b["loss"]) <= 1e-6 * abs(b["loss"]),
          f"one-step loss differs: {a} vs {b}")
    check(abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * b["grad_norm"],
          f"one-step grad norm differs: {a} vs {b}")
    check(same_state or not same_grads,
          "equal gradients gave a different updated state")
    return {**out, "grads_bitwise_equal": same_grads,
            "state_bitwise_equal": same_state}


def long_batch() -> dict:
    """The DiffuSeq seq-1024 step's batch: 8 padded synthetic seq2seq rows,
    as numpy arrays."""
    from distributed_pipeline_tpu_torch.data import load_data_from_args
    return next(load_data_from_args("train", batch_size=8, seq_len=1024,
                                    vocab_size=8192, seed=0))


def attention_grads(loop) -> dict:
    """Each block's attention weight gradients (qkv, out) after a step."""
    return {name: g.detach().float().clone()
            for name, g in loop.state_dict_of(loop.grads).items()
            if ".attn." in name}


def worst_leaf(grads: dict, ref: dict) -> tuple:
    """(leaf, relative Frobenius error) of the leaf furthest from ``ref``."""
    errs = {n: float((grads[n] - ref[n]).norm() / ref[n].norm()) for n in ref}
    name = max(errs, key=errs.get)
    return name, errs[name]


def diffuseq_long_step(torch, fa, fu) -> dict:
    """DiffuSeq-base at seq_len 1024 (seeded random weights, padded rows):
    one step through ``auto`` (the flash kernels, bidirectional and
    pad-masked, and the fused update) and one through the plain versions,
    held to each other by the loss, the grad norm and every block's
    attention weight gradients. Two more plain steps, with the pad mask
    dropped from attention and with attention made causal, show what a
    kernel that got the mask wrong would give: the same bars must reject
    both."""
    from distributed_pipeline_tpu_torch.convert import init_params
    from distributed_pipeline_tpu_torch.models import \
        backbone, create_model_from_config
    from distributed_pipeline_tpu_torch.utils.logger import Logger
    from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop

    cfg = {**DIFFUSEQ_BASE, "seq_len": 1024}
    batch = long_batch()
    lens = batch["pad_mask"].sum(1).tolist()
    check(min(lens) < 1024, f"no padded row at seq_len 1024: {lens}")
    sd = init_params(cfg, seed=0)
    attend = backbone.dot_product_attention
    wrong = {
        "no_pad_mask": lambda q, k, v, pad_mask, causal, impl:
            attend(q, k, v, None, causal=causal, impl=impl),
        "causal": lambda q, k, v, pad_mask, causal, impl:
            attend(q, k, v, pad_mask, causal=True, impl=impl),
    }
    out, grads = {}, {}
    for arm, (attn, fused) in (("kernels", ("auto", "auto")),
                               ("plain", ("torch", "false")),
                               ("no_pad_mask", ("torch", "false")),
                               ("causal", ("torch", "false"))):
        loop = TrainLoop(
            model=create_model_from_config(**{**cfg, "attention_impl": attn},
                                           device="cuda"),
            data=None, batch_size=8, microbatch=4, lr=1e-4,
            ema_rate="0.5,0.9,0.99", learning_steps=20, seed=0,
            init_params=sd, checkpoint_dir="", fused_update=fused,
            logger=Logger(""))
        fa.reset_launch_counts()
        fu.reset_launch_count()
        backbone.dot_product_attention = wrong.get(arm, attend)
        try:
            m = loop.run_step(batch)
        finally:
            backbone.dot_product_attention = attend
        out[arm] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
        grads[arm] = attention_grads(loop)
        n = (fa.forward_launch_count(), fa.backward_launch_count(),
             fu.launch_count())
        out[arm]["launches"] = n
        check(n == ((24, 24, 1) if arm == "kernels" else (0, 0, 0)),
              f"seq_len 1024 {arm} arm launches {n}")
        del loop
        torch.cuda.empty_cache()
    b = out["plain"]
    # the bars of the GPT-2 step (train phase): bf16 through 12 layers.
    # Per attention leaf, 3% in relative Frobenius norm: the kernel's dq,
    # dk and dv are held to 1e-2 each (flash_check), and a weight gradient
    # sums them over 8,192 tokens and carries them through 12 layers
    failed = {}
    for arm in ("kernels", "no_pad_mask", "causal"):
        a = out[arm]
        leaf, err = worst_leaf(grads[arm], grads["plain"])
        a.update(worst_attention_leaf=leaf, worst_attention_rel_fro=err)
        failed[arm] = [what for what, bad in (
            ("loss", abs(a["loss"] - b["loss"]) > 5e-3 * abs(b["loss"])),
            ("grad_norm",
             abs(a["grad_norm"] - b["grad_norm"]) > 3e-2 * b["grad_norm"]),
            ("attention_grads", err > 3e-2)) if bad]
        a["bars_failed"] = failed[arm]
    del grads
    print(f"# diffuseq seq_len 1024 (row lengths {lens}): one step, kernels "
          f"{out['kernels']}, plain {b}; a wrong mask: pad mask dropped "
          f"{out['no_pad_mask']}, causal {out['causal']}", flush=True)
    check(not failed["kernels"],
          f"seq_len 1024 kernels against plain: {failed['kernels']} outside "
          f"the bars: {out}")
    for arm in ("no_pad_mask", "causal"):
        check(bool(failed[arm]),
              f"seq_len 1024: the bars cannot tell a {arm} attention from "
              f"the right one: {out[arm]} vs {b}")
    return {**out, "row_lengths": lens}


class CallCount:
    """Counts the calls of ``module.name`` while installed (a plain
    version the phase must not reach); ``with CallCount(m, "f") as c:``."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name, self.calls = module, name, 0
        self.orig = getattr(module, name)

    def __enter__(self):
        def counted(*args, **kwargs):
            self.calls += 1
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.orig)


def row_gaps(torch, model, preds, refs, plen: int) -> tuple:
    """(identical rows, one record a diverging row): the position of its
    first divergence from ``refs`` and the top-2 gap of ``model``'s
    next-token logits there, from a dense forward over the common
    prefix."""
    same, gaps = 0, []
    for r, (got, ref) in enumerate(zip(preds, refs)):
        if list(got) == list(ref):
            same += 1
            continue
        i = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
        check(i >= plen, f"row {r}: a prompt token differs at {i}")
        ids = torch.tensor(list(ref[:i]), device="cuda")
        with torch.inference_mode():
            # no-drop routing, as the servers and decoders route
            logits = model(ids[None], moe_no_drop=True)[0, -1].float()
        top = logits.topk(2).values
        gaps.append({"row": r, "position": i,
                     "gap": float(top[0] - top[1]),
                     "max_abs_logit": float(logits.abs().max())})
    return same, gaps


def gpt2_decode_phase(torch, fa, fd, fu, run: str) -> dict:
    """Phase 10 on the train phase's run dir (GPT-2 base, step 20):
    ``run.sample`` greedy through the graph engine, ``gpt2_decode`` on its
    first batch, the f32 identity of the two decoders, per-batch seeds on
    a reused graph server, the EMA weights through ``run.sample`` and
    ``run.serve``, a GPT-2 ``run.train --eval_decode true``, and the native
    encoder with the tokenizer CLI."""
    import numpy as np
    from distributed_pipeline_tpu_torch.data import load_data_from_args
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.models.sampling import gpt2_decode
    from distributed_pipeline_tpu_torch.run import sample as sample_mod
    from distributed_pipeline_tpu_torch.run import serve as serve_mod
    from distributed_pipeline_tpu_torch.serving.scheduler import (
        DecodeServer, one_shot_decode)

    layers, vocab, L = (GPT2_BASE["num_layers"], GPT2_BASE["vocab_size"],
                        GPT2_BASE["seq_len"])
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. greedy run.sample, 2 batches of 8 rows, 512 generated tokens a
        # row, through the graph-replayed prefill and decode phases
        pred_path = os.path.join(tmp, "pred.jsonl")
        plen, batches = 512, 2
        fd.reset_launch_count()
        fa.reset_launch_counts()
        clocks("before gpt2 run.sample")
        t0 = time.perf_counter()
        with CallCount(fd, "torch_paged_decode") as plain:
            sampled = sample_mod.main([
                "--checkpoint_path", run, "--batch_size", "8",
                "--num_batches", str(batches), "--prompt_len", str(plen),
                "--out", pred_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        clocks(f"after gpt2 run.sample ({wall:.1f} s)")
        launches = fd.launch_count()
        want = layers * batches * (L - plen - 1)
        check(launches == fd.launch_count("fp") == want and plain.calls == 0,
              f"run.sample: {launches} decode kernel launches (expected "
              f"{want}: 12 a decode step), the plain version called "
              f"{plain.calls} times")
        # a prefill (the second one a graph replay) and an eval-loss
        # forward a batch, each 12 flash forward launches
        fwd = fa.forward_launch_count()
        check(fwd == 2 * layers * batches, f"run.sample: {fwd} flash "
              f"forward launches, expected {2 * layers * batches}")
        with open(pred_path) as f:
            rows = [json.loads(line) for line in f]
        check(len(rows) == 8 * batches and all(
            len(r["pred"]) == L and r["pred"][:plen] == r["gold"][:plen]
            and all(0 <= t < vocab for t in r["pred"][plen:]) for r in rows),
            "run.sample: a row without its 512 generated tokens")
        check(0.0 <= sampled["decode_acc"] <= 1.0
              and math.isfinite(sampled["eval_loss"])
              and sampled["params"] == "raw" and sampled["step"] == 20,
              f"run.sample: {sampled}")
        out["sample"] = {**sampled, "wall_s": wall,
                         "generated_tokens_per_s":
                             8 * batches * (L - plen) / wall,
                         "decode_kernel_launches": launches,
                         "flash_forward_launches": fwd}
        print(f"# gpt2 run.sample: {json.dumps(out['sample'])}", flush=True)

        # 2. gpt2_decode (dense cache) on batch 0: the flash forward runs
        # the prefill (12 launches); rows equal run.sample's or part at a
        # near-tie
        model, _, _ = sample_mod.load_run(run, device=torch.device("cuda"))
        batch0 = next(load_data_from_args(
            "valid", batch_size=8, dataset="synthetic-lm", seq_len=L,
            vocab_size=vocab, seed=0, deterministic=True))
        ids = torch.from_numpy(batch0["input_ids"]).cuda()
        check(batch0["input_ids"].tolist() == [r["gold"] for r in rows[:8]],
              "batch 0 is not run.sample's first batch")
        fa.reset_launch_counts()
        clocks("before gpt2_decode")
        t0 = time.perf_counter()
        with CallCount(fa, "torch_flash_forward") as plain:
            dense = gpt2_decode(model, ids, plen)
        torch.cuda.synchronize()
        dwall = time.perf_counter() - t0
        clocks(f"after gpt2_decode ({dwall:.1f} s)")
        fwd = fa.forward_launch_count()
        check(fwd == layers and plain.calls == 0,
              f"gpt2_decode: {fwd} flash forward launches (expected "
              f"{layers}, the prefill), plain {plain.calls}")
        same, gaps = row_gaps(torch, model, dense.tolist(),
                              [r["pred"] for r in rows[:8]], plen)
        out["gpt2_decode_bf16"] = {"identical_rows": same / 8,
                                   "first_divergence_gaps": gaps,
                                   "wall_s": dwall,
                                   "flash_forward_launches": fwd}
        print(f"# gpt2_decode bf16 against run.sample: "
              f"{json.dumps(out['gpt2_decode_bf16'])}", flush=True)
        check_near_ties(gaps, "gpt2_decode against run.sample (bf16)")

        # f32 compute: one_shot_decode (paged, the decode kernel) and
        # gpt2_decode (dense) from 960-token prompts give the same tokens;
        # both prefills run at L = 1024, so both take the flash forward
        m32 = create_model_from_config(**{**GPT2_BASE, "dtype": "float32"},
                                       device="cuda")
        m32.load_state_dict(model.state_dict())
        ids4 = batch0["input_ids"][:4]
        fd.reset_launch_count()
        fa.reset_launch_counts()
        paged = one_shot_decode(m32, ids4, 960, device="cuda")
        paged_fwd = fa.forward_launch_count()
        dense32 = gpt2_decode(m32, torch.from_numpy(ids4).cuda(), 960)
        torch.cuda.synchronize()
        same32, gaps32 = row_gaps(torch, m32, dense32.tolist(),
                                  paged.tolist(), 960)
        out["f32_identity"] = {
            "identical_rows": same32 / 4, "first_divergence_gaps": gaps32,
            "decode_kernel_launches": fd.launch_count(),
            "flash_forward_launches": {"one_shot_decode": paged_fwd,
                                       "gpt2_decode": fa.forward_launch_count()
                                       - paged_fwd}}
        print(f"# f32 one_shot_decode vs gpt2_decode: "
              f"{json.dumps(out['f32_identity'])}", flush=True)
        check(same32 == 4 and paged_fwd == layers
              and fa.forward_launch_count() == 2 * layers
              and fd.launch_count() == layers * (L - 960 - 1),
              f"f32: one_shot_decode and gpt2_decode differ, or took "
              f"another arm: {out['f32_identity']}")
        del m32
        torch.cuda.empty_cache()

        # 3. seeds on one reused graph server against fresh eager servers
        kw = dict(decode_slots=8, page_size=64, max_prompt_len=L, max_len=L,
                  prefill_batch=8, temperature=1.0, top_k=50, device="cuda")
        reused = DecodeServer(model, seed=7, **kw)
        streams = {}
        for seed in (0, 1):
            got = one_shot_decode(model, batch0["input_ids"], 960, seed=seed,
                                  server=reused)
            ref = one_shot_decode(model, batch0["input_ids"], 960,
                                  server=DecodeServer(model, seed=seed,
                                                      cuda_graphs=False,
                                                      **kw))
            check(np.array_equal(got, ref), f"seed {seed}: the reused "
                  f"graph server's streams differ from a fresh eager "
                  f"server's")
            streams[seed] = got
        check(not np.array_equal(streams[0], streams[1]),
              "seeds 0 and 1 gave the same streams")
        check(reused.engine.captures == {"prefill": 1, "decode": 1},
              f"captures {reused.engine.captures}")
        out["seeds"] = {"reused_equals_fresh": True, "captures":
                        reused.engine.captures,
                        "differing_tokens": int((streams[0]
                                                 != streams[1]).sum())}
        print(f"# reused graph server seeds: {json.dumps(out['seeds'])}",
              flush=True)
        del reused, model
        torch.cuda.empty_cache()

        # 4. EMA weights through run.sample and run.serve
        ema = sample_mod.main(["--checkpoint_path", run, "--batch_size",
                               "8", "--num_batches", "1", "--prompt_len",
                               "960", "--ema", "0.99"])
        check(ema["params"] == "ema_0.99" and 0.0 <= ema["decode_acc"] <= 1.0
              and math.isfinite(ema["eval_loss"]), f"run.sample --ema: {ema}")
        served = serve_mod.main([
            "--checkpoint_path", run, "--decode_slots", "4",
            "--max_prompt_len", "128", "--synthetic_requests", "4",
            "--max_new_tokens", "16", "--ema", "0.99"])
        check(served["requests"] == 4 and served["decode_tokens"] == 64
              and served["params"] == "ema_0.99",
              f"run.serve --ema: {served}")
        out["ema"] = {"sample": ema, "serve_params": served["params"],
                      "serve_decode_tokens": served["decode_tokens"]}
        torch.cuda.empty_cache()

        # 5. GPT-2 training with --eval_decode: the callback's prefill on
        # the flash forward
        out["eval_decode"] = clocked("gpt2 eval_decode train",
                                     eval_decode_train, torch, fa, fu,
                                     os.path.join(tmp, "eval_decode"))
        # 6. the native encoder and the tokenizer CLI
        out["native"] = native_phase(tmp)
    return out


def eval_decode_train(torch, fa, fu, run: str) -> dict:
    """``run.train --model_family gpt2 --eval_decode true``, 4 steps at
    batch 8 in microbatches of 4, an eval every 2: ``decode_acc`` in
    ``progress.csv``, and the flash forward launched by the training and
    eval passes plus 12 a callback (its dense-cache prefill)."""
    from distributed_pipeline_tpu_torch.run.train import main as train_main

    steps, every, layers, n_micro = 4, 2, GPT2_BASE["num_layers"], 2
    argv = ["--checkpoint_path", run, "--model_family", "gpt2",
            "--vocab_size", "50257", "--seq_len", "1024",
            "--hidden_size", "768", "--num_layers", "12", "--num_heads",
            "12", "--dtype", "bfloat16", "--dataset", "synthetic-lm",
            "--batch_size", "8", "--microbatch", "4", "--learning_steps",
            str(steps), "--lr", "3e-4", "--log_interval", "1",
            "--eval_interval", str(every), "--eval_decode", "true",
            "--save_interval", "0", "--seed", "1"]
    fa.reset_launch_counts()
    fu.reset_launch_count()
    t0 = time.perf_counter()
    loop = train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    evals = steps // every
    launches = {"flash_forward": fa.forward_launch_count(),
                "flash_backward": fa.backward_launch_count(),
                "fused_adamw_ema": fu.launch_count()}
    passes = layers * n_micro * (steps + evals)  # training + eval forwards
    check(launches == {"flash_forward": passes + layers * evals,
                       "flash_backward": layers * n_micro * steps,
                       "fused_adamw_ema": steps},
          f"eval_decode run: launches {launches}, expected forward "
          f"{passes} + {layers} x {evals} callbacks")
    with open(os.path.join(run, "progress.csv")) as f:
        head, *rows = [r.split(",") for r in f.read().splitlines()]
    col = head.index("decode_acc") if "decode_acc" in head else -1
    accs = [float(r[col]) for r in rows if col >= 0 and r[col]]
    check(accs and all(0.0 <= a <= 1.0 for a in accs),
          f"progress.csv decode_acc: {accs}")
    del loop
    torch.cuda.empty_cache()
    result = {"launches": launches, "callbacks": evals,
              "decode_acc": accs, "wall_s": wall}
    print(f"# gpt2 eval_decode: {json.dumps(result)}", flush=True)
    return result


def native_phase(tmp: str) -> dict:
    """The port's native library builds and loads; the native BPE encoder
    gives the Python path's ids over the 24,000 texts of a seeded
    synthetic corpus of 12,000 jsonl lines (host times of both printed);
    the tokenizer CLI writes ``bpe.json`` from it; the native jsonl index
    counts its lines."""
    import random
    from distributed_pipeline_tpu_torch import native
    from distributed_pipeline_tpu_torch.data.tokenizer import BPEVocab

    check(native.load_library() is not None,
          "the native library did not build or load")
    rng = random.Random(0)
    letters = "abcdefghijklmnopqrstuvwxyzéüß日本"
    words = ["".join(rng.choice(letters) for _ in range(rng.randrange(2, 9)))
             for _ in range(3000)]
    weights = [1.0 / (i + 1) for i in range(len(words))]
    texts = [" ".join(rng.choices(words, weights, k=rng.randrange(4, 16)))
             for _ in range(24000)]
    data = os.path.join(tmp, "corpus")
    os.makedirs(data)
    with open(os.path.join(data, "train.jsonl"), "w") as f:
        for i in range(0, len(texts), 2):
            f.write(json.dumps({"src": texts[i], "trg": texts[i + 1]},
                               ensure_ascii=False) + "\n")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "distributed_pipeline_tpu_torch.data."
         "tokenizer", "--data_dir", data, "--vocab_size", "512"],
        capture_output=True, text=True, timeout=300, check=True)
    cli_s = time.perf_counter() - t0
    info = json.loads(cli.stdout.strip().splitlines()[-1])
    check(os.path.exists(os.path.join(data, "bpe.json"))
          and info["merges"] > 0, f"tokenizer CLI: {info}")
    fast = BPEVocab.load(os.path.join(data, "bpe.json"), 512)
    slow = BPEVocab.load(os.path.join(data, "bpe.json"), 512)
    slow._native = None
    check(fast._native is not None, "BPEVocab did not take the native "
          "encoder")
    t0 = time.perf_counter()
    got = [fast.encode(t) for t in texts]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = [slow.encode(t) for t in texts]
    python_s = time.perf_counter() - t0
    check(got == ref, "native and Python BPE ids differ")
    index = native.NativeJsonlIndex(os.path.join(data, "train.jsonl"))
    check(len(index) == len(texts) // 2, f"jsonl index: {len(index)} lines")
    result = {"texts": len(texts), "jsonl_lines": len(index),
              "tokens": sum(map(len, got)),
              "native_encode_s": native_s, "python_encode_s": python_s,
              "cli_s": cli_s, "cli": info}
    print(f"# native BPE (host times): {json.dumps(result)}", flush=True)
    return result


# ----------------------------------------------------------------- fleet

class _Stream:
    """One request's stream as ``divergence_gaps`` reads it."""

    def __init__(self, rid: int, prompt, tokens) -> None:
        self.id, self.prompt, self.tokens = rid, list(prompt), list(tokens)


def fleet_argv(run: str, requests: int, rate: float, fleet_dir: str,
               out: str, *extra) -> list:
    """run.serve's flags for a phase 11 fleet run: the serve workload's
    geometry (``serve_argv``: 32 slots a replica, pages of 16, 256-token
    prompts padded to 512, 128 new tokens, greedy, bf16 pool, graph
    engine) on the train phase's step 20, 2 replicas, poisson arrivals."""
    return serve_argv(run, "fp", requests) + [
        "--step", "20", "--traffic", "poisson", "--rate_rps", str(rate),
        "--replicas", "2", "--fleet_dir", fleet_dir, "--out", out,
        "--fleet_deadline_s", "240", *extra]


def worker_log_tails(root: str, lines: int = 12) -> None:
    """The last lines of every replica worker's log under ``root``."""
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.startswith("worker_") and name.endswith(".log"):
                path = os.path.join(dirpath, name)
                with open(path, errors="replace") as f:
                    tail = f.read().splitlines()[-lines:]
                print(f"# fleet log {path}:", *tail, sep="\n#   ",
                      flush=True)


def fleet_sidecars(fleet_dir: str) -> dict:
    """replica id -> its clean-exit sidecars (attempt -> record), and
    replica id -> its attempt records."""
    from distributed_pipeline_tpu_torch.chaos import goodput
    cars, attempts = {}, {}
    for rdir in goodput.list_replica_dirs(fleet_dir):
        rid = goodput.replica_id(rdir)
        cars[rid] = goodput.read_serving_records(rdir)
        attempts[rid] = goodput.read_attempts(rdir)
    return {"sidecars": cars, "attempts": attempts}


def check_replicas(fleet_dir: str, what: str) -> dict:
    """Every replica's last clean exit: the decode kernel launched (> 0
    times after warm-up), the plain decode version never called, on the
    card; returns replica -> (launches, peak device memory in bytes)."""
    got = fleet_sidecars(fleet_dir)
    out = {}
    for rid, cars in sorted(got["sidecars"].items()):
        check(bool(cars), f"{what}: replica {rid} wrote no clean-exit "
              f"sidecar (attempts {got['attempts'].get(rid)})")
        last = cars[max(cars)]
        check(last.get("decode_kernel_launches", 0) > 0
              and last.get("plain_decode_calls") == 0
              and last.get("device", "cpu") != "cpu",
              f"{what}: replica {rid}'s sidecar {last}")
        out[rid] = {"launches": last["decode_kernel_launches"],
                    "peak_memory_bytes": last.get("peak_memory_bytes"),
                    "attempts": len(got["attempts"].get(rid, []))}
    return out


def served_window_rate(fleet_dir: str, tokens: int) -> float:
    """Tokens over the window from the router's first placement to its
    last completion (the journal's stamps): the fleet's rate without the
    replicas' start-up, during which arrivals queue."""
    from distributed_pipeline_tpu_torch.chaos import goodput
    ev = goodput.read_journal(goodput.serving_journal_path(fleet_dir))
    t0 = min(e["t"] for e in ev if e["ev"] == "assign")
    t1 = max(e["t"] for e in ev if e["ev"] == "complete")
    return tokens / max(t1 - t0, 1e-9)


SERVE_MODULE = "distributed_pipeline_tpu_torch.run.serve"


def fleet_start(argv: list) -> dict:
    """Start one fleet run, ``python -m ...run.serve argv``, as a
    subprocess (the fleet parent is torch-free; its replicas hold the
    card), so fleet runs go side by side; ``fleet_finish`` reads it."""
    job = dp_start(argv, module=SERVE_MODULE)
    job["argv"] = argv
    return job


def fleet_finish(job: dict, n: int, what: str) -> tuple:
    """A ``fleet_start`` run's summary (the parent's last stdout line) and
    its ``--out`` rows, every request completed, every replica's exit
    code 0."""
    stdout, _stderr, wall = dp_wait(job, what)
    argv = job["argv"]
    summary = json.loads([line for line in stdout.splitlines()
                          if line.startswith("{")][-1])
    out = argv[argv.index("--out") + 1]
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    check(summary["mode"] == "fleet" and summary["completed"] == n
          and summary["dropped"] == 0 and not summary["deadline_hit"]
          and len(rows) == n,
          f"{what}: {summary['completed']}/{n} completed: {summary}")
    check(all(rc == 0 for rc in summary["replica_rcs"]),
          f"{what}: replica exit codes {summary['replica_rcs']}")
    for r in rows:
        check(len(r["tokens"]) == 128, f"{what}: request {r['id']} "
              f"returned {len(r['tokens'])} tokens")
    print(f"# fleet {what} (side by side: contended): {wall:.1f} s, "
          f"{json.dumps(summary)}", flush=True)
    return summary, rows


def hold_streams(torch, model, rows, refs, what: str) -> dict:
    """The fleet's streams against the single server's (the same prompts
    in the same order): equal, or parting at a bf16 near-tie
    (``check_near_ties``)."""
    for r, ref in zip(rows, refs):
        check(list(r["prompt"]) == list(ref.prompt),
              f"{what}: request {r['id']}'s prompt is not the single "
              f"run's")
    same, gaps = divergence_gaps(
        torch, model, [_Stream(r["id"], r["prompt"], r["tokens"])
                       for r in rows], [list(q.tokens) for q in refs])
    check_near_ties(gaps, what)
    return {"identical_streams": same / len(rows),
            "first_divergence_gaps": gaps}


def perturbed_checkpoint(torch, run: str, step: int, seed: int) -> str:
    """A second finalized checkpoint: step 20's weights plus seeded noise
    (std 0.02, GPT-2's init scale) on every matrix, saved as ``step`` with
    the port's own ``save_run``."""
    from distributed_pipeline_tpu_torch.utils.checkpoint import save_run
    sd = torch.load(os.path.join(run, "model_000020.pt"), map_location="cpu",
                    weights_only=True)
    g = torch.Generator().manual_seed(seed)
    for key, t in sd.items():
        if t.ndim >= 2:
            noise = torch.randn(t.shape, generator=g) * 0.02
            sd[key] = (t.float() + noise).to(t.dtype)
    with open(os.path.join(run, "training_args.json")) as f:
        targs = json.load(f)
    return save_run(run, targs, sd, step)


def fleet_phase(torch, fd, run: str, keep: str) -> dict:
    """Phase 11 on the train phase's run dir (GPT-2 base, step 20): the
    serving fleet through ``run.serve --replicas 2`` against the
    single-replica ``run.serve``; a replica killed mid-request; a hot swap
    to a second checkpoint and a corrupted one; the socket transport; and
    ``--replicas 1 --disagg 1`` against the colocated server. The kill
    run's fleet dir is copied into ``keep`` for the readers' phase."""
    import numpy as np
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.run import serve as serve_mod
    from distributed_pipeline_tpu_torch.run.sample import load_run

    n = 64
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            return _fleet_checks(torch, fd, np, parse_settings, serve_mod,
                                 load_run, run, tmp, n, out, keep)
        except BaseException:
            worker_log_tails(tmp)
            raise


def _fleet_checks(torch, fd, np, parse_settings, serve_mod, load_run, run,
                  tmp, n, out, keep) -> dict:
    def paths(tag):
        return os.path.join(tmp, tag), os.path.join(tmp, f"{tag}.jsonl")

    # the single-replica reference: the same flags, one server in process.
    # At 2.5 requests/s the 64 arrivals span ~26 s, about twice the
    # slowest replica start-up seen on the card (6.5-13 s to the first
    # beacon, host-dependent): requests that arrive before the first
    # replica is ready all go to it, so later arrivals are what the second
    # replica serves.
    rate = 2.5
    t0 = time.perf_counter()
    single_argv = serve_argv(run, "fp", n) + [
        "--step", "20", "--traffic", "poisson", "--rate_rps", str(rate)]
    fd.reset_launch_count()
    single, server, refs = serve_mod.serve(parse_settings(single_argv))
    check(single["decode_kernel_launches"] > 0
          and fd.plain_call_count() == 0,
          f"single run: {single['decode_kernel_launches']} decode kernel "
          f"launches, {fd.plain_call_count()} plain calls")
    del server
    torch.cuda.empty_cache()
    model, _, _ = load_run(run, 20, torch.device("cuda"))
    out["single"] = {k: single[k] for k in (
        "decode_tokens_per_s_per_chip", "ttft_p50_s", "ttft_p95_s",
        "wall_s", "decode_kernel_launches")}
    print(f"# fleet: single-replica reference in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(out['single'])}",
          flush=True)

    def start(tag, *extra, requests=n):
        fdir, jsonl = paths(tag)
        return fleet_start(fleet_argv(run, requests, rate, fdir, jsonl,
                                      *extra))

    def one(job, tag, requests=n):
        fdir, _jsonl = paths(tag)
        summary, rows = fleet_finish(job, requests, tag)
        rec = {"decode_tokens_per_s": summary["decode_tokens_per_s"],
               "served_window_tokens_per_s": served_window_rate(
                   fdir, summary["decode_tokens"]),
               "ttft_p50_s": summary["ttft_p50_s"],
               "ttft_p95_s": summary["ttft_p95_s"],
               "wall_s": summary["wall_s"], "replayed": summary["replayed"],
               "serving_goodput": summary["serving_goodput"],
               "replicas": check_replicas(fdir, tag)}
        return summary, rows, rec, fdir

    # the runs go side by side in two groups (their walls, rates and
    # TTFTs share the card and the host: contended): 1, 2 and 5, then 3
    # and 4 (which read the checkpoints written between the groups)
    t_a = time.perf_counter()
    plan = json.dumps({"faults": [{"kind": "kill_replica", "step": 4,
                                   "rank": 1, "sig": "SIGKILL"}]})
    k = 16
    dfdir, djsonl = paths("disagg")
    dargv = serve_argv(run, "fp", k) + [
        "--step", "20", "--traffic", "poisson", "--rate_rps", str(rate),
        "--replicas", "1", "--disagg", "1", "--fleet_dir", dfdir,
        "--out", djsonl, "--fleet_deadline_s", "240"]
    first = {"file": start("file"),
             "kill": start("kill", "--chaos_plan", plan),
             "disagg": fleet_start(dargv)}

    # 1. two replicas, no fault
    summary, rows, rec, _ = one(first["file"], "file")
    rec.update(hold_streams(torch, model, rows, refs, "fleet file"))
    out["file"] = rec

    # 2. a replica killed while it holds requests
    summary, rows, rec, fdir = one(first["kill"], "kill")
    check(summary["replayed"] >= 1, f"kill: nothing replayed: {summary}")
    check(rec["replicas"][1]["attempts"] >= 2,
          f"kill: replica 1's attempts.jsonl: {rec['replicas'][1]}")
    rec.update(hold_streams(torch, model, rows, refs, "fleet kill"))
    out["kill"] = rec
    out["kept_dir"] = os.path.join(keep, "fleet_kill")
    shutil.copytree(fdir, out["kept_dir"])
    out["kept_counts"] = {"completed": summary["completed"],
                          "replayed": summary["replayed"]}

    # 5. --replicas 1 --disagg 1, 16 requests, against the colocated run
    summary, rows = fleet_finish(first["disagg"], k, "disagg")
    check(summary.get("decode_rcs") == [0], f"disagg: {summary}")
    dec = check_replicas(os.path.join(dfdir, "decode"), "disagg decode")
    rec = {"decode_tokens_per_s": summary["decode_tokens_per_s"],
           "ttft_p50_s": summary["ttft_p50_s"],
           "ttft_p95_s": summary["ttft_p95_s"], "wall_s": summary["wall_s"],
           "decode_worker": dec[0]}
    # the colocated streams: the single run's first 16 requests (the
    # generator draws prompts in order, whatever the request count)
    rec.update(hold_streams(torch, model, rows, refs[:k], "fleet disagg"))
    out["disagg"] = rec
    out["group_walls_s"] = [time.perf_counter() - t_a]

    # 3. a hot swap to step 21 after 32 completions (arrivals keep coming
    # after the roll), and 4. a corrupted swap target (a copy of step 21
    # as step 22) over the socket transport
    t_ck = time.perf_counter()
    perturbed_checkpoint(torch, run, 21, seed=5)
    shutil.copy(os.path.join(run, "model_000021.pt"),
                os.path.join(run, "model_000022.pt"))
    print(f"# fleet: wrote the perturbed step 21 (and its copy as 22) in "
          f"{time.perf_counter() - t_ck:.1f} s", flush=True)
    t_b = time.perf_counter()
    plan = json.dumps({"faults": [{"kind": "corrupt_swap_checkpoint",
                                   "step": 0}]})
    second = {"swap": start("swap", "--swap_after_requests", "32",
                            "--swap_step", "21"),
              "corrupt": start("corrupt", "--swap_after_requests", "32",
                               "--swap_step", "22", "--chaos_plan", plan,
                               "--serve_transport", "socket")}
    summary, rows, rec, fdir = one(second["swap"], "swap")
    sw = summary["swap"]
    check(sw and sw["ok"] and sorted(sw["swapped"]) == [0, 1],
          f"swap: {sw}")
    windows = sorted(tuple(w) for w in sw["windows"].values())
    for (s0, e0), (s1, _e1) in zip(windows, windows[1:]):
        check(e0 is not None and e0 <= s1 + 1e-6,
              f"swap: two replicas out of service at once: {windows}")
    old = [r for r in rows if r["params_step"] == 20]
    new = [r for r in rows if r["params_step"] == 21]
    check(len(new) >= 1 and len(old) + len(new) == n,
          f"swap: {len(old)} requests at step 20, {len(new)} at 21")
    by_prompt = {tuple(q.prompt): q for q in refs}
    rec.update(hold_streams(torch, model, old,
                            [by_prompt[tuple(r["prompt"])] for r in old],
                            "fleet swap (step 20)"))
    m21, _, _ = load_run(run, 21, torch.device("cuda"))
    from distributed_pipeline_tpu_torch.serving.scheduler import \
        DecodeServer
    fresh = DecodeServer(m21, decode_slots=32, page_size=16,
                         max_prompt_len=512, decode_span=4, dispatch_lag=2,
                         device="cuda")
    refs21 = [fresh.submit(np.asarray(r["prompt"], np.int32), 128)
              for r in new]
    fresh.drain()
    del fresh
    held = hold_streams(torch, m21, new, refs21, "fleet swap (step 21)")
    moved = sum(r["tokens"] != by_prompt[tuple(r["prompt"])].tokens
                for r in new)
    check(moved >= 1, "swap: every step-21 stream equals its step-20 "
          "stream: the new weights did not reach the replicas")
    rec.update({"swap": {"ok": sw["ok"], "swapped": sw["swapped"],
                         "windows": sw["windows"]},
                "requests_step20": len(old), "requests_step21": len(new),
                "step21_streams_differing_from_step20": moved,
                "step21": held})
    del m21
    out["swap"] = rec

    # 4. the canary refuses the corrupted target, no replica moves, the
    # old weights serve on (one fleet run holds both runs' checks: the
    # socket transport's, and the refused swap's)
    summary, rows, rec, _ = one(second["corrupt"], "corrupt")
    check(summary["transport"] == "socket", f"socket: {summary}")
    sw = summary["swap"]
    check(sw and not sw["ok"] and sw["swapped"] == [] and sw["injected"]
          and "refused" in sw["error"], f"corrupt swap: {sw}")
    check(all(r["params_step"] == 20 for r in rows),
          "corrupt swap: a request was served off step 20")
    rec.update(hold_streams(torch, model, rows, refs, "fleet corrupt"))
    rec["swap"] = {"ok": sw["ok"], "swapped": sw["swapped"],
                   "error": sw["error"][:200]}
    out["corrupt_swap"] = out["socket"] = rec
    out["group_walls_s"].append(time.perf_counter() - t_b)
    out["contended"] = ["file", "kill", "disagg", "swap", "corrupt_swap"]
    del model
    torch.cuda.empty_cache()
    print(f"# fleet vs single (tokens/s, TTFT p50/p95 s): single "
          f"{out['single']['decode_tokens_per_s_per_chip']} "
          f"{out['single']['ttft_p50_s']}/{out['single']['ttft_p95_s']}; "
          f"fleet {out['file']['decode_tokens_per_s']} (served window "
          f"{out['file']['served_window_tokens_per_s']:.1f}) "
          f"{out['file']['ttft_p50_s']}/{out['file']['ttft_p95_s']}",
          flush=True)
    for tag in ("file", "kill", "swap", "corrupt_swap"):
        print(f"# fleet {tag} ({CARD}): replicas' launches, peak device "
              f"memory, attempts {json.dumps(out[tag]['replicas'])}",
              flush=True)
    return out


# ------------------------------------------------------- data parallel

DP_STEPS = 5
# the phase's wall budget: three run.train processes of GPT-2 base (start,
# 5 steps, the final save); 80 s measured on the H100
DP_BUDGET_S = 240.0


def dp_argv(run: str, batch: int, micro: int) -> list:
    return ["--checkpoint_path", run, "--model_family", "gpt2",
            "--model_size", "base", "--vocab_size", "50257",
            "--seq_len", "1024", "--hidden_size", "768",
            "--num_layers", "12", "--num_heads", "12",
            "--dtype", "bfloat16", "--dataset", "synthetic-lm",
            "--batch_size", str(batch), "--microbatch", str(micro),
            "--learning_steps", str(DP_STEPS), "--lr", "3e-4",
            "--ema_rate", "0.5,0.9,0.99", "--attention_impl", "auto",
            "--fused_update", "auto", "--log_interval", "1",
            "--save_interval", "0", "--seed", "0"]


# every run.train started, killed at exit if a failed check left it running
_JOBS: list = []


@atexit.register
def _kill_jobs() -> None:
    for proc in _JOBS:
        if proc.poll() is None:
            proc.kill()


def dp_start(argv: list, extra_env=None,
             module: str = "distributed_pipeline_tpu_torch.run.train"
             ) -> dict:
    """Start ``python -m <module> argv`` (``run.train`` by default) as a
    subprocess (``extra_env`` added to its environment), drained by a
    thread that notes when it ended (at most 600 s), so runs side by side
    each get their own wall; ``dp_finish`` waits for it."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
        "LOCAL_WORLD_SIZE", "DPT_DIST_AUTORUN", "DPT_RUN_TIMESTAMP",
        "DPT_MPMD_KILL")}
    env.update(extra_env or {})
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = repo
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *argv], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    job = {"proc": proc, "t0": time.perf_counter()}
    _JOBS.append(proc)

    def drain():
        try:
            job["out"] = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            job["out"] = proc.communicate()
        job["t1"] = time.perf_counter()
    job["thread"] = threading.Thread(target=drain, daemon=True)
    job["thread"].start()
    return job


def dp_wait(job: dict, what: str) -> tuple:
    """Wait for a ``dp_start`` run: ``(stdout, stderr, wall)``; fails
    the phase when it exited with another code than 0."""
    job["thread"].join()
    proc = job["proc"]
    stdout, stderr = job["out"]
    if proc.returncode != 0:
        print(stdout[-4000:], stderr[-8000:], file=sys.stderr)
    check(proc.returncode == 0, f"{what}: {proc.args[2]} exited "
                                f"{proc.returncode}")
    return stdout, stderr, job["t1"] - job["t0"]


def dp_run(run: str, argv: list, what: str) -> dict:
    """``python -m distributed_pipeline_tpu_torch.run.train argv`` as a
    subprocess; returns its progress rows, its ranks' sidecars and rank
    0's per-step metrics (``steps``: the sidecar's history; a progress row
    holds the step ``dispatch_lag`` before it)."""
    return dp_finish(dp_start(argv), run, what)


def dp_finish(job: dict, run: str, what: str) -> dict:
    """Wait for a ``dp_start`` run and read it as ``dp_run`` does."""
    _stdout, _stderr, wall = dp_wait(job, what)
    with open(os.path.join(run, "progress.csv")) as f:
        lines = f.read().splitlines()
    head = lines[0].split(",")
    rows = [dict(zip(head, line.split(","))) for line in lines[1:]]
    sides = []
    for name in sorted(n for n in os.listdir(run)
                       if n.startswith("train_summary")):
        with open(os.path.join(run, name)) as f:
            sides.append(json.load(f))
    sides = sorted(sides, key=lambda d: d["rank"])
    return {"rows": rows, "ranks": sides, "steps": sides[0]["history"],
            "wall_s": wall}


def dp_phase(torch) -> dict:
    """Phase 12 (see the module doc)."""
    t0 = time.perf_counter()
    layers, micro_steps = GPT2_BASE["num_layers"], 2
    want = {"flash_forward": layers * micro_steps * DP_STEPS,
            "flash_backward": layers * micro_steps * DP_STEPS,
            "fused_adamw_ema": DP_STEPS}
    runs = {}
    with tempfile.TemporaryDirectory() as work:
        # the run without a group alone (its step time is the one read),
        # then its bitwise twin beside the two ranks: their step and
        # all-reduce seconds share the card and the host (contended)
        run = os.path.join(work, "single")
        runs["single"] = dp_run(run, dp_argv(run, 8, 4), "single")
        started = {}
        for key, extra, batch, micro in (
                ("nprocs1", ["--distributed", "--nprocs", "1"], 8, 4),
                ("nprocs2", ["--distributed", "--nprocs", "2"], 4, 2)):
            run = os.path.join(work, key)
            started[key] = (dp_start(extra + dp_argv(run, batch, micro)),
                            run)
        for key, (job, run) in started.items():
            runs[key] = dp_finish(job, run, key)
    out = {"steps": DP_STEPS, "wall_s": {k: r["wall_s"]
                                         for k, r in runs.items()},
           "contended": ["nprocs1", "nprocs2"]}
    for key, r in runs.items():
        check(len(r["rows"]) == DP_STEPS
              and [h["step"] for h in r["steps"]]
              == list(range(1, DP_STEPS + 1)),
              f"{key}: {len(r['rows'])} rows, steps "
              f"{[h['step'] for h in r['steps']]}")
        world = 2 if key == "nprocs2" else 1
        check(len(r["ranks"]) == world, f"{key}: {len(r['ranks'])} "
                                        f"sidecars, expected {world}")
        for side in r["ranks"]:
            check(side["launches"] == want,
                  f"{key} rank {side['rank']}: launches "
                  f"{side['launches']}, expected {want}")
            check(not any(side["plain_calls"].values()),
                  f"{key} rank {side['rank']}: plain calls "
                  f"{side['plain_calls']}")
            check(side["device"].startswith("cuda"),
                  f"{key} rank {side['rank']} on {side['device']}")
            print(f"# data parallel {key} rank {side['rank']}/"
                  f"{side['world_size']} "
                  f"({'alone' if key == 'single' else 'contended'}): "
                  f"backend {side['backend']}, "
                  f"device {side['device']}, launches {side['launches']}, "
                  f"plain {side['plain_calls']}, all-reduce "
                  f"{side['allreduce_s_per_step']:.6f} s a step over "
                  f"{side['allreduce_calls']} calls, step "
                  f"{side.get('step_time_s', 0.0):.6f} s, "
                  f"{side.get('tokens_per_sec', 0.0):.1f} tokens/s "
                  f"(global batch), peak memory "
                  f"{side['peak_memory_bytes']} B", flush=True)
        out[key] = {
            "losses": [h["loss"] for h in r["steps"]],
            "grad_norms": [h["grad_norm"] for h in r["steps"]],
            "ranks": [{k: side.get(k) for k in (
                "rank", "backend", "device", "launches", "plain_calls",
                "allreduce_s_per_step", "allreduce_calls", "step_time_s",
                "tokens_per_sec", "tokens_per_sec_per_chip", "mfu",
                "peak_memory_bytes", "params_sha256", "footprint")}
                for side in r["ranks"]]}
    single, one, two = (runs[k] for k in ("single", "nprocs1", "nprocs2"))
    check(one["ranks"][0]["backend"] == "nccl",
          f"--nprocs 1 took {one['ranks'][0]['backend']}")
    check([s["backend"] for s in two["ranks"]] == ["gloo", "gloo"]
          and [s["device"] for s in two["ranks"]] == ["cuda:0", "cuda:0"],
          f"--nprocs 2 ranks: {two['ranks']}")
    check(single["ranks"][0]["backend"] == "none",
          "the run without --distributed joined a group")
    # (a) bitwise
    for col in ("loss", "grad_norm"):
        a = [h[col] for h in one["steps"]]
        b = [h[col] for h in single["steps"]]
        check(a == b, f"--nprocs 1 {col} {a} differ from the run without "
                      f"a group {b}")
    check(one["ranks"][0]["params_sha256"]
          == single["ranks"][0]["params_sha256"],
          "--nprocs 1 final parameters differ from the run without a group")
    # (b): the ranks agree bitwise, and match (a) within bf16 rounding
    check(two["ranks"][0]["params_sha256"] == two["ranks"][1]["params_sha256"],
          "the two ranks' final parameters differ")
    rel = {}
    for col, bar in (("loss", 5e-3), ("grad_norm", 3e-2)):
        a = [h[col] for h in one["steps"]]
        b = [h[col] for h in two["steps"]]
        rel[col] = max(abs(x - y) / abs(x) for x, y in zip(a, b))
        check(rel[col] <= bar, f"--nprocs 2 {col} {b} vs one rank {a}: "
                               f"relative {rel[col]} > {bar}")
    out["nprocs2_vs_nprocs1_max_rel"] = rel
    out["phase_s"] = time.perf_counter() - t0
    print(f"# data parallel: --nprocs 1 bitwise the run without a group "
          f"(losses, grad norms, parameters); --nprocs 2 against it, "
          f"largest relative difference {rel}; walls {out['wall_s']} "
          f"(single alone, then nprocs1 beside nprocs2: contended); "
          f"phase {out['phase_s']:.1f} s of its {DP_BUDGET_S:.0f} s budget",
          flush=True)
    check(out["phase_s"] <= DP_BUDGET_S,
          f"phase 12 took {out['phase_s']:.1f} s, over {DP_BUDGET_S} s")
    return out


# ------------------------------------------------- MoE and remat (phase 13)

MOE8 = dict(moe_experts=8, moe_top_k=2, moe_every=2,
            moe_capacity_factor=1.25)
GPT2_MOE8 = dict(GPT2_BASE, **MOE8)
DIFFUSEQ_MOE8 = dict(DIFFUSEQ_BASE, **MOE8)
DIFFUSEQ_LARGE_512 = dict(DIFFUSEQ_BASE, model_size="large", seq_len=512,
                          hidden_size=1024, num_layers=24, num_heads=16)
MOE_STEPS = 5
# the phase's wall budget: 5 run.train calls (two of GPT-2 base moe8, one
# of DiffuSeq-base moe8, two of DiffuSeq-large at seq 512), the one-step
# arms, two run.serve passes and run.sample
MOE_BUDGET_S = 240.0


def cfg_argv(cfg: dict) -> list:
    """run.train's model flags for a configuration dict."""
    argv = []
    for key in ("model_family", "model_size", "vocab_size", "seq_len",
                "hidden_size", "num_layers", "num_heads", "dtype",
                "moe_experts", "moe_top_k", "moe_every",
                "moe_capacity_factor", "diffusion_steps", "noise_schedule"):
        if key in cfg:
            argv += [f"--{key}", str(cfg[key])]
    return argv


def moe_train(torch, fa, fu, run: str, cfg: dict, extra: list, *,
              steps: int, batch: int, micro: int, what: str) -> dict:
    """``run.train`` in this process into ``run``: the step metrics, the
    kernels' launches and the plain versions' calls, the last log
    window's gauges with ``mfu_active`` (the JAX bench's convention: the
    FLOPs of the parameters a token runs through), the run's peak device
    memory above what was allocated when it began, and the final
    parameters' SHA-256."""
    import hashlib
    from distributed_pipeline_tpu_torch.run.train import main as train_main
    from distributed_pipeline_tpu_torch.utils.perf import (
        card_rates, transformer_train_flops_per_token)

    argv = moe_train_argv(run, cfg, steps, batch, micro, extra)
    fa.reset_launch_counts()
    fu.reset_launch_count()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loop = train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the run's own peak: above what earlier phases still hold
    peak = torch.cuda.max_memory_allocated() - start
    launches = {"flash_forward": fa.forward_launch_count(),
                "flash_backward": fa.backward_launch_count(),
                "fused_adamw_ema": fu.launch_count()}
    plain = {**{f"flash_{k}": v for k, v in fa.plain_call_counts().items()},
             "fused_adamw_ema": fu.plain_call_count()}
    hist = loop.history
    check(len(hist) == steps, f"{what}: {len(hist)} logged steps")
    for key in ("loss", "grad_norm") + (("moe_aux",) if cfg.get(
            "moe_experts") else ()):
        vals = [h[key] for h in hist]
        check(all(math.isfinite(v) for v in vals),
              f"{what}: {key} not finite: {vals}")
    with open(os.path.join(run, "progress.csv")) as f:
        rows = f.read().splitlines()
    last = dict(zip(rows[0].split(","), rows[-1].split(",")))
    gauges = {k: float(last[k]) for k in
              ("tokens_per_sec_per_chip", "mfu", "step_time_s")}
    peak_flops = card_rates(torch.cuda.get_device_name(0))[1]
    gauges["mfu_active"] = (gauges["tokens_per_sec_per_chip"]
                            * transformer_train_flops_per_token(
                                loop.n_active_params, cfg["num_layers"],
                                cfg["hidden_size"], cfg["seq_len"])
                            / peak_flops)
    out = {"steps": steps, "batch": batch, "microbatch": micro,
           "remat": bool(loop.model.remat),
           "n_params": loop.n_params,
           "n_active_params": loop.n_active_params,
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "moe_aux": [h.get("moe_aux") for h in hist],
           "launches": launches, "plain_calls": plain, **gauges,
           "peak_memory_bytes": peak, "memory_at_start_bytes": start,
           "wall_s": wall,
           "params_sha256": hashlib.sha256(
               loop.params.cpu().numpy().tobytes()).hexdigest()}
    print(f"# moe/remat {what} ({CARD}): " + json.dumps(
        {k: v for k, v in out.items() if k not in ("grad_norms",)}),
        flush=True)
    check(not any(plain.values()), f"{what}: plain versions called {plain}")
    del loop
    torch.cuda.empty_cache()
    return out


def moe_train_start(run: str, cfg: dict, extra: list, *, steps: int,
                    batch: int, micro: int) -> dict:
    """``moe_train``'s run as a process of its own (``run.train``), so it
    goes beside this process's runs; ``moe_train_finish`` reads it."""
    job = dp_start(moe_train_argv(run, cfg, steps, batch, micro, extra))
    job.update(run=run, cfg=cfg, steps=steps, batch=batch, micro=micro,
               remat="--remat" in extra)
    return job


def moe_train_finish(torch, job: dict, what: str) -> dict:
    """A ``moe_train_start`` run read into ``moe_train``'s record, from
    its sidecar and its last progress row: its process's peak device
    memory is the run's own (``memory_at_start_bytes`` 0)."""
    from distributed_pipeline_tpu_torch.utils.perf import (
        card_rates, transformer_train_flops_per_token)
    r = dp_finish(job, job["run"], what)
    side, cfg, steps = r["ranks"][0], job["cfg"], job["steps"]
    hist = r["steps"]
    check(len(hist) == steps, f"{what}: {len(hist)} logged steps")
    for key in ("loss", "grad_norm") + (("moe_aux",) if cfg.get(
            "moe_experts") else ()):
        vals = [h[key] for h in hist]
        check(all(math.isfinite(v) for v in vals),
              f"{what}: {key} not finite: {vals}")
    last = r["rows"][-1]
    gauges = {k: float(last[k]) for k in
              ("tokens_per_sec_per_chip", "mfu", "step_time_s")}
    peak_flops = card_rates(torch.cuda.get_device_name(0))[1]
    gauges["mfu_active"] = (gauges["tokens_per_sec_per_chip"]
                            * transformer_train_flops_per_token(
                                side["n_active_params"], cfg["num_layers"],
                                cfg["hidden_size"], cfg["seq_len"])
                            / peak_flops)
    out = {"steps": steps, "batch": job["batch"],
           "microbatch": job["micro"], "remat": job["remat"],
           "n_params": side["n_params"],
           "n_active_params": side["n_active_params"],
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "moe_aux": [h.get("moe_aux") for h in hist],
           "launches": side["launches"], "plain_calls": side["plain_calls"],
           **gauges, "peak_memory_bytes": side["peak_memory_bytes"],
           "memory_at_start_bytes": 0, "wall_s": r["wall_s"],
           "params_sha256": side["params_sha256"]}
    print(f"# moe/remat {what} (its own process, contended) ({CARD}): "
          + json.dumps({k: v for k, v in out.items()
                        if k not in ("grad_norms",)}), flush=True)
    check(not any(out["plain_calls"].values()),
          f"{what}: plain versions called {out['plain_calls']}")
    return out


def remat_pair(a: dict, b: dict, what: str) -> dict:
    """The run with remat ``b`` against the run without ``a``: losses, grad
    norms, aux and final parameters bitwise equal, peak memory lower."""
    for key in ("losses", "grad_norms", "moe_aux", "params_sha256"):
        check(a[key] == b[key], f"{what}: remat {key} {b[key]} differ "
                                f"from no remat {a[key]}")
    check(b["peak_memory_bytes"] < a["peak_memory_bytes"],
          f"{what}: peak memory with remat {b['peak_memory_bytes']} not "
          f"below {a['peak_memory_bytes']}")
    out = {"bitwise_equal": True,
           "peak_memory_bytes": [a["peak_memory_bytes"],
                                 b["peak_memory_bytes"]],
           "step_time_s": [a["step_time_s"], b["step_time_s"]],
           "remat_step_overhead": b["step_time_s"] / a["step_time_s"] - 1}
    print(f"# moe/remat {what}: remat bitwise the run without, "
          f"{json.dumps(out)}", flush=True)
    return out


def moe_serve(torch, fd, run: str) -> dict:
    """``run.serve`` on the GPT-2 moe8 run dir (bf16 pool, 32 slots, 16
    requests of 256 tokens, 64 new each, greedy) through the graph engine
    under ``--sanitize`` and through the eager engine: streams equal,
    0 recompiles, the decode kernel launched; the first 4 requests'
    streams against ``gpt2_decode`` on the same prompts (equal, or parting
    at a near-tie)."""
    from distributed_pipeline_tpu_torch.config.serve import parse_settings
    from distributed_pipeline_tpu_torch.models.sampling import gpt2_decode
    from distributed_pipeline_tpu_torch.run.serve import serve

    requests, new, plen = 16, 64, 256
    argv = ["--checkpoint_path", run, "--decode_slots", "32",
            "--page_size", "16", "--max_prompt_len", "512",
            "--synthetic_requests", str(requests),
            "--synthetic_prompt_len", str(plen),
            "--max_new_tokens", str(new), "--temperature", "0",
            "--decode_impl", "auto", "--kv_quant", "fp"]
    out = {}
    streams = {}
    for engine, graphs, extra in (("graph", True, ["--sanitize", "true"]),
                                  ("eager", False, [])):
        fd.reset_launch_count()
        summary, server, reqs = serve(parse_settings(argv + extra),
                                      cuda_graphs=graphs)
        check(len(reqs) == requests and all(
            len(r.tokens) == new for r in reqs),
            f"moe serve {engine}: a request lacks tokens")
        streams[engine] = [list(r.tokens) for r in reqs]
        out[engine] = {"decode_kernel_launches": fd.launch_count(),
                       **{k: summary.get(k) for k in (
                           "decode_tokens_per_s_per_chip", "ttft_p50_s",
                           "ttft_p95_s", "wall_s", "compile_time_s",
                           "recompile_count")}}
        check(fd.launch_count() > 0,
              f"moe serve {engine}: the decode kernel never launched")
        if engine == "graph":
            check(summary["recompile_count"] == 0,
                  f"moe serve: {summary['recompile_count']} recompiles")
            model = server.engine.model
            prompts = [list(r.prompt) for r in reqs[:4]]
        del server
        torch.cuda.empty_cache()
    differ = sum(a != b for a, b in zip(streams["graph"], streams["eager"]))
    check(differ == 0, f"moe serve: {differ} graph streams differ from "
                       f"the eager engine's")
    ids = torch.tensor([p + [0] * new for p in prompts], device="cuda")
    dec = gpt2_decode(model, ids, plen).tolist()
    refs = [p + s for p, s in zip(prompts, streams["graph"][:4])]
    same, gaps = row_gaps(torch, model, dec, refs, plen)
    check_near_ties(gaps, "moe serve vs gpt2_decode")
    out.update(identical_graph_eager=True, gpt2_decode_identical=same,
               gpt2_decode_rows=len(refs), gpt2_decode_gaps=gaps)
    print(f"# moe/remat serve ({CARD}): {json.dumps(out)}", flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def moe_remat_phase(torch, fa, fd, fu) -> dict:
    """Phase 13 (see the module doc)."""
    from distributed_pipeline_tpu_torch.run import sample as sample_mod

    t0 = time.perf_counter()
    layers = GPT2_MOE8["num_layers"]
    per_run = layers * 2 * MOE_STEPS
    out = {"contended": ["diffuseq_moe8", "diffuseq_large_seq512"]}
    with tempfile.TemporaryDirectory() as work:
        # the DiffuSeq runs in processes of their own, beside the GPT-2
        # runs in this one (their times share the card: contended)
        jobs = {"diffuseq_moe8": moe_train_start(
            os.path.join(work, "diffuseq_moe8"), DIFFUSEQ_MOE8, [],
            steps=20, batch=256, micro=64)}
        for key, extra in (("no_remat", []), ("remat", ["--remat", "true"])):
            jobs[key] = moe_train_start(
                os.path.join(work, f"dq_large_{key}"), DIFFUSEQ_LARGE_512,
                extra, steps=3, batch=128, micro=8)
        # phase 21 (d)'s one process: the stacked moe8 model (MoEScanBlocks)
        # with the flags of the named run below, read there
        run_scan = os.path.join(work, "gpt2_moe8_scan")
        job_scan = dp_start(moe_train_argv(run_scan, GPT2_MOE8, MOE_STEPS,
                                           8, 4, ["--scan_layers", "true"]))
        gpt2 = {}
        for key, extra in (("no_remat", []), ("remat", ["--remat", "true"])):
            run = os.path.join(work, f"gpt2_moe8_{key}")
            gpt2[key] = moe_train(torch, fa, fu, run, GPT2_MOE8, extra,
                                  steps=MOE_STEPS, batch=8, micro=4,
                                  what=f"gpt2 moe8 {key}")
            want = {"flash_forward": per_run * (2 if key == "remat" else 1),
                    "flash_backward": per_run,
                    "fused_adamw_ema": MOE_STEPS}
            check(gpt2[key]["launches"] == want,
                  f"gpt2 moe8 {key}: launches {gpt2[key]['launches']}, "
                  f"expected {want}")
        check(gpt2["no_remat"]["n_params"] == 322_574_592
              and gpt2["no_remat"]["n_active_params"] == 152_705_280,
              f"gpt2 moe8 parameters {gpt2['no_remat']['n_params']}, "
              f"active {gpt2['no_remat']['n_active_params']}")
        out["gpt2_moe8"] = {**gpt2, "remat_vs_no_remat": remat_pair(
            gpt2["no_remat"], gpt2["remat"], "gpt2 moe8")}
        out["gpt2_moe8"]["scan_run"] = dp_finish(job_scan, run_scan,
                                                 "gpt2 moe8 scan_layers")
        run = os.path.join(work, "gpt2_moe8_no_remat")
        argv = (["--checkpoint_path", run] + cfg_argv(GPT2_MOE8)
                + ["--learning_steps", str(MOE_STEPS), "--lr", "3e-4",
                   "--ema_rate", "0.9999"])
        out["gpt2_moe8"]["one_step"] = one_step_twice(
            torch, fa, fu, run, argv, cfg=GPT2_MOE8, step=MOE_STEPS)[
                "one_step"]
        out["serve"] = moe_serve(torch, fd, run)

        run = os.path.join(work, "diffuseq_moe8")
        dq = moe_train_finish(torch, jobs["diffuseq_moe8"],
                              "diffuseq-base moe8")
        check(dq["launches"] == {"flash_forward": 0, "flash_backward": 0,
                                 "fused_adamw_ema": 20},
              f"diffuseq moe8 launches {dq['launches']}")
        check(dq["n_params"] == 289_257_600
              and dq["n_active_params"] == 119_388_288,
              f"diffuseq moe8 parameters {dq['n_params']}, active "
              f"{dq['n_active_params']}")
        t1 = time.perf_counter()
        sampled = sample_mod.main(["--checkpoint_path", run,
                                   "--batch_size", "32", "--num_batches",
                                   "2", "--sample_steps", "20"])
        check(sampled["step"] == 20 and 0.0 <= sampled["decode_acc"] <= 1.0
              and math.isfinite(sampled["eval_loss"]),
              f"run.sample on the diffuseq moe8 run dir: {sampled}")
        out["diffuseq_moe8"] = {**dq, "sample": {
            **sampled, "wall_s": time.perf_counter() - t1}}

        large = {key: moe_train_finish(torch, jobs[key],
                                       f"diffuseq-large seq512 {key}")
                 for key in ("no_remat", "remat")}
        out["diffuseq_large_seq512"] = {**large, "remat_vs_no_remat":
                                        remat_pair(large["no_remat"],
                                                   large["remat"],
                                                   "diffuseq-large seq512")}
    out["phase_s"] = time.perf_counter() - t0
    print(f"# moe/remat: phase {out['phase_s']:.1f} s of its "
          f"{MOE_BUDGET_S:.0f} s budget", flush=True)
    check(out["phase_s"] <= MOE_BUDGET_S,
          f"phase 13 took {out['phase_s']:.1f} s, over {MOE_BUDGET_S} s")
    return out


# ------------------------------------- sequence parallelism (phase 14)

SP_DIFFUSEQ_STEPS = 3
DIFFUSEQ_BASE_1024 = dict(DIFFUSEQ_BASE, seq_len=1024)
# the phase's wall budget: the kernel checks and timings, one GPT-2 base
# run.train of two sequence ranks, two DiffuSeq-base seq-1024 runs
SP_BUDGET_S = 150.0
SP_FLAGS = ["--distributed", "--nprocs", "2", "--sequence", "2"]


def lse_check(torch, fa, B, H, L, Dh, dtype, causal, lens, seed) -> dict:
    """``flash_attention_lse`` on the kernels against the plain versions:
    ``(out, lse)``, and the backward of a random ``(g_out, g_lse)``
    through the autograd seam (the kernel backward's ``g_lse`` arm)
    against ``torch_flash_backward(..., g_lse)`` from the kernel's own out
    and lse, at the bars of ``flash_check``; a fully masked row must give
    out 0, a finite lse below NEG_INF / 2 and zero gradients, and the bars
    must fail a backward that drops ``g_lse``. Returns the errors."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn((B, H, L, Dh), generator=g, device=dev)
                     .to(dtype) for _ in range(4))
    g_lse = torch.randn((B, H, L), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_lse(*t, mask, causal, impl="cuda")
    torch.autograd.backward((out, lse), (dout, g_lse))
    torch.cuda.synchronize()
    out, lse = out.detach(), lse.detach()
    f = [x.float() for x in (q, k, v)]
    ref_out, ref_lse = fa.torch_flash_forward(*f, mask, causal)
    refs = fa.torch_flash_backward(*f, mask, causal, out.float(), lse,
                                   dout.float(), g_lse)
    if dtype == torch.float32:
        tol, tol_b = dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-4, atol=1e-4)
    else:
        tol = dict(rtol=8e-3, atol=1e-3 * float(ref_out.abs().max()))
        tol_b = None
    errs = {"out": close_enough(out, ref_out, **tol),
            "lse": close_enough(lse, ref_lse, rtol=1e-5, atol=1e-4)}
    for name, x, ref in zip(("dq", "dk", "dv"), t, refs):
        got, ref = x.grad.float(), ref.float()
        rel = float((got - ref).norm() / ref.norm().clamp_min(1e-30))
        errs[name + "_rel_fro"] = rel
        if tol_b is None:
            check(rel <= 1e-2 or float(ref.norm()) < 1e-3,
                  f"{name} with g_lse: relative Frobenius error {rel}")
        errs[name] = close_enough(got, ref, **(tol_b or dict(
            rtol=1e-2, atol=max(1e-2 * float(ref.abs().max()), 1e-4))))
    dropped = fa.flash_backward(q, k, v, mask, causal, out, lse, dout)
    errs["dq_rel_fro_if_g_lse_dropped"] = float(
        (dropped[0].float() - refs[0]).norm() / refs[0].norm())
    check(errs["dq_rel_fro_if_g_lse_dropped"] > 1e-2,
          f"the bars cannot tell a dropped g_lse: {errs}")
    for b in [b for b, n in enumerate(lens) if n == 0]:
        check(bool(torch.all(out[b] == 0))
              and bool(torch.all(torch.isfinite(lse[b])))
              and float(lse[b].max()) < fa.NEG_INF / 2
              and all(bool(torch.all(x.grad[b] == 0)) for x in t),
              "flash_attention_lse: a fully masked row is not out 0, a "
              "finite lse near NEG_INF and zero gradients")
    return errs


def graph_ms(fn, torch, flush, reps: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()`` call with a cold L2: CUDA events around
    replays of a CUDA graph of ``reps`` (flush, call) pairs, less a graph
    of the flushes alone. No host enqueue falls inside the window, and no
    profiler session is involved."""
    def per_body(body) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                body()
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (replays * reps)

    def both():
        flush.zero_()
        fn()

    return per_body(both) - per_body(flush.zero_)


def lse_timing(torch, fa, B, H, L, Dh) -> dict:
    """The bf16 backward with and without ``g_lse`` (causal, all-ones
    mask), device time (``graph_ms``) in turns (without, with, with,
    without)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(B + L)
    q, k, v, dout = (torch.randn((B, H, L, Dh), generator=g, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    g_lse = torch.randn((B, H, L), generator=g, device=dev)
    mask = torch.ones((B, L), dtype=torch.int32, device=dev)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    out, lse = fa.flash_forward(q, k, v, mask, True)
    fns = {"without": lambda: fa.flash_backward(q, k, v, mask, True, out,
                                                lse, dout),
           "with": lambda: fa.flash_backward(q, k, v, mask, True, out, lse,
                                             dout, g_lse)}
    runs = {name: [] for name in fns}
    for name in ("without", "with", "with", "without"):
        runs[name].append(graph_ms(fns[name], torch, flush))
    plain = time_ms(lambda: fa.torch_flash_backward(
        q, k, v, mask, True, out, lse, dout, g_lse), torch, flush, reps=10)
    return {"shape": [B, H, L, Dh], "ms_runs": runs,
            "ms": statistics.median(runs["with"]),
            "ms_without_g_lse": statistics.median(runs["without"]),
            "plain_ms": plain}


def sp_diffuseq_argv(run: str) -> list:
    return (["--checkpoint_path", run, "--dataset", "synthetic-seq2seq"]
            + cfg_argv(DIFFUSEQ_BASE_1024)
            + ["--batch_size", "8", "--microbatch", "4",
               "--learning_steps", str(SP_DIFFUSEQ_STEPS), "--lr", "3e-4",
               "--ema_rate", "0.9999", "--attention_impl", "auto",
               "--fused_update", "auto", "--log_interval", "1",
               "--save_interval", "0", "--seed", "0"])


def sp_ranks(r: dict, what: str, want: list) -> list:
    """Each rank's sidecar of a ``--sequence 2`` run, checked: gloo on
    ``cuda:0``, sequence index = rank, the launches ``want[rank]`` (the g_lse
    arm on every backward), no plain call; the two ranks' final
    parameters bitwise equal."""
    ranks = r["ranks"]
    check(len(ranks) == 2, f"{what}: {len(ranks)} sidecars")
    for side in ranks:
        i = side["rank"]
        check(side["backend"] == "gloo" and side["device"] == "cuda:0"
              and (side["data_index"], side["sequence_index"],
                   side["sequence"]) == (0, i, 2),
              f"{what} rank {i}: {side['backend']} {side['device']} "
              f"{side['data_index']}/{side['sequence_index']}")
        check(side["launches"] == want[i]
              and side["lse_backward_launches"]
              == want[i]["flash_backward"],
              f"{what} rank {i}: launches {side['launches']}, g_lse arm "
              f"{side['lse_backward_launches']}, expected {want[i]}")
        check(not any(side["plain_calls"].values()),
              f"{what} rank {i}: plain calls {side['plain_calls']}")
        print(f"# sequence parallel {what} rank {i} ({CARD}): launches "
              f"{side['launches']}, g_lse arm "
              f"{side['lse_backward_launches']}, ring shift "
              f"{side['ring_shift_s_per_step']:.6f} s a step over "
              f"{side['ring_shift_calls']} shifts, all-reduce "
              f"{side['allreduce_s_per_step']:.6f} s a step, step "
              f"{side.get('step_time_s', 0.0):.6f} s, "
              f"{side.get('tokens_per_sec', 0.0):.1f} tokens/s, peak "
              f"memory {side['peak_memory_bytes']} B", flush=True)
    check(ranks[0]["params_sha256"] == ranks[1]["params_sha256"],
          f"{what}: the two ranks' final parameters differ")
    return [{k: side.get(k) for k in (
        "rank", "backend", "device", "sequence_index", "launches",
        "lse_backward_launches", "ring_shift_s_per_step", "ring_shift_calls",
        "allreduce_s_per_step", "step_time_s", "tokens_per_sec",
        "tokens_per_sec_per_chip", "mfu", "peak_memory_bytes",
        "params_sha256")} for side in ranks]


def held_to(rows: list, ref: dict, what: str) -> dict:
    """Losses and grad norms of ``rows`` (per-step metrics) against
    ``ref``'s within bf16 rounding (loss 5e-3, grad norm 3e-2 relative:
    phase 12's bars)."""
    rel = {}
    for col, key, bar in (("loss", "losses", 5e-3),
                          ("grad_norm", "grad_norms", 3e-2)):
        a = ref[key]
        b = [float(row[col]) for row in rows]
        check(len(a) == len(b), f"{what}: {len(b)} rows, {len(a)} in ref")
        rel[col] = max(abs(x - y) / abs(x) for x, y in zip(a, b))
        check(rel[col] <= bar, f"{what} {col} {b} vs {a}: relative "
                               f"{rel[col]} > {bar}")
    return rel


def sequence_phase(torch, fa, bw, bf16_peak, single: dict) -> tuple:
    """Phase 14 (see the module doc). ``single`` is phase 12's run of
    GPT-2 base without a group. Returns the phase's line and the g_lse
    arm's kernel row."""
    t0 = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {
        "gpt2_hop_diag_bf16": (4, 12, 512, 64, bf16, True, [512] * 4),
        "gpt2_hop_past_bf16": (4, 12, 512, 64, bf16, False, [512] * 4),
        "dh128_dead_bf16": (2, 4, 512, 128, bf16, True, [512, 0]),
        "dh64_noncausal_dead_bf16": (2, 4, 300, 64, bf16, False, [300, 0]),
        "diffuseq_hop_bf16": (4, 12, 512, 64, bf16, False,
                              [512, 431, 97, 0]),
        "f32_dh64_causal": (2, 3, 200, 64, f32, True, [200, 77]),
        "f32_dh128_noncausal_dead": (2, 3, 130, 128, f32, False, [130, 0]),
    }
    errs = {name: lse_check(torch, fa, *c, seed=40 + i)
            for i, (name, c) in enumerate(cases.items())}
    print(f"# sequence parallel: flash_attention_lse kernels vs plain "
          f"(max abs err, relative Frobenius) {json.dumps(errs)}",
          flush=True)
    timing = {f"L{L}": lse_timing(torch, fa, 4, 12, L, 64)
              for L in (512, 1024)}
    for key, tm in timing.items():
        tm["g_lse_over_without"] = tm["ms"] / tm["ms_without_g_lse"]
        print(f"# sequence parallel ({CARD}): bf16 backward {tm['shape']} "
              f"causal: {tm['ms']:.5f} ms with g_lse, "
              f"{tm['ms_without_g_lse']:.5f} ms without "
              f"({tm['g_lse_over_without']:.4f}x; runs {tm['ms_runs']}); "
              f"plain with g_lse {tm['plain_ms']:.3f} ms", flush=True)

    layers, micro = GPT2_BASE["num_layers"], 2
    per = layers * micro * DP_STEPS
    runs = {}
    with tempfile.TemporaryDirectory() as work:
        # the three runs side by side, after the kernel timings: their
        # seconds share the card and the host (contended; with GPT-2's
        # ranks alone the whole script outgrows its budget)
        run = os.path.join(work, "gpt2_sp2")
        started = {"gpt2": (dp_start(SP_FLAGS + dp_argv(run, 8, 4)), run,
                            "gpt2 sp2")}
        for key, extra in (("diffuseq_one", []),
                           ("diffuseq_sp2", SP_FLAGS)):
            run = os.path.join(work, key)
            started[key] = (dp_start(extra + sp_diffuseq_argv(run)), run,
                            key)
        for key, (job, run, what) in started.items():
            runs[key] = dp_finish(job, run, what)
    out = {"kernel_checks": errs, "timing": timing,
           "wall_s": {k: r["wall_s"] for k, r in runs.items()},
           "contended": ["gpt2", "diffuseq_one", "diffuseq_sp2"]}
    gpt2_want = [{"flash_forward": per * n, "flash_backward": per * n,
                  "fused_adamw_ema": DP_STEPS} for n in (1, 2)]
    out["gpt2_base_sp2"] = {
        "losses": [h["loss"] for h in runs["gpt2"]["steps"]],
        "grad_norms": [h["grad_norm"] for h in runs["gpt2"]["steps"]],
        "ranks": sp_ranks(runs["gpt2"], "gpt2 base sp2 (contended)",
                          gpt2_want),
        "vs_no_group_max_rel": held_to(runs["gpt2"]["steps"], single,
                                       "gpt2 base sp2 vs no group")}
    dq_per = layers * micro * SP_DIFFUSEQ_STEPS
    one = runs["diffuseq_one"]
    check(one["ranks"][0]["launches"] == {
        "flash_forward": dq_per, "flash_backward": dq_per,
        "fused_adamw_ema": SP_DIFFUSEQ_STEPS},
        f"diffuseq seq1024 one process: launches "
        f"{one['ranks'][0]['launches']}")
    one_ref = {"losses": [h["loss"] for h in one["steps"]],
               "grad_norms": [h["grad_norm"] for h in one["steps"]]}
    out["diffuseq_base_seq1024"] = {
        "one_process": {**one_ref, "step_time_s": one["ranks"][0].get(
            "step_time_s"), "peak_memory_bytes": one["ranks"][0][
            "peak_memory_bytes"]},
        "sp2": {"losses": [h["loss"]
                           for h in runs["diffuseq_sp2"]["steps"]],
                "ranks": sp_ranks(runs["diffuseq_sp2"], "diffuseq seq1024 "
                                  "sp2 (contended)",
                                  [{"flash_forward": 2 * dq_per,
                                    "flash_backward": 2 * dq_per,
                                    "fused_adamw_ema":
                                        SP_DIFFUSEQ_STEPS}] * 2)},
        "sp2_vs_one_max_rel": held_to(runs["diffuseq_sp2"]["steps"],
                                      one_ref,
                                      "diffuseq seq1024 sp2 vs one")}
    hop = errs["gpt2_hop_diag_bf16"]
    tm = timing["L512"]
    ranks = out["gpt2_base_sp2"]["ranks"]
    row = {"name": "flash_attention_lse", "route": "cuda",
           "source": "distributed_pipeline_tpu_torch/ops/csrc/"
                     "flash_attention.cu",
           "replaces": "distributed_pipeline_tpu/ops/flash_attention.py:653",
           "arm": "dpt_flash_bwd with g_lse (delta = rowsum(dO * O) - "
                  "g_lse), behind the ring's flash_attention_lse",
           "launches": sum(r["lse_backward_launches"] for r in ranks),
           "launches_by_rank": [r["lse_backward_launches"] for r in ranks],
           "launches_diffuseq_sp2": [
               r["lse_backward_launches"] for r in
               out["diffuseq_base_seq1024"]["sp2"]["ranks"]],
           "max_abs_err": max(hop["dq"], hop["dk"], hop["dv"]),
           "ms": tm["ms"], "ms_runs": tm["ms_runs"],
           "ms_without_g_lse": tm["ms_without_g_lse"],
           "ms_L1024": timing["L1024"]["ms"],
           "ms_L1024_without_g_lse": timing["L1024"]["ms_without_g_lse"],
           "plain_ms": tm["plain_ms"],
           **bound(fa.flash_hbm_bytes(4, 12, 512, 64, 2, True,
                                      backward=True, g_lse=True),
                   fa.flash_flops(4, 12, 512, 64, True, backward=True), bw,
                   bf16_peak),
           "library_ms": None,
           "library_call": "none: no PyTorch call takes an lse cotangent"}
    out["phase_s"] = time.perf_counter() - t0
    dq_rel = out["diffuseq_base_seq1024"]["sp2_vs_one_max_rel"]
    print(f"# sequence parallel ({CARD}): gpt2 base sp2 vs no group "
          f"{out['gpt2_base_sp2']['vs_no_group_max_rel']}, diffuseq seq1024 "
          f"sp2 vs one process {dq_rel}; walls {out['wall_s']} (side by "
          f"side: contended); phase "
          f"{out['phase_s']:.1f} s of its {SP_BUDGET_S:.0f} s budget",
          flush=True)
    check(out["phase_s"] <= SP_BUDGET_S,
          f"phase 14 took {out['phase_s']:.1f} s, over {SP_BUDGET_S} s")
    return out, row


# ------------------------------------------- training tooling (phase 15)

TOOL_STEPS = 6
# the phase's wall budget: five run.train processes of DiffuSeq-base (start,
# the kernel library's load, up to 6 steps) and nine 2.2 GB saves
TOOL_BUDGET_S = 300.0
TOOL_HANG_S = 12.0
FUSED_KERNEL = "fused_update_kernel"


def tool_argv(run: str, extra=()) -> list:
    """Phase 5's DiffuSeq-base batch under a supervised one-rank ring."""
    return ["--distributed", "--nprocs", "1", "--max_restarts", "3",
            "--restart_backoff_s", "0.1", "--checkpoint_path", run,
            "--batch_size", "256", "--microbatch", "64",
            "--learning_steps", str(TOOL_STEPS), "--save_interval", "2",
            "--keep_checkpoints", "2", "--ema_rate", "0.5,0.9,0.99",
            "--attention_impl", "auto", "--fused_update", "auto",
            "--log_interval", "1", "--seed", "0", *extra]


def tool_run(run: str, argv: list, what: str, plan=None) -> dict:
    """``run.train`` as a supervised ring in a subprocess (``plan``: the
    chaos plan in ``DPT_CHAOS_PLAN``); returns its attempt records, the
    goodput fold, the sidecar and the progress rows."""
    from distributed_pipeline_tpu_torch.chaos import (aggregate_run,
                                                      read_attempts)
    env = {k: v for k, v in os.environ.items() if k not in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
        "LOCAL_WORLD_SIZE", "DPT_DIST_AUTORUN", "DPT_RUN_TIMESTAMP",
        "DPT_CHAOS_PLAN", "DPT_TRACE", "DPT_ATTEMPT")}
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = repo
    if plan is not None:
        env["DPT_CHAOS_PLAN"] = json.dumps({"faults": plan})
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "distributed_pipeline_tpu_torch.run.train",
         *argv], cwd=repo, env=env, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-8000:], file=sys.stderr)
    check(out.returncode == 0, f"{what}: run.train exited {out.returncode}")
    with open(os.path.join(run, "train_summary.json")) as f:
        side = json.load(f)
    with open(os.path.join(run, "progress.csv")) as f:
        lines = f.read().splitlines() or [""]
    head = lines[0].split(",")
    rows = [dict(zip(head, line.split(","))) for line in lines[1:]]
    agg = aggregate_run(run)
    check(agg["accounted_frac"] == agg["accounted_frac"]
          and abs(agg["accounted_frac"] - 1.0) <= 0.01,
          f"{what}: accounted_frac {agg['accounted_frac']}")
    return {"attempts": read_attempts(run), "goodput": agg, "side": side,
            "rows": rows, "stderr": out.stderr, "wall_s": wall}


def params_of(torch, run: str) -> dict:
    return torch.load(os.path.join(run, f"model_{TOOL_STEPS:06d}.pt"),
                      weights_only=True)


def attempt_summary(rec: dict) -> dict:
    """An attempt record's seconds: its wall, downtime, hang window and
    the goodput snapshot's categories."""
    gp = rec.get("goodput") or {}
    return {"rc": rec["rc"], "start_step": rec["start_step"],
            "end_step": rec["end_step"], "duration_s": rec["duration_s"],
            "downtime_s": rec["downtime_s"],
            "resume_overhead_s": rec["resume_overhead_s"],
            "hang_s": rec.get("hang_s"),
            **{k: gp.get(k) for k in (
                "startup_s", "setup_s", "restore_s", "compile_s", "save_s",
                "data_stall_s", "recompute_s", "useful_step_s", "goodput")}}


def fold_summary(agg: dict) -> dict:
    return {k: v for k, v in agg.items() if k != "per_attempt"}


def check_side(side: dict, launches: int, what: str) -> None:
    check(side["launches"] == {"flash_forward": 0, "flash_backward": 0,
                               "fused_adamw_ema": launches},
          f"{what}: launches {side['launches']}, expected the update "
          f"{launches} times and no flash kernel (dense arm at 128)")
    check(not any(side["plain_calls"].values()),
          f"{what}: plain calls {side['plain_calls']}")
    check(side["device"].startswith("cuda"), f"{what} on {side['device']}")


def profiler_kernel_events(prof_dir: str) -> list:
    """The device kernels the profiler window's Chrome trace names."""
    names = []
    files = [os.path.join(r, f) for r, _, fs in os.walk(prof_dir)
             for f in fs if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"profiler window wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    for e in events:
        if e.get("cat") == "kernel":
            names.append(e.get("name", ""))
    return names


def logged_losses(rows: list) -> dict:
    """{step: loss} from progress rows: a row holds the loss of the step
    ``dispatch_lag`` (1) before its own."""
    return {int(float(row["step"])) - 1: float(row["loss"]) for row in rows
            if row.get("loss")}


def tooling_phase(torch, work: str) -> dict:
    """Phase 15 (see the module doc). The rings' run dirs stay in
    ``work`` for the readers' phase."""
    from distributed_pipeline_tpu_torch.obs import ledger as ledger_lib
    from distributed_pipeline_tpu_torch.obs import trace as trace_lib
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"steps": TOOL_STEPS, "contended": ["chaos", "watchdog"]}
    # (b) the uninterrupted twin with every tool armed, alone (its laps are
    # the ones read); it saves once, at the end, so its laps overlap no
    # background write
    twin = os.path.join(work, "twin")
    prof = os.path.join(work, "prof")
    b = tool_run(twin, tool_argv(twin, (
        "--trace", "true", "--cost_ledger", "true", "--sanitize", "true",
        "--profile_dir", prof, "--profile_steps", "2:4",
        "--save_interval", str(TOOL_STEPS))), "twin")
    # then (a) and (c) side by side (their checks are bitwise or about
    # their attempts; their seconds share the card and the host)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    # (a) corrupt + kill at step 4: walk back to step 2, finish
    chaos = os.path.join(work, "chaos")
    job_a = pool.submit(
        tool_run, chaos, tool_argv(chaos, ("--cost_ledger", "true")),
        "chaos ring", plan=[
            {"kind": "corrupt_checkpoint", "step": 4, "rank": 0},
            {"kind": "kill", "step": 4, "rank": 0}])
    # (c) the watchdog kills a wedged attempt; this ring logs nothing
    # (--log_interval 0): its history holds every step it ran
    hang = os.path.join(work, "hang")
    job_c = pool.submit(tool_run, hang, tool_argv(hang, (
        "--hang_timeout_s", str(TOOL_HANG_S),
        "--hang_startup_timeout_s", "120", "--log_interval", "0")),
        "watchdog ring", plan=[
            {"kind": "stall_step", "step": 3, "seconds": 600, "rank": 0}])
    pool.shutdown(wait=True)
    a, c = job_a.result(), job_c.result()
    recs = a["attempts"]
    check([(r["rc"], r["end_step"]) for r in recs] == [(-9, 4), (0, 6)],
          f"chaos ring attempts {[(r['rc'], r['end_step']) for r in recs]}")
    check(recs[1]["start_step"] == 2, f"chaos ring resumed at "
                                      f"{recs[1]['start_step']}, not 2")
    check(all(os.path.exists(os.path.join(chaos, f".chaos_fired_0{i}"))
              for i in (0, 1)), "chaos markers missing")
    with open(os.path.join(chaos, "log.txt")) as f:
        log = f.read()
    check("walking back" in log and "resumed from step 2" in log,
          "the chaos ring's log shows no walk-back past the corrupt step 4 "
          "to step 2")
    check(a["goodput"]["recompute_s"] > 0,
          f"chaos ring recompute_s {a['goodput']['recompute_s']}")
    check_side(a["side"], TOOL_STEPS - 2, "chaos ring attempt 1")

    # (b)
    check([(r["rc"], r["end_step"]) for r in b["attempts"]] == [(0, 6)],
          f"twin attempts {b['attempts']}")
    check_side(b["side"], TOOL_STEPS, "twin")
    pa, pb = params_of(torch, chaos), params_of(torch, twin)
    differ = [k for k in pa if not torch.equal(pa[k], pb[k])]
    check(not differ, f"chaos ring's step-6 parameters differ from the "
                      f"twin's: {differ[:5]}")
    del pa, pb
    kernels = profiler_kernel_events(prof)
    fused = [n for n in kernels if FUSED_KERNEL in n]
    check(len(fused) == 2, f"the profiler window (steps 2:4) names "
                           f"{FUSED_KERNEL} {len(fused)} times")
    with open(os.path.join(twin, "sanitize_report.json")) as f:
        report = json.load(f)
    check(report["violations"] == [],
          f"sanitizer violations: {report['violations'][:3]}")
    row = ledger_lib.read_ledger(twin)["programs"]["train_step"]
    gap_sum = ledger_lib.gap_sum_identity(row)
    check(abs(gap_sum - 1.0) <= 1e-9, f"ledger gaps sum to {gap_sum}")
    logged = float(b["rows"][-1]["mfu"])
    check(abs(row["mfu"] - logged) <= 1e-9 * logged,
          f"ledger mfu {row['mfu']} vs logged {logged}")
    events = trace_lib.read_trace(trace_lib.trace_path(twin, 0))
    spans = sum(e["dur"] for e in events if e["name"] == "step")
    with open(os.path.join(twin, "goodput_attempt000.json")) as f:
        rec = json.load(f)
    step_s = (rec["useful_step_s"] + rec["recompute_s"]
              + rec["data_stall_s"])
    check(abs(spans - step_s) <= 0.02 * step_s,
          f"step spans {spans} s vs goodput step time {step_s} s")
    check([e["args"]["step"] for e in events if e["name"] == "step"]
          == list(range(1, TOOL_STEPS + 1)), "twin's step spans")
    compile_spans = [e["dur"] for e in events if e["name"] == "compile"]
    check(len(compile_spans) == 1
          and abs(compile_spans[0] - rec["compile_s"]) <= 1e-6,
          f"compile spans {compile_spans} vs compile_s {rec['compile_s']}")
    # the save in the background: its copy, then its wait at exit, one
    # span each, summing to save_s
    saves = b["side"]["saves"]
    check([sv["step"] for sv in saves] == [TOOL_STEPS],
          f"twin's saves {saves}")
    save_spans = [e["dur"] for e in events if e["name"] == "save"]
    check(len(save_spans) == 2 and abs(sum(save_spans) - rec["save_s"])
          <= 1e-3 * rec["save_s"] + 1e-6,
          f"save spans {save_spans} vs save_s {rec['save_s']}")

    # (c)
    hrecs = c["attempts"]
    check(len(hrecs) == 2 and hrecs[0].get("hung") is True
          and hrecs[0]["end_step"] == 3 and hrecs[1]["rc"] == 0
          and hrecs[1]["end_step"] == TOOL_STEPS,
          f"watchdog ring attempts {hrecs}")
    check(TOOL_HANG_S <= hrecs[0]["hang_s"] <= TOOL_HANG_S + 5,
          f"hang_s {hrecs[0]['hang_s']}, timeout {TOOL_HANG_S}")
    check(c["goodput"]["hang_s"] == hrecs[0]["hang_s"],
          f"the fold's hang_s {c['goodput']['hang_s']}")
    check_side(c["side"], TOOL_STEPS - 2, "watchdog ring attempt 1")
    # the twin's rows at --log_interval 1, each the step before its own,
    # against the unlogged ring's history (the same steps from the same
    # step-2 state: bitwise)
    twin_logged = logged_losses(b["rows"])
    hang_hist = {h["step"]: h["loss"] for h in c["side"]["history"]}
    common = sorted(set(twin_logged) & set(hang_hist))
    check(common == [3, 4, 5] and all(twin_logged[k] == hang_hist[k]
                                      for k in common),
          f"the twin's logged losses {twin_logged} differ from the "
          f"--log_interval 0 ring's history {hang_hist}")
    check(sorted(twin_logged) == list(range(1, TOOL_STEPS)),
          f"the twin logged the losses of steps {sorted(twin_logged)}")

    def step_times_of(r: dict) -> list:
        return [float(row["step_time_s"]) for row in r["rows"]
                if row.get("step_time_s")]

    step_times = step_times_of(b)
    out.update({
        "chaos": {"attempts": [attempt_summary(r) for r in recs],
                  "goodput": fold_summary(a["goodput"]),
                  "launches": a["side"]["launches"],
                  # the same flags without the tools: the twin's yardstick
                  "step_time_s": step_times_of(a),
                  "saves": a["side"]["saves"], "wall_s": a["wall_s"]},
        "twin": {"attempts": [attempt_summary(r) for r in b["attempts"]],
                 "goodput": fold_summary(b["goodput"]),
                 "launches": b["side"]["launches"],
                 "step_time_s": step_times,
                 "steady_lap_s": step_times[-1],
                 "saves": saves,
                 "beacon_s_per_step": b["side"]["beacon_s_per_step"],
                 "stall_means": b["side"]["stall_means"],
                 "peak_memory_bytes": b["side"]["peak_memory_bytes"],
                 "tokens_per_sec_per_chip": float(
                     b["rows"][-1]["tokens_per_sec_per_chip"]),
                 "mfu": logged, "ledger": {k: row[k] for k in (
                     "mfu", *ledger_lib.GAP_TERMS, "bytes_accessed",
                     "flops_per_execution", "host_stall_s_per_step",
                     "device_step_s", "padding_waste_frac")},
                 "step_spans_s": spans, "goodput_step_s": step_s,
                 "logged_losses": twin_logged,
                 "profiler_fused_events": len(fused),
                 "profiler_kernel_events": len(kernels),
                 "sanitize_violations": 0, "wall_s": b["wall_s"]},
        "watchdog": {"attempts": [attempt_summary(r) for r in hrecs],
                     "goodput": fold_summary(c["goodput"]),
                     "launches": c["side"]["launches"],
                     "history_losses": hang_hist,
                     "saves": c["side"]["saves"], "wall_s": c["wall_s"]},
        "chaos_bitwise_twin": True, "dirs": {
            "chaos": chaos, "twin": twin, "hang": hang}})
    out["phase_s"] = time.perf_counter() - t0
    for key, r in (("chaos (contended)", a), ("twin (alone)", b),
                   ("watchdog (contended)", c)):
        print(f"# training tooling {key} ({CARD}): save_s per save "
              f"(copy + wait) " + ", ".join(
                  f"step {sv['step']}: {sv['copy_s']:.4f} + "
                  f"{sv['wait_s']:.4f} s" for sv in r["side"]["saves"]),
              flush=True)
    print(f"# training tooling ({CARD}): chaos ring walked back to step 2 "
          f"and ended bitwise the twin's; goodput with the fault "
          f"{a['goodput']['goodput']:.4f}, twin {b['goodput']['goodput']:.4f}"
          f", watchdog ring {c['goodput']['goodput']:.4f} (hang_s "
          f"{hrecs[0]['hang_s']}); twin step times {step_times} (steady "
          f"lap {step_times[-1]:.6f} s at --log_interval 1, the metrics "
          f"one step in flight), the chaos ring's (no tool but the ledger "
          f"armed; contended) {out['chaos']['step_time_s']}, beacon "
          f"{b['side']['beacon_s_per_step']:.6f} s a step, peak "
          f"{b['side']['peak_memory_bytes']} B; walls "
          f"{a['wall_s']:.1f} / {b['wall_s']:.1f} / {c['wall_s']:.1f} s (the "
          f"twin alone, then the chaos and watchdog rings side by side: "
          f"contended); "
          f"phase {out['phase_s']:.1f} s of its {TOOL_BUDGET_S:.0f} s budget",
          flush=True)
    check(out["phase_s"] <= TOOL_BUDGET_S,
          f"phase 15 took {out['phase_s']:.1f} s, over {TOOL_BUDGET_S} s")
    return out


# ------------------------- MoE and --eval_decode under --sequence 2 (17)

# the phase's wall budget: one run.train pair of GPT-2 base moe8 on two
# sequence ranks and one --eval_decode pair of GPT-2 base, then the
# one-process callback (98.6-124.2 s measured on the H100)
SPM_BUDGET_S = 200.0


def spm_argv(run: str, cfg: dict, steps: int, extra=()) -> list:
    """GPT-2 base (or moe8) at seq 1024, batch 8 in microbatches of 4 (a
    data group's rows), as phase 12."""
    return (["--checkpoint_path", run, "--dataset", "synthetic-lm"]
            + cfg_argv(cfg)
            + ["--batch_size", "8", "--microbatch", "4",
               "--learning_steps", str(steps), "--lr", "3e-4",
               "--ema_rate", "0.9999", "--attention_impl", "auto",
               "--fused_update", "auto", "--log_interval", "1",
               "--save_interval", "0", "--seed", "0", *extra])


def moe_sequence_phase(torch, one: dict) -> dict:
    """Phase 17: GPT-2 base moe8 on two sequence ranks sharing ``cuda:0``
    (gloo) against ``one``, phase 13's run of the same flags in one
    process without a group (its losses and grad norms, 5 steps); then
    ``--eval_decode``
    on two sequence ranks, whose ``decode_acc`` (the first sequence rank
    decodes, outside the ring) must equal the one-process callback's on
    the step-2 weights."""
    from distributed_pipeline_tpu_torch.config.train import parse_settings
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.run.train import eval_decode_callback
    from distributed_pipeline_tpu_torch.utils.logger import Logger
    from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop
    t0 = time.perf_counter()
    layers, micro = GPT2_BASE["num_layers"], 2
    per = layers * micro * MOE_STEPS
    out: dict = {"steps": MOE_STEPS, "contended": ["moe8", "decode"]}
    with tempfile.TemporaryDirectory() as work:
        # the two runs side by side (contended: no time of theirs is
        # compared with an earlier one)
        run = os.path.join(work, "moe8_sp2")
        job = dp_start(SP_FLAGS + spm_argv(run, GPT2_MOE8, MOE_STEPS))
        run_dec = os.path.join(work, "decode_sp2")
        extra = ["--eval_decode", "true", "--eval_interval", "2",
                 "--save_interval", "2"]
        argv = spm_argv(run_dec, GPT2_BASE, 3, extra)
        job_dec = dp_start(SP_FLAGS + argv)
        sp2 = dp_finish(job, run, "moe8 sp2")
        dec = dp_finish(job_dec, run_dec, "eval_decode sp2")
        ranks = sp_ranks(sp2, "gpt2 moe8 sp2 (contended)", [
            {"flash_forward": per * n, "flash_backward": per * n,
             "fused_adamw_ema": MOE_STEPS} for n in (1, 2)])
        # held to the one process: every step's loss and the first step's
        # grad norm (the same weights and batch, the arithmetic's rounding
        # alone) within phase 12's bf16 bars; later grad norms are
        # recorded, not held: a bf16 rounding difference flips a token's
        # expert, which moves the capacity claims of the tokens after it
        # and, over the steps, the gradient by more than rounding
        held = held_to(sp2["steps"][:1], {k: one[k][:1] for k in (
            "losses", "grad_norms")}, "gpt2 moe8 sp2 vs one process, step 1")
        rel_loss = [abs(h["loss"] - x) / abs(x)
                    for h, x in zip(sp2["steps"], one["losses"])]
        check(len(rel_loss) == MOE_STEPS and max(rel_loss) <= 5e-3,
              f"gpt2 moe8 sp2 losses {[h['loss'] for h in sp2['steps']]} "
              f"vs one process {one['losses']}: relative {rel_loss}")
        out["moe8"] = {
            "one_process": {k: one[k] for k in (
                "losses", "grad_norms", "moe_aux", "step_time_s")},
            "sp2": {"losses": [h["loss"] for h in sp2["steps"]],
                    "grad_norms": [h["grad_norm"] for h in sp2["steps"]],
                    "moe_aux": [h["moe_aux"] for h in sp2["steps"]],
                    "ranks": ranks},
            "sp2_vs_one_step1_max_rel": held,
            "sp2_vs_one_loss_rel": rel_loss,
            "sp2_vs_one_grad_norm_rel": [
                abs(h["grad_norm"] - x) / abs(x)
                for h, x in zip(sp2["steps"], one["grad_norms"])],
            "wall_s": sp2["wall_s"]}
        # --eval_decode on two sequence ranks: the eval at step 2 lands in
        # step 3's row; the step-2 weights are saved
        got = [float(row["decode_acc"]) for row in dec["rows"]
               if row.get("decode_acc")]
        check(len(got) == 1, f"eval_decode sp2 rows carry decode_acc "
                             f"{got}")
        args = parse_settings(argv)
        model = create_model_from_config(
            **{k: v for k, v in args.to_dict().items() if k != "device"},
            device=torch.device("cuda"))
        log = Logger("")
        loop = TrainLoop(
            model=model, data=None, batch_size=8, microbatch=4,
            ema_rate="0.9999", checkpoint_dir="", logger=log,
            init_params=torch.load(os.path.join(run_dec, "model_000002.pt"),
                                   weights_only=True))
        loop.step = 2
        eval_decode_callback(args)(loop)
        want = log.dumpkvs()["decode_acc"]
        del loop, model
        torch.cuda.empty_cache()
        check(got[0] == want, f"eval_decode sp2 decode_acc {got[0]} vs the "
                              f"one-process callback's {want}")
        out["eval_decode_sp2"] = {
            "decode_acc": got[0], "one_process_decode_acc": want,
            "ranks": [{k: side.get(k) for k in (
                "rank", "sequence_index", "launches", "plain_calls",
                "step_time_s")} for side in dec["ranks"]],
            "wall_s": dec["wall_s"]}
    out["phase_s"] = time.perf_counter() - t0
    print(f"# moe and eval_decode under --sequence 2 ({CARD}): moe8 sp2 vs "
          f"one process: loss {out['moe8']['sp2_vs_one_loss_rel']}, grad "
          f"norm {out['moe8']['sp2_vs_one_grad_norm_rel']}, moe_aux "
          f"{out['moe8']['sp2']['moe_aux']}; eval_decode sp2 decode_acc "
          f"{got[0]} == one process {want}; walls "
          f"{out['moe8']['wall_s']:.1f} beside {dec['wall_s']:.1f} s "
          f"(contended); phase "
          f"{out['phase_s']:.1f} s of its {SPM_BUDGET_S:.0f} s budget",
          flush=True)
    check(out["phase_s"] <= SPM_BUDGET_S,
          f"phase 17 took {out['phase_s']:.1f} s, over {SPM_BUDGET_S} s")
    return out


# ------------------------------------------ sharded training state (18)

# the phase's wall budget: three run.train pairs of GPT-2 base (ZeRO-1
# with two saves, then --fsdp 2 beside the resume of steps 4-5; phase
# 12's three runs took 85.4 s)
SHARD_BUDGET_S = 120.0


def zero1_shard_elements(cfg: dict, dp: int) -> int:
    """The elements a rank's ZeRO-1 update covers: the flat buffer padded
    to a multiple of ``dp``, over ``dp``."""
    n = sum(math.prod(s) for s in param_shapes(cfg))
    return -(-n // dp)


def shard_ranks(r: dict, what: str, want: dict) -> list:
    """Each rank's sidecar of a sharded run, checked: gloo on ``cuda:0``,
    the launches ``want``, no plain call, the two ranks' final parameters
    bitwise equal; printed with the collectives' seconds, the footprint and
    the peak memory."""
    ranks = r["ranks"]
    check(len(ranks) == 2, f"{what}: {len(ranks)} sidecars")
    for side in ranks:
        i = side["rank"]
        check(side["backend"] == "gloo" and side["device"] == "cuda:0",
              f"{what} rank {i}: {side['backend']} {side['device']}")
        check(side["launches"] == want,
              f"{what} rank {i}: launches {side['launches']}, expected "
              f"{want}")
        check(not any(side["plain_calls"].values()),
              f"{what} rank {i}: plain calls {side['plain_calls']}")
        print(f"# sharded state {what} rank {i} ({CARD}): mesh "
              f"{side['mesh']}, ZeRO-1 {side['shard_optimizer']}, layout "
              f"{json.dumps(side['layout'])}, launches {side['launches']}, "
              f"reduce-scatter {side['reduce_scatter_s_per_step']:.6f} s a "
              f"step over {side['reduce_scatter_calls']} calls, all-gather "
              f"{side['all_gather_s_per_step']:.6f} s a step over "
              f"{side['all_gather_calls']} calls, all-reduce "
              f"{side['allreduce_s_per_step']:.6f} s a step, step "
              f"{side.get('step_time_s', 0.0):.6f} s, "
              f"{side.get('tokens_per_sec', 0.0):.1f} tokens/s, footprint "
              f"{json.dumps(side['footprint'])}, largest gathered unit "
              f"{side['fsdp_largest_unit_bytes']} B, peak memory "
              f"{side['peak_memory_bytes']} B", flush=True)
    check(ranks[0]["params_sha256"] == ranks[1]["params_sha256"],
          f"{what}: the two ranks' final parameters differ")
    return [{k: side.get(k) for k in (
        "rank", "backend", "device", "mesh", "shard_optimizer", "layout",
        "launches", "plain_calls", "reduce_scatter_s_per_step",
        "reduce_scatter_calls", "all_gather_s_per_step", "all_gather_calls",
        "allreduce_s_per_step", "allreduce_calls", "step_time_s",
        "tokens_per_sec", "footprint", "fsdp_largest_unit_bytes",
        "peak_memory_bytes", "params_sha256")} for side in ranks]


def shard_phase(torch, dp: dict, update_row: dict) -> dict:
    """Phase 18 (see the module doc). ``dp`` is phase 12's output: its
    ``nprocs2`` run is the unsharded pair every run here is held to.
    ``update_row`` is the update's kernel row at the ZeRO-1 shard's size:
    its element count is checked against the runs' and its launches are
    (a)'s. (a) runs alone; (b) then runs beside the resume (c), so their
    seconds share the card and the host (printed as contended)."""
    t0 = time.perf_counter()
    layers, micro = GPT2_BASE["num_layers"], 2
    per = layers * micro
    want = {"flash_forward": per * DP_STEPS, "flash_backward": per * DP_STEPS,
            "fused_adamw_ema": DP_STEPS}
    ref = dp["nprocs2"]
    ref_sha = ref["ranks"][0]["params_sha256"]
    ref_peak = max(x["peak_memory_bytes"] for x in ref["ranks"])
    ref_fp = ref["ranks"][0]["footprint"]
    out: dict = {"steps": DP_STEPS, "contended": ["fsdp2", "resume"]}
    with tempfile.TemporaryDirectory() as work:
        # (a) ZeRO-1 alone, saving at step 3 (and at the end)
        run_a = os.path.join(work, "zero1")
        a = dp_run(run_a, ["--distributed", "--nprocs", "2",
                           "--shard_optimizer", "true"]
                   + dp_argv(run_a, 4, 2) + ["--save_interval", "3"],
                   "zero1")
        torch.cuda.empty_cache()
        ranks_a = shard_ranks(a, "zero1", want)
        losses = [h["loss"] for h in a["steps"]]
        check(losses == ref["losses"],
              f"zero1 losses {losses} differ from phase 12's --nprocs 2 "
              f"{ref['losses']} (must be bitwise)")
        check(ranks_a[0]["params_sha256"] == ref_sha,
              "zero1 final parameters differ from phase 12's --nprocs 2")
        gn_rel = [abs(h["grad_norm"] - x) / abs(x)
                  for h, x in zip(a["steps"], ref["grad_norms"])]
        check(max(gn_rel) <= 1e-6, f"zero1 grad norms relative {gn_rel} to "
                                   f"phase 12's --nprocs 2, over 1e-6")
        owned = ranks_a[0]["layout"]["owned"]
        n = ranks_a[0]["layout"]["n"]
        fp = ranks_a[0]["footprint"]
        for key in ("opt_state_bytes_per_replica", "ema_bytes_per_replica"):
            # half of the unsharded pair's, within the shard's padding
            check(abs(2 * fp[key] - ref_fp[key]) <= 2 * 4 * 3 * (owned * 2
                                                                 - n) + 4,
                  f"zero1 {key} {fp[key]} is not half of phase 12's "
                  f"{ref_fp[key]}")
        print(f"# sharded state zero1 ({CARD}): losses bitwise phase 12's "
              f"--nprocs 2, final parameters' SHA-256 equal, grad norms "
              f"relative {gn_rel}; the update launched {DP_STEPS} times a "
              f"rank over {owned} of {n} elements; footprint "
              f"{json.dumps(fp)} vs phase 12's {json.dumps(ref_fp)}; peak "
              f"memory {[x['peak_memory_bytes'] for x in ranks_a]} B vs "
              f"phase 12's {[x['peak_memory_bytes'] for x in ref['ranks']]}"
              f" B", flush=True)
        out["zero1"] = {"losses": losses,
                        "grad_norms": [h["grad_norm"] for h in a["steps"]],
                        "grad_norm_rel": gn_rel, "update_elements": owned,
                        "ranks": ranks_a, "wall_s": a["wall_s"]}
        # (c), started now: (a)'s step-3 save resumed without ZeRO-1 into a
        # fresh run dir, to step 5, beside (b)
        saved = torch.load(os.path.join(run_a, "opt_000003.pt"),
                           weights_only=True, mmap=True)
        elems = sum(t.numel() for t in saved["mu"].values())
        check(elems == n and saved["count"] == 3,
              f"zero1's step-3 opt file holds {elems} mu elements at count "
              f"{saved['count']}, not the gathered {n} at 3")
        del saved
        run_c = os.path.join(work, "resume")
        started_c = dp_start(["--distributed", "--nprocs", "2"]
                             + dp_argv(run_c, 4, 2) + [
                                 "--resume_checkpoint",
                                 os.path.join(run_a, "model_000003.pt")])
        # (b) --fsdp 2 (dp 1, the same global batch), beside (c)
        run_b = os.path.join(work, "fsdp2")
        b = dp_run(run_b, ["--distributed", "--nprocs", "2", "--fsdp", "2"]
                   + dp_argv(run_b, 4, 2), "fsdp2")
        c = dp_finish(started_c, run_c, "resume")
        torch.cuda.empty_cache()
        ranks_b = shard_ranks(b, "fsdp2 (contended)", want)
        rel = {}
        for col, key, bar in (("loss", "losses", 5e-3),
                              ("grad_norm", "grad_norms", 3e-2)):
            got = [h[col] for h in b["steps"]]
            rel[col] = max(abs(x - y) / abs(y)
                           for x, y in zip(got, ref[key]))
            check(rel[col] <= bar, f"fsdp2 {col} {got} vs phase 12's "
                                   f"--nprocs 2 {ref[key]}: relative "
                                   f"{rel[col]} > {bar}")
        fp_b = ranks_b[0]["footprint"]
        check(fp_b["params_bytes_per_replica"] < fp_b["params_bytes"],
              f"fsdp2 holds {fp_b['params_bytes_per_replica']} parameter "
              f"bytes a rank, not less than the whole "
              f"{fp_b['params_bytes']}")
        peak_a = max(x["peak_memory_bytes"] for x in ranks_a)
        peak_b = max(x["peak_memory_bytes"] for x in ranks_b)
        check(peak_b < ref_peak, f"fsdp2 peak {peak_b} B not below phase "
                                 f"12's --nprocs 2 peak {ref_peak} B")
        print(f"# sharded state fsdp2 ({CARD}): vs phase 12's --nprocs 2 "
              f"largest relative difference {rel}, losses bitwise "
              f"{[h['loss'] for h in b['steps']] == ref['losses']}; params "
              f"{fp_b['params_bytes_per_replica']} of "
              f"{fp_b['params_bytes']} B a rank, largest gathered unit "
              f"{ranks_b[0]['fsdp_largest_unit_bytes']} B; peak memory "
              f"{peak_b} B vs zero1 {peak_a} B and phase 12's --nprocs 2 "
              f"{ref_peak} B", flush=True)
        out["fsdp2"] = {"losses": [h["loss"] for h in b["steps"]],
                        "grad_norms": [h["grad_norm"] for h in b["steps"]],
                        "vs_nprocs2_max_rel": rel, "ranks": ranks_b,
                        "peak_vs_zero1": peak_b - peak_a,
                        "wall_s": b["wall_s"]}
        # (c)
        rest = DP_STEPS - 3
        ranks_c = shard_ranks(c, "resume", {
            "flash_forward": per * rest, "flash_backward": per * rest,
            "fused_adamw_ema": rest})
        losses_c = [h["loss"] for h in c["steps"]]
        check([h["step"] for h in c["steps"]] == [4, 5]
              and losses_c == ref["losses"][3:],
              f"resumed steps {[h['step'] for h in c['steps']]} losses "
              f"{losses_c} differ from phase 12's --nprocs 2 steps 4-5 "
              f"{ref['losses'][3:]}")
        check(ranks_c[0]["params_sha256"] == ref_sha,
              "the resumed run's final parameters differ from phase 12's "
              "--nprocs 2")
        print(f"# sharded state resume ({CARD}): zero1's step-3 files "
              f"(full tensors, {n} elements) resumed without ZeRO-1: steps "
              f"4-5 losses and the final parameters bitwise phase 12's "
              f"--nprocs 2", flush=True)
        out["resume"] = {"losses": losses_c, "ranks": ranks_c,
                         "wall_s": c["wall_s"]}
    check(update_row["elements"] == owned,
          f"the update row's {update_row['elements']} elements are not the "
          f"runs' shard of {owned}")
    update_row["launches"] = [x["launches"]["fused_adamw_ema"]
                              for x in ranks_a]
    out["phase_s"] = time.perf_counter() - t0
    print(f"# sharded state ({CARD}): walls {a['wall_s']:.1f} alone, then "
          f"{b['wall_s']:.1f} beside {c['wall_s']:.1f} s (contended); phase "
          f"{out['phase_s']:.1f} s of its {SHARD_BUDGET_S:.0f} s budget",
          flush=True)
    check(out["phase_s"] <= SHARD_BUDGET_S,
          f"phase 18 took {out['phase_s']:.1f} s, over {SHARD_BUDGET_S} s")
    return out


# ----------------------------------- stacked layers and the pipeline (19)

PIPE_BUDGET_S = 200.0
PIPE_FLAGS = ["--distributed", "--nprocs", "2", "--pipe", "2"]
DIFFUSEQ_STEPS = 20


def pipe_stage_elements(cfg: dict, stages: int) -> int:
    """The elements a pipe rank's update covers: its stage's share of the
    stacked block weights and the whole rest of the model."""
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    model = create_model_from_config(**cfg, scan_layers=True, device="meta")
    blocks = sum(p.numel() for n, p in model.named_parameters()
                 if ".blocks." in n)
    rest = sum(p.numel() for n, p in model.named_parameters()
               if ".blocks." not in n)
    return blocks // stages + rest


def pipe_ranks(r: dict, what: str, want: list) -> list:
    """Each rank's sidecar of a pipe run, checked: gloo on ``cuda:0``, the
    launches ``want[rank]``, no plain call, the two ranks' losses and
    final parameters equal; printed with the step time, the exchange's
    seconds and bytes and the peak memory."""
    ranks = r["ranks"]
    check(len(ranks) == 2, f"{what}: {len(ranks)} sidecars")
    for side in ranks:
        i = side["rank"]
        check(side["backend"] == "gloo" and side["device"] == "cuda:0",
              f"{what} rank {i}: {side['backend']} {side['device']}")
        check(side["launches"] == want[i],
              f"{what} rank {i}: launches {side['launches']}, expected "
              f"{want[i]}")
        check(not any(side["plain_calls"].values()),
              f"{what} rank {i}: plain calls {side['plain_calls']}")
        print(f"# pipeline {what} rank {i} ({CARD}): stage "
              f"{json.dumps(side['pipe'])}, launches {side['launches']}, "
              f"step {side.get('step_time_s', 0.0):.6f} s, pipe_p2p "
              f"{side['pipe_p2p_s_per_step']:.6f} s a step over "
              f"{side['pipe_p2p_calls']} exchanges, {side['pipe_bytes']} B "
              f"sent, all-reduce {side['allreduce_s_per_step']:.6f} s a "
              f"step, update over {side['layout']['owned']} elements, peak "
              f"memory {side['peak_memory_bytes']} B", flush=True)
    check([h["loss"] for h in ranks[0]["history"]]
          == [h["loss"] for h in ranks[1]["history"]],
          f"{what}: the two ranks logged different losses")
    check(ranks[0]["params_sha256"] == ranks[1]["params_sha256"],
          f"{what}: the two ranks' final parameters differ")
    return [{k: side.get(k) for k in (
        "rank", "pipe", "launches", "plain_calls", "pipe_p2p_s_per_step",
        "pipe_p2p_calls", "pipe_bytes", "allreduce_s_per_step",
        "step_time_s", "tokens_per_sec", "peak_memory_bytes", "layout",
        "eval_decodes", "params_sha256")} for side in ranks]


def held_to_scan(steps: list, ref: list, what: str) -> dict:
    """A pipe run's per-step metrics against (a)'s over the same steps:
    step 1's loss (the forward before any update) within 1e-6 relative
    (the chunks' f32 loss sums), its grad norm within 1e-3 relative,
    every loss within 5e-3 relative (phase 12's bar across a change of
    microbatch split: each one-row chunk's weight gradient rounds to bf16
    before the f32 sum). Returns the largest absolute and relative loss
    differences."""
    got = [h["loss"] for h in steps]
    want = [h["loss"] for h in ref]
    check(len(got) == len(want), f"{what}: {len(got)} steps vs {len(want)}")
    gn = abs(steps[0]["grad_norm"] - ref[0]["grad_norm"]) / ref[0][
        "grad_norm"]
    worst = max(abs(x - y) for x, y in zip(got, want))
    rels = [abs(x - y) / abs(y) for x, y in zip(got, want)]
    check(rels[0] <= 1e-6 and gn <= 1e-3 and max(rels) <= 5e-3,
          f"{what}: losses {got} vs {want}, relative {rels} (step 1 within "
          f"1e-6, all within 5e-3), step-1 grad norm relative {gn}")
    return {"max_abs": worst, "max_rel": max(rels), "step1_rel": rels[0],
            "step1_grad_norm_rel": gn}


def pipe_launches(per_step_fwd: int, per_step_bwd: int, steps: int,
                  extra_fwd=(0, 0)) -> list:
    return [{"flash_forward": per_step_fwd * steps + extra_fwd[i],
             "flash_backward": per_step_bwd * steps,
             "fused_adamw_ema": steps} for i in range(2)]


def pipe_phase(torch, dp: dict, diffuseq: dict, update_row: dict) -> dict:
    """Phase 19 (see the module doc). ``dp`` is phase 12's output (its run
    without a group holds (a)), ``diffuseq`` the DiffuSeq phase's (its
    losses hold (f)), ``update_row`` the update's kernel row at a pipe
    rank's element count (checked against the runs')."""
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    from distributed_pipeline_tpu_torch.models.sampling import \
        gpt2_decode_and_score
    from distributed_pipeline_tpu_torch.models.schedule_1f1b import \
        stash_size
    from distributed_pipeline_tpu_torch.data import load_data_from_args

    t0 = time.perf_counter()
    layers, micro, chunks = GPT2_BASE["num_layers"], 2, 4
    held = layers // 2 * chunks * micro           # 48 chunk-layers a step
    scan = ["--scan_layers", "true"]
    out: dict = {"steps": DP_STEPS,
                 "contended": ["scan_layers", "gpipe", "interleaved",
                               "resume", "diffuseq"]}
    with tempfile.TemporaryDirectory() as work:
        # (b) alone (its step and exchange seconds are the ones read), then
        # (a), (c), (d), (f) and (e) on (b)'s step-3 checkpoint side by
        # side (contended)
        run_a, run_b = (os.path.join(work, k) for k in ("scan", "1f1b"))
        run_c, run_d, run_e = (os.path.join(work, k) for k in
                               ("gpipe", "interleaved", "resume"))
        run_f = os.path.join(work, "diffuseq")
        b = dp_run(run_b, PIPE_FLAGS + dp_argv(run_b, 8, 4) + scan + [
            "--pp_schedule", "1f1b", "--pp_chunks", str(chunks),
            "--save_interval", "3"], "pipe 1f1b")
        started = [dp_start(PIPE_FLAGS + dp_argv(run_c, 8, 4) + scan + [
                       "--pp_schedule", "gpipe", "--pp_chunks", str(chunks),
                       "--eval_decode", "true", "--eval_interval", "3",
                       "--save_interval", "3"]),
                   dp_start(PIPE_FLAGS + dp_argv(run_d, 8, 4) + scan + [
                       "--pp_schedule", "interleaved", "--pp_virtual", "2",
                       "--pp_chunks", str(chunks)]),
                   # (f): the DiffuSeq phase's flags
                   dp_start(PIPE_FLAGS + scan + [
                       "--checkpoint_path", run_f, "--batch_size", "256",
                       "--microbatch", "64", "--learning_steps",
                       str(DIFFUSEQ_STEPS), "--ema_rate", "0.5,0.9,0.99",
                       "--attention_impl", "auto", "--fused_update", "auto",
                       "--log_interval", "5", "--save_interval", "0",
                       "--seed", "0"]),
                   # (e): no group
                   dp_start(dp_argv(run_e, 8, 4) + scan + [
                       "--resume_checkpoint",
                       os.path.join(run_b, "model_000003.pt")])]
        a = dp_run(run_a, dp_argv(run_a, 8, 4) + scan, "scan_layers")
        side_a = a["ranks"][0]
        check(side_a["launches"] == {"flash_forward": layers * micro
                                     * DP_STEPS, "flash_backward": layers
                                     * micro * DP_STEPS,
                                     "fused_adamw_ema": DP_STEPS},
              f"scan_layers launches {side_a['launches']}")
        losses_a = [h["loss"] for h in a["steps"]]
        ref = dp["single"]["losses"]
        rel_a = max(abs(x - y) / abs(y) for x, y in zip(losses_a, ref))
        check(len(losses_a) == DP_STEPS and rel_a <= 2e-3,
              f"scan_layers losses {losses_a} vs phase 12's named blocks "
              f"{ref}: relative {rel_a} > 2e-3")
        print(f"# pipeline scan_layers (contended) ({CARD}): losses "
              f"{losses_a} vs phase "
              f"12's named blocks {ref}, largest relative difference "
              f"{rel_a}, step {side_a.get('step_time_s', 0.0):.6f} s, peak "
              f"memory {side_a['peak_memory_bytes']} B", flush=True)
        out["scan_layers"] = {"losses": losses_a, "vs_named_max_rel": rel_a,
                              "step_time_s": side_a.get("step_time_s"),
                              "peak_memory_bytes":
                                  side_a["peak_memory_bytes"],
                              "wall_s": a["wall_s"]}
        ranks_b = pipe_ranks(b, "1f1b", pipe_launches(2 * held, held,
                                                      DP_STEPS))
        losses_b = [h["loss"] for h in b["steps"]]
        held_b = held_to_scan(b["steps"], a["steps"], "pipe 1f1b")
        peak = ranks_b[0]["pipe"]["stash_peak"]
        check(peak == stash_size(chunks, 2) == 3,
              f"1f1b stage 0's stash peaked at {peak}, not stash_size(4, 2)"
              f" = 3")
        owned = ranks_b[0]["layout"]["owned"]
        check(owned == update_row["elements"]
              and [x["layout"]["owned"] for x in ranks_b] == [owned] * 2,
              f"pipe ranks update {[x['layout']['owned'] for x in ranks_b]}"
              f" elements, the update row {update_row['elements']}")
        out["1f1b"] = {"losses": losses_b, "vs_scan": held_b,
                       "grad_norms": [h["grad_norm"] for h in b["steps"]],
                       "stash_peak": peak, "ranks": ranks_b,
                       "wall_s": b["wall_s"]}
        saved = torch.load(os.path.join(run_b, "model_000003.pt"),
                           weights_only=True, mmap=True)
        depth = saved["backbone.blocks.qkv"].shape[0]
        check(depth == layers, f"1f1b's step-3 checkpoint holds "
                               f"{depth} layers of qkv, not {layers}")
        del saved
        torch.cuda.empty_cache()
        c = dp_finish(started[0], run_c, "pipe gpipe")
        d = dp_finish(started[1], run_d, "pipe interleaved")
        f = dp_finish(started[2], run_f, "pipe diffuseq")
        e = dp_finish(started[3], run_e, "resume")
        # (c): an eval of 48 forwards, stage 0's decode prefill of 12
        ranks_c = pipe_ranks(c, "gpipe (contended)", pipe_launches(
            held, held, DP_STEPS, (held + layers, held)))
        losses_c = [h["loss"] for h in c["steps"]]
        held_c = held_to_scan(c["steps"], a["steps"], "pipe gpipe")
        decodes = ranks_c[0]["eval_decodes"]
        check([x["step"] for x in decodes] == [3]
              and not ranks_c[1]["eval_decodes"],
              f"gpipe eval decodes {decodes} / rank 1 "
              f"{ranks_c[1]['eval_decodes']}")
        accs = [float(row["decode_acc"]) for row in c["rows"]
                if row.get("decode_acc")]
        check(accs == [x["value"] for x in decodes],
              f"gpipe decode_acc rows {accs} vs the decodes {decodes}")
        with open(os.path.join(run_c, "training_args.json")) as fh:
            targs = json.load(fh)
        model = create_model_from_config(**targs, device="cuda")
        model.load_state_dict(torch.load(os.path.join(
            run_c, "model_000003.pt"), weights_only=True))
        batch = next(load_data_from_args(
            "valid", **{**targs, "deterministic": True, "batch_size": 8,
                        "num_loader_proc": 0, "data_loader_workers": 0,
                        "host_sharded": False}))
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        with torch.no_grad():
            pred, acc = gpt2_decode_and_score(model.eval(), batch)
        import hashlib
        sha = hashlib.sha256(pred.cpu().numpy().tobytes()).hexdigest()
        check(sha == decodes[0]["tokens_sha256"]
              and float(acc) == decodes[0]["value"],
              f"gpipe's step-3 decode ({decodes[0]}) differs from "
              f"gpt2_decode of its step-3 checkpoint at --pipe 1 ({acc}, "
              f"{sha})")
        del model, batch, pred
        torch.cuda.empty_cache()
        print(f"# pipeline gpipe ({CARD}): vs scan_layers {held_c}; eval "
              f"decodes {decodes}; the step-3 tokens equal gpt2_decode of "
              f"model_000003.pt at --pipe 1", flush=True)
        out["gpipe"] = {"losses": losses_c, "vs_scan": held_c,
                        "grad_norms": [h["grad_norm"] for h in c["steps"]],
                        "eval_decodes": decodes, "ranks": ranks_c,
                        "wall_s": c["wall_s"]}
        ranks_d = pipe_ranks(d, "interleaved (contended)",
                             pipe_launches(2 * held, held, DP_STEPS))
        losses_d = [h["loss"] for h in d["steps"]]
        held_d = held_to_scan(d["steps"], a["steps"], "pipe interleaved")
        check([x["pipe"]["layers"] for x in ranks_d]
              == [[0, 1, 2, 6, 7, 8], [3, 4, 5, 9, 10, 11]],
              f"interleaved layers {[x['pipe']['layers'] for x in ranks_d]}")
        out["interleaved"] = {"losses": losses_d, "vs_scan": held_d,
                              "ranks": ranks_d, "wall_s": d["wall_s"]}
        # (e)
        side_e = e["ranks"][0]
        rest = DP_STEPS - 3
        check(side_e["launches"] == {"flash_forward": layers * micro * rest,
                                     "flash_backward": layers * micro * rest,
                                     "fused_adamw_ema": rest},
              f"resume launches {side_e['launches']}")
        check([h["step"] for h in e["steps"]] == [4, 5],
              f"resumed steps {[h['step'] for h in e['steps']]}")
        losses_e = [h["loss"] for h in e["steps"]]
        rel_e = max(abs(x - y) / abs(y) for x, y in zip(losses_e,
                                                        losses_b[3:]))
        # step 4 runs the saved weights (within the chunks' f32 loss
        # sums); step 5 follows an update from other chunking's gradients
        rel_e4 = abs(losses_e[0] - losses_b[3]) / abs(losses_b[3])
        check(rel_e4 <= 1e-6 and rel_e <= 5e-3,
              f"resumed steps 4-5 {losses_e} vs 1f1b's {losses_b[3:]}: "
              f"step 4 within 1e-6 ({rel_e4}), both within 5e-3 relative "
              f"({rel_e})")
        worst_e = max(abs(x - y) for x, y in zip(losses_e, losses_b[3:]))
        print(f"# pipeline resume ({CARD}): 1f1b's step-3 files ({layers} "
              f"stacked layers) at --pipe 1: steps 4-5 {losses_e} vs "
              f"1f1b's {losses_b[3:]}, step 4 relative {rel_e4}, largest "
              f"difference {worst_e}", flush=True)
        out["resume"] = {"losses": losses_e, "vs_1f1b_max_abs": worst_e,
                         "wall_s": e["wall_s"]}
        torch.cuda.empty_cache()
        # (f)
        ranks_f = pipe_ranks(f, "diffuseq (contended)", [{
            "flash_forward": 0, "flash_backward": 0,
            "fused_adamw_ema": DIFFUSEQ_STEPS}] * 2)
        losses_f = [h["loss"] for h in f["steps"]]
        ref_f = diffuseq["losses"]
        rel_f = [abs(x - y) / abs(y) for x, y in zip(losses_f, ref_f)]
        check(len(losses_f) == DIFFUSEQ_STEPS and max(rel_f[:3]) <= 2e-3,
              f"pipe diffuseq losses {losses_f[:3]} vs the DiffuSeq "
              f"phase's {ref_f[:3]}: relative {rel_f[:3]} > 2e-3")
        print(f"# pipeline diffuseq ({CARD}): first 3 losses relative "
              f"{rel_f[:3]} to the DiffuSeq phase's, all {DIFFUSEQ_STEPS} "
              f"largest {max(rel_f)}", flush=True)
        out["diffuseq"] = {"losses": losses_f, "vs_phase_rel": rel_f,
                           "ranks": ranks_f, "wall_s": f["wall_s"]}
    update_row["launches"] = [x["launches"]["fused_adamw_ema"]
                              for x in ranks_b]
    out["phase_s"] = time.perf_counter() - t0
    print(f"# pipeline ({CARD}): walls {b['wall_s']:.1f} (1f1b alone), "
          f"then {a['wall_s']:.1f}, {c['wall_s']:.1f}, {d['wall_s']:.1f}, "
          f"{f['wall_s']:.1f} and {e['wall_s']:.1f} side by side "
          f"(contended); phase "
          f"{out['phase_s']:.1f} s of its {PIPE_BUDGET_S:.0f} s budget",
          flush=True)
    check(out["phase_s"] <= PIPE_BUDGET_S,
          f"phase 19 took {out['phase_s']:.1f} s, over {PIPE_BUDGET_S} s")
    return out


# ------------------------------------------------ the MPMD pipeline (20)

# the phase's wall budget: three run.train --mpmd drivers (two stage
# processes each on cuda:0; the killed stage's ring starts a third) and
# the in-process references of (a) and (c) beside (b) and (c)
MPMD_BUDGET_S = 120.0
MPMD_CHUNKS = 4
MPMD_DIFFUSEQ_STEPS = 3
MPMD_FLAGS = ["--scan_layers", "true", "--mpmd", "true", "--mpmd_stages",
              "2", "--pp_schedule", "1f1b", "--pp_chunks", str(MPMD_CHUNKS)]
# what --mpmd refuses but at its default: the stages keep no EMA, fuse no
# update, chunk the batch by --pp_chunks and snapshot on their own
MPMD_DROPPED = ("--microbatch", "--ema_rate", "--fused_update",
                "--save_interval")


def mpmd_gpt2_argv(run: str) -> list:
    """Phase 19's GPT-2 base flags (batch 8, 5 steps) under --mpmd."""
    argv = dp_argv(run, 8, 8)
    keep = [i for i in range(0, len(argv), 2)
            if argv[i] not in MPMD_DROPPED]
    return [x for i in keep for x in argv[i:i + 2]] + MPMD_FLAGS


def mpmd_diffuseq_argv(run: str) -> list:
    """DiffuSeq-base at seq 128 under --mpmd: batch 8 in 4 chunks, 3 steps
    (the JAX bench leg ``diffuseq-base-seq128-mpmd-pipe``'s traffic at
    full width)."""
    return ["--checkpoint_path", run, "--model_family", "diffuseq",
            "--model_size", "base", "--vocab_size", "8192", "--seq_len",
            "128", "--hidden_size", "768", "--num_layers", "12",
            "--num_heads", "12", "--diffusion_steps", "2000",
            "--noise_schedule", "sqrt", "--dtype", "bfloat16",
            "--dataset", "synthetic-seq2seq", "--batch_size", "8",
            "--learning_steps", str(MPMD_DIFFUSEQ_STEPS), "--lr", "1e-3",
            "--attention_impl", "auto", "--seed", "0", *MPMD_FLAGS]


def tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def mpmd_config_of(run: str, timeout_s: float = 120.0) -> dict:
    """The ``mpmd_config.json`` a driver writes as it starts."""
    path = os.path.join(run, "mpmd_config.json")
    deadline = time.perf_counter() + timeout_s
    while not os.path.exists(path):
        check(time.perf_counter() < deadline, f"no {path} after {timeout_s} s")
        time.sleep(0.1)
    with open(path) as f:
        return json.load(f)


def mpmd_finish(job: dict, run: str, what: str) -> dict:
    """Wait for a ``dp_start`` of a ``run.train --mpmd`` driver; returns
    its summary line, its result (``mpmd_result.json``), its config and
    each stage's last clean-exit sidecar; prints the run dir's bytes and
    removes it. A failed driver's stage logs go to stderr first."""
    job["thread"].join()
    if job["proc"].returncode != 0:
        for d, _, files in os.walk(run):
            for f in files:
                if f.endswith(".log"):
                    with open(os.path.join(d, f)) as fh:
                        print(f"== {d}/{f}", fh.read()[-3000:],
                              file=sys.stderr)
    stdout, _stderr, wall = dp_wait(job, f"mpmd {what}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    with open(os.path.join(run, "mpmd_result.json")) as f:
        result = json.load(f)
    with open(os.path.join(run, "mpmd_config.json")) as f:
        config = json.load(f)
    stages = []
    for s in range(2):
        sd = os.path.join(run, f"stage_{s}")
        names = sorted(n for n in os.listdir(sd)
                       if n.startswith("goodput_attempt"))
        check(bool(names), f"mpmd {what}: stage {s} left no sidecar")
        with open(os.path.join(sd, names[-1])) as f:
            stages.append(json.load(f))
    size = tree_bytes(run)
    print(f"# mpmd {what} ({CARD}): run dir {size} B, removed", flush=True)
    shutil.rmtree(run, ignore_errors=True)
    return {"summary": summary, "result": result, "config": config,
            "stages": stages, "run_dir_bytes": size, "wall_s": wall}


def mpmd_stage_rows(r: dict, what: str) -> list:
    """Each stage's sidecar, printed: peak memory, seconds a step (the mean
    after the first), link wait, the bytes of an act frame and of a
    snapshot; no plain call on the card."""
    rows = []
    for side in r["stages"]:
        s = side["stage"]
        check(side["device"].startswith("cuda"),
              f"mpmd {what} stage {s} ran on {side['device']}")
        check(not any(side["plain_calls"].values()),
              f"mpmd {what} stage {s}: plain calls {side['plain_calls']}")
        steps = side["step_s"]
        steady = statistics.mean(steps[1:]) if len(steps) > 1 else steps[0]
        row = {"stage": s, "layers": side["layers"],
               "launches": side["launches"],
               "peak_memory_bytes": side["peak_memory_bytes"],
               "step_s": steps, "steady_step_s": steady,
               "step_data_s": side["step_data_s"],
               "step_math_s": side["step_math_s"],
               "link_wait_s": side["link_wait_s"],
               "save_s": side["save_s"], "startup_s": side["startup_s"],
               "act_frame_bytes": side["act_frame_bytes"],
               "snapshot_bytes": side["snapshot_bytes"]}
        print(f"# mpmd {what} stage {s} ({CARD}): layers {side['layers']}, "
              f"launches {side['launches']}, peak memory "
              f"{side['peak_memory_bytes']} B, steps {steps} s (steady "
              f"{steady:.6f} s; data {side['step_data_s']}, math "
              f"{side['step_math_s']}), link_wait "
              f"{side['link_wait_s']:.6f} s, "
              f"save {side['save_s']:.6f} s, startup "
              f"{side['startup_s']:.6f} s, act frame "
              f"{side['act_frame_bytes']} B, snapshot "
              f"{side['snapshot_bytes']} B", flush=True)
        rows.append(row)
    return rows


def mpmd_reference(torch, config: dict, steps: int) -> list:
    """``run_pipeline_inprocess`` of a driver's own config on the card:
    the same StageMath in this process, over in-memory links."""
    from distributed_pipeline_tpu_torch.mpmd.stage_math import \
        run_pipeline_inprocess
    out = run_pipeline_inprocess(config, steps)
    losses = out["losses"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def mpmd_fold(r: dict, what: str) -> dict:
    gp = r["result"]["goodput"]
    check("link_wait_s" in gp and abs(gp["accounted_frac"] - 1.0) <= 0.01,
          f"mpmd {what}: accounted_frac {gp.get('accounted_frac')}, "
          f"link_wait_s {gp.get('link_wait_s')}")
    return {k: gp[k] for k in ("wall_s", "goodput", "accounted_frac",
                               "link_wait_s", "save_s", "startup_s",
                               "restore_s", "recompute_s", "lost_s",
                               "downtime_s", "attempts")}


def mpmd_phase(torch, pipe: dict) -> dict:
    """Phase 20 (see the module doc). ``pipe`` is phase 19's output: its
    ``--scan_layers`` run without a group holds (a)'s first two steps."""
    t0 = time.perf_counter()
    layers = GPT2_BASE["num_layers"]
    out: dict = {"steps": DP_STEPS, "chunks": MPMD_CHUNKS,
                 "contended": ["gpt2", "gpt2_kill", "diffuseq"]}
    with tempfile.TemporaryDirectory() as work:
        free = shutil.disk_usage(work).free
        print(f"# mpmd ({CARD}): {free} B free under {work} for the run "
              f"dirs", flush=True)
        run_a, run_b, run_c = (os.path.join(work, k) for k in
                               ("gpt2", "gpt2_kill", "diffuseq"))
        # (a), (b) and (c) side by side, beside the in-process references
        # of (a) and (c): their seconds share the card and the host
        # (contended; with (a) alone the phase does not fit its budget)
        job_a = dp_start(mpmd_gpt2_argv(run_a))
        job_b = dp_start(mpmd_gpt2_argv(run_b), {"DPT_MPMD_KILL": "1:3"})
        job_c = dp_start(mpmd_diffuseq_argv(run_c))
        config_a = mpmd_config_of(run_a)
        config_c = mpmd_config_of(run_c)
        ref_a = mpmd_reference(torch, config_a, DP_STEPS)
        ref_c = mpmd_reference(torch, config_c, MPMD_DIFFUSEQ_STEPS)
        a = mpmd_finish(job_a, run_a, "gpt2 (contended)")
        b = mpmd_finish(job_b, run_b, "gpt2 kill 1:3 (contended)")
        c = mpmd_finish(job_c, run_c, "diffuseq (contended)")
        check(a["config"] == config_a and c["config"] == config_c,
              "mpmd: a driver's config changed while it ran")
    # (a)
    losses = a["result"]["losses"]
    sm = a["summary"]
    check(sm["mode"] == "mpmd" and sm["rewinds"] == 0
          and sm["attempts_per_stage"] == [1, 1] and len(losses) == DP_STEPS,
          f"mpmd gpt2 summary {sm}")
    rel = [abs(x - y) / abs(y) for x, y in zip(losses, ref_a)]
    check(len(ref_a) == DP_STEPS and max(rel) <= 1e-6,
          f"mpmd gpt2 losses {losses} vs the in-process runner {ref_a}: "
          f"relative {rel} > 1e-6")
    single = pipe["scan_layers"]["losses"]
    rel19 = [abs(x - y) / abs(y) for x, y in zip(losses[:2], single[:2])]
    check(rel19[0] <= 1e-6 and rel19[1] <= 5e-3,
          f"mpmd gpt2 steps 1-2 {losses[:2]} vs phase 19 (a)'s "
          f"{single[:2]}: relative {rel19} (1e-6, 5e-3)")
    rows_a = mpmd_stage_rows(a, "gpt2 (contended)")
    per = layers // 2 * MPMD_CHUNKS * DP_STEPS        # 120 chunk-layers
    want = [{"flash_forward": 2 * per, "flash_backward": per,
             "fused_adamw_ema": 0},
            {"flash_forward": per, "flash_backward": per,
             "fused_adamw_ema": 0}]
    check([r["launches"] for r in rows_a] == want,
          f"mpmd gpt2 launches {[r['launches'] for r in rows_a]}, "
          f"expected {want}")
    fold_a = mpmd_fold(a, "gpt2")
    print(f"# mpmd gpt2 (contended) ({CARD}): losses {losses} vs the "
          f"in-process runner {ref_a}, largest relative difference "
          f"{max(rel)}; steps 1-2 relative to phase 19 (a) {rel19}; {sm}; "
          f"fold {fold_a}; wall "
          f"{a['wall_s']:.1f} s", flush=True)
    out["gpt2"] = {"losses": losses, "inprocess_losses": ref_a,
                   "vs_inprocess_max_rel": max(rel),
                   "vs_phase19_rel": rel19, "stages": rows_a,
                   "goodput": fold_a, "run_dir_bytes": a["run_dir_bytes"],
                   "wall_s": a["wall_s"]}
    # (b)
    sm_b = b["summary"]
    check(sm_b["rewinds"] == 1 and sm_b["attempts_per_stage"] == [1, 2],
          f"mpmd kill 1:3 summary {sm_b}")
    check(b["result"]["losses"] == losses,
          f"mpmd kill 1:3 losses {b['result']['losses']} vs (a)'s {losses}")
    fold_b = mpmd_fold(b, "gpt2 kill 1:3")
    print(f"# mpmd gpt2 kill 1:3 (contended) ({CARD}): {sm_b}; losses "
          f"bitwise (a)'s; fold {fold_b}; wall {b['wall_s']:.1f} s",
          flush=True)
    out["gpt2_kill"] = {"summary": sm_b, "goodput": fold_b,
                        "stages": mpmd_stage_rows(
                            b, "gpt2 kill 1:3 (contended)"),
                        "run_dir_bytes": b["run_dir_bytes"],
                        "wall_s": b["wall_s"]}
    # (c)
    losses_c = c["result"]["losses"]
    rel_c = [abs(x - y) / abs(y) for x, y in zip(losses_c, ref_c)]
    check(c["summary"]["rewinds"] == 0
          and len(losses_c) == len(ref_c) == MPMD_DIFFUSEQ_STEPS
          and max(rel_c) <= 1e-5,
          f"mpmd diffuseq losses {losses_c} vs the in-process runner "
          f"{ref_c}: relative {rel_c} > 1e-5")
    fold_c = mpmd_fold(c, "diffuseq")
    print(f"# mpmd diffuseq (contended) ({CARD}): losses {losses_c} vs "
          f"the in-process runner {ref_c}, relative {rel_c}; fold "
          f"{fold_c}; wall "
          f"{c['wall_s']:.1f} s", flush=True)
    out["diffuseq"] = {"losses": losses_c, "inprocess_losses": ref_c,
                       "vs_inprocess_max_rel": max(rel_c),
                       "stages": mpmd_stage_rows(c, "diffuseq (contended)"),
                       "goodput": fold_c,
                       "run_dir_bytes": c["run_dir_bytes"],
                       "wall_s": c["wall_s"]}
    out["phase_s"] = time.perf_counter() - t0
    print(f"# mpmd ({CARD}): walls {a['wall_s']:.1f}, {b['wall_s']:.1f} "
          f"and {c['wall_s']:.1f} s side by side (contended); phase "
          f"{out['phase_s']:.1f} s of its {MPMD_BUDGET_S:.0f} s budget",
          flush=True)
    check(out["phase_s"] <= MPMD_BUDGET_S,
          f"phase 20 took {out['phase_s']:.1f} s, over {MPMD_BUDGET_S} s")
    return out


# ------------------------------------------------- the run readers (16)

# ------------------------------------ the pipe's compositions (phase 21)

# the phase's wall budget: (a)'s four ranks alone, then (b), (c) (four
# ranks each) and (d)'s two pipe ranks side by side ((d)'s one process
# runs in phase 13); 94-95 s measured on the H100 with that process here
# too (the target: under 90 s)
COMPOSE_BUDGET_S = 120.0
# phase 19's flags with one EMA rate (the losses do not read the EMA; a
# rank's final save and the update carry two fewer copies)
COMPOSE_EMA = ["--ema_rate", "0.99"]
COMPOSE_FLAGS = ["--distributed", "--nprocs", "4", "--pipe", "2"]
# step 1 of the ring against the GPipe run (the largest distance of a
# GPT-2 sp2 run from no group seen on the H100), every step within the
# pipe bar (phase 19's)
RING_STEP1_REL = 1.109e-4


def fsdp_pipe_elements(cfg: dict, stages: int, fsdp: int) -> int:
    """The elements a ``--pipe stages --fsdp fsdp`` rank's update covers:
    its fsdp piece of its stage's embed-cut block weights (qkv, out, wi,
    wo), its stage's LayerNorm rows whole, and the rest of the model
    (GPT-2's vocab 50257 is odd: the table's fsdp cut drops and it stays
    whole, as ``fix_spec`` drops it)."""
    from distributed_pipeline_tpu_torch.models import \
        create_model_from_config
    model = create_model_from_config(**cfg, scan_layers=True, device="meta")
    cut = sum(p.numel() for n, p in model.named_parameters()
              if ".blocks." in n
              and n.split(".")[-1] in ("qkv", "out", "wi", "wo"))
    rows = sum(p.numel() for n, p in model.named_parameters()
               if ".blocks.ln" in n)
    rest = sum(p.numel() for n, p in model.named_parameters()
               if ".blocks." not in n)
    return cut // (stages * fsdp) + rows // stages + rest


def moe_train_argv(run: str, cfg: dict, steps: int, batch: int, micro: int,
                   extra=()) -> list:
    """Phase 13's ``run.train`` flags for an MoE configuration."""
    dataset = ("synthetic-lm" if cfg["model_family"] == "gpt2"
               else "synthetic-seq2seq")
    return (["--checkpoint_path", run, "--dataset", dataset]
            + cfg_argv(cfg)
            + ["--batch_size", str(batch), "--microbatch", str(micro),
               "--learning_steps", str(steps), "--lr", "3e-4",
               "--ema_rate", "0.9999", "--attention_impl", "auto",
               "--fused_update", "auto", "--log_interval", str(steps),
               "--save_interval", "0", "--seed", "0"] + list(extra))


def compose_ranks(r: dict, what: str, want: list, world: int) -> list:
    """Each rank's sidecar of a phase-21 run, checked: gloo on ``cuda:0``
    (a world of one: no group), the launches ``want[rank]``, no plain
    call, every rank's losses and final parameters equal; printed with
    the step time, the exchange's and the gathers' bytes and the peak
    memory."""
    ranks = r["ranks"]
    check(len(ranks) == world, f"{what}: {len(ranks)} sidecars")
    for side in ranks:
        i = side["rank"]
        check(world == 1 or (side["backend"] == "gloo"
                             and side["device"] == "cuda:0"),
              f"{what} rank {i}: {side['backend']} {side['device']}")
        check(side["launches"] == want[i],
              f"{what} rank {i}: launches {side['launches']}, expected "
              f"{want[i]}")
        check(not any(side["plain_calls"].values()),
              f"{what} rank {i}: plain calls {side['plain_calls']}")
        steps = max(side["steps"], 1)
        print(f"# compositions {what} rank {i} ({CARD}): mesh "
              f"{json.dumps(side['mesh'])}, stage "
              f"{json.dumps(side['pipe'])}, launches {side['launches']}, "
              f"lse backward {side['lse_backward_launches']}, step "
              f"{side.get('step_time_s', 0.0):.6f} s, pipe_p2p "
              f"{side['pipe_p2p_s_per_step']:.6f} s a step, "
              f"{side['pipe_bytes']} B sent, fsdp gathers "
              f"{side['fsdp_gathers']} of {side['fsdp_gathered_bytes']} B "
              f"({side['fsdp_gathered_bytes'] / steps:.0f} B a step), "
              f"all-reduce {side['allreduce_s_per_step']:.6f} s and "
              f"reduce-scatter {side['reduce_scatter_s_per_step']:.6f} s a "
              f"step, update over {side['layout']['owned']} of "
              f"{side['layout']['local']} local elements, peak memory "
              f"{side['peak_memory_bytes']} B", flush=True)
    for side in ranks[1:]:
        check([h["loss"] for h in side["history"]]
              == [h["loss"] for h in ranks[0]["history"]],
              f"{what}: rank {side['rank']} logged other losses")
        check(side["params_sha256"] == ranks[0]["params_sha256"],
              f"{what}: rank {side['rank']}'s final parameters differ")
    return [{k: side.get(k) for k in (
        "rank", "mesh", "pipe", "launches", "lse_backward_launches",
        "plain_calls", "pipe_p2p_s_per_step", "pipe_bytes", "fsdp_gathers",
        "fsdp_gathered_bytes", "fsdp_largest_unit_bytes",
        "allreduce_s_per_step", "reduce_scatter_s_per_step",
        "all_gather_s_per_step", "step_time_s", "tokens_per_sec",
        "peak_memory_bytes", "layout", "update_share", "params_sha256")}
        for side in ranks]


def ring_held(steps: list, ref: list, what: str) -> dict:
    """The ring-in-stage run's losses against the GPipe run's: step 1
    within ``RING_STEP1_REL`` (the hops' bf16 partial outputs folded in
    f32, where one kernel call attends the whole row), every step within
    5e-3 (phase 19's pipe bar), grad norms within 3e-2 (phase 12's)."""
    got = [h["loss"] for h in steps]
    rels = [abs(x - y) / abs(y) for x, y in zip(got, ref["losses"])]
    gn = max(abs(h["grad_norm"] - g) / g
             for h, g in zip(steps, ref["grad_norms"]))
    check(len(got) == len(ref["losses"]) and rels[0] <= RING_STEP1_REL
          and max(rels) <= 5e-3 and gn <= 3e-2,
          f"{what}: losses {got} vs {ref['losses']}: relative {rels} "
          f"(step 1 within {RING_STEP1_REL}, all within 5e-3), grad norms "
          f"relative {gn} (3e-2)")
    return {"max_rel": max(rels), "step1_rel": rels[0],
            "grad_norm_max_rel": gn}


def compose_phase(torch, pipe: dict, moe: dict, rows: dict) -> dict:
    """Phase 21 (see the module doc). ``pipe`` is phase 19's output (its
    1F1B and GPipe runs hold (a) and (c)), ``moe`` phase 13's GPT-2 moe8
    record: its run without remat holds (d)'s one process, which ran
    beside phase 13's runs (``scan_run``, taken out here), and that
    process holds (d)'s pipe run; ``rows`` the update's kernel rows at
    the new element counts (checked against the runs')."""
    t0 = time.perf_counter()
    layers, micro, steps = GPT2_BASE["num_layers"], 2, DP_STEPS
    scan = ["--scan_layers", "true"]
    half = layers // 2
    out: dict = {"steps": steps, "contended": ["zero1", "sequence",
                                               "moe8_scan", "moe8_pipe"]}
    d1 = moe.pop("scan_run")
    named = moe["no_remat"]
    with tempfile.TemporaryDirectory() as work:
        run = {k: os.path.join(work, k) for k in (
            "fsdp", "zero1", "sequence", "moe8_pipe")}
        # (a) alone: --pipe 2 --fsdp 2, batch 8 (4 a row group) in
        # microbatches of 4 (2), one-row chunks as phase 19's 1F1B
        a = dp_run(run["fsdp"], COMPOSE_FLAGS + ["--fsdp", "2"]
                   + dp_argv(run["fsdp"], 4, micro) + scan + COMPOSE_EMA
                   + ["--pp_schedule", "1f1b", "--pp_chunks", "2"],
                   "pipe2 fsdp2")
        # (b), (c) and (d) side by side (contended)
        started = {
            "zero1": dp_start(COMPOSE_FLAGS + [
                "--dp", "2", "--shard_optimizer", "true"]
                + dp_argv(run["zero1"], 4, micro) + scan + COMPOSE_EMA
                + ["--pp_schedule", "1f1b", "--pp_chunks", "2"]),
            # a 1F1B request: a ring inside a stage takes GPipe
            "sequence": dp_start(COMPOSE_FLAGS + ["--sequence", "2"]
                                 + dp_argv(run["sequence"], 8, 4) + scan
                                 + COMPOSE_EMA + ["--pp_schedule", "1f1b",
                                    "--pp_chunks", "4"]),
            "moe8_pipe": dp_start(PIPE_FLAGS + moe_train_argv(
                run["moe8_pipe"], GPT2_MOE8, MOE_STEPS, 8, 4, scan + [
                    "--pp_schedule", "1f1b", "--pp_chunks", "4"]))}
        done = {k: dp_finish(job, run[k], k) for k, job in started.items()}
    # (a): 2 microbatches of 2 one-row chunks through 6 layers a rank;
    # the B slot recomputes the stage
    per = half * 2 * micro
    ranks_a = compose_ranks(a, "pipe2 fsdp2", [{
        "flash_forward": 2 * per * steps, "flash_backward": per * steps,
        "fused_adamw_ema": steps}] * 4, 4)
    elements = rows["fsdp"]["elements"]
    check([x["layout"]["owned"] for x in ranks_a] == [elements] * 4
          and [x["layout"]["local"] for x in ranks_a] == [elements] * 4,
          f"pipe2 fsdp2 ranks update "
          f"{[x['layout']['owned'] for x in ranks_a]} elements, "
          f"expected {elements} (the local count)")
    su = ranks_a[0]["layout"]["stage_unit_elements"]
    check(all(x["fsdp_gathers"] == micro * steps
              and x["fsdp_gathered_bytes"] == 4 * su * micro * steps
              for x in ranks_a),
          f"pipe2 fsdp2 gathers {[x['fsdp_gathers'] for x in ranks_a]} "
          f"of {[x['fsdp_gathered_bytes'] for x in ranks_a]} B: one "
          f"stage unit ({su} elements) a microbatch")
    from fractions import Fraction
    n = sum(Fraction(x["update_share"]) for x in ranks_a)
    check(n == ranks_a[0]["layout"]["n"],
          f"pipe2 fsdp2: the ranks' update shares sum to {n}, not the "
          f"model's {ranks_a[0]['layout']['n']}")
    ref_b = pipe["1f1b"]
    held_a = held_to_scan(a["steps"], [
        {"loss": x, "grad_norm": g} for x, g in
        zip(ref_b["losses"], ref_b["grad_norms"])], "pipe2 fsdp2")
    peak19 = [x["peak_memory_bytes"] for x in ref_b["ranks"]]
    print(f"# compositions pipe2 fsdp2 (alone) ({CARD}): vs phase 19's "
          f"1F1B {held_a}; peak memory a rank "
          f"{[x['peak_memory_bytes'] for x in ranks_a]} B against phase "
          f"19's 1F1B {peak19} B; gathered {4 * su * micro} B a step a "
          f"rank ({micro} stage gathers of {4 * su} B)", flush=True)
    out["fsdp"] = {"losses": [h["loss"] for h in a["steps"]],
                   "grad_norms": [h["grad_norm"] for h in a["steps"]],
                   "vs_pipe_1f1b": held_a, "ranks": ranks_a,
                   "phase19_1f1b_peak_bytes": peak19,
                   "gathered_bytes_per_step": 4 * su * micro,
                   "wall_s": a["wall_s"]}
    # (b): the same chunks; the owned range half a rank's buffer
    b = done["zero1"]
    ranks_b = compose_ranks(b, "pipe2 zero1 (contended)", [{
        "flash_forward": 2 * per * steps, "flash_backward": per * steps,
        "fused_adamw_ema": steps}] * 4, 4)
    check([x["layout"]["owned"] for x in ranks_b]
          == [rows["zero1"]["elements"]] * 4,
          f"pipe2 zero1 owned {[x['layout']['owned'] for x in ranks_b]}, "
          f"expected {rows['zero1']['elements']}")
    held_b = held_to_scan(b["steps"], a["steps"], "pipe2 zero1 vs (a)")
    bitwise_b = [h["loss"] for h in b["steps"]] == out["fsdp"]["losses"]
    out["zero1"] = {"losses": [h["loss"] for h in b["steps"]],
                    "vs_fsdp": held_b, "bitwise_vs_fsdp": bitwise_b,
                    "ranks": ranks_b, "wall_s": b["wall_s"]}
    # (c): sequence index r // 2 holds positions [512 i, 512 (i + 1));
    # index 0 attends its own slice (one launch a layer-chunk), index 1
    # its own and the earlier one (two); GPipe: no recompute
    c = done["sequence"]
    one = half * 4 * 2 * steps
    want_c = [{"flash_forward": one * (1 + r // 2),
               "flash_backward": one * (1 + r // 2),
               "fused_adamw_ema": steps} for r in range(4)]
    ranks_c = compose_ranks(c, "pipe2 sequence2 (contended)", want_c, 4)
    check([x["pipe"]["schedule"] for x in ranks_c] == ["gpipe"] * 4
          and all(x["lse_backward_launches"] == w["flash_backward"]
                  for x, w in zip(ranks_c, want_c)),
          f"pipe2 sequence2: schedules "
          f"{[x['pipe']['schedule'] for x in ranks_c]}, g_lse arm "
          f"{[x['lse_backward_launches'] for x in ranks_c]}")
    held_c = ring_held(c["steps"], pipe["gpipe"], "pipe2 sequence2")
    out["sequence"] = {"losses": [h["loss"] for h in c["steps"]],
                       "vs_pipe_gpipe": held_c, "ranks": ranks_c,
                       "wall_s": c["wall_s"]}
    # (d): the stacked moe8 model against phase 13's named blocks, then
    # at --pipe 2 (GPipe, 3 groups a stage) against the one process
    d2 = done["moe8_pipe"]
    moe_per = layers * 2 * MOE_STEPS
    ranks_d1 = compose_ranks(d1, "moe8 scan_layers (beside phase 13's "
                             "runs: contended)", [{
                                 "flash_forward": moe_per,
                                 "flash_backward": moe_per,
                                 "fused_adamw_ema": MOE_STEPS}], 1)
    held_d1 = held_to_scan(d1["steps"], [
        {"loss": x, "grad_norm": g} for x, g in
        zip(named["losses"], named["grad_norms"])], "moe8 scan_layers")
    aux1 = [h["moe_aux"] for h in d1["steps"]]
    check(max(abs(x - y) / y for x, y in zip(aux1, named["moe_aux"]))
          <= 5e-3, f"moe8 scan_layers moe_aux {aux1} vs "
                   f"{named['moe_aux']}")
    pipe_per = half * 4 * 2 * MOE_STEPS
    ranks_d2 = compose_ranks(d2, "moe8 pipe2 (contended)", [{
        "flash_forward": pipe_per, "flash_backward": pipe_per,
        "fused_adamw_ema": MOE_STEPS}] * 2, 2)
    check([x["pipe"]["schedule"] for x in ranks_d2] == ["gpipe"] * 2
          and [x["layout"]["owned"] for x in ranks_d2]
          == [rows["moe8_pipe"]["elements"]] * 2,
          f"moe8 pipe2: schedules {[x['pipe']['schedule'] for x in ranks_d2]}"
          f", owned {[x['layout']['owned'] for x in ranks_d2]}")
    held_d2 = held_to_scan(d2["steps"], d1["steps"], "moe8 pipe2")
    # the aux at step 1 (the same weights: the stages' group sums over
    # the chunks) within 1e-6; later steps follow weights a bf16-rounded
    # chunk gradient apart, and the top-k routing turns that into larger
    # aux moves than the loss's (printed, held finite; the losses hold
    # the pipe bar)
    aux2 = [h["moe_aux"] for h in d2["steps"]]
    rel_aux = [abs(x - y) / y for x, y in zip(aux2, aux1)]
    check(rel_aux[0] <= 1e-6 and all(math.isfinite(x) for x in aux2),
          f"moe8 pipe2 moe_aux {aux2} vs one process {aux1}: {rel_aux}")
    out["moe8"] = {
        "scan": {"losses": [h["loss"] for h in d1["steps"]],
                 "moe_aux": aux1, "vs_named": held_d1,
                 "bitwise_vs_named": [h["loss"] for h in d1["steps"]]
                 == named["losses"], "ranks": ranks_d1,
                 "wall_s": d1["wall_s"]},
        "pipe": {"losses": [h["loss"] for h in d2["steps"]],
                 "moe_aux": aux2, "vs_scan": held_d2,
                 "moe_aux_rel": rel_aux, "ranks": ranks_d2,
                 "wall_s": d2["wall_s"]}}
    print(f"# compositions ({CARD}): zero1 vs (a) {held_b} (bitwise "
          f"{bitwise_b}); sequence vs phase 19's GPipe {held_c}; moe8 "
          f"scan_layers vs phase 13's named blocks {held_d1} (bitwise "
          f"{out['moe8']['scan']['bitwise_vs_named']}); moe8 pipe2 vs the "
          f"one process {held_d2}, moe_aux relative {rel_aux}", flush=True)
    for key, r in (("fsdp", ranks_a), ("zero1", ranks_b),
                   ("moe8_pipe", ranks_d2)):
        rows[key]["launches"] = [x["launches"]["fused_adamw_ema"] for x in r]
    out["phase_s"] = time.perf_counter() - t0
    print(f"# compositions ({CARD}): walls {a['wall_s']:.1f} (pipe2 fsdp2 "
          f"alone), then " + ", ".join(f"{k} {v['wall_s']:.1f}" for k, v in
                                        done.items())
          + f" side by side (contended); phase {out['phase_s']:.1f} s of "
          f"its {COMPOSE_BUDGET_S:.0f} s budget", flush=True)
    check(out["phase_s"] <= COMPOSE_BUDGET_S,
          f"phase 21 took {out['phase_s']:.1f} s, over {COMPOSE_BUDGET_S} s")
    return out


READERS_BUDGET_S = 30.0


def readers_phase(fleet: dict, tools: dict) -> dict:
    """Phase 16: the port's run readers (``obs/export.py``,
    ``run/status.py``, ``run/perf_report.py``, ``obs/regress.py``) on the
    fleet dir phase 11 kept (the kill run) and the rings' run dirs of
    phase 15; no new training."""
    from distributed_pipeline_tpu_torch.chaos import goodput
    from distributed_pipeline_tpu_torch.obs import export as export_lib
    from distributed_pipeline_tpu_torch.obs import ledger as ledger_lib
    from distributed_pipeline_tpu_torch.obs import regress
    from distributed_pipeline_tpu_torch.obs.trace import read_trace
    from distributed_pipeline_tpu_torch.run import perf_report
    from distributed_pipeline_tpu_torch.run import status as status_lib
    t0 = time.perf_counter()
    dirs = tools["dirs"]
    out: dict = {}
    # the twin's Perfetto timeline: JSON with its step and save spans
    trace = json.loads(json.dumps(export_lib.chrome_trace(dirs["twin"])))
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    names = [e["name"] for e in spans]
    check(names.count("step") == TOOL_STEPS and names.count("save") == 2,
          f"the twin's timeline: {names.count('step')} step and "
          f"{names.count('save')} save spans")
    out["twin_trace_events"] = len(trace["traceEvents"])
    # each ring's status gives the goodput fold's
    out["status"] = {}
    for key in ("chaos", "twin", "hang"):
        snap = status_lib.status(dirs[key])
        want = round(goodput.aggregate_run(dirs[key])["goodput"], 4)
        check(snap["kind"] == "run" and snap["goodput"] == want
              and snap["step"] == TOOL_STEPS,
              f"status of the {key} ring: {snap}, goodput {want}")
        status_lib.render(snap)
        out["status"][key] = {k: snap.get(k) for k in (
            "step", "attempts", "last_rc", "goodput", "accounted_frac",
            "mfu")}
    # the Prometheus snapshots parse
    out["prometheus_lines"] = {}
    for key, d in (("twin", dirs["twin"]), ("fleet", fleet["kept_dir"])):
        lines = export_lib.prometheus_lines(d)
        for line in lines:
            if not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                float(value)
                check(name[0].isalpha(), f"prometheus line {line!r}")
        out["prometheus_lines"][key] = len(lines)
    # the ledger report renders the train_step row
    led = ledger_lib.read_ledger(dirs["twin"])
    text = perf_report.render(led)
    check("train_step" in text, "perf_report shows no train_step row")
    # the sentinel over the chaos ring's and the twin's ledgers
    hist = []
    for key in ("chaos", "twin"):
        row = ledger_lib.read_ledger(dirs[key])["programs"]["train_step"]
        hist.append({"name": "train_step", "run_id": key, "mfu": row["mfu"],
                     "tokens_per_sec_per_chip": row["tokens_per_s"],
                     "recompile_count": 0})
    cmp = regress.compare_runs(regress.group_runs(hist), baseline_runs=1)
    leg = (cmp.get("legs") or {}).get("train_step") or {}
    check(cmp["verdict"] in ("ok", "regressed")
          and leg.get("verdict") in ("improved", "flat", "regressed"),
          f"compare_runs: {cmp}")
    regress.render_table(cmp)
    out["compare_runs"] = {"verdict": cmp["verdict"],
                           "legs": cmp.get("legs")}
    # the fleet dir: its journal's counts are the fleet summary's
    fdir = fleet["kept_dir"]
    counts = export_lib.journal_counts(
        read_trace(goodput.serving_journal_path(fdir)))
    check((counts["completed"], counts["replayed"])
          == (fleet["kept_counts"]["completed"],
              fleet["kept_counts"]["replayed"]),
          f"the fleet journal counts {counts['completed']} completed, "
          f"{counts['replayed']} replayed; the summary "
          f"{fleet['kept_counts']}")
    ftrace = json.loads(json.dumps(export_lib.chrome_trace(fdir)))
    fsnap = status_lib.status(fdir)
    check(fsnap["kind"] == "fleet", f"status of the fleet dir: {fsnap}")
    out["fleet"] = {"completed": counts["completed"],
                    "replayed": counts["replayed"],
                    "ttft_p50_s": counts["ttft_p50_s"],
                    "ttft_p95_s": counts["ttft_p95_s"],
                    "trace_events": len(ftrace["traceEvents"])}
    # the CLIs as a user runs them
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    for argv in (["obs.export", dirs["twin"], "--out",
                  os.path.join(dirs["twin"], "trace.json")],
                 ["run.status", fdir, "--json"],
                 ["run.perf_report", dirs["twin"], "--json"]):
        mod = f"distributed_pipeline_tpu_torch.{argv[0]}"
        res = subprocess.run([sys.executable, "-m", mod, *argv[1:]],
                             cwd=repo, env=env, capture_output=True,
                             text=True, timeout=60)
        check(res.returncode == 0 and res.stdout.strip(),
              f"{argv[0]} exited {res.returncode}: {res.stderr[-2000:]}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"# run readers ({CARD}): twin timeline {out['twin_trace_events']}"
          f" events; status goodput {json.dumps(out['status'])}; prometheus "
          f"lines {out['prometheus_lines']}; compare_runs chaos -> twin "
          f"{cmp['verdict']}; fleet journal {json.dumps(out['fleet'])}; "
          f"phase {out['phase_s']:.1f} s", flush=True)
    check(out["phase_s"] <= READERS_BUDGET_S,
          f"phase 16 took {out['phase_s']:.1f} s, over {READERS_BUDGET_S} s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from distributed_pipeline_tpu_torch.ops import _build
    from distributed_pipeline_tpu_torch.ops import flash_attention as fa
    from distributed_pipeline_tpu_torch.ops import flash_decode as fd
    from distributed_pipeline_tpu_torch.ops import fused_update as fu
    from distributed_pipeline_tpu_torch.utils.perf import card_rates

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global CARD
    CARD = smi
    bw, bf16_peak, f32_peak = card_rates(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = t0 = time.perf_counter()
    _build.load_library()
    print(f"# build: CUDA kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for row in build_report(_build.build_log_path()):
        print(f"# build: {json.dumps(row)}", flush=True)
    lib = _build.load_library()
    print("# build: bf16 flash kernels' dynamic shared memory (bytes): " +
          json.dumps({f"{'bwd' if b else 'fwd'}_dh{dh}":
                      lib.dpt_flash_smem_bytes(b, dh)
                      for b in (0, 1) for dh in (64, 128)}), flush=True)

    decode = clocked("decode kernels", kernel_phase, torch, fd, bw,
                     bf16_peak)
    span = clocked("span kernels", span_phase, torch, fd, bw, bf16_peak)
    flash = clocked("flash kernels", flash_phase, torch, bw, bf16_peak)
    update = clocked("fused update", update_phase, torch, bw, f32_peak,
                     GPT2_BASE)
    update_dq = clocked("fused update diffuseq", update_phase, torch, bw,
                        f32_peak, DIFFUSEQ_BASE,
                        name="fused_adamw_ema_diffuseq")
    update_moe = clocked("fused update gpt2 moe8", update_phase, torch, bw,
                         f32_peak, GPT2_MOE8,
                         name="fused_adamw_ema_gpt2_moe8")
    update_shard = clocked(
        "fused update gpt2 zero1 shard", update_phase, torch, bw, f32_peak,
        GPT2_BASE, name="fused_adamw_ema_gpt2_zero1_shard",
        elements=zero1_shard_elements(GPT2_BASE, 2))
    update_pipe = clocked(
        "fused update gpt2 pipe2 stage", update_phase, torch, bw, f32_peak,
        GPT2_BASE, name="fused_adamw_ema_gpt2_pipe2_stage",
        elements=pipe_stage_elements(GPT2_BASE, 2))
    # phase 21's update shapes: a --pipe 2 --fsdp 2 rank's local elements,
    # a --pipe 2 ZeRO-1 rank's owned half of its stage buffer, a moe8
    # --pipe 2 rank's stage buffer
    update_compose = {
        "fsdp": clocked(
            "fused update gpt2 pipe2 fsdp2", update_phase, torch, bw,
            f32_peak, GPT2_BASE, name="fused_adamw_ema_gpt2_pipe2_fsdp2",
            elements=fsdp_pipe_elements(GPT2_BASE, 2, 2)),
        "zero1": clocked(
            "fused update gpt2 pipe2 zero1", update_phase, torch, bw,
            f32_peak, GPT2_BASE, name="fused_adamw_ema_gpt2_pipe2_zero1",
            elements=pipe_stage_elements(GPT2_BASE, 2) // 2),
        "moe8_pipe": clocked(
            "fused update gpt2 moe8 pipe2", update_phase, torch, bw,
            f32_peak, GPT2_MOE8, name="fused_adamw_ema_gpt2_moe8_pipe2",
            elements=pipe_stage_elements(GPT2_MOE8, 2))}
    small_model_phase(torch)
    t0 = time.perf_counter()
    serve, spec, options = serve_phase(torch, fd, bw, bf16_peak)
    print(f"# serve phase, spec runs included: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for row, kv_quant in zip(decode, ("fp", "int8")):
        run = dict(serve[kv_quant])
        row["launches"] = run.pop("launches")
        row.update({k: v for k, v in run.items() if k.startswith("serve_")})
    for row, key in zip(span, ("ngram_fp", "model_int8")):
        row["launches"] = spec[key]["span_kernel_launches"]
    # the fleet dir of phase 11 and the rings of phase 15, for phase 16
    keep = tempfile.mkdtemp(prefix="chip_smoke_keep_")
    atexit.register(shutil.rmtree, keep, True)
    with tempfile.TemporaryDirectory() as work:
        run = os.path.join(work, "gpt2_base_train")
        train = clocked("train", train_phase, torch, fa, fu, run)
        for row in (*flash, update):
            row["launches"] = train["launches"][row["name"]]
        gpt2 = clocked("gpt2 decoding and eval", gpt2_decode_phase, torch,
                       fa, fd, fu, run)
        fleet = clocked("serving fleet", fleet_phase, torch, fd, run, keep)
    decode[0]["launches_gpt2_sample"] = gpt2["sample"][
        "decode_kernel_launches"]
    # phase 11: each replica's launches (read from its sidecar) and the
    # disaggregated decode worker's
    decode[0]["launches_fleet_replicas"] = [
        r["launches"] for r in fleet["file"]["replicas"].values()]
    decode[0]["launches_disagg_decode"] = fleet["disagg"]["decode_worker"][
        "launches"]
    flash[0]["launches_gpt2_decode_prefill"] = gpt2["gpt2_decode_bf16"][
        "flash_forward_launches"]
    flash[0]["launches_gpt2_eval_decode"] = gpt2["eval_decode"]["launches"][
        "flash_forward"]
    diffuseq = clocked("diffuseq", diffuseq_phase, torch, fa, fu)
    update_dq["launches"] = diffuseq["launches"]["fused_adamw_ema"]
    for row, n in zip(flash, diffuseq["seq1024"]["kernels"]["launches"]):
        row["launches_diffuseq_seq1024"] = n
    dp = clocked("data parallel", dp_phase, torch)
    # phase 12: each rank's launches, read from its sidecar
    for row in (*flash, update):
        for key in ("nprocs1", "nprocs2"):
            row[f"launches_dp_{key}"] = [r["launches"][row["name"]]
                                         for r in dp[key]["ranks"]]
    moe = clocked("moe and remat", moe_remat_phase, torch, fa, fd, fu)
    sp, lse_row = clocked("sequence parallel", sequence_phase, torch, fa, bw,
                          bf16_peak, dp["single"])
    # phase 14: each rank's launches of the GPT-2 and DiffuSeq rings
    for row in flash:
        row["launches_sp2_gpt2"] = [r["launches"][row["name"]] for r in
                                    sp["gpt2_base_sp2"]["ranks"]]
        row["launches_sp2_diffuseq"] = [
            r["launches"][row["name"]] for r in
            sp["diffuseq_base_seq1024"]["sp2"]["ranks"]]
    # phase 13: GPT-2 base moe8 without and with remat, and the launches
    # of serving its run dir
    for row in (*flash, update):
        for key in ("no_remat", "remat"):
            row[f"launches_moe_gpt2_{key}"] = moe["gpt2_moe8"][key][
                "launches"][row["name"]]
    tools = clocked("training tooling", tooling_phase, torch,
                    os.path.join(keep, "tooling"))
    readers = clocked("run readers", readers_phase, fleet, tools)
    shutil.rmtree(keep, ignore_errors=True)
    spm = clocked("moe and eval_decode under --sequence 2",
                  moe_sequence_phase, torch, moe["gpt2_moe8"]["no_remat"])
    # phase 17: each rank's launches of the moe8 sp2 run
    for row in flash:
        row["launches_moe_sp2"] = [r["launches"][row["name"]] for r in
                                   spm["moe8"]["sp2"]["ranks"]]
    update_moe["launches_moe_sp2"] = [r["launches"]["fused_adamw_ema"]
                                      for r in spm["moe8"]["sp2"]["ranks"]]
    lse_row["launches_moe_sp2"] = [r["lse_backward_launches"]
                                   for r in spm["moe8"]["sp2"]["ranks"]]
    for row in (*flash, update):
        row["launches_eval_decode_sp2"] = [
            r["launches"][row["name"]] for r in
            spm["eval_decode_sp2"]["ranks"]]
    # phase 18: ZeRO-1, --fsdp 2 and a layout-flipping resume, against
    # phase 12's --nprocs 2 run
    shard = clocked("sharded training state", shard_phase, torch, dp,
                    update_shard)
    for row in flash:
        for key in ("zero1", "fsdp2"):
            row[f"launches_{key}"] = [r["launches"][row["name"]]
                                      for r in shard[key]["ranks"]]
    update["launches_fsdp2"] = [r["launches"]["fused_adamw_ema"]
                                for r in shard["fsdp2"]["ranks"]]
    # phase 19: stacked layers and the pipeline schedules
    pipe = clocked("stacked layers and the pipeline", pipe_phase, torch, dp,
                   diffuseq, update_pipe)
    for row in flash:
        for key in ("1f1b", "gpipe", "interleaved"):
            row[f"launches_pipe_{key}"] = [r["launches"][row["name"]]
                                           for r in pipe[key]["ranks"]]
    # phase 20: the MPMD pipeline's stage processes, last
    mpmd = clocked("mpmd pipeline", mpmd_phase, torch, pipe)
    for row in (*flash, update):
        row["launches_mpmd"] = [r["launches"][row["name"]]
                                for r in mpmd["gpt2"]["stages"]]
    # phase 21: the pipe's compositions, against phases 19 and 13
    compose = clocked("the pipe's compositions", compose_phase, torch, pipe,
                      moe["gpt2_moe8"], update_compose)
    for row in flash:
        for key, runs in (("fsdp2", compose["fsdp"]["ranks"]),
                          ("zero1", compose["zero1"]["ranks"]),
                          ("sequence2", compose["sequence"]["ranks"]),
                          ("moe8_scan", compose["moe8"]["scan"]["ranks"]),
                          ("moe8", compose["moe8"]["pipe"]["ranks"])):
            row[f"launches_compose_{key}"] = [r["launches"][row["name"]]
                                              for r in runs]
    lse_row["launches_compose_sequence2"] = [
        r["lse_backward_launches"] for r in compose["sequence"]["ranks"]]
    update_moe["launches_compose_moe8_scan"] = [
        r["launches"]["fused_adamw_ema"]
        for r in compose["moe8"]["scan"]["ranks"]]
    # phase 15: the finished attempts' launches, read from their sidecars
    update_dq["launches_tooling"] = {
        key: tools[key]["launches"]["fused_adamw_ema"]
        for key in ("chaos", "twin", "watchdog")}
    update_moe["launches_by_run"] = {
        key: moe["gpt2_moe8"][key]["launches"]["fused_adamw_ema"]
        for key in ("no_remat", "remat")}
    update_moe["launches"] = sum(update_moe["launches_by_run"].values())
    update_dq["launches_moe"] = moe["diffuseq_moe8"]["launches"][
        "fused_adamw_ema"]
    decode[0]["launches_moe_serve"] = {
        k: moe["serve"][k]["decode_kernel_launches"]
        for k in ("graph", "eager")}
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"spec": spec}), flush=True)
    print(json.dumps({"serve_options": options}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"diffuseq": diffuseq}), flush=True)
    print(json.dumps({"gpt2_decoding": gpt2}), flush=True)
    print(json.dumps({"serving_fleet": fleet}), flush=True)
    print(json.dumps({"data_parallel": dp}), flush=True)
    print(json.dumps({"moe_remat": moe}), flush=True)
    print(json.dumps({"sequence_parallel": sp}), flush=True)
    print(json.dumps({"training_tooling": tools}), flush=True)
    print(json.dumps({"run_readers": readers}), flush=True)
    print(json.dumps({"moe_eval_decode_sequence": spm}), flush=True)
    print(json.dumps({"sharded_state": shard}), flush=True)
    print(json.dumps({"pipeline": pipe}), flush=True)
    print(json.dumps({"mpmd": mpmd}), flush=True)
    print(json.dumps({"compositions": compose}), flush=True)
    print(f"# chip_smoke: all phases in {time.perf_counter() - start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [*decode, *span, *flash, lse_row, update,
                                  update_dq, update_moe, update_shard,
                                  update_pipe, *update_compose.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/H100 port (``paddle_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

(``python3 chip_smoke.py --ab fa_a.cu fa_b.cu ...`` instead times copies
of a kernel source against each other: ``compare_variants``;
``--fleet`` runs phase 4h alone: ``fleet_alone``; ``--distributed``
runs phases 17-22 alone: ``distributed_alone``, on every visible card;
``--tensor-parallel`` phases 19 and 20 alone, ``--sequence-parallel``
phase 20 alone, ``--pipeline`` phase 21 alone, ``--moe`` phase 22
alone: ``moe_alone``; ``--amp-clip`` phase 23, which the default run
leaves out: ``amp_clip_alone``.)

It imports nothing of JAX or ``paddle_tpu``.  Phases, each failing
loudly with a non-zero exit:

1. device — require CUDA, print the card's name and power limit
   (``nvidia-smi``), turn TF32 off for float32 matmuls and convolutions;
2. build — compile every kernel of ``paddle_tpu_torch/ops/csrc`` with
   nvcc for sm_90a and print the build seconds and ptxas report; then
   ``cuobjdump -sass`` on the flash attention library must find
   tensor-core instructions (HMMA / HGMMA) in both head_dim
   instantiations of the bf16 forward and backward kernels (K1a, K1b,
   K1c), and none in the fp32 kernels;
3. K7 — the ragged paged attention kernel against its plain PyTorch
   version on the card, at serving shapes (page 16, head_dim 128, MHA
   16/16 and GQA 32/8, fp32 and bf16; a decode whose lengths straddle
   the page splits) with NaN in every pool byte no row needs: error
   against the stated tolerance, exact zeros on padding rows and the
   empty slot, a second launch bitwise equal to the first, kernel /
   plain / library (``scaled_dot_product_attention``, a yardstick only)
   times and the card's bound for the same work;
4. serving main path — GPT-3 1.3B (random weights from a seed, fp32)
   served by ``ServingEngine`` (max_batch 8, page 16): 8 requests of
   17-512 prompt tokens, two sharing a 64-token prefix, one sampled, 32
   new tokens each, in two waves (seven queued before the loop starts,
   then the eighth, which hits the prefix cache); every request returns
   its 32 tokens, K7 ran exactly once per layer per step, K6c once per
   layer on every decode step, one host read per step, the prefix
   cache hit, and the engine's step logits for a prompt match the dense
   forward (which runs K1a and K2a);
4c. LLaMA serving — phase 10's llama2-7b (32 layers, MHA 32/32, fp32,
   nothing cut) served the same way (pools of 8 x 40 + 1 pages): the
   same checks (K7 = 32 x steps, K6c 32 on every decode step), and the
   ragged decode step's logits against the dense forward, with a fault
   control (the step's rope rows gathered at pos - 1) that must fail;
4d. the fused serving window — the same requests at
   ``FLAGS_serving_fused_steps = 4`` on both models: every token
   (greedy and the sampled one) equal to the single-step run's,
   iterations > dispatches, one host read per dispatch, K7 once per
   layer per dispatched iteration; ms per decode iteration beside the
   single step's, the idle iterations after a finish, the generator's
   state snapshot not waiting for the device, and one window and one
   step traced alone (``torch.profiler``: wall and the device's busy
   share);
4e. HTTP — ``InferenceServer`` over a llama2-7b engine on loopback, four
   concurrent ``generate_http`` streams: tokens equal to 4c's for the
   same prompts, ``/metrics`` counting them;
4f. fault containment on phase 4's GPT-3 1.3B — phase 4's 8 prompts, all
   greedy and queued before the loop starts, 32 new tokens, each run
   with its own event log and its K7 / K6c launches printed: a clean run
   (the oracle), then under ``FLAGS_fault_schedule`` ``serving_step@3=
   exc`` (one request quarantined alone, the innocents equal to the
   oracle, its prompt rejected at admission when resubmitted, health
   quarantining then degraded), ``@3=nan`` (the NaN sentinel quarantines
   its lane alone), ``@5=stall:6`` at a 2 s step timeout (one relaunch,
   every stream requeued and equal to the oracle, health degraded then
   ok after 8 clean steps, one step_timeout; the relaunch's time and
   peak memory), the same stall past a relaunch cap of 0 (health failed,
   every request unhealthy, a late submit rejected), a deadline that
   ends mid-batch (that request cancelled, the others equal, every page
   back, K7 / K6c equal to the clean run's), predicted-cost admission on
   a ``batch_step`` head fitted to the clean run's own timings with a
   budget between its decode-step and 512-token-admission predictions
   (admissions deferred, tokens equal, ``predicted_cost_s`` on every
   admission, a doomed deadline rejected up front) and ``python -m
   paddle_tpu_torch.observability watchdog --perf-model`` over the clean
   run (exit 0).  A stream that differs from the oracle passes only where
   the dense forward's top-2 margin at its first differing token is
   under 1e-3 (a probe or re-prefill runs its rows in other products);
   each such case prints;
4g. one watchdog relaunch on phase 10's llama2-7b (a clean run, then the
   stall run): every stream equal to the clean run's as in 4f, the
   relaunch's time and the peak memory with both pool sets alive;
4h. fleet serving on GPT-3 1.3B — 16 greedy prompts (8 sharing a 2-page
   prefix with 4-16 tokens of their own, then phase 4's 8) through one
   in-process engine on phase 4's model (the oracle), then through
   ``FleetRouter`` over a ``ReplicaSupervisor`` of two ``python -m
   paddle_tpu_torch.serving.fleet --worker`` replicas at the same widths
   and seed (max_batch 8, page 16, each with its own event log and
   tuning dir) as 16 concurrent ``generate_http`` streams, in three
   waves: clean (affinity hits; each replica's ``/health`` K7 = 24 x its
   dispatched iterations, > 0; then ``python -m paddle_tpu_torch.tuning
   fit --from-events`` on each replica's log, and the router's merged
   model at the largest input version + 1), the prefix's owner SIGKILLed
   once a stream has 4 tokens (a resubmission, one ``crash`` restart,
   the replica routable again), a rolling restart mid-traffic (two
   ``rolling`` restarts); every stream untruncated and equal to the
   oracle up to a top-2 margin under 1e-3 as in 4f, the route events of
   waves 2 and 3 priced (``predicted_cost_s``); tokens/s per wave beside
   the single engine's, the router's TTFT p50 / p99, SIGKILL to routable,
   each replica's memory, and no worker alive after the phase;
5. K1a/b/c (flash attention fwd, dq, dk/dv), K2a/b (LayerNorm fwd, dx)
   and K3 (fused AdamW) against their plain PyTorch versions on the card
   at training shapes (K1 at both training paths' shapes, GPT's and
   LLaMA's, and the bf16 kernels' edges: q_offset, ragged S, D = 64,
   D = 100 with GQA, one query row; K2 also on rows wider than 8192, the
   wide route), with kernel / plain / library (a yardstick only)
   times, the library's own distance from the plain version, and the
   card's bound for the same work;
6. training main path — the calls of ``bench.py``'s ``_measure``
   through the port: GPT-3 1.3B at full width (24 layers, seq 2048,
   batch 4), amp O2 bf16 with fp32 master weights, AdamW(1e-4, weight
   decay 0.01), the same random batch every step; 1 cold, 2 warm-up and
   5 timed steps; every loss finite and the last below the first, and per
   step exactly 24 launches of each K1 kernel, 49 of each K2 kernel and
   292 of K3;
6b. cross-check at full width and depth 2: one O2 step through the
   kernels against the same step composed here from the plain versions
   (the loss, every parameter's gradient and update, and the second
   step's loss), and a control with a LayerNorm dx fault that the
   gradient check must catch;
7. K4a/b (RMSNorm fwd, dx) and K5 (rotary embedding, forward and the
   backward's -sin launch) against their plain PyTorch versions on the
   card at the LLaMA path's shapes, plus a bf16 RMSNorm and a neox rope
   case, with kernel / plain / library (a yardstick only, where one
   PyTorch call computes the same) times and the card's bound;
8. LLaMA training main path — ``llama2-7b`` at full width cut to 8 of
   its 32 layers (the O2 AdamW state of all 32 does not fit 80 GB), batch
   2 x seq 4096, amp O2 bf16 with fp32 master weights, AdamW(1e-4, weight
   decay 0.01), the same random batch every step; 1 cold, 2 warm-up and 5
   timed steps, each printing its time, tokens/s, MFU and peak memory;
   every loss finite and the last below the first, and per step exactly
   17 launches of each K4 kernel, 32 of K5, 8 of each K1 kernel and 75 of
   K3 (none of K2 or K7);
8b. cross-check at full width and depth 2: one LLaMA O2 step through the
   kernels against the same step composed here from the plain versions,
   held as in 6b, with controls (an RMSNorm dx fault, rope rotated the
   other way, unrounded rope tables) that the gradient check must
   catch;
9. K6a (rope + QKV), K6b (attend + cache append) and K6c (norm + MLP)
   against their plain PyTorch versions on the card at the decode paths'
   shapes (llama2-7b and GPT-3 1.3B at batch 8, plus GQA 32/8, neox rope
   and bf16 cases; K6c also at 33 and 64 rows; every K6a and K6c case on
   its stream route, K6a's route as the kernel's ``fd_qkv_route`` gives
   it, a relaunch bitwise equal), with kernel / plain / library (a
   yardstick only, where one PyTorch call computes the same; for K6c a
   composition, ``composition_ms``) times and the card's bound, K6a's
   generic GEMV on the same inputs (``generic_ms``), K6a's and K6c's
   weights rotating over copies past twice the L2;
10. decode main path — ``decode_loop`` on ``llama2-7b`` at full width
   and depth (32 layers, fp32, nothing cut), batch 8 x prompt 512 + 128
   new tokens: every row returns its tokens, per call exactly 32 launches
   of each K6 kernel per decode step and the prefill's K1a, K4a and K5;
   the first decode step's logits match the dense forward over prompt +
   token, and a fault control (the step's attention one position short)
   must fail that check; compiled and eager ``generate`` agree up to the
   first position whose top-2 margin is under that tolerance; a sampled
   call is reproducible from its seed; an EOS call stops rows where the
   greedy run says; ms per token, tokens/s, host reads, peak memory and
   the device's busy share from a ``torch.profiler`` trace;
11. K9 (paged decode attention) against its plain PyTorch version on the
   card at the paged paths' shapes (llama2-7b MHA 32/32 at length 576 and
   GPT-3 1.3B 16/16 at 288, batch 8, page 16, head_dim 128), plus ragged
   lengths 0..640 (the empty row exactly 0), GQA 32/8 and bf16; every byte
   no row needs is NaN in the kernel's pools, so reading one shows; kernel
   / plain / library (SDPA on the gathered live rows, a yardstick only)
   times and the card's bound;
12. paged main path — eager ``generate(use_paged_cache=True)`` on phase
   10's llama2-7b (all 32 layers, fp32, batch 8 x prompt 512 + 128) and on
   GPT-3 1.3B rebuilt from phase 4's seed (batch 8 x 256 + 64): exact
   launches per call (K9 once per layer per decode step, the norms of
   every forward, the prefill's K1a and rope, no K6 or K7); the first
   paged step's logits match the dense forward, and a fault control (the
   tables' lengths one short) must fail that check; the tokens equal
   eager dense ``generate``'s up to each row's first top-2 margin under
   that tolerance; ms per token, tokens/s, host reads, table copies and
   peak memory beside a dense eager call.  Then beam search on both
   models (batch 2 x 4 beams, prompt 256 + 32): one beam is greedy, each
   returned hypothesis's carried score equals its score recomputed from a
   dense forward, and on llama2-7b (whose winning beams change rows; on
   random GPT-3 1.3B weights they never do, so its control is only read)
   a search that skips the cache reorder must fail that check;
13. K8a/K8b (softmax cross-entropy forward and backward) against their
   plain PyTorch version on the card: BART's loss shape (8192 x 50265
   fp32, ~10 % of rows ignored), GPT's and LLaMA's vocabularies, bf16, a
   ragged 33 x 37 case, every row ignored and labels outside [0, V) that
   are not ignored (no column picked); ignored rows exactly 0 in both
   passes; kernel / plain / library (``cross_entropy(reduction="none")``
   and its backward, a yardstick only) times and the card's bytes bound
   for what the data needs (an ignored row is not read);
14. BART main path — bart-base at the reference's default ``BartConfig``
   (d_model 768, 6 + 6 layers, vocab 50265, fp32, random weights from a
   seed, nothing cut), batch 8 x encoder 1024 + decoder 1024 with padded
   tails, ``jit.train_step`` with AdamW(1e-4, weight decay 0.01); 1 cold,
   2 warm-up and 5 timed steps; every loss finite and the last below the
   first, the frozen ``final_logits_bias`` unmoved, and per step exactly
   1 launch of each K8 kernel, 32 of each K2 kernel and 259 of K3 (none
   of K1, K4-K7 or K9);
14b. cross-check at full width and depth 2 + 2: one fp32 step through
   the kernels against the same step composed from the plain versions of
   K8, K2 and K3 (loss, every gradient, every update, the second loss),
   and a control (K8b giving ignored rows a gradient) that the gradient
   check must catch;
14c. ``generate`` on phase 14's model, batch 4 x encoder 1024 with padded
   masks, 32 new tokens: greedy (the stop switched off: a random BART's
   first token is its start token, which is its eos) equals the argmax of
   a teacher-forced dense forward up to each row's first top-2 margin
   under 1e-3; beam search with 4 beams returns scores equal to their
   recomputation and the forced eos in the last slot; neither launches
   K8.
15. K6d (norm + matmul, the kernel the program passes' claim routes to)
   against its plain PyTorch version on the card: GPT-3 1.3B's ln -> qkv
   and ln -> fc1 (row-major weights with biases) and its tied head,
   LLaMA-2 7B's head (both the transposed view of a row-major [V, H]),
   all at batch 8 in fp32, then bf16, 1, 33 and 64 rows, odd H = 40 and
   N = 37 in both layouts and 3-D x; each case's route (the stream
   kernel, the odd ones the generic GEMV), a relaunch bitwise equal;
   kernel / plain / library (the norm then one product, a yardstick
   only) times over weight copies past twice the L2, and the card's
   bound;
16. program-pass main path — ``capture_decode_program`` on GPT-3 1.3B
   rebuilt from phase 4's seed (LayerNorm parameters drawn from a second
   seed) and on phase 10's llama2-7b, batch 8 x prompt 256, then
   ``run_program_passes`` with the default pipeline, then both programs
   replayed on the card: exactly 49 claimed chains (24 ln1 -> qkv, 24
   ln2 -> fc1, final norm -> tied head) and 1 (final norm -> head); per
   optimized replay exactly 49 K6d and no K2a (GPT), 1 K6d and 64 K4a
   (LLaMA), per unoptimized replay 49 K2a / 65 K4a and no K6d; the
   optimized fetches (logits and every layer's cache) match the
   unoptimized replay and the eager step, and a control (K6d without the
   LayerNorm's bias) must fail that check; op counts, each pass's
   removals and the replay times before and after;
17. data-parallel training — the ranks started through the port's
   launcher (``python -m paddle_tpu_torch.distributed.launch``), one per
   visible card, on NCCL (at one card a world of one, as the driver runs
   it): every collective on CUDA tensors against values computed on the
   host from the seed; rank 0's oracle (the global batch of 4 x 2048 a
   rank as that many accumulated micro-batches on one card, then one
   AdamW step; at one rank phase 6's ``train_step`` itself) and one
   card's plain step time; GPT-3 1.3B O2 under ``DataParallel``, under
   ``group_sharded_parallel(level="os_g")`` (ZeRO stage 2) and under
   ``level="p_g_os"`` (stage 3: the tied head on the root segment), 3
   steps held against the oracle (at one rank bit-equal in losses,
   parameters, fp32 masters and, for DataParallel and stage 3, the first
   gradients; else losses 0.0625, gradients 2e-2 relative norm, values 3
   x 2.1 lr) and stages 2 and 3 against DataParallel the same way, every
   rank's parameters bit-identical after each step, then 5 more steps
   (the last 4 timed); per step exactly phase 6's launches of K1a-c and
   K2a/b, and of K3 292 (DataParallel) or one per bucket shard (stage 2)
   or segment flat shard (stage 3), and stage 3's gathers and
   reduce-scatters exactly; step ms, tokens/s,
   scaling against one card, the bucket collectives of one step timed
   alone and the peak memory of each mode; with two or more ranks the
   sanitizer's raise under ``collective@2=truncate``; then a SIGKILLed
   rank: the launcher restarts the group and exits 0, or exits non-zero
   with no restart left, each within ``DIST_KILL_S``;
18. LLaMA-2 7B O2 under ZeRO stage 3 with recompute, in the same ranks
   after phase 17 (``zero3_rank``): ``use_recompute=True``,
   ``group_sharded_parallel(level="p_g_os")``, AdamW(1e-4, wd 0.01),
   batch 2 x 4096 a rank.  At one card, phase 8's 8 layers (32 need
   107.8 GB of state): the plain ``train_step``, recompute alone and
   stage 3 + recompute, both bit-equal to the plain step in losses,
   first gradients, parameters and fp32 masters, with exact launches a
   step (recompute adds a layer's K1a, two K4a and two K5; K3 once a
   segment flat's shard) and exact gathers and reduce-scatters.  On
   several cards: stage 3 + recompute at depth 2 against rank 0's
   one-card oracle (phase 17's bounds), then at all 32 layers against
   ``os_g`` + recompute (losses 0.0625, values 3 x 2.1 lr); step ms,
   tokens/s, MFU, the collectives alone and peak memory a rank;
19. tensor parallel, in the same ranks after phase 18 (``tp_rank``):
   ``fleet.init`` at each layout, the model built split (the mp layers;
   GPT's packed qkv by heads), ``fleet.distributed_model``
   (``TensorParallel``), ``fleet.distributed_optimizer`` and
   ``train_step(mesh=...)`` on the global batch.  At one card
   (``tp_world_of_one``): LLaMA-2 7B O2 at depth 2 with
   ``sequence_parallel=True`` through ``TensorParallel`` in a world of
   one, bit-equal to the plain step (losses, first gradients,
   parameters, fp32 masters) with its launches.  On four cards: GPT-3
   1.3B O2 at depth 2 (batch 4 x 2048 shared by the ranks) under mp 4,
   mp 4 + SP and dp 2 x mp 2, and LLaMA-2 7B O2 at depth 2 (2 x 4096)
   under mp 4 + SP, each held to rank 0's one-card oracle with phase
   17's bounds (first gradients and values gathered from the shards);
   then LLaMA-2 7B at all 32 layers under mp 4 + SP against mp 4 without
   SP on every rank's shards (losses 0.0625, values 3 x 2.1 lr); every
   rank's launches exact a step (as one card's, over the rank's heads
   and rows; K3 once a parameter of the rank); step ms, tokens/s, MFU,
   peak memory a rank and one step's mp collectives timed alone;
20. sequence sharding.  At one card (``check_ring_schedule``, before
   phase 17): the factored ring runs cp 4's four ranks in turn on one
   causal sequence at llama2-7b's attention shape ([64, 4096, 128]
   bf16), against K1 over the whole sequence (KTOL) with exactly 10
   launches of each K1 kernel (rank r: r + 1), its relative distance
   from K1's fp32 kernels on the same inputs within 1.1x K1's own
   (``RING_WITNESS_MARGIN``), the schedule's and each rank's forward
   times beside K1's.  On four cards (``seq_rank``): LLaMA-2 7B O2 at
   phase 8's 8 layers, batch 2 x 4096, under cp 4 (the ring) and sep 4
   (Ulysses).  Rank 0 builds three one-card references
   (``seq_oracles``): the plain step, the step with fp32 attention (the
   witness) and the step with its attention through the factored ring of
   4 chunks (``one_card_ring``), whose first gradients must be within
   1.1x the plain step's distance from the witness.  sep 4 is held to the
   plain step with phase 17's bounds; cp 4 to the one-card ring with
   phase 17's bounds and to the plain step in losses and values (its
   first gradients measured: two sound bf16 attention layouts sit ~2.5e-2
   apart at 8 layers; two layout controls measured, two accumulated
   micro-batches and the one-card ring); cp rank r launches r + 1 of each
   K1 kernel a layer, sep one;
   every attention takes its route, none falls back;
21. pipeline parallel.  At one card (``pipeline_one_card``, before phase
   17): LLaMA-2 7B O2 at phase 8's 8 layers as a ``PipelineLayer`` (the
   embedding, the decoder layers, the norm and head, each piece under
   the O2 auto_cast and drawn from its own seed) of 4 stages on cuda:0
   behind ``PipelineParallel`` (``HostPipelineSchedule``), 8
   micro-batches of 1 x 4096 a step, every piece recomputed (FThenB
   would hold ~56 GB of residuals), under 1F1B, FThenB and ZBH1: each
   bit-equal to the plain step that accumulates the same micro-batches
   (loss / 8 each) in losses, first gradients, parameters and fp32
   masters, with exact launches a step (K1a, K4a, K5 again in each
   backward pass's recomputation; ZBH1's Bd and Bw each a pass).  On
   four cards (``pipeline_rank``): through ``fleet.init`` /
   ``distributed_model`` / ``PipelineParallel.train_batch``, pp 4 at
   depth 8 against rank 0's one-card oracle (phase 17's bounds; bit-
   equality reported), then all 32 layers under 1F1B, FThenB, ZBH1 and
   VPP (2 chunks), every layer recomputed, and 1F1B without, each
   bit-equal to 1F1B on every rank's values; LLaMA-2 7B at 32 layers
   under mp 2 x pp 2 through ``llama_pipeline_step`` (blocks
   recomputed) against pp 4 (phase 19's bounds); GPT-3 1.3B at 24
   layers under dp 2 x pp 2 through ``gpt_pipeline_step`` (the tied
   embedding summed over its two stages) against rank 0's one-card
   oracle (phase 17's bounds).  Every rank's launches exact a step; step
   ms, tokens/s, MFU, every rank's idle share (CUDA events around its
   compute), peak live residuals and peak memory, and one step's p2p
   traffic timed alone.

22. ERNIE-MoE pretraining.  At one card (``ernie_moe_main_path``, after
   phase 21's one-card part): ``MoELayer``'s index form against its
   one-hot einsum form on the card (fp32, tokens dropped; a fault
   control, the queue places shifted, must fail), then ``ernie-moe-base``
   at full width and depth (12 layers, hidden 768, 64 experts in every
   2nd block, GShard top-2, capacity factor 1.25, vocab 40000; dropout
   0, random weights from seed 0, each expert from a generator of its
   own), amp O2 bf16, AdamW(1e-4, wd 0.01) with
   ``ClipGradForMOEByGlobalNorm(1.0)``, batch 8 x 512 with MLM labels
   (~30 % kept), 1 cold, 2 warm-up and 5 timed steps through
   ``train_step``; every loss finite and the last below the first, per
   step exactly 12 launches of each K1 kernel (non-causal, head_dim 64),
   25 of each K2 kernel and 1672 of K3 (one a parameter tensor); step ms,
   tokens/s, MFU of the capacity slots computed, peak memory and the
   (token, choice) pairs each MoE block drops.  On four cards
   (``moe_rank``): rank 0's one-card oracle on cuda:0 (3 plain steps of
   the same model on the global batch), then ep 4 (16 experts a rank,
   dp 1) and dp 2 x ep 2 (32 a rank) through ``fleet.init`` and
   ``train_step(mesh=...)`` on the same global batch: losses within
   0.0625 of the oracle's and equal on every rank, every rank's fp32
   values (sent to rank 0) within phase 17's bounds, dense values
   bit-identical within each ep group, each rank holding exactly its
   ``E / ep`` experts, launches exact (K3 once a tensor of the rank);
   step ms, tokens/s, MFU, peak memory a rank and one step's ep
   collectives timed alone; each topology's groups freed before the
   next.  The value medians are held at ep 4 and measured at dp 2 x
   ep 2, and two witnesses at dp 2 x ep 2 say why: a control with
   capacity and queue places per dp rank (the upstream GPU form, a
   different result) must fail the first gradients' bound, and the same
   layout in fp32 must hold every bound, the medians too, against an
   fp32 oracle.
23. the global-norm clip and ``amp.GradScaler`` (``--amp-clip`` only).
   At one card (``amp_clip_one_card``) on phase 6's GPT-3 1.3B O2 step
   with ``ClipGradByGlobalNorm(1.0)`` and ``GradScaler(2**10)``; on
   several cards (``amp_clip_rank``) legs (a) example 03 at full width,
   GPT-3 1.3B O2 under dp 2 x sharding 2 stage 2 through
   ``train_step(scaler=, mesh=...)`` against rank 0's one-card oracle of
   the same stack (phase 17's bounds), (b) example 04's layers, LLaMA-2
   7B O2 at 32 layers under mp 4 with SP and recompute, the clip on,
   (c) LLaMA-2 7B O2 at 32 layers as phase 21's pipeline at pp 4 under
   1F1B with the clip and the scaler.  Each leg: the clip's first norm
   within 1e-4 of an fp64 oracle (every gradient's squares by name,
   gathered over the ranks, replicated tensors once) and each rank's
   own share missing it; exact launches (K3 the same with and without
   the clip, 0 on a skipped step); the step timed with and without the
   clip and scaler, their own times, tokens/s, MFU and peak memory a
   rank.  In (a), (c) and at one card rank 3's gradient (one card:
   rank 0's) is poisoned after the reductions at step 3: every rank's
   parameters, masters and moments bit-equal after it, the scale
   halved, only that rank's own flag raised, one host read a step, and
   the next step repeats its loss and trains.

Phases 6 and 8 also require 0 launches of K8 per step (the GPT and LLaMA
criteria stay on the log-softmax route, as ``ParallelCrossEntropy`` keeps
them in the JAX package).  Phase 4d's GPT-3 1.3B run follows phase 4 on
its model, and phase 4b runs ``decode_loop`` greedy on it (batch 8 x
prompt 256 + 64 new) with exact K6 launches, then phases 4f and 4h.
Phases
4c-4e and 4g run after phase 16, on phase 10's llama2-7b, before that
model is freed.

Each main path's launch counts are set to 0 just before it runs and read
just after (phase 16: after the passes, whose claim checks itself with
K6d, and before the replays; phases 4, 4c, 4d and 4e: around each
engine run).  The line before the last is ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.analysis.pass_check import CARD_TOL
from paddle_tpu_torch.distributed.parallel import (all_gather_single,
                                                  reduce_scatter_single)
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference.serving import (InferenceServer,
                                                generate_http)
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.models import generation
from paddle_tpu_torch.models.bart import (BartConfig,
                                          BartForConditionalGeneration)
from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
from paddle_tpu_torch.models.gpt import LayerNorm as GPTLayerNorm
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_config
from paddle_tpu_torch.models.ernie_moe import (ErnieMoEForPretraining,
                                               ernie_moe_config)
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm, MoELayer, moe_layer)
from paddle_tpu_torch.observability.events import read_events
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_adamw as adamw
from paddle_tpu_torch.ops import fused_decode as fd
from paddle_tpu_torch.ops import layer_norm as ln
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.ops import rms_norm as rms
from paddle_tpu_torch.ops import rope
from paddle_tpu_torch.ops import softmax_ce as sce
from paddle_tpu_torch.serving import PagePool, Request, Scheduler
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.__main__ import _print_device_profile
from paddle_tpu_torch.serving.fleet import FleetRouter, ReplicaSupervisor
from paddle_tpu_torch.static.passes import (capture_decode_program, graph,
                                            run_program_passes)
from paddle_tpu_torch.static.passes.__main__ import quartiles, replay_times
from paddle_tpu_torch.tuning.learned import (fit_from_telemetry, load_model,
                                             save_model)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# K7 vs its plain version: fp32 online (kernel) and two-pass (plain)
# softmax sum in different orders; bf16 is compared in the working dtype,
# where one rounding step of an output below 4 is under 2e-2
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# engine step vs dense forward, fp32 over 24 layers: different GEMM
# shapes (cuBLAS splits) and softmax orders, logits of order 1
LOGITS_TOL = 2e-3
N_LAYERS = 24
# K1/K2 vs their plain versions.  fp32: online (kernel) vs two-pass
# (plain) softmax and row sums in other orders, a few ulps of values of
# order 1-100.  bf16, compared in the working dtype: both round once from
# fp32 sums that differ in order, so they may land one bf16 step (2^-8 =
# 0.4 % of the value) apart, on values up to ~30 for summed gradients.
KTOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2)}  # atol, rtol
# K3 vs the plain sequence: both round every step of the same fp32
# arithmetic in the same order
ADAMW_TOL = 1e-6
# the 6b/8b cross-checks, kernels vs plain step at depth 2.  Both steps'
# losses are bf16 values in [4, 16): one bf16 step is 0.0625 in [8, 16),
# two in [4, 8).  An Adam update is +-lr per element where the gradient's
# sign agrees, and where it is bf16 rounding noise (the key bias has a
# true gradient of 0) the sign may differ, so each update must be within
# 2.1 lr everywhere and the median difference of each tensor below
# lr / 100.  On a first step those limits and the loss can pass a wrong
# backward, so each parameter's gradient is held by its relative norm
# |g_k - g_p| / |g_p| too: the gradients are bf16 and the two steps round
# at different points (online vs two-pass softmax, whose bf16 outputs
# feed every gradient upstream), which this script's sound runs on the
# H100 read as 7.4e-3 (GPT) and 1.2e-2 (LLaMA, a q projection) at worst.
# The limit is above them and below every control's reading: a
# plain step with one fault a kernel could have (a norm's dx without its
# mean terms, rope rotated the other way) reads 1.4 - 7.5, and the LLaMA
# step with its rope tables left unrounded (the O2 bf16 cast missed) 3.2e-2.
XCHECK_LOSS_TOL = 0.0625
GRAD_REL_TOL = 2e-2
PEAK_BF16 = 989e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls.
    A sleep kernel queued first keeps the device busy while the host
    enqueues, so host overhead does not leak into the interval."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)   # ~0.1 s at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: K7 against its plain version
# ---------------------------------------------------------------------------

def make_case(kv_lens, q_lens, q_width, nh, nkv, dtype, seed, ps=16, hd=128):
    """A batch over pools of each sequence's pages plus one page no row
    owns, in a random order (unused table slots at page 0).  Every pool
    byte no row needs (the spare page, slots past a length, an empty
    slot's pages) is NaN in the pools the kernel gets and 0 in the copies
    the plain version gets, so a kernel that read one would return NaN.
    Returns (q, k, v with NaN, kv_lens, q_lens, tables) and (k, v with
    0)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b = len(kv_lens)
    pages = [-(-k // ps) for k in kv_lens]
    ppseq = max(pages)
    n_pages = sum(pages) + 1
    perm = torch.randperm(n_pages, generator=g, device=dev)
    tables = torch.zeros(b, ppseq, dtype=torch.int32, device=dev)
    live = torch.zeros(n_pages, ps, dtype=torch.bool, device=dev)
    at = 0
    for i, n in enumerate(pages):
        tables[i, :n] = perm[at:at + n]
        at += n
        if q_lens[i]:
            t = torch.arange(kv_lens[i], device=dev)
            live[tables[i, t // ps].long(), t % ps] = True
    dead = ~live[None, :, :, None]
    shape = (nkv, n_pages, ps, hd)
    kp = torch.randn(shape, generator=g, device=dev).to(dtype)
    vp = torch.randn(shape, generator=g, device=dev).to(dtype)
    q = torch.randn(b, q_width, nh, hd, generator=g, device=dev).to(dtype)
    i32 = dict(dtype=torch.int32, device=dev)
    poisoned = [p.masked_fill(dead, float("nan")) for p in (kp, vp)]
    clean = tuple(p.masked_fill(dead, 0.0) for p in (kp, vp))
    return (q, *poisoned, torch.tensor(kv_lens, **i32),
            torch.tensor(q_lens, **i32), tables), clean


def bound(kv_lens, q_lens, q_width, nh, nkv, dtype, ps=16, hd=128):
    """Least time for the work: live K/V pages + valid q rows read once,
    the output written once; attended (row, position) pairs times 4*hd
    operations.  Returns (ms, "bytes" | "operations")."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = flops = 0
    for kv, ql in zip(kv_lens, q_lens):
        if ql:
            nbytes += 2 * nkv * (-(-kv // ps)) * ps * hd * item
            nbytes += ql * nh * hd * item
            for i in range(ql):
                flops += 4 * hd * nh * min(kv, kv - ql + i + 1)
    nbytes += len(kv_lens) * q_width * nh * hd * item
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_fn(q, kp, vp, kv_lens, q_lens, tables):
    """``scaled_dot_product_attention`` on K/V gathered densely from the
    pages beforehand, with the ragged causal mask (timed as a yardstick;
    the port never calls it)."""
    b, qw, nh, hd = q.shape
    nkv, _, ps, _ = kp.shape
    t = tables.shape[1] * ps
    k = kp[:, tables.long()].transpose(0, 1).reshape(b, nkv, t, hd) \
        .repeat_interleave(nh // nkv, dim=1)
    v = vp[:, tables.long()].transpose(0, 1).reshape(b, nkv, t, hd) \
        .repeat_interleave(nh // nkv, dim=1)
    qt = q.transpose(1, 2)
    kvpos = torch.arange(t, device=q.device)
    qpos = (kv_lens - q_lens)[:, None] + torch.arange(qw, device=q.device)
    mask = (kvpos[None, None, :] <= qpos[:, :, None]) \
        & (kvpos[None, None, :] < kv_lens[:, None, None])
    mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


CASES = {
    # a full 300-token prefill, a decode at context 2048, an empty slot
    # and a 64-row chunk at context 1024; Q padded to the engine's bucket
    "mixed": dict(kv_lens=[300, 2048, 0, 1024], q_lens=[300, 1, 0, 64],
                  q_width=512),
    # decode of the main path's 8 requests midway through generation
    "decode": dict(kv_lens=[33, 80, 144, 216, 349, 528, 96, 96],
                   q_lens=[1] * 8, q_width=1),
    # decode of 8 sequences at the model's full context
    "decode-2048": dict(kv_lens=[2048] * 8, q_lens=[1] * 8, q_width=1),
    # decode whose lengths straddle the page-split boundaries: fewer live
    # pages than splits (empty splits), one page each, runs that end
    # mid-page, and a long context
    "decode-split": dict(kv_lens=[1, 16, 17, 63, 64, 65, 1000, 2047],
                         q_lens=[1] * 8, q_width=1),
}
HEADS = {"mha": (16, 16), "gqa": (32, 8), "llama": (32, 32)}
# llama2-7b's heads (phases 4c-4e serve it) at the decode case only
K7_LLAMA_CASES = {("decode", torch.float32)}


def check_k7():
    results = []
    seed = 0
    for case, spec in CASES.items():
        for heads, (nh, nkv) in HEADS.items():
            for dtype in (torch.float32, torch.bfloat16):
                if heads == "llama":
                    if (case, dtype) not in K7_LLAMA_CASES:
                        continue
                    case_seed = 1000     # the other cases keep their seeds
                else:
                    seed += 1
                    case_seed = seed
                args, clean = make_case(spec["kv_lens"], spec["q_lens"],
                                        spec["q_width"], nh, nkv, dtype,
                                        case_seed)
                plain_args = (args[0], *clean, *args[3:])
                before = rpa.launches
                out = rpa.ragged_paged_attention(*args)
                torch.cuda.synchronize()
                if rpa.launches != before + 1:
                    fail(f"K7 {case}: launches did not increase")
                # the page splits merge in a fixed order: a second launch
                # on the same inputs gives the same bits
                again = rpa.ragged_paged_attention(*args)
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    fail(f"K7 {case}/{heads}/{dtype}: a second launch on "
                         "the same inputs differs")
                ref = rpa.ragged_paged_attention_ref(*plain_args)
                if out.dtype != dtype or out.shape != args[0].shape:
                    fail(f"K7 {case}: output {out.dtype} {out.shape}")
                if not torch.isfinite(out.float()).all():
                    fail(f"K7 {case}/{heads}/{dtype}: non-finite output")
                err = 0.0
                for b, ql in enumerate(spec["q_lens"]):
                    if ql:
                        d = (out[b, :ql].float() - ref[b, :ql].float())
                        err = max(err, d.abs().max().item())
                    # padding rows (and the empty slot) are exactly 0
                    if not (out[b, ql:] == 0).all():
                        fail(f"K7 {case}: padding rows of slot {b} "
                             "are not 0")
                    if ql == 0 and not (ref[b] == 0).all():
                        fail(f"K7 {case}: plain version's empty slot "
                             "is not 0")
                if err > TOL[dtype]:
                    fail(f"K7 {case}/{heads}/{dtype}: max abs err {err} > "
                         f"{TOL[dtype]}")
                ms = time_ms(lambda: rpa.ragged_paged_attention(*args), 20)
                plain_ms = time_ms(
                    lambda: rpa.ragged_paged_attention_ref(*plain_args), 3)
                library_ms = time_ms(library_fn(*plain_args), 10)
                bound_ms, bound_by = bound(spec["kv_lens"], spec["q_lens"],
                                           spec["q_width"], nh, nkv, dtype)
                row = dict(case=case, heads=heads,
                           dtype=str(dtype).replace("torch.", ""),
                           max_abs_err=err, tol=TOL[dtype], ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
                say("K7 " + json.dumps(row))
                results.append(row)
                del args, clean, plain_args, out, again, ref
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 4, 4c, 4d, 4e: serving (the main path)
# ---------------------------------------------------------------------------

# the served requests: six prompts of these lengths, then two sharing a
# 64-token prefix (4 full pages of 16) with 16 tokens of their own; one
# sampled; 32 new tokens each
SERVE = dict(lengths=(17, 64, 128, 200, 333, 512), prefix=64, tail=16,
             new=32, sampled=2, temperature=0.8)
SERVE_ENGINE = dict(max_batch=8, page_size=16)
# llama2-7b's engine: 40 pages of 16 a sequence (640 tokens: the longest
# prompt + 32 fits), 8 sequences' worth plus the sink
LLAMA_SERVE_PAGES = 40
FUSED_STEPS = 4                  # FLAGS_serving_fused_steps of phase 4d
AB_TURNS = 7                     # phase 4d's window / step turns
HTTP_STREAMS = (0, 1, 3, 4)      # phase 4e: four greedy requests of wave 1


def serve_prompts(vocab):
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, vocab, (n,)).tolist() for n in SERVE["lengths"]]
    shared = rs.randint(0, vocab, (SERVE["prefix"],)).tolist()
    prompts += [shared + rs.randint(0, vocab, (SERVE["tail"],)).tolist()
                for _ in range(2)]
    temps = [0.0] * len(prompts)
    temps[SERVE["sampled"]] = SERVE["temperature"]
    return prompts, temps


def serve_waves(engine, prompts, temps):
    """Wave 1, every request but the last, is queued before the loop
    starts, so the first step admits all of it and every run (single
    step or windows) plans the same steps; the last request, sharing the
    one before's prefix, is submitted once wave 1 has finished and hits
    the prefix cache.  Returns (tokens per request, requests, wall s)."""
    new = SERVE["new"]
    t0 = time.perf_counter()
    engine._accepting = True         # queue wave 1 before the first plan
    reqs = [engine.submit(p, max_new_tokens=new, temperature=t)
            for p, t in zip(prompts[:-1], temps[:-1])]
    engine.start()
    outs = [r.wait(timeout=600) for r in reqs]
    reqs.append(engine.submit(prompts[-1], max_new_tokens=new,
                              temperature=temps[-1]))
    outs.append(reqs[-1].wait(timeout=600))
    wall = time.perf_counter() - t0
    engine.stop()
    return outs, reqs, wall


def serve_run(tag, engine, prompts, temps, layers, vocab):
    """One counted serving run (K7's and K6c's counts set to 0 just
    before, read just after) and the checks every run must pass: each
    request's 32 tokens in the vocabulary, K7 once per layer per
    dispatched iteration (idle window iterations included) and the
    engine's count agreeing, K6c a multiple of the layers on at least
    every dispatched decode iteration, one host read per dispatch, a
    prefix-cache hit and no failed step."""
    rpa.launches = 0                 # count this run's launches only
    fd.launches["norm_mlp"] = 0
    outs, reqs, wall = serve_waves(engine, prompts, temps)
    k7, k6c = rpa.launches, fd.launches["norm_mlp"]
    stats = engine.stats()
    say(f"{tag}: engine stats: {json.dumps(stats)}")
    for i, (o, t) in enumerate(zip(outs, temps)):
        if len(o) != SERVE["new"]:
            fail(f"{tag}: request {i} (temperature {t}) returned {len(o)} "
                 "tokens")
        if not all(0 <= x < vocab for x in o):
            fail(f"{tag}: request {i} returned a token outside the "
                 "vocabulary")
    steps, idle = stats["steps"], stats["window_idle_iterations"]
    dispatched = steps + idle
    if k7 != layers * dispatched or stats["kernel_launches"] != k7:
        fail(f"{tag}: K7 launches {k7} != {layers} x {dispatched} "
             f"dispatched iterations (engine counted "
             f"{stats['kernel_launches']})")
    if stats["host_reads"] != stats["dispatches"]:
        fail(f"{tag}: {stats['host_reads']} host reads for "
             f"{stats['dispatches']} dispatches")
    if stats["prefix_cache"]["hits"] < 1:
        fail(f"{tag}: prefix cache scored no hit: {stats['prefix_cache']}")
    if stats["failed_steps"]:
        fail(f"{tag}: {stats['failed_steps']} failed steps")
    n_decode = steps - stats["prefill_steps"]
    # K6c takes every step of at most 64 rows (B x bucketed Q): each
    # decode iteration, idle ones included, and any prefill that small
    if k6c % layers or k6c < layers * (n_decode + idle):
        fail(f"{tag}: K6c launches {k6c} are not {layers} per step on at "
             f"least the {n_decode + idle} dispatched decode iterations")
    n_tok = sum(len(o) for o in outs)
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    ms_decode = 1e3 * stats["decode_step_s"] / max(n_decode, 1)
    say(f"{tag}: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; {steps} iterations in "
        f"{stats['dispatches']} dispatches ({idle} idle); TTFT mean "
        f"{1e3 * sum(ttft) / len(ttft):.1f} ms, max {1e3 * max(ttft):.1f} "
        f"ms; prefix cache {stats['prefix_cache']}")
    say(f"{tag}: {stats['prefill_steps']} steps with prefill, "
        f"{1e3 * stats['prefill_step_s'] / max(stats['prefill_steps'], 1):.2f}"
        f" ms each; {n_decode} decode iterations, {ms_decode:.2f} ms each "
        "(host clock around dispatch + the read that waits for it)")
    say(f"{tag}: K7 launches {k7} = {layers} x {dispatched} dispatched "
        f"iterations; K6c (norm_mlp) launches {k6c} = {layers} x "
        f"{k6c // layers} steps of at most {fd.NORM_MLP_MAX_ROWS} rows "
        f"({n_decode + idle} decode iterations)")
    return dict(outs=outs, stats=stats, k7=k7, k6c=k6c, wall=wall,
                tokens_per_s=n_tok / wall, ms_decode=ms_decode)


def window_state(engine, model):
    """Eight live lanes at wave 1's lengths midway (each prompt + 16),
    their pages laid out in order in the engine's pools, for one window
    or step outside the engine (the engine must be stopped)."""
    dev = model.device
    ps, ppseq = engine.pool.page_size, engine.scheduler.ppseq
    prompts, _ = serve_prompts(model.config.vocab_size)
    lens = [len(p) + SERVE["new"] // 2 for p in prompts]
    tables = np.zeros((engine.max_batch, ppseq), "int32")
    at = 0
    for i, n in enumerate(lens):
        k = -(-(n + FUSED_STEPS) // ps)
        tables[i, :k] = np.arange(at, at + k)
        at += k
    if at >= engine.pool.sink:
        fail(f"window state needs {at} pages, the pools hold "
             f"{engine.pool.sink}")
    b = engine.max_batch

    def put(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return dict(tok=put(np.arange(1, b + 1)), kv=put(lens),
                tables=put(tables), temps=put(np.zeros(b), torch.float32))


def device_busy_s(prof) -> float:
    from torch.autograd import DeviceType
    return sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / 1e6


def trace_window(tag, engine, model):
    """One window of ``FUSED_STEPS`` iterations and one single step on
    the same lanes, each traced alone with ``torch.profiler`` after a
    warm call: wall ms per iteration and the device's busy share of the
    wall time (device kernel time / host clock, dispatch to read)."""
    st = window_state(engine, model)
    dev = model.device
    b = engine.max_batch
    gen = torch.Generator(device=dev).manual_seed(0)
    _, window = model.build_fused_window_step(FUSED_STEPS)
    params, step = engine._params, engine._step_fn
    live = torch.ones(b, dtype=torch.bool, device=dev)
    eos = torch.full((b,), -1, dtype=torch.int32, device=dev)
    budgets = torch.full((b,), 2 ** 30, dtype=torch.int32, device=dev)

    def one_window():
        packed, _ = window(params, st["tok"], engine._pools, st["kv"], live,
                           st["tables"], st["temps"], eos, budgets, gen,
                           FUSED_STEPS)
        return packed.cpu()

    def one_step():
        page_ids, slots = rpa.append_positions(st["kv"], st["tables"], live,
                                               engine.pool.page_size,
                                               engine.pool.sink)
        q = live.to(torch.int32)
        with torch.no_grad():
            logits, _ = step(params, st["tok"][:, None], st["kv"][:, None],
                             engine._pools, page_ids[:, None],
                             slots[:, None], st["kv"] + q, q, st["tables"])
            return generation.serving_sample(logits, st["temps"],
                                             gen).cpu()

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = {}
    for name, fn, iters in (("window", one_window, FUSED_STEPS),
                            ("step", one_step, 1)):
        fn()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        busy = device_busy_s(prof)
        out[name] = dict(traced_ms_per_iteration=1e3 * wall / iters,
                         busy_share=busy / wall)
        say(f"{tag}: one {name} of {iters} iteration(s) on 8 lanes, "
            f"traced: {1e3 * wall:.3f} ms wall, {1e3 * wall / iters:.3f} ms "
            f"an iteration, device busy {1e3 * busy:.3f} ms = "
            f"{100 * busy / wall:.2f} % of the wall")
    # untraced, in turns on the same lanes: a window (its dispatch, then
    # the read) against FUSED_STEPS single steps (each dispatch + read)
    win, disp, steps = [], [], []
    for _ in range(AB_TURNS):
        synchronize(dev)
        t0 = time.perf_counter()
        packed, _ = window(params, st["tok"], engine._pools, st["kv"], live,
                           st["tables"], st["temps"], eos, budgets, gen,
                           FUSED_STEPS)
        t1 = time.perf_counter()
        packed.cpu()
        t2 = time.perf_counter()
        for _ in range(FUSED_STEPS):
            one_step()
        t3 = time.perf_counter()
        disp.append(1e3 * (t1 - t0) / FUSED_STEPS)
        win.append(1e3 * (t2 - t0) / FUSED_STEPS)
        steps.append(1e3 * (t3 - t2) / FUSED_STEPS)
    for key, vals in (("window_ms", win), ("window_dispatch_ms", disp),
                      ("step_ms", steps)):
        out[key] = float(np.median(vals))
    say(f"{tag}: in turns ({AB_TURNS} x): a window {out['window_ms']:.3f} "
        f"ms an iteration (its dispatch {out['window_dispatch_ms']:.3f}), "
        f"a single step {out['step_ms']:.3f} ms (medians; "
        f"windows {[round(v, 3) for v in win]}, steps "
        f"{[round(v, 3) for v in steps]})")
    return out


def synchronize(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def check_rng_snapshot_is_host_only(gen):
    """``generator.get_state()`` (the window's per-iteration snapshot)
    must not wait for the device: taken behind a ~0.1 s sleep kernel, it
    returns long before the sleep ends."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    gen.get_state()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    say(f"generator.get_state() behind a sleep kernel: {1e3 * dt:.3f} ms "
        f"(the sleep {1e3 * total:.3f} ms)")
    if dt > total / 4:
        fail(f"generator.get_state() waited for the device ({dt:.4f} s of "
             f"{total:.4f} s)")


def window_run(tag, model, prompts, temps, single, layers, engine_kw):
    """Phase 4d on one model: the same requests at
    ``FLAGS_serving_fused_steps = FUSED_STEPS``.  Every token (greedy and
    the sampled one, same seed) equals the single-step run's; the
    windows ran (iterations > dispatches); then one window and one step
    traced alone."""
    set_flags({"FLAGS_serving_fused_steps": FUSED_STEPS})
    try:
        engine = ServingEngine(model, **engine_kw, device=model.device)
        res = serve_run(tag, engine, prompts, temps, layers,
                        model.config.vocab_size)
    finally:
        set_flags({"FLAGS_serving_fused_steps": 1})
    st = res["stats"]
    for i, (got, want) in enumerate(zip(res["outs"], single["outs"])):
        if got != want:
            fail(f"{tag}: request {i} (temperature {temps[i]}) gave other "
                 f"tokens than the single-step run: {got} != {want}")
    if st["steps"] <= st["dispatches"]:
        fail(f"{tag}: {st['steps']} iterations in {st['dispatches']} "
             "dispatches: the windows did not run")
    say(f"{tag}: tokens equal to the single-step run's (greedy and sampled)"
        f"; {res['ms_decode']:.2f} ms a decode iteration against "
        f"{single['ms_decode']:.2f} single-step; {st['host_reads']} host "
        f"reads for {st['steps']} iterations (single-step "
        f"{single['stats']['host_reads']} for {single['stats']['steps']}); "
        f"{st['window_idle_iterations']} idle window iterations")
    if model.device.type == "cuda":
        check_rng_snapshot_is_host_only(engine._gen)
    res["trace"] = trace_window(tag, engine, model)
    del engine
    torch.cuda.empty_cache()
    return res


def http_run(tag, model, prompts, want, layers, engine_kw):
    """Phase 4e: ``InferenceServer`` over a fresh engine on loopback,
    the requests of ``HTTP_STREAMS`` as concurrent ``generate_http``
    streams: their tokens equal ``want``'s, ``/metrics`` counts them, and
    K7 runs once per layer per dispatched iteration."""
    set_flags({"FLAGS_serving_engine": True})
    engine = ServingEngine(model, **engine_kw, device=model.device)
    srv = None
    outs = [None] * len(HTTP_STREAMS)
    try:
        rpa.launches = 0             # count this run's launches only
        fd.launches["norm_mlp"] = 0
        engine.start()
        srv = InferenceServer(engine=engine,
                              max_in_flight=len(HTTP_STREAMS)).start()

        def run(i, r):
            try:
                outs[i] = list(generate_http(
                    srv.url, prompts[r], max_new_tokens=SERVE["new"],
                    timeout=600))
            except (RuntimeError, OSError) as e:
                outs[i] = e

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i, r))
                   for i, r in enumerate(HTTP_STREAMS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            fail(f"{tag}: a stream did not end in 900 s")
        deadline = time.monotonic() + 30
        while srv.served < len(HTTP_STREAMS) and \
                time.monotonic() < deadline:
            time.sleep(0.01)         # a handler counts after its done line
        with urllib.request.urlopen(srv.url + "/metrics",
                                    timeout=60) as r:
            metrics_text = r.read().decode()
    finally:
        if srv is not None:
            srv.stop()
        engine.stop()
        set_flags({"FLAGS_serving_engine": False})
    k7 = rpa.launches
    stats = engine.stats()
    for i, r in enumerate(HTTP_STREAMS):
        if outs[i] != want[r]:
            fail(f"{tag}: stream {i} (request {r}) gave {outs[i]}, the "
                 f"in-process run {want[r]}")
    served = (f'paddle_serving_requests_total{{outcome="served",server='
              f'"{srv.server_id}"}} {len(HTTP_STREAMS)}')
    decoded = (f'paddle_serving_engine_tokens_total{{engine='
               f'"{engine.engine_id}",phase="decode"}} '
               f'{len(HTTP_STREAMS) * SERVE["new"]}')
    for line in (served, decoded):
        if line not in metrics_text:
            fail(f"{tag}: /metrics lacks {line!r}")
    dispatched = stats["steps"] + stats["window_idle_iterations"]
    if k7 != layers * dispatched:
        fail(f"{tag}: K7 launches {k7} != {layers} x {dispatched}")
    n_tok = len(HTTP_STREAMS) * SERVE["new"]
    say(f"{tag}: {len(HTTP_STREAMS)} concurrent generate_http streams on "
        f"{srv.url}: tokens equal to the in-process run's; {n_tok} tokens "
        f"in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; /metrics counts "
        f"them; K7 launches {k7} = {layers} x {dispatched}; K6c "
        f"{fd.launches['norm_mlp']}")
    del engine
    torch.cuda.empty_cache()
    return dict(k7=k7, k6c=fd.launches["norm_mlp"], wall=wall,
                tokens_per_s=n_tok / wall)


def serve_main_path():
    """Phase 4 (GPT-3 1.3B, single step) and phase 4d's GPT run."""
    cfg = gpt_config("gpt3-1.3B", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    if cfg.num_layers != N_LAYERS:
        fail(f"gpt3-1.3B has {cfg.num_layers} layers")
    t0 = time.perf_counter()
    model = GPTForPretraining(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"model: gpt3-1.3B fp32, {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.3f} s")
    prompts, temps = serve_prompts(cfg.vocab_size)
    engine = ServingEngine(model, **SERVE_ENGINE, device=model.device)
    pool_bytes = 2 * N_LAYERS * engine.pool.num_pages * 16 \
        * cfg.hidden_size * 4
    say(f"engine: {engine.pool.num_pages} pages of 16 x {N_LAYERS} layers, "
        f"pools {pool_bytes} bytes")
    single = serve_run("main path", engine, prompts, temps, N_LAYERS,
                       cfg.vocab_size)
    del engine
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    window = window_run("gpt window", model, prompts, temps, single,
                        N_LAYERS, SERVE_ENGINE)
    say(f"phase 4d (gpt3-1.3B): {time.perf_counter() - t1:.1f} s")
    check_step_logits(model, prompts[3])
    gpt_decode = gpt_decode_main_path(model)
    faults = fault_main_path(model)
    gc.collect()
    torch.cuda.empty_cache()
    faults["fleet"] = fleet_main_path(model)
    del model
    torch.cuda.empty_cache()
    return single, window, gpt_decode, faults


def check_step_logits(model, prompt):
    """The engine's ragged step (planned by its scheduler, on fresh
    pools) against the dense forward: last-row logits of a prefill."""
    ps = 16
    c = model.config
    nh = c.num_heads
    hd = c.hidden_size // nh
    ppseq = -(-c.max_position_embeddings // ps)
    pool = PagePool(num_pages=-(-len(prompt) // ps) + 1, page_size=ps)
    sched = Scheduler(pool, max_batch=8, max_pages_per_seq=ppseq)
    sched.submit(Request(prompt, max_new_tokens=1))
    plan, _, _ = sched.plan_step()
    dev = model.device
    shape = (nh, pool.num_pages, ps, hd)
    pools = [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
             for _ in range(c.num_layers)]
    params, step = model.build_ragged_decode_step()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    logits, _ = step(params, put(plan.tok), put(plan.pos), pools,
                     put(plan.page_ids), put(plan.slots), put(plan.kv_lens),
                     put(plan.q_lens), put(plan.tables))
    dense = model(torch.tensor([prompt], device=dev))[0, -1]
    err = (logits[0] - dense).abs().max().item()
    if not torch.isfinite(logits[0]).all() or logits.shape[1] != \
            c.vocab_size:
        fail(f"step logits: shape {tuple(logits.shape)} or non-finite")
    say(f"step vs dense forward, prompt of {len(prompt)}: last-row logits "
        f"max abs err {err:.3e} (tol {LOGITS_TOL}; |logits| max "
        f"{dense.abs().max().item():.3f})")
    if err > LOGITS_TOL:
        fail(f"step logits differ from the dense forward by {err}")


def check_llama_step_logits(model, prompt):
    """LLaMA's ragged step against the dense forward: a prefill of all
    but the prompt's last token, then the decode step of the last (the
    step serving runs most), on fresh ``[nkv, P, ps, hd]`` pools; its
    logits must be within ``LOGITS_TOL`` of the dense forward's last row.
    The fault control, the same decode step with its rope rows gathered
    at ``pos - 1`` (the cached keys rotated at their own positions), must
    not.  Returns (error, control error)."""
    ps = 16
    c = model.config
    hd = c.hidden_size // c.num_heads
    dev = model.device
    params, step = model.build_ragged_decode_step()
    dense = model(torch.tensor([prompt], device=dev))[0, -1]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    errs = []
    for shift in (0, 1):
        pool = PagePool(num_pages=-(-len(prompt) // ps) + 1, page_size=ps)
        sched = Scheduler(pool, max_batch=8,
                          max_pages_per_seq=pool.num_pages - 1)
        sched.submit(Request(prompt[:-1], max_new_tokens=2))
        shape = (c.num_kv_heads, pool.num_pages, ps, hd)
        pools = [(torch.zeros(shape, device=dev),
                  torch.zeros(shape, device=dev))
                 for _ in range(c.num_layers)]
        for it in range(2):
            plan, _, _ = sched.plan_step()
            pos = put(plan.pos)
            if it == 1:
                pos = (pos - shift).clamp(min=0)
            logits, pools = step(params, put(plan.tok), pos, pools,
                                 put(plan.page_ids), put(plan.slots),
                                 put(plan.kv_lens), put(plan.q_lens),
                                 put(plan.tables))
            sched.commit(plan)
            plan.seqs[0].tokens.append(prompt[-1])
        if not torch.isfinite(logits[0]).all() or \
                logits.shape[1] != c.vocab_size:
            fail(f"llama step logits: shape {tuple(logits.shape)} or "
                 "non-finite")
        errs.append((logits[0] - dense).abs().max().item())
    err, ctrl = errs
    say(f"llama step vs dense forward, prompt of {len(prompt)} (prefill "
        f"{len(prompt) - 1}, then a decode step): last-row logits max abs "
        f"err {err:.3e} (tol {LOGITS_TOL}; |logits| max "
        f"{dense.abs().max().item():.3f}); control, rope rows at pos - 1: "
        f"{ctrl:.3e}")
    if err > LOGITS_TOL:
        fail(f"llama step logits differ from the dense forward by {err}")
    if ctrl <= LOGITS_TOL:
        fail(f"llama step control (rope at pos - 1) passed the logit "
             f"check ({ctrl})")
    return err, ctrl


def llama_serve_main_path(model):
    """Phases 4c, 4d and 4e on phase 10's llama2-7b (32 layers, MHA
    32/32, fp32, nothing cut)."""
    t0 = time.perf_counter()
    cfg = model.config
    layers, vocab = cfg.num_layers, cfg.vocab_size
    hd = cfg.hidden_size // cfg.num_heads
    kw = dict(SERVE_ENGINE, max_pages_per_seq=LLAMA_SERVE_PAGES,
              num_pages=SERVE_ENGINE["max_batch"] * LLAMA_SERVE_PAGES + 1)
    prompts, temps = serve_prompts(vocab)
    engine = ServingEngine(model, **kw, device=model.device)
    pool_bytes = 2 * layers * cfg.num_kv_heads * kw["num_pages"] \
        * SERVE_ENGINE["page_size"] * hd * 4
    say(f"llama serve: {kw['num_pages']} pages of "
        f"{SERVE_ENGINE['page_size']} x {layers} layers x "
        f"{cfg.num_kv_heads} kv heads, pools {pool_bytes} bytes")
    single = serve_run("llama serve", engine, prompts, temps, layers, vocab)
    del engine
    torch.cuda.empty_cache()
    err, ctrl = check_llama_step_logits(model, prompts[3])
    say(f"phase 4c: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    window = window_run("llama window", model, prompts, temps, single,
                        layers, kw)
    say(f"phase 4d (llama2-7b): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    http = http_run("llama http", model, prompts, single["outs"], layers,
                    kw)
    say(f"phase 4e: {time.perf_counter() - t1:.1f} s")
    return dict(single=single, window=window, http=http, step_err=err,
                control_err=ctrl)


# ---------------------------------------------------------------------------
# phases 4f and 4g: fault containment (quarantine, the NaN sentinel, the
# watchdog and its cap, deadlines, predicted-cost admission, the SLO gate)
# ---------------------------------------------------------------------------

FAULT_TIMEOUT_S = 2.0            # FLAGS_serving_step_timeout_s of the stalls
FAULT_STALL = "serving_step@5=stall:6"
FAULT_RECOVERY_STEPS = 8         # health_recovery_steps of the stall run
FAULT_WAIT_S = 120.0             # the phases' limit on any one request
FAULT_DEADLINE_REQUEST = 3       # whose deadline ends mid-batch
CARD = ""                        # nvidia-smi's name and power limit


def fault_run(tag, model, prompts, engine_kw, schedule="", flags=None,
              submit_kw=None, during=None):
    """One counted serving run of ``prompts`` (all greedy, ``SERVE["new"]``
    tokens each, every request queued before the loop starts, so the first
    step admits them all) under ``FLAGS_fault_schedule = schedule``, with an
    event directory of its own.  K7's and K6c's counts are set to 0 just
    before and read just after.  ``submit_kw`` maps a request's index to
    more ``submit`` arguments; ``during(engine, reqs)`` runs once every
    request has ended, before the engine stops.  A request that fails
    leaves None in ``outs``; one that outlives ``FAULT_WAIT_S`` fails the
    phase.  The engine is dropped on return (each request's cancel hook
    too), so its pools are free for the next run."""
    gc.collect()                     # the last run's engine and its pools
    obs = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    set_flags({"FLAGS_observability_dir": obs,
               "FLAGS_fault_schedule": schedule, **(flags or {})})
    rpa.launches = 0                 # count this run's launches only
    fd.launches["norm_mlp"] = 0
    engine = ServingEngine(model, **engine_kw, device=model.device)
    free0 = engine.pool.available()
    extra, reqs = None, []
    try:
        t0 = time.perf_counter()
        engine._accepting = True     # queue every request before the loop
        reqs = [engine.submit(p, max_new_tokens=SERVE["new"],
                              **(submit_kw or {}).get(i, {}))
                for i, p in enumerate(prompts)]
        engine.start()
        outs = []
        for r in reqs:
            try:
                outs.append(r.wait(timeout=FAULT_WAIT_S))
            except RuntimeError:
                outs.append(None)    # failed: its error_kind says why
            except TimeoutError:
                fail(f"{tag}: request {r.id} still running after "
                     f"{FAULT_WAIT_S} s")
        wall = time.perf_counter() - t0
        k7, k6c = rpa.launches, fd.launches["norm_mlp"]
        with engine._lock:           # the last step's events are written
            pass
        if during is not None:
            extra = during(engine, reqs)
        stats = engine.stats()
    finally:
        stopped = engine.stop(drain=False, join_timeout=10.0)
        set_flags({"FLAGS_observability_dir": "", "FLAGS_fault_schedule": "",
                   "FLAGS_serving_step_timeout_s": 0.0})
        # a relaunch's abandoned thread wakes from its stall, sees the new
        # epoch and returns; it holds the engine, its pools and the model
        for thread, _, _ in engine._abandoned:
            thread.join(timeout=30.0)
            if thread.is_alive():
                fail(f"{tag}: an abandoned loop thread outlived its stall")
        for r in reqs:
            r._cancel_cb = None      # the hook holds the engine
        del engine
    recs = read_events(obs)
    health = [e["state"] for e in recs if e["kind"] == "health_transition"]
    kinds = {}
    for e in recs:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    say(f"{tag} [{CARD}]: {wall:.3f} s; K7 launches {k7}, K6c (norm_mlp) "
        f"launches {k6c}; {stats['steps']} steps, {stats['failed_steps']} "
        f"failed; health {health or ['ok']}; quarantined "
        f"{stats['quarantined']}, cancelled {stats['cancelled']}, relaunches "
        f"{stats['watchdog_relaunches']}, deferred admissions "
        f"{stats['deferred_admissions']}; error kinds "
        f"{[r.error_kind for r in reqs]}; events "
        f"{json.dumps(kinds, sort_keys=True)}")
    return dict(outs=outs, reqs=reqs, stats=stats, k7=k7, k6c=k6c, wall=wall,
                recs=recs, health=health, dir=obs, extra=extra, free0=free0,
                stopped=stopped)


def top2_margin(model, ids) -> float:
    """The top-2 margin of the dense forward's last-row logits."""
    with torch.no_grad():
        row = model(torch.tensor([ids], device=model.device))[0, -1].float()
    top = row.topk(2).values
    return float(top[0] - top[1])


def hold_tokens(tag, model, prompts, oracle, outs, skip=()):
    """Each stream of ``outs`` (but ``skip``) against the clean run's: the
    tokens equal, or, at the first that differs, the dense forward's top-2
    margin over prompt + the tokens before it is under STEP_LOGITS_TOL (a
    probe, a relaunch's re-prefill or a smaller prefill runs its rows in
    other products, whose low bits may differ).  Prints each such case."""
    cases = 0
    for i, (want, got) in enumerate(zip(oracle, outs)):
        if i in skip:
            continue
        if got is None or len(got) != len(want):
            fail(f"{tag}: request {i} returned {got}, the clean run {want}")
        if got == want:
            continue
        j = next(k for k, (a, b) in enumerate(zip(want, got)) if a != b)
        margin = top2_margin(model, prompts[i] + want[:j])
        say(f"{tag} [{CARD}]: request {i} differs from the clean run at "
            f"token {j} ({got[j]} vs {want[j]}), where the dense forward's "
            f"top-2 margin is {margin:.3e} (tol {STEP_LOGITS_TOL})")
        if margin >= STEP_LOGITS_TOL:
            fail(f"{tag}: request {i} differs from the clean run at token "
                 f"{j} with a top-2 margin of {margin} >= {STEP_LOGITS_TOL}")
        cases += 1
    return cases


def relaunch_numbers(tag, run):
    """The stall run's relaunch: the step_timeout event's age, and the time
    from it to the end of the new epoch's first step (the re-prefill)."""
    recs = run["recs"]
    timeouts = [e for e in recs if e["kind"] == "step_timeout"]
    if len(timeouts) != 1:
        fail(f"{tag}: {len(timeouts)} step_timeout events, want 1")
    to = timeouts[0]
    after = [e for e in recs if e["kind"] == "batch_step"
             and e["ts"] > to["ts"]]
    if not after:
        fail(f"{tag}: no step after the relaunch")
    relaunch_s = after[0]["ts"] - to["ts"]
    say(f"{tag} [{CARD}]: the watchdog fired at a dispatch age of "
        f"{to['age_s']} s (timeout {to['timeout_s']} s); relaunch to the end "
        f"of the new epoch's first step (re-prefill of {after[0]['tokens']} "
        f"tokens, its step {after[0]['step_s']} s): {relaunch_s:.3f} s")
    return dict(age_s=to["age_s"], relaunch_s=relaunch_s,
                reprefill_step_s=after[0]["step_s"])


def check_stall_run(tag, model, prompts, oracle, run, layers):
    """A stall past the timeout: one relaunch, every stream requeued and
    equal to the clean run's, health degraded then ok, one step_timeout."""
    st = run["stats"]
    if st["watchdog_relaunches"] != 1:
        fail(f"{tag}: {st['watchdog_relaunches']} relaunches, want 1")
    evictions = [r.evictions for r in run["reqs"]]
    if min(evictions) < 1:
        fail(f"{tag}: evictions {evictions}: a stream was not requeued")
    hold_tokens(tag, model, prompts, oracle, run["outs"])
    if run["health"] != ["degraded", "ok"]:
        fail(f"{tag}: health went {run['health']}, want degraded then ok")
    if run["k7"] != layers * st["steps"]:
        fail(f"{tag}: K7 launches {run['k7']} != {layers} x {st['steps']}")
    return relaunch_numbers(tag, run)


def check_oracle(tag, clean, vocab):
    """The clean run's streams: every one its ``SERVE["new"]`` tokens, in
    the vocabulary."""
    for i, o in enumerate(clean["outs"]):
        if o is None or len(o) != SERVE["new"] or \
                not all(0 <= x < vocab for x in o):
            fail(f"{tag}: request {i} returned {o}")
    return clean["outs"]


def fault_main_path(model):
    """Phase 4f on GPT-3 1.3B (phase 4's model): a clean run as the oracle,
    then exc, nan, stall, stall past the cap, a deadline, predicted-cost
    admission on a head fitted to the clean run, and the SLO watchdog."""
    t_phase = time.perf_counter()
    vocab, layers = model.config.vocab_size, model.config.num_layers
    prompts, _ = serve_prompts(vocab)
    kw = dict(SERVE_ENGINE)
    runs = {}
    clean = runs["clean"] = fault_run("faults clean", model, prompts, kw)
    oracle = check_oracle("faults clean", clean, vocab)
    st = clean["stats"]
    if clean["k7"] != layers * st["steps"] or \
            clean["k6c"] != layers * (st["steps"] - st["prefill_steps"]):
        fail(f"faults clean: K7 {clean['k7']} / K6c {clean['k6c']} are not "
             f"{layers} per step / decode step ({st['steps']} steps)")

    # exc: the sticky poison fails one request alone; its prompt is then
    # rejected at admission
    def resubmit(engine, reqs):
        bad = [r for r in reqs if r.error_kind == "quarantined"]
        if len(bad) != 1:
            return None
        again = engine.submit(bad[0].prompt, max_new_tokens=SERVE["new"])
        return again.done, again.error_kind

    exc = runs["exc"] = fault_run("faults exc", model, prompts, kw,
                                  schedule="serving_step@3=exc",
                                  during=resubmit)
    bad = [i for i, r in enumerate(exc["reqs"])
           if r.error_kind == "quarantined"]
    if len(bad) != 1 or exc["outs"][bad[0]] is not None:
        fail(f"faults exc: quarantined {bad}, want exactly one request")
    hold_tokens("faults exc", model, prompts, oracle, exc["outs"], skip=bad)
    if exc["extra"] != (True, "quarantined"):
        fail(f"faults exc: the quarantined prompt resubmitted gave "
             f"{exc['extra']}, want a rejection at admission")
    if exc["health"] != ["quarantining", "degraded"]:
        fail(f"faults exc: health went {exc['health']}")

    # nan: the lane's sentinel (-1) quarantines it alone
    nan = runs["nan"] = fault_run("faults nan", model, prompts, kw,
                                  schedule="serving_step@3=nan")
    bad = [i for i, r in enumerate(nan["reqs"])
           if r.error_kind == "quarantined"]
    reasons = [e["reason"] for e in nan["recs"] if e["kind"] == "quarantine"]
    if len(bad) != 1 or reasons != ["nan_logits"]:
        fail(f"faults nan: quarantined {bad} for {reasons}")
    hold_tokens("faults nan", model, prompts, oracle, nan["outs"], skip=bad)

    # stall: one relaunch, every stream finishes equal to the oracle; the
    # peak counts the model, both pool sets and the re-prefill
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    stall = runs["stall"] = fault_run(
        "faults stall", model, prompts,
        dict(kw, health_recovery_steps=FAULT_RECOVERY_STEPS),
        schedule=FAULT_STALL,
        flags={"FLAGS_serving_step_timeout_s": FAULT_TIMEOUT_S})
    relaunch = check_stall_run("faults stall", model, prompts, oracle, stall,
                               layers)
    relaunch["peak_bytes"] = torch.cuda.max_memory_allocated()
    say(f"faults stall [{CARD}]: peak memory {relaunch['peak_bytes']} bytes "
        "with both pool sets alive")

    # stall past the cap: failed, every request unhealthy, submit rejected
    def late_submit(engine, reqs):
        late = engine.submit(prompts[0], max_new_tokens=2)
        return late.done, late.error_kind

    cap = runs["cap"] = fault_run(
        "faults cap", model, prompts, dict(kw, max_watchdog_relaunches=0),
        schedule=FAULT_STALL,
        flags={"FLAGS_serving_step_timeout_s": FAULT_TIMEOUT_S},
        during=late_submit)
    kinds = [r.error_kind for r in cap["reqs"]]
    if kinds != ["unhealthy"] * len(prompts) or \
            any(o is not None for o in cap["outs"]):
        fail(f"faults cap: error kinds {kinds}, want every one unhealthy")
    if cap["health"][-1:] != ["failed"] or \
            cap["extra"] != (True, "unhealthy"):
        fail(f"faults cap: health {cap['health']}, late submit "
             f"{cap['extra']}")

    # a deadline that ends mid-batch (half the clean run's wall time)
    deadline_s = clean["wall"] / 2
    late = runs["deadline"] = fault_run(
        "faults deadline", model, prompts, dict(kw, prefix_caching=False),
        submit_kw={FAULT_DEADLINE_REQUEST: {"deadline_s": deadline_s}})
    r = late["reqs"][FAULT_DEADLINE_REQUEST]
    if r.error_kind != "deadline" or \
            not 0 < len(r.tokens) < SERVE["new"]:
        fail(f"faults deadline: request {FAULT_DEADLINE_REQUEST} ended "
             f"{r.error_kind} after {len(r.tokens)} tokens (deadline "
             f"{deadline_s:.3f} s), want a cancel mid-batch")
    hold_tokens("faults deadline", model, prompts, oracle, late["outs"],
                skip=(FAULT_DEADLINE_REQUEST,))
    if late["stats"]["free_pages"] != late["free0"]:
        fail(f"faults deadline: {late['stats']['free_pages']} free pages "
             f"after the run, {late['free0']} before")
    if (late["k7"], late["k6c"]) != (clean["k7"], clean["k6c"]):
        fail(f"faults deadline: K7/K6c launches {late['k7']}/{late['k6c']}, "
             f"the clean run's {clean['k7']}/{clean['k6c']}")
    say(f"faults deadline [{CARD}]: request {FAULT_DEADLINE_REQUEST} "
        f"cancelled after {len(r.tokens)} of {SERVE['new']} tokens at "
        f"deadline_s {deadline_s:.3f}")

    predicted = predicted_admission(model, prompts, oracle, clean, kw)
    runs["predicted"] = predicted["run"]
    slo = slo_watchdog(clean["dir"], predicted["model_dir"])
    for run in runs.values():
        shutil.rmtree(run["dir"], ignore_errors=True)
    shutil.rmtree(predicted["model_dir"], ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    say(f"phase 4f [{CARD}]: {phase_s:.1f} s")
    return dict(runs=runs, relaunch=relaunch, predicted=predicted, slo=slo,
                k7=clean["k7"], k6c=clean["k6c"], phase_s=phase_s)


def predicted_admission(model, prompts, oracle, clean, kw):
    """Fit a batch_step head to the clean run's own timings, then serve
    again with a budget between its decode-step and 512-token-prefill
    predictions: admissions are deferred, every token equals the clean
    run's, every serving_admit carries its prediction, and a doomed
    deadline is rejected up front."""
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_perf_model_")
    perf, summary = fit_from_telemetry(None, [clean["dir"]])
    if not perf.has("batch_step"):
        fail(f"predicted admission: no batch_step head fitted: {summary}")
    save_model(perf, model_dir)
    steps = [e for e in clean["recs"] if e["kind"] == "batch_step"
             and e["prefill_seqs"] == 0]
    occ = float(np.median([e["page_occupancy"] for e in steps]))
    # the two prices, as the scheduler's admission features give them: a
    # decode step of the full batch, and the step that admits the
    # 512-token prompt into a batch of b - 1 decoding lanes
    b = SERVE_ENGINE["max_batch"]
    n = max(len(p) for p in prompts)
    decode = perf.predict("batch_step", dict(
        batch=b, prefill_seqs=0, decode_seqs=b, q_width=1, tokens=b,
        queue_depth=0, page_occupancy=occ, fused_steps=1))
    prefill = perf.predict("batch_step", dict(
        batch=b, prefill_seqs=1, decode_seqs=b - 1, q_width=n,
        tokens=n + b - 1, queue_depth=0, page_occupancy=occ, fused_steps=1))
    budget = math.sqrt(decode * prefill)
    say(f"predicted admission [{CARD}]: batch_step head on "
        f"{summary['batch_step']['n_samples']} steps of the clean run "
        f"(holdout MALE {summary['batch_step']['holdout_male']}); predicted "
        f"decode step ({b} lanes) {decode:.6f} s, the {n}-token prefill "
        f"admitted beside {b - 1} decoding lanes {prefill:.6f} s; budget "
        f"max_step_cost_s {budget:.6f} s (their geometric mean)")
    if not prefill > 1.5 * decode:
        fail(f"predicted admission: the head predicts the {n}-token "
             f"prefill ({prefill}) no dearer than a decode step ({decode})")

    def doomed(engine, reqs):
        r = engine.submit(prompts[0], max_new_tokens=SERVE["new"],
                          deadline_s=1e-3)
        return r.done, r.error_kind, r.error

    run = fault_run("faults predicted", model, prompts,
                    dict(kw, perf_model=perf, max_step_cost_s=budget),
                    during=doomed)
    if run["stats"]["deferred_admissions"] < 1:
        fail("predicted admission: no admission was deferred")
    hold_tokens("faults predicted", model, prompts, oracle, run["outs"])
    admits = [e for e in run["recs"] if e["kind"] == "serving_admit"]
    if not admits or any(e["predicted_cost_s"] is None for e in admits):
        fail(f"predicted admission: serving_admit without predicted_cost_s: "
             f"{[e['predicted_cost_s'] for e in admits]}")
    done, kind, err = run["extra"]
    if not done or kind != "deadline":
        fail(f"predicted admission: a doomed deadline gave {kind}: {err}")
    say(f"predicted admission [{CARD}]: {run['stats']['deferred_admissions']}"
        f" deferred admissions; predicted_cost_s of the {len(admits)} "
        f"admissions {[e['predicted_cost_s'] for e in admits]}; the doomed "
        f"deadline: {err}")
    return dict(run=run, decode_s=decode, prefill_s=prefill, budget_s=budget,
                model_dir=model_dir, summary=summary["batch_step"])


def slo_watchdog(log_dir, model_dir):
    """``python -m paddle_tpu_torch.observability watchdog --perf-model``
    over the clean run's log, against the head fitted to it: exit 0."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.observability", "watchdog",
           "--dir", log_dir, "--perf-model", model_dir]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=str(Path(__file__).resolve().parent))
    say(f"slo watchdog: exit {proc.returncode}: {proc.stdout.strip()} "
        f"{proc.stderr.strip()}")
    if proc.returncode != 0:
        fail(f"the SLO watchdog over the clean run exited {proc.returncode}")
    return proc.returncode


def llama_relaunch_main_path(model):
    """Phase 4g on phase 10's llama2-7b (32 layers, fp32): a clean run,
    then one watchdog relaunch; every stream equal to the clean run's, the
    peak memory with both pool sets alive."""
    t_phase = time.perf_counter()
    cfg = model.config
    layers = cfg.num_layers
    prompts, _ = serve_prompts(cfg.vocab_size)
    kw = dict(SERVE_ENGINE, max_pages_per_seq=LLAMA_SERVE_PAGES,
              num_pages=SERVE_ENGINE["max_batch"] * LLAMA_SERVE_PAGES + 1)
    clean = fault_run("llama relaunch clean", model, prompts, kw)
    check_oracle("llama relaunch clean", clean, cfg.vocab_size)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    stall = fault_run(
        "llama relaunch", model, prompts,
        dict(kw, health_recovery_steps=FAULT_RECOVERY_STEPS),
        schedule=FAULT_STALL,
        flags={"FLAGS_serving_step_timeout_s": FAULT_TIMEOUT_S})
    peak = torch.cuda.max_memory_allocated()
    relaunch = check_stall_run("llama relaunch", model, prompts,
                               clean["outs"], stall, layers)
    hd = cfg.hidden_size // cfg.num_heads
    pool_bytes = 2 * layers * cfg.num_kv_heads * kw["num_pages"] \
        * SERVE_ENGINE["page_size"] * hd * 4
    relaunch.update(peak_bytes=peak, pool_bytes=pool_bytes)
    for run in (clean, stall):
        shutil.rmtree(run["dir"], ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    say(f"phase 4g [{CARD}]: {phase_s:.1f} s; peak memory {peak} bytes with "
        f"both pool sets alive (pools {pool_bytes} bytes each); K7 launches "
        f"{stall['k7']}, K6c {stall['k6c']} (clean run {clean['k7']}, "
        f"{clean['k6c']})")
    return dict(relaunch=relaunch, k7=stall["k7"], k6c=stall["k6c"],
                clean_k7=clean["k7"], clean_k6c=clean["k6c"], phase_s=phase_s)


# ---------------------------------------------------------------------------
# phase 4h: fleet serving — two GPT-3 1.3B replicas behind the router
# ---------------------------------------------------------------------------

FLEET_REPLICAS = 2
FLEET_SHARED = dict(streams=8, pages=2, tail=(4, 16))  # the prefix's streams
FLEET_TRIGGER_TOKENS = 4         # tokens some stream has at a kill / restart
FLEET_READY_S = 180.0            # a replica's limit to publish its port file
FLEET_WAIT_S = 600.0             # the phase's limit on any one stream
FLEET_MODEL_WAIT_S = 60.0        # the router's limit to merge the models
ROOT = str(Path(__file__).resolve().parent)


def fleet_prompts(vocab):
    """Eight prompts sharing a 2-page (32-token) prefix, each with 4-16
    tokens of its own, then phase 4's eight (17-512 tokens); the shared
    prefix."""
    rs = np.random.RandomState(1)
    shared = rs.randint(0, vocab, (FLEET_SHARED["pages"]
                                   * SERVE_ENGINE["page_size"],)).tolist()
    lo, hi = FLEET_SHARED["tail"]
    prompts = [shared + rs.randint(0, vocab,
                                   (int(rs.randint(lo, hi + 1)),)).tolist()
               for _ in range(FLEET_SHARED["streams"])]
    return prompts + serve_prompts(vocab)[0], shared


def fleet_oracle(model, prompts):
    """The prompts through one in-process engine on phase 4's model (every
    request queued before the loop starts): the tokens and the wall s."""
    engine = ServingEngine(model, **SERVE_ENGINE, device=model.device)
    t0 = time.perf_counter()
    engine._accepting = True
    reqs = [engine.submit(p, max_new_tokens=SERVE["new"]) for p in prompts]
    engine.start()
    outs = [r.wait(timeout=FLEET_WAIT_S) for r in reqs]
    wall = time.perf_counter() - t0
    engine.stop()
    vocab = model.config.vocab_size
    for i, o in enumerate(outs):
        if len(o) != SERVE["new"] or not all(0 <= x < vocab for x in o):
            fail(f"fleet oracle: request {i} returned {o}")
    del engine, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return outs, wall


def fleet_wave(tag, url, prompts, trigger=None):
    """Every prompt as a concurrent greedy ``generate_http`` stream through
    the router.  ``trigger()`` runs on this thread once some stream has
    ``FLEET_TRIGGER_TOKENS`` tokens.  A stream that fails leaves None.
    ``ttft`` is each stream's first token from the wave's start, ``wall``
    the wave's start to its last stream's end."""
    outs = [None] * len(prompts)
    ttft = [None] * len(prompts)
    ends = [None] * len(prompts)
    started = threading.Event()
    t0 = time.perf_counter()

    def run(i):
        toks = []
        try:
            for t in generate_http(url, prompts[i],
                                   max_new_tokens=SERVE["new"],
                                   timeout=FLEET_WAIT_S):
                if not toks:
                    ttft[i] = time.perf_counter() - t0
                toks.append(int(t))
                if len(toks) >= FLEET_TRIGGER_TOKENS:
                    started.set()
            outs[i] = toks
            ends[i] = time.perf_counter()
        except (RuntimeError, OSError) as e:
            say(f"{tag}: stream {i} failed: {e!r}")

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    extra = None
    if trigger is not None:
        if not started.wait(timeout=FLEET_WAIT_S):
            fail(f"{tag}: no stream reached {FLEET_TRIGGER_TOKENS} tokens")
        extra = trigger()
    for t in threads:
        t.join(timeout=FLEET_WAIT_S + 60)
    if any(t.is_alive() for t in threads):
        fail(f"{tag}: a stream did not end in {FLEET_WAIT_S} s")
    # the wave ends with its last stream (a rolling restart outlasts it)
    wall = max([e for e in ends if e is not None] or [time.perf_counter()]) \
        - t0
    return dict(outs=outs, wall=wall, ttft=ttft, extra=extra)


def fleet_ttft(hist, before):
    """p50 / p99 of the router's ``paddle_fleet_ttft_seconds`` histogram
    over the observations since ``before`` (its bucket counts then)."""
    from paddle_tpu_torch.observability.metrics import HistogramValue
    delta = HistogramValue(hist.buckets)
    delta.bucket_counts = [a - b for a, b in
                           zip(hist.bucket_counts, before)]
    delta.count = sum(delta.bucket_counts)
    return delta.quantile(0.5), delta.quantile(0.99), delta.count


def replica_health(tag, sup, layers, require):
    """Each published replica's ``/health``: K7 launches equal to
    ``layers`` x its dispatched iterations (and > 0 with ``require``)."""
    out = {}
    for h in sup.replicas:
        if h.url is None:
            continue
        with urllib.request.urlopen(h.url.rstrip("/") + "/health",
                                    timeout=60) as r:
            st = json.loads(r.read())["engine"]
        dispatched = st["steps"] + st["window_idle_iterations"]
        k7 = st["kernel_launches"]
        if k7 != layers * dispatched or (require and k7 == 0):
            fail(f"{tag}: replica {h.id}'s K7 launches {k7} are not "
                 f"{layers} x {dispatched} dispatched iterations (> 0)")
        out[h.id] = dict(k7=k7, steps=st["steps"], pid=h.proc.pid,
                         decode_step_s=st["decode_step_s"],
                         prefix_hits=st["prefix_cache"]["hits"])
    say(f"{tag} [{CARD}]: replicas' /health: {json.dumps(out)}")
    return out


def card_memory_mib() -> int:
    """``nvidia-smi``'s memory.used of the card, in MiB."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return int(smi.stdout.strip().splitlines()[0])


def replica_memory(tag, sup, before_mib):
    """``nvidia-smi --query-compute-apps`` beside each replica's pid, and
    the card's memory.used over ``before_mib`` (its reading before the
    replicas started): what the replicas hold together."""
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    pids = {str(h.proc.pid): h.id for h in sup.replicas if h.alive}
    held = card_memory_mib() - before_mib
    say(f"{tag} [{CARD}]: replica pids {pids}; nvidia-smi compute apps: "
        f"{smi.stdout.strip().splitlines()} (this process {os.getpid()}); "
        f"the card's memory.used grew {held} MiB since before the "
        f"{len(pids)} replicas started")
    return dict(apps=smi.stdout.strip().splitlines(), replicas_mib=held)


def fit_replica_models(tag, dirs):
    """``python -m paddle_tpu_torch.tuning fit --from-events`` on each
    replica's event log, all at once: each writes its perf_model.json."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tuning", "--dir", tune,
         "fit", "--from-events", obs], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for obs, tune in dirs]
    versions = []
    for (obs, tune), proc in zip(dirs, procs):
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            fail(f"{tag}: tuning fit on {obs} exited {proc.returncode}: "
                 f"{out.strip()} {err.strip()}")
        summary = json.loads(out)
        say(f"{tag}: tuning fit on {os.path.basename(obs)}: version "
            f"{summary['perf_model_version']}, batch_step "
            f"{json.dumps(summary['perf_model'].get('batch_step'))}")
        versions.append(load_model(tune).version)
    return versions


def fleet_main_path(model):
    """Phase 4h on GPT-3 1.3B: the oracle on phase 4's model, then two
    replicas of the port's fleet worker at the same widths and seed behind
    the router, in three waves (clean; the prefix's owner SIGKILLed; a
    rolling restart), each stream held to the oracle."""
    t_phase = time.perf_counter()
    cfg = model.config
    layers, vocab = cfg.num_layers, cfg.vocab_size
    prompts, shared = fleet_prompts(vocab)
    oracle, oracle_wall = fleet_oracle(model, prompts)
    n_tok = len(prompts) * SERVE["new"]
    say(f"fleet oracle [{CARD}]: {len(prompts)} requests through one engine "
        f"in {oracle_wall:.3f} s = {n_tok / oracle_wall:.1f} tokens/s")

    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    obs_router = os.path.join(root, "obs-router")
    dirs = [(os.path.join(root, f"obs-{i}"), os.path.join(root, f"tune-{i}"))
            for i in range(FLEET_REPLICAS)]
    worker_args = ["--layers", str(layers), "--hidden", str(cfg.hidden_size),
                   "--heads", str(cfg.num_heads), "--vocab", str(vocab),
                   "--max-pos", str(cfg.max_position_embeddings),
                   "--max-batch", str(SERVE_ENGINE["max_batch"]),
                   "--page-size", str(SERVE_ENGINE["page_size"]),
                   "--seed", "0", "--device", model.device.type]
    env = {"FLAGS_observability_dir": os.path.join(root, "obs-{replica}"),
           "FLAGS_tuning_cache_dir": os.path.join(root, "tune-{replica}"),
           "PYTHONPATH": os.pathsep.join(
               [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    set_flags({"FLAGS_observability_dir": obs_router})
    sup = ReplicaSupervisor(FLEET_REPLICAS, worker_args=worker_args, env=env,
                            ready_timeout=FLEET_READY_S)
    router = None
    waves = {}
    try:
        before_mib = card_memory_mib()
        t0 = time.perf_counter()
        sup.start()
        start_s = time.perf_counter() - t0
        say(f"fleet [{CARD}]: {FLEET_REPLICAS} replicas published their "
            f"ports in {start_s:.3f} s")
        router = FleetRouter(sup, page_size=SERVE_ENGINE["page_size"],
                             model_dirs=[tune for _, tune in dirs],
                             poll_interval=0.25).start()
        hist = router._h_ttft.hist

        def wave(tag, trigger=None):
            before = list(hist.bucket_counts)
            stats0 = router.fleet_stats()
            t_start = time.time()
            res = fleet_wave(tag, router.url, prompts, trigger)
            hold_tokens(tag, model, prompts, oracle, res["outs"])
            p50, p99, n = fleet_ttft(hist, before)
            stats = router.fleet_stats()
            res.update(t_start=t_start, ttft_p50=p50, ttft_p99=p99,
                       tokens_per_s=n_tok / res["wall"], stats=stats,
                       resubmitted=stats["resubmitted"]
                       - stats0["resubmitted"],
                       affinity_hits=stats["affinity_hits"]
                       - stats0["affinity_hits"])
            say(f"{tag} [{CARD}]: {len(prompts)} streams, {n_tok} tokens in "
                f"{res['wall']:.3f} s = {res['tokens_per_s']:.1f} tokens/s "
                f"(one engine: {n_tok / oracle_wall:.1f}); router TTFT p50 "
                f"{p50:.4f} s, p99 {p99:.4f} s ({n} observations); client "
                f"TTFT max {max(t for t in res['ttft'] if t is not None):.4f}"
                f" s; affinity hits "
                f"{res['affinity_hits']}, resubmitted {res['resubmitted']}; "
                f"every stream equal to the oracle up to near-ties")
            return res

        # wave 1: clean; both replicas launched K7, then each fits its model
        waves["clean"] = wave("fleet wave 1")
        health1 = replica_health("fleet wave 1", sup, layers, require=True)
        mem = replica_memory("fleet wave 1", sup, before_mib)
        if waves["clean"]["affinity_hits"] < 1:
            fail("fleet wave 1: no affinity hit")
        versions = fit_replica_models("fleet", dirs)
        want_version = max(versions) + 1
        deadline = time.monotonic() + FLEET_MODEL_WAIT_S
        while router.fleet_stats()["model_version"] != want_version:
            if time.monotonic() > deadline:
                fail(f"fleet: the router's merged model is version "
                     f"{router.fleet_stats()['model_version']}, want "
                     f"{want_version} (inputs {versions})")
            time.sleep(0.05)
        say(f"fleet: merged model version {want_version} from replica "
            f"versions {versions}")

        # wave 2: SIGKILL the prefix's owner mid-stream
        owner = router._owners[router._prompt_keys(shared)[-1]]
        h_owner = next(h for h in sup.replicas if h.id == owner)
        back = {}

        def kill():
            t_kill = time.perf_counter()
            sup.kill(owner)

            def watch():
                while time.perf_counter() - t_kill < FLEET_READY_S + 60:
                    if h_owner.restarts >= 1 and h_owner.routable():
                        back["s"] = time.perf_counter() - t_kill
                        return
                    time.sleep(0.05)

            back["thread"] = threading.Thread(target=watch, daemon=True)
            back["thread"].start()
            return t_kill

        waves["kill"] = wave("fleet wave 2", trigger=kill)
        back["thread"].join(timeout=FLEET_READY_S + 90)
        if "s" not in back:
            fail(f"fleet wave 2: replica {owner} not routable again")
        if waves["kill"]["resubmitted"] < 1:
            fail("fleet wave 2: no stream was resubmitted")
        restarts = read_events(obs_router, kinds=["replica_restart"])
        crash = [e for e in restarts if e["reason"] == "crash"]
        if [e["replica"] for e in crash] != [owner]:
            fail(f"fleet wave 2: crash events {crash}, want one for {owner}")
        say(f"fleet wave 2 [{CARD}]: replica {owner} (the prefix's owner) "
            f"SIGKILLed; routable again {back['s']:.3f} s later")
        replica_health("fleet wave 2", sup, layers, require=False)

        # wave 3: a rolling restart mid-traffic
        t_roll = {}

        def roll():
            t = time.perf_counter()
            sup.rolling_restart()
            t_roll["s"] = time.perf_counter() - t

        waves["rolling"] = wave("fleet wave 3", trigger=roll)
        rolling = [e for e in read_events(obs_router,
                                          kinds=["replica_restart"])
                   if e["reason"] == "rolling"]
        if len(rolling) != FLEET_REPLICAS:
            fail(f"fleet wave 3: {len(rolling)} rolling restart events")
        say(f"fleet wave 3 [{CARD}]: rolling restart of {FLEET_REPLICAS} "
            f"replicas in {t_roll['s']:.3f} s")
        replica_health("fleet wave 3", sup, layers, require=False)
        routes = [e for e in read_events(obs_router, kinds=["router_route"])
                  if e["ts"] >= waves["kill"]["t_start"]]
        bare = [e for e in routes if e.get("predicted_cost_s") is None]
        if not routes or bare:
            fail(f"fleet: {len(bare)} of {len(routes)} router_route events "
                 "of waves 2 and 3 lack predicted_cost_s")
        costs = sorted(e["predicted_cost_s"] for e in routes)
        say(f"fleet: {len(routes)} router_route events of waves 2 and 3 "
            f"carry predicted_cost_s ({costs[0]:.3e}-{costs[-1]:.3e} s)")
    finally:
        if router is not None:
            router.stop()
        sup.stop()
        set_flags({"FLAGS_observability_dir": ""})
    alive = [h.id for h in sup.replicas if h.alive]
    if alive:
        fail(f"fleet: replicas {alive} outlived the supervisor's stop")
    shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    say(f"phase 4h [{CARD}]: {phase_s:.1f} s")
    return dict(k7=sum(r["k7"] for r in health1.values()), health=health1,
                waves={k: {f: v[f] for f in ("wall", "tokens_per_s",
                                             "ttft_p50", "ttft_p99",
                                             "resubmitted", "affinity_hits")}
                       for k, v in waves.items()},
                oracle_tokens_per_s=n_tok / oracle_wall, back_s=back["s"],
                rolling_s=t_roll["s"], memory=mem, start_s=start_s,
                phase_s=phase_s)


def fleet_alone() -> int:
    """``--fleet``: phase 4h alone (the kernels built, GPT-3 1.3B from phase
    4's seed as the oracle's model, then the fleet); its numbers and its
    checks as in the full run."""
    say(f"build: {_build.build_all():.3f} s")
    model = GPTForPretraining(gpt_config("gpt3-1.3B", hidden_dropout_prob=0.0,
                                         attention_dropout_prob=0.0), seed=0)
    say(json.dumps(fleet_main_path(model)))
    return 0


# ---------------------------------------------------------------------------
# phase 4b: the compiled decode loop of GPT-3 1.3B
# ---------------------------------------------------------------------------

GPT_DECODE = dict(batch=8, prompt=256, new=64)
K6_KEYS = ("rope_qkv", "attend_cache_append", "norm_mlp")


def decode_call(model, ids, new, **kw):
    """One ``decode_loop`` call, synchronised: (tokens, seconds, the
    launches it made, ``generation.decode_stats``)."""
    torch.cuda.synchronize()
    before = counts()
    t0 = time.perf_counter()
    out = generation.decode_loop(model, ids, max_new_tokens=new, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = counts()
    return (out, dt, {k: after[k] - before[k] for k in after},
            dict(generation.decode_stats))


def check_decode_launches(tag, moved, stats, layers, prefill):
    """Exact launches of one greedy call: K6a/b/c once per layer per decode
    step, the prefill's kernels once, nothing else."""
    steps = stats["steps"]
    want = {k: 0 for k in moved}
    want.update({k: layers * steps for k in K6_KEYS}, **prefill)
    if moved != want:
        fail(f"{tag}: launches {moved} != {want}")
    say(f"{tag}: launches per call: K6a/K6b/K6c {layers} x {steps} decode "
        f"steps = {moved['rope_qkv']} each; prefill "
        f"{ {k: moved[k] for k in prefill} }")


def check_greedy_rows(tag, out, ids, new, vocab):
    b, s = ids.shape
    if tuple(out.shape) != (b, s + new) or not torch.equal(out[:, :s], ids):
        fail(f"{tag}: output {tuple(out.shape)} is not the prompt + {new} "
             "tokens per row")
    gen = out[:, s:]
    if not ((gen >= 0) & (gen < vocab)).all():
        fail(f"{tag}: a token outside the vocabulary")


def gpt_decode_main_path(model):
    """``decode_loop`` greedy on phase 4's GPT-3 1.3B (fp32, 24 layers)."""
    cfg = model.config
    b, s, new = GPT_DECODE["batch"], GPT_DECODE["prompt"], GPT_DECODE["new"]
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s))).cuda()
    t0 = time.perf_counter()
    reset_counts()                   # count the main path's launches only
    out, dt_cold, moved, stats = decode_call(model, ids, new)
    check_greedy_rows("gpt decode", out, ids, new, cfg.vocab_size)
    check_decode_launches("gpt decode", moved, stats, N_LAYERS,
                          {"flash_fwd": N_LAYERS, "ln_fwd": 2 * N_LAYERS + 1})
    out2, dt, _, stats2 = decode_call(model, ids, new)
    if not torch.equal(out, out2):
        fail("gpt decode: a second greedy call gave other tokens")
    t1 = time.perf_counter()
    with torch.no_grad():
        model(ids, use_cache=True, last_logits_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    say(f"gpt decode: gpt3-1.3B fp32, batch {b} x prompt {s} + {new} new: "
        f"{dt:.3f} s per call (first {dt_cold:.3f} s), "
        f"{1e3 * dt / new:.2f} ms per token, {b * new / dt:.1f} tokens/s; "
        f"a prefill alone {prefill_s:.3f} s, so "
        f"{1e3 * (dt - prefill_s) / stats2['steps']:.2f} ms per decode "
        f"step; host reads per call {stats2['host_reads']}")
    say(f"phase 4b: {time.perf_counter() - t0:.1f} s")
    return dict(launches={k: moved[k] for k in K6_KEYS}, ms_per_token=
                1e3 * dt / new, tokens_per_s=b * new / dt)


# ---------------------------------------------------------------------------
# phase 5: K1, K2, K3 against their plain versions
# ---------------------------------------------------------------------------

def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def close_excess(got, want, dtype) -> float:
    """max(|got - want| - (atol + rtol |want|)) under KTOL: above 0 where
    the two are not close; inf where got is not finite."""
    atol, rtol = KTOL[dtype]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        return float("inf")
    return ((g - w).abs() - (atol + rtol * w.abs())).max().item()


def check_close(what, got, want, dtype):
    """Fail unless |got - want| <= atol + rtol |want| everywhere (KTOL)."""
    atol, rtol = KTOL[dtype]
    if not torch.isfinite(got.float()).all():
        fail(f"{what}: non-finite kernel output")
    if close_excess(got, want, dtype) > 0:
        fail(f"{what}: max abs err {max_err(got, want):.3e} exceeds "
             f"atol {atol} + rtol {rtol} |plain|")


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def visible_pairs(sq, sk, causal, q_offset):
    """(query, key) pairs the mask lets through, per head."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, q_offset + i + 1)) for i in range(sq))


def rand(shape, dtype, g, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


# name: (B*Hq, Sq, Sk, n_rep, causal, dtype, head_dim); "main" is the GPT
# training path's shape (batch 4 x 16 heads, seq 2048, head_dim 128, bf16,
# causal), "llama" the LLaMA training path's (batch 2 x 32 heads, seq
# 4096).  bf16 runs on the tensor cores; its edges: a bottom-right
# q_offset, a ragged causal S = 1000, D = 64, D = 100 (not a multiple of
# 8: the scalar staging path) with GQA, and one query row against 2048
# keys (q_offset 2047: one live warp in a query tile).
K1_CASES = {
    "causal-bf16": (16, 2048, 2048, 1, True, torch.bfloat16, 128),
    "causal-fp32": (16, 2048, 2048, 1, True, torch.float32, 128),
    "full-bf16": (16, 2048, 2048, 1, False, torch.bfloat16, 128),
    "full-fp32": (16, 2048, 2048, 1, False, torch.float32, 128),
    "q_offset-fp32": (16, 512, 2048, 1, True, torch.float32, 128),
    "gqa4-bf16": (16, 2048, 2048, 4, True, torch.bfloat16, 128),
    "q_offset-bf16": (16, 512, 2048, 1, True, torch.bfloat16, 128),
    "ragged-bf16": (16, 1000, 1000, 1, True, torch.bfloat16, 128),
    "d64-bf16": (16, 2048, 2048, 1, True, torch.bfloat16, 64),
    "d100-gqa2-bf16": (16, 1000, 1000, 2, True, torch.bfloat16, 100),
    "q1-bf16": (64, 1, 2048, 1, True, torch.bfloat16, 128),
    "main": (64, 2048, 2048, 1, True, torch.bfloat16, 128),
    "llama": (64, 4096, 4096, 1, True, torch.bfloat16, 128),
    # the ring's chunk calls at llama2-7b's attention shape under cp 4
    # (phase 20): a rank's own chunk (causal, q_offset 0) and an earlier
    # one (every key visible)
    "ring-diag": (64, 1024, 1024, 1, True, torch.bfloat16, 128),
    "ring-full": (64, 1024, 1024, 1, False, torch.bfloat16, 128),
    # ERNIE-MoE's attention (phase 22): batch 8 x 12 heads, non-causal
    "ernie": (96, 512, 512, 1, False, torch.bfloat16, 64),
}
# the bf16 kernels, which must hold tensor-core instructions (and the
# CUDA-core `_fp32` kernels none)
TC_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
              "flash_bwd_dkv_kernel")


def parse_sass(text: str) -> dict:
    """HMMA / HGMMA (tensor-core) instruction counts per function of
    ``cuobjdump -sass`` output, keyed by mangled name."""
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHG?MMA\b", line):
            counts[fn] += 1
    return counts


def tc_instances(counts: dict, kernel: str) -> dict:
    """{head_dim: count} of the instantiations of template ``kernel``."""
    token = f"{len(kernel)}{kernel}I"       # <length><name>I<args>E
    return {int(re.search(r"ILi(\d+)E", fn).group(1)): n
            for fn, n in counts.items() if token in fn}


def check_sass():
    """Fail unless the bf16 forward and both bf16 backward kernels (D = 64
    and 128) hold tensor-core instructions in the built library's SASS,
    and the fp32 kernels none."""
    lib = _build.library("flash_attention")._name
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib}: {out.stderr.strip()}")
    counts = parse_sass(out.stdout)
    found = {k: tc_instances(counts, k) for k in TC_KERNELS}
    say("sass: HMMA/HGMMA per kernel " + json.dumps(
        {fn: n for fn, n in counts.items() if "flash" in fn}))
    for kernel, by_d in found.items():
        if sorted(by_d) != [64, 128] or not all(by_d.values()):
            fail(f"{kernel}: tensor-core instructions by head_dim {by_d}")
    fp32 = {fn: n for fn, n in counts.items() if "_fp32_kernel" in fn}
    if len(fp32) != 6 or any(fp32.values()):
        fail(f"fp32 kernels: tensor-core instructions {fp32}")
    return found


def check_k1():
    rows = {}
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    for case, (bh, sq, sk, n_rep, causal, dtype, d) in K1_CASES.items():
        scale = 1.0 / d ** 0.5
        q = rand((bh, sq, d), dtype, g).requires_grad_()
        k = rand((bh // n_rep, sk, d), dtype, g).requires_grad_()
        v = rand((bh // n_rep, sk, d), dtype, g).requires_grad_()
        do = rand((bh, sq, d), dtype, g)
        off = sk - sq if causal else 0
        # the ring's chunk calls take their gradients in fp32
        g32 = case.startswith("ring")
        before = dict(fa.launches)
        out, lse = fa.flash_attention_fwd(q, k, v, scale, causal, off, n_rep,
                                          out_fp32=g32)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, scale,
                                            causal, off, n_rep,
                                            grads_fp32=g32)
        torch.cuda.synchronize()
        if any(fa.launches[n] != before[n] + 1 for n in before):
            fail(f"K1 {case}: launch counters did not move: {fa.launches}")
        ref, ref_lse = fa.reference_attention_bhsd(q, k, v, scale, causal,
                                                   off, n_rep,
                                                   return_lse=True)
        rdq, rdk, rdv = torch.autograd.grad(ref, (q, k, v), do,
                                            retain_graph=True)
        for name, a, b in (("O", out, ref), ("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
            want_dt = torch.float32 if g32 else dtype
            if a.dtype != want_dt or a.shape != b.shape:
                fail(f"K1 {case} {name}: {a.dtype} {tuple(a.shape)}")
            check_close(f"K1 {case} {name}", a, b, dtype)
        check_close(f"K1 {case} LSE", lse, ref_lse, torch.float32)
        errs = dict(o=max_err(out, ref), lse=max_err(lse, ref_lse),
                    dq=max_err(dq, rdq), dkv=max(max_err(dk, rdk),
                                                 max_err(dv, rdv)))
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        fwd = lambda: fa.flash_attention_fwd(qd, kd, vd, scale, causal, off,
                                             n_rep, out_fp32=g32)
        o2, lse2 = fwd()
        delta = (o2.float() * do.float()).sum(-1)
        lib = _build.library("flash_attention")
        args = (sq, sk, d, n_rep, int(causal), off, scale,
                2 if g32 else fa._DTYPE_CODE[dtype])
        dq2, dk2, dv2 = (torch.empty(t.shape, dtype=dq.dtype,
                                     device=t.device) for t in (qd, kd, vd))
        stream = torch.cuda.current_stream().cuda_stream

        def dq_kernel():
            lib.flash_bwd_dq(qd.data_ptr(), kd.data_ptr(), vd.data_ptr(),
                             do.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
                             dq2.data_ptr(), bh, *args, stream)

        def dkv_kernel():
            lib.flash_bwd_dkv(qd.data_ptr(), kd.data_ptr(), vd.data_ptr(),
                              do.data_ptr(), lse2.data_ptr(),
                              delta.data_ptr(), dk2.data_ptr(),
                              dv2.data_ptr(), bh // n_rep, *args, stream)

        def plain_bwd():
            torch.autograd.grad(ref, (q, k, v), do, retain_graph=True)

        # the library yardstick: [B, H, S, D] views, GQA as repeated heads;
        # sdpa's causal mask is top-left, so Sq != Sk takes the bottom-right
        # mask explicitly (none where every pair is visible)
        lq = qd.reshape(1, bh, sq, d).clone().requires_grad_()
        lk = kd.repeat_interleave(n_rep, 0).reshape(1, bh, sk, d).clone() \
            .requires_grad_()
        lv = vd.repeat_interleave(n_rep, 0).reshape(1, bh, sk, d).clone() \
            .requires_grad_()
        lib_kw = dict(is_causal=causal)
        if causal and sq != sk:
            vis = torch.arange(sq, device="cuda")[:, None] + off \
                >= torch.arange(sk, device="cuda")[None]
            lib_kw = {} if vis.all() else dict(attn_mask=vis)
        lout = F.scaled_dot_product_attention(lq, lk, lv, **lib_kw)
        ldo = do.reshape(1, bh, sq, d)
        # the library's own distance from the plain version
        ldq, ldk, ldv = torch.autograd.grad(lout, (lq, lk, lv), ldo,
                                            retain_graph=True)
        group = (bh // n_rep, n_rep, sk, d)
        lib_errs = dict(
            o=max_err(lout.reshape(bh, sq, d), ref),
            dq=max_err(ldq.reshape(bh, sq, d), rdq),
            dkv=max(max_err(ldk.float().reshape(group).sum(1), rdk),
                    max_err(ldv.float().reshape(group).sum(1), rdv)))
        del ldq, ldk, ldv
        row = dict(case=case, bh=bh, sq=sq, sk=sk, d=d, n_rep=n_rep,
                   causal=causal, dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=errs, library_max_abs_err=lib_errs,
                   fwd_ms=time_ms(fwd, 10), dq_ms=time_ms(dq_kernel, 5),
                   dkv_ms=time_ms(dkv_kernel, 5),
                   plain_fwd_ms=time_ms(
                       lambda: fa.reference_attention_bhsd(
                           qd, kd, vd, scale, causal, off, n_rep), 3),
                   plain_bwd_ms=time_ms(plain_bwd, 3))
        row["library_fwd_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                lq.detach(), lk.detach(), lv.detach(), **lib_kw), 10)
        row["library_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo,
                                        retain_graph=True), 5)
        peak = PEAK_FLOPS[dtype]
        item = q.element_size()
        pairs = bh * visible_pairs(sq, sk, causal, off)
        io_q, io_kv = bh * sq * d * item, (bh // n_rep) * sk * d * item
        gw = 4 // item if g32 else 1     # fp32 outputs: twice the bytes
        row["fwd_bound"] = bound_ms((1 + gw) * io_q + 2 * io_kv + bh * sq * 4,
                                    4 * pairs * d, peak)
        row["dq_bound"] = bound_ms(
            (2 + gw) * io_q + 2 * io_kv + 2 * bh * sq * 4, 6 * pairs * d, peak)
        row["dkv_bound"] = bound_ms(
            2 * io_q + (2 + 2 * gw) * io_kv + 2 * bh * sq * 4, 8 * pairs * d,
            peak)
        say("K1 " + json.dumps(row))
        rows[case] = row
        del q, k, v, do, out, lse, dq, dk, dv, ref, ref_lse, rdq, rdk, rdv
        del lq, lk, lv, lout, o2, lse2, delta, dq2, dk2, dv2
        torch.cuda.empty_cache()
    return rows


# name: (N, H, x dtype, w/b dtype, x).  "float32" is the GPT training
# path's LayerNorm ([8192, 2048] fp32: batch 4 x 2048 tokens, under O2 in
# fp32), "bart" the BART path's (batch 8 x 1024 tokens, d_model 768) and
# "decode" the 8 rows of a GPT decode step (phases 12 and 16).  The vector
# route at each of its widths (768, 2048, 4096) in both dtypes; the
# generic route by an odd width and by a view one element past 16-byte
# alignment ("unaligned"); and "offset", x = K2_OFFSET + N(0, 1), where a
# one-pass variance E[x²] - mean² loses the digits the tolerance needs
# (its control, `mean_offset_control`, must fail the check; dw there is
# held as `offset_dw_want` says).  Other x are N(0, 2²).
K2_CASES = {
    "float32": (8192, 2048, torch.float32, torch.float32, "randn"),
    "bfloat16": (8192, 2048, torch.bfloat16, torch.float32, "randn"),
    "bart": (8192, 768, torch.float32, torch.float32, "randn"),
    "decode": (8, 2048, torch.float32, torch.float32, "randn"),
    "bart-bf16": (8192, 768, torch.bfloat16, torch.bfloat16, "randn"),
    "h4096": (8192, 4096, torch.float32, torch.bfloat16, "randn"),
    "odd-fp32": (37, 1001, torch.float32, torch.float32, "randn"),
    "odd-bf16": (37, 1001, torch.bfloat16, torch.bfloat16, "randn"),
    "unaligned": (8192, 2048, torch.float32, torch.float32, "unaligned"),
    "offset": (8192, 2048, torch.float32, torch.float32, "offset"),
    "wide-fp32": (512, 12288, torch.float32, torch.float32, "randn"),
    "wide-bf16": (512, 12288, torch.bfloat16, torch.float32, "randn"),
    "wide-odd": (512, 10007, torch.float32, torch.float32, "randn"),
    # ERNIE-MoE's LayerNorms (phase 22): 8 x 512 tokens, width 768, fp32
    # under O2 (black-listed)
    "ernie": (4096, 768, torch.float32, torch.float32, "randn"),
}
K2_OFFSET = 100.0


def one_pass_layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm with the one-pass variance E[x²] - mean², in plain fp32:
    the formula a one-pass kernel would use, for the mean-offset control."""
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True) - m.square()
    return ((xf - m) * torch.rsqrt(var + eps) * w.float()
            + b.float()).to(x.dtype)


def mean_offset_control(x, w, b):
    """The one-pass formula against the plain version on a mean-offset x:
    it must fall outside `check_close`'s tolerance, which shows that the
    case would catch a one-pass kernel.  Returns its excess."""
    excess = close_excess(one_pass_layer_norm(x, w, b),
                          ln.layer_norm_ref(x, w, b, 1e-5), x.dtype)
    say(f"K2 offset {K2_OFFSET}: the one-pass control's excess over the "
        f"tolerance {excess:.3e} (must be > 0)")
    if excess <= 0:
        fail("K2: the one-pass variance passes the mean-offset check")
    return excess


def offset_dw_want(x, mean, gy, dw_plain):
    """The plain dw on the mean-offset case, moved to first order by the
    kernel's and the plain version's fp32 means' difference d_i:
    dw_j - sum_i g_ij rstd_i d_i.  Each mean is a few ulps of 100 from the
    exact one, and dw sums that over 8192 rows of g: at offset 100 the
    plain fp32 dw itself is 1.5e-3 from a float64 one, past KTOL (a CPU
    run).  y, dx and db are held as in the other cases."""
    xf = x.float()
    m = xf.mean(dim=-1)
    r = torch.rsqrt((xf - m[:, None]).square().mean(dim=-1) + 1e-5)
    shift = (gy.double() * (r.double() * (mean - m).double())[:, None]) \
        .sum(0)
    return (dw_plain.double() - shift).float()


def k2_inputs(n, h, dtype, wdtype, kind, g):
    """x (a leaf that requires grad), w, b, the upstream gradient."""
    if kind == "offset":
        x = (K2_OFFSET + torch.randn((n, h), generator=g, device="cuda")) \
            .to(dtype)
    else:
        x = rand((n, h), dtype, g, 2.0)
    if kind == "unaligned":
        flat = torch.empty(n * h + 1, dtype=dtype, device="cuda")
        flat[1:].copy_(x.reshape(-1))
        x = flat[1:].view(n, h)
    w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(wdtype)
    b = (0.1 * torch.randn(h, generator=g, device="cuda")).to(wdtype)
    gy = rand((n, h), dtype, g)
    return (x.requires_grad_(), w.requires_grad_(), b.requires_grad_(), gy)


def check_k2():
    """Phase 5's K2 cases: y, dx, dw and db against the plain version, the
    route each takes (the wrapper's `route` and the kernel's `ln_route`
    agree), a relaunch of each kernel bitwise equal to the first, the
    mean-offset control, and the times."""
    rows = {}
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    lib = _build.library("layer_norm")
    for key, (n, h, dtype, wdtype, kind) in K2_CASES.items():
        x, w, b, gy = k2_inputs(n, h, dtype, wdtype, kind, g)
        want = ("vector" if h in ln.VECTOR_WIDTHS and kind != "unaligned"
                else "wide" if h > ln.GENERIC_MAX_H else "generic")
        got = ln.route(h, (x, w, b))
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, b))
        c_route = lib.ln_route(h, int(aligned))
        if got != want or c_route != {"vector": h, "generic": 0,
                                      "wide": 1}[want]:
            fail(f"K2 {key}: route {got} (kernel {c_route}), want {want}")
        before = dict(ln.launches)
        y = ln.layer_norm(x, w, b, 1e-5)
        dx, dw, db = torch.autograd.grad(y, (x, w, b), gy)
        torch.cuda.synchronize()
        if any(ln.launches[k] != before[k] + 1 for k in before):
            fail(f"K2 {key}: launch counters did not move: {ln.launches}")
        xd, wd_, bd = x.detach(), w.detach(), b.detach()
        y2, mean, rstd = ln.layer_norm_fwd(xd, wd_, bd, 1e-5)
        dx2 = ln.layer_norm_bwd(xd, wd_, mean, rstd, gy)
        torch.cuda.synchronize()
        if not (torch.equal(y2, y) and torch.equal(dx2, dx)):
            fail(f"K2 {key}: a relaunch is not bitwise equal to the first")
        yr = ln.layer_norm_ref(x, w, b, 1e-5)
        dxr, dwr, dbr = torch.autograd.grad(yr, (x, w, b), gy,
                                            retain_graph=True)
        control, dw_want = None, dwr
        if kind == "offset":
            control = mean_offset_control(xd, wd_, bd)
            dw_want = offset_dw_want(xd, mean, gy, dwr)
        for name, a, r, dt in (("y", y, yr, dtype), ("dx", dx, dxr, dtype),
                               ("dw", dw, dw_want, torch.float32),
                               ("db", db, dbr, torch.float32)):
            check_close(f"K2 {key} {name}", a, r, dt)
        # the library yardstick takes weights in x's dtype
        lw, lb = wd_.to(dtype), bd.to(dtype)
        lib_y = F.layer_norm(x, (h,), lw, lb, 1e-5)
        item, w_item = x.element_size(), w.element_size()
        row = dict(case=key, dtype=str(dtype).replace("torch.", ""),
                   w_dtype=str(wdtype).replace("torch.", ""), n=n, h=h,
                   route=got,
                   max_abs_err=dict(y=max_err(y, yr), dx=max_err(dx, dxr),
                                    dw=max_err(dw, dwr), db=max_err(db, dbr)),
                   one_pass_excess=control,
                   fwd_ms=time_ms(lambda: ln.layer_norm_fwd(xd, wd_, bd,
                                                            1e-5), 20),
                   dx_ms=time_ms(lambda: ln.layer_norm_bwd(xd, wd_, mean,
                                                           rstd, gy), 20),
                   dwdb_ms=time_ms(lambda: ln.layer_norm_dw_db(
                       xd, mean, rstd, gy, w.dtype, b.dtype), 20),
                   plain_fwd_ms=time_ms(lambda: ln.layer_norm_ref(
                       xd, wd_, bd, 1e-5), 5),
                   plain_dx_ms=time_ms(lambda: torch.autograd.grad(
                       yr, x, gy, retain_graph=True), 5),
                   library_fwd_ms=time_ms(lambda: F.layer_norm(
                       xd, (h,), lw, lb, 1e-5), 20),
                   library_dx_ms=time_ms(lambda: torch.autograd.grad(
                       lib_y, x, gy, retain_graph=True), 20),
                   fwd_bound=bound_ms(2 * n * h * item + 8 * n
                                      + 2 * h * w_item,
                                      8 * n * h, PEAK_FLOPS[torch.float32]),
                   dx_bound=bound_ms(3 * n * h * item + 8 * n + h * w_item,
                                     10 * n * h, PEAK_FLOPS[torch.float32]))
        say("K2 " + json.dumps(row))
        rows[key] = row
        del x, w, b, gy, y, dx, dw, db, yr, dxr, dwr, dbr, lib_y, y2, dx2
        torch.cuda.empty_cache()
    return rows


def check_k3():
    """A bf16 [2048, 8192] parameter on an fp32 master, an fp32 [2048]
    parameter, an fp32 [50265, 768] parameter (BART's shared embedding,
    its largest tensor; no master) and a bf16 [768, 3072] one on an fp32
    master (an ERNIE-MoE expert's weight, the shape of 768 of phase 22's
    1672 tensors), 3 steps with weight decay, kernel vs the plain
    sequence on identical copies.  Returns the timed rows: "main" (the
    [2048, 8192] one, GPT's and LLaMA's O2 case), "bart" and "ernie"."""
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01
    lr = torch.tensor([1e-4], device="cuda")
    betas = torch.tensor([b1, b2], device="cuda")
    rows = {}
    for shape, low, key in (((2048, 8192), True, "main"),
                            ((2048,), False, None),
                            ((50265, 768), False, "bart"),
                            ((768, 3072), True, "ernie")):
        err = 0.0
        master = rand(shape, torch.float32, g, 0.02)
        states = []
        for _ in range(2):         # [kernel, plain]
            states.append(dict(
                p=master.clone(), m=torch.zeros_like(master),
                v=torch.zeros_like(master),
                low=master.to(torch.bfloat16) if low else None,
                pows=torch.ones(2, device="cuda")))
        for _ in range(3):
            grad = rand(shape, torch.bfloat16 if low else torch.float32, g,
                        1e-3)
            for fn, st in ((adamw.fused_adamw_update_, states[0]),
                           (adamw.fused_adamw_update_ref_, states[1])):
                st["pows"].mul_(betas)
                before = adamw.launches
                fn(st["p"], grad, st["m"], st["v"], lr, st["pows"][0:1],
                   st["pows"][1:2], b1, b2, eps, wd, p_low=st["low"])
                if fn is adamw.fused_adamw_update_ \
                        and adamw.launches != before + 1:
                    fail("K3: launch counter did not move")
        torch.cuda.synchronize()
        k, r = states
        for name in ("p", "m", "v") + (("low",) if low else ()):
            e = max_err(k[name], r[name])
            scale = r[name].float().abs().max().item()
            if not torch.isfinite(k[name].float()).all() \
                    or e > ADAMW_TOL * max(scale, 1e-30):
                fail(f"K3 {shape} {name}: max abs err {e:.3e} (|max| "
                     f"{scale:.3e}, rtol {ADAMW_TOL})")
            err = max(err, e)
        if key is not None:
            st = k
            numel = master.numel()
            row = dict(shape=list(shape), max_abs_err=err, ms=time_ms(
                lambda: adamw.fused_adamw_update_(
                    st["p"], grad, st["m"], st["v"], lr, st["pows"][0:1],
                    st["pows"][1:2], b1, b2, eps, wd, p_low=st["low"]), 20),
                plain_ms=time_ms(lambda: adamw.fused_adamw_update_ref_(
                    r["p"], grad, r["m"], r["v"], lr, r["pows"][0:1],
                    r["pows"][1:2], b1, b2, eps, wd, p_low=r["low"]), 5),
                bound=bound_ms(28 * numel, 15 * numel,
                               PEAK_FLOPS[torch.float32]))
            # yardstick: torch's fused AdamW on the fp32 master with an
            # fp32 gradient (it takes no bf16 gradient and writes no bf16
            # copy)
            lp = torch.nn.Parameter(master.clone())
            lp.grad = grad.float()
            lopt = torch.optim.AdamW([lp], lr=1e-4, weight_decay=wd,
                                     fused=True)
            row["library_ms"] = time_ms(lopt.step, 20)
            del lp, lopt
            say(f"K3 {key} " + json.dumps(row))
            rows[key] = row
        del states, master, grad
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 6: the training main path
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 4, 2048
N_STEPS = dict(cold=1, warmup=2, timed=5)
PER_STEP = {"flash_fwd": 24, "flash_bwd_dq": 24, "flash_bwd_dkv": 24,
            "ln_fwd": 49, "ln_bwd_dx": 49, "adamw": 292, "rms_fwd": 0,
            "rms_bwd_dx": 0, "rope": 0, "rpa": 0, "rope_qkv": 0,
            "attend_cache_append": 0, "norm_mlp": 0, "paged_attention": 0,
            "ce_fwd": 0, "ce_bwd": 0, "norm_matmul": 0}


def counts():
    return dict(fa.launches, **ln.launches, **rms.launches, **fd.launches,
                **sce.launches, adamw=adamw.launches, rope=rope.launches,
                rpa=rpa.launches, paged_attention=pa.launches)


def reset_counts():
    for d in (fa.launches, ln.launches, rms.launches, fd.launches,
              sce.launches):
        for k in d:
            d[k] = 0
    adamw.launches = rope.launches = rpa.launches = pa.launches = 0


def param_count(c) -> int:
    """``bench.py``'s ``_param_count``: V·H + S·H + L·(12H² + 13H) + 2H."""
    h = c.hidden_size
    return (c.vocab_size * h + c.max_position_embeddings * h
            + c.num_layers * (12 * h * h + 13 * h) + 2 * h)


def o2_step_fn(m, ids, labels):
    with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
        return m.loss_fn(m(ids), labels)


def build_trainer(num_layers, seed):
    cfg = gpt_config("gpt3-1.3B", num_layers=num_layers,
                     max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForPretraining(cfg, seed=seed)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16")
    return cfg, model, opt, train_step(model, None, opt, step_fn=o2_step_fn)


def batch(cfg):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    labels = rs.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    return (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())


def train_main_path():
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, opt, step = build_trainer(N_LAYERS, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != param_count(cfg) or len(list(model.parameters())) != 292:
        fail(f"gpt3-1.3B has {n_params} parameters in "
             f"{len(list(model.parameters()))} tensors")
    say(f"train: gpt3-1.3B, {n_params} parameters, O2 bf16 + fp32 masters,"
        f" batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, built in "
        f"{time.perf_counter() - t0:.3f} s")
    ids, labels = batch(cfg)
    reset_counts()                   # count the main path's launches only
    losses, step_s = [], []
    n_total = sum(N_STEPS.values())
    for i in range(n_total):
        before = counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step(ids, labels))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        after = counts()
        moved = {k: after[k] - before[k] for k in PER_STEP}
        if moved != PER_STEP:
            fail(f"step {i}: launches {moved} != {PER_STEP}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    vals = [float(l) for l in losses]
    say(f"train: losses {vals}")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"losses not finite and falling: {vals}")
    timed = step_s[N_STEPS["cold"] + N_STEPS["warmup"]:]
    mean_s = sum(timed) / len(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * param_count(cfg) * tokens / mean_s / PEAK_BF16
    say(f"train: step ms cold {1e3 * step_s[0]:.2f}, warm-up "
        f"{[round(1e3 * t, 2) for t in step_s[1:3]]}, timed "
        f"{[round(1e3 * t, 2) for t in timed]}; mean {1e3 * mean_s:.2f} ms"
        f" = {tokens / mean_s:.1f} tokens/s, MFU {100 * mfu:.2f} % of "
        f"989 TFLOP/s bf16; peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB); batch {TRAIN_BATCH}")
    say(f"train: launches over {n_total} steps {launches}")
    del model, opt, step, losses
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 6b and 8b: kernels vs plain versions, one O2 step, depth 2
# ---------------------------------------------------------------------------

def snapshot_grads(model):
    """Copy each parameter's gradient as backward finishes accumulating
    it, before the optimizer step reads and clears it; returns the copies
    and the hooks' handles."""
    grads = {}

    def keep(name):
        return lambda p: grads.__setitem__(name, p.grad.detach().clone())
    return grads, [p.register_post_accumulate_grad_hook(keep(n))
                   for n, p in model.named_parameters() if p.requires_grad]


def plain_adamw_(P):
    """The first AdamW step (lr 1e-4, weight decay 0.01) of the plain
    step on its own copies ``P``, from their gradients: fp32 masters made
    from the bf16 parameters, which get the rounded masters back, as the
    O2 optimizer does; fp32 parameters are updated in place; a parameter
    without a gradient is skipped, as the optimizer skips it.  Returns the
    fp32 values after the step."""
    dev = next(iter(P.values())).device
    lr = torch.tensor([1e-4], device=dev)
    betas = torch.tensor([0.9, 0.999], device=dev)
    new = {}
    with torch.no_grad():
        for n, p in P.items():
            if p.grad is None:          # frozen: no gradient, no update
                continue
            master = p.float().clone() if p.dtype == torch.bfloat16 else p
            m, v = torch.zeros_like(master), torch.zeros_like(master)
            pows = torch.ones(2, device=dev) * betas
            adamw.fused_adamw_update_ref_(
                master, p.grad, m, v, lr, pows[0:1], pows[1:2], 0.9, 0.999,
                1e-8, 0.01, p_low=p if master is not p else None)
            new[n] = master
    return new


def step_cross_check(tag, model, opt, step, plain_loss, batch, controls,
                     loss_tol=XCHECK_LOSS_TOL, grad_tol=GRAD_REL_TOL,
                     scale_of=None):
    """One step through the kernels (``step``, the trainer of ``model``
    and ``opt``) against the same step composed from the plain versions,
    from the same weights: ``plain_loss(P, fault)`` is the plain forward
    and criterion on the copies ``P``, sound when ``fault`` is None.

    Holds the first loss (``loss_tol``), each trainable parameter's
    gradient before the optimizer step by relative norm (``grad_tol``),
    each parameter's update (max 2.1 lr, median lr/100; a frozen one must
    not move) and the second step's loss after each side's own update
    (``loss_tol`` too).  Then the gradient check's power: the plain step
    with each fault of ``controls`` (one a kernel could have) must differ
    from the sound plain step by more than ``grad_tol`` on some
    parameter.  ``batch`` is what ``step`` takes.  ``scale_of`` maps a parameter whose exact gradient is 0 (both
    sides then hold rounding noise) to one of the same shape whose
    gradient norm scales its error instead of its own."""
    train = {n: p.requires_grad for n, p in model.named_parameters()}
    names = [n for n, t in train.items() if t]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads_k, hooks = snapshot_grads(model)
    loss_k = step(*batch)
    for h in hooks:
        h.remove()
    # the plain step's own copy of the same weights, masters and moments
    P = {n: t.clone().requires_grad_(train[n]) for n, t in before.items()}
    loss_p = plain_loss(P, None)
    loss_p.backward()
    grads_p = {n: P[n].grad.detach().clone() for n in names}
    plain_new = plain_adamw_(P)
    torch.cuda.synchronize()
    lk, lp = float(loss_k), float(loss_p.detach())
    say(f"{tag}: loss kernels {lk} plain {lp} (tol {loss_tol})")
    if not abs(lk - lp) <= loss_tol:
        fail(f"{tag} loss {lk} vs plain {lp}")
    scale_of = scale_of or {}

    def rel(g, n, ref):
        d = (g.float() - ref[n].float()).norm()
        return (d / ref[scale_of.get(n, n)].float().norm()).item()

    rels = {n: rel(grads_k[n], n, grads_p) for n in names}
    worst = max(rels, key=rels.get)
    say(f"{tag}: gradients' relative error |g_k - g_p| / |g_p|: worst "
        f"{rels[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(rels.values()))):.3e} (tol {grad_tol})")
    if not rels[worst] <= grad_tol:
        fail(f"{tag} gradient of {worst}: relative error {rels[worst]:.3e}")
    worst_max, worst_med = 0.0, 0.0
    for n, p in model.named_parameters():
        if not train[n]:
            if not torch.equal(p.detach(), before[n]):
                fail(f"{tag}: the frozen {n} moved")
            continue
        # the update of the fp32 master (of the parameter itself for the
        # fp32 norm parameters)
        new = opt.state[p].get("master", p).detach()
        old = before[n].float()
        diff = ((new - old) - (plain_new[n] - old)).abs()
        mx, med = diff.max().item(), diff.median().item()
        worst_max, worst_med = max(worst_max, mx), max(worst_med, med)
        if mx > 2.1e-4 or med > 1e-6:
            fail(f"{tag} update of {n}: max diff {mx:.3e}, median "
                 f"{med:.3e}")
    say(f"{tag}: {len(names)} parameters' updates agree: worst max diff "
        f"{worst_max:.3e} (tol 2.1 lr = 2.1e-4), worst median "
        f"{worst_med:.3e} (tol lr/100 = 1e-6)")
    del grads_k, plain_new
    loss_k2 = step(*batch)
    with torch.no_grad():
        loss_p2 = plain_loss(P, None)
    lk2, lp2 = float(loss_k2), float(loss_p2)
    say(f"{tag}: second step's loss kernels {lk2} plain {lp2} (tol "
        f"{loss_tol})")
    if not abs(lk2 - lp2) <= loss_tol:
        fail(f"{tag} second loss {lk2} vs plain {lp2}")
    del P
    torch.cuda.empty_cache()
    for fault in controls:
        C = {n: t.clone().requires_grad_(train[n])
             for n, t in before.items()}
        loss_c = plain_loss(C, fault)
        loss_c.backward()
        crel = {n: rel(C[n].grad, n, grads_p) for n in names}
        w = max(crel, key=crel.get)
        say(f"{tag}: control {fault}: loss {float(loss_c.detach())}, "
            f"gradients' relative error to the sound plain step: worst "
            f"{crel[w]:.3e} ({w}), median "
            f"{float(np.median(list(crel.values()))):.3e}")
        if not crel[w] > grad_tol:
            fail(f"{tag}: the gradient check cannot see the {fault} "
                 f"control ({crel[w]:.3e} <= {grad_tol})")
        del C, loss_c
        torch.cuda.empty_cache()


def plain_loss(P, cfg, ids, labels, fault=None):
    """The O2 forward and criterion of ``models/gpt.py`` composed from the
    plain versions (``layer_norm_ref``, ``reference_attention_bhsd``),
    with the amp O2 casts written out.  ``fault="ln_dx"`` stops the
    gradient through the LayerNorm statistics: the forward is the same,
    dx lacks its mean terms (a K2b fault)."""
    bf = torch.bfloat16
    b, s = ids.shape
    hidden, nh = cfg.hidden_size, cfg.num_heads
    hd = hidden // nh

    def lnorm(x, name):
        w, bias = P[name + ".weight"], P[name + ".bias"]
        if fault == "ln_dx":
            xf = x.float()
            m = xf.mean(dim=-1, keepdim=True).detach()
            r = torch.rsqrt((xf - m).square().mean(dim=-1, keepdim=True)
                            + 1e-5).detach()
            return (xf - m) * r * w + bias
        return ln.layer_norm_ref(x.float(), w, bias, 1e-5)

    def linear(x, name):
        return torch.matmul(x.to(bf), P[name + ".weight"]) \
            + P[name + ".bias"]

    x = P["gpt.embeddings.word_embeddings.weight"][ids] \
        + P["gpt.embeddings.position_embeddings.weight"][
            torch.arange(s, device=ids.device)]
    for i in range(cfg.num_layers):
        pre = f"gpt.layers.{i}."
        qkv = linear(lnorm(x, pre + "ln1"), pre + "attn.qkv_proj") \
            .reshape(b, s, 3, nh, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2).reshape(b * nh, s, hd)
                   for j in range(3))
        a = fa.reference_attention_bhsd(q, k, v, 1.0 / hd ** 0.5, True)
        a = a.reshape(b, nh, s, hd).transpose(1, 2).reshape(b, s, hidden)
        x = x + linear(a, pre + "attn.out_proj")
        f = F.gelu(linear(lnorm(x, pre + "ln2"), pre + "mlp.fc1"),
                   approximate="tanh")
        x = x + linear(f, pre + "mlp.fc2")
    h = lnorm(x, "gpt.final_ln")
    logits = torch.matmul(h.to(bf),
                          P["gpt.embeddings.word_embeddings.weight"].t())
    return plain_criterion(logits, labels)


def plain_criterion(logits, labels):
    """The pretraining criterion under O2: fp32 log-softmax, the per-token
    loss and the mean over valid labels in bf16."""
    bf = torch.bfloat16
    flat = labels.reshape(-1)
    logp = torch.log_softmax(logits.reshape(flat.numel(), -1).float(), -1)
    valid = flat != -100
    loss = -torch.gather(logp, -1, flat.clamp(min=0)[:, None])[:, 0]
    loss = torch.where(valid, loss, torch.zeros((), device=loss.device))
    mask = valid.float()
    num = (loss.to(bf) * mask.to(bf)).float().sum()
    den = mask.sum().to(bf).clamp(min=1.0)
    return num.to(bf) / den


def cross_check():
    cfg, model, opt, step = build_trainer(2, seed=1)
    ids, labels = batch(cfg)
    step_cross_check(
        f"cross-check (2 layers, full width, batch {TRAIN_BATCH})",
        model, opt, step,
        lambda P, fault: plain_loss(P, cfg, ids, labels, fault),
        (ids, labels), controls=("ln_dx",))


# ---------------------------------------------------------------------------
# phase 7: K4a/b and K5 against their plain versions
# ---------------------------------------------------------------------------

# the LLaMA path's shapes: RMSNorm rows = batch 2 x seq 4096 tokens of
# hidden 4096 (fp32 under O2: "rms_norm" is black-listed); rope on q/k
# [batch 2, seq 4096, 32 heads, head_dim 128] bf16 with bf16 tables
K4_SHAPE = (8192, 4096)
K5_SHAPE = (2, 4096, 32, 128)


def check_k4():
    rows = {}
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    n, h = K4_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        x = rand((n, h), dtype, g, 2.0).requires_grad_()
        w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")) \
            .requires_grad_()
        gy = rand((n, h), dtype, g)
        before = dict(rms.launches)
        y = rms.rms_norm(x, w, 1e-5)
        dx, dw = torch.autograd.grad(y, (x, w), gy)
        torch.cuda.synchronize()
        if any(rms.launches[k] != before[k] + 1 for k in before):
            fail(f"K4 {dtype}: launch counters did not move: "
                 f"{rms.launches}")
        yr = rms.rms_norm_ref(x, w, 1e-5)
        dxr, dwr = torch.autograd.grad(yr, (x, w), gy, retain_graph=True)
        for name, a, r, dt in (("y", y, yr, dtype), ("dx", dx, dxr, dtype),
                               ("dw", dw, dwr, torch.float32)):
            if a.dtype != r.dtype or a.shape != r.shape:
                fail(f"K4 {dtype} {name}: {a.dtype} {tuple(a.shape)}")
            check_close(f"K4 {dtype} {name}", a, r, dt)
        xd, wd_ = x.detach(), w.detach()
        _, r = rms.rms_norm_fwd(xd, wd_, 1e-5)
        # the library yardstick takes the weight in x's dtype
        lw = wd_.to(dtype)
        lib_y = F.rms_norm(x, (h,), lw, 1e-5)
        item = x.element_size()
        row = dict(dtype=str(dtype).replace("torch.", ""), n=n, h=h,
                   max_abs_err=dict(y=max_err(y, yr), dx=max_err(dx, dxr),
                                    dw=max_err(dw, dwr)),
                   tol=dict(zip(("atol", "rtol"), KTOL[dtype])),
                   fwd_ms=time_ms(lambda: rms.rms_norm_fwd(xd, wd_, 1e-5),
                                  20),
                   dx_ms=time_ms(lambda: rms.rms_norm_bwd(xd, wd_, r, gy),
                                 20),
                   plain_fwd_ms=time_ms(lambda: rms.rms_norm_ref(
                       xd, wd_, 1e-5), 5),
                   plain_dx_ms=time_ms(lambda: torch.autograd.grad(
                       yr, x, gy, retain_graph=True), 5),
                   library_fwd_ms=time_ms(lambda: F.rms_norm(
                       xd, (h,), lw, 1e-5), 20),
                   library_dx_ms=time_ms(lambda: torch.autograd.grad(
                       lib_y, x, gy, retain_graph=True), 20),
                   # x read, y written; w and the fp32 r
                   fwd_bound=bound_ms(2 * n * h * item + 4 * h + 4 * n,
                                      4 * n * h, PEAK_FLOPS[torch.float32]),
                   # x and g read, dx written; w and r
                   dx_bound=bound_ms(3 * n * h * item + 4 * h + 4 * n,
                                     7 * n * h, PEAK_FLOPS[torch.float32]))
        say("K4 " + json.dumps(row))
        rows[row["dtype"]] = row
        del x, w, gy, y, dx, dw, yr, dxr, dwr, lib_y, r
        torch.cuda.empty_cache()
    return rows


def rope_tables(s, d, neox, dtype):
    """The model's position tables (``_rope_cache``'s layout, theta 1e4),
    rounded to ``dtype`` as the O2 cast rounds them."""
    inv = 1.0 / (1e4 ** (np.arange(0, d, 2, dtype="float32") / d))
    freqs = np.outer(np.arange(s, dtype="float32"), inv)
    full = np.concatenate([freqs, freqs], -1) if neox \
        else np.repeat(freqs, 2, -1)
    return tuple(torch.from_numpy(f(full)).cuda().to(dtype)
                 for f in (np.cos, np.sin))


# name: (neox, x dtype, table dtype); "main" is the LLaMA path's
K5_CASES = {
    "main": (False, torch.bfloat16, torch.bfloat16),
    "neox-bf16": (True, torch.bfloat16, torch.bfloat16),
    "interleaved-fp32": (False, torch.float32, torch.float32),
}


def check_k5():
    """Forward on a contiguous x and the backward (the kernel again, with
    -sin) on a gradient that arrives as a transposed view, as the
    attention's dq does on the main path."""
    rows = {}
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    b, s, h, d = K5_SHAPE
    for case, (neox, dtype, tdtype) in K5_CASES.items():
        cos, sin = rope_tables(s, d, neox, tdtype)
        x = rand((b, s, h, d), dtype, g).requires_grad_()
        gy = rand((b, h, s, d), dtype, g).transpose(1, 2)
        before = rope.launches
        y = rope.rope(x, cos, sin, neox)
        (dx,) = torch.autograd.grad(y, x, gy)
        torch.cuda.synchronize()
        if rope.launches != before + 2:
            fail(f"K5 {case}: {rope.launches - before} launches, not 2")
        yr = rope.rope_ref(x, cos, sin, neox)
        (dxr,) = torch.autograd.grad(yr, x, gy, retain_graph=True)
        for name, a, r in (("y", y, yr), ("dx", dx, dxr)):
            if a.dtype != dtype or a.shape != r.shape:
                fail(f"K5 {case} {name}: {a.dtype} {tuple(a.shape)}")
            check_close(f"K5 {case} {name}", a, r, dtype)
        xd = x.detach()
        numel = xd.numel()
        row = dict(case=case, shape=list(K5_SHAPE), neox=neox,
                   dtype=str(dtype).replace("torch.", ""),
                   table_dtype=str(tdtype).replace("torch.", ""),
                   max_abs_err=dict(y=max_err(y, yr), dx=max_err(dx, dxr)),
                   tol=dict(zip(("atol", "rtol"), KTOL[dtype])),
                   ms=time_ms(lambda: rope.rope_fwd(xd, cos, sin, neox), 20),
                   bwd_ms=time_ms(lambda: rope.rope_fwd(
                       gy, cos, sin, neox, sin_sign=-1.0), 20),
                   plain_ms=time_ms(lambda: rope.rope_ref(xd, cos, sin,
                                                          neox), 5),
                   # no single PyTorch call computes rope
                   library_ms=None,
                   # x read, out written, both tables read once
                   bound=bound_ms(2 * numel * xd.element_size()
                                  + 2 * s * d * cos.element_size(),
                                  3 * numel, PEAK_FLOPS[torch.float32]))
        say("K5 " + json.dumps(row))
        rows[case] = row
        del x, gy, y, dx, yr, dxr, cos, sin
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 8: the LLaMA training main path
# ---------------------------------------------------------------------------

LLAMA_PRESET, LLAMA_LAYERS = "llama2-7b", 8
LLAMA_BATCH, LLAMA_SEQ = 2, 4096


def llama_per_step(layers, recompute=False, adamw=None):
    """Exact launches per step: RMSNorm twice per layer and the final
    norm (forward and dx each); rope on q and k per layer, forward and
    backward; one flash fwd/dq/dkv per layer; AdamW per parameter (9 per
    layer + embedding, head and final norm), or ``adamw`` (one a bucket
    or segment flat shard under ZeRO).  ``recompute`` runs each layer's
    forward again in the backward: one more K1a, two more K4a and two
    more K5 a layer."""
    f = 2 if recompute else 1
    return {"flash_fwd": f * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "ln_fwd": 0, "ln_bwd_dx": 0,
            "adamw": 9 * layers + 3 if adamw is None else adamw,
            "rms_fwd": 2 * f * layers + 1, "rms_bwd_dx": 2 * layers + 1,
            "rope": (2 * f + 2) * layers, "rpa": 0,
            "rope_qkv": 0, "attend_cache_append": 0, "norm_mlp": 0,
            "paged_attention": 0, "ce_fwd": 0, "ce_bwd": 0,
            "norm_matmul": 0}


def llama_param_count(c) -> int:
    """2·V·H (embedding and untied head) + L·(4H² + 3H·I + 2H) + H for
    MHA llama2 widths."""
    h, i = c.hidden_size, c.intermediate_size
    return (2 * c.vocab_size * h
            + c.num_layers * (4 * h * h + 3 * h * i + 2 * h) + h)


def build_llama_trainer(num_layers, seed):
    cfg = llama_config(LLAMA_PRESET, num_layers=num_layers)
    model = LlamaForCausalLM(cfg, seed=seed)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16")
    return cfg, model, opt, train_step(model, None, opt, step_fn=o2_step_fn)


def llama_batch(cfg):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ))
    labels = rs.randint(0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ))
    return (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())


def llama_train_main_path():
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, opt, step = build_llama_trainer(LLAMA_LAYERS, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    if n_params != llama_param_count(cfg) \
            or n_tensors != 9 * LLAMA_LAYERS + 3:
        fail(f"{LLAMA_PRESET} at {LLAMA_LAYERS} layers has {n_params} "
             f"parameters in {n_tensors} tensors")
    say(f"llama: {LLAMA_PRESET} width (hidden {cfg.hidden_size}, "
        f"{cfg.num_heads} heads, intermediate {cfg.intermediate_size}, "
        f"vocab {cfg.vocab_size}), {LLAMA_LAYERS} of "
        f"{llama_config(LLAMA_PRESET).num_layers} layers, N = "
        f"{n_params} parameters, O2 bf16 + fp32 masters, batch "
        f"{LLAMA_BATCH} x seq {LLAMA_SEQ}, built in "
        f"{time.perf_counter() - t0:.3f} s")
    ids, labels = llama_batch(cfg)
    per_step = llama_per_step(LLAMA_LAYERS)
    tokens = LLAMA_BATCH * LLAMA_SEQ
    reset_counts()                   # count the main path's launches only
    losses, step_s = [], []
    for i in range(sum(N_STEPS.values())):
        before = counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step(ids, labels))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        after = counts()
        moved = {k: after[k] - before[k] for k in per_step}
        if moved != per_step:
            fail(f"llama step {i}: launches {moved} != {per_step}")
        mfu = 6 * n_params * tokens / step_s[-1] / PEAK_BF16
        say(f"llama step {i}: {1e3 * step_s[-1]:.2f} ms, "
            f"{tokens / step_s[-1]:.1f} tokens/s, MFU {100 * mfu:.2f} % "
            f"(6 N tokens / step / 989 TFLOP/s), peak memory "
            f"{torch.cuda.max_memory_allocated()} bytes")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    vals = [float(l) for l in losses]
    say(f"llama: losses {vals}")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"llama losses not finite and falling: {vals}")
    timed = step_s[N_STEPS["cold"] + N_STEPS["warmup"]:]
    mean_s = sum(timed) / len(timed)
    mfu = 6 * n_params * tokens / mean_s / PEAK_BF16
    say(f"llama: timed steps {[round(1e3 * t, 2) for t in timed]}; mean "
        f"{1e3 * mean_s:.2f} ms = {tokens / mean_s:.1f} tokens/s, MFU "
        f"{100 * mfu:.2f} % of 989 TFLOP/s bf16; peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    say(f"llama: launches over {len(vals)} steps {launches}")
    del model, opt, step, losses
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 8b: kernels vs plain versions, one LLaMA O2 step, depth 2
# ---------------------------------------------------------------------------

def plain_llama_loss(P, cfg, ids, labels, cos, sin, fault=None):
    """The O2 forward and criterion of ``models/llama.py`` composed from
    the plain versions (``rms_norm_ref``, ``rope_ref`` on the model's
    tables cast to bf16, ``reference_attention_bhsd``), with the amp O2
    casts written out.  The controls' faults: ``"rms_dx"`` stops the
    gradient through the RMSNorm statistic (the same forward, dx without
    its mean term: a K4b fault); ``"rope_sign"`` rotates q and k the other
    way (the backward's -sin in the forward: a K5 fault);
    ``"tables_fp32"`` leaves the tables in fp32 (the O2 rounding of
    "fused_rope"'s inputs missed)."""
    bf = torch.bfloat16
    b, s = ids.shape
    hidden, nh = cfg.hidden_size, cfg.num_heads
    hd = hidden // nh
    cos, sin = cos[:s], sin[:s]
    if fault != "tables_fp32":
        cos, sin = cos.to(bf), sin.to(bf)
    if fault == "rope_sign":
        sin = -sin

    def norm(x, name):
        if fault == "rms_dx":
            xf = x.float()
            r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True)
                            + cfg.rms_eps).detach()
            return xf * r * P[name]
        return rms.rms_norm_ref(x.float(), P[name], cfg.rms_eps)

    def linear(x, name):
        return torch.matmul(x.to(bf), P[name + ".weight"])

    x = P["llama.embed_tokens.weight"][ids]
    for i in range(cfg.num_layers):
        pre = f"llama.layers.{i}."
        h = norm(x, pre + "input_layernorm.weight")
        q, k, v = (linear(h, pre + f"self_attn.{n}_proj")
                   .reshape(b, s, nh, hd) for n in "qkv")
        q, k = (rope.rope_ref(t, cos, sin, False) for t in (q, k))
        q, k, v = (t.transpose(1, 2).reshape(b * nh, s, hd)
                   for t in (q, k, v))
        a = fa.reference_attention_bhsd(q, k, v, 1.0 / hd ** 0.5, True)
        a = a.reshape(b, nh, s, hd).transpose(1, 2).reshape(b, s, hidden)
        x = x + linear(a, pre + "self_attn.o_proj")
        h = norm(x, pre + "post_attention_layernorm.weight")
        f = F.silu(linear(h, pre + "mlp.gate_proj")) \
            * linear(h, pre + "mlp.up_proj")
        x = x + linear(f, pre + "mlp.down_proj")
    h = norm(x, "llama.norm.weight")
    logits = torch.matmul(h.to(bf), P["lm_head_weight"].t())
    return plain_criterion(logits, labels)


def llama_cross_check():
    cfg, model, opt, step = build_llama_trainer(2, seed=1)
    ids, labels = llama_batch(cfg)
    att = model.llama.layers[0].self_attn
    cos, sin = att._cos, att._sin
    step_cross_check(
        f"llama cross-check (2 layers, full width, batch {LLAMA_BATCH} x "
        f"seq {LLAMA_SEQ})", model, opt, step,
        lambda P, fault: plain_llama_loss(P, cfg, ids, labels, cos, sin,
                                          fault), (ids, labels),
        controls=("rms_dx", "rope_sign", "tables_fp32"))


# ---------------------------------------------------------------------------
# phase 9: K6a/b/c against their plain versions
# ---------------------------------------------------------------------------

# The decode paths' shapes, batch 8: llama2-7b (H 4096, 32 heads of 128,
# SwiGLU 11008) with its caches [8, 640, 32, 128] at position 575 (phase
# 10: prompt 512 + 128 new, midway), and GPT-3 1.3B (H 2048, 16 heads,
# intermediate 8192; caches [8, 320, 16, 128] at 287, phase 4b), plus a
# GQA 32/8, a neox and a bf16 case.  Tolerances: fp32 KTOL (sums over
# 2048-11008 products in other orders than cuBLAS, online vs two-pass
# softmax; read on the H100: 4e-7 - 9e-6); bf16 see check_k6_close (the
# bf16 plain K6c sits 6 bf16 steps, 9.4e-2 at |y| ~ 4, from the kernel:
# its roundings of h, g, u and the SwiGLU product add up over 11008 terms).
K6A_CASES = {   # (hidden, nh, nkv, rope, bias, dtype)
    "llama": (4096, 32, 32, "interleaved", False, torch.float32),
    "gpt": (2048, 16, 16, None, True, torch.float32),
    "gqa": (4096, 32, 8, "interleaved", False, torch.float32),
    "neox": (4096, 32, 32, "neox", False, torch.float32),
    "bf16": (4096, 32, 32, "interleaved", False, torch.bfloat16),
}
# every main-path K6a case must take the stream form
K6A_STREAM = tuple(K6A_CASES)
K6B_CASES = {   # (nh, nkv, s_total, pos, dtype)
    "llama": (32, 32, 640, 575, torch.float32),
    "gpt": (16, 16, 320, 287, torch.float32),
    "gqa": (32, 8, 640, 575, torch.float32),
    "bf16": (32, 32, 640, 575, torch.bfloat16),
}
# K6c also at 33 and 64 rows (serving's decode-only steps take it up to
# the gate's 64).  Every K6c case is a main-path shape: each must take the
# stream route.
K6C_CASES = {   # (kind, act, hidden, inter, dtype, rows)
    "llama": ("rms_norm", "silu", 4096, 11008, torch.float32, 8),
    "gpt": ("layer_norm", "gelu_tanh", 2048, 8192, torch.float32, 8),
    "bf16": ("rms_norm", "silu", 4096, 11008, torch.bfloat16, 8),
    "rows33": ("layer_norm", "gelu_tanh", 2048, 8192, torch.float32, 33),
    "rows64": ("rms_norm", "silu", 4096, 11008, torch.float32, 64),
}
K6_BATCH, HD = 8, 128
# K6c/K6d times rotate over copies of the weights whose bytes together pass
# twice the H100's 50 MB L2, so that no case reads its weight from L2 (a
# decode step's next layer brings other weights)
ROTATE_BYTES = 100e6


def weight_copies(nbytes: float) -> int:
    """Copies of a weight of ``nbytes`` whose total passes ROTATE_BYTES."""
    return int(ROTATE_BYTES // nbytes) + 1


def time_rotating(fns, iters: int) -> float:
    """:func:`time_ms` of calls that take ``fns`` in turn (one per weight
    copy); ``iters`` is rounded up to whole rounds."""
    it = itertools.cycle(fns)
    rounds = -(-iters // len(fns)) * len(fns)
    return time_ms(lambda: next(it)(), rounds)


def k6_row(kernel, case, dtype, errs, ms, plain_ms, library_ms, bound,
           **extra):
    row = dict(kernel=kernel, case=case,
               dtype=str(dtype).replace("torch.", ""), max_abs_err=errs,
               tol=dict(zip(("atol", "rtol"), KTOL[dtype])), ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound[0],
               bound_by=bound[1], **extra)
    say(f"{kernel} " + json.dumps(row))
    return row


def check_k6_close(what, got, ref, ref32, dtype):
    """fp32: the kernel within KTOL of its plain version.  bf16: the plain
    version rounds its matmul outputs, the activation product and the
    probabilities to bf16 on the way, the kernel once from fp32 sums.  So
    the kernel is held within KTOL (one bf16 step) of the plain version
    run on fp32 copies of the same bf16 inputs, and, element by element,
    within the bf16 plain version's own distance from that run plus KTOL.
    Returns the errors read."""
    errs = {"plain": max_err(got, ref)}
    if dtype == torch.float32:
        check_close(what, got, ref, dtype)
        return errs
    check_close(f"{what} vs the fp32 plain run", got, ref32, dtype)
    atol, rtol = KTOL[dtype]
    g, p, t = got.float(), ref.float(), ref32.float()
    excess = ((g - p).abs() - (p - t).abs() - atol - rtol * t.abs()).max()
    if excess.item() > 0:
        fail(f"{what}: max abs err {errs['plain']:.3e} from the bf16 plain "
             "version exceeds its own error + KTOL somewhere")
    errs["fp32_plain"] = max_err(got, ref32)
    errs["plain_vs_its_fp32"] = max_err(ref, ref32)
    return errs


def f32(*ts):
    return [None if t is None else t.float() for t in ts]


def check_launch(key, fn):
    before = fd.launches[key]
    out = fn()
    torch.cuda.synchronize()
    if fd.launches[key] != before + 1:
        fail(f"{key}: launches did not move by 1")
    return out


@contextlib.contextmanager
def qkv_route_forced(route):
    """K6a's calls forced onto ``route`` ("stream" or "generic")."""
    keep = fd.qkv_route
    fd.qkv_route = lambda *a: int(route == "stream")
    try:
        yield
    finally:
        fd.qkv_route = keep


def k6a_case(case, g):
    """(x, packed q/k/v weight, wq, wk, wv, biases, cos, sin, kw) of a
    K6A_CASES case: GPT's q/k/v are column slices of its packed [H, 3H]
    projection, LLaMA's three parameters of their own."""
    h, nh, nkv, rope_mode, bias, dtype = K6A_CASES[case]
    nq, nk = nh * HD, nkv * HD
    x = rand((K6_BATCH, h), dtype, g)
    packed = rand((h, nq + 2 * nk), dtype, g, 0.02)
    bs = [rand((n,), dtype, g, 0.1) if bias else None for n in (nq, nk, nk)]
    cos = sin = None
    if rope_mode:
        tc, ts = rope_tables(576, HD, rope_mode == "neox", torch.float32)
        cos, sin = tc[575], ts[575]
    kw = dict(n_heads=nh, n_kv=nkv, head_dim=HD, neox=rope_mode == "neox")
    return x, packed, k6a_weights(case, packed), bs, cos, sin, kw


def k6a_weights(case, packed):
    h, nh, nkv = K6A_CASES[case][:3]
    nq, nk = nh * HD, nkv * HD
    ws = packed[:, :nq], packed[:, nq:nq + nk], packed[:, nq + nk:]
    return ws if case == "gpt" else tuple(w.contiguous() for w in ws)


def check_k6a(g):
    rows = {}
    b = K6_BATCH
    lib = _build.library("fused_decode")
    for case, (h, nh, nkv, rope_mode, bias, dtype) in K6A_CASES.items():
        nq, nk = nh * HD, nkv * HD
        x, packed, (wq, wk, wv), bs, cos, sin, kw = k6a_case(case, g)
        neox = kw["neox"]
        route = fd.rope_qkv_route(x, wq, wk, wv, HD, neox)
        c_route = lib.fd_qkv_route(b, nq, nk, h, wq.stride(0), wk.stride(0),
                                   wv.stride(0), HD, int(neox),
                                   fd._DTYPE_CODE[dtype], 1)
        if (route == "stream") != bool(c_route):
            fail(f"K6a {case}: rope_qkv_route says {route}, the kernel's "
                 f"fd_qkv_route {c_route}")
        if case in K6A_STREAM and route != "stream":
            fail(f"K6a {case}: route {route}, want stream")
        args = (x, wq, wk, wv, *bs, cos, sin)
        got = check_launch("rope_qkv", lambda: fd.rope_qkv(*args, **kw))
        check_relaunch(f"K6a {case}", lambda: fd.rope_qkv(*args, **kw), got)
        ref = fd.rope_qkv_ref(*args, **kw)
        ref32 = fd.rope_qkv_ref(*f32(*args), **kw) \
            if dtype != torch.float32 else (None,) * 3
        errs = {}
        for name, a, r, r32 in zip("qkv", got, ref, ref32):
            if a.dtype != dtype or a.shape != r.shape:
                fail(f"K6a {case} {name}: {a.dtype} {tuple(a.shape)}")
            errs[name] = check_k6_close(f"K6a {case} {name}", a, r, r32,
                                        dtype)
        n_out = nq + 2 * nk
        # the weights rotate over copies (GPT's packed projection is read
        # as its three column slices); x, the biases and cos/sin stay
        copies = [packed] + [packed.clone() for _ in range(
            weight_copies(x.element_size() * h * n_out) - 1)]
        calls = [functools.partial(fd.rope_qkv, x, *k6a_weights(case, c),
                                   *bs, cos, sin, **kw) for c in copies]
        plain = [functools.partial(fd.rope_qkv_ref, x, *k6a_weights(case, c),
                                   *bs, cos, sin, **kw) for c in copies]
        ms = time_rotating(calls, 20)
        generic_ms = None
        if route == "stream":    # the generic GEMV on the same inputs
            with qkv_route_forced("generic"):
                generic_ms = time_rotating(calls, 20)
        # the weights, x, q/k/v and the biases; the fp32 cos/sin row
        nbytes = x.element_size() * (h * n_out + b * h + b * n_out
                                     + n_out * bias) \
            + 4 * 2 * HD * bool(rope_mode)
        rows[case] = k6_row(
            "K6a", case, dtype, errs, ms, time_rotating(plain, 10),
            # the product part as one library call on the packed weight
            time_rotating([functools.partial(torch.matmul, x, c)
                           for c in copies], 20),
            bound_ms(nbytes, 2 * b * h * n_out, PEAK_FLOPS[dtype]),
            route=route, generic_ms=generic_ms, weight_copies=len(copies),
            shape=f"x [{b}, {h}], w [{h}, {nq}+{nk}+{nk}]")
        del x, packed, wq, wk, wv, bs, got, ref, ref32, args, copies, calls
        del plain
    return rows


def check_k6b(g):
    rows = {}
    b = K6_BATCH
    for case, (nh, nkv, st, pos, dtype) in K6B_CASES.items():
        q = rand((b, nh, HD), dtype, g)
        kn, vn = (rand((b, nkv, HD), dtype, g) for _ in range(2))
        kc, vc = (rand((b, st, nkv, HD), dtype, g) for _ in range(2))
        kr, vr = kc.clone(), vc.clone()
        ctx, ko, vo = check_launch("attend_cache_append", lambda:
                                   fd.attend_cache_append(q, kn, vn, kc, vc,
                                                          pos))
        rctx, _, _ = fd.attend_cache_append_ref(q, kn, vn, kr, vr, pos)
        rctx32 = fd.attend_cache_append_ref(*f32(q, kn, vn, kc, vc),
                                            pos)[0] \
            if dtype != torch.float32 else None
        if ko is not kc or vo is not vc:
            fail(f"K6b {case}: the caches were not updated in place")
        if not (torch.equal(kc, kr) and torch.equal(vc, vr)):
            fail(f"K6b {case}: the appended caches differ from the plain "
                 "version's")
        if ctx.dtype != dtype or ctx.shape != q.shape:
            fail(f"K6b {case} ctx: {ctx.dtype} {tuple(ctx.shape)}")
        errs = {"ctx": check_k6_close(f"K6b {case} ctx", ctx, rctx, rctx32,
                                      dtype)}
        qs = q[:, :, None]
        ks, vs = (c[:, :pos + 1].transpose(1, 2) for c in (kc, vc))
        item = q.element_size()
        # rows 0..pos-1 of both caches read, row pos written; q, k/v_new
        # read and ctx written
        nbytes = item * (2 * b * pos * nkv * HD + 2 * b * nkv * HD
                         + b * (2 * nh + 2 * nkv) * HD)
        rows[case] = k6_row(
            "K6b", case, dtype, errs,
            time_ms(lambda: fd.attend_cache_append(q, kn, vn, kc, vc, pos),
                    20),
            time_ms(lambda: fd.attend_cache_append_ref(q, kn, vn, kr, vr,
                                                       pos), 10),
            # the attention part (no append) over the live rows
            time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, enable_gqa=nh != nkv), 20),
            bound_ms(nbytes, 4 * b * nh * (pos + 1) * HD, PEAK_FLOPS[dtype]),
            shape=f"q [{b}, {nh}, {HD}], caches [{b}, {st}, {nkv}, {HD}], "
                  f"pos {pos}")
        del q, kn, vn, kc, vc, kr, vr, ctx, rctx, rctx32, ks, vs
    return rows


def k6c_composition(kind, act, x, norm_w, norm_b, w1, b1, w2, b2, w_gate):
    """K6c's yardstick: no single PyTorch call computes norm -> (gated)
    MLP, so a composition: the norm, then two or three ``addmm`` /
    ``matmul`` and the activation."""
    h = x.shape[-1]
    if kind == "layer_norm":
        def run():
            hn = F.layer_norm(x, (h,), norm_w, norm_b, 1e-5)
            a = F.gelu(torch.addmm(b1, hn, w1),
                       approximate="tanh" if act == "gelu_tanh" else "none")
            return torch.addmm(b2, a, w2)
        return run

    def run():
        hn = F.rms_norm(x, (h,), norm_w, 1e-5)
        return torch.matmul(F.silu(torch.matmul(hn, w_gate))
                            * torch.matmul(hn, w1), w2)
    return run


def check_relaunch(what, fn, first):
    """A second launch on the same inputs gives the same bits (``first``
    a tensor or a tuple of them)."""
    again = fn()
    torch.cuda.synchronize()
    pairs = zip(again, first) if isinstance(first, tuple) else [(again, first)]
    for a, f in pairs:
        if not torch.equal(a, f):
            fail(f"{what}: a relaunch is not bitwise equal to the first "
                 f"(max diff {max_err(a, f):.3e})")


def check_k6c(g):
    rows = {}
    for case, (kind, act, h, inter, dtype, b) in K6C_CASES.items():
        ln_kind = kind == "layer_norm"
        x = rand((b, h), dtype, g, 2.0)
        arrays = dict(
            norm_w=(1 + 0.1 * torch.randn(h, generator=g, device="cuda"))
            .to(dtype),
            norm_b=rand((h,), dtype, g, 0.1) if ln_kind else None,
            w1=rand((h, inter), dtype, g, 0.02),
            b1=rand((inter,), dtype, g, 0.1) if ln_kind else None,
            w2=rand((inter, h), dtype, g, 0.02),
            b2=rand((h,), dtype, g, 0.1) if ln_kind else None,
            w_gate=None if ln_kind else rand((h, inter), dtype, g, 0.02))
        kw = dict(kind=kind, act=act, eps=1e-5, **arrays)
        route = fd.norm_mlp_route(x, arrays["w1"], arrays["w2"],
                                  arrays["w_gate"])
        if route != "stream":
            fail(f"K6c {case}: route {route}, want stream (a main-path "
                 "shape)")
        got = check_launch("norm_mlp", lambda: fd.norm_mlp(x, **kw))
        check_relaunch(f"K6c {case}", lambda: fd.norm_mlp(x, **kw), got)
        ref = fd.norm_mlp_ref(x, **kw)
        ref32 = fd.norm_mlp_ref(x.float(), **dict(kw, **dict(zip(
            arrays, f32(*arrays.values()))))) \
            if dtype != torch.float32 else None
        if got.dtype != dtype or got.shape != ref.shape:
            fail(f"K6c {case}: {got.dtype} {tuple(got.shape)}")
        errs = {"y": check_k6_close(f"K6c {case}", got, ref, ref32, dtype)}
        n_up = 1 if ln_kind else 2
        w_bytes = x.element_size() * h * inter * (n_up + 1)
        # the weights rotate over copies; x and the vectors stay
        copies = [kw] + [dict(kw, **{k: arrays[k].clone() for k in
                                     ("w1", "w2", "w_gate")
                                     if arrays[k] is not None})
                         for _ in range(weight_copies(w_bytes) - 1)]
        # the weights, x and y; the norm's vectors and the biases
        vectors = 3 * h + inter if ln_kind else h
        nbytes = w_bytes + x.element_size() * (2 * b * h + vectors)
        rows[case] = k6_row(
            "K6c", case, dtype, errs,
            time_rotating([functools.partial(fd.norm_mlp, x, **c)
                           for c in copies], 20),
            time_rotating([functools.partial(fd.norm_mlp_ref, x, **c)
                           for c in copies], 10),
            # no single PyTorch call computes norm -> (gated) MLP
            None,
            bound_ms(nbytes, 2 * b * inter * h * (n_up + 1),
                     PEAK_FLOPS[dtype]),
            composition_ms=time_rotating([k6c_composition(
                kind, act, x, c["norm_w"], c["norm_b"], c["w1"], c["b1"],
                c["w2"], c["b2"], c["w_gate"]) for c in copies], 20),
            route=route, weight_copies=len(copies),
            shape=f"x [{b}, {h}], {kind} + {act}, inter {inter}")
        del x, arrays, kw, got, ref, ref32, copies
    return rows


def check_k6():
    t0 = time.perf_counter()
    for line in _build.build_log.get("fused_decode", "").splitlines():
        if "registers" in line or "spill" in line:
            say(f"ptxas fused_decode: {line.strip()}")
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    rows = dict(k6a=check_k6a(g), k6b=check_k6b(g), k6c=check_k6c(g))
    torch.cuda.empty_cache()
    say(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 10: the compiled decode loop of llama2-7b, all 32 layers, fp32
# ---------------------------------------------------------------------------

DECODE_PRESET = "llama2-7b"
DECODE = dict(batch=8, prompt=512, new=128, eager_new=16)
SAMPLING = dict(decode_strategy="sampling", temperature=0.8, top_k=40,
                top_p=0.95)
# the first decode step's logits (K6a/b/c over the caches) vs the dense
# forward over prompt + token (K1, K4, K5 and cuBLAS over 513 positions),
# fp32 over 32 layers: the same sums in other orders, which read 1.3e-4
# on the H100 (phase 4's 24-layer GPT step reads 7.2e-6).  The limit sits
# well below the fault control (the step's attention one position short),
# which reads 1.77 there
STEP_LOGITS_TOL = 1e-3


def short_attend(q, k_new, v_new, k_cache, v_cache, pos, scale=None):
    """Fault control: the decode step's attention leaves out the appended
    row (attends 0..pos-1); the row is still appended."""
    ctx, _, _ = fd.attend_cache_append_ref(
        q, k_cache[:, pos - 1].clone(), v_cache[:, pos - 1].clone(),
        k_cache[:, :pos], v_cache[:, :pos], pos - 1, scale)
    k_cache[:, pos] = k_new
    v_cache[:, pos] = v_new
    return ctx, k_cache, v_cache


def first_step_logits(model, ids):
    """Prefill, the greedy token, one decode step at pos S over caches of
    S + 1 rows: (step logits [B, V], token [B])."""
    logits, past = model(ids, use_cache=True, last_logits_only=True)
    tok = logits[:, -1].argmax(dim=-1)
    params, step = model.build_decode_step()
    b, s = ids.shape
    caches = []
    for k, v in past:
        kc = k.new_zeros((b, s + 1) + tuple(k.shape[2:]))
        vc = torch.zeros_like(kc)
        kc[:, :s], vc[:, :s] = k, v
        caches.append((kc, vc))
    del past
    out, _ = step(params, tok, caches, s)
    return out, tok


def step_logit_check(model, ids):
    """The first decode step's logits against the dense forward over
    prompt + token, and the fault control that must fail the same check.
    Returns (error, control's error)."""
    with torch.no_grad():
        got, tok = first_step_logits(model, ids)
        dense = model(torch.cat([ids, tok[:, None]], dim=1),
                      last_logits_only=True)[:, -1]
        err = max_err(got, dense)
        sound = fd.attend_cache_append
        fd.attend_cache_append = short_attend
        try:
            bad, _ = first_step_logits(model, ids)
        finally:
            fd.attend_cache_append = sound
        ctrl = max_err(bad, dense)
    if not torch.isfinite(got).all() or got.shape != dense.shape:
        fail(f"step logits: shape {tuple(got.shape)} or non-finite")
    say(f"step vs dense forward over prompt {ids.shape[1]} + 1: max abs err "
        f"{err:.3e} (tol {STEP_LOGITS_TOL}; |logits| max "
        f"{dense.abs().max().item():.3f}); control short_attend: "
        f"{ctrl:.3e}")
    if err > STEP_LOGITS_TOL:
        fail(f"step logits differ from the dense forward by {err}")
    if ctrl <= STEP_LOGITS_TOL:
        fail(f"the fault control passes the step-logit check ({ctrl})")
    return err, ctrl


def eager_tokens(model, ids, new):
    """Eager ``generate`` (the dense forward per token): (its new tokens
    [B, new] and the top-2 margin of the logits each came from [new, B]),
    on the host."""
    seen = []
    hook = model.register_forward_hook(
        lambda mod, inp, out: seen.append(out[0][:, -1].float()))
    try:
        eager = generation.generate(model, ids, max_new_tokens=new)
    finally:
        hook.remove()
    top2 = torch.stack([t.topk(2, dim=-1).values for t in seen[:new]])
    return (eager[:, ids.shape[1]:].cpu(),
            (top2[..., 0] - top2[..., 1]).cpu())


def agreement(what, eager, margin, other):
    """``other``'s new tokens equal the eager ones in each row up to the
    first position where the eager logits' top-2 margin is under
    STEP_LOGITS_TOL.  Returns the positions compared."""
    new = eager.shape[1]
    o = other[:, :new].cpu()
    compared = 0
    for row in range(eager.shape[0]):
        small = torch.nonzero(margin[:, row] < STEP_LOGITS_TOL)
        upto = int(small[0]) if len(small) else new
        if not torch.equal(eager[row, :upto], o[row, :upto]):
            fail(f"row {row}: eager and {what} tokens differ before "
                 f"position {upto}: {eager[row].tolist()} vs "
                 f"{o[row].tolist()}")
        compared += upto
    say(f"eager vs {what}: {compared} of {eager.numel()} positions "
        f"compared (each row up to its first top-2 margin under "
        f"{STEP_LOGITS_TOL}; smallest margin {margin.min().item():.3e}), "
        f"all equal")
    return compared


def eager_agreement(model, ids, comp, new):
    """Eager ``generate`` against the compiled tokens ``comp`` (see
    ``agreement``).  Returns the positions compared."""
    eager, margin = eager_tokens(model, ids, new)
    return agreement("compiled", eager, margin, comp[:, ids.shape[1]:])


def eos_check(model, ids, greedy, new):
    """An EOS drawn from a row whose greedy run changes: each row stops at
    its first EOS and holds there, the call at the last row's."""
    s = ids.shape[1]
    gen = greedy[:, s:].cpu()
    row = next((r for r in range(gen.shape[0])
                if (gen[r] != gen[r, 0]).any()), None)
    if row is None:
        fail(f"every greedy row repeats one token: {gen.tolist()}")
    eos = int(gen[row][gen[row] != gen[row, 0]][0])
    firsts = []
    for r in range(gen.shape[0]):
        hit = torch.nonzero(gen[r] == eos)
        firsts.append(int(hit[0]) if len(hit) else None)
    n = new if None in firsts else max(firsts) + 1
    out = generation.decode_loop(model, ids, max_new_tokens=new,
                                 eos_token_id=eos).cpu()
    if out.shape[1] != s + n or generation.decode_stats["generated"] != n:
        fail(f"EOS {eos}: {out.shape[1] - s} tokens, expected {n}")
    for r, at in enumerate(firsts):
        stop = n if at is None else at + 1
        if not torch.equal(out[r, s:s + stop], gen[r, :stop]) \
                or not (out[r, s + stop:] == eos).all():
            fail(f"EOS {eos}: row {r} does not stop at {stop}")
    say(f"eos: token {eos} (row {row}'s first change), rows stop at "
        f"{[None if a is None else a + 1 for a in firsts]}, call at {n}; "
        f"host reads {generation.decode_stats['host_reads']}")


def llama_decode_main_path():
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"llama decode: {torch.cuda.memory_allocated()} bytes allocated "
        "before the model")
    torch.cuda.reset_peak_memory_stats()
    cfg = llama_config(DECODE_PRESET)
    model = LlamaForCausalLM(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != llama_param_count(cfg):
        fail(f"{DECODE_PRESET} has {n_params} parameters")
    b, s, new = DECODE["batch"], DECODE["prompt"], DECODE["new"]
    layers = cfg.num_layers
    say(f"llama decode: {DECODE_PRESET} fp32, {layers} layers, {n_params} "
        f"parameters ({4 * n_params} bytes), batch {b} x prompt {s} + {new}"
        " new")
    rs = np.random.RandomState(2)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s))).cuda()
    reset_counts()                   # count the main path's launches only
    out, dt_cold, moved, stats = decode_call(model, ids, new)
    check_greedy_rows("llama decode", out, ids, new, cfg.vocab_size)
    check_decode_launches("llama decode", moved, stats, layers,
                          {"flash_fwd": layers, "rms_fwd": 2 * layers + 1,
                           "rope": 2 * layers})
    torch.cuda.reset_peak_memory_stats()
    out2, dt, _, stats2 = decode_call(model, ids, new)
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(out, out2):
        fail("llama decode: a second greedy call gave other tokens")
    t0 = time.perf_counter()
    with torch.no_grad():
        model(ids, use_cache=True, last_logits_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    say(f"llama decode: {dt:.3f} s per call (first {dt_cold:.3f} s), "
        f"{1e3 * dt / new:.2f} ms per token, {b * new / dt:.1f} tokens/s "
        f"(B x new / time); a prefill alone {prefill_s:.3f} s, so "
        f"{1e3 * (dt - prefill_s) / stats2['steps']:.2f} ms per decode "
        f"step; host reads per call {stats2['host_reads']}; peak memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB)")
    err, ctrl = step_logit_check(model, ids)
    eager, margin = eager_tokens(model, ids, DECODE["eager_new"])
    compared = agreement("compiled", eager, margin, out[:, s:])
    g1, g2 = (torch.Generator(device="cuda").manual_seed(11)
              for _ in range(2))
    s1 = generation.decode_loop(model, ids, max_new_tokens=new,
                                generator=g1, **SAMPLING)
    s2 = generation.decode_loop(model, ids, max_new_tokens=new,
                                generator=g2, **SAMPLING)
    if not torch.equal(s1, s2):
        fail("sampling: two calls from one seed gave other tokens")
    check_greedy_rows("llama sampling", s1, ids, new, cfg.vocab_size)
    say(f"sampling {SAMPLING}: reproducible from its seed; "
        f"{int((s1[:, s:] != out[:, s:]).sum())} of {b * new} tokens differ "
        "from greedy")
    eos_check(model, ids, out, new)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, dt_prof, _, _ = decode_call(model, ids, new)
    _print_device_profile(prof, dt_prof, top=12)
    del out, out2, s1, s2, prof
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    # the model, the prompt and the eager tokens go on to phase 12
    return dict(launches={k: moved[k] for k in K6_KEYS},
                steps=stats["steps"], ms_per_token=1e3 * dt / new,
                ms_per_step=1e3 * (dt - prefill_s) / stats2["steps"],
                tokens_per_s=b * new / dt, peak=peak, step_err=err,
                control_err=ctrl, compared=compared), \
        dict(model=model, ids=ids, eager=eager, margin=margin)


# ---------------------------------------------------------------------------
# phase 11: K9 (paged decode attention) against its plain version
# ---------------------------------------------------------------------------

# name: (nh, nkv, lengths, pages per row, dtype); page 16, head_dim 128.
# "llama" and "gpt" are phase 12's decode steps midway (the pools of
# build_paged_caches: B x pages-per-row pages of 16)
K9_CASES = {
    "llama": (32, 32, [576] * 8, 40, torch.float32),
    "gpt": (16, 16, [288] * 8, 20, torch.float32),
    "ragged": (32, 32, [0, 1, 17, 100, 255, 384, 577, 640], 40,
               torch.float32),
    "gqa": (32, 8, [576] * 8, 40, torch.float32),
    "bf16": (32, 32, [576] * 8, 40, torch.bfloat16),
}
K9_PAGE = 16


def k9_case(nh, nkv, lengths, ppseq, dtype, g):
    """Pools of B x ppseq pages plus a page 0 that no row owns, each row's
    pages in a random order, unused table slots at page 0.  Every byte no
    row needs (page 0, slots past a row's length) is NaN in the pools the
    kernel gets and 0 in the copies the plain version gets, so a kernel
    that read one would return NaN.  Returns (q, (k, v) with NaN, (k, v)
    with 0, lengths, tables)."""
    b, ps = len(lengths), K9_PAGE
    n_pages = b * ppseq + 1
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda") + 1
    tables = torch.zeros(b, ppseq, dtype=torch.int32, device="cuda")
    live = torch.zeros(n_pages, ps, dtype=torch.bool, device="cuda")
    for i, n in enumerate(lengths):
        rows = perm[i * ppseq:(i + 1) * ppseq][:-(-n // ps)]
        tables[i, :len(rows)] = rows.to(torch.int32)
        t = torch.arange(n, device="cuda")
        live[rows[t // ps], t % ps] = True
    dead = ~live[None, :, :, None]
    shape = (nkv, n_pages, ps, HD)
    pools = [rand(shape, dtype, g) for _ in range(2)]
    poisoned = tuple(p.masked_fill(dead, float("nan")) for p in pools)
    clean = tuple(p.masked_fill(dead, 0.0) for p in pools)
    q = rand((b, nh, HD), dtype, g)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, poisoned, clean, lens, tables


def k9_library(q, k, v, lens, tables, lengths):
    """``scaled_dot_product_attention`` on each row's live K/V rows,
    gathered from the pages beforehand (the gather is not timed; a
    yardstick only, the port never calls it)."""
    b, nh, _ = q.shape
    nkv = k.shape[0]
    lmax = max(lengths)
    t = torch.arange(lmax, device="cuda")
    pages = tables.long()[:, t // K9_PAGE]                   # [B, lmax]
    kl, vl = (p[:, pages, t % K9_PAGE].transpose(0, 1).contiguous()
              for p in (k, v))                               # [B, nkv, l, hd]
    mask = None
    if min(lengths) != lmax:
        mask = (t[None, :] < lens[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None], kl, vl, attn_mask=mask, enable_gqa=nh != nkv)


def check_k9():
    t0 = time.perf_counter()
    for line in _build.build_log.get("paged_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            say(f"ptxas paged_attention: {line.strip()}")
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    rows = {}
    for case, (nh, nkv, lengths, ppseq, dtype) in K9_CASES.items():
        q, poisoned, clean, lens, tables = k9_case(nh, nkv, lengths, ppseq,
                                                   dtype, g)
        before = pa.launches
        got = pa.paged_attention(q, *poisoned, lens, tables)
        torch.cuda.synchronize()
        if pa.launches != before + 1:
            fail(f"K9 {case}: launches did not move by 1")
        ref = pa.paged_attention_ref(q, *clean, lens, tables)
        if got.dtype != dtype or got.shape != q.shape:
            fail(f"K9 {case}: {got.dtype} {tuple(got.shape)}")
        check_close(f"K9 {case}", got, ref, dtype)
        for i, n in enumerate(lengths):
            if n == 0 and not (got[i] == 0).all():
                fail(f"K9 {case}: the zero-length row {i} is not exactly 0")
        item = q.element_size()
        live_pages = sum(-(-n // K9_PAGE) for n in lengths)
        # the live K/V rows, q and the output; the lengths and the live
        # table entries
        nbytes = item * (2 * nkv * HD * sum(lengths) + 2 * q.numel()) \
            + 4 * (len(lengths) + live_pages)
        row = dict(
            kernel="K9", case=case, dtype=str(dtype).replace("torch.", ""),
            max_abs_err=max_err(got, ref),
            tol=dict(zip(("atol", "rtol"), KTOL[dtype])),
            ms=time_ms(lambda: pa.paged_attention(q, *poisoned, lens,
                                                  tables), 50),
            plain_ms=time_ms(lambda: pa.paged_attention_ref(
                q, *clean, lens, tables), 5),
            library_ms=time_ms(k9_library(q, *clean, lens, tables, lengths),
                               50))
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 4 * HD * nh * sum(lengths), PEAK_FLOPS[dtype])
        lens_txt = lengths[0] if min(lengths) == max(lengths) else lengths
        row["shape"] = (f"q [{len(lengths)}, {nh}, {HD}], pools [{nkv}, "
                        f"{q.shape[0] * ppseq + 1}, {K9_PAGE}, {HD}], "
                        f"{ppseq} pages per row, lengths {lens_txt}")
        say("K9 " + json.dumps(row))
        rows[case] = row
        del q, poisoned, clean, got, ref
    torch.cuda.empty_cache()
    say(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 12: eager paged generate (K9) and beam search
# ---------------------------------------------------------------------------

PAGED_GPT = dict(batch=8, prompt=256, new=64)     # phase 4b's shapes
PAGED_EAGER_NEW = 16
# beam search on llama2-7b and GPT-3 1.3B.  The check recomputes each
# returned hypothesis's score from a dense forward over it; the penalty 0.5
# divides the summed log-probs by sqrt(288) = 17: enough that the carried
# sum's fp32 rounding (32 additions) stays far under the limit, little
# enough that a search that skips the cache reorder, whose log-probs come
# from the wrong beams' histories, lands well outside it
BEAM = dict(batch=2, num_beams=4, prompt=256, new=32, length_penalty=0.5)


def paged_call(model, ids, new, **kw):
    """One eager ``generate`` call, synchronised: (tokens, seconds, the
    launches it made, ``generation.decode_stats``)."""
    torch.cuda.synchronize()
    before = counts()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = counts()
    return (out, dt, {k: after[k] - before[k] for k in after},
            dict(generation.decode_stats))


def check_paged_launches(tag, moved, stats, layers, per_forward, prefill):
    """Exact launches of one paged greedy call: K9 once per layer per
    decode step, the norms of every forward (prefill and steps), the
    prefill's attention and rope, nothing else (no K6, no K7)."""
    steps = stats["steps"]
    want = {k: 0 for k in moved}
    want["paged_attention"] = layers * steps
    want.update({k: n * (steps + 1) for k, n in per_forward.items()},
                **prefill)
    if moved != want:
        fail(f"{tag}: launches {moved} != {want}")
    say(f"{tag}: launches per call: K9 {layers} x {steps} decode steps = "
        f"{moved['paged_attention']}; "
        f"{ {k: moved[k] for k in list(per_forward) + list(prefill)} }")


def paged_first_step(model, ids):
    """Prefill, the greedy token, one paged decode step over pools of
    S + 1 positions: (step logits [B, V], token [B])."""
    logits, past = model(ids, use_cache=True, last_logits_only=True)
    tok = logits[:, -1].argmax(dim=-1)
    views = generation._to_paged(past, ids.shape[0], ids.shape[1] + 1)
    del past
    out, _ = model(tok[:, None], past=views, use_cache=True)
    return out[:, -1], tok


def paged_step_check(tag, model, ids):
    """The first paged step's logits against the dense forward over
    prompt + token, and the fault control (the tables' lengths one short,
    so attention misses the appended position) that must fail the same
    check.  Returns (error, control's error)."""
    sound = pa.PagedKVCache.batch_tables

    def short(self, seq_ids):
        lengths, tables = sound(self, seq_ids)
        return lengths - 1, tables

    with torch.no_grad():
        got, tok = paged_first_step(model, ids)
        dense = model(torch.cat([ids, tok[:, None]], dim=1),
                      last_logits_only=True)[:, -1]
        err = max_err(got, dense)
        pa.PagedKVCache.batch_tables = short
        try:
            bad, _ = paged_first_step(model, ids)
        finally:
            pa.PagedKVCache.batch_tables = sound
        ctrl = max_err(bad, dense)
    if not torch.isfinite(got).all() or got.shape != dense.shape:
        fail(f"{tag} step logits: shape {tuple(got.shape)} or non-finite")
    say(f"{tag}: paged step vs dense forward over prompt {ids.shape[1]} + "
        f"1: max abs err {err:.3e} (tol {STEP_LOGITS_TOL}); control "
        f"lengths one short: {ctrl:.3e}")
    if err > STEP_LOGITS_TOL:
        fail(f"{tag}: paged step logits differ from the dense forward by "
             f"{err}")
    if ctrl <= STEP_LOGITS_TOL:
        fail(f"{tag}: the fault control passes the step-logit check "
             f"({ctrl})")
    return err, ctrl


def paged_main_path(tag, model, ids, new, layers, per_forward, prefill,
                    eager, margin):
    """Paged greedy ``generate`` at the path's shape: exact launches, the
    same tokens twice, the first step against the dense forward with its
    control, the tokens against eager dense ``generate`` up to each row's
    first small top-2 margin, and the times beside a dense eager call."""
    b, s = ids.shape
    vocab = model.config.vocab_size
    reset_counts()                   # count the main path's launches only
    out, dt_cold, moved, stats = paged_call(model, ids, new,
                                            use_paged_cache=True)
    check_greedy_rows(tag, out, ids, new, vocab)
    if stats["loop"] != "paged":
        fail(f"{tag}: the {stats['loop']} loop ran")
    check_paged_launches(tag, moved, stats, layers, per_forward, prefill)
    torch.cuda.reset_peak_memory_stats()
    out2, dt, _, stats2 = paged_call(model, ids, new, use_paged_cache=True)
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(out, out2):
        fail(f"{tag}: a second greedy call gave other tokens")
    dense, dt_dense, _, _ = paged_call(model, ids, new)
    err, ctrl = paged_step_check(tag, model, ids)
    compared = agreement(tag, eager, margin, out[:, s:])
    equal = int((dense[:, s:] == out[:, s:]).sum())
    say(f"{tag}: {dt:.3f} s per call (first {dt_cold:.3f} s), "
        f"{1e3 * dt / new:.2f} ms per token, {b * new / dt:.1f} tokens/s; "
        f"host reads {stats2['host_reads']} and table copies to the card "
        f"{stats2['table_copies']} (non-blocking) per call; peak memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB); the dense eager call "
        f"{dt_dense:.3f} s, {1e3 * dt_dense / new:.2f} ms per token "
        f"({equal} of {b * new} tokens equal to the paged call's)")
    return dict(launches=moved["paged_attention"], ln_fwd=moved["ln_fwd"],
                steps=stats["steps"],
                s_per_call=dt, ms_per_token=1e3 * dt / new,
                tokens_per_s=b * new / dt, dense_s_per_call=dt_dense,
                host_reads=stats2["host_reads"],
                table_copies=stats2["table_copies"], peak=peak,
                step_err=err, control_err=ctrl, compared=compared)


def beam_score_errors(model, out, scores, s, lp):
    """|carried score - the hypothesis's summed log-probs from one dense
    forward over it / len ** lp| for each row."""
    with torch.no_grad():
        logp = torch.log_softmax(model(out).float(), dim=-1)
    errs = []
    for r in range(out.shape[0]):
        toks = out[r, s:]
        total = logp[r, s - 1:-1].gather(-1, toks[:, None]).double().sum()
        errs.append(abs(total.item() / out.shape[1] ** lp - scores[r]))
    return errs


def beam_main_path(tag, model, require_reorder):
    """Beam search: one beam is greedy; each returned hypothesis's carried
    score equals the score recomputed from a dense forward over it; and
    (``require_reorder``) the reorders moved cache rows and a search that
    skips them fails that check.  On random GPT-3 1.3B weights the tied
    head makes each prompt's best beam its greedy continuation (log-prob
    ~0 against ~-30 for any other token), which stays in its own row: the
    reorders move only the losing beams, so skipping them leaves the
    returned hypotheses as they were, and that path reads the control
    without holding it to the limit.  LLaMA's untied head gives flat
    log-probs, the winning beams change rows, and the control must fail."""
    b, nb, s, new, lp = (BEAM[k] for k in ("batch", "num_beams", "prompt",
                                           "new", "length_penalty"))
    rs = np.random.RandomState(3)
    ids = torch.from_numpy(rs.randint(0, model.config.vocab_size,
                                      (b, s))).cuda()
    greedy = model.generate(ids, max_new_tokens=new)
    one = model.generate(ids, max_new_tokens=new, num_beams=1,
                         length_penalty=lp)
    if not torch.equal(one, greedy):
        fail(f"{tag}: num_beams=1 does not give greedy's tokens")
    sound = generation._reorder_past
    moves = []

    def counting(past, beam_idx):
        moves.append(int((beam_idx != torch.arange(
            len(beam_idx), device=beam_idx.device)).sum()))
        return sound(past, beam_idx)

    reset_counts()
    generation._reorder_past = counting
    try:
        out, dt, moved, stats = paged_call(model, ids, new, num_beams=nb,
                                           length_penalty=lp)
    finally:
        generation._reorder_past = sound
    if stats["loop"] != "beam" or moved["paged_attention"]:
        fail(f"{tag}: the {stats['loop']} loop ran, K9 launches "
             f"{moved['paged_attention']}")
    check_greedy_rows(tag, out, ids, new, model.config.vocab_size)
    errs = beam_score_errors(model, out, stats["scores"], s, lp)
    generation._reorder_past = lambda past, beam_idx: past
    try:
        bad = model.generate(ids, max_new_tokens=new, num_beams=nb,
                             length_penalty=lp)
        bad_scores = list(generation.decode_stats["scores"])
    finally:
        generation._reorder_past = sound
    ctrl = beam_score_errors(model, bad, bad_scores, s, lp)
    say(f"{tag}: batch {b} x {nb} beams, prompt {s} + {new}, "
        f"length_penalty {lp}: {dt:.3f} s per call, {stats['steps']} "
        f"steps, host reads {stats['host_reads']}; rows moved by the "
        f"reorders {moves}; scores {stats['scores']}; |carried - "
        f"recomputed| {errs} (tol {STEP_LOGITS_TOL}); control without the "
        f"cache reorder: {ctrl}; {int((out[:, s:] != greedy[:, s:]).sum())}"
        f" of {b * new} tokens differ from greedy")
    if max(errs) > STEP_LOGITS_TOL:
        fail(f"{tag}: a carried score is {max(errs)} from its "
             "recomputation")
    if require_reorder and not sum(moves):
        fail(f"{tag}: no reorder moved a cache row")
    if require_reorder and max(ctrl) <= STEP_LOGITS_TOL:
        fail(f"{tag}: the skipped-reorder control passes the score check "
             f"({ctrl})")
    return dict(s_per_call=dt, score_err=max(errs), control_err=max(ctrl),
                rows_moved=sum(moves))


def paged_main_paths(llama):
    """Phase 12: the LLaMA path on phase 10's model and prompt, then GPT-3
    1.3B rebuilt from phase 4's seed: paged greedy and beam search."""
    t0 = time.perf_counter()
    model, ids = llama["model"], llama["ids"]
    layers = model.config.num_layers
    lp = paged_main_path(
        "llama paged", model, ids, DECODE["new"], layers,
        {"rms_fwd": 2 * layers + 1}, {"flash_fwd": layers,
                                      "rope": 2 * layers},
        llama["eager"], llama["margin"])
    llama_beam = beam_main_path("llama beam", model, require_reorder=True)
    del model                        # phase 16 takes it on from llama
    gc.collect()
    torch.cuda.empty_cache()
    cfg = gpt_config("gpt3-1.3B", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    model = GPTForPretraining(cfg, seed=0)
    b, s, new = (PAGED_GPT[k] for k in ("batch", "prompt", "new"))
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s))).cuda()
    eager, margin = eager_tokens(model, ids, PAGED_EAGER_NEW)
    gp = paged_main_path("gpt paged", model, ids, new, N_LAYERS,
                         {"ln_fwd": 2 * N_LAYERS + 1},
                         {"flash_fwd": N_LAYERS}, eager, margin)
    beam = beam_main_path("gpt beam", model, require_reorder=False)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return dict(llama=lp, gpt=gp, beam=beam, llama_beam=llama_beam)



# ---------------------------------------------------------------------------
# phase 13: K8a/K8b against their plain versions
# ---------------------------------------------------------------------------

# name: (N, V, dtype, labels): "main" is the BART path's loss (batch 8 x
# decoder 1024 tokens, bart-base's vocabulary 50265, fp32); GPT's and
# LLaMA's vocabularies; bf16; a ragged odd case; every row ignored; labels
# outside [0, V) that are not ignore_index ("oob": no column picked, loss
# = lse, dx = softmax · g).  "mixed" labels have ~10 % of rows -100.
K8_CASES = {
    "main": (8192, 50265, torch.float32, "mixed"),
    "gpt-vocab": (8192, 50304, torch.float32, "mixed"),
    "llama-vocab": (8192, 32000, torch.float32, "mixed"),
    "bf16": (8192, 50265, torch.bfloat16, "mixed"),
    "ragged": (33, 37, torch.float32, "mixed"),
    "all-ignored": (64, 50265, torch.float32, "ignored"),
    "oob": (64, 50265, torch.float32, "oob"),
}
# K8 vs its plain version.  The loss: the kernel's one-pass online lse
# against torch's two-pass logsumexp, both fp32 sums of up to 50304 terms
# in other orders: a relative error of ~1e-6 on a sum, so ~1e-6 on an lse
# of ~13; the limit 1e-4 leaves a margin and still sees any wrong term
# (one missing exp of a typical logit moves the lse by ~1/V·e^x ~ 1e-5 at
# most, a wrong max or row by far more).  dx fp32: exp(x - lse) from lses
# that differ by ~1e-6, times g: atol 1e-6 + rtol 1e-4.  dx bf16: both
# round once to bf16 from fp32 values a few ulps apart, so at most one
# bf16 step (2^-7 relative) apart: rtol 1e-2.  Ignored rows: exactly 0.
K8_LOSS_TOL = 1e-4
K8_DX_TOL = {torch.float32: (1e-6, 1e-4), torch.bfloat16: (1e-6, 1e-2)}


def k8_case(n, v, dtype, kind, g):
    """Logits (N(0, 2²) in fp32, cast to ``dtype``), int64 labels and a
    per-row upstream gradient that is non-zero on ignored rows too (the
    kernel must zero them itself)."""
    x = rand((n, v), dtype, g, 2.0)
    lab = torch.randint(0, v, (n,), generator=g, device="cuda")
    if kind == "mixed":
        lab[torch.rand(n, generator=g, device="cuda") < 0.1] = -100
        lab[0] = -100
    elif kind == "ignored":
        lab[:] = -100
    elif kind == "oob":
        lab[0::4] = v + 5
        lab[1::4] = -1
        lab[2::4] = -7
        lab[3] = -100
    up = torch.randn(n, generator=g, device="cuda")
    return x, lab, up


def check_k8():
    rows = {}
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    for case, (n, v, dtype, kind) in K8_CASES.items():
        x, lab, up = k8_case(n, v, dtype, kind, g)
        lab32 = lab.to(torch.int32)
        before = dict(sce.launches)
        loss, lse = sce.softmax_ce_fwd(x, lab32)
        dx = sce.softmax_ce_bwd(x, lab32, lse, up)
        torch.cuda.synchronize()
        if any(sce.launches[k] != before[k] + 1 for k in before):
            fail(f"K8 {case}: launch counters did not move: {sce.launches}")
        xp = x.clone().requires_grad_()
        loss_p = sce.reference_softmax_ce(xp, lab)
        (dx_p,) = torch.autograd.grad(loss_p, xp, up, retain_graph=True)
        ignored = lab == -100
        if not torch.isfinite(loss).all() or not torch.isfinite(
                dx.float()).all():
            fail(f"K8 {case}: non-finite kernel output")
        if (loss[ignored] != 0).any() or (dx[ignored] != 0).any():
            fail(f"K8 {case}: an ignored row's loss or dx is not exactly 0")
        e_loss = max_err(loss, loss_p)
        if e_loss > K8_LOSS_TOL:
            fail(f"K8 {case} loss: max abs err {e_loss:.3e} > "
                 f"{K8_LOSS_TOL}")
        atol, rtol = K8_DX_TOL[dtype]
        excess = ((dx.float() - dx_p.float()).abs()
                  - (atol + rtol * dx_p.float().abs())).max().item()
        if excess > 0:
            fail(f"K8 {case} dx: max abs err {max_err(dx, dx_p):.3e} "
                 f"exceeds atol {atol} + rtol {rtol} |plain|")
        if kind == "oob":
            picked_none = ((lab < 0) | (lab >= v)) & ~ignored
            lse_p = torch.logsumexp(x.float(), -1)
            e_oob = max_err(loss[picked_none], lse_p[picked_none])
            if e_oob > K8_LOSS_TOL:
                fail(f"K8 oob: loss is not the lse where no column is "
                     f"picked ({e_oob:.3e})")
        item = x.element_size()
        valid = int((~ignored).sum())
        # the bytes this data needs: an ignored row is neither read
        # forward nor backward (its dx is written as zeros)
        fwd_bytes = valid * v * item + n * 12
        bwd_bytes = valid * v * item + n * v * item + n * 12
        row = dict(case=case, n=n, v=v, dtype=str(dtype).replace(
            "torch.", ""), valid_rows=valid,
            max_abs_err=dict(loss=e_loss, dx=max_err(dx, dx_p)),
            fwd_ms=time_ms(lambda: sce.softmax_ce_fwd(x, lab32), 20),
            bwd_ms=time_ms(lambda: sce.softmax_ce_bwd(x, lab32, lse, up),
                           20),
            plain_fwd_ms=time_ms(lambda: sce.reference_softmax_ce(x, lab),
                                 5),
            plain_bwd_ms=time_ms(lambda: torch.autograd.grad(
                loss_p, xp, up, retain_graph=True), 5),
            fwd_bound=bound_ms(fwd_bytes, 4 * valid * v,
                               PEAK_FLOPS[torch.float32]),
            bwd_bound=bound_ms(bwd_bytes, 4 * valid * v,
                               PEAK_FLOPS[torch.float32]))
        # yardstick: torch's cross entropy (per row) and its backward; it
        # asserts on a label outside [0, V), so those take column 0 there
        lib_lab = torch.where((lab < 0) & ~ignored | (lab >= v),
                              torch.zeros_like(lab), lab)
        xl = x.clone().requires_grad_()
        lib = F.cross_entropy(xl, lib_lab, ignore_index=-100,
                              reduction="none")
        row["library_fwd_ms"] = time_ms(lambda: F.cross_entropy(
            x, lib_lab, ignore_index=-100, reduction="none"), 20)
        row["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            lib, xl, up, retain_graph=True), 20)
        say("K8 " + json.dumps(row))
        rows[case] = row
        del x, lab, lab32, up, loss, lse, dx, xp, loss_p, dx_p, xl, lib
        del lib_lab
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 14: the BART main path (training, cross-check, generate)
# ---------------------------------------------------------------------------

# bart-base at the reference's default BartConfig (d_model 768, 6 + 6
# layers, 12 heads, FFN 3072, vocab 50265, 1024 positions), fp32, nothing
# cut; batch 8 x encoder 1024 + decoder 1024 (the denoising objective
# rebuilds the whole document, so both sides run at the full
# max_position_embeddings)
BART_BATCH, BART_SEQ = 8, 1024
BART_XCHECK_LAYERS = 2
# the 14b cross-check in fp32: both steps run the same cuBLAS matmuls; the
# norms and the loss differ by the kernels' summation orders (a few ulps),
# so the loss agrees to ~1e-6 of ~11 and each gradient to ~1e-5 of its
# norm.  The control (ignored rows given a gradient) moves the gradients
# by the share of ignored rows, ~10 %.
BART_LOSS_TOL = 1e-4
BART_GRAD_REL_TOL = 1e-3
BART_GEN = dict(batch=4, new=32, num_beams=4)


def bart_per_step(c: BartConfig):
    """Exact launches per step: one K8a and one K8b; LayerNorm after the
    embeddings of each stack, twice per encoder layer and three times
    per decoder layer (forward and dx each); AdamW per trainable
    parameter (16 per encoder layer, 26 per decoder layer, 3 per stack
    and the shared embedding; not the frozen final_logits_bias)."""
    norms = 1 + 2 * c.encoder_layers + 1 + 3 * c.decoder_layers
    want = {k: 0 for k in PER_STEP}
    want.update(ce_fwd=1, ce_bwd=1, ln_fwd=norms, ln_bwd_dx=norms,
                adamw=7 + 16 * c.encoder_layers + 26 * c.decoder_layers)
    return want


def bart_step_flops(c: BartConfig, b: int, s: int) -> int:
    """FLOPs of one training step's matrix products (3 x the forward's 2
    per multiply-add), encoder and decoder at ``s`` tokens each: the
    projections, the FFNs, attention scores and context over all ``s``
    keys (the masks are additive, so nothing is skipped) and the head."""
    d, v = c.d_model, c.vocab_size
    enc = c.encoder_layers * (4 * d * d + 2 * d * c.encoder_ffn_dim
                              + 2 * s * d)
    dec = c.decoder_layers * (8 * d * d + 2 * d * c.decoder_ffn_dim
                              + 4 * s * d) + d * v
    return 6 * b * s * (enc + dec)


def bart_batch(cfg, b, s, seed):
    """Encoder ids with each row's tail padded (mask 0, pad id), decoder
    ids from the start token, labels -100 at the decoder's padded tail
    (tails up to 20 % of a row, ~10 % on average)."""
    rs = np.random.RandomState(seed)
    v = cfg.vocab_size
    enc = rs.randint(3, v, (b, s))
    mask = np.ones((b, s), np.int64)
    dec = rs.randint(3, v, (b, s))
    dec[:, 0] = cfg.decoder_start_token_id
    labels = rs.randint(3, v, (b, s))
    for r in range(b):
        pad_enc, pad_dec = rs.randint(0, s // 5, 2)
        if pad_enc:
            mask[r, s - pad_enc:] = 0
            enc[r, s - pad_enc:] = cfg.pad_token_id
        if pad_dec:
            dec[r, s - pad_dec:] = cfg.pad_token_id
            labels[r, s - pad_dec:] = -100
    return tuple(torch.from_numpy(a).cuda() for a in (enc, mask, dec,
                                                      labels))


def bart_step_fn(m, enc, mask, dec, labels):
    return m.loss_fn(m(enc, dec, attention_mask=mask), labels)


def build_bart_trainer(cfg, seed):
    model = BartForConditionalGeneration(cfg, seed=seed)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01)
    return model, opt, train_step(model, None, opt, step_fn=bart_step_fn)


def bart_train_main_path():
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = BartConfig()
    model, opt, step = build_bart_trainer(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    n_tensors = len(list(model.parameters()))
    per_step = bart_per_step(cfg)
    if n_tensors != per_step["adamw"] + 1:
        fail(f"bart-base has {n_tensors} parameter tensors")
    say(f"bart: bart-base (d_model {cfg.d_model}, {cfg.encoder_layers} + "
        f"{cfg.decoder_layers} layers, {cfg.encoder_attention_heads} heads,"
        f" FFN {cfg.encoder_ffn_dim}, vocab {cfg.vocab_size}), fp32, N = "
        f"{n_params} trainable parameters in {n_tensors - 1} tensors (+ the"
        f" frozen final_logits_bias), batch {BART_BATCH} x encoder "
        f"{BART_SEQ} + decoder {BART_SEQ}, AdamW(1e-4, weight decay 0.01), "
        f"built in {time.perf_counter() - t0:.3f} s")
    batch = bart_batch(cfg, BART_BATCH, BART_SEQ, seed=0)
    valid = int((batch[3] != -100).sum())
    tokens = 2 * BART_BATCH * BART_SEQ
    reset_counts()                   # count the main path's launches only
    losses, step_s = [], []
    for i in range(sum(N_STEPS.values())):
        before = counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step(*batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        after = counts()
        moved = {k: after[k] - before[k] for k in per_step}
        if moved != per_step:
            fail(f"bart step {i}: launches {moved} != {per_step}")
        say(f"bart step {i}: {1e3 * step_s[-1]:.2f} ms, "
            f"{tokens / step_s[-1]:.1f} tokens/s (encoder + decoder), "
            f"peak memory {torch.cuda.max_memory_allocated()} bytes")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    vals = [float(l) for l in losses]
    say(f"bart: losses {vals}")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"bart losses not finite and falling: {vals}")
    if float(model.final_logits_bias.abs().sum()) != 0.0:
        fail("bart: the frozen final_logits_bias moved")
    timed = step_s[N_STEPS["cold"] + N_STEPS["warmup"]:]
    mean_s = sum(timed) / len(timed)
    flops = bart_step_flops(cfg, BART_BATCH, BART_SEQ)
    util = flops / mean_s / PEAK_FLOPS[torch.float32]
    say(f"bart: timed steps {[round(1e3 * t, 2) for t in timed]}; mean "
        f"{1e3 * mean_s:.2f} ms = {tokens / mean_s:.1f} tokens/s "
        f"({valid} labelled decoder tokens a step); matrix products "
        f"{flops:.4e} FLOP a step = {100 * util:.2f} % of 67 TFLOP/s "
        f"fp32; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    say(f"bart: launches over {sum(N_STEPS.values())} steps {launches}")
    return model, launches


def plain_bart_loss(P, cfg, enc, mask, dec, labels, fault=None):
    """The forward and loss of ``models/bart.py`` composed from the plain
    versions (``layer_norm_ref``, ``reference_softmax_ce``) in fp32.
    ``fault="ce_ignored_grad"`` keeps the forward and gives the ignored
    rows the gradient of their clamped label's loss (a K8b that does not
    zero g there)."""
    d = cfg.d_model

    def lnorm(x, name):
        return ln.layer_norm_ref(x, P[name + ".weight"], P[name + ".bias"],
                                 1e-5)

    def linear(x, name):
        return torch.matmul(x, P[name + ".weight"]) + P[name + ".bias"]

    def attention(x, pre, heads, kv, key_mask, causal):
        b, sq = x.shape[:2]
        mem = x if kv is None else kv
        sk, dk = mem.shape[1], d // heads
        q = linear(x, pre + "q_proj").reshape(b, sq, heads, dk) \
            .transpose(1, 2)
        k = linear(mem, pre + "k_proj").reshape(b, sk, heads, dk) \
            .transpose(1, 2)
        v = linear(mem, pre + "v_proj").reshape(b, sk, heads, dk) \
            .transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2)) * dk ** -0.5
        if key_mask is not None:
            s = s + ((1.0 - key_mask.float()) * -1e9).reshape(b, 1, 1, sk)
        if causal:
            s = s + torch.full((sq, sk), -1e9, device=x.device).triu(
                sk - sq + 1)
        ctx = torch.matmul(torch.softmax(s, -1), v).transpose(1, 2)
        return linear(ctx.reshape(b, sq, d), pre + "out_proj")

    def stack(ids, name, n, heads, self_mask, memory=None):
        s = ids.shape[1]
        x = P["shared.weight"][ids] + P[name + ".embed_positions.weight"][
            torch.arange(2, s + 2, device=ids.device)]
        x = lnorm(x, name + ".layernorm_embedding")
        for i in range(n):
            pre = f"{name}.layers.{i}."
            x = lnorm(x + attention(x, pre + "self_attn.", heads, None,
                                    self_mask, memory is not None),
                      pre + "self_attn_layer_norm")
            if memory is not None:
                x = lnorm(x + attention(x, pre + "encoder_attn.", heads,
                                        memory, mask, False),
                          pre + "encoder_attn_layer_norm")
            x = lnorm(x + linear(F.gelu(linear(x, pre + "fc1")),
                                 pre + "fc2"), pre + "final_layer_norm")
        return x

    memory = stack(enc, "encoder", cfg.encoder_layers,
                   cfg.encoder_attention_heads, mask)
    h = stack(dec, "decoder", cfg.decoder_layers,
              cfg.decoder_attention_heads, None, memory)
    logits = (torch.matmul(h, P["shared.weight"].t())
              + P["final_logits_bias"]).reshape(-1, cfg.vocab_size)
    flat = labels.reshape(-1)
    valid = flat != -100
    rows = sce.reference_softmax_ce(logits, flat)
    if fault == "ce_ignored_grad":
        # the loss of the clamped label: 0 in the forward, its gradient
        # on the ignored rows in the backward
        alt = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, flat.clamp(min=0)[:, None])[:, 0]
        rows = rows + torch.where(valid, torch.zeros_like(alt),
                                  alt - alt.detach())
    return rows.sum() / valid.float().sum().clamp(min=1e-12)


def bart_cross_check():
    """Phase 14b: one fp32 step at full width and depth 2 + 2 through the
    kernels (K8, K2, K3) against the same step from the plain versions,
    with the ignored-rows control."""
    cfg = BartConfig(encoder_layers=BART_XCHECK_LAYERS,
                     decoder_layers=BART_XCHECK_LAYERS)
    model, opt, step = build_bart_trainer(cfg, seed=1)
    batch = bart_batch(cfg, BART_BATCH, BART_SEQ, seed=1)
    step_cross_check(
        f"bart cross-check ({BART_XCHECK_LAYERS} + {BART_XCHECK_LAYERS} "
        f"layers, full width, batch {BART_BATCH} x {BART_SEQ} + "
        f"{BART_SEQ}, fp32)", model, opt, step,
        lambda P, fault: plain_bart_loss(P, cfg, *batch, fault), batch,
        controls=("ce_ignored_grad",), loss_tol=BART_LOSS_TOL,
        grad_tol=BART_GRAD_REL_TOL,
        # a key bias adds one constant to all of a query's scores, which
        # the softmax removes: its exact gradient is 0, so its error is
        # held against the value bias's gradient norm
        scale_of={n: n.replace("k_proj", "v_proj")
                  for n, _ in model.named_parameters()
                  if n.endswith("k_proj.bias")})
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()


def bart_generate_main_path(model):
    """Phase 14c: greedy and beam ``generate`` on phase 14's model; the
    greedy tokens equal the argmax of a teacher-forced dense forward up to
    each row's first top-2 margin under STEP_LOGITS_TOL; each beam's
    carried score equals its recomputation from that forward; the forced
    eos fills the last slot; no K8 launch."""
    cfg = model.config
    b, new, nb = (BART_GEN[k] for k in ("batch", "new", "num_beams"))
    enc, mask, _, _ = bart_batch(cfg, b, BART_SEQ, seed=2)
    eos = cfg.eos_token_id
    res = {}
    # a random BART copies its input token, and its start token is its
    # eos: a greedy call with the config's eos ends after one token.  The
    # greedy call switches the stop off (an id no row can emit), so every
    # row runs all its steps; beam search keeps the config's eos
    for tag, kw in (("greedy", dict(eos_token_id=-1)),
                    ("beam", dict(num_beams=nb))):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(enc, max_new_tokens=new, attention_mask=mask,
                             **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved = counts()
        if any(v for k, v in moved.items() if k != "ln_fwd") \
                or not moved["ln_fwd"]:
            fail(f"bart {tag} generate: launches {moved} (K2a only)")
        if tuple(out.shape) != (b, 1 + new) or \
                not (out[:, -1] == eos).all():
            fail(f"bart {tag} generate: {tuple(out.shape)}, last slot "
                 f"{out[:, -1].tolist()} (the forced eos is {eos})")
        scores = list(generation.decode_stats.get("scores", [])) \
            if tag == "beam" else None
        with torch.no_grad():
            logits = model(enc, out[:, :-1], attention_mask=mask).float()
        toks = out[:, 1:]
        if tag == "greedy":
            top2 = logits.topk(2, dim=-1).values
            margin = (top2[..., 0] - top2[..., 1]).t().cpu()  # [new, B]
            want = logits.argmax(-1).cpu()
            # the forced last slot is not the argmax's: stop comparing
            # there (no row stops earlier: the stop is off)
            margin[-1] = 0.0
            compared = agreement("bart greedy (dense argmax)", want,
                                 margin, toks)
            say(f"bart greedy: {len(set(toks.flatten().tolist()))} "
                f"distinct tokens; first row {toks[0].tolist()}")
            res[tag] = dict(s_per_call=dt, compared=compared)
        else:
            logp = torch.log_softmax(logits, -1)
            errs = []
            for r in range(b):
                hit = torch.nonzero(toks[r] == eos)
                e = int(hit[0])
                total = logp[r, :e].gather(-1, toks[r, :e, None]).double() \
                    .sum().item()
                if e < new - 1:                # a natural eos, not forced
                    total += logp[r, e, eos].item()
                errs.append(abs(total / (1 + e) - scores[r]))
            say(f"bart beam: scores {scores}; |carried - recomputed| "
                f"{errs} (tol {STEP_LOGITS_TOL})")
            if max(errs) > STEP_LOGITS_TOL:
                fail(f"bart beam: a carried score is {max(errs)} from its "
                     "recomputation")
            res[tag] = dict(s_per_call=dt, score_err=max(errs))
        say(f"bart {tag} generate: batch {b} x encoder {BART_SEQ} + {new} "
            f"new tokens{' x ' + str(nb) + ' beams' if tag == 'beam' else ''}: "
            f"{dt:.3f} s per call, {b * new / dt:.1f} tokens/s; launches "
            f"{ {k: v for k, v in moved.items() if v} } (no K8)")
    return res


def bart_main_paths():
    t0 = time.perf_counter()
    model, launches = bart_train_main_path()
    bart_generate_main_path(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    bart_cross_check()
    say(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 15: K6d (norm + matmul) against its plain version
# ---------------------------------------------------------------------------

# name: (kind, x's leading shape, H, N, weight transposed, bias, dtype).
# The first four are the program-pass paths' shapes (one decode token per
# row, batch 8, fp32): GPT-3 1.3B's ln1 -> qkv and ln2 -> fc1 (row-major
# [in, out] weights with biases) and its tied head, LLaMA-2 7B's head (both
# heads the transpose of a row-major [V, H] tensor).  Then bf16, 1, 33 and
# 64 rows (the gate's limit), an odd H and N in both layouts and other
# 3-D x.  K6d vs its plain version: the same fp32 products summed in other
# orders (read as a few 1e-6 on outputs of order 1-4); bf16 as
# check_k6_close says.
K6D_CASES = {
    "gpt_qkv": ("layer_norm", (8, 1), 2048, 6144, False, True,
                torch.float32),
    "gpt_fc1": ("layer_norm", (8, 1), 2048, 8192, False, True,
                torch.float32),
    "gpt_head": ("layer_norm", (8, 1), 2048, 50304, True, False,
                 torch.float32),
    "llama_head": ("rms_norm", (8, 1), 4096, 32000, True, False,
                   torch.float32),
    "bf16_head": ("rms_norm", (8, 1), 4096, 32000, True, False,
                  torch.bfloat16),
    "bf16_fc1": ("layer_norm", (8,), 2048, 8192, False, True,
                 torch.bfloat16),
    "rows1": ("layer_norm", (1,), 2048, 50304, True, False, torch.float32),
    "rows33": ("layer_norm", (33,), 2048, 6144, False, True,
               torch.float32),
    "rows64": ("rms_norm", (64,), 4096, 32000, True, False, torch.float32),
    "odd": ("layer_norm", (5,), 40, 37, False, True, torch.float32),
    "odd_t": ("rms_norm", (3, 2), 40, 37, True, True, torch.float32),
}
# the cases off the stream route (N 37 is no multiple of the 16-byte
# vector): the generic GEMV; every other case is a main-path shape
K6D_GENERIC = ("odd", "odd_t")


# the K6d launches of one optimized GPT-3 1.3B decode step
K6D_GPT_STEP = {"gpt_qkv": N_LAYERS, "gpt_fc1": N_LAYERS, "gpt_head": 1}


def k6d_case(kind, lead, h, n, transposed, bias, dtype, g):
    """(x, norm_w, norm_b, w, bias): a transposed w is the view of a
    row-major [n, h] tensor, as the heads arrive."""
    x = rand((*lead, h), dtype, g, 2.0)
    nw = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(dtype)
    nb = rand((h,), dtype, g, 0.1) if kind == "layer_norm" else None
    w = rand((n, h), dtype, g, 0.02).t() if transposed \
        else rand((h, n), dtype, g, 0.02)
    b = rand((n,), dtype, g, 0.1) if bias else None
    return x, nw, nb, w, b


def k6d_library(kind, x, nw, nb, w, b):
    """The yardstick: no single PyTorch call computes K6d's function, so
    the norm, then one product (with the bias: addmm)."""
    h = x.shape[-1]

    def norm():
        if kind == "layer_norm":
            return F.layer_norm(x, (h,), nw, nb, 1e-5)
        return F.rms_norm(x, (h,), nw, 1e-5)
    if b is not None:
        return lambda: torch.addmm(b, norm().reshape(-1, h), w)
    return lambda: torch.matmul(norm(), w)


def check_k6d():
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(15)
    rows, step = {}, []
    for case, (kind, lead, h, n, transposed, bias, dtype) in \
            K6D_CASES.items():
        args = k6d_case(kind, lead, h, n, transposed, bias, dtype, g)
        x, nw, nb, w, b = args
        kw = dict(kind=kind, eps=1e-5)
        if not fd.norm_matmul_admits(x, w, b):
            fail(f"K6d {case}: the gate does not admit it")
        route = fd.norm_matmul_route(x, w)
        want = "generic" if case in K6D_GENERIC else "stream"
        c_route = _build.library("fused_decode").fd_route(
            int(transposed), x.numel() // h, n, h,
            w.stride(1) if transposed else w.stride(0),
            fd._DTYPE_CODE[dtype],
            int(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0))
        if route != want or c_route != (want == "stream"):
            fail(f"K6d {case}: route {route} (kernel {c_route}), want "
                 f"{want}")
        got = check_launch("norm_matmul", lambda: fd.norm_matmul(*args, **kw))
        check_relaunch(f"K6d {case}", lambda: fd.norm_matmul(*args, **kw),
                       got)
        ref = fd.norm_matmul_ref(*args, **kw)
        ref32 = fd.norm_matmul_ref(*f32(*args), **kw) \
            if dtype != torch.float32 else None
        if got.dtype != dtype or got.shape != (*lead, n):
            fail(f"K6d {case}: {got.dtype} {tuple(got.shape)}")
        errs = {"y": check_k6_close(f"K6d {case}", got, ref, ref32, dtype)}
        r = x.numel() // h
        item = x.element_size()
        # the weight rotates over copies (a transposed one as a fresh
        # view of a copy of its [n, h] tensor)
        copies = [args] + [
            (x, nw, nb, w.t().clone().t() if transposed else w.clone(), b)
            for _ in range(weight_copies(item * h * n) - 1)]
        libs = [k6d_library(kind, *c) for c in copies]
        vectors = (2 if kind == "layer_norm" else 1) * h + n * bool(bias)
        nbytes = item * (r * h + h * n + r * n + vectors)
        w_shape = f"[{n}, {h}]^T" if transposed else f"[{h}, {n}]"
        rows[case] = k6_row(
            "K6d", case, dtype, errs,
            time_rotating([functools.partial(fd.norm_matmul, *c, **kw)
                           for c in copies], 20),
            time_rotating([functools.partial(fd.norm_matmul_ref, *c, **kw)
                           for c in copies], 10),
            time_rotating(libs, 20),
            bound_ms(nbytes, 2 * r * h * n + 8 * r * h, PEAK_FLOPS[dtype]),
            route=route, weight_copies=len(copies),
            shape=f"x [{', '.join(map(str, lead))}, {h}], w {w_shape}"
                  f"{' + bias' if bias else ''}, {kind}")
        if case in K6D_GPT_STEP:
            step.append((case, copies, kw, libs))
        del x, nw, nb, w, b, args, got, ref, ref32
    # one GPT-3 1.3B decode step's launches (phase 16's optimized replay),
    # timed as one: 24 x qkv, 24 x fc1, the tied head, each launch on the
    # next weight copy, as each layer brings its own weights
    def per_step(pick):
        def run():
            for case, copies, kw, libs in step:
                for i in range(K6D_GPT_STEP[case]):
                    j = i % len(copies)
                    pick(copies[j], kw, libs[j])()
        return run
    rows["gpt_step"] = k6_row(
        "K6d", "gpt_step", torch.float32,
        {"y": {"plain": max(rows[c]["max_abs_err"]["y"]["plain"]
                            for c in K6D_GPT_STEP)}},
        time_ms(per_step(lambda a, kw, lib:
                         functools.partial(fd.norm_matmul, *a, **kw)), 10),
        time_ms(per_step(lambda a, kw, lib:
                         functools.partial(fd.norm_matmul_ref, *a, **kw)),
                5),
        time_ms(per_step(lambda a, kw, lib: lib), 10),
        (sum(rows[c]["bound_ms"] * m for c, m in K6D_GPT_STEP.items()),
         "bytes"),
        route="stream",
        shape="one decode step: " + ", ".join(
            f"{m} x ({rows[c]['shape']})" for c, m in K6D_GPT_STEP.items()))
    del step
    torch.cuda.empty_cache()
    say(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 16: the program-pass path — capture a decode step, run the default
# pipeline, replay both programs
# ---------------------------------------------------------------------------

PROGRAM = dict(batch=8, prompt=256, pairs=10)
# optimized vs unoptimized replay and vs the eager step (pass_check's card
# tolerance: K6d and K2a/K4a + cuBLAS sum in other orders, across 24 / 32
# layers)
PROGRAM_TOL = CARD_TOL


def _claimed_weights(prog, rep, opt, names):
    """{parameter name suffix: claims} of the claimed chains' weights
    (the hints index the program the claim pass saw, which is the captured
    one when CSE, folding and DCE removed nothing)."""
    if any(p["removed"] for p in rep["passes"][:3]):
        fail(f"program passes before the claim removed ops: {rep['passes']}")
    out = {}
    for h in opt.fusion_hints:
        if h.get("claimed"):
            w = prog.ops[h["ops"][1]].inputs[1]
            key = ".".join(names.get(id(w), "?").split(".")[-3:])
            out[key] = out.get(key, 0) + 1
    return out


def _replay(program, feeds, fetches, tok):
    """One synchronised replay: (outputs, the launches it made)."""
    pure, ext = program.build_replay(feeds, fetches)
    torch.cuda.synchronize()
    before = counts()
    with torch.no_grad():
        outs = pure((tok,), tuple(ext))
    torch.cuda.synchronize()
    after = counts()
    return outs, {k: after[k] - before[k] for k in after}


def _fetch_faults(got, want, tol=PROGRAM_TOL):
    """(max abs error, the fetches that fail the check): a fetch fails
    on another shape, a non-finite value or an element outside atol +
    rtol |want|."""
    worst, faults = 0.0, []
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            faults.append(f"fetch {i} {tuple(a.shape)} vs {tuple(b.shape)} "
                          "or non-finite")
            continue
        err = max_err(a, b)
        worst = max(worst, err)
        if ((a - b).abs() - tol["atol"]
                - tol["rtol"] * b.abs()).max().item() > 0:
            faults.append(f"fetch {i} max abs err {err:.3e} exceeds atol "
                          f"{tol['atol']} + rtol {tol['rtol']} |want|")
    return worst, faults


def _fetch_err(what, got, want):
    """Max abs error over the fetches; fails unless every fetch passes
    the check of :func:`_fetch_faults`."""
    worst, faults = _fetch_faults(got, want)
    if faults:
        fail(f"{what}: {faults[0]} ({len(faults)} fetches fail)")
    return worst


def program_main_path(tag, model, ids, want_chains, want_weights,
                      want_before, want_after, control=None):
    """Capture one decode step of ``model`` after a prefill of ``ids``,
    run the default pipeline, replay both programs: exact claims, exact
    launches per replay, the optimized fetches against the unoptimized
    replay and the eager step (the captured values), a fault control
    that must fail that check, and the replay times."""
    t0 = time.perf_counter()
    prog, feeds, fetches, tok = capture_decode_program(model, ids)
    t_capture = time.perf_counter() - t0
    if not graph.is_ssa(prog.ops):
        fail(f"{tag}: the captured step is not SSA: every pass would bail")
    t1 = time.perf_counter()
    opt, rep = run_program_passes(prog, fetches, label=tag)
    t_passes = time.perf_counter() - t1
    chains = {}
    for h in opt.fusion_hints:
        if h.get("claimed"):
            chains[h["chain"]] = chains.get(h["chain"], 0) + 1
    if chains != want_chains:
        fail(f"{tag}: claimed chains {chains} != {want_chains}")
    names = {id(p): n for n, p in model.named_parameters()}
    weights = _claimed_weights(prog, rep, opt, names)
    if weights != want_weights:
        fail(f"{tag}: claimed weights {weights} != {want_weights}")
    say(f"{tag}: captured {len(prog.ops)} ops in {t_capture:.3f} s "
        f"({graph.op_class_histogram(prog.ops)}); passes in "
        f"{t_passes:.3f} s: ops_before {rep['ops_before']}, ops_after "
        f"{rep['ops_after']}, reduction_pct {rep['reduction_pct']}, removed "
        f"{ {p['pass']: p['removed'] for p in rep['passes']} }; claimed "
        f"{chains} on {weights}")
    # the claim launched K6d to check itself: count the replays only
    reset_counts()
    outs_b, moved_b = _replay(prog, feeds, fetches, tok)
    err_b = _fetch_err(f"{tag} unoptimized replay vs eager", outs_b, fetches)
    outs_a, moved_a = _replay(opt, feeds, fetches, tok)
    for what, moved, want in (("unoptimized", moved_b, want_before),
                              ("optimized", moved_a, want_after)):
        full = {k: 0 for k in moved}
        full.update(want)
        if moved != full:
            fail(f"{tag}: launches per {what} replay {moved} != {full}")
    err_a = _fetch_err(f"{tag} optimized vs unoptimized replay", outs_a,
                       outs_b)
    err_e = _fetch_err(f"{tag} optimized replay vs eager", outs_a, fetches)
    del outs_a, outs_b
    ctrl = None
    if control is not None:
        real = fd.norm_matmul
        fd.norm_matmul = control(real)
        try:
            outs_c, _ = _replay(opt, feeds, fetches, tok)
        finally:
            fd.norm_matmul = real
        ctrl, faults = _fetch_faults(outs_c, fetches)
        if not faults:
            fail(f"{tag}: the control passes the fetch check ({ctrl:.3e})")
        say(f"{tag}: the control fails the fetch check: {faults[0]} "
            f"({len(faults)} of {len(fetches)} fetches)")
        del outs_c
    # host-bound and noisy (a shared host): the two programs take turns
    t_b, t_a = replay_times((prog, opt), feeds, fetches, tok,
                            PROGRAM["pairs"], torch.cuda.synchronize)
    ms_b, ms_a = quartiles(t_b), quartiles(t_a)
    wins = sum(a < b for a, b in zip(t_a, t_b))
    for what, program in (("unoptimized", prog), ("optimized", opt)):
        pure, ext = program.build_replay(feeds, fetches)
        ext = tuple(ext)
        torch.cuda.synchronize()
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t2 = time.perf_counter()
            pure((tok,), ext)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t2
        say(f"{tag}: one {what} replay traced")
        _print_device_profile(prof, dt, top=6)
    res = dict(ops_before=rep["ops_before"], ops_after=rep["ops_after"],
               reduction_pct=rep["reduction_pct"],
               removed={p["pass"]: p["removed"] for p in rep["passes"]},
               fusion_hints=len(opt.fusion_hints), claimed=chains,
               launches_before={k: v for k, v in moved_b.items() if v},
               launches_after={k: v for k, v in moved_a.items() if v},
               err_unoptimized_vs_eager=err_b,
               err_optimized_vs_unoptimized=err_a,
               err_optimized_vs_eager=err_e, control_err=ctrl,
               tol=PROGRAM_TOL, replay_ms_before=ms_b[1],
               replay_ms_after=ms_a[1],
               warm_step_delta_pct=100.0 * (ms_a[1] - ms_b[1]) / ms_b[1],
               replay_ms_quartiles_before=[ms_b[0], ms_b[2]],
               replay_ms_quartiles_after=[ms_a[0], ms_a[2]],
               optimized_faster_in=f"{wins} of {PROGRAM['pairs']} pairs")
    say(f"{tag} " + json.dumps(res))
    del prog, opt, fetches, tok
    gc.collect()
    torch.cuda.empty_cache()
    return res


def program_main_paths(llama):
    """Phase 16 on GPT-3 1.3B rebuilt from phase 4's seed and on phase
    10's llama2-7b."""
    t0 = time.perf_counter()
    b, s = PROGRAM["batch"], PROGRAM["prompt"]
    cfg = gpt_config("gpt3-1.3B", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    model = GPTForPretraining(cfg, seed=0)
    # the seed's LayerNorms are ones and zeros: draw them, so that a K6d
    # which drops the norm's bias (the control) changes the step
    g = torch.Generator(device="cuda").manual_seed(16)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, GPTLayerNorm):
                mod.weight.copy_(1 + 0.1 * torch.randn(
                    mod.weight.shape, generator=g, device="cuda"))
                mod.bias.copy_(0.1 * torch.randn(
                    mod.bias.shape, generator=g, device="cuda"))
    rs = np.random.RandomState(16)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s))).cuda()
    gpt = program_main_path(
        "gpt program", model, ids,
        {"layer_norm->linear": 2 * N_LAYERS, "layer_norm->matmul": 1},
        {"attn.qkv_proj.weight": N_LAYERS, "mlp.fc1.weight": N_LAYERS,
         "embeddings.word_embeddings.weight": 1},
        {"ln_fwd": 2 * N_LAYERS + 1, "flash_fwd": N_LAYERS},
        {"norm_matmul": 2 * N_LAYERS + 1, "flash_fwd": N_LAYERS},
        control=lambda real: (lambda x, nw, nb, w, bias=None, **kw:
                              real(x, nw, None, w, bias, **kw)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = llama["model"]
    layers = model.config.num_layers
    llama_res = program_main_path(
        "llama program", model, llama["ids"][:, :s].contiguous(),
        {"rms_norm->matmul": 1}, {"lm_head_weight": 1},
        {"rms_fwd": 2 * layers + 1, "flash_fwd": layers,
         "rope": 2 * layers},
        {"rms_fwd": 2 * layers, "norm_matmul": 1, "flash_fwd": layers,
         "rope": 2 * layers})
    say(f"phase 16: {time.perf_counter() - t0:.1f} s")
    return dict(gpt=gpt, llama=llama_res)


# ---------------------------------------------------------------------------
# kernel variants: python3 chip_smoke.py --ab A.cu B.cu ...
# ---------------------------------------------------------------------------

AB_K7_CASES = ("decode", "decode-2048", "mixed")
AB_K2_CASES = ("float32", "bfloat16", "bart", "decode")
# phase 9's and phase 15's main-path K6c / K6d cases
AB_K6A_CASES = ("llama", "gpt", "bf16")
AB_K6C_CASES = ("llama", "gpt")
AB_K6D_CASES = ("gpt_qkv", "gpt_fc1", "gpt_head", "llama_head")


@contextlib.contextmanager
def fd_variant(lib, route):
    """``fused_decode``'s wrappers on a variant's library, its K6a, K6c
    and K6d calls forced onto ``route`` (a library built from a source
    without a stream form has only the generic route)."""
    keep = (_build._libs.get("fused_decode"), fd.norm_matmul_route,
            fd.norm_mlp_route, fd.qkv_route, dict(fd._occupancy),
            dict(fd._plans))
    _build._libs["fused_decode"] = lib
    fd._occupancy.clear()
    fd._plans.clear()
    fd.norm_matmul_route = lambda *a: route
    fd.norm_mlp_route = lambda *a: route
    fd.qkv_route = lambda *a: int(route == "stream")
    try:
        yield
    finally:
        if keep[0] is None:
            _build._libs.pop("fused_decode", None)
        else:
            _build._libs["fused_decode"] = keep[0]
        fd.norm_matmul_route, fd.norm_mlp_route, fd.qkv_route = keep[1:4]
        fd._occupancy.clear()
        fd._occupancy.update(keep[4])
        fd._plans.clear()
        fd._plans.update(keep[5])


def ab_fused_decode(libs, turns, g):
    """K6a, K6c and K6d of each ``fd_*`` variant, on every route it has,
    at the main-path cases, the weights rotating over copies as in phases
    9 and 15; each variant's error from the plain version."""
    routes, qkv_routes = {}, {}
    for name, lib in libs.items():
        for route in ("stream", "generic"):
            if route == "generic" or hasattr(lib, "fd_norm_matmul_stream"):
                routes[f"{name}/{route}"] = (lib, route)
            if route == "generic" or hasattr(lib, "fd_rope_qkv_stream"):
                qkv_routes[f"{name}/{route}"] = (lib, route)

    def in_variant(key, fn, table=routes):
        lib, route = table[key]

        def run():
            with fd_variant(lib, route):
                return fn()
        return run
    for case in AB_K6A_CASES:
        x, packed, ws, bs, cos, sin, kw = k6a_case(case, g)
        h, nh, nkv = K6A_CASES[case][:3]
        copies = [packed] + [packed.clone() for _ in range(weight_copies(
            x.element_size() * h * packed.shape[1]) - 1)]
        ref = fd.rope_qkv_ref(x, *ws, *bs, cos, sin, **kw)
        fns, errs = {}, {}
        for key in qkv_routes:
            out = in_variant(key, lambda: fd.rope_qkv(x, *ws, *bs, cos, sin,
                                                      **kw), qkv_routes)()
            torch.cuda.synchronize()
            errs[key] = max(max_err(a, r) for a, r in zip(out, ref))
            it = itertools.cycle([functools.partial(
                fd.rope_qkv, x, *k6a_weights(case, c), *bs, cos, sin, **kw)
                for c in copies])
            fns[key] = in_variant(key, lambda it=it: next(it)(), qkv_routes)
        lib_fns = itertools.cycle([functools.partial(torch.matmul, x, c)
                                   for c in copies])
        fns["library"] = lambda: next(lib_fns)()
        say("AB K6a " + json.dumps(dict(case=case, ms=turns(fns),
                                        max_abs_err=errs)))
        del x, packed, ws, bs, copies, ref, fns
    for case in AB_K6C_CASES:
        kind, act, h, inter, dtype, b = K6C_CASES[case]
        ln_kind = kind == "layer_norm"
        x = rand((b, h), dtype, g, 2.0)
        n_up = 1 if ln_kind else 2
        base = dict(kind=kind, act=act, eps=1e-5,
                    norm_w=(1 + 0.1 * torch.randn(h, generator=g,
                                                  device="cuda")).to(dtype),
                    norm_b=rand((h,), dtype, g, 0.1) if ln_kind else None,
                    b1=rand((inter,), dtype, g, 0.1) if ln_kind else None,
                    b2=rand((h,), dtype, g, 0.1) if ln_kind else None)
        copies = [dict(base, w1=rand((h, inter), dtype, g, 0.02),
                       w2=rand((inter, h), dtype, g, 0.02),
                       w_gate=None if ln_kind
                       else rand((h, inter), dtype, g, 0.02))
                  for _ in range(weight_copies(
                      x.element_size() * h * inter * (n_up + 1)))]
        ref = fd.norm_mlp_ref(x, **copies[0])
        fns, errs = {}, {}
        for key in routes:
            out = in_variant(key, lambda: fd.norm_mlp(x, **copies[0]))()
            torch.cuda.synchronize()
            errs[key] = max_err(out, ref)
            calls = [functools.partial(fd.norm_mlp, x, **c) for c in copies]
            it = itertools.cycle(calls)
            fns[key] = in_variant(key, lambda it=it: next(it)())
        say("AB K6c " + json.dumps(dict(case=case, ms=turns(fns),
                                        max_abs_err=errs)))
        del x, copies, ref, fns
    for case in AB_K6D_CASES:
        kind, lead, h, n, transposed, bias, dtype = K6D_CASES[case]
        args = k6d_case(kind, lead, h, n, transposed, bias, dtype, g)
        x, nw, nb, w, b = args
        copies = [args] + [
            (x, nw, nb, w.t().clone().t() if transposed else w.clone(), b)
            for _ in range(weight_copies(x.element_size() * h * n) - 1)]
        kw = dict(kind=kind, eps=1e-5)
        ref = fd.norm_matmul_ref(*args, **kw)
        fns, errs = {}, {}
        for key in routes:
            out = in_variant(key, lambda: fd.norm_matmul(*args, **kw))()
            torch.cuda.synchronize()
            errs[key] = max_err(out, ref)
            it = itertools.cycle([functools.partial(fd.norm_matmul, *c, **kw)
                                  for c in copies])
            fns[key] = in_variant(key, lambda it=it: next(it)())
        lib_fns = itertools.cycle([k6d_library(kind, *c) for c in copies])
        fns["library"] = lambda: next(lib_fns)()
        say("AB K6d " + json.dumps(dict(case=case, ms=turns(fns),
                                        max_abs_err=errs)))
        del x, nw, nb, w, b, args, copies, ref, fns


def compare_variants(paths) -> int:
    """Time copies of ``csrc/flash_attention.cu`` (files named ``fa_*.cu``),
    ``csrc/ragged_paged_attention.cu`` (``rpa_*.cu``),
    ``csrc/layer_norm.cu`` (``ln_*.cu``) or ``csrc/fused_decode.cu``
    (``fd_*.cu``), each built with the port's nvcc flags into its own
    library, on the same inputs in turns (every variant, then again in
    reverse order): K1a's forward at the two training shapes, K7 at phase
    3's cases with the wrapper's page splits and twice as many, K2a and
    K2b at phase 5's GPT, bf16, BART and decode cases beside the
    library's call, K6a, K6c and K6d at phase 9's and phase 15's
    main-path cases on each route a variant has (``ab_fused_decode``).  One line per
    case: each variant's times and its max abs error from the plain
    version."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {Path(p).stem: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / (Path(p).stem + ".so")), p], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for p in paths}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {name}: {log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                say(f"ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(str(out_dir / (name + ".so")))
        {"fa": fa, "rpa": rpa, "ln": ln,
         "fd": fd}[name.split("_")[0]]._declare(lib)
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream

    def turns(fns):
        ms = {n: [] for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                ms[n].append(time_ms(fns[n], 20))
        return ms

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    fa_libs = {n: lib for n, lib in libs.items() if n.startswith("fa_")}
    for case in ("main", "llama") if fa_libs else ():
        bh, sq, sk, _, _, dtype, d = K1_CASES[case]
        q, k, v = (rand((bh, n, d), dtype, g) for n in (sq, sk, sk))
        ref = fa.reference_attention_bhsd(q, k, v, d ** -0.5, True)
        outs = {n: (torch.empty_like(q), torch.empty(bh, sq, device="cuda"))
                for n in fa_libs}
        fns = {n: functools.partial(
            lib.flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            outs[n][0].data_ptr(), outs[n][1].data_ptr(), bh, sq, sk, d, 1,
            1, 0, d ** -0.5, fa._DTYPE_CODE[dtype], stream)
            for n, lib in fa_libs.items()}
        errs = {}
        for n, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            errs[n] = max_err(outs[n][0], ref)
        say("AB K1a " + json.dumps(dict(case=case, ms=turns(fns),
                                        max_abs_err=errs)))
        del q, k, v, ref, outs
    rpa_libs = {n: lib for n, lib in libs.items() if n.startswith("rpa_")}
    for case in AB_K7_CASES if rpa_libs else ():
        spec = CASES[case]
        for heads, (nh, nkv) in HEADS.items():
            for dtype in (torch.float32, torch.bfloat16):
                args, clean = make_case(spec["kv_lens"], spec["q_lens"],
                                        spec["q_width"], nh, nkv, dtype, 7)
                q, kp, vp, kvl, ql, tables = args
                ref = rpa.ragged_paged_attention_ref(q, *clean, kvl, ql,
                                                     tables)
                b, qw, _, hd = q.shape
                ppseq = tables.shape[1]
                groups = -(-(nh // nkv * qw) // rpa._ROWS) * nkv
                base = rpa._splits(groups, b, ppseq, q.device)
                fns, errs, outs = {}, {}, {}
                for mult in (1, 2):
                    splits = min(base * mult, ppseq)
                    part, cnt = rpa._scratch(q.device, groups * b,
                                             max(splits, 2), hd)
                    for n, lib in rpa_libs.items():
                        key = f"{n}/splits={splits}"
                        outs[key] = out = torch.empty_like(q)
                        fns[key] = functools.partial(
                            lib.rpa_forward, *(t.data_ptr() for t in args),
                            out.data_ptr(), part.data_ptr(), cnt.data_ptr(),
                            b, qw, nh, nkv, kp.shape[1], kp.shape[2], hd,
                            ppseq, splits, hd ** -0.5, rpa._DTYPE_CODE[dtype],
                            rpa._DTYPE_CODE[dtype], stream)
                        fns[key]()
                        torch.cuda.synchronize()
                        errs[key] = max(max_err(out[i, :n], ref[i, :n])
                                        for i, n in enumerate(spec["q_lens"])
                                        if n)
                say("AB K7 " + json.dumps(dict(
                    case=case, heads=heads,
                    dtype=str(dtype).replace("torch.", ""), ms=turns(fns),
                    max_abs_err=errs)))
                del args, clean, ref, outs, fns
    ln_libs = {n: lib for n, lib in libs.items() if n.startswith("ln_")}
    for case in AB_K2_CASES if ln_libs else ():
        n, h, dtype, wdtype, kind = K2_CASES[case]
        x, w, b, gy = (t.detach() for t in k2_inputs(n, h, dtype, wdtype,
                                                      kind, g))
        xr = x.clone().requires_grad_()
        yr = ln.layer_norm_ref(xr, w, b, 1e-5)
        dxr, = torch.autograd.grad(yr, xr, gy)
        xf = x.float()
        mean = xf.mean(dim=-1)
        rstd = torch.rsqrt((xf - mean[:, None]).square().mean(dim=-1) + 1e-5)
        codes = (ln._DTYPE_CODE[dtype], ln._DTYPE_CODE[wdtype], stream)
        fwd, bwd, errs, outs = {}, {}, {}, {}
        for name, lib in ln_libs.items():
            # kept in `outs`: the launches below write through raw pointers
            outs[name] = y, dx, m_out, r_out = (
                torch.empty_like(x), torch.empty_like(x),
                torch.empty_like(mean), torch.empty_like(rstd))
            fwd[name] = functools.partial(
                lib.ln_forward, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                y.data_ptr(), m_out.data_ptr(), r_out.data_ptr(), n, h, 1e-5,
                *codes)
            bwd[name] = functools.partial(
                lib.ln_backward_dx, x.data_ptr(), w.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), gy.data_ptr(),
                dx.data_ptr(), n, h, *codes)
            if fwd[name]() or bwd[name]():
                fail(f"AB K2 {name}: launch failed")
            torch.cuda.synchronize()
            errs[name] = dict(y=max_err(y, yr), dx=max_err(dx, dxr))
        lw, lb = w.to(dtype), b.to(dtype)
        lib_y = F.layer_norm(xr, (h,), lw, lb, 1e-5)
        fwd["library"] = lambda: F.layer_norm(x, (h,), lw, lb, 1e-5)
        bwd["library"] = lambda: torch.autograd.grad(lib_y, xr, gy,
                                                     retain_graph=True)
        say("AB K2 " + json.dumps(dict(
            case=case, n=n, h=h, dtype=str(dtype).replace("torch.", ""),
            fwd_ms=turns(fwd), dx_ms=turns(bwd), max_abs_err=errs)))
        del x, w, b, gy, xr, yr, dxr, fwd, bwd, outs, lib_y
    fd_libs = {n: lib for n, lib in libs.items() if n.startswith("fd_")}
    if fd_libs:
        ab_fused_decode(fd_libs, turns, g)
    return 0


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --ab-paths A.cu: the decode paths on another source
# python3 chip_smoke.py --marks: K6a's time by phase
# ---------------------------------------------------------------------------

AB_PATH_PAIRS = 10


def build_variant(path, name):
    """``csrc/fused_decode.cu``'s copy at ``path`` built with the port's
    flags into its own library, its entry points declared."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out / f"{name}.so"), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        fail(f"nvcc {path}: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    fd._declare(lib)
    return lib


def compare_paths(path) -> int:
    """The compiled decode loops (phase 10's llama2-7b, phase 4b's GPT-3
    1.3B) with ``fused_decode``'s library built from ``path`` against this
    tree's, ``AB_PATH_PAIRS`` pairs of synchronized calls in turns: the
    tokens, each side's quartiles of seconds a call and the pairs this
    tree's side won, then each side's K6a kernels' device ms a call
    (profiler).  K6a takes only the generic route on a source without
    its stream form."""
    _build.build_all()
    other = build_variant(path, "paths_other")
    ours = _build.library("fused_decode")

    @contextlib.contextmanager
    def side(name):
        keep = fd.qkv_route
        fd._occupancy.clear()
        fd._plans.clear()
        if name == "other":
            _build._libs["fused_decode"] = other
            if not hasattr(other, "fd_rope_qkv_stream"):
                fd.qkv_route = lambda *a: 0
        try:
            yield
        finally:
            _build._libs["fused_decode"], fd.qkv_route = ours, keep
            fd._occupancy.clear()
            fd._plans.clear()

    for name, build, shape in (
            (DECODE_PRESET, lambda: LlamaForCausalLM(
                llama_config(DECODE_PRESET), seed=0), DECODE),
            ("gpt3-1.3B", lambda: GPTForPretraining(
                gpt_config("gpt3-1.3B"), seed=0), GPT_DECODE)):
        model = build()
        b, s, n = shape["batch"], shape["prompt"], shape["new"]
        ids = torch.from_numpy(np.random.RandomState(2).randint(
            0, model.config.vocab_size, (b, s))).cuda()
        toks, secs, k6a_ms, wins = {}, {"other": [], "ours": []}, {}, 0
        for v in ("other", "ours"):
            with side(v):
                toks[v] = decode_call(model, ids, n)[0]
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    decode_call(model, ids, n)
                k6a_ms[v] = sum(e.device_time_total for e in prof.key_averages()
                                if "gemv_kernel" in e.key or "qkv_" in e.key) / 1e3
        for i in range(AB_PATH_PAIRS):
            pair = {}
            for v in ("other", "ours") if i % 2 == 0 else ("ours", "other"):
                with side(v):
                    pair[v] = decode_call(model, ids, n)[1]
                secs[v].append(pair[v])
            wins += pair["ours"] < pair["other"]
        say("AB paths " + json.dumps(dict(
            model=name, tokens_equal=torch.equal(toks["other"], toks["ours"]),
            s_per_call_quartiles={v: np.percentile(x, [25, 50, 75]).tolist()
                                  for v, x in secs.items()},
            ours_faster_pairs=f"{wins} of {AB_PATH_PAIRS}",
            k6a_device_ms_per_call=k6a_ms, decode_steps=n - 1)))
        del model, ids
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def marked_source() -> str:
    """``csrc/fused_decode.cu`` with %globaltimer marks in K6a's stream
    kernel: per block its start, its window and first stages landed, its
    end; per warp the end of its stream; read back by ``fd_read_marks``."""
    src = (_build.CSRC_DIR / "fused_decode.cu").read_text()
    head, tail = src.split("qkv_stream_kernel(const __grid_constant__", 1)
    marks = ("__device__ unsigned long long qkv_marks[1024][3];\n"
             "__device__ unsigned long long qkv_warp_marks[1024][8];\n"
             "__device__ __forceinline__ unsigned long long gtime() {\n"
             "  unsigned long long t;\n"
             "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
             "  return t;\n}\n")
    cut = head.rindex("template <typename T>")
    head = head[:cut] + marks + head[cut:]
    for old, new in (
            ("  grid_dep_launch();", "  if (tid == 0) qkv_marks[j][0] = gtime();\n"
             "  grid_dep_launch();"),
            ("  cp_async_wait(0);\n  __syncthreads();\n",
             "  cp_async_wait(0);\n  __syncthreads();\n"
             "  if (tid == 0) qkv_marks[j][1] = gtime();\n"),
            ("  cp_async_wait(0);\n}", "  cp_async_wait(0);\n"
             "  if (lane == 0) qkv_warp_marks[j][warp] = gtime();\n"
             "  __syncthreads();\n  if (tid == 0) qkv_marks[j][2] = gtime();\n}")):
        if tail.count(old) != 1:
            fail(f"--marks: the K6a kernel no longer has {old!r}")
        tail = tail.replace(old, new, 1)
    return (head + "qkv_stream_kernel(const __grid_constant__" + tail +
            '\nextern "C" int fd_read_marks(void* blocks, void* warps) {\n'
            "  if (cudaMemcpyFromSymbol(blocks, qkv_marks, sizeof(qkv_marks)) != cudaSuccess)\n"
            "    return 1;\n"
            "  return static_cast<int>(cudaMemcpyFromSymbol(warps, qkv_warp_marks,\n"
            "                                                sizeof(qkv_warp_marks)));\n}\n")


def k6a_marks() -> int:
    """K6a's stream kernel by phase at phase 9's cases, in microseconds
    from the first block's start (quartiles over blocks): the window and
    first stages landed, each block's last warp done, the warps' spread
    within a block, each block's end; and the call's time with the
    marks in."""
    _build.build_all()
    path = _build.BUILD_DIR / "variants" / "fd_marks.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(marked_source())
    lib = build_variant(path, "fd_marks")
    lib.fd_read_marks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    q = lambda a: np.percentile(a / 1e3, [0, 25, 50, 75, 100]).round(2).tolist()
    for case in K6A_CASES:
        x, packed, ws, bs, cos, sin, kw = k6a_case(case, g)
        with fd_variant(lib, "stream"):
            call = functools.partial(fd.rope_qkv, x, *ws, *bs, cos, sin, **kw)
            ms = time_ms(call, 20)
            call()
            torch.cuda.synchronize()
            plan = next(iter(fd._plans.values()))
        blocks = np.zeros((1024, 3), np.uint64)
        warps = np.zeros((1024, 8), np.uint64)
        if lib.fd_read_marks(blocks.ctypes.data, warps.ctypes.data):
            fail("--marks: reading the marks failed")
        b = blocks[:plan.grid].astype(np.int64)
        w = warps[:plan.grid].astype(np.int64)
        t0 = b[:, 0].min()
        say("marks K6a " + json.dumps(dict(
            case=case, ms=ms, grid=plan.grid, units_a_block=plan.q,
            us_min_q1_median_q3_max=dict(
                first_stages_in=q(b[:, 1] - t0), last_warp_done=q(w.max(1) - t0),
                warp_spread=q(w.max(1) - w.min(1)), block_end=q(b[:, 2] - t0)))))
        del x, packed, ws
    return 0


# ---------------------------------------------------------------------------
# phase 17: data-parallel training on NCCL (DataParallel, ZeRO 2 and 3)
# ---------------------------------------------------------------------------

DIST_STEPS = 3                   # steps held against the oracle
DIST_TIMED = dict(warmup=1, timed=4)   # then these, timed
DIST_LAUNCH_S = 2400             # the launcher's limit (phases 17-21 on
#                                  four cards; the ranks' builds are cache
#                                  hits: it builds first)
DIST_KILL_S = 300                # each SIGKILL run's limit
DIST_COLL_N = 1 << 20            # elements per rank in the collective checks
DIST_SEED = 17
# a parameter's value after DIST_STEPS Adam steps, held element-wise: each
# step's update may differ by 2.1 lr where the gradient's sign is bf16
# noise (6b's rule), the median by lr / 100
DIST_PARAM_MAX = DIST_STEPS * 2.1e-4
DIST_PARAM_MEDIAN = DIST_STEPS * 1e-6


def dist_global_batch(cfg, world):
    """The global batch: ``world`` shards of phase 6's 4 x 2048 (at one
    rank, phase 6's batch itself), on the host."""
    rs = np.random.RandomState(0)
    n = world * TRAIN_BATCH
    return (torch.from_numpy(rs.randint(0, cfg.vocab_size, (n, TRAIN_SEQ))),
            torch.from_numpy(rs.randint(0, cfg.vocab_size, (n, TRAIN_SEQ))))


def dist_shard(batch, rank, dev):
    return tuple(t[rank * TRAIN_BATCH:(rank + 1) * TRAIN_BATCH].to(dev)
                 for t in batch)


def dist_collectives(dist, rank, world, dev):
    """Every collective on CUDA tensors against the values computed on the
    host from the seed: fp32 within 1e-5 + 1e-5 |x|; the bf16 sum within
    ``world`` bf16 roundings of the partial sums, 2^-8 sum_r |x_r| each
    (NCCL rounds every hop's partial sum to bf16).  Point-to-point ops
    need two ranks."""
    g = torch.Generator().manual_seed(DIST_SEED)
    xs = torch.randn(world, DIST_COLL_N, generator=g)
    chunks = [x.chunk(world) for x in xs]
    errs = {}

    def hold(name, got, want, bound=None):
        got = got.float().cpu()
        if bound is None:
            bound = 1e-5 + 1e-5 * want.abs()
        errs[name] = (got - want).abs().max().item()
        if not bool(((got - want).abs() <= bound).all()):
            fail(f"rank {rank}: {name} off by {errs[name]:.3e}")

    def mine():
        return xs[rank].to(dev, copy=True)

    for name, op, want in (("sum", dist.ReduceOp.SUM, xs.sum(0)),
                           ("max", dist.ReduceOp.MAX, xs.max(0).values),
                           ("min", dist.ReduceOp.MIN, xs.min(0).values),
                           ("avg", dist.ReduceOp.AVG, xs.mean(0)),
                           ("prod", dist.ReduceOp.PROD, xs.prod(0))):
        t = mine()
        dist.all_reduce(t, op=op)
        hold(f"all_reduce_{name}", t, want)
    t = mine().bfloat16()
    dist.all_reduce(t)
    xb = xs.bfloat16().float()
    hold("all_reduce_bf16", t, xb.sum(0),
         bound=world * 2.0 ** -8 * xb.abs().sum(0))
    t = mine()
    dist.all_reduce(t, sync_op=False).wait()
    hold("all_reduce_async", t, xs.sum(0))
    t = mine()
    dist.reduce(t, dst=0)
    hold("reduce", t, xs.sum(0))
    lst = []
    dist.all_gather(lst, mine())
    hold("all_gather", torch.cat(lst), xs.reshape(-1))
    t = mine()
    dist.broadcast(t, src=world - 1)
    hold("broadcast", t, xs[world - 1])
    t = torch.empty_like(chunks[0][0], device=dev)
    dist.scatter(t, [c.to(dev, copy=True) for c in chunks[0]], src=0)
    hold("scatter", t, chunks[0][rank])
    for name, op, want in (("sum", dist.ReduceOp.SUM, xs.sum(0)),
                           ("avg", dist.ReduceOp.AVG, xs.mean(0))):
        hold(f"reduce_scatter_{name}", dist.reduce_scatter(mine(), op=op),
             want.chunk(world)[rank])
    hold("alltoall_single", dist.alltoall_single(mine()),
         torch.cat([chunks[j][rank] for j in range(world)]))
    outs = []
    dist.alltoall(outs, [c.to(dev, copy=True) for c in chunks[rank]])
    hold("alltoall", torch.cat(outs),
         torch.cat([chunks[j][rank] for j in range(world)]))
    if world > 1:
        recv = torch.empty(DIST_COLL_N, device=dev)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, mine(), (rank + 1) % world),
            dist.P2POp(dist.irecv, recv, (rank - 1) % world)])
        for w in works:
            w.wait()
        hold("batch_isend_irecv", recv, xs[(rank - 1) % world])
    dist.barrier()
    objs = []
    dist.all_gather_object(objs, rank)
    if objs != list(range(world)):
        fail(f"rank {rank}: all_gather_object gave {objs}")
    return errs


def host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` (a copy even when ``t`` is on the host)."""
    return t.detach().to("cpu", copy=True)


def stage3_of(model):
    """The model's stage-3 reducer, or None."""
    red = getattr(model, "_reducer", None)
    return red if red is not None and red.mode == "stage3" else None


def dist_values(model, opt, sharded, rank=0):
    """Every parameter's fp32 value on the host, on rank 0 (None on the
    others): its master where it has one (under ZeRO gathered from the
    shards one bucket or segment flat at a time, a collective call),
    else the parameter (under stage 3 gathered too)."""
    inner = getattr(model, "_layers", model)
    if not sharded:
        if rank != 0:
            return None
        return {n: host(opt.state[p].get("master", p).float())
                for n, p in inner.named_parameters()}
    stage3 = stage3_of(model) is not None
    vals = {}
    for k, b in enumerate(opt._reducer.buckets):
        master = opt._state.get(k, {}).get("master")
        if master is not None:
            full = opt._gather(master, b.numel)
        elif stage3:
            full = opt._gather(b.param_shard, b.numel)
        else:
            full = None
        shapes = b.shapes if stage3 else [p.shape for p in b.params]
        if rank == 0:
            for p, off, shape in zip(b.params, b.offsets, shapes):
                src = p if full is None else full[off:off + shape.numel()]
                vals[id(p)] = host(src.float().reshape(shape))
        del full
    if rank != 0:
        return None
    return {n: vals[id(p)] for n, p in inner.named_parameters()}


def dist_params(model, rank=0):
    """Every parameter (its own dtype) on the host, on rank 0; under stage
    3 each segment is gathered and freed in turn (a collective call)."""
    inner = getattr(model, "_layers", model)
    red = stage3_of(model)
    if red is None:
        return {n: host(p) for n, p in inner.named_parameters()} \
            if rank == 0 else None
    vals = {}
    for seg in red.segments:
        red.gather(seg)
        if rank == 0:
            vals.update((id(p), host(p)) for f in seg.flats
                        for p in f.params)
        red.free(seg)
    return {n: vals[id(p)] for n, p in inner.named_parameters()} \
        if rank == 0 else None


def dist_grads(model, opt, rank=0):
    """The averaged gradients after a backward, on rank 0: each
    parameter's ``grad`` (DataParallel, one card), or under stage 3 each
    flat's ``shard_grad`` gathered (a collective call)."""
    inner = getattr(model, "_layers", model)
    red = stage3_of(model)
    if red is None:
        return {n: host(p.grad) for n, p in inner.named_parameters()} \
            if rank == 0 else None
    vals = {}
    for b in red.buckets:
        full = opt._gather(b.shard_grad, b.numel)
        if rank == 0:
            for p, off, shape in zip(b.params, b.offsets, b.shapes):
                vals[id(p)] = host(full[off:off + shape.numel()]
                                   .reshape(shape))
        del full
    return {n: vals[id(p)] for n, p in inner.named_parameters()} \
        if rank == 0 else None


def dist_oracle(model, opt, step, shards, timed=True):
    """Rank 0's oracle on one card: the global batch, ``len(shards)``
    micro-batches accumulated per step (each loss over their count), then
    one plain AdamW step; at one shard the ``train_step`` itself.
    Returns the losses, the first step's gradients and the values after
    ``DIST_STEPS`` steps on the host, and (``timed``) one card's plain
    step ms at one shard (timed after)."""
    world = len(shards)
    grads, losses = {}, []
    for s in range(DIST_STEPS):
        if world == 1:
            hooks = []
            if s == 0:
                grads, hooks = snapshot_grads(model)
            losses.append(float(step(*shards[0])))
            for h in hooks:
                h.remove()
            continue
        total = 0.0
        for j in range(world):
            loss = o2_step_fn(model, *shards[j])
            (loss / world).backward()
            total += float(loss.detach()) / world
        if s == 0:
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(total)
    grads = {n: host(g) for n, g in grads.items()}
    values = dist_values(model, opt, False)
    params = {n: host(p) for n, p in model.named_parameters()}
    one_card_ms = None
    if timed:
        step_s = []
        for i in range(sum(DIST_TIMED.values())):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*shards[0])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        one_card_ms = 1e3 * float(np.mean(step_s[DIST_TIMED["warmup"]:]))
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, grads=grads, values=values, params=params,
                one_card_ms=one_card_ms)


def dist_identical(dist, reducer):
    """True when every rank's parameters equal rank 0's bit for bit
    (under stage 3: the gathered flats)."""
    same = True
    stage3 = reducer.mode == "stage3"
    for b in reducer.buckets:
        if stage3:
            full = torch.empty(b.numel, dtype=b.dtype, device=b.device)
            all_gather_single(full, b.param_shard,
                              group=reducer.group.process_group)
        else:
            full = b.param_buf
        ref = full.clone()
        dist.broadcast(ref, src=0)
        same = same and bool(torch.equal(ref, full))
        del full, ref
    flag = torch.tensor([1 if same else 0], device=b.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def stage3_collectives(reducer):
    """A stage-3 step's all-gathers and reduce-scatters: the root's flats
    gathered once, each layer's twice (forward and backward; recompute's
    second forward finds the layer gathered), every flat reduce-scattered
    once."""
    layer = sum(len(s.flats) for s in reducer.segments
                if s.module is not None)
    return (len(reducer.buckets) - layer + 2 * layer, len(reducer.buckets))


def dist_comm_ms(dist, reducer, mode):
    """One step's collectives timed alone (CUDA events): the all-reduce of
    every bucket, stage 2's reduce-scatter and all-gather, or stage 3's
    gathers of each segment flat (the root once, a layer twice) and its
    reduce-scatter."""
    pg = reducer.group.process_group
    tdist = torch.distributed

    def run():
        if mode == "p_g_os":
            for seg in reducer.segments:
                for f in seg.flats:
                    full = torch.empty(f.numel, dtype=f.dtype,
                                       device=f.device)
                    for _ in range(1 if seg.module is None else 2):
                        all_gather_single(full, f.param_shard, group=pg)
                    reduce_scatter_single(f.shard_grad, full,
                                          op=tdist.ReduceOp.AVG, group=pg)
            return
        for b in reducer.buckets:
            if mode == "dp":
                tdist.all_reduce(b.grad_buf, op=tdist.ReduceOp.AVG, group=pg)
            else:
                reduce_scatter_single(b.shard_grad, b.grad_buf,
                                      op=tdist.ReduceOp.AVG, group=pg)
                n = b.shard_grad.numel()
                r = reducer.group.rank
                all_gather_single(b.param_buf,
                                  b.param_buf[r * n:(r + 1) * n], group=pg)
    return time_ms(run, 3)


def dist_settle(dist):
    """Free what an earlier run left on the card (its cycles, the
    allocator's cached blocks), every rank together, so a run's memory
    readings start from nothing."""
    gc.collect()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.empty_cache()


def build_gpt_o2(cfg):
    model = GPTForPretraining(cfg, seed=0)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    return amp.decorate(models=model, optimizers=opt, level="O2",
                        dtype="bfloat16")


def gpt_per_step(mode, reducer):
    """Phase 6's launches a step; K3 once a parameter, once a bucket
    shard under ZeRO 2, once a segment flat's shard under ZeRO 3."""
    return dict(PER_STEP, adamw=(PER_STEP["adamw"] if mode == "dp"
                                 else len(reducer.buckets)))


def dist_run(mode, dist, build, local, per_step, rank, world, dev,
             grads=False, timed=True, keep_params=True, wrap=None):
    """``build()``'s O2 model and optimizer on every rank under ``mode``
    (``"plain"``: unwrapped, ``"dp"``: DataParallel, ``"os_g"`` /
    ``"p_g_os"``: ZeRO stage 2 / 3): ``DIST_STEPS`` steps held (the
    first one written out with ``grads``, to read the averaged gradients
    before the optimizer step), then (``timed``) ``DIST_TIMED`` more,
    timed; the launches a step (``per_step(mode, reducer)``) and under
    stage 3 the collectives a step exact on every rank, and the
    parameters bit-identical across ranks after each held step.
    ``wrap(model, opt)``, when given, wraps in ``mode``'s place."""
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    dist_settle(dist)
    torch.cuda.reset_peak_memory_stats()
    # what is still allocated before the run, read beside the peak
    base = torch.cuda.memory_allocated()
    model, opt = build()
    if wrap is not None:
        model, opt = wrap(model, opt)
    elif mode == "dp":
        model = dist.DataParallel(model)
    elif mode != "plain":
        model, opt, _ = group_sharded_parallel(model, opt, level=mode)
    reducer = getattr(model, "_reducer", None)
    step = train_step(model, None, opt, step_fn=o2_step_fn)
    want = per_step(mode, reducer)
    coll = stage3_collectives(reducer) if mode == "p_g_os" else None
    out = dict(buckets=len(reducer.buckets) if reducer else 0, losses=[],
               step_s=[], collectives=coll)
    reset_counts()                   # count the main path's launches only
    n_total = DIST_STEPS + (sum(DIST_TIMED.values()) if timed else 0)
    for s in range(n_total):
        before = counts()
        c0 = (reducer.gathers, reducer.reduce_scatters) if coll else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if s == 0 and grads:
            loss = o2_step_fn(model, *local)
            loss.backward()
            g = dist_grads(model, opt, rank)
            if rank == 0:
                out["grads"] = g
            opt.step()
            opt.clear_grad()
            loss = loss.detach()
        else:
            loss = step(*local)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        after = counts()
        moved = {k: after[k] - before[k] for k in want}
        if moved != want:
            fail(f"rank {rank} {mode} step {s}: launches {moved} != {want}")
        if coll:
            got = (reducer.gathers - c0[0], reducer.reduce_scatters - c0[1])
            if got != coll:
                fail(f"rank {rank} {mode} step {s}: gathers and "
                     f"reduce-scatters {got} != {coll}")
        loss = loss.float()          # the global mean, in fp32
        dist.all_reduce(loss, op=dist.ReduceOp.AVG)
        out["losses"].append(float(loss))
        if s < DIST_STEPS and reducer is not None and \
                not dist_identical(dist, reducer):
            fail(f"{mode} step {s}: the ranks' parameters differ")
        if s == DIST_STEPS - 1:
            # the training steps' peak, before the host copies (the
            # sharded masters' gathers free buffers NCCL has used, which
            # stay allocated until their stream events are processed)
            peak = torch.cuda.max_memory_allocated()
            values = dist_values(model, opt, mode in ("os_g", "p_g_os"),
                                 rank)
            params = dist_params(model, rank) if keep_params else None
            if rank == 0:
                out["values"] = values
                if keep_params:
                    out["params"] = params
            del values, params
            torch.cuda.empty_cache()     # processes those events
            torch.cuda.reset_peak_memory_stats()
    out["launches"] = counts()
    mem = torch.tensor([max(peak, torch.cuda.max_memory_allocated()),
                        base], device=dev)
    dist.all_reduce(mem, op=dist.ReduceOp.MAX)
    out["peak_bytes"], out["base_bytes"] = (int(v) for v in mem.tolist())
    out["comm_ms"] = dist_comm_ms(dist, reducer, mode) if reducer else None
    if timed:
        t = out["step_s"][DIST_STEPS + DIST_TIMED["warmup"]:]
        out["step_ms"] = 1e3 * float(np.mean(t))
        out["tokens_s"] = world * local[0].numel() / float(np.mean(t))
    del model, opt, step, reducer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_compare(tag, got, want, exact, median_tol=DIST_PARAM_MEDIAN,
                 check=True, grad_tol=GRAD_REL_TOL):
    """``got``'s losses and values against ``want``'s: bit-equal when
    ``exact``, else within phase 6b/8b's tolerances (losses 0.0625; each
    value after DIST_STEPS steps within DIST_PARAM_MAX, each tensor's
    median within ``median_tol``); the first step's gradients by
    relative norm (``grad_tol``; None: measured) where both sides have
    them.  Without ``check`` the distances are only measured (a
    control)."""
    real_fail = fail if check else (lambda msg: None)
    lg, lw = got["losses"][:DIST_STEPS], want["losses"][:DIST_STEPS]
    say(f"distributed: {tag}: losses {lg} against {lw}")
    if exact:
        if lg != lw:
            fail(f"{tag}: losses {lg} != {lw}")
        for key in ("values", "params", "grads"):
            for n, w in want.get(key, {}).items():
                if key in got and not torch.equal(got[key][n], w):
                    fail(f"{tag}: {key} {n} differs")
        what = "losses, parameters, fp32 values" + (
            " and first gradients" if "grads" in got else "")
        say(f"distributed: {tag}: {what} bit-equal")
        return dict(bit_equal=what)
    worst = max(abs(a - b) for a, b in zip(lg, lw))
    if not worst <= XCHECK_LOSS_TOL:
        real_fail(f"{tag}: losses differ by {worst}")
    res = dict(loss_diff=worst)
    if "grads" in got and "grads" in want:
        rels = {n: ((got["grads"][n].float() - w.float()).norm()
                    / w.float().norm()).item()
                for n, w in want["grads"].items()}
        n = max(rels, key=rels.get)
        res["grad_rel"] = rels[n]
        say(f"distributed: {tag}: first gradients' relative error worst "
            f"{rels[n]:.3e} ({n}), median "
            f"{float(np.median(list(rels.values()))):.3e} "
            + (f"(tol {grad_tol:.3e})" if grad_tol is not None
               else "(measured)"))
        if grad_tol is not None and not rels[n] <= grad_tol:
            real_fail(f"{tag}: gradient of {n}: relative error {rels[n]:.3e}")
    maxes, medians = {}, {}
    for n, w in want["values"].items():      # on the card: 27 GB at 32 layers
        d = (got["values"][n].cuda() - w.cuda()).abs()
        maxes[n], medians[n] = d.max().item(), d.median().item()
        del d
    mx, med = max(maxes.values()), max(medians.values())
    res.update(value_max=mx, value_median=med)
    by_med = sorted(medians, key=medians.get, reverse=True)
    over = sum(v > median_tol for v in medians.values())
    say(f"distributed: {tag}: values after {DIST_STEPS} steps: worst max "
        f"diff {mx:.3e} ({max(maxes, key=maxes.get)}; tol "
        f"{DIST_PARAM_MAX:.2e}), worst median {med:.3e} (tol "
        f"{median_tol:.3e}; {over} of {len(medians)} tensors over "
        f"it; the largest: "
        + ", ".join(f"{n} {medians[n]:.3e}" for n in by_med[:4]) + ")")
    if not (mx <= DIST_PARAM_MAX and med <= median_tol):
        real_fail(f"{tag}: values differ")
    return res


def dist_sanitizer(dist, world, dev):
    """Under ``collective@2=truncate`` the sanitizer must raise on every
    rank at the second all-reduce, before it launches, instead of
    hanging; the group stays usable.  One rank has nobody to disagree
    with."""
    from paddle_tpu_torch.distributed.communication import sanitizer
    if world == 1:
        return "one rank: nothing to disagree with"
    set_flags({"collective_sanitizer": True,
               "fault_schedule": "collective@2=truncate"})
    sanitizer.reset_sanitizer()
    t0 = time.perf_counter()
    raised = None
    try:
        dist.all_reduce(torch.ones(1024, device=dev))
        dist.all_reduce(torch.ones(1024, device=dev))
    except sanitizer.CollectiveMismatchError as e:
        raised = [e.seq, e.rank_a, e.rank_b]
    finally:
        set_flags({"fault_schedule": "", "collective_sanitizer": False})
        sanitizer.reset_sanitizer()
    secs = time.perf_counter() - t0
    if raised != [1, 0, world - 1]:
        fail(f"the sanitizer did not raise at the damaged call: {raised}")
    t = torch.ones(4, device=dev)
    dist.all_reduce(t)
    if t.tolist() != [float(world)] * 4:
        fail("the group is not usable after the sanitizer's raise")
    return f"raised at call #1 (rank 0 vs rank {world - 1}) in {secs:.3f} s"


# ---------------------------------------------------------------------------
# phase 18: LLaMA-2 7B O2 under ZeRO stage 3 with recompute
# ---------------------------------------------------------------------------

ZERO3_DEPTH = 2                  # the four-card check against the oracle
ZERO3_CONTROL_MB = 1024          # above any segment flat (root: 0.52 GB)
# stage 3's median distance from stage 2 at 32 layers may exceed the
# layout control's (two stage-2 layouts, same call) by this factor: on
# four H100s three layouts' pairwise medians spread by 1.1 %
ZERO3_FLOOR_MARGIN = 1.1


def zero3_layers(world) -> int:
    """Phase 8's 8 layers on one card (the O2 state of 32 is 107.8 GB),
    all 32 across several."""
    return LLAMA_LAYERS if world == 1 else \
        llama_config(LLAMA_PRESET).num_layers


def zero3_global_batch(world):
    """``world`` shards of phase 8's 2 x 4096 (at one rank phase 8's batch
    itself), on the host."""
    rs = np.random.RandomState(0)
    n = world * LLAMA_BATCH
    vocab = llama_config(LLAMA_PRESET).vocab_size
    return (torch.from_numpy(rs.randint(0, vocab, (n, LLAMA_SEQ))),
            torch.from_numpy(rs.randint(0, vocab, (n, LLAMA_SEQ))))


def zero3_shard(batch, rank, dev):
    return tuple(t[rank * LLAMA_BATCH:(rank + 1) * LLAMA_BATCH].to(dev)
                 for t in batch)


def zero3_trainer(layers, recompute):
    """Phase 8's O2 trainer at ``layers`` (AdamW 1e-4, wd 0.01, fp32
    masters), ``use_recompute`` as asked."""
    def build():
        cfg = llama_config(LLAMA_PRESET, num_layers=layers,
                           use_recompute=recompute)
        model = LlamaForCausalLM(cfg, seed=0)
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters(),
                              weight_decay=0.01, multi_precision=True)
        return amp.decorate(models=model, optimizers=opt, level="O2",
                            dtype="bfloat16")
    return build


def zero3_per_step(layers, recompute):
    return lambda mode, reducer: llama_per_step(
        layers, recompute,
        None if mode in ("plain", "dp") else len(reducer.buckets))


def zero3_summary(run, layers, world):
    """A run's numbers without its tensors, with MFU (6 N tokens a step
    a card over 989 TFLOP/s; recompute's second forward not counted)."""
    out = {k: v for k, v in run.items()
           if k not in ("values", "params", "grads")}
    n = llama_param_count(llama_config(LLAMA_PRESET, num_layers=layers))
    out["n_params"], out["layers"] = n, layers
    if "step_ms" in run:
        per_card = run["tokens_s"] / world
        out["tokens_s_card"] = per_card
        out["mfu"] = 6 * n * per_card / PEAK_BF16
    return out


def zero3_rank(dist, rank, world, dev):
    """Phase 18 on this rank.  One card: the plain O2 ``train_step``,
    recompute alone and ``p_g_os`` + recompute at phase 8's depth, both
    held bit-equal to the plain step.  Several: ``p_g_os`` + recompute at
    depth 2 against rank 0's one-card oracle (the global batch as
    accumulated micro-batches), then at all 32 layers against ``os_g`` +
    recompute.  Returns rank 0's comparisons and every run's numbers."""
    res = {}
    batch = zero3_global_batch(world)
    local = zero3_shard(batch, rank, dev)
    if world == 1:
        layers = zero3_layers(world)
        plain = dist_run("plain", dist, zero3_trainer(layers, False), local,
                         zero3_per_step(layers, False), rank, world, dev,
                         grads=True, timed=False)
        rc = dist_run("plain", dist, zero3_trainer(layers, True), local,
                      zero3_per_step(layers, True), rank, world, dev,
                      grads=True, timed=False)
        res["recompute_vs_plain"] = dist_compare(
            "phase 18: recompute vs the plain step", rc, plain, exact=True)
        res["plain"] = zero3_summary(plain, layers, world)
        res["recompute"] = zero3_summary(rc, layers, world)
        del rc
        z3 = dist_run("p_g_os", dist, zero3_trainer(layers, True), local,
                      zero3_per_step(layers, True), rank, world, dev,
                      grads=True)
        res["p_g_os_vs_plain"] = dist_compare(
            "phase 18: p_g_os + recompute vs the plain step", z3, plain,
            exact=True)
        res["p_g_os"] = zero3_summary(z3, layers, world)
        return res
    oracle = None
    if rank == 0:
        model, opt = zero3_trainer(ZERO3_DEPTH, False)()
        step = train_step(model, None, opt, step_fn=o2_step_fn)
        oracle = dist_oracle(model, opt, step,
                             [zero3_shard(batch, j, dev)
                              for j in range(world)], timed=False)
        del model, opt, step
    dist.barrier()
    z3d = dist_run("p_g_os", dist, zero3_trainer(ZERO3_DEPTH, True), local,
                   zero3_per_step(ZERO3_DEPTH, True), rank, world, dev,
                   grads=True, timed=False)
    if rank == 0:
        res["depth2_vs_oracle"] = dist_compare(
            f"phase 18: p_g_os + recompute at depth {ZERO3_DEPTH} vs the "
            "oracle", z3d, oracle, exact=False)
        res["oracle_losses"] = oracle["losses"]
    res["depth2"] = zero3_summary(z3d, ZERO3_DEPTH, world)
    del oracle, z3d
    layers = zero3_layers(world)
    runs = {}
    for mode in ("os_g", "p_g_os"):
        runs[mode] = dist_run(mode, dist, zero3_trainer(layers, True), local,
                              zero3_per_step(layers, True), rank, world,
                              dev, keep_params=False)
        res[mode] = zero3_summary(runs[mode], layers, world)
    # the layout control: stage 2 again, its buckets cut as stage 3's
    # flats are (one a segment and dtype), so its gradients' reduce-
    # scatters have stage 3's message sizes, not os_g's 25 MB
    runs["os_g_seg"] = dist_run("os_g", dist, zero3_trainer(layers, True),
                                local, zero3_per_step(layers, True), rank,
                                world, dev, timed=False, keep_params=False,
                                wrap=functools.partial(stage2_by_segment,
                                                       dist))
    if rank == 0:
        for key in ("os_g", "p_g_os"):
            say(zero3_line(key, res[key], world))
    dist.barrier()
    if rank == 0:
        # the values' noise floor between two correct stage-2 layouts:
        # the fixed batch is memorised (the losses fall ~10x a step), so
        # the last step's gradients sit near their bf16 rounding, which
        # the reduce-scatters' sizes and element order change (on four
        # H100s 3.897e-6 at the median between these two, above
        # DIST_PARAM_MEDIAN); stage 3 is held to that floor
        res["os_g_seg_vs_os_g"] = control = dist_compare(
            f"phase 18: os_g over stage 3's segment flats vs os_g at "
            f"{layers} layers (the layout control, measured)",
            runs["os_g_seg"], runs["os_g"], exact=False, check=False)
        res["p_g_os_vs_os_g_seg"] = dist_compare(
            f"phase 18: p_g_os vs os_g over stage 3's segment flats at "
            f"{layers} layers (measured)", runs["p_g_os"], runs["os_g_seg"],
            exact=False, check=False)
        res["p_g_os_vs_os_g"] = dist_compare(
            f"phase 18: p_g_os vs os_g at {layers} layers, recompute",
            runs["p_g_os"], runs["os_g"], exact=False,
            median_tol=max(DIST_PARAM_MEDIAN,
                           ZERO3_FLOOR_MARGIN * control["value_median"]))
    return res


def stage2_by_segment(dist, model, opt):
    """ZeRO stage 2 as ``GroupShardedStage2`` builds it, but with a bucket
    for each stage-3 segment and dtype (a layer of the ``ModuleList``, or
    the root), however large (the group-sharded API keeps DataParallel's
    25 MB buckets)."""
    from paddle_tpu_torch.distributed.fleet import DygraphShardingOptimizer
    segment = {}
    for m in model.modules():
        if isinstance(m, torch.nn.ModuleList):
            for i, layer in enumerate(m):
                segment.update((id(p), i) for p in layer.parameters())
    model = dist.DataParallel(model, comm_buffer_size=ZERO3_CONTROL_MB,
                              last_comm_buffer_size=ZERO3_CONTROL_MB)
    model._reducer.split_by(lambda p: segment.get(id(p), -1))
    model._reducer.set_mode("reduce_scatter")
    return model, DygraphShardingOptimizer.over(opt, model._group)



# ---------------------------------------------------------------------------
# phases 19 and 20: tensor, sequence and context parallelism
# ---------------------------------------------------------------------------

TP_DEPTH = 2                     # the runs held against one card's oracle
# phase 19's GPT-3 1.3B layouts: (hybrid degrees, sequence_parallel)
TP_GPT_RUNS = {"mp4": (dict(mp_degree=4), False),
               "mp4_sp": (dict(mp_degree=4), True),
               "dp2_mp2": (dict(dp_degree=2, mp_degree=2), False)}
# phase 20's sequence sharding of LLaMA-2 7B at phase 8's depth
SEQ_RUNS = {"cp4": dict(cp_degree=4), "sep4": dict(sep_degree=4)}
SEQ_RUNS_RING = 4                # cp 4's chunks, for the one-card control
# The ring's chunked bf16 attention against K1's fp32 kernels must be as
# near as one K1 call over the whole sequence is, within this factor: at
# the attention (check_ring_schedule: both read 2.427e-3 for dq, the
# same to 4 digits, on the H100) and in phase 20's one-card step at 8
# layers, whose first gradients sit 4.59e-2 (plain) and 4.56e-2 (ring)
# from the same step with fp32 attention, and 2.47e-2 from each other:
# two sound bf16 attention layouts, each about as far from the fp32
# witness, whose rounding the depth amplifies (PERF.md, phase 20)
RING_WITNESS_MARGIN = 1.1
# the one-card ring schedule: cp 4's ranks in turn at llama2-7b's
# attention shape (batch 2 x 32 heads, seq 4096, head_dim 128, bf16)
RING = dict(batch=2, heads=32, seq=4096, head_dim=128, ranks=4)


def fleet_init(degrees):
    """``fleet.init`` at ``degrees`` (the others 1) in the running group:
    the topology every model built next is split by."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def fleet_reset():
    from paddle_tpu_torch.distributed.fleet.base.topology import _clear_hcg
    _clear_hcg()


def tp_gpt_trainer(layers, sp):
    """Phase 17's GPT-3 1.3B O2 trainer at ``layers``, SP as asked; built
    under the live topology."""
    def build():
        cfg = gpt_config("gpt3-1.3B", num_layers=layers,
                         max_position_embeddings=TRAIN_SEQ,
                         hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                         sequence_parallel=sp)
        return build_gpt_o2(cfg)
    return build


def tp_llama_trainer(layers, sp):
    """Phase 8's LLaMA-2 7B O2 trainer at ``layers``, SP as asked."""
    def build():
        cfg = llama_config(LLAMA_PRESET, num_layers=layers,
                           sequence_parallel=sp)
        model = LlamaForCausalLM(cfg, seed=0)
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters(),
                              weight_decay=0.01, multi_precision=True)
        return amp.decorate(models=model, optimizers=opt, level="O2",
                            dtype="bfloat16")
    return build


def gpt_tp_per_step(layers):
    """GPT's launches a step at ``layers``, the same on every mp rank:
    K1 once a layer, K2 twice a layer and the final norm, K3 once a
    parameter (12 a layer, both embeddings, the final norm)."""
    return dict(PER_STEP, flash_fwd=layers, flash_bwd_dq=layers,
                flash_bwd_dkv=layers, ln_fwd=2 * layers + 1,
                ln_bwd_dx=2 * layers + 1, adamw=12 * layers + 4)


def cp_per_step(layers, cp_rank):
    """LLaMA's launches a step on cp rank ``r``: the causal ring runs
    ``r + 1`` of each K1 kernel a layer (its own chunk and the earlier
    ones; the later ones are masked and launch nothing)."""
    n = (cp_rank + 1) * layers
    return dict(llama_per_step(layers), flash_fwd=n, flash_bwd_dq=n,
                flash_bwd_dkv=n)


def tp_full(inner, value, rank):
    """Every parameter's full tensor (``value(p)``: the parameter, its fp32
    master or its gradient) on rank 0's host, split ones gathered over the
    mp group (a collective call)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_layers
    vals = {}
    for n, p in inner.named_parameters():
        full = mp_layers.gather_parameter(value(p), p)
        if rank == 0:
            vals[n] = host(full)
        del full
    return vals if rank == 0 else None


def tp_comm_ms(hcg, sp, layers, tokens, hidden):
    """One step's mp collectives timed alone (CUDA events) on
    ``tokens x hidden`` activations, each at the dtype the path moves
    (``mp_layers``): the sums in fp32 (a row-parallel output, a
    column-parallel input gradient), the gathers in bf16.  A layer's four
    bf16 all-gathers and four fp32 reduce-scatters under SP (forward and
    backward), else its four fp32 all-reduces; the embedding's bf16
    all-reduce; the head's bf16 gather and fp32 reduce-scatter (SP) or
    fp32 all-reduce.  The cross entropy's per-token sums are left out."""
    g = hcg.get_model_parallel_group()
    pg, n = g.process_group, g.nranks
    tdist = torch.distributed
    dev = torch.cuda.current_device()
    full16 = torch.zeros(tokens * hidden, dtype=torch.bfloat16, device=dev)
    chunk16 = torch.zeros(full16.numel() // n, dtype=full16.dtype,
                          device=dev)
    full32 = torch.zeros(full16.numel(), dtype=torch.float32, device=dev)
    chunk32 = torch.zeros(chunk16.numel(), dtype=full32.dtype, device=dev)

    def sums():
        if sp:
            all_gather_single(full16, chunk16, group=pg)
            reduce_scatter_single(chunk32, full32, group=pg)
        else:
            tdist.all_reduce(full32, group=pg)

    def run():
        for _ in range(layers):
            for _ in range(4):
                sums()
        tdist.all_reduce(full16, group=pg)
        sums()
    return time_ms(run, 3)


def tp_run(tag, dist, degrees, build, batch, per_step, rank, world, dev,
           grads=False, timed=True, values="full", wrap=None, comm=None):
    """``build()``'s O2 model and optimizer under ``fleet.init(degrees)``,
    wrapped by ``fleet.distributed_model`` (``TensorParallel``; ``wrap``
    in its place when given) and ``fleet.distributed_optimizer``, trained
    through ``TrainStep(mesh=...)`` on the global ``batch`` (host
    tensors): ``DIST_STEPS`` held steps (the first written out with
    ``grads``, to read the reduced gradients before the update), then
    (``timed``) ``DIST_TIMED`` more.  Every step's launches equal
    ``per_step(hcg)`` on every rank.  ``values="full"``: rank 0 keeps
    every parameter's fp32 value and the parameters, gathered over mp;
    ``"shard"``: every rank keeps its own shards' fp32 values.  ``comm``
    ``(sp, layers, tokens, hidden)`` times the mp collectives alone."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        segment_parallel as seg)
    dist_settle(dist)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hcg = fleet_init(degrees)
    model, opt = build()
    model = wrap(model, hcg) if wrap is not None \
        else fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    inner = getattr(model, "_layers", model)
    step = train_step(model, None, opt, mesh=hcg.mesh, step_fn=o2_step_fn)
    want = per_step(hcg)
    out = dict(tag=tag, degrees=degrees, losses=[], step_s=[])
    local = [step._data.rows(t.to(dev)) for t in batch]
    reset_counts()                   # count the main path's launches only
    routes = dict(seg.launches)
    n_total = DIST_STEPS + (sum(DIST_TIMED.values()) if timed else 0)
    peak = 0
    for s in range(n_total):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if s == 0 and grads:
            loss = o2_step_fn(model, *local)
            loss.backward()
            opt._reduce_gradients()
            g = tp_full(inner, lambda p: p.grad, rank)
            if rank == 0:
                out["grads"] = g
            del g
            opt._stepper().step()
            opt.clear_grad()
            loss = step._data.mean(loss.detach())
        else:
            loss = step(*batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        after = counts()
        moved = {k: after[k] - before[k] for k in want}
        if moved != want:
            fail(f"rank {rank} {tag} step {s}: launches {moved} != {want}")
        out["losses"].append(float(loss.float()))
        if s == DIST_STEPS - 1:
            peak = torch.cuda.max_memory_allocated()
            def master(p):
                return opt.state[p].get("master", p).float()
            if values == "full":
                v = tp_full(inner, master, rank)
                prm = tp_full(inner, lambda p: p.detach(), rank)
                if rank == 0:
                    out["values"], out["params"] = v, prm
                del v, prm
            elif values == "shard":
                out["shards"] = {n: host(master(p))
                                 for n, p in inner.named_parameters()}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    out["launches"] = counts()
    out["routes"] = {k: seg.launches[k] - routes[k] for k in routes}
    mem = torch.tensor([max(peak, torch.cuda.max_memory_allocated()), base],
                       device=dev)
    dist.all_reduce(mem, op=dist.ReduceOp.MAX)
    out["peak_bytes"], out["base_bytes"] = (int(v) for v in mem.tolist())
    out["held_elems"] = sum(p.numel() for p in inner.parameters())
    if comm is not None:
        out["comm_ms"] = tp_comm_ms(hcg, *comm)
    if timed:
        t = out["step_s"][DIST_STEPS + DIST_TIMED["warmup"]:]
        out["step_ms"] = 1e3 * float(np.mean(t))
        out["tokens_s"] = batch[0].numel() / float(np.mean(t))
    del model, opt, step, inner, local
    fleet_reset()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_summary(run, n_params, world):
    """A run's numbers without its tensors; MFU is 6 N tokens a step over
    the cards' 989 TFLOP/s each."""
    out = {k: v for k, v in run.items()
           if k not in ("values", "params", "grads", "shards")}
    out["n_params"] = n_params
    if "step_ms" in run:
        out["tokens_s_card"] = run["tokens_s"] / world
        out["mfu"] = 6 * n_params * out["tokens_s_card"] / PEAK_BF16
    return out


def shard_compare(dist, tag, got, want):
    """Two runs of one split layout, each rank's fp32 shards after
    ``DIST_STEPS`` steps: the worst element over every rank within
    ``DIST_PARAM_MAX`` and the losses within ``XCHECK_LOSS_TOL`` (phase
    18's bounds); each shard's median distance is measured (phase 18
    found three correct reduction layouts ~3.9e-6 apart there)."""
    lg, lw = got["losses"][:DIST_STEPS], want["losses"][:DIST_STEPS]
    mx, med, worst_n = 0.0, 0.0, ""
    for n, w in want["shards"].items():
        d = (got["shards"][n].cuda() - w.cuda()).abs()
        if d.max().item() > mx:
            mx, worst_n = d.max().item(), n
        med = max(med, d.median().item())
        del d
    t = torch.tensor([mx, med], device=torch.cuda.current_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    mx, med = t.tolist()
    loss_diff = max(abs(a - b) for a, b in zip(lg, lw))
    say(f"tensor parallel: {tag}: losses {lg} against {lw}; values after "
        f"{DIST_STEPS} steps, every rank's shards: worst max diff "
        f"{mx:.3e} (rank 0's worst: {worst_n}; tol {DIST_PARAM_MAX:.2e}), "
        f"worst median {med:.3e} (measured)")
    if not loss_diff <= XCHECK_LOSS_TOL:
        fail(f"{tag}: losses differ by {loss_diff}")
    if not mx <= DIST_PARAM_MAX:
        fail(f"{tag}: values differ")
    return dict(loss_diff=loss_diff, value_max=mx, value_median=med)


def tp_world_of_one(dist, rank, world, dev):
    """Phase 19 at one card: LLaMA-2 7B O2 at depth 2 with
    ``sequence_parallel=True`` through ``TensorParallel`` and the hybrid
    optimizer in a world of one (mp 1: SP stays off), bit-equal to the
    plain step in losses, first gradients, parameters and fp32 masters,
    with the plain step's launches."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        TensorParallel)
    batch = zero3_global_batch(world)
    local = zero3_shard(batch, rank, dev)
    per_step = zero3_per_step(TP_DEPTH, False)
    plain = dist_run("plain", dist, tp_llama_trainer(TP_DEPTH, True), local,
                     per_step, rank, world, dev, grads=True, timed=False)
    tp = tp_run("tp_world_of_one", dist, {}, tp_llama_trainer(TP_DEPTH, True),
                batch, lambda hcg: per_step("plain", None), rank, world, dev,
                grads=True, wrap=lambda m, hcg: TensorParallel(m, hcg))
    res = dict(vs_plain=dist_compare(
        "phase 19: TensorParallel at a world of one vs the plain step", tp,
        plain, exact=True))
    res["run"] = tp_summary(tp, llama_param_count(
        llama_config(LLAMA_PRESET, num_layers=TP_DEPTH)), world)
    return res


def tp_rank(dist, rank, world, dev):
    """Phase 19 on four ranks: GPT-3 1.3B O2 at depth 2 under mp 4, mp 4
    + SP and dp 2 x mp 2, then LLaMA-2 7B O2 at depth 2 under mp 4 + SP,
    each held against rank 0's one-card oracle; then LLaMA-2 7B at all 32
    layers under mp 4 + SP against mp 4 without SP (every rank's shards).
    Returns rank 0's comparisons and every run's numbers."""
    res = {}
    cfg = gpt_config("gpt3-1.3B", num_layers=TP_DEPTH,
                     max_position_embeddings=TRAIN_SEQ)
    batch = dist_global_batch(cfg, 1)             # 4 x 2048, all ranks
    oracle = None
    if rank == 0:
        _, model, opt, step = build_trainer(TP_DEPTH, seed=0)
        oracle = dist_oracle(model, opt, step, [dist_shard(batch, 0, dev)],
                             timed=False)
        del model, opt, step
    dist.barrier()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for tag, (degrees, sp) in TP_GPT_RUNS.items():
        run = tp_run(f"gpt_{tag}", dist, degrees, tp_gpt_trainer(TP_DEPTH, sp),
                     batch, lambda hcg: gpt_tp_per_step(TP_DEPTH), rank,
                     world, dev, grads=True,
                     comm=(sp, TP_DEPTH, tokens // degrees.get("dp_degree", 1),
                           cfg.hidden_size))
        if rank == 0:
            res[f"gpt_{tag}_vs_oracle"] = dist_compare(
                f"phase 19: GPT-3 1.3B {tag} at depth {TP_DEPTH} vs the "
                "oracle", run, oracle, exact=False)
        res[f"gpt_{tag}"] = tp_summary(run, param_count(cfg), world)
        del run
    if rank == 0:
        res["gpt_oracle_losses"] = oracle["losses"]
    del oracle
    lcfg = llama_config(LLAMA_PRESET, num_layers=TP_DEPTH)
    lbatch = zero3_global_batch(1)                # 2 x 4096, all ranks
    ltokens = LLAMA_BATCH * LLAMA_SEQ
    oracle = None
    if rank == 0:
        model, opt = zero3_trainer(TP_DEPTH, False)()
        step = train_step(model, None, opt, step_fn=o2_step_fn)
        oracle = dist_oracle(model, opt, step, [zero3_shard(lbatch, 0, dev)],
                             timed=False)
        del model, opt, step
    dist.barrier()
    run = tp_run("llama_mp4_sp", dist, dict(mp_degree=4),
                 tp_llama_trainer(TP_DEPTH, True), lbatch,
                 lambda hcg: llama_per_step(TP_DEPTH), rank, world, dev,
                 grads=True, comm=(True, TP_DEPTH, ltokens,
                                   lcfg.hidden_size))
    if rank == 0:
        res["llama_mp4_sp_vs_oracle"] = dist_compare(
            f"phase 19: LLaMA-2 7B mp4 + SP at depth {TP_DEPTH} vs the "
            "oracle", run, oracle, exact=False)
        res["llama_oracle_losses"] = oracle["losses"]
    res["llama_mp4_sp"] = tp_summary(run, llama_param_count(lcfg), world)
    del run, oracle
    layers = llama_config(LLAMA_PRESET).num_layers
    full = llama_config(LLAMA_PRESET)
    runs = {}
    for tag, sp in (("mp4", False), ("mp4_sp", True)):
        runs[tag] = tp_run(f"llama32_{tag}", dist, dict(mp_degree=4),
                           tp_llama_trainer(layers, sp), lbatch,
                           lambda hcg: llama_per_step(layers), rank, world,
                           dev, values="shard",
                           comm=(sp, layers, ltokens, full.hidden_size))
        res[f"llama32_{tag}"] = tp_summary(runs[tag],
                                           llama_param_count(full), world)
        say_rank0(rank, tp_line(f"llama32_{tag}", res[f"llama32_{tag}"],
                                world))
    res["llama32_sp_vs_no_sp"] = shard_compare(
        dist, f"phase 19: LLaMA-2 7B mp4 + SP vs mp4 at {layers} layers",
        runs["mp4_sp"], runs["mp4"])
    del runs
    return res


class _OneCardRing(torch.autograd.Function):
    """Causal attention of ``[BH, S, D]`` through the factored ring
    schedule of ``n`` chunks on one card (``ops.ring_attention``): cp n's
    attention numerics, everything else one card's."""

    @staticmethod
    def forward(ctx, q, k, v, scale, n):
        from paddle_tpu_torch.ops import ring_attention as ring
        chunks = [[c.contiguous() for c in t.chunk(n, dim=1)]
                  for t in (q, k, v)]
        res = ring.ring_schedule_fwd(*chunks, scale, True)
        ctx.chunks, ctx.scale = chunks, scale
        ctx.outs, ctx.lses = [o for o, _ in res], [m for _, m in res]
        return torch.cat(ctx.outs, dim=1)

    @staticmethod
    def backward(ctx, do):
        from paddle_tpu_torch.ops import ring_attention as ring
        dos = [c.contiguous() for c in do.chunk(len(ctx.outs), dim=1)]
        grads = ring.ring_schedule_bwd(*ctx.chunks, ctx.outs, ctx.lses, dos,
                                       ctx.scale, True)
        return (*(torch.cat([g[i] for g in grads], dim=1)
                  for i in range(3)), None, None)


@contextlib.contextmanager
def one_card_ring(n):
    """The models' causal self-attention (``nn.functional``'s flash call)
    through :class:`_OneCardRing` of ``n`` chunks while inside."""
    from paddle_tpu_torch.nn import functional as nnf
    plain = nnf.flash_attention_bhsd

    def attend(q, k, v, scale, causal, *args, q_offset=0, n_rep=1, **kw):
        if not (causal and q_offset == 0 and n_rep == 1
                and q.shape[1] == k.shape[1] and q.shape[1] % n == 0):
            fail("one_card_ring: not a causal self-attention of n chunks")
        return _OneCardRing.apply(q, k, v, scale, n)
    nnf.flash_attention_bhsd = attend
    try:
        yield
    finally:
        nnf.flash_attention_bhsd = plain


@contextlib.contextmanager
def fp32_attention():
    """The models' flash call on fp32 copies of q, k and v while inside
    (K1's fp32 kernels: P and dS never rounded to bf16), the output cast
    back to q's dtype: a one-card step whose attention is near exact,
    independent of the ring's code, against which a bf16 attention layout
    is held."""
    from paddle_tpu_torch.nn import functional as nnf
    plain = nnf.flash_attention_bhsd

    def attend(q, k, v, scale, causal, *args, **kw):
        return plain(q.float(), k.float(), v.float(), scale, causal, *args,
                     **kw).to(q.dtype)
    nnf.flash_attention_bhsd = attend
    try:
        yield
    finally:
        nnf.flash_attention_bhsd = plain


def seq_oracles(layers, batch, dev):
    """Rank 0's one-card references for phase 20, each a ``dist_oracle``
    of phase 8's LLaMA-2 7B O2 step at ``layers`` on the global ``batch``:
    the plain step, the same step with its attention through K1's fp32
    kernels (``fp32_attention``: the witness), and with its attention
    through the factored ring of ``SEQ_RUNS_RING`` chunks
    (``one_card_ring``: cp's attention numerics on one card); and two
    measured controls against the plain step: the batch as accumulated
    micro-batches (what a reduction layout alone moves) and the ring.
    The plain step and the ring, each against the witness, say which of
    the two bf16 attention layouts is nearer the truth: the ring's must be
    within ``RING_WITNESS_MARGIN`` of the plain step's (a fault in the
    ring's steps moves only the ring's; the witness runs none of its
    code).  Returns the comparisons and the three references."""
    res = {}
    shards = [zero3_shard(batch, 0, dev)]

    def oracle_of(parts, ctx):
        with ctx:
            model, opt = zero3_trainer(layers, False)()
            step = train_step(model, None, opt, step_fn=o2_step_fn)
            out = dist_oracle(model, opt, step, parts, timed=False)
            del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        return out
    oracle = oracle_of(shards, contextlib.nullcontext())
    halves = [tuple(t[i:i + 1] for t in shards[0])
              for i in range(LLAMA_BATCH)]
    control = oracle_of(halves, contextlib.nullcontext())
    res["control_vs_oracle"] = dist_compare(
        f"phase 20: the one-card step as {LLAMA_BATCH} micro-batches vs "
        "the one-card step (a layout control, measured)", control, oracle,
        exact=False, check=False)
    del control
    exact = oracle_of(shards, fp32_attention())
    ring = oracle_of(shards, one_card_ring(SEQ_RUNS_RING))
    for key, got, want, what in (
            ("ring_control_vs_oracle", ring, oracle,
             f"the one-card step with its attention through the ring of "
             f"{SEQ_RUNS_RING} chunks vs the one-card step"),
            ("oracle_vs_fp32", oracle, exact,
             "the one-card step vs the one-card step with fp32 attention"),
            ("ring_control_vs_fp32", ring, exact,
             f"the one-card step with its attention through the ring of "
             f"{SEQ_RUNS_RING} chunks vs the one-card step with fp32 "
             "attention")):
        res[key] = dist_compare(f"phase 20: {what} (measured)", got, want,
                                exact=False, check=False)
    lim = RING_WITNESS_MARGIN * res["oracle_vs_fp32"]["grad_rel"]
    got = res["ring_control_vs_fp32"]["grad_rel"]
    say(f"distributed: phase 20: the ring's first gradients {got:.3e} from "
        f"the fp32-attention step, the plain step's "
        f"{res['oracle_vs_fp32']['grad_rel']:.3e} (limit {lim:.3e})")
    if not got <= lim:
        fail(f"phase 20: the one-card ring's first gradients are {got:.3e} "
             f"from the fp32-attention step, over {lim:.3e}")
    return res, oracle, ring, exact


def seq_rank(dist, rank, world, dev):
    """Phase 20 on four ranks: LLaMA-2 7B O2 at phase 8's 8 layers, batch
    2 x 4096 shared by every rank, under cp 4 (ring) and sep 4 (Ulysses);
    every rank's K1 launches exact (cp rank r: r + 1 of each a layer),
    every attention on its route.  Rank 0 holds sep 4 against its
    one-card plain step with phase 17's bounds, and cp 4 with phase 17's
    bounds against the one-card step with the same attention numerics,
    its attention through the factored ring (``one_card_ring``), which
    ``seq_oracles`` holds to the plain step's accuracy against an
    fp32-attention witness.  cp 4 against the plain step: losses and
    values with phase 17's bounds, the first gradients measured (two
    sound bf16 attention layouts sit ~2.5e-2 apart at 8 layers, each
    ~4.6e-2 from the witness: ``RING_WITNESS_MARGIN``); against the
    witness: measured."""
    res = {}
    layers = LLAMA_LAYERS
    cfg = llama_config(LLAMA_PRESET, num_layers=layers)
    batch = zero3_global_batch(1)
    oracle = ring_oracle = exact = None
    if rank == 0:
        res, oracle, ring_oracle, exact = seq_oracles(layers, batch, dev)
    dist.barrier()
    for tag, degrees in SEQ_RUNS.items():
        per_step = (lambda hcg: cp_per_step(
            layers, hcg.get_context_parallel_rank())) if "cp" in tag else \
            (lambda hcg: llama_per_step(layers))
        run = tp_run(f"llama_{tag}", dist, degrees,
                     tp_llama_trainer(layers, False), batch, per_step, rank,
                     world, dev, grads=True)
        route = "cp" if "cp" in tag else "sep"
        want = {"sep": 0, "cp": 0, "fallback": 0,
                route: layers * len(run["step_s"])}
        if run["routes"] != want:
            fail(f"rank {rank} {tag}: routes {run['routes']} != {want}")
        what = f"phase 20: LLaMA-2 7B {tag} at {layers} layers vs the " \
            "one-card step"
        if rank == 0 and route == "cp":
            res[f"{tag}_vs_one_card_ring"] = dist_compare(
                f"{what} through the ring", run, ring_oracle, exact=False)
            res[f"{tag}_vs_fp32"] = dist_compare(
                f"{what} with fp32 attention (measured)", run, exact,
                exact=False, check=False)
            res[f"{tag}_vs_oracle"] = dist_compare(
                f"{what} (first gradients measured)", run, oracle,
                exact=False, grad_tol=None)
        elif rank == 0:
            res[f"{tag}_vs_oracle"] = dist_compare(what, run, oracle,
                                                   exact=False)
        res[tag] = tp_summary(run, llama_param_count(cfg), world)
        del run
    if rank == 0:
        res["oracle_losses"] = oracle["losses"]
    del oracle, ring_oracle, exact
    return res


def check_ring_schedule():
    """The factored ring (``ops.ring_attention``) on one card: cp 4's
    four virtual ranks run their schedules in turn on the chunks of one
    causal sequence at llama2-7b's attention shape; the outputs, lse and
    gradients against K1 over the whole sequence (KTOL), the launches
    exact (rank r: r + 1 of each K1 kernel; 10 of each), the whole
    schedule's and each rank's forward times beside K1's; the ring's
    relative distance from K1's fp32 kernels on the same inputs within
    ``RING_WITNESS_MARGIN`` of K1's own."""
    from paddle_tpu_torch.ops import ring_attention as ring
    n, b, h = RING["ranks"], RING["batch"], RING["heads"]
    sq, d = RING["seq"], RING["head_dim"]
    dtype = torch.bfloat16
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    q, k, v, do = (rand((b * h, sq, d), dtype, g) for _ in range(4))
    scale = 1.0 / d ** 0.5
    qc, kc, vc, dc = ([c.contiguous() for c in t.chunk(n, dim=1)]
                      for t in (q, k, v, do))
    reset_counts()
    fwd = ring.ring_schedule_fwd(qc, kc, vc, scale, True)
    outs, lses = [o for o, _ in fwd], [lse for _, lse in fwd]
    grads = ring.ring_schedule_bwd(qc, kc, vc, outs, lses, dc, scale, True)
    torch.cuda.synchronize()
    launches = counts()
    want = n * (n + 1) // 2
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[key] != want:
            fail(f"ring schedule: {key} launched {launches[key]} != {want}")
    out, lse = fa.flash_attention_fwd(q, k, v, scale, True, 0)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, scale, True,
                                        0)
    errs = {}
    for name, got, ref, dt in (
            ("out", torch.cat(outs, 1), out, dtype),
            ("lse", torch.cat(lses, 1), lse, torch.float32),
            ("dq", torch.cat([x[0] for x in grads], 1), dq, dtype),
            ("dk", torch.cat([x[1] for x in grads], 1), dk, dtype),
            ("dv", torch.cat([x[2] for x in grads], 1), dv, dtype)):
        check_close(f"ring schedule {name} vs K1", got, ref, dt)
        errs[name] = max_err(got, ref)
    # both bf16 layouts against K1's fp32 kernels on fp32 copies (P and dS
    # never rounded): relative norms, measured
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    out32, lse32 = fa.flash_attention_fwd(qf, kf, vf, scale, True, 0)
    exact = (out32, *fa.flash_attention_bwd(qf, kf, vf, out32, lse32, dof,
                                            scale, True, 0))
    del qf, kf, vf, dof, lse32
    ring_all = (torch.cat(outs, 1),
                *(torch.cat([x[i] for x in grads], 1) for i in range(3)))
    vs_fp32 = {}
    for who, res in (("k1", (out, dq, dk, dv)), ("ring", ring_all)):
        vs_fp32[who] = {
            name: ((a.float() - e).norm() / e.norm()).item()
            for name, a, e in zip(("out", "dq", "dk", "dv"), res, exact)}
    del exact, ring_all
    for name, k1_rel in vs_fp32["k1"].items():
        if not vs_fp32["ring"][name] <= RING_WITNESS_MARGIN * k1_rel:
            fail(f"ring schedule {name}: {vs_fp32['ring'][name]:.3e} from "
                 f"K1's fp32 kernels, over {RING_WITNESS_MARGIN} x K1's "
                 f"{k1_rel:.3e}")

    def one_rank(r):
        o, m = ring._start(qc[r])
        for i in range(n):
            j = (r - i) % n
            o, m = ring.ring_fwd_step(qc[r], kc[j], vc[j], o, m, scale,
                                      r * (sq // n), j * (sq // n), True)
        return o
    row = dict(shape=f"[{b * h}, {sq}, {d}] bf16 causal in {n} chunks",
               launches={k: launches[k] for k in ("flash_fwd",
                                                  "flash_bwd_dq",
                                                  "flash_bwd_dkv")},
               max_abs_err=errs, rel_vs_fp32=vs_fp32,
               ring_fwd_ms=time_ms(lambda: ring.ring_schedule_fwd(
                   qc, kc, vc, scale, True), 3),
               ring_bwd_ms=time_ms(lambda: ring.ring_schedule_bwd(
                   qc, kc, vc, outs, lses, dc, scale, True), 3),
               k1_fwd_ms=time_ms(lambda: fa.flash_attention_fwd(
                   q, k, v, scale, True, 0), 3),
               k1_bwd_ms=time_ms(lambda: fa.flash_attention_bwd(
                   q, k, v, out, lse, do, scale, True, 0), 3),
               rank_fwd_ms=[time_ms(functools.partial(one_rank, r), 3)
                            for r in range(n)])
    say("ring schedule: " + json.dumps(row))
    del q, k, v, do, qc, kc, vc, dc, fwd, outs, lses, grads, out, lse
    torch.cuda.empty_cache()
    return row


def say_rank0(rank, msg):
    if rank == 0:
        say(msg)


def tp_line(key, m, world):
    """One phase 19 / 20 run's numbers on a line."""
    line = (f"tensor parallel: {key} {m['degrees']}: "
            f"{m['n_params']} parameters, {m['held_elems']} held a rank; "
            f"step ms {[round(1e3 * t, 2) for t in m['step_s']]}")
    if "step_ms" in m:
        line += (f"; timed mean {m['step_ms']:.2f} ms = "
                 f"{m['tokens_s']:.1f} tokens/s over {world} card(s), "
                 f"{m['tokens_s_card']:.1f} a card, MFU "
                 f"{100 * m['mfu']:.2f} % (6 N tokens a card / 989 TFLOP/s)")
    if m.get("comm_ms") is not None:
        line += f"; the step's mp collectives alone {m['comm_ms']:.3f} ms"
    line += (f"; peak memory {m['peak_bytes']} bytes "
             f"({m['peak_bytes'] / 2**30:.2f} GiB, the largest rank's), "
             f"{m['base_bytes']} bytes allocated before the run")
    return line + (f"\ntensor parallel: {key}: launches over "
                   f"{len(m['step_s'])} steps {m['launches']}; routes "
                   f"{m['routes']}")


# ---------------------------------------------------------------------------
# phase 21: pipeline parallel
# ---------------------------------------------------------------------------

PP_MICRO = 8                     # micro-batches a step (accumulate_steps)
PP_ONE_CARD = ("1F1B", "FThenB", "ZBH1")
# the four-card LLaMA-2 7B runs at 32 layers: (tag, schedule,
# recompute_interval).  FThenB and ZBH1 keep 8 micro-batches' graphs a
# rank (~50 GB of residuals at 8 layers of 1 x 4096): every layer is
# recomputed in all four schedules, then 1F1B once without
PP_RUNS = (("1F1B", "1F1B", 1), ("FThenB", "FThenB", 1),
           ("ZBH1", "ZBH1", 1), ("VPP", "VPP", 1), ("1F1B_norc", "1F1B", 0))
PP_GPT_ROWS = 2                  # GPT rows a micro-batch (1 a dp rank)
PP_STAGES = 4                    # the one-card run's stages on cuda:0


def card() -> torch.device:
    """This process's CUDA card."""
    return torch.device("cuda", torch.cuda.current_device())


def o2_cast():
    return amp.auto_cast(enable=True, level="O2", dtype="bfloat16")


def pp_generator(piece: int, dev):
    """The generator of one piece of the LLaMA pipeline (0: the
    embedding, i + 1: decoder layer i, -1: the head), each seeded alone,
    so a stage draws its own pieces without the others'."""
    from paddle_tpu_torch.device import generator
    return generator(1000 + piece if piece >= 0 else 999, dev)


def pp_head_weight(cfg, dev, pc=None):
    """The head ``[V, H]`` (under mp: this rank's vocabulary rows)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        .mp_layers import shard_of
    full = torch.empty(cfg.vocab_size, cfg.hidden_size, device=dev)
    with torch.no_grad():
        full.normal_(0.0, cfg.initializer_range,
                     generator=pp_generator(-1, dev))
    if pc is not None and pc.mp > 1:
        full = shard_of(full, 0, 1, pc.mp_rank, pc.mp).contiguous()
    return full


def pp_embedding(cfg, dev):
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import VocabParallelEmbedding
    from paddle_tpu_torch.nn.initializer import Normal, ParamAttr
    return VocabParallelEmbedding(
        cfg.vocab_size, cfg.hidden_size,
        weight_attr=ParamAttr(initializer=Normal(std=cfg.initializer_range)),
        generator=pp_generator(0, dev), device=dev)


class LlamaEmbedPipe(torch.nn.Module):
    """The LLaMA pipeline's first piece: the token embedding, under O2."""

    def __init__(self, cfg, dev):
        super().__init__()
        self.embed_tokens = pp_embedding(cfg, dev)

    def forward(self, ids):
        with o2_cast():
            return self.embed_tokens(ids)


def _llama_layer_class():
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer

    class LlamaLayerPipe(LlamaDecoderLayer):
        """Decoder layer ``i`` of the LLaMA pipeline, under O2."""

        def __init__(self, cfg, i, dev):
            super().__init__(cfg, gen=pp_generator(i + 1, dev), device=dev)

        def forward(self, x):
            with o2_cast():
                return super().forward(x)
    return LlamaLayerPipe


LlamaLayerPipe = _llama_layer_class()


class LlamaHeadPipe(torch.nn.Module):
    """The LLaMA pipeline's last piece: the final RMSNorm (K4a) and the
    head, under O2."""

    def __init__(self, cfg, dev):
        super().__init__()
        from paddle_tpu_torch.models.llama import LlamaRMSNorm
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_eps, device=dev)
        self.lm_head_weight = torch.nn.Parameter(pp_head_weight(cfg, dev))

    def forward(self, h):
        from paddle_tpu_torch.nn import functional as PF
        with o2_cast():
            return PF.matmul(self.norm(h), self.lm_head_weight,
                             transpose_y=True)


class PPLoss:
    """LLaMA's criterion under O2 (the pipeline's ``loss_fn``)."""

    def __init__(self):
        from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
        self.crit = LlamaPretrainingCriterion()

    def __call__(self, logits, labels):
        with o2_cast():
            return self.crit(logits, labels)


def llama_pipe(layers, dev, num_stages=None, vpp=None, recompute=1,
               grad_clip=None):
    """LLaMA-2 7B at ``layers`` as a ``PipelineLayer`` (the embedding,
    the decoder layers, the norm and head; each stage starts at a decoder
    layer, ``seg_method="layer:LlamaLayerPipe"``), O2: its AdamW(1e-4, wd
    0.01, ``grad_clip``) with fp32 masters, the pieces decorated.  Under a
    pipeline degree above 1 the rank builds its own stage only."""
    from paddle_tpu_torch.distributed.fleet import LayerDesc, PipelineLayer
    cfg = llama_config(LLAMA_PRESET, num_layers=layers)
    descs = ([LayerDesc(LlamaEmbedPipe, cfg, dev)]
             + [LayerDesc(LlamaLayerPipe, cfg, i, dev) for i in range(layers)]
             + [LayerDesc(LlamaHeadPipe, cfg, dev)])
    pl = PipelineLayer(descs, num_stages=num_stages, loss_fn=PPLoss(),
                       seg_method="layer:LlamaLayerPipe",
                       recompute_interval=recompute,
                       num_virtual_pipeline_stages=vpp)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=pl.parameters(),
                          weight_decay=0.01, multi_precision=True,
                          grad_clip=grad_clip)
    return amp.decorate(models=pl, optimizers=opt, level="O2",
                        dtype="bfloat16")


def pp_model_name(name: str, layers: int) -> str:
    """A LLaMA pipeline piece's parameter name as ``LlamaForCausalLM``
    names it."""
    head, rest = name.split(".", 1)
    i = int(head)
    if i == 0:
        return "llama." + rest
    if i == layers + 1:
        return rest if rest == "lm_head_weight" else "llama." + rest
    return f"llama.layers.{i - 1}.{rest}"


def pp_llama_batch():
    """``PP_MICRO`` micro-batches of 1 x 4096 tokens (the global batch,
    on the host)."""
    rs = np.random.RandomState(0)
    vocab = llama_config(LLAMA_PRESET).vocab_size
    return (torch.from_numpy(rs.randint(0, vocab, (PP_MICRO, LLAMA_SEQ))),
            torch.from_numpy(rs.randint(0, vocab, (PP_MICRO, LLAMA_SEQ))))


def pp_gpt_batch():
    rs = np.random.RandomState(0)
    vocab = gpt_config("gpt3-1.3B").vocab_size
    n = PP_MICRO * PP_GPT_ROWS
    return (torch.from_numpy(rs.randint(0, vocab, (n, TRAIN_SEQ))),
            torch.from_numpy(rs.randint(0, vocab, (n, TRAIN_SEQ))))


# launches of one piece's forward and backward (phase 8's per-layer counts)
PP_PIECE = {"LlamaLayerPipe": (dict(flash_fwd=1, rms_fwd=2, rope=2),
                               dict(flash_bwd_dq=1, flash_bwd_dkv=1,
                                    rms_bwd_dx=2, rope=2)),
            "LlamaDecoderLayer": (dict(flash_fwd=1, rms_fwd=2, rope=2),
                                  dict(flash_bwd_dq=1, flash_bwd_dkv=1,
                                       rms_bwd_dx=2, rope=2)),
            "GPTBlock": (dict(flash_fwd=1, ln_fwd=2),
                         dict(flash_bwd_dq=1, flash_bwd_dkv=1, ln_bwd_dx=2)),
            "LlamaHeadPipe": (dict(rms_fwd=1), dict(rms_bwd_dx=1))}


def pp_piece_kind(layer) -> str:
    inner = getattr(layer, "block", None)      # a pipeline step's block
    return type(inner if inner is not None else layer).__name__


def pp_expected(events, runners, recompute, adamw_n):
    """The launches of one step's ``events`` (``(virtual stage, kind,
    micro)``): a forward runs each piece's forward launches; a backward
    pass its backward launches, and its forward again under recompute.
    B is one pass, Bd one (the first stage's: none) and Bw one;
    ``adamw_n`` K3 launches."""
    out = {k: 0 for k in PER_STEP}
    for k, kind, _ in events:
        fwd, bwd = {}, {}
        for layer in runners[k].layers:
            f, b = PP_PIECE.get(pp_piece_kind(layer), ({}, {}))
            for key, v in f.items():
                fwd[key] = fwd.get(key, 0) + v
            for key, v in b.items():
                bwd[key] = bwd.get(key, 0) + v
        passes = []
        if kind == "F":
            passes = [fwd]
        elif kind == "Bd" and k == 0:
            passes = []
        else:
            passes = [bwd, fwd] if recompute else [bwd]
        for d in passes:
            for key, v in d.items():
                out[key] += v
    out["adamw"] = adamw_n
    return out


def pp_values(params):
    """``{name: fp32 value on the host}`` (the master where there is one)
    of ``params`` (``(name, parameter, optimizer)``)."""
    out = {}
    for n, p, opt in params:
        inner = getattr(opt, "_inner_opt", opt)
        out[n] = host(inner.state[p].get("master", p).float())
    return out


def pp_grads(params):
    return {n: host(p.grad) for n, p, _ in params}


def pp_gather0(dist, rank, world, vals, senders=None):
    """Rank 0 gets every other rank's ``{name: host tensor}`` (the
    ``senders`` only), merged with its own; None on the others."""
    metas = []
    dist.all_gather_object(metas, [(n, tuple(t.shape), str(t.dtype))
                                   for n, t in vals.items()])
    senders = senders if senders is not None else range(world)
    merged = dict(vals) if rank == 0 else None
    for r in senders:
        if r == 0:
            continue
        for n, shape, dt in metas[r]:
            if rank == r:
                dist.send(vals[n].to(card()), 0)
            elif rank == 0:
                buf = torch.empty(shape, dtype=getattr(torch,
                                                       dt.split(".")[1]),
                                  device=card())
                dist.recv(buf, r)
                merged[n] = host(buf)
                del buf
    return merged


def pp_cross_compare(dist, rank, tag, base, got, split=None, exact=False,
                     median_tol=DIST_PARAM_MEDIAN):
    """Values of two layouts of one model, each rank holding some of them:
    ``base`` and ``got`` map this rank's names (``base``'s naming) to host
    tensors; ``split(name)`` gives a ``got`` tensor's mp shard as
    ``(axis, groups, rank, degree)``.  The holder of each ``base`` tensor
    sends it to every rank that holds it in ``got`` (a collective walk in
    one order); returns the worst element over every rank and the worst
    tensor median; ``exact`` requires them all 0, else the worst element
    is held to ``DIST_PARAM_MAX`` and the median to ``median_tol`` (None:
    measured, as phase 19 measures it across layouts)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        .mp_layers import shard_of
    owners, holders = [], []
    dist.all_gather_object(owners, [(n, tuple(t.shape), str(t.dtype))
                                    for n, t in base.items()])
    dist.all_gather_object(holders, sorted(got))
    where = {n: (r, shape, dt) for r, items in enumerate(owners)
             for n, shape, dt in items}
    mx = med = 0.0
    worst = ""
    for n in sorted(where):
        src, shape, dt = where[n]
        for dst, names in enumerate(holders):
            if n not in names:
                continue
            if rank == src and dst != src:
                dist.send(base[n].to(card()), dst)
            if rank != dst:
                continue
            if src == dst:
                full = base[n].to(card())
            else:
                full = torch.empty(shape, dtype=getattr(
                    torch, dt.split(".")[1]), device=card())
                dist.recv(full, src)
            s = split(n) if split is not None else None
            want = shard_of(full, *s) if s is not None else full
            d = (got[n].to(card()) - want).abs()
            if d.max().item() > mx:
                mx, worst = d.max().item(), n
            med = max(med, d.float().median().item())
            del d, full, want
    t = torch.tensor([mx, med], device=card())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    mx, med = t.tolist()
    say_rank0(rank, f"pipeline: {tag}: values after {DIST_STEPS} steps, every "
              f"rank's: worst max diff {mx:.3e} (rank {rank}'s worst: "
              f"{worst or 'none'}; tol {0.0 if exact else DIST_PARAM_MAX:.2e}"
              f"), worst median {med:.3e} ("
              + ("measured" if median_tol is None and not exact else
                 f"tol {0.0 if exact else median_tol:.2e}") + ")")
    if exact and mx != 0.0:
        fail(f"{tag}: values not bit-equal (worst {mx:.3e})")
    if not exact and not (mx <= DIST_PARAM_MAX and (
            median_tol is None or med <= median_tol)):
        fail(f"{tag}: values differ")
    return dict(value_max=mx, value_median=med, bit_equal=mx == 0.0)


def pp_step_loop(tag, step_fn, sched_of, expected, n_total, rank, grads_of,
                 values_of, timing=True, params_of=None):
    """``n_total`` steps of ``step_fn(s)`` (returns the loss; at ``s == 0``
    it may keep the reduced gradients through ``grads_of``): each step's
    launches equal ``expected(events)`` of its schedule; the fp32 values
    after ``DIST_STEPS`` steps; each timed step's host ms and, from the
    schedule's CUDA events, its busy and step ms (the idle share);
    ``params_of`` the parameters after the held steps too."""
    out = dict(tag=tag, losses=[], step_s=[], busy_ms=[], sched_ms=[])
    reset_counts()                   # count the main path's launches only
    peak = 0
    for s in range(n_total):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step_fn(s)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        sched = sched_of()
        sched.timing = timing
        after = counts()
        want = expected(sched.event_log)
        moved = {k: after[k] - before[k] for k in want}
        if moved != want:
            fail(f"rank {rank} {tag} step {s}: launches {moved} != {want}")
        out["losses"].append(float(loss.float()))
        if s > 0 and timing:
            out["busy_ms"].append(sched.busy_ms)
            out["sched_ms"].append(sched.step_ms)
        if s == DIST_STEPS - 1:
            peak = torch.cuda.max_memory_allocated()
            out["values"] = values_of()
            if params_of is not None:
                out["params"] = params_of()
            torch.cuda.empty_cache()
    out["launches"] = counts()
    out["peak_live_residuals"] = sched.peak_live_residuals
    out["peak_retained_graphs"] = sched.peak_retained_graphs
    out["events"] = [list(e) for e in sched.event_log]
    out["peak_bytes"] = max(peak, torch.cuda.max_memory_allocated())
    g = grads_of()
    if g is not None:
        out["grads"] = g
    return out


def pp_timing(out, world, tokens, n_params):
    """Step ms, tokens/s, MFU and the idle share of a run's timed steps."""
    t = out["step_s"][DIST_STEPS + DIST_TIMED["warmup"]:]
    if not t:
        return out
    out["step_ms"] = 1e3 * float(np.mean(t))
    out["tokens_s"] = tokens / float(np.mean(t))
    out["tokens_s_card"] = out["tokens_s"] / world
    out["mfu"] = 6 * n_params * out["tokens_s_card"] / PEAK_BF16
    k = DIST_STEPS + DIST_TIMED["warmup"] - 1
    busy, sched = out["busy_ms"][k:], out["sched_ms"][k:]
    if busy and float(np.sum(sched)) > 0:
        out["idle"] = 1.0 - float(np.sum(busy)) / float(np.sum(sched))
    return out


def pipeline_one_card():
    """Phase 21 at one card: LLaMA-2 7B O2 at phase 8's 8 layers as a
    ``PipelineLayer`` of 4 stages on cuda:0 (``HostPipelineSchedule``
    behind ``PipelineParallel``), 8 micro-batches of 1 x 4096 a step,
    every layer recomputed (FThenB would hold ~56 GB of residuals), under
    1F1B, FThenB and ZBH1, each bit-equal to the plain step that
    accumulates the same micro-batches (loss / 8 each) through the same
    layers: losses, first gradients, parameters and fp32 masters; exact
    launches a step.  Returns the runs' numbers."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PipelineParallel
    dev = card()
    x, y = pp_llama_batch()
    micro = list(zip(x.to(dev).split(1), y.to(dev).split(1)))
    layers = LLAMA_LAYERS
    res = {}
    gc.collect()
    torch.cuda.empty_cache()

    # the plain step: each micro-batch through every piece, loss / 8
    pl, opt = llama_pipe(layers, dev, num_stages=PP_STAGES)
    named = [(n, p, opt) for n, p in pl.named_parameters()]
    grads = {}

    def plain(s):
        total = None
        for xi, yi in micro:
            loss = pl._loss_fn(pl(xi), yi)
            (loss / PP_MICRO).backward()
            total = loss.detach().float() if total is None \
                else total + loss.detach().float()
        if s == 0:
            grads.update(pp_grads(named))
        opt.step()
        opt.clear_grad()
        return total / PP_MICRO

    class _Plain:                       # the launches of a whole step
        event_log = [(k, e, 0) for k in range(PP_STAGES) for e in ("F", "B")]
        peak_live_residuals = peak_retained_graphs = 0
        timing = False
    runners = {k: types_ns(layers=pl.stage_layers(k))
               for k in range(PP_STAGES)}

    def expected_plain(events, n=len(named)):
        e = pp_expected(events, runners, True, n)
        return {k: v * (PP_MICRO if k != "adamw" else 1)
                for k, v in e.items()}
    run = pp_step_loop("plain", plain, lambda: _Plain, expected_plain,
                       DIST_STEPS, 0, lambda: dict(grads),
                       lambda: pp_values(named), timing=False,
                       params_of=lambda: {n: host(p) for n, p in
                                          pl.named_parameters()})
    base = dict(losses=run["losses"], values=run.pop("values"),
                grads=run.pop("grads"), params=run.pop("params"))
    res["plain"] = {k: v for k, v in run.items() if k != "events"}
    del pl, opt, named, grads, run
    gc.collect()
    torch.cuda.empty_cache()
    for mode in PP_ONE_CARD:
        torch.cuda.reset_peak_memory_stats()
        pl, opt = llama_pipe(layers, dev, num_stages=PP_STAGES)
        s = fleet.DistributedStrategy()
        s.pipeline_configs = {"micro_batch_size": 1,
                              "accumulate_steps": PP_MICRO,
                              "schedule_mode": mode}
        model = PipelineParallel(pl, strategy=s)
        named = [(n, p, opt) for n, p in pl.named_parameters()]
        grads = {}

        def step_fn(i):
            if i == 0:
                loss = model.forward_backward_pipeline((x, y))
                grads.update(pp_grads(named))
                opt.step()
                opt.clear_grad()
                return loss
            return model.train_batch((x, y), opt)
        n_total = DIST_STEPS + (sum(DIST_TIMED.values())
                                if mode == "1F1B" else 0)
        run = pp_step_loop(
            mode, step_fn, lambda: model._host_sched,
            lambda ev: pp_expected(ev, model._host_sched.runners, True,
                                   len(named)),
            n_total, 0, lambda: dict(grads), lambda: pp_values(named),
            timing=False,
            params_of=lambda: {n: host(p) for n, p in pl.named_parameters()})
        if mode == "1F1B":
            pp_timing(run, 1, PP_MICRO * LLAMA_SEQ, llama_param_count(
                llama_config(LLAMA_PRESET, num_layers=layers)))
        bit = all(torch.equal(run[key][n], base[key][n])
                  for key in ("values", "params", "grads")
                  for n in base[key]) and \
            run["losses"][:DIST_STEPS] == base["losses"]
        if bit:
            cmp = dist_compare(f"phase 21: {mode} on one card vs the plain "
                               "accumulated step", run, base, exact=True)
        else:
            cmp = dist_compare(f"phase 21: {mode} on one card vs the plain "
                               "accumulated step (not bit-equal: measured, "
                               "held to phase 17's bounds)", run, base,
                               exact=False)
        cmp["bit_equal"] = bit
        res[mode] = dict({k: v for k, v in run.items()
                          if k not in ("values", "params", "grads")},
                         vs_plain=cmp)
        say(f"pipeline: one card {mode}: step ms "
            f"{[round(1e3 * t, 2) for t in run['step_s']]}, peak live "
            f"residuals {run['peak_live_residuals']} (retained graphs "
            f"{run['peak_retained_graphs']}), peak memory "
            f"{run['peak_bytes'] / 2**30:.2f} GiB; launches {run['launches']}")
        del pl, opt, model, named, grads, run
        gc.collect()
        torch.cuda.empty_cache()
    return res


class types_ns:
    """A plain attribute holder."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def release_groups(dist):
    """Free the communicators of every group but the world's, each rank
    at the same point: a topology's groups (its axes, fused axes and
    pipeline channels) keep their NCCL buffers after ``fleet_reset``, ~25
    GB a rank by the end of phases 17-21, which the 32-layer pipelines'
    ~55 GB do not leave room for.  Phase 21 builds a new topology for
    every run and uses no earlier group."""
    from paddle_tpu_torch.distributed.communication import group as grp
    from paddle_tpu_torch.distributed.mesh import reset_mesh
    torch.cuda.synchronize()
    dist.barrier()
    for gid, g in sorted(grp._groups.items()):
        if gid == 0:
            continue
        if g.process_group is not None:
            torch.distributed.destroy_process_group(g.process_group)
        del grp._groups[gid]
    reset_mesh()
    gc.collect()
    torch.cuda.empty_cache()


def pp_fleet_reset(dist):
    fleet_reset()
    release_groups(dist)


def pp_fleet_init(degrees, mode="1F1B"):
    """``fleet.init`` at ``degrees`` with phase 21's pipeline configs."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(degrees)
    s.pipeline_configs = {"micro_batch_size": 1,
                          "accumulate_steps": PP_MICRO,
                          "schedule_mode": mode}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def pp_exchange_ms(dist, sched, like):
    """One step's p2p traffic of every rank timed alone (host clock around
    synchronised exchanges after a barrier, the mean of 3; the slowest
    rank's)."""
    sched.exchange_only(PP_MICRO, like)          # warm
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        sched.exchange_only(PP_MICRO, like)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    t = torch.tensor([1e3 * float(np.mean(ts))], device=card())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.item()


def pp_layer_run(tag, dist, degrees, mode, layers, recompute, batch, rank,
                 world, timed=True, grads=False):
    """LLaMA-2 7B O2 at ``layers`` as a ``PipelineLayer`` under
    ``fleet.init(degrees)`` (each rank its stage), through
    ``fleet.distributed_model`` (``PipelineParallel``),
    ``fleet.distributed_optimizer`` and ``train_batch`` on the global
    batch: ``DIST_STEPS`` held steps (the first with the gradients kept
    when ``grads``), then (``timed``) ``DIST_TIMED`` more; exact launches
    a step; the rank's fp32 values (named as ``LlamaForCausalLM`` names
    them) after the held steps."""
    from paddle_tpu_torch.distributed import fleet
    dist_settle(dist)
    torch.cuda.reset_peak_memory_stats()
    hcg = pp_fleet_init(degrees, mode)
    dev = card()
    pl, opt = llama_pipe(layers, dev, vpp=2 if mode == "VPP" else None,
                         recompute=recompute)
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(opt)
    named = [(pp_model_name(n, layers), p, opt)
             for n, p in pl.named_parameters()]
    kept = {}

    def step_fn(s):
        if s == 0 and grads:
            loss = model.forward_backward_pipeline(batch)
            opt._reduce_gradients()
            kept.update(pp_grads(named))
            opt._stepper().step()
            opt.clear_grad()
            return loss
        return model.train_batch(batch, opt)
    n_total = DIST_STEPS + (sum(DIST_TIMED.values()) if timed else 0)
    run = pp_step_loop(
        tag, step_fn, lambda: model._host_sched,
        lambda ev: pp_expected(ev, model._host_sched.runners, recompute,
                               len(named)),
        n_total, rank, lambda: dict(kept) if grads else None,
        lambda: pp_values(named))
    run.update(mode=mode, recompute=recompute, degrees=degrees,
               held=len(named))
    if timed:
        like = torch.zeros(1, LLAMA_SEQ, llama_config(LLAMA_PRESET)
                           .hidden_size, dtype=torch.bfloat16, device=dev)
        run["p2p_ms"] = pp_exchange_ms(dist, model._host_sched, like)
    del model, opt, pl, named
    pp_fleet_reset(dist)
    gc.collect()
    torch.cuda.empty_cache()
    return run


def pp_llama_step_run(tag, dist, layers, batch, rank, world):
    """LLaMA-2 7B O2 at ``layers`` under mp 2 x pp 2 through
    ``llama_pipeline_step(model, opt, hcg.mesh, n_micro=8)`` (its
    defaults: each block recomputed), the model built with the pipeline's
    per-piece weights (the embedding, this stage's decoder layers, the
    head; the others' places empty until the step fills them)."""
    from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                               llama_pipeline_step)
    dist_settle(dist)
    torch.cuda.reset_peak_memory_stats()
    hcg = pp_fleet_init(dict(mp_degree=2, pp_degree=2))
    dev = card()
    cfg = llama_config(LLAMA_PRESET, num_layers=layers)
    model = LlamaForCausalLM(llama_config(LLAMA_PRESET, num_layers=0),
                             seed=0)
    pc = model._pc
    per = layers // 2
    own = range(hcg.get_stage_id() * per, (hcg.get_stage_id() + 1) * per)
    model.llama.embed_tokens = pp_embedding(cfg, dev)
    model.llama.layers = torch.nn.ModuleList([
        LlamaDecoderLayer(cfg, gen=pp_generator(i + 1, dev), device=dev,
                          pc=pc) if i in own else torch.nn.Identity()
        for i in range(layers)])
    model.lm_head_weight = torch.nn.Parameter(pp_head_weight(cfg, dev, pc))
    model.lm_head_weight.split_axis = 0
    model.lm_head_weight.split_groups = 1
    model.config = model.llama.config = cfg
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True)
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16")
    step = llama_pipeline_step(model, opt, hcg.mesh, n_micro=PP_MICRO,
                               autocast=o2_cast)
    named = lambda: [(n, p, opt) for n, p in model.named_parameters()
                     if p in opt.state]
    n_total = DIST_STEPS + sum(DIST_TIMED.values())
    run = pp_step_loop(
        tag, lambda s: step(*batch), lambda: step.sched,
        lambda ev: pp_expected(ev, step.sched.runners, True,
                               sum(1 for q in step.params()
                                   if q.grad is not None or q in opt.state)),
        n_total, rank, lambda: None, lambda: pp_values(named()))
    run["shards"] = {n: (p.split_axis, p.split_groups,
                         hcg.get_model_parallel_rank(), 2)
                     for n, p, _ in named()
                     if getattr(p, "split_axis", None) is not None}
    run.update(degrees=dict(mp_degree=2, pp_degree=2), mode="1F1B",
               recompute=1, held=len(named()))
    like = torch.zeros(1, LLAMA_SEQ, cfg.hidden_size, dtype=torch.bfloat16,
                       device=dev)
    run["p2p_ms"] = pp_exchange_ms(dist, step.sched, like)
    del model, opt, step
    pp_fleet_reset(dist)
    gc.collect()
    torch.cuda.empty_cache()
    return run


def pp_gpt_run(dist, rank, world):
    """GPT-3 1.3B O2 at all 24 layers under dp 2 x pp 2 through
    ``gpt_pipeline_step`` (the head tied to the word embedding across the
    first and last stage), 8 micro-batches of 2 x 2048 a step (one row a
    dp rank)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        gpt_pipeline_step)
    from paddle_tpu_torch.distributed import fleet
    dist_settle(dist)
    torch.cuda.reset_peak_memory_stats()
    hcg = pp_fleet_init(dict(dp_degree=2, pp_degree=2))
    cfg = gpt_config("gpt3-1.3B", num_layers=N_LAYERS,
                     max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model, opt = build_gpt_o2(cfg)
    opt = fleet.distributed_optimizer(opt)
    inner = opt._inner_opt
    step = gpt_pipeline_step(model, opt, hcg.mesh, n_micro=PP_MICRO,
                             dp_axes=("dp",), autocast=o2_cast)
    named = lambda: [(n, p, inner) for n, p in model.named_parameters()
                     if p in inner.state]
    kept = {}
    orig = inner.step

    def step_keeping(s):
        if s == 0:
            def snap():
                kept.update({n: host(p.grad) for n, p in
                             model.named_parameters() if p.grad is not None})
                orig()
            inner.step = snap
        try:
            return step(*pp_gpt_batch())
        finally:
            inner.step = orig
    n_total = DIST_STEPS + sum(DIST_TIMED.values())
    run = pp_step_loop(
        "gpt_dp2_pp2", step_keeping, lambda: step.sched,
        lambda ev: pp_expected(ev, step.sched.runners, True,
                               sum(1 for q in step.params()
                                   if q in inner.state
                                   or q.grad is not None)),
        n_total, rank, lambda: dict(kept), lambda: pp_values(named()))
    run.update(degrees=dict(dp_degree=2, pp_degree=2), mode="1F1B",
               recompute=1, held=len(named()),
               tied=list(model.gpt.embeddings.word_embeddings.weight
                         .pp_shared_group.ranks))
    like = torch.zeros(1, TRAIN_SEQ, cfg.hidden_size, dtype=torch.bfloat16,
                       device=card())
    run["p2p_ms"] = pp_exchange_ms(dist, step.sched, like)
    del model, opt, step, inner
    pp_fleet_reset(dist)
    gc.collect()
    torch.cuda.empty_cache()
    return run


def pp_summary(run, world, tokens, n_params):
    """A run's numbers without its tensors."""
    pp_timing(run, world, tokens, n_params)
    mem = run.get("peak_bytes", 0)
    return {k: v for k, v in run.items()
            if k not in ("values", "grads", "params", "shards", "events")} \
        | dict(n_params=n_params, peak_gib=mem / 2**30)


def pp_rank_numbers(dist, run, world):
    """Every rank's idle share, peak live residuals and peak memory (the
    run's numbers on rank 0)."""
    per = []
    dist.all_gather_object(per, dict(
        idle=run.get("idle"), peak_live_residuals=run["peak_live_residuals"],
        peak_retained_graphs=run["peak_retained_graphs"],
        peak_bytes=run["peak_bytes"], launches=run["launches"],
        held=run.get("held")))
    return per


def pipeline_rank(dist, rank, world, dev):
    """Phase 21 on several ranks (module docstring).  Returns rank 0's
    comparisons and every run's numbers."""
    res = {}
    release_groups(dist)             # phases 17-20's topologies
    x, y = pp_llama_batch()
    full = llama_config(LLAMA_PRESET)
    n32 = llama_param_count(full)
    n8 = llama_param_count(llama_config(LLAMA_PRESET,
                                        num_layers=LLAMA_LAYERS))
    tokens = PP_MICRO * LLAMA_SEQ
    # depth 8 against rank 0's one-card oracle: the plain accumulated step
    oracle = None
    if rank == 0:
        pl, opt = llama_pipe(LLAMA_LAYERS, dev)
        named = [(pp_model_name(n, LLAMA_LAYERS), p, opt)
                 for n, p in pl.named_parameters()]
        micro = list(zip(x.to(dev).split(1), y.to(dev).split(1)))
        losses, grads = [], {}
        for s in range(DIST_STEPS):
            total = None
            for xi, yi in micro:
                loss = pl._loss_fn(pl(xi), yi)
                (loss / PP_MICRO).backward()
                total = loss.detach().float() if total is None \
                    else total + loss.detach().float()
            if s == 0:
                grads = pp_grads(named)
            opt.step()
            opt.clear_grad()
            losses.append(float((total / PP_MICRO).float()))
        oracle = dict(losses=losses, grads=grads, values=pp_values(named))
        del pl, opt, named
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    run = pp_layer_run("pp4_depth8", dist, dict(pp_degree=4), "1F1B",
                       LLAMA_LAYERS, 1, (x, y), rank, world, timed=False,
                       grads=True)
    vals = pp_gather0(dist, rank, world, run.pop("values"))
    grads = pp_gather0(dist, rank, world, run.pop("grads"))
    if rank == 0:
        got = dict(losses=run["losses"], values=vals, grads=grads)
        bit = got["losses"] == oracle["losses"] and all(
            torch.equal(got[k][n], oracle[k][n]) for k in ("values", "grads")
            for n in oracle[k])
        res["depth8_vs_oracle"] = dist_compare(
            f"phase 21: LLaMA-2 7B pp 4 at depth {LLAMA_LAYERS} vs the "
            "one-card oracle", got, oracle, exact=False)
        res["depth8_vs_oracle"]["bit_equal"] = bit
        say(f"pipeline: depth {LLAMA_LAYERS} pp 4 bit-equal to the oracle: "
            f"{bit}")
    res["depth8"] = pp_summary(run, world, tokens, n8)
    del vals, grads, oracle, run
    # all 32 layers at pp 4 under each schedule; 1F1B's values the base
    base, base_losses = None, None
    for tag, mode, rc in PP_RUNS:
        run = pp_layer_run(f"pp4_{tag}", dist, dict(pp_degree=4), mode,
                           full.num_layers, rc, (x, y), rank, world)
        vals = run.pop("values")
        if base is None:
            base, base_losses = vals, run["losses"][:DIST_STEPS]
        else:
            if run["losses"][:DIST_STEPS] != base_losses:
                fail(f"pp4 {tag}: losses {run['losses'][:DIST_STEPS]} != "
                     f"1F1B's {base_losses}")
            run["vs_1f1b"] = pp_cross_compare(
                dist, rank, f"phase 21: pp 4 {tag} vs 1F1B at "
                f"{full.num_layers} layers", base, vals, exact=True)
        del vals
        res[f"pp4_{tag}"] = pp_summary(run, world, tokens, n32)
        res[f"pp4_{tag}"]["ranks"] = pp_rank_numbers(dist, run, world)
        say_rank0(rank, pp_line(f"pp4_{tag}", res[f"pp4_{tag}"], world))
        del run
    # mp 2 x pp 2 through llama_pipeline_step, against pp 4's 1F1B
    run = pp_llama_step_run("mp2_pp2", dist, full.num_layers, (x, y), rank,
                            world)
    vals, shards = run.pop("values"), run.pop("shards")
    lg, lw = run["losses"][:DIST_STEPS], base_losses
    worst = max(abs(a - b) for a, b in zip(lg, lw))
    say_rank0(rank, f"pipeline: mp2_pp2 vs pp 4 1F1B: losses {lg} against "
              f"{lw}")
    if not worst <= XCHECK_LOSS_TOL:
        fail(f"mp2_pp2: losses differ by {worst} from pp 4's")
    cmp = pp_cross_compare(dist, rank, "phase 21: mp 2 x pp 2 vs pp 4 at "
                           f"{full.num_layers} layers", base, vals,
                           split=shards.get, median_tol=None)
    cmp["loss_diff"] = worst
    res["mp2_pp2"] = pp_summary(run, world, tokens, n32)
    res["mp2_pp2"]["vs_pp4"] = cmp
    res["mp2_pp2"]["ranks"] = pp_rank_numbers(dist, run, world)
    say_rank0(rank, pp_line("mp2_pp2", res["mp2_pp2"], world))
    del base, vals, run
    # GPT-3 1.3B dp 2 x pp 2 against rank 0's one-card oracle
    gx, gy = pp_gpt_batch()
    oracle = None
    if rank == 0:
        _, model, opt, step = build_trainer(N_LAYERS, seed=0)
        shards = [(gx[j * PP_GPT_ROWS:(j + 1) * PP_GPT_ROWS].to(dev),
                   gy[j * PP_GPT_ROWS:(j + 1) * PP_GPT_ROWS].to(dev))
                  for j in range(PP_MICRO)]
        oracle = dist_oracle(model, opt, step, shards, timed=False)
        del model, opt, step, shards
    dist.barrier()
    run = pp_gpt_run(dist, rank, world)
    hcg_dp0 = [0, 1]                 # the dp rank 0 stages (ranks 0, 1)
    vals = pp_gather0(dist, rank, world, run.pop("values"), hcg_dp0)
    grads = pp_gather0(dist, rank, world, run.pop("grads"), hcg_dp0)
    gcfg = gpt_config("gpt3-1.3B", num_layers=N_LAYERS,
                      max_position_embeddings=TRAIN_SEQ)
    if rank == 0:
        got = dict(losses=run["losses"], values=vals, grads=grads)
        res["gpt_vs_oracle"] = dist_compare(
            "phase 21: GPT-3 1.3B dp 2 x pp 2 vs the one-card oracle", got,
            oracle, exact=False)
        res["gpt_oracle_losses"] = oracle["losses"]
    res["gpt_dp2_pp2"] = pp_summary(run, world,
                                    PP_MICRO * PP_GPT_ROWS * TRAIN_SEQ,
                                    param_count(gcfg))
    res["gpt_dp2_pp2"]["ranks"] = pp_rank_numbers(dist, run, world)
    say_rank0(rank, pp_line("gpt_dp2_pp2", res["gpt_dp2_pp2"], world))
    del vals, grads, oracle, run
    return res


def pp_line(key, m, world):
    """One phase 21 run's numbers on a line."""
    p, micro = m["degrees"]["pp_degree"], PP_MICRO
    line = (f"pipeline: {key} {m['degrees']} {m['mode']} (recompute "
            f"{m['recompute']}): {m['n_params']} parameters, {m['held']} "
            f"held tensors on rank 0; step ms "
            f"{[round(1e3 * t, 2) for t in m['step_s']]}")
    if "step_ms" in m:
        line += (f"; timed mean {m['step_ms']:.2f} ms = "
                 f"{m['tokens_s']:.1f} tokens/s over {world} cards, "
                 f"{m['tokens_s_card']:.1f} a card, MFU "
                 f"{100 * m['mfu']:.2f} % (6 N tokens a card / 989 TFLOP/s)")
    ranks = m.get("ranks", [])
    if ranks:
        idle = [r["idle"] for r in ranks]
        line += (f"; idle share a rank {[round(100 * i, 2) if i is not None else None for i in idle]} % "
                 f"(the bubble (P-1)/(M+P-1) = "
                 f"{100 * (p - 1) / (micro + p - 1):.1f} %), peak live "
                 f"residuals a rank {[r['peak_live_residuals'] for r in ranks]}"
                 f", retained graphs "
                 f"{[r['peak_retained_graphs'] for r in ranks]}, peak memory "
                 f"a rank {[round(r['peak_bytes'] / 2**30, 2) for r in ranks]}"
                 " GiB")
    if m.get("p2p_ms") is not None:
        line += f"; one step's p2p alone {m['p2p_ms']:.3f} ms"
    if ranks:
        line += (f"\npipeline: {key}: launches a rank over "
                 f"{len(m['step_s'])} steps "
                 f"{[r['launches'] for r in ranks]}")
    return line


# ---------------------------------------------------------------------------
# phase 22: ERNIE-MoE pretraining, at one card and under ep
# ---------------------------------------------------------------------------

MOE_BATCH, MOE_SEQ = 8, 512
MOE_STEPS = dict(cold=1, warmup=2, timed=5)
MOE_CLIP = 1.0
# the four-card runs: (tag, hybrid degrees); the same global batch
MOE_RUNS = (("ep4", dict(ep_degree=4)),
            ("dp2_ep2", dict(dp_degree=2, ep_degree=2)))


def moe_config():
    """``ernie-moe-base`` at full width and depth: 12 layers, hidden 768,
    12 heads, 64 experts in every 2nd block, GShard top-2, capacity
    factor 1.25, vocab 40000, 512 positions; dropout 0."""
    return ernie_moe_config("ernie-moe-base", hidden_dropout_prob=0.0,
                            attention_dropout_prob=0.0)


def moe_blocks(cfg) -> int:
    return sum((i + 1) % cfg.moe_every == 0 for i in range(cfg.num_layers))


def moe_param_count(cfg) -> int:
    """Every parameter of ``ErnieMoEForPretraining`` at ``cfg``."""
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    n_moe = moe_blocks(cfg)
    ffn = 2 * h * i + i + h
    return ((cfg.vocab_size + cfg.max_position_embeddings) * h + 2 * h
            + cfg.num_layers * (4 * h * h + 4 * h + 4 * h)
            + (cfg.num_layers - n_moe) * ffn
            + n_moe * (h * e + e + e * ffn))


def moe_tensor_count(cfg, experts_held) -> int:
    """The parameter tensors of a rank holding ``experts_held`` experts a
    MoE block: K3 launches once for each."""
    n_moe = moe_blocks(cfg)
    return (4 + cfg.num_layers * 8 + (cfg.num_layers - n_moe) * 4
            + n_moe * (2 + 4 * experts_held))


def moe_per_step(n_tensors):
    """One O2 step's launches: K1a-c once a layer (non-causal, d 64), K2a/b
    for the embedding's and each block's two LayerNorms, K3 once a
    parameter tensor of the rank; nothing else."""
    per = {k: 0 for k in PER_STEP}
    per.update(flash_fwd=12, flash_bwd_dq=12, flash_bwd_dkv=12, ln_fwd=25,
               ln_bwd_dx=25, adamw=n_tensors)
    return per


def moe_capacity(cfg, tokens) -> int:
    return max(int(math.ceil(cfg.top_k * tokens / cfg.num_experts
                             * cfg.capacity_factor)), 1)


def moe_step_flops(cfg, tokens, experts_held) -> int:
    """A rank's FLOPs a step (3 x forward): per token the qkv and output
    projections, the non-causal attention, the dense FFNs, the gates and
    the tied head; per MoE block the experts' capacity slots this rank
    computes, every one of them (``experts_held x cap`` rows, empty slots
    included)."""
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    n_moe = moe_blocks(cfg)
    cap = moe_capacity(cfg, MOE_BATCH * MOE_SEQ)
    per_token = (cfg.num_layers * (8 * h * h + 4 * MOE_SEQ * h)
                 + (cfg.num_layers - n_moe) * 4 * h * i + n_moe * 2 * h * e
                 + 2 * h * cfg.vocab_size)
    return 3 * (tokens * per_token + n_moe * experts_held * cap * 4 * h * i)


def moe_global_batch(cfg, dev):
    """The global batch: 8 x 512 ids, MLM labels ~30 % kept as
    ``tests/test_ernie_moe.py`` draws them."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ)).astype(
        np.int64)
    labels = ids.copy()
    labels[rs.rand(MOE_BATCH, MOE_SEQ) > 0.3] = -100
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev))


def moe_trainer(cfg):
    """The O2 model (seed 0: each expert from its own generator, so the
    same at any ep) and AdamW(1e-4, wd 0.01) with the MoE clip, built
    under the live topology."""
    model = ErnieMoEForPretraining(cfg, seed=0)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True,
                          grad_clip=ClipGradForMOEByGlobalNorm(MOE_CLIP))
    return amp.decorate(models=model, optimizers=opt, level="O2",
                        dtype="bfloat16")


def moe_dropped(model, group=None):
    """Each MoE block's (token, choice) pairs over capacity in the last
    forward, summed over the data ``group``'s ranks (the global batch)."""
    t = torch.stack([blk.ffn.dropped for blk in model.ernie.blocks
                     if blk.use_moe])
    if group is not None:
        torch.distributed.all_reduce(t, group=group.process_group)
    return [int(v) for v in t.tolist()]


def moe_steps(tag, step, batch, per_step, n):
    """``n`` steps, each one's launches held to ``per_step``; the losses,
    each step's seconds."""
    losses, step_s = [], []
    for i in range(n):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        moved = {k: counts()[k] - before[k] for k in per_step}
        if moved != per_step:
            fail(f"{tag} step {i}: launches {moved} != {per_step}")
    return losses, step_s


def check_moe_forms():
    """``MoELayer``'s index form against its one-hot einsum form on the
    card (8 experts of 64 -> 256 -> 64, GShard top-2, capacity factor
    0.75 so tokens drop, 512 tokens, fp32): outputs and every gradient
    within the card's fp32 tolerance (``KTOL``: the same products summed
    in another order); and with the even queue places moved one slot (a
    fault) the outputs must leave it."""
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    from paddle_tpu_torch.nn import GELU, Linear
    dev = card()
    g = torch.Generator(device=dev)
    g.manual_seed(22)
    experts = [torch.nn.Sequential(Linear(64, 256, generator=g, device=dev),
                                   GELU(),
                                   Linear(256, 64, generator=g, device=dev))
               for _ in range(8)]
    moe = MoELayer(64, experts, gate={"type": "gshard", "top_k": 2},
                   capacity_factor=0.75, generator=g, device=dev)
    x = torch.randn(8, 64, 64, device=dev, generator=g, requires_grad=True)
    gy = torch.randn(8, 64, 64, device=dev, generator=g)
    params = [x] + list(moe.parameters())
    y = moe(x)
    y2 = moe.forward_einsum(x)
    g1 = torch.autograd.grad(y, params, gy)
    g2 = torch.autograd.grad(y2, params, gy)
    pairs = [(y, y2)] + list(zip(g1, g2))
    err = max(max_err(a, b) for a, b in pairs)
    excess = max(close_excess(a, b, torch.float32) for a, b in pairs)
    real = moe_layer.route

    def shifted(*a, **kw):
        w, e, places, keep = real(*a, **kw)
        return w, e, torch.where(places % 2 == 0, places + 1, places), keep
    moe_layer.route = shifted
    try:
        shifted_y = moe(x)
    finally:
        moe_layer.route = real
    atol, rtol = KTOL[torch.float32]
    say(f"moe: index form vs einsum form on the card (fp32, {int(moe.dropped)}"
        f" of 1024 choices dropped): outputs and gradients max abs err "
        f"{err:.3e} (tol {atol} + {rtol} |x|); with the places shifted (a "
        f"fault) {max_err(shifted_y, y2):.3e}")
    if not excess <= 0:
        fail(f"moe: the index form is {err:.3e} from the einsum form")
    if not close_excess(shifted_y, y2, torch.float32) > 0:
        fail("moe: the forms' check missed shifted places")
    return err


def moe_summary(cfg, model, losses, step_s, warm, tokens, experts_held,
                group=None):
    """A run's numbers: step ms (the steps after ``warm``), global tokens
    per second, MFU of the rank's computed FLOPs (``moe_step_flops``)
    over 989 TFLOP/s, peak memory, dropped pairs a MoE block over the
    global batch (``group``: the data group)."""
    timed = step_s[warm:]
    mean_s = sum(timed) / len(timed)
    flops = moe_step_flops(cfg, tokens, experts_held)
    return dict(losses=losses, step_s=step_s, step_ms=1e3 * mean_s,
                tokens_s=MOE_BATCH * MOE_SEQ / mean_s,
                mfu=flops / mean_s / PEAK_BF16, step_flops=flops,
                peak_bytes=torch.cuda.max_memory_allocated(),
                dropped=moe_dropped(model, group),
                experts_held=experts_held,
                tokens_rank=tokens,
                cap=moe_capacity(cfg, MOE_BATCH * MOE_SEQ))


def moe_line(key, m, world):
    choices = MOE_BATCH * MOE_SEQ * 2
    return (f"moe: {key}: step ms {[round(1e3 * t, 2) for t in m['step_s']]};"
            f" timed mean {m['step_ms']:.2f} ms = {m['tokens_s']:.1f} tokens/s"
            f" over {world} card(s), MFU {100 * m['mfu']:.2f} % a card "
            f"({m['step_flops'] / 1e12:.3f} TFLOP a step a card: the "
            f"capacity slots computed, {m['experts_held']} experts x cap "
            f"{m['cap']} a MoE block, empty slots included; 989 TFLOP/s); "
            f"peak memory {m['peak_bytes']} bytes "
            f"({m['peak_bytes'] / 2**30:.2f} GiB a rank); dropped (token, "
            f"choice) pairs a MoE block {m['dropped']} of {choices} (the global "
            "batch's)"
            + (f"; the step's ep collectives alone {m['comm_ms']:.3f} ms"
               if m.get("comm_ms") is not None else "")
            + f"\nmoe: {key}: losses {m['losses']}; launches over "
            f"{len(m['step_s'])} steps {m['launches']}")


def moe_time_split(model, opt, batch):
    """Where a one-card step goes: one step written out with host clocks
    around its synchronised forward (with the loss), backward and
    optimizer step (the MoE clip's scale and AdamW), the clip's scale
    alone, then one step traced with ``torch.profiler``: its wall, the
    device's busy time and share, and the five ops with the most device
    time (self)."""
    model.train()

    def fwd():
        with amp.auto_cast(enable=True, level="O2", dtype="bfloat16"):
            return model.loss_fn(model(batch[0]), batch[1])
    out = {}
    for _ in range(2):                   # the second one is read
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fwd()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pg = [(p, p.grad) for p in model.parameters()]
        opt._grad_clip.scale(pg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del pg
        opt.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        opt.clear_grad()
        out = dict(forward_ms=1e3 * (t1 - t0), backward_ms=1e3 * (t2 - t1),
                   clip_scale_ms=1e3 * (t3 - t2),
                   optimizer_ms=1e3 * (t4 - t3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd().backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    by_name = {}
    for ev in prof.events():
        # the device's kernels and copies; a user annotation (such as the
        # optimizer's step range) spans them on the device's timeline
        if ev.device_type == DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            t, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (t + ev.time_range.elapsed_us(), n + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:5]
    out.update(traced_wall_ms=1e3 * wall, device_busy_ms=1e3 * busy,
               busy_share=busy / wall,
               top_device_ops=[(name[:60], round(t / 1e3, 3), n)
                               for name, (t, n) in top])
    say("moe: one card: a step's split (host clocks, synchronised): "
        + json.dumps(out))
    return out


def ernie_moe_main_path():
    """Phase 22 at one card: the forms' check, then ``ernie-moe-base`` O2
    through ``train_step`` for 1 cold, 2 warm-up and 5 timed steps with
    exact launches."""
    forms_err = check_moe_forms()
    cfg = moe_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt = moe_trainer(cfg)
    step = train_step(model, None, opt, step_fn=o2_step_fn)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    if n_params != moe_param_count(cfg) or \
            n_tensors != moe_tensor_count(cfg, cfg.num_experts):
        fail(f"ernie-moe-base has {n_params} parameters in {n_tensors} "
             "tensors")
    say(f"moe: ernie-moe-base, {n_params} parameters in {n_tensors} tensors,"
        f" O2 bf16 + fp32 masters, batch {MOE_BATCH} x {MOE_SEQ}, built in "
        f"{time.perf_counter() - t0:.3f} s")
    batch = moe_global_batch(cfg, card())
    reset_counts()                   # count the main path's launches only
    n = sum(MOE_STEPS.values())
    losses, step_s = moe_steps("moe", step, batch, moe_per_step(n_tensors),
                               n)
    launches = counts()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"moe: losses not finite and falling: {losses}")
    m = moe_summary(cfg, model, losses, step_s, MOE_STEPS["cold"]
                    + MOE_STEPS["warmup"], MOE_BATCH * MOE_SEQ,
                    cfg.num_experts)
    m.update(launches=launches, forms_err=forms_err, n_params=n_params)
    say(moe_line("one card", m, 1))
    m["split"] = moe_time_split(model, opt, batch)
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return m


def moe_comm_ms(hcg, cfg, tokens):
    """One step's ep collectives timed alone (CUDA events), at the dtypes
    the MoE layers move: a MoE block's combined output summed in fp32
    ``[tokens, H]``, its input's gradient in bf16 ``[tokens, H]`` and its
    combine weights' gradient in fp32 ``[tokens, k]`` (each an all-reduce
    over the ep group), and the MoE clip's sum of the experts' squares."""
    pg = hcg.get_expert_parallel_group().process_group
    dev = torch.cuda.current_device()
    y = torch.zeros(tokens * cfg.hidden_size, device=dev)
    dx = torch.zeros(y.numel(), dtype=torch.bfloat16, device=dev)
    dw = torch.zeros(tokens * cfg.top_k, device=dev)
    sq = torch.zeros(1, device=dev)

    def run():
        for _ in range(moe_blocks(cfg)):
            for t in (y, dx, dw):
                torch.distributed.all_reduce(t, group=pg)
        torch.distributed.all_reduce(sq, group=pg)
    return time_ms(run, 3)


def moe_masters(model, opt):
    """This rank's fp32 values on the card: each parameter's master, or
    the parameter (the LayerNorms, fp32)."""
    return {n: opt.state[p].get("master", p).detach().float()
            for n, p in model.named_parameters()}


def moe_first_step(step, model, opt, batch, step_fn=o2_step_fn):
    """``step``'s first call written out, to read this rank's averaged
    gradients before the optimizer step: the loss (averaged over the
    data ranks, as ``train_step`` returns it) and the gradients."""
    data = step._data
    if data is not None:
        batch = [data.rows(b) for b in batch]
        data.prepare()
    loss = step_fn(model, *batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    opt.step()
    opt.clear_grad()
    loss = loss.detach()
    return (data.mean(loss) if data is not None else loss), grads


def moe_steps_held(tag, step, model, opt, batch, per_step,
                   step_fn=o2_step_fn):
    """``DIST_STEPS`` steps, the first written out (``moe_first_step``),
    each one's launches held to ``per_step`` (None: not held); the losses
    (the global mean), each step's seconds, the first gradients."""
    losses, step_s = [], []
    for i in range(DIST_STEPS):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            loss, grads = moe_first_step(step, model, opt, batch, step_fn)
        else:
            loss = step(*batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if per_step is None:
            continue
        moved = {k: counts()[k] - before[k] for k in per_step}
        if moved != per_step:
            fail(f"{tag} step {i}: launches {moved} != {per_step}")
    return losses, step_s, grads


def fp32_step_fn(m, ids, labels):
    return m.loss_fn(m(ids), labels)


def moe_fp32_trainer(cfg):
    """``moe_trainer``'s model and optimizer in fp32: no amp, no
    masters."""
    model = ErnieMoEForPretraining(cfg, seed=0)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=ClipGradForMOEByGlobalNorm(MOE_CLIP))
    return model, opt


def moe_oracle(cfg, batch, fp32=False):
    """Rank 0's one-card oracle on cuda:0: the plain O2 ``train_step`` on
    the global batch (``fp32``: the fp32 model's, launches not held),
    ``DIST_STEPS`` steps (the first written out); the losses, the first
    gradients and the fp32 values on the host, and one card's step ms (3
    more steps)."""
    model, opt = moe_fp32_trainer(cfg) if fp32 else moe_trainer(cfg)
    step_fn = fp32_step_fn if fp32 else o2_step_fn
    step = train_step(model, None, opt, step_fn=step_fn)
    losses, _, grads = moe_steps_held(
        "moe oracle", step, model, opt, batch,
        None if fp32 else moe_per_step(len(list(model.parameters()))),
        step_fn)
    grads = {n: host(g) for n, g in grads.items()}
    values = {n: host(v) for n, v in moe_masters(model, opt).items()}
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, values=values, grads=grads,
                one_card_ms=1e3 * float(np.mean(ts[1:])))


def moe_to_rank0(dist, rank, world, tensors):
    """Every rank's ``tensors`` (name -> tensor on the card) on rank 0's
    host, sent over NCCL one rank at a time, tensor by tensor (a
    collective call); None on the other ranks."""
    names = [None] * world
    dist.all_gather_object(names, [(n, tuple(t.shape), str(t.dtype))
                                   for n, t in sorted(tensors.items())])
    got = {0: {n: host(t) for n, t in tensors.items()}} if rank == 0 \
        else None
    for q in range(1, world):
        dist.barrier()
        if rank == q:
            for n, _, _ in names[q]:
                torch.distributed.send(tensors[n].contiguous(), 0)
            torch.cuda.synchronize()
        elif rank == 0:
            got[q] = {}
            for n, shape, dtype in names[q]:
                v = torch.empty(shape, dtype=getattr(torch, dtype[6:]),
                                device=card())
                torch.distributed.recv(v, q)
                got[q][n] = host(v)
                del v
    dist.barrier()
    return got


def grad_rel(got, want) -> float:
    """``|got - want| / |want|`` (2-norms, fp32 on the card)."""
    w = want.cuda().float()
    return ((got.cuda().float() - w).norm()
            / w.norm().clamp(min=1e-30)).item()


def moe_compare(tag, vals, grads, oracle, ep_groups, median_gate):
    """Rank 0: every rank's fp32 values after ``DIST_STEPS`` steps against
    the oracle's (each within ``DIST_PARAM_MAX``; each tensor's median
    within ``DIST_PARAM_MEDIAN`` when ``median_gate``, else measured),
    its first gradients by relative norm (``GRAD_REL_TOL``), the dense
    values and gradients bit-identical within each ep group, and each
    rank holding exactly its ``E / ep`` experts."""
    e = moe_config().num_experts
    maxes, medians, rels = {}, {}, {}
    for q, mine in vals.items():
        grp = next(g for g in ep_groups if q in g)
        per = e // len(grp)
        j = grp.index(q)
        held = {int(n.split(".ffn.experts.")[1].split(".")[0])
                for n in mine if ".ffn.experts." in n}
        if held != set(range(j * per, (j + 1) * per)):
            fail(f"moe {tag}: rank {q} holds experts {sorted(held)}")
        for n, v in mine.items():
            d = (v.cuda() - oracle["values"][n].cuda()).abs()
            maxes[f"{q}:{n}"] = d.max().item()
            medians[f"{q}:{n}"] = d.median().item()
            rels[f"{q}:{n}"] = grad_rel(grads[q][n], oracle["grads"][n])
            del d
    for what, by_rank in (("values", vals), ("first gradients", grads)):
        for grp in ep_groups:
            for n, a in by_rank[grp[0]].items():
                if ".ffn.experts." in n:
                    continue
                for q in grp[1:]:
                    if not torch.equal(by_rank[q][n], a):
                        fail(f"moe {tag}: {what} of {n} differ between "
                             f"ranks {grp[0]} and {q} of one ep group")
    everywhere = all(torch.equal(vals[q][n], vals[0][n]) for q in vals
                     for n in vals[0] if ".ffn.experts." not in n)
    mx, med, rel = (max(d.values()) for d in (maxes, medians, rels))
    over = sorted((k for k, v in medians.items() if v > DIST_PARAM_MEDIAN),
                  key=medians.get, reverse=True)
    exact = all(torch.equal(v, oracle["values"][n]) for mine in vals.values()
                for n, v in mine.items())
    res = dict(value_max=mx, value_median=med, over_median=len(over),
               tensors=len(medians), grad_rel=rel,
               dense_equal_everywhere=everywhere, bit_equal=exact)
    say(f"moe: {tag}: against the oracle after {DIST_STEPS} steps: values "
        f"bit-equal {exact}; worst max diff {mx:.3e} "
        f"({max(maxes, key=maxes.get)}; tol {DIST_PARAM_MAX:.2e}); worst "
        f"median {med:.3e} ({DIST_PARAM_MEDIAN:.3e} "
        + ("held" if median_gate else "measured") + f"; {len(over)} of "
        f"{len(medians)} tensors over it: "
        + ", ".join(f"{k} {medians[k]:.3e}" for k in over[:3])
        + f"); first gradients' relative error worst {rel:.3e} "
        f"({max(rels, key=rels.get)}; tol {GRAD_REL_TOL}); dense values "
        f"and gradients bit-identical within each ep group, values across "
        f"every rank: {everywhere}")
    if not (mx <= DIST_PARAM_MAX and rel <= GRAD_REL_TOL):
        fail(f"moe {tag}: values or first gradients differ from the oracle")
    if median_gate and not med <= DIST_PARAM_MEDIAN:
        fail(f"moe {tag}: value medians differ from the oracle")
    return res


def moe_dist_run(tag, dist, hcg, cfg, batch, rank, world, oracle):
    """One topology's run: ``train_step(mesh=...)`` on the global batch,
    ``DIST_STEPS`` steps held against the oracle (losses 0.0625 and equal
    on every rank; values and first gradients by ``moe_compare``; the
    value medians held at ep 4, whose gradients sum nothing over dp, and
    measured at dp 2 x ep 2, whose witnesses ``moe_witnesses`` runs),
    then ``DIST_TIMED`` more, the last timed."""
    torch.cuda.reset_peak_memory_stats()
    model, opt = moe_trainer(cfg)
    step = train_step(model, None, opt, mesh=hcg.mesh, step_fn=o2_step_fn)
    ep = hcg.get_expert_parallel_world_size()
    dp = hcg.get_data_parallel_world_size()
    held = cfg.num_experts // ep
    n_tensors = len(list(model.parameters()))
    if n_tensors != moe_tensor_count(cfg, held):
        fail(f"moe {tag}: rank {rank} holds {n_tensors} tensors")
    per_step = moe_per_step(n_tensors)
    reset_counts()
    losses, step_s, grads = moe_steps_held(f"moe {tag}", step, model, opt,
                                           batch, per_step)
    every = [None] * world
    dist.all_gather_object(every, losses)
    if any(l != losses for l in every):
        fail(f"moe {tag}: the ranks' losses differ: {every}")
    ep_groups = [None] * world
    dist.all_gather_object(ep_groups, hcg.get_expert_parallel_group().ranks)
    vals = moe_to_rank0(dist, rank, world, moe_masters(model, opt))
    grads = moe_to_rank0(dist, rank, world, grads)
    res = {}
    if rank == 0:
        worst = max(abs(a - b) for a, b in zip(losses, oracle["losses"]))
        say(f"moe: {tag}: losses {losses} against the oracle's "
            f"{oracle['losses']} (worst {worst:.3e}, tol "
            f"{XCHECK_LOSS_TOL})")
        if not worst <= XCHECK_LOSS_TOL:
            fail(f"moe {tag}: losses differ by {worst}")
        res = moe_compare(tag, vals, grads, oracle,
                          sorted(set(map(tuple, ep_groups))),
                          median_gate=dp == 1)
        res["loss_diff"] = worst
    del vals, grads
    dist.barrier()
    more, more_s = moe_steps(f"moe {tag}", step, batch, per_step,
                             sum(DIST_TIMED.values()))
    losses, step_s = losses + more, step_s + more_s
    launches = counts()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"moe {tag}: losses not finite and falling: {losses}")
    m = moe_summary(cfg, model, losses, step_s,
                    DIST_STEPS + DIST_TIMED["warmup"],
                    MOE_BATCH * MOE_SEQ // dp, held,
                    hcg.get_data_parallel_group() if dp > 1 else None)
    m.update(res, launches=launches, degrees=dict(ep=ep, dp=dp),
             comm_ms=moe_comm_ms(hcg, cfg, MOE_BATCH * MOE_SEQ // dp))
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return m


def moe_per_rank_plan(self, xf):
    """The control's ``MoELayer._plan``: capacity and queue places from
    this rank's tokens alone, as the upstream GPU MoE computes them (a
    different result from the global batch's)."""
    cap = self._capacity(xf.shape[0], None)
    logits, _ = self.gate(xf)
    return moe_layer.route(logits, self.top_k, cap, None) + (cap,)


def moe_control(dist, hcg, cfg, batch, rank, world, oracle):
    """The per-rank-capacity control at dp 2 x ep 2: one O2 step's
    averaged gradients with ``moe_per_rank_plan``; rank 0: their worst
    relative error against the oracle's first gradients, which must
    leave ``GRAD_REL_TOL`` (else that bound does not see this fault)."""
    real = MoELayer._plan
    MoELayer._plan = moe_per_rank_plan
    try:
        model, opt = moe_trainer(cfg)
        step = train_step(model, None, opt, mesh=hcg.mesh,
                          step_fn=o2_step_fn)
        loss, grads = moe_first_step(step, model, opt, batch)
    finally:
        MoELayer._plan = real
    loss = float(loss)
    del model, opt, step
    grads = moe_to_rank0(dist, rank, world, grads)
    res = {}
    if rank == 0:
        rels = {f"{q}:{n}": grad_rel(g, oracle["grads"][n])
                for q, mine in grads.items() for n, g in mine.items()}
        worst = max(rels, key=rels.get)
        res = dict(grad_rel=rels[worst], worst=worst,
                   over=sum(v > GRAD_REL_TOL for v in rels.values()),
                   tensors=len(rels), loss=loss,
                   loss_diff=abs(loss - oracle["losses"][0]))
        say(f"moe: dp2_ep2 per-rank-capacity control: first loss {loss} "
            f"(oracle {oracle['losses'][0]}); first gradients' relative "
            f"error worst {rels[worst]:.3e} ({worst}), {res['over']} of "
            f"{len(rels)} tensors over {GRAD_REL_TOL}")
        if not rels[worst] > GRAD_REL_TOL:
            fail("moe: the first gradients' bound does not see capacity "
                 "per dp rank")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def moe_fp32_run(dist, hcg, cfg, batch, rank, world, oracle):
    """The fp32 witness: dp 2 x ep 2 in fp32, ``DIST_STEPS`` steps held
    against the fp32 oracle (losses 0.0625, ``moe_compare`` with the
    value medians held)."""
    model, opt = moe_fp32_trainer(cfg)
    step = train_step(model, None, opt, mesh=hcg.mesh, step_fn=fp32_step_fn)
    losses, step_s, grads = moe_steps_held("moe dp2_ep2 fp32", step, model,
                                           opt, batch, None, fp32_step_fn)
    ep_groups = [None] * world
    dist.all_gather_object(ep_groups, hcg.get_expert_parallel_group().ranks)
    vals = moe_to_rank0(dist, rank, world, moe_masters(model, opt))
    grads = moe_to_rank0(dist, rank, world, grads)
    res = {}
    if rank == 0:
        worst = max(abs(a - b) for a, b in zip(losses, oracle["losses"]))
        say(f"moe: dp2_ep2 fp32: losses {losses} against the fp32 "
            f"oracle's {oracle['losses']} (worst {worst:.3e}, tol "
            f"{XCHECK_LOSS_TOL}); step ms "
            f"{[round(1e3 * t, 2) for t in step_s]}")
        if not worst <= XCHECK_LOSS_TOL:
            fail(f"moe dp2_ep2 fp32: losses differ by {worst}")
        res = moe_compare("dp2_ep2 fp32", vals, grads, oracle,
                          sorted(set(map(tuple, ep_groups))),
                          median_gate=True)
        res["loss_diff"] = worst
    del model, opt, step, vals, grads
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def moe_witnesses(dist, rank, world, cfg, batch, oracle):
    """Why dp 2 x ep 2's value medians are measured, not held: the
    per-rank-capacity control against the O2 oracle (``moe_control``),
    then the same layout in fp32 against an fp32 oracle built on rank 0
    (``moe_fp32_run``); each topology's groups freed after it."""
    degrees = dict(MOE_RUNS)["dp2_ep2"]
    hcg = fleet_init(degrees)
    res = {"control": moe_control(dist, hcg, cfg, batch, rank, world,
                                  oracle)}
    fleet_reset()
    release_groups(dist)
    oracle32 = moe_oracle(cfg, batch, fp32=True) if rank == 0 else None
    dist.barrier()
    hcg = fleet_init(degrees)
    res["fp32"] = moe_fp32_run(dist, hcg, cfg, batch, rank, world, oracle32)
    fleet_reset()
    release_groups(dist)
    if oracle32 is not None:
        res["fp32"]["oracle_losses"] = oracle32["losses"]
    return res


def moe_rank(dist, rank, world, dev):
    """Phase 22 on several cards: rank 0's one-card oracle, then ep 4 and
    dp 2 x ep 2, then dp 2 x ep 2's witnesses, each topology's groups
    freed before the next."""
    cfg = moe_config()
    batch = moe_global_batch(cfg, dev)
    oracle = moe_oracle(cfg, batch) if rank == 0 else None
    dist.barrier()
    res = {}
    if oracle is not None:
        res["oracle_losses"] = oracle["losses"]
        res["one_card_ms"] = oracle["one_card_ms"]
    for tag, degrees in MOE_RUNS:
        hcg = fleet_init(degrees)
        res[tag] = moe_dist_run(tag, dist, hcg, cfg, batch, rank, world,
                                oracle)
        fleet_reset()
        release_groups(dist)
        if rank == 0:
            say(moe_line(tag, res[tag], world))
    if oracle is not None:
        del oracle["values"]
    res["witness"] = moe_witnesses(dist, rank, world, cfg, batch, oracle)
    return res


def moe_report(m, world):
    """Phase 22's numbers on several cards, from rank 0's results."""
    say(f"moe: one card's plain step in this call {m['one_card_ms']:.2f} ms;"
        f" the oracle's losses {m['oracle_losses']}")
    keys = ("loss_diff", "bit_equal", "value_max", "value_median",
            "over_median", "tensors", "grad_rel", "dense_equal_everywhere")
    for tag, _ in MOE_RUNS:
        say(moe_line(tag, m[tag], world))
        say(f"moe: {tag}: against the oracle: " + json.dumps(
            {k: m[tag][k] for k in keys}))
    w = m["witness"]
    say("moe: dp2_ep2 per-rank-capacity control against the oracle: "
        + json.dumps(w["control"]))
    say("moe: dp2_ep2 fp32 against the fp32 oracle: " + json.dumps(
        {k: w["fp32"][k] for k in keys + ("oracle_losses",)}))


def moe_alone() -> int:
    """``--moe``: phase 22 alone after the build: at one card its
    one-card part, on several cards the ranks (ep 4, dp 2 x ep 2)."""
    say(f"build: {_build.build_all():.3f} s")
    if torch.cuda.device_count() == 1:
        ernie_moe_main_path()
    else:
        distributed_main_path((22,))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 23: the hybrid global-norm clip and GradScaler (--amp-clip)
# ---------------------------------------------------------------------------

AC_CLIP = 1.0                    # examples 03 and 04's ClipGradByGlobalNorm
AC_SCALE = 2.0 ** 10             # example 03's init_loss_scaling
AC_POISON = DIST_STEPS           # the step one rank's gradient is poisoned
AC_POISON_RANK = 3               # that rank (at one card: rank 0)
# the clip's norm against the fp64 oracle: both square the same gradients,
# the clip sums in fp32 (a tree a tensor, then over tensors and ranks),
# the oracle in fp64 by name
AC_NORM_RTOL = 1e-4
AC_SHARE_MISS = 1e-3             # a rank's own share misses by more


def ac_sq_sums(items):
    """``{name: (sum of squares in fp64, summed over ranks)}`` of
    ``items`` ``(name, tensor, summed)``, one host read."""
    if not items:
        return {}
    sums = torch.stack([t.detach().double().square().sum()
                        for _, t, _ in items]).tolist()
    return {n: (v, summed) for (n, _, summed), v in zip(items, sums)}


def ac_grad_parts(named, summed):
    """This rank's parts of the squared norm from whole gradients
    (``named``: ``(name, parameter)``; ``summed(p)``: a shard whose parts
    add over the ranks, as an mp split)."""
    return ac_sq_sums([(n, p.grad, summed(p)) for n, p in named
                       if p.grad is not None])


def ac_shard_parts(sopt, names):
    """This rank's parts from its ZeRO gradient shards: each parameter's
    slot of a bucket cut to the rank's shard (``names``: id -> name)."""
    items = []
    for _, b in sopt._ready():
        lo, hi = sopt._shard(b)
        g = sopt._grad_shard(b)
        for p, off in zip(b.params, b.offsets):
            a, e = max(off, lo), min(off + p.numel(), hi)
            if a < e:
                items.append((names[id(p)], g[a - lo:e - lo], True))
    return ac_sq_sums(items)


def ac_norm_oracle(dist, parts):
    """The norm's oracle: every rank's parts gathered by name (``dist``
    None: this process's alone), a summed name's parts added, any other
    counted once; and the largest relative spread between the copies
    of a name counted once (replicated gradients must agree)."""
    everyone = [parts]
    if dist is not None:
        everyone = []
        dist.all_gather_object(everyone, parts)
    total, seen, spread = 0.0, {}, 0.0
    for part in everyone:
        for n, (v, summed) in part.items():
            if summed or n not in seen:
                total += v
                seen.setdefault(n, v)
            else:
                spread = max(spread, abs(v - seen[n]) / max(seen[n], 1e-300))
    return math.sqrt(total), spread


def ac_fingerprint(tensors):
    """Each tensor's raw bits summed as int64 and its fp64 sum of
    magnitudes (one host read): a step that moved nothing leaves them
    all equal, an update changes them."""
    bits, mags = [], []
    for t in tensors:
        flat = t.detach().reshape(-1)
        view = flat.view(torch.int16 if flat.element_size() == 2
                         else torch.int32)
        bits.append(view.to(torch.int64).sum())
        mags.append(flat.double().abs().sum())
    if not bits:
        return []
    return torch.stack(bits).tolist() + torch.stack(mags).tolist()


def ac_poison(scaler, rank, world, armed):
    """Make rank ``min(AC_POISON_RANK, world - 1)``'s ``scaler.unscale_``
    set one element of its last gradient (or gradient shard) to inf while
    ``armed[0]``, after the reductions: the other ranks' are clean.
    Returns that rank."""
    victim = min(AC_POISON_RANK, world - 1)
    unscale = scaler.unscale_

    def poisoned(opt):
        if armed[0] and rank == victim:
            with torch.no_grad():
                opt._unscale_targets()[-1].view(-1)[0] = float("inf")
        unscale(opt)
    scaler.unscale_ = poisoned
    return victim


def ac_all(dist, flag: bool) -> bool:
    """``flag`` on every rank (``dist`` None: this process's)."""
    if dist is None:
        return flag
    t = torch.tensor([1 if flag else 0], device=card())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def ac_gather(dist, value):
    if dist is None:
        return [value]
    out = []
    dist.all_gather_object(out, value)
    return out


def ac_run(tag, dist, rank, world, step, first, expected, clip,
           scaler=None, state=None, values=None):
    """Phase 23's held steps of one leg on this rank (each ends in a
    synchronise, its launches equal ``expected(skipped)``): ``first()``
    writes the first step out and returns its loss and this rank's parts
    of the squared norm (taken after the reductions and the unscale,
    before the clip), whose oracle (``ac_norm_oracle``) the clip's norm
    must meet within ``AC_NORM_RTOL`` while the rank's own share misses it
    (more than one rank); ``step()`` the others, ``DIST_STEPS`` in all.
    With a ``scaler``: the next step's gradient is poisoned on one rank,
    and every rank must skip it (``state()``'s tensors' fingerprints
    unchanged, the scale halved, only that rank's own flag raised), then
    the step after trains (the same loss, the tensors moved).
    ``values()`` after the held steps (rank 0's comparison)."""
    out = dict(tag=tag, losses=[], step_s=[], scales=[])
    armed = [False]
    victim = ac_poison(scaler, rank, world, armed) if scaler else None
    n = DIST_STEPS + (2 if scaler else 0)
    reset_counts()                   # count the main path's launches only
    fp0 = None
    peak = 0
    for s in range(n):
        skip = scaler is not None and s == AC_POISON
        if skip:
            fp0 = ac_fingerprint(state())
            armed[0] = True
        reads = scaler.host_reads if scaler else 0
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if s == 0:
            loss, parts = first()
        else:
            loss = step()
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        armed[0] = False
        want = expected(skip)
        after = counts()
        moved = {k: after[k] - before[k] for k in want}
        if moved != want:
            fail(f"rank {rank} {tag} step {s}: launches {moved} != {want}")
        out["losses"].append(float(loss.float()))
        if scaler:
            out["scales"].append(float(scaler._scale))
            out["host_reads_a_step"] = scaler.host_reads - reads
            if scaler.host_reads - reads != 1:
                fail(f"{tag} step {s}: {scaler.host_reads - reads} host "
                     "reads for the scaler's decision, not 1")
        if s == 0:
            norm, spread = ac_norm_oracle(dist, parts)
            got = float(clip.last_norm)
            shares = ac_gather(dist, float(clip.last_local_norm))
            out.update(norm=got, oracle_norm=norm, replicated_spread=spread,
                       shares=shares, norm_rel=abs(got - norm) / norm)
            say_rank0(rank, f"amp_clip: {tag}: the clip's norm {got!r}, "
                      f"the fp64 oracle's {norm!r} (relative gap "
                      f"{out['norm_rel']:.3e}, tol {AC_NORM_RTOL:.0e}); each "
                      f"rank's own share {shares}; replicated copies' "
                      f"largest spread {spread:.3e}")
            if not out["norm_rel"] <= AC_NORM_RTOL:
                fail(f"{tag}: the clip's norm {got} misses the oracle's "
                     f"{norm}")
            if spread > 1e-6:
                fail(f"{tag}: replicated gradients differ across ranks "
                     f"({spread:.3e})")
            if world > 1 and not all(abs(v - norm) > AC_SHARE_MISS * norm
                                     for v in shares):
                fail(f"{tag}: the control: a rank's own share {shares} "
                     f"meets the global norm {norm}")
        if skip:
            same = ac_all(dist, ac_fingerprint(state()) == fp0)
            flags = ac_gather(dist, float(scaler._local_found_inf))
            out.update(skip_bit_equal=same, local_flags=flags)
            say_rank0(rank, f"amp_clip: {tag}: step {s} poisoned on rank "
                      f"{victim}: every rank's parameters, masters and "
                      f"moments unchanged: {same}; scale {out['scales']}; "
                      f"each rank's own flag before the all-reduce "
                      f"{flags}")
            if not same:
                fail(f"{tag}: a rank's state moved on the skipped step")
            if flags != [1.0 if r == victim else 0.0 for r in range(world)]:
                fail(f"{tag}: the own flags {flags}: only rank {victim} "
                     "should see its poison")
            if out["scales"][-1] != out["scales"][-2] / 2:
                fail(f"{tag}: the scale {out['scales']} was not halved")
        if scaler and s == AC_POISON + 1:
            trained = ac_all(dist, ac_fingerprint(state()) != fp0)
            out["next_trains"] = trained
            if out["losses"][-1] != out["losses"][-2] or not trained:
                fail(f"{tag}: the step after the skip: losses "
                     f"{out['losses']}, moved {trained}")
        if s == DIST_STEPS - 1:
            peak = torch.cuda.max_memory_allocated()
            if values is not None:
                v = values()
                if rank == 0:
                    out["values"] = v
                del v
            torch.cuda.empty_cache()
    out["launches"] = counts()
    out["peak_held"] = peak
    return out


def ac_timed(tag, step, expected, rank):
    """``DIST_TIMED`` steps of ``step()``, each synchronised with exact
    launches; the timed ones' mean host ms."""
    step_s = []
    for s in range(sum(DIST_TIMED.values())):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        want = expected(False)
        after = counts()
        moved = {k: after[k] - before[k] for k in want}
        if moved != want:
            fail(f"rank {rank} {tag} timed step {s}: launches {moved} != "
                 f"{want}")
    return 1e3 * float(np.mean(step_s[DIST_TIMED["warmup"]:]))


def ac_finish(dist, out, world, tokens, n_params, base, timed_ms,
              plain_ms, clip_ms, scaler_ms):
    """A leg's numbers: step ms with the clip (and scaler) and without,
    tokens/s, MFU (6 N tokens a card over 989 TFLOP/s), peak memory a rank
    (the largest), the clip's and the scaler's own ms."""
    mem = torch.tensor([max(out.pop("peak_held"),
                            torch.cuda.max_memory_allocated()), base],
                       device=card())
    if dist is not None:
        dist.all_reduce(mem, op=dist.ReduceOp.MAX)
    out["peak_bytes"], out["base_bytes"] = (int(v) for v in mem.tolist())
    out.update(step_ms=timed_ms, plain_step_ms=plain_ms, clip_ms=clip_ms,
               scaler_ms=scaler_ms, tokens_s=tokens / (timed_ms / 1e3),
               n_params=n_params)
    out["tokens_s_card"] = out["tokens_s"] / world
    out["mfu"] = 6 * n_params * out["tokens_s_card"] / PEAK_BF16
    return out


def ac_gpt_build(cfg):
    """Example 03's stack on phase 17's GPT-3 1.3B: AdamW(1e-4, wd 0.01,
    fp32 masters) with ``ClipGradByGlobalNorm(AC_CLIP)``, amp O2 bf16."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    model = GPTForPretraining(cfg, seed=0)
    clip = ClipGradByGlobalNorm(AC_CLIP)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True,
                          grad_clip=clip)
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16")
    return model, opt, clip


def ac_gpt_config():
    return gpt_config("gpt3-1.3B", num_layers=N_LAYERS,
                      max_position_embeddings=TRAIN_SEQ,
                      hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def ac_gpt_oracle(cfg, batch, world, dev):
    """Rank 0's one-card oracle of leg (a): the same stack and scaler on
    the global batch, its ``world`` shards accumulated (each scaled loss
    over their count), ``DIST_STEPS`` steps: losses, fp32 values, the
    first step's norm and its fp64 oracle."""
    model, opt, clip = ac_gpt_build(cfg)
    model.train()
    scaler = amp.GradScaler(init_loss_scaling=AC_SCALE)
    shards = [dist_shard(batch, j, dev) for j in range(world)]
    named = list(model.named_parameters())
    losses = []
    for s in range(DIST_STEPS):
        total = 0.0
        for ids, labels in shards:
            loss = o2_step_fn(model, ids, labels)
            scaler.scale(loss / world).backward()
            total += float(loss.detach()) / world
        if s == 0:
            scaler.unscale_(opt)
            norm, _ = ac_norm_oracle(None, ac_grad_parts(named,
                                                         lambda p: False))
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        if s == 0:
            first = float(clip.last_norm)
        losses.append(total)
    values = dist_values(model, opt, False)
    say(f"amp_clip: the one-card oracle: losses {losses}, the first "
        f"step's norm {first!r} (fp64 oracle {norm!r})")
    if not abs(first - norm) <= AC_NORM_RTOL * norm:
        fail(f"the oracle's norm {first} misses its fp64 sum {norm}")
    del model, opt, named
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, values=values, norm=first, oracle_norm=norm)


def ac_gpt_leg(dist, rank, world, dev, oracle):
    """Leg (a): example 03 at full width, GPT-3 1.3B O2 under dp 2 x
    sharding 2, stage 2 (``group_sharded_parallel("os_g")`` over the dp x
    sharding group) with the clip and ``GradScaler(AC_SCALE)`` through
    ``train_step(scaler=, mesh=hcg.mesh)`` on phase 17's global batch;
    against rank 0's one-card oracle (losses and values, phase 17's
    bounds); the poison; timed with and without the clip and scaler."""
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    dist_settle(dist)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = ac_gpt_config()
    batch = dist_global_batch(cfg, world)
    hcg = fleet_init(dict(dp_degree=2, sharding_degree=world // 2))
    model, opt, clip = ac_gpt_build(cfg)
    scaler = amp.GradScaler(init_loss_scaling=AC_SCALE)
    model, sopt, scaler = group_sharded_parallel(
        model, opt, "os_g", scaler=scaler,
        group=hcg.get_dp_sharding_parallel_group())
    step = train_step(model, None, sopt, scaler=scaler, mesh=hcg.mesh,
                      step_fn=o2_step_fn)
    local = [step._data.rows(t.to(dev)) for t in batch]
    names = {id(p): n for n, p in model._layers.named_parameters()}
    buckets = sopt._reducer.buckets

    def first():
        loss = o2_step_fn(model, *local)
        scaler.scale(loss).backward()
        scaler.unscale_(sopt)
        parts = ac_shard_parts(sopt, names)
        scaler.step(sopt)
        scaler.update()
        sopt.clear_grad()
        return step._data.mean(loss.detach()), parts

    def expected(skip):
        return dict(PER_STEP, adamw=0 if skip else len(buckets))

    def state():
        return [b.param_buf for b in buckets] + [
            v for st in sopt._state.values() for v in st.values()]
    out = ac_run("gpt_dp2_sh2_os_g", dist, rank, world,
                 lambda: step(*batch), first, expected, clip, scaler, state,
                 lambda: dist_values(model, sopt, True, rank))
    out["buckets"] = len(buckets)
    if rank == 0:
        out["vs_oracle"] = dist_compare(
            "phase 23 (a): GPT-3 1.3B dp 2 x sharding 2 os_g + clip + "
            "scaler vs the one-card oracle", out, oracle, exact=False)
        out["oracle_norm_rel"] = abs(out["norm"] - oracle["norm"]) \
            / oracle["norm"]
        say(f"amp_clip: (a): the four cards' first norm {out['norm']!r} "
            f"against the one-card oracle's {oracle['norm']!r} (relative "
            f"{out['oracle_norm_rel']:.3e})")
    out.pop("values", None)
    timed_ms = ac_timed("gpt (a)", lambda: step(*batch), expected,
                        rank)
    loss = o2_step_fn(model, *local)       # gradients for the own times
    scaler.scale(loss).backward()

    def unscale():
        scaler._unscaled = False
        scaler.unscale_(sopt)
    scaler_ms = time_ms(unscale, 3)
    clip_ms = time_ms(lambda: sopt._clip(sopt._ready()), 3)
    sopt.clear_grad()
    scaler.update()
    sopt._inner_opt._grad_clip = None       # the same step without them
    plain = train_step(model, None, sopt, mesh=hcg.mesh, step_fn=o2_step_fn)
    plain_ms = ac_timed("gpt (a) without", lambda: plain(*batch),
                        expected, rank)
    out = ac_finish(dist, out, world, batch[0].numel(),
                    param_count(cfg), base, timed_ms, plain_ms, clip_ms,
                    scaler_ms)
    del model, opt, sopt, step, plain, local
    fleet_reset()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ac_tp_leg(dist, rank, world, dev):
    """Leg (b): example 04's layers at full width, LLaMA-2 7B O2 at all 32
    layers under mp 4 with SP and recompute, the clip in the hybrid
    optimizer, through ``train_step(mesh=hcg.mesh)`` on phase 19's batch;
    timed with and without the clip."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        .mp_layers import is_split
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    dist_settle(dist)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = llama_config(LLAMA_PRESET)
    hcg = fleet_init(dict(mp_degree=world))
    cfg = llama_config(LLAMA_PRESET, sequence_parallel=True,
                       use_recompute=True)
    model = LlamaForCausalLM(cfg, seed=0)
    clip = ClipGradByGlobalNorm(AC_CLIP)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01, multi_precision=True,
                          grad_clip=clip)
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16")
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    inner = model._layers
    step = train_step(model, None, opt, mesh=hcg.mesh, step_fn=o2_step_fn)
    rs = np.random.RandomState(0)
    batch = tuple(torch.from_numpy(rs.randint(0, full.vocab_size,
                                              (LLAMA_BATCH, LLAMA_SEQ)))
                  for _ in range(2))
    local = [step._data.rows(t.to(dev)) for t in batch]
    named = list(inner.named_parameters())

    def first():
        loss = o2_step_fn(model, *local)
        loss.backward()
        opt._reduce_once()
        parts = ac_grad_parts(named, is_split)
        opt.step()
        opt.clear_grad()
        return step._data.mean(loss.detach()), parts

    def expected(skip):
        return llama_per_step(full.num_layers, recompute=True)
    out = ac_run("llama_mp4_sp_rc", dist, rank, world, lambda: step(*batch),
                 first, expected, clip)
    timed_ms = ac_timed("llama (b)", lambda: step(*batch), expected,
                        rank)
    loss = o2_step_fn(model, *local)       # gradients for the clip's time
    loss.backward()
    opt._reduce_once()
    pg = [(p, p.grad) for _, p in named if p.grad is not None]
    clip_ms = time_ms(lambda: clip._clip_(pg, device=dev), 3)
    del pg
    opt.clear_grad()
    opt._inner_opt._grad_clip = None
    plain_ms = ac_timed("llama (b) without", lambda: step(*batch),
                        expected, rank)
    out = ac_finish(dist, out, world, batch[0].numel(),
                    llama_param_count(full), base, timed_ms, plain_ms,
                    clip_ms, None)
    del model, opt, step, inner, named, local
    fleet_reset()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ac_pp_leg(dist, rank, world, dev):
    """Leg (c): LLaMA-2 7B O2 at all 32 layers as phase 21's
    ``PipelineLayer`` at pp 4 under 1F1B (8 micro-batches of 1 x 4096,
    each layer recomputed), the clip in its AdamW and
    ``GradScaler(AC_SCALE)`` through ``train_batch(scaler=)``; the
    poison; timed with and without the clip and scaler."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    dist_settle(dist)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = llama_config(LLAMA_PRESET)
    layers = full.num_layers
    hcg = pp_fleet_init(dict(pp_degree=world), "1F1B")
    clip = ClipGradByGlobalNorm(AC_CLIP)
    pl, opt = llama_pipe(layers, dev, recompute=1, grad_clip=clip)
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(opt)
    scaler = amp.GradScaler(init_loss_scaling=AC_SCALE)
    batch = pp_llama_batch()
    named = [(pp_model_name(n, layers), p) for n, p in pl.named_parameters()]

    def first():
        loss = model.forward_backward_pipeline(batch, scaler)
        scaler.unscale_(opt)
        parts = ac_grad_parts(named, lambda p: False)
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss, parts

    def expected(skip):
        sched = model._host_sched
        return pp_expected(sched.event_log, sched.runners, 1,
                           0 if skip else len(named))

    def state():
        return [p for _, p in named] + [
            v for st in opt._inner_opt.state.values() for v in st.values()]
    out = ac_run("llama_pp4_1f1b", dist, rank, world,
                 lambda: model.train_batch(batch, opt, scaler=scaler),
                 first, expected, clip, scaler, state)
    timed_ms = ac_timed("llama (c)",
                        lambda: model.train_batch(batch, opt, scaler=scaler),
                        expected, rank)
    model.forward_backward_pipeline(batch, scaler)   # for the own times

    def unscale():
        scaler._unscaled = False
        scaler.unscale_(opt)
    scaler_ms = time_ms(unscale, 3)
    pg = [(p, p.grad) for _, p in named if p.grad is not None]
    clip_ms = time_ms(lambda: clip._clip_(pg, device=dev), 3)
    del pg
    opt.clear_grad()
    scaler.update()
    opt._inner_opt._grad_clip = None
    plain_ms = ac_timed("llama (c) without",
                        lambda: model.train_batch(batch, opt), expected,
                        rank)
    out = ac_finish(dist, out, world, PP_MICRO * LLAMA_SEQ,
                    llama_param_count(full), base, timed_ms, plain_ms,
                    clip_ms, scaler_ms)
    out["held"] = len(named)
    del model, opt, pl, named
    pp_fleet_reset(dist)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ac_line(key, m, world):
    """One phase-23 leg's numbers on a line."""
    scaler = (f", the scaler's unscale and check {m['scaler_ms']:.3f} ms"
              if m.get("scaler_ms") is not None else "")
    return (f"amp_clip: {key}: step ms {m['step_ms']:.2f} with the clip"
            f"{' and the scaler' if m.get('scaler_ms') is not None else ''}"
            f", {m['plain_step_ms']:.2f} without; {m['tokens_s']:.1f} "
            f"tokens/s over {world} card(s) ({m['tokens_s_card']:.1f} a "
            f"card), MFU {100 * m['mfu']:.2f} % (6 N tokens a card / 989 "
            f"TFLOP/s, N = {m['n_params']}); the clip's own "
            f"{m['clip_ms']:.3f} ms{scaler}; peak memory {m['peak_bytes']} "
            f"bytes ({m['peak_bytes'] / 2**30:.2f} GiB, the largest rank's)"
            f"; losses {m['losses']}; scales {m['scales']}; launches over "
            f"the held steps {m['launches']}")


def amp_clip_rank(dist, rank, world, dev):
    """Phase 23 on several cards: rank 0's one-card oracle of leg (a),
    then legs (a), (b) and (c), each topology's groups freed before the
    next."""
    res = {}
    release_groups(dist)
    cfg = ac_gpt_config()
    oracle = ac_gpt_oracle(cfg, dist_global_batch(cfg, world), world,
                           dev) if rank == 0 else None
    dist.barrier()
    for key, leg in (("a", lambda: ac_gpt_leg(dist, rank, world, dev,
                                              oracle)),
                     ("b", lambda: ac_tp_leg(dist, rank, world, dev)),
                     ("c", lambda: ac_pp_leg(dist, rank, world, dev))):
        res[key] = leg()
        if key == "a":
            oracle = None
        release_groups(dist)
        say_rank0(rank, ac_line(key, res[key], world))
    return res


def amp_clip_report(m, world):
    """Phase 23's numbers on several cards, from rank 0's results."""
    for key in ("a", "b", "c"):
        say(ac_line(key, m[key], world))
        say(f"amp_clip: {key}: " + json.dumps(
            {k: m[key][k] for k in ("norm", "oracle_norm", "norm_rel",
                                    "shares", "replicated_spread",
                                    "skip_bit_equal", "local_flags",
                                    "next_trains", "vs_oracle",
                                    "oracle_norm_rel", "host_reads_a_step",
                                    "buckets", "held")
             if k in m[key]}))


def amp_clip_one_card():
    """Phase 23 at one card: the clip and the scaler on phase 6's GPT-3
    1.3B O2 step (no process group): the clip's norm against its fp64
    oracle, the poison skipped, exact launches (K3 292 a step, 0 on the
    skip), timed with and without them."""
    torch.cuda.reset_peak_memory_stats()
    dev = card()
    base = torch.cuda.memory_allocated()
    cfg = ac_gpt_config()
    model, opt, clip = ac_gpt_build(cfg)
    scaler = amp.GradScaler(init_loss_scaling=AC_SCALE)
    step = train_step(model, None, opt, scaler=scaler, step_fn=o2_step_fn)
    ids, labels = batch(cfg)
    named = list(model.named_parameters())

    def first():
        loss = o2_step_fn(model, ids, labels)
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        parts = ac_grad_parts(named, lambda p: False)
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss.detach(), parts

    def expected(skip):
        return dict(PER_STEP, adamw=0 if skip else PER_STEP["adamw"])

    def state():
        return [p for _, p in named] + [
            v for st in opt.state.values() for v in st.values()]
    out = ac_run("gpt_one_card", None, 0, 1, lambda: step(ids, labels),
                 first, expected, clip, scaler, state)
    timed_ms = ac_timed("gpt one card", lambda: step(ids, labels),
                        expected, 0)
    loss = o2_step_fn(model, ids, labels)
    scaler.scale(loss).backward()

    def unscale():
        scaler._unscaled = False
        scaler.unscale_(opt)
    scaler_ms = time_ms(unscale, 3)
    pg = [(p, p.grad) for _, p in named if p.grad is not None]
    clip_ms = time_ms(lambda: clip._clip_(pg, device=dev), 3)
    del pg
    opt.clear_grad()
    scaler.update()
    opt._grad_clip = None
    plain = train_step(model, None, opt, step_fn=o2_step_fn)
    plain_ms = ac_timed("gpt one card without",
                        lambda: plain(ids, labels), expected, 0)
    out = ac_finish(None, out, 1, ids.numel(), param_count(cfg),
                    base, timed_ms, plain_ms, clip_ms, scaler_ms)
    say(ac_line("gpt_one_card", out, 1))
    del model, opt, step, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def amp_clip_alone() -> int:
    """``--amp-clip``: phase 23 alone after the build: at one card its
    one-card part, on several cards the ranks (legs (a)-(c))."""
    say(f"build: {_build.build_all():.3f} s")
    if torch.cuda.device_count() == 1:
        amp_clip_one_card()
    else:
        distributed_main_path((23,))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


PHASES = (17, 18, 19, 20, 21, 22)


def distributed_rank(out_dir: str, phases=PHASES) -> int:
    """One rank of phases 17-22 (``--distributed-rank DIR [--phases
    17,18,19,20,21,22]``, started by the port's launcher): the collectives,
    the oracle (rank 0), DataParallel and ZeRO stages 2 and 3 on GPT-3
    1.3B, the sanitizer, then phase 18 (``zero3_rank``), phase 19
    (``tp_rank``; at one card ``tp_world_of_one``), phase 20
    (``seq_rank``, on several cards), phase 21 (``pipeline_rank``, on
    several cards) and phase 22 (``moe_rank``, on several cards); rank 0
    holds the comparisons; each rank writes
    ``DIR/rank<r>.json``."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.env import runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = runtime().device
    res = dict(rank=rank, world=world, backend=dist.get_backend(),
               device=torch.cuda.get_device_name(dev), phases=list(phases))
    if 17 in phases:
        res.update(data_parallel_rank(dist, rank, world, dev))
    if 18 in phases:
        res["zero3"] = zero3_rank(dist, rank, world, dev)
    if 19 in phases:
        res["tp"] = tp_world_of_one(dist, rank, world, dev) if world == 1 \
            else tp_rank(dist, rank, world, dev)
    if 20 in phases and world > 1:
        res["seq"] = seq_rank(dist, rank, world, dev)
    if 21 in phases and world > 1:
        res["pp"] = pipeline_rank(dist, rank, world, dev)
    if 22 in phases and world > 1:
        res["moe"] = moe_rank(dist, rank, world, dev)
    if 23 in phases and world > 1:
        res["amp_clip"] = amp_clip_rank(dist, rank, world, dev)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def data_parallel_rank(dist, rank, world, dev):
    """Phase 17 on this rank: the collectives, rank 0's oracle,
    DataParallel and ZeRO stages 2 and 3 on GPT-3 1.3B, the sanitizer."""
    res = {}
    res["collective_errs"] = dist_collectives(dist, rank, world, dev)
    cfg = gpt_config("gpt3-1.3B", num_layers=N_LAYERS,
                     max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    batch = dist_global_batch(cfg, world)
    oracle = None
    if rank == 0:
        _, model, opt, step = build_trainer(N_LAYERS, seed=0)
        oracle = dist_oracle(model, opt, step,
                             [dist_shard(batch, j, dev)
                              for j in range(world)])
        del model, opt, step
    dist.barrier()
    local = dist_shard(batch, rank, dev)
    runs = {}
    for mode in ("dp", "os_g", "p_g_os"):
        runs[mode] = dist_run(mode, dist, lambda: build_gpt_o2(cfg), local,
                              gpt_per_step, rank, world, dev,
                              grads=mode in ("dp", "p_g_os"))
    if rank == 0:
        dp = runs["dp"]
        res["dp_vs_oracle"] = dist_compare("DataParallel vs the oracle", dp,
                                           oracle, exact=world == 1)
        for mode in ("os_g", "p_g_os"):
            res[f"{mode}_vs_dp"] = dist_compare(
                f"{mode} vs DataParallel", runs[mode], dp, exact=world == 1)
            if world == 1:
                dist_compare(f"{mode} vs the oracle", runs[mode], oracle,
                             exact=True)
        res["one_card_ms"] = oracle["one_card_ms"]
        res["oracle_losses"] = oracle["losses"]
    for key, run in runs.items():
        res[key] = {k: v for k, v in run.items()
                    if k not in ("values", "params", "grads")}
    del runs, oracle
    dist.barrier()                   # rank 0's comparisons ran on the host
    res["sanitizer"] = dist_sanitizer(dist, world, dev)
    return res


# one rank of the SIGKILL checks, written next to their logs and started by
# the launcher: join the NCCL group and all-reduce once; the last rank
# SIGKILLs itself on its first attempt (every attempt under
# DIST_KILL_ALWAYS; a marker file counts them) while the others wait in a
# second all-reduce until the launcher stops them
KILL_RANK_SOURCE = """\
import os, signal, sys
import torch
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed.env import runtime
dist.init_parallel_env()
rank, world = dist.get_rank(), dist.get_world_size()
t = torch.ones(1, device=runtime().device)
dist.all_reduce(t)
marker = os.path.join(sys.argv[1], f"attempt.{rank}")
first = not os.path.exists(marker)
with open(marker, "a") as f:
    f.write("x")
if rank == world - 1 and (first or os.environ.get("DIST_KILL_ALWAYS")):
    os.kill(os.getpid(), signal.SIGKILL)
dist.all_reduce(t)
if t.item() != world * world:
    sys.exit(f"rank {rank}: {t.item()} after two all-reduces")
dist.destroy_process_group()
"""


def dist_launch(world, log_dir, script, args, max_restart, timeout,
                env=None):
    """``script`` on ``world`` ranks through the port's launcher."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(world), "--log_dir", str(log_dir),
           "--max_restart", str(max_restart), str(script), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT,
                          env=dict(os.environ,
                                   PADDLE_ELASTIC_RESTART_BACKOFF="0",
                                   **(env or {})))
    return proc, time.perf_counter() - t0


def dist_logs(log_dir) -> str:
    return "".join(f"--- {p.name}\n" + p.read_text(errors="replace")[-4000:]
                   for p in sorted(Path(log_dir).glob("workerlog.*")))


def dist_kill_checks(world, root):
    """A SIGKILLed rank: the launcher restarts the group and exits 0
    (max_restart 1), or exits non-zero once the restarts run out
    (max_restart 0), each within DIST_KILL_S."""
    res = {}
    for tag, restarts, env in (("restart", 1, None),
                               ("give_up", 0, {"DIST_KILL_ALWAYS": "1"})):
        d = root / f"kill_{tag}"
        d.mkdir()
        script = d / "kill_rank.py"
        script.write_text(KILL_RANK_SOURCE)
        proc, secs = dist_launch(world, d / "logs", script, [str(d)],
                                 restarts, DIST_KILL_S, env)
        attempts = len((d / f"attempt.{world - 1}").read_text())
        res[tag] = dict(rc=proc.returncode, s=round(secs, 3),
                        attempts=attempts)
        want_rc = (lambda rc: rc == 0) if tag == "restart" \
            else (lambda rc: rc != 0)
        if not want_rc(proc.returncode) or \
                attempts != (2 if tag == "restart" else 1):
            fail(f"SIGKILL {tag}: launcher rc {proc.returncode}, "
                 f"{attempts} attempts\n{proc.stderr[-3000:]}"
                 f"{dist_logs(d / 'logs')}")
        say(f"distributed: a SIGKILLed rank, max_restart {restarts}: "
            f"launcher rc {proc.returncode} after {attempts} attempt(s) in "
            f"{secs:.3f} s")
    return res


def distributed_main_path(phases=PHASES):
    """Phases 17-22 (or those of ``phases``): the ranks through the port's
    launcher at the visible card count (NCCL), then (phase 17) the
    SIGKILL checks; prints the numbers and returns rank 0's results."""
    world = torch.cuda.device_count()
    for args in (["--query-gpu=index,name,power.limit",
                  "--format=csv,noheader"], ["topo", "-m"],
                 ["nvlink", "--status"]):
        smi = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=60)
        say(f"distributed: nvidia-smi {' '.join(args)} (rc {smi.returncode})"
            f"\n{(smi.stdout + smi.stderr).rstrip()[:3000]}")
    root = Path(ROOT) / "chiprun_out" / "distributed"
    shutil.rmtree(root, ignore_errors=True)
    (root / "run").mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    names = ",".join(map(str, phases))
    proc, secs = dist_launch(world, root / "logs", Path(__file__).resolve(),
                             ["--distributed-rank", str(root / "run"),
                              "--phases", names], 0, DIST_LAUNCH_S)
    if proc.returncode != 0:
        fail(f"phases {names}: the launcher exited {proc.returncode}\n"
             f"{proc.stderr[-3000:]}{dist_logs(root / 'logs')}")
    ranks = [json.loads((root / "run" / f"rank{r}.json").read_text())
             for r in range(world)]
    r0 = ranks[0]
    say(f"distributed: {world} rank(s), {r0['backend']}, {r0['device']}; "
        f"phases {names}'s ranks ran {secs:.3f} s")
    if 17 in phases:
        data_parallel_report(ranks, world)
    if 18 in phases:
        zero3_report(r0["zero3"], world)
    if 19 in phases:
        tp_report(r0["tp"], world)
    if 20 in phases and "seq" in r0:
        seq_report(r0["seq"], world)
    if 21 in phases and "pp" in r0:
        pipeline_report(r0["pp"], world)
    if 22 in phases and "moe" in r0:
        moe_report(r0["moe"], world)
    if 23 in phases and "amp_clip" in r0:
        amp_clip_report(r0["amp_clip"], world)
    if 17 in phases:
        r0["kill"] = dist_kill_checks(world, root)
    return r0


def data_parallel_report(ranks, world):
    """Phase 17's numbers, from every rank's results."""
    r0 = ranks[0]
    worst = {k: max(r["collective_errs"][k] for r in ranks)
             for k in r0["collective_errs"]}
    say(f"distributed: collectives' worst error over the ranks: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    for mode in ("dp", "os_g", "p_g_os"):
        m = r0[mode]
        per_card = m["tokens_s"] / world
        say(f"distributed: {mode}: {m['buckets']} buckets; step ms "
            f"{[round(1e3 * t, 2) for t in m['step_s']]}; timed mean "
            f"{m['step_ms']:.2f} ms = {m['tokens_s']:.1f} tokens/s "
            f"({per_card:.1f} a card), one card's plain step in this call "
            f"{r0['one_card_ms']:.2f} ms: scaling "
            f"{r0['one_card_ms'] / m['step_ms']:.4f} (against PERF.md's "
            f"214.20 ms: {214.20 / m['step_ms']:.4f}); the step's bucket "
            f"collectives alone {m['comm_ms']:.3f} ms; peak memory "
            f"{m['peak_bytes']} bytes ({m['peak_bytes'] / 2**30:.2f} GiB, "
            f"the largest rank's), of which {m['base_bytes']} bytes "
            f"({m['base_bytes'] / 2**30:.2f} GiB) allocated before the "
            "run")
        say(f"distributed: {mode}: launches over "
            f"{len(m['step_s'])} steps {m['launches']}"
            + (f"; gathers and reduce-scatters a step {m['collectives']}"
               if m["collectives"] else ""))
    say(f"distributed: rank 0's comparisons: DataParallel vs the oracle "
        f"{r0['dp_vs_oracle']}; os_g vs DataParallel {r0['os_g_vs_dp']}; "
        f"p_g_os vs DataParallel {r0['p_g_os_vs_dp']}; the oracle's losses "
        f"{r0['oracle_losses']}")
    say(f"distributed: sanitizer: {r0['sanitizer']}")


def tp_report(t, world):
    """Phase 19's numbers, from rank 0's results."""
    for key, m in t.items():
        if key == "run":
            continue
        if isinstance(m, dict) and "step_s" in m:
            say(tp_line(key, m, world))
        else:
            say(f"tensor parallel: {key}: {m}")
    if "run" in t:
        say(tp_line("tp_world_of_one", t["run"], world))


def seq_report(t, world):
    """Phase 20's numbers, from rank 0's results."""
    for key, m in t.items():
        if isinstance(m, dict) and "step_s" in m:
            say(tp_line(key, m, world))
        else:
            say(f"sequence parallel: {key}: {m}")


def pipeline_report(pp, world):
    """Phase 21's comparisons and numbers (rank 0's), one line each."""
    for key in ("depth8_vs_oracle", "gpt_vs_oracle"):
        if key in pp:
            say(f"pipeline: {key}: {json.dumps(pp[key])}")
    for key in ("depth8", *(f"pp4_{t}" for t, _, _ in PP_RUNS), "mp2_pp2",
                "gpt_dp2_pp2"):
        if key in pp:
            m = pp[key]
            extra = {k: m[k] for k in ("vs_1f1b", "vs_pp4") if k in m}
            say(f"pipeline: {key}: comparisons {json.dumps(extra)}")


def zero3_line(key, m, world):
    """One phase-18 run's numbers (``zero3_summary``) on a line, and its
    launches on the next."""
    line = (f"zero3: {key} at {m['layers']} layers ({m['n_params']} "
            f"parameters): {m['buckets']} buckets/flats; step ms "
            f"{[round(1e3 * t, 2) for t in m['step_s']]}")
    if "step_ms" in m:
        line += (f"; timed mean {m['step_ms']:.2f} ms = "
                 f"{m['tokens_s']:.1f} tokens/s over {world} card(s), "
                 f"{m['tokens_s_card']:.1f} a card, MFU "
                 f"{100 * m['mfu']:.2f} % (6 N tokens a card / 989 "
                 "TFLOP/s; recompute's second forward not counted)")
    if m.get("comm_ms") is not None:
        line += f"; the step's collectives alone {m['comm_ms']:.3f} ms"
    line += (f"; peak memory {m['peak_bytes']} bytes "
             f"({m['peak_bytes'] / 2**30:.2f} GiB, the largest rank's), "
             f"{m['base_bytes']} bytes ({m['base_bytes'] / 2**30:.2f} "
             "GiB) allocated before the run")
    return line + (f"\nzero3: {key}: launches over {len(m['step_s'])} "
                   f"steps {m['launches']}") + (
        f"; gathers and reduce-scatters a step {m['collectives']}"
        if m["collectives"] else "")


def zero3_report(z, world):
    """Phase 18's numbers, from rank 0's results."""
    runs = ("plain", "recompute", "p_g_os") if world == 1 else \
        ("depth2", "os_g", "p_g_os")
    for key in runs:
        say(zero3_line(key, z[key], world))
    for key in ("recompute_vs_plain", "p_g_os_vs_plain", "depth2_vs_oracle",
                "os_g_seg_vs_os_g", "p_g_os_vs_os_g_seg", "p_g_os_vs_os_g"):
        if key in z:
            say(f"zero3: {key}: {z[key]}")
    if "oracle_losses" in z:
        say(f"zero3: the depth-{ZERO3_DEPTH} oracle's losses "
            f"{z['oracle_losses']}")


def distributed_alone(phases=PHASES) -> int:
    """``--distributed``: phases 17-22 alone, after the build
    (``--tensor-parallel``: phases 19 and 20, and the one-card ring
    schedule; ``--sequence-parallel``: phase 20 and the ring schedule;
    ``--pipeline``: phase 21, and at one card its one-card part; at one
    card phase 22's one-card part too)."""
    say(f"build: {_build.build_all():.3f} s")
    if 20 in phases:
        check_ring_schedule()
    if 21 in phases and torch.cuda.device_count() == 1:
        pipeline_one_card()
    if 22 in phases and torch.cuda.device_count() == 1:
        ernie_moe_main_path()
    distributed_main_path(phases)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    if "--distributed-rank" in sys.argv:
        phases = PHASES
        if "--phases" in sys.argv:
            phases = tuple(int(p) for p in sys.argv[
                sys.argv.index("--phases") + 1].split(","))
        return distributed_rank(sys.argv[sys.argv.index("--distributed-rank")
                                         + 1], phases)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    global CARD
    CARD = card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    if "--ab" in sys.argv:
        return compare_variants(sys.argv[sys.argv.index("--ab") + 1:])
    if "--ab-paths" in sys.argv:
        return compare_paths(sys.argv[sys.argv.index("--ab-paths") + 1])
    if "--marks" in sys.argv:
        return k6a_marks()
    if "--fleet" in sys.argv:
        return fleet_alone()
    if "--distributed" in sys.argv:
        return distributed_alone()
    if "--tensor-parallel" in sys.argv:
        return distributed_alone((19, 20))
    if "--sequence-parallel" in sys.argv:
        return distributed_alone((20,))
    if "--pipeline" in sys.argv:
        return distributed_alone((21,))
    if "--moe" in sys.argv:
        return moe_alone()
    if "--amp-clip" in sys.argv:
        return amp_clip_alone()

    build_s = _build.build_all()
    say(f"build: {build_s:.3f} s ({' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                say(f"ptxas {name}: {line.strip()}")
    sass = check_sass()              # K1a/K1b/K1c bf16 on the tensor cores

    k7 = check_k7()
    gpt_serve, gpt_window, gpt_decode, gpt_faults = serve_main_path()
    k1 = check_k1()                  # "main" (GPT) and "llama" shapes
    k2_rows = check_k2()
    k2 = k2_rows["float32"]          # the main path's LayerNorm dtype (O2)
    k3_rows = check_k3()
    k3 = k3_rows["main"]
    train = train_main_path()
    cross_check()
    k4 = check_k4()["float32"]       # the main path's RMSNorm dtype (O2)
    k5 = check_k5()["main"]
    llama = llama_train_main_path()
    llama_cross_check()
    k6 = check_k6()
    llama_decode, llama_model = llama_decode_main_path()
    k9 = check_k9()
    paged = paged_main_paths(llama_model)
    k6d = check_k6d()
    programs = program_main_paths(llama_model)
    llama_serve = llama_serve_main_path(llama_model["model"])
    llama_serve["relaunch"] = llama_relaunch_main_path(llama_model["model"])
    del llama_model
    gc.collect()
    torch.cuda.empty_cache()
    k8 = check_k8()
    bart = bart_main_paths()
    ring = check_ring_schedule()             # phase 20 at one card
    pipe1 = pipeline_one_card()              # phase 21 at one card
    moe1 = ernie_moe_main_path()             # phase 22 at one card
    dist17 = distributed_main_path()

    # each kernel's line: the main path's shape.  K7 runs on the serving
    # paths: the entry's numbers are phase 4's (GPT-3 1.3B, single step),
    # by_path holds each serving path's launches with the numbers of its
    # own heads' decode case
    by_path = {}
    for path, heads, launched in (
            ("gpt_serve", "mha", gpt_serve["k7"]),
            ("gpt_window", "mha", gpt_window["k7"]),
            ("llama_serve", "llama", llama_serve["single"]["k7"]),
            ("llama_window", "llama", llama_serve["window"]["k7"]),
            ("llama_http", "llama", llama_serve["http"]["k7"]),
            ("gpt_faults", "mha", gpt_faults["k7"]),
            ("gpt_fleet", "mha", gpt_faults["fleet"]["k7"]),
            ("llama_relaunch", "llama", llama_serve["relaunch"]["k7"])):
        row = next(r for r in k7 if (r["case"], r["heads"], r["dtype"])
                   == ("decode", heads, "float32"))
        nh, nkv = HEADS[heads]
        by_path[path] = dict(
            launches=launched, max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"],
            shape=f"decode, B=8, Q=1, nh={nh}, nkv={nkv}, hd=128, ps=16, "
                  "fp32")
    k1_shape = "[64, 2048, 128] bf16 causal (batch 4 x 16 heads)"
    k2_shape = "[8192, 2048] fp32 (batch 4 x seq 2048 tokens, H 2048)"
    kernels = [dict(
        name="ragged_paged_attention",
        source="paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/ragged_paged_attention.py:207",
        **by_path["gpt_serve"], by_path=by_path)]
    flash_src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    # K1 runs on both training paths, each at its own shape: the entry's
    # numbers are the GPT path's (its first), and by_path holds each
    # path's launches with the numbers of its own shape's case
    world = dist17["world"]
    dist_shape = f" on each of {world} rank(s)"
    zero3 = dist17["zero3"]["p_g_os"]    # phase 18's stage-3 run
    zero3_shape = (f", phase 18 at {zero3['layers']} layers under ZeRO 3 "
                   f"+ recompute{dist_shape}")
    tp1 = dist17["tp"]["run"]            # phase 19 at one card
    tp1_shape = (f", phase 19 at depth {TP_DEPTH} through TensorParallel "
                 "in a world of one")
    # phase 21 at one card: each schedule's run (3 steps; 1F1B 8), every
    # layer recomputed, 8 micro-batches of 1 x 4096 a step
    pp1 = [(f"llama_pp1_{m}", pipe1[m]["launches"],
            f", phase 21: {PP_STAGES} stages on one card under {m}, "
            f"{PP_MICRO} micro-batches of 1 x {LLAMA_SEQ}, recompute; the "
            "numbers are the batch-2 case's") for m in PP_ONE_CARD]
    k1_paths = (("gpt_train", "main", train, k1_shape),
                ("llama_train", "llama", llama,
                 "[64, 4096, 128] bf16 causal (batch 2 x 32 heads)"),
                ("gpt_dist_dp", "main", dist17["dp"]["launches"],
                 k1_shape + dist_shape),
                ("gpt_dist_os_g", "main", dist17["os_g"]["launches"],
                 k1_shape + dist_shape),
                ("gpt_dist_p_g_os", "main", dist17["p_g_os"]["launches"],
                 k1_shape + dist_shape),
                ("llama_zero3", "llama", zero3["launches"],
                 "[64, 4096, 128] bf16 causal (batch 2 x 32 heads; K1a "
                 "twice a layer under recompute)" + zero3_shape),
                ("llama_tp_world_of_one", "llama", tp1["launches"],
                 "[64, 4096, 128] bf16 causal (batch 2 x 32 heads)"
                 + tp1_shape),
                *((path, "llama", launched,
                   "[32, 4096, 128] bf16 causal (batch 1 x 32 heads)" + sh)
                  for path, launched, sh in pp1),
                ("ernie_moe_train", "ernie", moe1["launches"],
                 "[96, 512, 64] bf16 non-causal (ernie-moe-base, batch 8 x "
                 "12 heads; phase 22)"),
                ("llama_ring_schedule", "ring-full", ring["launches"],
                 "[64, 1024, 128] bf16 chunks of llama2-7b's attention "
                 "(phase 20 at one card: cp 4's ranks in turn; 6 of the "
                 "10 launches of each kernel see every key, the numbers "
                 "are theirs, ring-diag's the other 4)"))
    for name, key, replaces, err in (
            ("flash_attention_fwd", "fwd", ":113", "o"),
            ("flash_attention_bwd_dq", "dq", ":269", "dq"),
            ("flash_attention_bwd_dkv", "dkv", ":297", "dkv")):
        count = "flash_" + ("fwd" if key == "fwd" else "bwd_" + key)
        phase = "fwd" if key == "fwd" else "bwd"
        by_path = {}
        for path, case, launched, shape in k1_paths:
            r = k1[case]
            by_path[path] = dict(
                launches=launched[count], max_abs_err=r["max_abs_err"][err],
                ms=r[key + "_ms"], plain_ms=r[f"plain_{phase}_ms"],
                bound_ms=r[key + "_bound"][0],
                bound_by=r[key + "_bound"][1],
                library_ms=r[f"library_{phase}_ms"], shape=shape)
        entry = dict(
            name=name, source=flash_src,
            replaces="paddle_tpu/ops/flash_attention.py" + replaces,
            **by_path["gpt_train"], by_path=by_path)
        # tensor-core instructions by head_dim (bf16)
        entry["sass_hmma"] = sass["flash_fwd_kernel" if key == "fwd"
                                  else f"flash_bwd_{key}_kernel"]
        kernels.append(entry)
    # K2 and K3 run on the GPT and BART training paths, K2a also on GPT's
    # decode steps: the entry's numbers are the GPT training path's,
    # by_path holds each path's launches with the numbers of its own
    # shape's case
    k2_paths = (("gpt_train", k2, train, k2_shape),
                ("bart_train", k2_rows["bart"], bart,
                 "[8192, 768] fp32 (batch 8 x 1024 tokens, d_model 768)"),
                ("gpt_decode", k2_rows["decode"],
                 {"ln_fwd": paged["gpt"]["ln_fwd"], "ln_bwd_dx": 0},
                 "[8, 2048] fp32 (a decode step's 8 rows; launches of "
                 "phase 12's paged GPT-3 1.3B call)"),
                ("gpt_dist_dp", k2, dist17["dp"]["launches"],
                 k2_shape + dist_shape),
                ("gpt_dist_os_g", k2, dist17["os_g"]["launches"],
                 k2_shape + dist_shape),
                ("gpt_dist_p_g_os", k2, dist17["p_g_os"]["launches"],
                 k2_shape + dist_shape),
                ("ernie_moe_train", k2_rows["ernie"], moe1["launches"],
                 "[4096, 768] fp32 (ernie-moe-base, batch 8 x 512 tokens; "
                 "phase 22)"))
    for name, key, replaces, count in (
            ("layer_norm_fwd", "fwd", ":58", "ln_fwd"),
            ("layer_norm_bwd_dx", "dx", ":80", "ln_bwd_dx")):
        by_path = {}
        for path, r, launched, shape in k2_paths:
            by_path[path] = dict(
                launches=launched[count],
                max_abs_err=r["max_abs_err"]["y" if key == "fwd" else "dx"],
                ms=r[key + "_ms"], plain_ms=r["plain_" + key + "_ms"],
                bound_ms=r[key + "_bound"][0], bound_by=r[key + "_bound"][1],
                library_ms=r["library_" + key + "_ms"], shape=shape)
        kernels.append(dict(
            name=name, source="paddle_tpu_torch/ops/csrc/layer_norm.cu",
            replaces="paddle_tpu/ops/pallas/layer_norm.py" + replaces,
            **by_path["gpt_train"], by_path=by_path))
    by_path = {}
    for path, r, launched, shape in (
            ("gpt_train", k3, train["adamw"],
             "[2048, 8192] bf16 parameter on an fp32 master, bf16 grad"),
            ("llama_train", k3, llama["adamw"],
             "[2048, 8192] bf16 parameter on an fp32 master, bf16 grad"),
            ("bart_train", k3_rows["bart"], bart["adamw"],
             "[50265, 768] fp32 parameter and grad (BART's shared "
             "embedding)"),
            ("gpt_dist_dp", k3, dist17["dp"]["launches"]["adamw"],
             "[2048, 8192] bf16 parameter on an fp32 master, bf16 grad"
             + dist_shape),
            ("gpt_dist_os_g", k3, dist17["os_g"]["launches"]["adamw"],
             f"one bucket's 1/{world} shard a launch ({dist17['os_g']['buckets']}"
             " buckets of <= 25 MB, flat bf16 grad on an fp32 master); "
             "the numbers are the [2048, 8192] case's"),
            ("gpt_dist_p_g_os", k3, dist17["p_g_os"]["launches"]["adamw"],
             f"one segment flat's 1/{world} shard a launch "
             f"({dist17['p_g_os']['buckets']} flats: a bf16 and an fp32 one "
             "a segment); the numbers are the [2048, 8192] case's"),
            ("llama_zero3", k3, zero3["launches"]["adamw"],
             f"one segment flat's 1/{world} shard a launch "
             f"({zero3['buckets']} flats){zero3_shape}; the numbers are "
             "the [2048, 8192] case's"),
            ("llama_tp_world_of_one", k3, tp1["launches"]["adamw"],
             "[2048, 8192] bf16 parameter on an fp32 master, bf16 grad"
             + tp1_shape),
            *((path, k3, launched["adamw"],
               "[2048, 8192] bf16 parameter on an fp32 master, bf16 grad"
               + sh) for path, launched, sh in pp1),
            ("ernie_moe_train", k3_rows["ernie"], moe1["launches"]["adamw"],
             "[768, 3072] bf16 expert weight on an fp32 master, bf16 grad; "
             "one launch a parameter tensor of ernie-moe-base (1672: 1536 "
             "expert weights and biases; phase 22)")):
        by_path[path] = dict(
            launches=launched, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"], shape=shape)
    kernels.append(dict(
        name="fused_adamw", source="paddle_tpu_torch/ops/csrc/fused_adamw.cu",
        replaces="paddle_tpu/ops/pallas/fused_adamw.py:55",
        **by_path["gpt_train"], by_path=by_path))
    k4_shape = "[8192, 4096] fp32 (batch 2 x seq 4096 tokens, H 4096)"
    # K4 and K5 run on the LLaMA training paths (phases 8 and 18): the
    # entry's numbers are phase 8's, by_path holds each path's launches
    for name, key, replaces, count in (
            ("rms_norm_fwd", "fwd", ":57", "rms_fwd"),
            ("rms_norm_bwd_dx", "dx", ":76", "rms_bwd_dx")):
        by_path = {path: dict(
            launches=launched[count],
            max_abs_err=k4["max_abs_err"]["y" if key == "fwd" else "dx"],
            ms=k4[key + "_ms"], plain_ms=k4["plain_" + key + "_ms"],
            bound_ms=k4[key + "_bound"][0], bound_by=k4[key + "_bound"][1],
            library_ms=k4["library_" + key + "_ms"], shape=shape)
            for path, launched, shape in (
                ("llama_train", llama, k4_shape),
                ("llama_zero3", zero3["launches"], k4_shape + zero3_shape),
                ("llama_tp_world_of_one", tp1["launches"],
                 k4_shape + tp1_shape),
                *((path, launched, "[4096, 4096] fp32 (1 x 4096 tokens)"
                   + sh) for path, launched, sh in pp1))}
        kernels.append(dict(
            name=name, source="paddle_tpu_torch/ops/csrc/rms_norm.cu",
            replaces="paddle_tpu/ops/pallas/rms_norm.py" + replaces,
            **by_path["llama_train"], by_path=by_path))
    k5_shape = "[2, 4096, 32, 128] bf16 q/k, [4096, 128] bf16 tables, " \
        "interleaved"
    by_path = {path: dict(
        launches=launched["rope"], max_abs_err=k5["max_abs_err"]["y"],
        ms=k5["ms"], plain_ms=k5["plain_ms"], bound_ms=k5["bound"][0],
        bound_by=k5["bound"][1], library_ms=k5["library_ms"], shape=shape)
        for path, launched, shape in (
            ("llama_train", llama, k5_shape),
            ("llama_zero3", zero3["launches"], k5_shape + zero3_shape),
            ("llama_tp_world_of_one", tp1["launches"],
             k5_shape + tp1_shape),
            *((path, launched, k5_shape + sh)
              for path, launched, sh in pp1))}
    kernels.append(dict(
        name="rope", source="paddle_tpu_torch/ops/csrc/rope.cu",
        replaces="paddle_tpu/ops/pallas/rope.py:57",
        **by_path["llama_train"], by_path=by_path))
    # K6a/b/c run on the decode paths, each at its own shape: the entry's
    # numbers are the llama2-7b path's (phase 10, the main path of this
    # slice), by_path holds each path's launches with its own case's
    k6_paths = (("llama_decode", "llama", llama_decode["launches"]),
                ("gpt_decode", "gpt", gpt_decode["launches"]))
    for name, key, count, replaces in (
            ("rope_qkv", "k6a", "rope_qkv", ":145"),
            ("attend_cache_append", "k6b", "attend_cache_append", ":254"),
            ("norm_mlp", "k6c", "norm_mlp", ":363")):
        paths = list(k6_paths)
        if key == "k6c":
            paths += [
                ("gpt_serve", "gpt", {"norm_mlp": gpt_serve["k6c"]}),
                ("gpt_window", "gpt", {"norm_mlp": gpt_window["k6c"]}),
                ("llama_serve", "llama",
                 {"norm_mlp": llama_serve["single"]["k6c"]}),
                ("llama_window", "llama",
                 {"norm_mlp": llama_serve["window"]["k6c"]}),
                ("llama_http", "llama",
                 {"norm_mlp": llama_serve["http"]["k6c"]}),
                ("gpt_faults", "gpt", {"norm_mlp": gpt_faults["k6c"]}),
                ("llama_relaunch", "llama",
                 {"norm_mlp": llama_serve["relaunch"]["k6c"]})]
        by_path = {}
        for path, case, launched in paths:
            r = k6[key][case]
            by_path[path] = dict(
                launches=launched[count],
                max_abs_err=max(e["plain"] for e in
                                r["max_abs_err"].values()), ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                shape=r["shape"] + " " + r["dtype"])
            if "composition_ms" in r:    # K6c: not one PyTorch call
                by_path[path]["composition_ms"] = r["composition_ms"]
        kernels.append(dict(
            name=name, source="paddle_tpu_torch/ops/csrc/fused_decode.cu",
            replaces="paddle_tpu/ops/pallas/fused_decode.py" + replaces,
            **by_path["llama_decode"], by_path=by_path))
    # K9 runs on the paged paths, each at its own shape: the entry's
    # numbers are the llama2-7b path's, by_path holds each path's
    by_path = {}
    for path, case in (("llama_paged", "llama"), ("gpt_paged", "gpt")):
        r = k9[case]
        by_path[path] = dict(
            launches=paged[case]["launches"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"] + " " + r["dtype"])
    kernels.append(dict(
        name="paged_attention",
        source="paddle_tpu_torch/ops/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/paged_attention.py:71",
        **by_path["llama_paged"], by_path=by_path))
    # K8a/K8b run on the BART training path (phase 14), at its loss's shape
    r = k8["main"]
    for name, key, replaces, count in (
            ("softmax_ce_fwd", "fwd", ":65", "ce_fwd"),
            ("softmax_ce_bwd", "bwd", ":83", "ce_bwd")):
        kernels.append(dict(
            name=name, source="paddle_tpu_torch/ops/csrc/softmax_ce.cu",
            replaces="paddle_tpu/ops/pallas/softmax_ce.py" + replaces,
            launches=bart[count],
            max_abs_err=r["max_abs_err"]["loss" if key == "fwd" else "dx"],
            ms=r[key + "_ms"], plain_ms=r["plain_" + key + "_ms"],
            bound_ms=r[key + "_bound"][0], bound_by=r[key + "_bound"][1],
            library_ms=r["library_" + key + "_ms"],
            shape=f"[{r['n']}, {r['v']}] fp32 logits, {r['valid_rows']} "
                  "rows not ignored (batch 8 x decoder 1024)"))
    # K6d runs on the program-pass paths (phase 16): GPT-3 1.3B's optimized
    # step launches it 49 times at three shapes, timed together as phase
    # 15's "gpt_step"; LLaMA-2 7B's launches it once, at its head's shape
    by_path = {}
    for path, res, case in (("gpt_program", programs["gpt"], "gpt_step"),
                            ("llama_program", programs["llama"],
                             "llama_head")):
        r = k6d[case]
        by_path[path] = dict(
            launches=res["launches_after"]["norm_matmul"],
            max_abs_err=r["max_abs_err"]["y"]["plain"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"] + " " + r["dtype"])
    kernels.append(dict(
        name="norm_matmul", source="paddle_tpu_torch/ops/csrc/fused_decode.cu",
        replaces="paddle_tpu/ops/pallas/fused_decode.py:455",
        **by_path["gpt_program"], by_path=by_path))
    for k in kernels:
        k["route"] = "cuda"
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

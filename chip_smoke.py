#!/usr/bin/env python3
"""Smoke run of deepspeed_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the package's CUDA kernels from ``deepspeed_tpu_torch/csrc`` and
drives the serving (single-step, multi-step windows, speculative decoding,
crash recovery from the journal, int8 weights, multi-tenant SLA serving,
a two-replica fleet and tensor-parallel serving, forward and generate on
two ranks, tenancy, the fleet and wall-clock replay over tp servers), the
training (with checkpoints: save, async save, bit-exact resume, serving
booted from one; ZeRO stages 0-3 on two ranks and a checkpoint moved
between dp = 2 and dp = 1; optimizer and parameter offload, and
ZeRO-Inference; fused gradient accumulation and multi-step windows as
captured CUDA graphs, GPT-2 2.7B at head_dim 80, the llama, qwen and ALiBi
training shapes; the data pipeline: curriculum, random-LTD, PLD and a resume
from the data cursor), MoE on one rank (moe-llama 1b-8e serving and training),
expert parallelism on two ranks (its training, forward, generate and serving)
and the block-sparse attention main paths at full width. Phases,
each printing JSON lines; any failure raises, and the script then exits
non-zero without the final line:

1. device: the card (``nvidia-smi`` name and power limit) and the kernel
   builds, one ``nvcc`` per source, all started together (nvcc time,
   ptxas register/shared-memory report);
2. the ragged paged-attention kernel (K4) against its plain PyTorch version
   at the serving shapes of llama-1B (R=8, NH=32, NKV=4, D=64, P=16,
   MAXP=128, NP=1025): a W=1 decode batch, a W=32 mixed batch and a W=5
   speculative verify batch (q_lens 1, 2, 3, 4, 5, 5, 1, 0), fp32 with
   TF32 off (max abs error <= 1e-4) and bf16 (<= 2e-2 against the plain
   version in fp32 on the same bf16 inputs); dead rows and window slots past
   q_len must be exact zeros, every call must run the split-KV kernel and its
   combine (``launches_ragged_split``; each case prints its split count), and
   two calls on the same inputs must be bitwise equal. Then kv_len on a split
   boundary and one key past it, a row with a single key in its last split,
   and D=128 with a GQA group of 7 and pages of 64 (correctness only).
   Times the kernel, the plain version and a yardstick
   (``scaled_dot_product_attention`` over K/V pre-gathered into a
   contiguous cache: it omits the page walk, and the port never calls it),
   each with the L2 cache flushed before every launch;
3. the main path: ``init_inference(TransformerLM(llama_config("1b")),
   dtype="bf16", paged_kv={"page_size": 16, "max_slots": 8})`` with seeded
   random weights loaded through ``load_jax_params``, serving 16 requests
   twice (cold, then warm with cached prefixes); the kernel's launch count
   is zeroed just before and read just after, and must equal
   22 × ``ragged_steps``, every call on the split-KV path. Then
   ``engine(tokens)`` once on that engine ([2, 256] tokens, model profiling
   on): the logits' shape, dtype, finiteness, ``model_times()`` entry and
   the launches of that call;
4. greedy-stream identity in fp32 (TF32 off): 4 requests × 32 tokens with
   ``attn_impl="kernel"`` against ``"plain"``; where streams part, the plain
   run's top-2 logit gap at that position must be below 1e-4;
5. the dense decode kernel (K6, split-KV) against its plain version at the
   generate shape of llama-1B (B=16, S=256, NH=32, NKV=4, D=64, ragged
   lengths with 0 and 256; fp32, bf16 and fp16) and an MHA shape
   (NH=NKV=12; fp32, bf16), fp32 with TF32 off (<= 1e-4) and bf16/fp16
   (<= 2e-2 against the plain version in fp32 on the same cast inputs),
   rows of length 0 exact zeros; timed beside its bound and a yardstick
   (``scaled_dot_product_attention`` with a length mask over the same
   cache), L2 flushed before every launch. Then (correctness only) a GQA
   group of 7 at D=128, and S=100 with kv_len on a 64-key split boundary,
   one past it, S and past S. Every call must run the split kernel and its
   combine (``launches_decode_split``), two calls on the same inputs must
   be bitwise equal, and each case prints its split count;
6. the paged decode kernel (K5, split-KV) the same way at the bucketed
   decode shape (bucket 8, llama-1B heads, P=16, MAXP=128, NP=1025, a dead
   row and -1 sentinels) and at bucket 1 (bf16, one row of 1500 keys),
   yardstick SDPA over pre-gathered K/V as for K4; and at D=128 with a
   group of 7 (correctness only). Every call must run the split kernel and
   its combine (``launches_paged_split``), two calls on the same inputs
   must be bitwise equal, and each case prints its split count;
7. the dense ``engine.generate`` path in bf16 on llama-1B: 16 prompts of 128
   tokens with 128 new (cache length 256), cold and warm, with
   ``profile_model_time``; K6 must launch 22 × 128 times per call and K4,
   K5 never. Then beam search (4 beams, 2 prompts of 224 tokens, 32 new):
   K6 = 22 × 32. Every K6 call on the split path;
8. the bucketed server (``paged_kv.ragged=False``) in bf16 on phase 3's
   last 8 requests (one shared prefix; cut from 16 to make room for
   18a-18d), cold and warm: 16 of 16 finished, K5 = 22 × ``decode_steps``,
   every K5 call on the split path, K4 never;
9. fp32 (TF32 off) stream identity of the three decode kernels: 4 prompts
   of 224 tokens, 32 new tokens each, through the ragged server (K4), the
   bucketed server (K5) and ``generate`` (K6, cache length 256); where two
   streams part, the plain top-2 logit gap must be below 1e-4. Beam search
   there too: the 4-beam answer's joint log-probability (rescored by a full
   fp32 forward) must be at least the greedy answer's less 1e-3. And the
   ragged server with multi-step windows (horizon 8, CUDA graph replays):
   its streams must equal the single-step ragged server's exactly. Then,
   on the same prompts, speculation (an oracle drafter of the ragged
   streams, K = 4; ragged verify rows on K4 and the bucketed oracle's plain
   verify with every third round a K5 round) and a journaled ragged server
   killed at ``serve.mid_step`` (hit 12) and recovered by a fresh server
   from the replayed journal: streams equal to the ragged server's or
   parting where the plain top-2 gap is below 1e-4, exact counts; and the
   largest logit difference of one token scored as a decode row (width 1)
   and as a verify row's first slot (width 5);
9b. multi-step serving windows: phase 3's engine with
   ``paged_kv={"page_size": 16, "max_slots": 8, "ragged": True,
   "multi_step": {"enable": True, "horizon": 8}}`` in bf16 on phase 3's 16
   requests, cold then warm: every stream equal to phase 3's, windows
   formed, one CUDA graph captured, and K4's counter equal to 22 x
   ``ragged_steps`` + 2 x 22 x 8 x captures (a capture passes the wrapper
   for the warm-up's launch and for the graph's record; a replay never
   passes it), every other kernel 0. Then steady traffic, 8 requests of
   128 tokens with 128 new, on fresh servers in turns (single-step,
   windows, windows, single-step): streams equal, TPOT p50, tokens/s,
   windows, captures and replays, each window's host wall beside its
   replay's device time (CUDA events at every replay, from
   ``serve_stats()["window_device_ms"]``) and the window's idle share,
   with the same counter accounting. Last, a fifth server on the steady
   traffic runs two steps after its capture under ``torch.profiler``,
   which counts K4's split and combine kernels on the device, those
   inside the replays included: each must equal 22 x (``ragged_steps`` +
   8 x ``window_steps``) of those steps and K4's counter 22 x
   ``ragged_steps``; the server then runs to its end with its streams
   equal to the single-step server's;
9c. speculative serving in bf16, each run on a fresh server with the
   counts zeroed just before (K4 = 22 x ``ragged_steps``, K5 = 22 x plain
   bucketed rounds, every other kernel 0, every page back): the steady
   traffic with an oracle drafter of phase 9b's single-step streams
   (K = 4), the oracle corrupted at index 2 (no accepted prefix past 2),
   one bucketed pass with the oracle (every third round plain, so K5 runs
   between verify rounds); then phase 3's first 8 requests (cut from 16
   for 18a-18d) through
   ``init_inference(..., spec_decode={"enable": True})`` (the n-gram
   drafter). Each prints the streams equal to speculation-off (counted,
   not required: bf16 GEMMs round by width), ``spec_rounds``, the
   acceptance, dispatches per token, tok/s and TPOT p50; and the decode
   row vs verify row logit difference in bf16;
9d. crash and recovery in bf16: a journaled engine
   (``journal={"enabled": True, "dir": ...}``) on phase 3's first 8
   requests (cut from 16 for 18a-18d) killed
   by ``utils.chaos`` at ``serve.mid_step`` (hit 40), dropped, and a fresh
   engine on the same directory recovers: ``stats["recovered"]`` equals
   the live requests, every request finishes, the counts are exact (the
   killed pass's too); again with windows, killed at ``serve.mid_window``
   (hit 2). Streams equal to phase 3's are counted. Then the journal's
   cost on the steady traffic (64 new), off, on, on, off on fresh
   servers (two turns cut for 18a-18d):
   tok/s, TPOT p50 and each step's ``journal.sync`` time;
9e. int8 serving weights (S8): a bf16 engine with
   ``paged_kv={"page_size": 16, "max_slots": 8, "sharded":
   {"weight_quant_bits": 8}}`` serves phase 3's last 8 requests (one
   shared prefix; cut from 16 for 18a-18d) cold then warm: every request finishes and K4 = 22 x ``ragged_steps``, every
   other kernel 0. Prints the served tree's bytes (codes, scales and
   exact leaves) beside the bf16 tree's, TTFT/TPOT, the streams equal to
   phase 3's (counted, not required) and the largest logit difference of
   one [2, 256] forward (plain attention) against the unquantized tree on
   the logit scale. Then the steady traffic with windows on fresh servers,
   int8, bf16, bf16, int8: tok/s, TPOT p50, a replay's device time per
   round and the round's weight-read bound (every leaf once, 8 rows of the
   embedding table, over 3.35 TB/s), K4's counter exact. In fp32 (TF32
   off) on phase 9's prompts: an int8 server through K4 and one through
   ``attn_impl="plain"`` (streams equal or parting at a plain top-2 gap
   below 1e-4) and a bucketed int8 server (K5 = 22 x plain rounds). Last,
   a bf16 ``quant.enabled`` engine: ``engine(tokens)`` finite, and one
   ``generate`` (2 prompts of 128, 128 new) with K6 = 22 x 128 and no
   other kernel;
9f. multi-tenant SLA serving (S7): ``init_inference(..., traffic={"enabled":
   True, "tenants": [gold (weight 3, priority 1), free (weight 1)]})`` in
   bf16 on phase 3's traffic, the tenants alternating: every request
   finishes, K4 exact; per-tenant TTFT/TPOT, budget and goodput shares, SLA
   attainment and the streams equal to phase 3's (counted). In fp32 on
   phase 9's prompts the multi-tenant server's streams must equal the
   single-tenant server's (or part at a plain top-2 gap below 1e-4);
9g. the serving fleet (S7): two replicas of llama-1B on the one card (one
   device, not a multi-card fleet), each a ``PagedServer`` with its own
   pool and journal directory, sharing one weight tree, behind a
   ``FleetRouter``. fp32 (TF32 off), phase 9's prompts: one run migrates a
   request mid-stream and drains the busier replica; one kills a replica
   at ``fleet.replica_kill`` (hit 6) and re-routes its requests from its
   journal (re-routed = its live requests at the kill). Every request
   finishes, ``migrated_token_divergence`` is 0, K4 = 22 x the replicas'
   ``ragged_steps``, and the streams equal the single server's (or part at
   a plain top-2 gap below 1e-4). Then bf16: a ``make_trace`` of the two
   tenants (3 s at 3 requests a second each) replayed by
   ``utils.loadgen.replay`` on the real clock into two SLA replicas, one
   killed at 1.5 s: routing shares, TTFT/TPOT, ``fleet_stats()`` and the
   streams equal to one server's (counted); every request finished, the
   kill fired, divergence 0 and K4 exact are required;
9h. tensor parallelism (S9) on two gloo ranks that share the one card
   (the sharded math and collectives on the device, not a TP speed), on
   llama-1B's width at 2 of its 22 layers (the depth cut to 8 to make room
   for phases 17a-17e, to 2 for 18a-18d; the references below are made at
   that depth too). K4,
   K6 and K1 against their plain versions at a rank's head counts under
   tp = 2 (16 query heads over 2 kv heads, D 64; one launch each, fp32
   within 1e-4 and bf16 within 2e-2). The single-rank fp32 references
   are made first; then the tree goes to one memory-mapped file and two
   ranks are spawned (``spawn``; ``init_distributed("gloo")`` through a
   file store with a timeout; the parent kills both at a time limit and
   fails on any rank's error). Each rank: ``init_inference(...,
   paged_kv={"sharded": {"tp_degree": 2}})`` serving the first 8 of phase
   3's 16 requests in bf16 (cut to make room for phases 16a-16e; every
   request finished, K4 = layers x ragged steps, TTFT/TPOT); a bf16 server with the
   quantized all-reduce (4 requests of 8 new tokens finished) and the largest logit
   difference of one [2, 256] forward against the fp all-reduce; fp32
   (TF32 off) servers on phase 9's 4 prompts, 16 new tokens each: ragged, windows (eager
   rounds under tp, K4 = layers x (steps + 8 x windows)), an oracle drafter
   and int8 weights, each stream equal to the single-rank server's or
   parting at a plain top-2 gap below 1e-4; ``tensor_parallel={"tp_size":
   2}``: ``engine(tokens)`` [2, 256] within 1e-4 of the logit scale of
   tp = 1 with K1 = layers, greedy ``generate`` (16 x 32 new) equal to tp =
   1's with K6 = layers x 32; ``save_mp_checkpoint`` (rank 0 writes), then
   fresh tp = 2 and (rank 0) tp = 1 engines booted with ``checkpoint=``,
   logits bitwise those of the saving engine and of the tp = 1 engine.
   The ranks' step fingerprints must be equal in every serve; the port
   stages no collective through the host itself (``staged_collectives``
   0: gloo takes every one on CUDA tensors);
9i. tensor parallelism under tenancy, the fleet and wall-clock replay
   (S10), in phase 9h's two ranks, fp32 (TF32 off) on phase 9's 4 prompts
   with 16 new tokens: a ``MultiTenantServer`` (the two tenants of phase
   9f, alternating) over a tp = 2 server on a virtual clock; a
   two-replica ``FleetRouter`` of tp = 2 servers, replica r1 drained after
   4 fleet steps; ``replay`` on the wall clock of a two-tenant
   ``make_trace`` (3 + 3 requests) across two tp = 2 replicas with a drain
   of r1 fired at 1 s. Every request finishes on both ranks, the streams
   are equal on both ranks and to the tp = 1 server's (or part at a plain
   top-2 gap below 1e-4), the replay's drain fires and both ranks log the
   same fingerprint after every step of each replica; K4 = 22 x the
   servers' ragged steps on each rank, every other kernel 0;
10. the flash attention kernels K1 (forward), K2 (dQ) and K3 (dK, dV)
   against their plain versions at the training shape (B=8, T=1024, N=12,
   D=64, causal), a ragged T=200, a non-causal T=256 and D=128 (B=1,
   T=2048, N=32): O, LSE, dQ, dK and dV, fp32 with TF32 off (O and LSE
   within 1e-4, each gradient within 1e-3 of the reference's largest
   magnitude) and bf16 against the plain versions in fp32 on the same bf16
   inputs (O within 2e-2, each gradient within 3e-2 of that magnitude),
   and fp16 at the training shape within bf16's bounds. K1, K2 and K3 must
   take their tensor-core variants in bf16 and fp16 and their FMA variants
   in fp32 (``launches_fwd_tc``, ``launches_dq_tc``, ``launches_dkv_tc``);
   two bf16 K2 calls on the same inputs must give a bitwise-equal dQ. At
   the training shape it times each kernel, its
   plain version and a yardstick (``scaled_dot_product_attention(
   is_causal=True)`` for K1, and its autograd backward for K2 and K3
   together; the port never calls either), L2 flushed before every launch,
   beside its bound, with the yardstick's share of the kernel's time;
11. the training main path: ``initialize(TransformerLM(gpt2_config("125m",
   max_seq_len=1024, remat=False)), config=<bench.py config 1>)`` (bf16,
   ZeRO-1, Adam with weight decay 0.01, clipping 1.0, micro batch 8) with
   seeded random weights in the JAX tree layout; one ``RandomState(0)``
   batch of ``[8, 1025]`` tokens placed once; 3 warm-up and 20 timed steps
   of ``engine(batch)``, ``backward``, ``step``. The flash launch counts
   are zeroed just before and each must equal 12 × 23 just after, every K1,
   K2 and K3 launch on the tensor-core variant; every loss must be finite and
   the last below the first. Prints tokens/s, ms per step, MFU by bench.py's
   formula and peak device memory;
12. the same model in fp32 (TF32 off) for 3 steps, once through the
   kernels (K1's, K2's and K3's FMA variants) and once with
   ``attn_impl="plain"``: step 1's loss and grad norm within 1e-5 relative
   and identical to the last bit;
12b. training checkpoints (T3) on the same bf16 model, config 1 with a
   4-step ``WarmupLR``, the batch of step i drawn from seed + i: two
   uninterrupted 8-step runs must agree bit for bit (losses, grad norms,
   every master leaf); an engine saves synchronously at step 4 and
   asynchronously at step 6 and takes steps 7-8 while the writer persists;
   a fresh engine ``load_checkpoint(dir, auto_resume=True)`` must land on
   step 6 and a third one loads step 4 by tag, and both must finish the
   run bitwise equal to the uninterrupted one; a save of step 8 killed at
   ``ckpt.pre_commit`` must leave ``latest`` and ``find_latest_valid`` on
   step 6; ``init_inference(..., checkpoint=<step 6>)`` must hold the
   checkpoint's module bitwise and launch K6 12 x 16 times for a greedy
   ``generate`` of 4 prompts of 240 with 16 new. K1-K3 = 12 x the phase's
   30 steps, all on the tensor-core variants, every other kernel 0. Prints
   the bytes on disk and the file system, the sync save's wall, the async
   stall beside its bound (the state over 64 GB/s), the async persist,
   the steps in flight beside the clean step, the restore and the peak
   memory. It writes into a fresh directory off tmpfs and removes it;
12c. ZeRO stage 3 at one rank shards nothing: 3 bf16 steps of config 1 at
   stage 3 equal stage 1's bit for bit (losses, grad norms, every master
   leaf), K1-K3 = 12 a step;
12d. data parallelism with ZeRO (T2) on two spawned gloo ranks sharing the
   card (the sharded math and per-rank memory, not a DP speed): GPT-2 125M
   at config 1's widths and depth, phase 11's batch of 8 rows as the
   global micro batch (4 a rank). fp32 (TF32 off), stages 0-3, 3 steps
   each: every stage's losses, grad norms and gathered master equal to
   stage 0's bit for bit on both ranks; the losses within 1e-5 and each
   step's grad norm within 1e-4 relative of phase 12's one-rank kernel
   arm (the norm catches a gradient reduction off by a constant factor,
   which Adam and the clip hide from losses and master); the master's
   elements within 1e-5 of their leaf's largest magnitude from the
   one-rank run's but for at most 0.1% of all of them and 10% of any one
   leaf's, none further than lr / 2: GEMMs of 4 rows a rank round
   otherwise than of 8, and Adam's normalised step turns that into up to
   lr where a gradient is small (phase 12's plain arm against its kernel
   arm is printed beside as the yardstick). A leaf whose one-rank
   gradient stays below 1e-6 of the largest leaf's at every step
   (``layers/bk``: softmax ignores a bias shared by every key) is zero up
   to rounding and takes steps of noise: it is held only to Adam's reach
   (2 x lr a step). bf16, stages
   1-3, 2 steps each (cut from 3 for 18a-18d): each rank's peak memory and held state beside
   ``estimate_zero_memory(n, stage, 2)``; stage 3 must hold 0.45-0.6 of
   stage 1's parameter bytes a rank. K1-K3 = 12 a step on each rank in
   every run, every other kernel 0, bf16 on the tensor cores;
12e. the dp = 2 stage-3 fp32 run saves its checkpoint (rank 0 writes, off
   tmpfs) and takes 2 more steps; two dp = 1 stage-1 engines load the tag
   in the parent and take the same 2 steps: the loaded master bitwise the
   ranks' gathered one (CRC), the two resumed runs bitwise equal, within
   1e-5 of the ranks' continuation;
15a. (run after phase 9i, with 15f, while phase 3's llama-1B weights are
   held; 15b-15e run after 12e) the offload paths' host libraries (T2):
   ``g++`` builds of the host
   Adam, Adagrad and aio (one per source, all started together), the SIMD
   width, the host Adam on GPT-2 125M's 124,439,808 elements against the
   plain FusedAdam arithmetic on the CPU (one fp32 step: the largest
   difference within 1e-3 of the step) and one timed pass; aio writing and
   reading 1 GiB (GB/s beside the file system and the I/O mode, buffered;
   the read is warm); the yardstick, a pinned <-> card ``copy_`` of 1 GiB
   each way;
15b. streamed offload (stage 1, ``pipeline_read`` and ``pipeline_write``,
   pinned, buckets of 2e7 elements) against the on-device stage 1, 4 steps
   each in fp32 (TF32 off) and bf16: losses, grad norms and master bit for
   bit; the bf16 device peak lower by at least the host state's 12 B an
   element less the two largest buckets, less 5%; each step's stream bytes,
   card copy times (GB/s against the yardstick) and exposed wait; the
   step's median wall beside the on-device one; a bf16 async save after
   step 2, resumed by a fresh engine, steps 3-4 bit for bit;
15c. the host-Adam path (stage 2, ``device=cpu`` then ``nvme`` on a file
   system off tmpfs), fp32, 3 steps, against the on-device stage 2 by phase
   12d's bounds (losses 1e-5, grad norms 1e-4, each leaf's share past 1e-5
   of its scale 10%, its largest difference lr / 2, the zero-gradient leaf
   2 x lr a step); ``nvme`` bit for bit ``cpu``; the fp32 peak lower by 90%
   of the moments' bytes (fp32 parameters are the master) and a bf16 pair's
   by 90% of the host state's 12 B an element; each step's host Adam, swap
   read and write and wall;
15d. parameter offload (stage 3, ``device=cpu``; ``nvme`` with
   ``cpu_checkpointing``), fp32, 3 steps, against the on-device stage 3 by
   phase 12d's bounds, ``nvme`` bit for bit ``cpu``; K1 = 24, K2 = K3 = 12
   a step (the forward and the recompute); the peak below the on-device
   run's with its reckoning (resident parameters, two layers, the stash,
   the fp32 logits); the layer copies' rate; then 2 bf16 steps, every K1-K3
   launch on the tensor cores;
15e. inside phase 12d's two ranks: streamed offload at stage 1 bit for bit
   the dp = 2 on-device stage 1 on every rank, and the host Adam at stage 2
   by phase 12d's bounds against it, with each rank's peak;
15f. ZeRO-Inference on llama-1B (``zero={"stage": 3, "offload_param":
   {"device": "cpu"}}``): ``engine(tokens)`` ([2, 256]) logits bit for bit
   the in-memory engine's in bf16 and fp32, K1 = 22; greedy ``generate`` of
   8 tokens on 4 prompts of 120, fp32 streams equal to the in-memory
   ``generate`` (or parting where the streamed engine's top-2 gap is below
   1e-4), bf16's equal streams counted, K1 = 22 x 8; the peak below half
   the in-memory weight bytes; ms a token beside the yardstick's time for
   the layer bytes; an ``nvme`` arm at depth 4 with 2 staging buffers (so
   every token reads every layer file) whose streams equal the ``cpu``
   arm's at that depth;
16a. K1-K3 at head_dim 80 ([4, 1024, 32, 80], causal: GPT-2 2.7B's heads at
   micro 4) in bf16, fp16 and fp32 (TF32 off) against their plain versions
   at the training shape's tolerances, each timed beside its bound, its
   plain version and SDPA (forward; its autograd backward for K2 and K3);
16b. ``compile.fuse_grad_accum`` at gas 4 on config 1's model: each arm's
   step program (a warm-up step, one capture, then one CUDA-graph replay a
   step) against the eager engine on the same microbatches, 4 steps, bit
   for bit (losses, grad norms, loss scales, a digest of every master
   leaf): fp32, bf16, fp16 with the scale written to 2^40 before step 2
   (the overflow's skip and scale walk run in the program), remat, dropout
   0.1; the bf16 arm's step ms and idle share (``torch.profiler`` kernel
   time against the step wall), eager and captured. K1-K3 counters: every
   step's launches on the eager engine, the warm-up's and the capture's on
   the captured one (a replay passes no wrapper);
16c. ``compile.multi_step`` (horizon 4), bf16: at gas 1 and at gas 4 12
   steps bitwise the sequential eager run, 3 windows,
   ``dispatches_per_opt_step`` 0.25, drained losses equal to the returned
   ones, the third window's host wall beside its replay's device time; a
   checkpoint interval of 6 (``checkpoint`` breaks) and a 10-step iterator
   (``data`` breaks) bitwise the sequential run; streamed offload in
   three windows (a warm-up, two captures) bitwise its sequential run,
   host state included;
16d. ``gpt2_config("2.7b")`` at full width (32 heads of 80) and 8 of its 32
   layers (the depth cut to make room for phases 17a-17f), bf16, ZeRO-1,
   remat, micro 4 x T 1024, gas 4: the eager engine 4 steps (K1 = 64, K2 =
   K3 = 32 a step, all tensor-core), then
   ``fuse_grad_accum`` with windows of 2 on the same microbatches, bitwise
   (losses, grad norms, master digest); step ms, MFU, peak and pool memory
   against the reckoned state, idle share;
16e. ``llama_config("1b")`` at micro 2 x T 2048 and ``qwen2_config("0.5b")``,
   at their widths and 4 layers each (cut to 8 for 17a-17e, to 4 for 18a-18d), remat: kernel vs ``attn_impl="plain"``, fp32 step 1 within 1e-5 and 3
   bf16 steps within twice the bf16 rounding of the plain arm; config 1
   with ALiBi (no kernel): the card's fp32 loss against the CPU's within
   1e-5, 3 bf16 steps falling;
17a. K1-K3 against their plain versions at the data pipeline's new lengths:
   a curriculum length of 72 (a multiple of 8, not of 64) and a random-LTD
   kept count of 400, [8, T, 12, 64] causal, fp32 and bf16;
17b. config 1's model at full width and depth, bf16, ZeRO-1, gas 2 under
   ``fuse_grad_accum``, on a seeded synthetic corpus written by
   ``MMapIndexedDatasetBuilder``, analysed by ``DataAnalyzer``, ordered by
   ``DeepSpeedDataSampler`` and loaded through ``initialize(training_data=
   ...)``, curriculum 64 -> 1024: 20 steps with random-LTD (layers 1-10,
   kept 128 -> 1024) and 20 with PLD (theta 0.5); losses falling, K1-K3
   = the layers that ran at each warm-up and capture, reserved memory
   within 10% of one run at the final shape; PLD eager: K1 = kept layers;
17c. config 1 at gas 2 with windows of 2 over the engine dataloader: a
   checkpoint while the window's look-ahead holds batches, resumed in a
   fresh engine, bit for bit the uninterrupted 8 steps;
17d. ``moe_llama_config("1b-8e", moe_top_k=2)`` at full width and 8 of
   its 22 layers (2.35 B parameters; the depth cut to make room for
   18a-18d): fp32 kernel vs plain streams (no capacity drops;
   partings only at a top-2 gap or router margin below 1e-4); bf16 phase
   3's traffic ragged (K4 = 8 a step) and its first 8 requests bucketed
   (K5 = 8 a round),
   windows on steady traffic, ``generate`` (K6 = 8 a token);
17e. the same width at 6 of 22 layers, bf16, ZeRO-1, micro 4 x T 1024,
   gas 2: eager 3 steps, then ``fuse_grad_accum`` 3 steps bit for bit;
   load-balance losses and expert counts; K1-K3 = layers x microbatches;
   fp32 step 1 kernels vs plain within 1e-5;
18a-18d. expert parallelism on two spawned gloo ranks that share the card
   (the sharded math and each rank's memory; not an EP speed), every rank
   started with a process-group timeout and a hard join limit (a hung
   rank fails the run), ``moe_llama_config("1b-8e", moe_top_k=2)`` at full
   width (8 experts of 5376, 33.0 M parameters an expert, 4 a rank); the
   one-rank references are made first in this process:
18a. 4 layers, ``mesh.expert`` 2, bf16, ZeRO-1, micro 2 x T 1024 a rank at
   gas 2, capacity factor 4 (E / k: no token drops), no load-balance loss
   (ep = 2 takes each token shard's, one rank the global batch's: with it
   the two arms would be different functions), 3 steps against one rank on
   the same global batch (micro 4): losses within 1e-3 and grad norms
   within 1e-2 relative, the master past half an Adam step from the
   one-rank master on at most ``EP_LEAF_SHARE`` of a leaf's elements and
   ``EP_MASTER_SHARE`` of all (bf16 rule 12d; set from sound runs, and
   rejecting one expert left without its gradient or the combine's blocks
   out of order, ``tools/torch_ep_fault_probe.py``); each rank holds 4 of
   the 8 experts; K1-K3 = 4 x 2 x 3 a rank, all on the tensor cores; peak
   memory a rank. Then ``moe_quantized_a2a`` (the int8 wire) one step:
   within 2e-2 of the fp wire and not equal to it; and fp32 (TF32 off,
   the model's load-balance loss on) step 1 through the kernels and
   through ``attn_impl="plain"``: the loss equal, the grad norm within
   1e-6 relative;
18b. the same at ``mesh.data`` 2 (no expert axis: the global gate over the
   all-gathered router logits), 2 steps against the one-rank run, the same
   bounds, K1-K3 = 4 x 2 x 2 a rank;
18c. ``groups.initialize(ep_size=2)``, then ``init_inference`` in fp32 at
   8 layers (``EP_DEPTH``; each rank keeps 4 experts) with the eval
   capacity factor 4 (E / k: no drops, so a token shard's gate and the
   global one agree): ``engine(tokens)`` on [2, 128], each rank gating its
   token shard, within 1e-4 of the largest logit of one rank's; greedy
   ``generate`` of 4 x 224 prompts, 32 new: streams equal to one rank's,
   K6 = 8 x 32 a rank; bf16 streams parting from one rank's counted;
18d. the same fp32 engine's ragged ``serve`` of phase 3's first 8
   requests: streams equal to one rank's, every rank's step fingerprint
   equal, K4 = 8 x ragged steps a rank, TPOT recorded;
13. the block-sparse kernels K7 (forward), K8 (dQ) and K9 (dK, dV)
   against their plain versions: the main case at BERT-large widths (B=2,
   16 heads of 64, T=4096, ``FixedSparsityConfig(num_heads=16, block=16)``,
   bidirectional, shared layout), the bench case of
   ``tests/perf/block_sparse_bench.py`` (B=1, NH=8, T=8192, D=64,
   ``BSLongformerSparsityConfig(block=64)``, causal), a per-head BigBird
   layout (one launch per head), a causal Fixed layout, the dead-rows
   layout of ``tests/unit/ops/test_pallas_block_sparse.py`` (exact zeros in
   O and dQ), blocks of 8 and 128, and a layout whose key block 3 has no
   live pair (exact zeros in its dK and dV); fp32 with TF32 off (O and LSE
   within 1e-4, each gradient within 1e-3 of the reference's largest
   magnitude) and bf16 against the plain versions in fp32 on the same bf16
   inputs (O within 2e-2, each gradient within 3e-2 of that magnitude). K7,
   K8 and K9 must take their tensor-core variants in bf16 and their FMA
   variants in fp32 (``launches_fwd_tc``, ``launches_dq_tc``,
   ``launches_dkv_tc``); K7 and K8 run in fp16 too (O and LSE within 2e-2,
   dQ within 3e-2 of its largest magnitude, dead rows exact zeros, every
   call on the tensor cores; timed at the main and bench shapes). At the
   main and bench shapes two bf16 K7 calls must give bitwise-equal O and
   LSE, two K8 calls a bitwise-equal dQ and two K9 calls bitwise-equal dK
   and dV. K8 must keep dS in fp32: on keys within 0.03 of one shared
   vector a head, where rounding dS to the operand dtype would move dQ some
   30 times the output rounding, dQ within 1.5e-2 (bf16) or 3e-3 (fp16) of
   its largest magnitude, a bound the plain version with dS rounded must
   exceed. It times each kernel, its plain
   version, its bound, a yardstick (``scaled_dot_product_attention`` with
   the layout expanded to an element mask, and its autograd backward for
   K8 and K9 together; the port never calls either, with its share of the
   kernel's time) and the port's dense K1-K3 at the same shape, L2 flushed
   before every launch; K7's, K8's and K9's lines carry their units, split
   q or key blocks and fp32 workspace bytes;
14. the sparse main path: ``BertSparseSelfAttention`` at BERT-large width
   (its default ``FixedDefault(16)`` layout) on bf16 hidden states [2,
   4096, 1024], ``wq``, ``wk`` and ``wv`` with fp32 masters updated by
   ``FusedAdam.apply`` and cast to bf16 for each forward, MSE against a
   seeded target, 3 warm-up and 10 timed steps enqueued back to back and
   timed as one window from a synchronize to a synchronize (ms per step and
   tokens/s over the whole window). Beside them, for a reading that
   strays: each step's host enqueue time, each step's interval on the
   card's stream (CUDA events between steps, no synchronize), the garbage
   collections and the allocator's cudaMalloc / cudaFree calls and retries
   inside the window.
   The counts are zeroed just
   before and each of K7-K9 must equal 13 just after, every other kernel 0,
   every K7, K8 and K9 call on the tensor-core variant; every loss finite and the last
   below the first. Then one fp32 step
   (TF32 off) through the kernels and through ``impl="plain"`` (loss within
   1e-5 relative, gradients within 1e-3 of their largest magnitude), and one
   call with a ``key_padding_mask``, which takes the emulation by JAX's rule
   with no K7 launch.

The line before the last is ``{"kernels": [...]}`` (K1-K3 and K7-K9 with
their ``variant`` by dtype and the main path's tensor-core launches and
phase 12b's ``checkpoint`` launches, K1-K3,
K7 and K8 with their fp16 times; K4, K5 and K6 with their split counts and
split-KV launches, K4 with phase 9b's window numbers, its ``spec`` field
(the verify-shape case, phase 9c's and the fp32 speculation's runs and
counts), its ``recovery`` field (phase 9d's and the fp32 recovery's) and
its ``int8``, ``traffic`` and ``fleet`` fields (phases 9e-9g); K5 with the
fp32 int8 bucketed server's launches, K6 with the ``quant.enabled``
generate's and phase 12b's ``checkpoint`` launches; K4, K6 and K1 with a
``tp`` field: each rank's launches on the tensor-parallel paths of phase
9h and the local-shape checks, K4's also phase 9i's; K1-K3 with a
``zero`` field: each rank's launches in phase 12d's runs, and an
``offload`` field: the launches of phases 15b-15e's runs, K1's also phase
15f's; a ``d80`` field: phase 16a's errors and times in each dtype; a
``fused`` field: their counters, launches a step and replays on phases
16b-16e's step programs), a ``data_pipeline`` field (17a's errors, 17b's
runs' counters and graphs, 17c's verdict) and a ``moe`` field (17e's
launches); K4, K5 and K6 with a ``moe`` field (17d's launches); K1-K3, K4
and K6 with an ``expert_parallel`` field (each rank's launches in 18a-18b,
18d and 18c); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, load_jax_params
from deepspeed_tpu_torch.compression.int8 import QuantizedTensor, quantize_params_int8, tree_nbytes
from deepspeed_tpu_torch.inference import decode
from deepspeed_tpu_torch.inference.fleet import FleetRouter, ReplicaHandle
from deepspeed_tpu_torch.inference.journal import RequestJournal
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.inference.spec_decode import Drafter
from deepspeed_tpu_torch.inference.traffic import MultiTenantServer, TenantSpec
from deepspeed_tpu_torch.models import TransformerLM, bert_config, gpt2_config, llama_config, qwen2_config
from deepspeed_tpu_torch.models.moe_transformer import MoETransformerLM, moe_llama_config
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.models.transformer import init_params, param_shapes
from deepspeed_tpu_torch.ops import native
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.sparse_attention import (
    BertSparseSelfAttention,
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    FixedSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import build_block_tables
from deepspeed_tpu_torch.ops.transformer import decode_attention
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.paged_attention import paged_decode_attention, ragged_paged_attention
from deepspeed_tpu_torch.runtime.checkpoint_engine.atomic import find_latest_valid, read_latest_marker
from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import TorchCheckpointEngine
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
from deepspeed_tpu_torch.utils import chaos
from deepspeed_tpu_torch.utils.loadgen import TenantLoad, make_trace, replay

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}  # tensor cores; fp32 without TF32
GARBAGE = 3.0e4  # finite in fp32 and bf16: pages past kv_len and page 0 hold it
R, NH, NKV, D, P, MAXP, NP = 8, 32, 4, 64, 16, 128, 1025


T_START = time.perf_counter()


def emit(**obj):
    """One JSON line; ``t_s`` is the script's wall time when it was
    printed (phase times are the differences)."""
    obj["t_s"] = round(time.perf_counter() - T_START, 3)
    print(json.dumps(obj, default=lambda o: o.item() if hasattr(o, "item") else str(o)), flush=True)


# --- phase 2: the kernel against its plain version --------------------------
def _batch(rs, W, rows, dev, nh=NH, nkv=NKV, d=D, p=P, maxp=MAXP, np_=NP):
    """q [R, W, NH, D] and pools [NP, NKV, P, D] in fp32, every pool slot
    garbage except the live positions of each row's pages; tables of
    distinct random pages ending in -1 sentinels. ``rows`` is a list of
    (kv_len, q_len)."""
    kv_lens = np.array([r[0] for r in rows], np.int32)
    q_lens = np.array([r[1] for r in rows], np.int32)
    kp = np.full((np_, nkv, p, d), GARBAGE, np.float32)
    kp[1::2] = -GARBAGE
    vp = -kp
    pt = np.full((len(rows), maxp), -1, np.int32)
    free = rs.permutation(np.arange(1, np_))
    used = 0
    for r, (kv_len, _) in enumerate(rows):
        n = -(-kv_len // p)
        pt[r, :n] = free[used : used + n]
        used += n
        for i in range(n):
            live = min(p, kv_len - i * p)
            kp[pt[r, i], :, :live] = rs.standard_normal((nkv, live, d))
            vp[pt[r, i], :, :live] = rs.standard_normal((nkv, live, d))
    q = rs.standard_normal((len(rows), W, nh, d)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(q), t(kp), t(vp), t(pt), t(kv_lens), t(q_lens)


def _compare(label, args, scale, dtype, tol):
    """Run the kernel on ``args`` cast to ``dtype`` and hold it against the
    plain version in fp32 on the same (cast) inputs; raises past ``tol``,
    on a non-finite live slot, on a dead row or a slot past ``q_len`` that
    is not exact zeros, or when the call did not run the split-KV kernel
    and its combine. Returns (max abs error on live slots, the cast inputs,
    the split count)."""
    q, kp, vp, pt, kv_lens, q_lens = args
    qd, kd, vd = q.to(dtype), kp.to(dtype), vp.to(dtype)
    ref = ragged_paged_attention(qd.float(), kd.float(), vd.float(), pt, kv_lens, q_lens, scale=scale,
                                 impl="plain")
    before = decode_attention.launches_ragged_split
    out = ragged_paged_attention(qd, kd, vd, pt, kv_lens, q_lens, scale=scale, impl="kernel")
    torch.cuda.synchronize()
    live = torch.arange(q.shape[1], device=q.device)[None, :] < q_lens[:, None]  # [R, W]
    err = (out.float() - ref).abs()[live].max().item()
    dead_zero = bool((out[~live] == 0).all().item())
    finite = bool(torch.isfinite(out.float()[live]).all().item())
    split = decode_attention.launches_ragged_split - before
    if not (err <= tol and dead_zero and finite and split == 1):
        raise AssertionError(f"K4 {label} {dtype}: max_abs_err {err} (tol {tol}), dead rows and slots zero "
                             f"{dead_zero}, finite {finite}, split-KV calls {split}")
    return err, (qd, kd, vd, pt, kv_lens, q_lens), decode_attention.ragged_splits(pt.shape[1], kp.shape[2])


def _bitwise_repeat(label, cast, scale):
    """Two K4 calls on the same inputs: bitwise-equal outputs (the combine
    merges the partials in split order, without atomics)."""
    runs = [ragged_paged_attention(*cast, scale=scale, impl="kernel") for _ in range(2)]
    torch.cuda.synchronize()
    bits = torch.int32 if runs[0].dtype == torch.float32 else torch.int16
    equal = torch.equal(runs[0].view(bits), runs[1].view(bits))
    emit(phase="kernel_determinism", kernel="ragged_paged_attention", case=label, bitwise_equal=equal)
    if not equal:
        raise AssertionError(f"K4 {label}: two calls on the same inputs differ")
    return equal


def _bound(q, pt, kv_lens, q_lens, dtype):
    """Least time for this call: max(bytes / HBM rate, flops / peak). Bytes:
    q and the output once, the page-table row entries and lengths, and the
    K and V of every live page (whole pages, as the pool stores them).
    Flops: 4·D per (query head, visible key) for QK^T and P·V."""
    item = torch.tensor([], dtype=dtype).element_size()
    kv_lens = kv_lens.cpu().numpy().astype(np.int64)
    q_lens = q_lens.cpu().numpy().astype(np.int64)
    pages = -(-kv_lens // P)
    nbytes = 2 * q.numel() * item + 2 * int(pages.sum()) * NKV * P * D * item
    nbytes += 4 * (int(pages.sum()) + 2 * R)
    visible = 0
    for kv_len, q_len in zip(kv_lens, q_lens):
        start = kv_len - q_len
        visible += sum(min(start + w + 1, kv_len) for w in range(q_len))
    flops = 4 * D * NH * visible
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def _time_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (a layer's pages are cold when the serving step reaches them)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _sdpa_inputs(q, kp, vp, pt, kv_lens, q_lens):
    """q [R, NH, W, D], K/V gathered into a contiguous [R, NKV, S, D] cache,
    and the boolean mask of the same causal + length rule."""
    rows, W = q.shape[:2]
    idx = pt.long().clamp(0, NP - 1)
    kc = kp[idx].permute(0, 2, 1, 3, 4).reshape(rows, NKV, MAXP * P, D).contiguous()
    vc = vp[idx].permute(0, 2, 1, 3, 4).reshape(rows, NKV, MAXP * P, D).contiguous()
    kv_pos = torch.arange(MAXP * P, device=q.device)
    q_pos = (kv_lens - q_lens)[:, None] + torch.arange(W, device=q.device)[None, :]
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) & (kv_pos[None, None, :] < kv_lens[:, None, None])
    return q.transpose(1, 2).contiguous(), kc, vc, mask[:, None]


def phase_kernel(dev, flush):
    rs = np.random.default_rng(1234)
    scale = 1.0 / np.sqrt(D)
    batches = {
        "W=1": (1, [(1, 1), (17, 1), (300, 1), (511, 1), (1024, 1), (1500, 1), (2047, 1), (2048, 1)]),
        # chunk at 0, chunk mid-sequence, partial chunk (q_len 7), decode rows,
        # a dead row, a chunk ending at max_seq_len
        "W=32": (32, [(32, 32), (1032, 32), (71, 7), (2048, 1), (513, 1), (0, 0), (2048, 32), (1, 1)]),
        # a speculative verify step (K = 4 drafts): rows of 1 + d tokens in a width-5 window, decode rows
        # and a dead row (q_lens 1, 2, 3, 4, 5, 5, 1, 0)
        "W=5 verify": (5, [(129, 1), (300, 2), (511, 3), (700, 4), (1024, 5), (1500, 5), (2048, 1), (0, 0)]),
    }
    cases = []
    for label, (W, rows) in batches.items():
        args = _batch(rs, W, rows, dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            err, cast, splits = _compare(label, args, scale, dtype, tol)
            bitwise = _bitwise_repeat(f"{label} {str(dtype).replace('torch.', '')}", cast, scale)
            ms = _time_ms(lambda: ragged_paged_attention(*cast, scale=scale, impl="kernel"), 50, flush)
            plain_ms = _time_ms(lambda: ragged_paged_attention(*cast, scale=scale, impl="plain"), 20, flush)
            sq, sk, sv, mask = _sdpa_inputs(*cast)
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, scale=scale, enable_gqa=True), 50, flush)
            q, _, _, pt, kv_lens, q_lens = args
            bound_ms, bound_by, nbytes, flops = _bound(q, pt, kv_lens, q_lens, dtype)
            case = dict(case=f"{label} {str(dtype).replace('torch.', '')}", max_abs_err=err, tol=tol,
                        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by, bytes=nbytes, flops=flops, roofline_share=bound_ms / ms,
                        library_share=library_ms / ms, splits=splits, bitwise_equal=bitwise)
            emit(phase="kernel", kernel="ragged_paged_attention", dead_rows_and_slots_exact_zero=True, **case,
                 launches_ragged_split=decode_attention.launches_ragged_split,
                 library="scaled_dot_product_attention over pre-gathered contiguous K/V (omits the page walk)")
            cases.append(case)
    # split boundaries (correctness only; 16 splits of 128 keys at MAXP=128, P=16): kv_len on a
    # boundary and one key past it (decode rows, and 8-token chunks that end on or cross one), a row
    # with a single key in its last split, a full row, a partial chunk, a dead row
    rows = [(128, 1), (129, 1), (1024, 8), (1025, 8), (1921, 1), (2048, 8), (5, 3), (0, 0)]
    args = _batch(rs, 8, rows, dev)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        err, _, splits = _compare("split boundaries", args, scale, dtype, tol)
        emit(phase="kernel", kernel="ragged_paged_attention", case=f"split boundaries W=8 {dtype}", rows=rows,
             max_abs_err=err, tol=tol, splits=splits, dead_rows_and_slots_exact_zero=True,
             launches_ragged_split=decode_attention.launches_ragged_split)
    # beyond the main path's shapes (correctness only): head_dim 128, a GQA
    # group of 7, pages of 64 keys across the kernel's 64-key tiles
    other = dict(nh=28, nkv=4, d=128, p=64, maxp=8, np_=24)
    args = _batch(rs, 5, [(300, 1), (70, 5), (0, 0), (5, 5), (129, 3)], dev, **other)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        err, _, splits = _compare("D=128 Hg=7 P=64", args, 1.0 / np.sqrt(128), dtype, tol)
        emit(phase="kernel", kernel="ragged_paged_attention", case=f"D=128 Hg=7 P=64 W=5 {dtype}",
             max_abs_err=err, tol=tol, splits=splits, dead_rows_and_slots_exact_zero=True,
             launches_ragged_split=decode_attention.launches_ragged_split)
    return cases


# --- phase 3: the serving main path ------------------------------------------
def _tree_on_card(cfg, seed, dev, dtype):
    """The tree in the JAX layout as tensors on the card in ``dtype``, with
    ``init_params``' distributions (normal std 0.02, output projections
    0.02/sqrt(2L), norm scales 1, biases 0) drawn from a seeded
    ``torch.Generator`` on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree = {}
    for path, shape in param_shapes(cfg).items():
        name = path.rsplit("/", 1)[-1]
        if "norm_scale" in name:
            tree[path] = torch.ones(shape, dtype=dtype, device=dev)
        elif name.startswith("b") or name.endswith("bias"):
            tree[path] = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            std = 0.02 / np.sqrt(2 * cfg.num_layers) if name in ("wo", "w_out") else 0.02
            tree[path] = torch.empty(shape, device=dev).normal_(0.0, std, generator=gen).to(dtype)
    return tree


def _weights(cfg, seed):
    """The JAX tree layout as numpy with the distributions of the JAX
    ``TransformerLM.init`` (normal std 0.02, output projections
    0.02/sqrt(2L), norm scales 1, biases 0), from
    ``numpy.random.default_rng(seed)``."""
    return init_params(cfg, seed)


def _requests(seed, vocab):
    """16 prompts of 64..512 tokens, the 8 longest (302..512) opening with
    one shared 128-token prefix; budgets 32..128."""
    rs = np.random.default_rng(seed)
    shared = rs.integers(0, vocab, 128, dtype=np.int32)
    lens = np.linspace(64, 512, 16).astype(int)
    prompts = []
    for i, n in enumerate(lens):
        if i >= 8:
            prompts.append(np.concatenate([shared, rs.integers(0, vocab, n - 128, dtype=np.int32)]))
        else:
            prompts.append(rs.integers(0, vocab, n, dtype=np.int32))
    budgets = [int(b) for b in np.linspace(32, 128, 16).astype(int)[rs.permutation(16)]]
    return prompts, budgets


def phase_serve(cfg, tree, seed):
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16", paged_kv={"page_size": 16, "max_slots": 8})
    t0 = time.perf_counter()
    engine.load_jax_params(tree)
    torch.cuda.synchronize()
    emit(phase="serve", event="weights_loaded", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in model.parameters()))
    prompts, budgets = _requests(seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the serving main path's
    passes, streams = [], {}
    for name in ("cold", "warm"):
        before = engine.serve_stats() or {"prefix": {"prefix_hit_tokens": 0, "prefix_query_tokens": 0},
                                          "ragged_steps": 0}
        t0 = time.perf_counter()
        outs = streams[name] = engine.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = engine.serve_stats()
        for p, b, o in zip(prompts, budgets, outs):
            if o is None or o.shape != (p.size + b,) or not (o[: p.size] == p).all() \
                    or o.min() < 0 or o.max() >= cfg.vocab_size:
                raise AssertionError(f"serve {name}: malformed output for a {p.size}-token prompt")
        gen = sum(budgets)
        hit = s["prefix"]["prefix_hit_tokens"] - before["prefix"]["prefix_hit_tokens"]
        query = s["prefix"]["prefix_query_tokens"] - before["prefix"]["prefix_query_tokens"]
        rec = dict(phase="serve", pass_=name, requests=len(outs), generated_tokens=gen, wall_s=wall,
                   tokens_per_s=gen / wall, ragged_steps=s["ragged_steps"] - before["ragged_steps"],
                   prefix_hit_rate=hit / query if query else 0.0)
        emit(**rec)
        passes.append(rec)
    counts, split = _counts(), decode_attention.launches_ragged_split
    launches = counts["ragged_paged_attention"]
    s = engine.serve_stats()
    summary = dict(phase="serve", pass_="both", ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"],
                   ragged_steps=s["ragged_steps"], finished=s["finished"], preempted=s["preempted"],
                   prefix=s["prefix"], k4_launches=launches, k4_split_launches=split,
                   num_pages=engine._paged_server.pool.num_pages,
                   kv_pool_bytes=engine._paged_server.pool.cache.hbm_bytes(),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit(**summary)
    if s["finished"] != 32 or passes[1]["prefix_hit_rate"] <= 0:
        raise AssertionError(f"serve: finished {s['finished']} of 32, warm prefix hit rate {passes[1]['prefix_hit_rate']}")
    if launches != cfg.num_layers * s["ragged_steps"] or launches == 0 or sum(counts.values()) != launches:
        raise AssertionError(f"K4 launches {launches} != {cfg.num_layers} x ragged_steps {s['ragged_steps']}")
    if split != launches:
        raise AssertionError(f"serve: {split} of {launches} K4 calls ran the split-KV kernel and combine, want all")
    phase_forward(engine, cfg, seed)
    del engine, model
    torch.cuda.empty_cache()
    return launches, split, streams


def phase_forward(engine, cfg, seed):
    """``engine(tokens)`` once on the serving engine with model profiling on:
    the logits' shape, dtype and finiteness, the ``model_times()`` entry and
    the launches of that call (the CPU tests hold the values against the JAX
    engine's forward)."""
    tokens = torch.from_numpy(np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (2, 256),
                                                                         dtype=np.int32)).cuda()
    engine.profile_model_time()
    before = _counts()
    logits = engine(tokens)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    times = engine.model_times()
    finite = bool(torch.isfinite(logits.float()).all().item())
    emit(phase="forward", call="engine(tokens)", tokens=list(tokens.shape), logits_shape=list(logits.shape),
         logits_dtype=str(logits.dtype).replace("torch.", ""), model_times_s=times, launches=got, finite=finite)
    if logits.shape != (2, 256, cfg.vocab_size) or logits.dtype != torch.bfloat16 or not finite or len(times) != 1:
        raise AssertionError(f"forward: logits {tuple(logits.shape)} {logits.dtype}, finite {finite}, "
                             f"model_times {times}")


# --- phase 4: fp32 greedy-stream identity ------------------------------------
def _top2_gap(cfg, tree_t, context, dev):
    """Top-2 logit gap of the plain path at the position after ``context``
    (one prefill row over a fresh pool)."""
    n = context.size
    pages = -(-n // P)
    maxp = -(-cfg.max_seq_len // P)
    shape = (cfg.num_layers, pages + 1, cfg.num_kv_heads, P, cfg.head_dim)
    kp = torch.zeros(shape, dtype=torch.float32, device=dev)
    vp = torch.zeros_like(kp)
    pt = torch.full((1, maxp), -1, dtype=torch.int32, device=dev)
    pt[0, :pages] = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)
    tokens = torch.from_numpy(context.astype(np.int32))[None].to(dev)
    positions = torch.arange(n, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits = decode._paged_forward(cfg, tree_t, tokens, kp, vp, pt, positions, "plain",
                                       write_valid=positions < n, kv_lens=lens, q_lens=lens)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_streams(cfg, tree, seed, dev):
    model = TransformerLM(cfg)
    paged = {"page_size": 16, "max_slots": 8}
    kernel = dst.init_inference(model, dtype="fp32", paged_kv=dict(paged, attn_impl="kernel"))
    kernel.load_jax_params(tree)
    plain = dst.init_inference(model, dtype="fp32", paged_kv=dict(paged, attn_impl="plain"))
    rs = np.random.default_rng(seed + 1)
    prompts = [rs.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in (40, 100, 200, 333)]
    before = decode_attention.launches
    outs_k = kernel.serve(prompts, max_new_tokens=32)
    if decode_attention.launches == before:
        raise AssertionError("the kernel arm never launched the kernel")
    mid = decode_attention.launches
    outs_p = plain.serve(prompts, max_new_tokens=32)
    if decode_attention.launches != mid:
        raise AssertionError("the plain arm launched the kernel")
    partings = _partings(cfg, model.param_tree(), outs_k, outs_p, dev, "kernel vs plain")
    emit(phase="streams", dtype="float32", requests=len(prompts), new_tokens=32,
         identical=sum(1 for a, b in zip(outs_k, outs_p) if np.array_equal(a, b)), partings=partings)


# --- phases 5 and 6: the decode kernels against their plain versions ----------
def _decode_bound(lens, nh, nkv, d, dtype, extra_bytes=0):
    """Least time of one single-token call: max(bytes / HBM rate, flops /
    peak). Bytes: q and the output once, the live K and V rows once
    (``extra_bytes`` adds what else the call must read: K5's whole live
    pages beyond the live rows and its table entries), the lengths. Flops:
    4·D per (query head, live key) for QK^T and P·V."""
    item = torch.tensor([], dtype=dtype).element_size()
    live = int(np.asarray(lens, np.int64).sum())
    nbytes = 2 * len(lens) * nh * d * item + 2 * live * nkv * d * item + 4 * len(lens) + extra_bytes
    flops = 4 * d * nh * live
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


DECODE_SHAPES = {  # name: (B, S, NH, NKV, D)
    "generate B=16 S=256 NH=32 NKV=4 D=64": (16, 256, 32, 4, 64),
    "MHA B=16 S=256 NH=NKV=12 D=64": (16, 256, 12, 12, 64),
}
DECODE_MAIN = "generate B=16 S=256 NH=32 NKV=4 D=64"
# correctness only, (B, S, NH, NKV, D, kv_lens): a GQA group of 7 at D=128, and S=100 (not a multiple of the
# 64-key split) with kv_len on a split boundary, one past it, S and past S (clamped to S)
DECODE_EXTRA = {
    "Hg=7 D=128 S=256": (5, 256, 28, 4, 128, [1, 64, 65, 200, 256]),
    "S=100 kv_len>S": (6, 100, 32, 4, 64, [0, 1, 64, 65, 100, 150]),
}


def _decode_check(label, args, scale, dtype, tol):
    """K6 on ``args`` (q, k, v in fp32, kv_lens) cast to ``dtype`` against the
    plain version in fp32 on the same (cast) inputs; raises past ``tol``, on
    a non-finite value, on a dead row that is not exact zeros, when a call
    did not run the split kernel and its combine, or when a second call on
    the same inputs is not bitwise equal. Returns (max abs error, the cast
    inputs, the split count)."""
    q, k, v, lens_d = args
    qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
    ref = decode_attention.decode_attention_plain(qd.float(), kd.float(), vd.float(), lens_d, scale)
    before = decode_attention.launches_decode_split
    out = decode_attention.decode_attention_kernel(qd, kd, vd, lens_d, scale)
    again = decode_attention.decode_attention_kernel(qd, kd, vd, lens_d, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    dead_zero = bool((out[lens_d == 0] == 0).all().item())
    finite = bool(torch.isfinite(out.float()).all().item())
    split = decode_attention.launches_decode_split - before
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    equal = torch.equal(out.view(bits), again.view(bits))
    splits = decode_attention.dense_splits(k.shape[1])
    dt = str(dtype).replace("torch.", "")
    emit(phase="kernel_determinism", kernel="decode_attention", case=f"{label} {dt}", bitwise_equal=equal,
         splits=splits)
    if not (err <= tol and dead_zero and finite and split == 2 and equal):
        raise AssertionError(f"K6 {label} {dt}: max_abs_err {err} (tol {tol}), dead rows zero {dead_zero}, "
                             f"finite {finite}, split-KV calls {split} of 2, bitwise equal {equal}")
    return err, (qd, kd, vd, lens_d), splits


def _decode_inputs(rs, B, S, nh, nkv, d, lens, dev):
    q = torch.from_numpy(rs.standard_normal((B, nh, d), dtype=np.float32)).to(dev)
    k, v = (torch.from_numpy(rs.standard_normal((B, S, nkv, d), dtype=np.float32)).to(dev) for _ in range(2))
    return q, k, v, torch.from_numpy(np.asarray(lens, np.int32)).to(dev)


def phase_decode_kernel(dev, flush):
    rs = np.random.default_rng(2345)
    cases = []
    for label, (B, S, nh, nkv, d) in DECODE_SHAPES.items():
        lens = np.linspace(0, S, B).astype(np.int32)  # 0 .. S, ragged
        args = _decode_inputs(rs, B, S, nh, nkv, d, lens, dev)
        scale = 1.0 / np.sqrt(d)
        dtypes = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2))
        for dtype, tol in dtypes if label == DECODE_MAIN else dtypes[:2]:
            err, cast, splits = _decode_check(label, args, scale, dtype, tol)
            qd, kd, vd, lens_d = cast
            ms = _time_ms(lambda: decode_attention.decode_attention_kernel(qd, kd, vd, lens_d, scale), 50, flush)
            plain_ms = _time_ms(lambda: decode_attention.decode_attention_plain(qd, kd, vd, lens_d, scale), 20, flush)
            sq, sk, sv = qd[:, :, None], kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
            mask = (torch.arange(S, device=dev)[None, :] < lens_d[:, None])[:, None, None]
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, scale=scale, enable_gqa=True), 50, flush)
            bound_ms, bound_by, nbytes, flops = _decode_bound(lens, nh, nkv, d, dtype)
            case = dict(case=f"{label} {str(dtype).replace('torch.', '')}", max_abs_err=err, tol=tol, ms=ms,
                        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                        bytes=nbytes, flops=flops, roofline_share=bound_ms / ms, library_share=library_ms / ms,
                        splits=splits, bitwise_equal=True)
            emit(phase="decode_kernel", kernel="decode_attention", dead_rows_exact_zero=True, **case,
                 launches_decode_split=decode_attention.launches_decode_split,
                 library="scaled_dot_product_attention with a length mask over the same cache")
            cases.append(case)
    for label, (B, S, nh, nkv, d, lens) in DECODE_EXTRA.items():
        args = _decode_inputs(rs, B, S, nh, nkv, d, lens, dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.float16, 2e-2)):
            err, _, splits = _decode_check(label, args, 1.0 / np.sqrt(d), dtype, tol)
            emit(phase="decode_kernel", kernel="decode_attention", case=f"{label} {dtype}", kv_lens=lens,
                 max_abs_err=err, tol=tol, splits=splits, dead_rows_exact_zero=True,
                 launches_decode_split=decode_attention.launches_decode_split)
    return cases


PAGED_ROWS = [(1, 1), (17, 1), (300, 1), (0, 0), (1024, 1), (1500, 1), (2047, 1), (2048, 1)]


def _paged_compare(label, args, scale, dtype, tol):
    """K5 on ``args`` (``_batch`` at W=1) cast to ``dtype`` against the plain
    version in fp32 on the same (cast) inputs; raises past ``tol``, on a
    non-finite live row, on a dead row that is not exact zeros, when the
    call did not run the split-KV kernel and its combine, or when a second
    call on the same inputs is not bitwise equal. Returns (max abs error,
    the cast inputs, the split count)."""
    q, kp, vp, pt, kv_lens, _ = args
    qd, kd, vd = q[:, 0].to(dtype), kp.to(dtype), vp.to(dtype)
    ref = paged_decode_attention(qd.float(), kd.float(), vd.float(), pt, kv_lens, scale=scale, impl="plain")
    before = decode_attention.launches_paged_split
    out = paged_decode_attention(qd, kd, vd, pt, kv_lens, scale=scale, impl="kernel")
    again = paged_decode_attention(qd, kd, vd, pt, kv_lens, scale=scale, impl="kernel")
    torch.cuda.synchronize()
    live = kv_lens > 0
    err = (out.float() - ref).abs()[live].max().item()
    dead_zero = bool((out[~live] == 0).all().item())
    finite = bool(torch.isfinite(out.float()[live]).all().item())
    split = decode_attention.launches_paged_split - before
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    equal = torch.equal(out.view(bits), again.view(bits))
    splits = decode_attention.paged_splits(pt.shape[1], kp.shape[2])
    emit(phase="kernel_determinism", kernel="paged_decode_attention", case=f"{label} {dtype}", bitwise_equal=equal,
         splits=splits)
    if not (err <= tol and dead_zero and finite and split == 2 and equal):
        raise AssertionError(f"K5 {label} {dtype}: max_abs_err {err} (tol {tol}), dead rows zero "
                             f"{dead_zero}, finite {finite}, split-KV calls {split} of 2, bitwise equal {equal}")
    return err, (qd, kd, vd, pt, kv_lens), splits


def _paged_bound(kv_lens, dtype):
    """K5's bound at the serving heads: the live rows, whole live pages (the
    pool's unit) beyond them and the table entries."""
    lens = kv_lens.cpu().numpy().astype(np.int64)
    pages = -(-lens // P)
    item = torch.tensor([], dtype=dtype).element_size()
    extra = 2 * int((pages * P - lens).sum()) * NKV * D * item + 4 * int(pages.sum())
    return _decode_bound(lens, NH, NKV, D, dtype, extra)


def phase_paged_kernel(dev, flush):
    rs = np.random.default_rng(3456)
    scale = 1.0 / np.sqrt(D)
    cases = []
    # bucket 8 (the main case, fp32 and bf16) and bucket 1 (bf16: one row, the fewest split blocks)
    for bucket, rows, dtypes in ((8, PAGED_ROWS, ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))),
                                 (1, [(1500, 1)], ((torch.bfloat16, 2e-2),))):
        args = _batch(rs, 1, rows, dev)
        for dtype, tol in dtypes:
            err, cast, splits = _paged_compare(f"bucket {bucket}", args, scale, dtype, tol)
            ms = _time_ms(lambda: paged_decode_attention(*cast, scale=scale, impl="kernel"), 50, flush)
            plain_ms = _time_ms(lambda: paged_decode_attention(*cast, scale=scale, impl="plain"), 20, flush)
            qd, kd, vd, pt, kv_lens = cast
            sq, sk, sv, mask = _sdpa_inputs(qd[:, None], kd, vd, pt, kv_lens, (kv_lens > 0).to(torch.int32))
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, scale=scale, enable_gqa=True), 50, flush)
            bound_ms, bound_by, nbytes, flops = _paged_bound(kv_lens, dtype)
            case = dict(case=f"bucket {bucket} W=1 {str(dtype).replace('torch.', '')}", max_abs_err=err, tol=tol,
                        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                        bytes=nbytes, flops=flops, roofline_share=bound_ms / ms, splits=splits, bitwise_equal=True)
            emit(phase="paged_kernel", kernel="paged_decode_attention", dead_rows_exact_zero=True, **case,
                 library="scaled_dot_product_attention over pre-gathered contiguous K/V (omits the page walk)")
            cases.append(case)
    # beyond the main path's shapes (correctness only): head_dim 128, a GQA
    # group of 7, pages of 64 keys, sentinel ids and a dead row
    other = dict(nh=28, nkv=4, d=128, p=64, maxp=8, np_=24)
    args = _batch(rs, 1, [(300, 1), (70, 1), (0, 0), (5, 1), (129, 1)], dev, **other)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        err, _, _ = _paged_compare("D=128 Hg=7 P=64", args, 1.0 / np.sqrt(128), dtype, tol)
        emit(phase="paged_kernel", kernel="paged_decode_attention", case=f"D=128 Hg=7 P=64 {dtype}",
             max_abs_err=err, tol=tol, dead_rows_exact_zero=True)
    return cases


# --- phase 7: the dense generate path -------------------------------------------
def _check_generated(label, out, prompts, new, vocab):
    out = out.cpu().numpy()
    if out.shape != (prompts.shape[0], prompts.shape[1] + new) or not (out[:, : prompts.shape[1]] == prompts).all() \
            or out.min() < 0 or out.max() >= vocab:
        raise AssertionError(f"{label}: malformed output {out.shape}")
    return out


def phase_generate(cfg, tree, seed):
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16")
    engine.load_jax_params(tree)
    engine.profile_model_time()
    rs = np.random.default_rng(seed)
    prompts = rs.integers(0, cfg.vocab_size, (16, 128), dtype=np.int32)
    new = 128
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the generate main path's
    for name in ("cold", "warm"):
        before = _counts()
        t0 = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_generated(f"generate {name}", out, prompts, new, cfg.vocab_size)
        got = {k: v - before[k] for k, v in _counts().items()}
        emit(phase="generate", pass_=name, batch=16, prompt=128, new_tokens=new, wall_s=wall,
             tokens_per_s=16 * new / wall, ms_per_token=wall * 1e3 / new, launches=got)
        if got["decode_attention"] != cfg.num_layers * new or sum(got.values()) != got["decode_attention"]:
            raise AssertionError(f"generate {name}: launches {got}, want K6 = {cfg.num_layers} x {new} and no other")
    beam_prompts = rs.integers(0, cfg.vocab_size, (2, 224), dtype=np.int32)
    before = _counts()
    t0 = time.perf_counter()
    beam = engine.generate(beam_prompts, max_new_tokens=32, num_beams=4)
    torch.cuda.synchronize()
    beam_wall = time.perf_counter() - t0
    _check_generated("beam", beam, beam_prompts, 32, cfg.vocab_size)
    got = {k: v - before[k] for k, v in _counts().items()}
    if got["decode_attention"] != cfg.num_layers * 32 or sum(got.values()) != got["decode_attention"]:
        raise AssertionError(f"beam: launches {got}, want K6 = {cfg.num_layers} x 32 and no other")
    counts = _counts()
    split = decode_attention.launches_decode_split
    summary = dict(phase="generate", pass_="all", model_times_s=engine.model_times(), beam_wall_s=beam_wall,
                   beam_launches=got, launches=counts, k6_split_launches=split,
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit(**summary)
    if split != counts["decode_attention"]:
        raise AssertionError(f"generate: {split} of {counts['decode_attention']} K6 calls ran the split-KV kernel")
    del engine, model
    torch.cuda.empty_cache()
    return counts["decode_attention"], split


# --- phase 8: the bucketed server -------------------------------------------------
BUCKETED_REQUESTS = 8  # phase 3's 8 last requests (one shared prefix): cut from 16 to make room for 18a-18d
CUT_REQUESTS = 8  # of phase 3's 16 that 9c's n-gram run, 9d's kills and 9e's int8 passes serve (cut for 18a-18d)


def phase_bucketed(cfg, tree, seed):
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16", paged_kv={"page_size": 16, "max_slots": 8, "ragged": False})
    engine.load_jax_params(tree)
    prompts, budgets = _requests(seed, cfg.vocab_size)
    prompts, budgets = prompts[-BUCKETED_REQUESTS:], budgets[-BUCKETED_REQUESTS:]  # they share one prefix
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the bucketed serving path's
    passes = []
    for name in ("cold", "warm"):
        before = engine.serve_stats() or {"prefix": {"prefix_hit_tokens": 0, "prefix_query_tokens": 0},
                                          "decode_steps": 0, "prefill_chunks": 0}
        t0 = time.perf_counter()
        outs = engine.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = engine.serve_stats()
        for p, b, o in zip(prompts, budgets, outs):
            if o is None or o.shape != (p.size + b,) or not (o[: p.size] == p).all() \
                    or o.min() < 0 or o.max() >= cfg.vocab_size:
                raise AssertionError(f"bucketed {name}: malformed output for a {p.size}-token prompt")
        hit = s["prefix"]["prefix_hit_tokens"] - before["prefix"]["prefix_hit_tokens"]
        query = s["prefix"]["prefix_query_tokens"] - before["prefix"]["prefix_query_tokens"]
        rec = dict(phase="bucketed", pass_=name, requests=len(outs), generated_tokens=sum(budgets), wall_s=wall,
                   tokens_per_s=sum(budgets) / wall, decode_steps=s["decode_steps"] - before["decode_steps"],
                   prefill_chunks=s["prefill_chunks"] - before["prefill_chunks"],
                   prefix_hit_rate=hit / query if query else 0.0)
        emit(**rec)
        passes.append(rec)
    counts = _counts()
    launches = counts["paged_decode_attention"]
    s = engine.serve_stats()
    emit(phase="bucketed", pass_="both", ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"], decode_steps=s["decode_steps"],
         prefill_chunks=s["prefill_chunks"], dispatches=s["dispatches"], finished=s["finished"],
         preempted=s["preempted"], prefix=s["prefix"], buckets=engine._paged_server.buckets, k5_launches=launches,
         launches=counts, peak_memory_bytes=torch.cuda.max_memory_allocated())
    if s["finished"] != 2 * BUCKETED_REQUESTS or passes[1]["prefix_hit_rate"] <= 0:
        raise AssertionError(f"bucketed: finished {s['finished']} of {2 * BUCKETED_REQUESTS}, warm prefix hit rate "
                             f"{passes[1]['prefix_hit_rate']}")
    if launches != cfg.num_layers * s["decode_steps"] or launches == 0 or sum(counts.values()) != launches:
        raise AssertionError(f"K5 launches {launches} != {cfg.num_layers} x decode_steps {s['decode_steps']}, "
                             f"or another kernel launched: {counts}")
    split_launches = decode_attention.launches_paged_split
    if split_launches != launches:
        raise AssertionError(f"{split_launches} of {launches} K5 calls ran the split-KV kernel, want all")
    del engine, model
    torch.cuda.empty_cache()
    return launches, split_launches


# --- phase 9: fp32 stream identity of K4, K5 and K6 --------------------------------
def _joint_logprob(model, seqs, prompt_len):
    """Σ log p(token | prefix) over each row's generated part, one full fp32
    forward (the rescoring of tests/unit/inference/test_beam.py)."""
    with torch.no_grad():
        logits = model.apply(model.param_tree(), seqs.long(), train=False)
    logp = torch.log_softmax(logits.float(), dim=-1)
    gen = seqs[:, prompt_len:].long()
    return logp[:, prompt_len - 1 : -1].gather(2, gen[..., None])[..., 0].sum(dim=1).tolist()


def phase_three_way(cfg, tree, seed, dev):
    model = TransformerLM(cfg)
    paged = {"page_size": 16, "max_slots": 8}
    ragged = dst.init_inference(model, dtype="fp32", paged_kv=paged)
    ragged.load_jax_params(tree)
    bucketed = dst.init_inference(model, dtype="fp32", paged_kv=dict(paged, ragged=False))
    windows = dst.init_inference(model, dtype="fp32", paged_kv=WINDOWS)
    rs = np.random.default_rng(seed + 2)
    prompts = rs.integers(0, cfg.vocab_size, (4, 224), dtype=np.int32)
    before = _counts()
    streams = {
        "ragged (K4)": ragged.serve(list(prompts), max_new_tokens=32),
        "bucketed (K5)": bucketed.serve(list(prompts), max_new_tokens=32),
        "generate (K6)": list(ragged.generate(prompts, max_new_tokens=32).cpu().numpy()),
    }
    got = {k: v - before[k] for k, v in _counts().items()}
    if not (got["ragged_paged_attention"] and got["paged_decode_attention"]
            and got["decode_attention"] == cfg.num_layers * 32):
        raise AssertionError(f"fp32 three-way: launches {got}")
    # the window server (CUDA graph replays of K4) must give the ragged streams exactly: same kernels, same rows
    window_streams = windows.serve(list(prompts), max_new_tokens=32)
    ws = windows.serve_stats()
    same = sum(1 for a, b in zip(window_streams, streams["ragged (K4)"]) if np.array_equal(a, b))
    emit(phase="three_way", dtype="float32", arm="ragged windows (K4, CUDA graph)", identical_to_ragged=same,
         window_steps=ws["window_steps"], window_captures=ws["window_captures"])
    if same != len(prompts) or ws["window_steps"] == 0:
        raise AssertionError(f"fp32 windows: {same} of {len(prompts)} streams equal the ragged server's, "
                             f"window_steps {ws['window_steps']}")
    names = list(streams)
    partings = [dict(pair=f"{names[0]} vs {other}", **p) for other in names[1:]
                for p in _partings(cfg, model.param_tree(), streams[other], streams[names[0]], dev, other)]
    identical = {other: sum(1 for a, b in zip(streams[names[0]], streams[other]) if np.array_equal(a, b))
                 for other in names[1:]}
    greedy = ragged.generate(prompts[:2], max_new_tokens=32)
    beam = ragged.generate(prompts[:2], max_new_tokens=32, num_beams=4, length_penalty=0.0)
    g_scores = _joint_logprob(model, greedy, 224)
    b_scores = _joint_logprob(model, beam, 224)
    emit(phase="three_way", dtype="float32", requests=4, new_tokens=32, identical_to_ragged=identical,
         partings=partings, launches=got, beam_logprob=b_scores, greedy_logprob=g_scores)
    if beam.shape != greedy.shape or any(b < g - 1e-3 for g, b in zip(g_scores, b_scores)):
        raise AssertionError(f"fp32 beam joint log-prob {b_scores} below greedy's {g_scores}")
    del bucketed, windows
    torch.cuda.empty_cache()
    # speculation and recovery in fp32 against the ragged server's streams (phases 9c and 9d)
    params = model.param_tree()
    fp32 = dict(spec=_spec_fp32(cfg, params, prompts, streams["ragged (K4)"], dev),
                recovery=_recovery_fp32(cfg, params, prompts, streams["ragged (K4)"], dev))
    del ragged, model, params
    torch.cuda.empty_cache()
    return fp32


# --- phase 9b: multi-step serving windows (one CUDA graph replay a window) -------------
HORIZON = 8
WINDOWS = {"page_size": 16, "max_slots": 8, "ragged": True, "multi_step": {"enable": True, "horizon": HORIZON}}


def _k4_counter_want(cfg, s):
    """K4's wrapper counter from a window server's stats: one a layer a
    single step; a capture passes the wrapper twice a layer and round (the
    warm-up's launch and the graph's record); a replay never passes it."""
    return cfg.num_layers * (s["ragged_steps"] + 2 * HORIZON * s["window_captures"])


K4_KERNELS = ("ragged_split_kernel", "ragged_combine_kernel")


PROFILED_STEPS = 2  # window replays under the profiler: ~32k device events


def _profiled_windows(cfg, params, prompts, new, ref):
    """K4's kernels counted on the device by ``torch.profiler`` (CUDA
    activity) over PROFILED_STEPS steps of a window server whose graph is
    already captured: one split and one combine a layer per single step and
    a layer and round per replay, which the wrappers' counters cannot see.
    The region is kept short: a whole serve pass under the profiler holds
    ~400k device events, and one such run on the card counted one K4 pair
    fewer than the replays and steps launch (ten more passes, in
    tools/torch_window_launches.py, counted every pair). The server then
    runs to its end, and its streams must equal ``ref``."""
    server = PagedServer(cfg, params, page_size=16, max_slots=8, dtype=torch.bfloat16,
                         prefix_cache=True, multi_step=WINDOWS["multi_step"])
    uids = [server.submit(p, max_new_tokens=new) for p in prompts]
    while server.has_work() and (server.prefilling() or server.stats["window_captures"] == 0):
        server.step()
    before = dict(server.stats)
    _zero_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            server.step()
        torch.cuda.synchronize()
    counter = decode_attention.launches
    device = dict.fromkeys(K4_KERNELS, 0)
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            for name in K4_KERNELS:
                if name in evt.key:
                    device[name] += evt.count
    d_ragged = server.stats["ragged_steps"] - before["ragged_steps"]
    d_windows = server.stats["window_steps"] - before["window_steps"]
    server.run()
    outs = [server.take_result(u) for u in uids]
    return dict(steps=PROFILED_STEPS, window_steps=d_windows, ragged_steps=d_ragged,
                window_captures=server.stats["window_captures"] - before["window_captures"],
                k4_counter=counter, k4_counter_want=cfg.num_layers * d_ragged, k4_device_launches=device,
                k4_device_launches_want=cfg.num_layers * (d_ragged + HORIZON * d_windows),
                identical=sum(1 for a, b in zip(outs, ref) if np.array_equal(a, b)))


def _steady_run(server, prompts, new):
    """Serve ``prompts`` x ``new`` tokens on a fresh server, stepping by hand:
    the host wall of every step after prefill, split into windows and single
    steps (the first window holds the server's capture: a warm-up run and
    the graph's recording), and the device time of each window's replay
    from the server's stats. K4's counter is zeroed first."""
    _zero_counts()
    t0 = time.perf_counter()
    uids = [server.submit(p, max_new_tokens=new) for p in prompts]
    while server.prefilling():
        server.step()
    windows, singles = [], []
    while server.has_work():
        w0, t = server.stats["window_steps"], time.perf_counter()
        server.step()
        (windows if server.stats["window_steps"] > w0 else singles).append(time.perf_counter() - t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [server.take_result(u) for u in uids]
    s = server.serve_stats()
    return outs, dict(wall_s=wall, tokens_per_s=len(prompts) * new / wall, tpot_ms=s["tpot_ms"], ttft_ms=s["ttft_ms"],
                      window_steps=s["window_steps"], window_captures=s["window_captures"],
                      window_replays=s["window_device_ms"]["count"], ragged_steps=s["ragged_steps"],
                      window_break_reasons=s["window_break_reasons"],
                      window_ms_p50=float(np.median(windows)) * 1e3 if windows else None,
                      first_window_ms=windows[0] * 1e3 if windows else None,  # a fresh server's capture
                      window_device_ms=s["window_device_ms"],
                      single_step_ms_p50=float(np.median(singles)) * 1e3 if singles else None,
                      k4_counter=decode_attention.launches, launches=_counts())


def phase_windows(cfg, tree, seed, streams):
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16", paged_kv=WINDOWS)
    engine.load_jax_params(tree)
    prompts, budgets = _requests(seed, cfg.vocab_size)
    _zero_counts()  # counts from here are the window serving path's
    for name in ("cold", "warm"):
        before = engine.serve_stats() or {"window_steps": 0, "ragged_steps": 0}
        t0 = time.perf_counter()
        outs = engine.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = engine.serve_stats()
        same = sum(1 for a, b in zip(outs, streams[name]) if np.array_equal(a, b))
        emit(phase="windows", pass_=name, requests=len(outs), generated_tokens=sum(budgets), wall_s=wall,
             tokens_per_s=sum(budgets) / wall, identical_to_phase_3=same,
             window_steps=s["window_steps"] - before["window_steps"],
             ragged_steps=s["ragged_steps"] - before["ragged_steps"])
        if same != len(outs):
            raise AssertionError(f"windows {name}: {same} of {len(outs)} streams equal phase 3's single-step streams")
    s = engine.serve_stats()
    counts = _counts()
    counter = _k4_counter_want(cfg, s)
    emit(phase="windows", pass_="both", ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"], window_steps=s["window_steps"],
         window_captures=s["window_captures"], window_replays=s["window_device_ms"]["count"],
         window_break_reasons=s["window_break_reasons"], ragged_steps=s["ragged_steps"],
         dispatches_per_token=s["dispatches_per_token"], finished=s["finished"], launches=counts,
         k4_counter_want=counter)
    if s["finished"] != 32 or s["window_steps"] == 0 or s["window_captures"] != 1:
        raise AssertionError(f"windows: finished {s['finished']} of 32, window_steps {s['window_steps']}, "
                             f"captures {s['window_captures']}")
    if s["window_device_ms"]["count"] != s["window_steps"]:
        raise AssertionError(f"windows: {s['window_device_ms']['count']} timed replays, {s['window_steps']} windows")
    if counts["ragged_paged_attention"] != counter or sum(counts.values()) != counter:
        raise AssertionError(f"windows: launches {counts}, want K4 = {counter} and no other")
    # steady traffic: 8 requests x 128 new tokens, the single-step server and the window server in turns
    # (single, window, window, single), each a fresh server with the serving engine's settings
    rs = np.random.default_rng(seed + 7)
    steady = [rs.integers(0, cfg.vocab_size, 128, dtype=np.int32) for _ in range(8)]
    params = engine.module.param_tree()
    runs, ref = [], None
    for multi_step in (None, WINDOWS["multi_step"], WINDOWS["multi_step"], None):
        server = PagedServer(cfg, params, page_size=16, max_slots=8, dtype=torch.bfloat16,
                             prefix_cache=True, multi_step=multi_step)
        outs, rec = _steady_run(server, steady, 128)
        ref = ref or outs
        rec.update(mode="windows" if multi_step else "single-step",
                   identical=sum(1 for a, b in zip(outs, ref) if np.array_equal(a, b)))
        want = _k4_counter_want(cfg, rec)
        if multi_step:
            rec.update(k4_counter_want=want,
                       window_idle_share=1.0 - rec["window_device_ms"]["p50"] / rec["window_ms_p50"])
        emit(phase="windows_steady", requests=8, new_tokens=128, **rec)
        if rec["identical"] != 8 or rec["k4_counter"] != want or sum(rec["launches"].values()) != want:
            raise AssertionError(f"windows steady {rec['mode']}: {rec['identical']} of 8 streams equal, "
                                 f"K4 counter {rec['k4_counter']} want {want}, launches {rec['launches']}")
        if multi_step and (rec["window_steps"] == 0 or rec["window_captures"] != 1
                           or rec["window_replays"] != rec["window_steps"]):
            raise AssertionError(f"windows steady: window_steps {rec['window_steps']}, captures "
                                 f"{rec['window_captures']}, timed replays {rec['window_replays']}")
        runs.append(rec)
        del server
    # the replays launch K4 without passing its wrapper: count its kernels on the device
    profiled = _profiled_windows(cfg, params, steady, 128, ref)
    emit(phase="windows", pass_="profiled", **profiled)
    if (profiled["identical"] != 8 or profiled["window_steps"] == 0 or profiled["window_captures"] != 0
            or any(n != profiled["k4_device_launches_want"] for n in profiled["k4_device_launches"].values())
            or profiled["k4_counter"] != profiled["k4_counter_want"]):
        raise AssertionError(f"windows profiled: {profiled}")
    del engine, model
    torch.cuda.empty_cache()
    record = dict(serve=dict(window_steps=s["window_steps"], window_captures=s["window_captures"],
                             k4_counter=counts["ragged_paged_attention"], k4_counter_want=counter),
                  profiled=profiled,
                  steady=[{k: r[k] for k in ("mode", "tokens_per_s", "tpot_ms", "window_steps", "window_ms_p50",
                                            "window_device_ms", "single_step_ms_p50") if k in r} for r in runs])
    return record, steady, ref


# --- phase 9c: speculative serving (S4) ------------------------------------------------------
SPEC_K = 4  # drafts a verify row carries (paged_kv's draft width, a K4 window of 5)
SERVE = {"page_size": 16, "max_slots": 8}


class OracleDrafter(Drafter):
    """Drafts each request's known future (a speculation-off stream of the
    same traffic), so every draft the model agrees with is accepted;
    ``corrupt_at`` changes that index of every proposal, capping the
    accepted prefix there; with ``skip_every`` each request's n-th, 2n-th,
    ... proposal is empty (rows in step skip together, so the bucketed
    server runs plain K5 rounds between its verify rounds)."""

    def __init__(self, futures, vocab, corrupt_at=None, skip_every=0):
        self.futures, self.vocab, self.corrupt_at, self.skip_every = futures, vocab, corrupt_at, skip_every
        self.asked = {}

    def propose(self, uid, context, k):
        self.asked[uid] = n = self.asked.get(uid, 0) + 1
        if self.skip_every and n % self.skip_every == 0:
            return np.zeros(0, np.int32)
        cont = self.futures[uid][context.size : context.size + k].astype(np.int32)
        if self.corrupt_at is not None and cont.size > self.corrupt_at:
            cont[self.corrupt_at] = (cont[self.corrupt_at] + 1) % self.vocab
        return cont


def _same(outs, ref):
    return sum(1 for a, b in zip(outs, ref) if np.array_equal(a, b))


def _want_counts(cfg, server, s):
    """The counts a serving pass must leave: K4 = layers x ragged steps (and
    the window captures' warm-up and record), K5 = layers x plain bucketed
    rounds, every other kernel 0 (a bucketed verify round and a prefill
    chunk attend through the plain version, as JAX's XLA does)."""
    want = dict.fromkeys(_counts(), 0)
    if server.ragged:
        want["ragged_paged_attention"] = _k4_counter_want(cfg, s)
    else:
        want["paged_decode_attention"] = cfg.num_layers * s["decode_steps"]
    return want


def _spec_stats(s):
    return {k: s[k] for k in ("spec_rounds", "spec_drafted", "spec_accepted", "spec_accept_rate",
                              "spec_mean_accepted_per_round", "spec_accept_hist", "decode_steps", "ragged_steps",
                              "dispatches", "dispatches_per_token")}


def _spec_run(cfg, server, prompts, new, ref):
    """One serve on a fresh server, the counts zeroed just before: streams
    equal to ``ref`` (counted), tok/s, TPOT p50, the speculation stats and
    the kernel counts, which must be the pass's exactly."""
    _zero_counts()
    t0 = time.perf_counter()
    outs = server.serve(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = server.serve_stats()
    counts, want = _counts(), _want_counts(cfg, server, s)
    gen = sum(o.size - p.size for o, p in zip(outs, prompts))
    rec = dict(identical=_same(outs, ref), requests=len(prompts), generated_tokens=gen, wall_s=wall,
               tokens_per_s=gen / wall, tpot_ms=s["tpot_ms"], **_spec_stats(s), launches=counts)
    if counts != want or s["finished"] != len(prompts) or server.pool.used_pages() != 0:
        raise AssertionError(f"spec run: launches {counts} want {want}, finished {s['finished']}, "
                             f"pages left {server.pool.used_pages()}")
    return outs, rec


def width_logits(cfg, params, contexts, drafts, dev):
    """Each context's next token scored as a decode row (a width-1 ragged
    step) and as the first slot of a verify row (width 5: the token and 4
    drafts, which it cannot see), in steps of 8 rows (the contexts live,
    the rest dead, as the server pads) through K4, after the contexts were
    written into fresh pools (plain attention): the [len(contexts), V]
    logits of both steps, in fp32."""
    R = 8
    dtype = params["embed"]["tokens"].dtype
    maxp = -(-cfg.max_seq_len // P)
    per_row = [-(-(c.size + SPEC_K) // P) for c in contexts]
    shape = (cfg.num_layers, sum(per_row) + 1, cfg.num_kv_heads, P, cfg.head_dim)
    kp, vp = torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev)
    pt = np.full((R, maxp), -1, np.int32)
    first = 1
    for r, n in enumerate(per_row):
        pt[r, :n] = np.arange(first, first + n)
        first += n
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    live = len(contexts)
    lens = np.zeros(R, np.int32)
    lens[:live] = [c.size - 1 for c in contexts]
    out = []
    with torch.no_grad():
        for r, c in enumerate(contexts):
            n = int(lens[r])
            decode._paged_forward(cfg, params, t(c[:n])[None], kp, vp, t(pt[r : r + 1]), t(np.arange(n))[None],
                                  "plain", kv_lens=t([n]), q_lens=t([n]))
        for W in (1, SPEC_K + 1):
            tokens = np.zeros((R, W), np.int32)
            tokens[:live] = [np.concatenate([c[-1:], d[: W - 1]]) for c, d in zip(contexts, drafts)]
            q_lens = np.where(np.arange(R) < live, W, 0).astype(np.int32)
            positions = np.where(q_lens[:, None] > 0, lens[:, None] + np.arange(W)[None, :], 0)
            logits = decode._paged_forward(cfg, params, t(tokens), kp.clone(), vp.clone(), t(pt), t(positions), "auto",
                                           write_valid=t(np.arange(W)[None, :] < q_lens[:, None]).bool(),
                                           kv_lens=t(np.where(q_lens > 0, lens + W, 0)), q_lens=t(q_lens))
            out.append(logits[:live, 0].float())
    return out


def _width_rounding(cfg, params, streams, prompt_len, dev):
    """``width_logits`` over the 8 streams at 4 positions of their
    generated part (each stream's own next tokens as the drafts): the
    largest and mean logit difference, the rows whose argmax moved, and
    the smallest top-2 gap of the decode rows."""
    diffs, moved, gaps = [], 0, []
    for at in (prompt_len + 1, prompt_len + 9, prompt_len + 17, prompt_len + 25):
        w1, w5 = width_logits(cfg, params, [o[:at] for o in streams], [o[at : at + SPEC_K] for o in streams], dev)
        diffs += (w1 - w5).abs().amax(dim=1).tolist()
        moved += int((w1.argmax(dim=1) != w5.argmax(dim=1)).sum())
        top = torch.topk(w1, 2, dim=1).values
        gaps += (top[:, 0] - top[:, 1]).tolist()
    return dict(positions=len(diffs), max_abs_logit_diff=max(diffs), mean_abs_logit_diff=float(np.mean(diffs)),
                argmax_moved=moved, min_top2_gap=min(gaps))


def phase_spec(cfg, tree, seed, streams, steady, steady_ref, dev):
    """(a) the steady traffic with an oracle drafter, then the oracle
    corrupted at index 2, against phase 9b's single-step streams; (c) one
    bucketed pass with the oracle; (b) phase 3's traffic through
    ``init_inference(..., spec_decode={"enable": True})`` (the n-gram
    drafter); and the logit difference of a token scored at width 1 and
    at width 5. bf16: streams that part from speculation-off are counted,
    not refused (the card's GEMMs round by width)."""
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16", paged_kv=SERVE, spec_decode={"enable": True})
    engine.load_jax_params(tree)
    params = engine.module.param_tree()
    futures = dict(enumerate(steady_ref))
    runs = {}
    for name, corrupt, ragged in (("oracle", None, True), ("oracle corrupt@2", 2, True),
                                  ("bucketed oracle, every 3rd round plain", None, False)):
        server = PagedServer(cfg, params, dtype=torch.bfloat16, prefix_cache=True, ragged=ragged,
                             drafter=OracleDrafter(futures, cfg.vocab_size, corrupt, skip_every=0 if ragged else 3),
                             spec_decode={"max_draft": SPEC_K}, **SERVE)
        _, rec = _spec_run(cfg, server, steady, 128, steady_ref)
        emit(phase="spec", run=name, traffic="steady 8 x 128 new", dtype="bfloat16", **rec)
        runs[name] = rec
        del server
    bucketed = runs["bucketed oracle, every 3rd round plain"]
    if (runs["oracle"]["spec_rounds"] == 0 or runs["oracle corrupt@2"]["spec_accept_hist"][3:] != [0, 0]
            or bucketed["spec_rounds"] == 0 or bucketed["decode_steps"] == 0):
        raise AssertionError(f"spec: {runs}")
    prompts, budgets = _requests(seed, cfg.vocab_size)
    prompts, budgets = prompts[:CUT_REQUESTS], budgets[:CUT_REQUESTS]
    _zero_counts()
    t0 = time.perf_counter()
    outs = engine.serve(prompts, max_new_tokens=budgets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = engine.serve_stats()
    counts, want = _counts(), _want_counts(cfg, engine._paged_server, s)
    rec = dict(identical_to_phase_3=_same(outs, streams["cold"][:CUT_REQUESTS]), requests=len(outs),
               tokens_per_s=sum(budgets) / wall,
               wall_s=wall, tpot_ms=s["tpot_ms"], **_spec_stats(s), launches=counts)
    emit(phase="spec", run="n-gram (init_inference spec_decode)", traffic="phase 3", dtype="bfloat16", **rec)
    runs["ngram"] = rec
    if counts != want or s["finished"] != len(prompts):
        raise AssertionError(f"spec n-gram: launches {counts} want {want}, finished {s['finished']}")
    rounding = _width_rounding(cfg, params, steady_ref, 128, dev)
    emit(phase="spec", run="decode row (W=1) vs verify row (W=5) logits", dtype="bfloat16", **rounding)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs={k: {f: v[f] for f in ("identical", "identical_to_phase_3", "spec_rounds", "spec_accept_rate",
                                             "ragged_steps", "decode_steps", "launches", "tokens_per_s")
                          if f in v} for k, v in runs.items()},
                width_rounding_bf16=rounding)


def _spec_fp32(cfg, params, prompts, ref, dev):
    """fp32 speculation (TF32 off) on phase 9's prompts: the oracle drafter
    from the ragged server's streams, ragged (K4 verify rows) and bucketed
    (plain verify): streams equal to speculation-off, or parting where the
    plain top-2 gap is below 1e-4; the width-rounding logits in fp32."""
    recs = {}
    for name, ragged in (("ragged oracle", True), ("bucketed oracle, every 3rd round plain", False)):
        server = PagedServer(cfg, params, dtype=torch.float32, prefix_cache=True, ragged=ragged,
                             drafter=OracleDrafter(dict(enumerate(ref)), cfg.vocab_size,
                                                   skip_every=0 if ragged else 3),
                             spec_decode={"max_draft": SPEC_K}, **SERVE)
        outs, rec = _spec_run(cfg, server, list(prompts), 32, ref)
        rec["partings"] = _partings(cfg, params, outs, ref, dev, f"fp32 spec {name}")
        emit(phase="spec", run=name, dtype="float32", **rec)
        recs[name] = {k: rec[k] for k in ("identical", "spec_rounds", "spec_accept_rate", "partings", "launches")}
        del server
    recs["width_rounding_fp32"] = _width_rounding(cfg, params, ref, prompts.shape[1], dev)
    emit(phase="spec", run="decode row (W=1) vs verify row (W=5) logits", dtype="float32",
         **recs["width_rounding_fp32"])
    return recs


def _partings(cfg, params, outs, ref, dev, label):
    """Where each stream first parts from ``ref``, with the plain fp32 top-2
    logit gap there; raises at a gap of 1e-4 or more."""
    partings = []
    for i, (a, b) in enumerate(zip(outs, ref)):
        if a.shape != b.shape:
            raise AssertionError(f"{label} stream {i}: shapes {a.shape} vs {b.shape}")
        diff = np.nonzero(a != b)[0]
        if diff.size:
            at = int(diff[0])
            gap = _top2_gap(cfg, params, b[:at], dev)
            partings.append({"request": i, "position": at, "plain_top2_gap": gap})
            if gap >= 1e-4:
                raise AssertionError(f"{label} stream {i} parts at {at} with plain top-2 gap {gap} >= 1e-4")
    return partings


# --- phase 9d: crash and recovery (S6) ---------------------------------------------------------
def _recovery_fp32(cfg, params, prompts, ref, dev):
    """fp32 (TF32 off): a journaled ragged server on phase 9's prompts
    killed at ``serve.mid_step`` (hit 12: prefill done, decoding), a fresh
    server on the replayed journal recovers every request, and its streams
    equal the uncrashed ones (or part where the plain top-2 gap is below
    1e-4)."""
    with tempfile.TemporaryDirectory(prefix="journal_") as jdir:
        server = PagedServer(cfg, params, dtype=torch.float32, prefix_cache=True, journal=RequestJournal(jdir),
                             **SERVE)
        for p in prompts:
            server.submit(p, max_new_tokens=32)
        chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("serve.mid_step", hit=12)]))
        try:
            server.run()
            raise AssertionError("chaos never fired at serve.mid_step hit 12")
        except chaos.ChaosKilled:
            pass
        finally:
            chaos.uninstall()
        live, emitted = len(server._queue) + len(server._active), server.stats["emitted_tokens"]
        del server
        gc.collect()
        torch.cuda.empty_cache()
        states, next_uid = RequestJournal.replay(jdir)
        server = PagedServer(cfg, params, dtype=torch.float32, prefix_cache=True, journal=RequestJournal(jdir),
                             **SERVE)
        _zero_counts()
        recovered = server.recover(states, next_uid)
        server.run()
        outs = [server.take_result(u) for u in range(len(prompts))]
        s = server.serve_stats()
        counts, want = _counts(), _want_counts(cfg, server, s)
    rec = dict(killed_live=live, killed_emitted=emitted, recovered=recovered, identical=_same(outs, ref),
               partings=_partings(cfg, params, outs, ref, dev, "fp32 recovery"), launches=counts)
    emit(phase="recovery", point="serve.mid_step", hit=12, dtype="float32", **rec)
    if recovered != live or live == 0 or counts != want:
        raise AssertionError(f"fp32 recovery: recovered {recovered} of {live} live; launches {counts} want {want}")
    return rec


def _killed(engine, prompts, budgets, point, hit):
    """``engine.serve`` until ``chaos`` kills it at ``point``'s ``hit``-th
    arrival: the dead server's stats, its live requests and its counts."""
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule(point, hit=hit)]))
    try:
        engine.serve(prompts, max_new_tokens=budgets)
        raise AssertionError(f"chaos never fired at {point} hit {hit}")
    except chaos.ChaosKilled:
        pass
    finally:
        chaos.uninstall()
    dead = engine._paged_server
    return dead, dead.serve_stats(), len(dead._queue) + len(dead._active)


def phase_recovery(cfg, tree, seed, streams):
    """A journaled engine on phase 3's traffic killed at ``serve.mid_step``
    (hit 40), then with windows at ``serve.mid_window`` (hit 2); the dead
    engine is dropped and a fresh engine on the same ``journal.dir``
    recovers (``stats["recovered"]`` = the live requests) and finishes every
    request. bf16: streams equal to phase 3's are counted. Then the journal's
    cost on the steady traffic (8 x 64 new), off and on in turns."""
    prompts, budgets = _requests(seed, cfg.vocab_size)
    prompts, budgets = prompts[:CUT_REQUESTS], budgets[:CUT_REQUESTS]
    recs = {}
    for name, paged, point, hit in (("mid_step", SERVE, "serve.mid_step", 40),
                                    ("mid_window", WINDOWS, "serve.mid_window", 2)):
        with tempfile.TemporaryDirectory(prefix="journal_") as jdir:
            jcfg = {"enabled": True, "dir": jdir}
            engine = dst.init_inference(TransformerLM(cfg), dtype="bf16", paged_kv=paged, journal=jcfg)
            engine.load_jax_params(tree)
            _zero_counts()
            dead, s, live = _killed(engine, prompts, budgets, point, hit)
            counts, want = _counts(), _want_counts(cfg, dead, s)
            killed = dict(finished=s["finished"], live=live, emitted_tokens=s["emitted_tokens"],
                          ragged_steps=s["ragged_steps"], window_steps=s["window_steps"], launches=counts)
            if counts != want:
                raise AssertionError(f"recovery {name}: the killed pass launched {counts}, want {want}")
            del dead, engine
            gc.collect()
            torch.cuda.empty_cache()
            engine = dst.init_inference(TransformerLM(cfg), dtype="bf16", paged_kv=paged, journal=jcfg)
            engine.load_jax_params(tree)
            _zero_counts()
            t0 = time.perf_counter()
            engine.serve([])  # builds the server, which replays the journal and recovers; runs them to the end
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            server = engine._paged_server
            s2 = server.serve_stats()
            outs = [server.take_result(u) for u in range(len(prompts))]
            counts, want = _counts(), _want_counts(cfg, server, s2)
            rec = dict(killed=killed, recovered=s2["recovered"], finished_after=s2["finished"], wall_s=wall,
                       identical_to_phase_3=_same(outs, streams["cold"][:CUT_REQUESTS]),
                       ragged_steps=s2["ragged_steps"],
                       window_steps=s2["window_steps"], window_captures=s2["window_captures"], launches=counts,
                       segments=len(RequestJournal.segments(jdir)))
            emit(phase="recovery", point=point, hit=hit, dtype="bfloat16", **rec)
            for p, b, o in zip(prompts, budgets, outs):
                if o is None or o.shape != (p.size + b,) or not (o[: p.size] == p).all():
                    raise AssertionError(f"recovery {name}: a request is missing or malformed")
            if s2["recovered"] != live or live == 0 or counts != want:
                raise AssertionError(f"recovery {name}: recovered {s2['recovered']} of {live} live; launches "
                                     f"{counts} want {want}")
            recs[name] = {k: rec[k] for k in ("recovered", "identical_to_phase_3", "launches")}
            del server, engine
            gc.collect()
            torch.cuda.empty_cache()
    recs["journal_cost"] = _journal_cost(cfg, tree, seed)
    return recs


def _journal_cost(cfg, tree, seed):
    """The steady traffic (8 x 64 new) on fresh single-step servers, the
    journal off and on in turns (off, on, on, off): tok/s, TPOT
    p50 and, journal on, each step's ``journal.sync`` (write, flush,
    fsync)."""
    model = TransformerLM(cfg)
    engine = dst.init_inference(model, dtype="bf16", paged_kv=SERVE)
    engine.load_jax_params(tree)
    params = engine.module.param_tree()
    rs = np.random.default_rng(seed + 7)
    steady = [rs.integers(0, cfg.vocab_size, 128, dtype=np.int32) for _ in range(8)]
    sync_s = []
    original = RequestJournal.sync

    def timed(self):
        t0 = time.perf_counter()
        original(self)
        sync_s.append(time.perf_counter() - t0)

    runs, ref = [], None
    RequestJournal.sync = timed
    try:
        for on in (False, True, True, False):
            with tempfile.TemporaryDirectory(prefix="journal_") as jdir:
                server = PagedServer(cfg, params, dtype=torch.bfloat16, prefix_cache=True,
                                     journal=RequestJournal(jdir) if on else None, **SERVE)
                del sync_s[:]
                t0 = time.perf_counter()
                outs = server.serve(steady, max_new_tokens=64)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ref = ref or outs
                s = server.serve_stats()
                rec = dict(journal=on, tokens_per_s=8 * 64 / wall, tpot_ms_p50=s["tpot_ms"]["p50"],
                           identical=_same(outs, ref), steps=s["ragged_steps"])
                if on:
                    rec.update(syncs=len(sync_s), sync_ms_p50=float(np.median(sync_s)) * 1e3,
                               sync_ms_mean=float(np.mean(sync_s)) * 1e3, sync_ms_max=float(np.max(sync_s)) * 1e3)
                emit(phase="recovery", run="journal cost", traffic="steady 8 x 64 new", **rec)
                runs.append(rec)
                del server
    finally:
        RequestJournal.sync = original
    del engine, model
    torch.cuda.empty_cache()
    return runs


# --- phase 9e: int8 serving weights and quant.enabled (S8) ------------------------------------
INT8 = dict(SERVE, sharded={"weight_quant_bits": 8})


def _round_bytes(cfg, params, rows):
    """Bytes a decode round must read of the weights: every leaf once (the
    codes and scales of the int8 ones), but only ``rows`` rows of the
    embedding table, which a round gathers."""
    table = params["embed"]["tokens"]
    return tree_nbytes(params) - tree_nbytes(table) + rows * cfg.hidden_size * table.element_size()


def _tree_logits(cfg, params, tokens, dev):
    """Logits ``[B, T, V]`` of ``tokens`` over fresh pools, one prefill row a
    sequence through the plain attention (no kernel launch)."""
    B, T = tokens.shape
    pages = -(-T // P)
    maxp = -(-cfg.max_seq_len // P)
    dtype = params["final_norm_scale"].dtype
    kp = torch.zeros((cfg.num_layers, B * pages + 1, cfg.num_kv_heads, P, cfg.head_dim), dtype=dtype, device=dev)
    vp = torch.zeros_like(kp)
    pt = torch.full((B, maxp), -1, dtype=torch.int32, device=dev)
    pt[:, :pages] = torch.arange(1, B * pages + 1, dtype=torch.int32, device=dev).view(B, pages)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T).contiguous()
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    with torch.no_grad():
        return decode._paged_forward(cfg, params, tokens, kp, vp, pt, positions, "plain",
                                     write_valid=positions < T, kv_lens=lens, q_lens=lens)


def phase_int8(cfg, tree, seed, streams, steady, steady_ref, dev):
    """``paged_kv.sharded.weight_quant_bits=8`` in bf16 on phase 3's traffic
    (cold, warm), the logit difference to the unquantized tree, the steady
    traffic with windows taking int8 and bf16 servers in turns, fp32
    identities (K4 vs plain, a bucketed K5 server) and a ``quant.enabled``
    engine's forward and ``generate``."""
    engine = dst.init_inference(TransformerLM(cfg), dtype="bf16", paged_kv=INT8)
    engine.load_jax_params(tree)
    server = engine._paged_server = engine._build_paged_server()
    qparams, params = server.params, engine.module.param_tree()
    sizes = dict(served_tree_bytes=tree_nbytes(qparams), bf16_tree_bytes=tree_nbytes(params),
                 int8_leaves=sorted(k for k, v in qparams["layers"].items() if isinstance(v, QuantizedTensor))
                 + (["lm_head"] if isinstance(qparams["lm_head"], QuantizedTensor) else []))
    emit(phase="int8", event="server_built", **sizes)
    if not isinstance(qparams["layers"]["wq"], QuantizedTensor) or isinstance(params["layers"]["wq"], QuantizedTensor):
        raise AssertionError("int8: the server's tree is not quantized, or the engine's tree is")
    prompts, budgets = _requests(seed, cfg.vocab_size)
    prompts, budgets = prompts[-CUT_REQUESTS:], budgets[-CUT_REQUESTS:]  # one shared prefix: warm hits
    _zero_counts()
    passes = {}
    for name in ("cold", "warm"):
        before = server.serve_stats()
        t0 = time.perf_counter()
        outs = server.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for p, b, o in zip(prompts, budgets, outs):
            if o is None or o.shape != (p.size + b,) or not (o[: p.size] == p).all():
                raise AssertionError(f"int8 {name}: a request is missing or malformed")
        s = server.serve_stats()
        passes[name] = dict(wall_s=wall, tokens_per_s=sum(budgets) / wall,
                            identical_to_phase_3=_same(outs, streams[name][-CUT_REQUESTS:]),
                            ragged_steps=s["ragged_steps"] - before["ragged_steps"])
        emit(phase="int8", pass_=name, requests=len(outs), generated_tokens=sum(budgets), **passes[name])
    s = server.serve_stats()
    counts, want = _counts(), _want_counts(cfg, server, s)
    emit(phase="int8", pass_="both", ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"], finished=s["finished"],
         ragged_steps=s["ragged_steps"], launches=counts)
    if s["finished"] != 2 * len(prompts) or counts != want or counts["ragged_paged_attention"] == 0:
        raise AssertionError(f"int8 serve: finished {s['finished']} of {2 * len(prompts)}, launches {counts} "
                             f"want {want}")
    tokens = torch.from_numpy(np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (2, 256),
                                                                         dtype=np.int32)).to(dev)
    ref_logits = _tree_logits(cfg, params, tokens, dev).float()
    q_logits = _tree_logits(cfg, qparams, tokens, dev).float()
    scale = ref_logits.abs().max().item()
    diff = (q_logits - ref_logits).abs().max().item()
    finite = bool(torch.isfinite(q_logits).all().item())
    emit(phase="int8", event="logits [2, 256]", max_abs_diff=diff, logit_scale=scale, relative=diff / scale,
         jax_test_bound_relative=1e-2, finite=finite)
    if not finite:
        raise AssertionError("int8: the quantized forward's logits are not finite")
    del ref_logits, q_logits, server, engine
    torch.cuda.empty_cache()
    # steady traffic with windows, int8 and bf16 servers in turns
    runs = []
    for label, tree_ in (("int8", qparams), ("bf16", params), ("bf16", params), ("int8", qparams)):
        srv = PagedServer(cfg, tree_, dtype=torch.bfloat16, prefix_cache=True, multi_step=WINDOWS["multi_step"],
                          **SERVE)
        outs, rec = _steady_run(srv, steady, 128)
        round_ms = rec["window_device_ms"]["p50"] / HORIZON if rec["window_device_ms"]["count"] else None
        bound_ms = _round_bytes(cfg, tree_, SERVE["max_slots"]) / HBM_BYTES_PER_S * 1e3
        rec.update(weights=label, replay_ms_per_round=round_ms, weight_read_bound_ms=bound_ms,
                   identical_to_bf16_single_step=_same(outs, steady_ref), k4_counter_want=_k4_counter_want(cfg, rec))
        emit(phase="int8_steady", requests=8, new_tokens=128, **rec)
        if rec["k4_counter"] != rec["k4_counter_want"] or rec["window_steps"] == 0 or rec["window_captures"] != 1:
            raise AssertionError(f"int8 steady {label}: K4 counter {rec['k4_counter']} want {rec['k4_counter_want']}, "
                                 f"window_steps {rec['window_steps']}, captures {rec['window_captures']}")
        runs.append({k: rec[k] for k in ("weights", "tokens_per_s", "tpot_ms", "replay_ms_per_round",
                                         "weight_read_bound_ms", "identical_to_bf16_single_step")})
        del srv
        torch.cuda.empty_cache()
    del qparams, params
    torch.cuda.empty_cache()
    fp32 = _int8_fp32(llama_config("1b", dtype="float32"), tree, seed, dev)
    quant = _quant_enabled(cfg, tree, seed, dev)
    return dict(serve=dict(passes=passes, launches=counts["ragged_paged_attention"], **sizes), logits_relative=diff / scale,
                steady=runs, fp32=fp32, quant=quant)


def _int8_fp32(cfg, tree, seed, dev):
    """fp32 (TF32 off), phase 9's prompts: int8 ragged servers through K4
    and through ``attn_impl="plain"`` (streams identical, or parting where
    the plain top-2 gap is below 1e-4), and a bucketed int8 server (K5 =
    22 x plain rounds)."""
    engine = dst.init_inference(TransformerLM(cfg), dtype="fp32", paged_kv=SERVE)
    engine.load_jax_params(tree)
    qparams = quantize_params_int8(engine.module.param_tree())
    prompts = list(np.random.default_rng(seed + 2).integers(0, cfg.vocab_size, (4, 224), dtype=np.int32))
    arms = {}
    for name, kw in (("kernel", {}), ("plain", {"attn_impl": "plain"}), ("bucketed", {"ragged": False})):
        srv = PagedServer(cfg, qparams, dtype=torch.float32, prefix_cache=True, **SERVE, **kw)
        _zero_counts()
        outs = srv.serve(prompts, max_new_tokens=32)
        s = srv.serve_stats()
        counts = _counts()
        want = dict.fromkeys(counts, 0) if name == "plain" else _want_counts(cfg, srv, s)
        arms[name] = dict(outs=outs, launches=counts, decode_steps=s["decode_steps"], ragged_steps=s["ragged_steps"])
        if counts != want or s["finished"] != 4:
            raise AssertionError(f"int8 fp32 {name}: launches {counts} want {want}, finished {s['finished']}")
        del srv
    ref = arms["kernel"]["outs"]
    rec = {name: dict(identical_to_kernel=_same(a["outs"], ref), launches=a["launches"],
                      partings=_partings(cfg, qparams, a["outs"], ref, dev, f"int8 fp32 {name}"))
           for name, a in arms.items() if name != "kernel"}
    emit(phase="int8", dtype="float32", requests=4, new_tokens=32, kernel_launches=arms["kernel"]["launches"], **rec)
    del engine, qparams
    torch.cuda.empty_cache()
    return dict(k4=arms["kernel"]["launches"]["ragged_paged_attention"], identical_plain=rec["plain"]["identical_to_kernel"],
                k5=arms["bucketed"]["launches"]["paged_decode_attention"],
                identical_bucketed=rec["bucketed"]["identical_to_kernel"])


def _quant_enabled(cfg, tree, seed, dev):
    """``quant.enabled`` on a bf16 engine: every leaf of rank >= 2
    fake-quantized by groups of 64; the forward is finite and one
    ``generate`` (2 prompts of 128, 128 new: cache length 256) runs K6
    22 x 128 times."""
    engine = dst.init_inference(TransformerLM(cfg), dtype="bf16", quant={"enabled": True})
    engine.load_jax_params(tree)
    tokens = torch.from_numpy(np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (2, 256),
                                                                         dtype=np.int32)).to(dev)
    logits = engine(tokens)
    finite = bool(torch.isfinite(logits.float()).all().item())
    prompts = np.random.default_rng(seed + 11).integers(0, cfg.vocab_size, (2, 128), dtype=np.int32)
    _zero_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_generated("quant.enabled generate", out, prompts, 128, cfg.vocab_size)
    counts = _counts()
    emit(phase="int8", run="quant.enabled", forward_finite=finite, logits_shape=list(logits.shape),
         generate_wall_s=wall, launches=counts)
    if not finite or counts["decode_attention"] != cfg.num_layers * 128 or sum(counts.values()) != counts["decode_attention"]:
        raise AssertionError(f"quant.enabled: forward finite {finite}, launches {counts}, want K6 = "
                             f"{cfg.num_layers} x 128 and no other")
    del engine, logits
    torch.cuda.empty_cache()
    return dict(k6=counts["decode_attention"], forward_finite=finite)


# --- phase 9f: multi-tenant SLA serving (S7) ----------------------------------------------------
TENANTS = [{"name": "gold", "weight": 3.0, "priority": 1, "ttft_target_ms": 2000.0, "tpot_target_ms": 60.0},
           {"name": "free", "weight": 1.0, "ttft_target_ms": 5000.0, "tpot_target_ms": 80.0}]


def _tenant_summary(s):
    keys = ("submitted", "finished", "tokens", "budget_share", "goodput_share", "rejected", "ttft_sla_attainment",
            "tpot_sla_attainment", "ttft_ms", "tpot_ms")
    return {name: {k: rec.get(k) for k in keys} for name, rec in s["tenants"].items()}


def phase_traffic(cfg, tree, seed, streams, dev):
    """``traffic.enabled`` in bf16 on phase 3's traffic, two tenants (weights
    3:1, gold one priority class higher), then in fp32 on phase 9's prompts
    against the single-tenant server."""
    engine = dst.init_inference(TransformerLM(cfg), dtype="bf16", paged_kv=dict(SERVE, prefix_cache=True),
                                traffic={"enabled": True, "tenants": TENANTS})
    engine.load_jax_params(tree)
    front = engine._paged_server = engine._build_paged_server()
    if not isinstance(front, MultiTenantServer):
        raise AssertionError(f"traffic.enabled built a {type(front).__name__}")
    prompts, budgets = _requests(seed, cfg.vocab_size)
    tenants = ["gold" if i % 2 else "free" for i in range(len(prompts))]
    _zero_counts()
    t0 = time.perf_counter()
    outs = front.serve(prompts, max_new_tokens=budgets, tenant=tenants)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = front.serve_stats()
    counts, want = _counts(), _want_counts(cfg, front.server, s)
    rec = dict(requests=len(outs), generated_tokens=sum(budgets), wall_s=wall, tokens_per_s=sum(budgets) / wall,
               identical_to_phase_3=_same(outs, streams["cold"]), preempted=s["preempted"],
               tenants=_tenant_summary(s), launches=counts)
    emit(phase="traffic", dtype="bfloat16", traffic="phase 3", **rec)
    if s["finished"] != len(prompts) or counts != want or any(o is None for o in outs):
        raise AssertionError(f"traffic bf16: finished {s['finished']}, launches {counts} want {want}")
    bf16 = dict(identical_to_phase_3=rec["identical_to_phase_3"], launches=counts["ragged_paged_attention"])
    del front, engine
    torch.cuda.empty_cache()
    cfg32 = llama_config("1b", dtype="float32")
    engine = dst.init_inference(TransformerLM(cfg32), dtype="fp32", paged_kv=SERVE)
    engine.load_jax_params(tree)
    params32 = engine.module.param_tree()
    prompts = list(np.random.default_rng(seed + 2).integers(0, cfg32.vocab_size, (4, 224), dtype=np.int32))
    single = PagedServer(cfg32, params32, dtype=torch.float32, prefix_cache=True, **SERVE)
    ref = single.serve(prompts, max_new_tokens=32)
    del single
    front = MultiTenantServer(PagedServer(cfg32, params32, dtype=torch.float32, prefix_cache=True, **SERVE),
                              tenants=[TenantSpec(**t) for t in TENANTS])
    _zero_counts()
    outs = front.serve(prompts, max_new_tokens=32, tenant=["free", "gold", "free", "gold"])
    s = front.serve_stats()
    counts, want = _counts(), _want_counts(cfg32, front.server, s)
    fp32 = dict(identical=_same(outs, ref), partings=_partings(cfg32, params32, outs, ref, dev, "fp32 tenancy"),
                launches=counts)
    emit(phase="traffic", dtype="float32", requests=4, new_tokens=32, **fp32)
    if counts != want or s["finished"] != 4:
        raise AssertionError(f"traffic fp32: launches {counts} want {want}, finished {s['finished']}")
    del front, engine, params32
    torch.cuda.empty_cache()
    return dict(bf16=bf16, fp32=dict(identical=fp32["identical"], launches=counts["ragged_paged_attention"]))


# --- phase 9g: the serving fleet (S7) -------------------------------------------------------------
def _fleet_of(cfg, params, dtype, jroot, n=2, tenants=None):
    """``n`` replicas of one weight tree on the card, each a ``PagedServer``
    with its own pool and journal directory under ``jroot``."""
    handles = []
    for i in range(n):
        jdir = f"{jroot}/r{i}"
        srv = PagedServer(cfg, params, dtype=dtype, prefix_cache=True, journal=RequestJournal(jdir), **SERVE)
        if tenants:
            srv = MultiTenantServer(srv, tenants=[TenantSpec(**t) for t in tenants])
        handles.append(ReplicaHandle(name=f"r{i}", server=srv, journal_dir=jdir))
    return FleetRouter(handles)


def _fleet_counts_want(cfg, router):
    want = dict.fromkeys(_counts(), 0)
    want["ragged_paged_attention"] = cfg.num_layers * sum(h.inner.stats["ragged_steps"]
                                                          for h in router.replicas.values())
    return want


def _fleet_fp32_run(cfg, params, prompts, ref, dev, scenario):
    """One fp32 fleet run of phase 9's prompts: ``"move"`` migrates a request
    mid-stream and then drains the busier replica; ``"kill"`` kills a
    replica at ``fleet.replica_kill`` (hit 6) and re-routes its requests
    from its journal."""
    with tempfile.TemporaryDirectory(prefix="fleet_") as jroot:
        router = _fleet_of(cfg, params, torch.float32, jroot)
        _zero_counts()
        uids = [router.submit(p, max_new_tokens=32) for p in prompts]
        routed = {u: router._where[u] for u in uids}
        live_at_kill = {}

        def snapshot(point, action):  # noqa: ARG001
            live_at_kill.update({n: h.inner.queued_count() + h.inner.live_count() for n, h in router.replicas.items()})

        if scenario == "move":
            mid = None
            while mid is None:
                router.step()
                mid = next((r.uid for h in router.replicas.values() for r in h.inner._active
                            if len(r.generated) >= 2 and not r.done), None)
            if not router.migrate(mid):
                raise AssertionError("fleet fp32: the migration found nothing to move")
            for _ in range(3):
                router.step()
            busy = max(router.replicas.values(), key=lambda h: h.inner.queued_count() + h.inner.live_count())
            drained = router.drain(busy.name)
        else:
            chaos.add_kill_hook(snapshot)
            chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("fleet.replica_kill", hit=6)]))
        try:
            router.run()
        finally:
            chaos.uninstall()
            chaos.remove_kill_hook(snapshot)
        outs = [router.take_result(u) for u in uids]
        fs = router.fleet_stats()
        counts, want = _counts(), _fleet_counts_want(cfg, router)
    rec = dict(scenario=scenario, routed=routed, identical_to_single=_same(outs, ref),
               partings=_partings(cfg, params, outs, ref, dev, f"fleet fp32 {scenario}"),
               fleet={k: fs[k] for k in ("routed", "migrations", "drains", "replica_kills", "rerouted",
                                          "migrated_token_divergence", "n_active")}, launches=counts)
    if scenario == "move":
        rec["drained"] = drained
    else:
        dead = next(n for n, h in router.replicas.items() if h.state == "dead")
        rec.update(killed=dead, live_at_kill=live_at_kill.get(dead), recovered=fs["rerouted"])
    emit(phase="fleet", dtype="float32", requests=len(prompts), new_tokens=32, **rec)
    if any(o is None for o in outs) or fs["migrated_token_divergence"] != 0 or counts != want:
        raise AssertionError(f"fleet fp32 {scenario}: outputs {[o is None for o in outs]}, divergence "
                             f"{fs['migrated_token_divergence']}, launches {counts} want {want}")
    if scenario == "move" and (fs["migrations"] < 2 or fs["drains"] != 1):
        raise AssertionError(f"fleet fp32 move: migrations {fs['migrations']}, drains {fs['drains']}")
    if scenario == "kill" and (fs["replica_kills"] != 1 or rec["live_at_kill"] != rec["recovered"]
                               or not rec["recovered"]):
        raise AssertionError(f"fleet fp32 kill: kills {fs['replica_kills']}, live at the kill "
                             f"{rec['live_at_kill']}, re-routed {rec['recovered']}")
    return rec


def phase_fleet(cfg, tree, seed, dev):
    """Two replicas of llama-1B on the one card (one device; not a
    multi-card fleet), each a ``PagedServer`` with its own pool and journal,
    sharing one weight tree: fp32 migration, drain and a replica kill
    against the single server's streams; then a bf16 two-tenant trace
    replayed on the real clock with a kill mid-trace."""
    cfg32 = llama_config("1b", dtype="float32")
    engine = dst.init_inference(TransformerLM(cfg32), dtype="fp32", paged_kv=SERVE)
    engine.load_jax_params(tree)
    params = engine.module.param_tree()
    prompts = list(np.random.default_rng(seed + 2).integers(0, cfg32.vocab_size, (4, 224), dtype=np.int32))
    ref = PagedServer(cfg32, params, dtype=torch.float32, prefix_cache=True, **SERVE).serve(prompts, max_new_tokens=32)
    fp32 = {s: _fleet_fp32_run(cfg32, params, prompts, ref, dev, s) for s in ("move", "kill")}
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    engine = dst.init_inference(TransformerLM(cfg), dtype="bf16", paged_kv=SERVE)
    engine.load_jax_params(tree)
    params = engine.module.param_tree()
    loads = [TenantLoad(name=t["name"], rate=3.0, pareto_alpha=1.5, prompt_len=(32, 192), max_new_tokens=(16, 64),
                        shared_prefix_prob=0.8, n_prefixes=2, prefix_len=64) for t in TENANTS]
    trace = make_trace(loads, horizon_s=3.0, vocab_size=cfg.vocab_size, seed=seed + 13)
    single = PagedServer(cfg, params, dtype=torch.bfloat16, prefix_cache=True, **SERVE)
    ref = single.serve([r.prompt for r in trace], max_new_tokens=[r.max_new_tokens for r in trace])
    del single
    with tempfile.TemporaryDirectory(prefix="fleet_") as jroot:
        router = _fleet_of(cfg, params, torch.bfloat16, jroot, tenants=TENANTS)
        routed = {}
        submit = router.submit

        def counted_submit(*a, **kw):
            uid = submit(*a, **kw)
            if uid is not None:
                routed[router._where[uid]] = routed.get(router._where[uid], 0) + 1
            return uid

        router.submit = counted_submit
        kill = (1.5, lambda srv: srv.kill_replica(next(n for n, h in srv.replicas.items() if h.inner.has_work())))
        _zero_counts()
        rep = replay(router, trace, events=[kill])
        torch.cuda.synchronize()
        outputs = rep.pop("outputs")
        outs = [outputs.get(r.index) for r in trace]
        fs = router.fleet_stats()
        counts, want = _counts(), _fleet_counts_want(cfg, router)
    finished = sum(rec["finished"] for rec in rep["tenants"].values())
    rec = dict(requests=len(trace), finished=finished, rejected=rep["n_rejected"], events_fired=rep["events_fired"],
               routing_shares={n: c / max(len(trace), 1) for n, c in sorted(routed.items())},
               duration_s=rep["duration_s"], steps=rep["steps"], ttft_ms=rep["ttft_ms"], tpot_ms=rep["tpot_ms"],
               goodput_tokens_per_s=rep["goodput_tokens_per_s"], starved_tenants=rep["starved_tenants"],
               tenants={n: {k: t[k] for k in ("offered", "finished", "goodput_share", "budget_share", "ttft_ms",
                                                 "tpot_ms")} for n, t in rep["tenants"].items()},
               fleet={k: v for k, v in fs.items() if k != "replicas"},
               identical_to_single=_same(outs, ref), launches=counts)
    emit(phase="fleet", dtype="bfloat16", traffic="make_trace, 2 tenants, real clock, kill at 1.5 s", **rec)
    if (finished != len(trace) or rep["n_rejected"] or any(o is None for o in outs) or rep["events_fired"] != 1
            or fs["replica_kills"] != 1 or fs["migrated_token_divergence"] != 0 or counts != want):
        raise AssertionError(f"fleet bf16 replay: finished {finished} of {len(trace)}, events {rep['events_fired']}, "
                             f"kills {fs['replica_kills']}, divergence {fs['migrated_token_divergence']}, launches "
                             f"{counts} want {want}")
    del router, engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(fp32={s: dict(identical=r["identical_to_single"], launches=r["launches"]["ragged_paged_attention"])
                      for s, r in fp32.items()},
                bf16=dict(identical=rec["identical_to_single"], launches=counts["ragged_paged_attention"],
                          routing_shares=rec["routing_shares"]))


# --- launch counts -------------------------------------------------------------
def _zero_counts():
    decode_attention.launches = decode_attention.launches_decode = decode_attention.launches_paged = 0
    decode_attention.launches_ragged_split = decode_attention.launches_paged_split = 0
    decode_attention.launches_decode_split = 0
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    fa.launches_fwd_tc = fa.launches_dq_tc = fa.launches_dkv_tc = 0
    bs.launches_fwd = bs.launches_dq = bs.launches_dkv = 0
    bs.launches_fwd_tc = bs.launches_dq_tc = bs.launches_dkv_tc = 0


def _variants():
    """Launches of the tensor-core variants of K1-K3 and K7-K9 (bf16, fp16)
    among the counts above (the rest of those kernels' launches took the
    fp32 FMA variants), and the K4, K6 and K5 calls that ran their split-KV
    kernel and combine."""
    return dict(flash_fwd_tc=fa.launches_fwd_tc, flash_dq_tc=fa.launches_dq_tc, flash_dkv_tc=fa.launches_dkv_tc,
                block_sparse_fwd_tc=bs.launches_fwd_tc, block_sparse_dq_tc=bs.launches_dq_tc,
                block_sparse_dkv_tc=bs.launches_dkv_tc,
                ragged_split=decode_attention.launches_ragged_split,
                decode_split=decode_attention.launches_decode_split,
                paged_split=decode_attention.launches_paged_split)


def _counts():
    return dict(ragged_paged_attention=decode_attention.launches, decode_attention=decode_attention.launches_decode,
                paged_decode_attention=decode_attention.launches_paged, flash_fwd=fa.launches_fwd,
                flash_dq=fa.launches_dq, flash_dkv=fa.launches_dkv, block_sparse_fwd=bs.launches_fwd,
                block_sparse_dq=bs.launches_dq, block_sparse_dkv=bs.launches_dkv)


# --- phase 9h: tensor-parallel serving (S9), two gloo ranks sharing the one card ---------------
TP = 2
TP_SERVE = {"page_size": 16, "max_slots": 8, "sharded": {"tp_degree": TP}}
TP_LIMIT_S = 480  # the parent's hard limit on the ranks
TP_PG_TIMEOUT_S = 300
TP_NEW = 16  # new tokens a request in the fp32 tp runs (a tp step costs ~90 gloo collectives on the shared card)
TP_REQUESTS = 8  # phase 3's requests the bf16 tp server serves (cut from 16 to make room for 16a-16e)
TP_DEPTH = 2  # llama-1B's layers the tp phases run (its width; the depth cut to 8 for 17a-17e, to 2 for 18a-18d)


def _save_tree(tree, path):
    """The flat tree as one float32 file and its index, which every rank
    memory-maps (the tree is made once, in the parent)."""
    index, off = [], 0
    with open(path + ".bin", "wb") as f:
        for name, leaf in tree.items():
            a = np.ascontiguousarray(leaf, np.float32)
            f.write(memoryview(a).cast("B"))
            index.append((name, list(a.shape), off))
            off += a.nbytes
    with open(path + ".json", "w") as f:
        json.dump(index, f)


def _load_tree(path):
    with open(path + ".json") as f:
        index = json.load(f)
    mm = np.memmap(path + ".bin", dtype=np.float32, mode="r")
    return {name: mm[off // 4 : off // 4 + int(np.prod(shape))].reshape(shape) for name, shape, off in index}


def _tp_serve_run(cfg, server, prompts, budgets, label):
    """One serve on ``server`` (an engine or a ``PagedServer``) with the
    counts zeroed just before: every
    request finishes with its budget, and the launches are exactly K4 =
    layers x (ragged steps + 8 x window steps) on this rank (windows under tp run
    their rounds eagerly: no capture)."""
    _zero_counts()
    t0 = time.perf_counter()
    outs = server.serve(prompts, max_new_tokens=budgets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = server.serve_stats()
    counts = _counts()
    want = {k: 0 for k in counts}
    want["ragged_paged_attention"] = cfg.num_layers * (s["ragged_steps"] + s["window_horizon"] * s["window_steps"])
    bad = [i for i, (p, b, o) in enumerate(zip(prompts, budgets, outs))
           if o is None or o.shape != (p.size + b,) or not (o[: p.size] == p).all()]
    if bad or s["finished"] != len(prompts) or counts != want or s["tp_degree"] != TP or s["window_graph"]:
        raise AssertionError(f"tp {label}: malformed {bad}, finished {s['finished']}, launches {counts} "
                             f"want {want}, tp_degree {s['tp_degree']}, window_graph {s['window_graph']}")
    gen = sum(budgets)
    return outs, dict(requests=len(prompts), generated_tokens=gen, wall_s=wall, tokens_per_s=gen / wall,
                      ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"], ragged_steps=s["ragged_steps"],
                      window_steps=s["window_steps"], spec_rounds=s["spec_rounds"], launches=counts,
                      fingerprint=s["step_fingerprint"], fingerprint_steps=s["fingerprint_steps"])


def _tp_rank_work(rank, tree, prompts, budgets, small, small_ref, dense_prompts, tokens, ckpt):
    """Everything one rank runs, in order (see the module docstring, phase
    9h). Returns this rank's records, streams and logits."""
    from deepspeed_tpu_torch.inference.tp import TPServing

    out = {}
    # bf16 tp = 2 ragged serving of phase 3's traffic, through init_inference
    cfg = llama_config("1b", num_layers=TP_DEPTH)
    engine = dst.init_inference(TransformerLM(cfg), dtype="bf16", paged_kv=TP_SERVE)
    engine.set_params(tree)
    _, out["bf16"] = _tp_serve_run(cfg, engine, prompts, budgets, "bf16 serve")
    params = engine.module.param_tree()
    # bf16 with the quantized all-reduce: the serve, and one [2, 256] forward's logits against the fp all-reduce's
    qar = PagedServer(cfg, params, dtype=torch.bfloat16, tp=TPServing(degree=TP, quantized_allreduce=True), **SERVE)
    _, out["bf16_qar"] = _tp_serve_run(cfg, qar, small, [8] * len(small), "bf16 quantized all-reduce")
    del qar
    tok = torch.from_numpy(tokens).cuda()
    with torch.no_grad():
        logits = {}
        for quantized in (False, True):
            ctx = TPServing(degree=TP, quantized_allreduce=quantized)
            logits[quantized] = engine.module.apply(ctx.shard_params(cfg, params), tok, train=False, tp=ctx).float()
        out["bf16_qar"]["logit_max_abs_diff"] = (logits[True] - logits[False]).abs().max().item()
        out["bf16_qar"]["logit_scale"] = logits[False].abs().max().item()
    del engine, params, logits
    torch.cuda.empty_cache()

    # fp32 (TF32 off): ragged, windows (eager rounds), an oracle drafter and int8 weights
    cfg32 = llama_config("1b", dtype="float32", num_layers=TP_DEPTH)
    engine = dst.init_inference(TransformerLM(cfg32), dtype="fp32", paged_kv=TP_SERVE)
    engine.set_params(tree)
    params = engine.module.param_tree()
    new = [TP_NEW] * len(small)
    servers = {
        "ragged": lambda: engine,
        "windows": lambda: PagedServer(cfg32, params, dtype=torch.float32, tp=TPServing(degree=TP),
                                       multi_step={"enable": True, "horizon": HORIZON}, **SERVE),
        "oracle": lambda: PagedServer(cfg32, params, dtype=torch.float32, tp=TPServing(degree=TP),
                                      drafter=OracleDrafter(dict(enumerate(small_ref)), cfg32.vocab_size),
                                      spec_decode={"max_draft": SPEC_K}, **SERVE),
        "int8": lambda: PagedServer(cfg32, quantize_params_int8(params), dtype=torch.float32, tp=TPServing(degree=TP),
                                    **SERVE),
    }
    out["fp32"], out["fp32_streams"] = {}, {}
    for name, make in servers.items():
        server = make()
        out["fp32_streams"][name], out["fp32"][name] = _tp_serve_run(cfg32, server, small, new, f"fp32 {name}")
        del server
    out["tenancy"] = _tp_tenancy_work(cfg32, params, small, new)
    del engine, params
    torch.cuda.empty_cache()

    # the dense tensor-parallel forward and generate (fp32), then the pre-sharded checkpoint
    engine = dst.init_inference(TransformerLM(cfg32), dtype="fp32", tensor_parallel={"tp_size": TP})
    engine.set_params(tree)
    _zero_counts()
    logits = engine(tok)
    torch.cuda.synchronize()
    out["dense_forward_launches"] = _counts()
    _zero_counts()
    t0 = time.perf_counter()
    gen = engine.generate(dense_prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    out["dense_generate"] = dict(wall_s=time.perf_counter() - t0, launches=_counts(),
                                 split_launches=decode_attention.launches_decode_split)
    out["dense_logits"] = logits.cpu().numpy()
    out["dense_streams"] = gen.cpu().numpy()
    t0 = time.perf_counter()
    mpath = engine.save_mp_checkpoint(ckpt)
    out["ckpt_save_s"] = time.perf_counter() - t0
    del engine
    torch.cuda.empty_cache()
    booted = dst.init_inference(TransformerLM(cfg32), dtype="fp32", tensor_parallel={"tp_size": TP}, checkpoint=mpath)
    out["ckpt_tp_bitwise"] = bool(torch.equal(booted(tok), logits))
    del booted
    torch.cuda.empty_cache()
    if rank == 0:
        single = dst.init_inference(TransformerLM(cfg32), dtype="fp32", checkpoint=mpath)
        out["ckpt_tp1_logits"] = single(tok).cpu().numpy()
        del single
        torch.cuda.empty_cache()
    return out


TP_TRACE = [  # phase 9i's wall-clock replay: two tenants, 3 requests each over 2 s of trace
    dict(name="gold", rate=3.0, prompt_len=(96, 160), max_new_tokens=(8, 16), n_prefixes=1, prefix_len=64,
         n_requests=3),
    dict(name="free", rate=3.0, prompt_len=(96, 160), max_new_tokens=(8, 16), n_prefixes=0, n_requests=3),
]
TP_DRAIN_AT_S = 1.0


def _tp_k4_want(cfg, servers):
    """Launch counts a tp run must show: K4 = layers x the servers' ragged steps
    (no windows here), every other kernel 0."""
    want = dict.fromkeys(_counts(), 0)
    want["ragged_paged_attention"] = cfg.num_layers * sum(srv.stats["ragged_steps"] for srv in servers)
    return want


def _tp_tenancy_work(cfg, params, small, new):
    """Phase 9i on one rank (fp32, TF32 off): a ``MultiTenantServer`` over a
    tp = 2 server on a virtual clock, a two-replica ``FleetRouter`` of tp
    servers with a drain, and ``replay`` on the wall clock across two tp
    replicas with a drain at 1 s of trace time, each with its launches and
    the step fingerprints it saw."""
    from deepspeed_tpu_torch.inference.tp import TPServing
    from deepspeed_tpu_torch.utils.loadgen import VirtualClock

    def server(clock=None):
        return PagedServer(cfg, params, dtype=torch.float32, tp=TPServing(degree=TP), prefix_cache=True,
                           clock=clock, **SERVE)

    out = {}
    front = MultiTenantServer(server(VirtualClock(0.05)), tenants=[TenantSpec(**t) for t in TENANTS])
    _zero_counts()
    streams = front.serve(small, max_new_tokens=new, tenant=["free", "gold", "free", "gold"])
    s = front.serve_stats()
    out["tenancy"] = dict(streams=streams, launches=_counts(), want=_tp_k4_want(cfg, [front.server]),
                          finished=s["finished"], fingerprint=s["step_fingerprint"], steps=s["fingerprint_steps"],
                          tenants=_tenant_summary(s))
    del front

    router = FleetRouter([ReplicaHandle(name=f"r{i}", server=server()) for i in range(2)])
    _zero_counts()
    uids = [router.submit(p, max_new_tokens=n) for p, n in zip(small, new)]
    for _ in range(4):
        router.step()
    router.drain("r1")
    router.run()
    fs = router.fleet_stats()
    inners = [h.inner for h in router.replicas.values()]
    out["fleet"] = dict(streams=[router.take_result(u) for u in uids], launches=_counts(),
                        want=_tp_k4_want(cfg, inners), migrations=fs["migrations"], drains=fs["drains"],
                        divergence=fs["migrated_token_divergence"], finished=sum(i.stats["finished"] for i in inners))
    del router, inners

    router = FleetRouter([ReplicaHandle(name=f"r{i}", server=server()) for i in range(2)])
    prints = {}
    for name, h in router.replicas.items():
        log = prints[name] = []

        def logged(step=h.inner.step, inner=h.inner, log=log):
            step()
            log.append(f"{inner._fingerprint:08x}")

        h.inner.step = logged
    trace = make_trace([TenantLoad(**t) for t in TP_TRACE], horizon_s=2.0, vocab_size=cfg.vocab_size, seed=11)
    _zero_counts()
    t0 = time.perf_counter()
    rep = replay(router, trace, events=[(TP_DRAIN_AT_S, lambda f: f.drain("r1"))])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inners = [h.inner for h in router.replicas.values()]
    out["replay"] = dict(requests=len(trace), steps=rep["steps"], events_fired=rep["events_fired"], prints=prints,
                         outputs={int(k): np.asarray(v) for k, v in rep.pop("outputs").items()},
                         finished=sum(t["finished"] for t in rep["tenants"].values()), launches=_counts(),
                         want=_tp_k4_want(cfg, inners), wall_s=wall, duration_s=rep["duration_s"],
                         ttft_ms=rep["ttft_ms"], tpot_ms=rep["tpot_ms"],
                         states={n: h.state for n, h in router.replicas.items()})
    del router, inners
    torch.cuda.empty_cache()
    return out


def _tp_tenancy_checks(cfg32, params32, ranks, small_ref, dev):
    """The parent's checks of phase 9i (see the module docstring)."""
    rec = dict(ranks=TP, backend="gloo", note="two gloo ranks on one card, not a TP speed")
    for name in ("tenancy", "fleet"):
        runs = [r["tenancy"][name] for r in ranks]
        for rank, run in enumerate(runs):
            if run["launches"] != run["want"] or run["finished"] != len(small_ref):
                raise AssertionError(f"tp {name} rank {rank}: finished {run['finished']}, launches "
                                     f"{run['launches']} want {run['want']}")
            if not all(np.array_equal(a, b) for a, b in zip(run["streams"], runs[0]["streams"])):
                raise AssertionError(f"tp {name}: rank {rank}'s streams differ from rank 0's")
        if name == "fleet" and (runs[0]["divergence"] or runs[0]["drains"] != 1 or not runs[0]["migrations"]):
            raise AssertionError(f"tp fleet: {runs[0]}")
        rec[name] = dict(identical_to_tp1=_same(runs[0]["streams"], small_ref),
                         partings=_partings(cfg32, params32, runs[0]["streams"], small_ref, dev, f"tp {name}"),
                         launches_per_rank=[run["launches"]["ragged_paged_attention"] for run in runs],
                         **{k: runs[0][k] for k in runs[0] if k in ("migrations", "drains", "divergence", "steps",
                                                                     "tenants")})
    runs = [r["tenancy"]["replay"] for r in ranks]
    for rank, run in enumerate(runs):
        if run["launches"] != run["want"] or run["finished"] != run["requests"] or run["events_fired"] != 1 \
                or run["states"]["r1"] != "drained":
            raise AssertionError(f"tp replay rank {rank}: finished {run['finished']} of {run['requests']}, events "
                                 f"{run['events_fired']}, states {run['states']}, launches {run['launches']} want "
                                 f"{run['want']}")
        if (run["steps"], run["prints"]) != (runs[0]["steps"], runs[0]["prints"]) or any(
                not np.array_equal(o, runs[0]["outputs"][k]) for k, o in run["outputs"].items()):
            raise AssertionError(f"tp replay: rank {rank}'s steps, fingerprints or outputs differ from rank 0's")
    rec["replay"] = dict(requests=runs[0]["requests"], steps=runs[0]["steps"], events_fired=1,
                         fingerprints_per_replica={n: len(v) for n, v in runs[0]["prints"].items()},
                         fingerprints_equal=True, wall_s=[run["wall_s"] for run in runs],
                         duration_s=runs[0]["duration_s"], ttft_ms=runs[0]["ttft_ms"], tpot_ms=runs[0]["tpot_ms"],
                         launches_per_rank=[run["launches"]["ragged_paged_attention"] for run in runs])
    emit(phase="tp_tenancy", **rec)
    return rec


def _tp_rank(rank, store, result_path, work_args):
    """One spawned rank of phase 9h: joins the gloo group through a file
    store (with a timeout), runs ``_tp_rank_work`` and pickles its result
    or its traceback."""
    import pickle
    import traceback

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dst.init_distributed("gloo", init_method=f"file://{store}", rank=rank, world_size=TP,
                             timeout=TP_PG_TIMEOUT_S)
        work_args = dict(work_args)
        res = _tp_rank_work(rank, _load_tree(work_args.pop("tree_path")), **work_args)
        dst.comm.barrier()
        dst.comm.destroy_process_group()
        payload = ("ok", res)
    except BaseException:  # the parent raises it
        payload = ("error", traceback.format_exc())
    with open(result_path, "wb") as f:
        pickle.dump(payload, f)


def _spawn_ranks(target, world, tmp, work_args, limit_s, label):
    """``world`` spawned ranks running ``target(rank, store, result, work_args)``;
    the parent kills them at ``limit_s`` and raises on any rank's error."""
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    results = [f"{tmp}/{label}_rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, f"{tmp}/{label}_store", results[r], work_args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + limit_s
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    out, errors = [], [f"ranks {hung} still running after {limit_s} s: killed"] if hung else []
    for r, path in enumerate(results):
        try:
            with open(path, "rb") as f:
                status, value = pickle.load(f)
        except OSError:
            errors.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
            continue
        if status == "ok":
            out.append(value)
        else:
            errors.append(f"rank {r}:\n{value}")
    if errors:
        raise AssertionError(f"{label} ranks failed:\n" + "\n".join(errors))
    return out


def _tp_local_kernels(dev):
    """K4, K6 and K1 against their plain versions at llama-1B's per-rank
    shapes under tp = 2 (16 query heads over 2 kv heads, D 64; K1 over 16
    heads at the [2, 256] forward), one launch each, fp32 (TF32 off) and
    bf16."""
    rs = np.random.default_rng(5432)
    nh, nkv = NH // TP, NKV // TP
    recs = {}
    k4_args = _batch(rs, 1, [(1, 1), (17, 1), (300, 1), (511, 1), (1024, 1), (1500, 1), (0, 0), (2048, 1)], dev,
                     nh=nh, nkv=nkv)
    q6, k6, v6, lens6 = _decode_inputs(rs, 16, 256, nh, nkv, D, np.linspace(0, 256, 16).astype(np.int32), dev)
    q1, k1, v1 = (torch.from_numpy(rs.standard_normal((2, 256, nh, D), dtype=np.float32)).to(dev) for _ in range(3))
    scale = 1.0 / np.sqrt(D)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        dt = str(dtype).replace("torch.", "")
        err4, _, splits = _compare(f"tp{TP} local W=1", k4_args, scale, dtype, tol)
        before = decode_attention.launches_decode
        qd, kd, vd = q6.to(dtype), k6.to(dtype), v6.to(dtype)
        got6 = decode_attention.decode_attention_kernel(qd, kd, vd, lens6, scale)
        ref6 = decode_attention.decode_attention_plain(qd.float(), kd.float(), vd.float(), lens6, scale)
        launched6 = decode_attention.launches_decode - before
        before = fa.launches_fwd
        o, lse = fa.flash_fwd_kernel(q1.to(dtype), k1.to(dtype), v1.to(dtype), True)
        o_ref, lse_ref = fa.flash_fwd_plain(q1.to(dtype).float(), k1.to(dtype).float(), v1.to(dtype).float(), True)
        launched1 = fa.launches_fwd - before
        torch.cuda.synchronize()
        err6 = (got6.float() - ref6).abs().max().item()
        err1 = max((o.float() - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
        recs[dt] = dict(k4=dict(case=f"W=1 NH={nh} NKV={nkv} D={D}", max_abs_err=err4, splits=splits),
                        k6=dict(case=f"B=16 S=256 NH={nh} NKV={nkv} D={D}", max_abs_err=err6),
                        k1=dict(case=f"B=2 T=256 N={nh} D={D} causal", max_abs_err=err1), tol=tol)
        emit(phase="tp_kernels", dtype=dt, **recs[dt])
        if not (err6 <= tol and err1 <= tol and launched6 == 1 and launched1 == 1):
            raise AssertionError(f"tp local kernels {dt}: K6 err {err6} ({launched6} launches), K1 err {err1} "
                                 f"({launched1} launches), tol {tol}")
    return recs


def phase_tp(cfg, tree, seed, dev):
    """Phase 9h: two spawned ranks share the card over gloo (not a TP speed
    measurement); the tp = 1 references are made here first."""
    import shutil

    local = _tp_local_kernels(dev)
    prompts, budgets = _requests(seed, cfg.vocab_size)
    rs = np.random.default_rng(seed + 2)
    small = list(rs.integers(0, cfg.vocab_size, (4, 224), dtype=np.int32))
    dense_prompts = np.random.default_rng(seed + 9).integers(0, cfg.vocab_size, (16, 224), dtype=np.int32)
    tokens = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (2, 256), dtype=np.int32)
    # the single-rank fp32 references: ragged and int8 streams, the dense forward's logits and greedy generate,
    # all at the phase's depth (the first TP_DEPTH layers of the tree)
    tree = {k: (v[:TP_DEPTH] if k.startswith("layers/") else v) for k, v in tree.items()}
    cfg32 = llama_config("1b", dtype="float32", num_layers=TP_DEPTH)
    ref_engine = dst.init_inference(TransformerLM(cfg32), dtype="fp32", paged_kv=SERVE)
    ref_engine.load_jax_params(tree)
    params32 = ref_engine.module.param_tree()
    small_ref = PagedServer(cfg32, params32, dtype=torch.float32, **SERVE).serve(small, max_new_tokens=TP_NEW)
    params_int8 = quantize_params_int8(params32)
    small_int8_ref = PagedServer(cfg32, params_int8, dtype=torch.float32, **SERVE).serve(small, max_new_tokens=TP_NEW)
    with torch.no_grad():
        ref_logits = ref_engine(torch.from_numpy(tokens).to(dev)).cpu().numpy()
    ref_dense = ref_engine.generate(dense_prompts, max_new_tokens=32).cpu().numpy()
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="tp_smoke_", dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    try:
        t0 = time.perf_counter()
        _save_tree(tree, f"{tmp}/tree")
        emit(phase="tp", event="tree_written", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        ranks = _spawn_ranks(_tp_rank, TP, tmp, dict(
            tree_path=f"{tmp}/tree", prompts=prompts[:TP_REQUESTS], budgets=budgets[:TP_REQUESTS], small=small,
            small_ref=small_ref,
            dense_prompts=dense_prompts, tokens=tokens, ckpt=f"{tmp}/ckpt"), TP_LIMIT_S, "tp")
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    L = TP_DEPTH
    rec = dict(ranks=TP, backend="gloo", note="two gloo ranks on one card, not a TP speed", ranks_wall_s=ranks_s,
               layers=f"{TP_DEPTH} of llama-1B's {cfg.num_layers} (a depth cut)",
               bf16_requests=f"phase 3's first {TP_REQUESTS} of {len(prompts)} (a cut)")
    # bf16 serving of phase 3's traffic
    rec["bf16"] = [r["bf16"] for r in ranks]
    rec["bf16_qar"] = [r["bf16_qar"] for r in ranks]
    # fp32 identities against the single-rank streams (or a parting at a plain top-2 gap below 1e-4)
    rec["fp32"] = {}
    for name in ranks[0]["fp32"]:
        ref, params = (small_int8_ref, params_int8) if name == "int8" else (small_ref, params32)
        rec["fp32"][name] = [dict(r["fp32"][name], identical=_same(r["fp32_streams"][name], ref),
                                  partings=_partings(cfg32, params, r["fp32_streams"][name], ref, dev,
                                                     f"tp fp32 {name}")) for r in ranks]
    # the dense forward and generate, and the checkpoint round trip
    scale = float(np.abs(ref_logits).max())
    dense = []
    for rank, r in enumerate(ranks):
        err = float(np.abs(r["dense_logits"] - ref_logits).max())
        same = int(sum(np.array_equal(a, b) for a, b in zip(r["dense_streams"], ref_dense)))
        fwd, gen = r["dense_forward_launches"], r["dense_generate"]["launches"]
        want_fwd = {k: (L if k == "flash_fwd" else 0) for k in fwd}
        want_gen = {k: (L * 32 if k == "decode_attention" else 0) for k in gen}
        dense.append(dict(logit_max_abs_err=err, logit_scale=scale, streams_identical=same,
                          forward_launches=fwd, generate_launches=gen, generate_wall_s=r["dense_generate"]["wall_s"],
                          ckpt_save_s=r["ckpt_save_s"], ckpt_tp_bitwise=r["ckpt_tp_bitwise"]))
        if err > 1e-4 * scale or same != len(ref_dense) or fwd != want_fwd or gen != want_gen \
                or not r["ckpt_tp_bitwise"]:
            raise AssertionError(f"tp dense rank {rank}: {dense[-1]}")
    tenancy = _tp_tenancy_checks(cfg32, params32, ranks, small_ref, dev)
    ckpt_tp1 = bool(np.array_equal(ranks[0]["ckpt_tp1_logits"], ref_logits))
    rec["dense"] = dense
    rec["ckpt_tp1_bitwise"] = ckpt_tp1
    if not ckpt_tp1:
        raise AssertionError("tp checkpoint: the tp = 1 engine booted from it differs from the one loaded from the tree")
    # every rank shipped the same host arrays in the same steps, in every serve
    prints = {}
    for label, get in (("bf16", lambda r: r["bf16"]), ("bf16_qar", lambda r: r["bf16_qar"]),
                       *((f"fp32 {n}", lambda r, n=n: r["fp32"][n]) for n in ranks[0]["fp32"])):
        seen = {(get(r)["fingerprint"], get(r)["fingerprint_steps"]) for r in ranks}
        prints[label] = dict(equal=len(seen) == 1, fingerprint=get(ranks[0])["fingerprint"],
                             steps=get(ranks[0])["fingerprint_steps"])
        if len(seen) != 1:
            raise AssertionError(f"tp {label}: the ranks' step fingerprints differ: {seen}")
    rec["fingerprints"] = prints
    # the comm layer hands every collective to gloo as a CUDA tensor (gloo copies through the host inside)
    rec["staged_collectives"] = 0
    rec["local_kernels"] = local
    emit(phase="tp", **rec)
    # the kernels line: each rank's launches on the tp main paths, and the local-shape checks
    rec["kernels"] = {
        "ragged_paged_attention": dict(launches_per_rank=[r["bf16"]["launches"]["ragged_paged_attention"]
                                                          for r in ranks], path="bf16 tp = 2 serve",
                                       local={dt: v["k4"] for dt, v in local.items()},
                                       tenancy={k: tenancy[k]["launches_per_rank"]
                                                for k in ("tenancy", "fleet", "replay")}),
        "decode_attention": dict(launches_per_rank=[r["dense_generate"]["launches"]["decode_attention"]
                                                    for r in ranks], path="fp32 tp = 2 generate, 16 x 32 new",
                                 local={dt: v["k6"] for dt, v in local.items()}),
        "flash_fwd": dict(launches_per_rank=[r["dense_forward_launches"]["flash_fwd"] for r in ranks],
                          path="fp32 tp = 2 engine(tokens) [2, 256]",
                          local={dt: v["k1"] for dt, v in local.items()}),
    }
    del ref_engine, params32, params_int8
    torch.cuda.empty_cache()
    return rec


# --- phase 5: K1-K3 against their plain versions -------------------------------
FLASH_CASES = {  # name: (B, T, N, D, causal)
    "train B=8 T=1024 N=12 D=64 causal": (8, 1024, 12, 64, True),
    "ragged B=2 T=200 N=12 D=64 causal": (2, 200, 12, 64, True),
    "full B=2 T=256 N=12 D=64": (2, 256, 12, 64, False),
    "D=128 B=1 T=2048 N=32 causal": (1, 2048, 32, 128, True),
}
FLASH_MAIN = "train B=8 T=1024 N=12 D=64 causal"
FLASH_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 3e-2)}  # (O and LSE abs, grads rel)
FLASH_FP16_TOL = FLASH_TOL[torch.bfloat16]  # fp16 (the training shape only) at bf16's bounds: it rounds finer
VARIANT = {torch.float32: "fma", torch.bfloat16: "tensor_core", torch.float16: "tensor_core"}  # K1-K3, K7-K9


def _flash_bound(B, T, N, D, causal, dtype):
    """Least time of each kernel at these shapes: max(bytes / HBM rate,
    flops / peak). Pairs = the (query, key) pairs the mask leaves
    (T(T+1)/2 per head causal, T^2 full); K1 does 2 products per pair
    (QK^T, PV), K2 3 (QK^T, dO V^T, dS K), K3 4 (QK^T, dO V^T, P^T dO,
    dS^T Q), 2·D flops each. Bytes: each [B, T, N, D] operand read once
    and each output written once (K1: q, k, v, o; K2: q, k, v, dO, dQ; K3:
    q, k, v, dO, dK, dV) plus the fp32 [B·N, T] rows (K1: lse; K2 and K3:
    lse and delta)."""
    item = torch.tensor([], dtype=dtype).element_size()
    pairs = B * N * (T * (T + 1) // 2 if causal else T * T)
    tensor, row = B * T * N * D * item, B * N * T * 4
    out = {}
    for name, products, tensors, rows in (("flash_fwd", 2, 4, 1), ("flash_dq", 3, 5, 2), ("flash_dkv", 4, 6, 2)):
        nbytes, flops = tensors * tensor + rows * row, products * 2 * D * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        out[name] = dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, flops=flops)
    return out


def _flash_errors(q, k, v, do, causal):
    """Each kernel against its plain version in fp32 on the same inputs
    (the backward pair on the kernel forward's LSE and delta). Returns
    {kernel: (max abs error, error relative to the reference's largest
    magnitude)} over its outputs, and the kernel residuals."""
    f = [t.float() for t in (q, k, v, do)]
    before_tc = fa.launches_fwd_tc
    o, lse = fa.flash_fwd_kernel(q, k, v, causal)
    if fa.launches_fwd_tc - before_tc != int(VARIANT[q.dtype] == "tensor_core"):
        raise AssertionError(f"K1 on {q.dtype} did not take the {VARIANT[q.dtype]} variant")
    o_ref, lse_ref = fa.flash_fwd_plain(*f[:3], causal)
    delta = fa.flash_delta(o, do)
    before_tc = (fa.launches_dq_tc, fa.launches_dkv_tc)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal)
    tc = int(VARIANT[q.dtype] == "tensor_core")
    if (fa.launches_dq_tc - before_tc[0], fa.launches_dkv_tc - before_tc[1]) != (tc, tc):
        raise AssertionError(f"K2 or K3 on {q.dtype} did not take the {VARIANT[q.dtype]} variant")
    dq_ref = fa.flash_dq_plain(*f, lse, delta, causal)
    dk_ref, dv_ref = fa.flash_dkv_plain(*f, lse, delta, causal)
    torch.cuda.synchronize()

    def gap(pairs):
        errs = [((a.float() - b).abs().max().item(), (a.float() - b).abs().max().item() / b.abs().max().item())
                for a, b in pairs]
        for a, _ in pairs:
            if not torch.isfinite(a.float()).all():
                raise AssertionError("a flash kernel wrote a non-finite value")
        return max(e[0] for e in errs), max(e[1] for e in errs)

    return dict(flash_fwd=gap([(o, o_ref)]), flash_lse=gap([(lse, lse_ref)]), flash_dq=gap([(dq, dq_ref)]),
                flash_dkv=gap([(dk, dk_ref), (dv, dv_ref)])), (lse, delta)


def phase_flash(dev, flush):
    rs = np.random.default_rng(4321)
    main = {}
    for name, (B, T, N, D, causal) in FLASH_CASES.items():
        base = [torch.from_numpy(rs.standard_normal((B, T, N, D), dtype=np.float32)).to(dev) for _ in range(4)]
        tols = {**FLASH_TOL, **({torch.float16: FLASH_FP16_TOL} if name == FLASH_MAIN else {})}
        for dtype, (tol_o, tol_g) in tols.items():
            q, k, v, do = (t.to(dtype) for t in base)
            errs, (lse, delta) = _flash_errors(q, k, v, do, causal)
            bad = [key for key, (abs_err, rel) in errs.items()
                   if (abs_err > tol_o if key in ("flash_fwd", "flash_lse") else rel > tol_g)]
            dt = str(dtype).replace("torch.", "")
            rec = dict(phase="flash", case=name, dtype=dt, flash_fwd_variant=VARIANT[dtype],
                       flash_dq_variant=VARIANT[dtype], flash_dkv_variant=VARIANT[dtype], tol_o_lse_abs=tol_o,
                       tol_grad_rel=tol_g, errors={key: dict(max_abs_err=a, rel_err=r) for key, (a, r) in errs.items()})
            if name == FLASH_MAIN and dtype == torch.bfloat16:  # K2 twice on the same inputs: bitwise-equal dQ
                runs = [fa.flash_dq_kernel(q, k, v, do, lse, delta, causal) for _ in range(2)]
                torch.cuda.synchronize()
                equal = torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))
                emit(phase="flash_dq_determinism", case=name, dtype=dt, bitwise_equal=equal)
                if not equal:
                    raise AssertionError(f"K2 {name}: two calls on the same inputs differ")
                del runs
            if name == FLASH_MAIN:
                bounds = _flash_bound(B, T, N, D, causal, dtype)
                f = [t.float() for t in (q, k, v, do)]
                timed = {
                    "flash_fwd": (lambda: fa.flash_fwd_kernel(q, k, v, causal),
                                  lambda: fa.flash_fwd_plain(*f[:3], causal)),
                    "flash_dq": (lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, causal),
                                 lambda: fa.flash_dq_plain(*f, lse, delta, causal)),
                    "flash_dkv": (lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal),
                                  lambda: fa.flash_dkv_plain(*f, lse, delta, causal)),
                }
                # yardsticks the port never calls: SDPA forward, and its autograd backward
                # (dQ, dK and dV together) for K2 and K3
                sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
                so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
                sdo = do.transpose(1, 2).contiguous()
                lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(sq.detach(), sk.detach(), sv.detach(),
                                                                          is_causal=causal), 20, flush)
                lib_bwd = _time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), sdo, retain_graph=True), 20, flush)
                timing = {}
                for key, (kernel, plain) in timed.items():
                    ms = _time_ms(kernel, 20, flush)
                    lib = lib_fwd if key == "flash_fwd" else lib_bwd
                    timing[key] = dict(ms=ms, plain_ms=_time_ms(plain, 5, flush), library_ms=lib,
                                       library_share=lib / ms, roofline_share=bounds[key]["bound_ms"] / ms,
                                       **bounds[key])
                rec["timing"] = timing
                rec["library"] = ("flash_fwd: scaled_dot_product_attention(is_causal=True) on [B, N, T, D]; "
                                  "flash_dq and flash_dkv: the autograd backward of that call, dQ, dK and dV "
                                  "together (the same number on both)")
                main[dt] = rec
                del so, sq, sk, sv, sdo
            emit(**rec)
            if bad:
                raise AssertionError(f"flash {name} {dt}: {bad} past tolerance: {errs}")
    torch.cuda.empty_cache()
    return main


# --- phases 6 and 7: the training main path --------------------------------------
TRAIN_CONFIG = {  # bench.py:507-517, config 1
    "train_micro_batch_size_per_gpu": 8,
    "optimizer": {"type": "adam", "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 1},
    "gradient_clipping": 1.0,
    "steps_per_print": 10_000,
}
WARMUP, TIMED = 3, 20


def _train_batch(cfg, dev, micro=8):
    """bench.py:519-521: RandomState(0) tokens [micro, T+1], split into
    inputs and labels, placed on the card once."""
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (micro, cfg.max_seq_len + 1)).astype(np.int32)
    return {"input_ids": torch.from_numpy(toks[:, :-1]).to(dev), "labels": torch.from_numpy(toks[:, 1:]).to(dev)}


def phase_train(seed, dev):
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    t0 = time.perf_counter()
    tree = _weights(cfg, seed)
    engine, _, _, _ = dst.initialize(model=TransformerLM(cfg), config=dict(TRAIN_CONFIG), model_parameters=tree)
    del tree
    batch = _train_batch(cfg, dev)
    torch.cuda.synchronize()
    emit(phase="train", event="engine_built", seconds=time.perf_counter() - t0, params=engine.num_parameters())
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the training main path's
    losses = []
    for _ in range(WARMUP):
        loss = engine(batch)
        engine.backward(loss)
        engine.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        loss = engine(batch)
        engine.backward(loss)
        engine.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = _counts(), _variants()
    losses = [float(x) for x in losses]
    steps, L, H, T = WARMUP + TIMED, cfg.num_layers, cfg.hidden_size, cfg.max_seq_len
    tokens_per_s = TIMED * 8 * T / wall
    n_params = engine.num_parameters()
    flops_per_token = 6 * n_params + 12 * L * H * T  # bench.py:440-443
    rec = dict(phase="train", model='gpt2_config("125m", max_seq_len=1024, remat=False)', config=TRAIN_CONFIG,
               steps=steps, timed_steps=TIMED, losses=losses, ms_per_step=wall * 1e3 / TIMED,
               tokens_per_s=tokens_per_s, mfu=tokens_per_s * flops_per_token / PEAK_FLOPS[torch.bfloat16],
               step_floor_ms=8 * T * flops_per_token / PEAK_FLOPS[torch.bfloat16] * 1e3,
               grad_norm=engine.get_global_grad_norm(), peak_memory_bytes=torch.cuda.max_memory_allocated(),
               params=n_params, launches=counts, variants=variants)
    emit(**rec)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses not finite or not falling: {losses}")
    want = L * steps
    if any(counts[k] != want for k in ("flash_fwd", "flash_dq", "flash_dkv")) or \
            sum(counts[k] for k in ("ragged_paged_attention", "decode_attention", "paged_decode_attention")):
        raise AssertionError(f"train: launches {counts}, want {want} = {L} x {steps} for each flash kernel")
    if any(variants[f"{k}_tc"] != counts[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError(f"train: {variants['flash_fwd_tc']} of {counts['flash_fwd']} bf16 K1 launches, "
                             f"{variants['flash_dq_tc']} of {counts['flash_dq']} K2 launches and "
                             f"{variants['flash_dkv_tc']} of {counts['flash_dkv']} K3 launches took the tensor-core "
                             f"variant, want all")
    del engine, batch
    torch.cuda.empty_cache()
    return counts, variants


def phase_train_fp32(seed, dev):
    """The same model in fp32 (TF32 off), 3 steps through the kernels and
    3 through the plain attention from the same weights and batch."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False, dtype="float32")
    tree = _weights(cfg, seed)
    config = {k: v for k, v in TRAIN_CONFIG.items() if k != "bf16"}
    batch = _train_batch(cfg, dev)
    arms, masters, grad_max = {}, {}, []
    for impl in ("kernel", "plain"):
        engine, _, _, _ = dst.initialize(model=TransformerLM(cfg), config=dict(config), model_parameters=tree,
                                         attn_impl=impl)
        before = (fa.launches_fwd, fa.launches_fwd_tc, fa.launches_dq_tc, fa.launches_dkv_tc)
        rec = []
        for _ in range(3):
            loss = engine(batch)
            engine.backward(loss)
            if impl == "kernel":  # each leaf's largest gradient magnitude: phase 12d's rule for a zero gradient
                grad_max.append({k: float(g.abs().max()) for k, g in engine._grad_acc.items()})
            engine.step()
            rec.append((loss.item(), engine.get_global_grad_norm()))
        launched = fa.launches_fwd - before[0]
        tc = (fa.launches_fwd_tc - before[1], fa.launches_dq_tc - before[2], fa.launches_dkv_tc - before[3])
        if (impl == "kernel") != (launched > 0) or tc != (0, 0, 0):
            raise AssertionError(f"fp32 {impl} arm launched K1 {launched} times; K1-K3 launches on the "
                                 f"tensor-core variants {tc} (want 0)")
        arms[impl] = rec
        masters[impl] = flatten_tree(engine.get_master_params())  # phase 12d's one-rank reference and yardstick
        if impl == "kernel":
            masters["grad_max"] = grad_max
        del engine
        torch.cuda.empty_cache()
    gaps = [dict(step=i + 1, loss_rel=abs(k[0] - p[0]) / abs(p[0]), grad_norm_rel=abs(k[1] - p[1]) / abs(p[1]))
            for i, (k, p) in enumerate(zip(arms["kernel"], arms["plain"]))]
    # fp32 takes K1's FMA variant: step 1's loss and grad norm equal the plain arm's to the last bit
    identical = arms["kernel"][0] == arms["plain"][0]
    emit(phase="train_fp32", kernel=arms["kernel"], plain=arms["plain"], gaps=gaps, tol_step1=1e-5,
         step1_bit_identical=identical, flash_fwd_variant=VARIANT[torch.float32])
    if gaps[0]["loss_rel"] > 1e-5 or gaps[0]["grad_norm_rel"] > 1e-5 or not identical:
        raise AssertionError(f"fp32 training: step 1 kernel vs plain gap {gaps[0]} past 1e-5 or not bit-identical")
    return arms["kernel"], masters


# --- phase 12b: training checkpoints (T3) -------------------------------------------------
CKPT_SCHEDULER = {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-4, "warmup_num_steps": 4}}
CKPT_STEPS = 8
PCIE_BYTES_PER_S = 64e9  # PCIe Gen5 x16, one direction: the async stall's bound
CKPT_NEW = 16  # greedy tokens the serving engine booted from the checkpoint generates


def _fs_type(path):
    return subprocess.run(["stat", "-f", "-c", "%T", path], capture_output=True, text=True,
                          check=True).stdout.strip()


def _ckpt_root(need_bytes):
    """A fresh directory on a file system that holds ``need_bytes``: the
    temporary directory unless it is memory (tmpfs, ramfs), else beside this
    script. Returns (dir, filesystem type)."""
    for base in (tempfile.gettempdir(), os.path.dirname(os.path.abspath(__file__))):
        if _fs_type(base) not in ("tmpfs", "ramfs") and shutil.disk_usage(base).free > need_bytes:
            break
    else:
        base = tempfile.gettempdir()
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base)
    return d, _fs_type(d)


def _ckpt_batch(cfg, dev, step, seed):
    """Step ``step``'s batch, drawn from seed + step: a resume at the wrong
    step trains on other tokens."""
    toks = np.random.RandomState(seed + step).randint(0, cfg.vocab_size, (8, cfg.max_seq_len + 1)).astype(np.int32)
    return {"input_ids": torch.from_numpy(toks[:, :-1]).to(dev), "labels": torch.from_numpy(toks[:, 1:]).to(dev)}


def _ckpt_steps(engine, cfg, dev, seed, n, rec, times=None):
    """``n`` steps, each step's (loss, grad norm) appended to ``rec`` and,
    with ``times``, its wall time (ending in a synchronize) and whether a
    checkpoint write was in flight when it started."""
    for _ in range(n):
        batch = _ckpt_batch(cfg, dev, engine.global_steps, seed)
        in_flight = engine.checkpoint_stats()["pending"] > 0
        t0 = time.perf_counter()
        loss = engine(batch)
        engine.backward(loss)
        engine.step()
        rec.append((loss.item(), engine.get_global_grad_norm()))
        if times is not None:
            times.append((time.perf_counter() - t0, in_flight))


def _same_masters(label, master, ref):
    differ = [k for k, m in master.items() if not torch.equal(m, ref[k])]
    if differ:
        raise AssertionError(f"train_checkpoint: {label}: {len(differ)} master leaves differ from the "
                             f"uninterrupted run's, e.g. {differ[:3]}")


def _same_records(label, got, want):
    if got != want:
        first = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"train_checkpoint: {label}: (loss, grad norm) {got[first]} at record {first} is not "
                             f"bitwise the uninterrupted run's {want[first]}")


def phase_train_checkpoint(seed, dev):
    """GPT-2 125M bf16 (config 1 plus a 4-step warm-up lr): two uninterrupted
    8-step runs bitwise equal; a sync save at step 4 and an async save at
    step 6 (steps 7-8 run while it persists); fresh engines resumed from
    each take the remaining steps bitwise; a save killed at
    ``ckpt.pre_commit`` leaves ``latest`` on step 6; a serving engine
    booted from step 6 holds its module bitwise and generates through K6."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    tree = _weights(cfg, seed)
    config = dict(TRAIN_CONFIG, scheduler=CKPT_SCHEDULER)
    engine_of = lambda: dst.initialize(model=TransformerLM(cfg), config=dict(config), model_parameters=tree)[0]  # noqa: E731
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the phase's training steps'
    steps_taken = 0

    # 1. two uninterrupted runs
    runs = []
    for _ in range(2):
        engine = engine_of()
        rec, times = [], []
        _ckpt_steps(engine, cfg, dev, seed, CKPT_STEPS, rec, times)
        steps_taken += CKPT_STEPS
        runs.append((rec, times, {k: m.clone() for k, m in engine._master.items()}))
        del engine
    (ref, ref_times, ref_master), (rec2, times2, master2) = runs
    _same_records("second uninterrupted run", rec2, ref)
    _same_masters("second uninterrupted run", master2, ref_master)
    del master2, runs
    clean_ms = float(np.median([t for t, _ in times2])) * 1e3

    state_bytes = sum(m.numel() * (4 + 2 + 4 + 4) for m in ref_master.values())
    save_dir, fs = _ckpt_root(4 * state_bytes)
    try:
        # 2. engine A: a sync save at step 4, an async one at step 6, steps 7-8 while it persists
        a = engine_of()
        rec_a, times_a = [], []
        _ckpt_steps(a, cfg, dev, seed, 4, rec_a)
        t0 = time.perf_counter()
        a.save_checkpoint(save_dir)
        sync_s = time.perf_counter() - t0
        _ckpt_steps(a, cfg, dev, seed, 2, rec_a)
        a.save_checkpoint(save_dir, asynchronous=True)
        stats = a.checkpoint_stats()
        stall_ms, pending = stats["last_stall_ms"], stats["pending"]
        _ckpt_steps(a, cfg, dev, seed, 2, rec_a, times_a)
        t0 = time.perf_counter()
        a.wait_pending_checkpoint()
        drain_s = time.perf_counter() - t0
        persist_s = a.checkpoint_stats()["last_save_s"]
        steps_taken += CKPT_STEPS
        _same_records("engine A (saving)", rec_a, ref)
        pinned_bytes = a._pinned.nbytes()
        del a
        tag6 = os.path.join(save_dir, "global_step6")
        disk_bytes = sum(os.path.getsize(os.path.join(tag6, f)) for f in os.listdir(tag6))

        # 3. engine B: auto_resume lands on the async checkpoint, steps 7-8
        b = engine_of()
        t0 = time.perf_counter()
        path, _ = b.load_checkpoint(save_dir, auto_resume=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if path != tag6 or b.global_steps != 6:
            raise AssertionError(f"train_checkpoint: auto_resume landed on {path} at step {b.global_steps}, "
                                 f"want {tag6} at 6")
        rec_b = []
        _ckpt_steps(b, cfg, dev, seed, 2, rec_b)
        steps_taken += 2
        _same_records("engine B (resumed from the async save)", rec_b, ref[6:])
        _same_masters("engine B after step 8", b._master, ref_master)
        del b

        # 4. engine C: the sync checkpoint by tag, steps 5-8
        c = engine_of()
        c.load_checkpoint(save_dir, tag="global_step4")
        rec_c = []
        _ckpt_steps(c, cfg, dev, seed, 4, rec_c)
        steps_taken += 4
        _same_records("engine C (resumed from the sync save)", rec_c, ref[4:])
        _same_masters("engine C after step 8", c._master, ref_master)
        counts, variants = _counts(), _variants()

        # 5. a save of step 8 killed before its commit rename
        chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("ckpt.pre_commit")]))
        killed = False
        try:
            c.save_checkpoint(save_dir)
        except chaos.ChaosKilled:
            killed = True
        finally:
            chaos.uninstall()
        latest, newest = read_latest_marker(save_dir), find_latest_valid(save_dir)
        if not killed or latest != "global_step6" or newest != "global_step6":
            raise AssertionError(f"train_checkpoint: the killed save of step 8 (killed={killed}) left latest "
                                 f"{latest!r} and the newest valid tag {newest!r}, want global_step6")
        del c
        torch.cuda.empty_cache()

        # 6. serving booted from the async checkpoint
        saved_module = flatten_tree(TorchCheckpointEngine().load(tag6)["module"])
        t0 = time.perf_counter()
        server = dst.init_inference(TransformerLM(cfg), dtype="bf16", checkpoint=tag6)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        held = flatten_tree(server.module.param_tree())
        differ = [k for k, t in saved_module.items() if not torch.equal(held[k].cpu(), t)]
        if set(held) != set(saved_module) or differ:
            raise AssertionError(f"train_checkpoint: the serving engine's weights differ from the checkpoint's "
                                 f"module at {differ[:3]}")
        # 240 + 16 = a cache of 256, a multiple of 256: the single-token steps take K6 (JAX's rule)
        prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 240), dtype=np.int32)
        _zero_counts()
        out = server.generate(prompts, max_new_tokens=CKPT_NEW)
        torch.cuda.synchronize()
        _check_generated("train_checkpoint generate", out, prompts, CKPT_NEW, cfg.vocab_size)
        served = _counts()
        if served["decode_attention"] != L * CKPT_NEW or sum(served.values()) != served["decode_attention"] or \
                decode_attention.launches_decode_split != served["decode_attention"]:
            raise AssertionError(f"train_checkpoint generate: launches {served}, want K6 = {L} x {CKPT_NEW} "
                                 f"on the split path and no other")
        del server, saved_module, held
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)

    stall_bound_ms = state_bytes / PCIE_BYTES_PER_S * 1e3
    in_flight = [t for t, busy in times_a if busy]
    rec = dict(phase="train_checkpoint", model='gpt2_config("125m", max_seq_len=1024, remat=False)',
               config=config, steps=steps_taken, uninterrupted_bitwise=True, resume_bitwise={"async": True,
                                                                                             "sync": True},
               filesystem=fs, state_bytes=state_bytes, checkpoint_bytes_on_disk=disk_bytes, sync_save_s=sync_s,
               async_stall_ms=stall_ms, async_stall_bound_ms=stall_bound_ms, async_pending_after_save=pending,
               async_persist_s=persist_s, async_drain_wait_s=drain_s, pinned_pool_bytes=pinned_bytes,
               in_flight_step_ms=[t * 1e3 for t in in_flight], clean_step_ms=clean_ms, restore_s=restore_s,
               serve_boot_s=boot_s, latest_after_killed_save=latest, generate_launches=served,
               peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts, variants=variants)
    emit(**rec)
    want = L * steps_taken
    if any(counts[k] != want for k in ("flash_fwd", "flash_dq", "flash_dkv")) or \
            sum(v for k, v in counts.items() if not k.startswith("flash_")):
        raise AssertionError(f"train_checkpoint: launches {counts}, want {want} = {L} x {steps_taken} for each "
                             f"flash kernel and no other")
    if any(variants[f"{k}_tc"] != counts[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError(f"train_checkpoint: tensor-core launches {variants}, want all of {counts}")
    return dict(steps=steps_taken, launches=counts, k6_launches=served["decode_attention"],
                stall_ms=stall_ms, stall_bound_ms=stall_bound_ms)


# --- phases 12c-12e: data parallelism with ZeRO (T2), two gloo ranks sharing the one card ----------
ZERO_DP = 2
ZERO_STEPS = 3
ZERO_BF16_STEPS = 2  # the bf16 stages' steps (state and peak memory a rank; cut from 3 for 18a-18d)
ZERO_CONTINUE = 2  # steps after the dp = 2 save, on the ranks and at dp = 1
ZERO_LIMIT_S = 420
ZERO_TOL = 1e-5
ZERO_MASTER_SHARE = 1e-3  # of the master's elements may lie past ZERO_TOL of their leaf's scale from one rank's
ZERO_LEAF_SHARE = 0.1  # of one leaf's elements may
ZERO_NORM_TOL = 1e-4  # each step's grad norm against one rank's, relative
ZERO_GRAD_ZERO = 1e-6  # a leaf whose gradient stays below this share of the largest leaf's is zero up to rounding


def _zero_config(stage, bf16):
    """Config 1 (fp32 without its bf16 section) at micro 4 a rank: two ranks
    take phase 11's global batch of 8 rows."""
    base = dict(TRAIN_CONFIG) if bf16 else {k: v for k, v in TRAIN_CONFIG.items() if k != "bf16"}
    return dict(base, train_micro_batch_size_per_gpu=8 // ZERO_DP, zero_optimization={"stage": stage})


def _store_bytes(engine):
    """Bytes of the state this rank holds: compute parameters, fp32 master,
    Adam moments, gradient accumulators (an fp32 single copy counts once)."""
    params = sum(p.numel() * p.element_size() for k, p in engine._params.items() if p is not engine._master[k])
    master = sum(m.numel() * m.element_size() for m in engine._master.values())
    st = engine._opt_state
    moments = sum(t.numel() * t.element_size() for d in (st.exp_avg, st.exp_avg_sq) for t in d.values())
    grads = sum(g.numel() * g.element_size() for g in engine._grad_acc.values())
    return dict(params=params, master=master, moments=moments, grads=grads)


def _zero_steps(engine, batch, n, label):
    """``n`` steps with the counts zeroed just before: each step's (loss,
    grad norm) and wall (to a synchronize); K1-K3 must launch 12 a step
    each, every other kernel never."""
    _zero_counts()
    rec, walls = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = engine(batch)
        engine.backward(loss)
        engine.step()
        rec.append((loss.item(), engine.get_global_grad_norm()))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = _counts()
    L = engine.module.config.num_layers
    want = {k: (L * n if k in ("flash_fwd", "flash_dq", "flash_dkv") else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"zero {label}: launches {counts}, want {want}")
    return rec, walls, counts


def _leaf_gaps(master, ref):
    """Per leaf: the largest difference, it over the leaf's largest
    magnitude in ``ref``, and the share of elements differing by more than
    ``ZERO_TOL`` of that magnitude."""
    out = {}
    for k, r in ref.items():
        d = np.abs(master[k] - r)
        scale = max(float(np.abs(r).max()), 1e-30)
        out[k] = dict(n=int(d.size), max_abs=float(d.max()), rel=float(d.max()) / scale,
                      share_past_tol=float((d > ZERO_TOL * scale).mean()))
    return out


def _master_crc(master):
    import zlib

    crc = 0
    for k in sorted(master):
        crc = zlib.crc32(np.ascontiguousarray(master[k]).tobytes(), crc)
    return f"{crc:08x}"


def _zero_rank_work(rank, seed, ref_path, ckpt_dir):
    """Everything one rank of phases 12c-12e runs, in order. Returns this
    rank's records (masters only as their gap to the reference and CRCs)."""
    from deepspeed_tpu_torch.runtime.zero.partition import estimate_zero_memory

    dev = torch.device("cuda", 0)
    cfg32 = gpt2_config("125m", max_seq_len=1024, remat=False, dtype="float32")
    tree = _weights(cfg32, seed)
    batch = _train_batch(cfg32, dev)  # phase 11's global batch; this rank takes its 4 rows
    ref = _load_tree(ref_path)
    out = {"fp32": {}, "bf16": {}}
    for stage in (0, 1, 2, 3):
        engine = dst.initialize(model=TransformerLM(cfg32), config=_zero_config(stage, False),
                                model_parameters=tree)[0]
        rec, walls, counts = _zero_steps(engine, batch, ZERO_STEPS, f"fp32 stage {stage}")
        master = flatten_tree(engine.get_master_params())
        out["fp32"][stage] = dict(rec=rec, step_s=walls, launches=counts, crc=_master_crc(master),
                                  gaps_to_one_rank=_leaf_gaps(master, ref) if stage == 0 else None,
                                  store=_store_bytes(engine))
        if stage == 1:
            stage1_master = master  # phase 15e's reference
        if stage == 3:  # phase 12e: save at dp = 2, stage 3, then continue
            t0 = time.perf_counter()
            engine.save_checkpoint(ckpt_dir, tag="zero3_dp2")
            out["ckpt"] = dict(save_s=time.perf_counter() - t0, master_crc=_master_crc(master))
            out["ckpt"]["continue"], _, _ = _zero_steps(engine, batch, ZERO_CONTINUE, "fp32 stage 3 after the save")
        del engine, master
        torch.cuda.empty_cache()
    out["offload"] = {}  # phase 15e: streamed offload at stage 1 and the host Adam at stage 2, fp32
    for name, stage, off in (("streamed", 1, STREAMED_OFFLOAD), ("host_adam", 2, {"device": "cpu"})):
        _free()
        torch.cuda.reset_peak_memory_stats()
        engine = dst.initialize(model=TransformerLM(cfg32), model_parameters=tree, config=dict(
            _zero_config(stage, False), zero_optimization={"stage": stage, "offload_optimizer": off}))[0]
        rec, walls, counts = _zero_steps(engine, batch, ZERO_STEPS, f"offload {name}")
        master = flatten_tree(engine.get_master_params())
        out["offload"][name] = dict(rec=rec, step_s=walls, launches=counts, crc=_master_crc(master),
                                    peak_memory_bytes=torch.cuda.max_memory_allocated(),
                                    gaps_to_stage1=_leaf_gaps(master, stage1_master) if name == "host_adam" else None)
        del engine, master
    del stage1_master
    _free()
    cfg16 = gpt2_config("125m", max_seq_len=1024, remat=False)
    n = None
    for stage in (1, 2, 3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = dst.initialize(model=TransformerLM(cfg16), config=_zero_config(stage, True), model_parameters=tree)[0]
        n = engine.num_parameters()
        rec, walls, counts = _zero_steps(engine, batch, ZERO_BF16_STEPS, f"bf16 stage {stage}")
        out["bf16"][stage] = dict(rec=rec, step_s=walls, launches=counts, variants=_variants(),
                                  peak_memory_bytes=torch.cuda.max_memory_allocated(), store=_store_bytes(engine),
                                  estimate=estimate_zero_memory(n, stage, ZERO_DP, 2))
        del engine
        torch.cuda.empty_cache()
    out["params"] = n
    return out


def _zero_rank(rank, store, result_path, work_args):
    """One spawned rank of phases 12c-12e (as ``_tp_rank``)."""
    import pickle
    import traceback

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dst.init_distributed("gloo", init_method=f"file://{store}", rank=rank, world_size=ZERO_DP,
                             timeout=TP_PG_TIMEOUT_S)
        res = _zero_rank_work(rank, **work_args)
        dst.comm.barrier()
        dst.comm.destroy_process_group()
        payload = ("ok", res)
    except BaseException:  # the parent raises it
        payload = ("error", traceback.format_exc())
    with open(result_path, "wb") as f:
        pickle.dump(payload, f)


def phase_zero3_one_rank(seed, dev):
    """Phase 12c: at one rank stage 3 shards nothing; in bf16 its 3 steps
    are stage 1's bit for bit (losses, grad norms, every master leaf)."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    tree = _weights(cfg, seed)
    batch = _train_batch(cfg, dev)
    runs = {}
    for stage in (1, 3):
        engine = dst.initialize(model=TransformerLM(cfg), config=dict(TRAIN_CONFIG, zero_optimization={"stage": stage}),
                                model_parameters=tree)[0]
        rec, walls, _ = _zero_steps(engine, batch, ZERO_STEPS, f"one rank stage {stage}")
        runs[stage] = (rec, walls, {k: m.clone() for k, m in engine._master.items()})
        del engine
        torch.cuda.empty_cache()
    same_master = all(torch.equal(m, runs[1][2][k]) for k, m in runs[3][2].items())
    rec = dict(stage1=runs[1][0], stage3=runs[3][0], bit_identical=runs[1][0] == runs[3][0] and same_master,
               step_s={1: runs[1][1], 3: runs[3][1]})
    emit(phase="zero3_one_rank", dtype="bfloat16", **rec)
    if not rec["bit_identical"]:
        raise AssertionError(f"zero3 at one rank: stage 3 {runs[3][0]} differs from stage 1 {runs[1][0]}")
    return rec


def phase_zero(seed, dev, ref_rec, masters):
    """Phases 12d (ZeRO stages 0-3 at dp = 2) and 12e (a dp = 2 stage-3
    checkpoint resumed at dp = 1): two spawned gloo ranks share the card;
    the one-rank fp32 reference is phase 12's kernel arm."""
    tmp = tempfile.mkdtemp(prefix="zero_smoke_", dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    n_bytes = sum(v.nbytes for v in masters["kernel"].values())
    ckpt_dir, fs = _ckpt_root(8 * n_bytes)
    yardstick = _leaf_gaps(masters["plain"], masters["kernel"])  # one rank, plain attention against the kernels
    zero_grad = _zero_grad_leaves(masters["grad_max"])
    try:
        _save_tree(masters["kernel"], f"{tmp}/ref")
        t0 = time.perf_counter()
        ranks = _spawn_ranks(_zero_rank, ZERO_DP, tmp, dict(seed=seed, ref_path=f"{tmp}/ref", ckpt_dir=ckpt_dir),
                             ZERO_LIMIT_S, "zero")
        ranks_s = time.perf_counter() - t0
        rec = _zero_checks(ranks, ref_rec, yardstick, zero_grad, ranks_s)
        emit(phase="offload_ranks", **rec["offload"])
        rec["ckpt"] = _zero_ckpt_resume(seed, dev, ranks, ckpt_dir, fs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return rec


def _zero_grad_leaves(grad_max):
    """The leaves whose one-rank gradient is zero up to rounding at every
    step (``layers/bk``: softmax ignores a bias shared by every key), with
    each leaf's largest gradient over the largest leaf's, per step."""
    ratios = {k: [g[k] / max(max(g.values()), 1e-30) for g in grad_max] for k in grad_max[0]}
    return {k: r for k, r in ratios.items() if max(r) <= ZERO_GRAD_ZERO}, ratios


def _zero_checks(ranks, ref_rec, yardstick, zero_grad, ranks_s):
    """Phase 12d's bounds (see the module docstring) and its record."""
    rec = dict(ranks=ZERO_DP, backend="gloo", note="two gloo ranks on one card, not a DP speed", ranks_wall_s=ranks_s,
               params=ranks[0]["params"], one_rank=ref_rec, fp32={}, bf16={})
    first = ranks[0]["fp32"][0]
    for stage in (0, 1, 2, 3):
        runs = [r["fp32"][stage] for r in ranks]
        if any(run["rec"] != first["rec"] or run["crc"] != first["crc"] for run in runs):
            raise AssertionError(f"zero fp32 stage {stage}: a rank's records or master differ from stage 0's "
                                 f"on rank 0 (the stage may move state, never the math)")
        rec["fp32"][stage] = dict(step_s=[run["step_s"] for run in runs], store=runs[0]["store"],
                                  launches_per_rank=[run["launches"]["flash_fwd"] for run in runs])
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(first["rec"], ref_rec))
    norm_rel = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(first["rec"], ref_rec)]
    gaps = first["gaps_to_one_rank"]
    exempt, grad_ratios = zero_grad
    rec["fp32_vs_one_rank"] = dict(
        rec=first["rec"], loss_rel=loss_rel, grad_norm_rel=norm_rel, stages_bitwise=True,
        master_leaves_past_tol={k: g for k, g in gaps.items() if g["rel"] > ZERO_TOL},
        one_rank_kernel_vs_plain_past_tol={k: g for k, g in yardstick.items() if g["rel"] > ZERO_TOL},
        one_rank_grad_max_over_largest={k: max(r) for k, r in grad_ratios.items()}, zero_grad_leaves=sorted(exempt))
    # the master: fp32 GEMMs over 4 rows a rank against 8 round differently, and Adam's normalised step
    # turns a gradient's rounding into up to lr a step where the gradient is small; a leaf whose gradient
    # is zero up to rounding (layers/bk) takes steps of rounding noise, held only to Adam's reach; phase
    # 12's two one-rank arms show the same (the yardstick beside). The grad norm sees what Adam and
    # the clip hide: a gradient reduction off by a constant factor (a missing or extra 1/dp)
    n_all = sum(g["n"] for g in gaps.values())
    pooled = sum(g["share_past_tol"] * g["n"] for g in gaps.values()) / n_all
    lr = TRAIN_CONFIG["optimizer"]["params"]["lr"]
    reach = 2 * lr * ZERO_STEPS
    held = {k: g for k, g in gaps.items() if k not in exempt}
    leaf_share = max(g["share_past_tol"] for g in held.values())
    worst = max(g["max_abs"] for g in held.values())
    worst_exempt = max((gaps[k]["max_abs"] for k in exempt), default=0.0)
    rec["fp32_vs_one_rank"].update(master_share_past_tol=pooled, leaf_share_past_tol=leaf_share,
                                   master_max_abs=worst, master_max_abs_bound=lr / 2,
                                   zero_grad_max_abs=worst_exempt, adam_reach=reach)
    faults = []
    if loss_rel > ZERO_TOL or max(norm_rel) > ZERO_NORM_TOL:
        faults.append(f"losses {loss_rel} relative (bound {ZERO_TOL}), grad norms {norm_rel} (bound {ZERO_NORM_TOL})")
    if pooled > ZERO_MASTER_SHARE or leaf_share > ZERO_LEAF_SHARE:
        faults.append(f"master: {pooled} of all elements (bound {ZERO_MASTER_SHARE}) and up to {leaf_share} of "
                      f"a leaf's (bound {ZERO_LEAF_SHARE}) past {ZERO_TOL} of their leaf's scale")
    if worst > lr / 2 or worst_exempt > reach:
        faults.append(f"master: largest difference {worst} (bound lr / 2 = {lr / 2}), {worst_exempt} in the "
                      f"zero-gradient leaves {sorted(exempt)} (bound {reach})")
    if faults:
        raise AssertionError("zero fp32 vs one rank: " + "; ".join(faults))
    for stage in (1, 2, 3):
        runs = [r["bf16"][stage] for r in ranks]
        rec["bf16"][stage] = dict(rec=runs[0]["rec"], step_s=[run["step_s"] for run in runs],
                                  peak_memory_bytes=[run["peak_memory_bytes"] for run in runs],
                                  store=[run["store"] for run in runs], estimate=runs[0]["estimate"],
                                  launches_per_rank={k: [run["launches"][k] for run in runs]
                                                     for k in ("flash_fwd", "flash_dq", "flash_dkv")},
                                  tensor_core_per_rank=[run["variants"]["flash_fwd_tc"] for run in runs])
        if any(run["variants"][f"{k}_tc"] != run["launches"][k] for run in runs
               for k in ("flash_fwd", "flash_dq", "flash_dkv")):
            raise AssertionError(f"zero bf16 stage {stage}: a K1-K3 launch missed the tensor-core variant")
        if not all(np.isfinite(x) for run in runs for pair in run["rec"] for x in pair):
            raise AssertionError(f"zero bf16 stage {stage}: non-finite losses {runs[0]['rec']}")
    rec["offload"] = _offload_rank_checks(ranks, zero_grad)
    ratio = [s3["params"] / s1["params"] for s1, s3 in zip(rec["bf16"][1]["store"], rec["bf16"][3]["store"])]
    rec["bf16_stage3_param_store_over_stage1"] = ratio
    if any(not 0.45 <= x <= 0.6 for x in ratio):
        raise AssertionError(f"zero: stage 3 holds {ratio} of stage 1's parameter bytes a rank, want about half")
    emit(phase="zero", **rec)
    return rec


def _offload_rank_checks(ranks, zero_grad):
    """Phase 15e: at dp = 2 the streamed stage-1 arm is the on-device stage
    1 bit for bit (records and master CRC, every rank); the host-Adam
    stage-2 arm follows rule 12d against it; per-rank peaks."""
    stage1 = [r["fp32"][1] for r in ranks]
    streamed = [r["offload"]["streamed"] for r in ranks]
    host = [r["offload"]["host_adam"] for r in ranks]
    bitwise = all(s["rec"] == t["rec"] and s["crc"] == t["crc"] for s, t in zip(streamed, stage1))
    exempt, _ = zero_grad
    rules = [_rule_12d(f"offload ranks host adam, rank {i}", h["rec"], s["rec"], h["gaps_to_stage1"], exempt, ZERO_STEPS)
             for i, (h, s) in enumerate(zip(host, stage1))]
    rec = dict(note="two gloo ranks on one card, not a DP speed", streamed_bitwise_stage1=bitwise,
               host_adam_rule_12d=rules, peak_memory_bytes={n: [r["offload"][n]["peak_memory_bytes"] for r in ranks]
                                                             for n in ("streamed", "host_adam")},
               step_s={n: [r["offload"][n]["step_s"] for r in ranks] for n in ("streamed", "host_adam")},
               launches={n: [r["offload"][n]["launches"] for r in ranks] for n in ("streamed", "host_adam")})
    if not bitwise:
        raise AssertionError(f"offload ranks: streamed {[s['rec'] for s in streamed]} differs from stage 1 "
                             f"{[s['rec'] for s in stage1]}")
    return rec


def _zero_ckpt_resume(seed, dev, ranks, ckpt_dir, fs):
    """Phase 12e in the parent: two dp = 1 stage-1 fp32 engines load the
    ranks' tag and take the steps the ranks took after saving it."""
    cfg32 = gpt2_config("125m", max_seq_len=1024, remat=False, dtype="float32")
    tree = _weights(cfg32, seed)
    batch = _train_batch(cfg32, dev)
    config = {k: v for k, v in TRAIN_CONFIG.items() if k != "bf16"}
    runs = []
    for _ in range(2):
        engine = dst.initialize(model=TransformerLM(cfg32), config=dict(config), model_parameters=tree)[0]
        t0 = time.perf_counter()
        engine.load_checkpoint(ckpt_dir, tag="zero3_dp2", load_module_strict=False)
        load_s = time.perf_counter() - t0
        crc = _master_crc(flatten_tree(engine.get_master_params()))
        rec, _, _ = _zero_steps(engine, batch, ZERO_CONTINUE, "fp32 dp = 1 resumed")
        runs.append(dict(rec=rec, crc=crc, load_s=load_s, steps=engine.global_steps))
        del engine
        torch.cuda.empty_cache()
    ranks_cont = ranks[0]["ckpt"]["continue"]
    gap = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(runs[0]["rec"], ranks_cont))
    out = dict(fs=fs, save_s=ranks[0]["ckpt"]["save_s"], load_s=[r["load_s"] for r in runs],
               master_bitwise=all(r["crc"] == ranks[0]["ckpt"]["master_crc"] for r in runs),
               resumed_bitwise=runs[0]["rec"] == runs[1]["rec"], resumed=runs[0]["rec"], dp2_continue=ranks_cont,
               loss_rel_to_dp2=gap, global_steps=runs[0]["steps"])
    emit(phase="zero_ckpt", **out)
    if not (out["master_bitwise"] and out["resumed_bitwise"]) or gap > ZERO_TOL \
            or out["global_steps"] != ZERO_STEPS + ZERO_CONTINUE:
        raise AssertionError(f"zero checkpoint: {out}")
    return out


# --- phases 15a-15f: offload (T2's second half) and ZeRO-Inference ------------------------------
STREAM_BUCKET = int(2e7)
STREAMED_OFFLOAD = {"device": "cpu", "pipeline_read": True, "pipeline_write": True, "pin_memory": True,
                    "bucket_size": STREAM_BUCKET}
OFFLOAD_STEPS = 4  # the streamed arms; the host-Adam and param arms take ZERO_STEPS
YARD_BYTES = 2**30  # the pinned copy yardstick and the aio file: 1 GiB
ZI_NEW, ZI_PROMPTS, ZI_PROMPT_LEN = 8, 4, 120  # ZeRO-Inference greedy: new tokens, prompts, prompt length
ZI_NVME_LAYERS = 4  # the ZeRO-Inference nvme arm's depth; with 2 staging buffers every token reads every layer file


def _free():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _offload_config(zero, bf16):
    base = dict(TRAIN_CONFIG) if bf16 else {k: v for k, v in TRAIN_CONFIG.items() if k != "bf16"}
    return dict(base, zero_optimization=zero)


def _offload_run(cfg, tree, config, batch, n, label, after_step=None):
    """Build an engine, reset the peak (it starts from the engine's state),
    take ``n`` steps with the counts zeroed just before; each step's (loss,
    grad norm) and wall to a synchronize, and ``after_step(i, engine)``'s
    records. K1-K3 must launch equally, every other kernel never."""
    engine = dst.initialize(model=TransformerLM(cfg), config=config, model_parameters=tree)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    rec, ms, extra = [], [], []
    for i in range(n):
        t0 = time.perf_counter()
        loss = engine(batch)
        engine.backward(loss)
        engine.step()
        rec.append((loss.item(), engine.get_global_grad_norm()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if after_step is not None:
            extra.append(after_step(i, engine))
    counts = _counts()
    others = {k: v for k, v in counts.items() if k not in ("flash_fwd", "flash_dq", "flash_dkv")}
    if any(others.values()):
        raise AssertionError(f"{label}: kernels off the training path launched: {others}")
    return dict(engine=engine, rec=rec, step_ms=ms, peak=torch.cuda.max_memory_allocated(), counts=counts,
                variants=_variants(), extra=extra)


def _same_master(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _rule_12d(label, rec, ref_rec, gaps, exempt, steps):
    """Phase 12d's rule against a reference run: losses <= 1e-5 and
    grad norms <= 1e-4 relative; each leaf's share past 1e-5 of its scale
    <= 10% and its largest difference <= lr/2; a leaf whose reference
    gradient stays below 1e-6 of the largest (``exempt``) within Adam's
    reach 2·lr·steps alone."""
    lr = TRAIN_CONFIG["optimizer"]["params"]["lr"]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(rec, ref_rec))
    norm_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(rec, ref_rec))
    held = {k: g for k, g in gaps.items() if k not in exempt}
    worst_leaves = sorted(held, key=lambda k: -held[k]["share_past_tol"])[:3]
    out = dict(loss_rel=loss_rel, grad_norm_rel=norm_rel, leaf_share_past_tol=max(g["share_past_tol"] for g in held.values()),
               worst_leaves={k: held[k] for k in worst_leaves},
               master_max_abs=max(g["max_abs"] for g in held.values()), master_max_abs_bound=lr / 2,
               zero_grad_leaves=sorted(exempt), zero_grad_max_abs=max((gaps[k]["max_abs"] for k in exempt), default=0.0),
               adam_reach=2 * lr * steps)
    if loss_rel > ZERO_TOL or norm_rel > ZERO_NORM_TOL or out["leaf_share_past_tol"] > ZERO_LEAF_SHARE \
            or out["master_max_abs"] > lr / 2 or out["zero_grad_max_abs"] > 2 * lr * steps:
        raise AssertionError(f"{label} against the on-device run, rule 12d: {out}")
    return out


def _timed_copy(dst_t, src_t, reps=3):
    """The best of ``reps`` copies' card time (CUDA events), ms."""
    best = None
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dst_t.copy_(src_t, non_blocking=True)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        best = ms if best is None else min(best, ms)
    return best


def phase_host_ops(dev):
    """Phase 15a: the three host libraries built (g++, the JAX build's
    flags); the host Adam on GPT-2 125M's 124,439,808 elements against the
    plain FusedAdam arithmetic on the CPU (one fp32 step) and one timed
    pass; aio writing and reading 1 GiB with the file system and the I/O
    mode beside it; the yardstick, a pinned <-> card ``copy_`` of 1 GiB."""
    from concurrent.futures import ThreadPoolExecutor

    from deepspeed_tpu_torch.ops import aio
    from deepspeed_tpu_torch.ops.adam import cpu_adam_native
    from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:  # one g++ a source, all started together
        list(pool.map(native.load_host, list(native.HOST_SOURCES)))
    build_s = time.perf_counter() - t0
    n = 124_439_808
    rs = np.random.default_rng(0)
    p = rs.standard_normal(n, dtype=np.float32) * 0.02
    g = rs.standard_normal(n, dtype=np.float32) * 1e-3
    m, v = g * 0.1, g * g * 0.01
    lr, wd = TRAIN_CONFIG["optimizer"]["params"]["lr"], TRAIN_CONFIG["optimizer"]["params"]["weight_decay"]
    t0 = time.perf_counter()
    new_p, _ = FusedAdam(lr=lr, weight_decay=wd).apply(
        {"p": torch.from_numpy(g)}, AdamState(step=0, exp_avg={"p": torch.from_numpy(m.copy())},
                                              exp_avg_sq={"p": torch.from_numpy(v.copy())}),
        {"p": torch.from_numpy(p.copy())}, lr)
    plain_ms = (time.perf_counter() - t0) * 1e3
    host = cpu_adam_native.NativeCPUAdam(lr=lr, weight_decay=wd)
    hp, hm, hv = p.copy(), m.copy(), v.copy()
    host.step(hp, g, hm, hv, step=1)
    ref = new_p["p"].numpy()
    diff = np.abs(hp - ref)
    step_size = float(np.abs(ref - p).max())
    rel_diff = float((diff / np.maximum(np.abs(ref), 1e-8)).max())
    t0 = time.perf_counter()
    host.step(hp, g, hm, hv, step=2)
    adam_ms = (time.perf_counter() - t0) * 1e3
    adam_max_abs = float(diff.max())
    del new_p, ref, hp, hm, hv, p, g, m, v, diff

    root, fs = _ckpt_root(3 * YARD_BYTES)
    try:
        buf = torch.empty(YARD_BYTES, dtype=torch.uint8, pin_memory=True)
        buf.numpy()[:] = np.frombuffer(np.random.default_rng(1).bytes(YARD_BYTES), np.uint8)
        back = torch.empty_like(buf).pin_memory()
        h = aio.AsyncIOHandle()
        path = os.path.join(root, "aio_1gib.bin")
        t0 = time.perf_counter()
        h.sync_pwrite(buf.numpy(), path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h.sync_pread(back.numpy(), path)
        read_s = time.perf_counter() - t0
        aio_equal = torch.equal(buf, back)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    card = torch.empty(YARD_BYTES, dtype=torch.uint8, device=dev)
    h2d_ms = _timed_copy(card, buf)
    d2h_ms = _timed_copy(back, card)
    del card, buf, back
    _free()
    yard = dict(h2d_gb_s=YARD_BYTES / h2d_ms / 1e6, d2h_gb_s=YARD_BYTES / d2h_ms / 1e6, bytes=YARD_BYTES)
    rec = dict(phase="host_ops", build_s=build_s, builds={k: native.build_log.get(k) for k in native.HOST_SOURCES},
               simd_width=cpu_adam_native.simd_width(), cpu_count=os.cpu_count(), adam_elements=n,
               adam_max_abs_diff=adam_max_abs, adam_max_rel_diff=rel_diff,
               adam_max_diff_over_step=adam_max_abs / step_size, adam_step_max_abs=step_size,
               host_adam_ms=adam_ms, plain_fused_adam_cpu_ms=plain_ms,
               aio=dict(bytes=YARD_BYTES, write_gb_s=YARD_BYTES / write_s / 1e9, read_gb_s=YARD_BYTES / read_s / 1e9,
                        fs=fs, mode=aio.IO_MODE, read_after_write="warm: the file was just written",
                        equal=aio_equal),
               yardstick=yard)
    emit(**rec)
    if not aio_equal or rec["adam_max_diff_over_step"] > 1e-3:
        raise AssertionError(f"host_ops: aio equal {aio_equal}; host Adam differs from the plain arithmetic by "
                             f"{rec['adam_max_diff_over_step']} of the step (bound 1e-3)")
    return yard


def _stream_delta(prev, cur):
    return {k: cur[k] - prev.get(k, 0) for k in ("h2d_ms", "d2h_ms", "exposed_ms", "h2d_bytes", "d2h_bytes")}


def phase_offload_streamed(dev, yard, tree):
    """Phase 15b: the streamed ZeRO-Infinity path (stage 1, ``pipeline_read``
    and ``pipeline_write``, pinned host tensors, buckets of 2e7 elements)
    against the on-device stage 1 on the same batches: fp32 (TF32 off) and
    bf16, 4 steps each, losses, grad norms and master bit for bit; the bf16
    device peak lower by at least the host state's 12 B an element less the
    two largest buckets, less 5%; each step's stream accounting and wall
    beside the on-device step's; a bf16 async save after step 2 resumed by a
    fresh engine, steps 3-4 bit for bit."""
    out = {}
    root, fs = _ckpt_root(4 * 124_439_808 * 16)
    try:
        for dt in ("float32", "bfloat16"):
            bf16 = dt == "bfloat16"
            cfg = gpt2_config("125m", max_seq_len=1024, remat=False, dtype=dt)
            batch = _train_batch(cfg, dev)
            ref = _offload_run(cfg, tree, _offload_config({"stage": 1}, bf16), batch, OFFLOAD_STEPS, f"streamed {dt} ref")
            ref_master = flatten_tree(ref.pop("engine").get_master_params())
            _free()
            stats = [{}]

            def after(i, engine, bf16=bf16):
                cur = engine.offload_stream_stats()
                d = _stream_delta(stats[-1], cur)
                stats.append(cur)
                if bf16 and i == 1:
                    engine.save_checkpoint(root, tag="streamed2", asynchronous=True)
                return d

            zero = {"stage": 1, "offload_optimizer": STREAMED_OFFLOAD}
            off = _offload_run(cfg, tree, _offload_config(zero, bf16), batch, OFFLOAD_STEPS, f"streamed {dt}", after)
            engine = off.pop("engine")
            engine.wait_pending_checkpoint()
            mem = engine._host_offload.memory_report()
            n = engine.num_parameters()
            master = flatten_tree(engine.get_master_params())
            del engine
            _free()
            rec = dict(rec=off["rec"], ref_rec=ref["rec"], bitwise=off["rec"] == ref["rec"] and _same_master(master, ref_master),
                       step_ms=off["step_ms"], ref_step_ms=ref["step_ms"],
                       step_ms_median=float(np.median(off["step_ms"][1:])),
                       ref_step_ms_median=float(np.median(ref["step_ms"][1:])),
                       peak_bytes=off["peak"], ref_peak_bytes=ref["peak"], host_bytes=mem["host_bytes"],
                       bucket_bound_bytes=mem["device_residency_bound_bytes"], buckets=mem["buckets"],
                       pinned=mem["pinned"], stream_per_step=off["extra"], launches=off["counts"],
                       tensor_core=off["variants"]["flash_fwd_tc"],
                       h2d_gb_s=[d["h2d_bytes"] / d["h2d_ms"] / 1e6 if d["h2d_ms"] else None for d in off["extra"]],
                       d2h_gb_s=[d["d2h_bytes"] / d["d2h_ms"] / 1e6 if d["d2h_ms"] else None for d in off["extra"]],
                       yardstick=yard)
            want_saving = (12 * n - mem["device_residency_bound_bytes"]) * 0.95
            rec["peak_saving_bytes"] = ref["peak"] - off["peak"]
            rec["peak_saving_bound_bytes"] = want_saving if bf16 else None
            L = cfg.num_layers
            if not rec["bitwise"] or any(off["counts"][k] != L * OFFLOAD_STEPS for k in ("flash_fwd", "flash_dq", "flash_dkv")):
                raise AssertionError(f"streamed {dt}: bitwise {rec['bitwise']}, launches {off['counts']}")
            if bf16:
                if rec["peak_saving_bytes"] < want_saving:
                    raise AssertionError(f"streamed bf16: the peak {off['peak']} is {rec['peak_saving_bytes']} below the "
                                         f"on-device {ref['peak']}, want at least {want_saving}")
                resumed = dst.initialize(model=TransformerLM(cfg), config=_offload_config(zero, True),
                                         model_parameters=tree)[0]
                resumed.load_checkpoint(root, tag="streamed2")
                res = []
                for _ in range(OFFLOAD_STEPS - 2):
                    loss = resumed(batch)
                    resumed.backward(loss)
                    resumed.step()
                    res.append((loss.item(), resumed.get_global_grad_norm()))
                rec["resumed_bitwise"] = res == off["rec"][2:] and _same_master(flatten_tree(resumed.get_master_params()), master)
                rec["ckpt_fs"] = fs
                del resumed
                _free()
                if not rec["resumed_bitwise"]:
                    raise AssertionError(f"streamed bf16: resumed steps {res} differ from {off['rec'][2:]}")
            out[dt] = rec
            emit(phase="offload_streamed", dtype=dt, **rec)
            del master, ref_master
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_offload_host_adam(dev, zero_grad, tree):
    """Phase 15c: the legacy ZeRO-Offload path (stage 2, the host Adam;
    ``device=cpu`` then ``device=nvme``, pipeline off), fp32, 3 steps,
    against the on-device stage 2 by rule 12d; ``nvme`` bit for bit ``cpu``;
    each step's host Adam, swap read and write and step wall. The device
    peak: in fp32 lower by at least 90% of the moments' 8 B an element (the
    fp32 parameters are the master, so it stays on the card); in bf16 (2
    steps each, on-device and ``cpu``) by at least 90% of the host state's
    12 B an element."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False, dtype="float32")
    batch = _train_batch(cfg, dev)
    ref = _offload_run(cfg, tree, _offload_config({"stage": 2}, False), batch, ZERO_STEPS, "host adam ref")
    ref_master = flatten_tree(ref.pop("engine").get_master_params())
    _free()
    out = {}
    root, fs = _ckpt_root(4 * 124_439_808 * 8)
    try:
        for device in ("cpu", "nvme"):
            off = {"device": device} if device == "cpu" else {"device": "nvme", "nvme_path": root}
            run = _offload_run(cfg, tree, _offload_config({"stage": 2, "offload_optimizer": off}, False), batch,
                               ZERO_STEPS, f"host adam {device}", lambda i, e: e._host_offload.timing())
            engine = run.pop("engine")
            n = engine.num_parameters()
            out[device] = dict(run, master=flatten_tree(engine.get_master_params()))
            del engine
            _free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cpu, nvme = out["cpu"], out["nvme"]
    exempt, _ = zero_grad
    rule = _rule_12d("host adam cpu", cpu["rec"], ref["rec"], _leaf_gaps(cpu["master"], ref_master), exempt, ZERO_STEPS)
    nvme_bitwise = nvme["rec"] == cpu["rec"] and _same_master(nvme["master"], cpu["master"])
    cfg16 = gpt2_config("125m", max_seq_len=1024, remat=False)
    batch16 = _train_batch(cfg16, dev)
    peaks16 = {}
    for name, zero in (("on_device", {"stage": 2}), ("cpu", {"stage": 2, "offload_optimizer": {"device": "cpu"}})):
        run = _offload_run(cfg16, tree, _offload_config(zero, True), batch16, 2, f"host adam bf16 {name}")
        del run["engine"]
        _free()
        peaks16[name] = run["peak"]
    saving32, saving16 = min(ref["peak"] - cpu["peak"], ref["peak"] - nvme["peak"]), peaks16["on_device"] - peaks16["cpu"]
    rec = dict(rec=cpu["rec"], ref_rec=ref["rec"], rule_12d=rule, nvme_bitwise_cpu=nvme_bitwise,
               peak_bytes={"cpu": cpu["peak"], "nvme": nvme["peak"]}, ref_peak_bytes=ref["peak"],
               peak_saving_bytes=saving32, peak_saving_bound_bytes=0.9 * 8 * n,
               bf16_peak_bytes=peaks16, bf16_peak_saving_bytes=saving16, bf16_peak_saving_bound_bytes=0.9 * 12 * n,
               step_ms={"cpu": cpu["step_ms"], "nvme": nvme["step_ms"]},
               ref_step_ms=ref["step_ms"], host_timing={"cpu": cpu["extra"], "nvme": nvme["extra"]},
               launches={"cpu": cpu["counts"], "nvme": nvme["counts"]}, nvme_fs=fs, cpu_count=os.cpu_count())
    emit(phase="offload_host_adam", **rec)
    L = cfg.num_layers
    bad_counts = [d for d in out.values() if any(d["counts"][k] != L * ZERO_STEPS for k in ("flash_fwd", "flash_dq", "flash_dkv"))]
    if not nvme_bitwise or bad_counts or saving32 < 0.9 * 8 * n or saving16 < 0.9 * 12 * n:
        raise AssertionError(f"host adam: nvme bitwise cpu {nvme_bitwise}, launches {[d['counts'] for d in bad_counts]}, "
                             f"fp32 peaks {cpu['peak']} / {nvme['peak']} against {ref['peak']} (want {0.9 * 8 * n} "
                             f"lower), bf16 {peaks16} (want {0.9 * 12 * n} lower)")
    return rec


def phase_offload_param(dev, zero_grad, tree):
    """Phase 15d: layer-streamed training (``offload_param``, stage 3), fp32
    (TF32 off), 3 steps: ``cpu`` against the on-device stage 3 by rule 12d,
    ``nvme`` with ``cpu_checkpointing`` bit for bit ``cpu``; K1 = 24, K2 = 12,
    K3 = 12 a step; the device peak below the on-device run's with its
    reckoning; the layers' copy rate against the yardstick; then 2 bf16
    steps, every K1-K3 launch on the tensor cores."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False, dtype="float32")
    batch = _train_batch(cfg, dev)
    L = cfg.num_layers
    ref = _offload_run(cfg, tree, _offload_config({"stage": 3}, False), batch, ZERO_STEPS, "param ref")
    ref_master = flatten_tree(ref.pop("engine").get_master_params())
    _free()
    out = {}
    root, fs = _ckpt_root(4 * 124_439_808 * 4)
    try:
        for device in ("cpu", "nvme"):
            zero = {"stage": 3, "offload_param": {"device": "cpu"} if device == "cpu" else
                    {"device": "nvme", "nvme_path": root}}
            config = _offload_config(zero, False)
            if device == "nvme":
                config["activation_checkpointing"] = {"cpu_checkpointing": True}
            run = _offload_run(cfg, tree, config, batch, ZERO_STEPS, f"param {device}")
            engine = run.pop("engine")
            store = engine._param_stream.store
            run.update(master=flatten_tree(engine.get_master_params()), layer_bytes=store.layer_nbytes,
                       h2d_bytes=store.h2d_bytes, h2d_ms=store.h2d_ms(), read_bytes=store.read_bytes,
                       resident_bytes=sum(t.numel() * t.element_size() for t in engine._param_stream.resident.values()))
            out[device] = run
            del engine, store
            _free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cpu, nvme = out["cpu"], out["nvme"]
    exempt, _ = zero_grad
    rule = _rule_12d("param cpu", cpu["rec"], ref["rec"], _leaf_gaps(cpu["master"], ref_master), exempt, ZERO_STEPS)
    nvme_bitwise = nvme["rec"] == cpu["rec"] and _same_master(nvme["master"], cpu["master"])
    B, T, H, V = 8, cfg.max_seq_len, cfg.hidden_size, cfg.vocab_size
    reckoning = dict(resident=cpu["resident_bytes"], two_layers=2 * cpu["layer_bytes"], stash=L * B * T * H * 4,
                     logits=B * T * V * 4)
    want = {k: L * ZERO_STEPS * (2 if k == "flash_fwd" else 1) for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    cfg16 = gpt2_config("125m", max_seq_len=1024, remat=False)
    b16 = _offload_run(cfg16, tree, _offload_config({"stage": 3, "offload_param": {"device": "cpu"}}, True),
                       _train_batch(cfg16, dev), 2, "param bf16")
    del b16["engine"]
    _free()
    rec = dict(rec=cpu["rec"], ref_rec=ref["rec"], rule_12d=rule, nvme_cpu_checkpointing_bitwise_cpu=nvme_bitwise,
               peak_bytes={"cpu": cpu["peak"], "nvme": nvme["peak"]}, ref_peak_bytes=ref["peak"], reckoning=reckoning,
               step_ms={"cpu": cpu["step_ms"], "nvme": nvme["step_ms"]}, ref_step_ms=ref["step_ms"],
               layer_h2d_gb_s={d: r["h2d_bytes"] / r["h2d_ms"] / 1e6 for d, r in out.items()},
               nvme_read_bytes=nvme["read_bytes"], nvme_fs=fs, launches={"cpu": cpu["counts"], "nvme": nvme["counts"]},
               launches_per_step={k: cpu["counts"][k] // ZERO_STEPS for k in want},
               bf16=dict(rec=b16["rec"], launches=b16["counts"], tensor_core=b16["variants"], peak_bytes=b16["peak"]))
    emit(phase="offload_param", **rec)
    want16 = {k: L * 2 * (2 if k == "flash_fwd" else 1) for k in want}
    tc_ok = all(b16["variants"][f"{k}_tc"] == b16["counts"][k] == want16[k] for k in want16)
    if not nvme_bitwise or any(d["counts"][k] != want[k] for d in out.values() for k in want) or not tc_ok \
            or cpu["peak"] >= ref["peak"]:
        raise AssertionError(f"param offload: nvme bitwise {nvme_bitwise}, launches {[d['counts'] for d in out.values()]} "
                             f"(want {want}), bf16 {b16['counts']} / {b16['variants']}, peak {cpu['peak']} vs {ref['peak']}")
    return rec


def _first_parting(a, b):
    for i, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
        if x != y:
            return i
    return None


def phase_zero_inference(dev, yard, tree):
    """Phase 15f: ZeRO-Inference on llama-1B (22 layers, ~1.9 GB of bf16
    layer weights; ``zero={"stage": 3, "offload_param": {"device":
    "cpu"}}``) against the in-memory engine: ``engine(batch)`` logits bit for
    bit in bf16 and fp32 ([2, 256] tokens, K1 = 22); greedy ``generate`` of
    8 tokens on 4 prompts token for token in fp32 (TF32 off; bf16's equal
    streams counted); K1 = 22 x tokens generated; the device peak below half
    the in-memory weight bytes; ms a token against the yardstick's time for
    the layer bytes. Then an ``nvme`` arm at depth 4 with 2 staging
    buffers, so that every token reads every layer file: its streams equal
    the ``cpu`` arm's at that depth."""
    from deepspeed_tpu_torch.ops import aio

    rs = np.random.default_rng(5)
    tokens = torch.from_numpy(rs.integers(0, 32000, (2, 256), dtype=np.int64)).to(dev)
    prompts = torch.from_numpy(rs.integers(0, 32000, (ZI_PROMPTS, ZI_PROMPT_LEN), dtype=np.int64)).to(dev)
    zero = {"stage": 3, "offload_param": {"device": "cpu"}}
    out = {}
    for dt, dtype in (("bf16", "bfloat16"), ("fp32", "float32")):
        cfg = llama_config("1b", dtype=dtype)
        hbm = dst.init_inference(TransformerLM(cfg), dtype=dt)
        hbm.set_params(tree)
        weight_bytes = sum(p.numel() * p.element_size() for p in hbm.module.parameters())
        logits_hbm = hbm(tokens).float().cpu()
        gen_hbm = hbm.generate(prompts, max_new_tokens=ZI_NEW).cpu()
        del hbm
        _free()
        torch.cuda.reset_peak_memory_stats()
        z = dst.init_inference(TransformerLM(cfg), dtype=dt, zero=zero)
        z.set_params(tree)
        _zero_counts()
        logits = z(tokens).float().cpu()
        fwd_counts = _counts()
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = z.generate(prompts, max_new_tokens=ZI_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_counts = _counts()
        gen = gen.cpu()
        store = z._param_stream.store
        layer_bytes = store.layer_nbytes * cfg.num_layers
        equal = [bool(torch.equal(a, b)) for a, b in zip(gen, gen_hbm)]
        partings = []
        for r, same in enumerate(equal):
            if not same:  # the zero engine's top-2 gap where the streams part
                i = _first_parting(gen[r], gen_hbm[r])
                ctx = gen[r:r + 1, :i].to(dev)
                top2 = torch.topk(z(ctx)[0, -1].float(), 2).values
                partings.append(dict(row=r, at=i, top2_gap=float(top2[0] - top2[1])))
        rec = dict(logits_bitwise=bool(torch.equal(logits, logits_hbm)),
                   logits_max_abs=float((logits - logits_hbm).abs().max()), streams_equal=sum(equal),
                   streams=ZI_PROMPTS, partings=partings, forward_launches=fwd_counts, generate_launches=gen_counts,
                   ms_per_token=gen_s * 1e3 / ZI_NEW, layer_bytes=layer_bytes,
                   yardstick_ms_for_layer_bytes=layer_bytes / (yard["h2d_gb_s"] * 1e9) * 1e3,
                   layer_h2d_gb_s=store.h2d_bytes / store.h2d_ms() / 1e6, peak_bytes=torch.cuda.max_memory_allocated(),
                   in_memory_weight_bytes=weight_bytes)
        del z, store
        _free()
        out[dt] = rec
        emit(phase="zero_inference", dtype=dt, **rec)
        L = cfg.num_layers
        others = {k: v for k, v in list(fwd_counts.items()) + list(gen_counts.items()) if k != "flash_fwd" and v}
        faults = []
        if not rec["logits_bitwise"]:
            faults.append(f"logits differ from the in-memory forward by {rec['logits_max_abs']}")
        if fwd_counts["flash_fwd"] != L or gen_counts["flash_fwd"] != L * ZI_NEW or others:
            faults.append(f"launches {fwd_counts} / {gen_counts}, want K1 = {L} and {L * ZI_NEW}")
        if rec["peak_bytes"] >= weight_bytes / 2:
            faults.append(f"peak {rec['peak_bytes']} not below half the weight bytes {weight_bytes}")
        if dt == "fp32" and any(p["top2_gap"] >= 1e-4 for p in partings):
            faults.append(f"fp32 streams part away from a near-tie: {partings}")
        if faults:
            raise AssertionError(f"zero inference {dt}: " + "; ".join(faults))
    small = llama_config("1b", num_layers=ZI_NVME_LAYERS)
    small_tree = {k: (v[:ZI_NVME_LAYERS] if k.startswith("layers/") else v) for k, v in tree.items()}
    root, fs = _ckpt_root(4 * 2**30)
    try:
        arms = {}
        for device in ("cpu", "nvme"):
            off = {"device": "cpu"} if device == "cpu" else {"device": "nvme", "nvme_path": root, "buffer_count": 2}
            z = dst.init_inference(TransformerLM(small), dtype="bf16", zero={"stage": 3, "offload_param": off})
            z.set_params(small_tree)
            store = z._param_stream.store
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = z.generate(prompts, max_new_tokens=ZI_NEW).cpu()
            arms[device] = (gen, time.perf_counter() - t0, store.read_bytes, store.layer_nbytes)
            del store, z
            _free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["nvme"] = dict(layers=ZI_NVME_LAYERS, staging_buffers=2,
                       streams_equal_cpu=bool(torch.equal(arms["nvme"][0], arms["cpu"][0])),
                       ms_per_token={d: a[1] * 1e3 / ZI_NEW for d, a in arms.items()}, read_bytes=arms["nvme"][2],
                       reads_every_token=arms["nvme"][2] >= ZI_NEW * ZI_NVME_LAYERS * arms["nvme"][3],
                       fs=fs, mode=aio.IO_MODE)
    emit(phase="zero_inference_nvme", **out["nvme"])
    if not (out["nvme"]["streams_equal_cpu"] and out["nvme"]["reads_every_token"]):
        raise AssertionError(f"zero inference nvme: {out['nvme']}")
    return out


# --- phases 13 and 14: block-sparse attention (K7-K9) --------------------------------
SPARSE_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 3e-2)}  # (O and LSE abs, grads rel)
SPARSE_MAIN = "main B=2 NH=16 T=4096 D=64 Fixed blk=16"
SPARSE_BENCH = "bench B=1 NH=8 T=8192 D=64 BSLongformer blk=64 causal"
SPARSE_B, SPARSE_T = 2, 4096  # the main path's batch and sequence
SPARSE_WARMUP, SPARSE_TIMED = 3, 10
# K8's dQ bound on keys where rounding dS shows (_sparse_dq_ds_fp32), relative to its largest magnitude:
# above the output rounding with dS as hi + lo (at most 3.3e-3 in bf16, 9.6e-4 in fp16, emulated in plain
# torch) and below the error of dS rounded to the operand dtype (at least 8.5e-2 and 1.1e-2)
DS_FP32_TOL = {torch.bfloat16: 1.5e-2, torch.float16: 3e-3}


def _dead_rows_layout():
    """tests/unit/ops/test_pallas_block_sparse.py:136-171: q block 0 lists
    only the future kv block 3, so under the causal mask its rows are dead."""
    layout = np.zeros((1, 4, 4), bool)
    layout[0, 0, 3] = layout[0, 1, 1] = layout[0, 2, 2] = layout[0, 2, 0] = layout[0, 3, 3] = True
    return layout


def _dead_keys_layout():
    """Key block 3 is listed only by q block 0, which precedes it: under the
    causal mask its keys have no live pair, so its dK and dV rows are exact
    zeros (and q block 0's rows are dead)."""
    layout = np.zeros((1, 4, 4), bool)
    layout[0, 0, 3] = layout[0, 1, 1] = layout[0, 2, 0] = layout[0, 2, 2] = layout[0, 3, 1] = layout[0, 3, 2] = True
    return layout


def _dead_keys(layout_h, block, causal):
    """[T] bool: keys with no live (query, key) pair in this layout. A listed
    pair of blocks (q block >= k block under the causal mask) makes every key
    of its k block live (on the diagonal, each key meets its own row)."""
    qi, ki = np.nonzero(layout_h)
    live = ki[qi >= ki] if causal else ki
    dead = np.ones(layout_h.shape[1], bool)
    dead[live] = False
    return np.repeat(dead, block)


def _sparse_cases():
    """name: (B, NH, T, D, layout [NH or 1, nb, nb], block, causal, timed)."""
    cfg = bert_config("large")  # 16 heads of 64
    nh, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    return {
        SPARSE_MAIN: (SPARSE_B, nh, SPARSE_T, d, FixedSparsityConfig(num_heads=nh, block=16).make_layout(SPARSE_T)[:1],
                      16, False, True),
        # tests/perf/block_sparse_bench.py:31-39: its default bidirectional layout, causal=True to the kernel
        SPARSE_BENCH: (1, 8, 8192, 64, BSLongformerSparsityConfig(num_heads=8, block=64).make_layout(8192)[:1],
                       64, True, True),
        "per-head BigBird B=1 NH=4 T=2048 D=128 blk=32": (
            1, 4, 2048, 128, BigBirdSparsityConfig(num_heads=4, block=32, different_layout_per_head=True,
                                                   num_random_blocks=1).make_layout(2048), 32, False, False),
        "causal Fixed B=1 NH=8 T=2048 D=64 blk=16": (
            1, 8, 2048, 64, FixedSparsityConfig(num_heads=8, block=16, attention="unidirectional").make_layout(2048)[:1],
            16, True, False),
        "dead rows B=2 NH=2 T=64 D=64 blk=16": (2, 2, 64, 64, _dead_rows_layout(), 16, True, False),
        "block 8 B=1 NH=4 T=512 D=64 BigBird": (
            1, 4, 512, 64, BigBirdSparsityConfig(num_heads=4, block=8).make_layout(512)[:1], 8, True, False),
        "block 128 B=1 NH=4 T=2048 D=128 Fixed": (
            1, 4, 2048, 128, FixedSparsityConfig(num_heads=4, block=128).make_layout(2048)[:1], 128, False, False),
        "dead keys B=2 NH=2 T=64 D=64 blk=16": (2, 2, 64, 64, _dead_keys_layout(), 16, True, False),
    }


def _live_pairs(layout, block, causal, batch):
    """(query, key) pairs the layout leaves, summed over heads and batch:
    block^2 per live block pair, block(block+1)/2 on a causal diagonal and
    none above it."""
    total = 0
    for layout_h in np.asarray(layout, bool):
        qi, ki = np.nonzero(layout_h)
        per = np.full(qi.shape, block * block, np.int64)
        if causal:
            per = np.where(qi > ki, per, np.where(qi == ki, block * (block + 1) // 2, 0))
        total += int(per.sum())
    return total * batch


def _sparse_bound(B, NH, T, D, layout, block, causal, dtype):
    """Least time of K7-K9 at these inputs: max(bytes / HBM rate, flops /
    peak). Pairs = the (query, key) pairs of this layout (causal: on or
    below the diagonal); K7 does 2 products of 2·D flops per pair (QK^T,
    PV), K8 3 (QK^T, dO V^T, dS K), K9 4 (QK^T, dO V^T, P^T dO, dS^T Q).
    Bytes: each [B·NH, T, D] operand read once and each output written once
    (K7: q, k, v, o; K8: q, k, v, dO, dQ; K9: q, k, v, dO, dK, dV), the
    fp32 [B·NH, T] rows (K7: lse; K8, K9: lse and delta) and the int32
    tables each call reads (K7, K8: the row lists; K9: the column lists)."""
    item = torch.tensor([], dtype=dtype).element_size()
    heads = NH if layout.shape[0] == 1 else 1
    pairs = _live_pairs(layout, block, causal, B * heads)
    tensor, row = B * NH * T * D * item, B * NH * T * 4
    table_bytes = {"rows": 0, "cols": 0}
    for layout_h in layout:
        ri, rc, ci, cc = build_block_tables(layout_h)
        table_bytes["rows"] += 4 * (ri.size + rc.size)
        table_bytes["cols"] += 4 * (ci.size + cc.size)
    out = {}
    for name, products, tensors, rows, tables in (("block_sparse_fwd", 2, 4, 1, "rows"),
                                                  ("block_sparse_dq", 3, 5, 2, "rows"),
                                                  ("block_sparse_dkv", 4, 6, 2, "cols")):
        nbytes, flops = tensors * tensor + rows * row + table_bytes[tables], products * 2 * D * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        out[name] = dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, flops=flops, live_pairs=pairs)
    return out


def _sparse_errors(groups, block, causal):
    """Each kernel against its plain version in fp32 on the same inputs (the
    backward pair on the kernel forward's LSE and delta), over the head
    groups (one for a shared layout, one per head otherwise). Returns
    {kernel: (max abs error, error relative to the reference's largest
    magnitude)}, whether the dead rows (rows with no live score) are exact
    zeros in O and dQ and the dead keys (keys with no live pair) exact zeros
    in dK and dV, and the kernel outputs of the first group. K7-K9 must take
    the variant of their dtype (tensor cores for bf16 and fp16, FMA for
    fp32)."""
    errs = {}
    dead_zero = True
    first = None
    for q, k, v, do, tables, f_units, units, layout_h in groups:
        row_idx, row_cnt, col_idx, col_cnt = tables
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
        args = (scale, block, causal)
        f = [t.float() for t in (q, k, v, do)]
        before_tc = (bs.launches_fwd_tc, bs.launches_dq_tc, bs.launches_dkv_tc)
        o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args)
        delta = bs.sparse_delta(o, do)
        dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, f_units, *args)
        dk, dv = bs.sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, units, *args)
        tc = int(VARIANT[q.dtype] == "tensor_core")
        moved = (bs.launches_fwd_tc - before_tc[0], bs.launches_dq_tc - before_tc[1], bs.launches_dkv_tc - before_tc[2])
        if moved != (tc, tc, tc):
            raise AssertionError(f"K7, K8 or K9 on {q.dtype} did not take the {VARIANT[q.dtype]} variant: {moved}")
        o_ref, lse_ref = bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)
        dq_ref = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)
        dk_ref, dv_ref = bs.sparse_dkv_plain(*f, lse, delta, col_idx, col_cnt, *args)
        torch.cuda.synchronize()
        for a in (o, dq, dk, dv):
            if not torch.isfinite(a.float()).all():
                raise AssertionError("a block-sparse kernel wrote a non-finite value")
        dead = lse_ref <= bs.NEG_INF / 2  # [BN, T]: rows with no live score
        dead_keys = torch.from_numpy(_dead_keys(layout_h, block, causal)).to(q.device)
        dead_zero &= bool((o[dead] == 0).all().item() and (dq[dead] == 0).all().item()
                          and (lse[dead] == lse_ref[dead]).all().item()
                          and (dk[:, dead_keys] == 0).all().item() and (dv[:, dead_keys] == 0).all().item())
        for key, pairs in (("block_sparse_fwd", [(o, o_ref)]), ("block_sparse_lse", [(lse, lse_ref)]),
                           ("block_sparse_dq", [(dq, dq_ref)]), ("block_sparse_dkv", [(dk, dk_ref), (dv, dv_ref)])):
            for a, b in pairs:
                if key == "block_sparse_lse":  # NEG_INF on dead rows, checked above
                    a, b = a[~dead], b[~dead]
                gap = (a.float() - b).abs().max().item()
                rel = gap / max(b.abs().max().item(), 1e-30)
                prev = errs.get(key, (0.0, 0.0))
                errs[key] = (max(prev[0], gap), max(prev[1], rel))
        if first is None:
            first = (o, lse, delta)
        del f, o_ref, lse_ref, dq_ref, dk_ref, dv_ref
    return errs, dead_zero, first


def _sparse_groups(q4, k4, v4, do4, layout, block, dev):
    """[B, NH, T, D] inputs as the fused path runs them: heads folded into
    the batch for a shared layout, one [B, T, D] group per head otherwise;
    each with its tables, K7's and K9's units and its layout."""
    B, NH, T, D = q4.shape

    def tables(layout_h):
        return (bs.block_tables(layout_h, dev), bs.fwd_units(layout_h, block, dev),
                bs.dkv_units(layout_h, block, dev), layout_h)

    if layout.shape[0] == 1:
        return [tuple(x.reshape(B * NH, T, D) for x in (q4, k4, v4, do4)) + tables(layout[0])]
    return [tuple(x[:, h].contiguous() for x in (q4, k4, v4, do4)) + tables(layout[h]) for h in range(NH)]


def _sparse_timing(groups, q4, k4, v4, do4, layout, block, causal, dtype, flush, first):
    """ms of each kernel, its plain version, its bound, the library
    yardstick (SDPA with the layout as an element mask; its autograd
    backward for K8 and K9 together) and the port's dense flash kernels K1-K3
    at the same shape."""
    B, NH, T, D = q4.shape
    q, k, v, do, (row_idx, row_cnt, col_idx, col_cnt), f_units, units, _ = groups[0]
    scale = 1.0 / float(np.sqrt(D))
    args = (scale, block, causal)
    _, lse, delta = first
    f = [t.float() for t in (q, k, v, do)]
    timed = {
        "block_sparse_fwd": (lambda: bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args),
                             lambda: bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)),
        "block_sparse_dq": (lambda: bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, f_units, *args),
                            lambda: bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)),
        "block_sparse_dkv": (lambda: bs.sparse_dkv_kernel(q, k, v, do, lse, delta, col_idx, col_cnt, units, *args),
                             lambda: bs.sparse_dkv_plain(*f, lse, delta, col_idx, col_cnt, *args)),
    }
    bounds = _sparse_bound(B, NH, T, D, layout, block, causal, dtype)
    # yardsticks the port never calls: SDPA over the layout expanded to an element mask, and its autograd
    # backward (dQ, dK and dV together) for K8 and K9
    elem = _element_mask(layout, block, causal, T, q.device)
    sq, sk, sv = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    so = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=elem, scale=scale)
    lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=elem, scale=scale), 10, flush)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), do4, retain_graph=True), 10, flush)
    del so, sq, sk, sv, elem
    timing = {}
    for key, (kernel, plain) in timed.items():
        ms = _time_ms(kernel, 20, flush)
        lib = lib_fwd if key == "block_sparse_fwd" else lib_bwd
        timing[key] = dict(ms=ms, plain_ms=_time_ms(plain, 3, flush), library_ms=lib, library_share=lib / ms,
                           roofline_share=bounds[key]["bound_ms"] / ms, **bounds[key])
    if q.dtype != torch.float32:  # K7's, K8's and K9's fp32 workspaces for the split blocks at these shapes
        bn = B * NH // len(groups)
        timing["block_sparse_fwd"].update(units=int(f_units.units.shape[0]), split_q_blocks=int(f_units.reduce.shape[0]),
                                          chunk_cap=f_units.cap, workspace_bytes=bn * f_units.n_slots * block * (D + 2) * 4)
        timing["block_sparse_dq"].update(units=int(f_units.units.shape[0]), split_q_blocks=int(f_units.reduce.shape[0]),
                                         chunk_cap=f_units.cap, workspace_bytes=bn * f_units.n_slots * block * D * 4)
        timing["block_sparse_dkv"].update(units=int(units.units.shape[0]), split_key_blocks=int(units.reduce.shape[0]),
                                          chunk_cap=units.cap, workspace_bytes=bn * units.n_slots * 2 * block * D * 4)
    del f
    torch.cuda.empty_cache()
    # the port's dense flash kernels on the same inputs ([B, T, N, D]): block_sparse_bench's comparison
    fq, fk, fv, fdo = (x.transpose(1, 2).contiguous() for x in (q4, k4, v4, do4))
    fo, flse = fa.flash_fwd_kernel(fq, fk, fv, causal, scale)
    fdelta = fa.flash_delta(fo, fdo)
    dense = {
        "flash_fwd": _time_ms(lambda: fa.flash_fwd_kernel(fq, fk, fv, causal, scale), 10, flush),
        "flash_dq": _time_ms(lambda: fa.flash_dq_kernel(fq, fk, fv, fdo, flse, fdelta, causal, scale), 10, flush),
        "flash_dkv": _time_ms(lambda: fa.flash_dkv_kernel(fq, fk, fv, fdo, flse, fdelta, causal, scale), 10, flush),
    }
    return timing, dense


def _sparse_fp16(name, base, layout, block, causal, timed, dev, flush):
    """K7 and K8 in fp16 against their plain versions in fp32 on the same
    (cast) inputs, K8 on the kernel forward's LSE and delta: O and LSE within
    bf16's bound, dQ within 3e-2 of its largest magnitude, dead rows exact
    zeros in O and dQ, every call on the tensor-core variant; at the timed
    shapes their times, bounds and library yardsticks."""
    q4, k4, v4, do4 = (t.to(torch.float16) for t in base)
    groups = _sparse_groups(q4, k4, v4, do4, layout, block, dev)
    tol, tol_g = SPARSE_TOL[torch.bfloat16]
    err, dq_rel, dead_zero = 0.0, 0.0, True
    for q, k, v, do, (row_idx, row_cnt, _, _), f_units, _, _ in groups:
        args = (1.0 / float(np.sqrt(q.shape[-1])), block, causal)
        before = (bs.launches_fwd_tc, bs.launches_dq_tc)
        o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args)
        delta = bs.sparse_delta(o, do)
        dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, f_units, *args)
        f = [t.float() for t in (q, k, v, do)]
        o_ref, lse_ref = bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)
        dq_ref = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)
        torch.cuda.synchronize()
        if (bs.launches_fwd_tc - before[0], bs.launches_dq_tc - before[1]) != (1, 1) or \
                not (torch.isfinite(o.float()).all() and torch.isfinite(dq.float()).all()):
            raise AssertionError(f"K7 or K8 {name} float16: not on the tensor-core variant, or a non-finite value")
        dead = lse_ref <= bs.NEG_INF / 2
        dead_zero &= bool((o[dead] == 0).all().item() and (dq[dead] == 0).all().item()
                          and (lse[dead] == lse_ref[dead]).all().item())
        err = max(err, (o.float() - o_ref).abs().max().item(), (lse - lse_ref)[~dead].abs().max().item())
        dq_rel = max(dq_rel, (dq.float() - dq_ref).abs().max().item() / max(dq_ref.abs().max().item(), 1e-30))
        del f, o_ref, lse_ref, dq_ref
    rec = dict(phase="sparse_fp16", case=name, dtype="float16", block_sparse_fwd_variant="tensor_core",
               block_sparse_dq_variant="tensor_core", max_abs_err=err, tol=tol, dq_rel_err=dq_rel, tol_grad_rel=tol_g,
               dead_rows_exact_zero=dead_zero)
    if timed:
        B, NH, T, D = q4.shape
        q, k, v, do, (row_idx, row_cnt, _, _), f_units, _, _ = groups[0]
        args = (1.0 / float(np.sqrt(D)), block, causal)
        o, lse = bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args)
        delta = bs.sparse_delta(o, do)
        bounds = _sparse_bound(B, NH, T, D, layout, block, causal, torch.float16)
        elem = _element_mask(layout, block, causal, T, dev)
        sq, sk, sv = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
        so = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=elem, scale=args[0])
        rec["timing"] = {
            "block_sparse_fwd": dict(
                ms=_time_ms(lambda: bs.sparse_fwd_kernel(q, k, v, row_idx, row_cnt, f_units, *args), 20, flush),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=elem, scale=args[0]),
                                    10, flush),
                **bounds["block_sparse_fwd"]),
            "block_sparse_dq": dict(
                ms=_time_ms(lambda: bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, f_units, *args),
                            20, flush),
                library_ms=_time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), do4, retain_graph=True), 10, flush),
                **bounds["block_sparse_dq"]),
        }
        del so, sq, sk, sv, elem
    emit(**rec)
    if err > tol or dq_rel > tol_g or not dead_zero:
        raise AssertionError(f"K7 or K8 {name} float16: max abs error {err} (tol {tol}), dQ relative error {dq_rel} "
                             f"(tol {tol_g}), dead rows exact zero {dead_zero}")
    return rec


def _element_mask(layout, block, causal, T, dev):
    """The shared layout as a [T, T] boolean element mask (and the causal
    mask where set): the SDPA yardstick's mask."""
    elem = torch.from_numpy(np.kron(layout[0], np.ones((block, block), bool))).to(dev)
    if causal:
        elem &= torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    return elem


def _sparse_dq_ds_fp32(dev):
    """K8 keeps dS in fp32 (hi + lo in the operand dtype), as Pallas does, and
    does not round it to k's dtype as K2 does. On keys within 0.03 of one
    shared vector a head, Σ_k dS_k·c cancels, so dQ is small beside its terms
    and rounding dS would move it some 30 times the output rounding: dQ must
    lie within DS_FP32_TOL of the plain version with fp32 dS, and the plain
    version with dS rounded must not (else the check could not tell)."""
    recs = []
    for dtype, block in ((torch.bfloat16, 16), (torch.bfloat16, 64), (torch.float16, 16)):
        n = 16 if block == 16 else 8
        layout_h = np.ones((n, n), np.int64)
        row_idx, row_cnt, _, _ = bs.block_tables(layout_h, dev)
        rs = np.random.RandomState(block)
        q, v, do = (torch.from_numpy(rs.randn(3, n * block, 64).astype(np.float32)).to(dev).to(dtype) for _ in range(3))
        c = rs.randn(3, 1, 64).astype(np.float32)
        k = torch.from_numpy(c + 0.03 * rs.randn(3, n * block, 64).astype(np.float32)).to(dev).to(dtype)
        args = (0.125, block, False)
        f = [t.float() for t in (q, k, v, do)]
        o, lse = bs.sparse_fwd_plain(*f[:3], row_idx, row_cnt, *args)  # fp32 O: delta = Σ P·dP to fp32
        delta = bs.sparse_delta(o, f[3])
        dq = bs.sparse_dq_kernel(q, k, v, do, lse, delta, row_idx, row_cnt, bs.fwd_units(layout_h, block, dev), *args)
        ref = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args)
        foil = bs.sparse_dq_plain(*f, lse, delta, row_idx, row_cnt, *args, ds_dtype=dtype)
        top = ref.abs().max().item()
        err, foil_err = ((x.float() - ref).abs().max().item() / top for x in (dq, foil))
        recs.append(dict(dtype=str(dtype).replace("torch.", ""), block=block, rel_err=err,
                         rounded_ds_rel_err=foil_err, tol=DS_FP32_TOL[dtype]))
    emit(phase="sparse_dq_ds_fp32", cases=recs)
    bad = [r for r in recs if not r["rel_err"] <= r["tol"] < r["rounded_ds_rel_err"]]
    if bad:
        raise AssertionError(f"K8 dS in fp32: {bad}")
    return recs


def phase_sparse_kernels(dev, flush):
    rs = np.random.default_rng(2468)
    main = {}
    for name, (B, NH, T, D, layout, block, causal, timed) in _sparse_cases().items():
        layout = np.asarray(layout, bool)
        base = [torch.from_numpy(rs.standard_normal((B, NH, T, D), dtype=np.float32)).to(dev) for _ in range(4)]
        live = float(layout.mean())
        for dtype, (tol_o, tol_g) in SPARSE_TOL.items():
            q4, k4, v4, do4 = (t.to(dtype) for t in base)
            groups = _sparse_groups(q4, k4, v4, do4, layout, block, dev)
            errs, dead_zero, first = _sparse_errors(groups, block, causal)
            bad = [key for key, (abs_err, rel) in errs.items()
                   if (abs_err > tol_o if key in ("block_sparse_fwd", "block_sparse_lse") else rel > tol_g)]
            dt = str(dtype).replace("torch.", "")
            dead_keys = int(_dead_keys(layout[0], block, causal).sum())
            rec = dict(phase="sparse_kernels", case=name, dtype=dt, causal=causal, block=block,
                       shared_layout=layout.shape[0] == 1, live_block_share=live, block_sparse_fwd_variant=VARIANT[dtype],
                       block_sparse_dq_variant=VARIANT[dtype], block_sparse_dkv_variant=VARIANT[dtype],
                       tol_o_lse_abs=tol_o, tol_grad_rel=tol_g, dead_rows_exact_zero=dead_zero, dead_keys=dead_keys,
                       errors={key: dict(max_abs_err=a, rel_err=r) for key, (a, r) in errs.items()})
            if name.startswith("dead rows") and not (first[1] <= bs.NEG_INF / 2).any():
                raise AssertionError("the dead-rows layout left no dead row")
            if name.startswith("dead keys") and not dead_keys:
                raise AssertionError("the dead-keys layout left no dead key")
            if timed and dtype == torch.bfloat16:  # K7-K9 twice on the same inputs: bitwise-equal outputs
                q, k, v, do, tables, f_units, units, _ = groups[0]
                _, lse, delta = first
                args = (1.0 / float(np.sqrt(D)), block, causal)
                runs = [bs.sparse_fwd_kernel(q, k, v, tables[0], tables[1], f_units, *args) for _ in range(2)]
                torch.cuda.synchronize()
                equal_fwd = torch.equal(runs[0][0].view(torch.int16), runs[1][0].view(torch.int16)) and \
                    torch.equal(runs[0][1].view(torch.int32), runs[1][1].view(torch.int32))
                emit(phase="sparse_fwd_determinism", case=name, dtype=dt, bitwise_equal=equal_fwd,
                     split_q_blocks=int(f_units.reduce.shape[0]))
                runs = [bs.sparse_dq_kernel(q, k, v, do, lse, delta, tables[0], tables[1], f_units, *args)
                        for _ in range(2)]
                torch.cuda.synchronize()
                equal_dq = torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))
                emit(phase="sparse_dq_determinism", case=name, dtype=dt, bitwise_equal=equal_dq,
                     split_q_blocks=int(f_units.reduce.shape[0]))
                runs = [bs.sparse_dkv_kernel(q, k, v, do, lse, delta, tables[2], tables[3], units, *args)
                        for _ in range(2)]
                torch.cuda.synchronize()
                equal = all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(*runs))
                emit(phase="sparse_dkv_determinism", case=name, dtype=dt, bitwise_equal=equal,
                     split_key_blocks=int(units.reduce.shape[0]))
                if not (equal and equal_fwd and equal_dq):
                    raise AssertionError(f"K7, K8 or K9 {name}: two calls on the same inputs differ")
                del runs
            if timed:
                rec["timing"], rec["dense_flash_ms"] = _sparse_timing(groups, q4, k4, v4, do4, layout, block,
                                                                      causal, dtype, flush, first)
                rec["library"] = ("block_sparse_fwd: scaled_dot_product_attention with the layout expanded to an "
                                  "element-wise boolean mask (and the causal mask where set) on [B, NH, T, D]; "
                                  "block_sparse_dq and block_sparse_dkv: the autograd backward of that call, dQ, dK "
                                  "and dV together (the same number on both)")
                main[(name, dt)] = rec
            emit(**rec)
            if bad or not dead_zero:
                raise AssertionError(f"block-sparse {name} {dt}: {bad} past tolerance, dead rows and keys exact zero "
                                     f"{dead_zero}: {errs}")
            del groups, first, q4, k4, v4, do4
        main[(name, "float16")] = _sparse_fp16(name, base, layout, block, causal, timed, dev, flush)
        del base
        torch.cuda.empty_cache()
    # one launch per head for a per-head layout through the fused entry, as JAX runs one kernel per head
    name = "per-head BigBird B=1 NH=4 T=2048 D=128 blk=32"
    B, NH, T, D, layout, block, causal, _ = _sparse_cases()[name]
    q4 = torch.from_numpy(rs.standard_normal((B, NH, T, D), dtype=np.float32)).to(dev).to(torch.bfloat16)
    before = bs.launches_fwd
    out = bs.fused_block_sparse_attention(q4, q4, q4, layout, block, causal=causal)
    torch.cuda.synchronize()
    if bs.launches_fwd - before != NH or not torch.isfinite(out.float()).all():
        raise AssertionError(f"per-head fused call: {bs.launches_fwd - before} K7 launches for {NH} heads")
    _sparse_dq_ds_fp32(dev)
    return main


def _bert_step(attn, hidden, target, weights):
    """One forward and backward of BertSparseSelfAttention with MSE against
    ``target``; returns the loss and the weights' gradients."""
    ws = [w.detach().requires_grad_(True) for w in weights]
    out = attn(hidden, *ws)
    loss = F.mse_loss(out.float(), target)
    loss.backward()
    # the clone: mse_loss's scalar keeps the storage of the elementwise loss ([B, T, H] fp32, 32 MiB at the
    # main shape), so a list of the losses themselves grew by a new allocator segment every step
    return loss.detach().clone(), [w.grad for w in ws]


def _timed_window(step, n):
    """Run ``step`` ``n`` times back to back, from a synchronize to a
    synchronize: ``ms_per_step`` is the window's wall time over ``n``. Beside
    it, what a stray reading needs to be read: each step's host enqueue time
    (``host_ms``), each step's interval on the current stream between CUDA
    events recorded at the step boundaries (``stream_ms``; no synchronize
    inside the window), the garbage collections in it (``gc``: generation
    and ms each) and the allocator's device allocations, frees, retries and
    all-stream syncs in it (``allocator``)."""
    collections, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            collections.append(dict(generation=info["generation"], ms=(time.perf_counter() - started.pop("t")) * 1e3))

    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries", "num_sync_all_streams")
    mem0 = torch.cuda.memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    stamps = []
    torch.cuda.synchronize()
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        events[0].record()
        for i in range(n):
            step()
            events[i + 1].record()
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    mem1 = torch.cuda.memory_stats()
    return dict(ms_per_step=wall * 1e3 / n, wall_ms=wall * 1e3,
                host_ms=[(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)],
                stream_ms=[a.elapsed_time(b) for a, b in zip(events, events[1:])],
                gc=collections, allocator={k: mem1.get(k, 0) - mem0.get(k, 0) for k in keys})


def phase_sparse_train(seed, dev):
    """BertSparseSelfAttention at BERT-large width (16 heads, hidden 1024,
    its default FixedDefault(16) layout) on bf16 hidden states [2, 4096,
    1024]: wq, wk and wv with fp32 masters updated by FusedAdam.apply, cast
    to bf16 for each forward; MSE against a seeded target."""
    cfg = bert_config("large")
    config = types.SimpleNamespace(num_attention_heads=cfg.num_heads, hidden_size=cfg.hidden_size)
    H = cfg.hidden_size
    rs = np.random.default_rng(seed + 4)
    hidden32 = torch.from_numpy(rs.standard_normal((SPARSE_B, SPARSE_T, H), dtype=np.float32)).to(dev)
    target = torch.from_numpy(rs.standard_normal((SPARSE_B, SPARSE_T, H), dtype=np.float32)).to(dev)
    masters = {name: torch.from_numpy((0.02 * rs.standard_normal((H, H))).astype(np.float32)).to(dev)
               for name in ("wq", "wk", "wv")}
    hidden = hidden32.to(torch.bfloat16)
    attn = BertSparseSelfAttention(config)
    opt = FusedAdam(lr=1e-3)
    state = opt.init_state(masters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # counts from here are the sparse main path's
    losses = []

    def step():
        nonlocal masters, state
        loss, grads = _bert_step(attn, hidden, target, [m.to(torch.bfloat16) for m in masters.values()])
        masters, state = opt.apply(dict(zip(masters, grads)), state, masters, opt.defaults["lr"])
        losses.append(loss)

    for _ in range(SPARSE_WARMUP):
        step()
    window = _timed_window(step, SPARSE_TIMED)
    counts, variants = _counts(), _variants()
    losses = [float(x) for x in losses]
    steps = SPARSE_WARMUP + SPARSE_TIMED
    rec = dict(phase="sparse_train", model='BertSparseSelfAttention(bert_config("large") widths), FixedDefault(16)',
               batch=SPARSE_B, seq=SPARSE_T, hidden=H, dtype="bfloat16", steps=steps, timed_steps=SPARSE_TIMED,
               losses=losses, ms_per_step=window["ms_per_step"],
               tokens_per_s=SPARSE_B * SPARSE_T / (window["ms_per_step"] * 1e-3), window=window,
               peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts, variants=variants)
    emit(**rec)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"sparse train: losses not finite or not falling: {losses}")
    sparse_keys = ("block_sparse_fwd", "block_sparse_dq", "block_sparse_dkv")
    if any(counts[k] != steps for k in sparse_keys) or any(counts[k] for k in counts if k not in sparse_keys):
        raise AssertionError(f"sparse train: launches {counts}, want {steps} for each of K7-K9 and 0 for the rest")
    if any(variants[f"{k}_tc"] != steps for k in sparse_keys):
        raise AssertionError(f"sparse train: {variants['block_sparse_fwd_tc']} K7, {variants['block_sparse_dq_tc']} K8 "
                             f"and {variants['block_sparse_dkv_tc']} K9 of {steps} bf16 calls each took the "
                             f"tensor-core variant, want all")

    # fp32 (TF32 off): one step through the kernels and one through impl="plain"
    arms = {}
    for impl in ("kernel", "plain"):
        before = (bs.launches_fwd, bs.launches_fwd_tc, bs.launches_dq_tc, bs.launches_dkv_tc)
        loss, grads = _bert_step(BertSparseSelfAttention(config, impl=impl), hidden32, target,
                                 list(masters.values()))
        tc = (bs.launches_fwd_tc, bs.launches_dq_tc, bs.launches_dkv_tc)
        if (impl == "kernel") != (bs.launches_fwd > before[0]) or tc != before[1:]:
            raise AssertionError(f"fp32 {impl} arm launched K7 {bs.launches_fwd - before[0]} times, the tensor-core "
                                 f"variants of K7-K9 {[a - b for a, b in zip(tc, before[1:])]} times (want 0)")
        arms[impl] = (float(loss), grads)
        torch.cuda.empty_cache()
    loss_rel = abs(arms["kernel"][0] - arms["plain"][0]) / abs(arms["plain"][0])
    grad_rel = {name: ((a - b).abs().max() / b.abs().max()).item()
                for name, a, b in zip(masters, arms["kernel"][1], arms["plain"][1])}
    emit(phase="sparse_train_fp32", loss_kernel=arms["kernel"][0], loss_plain=arms["plain"][0], loss_rel=loss_rel,
         grad_rel=grad_rel, tol_loss_rel=1e-5, tol_grad_rel=1e-3)
    if loss_rel > 1e-5 or any(r > 1e-3 for r in grad_rel.values()):
        raise AssertionError(f"fp32 sparse step: kernel vs plain loss {loss_rel}, grads {grad_rel}")
    del arms

    # a key_padding_mask takes the emulation by JAX's rule: no K7 launch on that call
    mask = torch.ones(SPARSE_B, SPARSE_T, dtype=torch.bool, device=dev)
    mask[0, -300:] = False
    mask[1, -1000:] = False
    before = _counts()
    with torch.no_grad():
        out = attn(hidden, *(m.to(torch.bfloat16) for m in masters.values()), attention_mask=mask)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    finite = bool(torch.isfinite(out.float()).all().item())
    emit(phase="sparse_masked_call", path="block_sparse_attention (emulation)", launches=moved, finite=finite,
         shape=list(out.shape))
    if moved or not finite or out.shape != (SPARSE_B, SPARSE_T, H):
        raise AssertionError(f"masked call: launches {moved}, finite {finite}, shape {tuple(out.shape)}")
    torch.cuda.empty_cache()
    return counts, variants


# --- phases 16a-16e: T4 (head_dim 80, the step programs as CUDA graphs, 2.7B, training shapes) ------
FLASH_D80 = (4, 1024, 32, 80, True)  # gpt2_config("2.7b")'s attention at micro 4 x T 1024: [B, T, N, D], causal
FUSED_GAS, FUSED_STEPS, FUSED_TIMED = 4, 4, 2
WINDOW_H = 4


def phase_flash_d80(dev, flush):
    """Phase 16a: K1-K3 at head_dim 80 ([4, 1024, 32, 80], causal) in bf16,
    fp16 and fp32 (TF32 off), each against its plain version at the
    training shape's tolerances; each timed beside its bound, its plain
    version and SDPA (forward; its autograd backward for K2 and K3)."""
    B, T, N, Dh, causal = FLASH_D80
    rs = np.random.default_rng(8080)
    base = [torch.from_numpy(rs.standard_normal((B, T, N, Dh), dtype=np.float32)).to(dev) for _ in range(4)]
    out = {}
    for dtype, (tol_o, tol_g) in {**FLASH_TOL, torch.float16: FLASH_FP16_TOL}.items():
        q, k, v, do = (t.to(dtype) for t in base)
        errs, (lse, delta) = _flash_errors(q, k, v, do, causal)
        bad = [key for key, (abs_err, rel) in errs.items()
               if (abs_err > tol_o if key in ("flash_fwd", "flash_lse") else rel > tol_g)]
        dt = str(dtype).replace("torch.", "")
        bounds = _flash_bound(B, T, N, Dh, causal, dtype)
        f = [t.float() for t in (q, k, v, do)]
        timed = {
            "flash_fwd": (lambda: fa.flash_fwd_kernel(q, k, v, causal), lambda: fa.flash_fwd_plain(*f[:3], causal)),
            "flash_dq": (lambda: fa.flash_dq_kernel(q, k, v, do, lse, delta, causal),
                         lambda: fa.flash_dq_plain(*f, lse, delta, causal)),
            "flash_dkv": (lambda: fa.flash_dkv_kernel(q, k, v, do, lse, delta, causal),
                          lambda: fa.flash_dkv_plain(*f, lse, delta, causal)),
        }
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
        sdo = do.transpose(1, 2).contiguous()
        lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(sq.detach(), sk.detach(), sv.detach(),
                                                                  is_causal=causal), 20, flush)
        lib_bwd = _time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), sdo, retain_graph=True), 20, flush)
        timing = {}
        for key, (kernel, plain) in timed.items():
            ms = _time_ms(kernel, 20, flush)
            lib = lib_fwd if key == "flash_fwd" else lib_bwd
            timing[key] = dict(ms=ms, plain_ms=_time_ms(plain, 3, flush), library_ms=lib, library_share=lib / ms,
                               roofline_share=bounds[key]["bound_ms"] / ms, **bounds[key])
        rec = dict(phase="flash_d80", case="B=4 T=1024 N=32 D=80 causal", dtype=dt, variant=VARIANT[dtype],
                   tol_o_lse_abs=tol_o, tol_grad_rel=tol_g,
                   errors={key: dict(max_abs_err=a, rel_err=r) for key, (a, r) in errs.items()}, timing=timing,
                   library=("flash_fwd: scaled_dot_product_attention(is_causal=True) on [B, N, T, D]; flash_dq and "
                            "flash_dkv: the autograd backward of that call (dQ, dK and dV together)"))
        emit(**rec)
        out[dt] = rec
        del so, sq, sk, sv, sdo
        if bad:
            raise AssertionError(f"flash D=80 {dt}: {bad} past tolerance: {errs}")
    _free()
    return out


def _weights_on_card(cfg, seed, dev):
    """``_tree_on_card``'s fp32 tree as host numpy: the large models' trees
    in seconds rather than a minute of numpy draws."""
    return {k: v.cpu().numpy() for k, v in _tree_on_card(cfg, seed, dev, torch.float32).items()}


def _step_data(vocab, T, n, micro, seed, dev):
    """``n`` microbatches [micro, T] on the card, drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = torch.from_numpy(rs.randint(0, vocab, (micro, T + 1)).astype(np.int64)).to(dev)
        out.append({"input_ids": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _program_engine(cfg, tree, config, fuse=False, horizon=0, attn_impl=None):
    c = dict(config, compile={"fuse_grad_accum": fuse, "multi_step": {"enable": horizon > 0, "horizon": max(horizon, 2)}})
    return dst.initialize(model=TransformerLM(cfg), config=c, model_parameters=tree, attn_impl=attn_impl)[0]


def _leaf_digest(t):
    """Two int64 sums over the bits of ``t`` (plain and position-weighted),
    on the card in pieces: equal masters give equal digests, and one
    differing element changes them."""
    x = t.detach().contiguous().view(-1)
    x = x.view(torch.int32) if x.element_size() == 4 else x.view(torch.int16)
    total, weighted, step = 0, 0, 1 << 26
    for a in range(0, x.numel(), step):
        piece = x[a:a + step].to(torch.int64)
        w = (torch.arange(a, a + piece.numel(), device=x.device, dtype=torch.int64) % 1000003) + 1
        total += int(piece.sum())
        weighted += int((piece * w).sum())
    return total, weighted


def _master_digest(engine):
    state = engine._master if engine._master is not None else engine._params
    return {k: _leaf_digest(t) for k, t in state.items()}


def _drive(engine, data, steps):
    """``steps`` train_batch calls on one iterator over ``data``: per step
    (loss, grad norm, loss scale) and the host wall of each call, which
    ends in a host read of the loss (the card has finished the step or
    the window)."""
    it = iter(data)
    rec, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = float(engine.train_batch(data_iter=it))
        walls.append((time.perf_counter() - t0) * 1e3)
        rec.append((loss, engine.get_global_grad_norm(), engine.loss_scale))
    return rec, walls


def _kernel_ms(fn):
    """The card's kernel time in one call of ``fn`` (torch.profiler: the
    sum of the kernels' device time, those inside graph replays included)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us += next((float(getattr(evt, a)) for a in ("self_device_time_total", "self_cuda_time_total")
                        if hasattr(evt, a)), 0.0)
    return us / 1e3


def _same_rec(a, b):
    return np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64), equal_nan=True)


def phase_train_fused(seed, dev, tree):
    """Phase 16b: ``compile.fuse_grad_accum`` on config 1's model (GPT-2
    125M, micro 8 x T 1024, FusedAdam wd 0.01, clip 1.0) at gas 4: the step
    program (a warm-up step, then one capture, then one replay a step)
    against the eager engine on the same microbatches, 4 steps, in fp32
    (TF32 off), bf16, fp16 with the loss scale written to 2^40 before step 2
    in both engines and back to 2^14 before step 3 (step 2 overflows: the
    skip and the scale walk run in the program), remat, and dropout 0.1
    (attention and hidden): losses, grad norms, loss scales and a bitwise
    digest of the master equal. Then
    2 more steps of each bf16 engine, timed, and one profiled: step ms and
    the card's idle share (1 - kernel time / step wall)."""
    out = {}
    bf16_cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    fp32_config = {k: v for k, v in TRAIN_CONFIG.items() if k != "bf16"}
    arms = {
        "fp32": (gpt2_config("125m", max_seq_len=1024, remat=False, dtype="float32"), fp32_config),
        "bf16": (bf16_cfg, TRAIN_CONFIG),
        "fp16 overflow": (gpt2_config("125m", max_seq_len=1024, remat=False, dtype="float16"),
                          dict(fp32_config, fp16={"enabled": True, "initial_scale_power": 14, "hysteresis": 1})),
        "bf16 remat": (gpt2_config("125m", max_seq_len=1024, remat=True), TRAIN_CONFIG),
        "bf16 dropout": (gpt2_config("125m", max_seq_len=1024, remat=False, attn_dropout=0.1, hidden_dropout=0.1),
                         TRAIN_CONFIG),
    }
    extra = FUSED_TIMED + 1
    for name, (cfg, config) in arms.items():
        config = dict(config, gradient_accumulation_steps=FUSED_GAS)
        steps = FUSED_STEPS + (extra if name == "bf16" else 0)
        data = _step_data(cfg.vocab_size, cfg.max_seq_len, FUSED_GAS * steps, 8, seed + 16, dev)
        res = {}
        for fuse in (False, True):
            engine = _program_engine(cfg, tree, config, fuse=fuse)
            _zero_counts()
            it = iter(data)
            rec, walls = [], []
            for i in range(FUSED_STEPS):
                if name == "fp16 overflow" and i in (1, 2):
                    # in place, as a captured program reads it: 2^40 forces step 2's overflow (the program
                    # skips it and halves the scale); step 3 starts again from 2^14
                    engine._scale_state.scale.fill_(2.0**40 if i == 1 else 2.0**14)
                t0 = time.perf_counter()
                loss = float(engine.train_batch(data_iter=it))
                walls.append((time.perf_counter() - t0) * 1e3)
                rec.append((loss, engine.get_global_grad_norm(), engine.loss_scale))
            counts, variants = _counts(), _variants()
            r = dict(rec=rec, walls=walls, digest=_master_digest(engine), counts=counts, variants=variants,
                     graphs=engine.window_stats()["graphs"], skipped=engine.skipped_steps)
            if name == "bf16":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(FUSED_TIMED):
                    float(engine.train_batch(data_iter=it))
                r["step_ms"] = (time.perf_counter() - t0) * 1e3 / FUSED_TIMED
                r["kernel_ms"] = _kernel_ms(lambda: float(engine.train_batch(data_iter=it)))
                r["idle_share"] = 1.0 - r["kernel_ms"] / r["step_ms"]
            res["fused" if fuse else "eager"] = r
            del engine, it
            _free()
        eager, fused = res["eager"], res["fused"]
        bitwise = _same_rec(eager["rec"], fused["rec"]) and eager["digest"] == fused["digest"]
        L = cfg.num_layers
        per_step = 0 if "dropout" in name else L * FUSED_GAS * (2 if cfg.remat else 1)  # K1 (no flash under dropout)
        launches_per_step = {"flash_fwd": per_step, "flash_dq": 0 if "dropout" in name else L * FUSED_GAS,
                             "flash_dkv": 0 if "dropout" in name else L * FUSED_GAS}
        rec = dict(phase="train_fused", arm=name, gas=FUSED_GAS, steps=FUSED_STEPS, bitwise=bitwise,
                   losses=[x[0] for x in fused["rec"]], grad_norms=[x[1] for x in fused["rec"]],
                   loss_scales=[x[2] for x in fused["rec"]], skipped=fused["skipped"], graphs=fused["graphs"],
                   eager_launches=eager["counts"], fused_launches=fused["counts"],
                   fused_tensor_core=fused["variants"]["flash_fwd_tc"],
                   launches_per_step=launches_per_step, step_wall_ms=dict(eager=eager["walls"], fused=fused["walls"]))
        if name == "bf16":
            rec.update(step_ms=dict(eager=eager["step_ms"], fused=fused["step_ms"]),
                       kernel_ms=dict(eager=eager["kernel_ms"], fused=fused["kernel_ms"]),
                       idle_share=dict(eager=eager["idle_share"], fused=fused["idle_share"]))
        emit(**rec)
        out[name] = rec
        # the eager run launches every step's kernels; the fused run the warm-up step's and the capture's
        k1_eager, k1_fused = eager["counts"]["flash_fwd"], fused["counts"]["flash_fwd"]
        want_fused, want_eager = 2 * per_step, per_step * FUSED_STEPS
        if not bitwise or (k1_eager, k1_fused) != (want_eager, want_fused) or \
                fused["graphs"] != {"captures": 1, "replays": FUSED_STEPS - 1, "warmups": 1, "uncaptured": 0}:
            raise AssertionError(f"train_fused {name}: bitwise {bitwise}, K1 eager {k1_eager} (want {want_eager}) "
                                 f"fused {k1_fused} (want {want_fused}), graphs {fused['graphs']}: {rec}")
        if name == "fp16 overflow" and not (fused["skipped"] >= 1 and fused["skipped"] < FUSED_STEPS):
            raise AssertionError(f"train_fused fp16: {fused['skipped']} skipped steps, want the forced one and taken ones")
        if not all(np.isfinite(rec["losses"])):
            raise AssertionError(f"train_fused {name}: losses {rec['losses']}")
    return out


def phase_train_window(seed, dev, tree):
    """Phase 16c: ``compile.multi_step`` (horizon 4) on config 1's model in
    bf16: at gas 1 and at gas 4 (over the fused body) 12 steps, each window
    one replay of one captured graph after its warm-up window; bitwise the
    sequential eager run, 3 windows, ``dispatches_per_opt_step`` 0.25, the
    drained losses equal the returned ones; the third window's host wall
    against its replay's device time (CUDA events). A checkpoint interval
    of 6 forces ``checkpoint`` breaks and a 10-step iterator ``data``
    breaks, both bitwise the sequential run; the streamed offload (stage 1,
    ``pipeline_read``/``pipeline_write``) in three windows (a warm-up, two
    captures over fresh state) is bitwise its sequential run."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    out = {}
    steps = 3 * WINDOW_H
    for gas in (1, FUSED_GAS):
        config = dict(TRAIN_CONFIG, gradient_accumulation_steps=gas)
        data = _step_data(cfg.vocab_size, cfg.max_seq_len, gas * steps, 8, seed + 160 + gas, dev)
        ref = _program_engine(cfg, tree, config)
        want, ref_walls = _drive(ref, data, steps)
        want_digest = _master_digest(ref)
        del ref
        _free()
        engine = _program_engine(cfg, tree, config, fuse=gas > 1, horizon=WINDOW_H)
        _zero_counts()
        got, walls = _drive(engine, data, steps)
        counts = _counts()
        engine.flush_loss_drain()
        drained = [d["loss"] for d in engine.drained_losses()]
        stats = engine.window_stats()
        device_ms = engine.window_device_ms()
        bitwise = _same_rec(got, want) and _master_digest(engine) == want_digest
        del engine
        _free()
        third = walls[2 * WINDOW_H:3 * WINDOW_H]
        rec = dict(phase="train_window", gas=gas, horizon=WINDOW_H, steps=steps, bitwise=bitwise,
                   losses=[x[0] for x in got], window_stats=stats, drained_equal=drained == [x[0] for x in got],
                   window_wall_ms=sum(third), window_first_call_ms=third[0], replay_device_ms=device_ms,
                   sequential_ms_per_step=float(np.median(ref_walls[2:])), launches=counts)
        rec["window_idle_share"] = 1.0 - device_ms[0] / rec["window_wall_ms"] if device_ms else None
        emit(**rec)
        out[f"gas{gas}"] = rec
        if not (bitwise and rec["drained_equal"] and stats["window_steps"] == 3
                and stats["dispatches_per_opt_step"] == 0.25 and stats["graphs"]["captures"] == 1):
            raise AssertionError(f"train_window gas {gas}: {rec}")
    # the breaks, at gas 1: a checkpoint interval of 6 (saves at 6 and after), then a 10-step iterator
    config = dict(TRAIN_CONFIG, gradient_accumulation_steps=1)
    data = _step_data(cfg.vocab_size, cfg.max_seq_len, 10, 8, seed + 170, dev)
    ref = _program_engine(cfg, tree, config)
    want, _ = _drive(ref, data, 10)
    del ref
    _free()
    root, fs = _ckpt_root(2 * 124_439_808 * 16)
    try:
        for label, extra in (("checkpoint", {"checkpoint": {"interval_steps": 6, "save_dir": root}}), ("data", {})):
            engine = _program_engine(cfg, tree, dict(config, **extra), horizon=WINDOW_H)
            got, _ = _drive(engine, data, 10)
            stats = engine.window_stats()
            del engine
            _free()
            rec = dict(phase="train_window", case=f"{label} break", bitwise=_same_rec(got, want),
                       break_reasons=stats["window_break_reasons"], window_steps=stats["window_steps"], ckpt_fs=fs)
            emit(**rec)
            out[f"{label}_break"] = rec
            if not rec["bitwise"] or rec["break_reasons"][label] < 1:
                raise AssertionError(f"train_window {label} break: {rec}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the streamed offload in windows: a warm-up, then two captures, each over the window's fresh state
    zero = {"stage": 1, "offload_optimizer": STREAMED_OFFLOAD}
    config = dict(TRAIN_CONFIG, zero_optimization=zero)
    data = _step_data(cfg.vocab_size, cfg.max_seq_len, 3 * WINDOW_H, 8, seed + 180, dev)
    runs = {}
    for horizon in (0, WINDOW_H):
        engine = _program_engine(cfg, tree, config, horizon=horizon)
        rec_, walls = _drive(engine, data, 3 * WINDOW_H)
        host = engine._host_offload.state_dict()
        runs[horizon] = (rec_, walls, [[rec[f].clone() for f in ("master", "exp_avg", "exp_avg_sq")]
                                       for rec in host["leaves"]], engine.window_stats(), host["step"])
        del engine
        _free()
    same_host = all(all(torch.equal(a, b) for a, b in zip(x, y)) for x, y in zip(runs[0][2], runs[WINDOW_H][2]))
    rec = dict(phase="train_window", case="streamed offload", bitwise=_same_rec(runs[0][0], runs[WINDOW_H][0]),
               host_state_bitwise=same_host, host_steps=(runs[0][4], runs[WINDOW_H][4]),
               window_steps=runs[WINDOW_H][3]["window_steps"], graphs=runs[WINDOW_H][3]["graphs"],
               sequential_walls_ms=runs[0][1], window_walls_ms=runs[WINDOW_H][1])
    emit(**rec)
    out["streamed_offload"] = rec
    if not (rec["bitwise"] and same_host and rec["window_steps"] == 3 and rec["graphs"]["captures"] == 2):
        raise AssertionError(f"train_window streamed offload: {rec}")
    return out


TRAIN_2P7B = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 4, "bf16": {"enabled": True},
              "zero_optimization": {"stage": 1}, "gradient_clipping": 1.0,
              "optimizer": {"type": "adam", "params": {"lr": 1e-4, "weight_decay": 0.01}}}
STEPS_2P7B, HORIZON_2P7B = 4, 2
DEPTH_2P7B = 8  # of the model's 32 layers: the width is the model's, the depth cut to make room for 17a-17f


def phase_train_2p7b(seed, dev):
    """Phase 16d: ``gpt2_config("2.7b")`` at full width (2560 wide, 32
    heads of 80) and ``DEPTH_2P7B`` of its 32 layers, bf16, ZeRO-1 at one
    rank, FusedAdam,
    ``remat=True``, micro 4 x T 1024, gas 4, weights drawn on the card: the
    eager engine 4 steps, then (the state does not fit twice)
    ``fuse_grad_accum`` with ``multi_step.horizon`` 2 (a warm-up window,
    then a capture and its replay) 4 steps on the same microbatches: losses
    finite and falling, K1 = 2 x layers x gas, K2 = K3 = layers x gas a step on the tensor-core
    variants, losses, grad norms and a per-leaf bitwise digest of the master
    equal. Then 2 more steps of each engine timed (on the captured one a
    window, one replay, its device span by CUDA events; the eager step runs
    the same kernels): step ms, MFU against the
    dense bf16 peak (6 N + 12 L H T operations a token, the remat recompute
    not counted), the peak and pool figures against the reckoned state, and
    the idle share."""
    cfg = gpt2_config("2.7b", remat=True, num_layers=DEPTH_2P7B)
    t0 = time.perf_counter()
    tree = _weights_on_card(cfg, seed, dev)
    made_s = time.perf_counter() - t0
    gas, micro, T, L = TRAIN_2P7B["gradient_accumulation_steps"], TRAIN_2P7B["train_micro_batch_size_per_gpu"], \
        cfg.max_seq_len, cfg.num_layers
    data = _step_data(cfg.vocab_size, T, gas * STEPS_2P7B, micro, seed + 27, dev)
    arms = {}
    for fused in (False, True):
        t0 = time.perf_counter()
        engine = _program_engine(cfg, tree, TRAIN_2P7B, fuse=fused, horizon=HORIZON_2P7B if fused else 0)
        build_s = time.perf_counter() - t0
        n_params = engine.num_parameters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        rec, walls = _drive(engine, data, STEPS_2P7B)
        counts, variants = _counts(), _variants()
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        r = dict(rec=rec, walls=walls, counts=counts, variants=variants, build_s=build_s,
                 peak_allocated=stats["allocated_bytes.all.peak"], peak_reserved=stats["reserved_bytes.all.peak"],
                 reserved_after=stats["reserved_bytes.all.current"], allocated_after=stats["allocated_bytes.all.current"],
                 window=engine.window_stats(), device_ms=engine.window_device_ms(), digest=_master_digest(engine))
        # a steady stretch of HORIZON_2P7B more steps (on the captured engine one window, one replay), timed
        it = iter(_step_data(cfg.vocab_size, T, gas * HORIZON_2P7B, micro, seed + 28, dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(HORIZON_2P7B):
            float(engine.train_batch(data_iter=it))
        r["steady_ms"] = (time.perf_counter() - t1) * 1e3 / HORIZON_2P7B
        r["steady_device_ms"] = engine.window_device_ms()
        arms["fused" if fused else "eager"] = r
        del engine, it
        _free()
    del tree
    eager, fused = arms["eager"], arms["fused"]
    bitwise = _same_rec(eager["rec"], fused["rec"]) and eager["digest"] == fused["digest"]
    losses = [x[0] for x in fused["rec"]]
    eager_ms, fused_ms = eager["steady_ms"], fused["steady_ms"]
    flops_per_token = 6 * n_params + 12 * L * cfg.hidden_size * T
    tokens = gas * micro * T
    # bf16 params, fp32 master, two fp32 moments, fp32 accumulator, bf16 gradients
    state_bytes = n_params * (2 + 4 + 8 + 4 + 2)
    rec = dict(phase="train_2p7b", model=f'gpt2_config("2.7b", remat=True, num_layers={DEPTH_2P7B})',
               config=TRAIN_2P7B, params=n_params,
               weights_made_s=made_s, build_s=dict(eager=eager["build_s"], fused=fused["build_s"]),
               steps=STEPS_2P7B, horizon=HORIZON_2P7B, bitwise=bitwise, losses=losses,
               grad_norms=[x[1] for x in fused["rec"]], eager_launches=eager["counts"],
               eager_tensor_core=[eager["variants"][f"{k}_tc"] for k in ("flash_fwd", "flash_dq", "flash_dkv")],
               fused_launches=fused["counts"], window_stats=fused["window"], replay_device_ms=fused["device_ms"],
               step_ms=dict(eager=eager_ms, fused=fused_ms), step_walls_ms=dict(eager=eager["walls"], fused=fused["walls"]),
               tokens_per_step=tokens, flops_per_token=flops_per_token,
               mfu=dict(eager=tokens * flops_per_token / (eager_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
                        fused=tokens * flops_per_token / (fused_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]),
               # the steady replay's device span by CUDA events; the eager step runs the same kernels (bitwise)
               device_ms_per_step=fused["steady_device_ms"][0] / HORIZON_2P7B,
               state_bytes_reckoned=state_bytes,
               memory={a: {k: arms[a][k] for k in ("peak_allocated", "peak_reserved", "reserved_after", "allocated_after")}
                       for a in arms})
    # measured for the captured step; for the eager step derived (the replay's device time over the eager
    # wall, on the assumption that the bitwise-equal eager step keeps the card as busy), not measured
    rec["idle_share"] = {"fused": 1.0 - rec["device_ms_per_step"] / rec["step_ms"]["fused"],
                         "eager_derived_from_replay": 1.0 - rec["device_ms_per_step"] / rec["step_ms"]["eager"]}
    emit(**rec)
    want = {"flash_fwd": 2 * L * gas * STEPS_2P7B, "flash_dq": L * gas * STEPS_2P7B, "flash_dkv": L * gas * STEPS_2P7B}
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_2p7b: losses not finite or not falling: {losses}")
    if any(eager["counts"][k] != w for k, w in want.items()) or rec["eager_tensor_core"] != [want[k] for k in want]:
        raise AssertionError(f"train_2p7b: eager launches {eager['counts']}, want {want} all tensor-core")
    if not bitwise:
        raise AssertionError(f"train_2p7b: captured against eager not bitwise: {rec}")
    return rec


def _shape_run(cfg, tree, config, batch_data, steps, attn_impl=None):
    engine = dst.initialize(model=TransformerLM(cfg), config=dict(config), model_parameters=tree, attn_impl=attn_impl)[0]
    _zero_counts()
    rec, _ = _drive(engine, batch_data, steps)
    counts = _counts()
    del engine
    _free()
    return [x[0] for x in rec], counts


SHAPES_DEPTH = 4  # 16e's layers: the models' widths, the depth cut to 8 for 17a-17e, to 4 for 18a-18d


def phase_train_shapes(seed, dev):
    """Phase 16e: training shapes the CPU tests held alone until now, 3 steps
    each through the kernels and through ``attn_impl="plain"`` on the card:
    ``llama_config("1b")`` (GQA 32/4, D 64) at micro 2 x T 2048 and
    ``qwen2_config("0.5b")`` (GQA 14/2, q/k/v biases) at micro 4 x T 1024,
    both with remat, at their widths and ``SHAPES_DEPTH`` layers. One fp32 step (TF32 off) of kernel and plain within
    1e-5 (the kernels' math); then bf16, where the kernel arm's loss gap to
    the plain arm must stay within twice the plain arm's own bf16-to-fp32
    gap (or 1e-3 of the loss): the rounding bf16 itself brings. Config 1
    with ``position="alibi"``: no kernel launches; its fp32 loss on the card
    equals the port's CPU loss on the same weights and batch within 1e-5;
    3 bf16 steps fall."""
    out = {}
    base = {"optimizer": {"type": "adam", "params": {"lr": 1e-4, "weight_decay": 0.01}}, "gradient_clipping": 1.0,
            "zero_optimization": {"stage": 1}}
    d = SHAPES_DEPTH
    for label, make, micro, T in ((f'llama_config("1b", num_layers={d})',
                                   lambda dt: llama_config("1b", max_seq_len=2048, dtype=dt, num_layers=d), 2, 2048),
                                  (f'qwen2_config("0.5b", num_layers={d})',
                                   lambda dt: qwen2_config("0.5b", max_seq_len=1024, dtype=dt, num_layers=d), 4, 1024)):
        cfg32 = make("float32")
        tree = _weights_on_card(cfg32, seed, dev)
        data = _step_data(cfg32.vocab_size, T, 3, micro, seed + 31, dev)
        arms = {}
        for dt in ("float32", "bfloat16"):
            cfg = make(dt)
            config = dict(base, train_micro_batch_size_per_gpu=micro, **({"bf16": {"enabled": True}} if dt == "bfloat16" else {}))
            n = 1 if dt == "float32" else 3
            for impl in ("kernel", "plain"):
                arms[(dt, impl)] = _shape_run(cfg, tree, config, data, n, attn_impl=impl)
        del tree
        L = cfg32.num_layers
        fp32_gap = abs(arms[("float32", "kernel")][0][0] - arms[("float32", "plain")][0][0]) / \
            abs(arms[("float32", "plain")][0][0])
        bf_k, bf_p = arms[("bfloat16", "kernel")][0], arms[("bfloat16", "plain")][0]
        rounding = abs(arms[("bfloat16", "plain")][0][0] - arms[("float32", "plain")][0][0])
        tol = max(2 * rounding, 1e-3 * abs(bf_p[0]))
        gaps = [abs(a - b) for a, b in zip(bf_k, bf_p)]
        counts = arms[("bfloat16", "kernel")][1]
        rec = dict(phase="train_shapes", model=label, micro=micro, seq=T, fp32_step1_rel_gap=fp32_gap,
                   fp32_losses={impl: arms[("float32", impl)][0] for impl in ("kernel", "plain")},
                   bf16_losses={"kernel": bf_k, "plain": bf_p}, bf16_gaps=gaps, bf16_tol=tol,
                   bf16_kernel_launches=counts, plain_launches=arms[("bfloat16", "plain")][1])
        emit(**rec)
        out[label] = rec
        want = {"flash_fwd": 2 * L * 3, "flash_dq": L * 3, "flash_dkv": L * 3}
        if fp32_gap > 1e-5 or max(gaps) > tol or any(counts[k] != w for k, w in want.items()) or \
                arms[("bfloat16", "plain")][1]["flash_fwd"] or not all(np.isfinite(bf_k)):
            raise AssertionError(f"train_shapes {label}: {rec}")
    # ALiBi: no kernel; the card's fp32 loss against the port's CPU loss
    cfg32 = gpt2_config("125m", max_seq_len=1024, remat=False, position="alibi", dtype="float32")
    tree = _weights(cfg32, seed)
    batch = _step_data(cfg32.vocab_size, 1024, 1, 1, seed + 33, dev)[0]
    losses = {}
    for device in ("cuda", "cpu"):
        engine = dst.initialize(model=TransformerLM(cfg32), config=dict(base, train_micro_batch_size_per_gpu=1),
                                model_parameters=tree, device=device)[0]
        engine.eval()
        with torch.no_grad():
            losses[device] = float(engine({k: v.to(device) for k, v in batch.items()}))
        del engine
    _free()
    data = _step_data(cfg32.vocab_size, 1024, 1, 8, seed + 34, dev) * 3  # one batch three times: the loss falls
    bf16, counts = _shape_run(gpt2_config("125m", max_seq_len=1024, remat=False, position="alibi"), tree,
                              dict(TRAIN_CONFIG), data, 3)
    del tree
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    rec = dict(phase="train_shapes", model='gpt2_config("125m", max_seq_len=1024, remat=False, position="alibi")',
               fp32_card_loss=losses["cuda"], fp32_cpu_loss=losses["cpu"], fp32_rel_gap=rel, bf16_losses=bf16,
               launches=counts)
    emit(**rec)
    out["alibi"] = rec
    if rel > 1e-5 or counts["flash_fwd"] or not (all(np.isfinite(bf16)) and bf16[-1] < bf16[0]):
        raise AssertionError(f"train_shapes alibi: {rec}")
    return out


def _fused_field(name, fused, window, big, shapes):
    """K1-K3's launches on phases 16b-16e's step programs. A wrapper counts
    host calls: under a captured program it counts the warm-up's launches
    and the capture's, and a replay adds none; so each entry gives the
    counter, the launches a step makes and the replays, and the launches
    the card ran are the counter plus replays x launches a replay."""
    remat = {"flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}
    out = {"train_fused": {arm: dict(eager=r["eager_launches"][name], captured_counter=r["fused_launches"][name],
                                     per_step=r["launches_per_step"][name], replays=r["graphs"]["replays"])
                           for arm, r in fused.items()}}
    out["train_window"] = {k: dict(counter=r["launches"][name], replays=r["window_stats"]["graphs"]["replays"],
                                   horizon=r["horizon"], gas=r["gas"]) for k, r in window.items() if k.startswith("gas")}
    gas, L = TRAIN_2P7B["gradient_accumulation_steps"], DEPTH_2P7B
    out["train_2p7b"] = dict(eager=big["eager_launches"][name], per_step=remat[name] * L * gas,
                             captured_counter=big["fused_launches"][name],
                             replays=big["window_stats"]["graphs"]["replays"], horizon=big["horizon"])
    out["train_shapes"] = {m: r["bf16_kernel_launches"][name] for m, r in shapes.items() if m != "alibi"}
    return out


# --- phases 17a-17f: the data pipeline (T5) and MoE on one rank (M1, first half) ------------------
T5_STEPS, T5_GAS, T5_MICRO = 20, 2, 8
T5_FLASH = {"curriculum T=72": (8, 72, 12, 64, True), "random-LTD kept=400": (8, 400, 12, 64, True)}
T5_CURRICULUM = {"enabled": True, "min_difficulty": 64, "max_difficulty": 1024, "schedule_type": "fixed_linear",
                 "schedule_config": {"total_curriculum_step": 8, "difficulty_step": 8}}
T5_LTD = {"enabled": True, "data_routing": {"enabled": True, "random_ltd": {
    "enabled": True, "random_ltd_layer_num": 10,
    "random_ltd_schedule": {"min_value": 128, "max_value": 1024,
                            "schedule_config": {"require_steps": 12, "seq_per_step": 16}}}}}
T5_PLD = {"enabled": True, "theta": 0.5, "gamma": 0.5}
T5_MEMORY_SLACK = 1.10  # the schedule's reserved memory against one run at its final shape (allocator rounding)
T5_RESUME_STEPS, T5_RESUME_AT = 8, 4
CHAIN = 256  # the corpus's token range: a Markov chain (next = 7 prev + 3 mod 256, one token in ten uniform)
MOE_CFG = dict(moe_top_k=2)  # moe_llama_config("1b-8e", moe_top_k=2)
MOE_TRAIN_LAYERS = 6  # of 22: the fp32 master, two Adam moments and the fp32 accumulator at 16 B a parameter
MOE_TRAIN = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2, "bf16": {"enabled": True},
             "zero_optimization": {"stage": 1}, "gradient_clipping": 1.0,
             "optimizer": {"type": "adam", "params": {"lr": 1e-4, "weight_decay": 0.01}}}
MOE_STEPS = 3
MOE_BUCKETED_REQUESTS = 8  # the first 8 of phase 3's 16: the bucketed oracle's host loop is the slow one
MOE_SERVE_DEPTH = 8  # 17d's layers of 22: its width, the depth cut to make room for 18a-18d


def phase_t5_kernels(dev):
    """Phase 17a: K1-K3 against their plain versions at the data
    pipeline's new lengths: a curriculum length that is a multiple of 8
    but not of 64 (T = 72) and a random-LTD kept count (400), both at
    config 1's heads (micro 8, 12 heads of 64, causal), fp32 (TF32 off)
    and bf16, at phase 10's tolerances."""
    rs = np.random.default_rng(1717)
    out = {}
    for name, (B, T, N, Dh, causal) in T5_FLASH.items():
        base = [torch.from_numpy(rs.standard_normal((B, T, N, Dh), dtype=np.float32)).to(dev) for _ in range(4)]
        for dtype in (torch.float32, torch.bfloat16):
            tol_o, tol_g = FLASH_TOL[dtype]
            q, k, v, do = (t.to(dtype) for t in base)
            errs, _ = _flash_errors(q, k, v, do, causal)
            bad = [key for key, (abs_err, rel) in errs.items()
                   if (abs_err > tol_o if key in ("flash_fwd", "flash_lse") else rel > tol_g)]
            dt = str(dtype).replace("torch.", "")
            rec = dict(phase="t5_kernels", case=name, dtype=dt, variant=VARIANT[dtype], tol_o_lse_abs=tol_o,
                       tol_grad_rel=tol_g, errors={key: dict(max_abs_err=a, rel_err=r) for key, (a, r) in errs.items()})
            emit(**rec)
            out[f"{name} {dt}"] = rec["errors"]
            if bad:
                raise AssertionError(f"t5 kernels {name} {dt}: {bad} past tolerance: {errs}")
    _free()
    return out


def _t5_corpus(root, seed, n_docs):
    """``n_docs`` documents of 64..1024 tokens written by
    ``MMapIndexedDatasetBuilder`` under ``root/corpus``, analysed by
    ``DataAnalyzer`` on their length (``seqlen``). Returns the dataset."""
    from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import DataAnalyzer, make_builder, make_dataset

    rs = np.random.default_rng(seed)
    prefix = os.path.join(root, "corpus")
    builder = make_builder(prefix + ".bin", dtype=np.uint16)
    for n in rs.integers(64, 1025, n_docs):
        noise, rnd = rs.random(n) < 0.1, rs.integers(0, CHAIN, n)
        doc = np.empty(n, np.int64)
        doc[0] = rnd[0]
        for i in range(1, n):
            doc[i] = rnd[i] if noise[i] else (7 * doc[i - 1] + 3) % CHAIN
        builder.add_item(doc)
        builder.end_document()
    builder.finalize(prefix + ".idx")
    corpus = make_dataset(prefix)
    DataAnalyzer(corpus, num_workers=2, metric_names=["seqlen"], metric_functions=[len],
                 metric_types=["single_value_per_sample"], save_path=os.path.join(root, "analysis")).run()
    return corpus


class _CorpusItems:
    """Training items over the corpus in ``order``: a document's tokens as
    ``input_ids`` and the next ones as ``labels``, padded to ``T`` (token 0,
    label -100)."""

    def __init__(self, corpus, order, T):
        self.corpus, self.order, self.T = corpus, np.asarray(order), T

    def __len__(self):
        return len(self.order)

    def __getitem__(self, i):
        doc = self.corpus[int(self.order[i])].astype(np.int64)
        n = min(doc.size - 1, self.T)
        ids, labels = np.zeros(self.T, np.int64), np.full(self.T, -100, np.int64)
        ids[:n], labels[:n] = doc[:n], doc[1:n + 1]
        return {"input_ids": ids, "labels": labels}


def _t5_order(root, n, seed):
    """``n`` sample indices from ``DeepSpeedDataSampler`` over the analysis
    (``sampler_from_analysis``), its own seqlen curriculum stepping once per
    optimizer step (gas x micro samples)."""
    from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
    from deepspeed_tpu_torch.runtime.data_pipeline.data_sampler import sampler_from_analysis

    sched = CurriculumScheduler({k: v for k, v in T5_CURRICULUM.items() if k != "enabled"})
    sampler = sampler_from_analysis(os.path.join(root, "analysis"), "seqlen", sched, seed=seed,
                                    global_batch_size=T5_GAS * T5_MICRO)
    it = iter(sampler)
    return [next(it) for _ in range(n)], sampler.state_dict()


def _t5_run(cfg, tree, config, items, steps, record_kwargs=False):
    """``steps`` train_batch calls over ``initialize(training_data=items)``'s
    dataloader: per step the loss, the curriculum length, the kept count,
    the reserved and allocated bytes; the counters; the engine."""
    _free()
    engine, _, loader, _ = dst.initialize(model=TransformerLM(cfg), config=config, model_parameters=tree,
                                          training_data=items)
    drawn = []
    if record_kwargs:  # the keep flags each microbatch drew (the eager path reads them on the host)
        draw = engine._model_kwargs
        engine._model_kwargs = lambda *a, **k: drawn.append(draw(*a, **k)) or drawn[-1]
    it = RepeatingLoader(loader)
    _zero_counts()
    rows, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = float(engine.train_batch(data_iter=it))
        walls.append((time.perf_counter() - t0) * 1e3)
        rows.append(dict(loss=loss, seqlen=engine.curriculum_scheduler.get_current_difficulty()
                         if engine.curriculum_scheduler else None,
                         kept=engine.random_ltd_scheduler.current if engine.random_ltd_scheduler else None,
                         theta=engine.progressive_layer_drop.get_theta() if engine.progressive_layer_drop else None,
                         reserved=torch.cuda.memory_reserved(), allocated=torch.cuda.memory_allocated()))
    return engine, rows, walls, _counts(), _variants(), drawn


def phase_t5_train(seed, dev, tree):
    """Phase 17b: config 1's model (GPT-2 125M, full width and depth) in
    bf16, ZeRO-1, FusedAdam, micro 8, ``fuse_grad_accum`` at gas 2, trained
    on a seeded synthetic corpus (``MMapIndexedDatasetBuilder`` documents of
    64..1024 tokens, enough for 2 epochs of the run, analysed by
    ``DataAnalyzer`` on length, ordered by ``DeepSpeedDataSampler``) through
    ``initialize(training_data=...)``, curriculum ``seqlen`` ``fixed_linear``
    64 -> 1024 in steps of 8: run A with random-LTD (layers 1-10 of 12,
    kept 128 -> 1024 in steps of 16), run B with PLD (theta 0.5, gamma 0.5),
    20 steps each. Losses finite and falling; K1 = K2 = K3 = the layers that
    ran a microbatch, counted at each step program's warm-up and capture (a
    replay passes no wrapper: PLD's captured step computes every layer and
    keeps or drops each by torch.where), all tensor-core; reserved memory
    over the schedule within 10% of one run at the final shape alone. Then
    PLD eager (no step program) 4 steps: K1 = the kept layers, each step's
    ms beside the captured step's."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    L = cfg.num_layers
    root = tempfile.mkdtemp(prefix="chip_smoke_t5_")
    t0 = time.perf_counter()
    n = T5_STEPS * T5_GAS * T5_MICRO
    corpus = _t5_corpus(root, seed + 17, 2 * n)
    order, sampler_state = _t5_order(root, n, seed)
    items = _CorpusItems(corpus, order, cfg.max_seq_len)
    data_s = time.perf_counter() - t0
    base = dict(TRAIN_CONFIG, gradient_accumulation_steps=T5_GAS, compile={"fuse_grad_accum": True},
                curriculum_learning=T5_CURRICULUM)
    runs = {}
    for name, extra in (("random_ltd", {"data_efficiency": T5_LTD}), ("pld", {"progressive_layer_drop": T5_PLD})):
        engine, rows, walls, counts, variants, _ = _t5_run(cfg, tree, dict(base, **extra), items, T5_STEPS)
        g = engine.window_stats()["graphs"]
        want = (g["warmups"] + g["captures"]) * L * T5_GAS
        runs[name] = dict(rows=rows, walls_ms=walls, counts=counts, variants=variants, graphs=g, launches_want=want,
                          programs_alive=len(engine._graphs))
        del engine
        # one run at the schedule's final shape alone: the memory the whole schedule may reserve
        final = dict(base, **extra)
        final["curriculum_learning"] = dict(T5_CURRICULUM, min_difficulty=1024)
        if name == "random_ltd":
            final["data_efficiency"] = copy.deepcopy(T5_LTD)
            final["data_efficiency"]["data_routing"]["random_ltd"]["random_ltd_schedule"]["min_value"] = 1024
        ref, ref_rows, _, _, _, _ = _t5_run(cfg, tree, final, items, 3)
        runs[name]["final_shape_reserved"] = max(r["reserved"] for r in ref_rows)
        del ref
    pld_eager, eager_rows, eager_walls, eager_counts, _, drawn = _t5_run(
        cfg, tree, dict(TRAIN_CONFIG, gradient_accumulation_steps=T5_GAS, progressive_layer_drop=T5_PLD,
                        curriculum_learning=dict(T5_CURRICULUM, min_difficulty=1024)), items, 4, record_kwargs=True)
    kept_layers = sum(sum(d["pld_keep"]) for d in drawn)
    del pld_eager
    shutil.rmtree(root, ignore_errors=True)
    _free()
    for name, r in runs.items():
        losses = [x["loss"] for x in r["rows"]]
        reserved = [x["reserved"] for x in r["rows"]]
        r.update(losses=losses, first3=float(np.mean(losses[:3])), last3=float(np.mean(losses[-3:])),
                 seqlens=[x["seqlen"] for x in r["rows"]], kept=[x["kept"] for x in r["rows"]],
                 thetas=[x["theta"] for x in r["rows"]], reserved=reserved, reserved_peak=max(reserved),
                 reserved_limit=r["final_shape_reserved"] * T5_MEMORY_SLACK,
                 captured_step_ms_p50=float(np.median(r["walls_ms"][-4:])))
        emit(phase="t5_train", run=name, model='gpt2_config("125m", max_seq_len=1024)', corpus_docs=2 * n,
             data_s=data_s, sampler_state=sampler_state, **{k: v for k, v in r.items() if k != "rows"})
        bad = []
        if not all(np.isfinite(losses)) or not r["last3"] < r["first3"]:
            bad.append("losses not finite or not falling")
        if any(r["counts"][k] != r["launches_want"] for k in ("flash_fwd", "flash_dq", "flash_dkv")):
            bad.append(f"K1-K3 {r['counts']} != {r['launches_want']}")
        if [r["variants"][f"{k}_tc"] for k in ("flash_fwd", "flash_dq", "flash_dkv")] != [r["launches_want"]] * 3:
            bad.append("a K1-K3 launch off the tensor cores")
        if r["reserved_peak"] > r["reserved_limit"] or r["programs_alive"] != 1 or r["graphs"]["captures"] == 0:
            bad.append(f"reserved peak {r['reserved_peak']} > {r['reserved_limit']}, programs alive "
                       f"{r['programs_alive']}, captures {r['graphs']['captures']}")
        if name == "random_ltd" and not any(k is not None and k < s for k, s in zip(r["kept"], r["seqlens"])):
            bad.append("random-LTD never dropped a token")
        if bad:
            raise AssertionError(f"t5_train {name}: {bad}")
    eager = dict(losses=[x["loss"] for x in eager_rows], step_ms=eager_walls, counts=eager_counts,
                 kept_layers=kept_layers, all_layers=len(drawn) * L)
    emit(phase="t5_train", run="pld eager (host skip)", **eager,
         captured_step_ms_p50=runs["pld"]["captured_step_ms_p50"])
    if any(eager_counts[k] != kept_layers for k in ("flash_fwd", "flash_dq", "flash_dkv")) or \
            kept_layers >= len(drawn) * L:
        raise AssertionError(f"t5_train pld eager: launches {eager_counts}, kept layers {kept_layers} of "
                             f"{len(drawn) * L}")
    runs["pld_eager"] = eager
    return runs


def phase_t5_resume(seed, dev, tree):
    """Phase 17c: config 1 in bf16 at gas 2 with ``fuse_grad_accum`` and
    ``multi_step`` windows of 2 over ``initialize(training_data=...)``'s
    dataloader (the window's ``PrefetchingLoader`` places gas x 2
    microbatches on the card ahead): 8 steps uninterrupted; then 4 steps,
    a checkpoint while the look-ahead holds untrained batches, a fresh
    engine resumed from it and 4 more. Losses, grad norms and the master
    digest bit for bit the uninterrupted run's."""
    cfg = gpt2_config("125m", max_seq_len=1024, remat=False)
    root = tempfile.mkdtemp(prefix="chip_smoke_t5r_")
    corpus = _t5_corpus(root, seed + 18, T5_RESUME_STEPS * T5_GAS * T5_MICRO)
    items = _CorpusItems(corpus, np.arange(len(corpus)), cfg.max_seq_len)
    config = dict(TRAIN_CONFIG, gradient_accumulation_steps=T5_GAS,
                  compile={"fuse_grad_accum": True, "multi_step": {"enable": True, "horizon": 2}})
    ckpt, fs = _ckpt_root(4 * 2**30)

    def run(n, load=False):
        _free()
        engine, _, loader, _ = dst.initialize(model=TransformerLM(cfg), config=config, model_parameters=tree,
                                              training_data=items)
        if load:
            engine.load_checkpoint(ckpt)
        it = RepeatingLoader(loader)
        rec = []
        for _ in range(n):
            loss = float(engine.train_batch(data_iter=it))
            rec.append((loss, float(engine.get_global_grad_norm())))
        return engine, rec

    full_engine, full = run(T5_RESUME_STEPS)
    full_digest = _master_digest(full_engine)
    del full_engine
    engine, first = run(T5_RESUME_AT)
    staged = engine._active_prefetcher.buffered()
    cursor = engine._checkpoint_state(None)["data_cursor"]
    engine.save_checkpoint(ckpt)
    del engine
    engine, rest = run(T5_RESUME_STEPS - T5_RESUME_AT, load=True)
    bitwise = _same_rec(first + rest, full) and _master_digest(engine) == full_digest
    del engine
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    _free()
    rec = dict(phase="t5_resume", steps=T5_RESUME_STEPS, saved_at=T5_RESUME_AT, staged_at_save=staged,
               cursor=cursor, filesystem=fs, bitwise=bitwise, losses=[x[0] for x in full])
    emit(**rec)
    if not bitwise or staged == 0:
        raise AssertionError(f"t5_resume: bitwise {bitwise}, staged batches at the save {staged}: {full} vs "
                             f"{first + rest}")
    return rec


def _moe_gaps(cfg, tree_t, context, dev):
    """The plain path's margins at the position after ``context`` (one
    prefill row over a fresh pool): the final logits' top-2 gap, and the
    smallest router margin (the k-th gate logit over the next one) of any
    token of the row in any MoE layer, where a tie flips an expert choice
    and moves that token's hidden state, and so every later logit."""
    margins = []
    route = MoE.route

    def record(self, params, tokens, **kw):
        logits = tokens.float() @ params["gate"]["wg"].float()
        top = torch.topk(logits, self.k + 1, dim=-1).values
        margins.append(float((top[:, self.k - 1] - top[:, self.k]).min()))
        return route(self, params, tokens, **kw)

    MoE.route = record
    try:
        gap = _top2_gap(cfg, tree_t, context, dev)
    finally:
        MoE.route = route
    return gap, min(margins)


def _moe_partings(cfg, params, outs, ref, dev):
    """Where each stream first parts from ``ref``, with the plain path's
    final top-2 gap and smallest router margin there; raises when both
    are 1e-4 or more (phase 4's top-2 gap rule, with the router's choice as
    the other place two fp32 runs may part)."""
    partings = []
    for i, (a, b) in enumerate(zip(outs, ref)):
        if a.shape != b.shape:
            raise AssertionError(f"moe stream {i}: shapes {a.shape} vs {b.shape}")
        diff = np.nonzero(a != b)[0]
        if diff.size:
            at = int(diff[0])
            gap, margin = _moe_gaps(cfg, params, b[:at], dev)
            partings.append({"request": i, "position": at, "plain_top2_gap": gap, "router_margin": margin})
            if min(gap, margin) >= 1e-4:
                raise AssertionError(f"moe stream {i} parts at {at}: plain top-2 gap {gap}, router margin {margin}")
    return partings


def _moe_model(cfg, seed, dev, dtype):
    model = MoETransformerLM(cfg)
    tree = _tree_on_card(cfg, seed, dev, dtype)
    load_jax_params(model, tree, device=dev, dtype=dtype)
    del tree
    _free()
    return model


def phase_moe_serve(seed, dev):
    """Phase 17d: ``moe_llama_config("1b-8e", moe_top_k=2)`` at full width
    and depth (hidden 2048, 22 layers, 32/4 heads, 8 experts of 5376),
    weights drawn on the card and installed through ``load_jax_params``.
    fp32 (TF32 off) without capacity drops (``moe_drop_tokens=False``: a
    token's logits then do not depend on the rows packed beside it, so a
    one-row recompute reproduces them): phase 4's prompts, 32 new tokens
    each, through K4 and through the plain attention on one model, streams
    identical up to the top-2 gap rule, a router margin below 1e-4 counting
    as a near-tie too. bf16 with the config's drops: phase 3's 16 requests
    ragged (K4 = 22 a step), the first 8 of them bucketed (K5 = 22 a decode
    round), windows of 8 on steady traffic (8 x 128 new) against single
    steps, and ``generate`` (K6 = 22 a token);
    tok/s and TPOT. ``generate``: 4 prompts of 224, 32 new tokens (a
    256-position cache, JAX's condition for the decode kernel)."""
    cfg32 = moe_llama_config("1b-8e", num_layers=MOE_SERVE_DEPTH, dtype="float32", moe_drop_tokens=False, **MOE_CFG)
    cfg = moe_llama_config("1b-8e", num_layers=MOE_SERVE_DEPTH, **MOE_CFG)
    out = {}
    t0 = time.perf_counter()
    model = _moe_model(cfg32, seed, dev, torch.float32)
    made_s = time.perf_counter() - t0
    params_n = sum(p.numel() for p in model.parameters())
    paged = {"page_size": 16, "max_slots": 8}
    kernel = dst.init_inference(model, dtype="fp32", paged_kv=dict(paged, attn_impl="kernel"))
    plain = dst.init_inference(model, dtype="fp32", paged_kv=dict(paged, attn_impl="plain"))
    rs = np.random.default_rng(seed + 1)
    prompts = [rs.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in (40, 100, 200, 333)]
    _zero_counts()
    outs_k = kernel.serve(prompts, max_new_tokens=32)
    k4 = _counts()["ragged_paged_attention"]
    outs_p = plain.serve(prompts, max_new_tokens=32)
    if k4 == 0 or _counts()["ragged_paged_attention"] != k4:
        raise AssertionError(f"moe fp32: the kernel arm launched K4 {k4} times, the plain arm "
                             f"{_counts()['ragged_paged_attention'] - k4}")
    partings = _moe_partings(cfg32, model.param_tree(), outs_k, outs_p, dev)
    out["fp32"] = dict(identical=sum(1 for a, b in zip(outs_k, outs_p) if np.array_equal(a, b)), partings=partings,
                       k4=k4)
    emit(phase="moe_serve", dtype="float32", params=params_n, weights_made_s=made_s, requests=4, new_tokens=32,
         **out["fp32"])
    del kernel, plain, model
    _free()

    t0 = time.perf_counter()
    model = _moe_model(cfg, seed, dev, torch.bfloat16)
    made_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    all_prompts, all_budgets = _requests(seed, cfg.vocab_size)
    for name, extra, n in (("ragged", {}, 16), ("bucketed", {"ragged": False}, MOE_BUCKETED_REQUESTS)):
        prompts, budgets = all_prompts[:n], all_budgets[:n]
        engine = dst.init_inference(model, dtype="bf16", paged_kv=dict(paged, **extra))
        _zero_counts()
        t0 = time.perf_counter()
        outs = engine.serve(prompts, max_new_tokens=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s, counts = engine.serve_stats(), _counts()
        for p, b, o in zip(prompts, budgets, outs):
            if o is None or o.shape != (p.size + b,) or o.min() < 0 or o.max() >= cfg.vocab_size:
                raise AssertionError(f"moe {name}: malformed output for a {p.size}-token prompt")
        kernel_name, steps = (("ragged_paged_attention", s["ragged_steps"]) if name == "ragged"
                              else ("paged_decode_attention", s["decode_steps"]))
        rec = dict(requests=len(outs), generated_tokens=sum(budgets), wall_s=wall, tokens_per_s=sum(budgets) / wall,
                   ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"], steps=steps, launches=counts,
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
        emit(phase="moe_serve", dtype="bfloat16", server=name, **rec)
        out[name] = rec
        if counts[kernel_name] != cfg.num_layers * steps or steps == 0 or sum(counts.values()) != counts[kernel_name]:
            raise AssertionError(f"moe {name}: launches {counts}, want {kernel_name} = {cfg.num_layers} x {steps}")
        del engine
    rs = np.random.default_rng(seed + 7)
    steady = [rs.integers(0, cfg.vocab_size, 128, dtype=np.int32) for _ in range(8)]
    runs, ref = [], None
    for multi_step in (None, WINDOWS["multi_step"]):
        server = PagedServer(cfg, model.param_tree(), page_size=16, max_slots=8, dtype=torch.bfloat16,
                             prefix_cache=True, multi_step=multi_step)
        outs, rec = _steady_run(server, steady, 128)
        ref = ref or outs
        rec.update(mode="windows" if multi_step else "single-step",
                   identical=sum(1 for a, b in zip(outs, ref) if np.array_equal(a, b)))
        want = _k4_counter_want(cfg, rec)
        emit(phase="moe_serve", dtype="bfloat16", server="steady", requests=8, new_tokens=128,
             **{k: v for k, v in rec.items() if k != "launches"}, k4_counter_want=want)
        if rec["k4_counter"] != want or (multi_step and rec["window_steps"] == 0):
            raise AssertionError(f"moe steady {rec['mode']}: K4 counter {rec['k4_counter']} want {want}, "
                                 f"window steps {rec['window_steps']}")
        runs.append({k: rec[k] for k in ("mode", "tokens_per_s", "tpot_ms", "window_steps", "window_ms_p50",
                                         "single_step_ms_p50", "identical", "k4_counter")})
        del server
    out["steady"] = runs
    engine = dst.init_inference(model, dtype="bf16")
    # 224 + 32: the cache holds 256 positions, a multiple of 256, which is JAX's condition for the decode kernel
    gen_prompts = np.random.default_rng(seed + 9).integers(0, cfg.vocab_size, (4, 224), dtype=np.int32)
    _zero_counts()
    t0 = time.perf_counter()
    gen = engine.generate(gen_prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_generated("moe generate", gen, gen_prompts, 32, cfg.vocab_size)
    counts = _counts()
    out["generate"] = dict(batch=4, prompt=224, new_tokens=32, wall_s=wall, ms_per_token=wall * 1e3 / 32,
                           launches=counts)
    emit(phase="moe_serve", dtype="bfloat16", server="generate", weights_made_s=made_s, **out["generate"])
    if counts["decode_attention"] != cfg.num_layers * 32 or sum(counts.values()) != counts["decode_attention"]:
        raise AssertionError(f"moe generate: launches {counts}, want K6 = {cfg.num_layers} x 32")
    del engine, model
    _free()
    return out


def _moe_stats(engine, batch):
    """Each MoE layer's load-balance loss (unscaled) and expert token
    counts on one training forward, read by wrapping the model's layer."""
    moe, layers = engine.module.moe, []
    apply = moe.apply

    def record(*a, **k):
        out = apply(*a, **k)
        layers.append((float(out[1]), out[2].tolist()))
        return out

    moe.apply = record
    try:
        with torch.no_grad():
            engine.module.apply(engine._param_tree, (batch["input_ids"], batch["labels"]), train=True)
    finally:
        moe.apply = apply
    return layers


def phase_moe_train(seed, dev):
    """Phase 17e: ``moe_llama_config("1b-8e", moe_top_k=2)`` at full width
    and 6 of its 22 layers (the fp32 master, two Adam moments and the fp32
    accumulator take 16 B a parameter), bf16, ZeRO-1, FusedAdam, micro 4 x
    T 1024 at gas 2: the eager engine 3 steps, then ``fuse_grad_accum`` 3
    steps (a warm-up, a capture and a replay) on the same microbatches, bit
    for bit (losses, grad norms, master digest); losses and the load-balance
    losses finite, each layer's expert token counts recorded; K1-K3 = one a
    layer and microbatch, on the tensor cores. Then one fp32 step (TF32 off)
    through the kernels and through ``attn_impl="plain"``: loss and grad
    norm within 1e-5 relative."""
    cfg = moe_llama_config("1b-8e", num_layers=MOE_TRAIN_LAYERS, max_seq_len=1024, remat=False, **MOE_CFG)
    gas, micro, T, L = MOE_TRAIN["gradient_accumulation_steps"], MOE_TRAIN["train_micro_batch_size_per_gpu"], \
        cfg.max_seq_len, cfg.num_layers
    data = _step_data(cfg.vocab_size, T, gas * MOE_STEPS, micro, seed + 37, dev)
    arms = {}
    for fused in (False, True):
        _free()
        tree = _tree_on_card(cfg, seed + 3, dev, torch.float32)
        engine = dst.initialize(model=MoETransformerLM(cfg), config=dict(MOE_TRAIN, compile={"fuse_grad_accum": fused}),
                                model_parameters=tree)[0]
        del tree
        n_params = engine.num_parameters()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        rec, walls = _drive(engine, data, MOE_STEPS)
        r = dict(rec=rec, walls=walls, counts=_counts(), variants=_variants(), digest=_master_digest(engine),
                 graphs=engine.window_stats()["graphs"], peak_allocated=torch.cuda.max_memory_allocated())
        if not fused:
            r["moe_layers"] = _moe_stats(engine, data[0])
        arms["fused" if fused else "eager"] = r
        del engine
    eager, fused = arms["eager"], arms["fused"]
    bitwise = _same_rec(eager["rec"], fused["rec"]) and eager["digest"] == fused["digest"]
    want_eager = L * gas * MOE_STEPS
    want_fused = (fused["graphs"]["warmups"] + fused["graphs"]["captures"]) * L * gas
    fp32 = {}
    cfg32 = moe_llama_config("1b-8e", num_layers=MOE_TRAIN_LAYERS, max_seq_len=1024, remat=False, dtype="float32",
                             **MOE_CFG)
    config32 = {k: v for k, v in MOE_TRAIN.items() if k != "bf16"}
    for impl in (None, "plain"):
        _free()
        tree = _tree_on_card(cfg32, seed + 3, dev, torch.float32)
        engine = dst.initialize(model=MoETransformerLM(cfg32), config=config32, model_parameters=tree,
                                attn_impl=impl)[0]
        del tree
        rec, _ = _drive(engine, data, 1)
        fp32[impl or "kernel"] = rec[0]
        del engine
    _free()
    loss_rel = abs(fp32["kernel"][0] - fp32["plain"][0]) / abs(fp32["plain"][0])
    norm_rel = abs(fp32["kernel"][1] - fp32["plain"][1]) / abs(fp32["plain"][1])
    losses = [x[0] for x in fused["rec"]]
    rec = dict(phase="moe_train", model='moe_llama_config("1b-8e", moe_top_k=2)', layers=L, of_layers=22,
               params=n_params, config=MOE_TRAIN, steps=MOE_STEPS, bitwise=bitwise, losses=losses,
               grad_norms=[x[1] for x in fused["rec"]], step_ms=dict(eager=eager["walls"], fused=fused["walls"]),
               moe_layers=eager["moe_layers"], eager_launches=eager["counts"], fused_launches=fused["counts"],
               launches_want=dict(eager=want_eager, fused=want_fused), graphs=fused["graphs"],
               peak_allocated=dict(eager=eager["peak_allocated"], fused=fused["peak_allocated"]),
               fp32_step1=dict(kernel=fp32["kernel"], plain=fp32["plain"], loss_rel=loss_rel, norm_rel=norm_rel))
    emit(**rec)
    bad = []
    aux = [a for a, _ in eager["moe_layers"]]
    if not all(np.isfinite(losses)) or not all(np.isfinite(aux)) or len(aux) != L:
        bad.append(f"losses {losses} or load-balance losses {aux} not finite")
    if not bitwise:
        bad.append("captured steps not bitwise the eager ones")
    for arm, want in (("eager", want_eager), ("fused", want_fused)):
        c, v = arms[arm]["counts"], arms[arm]["variants"]
        if any(c[k] != want or v[f"{k}_tc"] != want for k in ("flash_fwd", "flash_dq", "flash_dkv")):
            bad.append(f"{arm} K1-K3 {c} want {want} on the tensor cores")
    if loss_rel > 1e-5 or norm_rel > 1e-5:
        bad.append(f"fp32 kernel vs plain: loss {loss_rel}, grad norm {norm_rel}")
    if bad:
        raise AssertionError(f"moe_train: {bad}")
    return rec


# --- phases 18a-18d: expert parallelism (M1's second half), two gloo ranks sharing the one card ---------
EP = 2
EP_LAYERS = 4  # of moe-llama 1b-8e's 22 in training (its width: 8 experts of 5376 a layer, 4 a rank)
EP_DEPTH = 8  # of its 22 in inference
EP_CF = 4.0  # the training capacity factor E / k: an expert's queue holds every token of a shard (no drops)
EP_TRAIN = dict(MOE_TRAIN, train_micro_batch_size_per_gpu=2)  # a rank's micro 2; one rank takes micro 4
EP_ROWS = 4  # the global micro batch: every rank passes it and takes its 2 rows
EP_STEPS, EP_DATA_STEPS, EP_INT8_STEPS = 3, 2, 1
EP_NEW = 32  # 18c's greedy tokens (224 + 32: a 256-position cache, JAX's condition for K6)
EP_REQUESTS = 8  # phase 3's first requests that 18d serves
EP_LIMIT_S = 720
EP_LOSS_TOL, EP_NORM_TOL = 1e-3, 1e-2  # bf16, two ranks against one: GEMMs over 2 x 1024 rows against 4 x 1024
EP_STEP_TOL = 0.5  # of one Adam step (lr): the master difference most elements must stay within
EP_LEAF_SHARE, EP_MASTER_SHARE = 0.12, 0.09  # of a leaf's / all elements past EP_STEP_TOL x lr: sound runs read
# 0.088 / 0.061, one expert left without its gradient 0.186 / 0.164 (tools/torch_ep_fault_probe.py)
EP_INT8_TOL = 2e-2  # the int8 wire's losses and norms against the fp wire's, relative
# 18a-18b and their one-rank run train without the load-balance loss: ep = 2 takes each token shard's (JAX's
# fast path), one rank the global batch's, so with it the two would be different functions
EP_AUX = 0.0
MOE_AUX = moe_llama_config("1b-8e").moe_aux_loss_coef  # the model's own: 18a's fp32 arm keeps it
EP_INFER = dict(MOE_CFG, eval_capacity_factor=4.0)  # 18c-18d: E / k, no drops, so a token shard's gate is the global
EP_FWD_TOL = 1e-4  # 18c's fp32 logits against one rank's, relative to their largest magnitude


def _ep_train_cfg(**kw):
    return moe_llama_config("1b-8e", num_layers=EP_LAYERS, max_seq_len=1024, remat=False, capacity_factor=EP_CF,
                            **{**MOE_CFG, "moe_aux_loss_coef": EP_AUX, **kw})


def _ep_engine(cfg, seed, dev, config, attn_impl=None):
    tree = _tree_on_card(cfg, seed + 3, dev, torch.float32)
    engine = dst.initialize(model=MoETransformerLM(cfg), config=config, model_parameters=tree, attn_impl=attn_impl)[0]
    del tree
    _free()
    return engine


def _ep_gaps(engine, ref_path):
    """Per leaf of this rank's master slices (its experts, its ZeRO blocks):
    elements, largest difference from the one-rank master's same slice and
    the share past ``EP_STEP_TOL`` Adam steps, on the card."""
    ref = _load_tree(ref_path)
    tol = EP_STEP_TOL * MOE_TRAIN["optimizer"]["params"]["lr"]
    out = {}
    for k, m in engine._master.items():
        whole = torch.from_numpy(np.array(ref[k])).to(m.device)
        d = (m - engine._own(k, whole, engine._mdim[k])).abs()
        out[k] = dict(n=d.numel(), max_abs=float(d.max()), share_past_tol=float((d > tol).float().mean()))
        del whole, d
    return out


def _ep_train_rank(seed, dev, ref_dir):
    """18a and 18b on this rank (see ``phase_ep``)."""
    out = {}
    cfg = _ep_train_cfg()
    gas = EP_TRAIN["gradient_accumulation_steps"]
    data = _step_data(cfg.vocab_size, cfg.max_seq_len, gas * EP_STEPS, EP_ROWS, seed + 43, dev)
    for name, kw, steps in (("fp", {}, EP_STEPS), ("int8", {"moe_quantized_a2a": True}, EP_INT8_STEPS)):
        torch.cuda.reset_peak_memory_stats()
        engine = _ep_engine(_ep_train_cfg(**kw), seed, dev, dict(EP_TRAIN, mesh={"expert": EP}))
        _zero_counts()
        rec, walls = _drive(engine, data, steps)
        out[name] = dict(rec=rec, step_ms=walls, counts=_counts(), variants=_variants(),
                         peak_allocated=torch.cuda.max_memory_allocated(),
                         a2a=(engine._a2a.a2a_axis, engine._a2a.a2a_world, engine._a2a.a2a_quantized),
                         local_experts=int(engine._params["layers/moe/experts/w_up"].shape[1]))
        if name == "fp":
            out[name]["gaps"] = _ep_gaps(engine, f"{ref_dir}/master{steps}")
        del engine
        _free()
    config32 = {k: v for k, v in EP_TRAIN.items() if k != "bf16"}
    fp32 = {}
    for impl in (None, "plain"):
        engine = _ep_engine(_ep_train_cfg(dtype="float32", moe_aux_loss_coef=MOE_AUX), seed, dev,
                            dict(config32, mesh={"expert": EP}), attn_impl=impl)
        fp32[impl or "kernel"] = _drive(engine, data, 1)[0][0]
        del engine
        _free()
    out["fp32"] = fp32
    engine = _ep_engine(cfg, seed, dev, dict(EP_TRAIN, mesh={"data": EP}))  # no expert axis: JAX's global gate
    _zero_counts()
    rec, walls = _drive(engine, data, EP_DATA_STEPS)
    out["data"] = dict(rec=rec, step_ms=walls, counts=_counts(), variants=_variants(),
                       gaps=_ep_gaps(engine, f"{ref_dir}/master{EP_DATA_STEPS}"))
    del engine
    _free()
    return out


def _ep_infer_rank(seed, dev, refs):
    """18c and 18d on this rank (see ``phase_ep``)."""
    from deepspeed_tpu_torch.utils import groups

    groups.initialize(ep_size=EP)
    out = {}
    cfg32 = moe_llama_config("1b-8e", num_layers=EP_DEPTH, dtype="float32", **EP_INFER)
    tree = _tree_on_card(cfg32, seed, dev, torch.float32)
    engine = dst.init_inference(MoETransformerLM(cfg32), dtype="fp32", paged_kv={"page_size": 16, "max_slots": 8})
    engine.load_jax_params(tree)
    out["local_experts"] = int(engine.module.layers["moe/experts/w_up"].shape[1])
    tok = torch.from_numpy(refs["tokens"]).to(dev)
    _zero_counts()
    logits = engine(tok)
    torch.cuda.synchronize()
    ref = torch.from_numpy(np.load(refs["logits_path"])).to(dev)
    out["forward"] = dict(max_abs=float((logits - ref).abs().max()), scale=float(ref.abs().max()),
                          shape=list(logits.shape), finite=bool(torch.isfinite(logits).all()), launches=_counts())
    del logits, ref
    _zero_counts()
    t0 = time.perf_counter()
    gen = engine.generate(refs["gen_prompts"], max_new_tokens=EP_NEW)
    torch.cuda.synchronize()
    out["generate"] = dict(wall_s=time.perf_counter() - t0, launches=_counts(), variants=_variants(),
                           streams=gen.cpu().numpy())
    _zero_counts()
    t0 = time.perf_counter()
    outs = engine.serve(refs["prompts"], max_new_tokens=refs["budgets"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = engine.serve_stats()
    out["serve"] = dict(wall_s=wall, tokens_per_s=sum(refs["budgets"]) / wall, ttft_ms=s["ttft_ms"], tpot_ms=s["tpot_ms"],
                        ragged_steps=s["ragged_steps"], finished=s["finished"], ep_degree=s["ep_degree"],
                        fingerprint=s["step_fingerprint"], launches=_counts(), variants=_variants(),
                        streams=[o.tolist() for o in outs])
    del engine
    _free()
    bf16 = dst.init_inference(MoETransformerLM(moe_llama_config("1b-8e", num_layers=EP_DEPTH, **EP_INFER)),
                              dtype="bf16")
    bf16.load_jax_params(tree)
    del tree
    _free()
    out["generate_bf16"] = bf16.generate(refs["gen_prompts"], max_new_tokens=EP_NEW).cpu().numpy()
    del bf16
    _free()
    return out


def _ep_rank(rank, store, result_path, work_args):
    """One spawned rank of phases 18a-18d (as ``_tp_rank``)."""
    import pickle
    import traceback

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dst.init_distributed("gloo", init_method=f"file://{store}", rank=rank, world_size=EP,
                             timeout=TP_PG_TIMEOUT_S)
        dev = torch.device("cuda", 0)
        t0 = time.perf_counter()
        res = dict(train=_ep_train_rank(work_args["seed"], dev, work_args["ref_dir"]))
        res["train_s"] = time.perf_counter() - t0
        res.update(infer=_ep_infer_rank(work_args["seed"], dev, work_args["refs"]))
        res["infer_s"] = time.perf_counter() - t0 - res["train_s"]
        dst.comm.barrier()
        dst.comm.destroy_process_group()
        payload = ("ok", res)
    except BaseException:  # the parent raises it
        payload = ("error", traceback.format_exc())
    with open(result_path, "wb") as f:
        pickle.dump(payload, f)


def _ep_train_ref(seed, dev, tmp):
    """18a-18b's one-rank bf16 run on the global batch (micro 4): its
    records, its master after 2 and 3 steps saved for the ranks to read."""
    cfg = _ep_train_cfg()
    gas = MOE_TRAIN["gradient_accumulation_steps"]
    data = _step_data(cfg.vocab_size, cfg.max_seq_len, gas * EP_STEPS, EP_ROWS, seed + 43, dev)
    engine = _ep_engine(cfg, seed, dev, MOE_TRAIN)
    it, rec = iter(data), []
    for step in range(1, EP_STEPS + 1):
        rec.append(_drive(engine, [next(it) for _ in range(gas)], 1)[0][0])
        if step in (EP_DATA_STEPS, EP_STEPS):
            _save_tree({k: v.detach().cpu().numpy() for k, v in engine._master.items()}, f"{tmp}/master{step}")
    del engine
    _free()
    return rec


def _ep_refs(seed, dev, tmp):
    """The one-rank references, made before the ranks start: 18a-18b's
    (``_ep_train_ref``), 18c's fp32 logits and greedy streams and bf16
    greedy streams, 18d's fp32 streams."""
    refs = {"train": _ep_train_ref(seed, dev, tmp)}
    cfg32 = moe_llama_config("1b-8e", num_layers=EP_DEPTH, dtype="float32", **EP_INFER)
    model = _moe_model(cfg32, seed, dev, torch.float32)
    engine = dst.init_inference(model, dtype="fp32", paged_kv={"page_size": 16, "max_slots": 8})
    rs = np.random.default_rng(seed + 19)
    tokens = rs.integers(0, cfg32.vocab_size, (2, 128), dtype=np.int64)
    np.save(f"{tmp}/logits.npy", engine(torch.from_numpy(tokens).to(dev)).cpu().numpy())
    gen_prompts = rs.integers(0, cfg32.vocab_size, (4, 224), dtype=np.int32)
    prompts, budgets = _requests(seed, cfg32.vocab_size)
    prompts, budgets = prompts[:EP_REQUESTS], budgets[:EP_REQUESTS]
    refs.update(tokens=tokens, logits_path=f"{tmp}/logits.npy", gen_prompts=gen_prompts, prompts=prompts,
                budgets=budgets, gen=engine.generate(gen_prompts, max_new_tokens=EP_NEW).cpu().numpy(),
                serve=[o.tolist() for o in engine.serve(prompts, max_new_tokens=budgets)], params32=model.param_tree())
    del engine
    bf16 = dst.init_inference(MoETransformerLM(moe_llama_config("1b-8e", num_layers=EP_DEPTH, **EP_INFER)),
                              dtype="bf16")
    bf16.load_jax_params(model.param_tree())
    refs["gen_bf16"] = bf16.generate(gen_prompts, max_new_tokens=EP_NEW).cpu().numpy()
    del bf16
    return refs, cfg32, model


def _ep_pooled(ranks, key):
    """The ranks' gaps of ``key`` joined: per leaf the largest difference
    and the share past tolerance over all its elements."""
    out = {}
    for k in ranks[0]["train"][key]["gaps"]:
        parts = [r["train"][key]["gaps"][k] for r in ranks]
        n = sum(p["n"] for p in parts)
        out[k] = dict(n=n, max_abs=max(p["max_abs"] for p in parts),
                      share_past_tol=sum(p["share_past_tol"] * p["n"] for p in parts) / n)
    return out


def _ep_rule(label, rec, ref_rec, gaps, bad):
    """The bf16 form of rule 12d: losses and grad norms within
    ``EP_LOSS_TOL`` / ``EP_NORM_TOL`` relative; the master held by share:
    each leaf's share of elements farther than ``EP_STEP_TOL`` Adam steps
    (lr) within ``EP_LEAF_SHARE``, all elements' within ``EP_MASTER_SHARE``
    (one of the 8 experts left unchanged moves an eighth of each expert
    leaf and a tenth of all elements past it). The largest difference is
    reported, not bounded: Adam moves an element at most about lr a step,
    so no bound on it could fail. A breach is appended to ``bad``."""
    lr = MOE_TRAIN["optimizer"]["params"]["lr"]
    n_all = sum(g["n"] for g in gaps.values())
    out = dict(loss_rel=max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(rec, ref_rec)),
               grad_norm_rel=max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(rec, ref_rec)),
               leaf_share_past_tol=max(g["share_past_tol"] for g in gaps.values()),
               master_share_past_tol=sum(g["share_past_tol"] * g["n"] for g in gaps.values()) / n_all,
               master_max_abs=max(g["max_abs"] for g in gaps.values()),
               worst_leaves=sorted(gaps, key=lambda k: -gaps[k]["share_past_tol"])[:3],
               bounds=dict(loss_rel=EP_LOSS_TOL, grad_norm_rel=EP_NORM_TOL, leaf_share=EP_LEAF_SHARE,
                           master_share=EP_MASTER_SHARE, past_abs=EP_STEP_TOL * lr))
    if out["loss_rel"] > EP_LOSS_TOL or out["grad_norm_rel"] > EP_NORM_TOL \
            or out["leaf_share_past_tol"] > EP_LEAF_SHARE or out["master_share_past_tol"] > EP_MASTER_SHARE:
        bad.append(f"{label} against one rank: {out}")
    return out


def phase_ep(seed, dev):
    """Phases 18a-18d: expert parallelism on two spawned gloo ranks that
    share the card (gloo takes CUDA tensors for the all-to-alls,
    all-reduces and all-gathers; NCCL refuses two ranks on one device): the
    sharded math and each rank's memory, not a speed. The model is
    ``moe_llama_config("1b-8e", moe_top_k=2)`` at full width (hidden 2048,
    8 experts of 5376, 33.0 M parameters an expert), its depth cut to 4
    layers for training and ``EP_DEPTH`` (8) for inference; the one-rank
    references are made first, in this process."""
    tmp = tempfile.mkdtemp(prefix="ep_smoke_", dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    try:
        t0 = time.perf_counter()
        refs, cfg32, model = _ep_refs(seed, dev, tmp)
        refs_s = time.perf_counter() - t0
        params32 = refs.pop("params32")
        work = dict(seed=seed, ref_dir=tmp, refs={k: v for k, v in refs.items()
                                                   if k in ("tokens", "logits_path", "gen_prompts", "prompts",
                                                            "budgets")})
        del model
        _free()
        t0 = time.perf_counter()
        ranks = _spawn_ranks(_ep_rank, EP, tmp, work, EP_LIMIT_S, "ep")
        ranks_s = time.perf_counter() - t0
        walls = dict(refs_s=refs_s, ranks_wall_s=ranks_s, rank_s=[dict(train=r["train_s"], infer=r["infer_s"])
                                                                  for r in ranks])
        emit(phase="ep_walls", **walls)
        out = _ep_checks(ranks, refs, cfg32, params32, dev)
        out.update(walls)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _ep_checks(ranks, refs, cfg32, params32, dev):
    """The records and verdicts of 18a-18d (see the module docstring)."""
    L, gas = EP_LAYERS, EP_TRAIN["gradient_accumulation_steps"]
    flash = ("flash_fwd", "flash_dq", "flash_dkv")
    out, bad = {}, []
    # 18a: ep = 2 against one rank, the int8 wire against the fp wire, fp32 kernels against plain
    fp = [r["train"]["fp"] for r in ranks]
    rule = _ep_rule("ep 18a", fp[0]["rec"], refs["train"], _ep_pooled(ranks, "fp"), bad)
    want = L * gas * EP_STEPS
    int8 = [r["train"]["int8"] for r in ranks]
    int8_rel = max(abs(a[i] - b[i]) / abs(b[i]) for q in int8 for a, b in zip(q["rec"], fp[0]["rec"]) for i in (0, 1))
    fp32 = ranks[0]["train"]["fp32"]
    loss_rel = abs(fp32["kernel"][0] - fp32["plain"][0]) / abs(fp32["plain"][0])
    norm_rel = abs(fp32["kernel"][1] - fp32["plain"][1]) / abs(fp32["plain"][1])
    rec = dict(phase="ep_train", model='moe_llama_config("1b-8e", moe_top_k=2)', layers=L, of_layers=22,
               capacity_factor=EP_CF, ranks=EP, backend="gloo", note="two gloo ranks on one card, not an EP speed",
               config=dict(EP_TRAIN, mesh={"expert": EP}), steps=EP_STEPS, losses=[x[0] for x in fp[0]["rec"]],
               grad_norms=[x[1] for x in fp[0]["rec"]], one_rank=refs["train"], rule=rule,
               step_ms=[f["step_ms"] for f in fp], peak_allocated=[f["peak_allocated"] for f in fp],
               local_experts=[f["local_experts"] for f in fp], a2a=fp[0]["a2a"],
               launches=[{k: f["counts"][k] for k in flash} for f in fp], launches_want=want,
               int8=dict(rec=int8[0]["rec"], max_rel_to_fp=int8_rel, bound=EP_INT8_TOL, a2a=int8[0]["a2a"]),
               fp32_step1=dict(kernel=fp32["kernel"], plain=fp32["plain"], loss_rel=loss_rel, norm_rel=norm_rel))
    emit(**rec)
    for i, f in enumerate(fp):
        if any(f["counts"][k] != want or f["variants"][f"{k}_tc"] != want for k in flash) \
                or sum(f["counts"].values()) != 3 * want:
            bad.append(f"rank {i} launches {f['counts']} want K1-K3 = {want} on the tensor cores")
        if f["rec"] != fp[0]["rec"] or f["local_experts"] != 8 // EP:
            bad.append(f"rank {i}: records {f['rec']} or {f['local_experts']} local experts")
    if not 0.0 < int8_rel <= EP_INT8_TOL or int8[0]["a2a"][2] is not True:
        bad.append(f"int8 wire: {int8_rel} from the fp wire (bound {EP_INT8_TOL}, must be nonzero)")
    if loss_rel != 0.0 or norm_rel > 1e-6:
        bad.append(f"fp32 kernel vs plain: loss {loss_rel}, grad norm {norm_rel}")
    out["train"] = rec
    # 18b: data = 2 without an expert axis (the global gate) against the same one-rank run
    data = [r["train"]["data"] for r in ranks]
    rule_b = _ep_rule("ep 18b", data[0]["rec"], refs["train"][:EP_DATA_STEPS], _ep_pooled(ranks, "data"), bad)
    want_b = L * gas * EP_DATA_STEPS
    rec = dict(phase="ep_data", mesh={"data": EP}, steps=EP_DATA_STEPS, losses=[x[0] for x in data[0]["rec"]],
               rule=rule_b, step_ms=[d["step_ms"] for d in data],
               launches=[{k: d["counts"][k] for k in flash} for d in data], launches_want=want_b)
    emit(**rec)
    if any(d["counts"][k] != want_b or d["variants"][f"{k}_tc"] != want_b for d in data for k in flash) \
            or any(d["rec"] != data[0]["rec"] for d in data):
        bad.append(f"ep_data: launches {[d['counts'] for d in data]} want {want_b}, or ranks differ")
    out["data"] = rec
    # 18c: forward and generate under the expert axis
    inf = [r["infer"] for r in ranks]
    gen_want = EP_DEPTH * EP_NEW
    partings = [int((g["generate_bf16"] != refs["gen_bf16"]).any(axis=1).sum()) for g in inf]
    rec = dict(phase="ep_generate", layers=EP_DEPTH, local_experts=[i["local_experts"] for i in inf],
               forward={k: inf[0]["forward"][k] for k in ("max_abs", "scale", "shape", "finite")},
               forward_max_abs=[i["forward"]["max_abs"] for i in inf],
               fp32_streams_equal=[bool(np.array_equal(i["generate"]["streams"], refs["gen"])) for i in inf],
               bf16_partings=partings, new_tokens=EP_NEW, batch=int(refs["gen_prompts"].shape[0]),
               wall_s=[i["generate"]["wall_s"] for i in inf],
               launches=[i["generate"]["launches"]["decode_attention"] for i in inf], launches_want=gen_want)
    emit(**rec)
    for i in inf:
        c, v = i["generate"]["launches"], i["generate"]["variants"]
        if c["decode_attention"] != gen_want or sum(c.values()) != gen_want or v["decode_split"] != gen_want:
            bad.append(f"generate launches {c} want K6 = {gen_want}")
        if not i["forward"]["finite"] or i["forward"]["max_abs"] > EP_FWD_TOL * i["forward"]["scale"] \
                or i["local_experts"] != 8 // EP:
            bad.append(f"forward logits {i['forward']} past {EP_FWD_TOL} of their scale, or the experts not split")
    if not all(rec["fp32_streams_equal"]):
        bad.append(f"fp32 streams part from ep = 1: {[p for p in _moe_partings(cfg32, params32, list(inf[0]['generate']['streams']), list(refs['gen']), dev)]}")
    out["generate"] = rec
    # 18d: ragged serving under the expert axis
    sv = [i["serve"] for i in inf]
    rec = dict(phase="ep_serve", requests=EP_REQUESTS, note="two gloo ranks on one card, not an EP speed",
               identical_to_ep1=[s["streams"] == refs["serve"] for s in sv],
               **{k: [s[k] for s in sv] for k in ("tpot_ms", "ttft_ms", "tokens_per_s", "wall_s", "ragged_steps",
                                                 "fingerprint")},
               launches=[s["launches"]["ragged_paged_attention"] for s in sv],
               launches_want=[EP_DEPTH * s["ragged_steps"] for s in sv])
    emit(**rec)
    if not all(rec["identical_to_ep1"]) or len(set(rec["fingerprint"])) != 1 \
            or any(s["launches"]["ragged_paged_attention"] != EP_DEPTH * s["ragged_steps"] or s["ragged_steps"] == 0
                   or sum(s["launches"].values()) != s["launches"]["ragged_paged_attention"]
                   or s["variants"]["ragged_split"] != s["launches"]["ragged_paged_attention"]
                   or s["finished"] != EP_REQUESTS or s["ep_degree"] != EP for s in sv):
        bad.append(f"ep_serve: {rec}")
    out["serve"] = rec
    if bad:
        raise AssertionError(f"phases 18a-18d: {bad}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 1: the card and the kernel build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    sources = ["ragged_paged_attention", "decode_attention", "flash_attention", "block_sparse_attention"]
    libs = native.build_many(sources)  # one nvcc per source, all started together
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
         builds={name: dict(library=lib.split("/")[-1], nvcc_s=native.build_log.get(name, {}).get("seconds"),
                            ptxas=[line.strip() for line in native.build_log.get(name, {}).get("ptxas", "").splitlines()
                                   if "Used" in line or "spill" in line])
                 for name, lib in zip(sources, libs)})

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > the 50 MB L2
    cases = phase_kernel(dev, flush)
    del flush

    cfg = llama_config("1b")
    t0 = time.perf_counter()
    tree = _weights_on_card(cfg, args.seed, dev)  # llama-1B's serving tree (~19 s of numpy normals otherwise)
    emit(phase="serve", event="weights_made", seconds=time.perf_counter() - t0)
    launches, split_launches, serve_streams = phase_serve(cfg, tree, args.seed)
    phase_streams(llama_config("1b", dtype="float32"), tree, args.seed, dev)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    k6_cases = phase_decode_kernel(dev, flush)
    k5_cases = phase_paged_kernel(dev, flush)
    del flush
    k6_launches, k6_split_launches = phase_generate(cfg, tree, args.seed)
    k5_launches, k5_split_launches = phase_bucketed(cfg, tree, args.seed)
    fp32 = phase_three_way(llama_config("1b", dtype="float32"), tree, args.seed, dev)
    windows, steady, steady_ref = phase_windows(cfg, tree, args.seed, serve_streams)
    spec = phase_spec(cfg, tree, args.seed, serve_streams, steady, steady_ref, dev)
    recovery = phase_recovery(cfg, tree, args.seed, serve_streams)
    int8 = phase_int8(cfg, tree, args.seed, serve_streams, steady, steady_ref, dev)
    traffic = phase_traffic(cfg, tree, args.seed, serve_streams, dev)
    fleet = phase_fleet(cfg, tree, args.seed, dev)
    tp = phase_tp(cfg, tree, args.seed, dev)
    yard = phase_host_ops(dev)  # before any offload phase: the host libraries' builds are this process's own
    zero_inf = phase_zero_inference(dev, yard, tree)
    del tree

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    flash = phase_flash(dev, flush)
    del flush
    train_counts, train_variants = phase_train(args.seed, dev)
    fp32_rec, fp32_masters = phase_train_fp32(args.seed, dev)
    ckpt = phase_train_checkpoint(args.seed, dev)
    zero1 = phase_zero3_one_rank(args.seed, dev)
    zero = phase_zero(args.seed, dev, fp32_rec, fp32_masters)
    zero_grad = _zero_grad_leaves(fp32_masters["grad_max"])
    del fp32_masters
    gpt2_tree = _weights(gpt2_config("125m", max_seq_len=1024, remat=False), args.seed)  # fp32 and bf16 alike
    streamed = phase_offload_streamed(dev, yard, gpt2_tree)
    host_adam = phase_offload_host_adam(dev, zero_grad, gpt2_tree)
    param = phase_offload_param(dev, zero_grad, gpt2_tree)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    d80 = phase_flash_d80(dev, flush)
    del flush
    fused = phase_train_fused(args.seed, dev, gpt2_tree)
    window = phase_train_window(args.seed, dev, gpt2_tree)
    t5_kernels = phase_t5_kernels(dev)
    t5 = phase_t5_train(args.seed, dev, gpt2_tree)
    t5_resume = phase_t5_resume(args.seed, dev, gpt2_tree)
    del gpt2_tree
    big = phase_train_2p7b(args.seed, dev)
    shapes = phase_train_shapes(args.seed, dev)
    moe_serve = phase_moe_serve(args.seed, dev)
    moe_train = phase_moe_train(args.seed, dev)
    ep = phase_ep(args.seed, dev)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    sparse = phase_sparse_kernels(dev, flush)
    del flush
    sparse_counts, sparse_variants = phase_sparse_train(args.seed, dev)

    main_case = next(c for c in cases if c["case"] == "W=1 bfloat16")
    k6_main = next(c for c in k6_cases if c["case"] == f"{DECODE_MAIN} bfloat16")
    k5_main = next(c for c in k5_cases if c["case"] == "bucket 8 W=1 bfloat16")
    keys = ("case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit(kernels=[dict(
        name="ragged_paged_attention", route="cuda",
        source="deepspeed_tpu_torch/csrc/ragged_paged_attention.cu",
        replaces="deepspeed_tpu/ops/transformer/decode_attention.py:209",
        launches=launches, max_abs_err=main_case["max_abs_err"], ms=main_case["ms"],
        plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"], case=main_case["case"], variant="split_kv",
        split_launches=split_launches, splits=main_case["splits"], windows=windows,
        spec=dict(verify_case={c["case"]: {k: c[k] for k in keys[1:] + ("splits", "bitwise_equal")}
                               for c in cases if c["case"].startswith("W=5 verify")},
                  bf16=spec, fp32=fp32["spec"]),
        recovery=dict(bf16=recovery, fp32={k: fp32["recovery"][k] for k in ("recovered", "identical", "launches")}),
        int8=dict(serve=int8["serve"], logits_relative=int8["logits_relative"], steady=int8["steady"],
                  fp32={k: int8["fp32"][k] for k in ("k4", "identical_plain")}),
        traffic=traffic, fleet=fleet, tp=tp["kernels"]["ragged_paged_attention"],
        expert_parallel=dict(serve=ep["serve"]["launches"], want=ep["serve"]["launches_want"],
                             note="18d, each rank's launches, two gloo ranks on one card"),
        moe=dict(ragged=moe_serve["ragged"]["launches"]["ragged_paged_attention"],
                 ragged_steps=moe_serve["ragged"]["steps"], fp32=moe_serve["fp32"]["k4"],
                 steady=[{k: r[k] for k in ("mode", "k4_counter", "window_steps")} for r in moe_serve["steady"]]),
        cases=[{k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "splits", "bitwise_equal")} for c in cases],
    )] + [dict(
        name=name, route="cuda", source="deepspeed_tpu_torch/csrc/flash_attention.cu",
        replaces=f"deepspeed_tpu/ops/transformer/flash_attention.py:{line}",
        launches=train_counts[name],
        max_abs_err=flash["bfloat16"]["errors"][name]["max_abs_err"],
        case=f"{FLASH_MAIN} bfloat16",
        **{k: flash["bfloat16"]["timing"][name][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_share")},
        fp32={k: flash["float32"]["timing"][name][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        variant={"bfloat16": "tensor_core", "float16": "tensor_core", "float32": "fma"},
        tensor_core_launches=train_variants[f"{name}_tc"],
        fp16={k: flash["float16"]["timing"][name][k] for k in ("ms", "bound_ms", "library_ms")},
        **({"tp": tp["kernels"]["flash_fwd"]} if name == "flash_fwd" else {}),
        d80={dt: dict(max_abs_err=r["errors"][name]["max_abs_err"], rel_err=r["errors"][name]["rel_err"],
                      **{k: r["timing"][name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                      case=r["case"], variant=r["variant"]) for dt, r in d80.items()},
        fused=_fused_field(name, fused, window, big, shapes),
        data_pipeline=dict(
            new_lengths={case: errs[name] for case, errs in t5_kernels.items()},
            runs={run: dict(counter=r["counts"][name], tensor_core=r["variants"][f"{name}_tc"],
                            want=r["launches_want"], graphs=r["graphs"]) for run, r in t5.items() if run != "pld_eager"},
            pld_eager=dict(counter=t5["pld_eager"]["counts"][name], kept_layers=t5["pld_eager"]["kept_layers"]),
            resume_bitwise=t5_resume["bitwise"]),
        moe=dict(eager=moe_train["eager_launches"][name], captured_counter=moe_train["fused_launches"][name],
                 want=moe_train["launches_want"], layers=moe_train["layers"]),
        expert_parallel=dict(train=[c[name] for c in ep["train"]["launches"]], want=ep["train"]["launches_want"],
                             data=[c[name] for c in ep["data"]["launches"]], data_want=ep["data"]["launches_want"],
                             note="18a and 18b, each rank's launches, two gloo ranks on one card"),
        checkpoint=dict(launches=ckpt["launches"][name], steps=ckpt["steps"]),
        zero=dict(fp32={st: r["launches_per_rank"] for st, r in zero["fp32"].items()},
                  bf16={st: r["launches_per_rank"][name] for st, r in zero["bf16"].items()},
                  steps_per_run=ZERO_STEPS, bf16_steps_per_run=ZERO_BF16_STEPS,
                  one_rank_stage3_bit_identical=zero1["bit_identical"],
                  note="two gloo ranks on one card"),
        offload=dict(
            streamed={dt: r["launches"][name] for dt, r in streamed.items()}, streamed_steps=OFFLOAD_STEPS,
            host_adam={d: c[name] for d, c in host_adam["launches"].items()},
            param={d: c[name] for d, c in param["launches"].items()}, param_bf16=param["bf16"]["launches"][name],
            param_bf16_tensor_core=param["bf16"]["tensor_core"][f"{name}_tc"], steps=ZERO_STEPS,
            ranks={n: [c[name] for c in per_rank] for n, per_rank in zero["offload"]["launches"].items()},
            **({"zero_inference": {dt: dict(forward=r["forward_launches"][name], generate=r["generate_launches"][name],
                                            new_tokens=ZI_NEW) for dt, r in zero_inf.items() if dt != "nvme"}}
               if name == "flash_fwd" else {})),
    ) for name, line in (("flash_fwd", 63), ("flash_dq", 165), ("flash_dkv", 196))] + [dict(
        name="decode_attention", route="cuda", source="deepspeed_tpu_torch/csrc/decode_attention.cu",
        replaces="deepspeed_tpu/ops/transformer/decode_attention.py:42", launches=k6_launches,
        **{k: k6_main[k] for k in keys}, variant="split_kv", split_launches=k6_split_launches,
        splits=k6_main["splits"], cases=[{k: c[k] for k in keys + ("splits", "bitwise_equal")} for c in k6_cases],
        quant_enabled=int8["quant"], tp=tp["kernels"]["decode_attention"],
        moe=dict(generate=moe_serve["generate"]["launches"]["decode_attention"],
                 new_tokens=moe_serve["generate"]["new_tokens"]),
        expert_parallel=dict(generate=ep["generate"]["launches"], want=ep["generate"]["launches_want"],
                             note="18c, each rank's launches, two gloo ranks on one card"),
        checkpoint=dict(launches=ckpt["k6_launches"]),
    ), dict(
        name="paged_decode_attention", route="cuda", source="deepspeed_tpu_torch/csrc/decode_attention.cu",
        replaces="deepspeed_tpu/ops/transformer/decode_attention.py:110", launches=k5_launches,
        **{k: k5_main[k] for k in keys}, variant="split_kv", split_launches=k5_split_launches,
        splits=k5_main["splits"], cases=[{k: c[k] for k in keys + ("splits", "bitwise_equal")} for c in k5_cases],
        int8_fp32=dict(launches=int8["fp32"]["k5"], identical_to_k4=int8["fp32"]["identical_bucketed"]),
        moe=dict(bucketed=moe_serve["bucketed"]["launches"]["paged_decode_attention"],
                 decode_steps=moe_serve["bucketed"]["steps"]),
    )] + [dict(
        name=name, route="cuda", source="deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
        replaces=f"deepspeed_tpu/ops/sparse_attention/pallas_block_sparse.py:{line}",
        launches=sparse_counts[name],
        max_abs_err=sparse[(SPARSE_MAIN, "bfloat16")]["errors"][name]["max_abs_err"],
        case=f"{SPARSE_MAIN} bfloat16",
        **{k: sparse[(SPARSE_MAIN, "bfloat16")]["timing"][name][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_share")},
        fp32={k: sparse[(SPARSE_MAIN, "float32")]["timing"][name][k]
              for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        bench={dt: {k: sparse[(SPARSE_BENCH, dt)]["timing"][name][k]
                    for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_share")}
               for dt in ("bfloat16", "float32")},
        variant={"bfloat16": "tensor_core", "float16": "tensor_core", "float32": "fma"},
        tensor_core_launches=sparse_variants[f"{name}_tc"],
        **(dict(fp16={k: sparse[(SPARSE_MAIN, "float16")]["timing"][name][k] for k in ("ms", "bound_ms", "library_ms")},
                bench_fp16={k: sparse[(SPARSE_BENCH, "float16")]["timing"][name][k]
                            for k in ("ms", "bound_ms", "library_ms")})
           if name in ("block_sparse_fwd", "block_sparse_dq") else {}),
    ) for name, line in (("block_sparse_fwd", 78), ("block_sparse_dq", 163), ("block_sparse_dkv", 194))])
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

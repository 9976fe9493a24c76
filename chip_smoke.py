#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` (``/usr/local/cuda``) and the
repository's ``src/``; without a card it exits non-zero at once.

Stages (any failure raises and exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, all in parallel); print
   each kernel's registers and spills, and hold decode attention's and
   the grouped FFN's wgmma instantiations to 0 bytes spilled;

DeepSeek-V3 (MLA + top-8 MoE):

3. hold each MoE kernel against its plain PyTorch version on the card at
   the main path's shapes (DeepSeek-V3 width, top-8 of 256 experts,
   capacity 4; the token counts T the path packs: decode T=4, the
   prompts' padded prefill buckets 32 and 64, and the unpadded 37-token
   prompt): route-pack exactly (bf16, spread and hot routing, with and
   without INT8 quantize and expert ids, with masked rows, and with the
   EPLB Collect count block — logical ids counted, int32 dest without a
   placement and the router's int64 ids with one, counts equal to
   ``collect_ref`` — over the 256 experts and the EPLB table's 258
   slots; and on padding rows, payload rows off the 16-byte vector, a
   capacity past 256 slots and a call with no rows, counting ids with -1
   and ids >= E mixed in), the standalone Collect kernel exactly at every
   N = T·8 (routed int64 ids, and int32 ids with -1 and ids >= E mixed
   in), the grouped expert FFN within 3e-2 (bf16), and the owner-indexed
   FFN within 3e-2 of its plain version and bit-identical to the plain
   kernel on owner-gathered weights over the 258 slots; every gmm call
   also has its device-side live rows equal to ``live_rows``, a second
   call bit-identical and every all-zero bucket row +0, and gmm is also
   held on an all-empty call (all +0), one live slot, partly filled rows
   and in float32 (2e-4, 16 experts' weights); route-pack must be one
   device kernel per call under the profiler, with no memset or fill
   beside it, with and without the count block, its device time with the
   block within 10% of its time without (in turn in one profiler window)
   and its event time below route-pack + the standalone Collect's (in
   turn); time kernel (CUDA events, median of 20 after warm-up, and
   device time under the profiler), plain version and one PyTorch
   library call, gmm also on one live slot
   and at the largest T of each capacity, each beside its live-slot
   count, its bound, its dense-walk bound, the library call's device
   time and ``kernel.plan``'s variant, whose kernel the profiler must
   name; and held and timed off the path at a 512-token chunk (C 20);
4. serve full-width DeepSeek-V3 cut to 4 layers (3 dense + 1 MoE, and
   its MTP head; random bf16 weights made on the card from a seed)
   through the port's
   ``FlowServeEngine`` (2 DP groups × 4 slots): 4 prompts × 16 greedy
   tokens, then a skewed EPLB pass, then 4 more prompts; every kernel's
   launch count over this stage must be above 0 (route-pack, gmm,
   placement_gmm), the owner-indexed FFN must run after EPLB, and EPLB
   Collect must have run inside every route-pack launch (68 of them, one
   per MoE layer call) and never on its own; the first route-pack of
   each shape the path makes is replayed on the kernel and the plain
   version, exactly, its counts equal to ``collect_ref`` on its logical
   ids, with and without a placement; then profile full-batch decode steps
   (host clock per engine step, device time by kernel with
   ``torch.profiler``, and the device's idle share within the same
   profiled steps), and run one full-batch decode step of a DP group
   twice from copies of one cache with the same inputs: the logits must
   be bit-identical (the MoE combine sums in a fixed order);
5. the INT8 path of §4.7 on that engine before it is freed, with the
   launch counts set to 0 just before it and read just after: on layer
   0's full-width ``wq_a``, ``wkv_a``, ``wq_b`` (as [1536, 24576]), the
   dense MLP's ``wi_gate`` and ``wo`` and one routed expert's
   ``we_gate``, with the path's own tokens' rms-normed embeddings (their
   q latent for ``wq_b``, their SwiGLU for ``wo``) as activations and
   calibration set: SmoothQuant, channel-wise weights (stored K-major),
   the W8A8 linear (quant-dispatch + INT8-matmul kernels) at M 4, 37, 64
   and 512, naive and smoothed, each bit-identical to the plain path,
   with its error against the bf16 product logged; GPTQ of ``wkv_a`` in
   float64 on the card (timed, error against naive rounding); the served
   MLA caches quantized. Then quant-dispatch bit-identical at every
   input, a zero row, .5 quotients, (7, 32), (5, 1000), the ragged
   (4, 7170), an unaligned (4, 7168) and all-zero rows (+0 and -0) on
   the cluster and block paths; INT8 matmul on K-major
   weights at (100,300,50), (1,64,17), (37,1000,300), (130,136,257) (K
   not a multiple of 16 but at (1,64,17)) and on a weight 1 byte off a
   16-byte boundary; the caches bit-identical; and both kernels timed
   (quant-dispatch at widths 1536, 7168 and 18432 x M 4, 37, 64 and 512
   in bf16 and f32 and on the MLA cache rows, each bit-identical, one
   device kernel per call, beside its plan and bound, and at M 4 called
   in turn with the two-pass launch of the same function — the plan's
   scalar path, a block per row — which it must beat on the device, and
   with the one of one block a row and a cluster of blocks that the plan
   did not pick; INT8 matmul on ``wi_gate`` at every M, one
   device kernel per call, its share of the int8 peak logged, and called
   in turn with ``torch._int_mm`` + the same epilogue on the same K-major
   weight where that takes the shape (M > 16): the kernel must be faster
   at M 512);
A. the prefix-KV trio on that engine's first DP group (radix-cache
   seeding, §4.2), launch counts set to 0 just before and read just
   after: a 129-token chat turn prefilled cold in chunks ending at 32
   and 64, its four block payloads, their ``read_remote_kv`` copies and
   the seeded cache's first 64 positions bit-identical copies (fresh
   storage); the suffix chunk run on the seeded cache gives the cold
   run's logits and valid-region KV bit for bit (bf16); against a cold
   prefill of the whole turn in one chunk (another split: MoE capacity
   is set per call from the chunk's token count, and cuBLAS picks its
   kernel by the row count) the logit error and how many greedy tokens
   agree are reported; ``_cache_insert`` and ``seed_prefill_cache``
   timed per block (host clock and device), ``read_remote_kv`` as a
   device-to-device copy (GB/s, and its HBM traffic's share of
   3.35 TB/s);
B. disaggregated Prefill-Decode (§5.1, ``DisaggregatedPD``) on that
   engine's weights: 2 prefill TEs x 2 DP groups and 1 decode TE x 2,
   4 slots each, ``max_len`` 256, 32-token chunks, the pod-pooled
   prefix directory on; chat sessions sharing a 64-byte system prompt
   and a long unrelated prompt, in three waves, 16 greedy tokens each,
   launch counts set to 0 just before and read just after: local hits,
   remote (pod-directory) hits and skipped chunks must each occur; KV
   streamed in at least 2 chunks, no stream left open; the KV each
   decode group admits bit-identical to the prefill group's final cache
   over the prompt; every pin released exactly once; route-pack and gmm
   launched on both sides. TTFT and TPOT (host clock), peak memory, and
   the follow-up turn's prefill device time cold against seeded, beside
   the cold split's chunks up to the seed (stage P's ``hit_skip``). Then
   with ``kv_pool=False`` against the colocated ``FlowServeEngine``
   (same chunks and slots) on prompts that share no block: the same
   greedy tokens (decode at B 4 with capacity 4 drops nothing);
6. MTP speculative decoding (§4.6) on that engine's weights, with its
   MTP head (a [14336, 7168] projection and one MLA + dense-MLP block,
   0.69 B parameters): a ``FlowServeEngine`` with ``mtp_k`` 1, then 2,
   serves the plain path's prompts with the same EPLB pass, and every
   request's tokens must equal the plain engine's for the same prompt
   seeded alike (a prompt served again is seeded from the radix cache
   when it lands on a DP group that holds it, which at full width is
   another function than its cold prefill: the plain tokens come from
   the path and from a plain engine of one DP group that serves each
   prompt twice, keyed by prompt and prefix hit); every iteration of
   every DP group must launch route-pack (with Collect's count block),
   and gmm before EPLB or placement_gmm after it, ``k + 1`` times per MoE
   layer and nothing else, call ``_logits`` ``2k + 1`` times and never in
   the draft-cache fill pass; 4 requests at temperature 0.7 (the
   residual and bonus draws); the second wave again with an oracle head
   (its logits peaked at the token the plain engine emitted next: every
   draft accepted, as a well-trained head's would be) and once more with
   one of its drafts per request wrong (a rejection mid-block, junk left
   in both caches), the tokens unchanged each time; one rolled-back
   iteration (``inject_fault``)
   at a full batch of greedy and sampled slots must give the fault-free
   iteration's blocks and accepted counts; then the acceptance rate,
   tokens per iteration, TPOT per emitted token (host clock; and at the
   oracle's full acceptance), one DP
   group's device time per iteration split into draft chain, verify
   chain and fill pass beside the plain ``decode_sample`` from the same
   state (``torch.profiler``), and a decode profile of the engine, each
   printed beside the plain path's;
E. disaggregated MoE-Attention (§5.2, ``DisaggregatedMoEAttention``)
   on that engine's weights and EPLB table, at B 96 from a cache the
   port prefilled with prompts of 16-200 random tokens (ragged
   positions): microbatches 1 and 2 x the INT8 wire format off and on x
   no placement and the engine's table, 16 decode steps each, teacher-
   forced by ``Model(decode_microbatches=m)``'s greedy tokens at the
   model's capacity factor (so the buckets are equal), launch counts set
   to 0 just before the disaggregated runs and read just after, each
   ``decode_step`` under ``torch.cuda.set_sync_debug_mode("error")``:
   the slots each step writes bit-identical to the monolithic step's
   and the whole cache after the last step too (the only MoE layer is
   the last one, so the KV never depends on an FFN's add order); logits
   within 0.05 relative; the first step twice from one cache
   bit-identical; 16 steps run free, their greedy agreement reported
   beside the dropped assignments per step and the INT8 wire's logit
   error; route-pack (with and without its quantize branch), gmm and
   placement_gmm launched, Collect not; each variant's first pack and
   grouped FFN replayed on the plain versions (exact, 3e-2); one MoE
   layer's stages timed at microbatches 2 (attention half, pack, expert
   half, unpack and combine) into a ``StageTimes`` fed to the Fig. 19
   pipeline of the full model on 768 dies (labelled modeled); one
   disaggregated and one monolithic step's device time, and the
   disaggregated step's device idle share under the profiler;
7. check the output by the repository's own means: every request
   finished with its tokens, the logits are finite, and on the smoke
   DeepSeek-V3 (float32) the engine on the card gives the same greedy
   tokens as the engine on the CPU with the plain versions, before and
   after EPLB, and with its MTP head at ``mtp_k`` 2 the same tokens and,
   iteration by iteration, the CPU's blocks and accepted counts (with a
   wave under the oracle head, so full and partial blocks are among
   them); and the smoke DeepSeek-V3 through ``DisaggregatedPD`` with
   the pod directory (C) on the card and on the CPU: the same TE
   choices, hits, skipped chunks, streams and greedy tokens; and
   through ``DisaggregatedMoEAttention`` (F) in stage E's eight
   configurations (an EPLB table of six slots), 8 free-running greedy
   tokens on 6 ragged slots, equal on the card and the CPU;
G. the port's launcher (``repro_torch.launch.serve.main``) in-process
   on the card: ``--arch deepseek-v3-671b`` and no other flag (the smoke
   config, 16 greedy tokens), then both modes on the smoke DeepSeek-V3
   in float32, its weights made from the seed on either device (the
   same weights): the printed lines and the token ids behind them equal
   the CPU's;

Llama-4 Maverick (GQA + top-1 MoE with a shared expert), after the
DeepSeek-V3 engine is freed:

8. make full-width Llama-4 cut to 2 layers (one dense GQA+MLP layer, one
   GQA+MoE layer; random bf16 weights made on the card from a seed) in
   a ``FlowServeEngine`` (2 DP groups x 4 slots, ``max_len`` 1024,
   512-token prefill chunks);
9. hold the kernels against their plain versions at Llama-4's shapes:
   the MoE kernels and Collect as in stage 3, at top-1 of 128 experts
   and 130 slots, on the engine's own MoE weights, at every capacity
   the path's packs have (4 at decode, 5 for a 512-token chunk, 8 for
   the 826-token prompt: one tensor-core row tile each), timed as in
   stage 3; decode attention in bf16 (3e-2) and float32 (2e-4), both as
   an absolute error and scaled by each output row's size (min(1,
   max |want|)), at the path's shape (B 4, H 40, KV 8, hd 128, L 1024,
   positions 0 and L-1 among them), at a ragged L, in ring-window mode
   (rows past and before their first wrap), at G = 1 and G = 8, on a
   strided cache view, at head sizes 64 and 32 and with peaked scores,
   each also with every slot its rows do not attend to NaN-filled (a
   stale tail: the output must not change beyond the bar) and repeated
   bit-identically; timed (``scaled_dot_product_attention`` is its
   library call, the two called in turn) at the path's shape, at
   L 8192, 32768 and 131072 and on a ragged batch at L 32768 (positions
   L-1, L/2, 100, 0), each beside its bound from the slots the data
   needs; one call must be one launch under the profiler, no slower
   than SDPA at L 1024, 8192 and 32768, and at L 32768 within 2x the
   bound on the device;
10. serve 4 prompts x 16 greedy tokens (one of 825 bytes, prefilled in
   two 512-token chunks), a skewed EPLB pass on the MoE layer, 4 more
   prompts; every kernel of the path launches, Collect inside each of
   the 70 route-packs and never alone, the path's first pack of each
   shape is replayed exactly with its counts, the logits are
   finite; profile decode steps and repeat a decode step as for
   DeepSeek-V3;
11. the INT8 KV cache on that engine, launch counts set to 0 just
    before and read just after: every layer's k/v of both DP groups
    quantized per (position, head) through quant-dispatch, bit-identical
    to the plain version; INT8 attention scores at the path's shape (one
    query row per KV head, [4, 8, 128] against [4, 1024, 8, 128]) equal
    on the card and the CPU; quant-dispatch timed on the cache rows
    [32768, 128] and on each head's whole cache as a row [32, 131072];
D. prefix seeding on that engine, launch counts set to 0 just before
   and read just after: the 826-token prompt served alone, then twice
   with another 10-token tail (the second timed with its shapes warm):
   816 tokens (51 blocks) seeded, the first 512-token chunk skipped and
   only (816, 826) prefilled, and the slot decodes through decode
   attention; on the backend, the same split
   (0, 512), (512, 816), (816, 826) against a seed from its payloads:
   logits and valid-region KV bit-identical;
E. (Llama-4) stage E on that engine's weights and EPLB table (130
   slots), ``max_len`` 1024, B 96: its GQA layers' decode attention
   launched from the attention half, and replayed on the plain version;
12. the smoke Llama-4 with G = 5 (float32): the engine on the card gives
    the CPU's greedy tokens, before and after EPLB;

RecurrentGemma-2B and Mamba2-130M (the recurrent and hybrid families),
after the Llama-4 engine is freed:

H. decode attention at RecurrentGemma-2B's local-attention shape (B 4,
   10 query heads on one KV head, hd 256, a ring of L = window 2048;
   three head groups of 4, 4 and 2 heads a block) against its plain
   version in bf16 (3e-2) and float32 (2e-4), absolute and scaled by
   each row: positions below the window, at 2047, wrapped (2048, 3000,
   4095), ragged, at L 2000 and at B 8, each also with the slots its
   rows do not see NaN-filled and repeated bit-identically; one launch
   per call under the profiler; timed at B 4 and B 8 with every slot
   valid (CUDA events in turn with ``scaled_dot_product_attention`` and
   the ring mask, profiler device time) beside the bytes bound and the
   plain version, and at 1, 2 and 3 head groups on the same K/V;
I. RecurrentGemma-2B at full width and depth (26 layers: 8 superblocks
   of RG-LRU, RG-LRU, ring-window attention, then a 2-layer RG-LRU
   tail; random bf16 weights from a seed) through ``FlowServeEngine``
   (2 DP groups x 4 slots, ``max_len`` 4096, greedy): prompts of 16,
   57, 130, 200, 2048 (its first decode wraps to ring slot 0) and 3000
   tokens (bucket 4096: blockwise attention and the ring-slot layout),
   64 tokens each, every prefill buffered; launch counts set to 0 just
   before and read just after: decode attention exactly 8 local layers
   x each DP group's decode steps, and no other kernel. TTFT and TPOT
   by prompt length (host clock), peak memory, a decode profile (device
   busy per engine step, idle share, top kernels), a decode step run
   twice bit-identically, one under ``no_host_sync``, and 16 decode
   steps from an unpadded 2040-token prefill (across the wrap) against
   the padded prefill at their positions, within 0.08 relative;
J. Mamba2-130M at full width and depth (24 SSD layers) the same way
   (decode against prefill from 200 tokens): no kernel launches at all;
K. the smoke RecurrentGemma (5 layers: a superblock and the tail) and
   Mamba-2 in float32: the engine on the card gives the CPU's greedy
   tokens;

Llama-3.2-Vision-11B and SeamlessM4T-medium (cross-attention, the
encoder and VLM memory), after the hybrid engines are freed:

L. decode attention at the memory paths' shapes (B 4): each model's
   cross-attention over its memory (Llama-3.2-Vision: 32 query heads on
   8 KV heads of 128, L 1601; SeamlessM4T: 16 on 16 of 64, L 512) and
   its self-attention over 256 slots, against the plain version in bf16
   (3e-2) and float32 (2e-4), absolute and scaled by each row: every
   slot attended, a short memory's zero pads among them, a layer's view
   of a stacked cache, ragged self-attention positions, the slots a row
   does not see NaN-filled; each check one launch under the profiler
   and repeated bit-identically; timed in bf16 with every slot valid
   (CUDA events in turn with ``scaled_dot_product_attention``, profiler
   device time) beside the bytes bound and the plain version;
M. Llama-3.2-Vision-11B at full width and depth (40 layers: 8
   superblocks of 4 GQA layers and a cross-attention layer; 9.78 B
   random bf16 parameters from a seed) through
   ``FlowServeEngine(memory=)``, the memory [1, 1601, 4096] bf16 patch
   embeddings made on the card from a seeded generator (the stubbed
   vision frontend): 2 DP groups x 4 slots, ``max_len`` 256, prompts
   of 8-200 random tokens x 16 greedy tokens, every prefill buffered;
   launch counts set to 0 just before and read just after: decode
   attention exactly 40 layers x each DP group's decode steps, and no
   other kernel. TTFT, TPOT, peak memory, a decode profile, a decode
   step run twice bit-identically and one under ``no_host_sync``, and
   16 decode steps from an unpadded 200-token prefill against the
   padded prefill, within 0.08 relative;
N. SeamlessM4T-medium at full width and depth (12 encoder layers on
   [1, 512, 1024] frames, 24 decoder blocks: 12 self-attention and 12
   cross-attention + MLP) the same way: decode attention exactly 24 x
   the decode steps;
O. the smoke Llama-3.2-Vision with G = 4 (8 query heads on 2 KV heads)
   and the smoke SeamlessM4T in float32, served a memory made on the
   CPU from a seed: the engine on the card gives the CPU's greedy
   tokens;

Dense and long-context serving, after the memory engines are freed:

V. InternLM2-1.8B (24 layers, G 2), Granite-8B (12 of 36, G 4),
   Command-R-35B (8 of 40 layers, G 8, the tied head), DeepSeek-MoE-16B
   (10 of 28: MHA, a dense layer, 9 MoE layers of 64 experts top-6 with
   shared experts) and Mistral-NeMo-12B (40, G 4) at full width, random
   bf16 weights from a seed, through ``FlowServeEngine`` with 512-token
   chunked prefill: 2 DP groups x 4 slots of 1024 and prompts of 16-900
   random tokens x 16 greedy tokens (DeepSeek-MoE-16B: a skewed EPLB
   pass and a second wave); Mistral-NeMo-12B on one DP group of 4 slots of 32768
   (its decode attention planned at 16 splits and the ticket merge): a
   32000-token prompt, then three of 16-200 tokens that decode beside
   it, 32 tokens each, with the decode steps of all four profiled inside
   the wave. Launch counts set to 0 just before and read just after:
   decode attention exactly the attention layers x decode steps, and on
   DeepSeek-MoE-16B route-pack (Collect inside) exactly the MoE layers
   x forward passes, gmm and placement_gmm split by the placement; no
   other kernel. TTFT and TPOT by prompt length, peak memory, a decode
   profile, a decode step twice bit-identically, one under
   ``no_host_sync``, decode against prefill within 0.08 (Mistral-NeMo
   from an 8192-token prefill; DeepSeek-MoE-16B held with a capacity
   that drops nothing on the same weights, the served capacity's error
   logged); decode attention held and timed at each model's (G, L),
   Mistral-NeMo's also on the served ragged positions, and on
   DeepSeek-MoE-16B route-pack, Collect, gmm and placement_gmm on its
   layer-0 experts at the path's token counts (C 4-72, all on gmm's one
   wgmma variant: 8-row tiles and the K split up to C 8), gmm also held
   and timed off the path at C 12, 16 and 144; then each smoke model
   with its full width's G, card against CPU in float32. ``python3
   chip_smoke.py --only V`` builds the kernels and runs this stage
   alone;
Q. training (``repro_torch.train``, ``Model.forward_train``,
   ``MTPTrainer``), no hand kernel launched in any of it (the MoE layers
   take the plain route-pack and grouped FFN by mode), each step's line
   and one JSON line per part: Q1 one forward_train + backward +
   ``adamw_update`` of five smoke models in float32 (DeepSeek-V3 with
   its MTP head, Llama-4 with G = 5, RecurrentGemma, Mamba-2,
   SeamlessM4T) on the card and on the host's CPU, same weights,
   tokens, loss mask and memory, TF32 off: the loss within 1e-4, every
   gradient leaf and updated weight within 1e-3 relative in norm; a
   requires-grad input to ``fused_route_pack`` or ``expert_ffn`` on the
   card raises, and with ``use_kernel=False`` both carry the gradient.
   Q2 InternLM2-1.8B at full width and depth (24 layers, 1.89 B), as
   ``launch/train.py`` builds it by default (B 8, S 256, lr 3e-4), 20
   steps: finite losses, the first within 1 of ln V, the last 5's mean
   below the first 5's; Q3 DeepSeek-MoE-16B at full width cut to 4
   layers (1 dense, 3 MoE), 10 steps: the aux losses finite and non-zero,
   every MoE layer's counts summing to B·S·6, the loss falling; both
   print the host ms per step and, over the steps after 2 under a
   device-activity-only profiler, device busy (also by kernel kind:
   f32 GEMM, bf16 GEMM, elementwise, other), idle share, tokens/s,
   6·N·tokens/s, the top kernels and peak memory. Q4 ``MTPTrainer`` on
   DeepSeek-V3 depth 4 at full width (the served path's seed-0 weights
   made again; head 0, lr 5e-3, [4, 64] seeded tokens, 8 steps): the
   last loss below the first, every other weight untouched, ms per step.
   Q5 smoke InternLM2: a checkpoint after 3 steps restored into a fresh
   ``Trainer`` (its loader moved past the 3 batches: a checkpoint holds
   no loader) gives steps 4-5 bit-identical to a straight run;
P. the SuperPod simulator (``repro_torch.sim``; host code, no kernel):
   DeepSeek-V3 on a modeled CloudMatrix384 of 768 dies (8 simulated DP
   groups, EPLB every 0.5 s, 80 requests/s for 1 s, seed 11), colocated
   and MoE-Attention disaggregated, each run twice: the trace digests
   and the report JSON (per request too) must repeat, every request
   finish, and the plan be 288 expert / 480 attention dies; then two
   calibration rows measured earlier in this run are written to
   ``chiprun_out/sim_calibration.json`` (``decode/iter_overhead``: the
   DeepSeek-V3 decode profile's engine step on the host clock less the
   device busy of the same steps, per DP group; ``prefill/hit_skip``: the share of the cold prefix's
   prefill device time that seeding saved, from stage B's follow-up
   turn), and the colocated run is repeated from that file: the cost
   model must carry both rows and every request finish. Its figures are
   the MODELED pod's, not the card's (only the two rows are);
R. the multi-device layer (``models/mesh_ctx.py``, ``launch/mesh.py``,
   ``launch/sharding.py``): R0 (in the DeepSeek-V3 stages, DeepSeek-V3
   cut to 1 layer) ``Model.init(0)`` made on the card equals the same init on
   the host CPU bit for bit, leaf by leaf (every element of a leaf up to
   4 Mi elements, three blocks of about 1 Mi of each larger one); R1
   (after the memory stages, in a process of its own, so that no NCCL
   group lives in the main process) a live 1x1 mesh over NCCL on the
   seed's weights of DeepSeek-V3 (depth 4) and Llama-4 (depth 2):
   the mesh code path serves the one-device engine's greedy tokens with
   its kernel launches, and prefill, chunk and decode logits
   bit-identical; R2 (after the memory stages) two ranks as two
   processes sharing the card over gloo — NCCL refuses two ranks on one
   device — each making its blocks of the seed's weights: DeepSeek-V3
   (depth 4, no MTP head) and Llama-4 (depth 2) at full width on (2,1)
   (DP attention, EP 2 under ``DECODE_RULES``) and on (1,2) (TP 2, the
   KV cache's slots sharded, all-to-all prefill), greedy serving with
   the launch counts set to 0 just before and read just after, every
   kernel launch replayed on its plain version (route-pack and Collect
   exactly, the grouped FFNs and decode attention within 3e-2), the
   ranks' tokens identical, the decode steps' logits of the rows
   routed alike within 0.08 relative of a one-device model's on the
   same weights, and so every logit (prefill, chunk, decode) of those
   rows of a no-drop control (capacity factor 64, the gather strategy:
   no pack drops an assignment on either side), and of every row once
   one device takes the ranks' decode routing; the prefill and chunk
   logits at the configuration's
   capacity beside the assignments each side dropped; and each
   rank's peak memory, wire bytes per collective of a decode step and
   step time (the wire goes through host memory and the ranks
   time-slice one card: not multi-GPU figures); and the decode-attention
   kernel's partial output (a shard's max, sum and unnormalised output)
   at Llama-4's shard shape (B 4, 40 heads on 8, hd 128, 512 of 1024
   slots) held to its plain version and timed beside it and SDPA;
S. serving on a mesh, the rest of DeepSeek-V3's path: S1 (in R1's
   process, on its DeepSeek-V3 weights, depth 4 with the MTP head) on
   the live 1x1 NCCL mesh, MTP serving at k 1 and 2, prefix seeding
   (the same split cold and seeded, then a remote and a local pod hit)
   and ``DisaggregatedPD(ctx=)`` (the pod directory, MTP k 1): tokens,
   hits, streams and launches the one-device runs', the prefix logits
   bit for bit; then two ranks sharing the card over gloo (after R2):
   S2 DeepSeek-V3 on (2,1) under ``DECODE_RULES`` (EP 2, DP attention:
   the paper's decode deployment) serving with MTP k 1, every launch
   replayed on its plain version: both ranks' tokens and accepted
   counts equal, the head's draft logits and the verify chain's logits
   of the rows routed alike within 0.08 of one device's, each
   iteration's wire and host-staged bytes, each rank's peak memory and
   launches; S4 that model's 512-token prefill KV from rank 0 to rank 1
   over the ``pd`` axis of a (2,1,1) mesh (``KVLayout``), bit-equal,
   its bytes and host-staged ms (not a wire figure), then
   ``DisaggregatedPD(ctx=)`` on (2,1), its greedy tokens against the
   one-device PD run's (reported); S3 Llama-4 (depth 2) on (1,2),
   prefix seeding: seeded and cold prefill device ms, the seeded logits
   bit-identical to the cold split, the seeded slot decoding through the
   partial decode attention;

U. training on a mesh and the dry run (no hand kernel on this path: the
   train mode takes the plain route-pack and grouped FFN): U1 (in a
   process of its own) InternLM2-1.8B at full width and depth, B 8 x
   S 256, ``Trainer`` for 3 steps on one device and ``Trainer(ctx=)`` on a
   live 1x1 NCCL mesh: every step's loss and grad_norm and every
   parameter and AdamW moment after the last step bit-identical; U2 two
   ranks sharing the card over gloo, InternLM2-1.8B (full) and
   DeepSeek-MoE-16B (full width, 4 layers) on (2,1) (FSDP over
   ``data``) and (1,2) (TP, EP with the all-to-all MoE), each rank its
   blocks of the seed's weights: the loss and grad_norm within 0.02
   relative of one device's (``tests/test_multidevice.py``'s bar), the
   largest gradient-leaf error reported (per-shard MoE capacity drops
   other assignments: not a bar), per rank tokens/s of a timed step,
   peak memory and wire and host-staged bytes, forward and backward
   apart (host wire, one time-sliced card: not multi-GPU figures); U3
   the dry run (``launch/dryrun_lib.run_one``, ``meta`` tensors, a pool
   of host processes started with the stage) of every registered arch
   at ``train_4k`` and ``decode_32k`` on 16x16, one line each and the
   count of ``ok``, all required, then the dry run's per-device
   parameter bytes of DeepSeek-V3 at depth 4 on a 1x1 mesh equal, byte
   for byte, the bytes building them on the card requests from the
   allocator (its ``requested_bytes``; ``memory_allocated``, which
   rounds each block up, printed beside);

13. print the card's name and power limit, one JSON line with every
    kernel's launches per path, error, times and bound (Collect's
    launches are the route-pack launches that ran its body; the partial
    decode attention's are R2's and S3's), then the final
    ``{"ok": true, ...}``
    line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16, published
INT8_OP_PER_S = 1979e12            # H100 SXM dense int8, published
PROMPTS = ["The SuperPod serves DeepSeek-V3 with", "Expert parallel decode",
           "Hello, world! 1 2 3", "Latent attention caches"]
PROMPTS_EPLB = ["Load balancing moves experts", "A second wave of",
                "requests after the swap", "ends the run."]
LLAMA_PROMPTS = [
    ("Llama-4 Maverick sends every token to one of 128 routed experts and "
     "adds one shared expert; grouped-query attention lets five query heads "
     "share each key-value head. ") * 5,
    "Top-1 routing", "Grouped-query attention", "One shared expert"]
LLAMA_PROMPTS_EPLB = ["After the swap", "a hot expert has", "two replicas",
                      "and the run ends."]
DEEPSEEK, LLAMA = "deepseek-v3-671b", "llama4-maverick-400b-a17b"
DEEPSEEK_INT8, LLAMA_INT8_KV = DEEPSEEK + "/int8", LLAMA + "/int8-kv"
KERNELS = ("route_pack", "gmm", "placement_gmm", "decode_attention",
           "quant_dispatch", "int8_matmul", "collect",
           "decode_attention_partial")
SOURCES = {n: f"src/repro_torch/kernels/csrc/{n}.cu" for n in KERNELS}
SOURCES["placement_gmm"] = SOURCES["gmm"]
#: the partial output (m, l, unnormalised acc) of a sequence shard
SOURCES["decode_attention_partial"] = SOURCES["decode_attention"]
#: Collect's body: run by route-pack's count block on the path, and by
#: the standalone launch of csrc/collect.cu
SOURCES["collect"] = "src/repro_torch/kernels/csrc/collect.cuh"
REPLACES = {"route_pack": "src/repro/kernels/route_pack/kernel.py:105",
            "gmm": "src/repro/kernels/gmm/kernel.py:56",
            "placement_gmm": "src/repro/kernels/gmm/kernel.py:91",
            "decode_attention": "src/repro/kernels/decode_attention/"
                                "kernel.py:67",
            "quant_dispatch": "src/repro/kernels/quant_dispatch/kernel.py:30",
            "int8_matmul": "src/repro/kernels/int8_matmul/kernel.py:38",
            "collect": "src/repro/kernels/collect/kernel.py:38",
            "decode_attention_partial": "src/repro/kernels/"
                                        "decode_attention/kernel.py:67"}
#: the path whose measurements each kernel's entry of the kernels line
#: carries (every path's own are under ``by_path``)
TIMED_ON = {"quant_dispatch": DEEPSEEK_INT8, "int8_matmul": DEEPSEEK_INT8,
            "decode_attention_partial": LLAMA + "/R2-1x2"}
#: the INT8 stage's token counts M: a DP group's decode batch, the
#: unpadded first prompt, its padded prefill bucket, and a 512 bucket
INT8_M = (4, 37, 64, 512)
#: route-pack launches (one per MoE layer call) over each served path
PATH_PACKS = {DEEPSEEK: 68, LLAMA: 70}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events per call)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


#: launches of the pad kernel at each end of a profiler window
#: (:func:`device_window`)
PAD_LAUNCHES = 256
#: the pad kernel's name under the profiler, found on first use
PAD_KERNEL = []
#: every :func:`device_window` of the run: windows opened, the most pad
#: events one window lost; and of the :func:`profile_calls` windows, the
#: ones profiled again and the ones whose last try still showed fewer
#: device kernels per call than the wrappers counted
WINDOWS = {"windows": 0, "pads_lost_max": 0, "calls": 0, "retried": 0,
           "short": 0}


def _pad() -> None:
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)


def _cuda_events(prof) -> list:
    return [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.count]


@contextlib.contextmanager
def device_window(activities=None):
    """A ``torch.profiler`` window (device activity only by default)
    whose work is framed by :data:`PAD_LAUNCHES` launches of torch's
    spin kernel (``torch.cuda._sleep``) after the window opens and again
    after the work has synchronised. The profiler loses a window's first
    or last kernel events, more as the process ages, whatever the time
    the window is held open (``tools/profiler_drops.py``: 0-1 of 60 at
    first, 10 after the DeepSeek-V3 stages; 50 ms of host time at each
    end kept none of them): the pads take that loss. Yields a namespace
    whose ``events``, set when the window closes, are the window's CUDA
    events without the pads', and ``pads_lost`` the pad events the
    profiler lost."""
    import types

    from torch.profiler import ProfilerActivity, profile

    if not PAD_KERNEL:                  # early in the run: nothing lost
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _pad()
            torch.cuda.synchronize()
        names = {e.key for e in _cuda_events(prof)}
        check(len(names) == 1, f"the pad kernel alone in its window "
                               f"({names})")
        PAD_KERNEL.append(names.pop())
    w = types.SimpleNamespace(events=None, pads_lost=None)
    with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
        _pad()
        yield w
        torch.cuda.synchronize()
        _pad()
        torch.cuda.synchronize()
    ev = _cuda_events(prof)
    w.events = [e for e in ev if e.key != PAD_KERNEL[0]]
    w.pads_lost = 2 * PAD_LAUNCHES - sum(e.count for e in ev
                                         if e.key == PAD_KERNEL[0])
    WINDOWS["windows"] += 1
    WINDOWS["pads_lost_max"] = max(WINDOWS["pads_lost_max"], w.pads_lost)


def profile_calls(fn, reps: int = 20, warm: int = 3, tries: int = 6) -> dict:
    """``fn`` under ``torch.profiler`` over ``reps`` calls after warm-up:
    ``device_ms``, the CUDA kernels' own time per call, ``per_call``, the
    device kernels and memsets per call, and their ``names``, all from
    one window (:func:`device_window`). Unlike :func:`time_ms` the time
    leaves out the host's launch work, which sets the event-timed figure
    of a call shorter than its launch cost. The profiler drops a single
    event now and then, so each kernel counts as its mean time times its
    launches per call (its count over ``reps``, rounded); more rarely it
    records nothing in a window, drops most of one kernel's events (seen
    in half the calls or fewer), or loses every pad event at one end of
    the window, and the window is then profiled again, up to ``tries``
    times, each retry a little later than the last. After that the last
    window that recorded anything is returned, or every figure is None:
    "not measured", never 0.
    ``counted_per_call``: the launches the port's wrappers counted per
    call in the same window (0 for a library call)."""
    from repro_torch.kernels import runtime

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    got = dict(device_ms=None, per_call=None, names=[],
               counted_per_call=None)
    WINDOWS["calls"] += 1
    for attempt in range(tries):
        time.sleep(0.25 * attempt)       # spread the retries out in time
        WINDOWS["retried"] += attempt == 1
        before = sum(runtime.LAUNCHES.values())
        with device_window() as w:
            for _ in range(reps):
                fn()
        counted = (sum(runtime.LAUNCHES.values()) - before) / reps
        ev = w.events
        total = sum(e.self_device_time_total / e.count
                    * max(1, round(e.count / reps)) for e in ev)
        if total > 0:
            got = dict(device_ms=total / 1e3,
                       per_call=round(sum(e.count for e in ev) / reps, 2),
                       names=sorted(e.key for e in ev),
                       counted_per_call=counted)
            if (w.pads_lost < PAD_LAUNCHES
                    and all(2 * e.count > reps for e in ev)):
                break
    WINDOWS["short"] += bool(got["per_call"] is None
                             or got["per_call"] < counted)
    return got


def device_ms(fn, reps: int = 20, warm: int = 3):
    """The device time per call of :func:`profile_calls`, or None."""
    return profile_calls(fn, reps, warm)["device_ms"]


def one_launch(prof: dict, name: str, what: str) -> None:
    """Hold a :func:`profile_calls` window to one device kernel per call,
    the kernel ``name``: no memset, fill or second kernel beside it, and
    one launch per call by the wrapper's own count in the same window."""
    check(prof["per_call"] is not None and prof["device_ms"] is not None,
          f"{what}: measured under the profiler")
    check(len(prof["names"]) == 1 and round(prof["per_call"]) == 1
          and name in prof["names"][0],
          f"{what}: one launch per call, got {prof['per_call']} of "
          f"{prof['names']}")
    check(prof["counted_per_call"] == 1,
          f"{what}: one counted launch per call, got "
          f"{prof['counted_per_call']}")


def profile_turns(fa, fb, reps: int = 20, warm: int = 3,
                  tries: int = 6) -> tuple:
    """Device ms per call of ``fa`` and of ``fb`` called in turn (a, b,
    b, a, ...) in one ``torch.profiler`` window, each the sum of its own
    kernels' mean times (:func:`profile_calls` names them in a window of
    its own first: the two must launch kernels of different names). A
    window that misses a kernel is profiled again, up to ``tries``
    times. Returns (a ms, b ms, a's window, b's window)."""
    pa, pb = profile_calls(fa, warm=warm), profile_calls(fb, warm=warm)
    na, nb = set(pa["names"]), set(pb["names"])
    check(bool(na) and bool(nb) and not na & nb,
          f"profile_turns: kernels told apart by name ({na} and {nb})")
    for attempt in range(tries):
        time.sleep(0.25 * attempt)
        with device_window() as w:
            for i in range(2 * reps):
                (fa, fb)[(i + i // 2) % 2]()
        ev = {e.key: e for e in w.events}
        if na | nb <= set(ev):
            break
    check(na | nb <= set(ev), f"profile_turns: {na | nb} recorded")

    def per_call(names):
        return sum(ev[n].self_device_time_total / ev[n].count
                   * max(1, round(ev[n].count / reps)) for n in names) / 1e3
    return per_call(na), per_call(nb), pa, pb


def time_pair(fa, fb, reps: int = 50, warm: int = 3):
    """Median CUDA-event times of ``fa`` and ``fb`` (ms per call, as
    :func:`time_ms`), called in turn (a, b, b, a, ...) so that both
    meet the same card and host state."""
    for _ in range(warm):
        fa()
        fb()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(2 * reps):
        j = (i + i // 2) % 2                   # a b b a a b b a ...
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        (fa, fb)[j]()
        b.record()
        b.synchronize()
        times[j].append(a.elapsed_time(b))
    return statistics.median(times[0]), statistics.median(times[1])


def bound_ms(n_bytes: float, n_flops: float, peak: float = BF16_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def routed_dest(T: int, k: int, E: int, gen, hot: int = 0) -> torch.Tensor:
    """Top-k experts of random router scores, flattened [T*k] int32. With
    ``hot > 0`` every token favours the same ``hot`` experts, so buckets
    overflow and ranks grow across the rank scan's tiles."""
    scores = torch.rand((T, E), generator=gen, device="cuda")
    if hot:
        scores[:, :hot] += 1.0
    return torch.topk(scores, k, dim=-1).indices.reshape(-1).to(torch.int32)


def pack_err(a, b, what: str) -> float:
    """Hold two RoutePacks field by field: exact, or the check fails.
    Returns the largest absolute difference over all fields."""
    err = 0.0
    for name in ("buckets", "scales", "eids", "rank", "keep", "counts"):
        ta, tb = getattr(a, name), getattr(b, name)
        check((ta is None) == (tb is None), f"{what}: {name} in both")
        if ta is None:
            continue
        check(ta.shape == tb.shape and ta.dtype == tb.dtype,
              f"{what}: {name} shape and dtype")
        if ta.numel() and not torch.equal(ta, tb):
            err = max(err, (ta.double() - tb.double()).abs().max().item())
        check(torch.equal(ta, tb), f"{what}: {name} exact (max abs "
                                   f"difference {err})")
    return err


def exact(got, want, what: str) -> float:
    """Hold a kernel's output to its plain version: same shape and dtype
    and bit-identical, or the check fails. Returns the largest absolute
    difference, computed from the two tensors."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape and dtype")
    err = ((got.double() - want.double()).abs().max().item()
           if got.numel() else 0.0)
    check(torch.equal(got, want), f"{what}: bit-identical (max abs "
                                  f"difference {err})")
    return err


def path_token_counts(prompts, max_batch: int, max_len: int = 256,
                      chunk: int = 0) -> list:
    """Token counts T of the route-packs a path makes: a decode step's
    batch, each prefill chunk (``chunk`` tokens, 0 for whole prompts)
    padded as ``TorchBackend.prefill_chunk`` pads it, and the unpadded
    first prompt of the finite-logits check."""
    from repro_torch.serving.tokenizer import ByteTokenizer

    enc = ByteTokenizer().encode
    return sorted({max_batch, len(enc(prompts[0]))}
                  | chunk_token_counts([len(enc(p)) for p in prompts],
                                       max_len, chunk))


def chunk_token_counts(lens, max_len: int, chunk: int = 0) -> set:
    """Token counts of the prefill chunks of prompts of ``lens`` tokens
    (``chunk`` tokens, 0 for whole prompts), each padded as
    ``TorchBackend.prefill_chunk`` pads it."""
    from repro_torch.serving.backend import _bucket_len

    counts = set()
    for n in lens:
        Lc, c = min(_bucket_len(n), max_len), chunk or n
        counts |= {min(_bucket_len(min(c, n - o)), Lc - o)
                   for o in range(0, n, c)}
    return counts


# ---------------------------------------------------------------------------
# stages 3 and 9: kernels against their plain versions
# ---------------------------------------------------------------------------
def bmm_chain(xb, g, u, dn):
    """The grouped SwiGLU FFN as PyTorch batched products (the library
    yardstick of gmm)."""
    h = torch.bmm(xb, g)
    return torch.bmm(torch.nn.functional.silu(h) * torch.bmm(xb, u),
                     dn).float()


def check_moe_kernels(cfg, counts, max_batch: int, weights=None,
                      off_path=()) -> dict:
    """Route-pack, Collect, gmm and placement_gmm at a path's shapes.

    ``counts``: the token counts T of the path's packs; ``weights``: the
    expert weights (we_gate, we_up, we_down), or None to make random
    ones; ``off_path``: token counts T whose packs gmm is also held and
    timed on (capacities the path does not reach). Route-pack is held
    exactly at every T, over the E logical experts and over the E + 2
    physical slots of an EPLB table that replicates two experts, and
    Collect at every N = T·k; gmm and
    placement_gmm as :func:`check_gmm` says, on the path's packs. Times
    are taken at the decode shape (T = ``max_batch``), and gmm's also at
    the shapes :func:`check_gmm` names."""
    from repro_torch.kernels.collect.kernel import collect_cuda
    from repro_torch.kernels.collect.ref import collect_ref
    from repro_torch.kernels.route_pack.kernel import route_pack_cuda
    from repro_torch.kernels.route_pack.ops import placement_route
    from repro_torch.kernels.route_pack.ref import route_pack_ref
    from repro_torch.serving.eplb import build_placement_table, ExpertMap

    e, d = cfg.moe, cfg.d_model
    E, k, f = e.num_experts, e.top_k, e.expert_d_ff
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1234)
    if weights is None:
        def w(shape, fan):
            return (torch.randn(shape, generator=gen, device="cuda")
                    / fan ** 0.5).to(bf16)
        weights = w((E, d, f), d), w((E, d, f), d), w((E, f, d), f)
    wg, wu, wd = weights

    def cap_of(T):       # models/ffn.py's capacity, as Python arithmetic
        return max(int(T * k / E * e.capacity_factor), 4)

    # the EPLB table: two redundant replicas of two hot experts
    hot = [3 % E, 77 % E]
    emap = ExpertMap(E, {h: [h, E + i] for i, h in enumerate(hot)})
    table = build_placement_table([emap], E, pad_physical=E + 2,
                                  pad_replicas=3)
    rs, nr, owner = (torch.as_tensor(a[0], dtype=torch.int32, device="cuda")
                     for a in (table.replica_slots, table.n_replicas,
                               table.phys_owner))
    S = owner.shape[0]

    def held_pack(x, dst, valid, ei, what, **kw):
        """One route-pack held to its plain version (the counts too, and
        those to Collect's plain version)."""
        got = route_pack_cuda(x, dst, valid, ei, **kw)
        err = pack_err(got, route_pack_ref(x, dst, valid, ei, **kw), what)
        if kw.get("count_ids") is not None:
            exact(got.counts, collect_ref(kw["count_ids"], kw["n_count"]),
                  f"{what}: counts against collect_ref")
        return err

    # -- route-pack: exact at every token count, over E and S slots, with
    # and without the count block (the path's form: logical ids counted,
    # as int32 dest without a placement and the router's int64 ids with)
    rp_err, packs = 0.0, {}
    for T in counts:
        N, cap = T * k, cap_of(T)
        x = torch.randn((T, d), generator=gen, device="cuda").to(bf16)
        eid = torch.randint(0, E, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        mask = torch.rand((N,), generator=gen, device="cuda") > 0.2
        tok_of = torch.arange(T, device="cuda").repeat_interleave(k)
        variants = ([(q, ei, None, False) for q in (False, True)
                     for ei in (None, eid)]
                    + [(True, eid, mask, False), (False, None, None, True),
                       (True, eid, mask, True)])
        for hot_n in (0, 12):
            dest = routed_dest(T, k, E, gen, hot_n)
            pdest = placement_route(dest, tok_of, rs, nr)
            for n_dest, dst, ids in ((E, dest, dest), (S, pdest, dest.long())):
                for quant, ei, valid, counted in variants:
                    kw = dict(k=k, n_dest=n_dest, capacity=cap,
                              quantize=quant)
                    if counted:
                        kw.update(count_ids=ids, n_count=E)
                    rp_err = max(rp_err, held_pack(
                        x, dst, valid, ei,
                        f"route_pack T={T} n_dest={n_dest} hot={hot_n} "
                        f"quantize={quant} eid={ei is not None} "
                        f"masked={valid is not None} counted={counted}",
                        **kw))
            if not hot_n:
                packs[T] = x, dest, pdest
        log(f"route_pack T={T} N={N} C={cap}: exact in "
            f"{4 * len(variants)} variants (n_dest {E} and {S}, spread and "
            f"hot routing x quantize x eid, masked, and with the count "
            f"block: counts equal to collect_ref)")
    # edge cases: padding rows (dest == n_dest, valid or masked), payload
    # rows off the 16-byte vector (f32 and bf16), a capacity past one
    # 256-slot window, and a call with no rows
    for T, dd, kk, n_dest, cap, dt in ((37, d, k, E, cap_of(37), bf16),
                                       (64, 100, 2, 3, 300, torch.float32),
                                       (16, 36, 1, 5, 4, bf16),
                                       (0, d, k, E, 4, bf16)):
        N = T * kk
        x = torch.randn((T, dd), generator=gen, device="cuda").to(dt)
        dest = torch.randint(0, n_dest, (N,), generator=gen, device="cuda",
                             dtype=torch.int32)
        pad = torch.rand((N,), generator=gen, device="cuda") < 0.2
        dest = torch.where(pad, torch.full_like(dest, n_dest), dest)
        eid = torch.randint(0, E, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        mask = torch.rand((N,), generator=gen, device="cuda") > 0.2
        # count ids with padding (-1) and ids at E or above mixed in
        wild = torch.randint(-1, E + 5, (N,), generator=gen, device="cuda")
        for quant in (False, True):
            for ei, valid, ids in ((None, None, None), (eid, mask, None),
                                   (eid, None, None), (None, None, wild),
                                   (eid, mask, wild.int())):
                kw = dict(k=kk, n_dest=n_dest, capacity=cap, quantize=quant)
                if ids is not None:
                    kw.update(count_ids=ids, n_count=E)
                rp_err = max(rp_err, held_pack(
                    x, dest, valid, ei,
                    f"route_pack edge T={T} d={dd} {dt} n_dest={n_dest} "
                    f"C={cap} quantize={quant} eid={ei is not None} "
                    f"masked={valid is not None} counted={ids is not None}",
                    **kw))
        log(f"route_pack edge T={T} d={dd} {dt} n_dest={n_dest} C={cap}, "
            f"padding rows: exact with and without quantize, eid, mask and "
            f"the count block (int64 and int32 ids, -1 and ids >= E)")
    # -- timed at decode, in the path's form: the pack counts the logical
    # ids (here dest itself: no placement) in the same launch
    x, dest, pdest = packs[max_batch]
    kw = dict(k=k, n_dest=E, capacity=cap_of(max_batch), quantize=False)
    cw = dict(kw, count_ids=dest, n_count=E)

    def rp():
        return route_pack_cuda(x, dest, None, None, **cw)

    def rp_alone():
        return route_pack_cuda(x, dest, None, None, **kw)

    def rp_then_collect():               # the two launches it replaces
        return rp_alone(), collect_cuda(dest, E)
    res = rp()
    bnd, by = bound_ms(nbytes(x, dest, res.buckets, res.rank, res.keep,
                              res.counts), 0)
    with_ms, alone_ms, prof, prof_alone = profile_turns(rp, rp_alone)
    one_launch(prof, "route_pack", f"route_pack T={max_batch} with counts")
    one_launch(prof_alone, "route_pack", f"route_pack T={max_batch}")
    check(with_ms <= 1.10 * alone_ms,
          f"route_pack T={max_batch}: device {with_ms} ms with the count "
          f"block within 10% of {alone_ms} ms without it, in turn")
    fused_ms, two_ms = time_pair(rp, rp_then_collect)
    check(fused_ms < two_ms,
          f"route_pack with counts: {fused_ms} ms below route_pack + "
          f"collect_cuda's {two_ms} ms, in turn")
    out = {"route_pack": dict(
        max_abs_err=rp_err, ms=time_ms(rp), device_ms=with_ms,
        device_ms_without_counts=alone_ms,
        kernels_per_call=prof["per_call"],
        plain_ms=time_ms(lambda: route_pack_ref(x, dest, None, None, **cw)),
        library_ms=None, bound_ms=bnd, bound_by=by)}
    log(f"route_pack T={max_batch}: device {with_ms:.4f} ms with the count "
        f"block, {alone_ms:.4f} without (in turn); events {fused_ms:.4f} ms "
        f"against {two_ms:.4f} for route_pack + collect_cuda (in turn)")

    out["collect"] = check_collect(counts, k, E, gen)
    out["collect"]["in_route_pack"] = dict(
        events_ms=fused_ms, events_ms_route_pack_then_collect=two_ms,
        device_ms=with_ms, device_ms_route_pack_alone=alone_ms)

    # -- gmm and placement_gmm at each capacity the path's packs have,
    # and gmm off the path on routed tokens
    for T in off_path:
        packs[T] = (torch.randn((T, d), generator=gen, device="cuda")
                    .to(bf16), routed_dest(T, k, E, gen), None)

    def pack(T, dst, n_dest):
        return route_pack_cuda(packs[T][0], dst, None, None, k=k,
                               n_dest=n_dest, capacity=cap_of(T),
                               quantize=False).buckets

    out.update(check_gmm(
        weights, owner, hot, counts, max_batch, cap_of, gen,
        lambda T: pack(T, packs[T][1], E), lambda T: pack(T, packs[T][2], S),
        off_path))
    for name, r in out.items():
        log(f"  {name}: {r['ms']:.4f} ms, device {r['device_ms']} ms "
            f"(plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
    return out


def sparse_buckets(S: int, C: int, d: int, live: int, gen,
                   dtype=torch.bfloat16, full: bool = False):
    """[S, C, d] buckets, all zero but ``live`` random slots, which hold
    1..C leading rows of random values (all C if ``full``); in a live
    slot of three or more rows, row 1 is zero (a zero row between live
    ones)."""
    b = torch.zeros((S, C, d), device="cuda")
    slots = torch.randperm(S, generator=gen, device="cuda")[:live].tolist()
    n = (torch.full((live,), C) if full else
         torch.randint(1, C + 1, (live,), generator=gen, device="cuda"))
    for s, r in zip(slots, n.tolist()):
        b[s, :r] = torch.randn((r, d), generator=gen, device="cuda")
        if r >= 3:
            b[s, 1] = 0.0
    return b.to(dtype)


def check_gmm(weights, owner, hot, counts, max_batch: int, cap_of, gen,
              pack_experts, pack_slots, off_path=()) -> dict:
    """gmm and placement_gmm at a path's shapes.

    ``pack_experts(T)`` / ``pack_slots(T)``: the path's route-pack of T
    tokens into the E experts' / the EPLB table's S slots' buckets. Every
    call below is held to its plain version (3e-2 in bf16, 2e-4 in f32),
    its device-side rows (the kernel's prologue) to ``live_rows`` exactly,
    a second call bit-identical to it, and every all-zero bucket row to
    +0 in the output. The calls: each capacity the path's packs have
    (with identity owners bit-identical to gmm, and placement_gmm
    bit-identical to gmm on owner-gathered weights, 16 slots at a time: a
    whole copy at Llama-4 width would be 32 GB beside its 37 GB of
    weights); at the decode capacity an all-empty call (all +0), one live
    slot, partly filled rows; the float32 variant on 16 experts' weights.
    Order independent of the live count: at each capacity C <= 8 the path
    packs and its largest one above 8 (or, with none, the largest of
    ``off_path``), a slot's output alone in the call bit-identical to its
    output beside every other slot live, for gmm and placement_gmm.
    Timed: the decode packs of both, and for gmm a one-live-slot decode,
    the largest T of each capacity and each T of ``off_path`` (held
    first), each beside its live-slot count, its bound (live experts'
    weights read once), its dense-walk bound (every slot's weights), the
    plain version and ``bmm_chain`` (event and device ms), with the
    call's ``kernel.plan`` (at C <= 8 its K ranges, and the piece length
    the walk takes at that live count): the profiler must name the kernel
    of its width (``wg_pass<2, nb>``), and the work buffer the C entry
    asks for must equal ``kernel.work_ints``."""
    import re

    from repro_torch.kernels.gmm import kernel as gmm_kernel
    from repro_torch.kernels.gmm.kernel import (gmm_cuda, gmm_cuda_with_rows,
                                                plan)
    from repro_torch.kernels.gmm.ref import (gmm_ref, live_rows,
                                             placement_gmm_ref)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False
    wg, wu, wd = weights
    E, d, f = wg.shape
    S = owner.shape[0]
    o = owner.long()
    errs = {}

    def held(b, own, what, ws=weights):
        """One call held to the plain version, rows, repeat and zeros."""
        bar = 3e-2 if b.dtype == torch.bfloat16 else 2e-4
        got, rows = gmm_cuda_with_rows(b, *ws, own)
        want = (gmm_ref(b, *ws) if own is None
                else placement_gmm_ref(b, *ws, own))
        err = (got - want).abs().max().item()
        check(err <= bar, f"{what}: max abs err {err} <= {bar}")
        check(torch.equal(rows, live_rows(b)),
              f"{what}: the kernel's rows equal live_rows")
        check(torch.equal(gmm_cuda(b, *ws, own), got),
              f"{what}: two calls bit-identical")
        zero = ~(b != 0).any(dim=-1)
        check(bool((got[zero] == 0).all())
              and not bool(torch.signbit(got[zero]).any()),
              f"{what}: every all-zero bucket row gives +0")
        key = ("gmm" if own is None else "placement_gmm", str(b.dtype))
        errs[key] = max(errs.get(key, 0.0), err)
        return got, int((rows > 0).sum())

    by_cap = {}
    for T in sorted(counts):
        by_cap.setdefault(cap_of(T), T)     # the smallest T of a capacity
    ident = torch.arange(E, device="cuda", dtype=torch.int32)
    for T in by_cap.values():
        b = pack_experts(T)
        got, live = held(b, None, f"gmm T={T}")
        check(torch.equal(gmm_cuda(b, wg, wu, wd, ident), got),
              f"placement_gmm with identity owners bit-identical to gmm, "
              f"T={T}")
        pb = pack_slots(T)
        pgot, plive = held(pb, owner, f"placement_gmm T={T}")
        for s in range(0, S, 16):
            sub = [t[o[s:s + 16]] for t in (wg, wu, wd)]
            check(torch.equal(gmm_cuda(pb[s:s + 16], *sub), pgot[s:s + 16]),
                  f"placement_gmm bit-identical to gmm on owner-gathered "
                  f"weights, T={T}, slots {s}..{s + 15}")
            del sub
        torch.cuda.synchronize()
        log(f"gmm [{E},{b.shape[1]},{d}]x{f} ({live} live): rows, repeat "
            f"and zeros held; placement_gmm [{S},{pb.shape[1]},{d}] "
            f"({plive} live; replicas of experts {hot}): bit-identical to "
            f"gathered; max abs err vs plain {errs}")

    C = cap_of(max_batch)
    for own, n in ((None, E), (owner, S)):
        z, rows = gmm_cuda_with_rows(
            torch.zeros((n, C, d), dtype=wg.dtype, device="cuda"), wg, wu,
            wd, own)
        check(not bool(rows.any()) and bool((z == 0).all())
              and not bool(torch.signbit(z).any()),
              f"all-empty call ({n} slots): no live rows, output all +0")
    held(sparse_buckets(E, C, d, 1, gen, full=True), None, "gmm, one live "
         "slot")
    held(sparse_buckets(S, C, d, 1, gen, full=True), owner,
         "placement_gmm, one live slot")
    held(sparse_buckets(E, C, d, E // 4, gen), None, "gmm, partly filled")
    held(sparse_buckets(S, C, d, S // 4, gen), owner,
         "placement_gmm, partly filled")
    # float32 on 16 experts (the smoke engines' variant; a whole f32 copy
    # would be 45 GB at DeepSeek-V3 width), 4 more slots with replicas
    n = min(16, E)
    wf = [w[:n].float() for w in weights]
    own_f = (torch.cat([torch.arange(n), torch.tensor([3, 3, 9, 15]) % n])
             .to(device="cuda", dtype=torch.int32))
    for Cf in sorted({C, max(by_cap)}):
        held(sparse_buckets(n, Cf, d, 6, gen, torch.float32), None,
             f"gmm f32 C={Cf}", wf)
        held(sparse_buckets(n + 4, Cf, d, 7, gen, torch.float32), own_f,
             f"placement_gmm f32 C={Cf}", wf)
    del wf
    log(f"gmm: all-empty, one live slot, partly filled rows and float32 "
        f"held; max abs err vs plain {errs}")
    # a slot's output does not depend on which other slots are live
    caps = sorted(c for c in by_cap if c <= 8)
    wide = [c for c in by_cap if c > 8] or [cap_of(T) for T in off_path]
    for Ci in caps + sorted(wide)[-1:]:
        for own, n in ((None, E), (owner, S)):
            full = sparse_buckets(n, Ci, d, n, gen, full=True)
            s0 = int(torch.randint(0, n, (1,), generator=gen,
                                   device="cuda"))
            alone = torch.zeros_like(full)
            alone[s0] = full[s0]
            check(torch.equal(gmm_cuda(alone, wg, wu, wd, own)[s0],
                              gmm_cuda(full, wg, wu, wd, own)[s0]),
                  f"{'gmm' if own is None else 'placement_gmm'} C={Ci}: "
                  f"slot {s0} alone bit-identical to it beside all {n} "
                  f"slots live")
            del full, alone
    log(f"gmm, placement_gmm: a slot alone bit-identical to it beside "
        f"every slot live at C {caps + sorted(wide)[-1:]}")
    f32 = str(torch.float32)
    bf = str(torch.bfloat16)

    def timed(b, own) -> dict:
        ref = gmm_ref if own is None else (
            lambda *a: placement_gmm_ref(*a, own))
        rows = live_rows(b)
        live_slots = (rows > 0).nonzero().flatten()
        live = int(live_slots.numel())
        experts = int((live_slots if own is None else own[live_slots])
                      .unique().numel())
        io = nbytes(b, own) + b.numel() * 4
        n_rows = int(rows.sum())
        bnd, by = bound_ms(experts * 3 * d * f * 2 + io, 6 * n_rows * d * f)
        dense, _ = bound_ms(b.shape[0] * 3 * d * f * 2 + io,
                            6 * b.shape[0] * b.shape[1] * d * f)
        p = plan(*b.shape, f, b.dtype)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        ints = gmm_kernel._work_ints(*b.shape, f, 1)
        check(ints == gmm_kernel.work_ints(*b.shape, f, b.dtype, sms),
              f"gmm {list(b.shape)}: the C entry's work buffer {ints} ints "
              f"equals kernel.work_ints on {sms} SMs")
        # the piece length the walk takes here (C <= 8), as the card does
        units = [int((rows > 0).sum()) * c for c in p.col_tiles]
        pieces = [gmm_kernel.piece_len(u % sms, ns, nk, sms, nw)
                  for u, ns, nk, nw in zip(units, p.splits, p.k_steps,
                                           (2, 1))]
        prof = profile_calls(lambda: gmm_cuda(b, wg, wu, wd, own))
        # pass 1's kernel, demangled or not
        kern = rf"wg_pass<2,\s*{p.nb}>|_Z7wg_passILi2ELi{p.nb}E"
        check(not prof["names"]
              or any(re.search(kern, n) for n in prof["names"]),
              f"gmm {list(b.shape)}: plan {p.variant} {p.nb}, the profiler "
              f"names {prof['names']}")
        r = dict(shape=list(b.shape), nonempty_slots=live,
                 live_experts=experts, slots=b.shape[0],
                 plan=p._asdict(), piece_len=pieces,
                 ms=time_ms(lambda: gmm_cuda(b, wg, wu, wd, own)),
                 device_ms=prof["device_ms"],
                 plain_ms=time_ms(lambda: ref(b, wg, wu, wd)),
                 # no single PyTorch call takes an owner table
                 library_ms=(time_ms(lambda: bmm_chain(b, wg, wu, wd))
                             if own is None else None),
                 library_device_ms=(
                     device_ms(lambda: bmm_chain(b, wg, wu, wd))
                     if own is None else None),
                 bound_ms=bnd, bound_by=by, bound_dense_walk_ms=dense)
        log(f"  {'gmm' if own is None else 'placement_gmm'} "
            f"{list(b.shape)} x {f}, {live} of {b.shape[0]} slots live, "
            f"{p.variant} nb {p.nb}, K ranges {p.splits}, pieces of "
            f"{pieces}: {r['ms']:.4f} ms, device "
            f"{r['device_ms']} ms, bound {bnd:.4f} ms by {by}, dense walk "
            f"{dense:.4f} ms, plain {r['plain_ms']:.4f} ms, bmm_chain "
            f"{r['library_ms']} (device {r['library_device_ms']})")
        return r

    res = {"gmm": timed(pack_experts(max_batch), None),
           "placement_gmm": timed(pack_slots(max_batch), owner)}
    res["gmm"]["max_abs_err"] = errs[("gmm", bf)]
    res["gmm"]["max_abs_err_f32"] = errs[("gmm", f32)]
    res["placement_gmm"]["max_abs_err"] = errs[("placement_gmm", bf)]
    res["placement_gmm"]["max_abs_err_f32"] = errs[("placement_gmm", f32)]
    largest = {}
    for T in sorted(counts):
        largest[cap_of(T)] = T
    res["gmm"]["shapes"] = {
        "one live slot, decode": timed(
            sparse_buckets(E, C, d, 1, gen, full=True), None),
        **{f"T={T}, C={c}": timed(pack_experts(T), None)
           for c, T in largest.items()}}
    for T in off_path:
        b = pack_experts(T)
        held(b, None, f"gmm off the path, T={T}, C={cap_of(T)}")
        res["gmm"]["shapes"][f"off path: T={T}, C={cap_of(T)}"] = timed(
            b, None)
    res["gmm"]["max_abs_err"] = errs[("gmm", bf)]
    return res


def check_collect(counts, k: int, E: int, gen) -> dict:
    """Collect exactly against its plain version at every N = T·k the
    path routes, on routed ids (int64, as the router's top-k gives them)
    and on int32 ids with -1 and ids at E or above mixed in; its counts
    sum to the number of valid ids. Timed at the decode shape (the first
    T) on routed ids."""
    from repro_torch.kernels.collect.kernel import collect_cuda
    from repro_torch.kernels.collect.ref import collect_ref

    err = 0.0
    for T in counts:
        N = T * k
        routed = torch.rand((T, E), generator=gen, device="cuda").topk(
            k, dim=-1).indices.reshape(-1)
        mixed = torch.randint(-1, E, (N,), generator=gen, device="cuda",
                              dtype=torch.int32)
        wild = torch.rand((N,), generator=gen, device="cuda") < 0.15
        mixed[wild] = E + torch.randint(0, 3 * E, (N,), generator=gen,
                                        device="cuda",
                                        dtype=torch.int32)[wild]
        for name, ids in (("routed int64", routed), ("mixed int32", mixed)):
            got = collect_cuda(ids, E)
            err = max(err, exact(got, collect_ref(ids, E),
                                 f"collect N={N} E={E} {name}"))
            check(int(got.sum()) == int(((ids >= 0) & (ids < E)).sum()),
                  f"collect N={N}: the counts sum to the valid ids")
        log(f"collect N={N} E={E}: exact on routed int64 ids and on int32 "
            f"ids with -1 and ids >= E mixed in")
    ids = torch.rand((counts[0], E), generator=gen, device="cuda").topk(
        k, dim=-1).indices.reshape(-1)
    bnd, by = bound_ms(nbytes(ids) + E * 4, 0)
    return dict(max_abs_err=err, n=ids.numel(),
                ms=time_ms(lambda: collect_cuda(ids, E)),
                device_ms=device_ms(lambda: collect_cuda(ids, E)),
                plain_ms=time_ms(lambda: collect_ref(ids, E)),
                library_ms=time_ms(lambda: torch.bincount(ids, minlength=E)),
                library="torch.bincount", bound_ms=bnd, bound_by=by)


# ---------------------------------------------------------------------------
# stage 9: decode attention against its plain version
# ---------------------------------------------------------------------------
def attention_err(got, want) -> tuple:
    """(max abs err, scaled err) of decode attention's output [B, H, hd]
    against the plain version's. The scaled error is the largest of any
    row (b, head) over that row's scale, min(1, max |want|): with
    near-uniform scores an output is a mean of many values, far below 1,
    where a bar on the absolute error could not tell a wrong kernel
    (zeros, a dropped split or warp) from a right one. NaN reads as
    failed."""
    d = (got - want).abs()
    scale = want.abs().amax(-1).clamp(min=1e-30, max=1.0)
    scaled = (d.amax(-1) / scale).max().item()
    return d.max().item(), scaled


def held_attention(got, want, bar: float, what: str) -> tuple:
    """Check decode attention's output within ``bar`` of the plain
    version's, both as an absolute error and scaled by each row's
    output (:func:`attention_err`); returns both errors."""
    err, scaled = attention_err(got, want)
    check(bool(torch.isfinite(got).all()) and err <= bar and scaled <= bar,
          f"decode_attention {what}: max abs err {err}, scaled by the "
          f"output {scaled}, within {bar}")
    return err, scaled


def no_spills(name: str) -> None:
    """Hold nvcc's ``-Xptxas -v`` lines of ``csrc/<name>.cu`` to 0 bytes
    spilled in every kernel instantiation (one line each: decode
    attention's are the entries of ``kernel.BLOCKS_PER_SM``). A library
    found already built in the build directory has no log: said, not
    held."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.decode_attention.kernel import BLOCKS_PER_SM

    text = runtime.BUILD_LOGS.get(name)
    if text is None:
        log(f"{name}.cu: built before this run, no spill lines to hold")
        return
    lines = [ln for ln in text.splitlines() if "spill" in ln]
    check(len(lines) == len(BLOCKS_PER_SM) and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln for ln in lines),
        f"{name}.cu: 0 bytes spilled in each of its {len(BLOCKS_PER_SM)} "
        f"instantiations, got {lines}")
    log(f"{name}.cu: 0 bytes spilled in all {len(lines)} instantiations")


def gmm_spills() -> dict:
    """Registers and spill bytes of the grouped FFN's wgmma
    instantiations (``wg_pass<NW, NB>``: both passes at every width of
    ``kernel.WG_WIDTHS``, the 8-row one included), from nvcc's
    ``-Xptxas -v`` lines of
    ``csrc/gmm.cu``, each held to 0 bytes spilled. A library found
    already built in the build directory has no log: said, not held."""
    import re

    from repro_torch.kernels import runtime
    from repro_torch.kernels.gmm.kernel import WG_WIDTHS

    text = runtime.BUILD_LOGS.get("gmm")
    if text is None:
        log("gmm.cu: built before this run, no ptxas lines to hold")
        return {}
    got, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'_Z7wg_passILi(\d+)ELi(\d+)E", line)
            name = f"wg_pass<{m[1]}, {m[2]}>" if m else None
        elif name and "spill" in line:
            stores, loads = (int(n) for n in re.findall(
                r"(\d+) bytes spill", line))
            got[name] = dict(spill_stores=stores, spill_loads=loads)
        elif name and "registers" in line:
            got[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
    want = {f"wg_pass<{nw}, {nb}>" for nw in (1, 2) for nb in WG_WIDTHS}
    check(set(got) == want and all(
        v["spill_stores"] == v["spill_loads"] == 0 for v in got.values()),
        f"gmm.cu: 0 bytes spilled in each of {sorted(want)}, got {got}")
    log("gmm.cu: 0 bytes spilled in every wgmma instantiation; registers "
        + ", ".join(f"{k} {v['registers']}" for k, v in sorted(got.items())))
    return got


def check_occupancy() -> dict:
    """Decode attention's plan table (``kernel.BLOCKS_PER_SM``: blocks an
    SM holds, by dtype, hd, heads a warp set takes and warp sets) against
    the CUDA runtime's occupancy of each instantiation; logs the clusters
    of 8 blocks the card holds beside it."""
    from repro_torch.kernels.decode_attention.kernel import (BLOCKS_PER_SM,
                                                             occupancy)

    got = {}
    for (dtype, hd, sh, wq), want in BLOCKS_PER_SM.items():
        what = f"{str(dtype)[6:]} hd {hd} sets {wq} of {sh} heads"
        blocks, clusters = occupancy(dtype, hd, sh, wq, torch.device("cuda"))
        got[what] = dict(blocks_per_sm=blocks, table=want,
                         clusters_of_8=clusters)
    check(all(g["blocks_per_sm"] == g["table"] for g in got.values()),
          f"decode_attention: blocks an SM as the plan's table says: {got}")
    log(f"decode_attention occupancy (blocks an SM = the plan's table; "
        f"clusters of 8 on the card): {got}")
    return got


def plan_text(p: dict) -> str:
    """A decode-attention plan in a few words: split, merge, heads."""
    merge = (f"cluster of {p['cluster']}" if p["cluster"] > 1 else
             "ticket merge" if p["n_split"] > 1 else "no merge")
    return (f"{p['n_split']} x {p['split_len']} slots ({merge}), "
            f"{p['n_grp']} group(s) of {p['gpb']} heads in {p['wq']} warp "
            f"set(s), {p['per_sm']} block(s) an SM")


def host_cut(fn) -> dict:
    """CUDA-event ms of a decode-attention call ``fn`` (called in turn,
    as :func:`time_pair`) doing a first call's host work every time (the
    wrapper's kept launches dropped first: checks, plan, argument block
    and workspace made anew, as every call did before they were kept)
    and as the served calls run it (the kept launch)."""
    from repro_torch.kernels.decode_attention import kernel as K

    def first():
        K._CALLS.clear()
        return fn()
    before, after = time_pair(first, fn)
    return dict(events_ms_first_call=before, events_ms=after)


def attention_row(what: str, res: dict, p: dict, fn) -> None:
    """Add a timed decode-attention row's plan, its device ms over
    SDPA's, and :func:`host_cut`, and log them beside its bound."""
    res.update(plan=p, sdpa_device_ratio=(
        res["device_ms"] / res["library_device_ms"]
        if res["device_ms"] and res["library_device_ms"] else None),
        **host_cut(fn))
    log(f"decode_attention row {what}: plan {plan_text(p)}; device "
        f"{res['device_ms']} ms, SDPA device {res['library_device_ms']} ms "
        f"(ratio {res['sdpa_device_ratio']}), bound {res['bound_ms']:.5f} "
        f"ms; events {res['events_ms']:.4f} ms, "
        f"{res['events_ms_first_call']:.4f} with a first call's host work")


def check_decode_attention(cfg, max_batch: int, max_len: int,
                           sweep: bool = True, ragged=None) -> dict:
    """Decode attention at the path's shape and around it, in bf16 and
    float32, against the plain version (:func:`held_attention`), with
    the slots past each row's position NaN-filled where the row does not
    attend to them (a stale cache tail the kernel must never read), and
    a repeat of every call bit-identical; then timed (CUDA events and
    device time) at the path's shape, and with ``sweep`` at L 8192,
    32768 and 131072 (every row at the last slot, so the whole cache is
    read) and on a ragged batch at L 32768 (positions L-1, L/2, 100, 0),
    each beside its bound from the slots the data needs, the plain
    version and ``scaled_dot_product_attention``. One call must be one
    launch; with ``sweep``, no slower than SDPA's (events, called in
    turn) at L <= 32768 with every row full, and at L 32768 within 2x
    its bound on the device (without it the times are recorded as
    found). ``ragged``: positions [B] of one more timed batch at the
    path's L (``out["ragged"]``), a served decode step's."""
    from repro_torch.kernels.decode_attention.kernel import (
        _n_sms, decode_attention_cuda, plan)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, valid_slots)

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, L = max_batch, max_len
    occupancy = check_occupancy()
    n_sms = _n_sms(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(4321)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.5

    def inputs(H, KV, L, dtype, pos, heads_alloc=None, hd=hd, q_scale=1.0):
        """q, k, v, positions; ``heads_alloc`` > KV makes k/v views of a
        wider cache (a head stride that is not KV * hd); ``q_scale``
        widens the scores (std 0.25 at 1). The random values past each
        row's position stand for stale slots."""
        n = heads_alloc or KV
        k = rand(B, L, n, hd).to(dtype)[:, :, :KV]
        v = rand(B, L, n, hd).to(dtype)[:, :, :KV]
        return ((rand(B, H, hd) * q_scale).to(dtype), k, v,
                torch.tensor(pos, dtype=torch.int32, device="cuda"))

    last = [L - 1] * B
    cases = [  # name, H, KV, L, window, positions, heads_alloc, hd, q_scale
        ("path", H, KV, L, 0, [0, L - 1, L // 2 + 3, 37], None, hd, 1.0),
        ("ragged L=1000", H, KV, 1000, 0, [999, 0, 517, 1], None, hd, 1.0),
        ("ring window 256", H, KV, 256, 256, [255, 256, 700, 1500], None,
         hd, 1.0),
        ("ring window 256, ragged L=250", H, KV, 250, 256,
         [249, 300, 1000, 0], None, hd, 1.0),
        ("ring window 256, early rows", H, KV, 256, 256, [255, 20, 5, 0],
         None, hd, 1.0),
        # a cache longer than its window: the ring rule slot by slot
        ("ring window 256, L=600", H, KV, 600, 256, [255, 700, 20, 1000],
         None, hd, 1.0),
        ("G=1", KV, KV, L, 0, last, None, hd, 1.0),
        ("G=8", 8 * KV, KV, L, 0, [5, L - 1, 600, 0], None, hd, 1.0),
        ("strided cache view", H, KV, L, 0, [L - 1, 3, 800, 64], 2 * KV,
         hd, 1.0),
        # the other head sizes the wrapper takes (32: the smoke model's)
        ("hd=64", H, KV, L, 0, [L - 1, 0, 300, 901], None, 64, 1.0),
        ("hd=32", H, KV, 1000, 0, [999, 12, 0, 640], None, 32, 1.0),
        # peaked scores (std 4): the running max moves between tiles and
        # splits, and the outputs are of order 1
        ("peaked scores", H, KV, L, 0, [L - 1, 700, 64, 3], None, hd, 16.0),
    ]
    errs = {}
    for dtype, bar in ((torch.bfloat16, 3e-2), (torch.float32, 2e-4)):
        for name, h, kv, length, w, pos, alloc, d, qs in cases:
            q, k, v, p = inputs(h, kv, length, dtype, pos, alloc, d, qs)
            want = decode_attention_ref(q, k, v, p, window=w)
            got = decode_attention_cuda(q, k, v, p, window=w)
            # the same call with every slot the rows do not attend to
            # NaN-filled: the stale tail must not reach the output
            stale = ~valid_slots(p, length, w)[:, :, None, None]
            k.masked_fill_(stale, float("nan"))
            v.masked_fill_(stale, float("nan"))
            nan_got = decode_attention_cuda(q, k, v, p, window=w)
            again = decode_attention_cuda(q, k, v, p, window=w)
            torch.cuda.synchronize()
            what = f"{name} {dtype}"
            e1 = held_attention(got, want, bar, what)
            e2 = held_attention(nan_got, want, bar, what + ", NaN tail")
            check(torch.equal(nan_got, again),
                  f"decode_attention {what}: repeat bit-identical")
            errs[(name, str(dtype))] = (max(e1[0], e2[0]), max(e1[1], e2[1]))
            log(f"decode_attention {name} [{B},{h},{d}] x L={length} "
                f"window={w} {str(dtype)[6:]}: max abs err "
                f"{errs[(name, str(dtype))][0]:.3g}, scaled "
                f"{errs[(name, str(dtype))][1]:.3g} (NaN tail too), repeat "
                f"bit-identical")

    def timed(L, pos):
        q, k, v, p = inputs(H, KV, L, torch.bfloat16, pos)
        valid = valid_slots(p, L)
        mask = valid[:, None, None, :]

        def kernel():
            return decode_attention_cuda(q, k, v, p)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        want = decode_attention_ref(q, k, v, p)
        err, scaled = held_attention(kernel(), want, 3e-2, f"timed L={L}")
        lib_err = attention_err(sdpa()[:, :, 0].float(), want)
        del want
        rows = int(valid.sum())                # cache slots the data needs
        bnd, by = bound_ms(rows * KV * hd * 2 * 2 + nbytes(q, p)
                           + B * H * hd * 4, 4 * rows * H * hd)
        prof = profile_calls(kernel)
        one_launch(prof, "decode_attention", f"decode_attention L={L}")
        ms, lib_ms = time_pair(kernel, sdpa)
        res = dict(ms=ms, device_ms=prof["device_ms"],
                   plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, p),
                                    reps=5, warm=1),
                   library_ms=lib_ms, library_device_ms=device_ms(sdpa),
                   library_max_abs_err=lib_err[0],
                   library_scaled_err=lib_err[1], max_abs_err=err,
                   scaled_err=scaled, bound_ms=bnd, bound_by=by,
                   slots_needed=rows, kernels_per_call=prof["per_call"],
                   positions=pos)
        attention_row(f"L={L} positions {pos}", res,
                      plan(B, H, KV, hd, L, n_sms), kernel)
        log(f"decode_attention timed L={L} positions {pos}: "
            f"{res['ms']:.4f} ms (device {res['device_ms']}), plain "
            f"{res['plain_ms']:.4f}, SDPA {res['library_ms']:.4f} (device "
            f"{res['library_device_ms']}), bound {bnd:.4f} ms ({by}); err "
            f"{err:.3g}, scaled {scaled:.3g}")
        return res
    out = timed(L, last)
    if ragged is not None:
        out["ragged"] = timed(L, list(ragged))
    if sweep:
        for n in (8192, 32768, 131072):
            out[f"long_context_L{n}"] = timed(n, [n - 1] * B)
            gc.collect()
            torch.cuda.empty_cache()
        out["ragged_L32768"] = timed(32768, [32767, 16384, 100, 0])
        for n, t in ((L, out), (8192, out["long_context_L8192"]),
                     (32768, out["long_context_L32768"])):
            check(t["ms"] <= t["library_ms"],
                  f"decode_attention L={n}: {t['ms']} ms no slower than "
                  f"scaled_dot_product_attention's {t['library_ms']} ms")
        t = out["long_context_L32768"]
        check(t["device_ms"] <= 2 * t["bound_ms"],
              f"decode_attention L=32768: device {t['device_ms']} ms within "
              f"2x its bound {t['bound_ms']} ms")
    timed_runs = [out] + [t for k, t in out.items()
                          if k.startswith(("long_context", "ragged"))]
    bf16 = [e for (_, dt), e in errs.items() if dt == "torch.bfloat16"]
    out["max_abs_err"] = max([e for e, _ in bf16]
                             + [t["max_abs_err"] for t in timed_runs])
    out["max_scaled_err"] = max([s for _, s in bf16]
                                + [t["scaled_err"] for t in timed_runs])
    f32 = [e for (_, dt), e in errs.items() if dt == "torch.float32"]
    out["max_abs_err_f32"] = max(e for e, _ in f32)
    out["max_scaled_err_f32"] = max(s for _, s in f32)
    out["occupancy"] = occupancy
    return out


# ---------------------------------------------------------------------------
# stage 4: the main path at full width
# ---------------------------------------------------------------------------
def serve(engine, prompts, n_new: int, **kw):
    from repro_torch.serving.request import Request

    reqs = [Request(prompt=p, max_new_tokens=n_new, ignore_eos=True, **kw)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    t0 = time.monotonic()
    engine.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for r in reqs:
        check(r.state.value == "finished" and len(r.output_tokens) == n_new,
              f"request {r.req_id} finished with {n_new} tokens")
        check(all(0 <= t < engine.cfg.vocab_size for t in r.output_tokens),
              "tokens inside the vocabulary")
    return reqs, wall


def moe_layers(cfg) -> list:
    from repro_torch.configs.base import MOE
    return [i for i, (_, f) in enumerate(cfg.layer_kinds()) if f == MOE]


def skewed_counts(cfg, gen_seed: int = 7, n_hot: int = 2):
    """Routed-token counts [n_layers, E] with ``n_hot`` (1 or 2) hot
    experts in every MoE layer."""
    import numpy as np
    rng = np.random.default_rng(gen_seed)
    E = cfg.moe.num_experts
    counts = rng.integers(0, 4, size=(cfg.num_layers, E))
    hot = np.ix_(moe_layers(cfg), [3 % E, 77 % E][:n_hot])
    counts[hot] += 400
    return counts


class PackRecorder:
    """Stands in for the MoE layer's route-pack entry point, counts its
    calls and those that asked for EPLB Collect's counts, and keeps a
    copy of the inputs of the first call of each shape, so that the
    path's own packs (and their counts) can be held against the plain
    versions afterwards."""

    def __init__(self, fn):
        self.fn, self.calls = fn, {}
        self.n_calls = self.n_counted = 0

    def __call__(self, x, dest, valid=None, eid=None, *,
                 use_kernel: bool = True, **kw):
        check(use_kernel, "a served MoE layer launches the route-pack "
                          "kernel (use_kernel is for training)")
        kw = {"k": 1, "quantize": False, **kw}     # the entry's defaults
        ids = kw.get("count_ids")
        self.n_calls += 1
        self.n_counted += ids is not None
        key = (x.shape[0], kw["n_dest"], kw["capacity"], x.dtype,
               kw["quantize"], valid is not None, eid is not None,
               None if ids is None else ids.dtype)
        if key not in self.calls:
            if ids is not None:
                kw["count_ids"] = ids.clone()
            self.calls[key] = (x.clone(), dest.clone(),
                               None if valid is None else valid.clone(),
                               None if eid is None else eid.clone(), kw)
        return self.fn(x, dest, valid, eid, **kw)


def replay_packs(rec: PackRecorder, cfg) -> tuple:
    """The path's own route-packs, one of each shape, on the kernel and
    on the plain version: exact, their counts too, and those equal to
    Collect's plain version on the pack's count ids: logical expert ids,
    which under a placement are not the physical slots the pack routes
    to. Every pack of the path must have counted. Returns the largest
    differences of the packs and of the counts."""
    from repro_torch.kernels.collect.ref import collect_ref
    from repro_torch.kernels.route_pack.kernel import route_pack_cuda
    from repro_torch.kernels.route_pack.ref import route_pack_ref

    E, err, c_err = cfg.moe.num_experts, 0.0, 0.0
    check(rec.n_counted == rec.n_calls,
          f"every MoE layer call's pack counted its ids "
          f"({rec.n_counted} of {rec.n_calls})")
    placed = plain = 0
    for (T, n_dest, cap, *_), (x, dest, valid, eid, kw) in rec.calls.items():
        what = f"path route_pack T={T} n_dest={n_dest}"
        got = route_pack_cuda(x, dest, valid, eid, **kw)
        err = max(err, pack_err(got, route_pack_ref(x, dest, valid, eid,
                                                    **kw), what))
        ids = kw["count_ids"]
        check(kw["n_count"] == E, f"{what}: counts over the {E} experts")
        c_err = max(c_err, exact(got.counts, collect_ref(ids, E),
                                 f"{what}: counts against collect_ref"))
        if n_dest > E:           # physical slots routed, logical counted
            placed += 1
            check(ids.dtype == torch.int64 and bool((ids < E).all()),
                  f"{what}: the router's logical ids counted")
        else:
            plain += 1
    shapes = sorted((T, n, c) for T, n, c, *_ in rec.calls)
    check(placed > 0 and plain > 0,
          "packs with and without a placement were replayed")
    check(any(T * cfg.moe.top_k > 256 for T, _, _ in shapes),
          "a pack spanning more than one rank-scan tile was replayed")
    log(f"path route_pack replayed exactly at (T, n_dest, C) {shapes}, "
        f"counts equal to collect_ref ({placed} with a placement)")
    return err, c_err


def make_engine(cfg, n_dp: int = 2, **kw):
    """The port's engine with random weights made on the card. A DP
    group whose slots' caches hold more tokens than its default KV block
    pool (512 blocks of 16) gets a pool of their size: a prompt's blocks
    are taken chunk by chunk, so a 32000-token prompt needs them."""
    from repro_torch.models.weights import flatten
    from repro_torch.serving.flowserve import FlowServeEngine
    from repro_torch.serving.kv_cache import BlockAllocator

    t0 = time.monotonic()
    engine = FlowServeEngine(cfg, device="cuda", n_dp_groups=n_dp, seed=0,
                             **kw)
    for d in engine.dps:
        a = d.allocator
        if d.max_batch * d.max_len > a.n_blocks * a.block_size:
            d.allocator = BlockAllocator(d.max_batch * d.max_len
                                         // a.block_size, a.block_size)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(engine.params).values())
    log(f"path: {cfg.name} depth {cfg.num_layers}, {n_params / 1e9:.2f} B "
        f"parameters made on the card in {time.monotonic() - t0:.1f} s")
    return engine


def run_path(engine, prompts, prompts_eplb, kernels,
             before_close=None) -> dict:
    """Serve ``prompts``, run a skewed EPLB pass, serve
    ``prompts_eplb``, with every launch count set to 0 just before and
    read just after: each of ``kernels`` must have launched. Then replay
    the path's packs and Collect calls, profile decode, call
    ``before_close(engine, requests)`` if given (its result goes under
    ``"stage"``), and close the engine."""
    from unittest import mock

    from repro_torch.kernels import runtime
    from repro_torch.models import ffn

    cfg = engine.cfg
    torch.cuda.reset_peak_memory_stats()
    rec = PackRecorder(ffn.fused_route_pack)
    with mock.patch.object(ffn, "fused_route_pack", rec):
        runtime.reset_launch_counts()
        reqs, wall = serve(engine, prompts, 16)
        before = dict(runtime.LAUNCHES)
        engine.record_expert_counts(skewed_counts(cfg))
        maps = engine.run_eplb()
        check(all(any(len(s) > 1 for s in maps[i].replicas.values())
                  for i in moe_layers(cfg)),
              "EPLB installed redundant replicas in every MoE layer")
        reqs2, wall2 = serve(engine, prompts_eplb, 16)
        launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
        check(all(launches.get(n, 0) > 0 for n in kernels),
              f"every kernel launched on the path: {launches}")
        check(launches["placement_gmm"] > before.get("placement_gmm", 0),
              "placement_gmm ran after EPLB")
        # EPLB Collect: in every route-pack launch, never on its own
        check(launches.get("collect", 0) == 0
              and fused.get("collect", 0) == launches["route_pack"]
              == rec.n_calls == PATH_PACKS[cfg.name],
              f"Collect ran in each of the path's {PATH_PACKS[cfg.name]} "
              f"route-pack launches and never alone: launches {launches}, "
              f"fused {fused}, MoE layer calls {rec.n_calls}")

        # the output is finite: logits of one prompt through the model
        tok = torch.tensor([engine.tokenizer.encode(prompts[0])],
                           device=engine.device)
        with torch.no_grad():
            logits, _ = engine.model.prefill(engine.params, tok)
        check(bool(torch.isfinite(logits).all()), "finite logits")
    replay_err, collect_err = replay_packs(rec, cfg)
    del rec
    profile = profile_decode(engine, overhead_window=True)
    check_decode_repeat(engine)
    everyone = reqs + reqs2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stage = before_close(engine, everyone) if before_close else None
    ttft = [r.ttft for r in everyone]
    tpot = [r.tpot for r in everyone]
    res = dict(launches=launches, fused=fused, launches_before_eplb=before,
               route_pack_replay_err=replay_err,
               collect_replay_err=collect_err,
               ttft_ms_mean=1e3 * statistics.mean(ttft),
               ttft_ms_max=1e3 * max(ttft),
               tpot_ms_mean=1e3 * statistics.mean(tpot),
               tpot_ms_max=1e3 * max(tpot),
               ttft_ms=[1e3 * t for t in ttft],
               # the first wave pays the process's cold costs
               ttft_ms_mean_by_wave=[1e3 * statistics.mean(r.ttft for r in w)
                                     for w in (reqs, reqs2)],
               serve_s=[wall, wall2],
               peak_mem_gib=peak,
               decode_profile=profile, stage=stage,
               tokens={r.prompt: list(r.output_tokens) for r in everyone},
               text=engine.tokenizer.decode(reqs[0].output_tokens))
    engine.close()
    log(f"path: {len(everyone)} requests x 16 tokens served in {wall:.2f} "
        f"s + {wall2:.2f} s; TTFT mean {res['ttft_ms_mean']:.1f} ms (by "
        f"wave {res['ttft_ms_mean_by_wave'][0]:.1f}, "
        f"{res['ttft_ms_mean_by_wave'][1]:.1f}), TPOT "
        f"mean {res['tpot_ms_mean']:.2f} ms, peak memory "
        f"{res['peak_mem_gib']:.2f} GiB; launches {launches}")
    return res


def check_decode_repeat(engine, placed: bool = True,
                        reuse: bool = False) -> None:
    """One full-batch decode step of a DP group (every slot prefilled
    with its own prompt, the EPLB placement installed where ``placed``),
    run twice from copies of the same cache with the same inputs: the
    logits must be bit-identical, so the MoE combine sums in a fixed
    order. ``reuse``: the slots are written into the idle group's own
    cache, not a new one (a 32768-slot cache is 20 GiB)."""
    from repro_torch.models.common import tree_map

    dp = engine.dps[0]
    be, B = dp.backend, dp.max_batch
    check((be._placement is not None) == placed,
          f"an EPLB placement is installed: {placed}")
    check(not reuse or all(s.free for s in dp.slots), "an idle DP group")
    cache = dp.cache if reuse else be.init_cache(B, dp.max_len)
    lens = []
    for i in range(B):
        toks = engine.tokenizer.encode(f"repeat {i}: " + PROMPTS[i % 4])
        cache1, _ = be.prefill(toks)
        be.write_slot(cache, cache1, i)
        lens.append(len(toks))
    tokens = torch.arange(7, 7 + B, dtype=torch.int32,
                          device=engine.device)[:, None]
    positions = torch.tensor(lens, dtype=torch.int32, device=engine.device)
    logits = []
    with torch.no_grad():
        for _ in range(2):
            out, _ = be.model.decode_step(be.params,
                                          tree_map(torch.clone, cache),
                                          tokens, positions,
                                          placement=be._placement)
            logits.append(out)
    torch.cuda.synchronize()
    check(torch.equal(logits[0], logits[1]),
          f"{engine.cfg.name}: a decode step run twice gives bit-identical "
          f"logits")
    log(f"decode repeat: {engine.cfg.name} full-batch decode step (B {B}) "
        f"twice from one cache: logits bit-identical")


def profile_decode(engine, steps: int = 4,
                   overhead_window: bool = False) -> dict:
    """Where a decode step's time goes: engine steps with every slot of
    both DP groups decoding, timed on the host clock, then the same
    number of steps under ``torch.profiler``, which gives device time by
    kernel; the idle share compares that busy time with the host-clock
    time of the same profiled steps. Runs after the path's launch counts
    were read.

    With ``overhead_window``, ``steps`` more engine steps run under a
    profiler that records only device activity (no host op events, so
    it adds little host time), and the host clock and the device busy
    are both read from that one window: ``overhead_step_ms`` and
    ``overhead_busy_ms`` (stage P's ``decode/iter_overhead`` row)."""
    from torch.profiler import ProfilerActivity

    from repro_torch.serving.request import Request

    n = sum(d.max_batch for d in engine.dps)
    for i in range(n):
        engine.submit(Request(prompt=f"profile prompt {i}",
                              max_new_tokens=3 * steps + 8, ignore_eos=True))
    for _ in range(3):                        # prefill + first decodes
        engine.step()
    check(all(d.active == d.max_batch for d in engine.dps),
          "every slot decoding while profiled")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / steps * 1e3
    with device_window([ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as w:
        t0 = time.monotonic()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) / steps * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                      for e in w.events if e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    attention = sum(ms for k, ms in kernels if "decode_attention" in k)
    check(0 < busy <= prof_wall, f"device busy {busy} ms per step within "
          f"the profiled step's {prof_wall} ms")
    window = {}
    if overhead_window:
        check(all(d.active == d.max_batch for d in engine.dps),
              "every slot decoding in the overhead window")
        with device_window() as w:
            t0 = time.monotonic()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            step_ms = (time.monotonic() - t0) / steps * 1e3
        busy_ms = sum(e.self_device_time_total / 1e3 / steps
                      for e in w.events)
        check(0 < busy_ms <= step_ms, f"overhead window: device busy "
              f"{busy_ms} ms per step within its {step_ms} ms")
        window = dict(overhead_step_ms=step_ms, overhead_busy_ms=busy_ms)
        log(f"decode overhead window (device activity only): engine step "
            f"{step_ms:.2f} ms (host clock), device busy {busy_ms:.2f} ms "
            f"in the same steps")
    engine.run_until_done()
    res = dict(engine_step_ms=wall, profiled_step_ms=prof_wall, **window,
               device_busy_ms=busy, device_idle_share=1.0 - busy / prof_wall,
               decode_attention_ms=attention,
               dp_groups=len(engine.dps),
               batch_per_group=engine.dps[0].max_batch,
               top_kernels_ms=[(k[:60], ms) for k, ms in kernels[:8]])
    log(f"decode profile: engine step {wall:.2f} ms (host clock), "
        f"{prof_wall:.2f} ms under the profiler, device busy {busy:.2f} ms, "
        f"idle share {res['device_idle_share']:.4f} of the profiled step; "
        f"decode attention {attention:.4f} ms of it")
    for k, ms in res["top_kernels_ms"]:
        log(f"  {ms:8.3f} ms/step  {k}")
    return res


# ---------------------------------------------------------------------------
# stage 6: MTP speculative decoding (§4.6) on the served DeepSeek-V3
# ---------------------------------------------------------------------------
class MTPRecorder:
    """Stands in for a DP group's ``decode_sample_mtp`` and checks each
    iteration as it runs: route-pack (with Collect's count block), and
    gmm before EPLB or placement_gmm after it, launch ``k + 1`` times per
    MoE layer, Collect never alone, ``_logits`` ``2k + 1`` times and
    never in the draft-cache fill pass. Keeps every iteration's block
    and accepted counts and which slots were busy."""

    def __init__(self, dp, logits_calls: dict, n_moe: int):
        self.dp, self.real = dp, dp.backend.decode_sample_mtp
        self.logits_calls, self.n_moe = logits_calls, n_moe
        self.iters = []
        dp.backend.decode_sample_mtp = self

    def __call__(self, *a, **kw):
        from repro_torch.kernels import runtime

        be, k = self.dp.backend, self.dp.mtp_k
        busy = [not s.free for s in self.dp.slots]
        before = (dict(runtime.LAUNCHES), dict(runtime.FUSED),
                  dict(self.logits_calls))
        out = self.real(*a, **kw)
        after = (runtime.LAUNCHES, runtime.FUSED, self.logits_calls)
        d = [{n: c.get(n, 0) - b.get(n, 0) for n in c}
             for b, c in zip(before, after)]
        moe = (k + 1) * self.n_moe
        ffn = "gmm" if be._placement is None else "placement_gmm"
        check(d[0].get("route_pack", 0) == d[0].get(ffn, 0) == moe
              and d[0].get("collect", 0) == 0
              and d[1].get("collect", 0) == moe
              and sum(d[0].values()) == 2 * moe,
              f"MTP k={k} iteration: route-pack (with Collect) and {ffn} "
              f"{moe} times each, nothing else: launches {d[0]}, fused "
              f"{d[1]}")
        check(d[2].get("all", 0) == 2 * k + 1 and d[2].get("fill", 0) == 0,
              f"MTP k={k} iteration: _logits {2 * k + 1} times, none in "
              f"the fill pass: {d[2]}")
        self.iters.append(dict(block=out[0].cpu(), n_acc=out[1].cpu(),
                               busy=torch.tensor(busy)))
        return out

    def restore(self) -> None:
        self.dp.backend.decode_sample_mtp = self.real


def mtp_counters(engine, n_moe: int) -> tuple:
    """Count ``_logits`` calls on the engine's model (and those made in
    a backend's fill pass) and install an :class:`MTPRecorder` on each
    DP group. Returns the counts, the recorders and a function that
    takes all of it off again."""
    calls = {"all": 0, "fill": 0, "in_fill": False}
    model = engine.model
    logits = model._logits

    def counted(*a, **kw):
        calls["all"] += 1
        calls["fill"] += calls["in_fill"]
        return logits(*a, **kw)
    model._logits = counted
    for dp in engine.dps:
        fill = dp.backend._mtp_fill

        def flagged(*a, _fill=fill, **kw):
            calls["in_fill"] = True
            try:
                return _fill(*a, **kw)
            finally:
                calls["in_fill"] = False
        dp.backend._mtp_fill = flagged
    recs = [MTPRecorder(dp, calls, n_moe) for dp in engine.dps]

    def undo():
        del model._logits
        for dp, rec in zip(engine.dps, recs):
            del dp.backend._mtp_fill
            rec.restore()
    return calls, recs, undo


def acceptance(iters) -> dict:
    """Acceptance over the busy slots of recorded iterations."""
    n = torch.cat([it["n_acc"][it["busy"]] for it in iters])
    k = iters[0]["block"].shape[1] - 1
    return dict(iterations=len(iters), slot_iterations=int(n.numel()),
                acceptance=float(n.sum()) / max(k * n.numel(), 1),
                tokens_per_iteration=float((n + 1).float().mean()),
                full_blocks=int((n == k).sum()),
                rejected_blocks=int((n < k).sum()))


def mtp_split(engine) -> dict:
    """Device time of one DP group's MTP iteration at a full batch, split
    into the draft chain, the verify chain and the fill pass, beside the
    whole iteration and the plain one-token ``decode_sample`` from the
    same state (``profile_calls``: each phase called alone on copies of
    the group's caches)."""
    from repro_torch.models.common import tree_map
    from repro_torch.serving.backend import TorchBackend
    from repro_torch.serving.request import Request

    dp = engine.dps[0]
    be = dp.backend
    for i in range(sum(d.max_batch for d in engine.dps)):
        engine.submit(Request(prompt=f"split prompt {i}", max_new_tokens=24,
                              ignore_eos=True))
    for _ in range(3):
        engine.step()
    check(dp.active == dp.max_batch, "every slot decoding while split")
    tokens, positions, temps, _ = dp._gather_step_inputs()
    cache = tree_map(torch.clone, dp.cache)
    mtp = tree_map(torch.clone, dp.mtp_cache)
    toks, pos = be._ints(tokens), be._ints(positions)
    t = torch.as_tensor(temps, device=be.device)
    with torch.no_grad():
        drafts, _ = be._mtp_draft(mtp, toks, pos, t, 0, False)
        _, hiddens = be._mtp_verify(cache, toks, pos, drafts)
        phases = {
            "draft": lambda: be._mtp_draft(mtp, toks, pos, t, 0, False),
            "verify": lambda: be._mtp_verify(cache, toks, pos, drafts),
            "fill": lambda: be._mtp_fill(mtp, hiddens, drafts, pos),
            "iteration": lambda: TorchBackend.decode_sample_mtp(
                be, cache, mtp, tokens, positions, temps, 0),
            "plain_decode_sample": lambda: TorchBackend.decode_sample(
                be, cache, tokens, positions, temps, 0)}
        res = {f"{n}_ms": profile_calls(fn, reps=5, warm=1)["device_ms"]
               for n, fn in phases.items()}
    engine.run_until_done()
    return res


def mtp_rollback(engine, rec: MTPRecorder) -> dict:
    """One ``inject_fault=True`` iteration of DP group 0 at a full batch,
    half the slots greedy and half at temperature 0.7: the faulted run
    and its replay each give the blocks and accepted counts of the
    fault-free iteration from the same state (``donate=False`` keeps
    it)."""
    from repro_torch.serving.request import Request

    dp = engine.dps[0]
    for i in range(sum(d.max_batch for d in engine.dps)):
        engine.submit(Request(prompt=f"rollback prompt {i}",
                              max_new_tokens=16, ignore_eos=True,
                              temperature=0.7 * ((i // 2) % 2)))
    for _ in range(3):
        engine.step()
    check(dp.active == dp.max_batch, "every slot decoding at the rollback")
    tokens, positions, temps, _ = dp._gather_step_inputs()
    check(bool((temps > 0).any() and (temps == 0).any()),
          "greedy and sampled slots at the rollback")
    n = len(rec.iters)
    dp.backend.decode_sample_mtp(dp.cache, dp.mtp_cache, tokens, positions,
                                 temps, dp.steps, donate=False)
    dp.decode_step_all(inject_fault=True)
    want, *runs = rec.iters[n:]
    check(len(runs) == 2 and all(
        torch.equal(r["block"], want["block"])
        and torch.equal(r["n_acc"], want["n_acc"]) for r in runs),
        "MTP rollback: the faulted iteration and its replay give the "
        "fault-free blocks and accepted counts")
    engine.run_until_done()
    return dict(block=want["block"].tolist(), n_acc=want["n_acc"].tolist())


def plain_key(req) -> tuple:
    """The key of a request's plain-engine tokens: its prompt and how
    many of its tokens were seeded from the radix prefix cache. A seeded
    prefill runs another chunk split than a cold one, which at full
    width is another function (MoE capacity is set per call from the
    chunk's token count; cuBLAS picks its kernel by the row count), so
    seeded and cold requests are held to plain requests seeded alike."""
    return req.prompt, req.prefix_hit_tokens


def plain_tokens(plain: dict, req) -> list:
    key = plain_key(req)
    check(key in plain, f"plain-engine tokens for (prompt, prefix hit) "
                        f"{key} (known: {sorted(plain)})")
    return plain[key]


def keyed(reqs) -> dict:
    """:func:`plain_key` → tokens of served requests."""
    return {plain_key(r): list(r.output_tokens) for r in reqs}


class OracleHead:
    """Stands in for a DP group's model: the MTP head's logits get a
    peak at the token the plain engine emitted at the next position of
    each slot's request (``plain``: :func:`plain_key` → tokens), so
    drafts are accepted as a well-trained head's would be; ``wrong`` names output indices whose draft is made wrong
    (a rejection in the middle of a block, leaving junk in both caches).
    The table of targets lives on the card and changes only when a
    slot's request does, so the head adds no host sync."""

    PEAK = 1e4

    def __init__(self, model, dp, plain: dict, wrong=()):
        self.model, self.dp, self.plain, self.wrong = model, dp, plain, wrong
        self.table = torch.zeros((dp.max_batch, dp.max_len),
                                 dtype=torch.long, device=dp.backend.device)
        self.owner = [None] * dp.max_batch

    def __getattr__(self, name):
        return getattr(self.model, name)

    def mtp_step(self, params, idx, hidden, tokens, positions, cache=None):
        for b, s in enumerate(self.dp.slots):
            if s.req is not None and s.req is not self.owner[b]:
                row = [0] * self.dp.max_len
                for i, t in enumerate(plain_tokens(self.plain, s.req)):
                    if s.req.prompt_len + i < self.dp.max_len:
                        row[s.req.prompt_len + i] = (
                            t + 1 if i in self.wrong else t)
                self.table[b] = torch.tensor(row, device=self.table.device)
                self.owner[b] = s.req
        logits, h, cache = self.model.mtp_step(params, idx, hidden, tokens,
                                               positions, cache)
        rows = torch.arange(self.table.shape[0], device=self.table.device)
        tgt = self.table[rows, torch.clamp(positions.long() + 1,
                                           max=self.table.shape[1] - 1)]
        logits = logits.index_put((rows, tgt), torch.full_like(
            tgt, self.PEAK, dtype=logits.dtype), accumulate=True)
        return logits, h, cache


def oracle_wave(engine, plain: dict, prompts, n_new: int,
                wrong=()) -> tuple:
    """Serve ``prompts`` with every DP group's head replaced by an
    :class:`OracleHead`: the tokens must still equal the plain engine's.
    Returns the requests and the host-clock wall time."""
    models = [dp.backend.model for dp in engine.dps]
    for dp in engine.dps:
        dp.backend.model = OracleHead(dp.backend.model, dp, plain, wrong)
    try:
        reqs, wall = serve(engine, prompts, n_new)
    finally:
        for dp, m in zip(engine.dps, models):
            dp.backend.model = m
    differ = [r.prompt for r in reqs
              if r.output_tokens != plain_tokens(plain, r)]
    check(not differ, f"mtp_k={engine.dps[0].mtp_k}, oracle head (wrong "
                      f"drafts at output indices {sorted(wrong)}): tokens "
                      f"equal the plain engine's; differ: {differ}")
    return reqs, wall


def mtp_path(cfg, params, k: int, plain: dict, placement) -> dict:
    """Serve the plain path's greedy prompts with ``mtp_k=k`` on the
    plain engine's weights, with the same EPLB pass: every request's
    tokens equal the plain engine's for its prompt, seeded alike
    (``plain``: :func:`plain_key` → tokens, from :func:`plain_table`),
    with the random head and, before
    EPLB and after it, with an oracle head. Then 4 requests at
    temperature 0.7 and one rolled-back iteration, all with the launch
    counts set to 0 just before and read just after. With the recorders
    taken off (each syncs the host once per iteration): the first greedy
    wave again, for TPOT, an oracle wave, the device split and a decode
    profile."""
    import numpy as np

    from repro_torch.kernels import runtime
    from repro_torch.serving.flowserve import FlowServeEngine

    engine = FlowServeEngine(cfg, params=params, device="cuda",
                             n_dp_groups=2, seed=0, max_batch=4, mtp_k=k)
    calls, recs, undo = mtp_counters(engine, len(moe_layers(cfg)))

    def since(marks):
        return [it for rec, n in zip(recs, marks) for it in rec.iters[n:]]

    def equal_plain(reqs, what):
        differ = [(plain_key(r), next(i for i, (a, b) in enumerate(
            zip(r.output_tokens, plain_tokens(plain, r))) if a != b),
            r.output_tokens, plain_tokens(plain, r)) for r in reqs
            if r.output_tokens != plain_tokens(plain, r)]
        check(not differ, f"MTP k={k}, {what}: every request gives the "
                          f"plain engine's tokens; differ (prompt, first "
                          f"index, MTP, plain): {differ}")

    runtime.reset_launch_counts()
    reqs, wall = serve(engine, PROMPTS, 16)
    greedy = [it for rec in recs for it in rec.iters]
    # full and partial blocks on gmm (no placement yet)
    marks = [len(rec.iters) for rec in recs]
    oracle_wave(engine, plain, PROMPTS, 16, wrong={5})
    before_eplb = acceptance(since(marks))
    check(before_eplb["full_blocks"] > 0
          and before_eplb["rejected_blocks"] >= len(PROMPTS),
          f"MTP k={k}, oracle head before EPLB: full blocks and the wrong "
          f"drafts rejected: {before_eplb}")
    engine.record_expert_counts(skewed_counts(cfg))
    engine.run_eplb()
    got = engine.dps[0].backend._placement
    check(all(np.array_equal(getattr(got, f).cpu(), getattr(placement, f)
                             .cpu()) for f in ("replica_slots", "n_replicas",
                                               "phys_owner")),
          "the MTP engine's EPLB pass installed the plain path's placement")
    marks = [len(rec.iters) for rec in recs]
    reqs2, wall2 = serve(engine, PROMPTS_EPLB, 16)
    greedy += since(marks)
    equal_plain(reqs + reqs2, "random head")
    marks = [len(rec.iters) for rec in recs]
    sampled, wall3 = serve(engine, PROMPTS, 16, temperature=0.7)
    temp = since(marks)
    marks = [len(rec.iters) for rec in recs]
    oracle_wave(engine, plain, PROMPTS_EPLB, 16)
    full = since(marks)
    marks = [len(rec.iters) for rec in recs]
    oracle_wave(engine, plain, PROMPTS_EPLB, 16, wrong={5})
    rejected = acceptance(since(marks))
    check(rejected["rejected_blocks"] >= len(PROMPTS_EPLB),
          f"MTP k={k}, oracle head: the wrong drafts were rejected")
    rollback = mtp_rollback(engine, recs[0])
    launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
    check(launches.get("collect", 0) == 0 and fused.get("collect", 0)
          == launches.get("route_pack", 0) > 0,
          f"MTP k={k}: Collect in every route-pack, never alone: "
          f"{launches}, {fused}")
    undo()
    timed, wall4 = serve(engine, PROMPTS, 16)
    equal_plain(timed, "unrecorded")
    oracle, wall6 = oracle_wave(engine, plain, PROMPTS_EPLB, 16)
    split = mtp_split(engine)
    profile = profile_decode(engine)
    engine.close()
    everyone = timed
    res = dict(k=k, launches=launches, fused=fused,
               greedy=acceptance(greedy), temperature_0_7=acceptance(temp),
               tpot_ms_mean=1e3 * statistics.mean(r.tpot for r in everyone),
               tpot_ms_max=1e3 * max(r.tpot for r in everyone),
               ttft_ms_mean=1e3 * statistics.mean(r.ttft for r in everyone),
               # the same prompts served earlier under the recorders
               tpot_ms_mean_recorded=1e3 * statistics.mean(
                   r.tpot for r in reqs + reqs2),
               oracle=acceptance(full), oracle_before_eplb=before_eplb,
               oracle_with_rejections=rejected,
               tpot_ms_mean_oracle=1e3 * statistics.mean(
                   r.tpot for r in oracle),
               serve_s=[wall, wall2, wall3, wall4, wall6],
               logits_calls=calls["all"],
               rollback=rollback, device_split=split,
               decode_profile=profile)
    g = res["greedy"]
    log(f"MTP k={k}: {len(reqs + reqs2)} greedy requests equal the "
        f"plain engine's tokens, {len(everyone)} more unrecorded; "
        f"acceptance {g['acceptance']:.4f}, "
        f"{g['tokens_per_iteration']:.4f} tokens per iteration over "
        f"{g['iterations']} DP-group iterations, TPOT per emitted token "
        f"{res['tpot_ms_mean']:.2f} ms (host clock, unrecorded waves; "
        f"{res['tpot_ms_mean_recorded']:.2f} ms recorded); at "
        f"temperature 0.7: "
        f"acceptance {res['temperature_0_7']['acceptance']:.4f}, "
        f"{res['temperature_0_7']['full_blocks']} full blocks (bonus "
        f"token) and {res['temperature_0_7']['rejected_blocks']} with a "
        f"rejection (residual resample); oracle head: "
        f"{res['oracle']['tokens_per_iteration']:.4f} tokens per "
        f"iteration, TPOT per emitted token {res['tpot_ms_mean_oracle']:.2f}"
        f" ms, lossless with a wrong draft per request too, before EPLB "
        f"({res['oracle_before_eplb']['full_blocks']} full blocks, "
        f"{res['oracle_before_eplb']['rejected_blocks']} with a rejection)"
        f" and after it")
    log(f"MTP k={k} device ms per DP-group iteration (B 4): draft "
        f"{split['draft_ms']:.3f}, verify {split['verify_ms']:.3f}, fill "
        f"{split['fill_ms']:.3f}, whole iteration "
        f"{split['iteration_ms']:.3f}; plain decode_sample "
        f"{split['plain_decode_sample_ms']:.3f}; engine step device busy "
        f"{profile['device_busy_ms']:.3f} ms")
    return res


def plain_table(cfg, params, cold: dict) -> dict:
    """The plain engine's greedy tokens for every (prompt, prefix hit)
    the MTP engines can meet: the served path's cold requests (``cold``:
    prompt → tokens), and each prompt served again on a plain engine of
    one DP group, which seeds it from its radix cache. That engine's
    cold requests must give the path's tokens (tokens do not depend on
    the DP group or the batch, before EPLB or after it)."""
    from repro_torch.serving.flowserve import FlowServeEngine

    engine = FlowServeEngine(cfg, params=params, device="cuda",
                             n_dp_groups=1, seed=0, max_batch=4)
    table = {(p, 0): t for p, t in cold.items()}
    for wave in (PROMPTS, PROMPTS, PROMPTS_EPLB, PROMPTS_EPLB):
        reqs, _ = serve(engine, wave, 16)
        for key, toks in keyed(reqs).items():
            check(table.setdefault(key, toks) == toks,
                  f"plain engines agree on (prompt, prefix hit) {key}")
    engine.close()
    seeded = {p: h for p, h in table if h}
    check(set(seeded) == {p for p in PROMPTS + PROMPTS_EPLB
                          if len(engine.tokenizer.encode(p)) > 16},
          f"every prompt longer than a block was served seeded: {seeded}")
    same = sum(table[p, h] == table[p, 0] for p, h in seeded.items())
    log(f"plain table: {len(table)} (prompt, prefix hit) entries; "
        f"{same} of {len(seeded)} seeded prompts give their cold tokens")
    return table


def mtp_stage(cfg, params, path: dict) -> dict:
    """MTP at k = 1 and 2 on the served DeepSeek-V3's weights, held to
    the plain engine's tokens (``path["tokens"]``: a
    :func:`plain_table`)."""
    res = {}
    for k in (1, 2):
        res[f"{DEEPSEEK}/mtp-k{k}"] = ({}, mtp_path(
            cfg, params, k, path["tokens"], path["placement"]))
        free(f"MTP k={k}")
    p = path["decode_profile"]["device_busy_ms"]
    log(f"MTP against the plain path: engine-step device busy "
        f"{p:.3f} ms plain, " + ", ".join(
            f"{r['decode_profile']['device_busy_ms']:.3f} ms at k="
            f"{r['k']}" for _, r in res.values())
        + f"; TPOT {path['tpot_ms_mean']:.2f} ms plain, " + ", ".join(
            f"{r['tpot_ms_mean']:.2f} ms at k={r['k']} (oracle head "
            f"{r['tpot_ms_mean_oracle']:.2f})" for _, r in res.values()))
    return res


# ---------------------------------------------------------------------------
# stages A-D: radix prefix KV, the pod-pooled directory, disaggregated PD
# ---------------------------------------------------------------------------
#: a 64-byte system prompt (with BOS 65 tokens: four full KV blocks and
#: one more token) that chat sessions share, each with its own turn
PD_SYSTEM = "System: you are the SuperPod's helper; answer briefly, kindly..."
#: waves served to completion in turn: a first turn; three more sessions
#: and a long unrelated prompt together (the pod directory routes them
#: across TEs and DP groups); a follow-up turn and a short prompt
PD_WAVES = [[PD_SYSTEM + " User: what is MLA?"],
            [PD_SYSTEM + " User: what is EPLB?",
             PD_SYSTEM + " User: what is MTP?",
             PD_SYSTEM + " User: and the UB plane?",
             "A long request with no shared prefix at all: it runs for more "
             "than a hundred bytes, so it prefills in several chunks."],
            [PD_SYSTEM + " User: what is MLA? Assistant: latent attention. "
             "User: and then?", "Another distinct prompt"]]
#: prompts that share no KV block (their first 16 tokens differ), most
#: of them longer than one 32-token chunk
PD_DISTINCT = ["Disaggregated prefill runs on its own task executors.",
               "KV streams chunk by chunk to the decode side over DistFlow.",
               "Backpressure defers the receive until a slot is free.",
               "Each pair of TEs has an isolated DistFlow instance.",
               "Short prompt", "Decode groups balance by KV usage."]
PD_CHUNK = 32
PD_KW = dict(n_prefill_te=2, n_decode_te=1, dp_per_te=2, max_batch=4,
             max_len=256, chunk_tokens=PD_CHUNK)


def kv_leaves(tree) -> list:
    from repro_torch.xccl.pd_transfer import _leaves
    return _leaves(tree)


def kv_equal(a, b) -> bool:
    la, lb = kv_leaves(a), kv_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def host_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median host-clock ms of ``fn`` with the device synchronised after
    each call (the host's work and the device's, end to end)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def chunked(be, toks, stops, cache=None, start: int = 0):
    """Prefill ``toks`` from ``start`` in chunks ending at ``stops`` (the
    last is ``len(toks)``) through ``be.prefill_chunk``; returns the
    cache and the last chunk's logits."""
    logits = None
    for end in stops:
        cache, logits = be.prefill_chunk(cache, toks[start:end], start,
                                         len(toks))
        start = end
    return cache, logits


def greedy_pair(be, caches, starts, n: int = 16) -> list:
    """Decode ``n`` greedy tokens after each batch-1 cache (``starts``:
    its prompt length and first token), all in one batch of 4 slots,
    the decode shape of the path (rows do not meet): the tokens of
    each."""
    import numpy as np

    B = 4
    cache = be.init_cache(B, be.max_len)
    for i, c in enumerate(caches):
        be.write_slot(cache, c, i)
    tok = np.zeros((B, 1), np.int32)
    pos = np.zeros((B,), np.int32)
    for i, (L, first) in enumerate(starts):
        tok[i, 0], pos[i] = first, L
    out = [[] for _ in caches]
    for _ in range(n):
        nxt, cache = be.decode_sample(cache, tok, pos,
                                      np.zeros((B,), np.float32), 0)
        nxt = nxt.cpu().numpy()
        for i in range(len(caches)):
            out[i].append(int(nxt[i]))
        tok[:, 0] = nxt
        pos += 1
    return out


def per(ms, n: int):
    """``ms / n``, or None where the time was not measured."""
    return None if ms is None else ms / n


def prefix_trio(engine) -> dict:
    """Stage A on the served DeepSeek-V3's first DP group, launch counts
    set to 0 just before and read just after: payloads, seeded caches
    and UB reads bit-identical copies; the same-split seeded prefill
    bit-identical to the cold one; seeded against a cold one-chunk
    prefill reported (logit error, greedy agreement); ``_cache_insert``,
    ``seed_prefill_cache`` and ``read_remote_kv`` timed."""
    from repro_torch.kernels import runtime
    from repro_torch.serving.dp_group import DPGroup
    from repro_torch.xccl.pd_transfer import pytree_bytes, slice_kv_chunk

    be = engine.dps[0].backend
    toks = engine.tokenizer.encode(PD_WAVES[2][0])
    n, S = len(toks), 4 * 16
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    # the same split: a cold prefill whose chunk ends at the seed boundary
    cold, log_c = chunked(be, toks, (32, S, n))
    payloads = [be.slice_prefill_kv(cold, toks, b * 16, (b + 1) * 16)
                for b in range(S // 16)]
    for b, p in enumerate(payloads):
        check(kv_equal(p, slice_kv_chunk(cold, b * 16, (b + 1) * 16)),
              f"block {b} payload equals its source")
    check(not {t.data_ptr() for t in kv_leaves(payloads)}
          & {t.data_ptr() for t in kv_leaves(cold)},
          "payloads are copies, not views of the prefill buffer")
    pulled = be.read_remote_kv(payloads)
    check(kv_equal(pulled, payloads) and not
          {t.data_ptr() for t in kv_leaves(pulled)}
          & {t.data_ptr() for t in kv_leaves(payloads)},
          "read_remote_kv: fresh copies, bit-identical")
    seeded = be.seed_prefill_cache(pulled, S, n)
    check(kv_equal(slice_kv_chunk(seeded, 0, S),
                   slice_kv_chunk(cold, 0, S)),
          "the seeded region equals the cold cache's")
    warm, log_s = be.prefill_chunk(seeded, toks[S:], S, n)
    torch.cuda.synchronize()
    launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
    check(bool((log_c == log_s).all()) and kv_equal(
        slice_kv_chunk(warm, 0, n), slice_kv_chunk(cold, 0, n)),
        "same-split seeded prefill: logits and valid-region KV "
        "bit-identical to the cold prefill (bf16)")
    check(launches.get("route_pack", 0) > 0 and launches.get("gmm", 0) > 0,
          f"the prefills ran the MoE kernels: {launches}")
    # seeded against a cold prefill of the whole prompt in one chunk:
    # another split, so another function at full width (reported)
    one, log_1 = be.prefill_chunk(None, toks, 0, n)
    rel = float(abs(log_s - log_1).max() / abs(log_1).max())
    first_s, first_1 = int(log_s.argmax()), int(log_1.argmax())
    gs, g1 = greedy_pair(be, [warm, one], [(n, first_s), (n, first_1)])
    # tokens agreeing from the first on, the prefill's own included
    agree = 0 if first_s != first_1 else 1 + next(
        (i for i, (a, b) in enumerate(zip(gs, g1)) if a != b), len(gs))
    # costs: a block's payload slice (the radix insert), the seed, the read
    dp = DPGroup(99, be, max_batch=1, max_len=be.max_len)

    def insert():
        dp.prefix_cache.clear()
        dp._cache_insert(toks, cold)
    n_blocks = n // 16
    nbytes = pytree_bytes(payloads)
    res = dict(
        launches=launches, fused=fused, prompt_tokens=n, seed_tokens=S,
        same_split_bit_identical=True,
        one_chunk_logit_rel_err=rel, one_chunk_argmax_equal=first_s == first_1,
        one_chunk_greedy_agree_tokens=agree,
        insert_blocks=n_blocks,
        insert_host_ms_per_block=host_ms(insert) / n_blocks,
        insert_device_ms_per_block=per(device_ms(insert), n_blocks),
        seed_host_ms_per_block=host_ms(
            lambda: be.seed_prefill_cache(pulled, S, n)) / len(payloads),
        seed_device_ms_per_block=per(device_ms(
            lambda: be.seed_prefill_cache(pulled, S, n)), len(payloads)),
        read_bytes=nbytes)
    dp.close()
    ms = time_ms(lambda: be.read_remote_kv(payloads))
    dev = device_ms(lambda: be.read_remote_kv(payloads))
    res.update(read_ms=ms, read_device_ms=dev,
               read_gb_per_s=nbytes / ms / 1e6,
               read_device_gb_per_s=None if not dev else nbytes / dev / 1e6,
               # a copy reads and writes each byte
               read_hbm_share=None if not dev
               else 2 * nbytes / (dev * 1e-3) / HBM_BYTES_PER_S)
    log(f"prefix trio ({engine.cfg.name}, {n} tokens, seed {S}): payloads, "
        f"UB reads and the seeded region bit-identical copies; same-split "
        f"seeded prefill bit-identical to cold; against one cold chunk: "
        f"logit rel err {rel:.4g}, first token equal {first_s == first_1}, "
        f"greedy agreement {res['one_chunk_greedy_agree_tokens']} of "
        f"{len(gs) + 1} tokens; _cache_insert "
        f"{res['insert_host_ms_per_block']:.4f} ms host / "
        f"{res['insert_device_ms_per_block']} ms device per block, "
        f"seed {res['seed_host_ms_per_block']:.4f} / "
        f"{res['seed_device_ms_per_block']}; read_remote_kv of "
        f"{nbytes} bytes {ms:.4f} ms ({res['read_gb_per_s']:.2f} GB/s "
        f"events), device {dev} ms (HBM share {res['read_hbm_share']})")
    return res


class PDRecorder:
    """Instruments a ``DisaggregatedPD``: each prefill group's final
    cache (its valid region) and skipped first chunks, the KV each
    decode group admits, and the launches made on each side (deltas of
    the counts around each call)."""

    def __init__(self, pd):
        from repro_torch.kernels import runtime
        from repro_torch.xccl.pd_transfer import slice_kv_chunk

        self.finals, self.admitted, self.skips = {}, {}, []
        self.side = {"prefill": {}, "decode": {}}

        def counted(side, fn):
            def call(*a, **kw):
                before = dict(runtime.LAUNCHES)
                out = fn(*a, **kw)
                acc = self.side[side]
                for k, v in runtime.LAUNCHES.items():
                    acc[k] = acc.get(k, 0) + v - before.get(k, 0)
                return out
            return call

        for te in pd.prefill_tes:
            for dp in te.dps:
                def run(work, _real=counted("prefill", dp.run_prefill_chunk)):
                    out = _real(work)
                    req = work.req
                    if out is not None:
                        self.finals[req.req_id] = slice_kv_chunk(
                            out[0], 0, req.prompt_len)
                    elif work.is_first and req.prefill_pos > work.end:
                        self.skips.append(req.req_id)
                    return out
                dp.run_prefill_chunk = run
        for te in pd.decode_tes:
            for dp in te.dps:
                def admit(req, kv, logits, _real=dp.admit):
                    self.admitted[req.req_id] = kv
                    return _real(req, kv, logits)
                dp.admit = admit
                dp.decode_step_all = counted("decode", dp.decode_step_all)


def serve_pd(pd, waves, n_new: int) -> list:
    """Serve each wave to completion before the next is submitted."""
    from repro_torch.serving.request import Request

    reqs = []
    for wave in waves:
        rs = [Request(prompt=p, max_new_tokens=n_new, ignore_eos=True)
              for p in wave]
        n0 = len(pd.finished)
        for r in rs:
            pd.submit(r)
        steps = 0
        while len(pd.finished) < n0 + len(rs):
            pd.step()
            steps += 1
            check(steps < 2000, "disaggregated PD finishes its wave")
        reqs += rs
    for te in pd.decode_tes:
        for d in te.dps:
            d.drain()
    for r in reqs:
        check(r.state.value == "finished" and len(r.output_tokens) == n_new,
              f"PD request {r.req_id} finished with {n_new} tokens")
    return reqs


def pd_summary(pd, reqs) -> dict:
    """What two runs of the same traffic must agree on: each request's
    TE choices, prefix hit, chunks and tokens; each prefill group's
    remote and local hits; the pins; each DistFlow pair's streams."""
    return dict(
        requests=[(r.prefill_te, r.decode_te, r.prefix_hit_tokens,
                   r.n_prefill_chunks, list(r.output_tokens)) for r in reqs],
        groups=[(d.dp_id, d.n_remote_hits, d.remote_hit_blocks,
                 d.prefix_cache.hit_blocks)
                for te in pd.prefill_tes for d in te.dps],
        pins=(None if pd.pod_dir is None else
              (pd.pod_dir.n_remote_acquires, pd.pod_dir.n_releases)),
        flows={k: (f.fabric, f.chunks_streamed, f.bytes_moved,
                   len(f.streams)) for k, f in sorted(pd.distflow.items())})


def pd_hits(pd, reqs, rec) -> dict:
    remote = sum(d.n_remote_hits for te in pd.prefill_tes for d in te.dps)
    seeded = sum(r.prefix_hit_tokens > 0 for r in reqs)
    return dict(local=seeded - remote, remote=remote,
                chunk_skips=len(rec.skips) if rec else None)


def pd_stage(cfg, params) -> dict:
    """Stage B: ``DisaggregatedPD`` on the served weights (2 prefill TEs
    x 2 DP groups, 1 decode TE x 2, 4 slots each, 32-token chunks, the
    pod directory on), launch counts set to 0 just before and read just
    after. Then the prefill's device time cold and seeded, and the same
    engine with ``kv_pool=False`` against the colocated engine on
    prompts that share no block: equal greedy tokens."""
    from repro_torch.core import DisaggregatedPD
    from repro_torch.kernels import runtime
    from repro_torch.serving.flowserve import FlowServeEngine

    t0 = time.monotonic()
    pd = DisaggregatedPD(cfg, params, device="cuda", kv_pool=True, **PD_KW)
    check(all(d.backend.params is params for te in pd.prefill_tes
              + pd.decode_tes for d in te.dps), "one parameter set")
    rec = PDRecorder(pd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    t1 = time.monotonic()
    reqs = serve_pd(pd, PD_WAVES, 16)
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    summary = pd_summary(pd, reqs)
    hits = pd_hits(pd, reqs, rec)
    check(hits["local"] > 0 and hits["remote"] > 0
          and hits["chunk_skips"] > 0,
          f"local hits, remote (pod directory) hits and chunk skips: {hits}")
    flows = summary["flows"].values()
    check(sum(f[1] for f in flows) >= 2 and not any(f[3] for f in flows),
          f"KV streamed in chunks, no stream left open: {summary['flows']}")
    check(set(rec.admitted) == set(rec.finals) == {r.req_id for r in reqs}
          and all(kv_equal(rec.admitted[i], rec.finals[i])
                  for i in rec.finals),
          "the KV each decode group admits is the prefill group's "
          "slice_kv_chunk(cache1, 0, L), bit for bit")
    check(summary["pins"][0] == summary["pins"][1] > 0 and not any(
        d._chunk_pins or d._chunk_locks
        for te in pd.prefill_tes for d in te.dps),
        f"every pin released exactly once: {summary['pins']}")
    for side, got in rec.side.items():
        check(got.get("route_pack", 0) > 0 and got.get("gmm", 0) > 0,
              f"route-pack and gmm launch on the {side} side: {got}")
    check(launches.get("collect", 0) == 0 and fused.get("collect", 0)
          == launches.get("route_pack", 0),
          f"Collect inside every route-pack: {launches}, {fused}")
    ttft = [r.ttft for r in reqs]
    tpot = [r.tpot for r in reqs]
    # the prefill's device time, cold and seeded from the pod's blocks,
    # for the follow-up turn as the prefill group runs it
    be = pd.prefill_tes[0].dps[0].backend
    toks = pd.tokenizer.encode(PD_WAVES[2][0])
    n = len(toks)
    hit = max(r.prefix_hit_tokens for r in reqs if r.prompt == PD_WAVES[2][0])
    stops = list(range(PD_CHUNK, n, PD_CHUNK)) + [n]
    cold, _ = chunked(be, toks, stops)
    payloads = [be.slice_prefill_kv(cold, toks, b * 16, (b + 1) * 16)
                for b in range(hit // 16)]
    warm_stops = list(range(hit + PD_CHUNK, n, PD_CHUNK)) + [n]
    # the cold split's chunks up to the seed: what the seed replaces
    prefix_stops = [e for e in stops if e < hit] + [hit]

    def warm():
        seeded = be.seed_prefill_cache(be.read_remote_kv(payloads), hit, n)
        return chunked(be, toks, warm_stops, seeded, hit)
    prefill = dict(prompt_tokens=n, hit_tokens=hit,
                   cold_chunks=len(stops), warm_chunks=len(warm_stops),
                   cold_device_ms=device_ms(lambda: chunked(be, toks, stops),
                                            reps=5, warm=1),
                   warm_device_ms=device_ms(warm, reps=5, warm=1),
                   prefix_chunks=len(prefix_stops),
                   prefix_device_ms=device_ms(
                       lambda: chunked(be, toks, prefix_stops), reps=5,
                       warm=1),
                   cold_ms=time_ms(lambda: chunked(be, toks, stops), reps=5,
                                   warm=1),
                   warm_ms=time_ms(warm, reps=5, warm=1))
    side = rec.side
    pd.close()
    del pd, rec, be, cold, payloads
    # kv_pool off, against the colocated engine, on prompts sharing no
    # block: the same prefill splits, and decode at B 4 drops nothing
    pd = DisaggregatedPD(cfg, params, device="cuda", kv_pool=False, **PD_KW)
    plain = serve_pd(pd, [PD_DISTINCT], 16)
    check(all(r.prefix_hit_tokens == 0 for r in plain),
          "the distinct prompts share no block")
    pd.close()
    eng = FlowServeEngine(cfg, params=params, device="cuda", n_dp_groups=2,
                          max_batch=PD_KW["max_batch"],
                          max_len=PD_KW["max_len"], chunk_tokens=PD_CHUNK)
    co, _ = serve(eng, PD_DISTINCT, 16)
    eng.close()
    differ = [r.prompt for r, c in zip(plain, co)
              if r.output_tokens != c.output_tokens]
    check(not differ, f"PD (kv_pool off) gives the colocated engine's "
                      f"tokens; differ: {differ}")
    del pd, eng
    res = dict(launches=launches, fused=fused, side_launches=side,
               hits=hits, flows=summary["flows"], pins=summary["pins"],
               prefix_hit_tokens=[r.prefix_hit_tokens for r in reqs],
               te=[(r.prefill_te, r.decode_te) for r in reqs],
               ttft_ms_mean=1e3 * statistics.mean(ttft),
               ttft_ms_max=1e3 * max(ttft),
               tpot_ms_mean=1e3 * statistics.mean(tpot),
               tpot_ms_max=1e3 * max(tpot), serve_s=wall,
               peak_mem_gib=peak, prefill=prefill,
               stage_s=time.monotonic() - t0)
    log(f"PD ({cfg.name}, 2 prefill TEs x 2 + 1 decode TE x 2): "
        f"{len(reqs)} requests x 16 tokens in {wall:.2f} s; hits {hits}, "
        f"pins {summary['pins']}, streams {summary['flows']}; TTFT mean "
        f"{res['ttft_ms_mean']:.1f} ms (max {res['ttft_ms_max']:.1f}), TPOT "
        f"mean {res['tpot_ms_mean']:.2f} ms (host clock); prefill of "
        f"{n} tokens: cold {prefill['cold_device_ms']} ms device "
        f"({prefill['cold_chunks']} chunks), seeded from {hit} tokens "
        f"{prefill['warm_device_ms']} ms ({prefill['warm_chunks']} "
        f"chunks), the cold prefix's {prefill['prefix_chunks']} chunks "
        f"{prefill['prefix_device_ms']} ms; peak memory {peak:.2f} GiB; launches by side {side}; "
        f"kv_pool off: {len(plain)} requests give the colocated engine's "
        f"tokens")
    return res


def pd_small_reference() -> None:
    """Stage C: the smoke DeepSeek-V3 (float32) through
    ``DisaggregatedPD`` with the pod directory, on the card and on the
    CPU: the same TE choices, hits, chunk skips, pins, streams and
    greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core import DisaggregatedPD
    from repro_torch.models.transformer import Model

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(DEEPSEEK + "-smoke"),
                              dtype="float32")
    out = []
    for dev in ("cpu", "cuda"):
        # one seed, the same weights on either device
        pd = DisaggregatedPD(cfg, Model(cfg).init(0, device=dev),
                             device=dev, kv_pool=True, **PD_KW)
        rec = PDRecorder(pd)
        reqs = serve_pd(pd, PD_WAVES, 8)
        out.append((pd_summary(pd, reqs), pd_hits(pd, reqs, rec)))
        pd.close()
    cpu, card = out
    hits = card[1]
    check(cpu == card, f"smoke PD: the card's TE choices, hits, streams "
                       f"and tokens equal the CPU's: {cpu} != {card}")
    check(all(v > 0 for v in hits.values()),
          f"smoke PD: local, remote hits and chunk skips: {hits}")
    log(f"small reference: {cfg.name} (f32) DisaggregatedPD with the pod "
        f"directory gives the CPU's greedy tokens, TE choices and hits "
        f"{hits} on the card")


def llama_prefix(engine) -> dict:
    """Stage D on the served Llama-4 (GQA), launch counts set to 0 just
    before and read just after: the 826-token prompt served alone, then
    again with another tail: its first 512-token chunk is skipped, 816
    tokens (51 blocks) seeded, only (816, 826) prefilled, and the seeded
    slot decodes through decode attention. Then the same split on the
    backend, (0, 512), (512, 816), (816, 826), against a seed from its
    payloads: logits and valid-region KV bit-identical."""
    from repro_torch.kernels import runtime
    from repro_torch.xccl.pd_transfer import slice_kv_chunk

    base = LLAMA_PROMPTS[0]
    tails = ("A new tail", "Other tail")
    check(all(t[0] != base[815] for t in tails),
          "the tails differ at their first byte")
    variants = [base[:815] + t for t in tails]
    enc = engine.tokenizer.encode
    n, S = len(enc(variants[0])), 816
    check(n == len(enc(variants[1])) == len(enc(base)) == 826,
          f"826-token prompts ({n})")
    ran, skipped = [], []
    for dp in engine.dps:
        def run(work, _real=dp.run_prefill_chunk):
            out = _real(work)
            req = work.req
            seeded = req.prompt in variants
            if out is None and work.is_first and req.prefill_pos > work.end:
                skipped.append((seeded, work.start, work.end))
            else:
                ran.append((seeded, work.start, work.end))
            return out
        dp.run_prefill_chunk = run
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    try:
        (first,), _ = serve(engine, [base], 16)
        # the first seeded turn meets new shapes (a 32-row chunk at
        # offset 816); the second is timed warm
        seeded = [serve(engine, [v], 16)[0][0] for v in variants]
    finally:
        for dp in engine.dps:
            del dp.run_prefill_chunk
    torch.cuda.synchronize()
    launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
    check(all(r.prefix_hit_tokens == S for r in seeded)
          and skipped == [(True, 0, 512)] * 2
          and [r for r in ran if r[0]] == [(True, S, n)] * 2,
          f"each variant seeded {S} tokens, skipped its first chunk and "
          f"prefilled ({S}, {n}) only: hits "
          f"{[r.prefix_hit_tokens for r in seeded]}, skipped {skipped}, "
          f"ran {ran}")
    check(launches.get("decode_attention", 0) > 0
          and launches.get("route_pack", 0) > 0,
          f"the seeded slot decoded through decode attention: {launches}")
    be = engine.dps[0].backend
    toks = enc(variants[0])
    cold, log_c = chunked(be, toks, (512, S, n))
    payloads = [slice_kv_chunk(cold, b * 16, (b + 1) * 16)
                for b in range(S // 16)]
    warm, log_s = be.prefill_chunk(
        be.seed_prefill_cache(be.read_remote_kv(payloads), S, n), toks[S:],
        S, n)
    check(bool((log_c == log_s).all()) and kv_equal(
        slice_kv_chunk(warm, 0, n), slice_kv_chunk(cold, 0, n)),
        "Llama-4 same-split seeded prefill at (0,512), (512,816), (816,826):"
        " logits and valid-region KV bit-identical (bf16)")
    res = dict(launches=launches, fused=fused, prefix_hit_tokens=S,
               skipped=skipped, ran=ran,
               base_prefix_hit_tokens=first.prefix_hit_tokens,
               seeded_ttft_ms=[1e3 * r.ttft for r in seeded],
               base_ttft_ms=1e3 * first.ttft,
               same_split_bit_identical=True)
    log(f"Llama-4 prefix: the 826-token prompt again with two other tails, "
        f"each seeded {S} tokens, skipped (0, 512), prefilled ({S}, {n}); "
        f"TTFT {res['seeded_ttft_ms'][0]:.1f} ms (new shapes), "
        f"{res['seeded_ttft_ms'][1]:.1f} ms (warm) against "
        f"{res['base_ttft_ms']:.1f} ms for the base (its hit "
        f"{first.prefix_hit_tokens}); launches {launches}; same split "
        f"bit-identical")
    return res


# ---------------------------------------------------------------------------
# stages E-G: disaggregated MoE-Attention (§5.2) and the launcher
# ---------------------------------------------------------------------------
#: the paper's decode batch per attention die, and the decode steps run
#: in each configuration of the MoE-Attention stage
MA_BATCH, MA_STEPS = 96, 16
#: (microbatches, quantize, placement) of the disaggregated driver; a
#: quantize=False configuration comes before its quantize=True twin
MA_CONFIGS = [(m, q, p) for p in (False, True) for m in (1, 2)
              for q in (False, True)]


@contextlib.contextmanager
def no_host_sync():
    """Raise on any host sync PyTorch makes inside the block."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def sync_detector_controls() -> dict:
    """The host-sync detector is armed: ``.item()`` inside
    :func:`no_host_sync` must raise. Also reports whether a copy of a
    numpy array to the card raises there, as ``apply_rope`` made on every
    call before it kept its frequencies on the card."""
    import numpy as np

    def raises(fn) -> bool:
        try:
            with no_host_sync():
                fn()
        except RuntimeError:
            return True
        return False
    res = dict(item=raises(lambda: torch.ones(1, device="cuda").item()),
               numpy_to_card=raises(lambda: torch.as_tensor(
                   np.arange(4.0), dtype=torch.float32, device="cuda")))
    check(res["item"], "no_host_sync raises on .item()")
    log(f"host-sync detector: .item() raises; a numpy-to-card copy "
        f"{'raises' if res['numpy_to_card'] else 'does not raise'}")
    return res


def ragged_batch(be, B: int, seed: int = 21, lens=(16, 200)):
    """A B-slot decode cache prefilled by the port, one prompt of
    ``lens`` (inclusive) random token ids per slot (so the slots sit at
    ragged positions), with each slot's greedy first token: (cache,
    tokens [B, 1] int32, positions [B] int32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(lens[0], lens[1] + 1, B)
    cache = be.init_cache(B, be.max_len)
    first = []
    for i, n in enumerate(lens):
        cache1, logits = be.prefill(
            rng.integers(3, be.model.cfg.vocab_size, n).tolist())
        be.write_slot(cache, cache1, i)
        first.append(int(logits.argmax()))
    dev = be.device
    return (cache, torch.tensor(first, dtype=torch.int32, device=dev)[:, None],
            torch.tensor(lens, dtype=torch.int32, device=dev))


def written_rows(cache, positions) -> list:
    """The slot of every cache leaf that a decode step at ``positions``
    writes (prefix leaves [B, L, ...], stacked ones [n_sb, B, L, ...]),
    copied."""
    b = torch.arange(positions.shape[0], device=positions.device)
    p = positions.long()
    return ([leaf[b, p].clone() for layer in cache.get("prefix", ())
             for leaf in layer.values()]
            + [leaf[:, b, p].clone() for pos in cache["blocks"].values()
               for leaf in pos.values()])


def step_profile(fn, steps: int = 4) -> dict:
    """``fn`` (one decode step) ``steps`` times under ``torch.profiler``:
    device busy ms per step (the CUDA kernels' own time), the host-clock
    ms per step of the same window, and the device's idle share."""
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with device_window([ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as w:
        t0 = time.monotonic()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) / steps * 1e3
    busy = sum(e.self_device_time_total for e in w.events) / 1e3 / steps
    check(0 < busy <= wall, f"device busy {busy} ms within the profiled "
                            f"step's {wall} ms")
    return dict(device_busy_ms=busy, profiled_step_ms=wall,
                device_idle_share=1.0 - busy / wall)


class DisaggRecorder:
    """Stands in for the disaggregated driver's route-pack and grouped
    FFN entry points and the attention module's decode attention: counts
    the calls by variant, keeps each pack's keep mask on the card (the
    dropped assignments, read after each step) and the inputs of the
    first call of each variant, for the replay against the plain
    versions. Copies nothing to the host."""

    def __init__(self, pack, ffn, attend):
        self.pack, self.ffn, self.attend = pack, ffn, attend
        self.calls, self.first, self.keeps = {}, {}, []

    def _note(self, key, make):
        self.calls[key] = self.calls.get(key, 0) + 1
        if key not in self.first:
            self.first[key] = make()

    def route_pack(self, x, dest, valid=None, eid=None, **kw):
        key = ("route_pack", kw["n_dest"], bool(kw.get("quantize")))
        self._note(key, lambda: (x.clone(), dest.clone(), dict(kw)))
        out = self.pack(x, dest, valid, eid, **kw)
        self.keeps.append(out.keep)
        return out

    def expert_ffn(self, buckets, wg, wu, wd, *, phys_owner=None):
        key = ("gmm" if phys_owner is None else "placement_gmm",
               buckets.shape[0])
        self._note(key, lambda: (buckets.clone(), (wg, wu, wd),
                                 phys_owner))
        return self.ffn(buckets, wg, wu, wd, phys_owner=phys_owner)

    def decode_attention(self, q, k, v, positions, **kw):
        self._note(("decode_attention",), lambda: (
            q.clone(), k.clone(), v.clone(), positions.clone(), kw))
        return self.attend(q, k, v, positions, **kw)

    def dropped(self) -> int:
        n = sum(int((~k).sum()) for k in self.keeps)
        self.keeps.clear()
        return n


def replay_disagg(rec: DisaggRecorder) -> dict:
    """The path's first call of each variant again on the kernel and on
    its plain version: route-pack exactly, the grouped FFNs within 3e-2
    (bf16), decode attention within 3e-2 absolute and scaled by the
    output. Returns the largest error by kernel."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref
    from repro_torch.kernels.gmm.kernel import gmm_cuda
    from repro_torch.kernels.gmm.ref import gmm_ref, placement_gmm_ref
    from repro_torch.kernels.route_pack.kernel import route_pack_cuda
    from repro_torch.kernels.route_pack.ref import route_pack_ref

    errs = {}
    for key, args in rec.first.items():
        name, what = key[0], f"moe-attn path {key}"
        if name == "route_pack":
            x, dest, kw = args
            err = pack_err(route_pack_cuda(x, dest, None, None, **kw),
                           route_pack_ref(x, dest, None, None, **kw), what)
        elif name == "decode_attention":
            q, k, v, pos, kw = args
            err, _ = held_attention(decode_attention_cuda(q, k, v, pos, **kw),
                                    decode_attention_ref(q, k, v, pos, **kw),
                                    3e-2, what)
        else:
            b, ws, own = args
            want = (gmm_ref(b, *ws) if own is None
                    else placement_gmm_ref(b, *ws, own))
            err = (gmm_cuda(b, *ws, own) - want).abs().max().item()
            check(err <= 3e-2, f"{what}: max abs err {err} <= 3e-2")
        errs[name] = max(errs.get(name, 0.0), err)
    torch.cuda.synchronize()
    return errs


def moe_attn_stage_times(dis, params, cache, tokens, positions) -> dict:
    """One MoE layer's four stages at microbatch 0 of the driver's split
    (CUDA events, median of 20, and device time under the profiler):
    the attention half, the pack (A2E, no wire on one card), the expert
    half and the unpack-and-combine (E2A), on a copy of ``cache``; and
    the whole layer at the full batch. Returns seconds per stage, as
    ``StageTimes`` takes them (a device time the profiler did not
    record is None)."""
    from repro_torch.configs.base import MOE
    from repro_torch.core import moe_attn_disagg as mad
    from repro_torch.models.common import microbatch_sizes, tree_map

    cfg = dis.cfg
    e = cfg.moe
    layer_i = next(i for i, (_, f) in enumerate(cfg.layer_kinds())
                   if f == MOE)
    p, loc = dis._block_params(layer_i)
    cache = tree_map(torch.clone, cache)
    c = dis._layer_cache(cache, loc)
    sz = microbatch_sizes(tokens.shape[0], dis.microbatches)[0]
    x = dis.model._embed(params, tokens[:sz])
    cm = {n: t[:sz] for n, t in c.items()}
    lp = dis.placement.layer(layer_i) if dis.placement is not None else None
    n_dest = e.num_experts if lp is None else int(lp[2].shape[0])
    owner = None if lp is None else lp[2]
    cap = mad.chunk_cap(sz, n_dest, e.top_k, dis.capacity_factor)

    def attn():
        return mad.attention_half(p, x, cfg=cfg, cache=cm,
                                  positions=positions[:sz])
    _, hn, idx, w, _, _ = attn()

    def pack():
        return mad.pack_dispatch(hn, idx, w, n_dest, cap, dis.quantize,
                                 placement=None if lp is None
                                 else (lp[0], lp[1]))
    buckets, state = pack()

    def experts():
        return mad.expert_half(p["ffn"], buckets, owner)
    out_b = experts()
    d = cfg.d_model
    xf = dis.model._embed(params, tokens)
    fns = dict(t_attn=attn, t_a2e=pack,
               t_a2e_quantize=lambda: mad.pack_dispatch(
                   hn, idx, w, n_dest, cap, True, placement=None
                   if lp is None else (lp[0], lp[1])),
               t_moe=experts,
               t_e2a=lambda: mad.unpack_combine(out_b, state, sz, d, cap),
               layer_full_batch=lambda: dis.moe_layer(layer_i, p, xf, c,
                                                      positions))
    dev = {k: device_ms(f) for k, f in fns.items()}
    return dict(events_s={k: time_ms(f) / 1e3 for k, f in fns.items()},
                device_s={k: None if v is None else v / 1e3
                          for k, v in dev.items()})


def moe_attn_stage(be) -> dict:
    """Stage E: ``DisaggregatedMoEAttention`` on the served engine's
    weights and EPLB table (``be``: its first DP group's backend, the
    placement installed), at B 96 from a cache the port prefilled with
    prompts of 16-200 tokens. Every configuration (microbatches 1 and 2,
    quantize off and on, no placement and the engine's table) runs 16
    decode steps teacher-forced by ``Model(decode_microbatches=m)``'s
    greedy tokens, with the launch counts set to 0 just before the
    disaggregated runs and read just after, each ``decode_step`` with
    host syncs made errors: the slots each step writes equal the
    monolithic step's bit for bit, the whole cache after the last step
    too; logits within 0.05 relative; the first step run twice from one
    cache bit-identical; then 16 steps run free, whose greedy agreement
    with the monolithic tokens is reported, beside the dropped
    assignments per step and the quantize=True logit error. The path's
    first pack, grouped FFN and decode attention of each variant are
    replayed on their plain versions; one MoE layer's stages are timed
    (microbatches 2) into a ``StageTimes`` and fed to the Fig. 19
    pipeline model of the full model on 768 dies, and one disaggregated
    and one monolithic step are profiled."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.core import moe_attn_disagg as mad
    from repro_torch.core import (DisaggregatedMoEAttention, DomainPipeline,
                                  StageTimes, plan_partition)
    from repro_torch.kernels import runtime
    from repro_torch.models import attention as A
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model

    cfg, params, table = be.model.cfg, be.params, be._placement
    check(table is not None, "the engine's EPLB table is installed")
    B, T = MA_BATCH, MA_STEPS
    t0 = time.monotonic()
    cache0, tok0, pos0 = ragged_batch(be, B)
    check(int(pos0.max()) + T < be.max_len, "every step fits the cache")
    build_s = time.monotonic() - t0

    def clone():
        return tree_map(torch.clone, cache0)

    def relerr(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item()

    # the monolithic runs: teacher tokens, logits, written slots, caches
    mono = {}
    with torch.no_grad():
        for m in (1, 2):
            model = Model(cfg, decode_microbatches=m)
            for placed in (False, True):
                c, tok, pos = clone(), tok0, pos0
                run = dict(tokens=[], logits=[], rows=[])
                for _ in range(T):
                    logits, _ = model.decode_step(
                        params, c, tok, pos,
                        placement=table if placed else None)
                    run["rows"].append(written_rows(c, pos))
                    run["logits"].append(logits)
                    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
                    run["tokens"].append(tok)
                    pos = pos + 1
                run["cache"] = c
                mono[m, placed] = run
    torch.cuda.synchronize()

    # the disaggregated runs: the stage's main path
    rec = DisaggRecorder(mad.fused_route_pack, mad.expert_ffn,
                         A.decode_attention)
    res = dict(batch=B, steps=T, cache_build_s=build_s,
               positions=[int(pos0.min()), int(pos0.max())], configs={},
               sync_detector=sync_detector_controls())
    unquantized = {}
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    with mock.patch.object(mad, "fused_route_pack", rec.route_pack), \
            mock.patch.object(mad, "expert_ffn", rec.expert_ffn), \
            mock.patch.object(A, "decode_attention", rec.decode_attention), \
            torch.no_grad():
        for m, q, placed in MA_CONFIGS:
            what = f"{cfg.name} moe-attn mb={m} quantize={q} placed={placed}"
            dis = DisaggregatedMoEAttention(
                Model(cfg), params, capacity_factor=cfg.moe.capacity_factor,
                quantize=q, microbatches=m,
                placement=table if placed else None)
            ref = mono[m, placed]
            c, tok, pos = clone(), tok0, pos0
            errs, drops, logits_all = [], [], []
            rec.dropped()
            for s in range(T):
                with no_host_sync():
                    logits, out = dis.decode_step(c, tok, pos)
                check(out is c, f"{what}: the cache written in place")
                drops.append(rec.dropped())
                rows = written_rows(c, pos)
                check(all(torch.equal(a, b)
                          for a, b in zip(rows, ref["rows"][s])),
                      f"{what}: step {s} writes the monolithic step's KV "
                      f"bit for bit")
                errs.append(relerr(logits, ref["logits"][s]))
                logits_all.append(logits)
                tok, pos = ref["tokens"][s], pos + 1
            check(kv_equal(c, ref["cache"]),
                  f"{what}: the whole cache after {T} steps bit-identical "
                  f"to the monolithic one's")
            check(max(errs) < 0.05, f"{what}: logits within 0.05 relative "
                                    f"of the monolithic step's: {errs}")
            # the first step twice from one cache
            twice = []
            for _ in range(2):
                with no_host_sync():
                    twice.append(dis.decode_step(clone(), tok0, pos0)[0])
            check(torch.equal(twice[0], twice[1]),
                  f"{what}: a step run twice gives bit-identical logits")
            # run free: its own greedy tokens
            c, tok, pos, same = clone(), tok0, pos0, []
            for s in range(T):
                with no_host_sync():
                    logits, _ = dis.decode_step(c, tok, pos)
                tok, pos = logits.argmax(-1, keepdim=True).to(torch.int32), \
                    pos + 1
                same.append(tok == ref["tokens"][s])
            same = torch.cat(same, dim=1)
            rec.dropped()
            r = dict(logit_rel_err_max=max(errs), logit_rel_err=errs,
                     dropped_per_step=drops,
                     dropped_mean=statistics.mean(drops),
                     free_run_agreement=same.float().mean().item(),
                     free_run_rows_equal=int(same.all(dim=1).sum()))
            if q:
                qerr = [relerr(a, b) for a, b in
                        zip(logits_all, unquantized.pop((m, placed)))]
                r["quantize_vs_off_logit_rel_err_max"] = max(qerr)
            else:
                unquantized[m, placed] = logits_all
            res["configs"][f"mb{m}-q{int(q)}-p{int(placed)}"] = r
            log(f"{what}: KV bit-identical over {T} steps, logits rel err "
                f"max {r['logit_rel_err_max']:.3e}, repeat bit-identical, "
                f"no host sync; dropped {r['dropped_mean']:.2f} of "
                f"{B * cfg.moe.top_k} assignments a step; free-run "
                f"greedy agreement {r['free_run_agreement']:.4f} "
                f"({r['free_run_rows_equal']} of {B} rows all {T} equal)"
                + (f"; quantize vs off logit rel err "
                   f"{r['quantize_vs_off_logit_rel_err_max']:.3e}" if q
                   else ""))
        torch.cuda.synchronize()
        launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
    del mono, unquantized
    want = {"route_pack", "gmm", "placement_gmm"} | (
        {"decode_attention"} if cfg.layer_kinds()[-1][0] == "attn" else set())
    check(all(launches.get(n, 0) > 0 for n in want)
          and fused.get("collect", 0) == 0,
          f"{cfg.name} moe-attn: {sorted(want)} launched, no Collect: "
          f"{launches}, {fused}")
    check(sum(n for key, n in rec.calls.items()
              if key[0] == "route_pack" and key[2]) > 0,
          "route-pack's quantize branch served the decode steps")
    res.update(launches=launches, fused=fused,
               calls_by_variant={str(k): n for k, n in rec.calls.items()})
    errs = replay_disagg(rec)
    del rec

    # stage times and the pipeline model, microbatches 2, no placement
    dis = DisaggregatedMoEAttention(Model(cfg), params,
                                    capacity_factor=cfg.moe.capacity_factor,
                                    microbatches=2)
    with torch.no_grad():
        st = moe_attn_stage_times(dis, params, cache0, tok0, pos0)
        full = get_config(cfg.name)
        # the device times (a persistent-kernel deployment keeps the
        # host out of the loop), the event times where one is missing
        fed = ("device_s" if all(v is not None
                                 for v in st["device_s"].values())
               else "events_s")
        times = StageTimes(*(st[fed][k] for k in ("t_attn", "t_a2e",
                                                  "t_moe", "t_e2a")))
        plan = plan_partition(full, 768)
        pipe = DomainPipeline(plan, times, full.num_layers)
        sched, steady = pipe.schedule(), pipe.steady_state()
        scratch = clone()
        mono2 = Model(cfg, decode_microbatches=2)
        dis_ms = device_ms(lambda: dis.decode_step(scratch, tok0, pos0))
        mono_ms = device_ms(lambda: mono2.decode_step(params, scratch, tok0,
                                                      pos0))
        prof = step_profile(lambda: dis.decode_step(scratch, tok0, pos0))
    res.update(
        stage_times_s=st,
        modeled_from_h100_stage_times=dict(
            plan=dataclasses.asdict(plan), n_layers=full.num_layers,
            stage_times=fed,
            schedule_iteration_s=sched.iteration_time,
            schedule_expert_busy=sched.expert_busy,
            schedule_attention_busy=sched.attention_busy,
            steady_iteration_s=steady.iteration_time,
            steady_expert_busy=steady.expert_busy,
            steady_attention_busy=steady.attention_busy),
        disagg_step_device_ms=dis_ms, monolithic_step_device_ms=mono_ms,
        disagg_step_profile=prof)
    for kind in ("events_s", "device_s"):
        log(f"{cfg.name} moe-attn stage ms (B {B}, microbatch of {B // 2},"
            f" {kind[:-2]}): " + ", ".join(
                f"{k} {'not measured' if v is None else f'{1e3 * v:.4f}'}"
                for k, v in st[kind].items()))
    log(f"{cfg.name} moe-attn, modeled from H100 stage times ({fed[:-2]};"
        f" not a SuperPod measurement): plan {plan.n_attention} attention + "
        f"{plan.n_expert} expert dies, {plan.n_dp_domains} domains x "
        f"{plan.dp_groups_per_domain}, {full.num_layers} layers: "
        f"schedule {1e3 * sched.iteration_time:.4f} ms per iteration "
        f"(expert busy {sched.expert_busy:.4f}), steady state "
        f"{1e3 * steady.iteration_time:.4f} ms (expert busy "
        f"{steady.expert_busy:.4f})")
    log(f"{cfg.name} moe-attn decode step at B {B} (mb 2): device "
        f"{dis_ms} ms disaggregated, {mono_ms} ms monolithic; "
        f"disaggregated under the profiler {prof['profiled_step_ms']:.3f} "
        f"ms a step, device busy {prof['device_busy_ms']:.3f}, idle share "
        f"{prof['device_idle_share']:.4f}")
    return {n: dict(max_abs_err=e) for n, e in errs.items()}, res


def moe_attn_small_reference() -> None:
    """Stage F: the smoke DeepSeek-V3 (float32) under
    ``DisaggregatedMoEAttention`` on the card and on the CPU, from
    ragged caches each device's backend prefilled: in every
    configuration (microbatches 1 and 2, quantize off and on, no
    placement and a table replicating two experts) 8 free-running
    greedy tokens per slot, equal on both."""
    from repro_torch.configs import get_config
    from repro_torch.core import DisaggregatedMoEAttention
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    from repro_torch.serving.backend import TorchBackend
    from repro_torch.serving.eplb import (ExpertMap, PlacementTable,
                                          build_placement_table)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(DEEPSEEK + "-smoke"),
                              dtype="float32")
    E = cfg.moe.num_experts
    maps = [None] * cfg.num_layers
    maps[moe_layers(cfg)[0]] = ExpertMap(E, {1: [1, E], 2: [2, E + 1]})
    table = build_placement_table(maps, E, pad_physical=E + 2,
                                  pad_replicas=2)
    out = {}
    for dev in ("cpu", "cuda"):
        be = TorchBackend(Model(cfg), Model(cfg).init(0, device=dev),
                          max_len=64, device=dev)
        tab = PlacementTable(*(torch.as_tensor(a, dtype=torch.int32,
                                               device=dev)
                               for a in (table.replica_slots,
                                         table.n_replicas,
                                         table.phys_owner)))
        cache0, tok0, pos0 = ragged_batch(be, 6, seed=5, lens=(4, 40))
        runs = {"first": tok0.flatten().tolist()}
        with torch.no_grad():
            for m, q, placed in MA_CONFIGS:
                dis = DisaggregatedMoEAttention(
                    be.model, be.params, quantize=q, microbatches=m,
                    placement=tab if placed else None)
                c, tok, pos, toks = tree_map(torch.clone, cache0), tok0, \
                    pos0, []
                for _ in range(8):
                    logits, _ = dis.decode_step(c, tok, pos)
                    check(bool(torch.isfinite(logits).all()),
                          "smoke moe-attn: finite logits")
                    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
                    toks.append(tok.flatten().tolist())
                    pos = pos + 1
                runs[m, q, placed] = toks
        out[dev] = runs
    check(out["cpu"] == out["cuda"],
          f"smoke moe-attn: the card's greedy tokens equal the CPU's in "
          f"every configuration: {out}")
    log(f"small reference: {cfg.name} (f32) DisaggregatedMoEAttention "
        f"gives the CPU's greedy tokens on the card in "
        f"{len(MA_CONFIGS)} configurations (8 steps, 6 ragged slots)")


def launcher_stage() -> dict:
    """Stage G: ``repro_torch.launch.serve.main`` in-process on the card,
    first as ``--arch deepseek-v3-671b`` and no other flag (the smoke
    config in bf16, 16 greedy tokens), then in both modes on the smoke
    DeepSeek-V3 in float32, its weights made from the seed on either
    device (the same weights): the printed lines, and the token ids
    behind them, equal the CPU's."""
    import io
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.serving.tokenizer import ByteTokenizer

    ids = []
    real_decode = ByteTokenizer.decode

    def decode(self, toks):
        ids.append([int(t) for t in toks])
        return real_decode(self, toks)

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                mock.patch.object(ByteTokenizer, "decode", decode):
            launch.main(list(argv))
        return buf.getvalue().splitlines()

    from repro_torch.kernels import runtime

    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.monotonic()
    lines = run("--arch", DEEPSEEK)
    check(len(lines) == 1 and " -> " in lines[0] and len(ids[-1]) == 16,
          f"launcher, no flag but the arch: one prompt served with 16 "
          f"tokens on the card: {lines}")
    default_s = time.monotonic() - t0
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False

    def f32(name):
        return dataclasses.replace(get_config(name), dtype="float32")
    res = dict(default_lines=lines, default_s=default_s)
    # one seed gives the card and the CPU the same weights
    with mock.patch.object(launch, "get_config", f32):
        for mode in ("colocated", "pd-disagg"):
            got = {}
            for dev in ("cpu", "cuda"):
                ids.clear()
                got[dev] = (run("--arch", DEEPSEEK, "--device", dev,
                                "--mode", mode, "--max-new-tokens", "8",
                                "--prompt", PROMPTS[0], "--prompt",
                                PROMPTS[1]), list(ids))
            check(got["cpu"] == got["cuda"] and len(got["cpu"][0]) == 2,
                  f"launcher {mode} (f32): the card prints the CPU's lines "
                  f"and tokens: {got}")
            res[mode] = got["cuda"][0]
    torch.cuda.synchronize()
    res.update(launches=dict(runtime.LAUNCHES), fused=dict(runtime.FUSED))
    check(res["launches"].get("route_pack", 0) > 0
          and res["launches"].get("gmm", 0) > 0,
          f"launcher: the MoE kernels launched on the card: {res}")
    log(f"launcher: --arch {DEEPSEEK} alone served on the card "
        f"({default_s:.1f} s): {lines[0]!r}; colocated and pd-disagg in "
        f"f32 print the CPU's lines and tokens")
    return res


# ---------------------------------------------------------------------------
# stages 7 and 12: the card against the CPU on a small input
# ---------------------------------------------------------------------------
def check_small_reference(arch: str, **overrides):
    """The smoke variant of ``arch`` in float32: greedy tokens of the
    engine on the card equal the CPU plain versions', before and after
    EPLB (where it has MoE layers; else two waves of the same prompts);
    where it has an MTP head, also with ``mtp_k=2`` (and an oracle
    head before EPLB and after it), whose tokens equal the plain
    engine's and whose every iteration's block and accepted counts are
    the CPU's. A model with cross-attention is served a memory made on
    the CPU from a seed, the same on both devices."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model, seeded_memory
    from repro_torch.serving.flowserve import FlowServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch + "-smoke"), dtype="float32",
                              **overrides)
    outs, blocks, tables = {}, {}, {}
    mem = (seeded_memory(cfg, torch.Generator().manual_seed(5), "cpu",
                         torch.float32) if Model(cfg).has_cross else None)
    for dev in ("cpu", "cuda"):
        params = Model(cfg).init(0, device=dev)
        for k in (0, 2) if cfg.mtp_num_layers else (0,):
            eng = FlowServeEngine(cfg, params, device=dev, n_dp_groups=2,
                                  max_batch=2, mtp_k=k, memory=mem)
            seen = []
            for d in eng.dps if k else ():
                real = d.backend.decode_sample_mtp

                def spy(*a, _real=real, _dp=d, **kw):
                    out = _real(*a, **kw)
                    busy = [i for i, s in enumerate(_dp.slots) if not s.free]
                    seen.append((_dp.dp_id, out[0][busy].tolist(),
                                 out[1][busy].tolist()))
                    return out
                d.backend.decode_sample_mtp = spy
            # the plain engine's tokens by (prompt, prefix hit): the
            # second wave's prompts are seeded from the first's blocks
            first = serve_any(eng, PROMPTS[:3])
            if k:   # drafts accepted, and one rejected, on gmm
                oracle_wave(eng, tables[dev], PROMPTS[:3], 8, wrong={3})
            if cfg.has_moe:
                eng.record_expert_counts(skewed_counts(cfg))
                eng.run_eplb()
            second = serve_any(eng, PROMPTS[:3])
            if k:   # and on placement_gmm
                oracle_wave(eng, tables[dev], PROMPTS[:3], 8, wrong={3})
            else:
                tables[dev] = keyed(first + second)
            eng.close()
            first, second = ([r.output_tokens for r in w]
                             for w in (first, second))
            outs[dev, k], blocks[dev, k] = (first, second), seen
    check(outs["cpu", 0] == outs["cuda", 0],
          "smoke engine: card tokens equal CPU tokens before and after EPLB")
    if cfg.mtp_num_layers:
        check(outs["cpu", 2] == outs["cpu", 0] == outs["cuda", 2],
              "smoke engine, mtp_k=2: tokens equal the plain engine's")
        check(blocks["cpu", 2] == blocks["cuda", 2] and blocks["cpu", 2],
              f"smoke engine, mtp_k=2: every iteration's greedy block and "
              f"accepted counts on the card equal the CPU's "
              f"({len(blocks['cpu', 2])} iterations)")
        n_acc = np.array([n for _, _, ns in blocks["cuda", 2] for n in ns])
        check(n_acc.max() == 2 and n_acc.min() < 2,
              "smoke engine, mtp_k=2: full and partial blocks accepted")
        log(f"small reference: mtp_k=2 blocks and accepted counts equal "
            f"on the card and the CPU over {len(blocks['cpu', 2])} "
            f"iterations, the oracle head's among them (accepted drafts "
            f"{int(n_acc.sum())})")
    log(f"small reference: {cfg.name} {overrides} (f32) greedy tokens on "
        f"the card equal the CPU plain versions', before and after EPLB")


def serve_any(engine, prompts):
    from repro_torch.serving.request import Request

    reqs = [Request(prompt=p, max_new_tokens=8, ignore_eos=True)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return reqs


# ---------------------------------------------------------------------------
# stages 5 and 11: the INT8 path of §4.7 on the served engines
# ---------------------------------------------------------------------------
def int8_token_rows(engine, reqs) -> dict:
    """M → token ids of the INT8 stage: the last token of four served
    requests (a DP group's decode batch), the first prompt unpadded and
    padded to its prefill bucket as the backend pads it, and every prompt
    and output token of the path, cycled to 512 (the calibration set)."""
    from repro_torch.serving.backend import _bucket_len
    from repro_torch.serving.tokenizer import PAD

    enc = engine.tokenizer.encode
    first = enc(PROMPTS[0])
    every = [t for r in reqs for t in enc(r.prompt) + list(r.output_tokens)]
    rows = {4: [r.output_tokens[-1] for r in reqs[:4]],
            len(first): first,
            _bucket_len(len(first)): first + [PAD] * (
                _bucket_len(len(first)) - len(first)),
            512: (every * (512 // len(every) + 1))[:512]}
    check(tuple(sorted(rows)) == INT8_M, f"INT8 token counts {sorted(rows)}")
    return rows


def hold_quant_dispatch(x, what: str) -> float:
    """quant-dispatch on ``x`` [T, d] against its plain version: the
    int8 values and the scales bit-identical."""
    from repro_torch.kernels.quant_dispatch.kernel import quant_dispatch_cuda
    from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref

    (q, sc), (rq, rsc) = quant_dispatch_cuda(x), quant_dispatch_ref(x)
    return max(exact(q, rq, f"quant_dispatch {what} values"),
               exact(sc, rsc, f"quant_dispatch {what} scales"))


def time_quant_dispatch(x, n_sms: int, rivals: bool = False) -> dict:
    """quant-dispatch on ``x`` [T, d] at one path shape: bit-identical to
    the plain version, its plan, one device kernel per call, device time
    and events, the plain version's events and the bound. With
    ``rivals``, also two other launches of the same function on the same
    input, each bit-identical to it and called in turn with it (events
    and device time): the two-pass launch — the plan's scalar path, what
    it gives an unaligned input: a warp or a block per row, the row read
    twice with scalar loads — and the launch the plan did not pick
    between one block a row and a cluster of blocks (``one_block`` where
    the plan splits the row, ``cluster_2`` where it does not)."""
    from repro_torch.kernels.quant_dispatch import kernel as qk
    from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref

    T, d = x.shape
    shape = f"[{T}, {d}] {str(x.dtype)[6:]}"
    what = f"quant_dispatch {shape}"
    aligned = x.data_ptr() % 16 == 0
    p = qk.plan(T, d, n_sms, aligned=aligned)
    err = hold_quant_dispatch(x, shape)
    q, sc = qk.quant_dispatch_cuda(x)
    bnd, by = bound_ms(nbytes(x, q, sc), 0)

    def kernel():
        return qk.quant_dispatch_cuda(x)
    r = dict(shape=[T, d], dtype=str(x.dtype), plan=list(p),
             max_abs_err=err,
             plain_ms=time_ms(lambda: quant_dispatch_ref(x)),
             library_ms=None, bound_ms=bnd, bound_by=by)
    prof = profile_calls(kernel)
    one_launch(prof, "quant_dispatch", what)
    dev, ms = prof["device_ms"], time_ms(kernel)
    line = ""
    if rivals:
        others = {"two_pass": qk.plan(T, d, n_sms, aligned=False)}
        if p.path in ("block", "cluster"):
            others["one_block" if p.cluster > 1 else "cluster_2"] = \
                qk.plan(T, d, n_sms, aligned=aligned,
                        cluster=1 if p.cluster > 1 else 2)
        q2, s2 = torch.empty_like(q), torch.empty_like(sc)
        for name, other in others.items():
            def rival(other=other):
                qk.launch(x, other, q2, s2)
            rival()
            exact(q2, q, f"{what}: the {name} launch, values")
            exact(s2, sc, f"{what}: the {name} launch, scales")
            p_dev, o_dev, _, _ = profile_turns(kernel, rival)
            p_ms, o_ms = time_pair(kernel, rival)
            r[name] = dict(plan=list(other), ms=o_ms, device_ms=o_dev,
                           plan_ms=p_ms, plan_device_ms=p_dev)
            line += (f"; {name} {other.path} x{other.cluster} in turn "
                     f"{o_ms:.4f} ms, device {o_dev:.4f} ms (the plan's "
                     f"{p_ms:.4f}, device {p_dev:.4f})")
    r.update(ms=ms, device_ms=dev, kernels_per_call=prof["per_call"],
             bound_share=bnd / dev)
    log(f"  {what} {p.path} (group {p.group}, vec {p.vec}, cluster "
        f"{p.cluster}, {p.blocks} blocks): {ms:.4f} ms, device {dev:.4f} ms "
        f"({bnd / dev:.0%} of the bound {bnd:.4f} ms by {by}), plain "
        f"{r['plain_ms']:.4f} ms" + line)
    return r


def rel_err(y, ref) -> float:
    return float(torch.linalg.norm(y.float() - ref.float())
                 / torch.linalg.norm(ref.float()))


def int8_stage(engine, reqs) -> dict:
    """The §4.7 pipeline on the served DeepSeek-V3 engine's layer-0
    weights and its cache. Launch counts are set to 0 just before the
    pipeline and read just after; the comparisons with the plain
    versions that need a kernel launch come after that."""
    from repro_torch import quant as Q
    from repro_torch.kernels import runtime
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_cuda
    from repro_torch.kernels.int8_matmul.kernel import plan as int8_plan
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    from repro_torch.kernels.quant_dispatch.kernel import quant_dispatch_cuda
    from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref
    from repro_torch.models.common import rms_norm

    t_stage = time.monotonic()
    cfg, p = engine.cfg, engine.params
    eps, m = cfg.norm_eps, cfg.mla
    l0 = p["prefix"][0]
    mla, mlp = l0["mixer"], l0["ffn"]
    silu = torch.nn.functional.silu
    ids = {M: torch.tensor(t, device="cuda")
           for M, t in int8_token_rows(engine, reqs).items()}
    with torch.no_grad():
        # the weights' inputs, computed with the port's functions: the
        # rms-normed embeddings (wq_a, wkv_a, wi_gate, the expert), their
        # q latent (wq_b) and their SwiGLU through the dense MLP (wo)
        x = {M: rms_norm(p["embed"][t], l0["mixer_norm"], eps)
             for M, t in ids.items()}
        acts = {"x": x,
                "cq": {M: rms_norm(v @ mla["wq_a"], mla["q_norm"], eps)
                       for M, v in x.items()},
                "h": {M: silu(v @ mlp["wi_gate"]) * (v @ mlp["wi_up"])
                      for M, v in x.items()}}
    weights = [("wq_a", mla["wq_a"], "x"), ("wkv_a", mla["wkv_a"], "x"),
               ("wq_b", mla["wq_b"].reshape(m.q_lora_rank, -1), "cq"),
               ("wi_gate", mlp["wi_gate"], "x"), ("wo", mlp["wo"], "h"),
               ("we_gate[3]", p["blocks"]["pos0"]["ffn"]["we_gate"][0][3],
                "x")]

    def plain_linear(x, qw):
        xq, xs = quant_dispatch_ref(x.reshape(-1, x.shape[-1]))
        return int8_matmul_ref(xq, xs, qw.values, qw.scale)

    # -- the pipeline, counted ------------------------------------------
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.monotonic()
    errs, lin_err, held, qws = {}, 0.0, [], {}
    for name, w, kind in weights:
        ws, s = Q.smooth_quant_pair(acts[kind][512], w)
        qn, qs = Q.quantize_weight_channelwise(w), \
            Q.quantize_weight_channelwise(ws)
        qws[name] = qn
        for M in INT8_M:
            xm = acts[kind][M]
            y16 = xm @ w                                # the bf16 product
            xs_ = xm / s[None]                          # f32 after smoothing
            yn, ys = Q.quantized_linear(xm, qn), Q.quantized_linear(xs_, qs)
            lin_err = max(lin_err,
                          exact(yn, plain_linear(xm, qn),
                                f"quantized_linear {name} M={M}"),
                          exact(ys, plain_linear(xs_, qs),
                                f"smoothed quantized_linear {name} M={M}"))
            held += [(f"{name} M={M} bf16", xm), (f"{name} M={M} smoothed",
                                                  xs_)]
            errs[f"{name} M={M}"] = dict(naive=rel_err(yn, y16),
                                         smoothed=rel_err(ys, y16))
        del ws, s, qs
    x512 = acts["x"][512]
    h = Q.hessian_from_calibration(x512)
    torch.cuda.synchronize()
    tg = time.monotonic()
    qg, gptq_w_rel = Q.gptq_quantize(mla["wkv_a"], h)
    torch.cuda.synchronize()
    gptq_s = time.monotonic() - tg
    del h
    y16 = x512 @ mla["wkv_a"]
    yg = Q.quantized_linear(x512, qg)
    lin_err = max(lin_err, exact(yg, plain_linear(x512, qg),
                                 "quantized_linear wkv_a GPTQ"))
    gptq = dict(seconds=gptq_s, weight_rel_err=gptq_w_rel,
                out_rel_err=rel_err(yg, y16),
                naive_out_rel_err=errs["wkv_a M=512"]["naive"])
    caches = []
    for g, dp in enumerate(engine.dps):
        c = dp.cache
        layers = [(f"prefix{i}", lc) for i, lc in enumerate(c["prefix"])]
        layers.append(("blocks.pos0", c["blocks"]["pos0"]))
        caches += [(f"dp{g} {n}", lc, Q.quantize_mla_cache(lc))
                   for n, lc in layers]
    torch.cuda.synchronize()
    pipeline_s = time.monotonic() - t0
    launches = dict(runtime.LAUNCHES)
    check(all(launches.get(n, 0) > 0 for n in ("quant_dispatch",
                                                 "int8_matmul")),
          f"the INT8 path launched both kernels: {launches}")
    log(f"int8: pipeline over {len(weights)} weights x M {INT8_M} (naive "
        f"and smoothed), GPTQ of wkv_a ({gptq_s:.2f} s in float64 on the "
        f"card) and {len(caches)} MLA caches in {pipeline_s:.2f} s; "
        f"launches {launches}; quantized_linear bit-identical to the plain "
        f"path everywhere")
    for k, e in errs.items():
        log(f"  {k}: rel err vs bf16 naive {e['naive']:.4g}, smoothed "
            f"{e['smoothed']:.4g}")
    log(f"  GPTQ wkv_a M=512: rel err {gptq['out_rel_err']:.4g} (naive "
        f"{gptq['naive_out_rel_err']:.4g}), weight rel err "
        f"{gptq_w_rel:.4g}")

    # -- quant-dispatch and INT8 matmul against their plain versions -----
    qd_err = 0.0
    for what, xh in held:
        qd_err = max(qd_err, hold_quant_dispatch(xh.reshape(-1, xh.shape[-1]),
                                                 what))
    kv_err, kv_rt = 0.0, 0.0
    for what, lc, qc in caches:
        rows = lc["ckv"].reshape(-1, lc["ckv"].shape[-1])
        rq, rsc = quant_dispatch_ref(rows)
        kv_err = max(kv_err,
                     exact(qc["ckv_q"].reshape(rows.shape), rq,
                           f"MLA cache {what} values"),
                     exact(qc["ckv_scale"].reshape(-1), rsc,
                           f"MLA cache {what} scales"))
        check(qc["krope"] is lc["krope"], "the RoPE part stays as it is")
        back = Q.dequantize_mla_cache(qc)["ckv"]
        kv_rt = max(kv_rt, (back.float() - lc["ckv"].float()).abs().max()
                    .item())
    log(f"int8: MLA caches {tuple(caches[0][1]['ckv'].shape)} per layer "
        f"quantized bit-identically to the plain version; round-trip max "
        f"abs err {kv_rt:.4g}")
    gen = torch.Generator(device="cuda").manual_seed(99)
    edge = torch.zeros((3, 300), device="cuda")
    edge[1, :8] = torch.tensor([127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5,
                                -126.5])
    edge[2] = torch.randn(300, generator=gen, device="cuda")
    qd_err = max(qd_err, hold_quant_dispatch(edge, "zero row, .5 quotients"))
    check(quant_dispatch_cuda(edge)[0][1, :8].tolist()
          == [127, 2, -4, 0, 0, 2, 126, -126], "half to even")
    for dt in (torch.float32, torch.bfloat16):
        qd_err = max(qd_err, hold_quant_dispatch(
            torch.randn((7, 32), generator=gen, device="cuda").to(dt),
            f"(7, 32) {dt}"))
        # a row that ends mid-group (warp path), ragged d (scalar), an
        # input 2 or 4 bytes off a 16-byte boundary (scalar)
        for T, d in ((5, 1000), (4, 7170)):
            qd_err = max(qd_err, hold_quant_dispatch(
                torch.randn((T, d), generator=gen, device="cuda").to(dt),
                f"({T}, {d}) {dt}"))
        off = torch.randn((4 * 7168 + 1,), generator=gen,
                          device="cuda").to(dt)[1:].view(4, 7168)
        qd_err = max(qd_err, hold_quant_dispatch(off, f"unaligned (4, 7168) "
                                                      f"{dt}"))
        # all-zero rows (+0 and -0) on the cluster and block paths, which
        # store them without the divide
        for T in (6, 300):
            z = torch.randn((T, 7168), generator=gen, device="cuda")
            z[1], z[T - 1] = 0.0, -0.0
            z[2, ::3] = -0.0
            z[2, 1::3] = 0.0
            z[2, 2::3] = 0.0
            qd_err = max(qd_err, hold_quant_dispatch(z.to(dt), f"zero rows "
                                                               f"({T}, 7168) "
                                                               f"{dt}"))
    mm_err, n_sms = lin_err, torch.cuda.get_device_properties(0) \
        .multi_processor_count
    # K-major weights ([N, K] row-major, viewed [K, N]); K not a multiple
    # of 16 at M 100, 37 and 130, and the last one's weight 1 byte off a
    # 16-byte boundary at a shape TMA would take: the ragged variant
    for M, K, N, skew in ((100, 300, 50, 0), (1, 64, 17, 0),
                          (37, 1000, 300, 0), (130, 136, 257, 0),
                          (4, 7168, 300, 1)):
        xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (N * K + skew,), generator=gen,
                           device="cuda", dtype=torch.int8)[skew:] \
            .view(N, K).t()
        xs_, ws_ = (torch.rand(n, generator=gen, device="cuda") + 0.1
                    for n in (M, N))
        p = int8_plan(M, K, N, n_sms, aligned=wq.data_ptr() % 16 == 0)
        mm_err = max(mm_err, exact(int8_matmul_cuda(xq, xs_, wq, ws_),
                                   int8_matmul_ref(xq, xs_, wq, ws_),
                                   f"int8_matmul ragged ({M},{K},{N}) "
                                   f"{p.path}"))
        log(f"int8: int8_matmul ({M},{K},{N}), weight base +{skew}: "
            f"bit-identical ({p.path} variant)")
    log("int8: quant_dispatch bit-identical at every input of the pipeline, "
        "a zero row, .5 quotients, (7, 32), (5, 1000), (4, 7170), an "
        "unaligned (4, 7168) and zero rows of +0 and -0 at (6, 7168) and "
        "(300, 7168)")

    # -- times at the path's shapes ----------------------------------------
    # quant-dispatch at every activation width (q latent 1536, d_model
    # 7168, d_ff 18432) and M, bf16 (as served) and f32 (after
    # SmoothQuant), other launches of it in turn at M 4, and the MLA
    # cache rows
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    by_shape = {}
    for kind in ("cq", "x", "h"):
        for M in INT8_M:
            for dt in (torch.bfloat16, torch.float32):
                xt = acts[kind][M].to(dt).contiguous()
                r = time_quant_dispatch(xt, n_sms, rivals=M == 4)
                by_shape[f"[{M}, {xt.shape[1]}] {str(dt)[6:]}"] = r
                if M == 4:
                    t = r["two_pass"]
                    check(t["plan_device_ms"] < t["device_ms"],
                          f"quant_dispatch [4, {xt.shape[1]}] {dt}: device "
                          f"{t['plan_device_ms']} ms below the two-pass "
                          f"launch's {t['device_ms']} ms, in turn")
    rows = caches[0][1]["ckv"].reshape(-1, caches[0][1]["ckv"].shape[-1])
    by_shape[f"MLA cache rows {list(rows.shape)} bfloat16"] = \
        time_quant_dispatch(rows, n_sms)
    big = by_shape[f"[512, {cfg.d_model}] bfloat16"]
    qd = dict(big, max_abs_err=max([qd_err] + [r["max_abs_err"] for r in
                                               by_shape.values()]),
              kv_max_abs_err=kv_err,
              kv_round_trip_max_abs_err=kv_rt, library="none",
              target_device_ms=0.0066,
              target_met=big["device_ms"] <= 0.0066, by_shape=by_shape)
    qw = qws["wi_gate"]
    K, N = qw.values.shape
    check(qw.values.t().is_contiguous(), "QTensor keeps wi_gate K-major")
    mm = {}
    for M in INT8_M:
        xq, xs_ = quant_dispatch_cuda(acts["x"][M])

        def kernel():
            return int8_matmul_cuda(xq, xs_, qw.values, qw.scale)
        out = kernel()
        ops = 2 * M * K * N
        bnd, by = bound_ms(nbytes(xq, xs_, qw.values, qw.scale, out), ops,
                           INT8_OP_PER_S)
        prof = profile_calls(kernel)
        one_launch(prof, "int8_matmul", f"int8_matmul M={M}")
        r = dict(shape=[M, K, N], plan=list(int8_plan(M, K, N, n_sms)),
                 device_ms=prof["device_ms"],
                 kernels_per_call=prof["per_call"],
                 int8_peak_share=ops / INT8_OP_PER_S * 1e3
                 / prof["device_ms"],
                 plain_ms=time_ms(lambda: int8_matmul_ref(
                     xq, xs_, qw.values, qw.scale)),
                 bound_ms=bnd, bound_by=by)
        if M > 16:                # torch._int_mm takes M > 16
            def lib():
                return (torch._int_mm(xq, qw.values).float() * xs_[:, None]
                        * qw.scale[None, :])
            ms, lib_ms = time_pair(kernel, lib)
            r.update(ms=ms, library_ms=lib_ms, library_ratio=ms / lib_ms,
                     library="torch._int_mm + the same epilogue, on the "
                             "same K-major weight",
                     library_device_ms=device_ms(lib),
                     library_max_abs_err=(lib() - out).abs().max().item())
        else:
            r.update(ms=time_ms(kernel), library_ms=None,
                     library="none at this shape (torch._int_mm takes "
                             "M > 16)")
        mm[M] = r
        log(f"  int8_matmul M={M} {r['plan']}: {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} ms ({r['int8_peak_share']:.1%} of the "
            f"int8 peak; bound {bnd:.4f} ms by {by}), library "
            f"{r['library_ms']} (kernel/library "
            f"{r.get('library_ratio')})")
    check(mm[512]["ms"] < mm[512]["library_ms"],
          f"int8_matmul M=512: {mm[512]['ms']} ms faster than torch._int_mm "
          f"+ the epilogue's {mm[512]['library_ms']} ms, called in turn")
    mm4 = dict(mm[4], max_abs_err=mm_err, by_m=mm)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  quant_dispatch [512, 7168] bf16: device {qd['device_ms']:.4f} "
        f"ms against the target 0.0066 ms: "
        f"{'met' if qd['target_met'] else 'missed'}")
    return dict(kernels={"quant_dispatch": qd, "int8_matmul": mm4},
                launches=launches, output_rel_err=errs, gptq=gptq,
                pipeline_s=pipeline_s, peak_mem_gib=peak,
                stage_s=time.monotonic() - t_stage)


def int8_kv_stage(engine, reqs) -> dict:
    """The INT8 GQA cache on the served Llama-4 engine: each layer's k/v
    of each DP group quantized per (position, head) with launch counts
    set to 0 just before and read just after, bit-identical to the plain
    version; then INT8 attention scores at the path's shape, one query
    row per KV head, against the CPU."""
    from repro_torch import quant as Q
    from repro_torch.kernels import runtime
    from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref

    layers = [(f"dp{g} {pos}", lc) for g, dp in enumerate(engine.dps)
              for pos, lc in dp.cache["blocks"].items()]
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    quantized = [(w, lc, Q.quantize_gqa_cache(lc)) for w, lc in layers]
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    check(launches.get("quant_dispatch", 0) > 0,
          f"the INT8 KV path launched quant_dispatch: {launches}")
    err, rt = 0.0, 0.0
    for what, lc, qc in quantized:
        back = Q.dequantize_gqa_cache(qc, lc["k"].dtype)
        for n in ("k", "v"):
            rows = lc[n].reshape(-1, lc[n].shape[-1])
            rq, rsc = quant_dispatch_ref(rows)
            err = max(err, exact(qc[n + "_q"].reshape(rows.shape), rq,
                                 f"GQA cache {what} {n} values"),
                      exact(qc[n + "_scale"].reshape(-1), rsc,
                            f"GQA cache {what} {n} scales"))
            rt = max(rt, (back[n].float() - lc[n].float()).abs().max()
                     .item())
    # scores: q [B, KV, hd] per row, k [B, L, KV, hd] per (row, head) over
    # all positions, the scale shapes the reference's broadcast takes
    k = layers[0][1]["k"][0]
    B, L, KV, hd = k.shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, KV, hd), generator=gen, device="cuda").to(k.dtype)
    qq, qs = Q.quantize_act_tokenwise(q)
    kh, ks = Q.quantize_act_tokenwise(
        k.permute(0, 2, 1, 3).reshape(B, KV, L * hd))
    per_head = k.permute(0, 2, 1, 3).reshape(B * KV, L * hd)
    err = max(err, hold_quant_dispatch(per_head, "k per head"))
    kq = kh.reshape(B, KV, L, hd).permute(0, 2, 1, 3)
    got = Q.int8_attention_scores(qq, qs, kq, ks)
    want = Q.int8_attention_scores(qq.cpu(), qs.cpu(), kq.cpu(), ks.cpu())
    sc_err = exact(got.cpu(), want, "int8_attention_scores card vs CPU")
    log(f"int8-kv: {len(layers)} GQA caches {tuple(k.shape)} quantized "
        f"bit-identically to the plain version (round-trip max abs err "
        f"{rt:.4g}); launches {launches}; int8_attention_scores "
        f"[{B},{KV},{hd}] x [{B},{L},{KV},{hd}] on the card equal the CPU's")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = layers[0][1]["k"].reshape(-1, hd)
    by_shape = {
        f"GQA cache rows {list(rows.shape)} bfloat16":
            time_quant_dispatch(rows, n_sms),
        f"k per head {list(per_head.shape)} bfloat16":
            time_quant_dispatch(per_head.contiguous(), n_sms)}
    return dict(kernels={"quant_dispatch": dict(max_abs_err=err,
                                                by_shape=by_shape)},
                launches=launches, round_trip_max_abs_err=rt,
                scores_max_abs_err=sc_err)


# ---------------------------------------------------------------------------
def free(what: str) -> None:
    """Drop what the last stage left on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{what}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
        f"allocated")


def deepseek_stages(get_config) -> dict:
    """Stages 3-7 on DeepSeek-V3 cut to 4 layers, with its MTP head."""
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=4)
    check(cfg.mtp_num_layers == 1, "DeepSeek-V3 has its MTP head")
    max_batch = 4
    t0 = time.monotonic()
    kern = check_moe_kernels(
        cfg, path_token_counts(PROMPTS + PROMPTS_EPLB, max_batch), max_batch,
        off_path=(512,))
    free(f"kernel checks: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    engine = make_engine(cfg, max_batch=max_batch)
    path = run_path(engine, PROMPTS, PROMPTS_EPLB,
                    ("route_pack", "gmm", "placement_gmm"),
                    before_close=int8_stage)
    fold_replays(kern, path)
    int8 = path.pop("stage")
    free(f"path: {time.monotonic() - t0:.1f} s (the INT8 stage "
         f"{int8['stage_s']:.1f} s of it); sample output {path['text']!r}")

    t0 = time.monotonic()
    trio = prefix_trio(engine)
    pd = pd_stage(cfg, engine.params)
    free(f"prefix trio and PD: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    table = plain_table(cfg, engine.params, path.pop("tokens"))
    mtp = mtp_stage(cfg, engine.params, dict(
        path, tokens=table, placement=engine.dps[0].backend._placement))
    free(f"MTP: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    moe_attn = moe_attn_stage(engine.dps[0].backend)
    free(f"MoE-Attention: {time.monotonic() - t0:.1f} s")

    del engine
    free("DeepSeek-V3 engine")
    t0 = time.monotonic()
    cfg1 = dataclasses.replace(cfg, num_layers=R0_DEPTH,
                               prefix_layers=cfg.prefix_layers[:R0_DEPTH])
    params = Model(cfg1).init(0, device="cuda")
    r0 = r0_init(cfg1, params)
    del params
    free(f"R0: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    check_small_reference(DEEPSEEK)
    pd_small_reference()
    moe_attn_small_reference()
    launch = launcher_stage()
    log(f"small reference and launcher: {time.monotonic() - t0:.1f} s")
    return {DEEPSEEK: (kern, path), DEEPSEEK + "/prefix": ({}, trio),
            DEEPSEEK + "/pd": ({}, pd),
            DEEPSEEK + "/R0": ({}, dict(r0, launches={})), **mtp,
            DEEPSEEK + "/moe-attn": moe_attn,
            DEEPSEEK + "-smoke/launch": ({}, launch),
            DEEPSEEK_INT8: (int8.pop("kernels"), int8)}


def fold_replays(kern: dict, path: dict) -> None:
    """The path's replayed route-packs and their counts count in the
    kernels' errors."""
    for n in ("route_pack", "collect"):
        kern[n]["max_abs_err"] = max(kern[n]["max_abs_err"],
                                     path[f"{n}_replay_err"])


def llama_stages(get_config) -> dict:
    """Stages 8-12 on Llama-4 Maverick cut to 2 layers."""
    from repro_torch.configs.base import MOE

    cfg = dataclasses.replace(get_config(LLAMA), num_layers=2)
    max_batch, max_len, chunk = 4, 1024, 512
    t0 = time.monotonic()
    engine = make_engine(cfg, max_batch=max_batch, max_len=max_len,
                         chunk_tokens=chunk)
    counts = path_token_counts(LLAMA_PROMPTS + LLAMA_PROMPTS_EPLB, max_batch,
                               max_len, chunk)
    check(chunk in counts, f"a {chunk}-token chunk among the packs {counts}")
    moe = engine.params["blocks"][
        f"pos{[f for _, f in cfg.layer_pattern].index(MOE)}"]["ffn"]
    kern = check_moe_kernels(
        cfg, counts, max_batch,
        [moe[n][0] for n in ("we_gate", "we_up", "we_down")])
    del moe
    kern["decode_attention"] = check_decode_attention(cfg, max_batch,
                                                      max_len)
    free(f"kernel checks: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    path = run_path(engine, LLAMA_PROMPTS, LLAMA_PROMPTS_EPLB,
                    ("route_pack", "gmm", "placement_gmm",
                     "decode_attention"),
                    before_close=lambda e, reqs: dict(
                        kv=int8_kv_stage(e, reqs), prefix=llama_prefix(e),
                        moe_attn=moe_attn_stage(e.dps[0].backend)))
    del engine
    fold_replays(kern, path)
    kv, prefix, moe_attn = (path["stage"][n]
                            for n in ("kv", "prefix", "moe_attn"))
    path.pop("stage")
    path.pop("tokens")
    free(f"path: {time.monotonic() - t0:.1f} s; sample output "
         f"{path['text']!r}")

    t0 = time.monotonic()
    check_small_reference(LLAMA, num_heads=10, num_kv_heads=2, head_dim=32)
    log(f"small reference: {time.monotonic() - t0:.1f} s")
    return {LLAMA: (kern, path), LLAMA + "/prefix": ({}, prefix),
            LLAMA + "/moe-attn": moe_attn,
            LLAMA_INT8_KV: (kv.pop("kernels"), kv)}


# ---------------------------------------------------------------------------
# stages H-K: the recurrent and hybrid families
# ---------------------------------------------------------------------------
RG, MAMBA = "recurrentgemma-2b", "mamba2-130m"
#: prompt lengths of the hybrid paths: buffered prefills that fold their
#: bucket's pads into the state, one of exactly the 2048-slot window (its
#: first decode wraps to slot 0) and one whose bucket (4096) is past the
#: window (blockwise attention, the ring-slot layout)
HYBRID_LENS = (16, 57, 130, 200, 2048, 3000)
HYBRID_NEW = 64
HYBRID_MAX_LEN = 4096


def check_ring_attention() -> dict:
    """Stage H: decode attention at RecurrentGemma-2B's local-attention
    shape (B 4, H 10 on KV 1, hd 256, a ring of L = window 2048), three
    head groups (4, 4, 2) a KV head: against the plain version in bf16
    (3e-2) and float32 (2e-4), absolute and scaled by each row
    (:func:`held_attention`), at positions below the window, at 2047,
    wrapped (2048, 3000, 4095), ragged, at L 2000 < window and at B 8,
    each also with every slot its rows do not see NaN-filled and
    repeated bit-identically; one launch per call under the profiler.
    Timed at B 4 and B 8 with every slot valid (CUDA events, in turn
    with ``scaled_dot_product_attention`` and the ring mask; profiler
    device time), beside the bytes bound and the plain version; and the
    device time of 4, 8 and 10 query heads on the same K/V (one block
    takes all 10: two warp sets of 8 query columns on one ring)."""
    from repro_torch.kernels.decode_attention.kernel import (
        _n_sms, decode_attention_cuda, plan)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, valid_slots)

    H, KV, hd, W = 10, 1, 256, 2048
    gen = torch.Generator(device="cuda").manual_seed(2560)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False

    def inputs(B, L, pos, dtype, H=H):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda") * 0.5
        return (rand(B, H, hd).to(dtype), rand(B, L, KV, hd).to(dtype),
                rand(B, L, KV, hd).to(dtype),
                torch.tensor(pos, dtype=torch.int32, device="cuda"))

    cases = [  # name, B, L, positions
        ("below the window", 4, W, [16, 200, 1000, 2000]),
        ("at 2047", 4, W, [W - 1] * 4),
        ("wrapped", 4, W, [2048, 3000, 4095, 2047]),
        ("ragged", 4, W, [0, 2048, 57, 3999]),
        ("ragged L=2000", 4, 2000, [1999, 10, 2100, 4000]),
        ("B 8", 8, W, [2047, 1, 2100, 0, 700, 4000, 2048, 64]),
    ]
    errs = {}
    for dtype, bar in ((torch.bfloat16, 3e-2), (torch.float32, 2e-4)):
        for name, B, L, pos in cases:
            q, k, v, p = inputs(B, L, pos, dtype)
            want = decode_attention_ref(q, k, v, p, window=W)
            got = decode_attention_cuda(q, k, v, p, window=W)
            stale = ~valid_slots(p, L, W)[:, :, None, None]
            k.masked_fill_(stale, float("nan"))
            v.masked_fill_(stale, float("nan"))
            nan_got = decode_attention_cuda(q, k, v, p, window=W)
            again = decode_attention_cuda(q, k, v, p, window=W)
            torch.cuda.synchronize()
            what = f"ring {name} {dtype}"
            e1 = held_attention(got, want, bar, what)
            e2 = held_attention(nan_got, want, bar, what + ", NaN tail")
            check(torch.equal(nan_got, again),
                  f"decode_attention {what}: repeat bit-identical")
            errs[name, str(dtype)] = (max(e1[0], e2[0]), max(e1[1], e2[1]))
            log(f"decode_attention ring {name} [{B},{H},{hd}] x L={L} "
                f"window={W} {str(dtype)[6:]}: max abs err "
                f"{errs[name, str(dtype)][0]:.3g}, scaled "
                f"{errs[name, str(dtype)][1]:.3g} (NaN tail too), repeat "
                f"bit-identical; plan {plan(B, H, KV, hd, L, 132)}")

    def timed(B, heads=H):
        q, k, v, p = inputs(B, W, [3000] * B, torch.bfloat16, heads)
        mask = valid_slots(p, W, W)[:, None, None, :]

        def kernel():
            return decode_attention_cuda(q, k, v, p, window=W)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        prof = profile_calls(kernel)
        one_launch(prof, "decode_attention", f"decode_attention ring B={B} "
                                             f"H={heads}")
        if heads != H:
            return dict(device_ms=prof["device_ms"])
        want = decode_attention_ref(q, k, v, p, window=W)
        err, scaled = held_attention(kernel(), want, 3e-2,
                                     f"ring timed B={B}")
        lib_err = attention_err(sdpa()[:, :, 0].float(), want)
        rows = int(mask.sum())               # the slots the data needs
        bnd, by = bound_ms(rows * KV * hd * 2 * 2 + nbytes(q, p)
                           + B * H * hd * 4, 4 * rows * H * hd)
        ms, lib_ms = time_pair(kernel, sdpa)
        res = dict(ms=ms, device_ms=prof["device_ms"],
                   plain_ms=time_ms(lambda: decode_attention_ref(
                       q, k, v, p, window=W), reps=5, warm=1),
                   library_ms=lib_ms, library_device_ms=device_ms(sdpa),
                   library="scaled_dot_product_attention (ring mask)",
                   library_max_abs_err=lib_err[0], max_abs_err=err,
                   scaled_err=scaled, bound_ms=bnd, bound_by=by,
                   slots_needed=rows, kernels_per_call=prof["per_call"])
        attention_row(f"ring B={B}", res,
                      plan(B, H, KV, hd, W, _n_sms(q.device)), kernel)
        log(f"decode_attention ring timed B={B}: {ms:.4f} ms (device "
            f"{res['device_ms']}), plain {res['plain_ms']:.4f}, SDPA "
            f"{lib_ms:.4f} (device {res['library_device_ms']}), bound "
            f"{bnd:.5f} ms ({by}); err {err:.3g}")
        return res
    out = timed(4)
    out["B8"] = timed(8)
    out["heads_device_ms"] = {heads: timed(4, heads)["device_ms"]
                              for heads in (4, 8)}
    out["heads_device_ms"][10] = out["device_ms"]
    log(f"decode_attention ring B=4, device ms by query heads on the same "
        f"K/V (H 4, 8, 10; one head group each): {out['heads_device_ms']}")
    bf16 = [e for (_, dt), e in errs.items() if dt == "torch.bfloat16"]
    f32 = [e for (_, dt), e in errs.items() if dt == "torch.float32"]
    out["max_abs_err"] = max([e for e, _ in bf16] + [out["max_abs_err"],
                                                     out["B8"]["max_abs_err"]])
    out["max_scaled_err"] = max(s for _, s in bf16)
    out["max_abs_err_f32"] = max(e for e, _ in f32)
    out["max_scaled_err_f32"] = max(s for _, s in f32)
    return out


def random_prompts(cfg, lens, seed: int = 2402) -> list:
    """Token ids of prompts of ``lens`` tokens, random from a seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens]


class ModelCalls:
    """Counts an engine's forward passes: its model instance's
    ``prefill``, ``prefill_chunk`` and ``decode_step`` (``decode_placed``:
    the decode steps under an EPLB placement), standing in for the
    methods on the instance that every DP group's backend calls."""

    NAMES = ("prefill", "prefill_chunk", "decode_step")

    def __init__(self, model):
        self.model = model
        self.calls = dict(prefill=0, prefill_chunk=0, decode=0,
                          decode_placed=0)
        for name in self.NAMES:
            real = getattr(model, name)

            def spy(*a, _real=real, _name=name, **kw):
                key = _name
                if _name == "decode_step":
                    key = ("decode" if kw.get("placement") is None
                           else "decode_placed")
                self.calls[key] += 1
                return _real(*a, **kw)
            setattr(model, name, spy)

    def undo(self) -> None:
        for name in self.NAMES:
            delattr(self.model, name)

    def want(self, n_attn: int, n_moe: int) -> tuple:
        """(launches, fused launches) the passes counted so far make: a
        decode attention per attention layer and decode step; per MoE
        layer and pass one route-pack (EPLB Collect inside it), and one
        gmm, or placement_gmm in a decode step under a placement (the
        placement reaches decode only)."""
        c = self.calls
        dec = c["decode"] + c["decode_placed"]
        fwd = c["prefill"] + c["prefill_chunk"] + dec
        want = dict(decode_attention=n_attn * dec, route_pack=n_moe * fwd,
                    gmm=n_moe * (fwd - c["decode_placed"]),
                    placement_gmm=n_moe * c["decode_placed"])
        return ({n: v for n, v in want.items() if v},
                {"collect": want["route_pack"]} if n_moe and fwd else {})


def serve_tokens(engine, prompts, n_new: int, lead: int = 0) -> tuple:
    """Serve token-id ``prompts``, ``n_new`` greedy tokens each. With
    ``lead`` the first ``lead`` prompts are submitted alone and the rest
    (their requests made then, so that their TTFT starts there) once
    those decode, so that the rest's decode steps batch with theirs;
    :func:`path_window` then runs once every slot of the first DP group
    decodes. → (requests, the window's result or None)."""
    from repro_torch.serving.request import Request, RequestState

    def make(i, toks):
        return Request(prompt=f"prompt {i}", prompt_tokens=toks,
                       max_new_tokens=n_new, ignore_eos=True)
    reqs = [make(i, t) for i, t in enumerate(prompts[:lead or None])]
    for r in reqs:
        engine.submit(r)
    if lead:
        for _ in range(10_000):
            if all(r.state == RequestState.DECODING for r in reqs):
                break
            engine.step()
        check(all(r.state == RequestState.DECODING for r in reqs),
              "the leading requests decode")
        rest = [make(lead + i, t) for i, t in enumerate(prompts[lead:])]
        for r in rest:
            engine.submit(r)
        reqs += rest
    got = None
    if lead:
        dp = engine.dps[0]
        for _ in range(10_000):
            if dp.active == dp.max_batch:
                break
            engine.step()
        check(dp.active == dp.max_batch, "every slot decoding for the "
                                         "window")
        got = path_window(engine)
    engine.run_until_done()
    torch.cuda.synchronize()
    return reqs, got


def path_window(engine, steps: int = 4) -> dict:
    """Device time by kernel of ``steps`` engine steps of a served wave,
    every slot of the first DP group decoding, under a profiler that
    records only device activity (so the wave's TPOT barely moves):
    busy ms, decode attention's ms a step and a call, its launches, and
    the slots' positions."""
    from repro_torch.kernels import runtime

    dp = engine.dps[0]
    positions = [s.position for s in dp.slots]
    before = runtime.LAUNCHES.get("decode_attention", 0)
    torch.cuda.synchronize()
    with device_window() as w:
        t0 = time.monotonic()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t0) / steps * 1e3
    n = runtime.LAUNCHES.get("decode_attention", 0) - before
    attn = [e for e in w.events if "decode_attention" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3
    busy = sum(e.self_device_time_total for e in w.events) / 1e3 / steps
    res = dict(positions=positions, engine_step_ms=step_ms,
               device_busy_ms=busy,
               decode_attention_ms_per_step=attn_ms / steps,
               decode_attention_ms_per_call=attn_ms / n if n else None,
               decode_attention_launches=n,
               decode_attention_events=sum(e.count for e in attn))
    log(f"path window: {engine.cfg.name} {steps} engine steps at positions "
        f"{positions}: step {step_ms:.2f} ms (host clock), device busy "
        f"{busy:.3f} ms a step; decode attention "
        f"{res['decode_attention_ms_per_step']:.4f} ms a step, "
        f"{res['decode_attention_ms_per_call']} ms a call over {n} "
        f"launches ({res['decode_attention_events']} profiler events)")
    return res


class DecodeCounter:
    """Counts each DP group's ``decode_sample`` calls (its decode
    steps), standing in for the backend's method on the instance."""

    def __init__(self, engine):
        self.calls = {}
        for d in engine.dps:
            real = d.backend.decode_sample
            self.calls[d.dp_id] = 0

            def spy(*a, _real=real, _id=d.dp_id, **kw):
                self.calls[_id] += 1
                return _real(*a, **kw)
            d.backend.decode_sample = spy

    def undo(self, engine) -> None:
        for d in engine.dps:
            del d.backend.decode_sample


def decode_consistency(engine, P: int, steps: int, at: tuple,
                       be=None, hold: bool = True) -> dict:
    """Decode against prefill at full width: a prompt of ``P`` random
    tokens prefilled unpadded into one slot, then ``steps`` decode steps
    fed the next tokens; after step ``j`` in ``at`` the logits are held
    to the backend's (padded) prefill of the first ``P + j`` tokens at
    its last position, within the 0.08 relative bar of
    ``tests/test_decode_consistency.py``. A model with cross-attention
    reads the backend's memory in both prefills. ``be``: the backend
    (default: the engine's first DP group's); without ``hold`` the
    errors are logged, not held."""
    import numpy as np

    be = engine.dps[0].backend if be is None else be
    dev = be.device
    name = be.model.cfg.name
    toks = np.random.default_rng(P).integers(
        3, be.model.cfg.vocab_size, P + steps).tolist()
    errs = {}
    with torch.no_grad():
        _, cache1 = be.model.prefill(
            be.params, torch.tensor([toks[:P]], device=dev),
            memory=None if be.memory is None else be.memory[:1])
        cache = be.model.init_cache(1, be.max_len, device=dev)
        be.write_slot(cache, cache1, 0)
        del cache1
        for j in range(steps):
            logits, cache = be.model.decode_step(
                be.params, cache,
                torch.tensor([[toks[P + j]]], dtype=torch.int32, device=dev),
                torch.tensor([P + j], dtype=torch.int32, device=dev))
            if j + 1 in at:
                _, ref = be.prefill(toks[:P + j + 1])
                ref = torch.as_tensor(ref)
                errs[P + j] = float((logits[0].float().cpu() - ref).abs().max()
                                    / ref.abs().max().clamp(min=1e-30))
    check(not hold or all(e < 0.08 for e in errs.values()),
          f"{name}: decode logits within 0.08 of prefill's at positions "
          f"{errs}")
    log(f"decode vs prefill: {name} (capacity factor "
        f"{be.model.cfg.moe.capacity_factor}) from an unpadded {P}-token "
        f"prefill, relative logit error by position {errs} "
        f"({'bar 0.08' if hold else 'not held'})")
    return errs


def sync_free_decode(engine) -> None:
    """One full-batch decode step of a DP group from tensors already on
    the card (the idle group's own cache), under :func:`no_host_sync`,
    the EPLB placement installed where there is one."""
    dp = engine.dps[0]
    be, B = dp.backend, dp.max_batch
    check(all(s.free for s in dp.slots), "an idle DP group")
    cache = dp.cache
    tokens = torch.arange(5, 5 + B, dtype=torch.int32,
                          device=be.device)[:, None]
    positions = torch.tensor([min(p, be.max_len - 1)
                              for p in (0, 9, 2047, 3000)][:B]
                             + [1] * (B - 4),
                             dtype=torch.int32, device=be.device)
    torch.cuda.synchronize()
    with torch.no_grad(), no_host_sync():
        logits, _ = be.model.decode_step(be.params, cache, tokens, positions,
                                         placement=be._placement)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), "finite sync-free logits")
    log(f"no host sync: {engine.cfg.name} decode step (B {B}) under "
        f"set_sync_debug_mode('error')")


def served_path(cfg, lens, n_new: int, max_len: int, consistency: tuple,
                memory=None, *, chunk=None, n_dp: int = 2, lead: int = 0,
                before_close=None) -> dict:
    """Stages I, J, M, N and V: ``cfg`` at full width served through the
    port's ``FlowServeEngine`` (``n_dp`` DP groups x 4 slots, greedy; a
    model with cross-attention reads ``memory``): prompts of ``lens``
    random tokens, ``n_new`` tokens each (:func:`serve_tokens`; with
    ``lead``, :func:`path_window` inside the wave once the rest decode
    beside the leading prompts), every prefill buffered, or with
    ``chunk`` prefilled in ``chunk``-token chunks; a model with MoE
    layers then takes a skewed EPLB pass and a second wave of other
    prompts of the same lengths. Launch counts set to 0 just before and
    read just after: exactly those the model's forward passes make
    (:meth:`ModelCalls.want`: decode attention for its global, local
    and cross-attention layers x decode steps; route-pack with Collect
    inside, gmm and placement_gmm for its MoE layers) and no other
    kernel. Then TTFT, TPOT, peak memory, a decode profile, a decode
    step repeated bit-identically, a step with no host sync and decode
    against prefill (``consistency``: prompt length, steps, checkpoints;
    with MoE layers held on the same weights with a capacity that drops
    nothing, as the reference's smoke MoE configs are sized, the served
    capacity's error logged beside it: a prefill's capacity drops are
    not a decode step's).
    ``before_close(engine, res)``'s result goes under ``"stage"``."""
    from repro_torch.configs.base import ATTN, CROSS_ATTN, LOCAL_ATTN
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import Model
    from repro_torch.serving.backend import TorchBackend

    engine = make_engine(cfg, n_dp=n_dp, max_batch=4, max_len=max_len,
                         memory=memory, chunk_tokens=chunk)
    chunked = chunk is not None
    check(all(d.backend.supports_chunked_prefill == chunked
              for d in engine.dps),
          f"{cfg.name}: the {'chunked' if chunked else 'buffering'} prefill")
    n_attn = sum(m in (ATTN, LOCAL_ATTN, CROSS_ATTN)
                 for m, _ in cfg.layer_kinds())
    n_moe = len(moe_layers(cfg))
    eplb = n_moe > 0
    torch.cuda.reset_peak_memory_stats()
    counter = DecodeCounter(engine)
    calls = ModelCalls(engine.model)
    waves = [random_prompts(cfg, lens, 2402 + i) for i in range(1 + eplb)]
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.monotonic()
    reqs, in_wave = [], None
    for i, prompts in enumerate(waves):
        if i:      # one hot expert: EPLB's one redundant slot of 64
            # experts lowers the peak only where a single expert is hot
            engine.record_expert_counts(skewed_counts(cfg, n_hot=1))
            maps = engine.run_eplb()
            check(all(any(len(s) > 1 for s in maps[j].replicas.values())
                      for j in moe_layers(cfg)),
                  "EPLB installed redundant replicas in every MoE layer")
        got, w = serve_tokens(engine, prompts, n_new, lead)
        reqs.append(got)
        in_wave = in_wave or w
    wall = time.monotonic() - t0
    launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
    steps = dict(counter.calls)
    counter.undo(engine)
    calls.undo()
    passes = dict(calls.calls)
    for r in (r for w in reqs for r in w):
        check(r.state.value == "finished"
              and len(r.output_tokens) == n_new
              and all(0 <= t < cfg.vocab_size for t in r.output_tokens),
              f"{cfg.name}: request {r.req_id} finished with {n_new} "
              f"tokens")
    check(passes["decode"] + passes["decode_placed"] == sum(steps.values())
          and (passes["prefill_chunk"] > 0) == chunked
          and (passes["prefill"] == 0 or not chunked)
          and (passes["decode_placed"] > 0) == eplb,
          f"{cfg.name}: forward passes {passes} (decode steps {steps})")
    want, want_fused = calls.want(n_attn, n_moe)
    check({n: c for n, c in launches.items() if c} == want
          and {n: c for n, c in fused.items() if c} == want_fused,
          f"{cfg.name}: launches {launches} (fused {fused}) equal {want} "
          f"(fused {want_fused}): {n_attn} attention and {n_moe} MoE "
          f"layers x forward passes {passes}, and no other kernel")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_len = {(f"w{i}/" if eplb else "") + str(len(r.prompt_tokens)):
              dict(ttft_ms=1e3 * r.ttft, tpot_ms=1e3 * r.tpot)
              for i, w in enumerate(reqs) for r in w}
    log(f"path: {cfg.name} {sum(map(len, reqs))} requests x {n_new} tokens "
        f"in {wall:.2f} s; decode steps by DP group {steps}; forward "
        f"passes {passes}; launches {launches} (fused {fused}); peak "
        f"memory {peak:.2f} GiB; TTFT / TPOT ms by prompt length "
        + ", ".join(f"{n}: {v['ttft_ms']:.1f} / {v['tpot_ms']:.2f}"
                    for n, v in by_len.items()))
    profile = profile_decode(engine)
    check_decode_repeat(engine, placed=eplb, reuse=True)
    sync_free_decode(engine)
    errs, served_errs = decode_consistency(engine, *consistency,
                                           hold=not eplb), None
    if eplb:
        served_errs = errs
        moe = cfg.moe
        free_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            moe, capacity_factor=moe.num_experts / moe.top_k + 1))
        be = TorchBackend(Model(free_cfg), engine.params, max_len=max_len,
                          device=engine.device)
        errs = decode_consistency(engine, *consistency, be=be)
        del be
    res = dict(launches=launches, fused=fused, decode_steps=steps,
               forward_passes=passes, attention_layers=n_attn,
               moe_layers=n_moe, serve_s=wall,
               ttft_ms_mean=statistics.mean(v["ttft_ms"]
                                            for v in by_len.values()),
               tpot_ms_mean=statistics.mean(v["tpot_ms"]
                                            for v in by_len.values()),
               by_prompt_len=by_len, peak_mem_gib=peak,
               decode_profile=profile, decode_vs_prefill_err=errs,
               text=engine.tokenizer.decode(reqs[0][0].output_tokens))
    if served_errs is not None:
        res["decode_vs_prefill_err_served_capacity"] = served_errs
    if in_wave is not None:
        res["path_window"] = in_wave
    if before_close is not None:
        res["stage"] = before_close(engine, res)
    engine.close()
    return res


def hybrid_stages(get_config) -> dict:
    """Stages H-K: decode attention at RecurrentGemma's shape, then
    RecurrentGemma-2B and Mamba2-130M at full width and depth, then
    both smoke models card against CPU."""
    t0 = time.monotonic()
    kern = {"decode_attention": check_ring_attention()}
    free(f"ring attention checks: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    rg = served_path(get_config(RG), HYBRID_LENS, HYBRID_NEW,
                     HYBRID_MAX_LEN, (2040, 16, (1, 8, 9, 16)))
    free(f"{RG} path: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    mamba = served_path(get_config(MAMBA), HYBRID_LENS, HYBRID_NEW,
                        HYBRID_MAX_LEN, (200, 16, (1, 8, 16)))
    free(f"{MAMBA} path: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    check_small_reference(RG, num_layers=5)
    check_small_reference(MAMBA)
    log(f"hybrid small references: {time.monotonic() - t0:.1f} s")
    return {RG: (kern, rg), MAMBA: ({}, mamba)}


# ---------------------------------------------------------------------------
# stages L-O: cross-attention, the encoder and VLM memory
# ---------------------------------------------------------------------------
VLM, SEAMLESS = "llama-3.2-vision-11b", "seamless-m4t-medium"
#: the memory paths' self-attention cache length
MEMORY_MAX_LEN = 256
#: prompt lengths of the memory paths: one wave of 8 slots
MEMORY_LENS = (8, 16, 33, 57, 100, 130, 180, 200)
MEMORY_NEW = 16
#: decode-attention batch of stage L (a DP group's slots)
MEMORY_B = 4


def memory_attention_shapes(get_config) -> dict:
    """name → (H, KV, hd, L, cross) of decode attention on the memory
    paths: each model's cross-attention over its memory and its
    self-attention over ``MEMORY_MAX_LEN`` slots."""
    out = {}
    for arch in (VLM, SEAMLESS):
        c = get_config(arch)
        H, KV, hd = c.num_heads, c.num_kv_heads, c.resolved_head_dim
        out[f"{arch} cross"] = (H, KV, hd, c.num_frontend_tokens, True)
        out[f"{arch} self"] = (H, KV, hd, MEMORY_MAX_LEN, False)
    return out


def check_memory_attention(get_config) -> dict:
    """Stage L: decode attention at the memory paths' shapes (B 4;
    Llama-3.2-Vision H 32 on KV 8, hd 128, cross L 1601; SeamlessM4T H
    16 on KV 16, hd 64, cross L 512; self-attention over 256 slots)
    against the plain version in bf16 (3e-2) and float32 (2e-4),
    absolute and scaled by each row (:func:`held_attention`). Cross
    shapes: every slot attended (positions L - 1), a short memory's zero
    pads among them, and a per-layer view of a stacked cache; self
    shapes: every slot, ragged positions and a stacked view, with the
    slots a row does not see NaN-filled. Each check repeats
    bit-identically, and is one launch under the profiler (all checks'
    calls in one window). Timed in bf16 with every
    slot valid (CUDA events in turn with ``scaled_dot_product_attention``,
    profiler device time) beside the bytes bound and the plain
    version."""
    from repro_torch.kernels.decode_attention.kernel import (
        _n_sms, decode_attention_cuda, plan)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, valid_slots)

    B = MEMORY_B
    gen = torch.Generator(device="cuda").manual_seed(1601)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False

    def inputs(H, KV, hd, L, dtype, pos, stacked=False):
        """q, k, v, positions; ``stacked``: k/v are layer 1 of a [2, B,
        L, KV, hd] stack, as a superblock's cache view."""
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda") * 0.5
        n = 2 if stacked else 1
        k = rand(n, B, L, KV, hd).to(dtype)[n - 1]
        v = rand(n, B, L, KV, hd).to(dtype)[n - 1]
        return (rand(B, H, hd).to(dtype), k, v,
                torch.tensor(pos, dtype=torch.int32, device="cuda"))

    shapes = memory_attention_shapes(get_config)
    errs, calls = {}, []
    for name, (H, KV, hd, L, cross) in shapes.items():
        last = [L - 1] * B
        cases = [("every slot", last, False, 0)]
        if cross:
            cases += [("short memory, zero pads", last, False, L // 3),
                      ("stacked cache view", last, True, 0)]
        else:
            cases += [("ragged", [0, L - 1, L // 2 + 3, 37], False, 0),
                      ("stacked cache view", [L - 1, 3, 100, 200], True, 0)]
        for dtype, bar in ((torch.bfloat16, 3e-2), (torch.float32, 2e-4)):
            for case, pos, stacked, short in cases:
                q, k, v, p = inputs(H, KV, hd, L, dtype, pos, stacked)
                if short:
                    k[:, short:] = 0
                    v[:, short:] = 0
                want = decode_attention_ref(q, k, v, p)
                got = decode_attention_cuda(q, k, v, p)
                stale = ~valid_slots(p, L)[:, :, None, None]
                k.masked_fill_(stale, float("nan"))
                v.masked_fill_(stale, float("nan"))
                nan_got = decode_attention_cuda(q, k, v, p)
                again = decode_attention_cuda(q, k, v, p)
                torch.cuda.synchronize()
                what = f"{name}, {case}, {dtype}"
                e1 = held_attention(got, want, bar, what)
                e2 = held_attention(nan_got, want, bar, what + ", NaN tail")
                check(torch.equal(nan_got, again),
                      f"decode_attention {what}: repeat bit-identical")
                calls.append(functools.partial(decode_attention_cuda,
                                               q, k, v, p))
                errs[name, case, str(dtype)] = (max(e1[0], e2[0]),
                                                max(e1[1], e2[1]))
                log(f"decode_attention {what} [{B},{H},{hd}] x L={L}: max "
                    f"abs err {errs[name, case, str(dtype)][0]:.3g}, scaled "
                    f"{errs[name, case, str(dtype)][1]:.3g} (NaN tail too), "
                    f"repeat bit-identical; plan "
                    f"{plan(B, H, KV, hd, L, 132)}")
    # every check's call, each once, in one profiler window: one device
    # kernel per call and nothing beside them (40 rounds: late in the
    # process a window loses its first 7-10 kernel events)
    prof = profile_calls(lambda: [c() for c in calls], reps=40)
    check(prof["per_call"] is not None
          and round(prof["per_call"]) == len(calls)
          and all("decode_attention" in n for n in prof["names"]),
          f"decode_attention: each of the {len(calls)} checks one launch "
          f"under the profiler, got {prof['per_call']} of {prof['names']}")
    check(prof["counted_per_call"] == len(calls),
          f"decode_attention: each of the {len(calls)} checks one counted "
          f"launch, got {prof['counted_per_call']}")
    log(f"decode_attention: the {len(calls)} checks' calls are "
        f"{prof['per_call']} device kernels per round ({prof['names']})")

    def timed(name):
        H, KV, hd, L, _ = shapes[name]
        q, k, v, p = inputs(H, KV, hd, L, torch.bfloat16, [L - 1] * B)

        def kernel():
            return decode_attention_cuda(q, k, v, p)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                enable_gqa=True)
        want = decode_attention_ref(q, k, v, p)
        err, scaled = held_attention(kernel(), want, 3e-2, f"timed {name}")
        lib_err = attention_err(sdpa()[:, :, 0].float(), want)
        rows = B * L                           # every slot is needed
        bnd, by = bound_ms(rows * KV * hd * 2 * 2 + nbytes(q, p)
                           + B * H * hd * 4, 4 * rows * H * hd)
        prof = profile_calls(kernel, reps=100)   # see the window above
        one_launch(prof, "decode_attention", f"decode_attention {name}")
        ms, lib_ms = time_pair(kernel, sdpa)
        res = dict(ms=ms, device_ms=prof["device_ms"],
                   plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, p),
                                    reps=5, warm=1),
                   library_ms=lib_ms, library_device_ms=device_ms(sdpa),
                   library="scaled_dot_product_attention",
                   library_max_abs_err=lib_err[0], max_abs_err=err,
                   scaled_err=scaled, bound_ms=bnd, bound_by=by,
                   slots_needed=rows, kernels_per_call=prof["per_call"],
                   shape=dict(B=B, H=H, KV=KV, hd=hd, L=L))
        attention_row(name, res, plan(B, H, KV, hd, L, _n_sms(q.device)),
                      kernel)
        log(f"decode_attention timed {name} [{B},{H},{hd}] x L={L}: "
            f"{ms:.4f} ms (device {res['device_ms']}), plain "
            f"{res['plain_ms']:.4f}, SDPA {lib_ms:.4f} (device "
            f"{res['library_device_ms']}), bound {bnd:.5f} ms ({by}); err "
            f"{err:.3g}")
        return res
    by_shape = {name: timed(name) for name in shapes}
    out = dict(by_shape[f"{VLM} cross"], by_shape=by_shape)
    bf16 = [e for (_, _, dt), e in errs.items() if dt == "torch.bfloat16"]
    f32 = [e for (_, _, dt), e in errs.items() if dt == "torch.float32"]
    out["max_abs_err"] = max([e for e, _ in bf16]
                             + [t["max_abs_err"] for t in by_shape.values()])
    out["max_scaled_err"] = max(s for _, s in bf16)
    out["max_abs_err_f32"] = max(e for e, _ in f32)
    out["max_scaled_err_f32"] = max(s for _, s in f32)
    return out


def memory_stages(get_config) -> dict:
    """Stages L-O: decode attention at the memory paths' shapes, then
    Llama-3.2-Vision-11B (40 layers) and SeamlessM4T-medium (12 encoder
    layers, 24 decoder blocks) at full width and depth, then both smoke
    models card against CPU."""
    from repro_torch.models.transformer import seeded_memory

    t0 = time.monotonic()
    kern = {"decode_attention": check_memory_attention(get_config)}
    free(f"memory attention checks: {time.monotonic() - t0:.1f} s")
    paths = {}
    for arch in (VLM, SEAMLESS):
        t0 = time.monotonic()
        cfg = get_config(arch)
        memory = seeded_memory(cfg, torch.Generator(
            device="cuda").manual_seed(2311), "cuda", torch.bfloat16)
        paths[arch] = served_path(cfg, MEMORY_LENS, MEMORY_NEW,
                                  MEMORY_MAX_LEN, (200, 16, (1, 8, 16)),
                                  memory)
        del memory
        free(f"{arch} path: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    check_small_reference(VLM, num_heads=8, num_kv_heads=2)
    check_small_reference(SEAMLESS)
    log(f"memory small references: {time.monotonic() - t0:.1f} s")
    return {VLM: (kern, paths[VLM]), SEAMLESS: ({}, paths[SEAMLESS])}


# ---------------------------------------------------------------------------
# stage V: dense and long-context serving
# ---------------------------------------------------------------------------
INTERNLM, GRANITE, COMMAND_R = ("internlm2-1.8b", "granite-8b",
                                "command-r-35b")
DS_MOE, NEMO = "deepseek-moe-16b", "mistral-nemo-12b"
#: (arch, depth (None: all its layers), the overrides of its smoke config
#: that :func:`check_small_reference` serves: the full width's query
#: heads per KV head, as ``tests/torch_parity.py`` holds them)
V_MODELS = ((INTERNLM, None, {}),
            # Granite 12 of 36 layers and DeepSeek-MoE-16B 10 of 28 (a
            # dense layer, 9 MoE layers): at full depth the script took
            # 1058.5 s of its 1200 s on a slow host
            (GRANITE, 12, dict(num_heads=8, num_kv_heads=2)),
            # 8 of 40 layers: the tied 256000 x 8192 table is 2.1 B of
            # the 7.7 B parameters left
            (COMMAND_R, 8, dict(num_heads=16, num_kv_heads=2, head_dim=32)),
            (DS_MOE, 10, {}),
            (NEMO, None, dict(num_heads=8, num_kv_heads=2)))
#: prompt lengths of the 1024-slot paths (2 DP groups x 4 slots: one
#: wave), the last two prefilled in two 512-token chunks
V_LENS = (16, 33, 57, 100, 130, 200, 600, 900)
#: DeepSeek-MoE-16B's gmm off the path: T 88, 120 and 1024 routed
#: tokens, C 12 and 16 (either side of the wgmma variant's 16-row
#: width) and 144 (two 128-row tiles)
V_MOE_OFF_PATH = (88, 120, 1024)
V_NEW, V_MAX_LEN, V_CHUNK = 16, 1024, 512
#: Mistral-NeMo on one DP group of 4 slots of 32768: one 32000-token
#: prompt first, then three short ones that decode beside it
NEMO_LENS = (32000, 16, 120, 200)
NEMO_NEW, NEMO_MAX_LEN = 32, 32768


def v_path(arch: str, cfg) -> tuple:
    """One stage V model: served (:func:`served_path`, chunked prefill)
    with its kernels held at the path's shapes before the engine closes
    (decode attention at its (G, L); on DeepSeek-MoE-16B route-pack,
    Collect, gmm and placement_gmm on the engine's layer-0 experts and
    the path's token counts). → (kernel results, path)."""
    from repro_torch.configs.base import MOE
    from repro_torch.kernels.decode_attention.kernel import _n_sms, plan

    nemo = arch == NEMO
    B, max_len = 4, NEMO_MAX_LEN if nemo else V_MAX_LEN
    lens = NEMO_LENS if nemo else V_LENS
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = plan(B, H, KV, hd, max_len, _n_sms(torch.device("cuda")))
    log(f"stage V: {cfg.name} decode attention G {H // KV} hd {hd} over "
        f"{max_len} slots at B {B}: plan {plan_text(p)}")
    if nemo:
        check(p["n_split"] >= 16 and p["cluster"] == 1,
              f"{cfg.name}: a {max_len}-slot cache takes the ticket merge "
              f"of 16+ splits: {p}")

    def kernels(engine, res):
        t0 = time.monotonic()
        kern = {"decode_attention": check_decode_attention(
            cfg, B, max_len, sweep=False,
            ragged=res["path_window"]["positions"] if nemo else None)}
        if cfg.moe.enabled:
            counts = sorted({B} | chunk_token_counts(lens, max_len, V_CHUNK))
            pos = [f for _, f in cfg.layer_pattern].index(MOE)
            ffn = engine.params["blocks"][f"pos{pos}"]["ffn"]
            kern.update(check_moe_kernels(
                cfg, counts, B,
                [ffn[n][0] for n in ("we_gate", "we_up", "we_down")],
                off_path=V_MOE_OFF_PATH))
        log(f"{cfg.name} kernel checks: {time.monotonic() - t0:.1f} s")
        return kern
    path = served_path(
        cfg, lens, NEMO_NEW if nemo else V_NEW, max_len,
        (8192, 4, (1, 4)) if nemo else (200, 8, (1, 8)), chunk=V_CHUNK,
        n_dp=1 if nemo else 2, lead=int(nemo), before_close=kernels)
    path["decode_attention_plan"] = p
    return path.pop("stage"), path


def v_stage(get_config) -> dict:
    """Stage V: InternLM2-1.8B, Granite-8B (12 of 36 layers),
    Command-R-35B (8 of 40 layers, its tied head), DeepSeek-MoE-16B (10
    of 28) and Mistral-NeMo-12B (one 32000-token prompt on a 32768-slot
    cache) at full width through ``FlowServeEngine`` with 512-token
    chunks (:func:`v_path`), each then as a smoke model card against
    CPU (:func:`check_small_reference` with the overrides of
    ``V_MODELS``)."""
    t_v = time.monotonic()
    out = {}
    for arch, depth, small in V_MODELS:
        t0 = time.monotonic()
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        out[arch] = v_path(arch, cfg)
        free(f"{arch} path: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        check_small_reference(arch, **small)
        log(f"{arch} small reference: {time.monotonic() - t0:.1f} s")
    log(f"stage V: {time.monotonic() - t_v:.1f} s")
    return out


# ---------------------------------------------------------------------------
# stage Q: training (train/*, Model.forward_train, MTPTrainer)
# ---------------------------------------------------------------------------
#: Q1's smoke configurations, float32: MLA + MoE with the MTP head, GQA +
#: MoE (5 query heads per KV head), RG-LRU + ring attention, the SSD, and
#: the encoder-decoder
TRAIN_SMOKE = (("deepseek-v3-671b", {}),
               ("llama4-maverick-400b-a17b",
                dict(num_heads=10, num_kv_heads=2, head_dim=32)),
               ("recurrentgemma-2b", dict(num_layers=5)),
               ("mamba2-130m", {}), ("seamless-m4t-medium", {}))
#: Q2: ``launch/train.py``'s default arch and arguments; Q3: the MoE
TRAIN_ARCH, TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LR = (
    "internlm2-1.8b", 20, 8, 256, 3e-4)
TRAIN_MOE_ARCH, TRAIN_MOE_LAYERS, TRAIN_MOE_STEPS = "deepseek-moe-16b", 4, 10
#: profiled steps follow this many unprofiled ones
TRAIN_WARM = 2


def no_kernel_launched(what: str) -> None:
    from repro_torch.kernels import runtime

    check(not +runtime.LAUNCHES and not +runtime.FUSED,
          f"{what}: no hand kernel launched (got {dict(runtime.LAUNCHES)}, "
          f"fused {dict(runtime.FUSED)})")


def norm_err(got, want) -> float:
    """|got - want| / |want| over the whole tensor (|got| if want is 0)."""
    got, want = (t.detach().double().cpu() for t in (got, want))
    num = float(torch.linalg.vector_norm(got - want))
    den = float(torch.linalg.vector_norm(want))
    return num / den if den else num


def train_parity(device: str = "cuda") -> dict:
    """Q1: one ``forward_train`` + backward + ``adamw_update`` of each
    :data:`TRAIN_SMOKE` model on the card and on the host's CPU, same
    seeded weights, tokens, loss mask (and memory), TF32 off: the loss
    within 1e-4 relative, every gradient leaf and every updated
    parameter within 1e-3 relative in norm; no hand kernel launched.
    Then a requires-grad input to ``expert_ffn`` or ``fused_route_pack``
    on the card raises, and with ``use_kernel=False`` both run and carry
    the gradient."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.kernels.gmm.ops import expert_ffn
    from repro_torch.kernels.route_pack.ops import fused_route_pack
    from repro_torch.models.transformer import Model, seeded_memory
    from repro_torch.models.weights import flatten
    from repro_torch.train import AdamWConfig, adamw_update, init_adamw
    from repro_torch.train.train_loop import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    B, S = 2, 64
    out = {}
    for arch, kw in TRAIN_SMOKE:
        cfg = dataclasses.replace(get_config(arch + "-smoke"),
                                  dtype="float32", **kw)
        model = Model(cfg)
        gen = torch.Generator().manual_seed(7)
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
        mask = (torch.rand((B, S), generator=gen) > 0.1).float()
        mem = (seeded_memory(cfg, gen, "cpu").expand(B, -1, -1)
               if model.has_cross else None)
        res = {}
        for dev in ("cpu", device):
            params = model.init(0, device=dev)     # one seed, same weights
            runtime.reset_launch_counts()
            (loss, met), grads = loss_and_grads(
                model, params, toks[:, :-1].to(dev), toks[:, 1:].to(dev),
                memory=None if mem is None else mem.to(dev),
                loss_mask=mask.to(dev))
            new, _, _ = adamw_update(opt, params, grads, init_adamw(params))
            no_kernel_launched(f"Q1 {arch} on {dev}")
            res[dev] = (float(loss), float(met["moe_lb_loss"]),
                        flatten(grads), flatten(new))
        (cl, clb, cg, cp), (gl, glb, gg, gp) = res["cpu"], res[device]
        loss_err = abs(gl - cl) / abs(cl)
        grad_err = max(norm_err(gg[k], cg[k]) for k in cg)
        param_err = max(norm_err(gp[k], cp[k]) for k in cp)
        check(loss_err <= 1e-4, f"Q1 {arch}: loss {gl} vs CPU {cl}")
        check(grad_err <= 1e-3, f"Q1 {arch}: gradients within 1e-3 "
                                f"({grad_err})")
        check(param_err <= 1e-3, f"Q1 {arch}: updated parameters within "
                                 f"1e-3 ({param_err})")
        out[arch] = dict(loss=gl, moe_lb_loss=glb, loss_rel_err=loss_err,
                         grad_max_rel_err=grad_err,
                         param_max_rel_err=param_err, leaves=len(cg))
        log(f"Q1 {arch} {kw}: loss {gl:.6f} (CPU {cl:.6f}, rel {loss_err:.2e})"
            f", {len(cg)} gradient leaves within {grad_err:.2e}, parameters "
            f"after AdamW within {param_err:.2e}")
    # the refusal: a kernel's output would leave the graph
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((8, 64), generator=gen, device=device,
                    requires_grad=True)
    dest = torch.randint(0, 4, (8,), generator=gen, device=device,
                         dtype=torch.int32)
    w = torch.randn((4, 64, 64), generator=gen, device=device) * 0.1
    buckets = torch.randn((4, 8, 64), generator=gen, device=device,
                          requires_grad=True)
    refused = []
    for name, call in (
            ("route_pack", lambda u: fused_route_pack(
                x, dest, n_dest=4, capacity=8, use_kernel=u).buckets),
            ("gmm", lambda u: expert_ffn(buckets, w, w, w, use_kernel=u))):
        try:
            call(True)
        except RuntimeError as e:
            check("no backward" in str(e), f"Q1 {name}: refused ({e})")
            refused.append(name)
        y = call(False)
        y.sum().backward()
    check(refused == ["route_pack", "gmm"],
          f"Q1: requires-grad input refused on the card ({refused})")
    check(x.grad is not None and buckets.grad is not None
          and bool(torch.isfinite(x.grad).all()),
          "Q1: the plain versions carry the gradient")
    return out


def train_run(cfg, steps: int, B: int, S: int, what: str,
              device: str = "cuda") -> tuple:
    """``Trainer`` as ``launch/train.py`` builds it (AdamW lr
    :data:`TRAIN_LR`, warm-up ``max(steps // 20, 5)``, cosine to
    ``steps``) for ``steps`` steps of B × S tokens, logging every step;
    after :data:`TRAIN_WARM` steps the rest run under a profiler that
    records device activity only. → (rows, timing dict, trainer)."""
    from repro_torch.kernels import runtime
    from repro_torch.models.weights import flatten
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   Trainer)

    tcfg = TrainConfig(
        steps=steps, log_every=1,
        opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=max(steps // 20, 5),
                        total_steps=steps),
        data=DataConfig(seq_len=S, global_batch=B))
    t0 = time.monotonic()
    tr = Trainer(cfg, tcfg, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(tr.params).values())
    log(f"{what}: {cfg.name} depth {cfg.num_layers}, {n_params / 1e9:.3f} B "
        f"parameters ({cfg.dtype}) made on the card in "
        f"{time.monotonic() - t0:.1f} s")
    rows, host, last = [], [], [0.0]

    def on_log(r):      # wall_s counts from the start of each run()
        host.append((r["wall_s"] - last[0]) * 1e3)
        last[0] = r["wall_s"]
        rows.append(r)
        log(f"{what} step {r['step']:3d}: loss {r['loss']:.4f} nll "
            f"{r['nll']:.4f} lb {r['moe_lb_loss']:.5f} z "
            f"{r['moe_z_loss']:.5f} gnorm {r['grad_norm']:.3f} lr "
            f"{r['lr']:.2e}, {host[-1]:.1f} ms (host clock)")
    runtime.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tr.tcfg.steps = TRAIN_WARM
    tr.run(on_log=on_log)
    tr.tcfg.steps, last[0] = steps, 0.0
    with device_window() as w:
        tr.run(on_log=on_log)
        torch.cuda.synchronize()
    no_kernel_launched(what)
    n_prof = steps - TRAIN_WARM
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n_prof)
                      for e in w.events if e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    step_ms = statistics.mean(host[TRAIN_WARM:])
    check(0 < busy <= step_ms, f"{what}: device busy {busy} ms within the "
                               f"step's {step_ms} ms")
    tok_s = B * S / step_ms * 1e3
    by_kind: dict = {}
    for k, ms in kernels:
        by_kind[kernel_kind(k)] = by_kind.get(kernel_kind(k), 0.0) + ms
    timing = dict(
        params=n_params, host_ms_per_step=step_ms,
        host_ms_first_steps=host[:TRAIN_WARM], device_busy_ms=busy,
        device_idle_share=1.0 - busy / step_ms, tokens_per_s=tok_s,
        six_n_tflop_s=6 * n_params * tok_s / 1e12,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        by_kind_ms=by_kind,
        top_kernels_ms=[(k[:70], ms) for k, ms in kernels[:8]])
    log(f"{what}: {step_ms:.1f} ms per step (host clock, mean of the "
        f"{n_prof} profiled steps), device busy {busy:.1f} ms, idle share "
        f"{timing['device_idle_share']:.4f}, {tok_s:.0f} tokens/s, "
        f"6·N·tokens/s {timing['six_n_tflop_s']:.1f} TFLOP/s, peak "
        f"{timing['peak_gib']:.2f} GiB; by kind "
        + ", ".join(f"{k} {ms:.1f} ms" for k, ms in sorted(
            by_kind.items(), key=lambda kv: -kv[1])))
    for k, ms in timing["top_kernels_ms"]:
        log(f"  {ms:8.3f} ms/step  {k}")
    return rows, timing, tr


def kernel_kind(name: str) -> str:
    """A device kernel's kind, by its name: float32 GEMM (cuBLAS'
    ``sgemm`` / ``f32f32`` kernels), other GEMM (bf16), elementwise
    (PyTorch's elementwise and copy kernels, fills), or other
    (reductions, softmax, sort, scatter, ...)."""
    n = name.lower()
    if "sgemm" in n or "f32f32" in n or "gemmsn" in n:
        return "f32 GEMM"
    if "gemm" in n or "nvjet" in n:
        return "bf16 GEMM"
    if "elementwise" in n or "copy" in n or "fill" in n:
        return "elementwise"
    return "other"


def finite_falling(rows, what: str, n: int) -> None:
    losses = [r["loss"] for r in rows]
    check(all(math.isfinite(x) for x in losses), f"{what}: finite losses")
    first, last = (statistics.mean(losses[:n]), statistics.mean(losses[-n:]))
    check(last < first, f"{what}: the mean of the last {n} losses "
                        f"({last:.4f}) below the first {n}'s ({first:.4f})")


def train_full_width(get_config, device: str = "cuda") -> dict:
    """Q2: ``launch/train.py``'s default, InternLM2-1.8B at full width
    and depth, 20 steps of 8 × 256 tokens."""
    cfg = get_config(TRAIN_ARCH)
    rows, timing, _ = train_run(cfg, TRAIN_STEPS, TRAIN_B, TRAIN_S, "Q2",
                                device)
    finite_falling(rows, "Q2", 5)
    first = rows[0]["loss"]
    check(abs(first - math.log(cfg.vocab_size)) <= 1.0,
          f"Q2: first loss {first:.4f} within 1 of ln V "
          f"{math.log(cfg.vocab_size):.4f}")
    return dict(arch=cfg.name, layers=cfg.num_layers, batch=TRAIN_B,
                seq_len=TRAIN_S, steps=TRAIN_STEPS,
                losses=[r["loss"] for r in rows], **timing)


def train_moe(get_config, device: str = "cuda") -> dict:
    """Q3: DeepSeek-MoE-16B at full width cut to
    :data:`TRAIN_MOE_LAYERS` layers (the dense prefix layer and 3 MoE
    layers), 10 steps of 8 × 256 tokens: the aux losses finite and
    non-zero, every MoE layer's ``expert_counts`` summing to B·S·top-k on
    every step, the loss falling."""
    from repro_torch.configs.base import MOE
    from repro_torch.models import ffn

    full = get_config(TRAIN_MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_MOE_LAYERS)
    n_moe = sum(f == MOE for _, f in cfg.layer_kinds())
    log(f"Q3: {cfg.name} cut from {full.num_layers} to {cfg.num_layers} "
        f"layers ({cfg.num_layers - n_moe} dense, {n_moe} MoE), full width")
    seen = []
    real = ffn.moe_apply

    def spy(*a, **kw):
        y, aux = real(*a, **kw)
        seen.append(aux["expert_counts"].detach())
        return y, aux
    ffn.moe_apply = spy
    try:
        rows, timing, _ = train_run(cfg, TRAIN_MOE_STEPS, TRAIN_B, TRAIN_S,
                                    "Q3", device)
    finally:
        ffn.moe_apply = real
    want = TRAIN_B * TRAIN_S * cfg.moe.top_k
    sums = [int(c.sum()) for c in seen]
    check(len(sums) == n_moe * TRAIN_MOE_STEPS and set(sums) == {want},
          f"Q3: every MoE layer's counts sum to {want} on every step "
          f"({len(sums)} layer calls, sums {sorted(set(sums))})")
    for k in ("moe_lb_loss", "moe_z_loss"):
        check(all(math.isfinite(r[k]) and r[k] != 0 for r in rows),
              f"Q3: {k} finite and non-zero")
    finite_falling(rows, "Q3", 3)
    return dict(arch=cfg.name, layers=cfg.num_layers, moe_layers=n_moe,
                batch=TRAIN_B, seq_len=TRAIN_S, steps=TRAIN_MOE_STEPS,
                losses=[r["loss"] for r in rows],
                moe_lb_loss=[r["moe_lb_loss"] for r in rows],
                moe_z_loss=[r["moe_z_loss"] for r in rows], **timing)


def train_mtp(get_config, device: str = "cuda") -> dict:
    """Q4: ``MTPTrainer`` on DeepSeek-V3 at full width, depth 4 with its
    MTP head, the served path's seed-0 weights made again: head 0, lr
    5e-3, 8 steps on seeded tokens [4, 64]; the last loss below the
    first, and every other weight the same tensor, never written."""
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import flatten
    from repro_torch.serving.mtp import MTPTrainer

    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=4)
    model = Model(cfg)
    t0 = time.monotonic()
    params = model.init(0, device=device)
    torch.cuda.synchronize()
    before = {k: (t, t._version) for k, t in flatten(params).items()
              if not k.startswith("mtp.0.")}
    log(f"Q4: {cfg.name} depth 4 with its MTP head made on the card in "
        f"{time.monotonic() - t0:.1f} s")
    toks = torch.randint(0, cfg.vocab_size, (4, 64), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(1))
    tr = MTPTrainer(model, params, mtp_index=0, lr=5e-3)
    runtime.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(8):
        t0 = time.monotonic()
        losses.append(tr.train_step(toks))
        ms.append((time.monotonic() - t0) * 1e3)
    no_kernel_launched("Q4")
    check(losses[-1] < losses[0], f"Q4: the draft loss falls ({losses})")
    after = flatten(tr.params)
    check(all(after[k] is t and t._version == v
              for k, (t, v) in before.items()),
          "Q4: every main-stack weight (and no other head) untouched")
    check(any(not torch.equal(after[k], flatten(params)[k])
              for k in after if k.startswith("mtp.0.")),
          "Q4: the head was updated")
    res = dict(arch=cfg.name, layers=4, losses=losses, ms_per_step=ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"Q4: draft loss {losses[0]:.4f} -> {losses[-1]:.4f} over 8 steps, "
        f"{statistics.median(ms[1:]):.1f} ms per step (host clock, median "
        f"of steps 2-8; the first {ms[0]:.1f}), peak {res['peak_gib']:.2f} "
        f"GiB")
    return res


def train_checkpoint(get_config, device: str = "cuda") -> dict:
    """Q5: smoke InternLM2 (bf16) on the card: 3 steps and a checkpoint,
    a fresh ``Trainer`` restored from it (its loader moved past the 3
    batches the first run read: the loader is not in a checkpoint, in
    either package) running steps 4 and 5, against 5 steps run straight
    through: every metric and every parameter and moment bit-identical."""
    import shutil
    import tempfile

    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   Trainer)
    from repro_torch.train.checkpoint import _flatten

    cfg = get_config(TRAIN_ARCH + "-smoke")

    def trainer(steps, d):
        return Trainer(cfg, TrainConfig(
            steps=steps, log_every=1, ckpt_dir=d,
            opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=5),
            data=DataConfig(seq_len=64, global_batch=4)), device=device)
    d = tempfile.mkdtemp(prefix="q5_ckpt_")
    try:
        a = trainer(5, None)
        straight = a.run()
        trainer(3, d).run()
        c = trainer(5, d)
        c.maybe_restore()
        check(c.step == 3, f"Q5: restored at step {c.step}")
        for _ in range(c.step):
            c.loader.next_batch()
        resumed = c.run()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in straight[3:]]
    check([{k: v for k, v in r.items() if k != "wall_s"} for r in resumed]
          == strip, "Q5: steps 4-5 after the restore equal the straight "
                    "run's, metric for metric")
    want, got = (dict(_flatten((t.params, t.opt_state))) for t in (a, c))
    check(list(got) == list(want) and all(
        got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
        for k in want), "Q5: every parameter, moment and the step "
                        "bit-identical to the straight run's")
    log(f"Q5: {cfg.name} checkpoint after 3 steps, restored, steps 4-5 "
        f"bit-identical to the straight run (losses "
        f"{[r['loss'] for r in resumed]}, {len(want)} leaves)")
    return dict(arch=cfg.name, losses=[r["loss"] for r in resumed],
                leaves=len(want))


def train_stages(get_config) -> dict:
    """Stage Q: Q1-Q5, each with a line of its own."""
    t0 = time.monotonic()
    out = {}
    for name, fn in (("Q1", lambda: train_parity()),
                     ("Q2", lambda: train_full_width(get_config)),
                     ("Q3", lambda: train_moe(get_config)),
                     ("Q4", lambda: train_mtp(get_config)),
                     ("Q5", lambda: train_checkpoint(get_config))):
        t1 = time.monotonic()
        out[name] = fn()
        free(f"{name}: {time.monotonic() - t1:.1f} s")
        log(json.dumps({"train": name, **out[name]}))
    log(f"training stage: {time.monotonic() - t0:.1f} s")
    return out


#: stage P's deployment: the simulator example's (DeepSeek-V3 on 768
#: dies folded to 8 simulated DP groups; 80 requests/s for 1 s)
SIM_CFG = dict(n_sim_dps=8, eplb_interval_s=0.5)
SIM_WL = dict(arrival_rate=80.0, duration_s=1.0, seed=11)


def sim_run(sim, what: str, **kw):
    """One simulator run at stage P's deployment: (sim, report, host
    wall seconds); every request must finish on the 288/480 plan."""
    t0 = time.monotonic()
    s = sim.SuperPodSim(sim.SimConfig(**SIM_CFG, **kw),
                        sim.WorkloadConfig(**SIM_WL))
    rep = s.run()
    wall = time.monotonic() - t0
    m = rep.summary
    check((s.plan.n_expert, s.plan.n_attention) == (288, 480),
          f"simulator {what}: the 288/480 plan, got {s.plan}")
    check(m["n_finished"] == m["n_requests"] > 0,
          f"simulator {what}: every request finished: {m['n_finished']} "
          f"of {m['n_requests']}")
    log(f"simulator {what} (MODELED CloudMatrix384, 768 dies, not this "
        f"card): {m['throughput_tok_s_per_die']} tok/s/die, TPOT mean "
        f"{m['tpot_mean_s'] * 1e3:.3f} ms p99 {m['tpot_p99_s'] * 1e3:.3f} "
        f"ms, TTFT p99 {m['ttft_p99_s'] * 1e3:.3f} ms, {m['n_finished']} "
        f"requests, {len(s.loop.trace)} events; {wall:.2f} s wall on the "
        f"card's host; digest {rep.trace_hash[:16]}")
    return s, rep, wall


def calibration_rows(results: dict) -> list:
    """The two ``from_calibration`` rows this run measured on the card:
    the host overhead of one DP group's decode iteration, and the share
    of the cold prefix's prefill device time that seeding saved (stage
    B's follow-up turn; clipped to [0, 1] by the reader).

    The overhead is the DeepSeek-V3 decode profile's overhead window:
    its engine step on the host clock less the device busy of the same
    steps, divided by the DP groups that step runs one after the other
    on one host thread (the cost model charges ``iter_overhead`` once
    per DP-group iteration). It is a 4-layer eager step's: the modeled
    die's 61 layers would launch more."""
    prof = results[DEEPSEEK][1]["decode_profile"]
    pre = results[DEEPSEEK + "/pd"][1]["prefill"]
    for k in ("cold_device_ms", "warm_device_ms", "prefix_device_ms"):
        check(pre[k] is not None and pre[k] > 0,
              f"stage B measured the prefill's {k}: {pre[k]}")
    overhead_us = ((prof["overhead_step_ms"] - prof["overhead_busy_ms"])
                   / prof["dp_groups"] * 1e3)
    check(overhead_us > 0, f"the decode iteration's host overhead is "
                           f"positive: {overhead_us} us")
    skip = ((pre["cold_device_ms"] - pre["warm_device_ms"])
            / pre["prefix_device_ms"])
    return [
        {"name": "decode/iter_overhead", "us_per_call": overhead_us,
         "derived": f"(engine_step_ms={prof['overhead_step_ms']} - "
                    f"device_busy_ms={prof['overhead_busy_ms']}) / "
                    f"dp_groups={prof['dp_groups']}, one window "
                    f"(DeepSeek-V3 4 layers eager, {prof['dp_groups']} "
                    f"DP groups "
                    f"x {prof['batch_per_group']} slots)"},
        {"name": "prefill/hit_skip", "us_per_call": skip,
         "derived": f"cold_device_ms={pre['cold_device_ms']} "
                    f"seeded_device_ms={pre['warm_device_ms']} "
                    f"prefix_device_ms={pre['prefix_device_ms']} "
                    f"({pre['prompt_tokens']} tokens, {pre['hit_tokens']} "
                    f"seeded; dimensionless)"}]


def sim_stage(results: dict, smi: str) -> dict:
    """Stage P: the simulator at the example's deployment, analytic
    (colocated and MoE-Attention, each twice: reports must repeat byte
    for byte), then colocated from the two rows this run measured."""
    import numpy as np

    import repro_torch.sim as sim

    t0 = time.monotonic()
    runs = {}
    for dep in ("colocated", "moe_attn"):
        (_, a, wa), (_, b, wb) = (sim_run(sim, f"{dep} run {i}",
                                          deployment=dep) for i in (1, 2))
        check(a.trace_hash == b.trace_hash and a.to_json(
            include_requests=True) == b.to_json(include_requests=True),
            f"simulator {dep}: a second run repeats the digest and the "
            f"report")
        runs[dep] = dict(summary=a.summary, trace_hash=a.trace_hash,
                         wall_s=[wa, wb])
    rows = calibration_rows(results)
    path = ROOT / "chiprun_out" / "sim_calibration.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({"benchmark": "chip_smoke", "device": smi,
                                "rows": rows}, indent=1))
    cal, rep, wall = sim_run(sim, "colocated, calibrated",
                             calibration_paths=(str(path),))
    want = rows[0]["us_per_call"] * 1e-6
    skip = float(np.clip(rows[1]["us_per_call"], 0.0, 1.0))
    check(cal.cost.iter_overhead == want
          and cal.cost.prefill_hit_skip == skip,
          f"the calibrated cost model carries the measured rows: "
          f"iter_overhead {cal.cost.iter_overhead} (row {want}), "
          f"prefill_hit_skip {cal.cost.prefill_hit_skip} (row {skip})")
    runs["colocated, calibrated"] = dict(
        summary=rep.summary, trace_hash=rep.trace_hash, wall_s=[wall],
        rows=rows, calibration_file=str(path.relative_to(ROOT)))
    a, c = runs["colocated"]["summary"], rep.summary
    log(f"simulator calibrated from this card ({smi}): decode/iter_overhead "
        f"{rows[0]['us_per_call']:.2f} us per DP-group iteration of a "
        f"4-layer eager step (analytic 1000), prefill/hit_skip "
        f"{rows[1]['us_per_call']:.4f} (analytic 1.0); the die's compute is "
        f"still the MODELED die's, only these two rows are the card's. "
        f"Modeled pod, analytic vs calibrated: "
        f"{a['throughput_tok_s_per_die']} vs {c['throughput_tok_s_per_die']} "
        f"tok/s/die, TPOT mean {a['tpot_mean_s'] * 1e3:.3f} vs "
        f"{c['tpot_mean_s'] * 1e3:.3f} ms, TTFT p99 "
        f"{a['ttft_p99_s'] * 1e3:.3f} vs {c['ttft_p99_s'] * 1e3:.3f} ms")
    log(f"simulator stage: {time.monotonic() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# stage R: the multi-device layer (mesh context, sharding rules, XCCL)
# ---------------------------------------------------------------------------
R_B, R_S, R_L, R_STEPS, R_NEW = 4, 32, 64, 4, 8
#: R2's meshes of two ranks: name → (shape, EP axis, the decode rules)
R2_MESHES = {"2x1": ((2, 1), ("data", "model"), True),
             "1x2": ((1, 2), "model", False)}
#: R2's models: arch → depth (no MTP head)
R2_MODELS = {DEEPSEEK: 4, LLAMA: 2}
R2_PROMPTS = {DEEPSEEK: PROMPTS, LLAMA: LLAMA_PROMPTS[1:]}
#: R2's control: a capacity factor at which no MoE pack of its logits
#: drops an assignment on either side (the gather strategy everywhere)
R2_NO_DROP_CF = 64.0
R0_BLOCK = 1 << 20
#: R0 holds the seed's weights of DeepSeek-V3 at this depth (one dense
#: layer, the embedding, lm_head and the MTP head)
R0_DEPTH = 1


def r_inputs(cfg):
    """Seeded tokens: [R_B, R_S] prompts and R_STEPS decode rounds."""
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (R_B, R_S), generator=gen)
    dec = torch.randint(0, cfg.vocab_size, (R_STEPS, R_B, 1), generator=gen)
    return toks, dec


@torch.no_grad()
def r_logits(model, params, toks, dec) -> dict:
    """Global logits (f32, on the host) of a prefill, of the same prompts
    in two chunks, and of R_STEPS decode steps from the chunked cache."""
    dev = "cuda"
    toks, dec = toks.to(dev), dec.to(dev)
    out = {"prefill": model.prefill(params, toks)[0].float().cpu()}
    cache = model.init_cache(R_B, R_L, device=dev)
    half = R_S // 2
    last = torch.full((R_B,), half - 1, device=dev)
    _, cache = model.prefill_chunk(params, cache, toks[:, :half], 0, last)
    lc, cache = model.prefill_chunk(params, cache, toks[:, half:], half, last)
    out["chunk"] = lc.float().cpu()
    cache = model.place_cache(cache, R_B)
    for i in range(R_STEPS):
        ld, cache = model.decode_step(
            params, cache, dec[i],
            torch.full((R_B,), R_S + i, dtype=torch.int32, device=dev))
        out[f"decode{i}"] = ld.float().cpu()
    torch.cuda.synchronize()
    return out


def r0_init(cfg, params) -> dict:
    """R0: the weights ``init(0, "cuda")`` made against ``init(0, "cpu")``, leaf by leaf, bit for bit: every element
    of a leaf up to 4 Mi elements, and of a larger leaf three blocks of
    about 1 Mi elements (its first, middle and last indices along the
    first dim whose single index spans at most 16 Mi elements): the host
    draws tens of ns an element, so a whole 15.8 B-parameter tree takes
    it minutes."""
    from repro_torch.launch.sharding import PSpec
    from repro_torch.models.common import dense_init, embed_init, part_seed
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import flatten

    model, flat = Model(cfg), flatten(params)
    t0 = time.monotonic()
    n_leaves = whole = compared = 0
    for i, (path, s) in enumerate(flatten(model.param_spec()).items()):
        card = flat[path]
        n_leaves += 1
        if card.numel() <= 4 * R0_BLOCK or s.init not in ("dense", "embed"):
            cpu = model.init_leaf(0, i, s, PSpec(), "cpu")
            check(torch.equal(card.cpu(), cpu), f"R0 {path}: card == CPU")
            whole += 1
            compared += cpu.numel()
            continue
        shape = tuple(s.shape)
        k = next(d for d in range(len(shape))
                 if math.prod(shape) // shape[d] <= 16 * R0_BLOCK)
        one = math.prod(shape) // shape[k]
        r = max(1, R0_BLOCK // one)
        for lo in sorted({0, (shape[k] - r) // 2, shape[k] - r}):
            blk = (shape, k, lo, lo + r)
            if s.init == "embed":
                cpu = embed_init(shape, s.dtype, part_seed(0, i), "cpu",
                                 block=blk)
            else:
                cpu = dense_init(shape, s.dtype, s.fan_in, part_seed(0, i),
                                 "cpu", block=blk)
            check(torch.equal(card.narrow(k, lo, r).cpu(), cpu),
                  f"R0 {path} [{lo}, {lo + r}) of dim {k}: card == CPU")
            compared += cpu.numel()
    total = sum(t.numel() for t in flat.values())
    res = dict(leaves=n_leaves, leaves_whole=whole, elements=total,
               elements_compared=compared, seconds=time.monotonic() - t0)
    log(f"R0: init(0, 'cuda') == init(0, 'cpu') bit for bit on {n_leaves} "
        f"leaves ({whole} whole; {compared / 1e6:.1f} M of "
        f"{total / 1e9:.2f} B elements) in {res['seconds']:.1f} s")
    return res


R1_PROMPTS = {DEEPSEEK: PROMPTS, LLAMA: LLAMA_PROMPTS[1:]}


def r1_rank(rank, world, init):
    """R1 in a process of its own (the NCCL group stays out of the main
    process): for DeepSeek-V3 (depth 4, its MTP head) and Llama-4 (depth
    2), the seed's weights made on the card, :func:`r1_world_one`; on
    DeepSeek-V3's, S1 (:func:`s1_world_one`). → path → result."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model

    mesh = init_mesh((1, 1), "nccl", "cuda", rank=rank, world_size=world,
                     init_method=init)
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",), remat="none")
    out = {}
    for arch, depth in ((DEEPSEEK, 4), (LLAMA, 2)):
        cfg = dataclasses.replace(get_config(arch), num_layers=depth)
        params = Model(cfg).init(0, device="cuda")
        out[f"{arch}/R1"] = r1_world_one(cfg, params, R1_PROMPTS[arch], ctx)
        if arch == DEEPSEEK:
            out[f"{arch}/S1"] = s1_world_one(cfg, params, ctx)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def r1_world_one(cfg, params, prompts, ctx) -> dict:
    """R1: world size 1 over NCCL — ``ctx`` on a live 1×1 mesh, its
    process group NCCL's — on one set of weights: the mesh serves the
    same greedy tokens with the same kernel launches as the one-device
    engine, and gives bit-identical prefill, chunk and decode logits."""
    from repro_torch.kernels import runtime
    from repro_torch.serving.flowserve import FlowServeEngine

    toks, dec = r_inputs(cfg)
    out = {}
    for name, c in (("one_device", None), ("mesh", ctx)):
        eng = FlowServeEngine(cfg, params, device="cuda", n_dp_groups=2,
                              max_batch=4, ctx=c)
        check(eng.model.sharded == (c is not None),
              f"R1 {name}: the {'mesh' if c else 'one-device'} path")
        runtime.reset_launch_counts()
        reqs, wall = serve(eng, prompts, R_NEW)
        launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
        out[name] = dict(tokens=[list(r.output_tokens) for r in reqs],
                         launches=launches, fused=fused, serve_s=wall,
                         logits=r_logits(eng.model, params, toks, dec))
        eng.close()
        del eng
    a, b = out["one_device"], out["mesh"]
    check(a["tokens"] == b["tokens"], f"R1: the mesh path's greedy tokens "
          f"are the one-device engine's: {a['tokens']} vs {b['tokens']}")
    check(a["launches"] == b["launches"] and a["fused"] == b["fused"],
          f"R1: the same kernel launches: {a['launches']} vs "
          f"{b['launches']}")
    for k in a["logits"]:
        check(torch.equal(a["logits"][k], b["logits"][k]),
              f"R1: {k} logits bit-identical")
    res = dict(tokens=a["tokens"], launches=a["launches"],
               serve_s=[a["serve_s"], b["serve_s"]],
               logits_compared=sorted(a["logits"]))
    log(f"R1 {cfg.name}: a live 1x1 NCCL mesh serves the one-device "
        f"engine's tokens with its launches {a['launches']}; prefill, "
        f"chunk and {R_STEPS} decode logits bit-identical")
    return res


class Replayer:
    """Stands in for the kernel wrappers that the ``ops`` modules call on
    a rank of R2: each launch runs the kernel (counted by its wrapper),
    then its plain version on the same inputs (uncounted), and holds the
    two: route-pack exactly (its Collect counts too), the grouped FFNs
    and decode attention within 3e-2 (bf16; decode attention's partial
    output normalised by its own sum, and its max and sum beside it)."""

    def __init__(self):
        from repro_torch.kernels.decode_attention import ops as da_ops
        from repro_torch.kernels.gmm import ops as gmm_ops
        from repro_torch.kernels.route_pack import ops as rp_ops

        self.mods = ((rp_ops, "route_pack_cuda", self.route_pack),
                     (gmm_ops, "gmm_cuda", self.gmm),
                     (da_ops, "decode_attention_cuda", self.attention))
        self.real = {n: getattr(m, n) for m, n, _ in self.mods}
        self.errs, self.calls = {}, {}
        #: valid assignments the packs left out (over capacity)
        self.drops = 0
        #: False: pass the launches through, only counting drops
        self.replay = True
        #: each MoE layer call's routed expert ids [T, k] (the pack's
        #: count ids), in call order
        self.routes = []

    def __enter__(self):
        for m, n, fn in self.mods:
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for m, n, _ in self.mods:
            setattr(m, n, self.real[n])

    def note(self, name, err):
        self.errs[name] = max(self.errs.get(name, 0.0), err)
        self.calls[name] = self.calls.get(name, 0) + 1

    def route_pack(self, x, dest, valid, eid, **kw):
        from repro_torch.kernels.route_pack.ref import route_pack_ref

        got = self.real["route_pack_cuda"](x, dest, valid, eid, **kw)
        live = dest < kw["n_dest"]
        if valid is not None:
            live &= valid.bool()
        self.drops += int((live & ~got.keep).sum())
        if kw.get("count_ids") is not None:
            self.routes.append(kw["count_ids"].view(-1, kw["k"]).cpu())
        if not self.replay:
            return got
        self.note("route_pack", pack_err(
            got, route_pack_ref(x, dest, valid, eid, **kw),
            f"R2 route_pack T={x.shape[0]} n_dest={kw['n_dest']}"))
        if kw.get("count_ids") is not None:
            self.note("collect", 0.0)
        return got

    def gmm(self, b, wg, wu, wd, own=None):
        from repro_torch.kernels.gmm.ref import gmm_ref, placement_gmm_ref

        got = self.real["gmm_cuda"](b, wg, wu, wd, own)
        if not self.replay:
            return got
        want = (gmm_ref(b, wg, wu, wd) if own is None
                else placement_gmm_ref(b, wg, wu, wd, own))
        err = (got - want).abs().max().item() if got.numel() else 0.0
        name = "gmm" if own is None else "placement_gmm"
        check(err <= 3e-2, f"R2 {name} {tuple(b.shape)}: max abs err {err}")
        self.note(name, err)
        return got

    def attention(self, q, k, v, positions, *, window=0, partial=False):
        from repro_torch.kernels.decode_attention.ref import (
            decode_attention_partial_ref, decode_attention_ref)

        got = self.real["decode_attention_cuda"](q, k, v, positions,
                                                 window=window,
                                                 partial=partial)
        if not self.replay:
            return got
        what = f"R2 decode attention {tuple(k.shape)}"
        if not partial:
            err, _ = held_attention(got, decode_attention_ref(
                q, k, v, positions, window=window), 3e-2, what)
            self.note("decode_attention", err)
            return got
        acc, m, l = got
        racc, rm, rl = decode_attention_partial_ref(q, k, v, positions,
                                                    window=window)
        err, _ = held_attention(acc / l.clamp(min=1e-30)[..., None],
                                racc / rl.clamp(min=1e-30)[..., None],
                                3e-2, what + " (partial)")
        check(torch.equal(torch.isinf(m), torch.isinf(rm))
              and float((m - rm).nan_to_num().abs().max()) <= 3e-2
              and float(((l - rl).abs() / rl.clamp(min=1e-30)).max())
              <= 3e-2, f"{what}: partial max and sum within 3e-2")
        self.note("decode_attention_partial", err)
        return got


def r_logits_and_drops(model, params, toks, dec, rep,
                       replay: bool = True) -> tuple:
    """:func:`r_logits` and the assignments its MoE packs dropped; with
    ``replay=False`` (the no-drop control, off the path) its launches
    are not replayed on the plain versions."""
    before, rep.replay, rep.routes = rep.drops, replay, []
    try:
        out = r_logits(model, params, toks, dec)
    finally:
        rep.replay = True
    return out, rep.drops - before, rep.routes


def last_routes(routes: list) -> dict:
    """The sorted expert set [R_B, k] of each row's last token in the MoE
    layer (the models' only one, their last layer: a token's logits read
    no other token's MoE output) for each of :func:`r_logits`' keys,
    from one rank's route list: prefill, chunk 1, chunk 2, decode steps
    (an all-to-all rank holds a block of the sequence: the last block's
    rank gives prefill and chunk)."""
    keys = ["prefill", None, "chunk"] + [f"decode{i}"
                                         for i in range(R_STEPS)]
    check(len(routes) == len(keys), f"R2: one MoE call per step "
                                    f"({len(routes)})")
    return {key: r.view(R_B, -1, r.shape[-1])[:, -1].sort(-1).values
            for key, r in zip(keys, routes) if key}


def routed_alike(ref: list, got: list, alltoall: bool) -> dict:
    """key → [R_B] bool: rows whose last token went to the same experts
    on one device and on the ranks (``got``: each rank's routes)."""
    want = last_routes(ref)
    mine = last_routes(got[0])
    if alltoall:                 # prefill and chunk: the last seq block
        last = last_routes(got[-1])
        mine.update(prefill=last["prefill"], chunk=last["chunk"])
    return {k: (want[k] == mine[k]).all(-1) for k in want}


def no_drop(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=R2_NO_DROP_CF))


@torch.no_grad()
def r_pinned_logits(cfg, params, toks, dec, routes) -> dict:
    """:func:`r_logits` of the no-drop control on one device with each
    decode step's MoE routing pinned to ``routes`` (one rank's no-drop
    routes, in call order, as :func:`last_routes` reads them): the expert
    ids the ranks chose for every row, weighted by this device's router
    probabilities at those ids. The witness that a row routed otherwise
    moves only by its routing."""
    from repro_torch.models import ffn
    from repro_torch.models.transformer import Model

    check(len(routes) == 3 + R_STEPS, f"R2: one MoE call per step "
                                      f"({len(routes)})")
    pins = iter([None] * 3 + list(routes[3:]))
    real = ffn._route

    def route(x_flat, router_w, top_k):
        idx, w, probs, logits = real(x_flat, router_w, top_k)
        pin = next(pins)
        if pin is not None:
            check(tuple(pin.shape) == tuple(idx.shape),
                  f"R2 pinned routes {tuple(pin.shape)} for "
                  f"{tuple(idx.shape)}")
            idx = pin.to(device=idx.device, dtype=idx.dtype)
            w = probs.gather(-1, idx)
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        return idx, w, probs, logits
    ffn._route = route
    try:
        return r_logits(Model(no_drop(cfg)), params, toks, dec)
    finally:
        ffn._route = real


def r2_rank(rank, world, init, cases, inputs):
    """One rank of R2 (a process; the two share the card over gloo): for
    each (arch, mesh) of ``cases``, the model's blocks made from the seed
    on this rank, every kernel launch replayed on its plain version
    (:class:`Replayer`), greedy serving with the launch counts set to 0
    just before and read just after, then the global logits of
    :func:`r_logits` (and of the no-drop control, :data:`R2_NO_DROP_CF`
    and the gather strategy, on the same weights), the bytes each
    collective moves in one decode step, and this process's peak
    memory."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import flatten
    from repro_torch.serving.flowserve import FlowServeEngine

    out, meshes = {}, {}
    for arch, mname in cases:
        shape, ep, decode_rules = R2_MESHES[mname]
        if shape not in meshes:
            meshes[shape] = init_mesh(shape, "gloo", "cuda", rank=rank,
                                      world_size=world, init_method=init)
        mesh = meshes[shape]
        ctx = MeshCtx(mesh=mesh, batch_axes=("data",), remat="none",
                      ep_axis=ep)
        rules = shd.DECODE_RULES if decode_rules else None
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=R2_MODELS[arch],
                                  mtp_num_layers=0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        eng = FlowServeEngine(cfg, device="cuda", n_dp_groups=2,
                              max_batch=R_B, seed=0, ctx=ctx, rules=rules)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        held = sum(t.numel() for t in flatten(eng.params).values())
        with Replayer() as rep:
            runtime.reset_launch_counts()
            mesh.comm.sent.clear()
            mesh.comm.staged.clear()
            reqs, wall = serve(eng, R2_PROMPTS[arch], R_NEW)
            launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
            replayed = dict(rep.calls)
            serve_sent = dict(mesh.comm.sent)
            toks, dec = inputs[arch]
            logits, drops, routes = r_logits_and_drops(
                eng.model, eng.params, toks, dec, rep)
            control = Model(no_drop(cfg), ctx=dataclasses.replace(
                ctx, moe_impl="gather"), rules=rules)
            nd_logits, nd_drops, nd_routes = r_logits_and_drops(
                control, eng.params, toks, dec, rep, replay=False)
        # the wire of one decode step of R_B rows: from a placed cache
        cache = eng.model.place_cache(
            eng.model.prefill_chunk(
                eng.params, eng.model.init_cache(R_B, R_L, device="cuda"),
                toks.cuda(), 0,
                torch.full((R_B,), R_S - 1, device="cuda"))[1], R_B)
        mesh.comm.sent.clear()
        mesh.comm.staged.clear()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        with torch.no_grad():
            eng.model.decode_step(eng.params, cache, dec[0].cuda(),
                                  torch.full((R_B,), R_S, dtype=torch.int32,
                                             device="cuda"))
        torch.cuda.synchronize()
        step_s = time.monotonic() - t1
        out[(arch, mname)] = dict(
            tokens=[list(r.output_tokens) for r in reqs], logits=logits,
            drops=drops, no_drop_logits=nd_logits, no_drop_drops=nd_drops,
            routes=routes, no_drop_routes=nd_routes,
            launches=launches, fused=fused, replay_err=rep.errs,
            replayed=replayed, params_held=held, init_s=init_s,
            serve_s=wall, serve_sent=serve_sent,
            step_sent=dict(mesh.comm.sent),
            step_staged=dict(mesh.comm.staged), step_s=step_s,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        eng.close()
        del eng, cache
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_partial_attention() -> dict:
    """The decode-attention kernel's partial output at a shard's shape:
    Llama-4 decode, B 4, 40 heads on 8 KV heads, hd 128, bf16, 512 of the
    cache's 1024 slots on each of 2 ranks (this rank the second, every
    slot valid): held to its plain version, timed (CUDA events and device
    time, one launch per call) beside the plain version and SDPA on the
    same shard (SDPA returns no max or sum, so it is not a partial), and
    its bytes bound at 3.35 TB/s."""
    from repro_torch.kernels.decode_attention.kernel import (
        _n_sms, decode_attention_cuda, plan)
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_partial_ref

    B, H, KV, hd, L = 4, 40, 8, 128, 512
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((B, H, hd), generator=gen).to(torch.bfloat16).cuda()
    k = torch.randn((B, L, KV, hd), generator=gen).to(torch.bfloat16).cuda()
    v = torch.randn((B, L, KV, hd), generator=gen).to(torch.bfloat16).cuda()
    pos = torch.full((B,), 1023 - 512, dtype=torch.int32, device="cuda")

    def kernel():
        return decode_attention_cuda(q, k, v, pos, partial=True)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True)
    acc, m, l = kernel()
    racc, rm, rl = decode_attention_partial_ref(q, k, v, pos)
    err, scaled = held_attention(acc / l[..., None], racc / rl[..., None],
                                 3e-2, "partial at the Llama-4 shard")
    check(torch.equal(kernel()[0], acc), "partial: a repeat bit-identical")
    prof = profile_calls(kernel)
    one_launch(prof, "decode_attention_kernel", "partial at the Llama-4 "
                                                "shard")
    ms, lib_ms = time_pair(kernel, sdpa)
    bnd, by = bound_ms(nbytes(q, k, v, pos) + nbytes(acc, m, l),
                       4 * B * L * H * hd)
    res = dict(ms=ms, device_ms=prof["device_ms"],
               plain_ms=time_ms(lambda: decode_attention_partial_ref(
                   q, k, v, pos), reps=5, warm=1),
               library_ms=lib_ms, library_device_ms=device_ms(sdpa),
               library_returns_lse=False, bound_ms=bnd, bound_by=by,
               max_abs_err=err, scaled_err=scaled,
               profiled_per_call=prof["per_call"],
               shape=dict(B=B, H=H, KV=KV, hd=hd, L=L, of=2 * L))
    attention_row("partial at the Llama-4 shard", res,
                  plan(B, H, KV, hd, L, _n_sms(q.device)), kernel)
    log(f"decode attention partial [{B},{H},{KV},{hd}] x {L} slots: "
        f"{ms:.4f} ms (device {prof['device_ms']}), plain "
        f"{res['plain_ms']:.4f}, SDPA {lib_ms:.4f} (device "
        f"{res['library_device_ms']}; no max or sum), bound {bnd:.4f} ms "
        f"({by}); err {err:.3g}")
    return res


def r2_stage(get_config) -> dict:
    """R1 (:func:`r1_rank`, spawned), then R2: two ranks as two
    processes sharing the card over gloo (NCCL
    refuses two ranks on one device), DeepSeek-V3 (depth 4, no MTP head)
    and Llama-4 (depth 2) at full width on (2,1) — DP attention, EP 2
    under ``DECODE_RULES`` — and (1,2) — TP 2, the KV cache's slots
    sharded, all-to-all prefill. Each rank's kernel launches are
    replayed on their plain versions, and the ranks' greedy tokens must
    be identical (their agreement with the one-device engine's is
    reported). The two-rank logits against a one-device model's on the
    same seeded weights, bar 0.08 relative
    (``tests/test_decode_consistency.py``'s): the decode steps' at the
    configuration's capacity factor; every logit (prefill, chunk,
    decode) of the no-drop control, where no pack on either side drops
    an assignment. At the configuration's capacity the two sides drop
    different assignments by the reference's rules (capacity per shard
    with a 4x margin in the sharded gather, whose masked rows take slots
    of local expert 0; per destination rank in the all-to-all), so the
    prefill and chunk logits are reported beside the assignments each
    side dropped. The witness for the rows a bf16 near-tie routes
    otherwise: the no-drop control on one device with each decode step's
    routing pinned to the ranks' (:func:`r_pinned_logits`), every row of
    every logit within 0.08. Times are not multi-GPU numbers: the wire
    goes through host memory and the ranks time-slice one card."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.transformer import Model
    from repro_torch.serving.flowserve import FlowServeEngine

    inputs, want = {}, {}
    for arch, depth in R2_MODELS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                                  mtp_num_layers=0)
        inputs[arch] = r_inputs(cfg)
        eng = FlowServeEngine(cfg, device="cuda", n_dp_groups=2,
                              max_batch=R_B, seed=0)
        with Replayer() as rep:
            reqs, _ = serve(eng, R2_PROMPTS[arch], R_NEW)
            logits, drops, routes = r_logits_and_drops(
                eng.model, eng.params, *inputs[arch], rep)
            nd_logits, nd_drops, nd_routes = r_logits_and_drops(
                Model(no_drop(cfg)), eng.params, *inputs[arch], rep,
                replay=False)
        check(nd_drops == 0, f"R2 {arch}: the control drops nothing on "
                             f"one device ({nd_drops})")
        want[arch] = dict(tokens=[list(r.output_tokens) for r in reqs],
                          logits=logits, drops=drops, routes=routes,
                          no_drop_logits=nd_logits, no_drop_routes=nd_routes)
        eng.close()
        del eng
        free(f"R2 one-device reference {arch}")
    partial = check_partial_attention()
    t0 = time.monotonic()
    r1 = spawn(r1_rank, 1, threads=8)[0]
    log(f"R1 in its own process: {time.monotonic() - t0:.1f} s")
    cases = [(a, m) for a in R2_MODELS for m in R2_MESHES]
    t0 = time.monotonic()
    ranks = spawn(r2_rank, 2, cases, inputs, threads=4)
    spawn_s = time.monotonic() - t0
    results = {}
    for arch, mname in cases:
        got = [r[(arch, mname)] for r in ranks]
        ref = want[arch]
        check(all(g["tokens"] == got[0]["tokens"] for g in got),
              f"R2 {arch} {mname}: every rank emits the same tokens")
        alltoall = not R2_MESHES[mname][2]     # (1,2): prefill all-to-all

        def rel(key, alike=None):
            """key → the largest relative error of a row (over rows
            routed alike where ``alike`` is given) across the ranks."""
            out = {}
            for k in ref[key]:
                rows = (torch.ones(R_B, dtype=torch.bool) if alike is None
                        else alike[k])
                d = torch.stack([(g[key][k] - ref[key][k]).abs().amax(-1)
                                 for g in got]).amax(0)
                out[k] = float(d[rows].max() / ref[key][k].abs().max()) \
                    if bool(rows.any()) else None
            return out
        errs = rel("logits")
        alike = routed_alike(ref["routes"], [g["routes"] for g in got],
                             alltoall)
        nd_alike = routed_alike(ref["no_drop_routes"],
                                [g["no_drop_routes"] for g in got], False)
        flips = {k: int((~v).sum()) for k, v in nd_alike.items()}
        nd_errs = rel("no_drop_logits", nd_alike)
        check(all(g["no_drop_drops"] == 0 for g in got),
              f"R2 {arch} {mname}: the control drops nothing on 2 ranks")
        check(all(e is None or e <= 0.08 for e in nd_errs.values())
              and sum(flips.values()) <= len(flips) * R_B // 4,
              f"R2 {arch} {mname}: with no assignment dropped, prefill, "
              f"chunk and decode logits of the rows routed alike within "
              f"0.08 of one rank's: {nd_errs}; rows routed otherwise (a "
              f"bf16 near-tie) {flips}")
        dec_errs = rel("logits", alike)
        dec_errs = {k: e for k, e in dec_errs.items()
                    if k.startswith("decode")}
        check(all(e is None or e <= 0.08 for e in dec_errs.values()),
              f"R2 {arch} {mname}: decode logits of the rows routed alike "
              f"within 0.08 of one rank's: {dec_errs} (all rows {errs})")
        flat_a = sum(ref["tokens"], [])
        flat_b = sum(got[0]["tokens"], [])
        agree = sum(x == y for x, y in zip(flat_a, flat_b)) / len(flat_a)
        launches = {k: sum(g["launches"].get(k, 0) for g in got)
                    for k in set().union(*(g["launches"] for g in got))}
        fused = {k: sum(g["fused"].get(k, 0) for g in got)
                 for k in set().union(*(g["fused"] for g in got))}
        kern = {}
        for n in set().union(*(g["replay_err"] for g in got)):
            kern[n] = dict(max_abs_err=max(g["replay_err"].get(n, 0.0)
                                           for g in got))
            check(sum(g["replayed"].get(n, 0) for g in got)
                  == (fused if n == "collect" else launches).get(n, 0),
                  f"R2 {arch} {mname}: every {n} launch replayed")
        if "decode_attention_partial" in kern:
            kern["decode_attention_partial"] = dict(
                partial, max_abs_err=max(
                    partial["max_abs_err"],
                    kern["decode_attention_partial"]["max_abs_err"]))
        path = dict(
            launches=launches, fused=fused, logits_rel_err=errs,
            no_drop_logits_rel_err=nd_errs,
            no_drop_rows_routed_otherwise=flips,
            decode_rel_err_routed_alike=dec_errs,
            rows_routed_otherwise={k: int((~v).sum())
                                   for k, v in alike.items()},
            drops=dict(one_device=ref["drops"],
                       ranks=[g["drops"] for g in got]),
            token_agreement=agree, tokens=got[0]["tokens"],
            ranks=[{k: g[k] for k in ("params_held", "init_s", "serve_s",
                                      "serve_sent", "step_sent",
                                      "step_staged", "step_s", "peak_gib",
                                      "replay_err", "replayed")}
                   for g in got])
        results[f"{arch}/R2-{mname}"] = (kern, path)
        log(f"R2 {arch} {mname}: logits rel err {errs} (assignments "
            f"dropped: one device {ref['drops']}, ranks "
            f"{[g['drops'] for g in got]}); no-drop control {nd_errs} "
            f"(bar 0.08; rows routed otherwise {flips}); decode rows "
            f"routed alike {dec_errs}; greedy tokens agree "
            f"{agree:.3f} with one device; "
            f"launches {launches}; per rank peak "
            f"{[round(g['peak_gib'], 2) for g in got]} GiB, decode-step "
            f"wire bytes {[g['step_sent'] for g in got]}, host-staged "
            f"{[g['step_staged'] for g in got]}, step "
            f"{[round(g['step_s'], 4) for g in got]} s (host wire, one "
            f"time-sliced card)")
    # the witness: the no-drop control with the ranks' decode routing
    # pinned on one device, every row of every logit within the bar
    for arch, depth in R2_MODELS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                                  mtp_num_layers=0)
        params = Model(cfg).init(0, device="cuda")
        for mname in R2_MESHES:
            got = [r[(arch, mname)] for r in ranks]
            pinned = r_pinned_logits(cfg, params, *inputs[arch],
                                     got[0]["no_drop_routes"])
            errs = {k: max(float((g["no_drop_logits"][k] - v).abs().max()
                                 / v.abs().max()) for g in got)
                    for k, v in pinned.items()}
            check(all(e <= 0.08 for e in errs.values()),
                  f"R2 {arch} {mname}: every logit of the no-drop control "
                  f"within 0.08 of one device's with the ranks' decode "
                  f"routing: {errs}")
            results[f"{arch}/R2-{mname}"][1][
                "no_drop_pinned_rel_err"] = errs
            log(f"R2 {arch} {mname}: no-drop control, every row, against "
                f"one device with the ranks' decode routing pinned: "
                f"{errs} (bar 0.08)")
        del params
        free(f"R2 pinned witness {arch}")
    check(any("decode_attention_partial" in k for k, _ in results.values()),
          "R2 launched the partial decode attention")
    for path, res in r1.items():
        results[path] = ({}, res)
    log(f"R2: {len(cases)} cases on 2 ranks in {spawn_s:.1f} s")
    return results


# ---------------------------------------------------------------------------
# stage S: serving on a mesh — MTP, prefix-KV seeding, disaggregated PD —
# and the KV moved between rank groups
# ---------------------------------------------------------------------------
#: S's disaggregated PD: one prefill TE of two DP groups, one decode TE,
#: the pod-pooled directory and MTP k 1 on the decode side
S_PD_KW = dict(PD_KW, n_prefill_te=1, kv_pool=True, mtp_k=1)
#: S2's verify chain and S4's transfer: the prompt of one request
S4_LEN = 512
#: S1's prefix split (DeepSeek-V3: PD_WAVES' first prompt, 84 tokens)
#: and S3's (Llama-4: LLAMA_PROMPTS[0], 826 tokens)
S1_STOPS, S3_STOPS = (64, 84), (512, 816, 826)


@torch.no_grad()
def s_prefix(model, params, toks, stops, max_len: int) -> dict:
    """Prefix seeding on ``model``'s mesh: ``toks`` prefilled cold in
    chunks ending at ``stops``, then seeded from the cold cache's
    16-token block payloads up to the last stop but one and only the
    suffix prefilled (logits and valid-region KV bit-identical, the same
    split); then the pod path: a DP group caches the prompt's head,
    another seeds from its blocks (a remote hit) and then from its own
    (a local hit)."""
    from repro_torch.serving.backend import TorchBackend
    from repro_torch.serving.dp_group import DPGroup
    from repro_torch.serving.kv_cache import PodKVDirectory
    from repro_torch.serving.request import Request
    from repro_torch.xccl.pd_transfer import pytree_bytes, slice_kv_chunk

    n, seed = len(toks), stops[-2]
    be = TorchBackend(model, params, max_len=max_len, device="cuda")
    check(be.supports_prefix_kv, f"{model.cfg.name}: prefix KV on its mesh")

    def cold():
        return chunked(be, toks, stops)

    def seeded():
        return be.prefill_chunk(
            be.seed_prefill_cache(be.read_remote_kv(payloads), seed, n),
            toks[seed:], seed, n)
    cache_c, log_c = cold()
    payloads = [slice_kv_chunk(cache_c, b * 16, (b + 1) * 16)
                for b in range(seed // 16)]
    cache_s, log_s = seeded()
    check((log_c == log_s).all() and kv_equal(slice_kv_chunk(cache_s, 0, n),
                                              slice_kv_chunk(cache_c, 0, n)),
          f"{model.cfg.name} prefix on its mesh: seeded at {seed} == cold "
          f"split at {stops}, logits and KV bit for bit")
    res = dict(cold_logits=log_c, seeded_logits=log_s,
               cold_ms=time_ms(cold, reps=3, warm=1),
               seeded_ms=time_ms(seeded, reps=3, warm=1),
               payload_bytes=sum(pytree_bytes(p) for p in payloads))
    pod = PodKVDirectory()
    dps = [DPGroup(i, TorchBackend(model, params, max_len=max_len,
                                   device="cuda"), max_batch=2,
                   max_len=max_len, pod_directory=pod) for i in (0, 1)]
    try:
        dps[0].run_prefill(Request(prompt_tokens=toks[:seed + 4],
                                   max_new_tokens=1))
        remote = Request(prompt_tokens=list(toks), max_new_tokens=1)
        _, res["remote_logits"] = dps[1].run_prefill(remote)
        local = Request(prompt_tokens=list(toks), max_new_tokens=1)
        _, res["local_logits"] = dps[1].run_prefill(local)
        res["hits"] = (remote.prefix_hit_tokens, local.prefix_hit_tokens,
                       dps[1].n_remote_hits, pod.n_remote_acquires,
                       pod.n_releases)
    finally:
        for d in dps:
            d.close()
    check(res["hits"][0] == seed and res["hits"][2] == 1
          and res["hits"][1] >= seed and res["hits"][3] == res["hits"][4],
          f"{model.cfg.name} prefix on its mesh: a remote hit of {seed} "
          f"tokens, then a local one, every pin released: {res['hits']}")
    return res


def s1_world_one(cfg, params, ctx) -> dict:
    """S1: on ``ctx``, a live 1×1 NCCL mesh, MTP serving at k 1 and 2,
    prefix seeding and ``DisaggregatedPD(ctx=)`` (the pod directory, MTP
    k 1) against the one-device runs on the same weights: the same
    tokens, hits and streams, the same kernel launches, the prefix
    logits bit for bit."""
    from repro_torch.core import DisaggregatedPD
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import Model
    from repro_torch.serving.flowserve import FlowServeEngine
    from repro_torch.serving.tokenizer import ByteTokenizer

    toks = ByteTokenizer().encode(PD_WAVES[0][0])
    check(len(toks) == S1_STOPS[-1], f"S1: an {S1_STOPS[-1]}-token prompt")
    out = {}
    for name, c in (("one_device", None), ("mesh", ctx)):
        run = {}
        for k in (1, 2):
            eng = FlowServeEngine(cfg, params, device="cuda", n_dp_groups=2,
                                  max_batch=4, mtp_k=k, ctx=c)
            runtime.reset_launch_counts()
            reqs, wall = serve(eng, PROMPTS, R_NEW)
            run[f"mtp{k}"] = dict(tokens=[list(r.output_tokens)
                                          for r in reqs],
                                  launches=dict(runtime.LAUNCHES),
                                  fused=dict(runtime.FUSED), serve_s=wall)
            eng.close()
        runtime.reset_launch_counts()
        pre = s_prefix(Model(cfg, ctx=c), params, toks, S1_STOPS, 256)
        run["prefix"] = dict(pre, launches=dict(runtime.LAUNCHES),
                             fused=dict(runtime.FUSED))
        pd = DisaggregatedPD(cfg, params, device="cuda", ctx=c, **S_PD_KW)
        runtime.reset_launch_counts()
        try:
            reqs = serve_pd(pd, PD_WAVES, R_NEW)
            run["pd"] = dict(summary=pd_summary(pd, reqs),
                             launches=dict(runtime.LAUNCHES),
                             fused=dict(runtime.FUSED))
        finally:
            pd.close()
        out[name] = run
        free(f"S1 {name}")
    a, b = out["one_device"], out["mesh"]
    for part in ("mtp1", "mtp2", "prefix", "pd"):
        x, y = a[part], b[part]
        check(x["launches"] == y["launches"] and x["fused"] == y["fused"],
              f"S1 {part}: the mesh launches the one-device kernels: "
              f"{x['launches']} vs {y['launches']}")
    for k in (1, 2):
        check(a[f"mtp{k}"]["tokens"] == b[f"mtp{k}"]["tokens"],
              f"S1 MTP k {k}: the one-device tokens")
    check(a["pd"]["summary"] == b["pd"]["summary"],
          "S1 PD: the one-device TE choices, hits, streams and tokens")
    for key in ("cold_logits", "seeded_logits", "remote_logits",
                "local_logits"):
        check((a["prefix"][key] == b["prefix"][key]).all(),
              f"S1 prefix {key} bit for bit")
    check(a["prefix"]["hits"] == b["prefix"]["hits"], "S1 prefix hits")
    launches = collections_sum([b[p]["launches"] for p in b])
    fused = collections_sum([b[p]["fused"] for p in b])
    res = dict(launches=launches, fused=fused,
               tokens={f"mtp{k}": b[f"mtp{k}"]["tokens"] for k in (1, 2)},
               launches_by_part={p: b[p]["launches"] for p in b},
               prefix_hits=b["prefix"]["hits"],
               pd=b["pd"]["summary"],
               prefix_ms={n: dict(cold=out[n]["prefix"]["cold_ms"],
                                  seeded=out[n]["prefix"]["seeded_ms"])
                          for n in out},
               serve_s={n: [out[n][f"mtp{k}"]["serve_s"] for k in (1, 2)]
                        for n in out})
    log(f"S1 {cfg.name}: a live 1x1 NCCL mesh serves MTP k 1 and 2, "
        f"prefix seeding and disaggregated PD with the one-device "
        f"engine's tokens and launches ({launches}); prefix logits bit "
        f"for bit; hits {res['prefix_hits']}")
    return res


def collections_sum(dicts) -> dict:
    """Key-wise sum of count dicts."""
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def s_cfg(get_config, arch: str, depth: int):
    """S's models: full width, cut to ``depth`` layers (DeepSeek-V3 with
    its MTP head)."""
    return dataclasses.replace(get_config(arch), num_layers=depth)


@torch.no_grad()
def s_verify(model, params, toks, dec, drafts, rep) -> dict:
    """One MTP iteration's chain from the prefill of ``toks`` [R_B, R_S]:
    the head's draft logits on ``dec`` [R_B, 1] (a zero hidden), and the
    verify chain's two decode steps on ``dec`` then ``drafts`` (given,
    so both sides verify the same tokens), with each step's routes
    (``rep``). Global logits, f32 on the host."""
    dev = "cuda"
    toks, dec, drafts = toks.to(dev), dec.to(dev), drafts.to(dev)
    cache = model.place_cache(model.prefill_chunk(
        params, model.init_cache(R_B, R_L, device=dev), toks, 0,
        torch.full((R_B,), R_S - 1, device=dev))[1], R_B)
    mtp = model.init_mtp_cache(R_B, R_L, device=dev, local=True)
    pos = torch.full((R_B,), R_S, dtype=torch.int32, device=dev)
    out = {"draft": model.mtp_step(params, 0, mtp["hidden"], dec, pos,
                                   mtp["kv"])[0].float().cpu()}
    before, rep.replay, rep.routes = rep.drops, False, []
    try:
        for j, tok in enumerate((dec, drafts[:, None])):
            out[f"verify{j}"] = model.decode_step_hidden(
                params, cache, tok, pos + j)[0].float().cpu()
    finally:
        rep.replay = True
    out["routes"] = rep.routes
    out["drops"] = rep.drops - before
    torch.cuda.synchronize()
    return out


def s_rank(rank, world, init, inputs):
    """One rank of S2-S4 (a process; the two share the card over gloo).
    S2: DeepSeek-V3 (depth 4, its MTP head) on (2,1) under
    ``DECODE_RULES`` — EP 2 over the data axis, DP attention: the
    paper's decode deployment — serving with MTP k 1 (each launch
    replayed on its plain version), counts set to 0 just before and read
    just after; every iteration's blocks, accepted counts and wire and
    host-staged bytes; :func:`s_verify`; a 512-token prefill's chunk
    buffer (the same global KV on both ranks); then ``DisaggregatedPD``
    on the mesh. S4: that KV from rank 0 to rank 1 over the ``pd`` axis
    of a (2,1,1) mesh, hashed on both sides. S3: Llama-4 (depth 2) on
    (1,2) (TP 2, the decode cache's slots cut), :func:`s_prefix`, then
    decode steps of the seeded slot."""
    import hashlib

    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.core import DisaggregatedPD
    from repro_torch.kernels import runtime
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import PD_AXES, init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model
    from repro_torch.serving.backend import TorchBackend
    from repro_torch.serving.dp_group import DPGroup
    from repro_torch.serving.flowserve import FlowServeEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.tokenizer import ByteTokenizer
    from repro_torch.xccl.pd_transfer import (KVLayout, execute_transfer,
                                              plan_transfer)

    out = {}
    mesh = init_mesh((2, 1), "gloo", "cuda", rank=rank, world_size=world,
                     init_method=init)
    comm = mesh.comm
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",), remat="none",
                  ep_axis=("data", "model"))
    cfg = s_cfg(get_config, DEEPSEEK, 4)
    torch.cuda.reset_peak_memory_stats()
    eng = FlowServeEngine(cfg, device="cuda", n_dp_groups=2, max_batch=R_B,
                          seed=0, ctx=ctx, rules=shd.DECODE_RULES, mtp_k=1)
    iters = []
    for dp in eng.dps:
        def spy(*a, _real=dp.backend.decode_sample_mtp, **kw):
            sent, staged = sum(comm.sent.values()), sum(comm.staged.values())
            got = _real(*a, **kw)
            iters.append((got[0].tolist(), got[1].tolist(),
                          sum(comm.sent.values()) - sent,
                          sum(comm.staged.values()) - staged))
            return got
        dp.backend.decode_sample_mtp = spy
    with Replayer() as rep:
        runtime.reset_launch_counts()
        comm.sent.clear()
        comm.staged.clear()
        reqs, wall = serve(eng, PROMPTS, R_NEW)
        launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
        replayed, errs = dict(rep.calls), dict(rep.errs)
        serve_sent = dict(comm.sent)
        verify = s_verify(eng.model, eng.params, *inputs["verify"], rep)
    # a buffer of the prompt's length (the engine's is 256)
    be = TorchBackend(eng.model, eng.params, max_len=S4_LEN, device="cuda")
    toks = list(range(3, 3 + S4_LEN))
    kv, _ = be.prefill_chunk(None, toks, 0, S4_LEN)
    for dp in eng.dps:
        del dp.backend.decode_sample_mtp
    out["S2"] = dict(
        tokens=[list(r.output_tokens) for r in reqs], iters=iters,
        launches=launches, fused=fused, replayed=replayed, replay_err=errs,
        serve_s=wall, serve_sent=serve_sent, verify=verify,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    # S4: the prefill KV across the pd axis, rank 0 to rank 1
    pd_mesh = init_mesh((2, 1, 1), "gloo", "cuda", axis_names=PD_AXES,
                        rank=rank, world_size=world, init_method=init)
    pctx = MeshCtx(mesh=pd_mesh, batch_axes=("data",), remat="none")
    layout = KVLayout(pctx, axis="pd", device="cuda")
    src = kv if pd_mesh.comm.coords["pd"] == 0 else shd.map_with_paths(
        kv, lambda _k, t: torch.empty(t.shape, dtype=t.dtype,
                                      device="meta"))

    def digest(tree) -> str:
        h = hashlib.sha256()
        for t in kv_leaves(tree):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()
    moved = execute_transfer(src, layout)
    torch.cuda.synchronize()
    pd_mesh.comm.sent.clear()
    pd_mesh.comm.staged.clear()
    t0 = time.perf_counter()
    for _ in range(3):
        execute_transfer(src, layout)
    torch.cuda.synchronize()
    out["S4"] = dict(
        bytes=plan_transfer(src).total_bytes,
        digest=digest(kv if moved is None else moved),
        received=moved is not None,
        host_staged_ms=(time.perf_counter() - t0) * 1e3 / 3,
        sent=dict(pd_mesh.comm.sent), staged=dict(pd_mesh.comm.staged))
    del kv, moved, src
    # S4, then: disaggregated PD on the (2,1) mesh, on the served weights
    pd = DisaggregatedPD(cfg, eng.params, device="cuda", ctx=ctx,
                         rules=shd.DECODE_RULES, **S_PD_KW)
    try:
        runtime.reset_launch_counts()
        preqs = serve_pd(pd, PD_WAVES, R_NEW)
        out["S4"]["pd"] = dict(summary=pd_summary(pd, preqs),
                               launches=dict(runtime.LAUNCHES),
                               fused=dict(runtime.FUSED))
    finally:
        pd.close()
    eng.close()
    # the loop's last group and spy (its bound method) hold the weights
    del eng, be, pd, dp, spy
    free(f"S2/S4 rank {rank}")
    # S3: Llama-4 on (1,2), prefix seeding
    mesh12 = init_mesh((1, 2), "gloo", "cuda", rank=rank, world_size=world,
                       init_method=init)
    lctx = MeshCtx(mesh=mesh12, batch_axes=("data",), remat="none")
    lcfg = s_cfg(get_config, LLAMA, 2)
    model = Model(lcfg, ctx=lctx)
    params = model.init(0, device="cuda")
    ltoks = ByteTokenizer().encode(LLAMA_PROMPTS[0])
    check(len(ltoks) == S3_STOPS[-1], f"S3: a {S3_STOPS[-1]}-token prompt")
    # the prefix timings run unreplayed (a replay adds its plain versions'
    # device work to the window); the seeded slot's decode is replayed
    pre = s_prefix(model, params, ltoks, S3_STOPS, 1024)
    with Replayer() as rep:
        dp = DPGroup(0, TorchBackend(model, params, max_len=1024,
                                     device="cuda"),
                     max_batch=R_B, max_len=1024)
        try:
            req = Request(prompt_tokens=list(ltoks), max_new_tokens=8,
                          ignore_eos=True)
            cache1, logits = dp.run_prefill(req)
            runtime.reset_launch_counts()
            dp.admit(req, cache1, logits)
            while dp.active:
                dp.decode_step_all()
            dp.drain()
            torch.cuda.synchronize()
            dlaunches, dfused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
        finally:
            dp.close()
        lerrs, lcalls = dict(rep.errs), dict(rep.calls)
    out["S3"] = dict(
        {k: v for k, v in pre.items() if not k.endswith("_logits")},
        logits_bit_identical=True, tokens=list(req.output_tokens),
        decode_launches=dlaunches, decode_fused=dfused, replay_err=lerrs,
        replayed=lcalls,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, params
    free(f"S3 rank {rank}")
    return out


def s_stage(get_config) -> dict:
    """S2-S4 (:func:`s_rank`, two ranks sharing the card over gloo),
    held against one device on the same seeded weights: S2's tokens and
    accepted counts the same on both ranks, the head's draft logits and
    the verify chain's logits of the rows routed alike within 0.08 of
    one device's (``tests/test_decode_consistency.py``'s bar), each
    launch replayed on its plain version; S3's seeded logits
    bit-identical to the cold split (checked on the ranks); S4's moved
    KV bit-equal to the source, and the PD run's tokens against the
    one-device PD run's. Times are not multi-GPU numbers: the wire goes
    through host memory and the ranks time-slice one card."""
    from repro_torch.core import DisaggregatedPD
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.transformer import Model

    cfg = s_cfg(get_config, DEEPSEEK, 4)
    params = Model(cfg).init(0, device="cuda")
    toks, dec = r_inputs(cfg)
    with Replayer() as rep:
        ref = s_verify(Model(cfg), params, toks, dec[0],
                       torch.zeros(R_B, dtype=torch.int64), rep)
        drafts = ref["draft"].argmax(-1)
        ref = s_verify(Model(cfg), params, toks, dec[0], drafts, rep)
    pd = DisaggregatedPD(cfg, params, device="cuda", **S_PD_KW)
    try:
        want_pd = pd_summary(pd, serve_pd(pd, PD_WAVES, R_NEW))
    finally:
        pd.close()
    del params, pd
    free("S one-device references")
    t0 = time.monotonic()
    ranks = spawn(s_rank, 2, {"verify": (toks, dec[0], drafts)}, threads=4)
    spawn_s = time.monotonic() - t0
    results = {}
    # S2
    s2 = [r["S2"] for r in ranks]
    check(all(g["tokens"] == s2[0]["tokens"] for g in s2)
          and all([i[:2] for i in g["iters"]]
                  == [i[:2] for i in s2[0]["iters"]] for g in s2),
          "S2: both ranks emit the same tokens and accept the same counts")
    drafts_err = max(float((g["verify"]["draft"] - ref["draft"]).abs().max()
                           / ref["draft"].abs().max()) for g in s2)
    check(drafts_err <= 0.08, f"S2: the head's draft logits within 0.08 of "
                              f"one device's ({drafts_err:.4g})")
    verify_err, alike_rows = {}, {}
    for j in range(2):
        want = ref[f"verify{j}"]
        wr = ref["routes"][j].view(R_B, -1, ref["routes"][j].shape[-1])
        gr = s2[0]["verify"]["routes"][j]
        gr = gr.view(R_B, -1, gr.shape[-1])
        alike = (wr[:, -1].sort(-1).values
                 == gr[:, -1].sort(-1).values).all(-1)
        d = torch.stack([(g["verify"][f"verify{j}"] - want).abs().amax(-1)
                         for g in s2]).amax(0)
        alike_rows[j] = int(alike.sum())
        verify_err[j] = (float(d[alike].max() / want.abs().max())
                         if bool(alike.any()) else None)
    check(all(e is None or e <= 0.08 for e in verify_err.values())
          and sum(alike_rows.values()) > 0,
          f"S2: verify logits of the rows routed alike within 0.08 of one "
          f"device's: {verify_err} ({alike_rows} of {R_B} rows alike)")
    for n, c in collections_sum([g["replayed"] for g in s2]).items():
        check(c == collections_sum(
            [g["fused" if n == "collect" else "launches"] for g in s2]
        ).get(n, 0), f"S2: every {n} launch replayed")
    n_acc = [i[1] for i in s2[0]["iters"]]
    per_iter = [dict(wire=[g["iters"][t][2] for g in s2],
                     staged=[g["iters"][t][3] for g in s2])
                for t in range(len(s2[0]["iters"]))]
    launches = collections_sum([g["launches"] for g in s2])
    fused = collections_sum([g["fused"] for g in s2])
    check(launches.get("route_pack", 0) > 0 and launches.get("gmm", 0) > 0,
          f"S2: route-pack and gmm launched ({launches})")
    results[f"{DEEPSEEK}/S2-2x1-mtp1"] = (
        {n: dict(max_abs_err=max(g["replay_err"].get(n, 0.0) for g in s2))
         for n in set().union(*(g["replay_err"] for g in s2))},
        dict(launches=launches, fused=fused, tokens=s2[0]["tokens"],
             n_accepted=n_acc, per_iteration=per_iter,
             draft_rel_err=drafts_err, verify_rel_err_routed_alike=verify_err,
             rows_routed_alike=alike_rows,
             peak_gib=[g["peak_gib"] for g in s2],
             serve_s=[g["serve_s"] for g in s2],
             serve_sent=[g["serve_sent"] for g in s2]))
    log(f"S2 {DEEPSEEK} (2,1) DECODE_RULES, MTP k 1: both ranks emit the "
        f"same tokens, accepted counts {n_acc}; draft logits rel err "
        f"{drafts_err:.4g}, verify rows routed alike {verify_err} "
        f"({alike_rows} of {R_B}); launches {launches}; per iteration "
        f"wire bytes {[p['wire'] for p in per_iter]}, host-staged "
        f"{[p['staged'] for p in per_iter]}; peak "
        f"{[round(g['peak_gib'], 2) for g in s2]} GiB per rank")
    # S4
    s4 = [r["S4"] for r in ranks]
    check(not s4[0]["received"] and s4[1]["received"]
          and s4[0]["digest"] == s4[1]["digest"],
          "S4: the prefill KV reached rank 1 over the pd axis, bit-equal")
    agree = [x == y for x, y in zip(
        sum((r[4] for r in want_pd["requests"]), []),
        sum((r[4] for r in s4[0]["pd"]["summary"]["requests"]), []))]
    check(all(g["pd"]["summary"] == s4[0]["pd"]["summary"] for g in s4),
          "S4 PD: both ranks serve the same requests, hits and tokens")
    pd_launches = collections_sum([g["pd"]["launches"] for g in s4])
    results[f"{DEEPSEEK}/S4-pd"] = ({}, dict(
        launches=pd_launches,
        fused=collections_sum([g["pd"]["fused"] for g in s4]),
        kv_bytes=s4[0]["bytes"], host_staged_ms=[g["host_staged_ms"]
                                                 for g in s4],
        sent=[g["sent"] for g in s4], staged=[g["staged"] for g in s4],
        pd_tokens_equal_one_device=all(agree),
        pd_token_agreement=sum(agree) / len(agree),
        pd=s4[0]["pd"]["summary"], pd_one_device=want_pd))
    log(f"S4: {s4[0]['bytes']} bytes of DeepSeek-V3 prefill KV ({S4_LEN} "
        f"tokens) from rank 0 to rank 1 over the pd axis, bit-equal; "
        f"{[round(g['host_staged_ms'], 3) for g in s4]} ms host-staged "
        f"(not a wire figure: two ranks share the card over gloo, through "
        f"host memory); PD on (2,1): greedy tokens agree {sum(agree)} of "
        f"{len(agree)} with the one-device PD run; launches {pd_launches}")
    # S3
    s3 = [r["S3"] for r in ranks]
    check(all(g["tokens"] == s3[0]["tokens"] for g in s3)
          and all(g["hits"] == s3[0]["hits"] for g in s3),
          "S3: both ranks seed alike and decode the same tokens")
    dl = collections_sum([g["decode_launches"] for g in s3])
    check(dl.get("decode_attention_partial", 0) > 0,
          f"S3: the seeded slot decodes through the partial decode "
          f"attention ({dl})")
    results[f"{LLAMA}/S3-1x2-prefix"] = (
        {n: dict(max_abs_err=max(g["replay_err"].get(n, 0.0) for g in s3))
         for n in set().union(*(g["replay_err"] for g in s3))},
        dict(launches=dl,
             fused=collections_sum([g["decode_fused"] for g in s3]),
             cold_ms=[g["cold_ms"] for g in s3],
             seeded_ms=[g["seeded_ms"] for g in s3],
             hits=s3[0]["hits"], payload_bytes=s3[0]["payload_bytes"],
             logits_bit_identical=True, tokens=s3[0]["tokens"],
             peak_gib=[g["peak_gib"] for g in s3]))
    log(f"S3 {LLAMA} (1,2): seeded at {S3_STOPS[-2]} == cold split "
        f"{S3_STOPS} bit for bit on both ranks; device ms cold "
        f"{[round(g['cold_ms'], 3) for g in s3]}, seeded "
        f"{[round(g['seeded_ms'], 3) for g in s3]} (host wire, one "
        f"time-sliced card); hits {s3[0]['hits']}; decode launches {dl}")
    log(f"S2-S4: 2 ranks in {spawn_s:.1f} s")
    return results


# ---------------------------------------------------------------------------
# stage T: the last mixers on a mesh — RG-LRU, the SSD, cross-attention over
# a sequence-sharded memory and the encoder
# ---------------------------------------------------------------------------
#: T's families, at full width and depth
T_MODELS = (RG, MAMBA, VLM, SEAMLESS)
#: T2's meshes of two ranks: name → (shape, the decode rules): (2,1) DP
#: attention with the weights whole on each rank, (1,2) TP 2 with the
#: decode caches' slots cut (the ring window's, and the memory's where
#: its length divides 2: SeamlessM4T's 512 frames, not the VLM's 1601)
T2_MESHES = {"2x1": ((2, 1), True), "1x2": ((1, 2), False)}
T_NEW, T_MAX_LEN = 8, 256


def t_memory(cfg):
    """The seeded memory [R_B, M, md] bf16 on the card of a model with
    cross-attention (every row the same), else None: the same on every
    rank and in the parent."""
    from repro_torch.models.transformer import seeded_memory

    if not any(m == "cross_attn" for m, _ in cfg.layer_kinds()):
        return None
    mem = seeded_memory(cfg, torch.Generator(device="cuda").manual_seed(2311),
                        "cuda", torch.bfloat16)
    return mem.expand(R_B, -1, -1)


def t_engine(cfg, memory, params=None, ctx=None, rules=None):
    """``FlowServeEngine`` of T: 2 DP groups of R_B slots, the seed's
    weights (or ``params``), the memory's first row."""
    from repro_torch.serving.flowserve import FlowServeEngine

    return FlowServeEngine(cfg, params, device="cuda", n_dp_groups=2,
                           max_batch=R_B, max_len=T_MAX_LEN, seed=0, ctx=ctx,
                           rules=rules,
                           memory=None if memory is None else memory[:1])


@torch.no_grad()
def t_logits(model, params, toks, dec, memory, comm=None) -> dict:
    """Global logits (f32, on the host) of a prefill of ``toks`` [R_B,
    R_S] (reading ``memory``), then of R_STEPS decode steps from its
    cache, padded to R_L slots and placed in the decode layout. With
    ``comm``: the bytes the first decode step put on the wire and staged
    through the host (``step_sent``, ``step_staged``)."""
    from repro_torch.launch import sharding as shd

    dev = "cuda"
    toks, dec = toks.to(dev), dec.to(dev)
    lp, c = model.prefill(params, toks, memory=memory)
    out = {"prefill": lp.float().cpu()}
    cache = model.init_cache(R_B, R_L, device=dev)
    part = shd.leaves_by_path(c)
    for keys, t in shd.leaves_by_path(cache).items():
        t[tuple(slice(0, n) for n in part[keys].shape)].copy_(part[keys])
    del c, part
    cache = model.place_cache(cache, R_B)
    for i in range(R_STEPS):
        if comm is not None and i == 0:
            torch.cuda.synchronize()
            comm.sent.clear()
            comm.staged.clear()
        ld, cache = model.decode_step(
            params, cache, dec[i],
            torch.full((R_B,), R_S + i, dtype=torch.int32, device=dev))
        if comm is not None and i == 0:
            torch.cuda.synchronize()
            out["step_sent"] = dict(comm.sent)
            out["step_staged"] = dict(comm.staged)
        out[f"decode{i}"] = ld.float().cpu()
    torch.cuda.synchronize()
    return out


class CrossSpy:
    """Stands in for ``attention.cross_attn_apply`` and counts, over its
    decode calls, the decode-attention launches each made (full and
    partial): a cross layer reads its memory through exactly one."""

    def __init__(self):
        from repro_torch.models import attention

        self.mod, self.real = attention, attention.cross_attn_apply
        self.calls, self.launches, self.odd = 0, {}, 0

    def __enter__(self):
        from repro_torch.kernels import runtime

        def spy(*a, **kw):
            if kw.get("mode") != "decode":
                return self.real(*a, **kw)
            before = dict(runtime.LAUNCHES)
            got = self.real(*a, **kw)
            d = {n: runtime.LAUNCHES.get(n, 0) - before.get(n, 0)
                 for n in ("decode_attention", "decode_attention_partial")}
            self.calls += 1
            self.odd += sum(d.values()) != 1
            for n, c in d.items():
                self.launches[n] = self.launches.get(n, 0) + c
            return got
        self.mod.cross_attn_apply = spy
        return self

    def __exit__(self, *exc):
        self.mod.cross_attn_apply = self.real


def t1_rank(rank, world, init):
    """T1 in a process of its own (world size 1 over NCCL): each family's
    seed weights made on the card, :func:`t1_world_one`. → path →
    result."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model

    mesh = init_mesh((1, 1), "nccl", "cuda", rank=rank, world_size=world,
                     init_method=init)
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",), remat="none")
    out = {}
    for arch in T_MODELS:
        cfg = get_config(arch)
        params = Model(cfg).init(0, device="cuda")
        out[f"{arch}/T1"] = t1_world_one(cfg, params, t_memory(cfg), ctx)
        del params
        free(f"T1 {arch}")
    return out


def t1_world_one(cfg, params, memory, ctx) -> dict:
    """T1: on ``ctx``, a live 1×1 NCCL mesh, ``cfg`` served as the
    one-device engine serves it on the same weights: the same greedy
    tokens with the same kernel launches, and the prefill and decode
    logits of :func:`t_logits` bit for bit."""
    from repro_torch.kernels import runtime

    toks, dec = r_inputs(cfg)
    out = {}
    for name, c in (("one_device", None), ("mesh", ctx)):
        eng = t_engine(cfg, memory, params, c)
        check(eng.model.sharded == (c is not None),
              f"T1 {name}: the {'mesh' if c else 'one-device'} path")
        runtime.reset_launch_counts()
        reqs, wall = serve(eng, PROMPTS, T_NEW)
        launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
        out[name] = dict(tokens=[list(r.output_tokens) for r in reqs],
                         launches=launches, fused=fused, serve_s=wall,
                         logits=t_logits(eng.model, params, toks, dec,
                                         memory))
        eng.close()
        del eng
    a, b = out["one_device"], out["mesh"]
    check(a["tokens"] == b["tokens"], f"T1 {cfg.name}: the mesh path's "
          f"greedy tokens are the one-device engine's: {a['tokens']} vs "
          f"{b['tokens']}")
    check(a["launches"] == b["launches"] and a["fused"] == b["fused"],
          f"T1 {cfg.name}: the same kernel launches: {a['launches']} vs "
          f"{b['launches']}")
    for k in a["logits"]:
        check(torch.equal(a["logits"][k], b["logits"][k]),
              f"T1 {cfg.name}: {k} logits bit-identical")
    log(f"T1 {cfg.name}: a live 1x1 NCCL mesh serves the one-device "
        f"engine's tokens with its launches {a['launches']}; prefill and "
        f"{R_STEPS} decode logits bit-identical")
    return dict(tokens=a["tokens"], launches=b["launches"], fused=b["fused"],
                serve_s=[a["serve_s"], b["serve_s"]],
                logits_compared=sorted(a["logits"]))


def t2_rank(rank, world, init, inputs):
    """One rank of T2 (a process; the two share the card over gloo): for
    each family and mesh of :data:`T2_MESHES`, the model's blocks made
    from the seed on this rank, every decode-attention launch replayed
    on its plain version (:class:`Replayer`), greedy serving with the
    launch counts set to 0 just before and read just after (with each
    DP group's decode steps and the cross layers' launches), then the
    global logits of :func:`t_logits` with one decode step's wire and
    host-staged bytes, and this process's peak memory."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.weights import flatten

    out, meshes = {}, {}
    for arch in T_MODELS:
        cfg = get_config(arch)
        memory = t_memory(cfg)
        for mname, (shape, decode_rules) in T2_MESHES.items():
            if shape not in meshes:
                meshes[shape] = init_mesh(shape, "gloo", "cuda", rank=rank,
                                          world_size=world,
                                          init_method=init)
            mesh = meshes[shape]
            ctx = MeshCtx(mesh=mesh, batch_axes=("data",), remat="none")
            rules = shd.DECODE_RULES if decode_rules else None
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            eng = t_engine(cfg, memory, ctx=ctx, rules=rules)
            torch.cuda.synchronize()
            init_s = time.monotonic() - t0
            held = sum(t.numel() for t in flatten(eng.params).values())
            counter = DecodeCounter(eng)
            with Replayer() as rep, CrossSpy() as cross:
                runtime.reset_launch_counts()
                mesh.comm.sent.clear()
                mesh.comm.staged.clear()
                reqs, wall = serve(eng, PROMPTS, T_NEW)
                launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
                steps = dict(counter.calls)
                cross_launches, cross_calls = dict(cross.launches), cross.calls
                cross_odd = cross.odd
                replayed = dict(rep.calls)
                serve_sent = dict(mesh.comm.sent)
                logits = t_logits(eng.model, eng.params, *inputs[arch],
                                  memory, comm=mesh.comm)
            counter.undo(eng)
            out[(arch, mname)] = dict(
                tokens=[list(r.output_tokens) for r in reqs],
                logits={k: v for k, v in logits.items()
                        if not k.startswith("step_")},
                step_sent=logits["step_sent"],
                step_staged=logits["step_staged"],
                launches=launches, fused=fused, decode_steps=steps,
                cross_launches=cross_launches, cross_calls=cross_calls,
                cross_odd=cross_odd, mem_axis=eng.model.mem_axis,
                replay_err=dict(rep.errs), replayed=replayed,
                params_held=held, init_s=init_s, serve_s=wall,
                serve_sent=serve_sent,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            eng.close()
            del eng, counter
            free(f"T2 {arch} {mname} rank {rank}")
        del memory
    return out


def check_cross_partial() -> dict:
    """The decode-attention kernel's partial output on a cross memory
    shard: SeamlessM4T's cross-attention decode, B 4, 16 heads on 16 KV
    heads, hd 64, bf16, 256 of the memory's 512 slots on each of 2 ranks
    (every slot valid: the kernel at position L - 1 of the shard): held
    to its plain version, timed (CUDA events and device time, one launch
    per call) beside the plain version and SDPA on the same shard (SDPA
    returns no max or sum), and its bytes bound at 3.35 TB/s."""
    from repro_torch.kernels.decode_attention.kernel import (
        _n_sms, decode_attention_cuda, plan)
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_partial_ref

    B, H, KV, hd, L = 4, 16, 16, 64, 256
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((B, H, hd), generator=gen).to(torch.bfloat16).cuda()
    k = torch.randn((B, L, KV, hd), generator=gen).to(torch.bfloat16).cuda()
    v = torch.randn((B, L, KV, hd), generator=gen).to(torch.bfloat16).cuda()
    pos = torch.full((B,), L - 1, dtype=torch.int32, device="cuda")

    def kernel():
        return decode_attention_cuda(q, k, v, pos, partial=True)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
    acc, m, l = kernel()
    racc, rm, rl = decode_attention_partial_ref(q, k, v, pos)
    err, scaled = held_attention(acc / l[..., None], racc / rl[..., None],
                                 3e-2, "partial on a cross memory shard")
    check(float((m - rm).abs().max()) <= 3e-2
          and float(((l - rl).abs() / rl).max()) <= 3e-2,
          "partial on a cross memory shard: max and sum within 3e-2")
    check(torch.equal(kernel()[0], acc),
          "partial on a cross memory shard: a repeat bit-identical")
    prof = profile_calls(kernel)
    one_launch(prof, "decode_attention_kernel",
               "partial on a cross memory shard")
    ms, lib_ms = time_pair(kernel, sdpa)
    bnd, by = bound_ms(nbytes(q, k, v, pos) + nbytes(acc, m, l),
                       4 * B * L * H * hd)
    res = dict(ms=ms, device_ms=prof["device_ms"],
               plain_ms=time_ms(lambda: decode_attention_partial_ref(
                   q, k, v, pos), reps=5, warm=1),
               library_ms=lib_ms, library_device_ms=device_ms(sdpa),
               library_returns_lse=False, bound_ms=bnd, bound_by=by,
               max_abs_err=err, scaled_err=scaled,
               profiled_per_call=prof["per_call"],
               shape=dict(B=B, H=H, KV=KV, hd=hd, L=L, of=2 * L))
    attention_row("partial on a cross memory shard", res,
                  plan(B, H, KV, hd, L, _n_sms(q.device)), kernel)
    log(f"decode attention partial on a cross memory shard [{B},{H},{KV},"
        f"{hd}] x {L} of {2 * L} slots: {ms:.4f} ms (device "
        f"{prof['device_ms']}), plain {res['plain_ms']:.4f}, SDPA "
        f"{lib_ms:.4f} (device {res['library_device_ms']}; no max or sum), "
        f"bound {bnd:.4f} ms ({by}); err {err:.3g}")
    return res


def t_stage(get_config) -> dict:
    """Stage T: RecurrentGemma-2B, Mamba2-130M, Llama-3.2-Vision-11B and
    SeamlessM4T-medium at full width and depth on meshes. The one-device
    engine's tokens and :func:`t_logits` on the seed's weights; the
    partial decode attention on a cross memory shard
    (:func:`check_cross_partial`); T1 (:func:`t1_rank`, spawned): a live
    1×1 NCCL mesh bit for bit the one-device engine; T2 (:func:`t2_rank`,
    two ranks sharing the card over gloo) on :data:`T2_MESHES`: every
    rank emits the same tokens (their agreement with one device is
    reported), the logits within 0.08 relative of one device's
    (``tests/test_decode_consistency.py``'s bar), each decode-attention
    launch replayed on its plain version within 3e-2, the launches equal
    to the attention layers x each rank's decode steps, and on (1,2)
    SeamlessM4T's cross layers each launching the partial kernel over its
    rank's half of the memory (the VLM's 1601 patches stay whole: one full
    launch a cross layer). Times are not multi-GPU numbers: the wire goes
    through host memory and the ranks time-slice one card."""
    from repro_torch.configs.base import ATTN, CROSS_ATTN, LOCAL_ATTN
    from repro_torch.launch.mesh import spawn

    inputs, want = {}, {}
    for arch in T_MODELS:
        cfg = get_config(arch)
        inputs[arch] = r_inputs(cfg)
        memory = t_memory(cfg)
        eng = t_engine(cfg, memory)
        reqs, _ = serve(eng, PROMPTS, T_NEW)
        want[arch] = dict(tokens=[list(r.output_tokens) for r in reqs],
                          logits=t_logits(eng.model, eng.params,
                                          *inputs[arch], memory))
        eng.close()
        del eng, memory
        free(f"T one-device reference {arch}")
    partial = check_cross_partial()
    t0 = time.monotonic()
    t1 = spawn(t1_rank, 1, threads=8)[0]
    log(f"T1 in its own process: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    ranks = spawn(t2_rank, 2, inputs, threads=4)
    spawn_s = time.monotonic() - t0
    results = dict((p, ({}, r)) for p, r in t1.items())
    for arch in T_MODELS:
        cfg = get_config(arch)
        kinds = [m for m, _ in cfg.layer_kinds()]
        n_attn = sum(m in (ATTN, LOCAL_ATTN, CROSS_ATTN) for m in kinds)
        n_cross = kinds.count(CROSS_ATTN)
        ref = want[arch]
        for mname in T2_MESHES:
            got = [r[(arch, mname)] for r in ranks]
            check(all(g["tokens"] == got[0]["tokens"] for g in got),
                  f"T2 {arch} {mname}: every rank emits the same tokens")
            errs = {k: max(float((g["logits"][k] - v).abs().max()
                                 / v.abs().max()) for g in got)
                    for k, v in ref["logits"].items()}
            check(all(e <= 0.08 for e in errs.values()),
                  f"T2 {arch} {mname}: logits within 0.08 of one "
                  f"device's: {errs}")
            launches = collections_sum([g["launches"] for g in got])
            fused = collections_sum([g["fused"] for g in got])
            steps = sum(sum(g["decode_steps"].values()) for g in got)
            want_l = n_attn * steps
            check(sum(launches.values()) == want_l and not fused
                  and set(launches) <= {"decode_attention",
                                        "decode_attention_partial"},
                  f"T2 {arch} {mname}: launches {launches} equal {n_attn} "
                  f"attention layers x {steps} decode steps on the ranks")
            cross = collections_sum([g["cross_launches"] for g in got])
            cut = mname == "1x2" and arch == SEAMLESS
            check(all(g["cross_odd"] == 0 for g in got)
                  and sum(g["cross_calls"] for g in got) == n_cross * steps
                  and all((g["mem_axis"] is not None) == cut for g in got),
                  f"T2 {arch} {mname}: each cross layer's decode launched "
                  f"one decode attention ({cross}), the memory cut "
                  f"{[g['mem_axis'] for g in got]}")
            if cut:
                check(cross.get("decode_attention_partial", 0)
                      == n_cross * steps > 0,
                      f"T2 {arch} {mname}: the cut memory decodes through "
                      f"the partial kernel, {n_cross} cross layers x "
                      f"{steps} decode steps: {cross}")
            for n in set().union(*(g["replay_err"] for g in got)):
                check(sum(g["replayed"].get(n, 0) for g in got)
                      == launches.get(n, 0),
                      f"T2 {arch} {mname}: every {n} launch replayed")
            kern = {n: dict(max_abs_err=max(g["replay_err"].get(n, 0.0)
                                            for g in got))
                    for n in set().union(*(g["replay_err"] for g in got))}
            if cut:
                kern["decode_attention_partial"] = dict(
                    partial, max_abs_err=max(
                        partial["max_abs_err"],
                        kern["decode_attention_partial"]["max_abs_err"]))
            flat_a = sum(ref["tokens"], [])
            flat_b = sum(got[0]["tokens"], [])
            agree = sum(x == y for x, y in zip(flat_a, flat_b)) / len(flat_a)
            path = dict(
                launches=launches, fused=fused, decode_steps=steps,
                cross_launches=cross, logits_rel_err=errs,
                token_agreement=agree, tokens=got[0]["tokens"],
                mem_axis=got[0]["mem_axis"],
                ranks=[{k: g[k] for k in (
                    "params_held", "init_s", "serve_s", "serve_sent",
                    "step_sent", "step_staged", "peak_gib", "replay_err",
                    "replayed")} for g in got])
            results[f"{arch}/T2-{mname}"] = (kern, path)
            log(f"T2 {arch} {mname}: logits rel err {errs} (bar 0.08); "
                f"greedy tokens agree {agree:.3f} with one device; "
                f"launches {launches} ({n_attn} attention layers x {steps} "
                f"decode steps), cross layers {cross}; per rank peak "
                f"{[round(g['peak_gib'], 2) for g in got]} GiB, decode-step "
                f"wire bytes {[g['step_sent'] for g in got]}, host-staged "
                f"{[g['step_staged'] for g in got]} (host wire, one "
                f"time-sliced card)")
    log(f"T2: {len(T_MODELS) * len(T2_MESHES)} cases on 2 ranks in "
        f"{spawn_s:.1f} s")
    return results


# ---------------------------------------------------------------------------
# stage U: training on a mesh (the collectives' backward, FSDP, the
# all-to-all MoE under autograd, Trainer(ctx=)) and the dry run on meta
# ---------------------------------------------------------------------------
#: U1: ``launch/train.py``'s default model and batch, 3 steps
U_STEPS = 3
#: U2: the models (arch, depth or None: full) and meshes on 2 ranks
U2_MODELS = ((TRAIN_ARCH, None), (TRAIN_MOE_ARCH, TRAIN_MOE_LAYERS))
U2_MESHES = {"2x1": (2, 1), "1x2": (1, 2)}
#: U3: the input shapes every registered arch runs on 16x16, and the
#: model whose parameter bytes are held to the card's allocation
U3_SHAPES = ("train_4k", "decode_32k")
U3_DEPTH = 4
#: U3's pool: host processes beside U1 and U2's ranks
U3_WORKERS = 6


def u_train_config():
    from repro_torch.train import AdamWConfig, DataConfig, TrainConfig

    return TrainConfig(
        steps=U_STEPS, log_every=1,
        opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=max(U_STEPS // 20, 5),
                        total_steps=U_STEPS),
        data=DataConfig(seq_len=TRAIN_S, global_batch=TRAIN_B))


def u_batch(device) -> tuple:
    """The loader's first batch (tokens, labels, loss mask) of U's
    training configuration, on ``device``."""
    from repro_torch.train.data import PackedLoader

    return tuple(torch.as_tensor(a).to(device) for a in
                 PackedLoader(u_train_config().data).next_batch())


def u_cfg(get_config, arch, depth):
    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg,
                                                         num_layers=depth)


def u1_rank(rank, world, init):
    """U1 in a process of its own (the NCCL group stays out of the main
    process): InternLM2-1.8B at full width and depth, ``Trainer`` for
    :data:`U_STEPS` steps of B 8 × S 256 on one device, then
    ``Trainer(ctx=)`` on a live 1×1 NCCL mesh: every step's loss and
    ``grad_norm`` and every parameter and moment after the last step bit
    for bit the same."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.train import Trainer

    mesh = init_mesh((1, 1), "nccl", "cuda", rank=rank, world_size=world,
                     init_method=init)
    cfg = get_config(TRAIN_ARCH)
    out = {}
    for name, ctx in (("one_device", None),
                      ("mesh", MeshCtx(mesh=mesh, batch_axes=("data",),
                                       remat="none"))):
        t0 = time.monotonic()
        tr = Trainer(cfg, u_train_config(), ctx=ctx, device="cuda")
        check(tr.model.sharded == (ctx is not None),
              f"U1 {name}: the {'mesh' if ctx else 'one-device'} path")
        torch.cuda.reset_peak_memory_stats()
        rows = tr.run()
        torch.cuda.synchronize()
        # the first run's leaves stay on the card (19 GB) for the second
        out[name] = dict(
            rows=rows, seconds=time.monotonic() - t0,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            leaves=tree_leaves((tr.params, tr.opt_state.m,
                                tr.opt_state.v)))
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    a, b = out["one_device"], out["mesh"]
    for k in ("loss", "nll", "grad_norm", "lr"):
        check([r[k] for r in a["rows"]] == [r[k] for r in b["rows"]],
              f"U1: every step's {k} bit-identical: "
              f"{[r[k] for r in a['rows']]} vs {[r[k] for r in b['rows']]}")
    check(len(a["leaves"]) == len(b["leaves"]) and all(
        torch.equal(x, y) for x, y in zip(a["leaves"], b["leaves"])),
        f"U1: all {len(a['leaves'])} parameter and moment leaves "
        f"bit-identical after {U_STEPS} steps")
    log(f"U1 {cfg.name}: a live 1x1 NCCL mesh trains {U_STEPS} steps "
        f"bit for bit as one device (losses "
        f"{[round(r['loss'], 6) for r in b['rows']]}, grad_norm "
        f"{[round(r['grad_norm'], 4) for r in b['rows']]}); "
        f"{a['seconds']:.1f} / {b['seconds']:.1f} s, peak "
        f"{a['peak_gib']:.2f} / {b['peak_gib']:.2f} GiB")
    return dict(losses=[r["loss"] for r in b["rows"]],
                grad_norms=[r["grad_norm"] for r in b["rows"]],
                leaves=len(a["leaves"]),
                seconds=[a["seconds"], b["seconds"]],
                peak_gib=[a["peak_gib"], b["peak_gib"]])


def u_reference(get_config) -> dict:
    """U2's one-device references, in this process: each model's loss,
    ``grad_norm`` and gradient (host memory, shared with the ranks) on
    the seed's weights and U's first batch."""
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import flatten
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_loop import loss_and_grads

    toks, labels, mask = u_batch("cuda")
    refs = {}
    for arch, depth in U2_MODELS:
        cfg = u_cfg(get_config, arch, depth)
        model = Model(cfg)
        params = model.init(0, device="cuda")
        (loss, _), grads = loss_and_grads(model, params, toks.long(),
                                          labels.long(), loss_mask=mask)
        refs[arch] = dict(
            loss=float(loss), grad_norm=float(global_norm(grads)),
            grads={k: t.cpu().share_memory_()
                   for k, t in flatten(grads).items()})
        del params, grads
        free(f"U2 one-device reference {arch}")
    return refs


def u2_rank(rank, world, init, refs):
    """One rank of U2 (the two share the card over gloo): each model of
    :data:`U2_MODELS` on each mesh of :data:`U2_MESHES`, this rank's
    blocks of the seed's weights: one training step on U's first batch
    (forward and backward bytes apart: wire and host-staged; its global
    ``grad_norm``; timed to the AdamW update's end), each gradient
    leaf's block against the one-device gradient's; this process's peak
    memory."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.common import tree_leaves, tree_unflatten_like
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import flatten
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_adamw)
    from repro_torch.train.train_loop import grads_of

    toks, labels, mask = u_batch("cuda")
    out, meshes = {}, {}
    for arch, depth in U2_MODELS:
        cfg = u_cfg(get_config, arch, depth)
        ref = refs[arch]
        for mname, shape in U2_MESHES.items():
            if shape not in meshes:
                meshes[shape] = init_mesh(shape, "gloo", "cuda", rank=rank,
                                          world_size=world,
                                          init_method=init)
            comm = meshes[shape].comm
            ctx = MeshCtx(mesh=meshes[shape], batch_axes=("data",),
                          remat="none")
            torch.cuda.reset_peak_memory_stats()
            model = Model(cfg, ctx=ctx)
            params = model.init(0, device="cuda")
            opt = init_adamw(params)
            comm.sent.clear()
            comm.staged.clear()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            leaves = [t.detach().requires_grad_()
                      for t in tree_leaves(params)]
            loss, _ = model.forward_train(
                tree_unflatten_like(params, leaves), toks.long(),
                labels.long(), loss_mask=mask)
            fwd = (dict(comm.sent), dict(comm.staged))
            comm.sent.clear()
            comm.staged.clear()
            grads = grads_of(model, loss, leaves, params)
            bwd = (dict(comm.sent), dict(comm.staged))
            new, opt, om = adamw_update(AdamWConfig(lr=TRAIN_LR), params,
                                        grads, opt, ctx, model.specs)
            loss_v, gnorm = float(loss.detach()), float(om["grad_norm"])
            step_s = time.monotonic() - t0
            specs = flatten(model.specs)
            leaf_err = {}
            for k, g in flatten(grads).items():
                want = shd.take_local(ref["grads"][k], specs[k], ctx).to(
                    g.device).float()
                leaf_err[k] = (float((g.float() - want).abs().max()),
                               float(want.abs().max()))
            out[(arch, mname)] = dict(
                loss=loss_v, grad_norm=gnorm, leaf_err=leaf_err,
                step_s=step_s, tokens_per_s=TRAIN_B * TRAIN_S / step_s,
                fwd_sent=fwd[0], fwd_staged=fwd[1], bwd_sent=bwd[0],
                bwd_staged=bwd[1],
                params_held=sum(t.numel() for t in tree_leaves(params)),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            del model, params, opt, new, grads, leaves, loss
            free(f"U2 {arch} {mname} rank {rank}")
    return out


def u3_worker(job: tuple) -> dict:
    """One dry-run combination (a process of U3's pool): its record,
    less the per-op detail."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun_lib import run_one

    arch, shape = job
    try:
        rec = run_one(arch, shape, False)
        r = rec["roofline"]
        return dict(arch=arch, shape=shape, ok=True,
                    meta_s=rec["lower_s"],
                    param_bytes=rec["memory_analysis"]["param_bytes"],
                    argument_bytes=rec["memory_analysis"]["argument_bytes"],
                    coll_bytes=sum(rec["comm_sent"].values()),
                    bottleneck=r["bottleneck"],
                    t_s=[r["t_compute_s"], r["t_memory_s"],
                         r["t_collective_s"]])
    except Exception as e:           # recorded, as the reference records
        return dict(arch=arch, shape=shape, ok=False,          # a failed
                    error=f"{type(e).__name__}: {e}")           # compile


def u3_start(get_config):
    """U3's dry runs, submitted at the start of stage U to a pool of
    :data:`U3_WORKERS` processes (``meta`` tensors only: they run on the
    host while U1 and U2 hold the card), the costliest first. →
    (pool, {job: future})."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.configs import ALL_ARCHS

    jobs = sorted(((a, s) for a in ALL_ARCHS for s in U3_SHAPES),
                  key=lambda j: (j[1] != "train_4k",
                                 -get_config(j[0]).param_count()))
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=U3_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    return pool, {j: pool.submit(u3_worker, j) for j in jobs}


def u3_dry_run(get_config, futures: dict, t0: float) -> dict:
    """U3: every registered arch × :data:`U3_SHAPES` on the 16x16 mesh
    (``launch/dryrun_lib.run_one``, on ``meta`` tensors, in the pool
    :func:`u3_start` fed), one line each; then the dry run's per-device
    parameter bytes of DeepSeek-V3 at depth :data:`U3_DEPTH` on a 1x1
    mesh held byte for byte to what building those parameters on the
    card asks the allocator for (``requested_bytes``: the bytes the
    parameters' allocations requested, which freeing them gives back;
    ``memory_allocated`` beside it counts the allocator's blocks, each
    request rounded up). ``t0``: when the jobs were submitted."""
    from repro_torch.configs import ALL_ARCHS
    from repro_torch.launch.dryrun_lib import tree_bytes
    from repro_torch.models.mesh_ctx import Comm, MeshCtx, MeshShape
    from repro_torch.models.transformer import Model, build_model

    recs = [futures[(a, s)].result() for a in ALL_ARCHS for s in U3_SHAPES]
    pool_s = time.monotonic() - t0
    for r in recs:
        if r["ok"]:
            log(f"U3 [ ok ] {r['arch']}_{r['shape']}_16x16 meta "
                f"{r['meta_s']:.1f} s, params {r['param_bytes']} B per "
                f"device, arguments {r['argument_bytes']} B, collectives "
                f"{r['coll_bytes']} B, bound {r['bottleneck']} (t compute "
                f"/ memory / collective {r['t_s']})")
        else:
            log(f"U3 [FAIL] {r['arch']}_{r['shape']}_16x16: {r['error']}")
    n_ok = sum(r["ok"] for r in recs)
    log(f"U3: {n_ok} of {len(recs)} combinations ok, {pool_s:.1f} s after "
        f"they were submitted")
    check(n_ok == len(recs), f"U3: every combination ran on meta "
                             f"({n_ok} of {len(recs)})")
    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=U3_DEPTH)
    one = MeshShape((1, 1), ("data", "model"),
                    comm=Comm({"data": 1, "model": 1}, 0, "meta",
                              shape_only=True))
    dry = tree_bytes(build_model(cfg, MeshCtx(mesh=one)).init(
        0, device="meta"))

    def held():
        torch.cuda.synchronize()
        return (torch.cuda.memory_stats()["requested_bytes.all.current"],
                torch.cuda.memory_allocated())
    free("U3 before the allocation check")
    params = Model(cfg).init(0, device="cuda")
    grown = held()
    del params
    free("U3 allocation check")
    after = held()
    # what freeing the parameters gives back: the init's lookup tables,
    # made on first use, stay cached
    requested, blocks = grown[0] - after[0], grown[1] - after[1]
    check(dry == requested, f"U3: the dry run's parameter bytes of "
                            f"{cfg.name} depth {U3_DEPTH} ({dry}) equal "
                            f"the bytes the card's allocations requested "
                            f"({requested})")
    log(f"U3: {cfg.name} depth {U3_DEPTH}: the dry run's {dry} parameter "
        f"bytes per device on 1x1 equal the {requested} bytes the card's "
        f"allocations requested (the allocator's blocks: {blocks} B, "
        f"+{blocks - requested} of rounding)")
    return dict(records=recs, ok=n_ok, pool_s=pool_s, param_bytes=dry,
                requested_bytes=requested, allocated_bytes=blocks)


def u_stage(get_config) -> dict:
    """Stage U: training on a mesh and the dry run. U1
    (:func:`u1_rank`); U2 (:func:`u2_rank`, two ranks sharing the card
    over gloo): per model and mesh the loss and ``grad_norm`` within
    0.02 relative of one device's (``tests/test_multidevice.py``'s bar;
    per-shard MoE capacity drops other assignments), the largest
    relative error of any gradient leaf reported, per rank tokens/s,
    peak memory and wire and host-staged bytes, forward and backward
    apart; U3 (:func:`u3_dry_run`). Times are not multi-GPU numbers: the
    wire goes through host memory and the ranks time-slice one card."""
    from repro_torch.launch.mesh import spawn

    t_u = time.monotonic()
    pool, futures = u3_start(get_config)
    try:
        return u_run(get_config, futures, t_u)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def u_run(get_config, futures: dict, t_u: float) -> dict:
    """:func:`u_stage`'s body, the dry runs already submitted."""
    from repro_torch.launch.mesh import spawn

    t0 = time.monotonic()
    u1 = spawn(u1_rank, 1, threads=8)[0]
    u1_s = time.monotonic() - t0
    log(f"U1: {u1_s:.1f} s")
    t0 = time.monotonic()
    refs = u_reference(get_config)
    want = {a: (r["loss"], r["grad_norm"]) for a, r in refs.items()}
    ranks = spawn(u2_rank, 2, refs, threads=4)
    del refs
    u2_s = time.monotonic() - t0
    u2 = {}
    for arch, _ in U2_MODELS:
        loss1, norm1 = want[arch]
        for mname in U2_MESHES:
            got = [r[(arch, mname)] for r in ranks]
            check(all(g["loss"] == got[0]["loss"]
                      and g["grad_norm"] == got[0]["grad_norm"]
                      for g in got),
                  f"U2 {arch} {mname}: every rank holds the same loss and "
                  f"grad_norm")
            loss_err = abs(got[0]["loss"] - loss1) / abs(loss1)
            norm_err = abs(got[0]["grad_norm"] - norm1) / abs(norm1)
            check(loss_err <= 0.02 and norm_err <= 0.02,
                  f"U2 {arch} {mname}: loss {got[0]['loss']} and grad_norm "
                  f"{got[0]['grad_norm']} within 0.02 of one device's "
                  f"{loss1}, {norm1} ({loss_err:.2e}, {norm_err:.2e})")
            leaf = {}
            for g in got:
                for k, (num, den) in g["leaf_err"].items():
                    a, b = leaf.get(k, (0.0, 0.0))
                    leaf[k] = (max(a, num), max(b, den))
            errs = {k: num / den if den else num
                    for k, (num, den) in leaf.items()}
            worst = max(errs, key=errs.get)
            res = dict(
                loss=got[0]["loss"], loss_one_device=loss1,
                loss_rel_err=loss_err, grad_norm=got[0]["grad_norm"],
                grad_norm_one_device=norm1, grad_norm_rel_err=norm_err,
                grad_leaf_max_rel_err=errs[worst], grad_leaf_worst=worst,
                ranks=[{k: g[k] for k in (
                    "tokens_per_s", "step_s", "peak_gib", "params_held",
                    "fwd_sent", "fwd_staged", "bwd_sent", "bwd_staged")}
                    for g in got])
            u2[f"{arch}/{mname}"] = res
            log(f"U2 {arch} {mname}: loss {res['loss']:.6f} (one device "
                f"{loss1:.6f}, rel {loss_err:.2e}), grad_norm "
                f"{res['grad_norm']:.6f} (one device {norm1:.6f}, rel "
                f"{norm_err:.2e}), largest gradient-leaf rel err "
                f"{errs[worst]:.3e} ({worst}); per rank tokens/s "
                f"{[round(g['tokens_per_s'], 1) for g in got]}, peak "
                f"{[round(g['peak_gib'], 2) for g in got]} GiB, forward "
                f"wire {[g['fwd_sent'] for g in got]} host-staged "
                f"{[g['fwd_staged'] for g in got]}, backward wire "
                f"{[g['bwd_sent'] for g in got]} host-staged "
                f"{[g['bwd_staged'] for g in got]} (host wire, one "
                f"time-sliced card)")
    log(f"U2: {len(u2)} cases on 2 ranks in {u2_s:.1f} s")
    t0 = time.monotonic()
    u3 = u3_dry_run(get_config, futures, t_u)
    u3_s = time.monotonic() - t0
    total = time.monotonic() - t_u
    log(f"U: U1 {u1_s:.1f} s, U2 {u2_s:.1f} s, U3 after U2 {u3_s:.1f} s "
        f"(its dry runs in the background from the start), stage U "
        f"{total:.1f} s")
    return dict(u1=u1, u2=u2, u3=u3, seconds=dict(
        u1=u1_s, u2=u2_s, u3=u3_s, total=total))


def kernel_line(results: dict) -> dict:
    """One entry per kernel: launches per path (and their sum), the
    largest error of any path, and the times and bound of the path named
    in ``TIMED_ON`` (Llama-4 by default; each path's own measurements in
    full under ``by_path``). Collect runs on the paths inside route-pack's
    launches: its launches are those (``runtime.FUSED``), its own
    standalone launches on the paths (none) are listed beside them, and
    its times are the standalone kernel's (``check_collect``), with the
    fused launch's under ``in_route_pack``."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    kernels = []
    for n in KERNELS:
        meas = {p: k[n] for p, (k, _) in results.items() if n in k}
        own = {p: r["launches"].get(n, 0) for p, (_, r) in results.items()}
        launches = own
        extra = {}
        if n == "collect":
            launches = {p: r.get("fused", {}).get(n, 0)
                        for p, (_, r) in results.items()}
            extra = dict(fused_into="route_pack",
                         standalone_source=f"src/repro_torch/kernels/csrc/"
                                           f"{n}.cu",
                         standalone_launches_by_path=own)
        check(sum(launches.values()) > 0, f"{n} launched on a path")
        top = meas[TIMED_ON.get(n, LLAMA)]
        kernels.append(dict(
            name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
            launches=sum(launches.values()), launches_by_path=launches,
            **{k: top[k] for k in keys},
            max_abs_err=max(m["max_abs_err"] for m in meas.values()),
            **extra, by_path=meas))
    return kernels


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("V",),
                    help="build the kernels and run this stage alone (no "
                         "kernels or ok line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_main = time.monotonic()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    libs = runtime.build()
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.monotonic() - t0:.1f} s ({', '.join(sorted(libs))})")
    for name, text in sorted(runtime.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}.cu: {line.strip()}")
    no_spills("decode_attention")
    gmm_spills()
    if args.only:
        for p, (_, path) in v_stage(get_config).items():
            log(json.dumps({"path": p, **{k: v for k, v in path.items()
                                          if k != "text"}}))
        log(f"chip_smoke --only {args.only}: "
            f"{time.monotonic() - t_main:.1f} s")
        return 0

    results = {**deepseek_stages(get_config), **llama_stages(get_config),
               **hybrid_stages(get_config), **memory_stages(get_config),
               **v_stage(get_config)}
    t0 = time.monotonic()
    results.update(r2_stage(get_config))
    free(f"R1, S1, R2: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    results.update(s_stage(get_config))
    free(f"S2-S4: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    results.update(t_stage(get_config))
    free(f"T: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    u = u_stage(get_config)
    log(json.dumps({"stage_u": {k: v for k, v in u.items() if k != "u3"},
                    "u3": {k: v for k, v in u["u3"].items()
                           if k != "records"}}))
    free(f"U: {time.monotonic() - t0:.1f} s")
    for p, (_, path) in results.items():
        log(json.dumps({"path": p, **{k: v for k, v in path.items()
                                      if k != "text"}}))
    train_stages(get_config)
    log(json.dumps({"simulator": sim_stage(results, smi)}))
    log(f"profiler windows: {WINDOWS['windows']}, at most "
        f"{WINDOWS['pads_lost_max']} of a window's {2 * PAD_LAUNCHES} pad "
        f"events lost; profile_calls windows {WINDOWS['calls']}, profiled "
        f"again {WINDOWS['retried']}, still fewer device kernels than "
        f"counted launches {WINDOWS['short']}")
    log(f"chip_smoke: {time.monotonic() - t_main:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernel_line(results)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

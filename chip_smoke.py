#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``distllm_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero (nothing is caught and
carried on):

1. device — print the card's name and power limit (``nvidia-smi``);
2. build — compile every CUDA kernel from ``distllm_tpu_torch/csrc/``
   with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all at once):
   K1, K2 and K3;
3. kernel K1 — hold the ragged paged-attention kernel against its plain
   PyTorch version in bf16 at Mistral-7B geometry (32/8 heads, head dim
   128, block size 16), within ``paged_attention.comparison_tolerance``
   of the route each case takes (printed): (a) 32 decode rows with
   ragged contexts 1..4096, (b) 4 prefill rows with spans up to 512 over
   existing prefixes and ``q_lens`` padding, (c) sliding window 4096 +
   logit softcap, (d) chunk spans that start off a 64-key tile boundary,
   with ``q_lens`` padding, the shapes the serving phase gives it, and
   the split-KV route's edges (e-g: contexts at the plan's split edges,
   a window across a split edge with spans of 1..3 and softcap, rows
   whose window leaves one live split), and phase 6g's verify windows (32
   spans of 5 over 22..1094 keys, 20-row tiles on the tensor cores, and
   spans of 3, 12-row tiles on the split-KV route), and phase 20's shard
   shapes at 16 query / 4 KV heads (8 decode rows of 64..528 keys, 32 of
   1..4096, a 512 + 300 prefill); NaN in the trash block leaves
   the outputs of a decode case, a split-edge case and a wgmma case
   bitwise unchanged, and two launches of a split-edge case and of a
   wgmma case are bitwise equal; time kernel and
   ``scaled_dot_product_attention`` on the same gathered KV (a yardstick
   the port never calls) as CUDA-graph replays, the kernel also by events
   around eager calls and on the host's clock per call, and the plain
   version by events; wherever both tensor-core routes take a case (bf16
   over a bf16 pool of 16-token pages, 16 rows or more) the other one is
   launched too, held to its tolerance and timed beside it (``routes``:
   the A/B of ``'tensor_cores'`` and ``'wgmma'``);
3b. kernel K1, int8-KV mode — the same against its plain version over
   ``QuantizedKV`` pools (N(0, 1) K/V quantized on the card), within the
   int8 tolerance of the route each case takes (printed): (a) 32 decode
   rows of contexts 1..4096, (b) 4 prefill rows with spans up to 512 and
   ``q_lens`` padding, (c) window 4096 + softcap, (d) chunk spans off a
   64-key tile, (e) fp32 queries, (f) block size 32 on two routes, (g)
   phase 6's and phase 6b's decode and prefill shapes, (h) phase 3's
   split-KV edges; codes the quantizer never writes (-128) and, in turn,
   a NaN scale in the trash block leave the outputs of a decode case, a
   split-edge case and a tensor-core case bitwise unchanged; timed as in
   phase 3, SDPA on the pool dequantized to bf16 (a yardstick: not the
   same function, twice the KV bytes);
3c. kernel K1, mixed mode — the same over a full-precision pool of the
   other dtype than q, within the mixed tolerance of the route each case
   takes (printed): fp32 q over a bf16 pool (the CUDA cores) and bf16 q
   over an fp32 pool (the split-KV route and the tensor cores), each at
   phase 3's 32 decode rows of 1..4096, the 1024 + 700 prefill pair and
   the serve decode shape (8 x 18..1090), and spans of 4 over phase 3's
   rows (the tensor cores); NaN in the trash block leaves the outputs of a
   case on each route bitwise unchanged; a planted fault, the longest
   row's last page dropped at 32 x 1..4096 on each route, must exceed the
   tolerance; timed as in phase 3, SDPA on the pool cast to q's dtype as
   the yardstick;
3d. kernel K1 at head dim 256 — Gemma-2-9B's geometry (16 / 8 heads,
   block 16, scale 256 ** -0.5), each case within the tolerance of its
   route and KV mode: (a) 32 decode rows of 1..8192 keys (split-KV), (b)
   the prefill pair 1024 + 700 (tensor cores), (c) window 4096 + softcap
   50 over decode rows and chunk spans crossing the window's edge, (d)
   (a) and (b) over an int8 pool, (e) (a) and (b) in the mixed mode both
   ways (a planted dropped page exceeding the tolerance), (f) fp32 on the
   CUDA cores, (g) phase 13's serve shapes, (h) the split-KV edges of this
   head dim's plan; NaN (int8: -128 codes, a NaN scale) in the trash block
   leaves a case of each route bitwise unchanged; a 128-row fp32 tile,
   too large for shared memory, raises instead of launching; timed as in
   phase 3;
4. kernel K3 — hold the encoder-attention kernel against its plain
   version at BERT-base geometry (12 heads x 64): the embed path's shapes
   (batch 512, S = 128 / 192 / 288) in bf16, partial key masks with fully
   masked rows, S = 16 and an odd S, the ``[S, S]`` window bias, fp32,
   and a head dim of 24 (both on the CUDA-core route; the route of each
   case is printed); then the protein and ModernBERT phases' shapes: ESM-2
   650M (64 x 1024, 20 heads), ESM-C 600M (8 x 2048, 18 heads) and
   ModernBERT-base (128 x 512, 12 heads, the window-128 bias, and its
   local layers at the embed buckets 160 and 288); time kernel, plain
   version and ``scaled_dot_product_attention`` with a key mask (and the
   bias, additive) on pre-transposed ``[B, N, S, Hd]`` inputs; at bf16
   head dims of the wgmma route both tensor-core routes run each case,
   each held to the tolerance and timed (``routes``);
5. kernel K2 — hold the int8 weight-only matmul against its plain
   version elementwise within ``quantized_matmul.comparison_tolerance`` of
   the route each case takes (printed; bf16 on the tensor cores, fp32 on
   the CUDA cores): Mistral-7B decode rows M = 1 / 8 / 32 / 128 at every
   projection shape (4096 x 4096, 4096 x 1024, 4096 x 14336, 14336 x
   4096) and M = 16 (the last row count of the 16-row tiles) at 4096 x
   14336, a verify pass's M = 160 (32 rows x 5) at 4096 x 14336, a ragged
   prefill M = 1040, the BERT-base embed products (512 x
   288 rows at 768 x 3072, 3072 x 768 and 768 x 768), M = 5, M = 1000 (off
   the 128-row tile), N = 784 (off the 128-column tile), one-signed data
   at K = 14336, partial sums that stay large and cancel exactly at the
   end (the tensor cores' truncation at its largest, one split), an
   all-zero weight column, one fp32 case, and phase 20a's shard shapes
   at M = 8 (4096 x 2048 and 4096 x 512 column-parallel; 2048 x 4096
   row-parallel: half the rows' codes with the whole weight's scales); each case's worst ratio to
   the CUDA-core route's bound is printed too. Time kernel and
   ``torch.matmul`` on the weight dequantized to bf16 (a yardstick that is
   not the same function) as CUDA graphs of many calls, so the host's
   enqueue time is not counted, cycling weight copies so each launch
   finds its weight cold in L2; the kernel also by CUDA events around
   eager calls (``event_ms``, as K1, K3 and the plain version are timed)
   and on the host's clock per call (``host_us``, the wrapper's cost);
6. serve — full-width Mistral-7B in bf16 with random weights made on the
   card: ``TorchGenerator.generate`` on 16 prompts of 16..1024 tokens
   (``max_num_seqs=8``; 64 new tokens each, 14 greedy + 2 sampled), then
   three chat completions through ``chat_server`` on a free localhost
   port. K1's launch count must equal layers x forward passes and its
   plain op must not run at all; every prefill dispatch's launches went
   through the tensor-core route and every decode step's through the
   split-KV route (``launches_by_route``). The generator warmed its
   engine up at construction (two decode graphs captured, greedy and
   sampled, with their seconds and graph pool MiB printed): every decode
   step of the run, the chat worker's included, must be one graph replay
   (``decode_graph_replays`` = forward passes - prefill dispatches) and
   nothing may be captured during it. What stays allocated after each
   engine's shutdown is printed, here and in every later engine phase;
7. serve int8 — the same through ``TorchGenerator(quantization='int8')``,
   the weights quantized on the card; K2 must launch 7 x layers x
   forward passes, every launch on the tensor-core route, and its plain
   version never, K1 as in phase 6;
6b-6g run Mistral-7B widths at ``SHARED_LAYERS`` = 8 of its 32 layers
   (depth cut to keep the run's time; 16-16c stay at 32).
6b. serve with an int8 KV pool — the JAX ``gen_kvq`` stage's workload (64
   greedy prompts of 32..192 tokens, every third behind a shared 32-token
   prefix, 16..96 new tokens each; the prefix cache off here, on in 6d;
   the stage's chunked prefill runs in 6f) through two ``LLMEngine`` arms on
   the same bf16 weights (made once for 6b-6e), a bf16 and an int8 KV pool (``kv_cache_dtype``; block 16,
   1024 blocks, 32 slots); per arm tokens/s, pool GiB, allocated and peak
   GiB, ``telemetry['kv_cache_dtype']``; the int8 blocks the bf16 pool's
   bytes would hold and the greedy match fraction (recorded). K1 must
   launch layers x forward passes, every int8-arm launch in the int8
   mode (``launches_by_kv``) with prefill on the tensor cores and decode
   on the split-KV route, its plain op never, and the int8 pool must take
   under 0.51 of the bf16 pool's bytes; every decode step of each arm is a
   graph replay, as in phase 6;
6c. graph window — full-width Mistral-7B bf16 (16 of 32 layers, a pool of
   N(0, 1) K/V made on the card): one 8-step decode window of 8 rows of
   about 1024 keys (one row's budget ending mid-window), greedy and then
   sampled, through the engine's captured graphs and through the eager
   ``mistral.decode_loop`` on a copy of the pool: tokens and every pool
   byte outside the trash block must be identical; wall ms a step of
   each (3 windows), capture seconds and graph pool MiB are printed;
6d. prefix cache — full-width Mistral-7B bf16, three ``LLMEngine`` arms
   (the cache off; on over a bf16 pool; on over an int8 pool) over (a)
   6b's workload, its first shared-prefix prompt served first, and (b) a
   RAG set: a 1024-token system prefix request, then 16 prompts sharing
   it with tails of 16..64 tokens and one exact repeat of the prefix
   (copy-on-write), 32 new tokens each. Per arm the hit share, prefill
   wall and CUDA-event ms per dispatch, tokens/s and the greedy match against
   the cache-off arm (recorded); (b)'s hit share must exceed 0.85 with one
   copy-on-write; K1 launches on the route ``kernel_route`` names for
   each dispatch's padded span, its plain op never, every decode step a
   graph replay;
6e. KV tiers — a 100-block pool (two 1024-token prefixes do not fit), a
   1 GiB host tier writing through to a disk tier in a temporary
   directory, bf16 and int8 pools: spills and promotions happen with no
   payload mismatch or promotion failure, the promoted blocks' pool bytes
   and the tier's copies are bitwise their bytes before the spill, and a
   fresh engine on the same directory promotes from disk; spill and
   promotion host ms per MiB printed;
6f. mixed windows — the JAX ``gen_mixed`` stage at full width (6b's
   workload; 712 blocks, 32 slots, 512-token rows, 16-step windows,
   sampling over the top 64 logits, the prefix cache,
   ``prefill_chunk_tokens`` and ``max_window_prefill_tokens`` 256): mixed
   batching off, then on, on 6b's weights. The on arm must ride windows
   and run fewer standalone prefill dispatches; K1 launches on the route
   ``kernel_route`` names for each pass (eager prefill dispatches and
   chunk halves by padded width, decode steps on the split-KV route), its
   plain op never; every decode step a graph replay. Tokens/s, prefill
   and chunk host ms and the greedy match (bf16: recorded, each flip with
   the plain op's logit gap) are printed;
6g. speculation — the JAX ``gen_spec`` stage at full width (motif-tiled
   prompts, the same engine as 6f, ``draft_k=4``): arms ``draft_k=0``,
   ``spec_draft_source='none'`` and prompt lookup (random weights never
   repeat themselves, so it drafts next to nothing: recorded), then arms
   whose drafts are the ``'none'`` arm's greedy stream (``oracle``, a
   stand-in for a model that copies): greedy, sampled (temperature 0.15,
   top-p 0.95, a seed per request) twice, and greedy over int8 weights
   (K2 launches 7 x layers x passes, on the tensor cores). ``'none'`` and
   prompt lookup give identical tokens, the oracle
   arms accept drafts, the sampled arm is deterministic, every verify
   window is one graph replay and nothing is captured in a run, K1's
   verify passes launch on ``kernel_route(bf16, 5, 4)``'s route. Accept
   rate, tokens/s per arm, and the verify window's wall ms and replay
   event ms (medians) are printed;
8. identity — full width at depth 2 in fp32: greedy tokens from the engine
   on K1 equal those from the engine on its plain op; then, int8 weights,
   greedy tokens on K2 (every launch on the CUDA-core route) equal those
   on its plain version; 8b. then, an int8 KV pool, greedy tokens on K1's
   int8 mode equal those on its plain op; 8c. then the prefix cache with a
   host and disk tier (one copy-on-write, a spill and a promotion): greedy
   tokens on K1 equal those with the cache off; and an fp32 model over a
   bf16 pool (K1's mixed mode on the CUDA cores): greedy tokens on K1 and
   on its plain op, the match printed, a flip reported with the plain
   op's logit gap (failed unless a near tie); 8d. then 6g's first 16
   prompts (8..31 new tokens) with the prefix cache and 64-token
   chunks: greedy tokens with speculation (``draft_k=4``, the drafts the
   speculation-off stream) equal those without, with speculation on K1 those on its plain op, and with mixed
   batching those without. Every arm, the plain op's included, is warmed
   up first and replays its own decode (and verify) graphs;
9. quantize — the int8 codes and scales of the full-width gate kernel of
   layer 0, quantized on the card, equal bitwise those the CPU makes;
   9b. int8 KV codes and scales written on the card (``write_chunk_kv``
   fresh and mid-block, ``write_token_kv`` appends that grow the absmax
   and cross a block boundary) equal bitwise those the CPU writes;
10. embed — the stages of ``embedding_worker`` on the card: 2048 texts of
    120..260 words written to a jsonl file, read by the ``jsonl`` dataset
    (batch 512), a ``TorchEncoder`` over full-width, full-depth BERT-base
    in bf16 (random weights made on the card from seed 0, the
    ``WhitespaceTokenizer``), the ``mean`` pooler, the ``full_sequence``
    embedder and the ``numpy`` writer; one warm-up pass, one timed pass.
    The output must be ``[2048, 768]`` fp32, finite and read back from its
    files; K3 must launch 12 x the batches dispatched, all on the
    tensor-core route, and its plain version never;
11. embed int8 — the same with ``TorchEncoder(quantization='int8')``; K2
    must launch 6 x 12 x the batches, all on the tensor-core route, and
    its plain version never;
12. embed identity — full width at depth 2 in fp32: pooled embeddings
    through K3 and through its plain version agree elementwise within
    ``1e-4 * |ref| + 1e-5``;
13. serve Gemma-2-9B — full width and depth (42 layers, ``google/gemma-2-9b``'s
    config, bf16, random weights made on the card), the generator built
    from a chat app YAML whose model is named ``gemma2`` (the prefix cache
    on by that YAML's default), 16 prompts of 256..4600 tokens (two past
    4,160, so the even layers' window cuts during decode), 64 new tokens
    each, then 3 chat completions: K1 launches layers x forward passes,
    every one at head dim 256, prefill on the tensor cores and decode on
    the split-KV route, its plain op never; every decode step a graph
    replay; tokens/s and wall time printed;
13b. Gemma-2 identity — Gemma-2-9B widths at depth 2 in fp32 (layer 0
    local, layer 1 global), 6 prompts of 300..4400 tokens in chunks of
    512: greedy tokens through K1 (the CUDA cores at head dim 256) equal
    those through the plain op with speculation (``draft_k=4``) and mixed
    windows off and on;
14. protein embed — ESM-2 650M at ``facebook/esm2_t33_650M_UR50D``'s
    config (vocab 33, hidden 1280, 20 heads, intermediate 5120) cut to 9
    of its 33 layers (``PROTEIN_LAYERS``), bf16, random weights made on
    the card from seed 0: the stages of ``embedding_worker`` under a ``workstation``
    compute config (``max_workers: 1``) over a FASTA file of 2048 random
    protein sequences of 50..1022 residues (seed 12), read by the
    ``fasta`` dataset (batch 64), tokenized by ``EsmcSequenceTokenizer``
    (ESM-2's vocabulary id for id but for id 31, which no residue
    produces), mean-pooled, embedded by ``full_sequence`` and written by
    ``numpy``; one warm-up pass, one timed pass. The output must be
    ``[2048, 1280]`` fp32, finite and read back from its files; K3 must
    launch layers x the batches, all on the tensor-core route, its plain
    version never. Sequences/s, residues/s, device GiB allocated and at
    peak, and the padding share are printed;
14b. ESM-C 600M (1152 / 18 heads, ffn 3072; 9 of its 36 layers) the same
    way over the same sequences through the ``sequence_per_line`` dataset
    on a copy written one per line: ``[2048, 1152]``, K3 layers x batches;
14c. ModernBERT-base at ``answerdotai/ModernBERT-base``'s config (vocab
    50368, 768 / 22 layers / 12 heads, intermediate 1152, window 128,
    global every 3rd layer) over phase 10's corpus (``jsonl``, batch 512,
    the ``WhitespaceTokenizer`` at vocab 50368 and ``model_max_length``
    512: every local layer's window cuts), L2-normalised:
    ``[2048, 768]``, K3 22 x batches, 14 of them a batch with the
    ``[S, S]`` window bias (counted in this phase);
14d. identity — each of the three at full width and depth 2 in fp32:
    pooled embeddings through K3 (the CUDA cores) and through its plain
    version agree within phase 12's ``1e-4 * |ref| + 1e-5``.
15. retrieval index — a corpus of 2**19 rows x 768 (BERT-base width),
    fp32 N(0, 1) from numpy seed 15, with texts of 48..96 words, held in a
    numpy table this script defines and hands to the index (the index's
    one seam for a dataset that is not an HF dataset on disk); the
    ``float32``, ``int8`` and ``ubinary`` tiers built into a temporary
    directory in the JAX package's file format and loaded onto the card;
    64 queries through a ``Retriever`` over full-width BERT-base bf16
    (random weights from seed 0, the ``WhitespaceTokenizer``, mean pooler,
    batches of 8), top 20, ``rescore_multiplier`` 4. For 8 queries each
    tier's indices equal a host reference built from the index's own
    files (fp64 products; the int8 tier's int8 x int8 products exact with
    the scales in the port's fp32 order; Hamming distances by popcount;
    ties by the lower index; the quantized tiers' candidates rescored
    independently), the float32 tier's scores within 1e-5 of fp64 (two
    rows whose fp64 scores lie within 1e-6 may swap, reported); K3
    launches 12 x the query batches, all on the tensor cores, its plain
    version never. Per tier: build seconds, device bytes, host ms of a
    64-query search (the rescore's gather included), the device top-k
    by CUDA events beside its bound, queries/s with encoding;
15b. RAG chat — the chat app config's generator (Mistral-7B widths,
    bf16, 32 slots, 64 greedy tokens, the prefix cache on; built once
    through the generator registry and shared by 15b-15d) behind
    ``ChatServer`` with phase 15's float32 retriever: 16 POSTs with
    ``top_k`` 5 and ``score_threshold`` 0, every answer 200, every rendered
    prompt holding 5 contexts (counted through a hook on the template);
    K3 12 x 16 on the tensor cores, K1 layers x passes on the route of each
    dispatch, plain versions never; retrieve and generate ms a request;
15c. eval suite — ``run_eval_suite`` on ``pubmedqa`` (64 items written
    in the JAX task's format into ``download_dir`` first, so nothing is
    downloaded) with one rag_config: the registry's generator and phase
    15's retriever; K3 per query batch, K1 as in 15b, 64 x 64 tokens;
    accuracy and precision printed (random weights: a path check);
15d. generation job — ``run_generation`` over 4 jsonl files of 32
    chunks of 256..1024 words, the ``keyword_selection`` prompt (the card
    has no nltk, which ``question_chunk``'s postprocess imports), the
    registry's generator, the ``huggingface`` writer and ``local``
    compute: 4 shards of 32 rows read back, a second run into the same
    ``output_dir`` refused, K1 as in 15b;
15e. identity — fp32 at depth 2: the generation job's greedy responses
    through K1 equal those through the plain op (``attn_backend``
    ``'reference'``); the retriever's top-20 rows through K3 equal the
    plain K3's on a 4,096-row index wherever the plain scores' gap
    exceeds twice the query embeddings' distance, any flip reported with
    its gap.

16. open-loop load — the JAX ``gen_load`` stage's chip engine (bf16
    Mistral-7B on phase 6b's weights, 712 blocks of 16, 32 slots, 512-token
    rows, 16-step windows, top-64 sampling, the prefix cache on,
    ``ttft_slo_s`` 2, attribution on), warmed up, driven by
    ``generate.loadgen.run_loadgen`` through its workload (256 greedy
    requests at 16 rps, 16 sessions, 60% warm behind a 64-token prefix,
    tails of 32..192 and 16..96 new tokens): TTFT, TPOT and queue-wait
    p50/p95/p99, tok/s, goodput and its share, warm-prefix hit tokens and
    the MFU and bandwidth shares of each window kind, beside the card's
    name and power limit; K1 layers x passes on the route of each pass,
    its plain op never, every decode step a graph replay. Gates: every
    request finishes with its budget, warm hits > 0, nothing shed or
    failed, every share in (0, 1.05]. The same workload again with
    attribution off: its tok/s and the share of tokens that agree;
16b. chaos, overload and deadline — the same engine: the JAX
    ``gen_chaos`` stage's 192 requests at 16 rps clean and then under its
    fault schedule (``dispatch`` x3 after 16, ``slow_window`` x3 of 0.2 s
    after 8, ``sched_exhausted`` x2 after 32; 3 retries, 0.01 s backoff,
    a 120 s deadline, ``ttft_slo_s`` 4): every site fired, a recovery,
    nothing quarantined or failed, goodput > 0, the share of tokens that
    agree with the clean run printed; 128 requests at 256 rps under
    admission control with ``ttft_slo_s`` 0.25: some shed, each shed's
    ``retry_after_s`` > 0, every admitted request finishes; every window
    stalled 0.6 s against a 1 s deadline: the stalled requests end
    ``timeout`` and, the cache flushed, every block is free;
16c. the chat server under HTTP load — ``ChatServer`` over the chat
    app config's Mistral-7B bf16 generator (its serving defaults: the
    prefix cache, a 120 s deadline, 2 retries) on phase 6b's weights,
    ``run_http_loadgen`` with 64 requests at 8 rps, every fourth streamed:
    every answer 200, every streamed one a single delta and ``[DONE]``,
    ``/metrics``' TTFT count up by 64, ``/loadinfo`` with the JAX keys,
    then ``POST /drain``: ``/health`` 503 and a completion 503 with
    ``Retry-After``; a server over ``fake`` with ``overload_every`` 2
    answers 429 with ``Retry-After``; the HTTP TTFT percentiles;
16d. identity — fp32, depth 2, 32 greedy requests in a burst, through K1
    and through the plain op: attribution off and on give identical
    tokens, and so does ``dispatch`` x2 under 3 retries.
17. the pipelined ``generate_ids`` — full-width Mistral-7B bf16 at
    ``PIPE_LAYERS`` = 8 of its 32 layers (depth cut to keep the run's
    time; weights made again from seed 0), block 16, 1400 blocks, 32
    slots, 640-token rows, 16-step windows, the default (Python) scheduler: 64
    greedy prompts of 32..512 tokens, 64..128 new each, with the four
    tokens most frequent at positions 8..64 of a short first run's streams
    (48 prompts, 64 tokens) as stop ids, at ``pipeline_depth`` 1, 2 and 2
    with ``defer_prefill``. Per
    arm: tok/s and wall, eager prefill host ms, the gaps between windows
    on the host's clock and on the device's (CUDA events), the device's
    busy share, ``overshoot_frac``, the bf16 share of tokens agreeing with
    depth 1, K1's launches by route (layers x passes on each pass's route,
    every decode step a replay); the depth-2 arms overshoot, and every
    decode window's measured MFU and bandwidth shares (K1 priced at the
    lengths it ran) lie in (0, 1.05];
17b. pipeline identity — full width at depth 2 in fp32: depths 1, 2 and
    3, ``defer_prefill`` and mixed windows at depth 2, each on K1 and on
    the plain op, give depth 1's tokens; some arm overshoots; every engine
    asks for the native scheduler and takes it;
17c. serving from a checkpoint path — Mistral-7B widths at depth 2 (bf16,
    seed 18) written on the card as a checkpoint directory (safetensors
    in HF key names, ``config.json``, a word-level tokenizer built with
    ``tokenizers``, a ``generation_config.json`` with two EOS ids the
    streams emit); a chat YAML with ``pretrained_model_name_or_path``
    builds the generator in bf16 and with ``quantization: int8``: tokens
    identical to an engine built on the same tensors, the EOS and stop
    ids of generation_config, a ``weight_load`` start-up phase, K1 on the
    path and K2 in the int8 arm;
17d. the debug surface — ``ChatServer`` over 17c's int8 generator with
    the regression sentinel armed from an envelope file: every ``/debug/*``
    route answers (Perfetto valid with the window-kind tracks, history
    with samples, SLO, a bundle directory with the device's facts, an
    ``xprof`` capture whose trace names K1's kernel), a ``slow_window``
    stall under ``DISTLLM_WATCHDOG_S`` makes the watchdog dump a bundle,
    the compile series count the kernel builds and graph captures, and
    every series ROADMAP A6b listed at zero moves;
18. MCQA — inside phase 15's run, over the registry's warm Mistral-7B
    generator (``RAG_MODEL``: 16 of 32 layers, bf16): 4096 chunks embedded by ``run_embedding
    through a BERT-base checkpoint written on the card (K3) and merged;
    ``MCQA_QUESTIONS`` questions made from them (a stem, four options, the reference and
    the source ``chunk_id``); ``run_mcqa`` from a YAML on disk with
    ``retriever_config`` (BERT-base queries, K3), the model behind a
    ``ChatServer`` reached over HTTP (``ApiGenerator`` ->
    ``BatchingClient`` -> the engine, K1 on every pass's route) and a
    ``fake``-backend ``ChatServer`` grading: every question answered and
    graded, results.json with the JAX harness's keys, a second run resumes
    and asks nothing; questions/s, answer latency p50/p95, tok/s;
18b. a booted server — inside 17c's run: ``run_mcqa`` with
    ``local_model_path`` = 17c's checkpoint boots ``python -m
    distllm_tpu_torch.chat_server`` on the card; 16 answers equal a direct
    generator's on the same checkpoint; the process exits at ``stop()``;
18c. the CLI — ``generate --generator_name tpu`` on 17c's checkpoint
    (K1), ``embed`` on a BERT-base-width checkpoint of 4 layers (K3),
    ``merge`` of its shards;
18d. MCQA identity — fp32 at depth 2: phase 18's first 16 questions give
    identical answers through K1 and through the plain op; the retriever's
    encoder on K3 within phase 12's tolerance of its plain op.
19a. the 4-D quantizer — one full-width Mixtral expert bank, ``[2, 8,
    4096, 14336]`` bf16, quantized on the card one ``[4096, 14336]``
    slice at a time: its peak allocation beyond the input and the codes
    under two fp32 slices (printed), one expert's codes and scales equal
    to the CPU's bitwise;
19. Mixtral-8x7B — ``get_generator`` with ``model: {name: mixtral}`` and
    ``quantization: int8`` at full width and depth (32 layers, 8 experts,
    top 2; random weights quantized layer by layer as they are drawn): 16
    greedy prompts of 32..512 tokens x 32 new, then 2 requests over HTTP
    (16 new tokens each)
    through ``ChatServer``; the int8 weight GiB, the build and capture
    seconds, each graph pool's MiB, tok/s and wall ms a decode pass beside
    the estimate written before the first run, the peak allocated GiB
    (under the card's memory); K1 layers x passes on each pass's route, K2
    4 x layers x passes (q / k / v / o) on the tensor cores, the plain
    versions never, every decode step a graph replay, every HTTP status
    200;
19b. Mixtral identity — Mixtral-8x7B widths at depth 2 in fp32: greedy
    tokens through K1 (float weights) and through K1 + K2 (int8 weights)
    equal the plain ops';
19c. Mixtral speculation and mixed windows — depth 2 (cut from 4), bf16 over int8
    weights: ``draft_k=4`` (drafts from the off arm's stream) and mixed
    windows with chunked prefill against the arm with neither; agreement
    shares printed (bf16: not asserted), each arm's K1 / K2 launches
    checked per pass, the verify graph's counted;
19d. a Mixtral checkpoint — one layer at Mixtral-8x7B widths (bf16, about
    3.4 GB) written on the card and served from a chat YAML's
    ``pretrained_model_name_or_path`` with ``quantization: int8``: tokens
    identical to a direct engine on the same tensors.
20. tensor parallelism (ROADMAP A10b) — NCCL puts one rank on a device,
    so the two ranks of ``tensor_parallel_size: 2`` share the card over
    gloo (collectives staged through the host, windows eager): what the
    card shows is correctness and K1 / K2 at each rank's shard shapes,
    not a TP speed. Mistral-7B bf16 at full width, 16 of its 32 layers
    (depth cut to keep the run's time), through
    ``get_generator`` (this process rank 0, rank 1 spawned by the
    generator; each rank draws the seed's weights leaf by leaf and keeps
    its slices): 8 greedy prompts of 64..512 tokens x 16 new; each rank
    holds half the weights (GiB printed) and 4 of the 8 KV heads, K1 runs
    at 16 query / 4 KV heads, layers x passes on each rank (rank 1's
    counts from its ``mark_kernels`` report), the plain op never; both
    ranks sample the same tokens (equal digests); tok/s labelled as two
    ranks timesharing one card; the bf16 agreement share with the
    one-rank generator on the same seed; then one profiled serve (8
    prompts x 17 new) with a device sync around each of rank 0's
    all-reduces: the decode windows' wall against the host time in the
    exchange and in draining rank 0's queued kernels, and rank 0's
    kernel device time;
20a. Mixtral-8x7B int8 at full width, 4 of 32 layers, tp2 through
    ``get_generator``: K1 layers x passes and K2 4 x layers x passes (q /
    k / v column-parallel, o row-parallel with its whole scales) on both
    ranks, per-rank weight GiB;
20b. TP identity — fp32 at Mistral-7B widths, depth 2, float weights and
    int8 weights: tp2 on the kernels == tp1 on the kernels == tp1 on the
    plain ops, greedy tokens (int8: K2 on every projection of both ranks'
    shards, CUDA cores);
20c. an NCCL group of one rank — Mistral-7B widths at 4 layers, bf16:
    the decode and (``draft_k`` 4) verify windows are captured graphs
    whose captured steps issued their all-reduces (2 a layer and the
    logits' gather), served by replays with no collective from Python,
    greedy tokens bitwise the unsharded engine's; the NCCL kernels one
    profiled replay holds are printed (none: on one rank NCCL's in-place
    all-reduce enqueues no device work, so what one card shows is that
    the capture takes the NCCL calls and the replays serve bitwise);
20d. one chat completion over HTTP through ``ChatServer`` on phase 20's
    tp2 generator (K1 on both ranks);
21. the fabric under a ``pbspro`` script (ROADMAP A11b) — the script is
    rendered with ``submit=False`` and two workers start from its
    ``python -m distllm_tpu_torch.parallel.worker`` line (plus a one-second
    heartbeat), each on the card; ``distributed_embedding`` runs BERT-base
    bf16 (a checkpoint written here, its vocabulary phase 10's words) over
    phase 10's corpus in 8 files on that executor: the shards equal a
    ``local`` run's, file for file and in order, within the embed identity
    tolerance; each task returns its worker's K3 launches (all tensor
    cores); files/s and each worker's tasks are printed. The kill arm:
    two more workers under a 5 s ``heartbeat_threshold``, one SIGKILLed
    while it holds its first task; the run finishes with every file
    written once, the requeue counted, and the seconds from the kill to
    the requeued task's start printed;
21a. ``slurm`` — the rendered script checked line by line; one worker
    from its ``--jax-distributed`` line with ``DISTLLM_JAX_*`` joins a
    world of one over NCCL and answers a task that reads its rank and
    all-reduces on the card; every worker gets the poison pill and exits 0;
21b. the router (``python -m distllm_tpu_torch.router``) over two
    ``python -m distllm_tpu_torch.chat_server`` processes, Mistral-7B bf16
    at full width and 16 of 32 layers, pools of 48 blocks of 16 and 3 slots, under
    the JAX ``gen_router`` stage's small tier (32 requests at 2 rps, 6
    sessions, warm share 0.75, a 144-token shared prefix): round-robin and
    prefix_affinity each over a fresh pair; warm TTFT p50 / p95, the
    router's decisions by label, each replica's prefix-hit share and K1
    launches (its shutdown report), and the affinity arm's warm TTFT
    speedup;
21c. failover identity — three fp32 replicas (7B widths, depth 2, the
    prefix cache off) round-robin, 18 requests at 4 rps with no kill, then
    the same arrivals with one replica SIGKILLed at a third of the
    schedule: at least one answer carries the retry marker, none is a
    5xx, every answer's token ids equal the no-kill run's;
21d. peer handoff, in this process — engine A (host tier, a
    ``KVBlockServer``) serves a prompt and spills it; engine B, cold, with
    A as its peer, adopts A's blocks (peer fetches >= 1, K1 over them);
    control C has no peer: fp32 and int8 weights (K2) at depth 2, B's
    tokens equal C's; bf16 at full depth with a 1024-token prompt, B's and
    C's first-token ms, fetch ms per MiB and A's served bytes.
22. the KV tiers under tensor parallelism (ROADMAP A10d) — Mistral-7B
    bf16 at full width, 16 of 32 layers, tp2 over gloo on the card with a
    host and a disk tier on a 48-block pool (rank 0's tiers hold whole
    blocks; each rank gathers and promotes its own heads), three
    400-token prefixes asked twice in turns, 4 new tokens; one rank on the
    same traffic beside it: spills and promotions, per-rank bytes and ms
    per MiB, rank 0's tier blocks and bytes (equal to one rank's), the
    payloads' full-head shape, K1 layers x passes on both ranks at 16 / 4
    heads. Then fp32 at depth 2: tp2 with tiers == one rank with them ==
    tp2 with the tiers off (20b's tp2 engine serves that arm) == one rank
    cold, a fresh one-rank engine on
    the tp2 disk directory promoting from it with 0 mismatches, and an
    int8 KV pool at tp2 == one rank (K1's int8 mode on both ranks);
22a. peer adoption — the fp32 one-rank engine adopts the tp2 engine's
    spilled blocks through its ``KVBlockServer``, and the reverse; first
    tokens equal a cold run's;
22b. the data-sharded index — inside phase 15's run, on its corpus and
    index files: every tier at ``mesh: {data: n}`` (n = 1, 2, 4; ubinary
    1, 2), the shards sharing the one card (a placement test, not a
    multi-card speed), 64 queries through the BERT-base retriever (K3
    layers x batches): indices and scores bitwise ``data`` 1's; device ms
    of the top-k beside its bound;
22c. BERT-base at tp2 (``TorchEncoder.shard``, two ranks over gloo on the
    card) on 256 of phase 10's texts against one device: fp32 within
    ``EMBED_RTOL`` / ``EMBED_ATOL``, bf16 within twice one device's bf16
    error plus a bf16 step; K3 on each rank at 6 of 12 heads, layers x
    batches (phase 4 times K3 at that shard shape).

Each of phases 3d, 6f, 6g, 8d, 13, 13b, 14-14d, 15-15e, 16-16d, 17-17d,
18-18d, 19-19d, 20-20d, 21-21d and 22-22c prints its seconds (the others
under ``[time]``). The last three lines of
standard output are ``{"kernels": [...]}`` (K1, K3, K2 with their cases,
launches by route and, beside each decode headline, the prefill
headline, K1's int8-KV mode under ``int8_kv``, its mixed mode under
``mixed_kv``, its verify shapes under ``verify``, head dim 256 under
``head_dim_256``, K3's protein and ModernBERT shapes and launches under
``models``, the RAG phases' K1 launches under ``rag`` and the load
phases' under ``load``, phase 17's under ``pipeline`` and 17c's under
``checkpoint``, K3's under ``retriever``, K2's embed headline, its
verify rows under ``verify`` and 17c's int8 launches under
``checkpoint``, phases 18-18d's K1 and K3 launches under ``mcqa`` and
``cli``, phases 19-19d's K1 and K2 launches under ``mixtral``, phases
20-20c's under ``tensor_parallel``, phases 21-21d's under
``control_plane``, phases 22-22c's under ``mesh_axes``), the card's
name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, and ``{"ok": true, "device": {...}}``. Without CUDA, or without the
rest of the repository beside this file, it exits nonzero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# bf16 (tensor cores) / fp32 (CUDA cores) rates, used for the least-time
# bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_INT8_OPS = 1979e12  # int8 tensor-core operations a second
NUM_HEADS, NUM_KV_HEADS, HEAD_DIM, BLOCK_SIZE = 32, 8, 128, 16
BERT_HEADS, BERT_HEAD_DIM = 12, 64
EMBED_TEXTS, EMBED_BATCH = 2048, 512
# Phases 14-14b: random proteins of the 20 standard residues; ESM-2's
# 1,024-token window holds 1,022 residues and its two framing tokens.
PROTEIN_SEQS, PROTEIN_BATCH, PROTEIN_LENS = 2048, 64, (50, 1022)
RESIDUES = 'ACDEFGHIKLMNPQRSTVWY'
# facebook/esm2_t33_650M_UR50D's config.json (the keys the port reads).
ESM2_650M_HF = {
    'vocab_size': 33, 'hidden_size': 1280, 'num_hidden_layers': 33,
    'num_attention_heads': 20, 'intermediate_size': 5120, 'layer_norm_eps': 1e-5,
    'token_dropout': True, 'mask_token_id': 32, 'pad_token_id': 1,
}
# Phases 14 and 14b run ESM-2 650M and ESM-C 600M at full width and a
# quarter of their depth (9 of 33 and of 36 layers; cut from half), so
# the whole run keeps its time budget as later phases join it; 14d holds
# both at depth 2 in fp32.
PROTEIN_LAYERS = {'esm2_650m': 9, 'esmc_600m': 9}
# Phases 6b-6g: Mistral-7B widths at 8 of its 32 layers (their depth cut
# to keep the whole run's time; 16-16c stay at 32).
SHARED_LAYERS = 8
# K3's cases at the three models' shapes (phase 4): (name, batch, S, heads,
# sliding-window half width or None). ModernBERT attends within |i - j| <= 64.
K3_MODEL_CASES = (
    ('esm2_650m_64x1024', 64, 1024, 20, None),
    ('esmc_600m_8x2048', 8, 2048, 18, None),
    ('modernbert_base_128x512_window64', 128, 512, 12, 64),
)
# ModernBERT's embed buckets timed with the window bias in phase 4: the
# smallest, on route 1, and the largest, on the wgmma route.
K3_LOCAL_BUCKETS = (160, 288)
# fp32 pooled embeddings through K3 vs its plain version: the two differ
# only in fp32 summation order inside attention (about 1e-6 relative);
# two layers and the mean pool keep that far inside 1e-4 relative, and
# 1e-5 absolute covers components near zero.
EMBED_RTOL, EMBED_ATOL = 1e-4, 1e-5
# K3 at phase 22c's shard shape (BERT-base, 6 of 12 heads a rank).
TP_K3_CASES = ('tp2_embed_512x288_6heads',)
DEVICE = 'cuda'


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
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


def graph_ms(torch, fn, iters: int) -> float:
    """Mean device time of one of ``iters`` calls of ``fn`` captured in a
    CUDA graph (after a warm-up call): the host's enqueue time, which
    exceeds a small kernel's, is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (2 * iters)
    del graph
    return ms


def host_call_us(torch, fn, iters: int) -> float:
    """Mean host time of one call of ``fn`` (after a warm-up call), on the
    host's clock while the calls are enqueued: what a call costs the CPU."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def stats_delta(engine, stats0):
    """The engine's counts since ``stats0`` (``dict(engine.stats)`` before
    a run)."""
    return {k: v - stats0.get(k, 0) for k, v in engine.stats.items()}


@contextlib.contextmanager
def k1_geometry(num_heads, num_kv_heads, head_dim):
    """K1's cases at another model's attention geometry: phase 3's helpers
    read these module values, Mistral-7B's outside this block."""
    global NUM_HEADS, NUM_KV_HEADS, HEAD_DIM
    saved = NUM_HEADS, NUM_KV_HEADS, HEAD_DIM
    NUM_HEADS, NUM_KV_HEADS, HEAD_DIM = num_heads, num_kv_heads, head_dim
    try:
        yield
    finally:
        NUM_HEADS, NUM_KV_HEADS, HEAD_DIM = saved


# --------------------------------------------------------------- phase 3
def build_case(torch, rng, ctxs, q_lens, span, dtype, int8_kv=False,
               block_size=BLOCK_SIZE, kv_dtype=None):
    """Random paged-KV inputs: rows with contexts ``ctxs`` whose last
    ``q_lens`` tokens are the query span (padded to ``span``), pages
    scattered over a pool whose trash block 0 holds large finite garbage.
    With ``int8_kv`` the pools are ``QuantizedKV``: the same N(0, 1) K/V
    quantized on the card at absmax / 127 per block and KV head
    (``quantize_kv_rows``). ``kv_dtype`` stores a full-precision pool in
    another dtype than the queries' (K1's mixed mode)."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    ctxs = np.asarray(ctxs, np.int64)
    q_lens = np.asarray(q_lens, np.int64)
    pages = -(-ctxs // block_size)
    num_blocks = int(pages.sum()) + 1
    max_blocks = int(pages.max())
    perm = rng.permutation(np.arange(1, num_blocks))
    bt = np.zeros((len(ctxs), max_blocks), np.int32)
    at = 0
    for row, n in enumerate(pages):
        bt[row, :n] = perm[at:at + n]
        at += n
    shape = (num_blocks, block_size, NUM_KV_HEADS, HEAD_DIM)
    k = torch.randn(shape, generator=gen, device=dev).to(kv_dtype or dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(kv_dtype or dtype)
    k[0] = 100.0
    v[0] = -100.0
    if int8_kv:
        from distllm_tpu_torch.ops import paged_attention as tpa

        def quantize(x):
            scale = x.float().abs().amax((1, 3)) / tpa.KV_QUANT_MAX
            return tpa.QuantizedKV(tpa.quantize_kv_rows(x, scale[:, None]), scale)

        k, v = quantize(k), quantize(v)
    q = torch.randn(
        (len(ctxs), span, NUM_HEADS, HEAD_DIM), generator=gen, device=dev
    ).to(dtype)
    q_start = ctxs - q_lens
    positions = q_start[:, None] + np.arange(span)[None, :]
    as_i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    return dict(
        q=q, k=k, v=v, bt=as_i32(bt), ctx=as_i32(ctxs), pos=as_i32(positions),
        q_lens=as_i32(q_lens), np_ctx=ctxs, np_q_lens=q_lens, np_start=q_start,
        block_size=block_size, int8_kv=int8_kv,
        mixed=kv_dtype is not None and kv_dtype != dtype,
    )


def case_work(case, window, dtype):
    """Bytes the function must move and the operations it does on these
    inputs: each live K/V row read once (int8 KV: one byte an element,
    plus K's and V's fp32 scale of each live page and KV head; a mixed
    pool: its own dtype's bytes), q read and out written once; for each
    valid query 4 * Hd flops per (query head, attended key)."""
    elt = 2 if dtype == 'bfloat16' else 4
    kv_elt = 1 if case['int8_kv'] else case['k'].element_size()
    kv_row = NUM_KV_HEADS * HEAD_DIM * kv_elt * 2  # K and V of one position
    bs = case['block_size']
    bytes_ = 2 * case['q'].numel() * elt  # q in, out back
    bytes_ += case['bt'].numel() * 4 + 3 * case['ctx'].numel() * 4
    flops = 0
    for ctx, q_len, start in zip(
        case['np_ctx'], case['np_q_lens'], case['np_start']
    ):
        if q_len == 0:
            continue
        qpos = start + np.arange(q_len)
        lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros_like(qpos)
        keys = qpos - lo + 1  # keys each valid query attends
        flops += int(keys.sum()) * 4 * HEAD_DIM * NUM_HEADS
        first_lo = int(lo[0])
        bytes_ += (int(ctx) - first_lo) * kv_row
        if case['int8_kv']:
            pages = -(-int(ctx) // bs) - first_lo // bs
            bytes_ += pages * NUM_KV_HEADS * 4 * 2
    return bytes_, flops


def sdpa_inputs(torch, case, window):
    """Dense gathered [B, H, S, Hd] q/k/v and a boolean mask for
    ``scaled_dot_product_attention`` (KV heads expanded to the query
    heads; pad queries see key 0 so no row is empty). An int8 pool is
    dequantized to q's dtype first: SDPA then reads twice its bytes in
    bf16 and computes on the rounded values, so it is a yardstick, not
    the same function."""
    b, s = case['q'].shape[:2]
    t = case['bt'].shape[1] * case['block_size']
    bt = case['bt'].long()

    def dense(pool):
        if case['int8_kv']:
            pool = (pool.data.float() * pool.scale[:, None, :, None]).to(case['q'].dtype)
        pool = pool.to(case['q'].dtype)  # a mixed pool: cast to q's dtype
        return pool[bt].reshape(b, t, NUM_KV_HEADS, HEAD_DIM)

    k, v = dense(case['k']), dense(case['v'])
    group = NUM_HEADS // NUM_KV_HEADS
    k = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    q = case['q'].transpose(1, 2).contiguous()
    kv = torch.arange(t, device=DEVICE)[None, None, :]
    qp = case['pos'].long()[:, :, None]
    mask = (kv < case['ctx'].long()[:, None, None]) & (kv <= qp)
    if window > 0:
        mask &= kv > qp - window
    q_valid = torch.arange(s, device=DEVICE)[None, :, None] < case['q_lens'][:, None, None]
    mask |= ~q_valid & (kv == 0)
    return q, k, v, mask[:, None]


def run_kernel_case(torch, tpa, name, case, window, softcap, dtype, iters, scale=None):
    args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
    kw = dict(q_lens=case['q_lens'], sliding_window=window or None,
              logit_softcap=softcap, scale=scale)
    s = case['q'].shape[1]
    kv_mode = 'int8' if case['int8_kv'] else 'mixed' if case['mixed'] else 'model'
    group = NUM_HEADS // NUM_KV_HEADS
    route = case_route(tpa, case)
    by_route = dict(tpa.ragged_paged_attention.launches_by_route)
    by_kv = dict(tpa.ragged_paged_attention.launches_by_kv)
    out = tpa.ragged_paged_attention(*args, **kw)
    ref = tpa.ragged_paged_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    if tpa.ragged_paged_attention.launches_by_route[route] != by_route[route] + 1:
        fail(f'kernel case {name}: not launched on the {route} route')
    if tpa.ragged_paged_attention.launches_by_kv[kv_mode] != by_kv[kv_mode] + 1:
        fail(f'kernel case {name}: not launched in the {kv_mode} KV mode')
    valid = (
        torch.arange(s, device=DEVICE)[None, :] < case['q_lens'][:, None]
    )
    if not torch.isfinite(out[valid].float()).all():
        fail(f'kernel case {name}: non-finite output')
    if (out[~valid] != 0).any():
        fail(f'kernel case {name}: pad queries are not exact zeros')
    tol = tpa.comparison_tolerance(ref, *args, route=route, **kw)
    diff = (out[valid].float() - ref[valid].float()).abs()
    err = float(diff.max())
    err_over_tol = float((diff / tol[valid]).max())
    del tol
    # The kernel and SDPA as CUDA-graph replays (the host's enqueue time,
    # which exceeds a decode launch's device time, is not counted); the
    # kernel also by events around eager calls and on the host's clock.
    kernel = lambda: tpa.ragged_paged_attention(*args, **kw)  # noqa: E731
    kernel_ms = graph_ms(torch, kernel, iters)
    event_ms = cuda_ms(torch, kernel, iters)
    host_us = host_call_us(torch, kernel, iters)
    plain_ms = cuda_ms(
        torch, lambda: tpa.ragged_paged_attention_reference(*args, **kw),
        max(2, iters // 5), warmup=1,
    )
    sdpa_ms = causal = None
    if softcap is None:  # SDPA has no softcap: no single library call
        sq, sk, sv, mask = sdpa_inputs(torch, case, window)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_ms = graph_ms(torch, lambda: sdpa(sq, sk, sv, attn_mask=mask, scale=scale), iters)
        # Rows that are all one fresh prompt of n tokens (no window inside
        # it, no int8 or mixed pool): is_causal on the unpadded n tokens is
        # the same function, on PyTorch's flash path, which an explicit
        # mask keeps it off.
        n = int(case['q_lens'][0])
        if (not case['int8_kv'] and not case['mixed'] and n > 1
                and bool((case['q_lens'] == n).all()) and bool((case['ctx'] == n).all())
                and (window == 0 or window >= n)):
            cq, ck, cv = (x[:, :, :n].contiguous() for x in (sq, sk, sv))
            causal_call = lambda: sdpa(cq, ck, cv, is_causal=True, scale=scale)  # noqa: E731
            lib = causal_call().transpose(1, 2).float()
            causal = dict(
                ms=graph_ms(torch, causal_call, iters),
                max_abs_err=float((lib - ref[:, :n].float()).abs().max()),
            )
            del cq, ck, cv, lib
        del sq, sk, sv, mask
    # The A/B of the two tensor-core routes on the same inputs, in this
    # call (CUDA-graph replays): bf16 tiles of 16 rows or more over a bf16
    # pool of 16-token pages, each route held to its tolerance too.
    routes_ms = {}
    if (dtype == 'bfloat16' and kv_mode == 'model' and case['block_size'] == tpa.WGMMA_BLOCK_SIZE
            and tpa._span_tile(s, group) * group >= 16):
        for other in ('tensor_cores', 'wgmma'):
            if other == route:
                routes_ms[other] = dict(ms=kernel_ms, err_over_tol=err_over_tol)
                continue
            call = functools.partial(tpa.ragged_paged_attention_cuda, *args, route=other, **kw)
            got = call()
            tol = tpa.comparison_tolerance(ref, *args, route=other, **kw)
            other_err = float(((got[valid].float() - ref[valid].float()).abs()
                               / tol[valid]).max())
            del got, tol
            if not other_err <= 1.0:
                fail(f'kernel case {name}: the {other} route exceeds its tolerance '
                     f'({other_err:.3f} x)')
            routes_ms[other] = dict(ms=graph_ms(torch, call, iters), err_over_tol=other_err)
    bytes_, flops = case_work(case, window, dtype)
    byte_ms = bytes_ / PEAK_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    result = dict(
        case=name, kernel_route=route, kv=kv_mode, block_size=case['block_size'],
        pool_dtype=str(tpa.kv_storage_dtype(case['k'])).removeprefix('torch.'),
        max_abs_err=err, err_over_tol=err_over_tol,
        tol=k1_tol(tpa, route, dtype, case['int8_kv'], case['mixed']), ms=kernel_ms,
        timer='cuda graph', event_ms=event_ms, host_us=host_us,
        plain_ms=plain_ms, bound_ms=max(byte_ms, op_ms),
        bound_by='bytes' if byte_ms >= op_ms else 'operations',
        bytes=bytes_, flops=flops,
    )
    if routes_ms:
        result['routes'] = routes_ms
    # SDPA computes the same function on a pool in q's dtype; over an int8
    # or a mixed pool it reads the pool cast to q's dtype: a yardstick.
    if case['int8_kv'] or case['mixed']:
        result.update(library_ms=None, yardstick_ms=sdpa_ms)
    elif causal is not None:
        # The library's best call is the causal one; the masked call and
        # the causal call's distance from the plain version stand beside it.
        result.update(library_ms=causal['ms'], masked_sdpa_ms=sdpa_ms,
                      library_max_abs_err=causal['max_abs_err'])
    else:
        result['library_ms'] = sdpa_ms
    log(f'[kernel] {json.dumps(result)}')
    if not err_over_tol <= 1.0:
        fail(f'kernel case {name}: |out - ref| exceeds its {route} tolerance '
             f'(worst element at {err_over_tol:.3f} x; max abs err {err})')
    return result


def case_route(tpa, case):
    """``kernel_route``'s choice for a kernel case, by its pool and pages."""
    return tpa.kernel_route(
        case['q'].dtype, case['q'].shape[1], NUM_HEADS // NUM_KV_HEADS,
        kv_mode='int8' if case['int8_kv'] else 'mixed' if case['mixed'] else 'model',
        block_size=case['block_size'])


def k1_tol(tpa, route, dtype, int8_kv=False, mixed=False):
    """``paged_attention.comparison_tolerance``'s terms, for the record."""
    tol = {'abs': tpa.TOL_ABS}
    if dtype != 'float32':
        tol['rel'] = tpa.TOL_REL
        if route in ('tensor_cores', 'split_kv', 'wgmma'):
            tol['p'] = f'{tpa.TOL_P_REL} * (P @ |V|)'
    if int8_kv:
        tol['int8'] = ('sum_j P_j E_j (|v_j| + |out|), E_j = (2 Hd + 4) * 2**-24 * '
                       'scale * (|q| . |k_j|)')
    if mixed:
        tol['mixed'] = (f'{tpa.TOL_MIXED} * (P @ |V|); with p, the bf16 terms are '
                        f'min(w * (P @ |V|), w * (|out| + {tpa.TOL_MIXED_SIGMAS} * '
                        'sqrt(P**2 @ V**2)))')
    return tol


def check_nan_trash_block(torch, tpa, case, name):
    """Garbage in the trash block (NaN here) must never reach an output:
    the kernel skips keys outside each row's range instead of weighting
    them by a zero probability."""
    args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
    clean = tpa.ragged_paged_attention(*args, q_lens=case['q_lens'])
    saved = case['k'][0].clone(), case['v'][0].clone()
    case['k'][0] = float('nan')
    case['v'][0] = float('nan')
    poisoned = tpa.ragged_paged_attention(*args, q_lens=case['q_lens'])
    case['k'][0], case['v'][0] = saved
    if not torch.equal(clean, poisoned):
        fail(f'NaN in the trash block changed the kernel output ({name})')
    route = case_route(tpa, case)
    log(f'[kernel] NaN trash block, {name} ({route} route): outputs unchanged (bitwise)')


# K1 at phase 20's shard shapes (16 query / 4 KV heads): decode, ragged
# decode, prefill.
TP_K1_CASES = ('tp2_decode_8x64-528', 'tp2_decode_32x1-4096', 'tp2_prefill_2x512')
# Phase 3's verify-shape cases (phase 6g's spans) and K2's verify rows.
VERIFY_CASE = 'verify_32x5_22-1094'
VERIFY_SPLIT_CASE = 'verify_32x3_20-1092'
K2_VERIFY = 'verify_160x4096x14336'


def phase_kernel(torch, tpa):
    dtype = torch.bfloat16
    rng = np.random.default_rng(0)
    results = []
    # (a) 32 decode rows, ragged contexts 1..4096.
    ctxs = np.concatenate([[1, 4096], rng.integers(1, 4097, size=30)])
    case = build_case(torch, rng, ctxs, np.ones(32), 1, dtype)
    results.append(run_kernel_case(torch, tpa, 'a_decode_32x1-4096', case, 0, None, 'bfloat16', 50))
    check_nan_trash_block(torch, tpa, case, 'a_decode_32x1-4096')
    del case
    # (b) 4 prefill rows: spans up to 512 over existing prefixes, padded.
    prefixes = np.asarray([0, 100, 1000, 2000])
    q_lens = np.asarray([512, 300, 17, 0])
    case = build_case(torch, rng, prefixes + q_lens + (q_lens == 0), q_lens, 512, dtype)
    results.append(run_kernel_case(torch, tpa, 'b_prefill_4x512', case, 0, None, 'bfloat16', 20))
    check_nan_trash_block(torch, tpa, case, 'b_prefill_4x512')
    check_reproducible(torch, tpa, case, 'b_prefill_4x512')
    del case
    # (c) sliding window 4096 + softcap: decode rows past the window and
    # prefill rows whose span crosses it.
    ctxs = np.concatenate([rng.integers(4097, 8193, size=6), [6000, 8000]])
    q_lens = np.asarray([1] * 6 + [256, 100])
    case = build_case(torch, rng, ctxs, q_lens, 256, dtype)
    results.append(run_kernel_case(torch, tpa, 'c_window4096_softcap30', case, 4096, 30.0, 'bfloat16', 20))
    del case
    # (d) chunk spans that start off a 64-key tile boundary (so key tiles
    # cut each span away from its diagonal), with q_lens padding.
    prefixes = np.asarray([37, 1000, 3001, 517])
    q_lens = np.asarray([100, 64, 33, 0])
    case = build_case(torch, rng, prefixes + q_lens + (q_lens == 0), q_lens, 100, dtype)
    results.append(run_kernel_case(torch, tpa, 'd_chunk_4x100_offset', case, 0, None, 'bfloat16', 20))
    del case
    # The serving phase's shapes: 8 decode rows of 18..1090 tokens and a
    # fresh 1024-token prefill pair.
    case = build_case(torch, rng, rng.integers(18, 1091, size=8), np.ones(8), 1, dtype)
    results.append(run_kernel_case(torch, tpa, 'serve_decode_8x18-1090', case, 0, None, 'bfloat16', 50))
    del case
    case = build_case(torch, rng, [1024, 700], [1024, 700], 1024, dtype)
    results.append(run_kernel_case(torch, tpa, 'serve_prefill_2x1024', case, 0, None, 'bfloat16', 20))
    del case
    # Phase 6g's verify windows: 32 rows of 1 + draft_k = 5 span positions
    # over contexts of 18..1090 keys (20-row tiles: the tensor cores), and
    # spans of 3 (12-row tiles: the split-KV route, draft_k = 2).
    # Their own generator, so the other cases keep their data.
    vrng = np.random.default_rng(10)
    for name, span in ((VERIFY_CASE, 5), (VERIFY_SPLIT_CASE, 3)):
        ctxs = vrng.integers(18, 1091, size=32) + span - 1
        case = build_case(torch, vrng, ctxs, np.full(32, span), span, dtype)
        results.append(run_kernel_case(torch, tpa, name, case, 0, None, 'bfloat16', 50))
        del case
    # Phase 20's shard shapes: one rank of tensor_parallel_size 2 at 16
    # query / 4 KV heads; its 8 decode rows of 64..528 keys and 32 ragged
    # rows of 1..4096 (split-KV), and two prompts' prefill (tensor cores).
    # Their own generator, so the other cases keep their data.
    trng = np.random.default_rng(20)
    with k1_geometry(NUM_HEADS // 2, NUM_KV_HEADS // 2, HEAD_DIM):
        for name, ctxs, q_lens, span, iters in (
                (TP_K1_CASES[0], trng.integers(64, 529, size=8), np.ones(8), 1, 50),
                (TP_K1_CASES[1], np.concatenate([[1, 4096], trng.integers(1, 4097, size=30)]),
                 np.ones(32), 1, 50),
                (TP_K1_CASES[2], [512, 300], [512, 300], 512, 20)):
            case = build_case(torch, trng, ctxs, q_lens, span, dtype)
            results.append(run_kernel_case(torch, tpa, name, case, 0, None, 'bfloat16', iters))
            del case
    # The split-KV route's edges (e-g), and its launches bitwise alike.
    for name, case, window, softcap in split_edge_cases(torch, tpa, rng, dtype):
        results.append(run_kernel_case(torch, tpa, name, case, window, softcap, 'bfloat16', 50))
        if name.startswith('e_'):
            check_nan_trash_block(torch, tpa, case, name)
            check_reproducible(torch, tpa, case, name)
        del case
    torch.cuda.empty_cache()
    for route in tpa.ROUTES:
        mine = [r for r in results if r['kernel_route'] == route]
        if mine:
            worst = max(mine, key=lambda r: r['err_over_tol'])
            log(f'[kernel] {len(mine)} {route} cases within tolerance; worst '
                f'{worst["case"]} at {worst["err_over_tol"]:.4f} of its bound')
    return results


def split_edge_cases(torch, tpa, rng, dtype, int8_kv=False):
    """Rows at the split-KV plan's edges, for the plan the wrapper makes at
    these shapes (6 rows of up to 4096 keys): (e) decode rows of 1, a
    split's length - 1, one split, one split + 1, two splits + 1 and 4096
    keys; (f) spans of 1..3 on the same rows under a window that crosses a
    split edge (a split + 50), with softcap 30; (g) decode rows whose
    window of 8 leaves one live split, or straddles a split edge."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sk = tpa.split_plan(4096, 6, NUM_KV_HEADS, sms, BLOCK_SIZE, HEAD_DIM)[1]
    edges = np.asarray([1, sk - 1, sk, sk + 1, 2 * sk + 1, 4096])
    tag = 'int8_' if int8_kv else ''
    yield (f'{tag}e_split_edges_6x1-4096', build_case(
        torch, rng, edges, np.ones(6), 1, dtype, int8_kv=int8_kv), 0, None)
    yield (f'{tag}f_window_across_splits_span3_softcap30', build_case(
        torch, rng, edges, np.minimum(edges, [1, 3, 2, 3, 3, 3]), 3, dtype,
        int8_kv=int8_kv), sk + 50, 30.0)
    yield (f'{tag}g_one_live_split_window8', build_case(
        torch, rng, [4096, sk + 3, 2 * sk + 4, 3 * sk, 9, 1], np.ones(6), 1, dtype,
        int8_kv=int8_kv), 8, None)


def check_reproducible(torch, tpa, case, name):
    """The split-KV merge adds the partials in split order, and the wgmma
    route has no atomics: two launches on the same inputs are bitwise
    equal."""
    args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
    first = tpa.ragged_paged_attention(*args, q_lens=case['q_lens'])
    second = tpa.ragged_paged_attention(*args, q_lens=case['q_lens'])
    if not torch.equal(first, second):
        fail(f'two launches on the same inputs differ ({name})')
    log(f'[kernel] {name}: two launches bitwise equal')


# -------------------------------------------------------------- phase 3b
def check_int8_trash_block(torch, tpa, case, name):
    """Garbage in the trash block of an int8 pool never reaches an output:
    codes the quantizer never writes (-128; int8 holds no NaN) and, in
    turn, a NaN scale. A key outside a row's range reads neither its
    codes nor its scale."""
    args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
    clean = tpa.ragged_paged_attention(*args, q_lens=case['q_lens'])
    route = case_route(tpa, case)
    for poison in ('data', 'scale'):
        pools = (case['k'], case['v'])
        saved = [(pool.data[0].clone(), pool.scale[0].clone()) for pool in pools]
        for pool in pools:
            if poison == 'data':
                pool.data[0] = -128
            else:
                pool.scale[0] = float('nan')
        poisoned = tpa.ragged_paged_attention(*args, q_lens=case['q_lens'])
        for pool, (data, scale) in zip(pools, saved):
            pool.data[0], pool.scale[0] = data, scale
        if not torch.equal(clean, poisoned):
            fail(f'garbage in the int8 trash block ({poison}) changed the kernel '
                 f'output ({name})')
        log(f'[kernel int8] trash block {"codes -128" if poison == "data" else "scale NaN"}, '
            f'{name} ({route} route): outputs unchanged (bitwise)')


# The serve-int8 phase's (6b) shapes: decode rows of its 32 slots and a
# prefill batch of its longest bucket.
INT8_SERVE_DECODE = 'serve_int8_decode_32x33-320'
INT8_SERVE_PREFILL = 'serve_int8_prefill_8x256'


def phase_kernel_int8(torch, tpa):
    """K1's int8-KV mode against its plain version at Mistral-7B geometry,
    each case within the int8 tolerance of the route it takes."""
    bf16 = torch.bfloat16
    rng = np.random.default_rng(10)
    results = []

    def run(name, case, window, softcap, dtype, iters):
        results.append(run_kernel_case(torch, tpa, name, case, window, softcap, dtype, iters))

    # (a) 32 decode rows, ragged contexts 1..4096 (split-KV route).
    ctxs = np.concatenate([[1, 4096], rng.integers(1, 4097, size=30)])
    case = build_case(torch, rng, ctxs, np.ones(32), 1, bf16, int8_kv=True)
    run('int8_a_decode_32x1-4096', case, 0, None, 'bfloat16', 50)
    check_int8_trash_block(torch, tpa, case, 'int8_a_decode_32x1-4096')
    del case
    # (b) 4 prefill rows: spans up to 512 over existing prefixes, padded
    # (tensor cores).
    prefixes = np.asarray([0, 100, 1000, 2000])
    q_lens = np.asarray([512, 300, 17, 0])
    case = build_case(torch, rng, prefixes + q_lens + (q_lens == 0), q_lens, 512, bf16,
                      int8_kv=True)
    run('int8_b_prefill_4x512', case, 0, None, 'bfloat16', 20)
    check_int8_trash_block(torch, tpa, case, 'int8_b_prefill_4x512')
    del case
    # (c) sliding window 4096 + softcap.
    ctxs = np.concatenate([rng.integers(4097, 8193, size=6), [6000, 8000]])
    q_lens = np.asarray([1] * 6 + [256, 100])
    case = build_case(torch, rng, ctxs, q_lens, 256, bf16, int8_kv=True)
    run('int8_c_window4096_softcap30', case, 4096, 30.0, 'bfloat16', 20)
    del case
    # (d) chunk spans that start off a 64-key tile boundary.
    prefixes = np.asarray([37, 1000, 3001, 517])
    q_lens = np.asarray([100, 64, 33, 0])
    case = build_case(torch, rng, prefixes + q_lens + (q_lens == 0), q_lens, 100, bf16,
                      int8_kv=True)
    run('int8_d_chunk_4x100_offset', case, 0, None, 'bfloat16', 20)
    del case
    # (e) fp32 queries (CUDA cores), decode rows and a chunk.
    case = build_case(torch, rng, [700, 1, 2048, 300], [100, 1, 1, 37], 100,
                      torch.float32, int8_kv=True)
    run('int8_e_fp32_chunk_4x100', case, 0, None, 'float32', 10)
    del case
    # (f) block size 32, decode (split-KV route) and prefill (tensor cores).
    case = build_case(torch, rng, rng.integers(1, 2049, size=16), np.ones(16), 1, bf16,
                      int8_kv=True, block_size=32)
    run('int8_f_bs32_decode_16x1-2048', case, 0, None, 'bfloat16', 50)
    del case
    case = build_case(torch, rng, [300, 1100], [300, 77], 300, bf16, int8_kv=True,
                      block_size=32)
    run('int8_f_bs32_prefill_2x300', case, 0, None, 'bfloat16', 20)
    del case
    # (g) the serving phases' shapes: phase 6's decode rows and prefill
    # pair (the bf16 headlines), and phase 6b's.
    case = build_case(torch, rng, rng.integers(18, 1091, size=8), np.ones(8), 1, bf16,
                      int8_kv=True)
    run('int8_serve_decode_8x18-1090', case, 0, None, 'bfloat16', 50)
    del case
    case = build_case(torch, rng, [1024, 700], [1024, 700], 1024, bf16, int8_kv=True)
    run('int8_serve_prefill_2x1024', case, 0, None, 'bfloat16', 20)
    del case
    case = build_case(torch, rng, rng.integers(33, 321, size=32), np.ones(32), 1, bf16,
                      int8_kv=True)
    run(INT8_SERVE_DECODE, case, 0, None, 'bfloat16', 50)
    del case
    lens = rng.integers(129, 257, size=8)
    case = build_case(torch, rng, lens, lens, int(lens.max()), bf16, int8_kv=True)
    run(INT8_SERVE_PREFILL, case, 0, None, 'bfloat16', 20)
    del case
    # (h) the split-KV route's edges over the int8 pool.
    for name, case, window, softcap in split_edge_cases(torch, tpa, rng, bf16, int8_kv=True):
        run(name, case, window, softcap, 'bfloat16', 50)
        if name.startswith('int8_e_'):
            check_int8_trash_block(torch, tpa, case, name)
            check_reproducible(torch, tpa, case, name)
        del case
    torch.cuda.empty_cache()
    for route in tpa.ROUTES:
        mine = [r for r in results if r['kernel_route'] == route]
        if mine:
            worst = max(mine, key=lambda r: r['err_over_tol'])
            log(f'[kernel int8] {len(mine)} {route} cases within tolerance; worst '
                f'{worst["case"]} at {worst["err_over_tol"]:.4f} of its bound')
    return results


# -------------------------------------------------------------- phase 3c
# K1's mixed mode at the main path's shapes: phase 3's decode rows, a
# prefill pair and the serve decode shape, fp32 q over a bf16 pool (the
# CUDA cores) and bf16 q over an fp32 pool (the tensor cores and the
# split-KV route). The headline is phase 8c's shape: fp32 q over bf16.
MIXED_HEAD = 'mixed_fp32q_serve_decode_8x18-1090'


def planted_last_page(torch, tpa, case, name):
    """A subtle fault, planted through the wrapper: the kernel run with the
    longest row's context ending one page early (the keys of its last page
    skipped, positions unchanged), held to the plain version of the true
    inputs. Its worst element must exceed the tolerance; returns that
    ratio. The launch is a comparison's, outside every counted run."""
    args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
    kw = dict(q_lens=case['q_lens'])
    cut = case['ctx'].clone()
    row = int(torch.argmax(cut))
    cut[row] = (int(cut[row]) - 1) // case['block_size'] * case['block_size']
    out = tpa.ragged_paged_attention(*args[:4], cut, args[5], **kw)
    ref = tpa.ragged_paged_attention_reference(*args, **kw)
    route = case_route(tpa, case)
    tol = tpa.comparison_tolerance(ref, *args, route=route, **kw)
    valid = torch.arange(case['q'].shape[1], device=DEVICE)[None, :] < case['q_lens'][:, None]
    ratio = float(((out[valid].float() - ref[valid].float()).abs() / tol[valid]).max())
    log(f'[kernel mixed] planted fault, {name} ({route} route): the longest row\'s last page '
        f'dropped, worst element at {ratio:.3f} x its tolerance')
    if not ratio > 1.0:
        fail(f'kernel case {name}: a dropped last page stays within the {route} tolerance '
             f'({ratio:.3f} x)')
    return ratio


def phase_kernel_mixed(torch, tpa):
    """K1's mixed full-precision mode against its plain version, each case
    within the mixed tolerance of the route it takes; NaN in the trash
    block leaves the outputs of a case on each route bitwise unchanged;
    the longest row's dropped last page exceeds the tolerance on each
    route."""
    rng = np.random.default_rng(20)
    results = []
    pairs = (('fp32q', torch.float32, torch.bfloat16, 'float32', 10),
             ('bf16q', torch.bfloat16, torch.float32, 'bfloat16', 50))
    for tag, q_dtype, kv_dtype, name, iters in pairs:
        def run(case_name, case, check_nan=False, plant=False):
            results.append(run_kernel_case(torch, tpa, case_name, case, 0, None, name, iters))
            if check_nan:
                check_nan_trash_block(torch, tpa, case, case_name)
            if plant:
                results[-1]['planted_last_page_err_over_tol'] = planted_last_page(
                    torch, tpa, case, case_name)

        ctxs = np.concatenate([[1, 4096], rng.integers(1, 4097, size=30)])
        case = build_case(torch, rng, ctxs, np.ones(32), 1, q_dtype, kv_dtype=kv_dtype)
        run(f'mixed_{tag}_decode_32x1-4096', case, check_nan=True, plant=True)
        del case
        if tag == 'bf16q':  # spans of 4: 16-row tiles, the tensor cores
            case = build_case(torch, rng, ctxs, np.minimum(4, ctxs), 4, q_dtype,
                              kv_dtype=kv_dtype)
            run(f'mixed_{tag}_span4_32x1-4096', case, plant=True)
            del case
        case = build_case(torch, rng, [1024, 700], [1024, 700], 1024, q_dtype,
                          kv_dtype=kv_dtype)
        run(f'mixed_{tag}_prefill_2x1024', case, check_nan=True)
        del case
        case = build_case(torch, rng, rng.integers(18, 1091, size=8), np.ones(8), 1, q_dtype,
                          kv_dtype=kv_dtype)
        run(f'mixed_{tag}_serve_decode_8x18-1090', case)
        del case
    torch.cuda.empty_cache()
    for route in tpa.ROUTES:
        mine = [r for r in results if r['kernel_route'] == route]
        if mine:
            worst = max(mine, key=lambda r: r['err_over_tol'])
            log(f'[kernel mixed] {len(mine)} {route} cases within tolerance; worst '
                f'{worst["case"]} at {worst["err_over_tol"]:.4f} of its bound')
    return results


# -------------------------------------------------------------- phase 3d
# K1 at head dim 256, Gemma-2-9B's attention geometry (16 query / 8 KV
# heads, block 16, scale query_pre_attn_scalar ** -0.5 = 256 ** -0.5).
GEMMA2_HEADS, GEMMA2_KV_HEADS, GEMMA2_HEAD_DIM = 16, 8, 256
GEMMA2_SCALE = 256 ** -0.5
HD256_DECODE = 'hd256_g_serve_decode_8x256-4664'
HD256_PREFILL = 'hd256_g_serve_prefill_1x4600'


def check_too_large_raises(torch, tpa):
    """A configuration whose route needs more shared memory than a block
    may have is refused at launch with both sizes, never served by
    another route: fp32 at head dim 256 with 128 query heads over one KV
    head (route 0, a 128-row tile)."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    q = torch.randn((1, 1, 128, 256), generator=gen, device=DEVICE)
    pool = torch.randn((2, BLOCK_SIZE, 1, 256), generator=gen, device=DEVICE)
    i32 = lambda *a: torch.tensor(a, dtype=torch.int32, device=DEVICE)  # noqa: E731
    before = (tpa.ragged_paged_attention.launches, tpa.ragged_paged_attention_reference.launches)
    try:
        tpa.ragged_paged_attention(q, pool, pool, i32([1]), i32(5), i32([4]))
    except ValueError as exc:
        if 'shared memory' not in str(exc):
            fail(f'head dim 256, 128-row fp32 tile: refused for another reason: {exc}')
        log(f'[kernel hd256] a 128-row fp32 tile at head dim 256 is refused: {exc}')
    else:
        fail('head dim 256, 128-row fp32 tile: launched although it cannot fit')
    after = (tpa.ragged_paged_attention.launches, tpa.ragged_paged_attention_reference.launches)
    if after != before:
        fail(f'the refused configuration launched something: {before} -> {after}')


def phase_kernel_256(torch, tpa):
    """K1 at head dim 256 against its plain version, each case within the
    tolerance of the route and KV mode it takes: (a) 32 decode rows of
    1..8192 keys (split-KV), (b) the prefill pair 1024 + 700 (tensor
    cores), (c) window 4096 + softcap 50 over decode rows and chunk spans
    that cross the window's edge, (d) (a) and (b) over an int8 pool, (e)
    (a) and (b) in the mixed mode both ways (fp32 q over bf16 on the CUDA
    cores; bf16 q over fp32 on the split-KV route's one-deep rings and
    the tensor cores' 32-key tiles, each with a planted dropped page), (f)
    fp32 on route 0, (g) phase 13's serve shapes, (h) the split-KV edges
    at this head dim's plan; NaN in the trash block leaves a case of each
    route bitwise unchanged; a configuration too large for shared memory
    raises."""
    bf16, fp32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(30)
    results = []

    def run(name, case, window, softcap, dtype, iters, nan=False):
        results.append(run_kernel_case(torch, tpa, name, case, window, softcap, dtype, iters,
                                       scale=GEMMA2_SCALE))
        if nan:
            if case['int8_kv']:
                check_int8_trash_block(torch, tpa, case, name)
            else:
                check_nan_trash_block(torch, tpa, case, name)

    with k1_geometry(GEMMA2_HEADS, GEMMA2_KV_HEADS, GEMMA2_HEAD_DIM):
        ctxs = np.concatenate([[1, 8192], rng.integers(1, 8193, size=30)])
        pair = dict(ctxs=[1024, 700], q_lens=[1024, 700], span=1024)
        for tag, kw, name in (('', {}, 'bfloat16'), ('int8_', {'int8_kv': True}, 'bfloat16')):
            # (a), (b); (d) over an int8 pool.
            case = build_case(torch, rng, ctxs, np.ones(32), 1, bf16, **kw)
            run(f'hd256_{tag}a_decode_32x1-8192', case, 0, None, name, 30, nan=True)
            if not tag:
                check_reproducible(torch, tpa, case, 'hd256_a_decode_32x1-8192')
            del case
            case = build_case(torch, rng, pair['ctxs'], pair['q_lens'], pair['span'], bf16, **kw)
            run(f'hd256_{tag}b_prefill_2x1024', case, 0, None, name, 10, nan=True)
            del case
        # (c) window 4096 + softcap 50: decode rows past and across the
        # window's edge, then chunk spans that cross it.
        case = build_case(torch, rng, np.concatenate([rng.integers(4097, 8193, size=6),
                                                      [4096, 4097]]), np.ones(8), 1, bf16)
        run('hd256_c_window4096_softcap50_decode_8', case, 4096, 50.0, 'bfloat16', 30)
        del case
        case = build_case(torch, rng, [4200, 6000, 8000, 300], [256, 100, 256, 0], 256, bf16)
        run('hd256_c_window4096_softcap50_chunk_4x256', case, 4096, 50.0, 'bfloat16', 10)
        del case
        # (e) the mixed mode both ways.
        for tag, q_dtype, kv_dtype, name, iters in (
                ('fp32q', fp32, bf16, 'float32', 5), ('bf16q', bf16, fp32, 'bfloat16', 30)):
            case = build_case(torch, rng, ctxs, np.ones(32), 1, q_dtype, kv_dtype=kv_dtype)
            run(f'hd256_mixed_{tag}_a_decode_32x1-8192', case, 0, None, name, iters, nan=True)
            results[-1]['planted_last_page_err_over_tol'] = planted_last_page(
                torch, tpa, case, results[-1]['case'])
            del case
            case = build_case(torch, rng, pair['ctxs'], pair['q_lens'], pair['span'], q_dtype,
                              kv_dtype=kv_dtype)
            run(f'hd256_mixed_{tag}_b_prefill_2x1024', case, 0, None, name, max(2, iters // 3),
                nan=True)
            if tag == 'bf16q':
                results[-1]['planted_last_page_err_over_tol'] = planted_last_page(
                    torch, tpa, case, results[-1]['case'])
            del case
        # (f) fp32 on route 0: decode rows and a chunk.
        case = build_case(torch, rng, [700, 1, 2048, 300], [100, 1, 1, 37], 100, fp32)
        run('hd256_f_fp32_chunk_4x100', case, 0, None, 'float32', 5, nan=True)
        del case
        # (g) phase 13's shapes: its 8 slots' decode rows and one long
        # prompt's prefill in its bucket.
        case = build_case(torch, rng, rng.integers(256, 4665, size=8), np.ones(8), 1, bf16)
        run(HD256_DECODE, case, 0, None, 'bfloat16', 50)
        del case
        case = build_case(torch, rng, [4600], [4600], 4736, bf16)
        run(HD256_PREFILL, case, 0, None, 'bfloat16', 5)
        del case
        # (h) the split-KV edges at this head dim's plan.
        for name, case, window, softcap in split_edge_cases(torch, tpa, rng, bf16):
            run(f'hd256_{name}', case, window, softcap, 'bfloat16', 30)
            del case
        check_too_large_raises(torch, tpa)
    torch.cuda.empty_cache()
    for route in tpa.ROUTES:
        mine = [r for r in results if r['kernel_route'] == route]
        if mine:
            worst = max(mine, key=lambda r: r['err_over_tol'])
            log(f'[kernel hd256] {len(mine)} {route} cases within tolerance; worst '
                f'{worst["case"]} at {worst["err_over_tol"]:.4f} of its bound')
    return results


# --------------------------------------------------------------- phase 4
def k3_case(torch, rng, b, s, lens, dtype, window=None, heads=BERT_HEADS,
            head_dim=BERT_HEAD_DIM):
    """Random packed q/k/v ``[b, s, heads * head_dim]`` (BERT-base's 12 x
    64 unless named), a key mask of row lengths ``lens`` (0 = a fully
    masked batch row) and, with ``window``, the ``[s, s]`` sliding-window
    bias (0 inside, -1e9 outside)."""
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(1 << 30)))
    shape = (b, s, heads * head_dim)
    q, k, v = (
        torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(3)
    )
    lens = torch.as_tensor(np.asarray(lens), device=DEVICE)
    mask = (torch.arange(s, device=DEVICE)[None, :] < lens[:, None]).int()
    bias = None
    if window is not None:
        pos = torch.arange(s, device=DEVICE)
        dist = (pos[:, None] - pos[None, :]).abs()
        bias = torch.where(dist <= window, 0.0, -1e9).float()
    return dict(q=q, k=k, v=v, mask=mask, bias=bias, heads=heads)


def run_k3_case(torch, tea, name, case, iters):
    q, k, v, mask, bias = (case[key] for key in ('q', 'k', 'v', 'mask', 'bias'))
    b, s, d = q.shape
    heads = case['heads']
    head_dim = d // heads
    args = (q, k, v, mask, heads)
    route = tea.kernel_route(q.dtype, head_dim, s, bias is not None)
    by_route = dict(tea.encoder_attention.launches_by_route)
    out = tea.encoder_attention(*args, bias=bias)
    ref = tea.encoder_attention_reference(*args, bias=bias)
    torch.cuda.synchronize()
    if tea.encoder_attention.launches_by_route[route] != by_route[route] + 1:
        fail(f'K3 case {name}: not launched on the {route} route')
    if not torch.isfinite(out.float()).all():
        fail(f'K3 case {name}: non-finite output (fully masked rows included)')
    tol = tea.comparison_tolerance(ref, *args, bias=bias)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    err_over_tol = float((diff / tol).max())
    del out, diff
    kernel_ms = cuda_ms(torch, lambda: tea.encoder_attention(*args, bias=bias), iters)
    # The A/B of the two tensor-core routes on the same inputs, in this
    # call, each held to the tolerance: bf16 at the wgmma route's head dims.
    routes_ms = {}
    if q.dtype == torch.bfloat16 and head_dim in tea.WGMMA_HEAD_DIMS:
        for other in ('tensor_cores', 'wgmma'):
            if other == route:
                routes_ms[other] = dict(ms=kernel_ms, err_over_tol=err_over_tol)
                continue
            call = functools.partial(tea.encoder_attention_cuda, *args, bias=bias, route=other)
            other_err = float(((call().float() - ref.float()).abs() / tol).max())
            if not other_err <= 1.0:
                fail(f'K3 case {name}: the {other} route exceeds its tolerance '
                     f'({other_err:.3f} x)')
            routes_ms[other] = dict(ms=cuda_ms(torch, call, iters), err_over_tol=other_err)
    del ref, tol
    plain_ms = cuda_ms(
        torch, lambda: tea.encoder_attention_reference(*args, bias=bias),
        max(2, iters // 5), warmup=1,
    )
    # The yardstick: one SDPA call on pre-transposed [B, N, S, Hd] inputs
    # with the key mask (boolean), or the key mask plus the [S, S] bias
    # (additive), as its attention mask.
    split = [
        x.reshape(b, s, heads, head_dim).transpose(1, 2).contiguous()
        for x in (q, k, v)
    ]
    keys = mask.bool()[:, None, None, :]
    attn_mask = keys if bias is None else (
        torch.where(keys, 0.0, -1e9).to(q.dtype) + bias.to(q.dtype)[None, None]
    )
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(torch, lambda: sdpa(*split, attn_mask=attn_mask), iters)
    del split, attn_mask
    elt = q.element_size()
    bytes_ = 4 * b * s * d * elt + mask.numel() * 4
    if bias is not None:
        bytes_ += bias.numel() * 4
    flops = 4 * b * heads * s * s * head_dim
    byte_ms = bytes_ / PEAK_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[str(q.dtype).removeprefix('torch.')] * 1e3
    result = dict(
        case=name, kernel_route=route, max_abs_err=err, err_over_tol=err_over_tol,
        tol={'rel': tea.TOL_REL, 'abs': tea.TOL_ABS,
             'straddle': 'rel * p_max * v_max' if q.dtype == torch.bfloat16 else 0},
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(byte_ms, op_ms),
        bound_by='bytes' if byte_ms >= op_ms else 'operations',
        bytes=bytes_, flops=flops,
    )
    if routes_ms:
        result['routes'] = routes_ms
    log(f'[kernel K3] {json.dumps(result)}')
    if not err_over_tol <= 1.0:
        fail(f'K3 case {name}: |out - ref| exceeds its elementwise tolerance '
             f'(worst element at {err_over_tol:.3f} x; max abs err {err})')
    return result


def phase_encoder_kernel(torch, tea):
    rng = np.random.default_rng(3)
    bf16 = torch.bfloat16
    results = []
    # The embed path's shapes: batch 512 of one bucket, every row's length
    # within the bucket's last 32 positions, as length-sorted batches are;
    # ModernBERT's local layers at two of its buckets (phase 14c).
    for s, iters in ((128, 20), (192, 10), (288, 5)):
        lens = rng.integers(max(1, s - 31), s + 1, size=512)
        case = k3_case(torch, rng, 512, s, lens, bf16)
        results.append(run_k3_case(torch, tea, f'embed_512x{s}', case, iters))
        del case
    for s in K3_LOCAL_BUCKETS:
        lens = rng.integers(max(1, s - 31), s + 1, size=512)
        case = k3_case(torch, rng, 512, s, lens, bf16, window=64)
        results.append(run_k3_case(torch, tea, f'modernbert_local_512x{s}_window64', case, 5))
        del case
    lens = np.concatenate([rng.integers(1, 257, size=56), np.zeros(8, int)])
    case = k3_case(torch, rng, 64, 256, lens, bf16)
    results.append(run_k3_case(torch, tea, 'masks_64x256_8_fully_masked', case, 20))
    case = k3_case(torch, rng, 512, 16, rng.integers(3, 17, size=512), bf16)
    results.append(run_k3_case(torch, tea, 'short_512x16', case, 20))
    lens = np.concatenate([rng.integers(1, 78, size=62), [0, 77]])
    case = k3_case(torch, rng, 64, 77, lens, bf16)
    results.append(run_k3_case(torch, tea, 'odd_64x77', case, 20))
    case = k3_case(torch, rng, 32, 256, rng.integers(1, 257, size=32), bf16, window=64)
    results.append(run_k3_case(torch, tea, 'window64_32x256', case, 20))
    case = k3_case(torch, rng, 64, 192, rng.integers(1, 193, size=64), torch.float32)
    results.append(run_k3_case(torch, tea, 'fp32_64x192', case, 10))
    # A head dim that is not a multiple of 16 (32 heads x 24) stays on the
    # CUDA-core route in bf16.
    case = k3_case(torch, rng, 64, 192, rng.integers(1, 193, size=64), bf16,
                   heads=32, head_dim=24)
    results.append(run_k3_case(torch, tea, 'hd24_64x192', case, 10))
    del case
    # Phase 22c's shard shape: BERT-base's embed batch at one rank's 6 of
    # 12 heads (tensor_parallel_size 2).
    lens = rng.integers(288 - 31, 289, size=512)
    case = k3_case(torch, rng, 512, 288, lens, bf16, heads=BERT_HEADS // 2)
    results.append(run_k3_case(torch, tea, TP_K3_CASES[0], case, 5))
    del case
    # The protein and ModernBERT phases' shapes: unsorted protein batches
    # (the embedder sorts by whitespace words, which a sequence has one
    # of) carry rows of any length; every row at least the shortest.
    for name, b, s, heads, window in K3_MODEL_CASES:
        lens = rng.integers(min(s, PROTEIN_LENS[0]), s + 1, size=b)
        lens[0] = s
        case = k3_case(torch, rng, b, s, lens, bf16, window=window, heads=heads)
        results.append(run_k3_case(torch, tea, name, case, 5))
        del case
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- phase 5
# K2 cases: Mistral-7B decode rows at every projection shape, a ragged
# prefill, the BERT-base embed products, M = 5 and 16, tiles cut by M and
# by N, one-signed data, a zero weight column, fp32.
K2_DECODE_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# Headlines: the serve path's decode, prefill and the embed path's widest.
K2_HEADLINE = 'decode_8x4096x14336'
K2_PREFILL = 'prefill_1040x4096x14336'
K2_EMBED = 'embed_147456x768x3072'
# (name, M, K, N, dtype name, data, timed launches); data 'normal', 'zero
# column' (weight column 3 all zero), 'one-signed' (|x|, |w|),
# 'late-cancelling' (see late_cancelling) or 'row shard' (the first K rows
# of a weight of 2K rows quantized whole).
K2_OTHER_CASES = (
    ('decode_16x4096x14336', 16, 4096, 14336, 'bfloat16', 'normal', 50),
    # A verify pass's rows (32 slots x 1 + draft_k = 5, phase 6g).
    ('verify_160x4096x14336', 160, 4096, 14336, 'bfloat16', 'normal', 50),
    ('prefill_1040x4096x14336', 1040, 4096, 14336, 'bfloat16', 'normal', 10),
    ('embed_147456x768x3072', 512 * 288, 768, 3072, 'bfloat16', 'normal', 3),
    ('embed_147456x3072x768', 512 * 288, 3072, 768, 'bfloat16', 'normal', 3),
    ('embed_147456x768x768', 512 * 288, 768, 768, 'bfloat16', 'normal', 3),
    ('rows_5x4096x4096', 5, 4096, 4096, 'bfloat16', 'normal', 50),
    ('rows_1000x4096x1024', 1000, 4096, 1024, 'bfloat16', 'normal', 20),
    ('cols_64x768x784', 64, 768, 784, 'bfloat16', 'normal', 50),
    ('one_signed_8x14336x4096', 8, 14336, 4096, 'bfloat16', 'one-signed', 50),
    ('late_cancel_2048x14336x4096', 2048, 14336, 4096, 'bfloat16', 'late-cancelling', 10),
    ('zero_column_8x4096x1024', 8, 4096, 1024, 'bfloat16', 'zero column', 50),
    ('fp32_32x4096x4096', 32, 4096, 4096, 'float32', 'normal', 20),
    # Phase 20a's shard shapes on one rank of tensor_parallel_size 2: q and
    # k / v column-parallel (their per-channel scales split with the
    # codes), o row-parallel (half the rows' codes, the whole K's scales).
    ('tp2_q_8x4096x2048', 8, 4096, 2048, 'bfloat16', 'normal', 50),
    ('tp2_kv_8x4096x512', 8, 4096, 512, 'bfloat16', 'normal', 50),
    ('tp2_o_8x2048x4096', 8, 2048, 4096, 'bfloat16', 'row shard', 50),
)
TP_K2_CASES = ('tp2_q_8x4096x2048', 'tp2_kv_8x4096x512', 'tp2_o_8x2048x4096')
# Weight bytes cycled through while timing, so every launch finds its
# weight cold in the 50 MB L2 cache, as a decode step over 32 layers does.
K2_COLD_BYTES = 256 << 20


def late_cancelling(rng, m: int, k: int, n: int):
    """x ``[m, k]`` (fp32 holding bf16 values, every row alike) and int8
    codes q ``[k, n]`` whose exact product is 0 while every partial sum
    stays near its peak: one large first term (x = 2**13, codes 100..127),
    small one-signed terms (x in [1/16, 1/8) on a bf16 grid, codes
    0..127), then a last 16-deep slice that cancels the sum exactly (rows
    at x = 2**-11, 2**-4, 2**3 and 2**10 clear its residues modulo 2**-4,
    2**3, 2**10 and 2**17, and a row at x = 2**17 takes the rest). The
    tensor cores' truncation grows with the accumulator, and here the
    exact result is 0, so the bf16 term of the bound gives nothing."""
    xk = np.zeros(k)
    q = np.zeros((k, n))
    xk[0] = 2.0 ** 13
    q[0] = rng.integers(100, 128, n)
    xk[1:k - 16] = 2.0 ** -4 * (1 + np.floor(rng.random(k - 17) * 128) / 128)
    q[1:k - 16] = rng.integers(0, 128, (k - 17, n))
    total = xk @ q  # exact: multiples of 2**-11 below 2**24
    for row, e in enumerate((-11, -4, 3, 10), start=k - 16):
        xk[row] = 2.0 ** e
        q[row] = np.mod(-total / 2.0 ** e, 128)
        total += xk[row] * q[row]
    xk[k - 12] = 2.0 ** 17
    q[k - 12] = -total / 2.0 ** 17
    assert np.abs(q).max() <= 127 and not (xk @ q).any()
    return np.tile(xk.astype(np.float32), (m, 1)), q.astype(np.int8)


def k2_case(torch, tq, gen, m, k, n, dtype, data='normal'):
    """x [m, k] ~ N(0, 1) in ``dtype`` and int8 quantizations of
    independent N(0, 0.02) weights [k, n] (enough copies to exceed the L2
    cache), made on the card; with ``data='zero column'`` weight column 3
    is all zero (scale 1, codes 0), with ``'one-signed'`` x and the
    weights are their absolute values (every partial sum as large as the
    total), with ``'late-cancelling'`` x and one weight's codes come from
    :func:`late_cancelling` (seed 5), with a scale of 2**-10; with
    ``'row shard'`` each weight is drawn [2k, n] and quantized whole, and
    the case keeps its first k rows' codes with the whole weight's scales
    (a row-parallel rank's shard)."""
    zero_column = data == 'zero column'
    if data == 'late-cancelling':
        xs, codes = late_cancelling(np.random.default_rng(5), m, k, n)
        scale = torch.full((1, n), 2.0 ** -10, device=DEVICE)
        return dict(x=torch.from_numpy(xs).to(DEVICE, dtype), zero_column=False,
                    weights=[(torch.from_numpy(codes).to(DEVICE), scale)])
    x = torch.randn((m, k), generator=gen, device=DEVICE).to(dtype)
    if data == 'one-signed':
        x = x.abs()
    copies = max(1, min(16, -(-K2_COLD_BYTES // (k * n))))
    rows = 2 * k if data == 'row shard' else k
    weights = []
    for _ in range(copies):
        w = torch.randn((rows, n), generator=gen, device=DEVICE).mul_(0.02)
        if data == 'one-signed':
            w = w.abs()
        if zero_column:
            w[:, 3] = 0.0
        qt = tq.quantize_int8(w, dtype)
        weights.append((qt.q[:k].contiguous(), qt.scale))
        del w
    return dict(x=x, weights=weights, zero_column=zero_column)


def run_k2_case(torch, tqm, name, case, iters):
    x, weights = case['x'], case['weights']
    q, scale = weights[0]
    m, k = x.shape
    n = q.shape[1]
    route = tqm.kernel_route(m, k, n, x.dtype)
    by_route = dict(tqm.int8_matmul.launches_by_route)
    out = tqm.int8_matmul(x, q, scale)
    ref = tqm.int8_matmul_reference(x, q, scale)
    tol = tqm.comparison_tolerance(x, q, scale, route=route)
    torch.cuda.synchronize()
    if tqm.int8_matmul.launches_by_route[route] != by_route[route] + 1:
        fail(f'K2 case {name}: not launched on the {route} route')
    if not torch.isfinite(out.float()).all():
        fail(f'K2 case {name}: non-finite output')
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    err_over_tol = float((diff / tol).max())
    # The same difference against the CUDA-core route's bound, which has no
    # truncation term: what that term buys on this data.
    err_over_cuda_cores_tol = float(
        (diff / tqm.comparison_tolerance(x, q, scale, route='cuda_cores')).max()
    )
    if case['zero_column'] and (
        float(scale.reshape(-1)[3]) != 1.0 or (q[:, 3] != 0).any() or (out[:, 3] != 0).any()
    ):
        fail(f'K2 case {name}: the all-zero weight column is not scale 1, '
             'codes 0, output exactly 0')
    del out, ref, tol, diff
    turn = iter(range(1 << 30))

    def cycled(fn):
        def call():
            wq, ws = weights[next(turn) % len(weights)]
            return fn(wq, ws)
        return call

    kernel = cycled(lambda wq, ws: tqm.int8_matmul(x, wq, ws))
    kernel_ms = graph_ms(torch, kernel, iters)
    event_ms = cuda_ms(torch, kernel, iters, warmup=1)
    host_us = host_call_us(torch, kernel, iters)
    plain_ms = cuda_ms(
        torch, lambda: tqm.int8_matmul_reference(x, q, scale), max(2, iters // 5),
        warmup=1,
    )
    # The yardstick: a plain torch.matmul on the weight dequantized to x's
    # dtype. It reads twice the weight bytes (bf16) and rounds the weight
    # before the product, so it is not the same function.
    dequantized = [(wq.to(x.dtype) * ws.to(x.dtype)) for wq, ws in weights]
    turn_d = iter(range(1 << 30))
    yardstick_ms = graph_ms(
        torch, lambda: torch.matmul(x, dequantized[next(turn_d) % len(dequantized)]),
        iters,
    )
    del dequantized
    elt = x.element_size()
    bytes_ = m * k * elt + k * n + 4 * n + m * n * elt
    flops = 2 * m * k * n
    byte_ms = bytes_ / PEAK_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[str(x.dtype).removeprefix('torch.')] * 1e3
    result = dict(
        case=name, kernel_route=route, m=m, k=k, n=n,
        dtype=str(x.dtype).removeprefix('torch.'),
        max_abs_err=err, err_over_tol=err_over_tol,
        err_over_cuda_cores_tol=err_over_cuda_cores_tol, tol=k2_tol(tqm, route, x.dtype),
        ms=kernel_ms, timer='cuda graph', event_ms=event_ms, host_us=host_us,
        plain_ms=plain_ms, library_ms=None,
        yardstick_ms=yardstick_ms, bound_ms=max(byte_ms, op_ms),
        bound_by='bytes' if byte_ms >= op_ms else 'operations',
        bytes=bytes_, flops=flops, weight_copies=len(weights),
        split_k=tqm.launch_shape(m, k, n, torch.cuda.get_device_properties(0)
                                 .multi_processor_count, route)[1],
    )
    log(f'[kernel K2] {json.dumps(result)}')
    if not err_over_tol <= 1.0:
        fail(f'K2 case {name}: |out - ref| exceeds its elementwise tolerance '
             f'(worst element at {err_over_tol:.3f} x; max abs err {err})')
    return result


def k2_tol(tqm, route, dtype):
    """``quantized_matmul.comparison_tolerance``'s terms, for the record."""
    terms = {'rel': tqm.TOL_REL if str(dtype) == 'torch.bfloat16' else 0.0,
             'order': f'{tqm.ORDER} * sqrt(K) * 2**-24 * scale * (|x| @ |q|)',
             'abs': tqm.TOL_ABS}
    if route == 'tensor_cores':
        terms['trunc'] = (f'{tqm.TRUNC} * 2**-24 * scale * W, W = sum over 16-deep atoms '
                          'of the largest |prefix sum| so far')
    return terms


def phase_int8_kernel(torch, tq, tqm):
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    bf16 = torch.bfloat16
    results = []
    for m in (1, 8, 32, 128):
        for k, n in K2_DECODE_SHAPES:
            case = k2_case(torch, tq, gen, m, k, n, bf16)
            results.append(run_k2_case(torch, tqm, f'decode_{m}x{k}x{n}', case, 50))
            del case
    for name, m, k, n, dtype, data, iters in K2_OTHER_CASES:
        case = k2_case(torch, tq, gen, m, k, n, getattr(torch, dtype), data=data)
        results.append(run_k2_case(torch, tqm, name, case, iters))
        del case
        torch.cuda.empty_cache()
    worst = max(results, key=lambda r: r['err_over_tol'])
    log(f'[kernel K2] {len(results)} cases within tolerance; worst {worst["case"]} '
        f'at {worst["err_over_tol"]:.4f} of its bound')
    return results


# ------------------------------------------------------------ phases 6-7
def smoke_prompts(rng, n, lo, hi):
    words = [f'w{i}' for i in range(5000)]
    lengths = np.linspace(lo, hi, n).astype(int) - 2  # + CLS and SEP
    return [' '.join(rng.choice(words, size=int(m))) for m in lengths]


def post_completion(port, i):
    body = json.dumps({
        'model': 'mistral-7b-random',
        'messages': [{'role': 'user', 'content': f'question {i}: ' + 'tell me more ' * (8 * i + 4)}],
    }).encode()
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/v1/chat/completions', data=body,
        headers={'Content-Type': 'application/json', 'X-Request-Id': f'smoke-{i}'},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


GRAPH_STATS = ('decode_graph_captures', 'decode_graph_replays', 'verify_graph_captures',
               'verify_graph_replays')


def graph_marks(engine):
    """The engine's graph counters (decode and verify), read before a run."""
    return tuple(engine.stats[key] for key in GRAPH_STATS)


def check_graph_replays(tag, engine, marks, passes, prefills, verify=0):
    """Every decode step since ``marks`` was one replay of a captured
    decode graph and every verify pass (``verify``) one replay of a
    captured verify graph (nothing decoded or verified eagerly on the
    card), and nothing was captured: the graphs were captured by the
    warm-up before. ``prefills`` counts the eager passes: standalone
    prefill dispatches and chunk halves."""
    captures, replays, v_captures, v_replays = (
        engine.stats[key] - mark for key, mark in zip(GRAPH_STATS, marks))
    decode = passes - prefills - verify
    log(f'[{tag}] decode graphs: {replays} replays = {passes} forward passes - '
        f'{prefills} eager passes - {verify} verify passes; verify graphs: {v_replays} '
        f'replays; {captures + v_captures} captures during the run '
        f'({engine.stats["decode_graph_captures"]} + '
        f'{engine.stats["verify_graph_captures"]} at warm-up, '
        f'{engine.stats["decode_graph_capture_s"] + engine.stats["verify_graph_capture_s"]:.3f} s, '
        f'graph pools {engine.graph_pool_bytes / 2**20:.1f} MiB)')
    if replays != decode or replays + v_replays <= 0:
        fail(f'{tag}: {replays} decode graph replays for {decode} decode steps: a decode '
             'step ran eagerly on the card')
    if v_replays != verify:
        fail(f'{tag}: {v_replays} verify graph replays for {verify} verify passes: a '
             'verify pass ran eagerly on the card')
    verify_graphs = 2 if engine.config.draft_k else 0
    if (captures + v_captures != 0 or engine.stats['decode_graph_captures'] != 2
            or engine.stats['verify_graph_captures'] != verify_graphs):
        fail(f'{tag}: {captures + v_captures} captures in the run, '
             f'{engine.stats["decode_graph_captures"]} decode and '
             f'{engine.stats["verify_graph_captures"]} verify in all; expected those '
             'of the warm-up')
    return dict(decode_graph_replays=replays, verify_graph_replays=v_replays,
                decode_graph_capture_s=engine.stats['decode_graph_capture_s'],
                verify_graph_capture_s=engine.stats['verify_graph_capture_s'],
                graph_pool_mib=engine.graph_pool_bytes / 2**20)


def shut_down(torch, tag, engine):
    """Shut an engine down and print what stays allocated: a graph pool
    that outlived its engine would starve the next phase."""
    engine.shutdown()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f'[{tag}] after shutdown: {torch.cuda.memory_allocated() / 2**30:.3f} GiB '
        f'allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved')


def phase_serve(torch, tpa, card, cfg, tqm=None, quantization=None, *, config=None,
                tag=None, prompt_lens=(16, 1024), require_text=True):
    """Serve 16 prompts of ``prompt_lens`` tokens (evenly spaced) and 3
    chat completions; with ``quantization`` the generator quantizes its
    weights on the card and K2 (``tqm``) serves every projection.
    ``config`` is a ``TorchGeneratorConfig`` to serve instead of the
    default one over ``cfg`` (phase 13: a chat YAML's). With
    ``require_text`` every completion must decode to some text; without
    it a completion may decode to none (all its tokens special ones), and
    how many do is printed."""
    from distllm_tpu_torch.chat_server import ChatServer
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.generate.generators.torch_backend import (
        TorchGenerator,
        TorchGeneratorConfig,
    )

    tag = tag or (f'serve {quantization}' if quantization else 'serve')
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if config is None:
        config = TorchGeneratorConfig(
            model=cfg, temperature=0.0, max_tokens=64, block_size=BLOCK_SIZE,
            num_blocks=1024, max_num_seqs=8, max_model_len=2048, seed=0,
            device=DEVICE, quantization=quantization,
        )
    cfg = config.model
    generator = TorchGenerator(config)
    torch.cuda.synchronize()
    gib = torch.cuda.memory_allocated() / 2**30
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f'[{tag}] random init{" + quantization" if quantization else ""} '
        f'({cfg.num_layers} layers, hidden {cfg.hidden_size}, {cfg.dtype}) on '
        f'the card: {time.perf_counter() - t0:.3f} s, {gib:.2f} GiB allocated '
        f'(weights and KV pool), peak {peak_gib:.2f} GiB')
    engine = generator.engine
    log(f'[{tag}] warm-up at construction: {engine.stats["decode_graph_captures"]} '
        f'decode graphs captured in {engine.stats["decode_graph_capture_s"]:.3f} s, '
        f'graph pool {engine.graph_pool_bytes / 2**20:.1f} MiB')
    prompts = smoke_prompts(np.random.default_rng(1), 16, *prompt_lens)
    sampling = [SamplingParams(temperature=0.0, max_tokens=64)] * 14 + [
        SamplingParams(temperature=0.8, top_p=0.95, max_tokens=64, seed=s)
        for s in (7, 8)
    ]
    # The main path: counts to 0 just before, read just after.
    passes_before = engine.stats['forward_passes']
    prefills_before = engine.stats['prefill_dispatches']
    marks = graph_marks(engine)
    zero_k1_counts(tpa)
    if tqm is not None:
        tqm.int8_matmul.launches = 0
        tqm.int8_matmul.launches_by_route = dict.fromkeys(tqm.ROUTES, 0)
        tqm.int8_matmul_reference.launches = 0
    t0 = time.perf_counter()
    outputs = generator.generate(prompts, sampling)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    tele = dict(engine.telemetry)
    if len(outputs) != 16 or tele.get('generated_tokens') != 16 * 64:
        fail(f'generator produced {tele.get("generated_tokens")} tokens for '
             f'{len(outputs)} outputs; expected 16 x 64')
    if not all(isinstance(o, str) and (o or not require_text) for o in outputs):
        fail('empty generator output')
    if not require_text:
        log(f'[{tag}] {sum(1 for o in outputs if not o)} of {len(outputs)} completions '
            'decode to no text (every token a special one)')
    tok_s = tele['generated_tokens'] / wall_s
    log(f'[{tag}] generator: 16 prompts ({prompt_lens[0]}..{prompt_lens[1]} tokens), 1024 '
        f'new tokens in {wall_s:.3f} s = {tok_s:.1f} tok/s on {card}; telemetry '
        f'{json.dumps(tele)}')

    with ChatServer(generator, port=0) as server:
        results = [None] * 3

        def ask(i):
            results[i] = post_completion(server.port, i)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            fail('chat completion timed out')
        with urllib.request.urlopen(
            f'http://127.0.0.1:{server.port}/health', timeout=60
        ) as resp:
            health = json.loads(resp.read())
    for i, result in enumerate(results):
        if result is None:
            fail(f'chat completion {i} got no answer')
        status, body = result
        message = body['choices'][0]['message']
        if (status != 200 or body['object'] != 'chat.completion'
                or body['request_id'] != f'smoke-{i}' or message['role'] != 'assistant'
                or not isinstance(message['content'], str)
                or (require_text and not message['content'])):
            fail(f'chat completion {i}: status {status}, body {body}')
    if health.get('status') != 'ok':
        fail(f'/health answered {health}')
    log(f'[{tag}] chat_server: 3 completions answered 200, /health ok')

    passes = engine.stats['forward_passes'] - passes_before
    prefills = engine.stats['prefill_dispatches'] - prefills_before
    launches = tpa.ragged_paged_attention.launches
    by_route = dict(tpa.ragged_paged_attention.launches_by_route)
    by_head_dim = dict(tpa.ragged_paged_attention.launches_by_head_dim)
    plain = tpa.ragged_paged_attention_reference.launches
    log(f'[{tag}] ragged_paged_attention launches {launches} = '
        f'{cfg.num_layers} layers x {passes} forward passes ({prefills} '
        f'prefill dispatches); by route {json.dumps(by_route)}; by head dim '
        f'{json.dumps(by_head_dim)}; plain op launches {plain}')
    if launches <= 0 or launches != cfg.num_layers * passes:
        fail(f'kernel launches {launches} != {cfg.num_layers} x {passes}')
    if by_head_dim[cfg.head_size] != launches:
        fail(f'K1 launches by head dim {by_head_dim}: all {launches} belong at {cfg.head_size}')
    # Prefill spans (>= 16 tokens here, x the group of 4 or Gemma-2's 2)
    # fill tensor-core tiles, of 64 rows or more (the wgmma route) wherever
    # the span has them; decode rows (a group's rows per tile) take the
    # split-KV route.
    if (by_route['tensor_cores'] + by_route['wgmma'] != cfg.num_layers * prefills
            or by_route['wgmma'] <= 0
            or by_route['split_kv'] != cfg.num_layers * (passes - prefills)):
        fail(f'K1 routes {by_route}: expected {cfg.num_layers} x {prefills} '
             f'prefill passes on the tensor-core routes (the wgmma route among them) '
             f'and the rest on the split-KV route')
    if plain != 0:
        fail(f'the plain op ran {plain} times on the serving path')
    result = dict(tokens_per_s=tok_s, wall_s=wall_s, launches=launches,
                  launches_by_route=by_route, launches_by_head_dim=by_head_dim,
                  forward_passes=passes,
                  prefill_dispatches=prefills, telemetry=tele, gib=gib,
                  peak_gib=peak_gib,
                  **check_graph_replays(tag, engine, marks, passes, prefills))
    if tqm is not None:
        k2, k2_plain = tqm.int8_matmul.launches, tqm.int8_matmul_reference.launches
        k2_routes = dict(tqm.int8_matmul.launches_by_route)
        log(f'[{tag}] int8_matmul launches {k2} = 7 projections x '
            f'{cfg.num_layers} layers x {passes} forward passes; by route '
            f'{json.dumps(k2_routes)}; plain version launches {k2_plain}')
        if k2 <= 0 or k2 != 7 * cfg.num_layers * passes:
            fail(f'K2 launches {k2} != 7 x {cfg.num_layers} x {passes}')
        if k2_routes['tensor_cores'] != k2:
            fail(f'K2 routes {k2_routes}: every bf16 launch belongs on the tensor cores')
        if k2_plain != 0:
            fail(f'the plain int8 matmul ran {k2_plain} times on the serving path')
        result['k2_launches'] = k2
        result['k2_launches_by_route'] = k2_routes
    shut_down(torch, tag, engine)
    del generator, engine
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------- phase 6b
def kvq_workload(vocab_size):
    """The JAX package's ``gen_kvq`` stage workload (``bench.py``, full
    size): 64 greedy prompts of 32..192 tokens, every third behind a
    shared 32-token prefix, 16..96 new tokens each; numpy seed 0."""
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(1, vocab_size, size=32)]
    prompts = []
    for i, n in enumerate(rng.integers(32, 192, size=64)):
        tail = [int(t) for t in rng.integers(1, vocab_size, size=int(n))]
        prompts.append(shared + tail if i % 3 == 0 else tail)
    budgets = [int(n) for n in rng.integers(16, 96, size=64)]
    return prompts, budgets


def phase_serve_kv_int8(torch, tpa, card, cfg, params):
    """Serve the ``gen_kvq`` workload through two ``LLMEngine`` arms on the
    same bf16 weights (made on the card from seed 0): a bf16 KV pool and
    an int8 one (``EngineConfig(kv_cache_dtype='int8')``); block 16, 1024
    blocks, 32 slots, ``max_model_len`` 2048, 16-step decode windows, the
    prefix cache off (phase 6d serves the same workload with it on, phase
    6f with chunked prefill and mixed windows), so every prompt prefills
    whole. K1 must launch layers x forward passes in each
    arm, every int8-arm launch in the int8 mode (prefill on the tensor
    cores, decode on the split-KV route), its plain op never, and the int8
    pool must take under 0.51 of the bf16 pool's bytes. The greedy match
    fraction between the arms is recorded, not asserted."""
    from distllm_tpu_torch.generate.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    prompts, budgets = kvq_workload(cfg.vocab_size)
    sampling = [SamplingParams(temperature=0.0, max_tokens=n) for n in budgets]
    arms = {}
    for kv in ('bf16', 'int8'):
        torch.cuda.reset_peak_memory_stats()
        engine = LLMEngine(cfg, params, None, EngineConfig(
            block_size=BLOCK_SIZE, num_blocks=1024, max_num_seqs=32,
            max_model_len=2048, decode_steps=16, kv_cache_dtype=kv,
        ), device=DEVICE)
        # The warm run's first window warms the engine up (captures).
        engine.generate_ids(prompts[:2], SamplingParams(temperature=0.0, max_tokens=2))
        marks = graph_marks(engine)
        tpa.ragged_paged_attention.launches = 0
        tpa.ragged_paged_attention.launches_by_route = dict.fromkeys(tpa.ROUTES, 0)
        tpa.ragged_paged_attention.launches_by_kv = dict.fromkeys(tpa.KV_MODES, 0)
        tpa.ragged_paged_attention_reference.launches = 0
        t0 = time.perf_counter()
        tokens = engine.generate_ids(prompts, sampling)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        tele = dict(engine.telemetry)
        arm = dict(
            tokens=tokens, tokens_per_s=tele['generated_tokens'] / wall_s, wall_s=wall_s,
            kv_cache_dtype=tele['kv_cache_dtype'], kv_pool_bytes=engine.kv.hbm_bytes,
            kv_pool_gib=engine.kv.hbm_bytes / 2**30,
            gib=torch.cuda.memory_allocated() / 2**30,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            forward_passes=tele['forward_passes'],
            prefill_dispatches=tele['prefill_dispatches'],
            launches=tpa.ragged_paged_attention.launches,
            launches_by_route=dict(tpa.ragged_paged_attention.launches_by_route),
            launches_by_kv=dict(tpa.ragged_paged_attention.launches_by_kv),
            plain=tpa.ragged_paged_attention_reference.launches,
        )
        arm.update(check_graph_replays(
            f'serve kv {kv}', engine, marks, arm['forward_passes'], arm['prefill_dispatches']))
        shut_down(torch, f'serve kv {kv}', engine)
        del engine
        torch.cuda.empty_cache()
        if tele['generated_tokens'] != sum(budgets) or [len(t) for t in tokens] != budgets:
            fail(f'serve int8 KV ({kv}): {tele["generated_tokens"]} tokens, expected '
                 f'{sum(budgets)}')
        log(f'[serve kv {kv}] 64 prompts (32..224 tokens), {sum(budgets)} new tokens in '
            f'{wall_s:.3f} s = {arm["tokens_per_s"]:.1f} tok/s on {card}; KV pool '
            f'{arm["kv_pool_gib"]:.4f} GiB ({arm["kv_pool_bytes"]} bytes, '
            f'kv_cache_dtype {arm["kv_cache_dtype"]}); {arm["gib"]:.2f} GiB allocated, '
            f'peak {arm["peak_gib"]:.2f} GiB; K1 launches {arm["launches"]} = '
            f'{cfg.num_layers} layers x {arm["forward_passes"]} passes '
            f'({arm["prefill_dispatches"]} prefill dispatches); by route '
            f'{json.dumps(arm["launches_by_route"])}, by KV mode '
            f'{json.dumps(arm["launches_by_kv"])}; plain op {arm["plain"]}')
        passes, prefills = arm['forward_passes'], arm['prefill_dispatches']
        by_route = arm['launches_by_route']
        if arm['launches'] <= 0 or arm['launches'] != cfg.num_layers * passes:
            fail(f'serve int8 KV ({kv}): K1 launches {arm["launches"]} != '
                 f'{cfg.num_layers} x {passes}')
        # An int8 pool's prefill stays on route 1; a bf16 pool's takes the
        # wgmma route where its tiles have 64 rows.
        prefill_routes = by_route['tensor_cores'] + by_route['wgmma']
        if (prefill_routes != cfg.num_layers * prefills
                or (by_route['wgmma'] > 0) != (kv != 'int8')
                or by_route['split_kv'] != cfg.num_layers * (passes - prefills)):
            fail(f'serve int8 KV ({kv}): K1 routes {by_route}: expected prefill on '
                 'the tensor-core routes (int8: route 1 only) and decode on the '
                 'split-KV route')
        mode = 'int8' if kv == 'int8' else 'model'
        if arm['launches_by_kv'][mode] != arm['launches']:
            fail(f'serve int8 KV ({kv}): K1 KV modes {arm["launches_by_kv"]}: every '
                 f'launch belongs in the {mode} mode')
        if arm['plain'] != 0:
            fail(f'serve int8 KV ({kv}): the plain op ran {arm["plain"]} times')
        arms[kv] = arm
    torch.cuda.empty_cache()
    bf16, q8 = arms['bf16'], arms['int8']
    if (bf16['kv_cache_dtype'], q8['kv_cache_dtype']) != ('bfloat16', 'int8'):
        fail(f'telemetry kv_cache_dtype {bf16["kv_cache_dtype"]} / {q8["kv_cache_dtype"]}')
    ratio = q8['kv_pool_bytes'] / bf16['kv_pool_bytes']
    # The int8 blocks (codes and scales) the bf16 pool's bytes would hold.
    capacity_blocks = int(bf16['kv_pool_bytes'] // (q8['kv_pool_bytes'] / 1024))
    matched = total = 0
    for a, b in zip(bf16['tokens'], q8['tokens']):
        total += max(len(a), len(b))
        matched += sum(1 for x, y in zip(a, b) if x == y)
    match = matched / total
    # The first token comes from the prefill pass alone: where it differs,
    # the streams part before any decode step.
    first = sum(a[:1] == b[:1] for a, b in zip(bf16['tokens'], q8['tokens'])) / len(prompts)
    log(f'[serve kv int8] int8 vs bf16 pool bytes {ratio:.4f}; the bf16 pool\'s bytes '
        f'hold {capacity_blocks} int8 blocks (1024 bf16); greedy match {match:.4f} '
        f'({matched}/{total}), first tokens matching {first:.4f} (recorded, not asserted)')
    if not ratio < 0.51:
        fail(f'int8 KV pool is {ratio:.4f} of the bf16 pool, expected under 0.51')
    keep = ('tokens_per_s', 'wall_s', 'kv_cache_dtype', 'kv_pool_bytes', 'kv_pool_gib',
            'gib', 'peak_gib', 'forward_passes', 'prefill_dispatches', 'launches',
            'launches_by_route', 'launches_by_kv', 'decode_graph_replays',
            'decode_graph_capture_s', 'graph_pool_mib')
    return dict(bf16={k: bf16[k] for k in keep}, int8={k: q8[k] for k in keep},
                pool_bytes_ratio=ratio, int8_capacity_blocks=capacity_blocks,
                greedy_match=match, first_token_match=first), bf16['tokens']


# ------------------------------------------------------------- phase 6c
GRAPH_ROWS, GRAPH_STEPS, GRAPH_CONTEXT = 8, 8, 1024


def phase_graph_window(torch, tpa, card, cfg, params):
    """One decode window at full width through the engine's captured
    graphs and through the eager ``mistral.decode_loop``: 8 rows of about
    1024 keys (a pool of N(0, 1) K/V made on the card, seed 0), 8 steps,
    greedy and then sampled rows. Tokens and every pool byte outside the
    trash block must be identical; wall ms a step of each is timed over 3
    windows from the same pool (a window rewrites the same slots with the
    same values, so it can be repeated)."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine
    from distllm_tpu_torch.models import mistral

    engine = LLMEngine(cfg, params, None, EngineConfig(
        block_size=BLOCK_SIZE, num_blocks=1024, max_num_seqs=GRAPH_ROWS,
        max_model_len=2048, decode_steps=GRAPH_STEPS,
    ), device=DEVICE)
    engine.warmup()
    capture_s = engine.stats['decode_graph_capture_s']
    pool_mib = engine.graph_pool_bytes / 2**20
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for plane in (engine.kv.k, engine.kv.v):
        plane.copy_(torch.randn(plane.shape, generator=gen, device=DEVICE,
                                dtype=torch.float32).to(plane.dtype))
    del plane
    rng = np.random.default_rng(6)
    b, mb = GRAPH_ROWS, engine.max_blocks_per_seq
    pos = (GRAPH_CONTEXT - 1 - rng.integers(0, 16, size=b)).astype(np.int32)
    pages = -(-(pos + GRAPH_STEPS + 1) // BLOCK_SIZE)
    bt = np.zeros((b, mb), np.int32)
    free = rng.permutation(np.arange(1, 1024))
    at = 0
    for row, n in enumerate(pages):
        bt[row, :n] = free[at:at + n]
        at += n
    ids = rng.integers(4, cfg.vocab_size, size=b).astype(np.int32)
    steps = np.full((b,), GRAPH_STEPS, np.int32)
    steps[-1] = GRAPH_STEPS // 2  # one row's budget ends mid-window
    inputs = {
        'greedy': (np.zeros(b, np.float32), np.ones(b, np.float32)),
        'sampled': (np.full(b, 0.8, np.float32), np.full(b, 0.95, np.float32)),
    }
    results = {}
    for kind, (temp, top_p) in inputs.items():
        seeds = rng.integers(0, 2**32, size=b).astype(np.int64)
        host = (ids, pos, pos + 1, bt, steps, temp, top_p, np.zeros(b, np.float32),
                np.zeros(b, np.int32), seeds)
        eager_pool = [engine.kv.k.clone(), engine.kv.v.clone()]
        graph_ms, eager_ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine._decode.load(*host)
            tokens = engine._decode.run(GRAPH_STEPS, all_greedy=kind == 'greedy')
            graph_tokens = tokens.cpu()
            graph_ms.append((time.perf_counter() - t0) * 1e3 / GRAPH_STEPS)
        dev = [torch.from_numpy(np.asarray(x)).to(DEVICE) for x in host]
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager = mistral.decode_loop(
                engine.params, engine.model_cfg, dev[0], dev[1], *eager_pool,
                dev[3], dev[2], *dev[4:], num_steps=GRAPH_STEPS,
                max_table_positions=engine.config.max_model_len,
                all_greedy=kind == 'greedy',
            )[0]
            eager_tokens = eager.cpu()
            eager_ms.append((time.perf_counter() - t0) * 1e3 / GRAPH_STEPS)
        same_tokens = all(
            torch.equal(graph_tokens[:n, row], eager_tokens[:n, row])
            for row, n in enumerate(steps)
        )
        same_pool = all(
            torch.equal(card[:, 1:], ref[:, 1:])
            for card, ref in zip((engine.kv.k, engine.kv.v), eager_pool)
        )
        diff = max(
            float((card[:, 1:].float() - ref[:, 1:].float()).abs().max())
            for card, ref in zip((engine.kv.k, engine.kv.v), eager_pool)
        )
        del eager_pool
        log(f'[graph window {kind}] {cfg.num_layers} layers, hidden {cfg.hidden_size}, '
            f'{cfg.dtype}, {b} rows of {int(pos.min()) + 1}..'
            f'{int(pos.max()) + 1} keys, {GRAPH_STEPS} steps on {card}: graph '
            f'{", ".join(f"{x:.3f}" for x in graph_ms)} ms a step, eager '
            f'{", ".join(f"{x:.3f}" for x in eager_ms)} ms a step; tokens identical='
            f'{same_tokens}, pool bytes identical={same_pool} (max |diff| {diff})')
        if not (same_tokens and same_pool):
            fail(f'graph window ({kind}): replayed graph and eager decode_loop differ '
                 f'(tokens identical={same_tokens}, pool identical={same_pool})')
        results[kind] = dict(graph_ms_per_step=graph_ms, eager_ms_per_step=eager_ms)
    log(f'[graph window] capture {capture_s:.3f} s for 2 graphs, graph pool '
        f'{pool_mib:.1f} MiB')
    shut_down(torch, 'graph window', engine)
    del engine
    return dict(results, capture_s=capture_s, graph_pool_mib=pool_mib)


# ------------------------------------------------------------- phase 6d
def instrument_prefill(torch, engine):
    """Time each of the engine's prefill dispatches (host clock and CUDA
    events around the dispatch and its sampled tokens' fetch) and keep its
    padded span width, which decides K1's route."""
    records = []
    dispatch = engine._dispatch_prefill_paged

    def timed(spans, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = dispatch(spans, **kwargs)
        end.record()
        end.synchronize()
        records.append(dict(
            width=max(n for _, _, n in spans), rows=len(spans),
            tokens=sum(n for _, _, n in spans),
            wall_ms=(time.perf_counter() - t0) * 1e3, event_ms=start.elapsed_time(end),
        ))
        return out

    engine._dispatch_prefill_paged = timed
    return records


def zero_k1_counts(tpa):
    tpa.ragged_paged_attention.launches = 0
    tpa.ragged_paged_attention.launches_by_route = dict.fromkeys(tpa.ROUTES, 0)
    tpa.ragged_paged_attention.launches_by_kv = dict.fromkeys(tpa.KV_MODES, 0)
    tpa.ragged_paged_attention.launches_by_head_dim = dict.fromkeys(tpa.KERNEL_HEAD_DIMS, 0)
    tpa.ragged_paged_attention_reference.launches = 0


def check_k1_routes(torch, tpa, tag, cfg, engine, marks, passes, prefills, widths, mode,
                    verify=0, span=1):
    """K1 launched layers x forward passes, each on the route
    ``kernel_route`` names for its dispatch (an eager prefill or chunk
    half by its padded span width ``widths``, a verify pass by its
    ``span``, every decode step on the split-KV route), all in ``mode``;
    its plain op never; every decode step and verify pass a graph
    replay."""
    kernel = tpa.ragged_paged_attention
    group = NUM_HEADS // NUM_KV_HEADS
    want = dict.fromkeys(tpa.ROUTES, 0)
    for width in widths:
        want[tpa.kernel_route(torch.bfloat16, width, group, kv_mode=mode)] += cfg.num_layers
    want[tpa.kernel_route(torch.bfloat16, span, group, kv_mode=mode)] += cfg.num_layers * verify
    want['split_kv'] += cfg.num_layers * (passes - prefills - verify)
    got = dict(kernel.launches_by_route)
    log(f'[{tag}] K1 launches {kernel.launches} = {cfg.num_layers} layers x {passes} passes '
        f'({prefills} prefill dispatches); by route {json.dumps(got)} (expected '
        f'{json.dumps(want)}); by KV mode {json.dumps(kernel.launches_by_kv)}; plain op '
        f'{tpa.ragged_paged_attention_reference.launches}')
    if kernel.launches <= 0 or kernel.launches != cfg.num_layers * passes or got != want:
        fail(f'{tag}: K1 launches {kernel.launches}, routes {got}; expected '
             f'{cfg.num_layers} x {passes} on {want}')
    if kernel.launches_by_kv[mode] != kernel.launches:
        fail(f'{tag}: K1 KV modes {kernel.launches_by_kv}: every launch belongs in {mode}')
    if tpa.ragged_paged_attention_reference.launches != 0:
        fail(f'{tag}: the plain op ran on the serving path')
    return check_graph_replays(tag, engine, marks, passes, prefills, verify)


def greedy_match(a_runs, b_runs):
    matched = total = 0
    for a, b in zip(a_runs, b_runs):
        total += max(len(a), len(b))
        matched += sum(1 for x, y in zip(a, b) if x == y)
    return matched / total


RAG_PREFIX, RAG_PROMPTS, RAG_NEW = 1024, 16, 32


def rag_workload(vocab_size):
    """A RAG-style set (numpy seed 7): a 1024-token system prefix (64 full
    blocks), 16 prompts that share it with distinct tails of 16..64 tokens,
    and one exact repeat of the prefix (block-aligned: copy-on-write)."""
    rng = np.random.default_rng(7)
    prefix = [int(t) for t in rng.integers(4, vocab_size, size=RAG_PREFIX)]
    tails = [[int(t) for t in rng.integers(4, vocab_size, size=int(n))]
             for n in np.linspace(16, 64, RAG_PROMPTS).astype(int)]
    return prefix, [prefix + tail for tail in tails] + [list(prefix)]


def serve_in_order(engine, first, rest, sampling_first, sampling_rest):
    """``first`` runs to completion (its blocks enter the cache after its
    prefill), then ``rest`` in one call: a request acquires its match when
    it is added, so prompts added beside the first would all miss."""
    return engine.generate_ids(first, sampling_first) + engine.generate_ids(rest, sampling_rest)


def phase_serve_prefix_cache(torch, tpa, card, cfg, params, kvq_off_tokens):
    """Full-width Mistral-7B bf16 with the prefix cache: (a) phase 6b's
    ``gen_kvq`` workload, the first prompt behind the shared 32-token
    prefix served first, then the other 63; (b) the RAG set, its prefix
    request first. Arms: the cache off, on over a bf16 pool, on over an
    int8 pool. Per arm: hit share, prefill wall and CUDA-event ms per dispatch,
    tokens/s, the greedy match against the cache-off arm (recorded: in
    bf16 it is not identity). Every decode step is a graph replay and K1
    launches on the routes ``kernel_route`` names, its plain op never."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams

    kvq_prompts, budgets = kvq_workload(cfg.vocab_size)
    kvq_sampling = [SamplingParams(temperature=0.0, max_tokens=n) for n in budgets]
    prefix, rag = rag_workload(cfg.vocab_size)
    rag_sampling = SamplingParams(temperature=0.0, max_tokens=RAG_NEW)
    arms = (('off', 'bf16', False), ('on', 'bf16', True), ('on', 'int8', True))
    results = {}
    for cache, kv, enabled in arms:
        tag = f'prefix cache {cache} kv {kv}'
        engine = LLMEngine(cfg, params, None, EngineConfig(
            block_size=BLOCK_SIZE, num_blocks=1024, max_num_seqs=32, max_model_len=2048,
            decode_steps=16, kv_cache_dtype=kv, enable_prefix_cache=enabled,
        ), device=DEVICE)
        engine.warmup()
        arm = {}
        for name, first, rest, s_first, s_rest in (
            ('kvq', kvq_prompts[:1], kvq_prompts[1:], kvq_sampling[:1], kvq_sampling[1:]),
            ('rag', [prefix], rag, rag_sampling, rag_sampling),
        ):
            records = instrument_prefill(torch, engine)
            marks = graph_marks(engine)
            passes0 = engine.stats['forward_passes']
            prefills0 = engine.stats['prefill_dispatches']
            stats0 = dict(engine.stats)
            zero_k1_counts(tpa)
            t0 = time.perf_counter()
            tokens = serve_in_order(engine, first, rest, s_first, s_rest)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            del engine._dispatch_prefill_paged  # the instrumented dispatch
            run = stats_delta(engine, stats0)
            passes = engine.stats['forward_passes'] - passes0
            prefills = engine.stats['prefill_dispatches'] - prefills0
            mode = 'int8' if kv == 'int8' else 'model'
            graphs = check_k1_routes(torch, tpa, f'{tag} {name}', cfg, engine, marks, passes, prefills,
                                     [r['width'] for r in records], mode)
            lookup = run.get('prefix_lookup_tokens', 0)
            hits = run.get('prefix_hit_tokens', 0)
            res = dict(
                hit_share=hits / lookup if lookup else 0.0, hit_tokens=hits,
                lookup_tokens=lookup, cow_copies=run.get('prefix_cow_copies', 0),
                evicted_blocks=run.get('prefix_evicted_blocks', 0),
                generated_tokens=run['generated_tokens'],
                tokens_per_s=run['generated_tokens'] / wall_s, wall_s=wall_s,
                prefill_dispatches=prefills, forward_passes=passes,
                prefill_tokens=sum(r['tokens'] for r in records),
                prefill_wall_ms=[round(r['wall_ms'], 3) for r in records],
                prefill_event_ms=[round(r['event_ms'], 3) for r in records],
                prefill_widths=[r['width'] for r in records],
                prefill_event_ms_sum=sum(r['event_ms'] for r in records),
                prefill_wall_ms_sum=sum(r['wall_ms'] for r in records),
                tokens=tokens, **graphs,
            )
            expected = sum(budgets) if name == 'kvq' else RAG_NEW * (len(rag) + 1)
            if res['generated_tokens'] != expected:
                fail(f'{tag} {name}: {res["generated_tokens"]} tokens, expected {expected}')
            arm[name] = res
        shut_down(torch, tag, engine)
        del engine
        results[f'{cache}_{kv}'] = arm
    base = results['off_bf16']
    for key, arm in results.items():
        for name, res in arm.items():
            res['greedy_match_vs_off'] = greedy_match(base[name]['tokens'], res['tokens'])
            log(f'[prefix cache {key} {name}] hit share {res["hit_share"]:.4f} '
                f'({res["hit_tokens"]}/{res["lookup_tokens"]} prompt tokens, '
                f'{res["cow_copies"]} copy-on-write); {res["prefill_dispatches"]} prefill '
                f'dispatches of {res["prefill_tokens"]} tokens: wall '
                f'{res["prefill_wall_ms_sum"]:.3f} ms, CUDA-event span {res["prefill_event_ms_sum"]:.3f} '
                f'ms (per dispatch wall {res["prefill_wall_ms"]}, event span '
                f'{res["prefill_event_ms"]}, widths {res["prefill_widths"]}); '
                f'{res["generated_tokens"]} new tokens at {res["tokens_per_s"]:.1f} tok/s on '
                f'{card}; greedy match vs cache off {res["greedy_match_vs_off"]:.4f}')
    kvq_vs_6b = greedy_match(kvq_off_tokens, base['kvq']['tokens'])
    log(f'[prefix cache] cache-off kvq arm vs phase 6b bf16 arm greedy match {kvq_vs_6b:.4f}')
    rag_on = results['on_bf16']['rag']
    if not rag_on['hit_share'] > 0.85 or rag_on['cow_copies'] != 1:
        fail(f'prefix cache RAG set: hit share {rag_on["hit_share"]:.4f} (expected > 0.85), '
             f'{rag_on["cow_copies"]} copy-on-write (expected 1)')
    if results['on_int8']['rag']['hit_share'] != rag_on['hit_share']:
        fail('prefix cache RAG set: the int8 pool hit other tokens than the bf16 pool')
    for arm in results.values():
        for res in arm.values():
            res.pop('tokens')
    return results


# ------------------------------------------------------------- phase 6e
# The pool of phase 6e: 100 blocks (99 usable), 2 MiB a bf16 block at 7B
# width (32 layers x 16 x 8 x 128 x 2 x 2 bytes): one 1024-token prefix and
# its request's tail fit, two do not.
TIER_BLOCKS = 100


def phase_kv_tiers(torch, tpa, card, cfg, params, tmp: Path):
    """The host and disk tiers at full width (bf16 weights, a pool too
    small for two RAG prefixes): the RAG prefix request, then a second
    1024-token prefix request whose admission evicts the first prefix's
    blocks (spilled to a 1 GiB host tier writing through to a disk tier
    under ``tmp``), then the RAG prompts, which promote them back. Over a
    bf16 and an int8 pool: spills and promotions > 0, no payload mismatch
    or promotion failure, every promoted block's pool bytes (codes and
    scales) bitwise the bytes it had before its spill, the tier's copies
    too; then a fresh engine on the same directory promotes from disk (a
    warm restart). Spill and promotion host ms per MiB are printed."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.generate.engine.kv_cache import block_digests

    prefix, rag = rag_workload(cfg.vocab_size)
    other = [int(t) for t in np.random.default_rng(8).integers(4, cfg.vocab_size, size=RAG_PREFIX)]
    sampling = SamplingParams(temperature=0.0, max_tokens=RAG_NEW)
    digests = block_digests(prefix, BLOCK_SIZE)
    results = {}
    for kv in ('bf16', 'int8'):
        tag = f'kv tiers {kv}'
        tier_dir = tmp / f'tier_{kv}'

        def engine_on_dir():
            engine = LLMEngine(cfg, params, None, EngineConfig(
                block_size=BLOCK_SIZE, num_blocks=TIER_BLOCKS, max_num_seqs=4,
                max_model_len=2048, decode_steps=16, kv_cache_dtype=kv,
                enable_prefix_cache=True, host_kv_tier_bytes=1 << 30,
                disk_kv_tier_dir=str(tier_dir),
            ), device=DEVICE)
            engine.warmup()
            return engine

        engine = engine_on_dir()
        planes = engine._pool_planes()
        zero_k1_counts(tpa)
        marks = graph_marks(engine)
        passes0 = engine.stats['forward_passes']
        prefills0 = engine.stats['prefill_dispatches']
        records = instrument_prefill(torch, engine)
        t0 = time.perf_counter()
        engine.generate_ids([prefix], sampling)
        blocks = engine.prefix_cache.match(digests)
        snapshot = {d: [p[:, b].clone() for p in planes] for d, b in zip(digests, blocks)}
        engine.generate_ids([other], sampling)  # evicts and spills the prefix
        spilled = engine.tier_summary()
        # The prefix blocks the tier holds now (the first ones: LRU) are
        # the ones the RAG request promotes; their tier copies are bitwise
        # their pool bytes.
        in_tier = []
        for digest, arrays in snapshot.items():
            entry = engine.kv_tier.get(digest)
            if entry is not None:
                in_tier.append(digest)
                if not all(torch.equal(e, a.cpu()) for e, a in zip(entry, arrays)):
                    fail(f'{tag}: the tier copy of a spilled block differs from its pool bytes')
        out = engine.generate_ids(rag[:1], sampling)  # promotes them back
        engine.generate_ids(rag[1:4], sampling)  # device hits on the whole prefix
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        del engine._dispatch_prefill_paged
        summary = engine.tier_summary()
        passes = engine.stats['forward_passes'] - passes0
        prefills = engine.stats['prefill_dispatches'] - prefills0
        check_k1_routes(torch, tpa, tag, cfg, engine, marks, passes, prefills,
                        [r['width'] for r in records], 'int8' if kv == 'int8' else 'model')
        cached = dict(zip(digests, engine.prefix_cache.match(digests)))
        same = sum(
            digest in cached and all(
                torch.equal(p[:, cached[digest]], a) for p, a in zip(planes, snapshot[digest])
            )
            for digest in in_tier
        )
        del snapshot
        mib = 2**20
        res = dict(
            spills=summary['spills'], spilled_blocks=summary['spilled_blocks'],
            promotions=summary['promotions'], promoted_blocks=summary['promoted_blocks'],
            payload_mismatches=summary['payload_mismatches'],
            promotion_failures=summary['promotion_failures'],
            spilled_before_rag=spilled['spilled_blocks'], prefix_blocks_in_tier=len(in_tier),
            prefix_blocks_cached_after=len(cached), promoted_prefix_blocks_bitwise=same,
            spill_ms_per_mib=summary['spill_s'] * 1e3 / (summary['spilled_bytes'] / mib),
            promote_host_ms_per_mib=(summary['promote_host_s'] * 1e3
                                     / max(summary['promoted_bytes'] / mib, 1e-9)),
            promote_copy_ms_per_mib=(summary['promote_copy_s'] * 1e3
                                     / max(summary['promoted_bytes'] / mib, 1e-9)),
            promoted_bytes=summary['promoted_bytes'], disk_blocks=summary['disk_blocks'],
            disk_bytes=summary['disk_bytes'], wall_s=wall_s,
            prefill_event_ms=[round(r['event_ms'], 3) for r in records],
        )
        shut_down(torch, tag, engine)
        del engine, planes
        # The warm restart: a fresh engine, a fresh host tier, the same disk.
        engine = engine_on_dir()
        restart = engine.generate_ids(rag[:1], sampling)
        res.update(restart_promotions=engine.stats['tier_promotions'],
                   restart_promoted_blocks=engine.stats['tier_promoted_blocks'],
                   restart_disk_reads=engine.kv_tier.disk.reads,
                   restart_tokens_match=restart[0] == out[0])
        shut_down(torch, f'{tag} restart', engine)
        del engine
        log(f'[{tag}] {json.dumps(res)} on {card}')
        if not (res['spills'] > 0 and res['promotions'] > 0 and res['promoted_blocks'] > 0):
            fail(f'{tag}: spills {res["spills"]}, promotions {res["promotions"]}')
        if res['payload_mismatches'] or res['promotion_failures']:
            fail(f'{tag}: {res["payload_mismatches"]} payload mismatches, '
                 f'{res["promotion_failures"]} promotion failures')
        if not in_tier or same != len(in_tier) or len(cached) != len(digests):
            fail(f'{tag}: {same} of {len(in_tier)} promoted prefix blocks bitwise their '
                 f'spilled bytes ({len(cached)} of {len(digests)} prefix blocks cached)')
        if not (res['restart_promotions'] > 0 and res['restart_disk_reads'] > 0):
            fail(f'{tag}: the warm restart promoted {res["restart_promotions"]} times '
                 f'({res["restart_disk_reads"]} disk reads)')
        results[kv] = res
    return results


# ------------------------------------------------------------ phases 8-9
# ---------------------------------------------------------- phases 6f-6g
def instrument_windows(torch, engine):
    """Record each eager pass's padded width and host ms (standalone
    prefill dispatches and chunk halves, without a device sync: the
    engine's own timing stays as it is) and each window's host ms from
    its dispatch to its processing (planning, drafts, staging, the replays
    or the verify replay, the token fetch and emission; in the pipelined
    loop the next window's dispatch falls in between), and the device ms of
    each verify replay (CUDA events; the window fetches right after, so
    waiting on them adds no sync)."""
    from distllm_tpu_torch.models.tokenizer import pick_bucket

    rec = dict(prefill=[], chunk=[], window=[], verify_event=[])
    dispatch, chunk_half = engine._dispatch_prefill_paged, engine._run_chunk_half
    dispatch_window, process_window = engine._dispatch_window, engine._process_window

    def timed_prefill(spans, **kwargs):
        t0 = time.perf_counter()
        out = dispatch(spans, **kwargs)
        rec['prefill'].append(dict(width=max(n for _, _, n in spans),
                                   wall_ms=(time.perf_counter() - t0) * 1e3))
        return out

    def timed_chunk(plan):
        t0 = time.perf_counter()
        out = chunk_half(plan)
        rec['chunk'].append(dict(
            width=pick_bucket(max(n for _, _, n in plan), engine.prefill_buckets),
            rows=len(plan), tokens=sum(n for _, _, n in plan),
            wall_ms=(time.perf_counter() - t0) * 1e3))
        return out

    def timed_window():
        t0 = time.perf_counter()
        window = dispatch_window()
        if window is not None:
            window['_t0'] = t0
        return window

    def timed_process(window):
        out = process_window(window)
        if '_t0' in window:  # a window, not a deferred prefill's fetch record
            rec['window'].append(dict(
                spec=bool(window.get('spec')), chunk_rows=len(window['chunk_plan']),
                steps=0 if window['tokens'] is None or window.get('spec')
                else int(window['tokens'].shape[0]),
                wall_ms=(time.perf_counter() - window['_t0']) * 1e3))
        return out

    engine._dispatch_prefill_paged = timed_prefill
    engine._run_chunk_half = timed_chunk
    engine._dispatch_window = timed_window
    engine._process_window = timed_process
    if engine._verify is not None:
        run = engine._verify.run

        def timed_verify(all_greedy):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run(all_greedy)
            end.record()
            end.synchronize()
            rec['verify_event'].append(start.elapsed_time(end))
            return out

        engine._verify.run = timed_verify
    return rec


def flip_report(torch, cfg, params, prompts, a_runs, b_runs, limit=16):
    """The first position where each pair of greedy streams parts, with
    the plain op's logit gap between the two tokens there (bf16 pool, one
    fresh paged prefill of the shared history; the first ``limit`` flips):
    how near a tie each flip was."""
    flips = []
    for i, (a, b) in enumerate(zip(a_runs, b_runs)):
        at = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if at is None or len(flips) >= limit:
            continue
        logits = plain_logits(torch, cfg, params, prompts[i] + b[:at], torch.bfloat16)
        flips.append(dict(prompt=i, position=at, a=a[at], b=b[at],
                          logit_gap=float((logits[b[at]] - logits[a[at]]).abs())))
    return flips


def median(values):
    return float(np.median(values)) if len(values) else None


def zero_k2_counts(tqm):
    tqm.int8_matmul.launches = 0
    tqm.int8_matmul.launches_by_route = dict.fromkeys(tqm.ROUTES, 0)
    tqm.int8_matmul_reference.launches = 0


class ProposalDrafter:
    """A drafter that proposes given tokens, indexed by absolute history
    position (the JAX tests' stub drafter): a stand-in for a model that
    copies, which random weights are not."""

    def __init__(self, proposals):
        self.proposals = list(proposals)

    def draft(self, history, k):
        return self.proposals[len(history):len(history) + k]


def serve_arm(torch, tpa, tag, cfg, params, engine_kw, prompts, sampling, tqm=None,
              first=None, proposals=None, k2_per_layer=7):
    """One ``LLMEngine`` arm over ``prompts`` (warmed up first, so every
    capture happens before the run; ``first``, ``(prompts, sampling)``,
    served before the timed run, untimed; ``proposals``, one token list
    per prompt, replace each request's drafter by a
    :class:`ProposalDrafter` of them): tokens/s, window and pass times, and
    the checks every serving arm owes — K1 launches layers x passes on
    the routes ``kernel_route`` names for each pass, its plain op never,
    every decode step and verify pass a graph replay; with ``tqm`` (int8
    weights) K2 launches ``k2_per_layer`` (7; Mixtral's 4: q / k / v / o)
    x layers x passes on the tensor cores."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine

    engine = LLMEngine(cfg, params, None, EngineConfig(**engine_kw), device=DEVICE)
    engine.warmup()
    if first is not None:
        engine.generate_ids(*first)
    if proposals is not None:
        queue, add = list(proposals), engine.add_request

        def add_with_proposals(prompt, sp=None):
            rid = add(prompt, sp)
            engine._requests[rid].drafter = ProposalDrafter([0] * len(prompt) + queue.pop(0))
            return rid

        engine.add_request = add_with_proposals
    rec = instrument_windows(torch, engine)
    marks = graph_marks(engine)
    stats0 = dict(engine.stats)
    zero_k1_counts(tpa)
    if tqm is not None:
        zero_k2_counts(tqm)
    t0 = time.perf_counter()
    tokens = engine.generate_ids(prompts, sampling)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    run = stats_delta(engine, stats0)
    passes, verify = run['forward_passes'], run.get('spec_windows', 0)
    eager = run.get('prefill_dispatches', 0) + run.get('mixed_windows', 0) + run.get(
        'spec_chunk_windows', 0)
    widths = [r['width'] for r in rec['prefill'] + rec['chunk']]
    if len(widths) != eager:
        fail(f'{tag}: {len(widths)} eager passes recorded, {eager} counted')
    graphs = check_k1_routes(torch, tpa, tag, cfg, engine, marks, passes, eager, widths,
                             'model', verify=verify, span=1 + engine.config.draft_k)
    if run['generated_tokens'] != sum(sp.max_tokens for sp in sampling):
        fail(f'{tag}: {run["generated_tokens"]} tokens, expected '
             f'{sum(sp.max_tokens for sp in sampling)}')
    drafted, accepted = run.get('spec_draft_tokens', 0), run.get('spec_accepted_tokens', 0)
    windows = rec['window']
    arm = dict(
        tokens=tokens, tokens_per_s=run['generated_tokens'] / wall_s, wall_s=wall_s,
        generated_tokens=run['generated_tokens'], forward_passes=passes,
        prefill_dispatches=run.get('prefill_dispatches', 0),
        prefill_chunks=run.get('prefill_chunks', 0),
        mixed_windows=run.get('mixed_windows', 0),
        mixed_prefill_tokens=run.get('mixed_prefill_tokens', 0),
        spec_windows=verify, spec_chunk_windows=run.get('spec_chunk_windows', 0),
        spec_draft_tokens=drafted, spec_accepted_tokens=accepted,
        spec_sampled_rows=run.get('spec_sampled_rows', 0),
        spec_resampled_tokens=run.get('spec_resampled_tokens', 0),
        accept_rate=accepted / drafted if drafted else None,
        prefill_host_ms=sum(r['wall_ms'] for r in rec['prefill']),
        chunk_host_ms=sum(r['wall_ms'] for r in rec['chunk']),
        chunk_halves=len(rec['chunk']),
        chunk_widths=sorted({r['width'] for r in rec['chunk']}),
        prefill_widths=sorted({r['width'] for r in rec['prefill']}),
        windows=len(windows),
        verify_window_wall_ms=median([w['wall_ms'] for w in windows
                                      if w['spec'] and not w['chunk_rows']]),
        verify_replay_event_ms=median(rec['verify_event']),
        decode_window_wall_ms_per_step=median([
            w['wall_ms'] / w['steps'] for w in windows
            if not w['spec'] and w['steps'] and not w['chunk_rows']]),
        k1_launches=tpa.ragged_paged_attention.launches,
        k1_launches_by_route=dict(tpa.ragged_paged_attention.launches_by_route),
        **graphs,
    )
    if tqm is not None:
        k2, k2_routes = tqm.int8_matmul.launches, dict(tqm.int8_matmul.launches_by_route)
        log(f'[{tag}] int8_matmul launches {k2} = {k2_per_layer} x {cfg.num_layers} layers x '
            f'{passes} passes; by route {json.dumps(k2_routes)}; plain version '
            f'{tqm.int8_matmul_reference.launches}')
        if k2 != k2_per_layer * cfg.num_layers * passes or k2_routes['tensor_cores'] != k2:
            fail(f'{tag}: K2 launches {k2} ({k2_routes}) for {passes} passes')
        if tqm.int8_matmul_reference.launches != 0:
            fail(f'{tag}: the plain int8 matmul ran on the serving path')
        arm.update(k2_launches=k2, k2_launches_by_route=k2_routes)
    shut_down(torch, tag, engine)
    del engine
    torch.cuda.empty_cache()
    return arm


# The JAX gen_mixed / gen_spec engine (bench.py): 712 blocks of 16, 32 slots,
# 512-token rows, 16-step decode windows, sampling over the top 64 logits,
# the prefix cache on.
SERVE_712 = dict(block_size=BLOCK_SIZE, num_blocks=712, max_num_seqs=32, max_model_len=512,
                 decode_steps=16, sampling_top_window=64, enable_prefix_cache=True)


def phase_serve_mixed(torch, tpa, card, cfg, params):
    """The JAX ``gen_mixed`` stage at full width: its workload (phase 6b's:
    64 greedy prompts of 32..192 tokens, every third behind a shared
    32-token prefix, 16..96 new each) through two ``LLMEngine`` arms on the
    7B bf16 weights, ``prefill_chunk_tokens=256`` and
    ``max_window_prefill_tokens=256``, mixed batching off and then on. As
    in 6d, the first shared-prefix prompt is served first (untimed): a
    request matches the cache when it is added, and no tail here is longer
    than a chunk, so the shared-prefix tails admitted once windows flow
    are what rides.
    The on arm must ride windows (``mixed_windows`` > 0) and run fewer
    standalone prefill dispatches; K1 launches on the routes
    ``kernel_route`` names (eager passes by padded width, decode steps on
    the split-KV route), its plain op never; every decode step a graph
    replay. Tokens/s, prefill and chunk host ms and the greedy match
    between the arms are printed (bf16: a match fraction, not identity),
    each flip with the plain op's logit gap."""
    from distllm_tpu_torch.generate.engine import SamplingParams

    prompts, budgets = kvq_workload(cfg.vocab_size)
    sampling = [SamplingParams(temperature=0.0, max_tokens=n) for n in budgets]
    arms = {}
    for mixed in (False, True):
        tag = f'mixed {"on" if mixed else "off"}'
        arm = serve_arm(torch, tpa, tag, cfg, params, dict(
            SERVE_712, prefill_chunk_tokens=256, enable_mixed_batching=mixed,
            max_window_prefill_tokens=256), prompts[1:], sampling[1:],
            first=(prompts[:1], sampling[:1]))
        log(f'[{tag}] 63 prompts, {arm["generated_tokens"]} new tokens in '
            f'{arm["wall_s"]:.3f} s = {arm["tokens_per_s"]:.1f} tok/s on {card}; '
            f'{arm["prefill_dispatches"]} standalone prefill dispatches '
            f'({arm["prefill_host_ms"]:.1f} host ms, widths {arm["prefill_widths"]}), '
            f'{arm["mixed_windows"]} mixed windows carrying {arm["mixed_prefill_tokens"]} '
            f'chunk tokens ({arm["chunk_host_ms"]:.1f} host ms over {arm["chunk_halves"]} '
            f'chunk halves, widths {arm["chunk_widths"]}); decode window '
            f'{arm["decode_window_wall_ms_per_step"]} ms a step (median)')
        arms['on' if mixed else 'off'] = arm
    on, off = arms['on'], arms['off']
    match = greedy_match(off['tokens'], on['tokens'])
    flips = flip_report(torch, cfg, params, prompts[1:], off['tokens'], on['tokens'])
    log(f'[mixed] on vs off: {on["tokens_per_s"] / off["tokens_per_s"]:.4f}x tokens/s, '
        f'prefill + chunk host ms {off["prefill_host_ms"] + off["chunk_host_ms"]:.1f} off / '
        f'{on["prefill_host_ms"] + on["chunk_host_ms"]:.1f} on; greedy match {match:.4f} '
        f'(recorded, not asserted: bf16); flips with the plain op\'s logit gap '
        f'{json.dumps(flips)}')
    if not on['mixed_windows'] > 0 or off['mixed_windows'] != 0:
        fail(f'mixed: {on["mixed_windows"]} mixed windows on, {off["mixed_windows"]} off')
    if not on['prefill_dispatches'] < off['prefill_dispatches']:
        fail(f'mixed: {on["prefill_dispatches"]} standalone prefill dispatches on, '
             f'{off["prefill_dispatches"]} off')
    for arm in arms.values():
        arm.pop('tokens')
    return dict(arms, greedy_match=match, flips=flips,
                speedup=on['tokens_per_s'] / off['tokens_per_s'])


def spec_workload(vocab_size):
    """The JAX package's ``gen_spec`` stage workload (``bench.py``, full
    size; numpy seed 0): 64 prompts of 32..192 tokens, every other one's
    tail tiling an 8-token motif (prompt lookup's material), every third
    behind a shared 32-token prefix, 16..96 new tokens each."""
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(1, vocab_size, size=32)]
    motif = [int(t) for t in rng.integers(1, vocab_size, size=8)]
    prompts = []
    for i, n in enumerate(rng.integers(32, 192, size=64)):
        tail = [int(t) for t in rng.integers(1, vocab_size, size=int(n))]
        if i % 2 == 0:
            tail = (motif * (1 + len(tail) // len(motif)))[:len(tail)]
        prompts.append(shared + tail if i % 3 == 0 else tail)
    budgets = [int(n) for n in rng.integers(16, 96, size=64)]
    return prompts, budgets


SPEC_DRAFT_K = 4
SPEC_SAMPLED = dict(temperature=0.15, top_p=0.95)  # the JAX stage's sampled arm


def phase_serve_spec(torch, tpa, tqm, card, cfg, params):
    """The JAX ``gen_spec`` stage at full width on the 7B bf16 weights:
    arms ``draft_k=0`` (decode graphs), ``draft_k=4`` with
    ``spec_draft_source='none'`` (every window a span-1 verify) and with
    prompt lookup. Random weights never repeat themselves, so prompt
    lookup proposes next to nothing here (recorded); the arms that
    verify accepted drafts give every request a :class:`ProposalDrafter`
    of the ``'none'`` arm's greedy stream (``oracle``: greedy, then a
    sampled arm, temperature 0.15, top-p 0.95, a seed per request, run
    twice, then greedy over int8 weights, K2 on every verify pass).
    Asserted: ``'none'`` and prompt lookup give identical tokens (one
    graph, one schedule), the oracle arms accept drafts, the sampled arm is
    deterministic, every verify window is one graph replay with nothing
    captured in the run, K1's verify passes launch on
    ``kernel_route(bf16, 5, 4)``'s route, its plain op never. Accept
    rate, tokens/s per arm, the verify window's wall ms and replay event
    ms (medians), and the verify arms' greedy match against ``draft_k=0``
    with each flip's plain-op logit gap are printed."""
    from distllm_tpu_torch.generate.engine import SamplingParams

    prompts, budgets = spec_workload(cfg.vocab_size)
    greedy = [SamplingParams(temperature=0.0, max_tokens=n) for n in budgets]
    sampled = [SamplingParams(max_tokens=n, seed=1000 + i, **SPEC_SAMPLED)
               for i, n in enumerate(budgets)]
    spec = dict(SERVE_712, draft_k=SPEC_DRAFT_K)
    arms = {}
    for name, kw, sampling in (
        ('decode', SERVE_712, greedy),
        ('none', dict(spec, spec_draft_source='none'), greedy),
        ('prompt_lookup', spec, greedy),
    ):
        arms[name] = serve_arm(torch, tpa, f'spec {name}', cfg, params, kw, prompts, sampling)
    # The verify graph's own greedy stream: in bf16 the decode graphs'
    # stream parts from it at the first near tie.
    oracle = arms['none']['tokens']
    for name, kw, sampling, k2 in (
        ('oracle', spec, greedy, None),
        ('oracle_sampled', spec, sampled, None),
        ('oracle_sampled_again', spec, sampled, None),
        ('oracle_int8', dict(spec, quantization='int8'), greedy, tqm),
    ):
        arms[name] = serve_arm(torch, tpa, f'spec {name}', cfg, params, kw, prompts, sampling,
                               tqm=k2, proposals=oracle)
    base = arms['decode']['tokens_per_s']
    for name, arm in arms.items():
        arm['speedup_over_decode'] = arm['tokens_per_s'] / base
        log(f'[spec {name}] {arm["generated_tokens"]} new tokens in {arm["wall_s"]:.3f} s = '
            f'{arm["tokens_per_s"]:.1f} tok/s on {card} ({arm["speedup_over_decode"]:.4f}x '
            f'draft_k=0); {arm["spec_windows"]} verify windows, accept rate '
            f'{arm["accept_rate"]} ({arm["spec_accepted_tokens"]}/{arm["spec_draft_tokens"]}); '
            f'verify window {arm["verify_window_wall_ms"]} ms wall, replay '
            f'{arm["verify_replay_event_ms"]} ms event (medians); decode window '
            f'{arm["decode_window_wall_ms_per_step"]} ms a step; '
            f'{arm["prefill_dispatches"]} prefill dispatches ({arm["prefill_host_ms"]:.1f} host ms)')
    same = arms['none']['tokens'] == arms['prompt_lookup']['tokens']
    oracle_match = greedy_match(arms['none']['tokens'], arms['oracle']['tokens'])
    deterministic = arms['oracle_sampled']['tokens'] == arms['oracle_sampled_again']['tokens']
    decode_match = greedy_match(arms['decode']['tokens'], arms['none']['tokens'])
    flips = flip_report(torch, cfg, params, prompts, arms['decode']['tokens'],
                        arms['none']['tokens'])
    int8_match = greedy_match(arms['oracle']['tokens'], arms['oracle_int8']['tokens'])
    log(f'[spec] none and prompt_lookup identical={same}; oracle vs none greedy match '
        f'{oracle_match:.4f} (recorded: accepted drafts change the schedule, and with it the '
        f'prefill batches\' widths); sampled arm '
        f'deterministic={deterministic}, accepted {arms["oracle_sampled"]["spec_accepted_tokens"]}; '
        f'greedy match of the verify arms vs draft_k=0 {decode_match:.4f} (flips with the plain '
        f'op\'s logit gap {json.dumps(flips)}), int8 vs bf16 weights {int8_match:.4f} (recorded)')
    if not same:
        fail('spec: spec_draft_source none and prompt lookup gave different tokens')
    if not deterministic or not arms['oracle_sampled']['spec_accepted_tokens'] > 0:
        fail(f'spec: sampled arm deterministic={deterministic}, accepted '
             f'{arms["oracle_sampled"]["spec_accepted_tokens"]}')
    if not (arms['oracle']['spec_accepted_tokens'] > 0
            and arms['oracle_int8']['spec_accepted_tokens'] > 0):
        fail('spec: the oracle arms accepted no draft')
    for arm in arms.values():
        arm.pop('tokens')
    return dict(arms, identical=same, oracle_greedy_match=oracle_match,
                sampled_deterministic=deterministic,
                greedy_match_vs_decode=decode_match, flips_vs_decode=flips,
                int8_greedy_match=int8_match)


def phase_identity(torch, tpa, cfg):
    from distllm_tpu_torch.generate.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distllm_tpu_torch.models import mistral

    params = mistral.init(
        cfg, torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE
    )
    rng = np.random.default_rng(2)
    prompts = [
        [int(t) for t in rng.integers(4, cfg.vocab_size, size=n)]
        for n in (16, 100, 300, 520, 37, 800)
    ]
    sampling = SamplingParams(temperature=0.0, max_tokens=24)
    engine_cfg = EngineConfig(
        block_size=BLOCK_SIZE, num_blocks=256, max_num_seqs=4,
        max_model_len=1024,
    )
    outs = {}
    for backend in ('auto', 'reference'):
        engine = LLMEngine(
            cfg, params, None, engine_cfg, device=DEVICE, attn_backend=backend
        )
        engine.warmup()  # both arms replay their own graphs
        marks = graph_marks(engine)
        tpa.ragged_paged_attention.launches = 0
        tpa.ragged_paged_attention_reference.launches = 0
        outs[backend] = engine.generate_ids(prompts, sampling)
        passes = engine.telemetry['forward_passes']
        check_graph_replays(f'identity {backend}', engine, marks, passes,
                            engine.telemetry['prefill_dispatches'])
        counted = (
            tpa.ragged_paged_attention.launches if backend == 'auto'
            else tpa.ragged_paged_attention_reference.launches
        )
        if counted != cfg.num_layers * passes:
            fail(f'identity ({backend}): {counted} attention calls for '
                 f'{passes} passes')
        shut_down(torch, f'identity {backend}', engine)
    same = outs['auto'] == outs['reference']
    log(f'[identity] fp32 depth-2 full width, 6 prompts x 24 greedy tokens: '
        f'kernel vs plain op identical={same}')
    if not same:
        fail(f'fp32 greedy tokens differ: kernel {outs["auto"]} vs plain '
             f'{outs["reference"]}')
    del params
    torch.cuda.empty_cache()


def phase_identity_kv_int8(torch, tpa, cfg):
    """fp32, full width, depth 2, an int8 KV pool: greedy tokens through
    K1's int8 mode (every launch on the CUDA-core route) equal those
    through its plain op."""
    from distllm_tpu_torch.generate.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distllm_tpu_torch.models import mistral

    params = mistral.init(
        cfg, torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE
    )
    rng = np.random.default_rng(2)
    prompts = [
        [int(t) for t in rng.integers(4, cfg.vocab_size, size=n)]
        for n in (16, 100, 300, 520, 37, 800)
    ]
    sampling = SamplingParams(temperature=0.0, max_tokens=24)
    engine_cfg = EngineConfig(
        block_size=BLOCK_SIZE, num_blocks=256, max_num_seqs=4,
        max_model_len=1024, kv_cache_dtype='int8',
    )
    outs = {}
    for backend in ('auto', 'reference'):
        engine = LLMEngine(
            cfg, params, None, engine_cfg, device=DEVICE, attn_backend=backend
        )
        engine.warmup()
        marks = graph_marks(engine)
        tpa.ragged_paged_attention.launches = 0
        tpa.ragged_paged_attention.launches_by_route = dict.fromkeys(tpa.ROUTES, 0)
        tpa.ragged_paged_attention.launches_by_kv = dict.fromkeys(tpa.KV_MODES, 0)
        tpa.ragged_paged_attention_reference.launches = 0
        outs[backend] = engine.generate_ids(prompts, sampling)
        passes = engine.telemetry['forward_passes']
        check_graph_replays(f'identity kv int8 {backend}', engine, marks, passes,
                            engine.telemetry['prefill_dispatches'])
        kernel = tpa.ragged_paged_attention
        counted, other = kernel.launches, tpa.ragged_paged_attention_reference.launches
        if backend == 'reference':
            counted, other = other, counted
        if counted != cfg.num_layers * passes or other != 0:
            fail(f'int8 KV identity ({backend}): {counted} attention calls for '
                 f'{passes} passes ({other} through the other tier)')
        if kernel.launches_by_kv['int8'] != kernel.launches or (
            kernel.launches_by_route['cuda_cores'] != kernel.launches
        ):
            fail(f'int8 KV identity ({backend}): K1 modes {kernel.launches_by_kv}, '
                 f'routes {kernel.launches_by_route}; every fp32 launch belongs in the '
                 'int8 mode on the CUDA cores')
        if engine.telemetry['kv_cache_dtype'] != 'int8':
            fail(f'int8 KV identity: telemetry {engine.telemetry["kv_cache_dtype"]}')
        shut_down(torch, f'identity kv int8 {backend}', engine)
    same = outs['auto'] == outs['reference']
    log(f'[identity kv int8] fp32 depth-2 full width, int8 KV pool, 6 prompts x 24 '
        f'greedy tokens: K1 int8 mode (CUDA-core route) vs plain op identical={same}')
    if not same:
        fail(f'fp32 int8-KV greedy tokens differ: kernel {outs["auto"]} vs plain '
             f'{outs["reference"]}')
    del params
    torch.cuda.empty_cache()


def plain_logits(torch, cfg, params, tokens, kv_dtype):
    """The plain op's last-position logits of ``tokens`` (one fresh paged
    prefill over a pool of ``kv_dtype``): where a flip happened."""
    from distllm_tpu_torch.models import mistral

    n = len(tokens)
    blocks = -(-n // BLOCK_SIZE)
    shape = (cfg.num_layers, blocks + 1, BLOCK_SIZE, cfg.num_kv_heads, cfg.head_size)
    k = torch.zeros(shape, dtype=kv_dtype, device=DEVICE)
    v = torch.zeros_like(k)
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=DEVICE)  # noqa: E731
    logits, _, _ = mistral.prefill_paged(
        params, cfg, as_dev([tokens]), as_dev([np.arange(n)]), k, v,
        as_dev([np.arange(1, blocks + 1)]), as_dev([n]), as_dev([n]),
        max_table_positions=1024, attn_backend='reference',
    )
    return logits[0].float()


# A flip whose two tokens' plain-op logits lie closer than this is a near
# tie: reported with its gap, not failed.
NEAR_TIE = 1e-3


def phase_identity_prefix_mixed(torch, tpa, cfg):
    """fp32, full width, depth 2. (a) The prefix cache with a host tier: a
    512-token block-aligned prompt, its exact repeat (copy-on-write), a
    second 512-token prompt whose admission evicts and spills the first's
    leading blocks, then the first prompt plus a tail, which promotes them
    back; greedy tokens on K1 equal those with the cache off. (b) An fp32
    model over a bf16 pool (K1's mixed mode on the CUDA cores): greedy
    tokens on K1 and on its plain op, the match printed; a flip is
    reported with the plain op's logit gap and fails unless it is a near
    tie."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mistral

    params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE)
    rng = np.random.default_rng(9)
    first = [int(t) for t in rng.integers(4, cfg.vocab_size, size=512)]
    second = [int(t) for t in rng.integers(4, cfg.vocab_size, size=512)]
    tail = [int(t) for t in rng.integers(4, cfg.vocab_size, size=40)]
    sampling = SamplingParams(temperature=0.0, max_tokens=24)
    runs = ([first], [first], [second], [first + tail])
    outs, stats = {}, {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_8c_') as tmp:
        for cache in ('off', 'on'):
            extra = dict(enable_prefix_cache=True, host_kv_tier_bytes=1 << 30,
                         disk_kv_tier_dir=tmp) if cache == 'on' else {}
            engine = LLMEngine(cfg, params, None, EngineConfig(
                block_size=BLOCK_SIZE, num_blocks=60, max_num_seqs=4, max_model_len=1024,
                **extra,
            ), device=DEVICE)
            engine.warmup()
            outs[cache] = [engine.generate_ids(r, sampling)[0] for r in runs]
            stats[cache] = dict(engine.stats)
            shut_down(torch, f'identity prefix cache {cache}', engine)
            del engine
    on = stats['on']
    same = outs['on'] == outs['off']
    log(f'[identity prefix cache] fp32 depth-2 full width, 4 runs x 24 greedy tokens: '
        f'cache on (copy-on-write {on.get("prefix_cow_copies", 0)}, spills '
        f'{on.get("tier_spills", 0)} of {on.get("tier_spilled_blocks", 0)} blocks, promotions '
        f'{on.get("tier_promotions", 0)} of {on.get("tier_promoted_blocks", 0)} blocks, hits '
        f'{on.get("prefix_hit_tokens", 0)}/{on.get("prefix_lookup_tokens", 0)} tokens) vs off '
        f'identical={same}')
    if not (on.get('prefix_cow_copies') == 1 and on.get('tier_spills', 0) > 0
            and on.get('tier_promotions', 0) > 0):
        fail(f'identity prefix cache: expected one copy-on-write, a spill and a promotion; '
             f'stats {on}')
    if not same:
        fail(f'fp32 greedy tokens differ with the prefix cache: {outs}')

    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(4, cfg.vocab_size, size=n)]
               for n in (16, 100, 300, 520, 37, 800)]
    engine_cfg = EngineConfig(block_size=BLOCK_SIZE, num_blocks=256, max_num_seqs=4,
                              max_model_len=1024, kv_cache_dtype='bf16')
    mixed, result = {}, {}
    for backend in ('auto', 'reference'):
        engine = LLMEngine(cfg, params, None, engine_cfg, device=DEVICE, attn_backend=backend)
        engine.warmup()
        marks = graph_marks(engine)
        zero_k1_counts(tpa)
        mixed[backend] = engine.generate_ids(prompts, sampling)
        passes = engine.telemetry['forward_passes']
        check_graph_replays(f'identity mixed {backend}', engine, marks, passes,
                            engine.telemetry['prefill_dispatches'])
        kernel = tpa.ragged_paged_attention
        counted, other = kernel.launches, tpa.ragged_paged_attention_reference.launches
        if backend == 'reference':
            counted, other = other, counted
        if counted != cfg.num_layers * passes or other != 0:
            fail(f'mixed identity ({backend}): {counted} attention calls for {passes} passes '
                 f'({other} through the other tier)')
        if backend == 'auto':
            if (kernel.launches_by_kv['mixed'] != kernel.launches
                    or kernel.launches_by_route['cuda_cores'] != kernel.launches):
                fail(f'mixed identity: K1 modes {kernel.launches_by_kv}, routes '
                     f'{kernel.launches_by_route}; every fp32 launch over the bf16 pool '
                     'belongs in the mixed mode on the CUDA cores')
            result = dict(launches=kernel.launches,
                          launches_by_route=dict(kernel.launches_by_route),
                          launches_by_kv=dict(kernel.launches_by_kv))
        if engine.telemetry['kv_cache_dtype'] != 'bfloat16':
            fail(f'mixed identity: telemetry {engine.telemetry["kv_cache_dtype"]}')
        shut_down(torch, f'identity mixed {backend}', engine)
        del engine
    match = greedy_match(mixed['auto'], mixed['reference'])
    flips = []
    for i, (a, b) in enumerate(zip(mixed['auto'], mixed['reference'])):
        at = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if at is None:
            continue
        logits = plain_logits(torch, cfg, params, prompts[i] + b[:at], torch.bfloat16)
        gap = float((logits[b[at]] - logits[a[at]]).abs())
        flips.append(dict(prompt=i, position=at, kernel=a[at], plain=b[at], logit_gap=gap))
    log(f'[identity mixed] fp32 model over a bf16 pool, depth-2 full width, 6 prompts x 24 '
        f'greedy tokens: K1 mixed mode (CUDA cores) vs plain op match {match:.4f}; flips '
        f'{json.dumps(flips)}')
    if any(f['logit_gap'] > NEAR_TIE for f in flips):
        fail(f'fp32-over-bf16 greedy tokens flip away from a near tie: {flips}')
    del params
    torch.cuda.empty_cache()
    return dict(result, greedy_match=match, flips=flips, prefix_cache_identical=same,
                prefix_cache_stats={k: on.get(k, 0) for k in (
                    'prefix_cow_copies', 'tier_spills', 'tier_spilled_blocks',
                    'tier_promotions', 'tier_promoted_blocks', 'prefix_hit_tokens',
                    'prefix_lookup_tokens')})


def phase_identity_spec_mixed(torch, tpa, cfg):
    """8d. fp32, full width, depth 2, the first 16 prompts of 6g's
    workload (8..31 new tokens), the prefix cache on and
    ``prefill_chunk_tokens=64``: greedy tokens with speculation
    (``draft_k=4``, verify graphs, drafts proposing the first arm's
    stream) equal those without (decode graphs); with speculation on K1
    equal those on its plain op; with mixed batching on equal those with
    it off."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mistral

    params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE)
    prompts, budgets = spec_workload(cfg.vocab_size)
    prompts = prompts[:16]
    # Staggered budgets (8..31 new tokens), so slots free while others
    # decode and later admissions ride the windows.
    sampling = [SamplingParams(temperature=0.0, max_tokens=8 + n % 24) for n in budgets[:16]]
    base = dict(block_size=BLOCK_SIZE, num_blocks=256, max_num_seqs=8, max_model_len=512,
                decode_steps=8, enable_prefix_cache=True, prefill_chunk_tokens=64)
    outs, stats = {}, {}
    for name, kw, backend in (
        ('off', {}, 'auto'),
        ('spec', dict(draft_k=SPEC_DRAFT_K), 'auto'),
        ('spec_plain', dict(draft_k=SPEC_DRAFT_K), 'reference'),
        ('mixed', dict(enable_mixed_batching=True, max_window_prefill_tokens=64), 'auto'),
    ):
        tag = f'identity {name}'
        engine = LLMEngine(cfg, params, None, EngineConfig(**base, **kw), device=DEVICE,
                           attn_backend=backend)
        engine.warmup()
        if name.startswith('spec'):
            # Prompt lookup drafts next to nothing on random weights: the
            # drafts are the cache-off arm's stream (6g's oracle).
            queue, add = list(outs['off']), engine.add_request

            def add_with_proposals(prompt, sp=None, queue=queue, add=add, engine=engine):
                rid = add(prompt, sp)
                engine._requests[rid].drafter = ProposalDrafter(
                    [0] * len(prompt) + queue.pop(0))
                return rid

            engine.add_request = add_with_proposals
        marks = graph_marks(engine)
        zero_k1_counts(tpa)
        outs[name] = engine.generate_ids(prompts, sampling)
        tele = engine.telemetry
        passes, verify = tele['forward_passes'], tele.get('spec_windows', 0)
        eager = tele['prefill_dispatches'] + tele.get('mixed_windows', 0) + tele.get(
            'spec_chunk_windows', 0)
        check_graph_replays(tag, engine, marks, passes, eager, verify)
        counted, other = (tpa.ragged_paged_attention.launches,
                          tpa.ragged_paged_attention_reference.launches)
        if backend == 'reference':
            counted, other = other, counted
        if counted != cfg.num_layers * passes or other != 0:
            fail(f'{tag}: {counted} attention calls for {passes} passes ({other} through '
                 'the other tier)')
        stats[name] = {k: tele.get(k, 0) for k in (
            'forward_passes', 'prefill_dispatches', 'prefill_chunks', 'spec_windows',
            'spec_draft_tokens', 'spec_accepted_tokens', 'mixed_windows',
            'mixed_prefill_tokens')}
        shut_down(torch, tag, engine)
        del engine
    same = {name: outs[name] == outs['off'] for name in ('spec', 'spec_plain', 'mixed')}
    log(f'[identity spec mixed] fp32 depth-2 full width, 16 prompts (gen_spec), prefix cache, '
        f'chunks of 64: identical to speculation and mixed batching off: {json.dumps(same)}; '
        f'stats {json.dumps(stats)}')
    if not all(same.values()):
        fail(f'fp32 greedy tokens differ: {same}')
    if not (stats['spec']['spec_accepted_tokens'] > 0 and stats['mixed']['mixed_windows'] > 0):
        fail(f'identity spec mixed: no accepted draft or no mixed window: {stats}')
    del params
    torch.cuda.empty_cache()
    return dict(identical=same, stats=stats)


def phase_identity_int8(torch, tqm, cfg):
    """fp32, full width, depth 2, int8 weights quantized on the card:
    greedy tokens through K2 equal those through its plain version."""
    from distllm_tpu_torch.generate.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distllm_tpu_torch.models import mistral

    params = mistral.init(
        cfg, torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE
    )
    rng = np.random.default_rng(2)
    prompts = [
        [int(t) for t in rng.integers(4, cfg.vocab_size, size=n)]
        for n in (16, 100, 300, 520, 37, 800)
    ]
    sampling = SamplingParams(temperature=0.0, max_tokens=24)
    engine_cfg = EngineConfig(
        block_size=BLOCK_SIZE, num_blocks=256, max_num_seqs=4,
        max_model_len=1024, quantization='int8',
    )
    outs = {}
    for backend in ('auto', 'reference'):
        engine = LLMEngine(
            cfg, params, None, engine_cfg, device=DEVICE, qmm_backend=backend
        )
        engine.warmup()
        marks = graph_marks(engine)
        tqm.int8_matmul.launches = 0
        tqm.int8_matmul.launches_by_route = dict.fromkeys(tqm.ROUTES, 0)
        tqm.int8_matmul_reference.launches = 0
        outs[backend] = engine.generate_ids(prompts, sampling)
        passes = engine.telemetry['forward_passes']
        check_graph_replays(f'identity int8 {backend}', engine, marks, passes,
                            engine.telemetry['prefill_dispatches'])
        counted = (
            tqm.int8_matmul.launches if backend == 'auto'
            else tqm.int8_matmul_reference.launches
        )
        other = (
            tqm.int8_matmul_reference.launches if backend == 'auto'
            else tqm.int8_matmul.launches
        )
        if counted != 7 * cfg.num_layers * passes or other != 0:
            fail(f'int8 identity ({backend}): {counted} int8 products for '
                 f'{passes} passes ({other} through the other tier)')
        if tqm.int8_matmul.launches_by_route['cuda_cores'] != tqm.int8_matmul.launches:
            fail(f'int8 identity ({backend}): K2 routes '
                 f'{tqm.int8_matmul.launches_by_route}; every fp32 launch belongs '
                 f'on the CUDA cores')
        shut_down(torch, f'identity int8 {backend}', engine)
    same = outs['auto'] == outs['reference']
    log(f'[identity int8] fp32 depth-2 full width, int8 weights quantized on '
        f'the card, 6 prompts x 24 greedy tokens: K2 (CUDA-core route) vs '
        f'plain version identical={same}')
    if not same:
        fail(f'fp32 int8 greedy tokens differ: K2 {outs["auto"]} vs plain '
             f'{outs["reference"]}')
    del params
    torch.cuda.empty_cache()


def phase_quantize(torch, tq):
    """The int8 codes and scales of one full-width Mistral-7B leaf (gate,
    layer 0), quantized on the card inside ``quantize_pytree``, equal
    bitwise those the CPU makes from the same bf16 weight."""
    from distllm_tpu_torch.models import mistral
    from distllm_tpu_torch.models.mistral import MistralConfig

    params = mistral.init(
        MistralConfig(num_layers=1),
        torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE,
    )
    host = params['layers']['gate']['kernel'].cpu()
    t0 = time.perf_counter()
    card = tq.quantize_pytree(params, mode='int8', delete_source=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    gate = card['layers']['gate']['kernel']
    cpu = tq.quantize_int8(host, 'bfloat16')
    same = torch.equal(gate.q.cpu(), cpu.q) and torch.equal(gate.scale.cpu(), cpu.scale)
    log(f'[quantize] gate layer 0 {tuple(host.shape)} bf16: card codes and '
        f'scales equal the CPU\'s bitwise={same} (card quantize_pytree of the '
        f'1-layer tree {card_s:.3f} s)')
    if not same:
        fail('card-made int8 codes or scales differ from the CPU-made ones')
    del params, card, gate
    torch.cuda.empty_cache()


def phase_kv_codes(torch, tpa):
    """The same fp32 K/V rows through the same writes on the card and on
    the CPU, at Mistral-7B geometry (8 KV heads x 128, block 16): two
    ``write_chunk_kv`` spans per row (fresh from offset 0, then landing
    mid-block, with padding), then 40 ``write_token_kv`` appends whose
    magnitudes grow (every append rescales its block) across a block
    boundary (a scale reset at offset 0). Codes and scales must be equal
    bitwise outside the trash block."""
    gen = torch.Generator().manual_seed(9)
    nb, rows = 64, 4
    pools = {
        dev: [tpa.QuantizedKV(
            torch.zeros((nb, BLOCK_SIZE, NUM_KV_HEADS, HEAD_DIM), dtype=torch.int8,
                        device=dev),
            torch.zeros((nb, NUM_KV_HEADS), device=dev)) for _ in range(2)]
        for dev in ('cpu', DEVICE)
    }
    bt = torch.randperm(nb - 1, generator=gen)[:rows * 12].add(1).reshape(rows, 12).int()
    steps = []
    firsts, seconds = [37, 5, 64, 100], [40, 59, 17, 1]
    width = 64
    for start, lens in ((np.zeros(rows, int), firsts), (firsts, seconds)):
        pos = torch.tensor(start)[:, None] + torch.arange(width)[None]
        valid = torch.arange(width)[None] < torch.tensor(lens)[:, None]
        shape = (rows, width, NUM_KV_HEADS, HEAD_DIM)
        steps.append(('chunk', torch.randn(shape, generator=gen) * 2,
                      torch.randn(shape, generator=gen), pos.int(), valid))
    base = torch.tensor([a + b for a, b in zip(firsts, seconds)], dtype=torch.int32)
    for i in range(40):
        shape = (rows, NUM_KV_HEADS, HEAD_DIM)
        steps.append(('token', torch.randn(shape, generator=gen) * (1 + i / 8),
                      torch.randn(shape, generator=gen), base + i, None))
    t0 = time.perf_counter()
    for kind, nk, nv, pos, valid in steps:
        for dev, (k, v) in pools.items():
            args = (nk.to(dev), nv.to(dev), bt.to(dev), pos.to(dev))
            if kind == 'chunk':
                tpa.write_chunk_kv(k, v, *args, valid.to(dev))
            else:
                tpa.write_token_kv(k, v, *args)
    torch.cuda.synchronize()
    same = all(
        torch.equal(host.data[1:], card.data[1:].cpu())
        and torch.equal(host.scale[1:], card.scale[1:].cpu())
        for host, card in zip(pools['cpu'], pools[DEVICE])
    )
    resets = sum(int(((base + i) % BLOCK_SIZE == 0).sum()) for i in range(40))
    log(f'[kv codes] 2 chunk writes + 40 appends ({resets} at a block\'s offset 0), '
        f'{rows} rows, Mistral-7B KV geometry: card codes and scales equal the '
        f'CPU\'s bitwise={same} ({time.perf_counter() - t0:.3f} s)')
    if not same:
        fail('int8 KV codes or scales written on the card differ from the CPU\'s')


# ---------------------------------------------------------- phases 10-11
def write_corpus(path: Path) -> None:
    """2048 texts of 120..259 words from a 5000-word vocabulary, seed 0 —
    the JAX package's embed benchmark corpus (``bench.py``) — as jsonl."""
    rng = np.random.default_rng(0)
    vocab = [f'tok{i}' for i in range(5000)]
    with open(path, 'w') as fh:
        for i in range(EMBED_TEXTS):
            n = int(rng.integers(120, 260))
            text = ' '.join(rng.choice(vocab, size=n))
            fh.write(json.dumps({'text': text, 'id': i}) + '\n')


def phase_embed(torch, tea, card, tmp: Path, tqm=None, quantization=None):
    """The embed stages over BERT-base bf16; with ``quantization`` the
    encoder quantizes the dense kernels on the card and K2 (``tqm``)
    serves every projection."""
    from distllm_tpu_torch.embed import (
        get_dataset,
        get_embedder,
        get_pooler,
        get_writer,
    )
    from distllm_tpu_torch.embed.encoders.base import TorchEncoder
    from distllm_tpu_torch.models import bert
    from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer
    from distllm_tpu_torch.timer import Timer

    tag = f'embed {quantization}' if quantization else 'embed'
    corpus_file = tmp / 'corpus.jsonl'
    if not corpus_file.exists():
        write_corpus(corpus_file)
    cfg = bert.BertConfig()  # S-PubMedBert-MS-MARCO widths: BERT-base
    with Timer('loaded-encoder', corpus_file.name):
        params = bert.init(
            cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE
        )
        encoder = TorchEncoder(
            config=None, apply_fn=bert.apply, model_cfg=cfg, params=params,
            tokenizer=WhitespaceTokenizer(
                vocab_size=cfg.vocab_size, model_max_length=512
            ),
            embedding_size=cfg.hidden_size, device=DEVICE,
            quantization=quantization,
        )
        torch.cuda.synchronize()
    dataset = get_dataset({'name': 'jsonl', 'batch_size': EMBED_BATCH})
    pooler = get_pooler({'name': 'mean'})
    embedder = get_embedder({'name': 'full_sequence'})
    writer = get_writer({'name': 'numpy'})
    with Timer('loaded-dataset', corpus_file.name):
        corpus = dataset.read(corpus_file)
    t0 = time.perf_counter()
    embedder.embed(corpus, encoder, pooler, batch_size=dataset.config.batch_size)
    warm_s = time.perf_counter() - t0

    # The main path: counts to 0 just before, read just after.
    tea.encoder_attention.launches = 0
    tea.encoder_attention.launches_by_route = dict.fromkeys(tea.ROUTES, 0)
    tea.encoder_attention_reference.launches = 0
    if tqm is not None:
        tqm.int8_matmul.launches = 0
        tqm.int8_matmul.launches_by_route = dict.fromkeys(tqm.ROUTES, 0)
        tqm.int8_matmul_reference.launches = 0
    t0 = time.perf_counter()
    with Timer('computed-embeddings', corpus_file.name):
        result = embedder.embed(
            corpus, encoder, pooler, batch_size=dataset.config.batch_size
        )
    wall_s = time.perf_counter() - t0
    launches = tea.encoder_attention.launches
    by_route = dict(tea.encoder_attention.launches_by_route)
    plain = tea.encoder_attention_reference.launches
    shard = tmp / f'shard_{quantization or "float"}'
    with Timer('wrote-embeddings', corpus_file.name):
        writer.write(shard, result)

    stats = embedder.stats
    batches = sum(stats['bucket_batches'].values())
    emb = result.embeddings
    if emb.shape != (EMBED_TEXTS, cfg.hidden_size) or emb.dtype != np.float32:
        fail(f'embeddings are {emb.shape} {emb.dtype}, expected '
             f'({EMBED_TEXTS}, {cfg.hidden_size}) float32')
    if not np.isfinite(emb).all():
        fail('non-finite embeddings')
    back = np.load(shard / 'embeddings.npy')
    texts = np.load(shard / 'text.npy', allow_pickle=True)
    meta = np.load(shard / 'metadata.npy', allow_pickle=True)
    if (not np.array_equal(back, emb) or list(texts) != corpus.texts
            or [m['id'] for m in meta] != list(range(EMBED_TEXTS))):
        fail('the written shard does not read back as the embedder result')
    per_s = EMBED_TEXTS / wall_s
    padding = 1.0 - stats['tokens_real'] / stats['tokens_padded']
    buckets = {int(k): v for k, v in sorted(stats['bucket_batches'].items())}
    log(f'[{tag}] BERT-base {cfg.dtype} ({cfg.num_layers} layers, hidden '
        f'{cfg.hidden_size}), {EMBED_TEXTS} texts, batch {EMBED_BATCH}: '
        f'{per_s:.1f} embeddings/s ({wall_s:.3f} s; warm-up pass '
        f'{warm_s:.3f} s) on {card}; buckets {json.dumps(buckets)}; padding '
        f'share {padding:.4f}; output {emb.shape} float32, written and read back')
    log(f'[{tag}] encoder_attention launches {launches} = {cfg.num_layers} '
        f'layers x {batches} batches; by route {json.dumps(by_route)}; plain '
        f'version launches {plain}')
    if launches <= 0 or launches != cfg.num_layers * batches:
        fail(f'K3 launches {launches} != {cfg.num_layers} x {batches} batches')
    want = k3_route_counts(torch, tea, buckets, cfg.num_layers)
    if by_route != want:
        fail(f'K3 routes {by_route}: the route map gives {want} for these buckets')
    if plain != 0:
        fail(f'the plain encoder attention ran {plain} times on the embed path')
    out = dict(embeddings_per_s=per_s, wall_s=wall_s, launches=launches,
               launches_by_route=by_route, batches=batches, buckets=buckets, padding_share=padding,
               corpus=corpus)
    if tqm is not None:
        k2, k2_plain = tqm.int8_matmul.launches, tqm.int8_matmul_reference.launches
        k2_routes = dict(tqm.int8_matmul.launches_by_route)
        log(f'[{tag}] int8_matmul launches {k2} = 6 projections x '
            f'{cfg.num_layers} layers x {batches} batches; by route '
            f'{json.dumps(k2_routes)}; plain version launches {k2_plain}')
        if k2 <= 0 or k2 != 6 * cfg.num_layers * batches:
            fail(f'K2 launches {k2} != 6 x {cfg.num_layers} x {batches} batches')
        if k2_routes['tensor_cores'] != k2:
            fail(f'K2 routes {k2_routes}: every bf16 launch belongs on the tensor cores')
        if k2_plain != 0:
            fail(f'the plain int8 matmul ran {k2_plain} times on the embed path')
        out['k2_launches'] = k2
        out['k2_launches_by_route'] = k2_routes
    encoder.shutdown()
    del params, encoder, result
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- phase 12
def k3_route_counts(torch, tea, buckets, layers, bias_layers=0):
    """K3 launches by route that the route map gives an embed pass over
    ``buckets`` ({padded length: batches}) of ``layers`` bf16 layers at
    head dim 64, ``bias_layers`` of them with the [S, S] bias."""
    want = dict.fromkeys(tea.ROUTES, 0)
    for s, batches in buckets.items():
        want[tea.kernel_route(torch.bfloat16, 64, int(s), True)] += bias_layers * batches
        want[tea.kernel_route(torch.bfloat16, 64, int(s))] += (layers - bias_layers) * batches
    return want


def encoder_identity(torch, tea, tag, module, cfg, tokenizer, texts, batch):
    """fp32 pooled embeddings of ``texts`` through K3 (``attn_impl='auto'``)
    and through its plain version (``'reference'``) on the same weights
    (seed 1) agree elementwise within ``EMBED_RTOL * |ref| + EMBED_ATOL``;
    each run's attention calls are layers x batches, all of its kind."""
    from distllm_tpu_torch.embed import get_pooler
    from distllm_tpu_torch.embed.embedders.full_sequence import compute_embeddings
    from distllm_tpu_torch.embed.encoders.base import TorchEncoder

    params = module.init(cfg, torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE)
    pooler = get_pooler({'name': 'mean'})
    outs = {}
    for impl, counter in (('auto', tea.encoder_attention),
                          ('reference', tea.encoder_attention_reference)):
        encoder = TorchEncoder(
            config=None, apply_fn=functools.partial(module.apply, attn_impl=impl),
            model_cfg=cfg, params=params, tokenizer=tokenizer,
            embedding_size=cfg.hidden_size, device=DEVICE,
        )
        tea.encoder_attention.launches = 0
        tea.encoder_attention_reference.launches = 0
        stats = {}
        outs[impl] = compute_embeddings(texts, encoder, pooler, batch, stats=stats, device=DEVICE)
        batches = sum(stats['bucket_batches'].values())
        calls = tea.encoder_attention.launches + tea.encoder_attention_reference.launches
        if counter.launches != cfg.num_layers * batches or calls != counter.launches:
            fail(f'{tag} ({impl}): {counter.launches} attention calls for {batches} batches')
    ref = outs['reference']
    diff = np.abs(outs['auto'] - ref)
    err_over_tol = float((diff / (EMBED_RTOL * np.abs(ref) + EMBED_ATOL)).max())
    log(f'[{tag}] fp32 depth-2 full width, {len(texts)} texts in batches of {batch}: '
        f'kernel vs plain max abs err {float(diff.max()):.3e}, worst element at '
        f'{err_over_tol:.3f} x (rtol {EMBED_RTOL}, atol {EMBED_ATOL})')
    if not err_over_tol <= 1.0:
        fail(f'{tag}: fp32 pooled embeddings through K3 and its plain version differ')
    del params
    torch.cuda.empty_cache()
    return dict(max_abs_err=float(diff.max()), err_over_tol=err_over_tol)


def phase_embed_identity(torch, tea, corpus):
    from distllm_tpu_torch.models import bert
    from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer

    cfg = bert.BertConfig(num_layers=2, dtype='float32')
    # 600 texts in batches of 256: the last batch carries 168 fully masked
    # padding rows through the kernel's -1e9 path.
    return encoder_identity(
        torch, tea, 'embed identity', bert, cfg,
        WhitespaceTokenizer(vocab_size=cfg.vocab_size, model_max_length=512),
        corpus.texts[:600], 256,
    )


# -------------------------------------------------------------- phase 13
# google/gemma-2-9b's published config.json (the keys the port reads).
GEMMA2_9B_HF = {
    'model_type': 'gemma2', 'vocab_size': 256000, 'hidden_size': 3584,
    'num_hidden_layers': 42, 'num_attention_heads': 16, 'num_key_value_heads': 8,
    'head_dim': 256, 'intermediate_size': 14336, 'max_position_embeddings': 8192,
    'rope_theta': 10000.0, 'rms_norm_eps': 1e-6, 'hidden_activation': 'gelu_pytorch_tanh',
    'query_pre_attn_scalar': 256, 'attn_logit_softcapping': 50.0,
    'final_logit_softcapping': 30.0, 'sliding_window': 4096, 'tie_word_embeddings': True,
}
# Phase 13's engine: 8 slots of prompts up to 4,600 tokens + 64 new.
GEMMA2_MAX_MODEL_LEN = 4736
GEMMA2_PROMPT_LENS = (256, 4600)
# Phase 13b's prompts (two past the window of 4,096) and prefill chunk.
GEMMA2_IDENTITY_LENS = (4200, 300, 4400, 1000, 700, 2500)
GEMMA2_IDENTITY_CHUNK = 512


def gemma2_9b_model(**update):
    """Gemma-2-9B's ``GemmaConfig`` fields from its HF config, as a YAML
    mapping would carry them (``name: gemma2``)."""
    import dataclasses

    from distllm_tpu_torch.models.gemma import GemmaConfig

    fields = dataclasses.asdict(GemmaConfig.from_hf_config(GEMMA2_9B_HF))
    fields.update(update)
    return fields


def phase_serve_gemma2(torch, tpa, card, tmp: Path):
    """13. Full-width Gemma-2-9B in bf16 at full depth, random weights
    made on the card, served from a chat app YAML whose model is named
    ``gemma2``: 16 prompts of 256..4600 tokens (two past 4,160, so the
    even layers' window of 4,096 cuts during decode), 64 new tokens each,
    then 3 chat completions; every K1 launch at head dim 256 on the
    tensor cores (prefill) or the split-KV route (decode), the plain op
    never, every decode step a graph replay."""
    from distllm_tpu_torch.chat_server import load_app_config

    app = {
        'system_prompt': '',
        'generator_config': {
            'name': 'torch', 'temperature': 0.0, 'max_tokens': 64,
            'block_size': BLOCK_SIZE, 'num_blocks': 2400, 'max_num_seqs': 8,
            'max_model_len': GEMMA2_MAX_MODEL_LEN, 'seed': 0, 'device': DEVICE,
            'model': gemma2_9b_model(),
        },
    }
    import yaml

    path = tmp / 'gemma2_chat.yaml'
    path.write_text(yaml.safe_dump(app))
    config, _ = load_app_config(str(path))
    cfg = config.model
    log(f'[serve gemma2] {path.name}: {type(cfg).__name__}(name={cfg.name!r}, '
        f'{cfg.num_layers} layers, hidden {cfg.hidden_size}, heads {cfg.num_heads}/'
        f'{cfg.num_kv_heads} x {cfg.head_size}, window {cfg.sliding_window} '
        f'{cfg.sliding_window_pattern}, softcaps {cfg.attn_logit_softcap} / '
        f'{cfg.final_logit_softcap}, {cfg.dtype}); prefix cache '
        f'{config.enable_prefix_cache}')
    if (cfg.name != 'gemma2' or cfg.head_size != GEMMA2_9B_HF['head_dim']
            or not config.enable_prefix_cache):
        fail(f'the chat YAML gave {cfg} (prefix cache {config.enable_prefix_cache})')
    # Random Gemma-2 weights at full width copy a prompt's last token (tied
    # embeddings scaled by sqrt(3584) outweigh the rest of the residual
    # stream in the final logits), and the whitespace tokenizer ends every
    # prompt with its SEP token: a greedy completion is then SEP after SEP,
    # which decodes to no text. The token counts and launch checks hold.
    return phase_serve(torch, tpa, card, cfg, config=config, tag='serve gemma2',
                       prompt_lens=GEMMA2_PROMPT_LENS, require_text=False)


def phase_identity_gemma2(torch, tpa):
    """13b. Gemma-2-9B widths at depth 2 in fp32 (layer 0 local, layer 1
    global), prompts past 4,096 tokens: greedy tokens through K1 (route 0
    at head dim 256) equal those through the plain op, with speculation
    (``draft_k=4``, the drafts the speculation-off stream) and mixed
    windows off and on."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import gemma

    cfg = gemma.GemmaConfig(**gemma2_9b_model(num_layers=2, dtype='float32'))
    params = gemma.init(cfg, torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE)
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(4, cfg.vocab_size, size=n)]
               for n in GEMMA2_IDENTITY_LENS]
    sampling = [SamplingParams(temperature=0.0, max_tokens=n) for n in (24, 9, 20, 16, 12, 8)]
    # Every arm prefills in chunks of 512, so the arms differ only in
    # speculation and in chunks riding windows.
    base = dict(block_size=BLOCK_SIZE, num_blocks=1024, max_num_seqs=2,
                max_model_len=GEMMA2_MAX_MODEL_LEN, decode_steps=8,
                prefill_chunk_tokens=GEMMA2_IDENTITY_CHUNK)
    arms = {
        'off': {}, 'spec': dict(draft_k=SPEC_DRAFT_K),
        'mixed': dict(enable_mixed_batching=True,
                      max_window_prefill_tokens=GEMMA2_IDENTITY_CHUNK),
    }
    outs, stats = {}, {}
    for arm, kw in arms.items():
        for backend in ('auto', 'reference'):
            tag = f'identity gemma2 {arm} {backend}'
            engine = LLMEngine(cfg, params, None, EngineConfig(**base, **kw), device=DEVICE,
                               attn_backend=backend)
            if engine.attn_backend != backend:
                fail(f'{tag}: attn_backend resolved to {engine.attn_backend!r}')
            engine.warmup()
            if arm == 'spec':
                queue, add = list(outs[('off', backend)]), engine.add_request

                def add_with_proposals(prompt, sp=None, queue=queue, add=add, engine=engine):
                    rid = add(prompt, sp)
                    engine._requests[rid].drafter = ProposalDrafter(
                        [0] * len(prompt) + queue.pop(0))
                    return rid

                engine.add_request = add_with_proposals
            marks = graph_marks(engine)
            zero_k1_counts(tpa)
            outs[(arm, backend)] = engine.generate_ids(prompts, sampling)
            tele = engine.telemetry
            passes, verify = tele['forward_passes'], tele.get('spec_windows', 0)
            eager = tele['prefill_dispatches'] + tele.get('mixed_windows', 0) + tele.get(
                'spec_chunk_windows', 0)
            check_graph_replays(tag, engine, marks, passes, eager, verify)
            counted, other = (tpa.ragged_paged_attention.launches,
                              tpa.ragged_paged_attention_reference.launches)
            if backend == 'reference':
                counted, other = other, counted
            by_route = dict(tpa.ragged_paged_attention.launches_by_route)
            if counted != cfg.num_layers * passes or other != 0:
                fail(f'{tag}: {counted} attention calls for {passes} passes ({other} through '
                     'the other tier)')
            if backend == 'auto' and by_route['cuda_cores'] != counted:
                fail(f'{tag}: fp32 launches off the CUDA cores: {by_route}')
            stats[f'{arm}_{backend}'] = {k: tele.get(k, 0) for k in (
                'forward_passes', 'prefill_dispatches', 'prefill_chunks', 'spec_windows',
                'spec_accepted_tokens', 'mixed_windows')}
            shut_down(torch, tag, engine)
            del engine
    same = {arm: outs[(arm, 'auto')] == outs[(arm, 'reference')] for arm in arms}
    same_as_off = {arm: outs[(arm, 'auto')] == outs[('off', 'auto')] for arm in arms}
    log(f'[identity gemma2] fp32 depth 2 at Gemma-2-9B widths, prompts of 300..4400 '
        f'tokens: K1 vs plain op identical {json.dumps(same)}; each arm vs speculation '
        f'and mixed off (recorded) {json.dumps(same_as_off)}; stats {json.dumps(stats)}')
    if not all(same.values()):
        fail(f'identity gemma2: fp32 greedy tokens through K1 and the plain op differ: {same}')
    if not (stats['spec_auto']['spec_accepted_tokens'] > 0
            and stats['mixed_auto']['mixed_windows'] > 0):
        fail(f'identity gemma2: no accepted draft or no mixed window: {stats}')
    del params
    torch.cuda.empty_cache()
    return dict(identical=same, identical_to_off=same_as_off, stats=stats)


# ---------------------------------------------------------- phases 14-14d
def protein_sequences(n: int = 0) -> list[str]:
    """``n`` (default ``PROTEIN_SEQS``) random sequences of the 20
    standard residues, ``PROTEIN_LENS`` long, seed 12."""
    rng = np.random.default_rng(12)
    residues = np.array(list(RESIDUES))
    return [
        ''.join(rng.choice(residues, size=int(rng.integers(PROTEIN_LENS[0], PROTEIN_LENS[1] + 1))))
        for _ in range(n or PROTEIN_SEQS)
    ]


def write_proteins(path: Path) -> list[str]:
    """:func:`protein_sequences` as FASTA with 60-residue lines; returns
    the sequences."""
    seqs = protein_sequences()
    with open(path, 'w') as fh:
        for i, seq in enumerate(seqs):
            fh.write(f'>protein_{i} random, {len(seq)} residues\n')
            fh.writelines(seq[j:j + 60] + '\n' for j in range(0, len(seq), 60))
    return seqs


def phase_encoder_embed(torch, tea, card, tmp: Path, tag, module, cfg, tokenizer, data_file,
                        dataset_kwargs, want_texts=None, normalize=False, bias_layers=0,
                        unit='characters'):
    """The stages of ``distributed_embedding.embedding_worker`` over
    ``data_file`` under a ``workstation`` compute config (one worker: this
    process): ``module`` at ``cfg`` with random weights made on the card
    (seed 0) in a ``TorchEncoder``, the dataset of ``dataset_kwargs``, the
    ``mean`` pooler, ``full_sequence`` and the ``numpy`` writer; one
    warm-up pass, one timed pass. K3 must launch layers x batches on the
    tensor cores, ``bias_layers`` x batches of them with an ``[S, S]`` bias
    (counted by wrapping the kernel's launcher in this phase), and its
    plain version never. ``unit`` names the texts' characters in the
    printed rate (a protein's are its residues)."""
    from distllm_tpu_torch.embed import get_dataset, get_embedder, get_pooler, get_writer
    from distllm_tpu_torch.embed.encoders.base import TorchEncoder
    from distllm_tpu_torch.parallel.launcher import WorkstationConfig
    from distllm_tpu_torch.timer import Timer

    file_tag = data_file.name
    torch.cuda.reset_peak_memory_stats()
    with Timer('loaded-encoder', file_tag):
        params = module.init(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
        encoder = TorchEncoder(
            config=None, apply_fn=module.apply, model_cfg=cfg, params=params,
            tokenizer=tokenizer, embedding_size=cfg.hidden_size, device=DEVICE,
        )
        torch.cuda.synchronize()
    dataset = get_dataset(dataset_kwargs)
    pooler = get_pooler({'name': 'mean'})
    embedder = get_embedder({'name': 'full_sequence', 'normalize_embeddings': normalize})
    writer = get_writer({'name': 'numpy'})
    launch = tea.encoder_attention_cuda
    bias_launches = [0]

    def counting_launch(q, k, v, mask, num_heads, scale=None, bias=None):
        bias_launches[0] += bias is not None
        return launch(q, k, v, mask, num_heads, scale, bias)

    def worker(file):
        with Timer('loaded-dataset', file_tag):
            corpus = dataset.read(file)
        t0 = time.perf_counter()
        embedder.embed(corpus, encoder, pooler, batch_size=dataset.config.batch_size)
        warm_s = time.perf_counter() - t0
        # The main path: counts to 0 just before, read just after.
        tea.encoder_attention.launches = 0
        tea.encoder_attention.launches_by_route = dict.fromkeys(tea.ROUTES, 0)
        tea.encoder_attention_reference.launches = 0
        tea.encoder_attention_cuda = counting_launch
        try:
            t0 = time.perf_counter()
            with Timer('computed-embeddings', file_tag):
                result = embedder.embed(
                    corpus, encoder, pooler, batch_size=dataset.config.batch_size
                )
            wall_s = time.perf_counter() - t0
        finally:
            tea.encoder_attention_cuda = launch
        counts = dict(launches=tea.encoder_attention.launches,
                      launches_by_route=dict(tea.encoder_attention.launches_by_route),
                      plain=tea.encoder_attention_reference.launches,
                      bias_launches=bias_launches[0])
        shard = tmp / f'shard_{tag.replace(" ", "_")}'
        with Timer('wrote-embeddings', file_tag):
            writer.write(shard, result)
        return corpus, result, shard, warm_s, wall_s, counts

    executor = WorkstationConfig(max_workers=1).get_executor(tmp / 'run')
    [(corpus, result, shard, warm_s, wall_s, counts)] = executor.map(worker, [data_file])
    gib = torch.cuda.memory_allocated() / 2**30
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    n = len(corpus.texts)
    if want_texts is not None and corpus.texts != want_texts:
        fail(f'{tag}: the dataset did not read the sequences that were written')
    emb = result.embeddings
    if emb.shape != (n, cfg.hidden_size) or emb.dtype != np.float32:
        fail(f'{tag}: embeddings are {emb.shape} {emb.dtype}, expected '
             f'({n}, {cfg.hidden_size}) float32')
    if not np.isfinite(emb).all():
        fail(f'{tag}: non-finite embeddings')
    if normalize and not np.allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-3):
        fail(f'{tag}: normalized embeddings are not unit vectors')
    back = np.load(shard / 'embeddings.npy')
    texts = np.load(shard / 'text.npy', allow_pickle=True)
    meta = (np.load(shard / 'metadata.npy', allow_pickle=True)
            if corpus.metadata is not None else None)
    if (not np.array_equal(back, emb) or list(texts) != corpus.texts
            or (meta is not None and list(meta) != corpus.metadata)):
        fail(f'{tag}: the written shard does not read back as the embedder result')
    stats = embedder.stats
    batches = sum(stats['bucket_batches'].values())
    launches, by_route = counts['launches'], counts['launches_by_route']
    padding = 1.0 - stats['tokens_real'] / stats['tokens_padded']
    buckets = {int(k): v for k, v in sorted(stats['bucket_batches'].items())}
    chars = sum(len(t) for t in corpus.texts)
    log(f'[{tag}] {type(cfg).__name__} {cfg.dtype} ({cfg.num_layers} layers, hidden '
        f'{cfg.hidden_size}, {cfg.num_heads} heads), {n} texts of {chars} {unit}, '
        f'batch {dataset.config.batch_size}: {n / wall_s:.1f} sequences/s, '
        f'{chars / wall_s:.0f} {unit}/s, {stats["tokens_real"] / wall_s:.0f} real '
        f'tokens/s ({wall_s:.3f} s; warm-up pass {warm_s:.3f} s) on {card}; '
        f'{gib:.2f} GiB allocated, {peak_gib:.2f} GiB at peak; buckets '
        f'{json.dumps(buckets)}; padding share {padding:.4f}; output {emb.shape} '
        f'float32, written and read back')
    log(f'[{tag}] encoder_attention launches {launches} = {cfg.num_layers} layers x '
        f'{batches} batches, {counts["bias_launches"]} with the [S, S] bias; by route '
        f'{json.dumps(by_route)}; plain version launches {counts["plain"]}')
    if launches <= 0 or launches != cfg.num_layers * batches:
        fail(f'{tag}: K3 launches {launches} != {cfg.num_layers} x {batches} batches')
    want = k3_route_counts(torch, tea, buckets, cfg.num_layers, bias_layers)
    if by_route != want:
        fail(f'{tag}: K3 routes {by_route}: the route map gives {want} for these buckets')
    if counts['bias_launches'] != bias_layers * batches:
        fail(f'{tag}: {counts["bias_launches"]} K3 launches carried the window bias, '
             f'expected {bias_layers} x {batches} batches')
    if counts['plain'] != 0:
        fail(f'{tag}: the plain encoder attention ran {counts["plain"]} times')
    encoder.shutdown()
    del params, encoder, result
    torch.cuda.empty_cache()
    return dict(sequences_per_s=n / wall_s, characters_per_s=chars / wall_s,
                real_tokens_per_s=stats['tokens_real'] / wall_s, wall_s=wall_s,
                warm_s=warm_s, gib=gib, peak_gib=peak_gib, launches=launches,
                launches_by_route=by_route, bias_launches=counts['bias_launches'],
                batches=batches, buckets=buckets, padding_share=padding)


def phase_protein_embed(torch, tea, card, tmp: Path):
    """14: ESM-2 650M over FASTA; 14b: ESM-C 600M over the same sequences
    one per line, each at ``PROTEIN_LAYERS``' depth. Returns the results
    and the sequences."""
    from distllm_tpu_torch.models import esm2, esmc

    fasta = tmp / 'proteins.fasta'
    seqs = write_proteins(fasta)
    per_line = tmp / 'proteins.txt'
    per_line.write_text(''.join(seq + '\n' for seq in seqs))
    out = {}
    t0 = time.perf_counter()
    # ESM-2's vocabulary is ESMC_VOCAB id for id, but for id 31 ('<null_1>'
    # against '|'), which no residue letter produces: EsmcSequenceTokenizer
    # tokenizes ESM-2's input, with no transformers tokenizer files needed.
    out['esm2_650m'] = phase_encoder_embed(
        torch, tea, card, tmp, 'protein esm2', esm2,
        esm2.Esm2Config.from_hf_config(
            dict(ESM2_650M_HF, num_hidden_layers=PROTEIN_LAYERS['esm2_650m'])),
        esmc.EsmcSequenceTokenizer(model_max_length=PROTEIN_LENS[1] + 2), fasta,
        {'name': 'fasta', 'batch_size': PROTEIN_BATCH}, want_texts=seqs, unit='residues',
    )
    # The depth beside the figure: phases 14 and 14b run cut models.
    out['esm2_650m'].update(layers=PROTEIN_LAYERS['esm2_650m'],
                            full_layers=ESM2_650M_HF['num_hidden_layers'])
    log(f'[protein esm2] phase 14 took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    out['esmc_600m'] = phase_encoder_embed(
        torch, tea, card, tmp, 'protein esmc', esmc,
        dataclasses.replace(esmc.EsmcConfig.from_hidden_size(1152),
                            num_layers=PROTEIN_LAYERS['esmc_600m']),
        esmc.EsmcSequenceTokenizer(), per_line,
        {'name': 'sequence_per_line', 'batch_size': PROTEIN_BATCH}, want_texts=seqs,
        unit='residues',
    )
    out['esmc_600m'].update(layers=PROTEIN_LAYERS['esmc_600m'],
                            full_layers=esmc.EsmcConfig.from_hidden_size(1152).num_layers)
    log(f'[protein esmc] phase 14b took {time.perf_counter() - t0:.1f} s')
    return out, seqs


def phase_modernbert_embed(torch, tea, card, tmp: Path):
    """14c: ModernBERT-base over phase 10's corpus. Returns the result and
    the corpus texts."""
    from distllm_tpu_torch.models import modernbert
    from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer

    corpus_file = tmp / 'corpus.jsonl'
    write_corpus(corpus_file)
    cfg = modernbert.ModernBertConfig()  # answerdotai/ModernBERT-base
    local_layers = sum(not cfg.is_global(li) for li in range(cfg.num_layers))
    result = phase_encoder_embed(
        torch, tea, card, tmp, 'modernbert', modernbert, cfg,
        WhitespaceTokenizer(vocab_size=cfg.vocab_size, model_max_length=512), corpus_file,
        {'name': 'jsonl', 'batch_size': EMBED_BATCH}, normalize=True,
        bias_layers=local_layers,
    )
    texts = [json.loads(line)['text'] for line in corpus_file.read_text().splitlines()]
    return result, texts


def phase_protein_identity(torch, tea, seqs, texts):
    """14d: the three models at full width and depth 2 in fp32, K3 against
    its plain version. 100 sequences in batches of 32 leave a last batch
    of 28 fully masked rows; ModernBERT's layer 1 is local."""
    from distllm_tpu_torch.models import esm2, esmc, modernbert
    from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer

    esm2_cfg = esm2.Esm2Config.from_hf_config(ESM2_650M_HF)
    esmc_cfg = esmc.EsmcConfig.from_hidden_size(1152)
    mb_cfg = modernbert.ModernBertConfig()
    for cfg in (esm2_cfg, esmc_cfg, mb_cfg):
        cfg.num_layers, cfg.dtype = 2, 'float32'
    return {
        'esm2_650m': encoder_identity(
            torch, tea, 'identity esm2', esm2, esm2_cfg,
            esmc.EsmcSequenceTokenizer(model_max_length=PROTEIN_LENS[1] + 2), seqs[:100], 32),
        'esmc_600m': encoder_identity(
            torch, tea, 'identity esmc', esmc, esmc_cfg, esmc.EsmcSequenceTokenizer(),
            seqs[:100], 32),
        'modernbert_base': encoder_identity(
            torch, tea, 'identity modernbert', modernbert, mb_cfg,
            WhitespaceTokenizer(vocab_size=mb_cfg.vocab_size, model_max_length=512),
            texts[:600], 256),
    }


# ---------------------------------------------------------- phases 15-15e
# Phase 15's corpus: 2**19 rows at BERT-base width (the retriever of the
# reference's PubMed RAG), fp32 N(0, 1) from numpy seed 15, and texts of
# 48..96 words drawn from RAG_WORDS.
INDEX_ROWS, INDEX_DIM = 1 << 19, 768
INDEX_TOP_K, INDEX_RESCORE = 20, 4
INDEX_CHECKED = 8  # queries held against the fp64 host reference
# The float32 tier may order two rows whose fp64 scores lie this close
# either way (fp32 products of 768 terms err by about 1e-8 here).
NEAR_TIE_SCORE = 1e-6
RAG_QUERIES, RETRIEVER_BATCH = 64, 8
RAG_WORDS = [f'w{i}' for i in range(5000)]
RAG_CHAT_REQUESTS, RAG_CHAT_TOP_K = 16, 5
EVAL_ITEMS = 64
JOB_FILES, JOB_CHUNKS, JOB_WORDS = 4, 32, (256, 1024)
IDENTITY_INDEX_ROWS = 4096
# The generator of phases 15b-15d and 18, one warm instance through the
# registry: Mistral-7B widths at 16 of its 32 layers (depth cut to keep the
# whole run's time), bf16, random weights from seed 0, 32 slots,
# 64 greedy tokens, the prefix cache on, a 120 s deadline and 2 dispatch
# retries (the chat YAML's defaults for an engine, set here too so the
# three phases share one instance).
RAG_MODEL: dict = {'num_layers': 16}
RAG_BLOCKS, RAG_SLOTS, RAG_NEW = 3072, 32, 64
# The retriever's query encoder: BERT-base (None = BertConfig's defaults).
RETRIEVER_BERT = None


def rag_generator_config(**update):
    return dict(
        name='tpu', model=dict(RAG_MODEL), temperature=0.0, max_tokens=RAG_NEW,
        block_size=BLOCK_SIZE, num_blocks=RAG_BLOCKS, max_num_seqs=RAG_SLOTS,
        max_model_len=2048, seed=0, enable_prefix_cache=True, request_deadline_s=120.0,
        max_dispatch_retries=2, **update,
    )


class CorpusRows:
    """Rows of a :class:`CorpusTable` (a slice or an index list): the
    embeddings as a numpy view, the texts built when asked for."""

    def __init__(self, table, key):
        self.table, self.key = table, key

    def __getitem__(self, field):
        if field == 'embeddings':
            return self.table.embeddings[self.key]
        if field == 'text':
            ids, lens = self.table.word_ids[self.key], self.table.lengths[self.key]
            return [' '.join(RAG_WORDS[i] for i in row[:n]) for row, n in zip(ids, lens)]
        raise KeyError(field)


class CorpusTable:
    """Phase 15's corpus in host memory, with the dataset interface the
    index reads (``len``; row slices and index lists give
    ``['embeddings']`` and ``['text']``): an HF dataset of this size would
    measure arrow, not the index."""

    def __init__(self, embeddings, word_ids, lengths):
        self.embeddings, self.word_ids, self.lengths = embeddings, word_ids, lengths

    def __len__(self):
        return len(self.embeddings)

    def __getitem__(self, key):
        return CorpusRows(self, key)

    def head(self, n):
        return CorpusTable(self.embeddings[:n], self.word_ids[:n], self.lengths[:n])


def make_corpus(rows=None):
    rows = rows or INDEX_ROWS
    rng = np.random.default_rng(15)
    emb = rng.standard_normal((rows, INDEX_DIM), dtype=np.float32)
    ids = rng.integers(0, len(RAG_WORDS), size=(rows, 96), dtype=np.int16)
    lens = rng.integers(48, 97, size=rows)
    return CorpusTable(emb, ids, lens)


def rag_queries(n, seed):
    rng = np.random.default_rng(seed)
    return [' '.join(rng.choice(RAG_WORDS, size=int(rng.integers(8, 40)))) for _ in range(n)]


def zero_k3_counts(tea):
    tea.encoder_attention.launches = 0
    tea.encoder_attention.launches_by_route = dict.fromkeys(tea.ROUTES, 0)
    tea.encoder_attention_reference.launches = 0


def check_k3(tea, tag, layers, batches):
    """K3 launched ``layers`` x ``batches``, all on the tensor cores; its
    plain version never."""
    launches = tea.encoder_attention.launches
    by_route = dict(tea.encoder_attention.launches_by_route)
    plain = tea.encoder_attention_reference.launches
    log(f'[{tag}] encoder_attention launches {launches} = {layers} layers x {batches} '
        f'query batches; by route {json.dumps(by_route)}; plain version {plain}')
    if (launches <= 0 or launches != layers * batches
            or by_route['tensor_cores'] + by_route['wgmma'] != launches):
        fail(f'{tag}: K3 launches {launches}, routes {by_route}; expected {layers} x '
             f'{batches} on the tensor-core routes')
    if plain != 0:
        fail(f'{tag}: the plain encoder attention ran {plain} times')
    return dict(launches=launches, launches_by_route=by_route)


def retriever_encoder(torch, cfg, seed, attn_impl='auto'):
    from distllm_tpu_torch.embed.encoders.base import TorchEncoder
    from distllm_tpu_torch.models import bert
    from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer

    params = bert.init(cfg, torch.Generator(device=DEVICE).manual_seed(seed), device=DEVICE)
    return TorchEncoder(
        config=None, apply_fn=functools.partial(bert.apply, attn_impl=attn_impl),
        model_cfg=cfg, params=params,
        tokenizer=WhitespaceTokenizer(vocab_size=cfg.vocab_size, model_max_length=512),
        embedding_size=cfg.hidden_size, device=DEVICE,
    )


_POPCOUNT = np.array([bin(i).count('1') for i in range(256)], dtype=np.int64)


def host_order(scores, k):
    """The top ``k`` of each row by (score descending, index ascending)."""
    idx = np.arange(scores.shape[1])
    return np.stack([np.lexsort((idx, -row))[:k] for row in scores])


def host_rescore(table, queries, cand, k):
    """The index's fp32 rescore, done independently on the host."""
    vectors = np.asarray(table.embeddings[np.sort(cand.reshape(-1))], dtype=np.float32)
    vectors = vectors[np.argsort(np.argsort(cand.reshape(-1)))].reshape(*cand.shape, -1)
    vectors = vectors / np.clip(np.linalg.norm(vectors, axis=-1, keepdims=True), 1e-12, None)
    rescored = np.einsum('bh,boh->bo', queries, vectors)
    order = np.argsort(-rescored, axis=1)[:, :k]
    return np.take_along_axis(cand, order, axis=1), np.take_along_axis(rescored, order, axis=1)


def host_reference(torch, index, table, queries, precision):
    """Each tier's result for ``queries`` in fp64 / exact integer numpy from
    the index's own files: the float32 tier's scores in fp64; the int8
    codes' int8 x int8 products in int64 with the scales applied in the
    port's fp32 order; Hamming distances by popcount; the quantized tiers'
    candidates by (score descending, index ascending), then rescored."""
    from distllm_tpu_torch.ops import topk

    k, over = INDEX_TOP_K, INDEX_TOP_K * INDEX_RESCORE
    parts = list(index._iter_stored_chunks())
    if precision == 'float32':
        scores = np.concatenate([
            np.asarray(p, dtype=np.float64) @ queries.astype(np.float64).T for p in parts
        ]).T
        order = host_order(scores, k)
        return order, np.take_along_axis(scores, order, axis=1)
    if precision == 'int8':
        qi, qscale = (t.numpy() for t in topk.quantize_queries(torch.from_numpy(queries)))
        # int8 x int8 sums stay far below 2**53: exact in fp64 (BLAS).
        scores = np.concatenate([
            (np.asarray(p['codes'], np.float64) @ qi.astype(np.float64).T).astype(np.float32).T
            * qscale[:, None] * np.asarray(p['scales'])[None, :]
            for p in parts
        ], axis=1)
    else:
        qbits = topk.pack_sign_bits(queries)
        scores = -np.concatenate([
            np.stack([_POPCOUNT[np.asarray(p) ^ q].sum(axis=1) for q in qbits]) for p in parts
        ], axis=1).astype(np.float64)
    return host_rescore(table, queries, host_order(scores, over), k)


def phase_index(torch, tea, card, tmp: Path):
    """Phase 15: the three index tiers over the 2**19-row corpus, 64
    queries through the BERT-base retriever, each tier against the host
    reference."""
    from distllm_tpu_torch.models import bert
    from distllm_tpu_torch.ops import topk
    from distllm_tpu_torch.rag.search import Retriever, TpuIndexV2Config
    from distllm_tpu_torch.embed import get_pooler

    t0 = time.perf_counter()
    table = make_corpus()
    log(f'[index] corpus {len(table)} x {INDEX_DIM} fp32 and texts made on the host in '
        f'{time.perf_counter() - t0:.1f} s')
    cfg = RETRIEVER_BERT() if RETRIEVER_BERT else bert.BertConfig()
    encoder = retriever_encoder(torch, cfg, seed=0)
    pooler = get_pooler({'name': 'mean'})
    queries = rag_queries(RAG_QUERIES, seed=16)
    batches = -(-RAG_QUERIES // RETRIEVER_BATCH)
    n = len(table)
    out = {}
    for precision in ('float32', 'int8', 'ubinary'):
        tag = f'index {precision}'
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        index = TpuIndexV2Config(
            dataset_dir=tmp, precision=precision, rescore_multiplier=INDEX_RESCORE,
        ).get_index(dataset=table, device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        device_bytes = index.device_bytes
        retriever = Retriever(index, encoder, pooler, batch_size=RETRIEVER_BATCH)
        retriever.search(queries[:RETRIEVER_BATCH], top_k=INDEX_TOP_K)  # warm-up
        # The main path: counts to 0 just before, read just after.
        zero_k3_counts(tea)
        t0 = time.perf_counter()
        results, emb = retriever.search(queries, top_k=INDEX_TOP_K, score_threshold=-2.0)
        retrieve_s = time.perf_counter() - t0
        k3 = check_k3(tea, tag, cfg.num_layers, batches)
        # The index alone on the same embeddings: host ms a 64-query batch
        # (the rescore's gather included) and the device top-k by events.
        host_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            index.search(emb, top_k=INDEX_TOP_K, score_threshold=-2.0)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        q_dev = torch.from_numpy(emb).to(DEVICE)
        over = INDEX_TOP_K * INDEX_RESCORE
        if precision == 'float32':
            device_fn = lambda: topk.topk_inner_product(q_dev, index._corpus, INDEX_TOP_K)  # noqa: E731
            ops, ops_rate = 2 * RAG_QUERIES * INDEX_DIM * n, PEAK_FLOPS['float32']
        elif precision == 'int8':
            device_fn = lambda: topk.int8_topk(q_dev, *index._int8, over, n_valid=n)  # noqa: E731
            ops, ops_rate = 2 * RAG_QUERIES * INDEX_DIM * n, PEAK_INT8_OPS
        else:
            bits_dev = torch.from_numpy(topk.pack_sign_bits(emb)).to(DEVICE)
            device_fn = lambda: topk.hamming_topk(bits_dev, index._packed, over, n_valid=n)  # noqa: E731
            ops, ops_rate = 2 * RAG_QUERIES * INDEX_DIM * n, PEAK_INT8_OPS
        device_ms = cuda_ms(torch, device_fn, iters=5)
        bytes_ms = device_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / ops_rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        # The first INDEX_CHECKED queries against the host reference.
        ref_idx, ref_scores = host_reference(torch, index, table, emb[:INDEX_CHECKED], precision)
        got_idx = np.array(results.total_indices[:INDEX_CHECKED])
        got_scores = np.array(results.total_scores[:INDEX_CHECKED])
        if got_idx.shape != ref_idx.shape:
            fail(f'{tag}: results of shape {got_idx.shape}, expected {ref_idx.shape}')
        near_ties = []
        for q, rank in zip(*np.nonzero(got_idx != ref_idx)):
            # fp32 scores may swap two rows whose fp64 scores lie within
            # NEAR_TIE_SCORE; the exact tiers may not swap any.
            gap = abs(float(ref_scores[q, rank]) - float(got_scores[q, rank]))
            near_ties.append(dict(query=int(q), rank=int(rank), got=int(got_idx[q, rank]),
                                  ref=int(ref_idx[q, rank]), gap=gap))
            if precision != 'float32' or gap > NEAR_TIE_SCORE:
                fail(f'{tag}: query {q} rank {rank}: row {got_idx[q, rank]} where the host '
                     f'reference has {ref_idx[q, rank]} (score gap {gap:.3e})')
        same_rows = np.sort(got_idx, axis=1) == np.sort(ref_idx, axis=1)
        score_err = float(np.abs(got_scores - ref_scores).max())
        if precision == 'float32' and not score_err <= 1e-5:
            fail(f'{tag}: float32 scores {score_err:.3e} from the fp64 reference')
        per_s = RAG_QUERIES / retrieve_s
        log(f'[{tag}] built and loaded in {build_s:.2f} s; {device_bytes / 2**20:.1f} MiB on '
            f'the card ({(torch.cuda.memory_allocated() - before) / 2**20:.1f} MiB allocated); '
            f'search of {RAG_QUERIES} queries top {INDEX_TOP_K}: host {min(host_ms):.3f} ms '
            f'(runs {", ".join(f"{m:.3f}" for m in host_ms)}), device top-k '
            f'{device_ms:.4f} ms (CUDA events), bound {bound_ms:.4f} ms (bytes '
            f'{bytes_ms:.4f}, operations {ops_ms:.4f}); retriever (encode + search) '
            f'{retrieve_s * 1e3:.1f} ms = {per_s:.1f} queries/s on {card}; '
            f'{INDEX_CHECKED} queries equal the host reference (score err {score_err:.3e}, '
            f'near-tie swaps {json.dumps(near_ties)})')
        if not same_rows.all():
            fail(f'{tag}: the top {INDEX_TOP_K} rows differ from the host reference')
        out[precision] = dict(
            build_s=build_s, device_bytes=device_bytes, host_ms=min(host_ms),
            host_ms_runs=host_ms, device_ms=device_ms, bound_ms=bound_ms,
            bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
            bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms, retrieve_ms=retrieve_s * 1e3,
            queries_per_s=per_s, score_err=score_err, near_ties=near_ties, k3=k3,
        )
        if precision == 'float32':
            kept = retriever
        del index, retriever, device_fn
    torch.cuda.empty_cache()
    return out, table, kept


def rag_engine_routes(torch, tpa, tag, engine, marks, stats0, records):
    """K1 on the RAG phases' engine: layers x passes, each on its route."""
    passes = engine.stats['forward_passes'] - stats0.get('forward_passes', 0)
    prefills = engine.stats['prefill_dispatches'] - stats0.get('prefill_dispatches', 0)
    graphs = check_k1_routes(torch, tpa, tag, engine.model_cfg, engine, marks, passes, prefills,
                             [r['width'] for r in records], 'model')
    return dict(launches=tpa.ragged_paged_attention.launches,
                launches_by_route=dict(tpa.ragged_paged_attention.launches_by_route),
                forward_passes=passes, prefill_dispatches=prefills, **graphs)


def rag_generator(torch):
    """The registry's warm generator of phases 15b-15d."""
    from distllm_tpu_torch.generate import get_generator

    return get_generator(rag_generator_config(), register=True, device=DEVICE)


def post_rag(port, i, question):
    body = json.dumps({
        'model': 'mistral-7b-random', 'top_k': RAG_CHAT_TOP_K, 'score_threshold': 0.0,
        'messages': [{'role': 'system', 'content': 'Answer from the context.'},
                     {'role': 'user', 'content': question}],
    }).encode()
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/v1/chat/completions', data=body,
        headers={'Content-Type': 'application/json', 'X-Request-Id': f'rag-{i}'},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def phase_rag_chat(torch, tpa, tea, card, retriever):
    """Phase 15b: the chat server with the float32 tier's retriever."""
    from distllm_tpu_torch.chat import ChatAppConfig
    from distllm_tpu_torch.chat_server import ChatServer

    tag = 'rag chat'
    app = ChatAppConfig.from_dict({
        'generator_config': rag_generator_config(), 'system_prompt': 'Use the context.',
        'retrieval_top_k': RAG_CHAT_TOP_K,
    })
    t0 = time.perf_counter()
    generator = app.build_generator(device=DEVICE)
    if generator is not rag_generator(torch):
        fail(f'{tag}: the chat app built another generator than the registry holds')
    log(f'[{tag}] generator through the factory in {time.perf_counter() - t0:.2f} s')
    engine = generator.engine
    records = instrument_prefill(torch, engine)
    questions = rag_queries(RAG_CHAT_REQUESTS, seed=17)
    server = ChatServer(
        generator, system_prompt=app.system_prompt, retriever=retriever,
        retrieval_top_k=app.retrieval_top_k,
        retrieval_score_threshold=app.retrieval_score_threshold,
    )
    rendered = []
    render = server.template.render

    def counting_render(history, contexts=None, scores=None):
        rendered.append(len(contexts or []))
        return render(history, contexts, scores)

    server.template.render = counting_render
    stats0, marks = dict(engine.stats), graph_marks(engine)
    tokens0 = engine.stats.get('generated_tokens', 0)
    zero_k1_counts(tpa)
    zero_k3_counts(tea)
    t0 = time.perf_counter()
    with server:
        answers = [post_rag(server.port, i, q) for i, q in enumerate(questions)]
    wall_s = time.perf_counter() - t0
    for i, (status, body) in enumerate(answers):
        if status != 200 or body['request_id'] != f'rag-{i}' or not isinstance(
                body['choices'][0]['message']['content'], str):
            fail(f'{tag}: request {i} answered {status}: {body}')
    if rendered != [RAG_CHAT_TOP_K] * RAG_CHAT_REQUESTS:
        fail(f'{tag}: contexts per rendered prompt {rendered}, expected {RAG_CHAT_TOP_K} each')
    k3 = check_k3(tea, tag, retriever.encoder.model_cfg.num_layers, RAG_CHAT_REQUESTS)
    k1 = rag_engine_routes(torch, tpa, tag, engine, marks, stats0, records)
    del engine._dispatch_prefill_paged  # instrument_prefill's wrapper
    tokens = engine.stats['generated_tokens'] - tokens0
    retrieve_ms = [t['retrieve_s'] * 1e3 for t in server.timings]
    generate_ms = [t['generate_s'] * 1e3 for t in server.timings]
    log(f'[{tag}] {RAG_CHAT_REQUESTS} POSTs answered 200, {RAG_CHAT_TOP_K} contexts in every '
        f'prompt; retrieve ms a request median {median(retrieve_ms):.2f} (max '
        f'{max(retrieve_ms):.2f}), generate ms median {median(generate_ms):.1f}; {tokens} '
        f'tokens in {wall_s:.2f} s = {tokens / wall_s:.1f} tok/s on {card}')
    return dict(requests=RAG_CHAT_REQUESTS, retrieve_ms=retrieve_ms, generate_ms=generate_ms,
                tokens_per_s=tokens / wall_s, wall_s=wall_s, k3=k3, k1=k1)


def write_pubmedqa(path: Path):
    """``EVAL_ITEMS`` entries in the JAX pubmedqa task's file format."""
    rng = np.random.default_rng(18)
    data = {
        str(30000 + i): {
            'QUESTION': ' '.join(rng.choice(RAG_WORDS, size=int(rng.integers(8, 16)))),
            'CONTEXTS': [' '.join(rng.choice(RAG_WORDS, size=int(rng.integers(20, 40))))
                         for _ in range(int(rng.integers(1, 4)))],
            'final_decision': ('yes', 'no', 'maybe')[i % 3],
        }
        for i in range(EVAL_ITEMS)
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data))


def phase_rag_eval(torch, tpa, tea, card, retriever, tmp: Path):
    """Phase 15c: ``run_eval_suite`` with one rag_config (the registry's
    generator and phase 15's retriever) on the pubmedqa task."""
    from distllm_tpu_torch.rag.evaluate import (
        EvalSuiteConfig,
        RetrievalAugmentedGenerationConfig,
        run_eval_suite,
    )

    tag = 'rag eval'

    class PhaseRagConfig(RetrievalAugmentedGenerationConfig):
        """The generator from ``generator_config``; the retriever is phase
        15's (its index's table lives in this script)."""

        def get_rag_generator(self, register=True, device=None):
            rag = super().get_rag_generator(register=register, device=device)
            rag.retriever = retriever
            return rag

    write_pubmedqa(tmp / 'downloads' / 'pubmedqa' / 'pubmedQA.json')
    config = EvalSuiteConfig(
        rag_configs=[PhaseRagConfig(generator_config=rag_generator_config())],
        tasks=['pubmedqa'], download_dir=tmp / 'downloads', output_path=tmp / 'eval.json',
    )
    engine = rag_generator(torch).engine
    records = instrument_prefill(torch, engine)
    stats0, marks = dict(engine.stats), graph_marks(engine)
    tokens0 = engine.stats.get('generated_tokens', 0)
    zero_k1_counts(tpa)
    zero_k3_counts(tea)
    t0 = time.perf_counter()
    results = run_eval_suite(config, device=DEVICE)
    wall_s = time.perf_counter() - t0
    metrics = results['model_0']['pubmedqa']
    if json.loads((tmp / 'eval.json').read_text()) != results:
        fail(f'{tag}: the results file does not read back as the results')
    k3 = check_k3(tea, tag, retriever.encoder.model_cfg.num_layers,
                  -(-EVAL_ITEMS // retriever.batch_size))
    k1 = rag_engine_routes(torch, tpa, tag, engine, marks, stats0, records)
    del engine._dispatch_prefill_paged  # instrument_prefill's wrapper
    tokens = engine.stats['generated_tokens'] - tokens0
    if tokens != EVAL_ITEMS * RAG_NEW:
        fail(f'{tag}: {tokens} tokens generated for {EVAL_ITEMS} questions x {RAG_NEW}')
    log(f'[{tag}] pubmedqa, {EVAL_ITEMS} questions: accuracy {metrics["accuracy"]:.4f}, '
        f'precision {metrics["precision"]:.4f} (random weights: a path check); {wall_s:.2f} s, '
        f'{tokens / wall_s:.1f} tok/s on {card}')
    return dict(metrics=metrics, wall_s=wall_s, tokens_per_s=tokens / wall_s, k3=k3, k1=k1)


def write_job_inputs(root: Path, files, chunks, seed=19):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for f in range(files):
        with open(root / f'chunks{f}.jsonl', 'w') as fh:
            for c in range(chunks):
                words = rng.choice(RAG_WORDS, size=int(rng.integers(*JOB_WORDS)))
                fh.write(json.dumps({'text': ' '.join(words), 'path': f'doc{f}-{c}'}) + '\n')


def job_config(tmp: Path, name, generator, files, chunks):
    """The generation job's YAML: ``jsonl`` reader, ``keyword_selection``
    prompt (the card has no nltk, which ``question_chunk``'s postprocess
    imports), ``huggingface`` writer, ``local`` compute."""
    from distllm_tpu_torch.distributed_generation import Config

    inputs = tmp / f'{name}_inputs'
    write_job_inputs(inputs, files, chunks)
    (tmp / 'keywords.txt').write_text('\n'.join(RAG_WORDS[:40]) + '\n')
    raw = {
        'input_dir': str(inputs), 'output_dir': str(tmp / name),
        'glob_patterns': ['*.jsonl'], 'reader_config': {'name': 'jsonl'},
        'prompt_config': {'name': 'keyword_selection', 'keywords': str(tmp / 'keywords.txt')},
        'generator_config': generator, 'writer_config': {'name': 'huggingface'},
        'compute_config': {'name': 'local'},
    }
    path = tmp / f'{name}.yaml'
    path.write_text(json.dumps(raw))
    return Config.from_yaml(path)


def job_rows(output_dir: Path):
    from datasets import load_from_disk

    return [load_from_disk(str(p)).to_dict()
            for p in sorted((output_dir / 'generations').iterdir())]


def phase_generation_job(torch, tpa, card, tmp: Path):
    """Phase 15d: ``run_generation`` over 4 files of 32 chunks."""
    from distllm_tpu_torch.distributed_generation import run_generation

    tag = 'generation job'
    config = job_config(tmp, 'job', rag_generator_config(), JOB_FILES, JOB_CHUNKS)
    engine = rag_generator(torch).engine
    records = instrument_prefill(torch, engine)
    stats0, marks = dict(engine.stats), graph_marks(engine)
    tokens0 = engine.stats.get('generated_tokens', 0)
    zero_k1_counts(tpa)
    t0 = time.perf_counter()
    if run_generation(config, device=DEVICE) != 0:
        fail(f'{tag}: run_generation failed')
    wall_s = time.perf_counter() - t0
    k1 = rag_engine_routes(torch, tpa, tag, engine, marks, stats0, records)
    del engine._dispatch_prefill_paged  # instrument_prefill's wrapper
    tokens = engine.stats['generated_tokens'] - tokens0
    shards = job_rows(config.output_dir)
    rows = [len(s['response']) for s in shards]
    if len(shards) != JOB_FILES or rows != [JOB_CHUNKS] * JOB_FILES:
        fail(f'{tag}: shards of {rows} rows, expected {JOB_FILES} of {JOB_CHUNKS}')
    if not all(r for s in shards for r in s['response']):
        fail(f'{tag}: an empty response was written')
    if tokens != JOB_FILES * JOB_CHUNKS * RAG_NEW:
        fail(f'{tag}: {tokens} tokens for {JOB_FILES * JOB_CHUNKS} prompts x {RAG_NEW}')
    if run_generation(config, device=DEVICE) != 1 or len(job_rows(config.output_dir)) != JOB_FILES:
        fail(f'{tag}: a second run into the same output_dir was not refused')
    log(f'[{tag}] {JOB_FILES} shards of {JOB_CHUNKS} rows written and read back; the '
        f'clobber guard refused a second run; {tokens} tokens in {wall_s:.2f} s = '
        f'{tokens / wall_s:.1f} tok/s on {card}')
    return dict(shards=len(shards), wall_s=wall_s, tokens_per_s=tokens / wall_s, k1=k1)


def phase_rag_identity(torch, tpa, tea, table):
    """Phase 15e: fp32 at depth 2. (a) The generation job's greedy tokens
    through K1 equal those through the plain op; (b) the retriever's top-20
    indices through K3 equal the plain K3's on a 4,096-row index wherever
    the plain scores' gap exceeds what the embeddings' difference can move
    a score (each row is a unit vector: at most |q_K3 - q_plain|); a flip
    is reported with its gap."""
    from distllm_tpu_torch.embed import get_pooler
    from distllm_tpu_torch.models import bert
    from distllm_tpu_torch.rag.search import Retriever, TpuIndexV2Config
    from distllm_tpu_torch.distributed_generation import run_generation

    tag = 'rag identity'
    responses = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_rag_identity_') as tmp:
        for backend in ('auto', 'reference'):
            model = {**RAG_MODEL, 'num_layers': 2, 'dtype': 'float32'}
            generator = dict(rag_generator_config(attn_backend=backend), model=model,
                             max_tokens=24, num_blocks=512, max_num_seqs=8, seed=1)
            config = job_config(Path(tmp), f'identity_{backend}', generator, 1, 8)
            zero_k1_counts(tpa)
            if run_generation(config, device=DEVICE) != 0:
                fail(f'{tag}: run_generation ({backend}) failed')
            counted = (tpa.ragged_paged_attention.launches if backend == 'auto'
                       else tpa.ragged_paged_attention_reference.launches)
            other = (tpa.ragged_paged_attention_reference.launches if backend == 'auto'
                     else tpa.ragged_paged_attention.launches)
            if counted <= 0 or other != 0:
                fail(f'{tag} ({backend}): {counted} attention calls of its kind, {other} of '
                     'the other')
            responses[backend] = [r for s in job_rows(config.output_dir) for r in s['response']]
    same = responses['auto'] == responses['reference']
    log(f'[{tag}] generation job fp32 depth 2, 8 prompts x 24 greedy tokens: K1 vs plain '
        f'identical={same}')
    if not same:
        fail(f'{tag}: fp32 greedy responses differ: {responses}')

    cfg = dataclasses.replace(RETRIEVER_BERT() if RETRIEVER_BERT else bert.BertConfig(),
                              num_layers=2, dtype='float32')
    small = table.head(IDENTITY_INDEX_ROWS)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_rag_index_') as tmp:
        index = TpuIndexV2Config(dataset_dir=Path(tmp)).get_index(dataset=small, device=DEVICE)
        queries = rag_queries(RAG_QUERIES, seed=20)
        found = {}
        for impl, counter in (('auto', tea.encoder_attention),
                              ('reference', tea.encoder_attention_reference)):
            retriever = Retriever(index, retriever_encoder(torch, cfg, seed=1, attn_impl=impl),
                                  get_pooler({'name': 'mean'}), batch_size=RETRIEVER_BATCH)
            zero_k3_counts(tea)
            found[impl] = retriever.search(queries, top_k=INDEX_TOP_K, score_threshold=-2.0)
            if counter.launches != cfg.num_layers * -(-RAG_QUERIES // RETRIEVER_BATCH):
                fail(f'{tag} ({impl}): {counter.launches} encoder attention calls')
    (kres, kemb), (pres, pemb) = found['auto'], found['reference']
    flips = []
    for q, (ki, pi, ps) in enumerate(zip(kres.total_indices, pres.total_indices,
                                         pres.total_scores)):
        slack = 2 * float(np.linalg.norm(kemb[q] - pemb[q]))
        for rank, (a, b) in enumerate(zip(ki, pi)):
            if a != b:
                gap = ps[rank] - ps[rank + 1] if rank + 1 < len(ps) else float('inf')
                flips.append(dict(query=q, rank=rank, kernel=a, plain=b, gap=gap, slack=slack))
                if gap > slack:
                    fail(f'{tag}: query {q} rank {rank}: K3 gives row {a}, plain {b}, '
                         f'with a plain score gap {gap:.3e} over the slack {slack:.3e}')
                break
    max_diff = float(np.abs(kemb - pemb).max())
    log(f'[{tag}] retriever fp32 depth 2 over {IDENTITY_INDEX_ROWS} rows, {RAG_QUERIES} '
        f'queries top {INDEX_TOP_K}: K3 vs plain query embeddings max abs diff '
        f'{max_diff:.3e}; flips {json.dumps(flips)}')
    return dict(job_identical=same, embedding_max_abs_diff=max_diff, flips=flips)



# ---------------------------------------------------------- phases 16-16d
# The JAX gen_load stage's chip engine (bench.py): SERVE_712 with a 2 s
# TTFT SLO and attribution on.
LOAD_ENGINE = dict(SERVE_712, ttft_slo_s=2.0, attribution=True)
# Its workload, and gen_chaos's (192 requests) and overload (seed 1, 128
# at 256 rps, 16..64 new) ones; 16c's HTTP run (64 at 8 rps).
LOAD = dict(seed=0, num_requests=256, rate_rps=16.0, num_sessions=16, warm_fraction=0.6,
            prefix_tokens=64, prompt_tokens=(32, 192), output_tokens=(16, 96))
CHAOS_LOAD = dict(LOAD, num_requests=192)
OVERLOAD = dict(LOAD, seed=1, num_requests=128, rate_rps=256.0, output_tokens=(16, 64))
HTTP_LOAD = dict(LOAD, seed=2, num_requests=64, rate_rps=8.0)
CHAOS_FAULTS = (
    ('dispatch', dict(times=3, after=16)),
    ('slow_window', dict(times=3, delay_s=0.2, after=8)),
    ('sched_exhausted', dict(times=2, after=32)),
)
CHAOS_RECOVERY = dict(ttft_slo_s=4.0, request_deadline_s=120.0, max_dispatch_retries=3,
                      retry_backoff_s=0.01)
OVERLOAD_SLO_S = 0.25
DEADLINE_S, DEADLINE_STALL_S, DEADLINE_PROMPTS = 1.0, 0.6, 4
SHARE_CAP = 1.05  # an MFU or bandwidth share above this is a counting error
HTTP_MAX_TOKENS = 32
LOAD_IDENTITY_PROMPTS = 32


def workload_of(fields, vocab_size):
    from distllm_tpu_torch.generate.loadgen import LoadgenConfig, build_workload

    return build_workload(LoadgenConfig(**fields, vocab_size=vocab_size))


def load_run(torch, tpa, tag, cfg, engine, workload, prefill_rec):
    """One ``run_loadgen`` over ``workload``, K1's counts zeroed just before
    and read just after: K1 launches layers x passes on the route of each
    pass (prefill dispatches by their padded width), its plain op never,
    every decode step a graph replay. Returns the report and K1's counts."""
    from distllm_tpu_torch.generate.loadgen import run_loadgen

    n0 = len(prefill_rec)
    ring0 = engine.flight.total_recorded
    marks = graph_marks(engine)
    stats0 = dict(engine.stats)
    zero_k1_counts(tpa)
    t0 = time.perf_counter()
    report = run_loadgen(engine, workload)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    run = stats_delta(engine, stats0)
    widths = [r['width'] for r in prefill_rec[n0:]]
    prefills = run.get('prefill_dispatches', 0)
    if len(widths) != prefills:
        fail(f'{tag}: {len(widths)} prefill dispatches recorded, {prefills} counted')
    graphs = check_k1_routes(torch, tpa, tag, cfg, engine, marks, run['forward_passes'],
                             prefills, widths, 'model')
    k1 = dict(launches=tpa.ragged_paged_attention.launches,
              launches_by_route=dict(tpa.ragged_paged_attention.launches_by_route),
              forward_passes=run['forward_passes'], prefill_dispatches=prefills,
              decode_windows=run.get('decode_windows', 0), wall_s=wall_s,
              # Windows whose every active row ran all the steps: equal
              # passes, so their wall times compare across runs.
              full_window_ms=median([
                  1e3 * r['duration_s'] for r in new_records(engine.flight, ring0)
                  if r['kind'] == 'decode'
                  and r['tokens'] == engine.config.decode_steps * r['batch']]),
              **graphs)
    return report, k1


def report_line(report):
    """The fragment of a ``LoadReport`` a log line carries (no token lists)."""
    frag = report.to_fragment('')
    frag['roofline'] = report.roofline
    return frag


def check_shares(tag, report):
    """Every window kind's MFU and bandwidth share lies in (0, SHARE_CAP]:
    a share above 1 is a counting error, not a fast card."""
    if not report.roofline:
        fail(f'{tag}: no roofline summary (attribution off or no cost model)')
    for kind, stats in report.roofline.items():
        for key in ('mfu', 'bw_util'):
            if not 0 < stats[key] <= SHARE_CAP:
                fail(f'{tag}: {kind} {key} {stats[key]} outside (0, {SHARE_CAP}]')


def check_finished(tag, report, workload, shed_ok=False):
    """Every admitted arrival finished with its whole budget (no EOS: the
    engine has no tokenizer), none failed; shed ones only with
    ``shed_ok``."""
    schedule = sorted(workload, key=lambda a: a.at_s)
    if report.failed_requests or report.quarantined:
        fail(f'{tag}: {report.failed_requests} failed, {report.quarantined} quarantined')
    if report.shed_requests and not shed_ok:
        fail(f'{tag}: {report.shed_requests} requests shed')
    for arrival, tokens, ttft in zip(schedule, report.tokens_by_request, report.ttft_by_request):
        if ttft is None and shed_ok:
            continue
        if len(tokens) != arrival.max_tokens:
            fail(f'{tag}: a request finished with {len(tokens)} of {arrival.max_tokens} tokens')


def phase_load(torch, tpa, card, cfg, params):
    """Phase 16 (see the module docstring). Returns the engine for 16b."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams

    t0 = time.perf_counter()
    engine = LLMEngine(cfg, params, None, EngineConfig(**LOAD_ENGINE), device=DEVICE)
    engine.warmup()
    # The eager prefill path's first calls at the workload's buckets.
    engine.generate_ids([[1] * n for n in (24, 60, 120, 250)],
                        SamplingParams(temperature=0.0, max_tokens=2))
    warm_s = time.perf_counter() - t0
    prefill_rec = instrument_prefill(torch, engine)
    workload = workload_of(LOAD, cfg.vocab_size)
    on, k1_on = load_run(torch, tpa, 'load', cfg, engine, workload, prefill_rec)
    check_finished('load', on, workload)
    if on.warm_prefix_hit_tokens <= 0:
        fail('load: no warm-prefix hits: the session mix did not reach the prefix cache')
    check_shares('load', on)
    engine.attribution = False
    off, k1_off = load_run(torch, tpa, 'load attribution off', cfg, engine, workload,
                           prefill_rec)
    engine.attribution = True
    check_finished('load attribution off', off, workload)
    # Attribution on again, on the warm cache the off replay met: the fair
    # pair for the off run's window times.
    again, k1_again = load_run(torch, tpa, 'load attribution on again', cfg, engine,
                               workload, prefill_rec)
    check_finished('load attribution on again', again, workload)
    agree = greedy_match(on.tokens_by_request, off.tokens_by_request)
    out = dict(on=report_line(on), k1=k1_on, warm_s=warm_s,
               attribution_off=dict(tok_s=off.achieved_tok_s, k1=k1_off,
                                    token_agreement=agree),
               attribution_on_again=dict(tok_s=again.achieved_tok_s, k1=k1_again,
                                         token_agreement=greedy_match(
                                             off.tokens_by_request,
                                             again.tokens_by_request)))
    p = on.percentiles
    log(f'[load] {card}: {on.requests} requests at {on.offered_rps:.2f} rps offered, '
        f'{on.tokens} tokens in {on.elapsed_s:.3f} s = {on.achieved_tok_s:.1f} tok/s; TTFT '
        f'p50/p95/p99 {p["ttft_p50"]:.4f} / {p["ttft_p95"]:.4f} / {p["ttft_p99"]:.4f} s, '
        f'TPOT {p["tpot_p50"]:.4f} / {p["tpot_p95"]:.4f} / {p["tpot_p99"]:.4f} s, queue wait '
        f'{p["queue_wait_p50"]:.4f} / {p["queue_wait_p95"]:.4f} / {p["queue_wait_p99"]:.4f} s; '
        f'goodput {on.goodput_tokens} tokens (share {on.goodput_frac}); warm-prefix hits '
        f'{on.warm_prefix_hit_tokens} tokens; shares by kind {json.dumps(on.roofline)}; K1 '
        f'{json.dumps(k1_on["launches_by_route"])}')
    log(f'[load] attribution off: {off.achieved_tok_s:.1f} tok/s vs {on.achieved_tok_s:.1f} '
        f'on and {again.achieved_tok_s:.1f} on again (the replays meet a warm prefix cache); '
        f'median full decode window {k1_off["full_window_ms"]} ms off vs '
        f'{k1_on["full_window_ms"]} ms on and {k1_again["full_window_ms"]} ms on again; '
        f'tokens agreeing {agree:.4f} on / off, '
        f'{out["attribution_on_again"]["token_agreement"]:.4f} off / on again (bf16, an '
        'open-loop schedule: a share, not identity)')
    return engine, prefill_rec, out


def new_records(ring, before):
    grew = ring.total_recorded - before
    return ring.snapshot()[-grew:] if grew else []


def phase_chaos(torch, tpa, card, cfg, engine, prefill_rec):
    """Phase 16b on phase 16's engine (see the module docstring)."""
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.resilience.faults import get_fault_injector

    for key, value in CHAOS_RECOVERY.items():
        setattr(engine.config, key, value)
    workload = workload_of(CHAOS_LOAD, cfg.vocab_size)
    clean, k1_clean = load_run(torch, tpa, 'chaos clean', cfg, engine, workload, prefill_rec)
    check_finished('chaos clean', clean, workload)
    injector = get_fault_injector()
    injector.disarm()
    try:
        for site, kwargs in CHAOS_FAULTS:
            injector.arm(site, **kwargs)
        chaos, k1_chaos = load_run(torch, tpa, 'chaos', cfg, engine, workload, prefill_rec)
        fired = {site: injector.fired(site) for site, _ in CHAOS_FAULTS}
    finally:
        injector.disarm()
    if not all(fired.values()):
        fail(f'chaos: an armed site never fired: {fired}')
    if chaos.recoveries < 1 or chaos.quarantined or chaos.failed_requests:
        fail(f'chaos: {chaos.recoveries} recoveries, {chaos.quarantined} quarantined, '
             f'{chaos.failed_requests} failed')
    if not chaos.goodput_tokens:
        fail('chaos: no goodput under the fault schedule')
    check_finished('chaos', chaos, workload)
    agree = greedy_match(clean.tokens_by_request, chaos.tokens_by_request)
    log(f'[chaos] {card}: faults fired {json.dumps(fired)}, {chaos.window_retries} retries, '
        f'{chaos.recoveries} recoveries; {chaos.achieved_tok_s:.1f} tok/s vs '
        f'{clean.achieved_tok_s:.1f} clean, goodput {chaos.goodput_tokens} tokens (share '
        f'{chaos.goodput_frac}); tokens agreeing with the clean run {agree:.4f} (bf16)')
    # Overload: admission control under a tight SLO.
    engine.config.ttft_slo_s = OVERLOAD_SLO_S
    engine.admission_control = True
    ring = engine.flight
    before = ring.total_recorded
    overload_wl = workload_of(OVERLOAD, cfg.vocab_size)
    try:
        overload, k1_overload = load_run(torch, tpa, 'overload', cfg, engine, overload_wl,
                                         prefill_rec)
    finally:
        engine.admission_control = False
        engine.config.ttft_slo_s = CHAOS_RECOVERY['ttft_slo_s']
    sheds = [r for r in new_records(ring, before) if r['kind'] == 'shed']
    if not overload.shed_requests or len(sheds) != overload.shed_requests:
        fail(f'overload: {overload.shed_requests} shed, {len(sheds)} shed records')
    if not all(r['retry_after_s'] > 0 for r in sheds):
        fail('overload: a shed without a positive retry_after_s')
    check_finished('overload', overload, overload_wl, shed_ok=True)
    log(f'[overload] {card}: {overload.shed_requests} of {overload.requests} shed (rate '
        f'{overload.shed_rate:.4f}), retry_after_s {min(r["retry_after_s"] for r in sheds)}..'
        f'{max(r["retry_after_s"] for r in sheds)}; admitted TTFT p99 '
        f'{overload.percentiles["ttft_p99"]} s against the {OVERLOAD_SLO_S} s SLO')
    # Deadline: every window stalls past the deadline.
    engine.config.request_deadline_s = DEADLINE_S
    rng = np.random.default_rng(16)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, size=48)]
               for _ in range(DEADLINE_PROMPTS)]
    injector.arm('slow_window', times=None, delay_s=DEADLINE_STALL_S)
    t0 = time.perf_counter()
    try:
        rids = [engine.add_request(p, SamplingParams(temperature=0.0, max_tokens=64))
                for p in prompts]
        while engine.has_unfinished:
            engine.step()
    finally:
        injector.disarm()
        engine.config.request_deadline_s = CHAOS_RECOVERY['request_deadline_s']
    deadline_s = time.perf_counter() - t0
    finished = [engine._finished.pop(rid) for rid in rids]
    reasons = [r.finish_reason for r in finished]
    if reasons != ['timeout'] * DEADLINE_PROMPTS or any(r.error is None for r in finished):
        fail(f'deadline: finish reasons {reasons}')
    flushed = engine._evict_cached_blocks(engine.prefix_cache.num_evictable)
    free = engine.sched.num_free_blocks
    if free != engine.config.num_blocks - 1 or engine.prefix_cache.num_cached:
        fail(f'deadline: {free} free blocks of {engine.config.num_blocks - 1} after the '
             'timeouts and a cache flush')
    log(f'[deadline] {DEADLINE_PROMPTS} requests stalled {DEADLINE_STALL_S} s a window '
        f'against a {DEADLINE_S} s deadline: {reasons} after '
        f'{[len(r.output_ids) for r in finished]} tokens in {deadline_s:.3f} s; {free} blocks '
        f'free after flushing {flushed} cached ones')
    return dict(clean=report_line(clean), chaos=report_line(chaos), faults_fired=fired,
                token_agreement=agree, overload=report_line(overload),
                deadline=dict(reasons=reasons, tokens=[len(r.output_ids) for r in finished],
                              wall_s=deadline_s, free_blocks=free),
                k1=dict(clean=k1_clean, chaos=k1_chaos, overload=k1_overload))


def http_call(base, path, body=None, method='POST'):
    """``(status, headers, body bytes)``; an HTTP error status is an answer."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f'{base}{path}', data=data, method=method,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def ttft_count(base):
    """``distllm_request_ttft_seconds_count`` read off ``/metrics``, each
    line of which must parse as a comment or a sample."""
    text = http_call(base, '/metrics', method='GET')[2].decode()
    count = None
    for line in text.splitlines():
        if line.startswith('#'):
            continue
        name, value = line.rsplit(' ', 1)
        float(value)
        if name == 'distllm_request_ttft_seconds_count':
            count = float(value)
    if count is None:
        fail('http: /metrics has no distllm_request_ttft_seconds_count')
    return count


LOADINFO_KEYS = {'ready', 'draining', 'queue_depth', 'running', 'in_flight', 'kv_occupancy'}


def phase_load_http(torch, tpa, card, cfg, params):
    """Phase 16c (see the module docstring)."""
    from distllm_tpu_torch.chat import ChatAppConfig
    from distllm_tpu_torch.chat_server import ChatServer
    from distllm_tpu_torch.generate.generators.torch_backend import (
        FakeGenerator,
        FakeGeneratorConfig,
        TorchGenerator,
    )
    from distllm_tpu_torch.generate.loadgen import run_http_loadgen

    app = ChatAppConfig.from_dict({'generator_config': {
        'name': 'torch', 'model': dataclasses.asdict(cfg), 'temperature': 0.0,
        'max_tokens': HTTP_MAX_TOKENS, 'num_blocks': 712, 'max_num_seqs': 32,
        'max_model_len': 512, 'device': DEVICE,
    }})
    gen_cfg = app.build_generator_config()
    if (gen_cfg.request_deadline_s, gen_cfg.max_dispatch_retries,
            gen_cfg.enable_prefix_cache) != (120.0, 2, True):
        fail(f'http: the chat app defaults did not reach the generator config: {gen_cfg}')
    generator = TorchGenerator(gen_cfg, params=params)
    engine = generator.engine
    workload = workload_of(HTTP_LOAD, cfg.vocab_size)
    streams = [i % 4 == 3 for i in range(len(workload))]
    with ChatServer(generator) as server:
        base = f'http://127.0.0.1:{server.port}'
        count0 = ttft_count(base)
        marks, stats0 = graph_marks(engine), dict(engine.stats)
        prefill_rec = instrument_prefill(torch, engine)
        zero_k1_counts(tpa)
        report = run_http_loadgen(base, workload, stream=streams, timeout_s=600.0)
        run = stats_delta(engine, stats0)
        prefills = run.get('prefill_dispatches', 0)
        graphs = check_k1_routes(torch, tpa, 'http', cfg, engine, marks, run['forward_passes'],
                                 prefills, [r['width'] for r in prefill_rec], 'model')
        k1 = dict(launches=tpa.ragged_paged_attention.launches,
                  launches_by_route=dict(tpa.ragged_paged_attention.launches_by_route),
                  forward_passes=run['forward_passes'], prefill_dispatches=prefills, **graphs)
        if report.statuses != [200] * len(workload):
            fail(f'http: statuses {report.statuses}')
        for content, streamed in zip(report.contents, streams):
            if not streamed:
                continue
            events = [e for e in content.split('\n\n') if e]
            if len(events) != 2 or events[1] != 'data: [DONE]':
                fail(f'http: a streamed answer of {len(events)} events: {content[:200]!r}')
            chunk = json.loads(events[0].removeprefix('data: '))
            if chunk['object'] != 'chat.completion.chunk' or 'content' not in chunk[
                    'choices'][0]['delta']:
                fail(f'http: a streamed chunk {chunk}')
        rose = ttft_count(base) - count0
        if rose != len(workload):
            fail(f'http: /metrics TTFT count rose by {rose}, {len(workload)} completions')
        info = json.loads(http_call(base, '/loadinfo', method='GET')[2])
        if set(info) != LOADINFO_KEYS:
            fail(f'http: /loadinfo keys {sorted(info)}')
        status, _, body = http_call(base, '/drain?seconds=30')
        drained = json.loads(body)
        if status != 200 or not drained['drained']:
            fail(f'http: POST /drain answered {status} {drained}')
        health = http_call(base, '/health', method='GET')
        refused = http_call(base, '/v1/chat/completions',
                            {'messages': [{'role': 'user', 'content': 'late'}]})
        if health[0] != 503 or json.loads(health[2])['ready'] is not False:
            fail(f'http: /health after the drain answered {health[0]}')
        if refused[0] != 503 or not refused[1].get('Retry-After'):
            fail(f'http: a completion after the drain answered {refused[0]}')
    generator.shutdown()
    with ChatServer(FakeGenerator(FakeGeneratorConfig(overload_every=2))) as fake:
        base = f'http://127.0.0.1:{fake.port}'
        ask = {'messages': [{'role': 'user', 'content': 'hello'}]}
        first, second = (http_call(base, '/v1/chat/completions', ask) for _ in range(2))
        if first[0] != 200 or second[0] != 429 or not second[1].get('Retry-After'):
            fail(f'http: overload_every 2 answered {first[0]}, {second[0]}')
    p = report.percentiles
    log(f'[http] {card}: {report.ok} of {report.requests} answered 200 ({sum(streams)} '
        f'streamed) in {report.elapsed_s:.3f} s; HTTP TTFT p50/p95/p99 {p["ttft_p50"]:.4f} / '
        f'{p["ttft_p95"]:.4f} / {p["ttft_p99"]:.4f} s (from the scheduled arrival); '
        f'/metrics TTFT count +{rose:.0f}; drain {json.dumps(drained)}, then /health '
        f'{health[0]} and a completion {refused[0]} (Retry-After {refused[1]["Retry-After"]}); '
        f'fake overload 429 with Retry-After {second[1]["Retry-After"]}; K1 '
        f'{json.dumps(k1["launches_by_route"])}')
    return dict(report=report.to_fragment(''), k1=k1, drain=drained,
                ttft_count_rose=rose, loadinfo=info)


def phase_load_identity(torch, tpa, cfg):
    """Phase 16d (see the module docstring): fp32 at depth 2, a burst of
    32 greedy requests with fixed batches, through K1 and the plain op."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mistral
    from distllm_tpu_torch.resilience.faults import get_fault_injector

    params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    rng = np.random.default_rng(1616)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, size=int(n))]
               for n in rng.integers(16, 160, size=LOAD_IDENTITY_PROMPTS)]
    greedy = SamplingParams(temperature=0.0, max_tokens=24)
    injector = get_fault_injector()

    def burst(engine):
        rids = [engine.add_request(p, greedy) for p in prompts]
        while engine.has_unfinished:
            engine.step()
        return [engine._finished.pop(rid).output_ids for rid in rids]

    out, tokens = {}, {}
    for backend in ('auto', 'reference'):
        tag = f'load identity {backend}'
        engine = LLMEngine(cfg, params, None, EngineConfig(
            block_size=BLOCK_SIZE, num_blocks=512, max_num_seqs=LOAD_IDENTITY_PROMPTS,
            max_model_len=512, decode_steps=8, max_dispatch_retries=3, retry_backoff_s=0.0,
        ), device=DEVICE, attn_backend=backend)
        engine.warmup()
        zero_k1_counts(tpa)
        on = burst(engine)
        engine.attribution = False
        off = burst(engine)
        engine.attribution = True
        injector.disarm()
        injector.arm('dispatch', times=2)
        retries0 = engine.stats['window_retries']
        try:
            faulted = burst(engine)
            fired = injector.fired('dispatch')
        finally:
            injector.disarm()
        retries = engine.stats['window_retries'] - retries0
        kernel, plain = (tpa.ragged_paged_attention.launches,
                         tpa.ragged_paged_attention_reference.launches)
        log(f'[{tag}] attribution off == on: {off == on}; dispatch x{fired} under 3 retries '
            f'({retries} retries) == clean: {faulted == on}; K1 {kernel} launches, plain op '
            f'{plain}')
        if off != on or faulted != on or fired != 2 or retries < 2:
            fail(f'{tag}: attribution off == on {off == on}, faulted == clean '
                 f'{faulted == on}, {fired} fires, {retries} retries')
        if (backend == 'auto') != (kernel > 0 and plain == 0) or (
                backend == 'reference') != (plain > 0 and kernel == 0):
            fail(f'{tag}: K1 {kernel} and plain {plain} launches')
        tokens[backend] = on
        out[backend] = dict(k1_launches=kernel, plain_launches=plain, retries=retries)
        shut_down(torch, tag, engine)
        del engine
    out['k1_vs_plain_agreement'] = greedy_match(tokens['auto'], tokens['reference'])
    log(f'[load identity] K1 vs plain tokens agreeing {out["k1_vs_plain_agreement"]:.4f}')
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- phases 17-17d
# Phase 17: the pipelined generate_ids at Mistral-7B widths (PIPE_LAYERS
# layers, bf16, seed 0's weights): block 16, 32 slots, 640-token rows, 16-step
# windows; 128 greedy prompts of 32..512 tokens, 64..128 new each. Its depth
# is cut from 32 (to 16, then 8) to keep the whole run's time (a
# closed loop, unlike phase 16's open one, whose time the arrivals set: at
# 16 layers it took as long).
PIPE_LAYERS = 8
PIPE_ENGINE = dict(block_size=BLOCK_SIZE, num_blocks=1400, max_num_seqs=32,
                   max_model_len=640, decode_steps=16)
PIPE_PROMPTS, PIPE_LENS, PIPE_NEW, PIPE_STOPS = 64, (32, 512), (64, 128), 4
PIPE_ARMS = (('depth1', 1, False), ('depth2', 2, False), ('depth2_defer', 2, True))


def pipe_workload(vocab_size, n=None, lens=PIPE_LENS, new=PIPE_NEW, seed=17):
    """``n`` prompts of ``lens`` tokens (evenly spaced, shuffled; numpy
    ``seed``) and each one's new-token budget in ``new``."""
    n = n or PIPE_PROMPTS
    rng = np.random.default_rng(seed)
    lengths = np.linspace(*lens, n).astype(int)
    rng.shuffle(lengths)
    prompts = [[int(t) for t in rng.integers(4, vocab_size, size=int(m))] for m in lengths]
    return prompts, [int(m) for m in rng.integers(new[0], new[1] + 1, size=n)]


def stop_ids_of(outputs, k, lo=8, hi=64):
    """The ``k`` tokens most frequent at positions ``lo..hi`` of the
    streams and at none before ``lo``: taken as stop ids, they stop rows
    inside windows, never at their first tokens."""
    from collections import Counter

    early = {t for out in outputs for t in out[:lo]}
    counts = Counter(t for out in outputs for t in out[lo:hi] if t not in early)
    return tuple(t for t, _ in counts.most_common(k))


def instrument_device(torch, engine):
    """CUDA events around each window's replays and each prefill dispatch,
    and the host clock where each window's replays begin and end being
    enqueued: the device timeline's gaps between windows and its busy
    share, with no sync added (the events are read after the run)."""
    rec = dict(windows=[], prefills=[])
    run, dispatch = engine._decode.run, engine._dispatch_prefill_paged

    def timed_run(num_steps, all_greedy):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        out = run(num_steps, all_greedy)
        end.record()
        rec['windows'].append((t0, time.perf_counter(), start, end))
        return out

    def timed_prefill(spans, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = dispatch(spans, **kwargs)
        end.record()
        rec['prefills'].append((start, end))
        return out

    engine._decode.run = timed_run
    engine._dispatch_prefill_paged = timed_prefill
    return rec


def device_timeline(torch, rec, loop_s):
    """Gaps between consecutive windows (the host's, from the last replay
    enqueued to the next window's first; the device's, from the end of one
    window's replays to the start of the next's) and the device's busy
    share (window replays and prefill dispatches over the loop's wall)."""
    torch.cuda.synchronize()
    windows = rec['windows']
    host = [(b[0] - a[1]) * 1e3 for a, b in zip(windows, windows[1:])]
    device = [a[3].elapsed_time(b[2]) for a, b in zip(windows, windows[1:])]
    busy = sum(w[2].elapsed_time(w[3]) for w in windows) + sum(
        s.elapsed_time(e) for s, e in rec['prefills'])
    return dict(
        host_gap_ms_median=median(host), host_gap_ms_sum=float(sum(host)),
        device_gap_ms_median=median(device), device_gap_ms_p90=(
            float(np.percentile(device, 90)) if device else None),
        device_gap_ms_sum=float(sum(device)), window_device_ms_median=median(
            [w[2].elapsed_time(w[3]) for w in windows]),
        busy_share=busy / (loop_s * 1e3) if loop_s > 0 else None,
    )


def unwrap(engine, *names):
    """Drop instance-level wrappers, back to the class's methods."""
    for name in names:
        engine.__dict__.pop(name, None)


def phase_pipeline(torch, tpa, card, cfg, params):
    """Phase 17: one ``LLMEngine`` (the default scheduler), warmed up; a
    short first run without stops (48 prompts, 64 tokens) picks the stop
    ids; then the arms of
    ``PIPE_ARMS`` (``pipeline_depth`` 1, 2, and 2 with ``defer_prefill``)
    over the same prompts with those stops. Per arm: tok/s, wall, eager
    prefill host ms, the gaps between windows on the host's clock and the
    device's, the busy share, ``overshoot_frac``, the share of tokens
    agreeing with depth 1 (bf16: recorded), K1 launches by route. K1 runs
    layers x passes on each pass's route, every decode step a replay; the
    depth-2 arms overshoot; the measured MFU and bandwidth shares of every
    decode window of every arm (K1 priced at the lengths it ran) lie in
    (0, 1.05]."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.observability import instruments

    engine = LLMEngine(cfg, params, None, EngineConfig(**PIPE_ENGINE), device=DEVICE)
    engine.warmup()
    prompts, new = pipe_workload(cfg.vocab_size)
    # The stop ids come from a short first run: the first 48 prompts, 64
    # new tokens each.
    first = engine.generate_ids(prompts[:48], SamplingParams(temperature=0.0, max_tokens=64))
    stops = stop_ids_of(first, PIPE_STOPS)
    sampling = [SamplingParams(temperature=0.0, max_tokens=n, stop_token_ids=stops) for n in new]
    arms = {}
    for name, depth, defer in PIPE_ARMS:
        tag = f'pipeline {name}'
        engine.config.pipeline_depth, engine.config.defer_prefill = depth, defer
        rec = instrument_windows(torch, engine)
        dev = instrument_device(torch, engine)
        marks, stats0 = graph_marks(engine), dict(engine.stats)
        ring0 = engine.flight.total_recorded
        zero_k1_counts(tpa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = engine.generate_ids(prompts, sampling)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        unwrap(engine, '_dispatch_prefill_paged', '_run_chunk_half', '_dispatch_window',
               '_process_window')
        unwrap(engine._decode, 'run')
        run, tele = stats_delta(engine, stats0), dict(engine.telemetry)
        passes, eager = run['forward_passes'], run.get('prefill_dispatches', 0)
        graphs = check_k1_routes(torch, tpa, tag, cfg, engine, marks, passes, eager,
                                 [r['width'] for r in rec['prefill']], 'model')
        arms[name] = dict(
            tokens=tokens, pipeline_depth=tele['pipeline_depth'], defer_prefill=defer,
            tokens_per_s=tele['tokens_per_s'], wall_s=wall_s, loop_s=tele['loop_s'],
            generated_tokens=run['generated_tokens'],
            overshoot_tokens=run.get('overshoot_tokens', 0),
            overshoot_frac=tele.get('overshoot_frac'), windows=run['decode_windows'],
            windows_per_s=tele.get('windows_per_s'), prefill_dispatches=eager,
            prefill_host_ms=sum(r['wall_ms'] for r in rec['prefill']),
            k1_launches=tpa.ragged_paged_attention.launches,
            k1_launches_by_route=dict(tpa.ragged_paged_attention.launches_by_route),
            scheduler=tele['scheduler'],
            **device_timeline(torch, dev, tele['loop_s']), **graphs,
        )
        if tele['pipeline_depth'] != depth:
            fail(f'{tag}: ran at depth {tele["pipeline_depth"]}, asked {depth}')
        # Every decode window's measured shares (K1 priced at the lengths
        # it ran), and the gauges as the last window left them.
        windows = [r for r in new_records(engine.flight, ring0)
                   if r['kind'] == 'decode' and 'mfu_measured' in r]
        if not windows:
            fail(f'{tag}: no decode window carries measured shares')
        measured = {
            'mfu': instruments.ENGINE_MFU_MEASURED.labels(kind='decode').value,
            'bw_util': instruments.ENGINE_BW_UTIL_MEASURED.labels(kind='decode').value,
            'flops_ratio': instruments.ENGINE_ROOFLINE_FLOPS_RATIO.labels(kind='decode').value,
            'bytes_ratio': instruments.ENGINE_ROOFLINE_BYTES_RATIO.labels(kind='decode').value,
            'windows': len(windows),
        }
        for key in ('mfu', 'bw_util'):
            shares = [r[f'{key}_measured'] for r in windows]
            measured[f'{key}_min'], measured[f'{key}_median'], measured[f'{key}_max'] = (
                min(shares), median(shares), max(shares))
            if not 0 < min(shares) <= max(shares) <= SHARE_CAP:
                fail(f'{tag}: measured {key} {min(shares)}..{max(shares)} over '
                     f'{len(windows)} windows outside (0, {SHARE_CAP}]')
        arms[name]['measured'] = measured
    base = arms['depth1']['tokens']
    for name, arm in arms.items():
        arm['agreement_with_depth1'] = greedy_match(base, arm.pop('tokens'))
        log(f'[pipeline {name}] {card}: {arm["tokens_per_s"]:.1f} tok/s, loop '
            f'{arm["loop_s"]:.3f} s, {arm["windows"]} windows, {arm["prefill_dispatches"]} '
            f'prefills ({arm["prefill_host_ms"]:.1f} host ms), gap host / device median '
            f'{arm["host_gap_ms_median"]} / {arm["device_gap_ms_median"]} ms, busy share '
            f'{arm["busy_share"]:.4f}, overshoot_frac {arm["overshoot_frac"]}, agreeing with '
            f'depth 1 {arm["agreement_with_depth1"]:.4f}, K1 by route '
            f'{json.dumps(arm["k1_launches_by_route"])}, measured decode shares '
            f'{json.dumps(arm["measured"])}')
    if not (arms['depth2']['overshoot_tokens'] > 0 and arms['depth2_defer']['overshoot_tokens'] > 0):
        fail(f'pipeline: no overshoot at depth 2: {json.dumps(arms)}')
    shut_down(torch, 'pipeline', engine)
    del engine
    return dict(arms=arms, stop_ids=list(stops), engine=PIPE_ENGINE,
                prompts=PIPE_PROMPTS, prompt_lens=PIPE_LENS, new_tokens=PIPE_NEW)


# Phase 17b: full width, depth 2, fp32.
PIPE_ID_ENGINE = dict(block_size=BLOCK_SIZE, num_blocks=512, max_num_seqs=8,
                      max_model_len=512, decode_steps=8)
PIPE_ID_ARMS = {
    'depth1': dict(pipeline_depth=1),
    'depth2': dict(pipeline_depth=2),
    'depth3': dict(pipeline_depth=3),
    'defer': dict(pipeline_depth=2, defer_prefill=True),
    'mixed': dict(pipeline_depth=2, enable_mixed_batching=True, enable_prefix_cache=True,
                  prefill_chunk_tokens=64),
}


def phase_pipeline_identity(torch, tpa, cfg):
    """Phase 17b: 24 greedy prompts of 16..300 tokens (24 new each, stop
    ids from the first arm's streams) through every arm of
    ``PIPE_ID_ARMS``, each on K1 and on the plain op, each engine warmed
    up: tokens identical to depth 1 on K1; overshoot in some arm; the
    native scheduler in every engine (asked for); K1 (or the plain op) layers x
    passes, every decode step a replay."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mistral

    params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(17), device=DEVICE)
    prompts, _ = pipe_workload(cfg.vocab_size, n=24, lens=(16, 300), seed=171)
    outs, stats, stops = {}, {}, None
    for backend in ('auto', 'reference'):
        for name, extra in PIPE_ID_ARMS.items():
            tag = f'pipeline identity {name} {backend}'
            engine = LLMEngine(cfg, params, None, EngineConfig(
                **PIPE_ID_ENGINE, **extra, prefer_native_allocator=True),
                device=DEVICE, attn_backend=backend)
            engine.warmup()
            if stops is None:
                probe = engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=24))
                stops = stop_ids_of(probe, 3, lo=4, hi=20)
            marks = graph_marks(engine)
            zero_k1_counts(tpa)
            outs[(name, backend)] = engine.generate_ids(
                prompts, SamplingParams(temperature=0.0, max_tokens=24, stop_token_ids=stops))
            tele = engine.telemetry
            passes = tele['forward_passes']
            eager = tele.get('prefill_dispatches', 0) + tele.get('mixed_windows', 0)
            check_graph_replays(tag, engine, marks, passes, eager)
            counted, other = (tpa.ragged_paged_attention.launches,
                              tpa.ragged_paged_attention_reference.launches)
            if backend == 'reference':
                counted, other = other, counted
            if counted != cfg.num_layers * passes or other != 0:
                fail(f'{tag}: {counted} attention calls for {passes} passes ({other} other)')
            if engine.scheduler_kind != 'native':
                fail(f'{tag}: the {engine.scheduler_kind} scheduler')
            stats[f'{name}_{backend}'] = {k: tele.get(k, 0) for k in (
                'pipeline_depth', 'overshoot_tokens', 'decode_windows', 'mixed_windows',
                'prefill_dispatches', 'forward_passes')}
            shut_down(torch, tag, engine)
            del engine
    ref = outs[('depth1', 'auto')]
    same = {f'{n}_{b}': out == ref for (n, b), out in outs.items()}
    log(f'[pipeline identity] fp32 depth-2 full width, 24 prompts x 24 greedy tokens, stops '
        f'{list(stops)}: identical to depth 1 on K1: {json.dumps(same)}; stats {json.dumps(stats)}')
    if not all(same.values()):
        fail(f'pipeline identity: fp32 greedy tokens differ: {same}')
    if not any(s['overshoot_tokens'] > 0 for s in stats.values()):
        fail('pipeline identity: no overshoot in any arm')
    if not stats['mixed_auto']['mixed_windows'] > 0:
        fail('pipeline identity: no mixed window rode the pipeline')
    del params
    torch.cuda.empty_cache()
    return dict(identical=same, stats=stats, stop_ids=list(stops), scheduler='native')


# Phase 17c: a checkpoint directory written on the card from a seed.
CKPT_HF = {
    'model_type': 'mistral', 'vocab_size': 32000, 'hidden_size': 4096,
    'intermediate_size': 14336, 'num_hidden_layers': 2, 'num_attention_heads': 32,
    'num_key_value_heads': 8, 'max_position_embeddings': 32768, 'rms_norm_eps': 1e-5,
    'rope_theta': 10000.0, 'sliding_window': 4096, 'tie_word_embeddings': False,
    'torch_dtype': 'bfloat16',
}
CKPT_SERVE = dict(temperature=0.0, max_tokens=32, block_size=BLOCK_SIZE, num_blocks=512,
                  max_num_seqs=16, max_model_len=1024)
CKPT_PROMPTS = 16


def write_checkpoint(torch, root: Path, params, cfg, eos_ids=None):
    """An HF checkpoint directory of ``params`` (the port's tree, on the
    card): ``model.safetensors`` in HF key names (Linear weights back to
    ``[out, in]``), ``config.json``, a word-level fast tokenizer built with
    ``tokenizers`` (``tokenizer.json``, ``tokenizer_config.json``), and,
    with ``eos_ids``, a ``generation_config.json`` naming them."""
    from safetensors.torch import save_file

    root.mkdir(parents=True, exist_ok=True)
    if eos_ids is not None:
        (root / 'generation_config.json').write_text(json.dumps({'eos_token_id': list(eos_ids)}))
        return root
    layers = params['layers']

    def host(x):
        return x.detach().contiguous().cpu()

    state = {'model.embed_tokens.weight': host(params['embed']),
             'model.norm.weight': host(params['final_ln']['scale']),
             'lm_head.weight': host(params['lm_head'].T)}
    hf_names = {'q': 'self_attn.q_proj', 'k': 'self_attn.k_proj', 'v': 'self_attn.v_proj',
                'o': 'self_attn.o_proj', 'gate': 'mlp.gate_proj', 'up': 'mlp.up_proj',
                'down': 'mlp.down_proj'}
    for i in range(cfg.num_layers):
        p = f'model.layers.{i}'
        for key, hf in hf_names.items():
            state[f'{p}.{hf}.weight'] = host(layers[key]['kernel'][i].T)
        state[f'{p}.input_layernorm.weight'] = host(layers['attn_ln']['scale'][i])
        state[f'{p}.post_attention_layernorm.weight'] = host(layers['mlp_ln']['scale'][i])
    save_file(state, str(root / 'model.safetensors'))
    (root / 'config.json').write_text(json.dumps(CKPT_HF))
    write_word_tokenizer(root, cfg.vocab_size, CKPT_SERVE['max_model_len'])
    return root


def write_word_tokenizer(root: Path, vocab_size: int, max_len: int) -> None:
    """A word-level fast tokenizer of ``vocab_size`` ids built with
    ``tokenizers`` (``tokenizer.json``, ``tokenizer_config.json``): four
    special tokens, then ``w0``, ``w1``, ..."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {'[UNK]': 0, '[PAD]': 1, '<s>': 2, '</s>': 3}
    vocab.update({f'w{i}': i + 4 for i in range(vocab_size - 4)})
    tok = Tokenizer(WordLevel(vocab, unk_token='[UNK]'))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(root / 'tokenizer.json'))
    (root / 'tokenizer_config.json').write_text(json.dumps({
        'tokenizer_class': 'PreTrainedTokenizerFast', 'pad_token': '[PAD]',
        'unk_token': '[UNK]', 'model_max_length': max_len}))


def checkpoint_prompts(n=CKPT_PROMPTS):
    rng = np.random.default_rng(18)
    lengths = np.linspace(24, 400, n).astype(int)
    return [' '.join(f'w{int(i)}' for i in rng.integers(0, 31000, size=int(m))) for m in lengths]


def phase_checkpoint_serve(torch, tpa, tqm, card, tmp: Path):
    """Phase 17c: Mistral-7B widths with 2 layers (bf16, seed 18) written
    as a checkpoint directory; a probe engine over the same tensors gives
    the two EOS ids of ``generation_config.json`` (the most frequent
    tokens of its streams); a chat YAML with ``pretrained_model_name_or_path``
    then builds the generator (``ChatAppConfig.build_generator``, through
    the registry) in bf16 and with ``quantization: int8``. Each serves the prompts with
    generation_config's stops: tokens identical to an engine built on the
    same tensors directly; K1 on the serving path, K2 in the int8 arm
    (launches > 0, the plain versions never); the weight load a
    ``weight_load`` start-up phase."""
    import yaml

    from distllm_tpu_torch.chat import ChatAppConfig
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mistral
    from distllm_tpu_torch.models.tokenizer import HFTokenizer
    from distllm_tpu_torch.observability.startup import get_compile_watcher

    cfg = mistral.MistralConfig.from_hf_config(CKPT_HF)
    params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(18), device=DEVICE)
    root = tmp / 'mistral-7b-2l'
    t0 = time.perf_counter()
    write_checkpoint(torch, root, params, cfg)
    write_s = time.perf_counter() - t0
    texts = checkpoint_prompts()
    # The EOS ids: the two tokens most frequent in a direct engine's greedy
    # streams over the checkpoint's tokenizer, so generation_config's stops
    # stop rows.
    batch = HFTokenizer(str(root))(texts)
    probe = LLMEngine(cfg, params, None, EngineConfig(**{
        k: CKPT_SERVE[k] for k in ('block_size', 'num_blocks', 'max_num_seqs', 'max_model_len')
    }), device=DEVICE)
    eos = stop_ids_of(probe.generate_ids(
        [[int(t) for t, m in zip(r, mk) if m] for r, mk in zip(batch.input_ids, batch.attention_mask)],
        SamplingParams(temperature=0.0, max_tokens=CKPT_SERVE['max_tokens']),
    ), 2, lo=2, hi=24)
    shut_down(torch, 'checkpoint probe', probe)
    del probe
    write_checkpoint(torch, root, params, cfg, eos_ids=eos)
    results, generators = {}, {}
    for arm, quant in (('bf16', None), ('int8', 'int8')):
        tag = f'checkpoint {arm}'
        app_yaml = tmp / f'chat_{arm}.yaml'
        gen_cfg = {'name': 'tpu', 'pretrained_model_name_or_path': str(root), **CKPT_SERVE}
        if quant:
            gen_cfg['quantization'] = quant
        app_yaml.write_text(yaml.safe_dump({'system_prompt': 'Be brief.',
                                            'generator_config': gen_cfg}))
        phases = len(get_compile_watcher().state()['phases'])
        t0 = time.perf_counter()
        generator = ChatAppConfig.from_yaml(str(app_yaml)).build_generator(device=DEVICE)
        build_s = time.perf_counter() - t0
        loads = [p for p in get_compile_watcher().state()['phases'][phases:]
                 if p['phase'] == 'weight_load']
        sampling = generator.sampling_params()
        if (generator.tokenizer.eos_id, sampling.stop_token_ids) != (eos[0], tuple(eos[1:])):
            fail(f'{tag}: EOS {generator.tokenizer.eos_id} and stops {sampling.stop_token_ids}, '
                 f'expected {eos[0]} and {eos[1:]}')
        batch = generator.tokenizer(texts)
        ids = [[int(t) for t, m in zip(r, mk) if m]
               for r, mk in zip(batch.input_ids, batch.attention_mask)]
        zero_k1_counts(tpa)
        zero_k2_counts(tqm)
        t0 = time.perf_counter()
        served = generator.engine.generate_ids(ids, sampling)
        serve_s = time.perf_counter() - t0
        k1, k2 = tpa.ragged_paged_attention.launches, tqm.int8_matmul.launches
        k2_routes = dict(tqm.int8_matmul.launches_by_route)
        direct = LLMEngine(cfg, params, generator.tokenizer, generator.config.engine_config(),
                           device=DEVICE)
        direct.warmup()
        same = direct.generate_ids(ids, sampling) == served
        text = generator.generate(texts[:2])
        shut_down(torch, f'{tag} direct', direct)
        del direct
        results[arm] = dict(
            identical_to_direct=same, build_s=build_s, serve_s=serve_s,
            weight_load_s=loads[-1]['duration_s'] if loads else None,
            tokens=sum(map(len, served)), stopped=sum(len(o) < CKPT_SERVE['max_tokens']
                                                      for o in served),
            k1_launches=k1, k2_launches=k2, k2_launches_by_route=k2_routes,
            eos_id=eos[0], stop_ids=list(eos[1:]),
            weight_bytes=generator.engine.weight_bytes_quantized,
        )
        log(f'[{tag}] {card}: built from {root.name} in {build_s:.2f} s (weight load '
            f'{results[arm]["weight_load_s"]} s), {results[arm]["tokens"]} tokens in '
            f'{serve_s:.3f} s, {results[arm]["stopped"]} rows stopped early; identical to the '
            f'direct engine={same}; K1 {k1}, K2 {k2} {json.dumps(k2_routes)}; text '
            f'{json.dumps(text)[:120]}')
        if not same:
            fail(f'{tag}: tokens differ from an engine built on the same tensors')
        if not loads or k1 <= 0 or tpa.ragged_paged_attention_reference.launches:
            fail(f'{tag}: weight_load phases {loads}, K1 {k1}, plain '
                 f'{tpa.ragged_paged_attention_reference.launches}')
        if quant and (k2 <= 0 or tqm.int8_matmul_reference.launches):
            fail(f'{tag}: K2 launches {k2}, plain {tqm.int8_matmul_reference.launches}')
        if not quant and k2:
            fail(f'{tag}: K2 launched {k2} times on bf16 weights')
        generators[arm] = generator
    del params
    return dict(results, write_s=write_s, checkpoint_gib=sum(
        f.stat().st_size for f in root.iterdir()) / 2**30), generators['int8']


# Phase 17d: the A6b series that must move on the card (ROADMAP A6b).
A6B_SERIES = (
    'distllm_engine_overshoot_tokens_total', 'distllm_profiler_captures_total',
    'distllm_history_samples_total', 'distllm_history_sample_duration_seconds_count',
    'distllm_history_sample_errors_total', 'distllm_slo_burn_rate',
    'distllm_sentinel_regressions_total', 'distllm_sentinel_armed',
    'distllm_sentinel_disarmed_total', 'distllm_watchdog_stalls_total',
    'distllm_debug_bundles_total', 'distllm_stage_duration_seconds_count',
    'distllm_engine_mfu_measured', 'distllm_engine_bandwidth_utilization_measured',
    'distllm_engine_roofline_flops_ratio', 'distllm_engine_roofline_bytes_ratio',
    'distllm_engine_kv_dispatch_bytes', 'distllm_compile_seconds_count',
    'distllm_compile_cache_hits_total',
)


def series_values(text):
    """``{name: [values]}`` of a Prometheus exposition, labels dropped."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith('#'):
            key, value = line.rsplit(' ', 1)
            out.setdefault(key.split('{')[0], []).append(float(value))
    return out


def get_json(base, path, timeout=120):
    with urllib.request.urlopen(f'{base}{path}', timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def phase_debug_surface(torch, tpa, card, generator, tmp: Path):
    """Phase 17d: ``ChatServer`` over 17c's int8 generator, with the
    regression sentinel armed from an envelope file (``DISTLLM_BASELINE``:
    1e6 tok/s, so it fires; a server built first on a missing file counts
    a disarm) and debug dumps under the phase's directory. Eight completions, then every ``/debug/*`` route:
    ``perfetto`` valid with the four window-kind tracks, ``history`` with
    samples, ``slo``, ``bundle`` (a directory with the device facts),
    ``xprof?seconds=2`` under load (its trace names K1's kernel),
    ``traces`` and ``flight``; a ``slow_window`` fault of 2.5 s under a
    1 s ``DISTLLM_WATCHDOG_S`` fires the watchdog and dumps a bundle; the
    compile series count the kernel builds and the graph captures; every
    series of ``A6B_SERIES`` moves."""
    import os

    from distllm_tpu_torch.chat_server import ChatServer
    from distllm_tpu_torch.observability.history import get_metrics_history
    from distllm_tpu_torch.observability.metrics import render_prometheus
    from distllm_tpu_torch.observability.perfetto import validate_trace_events
    from distllm_tpu_torch.resilience.faults import get_fault_injector

    debug_dir = tmp / 'debug'
    envelope = tmp / 'envelope.json'
    envelope.write_text(json.dumps({
        'schema': 'distllm-baseline-envelope/v1', 'source': 'phase 17d',
        'metrics': {'tok_s': {'value': 1e6, 'direction': 'higher', 'from_key': 'tok_s'}},
    }))
    env = {'DISTLLM_DEBUG_DIR': str(debug_dir), 'DISTLLM_BASELINE': str(envelope)}
    saved = {k: os.environ.get(k) for k in (*env, 'DISTLLM_WATCHDOG_S')}
    os.environ.update(env)
    failing = {'n': 0}

    def failing_once(history, now):
        if failing['n'] == 0:
            failing['n'] += 1
            raise RuntimeError('an observer that fails once')

    history = get_metrics_history()
    history.add_observer(failing_once)
    # A server started on a baseline file that is not there: the sentinel's
    # counted disarm. Then the one this phase drives, armed.
    os.environ['DISTLLM_BASELINE'] = str(tmp / 'missing-envelope.json')
    ChatServer(generator).close()
    os.environ['DISTLLM_BASELINE'] = str(envelope)
    server = ChatServer(generator).start()
    base = f'http://127.0.0.1:{server.port}'
    out = {}
    try:
        for i in range(8):
            status, _ = post_completion(server.port, i)
            if status != 200:
                fail(f'debug surface: completion {i} answered {status}')
        time.sleep(2.5)  # history ticks with traffic behind them
        status, doc = get_json(base, '/debug/perfetto')
        problems = validate_trace_events(doc)
        tracks = {e['args']['name'] for e in doc['traceEvents']
                  if e.get('ph') == 'M' and e.get('name') == 'thread_name'}
        slices = {}
        for e in doc['traceEvents']:
            if e.get('cat') == 'engine_step':
                slices[e['name']] = slices.get(e['name'], 0) + 1
        out['perfetto'] = dict(status=status, events=len(doc['traceEvents']),
                               problems=problems[:5], tracks=sorted(tracks), slices=slices)
        if status != 200 or problems or not all(
                f'engine:{k}' in tracks for k in ('prefill', 'decode', 'mixed', 'spec')):
            fail(f'debug surface: perfetto {out["perfetto"]}')
        status, hist = get_json(base, '/debug/history')
        out['history'] = dict(status=status, samples=hist['samples'],
                              series=len(hist['series']), sampler_running=hist['sampler_running'])
        if status != 200 or hist['samples'] < 1 or not hist['sampler_running']:
            fail(f'debug surface: history {out["history"]}')
        status, slo = get_json(base, '/debug/slo')
        out['slo'] = dict(status=status, verdict=slo['verdict'], sentinel=slo['sentinel'])
        if status != 200 or not slo['sentinel']['armed']:
            fail(f'debug surface: slo {out["slo"]}')
        status, bundle = get_json(base, '/debug/bundle')
        device = json.loads(Path(bundle['paths']['device']).read_text())
        out['bundle'] = dict(status=status, files=sorted(bundle['paths']),
                             device=device.get('name'), cuda_initialized=device['cuda_initialized'])
        if status != 200 or not (Path(bundle['bundle_dir']) / 'meta.json').exists() or not (
                device['cuda_initialized'] and device['kernels']):
            fail(f'debug surface: bundle {out["bundle"]}')
        for path in ('/debug/traces?limit=20', '/debug/flight?limit=20'):
            status, body = get_json(base, path)
            if status != 200 or not body:
                fail(f'debug surface: {path} answered {status}')
        stop = threading.Event()

        def load():
            i = 100
            while not stop.is_set():
                post_completion(server.port, i)
                i += 1

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        try:
            time.sleep(0.3)
            status, xprof = get_json(base, '/debug/xprof?seconds=2')
        finally:
            stop.set()
            loader.join(120)
        trace = json.loads((Path(xprof['trace_dir']) / 'trace.json').read_text())
        k1_events = sum(1 for e in trace['traceEvents']
                        if 'ragged_paged_attention' in str(e.get('name', '')))
        kernels = sum(1 for e in trace['traceEvents'] if e.get('cat') == 'kernel')
        out['xprof'] = dict(status=status, ok=xprof['ok'], events=len(trace['traceEvents']),
                            kernel_events=kernels, k1_events=k1_events)
        if status != 200 or not xprof['ok'] or k1_events <= 0:
            fail(f'debug surface: xprof {out["xprof"]}')
        # The watchdog: one window stalls 2.5 s under a 1 s watchdog.
        os.environ['DISTLLM_WATCHDOG_S'] = '1'
        stalls = series_values(render_prometheus()).get('distllm_watchdog_stalls_total', [0])[0]
        get_fault_injector().arm('slow_window', times=1, delay_s=2.5)
        try:
            status, _ = post_completion(server.port, 7)
        finally:
            get_fault_injector().disarm('slow_window')
            os.environ.pop('DISTLLM_WATCHDOG_S', None)
        dumps = sorted(p.name for p in debug_dir.iterdir() if p.name.startswith('watchdog_'))
        after = series_values(render_prometheus()).get('distllm_watchdog_stalls_total', [0])[0]
        out['watchdog'] = dict(status=status, bundles=dumps, stalls=after - stalls)
        if status != 200 or not dumps or after - stalls < 1 or not (
                debug_dir / dumps[-1] / 'meta.json').exists():
            fail(f'debug surface: watchdog {out["watchdog"]}')
    finally:
        server.close()
        history.remove_observer(failing_once)
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    # The compile series: every kernel build and both decode-graph captures.
    text = render_prometheus()
    compile_counts = {}
    for line in text.splitlines():
        if line.startswith('distllm_compile_seconds_count{'):
            key, value = line.rsplit(' ', 1)
            compile_counts[key[len('distllm_compile_seconds_count'):]] = float(value)
    builds = sum(v for k, v in compile_counts.items() if 'kind="kernel_build"' in k)
    captures = sum(v for k, v in compile_counts.items() if 'kind="decode_window"' in k)
    out['compile'] = dict(kernel_builds=builds, decode_captures=captures,
                          phases=len(compile_counts))
    if builds < 3 or captures < 1:
        fail(f'debug surface: compile series {compile_counts}')
    values = series_values(text)
    moved = {name: max(values.get(name, [0.0])) for name in A6B_SERIES}
    # A burn rate of 0 is a reading (no missed SLO): the gauge must exist.
    still = [n for n, v in moved.items() if v <= 0 and n != 'distllm_slo_burn_rate']
    out['series'] = moved
    log(f'[debug surface] {card}: {json.dumps(out)}')
    if still or 'distllm_slo_burn_rate' not in values:
        fail(f'debug surface: series still at zero: {still}')
    return out


# ------------------------------------------------------------ phases 18-18d
# The MCQA harness, the booted server and the CLI (ROADMAP A11a).
# 16 questions (cut from 64, then 32, to keep the run's time).
MCQA_CHUNKS, MCQA_FILES, MCQA_QUESTIONS, MCQA_TOP_K = 4096, 4, 16, 3
# The run's knobs: 8 workers, client batches of 16; the server answers
# with its generator's max_tokens (RAG_NEW), as the JAX server does.
MCQA_RUN = dict(parallel_workers=8, batch_size=16, batch_timeout=0.5, request_max_tokens=32,
                checkpoint_every=16, retrieval_top_k=MCQA_TOP_K)
# 18b asks 8 questions (cut from 16 to keep the run's time).
MCQA_BOOT_QUESTIONS, MCQA_IDENTITY_QUESTIONS, MCQA_IDENTITY_NEW = 8, 16, 16
# The booted server's engine (vLLM's argument names). Its generator keeps
# the JAX default of 2000 tokens, so max_model_len bounds each answer.
MCQA_BOOT_VLLM = dict(tensor_parallel_size=1, max_model_len=256, max_num_seqs=16,
                      block_size=BLOCK_SIZE, num_blocks=512)
CLI_ROWS, CLI_EMBED_TEXTS, CLI_EMBED_LAYERS = 16, 512, 4
# The fake grader's answer: one JSON verdict (braces doubled for format).
GRADER_VERDICT = '{{"correct": true, "reason": "fake grader"}}'
# The keys of the JAX harness's results.json.
MCQA_SUMMARY_KEYS = {'total_questions', 'graded', 'correct', 'accuracy', 'errors', 'elapsed_s',
                     'throughput_qps', 'batches_sent', 'model', 'questions_file'}
MCQA_RESULT_KEYS = {'entry', 'answer', 'retrieval', 'correct', 'grader_reason',
                    'grader_ladder_level'}


def write_bert_checkpoint(torch, root: Path, cfg, seed, word='w'):
    """An HF BERT checkpoint directory of random weights made on the card
    (seed ``seed``): ``model.safetensors`` in ``BertModel`` key names,
    ``config.json`` and a ``BertTokenizerFast`` over ``<word><i>`` words."""
    from safetensors.torch import save_file
    from transformers import BertTokenizerFast

    from distllm_tpu_torch.models import bert

    root.mkdir(parents=True, exist_ok=True)
    vocab = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]'] + [
        f'{word}{i}' for i in range(cfg.vocab_size - 5)]
    (root / 'vocab.txt').write_text('\n'.join(vocab) + '\n')
    BertTokenizerFast(vocab_file=str(root / 'vocab.txt')).save_pretrained(root)
    params = bert.init(cfg, torch.Generator(device=DEVICE).manual_seed(seed), device=DEVICE,
                       dtype='float32')

    def host(x):
        return x.detach().float().contiguous().cpu()

    emb, layers = params['embeddings'], params['layers']
    state = {
        'embeddings.word_embeddings.weight': host(emb['word']),
        'embeddings.position_embeddings.weight': host(emb['position']),
        'embeddings.token_type_embeddings.weight': host(emb['token_type']),
        'embeddings.LayerNorm.weight': host(emb['ln']['scale']),
        'embeddings.LayerNorm.bias': host(emb['ln']['bias']),
    }
    names = {'q': 'attention.self.query', 'k': 'attention.self.key',
             'v': 'attention.self.value', 'o': 'attention.output.dense',
             'up': 'intermediate.dense', 'down': 'output.dense'}
    for li in range(cfg.num_layers):
        p = f'encoder.layer.{li}'
        for ours, theirs in names.items():
            state[f'{p}.{theirs}.weight'] = host(layers[ours]['kernel'][li].T)
            state[f'{p}.{theirs}.bias'] = host(layers[ours]['bias'][li])
        for ours, theirs in (('attn_ln', 'attention.output.LayerNorm'),
                             ('mlp_ln', 'output.LayerNorm')):
            state[f'{p}.{theirs}.weight'] = host(layers[ours]['scale'][li])
            state[f'{p}.{theirs}.bias'] = host(layers[ours]['bias'][li])
    save_file(state, str(root / 'model.safetensors'))
    (root / 'config.json').write_text(json.dumps({
        'model_type': 'bert', 'vocab_size': cfg.vocab_size, 'hidden_size': cfg.hidden_size,
        'num_hidden_layers': cfg.num_layers, 'num_attention_heads': cfg.num_heads,
        'intermediate_size': cfg.intermediate_size,
        'max_position_embeddings': cfg.max_position_embeddings,
        'type_vocab_size': cfg.type_vocab_size, 'layer_norm_eps': cfg.layer_norm_eps,
        'hidden_act': cfg.hidden_act,
    }))
    del params
    return root


def write_jsonl_rows(root: Path, files: int, rows: int, words, lens, seed, path_of=None):
    """``files`` jsonl files of ``rows`` rows each: ``text`` of ``lens``
    (lo, hi) random ``words``, and a ``path``."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for f in range(files):
        with open(root / f'part{f}.jsonl', 'w') as fh:
            for i in range(rows):
                n = int(rng.integers(*lens))
                text = ' '.join(words[j] for j in rng.integers(0, len(words), size=n))
                fh.write(json.dumps({'text': text, 'path': f'doc{f}/{i}.txt'}) + '\n')
    return root


def check_k3_kernel(tea, tag):
    """K3 launched (all on the tensor-core routes), its plain version never."""
    launches = tea.encoder_attention.launches
    by_route = dict(tea.encoder_attention.launches_by_route)
    plain = tea.encoder_attention_reference.launches
    log(f'[{tag}] encoder_attention launches {launches}, by route {json.dumps(by_route)}; '
        f'plain version {plain}')
    if launches <= 0 or by_route['tensor_cores'] + by_route['wgmma'] != launches or plain:
        fail(f'{tag}: K3 launches {launches}, routes {by_route}, plain {plain}')
    return dict(launches=launches, launches_by_route=by_route)


def check_k1_kernel(tpa, tag):
    """K1 launched, its plain version never."""
    launches = tpa.ragged_paged_attention.launches
    plain = tpa.ragged_paged_attention_reference.launches
    log(f'[{tag}] ragged_paged_attention launches {launches}, by route '
        f'{json.dumps(tpa.ragged_paged_attention.launches_by_route)}; plain op {plain}')
    if launches <= 0 or plain:
        fail(f'{tag}: K1 launches {launches}, plain op {plain}')
    return dict(launches=launches,
                launches_by_route=dict(tpa.ragged_paged_attention.launches_by_route))


def mcqa_corpus(torch, tea, card, root: Path):
    """Phase 18's corpus: ``MCQA_CHUNKS`` chunks as jsonl, embedded by the
    port's embed pipeline (``run_embedding``: a BERT-base checkpoint
    written here, bf16, K3) and merged by its writer; returns the
    ``retriever_config`` over it, the merged rows' paths and texts, and
    the embed run's numbers."""
    from datasets import load_from_disk

    from distllm_tpu_torch import distributed_embedding
    from distllm_tpu_torch.embed import get_writer
    from distllm_tpu_torch.models import bert

    cfg = RETRIEVER_BERT() if RETRIEVER_BERT else bert.BertConfig()
    t0 = time.perf_counter()
    ckpt = write_bert_checkpoint(torch, root / 'bert', cfg, seed=0)
    write_s = time.perf_counter() - t0
    inputs = write_jsonl_rows(root / 'chunks', MCQA_FILES, MCQA_CHUNKS // MCQA_FILES,
                              RAG_WORDS, (48, 97), seed=18)
    encoder_config = {'name': 'auto', 'pretrained_model_name_or_path': str(ckpt),
                      'half_precision': True}
    config = distributed_embedding.Config(
        input_dir=inputs, output_dir=root / 'embed', glob_patterns=['*.jsonl'],
        dataset_config={'name': 'jsonl', 'batch_size': 64}, encoder_config=encoder_config,
        pooler_config={'name': 'mean'}, embedder_config={'name': 'full_sequence'},
        writer_config={'name': 'huggingface'},
    )
    zero_k3_counts(tea)
    t0 = time.perf_counter()
    if distributed_embedding.run_embedding(config, device=DEVICE) != 0:
        fail('mcqa corpus: run_embedding failed')
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    k3 = check_k3_kernel(tea, 'mcqa corpus')
    shards = sorted(p for p in (root / 'embed' / 'embeddings').iterdir() if p.is_dir())
    get_writer({'name': 'huggingface'}).merge(shards, root / 'merged')
    merged = load_from_disk(str(root / 'merged'))
    if len(merged) != MCQA_CHUNKS or {'text', 'embeddings', 'path'} - set(merged.column_names):
        fail(f'mcqa corpus: merged {len(merged)} rows, columns {merged.column_names}')
    log(f'[mcqa corpus] {card}: BERT-base checkpoint written in {write_s:.1f} s; '
        f'{MCQA_CHUNKS} chunks embedded by run_embedding in {embed_s:.2f} s '
        f'({MCQA_CHUNKS / embed_s:.1f} chunks/s, {len(shards)} shards merged)')
    retriever_config = {
        'faiss_config': {'name': 'faiss_index_v2', 'dataset_dir': str(root / 'merged'),
                         'precision': 'float32'},
        'encoder_config': encoder_config, 'pooler_config': {'name': 'mean'},
        'batch_size': RETRIEVER_BATCH,
    }
    return retriever_config, merged['path'], merged['text'], dict(
        k3=k3, embed_s=embed_s, checkpoint_write_s=write_s, chunks=len(merged),
        layers=cfg.num_layers)


def mcqa_questions(paths, texts, n, seed):
    """``n`` questions from corpus rows: a stem of a row's first words,
    four options (the row's next three words among three random ones), the
    reference answer, and the row's ``chunk_id``."""
    from distllm_tpu_torch.mcqa.harness import chunk_id

    rng = np.random.default_rng(seed)
    out = []
    for idx in rng.choice(len(texts), size=n, replace=False):
        words = texts[int(idx)].split()
        options = [' '.join(words[10:13])] + [
            ' '.join(rng.choice(RAG_WORDS, size=3)) for _ in range(3)]
        order = rng.permutation(4)
        letters = 'ABCD'
        lines = [f'{letters[k]}. {options[o]}' for k, o in enumerate(order)]
        right = letters[int(np.flatnonzero(order == 0)[0])]
        out.append({
            'question': f'Which words follow "{" ".join(words[:10])}"?\n' + '\n'.join(lines),
            'answer': f'{right}. {options[0]}',
            'chunk_id': chunk_id(paths[int(idx)], int(idx)),
        })
    return out


def fake_grader():
    """The grader: a second ``ChatServer`` over the ``fake`` backend, whose
    answer is a JSON verdict (random weights cannot write JSON)."""
    from distllm_tpu_torch.chat_server import ChatServer
    from distllm_tpu_torch.generate.generators import get_generator

    return ChatServer(get_generator({'name': 'fake', 'response_template': GRADER_VERDICT}))


def mcqa_yaml(path: Path, questions_file: Path, output_dir: Path, model_base: str,
              grader_base: str, retriever_config=None, **fields):
    """The harness's YAML on disk, read back the user's way."""
    import yaml

    from distllm_tpu_torch.mcqa.config import MCQAConfig

    raw = dict(questions_file=str(questions_file), output_dir=str(output_dir),
               model_api_base=model_base, model_name='mistral-7b-random',
               grader_api_base=grader_base, grader_model='fake-grader', **MCQA_RUN, **fields)
    if retriever_config is not None:
        raw['retriever_config'] = retriever_config
    path.write_text(yaml.safe_dump(raw))
    return MCQAConfig.from_yaml(path)


def check_mcqa_results(tag, output_dir: Path, n):
    """results.json carries the JAX harness's keys, every question answered
    and graded."""
    doc = json.loads((output_dir / 'results.json').read_text())
    summary, results = doc['summary'], doc['results']
    missing = MCQA_SUMMARY_KEYS - set(summary)
    bad = [k for k, r in results.items() if set(r) != MCQA_RESULT_KEYS
           or not isinstance(r['answer'], str) or not isinstance(r['correct'], bool)]
    if (missing or bad or len(results) != n or summary['graded'] != n or summary['errors']
            or set(doc) != {'summary', 'results'}):
        fail(f'{tag}: results.json summary missing {missing}, {len(results)} results, bad '
             f'{bad[:3]}, graded {summary.get("graded")}, errors {summary.get("errors")}')
    return summary, results


def percentile(values, q):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if values else None


def phase_mcqa(torch, tpa, tea, card, tmp: Path):
    """Phase 18: the MCQA harness on the card at full width and depth.
    The model under test is a ``ChatServer`` over the registry's warm
    Mistral-7B generator of phases 15b-15d, reached through
    ``model_api_base`` (``ApiGenerator`` -> ``BatchingClient`` -> HTTP ->
    the engine, K1); the RAG arm reads ``retriever_config`` from the YAML
    on disk (BERT-base queries, K3, over the corpus this phase embeds);
    the grader a fake ``ChatServer``. A second ``run_mcqa`` on the same
    ``output_dir`` resumes: no question asked, the same accuracy."""
    from distllm_tpu_torch.chat_server import ChatServer
    from distllm_tpu_torch.mcqa import harness

    tag = 'mcqa'
    root = tmp / 'mcqa'
    retriever_config, paths, texts, corpus = mcqa_corpus(torch, tea, card, root)
    questions = mcqa_questions(paths, texts, MCQA_QUESTIONS, seed=19)
    qfile = root / 'questions.json'
    qfile.write_text(json.dumps(questions))
    generator = rag_generator(torch)
    engine = generator.engine
    server, grader = ChatServer(generator), fake_grader()
    latencies = []
    answer = harness.RagAnswerer.answer

    def timed_answer(self, question):
        t0 = time.perf_counter()
        out = answer(self, question)
        latencies.append(time.perf_counter() - t0)
        return out

    harness.RagAnswerer.answer = timed_answer
    try:
        with server, grader:
            config = mcqa_yaml(
                root / 'mcqa.yaml', qfile, root / 'out', f'http://127.0.0.1:{server.port}/v1',
                f'http://127.0.0.1:{grader.port}/v1', retriever_config,
            )
            records = instrument_prefill(torch, engine)
            stats0, marks = dict(engine.stats), graph_marks(engine)
            tokens0 = engine.stats.get('generated_tokens', 0)
            zero_k1_counts(tpa)
            zero_k3_counts(tea)
            t0 = time.perf_counter()
            summary = harness.run_mcqa(config, device=DEVICE)
            wall_s = time.perf_counter() - t0
            k3 = check_k3_kernel(tea, tag)
            k1 = rag_engine_routes(torch, tpa, tag, engine, marks, stats0, records)
            del engine._dispatch_prefill_paged  # instrument_prefill's wrapper
            tokens = engine.stats['generated_tokens'] - tokens0
            asked = len(server.timings)
            summary, results = check_mcqa_results(tag, root / 'out', MCQA_QUESTIONS)
            contexts = [len(r['retrieval']) for r in results.values()]
            if asked != MCQA_QUESTIONS or min(contexts) != MCQA_TOP_K:
                fail(f'{tag}: the model answered {asked} requests, contexts {set(contexts)}')
            # Resume: every question is in the checkpoint; nothing is asked.
            zero_k1_counts(tpa)
            t0 = time.perf_counter()
            again = harness.run_mcqa(config, device=DEVICE)
            resume_s = time.perf_counter() - t0
            if (len(server.timings) != asked or tpa.ragged_paged_attention.launches
                    or again['accuracy'] != summary['accuracy']
                    or again['graded'] != MCQA_QUESTIONS):
                fail(f'{tag}: the resumed run asked {len(server.timings) - asked} questions, '
                     f'accuracy {again["accuracy"]} vs {summary["accuracy"]}')
    finally:
        harness.RagAnswerer.answer = answer
    out = dict(
        questions=MCQA_QUESTIONS, wall_s=wall_s, questions_per_s=MCQA_QUESTIONS / wall_s,
        answer_latency_p50_s=percentile(latencies, 50),
        answer_latency_p95_s=percentile(latencies, 95),
        generate_ms_p50=percentile([t['generate_s'] * 1e3 for t in server.timings], 50),
        generated_tokens=tokens, generated_tokens_per_s=tokens / wall_s,
        accuracy=summary['accuracy'], batches_sent=summary['batches_sent'],
        source_chunk_retrieved_rate=summary.get('source_chunk_retrieved_rate'),
        resume_s=resume_s, resumed_accuracy=again['accuracy'], k1=k1, k3=k3, corpus=corpus,
    )
    log(f'[{tag}] {card}: {MCQA_QUESTIONS} questions answered and graded in {wall_s:.2f} s = '
        f'{out["questions_per_s"]:.2f} questions/s; answer latency p50 / p95 '
        f'{out["answer_latency_p50_s"]:.3f} / {out["answer_latency_p95_s"]:.3f} s (retrieval, '
        f'queue, HTTP and generation); {tokens} tokens = {out["generated_tokens_per_s"]:.1f} '
        f'tok/s; accuracy {summary["accuracy"]:.4f} (fake grader), source chunk retrieved '
        f'{out["source_chunk_retrieved_rate"]}; {summary["batches_sent"]} client batches; '
        f'resume {resume_s:.2f} s, 0 questions asked; K1 {k1["launches"]}, K3 '
        f'{k3["launches"]}')
    out['_setup'] = (root, retriever_config, questions)
    return out


def phase_mcqa_identity(torch, tpa, tea, card, setup):
    """Phase 18d: fp32, Mistral-7B widths at depth 2: phase 18's MCQA run
    (its first questions, its retriever from disk) through K1 and through
    ``attn_backend='reference'`` gives identical answers; the retriever's
    BERT-base encoder through K3 and through its plain op within phase 12's
    tolerance (``encoder_identity``)."""
    from distllm_tpu_torch.chat_server import ChatServer
    from distllm_tpu_torch.generate import get_generator
    from distllm_tpu_torch.mcqa import harness
    from distllm_tpu_torch.models import bert
    from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer

    root, retriever_config, questions = setup
    tag = 'mcqa identity'
    qfile = root / 'identity_questions.json'
    qfile.write_text(json.dumps(questions[:MCQA_IDENTITY_QUESTIONS]))
    answers, counts = {}, {}
    for arm, backend in (('kernel', 'auto'), ('plain', 'reference')):
        kwargs = {**rag_generator_config(), 'model': {**RAG_MODEL, 'num_layers': 2,
                                                      'dtype': 'float32'},
                  'attn_backend': backend, 'max_tokens': MCQA_IDENTITY_NEW,
                  # Off: a cache hit depends on the order requests arrive in,
                  # and a cached prefix changes the fp32 arithmetic.
                  'enable_prefix_cache': False}
        generator = get_generator(kwargs, device=DEVICE)
        server, grader = ChatServer(generator), fake_grader()
        with server, grader:
            config = mcqa_yaml(
                root / f'identity_{arm}.yaml', qfile, root / f'identity_{arm}',
                f'http://127.0.0.1:{server.port}/v1', f'http://127.0.0.1:{grader.port}/v1',
                retriever_config,
            )
            zero_k1_counts(tpa)
            harness.run_mcqa(config, device=DEVICE)
        counts[arm] = (tpa.ragged_paged_attention.launches,
                       tpa.ragged_paged_attention_reference.launches)
        _, results = check_mcqa_results(f'{tag} {arm}', root / f'identity_{arm}',
                                        MCQA_IDENTITY_QUESTIONS)
        # The answers as token ids: the whitespace tokenizer's ids are
        # hashes, but its decode names an id by the first word it saw with
        # it (an unseen one as '<id>'), which depends on the order requests
        # arrived in.
        tok = generator.tokenizer
        answers[arm] = [
            [int(w[1:-1]) if w[0] == '<' and w[-1] == '>' and w[1:-1].isdigit()
             else tok.token_id(w) for w in results[str(i)]['answer'].split()]
            for i in range(MCQA_IDENTITY_QUESTIONS)
        ]
        generator.shutdown()
        del generator
        torch.cuda.empty_cache()
    same = answers['kernel'] == answers['plain']
    log(f'[{tag}] fp32 depth 2: {MCQA_IDENTITY_QUESTIONS} answers ({sum(map(len, answers["kernel"]))} '
        f'tokens) identical through K1 and the plain op: {same}; K1 / plain launches {counts}')
    if not same:
        fail(f'{tag}: fp32 answers differ between K1 and the plain op')
    if counts['kernel'][0] <= 0 or counts['kernel'][1] or counts['plain'][0] or (
            counts['plain'][1] <= 0):
        fail(f'{tag}: K1 / plain launches {counts}')
    cfg = bert.BertConfig(num_layers=2, dtype='float32')
    k3 = encoder_identity(
        torch, tea, f'{tag} k3', bert, cfg,
        WhitespaceTokenizer(vocab_size=cfg.vocab_size, model_max_length=512),
        [q['question'] for q in questions], 16,
    )
    return dict(identical=same, questions=MCQA_IDENTITY_QUESTIONS,
                k1=dict(kernel=counts['kernel'][0], plain_arm_plain=counts['plain'][1]), k3=k3)


def phase_mcqa_boot(torch, tpa, card, tmp: Path, ckpt: Path):
    """Phase 18b: ``run_mcqa`` with ``local_model_path`` = phase 17c's
    checkpoint: ``LocalServerManager`` boots ``python -m
    distllm_tpu_torch.chat_server`` on the card as a subprocess; its bf16
    answers equal, token for token, a generator built in this process on
    the same checkpoint from the same generator config (the same kernels,
    device and dtype; the word-level tokenizer makes equal strings equal
    tokens); the process exits at ``stop()``. The subprocess's launches are
    not counted here: the direct generator's are."""
    import signal

    import yaml

    from distllm_tpu_torch.chat import ChatAppConfig, ConversationPromptTemplate
    from distllm_tpu_torch.mcqa import harness, server_boot
    from distllm_tpu_torch.mcqa.config import MCQAConfig

    tag = 'mcqa boot'
    root = tmp / 'mcqa_boot'
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(20)
    questions = []
    for i in range(MCQA_BOOT_QUESTIONS):
        stem = ' '.join(f'w{int(w)}' for w in rng.integers(0, 31000, size=int(rng.integers(16, 64))))
        options = [f'w{int(w)}' for w in rng.integers(0, 31000, size=4)]
        questions.append({'question': stem + '\n' + '\n'.join(
            f'{l}. {o}' for l, o in zip('ABCD', options)), 'answer': f'A. {options[0]}'})
    qfile = root / 'questions.json'
    qfile.write_text(json.dumps(questions))
    boot = {}
    start, stop = server_boot.LocalServerManager.start, server_boot.LocalServerManager.stop

    def timed_start(self):
        t0 = time.perf_counter()
        start(self)
        boot['ready_s'] = time.perf_counter() - t0
        boot['pid'] = self.process.pid

    def watched_stop(self):
        process = self.process
        stop(self)
        if process is not None and 'returncode' not in boot:
            boot['returncode'] = process.returncode

    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGINT, signal.SIGTERM)}
    server_boot.LocalServerManager.start = timed_start
    server_boot.LocalServerManager.stop = watched_stop
    grader = fake_grader()
    try:
        with grader:
            path = root / 'mcqa.yaml'
            path.write_text(yaml.safe_dump(dict(
                questions_file=str(qfile), output_dir=str(root / 'out'),
                local_model_path=str(ckpt), vllm_args=MCQA_BOOT_VLLM,
                grader_api_base=f'http://127.0.0.1:{grader.port}/v1', grader_model='fake',
                parallel_workers=8, batch_size=16, batch_timeout=0.5,
            )))
            t0 = time.perf_counter()
            harness.run_mcqa(MCQAConfig.from_yaml(path))
            wall_s = time.perf_counter() - t0
    finally:
        server_boot.LocalServerManager.start, server_boot.LocalServerManager.stop = start, stop
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    _, results = check_mcqa_results(tag, root / 'out', MCQA_BOOT_QUESTIONS)
    if boot.get('returncode') is None:
        fail(f'{tag}: the server process did not exit at stop(): {boot}')
    answers = [results[str(i)]['answer'] for i in range(MCQA_BOOT_QUESTIONS)]
    server_config = yaml.safe_load((root / 'out' / 'server_logs' / 'server_config.yaml')
                                   .read_text())
    template = ConversationPromptTemplate('')
    prompts = [template.render([{'role': 'user', 'content': q['question']}]) for q in questions]
    direct = ChatAppConfig.from_dict(server_config).build_generator(device=DEVICE)
    zero_k1_counts(tpa)
    # One prompt a call, as the server's worker generates them.
    want = [direct.generate([prompt])[0] for prompt in prompts]
    k1 = check_k1_kernel(tpa, f'{tag} direct')
    same = answers == want
    log(f'[{tag}] {card}: server booted as a subprocess, ready in {boot["ready_s"]:.2f} s, '
        f'{MCQA_BOOT_QUESTIONS} questions in {wall_s:.2f} s (boot included); answers identical '
        f'to the direct generator: {same}; exit code at stop() {boot["returncode"]}')
    if not same:
        diff = [i for i, (a, b) in enumerate(zip(answers, want)) if a != b]
        fail(f'{tag}: answers {diff} differ from the direct generator\'s')
    return dict(ready_s=boot['ready_s'], wall_s=wall_s, questions=MCQA_BOOT_QUESTIONS,
                identical_to_direct=same, returncode=boot['returncode'], k1_direct=k1,
                answer_words=sum(len(a.split()) for a in answers))


def phase_cli(torch, tpa, tea, card, tmp: Path, ckpt: Path):
    """Phase 18c: the CLI on the card. ``generate --generator_name tpu``
    over phase 17c's checkpoint (K1); ``embed`` over a checkpoint written
    here at BERT-base widths and ``CLI_EMBED_LAYERS`` layers (K3);
    ``merge`` of ``embed``'s shards."""
    from datasets import load_from_disk

    from distllm_tpu_torch import cli
    from distllm_tpu_torch.models import bert

    root = tmp / 'cli'
    words = [f'w{i}' for i in range(31000)]
    inputs = write_jsonl_rows(root / 'gen_in', 2, CLI_ROWS // 2, words, (24, 200), seed=21)
    zero_k1_counts(tpa)
    t0 = time.perf_counter()
    rc = cli.main(['generate', '--input_dir', str(inputs), '--output_dir', str(root / 'gen'),
                   '--glob_patterns', '*.jsonl', '--generator_name', 'tpu',
                   '--pretrained_model_name_or_path', str(ckpt), '--temperature', '0',
                   '--max_tokens', '32', '--device', DEVICE])
    generate_s = time.perf_counter() - t0
    k1 = check_k1_kernel(tpa, 'cli generate')
    rows = sum(len(load_from_disk(str(p))) for p in (root / 'gen' / 'generations').iterdir())
    if rc != 0 or rows <= 0:
        fail(f'cli generate: exit {rc}, {rows} rows written')
    cfg = (RETRIEVER_BERT or bert.BertConfig)(num_layers=CLI_EMBED_LAYERS)
    bert_ckpt = write_bert_checkpoint(torch, root / 'bert', cfg, seed=3)
    texts = write_jsonl_rows(root / 'embed_in', 2, CLI_EMBED_TEXTS // 2, RAG_WORDS, (8, 200),
                             seed=22)
    zero_k3_counts(tea)
    t0 = time.perf_counter()
    rc = cli.main(['embed', '--input_dir', str(texts), '--output_dir', str(root / 'embed'),
                   '--glob_patterns', '*.jsonl', '--pretrained_model_name_or_path',
                   str(bert_ckpt), '--dataset_name', 'jsonl', '--batch_size', '64',
                   '--device', DEVICE])
    embed_s = time.perf_counter() - t0
    k3 = check_k3_kernel(tea, 'cli embed')
    if rc != 0:
        fail(f'cli embed: exit {rc}')
    rc = cli.main(['merge', '--dataset_dir', str(root / 'embed' / 'embeddings'),
                   '--output_dir', str(root / 'merged')])
    merged = load_from_disk(str(root / 'merged'))
    emb = np.asarray(merged['embeddings'], dtype=np.float32)
    if rc != 0 or len(merged) != CLI_EMBED_TEXTS or emb.shape[1] != cfg.hidden_size or (
            not np.isfinite(emb).all()):
        fail(f'cli merge: exit {rc}, {len(merged)} rows, embeddings {emb.shape}')
    log(f'[cli] {card}: generate {rows} rows in {generate_s:.2f} s (generator build '
        f'included), K1 {k1["launches"]}; embed {CLI_EMBED_TEXTS} texts at '
        f'{CLI_EMBED_LAYERS} layers in {embed_s:.2f} s, K3 {k3["launches"]}; merge '
        f'{len(merged)} rows x {emb.shape[1]}')
    return dict(generate_rows=rows, generate_s=generate_s, embed_texts=CLI_EMBED_TEXTS,
                embed_s=embed_s, embed_layers=CLI_EMBED_LAYERS, merged_rows=len(merged),
                k1=k1, k3=k3)


# ---------------------------------------------------------- phases 19-19d
# Phase 19: Mixtral-8x7B (ROADMAP A10a) at full width and depth, int8,
# built through the generator factory a user calls. Its bf16 weights
# (93 GB) do not fit the card; mixtral.init quantizes layer by layer.
MIXTRAL_GENERATOR = {
    'name': 'torch', 'model': {'name': 'mixtral'}, 'quantization': 'int8', 'seed': 0,
    'max_num_seqs': 8, 'block_size': BLOCK_SIZE, 'num_blocks': 1024, 'max_model_len': 2048,
    # The HTTP requests' length (the server answers one at a time, about
    # 0.22 s a token): 16, cut from 64 to keep the run's time; the main
    # path asks its 64 itself.
    'temperature': 0.0, 'max_tokens': 16,
}
MIXTRAL_8X7B = dict(num_layers=32, num_experts=8, experts_per_token=2, hidden_size=4096,
                    intermediate_size=14336, num_heads=32, num_kv_heads=8, vocab_size=32000)
# The main path's 16 prompts ask 32 new tokens (cut from 64) and 2 HTTP
# requests follow (cut from 4), to keep the whole run's time.
MIXTRAL_PROMPTS, MIXTRAL_PROMPT_LENS, MIXTRAL_HTTP, MIXTRAL_NEW = 16, (32, 512), 2, 32
# Phase 19a: one full-width bank of two layers, quantized on the card.
MIXTRAL_BANK = (2, 8, 4096, 14336)
# The estimate written before the first run (not a target): a decode pass
# reads 45 GB of int8 codes and writes and reads about 90 GB of bf16
# dequantized banks, >= 67 ms at 3.35 TB/s, <= about 120 tok/s at 8 rows.
MIXTRAL_ESTIMATE = 'a decode pass >= 67 ms (codes + dequantized banks at 3.35 TB/s), <= ~120 tok/s'
# Phase 19d: Mixtral-8x7B widths at one layer, written as a checkpoint.
MIXTRAL_CKPT_HF = {
    'model_type': 'mixtral', 'vocab_size': 32000, 'hidden_size': 4096,
    'intermediate_size': 14336, 'num_hidden_layers': 1, 'num_attention_heads': 32,
    'num_key_value_heads': 8, 'num_local_experts': 8, 'num_experts_per_tok': 2,
    'max_position_embeddings': 32768, 'rms_norm_eps': 1e-5, 'rope_theta': 1e6,
    'sliding_window': None, 'tie_word_embeddings': False, 'torch_dtype': 'bfloat16',
}
MIXTRAL_CKPT_SERVE = dict(temperature=0.0, max_tokens=32, block_size=BLOCK_SIZE,
                          num_blocks=512, max_num_seqs=8, max_model_len=1024)


def is_mixtral_8x7b(cfg):
    return all(getattr(cfg, key) == value for key, value in MIXTRAL_8X7B.items())


def phase_quantize_bank(torch, tq):
    """19a. The repaired 4-D quantizer on one full-width expert bank,
    ``[2, 8, 4096, 14336]`` bf16 made on the card: it works one
    ``[4096, 14336]`` slice at a time, so its peak allocation beyond the
    input and the codes stays under two fp32 slices (470 MB; the whole
    bank's fp32 copy would be 3.76 GB); one expert's codes and scales
    equal the CPU's bitwise."""
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    bank = torch.randn(MIXTRAL_BANK, generator=gen, device=DEVICE, dtype=torch.bfloat16)
    bank.mul_(0.02)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qt = tq.quantize_int8(bank)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    codes = qt.nbytes
    extra = torch.cuda.max_memory_allocated() - base - codes
    slice_bytes = 4 * MIXTRAL_BANK[-2] * MIXTRAL_BANK[-1]
    last = (MIXTRAL_BANK[0] - 1, MIXTRAL_BANK[1] - 1)  # the last layer's last expert
    host = tq.quantize_int8(bank[last].cpu())
    same = torch.equal(qt.q[last].cpu(), host.q) and torch.equal(qt.scale[last].cpu(), host.scale)
    log(f'[quantize bank] {MIXTRAL_BANK} bf16 ({bank.numel() * 2 / 2**30:.3f} GiB) to int8 '
        f'codes and scales ({codes / 2**30:.3f} GiB) in {quantize_s:.3f} s; peak beyond input '
        f'and codes {extra / 2**20:.1f} MiB = {extra / slice_bytes:.3f} fp32 slices of '
        f'{slice_bytes / 2**20:.1f} MiB (bound 2; the whole bank in fp32 would be '
        f'{4 * bank.numel() / 2**20:.1f} MiB); expert {list(last)} equal to the CPU bitwise={same}')
    if extra >= 2 * slice_bytes:
        fail(f'quantize bank: {extra} bytes beyond input and codes, bound {2 * slice_bytes}')
    if not same:
        fail(f'quantize bank: card-made codes or scales of expert {last} differ from the CPU')
    del bank, qt
    torch.cuda.empty_cache()
    return dict(quantize_s=quantize_s, peak_extra_mib=extra / 2**20,
                peak_extra_slices=extra / slice_bytes, codes_gib=codes / 2**30, bitwise=same)


def phase_serve_mixtral(torch, tpa, tqm, card):
    """19. Mixtral-8x7B int8 at full width and depth through
    ``get_generator`` (32 layers, 8 experts, top 2, hidden 4096,
    intermediate 14336, 32 / 8 heads, vocab 32000; random weights from
    seed 0, quantized layer by layer as they are drawn): 16 greedy prompts
    of 32..512 tokens x ``MIXTRAL_NEW`` new, then ``MIXTRAL_HTTP`` requests of 16 new over HTTP through
    ``ChatServer`` on the same generator. K1 on every layer of every
    pass (prefill on the tensor cores, decode on the split-KV route), K2
    on q / k / v / o (4 a layer, tensor cores), the plain versions never;
    every decode step a graph replay; the peak allocation under the
    card's memory."""
    from distllm_tpu_torch.chat_server import ChatServer
    from distllm_tpu_torch.generate import get_generator
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.ops.quantization import QTensor

    tag = 'serve mixtral'
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    t0 = time.perf_counter()
    generator = get_generator(dict(MIXTRAL_GENERATOR), device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine = generator.engine
    cfg = engine.model_cfg
    bank = engine.params['layers']['gate']['kernel']
    widths = tuple(MIXTRAL_8X7B[k] for k in (
        'num_layers', 'num_experts', 'hidden_size', 'intermediate_size'))
    if not (cfg.name == 'mixtral' and is_mixtral_8x7b(cfg) and isinstance(bank, QTensor)
            and bank.kind == 'int8' and bank.shape == widths):
        fail(f'{tag}: get_generator built {cfg} with gate bank {bank!r}')
    built = dict(
        build_s=build_s, capture_s=engine.stats['decode_graph_capture_s'],
        weight_gib=engine.weight_bytes_quantized / 2**30,
        float_weight_gib=engine.weight_bytes_float / 2**30,
        expert_bank_gib=engine.stats['expert_bank_bytes_quantized'] / 2**30,
        allocated_gib=torch.cuda.memory_allocated() / 2**30,
        build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        pool_mib={'decode': engine._decode.pool_bytes / 2**20,
                  'verify': None if engine._verify is None else engine._verify.pool_bytes / 2**20},
    )
    log(f'[{tag}] {card}: get_generator built {type(cfg).__name__} ({cfg.num_layers} layers, '
        f'{cfg.num_experts} experts, top {cfg.experts_per_token}, hidden {cfg.hidden_size}, '
        f'intermediate {cfg.intermediate_size}) in {build_s:.2f} s with warm-up ({built["capture_s"]:.2f} s capturing the '
        f'decode graphs); int8 weights {built["weight_gib"]:.2f} GiB (expert banks '
        f'{built["expert_bank_gib"]:.2f}), float leaves {built["float_weight_gib"]:.2f} GiB; '
        f'{built["allocated_gib"]:.2f} GiB allocated, peak {built["build_peak_gib"]:.2f} GiB of '
        f'{card_gib:.1f}; graph pools {json.dumps(built["pool_mib"])} MiB')
    prompts = smoke_prompts(np.random.default_rng(19), MIXTRAL_PROMPTS, *MIXTRAL_PROMPT_LENS)
    sampling = SamplingParams(temperature=0.0, max_tokens=MIXTRAL_NEW)
    rec = instrument_windows(torch, engine)
    marks = graph_marks(engine)
    stats0 = dict(engine.stats)
    # The main path: counts to 0 just before, read just after.
    zero_k1_counts(tpa)
    zero_k2_counts(tqm)
    t0 = time.perf_counter()
    outputs = generator.generate(prompts, sampling)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    run = stats_delta(engine, stats0)
    passes, prefills = run['forward_passes'], run.get('prefill_dispatches', 0)
    eager = prefills + run.get('mixed_windows', 0)
    widths = [r['width'] for r in rec['prefill'] + rec['chunk']]
    if len(widths) != eager or len(outputs) != MIXTRAL_PROMPTS or not all(
            isinstance(o, str) for o in outputs):
        fail(f'{tag}: {len(outputs)} outputs, {len(widths)} eager passes recorded for {eager}')
    if run['generated_tokens'] != MIXTRAL_PROMPTS * MIXTRAL_NEW:
        fail(f'{tag}: {run["generated_tokens"]} tokens, expected {MIXTRAL_PROMPTS} x {MIXTRAL_NEW}')
    graphs = check_k1_routes(torch, tpa, tag, cfg, engine, marks, passes, eager, widths, 'model')
    k1, k1_routes = tpa.ragged_paged_attention.launches, dict(
        tpa.ragged_paged_attention.launches_by_route)
    k2, k2_routes = tqm.int8_matmul.launches, dict(tqm.int8_matmul.launches_by_route)
    log(f'[{tag}] int8_matmul launches {k2} = 4 (q / k / v / o) x {cfg.num_layers} layers x '
        f'{passes} passes; by route {json.dumps(k2_routes)}; plain version '
        f'{tqm.int8_matmul_reference.launches}')
    if (k2 != 4 * cfg.num_layers * passes or k2_routes['tensor_cores'] != k2
            or tqm.int8_matmul_reference.launches):
        fail(f'{tag}: K2 launches {k2} ({k2_routes}) for {passes} passes, plain '
             f'{tqm.int8_matmul_reference.launches}')
    tok_s = run['generated_tokens'] / wall_s
    decode_ms = median([w['wall_ms'] / w['steps'] for w in rec['window']
                        if not w['spec'] and w['steps'] and not w['chunk_rows']])
    log(f'[{tag}] {card}: {MIXTRAL_PROMPTS} prompts ({MIXTRAL_PROMPT_LENS[0]}..'
        f'{MIXTRAL_PROMPT_LENS[1]} tokens), {run["generated_tokens"]} new tokens in '
        f'{wall_s:.3f} s = {tok_s:.2f} tok/s; decode {decode_ms} ms a pass (window wall over '
        f'its steps, median); {prefills} prefill dispatches '
        f'({sum(r["wall_ms"] for r in rec["prefill"]):.1f} host ms); estimate from the code: '
        f'{MIXTRAL_ESTIMATE}')
    with ChatServer(generator, port=0) as server:
        results = [None] * MIXTRAL_HTTP

        def ask(i):
            results[i] = post_completion(server.port, i)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(MIXTRAL_HTTP)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            fail(f'{tag}: chat completion timed out')
    statuses = [None if r is None else r[0] for r in results]
    for i, result in enumerate(results):
        if result is None or result[0] != 200 or result[1]['request_id'] != f'smoke-{i}' \
                or not isinstance(result[1]['choices'][0]['message']['content'], str):
            fail(f'{tag}: chat completion {i} answered {result}')
    http_k1 = tpa.ragged_paged_attention.launches - k1
    http_k2 = tqm.int8_matmul.launches - k2
    if (http_k1 <= 0 or http_k2 <= 0 or tpa.ragged_paged_attention_reference.launches
            or tqm.int8_matmul_reference.launches):
        fail(f'{tag}: HTTP requests launched K1 {http_k1}, K2 {http_k2} times')
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f'[{tag}] chat_server: {MIXTRAL_HTTP} completions, statuses {statuses}; K1 {http_k1}, '
        f'K2 {http_k2} launches more; peak allocated {peak_gib:.2f} GiB of {card_gib:.1f}')
    if peak_gib >= card_gib:
        fail(f'{tag}: peak {peak_gib:.2f} GiB over the card\'s {card_gib:.1f}')
    shut_down(torch, tag, engine)
    del generator, engine, bank
    torch.cuda.empty_cache()
    return dict(built, tokens_per_s=tok_s, wall_s=wall_s, decode_pass_ms=decode_ms,
                forward_passes=passes, prefill_dispatches=prefills,
                generated_tokens=run['generated_tokens'], peak_gib=peak_gib,
                http_statuses=statuses, launches=k1, launches_by_route=k1_routes,
                k2_launches=k2, k2_launches_by_route=k2_routes, http_k1_launches=http_k1,
                http_k2_launches=http_k2, estimate=MIXTRAL_ESTIMATE, **graphs)


def phase_identity_mixtral(torch, tpa, tqm):
    """19b. Mixtral-8x7B widths at depth 2 in fp32: greedy tokens through
    K1 (float weights) equal the plain op's, and through K1 + K2 (int8
    weights, quantized as drawn) equal the plain ops'; every launch on
    the CUDA-core routes, the other tier never."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig(num_layers=2, dtype='float32')
    rng = np.random.default_rng(20)
    prompts = [[int(t) for t in rng.integers(4, cfg.vocab_size, size=n)]
               for n in (16, 100, 300, 37, 520)]
    sampling = SamplingParams(temperature=0.0, max_tokens=16)
    engine_kw = dict(block_size=BLOCK_SIZE, num_blocks=256, max_num_seqs=4, max_model_len=1024)
    result = {}
    for arm, quant in (('float', None), ('int8', 'int8')):
        params = mixtral.init(cfg, torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE,
                              quantization=quant)
        outs = {}
        for backend in ('auto', 'reference'):
            tag = f'identity mixtral {arm} {backend}'
            engine = LLMEngine(cfg, params, None, EngineConfig(**engine_kw, quantization=quant),
                               device=DEVICE, attn_backend=backend, qmm_backend=backend)
            engine.warmup()
            marks = graph_marks(engine)
            zero_k1_counts(tpa)
            zero_k2_counts(tqm)
            outs[backend] = engine.generate_ids(prompts, sampling)
            passes = engine.telemetry['forward_passes']
            check_graph_replays(tag, engine, marks, passes, engine.telemetry['prefill_dispatches'])
            k1 = (tpa.ragged_paged_attention.launches, tpa.ragged_paged_attention_reference.launches)
            k2 = (tqm.int8_matmul.launches, tqm.int8_matmul_reference.launches)
            if backend == 'reference':
                k1, k2 = k1[::-1], k2[::-1]
            want_k2 = 4 * cfg.num_layers * passes if quant else 0
            if k1 != (cfg.num_layers * passes, 0) or k2 != (want_k2, 0):
                fail(f'{tag}: K1 (tier, other) {k1}, K2 {k2} for {passes} passes')
            routes = (tpa.ragged_paged_attention.launches_by_route['cuda_cores'],
                      tqm.int8_matmul.launches_by_route['cuda_cores'])
            if routes != (tpa.ragged_paged_attention.launches, tqm.int8_matmul.launches):
                fail(f'{tag}: fp32 launches off the CUDA cores: {routes}')
            result[f'{arm}_{backend}'] = dict(k1_launches=k1[0], k2_launches=k2[0],
                                              forward_passes=passes)
            shut_down(torch, tag, engine)
            del engine
        same = outs['auto'] == outs['reference']
        result[f'{arm}_identical'] = same
        log(f'[identity mixtral] fp32 depth 2 at Mixtral-8x7B widths, {arm} weights, '
            f'{len(prompts)} prompts x 16 greedy tokens: kernels vs plain ops identical={same}')
        if not same:
            fail(f'identity mixtral {arm}: {outs["auto"]} on the kernels vs '
                 f'{outs["reference"]} on the plain ops')
        del params
        torch.cuda.empty_cache()
    return result


def phase_spec_mixed_mixtral(torch, tpa, tqm, card):
    """19c. Mixtral-8x7B widths at depth 2 (cut from 4 to keep the run's
    time), bf16 activations over int8
    weights: ``draft_k=4`` (drafts from the off arm's greedy stream, a
    :class:`ProposalDrafter`) and mixed windows with chunked prefill,
    each against the arm with neither. Agreement shares are printed, not
    asserted (bf16 token identity across schedules is not structural);
    each arm's K1 and K2 launches are checked per pass, the verify
    graph's among them."""
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig(num_layers=2)
    params = mixtral.init(cfg, torch.Generator(device=DEVICE).manual_seed(3), device=DEVICE,
                          quantization='int8')
    rng = np.random.default_rng(21)
    prompts = [[int(t) for t in rng.integers(4, cfg.vocab_size, size=int(n))]
               for n in rng.integers(48, 400, size=24)]
    sampling = [SamplingParams(temperature=0.0, max_tokens=int(n))
                for n in rng.integers(16, 48, size=24)]
    base = dict(block_size=BLOCK_SIZE, num_blocks=712, max_num_seqs=8, max_model_len=512,
                decode_steps=8)
    arms = {'off': serve_arm(torch, tpa, 'mixtral off', cfg, params, base, prompts, sampling,
                             tqm=tqm, k2_per_layer=4)}
    arms['spec'] = serve_arm(torch, tpa, 'mixtral spec', cfg, params,
                             dict(base, draft_k=SPEC_DRAFT_K), prompts, sampling, tqm=tqm,
                             proposals=arms['off']['tokens'], k2_per_layer=4)
    arms['mixed'] = serve_arm(torch, tpa, 'mixtral mixed', cfg, params,
                              dict(base, enable_mixed_batching=True, prefill_chunk_tokens=128,
                                   max_window_prefill_tokens=128),
                              prompts, sampling, tqm=tqm, k2_per_layer=4)
    spec, mixed = arms['spec'], arms['mixed']
    verify = dict(passes=spec['spec_windows'], replays=spec['verify_graph_replays'],
                  k1_launches=cfg.num_layers * spec['spec_windows'],
                  k2_launches=4 * cfg.num_layers * spec['spec_windows'],
                  pool_mib=spec.get('graph_pool_mib'))
    agree = {name: greedy_match(arms['off']['tokens'], arms[name]['tokens'])
             for name in ('spec', 'mixed')}
    log(f'[spec mixed mixtral] {card}: off / spec / mixed {arms["off"]["tokens_per_s"]:.1f} / '
        f'{spec["tokens_per_s"]:.1f} / {mixed["tokens_per_s"]:.1f} tok/s; spec accepted '
        f'{spec["spec_accepted_tokens"]}/{spec["spec_draft_tokens"]} over '
        f'{spec["spec_windows"]} verify passes (graph replays {verify["replays"]}: K1 '
        f'{verify["k1_launches"]}, K2 {verify["k2_launches"]} launches); mixed windows '
        f'{mixed["mixed_windows"]}; agreement with off (recorded, bf16) {json.dumps(agree)}')
    if not (spec['spec_accepted_tokens'] > 0 and mixed['mixed_windows'] > 0):
        fail(f'spec mixed mixtral: accepted {spec["spec_accepted_tokens"]}, mixed windows '
             f'{mixed["mixed_windows"]}')
    for arm in arms.values():
        arm.pop('tokens')
    del params
    torch.cuda.empty_cache()
    return dict(arms, agreement=agree, verify=verify)


def write_mixtral_checkpoint(torch, root: Path, params, cfg):
    """A Mixtral HF checkpoint directory of ``params`` (the port's float
    tree, on the card): ``model.safetensors`` in HF key names (Linear
    weights back to ``[out, in]``; the router as ``block_sparse_moe.gate``,
    each expert's ``w1`` / ``w3`` / ``w2``), ``config.json`` and the word
    tokenizer."""
    from safetensors.torch import save_file

    root.mkdir(parents=True, exist_ok=True)
    layers = params['layers']

    def host(x):
        return x.detach().contiguous().cpu()

    state = {'model.embed_tokens.weight': host(params['embed']),
             'model.norm.weight': host(params['final_ln']['scale']),
             'lm_head.weight': host(params['lm_head'].T)}
    attn = {'q': 'q_proj', 'k': 'k_proj', 'v': 'v_proj', 'o': 'o_proj'}
    for i in range(cfg.num_layers):
        p = f'model.layers.{i}'
        for key, hf in attn.items():
            state[f'{p}.self_attn.{hf}.weight'] = host(layers[key]['kernel'][i].T)
        state[f'{p}.block_sparse_moe.gate.weight'] = host(layers['router']['kernel'][i].T)
        for e in range(cfg.num_experts):
            for key, hf in (('gate', 'w1'), ('up', 'w3'), ('down', 'w2')):
                state[f'{p}.block_sparse_moe.experts.{e}.{hf}.weight'] = host(
                    layers[key]['kernel'][i, e].T)
        state[f'{p}.input_layernorm.weight'] = host(layers['attn_ln']['scale'][i])
        state[f'{p}.post_attention_layernorm.weight'] = host(layers['mlp_ln']['scale'][i])
    save_file(state, str(root / 'model.safetensors'))
    (root / 'config.json').write_text(json.dumps(MIXTRAL_CKPT_HF))
    write_word_tokenizer(root, cfg.vocab_size, MIXTRAL_CKPT_SERVE['max_model_len'])
    return root


def phase_checkpoint_mixtral(torch, tpa, tqm, card, tmp: Path):
    """19d. Mixtral-8x7B widths at one layer, bf16 from seed 22, written as
    a checkpoint directory (about 3.4 GB) and served from a chat YAML's
    ``pretrained_model_name_or_path`` with ``quantization: int8``: its
    greedy tokens equal a direct engine's on the same tensors; K1 and K2
    launched on the served path, the plain versions never."""
    import yaml

    from distllm_tpu_torch.chat import ChatAppConfig
    from distllm_tpu_torch.generate.engine import LLMEngine
    from distllm_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig.from_hf_config(MIXTRAL_CKPT_HF)
    params = mixtral.init(cfg, torch.Generator(device=DEVICE).manual_seed(22), device=DEVICE)
    root = tmp / 'mixtral-8x7b-1l'
    t0 = time.perf_counter()
    write_mixtral_checkpoint(torch, root, params, cfg)
    write_s = time.perf_counter() - t0
    app_yaml = tmp / 'chat_mixtral.yaml'
    app_yaml.write_text(yaml.safe_dump({'system_prompt': '', 'generator_config': {
        'name': 'tpu', 'pretrained_model_name_or_path': str(root), 'quantization': 'int8',
        **MIXTRAL_CKPT_SERVE}}))
    t0 = time.perf_counter()
    generator = ChatAppConfig.from_yaml(str(app_yaml)).build_generator(device=DEVICE)
    build_s = time.perf_counter() - t0
    if generator.model_cfg.name != 'mixtral':
        fail(f'checkpoint mixtral: the YAML built {generator.model_cfg}')
    texts = checkpoint_prompts(8)
    batch = generator.tokenizer(texts)
    ids = [[int(t) for t, m in zip(r, mk) if m]
           for r, mk in zip(batch.input_ids, batch.attention_mask)]
    sampling, engine_cfg = generator.sampling_params(), generator.config.engine_config()
    zero_k1_counts(tpa)
    zero_k2_counts(tqm)
    t0 = time.perf_counter()
    served = generator.engine.generate_ids(ids, sampling)
    serve_s = time.perf_counter() - t0
    k1, k2 = tpa.ragged_paged_attention.launches, tqm.int8_matmul.launches
    plain = (tpa.ragged_paged_attention_reference.launches, tqm.int8_matmul_reference.launches)
    shut_down(torch, 'checkpoint mixtral served', generator.engine)
    del generator
    direct = LLMEngine(cfg, params, None, engine_cfg, device=DEVICE)
    direct.warmup()
    same = direct.generate_ids(ids, sampling) == served
    shut_down(torch, 'checkpoint mixtral direct', direct)
    del direct, params
    torch.cuda.empty_cache()
    gib = sum(f.stat().st_size for f in root.iterdir()) / 2**30
    log(f'[checkpoint mixtral] {card}: 1 layer at Mixtral-8x7B widths written in {write_s:.2f} s '
        f'({gib:.2f} GiB), served from {app_yaml.name} with int8 (built in {build_s:.2f} s): '
        f'{sum(map(len, served))} tokens in {serve_s:.3f} s; identical to the direct engine='
        f'{same}; K1 {k1}, K2 {k2}, plain {plain}')
    if not same:
        fail('checkpoint mixtral: tokens differ from an engine built on the same tensors')
    if k1 <= 0 or k2 <= 0 or plain != (0, 0):
        fail(f'checkpoint mixtral: K1 {k1}, K2 {k2}, plain {plain}')
    return dict(identical_to_direct=same, write_s=write_s, build_s=build_s, serve_s=serve_s,
                checkpoint_gib=gib, k1_launches=k1, k2_launches=k2)


# Phases 20-20d: tensor parallelism (ROADMAP A10b) on the one card. NCCL
# puts one rank on a device, so the two ranks of tensor_parallel_size 2
# share cuda:0 over gloo (collectives staged through the host; windows run
# eagerly): what this card can show is correctness and K1 / K2 at the
# ranks' shard shapes, not a TP speed.
TP_GENERATOR = {  # Mistral-7B at 16 of its 32 layers (depth cut to keep the run's time)
    'name': 'torch', 'model': {'name': 'mistral', 'num_layers': 16}, 'seed': 0,
    'tensor_parallel_size': 2,
    'tensor_parallel_backend': 'gloo', 'max_num_seqs': 8, 'block_size': BLOCK_SIZE,
    'num_blocks': 512, 'max_model_len': 1024, 'temperature': 0.0, 'max_tokens': 16,
}
TP_PROMPTS, TP_PROMPT_LENS, TP_NEW = 8, (64, 512), 16
# Phase 20a: Mixtral-8x7B int8 at full width, 4 of its 32 layers (8 before
# the cut to keep the run's time).
TP_MIXTRAL_MODEL, TP_MIXTRAL_NEW = {'name': 'mixtral', 'num_layers': 4}, 16
# Phase 20b: fp32 at Mistral-7B widths, depth 2; 20c: bf16, depth 4, on
# an NCCL group of one rank.
TP_IDENTITY_MODEL = dict(num_layers=2, dtype='float32')
TP_NCCL_MODEL = dict(num_layers=4)


def rank_launches(report, before, after):
    """K1 and K2 launches of one rank between two ``mark_kernels`` tags."""
    marks = report['kernel_marks']
    out = {}
    for key in ('ragged_paged_attention.launches', 'int8_matmul.launches',
                'ragged_paged_attention_reference.launches', 'int8_matmul_reference.launches'):
        out[key] = marks[after][key] - marks[before][key]
    return out


@contextlib.contextmanager
def k1_shapes(torch):
    """Record ``(query heads, KV heads)`` of every K1 call this process
    makes through the Mistral forward (rank 0's shard shapes)."""
    from distllm_tpu_torch.models import mistral

    seen = []
    kernel = mistral.ragged_paged_attention

    def recording(q, k_pages, *args, **kwargs):
        data = getattr(k_pages, 'data', k_pages)
        seen.append((int(q.shape[2]), int(data.shape[-2])))
        return kernel(q, k_pages, *args, **kwargs)

    mistral.ragged_paged_attention = recording
    try:
        yield seen
    finally:
        mistral.ragged_paged_attention = kernel


def check_tp_reports(tag, reports, engine):
    """Every rank ran the same programs and sampled the same tokens."""
    keys = {(r['programs'], r['results'], r['digest']) for r in reports}
    log(f'[{tag}] rank reports: ' + '; '.join(
        f'rank {r["rank"]}: {r["programs"]} programs, {r["results"]} token results, digest '
        f'{r["digest"]}, weights {r["weight_bytes"] / 2**30:.3f} GiB' for r in reports))
    if len(reports) != engine.mesh.size or len(keys) != 1 or reports[0]['results'] <= 0:
        fail(f'{tag}: the ranks disagree or sampled nothing: {reports}')


def profile_gloo_decode(torch, generator):
    """Where a gloo decode window's time goes, on phase 20's tp2 generator
    after its main path: 8 prompts of 64 words x 17 new tokens under
    torch.profiler (device activity), with each of rank 0's all-reduces timed on the host
    between a device sync before it (rank 0's queued kernels drain:
    ``sync_ms``) and one after it (the exchange staged through the host,
    waiting for rank 1 included: ``collective_ms``). Those syncs serialise
    the window, so its wall here exceeds phase 20's. Over the decode
    windows (each from its dispatch to its processing): their wall and the
    all-reduces' count and host times; over the whole profiled run: the
    device time of rank 0's kernels and of its copies and sets."""
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.parallel import comm

    engine = generator.engine
    all_reduce = comm.TensorParallel._all_reduce
    dispatch, process = engine._dispatch_window, engine._process_window
    acc = dict(windows=0, window_ms=0.0, all_reduces=0, sync_ms=0.0, collective_ms=0.0)
    opened = [None]

    def timed(x, group):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = all_reduce(x, group)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if opened[0] is not None:
            acc['all_reduces'] += 1
            acc['sync_ms'] += (t1 - t0) * 1e3
            acc['collective_ms'] += (t2 - t1) * 1e3
        return out

    def open_window():
        opened[0] = time.perf_counter()
        window = dispatch()
        if window is None:
            opened[0] = None
        return window

    def close_window(window):
        out = process(window)
        if opened[0] is not None:
            acc['windows'] += 1
            acc['window_ms'] += (time.perf_counter() - opened[0]) * 1e3
            opened[0] = None
        return out

    prompts = smoke_prompts(np.random.default_rng(24), 8, 64, 64)
    activities = [torch.profiler.ProfilerActivity.CUDA]
    comm.TensorParallel._all_reduce = staticmethod(timed)
    engine._dispatch_window, engine._process_window = open_window, close_window
    try:
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            generator.generate(prompts, SamplingParams(temperature=0.0, max_tokens=17))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        comm.TensorParallel._all_reduce = staticmethod(all_reduce)
        engine._dispatch_window, engine._process_window = dispatch, process
    kernel_ms = copy_ms = 0.0
    for event in prof.events():
        # Kernels, copies and sets; not the engine's distllm:<kind> ranges,
        # which the trace also places on the device.
        if (event.device_type != torch.autograd.DeviceType.CUDA
                or event.name.startswith('distllm:')):
            continue
        ms = event.time_range.elapsed_us() / 1e3
        if 'memcpy' in event.name.lower() or 'memset' in event.name.lower():
            copy_ms += ms
        else:
            kernel_ms += ms
    window_ms = acc['window_ms'] or float('nan')
    return dict(acc, run_wall_ms=wall_ms, device_kernel_ms=kernel_ms, device_copy_ms=copy_ms,
                collective_share_of_windows=acc['collective_ms'] / window_ms,
                sync_share_of_windows=acc['sync_ms'] / window_ms,
                device_kernel_share_of_run=kernel_ms / wall_ms)


def phase_tp_serve(torch, tpa, card):
    """20. Mistral-7B bf16 at full width (``TP_GENERATOR``'s depth), ``tensor_parallel_size:
    2`` through ``get_generator`` (random weights from seed 0; each rank
    draws them leaf by leaf and keeps its slices), the two ranks on one
    card over gloo: 8 greedy prompts of 64..512 tokens x 16 new. Each rank
    holds half the weights and 4 of the 8 KV heads; K1 runs at 16 query /
    4 KV heads, layers x forward passes on each rank (rank 1's counts from
    its report), the plain op never; both ranks sample the same tokens.
    Tokens are compared with the one-rank generator's by agreement share
    (bf16: row-parallel partial products round before their sum).
    20d. One HTTP request through ``ChatServer`` on the same generator."""
    from distllm_tpu_torch.chat_server import ChatServer
    from distllm_tpu_torch.generate import get_generator
    from distllm_tpu_torch.generate.engine import SamplingParams

    tag = 'tp serve'
    prompts = smoke_prompts(np.random.default_rng(20), TP_PROMPTS, *TP_PROMPT_LENS)
    sampling = SamplingParams(temperature=0.0, max_tokens=TP_NEW)
    one = get_generator({**TP_GENERATOR, 'tensor_parallel_size': 1}, device=DEVICE)
    t0 = time.perf_counter()
    want = one.generate(prompts, sampling)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_gib = (one.engine.weight_bytes_float + one.engine.weight_bytes_quantized) / 2**30
    shut_down(torch, f'{tag} one rank', one.engine)
    del one
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    generator = get_generator(TP_GENERATOR, device=DEVICE)
    build_s = time.perf_counter() - t0
    engine = generator.engine
    cfg = engine.model_cfg
    local_heads = (engine.params['layers']['q']['kernel'].shape[-1] // cfg.head_size,
                   engine.kv.k.shape[3])
    shard_heads = (cfg.num_heads // 2, cfg.num_kv_heads // 2)  # 16 / 4 at 7B
    if (engine.mesh.shape['model'], engine.mesh.backend, local_heads) != (
            2, 'gloo', shard_heads) or engine.stats['decode_graphs']:
        fail(f'{tag}: mesh {engine.mesh.shape} over {engine.mesh.backend}, local heads '
             f'{local_heads}, decode graphs {engine.stats.get("decode_graphs")}')
    log(f'[{tag}] {card}: get_generator built tensor_parallel_size 2 (gloo, ranks on '
        f'{engine.mesh.num_devices} device, rank 0 on {engine.mesh.device}) in {build_s:.2f} s; rank 0 holds {local_heads[0]} query / '
        f'{local_heads[1]} KV heads, {engine.weight_bytes_float / 2**30:.3f} GiB of weights '
        f'(one rank: {one_gib:.3f}); windows eager: {engine.telemetry.get("decode_graphs_reason")}')
    rec = instrument_windows(torch, engine)
    stats0 = dict(engine.stats)
    # The main path: counts to 0 just before, read just after (rank 1's
    # from its marks).
    zero_k1_counts(tpa)
    engine.mark_kernels('serve_before')
    with k1_shapes(torch) as shapes:
        t0 = time.perf_counter()
        outputs = generator.generate(prompts, sampling)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    engine.mark_kernels('serve_after')
    run = stats_delta(engine, stats0)
    passes = run['forward_passes']
    k1 = tpa.ragged_paged_attention.launches
    k1_routes = dict(tpa.ragged_paged_attention.launches_by_route)
    if (k1 != cfg.num_layers * passes or tpa.ragged_paged_attention_reference.launches
            or set(shapes) != {shard_heads}):
        fail(f'{tag}: K1 {k1} for {cfg.num_layers} x {passes} passes, plain '
             f'{tpa.ragged_paged_attention_reference.launches}, shapes {set(shapes)}')
    agree = greedy_match([o.split() for o in outputs], [w.split() for w in want])
    tok_s = run['generated_tokens'] / wall_s
    decode_ms = median([w['wall_ms'] / w['steps'] for w in rec['window'] if w['steps']])
    log(f'[{tag}] {card}: {TP_PROMPTS} prompts ({TP_PROMPT_LENS[0]}..{TP_PROMPT_LENS[1]} '
        f'tokens) x {TP_NEW} new: {run["generated_tokens"]} tokens in {wall_s:.3f} s = '
        f'{tok_s:.2f} tok/s (two ranks timesharing one card, not a TP speed; one rank took '
        f'{one_s:.3f} s), decode {decode_ms} ms a pass (window wall over its steps, median); '
        f'K1 {k1} launches by route {json.dumps(k1_routes)} at (q, KV) heads {sorted(set(shapes))}; '
        f'bf16 agreement with the one-rank generator {agree:.4f}')
    if len(outputs) != TP_PROMPTS or run['generated_tokens'] != TP_PROMPTS * TP_NEW:
        fail(f'{tag}: {len(outputs)} outputs, {run["generated_tokens"]} tokens')
    # 20d. One request over HTTP to the chat server on this generator.
    t0 = time.perf_counter()
    with ChatServer(generator, port=0) as server:
        status, body = post_completion(server.port, 0)
    http_s = time.perf_counter() - t0
    engine.mark_kernels('http_after')
    http_k1 = tpa.ragged_paged_attention.launches - k1
    if status != 200 or not isinstance(body['choices'][0]['message']['content'], str) \
            or http_k1 <= 0:
        fail(f'{tag}: chat completion answered {status} {body}; K1 {http_k1} launches')
    log(f'[tp http] {card}: one chat completion over the tp2 generator in {http_s:.3f} s, '
        f'status {status}, K1 {http_k1} launches on rank 0')
    gloo = profile_gloo_decode(torch, generator)
    log(f'[tp gloo profile] {card}: {gloo["windows"]} decode windows, {gloo["window_ms"]:.1f} '
        f'ms: {gloo["all_reduces"]} all-reduces on rank 0 held {gloo["collective_ms"]:.1f} ms '
        f'in the exchange (share {gloo["collective_share_of_windows"]:.4f}) after '
        f'{gloo["sync_ms"]:.1f} ms draining rank 0\'s queued kernels (share '
        f'{gloo["sync_share_of_windows"]:.4f}); the whole profiled run: '
        f'{gloo["run_wall_ms"]:.1f} ms wall, rank 0 kernels {gloo["device_kernel_ms"]:.1f} ms '
        f'on the device (share {gloo["device_kernel_share_of_run"]:.4f}), copies and sets '
        f'{gloo["device_copy_ms"]:.1f} ms; {json.dumps(gloo)}')
    generator.shutdown()
    reports = generator.rank_reports
    check_tp_reports(tag, reports, engine)
    rank1 = rank_launches(reports[1], 'serve_before', 'serve_after')
    rank1_http = rank_launches(reports[1], 'serve_after', 'http_after')
    if (rank1['ragged_paged_attention.launches'] != k1
            or rank1['ragged_paged_attention_reference.launches']
            or rank1_http['ragged_paged_attention.launches'] != http_k1):
        fail(f'{tag}: rank 1 launched {rank1} (HTTP {rank1_http}); rank 0 K1 {k1} / {http_k1}')
    weights = [r['weight_bytes'] / 2**30 for r in reports]
    del generator, engine
    torch.cuda.empty_cache()
    return dict(build_s=build_s, wall_s=wall_s, tokens_per_s=tok_s, decode_pass_ms=decode_ms,
                one_rank_s=one_s, forward_passes=passes, launches=k1,
                launches_by_route=k1_routes, rank1_launches=rank1['ragged_paged_attention.launches'],
                local_heads=list(local_heads), rank_weight_gib=weights, one_rank_gib=one_gib,
                agreement=agree, http_s=http_s, http_status=status, http_launches=http_k1,
                rank1_http_launches=rank1_http['ragged_paged_attention.launches'],
                digests=[r['digest'] for r in reports], gloo_profile=gloo)


def phase_tp_mixtral(torch, tpa, tqm, card):
    """20a. Mixtral-8x7B int8 at full width, ``TP_MIXTRAL_MODEL``'s layers, at
    ``tensor_parallel_size: 2`` through ``get_generator`` (each rank draws
    one layer's leaves at a time, quantizes them whole and keeps its
    slices: the row-parallel ``o`` with its whole scales). K1 on every
    layer of every pass and K2 on q / k / v / o at the shard shapes, on
    both ranks; per-rank GiB."""
    from distllm_tpu_torch.generate import get_generator
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.ops.quantization import QTensor

    tag = 'tp mixtral'
    config = {**TP_GENERATOR, 'model': dict(TP_MIXTRAL_MODEL), 'quantization': 'int8'}
    t0 = time.perf_counter()
    generator = get_generator(config, device=DEVICE)
    build_s = time.perf_counter() - t0
    engine = generator.engine
    cfg = engine.model_cfg
    bank = engine.params['layers']['gate']['kernel']
    o = engine.params['layers']['o']['kernel']
    want_bank = (cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size // 2)
    want_o = (cfg.num_layers, cfg.num_heads * cfg.head_size // 2, cfg.hidden_size)
    if not (isinstance(bank, QTensor) and bank.shape == want_bank and isinstance(o, QTensor)
            and o.shape == want_o):
        fail(f'{tag}: gate bank {bank!r}, o {o!r}')
    prompts = smoke_prompts(np.random.default_rng(21), TP_PROMPTS, *TP_PROMPT_LENS)
    sampling = SamplingParams(temperature=0.0, max_tokens=TP_MIXTRAL_NEW)
    stats0 = dict(engine.stats)
    zero_k1_counts(tpa)
    zero_k2_counts(tqm)
    engine.mark_kernels('before')
    t0 = time.perf_counter()
    outputs = generator.generate(prompts, sampling)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    engine.mark_kernels('after')
    run = stats_delta(engine, stats0)
    passes = run['forward_passes']
    k1, k2 = tpa.ragged_paged_attention.launches, tqm.int8_matmul.launches
    k2_routes = dict(tqm.int8_matmul.launches_by_route)
    plain = (tpa.ragged_paged_attention_reference.launches, tqm.int8_matmul_reference.launches)
    generator.shutdown()
    reports = generator.rank_reports
    check_tp_reports(tag, reports, engine)
    rank1 = rank_launches(reports[1], 'before', 'after')
    gib = [r['weight_bytes'] / 2**30 for r in reports]
    log(f'[{tag}] {card}: Mixtral-8x7B int8, {cfg.num_layers} of 32 layers, tp2 over gloo '
        f'on one card, built in {build_s:.2f} s; per-rank weights {gib} GiB (gate bank '
        f'{bank.shape} on rank 0); {len(outputs)} prompts x {TP_MIXTRAL_NEW} new in '
        f'{wall_s:.3f} s = {run["generated_tokens"] / wall_s:.2f} tok/s; rank 0 K1 {k1}, K2 {k2} '
        f'({json.dumps(k2_routes)}), plain {plain}; rank 1 {json.dumps(rank1)}')
    if (k1 != cfg.num_layers * passes or k2 != 4 * cfg.num_layers * passes or plain != (0, 0)
            or rank1['ragged_paged_attention.launches'] != k1
            or rank1['int8_matmul.launches'] != k2
            or run['generated_tokens'] != TP_PROMPTS * TP_MIXTRAL_NEW):
        fail(f'{tag}: K1 {k1}, K2 {k2} for {passes} passes; plain {plain}; rank 1 {rank1}')
    del generator, engine, bank, o
    torch.cuda.empty_cache()
    return dict(build_s=build_s, wall_s=wall_s, tokens_per_s=run['generated_tokens'] / wall_s,
                forward_passes=passes, launches=k1, k2_launches=k2, k2_launches_by_route=k2_routes,
                rank1_launches=rank1['ragged_paged_attention.launches'],
                rank1_k2_launches=rank1['int8_matmul.launches'], rank_weight_gib=gib)


def phase_tp_identity(torch, tpa, tqm):
    """20b. fp32 at Mistral-7B widths, depth 2, in two arms: float weights,
    and int8 weights (quantized as drawn; tp2 shards the codes: q / k / v
    / gate / up column-parallel with their scales, o / down row-parallel
    with the whole scales). In each, greedy tokens of tp2 on the kernels
    (two ranks over gloo on the card) equal tp1's on the kernels and tp1's
    on the plain ops; on rank 0 K1 runs layers x passes and (int8) K2 7 x
    layers x passes, all on the CUDA cores, the plain ops never. The float
    arm's tp2 engine (no tiers, no prefix cache) then serves phase 22's
    fp32 traffic one request at a time: its tokens are 22's "tp2 with the
    tiers off" (returned under ``tier_traffic_tokens``)."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.generate.engine.sharded import ShardedEngine, WeightSource
    from distllm_tpu_torch.models import mistral

    cfg = mistral.MistralConfig(**TP_IDENTITY_MODEL)
    rng = np.random.default_rng(22)
    prompts = [[int(t) for t in rng.integers(4, cfg.vocab_size, size=n)]
               for n in (16, 100, 300, 37, 520)]
    sampling = SamplingParams(temperature=0.0, max_tokens=16)
    result = {}
    for weights, quant in (('float', None), ('int8', 'int8')):
        config = EngineConfig(block_size=BLOCK_SIZE, num_blocks=256, max_num_seqs=4,
                              max_model_len=1024, quantization=quant)
        params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(3), device=DEVICE,
                              quantization=quant)
        outs = {}
        for arm, backend in (('tp1_kernels', 'auto'), ('tp1_plain', 'reference')):
            one = LLMEngine(cfg, params, None, config, device=DEVICE, attn_backend=backend,
                            qmm_backend=backend)
            outs[arm] = one.generate_ids(prompts, sampling)
            shut_down(torch, f'tp identity {weights} {arm}', one)
            del one
        del params
        sharded = ShardedEngine(2, cfg, WeightSource('init', seed=3, quantization=quant),
                                config, backend='gloo', devices=DEVICE)
        zero_k1_counts(tpa)
        zero_k2_counts(tqm)
        outs['tp2_kernels'] = sharded.engine.generate_ids(prompts, sampling)
        passes = sharded.engine.telemetry['forward_passes']
        k1 = (tpa.ragged_paged_attention.launches, tpa.ragged_paged_attention_reference.launches)
        k2 = (tqm.int8_matmul.launches, tqm.int8_matmul_reference.launches)
        cores = (tpa.ragged_paged_attention.launches_by_route['cuda_cores'],
                 tqm.int8_matmul.launches_by_route['cuda_cores'])
        if not quant:
            tier_traffic = serve_one_by_one(
                sharded.engine, tier_tp_workload(cfg.vocab_size, seed=23),
                SamplingParams(temperature=0.0, max_tokens=TIER_TP_IDENTITY_NEW))
        reports = sharded.close()
        check_tp_reports(f'tp identity {weights} tp2_kernels', reports, sharded.engine)
        want_k2 = 7 * cfg.num_layers * passes if quant else 0
        if k1 != (cfg.num_layers * passes, 0) or k2 != (want_k2, 0) or cores != (k1[0], k2[0]):
            fail(f'tp identity {weights}: K1 (kernel, plain) {k1}, K2 {k2} for {passes} '
                 f'passes, CUDA cores {cores}')
        del sharded
        torch.cuda.empty_cache()
        same = outs['tp2_kernels'] == outs['tp1_kernels'] == outs['tp1_plain']
        key = 'tp2_kernels' if weights == 'float' else 'tp2_int8'
        result[key] = dict(k1_launches=k1[0], k2_launches=k2[0], forward_passes=passes,
                           identical=same)
        log(f'[tp identity] fp32 depth 2 at Mistral-7B widths, {weights} weights, '
            f'{len(prompts)} prompts x 16 greedy tokens: tp2 on the kernels == tp1 on the '
            f'kernels == tp1 on the plain ops: {same}; {json.dumps(result[key])}')
        if not same:
            fail(f'tp identity {weights}: {outs}')
    result['identical'] = all(r['identical'] for r in result.values())
    result['tier_traffic_tokens'] = tier_traffic
    return result


def phase_tp_nccl(torch, tpa, card):
    """20c. An NCCL group of one rank (the collectives NCCL runs across
    cards, on one): Mistral-7B widths at 4 layers, bf16. The decode and
    verify windows are captured CUDA graphs with their collectives inside
    (each captured step issued 2 all-reduces a layer and the logits'
    gather while capturing; the serve replays them without Python), and
    the greedy tokens are bitwise those of the unsharded engine. One rank's
    in-place NCCL all-reduce enqueues no device work, so the profiled
    replay's NCCL kernel count (printed) is what one card cannot show."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mistral
    from distllm_tpu_torch.parallel import comm, mesh, multihost

    cfg = mistral.MistralConfig(**TP_NCCL_MODEL)
    params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(4), device=DEVICE)
    prompts = [[int(t) for t in np.random.default_rng(23).integers(4, cfg.vocab_size, size=n)]
               for n in (24, 200, 61, 410, 9, 333)]
    sampling = SamplingParams(temperature=0.0, max_tokens=24)
    group = multihost.RankGroup(1, None, (), backend='nccl')
    calls = [0]
    all_reduce = comm.TensorParallel._all_reduce

    def counting(x, g):
        calls[0] += 1
        return all_reduce(x, g)

    comm.TensorParallel._all_reduce = staticmethod(counting)
    result = {}
    try:
        rank_mesh = mesh.make_mesh(mesh.MeshSpec(data=1, model=1), devices=DEVICE,
                                   backend='nccl')
        per_step = 2 * cfg.num_layers + 1  # o and down a layer, the logits' gather
        for arm, knobs in (('decode', {}), ('verify', {'draft_k': 4})):
            tag = f'tp nccl {arm}'
            config = EngineConfig(block_size=BLOCK_SIZE, num_blocks=256, max_num_seqs=8,
                                  max_model_len=1024, **knobs)
            base = LLMEngine(cfg, params, None, config, device=DEVICE)
            want = base.generate_ids(prompts, sampling)
            shut_down(torch, f'{tag} unsharded', base)
            engine = LLMEngine(cfg, params, None, config, device=DEVICE, mesh=rank_mesh)
            calls[0] = 0
            engine.warmup()
            warm_calls = calls[0]
            runners = 2 if knobs else 1
            # Per runner: two eager warm-up steps and two captures.
            if warm_calls != runners * 4 * per_step or not engine.stats['decode_graphs']:
                fail(f'{tag}: {warm_calls} collectives at warm-up, expected '
                     f'{runners} x 4 x {per_step}')
            marks = graph_marks(engine)
            zero_k1_counts(tpa)
            calls[0] = 0
            got = engine.generate_ids(prompts, sampling)
            run_calls = calls[0]
            passes = engine.telemetry['forward_passes']
            prefills = engine.telemetry['prefill_dispatches']
            verify = engine.telemetry.get('spec_windows', 0)
            graphs = check_graph_replays(tag, engine, marks, passes, prefills, verify)
            profile = profile_nccl(torch, engine, arm)
            same = got == want
            log(f'[{tag}] {card}: {warm_calls} all-reduces issued at warm-up (captured into '
                f'the graphs), {run_calls} in the serve = {prefills} eager prefills x {per_step} '
                f'(every {arm} pass a replay: {json.dumps(graphs)}); NCCL kernels in one '
                f'profiled replay: {profile}; bf16 tokens bitwise the unsharded engine\'s: {same}')
            if not same or run_calls != prefills * per_step:
                fail(f'{tag}: tokens equal {same}; {run_calls} collectives for {prefills} prefills')
            result[arm] = dict(graphs, warmup_collectives=warm_calls, serve_collectives=run_calls,
                               forward_passes=passes, launches=tpa.ragged_paged_attention.launches,
                               nccl_kernels_in_replay=profile, identical=same)
            shut_down(torch, tag, engine)
            del engine
    finally:
        comm.TensorParallel._all_reduce = staticmethod(all_reduce)
        group.close()
    del params
    torch.cuda.empty_cache()
    return result


def profile_nccl(torch, engine, arm):
    """Kernel names with 'nccl' in one profiled replay of the engine's
    greedy captured step (None when the profiler saw no device work)."""
    runner = engine._decode if arm == 'decode' else engine._verify
    captured = runner.graphs[True]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        captured.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return None
    return sum(1 for n in names if 'nccl' in n.lower())


# ---------------------------------------------------------- phases 21-21d
# Phase 21: the files of phase 10's corpus, split for the fabric.
FABRIC_FILES, FABRIC_BATCH = 8, 128
# The workers' own flags after the rendered line: heartbeats every second
# against the kill arm's threshold of a few seconds.
FABRIC_WORKER_FLAGS = ('--heartbeat-interval', '1', '--idle-timeout', '600')
FABRIC_THRESHOLD_S = 5.0
FABRIC_STALL_S = 120.0  # the kill arm's victim stalls its first task this long
FABRIC_WAIT_S = 300.0  # the longest a worker, replica or router may take to start
# 21a: the world's backend (a world of one on the card).
FABRIC_WORLD_BACKEND = 'nccl'
# 21b: the JAX gen_router stage's small tier (bench.py:1662-1680) and pool
# (48 blocks of 16: 6 sessions x 9 prefix blocks exceed one pool), served
# by two chat-server processes of Mistral-7B bf16 at full width, 16 of its
# 32 layers (depth cut to keep the run's time).
ROUTER_LOAD = dict(seed=0, num_requests=32, rate_rps=2.0, num_sessions=6, warm_fraction=0.75,
                   prefix_tokens=144, prompt_tokens=(8, 16), output_tokens=(4, 10),
                   vocab_size=2048)
ROUTER_GENERATOR = dict(name='torch', model={'name': 'mistral', 'num_layers': 16},
                        temperature=0.0, max_tokens=8,
                        block_size=BLOCK_SIZE, num_blocks=48, max_num_seqs=3, max_model_len=256,
                        decode_steps=4, seed=0, enable_prefix_cache=True)
# 21c: three fp32 replicas at 7B width and depth 2, the prefix cache off (a
# hit changes fp32 arithmetic), one killed at a third of the schedule.
FAILOVER_MODEL = {'name': 'mistral', 'num_layers': 2, 'dtype': 'float32'}
FAILOVER_LOAD = dict(ROUTER_LOAD, seed=3, num_requests=18, rate_rps=4.0)
# 21d: the JAX stage's peer arm (a 150-token prompt, junk to evict it, 8
# greedy tokens), then at full depth in bf16 a 1024-token prompt.
PEER_POOL = dict(block_size=BLOCK_SIZE, num_blocks=48, max_num_seqs=3, max_model_len=256,
                 decode_steps=4, enable_prefix_cache=True, host_kv_tier_bytes=1 << 30)
PEER_BF16_POOL = dict(PEER_POOL, num_blocks=80, max_model_len=1100)
PEER_PROMPT, PEER_BF16_PROMPT, PEER_NEW = 150, 1024, 8
# Which kernel counter of a replica's shutdown report is K1's launches.
REPLICA_K1 = 'ragged_paged_attention.launches'


def counted_embedding_worker(file, **kwargs):
    """``distributed_embedding.embedding_worker`` as phase 21's fabric task
    (the worker resolves it by import path): the shard, and this process's
    pid and K3 launches for the file. A worker started with
    ``CHIP_SMOKE_STARTS`` leaves a start marker per task there; one
    started with ``CHIP_SMOKE_STALL_S`` stalls its first task that long
    before working (the kill arm's victim)."""
    import os

    from distllm_tpu_torch.distributed_embedding import embedding_worker
    from distllm_tpu_torch.ops import encoder_attention as tea

    starts = os.environ.get('CHIP_SMOKE_STARTS')
    if starts:
        first = not any(p.name.startswith(f'{os.getpid()}-') for p in Path(starts).iterdir())
        Path(starts, f'{os.getpid()}-{Path(file).name}').write_text(repr(time.time()))
        if first:
            time.sleep(float(os.environ.get('CHIP_SMOKE_STALL_S') or 0))
    tensor_cores = lambda: (tea.encoder_attention.launches_by_route['tensor_cores']  # noqa: E731
                            + tea.encoder_attention.launches_by_route['wgmma'])
    before = (tea.encoder_attention.launches, tensor_cores(),
              tea.encoder_attention_reference.launches)
    t0 = time.perf_counter()
    shard = embedding_worker(file, **kwargs)
    return dict(file=file, shard=shard, pid=os.getpid(), seconds=time.perf_counter() - t0,
                k3=tea.encoder_attention.launches - before[0],
                k3_tensor_cores=tensor_cores() - before[1],
                plain=tea.encoder_attention_reference.launches - before[2])


def world_task(values):
    """Phase 21a's task in a ``--jax-distributed`` worker: its rank, world
    size and backend, and one all-reduce of ``values`` on the card."""
    import os

    import torch
    import torch.distributed as dist

    device = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    tensor = torch.tensor(values, dtype=torch.float32, device=device)
    dist.all_reduce(tensor)
    if device == 'cuda':
        torch.cuda.synchronize()
    return dict(rank=dist.get_rank(), size=dist.get_world_size(), backend=dist.get_backend(),
                values=tensor.cpu().tolist(), device=str(tensor.device), pid=os.getpid(),
                card=torch.cuda.get_device_name(0) if device == 'cuda' else 'cpu')


def this_module():
    """This script as the importable module ``chip_smoke``: a fabric task
    must be pickled under a name its worker can import."""
    import importlib

    return importlib.import_module('chip_smoke')


def start_process(argv, log_path: Path, **env):
    """``argv`` (``python`` replaced by this interpreter) from the root of
    the checkout, stdout and stderr into ``log_path``."""
    import os

    argv = [sys.executable if a == 'python' else a for a in argv]
    root = str(Path(__file__).resolve().parent)
    path = os.pathsep.join(p for p in (root, os.environ.get('PYTHONPATH')) if p)
    full_env = dict(os.environ, PYTHONPATH=path, DISTLLM_HISTORY_S='0', **env)
    with open(log_path, 'w') as fh:
        return subprocess.Popen(argv, cwd=Path(__file__).resolve().parent, env=full_env,
                                stdout=fh, stderr=subprocess.STDOUT)


def stop_processes(procs, timeout=60.0, sig=None):
    """Signal each process (``sig``; None just waits), wait for it (kill
    it past ``timeout``); their exit codes."""
    import signal as _signal

    for proc in procs:
        if sig is not None and proc.poll() is None:
            proc.send_signal(sig)
    codes = []
    deadline = time.monotonic() + timeout
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            proc.send_signal(_signal.SIGKILL)
            codes.append(proc.wait(timeout=30))
    return codes


def log_tail(path: Path, n=30) -> str:
    return '\n'.join(Path(path).read_text(errors='replace').splitlines()[-n:])


def rendered_worker_argv(script: str) -> list[str]:
    """The ``python -m distllm_tpu_torch.parallel.worker ...`` command of a
    rendered job script's launch line (after mpiexec / srun and their
    flags)."""
    line = [ln for ln in script.splitlines() if 'distllm_tpu_torch.parallel.worker' in ln][-1]
    return line[line.index('python -m'):].split()


@contextlib.contextmanager
def patched(obj, **attrs):
    saved = {name: getattr(obj, name) for name in attrs}
    for name, value in attrs.items():
        setattr(obj, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(obj, name, value)


def timer_stages(log_path: Path) -> dict:
    """Seconds by stage of a worker log's ``[timer]`` lines (its files
    summed): where a worker's time went."""
    out = {}
    for line in Path(log_path).read_text(errors='replace').splitlines():
        if line.startswith('[timer] tags='):
            fields = dict(f.split('=', 1) for f in line.split()[1:3])
            stage = fields['tags'].split(',')[0]
            out[stage] = round(out.get(stage, 0.0) + float(fields['elapsed_s']), 3)
    return out


def read_shard(path):
    from datasets import load_from_disk

    ds = load_from_disk(str(path))
    return list(ds['text']), np.asarray(ds['embeddings'], dtype=np.float32)


def phase_fabric(torch, tea, card, tmp: Path):
    """Phases 21 and 21a (see the module docstring)."""
    import signal as _signal

    from distllm_tpu_torch import distributed_embedding
    from distllm_tpu_torch.models import bert
    from distllm_tpu_torch.parallel import launcher
    from distllm_tpu_torch.parallel.multihost import free_port

    this = this_module()
    cfg = RETRIEVER_BERT() if RETRIEVER_BERT else bert.BertConfig()
    t0 = time.perf_counter()
    ckpt = write_bert_checkpoint(torch, tmp / 'bert', cfg, seed=0, word='tok')
    corpus = tmp / 'corpus.jsonl'
    write_corpus(corpus)
    lines = corpus.read_text().splitlines()
    inputs = tmp / 'files'
    inputs.mkdir()
    per = -(-len(lines) // FABRIC_FILES)
    for f in range(FABRIC_FILES):
        (inputs / f'part{f}.jsonl').write_text('\n'.join(lines[f * per:(f + 1) * per]) + '\n')
    setup_s = time.perf_counter() - t0

    # The scripts: pbspro (21, 21's kill arm) and slurm (21a), dry runs.
    ports = {arm: free_port() for arm in ('pod', 'kill', 'slurm', 'world')}
    endpoint = {arm: f'tcp://127.0.0.1:{ports[arm]}' for arm in ('pod', 'kill', 'slurm')}
    pbs = {arm: dict(name='pbspro', account='chip', queue='smoke', num_nodes=2, submit=False,
                     coordinator_port=ports[arm], advertise_host='127.0.0.1',
                     select=':ngpus=1',
                     heartbeat_threshold=FABRIC_THRESHOLD_S if arm == 'kill' else 120.0)
           for arm in ('pod', 'kill')}
    slurm = dict(name='slurm', account='chip', queue='smoke', partition='gpu', num_nodes=1,
                 submit=False, coordinator_port=ports['slurm'], advertise_host='127.0.0.1',
                 jax_distributed=True, jax_coordinator_port=ports['world'])
    scripts = {arm: launcher.get_compute_config(pbs[arm]).render_script(
        endpoint[arm], tmp / f'run_{arm}') for arm in ('pod', 'kill')}
    scripts['slurm'] = launcher.get_compute_config(slurm).render_script(
        endpoint['slurm'], tmp / 'run_slurm')
    for arm in ('pod', 'kill'):
        if (f'mpiexec -n 2 --ppn 1 --envall python -m distllm_tpu_torch.parallel.worker '
                f'--coordinator {endpoint[arm]}') not in scripts[arm] \
                or '#PBS -l select=2:ngpus=1' not in scripts[arm]:
            fail(f'fabric: the pbspro script is not the expected one:\n{scripts[arm]}')
    expected_slurm = [
        '#SBATCH --partition=gpu', '#SBATCH --nodes=1', '#SBATCH --ntasks-per-node=1',
        f'| head -n1):{ports["world"]}"', 'export DISTLLM_JAX_NUM_PROCESSES=1',
        f'srun --ntasks=1 --ntasks-per-node=1 python -m distllm_tpu_torch.parallel.worker '
        f'--coordinator {endpoint["slurm"]} --jax-distributed',
    ]
    missing = [s for s in expected_slurm if s not in scripts['slurm']]
    if missing:
        fail(f'fabric: the slurm script lacks {missing}:\n{scripts["slurm"]}')

    # Every worker starts now, from its script's rendered line: two for the
    # pod run, two for the kill arm (the victim stalls its first task), one
    # --jax-distributed for 21a. They dial until their coordinator binds.
    starts = {arm: tmp / f'starts_{arm}' for arm in ('pod', 'kill')}
    for d in starts.values():
        d.mkdir()
    procs = {}
    for arm in ('pod', 'kill'):
        argv = rendered_worker_argv(scripts[arm]) + list(FABRIC_WORKER_FLAGS)
        procs[arm] = [start_process(argv, tmp / f'worker_{arm}{i}.log',
                                    CHIP_SMOKE_STARTS=str(starts[arm]),
                                    **({'CHIP_SMOKE_STALL_S': str(FABRIC_STALL_S)}
                                       if arm == 'kill' and i == 0 else {}))
                      for i in range(2)]
    world_argv = rendered_worker_argv(scripts['slurm']) + [
        '--distributed-backend', FABRIC_WORLD_BACKEND, *FABRIC_WORKER_FLAGS]
    procs['slurm'] = [start_process(
        world_argv, tmp / 'worker_slurm.log', DISTLLM_JAX_COORDINATOR=f'127.0.0.1:{ports["world"]}',
        DISTLLM_JAX_NUM_PROCESSES='1', DISTLLM_JAX_PROCESS_ID='0')]
    try:
        encoder_config = {'name': 'auto', 'pretrained_model_name_or_path': str(ckpt),
                          'half_precision': True}
        files = sorted(str(p) for p in inputs.glob('*.jsonl'))

        def config(out, compute):
            return distributed_embedding.Config(
                input_dir=inputs, output_dir=out, glob_patterns=['*.jsonl'],
                dataset_config={'name': 'jsonl', 'batch_size': FABRIC_BATCH},
                encoder_config=encoder_config, pooler_config={'name': 'mean'},
                embedder_config={'name': 'full_sequence'}, writer_config={'name': 'huggingface'},
                compute_config=compute,
            )

        captured = {}

        def capturing(executor, fn, items):
            captured['executor'] = executor
            captured['results'] = launcher.map_with_teardown(executor, fn, items)
            return captured['results']

        # The local run, in this process: the reference shards.
        zero_k3_counts(tea)
        t0 = time.perf_counter()
        with patched(distributed_embedding, map_with_teardown=capturing):
            if distributed_embedding.run_embedding(config(tmp / 'out_local', {'name': 'local'}),
                                                   device=DEVICE) != 0:
                fail('fabric: the local run failed')
        torch.cuda.synchronize()
        local_s = time.perf_counter() - t0
        local_k3 = check_k3_kernel(tea, 'fabric local')
        local = [read_shard(s) for s in captured['results']]

        def pod_run(arm, victim=None):
            captured.clear()
            box = {}

            def run():
                try:
                    box['rc'] = distributed_embedding.run_embedding(
                        config(tmp / f'out_{arm}', pbs[arm]), device=DEVICE)
                except BaseException as exc:  # noqa: BLE001 - reported below
                    box['error'] = exc

            t0 = time.perf_counter()
            with patched(distributed_embedding, map_with_teardown=capturing,
                         embedding_worker=this.counted_embedding_worker):
                thread = threading.Thread(target=run, daemon=True)
                thread.start()
                killed_at = None
                if victim is not None:
                    deadline = time.monotonic() + FABRIC_WAIT_S
                    while killed_at is None:
                        marks = [p for p in starts[arm].iterdir()
                                 if p.name.startswith(f'{victim.pid}-')]
                        if marks:
                            victim.send_signal(_signal.SIGKILL)
                            killed_at = time.time()
                            victim_file = marks[0].name.split('-', 1)[1]
                        elif time.monotonic() > deadline or victim.poll() is not None:
                            fail(f'fabric {arm}: the victim never started a task\n'
                                 f'{log_tail(tmp / f"worker_{arm}0.log")}')
                        else:
                            time.sleep(0.05)
                    # The coordinator's requeue: the victim's silence past the
                    # threshold, seen by its poll loop.
                    while thread.is_alive() and not (
                            'executor' in captured and captured['executor'].coordinator.requeued):
                        time.sleep(0.02)
                    requeued_at = time.time()
                thread.join(FABRIC_WAIT_S + FABRIC_STALL_S)
            wall_s = time.perf_counter() - t0
            if thread.is_alive() or box.get('rc') != 0:
                fail(f'fabric {arm}: the pod run did not finish ({box})\n'
                     + '\n'.join(log_tail(tmp / f'worker_{arm}{i}.log') for i in range(2)))
            results = captured['results']
            coordinator = captured['executor'].coordinator
            coordinator.close()
            out = dict(wall_s=wall_s, files_per_s=len(files) / wall_s,
                       requeued=coordinator.requeued, results=results)
            if victim is not None:
                survivor_starts = [float(p.read_text()) for p in starts[arm].iterdir()
                                   if p.name.endswith(f'-{victim_file}')
                                   and not p.name.startswith(f'{victim.pid}-')]
                out.update(victim_file=victim_file, requeue_s=requeued_at - killed_at,
                           restart_s=(min(survivor_starts) - killed_at if survivor_starts else None))
            return out

        arms = {}
        for arm, victim in (('pod', None), ('kill', procs['kill'][0])):
            res = pod_run(arm, victim)
            results = res.pop('results')
            if [r['file'] for r in results] != files:
                fail(f'fabric {arm}: results are not in the files\' order')
            shards = sorted(p for p in (tmp / f'out_{arm}' / 'embeddings').iterdir())
            if len(shards) != len(files) or sorted(r['shard'] for r in results) != [
                    str(p) for p in shards]:
                fail(f'fabric {arm}: {len(shards)} shards for {len(files)} files')
            worst = 0.0
            for r, (texts, emb) in zip(results, local):
                got_texts, got = read_shard(r['shard'])
                if got_texts != texts or got.shape != emb.shape or not np.isfinite(got).all():
                    fail(f'fabric {arm}: the shard of {r["file"]} is not the local one')
                worst = max(worst, float((np.abs(got - emb)
                                          / (EMBED_RTOL * np.abs(emb) + EMBED_ATOL)).max()))
            if not worst <= 1.0:
                fail(f'fabric {arm}: shards differ from the local run ({worst:.3f} x tolerance)')
            by_worker = {}
            for r in results:
                w = by_worker.setdefault(r['pid'], dict(tasks=0, k3=0, k3_tensor_cores=0, plain=0))
                for key in ('k3', 'k3_tensor_cores', 'plain'):
                    w[key] += r[key]
                w['tasks'] += 1
            if any(w['k3'] <= 0 or w['k3_tensor_cores'] != w['k3'] or w['plain']
                   for w in by_worker.values()):
                fail(f'fabric {arm}: K3 by worker {by_worker}')
            res.update(by_worker={str(k): v for k, v in by_worker.items()}, err_over_tol=worst,
                       k3=sum(w['k3'] for w in by_worker.values()),
                       worker_stages=[timer_stages(tmp / f'worker_{arm}{i}.log') for i in range(2)])
            codes = stop_processes(procs[arm][1:] if victim is not None else procs[arm], timeout=60)
            res['worker_exit_codes'] = codes
            if any(codes):
                fail(f'fabric {arm}: workers exited {codes} after the poison pill')
            arms[arm] = res
            log(f'[fabric {arm}] {card}: {json.dumps(res)}')
        if len(arms['pod']['by_worker']) != 2:
            fail(f'fabric: the pod run used {len(arms["pod"]["by_worker"])} workers, not 2')
        kill = arms['kill']
        if kill['requeued'] != 1 or kill['restart_s'] is None:
            fail(f'fabric kill: requeued {kill["requeued"]}, restarted {kill["restart_s"]} s '
                 f'after the kill')

        # 21a: the slurm script's worker, in a world of one, answers a task.
        captured.clear()
        executor = launcher.get_compute_config(slurm).get_executor(tmp / 'run_slurm')
        written = (tmp / 'run_slurm' / 'submit.sbatch').read_text()
        if written != scripts['slurm']:
            fail('fabric slurm: the written script differs from the rendered one')
        box = {}
        thread = threading.Thread(target=lambda: box.update(r=launcher.map_with_teardown(
            executor, this.world_task, [[1.0, 2.0, 3.0]])), daemon=True)
        t0 = time.perf_counter()
        thread.start()
        thread.join(FABRIC_WAIT_S)
        world_s = time.perf_counter() - t0
        if 'r' not in box:
            fail(f'fabric slurm: the world task did not finish\n{log_tail(tmp / "worker_slurm.log")}')
        world = box['r'][0]
        codes = stop_processes(procs['slurm'], timeout=60)
        if (world['rank'], world['size'], world['backend'], world['values']) != (
                0, 1, FABRIC_WORLD_BACKEND, [1.0, 2.0, 3.0]) or any(codes):
            fail(f'fabric slurm: {world}, exit codes {codes}')
        slurm_log = (tmp / 'worker_slurm.log').read_text()
        if f'torch.distributed rank 0/1 ({FABRIC_WORLD_BACKEND})' not in slurm_log:
            fail(f'fabric slurm: the worker did not join its world\n{log_tail(tmp / "worker_slurm.log")}')
        world.update(seconds=world_s, exit_codes=codes)
        out = dict(setup_s=setup_s, local_s=local_s, local_k3=local_k3, arms=arms, world=world,
                   files=len(files), texts=sum(len(t) for t, _ in local))
        log(f'[fabric] {card}: BERT-base bf16 over {len(files)} files ({out["texts"]} texts): '
            f'local {local_s:.2f} s; pbspro pod of 2 workers {arms["pod"]["wall_s"]:.2f} s = '
            f'{arms["pod"]["files_per_s"]:.2f} files/s, tasks by worker '
            f'{[w["tasks"] for w in arms["pod"]["by_worker"].values()]}, K3 by worker '
            f'{[w["k3"] for w in arms["pod"]["by_worker"].values()]}; kill arm: requeued '
            f'{kill["requeued"]} ({kill["victim_file"]}) {kill["requeue_s"]:.2f} s after the '
            f'SIGKILL (restarted after {kill["restart_s"]:.2f} s), {kill["wall_s"]:.2f} s; slurm world of one: rank {world["rank"]}/'
            f'{world["size"]} over {world["backend"]} on {world["device"]}, all-reduce '
            f'{world["values"]}')
        return out
    finally:
        stop_processes([p for ps in procs.values() for p in ps], timeout=10)


def app_yaml(path: Path, generator: dict) -> Path:
    path.write_text(json.dumps({'generator_config': generator}))
    return path


def start_replicas(tmp: Path, tag: str, generator: dict, n: int):
    """``n`` chat-server processes (``python -m distllm_tpu_torch.chat_server``)
    over one app YAML, each binding a free port itself;
    ``[(proc, None, log)]``, the base read later by :func:`listening`."""
    config = app_yaml(tmp / f'{tag}.yaml', generator)
    out = []
    for i in range(n):
        log_path = tmp / f'{tag}{i}.log'
        argv = ['python', '-m', 'distllm_tpu_torch.chat_server', '--config', str(config),
                '--host', '127.0.0.1', '--port', '0']
        if DEVICE != 'cuda':
            argv += ['--device', DEVICE]
        out.append((start_process(argv, log_path), None, log_path))
    return out


def listening(servers, what):
    """``servers`` as ``[(proc, base, log)]`` with each base read from the
    ``listening on <url>`` line its process logs once bound. A port chosen
    here and bound later by the child could be taken meanwhile (an outgoing
    connection's ephemeral port); a port the child binds itself cannot."""
    import re

    deadline = time.monotonic() + FABRIC_WAIT_S
    out = []
    for proc, base, log_path in servers:
        while base is None:
            found = re.search(r'\] listening on (http://\S+)', log_path.read_text())
            if found:
                base = found.group(1)
            elif proc.poll() is not None:
                fail(f'{what}: exited {proc.returncode} before it listened\n'
                     f'{log_tail(log_path)}')
            elif time.monotonic() > deadline:
                fail(f'{what}: not listening in {FABRIC_WAIT_S} s\n{log_tail(log_path)}')
            else:
                time.sleep(0.2)
        out.append((proc, base, log_path))
    return out


def wait_ready(servers, what):
    """Poll each ``(proc, base, log)``'s ``/health`` until 200."""
    deadline = time.monotonic() + FABRIC_WAIT_S
    for proc, base, log_path in servers:
        while True:
            if proc.poll() is not None:
                fail(f'{what}: {base} exited {proc.returncode}\n{log_tail(log_path)}')
            try:
                if http_call(base, '/health', method='GET')[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail(f'{what}: {base} not ready in {FABRIC_WAIT_S} s\n{log_tail(log_path)}')
            time.sleep(0.5)


def start_router(tmp: Path, tag: str, fleet, policy, health_interval_s):
    """``python -m distllm_tpu_torch.router`` over ``fleet`` from a YAML
    ``RouterConfig``, on a port it binds itself; ``(proc, base, log)`` once
    it listens, not waited for beyond that."""
    config = tmp / f'{tag}_router.yaml'
    config.write_text(json.dumps({'replicas': [b for _, b, _ in fleet], 'policy': policy,
                                  'loadinfo_ttl_s': 0.05, 'health_interval_s': health_interval_s,
                                  'request_timeout_s': 120.0}))
    log_path = tmp / f'{tag}_router.log'
    proc = start_process(['python', '-m', 'distllm_tpu_torch.router', '--config', str(config),
                          '--host', '127.0.0.1', '--port', '0'], log_path)
    try:
        return listening([(proc, None, log_path)], f'{tag} router')[0]
    except BaseException:
        stop_processes([proc], timeout=10)
        raise


def shutdown_reports(servers, what):
    """SIGINT each replica and read the ``[chat_server] shutdown`` report
    its ``main`` logs (its kernel counters and prefix-cache tokens)."""
    import signal as _signal

    codes = stop_processes([s[0] for s in servers], timeout=120, sig=_signal.SIGINT)
    reports = []
    for (_, base, log_path), code in zip(servers, codes):
        lines = [ln for ln in log_path.read_text().splitlines()
                 if ln.startswith('[chat_server] shutdown ')]
        if not lines:
            fail(f'{what}: {base} logged no shutdown report (exit {code})\n{log_tail(log_path)}')
        reports.append(json.loads(lines[-1].split(' ', 2)[2]))
    return reports


def router_decisions(base):
    text = http_call(base, '/metrics', method='GET')[2].decode()
    out = {}
    for line in text.splitlines():
        if line.startswith('distllm_router_requests_total{'):
            key, value = line.rsplit(' ', 1)
            if float(value):
                out[key.split('"')[1]] = int(float(value))
    return out


def warm_indices(workload):
    seen, warm = set(), []
    for i, arrival in enumerate(sorted(workload, key=lambda a: a.at_s)):
        if arrival.session is not None:
            if arrival.session in seen:
                warm.append(i)
            seen.add(arrival.session)
    return warm


def run_router_arm(card, policy, router, fleet, workload, warm):
    """One 21b arm: ``router`` over ``fleet`` under ``workload``, then the
    replicas' shutdown reports."""
    import signal as _signal

    from distllm_tpu_torch.generate.loadgen import run_http_loadgen

    wait_ready([router], f'{policy} router')
    # Wait until the router holds every replica in rotation: its first
    # probe may come before a replica answers /health.
    deadline = time.monotonic() + FABRIC_WAIT_S
    while set(get_json(router[1], '/health')[1]['replicas'].values()) != {'healthy'}:
        if time.monotonic() > deadline:
            fail(f'{policy} router: replicas not back in rotation')
        time.sleep(0.2)
    try:
        report = run_http_loadgen(router[1], workload, timeout_s=120.0)
        decisions = router_decisions(router[1])
    finally:
        stop_processes([router[0]], timeout=30, sig=_signal.SIGINT)
    reports = shutdown_reports(fleet, f'router {policy}')
    warm_ttft = [report.ttft_by_request[i] for i in warm
                 if report.statuses[i] == 200 and report.ttft_by_request[i] is not None]
    replicas = {}
    for (_, base, _), rep in zip(fleet, reports):
        eng = rep['engine']
        name = base.split('//')[1]
        replicas[name] = dict(
            requests=report.by_replica.get(name, 0), k1=rep['kernels'][REPLICA_K1],
            k1_plain=rep['kernels']['ragged_paged_attention_reference.launches'],
            prefix_hit_share=round(eng['prefix_hit_tokens'] / max(1, eng['prefix_lookup_tokens']), 4),
            forward_passes=eng['forward_passes'])
    arm = dict(ok=report.ok, errors=report.errors, decisions=decisions, warm=len(warm_ttft),
               warm_ttft_p50=percentile(warm_ttft, 50), warm_ttft_p95=percentile(warm_ttft, 95),
               ttft_p50=report.percentiles.get('ttft_p50'), replicas=replicas,
               elapsed_s=report.elapsed_s)
    log(f'[router {policy}] {card}: {json.dumps(arm)}')
    if report.ok != len(workload) or not warm_ttft:
        fail(f'router {policy}: {report.ok} of {len(workload)} answered')
    if any(r['k1'] <= 0 or r['k1_plain'] for r in replicas.values()):
        fail(f'router {policy}: K1 by replica {replicas}')
    if policy == 'prefix_affinity' and not decisions.get('affinity'):
        fail(f'router {policy}: no affinity decision ({decisions})')
    return arm


def run_failover(card, router, fleet):
    """21c: round-robin over three fp32 replicas; the same arrivals with no
    kill, then with replica 0 killed at a third of the schedule. Probes
    every 30 s (the router started once the replicas were up): the kill is
    found on the proxy path."""
    import signal as _signal

    from distllm_tpu_torch.generate.loadgen import LoadgenConfig, build_workload, run_http_loadgen
    from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer

    workload = build_workload(LoadgenConfig(**FAILOVER_LOAD))
    wait_ready([router], 'failover router')
    try:
        control = run_http_loadgen(router[1], workload, timeout_s=120.0)
        last_at = max(a.at_s for a in workload)
        killer = threading.Timer(max(0.5, 0.35 * last_at),
                                 lambda: fleet[0][0].send_signal(_signal.SIGKILL))
        killer.start()
        try:
            killed = run_http_loadgen(router[1], workload, timeout_s=120.0)
        finally:
            killer.cancel()
        decisions = router_decisions(router[1])
    finally:
        stop_processes([router[0]], timeout=30, sig=_signal.SIGINT)
    fleet[0][0].wait(timeout=30)
    survivors = shutdown_reports(fleet[1:], 'router failover')
    tok = WhitespaceTokenizer(vocab_size=32000)

    def ids(text):
        # A word decodes back to its id by its hash, an unseen id as <id>.
        return [int(w[1:-1]) if w.startswith('<') else tok.token_id(w) for w in text.split()]

    same = sum(a is not None and b is not None and ids(a) == ids(b)
               for a, b in zip(control.contents, killed.contents))
    out = dict(requests=len(workload), control_ok=control.ok, ok=killed.ok,
               statuses=sorted(set(str(s) for s in killed.statuses)), retried=killed.retried,
               identical=same, decisions=decisions, by_replica=killed.by_replica,
               k1_by_survivor=[r['kernels'][REPLICA_K1] for r in survivors])
    log(f'[router failover] {card}: {json.dumps(out)}')
    if control.ok != len(workload) or killed.ok != len(workload):
        fail(f'router failover: {killed.ok} of {len(workload)} answered (statuses '
             f'{out["statuses"]}; control {control.ok})')
    if killed.retried < 1 or same != len(workload):
        fail(f'router failover: {killed.retried} retried, {same} of {len(workload)} answers '
             f'identical to the run with no kill')
    if any(k <= 0 for k in out['k1_by_survivor']):
        fail(f'router failover: K1 by survivor {out["k1_by_survivor"]}')
    return out


def phase_router(torch, card, tmp: Path):
    """Phases 21b and 21c (see the module docstring). All seven replicas
    start at once (four 7B bf16 ones, about 14 GiB each, and 21c's three
    fp32 ones at depth 2, about 3 GiB each); each 21b arm has its own
    fresh pair, the other pair idle meanwhile."""
    import signal as _signal

    from distllm_tpu_torch.generate.loadgen import LoadgenConfig, build_workload

    workload = build_workload(LoadgenConfig(**ROUTER_LOAD))
    warm = warm_indices(workload)
    fleets, routers = {}, {}
    t0 = time.perf_counter()
    try:
        fleets['round_robin'] = start_replicas(tmp, 'rr', ROUTER_GENERATOR, 2)
        fleets['prefix_affinity'] = start_replicas(tmp, 'aff', ROUTER_GENERATOR, 2)
        fleets['failover'] = start_replicas(tmp, 'fo', dict(
            ROUTER_GENERATOR, model=dict(FAILOVER_MODEL), enable_prefix_cache=False), 3)
        # Each replica binds its own port: the routers start once all
        # seven have logged theirs, then probe every 0.5 s.
        fleets = {tag: listening(fleet, f'router replicas ({tag})')
                  for tag, fleet in fleets.items()}
        for policy in ('round_robin', 'prefix_affinity'):
            routers[policy] = start_router(tmp, policy, fleets[policy], policy, 0.5)
        wait_ready([s for fleet in fleets.values() for s in fleet], 'router replicas')
        start_s = time.perf_counter() - t0
        log(f'[router] {card}: 7 replicas up in {start_s:.1f} s; '
            f'{torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB of the card free')
        routers['failover'] = start_router(tmp, 'failover', fleets['failover'], 'round_robin',
                                           30.0)
        arms = {policy: run_router_arm(card, policy, routers[policy], fleets[policy], workload,
                                       warm)
                for policy in ('round_robin', 'prefix_affinity')}
        failover = run_failover(card, routers['failover'], fleets['failover'])
    finally:
        stop_processes([s[0] for fleet in fleets.values() for s in fleet]
                       + [r[0] for r in routers.values()], timeout=30, sig=_signal.SIGTERM)
    speedup = arms['round_robin']['warm_ttft_p50'] / arms['prefix_affinity']['warm_ttft_p50']
    out = dict(start_s=start_s, arms=arms, warm_ttft_speedup=speedup, failover=failover,
               wall_s=time.perf_counter() - t0)
    log(f'[router] {card}: replicas up in {start_s:.1f} s; warm TTFT p50 / p95 '
        f'round-robin {arms["round_robin"]["warm_ttft_p50"]:.4f} / '
        f'{arms["round_robin"]["warm_ttft_p95"]:.4f} s, prefix_affinity '
        f'{arms["prefix_affinity"]["warm_ttft_p50"]:.4f} / '
        f'{arms["prefix_affinity"]["warm_ttft_p95"]:.4f} s: affinity {speedup:.3f}x; failover '
        f'{failover["retried"]} retried, {failover["identical"]}/{failover["requests"]} identical')
    return out


def peer_arm(torch, tpa, tqm, tag, cfg, params, pool, prompt, junk, timed):
    """21d's three engines over ``params``: A serves ``prompt`` and spills
    it under ``junk``, B (cold, A its peer) adopts A's blocks, C has no
    peer. Greedy tokens of B and C, their K1 launches (and K2's, where
    ``pool`` quantizes the weights); with ``timed`` each of B's and C's
    request is timed to its first token."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.observability.flight import get_flight_recorder

    def engine(**extra):
        eng = LLMEngine(cfg, params, None, EngineConfig(**pool, **extra), device=DEVICE)
        eng.warmup()
        return eng

    greedy = SamplingParams(temperature=0.0, max_tokens=PEER_NEW)
    first = SamplingParams(temperature=0.0, max_tokens=1)
    engine_a = engine(peer_kv_serve_endpoint='tcp://127.0.0.1:0')
    engine_a.generate_ids([prompt], greedy)
    for j in junk:
        engine_a.generate_ids([j], greedy)
    spilled = engine_a.tier_summary()['spilled_blocks']
    engine_b = engine(peer_kv_endpoints=(engine_a.peer_kv_endpoint,))
    engine_c = engine()
    out = {}
    for name, eng in (('b', engine_b), ('c', engine_c)):
        recorder = get_flight_recorder()
        before = recorder.total_recorded
        zero_k1_counts(tpa)
        zero_k2_counts(tqm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = eng.generate_ids([prompt], first if timed else greedy)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        k1 = check_k1_kernel(tpa, f'{tag} engine {name}')
        k2 = (tqm.int8_matmul.launches, tqm.int8_matmul_reference.launches)
        if pool.get('quantization') and (k2[0] <= 0 or k2[1]):
            fail(f'{tag} engine {name}: K2 launches {k2[0]}, plain {k2[1]}')
        new = recorder.total_recorded - before
        fetches = [r for r in recorder.snapshot(limit=new) if r.get('kind') == 'peer_fetch'] \
            if new else []
        if timed:
            tokens = eng.generate_ids([prompt], greedy)  # the device holds the prefix now
        out[name] = dict(tokens=tokens[0], k1=k1, k2=k2[0], first_token_ms=first_ms,
                         tier=eng.tier_summary(), fetch_s=sum(r['fetch_s'] for r in fetches))
    out['a'] = dict(spilled_blocks=spilled, tier=engine_a.tier_summary())
    for eng in (engine_b, engine_c, engine_a):
        shut_down(torch, tag, eng)
    return out


def phase_peer(torch, tpa, tqm, card):
    """Phase 21d (see the module docstring)."""
    from distllm_tpu_torch.models import mistral
    from distllm_tpu_torch.models.mistral import MistralConfig

    rng = np.random.default_rng(21)
    results = {}
    for tag, cfg, pool, length in (
            ('peer fp32', MistralConfig(num_layers=2, dtype='float32'), PEER_POOL, PEER_PROMPT),
            ('peer int8', MistralConfig(num_layers=2, dtype='float32'),
             dict(PEER_POOL, quantization='int8'), PEER_PROMPT),
            ('peer bf16', MistralConfig(), PEER_BF16_POOL, PEER_BF16_PROMPT)):
        params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
        # The JAX arm's six junk prompts; two evict a 1024-token prompt.
        prompt, *junk = ([int(t) for t in rng.integers(4, cfg.vocab_size, size=length)]
                         for _ in range(1 + (6 if length == PEER_PROMPT else 2)))
        res = peer_arm(torch, tpa, tqm, tag, cfg, params, pool, prompt, junk,
                       timed=cfg.dtype != 'float32')
        b, c, a = res['b'], res['c'], res['a']
        mib = b['tier'].get('peer_fetched_bytes', 0) / 2**20
        summary = dict(
            spilled_blocks_a=a['spilled_blocks'],
            peer_fetched_blocks=b['tier'].get('peer_fetched_blocks', 0),
            peer_fetched_mib=mib, promoted_blocks_b=b['tier']['promoted_blocks'],
            peer_served_blocks_a=a['tier'].get('peer_served_blocks', 0),
            peer_served_bytes_a=a['tier'].get('peer_served_bytes', 0),
            identical=b['tokens'] == c['tokens'], k1_b=b['k1'], k1_c=c['k1'], k2_b=b['k2'],
            fetch_ms_per_mib=(b['fetch_s'] * 1e3 / mib) if mib else None,
            first_token_ms_b=b['first_token_ms'], first_token_ms_c=c['first_token_ms'])
        log(f'[{tag}] {card}: {json.dumps(summary)}')
        if summary['peer_fetched_blocks'] < 1 or summary['peer_served_blocks_a'] < 1:
            fail(f'{tag}: B fetched {summary["peer_fetched_blocks"]} blocks from A')
        if cfg.dtype == 'float32' and not summary['identical']:  # fp32 and int8 arms
            fail(f'{tag}: B (peer blocks) and C (no peer) decoded different tokens')
        results[tag.split()[1]] = summary
        del params
        torch.cuda.empty_cache()
    bf16 = results['bf16']
    log(f'[peer] {card}: bf16 at full depth, a {PEER_BF16_PROMPT}-token prompt: B adopted '
        f'{bf16["peer_fetched_blocks"]} blocks ({bf16["peer_fetched_mib"]:.1f} MiB, '
        f'{bf16["fetch_ms_per_mib"]:.3f} ms/MiB fetched), first token {bf16["first_token_ms_b"]:.1f}'
        f' ms against C\'s {bf16["first_token_ms_c"]:.1f} ms; A served '
        f'{bf16["peer_served_bytes_a"]} bytes; fp32 identical {results["fp32"]["identical"]}')
    return results


# ---------------------------------------------------------- phases 22-22c
# Phase 22: the host and disk KV tiers at tensor_parallel_size 2 (ROADMAP
# A10d), two ranks on the card over gloo as in phase 20. Rank 0's tiers
# hold whole blocks (every KV head); each rank gathers and promotes its own
# heads. A pool of 48 blocks of 16 under RAG-style traffic: three
# 400-token prefixes, each asked twice in turns with a 16-token question,
# so a prefix's second question finds blocks the others' admissions
# spilled and promotes them; 4 greedy tokens a request.
TIER_TP_POOL = dict(block_size=BLOCK_SIZE, num_blocks=48, max_num_seqs=4, max_model_len=1024,
                    decode_steps=4, enable_prefix_cache=True, host_kv_tier_bytes=1 << 30)
TIER_TP_PREFIX, TIER_TP_PREFIXES, TIER_TP_QUESTION, TIER_TP_NEW = 400, 3, 16, 4
TIER_TP_MODEL: dict = {'num_layers': 16}  # Mistral-7B widths, 16 of 32 layers, bf16
# The fp32 arms of 22 and 22a: Mistral-7B widths at depth 2, 8 greedy tokens.
TIER_TP_IDENTITY_MODEL = TP_IDENTITY_MODEL  # 20b's model: its tp2 engine is the tiers-off arm
TIER_TP_IDENTITY_NEW = 8
# 22a: both fp32 tiered engines also serve their host tier to peers and
# take peers added later (an empty list at construction).
TIER_TP_PEER = dict(peer_kv_serve_endpoint='tcp://127.0.0.1:0', peer_kv_endpoints=())
# 22b: phase 15's index at these data axes, the shards sharing the card.
INDEX_SHARDS = {'float32': (1, 2, 4), 'int8': (1, 2, 4), 'ubinary': (1, 2)}
# 22c: BERT-base at tensor_parallel_size 2 over the first 256 of phase
# 10's texts, batches of 64.
ENCODER_TP_TEXTS, ENCODER_TP_BATCH = 256, 64


def tier_tp_workload(vocab_size, seed=22):
    """Phase 22's prompts: three prefixes, each twice, in turns."""
    rng = np.random.default_rng(seed)
    prefixes = [[int(t) for t in rng.integers(4, vocab_size, size=TIER_TP_PREFIX)]
                for _ in range(TIER_TP_PREFIXES)]
    return [prefixes[i % TIER_TP_PREFIXES]
            + [int(t) for t in rng.integers(4, vocab_size, size=TIER_TP_QUESTION)]
            for i in range(2 * TIER_TP_PREFIXES)]


def serve_one_by_one(engine, prompts, sampling):
    """Each prompt served alone, in order: the evictions, spills and
    promotions are the same on every engine."""
    return [engine.generate_ids([p], sampling)[0] for p in prompts]


def rank_tier_rates(tier):
    """A rank's tier report with its spill and promotion-copy ms per MiB."""
    mib = 2**20
    out = dict(tier)
    out['spill_ms_per_mib'] = (tier.get('spill_s', 0.0) * 1e3 / (tier['spilled_bytes'] / mib)
                               if tier.get('spilled_bytes') else None)
    out['promote_copy_ms_per_mib'] = (
        tier.get('promote_copy_s', 0.0) * 1e3 / (tier['promoted_bytes'] / mib)
        if tier.get('promoted_bytes') else None)
    return out


def tier_rates(summary):
    """An engine's ``tier_summary`` with spill, promotion staging and copy
    ms per MiB."""
    mib = 2**20
    spilled, promoted = summary['spilled_bytes'] / mib, summary['promoted_bytes'] / mib
    return dict(
        summary,
        spill_ms_per_mib=summary['spill_s'] * 1e3 / spilled if spilled else None,
        promote_host_ms_per_mib=summary['promote_host_s'] * 1e3 / promoted if promoted else None,
        promote_copy_ms_per_mib=summary['promote_copy_s'] * 1e3 / promoted if promoted else None,
        host_gib=summary['host_bytes'] / 2**30,
    )


def check_tier_tp_reports(tag, reports):
    """Every rank ran each spill and promotion program; rank 0 alone holds
    the tier, and each rank moved its own heads (equal halves)."""
    tiers = [r['tier'] for r in reports]
    if (len({(t.get('spills', 0), t.get('promotions', 0)) for t in tiers}) != 1
            or not tiers[0].get('spills') or not tiers[0].get('promotions')
            or len({t.get('spilled_bytes') for t in tiers}) != 1
            or not tiers[0].get('host_blocks') or 'host_blocks' in tiers[1]):
        fail(f'{tag}: rank tier reports {tiers}')
    return [rank_tier_rates(t) for t in tiers]


def phase_tp_tiers(torch, tpa, card, tmp: Path):
    """22. Mistral-7B bf16 at full width (16 of its 32 layers), ``tensor_parallel_size``
    2 (two ranks on the card over gloo; random weights from seed 0, each
    rank drawing its slices), host and disk tiers on a 48-block pool,
    phase 22's RAG traffic; then the same traffic, pool and tiers on one
    rank for comparison. Per rank: spills and promotions, the bytes of its
    heads moved and their ms per MiB, the host tier's blocks and bytes
    (rank 0's: every head); K1 on both ranks at 16 query / 4 KV heads,
    layers x passes, the plain op never."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.generate.engine.sharded import ShardedEngine, WeightSource
    from distllm_tpu_torch.models import mistral

    tag = 'tp tiers'
    cfg = mistral.MistralConfig(**TIER_TP_MODEL)
    prompts = tier_tp_workload(cfg.vocab_size)
    sampling = SamplingParams(temperature=0.0, max_tokens=TIER_TP_NEW)
    params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    one = LLMEngine(cfg, params, None, EngineConfig(
        **TIER_TP_POOL, disk_kv_tier_dir=str(tmp / 'tp1_bf16')), device=DEVICE)
    one.warmup()
    t0 = time.perf_counter()
    one_out = serve_one_by_one(one, prompts, sampling)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_tier = tier_rates(one.tier_summary())
    shut_down(torch, f'{tag} one rank', one)
    del one, params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = ShardedEngine(2, cfg, WeightSource('init', seed=0), EngineConfig(
        **TIER_TP_POOL, disk_kv_tier_dir=str(tmp / 'tp2_bf16')), backend='gloo', devices=DEVICE)
    engine = sharded.engine
    engine.warmup()
    build_s = time.perf_counter() - t0
    stats0 = dict(engine.stats)
    # The main path: counts to 0 just before, read just after (rank 1's
    # from its marks).
    zero_k1_counts(tpa)
    engine.mark_kernels('tiers_before')
    with k1_shapes(torch) as shapes:
        t0 = time.perf_counter()
        outs = serve_one_by_one(engine, prompts, sampling)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    engine.mark_kernels('tiers_after')
    passes = stats_delta(engine, stats0)['forward_passes']
    k1 = tpa.ragged_paged_attention.launches
    k1_routes = dict(tpa.ragged_paged_attention.launches_by_route)
    plain = tpa.ragged_paged_attention_reference.launches
    summary = tier_rates(engine.tier_summary())
    payload = engine.kv_tier.get(next(iter(engine.kv_tier._entries)))
    payload_shapes = [list(a.shape) for a in payload]
    reports = sharded.close()
    check_tp_reports(tag, reports, engine)
    ranks = check_tier_tp_reports(tag, reports)
    rank1 = rank_launches(reports[1], 'tiers_before', 'tiers_after')
    agree = greedy_match(outs, one_out)
    want_shapes = [[cfg.num_layers, BLOCK_SIZE, cfg.num_kv_heads, cfg.head_size]] * 2
    log(f'[{tag}] {card}: Mistral-7B bf16 at tp2 over gloo on one card (built in '
        f'{build_s:.2f} s), {len(prompts)} requests of {TIER_TP_PREFIX + TIER_TP_QUESTION} '
        f'tokens x {TIER_TP_NEW} new in {wall_s:.3f} s (one rank: {one_s:.3f} s); rank 0 '
        f'tier {json.dumps(summary)}; per rank {json.dumps(ranks)}; one rank '
        f'{json.dumps(one_tier)}; payload shapes {payload_shapes}; K1 rank 0 {k1} by route '
        f'{json.dumps(k1_routes)} at (q, KV) heads {sorted(set(shapes))}, rank 1 '
        f'{json.dumps(rank1)}, plain {plain}; bf16 agreement with one rank {agree:.4f}')
    if not (summary['spills'] > 0 and summary['promotions'] > 0
            and summary['payload_mismatches'] == 0 and summary['promotion_failures'] == 0):
        fail(f'{tag}: {summary}')
    if payload_shapes != want_shapes or summary['host_bytes'] != one_tier['host_bytes']:
        fail(f'{tag}: payloads {payload_shapes} (want {want_shapes}), host bytes '
             f'{summary["host_bytes"]} against one rank\'s {one_tier["host_bytes"]}')
    shard_heads = (cfg.num_heads // 2, cfg.num_kv_heads // 2)
    if (k1 != cfg.num_layers * passes or plain or set(shapes) != {shard_heads}
            or rank1['ragged_paged_attention.launches'] != k1
            or rank1['ragged_paged_attention_reference.launches']):
        fail(f'{tag}: K1 {k1} for {cfg.num_layers} x {passes} passes, plain {plain}, shapes '
             f'{set(shapes)}, rank 1 {rank1}')
    del sharded, engine
    torch.cuda.empty_cache()
    return dict(build_s=build_s, wall_s=wall_s, one_rank_s=one_s, forward_passes=passes,
                launches=k1, launches_by_route=k1_routes,
                rank1_launches=rank1['ragged_paged_attention.launches'],
                local_heads=list(shard_heads), tier=summary, ranks=ranks, one_rank=one_tier,
                payload_shapes=payload_shapes, agreement=agree)


def tiered_engine(torch, cfg, params, pool, sharded=False, **extra):
    """A fp32 engine of phase 22's arms over ``pool``: one rank on
    ``params``, or tp2 (``sharded``) on the same seed's weights drawn by
    each rank."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine
    from distllm_tpu_torch.generate.engine.sharded import ShardedEngine, WeightSource

    config = EngineConfig(**pool, **extra)
    if sharded:
        out = ShardedEngine(2, cfg, WeightSource('init', seed=3), config, backend='gloo',
                            devices=DEVICE)
        out.engine.warmup()
        return out
    engine = LLMEngine(cfg, params, None, config, device=DEVICE)
    engine.warmup()
    return engine


def phase_tp_tiers_identity(torch, tpa, card, tmp: Path, tp2_off=None):
    """22 (fp32 arms) and 22a. fp32 at Mistral-7B widths, depth 2, phase
    22's traffic: tp2 with host and disk tiers == one rank with the same
    tiers == tp2 with the tiers off (``tp2_off``) == one rank cold (no
    prefix cache);
    a fresh one-rank engine on the tp2 engine's disk directory promotes
    from it (0 mismatches) and gives the cold tokens; an int8 KV pool at
    tp2 with tiers == one rank with them (K1's int8 mode on both ranks,
    scale rows spilled and promoted by head). 22a: a one-rank engine
    adopts the tp2 engine's spilled blocks through its peer server, and
    the tp2 engine adopts the one-rank engine's: first tokens equal a
    cold run's. ``tp2_off``: the tiers-off tp2 tokens phase 20b's engine
    served (same weights and traffic); without them a tp2 engine with the
    prefix cache on and no tiers serves them here."""
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.models import mistral

    tag = 'tp tiers fp32'
    cfg = mistral.MistralConfig(**TIER_TP_IDENTITY_MODEL)
    params = mistral.init(cfg, torch.Generator(device=DEVICE).manual_seed(3), device=DEVICE)
    prompts = tier_tp_workload(cfg.vocab_size, seed=23)
    sampling = SamplingParams(temperature=0.0, max_tokens=TIER_TP_IDENTITY_NEW)
    cold_pool = {k: v for k, v in TIER_TP_POOL.items() if k != 'host_kv_tier_bytes'}
    cold_pool['enable_prefix_cache'] = False
    off_pool = {k: v for k, v in TIER_TP_POOL.items() if k != 'host_kv_tier_bytes'}
    outs, engines = {}, {}
    cold = tiered_engine(torch, cfg, params, cold_pool)
    outs['tp1_cold'] = serve_one_by_one(cold, prompts, sampling)
    engines['tp1'] = tiered_engine(torch, cfg, params, TIER_TP_POOL,
                                   disk_kv_tier_dir=str(tmp / 'fp32_tp1'), **TIER_TP_PEER)
    outs['tp1_tiers'] = serve_one_by_one(engines['tp1'], prompts, sampling)
    if tp2_off is None:
        off = tiered_engine(torch, cfg, None, off_pool, sharded=True)
        tp2_off = serve_one_by_one(off.engine, prompts, sampling)
        check_tp_reports(f'{tag} tp2 off', off.close(), off.engine)
        del off
    outs['tp2_off'] = tp2_off
    tp2 = tiered_engine(torch, cfg, None, TIER_TP_POOL, sharded=True,
                        disk_kv_tier_dir=str(tmp / 'fp32_tp2'), **TIER_TP_PEER)
    engines['tp2'] = tp2.engine
    zero_k1_counts(tpa)
    tp2.engine.mark_kernels('before')
    outs['tp2_tiers'] = serve_one_by_one(tp2.engine, prompts, sampling)
    tp2.engine.mark_kernels('after')
    tp2_tier = tier_rates(tp2.engine.tier_summary())
    k1 = (tpa.ragged_paged_attention.launches,
          tpa.ragged_paged_attention.launches_by_route['cuda_cores'],
          tpa.ragged_paged_attention_reference.launches)
    # A fresh engine, a fresh host tier, the tp2 engine's disk directory.
    fresh = tiered_engine(torch, cfg, params, TIER_TP_POOL,
                          disk_kv_tier_dir=str(tmp / 'fp32_tp2'))
    outs['tp1_from_tp2_disk'] = serve_one_by_one(fresh, prompts, sampling)
    fresh_tier = fresh.tier_summary()
    shut_down(torch, f'{tag} fresh', fresh)
    same = all(o == outs['tp1_cold'] for o in outs.values())
    log(f'[{tag}] {card}: fp32 depth 2, {len(prompts)} requests: '
        + ', '.join(outs) + f' identical: {same}; tp2 tier {json.dumps(tp2_tier)}; K1 rank 0 '
        f'(kernel, CUDA cores, plain) {k1}; the tp2-written directory into one rank: '
        f'{fresh_tier["promotions"]} promotions of {fresh_tier["promoted_blocks"]} blocks, '
        f'{fresh_tier["payload_mismatches"]} mismatches, disk reads '
        f'{fresh.kv_tier.disk.reads if fresh.kv_tier else None}')
    if not same:
        fail(f'{tag}: tokens differ: {outs}')
    if not (tp2_tier['promotions'] > 0 and tp2_tier['payload_mismatches'] == 0
            and fresh_tier['promoted_blocks'] > 0 and fresh_tier['payload_mismatches'] == 0):
        fail(f'{tag}: tp2 tier {tp2_tier}; the fresh engine {fresh_tier}')
    if k1[0] <= 0 or k1[1] != k1[0] or k1[2]:
        fail(f'{tag}: K1 (kernel, CUDA cores, plain) {k1}')
    result = dict(identical=same, tp2_tier=tp2_tier, k1_launches=k1[0],
                  from_tp2_disk=dict(promotions=fresh_tier['promotions'],
                                     promoted_blocks=fresh_tier['promoted_blocks'],
                                     payload_mismatches=fresh_tier['payload_mismatches']))
    del fresh
    # 22a: peer adoption both ways, against the cold engine's tokens.
    t0 = time.perf_counter()
    rng = np.random.default_rng(24)
    prompt_x, prompt_y, *junk = ([int(t) for t in rng.integers(4, cfg.vocab_size, size=n)]
                                 for n in (300, 300, TIER_TP_PREFIX, TIER_TP_PREFIX))
    peer = {}
    for name, (server, client, prompt) in {
            'tp1_adopts_tp2': (engines['tp2'], engines['tp1'], prompt_x),
            'tp2_adopts_tp1': (engines['tp1'], engines['tp2'], prompt_y)}.items():
        serve_one_by_one(server, [prompt] + junk, sampling)  # spills the prompt
        client.kv_tier.peer.add_endpoint(server.peer_kv_endpoint)
        before = client.tier_summary().get('peer_fetched_blocks', 0)
        got = client.generate_ids([prompt], sampling)[0]
        want = cold.generate_ids([prompt], sampling)[0]
        fetched = client.tier_summary().get('peer_fetched_blocks', 0) - before
        peer[name] = dict(identical=got == want, peer_fetched_blocks=fetched,
                          served_blocks=server.tier_summary().get('peer_served_blocks', 0))
        log(f'[tp tiers peer] {card}: {name}: {json.dumps(peer[name])}')
        if fetched <= 0 or got != want:
            fail(f'tp tiers peer {name}: fetched {fetched} blocks, tokens {got} vs cold {want}')
    peer_s = time.perf_counter() - t0
    reports = tp2.close()
    check_tp_reports(f'{tag} tp2', reports, tp2.engine)
    result['ranks'] = check_tier_tp_reports(f'{tag} tp2', reports)
    rank1 = rank_launches(reports[1], 'before', 'after')
    if rank1['ragged_paged_attention.launches'] != k1[0]:
        fail(f'{tag}: rank 1 K1 {rank1}, rank 0 {k1[0]}')
    shut_down(torch, f'{tag} tp1', engines['tp1'])
    shut_down(torch, f'{tag} cold', cold)
    del tp2, engines, cold
    # The int8 KV pool: scale rows sliced by KV head.
    t1 = time.perf_counter()
    int8_outs = {}
    one = tiered_engine(torch, cfg, params, TIER_TP_POOL, kv_cache_dtype='int8')
    int8_outs['tp1'] = serve_one_by_one(one, prompts, sampling)
    shut_down(torch, f'{tag} int8 tp1', one)
    del one
    sharded = tiered_engine(torch, cfg, None, TIER_TP_POOL, sharded=True, kv_cache_dtype='int8')
    zero_k1_counts(tpa)
    sharded.engine.mark_kernels('before')
    int8_outs['tp2'] = serve_one_by_one(sharded.engine, prompts, sampling)
    sharded.engine.mark_kernels('after')
    int8_tier = tier_rates(sharded.engine.tier_summary())
    by_kv = dict(tpa.ragged_paged_attention.launches_by_kv)
    reports = sharded.close()
    check_tp_reports(f'{tag} int8', reports, sharded.engine)
    int8_ranks = check_tier_tp_reports(f'{tag} int8', reports)
    marks = reports[1]['kernel_marks']
    rank1_int8 = (marks['after']['ragged_paged_attention.launches_by_kv']['int8']
                  - marks['before']['ragged_paged_attention.launches_by_kv']['int8'])
    int8_same = int8_outs['tp1'] == int8_outs['tp2']
    log(f'[{tag} int8] {card}: int8 KV pool, tp2 == one rank: {int8_same}; K1 by KV mode '
        f'{json.dumps(by_kv)}, rank 1 int8 {rank1_int8}; tier {json.dumps(int8_tier)}; per '
        f'rank {json.dumps(int8_ranks)}')
    if (not int8_same or by_kv['int8'] <= 0 or by_kv['model'] or rank1_int8 != by_kv['int8']
            or int8_tier['promotions'] <= 0 or int8_tier['payload_mismatches']):
        fail(f'{tag} int8: identical {int8_same}, K1 by KV {by_kv}, rank 1 {rank1_int8}, '
             f'tier {int8_tier}')
    del sharded, params
    torch.cuda.empty_cache()
    result.update(peer=peer, peer_s=peer_s, int8=dict(identical=int8_same, tier=int8_tier,
                  ranks=int8_ranks, launches=by_kv['int8'], rank1_launches=rank1_int8),
                  int8_s=time.perf_counter() - t1)
    return result


def sharded_device_fn(torch, topk, index, q_dev, precision, n):
    """The sharded index's device top-k on ``q_dev``, as its search runs it."""
    over = INDEX_TOP_K * INDEX_RESCORE
    if precision == 'float32':
        return lambda: topk.topk_inner_product(q_dev, index._corpus, INDEX_TOP_K)
    if precision == 'int8':
        codes, scales = (index._int8, None) if index.num_shards > 1 else index._int8
        return lambda: topk.int8_topk(q_dev, codes, scales, over, n_valid=n)
    bits = torch.from_numpy(topk.pack_sign_bits(q_dev.cpu().numpy())).to(q_dev.device)
    return lambda: topk.hamming_topk(bits, index._packed, over, n_valid=n)


def phase_index_sharded(torch, tea, card, table, tmp: Path):
    """22b. Phase 15's 2**19 x 768 index at ``mesh: {'data': n}``, the
    shards sharing the one card (a placement test, not a multi-card
    speed): for each tier and n, 64 queries through the BERT-base
    retriever (K3 launches layers x batches, as in 15); results equal
    ``data`` 1's, indices and scores bitwise; device ms of the top-k and
    its bound beside ``data`` 1's. ``ubinary`` ignores the mesh."""
    from distllm_tpu_torch.embed import get_pooler
    from distllm_tpu_torch.models import bert
    from distllm_tpu_torch.ops import topk
    from distllm_tpu_torch.rag.search import Retriever, TpuIndexV2Config

    cfg = RETRIEVER_BERT() if RETRIEVER_BERT else bert.BertConfig()
    encoder = retriever_encoder(torch, cfg, seed=0)
    pooler = get_pooler({'name': 'mean'})
    queries = rag_queries(RAG_QUERIES, seed=16)
    batches = -(-RAG_QUERIES // RETRIEVER_BATCH)
    n = len(table)
    out = {}
    for precision, counts in INDEX_SHARDS.items():
        runs = {}
        for data in counts:
            tag = f'index {precision} data {data}'
            t0 = time.perf_counter()
            index = TpuIndexV2Config(
                dataset_dir=tmp, precision=precision, rescore_multiplier=INDEX_RESCORE,
                mesh={'data': data} if data > 1 else None,
            ).get_index(dataset=table, device=DEVICE)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            retriever = Retriever(index, encoder, pooler, batch_size=RETRIEVER_BATCH)
            retriever.search(queries[:RETRIEVER_BATCH], top_k=INDEX_TOP_K)  # warm-up
            zero_k3_counts(tea)
            results, emb = retriever.search(queries, top_k=INDEX_TOP_K, score_threshold=-2.0)
            k3 = check_k3(tea, tag, cfg.num_layers, batches)
            device_ms = cuda_ms(torch, sharded_device_fn(
                torch, topk, index, torch.from_numpy(emb).to(DEVICE), precision, n), iters=5)
            bytes_ms = index.device_bytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = 2 * RAG_QUERIES * INDEX_DIM * n / (
                PEAK_FLOPS['float32'] if precision == 'float32' else PEAK_INT8_OPS) * 1e3
            runs[data] = dict(
                shards=index.num_shards, devices=sorted({str(d) for d in index.shard_devices}),
                device_bytes=index.device_bytes, build_s=build_s, device_ms=device_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by='bytes' if bytes_ms >= ops_ms else 'operations', k3=k3,
                indices=results.total_indices, scores=results.total_scores)
            del index, retriever
            torch.cuda.empty_cache()
        base = runs[1]
        summary = {}
        for data, run in runs.items():
            same_idx = run['indices'] == base['indices']
            same_scores = run['scores'] == base['scores']  # bitwise: equal Python floats
            summary[data] = {key: run[key] for key in (
                'shards', 'devices', 'device_bytes', 'build_s', 'device_ms', 'bound_ms',
                'bound_by', 'k3')}
            summary[data].update(indices_equal=same_idx, scores_bitwise=same_scores)
            log(f'[index sharded] {card}: {precision} data {data}: {run["shards"]} shard(s) on '
                f'{run["devices"]}, device top-k {run["device_ms"]:.4f} ms (bound '
                f'{run["bound_ms"]:.4f} {run["bound_by"]}; data 1 {base["device_ms"]:.4f}; '
                f'one card: not a multi-card speed), indices equal to data 1: {same_idx}, '
                f'scores bitwise: {same_scores}')
            if not (same_idx and same_scores):
                fail(f'index sharded {precision} data {data}: results differ from data 1')
        out[precision] = summary
    del encoder
    torch.cuda.empty_cache()
    return out


def corpus_texts(n: int) -> list[str]:
    """The first ``n`` texts of phase 10's corpus (:func:`write_corpus`)."""
    rng = np.random.default_rng(0)
    vocab = [f'tok{i}' for i in range(5000)]
    return [' '.join(rng.choice(vocab, size=int(rng.integers(120, 260)))) for _ in range(n)]


def sharded_bert_embeddings(torch, mesh, dtype: str, texts):
    """Phase 22c on one rank: BERT-base (seed 1) in ``dtype`` on the rank's
    device, sharded onto ``mesh`` (``mesh=None``: one device), the texts'
    mean-pooled embeddings in batches of ``ENCODER_TP_BATCH``; with the
    heads of every attention call and the calls expected (layers x
    batches)."""
    from distllm_tpu_torch.embed import get_pooler
    from distllm_tpu_torch.embed.embedders.full_sequence import compute_embeddings
    from distllm_tpu_torch.embed.encoders.base import TorchEncoder
    from distllm_tpu_torch.models import bert, common
    from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer

    device = DEVICE if mesh is None else mesh.device
    cfg = bert.BertConfig(dtype=dtype)
    params = bert.init(cfg, torch.Generator(device=device).manual_seed(1), device=device)
    encoder = TorchEncoder(
        None, bert.apply, cfg, params,
        WhitespaceTokenizer(vocab_size=cfg.vocab_size, model_max_length=512),
        cfg.hidden_size, device=device)
    if mesh is not None:
        encoder.shard(mesh, bert.param_specs(cfg))
    heads = []
    attend = common.encoder_attend

    def recording(q, k, v, mask, num_heads, *args, **kwargs):
        heads.append(num_heads)
        return attend(q, k, v, mask, num_heads, *args, **kwargs)

    common.encoder_attend = recording
    stats = {}
    try:
        emb = compute_embeddings(texts, encoder, get_pooler({'name': 'mean'}),
                                 ENCODER_TP_BATCH, stats=stats, device=device)
    finally:
        common.encoder_attend = attend
    encoder.shutdown()
    return emb, sorted(set(heads)), cfg.num_layers * sum(stats['bucket_batches'].values())


def encoder_rank(conn, world, devices, backend, texts):
    """Phase 22c's spawned rank: its mesh, then each ``('embed', dtype)``
    rank 0 sends (the same sharded embedding, its collectives meeting rank
    0's) until ``stop``; returns its K3 launches and heads by dtype."""
    import torch

    from distllm_tpu_torch.ops import encoder_attention as tea
    from distllm_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(data=1, model=world), devices=devices, backend=backend)
    counts = {}
    while True:
        op, args = conn.recv()
        if op == 'stop':
            return counts
        (dtype,) = args
        zero_k3_counts(tea)
        _, heads, calls = sharded_bert_embeddings(torch, mesh, dtype, texts)
        counts[dtype] = dict(launches=tea.encoder_attention.launches, calls=calls,
                             launches_by_route=dict(tea.encoder_attention.launches_by_route),
                             plain=tea.encoder_attention_reference.launches, heads=heads)


def phase_encoder_tp(torch, tea, card):
    """22c. BERT-base at full width and depth, ``TorchEncoder.shard`` over
    a ``model=2`` mesh of two ranks on the card (gloo), on the first 256
    of phase 10's texts, against one device: fp32 embeddings within
    ``EMBED_RTOL * |ref| + EMBED_ATOL`` elementwise (the row-parallel sums
    only reorder fp32 additions); bf16 by the rule that tp2's distance
    from the fp32 embeddings is at most twice one device's bf16 distance
    plus one bf16 step of their scale (row-parallel products round each
    partial before the sum). K3 on each rank at 6 of 12 heads, layers x
    batches, the plain version never."""
    from distllm_tpu_torch.parallel import mesh as tmesh
    from distllm_tpu_torch.parallel import multihost

    texts = corpus_texts(ENCODER_TP_TEXTS)
    devices = tmesh.rank_devices(2, DEVICE)
    group = multihost.RankGroup(2, this_module().encoder_rank, (2, devices, 'gloo', texts),
                                backend='gloo', timeout_s=300)
    result = {}
    try:
        mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, model=2), devices=devices, backend='gloo')
        for dtype in ('float32', 'bfloat16'):
            t0 = time.perf_counter()
            one, one_heads, _ = sharded_bert_embeddings(torch, None, dtype, texts)
            one_s = time.perf_counter() - t0
            group.send(('embed', (dtype,)))
            zero_k3_counts(tea)
            t0 = time.perf_counter()
            got, heads, calls = sharded_bert_embeddings(torch, mesh, dtype, texts)
            torch.cuda.synchronize()
            tp_s = time.perf_counter() - t0
            result[dtype] = dict(
                embeddings=got, one=one, one_heads=one_heads, heads=heads, calls=calls,
                one_s=one_s,
                tp_s=tp_s, launches=tea.encoder_attention.launches,
                launches_by_route=dict(tea.encoder_attention.launches_by_route),
                plain=tea.encoder_attention_reference.launches)
    finally:
        rank1 = group.close()[0]
    fp32, bf16 = result['float32'], result['bfloat16']
    diff = np.abs(fp32['embeddings'] - fp32['one'])
    err_over_tol = float((diff / (EMBED_RTOL * np.abs(fp32['one']) + EMBED_ATOL)).max())
    tp_err = float(np.abs(bf16['embeddings'] - fp32['one']).max())
    one_err = float(np.abs(bf16['one'] - fp32['one']).max())
    bf16_bound = 2 * one_err + 2.0**-8 * float(np.abs(fp32['one']).max())
    out = dict(fp32_max_abs_err=float(diff.max()), fp32_err_over_tol=err_over_tol,
               bf16_err=tp_err, bf16_one_device_err=one_err, bf16_bound=bf16_bound,
               texts=len(texts), batch=ENCODER_TP_BATCH)
    for dtype, r in result.items():
        out[dtype] = {key: r[key] for key in (
            'heads', 'one_heads', 'calls', 'one_s', 'tp_s', 'launches', 'launches_by_route',
            'plain')}
        out[dtype]['rank1'] = rank1[dtype]
    log(f'[encoder tp] {card}: BERT-base on {len(texts)} texts, tp2 over gloo on one card '
        f'vs one device: fp32 max abs err {diff.max():.3e} ({err_over_tol:.4f} x rtol '
        f'{EMBED_RTOL} / atol {EMBED_ATOL}); bf16 err from fp32 {tp_err:.4e} against one '
        f'device\'s {one_err:.4e} (bound {bf16_bound:.4e}); {json.dumps(out)}')
    if not err_over_tol <= 1.0 or not tp_err <= bf16_bound:
        fail(f'encoder tp: fp32 {err_over_tol:.4f} x tolerance; bf16 {tp_err} > {bf16_bound}')
    for dtype, r in out.items():
        if dtype not in ('float32', 'bfloat16'):
            continue
        route = 'tensor_cores' if dtype == 'bfloat16' else 'cuda_cores'
        if (r['heads'] != [BERT_HEADS // 2] or r['one_heads'] != [BERT_HEADS] or r['plain']
                or r['launches'] != r['calls'] or r['launches'] <= 0
                or r['launches_by_route'][route] != r['launches']
                or r['rank1']['launches'] != r['launches'] or r['rank1']['plain']
                or r['rank1']['heads'] != [BERT_HEADS // 2]):
            fail(f'encoder tp {dtype}: {r}')
    return out


def wgmma_entries(k1_cases, k3_cases, serve, gemma2, load, protein):
    """The kernels line's entries for the wgmma routes."""
    keys = ('ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')

    def ab(results):
        return {c['case']: {route: r['ms'] for route, r in c['routes'].items()}
                for c in results if 'routes' in c}

    def entry(name, source, replaces, head, mine, launches, by_phase, results):
        return dict(
            name=name, route='cuda', source=source, replaces=replaces, launches=launches,
            launches_by_phase=by_phase,
            max_abs_err=max(c['max_abs_err'] for c in mine),
            err_over_tol=max([c['err_over_tol'] for c in mine]
                             + [c['routes']['wgmma']['err_over_tol']
                                for c in results if 'routes' in c]),
            **{key: head[key] for key in keys},
            route1_ms=head['routes']['tensor_cores']['ms'], timed_case=head['case'],
            kernel_route=head['kernel_route'], ab=ab(results))

    k1_head = next(c for c in k1_cases if c['case'] == HD256_PREFILL)
    k3_head = next(c for c in k3_cases if c['case'] == K3_MODEL_CASES[0][0])
    return [
        entry('ragged_paged_attention_wgmma',
              'distllm_tpu_torch/csrc/ragged_paged_attention.cu (+ csrc/hopper_attention.cuh)',
              'distllm_tpu/ops/paged_attention.py:683', k1_head,
              [c for c in k1_cases if c['kernel_route'] == 'wgmma'],
              serve['launches_by_route']['wgmma'],
              {'serve': serve['launches_by_route'], 'gemma2': gemma2['launches_by_route'],
               'load': load['k1']}, k1_cases),
        entry('encoder_attention_wgmma',
              'distllm_tpu_torch/csrc/encoder_attention.cu (+ csrc/hopper_attention.cuh)',
              'distllm_tpu/ops/encoder_attention.py:151', k3_head,
              [c for c in k3_cases if c['kernel_route'] == 'wgmma'],
              sum(r['launches_by_route']['wgmma'] for r in protein.values()),
              {name: r['launches_by_route'] for name, r in protein.items()}, k3_cases),
    ]


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke run needs a GPU')
    from distllm_tpu_torch.ops import _build
    from distllm_tpu_torch.ops import encoder_attention as tea
    from distllm_tpu_torch.ops import paged_attention as tpa
    from distllm_tpu_torch.ops import quantization as tq
    from distllm_tpu_torch.ops import quantized_matmul as tqm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f'[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; '
        f'nvidia-smi: {smi}')

    # 2. build: one nvcc per source, all started together
    t_mark = [time.perf_counter()]

    def took(label):
        """Log the seconds since the last mark (the phases that print none)."""
        now = time.perf_counter()
        log(f'[time] {label} took {now - t_mark[0]:.1f} s')
        t_mark[0] = now

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f'[build] {len(libs)} kernel(s) built in {time.perf_counter() - t0:.1f} s')
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if 'registers' in line or 'Compiling entry' in line or 'spill' in line:
                log(f'[build] {name}: {line.strip()}')

    # 3. K1, 3b. K1's int8-KV mode, 4. K3 and 5. K2 against their plain
    # versions
    took('start-up and build')
    cases = phase_kernel(torch, tpa)
    int8_cases = phase_kernel_int8(torch, tpa)
    mixed_cases = phase_kernel_mixed(torch, tpa)
    # 3d. K1 at head dim 256 (Gemma-2-9B's geometry)
    t0 = time.perf_counter()
    hd256_cases = phase_kernel_256(torch, tpa)
    log(f'[kernel hd256] phase 3d took {time.perf_counter() - t0:.1f} s')
    k3_cases = phase_encoder_kernel(torch, tea)
    k2_cases = phase_int8_kernel(torch, tq, tqm)
    took('phases 3-5 (the kernels against their plain versions)')
    from distllm_tpu_torch.models import mistral
    from distllm_tpu_torch.models.mistral import MistralConfig

    # 6. serve: Mistral-7B widths, 32 layers, bf16
    serve = phase_serve(torch, tpa, smi, MistralConfig())
    took('phase 6')
    # 7. serve int8: the same, weights int8-quantized on the card
    serve_q = phase_serve(torch, tpa, smi, MistralConfig(), tqm=tqm, quantization='int8')
    took('phase 7')
    # 6b-6g share one set of 7B-width bf16 weights made on the card (seed
    # 0) at SHARED_LAYERS of the 32 layers (depth cut to keep the run's time).
    cfg6 = MistralConfig(num_layers=SHARED_LAYERS)
    params6 = mistral.init(cfg6, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    # 6b. serve with an int8 KV pool: bf16 and int8 KV arms, same weights
    serve_kv, kvq_tokens = phase_serve_kv_int8(torch, tpa, smi, cfg6, params6)
    # 6c. one full-width decode window: captured graph vs eager decode_loop
    graph_window = phase_graph_window(torch, tpa, smi, cfg6, params6)
    # 6d. the prefix cache: gen_kvq and RAG workloads, cache off / on x 2
    prefix = phase_serve_prefix_cache(torch, tpa, smi, cfg6, params6, kvq_tokens)
    # 6e. the host and disk tiers over a small pool, and a warm restart
    with tempfile.TemporaryDirectory(prefix='chip_smoke_tiers_') as tmp:
        tiers = phase_kv_tiers(torch, tpa, smi, cfg6, params6, Path(tmp))
    took('phases 6b-6e')
    # 6f. mixed prefill+decode windows: gen_mixed's workload, off / on
    t0 = time.perf_counter()
    mixed = phase_serve_mixed(torch, tpa, smi, cfg6, params6)
    log(f'[mixed] phase 6f took {time.perf_counter() - t0:.1f} s')
    # 6g. speculation: gen_spec's workload, five arms, then int8 weights
    t0 = time.perf_counter()
    spec = phase_serve_spec(torch, tpa, tqm, smi, cfg6, params6)
    log(f'[spec] phase 6g took {time.perf_counter() - t0:.1f} s')
    del params6
    torch.cuda.empty_cache()
    # 16-16c share the 7B weights at full depth (seed 0).
    cfg7b = MistralConfig()
    params7b = mistral.init(cfg7b, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    # 16. open-loop load; 16b. chaos, overload and deadline on its engine;
    # 16c. the chat server under HTTP load; 16d. their fp32 identities
    t0 = time.perf_counter()
    load_engine, load_prefills, load = phase_load(torch, tpa, smi, cfg7b, params7b)
    log(f'[load] phase 16 took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    chaos = phase_chaos(torch, tpa, smi, cfg7b, load_engine, load_prefills)
    shut_down(torch, 'load', load_engine)
    del load_engine
    log(f'[chaos] phase 16b took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    load_http = phase_load_http(torch, tpa, smi, cfg7b, params7b)
    log(f'[http] phase 16c took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    load_identity = phase_load_identity(torch, tpa, MistralConfig(num_layers=2, dtype='float32'))
    log(f'[load identity] phase 16d took {time.perf_counter() - t0:.1f} s')
    del params7b
    torch.cuda.empty_cache()
    t_mark[0] = time.perf_counter()
    # 8. identity: full width, depth 2, fp32, K1 and then K2 vs plain;
    # 8b. K1's int8-KV mode vs plain; 8c. the prefix cache with its tiers
    # on K1 vs the cache off, and K1's mixed mode (a bf16 pool) vs plain
    phase_identity(torch, tpa, MistralConfig(num_layers=2, dtype='float32'))
    phase_identity_int8(torch, tqm, MistralConfig(num_layers=2, dtype='float32'))
    phase_identity_kv_int8(torch, tpa, MistralConfig(num_layers=2, dtype='float32'))
    identity_mixed = phase_identity_prefix_mixed(
        torch, tpa, MistralConfig(num_layers=2, dtype='float32'))
    # 8d. speculation on / off, on K1 / plain, mixed on / off
    t0 = time.perf_counter()
    identity_spec = phase_identity_spec_mixed(
        torch, tpa, MistralConfig(num_layers=2, dtype='float32'))
    log(f'[identity spec mixed] phase 8d took {time.perf_counter() - t0:.1f} s')
    # 9. quantize on the card: one full-width leaf, bitwise vs the CPU;
    # 9b. int8 KV codes and scales written on the card vs the CPU
    phase_quantize(torch, tq)
    phase_kv_codes(torch, tpa)
    took('phases 8-9')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_embed_') as tmp:
        # 10. embed: BERT-base widths, 12 layers, bf16
        embed = phase_embed(torch, tea, smi, Path(tmp))
        # 11. embed int8: the same, dense kernels int8-quantized on the card
        embed_q = phase_embed(torch, tea, smi, Path(tmp), tqm=tqm, quantization='int8')
        embed_q.pop('corpus')
        # 12. embed identity: full width, depth 2, fp32
        phase_embed_identity(torch, tea, embed.pop('corpus'))
    took('phases 10-12')
    # 13. serve Gemma-2-9B (full width and depth, bf16) from a chat YAML
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_gemma2_') as tmp:
        gemma2 = phase_serve_gemma2(torch, tpa, smi, Path(tmp))
    log(f'[serve gemma2] phase 13 took {time.perf_counter() - t0:.1f} s')
    # 13b. Gemma-2 identity: fp32 depth 2, K1 vs plain, spec / mixed
    t0 = time.perf_counter()
    identity_gemma2 = phase_identity_gemma2(torch, tpa)
    log(f'[identity gemma2] phase 13b took {time.perf_counter() - t0:.1f} s')
    # 14-14b. protein embedding (ESM-2 650M, ESM-C 600M), 14c. ModernBERT-
    # base, 14d. the three models' fp32 identities
    t_mark[0] = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_protein_') as tmp:
        protein, seqs = phase_protein_embed(torch, tea, smi, Path(tmp))
        took('phases 14 and 14b')
        t0 = time.perf_counter()
        protein['modernbert_base'], corpus_texts = phase_modernbert_embed(
            torch, tea, smi, Path(tmp))
        log(f'[modernbert] phase 14c took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    identity_protein = phase_protein_identity(torch, tea, seqs, corpus_texts)
    log(f'[identity protein] phase 14d took {time.perf_counter() - t0:.1f} s')
    # 15. the retrieval index (three tiers, 2**19 rows, BERT-base queries);
    # 15b. the RAG chat server, 15c. the eval suite and 15d. the generation
    # job over one warm 7B generator; 15e. their fp32 identities
    with tempfile.TemporaryDirectory(prefix='chip_smoke_rag_') as tmp:
        t0 = time.perf_counter()
        index_tiers, table, retriever = phase_index(torch, tea, smi, Path(tmp) / 'corpus')
        log(f'[index] phase 15 took {time.perf_counter() - t0:.1f} s')
        # 22b. the data-sharded index over phase 15's corpus and index
        # files (run here, where they exist), its shards sharing the card
        t0 = time.perf_counter()
        index_sharded = phase_index_sharded(torch, tea, smi, table, Path(tmp) / 'corpus')
        log(f'[index sharded] phase 22b took {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        rag_chat = phase_rag_chat(torch, tpa, tea, smi, retriever)
        log(f'[rag chat] phase 15b took {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        rag_eval = phase_rag_eval(torch, tpa, tea, smi, retriever, Path(tmp))
        log(f'[rag eval] phase 15c took {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        job = phase_generation_job(torch, tpa, smi, Path(tmp))
        log(f'[generation job] phase 15d took {time.perf_counter() - t0:.1f} s')
        # 18. the MCQA harness over the same warm generator, its RAG arm
        # over a corpus embedded here; 18d. its fp32 identities
        t0 = time.perf_counter()
        mcqa = phase_mcqa(torch, tpa, tea, smi, Path(tmp))
        log(f'[mcqa] phase 18 took {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        mcqa_identity = phase_mcqa_identity(torch, tpa, tea, smi, mcqa.pop('_setup'))
        log(f'[mcqa identity] phase 18d took {time.perf_counter() - t0:.1f} s')
    del retriever
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rag_identity = phase_rag_identity(torch, tpa, tea, table)
    log(f'[rag identity] phase 15e took {time.perf_counter() - t0:.1f} s')
    del table
    # 17. the pipelined generate_ids (7B weights made again, seed 0); 17b.
    # its fp32 identities; 17c. serving from a checkpoint path; 17d. the
    # debug surface over 17c's generator.
    t17 = time.perf_counter()
    cfg_pipe = MistralConfig(num_layers=PIPE_LAYERS)
    params7b = mistral.init(cfg_pipe, torch.Generator(device=DEVICE).manual_seed(0),
                            device=DEVICE)
    t0 = time.perf_counter()
    pipeline = phase_pipeline(torch, tpa, smi, cfg_pipe, params7b)
    log(f'[pipeline] phase 17 took {time.perf_counter() - t0:.1f} s')
    del params7b
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipeline_identity = phase_pipeline_identity(
        torch, tpa, MistralConfig(num_layers=2, dtype='float32'))
    log(f'[pipeline identity] phase 17b took {time.perf_counter() - t0:.1f} s')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_checkpoint_') as tmp:
        t0 = time.perf_counter()
        checkpoint, ckpt_generator = phase_checkpoint_serve(torch, tpa, tqm, smi, Path(tmp))
        log(f'[checkpoint] phase 17c took {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        debug_surface = phase_debug_surface(torch, tpa, smi, ckpt_generator, Path(tmp))
        log(f'[debug surface] phase 17d took {time.perf_counter() - t0:.1f} s')
        # 18b. run_mcqa booting the port's chat server on 17c's checkpoint;
        # 18c. the CLI's generate, embed and merge
        t0 = time.perf_counter()
        mcqa_boot = phase_mcqa_boot(torch, tpa, smi, Path(tmp), Path(tmp) / 'mistral-7b-2l')
        log(f'[mcqa boot] phase 18b took {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        cli_run = phase_cli(torch, tpa, tea, smi, Path(tmp), Path(tmp) / 'mistral-7b-2l')
        log(f'[cli] phase 18c took {time.perf_counter() - t0:.1f} s')
    log(f'[pipeline] phases 17-17d took {time.perf_counter() - t17:.1f} s')
    del ckpt_generator
    torch.cuda.empty_cache()
    # 19a. the 4-D quantizer on a full-width expert bank; 19. Mixtral-8x7B
    # int8 at full width through get_generator and HTTP; 19b. its fp32
    # identities at depth 2; 19c. speculation and mixed windows at depth 2;
    # 19d. a one-layer Mixtral checkpoint served from a chat YAML.
    t19 = time.perf_counter()
    t0 = time.perf_counter()
    quantize_bank = phase_quantize_bank(torch, tq)
    log(f'[quantize bank] phase 19a took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    mixtral_serve = phase_serve_mixtral(torch, tpa, tqm, smi)
    log(f'[serve mixtral] phase 19 took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    mixtral_identity = phase_identity_mixtral(torch, tpa, tqm)
    log(f'[identity mixtral] phase 19b took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    mixtral_spec = phase_spec_mixed_mixtral(torch, tpa, tqm, smi)
    log(f'[spec mixed mixtral] phase 19c took {time.perf_counter() - t0:.1f} s')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_mixtral_') as tmp:
        t0 = time.perf_counter()
        mixtral_ckpt = phase_checkpoint_mixtral(torch, tpa, tqm, smi, Path(tmp))
        log(f'[checkpoint mixtral] phase 19d took {time.perf_counter() - t0:.1f} s')
    log(f'[mixtral] phases 19-19d took {time.perf_counter() - t19:.1f} s')
    # 20. Mistral-7B at tensor_parallel_size 2 through get_generator, two
    # ranks on the card over gloo (20d: one HTTP request on it); 20a.
    # Mixtral-8x7B int8 at tp2, 8 layers; 20b. fp32 identities tp2 vs tp1
    # and vs the plain ops; 20c. an NCCL group of one: captured windows with
    # their collectives, bitwise tokens.
    t20 = time.perf_counter()
    t0 = time.perf_counter()
    tp_serve = phase_tp_serve(torch, tpa, smi)
    log(f'[tp serve] phases 20 and 20d took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    tp_mixtral = phase_tp_mixtral(torch, tpa, tqm, smi)
    log(f'[tp mixtral] phase 20a took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    tp_identity = phase_tp_identity(torch, tpa, tqm)
    log(f'[tp identity] phase 20b took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    tp_nccl = phase_tp_nccl(torch, tpa, smi)
    log(f'[tp nccl] phase 20c took {time.perf_counter() - t0:.1f} s')
    log(f'[tp] phases 20-20d took {time.perf_counter() - t20:.1f} s')
    # 21. distributed_embedding over a pbspro pod of two fabric workers on
    # the card, and its kill arm; 21a. a slurm worker in a world of one;
    # 21b. the router over two Mistral-7B chat-server processes, round-robin
    # and prefix_affinity; 21c. failover identity over three fp32 replicas;
    # 21d. a replica adopting a peer's spilled KV blocks.
    t21 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_fabric_') as tmp:
        t0 = time.perf_counter()
        fabric = phase_fabric(torch, tea, smi, Path(tmp))
        log(f'[fabric] phases 21 and 21a took {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        router = phase_router(torch, smi, Path(tmp))
        log(f'[router] phases 21b and 21c took {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    peer = phase_peer(torch, tpa, tqm, smi)
    log(f'[peer] phase 21d took {time.perf_counter() - t0:.1f} s')
    log(f'[control plane] phases 21-21d took {time.perf_counter() - t21:.1f} s')
    # 22. the host and disk KV tiers at tensor_parallel_size 2 (Mistral-7B
    # bf16, two ranks on the card over gloo), its fp32 identities and int8
    # KV arm; 22a. peer adoption between tp1 and tp2 engines; 22c.
    # BERT-base on a model=2 mesh (22b ran inside phase 15's run).
    t22 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_tp_tiers_') as tmp:
        t0 = time.perf_counter()
        tp_tiers = phase_tp_tiers(torch, tpa, smi, Path(tmp))
        log(f'[tp tiers] phase 22 (bf16) took {time.perf_counter() - t0:.1f} s')
        t0 = time.perf_counter()
        tp_tiers_identity = phase_tp_tiers_identity(
            torch, tpa, smi, Path(tmp), tp2_off=tp_identity.pop('tier_traffic_tokens'))
        log(f'[tp tiers fp32] phases 22 (fp32, int8 KV) and 22a took '
            f'{time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    encoder_tp = phase_encoder_tp(torch, tea, smi)
    log(f'[encoder tp] phase 22c took {time.perf_counter() - t0:.1f} s')
    log(f'[mesh axes] phases 22, 22a and 22c took {time.perf_counter() - t22:.1f} s')

    # Headlines: K1 at the serving phase's decode shape, the main path's
    # most frequent launch (its prefill pair beside it); K3 at the embed
    # path's longest bucket. Every case is listed under 'cases'.
    head = next(c for c in cases if c['case'].startswith('serve_decode'))
    prefill_head = next(c for c in cases if c['case'] == 'serve_prefill_2x1024')
    k3_head = next(c for c in k3_cases if c['case'] == 'embed_512x288')
    int8_head, int8_decode8, int8_prefill = (
        next(c for c in int8_cases if c['case'] == name)
        for name in (INT8_SERVE_DECODE, 'int8_serve_decode_8x18-1090', INT8_SERVE_PREFILL)
    )
    int8_keys = ('case', 'kernel_route', 'tol', 'ms', 'timer', 'event_ms', 'host_us',
                 'plain_ms', 'bound_ms', 'bound_by', 'yardstick_ms', 'err_over_tol',
                 'max_abs_err')
    mixed_head = next(c for c in mixed_cases if c['case'] == MIXED_HEAD)
    verify_tc, verify_split = (
        next(c for c in cases if c['case'] == name) for name in (VERIFY_CASE, VERIFY_SPLIT_CASE)
    )
    verify_keys = ('case', 'kernel_route', 'tol', 'ms', 'timer', 'event_ms', 'host_us',
                   'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'err_over_tol',
                   'max_abs_err')
    k2_verify = next(c for c in k2_cases if c['case'] == K2_VERIFY)
    hd256_head, hd256_prefill = (
        next(c for c in hd256_cases if c['case'] == name) for name in (HD256_DECODE, HD256_PREFILL)
    )
    k2_head, k2_prefill, k2_embed = (
        next(c for c in k2_cases if c['case'] == name)
        for name in (K2_HEADLINE, K2_PREFILL, K2_EMBED)
    )
    k2_keys = ('case', 'kernel_route', 'tol', 'ms', 'timer', 'event_ms', 'host_us',
               'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'yardstick_ms',
               'err_over_tol', 'err_over_cuda_cores_tol', 'split_k')
    kernels = [{
        'name': 'ragged_paged_attention',
        'route': 'cuda',
        'source': 'distllm_tpu_torch/csrc/ragged_paged_attention.cu',
        'replaces': 'distllm_tpu/ops/paged_attention.py:683',
        'launches': serve['launches'],
        'launches_by_route': serve['launches_by_route'],
        'max_abs_err': max(c['max_abs_err'] for c in cases),
        'err_over_tol': max(c['err_over_tol'] for c in cases),
        'tol': head['tol'],
        'ms': head['ms'],
        'plain_ms': head['plain_ms'],
        'bound_ms': head['bound_ms'],
        'bound_by': head['bound_by'],
        'library_ms': head['library_ms'],
        # ms and library_ms are CUDA-graph replays; event_ms times eager
        # calls, host_us the host's time per call.
        'timer': head['timer'],
        'event_ms': head['event_ms'],
        'host_us': head['host_us'],
        'timed_case': head['case'],
        'kernel_route': head['kernel_route'],
        'prefill': {key: prefill_head[key] for key in (
            'case', 'kernel_route', 'tol', 'ms', 'timer', 'event_ms', 'plain_ms',
            'bound_ms', 'bound_by', 'library_ms', 'err_over_tol')},
        # The verify window (phase 6g, draft_k = 4): launches from its
        # greedy oracle arm; times at its [32, 5] spans (tensor cores) and at
        # spans of 3 (split-KV). The library call is SDPA on the gathered KV
        # with the causal span mask.
        'verify': {
            'launches': spec['oracle']['k1_launches'],
            'launches_by_route': spec['oracle']['k1_launches_by_route'],
            'verify_passes': spec['oracle']['spec_windows'],
            'tensor_cores': {key: verify_tc[key] for key in verify_keys},
            'split_kv': {key: verify_split[key] for key in verify_keys},
        },
        'cases': cases,
        # The int8-KV mode: launches from phase 6b's int8 arm, times at its
        # decode shape (prefill beside it). No PyTorch call computes
        # attention over int8 codes and scales; the yardstick is SDPA on
        # the pool dequantized to bf16, which reads twice the KV bytes.
        'int8_kv': {
            'launches': serve_kv['int8']['launches'],
            'launches_by_route': serve_kv['int8']['launches_by_route'],
            'launches_by_kv': serve_kv['int8']['launches_by_kv'],
            'max_abs_err': max(c['max_abs_err'] for c in int8_cases),
            'err_over_tol': max(c['err_over_tol'] for c in int8_cases),
            'tol': int8_head['tol'],
            'ms': int8_head['ms'],
            'plain_ms': int8_head['plain_ms'],
            'bound_ms': int8_head['bound_ms'],
            'bound_by': int8_head['bound_by'],
            'library_ms': None,
            'yardstick_ms': int8_head['yardstick_ms'],
            'yardstick': 'scaled_dot_product_attention on the KV dequantized to bf16',
            'timer': int8_head['timer'],
            'event_ms': int8_head['event_ms'],
            'host_us': int8_head['host_us'],
            'timed_case': int8_head['case'],
            'kernel_route': int8_head['kernel_route'],
            'decode_8': {key: int8_decode8[key] for key in int8_keys},
            'prefill': {key: int8_prefill[key] for key in int8_keys},
            'cases': int8_cases,
        },
        # The mixed full-precision mode: launches from phase 8c's fp32
        # model over a bf16 pool, times at phase 6's decode shape in that
        # pairing. No PyTorch call attends over a pool of another dtype;
        # the yardstick is SDPA on the pool cast to q's dtype.
        'mixed_kv': {
            'launches': identity_mixed['launches'],
            'launches_by_route': identity_mixed['launches_by_route'],
            'launches_by_kv': identity_mixed['launches_by_kv'],
            'max_abs_err': max(c['max_abs_err'] for c in mixed_cases),
            'err_over_tol': max(c['err_over_tol'] for c in mixed_cases),
            'tol': mixed_head['tol'],
            'ms': mixed_head['ms'],
            'plain_ms': mixed_head['plain_ms'],
            'bound_ms': mixed_head['bound_ms'],
            'bound_by': mixed_head['bound_by'],
            'library_ms': None,
            'yardstick_ms': mixed_head['yardstick_ms'],
            'yardstick': "scaled_dot_product_attention on the pool cast to q's dtype",
            'timer': mixed_head['timer'],
            'event_ms': mixed_head['event_ms'],
            'host_us': mixed_head['host_us'],
            'timed_case': mixed_head['case'],
            'kernel_route': mixed_head['kernel_route'],
            'cases': mixed_cases,
        },
        # Head dim 256 (Gemma-2-9B's geometry): launches from phase 13's
        # serve, times at its decode shape (its prefill beside it); SDPA on
        # the gathered KV is the library call where no softcap is on.
        'head_dim_256': {
            'launches': gemma2['launches'],
            'launches_by_route': gemma2['launches_by_route'],
            'launches_by_head_dim': gemma2['launches_by_head_dim'],
            'max_abs_err': max(c['max_abs_err'] for c in hd256_cases),
            'err_over_tol': max(c['err_over_tol'] for c in hd256_cases),
            'tol': hd256_head['tol'],
            'ms': hd256_head['ms'],
            'plain_ms': hd256_head['plain_ms'],
            'bound_ms': hd256_head['bound_ms'],
            'bound_by': hd256_head['bound_by'],
            'library_ms': hd256_head['library_ms'],
            'timer': hd256_head['timer'],
            'event_ms': hd256_head['event_ms'],
            'host_us': hd256_head['host_us'],
            'timed_case': hd256_head['case'],
            'kernel_route': hd256_head['kernel_route'],
            'prefill': {key: hd256_prefill[key] for key in (
                *verify_keys, 'masked_sdpa_ms', 'library_max_abs_err')},
            'cases': hd256_cases,
        },
        # Phases 15b-15d: the RAG chat server, the eval suite and the
        # generation job over one Mistral-7B bf16 engine.
        'rag': {'chat': rag_chat['k1'], 'eval': rag_eval['k1'], 'generation_job': job['k1']},
        # Phase 17: the pipelined generate_ids at depths 1, 2 and 2 with
        # defer_prefill; phase 17c: the checkpoint-served generators.
        'pipeline': {name: dict(launches=arm['k1_launches'],
                                launches_by_route=arm['k1_launches_by_route'])
                     for name, arm in pipeline['arms'].items()},
        'checkpoint': {arm: checkpoint[arm]['k1_launches'] for arm in ('bf16', 'int8')},
        # Phases 18-18d: the MCQA answers over HTTP (7B widths, 16 layers), the
        # direct generator 18b's booted server is held to (the server's own
        # launches run in its process), fp32 depth 2; and the CLI's generate.
        'mcqa': {'rag': mcqa['k1'], 'booted_direct': mcqa_boot['k1_direct'],
                 'fp32_identity': mcqa_identity['k1']},
        'cli': {'generate': cli_run['k1']},
        # Phase 19: Mixtral-8x7B int8 through get_generator (the main path's
        # launches, then its HTTP requests'); 19c: the verify graph's
        # launches at depth 2; 19b: the fp32 identities' kernel arms.
        'mixtral': {
            'launches': mixtral_serve['launches'],
            'launches_by_route': mixtral_serve['launches_by_route'],
            'http_launches': mixtral_serve['http_k1_launches'],
            'verify': {key: mixtral_spec['verify'][key] for key in ('passes', 'k1_launches')},
            'fp32_identity': {arm: mixtral_identity[f'{arm}_auto']['k1_launches']
                              for arm in ('float', 'int8')},
            'checkpoint': mixtral_ckpt['k1_launches'],
        },
        # Phases 20-20c: tensor_parallel_size 2 (two ranks on the card over
        # gloo), each rank at 16 query / 4 KV heads: rank 0's main-path
        # launches and rank 1's (from its report), 20d's HTTP request,
        # Mixtral at tp2, the fp32 identity's kernel arm, and the NCCL
        # group of one's replayed decode and verify windows.
        'tensor_parallel': {
            'launches': tp_serve['launches'],
            'launches_by_route': tp_serve['launches_by_route'],
            'rank1_launches': tp_serve['rank1_launches'],
            'local_heads': tp_serve['local_heads'],
            'http_launches': tp_serve['http_launches'],
            'mixtral': tp_mixtral['launches'],
            'mixtral_rank1': tp_mixtral['rank1_launches'],
            'fp32_identity': tp_identity['tp2_kernels']['k1_launches'],
            'nccl_one_rank': {arm: tp_nccl[arm]['launches'] for arm in ('decode', 'verify')},
            # Phase 3's cases at these shard shapes, held to the plain op.
            'shard_cases': {c['case']: {key: c[key] for key in verify_keys}
                            for c in cases if c['case'] in TP_K1_CASES},
        },
        # Phases 21b-21d: each chat-server replica's launches (its process's
        # counters, from its shutdown report) under round-robin and
        # prefix_affinity, 21c's survivors, and 21d's engine B over the
        # blocks it adopted from its peer (fp32 CUDA cores; bf16).
        'control_plane': {
            'router': {policy: {name: r['k1'] for name, r in arm['replicas'].items()}
                       for policy, arm in router['arms'].items()},
            'failover_survivors': router['failover']['k1_by_survivor'],
            'peer_adopting': {arm: peer[arm]['k1_b']['launches'] for arm in peer},
        },
        # Phase 22: the KV tiers at tensor_parallel_size 2 (rank 0's
        # launches and rank 1's at 16 query / 4 KV heads); its fp32 arm (CUDA
        # cores) and int8 KV arm (K1's int8 mode, rank 0 and rank 1).
        'mesh_axes': {
            'tiers_tp2': {key: tp_tiers[key] for key in (
                'launches', 'launches_by_route', 'rank1_launches', 'local_heads')},
            'tiers_fp32': tp_tiers_identity['k1_launches'],
            'tiers_int8_kv': {key: tp_tiers_identity['int8'][key]
                              for key in ('launches', 'rank1_launches')},
        },
        # Phases 16-16c: the open-loop load (attribution on and off), the
        # chaos run's clean and faulted arms, the overload arm, and the chat
        # server under HTTP load.
        'load': {
            'open_loop': load['k1'], 'attribution_off': load['attribution_off']['k1'],
            'attribution_on_again': load['attribution_on_again']['k1'],
            'chaos_clean': chaos['k1']['clean'], 'chaos': chaos['k1']['chaos'],
            'overload': chaos['k1']['overload'], 'http': load_http['k1'],
        },
    }, {
        'name': 'encoder_attention',
        'route': 'cuda',
        'source': 'distllm_tpu_torch/csrc/encoder_attention.cu',
        'replaces': 'distllm_tpu/ops/encoder_attention.py:151',
        'launches': embed['launches'],
        'launches_by_route': embed['launches_by_route'],
        'max_abs_err': max(c['max_abs_err'] for c in k3_cases),
        'err_over_tol': max(c['err_over_tol'] for c in k3_cases),
        'tol': k3_head['tol'],
        'ms': k3_head['ms'],
        'plain_ms': k3_head['plain_ms'],
        'bound_ms': k3_head['bound_ms'],
        'bound_by': k3_head['bound_by'],
        'library_ms': k3_head['library_ms'],
        'timed_case': k3_head['case'],
        # Phases 14-14c: launches on each model's main path, times at its
        # phase-4 shape, and phase 14d's fp32 identity.
        'models': {
            name: dict(
                {key: protein[name][key] for key in (
                    'launches', 'launches_by_route', 'bias_launches', 'batches')},
                identity=identity_protein[name],
                **{key: case[key] for key in (
                    'case', 'kernel_route', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                    'library_ms', 'max_abs_err', 'err_over_tol')},
            )
            for name, case in zip(
                ('esm2_650m', 'esmc_600m', 'modernbert_base'),
                (next(c for c in k3_cases if c['case'] == spec[0]) for spec in K3_MODEL_CASES),
            )
        },
        'cases': k3_cases,
        # Phases 15-15c: the retriever's BERT-base query encoder.
        'retriever': dict({f'index_{p}': r['k3'] for p, r in index_tiers.items()},
                          chat=rag_chat['k3'], eval=rag_eval['k3']),
        # Phase 18: the corpus embedded by run_embedding and the MCQA
        # queries; 18c: the CLI's embed.
        'mcqa': {'corpus_embed': mcqa['corpus']['k3'], 'rag_queries': mcqa['k3']},
        'cli': {'embed': cli_run['k3']},
        # Phase 22b: the retriever's query encoder over the data-sharded
        # index, by tier and shard count; 22c: BERT-base at tp2 (rank 0's
        # launches and rank 1's at 6 of 12 heads, fp32 on the CUDA cores,
        # bf16 on the tensor cores), then phase 4's case at that shard shape.
        'mesh_axes': {
            'index_sharded': {p: {str(d): r['k3']['launches'] for d, r in runs.items()}
                              for p, runs in index_sharded.items()},
            'encoder_tp2': {dtype: dict(launches=encoder_tp[dtype]['launches'],
                                        launches_by_route=encoder_tp[dtype]['launches_by_route'],
                                        rank1_launches=encoder_tp[dtype]['rank1']['launches'],
                                        heads=encoder_tp[dtype]['heads'])
                            for dtype in ('float32', 'bfloat16')},
            'shard_cases': {c['case']: {key: c[key] for key in (
                'kernel_route', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                'max_abs_err', 'err_over_tol')} for c in k3_cases if c['case'] in TP_K3_CASES},
        },
        # Phase 21: run_embedding in this process, then over the pbspro
        # pod's two worker processes (each task's count, summed by worker)
        # and its kill arm.
        'control_plane': {
            'local': fabric['local_k3']['launches'],
            'pod_by_worker': {pid: w['k3'] for pid, w in fabric['arms']['pod']['by_worker'].items()},
            'kill_arm_by_worker': {pid: w['k3']
                                   for pid, w in fabric['arms']['kill']['by_worker'].items()},
        },
    }, {
        'name': 'int8_matmul',
        'route': 'cuda',
        'source': 'distllm_tpu_torch/csrc/int8_matmul.cu',
        'replaces': 'distllm_tpu/ops/quantized_matmul.py:119',
        'launches': serve_q['k2_launches'],
        'launches_by_route': serve_q['k2_launches_by_route'],
        'embed_launches': embed_q['k2_launches'],
        'embed_launches_by_route': embed_q['k2_launches_by_route'],
        'max_abs_err': max(c['max_abs_err'] for c in k2_cases),
        'err_over_tol': max(c['err_over_tol'] for c in k2_cases),
        'tol': k2_head['tol'],
        'ms': k2_head['ms'],
        # K2's ms and yardstick_ms are CUDA-graph replays (no host enqueue
        # time); event_ms times eager calls as K1's and K3's ms are timed.
        'timer': k2_head['timer'],
        'event_ms': k2_head['event_ms'],
        'host_us': k2_head['host_us'],
        'plain_ms': k2_head['plain_ms'],
        'bound_ms': k2_head['bound_ms'],
        'bound_by': k2_head['bound_by'],
        # No one PyTorch call computes W8A16 (x @ int8 codes, scale on the
        # fp32 sum); the yardstick is torch.matmul on the weight
        # dequantized to bf16, which reads twice the weight bytes.
        'library_ms': None,
        'yardstick_ms': k2_head['yardstick_ms'],
        'yardstick': 'torch.matmul(x, bf16 dequantized weight)',
        'timed_case': k2_head['case'],
        'kernel_route': k2_head['kernel_route'],
        'prefill': {key: k2_prefill[key] for key in k2_keys},
        'embed': {key: k2_embed[key] for key in k2_keys},
        # A verify pass's rows (32 x 5) at the MLP's widest product; the
        # launches are phase 6g's int8-weight arm's.
        'verify': dict({key: k2_verify[key] for key in k2_keys},
                       launches=spec['oracle_int8']['k2_launches'],
                       launches_by_route=spec['oracle_int8']['k2_launches_by_route']),
        # Phase 17c: the generator served from a checkpoint path, int8.
        'checkpoint': dict(launches=checkpoint['int8']['k2_launches'],
                           launches_by_route=checkpoint['int8']['k2_launches_by_route']),
        # Phase 19: Mixtral-8x7B int8 (q / k / v / o of every layer; the
        # expert banks are dequantized, never sent to K2), then its HTTP
        # requests; 19c's verify graph; 19b's fp32 int8 arm; 19d's checkpoint.
        'mixtral': {
            'launches': mixtral_serve['k2_launches'],
            'launches_by_route': mixtral_serve['k2_launches_by_route'],
            'http_launches': mixtral_serve['http_k2_launches'],
            'verify_launches': mixtral_spec['verify']['k2_launches'],
            'fp32_identity': mixtral_identity['int8_auto']['k2_launches'],
            'checkpoint': mixtral_ckpt['k2_launches'],
        },
        # Phase 21d: the peer-adopting engine B of the int8 arm (fp32 depth 2).
        'control_plane': {'peer_adopting_int8': peer['int8']['k2_b']},
        # Phase 20a: Mixtral-8x7B int8 at tensor_parallel_size 2 (q / k / v
        # column-parallel, o row-parallel with its whole scales), rank 0's
        # launches and rank 1's.
        'tensor_parallel': {
            'launches': tp_mixtral['k2_launches'],
            'launches_by_route': tp_mixtral['k2_launches_by_route'],
            'rank1_launches': tp_mixtral['rank1_k2_launches'],
            # 20b's int8 arm (fp32, depth 2), then phase 5's cases at the
            # shard shapes, held to the plain op.
            'fp32_identity': tp_identity['tp2_int8']['k2_launches'],
            'shard_cases': {c['case']: {key: c[key] for key in k2_keys}
                            for c in k2_cases if c['case'] in TP_K2_CASES},
        },
        'cases': k2_cases,
    }]
    log(f'[summary] {smi}: {serve["tokens_per_s"]:.1f} tok/s bf16, '
        f'{serve_q["tokens_per_s"]:.1f} tok/s int8 ({serve["gib"]:.2f} vs '
        f'{serve_q["gib"]:.2f} GiB allocated); gen_kvq workload '
        f'{serve_kv["bf16"]["tokens_per_s"]:.1f} tok/s bf16 KV, '
        f'{serve_kv["int8"]["tokens_per_s"]:.1f} int8 KV (pool '
        f'{serve_kv["pool_bytes_ratio"]:.4f} of bf16, greedy match '
        f'{serve_kv["greedy_match"]:.4f}); {embed["embeddings_per_s"]:.1f} '
        f'embeddings/s bf16, {embed_q["embeddings_per_s"]:.1f} int8; RAG prefix hit share '
        f'{prefix["on_bf16"]["rag"]["hit_share"]:.4f}, prefill event ms '
        f'{prefix["off_bf16"]["rag"]["prefill_event_ms_sum"]:.1f} off / '
        f'{prefix["on_bf16"]["rag"]["prefill_event_ms_sum"]:.1f} on; '
        f'{time.perf_counter() - t_start:.1f} s total')
    log(f'[serve kv] {json.dumps(serve_kv)}')
    log(f'[graph window] {json.dumps(graph_window)}')
    log(f'[prefix cache] {json.dumps(prefix)}')
    log(f'[kv tiers] {json.dumps(tiers)}')
    log(f'[identity mixed] {json.dumps(identity_mixed)}')
    log(f'[mixed] {json.dumps(mixed)}')
    log(f'[spec] {json.dumps(spec)}')
    log(f'[identity spec mixed] {json.dumps(identity_spec)}')
    log(f'[serve gemma2] {json.dumps(gemma2)}')
    log(f'[identity gemma2] {json.dumps(identity_gemma2)}')
    log(f'[summary] {smi}: Gemma-2-9B bf16 (42 layers) {gemma2["tokens_per_s"]:.1f} tok/s, '
        f'{gemma2["wall_s"]:.3f} s for 16 prompts of 256..4600 tokens x 64 new; K1 at head '
        f'dim 256 {hd256_head["ms"]:.4f} ms at {hd256_head["case"]} (bound '
        f'{hd256_head["bound_ms"]:.4f}, plain {hd256_head["plain_ms"]:.4f}, SDPA '
        f'{hd256_head["library_ms"]})')
    log(f'[summary] {smi}: mixed off / on {mixed["off"]["tokens_per_s"]:.1f} / '
        f'{mixed["on"]["tokens_per_s"]:.1f} tok/s; spec decode / none / oracle / '
        f'oracle sampled / oracle int8 {spec["decode"]["tokens_per_s"]:.1f} / '
        f'{spec["none"]["tokens_per_s"]:.1f} / {spec["oracle"]["tokens_per_s"]:.1f} / '
        f'{spec["oracle_sampled"]["tokens_per_s"]:.1f} / '
        f'{spec["oracle_int8"]["tokens_per_s"]:.1f} tok/s, oracle accept rate '
        f'{spec["oracle"]["accept_rate"]}, prompt lookup drafts '
        f'{spec["prompt_lookup"]["spec_draft_tokens"]}, verify window '
        f'{spec["oracle"]["verify_window_wall_ms"]} ms wall / '
        f'{spec["oracle"]["verify_replay_event_ms"]} ms replay event; '
        f'{time.perf_counter() - t_start:.1f} s total')
    log(f'[protein] {json.dumps(protein)}')
    log(f'[identity protein] {json.dumps(identity_protein)}')
    log(f'[summary] {smi}: ' + '; '.join(
        f'{name}' + (f' at {r["layers"]}/{r["full_layers"]} layers' if 'layers' in r else '')
        + f' {r["sequences_per_s"]:.1f} sequences/s ({r["real_tokens_per_s"]:.0f} real '
        f'tokens/s, padding share {r["padding_share"]:.4f}, peak {r["peak_gib"]:.2f} GiB)'
        for name, r in protein.items()) + f'; {time.perf_counter() - t_start:.1f} s total')
    log(f'[load] {json.dumps(dict(load=load, chaos=chaos, http=load_http, identity=load_identity))}')
    lp = load['on']
    log(f'[summary] {smi}: open-loop load {lp["tok_s"]} tok/s, TTFT p50/p95/p99 '
        f'{lp["ttft_p50"]} / {lp["ttft_p95"]} / {lp["ttft_p99"]} s, TPOT {lp["tpot_p50"]} / '
        f'{lp["tpot_p95"]} / {lp["tpot_p99"]} s, queue wait {lp["queue_wait_p50"]} / '
        f'{lp["queue_wait_p95"]} / {lp["queue_wait_p99"]} s, goodput share '
        f'{lp["goodput_frac"]}, shares {json.dumps(lp["roofline"])}; attribution off '
        f'{load["attribution_off"]["tok_s"]:.2f} tok/s; chaos tokens agreeing '
        f'{chaos["token_agreement"]:.4f}, overload shed rate {chaos["overload"]["shed_rate"]}; '
        f'HTTP TTFT p50/p95/p99 {load_http["report"]["ttft_p50"]} / '
        f'{load_http["report"]["ttft_p95"]} / {load_http["report"]["ttft_p99"]} s; '
        f'{time.perf_counter() - t_start:.1f} s total')
    log(f'[index] {json.dumps(index_tiers)}')
    log(f'[rag] {json.dumps(dict(chat=rag_chat, eval=rag_eval, generation_job=job, identity=rag_identity))}')
    log(f'[summary] {smi}: index of {INDEX_ROWS} x {INDEX_DIM}, {RAG_QUERIES} queries top '
        f'{INDEX_TOP_K}: ' + '; '.join(
            f'{p} {r["device_bytes"] / 2**20:.0f} MiB, built {r["build_s"]:.1f} s, search '
            f'{r["host_ms"]:.2f} ms host / {r["device_ms"]:.3f} ms device (bound '
            f'{r["bound_ms"]:.3f}), {r["queries_per_s"]:.0f} queries/s with encoding'
            for p, r in index_tiers.items())
        + f'; RAG chat {rag_chat["tokens_per_s"]:.1f} tok/s, retrieve '
        f'{median(rag_chat["retrieve_ms"]):.2f} ms a request; eval {rag_eval["wall_s"]:.2f} s; '
        f'generation job {job["tokens_per_s"]:.1f} tok/s; {time.perf_counter() - t_start:.1f} s total')
    log(f'[pipeline] {json.dumps(dict(pipeline=pipeline, identity=pipeline_identity, checkpoint=checkpoint, debug=debug_surface))}')
    arm1, arm2, arm2d = (pipeline['arms'][n] for n in ('depth1', 'depth2', 'depth2_defer'))
    log(f'[summary] {smi}: pipelined generate_ids ({PIPE_LAYERS} of 32 layers), {PIPE_PROMPTS} '
        'prompts: depth 1 / 2 / 2 + defer '
        f'{arm1["tokens_per_s"]:.1f} / {arm2["tokens_per_s"]:.1f} / {arm2d["tokens_per_s"]:.1f} '
        f'tok/s, device gap median {arm1["device_gap_ms_median"]} / '
        f'{arm2["device_gap_ms_median"]} / {arm2d["device_gap_ms_median"]} ms, busy share '
        f'{arm1["busy_share"]:.4f} / {arm2["busy_share"]:.4f} / {arm2d["busy_share"]:.4f}, '
        f'overshoot_frac {arm1["overshoot_frac"]} / {arm2["overshoot_frac"]} / '
        f'{arm2d["overshoot_frac"]}, agreeing with depth 1 {arm2["agreement_with_depth1"]:.4f} / '
        f'{arm2d["agreement_with_depth1"]:.4f}, measured decode MFU / bandwidth share median '
        + ' / '.join(f'{a["measured"]["mfu_median"]:.4f} {a["measured"]["bw_util_median"]:.4f}'
                     for a in (arm1, arm2, arm2d))
        + f'; {time.perf_counter() - t_start:.1f} s total')
    log(f'[mcqa] {json.dumps(dict(mcqa=mcqa, boot=mcqa_boot, cli=cli_run, identity=mcqa_identity))}')
    log(f'[summary] {smi}: MCQA (Mistral-7B bf16, {RAG_MODEL["num_layers"]} layers, RAG over {MCQA_CHUNKS} chunks) '
        f'{mcqa["questions"]} questions in {mcqa["wall_s"]:.2f} s = '
        f'{mcqa["questions_per_s"]:.2f} questions/s, answer latency p50 / p95 '
        f'{mcqa["answer_latency_p50_s"]:.3f} / {mcqa["answer_latency_p95_s"]:.3f} s, '
        f'{mcqa["generated_tokens_per_s"]:.1f} generated tok/s, resume {mcqa["resume_s"]:.2f} s; '
        f'booted server ready in {mcqa_boot["ready_s"]:.2f} s, answers identical to the direct '
        f'generator; CLI generate {cli_run["generate_s"]:.2f} s, embed {cli_run["embed_s"]:.2f} s; '
        f'fp32 MCQA identical on K1 and plain: {mcqa_identity["identical"]}; '
        f'{time.perf_counter() - t_start:.1f} s total')
    log(f'[mixtral] {json.dumps(dict(quantize_bank=quantize_bank, serve=mixtral_serve, identity=mixtral_identity, spec_mixed=mixtral_spec, checkpoint=mixtral_ckpt))}')
    log(f'[summary] {smi}: Mixtral-8x7B int8 (32 layers, 8 experts, top 2) built in '
        f'{mixtral_serve["build_s"]:.1f} s, {mixtral_serve["weight_gib"]:.2f} GiB int8 weights, '
        f'peak {mixtral_serve["peak_gib"]:.2f} GiB; {mixtral_serve["tokens_per_s"]:.2f} tok/s, '
        f'decode {mixtral_serve["decode_pass_ms"]} ms a pass (estimate: {MIXTRAL_ESTIMATE}); '
        f'HTTP {mixtral_serve["http_statuses"]}; graph pools '
        f'{json.dumps(mixtral_serve["pool_mib"])} MiB; fp32 identities '
        f'{mixtral_identity["float_identical"]} / {mixtral_identity["int8_identical"]}; '
        f'spec / mixed agreement {json.dumps(mixtral_spec["agreement"])}; checkpoint identical '
        f'{mixtral_ckpt["identical_to_direct"]}; 4-D quantizer peak '
        f'{quantize_bank["peak_extra_slices"]:.3f} slices; '
        f'{time.perf_counter() - t_start:.1f} s total')
    log(f'[tp] {json.dumps(dict(serve=tp_serve, mixtral=tp_mixtral, identity=tp_identity, nccl=tp_nccl))}')
    log(f'[summary] {smi}: tensor_parallel_size 2 on one card over gloo (two ranks '
        f'timesharing the card, not a TP speed): Mistral-7B bf16 {tp_serve["tokens_per_s"]:.2f} '
        f'tok/s, decode {tp_serve["decode_pass_ms"]} ms a pass, per-rank weights '
        f'{tp_serve["rank_weight_gib"]} GiB, bf16 agreement with one rank '
        f'{tp_serve["agreement"]:.4f}, HTTP {tp_serve["http_status"]}; Mixtral-8x7B int8 '
        f'({TP_MIXTRAL_MODEL["num_layers"]} layers) per-rank {tp_mixtral["rank_weight_gib"]} GiB, '
        f'{tp_mixtral["tokens_per_s"]:.2f} tok/s; fp32 identities {tp_identity["identical"]}; '
        f'NCCL group of one: graphs with collectives, bitwise '
        f'{tp_nccl["decode"]["identical"]} / {tp_nccl["verify"]["identical"]}; '
        f'{time.perf_counter() - t_start:.1f} s total')
    log(f'[control plane] {json.dumps(dict(fabric=fabric, router=router, peer=peer))}')
    pod, kill, world = fabric['arms']['pod'], fabric['arms']['kill'], fabric['world']
    rr, aff = router['arms']['round_robin'], router['arms']['prefix_affinity']
    log(f'[summary] {smi}: pbspro pod of 2 workers {pod["files_per_s"]:.2f} files/s '
        f'(local {fabric["local_s"]:.2f} s for {fabric["files"]} files), shards equal the '
        f'local run\'s ({pod["err_over_tol"]:.3f} x tolerance); kill arm requeued '
        f'{kill["requeued"]} in {kill["requeue_s"]:.2f} s, every file once; slurm world of one '
        f'over {world["backend"]}; router warm TTFT p50 round-robin {rr["warm_ttft_p50"]:.4f} s, '
        f'affinity {aff["warm_ttft_p50"]:.4f} s ({router["warm_ttft_speedup"]:.3f}x), '
        f'decisions {json.dumps(aff["decisions"])}; failover '
        f'{router["failover"]["retried"]} retried, {router["failover"]["identical"]}/'
        f'{router["failover"]["requests"]} identical; peer handoff fp32 identical '
        f'{peer["fp32"]["identical"]}, bf16 first token {peer["bf16"]["first_token_ms_b"]:.1f} '
        f'vs {peer["bf16"]["first_token_ms_c"]:.1f} ms; {time.perf_counter() - t_start:.1f} s total')
    log(f'[mesh axes] {json.dumps(dict(tp_tiers=tp_tiers, tp_tiers_identity=tp_tiers_identity, index_sharded=index_sharded, encoder_tp=encoder_tp))}')
    k3_shard = next(c for c in k3_cases if c['case'] == TP_K3_CASES[0])
    log(f'[summary] {smi}: KV tiers at tp2 (7B bf16, gloo on one card): '
        f'{tp_tiers["tier"]["spills"]} spills / {tp_tiers["tier"]["promotions"]} promotions, '
        f'rank 0 host tier {tp_tiers["tier"]["host_gib"]:.4f} GiB (one rank '
        f'{tp_tiers["one_rank"]["host_gib"]:.4f}), spill ms/MiB by rank '
        + ' / '.join(str(r['spill_ms_per_mib']) for r in tp_tiers['ranks'])
        + f' (one rank {tp_tiers["one_rank"]["spill_ms_per_mib"]}), promotion copy ms/MiB by '
        'rank ' + ' / '.join(str(r['promote_copy_ms_per_mib']) for r in tp_tiers['ranks'])
        + f' (one rank {tp_tiers["one_rank"]["promote_copy_ms_per_mib"]}); fp32 identical '
        f'{tp_tiers_identity["identical"]}, int8 KV {tp_tiers_identity["int8"]["identical"]}, '
        f'peer both ways {json.dumps({k: v["identical"] for k, v in tp_tiers_identity["peer"].items()})}; '
        'sharded index device ms (one card, not a multi-card speed) ' + '; '.join(
            f'{p} ' + ' / '.join(f'data {d} {r["device_ms"]:.4f}' for d, r in runs.items())
            for p, runs in index_sharded.items())
        + f'; BERT-base tp2 fp32 {encoder_tp["fp32_err_over_tol"]:.4f} x tolerance, bf16 '
        f'{encoder_tp["bf16_err"]:.4e} (bound {encoder_tp["bf16_bound"]:.4e}); K3 at 6 heads '
        f'{k3_shard["ms"]:.4f} ms (bound {k3_shard["bound_ms"]:.4f}, SDPA '
        f'{k3_shard["library_ms"]:.4f}); {time.perf_counter() - t_start:.1f} s total')
    # The wgmma routes (K1's route 3, K3's route 2), each a kernel of its
    # own in the line: launches on the main paths, times at the headline
    # case beside route 1's on the same inputs in the same call, and the
    # A/B of the two routes at every case that both take.
    kernels += wgmma_entries(cases + hd256_cases, k3_cases, serve, gemma2, load, protein)
    if not all(math.isfinite(c['ms'])
               for c in cases + int8_cases + mixed_cases + hd256_cases + k3_cases + k2_cases):
        fail('non-finite kernel time')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count(),
    }}), flush=True)


if __name__ == '__main__':
    main()

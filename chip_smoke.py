"""GPU smoke run of the PyTorch port's serving paths: one request at a time
over a dense cache, and continuous batching over int8 KV-fused page pools,
each with bf16 weights, int8 weights (`--load-8bit`) and int4 weights
(`--load-4bit`), each with prompt-lookup speculation (`--lookahead`) and
each with multi-step bursts replayed as CUDA graphs (`--multi-step`);
continuous batching over one dense cache; per-request sampling, logprobs
and penalties in the replayed steps of both batchers; the OpenAI
endpoints; two-model speculation (`--draft-model`) on both batchers, the
draft's proposal bursts replayed as CUDA graphs; the paged batcher's prefix
cache (`--prefix-cache`) and lazy allocation with host swap (`--lazy-alloc`);
multi-LoRA serving; structured output (grammar-masked decoding) on all three
paths with the OpenAI `response_format` and `tools`; the evaluation
harness's batched greedy decoding and beam search;
the server's /health, /metrics, /debug/profile and drain; the writefirst
paged decode step; the fused int8 MLP probe; the
trainer, stage 1 and stage 2; the load paths (the trainer's own checkpoint,
the peft artifact, the consolidated dir, the native tokenizer); and the
batched-head and slot-grouped attention probes.

    python3 chip_smoke.py [--seed N] [--max-new-tokens N] [--profile] [--phases a,b]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; exits non-zero on a machine without a card. Phases:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds `vis_zephyr_tpu_torch/csrc/*.cu` into the ignored
             `vis_zephyr_tpu_torch/build/`;
3. K1      — flash_fwd (wgmma + TMA: its SASS must hold HGMMA and UTMALDG)
             against its plain version (f32 from the same bf16 inputs, one
             batch row at a time): causal T=S 256 and 2048, non-causal, B=2
             with right-padded keys plus a row that has no valid key, the
             trainer's B=8, T=S=2048 with each row's keys padded to another
             length, a 64-row half tile (T=S=192), non-causal T=128 S=320 and
             GQA group 1; output max-abs <= 2e-2, logsumexp max-abs <= 1e-2,
             keyless rows exactly 0 with l = 0 and m = NEG_INF; timed at B=1,
             T=S 256 and 2048 and at the trainer's shape; then K7
             (dK, dV) and K8 (dQ) (wgmma + TMA: each one's SASS must hold
             HGMMA and UTMALDG; registers and spills from cuobjdump
             -res-usage) in K1's first four cases, at the trainer's B=8,
             T=S=2048 with right-padded keys, at B=16 T=S=320 and at
             non-causal T=128 S=320, against
             `flash_attention_bwd_plain` in f32 on the same bf16 inputs and
             K1's m and l, one batch row at a time: per tensor max-abs <=
             1e-2 of its largest value and cosine >= 0.9999, dQ exactly 0 on
             rows without a key and dK = dV = 0 on invalid keys; kernel (per
             call and on the device alone), plain, bound and the backward of
             `scaled_dot_product_attention` at T=S 256 and 2048 and at B=8;
4. K2      — dense_cache_append's two entries against their plain versions,
             bit-exact: the copy entry (rows already rotated, the JAX
             contract) and the rope entry (K rotated in the kernel, what the
             dense-cache forward calls), at the decode step's shape (T=1), a
             clamped tail, and chunked admission's (B=1, T=256 into a scratch
             cache, one chunk ending at the cache's end); at the decode shape
             and a chunk: per call (median of 20 CUDA-event runs), on the
             device (a CUDA-graph replay) and issued back to back, beside the
             plain version, the bound, `index_put_` of the rotated rows and
             the route taken before (eager apply_rope + the copy entry); the
             same at the dense batcher's shapes: B = 8 and 32 slots of 2048
             rows at T = 1, and its verify step (B = 8, T = 5, rows clamped
             at the cache's end);
5. K3      — paged_attn_decode's SASS must hold HMMA (mma.sync), UTMALDG (the
             pages by TMA) and UBLKCP (the scales by bulk copy); registers and
             stack printed; then against its plain version at B=32, Hq=32,
             Hkv=8, D=128, page 128, 16 pages per slot, a shuffled page table
             and lengths that include 0, 1, 128, 129 and 2048: bf16 split,
             int8 split and int8 fused pools, each with and without the
             self-term, a windowed case, a two-row (S=2) case and NaN rows
             past `length`; per slot, max-abs error <= 1e-2 of the slot's
             largest value; exact zeros where no key is valid; the window's
             edge told from 511 and 513; the split plan's cases (one slot of
             2048 in 16 splits, one of 200, one of 2048 with a window of
             1000, 128 slots of 640 without a split, slots with fewer pages
             than splits, S = 9 with a window whose edge crosses a page
             between the tile's rows) and two calls at a split shape equal
             bit for bit; device times at the decode shape and at 2048
             tokens; then without the self-term at
             S = 1 to 9 query rows per slot (the verify shape; S = 9 is two
             row tiles) over int8 fused pools of 60 to 800 tokens, times
             (per call and on the device) and bound per S, bf16 split pools at
             S = 5 with a window; then
             rows 7 and 8's contracts: the single-row entry `paged_attention`
             over bf16 and int8 split pools with and without the self-term,
             with and without a window of 512, and
             `paged_attention_fa(fold_heads=False)` at S = 1 and 5, each per
             slot against the plain version; times at served lengths;
6. K4      — paged_kv_rows against its plain version at L=32, B=32 with
             inactive slots on the trash page: bf16 and int8, split and
             fused; whole pools and scales bit-exact, page 0 included (the
             last row in launch order wins there, in both); timed per call,
             on the device and issued back to back; then its absolute-page
             entry: `paged_kv_update_layer` at B=32, S = 1 to 9 rows a slot
             from a page table (rows sharing a page, rows forced onto the
             trash page, inactive slots) and on strided views, and the JAX
             contract paged_kv_update at L = 1 and 2, over the same four pool
             forms, bit-exact; timed at the verify step's form (int8 fused,
             S = 5) beside the route taken before (S single-row calls);
7. K5      — quant_matmul_int8 (wgmma, weights by TMA: its SASS must hold
             HGMMA and UTMALDG; its PRMT, LOP3 and I2F counts, registers and
             stack printed) against its plain version at every (K, N) of
             an int8 projection (decoder q/o, k/v, gate/up, down; Q-Former
             packed in_proj, cross k/v, ffn.0, ffn.2) with M = 1, 7, 32, 128,
             plus a K % 64 tail with ragged N and K = 16, each also with f32
             output; per row, max-abs error <= 1e-2 of the row's largest
             value; kernel (per call, on the device alone from a CUDA-graph
             replay, and issued back to back), plain, library
             (`torch._weight_int8pack_mm` where it runs, else dequantize +
             matmul; by events and on the device), the bf16 weights'
             `F.linear` on the device and bound, per shape and summed per
             decoder pass;
8. K6      — quant_matmul_int4 against its plain version at every (K, N) of
             an int4 projection (decoder q/o, k/v, gate/up, down; group 128)
             with M = 1, 7, 32, 128, plus one group (K = 128) and a 256-wide
             group, each also with f32 x; the same check and readings as K5's
             (library: `torch._weight_int4pack_mm` where it runs, else
             dequantize + matmul), and its SASS must hold no I2F (nibbles
             convert by lop3);
8b. K9     — fused_mlp_matvec against its plain version at D = 4096,
             I = 14336, M = 1 and 8, both tilings (block_i 64 and 128),
             random int8 weights from the seed: max-abs error over max |plain|
             <= 1e-2, cosine >= 0.9999; kernel (events and device-only),
             plain, the K5 route (K5 gate and up, F.silu(g) * u, K5 down),
             `torch._weight_int8pack_mm` x 3 + F.silu where it runs, bound;
9. slice1  — full-width Zephyr-7B + CLIP-L/336 + Q-Former with random bf16
             weights, the port's /chat server on 127.0.0.1 with no flags, 3
             sessions and 4 requests; checks the launch counters and the
             kernel path's prefill and decode-step-8 logits against the plain
             path (cosine >= 0.999); TTFT and decode tokens/s;
10. paged  — the same model behind the server started with
             `--continuous-batching --kv-cache paged --kv-quant --max-slots 32`
             (KV-fused int8 pools, page 128, prefill chunk 256): 48 /chat
             requests from 48 sessions sent at once, prompts of about 40, 300
             and 600 words; every reply HTTP 200 with all its tokens; launch
             counters exact (K3 = 32 x decode steps, K4 = decode steps, K2 =
             32 x prefill chunks); slots reused; every page back in the
             allocator; then the server's own readings: GET /health "ok",
             GET /metrics (its TTFT and TPOT counts equal the 48 requests),
             one GET /debug/profile?seconds=1 with a request in flight (its
             trace file written and not empty), and a drain with one request
             in flight (that request ends with all its tokens, the next POST
             gets 503 and /health reads "draining");
11. batch  — direct PagedBatchers with the same 16 requests admitted before
             the first step, whole (K1) and in chunks of 256 (K2 at T=256), on
             the kernel path and on the plain path, and with bf16 pools:
             chunked admission bit-equal between the paths; logits cosine per
             slot at steps 1 and 16 (kernel vs plain >= 0.999, int8 vs bf16
             pools >= 0.99); the two int8 runs' pools against each other
             (dequantized rows cosine >= 0.999, int8 values within 1 for
             >= 95 %, scales within 5 %);
11b. writefirst — the fixed batch of 16 (bf16 weights) stepped 16 times by
             `_paged_step(mode="writefirst")` and by mode "selfterm" on copies
             of its state, over bf16 split and int8 fused pools, both fed the
             selfterm step's tokens: logits cosine per slot >= 0.999 at every
             step, exactly 32 K3 and 32 paged_kv_update launches per
             writefirst step and no paged_kv_rows; greedy agreement printed;
             then one 32-slot step in each mode profiled side by side (wall,
             device busy, idle share, largest device items, K4's device time
             per launch);
12. spec   — speculation (`--lookahead 4`): two dense /chat requests with
             lookahead 4 and the same two with lookahead 0 (K1 and K2 counts
             exact, verify calls > 0; the streams' agreement printed); a
             paged server burst of 16 repetitive questions with `--lookahead
             4` (K3 = 32 x verify steps, paged_kv_update = 32 x verify
             steps, no paged_kv_rows launch), after the same burst without
             it for comparison; one verify step of a fixed
             batch of 16 on clones of int8 fused and bf16 split pools:
             kernel vs plain path cosine >= 0.999 on every column, column 0
             vs the decode step >= 0.99 (int8) and >= 0.999 (bf16); the
             verify steps of both paths replayed as CUDA graphs against the
             same steps run eagerly on the kernel path, 5 consecutive steps
             with acceptance and rollback between them, bit for bit (paged:
             32 slots, logits, pools, lengths, pending tokens and streams,
             K3 and K4 exact; dense: greedy tokens, logits, K, V and
             lengths, K2 and verify calls exact), then each form's wall,
             device busy and idle share and the graph pools (printed);
12b. multistep — multi-step bursts (`--multi-step 8`); every served decode
             step is a CUDA-graph replay, in bursts of one by default: a
             fixed batch of 32 slots (int8 fused pools) stepped 8 times by
             replays and 8 times by eager kernel-path `_paged_step`s on
             clones of its state (tokens equal on every slot at every step,
             logits cosine >= 0.999 per slot per step, K3 and K4 counted
             exactly, a replay as a launch); a burst of 8 on graphs against
             8 eager steps with the carry on the host, budgets 1 to 9 and an
             EOS inside the burst (tokens, alive masks, pools and lengths
             exactly equal); a burst of 8 against the same burst under
             `plain_versions()` (each slot's first differing step printed;
             last-step cosine >= 0.999 on the slots that never differ, at
             least 16 of them); the paged server burst of 48 requests with
             `--multi-step 8` (every reply HTTP 200 with all its tokens, K3 =
             32 x decode steps and K4 = decode steps with a burst's steps
             counted, bursts run, every page back); the B = 1 dense step
             replayed against the eager `decode_step`, 9 steps bit for bit;
             two dense /chat requests with `--multi-step 8` and the same two
             with `--multi-step 1` (K1 and K2 exact, streams equal); then,
             printed and not gated, the wall, device busy and idle share per
             token of the 32-slot step and of the B = 1 dense step run
             eagerly and in bursts of 1, 4, 8 and 16, the captures' host
             time and graph pools' memory, and a burst of 8 on int8 and on
             int4 weights in phases 15 and 16;
12c. dense_batch — the dense continuous batcher: the server with
             `--continuous-batching --max-slots 8` (one cache of 8 x 2048
             rows, prefill chunks of 256) under 16 concurrent /chat requests
             (every reply HTTP 200 with all its tokens, K2 = 32 x (decode
             steps + chunks), K1 = 0; TTFT median and max, tokens/s,
             captures and the graph pool printed); a fixed batch of 8
             admitted whole into two batchers, one stepping as served (each
             step a replay), one through eager kernel-path `_batch_step`s
             from the same state: logits, cache, lengths, tokens and streams
             bit for bit over 8 steps, K2 exact; the first step's logits
             against the serialized B = 1 `decode_step` (cosine >= 0.999,
             first tokens equal); the replayed and the eager 8-slot step
             profiled; a burst of 8 against 8 single steps (budgets 2 to 9)
             bit for bit; `--lookahead 4`: 5 verify steps replayed against 5
             eager `decode_verify`s with acceptance and rollback, bit for
             bit, K2 and verify calls exact; on int8 weights (phase 15) 8
             replayed steps at 8 slots with K5 = 224 a step and no
             dequantize call;
12d. sampled — per-request sampling on both batchers: 8 requests, the even
             slots at temperature 0.8 and top-p 0.9, two with logprobs and
             two penalized; a batcher stepping as served against one stepping
             eagerly from the same state and generator state, 6 steps: bit
             for bit (tokens, logits, state, counts, logprobs); greedy rows
             the argmax of their (penalized) logits, logprobs the step's
             `log_softmax` within 1e-3, the penalized slots' counts exactly
             their emitted tokens, the sampled tokens inside their nucleus;
12e. openai — the OpenAI endpoints on the port's server in this process
             (the dense batcher, the stand-in tokenizer, text prompts):
             /v1/models, a chat completion as one body and as SSE (the same
             text), n = 2, a stop string, logprobs (top 3: the greedy token
             the top-1), sampling with penalties, `tools` under "auto";
12f. draft — two-model speculation at full width (bf16 target): a random
             draft of the same vocabulary and tokenizer, decoder depth 2 at
             the published widths, saved as the port's `state/state.pt`
             with its `config.json` and a Zephyr-form `tokenizer.json`,
             loaded through the server's flags (`--draft-model` with no
             `--lookahead`: 4); three rounds of its proposal burst over 16
             slots (various caps, commits and rollbacks between rounds) as
             served (the first round the capture's warm-up, then replays),
             as an eager burst with the carry on the device and as single
             steps with the host choosing each token, from the same state:
             proposals and the draft cache bit for bit, K1 = 2 x admissions
             and K2 = 2 x draft steps exactly; each draft's burst timed
             (wall, device busy, idle share; captures' seconds). Then the
             paged server (int8 fused pools, `--max-slots 16`, 16 requests)
             and the dense one (`--max-slots 8`, 8 requests), each without
             speculation, with `--lookahead 4` (prompt lookup), with the
             target as its own draft and with the small draft: every reply
             HTTP 200 with all its tokens, K1 = draft layers x draft
             admissions and K2 = 32 x (target's chunks and, dense, verify
             steps) + draft layers x draft steps exactly (paged: K3 and
             paged_kv_update 32 x verify steps, no paged_kv_rows), every
             request a draft admission, GET /metrics' requests and
             proposals equal to the batcher's; printed, not gated: tokens/s
             of the four, each draft's acceptance rate from /metrics, and
             the first divergence of each speculative run's streams from
             the lookup-only and unspeculated ones;
12g. prefix_swap — the paged batcher's page sharing and page growth: eight
             text prompts on one 1024-token prefix (8 pages; suffixes of 40
             to 200 words, chunks of 256), the first run to its end, then
             the other seven, through PagedBatchers on KV-fused pools with
             and without `prefix_cache`: on bf16 pools the warm streams
             equal the cold ones bit for bit, hits >= 7 and pages reused >=
             56, K2 = 32 x (chunks - 4 a warm admission), K3 = 32 x decode
             steps, K4 = decode steps; on int8 pools two warm runs equal bit
             for bit, the first divergence from the cold run and the prefill
             logits' cosine printed; each run's admission wall (the first of
             the seven, submit to first token). Then lazy allocation: 24
             requests of 512 tokens with budgets of 64 to 256 on 16 slots
             (int8 fused pools), lazy on 80 usable pages against eager on the
             default pool: every stream equal bit for bit with every step a
             replay (the same captures), swaps out and in >= 1 each, the raw
             pool rows' bytes and the swaps' times printed, launches exact,
             every page back. Then the server with `--prefix-cache
             --lazy-alloc --kv-quant --max-slots 16 --num-pages 48` under 16
             concurrent /v1/completions on an 1100-word prefix: every reply
             HTTP 200 with all its tokens, GET /metrics' prefix_cache hits
             and swaps out and in >= 1, K3 and K4 exact;
12h. mlora  — multi-LoRA serving: two random adapters at the published
             widths (r = 128, alpha = 256, all seven targets in every layer)
             written as peft dirs and loaded by `--lora-adapters`; a fixed
             batch of six slots (base, a, b twice) on the paged batcher
             (int8 KV-fused pools, page 128) and on the dense batcher, 8
             replayed steps each, held against each request alone with its
             adapter's leaves attached (`attach_lora`), fed the same tokens:
             logits cosine >= 0.999 (prefill included), greedy tokens equal
             wherever the logits decide them (a token may differ only at a
             tie: the solo margin within twice the rows' largest logit
             difference; the count is printed); the base slots bit
             for bit the batch served with no pack; a new adapter mix in the
             same buffer replays without a new capture, and so do 4 verify
             steps (`--lookahead 4`) on each batcher; a 700-word prompt
             under a, b, a with `--prefix-cache`: b reuses no page, a's
             repeat hits and gives a's tokens; the server with the flag:
             GET /v1/models lists a and b, /v1/completions routes `model` a,
             b and base (three different texts), /chat takes `adapter`, an
             unknown name is a 400 on both; the replayed 32-slot decode
             step's wall and device time with the pack (base, a, b mixed)
             and without it, and the pack's bytes. In the int8 phase the
             fixed batch again on `--load-8bit` weights (K5), each slot
             against the same request alone under the same adapter;
12i. grammar — structured output at full width (bf16 weights): the token
             strings of the Zephyr-form `tokenizer.json` (32000 pieces) read
             through the port's `NativeTokenizer`, a regex and a JSON schema
             (a patterned string, an integer of an enum, an enum) compiled
             over them (host ms printed); the paged server (`--kv-quant`,
             32 slots, chunked admission) under a burst of 16
             /v1/completions requests (4 regex, 4 schema, 8 free), then the
             same 16 free: the free requests' tokens equal in both runs,
             every constrained reply matches its grammar (the schema's
             parses with its three fields), the masked steps are replays of
             one capture that launch K3 and K4; the dense batcher and the
             serialized path with 2 constrained and 2 free requests each
             (the free ones equal their own run, the masked steps replays of
             one capture that launch K2, the admissions K1); a json_schema chat completion and a forced
             tool call (`tools`, `tool_choice` "required") on the server;
             the 16-slot step's wall masked against unmasked, and the mask
             gather's device time;
12j. eval  — the evaluation entry point (`eval/eval_vqa.py`) after
             preparation, at full width (bf16 weights): 8 VCR items (4 boxes
             with polygon masks each, prompts from the port's `vcr_qa_eval`
             in the `zephyr_vcr` template, seeded pixels with 1 to 4 crops;
             the smoke does not rely on PIL for the overlay) through
             `score_items` greedily at batch 8, then 2 of them with
             `--num-beams 4`, 16 tokens each: the answers JSONL whole, K1 = 32
             a prefill and K2 = 32 a decode step exactly; each row of the
             right-padded batched prefill against its item alone and the
             batch against `plain_versions()` (first logits' cosine >= 0.999);
             the replayed beam search (the fixed K-row cache, one captured
             step) against eager steps on a cache of the same slots, the
             same hypotheses and scores bit for bit; `num_beams` 1 equal to
             greedy `generate`; the best hypothesis's score against a
             teacher-forced one (the prompt's prefill, then the hypothesis in
             one verify pass; within 2 %);
             printed: items/s, a beam step's wall replayed and eager, the
             reorder's time, the captures and a smaller last batch's cost;
13. profile — only with --profile: wall, device-busy and idle share of one
             batched decode step at B=32, of one verify step (S = 5) and of
             one dense decode step (B = 1), their kernel launches per step
             and the largest device items (torch.profiler); a text-only prefill
             of 2048 tokens (K1's share of its device time, one K1 launch a
             layer); the decode step again on int8 and int4 weights after
             phases 15 and 16, the verify step on int8 weights;
14. precision — (it widens the model in place): the bf16 prefill logits
             against an f32 run of the same weights (the JAX engine's
             arithmetic for f32 pixels; cosine >= 0.999);
15. int8   — the model rebuilt from the same seed and quantized in place by
             `load_8bit`'s step (`models/builder.py::quantize_weights`;
             memory before, after and at the peak), then 2 dense /chat
             requests and a paged burst of 16 on it, and the fixed batch of
             16 admitted whole on the kernel path, the plain path and against
             phase 11's bf16 logits (fed its tokens): kernel vs plain cosine
             >= 0.999, int8 vs bf16 weights >= 0.997; K5 (224 per decoder
             launch a chunk of at most 128 rows, up to `QMM_CHUNK_MAX_M`
             rows a pass) and dequantize-route counts (224 per longer pass)
             exact against what the prefill, chunk and step counters
             predict, the Q-Former's projections counted by rows; 14 verify
             steps of 32 slots (160 rows: K5 on chunks of 128 and 32 rows,
             no dequantize call) counted, the replayed step's wall, device
             busy and idle share printed;
15b. mlp_probe — `python -m vis_zephyr_tpu_torch.experiments.fused_mlp_matvec_probe`'s
             `main()` (numerics, then 32 chained calls in one CUDA graph for K9
             at each tiling and for the K5 route: us per layer, weight GB/s,
             speedup), and K9 on layer 0's MLP of phase 15's int8 model (a
             full-width MLP quantized alike when phase 15 does not run) at M = 1
             against `layer.mlp(hn)`: cosine >= 0.999;
16. int4   — the same on a model rebuilt from the seed and quantized by
             `load_4bit`'s step (int4 decoder with group-128 scales, int8
             Q-Former): 2 dense requests, a paged burst of 16, the fixed batch
             (kernel vs plain cosine >= 0.999; against bf16 and int8 weights
             printed, not gated: random weights say nothing of int4's
             quality); K6 (224 per decoder pass, a launch a chunk of at most
             128 rows), its dequantize route (224 per pass past
             `QMM_CHUNK_MAX_M` rows) and K5 (the Q-Former's rows) counted
             exactly; the 160-row verify steps as on int8 weights (K6 on
             chunks, no dequantize call);
17. train  — the served model freed, stage 1 through the trainer's entry
             point `train/train.py::train` at full width with random bf16
             weights from the seed: 3 steps of 8 `<image>` captions (4 anyres
             crops each, seeded pixels through the `dataset` seam, captions
             long enough that `model_max_length` 2048 truncates the splice),
             remat on; loss, grad_norm, step time and tokens/s per step, peak
             memory, the final saves' seconds and bytes (into a temporary
             directory, removed); one more step under torch.profiler for the
             device's idle share; one stage-1 step of 2 rows on the kernel
             path and on the plain path (loss within 1e-3 relative, projector
             gradient cosine >= 0.999); stage 2 (LoRA r=128, alpha=256,
             dropout 0.05) through `make_train_step` for 2 steps; K1 = 64,
             K7 = K8 = 32 launches per micro-step, exactly;
17b. load  — the load paths at full width (random bf16 weights from the
             seed): LoRA (r 128, alpha 256, `lora_b` random) on the decoder's
             projections, one AdamW update of the adapters from seeded
             gradients, the full train state saved by
             `train/checkpoints.save_checkpoint` (free disk checked first;
             bytes, save and sync seconds printed) into a model dir beside
             `config.json` and a Zephyr-form `tokenizer.json` (Metaspace BPE
             with byte fallback, 32000 pieces, written by the script);
             `load_pretrained_model(dir)` with `VZT_NATIVE_TOKENIZER=1` (the
             tokenizer must be the port's `NativeTokenizer`; load seconds and
             host RSS, anonymous and file-backed, printed) against
             `merge_lora` of the in-memory model on the card (every tensor bit
             for bit); 2 sessions and 3 requests through `ChatEngine` on the
             loaded model and on the in-memory one (replies equal, the first
             turns' greedy tokens equal, every text round-trips through the
             native tokenizer, K1 = 32 x requests and K2 = 32 x decode steps
             exactly), then one request on `load_8bit` (K5 launched, no
             dequantize call); the peft artifact (HF base and CLIP tower as
             `pytorch_model.bin`) and the consolidated dir at full widths and
             every decoder layer the disk has room for (all 32 on the card;
             the depth printed), each bit for bit against the merged model;
             whether the native image route builds (printed, not gated: the
             card's machine has no libjpeg headers);
18. attn_probes — last, after every served phase: K10 and K11 must not
             have launched yet. The two attention probes' `main()`
             (`vis_zephyr_tpu_torch/experiments/batched_paged_attention_probe.py`
             and `paired_slot_attention_probe.py`: numerics against the plain
             version and K3, gated at 1e-2 per slot and cosine 0.9999, K11
             at two splits and its first design too; then K3, K10 at
             pages_per_block 1, 5, 8, K11 and its first design
             (`vzt_paged_attn_paired_walk`) at P = 2, 4, 8 in CUDA graphs of
             32 layer calls at 128 slots of 640 tokens and at 32 slots of
             60-800, each route's layer-0 output at both shapes gated
             against the plain version the same way), their launches
             counted from 0; K11's SASS (HMMA, UTMALDG, UBLKCP required)
             and registers; then K10 and K11 at B=32 (lengths 0 to 2048,
             int8 fused pools, self-term) against their plain version and K3
             per slot (<= 1e-2, cosine >= 0.9999) at P = 1, 2, 4, 8,
             pages_per_block 1, 5, 6, 8, with and without a window of 512;
             the slot of length 0 exactly its v_new; NaN scales past length
             bit for bit harmless; `paged_attention_fa(slot_block=2)` routed
             to K11 on fused int8 pools and to K3 on split bf16 ones,
             counted; times at the bench shape for the result line, each
             timed call's output gated against the plain version.

`--phases` runs a subset (kernels, slice1, paged, batch, writefirst, spec,
multistep, dense_batch, sampled, openai, draft, prefix_swap, mlora, grammar,
eval, profile, precision, int8, mlp_probe, int4, train, load, attn_probes) and then prints
no result line. After a full run the line before
last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. Any failed check raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import http.client
import json
import math
import os
import re
import statistics
import subprocess
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import torch

# Published peaks of one H100 SXM at its full 700 W: HBM bytes/s, dense bf16
# tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # outside the tensor cores


def bound_ms(n_bytes: float, n_flops: float, peak: float = BF16_FLOPS):
    """The least time the card could take: (ms, "bytes" | "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def median_ms(fn, runs: int = 20) -> float:
    """Median of `runs` CUDA-event timings of fn() after two warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, runs: int = 10):
    """Device time of one fn() without the host's launch path: `calls` calls
    captured in a CUDA graph, the graph replayed `runs` times, the median
    CUDA-event time of a replay over `calls`. None (printed as not measured)
    when fn cannot be captured."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as e:
        print(f"graph capture failed ({str(e).splitlines()[0][:120]}): device time not measured")
        torch.cuda.synchronize()
        return None
    ms = median_ms(graph.replay, runs) / calls
    del graph
    return ms


def show(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def issue_ms(fn, calls: int = 50) -> float:
    """Host time to issue one fn() when calls go back to back: the wall of
    `calls` calls ended by a synchronize, over `calls`. Above the device time
    it is the wrapper's host path."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def masked_lse(q, k, kv_valid, causal, scale):
    """f32 per-row logsumexp [B, Hq, T] of the masked scores (the kernel's
    m + log l); -inf on rows without a valid key."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, T, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = kv_valid[:, None, None, None, :].clone()
    if causal:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        mask = mask & (cols <= rows)
    s = s.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, T)


@functools.lru_cache(maxsize=None)
def _cuobjdump(flag: str) -> str:
    """`cuobjdump <flag>` of the built kernel library (nvcc's own tool)."""
    from vis_zephyr_tpu_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    dump = subprocess.run([tool, flag, _kernels.LIB], capture_output=True, text=True,
                          timeout=300)
    if dump.returncode != 0:
        raise AssertionError(f"cuobjdump {flag} failed ({dump.returncode}): {dump.stderr[-500:]}")
    return dump.stdout


def sass_counts(function: str, ops=("HGMMA", "UTMALDG", "UTMASTG")) -> dict:
    """Instructions of each kind in `ops` (by default HGMMA (wgmma), UTMALDG
    (TMA load) and UTMASTG (TMA store)) in the built library's functions whose
    names hold `function` (summed over a template's instantiations), read
    with `cuobjdump -sass`."""
    sections = re.split(r"\n\s*Function : ", _cuobjdump("-sass"))[1:]
    body = "".join(sec for sec in sections if function in sec.split("\n", 1)[0])
    if not body:
        raise AssertionError(f"cuobjdump -sass shows no {function} function")
    return {op: len(re.findall(rf"\b{op}\b", body)) for op in ops}


def resource_usage(function: str) -> dict:
    """Registers at entry, stack-frame bytes (where ptxas puts spills) and
    local-memory bytes of the functions whose names hold `function` (the
    largest over a template's instantiations), from `cuobjdump -res-usage`;
    None where the dump does not say."""
    lines = _cuobjdump("-res-usage").splitlines()
    usage = {"reg": None, "local": None, "stack": None}
    for i, line in enumerate(lines):
        if "Function" in line and function in line:
            text = " ".join(lines[i:i + 2])
            for key in usage:
                m = re.search(rf"\b{key.upper()}:(\d+)", text)
                if m:
                    usage[key] = max(usage[key] or 0, int(m.group(1)))
    return usage


def flash_pairs(kv_valid, T: int, causal: bool) -> int:
    """The (row, key) pairs attention needs on these inputs: valid keys, and
    col <= row under `causal` (each costs 4 * Hq * D FLOPs for the two products)."""
    S = kv_valid.shape[1]
    if not causal:
        return int(kv_valid.sum()) * T
    seen = kv_valid.long().cumsum(dim=1)          # valid keys at or before each column
    rows = torch.arange(T, device=kv_valid.device).clamp(max=S - 1)
    return int(seen[:, rows].sum())


def check_flash(gen) -> dict:
    """K1 against its plain version run in f32 on the same bf16 inputs, one
    batch row at a time: output max-abs <= 2e-2 and logsumexp (m + log l)
    max-abs <= 1e-2 on rows with a key; on a row without one the output is
    exactly 0, l = 0 and m = NEG_INF. The first four cases are the phase's
    oldest (their inputs come first from `gen`); the rest (the trainer's B=8, T=2048 with
    right-padded keys, a 64-row half tile, S != T with S not a multiple of
    128, GQA group 1) draw from a generator of their own, so later phases see
    the inputs they saw before. Timed, B=1 at T=S 256 and 2048 and the
    trainer's shape: kernel (CUDA events around one call, and on the device
    alone from a CUDA-graph replay), plain, `scaled_dot_product_attention`
    (with the padding as a boolean mask where there is one; the same two
    readings) and the bound from this run's valid pairs. Fails if K1's SASS
    has no HGMMA or no UTMALDG."""
    from vis_zephyr_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    D = 128
    sass = sass_counts("flash_fwd_kernel")
    print(f"K1 SASS (cuobjdump -sass, flash_fwd_kernel): {sass}")
    if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
        raise AssertionError(f"K1 does not run on wgmma fed by TMA: {sass}")
    S_row = torch.arange(256, device=dev)
    padded = torch.stack([S_row < 200, (S_row >= 1) & (S_row < 230)])  # b=1, q row 0: no key
    rows_2048 = torch.arange(2048, device=dev)
    lengths = torch.tensor([2048, 1900, 1664, 1537, 1280, 1029, 700, 333], device=dev)
    ragged = rows_2048[None, :] < lengths[:, None]   # each row's keys right-padded
    extra = torch.Generator(dev).manual_seed(gen.initial_seed() + 1)
    cases = [
        # name, B, T, S, Hq, Hkv, causal, kv_valid, generator, timed as
        ("causal T=S=256", 1, 256, 256, 32, 8, True, None, gen, 256),
        ("causal T=S=2048", 1, 2048, 2048, 32, 8, True, None, gen, 2048),
        ("non-causal T=256 S=512", 1, 256, 512, 32, 8, False, None, gen, None),
        ("causal B=2 padded kv_valid", 2, 256, 256, 32, 8, True, padded, gen, None),
        ("causal B=8 T=S=2048 right-padded keys", 8, 2048, 2048, 32, 8, True, ragged, extra,
         "B8_2048"),
        ("causal T=S=192 (a 64-row half tile)", 1, 192, 192, 32, 8, True, None, extra, None),
        ("non-causal T=128 S=320", 1, 128, 320, 32, 8, False, None, extra, None),
        ("causal T=S=256 GQA group 1 (Hq=Hkv=8)", 1, 256, 256, 8, 8, True, None, extra, None),
    ]
    worst = 0.0
    times = {}
    for name, B, T, S, Hq, Hkv, causal, kv_valid, g, timed in cases:
        q = torch.randn(B, T, Hq, D, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        if kv_valid is None:
            kv_valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        scale = D ** -0.5
        out, m, l = fa.flash_attention_fwd(q, k, v, kv_valid, causal, scale)
        torch.cuda.synchronize()
        out_err = lse_err = 0.0
        n_empty = 0
        for b in range(B):  # the f32 reference one batch row at a time
            row = slice(b, b + 1)
            ref = fa.flash_attention_plain(q[row].float(), k[row].float(), v[row].float(),
                                           kv_valid[row], causal, scale)
            ref_lse = masked_lse(q[row], k[row], kv_valid[row], causal, scale)
            has_key = torch.isfinite(ref_lse)
            err = (out[row].float() - ref).abs()
            # Rows without a valid key must be exactly 0 (the plain version's
            # uniform softmax over -1e30 scores is no reference there).
            err = err.masked_fill(~has_key.transpose(1, 2)[..., None], 0.0)
            out_err = max(out_err, float(err.max()))
            empty_rows = ~has_key.transpose(1, 2)
            if bool(empty_rows.any()):
                n_empty += int(empty_rows.sum())
                if float(out[row].float()[empty_rows].abs().max()) != 0.0:
                    raise AssertionError(f"K1 {name}: a row with no valid key is not 0")
                if bool((l[row][~has_key] != 0).any()):
                    raise AssertionError(f"K1 {name}: l is not 0 on a row with no valid key")
                if bool((m[row][~has_key] != fa.NEG_INF).any()):
                    raise AssertionError(f"K1 {name}: m is not NEG_INF on a row with no valid key")
            lse = m[row] + torch.log(l[row])
            lse_err = max(lse_err, float((lse - ref_lse)[has_key].abs().max()))
            del ref, ref_lse, err
        print(f"K1 {name}: out max-abs {out_err:.3e} (<= 2e-2), lse max-abs "
              f"{lse_err:.3e} (<= 1e-2), rows without a key: {n_empty}")
        if not (out_err <= 2e-2 and lse_err <= 1e-2):
            raise AssertionError(f"K1 {name}: kernel disagrees with the plain version")
        worst = max(worst, out_err)
        if timed is not None:
            def kernel():
                fa.flash_attention_fwd(q, k, v, kv_valid, causal, scale)

            kernel_ms = median_ms(kernel)
            device_ms = graph_ms(kernel)   # without the wrapper's host path
            plain_ms = median_ms(lambda: fa.flash_attention_plain(q, k, v, kv_valid, causal, scale))
            # The yardstick: one library call for the same function (never on a
            # served path); padded keys go in as a boolean mask with the causal rule.
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if bool(kv_valid.all()):
                def library():
                    torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
            else:
                keep = (kv_valid[:, None, None, :]
                        & (torch.arange(S, device=dev)[None, :]
                           <= torch.arange(T, device=dev)[:, None])[None, None])

                def library():
                    torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=keep, scale=scale, enable_gqa=True)
            try:
                library_ms = median_ms(library)
                library_device_ms = graph_ms(library)
            except RuntimeError as e:  # no backend takes this mask with GQA
                print(f"K1 {name}: scaled_dot_product_attention failed "
                      f"({str(e).splitlines()[0][:120]}): library time not measured")
                library_ms = library_device_ms = None
            # q, k, v and out once, kv_valid, m and l; 4·Hq·D FLOPs per valid pair.
            n_bytes = (2 * (2 * q.numel() + k.numel() + v.numel()) + kv_valid.numel()
                       + 2 * 4 * B * Hq * T)
            least, by = bound_ms(n_bytes, 4 * Hq * D * flash_pairs(kv_valid, T, causal))
            times[timed] = dict(ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms,
                                library_ms=library_ms, library_device_ms=library_device_ms,
                                bound_ms=least, bound_by=by)
            print(f"K1 {name}: kernel {kernel_ms:.4f} ms per call, {show(device_ms)} on the "
                  f"device; plain (bf16 matmul + f32 softmax) {plain_ms:.4f} ms; "
                  f"scaled_dot_product_attention {show(library_ms)} ms per call, "
                  f"{show(library_device_ms)} on the device; bound {least:.5f} ms by {by}; "
                  f"median of 20")
        del q, k, v, out, m, l
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "times": times, "sass": sass}


def check_flash_bwd(gen) -> dict:
    """K7 (dK, dV) and K8 (dQ) against `flash_attention_bwd_plain` run in f32
    on the same bf16 inputs and K1's m and l, one batch row at a time, in
    K1's first four cases, at the trainer's B=8, T=S=2048 with each row's
    keys right-padded to another length, at B=16, T=S=320 (K7's 128-key
    blocks with a 64-key last tile) and non-causal T=128 S=320 (the last
    three draw from a generator of their own, so later phases see the
    inputs they saw before). Gate per tensor: max-abs error <= 1e-2 of the
    tensor's largest |value| and cosine >= 0.9999; q rows with no valid key
    give dQ = 0 and invalid keys dK = dV = 0, exactly. Fails unless both
    kernels' SASS holds HGMMA and UTMALDG.
    Timed at causal B=1, T=S 256 and 2048 and at the B=8 shape: each kernel
    (CUDA events around one call, and on the device alone from a CUDA-graph
    replay), its plain version, the bound from this run's valid pairs, and
    the backward of `scaled_dot_product_attention` (the padding as a boolean
    mask at B=8; the same two readings)."""
    from vis_zephyr_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    Hq, Hkv, D = 32, 8, 128
    out = {"dkv": {"max_abs_err": 0.0, "times": {}}, "dq": {"max_abs_err": 0.0, "times": {}}}
    for kernel, function in (("dkv", "flash_bwd_dkv_kernel"), ("dq", "flash_bwd_dq_kernel")):
        sass, res = sass_counts(function), resource_usage(function)
        print(f"K7/K8 SASS (cuobjdump -sass, {function}): {sass}; cuobjdump -res-usage: "
              f"{res['reg']} registers at entry, a stack frame of {res['stack']} bytes (spills "
              f"land there), {res['local']} bytes of local memory")
        if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
            raise AssertionError(f"{function} does not run on wgmma fed by TMA: {sass}")
        out[kernel].update(sass=sass, resources=res)
    S_row = torch.arange(256, device=dev)
    padded = torch.stack([S_row < 200, (S_row >= 1) & (S_row < 230)])  # b=1, q row 0: no key
    lengths = torch.tensor([2048, 1900, 1664, 1537, 1280, 1029, 700, 333], device=dev)
    ragged = torch.arange(2048, device=dev)[None, :] < lengths[:, None]
    extra = torch.Generator(dev).manual_seed(gen.initial_seed() + 2)
    cases = [
        # name, B, T, S, causal, kv_valid, generator, timed as
        ("causal T=S=256", 1, 256, 256, True, None, gen, 256),
        ("causal T=S=2048", 1, 2048, 2048, True, None, gen, 2048),
        ("non-causal T=256 S=512", 1, 256, 512, False, None, gen, None),
        ("causal B=2 padded kv_valid", 2, 256, 256, True, padded, gen, None),
        ("causal B=8 T=S=2048 right-padded keys", 8, 2048, 2048, True, ragged, extra, "B8_2048"),
        # K7 on 128-key blocks (a grid as large as the card) with a 64-key
        # last tile, and on split 64-key blocks with S != T.
        ("causal B=16 T=S=320", 16, 320, 320, True, None, extra, None),
        ("non-causal T=128 S=320", 1, 128, 320, False, None, extra, None),
    ]
    for name, B, T, S, causal, kv_valid, g, timed in cases:
        q = torch.randn(B, T, Hq, D, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        do = torch.randn(B, T, Hq, D, generator=g, device=dev).to(torch.bfloat16)
        if kv_valid is None:
            kv_valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        scale = D ** -0.5
        o, m, l = fa.flash_attention_fwd(q, k, v, kv_valid, causal, scale)
        di = fa.row_dot(o, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, kv_valid, do, m, l, di, causal, scale)
        dq = fa.flash_attention_bwd_dq(q, k, v, kv_valid, do, m, l, di, causal, scale)
        torch.cuda.synchronize()
        rows = [fa.flash_attention_bwd_plain(q[b:b + 1].float(), k[b:b + 1].float(),
                                             v[b:b + 1].float(), kv_valid[b:b + 1],
                                             o[b:b + 1].float(), m[b:b + 1], l[b:b + 1],
                                             do[b:b + 1].float(), causal, scale)
                for b in range(B)]
        ref = [torch.cat(parts) for parts in zip(*rows)]
        del rows
        parts = []
        for tname, kernel, got, want in (("dQ", "dq", dq, ref[0]), ("dK", "dkv", dk, ref[1]),
                                         ("dV", "dkv", dv, ref[2])):
            err = float((got.float() - want).abs().max())
            top = float(want.abs().max())
            cos = cosine(got, want)
            parts.append(f"{tname} max-abs {err:.3e} (<= {1e-2 * top:.3e}) cosine {cos:.6f}")
            if not (err <= 1e-2 * top and cos >= 0.9999):
                raise AssertionError(f"K7/K8 {name}: {tname} disagrees with the plain version "
                                     f"(max-abs {err:.3e} of {top:.3e}, cosine {cos:.6f})")
            out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"], err)
        del ref
        empty = ~fa._mask(kv_valid, T, S, causal)[:, 0].any(dim=-1)          # [B, T]
        if bool(empty.any()) and float(dq[empty].abs().max()) != 0.0:
            raise AssertionError(f"K8 {name}: dQ is not 0 on a row with no valid key")
        if bool((~kv_valid).any()) and (float(dk[~kv_valid].abs().max()) != 0.0
                                        or float(dv[~kv_valid].abs().max()) != 0.0):
            raise AssertionError(f"K7 {name}: dK or dV is not 0 on an invalid key")
        print(f"K7/K8 {name}: {'; '.join(parts)}; rows without a key: {int(empty.sum())}, "
              f"invalid keys: {int((~kv_valid).sum())}")
        if timed is not None:
            args = (q, k, v, kv_valid, do, m, l, di, causal, scale)
            readings = {}
            for kernel, launch, plain in (
                    ("dkv", fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_plain),
                    ("dq", fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain)):
                readings[kernel] = dict(ms=median_ms(lambda: launch(*args)),
                                        device_ms=graph_ms(lambda: launch(*args)),
                                        plain_ms=median_ms(lambda: plain(*args)))
            # The yardstick (never on the port's path): the library's fused
            # attention backward alone, its forward taken once outside the
            # timing; padded keys go in as a boolean mask with the causal rule.
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            if bool(kv_valid.all()):
                sdpa = dict(is_causal=True)
            else:
                sdpa = dict(attn_mask=kv_valid[:, None, None, :]
                            & (torch.arange(S, device=dev)[None, :]
                               <= torch.arange(T, device=dev)[:, None])[None, None])
            try:
                o_lib = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, scale=scale, enable_gqa=True, **sdpa)
                g_lib = do.transpose(1, 2)

                def library():
                    torch.autograd.grad(o_lib, (qt, kt, vt), g_lib, retain_graph=True)

                library_ms = median_ms(library)
                library_device_ms = graph_ms(library)
                del o_lib
            except RuntimeError as e:  # no backend takes this mask with GQA
                print(f"K7/K8 {name}: scaled_dot_product_attention backward failed "
                      f"({str(e).splitlines()[0][:120]}): library time not measured")
                library_ms = library_device_ms = None
            # Each product is 2·Hq·D FLOPs per valid (row, key) pair: K7 does
            # four (S, dP, dV, dK), K8 three (S, dP, dQ). Bytes: every input
            # read once, every output written once.
            pair_flops = 2 * Hq * D * flash_pairs(kv_valid, T, causal)
            rows_bytes = 4 * 3 * B * Hq * T + kv_valid.numel()  # m, l, di in f32
            bounds = {"dkv": bound_ms(2 * (q.numel() + do.numel() + 2 * k.numel() + 2 * v.numel())
                                      + rows_bytes, 4 * pair_flops),
                      "dq": bound_ms(2 * (2 * q.numel() + do.numel() + k.numel() + v.numel())
                                     + rows_bytes, 3 * pair_flops)}
            for kernel, (least, by) in bounds.items():
                out[kernel]["times"][timed] = dict(
                    **readings[kernel], library_ms=library_ms,
                    library_device_ms=library_device_ms, bound_ms=least, bound_by=by)
            r7, r8 = readings["dkv"], readings["dq"]
            print(f"K7/K8 {name}: K7 {r7['ms']:.4f} ms per call, {show(r7['device_ms'])} on the "
                  f"device, plain {r7['plain_ms']:.4f} ms, bound {bounds['dkv'][0]:.5f} ms by "
                  f"{bounds['dkv'][1]}; K8 {r8['ms']:.4f} ms per call, {show(r8['device_ms'])} on "
                  f"the device, plain {r8['plain_ms']:.4f} ms, bound {bounds['dq'][0]:.5f} ms by "
                  f"{bounds['dq'][1]}; scaled_dot_product_attention backward (dQ, dK, dV "
                  f"together) {show(library_ms)} ms per call, {show(library_device_ms)} on the "
                  f"device; median of 20")
            del qt, kt, vt
        del q, k, v, do, o, m, l, di, dq, dk, dv
        torch.cuda.empty_cache()
    return out


def check_cache_append(gen) -> dict:
    """K2's two entries against their plain versions, bit for bit:
    `dense_cache_update` (rows already rotated, the JAX contract) and
    `dense_cache_update_rope` (K before RoPE, rotated in the kernel: what
    the dense-cache forward calls once a layer), at the dense decode step's
    shape, a clamped tail and chunked admission's T = 256 chunks. Timed at
    the decode shape (and the rope entry at a chunk): per call, on the
    device (graph replay), issued back to back; beside it the route the
    forward took before, eager `apply_rope` then the copy entry."""
    from vis_zephyr_tpu_torch.config import DecoderConfig
    from vis_zephyr_tpu_torch.models.mistral import rope_cos_sin
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import kv_cache

    dev = "cuda"
    dec = DecoderConfig()
    Hkv, D = dec.num_kv_heads, dec.head_dim
    # The dense decode step's shape, a clamped tail, and chunked admission's
    # shapes (one 256-token chunk into a B=1 scratch cache): the third chunk of
    # a longer prompt, and a last chunk that ends exactly at the cache's end.
    # The dense batcher's shapes: its decode step at 8 and 32 slots, its
    # verify step (S = 5) at 8, slots of mixed lengths (one inactive, at 0).
    lens8 = [0, 17, 300, 517, 901, 1200, 1655, 2040]
    cases = [("L=32 B=1 S=2048 T=1", 32, 1, 2048, 1, [517], "decode"),
             ("L=32 B=3 S=2048 T=4, one length at S-2", 32, 3, 2048, 4, [0, 1000, 2046], None),
             ("L=32 B=1 S=1024 T=256 at 512 (a prefill chunk)", 32, 1, 1024, 256, [512],
              "chunk_256"),
             ("L=32 B=1 S=768 T=256 at 512 (the chunk that fills the cache)", 32, 1, 768, 256,
              [512], None),
             ("L=32 B=1 S=768 T=256 at 640 (128 rows clamped to S-1)", 32, 1, 768, 256, [640],
              None),
             ("L=32 B=8 S=2048 T=1 (the dense batcher's step)", 32, 8, 2048, 1, lens8,
              "batch_8"),
             ("L=32 B=32 S=2048 T=1", 32, 32, 2048, 1, lens8 * 4, "batch_32"),
             ("L=32 B=8 S=2048 T=5 (its verify step, three rows clamped to S-1)", 32, 8, 2048,
              5, lens8[:-1] + [2046], "verify_8_s5")]
    times = None
    for name, L, B, S, T, lens, timed in cases:
        ck = torch.randn(L, B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        cv = torch.randn(L, B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        positions = lengths[:, None] + torch.arange(T, dtype=torch.int32, device=dev)[None, :]
        cos, sin = rope_cos_sin(positions, D, dec.rope_theta)
        layer = L - 3
        for entry in ("copy", "rope"):
            got_k, got_v = ck.clone(), cv.clone()
            ref_k, ref_v = ck.clone(), cv.clone()
            if entry == "copy":
                kv_cache.dense_cache_update(got_k, got_v, k, v, lengths, layer)
                kv_cache.dense_cache_update_plain(ref_k, ref_v, k, v, lengths, layer)
            else:
                kv_cache.dense_cache_update_rope(got_k, got_v, k, v, cos, sin, lengths, layer)
                kv_cache.dense_cache_update_rope_plain(ref_k, ref_v, k, v, cos, sin, lengths,
                                                       layer)
            torch.cuda.synchronize()
            exact = torch.equal(got_k, ref_k) and torch.equal(got_v, ref_v)
            changed = int((got_k[layer] != ck[layer]).any(dim=-1).any(dim=-1).sum())
            print(f"K2 {entry} entry, {name}: bit-exact against the plain version: {exact} "
                  f"({changed} cache rows changed)")
            if not exact or changed == 0:
                raise AssertionError(f"K2 {entry} entry, {name}: kernel disagrees with the "
                                     "plain version")
        if timed is None:
            continue
        # The rows read once and written once (and the rope entry's cos / sin
        # tables read once); its arithmetic is a few operations an element.
        n_rows = B * T
        copy_bound = bound_ms(2 * 2 * (k.numel() + v.numel()), 0)
        rope_bound = bound_ms(2 * 2 * (k.numel() + v.numel()) + 2 * 4 * n_rows * D // 2,
                              6 * k.numel(), FP32_FLOPS)

        def copy_call():
            kv_cache.dense_cache_update(got_k, got_v, k, v, lengths, layer)

        def rope_call():
            kv_cache.dense_cache_update_rope(got_k, got_v, k, v, cos, sin, lengths, layer)

        def before_call():  # the dense-cache forward's route before the rope entry
            kv_cache.dense_cache_update(got_k, got_v, kv_cache.apply_rope(k, cos, sin), v,
                                        lengths, layer)

        rows = torch.arange(B, device=dev)[:, None]
        slots = torch.clamp(positions.long(), max=S - 1)
        k_rot = kv_cache.apply_rope(k, cos, sin)

        def library_call():  # the write half only: the rotated rows by index_put_
            ref_k[layer].index_put_((rows, slots), k_rot)
            ref_v[layer].index_put_((rows, slots), v)

        row = {}
        for label, fn in (("rope", rope_call), ("copy", copy_call), ("before", before_call),
                          ("library", library_call)):
            row[label] = dict(ms=median_ms(fn), device_ms=graph_ms(fn), issue_ms=issue_ms(fn))
        with _kernels.plain_versions():
            plain_ms = median_ms(rope_call)
            copy_plain_ms = median_ms(copy_call)
        print(f"K2 rope entry, {name}: kernel {row['rope']['ms']:.4f} ms per call, "
              f"{show(row['rope']['device_ms'])} on the device, issued back to back "
              f"{row['rope']['issue_ms']:.4f}; plain (apply_rope, casts, {T} indexed writes) "
              f"{plain_ms:.4f} ms; bound {rope_bound[0]:.6f} ms by {rope_bound[1]}; before "
              f"(eager apply_rope + the copy entry) {row['before']['ms']:.4f} per call, "
              f"{show(row['before']['device_ms'])} on the device, issued "
              f"{row['before']['issue_ms']:.4f}; index_put_ of the rotated rows "
              f"{row['library']['ms']:.4f}, {show(row['library']['device_ms'])} on the device; "
              f"median of 20")
        print(f"K2 copy entry, {name}: kernel {row['copy']['ms']:.4f} ms per call, "
              f"{show(row['copy']['device_ms'])} on the device, issued "
              f"{row['copy']['issue_ms']:.4f}; plain ({T} indexed writes) {copy_plain_ms:.4f} "
              f"ms; bound {copy_bound[0]:.6f} ms by {copy_bound[1]}")
        if timed == "decode":  # the decode step's shape goes into the result line
            times = dict(ms=row["rope"]["ms"], device_ms=row["rope"]["device_ms"],
                         issue_ms=row["rope"]["issue_ms"], plain_ms=plain_ms,
                         library_ms=row["library"]["ms"],
                         library_device_ms=row["library"]["device_ms"],
                         bound_ms=rope_bound[0], bound_by=rope_bound[1],
                         before=row["before"], copy_entry=dict(row["copy"], plain_ms=copy_plain_ms,
                                                                bound_ms=copy_bound[0]))
        else:
            times[timed] = dict(row["rope"], plain_ms=plain_ms, bound_ms=rope_bound[0],
                                bound_by=rope_bound[1], before=row["before"],
                                library=row["library"])
    return {"max_abs_err": 0.0, "times": times}


def paged_case(gen, lengths, quant: bool, fused: bool, layers: int = 2):
    """Pools of `layers` layers in the port's layout with a shuffled page table
    [B, 16]: every slot owns 16 pages of its own; page 0 is the trash page."""
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    Hkv, D, ps, pps = 8, 128, 128, 16
    B = len(lengths)
    P = B * pps + 1
    table = (torch.randperm(P - 1, generator=gen, device=dev)[:B * pps] + 1).reshape(B, pps)
    shape = (layers * P, Hkv, ps, D)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    ksc = vsc = None
    if quant:
        kp, ksc = pa.quantize_kv_pool(kp)
        vp, vsc = pa.quantize_kv_pool(vp)
    if fused:
        kp, vp = torch.cat([kp, vp], dim=2), None
        if quant:
            ksc, vsc = torch.cat([ksc, vsc], dim=2), None
    return dict(kp=kp, vp=vp, ksc=ksc, vsc=vsc, table=table.to(torch.int32).contiguous(),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev), P=P)


def paged_call(pa, case, q, selfterm, k_new, v_new, window=None, plain=False, **over):
    from vis_zephyr_tpu_torch.ops import _kernels

    if plain:
        with _kernels.plain_versions():
            return paged_call(pa, case, q, selfterm, k_new, v_new, window, **over)
    S = q.shape[1]
    lengths = case["lengths"]
    q_offs = lengths if selfterm else (lengths - S).contiguous()
    c = dict(case, **over)
    return pa.paged_attention_fa(
        q, c["kp"], c["vp"], c["table"], lengths, q_offs, sliding_window=window,
        k_scales=c["ksc"], v_scales=c["vsc"], k_new=k_new if selfterm else None,
        v_new=v_new if selfterm else None, page_offset=case["P"])


# K3's SASS: tensor-core products (HMMA: mma.sync), the pages by TMA
# (UTMALDG) and the scales by bulk copy (UBLKCP).
K3_SASS_OPS = ("HMMA", "UTMALDG", "UBLKCP")


def check_paged_attention(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    sass = sass_counts("paged_attn_decode", K3_SASS_OPS)
    resources = resource_usage("paged_attn_decode")
    print(f"K3 SASS (paged_attn_decode, every instantiation): {sass}; registers and stack "
          f"(spills) of the largest: {resources}")
    if not all(sass[op] for op in K3_SASS_OPS):
        raise AssertionError(f"K3's SASS lacks tensor-core or bulk-copy instructions: {sass}")
    dev = "cuda"
    Hq, Hkv, D, ps, B = 32, 8, 128, 128, 32
    edge = [0, 1, 128, 129, 2048, 2047, 127, 1025]
    rand = torch.randint(1, 2049, (B - len(edge),), generator=gen, device=dev).tolist()
    lengths = edge + rand
    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    worst = 0.0

    def slot_err(a, b):  # max-abs difference per slot, [B]
        return (a.float() - b.float()).abs().flatten(1).amax(dim=1)

    def compare(name, case, qq, selfterm, window=None, new=None):
        # A slot of 2048 keys has outputs near 0.05 and a slot of one key near
        # 3, so one max-abs over all slots would gate the long slots at half a
        # typical value. Each slot is held to its own scale instead: max-abs
        # error over the slot's largest |plain| value (a bf16 ulp is at most
        # 0.78 % of a value).
        nonlocal worst
        kn, vn = new or (k_new, v_new)
        got = paged_call(pa, case, qq, selfterm, kn, vn, window)
        torch.cuda.synchronize()
        want = paged_call(pa, case, qq, selfterm, kn, vn, window, plain=True)
        err = slot_err(got, want)
        top = want.float().abs().flatten(1).amax(dim=1)
        rel = torch.where(top > 0, err / top.clamp_min(1e-30), err)
        long_slots = case["lengths"] >= 1000
        long_rel = f"{float(rel[long_slots].max()):.3e}" if bool(long_slots.any()) else "none"
        print(f"K3 {name}: out max-abs {float(err.max()):.3e}; per slot, relative to the slot's "
              f"largest value: max {float(rel.max()):.3e} (<= 1e-2), over slots of >= 1000 keys "
              f"{long_rel}")
        if not (float(rel.max()) <= 1e-2 and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"K3 {name}: kernel disagrees with the plain version")
        worst = max(worst, float(err.max()))
        return got

    for quant, fused, label in ((False, False, "bf16 split"), (True, False, "int8 split"),
                                (True, True, "int8 fused")):
        case = paged_case(gen, lengths, quant, fused)
        for selfterm in (False, True):
            got = compare(f"{label}, {'self-term' if selfterm else 'pool only'}", case, q, selfterm)
            if not selfterm and float(got[0].float().abs().max()) != 0.0:
                raise AssertionError(f"K3 {label}: the slot with no key is not exactly 0")
        if not quant:
            # Whatever a recycled page holds at or past `length` must not reach
            # the output: NaN there, the same result bit for bit.
            clean = paged_call(pa, case, q, True, k_new, v_new)
            kd, vd = case["kp"].clone(), case["vp"].clone()
            for b, n in enumerate(lengths):
                if n < 2048:
                    page = int(case["table"][b, n // ps]) + case["P"]
                    kd[page, :, n % ps:] = float("nan")
                    vd[page, :, n % ps:] = float("nan")
            dirty = paged_call(pa, case, q, True, k_new, v_new, kp=kd, vp=vd)
            torch.cuda.synchronize()
            same = torch.equal(clean, dirty)
            print(f"K3 {label}: NaN rows past length leave the output unchanged: {same}")
            if not same:
                raise AssertionError("K3: rows past length reached the output")
    got = compare("int8 fused, self-term, window 512", case, q, True, window=512)
    # The window's edge: on the slots it cuts (query at `length`: 512 keys or more
    # in the pool), the kernel at 512 must sit nearer the plain
    # version at 512 than the plain version at 511 or 513, and differ from its
    # own unwindowed output.
    cut = case["lengths"] >= 512
    near = float(slot_err(got, paged_call(pa, case, q, True, k_new, v_new, 512, plain=True))[cut].sum())
    off = [float(slot_err(got, paged_call(pa, case, q, True, k_new, v_new, w, plain=True))[cut].sum())
           for w in (511, 513)]
    unwindowed = paged_call(pa, case, q, True, k_new, v_new)
    differs = bool((slot_err(got, unwindowed)[cut] > 0).all())
    same_short = torch.equal(got[~cut], unwindowed[~cut])
    print(f"K3 window 512 over the {int(cut.sum())} slots it cuts: summed max-abs against the "
          f"plain version at 512 {near:.3e}, at 511 {off[0]:.3e}, at 513 {off[1]:.3e}; differs "
          f"from the unwindowed output on every such slot: {differs}; equal on the others: "
          f"{same_short}")
    if not (near < min(off) and differs and same_short):
        raise AssertionError("K3: the sliding window's edge is off")
    q2 = torch.randn(B, 2, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    two = dict(case, lengths=torch.clamp(case["lengths"], min=2))
    compare("int8 fused, two query rows per slot (S=2), pool only", two, q2, False)

    # The split plan's cases (int8 fused pools): one slot (as many splits as
    # the table has pages), 128 slots of 640 tokens (no split), slots with
    # fewer pages than splits, a window whose edge cuts a page in the middle
    # of the splits' shares, and at S = 9 (two row tiles, eight splits) a
    # window whose first page for the tile's later rows is a middle split's.
    def rows(n, S=1):
        return torch.randn(n, S, Hq, D, generator=gen, device=dev).to(torch.bfloat16)

    def news(n):
        return tuple(torch.randn(n, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(2))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = {}
    for label, lens, S, selfterm, window in (
            ("one slot of 2048", [2048], 1, True, None),
            ("one slot of 200 (2 pages)", [200], 1, True, None),
            ("one slot of 2048, window 1000", [2048], 1, True, 1000),
            ("128 slots of 640", [640] * 128, 1, True, None),
            ("4 slots of 60, 130, 300, 2048", [60, 130, 300, 2048], 1, True, None),
            ("2 slots of 2048, 1500 at S=9, window 764", [2048, 1500], 9, False, 764)):
        c = paged_case(gen, lens, True, True)
        n = len(lens)
        plan = pa.split_plan(n, Hkv, S * Hq // Hkv, 16, sms)
        splits[label] = plan.splits
        compare(f"int8 fused, {label} ({plan.tiles} row tile(s), {plan.splits} split(s))", c,
                rows(n, S), selfterm, window, news(n))
    if not (splits["one slot of 2048"] == 16 and splits["128 slots of 640"] == 1
            and splits["2 slots of 2048, 1500 at S=9, window 764"] > 2):
        raise AssertionError(f"K3's split plan changed: {splits}")
    # The splits' merge repeats bit for bit (no float atomics).
    one = paged_case(gen, [2048, 1300, 70, 700], True, True)
    q4, new4 = rows(4), news(4)
    first = paged_call(pa, one, q4, True, *new4)
    again = paged_call(pa, one, q4, True, *new4)
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    print(f"K3 4 slots in {pa.split_plan(4, Hkv, Hq // Hkv, 16, sms).splits} splits: two calls "
          f"equal bit for bit: {same}")
    if not same:
        raise AssertionError("K3: two calls at a split shape differ")

    # Times at lengths like the served path's (prompts of 60 to 800 tokens), int8
    # fused pools with the self-term: what every layer of a decode step calls.
    served = torch.randint(60, 801, (B,), generator=gen, device=dev).tolist()
    case = paged_case(gen, served, True, True)
    ms = median_ms(lambda: paged_call(pa, case, q, True, k_new, v_new))
    device_ms = graph_ms(lambda: paged_call(pa, case, q, True, k_new, v_new))
    plain_ms = median_ms(lambda: paged_call(pa, case, q, True, k_new, v_new, plain=True))
    tokens = sum(served)
    # Each valid K and V row read once with its scale; q, the self-term, the
    # table and the lengths read once; the output written once. 4·Hq·D flops
    # per key (q·k and p·v), counting this run's lengths.
    n_bytes = (tokens * Hkv * 2 * (D + 4) + 2 * 2 * q.numel() + 2 * 2 * k_new.numel()
               + 4 * case["table"].numel() + 8 * B)
    least, by = bound_ms(n_bytes, 4 * Hq * D * (tokens + B))
    print(f"K3 B={B}, {tokens} tokens in the pools (60 to 800 per slot), int8 fused, self-term: "
          f"kernel {ms:.4f} ms per call, {show(device_ms)} on the device; plain (gather + f32 "
          f"matmuls) {plain_ms:.4f} ms; bound {least:.5f} ms by {by} ({n_bytes / 1e6:.2f} MB), "
          f"median of 20")
    full = paged_case(gen, [2048] * B, True, True)
    full_ms = median_ms(lambda: paged_call(pa, full, q, True, k_new, v_new))
    full_device_ms = graph_ms(lambda: paged_call(pa, full, q, True, k_new, v_new))
    full_bytes = B * 2048 * Hkv * 2 * (D + 4)
    print(f"K3 B={B}, every slot at 2048 tokens: kernel {full_ms:.4f} ms per call, "
          f"{show(full_device_ms)} on the device; bound {bound_ms(full_bytes, 0)[0]:.5f} ms by "
          f"bytes ({full_bytes / 1e6:.1f} MB)")
    return {"max_abs_err": worst, "sass": sass, "resources": resources,
            "times": dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=least, bound_by=by),
            "at_2048": dict(ms=full_ms, device_ms=full_device_ms,
                            bound_ms=bound_ms(full_bytes, 0)[0])}


# K3 without the self-term at S query rows per slot (the verify step's shape,
# S = lookahead + 1): 1 to 8, and 9 (36 rows per kv head: two tiles of 32).
VERIFY_ROWS = (1, 2, 3, 4, 5, 6, 7, 8, 9)


def check_paged_attention_rows(gen) -> dict:
    """K3 with S rows already in the pool (`q_offs = lengths - S`, no
    self-term) over int8 fused pools, 32 slots of 60 to 800 tokens, against
    its plain version per slot; times and bound per S. Then bf16 split pools
    at S = 5 with a window of 512, and one S = 5 case whose slots hold only
    their own rows."""
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    Hq, Hkv, D, B = 32, 8, 128, 32
    served = torch.randint(60, 801, (B,), generator=gen, device=dev).tolist()
    case = paged_case(gen, served, True, True)
    tokens = sum(served)
    worst, by_rows = 0.0, []

    def compare(name, c, q, window=None):
        got = paged_call(pa, c, q, False, None, None, window)
        torch.cuda.synchronize()
        want = paged_call(pa, c, q, False, None, None, window, plain=True)
        err = (got.float() - want.float()).abs().flatten(1).amax(dim=1)
        top = want.float().abs().flatten(1).amax(dim=1)
        rel = float(torch.where(top > 0, err / top.clamp_min(1e-30), err).max())
        if not (rel <= 1e-2 and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"K3 {name}: kernel disagrees with the plain version "
                                 f"(per-slot relative max-abs {rel:.3e})")
        return float(err.max()), rel

    for S in VERIFY_ROWS:
        q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
        err, rel = compare(f"S={S}", case, q)
        worst = max(worst, err)
        ms = median_ms(lambda: paged_call(pa, case, q, False, None, None))
        device_ms = graph_ms(lambda: paged_call(pa, case, q, False, None, None))
        plain_ms = median_ms(lambda: paged_call(pa, case, q, False, None, None, plain=True), 10)
        # Each valid K and V row read once with its scale, q and the output
        # once, the table and lengths; 4·Hq·D flops per (query row, key) pair
        # that the causal mask keeps (row j of a slot sees length − S + j + 1 keys).
        pairs = sum(S * (n - S) + S * (S + 1) // 2 for n in served)
        n_bytes = (tokens * Hkv * 2 * (D + 4) + 2 * 2 * q.numel() + 4 * case["table"].numel()
                   + 8 * B)
        least, by = bound_ms(n_bytes, 4 * Hq * D * pairs)
        rows = S * Hq // Hkv
        plan = pa.split_plan(B, Hkv, rows, 16, torch.cuda.get_device_properties(0)
                             .multi_processor_count)
        by_rows.append(dict(S=S, rows_per_kv_head=rows, tiles=plan.tiles, splits=plan.splits,
                            max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                            bound_ms=least, bound_by=by))
        print(f"K3 pool only, S={S} ({rows} query rows per kv head, {plan.tiles} tile(s) of "
              f"{plan.tile_rows}, {plan.splits} split(s)), B={B}, {tokens} tokens, int8 fused: "
              f"max-abs {err:.3e}, per slot relative {rel:.3e} (<= 1e-2); kernel {ms:.4f} ms per "
              f"call, {show(device_ms)} on the device; plain {plain_ms:.4f} ms; bound "
              f"{least:.5f} ms by {by}, median of 20")
    q5 = torch.randn(B, 5, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    wide = paged_case(gen, served, False, False)
    err, rel = compare("bf16 split, S=5, window 512", wide, q5, window=512)
    worst = max(worst, err)
    own = paged_case(gen, [5] * B, True, True)  # the rows are the slot's only keys
    err2, rel2 = compare("int8 fused, S=5, lengths 5", own, q5)
    worst = max(worst, err2)
    print(f"K3 pool only, S=5: bf16 split pools with a window of 512 max-abs {err:.3e} (per slot "
          f"relative {rel:.3e}); slots holding only their 5 rows max-abs {err2:.3e} ({rel2:.3e})")
    return {"max_abs_err": worst, "by_rows": by_rows}


def check_paged_single(gen) -> dict:
    """K3 on rows 7 and 8's contracts. Row 7: the single-row entry
    `paged_attention` (`lengths` tokens in the pool; with the self-term the
    query sits at `lengths`, without it at `lengths - 1`) over bf16 and int8
    split pools, each with and without the self-term and with a window of
    512, at B=32 and the edge lengths of `check_paged_attention`. Row 8:
    `paged_attention_fa(fold_heads=False)` over bf16 and int8 split pools at
    S = 1 and 5, and its refusal of fused pools. Each held against its plain
    version per slot (max-abs error <= 1e-2 of the slot's largest value);
    then times at served lengths (60 to 800 tokens), int8 split pools."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    Hq, Hkv, D, B = 32, 8, 128, 32
    edge = [0, 1, 128, 129, 2048, 2047, 127, 1025]
    lengths = edge + torch.randint(1, 2049, (B - len(edge),), generator=gen, device=dev).tolist()
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    worst = 0.0

    def single(case, selfterm, window=None):
        new = dict(k_new=k_new, v_new=v_new) if selfterm else {}
        return pa.paged_attention(q, case["kp"], case["vp"], case["table"], case["lengths"],
                                  sliding_window=window, k_scales=case["ksc"],
                                  v_scales=case["vsc"], page_offset=case["P"], **new)

    def unfolded(case, qq):
        S = qq.shape[1]
        return pa.paged_attention_fa(qq, case["kp"], case["vp"], case["table"], case["lengths"],
                                     (case["lengths"] - S).contiguous(), k_scales=case["ksc"],
                                     v_scales=case["vsc"], page_offset=case["P"],
                                     fold_heads=False)

    def compare(name, fn):
        # Each slot held to its own largest value, as in check_paged_attention.
        nonlocal worst
        got = fn()
        torch.cuda.synchronize()
        with _kernels.plain_versions():
            want = fn()
        err = (got.float() - want.float()).abs().flatten(1).amax(dim=1)
        top = want.float().abs().flatten(1).amax(dim=1)
        rel = float(torch.where(top > 0, err / top.clamp_min(1e-30), err).max())
        print(f"K3 {name}: out max-abs {float(err.max()):.3e}, per slot relative {rel:.3e} "
              f"(<= 1e-2)")
        if not (rel <= 1e-2 and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"K3 {name}: kernel disagrees with the plain version")
        worst = max(worst, float(err.max()))
        return got

    launched = pa.attn_launches
    for quant, label in ((False, "bf16 split"), (True, "int8 split")):
        case = paged_case(gen, lengths, quant, False)
        for selfterm in (False, True):
            for window in (None, 512):
                what = (f"row 7 paged_attention, {label}, "
                        f"{'self-term' if selfterm else 'token in the pool'}"
                        f"{', window 512' if window else ''}")
                got = compare(what, lambda: single(case, selfterm, window))
                if not selfterm and float(got[0].float().abs().max()) != 0.0:
                    raise AssertionError(f"K3 {what}: the slot with no key is not exactly 0")
        for S in (1, 5):
            rows = dict(case, lengths=torch.clamp(case["lengths"], min=S))
            qS = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
            compare(f"row 8 paged_attention_fa(fold_heads=False), {label}, S={S}",
                    lambda: unfolded(rows, qS))
    fused = paged_case(gen, [5] * B, True, True)
    try:
        unfolded(fused, q[:, None])
    except ValueError as e:
        print(f"K3 row 8 over fused pools refused: {e}")
    else:
        raise AssertionError("K3 row 8: fused pools with fold_heads=False were not refused")
    print(f"K3 rows 7 and 8: {pa.attn_launches - launched} kernel launches in the checks")

    # Times at served lengths, int8 split pools: what the writefirst step's
    # layers call (row 7, the token in the pool), row 7 with the self-term
    # (the TPU's `_make_kernel` case), and row 8 at S = 1 and 5.
    served = torch.randint(60, 801, (B,), generator=gen, device=dev).tolist()
    case = paged_case(gen, served, True, False)
    tokens = sum(served)
    q5 = torch.randn(B, 5, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    times = {}
    for key, fn, S, selfterm in (
            ("row 7, token in the pool", lambda: single(case, False), 1, False),
            ("row 7, self-term", lambda: single(case, True), 1, True),
            ("row 8, S=1", lambda: unfolded(case, q[:, None]), 1, False),
            ("row 8, S=5", lambda: unfolded(case, q5), 5, False)):
        ms, device_ms = median_ms(fn), graph_ms(fn)
        with _kernels.plain_versions():
            plain_ms = median_ms(fn, 10)
        # Each valid K and V row read once with its scale, q, the self-term,
        # the table and lengths read once, the output written once; 4·Hq·D
        # flops per (query row, key) pair the causal mask keeps.
        pairs = sum(S * (n - S) + S * (S + 1) // 2 for n in served) + (B if selfterm else 0)
        n_bytes = (tokens * Hkv * 2 * (D + 4) + 2 * 2 * B * S * Hq * D
                   + (2 * 2 * k_new.numel() if selfterm else 0)
                   + 4 * case["table"].numel() + 8 * B)
        least, by = bound_ms(n_bytes, 4 * Hq * D * pairs)
        times[key] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=least, bound_by=by)
        print(f"K3 {key}, B={B}, {tokens} tokens (60 to 800 per slot), int8 split: kernel "
              f"{ms:.4f} ms per call, {show(device_ms)} on the device; plain {plain_ms:.4f} ms; "
              f"bound {least:.5f} ms by {by}; median of 20")
    return {"max_abs_err": worst, "times": times}


def verify_targets(table, lengths, active, S: int, ps: int):
    """Within-layer page ids and offsets [S, B] of a verify step's rows, as
    `_paged_verify_step` computes them: rows past the table forced onto the
    trash page 0, inactive slots there at rows 0..S-1."""
    pps = table.shape[1]
    lengths_eff = torch.where(active, lengths, torch.zeros_like(lengths))
    pos = lengths_eff[:, None] + torch.arange(S, dtype=lengths.dtype, device=lengths.device)
    row_idx = pos // ps
    pages = torch.gather(table, 1, torch.clamp(row_idx, max=pps - 1).long())
    pages = torch.where(active[:, None] & (row_idx < pps), pages, torch.zeros_like(pages))
    return pages.T.contiguous(), (pos % ps).T.contiguous()


def kv_pools(gen, shape, quant: bool, fused: bool):
    """Random pools (and scales) of `shape` [N, Hkv, rows, D]: int8 or bf16,
    KV-fused (v None) or split."""
    dev = "cuda"
    if quant:
        kp = torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        vp = None if fused else torch.randint(-128, 128, shape, generator=gen, device=dev,
                                               dtype=torch.int8)
        ksc = torch.rand(shape[:3], generator=gen, device=dev)
        vsc = None if fused else torch.rand(shape[:3], generator=gen, device=dev)
        return kp, vp, ksc, vsc
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = None if fused else torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return kp, vp, None, None


POOL_FORMS = ((False, False, "bf16 split"), (False, True, "bf16 fused"),
              (True, False, "int8 split"), (True, True, "int8 fused"))


def check_paged_update(gen) -> dict:
    """K4's absolute-page entry against its plain version, whole pools and
    scales bit for bit, page 0 included (rows that meet on one pool row leave
    the last in (s, b) order, in the kernel and in the plain version), over
    bf16 and int8, split and fused pools:
    - `paged_kv_update_layer{,_q}`, the verify and writefirst steps' form:
      32 slots, S = 1 to 9 rows a slot as projected ([B, S, Hkv, D]), page
      ids and offsets from a page table as the verify step computes them
      (rows of one slot sharing a page and crossing into the next, slots
      whose last rows are forced onto the trash page, inactive slots), layer
      1 of 2; a strided view of a wider block (the writefirst step's
      `k[:, :1]`, and S = 5 of 7 columns);
    - `paged_kv_update{,_q}`, the JAX contract: L = 1 and 2, absolute ids.
    Timed at the verify step's form (int8 fused, B = 32, S = 5): per call,
    on the device, issued back to back; plain, bound, one `index_put_` of
    the quantized rows, and the route the verify step took before (S
    single-row calls a layer, each with its index add and two copies)."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    B, Hkv, D, ps, pps, L = 32, 8, 128, 128, 4, 2
    P = 1 + B * pps
    layer = 1
    table = (torch.randperm(P - 1, generator=gen, device=dev)[:B * pps] + 1).reshape(B, pps)
    table = table.to(torch.int32).contiguous()
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[[2, 9, 21, 30]] = False
    lengths = torch.randint(0, pps * ps - 9, (B,), generator=gen, device=dev)
    # Slots ending past the table (forced rows), starting at a page's last row,
    # and at a page's first.
    lengths[[0, 5, 11]] = torch.tensor([pps * ps - 1, pps * ps - 3, pps * ps - 6], device=dev)
    lengths[[7, 8]] = torch.tensor([ps - 1, 2 * ps], device=dev)
    lengths = lengths.to(torch.int32)

    def write(form, pools, k, v, pages, offsets, base=0):
        kp, vp, ksc, vsc = pools
        if form == "layer":
            if ksc is None:
                pa.paged_kv_update_layer(kp, vp, k, v, pages, offsets, base)
            else:
                pa.paged_kv_update_layer_q(kp, vp, ksc, vsc, k, v, pages, offsets, base)
        elif ksc is None:
            pa.paged_kv_update(kp, vp, k, v, pages, offsets)
        else:
            pa.paged_kv_update_q(kp, vp, ksc, vsc, k, v, pages, offsets)

    def compare(label, form, pools, k, v, pages, offsets, base=0):
        got = [None if t is None else t.clone() for t in pools]
        ref = [None if t is None else t.clone() for t in pools]
        write(form, got, k, v, pages, offsets, base)
        with _kernels.plain_versions():
            write(form, ref, k, v, pages, offsets, base)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, r) for g, r in zip(got, ref) if g is not None)
        changed = int((got[0] != pools[0]).any(dim=-1).sum())
        trash = int((got[0][base] != pools[0][base]).any(dim=-1).sum())
        print(f"K4 {label}: whole pools and scales bit-exact against the plain version, page 0 "
              f"included: {exact} ({changed} rows of the first pool changed, {trash} of them "
              f"on the trash page)")
        if not exact or changed == 0:
            raise AssertionError(f"K4 {label}: kernel disagrees with the plain version")
        return got, ref

    times = None
    shape = (L * P, Hkv, ps, D)
    for quant, fused, label in POOL_FORMS:
        pools = kv_pools(gen, (shape[0], Hkv, 2 * ps if fused else ps, D), quant, fused)
        for S in VERIFY_ROWS:
            pages, offsets = verify_targets(table, lengths, active, S, ps)
            k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            got, ref = compare(f"paged_kv_update_layer, {label}, S={S}", "layer", pools, k, v,
                               pages, offsets, layer * P)
            if quant and fused and S == 5:  # the verify step's form
                times = time_verify_write(pa, _kernels, got, ref, k, v, pages, offsets,
                                          layer * P)
        for S, width in ((1, 4), (5, 7)):  # strided views of a wider block
            pages, offsets = verify_targets(table, lengths, active, S, ps)
            block = torch.randn(B, width, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            compare(f"paged_kv_update_layer, {label}, S={S} strided (columns of {width})",
                    "layer", pools, block[:, :S], block[:, width - S:], pages, offsets, layer * P)
        # The JAX contract: rows [L, B] at absolute ids, offsets [B].
        offs = torch.where(active, torch.randint(0, ps, (B,), generator=gen, device=dev), 0)
        offs = offs.to(torch.int32)
        for n_layers in (1, 2):
            ids = (torch.randperm(shape[0] - 1, generator=gen, device=dev)[:n_layers * B]
                   + 1).reshape(n_layers, B)
            page_ids = torch.where(active[None], ids, 0).to(torch.int32).contiguous()
            k = torch.randn(n_layers, B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn(n_layers, B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            compare(f"paged_kv_update L={n_layers}, {label}", "update", pools, k, v, page_ids,
                    offs)
        del pools
    return {"max_abs_err": 0.0, "times": times}


def time_verify_write(pa, _kernels, got, ref, k, v, pages, offsets, base) -> dict:
    """The verify step's K4 call (int8 fused, one layer) timed, beside its
    plain version, one `index_put_` of the quantized rows and the old route."""
    B, S, Hkv, D = k.shape
    dev = k.device
    ps = got[0].shape[2] // 2

    def call():
        pa.paged_kv_update_layer_q(got[0], None, got[2], None, k, v, pages, offsets, base)

    def before_call():  # S single-row calls, each with an index add and two copies
        for s in range(S):
            page_ids = (pages[s] + base)[None]
            pa.paged_kv_update_q(got[0], None, got[2], None, k[:, s][None].contiguous(),
                                 v[:, s][None].contiguous(), page_ids, offsets[s])

    kq, vq = pa.quantize_kv(k)[0], pa.quantize_kv(v)[0]
    page = (pages.T.long() + base)[:, :, None]             # [B, S, 1]
    head = torch.arange(Hkv, device=dev)[None, None, :]
    row = offsets.T.long()[:, :, None]
    index = (torch.cat([page, page]), head, torch.cat([row, row + ps]))
    both = torch.cat([kq, vq])

    def library_call():  # the write half only
        ref[0].index_put_(index, both)

    out = {}
    for label, fn in (("kernel", call), ("before", before_call), ("library", library_call)):
        out[label] = dict(ms=median_ms(fn), device_ms=graph_ms(fn), issue_ms=issue_ms(fn))
    with _kernels.plain_versions():
        plain_ms = median_ms(call)
    # bf16 rows read once; int8 rows and f32 scales written once; ids and
    # offsets read once.
    n_rows = 2 * B * S * Hkv
    least, by = bound_ms(n_rows * (2 * D + D + 4) + 2 * 4 * S * B, 0)
    print(f"K4 paged_kv_update_layer_q, B={B}, S={S}, int8 fused (a verify step's layer): "
          f"kernel {out['kernel']['ms']:.4f} ms per call, {show(out['kernel']['device_ms'])} on "
          f"the device, issued back to back {out['kernel']['issue_ms']:.4f}; plain (quantize + "
          f"4 indexed writes) {plain_ms:.4f}; one index_put_ of quantized rows "
          f"{out['library']['ms']:.4f} ({show(out['library']['device_ms'])} on the device); "
          f"bound {least:.6f} ms by {by}; before ({S} single-row calls with their copies) "
          f"{out['before']['ms']:.4f} per call, {show(out['before']['device_ms'])} on the "
          f"device, issued {out['before']['issue_ms']:.4f}; median of 20")
    return dict(ms=out["kernel"]["ms"], device_ms=out["kernel"]["device_ms"],
                issue_ms=out["kernel"]["issue_ms"], plain_ms=plain_ms,
                library_ms=out["library"]["ms"], library_device_ms=out["library"]["device_ms"],
                bound_ms=least, bound_by=by, before=out["before"])


def check_paged_rows(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    L, B, Hkv, D, ps, P = 32, 32, 8, 128, 128, 65
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[[3, 4, 11, 17, 18, 19, 30, 31]] = False
    # An active slot writes its own page at any row; inactive slots all write
    # row 0 of trash page 0, where the last of them in slot order wins, in the
    # kernel as in the plain version.
    pages = torch.where(active, torch.randperm(P - 1, generator=gen, device=dev)[:B] + 1, 0)
    offsets = torch.where(active, torch.randint(0, ps, (B,), generator=gen, device=dev), 0)
    pages, offsets = pages.to(torch.int32), offsets.to(torch.int32)
    ks = torch.randn(L, B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    vs = torch.randn(L, B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    times = None
    for quant, fused, label in POOL_FORMS:
        kp, vp, ksc, vsc = kv_pools(gen, (L * P, Hkv, 2 * ps if fused else ps, D), quant, fused)
        got = [None if t is None else t.clone() for t in (kp, vp, ksc, vsc)]
        ref = [None if t is None else t.clone() for t in (kp, vp, ksc, vsc)]
        if quant:
            pa.paged_kv_update_rows_q(*got, ks, vs, pages, offsets)
            with _kernels.plain_versions():
                pa.paged_kv_update_rows_q(*ref, ks, vs, pages, offsets)
        else:
            pa.paged_kv_update_rows(got[0], got[1], ks, vs, pages, offsets)
            with _kernels.plain_versions():
                pa.paged_kv_update_rows(ref[0], ref[1], ks, vs, pages, offsets)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, r) for g, r in zip(got, ref) if g is not None)
        changed = int((got[0] != kp).any(dim=-1).sum())
        print(f"K4 {label}: whole pools and scales bit-exact against the plain version: {exact} "
              f"({changed} rows of the first pool changed)")
        if not exact or changed == 0:
            raise AssertionError(f"K4 {label}: kernel disagrees with the plain version")
        if quant and fused:  # the served path's form
            def call():
                pa.paged_kv_update_rows_q(*got, ks, vs, pages, offsets)

            ms, device_ms, issue = median_ms(call), graph_ms(call), issue_ms(call)
            with _kernels.plain_versions():
                plain_ms = median_ms(lambda: pa.paged_kv_update_rows_q(*ref, ks, vs, pages, offsets))
            # The library call nearest to it: ONE indexed write of rows that are
            # already quantized (the write half of the function only).
            kq, vq = pa.quantize_kv(ks)[0], pa.quantize_kv(vs)[0]
            page = (torch.arange(L, device=dev)[:, None] * P + pages.long()[None, :])[:, :, None]
            head = torch.arange(Hkv, device=dev)[None, None, :]
            row = offsets.long()[None, :, None]
            index = (torch.cat([page, page]), head, torch.cat([row.expand(L, B, 1),
                                                               row.expand(L, B, 1) + ps]))
            both = torch.cat([kq, vq])
            def library_call():
                ref[0].index_put_(index, both)

            library_ms, library_device_ms = median_ms(library_call), graph_ms(library_call)
            # bf16 rows read once; int8 rows and f32 scales written once.
            n_rows = 2 * L * B * Hkv
            least, by = bound_ms(n_rows * (2 * D + D + 4) + 8 * B, 0)
            times = dict(ms=ms, device_ms=device_ms, issue_ms=issue, plain_ms=plain_ms,
                         library_ms=library_ms, library_device_ms=library_device_ms,
                         bound_ms=least, bound_by=by)
            print(f"K4 paged_kv_rows, {label} (a decode step, L={L}, B={B}): kernel {ms:.4f} ms "
                  f"per call, {show(device_ms)} on the device, issued back to back "
                  f"{issue:.4f}; plain (quantize + 4 indexed writes) {plain_ms:.4f} ms, one "
                  f"index_put_ of quantized rows {library_ms:.4f} ms "
                  f"({show(library_device_ms)} on the device), bound {least:.6f} ms by {by}, "
                  f"median of 20")
    return {"max_abs_err": 0.0, "times": times}


# (K, N) of every int8 projection: the decoder's q/o, k/v, gate/up and down,
# and the Q-Former's packed self in_proj, cross q / out_proj, cross k/v, ffn.0
# and ffn.2.
QMM_SHAPES = {"decoder q, o": (4096, 4096), "decoder k, v": (4096, 1024),
              "decoder gate, up": (4096, 14336), "decoder down": (14336, 4096),
              "Q-Former in_proj": (4096, 12288), "Q-Former cross k, v": (5120, 4096),
              "Q-Former ffn.0": (4096, 8192), "Q-Former ffn.2": (8192, 4096)}
QMM_ROWS = (1, 7, 32, 128)


def int8_library_call(x, weight_q, scale):
    """The yardstick for K5: `torch._weight_int8pack_mm` where this PyTorch has
    it on CUDA (and it agrees), else dequantize + `torch.matmul`. Used nowhere
    in the port. Returns (name, fn)."""
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    want = qmm.quantized_matmul_plain(x, weight_q, scale).float()
    for name, s in (("torch._weight_int8pack_mm", scale), ("torch._weight_int8pack_mm", scale.to(x.dtype))):
        try:
            got = torch._weight_int8pack_mm(x, weight_q, s).float()
        except (RuntimeError, NotImplementedError, AttributeError, TypeError):
            continue
        if float((got - want).abs().max()) <= 2e-2 * float(want.abs().max()):
            return f"{name} (scales {s.dtype})", lambda: torch._weight_int8pack_mm(x, weight_q, s)
    return "dequantize + torch.matmul", lambda: x @ qmm.dequantize(weight_q, scale, x.dtype).T


QMM_SASS_OPS = ("HGMMA", "UTMALDG", "PRMT", "LOP3", "I2F")
# One decoder pass at M rows runs q, k, v, o, gate, up, down in 32 layers.
QMM_PASS = (("decoder q, o", 2), ("decoder k, v", 2), ("decoder gate, up", 2), ("decoder down", 1))


def qmm_sass(label: str, function: str, no_i2f: bool):
    """K5's or K6's SASS (every n instantiation) and resources: it must hold
    HGMMA and UTMALDG, and K6 no I2F (its nibbles convert by lop3)."""
    sass, res = sass_counts(function, QMM_SASS_OPS), resource_usage(function)
    print(f"{label} SASS ({function}, its five n): {sass}; registers at entry {res['reg']}, stack "
          f"frame {res['stack']} bytes, local {res['local']}")
    if not (sass["HGMMA"] and sass["UTMALDG"]):
        raise AssertionError(f"{label}: no HGMMA or UTMALDG in its SASS: {sass}")
    if no_i2f and sass["I2F"]:
        raise AssertionError(f"{label}: its SASS converts with I2F: {sass}")
    return sass, res


def time_qmm(kernel, plain, library, bf16) -> dict:
    """The kernel three ways: CUDA events around one call (the host's launch
    path included, as K1 to K4 are timed), the device time alone (CUDA-graph
    replay), and the host's issue time when calls go back to back; the plain
    version by events; the library call by events and on the device; the
    bf16 weights' `F.linear` (cuBLAS) on the device."""
    return dict(ms=median_ms(kernel), device_ms=graph_ms(kernel), issue_ms=issue_ms(kernel),
                plain_ms=median_ms(plain, 10), library_ms=median_ms(library, 10),
                library_device_ms=graph_ms(library), bf16_device_ms=graph_ms(bf16))


def pass_totals(label: str, times: dict) -> dict:
    """Each timing summed over one decoder pass, per M."""
    passes = {}
    for M in QMM_ROWS:
        total = {}
        for key, value in times[(QMM_PASS[0][0], M)].items():
            if isinstance(value, str):
                continue
            vals = [times[(name, M)][key] for name, _ in QMM_PASS]
            total[key] = (None if None in vals
                          else 32 * sum(n * v for (_, n), v in zip(QMM_PASS, vals)))
        passes[M] = total
        share = ("not measured" if total["device_ms"] is None
                 else f"{100 * total['bound_ms'] / total['device_ms']:.1f} %")
        print(f"{label} one decoder pass at M={M} (224 launches): kernel {show(total['ms'])} ms per "
              f"call summed, {show(total['device_ms'])} on the device ({share} of the bound), "
              f"issued back to back {show(total['issue_ms'])}; library {show(total['library_ms'])} "
              f"by events, {show(total['library_device_ms'])} on the device; bf16 weights "
              f"(F.linear) {show(total['bf16_device_ms'])} on the device; plain "
              f"{show(total['plain_ms'])}; bound {total['bound_ms']:.3f} ms")
    return passes


def check_quant_matmul(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    dev = "cuda"
    sass, res = qmm_sass("K5", "qmm_kernelILi8E", no_i2f=False)
    worst = 0.0
    times = {}
    library = None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(name, K, N, M) for name, (K, N) in QMM_SHAPES.items() for M in QMM_ROWS]
    # Edges the served shapes do not reach: a K % 64 tail, ragged N, f32 output.
    cases += [("edge: K % 64 = 48, ragged N", 4144, 1000, 33), ("edge: K = 16", 16, 72, 5)]
    for name, K, N, M in cases:
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
        scale = (torch.rand(N, generator=gen, device=dev) + 0.5) * (2.0 / (127 * K ** 0.5))
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        for xx in ((x, x.float()) if name.startswith("edge") else (x,)):
            got = qmm.quantized_matmul(xx, wq, scale)
            torch.cuda.synchronize()
            want = qmm.quantized_matmul_plain(xx, wq, scale)
            # Each row is held to its own largest value (a bf16 ulp is at most
            # 0.78 % of a value): per-row max-abs error over the row's max |plain|.
            err = (got.float() - want.float()).abs().amax(dim=1)
            rel = float((err / want.float().abs().amax(dim=1).clamp_min(1e-30)).max())
            if not (got.dtype == xx.dtype and got.shape == (M, N) and rel <= 1e-2
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K5 {name} M={M} {xx.dtype}: kernel disagrees with the plain "
                                     f"version (per-row relative max-abs {rel:.3e})")
            worst = max(worst, float(err.max()))
        if name.startswith("edge"):
            print(f"K5 {name} (K={K}, N={N}, M={M}), bf16 and f32 output: per-row max-abs over the "
                  f"row's largest value {rel:.3e} (<= 1e-2)")
            continue
        name_of_library, lib_fn = int8_library_call(x, wq, scale)
        if library is None:
            library = name_of_library
            print(f"K5 library yardstick: {library}")
        dense = qmm.dequantize(wq, scale, torch.bfloat16)
        t = time_qmm(lambda: qmm.quantized_matmul(x, wq, scale),
                     lambda: qmm.quantized_matmul_plain(x, wq, scale), lib_fn,
                     lambda: torch.nn.functional.linear(x, dense))
        del dense
        # x, the int8 weight and the scales read once, the bf16 output written
        # once; 2·M·N·K tensor-core operations.
        least, by = bound_ms(2 * M * K + N * K + 4 * N + 2 * M * N, 2 * M * N * K)
        plan = qmm.schedule(M, N, K, sms)
        times[(name, M)] = dict(t, bound_ms=least, bound_by=by)
        print(f"K5 {name} (K={K}, N={N}) M={M}: kernel {t['ms']:.4f} ms per call, "
              f"{show(t['device_ms'])} on the device ({plan.tiles} tiles x {plan.splits} K "
              f"splits), issued back to back {t['issue_ms']:.4f}; plain (f32 matmul) "
              f"{t['plain_ms']:.4f}; library {t['library_ms']:.4f} by events, "
              f"{show(t['library_device_ms'])} on the device; bf16 F.linear "
              f"{show(t['bf16_device_ms'])} on the device; bound {least:.5f} ms by {by} "
              f"({(N * K) / 1e6:.1f} MB of weights); per-row error {rel:.2e}")
    passes = pass_totals("K5", times)
    headline = times[("decoder gate, up", 32)]
    return {"max_abs_err": worst, "library": library, "passes": passes, "sass": sass,
            "resources": res,
            "times": {key: headline[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by", "device_ms", "issue_ms",
                                                     "library_device_ms", "bf16_device_ms")}}


# (K, N) of every int4 projection: the decoder's q/o, k/v, gate/up and down (the
# Q-Former stays int8 under --load-4bit).
QMM4_SHAPES = {name: QMM_SHAPES[name] for name in
               ("decoder q, o", "decoder k, v", "decoder gate, up", "decoder down")}


def int4_library_call(x, weight_q4, scale4):
    """The yardstick for K6: `torch._weight_int4pack_mm` after
    `torch._convert_weight_to_int4pack` (codes + 8 as uint4, two to a byte,
    bf16 scales, zero points 0) where this PyTorch runs it on CUDA and it
    agrees, else dequantize + `torch.matmul` (the name says why). Used
    nowhere in the port. Returns (name, fn)."""
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    want = qmm.quantized_matmul_int4_plain(x, weight_q4, scale4).float()
    N, G = scale4.shape
    K = x.shape[1]
    try:
        codes = qmm.unpack_int4(weight_q4, G).to(torch.int32) + 8        # [N, K] in 1..15
        packed = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)  # [N, K/2]
        w = torch._convert_weight_to_int4pack(packed, 8)
        scales_zeros = torch.stack([scale4.T, torch.zeros_like(scale4.T)], dim=-1)
        scales_zeros = scales_zeros.to(torch.bfloat16).contiguous()        # [G, N, 2]
        fn = lambda: torch._weight_int4pack_mm(x, w, K // G, scales_zeros)  # noqa: E731
        err = float((fn().float() - want).abs().max())
        if err <= 2e-2 * float(want.abs().max()):
            return "torch._weight_int4pack_mm (bf16 scales)", fn
        why = f"torch._weight_int4pack_mm disagrees, max-abs {err:.3e}"
    except (RuntimeError, NotImplementedError, AttributeError, TypeError) as e:
        why = f"torch._weight_int4pack_mm does not run: {str(e).splitlines()[0][:100]}"
    return (f"dequantize + torch.matmul ({why})",
            lambda: x @ qmm.dequant_int4(weight_q4, scale4, x.dtype).T)


def check_quant_matmul_int4(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import quant as quant_ops
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    dev = "cuda"
    sass, res = qmm_sass("K6", "qmm_kernelILi4E", no_i2f=True)
    worst = 0.0
    times = {}
    library = None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(name, K, N, M, 128) for name, (K, N) in QMM4_SHAPES.items() for M in QMM_ROWS]
    # Edges the served shapes do not reach: one group, a 256-wide group, f32 x.
    cases += [("edge: one group, K = 128", 128, 384, 5, 128), ("edge: group 256", 1024, 256, 33, 256)]
    for name, K, N, M, group in cases:
        w = torch.randn(N, K, generator=gen, device=dev) * K ** -0.5
        wq4, scale4 = quant_ops.quantize_kernel_int4(w, group)
        del w
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        for xx in ((x, x.float()) if name.startswith("edge") else (x,)):
            got = qmm.quantized_matmul_int4(xx, wq4, scale4)
            torch.cuda.synchronize()
            want = qmm.quantized_matmul_int4_plain(xx, wq4, scale4)
            # Each row is held to its own largest value, as K5's: per-row max-abs
            # error over the row's max |plain|.
            err = (got.float() - want.float()).abs().amax(dim=1)
            rel = float((err / want.float().abs().amax(dim=1).clamp_min(1e-30)).max())
            if not (got.dtype == xx.dtype and got.shape == (M, N) and rel <= 1e-2
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K6 {name} M={M} {xx.dtype}: kernel disagrees with the plain "
                                     f"version (per-row relative max-abs {rel:.3e})")
            worst = max(worst, float(err.max()))
        if name.startswith("edge"):
            print(f"K6 {name} (K={K}, N={N}, M={M}), bf16 and f32 x: per-row max-abs over the "
                  f"row's largest value {rel:.3e} (<= 1e-2)")
            continue
        name_of_library, lib_fn = int4_library_call(x, wq4, scale4)
        if library is None:
            library = name_of_library
            print(f"K6 library yardstick: {library}")
        dense = qmm.dequant_int4(wq4, scale4, torch.bfloat16)
        t = time_qmm(lambda: qmm.quantized_matmul_int4(x, wq4, scale4),
                     lambda: qmm.quantized_matmul_int4_plain(x, wq4, scale4), lib_fn,
                     lambda: torch.nn.functional.linear(x, dense))
        del dense
        # The nibbles, the f32 group scales and x read once, the bf16 output
        # written once; 2·M·N·K tensor-core operations.
        G = K // group
        least, by = bound_ms(N * K // 2 + 4 * N * G + 2 * M * K + 2 * M * N, 2 * M * N * K)
        plan = qmm.schedule(M, N, K, sms, group)
        times[(name, M)] = dict(t, bound_ms=least, bound_by=by)
        print(f"K6 {name} (K={K}, N={N}) M={M}: kernel {t['ms']:.4f} ms per call, "
              f"{show(t['device_ms'])} on the device ({plan.tiles} tiles x {plan.splits} K "
              f"splits), issued back to back {t['issue_ms']:.4f}; plain (f32 group matmuls) "
              f"{t['plain_ms']:.4f}; library {t['library_ms']:.4f} by events, "
              f"{show(t['library_device_ms'])} on the device; bf16 F.linear "
              f"{show(t['bf16_device_ms'])} on the device; bound {least:.5f} ms by {by} "
              f"({N * K / 2e6:.1f} MB of nibbles); per-row error {rel:.2e}")
    passes = pass_totals("K6", times)
    m1 = times[("decoder gate, up", 1)]
    print(f"K6 gate/up at M=1 on the device: {show(m1['device_ms'])} ms against the library call's "
          f"{show(m1['library_device_ms'])}")
    headline = times[("decoder gate, up", 32)]
    return {"max_abs_err": worst, "library": library, "passes": passes, "sass": sass,
            "resources": res,
            "times": {key: headline[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by", "device_ms", "issue_ms",
                                                     "library_device_ms", "bf16_device_ms")}}


def int8_mlp_library_call(x, weights):
    """A yardstick for K9: `torch._weight_int8pack_mm` for gate, up and down
    with `F.silu` between them, where this PyTorch runs it on CUDA and it
    agrees with the plain version, else None. Used nowhere in the port.
    Returns (name, fn) or (reason, None)."""
    from vis_zephyr_tpu_torch.experiments import fused_mlp_matvec_probe as probe

    gate_q, gate_s, up_q, up_s, down_q, down_s = weights
    want = probe.fused_mlp_matvec_plain(x, *weights).float()

    def fn(cast):
        g = torch._weight_int8pack_mm(x, gate_q, gate_s.to(cast))
        u = torch._weight_int8pack_mm(x, up_q, up_s.to(cast))
        return torch._weight_int8pack_mm(torch.nn.functional.silu(g) * u, down_q, down_s.to(cast))

    why = "torch._weight_int8pack_mm does not run"
    for cast in (torch.float32, x.dtype):
        try:
            err = float((fn(cast).float() - want).abs().max())
        except (RuntimeError, NotImplementedError, AttributeError, TypeError) as e:
            why = f"torch._weight_int8pack_mm does not run: {str(e).splitlines()[0][:100]}"
            continue
        if err <= 2e-2 * float(want.abs().max()):
            return f"torch._weight_int8pack_mm x 3 + F.silu (scales {cast})", lambda: fn(cast)
        why = f"torch._weight_int8pack_mm disagrees, max-abs {err:.3e}"
    return why, None


MLP_ROWS = (1, 8)


def check_fused_mlp(gen) -> dict:
    """K9 against `fused_mlp_matvec_plain` at Zephyr-7B's widths (D = 4096,
    I = 14336) with random int8 weights and scales from the seed, at M = 1
    and 8 and both tilings (block_i 64 and 128): max-abs error over max
    |plain| <= 1e-2 (a bf16 ulp is at most 0.78 % of a value; h and y round
    once on both sides, in other orders) and cosine >= 0.9999. Times per
    call (events around one call and the device alone from a CUDA-graph
    replay) beside the plain version, the K5 route a `--load-8bit` layer
    takes (K5 gate, up, `F.silu(g) · u`, K5 down) and the int8-pack yardstick."""
    from vis_zephyr_tpu_torch.experiments import fused_mlp_matvec_probe as probe
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    dev = "cuda"
    hidden, inter = probe.D, probe.I

    def codes(n, k):
        return torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)

    def scales(n, k):
        return (torch.rand(n, generator=gen, device=dev) + 0.5) * (2.0 / (127 * k ** 0.5))

    weights = (codes(inter, hidden), scales(inter, hidden), codes(inter, hidden),
               scales(inter, hidden), codes(hidden, inter), scales(hidden, inter))
    worst, times = 0.0, {}
    library = None
    for M in MLP_ROWS:
        x = torch.randn(M, hidden, generator=gen, device=dev).to(torch.bfloat16)
        want = probe.fused_mlp_matvec_plain(x, *weights)
        for bi in probe.BLOCK_I:
            got = probe.fused_mlp_matvec(x, *weights, block_i=bi)
            torch.cuda.synchronize()
            a = probe.agreement(got, want)
            print(f"K9 fused_mlp_matvec M={M}, block_i {bi}: max-abs over max |plain| "
                  f"{a['rel_err']:.3e} (<= 1e-2), cosine {a['cosine']:.7f} (>= 0.9999)")
            if not (got.shape == (M, hidden) and a["rel_err"] <= 1e-2 and a["cosine"] >= 0.9999
                    and bool(torch.isfinite(got.float()).all())):
                raise AssertionError(f"K9 M={M} block_i {bi}: kernel disagrees with the plain "
                                     "version")
            worst = max(worst, float((got.float() - want.float()).abs().max()))
        # x and the three int8 weights with their scales read once, y written
        # once; 2·M multiply-adds per weight byte.
        least, by = bound_ms(3 * hidden * inter + 4 * (2 * inter + hidden) + 4 * M * hidden,
                             2 * 3 * M * hidden * inter)
        t = {}
        for bi in probe.BLOCK_I:
            fn = lambda bi=bi: probe.fused_mlp_matvec(x, *weights, block_i=bi)  # noqa: E731
            t[bi] = dict(ms=median_ms(fn), device_ms=graph_ms(fn))
        k5 = lambda: probe.k5_route(x, *weights)  # noqa: E731
        k5_ms, k5_device = median_ms(k5), graph_ms(k5)
        plain_ms = median_ms(lambda: probe.fused_mlp_matvec_plain(x, *weights), 10)
        name, lib_fn = int8_mlp_library_call(x, weights)
        if library is None:
            library = name
            print(f"K9 yardstick: {library}")
        lib_ms = None if lib_fn is None else median_ms(lib_fn, 10)
        best = min(probe.BLOCK_I, key=lambda bi: t[bi]["device_ms"] or t[bi]["ms"])
        times[M] = dict(ms=t[probe.DEFAULT_BLOCK_I]["ms"],
                        device_ms=t[probe.DEFAULT_BLOCK_I]["device_ms"],
                        by_block_i={bi: t[bi] for bi in probe.BLOCK_I}, plain_ms=plain_ms,
                        library_ms=None, k5_route_ms=k5_ms, k5_route_device_ms=k5_device,
                        int8pack_route_ms=lib_ms, bound_ms=least, bound_by=by)
        for bi in probe.BLOCK_I:
            print(f"K9 M={M}, block_i {bi}: {t[bi]['ms']:.4f} ms per call, "
                  f"{show(t[bi]['device_ms'])} on the device")
        print(f"K9 M={M}: the K5 route {k5_ms:.4f} ms per call, {show(k5_device)} on the device; "
              f"plain (f32 matmuls) {plain_ms:.4f}; {library}: {show(lib_ms)}; bound {least:.5f} "
              f"ms by {by} ({3 * hidden * inter / 1e6:.1f} MB of int8 weights); fastest tiling "
              f"on the device: block_i {best}")
    return {"max_abs_err": worst, "times": times}


class WordTokenizer:
    """A stand-in tokenizer with the surface `tokenize_with_images` and
    `ChatEngine` use: words hash to ids, every id decodes to "w<id>"."""

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 2

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text, **kwargs):
        ids = [self.bos_token_id]
        for word in text.replace("</s>", " </s> ").split():
            ids.append(self.eos_token_id if word == "</s>"
                       else 3 + zlib.crc32(word.encode()) % (self.vocab_size - 3))
        return self._Out(ids)

    def decode(self, ids, skip_special_tokens=False):
        # Every id stays a word (EOS ends a stream before it is decoded), so
        # the streamed word count is the generated token count.
        return " ".join(f"w{i}" for i in ids)


def post_chat(port: int, payload: dict):
    """POST /chat; returns (status, text, seconds to first chunk, seconds to end)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/chat", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    chunks, first = [], None
    while True:
        data = resp.read1(65536)
        if not data:
            break
        if first is None:
            first = time.perf_counter() - t0
        chunks.append(data)
    total = time.perf_counter() - t0
    conn.close()
    return resp.status, b"".join(chunks).decode(), first, total


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(), dim=0))


def build_model(seed: int):
    from vis_zephyr_tpu_torch.config import VisZephyrConfig
    from vis_zephyr_tpu_torch.models.vis_zephyr import init_vis_zephyr

    cfg = VisZephyrConfig()
    t0 = time.perf_counter()
    model = init_vis_zephyr(cfg, torch.Generator("cuda").manual_seed(seed), device="cuda",
                            dtype=torch.bfloat16)
    # No random reply may end early: the EOS row of lm_head is zeroed, so its
    # logit is 0 and never the largest of 32000 random ones. Every reply then
    # has exactly max_new_tokens tokens and the launch counts are exact.
    model.decoder.lm_head.weight[WordTokenizer.eos_token_id].zero_()
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(model, name).parameters())
                for name in ("vision", "projector", "decoder")}
    print(f"model: full-width VisZephyrConfig() with random bf16 weights "
          f"(vision {n_params['vision'] / 1e9:.2f} B, projector {n_params['projector'] / 1e9:.2f} B, "
          f"decoder {n_params['decoder'] / 1e9:.2f} B params) in {time.perf_counter() - t0:.1f} s")
    return model, cfg


def session_pixels(rng, side: int, crops: int):
    """Seeded pixels [4, side, side, 3] with `crops` valid patches, as
    `attach_image` stores a preprocessed image (the smoke does not rely on
    PIL on the card's host)."""
    import numpy as np

    px = rng.standard_normal((4, side, side, 3)).astype(np.float32)
    px[crops:] = 0.0
    return px, np.arange(4) < crops


def start_server(engine, profile_dir=None):
    from vis_zephyr_tpu_torch.serve.api import serve

    server = serve(engine, "127.0.0.1", 0, profile_dir=profile_dir)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def stop_server(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)


def weight_bits(model) -> int:
    """16, 8 or 4: the form of the decoder's projections."""
    from vis_zephyr_tpu_torch.models.quant_linear import QuantLinear, QuantLinear4

    up = model.decoder.model.layers[0].mlp.up_proj
    return 4 if isinstance(up, QuantLinear4) else 8 if isinstance(up, QuantLinear) else 16


def reset_routes() -> None:
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    qmm.launches = qmm.dequant_calls = qmm.launches4 = qmm.dequant4_calls = 0


def read_routes() -> dict:
    """K5 and K6 launches and their dequantize routes' calls since the last reset."""
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    return dict(k5=qmm.launches, dequant=qmm.dequant_calls, k6=qmm.launches4,
                dequant4=qmm.dequant4_calls)


def expected_routes(model, qformer, decoder) -> dict:
    """What `read_routes` must give after a run whose Q-Former passes route as
    `qformer` and whose decoder passes as `decoder` ((kernel, dequantize)
    pairs): on int8 weights K5 takes both, on int4 weights K5 the Q-Former's
    and K6 the decoder's; on bf16 weights nothing is quantized."""
    bits = weight_bits(model)
    int8 = {16: (0, 0), 8: add_routes(qformer, decoder), 4: qformer}[bits]
    int4 = decoder if bits == 4 else (0, 0)
    return dict(k5=int8[0], dequant=int8[1], k6=int4[0], dequant4=int4[1])


def show_routes(got: dict, want: dict) -> str:
    return (f"K5 quant_matmul_int8 {got['k5']} (want {want['k5']}), its dequantize route "
            f"{got['dequant']} (want {want['dequant']}); K6 quant_matmul_int4 {got['k6']} (want "
            f"{want['k6']}), its dequantize route {got['dequant4']} (want {want['dequant4']})")


def qformer_routes(cfg, n_images: int, text_len: int):
    """(K5 launches, dequantize-route calls) of one int8 Q-Former pass over
    `n_images` crops conditioned on `text_len` prompt tokens. Per block: the
    packed self in_proj, the self out_proj, the cross q and out_proj, ffn.0 and
    ffn.2 at the query rows (block 0's queries are followed by the text), the
    cross k and v at the visual rows."""
    from vis_zephyr_tpu_torch.ops.quant_matmul import row_chunks

    pc = cfg.projector
    query_rows = ([n_images * (pc.num_queries + text_len)]
                  + [n_images * pc.num_queries] * (pc.num_blocks - 1))
    visual_rows = n_images * cfg.vision.tokens_per_image
    calls = [m for rows in query_rows for m in [rows] * 6 + [visual_rows] * 2]
    return (sum(len(row_chunks(m)) for m in calls), sum(not row_chunks(m) for m in calls))


def decoder_routes(cfg, rows: int, passes: int = 1):
    """(kernel launches, dequantize-route calls) of `passes` quantized decoder
    passes of `rows` rows each: q, k, v, o, gate, up and down in every layer,
    224 at full depth, all on one route (K5 on int8 weights; K6 on int4, whose
    gate the full-width shapes pass whole), a launch a chunk of rows
    (`row_chunks`)."""
    from vis_zephyr_tpu_torch.ops.quant_matmul import row_chunks

    n = 7 * cfg.decoder.num_layers * passes
    chunks = len(row_chunks(rows))
    return (n * chunks, 0) if chunks else (0, n)


def add_routes(*routes):
    return tuple(map(sum, zip(*routes))) if routes else (0, 0)


def run_slice(model, cfg, seed: int, max_new_tokens: int, card: str, n_requests: int = 4,
              label: str = "slice1") -> dict:
    import numpy as np

    from vis_zephyr_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve.engine import ChatEngine
    from vis_zephyr_tpu_torch.serve.generate import _cache_len, decode_step, prefill

    L = cfg.decoder.num_layers
    tokenizer = WordTokenizer(cfg.decoder.vocab_size)
    engine = ChatEngine(model, cfg, tokenizer, max_new_tokens=max_new_tokens)
    rng = np.random.default_rng(seed)
    side = cfg.vision.image_size
    sessions = [f"s{i}" for i in range(3)]
    pixels = {}
    for sid in sessions:
        px, valid = session_pixels(rng, side, 3)
        pixels[sid] = px
        engine.attach_pixels(sid, px, valid, (2 * side, side))

    server, thread = start_server(engine)
    port = server.server_address[1]
    # A session's first turn carries the <image> placeholder, as `chat` adds
    # it when it attaches an image itself.
    requests = [(sessions[0], f"{DEFAULT_IMAGE_TOKEN}\ndescribe the picture"),
                (sessions[1], f"{DEFAULT_IMAGE_TOKEN}\nwhat is in the image"),
                (sessions[2], f"{DEFAULT_IMAGE_TOKEN}\ncount the objects"),
                (sessions[0], "and what colour is it")][:n_requests]
    results = []
    try:
        fa.launches = kv_cache.launches = 0
        reset_routes()
        for sid, question in requests:
            status, text, ttft, total = post_chat(port, {"session_id": sid, "question": question})
            n = len(text.split())
            results.append((sid, status, text, ttft, total, n))
        flash_launches, append_launches = fa.launches, kv_cache.launches
        routes = read_routes()
    finally:
        stop_server(server, thread)

    decode_steps = 0
    rates = []
    for sid, status, text, ttft, total, n in results:
        words_ok = n > 0 and all(w[0] == "w" and w[1:].isdigit() for w in text.split())
        print(f"{label} request {sid}: HTTP {status}, {n} tokens streamed, TTFT {ttft * 1e3:.1f} ms, "
              f"total {total * 1e3:.1f} ms, text starts {text[:48]!r}")
        if status != 200 or not words_ok:
            raise AssertionError(f"request on {sid} did not stream text")
        decode_steps += min(n, max_new_tokens - 1)
        if n > 1:
            rates.append((n - 1) / (total - ttft))
    # Quantized weights: each first-turn request runs one Q-Former pass over its
    # 4 crops and one prefill over the spliced rows (the prompt without its
    # sentinel and 4 crops' tokens, padded to 128), then a decode step (M = 1)
    # per token after the first.
    qformer, prefills = [], []
    if weight_bits(model) != 16:
        assert all(q.startswith(DEFAULT_IMAGE_TOKEN) for _, q in requests), "first turns only"
        for _, question in requests:
            n_ids = len(engine.prompt_ids(question))
            rows = -(-(n_ids - 1 + 4 * cfg.tokens_per_patch) // 128) * 128
            qformer.append(qformer_routes(cfg, 4, n_ids - 1))
            prefills.append(decoder_routes(cfg, rows))
    want = expected_routes(model, add_routes(*qformer),
                           add_routes(*prefills, decoder_routes(cfg, 1, decode_steps)))
    print(f"{label} counters: K1 flash_fwd {flash_launches} launches (want {L * len(requests)}), "
          f"K2 dense_cache_append {append_launches} (want {L} x {decode_steps} decode steps), "
          f"{show_routes(routes, want)}")
    if (flash_launches != L * len(requests) or append_launches != L * decode_steps
            or routes != want):
        raise AssertionError("the serving path did not go through the kernels as counted")

    # Kernel path against the plain path on session s1's request.
    ids = torch.tensor([engine.prompt_ids(requests[1][1])], device="cuda")
    images = torch.as_tensor(pixels[sessions[1]], device="cuda")[None]
    valid = torch.tensor([[True, True, True, False]], device="cuda")
    # The cache length `generate_stream` picks, so the kernel path's greedy
    # tokens must equal the streamed ones exactly.
    cache_len = _cache_len(ids.shape[1], images, cfg, max_new_tokens)
    last_k, cache_k, lengths = prefill(model, ids, images, valid, cfg, cache_len)
    with _kernels.plain_versions():
        last_p, cache_p, _ = prefill(model, ids, images, valid, cfg, cache_len)
    if not (bool(torch.isfinite(last_k).all()) and last_k.shape == (1, cfg.decoder.vocab_size)):
        raise AssertionError(f"prefill logits not finite of shape [1, V]: {tuple(last_k.shape)}")
    cos_prefill = cosine(last_k, last_p)
    token = last_k.argmax(-1)
    direct = [int(token)]
    for _ in range(8):
        logits_k, cache_k = decode_step(model, cache_k, token, cfg)
        with _kernels.plain_versions():
            logits_p, cache_p = decode_step(model, cache_p, token, cfg)
        token = logits_k.argmax(-1)
        direct.append(int(token))
    cos_decode = cosine(logits_k, logits_p)
    streamed = [int(w[1:]) for w in results[1][2].split()][:len(direct)]
    same_tokens = direct[:len(streamed)] == streamed  # a stream ends early only at EOS
    print(f"{label} check (prefill length {int(lengths[0])}, padded to a multiple of 128): "
          f"prefill last-token logits cosine {cos_prefill:.6f}, decode-step-8 logits cosine "
          f"{cos_decode:.6f} (kernel path vs the kernels' plain versions, >= 0.999); "
          f"direct greedy tokens equal the streamed ones: {same_tokens}")
    if not (cos_prefill >= 0.999 and cos_decode >= 0.999 and bool(torch.isfinite(logits_k).all())):
        raise AssertionError("kernel path disagrees with the plain path")
    if not same_tokens:
        raise AssertionError(f"served tokens {streamed} differ from a direct run's {direct}")

    ttfts = [r[3] for r in results]
    rate = statistics.median(rates) if rates else float("nan")
    print(f"{label}: TTFT median {statistics.median(ttfts) * 1e3:.1f} ms (first request "
          f"{ttfts[0] * 1e3:.1f} ms), decode {rate:.2f} tokens/s median over requests, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    return {"k1": flash_launches, "k2": append_launches, **routes,
            "precision_inputs": (ids, images, valid, cache_len, last_k)}


def check_precision(model, cfg, ids, images, valid, cache_len, last_k) -> None:
    """The port runs the multimodal prefill in bf16, while the JAX engine's f32
    pixels promote its vision stack and prefill to f32 over the same bf16
    weights. Hold the kernel path's logits against that arithmetic: the same
    weights widened to f32 (exactly), plain attention. Widens `model` in place."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.serve.generate import prefill

    model.float()
    with _kernels.plain_versions():
        last_f32, _, _ = prefill(model, ids, images, valid, cfg, cache_len)
    cos_f32 = cosine(last_k, last_f32)
    same_top1 = int(last_k.argmax(-1)) == int(last_f32.argmax(-1))
    print(f"precision: bf16 kernel-path prefill last-token logits against an f32 run of "
          f"the same weights: cosine {cos_f32:.6f} (>= 0.999), max-abs "
          f"{float((last_k - last_f32).abs().max()):.4e}, same top-1 token: {same_top1}")
    if not cos_f32 >= 0.999:
        raise AssertionError("bf16 prefill disagrees with the f32 run of the same weights")


# -- the batched paged path -------------------------------------------------------------

PAGED_FLAGS = ["--continuous-batching", "--kv-cache", "paged", "--kv-quant", "--max-slots", "32"]
QUESTION_WORDS = (20, 280, 580)
WORDS = ("the picture shows a street with people cars trees shops and signs under a "
         "bright sky while someone asks what is happening here and why").split()


def make_question(rng, n_words: int) -> str:
    return " ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), n_words))


def paged_requests(rng, cfg, n: int, repeat: bool = False):
    """[(session id, question, pixels, valid)]: question lengths cycle through
    about 40, 300 and 600 words; every third session's image has 3 valid
    anyres crops, the others the global view alone (`/chat` takes no session
    without an image). `repeat`: each question is one 10-word phrase said
    over and over (for prompt lookup to find)."""
    from vis_zephyr_tpu_torch.constants import DEFAULT_IMAGE_TOKEN

    out = []
    for i in range(n):
        px, valid = session_pixels(rng, cfg.vision.image_size, 3 if i % 3 == 0 else 1)
        n_words = QUESTION_WORDS[(i // 3) % 3]
        text = (" ".join([make_question(rng, 10)] * (n_words // 10)) if repeat
                else make_question(rng, n_words))
        question = f"{DEFAULT_IMAGE_TOKEN}\n" + text
        out.append((f"p{i}", question, px, valid))
    return out


def run_paged_server(model, cfg, seed: int, new_tokens: int, card: str, n: int = 48,
                     label: str = "paged", lookahead: int = 0, repeat: bool = False,
                     multi_step: int = 1, observe: bool = False) -> dict:
    """The paged server under a burst of `n` concurrent /chat requests, with
    `--lookahead` when `lookahead` > 0 (then every scheduler step is a verify
    step of S = lookahead + 1 rows per slot) and `--multi-step` (a scheduler
    step with no admission work waiting runs that many decode steps, each
    counted in `steps`); `repeat`: repetitive questions (`paged_requests`);
    `observe`: then the server's own readings (`observe_server`)."""
    from vis_zephyr_tpu_torch.utils.metrics import ServingMetrics
    import numpy as np

    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve import api

    L = cfg.decoder.num_layers
    parser = argparse.ArgumentParser()
    api.add_engine_args(parser)
    flags = parser.parse_args(PAGED_FLAGS + ["--max-new-tokens", str(new_tokens),
                                             "--lookahead", str(lookahead),
                                             "--multi-step", str(multi_step)])
    engine = api.engine_from_args(model, cfg, WordTokenizer(cfg.decoder.vocab_size), flags)
    b = engine.batcher
    side = cfg.vision.image_size
    requests = paged_requests(np.random.default_rng(seed + 1), cfg, n, repeat=repeat)
    chunks = 0
    qformer = []  # quantized weights: one Q-Former pass per request, at admission
    for sid, question, px, valid in requests:
        engine.attach_pixels(sid, px, valid, (2 * side, side))
        n_ids = len(engine.prompt_ids(question))
        length = n_ids - 1 + int(valid.sum()) * cfg.tokens_per_patch
        chunks += -(-length // b.prefill_chunk)
        qformer.append(qformer_routes(cfg, px.shape[0], n_ids - 1))
    print(f"{label}: server flags {' '.join(PAGED_FLAGS)} -> max_slots {b.max_slots}, cache_len "
          f"{b.cache_len}, page {b.page_size}, {b.num_pages} pages per layer, prefill chunk "
          f"{b.prefill_chunk}, int8 {b.kv_quant}, fused {b.kv_fused}, lookahead {b.lookahead}; pools "
          f"{(b.kp.numel() + 4 * b.ksp.numel()) / 2**30:.2f} GiB")

    # Warm the path once (cuBLAS handles, allocator), outside the counted run.
    engine.attach_pixels("warm", requests[0][2], requests[0][3], (2 * side, side))
    engine.chat_text("warm", requests[0][1])
    engine.close()  # the pump's last step counts itself after the reply ends
    uses = np.zeros(b.max_slots, np.int64)
    install = b._install

    def counting_install(req, slot, *args):
        ok = install(req, slot, *args)
        uses[slot] += bool(ok)
        return ok

    b._install = counting_install
    server, thread = start_server(engine)
    port = server.server_address[1]
    torch.cuda.reset_peak_memory_stats()
    try:
        fa.launches = kv_cache.launches = pa.attn_launches = pa.rows_launches = 0
        pa.update_launches = 0
        reset_routes()
        b.steps = b.slots_stepped = b.verify_steps = b.proposed = b.accepted = b.bursts = 0
        engine.metrics = b.metrics = ServingMetrics()  # the burst's requests alone
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(
                lambda r: post_chat(port, {"session_id": r[0], "question": r[1]}), requests))
        wall = time.perf_counter() - t0
        counts = dict(k1=fa.launches, k2=kv_cache.launches, k3=pa.attn_launches,
                      k4=pa.rows_launches, kvu=pa.update_launches, **read_routes())
    finally:
        stop_server(server, thread)
        engine.close()

    for (sid, _, _, _), (status, text, ttft, total) in zip(requests, results):
        words = text.split()
        if status != 200 or len(words) != new_tokens or not all(
                w[0] == "w" and w[1:].isdigit() for w in words):
            raise AssertionError(f"{label} request {sid}: HTTP {status}, {len(words)} tokens "
                                 f"(want {new_tokens}): {text[:60]!r}")
    S = lookahead + 1
    steps = b.verify_steps if lookahead else b.steps
    kind = f"verify steps (S = {S})" if lookahead else "decode steps"
    bursts = (f" ({b.bursts} bursts of {b.multi_step} = {b.bursts * b.multi_step} of them, "
              f"{b.graphs.captures} capture)" if multi_step > 1 else "")
    print(f"{label}: {n} requests, all HTTP 200 with {new_tokens} tokens; {steps} {kind}{bursts}, "
          f"mean active slots per step {b.slots_stepped / steps:.2f} of {b.max_slots}")
    if multi_step > 1 and b.bursts == 0:
        raise AssertionError(f"{label}: no scheduler step ran a burst")
    # Quantized weights: every chunk (256 rows) takes the dequantize route,
    # every decode step (M = max_slots) the kernel, every verify step (M =
    # max_slots x S) whichever route its rows take; plus each request's
    # Q-Former pass.
    want = expected_routes(model, add_routes(*qformer),
                           add_routes(decoder_routes(cfg, b.prefill_chunk, chunks),
                                      decoder_routes(cfg, b.max_slots * S, steps)))
    routes = {key: counts[key] for key in want}
    # A decode step: K3 once per layer and K4 once over all layers. A verify
    # step: K3 once per layer over S rows, and one write of the layer's S rows
    # a slot (`paged_kv_update_layer`), no all-layer write.
    k4_want, kvu_want = (0, L * steps) if lookahead else (steps, 0)
    print(f"{label} counters: K3 paged_attn_decode {counts['k3']} (want {L} x {steps} = {L * steps}), "
          f"K4 paged_kv_rows {counts['k4']} (want {k4_want}), K4 paged_kv_update {counts['kvu']} "
          f"(want {kvu_want}), K2 dense_cache_append {counts['k2']} "
          f"(want {L} x {chunks} prefill chunks = {L * chunks}), K1 flash_fwd {counts['k1']} (want 0: "
          f"chunked admission attends its scratch cache with plain attention), "
          f"{show_routes(routes, want)}")
    if ((counts["k3"], counts["k4"], counts["kvu"], counts["k2"], counts["k1"])
            != (L * steps, k4_want, kvu_want, L * chunks, 0) or routes != want
            or (lookahead and (b.steps != 0 or steps == 0))):
        raise AssertionError("the paged serving path did not go through the kernels as counted")
    if lookahead:
        emitted = n * (new_tokens - 1)  # every token after each request's first
        counts.update(verify_steps=steps, proposed=b.proposed, accepted=b.accepted)
        print(f"{label} speculation: {b.proposed} tokens proposed, {b.accepted} accepted "
              f"({b.accepted / max(b.proposed, 1):.3f}); {emitted / b.slots_stepped:.3f} tokens "
              f"per slot per verify step")
    reused = int((uses > 1).sum())
    free = b.allocator.available
    print(f"{label} slots: {int((uses > 0).sum())} of {b.max_slots} used, {reused} of them more than "
          f"once ({int(uses.sum())} admissions); allocator {free} of {b.num_pages - 1} pages free, "
          f"page table all zero: {not bool(b.page_table.any())}")
    # Fewer requests than slots need not reuse a slot.
    if (int(uses.sum()) != n or (reused == 0 and n > b.max_slots) or free != b.num_pages - 1
            or b.has_work or bool(b.page_table.any()) or b.slots_stepped <= steps):
        raise AssertionError("slots were not reused, requests did not share steps, or pages leaked")
    ttfts = sorted(r[2] for r in results)
    decoded = n * (new_tokens - 1)
    print(f"{label}: TTFT median {statistics.median(ttfts) * 1e3:.1f} ms, max {ttfts[-1] * 1e3:.1f} ms; "
          f"{n * new_tokens} tokens in {wall:.2f} s = {n * new_tokens / wall:.1f} tokens/s over all "
          f"slots ({decoded / wall:.1f} decode tokens/s), {wall / steps * 1e3:.1f} ms of wall per "
          f"scheduler step (decode + one prefill chunk), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    counts.update(tokens_per_s=n * new_tokens / wall, ttft_median=statistics.median(ttfts),
                  streams={sid: text.split() for (sid, *_), (_, text, _, _) in zip(requests, results)})
    if observe:
        observe_server(engine, requests[0][:2], n, new_tokens, label, card)
    return counts


def wait_until(done, timeout: float = 120.0) -> None:
    deadline = time.perf_counter() + timeout
    while not done():
        if time.perf_counter() > deadline:
            raise AssertionError("timed out waiting for the server")
        time.sleep(0.001)


def observe_server(engine, request, n: int, new_tokens: int, label: str, card: str) -> None:
    """The server's own readings on an engine that has just served a burst of
    `n` requests (its `ServingMetrics` reset before the burst), through a
    fresh server with a profile dir: GET /health "ok"; GET /metrics, whose
    request, TTFT and TPOT counts must be `n`; one GET
    /debug/profile?seconds=1 while `request` (session id, question) is in
    flight, whose trace file must exist and hold the card's kernels; then a
    drain while `request` is in flight again: that request ends with HTTP 200
    and all its tokens, the next POST gets 503, /health reads "draining"
    (503) and `drain()` returns True. The engine is closed at the end."""
    import shutil
    import tempfile

    profile_dir = tempfile.mkdtemp(prefix="vzt_profile_")
    server, thread = start_server(engine, profile_dir=profile_dir)
    port = server.server_address[1]
    payload = {"session_id": request[0], "question": request[1]}
    try:
        status, body = post_json(port, "GET", "/health")
        health = (status, json.loads(body))
        summary = json.loads(post_json(port, "GET", "/metrics")[1])
        counted = (summary["requests"], summary["ttft_ms"]["count"],
                   summary["tpot_ms"]["count"])
        with ThreadPoolExecutor(1) as pool:
            reply = pool.submit(post_chat, port, payload)
            wait_until(lambda: engine._inflight > 0)
            t0 = time.perf_counter()
            profile_status, body = post_json(port, "GET", "/debug/profile?seconds=1")
            profile_s = time.perf_counter() - t0
            profiled = reply.result()
        trace = json.loads(body).get("trace_file") if profile_status == 200 else None
        trace_bytes = os.path.getsize(trace) if trace and os.path.exists(trace) else 0
        # The card's kernels are traced process-wide; of the host's operators
        # only the handler thread's (torch.profiler records the thread that
        # starts it).
        kernels = (sum(e.get("cat") == "kernel" for e in json.load(open(trace))["traceEvents"])
                   if trace_bytes else 0)
        with ThreadPoolExecutor(2) as pool:
            reply = pool.submit(post_chat, port, payload)
            wait_until(lambda: engine._inflight > 0)
            drained = pool.submit(engine.drain, 300.0)
            wait_until(lambda: engine._draining)
            in_flight = engine._inflight
            refused = post_chat(port, payload)[0]
            status, body = post_json(port, "GET", "/health")
            health_draining = (status, json.loads(body))
            last, clean = reply.result(), drained.result()
    finally:
        stop_server(server, thread)
        engine.close()
        shutil.rmtree(profile_dir, ignore_errors=True)
    checks = dict(health=health == (200, {"status": "ok"}), metrics=counted == (n, n, n),
                  profile=trace_bytes > 0 and kernels > 0 and profiled[0] == 200,
                  drain=(clean and in_flight == 1 and last[0] == 200
                         and len(last[1].split()) == new_tokens and refused == 503
                         and health_draining == (503, {"status": "draining"})))
    print(f"{label} observability: GET /health {health}; GET /metrics requests, TTFT and TPOT "
          f"counts {counted} (want {n} each), TTFT p50 {summary['ttft_ms']['p50']} ms, TPOT "
          f"mean {summary['tpot_ms']['mean']} ms; GET /debug/profile?seconds=1 with a request "
          f"in flight: HTTP {profile_status} in {profile_s:.2f} s, trace "
          f"{trace_bytes} bytes holding {kernels} kernel events; drain with {in_flight} request in flight: it ended HTTP "
          f"{last[0]} with {len(last[1].split())} tokens, drain() {clean}, the next POST HTTP "
          f"{refused}, /health {health_draining}: {checks} [{card}]", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{label}: the server's observability failed: {checks}")


def admitted_batcher(model, cfg, requests, max_slots: int, prefill_chunk=None,
                     max_new_tokens: int = 64, dense: bool = False, options=None, **kw):
    """A direct PagedBatcher (a dense ContinuousBatcher with `dense`) with
    every request admitted before any decode step: whole (the prompt
    prefills through K1) or, with `prefill_chunk`, in chunks over a scratch
    cache (K2 at T = chunk). `options`: each request's `submit` arguments.
    Inside `_kernels.plain_versions()` the same admission takes the plain
    versions."""
    from vis_zephyr_tpu_torch.serve.batching import ContinuousBatcher
    from vis_zephyr_tpu_torch.serve.generate import SamplingConfig
    from vis_zephyr_tpu_torch.serve.paged import PagedBatcher

    b = (ContinuousBatcher if dense else PagedBatcher)(
        model, cfg, max_slots=max_slots, cache_len=2048,
        sampling=SamplingConfig(max_new_tokens=max_new_tokens, eos_token_id=-1),
        prefill_chunk=prefill_chunk, **kw)
    for i, (ids, px, valid) in enumerate(requests):
        b.submit(ids, px, valid, **(options[i] if options else {}))
    if prefill_chunk:
        while not b.pending.empty() or b._prefilling is not None:
            b._pump_prefill()
    else:
        b._admit_pending()
    if int(b.active.sum()) != len(requests):
        raise AssertionError("not every request was admitted")
    return b


def direct_requests(cfg, seed: int, n: int, repeat: bool = False):
    import numpy as np

    from vis_zephyr_tpu_torch.data.tokenization import tokenize_with_images

    tok = WordTokenizer(cfg.decoder.vocab_size)
    return [(np.asarray(tokenize_with_images(q, tok), np.int64), px, valid)
            for _, q, px, valid in paged_requests(np.random.default_rng(seed + 2), cfg, n,
                                                  repeat=repeat)]


def slot_cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)


def valid_rows(b, L: int) -> torch.Tensor:
    """Bool [L·P, Hkv, rows]: the K and V rows below each slot's length (a
    prefill's padded tail holds rows nothing reads, filled differently by the
    two prefill paths)."""
    ps, P = b.page_size, b.num_pages
    valid = torch.zeros(b.ksp.shape, dtype=torch.bool, device=b.ksp.device)
    layer0 = torch.arange(L, device=valid.device) * P
    for slot in range(b.max_slots):
        n = int(b.slot_len[slot])
        for j, page in enumerate(b.slot_pages[slot]):
            rows = min(max(n - j * ps, 0), ps)
            valid[layer0 + page, :, :rows] = True
            valid[layer0 + page, :, ps:ps + rows] = True
    return valid


def run_fixed_batch(model, cfg, seed: int) -> dict:
    """HTTP timing changes which requests share a step, so agreement is read on
    a fixed batch: the same 16 requests admitted whole (K1) and in chunks of 256
    (K2 at T=256), each on the kernel path and on the plain path, and whole with
    bf16 pools; all are fed the whole-prompt kernel path's tokens so that they
    see the same sequence. Returns K2's launches of the chunked admission, the
    tokens fed before each step and the kernel path's logits at steps 1 and 16
    (the int8 phase replays them)."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    L = cfg.decoder.num_layers
    requests = direct_requests(cfg, seed, 16)
    int8_fused = dict(kv_quant=True, kv_fused=True)
    fa.launches = kv_cache.launches = 0
    kern = admitted_batcher(model, cfg, requests, 16, **int8_fused)
    k1 = fa.launches
    chunk_kern = admitted_batcher(model, cfg, requests, 16, prefill_chunk=256, **int8_fused)
    k2 = kv_cache.launches
    with _kernels.plain_versions():
        plain = admitted_batcher(model, cfg, requests, 16, **int8_fused)
        chunk_plain = admitted_batcher(model, cfg, requests, 16, prefill_chunk=256, **int8_fused)
    wide = admitted_batcher(model, cfg, requests, 16, kv_quant=False, kv_fused=True)
    chunks = sum(-(-int(n) // 256) for n in kern.slot_len)
    print(f"batch: 16 requests, prompt lengths {sorted(int(n) for n in kern.slot_len)}; admitted "
          f"whole: K1 flash_fwd {k1} launches (want {L} per prompt = {L * 16}); admitted in chunks "
          f"of 256: K2 dense_cache_append {k2} launches (want {L} x {chunks} chunks = {L * chunks})")
    if (k1, k2) != (L * 16, L * chunks):
        raise AssertionError("the admissions did not go through K1 and K2 as counted")

    # Chunked admission runs the same arithmetic on both paths but for K's
    # RoPE and the row write (K2, which repeats eager PyTorch's roundings,
    # against `apply_rope` and the indexed write), so everything it leaves
    # behind must be equal bit for bit: pools, scales, table, lengths, tokens.
    rows = valid_rows(chunk_kern, L)
    same = {"int8 rows": torch.equal(chunk_kern.kp[rows], chunk_plain.kp[rows]),
            "scales": torch.equal(chunk_kern.ksp[rows], chunk_plain.ksp[rows]),
            "whole pools": (torch.equal(chunk_kern.kp, chunk_plain.kp)
                            and torch.equal(chunk_kern.ksp, chunk_plain.ksp)),
            "page table": torch.equal(chunk_kern.page_table, chunk_plain.page_table),
            "lengths": torch.equal(chunk_kern.lengths, chunk_plain.lengths),
            "first tokens": torch.equal(chunk_kern.token, chunk_plain.token)}
    print(f"batch chunked admission, kernel path (K2 at B=1, T=256 into scratch caches of "
          f"{sorted({-(-int(n) // 256) * 256 for n in kern.slot_len})} rows) against the plain path, "
          f"{int(rows.sum())} K and V rows below the slots' lengths; bit-equal: {same}")
    if not all(same.values()):
        raise AssertionError("chunked admission through K2 differs from its plain version")

    others = (plain, wide, chunk_kern, chunk_plain)
    for other in others:
        other.token.copy_(kern.token)
    fed, logits = [kern.token.clone()], {}
    for step in range(1, 17):
        for b in (kern, wide, chunk_kern):
            if b.step() != 16:
                raise AssertionError("a slot finished early")
        with _kernels.plain_versions():
            for b in (plain, chunk_plain):
                if b.step() != 16:
                    raise AssertionError("a slot finished early")
        if step in (1, 16):
            logits[step] = kern.last_logits.clone()
            cos_plain = slot_cosines(kern.last_logits, plain.last_logits)
            cos_wide = slot_cosines(kern.last_logits, wide.last_logits)
            cos_chunk = slot_cosines(chunk_kern.last_logits, chunk_plain.last_logits)
            cos_route = slot_cosines(chunk_kern.last_logits, kern.last_logits)
            print(f"batch step {step}: logits cosine, minimum over the 16 slots: kernel path vs "
                  f"plain path, admitted whole {float(cos_plain.min()):.6f}, admitted in chunks "
                  f"{float(cos_chunk.min()):.6f} (>= 0.999); chunked vs whole admission "
                  f"{float(cos_route.min()):.6f} (>= 0.999); int8 pools vs bf16 pools min "
                  f"{float(cos_wide.min()):.6f} median {float(cos_wide.median()):.6f} (>= 0.99)")
            if not (min(float(cos_plain.min()), float(cos_chunk.min()),
                        float(cos_route.min())) >= 0.999 and float(cos_wide.min()) >= 0.99
                    and bool(torch.isfinite(kern.last_logits).all())
                    and bool(torch.isfinite(chunk_kern.last_logits).all())):
                raise AssertionError("the batched kernel path disagrees")
        for other in others:
            other.token.copy_(kern.token)
        fed.append(kern.token.clone())

    # The two whole-prompt int8 runs' pools. Their K/V rows come from bf16
    # activations that differ in the last bits between the paths (K1 against
    # plain attention), so an int8 value may move by a few steps and a scale by
    # a bf16 ulp or two (0.4 to 0.8 % each): "every value within 1, every
    # scale within 1e-3" cannot hold between two bf16 paths. The gates sit just under
    # what this comparison reads on an H100 (0.9996 / 0.960 / one to two ulps),
    # so a wrong row write by K4 or by admission fails them.
    valid = valid_rows(kern, L)
    diff = (kern.kp.int() - plain.kp.int()).abs()[valid]
    rel = ((kern.ksp - plain.ksp).abs() / kern.ksp.clamp_min(1e-30))[valid]
    deq_k = pa.dequant_kv_pool(kern.kp, kern.ksp, torch.float32)[valid]
    deq_p = pa.dequant_kv_pool(plain.kp, plain.ksp, torch.float32)[valid]
    cos_rows = slot_cosines(deq_k, deq_p)
    within_1 = float((diff <= 1).float().mean())
    print(f"batch pools after 16 steps, the {int(valid.sum())} K and V rows below the slots' "
          f"lengths: int8 values max |diff| {int(diff.max())}, within 1: {within_1:.6f} of all "
          f"(>= 0.95); scales relative diff median {float(rel.median()):.2e}, max "
          f"{float(rel.max()):.2e} (<= 5e-2), within 1e-3: "
          f"{float((rel <= 1e-3).float().mean()):.4f}; dequantized rows cosine min "
          f"{float(cos_rows.min()):.6f} (>= 0.999), mean {float(cos_rows.mean()):.6f} (>= 0.9995)")
    if not (float(cos_rows.min()) >= 0.999 and float(cos_rows.mean()) >= 0.9995
            and within_1 >= 0.95 and float(rel.max()) <= 5e-2
            and torch.equal(kern.page_table, plain.page_table)
            and torch.equal(kern.lengths, plain.lengths)):
        raise AssertionError("the kernel path's pools disagree with the plain path's")
    # After the steps too, the chunked pair: the decode rows K4 wrote.
    rows = valid_rows(chunk_kern, L)
    cos_rows = slot_cosines(pa.dequant_kv_pool(chunk_kern.kp, chunk_kern.ksp, torch.float32)[rows],
                            pa.dequant_kv_pool(chunk_plain.kp, chunk_plain.ksp, torch.float32)[rows])
    print(f"batch pools after 16 steps, admitted in chunks: dequantized rows cosine min "
          f"{float(cos_rows.min()):.6f} (>= 0.999)")
    if not float(cos_rows.min()) >= 0.999:
        raise AssertionError("the chunked kernel path's pools disagree with the plain path's")
    return {"k2": k2, "fed": fed, "logits": logits}


# -- the writefirst decode step ------------------------------------------------------


def run_writefirst(model, cfg, seed: int) -> dict:
    """The fixed batch of 16, admitted whole, stepped 16 times by
    `_paged_step(mode="writefirst")` and by `mode="selfterm"` on two copies
    of its state, over bf16 split and int8 fused pools; both steps are fed
    the selfterm step's tokens, so that every step compares one sequence.
    Gates: logits cosine >= 0.999 per slot at every step; exactly 32 K3 and
    32 `paged_kv_update` launches per writefirst step and no all-layer row
    write. The greedy tokens' agreement is printed, not gated: on random
    full-width weights the top logits of a slot lie closer together than two
    bf16 arithmetic orders' difference (PERF.md, Findings), so a different
    token there is a tie broken apart; for each such flip the selfterm
    step's margin between the two tokens is printed beside the slot's
    largest logit difference. The CPU test holds the tokens equal (f32, tiny
    model).
    Returns the writefirst steps' launch counts."""
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve.paged import _paged_step

    L = cfg.decoder.num_layers
    requests = direct_requests(cfg, seed, 16)
    counts = {"k3": 0, "kvu": 0}
    for quant, fused, label in ((False, False, "bf16 split"), (True, True, "int8 fused")):
        b = admitted_batcher(model, cfg, requests, 16, kv_quant=quant, kv_fused=fused)
        active = torch.ones(16, dtype=torch.bool, device=b.device)
        state = {mode: [None if t is None else t.clone()
                        for t in (b.kp, b.vp, b.ksp, b.vsp, b.lengths, b.token)]
                 for mode in ("writefirst", "selfterm")}
        agree, cos_min, flips = [], 1.0, []
        for step in range(1, 17):
            state["writefirst"][5].copy_(state["selfterm"][5])
            out = {}
            for mode in ("writefirst", "selfterm"):
                kp, vp, ksp, vsp, lengths, token = state[mode]
                before = (pa.attn_launches, pa.update_launches, pa.rows_launches)
                _, logits = _paged_step(model, kp, vp, (ksp, vsp), b.page_table, lengths, token,
                                        active, None, cfg, b.sampling, mode=mode)
                got = (pa.attn_launches - before[0], pa.update_launches - before[1],
                       pa.rows_launches - before[2])
                if mode == "writefirst":
                    if got != (L, L, 0):
                        raise AssertionError(f"writefirst {label} step {step}: launches K3, "
                                             f"paged_kv_update, paged_kv_rows {got}, want "
                                             f"({L}, {L}, 0)")
                    counts["k3"] += got[0]
                    counts["kvu"] += got[1]
                out[mode] = (token.clone(), logits)
            cos = slot_cosines(out["writefirst"][1], out["selfterm"][1])
            cos_min = min(cos_min, float(cos.min()))
            (tok_w, log_w), (tok_s, log_s) = out["writefirst"], out["selfterm"]
            agree.append(int((tok_w == tok_s).sum()))
            for slot in torch.nonzero(tok_w != tok_s)[:, 0].tolist():
                margin = float(log_s[slot, tok_s[slot]] - log_s[slot, tok_w[slot]])
                flips.append((margin, float((log_w[slot] - log_s[slot]).abs().max())))
            if step in (1, 16):
                print(f"writefirst {label} step {step}: logits cosine against the selfterm step, "
                      f"minimum over the 16 slots {float(cos.min()):.6f} median "
                      f"{float(cos.median()):.6f} (>= 0.999); same greedy token on "
                      f"{agree[-1]} of 16 slots")
            if not (float(cos.min()) >= 0.999
                    and bool(torch.isfinite(out["writefirst"][1]).all())):
                raise AssertionError(f"writefirst {label} step {step}: disagrees with selfterm")
        same_lengths = torch.equal(state["writefirst"][4], state["selfterm"][4])
        print(f"writefirst {label}, 16 steps fed the selfterm step's tokens: logits cosine min "
              f"{cos_min:.6f} (>= 0.999 every step); same greedy token on {sum(agree)} of 256 "
              f"(per step {agree}); lengths equal {same_lengths}; launches per step K3 {L}, "
              f"paged_kv_update {L}, paged_kv_rows 0")
        if flips:
            print(f"writefirst {label}: the {len(flips)} different tokens, the selfterm step's "
                  f"margin between its token and writefirst's against the slot's largest logit "
                  f"difference: " + ", ".join(f"{m:.4f}/{d:.4f}" for m, d in flips))
        if not same_lengths:
            raise AssertionError(f"writefirst {label}: lengths differ from the selfterm step's")
        del b, state, out
        torch.cuda.empty_cache()
    return counts


def device_items(prof, n: int):
    """Kernel rows of a torch.profiler run of `n` steps: [(name, ms per step,
    launches per step)], largest first, and their sum (device busy per step;
    one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType

    def device_us(e):  # the attribute's name changed between PyTorch releases
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # Kernel rows only: an operator's row repeats the time of the kernels it launched.
    rows = [(e.key, device_us(e) / 1e3 / n, e.count / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


def run_step_profile(model, cfg, seed: int, card: str) -> None:
    """One 32-slot decode step (int8 fused pools) in each mode, side by side
    on one batch: wall (host clock around steps that end in a synchronize,
    the modes taken in turns), device busy, idle share and the largest device
    items (torch.profiler), and `paged_kv_update`'s device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    from vis_zephyr_tpu_torch.serve.paged import _paged_step

    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True)
    active = torch.ones(32, dtype=torch.bool, device=b.device)
    modes = ("writefirst", "selfterm")

    def step(mode):
        _paged_step(model, b.kp, b.vp, (b.ksp, b.vsp), b.page_table, b.lengths, b.token, active,
                    None, cfg, b.sampling, mode=mode)

    for mode in modes * 2:
        step(mode)
    torch.cuda.synchronize()
    walls = {mode: [] for mode in modes}
    for _ in range(8):
        for mode in modes:
            t0 = time.perf_counter()
            step(mode)
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1e3)
    n = 4
    for mode in modes:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(mode)
            torch.cuda.synchronize()
        rows, busy = device_items(prof, n)
        wall = statistics.median(walls[mode])
        print(f"writefirst profile: {mode} decode step, B=32 active slots, int8 fused pools, "
              f"lengths about {int(b.lengths.float().mean())}: wall median {wall:.2f} ms (8 steps, "
              f"min {min(walls[mode]):.2f}, max {max(walls[mode]):.2f}), device busy {busy:.2f} "
              f"ms per step, idle share {1 - busy / wall:.2f} [{card}]")
        for key, ms, count in rows[:8]:
            print(f"writefirst profile:   {ms:8.3f} ms  {count:6.1f} launches/step  {key[:90]}")
        for key, ms, count in rows:
            if "paged_kv_rows_kernel" in key:
                print(f"writefirst profile: {mode}: K4 (`paged_kv_rows_kernel`) {ms:.4f} ms per "
                      f"step over {count:.1f} launches: {ms / count * 1e3:.2f} us per launch on "
                      f"the device [{card}]")
        if busy <= 0:
            print("writefirst profile: the profiler reported no device time")


# -- the fused int8 MLP matvec probe (K9) -------------------------------------------------


def run_mlp_layer(mlp, hidden: int, norm_weight, eps: float, label: str, card: str) -> None:
    """K9 on one int8 decoder layer's MLP, as `--load-8bit` leaves it, at M = 1
    against `mlp(hn)` (the K5 route, which rounds g, u and their product to
    bf16 each, where K9 rounds h once): cosine >= 0.999."""
    from vis_zephyr_tpu_torch.experiments import fused_mlp_matvec_probe as probe
    from vis_zephyr_tpu_torch.models.mistral import rms_norm

    gen = torch.Generator("cuda").manual_seed(7)
    h = torch.randn(1, hidden, generator=gen, device="cuda").to(torch.bfloat16)
    hn = rms_norm(h, norm_weight, eps)
    got = probe.fused_mlp_matvec(hn, *probe.quantized_mlp_weights(mlp))
    want = mlp(hn)
    torch.cuda.synchronize()
    a = probe.agreement(got, want)
    print(f"mlp_probe: K9 on {label} at M=1 against layer.mlp(hn): cosine {a['cosine']:.6f} "
          f"(>= 0.999), max-abs over max |mlp(hn)| {a['rel_err']:.3e} [{card}]")
    if not (a["cosine"] >= 0.999 and bool(torch.isfinite(got.float()).all())):
        raise AssertionError(f"mlp_probe: K9 disagrees with {label}'s mlp")


def standalone_int8_mlp(seed: int):
    """A full-width decoder MLP with random bf16 weights from `seed`
    (PyTorch's fan-in init), quantized as `load_8bit` quantizes a layer."""
    from vis_zephyr_tpu_torch.config import VisZephyrConfig
    from vis_zephyr_tpu_torch.models.mistral import MistralMLP
    from vis_zephyr_tpu_torch.ops.quant import quantize_linear

    dec = VisZephyrConfig().decoder
    torch.manual_seed(seed)
    mlp = MistralMLP(dec, device="cuda", dtype=torch.bfloat16)
    for name in ("gate_proj", "up_proj", "down_proj"):
        setattr(mlp, name, quantize_linear(getattr(mlp, name)))
    return mlp, dec.hidden_size, torch.ones(dec.hidden_size, device="cuda",
                                            dtype=torch.bfloat16), dec.rms_norm_eps


def quantize_model(seed: int, card: str, bits: int = 8):
    """The full-width model with random bf16 weights from `seed` (the same as
    the bf16 phases'), quantized in place by `load_8bit`'s (`bits` 8) or
    `load_4bit`'s (`bits` 4) step (`models/builder.py::quantize_weights`):
    decoder layers in `bits`, Q-Former projections in int8, one layer at a
    time."""
    from vis_zephyr_tpu_torch.models.builder import quantize_weights

    model, cfg = build_model(seed)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    quantize_weights(model, bits=bits)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    def gib(module):
        return sum(t.numel() * t.element_size()
                   for t in list(module.parameters()) + list(module.buffers())) / 2**30

    decoder = model.decoder
    layers = gib(decoder.model.layers)
    kept = gib(decoder) - layers
    flag = f"load_{bits}bit"
    print(f"int{bits}: {flag} quantized the decoder layers and the Q-Former in {seconds:.1f} s; "
          f"device memory {before / 2**30:.2f} GiB before, {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB after, peak while quantizing {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"weights: vision {gib(model.vision):.2f} GiB bf16, Q-Former {gib(model.projector):.2f} "
          f"GiB int8, decoder layers {layers:.2f} GiB int{bits}, embed + lm_head + norms "
          f"{kept:.2f} GiB bf16; in all {gib(model):.2f} GiB [{card}]")
    if weight_bits(model) != bits:
        raise AssertionError(f"{flag} left the decoder in another form")
    return model, cfg


def run_fixed_batch_quant(model, cfg, seed: int, bf16: dict, card: str, int8=None) -> dict:
    """The fixed batch of 16 on quantized weights, admitted whole: the kernel
    path against the plain path, and against the bf16 weights' kernel path
    (and, on int4 weights, the int8 one's), all fed the bf16 run's tokens;
    K5, K6 and dequantize-route counts exact. Returns the kernel path's
    logits at steps 1 and 16."""
    from vis_zephyr_tpu_torch.ops import _kernels

    bits = weight_bits(model)
    label = f"int{bits} batch"
    requests = direct_requests(cfg, seed, 16)
    int8_fused = dict(kv_quant=True, kv_fused=True)
    reset_routes()
    kern = admitted_batcher(model, cfg, requests, 16, **int8_fused)
    admitted = read_routes()
    # Whole admission: one Q-Former pass and one prefill per prompt, of its
    # spliced rows (the prompt without its sentinel and 4 crops' tokens)
    # padded to 128.
    want = expected_routes(
        model, add_routes(*(qformer_routes(cfg, px.shape[0], len(ids) - 1) for ids, px, _ in requests)),
        add_routes(*(decoder_routes(cfg, -(-(len(ids) - 1 + px.shape[0] * cfg.tokens_per_patch)
                                          // 128) * 128) for ids, px, _ in requests)))
    lengths = sorted(int(n) for n in kern.slot_len)
    with _kernels.plain_versions():
        plain = admitted_batcher(model, cfg, requests, 16, **int8_fused)
    reset_routes()
    logits = {}
    for step in range(1, 17):
        for b in (kern, plain):
            b.token.copy_(bf16["fed"][step - 1])
        if kern.step() != 16:
            raise AssertionError("a slot finished early")
        counted = read_routes()
        with _kernels.plain_versions():
            if plain.step() != 16:
                raise AssertionError("a slot finished early")
        if read_routes() != counted:
            raise AssertionError("the plain path launched a kernel")
        if step in (1, 16):
            logits[step] = kern.last_logits.clone()
            cos_plain = slot_cosines(kern.last_logits, plain.last_logits)
            cos_bf16 = slot_cosines(kern.last_logits, bf16["logits"][step])
            line = (f"{label} step {step}: logits cosine, minimum over the 16 slots: kernel path vs "
                    f"plain path {float(cos_plain.min()):.6f} (>= 0.999); int{bits} weights vs bf16 "
                    f"weights min {float(cos_bf16.min()):.6f} median {float(cos_bf16.median()):.6f}")
            if bits == 8:
                # int8 against bf16 weights read 0.998075 to 0.998123 (min over
                # slots) on an H100: the gate sits just under that.
                line += " (>= 0.997)"
                good = float(cos_bf16.min()) >= 0.997
            else:
                # Random weights say nothing of int4's quality (its rounding
                # step is about 13 times int8's): read, not gated.
                good = True
                if int8 is not None:
                    cos_int8 = slot_cosines(kern.last_logits, int8[step])
                    line += (f"; vs int8 weights min {float(cos_int8.min()):.6f} median "
                             f"{float(cos_int8.median()):.6f} (not gated)")
            print(line)
            if not (float(cos_plain.min()) >= 0.999 and good
                    and bool(torch.isfinite(kern.last_logits).all())):
                raise AssertionError(f"the int{bits} kernel path disagrees")
    stepped = read_routes()
    want_steps = expected_routes(model, (0, 0), decoder_routes(cfg, 16, 16))
    print(f"{label} counters: admission of 16 prompts {lengths} tokens long: "
          f"{show_routes(admitted, want)}; 16 decode steps at M=16: "
          f"{show_routes(stepped, want_steps)}; peak device memory since load_{bits}bit "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if admitted != want or stepped != want_steps:
        raise AssertionError(f"the int{bits} batch did not go through the kernels as counted")
    return logits


# -- speculative decoding (--lookahead) -------------------------------------------------

SPEC_LOOKAHEAD = 4
# Questions that repeat themselves, so that prompt lookup finds n-grams to copy.
SPEC_QUESTIONS = ("what is the man with the red hat doing and what is the man with the red hat "
                  "holding", "count the cars on the street and say which of the cars on the "
                  "street is the largest of the cars")


def first_divergence(a, b) -> int:
    """How many leading tokens two streams share."""
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def run_spec_dense(model, cfg, seed: int, max_new_tokens: int, card: str) -> dict:
    """The dense path with `lookahead` 4 and 0 in one call: two /chat requests
    each (two sessions, one anyres image each) through the port's server.
    Exact counts: K1 once per layer per request; K2 once per layer per verify
    call (lookahead 4) or per decode step (lookahead 0). Prints how far the
    two streams agree (bf16: a verify's S-row append and a decode step round
    differently, so greedy ties may break apart), proposals and acceptance,
    tokens per verify call, TTFT and tokens/s."""
    import numpy as np

    from vis_zephyr_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve import generate as gen
    from vis_zephyr_tpu_torch.serve.engine import ChatEngine

    L = cfg.decoder.num_layers
    side = cfg.vision.image_size
    rng = np.random.default_rng(seed + 3)
    images = [session_pixels(rng, side, 3) for _ in SPEC_QUESTIONS]
    out = {}
    for lookahead in (SPEC_LOOKAHEAD, 0):
        engine = ChatEngine(model, cfg, WordTokenizer(cfg.decoder.vocab_size),
                            max_new_tokens=max_new_tokens, lookahead=lookahead)
        for i, (px, valid) in enumerate(images):
            engine.attach_pixels(f"d{i}", px, valid, (2 * side, side))
        server, thread = start_server(engine)
        try:
            fa.launches = kv_cache.launches = 0
            gen.verify_calls = gen.proposed = gen.accepted = 0
            results = [post_chat(server.server_address[1], {
                "session_id": f"d{i}", "question": f"{DEFAULT_IMAGE_TOKEN}\n{q}"})
                for i, q in enumerate(SPEC_QUESTIONS)]
            counts = dict(k1=fa.launches, k2=kv_cache.launches, verify_calls=gen.verify_calls,
                          proposed=gen.proposed, accepted=gen.accepted)
        finally:
            stop_server(server, thread)
        streams = []
        for status, text, ttft, total in results:
            words = text.split()
            if status != 200 or len(words) != max_new_tokens:
                raise AssertionError(f"spec dense, lookahead {lookahead}: HTTP {status}, "
                                     f"{len(words)} tokens (want {max_new_tokens})")
            streams.append([int(w[1:]) for w in words])
        n = len(results)
        decode = n * (max_new_tokens - 1)
        passes = counts["verify_calls"] if lookahead else decode
        if counts["k1"] != L * n or counts["k2"] != L * passes or (lookahead and passes == 0):
            raise AssertionError(f"spec dense, lookahead {lookahead}: counts {counts} (want K1 "
                                 f"{L * n}, K2 {L} x {passes} decoder passes, verify calls > 0)")
        ttfts = [r[2] for r in results]
        rates = [(max_new_tokens - 1) / (r[3] - r[2]) for r in results]
        line = (f"spec dense, lookahead {lookahead}: {n} requests, {max_new_tokens} tokens each; "
                f"K1 {counts['k1']} (want {L * n}), K2 {counts['k2']} (want {L} x {passes} "
                f"{'verify calls' if lookahead else 'decode steps'}); TTFT "
                f"{', '.join(f'{t * 1e3:.1f}' for t in ttfts)} ms, decode "
                f"{', '.join(f'{r:.2f}' for r in rates)} tokens/s")
        if lookahead:
            line += (f"; {counts['proposed']} tokens proposed, {counts['accepted']} accepted, "
                     f"{decode / passes:.3f} tokens per verify call")
        print(line + f" [{card}]")
        out[lookahead] = dict(counts, streams=streams, ttft=ttfts, rates=rates)
    agree = [first_divergence(a, b) for a, b in zip(out[SPEC_LOOKAHEAD]["streams"], out[0]["streams"])]
    print(f"spec dense: the lookahead {SPEC_LOOKAHEAD} and lookahead 0 streams agree on their first "
          f"{agree} of {max_new_tokens} tokens")
    return {"k1": out[SPEC_LOOKAHEAD]["k1"], "k2": out[SPEC_LOOKAHEAD]["k2"],
            "agree": agree, **{k: out[SPEC_LOOKAHEAD][k] for k in ("verify_calls", "proposed",
                                                                   "accepted")}}


def fixed_proposals(b, S: int) -> torch.Tensor:
    """toks [B, S]: each slot's pending token, then the S - 1 tokens that
    followed an earlier occurrence of it in the slot's prompt (prompt lookup
    on one token; the prompt's own next tokens when it has none)."""
    import numpy as np

    toks = np.zeros((b.max_slots, S), np.int64)
    for slot in range(b.max_slots):
        hist = np.asarray(b.slot_hist[slot])
        hits = np.flatnonzero(hist[:-1] == hist[-1])
        start = int(hits[-1]) + 1 if len(hits) else 0
        cont = hist[start:start + S - 1]
        toks[slot, 0] = hist[-1]
        toks[slot, 1:1 + len(cont)] = cont
    return torch.as_tensor(toks, device=b.device)


def run_spec_batch(model, cfg, seed: int) -> dict:
    """One verify step (S = 5, fixed proposals) of 16 slots admitted whole, on
    clones of the pools, over int8 fused and bf16 split pools: the kernel
    path against the plain path (cosine >= 0.999 on every column), and column
    0 against `_paged_step`'s logits from the same pool state (>= 0.999 over
    bf16 pools; >= 0.99 over int8, where the verify attends its own row
    quantized and the decode step folds it in unquantized). Counts exact: K3
    and K4's `paged_kv_update_layer` once per layer, no all-layer write."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve.paged import _paged_step, _paged_verify_body

    L = cfg.decoder.num_layers
    S = SPEC_LOOKAHEAD + 1
    requests = direct_requests(cfg, seed, 16)
    out = {}
    for quant, fused, label, floor in ((True, True, "int8 fused", 0.99),
                                       (False, False, "bf16 split", 0.999)):
        b = admitted_batcher(model, cfg, requests, 16, kv_quant=quant, kv_fused=fused)
        toks = fixed_proposals(b, S)
        active = torch.ones(16, dtype=torch.bool, device=b.device)

        def pools():
            return [None if t is None else t.clone() for t in (b.kp, b.vp, b.ksp, b.vsp)]

        kp, vp, ksp, vsp = pools()
        pa.attn_launches = pa.rows_launches = pa.update_launches = 0
        _, logits_k = _paged_verify_body(model, kp, vp, (ksp, vsp), b.page_table,
                                         b.lengths.clone(), toks, active, cfg)
        counts = (pa.attn_launches, pa.rows_launches, pa.update_launches)
        kp, vp, ksp, vsp = pools()
        with _kernels.plain_versions():
            _, logits_p = _paged_verify_body(model, kp, vp, (ksp, vsp), b.page_table,
                                             b.lengths.clone(), toks, active, cfg)
        kp, vp, ksp, vsp = pools()
        _, logits_d = _paged_step(model, kp, vp, (ksp, vsp), b.page_table, b.lengths.clone(),
                                  toks[:, 0].clone(), active, None, cfg, b.sampling)
        torch.cuda.synchronize()
        cols = [float(slot_cosines(logits_k[:, j], logits_p[:, j]).min()) for j in range(S)]
        col0 = slot_cosines(logits_k[:, 0], logits_d)
        same_top1 = float((logits_k[:, 0].argmax(-1) == logits_d.argmax(-1)).float().mean())
        print(f"spec batch, {label} pools, 16 slots, one verify step of S={S}: logits cosine, "
              f"minimum over slots, kernel vs plain path per column "
              f"{', '.join(f'{c:.6f}' for c in cols)} (>= 0.999); column 0 vs the decode step "
              f"min {float(col0.min()):.6f} median {float(col0.median()):.6f} (>= {floor}), same "
              f"top-1 on {same_top1:.3f} of slots; launches K3 {counts[0]} (want {L}), "
              f"paged_kv_rows {counts[1]} (want 0), paged_kv_update {counts[2]} (want {L})")
        if not (min(cols) >= 0.999 and float(col0.min()) >= floor
                and bool(torch.isfinite(logits_k).all()) and counts == (L, 0, L)):
            raise AssertionError(f"spec batch {label}: the verify step disagrees or miscounted")
        out[label] = dict(cols=cols, col0=float(col0.min()))
        del b, kp, vp, ksp, vsp, logits_k, logits_p, logits_d
        torch.cuda.empty_cache()
    return out


VERIFY_STEPS = 5  # consecutive verify steps compared: the capture's warm-up, then replays


def run_verify_replay(model, cfg, seed: int, card: str) -> dict:
    """The verify steps of both served paths replayed as CUDA graphs against
    the same steps run eagerly on the kernel path, bit for bit, over
    VERIFY_STEPS consecutive steps (the first the capture's warm-up, the
    rest replays) with the host's acceptance and rollback between them;
    then each form's wall, device busy and idle share (printed, not gated),
    the captures' host time and the graph pools' memory.

    Paged: two batchers of 32 slots (int8 KV-fused pools, S = 5), the second
    given the first's admitted state; the first steps as served
    (`PagedBatcher.step`, its verify step a replay over `verify_buffers`),
    the second through `_paged_verify_body` run eagerly; after each step the
    logits, pools, lengths, pending tokens and the host's streams equal; K3
    and K4 32 launches a step on each, no all-layer write. Dense: a
    repetitive text prompt prefilled into two caches; `verify_step`
    (replays over the first) against `decode_verify` on the second, with the
    same prompt-lookup proposals and rollback: greedy tokens, logits, K, V
    and lengths equal after each step; K2 32 launches and one verify call a
    step on each."""
    import numpy as np

    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve import generate as gen
    from vis_zephyr_tpu_torch.serve.graphs import StepGraphs
    from vis_zephyr_tpu_torch.serve.paged import _paged_verify_body

    L = cfg.decoder.num_layers
    S = SPEC_LOOKAHEAD + 1
    out = {}
    requests = direct_requests(cfg, seed, 32)
    extra = dict(lookahead=SPEC_LOOKAHEAD, max_new_tokens=512, num_pages=1 + 32 * 16)
    served = admitted_batcher(model, cfg, requests, 32, kv_quant=True, kv_fused=True, **extra)
    eager = admitted_batcher(model, cfg, requests, 32, kv_quant=True, kv_fused=True, **extra)

    def device_state(b):
        return [t for t in (b.kp, b.vp, b.ksp, b.vsp, b.page_table, b.lengths, b.token)
                if t is not None]

    for mine, theirs in zip(device_state(eager), device_state(served)):
        mine.copy_(theirs)  # the same start, whatever the two admissions rounded

    def eager_verify(toks, valid):
        toks_dev, active_dev = eager.verify_buffers(S)
        toks_dev.copy_(torch.from_numpy(toks))
        active_dev.copy_(torch.from_numpy(eager.active))
        greedy, eager.last_logits = _paged_verify_body(
            model, eager.kp, eager.vp, (eager.ksp, eager.vsp), eager.page_table, eager.lengths,
            toks_dev, active_dev, cfg)
        return greedy.cpu().numpy()

    eager._verify_device = eager_verify
    pa.attn_launches = pa.rows_launches = pa.update_launches = 0
    steps = []
    for _ in range(VERIFY_STEPS):
        served.step()
        eager.step()
        steps.append(dict(
            logits=torch.equal(served.last_logits, eager.last_logits),
            device=all(torch.equal(x, y) for x, y in zip(device_state(served),
                                                          device_state(eager))),
            host=(served.slot_len.tolist() == eager.slot_len.tolist()
                  and [list(h) for h in served.slot_hist] == [list(h) for h in eager.slot_hist])))
    counts = (pa.attn_launches, pa.rows_launches, pa.update_launches)
    want = (2 * L * VERIFY_STEPS, 0, 2 * L * VERIFY_STEPS)
    equal = {key: all(step[key] for step in steps) for key in ("logits", "device", "host")}
    print(f"spec verify replay, paged: 32 slots, int8 fused pools, S={S}: {VERIFY_STEPS} verify "
          f"steps as served (the first the capture's warm-up, then replays) against "
          f"{VERIFY_STEPS} eager kernel-path steps from the same state, acceptance and rollback "
          f"between them: bit-equal {equal} (logits, pools, page table, lengths and pending "
          f"tokens; the host's streams); {served.accepted} of {served.proposed} proposals "
          f"accepted; K3 {counts[0]}, paged_kv_rows {counts[1]}, paged_kv_update {counts[2]} "
          f"(want {want}); capture {served.graphs.capture_seconds:.2f} s of host time, graph "
          f"pools {served.graphs.pool_bytes() / 2**20:.1f} MiB (the decode step's none: no "
          f"decode step ran) [{card}]", flush=True)
    if not all(equal.values()) or counts != want:
        raise AssertionError(f"spec verify replay, paged: the replayed verify step disagrees with "
                             f"the eager one or miscounted: {steps}, {counts}")
    for name, b in (("replayed", served), ("eager", eager)):
        got = profile_step(b.step, warm=2, timed=8, profiled=4)
        out[f"paged_{name}"] = {k: v for k, v in got.items() if k != "items"}
        print(f"spec verify replay, paged, {name} verify step, B=32, S={S}: wall "
              f"{got['wall_ms']:.2f} ms (min {got['wall_min_ms']:.2f}, max {got['wall_max_ms']:.2f}),"
              f" device busy {got['device_ms']:.2f} ms, idle share {got['idle_share']:.2f}, "
              f"{got['launches']:.1f} kernel launches a step [{card}]", flush=True)
        if int(b.active.sum()) != 32:
            raise AssertionError("spec verify replay: a slot finished inside the timed steps")
    out["paged_pool_mib"] = served.graphs.pool_bytes() / 2**20
    del served, eager
    torch.cuda.empty_cache()

    # The serialized path: B = 1 over a dense cache.
    rng = np.random.default_rng(seed + 6)
    ids = np.tile(rng.integers(3, cfg.decoder.vocab_size, (1, 12)), (1, 8))
    ids_t = torch.from_numpy(ids).cuda()
    last, cache, _ = gen.prefill(model, ids_t, None, None, cfg, 512)
    other = {name: t.clone() for name, t in cache.items()}
    graphs = StepGraphs()
    history, tok = ids[0].tolist(), int(last.argmax(-1)[0])
    kv_cache.launches = gen.verify_calls = 0
    dense_steps, accepted = [], 0
    for _ in range(VERIFY_STEPS):
        prop = gen._propose_lookup(np.asarray(history), span=SPEC_LOOKAHEAD)
        prop = np.zeros((0,), np.int64) if prop is None else np.asarray(prop, np.int64)
        toks = np.zeros((1, S), np.int64)
        toks[0, 0], toks[0, 1:1 + len(prop)] = tok, prop
        valid = np.zeros((1, S), bool)
        valid[0, :1 + len(prop)] = True
        base = cache["length"].clone()
        greedy_r, logits_r = gen.verify_step(model, cache, torch.from_numpy(toks),
                                             torch.from_numpy(valid), cfg, graphs)
        logits_e, _ = gen.decode_verify(model, other, torch.from_numpy(toks).cuda(),
                                        torch.from_numpy(valid).cuda(), cfg)
        greedy_e = torch.argmax(logits_e, dim=-1)
        greedy = greedy_r[0].tolist()
        n_ok = 0
        while n_ok < len(prop) and greedy[n_ok] == prop[n_ok]:
            n_ok += 1
        accepted += n_ok
        check = dict(greedy=torch.equal(greedy_r, greedy_e), logits=torch.equal(logits_r, logits_e))
        cache["length"].copy_(base + 1 + n_ok)
        other["length"].copy_(base + 1 + n_ok)
        check.update({name: torch.equal(cache[name], other[name]) for name in ("k", "v", "length")})
        dense_steps.append(check)
        emitted = [int(t) for t in prop[:n_ok]] + [greedy[n_ok]]
        history += emitted
        tok = emitted[-1]
    dense_counts = (kv_cache.launches, gen.verify_calls)
    dense_want = (2 * L * VERIFY_STEPS, 2 * VERIFY_STEPS)
    dense_equal = {key: all(step[key] for step in dense_steps) for key in dense_steps[0]}
    print(f"spec verify replay, dense: B=1, a repetitive prompt of {ids.shape[1]} tokens, "
          f"S={S}: {VERIFY_STEPS} verify steps (`verify_step`: the warm-up, then replays) against "
          f"{VERIFY_STEPS} eager `decode_verify`s with the same proposals and rollback: bit-equal "
          f"{dense_equal}; {accepted} proposals accepted; K2 {dense_counts[0]}, verify calls "
          f"{dense_counts[1]} (want {dense_want}); capture {graphs.capture_seconds:.2f} s, graph "
          f"pool {graphs.pool_bytes() / 2**20:.1f} MiB [{card}]", flush=True)
    if not all(dense_equal.values()) or dense_counts != dense_want:
        raise AssertionError(f"spec verify replay, dense: the replayed verify step disagrees "
                             f"with the eager one or miscounted: {dense_steps}, {dense_counts}")
    toks_t = torch.from_numpy(toks)
    valid_t = torch.from_numpy(valid)

    def replayed():
        base = cache["length"].clone()
        gen.verify_step(model, cache, toks_t, valid_t, cfg, graphs)[0].tolist()
        cache["length"].copy_(base)

    def eager_step():
        base = other["length"].clone()
        logits, _ = gen.decode_verify(model, other, toks_t.cuda(), valid_t.cuda(), cfg)
        torch.argmax(logits, dim=-1).tolist()
        other["length"].copy_(base)

    for name, step in (("replayed", replayed), ("eager", eager_step)):
        got = profile_step(step, warm=2, timed=8, profiled=4)
        out[f"dense_{name}"] = {k: v for k, v in got.items() if k != "items"}
        print(f"spec verify replay, dense, {name} verify step, B=1, S={S}: wall "
              f"{got['wall_ms']:.2f} ms (min {got['wall_min_ms']:.2f}, max {got['wall_max_ms']:.2f}),"
              f" device busy {got['device_ms']:.2f} ms, idle share {got['idle_share']:.2f}, "
              f"{got['launches']:.1f} kernel launches a step [{card}]", flush=True)
    del cache, other, graphs
    torch.cuda.empty_cache()
    return out


# -- multi-step bursts (--multi-step) ------------------------------------------------------

BURST_STEPS = 8             # the fixed batch's compared steps, and the served bursts' size
BURST_SIZES = (1, 4, 8, 16)  # the timed bursts


def first_differences(a: torch.Tensor, b: torch.Tensor) -> dict:
    """{slot: first step where toks a and b [n, B] differ}."""
    diff = (a != b).cpu()
    return {slot: int(torch.nonzero(diff[:, slot])[0, 0]) + 1
            for slot in range(diff.shape[1]) if bool(diff[:, slot].any())}


def run_burst_batch(model, cfg, seed: int, card: str) -> dict:
    """A fixed batch of 32 slots (int8 KV-fused pools, the profile's shape):
    eight graph-replayed steps (`_paged_multi_step` bursts of one, the graph
    captured first and the state put back in place) against eight eager
    `_paged_step`s on the kernel path, on clones of its state: tokens equal
    on every slot at every step and logits cosine >= 0.999 per slot per step
    (a slot whose token differs is printed with its step and compared no
    further; any such slot fails the phase); K3 and K4 counted exactly, a
    replay as a launch. Then a burst of 8 (graphs) against the same burst
    under `plain_versions()` (eager, plain kernels): each slot's first
    differing token printed (bf16 ties between two arithmetic orders),
    logits cosine >= 0.999 at the last step on the slots that never
    differed, at least half of the slots without a difference."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve.graphs import StepGraphs
    from vis_zephyr_tpu_torch.serve.paged import _paged_multi_step, _paged_step

    L = cfg.decoder.num_layers
    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True)
    active = torch.ones(32, dtype=torch.bool, device=b.device)
    left = torch.full((32,), 64, dtype=torch.int32, device=b.device)
    admitted = [b.kp, b.vp, b.ksp, b.vsp, b.lengths, b.token]

    def clone():
        return [None if t is None else t.clone() for t in admitted]

    def burst(state, n, graphs):
        kp, vp, ksp, vsp, lengths, token = state
        return _paged_multi_step(model, kp, vp, (ksp, vsp), b.page_table, lengths, token, active,
                                 left, None, cfg, b.sampling, n=n, graphs=graphs)

    graphed, eager, graphs = clone(), clone(), StepGraphs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    burst(graphed, 1, graphs)  # the warm-up step, then the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    for t, a in zip(graphed, admitted):
        if t is not None:
            t.copy_(a)  # in place: the graph keeps reading these buffers
    before = (pa.attn_launches, pa.rows_launches)
    diverged, cos_min = {}, 1.0
    for step in range(1, BURST_STEPS + 1):
        toks, _, logits_g = burst(graphed, 1, graphs)
        kp, vp, ksp, vsp, lengths, token = eager
        tok_e, logits_e = _paged_step(model, kp, vp, (ksp, vsp), b.page_table, lengths, token,
                                      active, None, cfg, b.sampling)
        cos = slot_cosines(logits_g, logits_e).tolist()
        same = (toks[0] == tok_e).tolist()
        for slot in range(32):
            if slot in diverged:
                continue
            cos_min = min(cos_min, cos[slot])
            if not same[slot]:
                diverged[slot] = step
                print(f"multistep batch: slot {slot} differs at step {step}: graph token "
                      f"{int(toks[0, slot])}, eager {int(tok_e[slot])}, logits cosine "
                      f"{cos[slot]:.6f}")
    counted = (pa.attn_launches - before[0], pa.rows_launches - before[1])
    want = (2 * BURST_STEPS * L, 2 * BURST_STEPS)
    same_pools = all(torch.equal(g, e) for g, e in zip(graphed, eager) if g is not None)
    same_lengths = torch.equal(graphed[4], eager[4])
    print(f"multistep batch: 32 slots, lengths about {int(b.slot_len.mean())}, int8 fused pools: "
          f"{BURST_STEPS} graph-replayed steps against {BURST_STEPS} eager kernel-path steps: tokens "
          f"equal on {32 - len(diverged)} of 32 slots at every step, logits cosine min "
          f"{cos_min:.6f} (>= 0.999); lengths equal {same_lengths}, pools and scales bit-equal "
          f"{same_pools}; K3 {counted[0]} and K4 {counted[1]} launches (want {want[0]} and "
          f"{want[1]}: the replays' and the eager steps'); warm-up step and capture "
          f"{capture_s:.2f} s, graph pool {graphs.pool_bytes() / 2**20:.1f} MiB [{card}]")
    if diverged or not cos_min >= 0.999 or not same_lengths or counted != want:
        raise AssertionError("multistep batch: the replayed step disagrees with the eager step")

    # A burst of 8 on graphs against 8 eager kernel-path steps with the carry
    # kept on the host, budgets of 1 to 9 and an EOS falling inside the burst.
    probe = clone()
    for _ in range(3):
        tok3, _ = _paged_step(model, *probe[:2], tuple(probe[2:4]), b.page_table, probe[4],
                              probe[5], active, None, cfg, b.sampling)
    sampling = dataclasses.replace(b.sampling, eos_token_id=int(tok3[5]))
    budgets = torch.tensor([1 + slot % 9 for slot in range(32)], dtype=torch.int32,
                           device=b.device)
    graphed, eager = clone(), clone()
    before = (pa.attn_launches, pa.rows_launches)
    kp, vp, ksp, vsp, lengths, token = graphed
    toks_g, entry_g, logits_g = _paged_multi_step(
        model, kp, vp, (ksp, vsp), b.page_table, lengths, token, active, budgets, None, cfg,
        sampling, n=BURST_STEPS, graphs=StepGraphs())
    kp, vp, ksp, vsp, lengths, token = eager
    alive, left, want_toks, want_entry = active.clone(), budgets.clone(), [], []
    for _ in range(BURST_STEPS):
        want_entry.append(alive.clone())
        tok, logits_e = _paged_step(model, kp, vp, (ksp, vsp), b.page_table, lengths, token,
                                    alive, None, cfg, sampling)
        want_toks.append(tok.clone())
        left -= 1
        alive = alive & (tok != sampling.eos_token_id) & (left > 0)
    counted_burst = (pa.attn_launches - before[0], pa.rows_launches - before[1])
    checks = dict(tokens=torch.equal(toks_g, torch.stack(want_toks)),
                  entry_alive=torch.equal(entry_g, torch.stack(want_entry)),
                  lengths=torch.equal(graphed[4], eager[4]),
                  pools=all(torch.equal(g, e) for g, e in zip(graphed, eager) if g is not None),
                  counts=counted_burst == want)
    ended = int((~alive).sum())
    print(f"multistep batch: a burst of {BURST_STEPS} on graphs (the warm-up step, then "
          f"{BURST_STEPS - 1} replays) against {BURST_STEPS} eager kernel-path steps with the "
          f"carry on the host, budgets 1 to 9 and EOS {sampling.eos_token_id}: {ended} of 32 "
          f"slots ended inside it; equal {checks}; last logits bit-equal "
          f"{torch.equal(logits_g, logits_e)}, max abs difference "
          f"{float((logits_g - logits_e).abs().max()):.3g} [{card}]")
    if not all(checks.values()):
        raise AssertionError("multistep batch: the graph burst's carry disagrees with the eager "
                             f"steps: {checks}")

    kern, plain = clone(), clone()
    toks_k, alive_k, logits_k = burst(kern, BURST_STEPS, StepGraphs())
    with _kernels.plain_versions():
        toks_p, alive_p, logits_p = burst(plain, BURST_STEPS, None)
    firsts = first_differences(toks_k, toks_p)
    kept = [slot for slot in range(32) if slot not in firsts]
    cos = slot_cosines(logits_k, logits_p)[kept] if kept else torch.zeros(1)
    print(f"multistep batch: a burst of {BURST_STEPS} (graph replays) against the same burst under "
          f"plain_versions(): {len(kept)} of 32 slots equal at every step; the others' first "
          f"different step {firsts}; last-step logits cosine on the equal slots min "
          f"{float(cos.min()):.6f} (>= 0.999); alive masks equal {torch.equal(alive_k, alive_p)}")
    if len(kept) < 16 or not float(cos.min()) >= 0.999 or not torch.equal(alive_k, alive_p):
        raise AssertionError("multistep batch: the graph burst disagrees with the plain burst")
    del b, graphed, eager, probe, kern, plain, graphs
    torch.cuda.empty_cache()
    return {"k3": counted[0], "k4": counted[1], "capture_s": capture_s}


def run_burst_dense(model, cfg, seed: int, max_new_tokens: int, card: str) -> dict:
    """The B = 1 dense step replayed against the eager `decode_step` on the
    kernel path, bit for bit: a text prompt prefilled once, a burst of 1
    (the warm-up step and the capture) and a burst of 8 replays on the
    cache, 9 eager steps on a clone of it; tokens, K, V and lengths equal.
    Then two dense /chat requests through the server started with
    `--multi-step 8`, and the same two with `--multi-step 1` (bursts of
    one): K1 once a layer a request, K2 once a layer a decode step (every
    step of a burst counted), exactly, and the two runs' streams equal."""
    import numpy as np

    from vis_zephyr_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve import api
    from vis_zephyr_tpu_torch.serve.generate import (SamplingConfig, decode_multi_step,
                                                     decode_step, prefill)
    from vis_zephyr_tpu_torch.serve.graphs import StepGraphs

    L = cfg.decoder.num_layers
    ids = torch.randint(3, cfg.decoder.vocab_size, (1, 170),
                        generator=torch.Generator().manual_seed(seed + 5)).cuda()
    last, cache, _ = prefill(model, ids, None, None, cfg, 512)
    eager = {name: t.clone() for name, t in cache.items()}
    token, graphs, sampling = last.argmax(-1), StepGraphs(), SamplingConfig(eos_token_id=-1)
    got, tok = [], token
    for n in (1, BURST_STEPS):
        toks, _, tok = decode_multi_step(model, cache, tok, None, cfg, sampling, n, graphs)
        got.append(toks)
    want = []
    for _ in range(1 + BURST_STEPS):
        logits, eager = decode_step(model, eager, token, cfg)
        token = logits.argmax(-1)
        want.append(token)
    checks = dict(tokens=torch.equal(torch.cat(got), torch.stack(want)),
                  **{name: torch.equal(cache[name], eager[name]) for name in ("k", "v", "length")})
    print(f"multistep dense: a burst of 1 and a burst of {BURST_STEPS} on graphs ({BURST_STEPS} "
          f"replays after the warm-up step) against {1 + BURST_STEPS} eager decode steps, B=1 "
          f"from position 170: bit-equal {checks} [{card}]")
    if not all(checks.values()):
        raise AssertionError(f"multistep dense: the replayed step disagrees with the eager step: "
                             f"{checks}")
    del cache, eager, graphs
    side = cfg.vision.image_size
    rng = np.random.default_rng(seed + 4)
    images = [session_pixels(rng, side, 3) for _ in range(2)]
    questions = ("describe the picture in detail", "what is happening on the street")
    out = {}
    for multi_step in (BURST_STEPS, 1):
        parser = argparse.ArgumentParser()
        api.add_engine_args(parser)
        flags = parser.parse_args(["--max-new-tokens", str(max_new_tokens),
                                   "--multi-step", str(multi_step)])
        engine = api.engine_from_args(model, cfg, WordTokenizer(cfg.decoder.vocab_size), flags)
        for i, (px, valid) in enumerate(images):
            engine.attach_pixels(f"m{i}", px, valid, (2 * side, side))
        server, thread = start_server(engine)
        try:
            fa.launches = kv_cache.launches = 0
            results = [post_chat(server.server_address[1], {
                "session_id": f"m{i}", "question": f"{DEFAULT_IMAGE_TOKEN}\n{q}"})
                for i, q in enumerate(questions)]
            counts = dict(k1=fa.launches, k2=kv_cache.launches)
        finally:
            stop_server(server, thread)
        streams = []
        for status, text, ttft, total in results:
            words = text.split()
            if status != 200 or len(words) != max_new_tokens:
                raise AssertionError(f"multistep dense, --multi-step {multi_step}: HTTP {status}, "
                                     f"{len(words)} tokens (want {max_new_tokens})")
            streams.append([int(w[1:]) for w in words])
        want = (L * len(results), L * len(results) * (max_new_tokens - 1))
        rates = [(max_new_tokens - 1) / (r[3] - r[2]) for r in results]
        print(f"multistep dense, --multi-step {multi_step}: {len(results)} requests of "
              f"{max_new_tokens} tokens; K1 {counts['k1']} (want {want[0]}), K2 {counts['k2']} "
              f"(want {L} x {len(results) * (max_new_tokens - 1)} decode steps = {want[1]}); TTFT "
              f"{', '.join(f'{r[2] * 1e3:.1f}' for r in results)} ms, decode "
              f"{', '.join(f'{r:.2f}' for r in rates)} tokens/s [{card}]")
        if (counts["k1"], counts["k2"]) != want:
            raise AssertionError(f"multistep dense, --multi-step {multi_step}: counts {counts}")
        out[multi_step] = dict(counts, streams=streams)
    agree = [first_divergence(a, b) for a, b in zip(out[BURST_STEPS]["streams"], out[1]["streams"])]
    print(f"multistep dense: the --multi-step {BURST_STEPS} and --multi-step 1 streams agree on "
          f"their first {agree} of {max_new_tokens} tokens (want all)")
    if out[BURST_STEPS]["streams"] != out[1]["streams"]:
        raise AssertionError("multistep dense: the --multi-step 8 and 1 streams differ")
    return {"k1": out[BURST_STEPS]["k1"], "k2": out[BURST_STEPS]["k2"], "agree": agree}


def run_burst_timing(model, cfg, seed: int, card: str, label: str = "multistep",
                     sizes=BURST_SIZES, dense: bool = True) -> dict:
    """Wall per token of the 32-slot paged step (int8 KV-fused pools) run
    eagerly (`_paged_step`, the CPU's and `plain_versions()`'s form, which
    the batcher served before its steps were replayed) and in bursts of
    each of `sizes` (the batcher's `_step_burst`, which ends in the burst's
    one copy to the host), and, with `dense`, of the B = 1 dense step the
    same way (the eager `decode_step`; `decode_multi_step` over the model's
    burst cache); device busy and idle share (torch.profiler, as
    `run_profile` reads a step) of the eager step and of the burst of
    BURST_STEPS; the captures' host seconds and their graph pools' memory.
    Printed, not gated."""
    from vis_zephyr_tpu_torch.experiments import step_profile as sp

    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True, max_new_tokens=512, num_pages=1 + 32 * 16)
    rows = {}
    runs = [("paged", 1, False)] + [("paged", n, True) for n in sizes]
    if dense:
        runs += [("dense", 1, False)] + [("dense", n, True) for n in sizes]
    graphs = {"paged": b.graphs}
    for path, n, in_burst in runs:
        if path == "paged":
            # The batcher's burst at n (a burst of one too), or the eager step.
            step = functools.partial(b._step_burst, n) if in_burst else sp.paged_eager_step(b)
        elif in_burst:
            step, graphs["dense"] = sp.dense_burst(model, cfg, seed, n)
        else:
            step, _ = sp.dense_decode(model, cfg, seed)
        profiled = 0 if in_burst and n != BURST_STEPS else 2 if in_burst else 4
        counts = dict(warm=1, timed=4) if in_burst and n > 1 else dict(warm=2, timed=8)
        got = sp.profile_step(step, per_call=n if in_burst else 1, profiled=profiled, **counts)
        name = f"{path} burst of {n}" if in_burst else f"{path} eager single step"
        rows[(path, n if in_burst else 0)] = got
        device = (f", device busy {got['device_ms']:.2f} ms per token, idle share "
                  f"{got['idle_share']:.2f}, {got['launches']:.1f} kernel launches per token"
                  if profiled else "")
        print(f"{label}: {name}{', B=32' if path == 'paged' else ', B=1'}: wall "
              f"{got['wall_ms']:.2f} ms per token (min {got['wall_min_ms']:.2f}, max "
              f"{got['wall_max_ms']:.2f}){device} [{card}]", flush=True)
        if profiled and got["device_ms"] <= 0:
            print(f"{label}: the profiler reported no device time for {name}")
    if int(b.active.sum()) != 32:
        raise AssertionError(f"{label}: a slot finished inside the timed steps")
    for path, g in graphs.items():
        if g is None:  # the dense step on the CPU runs eagerly
            continue
        print(f"{label}: {path} captures {g.captures} in {g.capture_seconds:.2f} s of host time "
              f"(each with its warm-up step), graph pools {g.pool_bytes() / 2**20:.1f} MiB [{card}]")
    del b
    torch.cuda.empty_cache()
    return rows


def run_verify_routes(model, cfg, seed: int, card: str) -> None:
    """Verify steps of 32 slots (S = 5: 160 rows) on quantized weights, as
    served: every decoder projection takes K5 (int8) or K6 (int4) on chunks
    of 128 and 32 rows (`row_chunks`) and none the dequantize route, counted
    exactly over the first step (its warm-up and capture) and the replays
    after it; the first step's wall and the replayed step's wall, device busy
    and idle share (printed, not gated)."""
    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step
    from vis_zephyr_tpu_torch.ops.quant_matmul import row_chunks

    S = SPEC_LOOKAHEAD + 1
    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True, lookahead=SPEC_LOOKAHEAD, max_new_tokens=512,
                         num_pages=1 + 32 * 16)
    torch.cuda.synchronize()
    reset_routes()
    t0 = time.perf_counter()
    if b.step() != 32:
        raise AssertionError("a slot finished early")
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    got = profile_step(b.step, warm=1, timed=8, profiled=4)
    routes = read_routes()
    want = expected_routes(model, (0, 0), decoder_routes(cfg, 32 * S, b.verify_steps))
    bits = weight_bits(model)
    print(f"int{bits} verify step, 32 slots x S={S} = {32 * S} rows (chunks of "
          f"{row_chunks(32 * S)}), {b.verify_steps} steps: {show_routes(routes, want)}; the first "
          f"step (warm-up and capture) {first:.2f} ms of wall; replayed: wall "
          f"{got['wall_ms']:.2f} ms (min {got['wall_min_ms']:.2f}, max {got['wall_max_ms']:.2f}), "
          f"device busy {got['device_ms']:.2f} ms, idle share {got['idle_share']:.2f}, "
          f"{got['launches']:.1f} kernel launches a step [{card}]")
    if routes != want or routes["dequant"] or routes["dequant4"] or int(b.active.sum()) != 32:
        raise AssertionError("the quantized verify step did not route as counted")
    del b
    torch.cuda.empty_cache()


def run_profile(model, cfg, seed: int, card: str, label: str = "profile",
                lookahead: int = 0) -> None:
    """One batched decode step at B=32 (`PagedBatcher.step`: a replayed burst
    of one; a verify step of S = lookahead + 1 rows per slot, replayed too,
    when `lookahead` > 0): wall (host clock around steps that
    end in a synchronize), device-busy time, kernel launches per step and the
    largest device items (torch.profiler kernel sums; one stream, so kernels
    do not overlap)."""
    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step, show_step

    # Verify steps emit up to S tokens a slot: a longer budget (and the pages
    # for it) keeps all 32 slots active through the 28 steps.
    extra = dict(lookahead=lookahead, max_new_tokens=512, num_pages=1 + 32 * 16) if lookahead else {}
    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True, **extra)
    got = profile_step(b.step)
    if int(b.active.sum()) != 32:
        raise AssertionError(f"{label}: a slot finished inside the profiled steps")
    kind = f"verify step (S={lookahead + 1})" if lookahead else "decode step"
    show_step(f"{label}: batched {kind}, B=32 active slots, lengths about "
              f"{int(b.slot_len.mean())}", label, got, card)


def run_dense_profile(model, cfg, seed: int, card: str) -> None:
    """One dense decode step (B = 1, bf16 weights, a text prompt of 170
    tokens) profiled as `run_profile` profiles a batched one; K2 must launch
    once a layer a step."""
    from vis_zephyr_tpu_torch.experiments import step_profile
    from vis_zephyr_tpu_torch.ops import kv_cache

    step, state = step_profile.dense_decode(model, cfg, seed)
    before = kv_cache.launches
    got = step_profile.profile_step(step, warm=4, timed=16, profiled=8)
    k2 = (kv_cache.launches - before) / (4 + 16 + 8)
    step_profile.show_step(f"dense profile: decode step, B=1, position about "
                           f"{int(state['cache']['length'][0])}, K2 {k2:.0f} launches per step",
                           "dense profile", got, card)
    if k2 != cfg.decoder.num_layers:
        raise AssertionError(f"dense profile: {k2} K2 launches per step, expected one per "
                             f"layer ({cfg.decoder.num_layers})")


PREFILL_TOKENS = 2048  # a long text prompt: K1 in each of the 32 layers at T = S = 2048


def run_prefill_profile(model, cfg, seed: int, card: str) -> None:
    """A text-only dense prefill of 2048 tokens on bf16 weights: wall (host
    clock around calls that end in a synchronize, median of 5), device busy,
    idle share, K1's device time and launches, and the largest device items
    (torch.profiler over 2 calls)."""
    from torch.profiler import ProfilerActivity, profile

    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.serve.generate import prefill

    rng = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, cfg.decoder.vocab_size, (1, PREFILL_TOKENS), generator=rng).cuda()

    def call():
        prefill(model, ids, None, None, cfg, PREFILL_TOKENS + 128)

    call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n = 2
    before = fa.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    launches = (fa.launches - before) / n
    rows, busy = device_items(prof, n)
    k1_ms = sum(ms for key, ms, _ in rows if "flash_fwd_kernel" in key)
    wall = statistics.median(walls)
    share = f"{k1_ms / busy:.1%}" if busy > 0 else "not measured"
    print(f"prefill profile: text-only prefill, T={PREFILL_TOKENS}, bf16 weights: wall median "
          f"{wall:.2f} ms (5 calls, min {min(walls):.2f}, max {max(walls):.2f}), device busy "
          f"{busy:.2f} ms per call, idle share {1 - busy / wall:.2f}; K1 {k1_ms:.3f} ms "
          f"({share} of the device time), {launches:.0f} launches per call [{card}]")
    for key, ms, count in rows[:8]:
        print(f"prefill profile:   {ms:8.3f} ms  {count:6.1f} launches/call  {key[:90]}")
    if busy <= 0:
        print("prefill profile: the profiler reported no device time")
    if launches != cfg.decoder.num_layers:
        raise AssertionError(f"prefill profile: {launches} K1 launches per call, expected one "
                             f"per layer ({cfg.decoder.num_layers})")


# -- training ------------------------------------------------------------------------

TRAIN_BATCH = 8        # bench.py's stage-1 batch
TRAIN_STEPS = 3        # stage-1 optimizer steps through train()
LORA_STEPS = 2         # stage-2 steps through make_train_step
CAPTION_WORDS = 2100   # over 2048 - 4 * 32 text tokens: the splice is truncated at 2048


class CaptionDataset:
    """Stage-1 records in memory for `train(dataset=...)`: `<image>` and a
    caption of CAPTION_WORDS words, through the port's `preprocess` (the
    plain template) and WordTokenizer, with seeded pixels of 4 anyres crops
    in place of an image file (the smoke does not rely on PIL). Long enough
    that `model_max_length` 2048 truncates the spliced sequence, as
    `bench.py`'s train cell does: only then is the length a multiple of 128
    and the flash kernels run."""

    def __init__(self, tokenizer, n: int, seed: int, side: int = 336, crops: int = 4):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.tokenizer, self.n, self.seed, self.side, self.crops = tokenizer, n, seed, side, crops
        self.captions = [make_question(rng, CAPTION_WORDS) for _ in range(n)]
        self.lengths = [CAPTION_WORDS + 128] * n
        self.modality_lengths = [CAPTION_WORDS] * n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        import numpy as np

        from vis_zephyr_tpu_torch.conversation import templates
        from vis_zephyr_tpu_torch.data.tokenization import preprocess

        turns = [{"from": "human", "value": "<image>\n"}, {"from": "gpt", "value": self.captions[i]}]
        out = preprocess([turns], self.tokenizer, has_image=True, conv=templates["plain"])
        pixels = np.random.default_rng((self.seed, i)).standard_normal(
            (self.crops, self.side, self.side, 3), dtype=np.float32) * 0.5
        return {"input_ids": out["input_ids"][0], "labels": out["labels"][0], "images": pixels,
                "patch_valid": np.ones(self.crops, bool)}


def reset_flash() -> None:
    from vis_zephyr_tpu_torch.ops import flash_attention as fa

    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0


def read_flash() -> dict:
    from vis_zephyr_tpu_torch.ops import flash_attention as fa

    return dict(k1=fa.launches, k7=fa.bwd_dkv_launches, k8=fa.bwd_dq_launches)


def expect_flash(got: dict, micro_steps: int, cfg, label: str) -> None:
    """With remat, a micro-step runs K1 twice a layer (forward and recompute)
    and K7 and K8 once a layer."""
    L = cfg.decoder.num_layers
    want = dict(k1=2 * L * micro_steps, k7=L * micro_steps, k8=L * micro_steps)
    print(f"{label}: launches K1 flash_fwd {got['k1']} (want {want['k1']}), K7 flash_bwd_dkv "
          f"{got['k7']} (want {want['k7']}), K8 flash_bwd_dq {got['k8']} (want {want['k8']})")
    if got != want:
        raise AssertionError(f"{label}: flash launch counts {got} != {want}")


def profile_step(step, state, batch, card: str, label: str) -> None:
    """One train step under torch.profiler: its wall (host clock, ending in a
    synchronize), device busy time (kernel sums on one stream), idle share
    and largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def device_us(e):  # the attribute's name changed between PyTorch releases
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    rows = sorted(((e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"{label}: one step under the profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f} [{card}]")
    for key, ms, count in rows[:8]:
        print(f"{label}:   {ms:9.2f} ms  {count:6d} launches  {key[:90]}")
    if busy <= 0:
        print(f"{label}: the profiler reported no device time")


def grad_cosine(xs, ys) -> float:
    """Cosine of two gradient lists taken as one vector each, summed tensor by
    tensor in f64 (a 1.68 B-element f64 copy would not fit beside the model)."""
    dot = na = nb = 0.0
    for a, b in zip(xs, ys):
        a, b = a.double(), b.double()
        dot += float((a * b).sum())
        na += float(a.square().sum())
        nb += float(b.square().sum())
    return dot / math.sqrt(na * nb)


def run_train(seed: int, card: str) -> dict:
    """(a) stage 1 through `train()` at full width, bf16, random weights from
    the seed, TRAIN_STEPS steps of TRAIN_BATCH with remat; (c) one stage-1
    step of 2 rows on the kernel path and on the plain path; (b) stage 2 (LoRA
    r=128, α=256, dropout 0.05) through `make_train_step`, LORA_STEPS steps of
    the same batch shape. Flash launch counts are checked exactly."""
    import os
    import shutil
    import tempfile

    from vis_zephyr_tpu_torch.config import VisZephyrConfig
    from vis_zephyr_tpu_torch.data.dataset import Collator
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.train import train as ttrain
    from vis_zephyr_tpu_torch.train.lora import LoraConfig, add_lora
    from vis_zephyr_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from vis_zephyr_tpu_torch.train.steps import init_train_state, loss_fn, make_train_step

    cfg = VisZephyrConfig()
    T = cfg.tokenizer_model_max_length
    tok = WordTokenizer(cfg.decoder.vocab_size)
    data = CaptionDataset(tok, TRAIN_BATCH * TRAIN_STEPS, seed)
    collate = Collator(pad_token_id=cfg.decoder.pad_token_id, max_length=T)

    def batch_of(indices):
        return {k: torch.from_numpy(v).cuda() for k, v in collate([data[i] for i in indices]).items()}

    # (a) stage 1 through the trainer's entry point; its saves timed.
    out = tempfile.mkdtemp(prefix="vzt_train_")
    saves = []
    real_save = ttrain.save_checkpoint

    def timed_save(output_dir, state, step, projector_only=False, metadata=None):
        t0 = time.perf_counter()
        path = real_save(output_dir, state, step, projector_only=projector_only, metadata=metadata)
        n_bytes = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)
        saves.append(("projector" if projector_only else "full state", time.perf_counter() - t0,
                      n_bytes))
        return path

    args = ttrain.TrainArguments(stage="1", output_dir=out, per_device_batch_size=TRAIN_BATCH,
                                 max_steps=TRAIN_STEPS, save_steps=10 ** 6, logging_steps=1,
                                 remat=True, resume=False, dtype="bfloat16", seed=seed,
                                 model_max_length=T, device="cuda")
    ttrain.save_checkpoint = timed_save
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_flash()
        t0 = time.perf_counter()
        state = ttrain.train(args, tok, cfg=cfg, dataset=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stage1 = read_flash()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(out, "benchmark.csv")) as f:
            bench_csv = f.read().strip().splitlines()[-1]
    finally:
        ttrain.save_checkpoint = real_save
        shutil.rmtree(out, ignore_errors=True)
    if len(rows) != TRAIN_STEPS or not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                                           for r in rows):
        raise AssertionError(f"train stage 1: metrics {rows}")
    for r in rows:
        print(f"train stage 1 (train(), B={TRAIN_BATCH}, T={T}, remat): step {r['step']} loss "
              f"{r['loss']:.4f} grad_norm {r['grad_norm']:.4f} step {r['step_time_s']:.3f} s, "
              f"{TRAIN_BATCH * T / r['step_time_s']:.0f} tokens/s "
              f"({r['tokens'] / r['step_time_s']:.0f} target tokens/s) [{card}]")
    print(f"train stage 1: {wall:.1f} s in train() for {TRAIN_STEPS} steps and the final saves; "
          f"peak torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; benchmark.csv row "
          f"{bench_csv}")
    for kind, seconds, n_bytes in saves:
        print(f"train stage 1: final {kind} save {seconds:.2f} s, {n_bytes / 2**30:.3f} GiB")
    expect_flash(stage1, TRAIN_STEPS, cfg, "train stage 1")

    model = state["params"]
    big = batch_of(range(TRAIN_BATCH))
    # The device's idle share in a stage-1 step (an extra update).
    step = make_train_step(model, cfg, state["opt_state"], remat=True)
    profile_step(step, state, big, card, "train stage 1")

    # (c) one stage-1 step, kernels against their plain versions: the loss
    # and the projector's gradients on the same weights and batch.
    small = batch_of(range(2))
    proj = list(model.projector.parameters())

    def loss_and_grads():
        loss, _ = loss_fn(model, small, cfg, remat=True)
        return float(loss.detach()), torch.autograd.grad(loss, proj)

    reset_flash()
    k_loss, k_grads = loss_and_grads()
    expect_flash(read_flash(), 1, cfg, "train kernel vs plain (B=2), kernel path")
    with _kernels.plain_versions():
        p_loss, p_grads = loss_and_grads()
    rel = abs(k_loss - p_loss) / abs(p_loss)
    cos = grad_cosine(k_grads, p_grads)
    print(f"train kernel vs plain (B=2, stage 1): loss {k_loss:.6f} vs {p_loss:.6f} (relative "
          f"{rel:.2e}, <= 1e-3), projector gradient cosine {cos:.6f} (>= 0.999)")
    if not (rel <= 1e-3 and cos >= 0.999):
        raise AssertionError("train: the kernel path disagrees with the plain path")
    del k_grads, p_grads, state, big, step

    # (b) stage 2: LoRA adapters on the same model through make_train_step.
    gc.collect()
    torch.cuda.empty_cache()
    add_lora(model, LoraConfig(r=128, alpha=256), torch.Generator("cuda").manual_seed(seed + 1))
    opt = build_optimizer(model, OptimizerConfig(total_steps=LORA_STEPS), stage="2")
    n_lora = sum(p.numel() for p in opt.params)
    step = make_train_step(model, cfg, opt, remat=True, lora_dropout=0.05, dropout_seed=seed)
    state = init_train_state(model, opt)
    reset_flash()
    for i in range(LORA_STEPS):
        batch = batch_of(range(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH))
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        seconds = time.perf_counter() - t0
        print(f"train stage 2 (LoRA r=128, alpha=256, dropout 0.05, {n_lora / 1e6:.1f} M adapter "
              f"params, B={TRAIN_BATCH}, T={T}): step {i + 1} loss {loss:.4f} grad_norm "
              f"{norm:.4f} {seconds:.3f} s [{card}]")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError("train stage 2: a non-finite loss or grad_norm")
    stage2 = read_flash()
    expect_flash(stage2, LORA_STEPS, cfg, "train stage 2")
    return {"train": stage1, "train_lora": stage2}


LOAD_LORA = (128, 256)     # r, alpha: the reference's stage-2 recipe
LOAD_QUESTIONS = ("<image>\ndescribe the picture", "<image>\nwhat is in the image",
                  "and what colour is it")


def write_zephyr_tokenizer(path: str, vocab_size: int) -> None:
    """A tokenizer.json in the form of the Zephyr-7B-β tokenizer (BPE over
    Metaspace pieces with byte fallback: <unk>, <s>, </s>, the 256 byte
    tokens, then pieces), written without a tokenizer package: single
    characters, merges that build "word" and "▁word" for the words of the
    smoke's questions and of the chat template (so that a prompt takes about
    as many tokens as with the real tokenizer), and filler pieces up to
    `vocab_size` so that every id a random model emits decodes."""
    import string

    from vis_zephyr_tpu_torch.conversation import templates

    conv = templates["zephyr_v1"].copy()
    for question in LOAD_QUESTIONS:
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], "a reply")
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for ch in "▁" + string.ascii_letters + string.digits + string.punctuation:
        vocab.setdefault(ch, len(vocab))
    merges = []
    words = sorted(set(WORDS) | set(conv.get_prompt().replace("</s>", " ").split()))
    for word in words:
        for piece in ("▁", word[0]):
            for ch in word[len(piece) - (piece == "▁"):]:
                if piece + ch not in vocab:
                    vocab[piece + ch] = len(vocab)
                    merges.append(f"{piece} {ch}")
                piece += ch
    i = 0
    while len(vocab) < vocab_size:
        vocab.setdefault(f"▁t{i}", len(vocab))
        i += 1
    tj = {"version": "1.0", "added_tokens": [],
          "normalizer": None,
          "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                            "prepend_scheme": "first", "split": False},
          "decoder": {"type": "Sequence", "decoders": [
              {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
              {"type": "ByteFallback"}, {"type": "Fuse"},
              {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
          "model": {"type": "BPE", "unk_token": "<unk>", "byte_fallback": True,
                    "fuse_unk": True, "vocab": vocab, "merges": merges}}
    with open(path, "w") as f:
        json.dump(tj, f)


def rss_fields() -> dict:
    """This process's resident memory in bytes (VmRSS; the mapped pages of a
    file count in it), and its anonymous and file-backed parts where the
    kernel reports them (RssAnon, RssFile)."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in ("VmRSS", "RssAnon", "RssFile"):
                out[key] = int(value.split()[0]) * 1024
    return out


class RssPeak:
    """The largest `rss_fields` seen by a thread polling every 20 ms inside
    a `with` block."""

    def __enter__(self):
        self.peak = rss_fields()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def _poll(self):
        while not self._stop.wait(0.02):
            now = rss_fields()
            self.peak = {k: max(v, now[k]) for k, v in self.peak.items()}

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def same_weights(got: dict, want: dict, label: str) -> None:
    """Every tensor of `want` in `got`, bit for bit."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys differ: {sorted(set(got) ^ set(want))[:8]}")
    bad = [k for k, v in want.items() if got[k].dtype != v.dtype or not torch.equal(got[k], v)]
    print(f"{label}: {len(want)} tensors, {len(want) - len(bad)} bit for bit equal to the "
          f"in-memory merged model's")
    if bad:
        raise AssertionError(f"{label}: {len(bad)} tensors differ, first {bad[:4]}")


def write_released_forms(model, cfg, root: str, depth: int) -> dict:
    """The reference's released forms of the LoRA-wrapped `model` at decoder
    depth `depth` (full widths): an HF base (`pytorch_model.bin`, the card's
    machine has no safetensors) and an HF CLIP tower, a peft artifact
    (adapter_config.json, adapter_model.bin, non_lora_trainables.bin), and
    the keys of a consolidated dir for after the merge. Returns the dirs."""
    cut = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=depth))
    dirs = {name: os.path.join(root, name) for name in ("base", "tower", "peft", "consolidated")}
    for d in dirs.values():
        os.makedirs(d)
    lora = (".lora_a", ".lora_b", ".lora_scale")
    base = {k: v for k, v in model.decoder.state_dict().items()
            if not k.endswith(lora) and not (k.startswith("model.layers.")
                                            and int(k.split(".")[2]) >= depth)}
    torch.save(base, os.path.join(dirs["base"], "pytorch_model.bin"))
    torch.save({f"vision_model.{k}": v for k, v in model.vision.state_dict().items()},
               os.path.join(dirs["tower"], "pytorch_model.bin"))
    adapters = {}
    for name, mod in model.decoder.named_modules():
        if hasattr(mod, "lora_a") and int(name.split(".")[2]) < depth:
            pre = f"base_model.model.{name}"
            adapters[f"{pre}.lora_A.weight"] = mod.lora_a.T.contiguous()
            adapters[f"{pre}.lora_B.weight"] = mod.lora_b.T.contiguous()
    torch.save(adapters, os.path.join(dirs["peft"], "adapter_model.bin"))
    with open(os.path.join(dirs["peft"], "adapter_config.json"), "w") as f:
        json.dump({"r": LOAD_LORA[0], "lora_alpha": LOAD_LORA[1]}, f)
    torch.save({f"base_model.model.model.mm_projector.{k}": v
                for k, v in model.projector.state_dict().items()},
               os.path.join(dirs["peft"], "non_lora_trainables.bin"))
    for d in (dirs["peft"], dirs["consolidated"]):
        with open(os.path.join(d, "config.json"), "w") as f:
            f.write(cut.to_json())
    return dirs


def run_load(seed: int, max_new_tokens: int, card: str) -> dict:
    """The load paths at full width: the port trainer's full stage-2 state
    (LoRA r 128, α 256, `lora_b` random, the adapters' AdamW moments) saved by
    `train/checkpoints.save_checkpoint` into a model dir beside `config.json`
    and a Zephyr-form `tokenizer.json`, loaded by `load_pretrained_model`
    with the native tokenizer and held bit for bit against `merge_lora` of
    the in-memory model; 2 sessions and 3 requests served on it (greedy
    tokens equal the in-memory merged model's, K1 and K2 counted), then on
    `load_8bit` (K5, no dequantize call); the peft artifact and the
    consolidated dir at as many layers as the disk holds, each bit for bit."""
    import shutil
    import tempfile

    import numpy as np

    from vis_zephyr_tpu_torch.data import native, native_lib
    from vis_zephyr_tpu_torch.data.tokenizer_native import NativeTokenizer
    from vis_zephyr_tpu_torch.models.builder import load_pretrained_model
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve import generate as tgen
    from vis_zephyr_tpu_torch.serve.engine import ChatEngine
    from vis_zephyr_tpu_torch.train.checkpoints import save_checkpoint
    from vis_zephyr_tpu_torch.train.lora import LoraConfig, add_lora, merge_lora
    from vis_zephyr_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer

    model, cfg = build_model(seed)
    L = cfg.decoder.num_layers
    r, alpha = LOAD_LORA
    gen = torch.Generator("cuda").manual_seed(seed + 3)
    add_lora(model, LoraConfig(r=r, alpha=alpha), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.01, generator=gen)
    # The adapters' optimizer state, as a stage-2 run leaves it: one AdamW
    # update from seeded gradients.
    opt = build_optimizer(model, OptimizerConfig(total_steps=1), stage="2")
    opt.update([torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype) * 1e-3
                for p in opt.params])
    model.requires_grad_(False)
    n_lora = sum(p.numel() for p in opt.params)

    root = tempfile.mkdtemp(prefix="vzt_load_")
    try:
        state_bytes = (sum(t.numel() * t.element_size() for t in model.state_dict().values())
                       + sum(t.numel() * t.element_size() for s in opt.adamw.state.values()
                             for t in s.values() if torch.is_tensor(t)))
        per_layer = sum(t.numel() * t.element_size()
                        for t in model.decoder.model.layers[0].state_dict().values())
        fixed = state_bytes - L * per_layer
        free = shutil.disk_usage(root).free
        print(f"load: {free / 2**30:.1f} GiB free on the disk of {root}; the full state needs "
              f"about {state_bytes / 2**30:.1f} GiB ({n_lora / 1e6:.1f} M adapter params and "
              f"their AdamW moments)")
        if free < 1.1 * state_bytes:
            raise AssertionError("load: not enough free disk for the full state")
        # The released forms, written from the LoRA-wrapped model before the
        # merge: two dirs of (fixed parts + depth layers) each.
        room = (free - 1.1 * state_bytes) / 2
        depth = max(0, min(L, int((room - fixed) // (per_layer * 1.1))))
        if depth < 1:
            raise AssertionError("load: no disk left for the released forms")
        t0 = time.perf_counter()
        forms = write_released_forms(model, cfg, os.path.join(root, "forms"), depth)
        print(f"load: wrote the peft artifact and its base at depth {depth} of {L} (full widths, "
              f"as deep as the disk allows) in {time.perf_counter() - t0:.1f} s")

        # (1) Save as the port trainer saves, into a model dir.
        t0 = time.perf_counter()
        ckpt = save_checkpoint(os.path.join(root, "run"),
                               {"params": model, "opt_state": opt, "step": 1}, step=1)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.sync()
        sync_s = time.perf_counter() - t0
        del opt
        gc.collect()
        model_dir = os.path.join(root, "model")
        os.makedirs(model_dir)
        os.rename(os.path.join(ckpt, "state"), os.path.join(model_dir, "state"))
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
        write_zephyr_tokenizer(os.path.join(model_dir, "tokenizer.json"), cfg.decoder.vocab_size)
        ckpt_bytes = dir_bytes(os.path.join(model_dir, "state"))
        print(f"load: save_checkpoint of the full stage-2 state: {ckpt_bytes / 2**30:.2f} GiB "
              f"in {save_s:.2f} s, then os.sync {sync_s:.2f} s [{card}]")

        # The in-memory reference: merge_lora on the device, as the builder does.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merge_lora(model)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        print(f"load: merge_lora of the in-memory model on the device: {merge_s * 1e3:.1f} ms "
              f"({7 * L} adapters) [{card}]")

        # (2) Load through the builder with the native tokenizer.
        os.environ["VZT_NATIVE_TOKENIZER"] = "1"
        torch.cuda.synchronize()
        before = rss_fields()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            tok, loaded, lcfg, _ = load_pretrained_model(model_dir, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        after = rss_fields()
        if not isinstance(tok, NativeTokenizer):
            raise AssertionError(f"load: the tokenizer is {type(tok).__name__}, not the port's "
                                 f"NativeTokenizer")
        parts = "; ".join(f"{k} {before[k] / 2**30:.2f} -> peak {rss.peak[k] / 2**30:.2f}"
                          for k in ("RssAnon", "RssFile") if k in before)
        print(f"load: load_pretrained_model (state.pt by mmap into a meta model, to the card, "
              f"LoRA merged there): {load_s:.2f} s; host RSS {before['VmRSS'] / 2**30:.2f} -> "
              f"peak {rss.peak['VmRSS'] / 2**30:.2f} -> {after['VmRSS'] / 2**30:.2f} GiB, the "
              f"peak {(rss.peak['VmRSS'] - before['VmRSS']) / 2**30:.2f} GiB over the start "
              f"against the file's {ckpt_bytes / 2**30:.2f} GiB ({parts or 'no RssAnon / RssFile '
              'in /proc/self/status here'}); tokenizer {type(tok).__name__}, vocabulary "
              f"{tok.vocab_size} [{card}]")
        if lcfg != cfg:
            raise AssertionError(f"load: the loaded config differs: {lcfg}")
        same_weights(loaded.state_dict(), model.state_dict(), "load: state.pt")

        # (3) Serve: 2 sessions, 3 requests, pixels attached as slice 1 does.
        rng = np.random.default_rng(seed)
        side = cfg.vision.image_size
        pixels = [session_pixels(rng, side, 3) for _ in range(2)]
        requests = [("s0", LOAD_QUESTIONS[0]), ("s1", LOAD_QUESTIONS[1]), ("s0", LOAD_QUESTIONS[2])]

        def serve(m, counted: bool):
            engine = ChatEngine(m, lcfg, tok, max_new_tokens=max_new_tokens)
            for sid, (px, valid) in zip(("s0", "s1"), pixels):
                engine.attach_pixels(sid, px, valid, (2 * side, side))
            if counted:
                fa.launches = kv_cache.launches = 0
                reset_routes()
            replies, rates = [], []
            for sid, question in requests:
                t0 = time.perf_counter()
                chunks, first = [], None
                for chunk in engine.chat(sid, question):
                    first = first or time.perf_counter() - t0
                    chunks.append(chunk)
                total = time.perf_counter() - t0
                replies.append("".join(chunks))
                rates.append((max_new_tokens - 1) / (total - (first or 0.0)))
            counts = dict(k1=fa.launches, k2=kv_cache.launches, **read_routes())
            return engine, replies, rates, counts

        engine, replies, rates, counts = serve(loaded, counted=True)
        _, want_replies, _, _ = serve(model, counted=False)
        # Greedy tokens of the first turns, direct, on both models (each
        # model's serialized cache has seen the same requests).
        sampling = tgen.SamplingConfig(max_new_tokens=max_new_tokens)
        for (sid, question), (px, valid) in zip(requests[:2], pixels):
            ids = torch.tensor([engine.prompt_ids(question)], device="cuda")
            images = torch.as_tensor(px, device="cuda")[None]
            pv = torch.as_tensor(valid, device="cuda")[None]
            got = tgen.generate(loaded, ids, images, pv, lcfg, sampling)
            want = tgen.generate(model, ids, images, pv, cfg, sampling)
            if not np.array_equal(got, want):
                raise AssertionError(f"load: greedy tokens {got.tolist()} differ from the "
                                     f"in-memory merged model's {want.tolist()}")
        print(f"load served: {len(requests)} requests on 2 sessions; first turns' greedy tokens "
              f"equal the in-memory merged model's; replies equal its replies: "
              f"{replies == want_replies}; decode {statistics.median(rates):.1f} tokens/s median "
              f"(of {', '.join(f'{x:.1f}' for x in rates)}); reply 0 starts {replies[0][:40]!r} "
              f"[{card}]")
        if replies != want_replies:
            raise AssertionError("load: the loaded model's replies differ from the in-memory "
                                 "merged model's")
        for text in list(replies) + [q for _, q in requests]:
            back = tok.decode(tok.encode(text, add_bos=False))
            if back != text:
                raise AssertionError(f"load: {text[:40]!r} does not round-trip through the "
                                     f"native tokenizer ({back[:40]!r})")
        decode_steps = len(requests) * (max_new_tokens - 1)
        print(f"load counters: K1 flash_fwd {counts['k1']} (want {L * len(requests)}), K2 "
              f"dense_cache_append {counts['k2']} (want {L} x {decode_steps} decode steps); "
              f"every text round-trips through the native tokenizer")
        if counts["k1"] != L * len(requests) or counts["k2"] != L * decode_steps:
            raise AssertionError("load: the served path did not go through K1 and K2 as counted")
        engine.close()
        del engine, loaded
        gc.collect()
        torch.cuda.empty_cache()

        # The same checkpoint served on int8 weights (load_8bit after the merge).
        t0 = time.perf_counter()
        tok8, loaded8, cfg8, _ = load_pretrained_model(model_dir, device="cuda", load_8bit=True)
        torch.cuda.synchronize()
        load8_s = time.perf_counter() - t0
        if weight_bits(loaded8) != 8:
            raise AssertionError("load: load_8bit did not quantize the decoder")
        engine8 = ChatEngine(loaded8, cfg8, tok8, max_new_tokens=max_new_tokens)
        # Two crops: the Q-Former's cross-attention then projects 2 x 577
        # visual rows, inside K5's chunked route (QMM_CHUNK_MAX_M).
        px, valid = pixels[0]
        engine8.attach_pixels("s0", px[:2], valid[:2], (side, side))
        fa.launches = kv_cache.launches = 0
        reset_routes()
        reply8 = engine8.chat_text("s0", LOAD_QUESTIONS[0])
        counts8 = dict(k1=fa.launches, k2=kv_cache.launches, **read_routes())
        print(f"load int8 (load_8bit after the merge): loaded in {load8_s:.2f} s; one request, "
              f"{show_routes(counts8, dict(k5='> 0', dequant=0, k6=0, dequant4=0))}; K1 "
              f"{counts8['k1']}, K2 {counts8['k2']}; reply starts {reply8[:40]!r}")
        if not (counts8["k5"] > 0 and counts8["dequant"] == 0 and counts8["k1"] > 0):
            raise AssertionError("load int8: K5 did not serve the loaded checkpoint")
        engine8.close()
        del engine8, loaded8
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(root, "model"))
        os.environ.pop("VZT_NATIVE_TOKENIZER")  # the released forms carry no tokenizer

        # (4) The released forms at depth `depth`, against the merged model.
        want = {}
        sd = model.state_dict()
        for k, v in sd.items():
            parts = k.split(".")
            if k.startswith("decoder.model.layers.") and int(parts[3]) >= depth:
                continue
            want[k] = v
        t0 = time.perf_counter()
        _, peft, pcfg, _ = load_pretrained_model(forms["peft"], model_base=forms["base"],
                                                 vision_tower_path=forms["tower"], device="cuda")
        torch.cuda.synchronize()
        peft_s = time.perf_counter() - t0
        print(f"load: the peft artifact ({dir_bytes(forms['peft']) / 2**30:.2f} GiB, base "
              f"{dir_bytes(forms['base']) / 2**30:.2f} GiB, tower "
              f"{dir_bytes(forms['tower']) / 2**30:.2f} GiB) loaded and merged in {peft_s:.2f} s, "
              f"depth {pcfg.decoder.num_layers}")
        same_weights(peft.state_dict(), want, "load: peft artifact")
        del peft
        gc.collect()
        consolidated = {f"model.vision_tower.vision_tower.{k}": v
                        for k, v in torch.load(os.path.join(forms["tower"], "pytorch_model.bin"),
                                               mmap=True, weights_only=True).items()}
        consolidated.update({f"model.mm_projector.{k}": v
                             for k, v in model.projector.state_dict().items()})
        consolidated.update({k[len("decoder."):]: v for k, v in want.items()
                             if k.startswith("decoder.")})
        torch.save(consolidated, os.path.join(forms["consolidated"], "pytorch_model.bin"))
        del consolidated
        t0 = time.perf_counter()
        _, cons, _, _ = load_pretrained_model(forms["consolidated"], device="cuda")
        torch.cuda.synchronize()
        cons_s = time.perf_counter() - t0
        print(f"load: the consolidated dir ({dir_bytes(forms['consolidated']) / 2**30:.2f} GiB) "
              f"loaded in {cons_s:.2f} s, depth {depth}")
        same_weights(cons.state_dict(), want, "load: consolidated dir")
        del cons
        built = native.available()
        print(f"load: the native image route (native/vzt_image.cpp, -ljpeg) "
              f"{'builds' if built else 'does not build'} on this machine"
              + ("" if built else f": {native_lib.build_error.get('vzt_image', '')[-200:]!r}"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        os.environ.pop("VZT_NATIVE_TOKENIZER", None)
    return {"load": counts, "load_int8": counts8}


GROUPED_PAIRS = (1, 2, 4, 8)  # slots a block owns: 1 is K10, more K11
GROUPED_PAGES = (1, 5, 6, 8)  # pages_per_block: the probes' timed steps


def grouped_call(pa, case, q, k_new, v_new, pair, ppcb, window=None, **over):
    """K10 (pair 1) or K11 over a `paged_case`'s int8 fused pools, layer 1."""
    c = dict(case, **over)
    args = (q, c["kp"], c["table"], case["lengths"], case["lengths"], k_new, v_new, c["ksc"],
            ppcb, window)
    if pair == 1:
        return pa.paged_attention_batched(*args, page_offset=case["P"])
    return pa.paged_attention_paired(*args, page_offset=case["P"], pair=pair)


def check_grouped(gen) -> dict:
    """K10 and K11 against their plain version and against K3 at B=32, Hq=32,
    Hkv=8, D=128, page 128, 16 pages a slot, int8 fused pools with the
    self-term, lengths that include 0, 1, 128, 129 and 2048: P = 1, 2, 4 and
    8 with `pages_per_block` 1, 5, 6 and 8 (every tiling the probes time),
    with and without a window of 512; per
    slot max-abs error <= 1e-2 of the slot's largest value and cosine >=
    0.9999; the slot of length 0 exactly its v_new; NaN in the scales past
    every slot's length leaves the output unchanged bit for bit. Then
    `paged_attention_fa` with an explicit `slot_block` of 2 (B = 31: one
    empty slot of padding) launches K11 on fused int8 pools and K3 on split
    bf16 ones."""
    from vis_zephyr_tpu_torch.experiments.probe_common import agreement
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    Hq, Hkv, D, ps, B = 32, 8, 128, 128, 32
    edge = [0, 1, 128, 129, 2048, 2047, 127, 1025]
    lengths = edge + torch.randint(1, 2049, (B - len(edge),), generator=gen, device=dev).tolist()
    case = paged_case(gen, lengths, True, True)
    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    k3 = paged_call(pa, case, q, True, k_new, v_new)
    k3_window = paged_call(pa, case, q, True, k_new, v_new, 512)
    worst = {"k10": 0.0, "k11": 0.0}

    def gate(name, got, want, what):
        a = agreement(got, want, per_slot=True)
        ok = a["rel_err"] <= 1e-2 and a["cosine"] >= 0.9999 and bool(torch.isfinite(got.float()).all())
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with {what} ({a})")
        return a

    for pair in GROUPED_PAIRS:
        name = "K10" if pair == 1 else f"K11 P={pair}"
        for ppcb in GROUPED_PAGES:
            for window in (None, 512):
                got = grouped_call(pa, case, q, k_new, v_new, pair, ppcb, window)
                torch.cuda.synchronize()
                with _kernels.plain_versions():
                    want = grouped_call(pa, case, q, k_new, v_new, pair, ppcb, window)
                label = f"{name}, pages_per_block {ppcb}, window {window}"
                a = gate(label, got, want, "its plain version")
                b = gate(label, got, k3 if window is None else k3_window, "K3")
                key = "k10" if pair == 1 else "k11"
                worst[key] = max(worst[key], float((got.float() - want.float()).abs().max()))
                print(f"{label}: against the plain version per slot {a['rel_err']:.3e} (<= 1e-2), "
                      f"cosine {a['cosine']:.7f}; against K3 {b['rel_err']:.3e}, "
                      f"{b['cosine']:.7f} (>= 0.9999)")
                want0 = v_new[0].repeat_interleave(Hq // Hkv, dim=0)
                if not torch.equal(got[0, 0], want0):
                    raise AssertionError(f"{label}: the slot of length 0 is not its v_new")
        # Whatever a recycled page holds at or past `length` must not reach the
        # output: NaN in the K and V scales there, the same result bit for bit.
        clean = grouped_call(pa, case, q, k_new, v_new, pair, 5)
        dirty_scales = case["ksc"].clone()
        for b, n in enumerate(lengths):
            for j in range(16):
                lo = max(n - j * ps, 0)
                if lo < ps:
                    page = int(case["table"][b, j]) + case["P"]
                    dirty_scales[page, :, lo:ps] = float("nan")
                    dirty_scales[page, :, ps + lo:] = float("nan")
        dirty = grouped_call(pa, case, q, k_new, v_new, pair, 5, ksc=dirty_scales)
        torch.cuda.synchronize()
        same = torch.equal(clean, dirty)
        print(f"{name}: NaN scales past length leave the output unchanged: {same}")
        if not same:
            raise AssertionError(f"{name}: rows past length reached the output")

    # paged_attention_fa with an explicit slot_block: K11 on the probes'
    # configuration (31 slots, padded to 32 by an empty slot), K3 on split bf16.
    def fa(c, **kw):
        return pa.paged_attention_fa(q[:31], c["kp"], c["vp"], c["table"][:31],
                                     c["lengths"][:31], c["lengths"][:31], k_scales=c["ksc"],
                                     v_scales=c["vsc"], k_new=k_new[:31], v_new=v_new[:31],
                                     page_offset=c["P"], **kw)

    split = paged_case(gen, lengths, False, False)
    before = (pa.attn_launches, pa.paired_launches)
    routed = fa(case, slot_block=2, pages_per_block=5)
    counts = (pa.attn_launches - before[0], pa.paired_launches - before[1])
    with _kernels.plain_versions():
        gate("paged_attention_fa(slot_block=2), int8 fused", routed, fa(case, slot_block=2,
             pages_per_block=5), "its plain version")
    before_split = (pa.attn_launches, pa.paired_launches)
    routed_split = fa(split, slot_block=2, pages_per_block=5)
    counts_split = (pa.attn_launches - before_split[0], pa.paired_launches - before_split[1])
    torch.cuda.synchronize()
    if not torch.equal(routed_split, fa(split)):
        raise AssertionError("paged_attention_fa(slot_block=2) on split bf16 pools is not K3's")
    print(f"paged_attention_fa(slot_block=2, pages_per_block=5), 31 slots: int8 fused pools -> "
          f"K3 {counts[0]}, K11 {counts[1]} launches (want 0, 1); split bf16 pools -> K3 "
          f"{counts_split[0]}, K11 {counts_split[1]} (want 1, 0)")
    if counts != (0, 1) or counts_split != (1, 0):
        raise AssertionError("paged_attention_fa's tilings did not route as documented")
    return worst


def time_grouped(seed: int, batched_times: dict, paired_times: dict) -> dict:
    """K10 (pages_per_block 8, the JAX probe's) and K11 (P = 2, pages_per_block
    6, the paired probe's first) at the bench shape, one layer: the timed
    call's output held against the plain version's on the same inputs (per
    slot max-abs error <= 1e-2 of the slot's largest value, cosine >=
    0.9999), CUDA events around one wrapper call (median of 20), the plain
    version, the bound from this run's inputs; the device time a layer from
    the probes' CUDA graphs of 32 layer calls."""
    from vis_zephyr_tpu_torch.experiments import batched_paged_attention_probe as bprobe
    from vis_zephyr_tpu_torch.experiments.probe_common import agreement
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    c = bprobe.bench_case("cuda", seed + 1, bprobe.BENCH_SLOTS,
                          [bprobe.BENCH_PROMPT] * bprobe.BENCH_SLOTS, 1)
    least, by, _ = bprobe.layer_bound(c)
    args = (c["q"], c["k_pages"], c["page_table"], c["lengths"], c["q_offs"], c["k_new"],
            c["v_new"], c["k_scales"])
    out = {}
    for name, tag, probe, fn in (
            ("paged_attn_batched", "k10_ppcb8", batched_times,
             lambda: pa.paged_attention_batched(*args, 8)),
            ("paged_attn_paired", "k11_P2_ppcb6", paired_times,
             lambda: pa.paged_attention_paired(*args, 6, pair=2))):
        got = fn()
        torch.cuda.synchronize()
        with _kernels.plain_versions():
            a = agreement(got, fn(), per_slot=True)
        print(f"{name} ({tag}) at the bench shape against its plain version: per slot "
              f"{a['rel_err']:.3e} (<= 1e-2), cosine {a['cosine']:.7f} (>= 0.9999)")
        if not (a["rel_err"] <= 1e-2 and a["cosine"] >= 0.9999
                and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"{name} ({tag}) disagrees with its plain version at the bench "
                                 f"shape: {a}")
        ms = median_ms(fn)
        with _kernels.plain_versions():
            plain_ms = median_ms(fn, 5)
        device_ms = probe["B128"]["step_ms"][tag] / probe["B128"]["layers"]
        out[name] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=least, bound_by=by, config=tag,
                         probe_step_ms={shape: t["step_ms"] for shape, t in probe.items()})
        if name == "paged_attn_paired":
            # K11 and its first design (`walk`) on the device a layer, by P.
            out[name]["device_ms_by_pair"] = {
                shape: {route: ms / t["layers"] for route, ms in t["step_ms"].items()
                        if route.startswith(("k11_", "walk_"))}
                for shape, t in probe.items()}
            for shape, routes in out[name]["device_ms_by_pair"].items():
                print(f"paged_attn_paired on the device a layer at {shape}: "
                      + ", ".join(f"{route} {ms:.4f} ms" for route, ms in routes.items())
                      + f"; bound {probe[shape]['bound_ms_per_layer']:.5f} ms by "
                        f"{probe[shape]['bound_by']}")
        print(f"{name} ({tag}) at the bench shape (128 slots of 640 tokens): {ms:.4f} ms per "
              f"call, {device_ms:.4f} on the device (a layer of the probe's graph); plain "
              f"{plain_ms:.4f} ms; bound {least:.5f} ms by {by}; no library call computes it")
    del c, args
    torch.cuda.empty_cache()
    return out


def run_attn_probes(seed: int, gen, card: str) -> dict:
    """The two attention probes' `main()`, their launches counted from 0
    (numerics, then K3, K10 and K11 in CUDA graphs of 32 layer calls at
    128 slots of 640 tokens and at 32 slots of 60-800), their numerics
    and every timed route's output at both timed shapes gated; then K10
    and K11 held against their plain version and K3
    (`check_grouped`) and timed for the kernels line (`time_grouped`)."""
    from vis_zephyr_tpu_torch.experiments import batched_paged_attention_probe as bprobe
    from vis_zephyr_tpu_torch.experiments import paired_slot_attention_probe as pprobe
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    # Every served phase ran before this one: neither kernel may have launched.
    if pa.batched_launches or pa.paired_launches:
        raise AssertionError(f"K10 or K11 launched on a served path: {pa.batched_launches}, "
                             f"{pa.paired_launches}")
    pa.batched_launches = pa.paired_launches = 0
    batched = bprobe.main(["--seed", str(seed)])
    paired = pprobe.main(["--seed", str(seed)])
    counts = {"k10": pa.batched_launches, "k11": pa.paired_launches}
    checks = {"batched": batched["vs_plain"], "batched vs K3": batched["vs_k3"]}
    for key, value in paired.items():
        if key.startswith("P"):
            checks[f"paired {key}"] = value["vs_plain"]
            checks[f"paired {key} vs K3"] = value["vs_k3"]
            checks[f"paired {key}, the first design"] = value["walk_vs_plain"]
    # Every timed route's layer-0 output at both timed shapes against the
    # plain version on the same inputs (`time_routes`).
    for probe, res in (("batched", batched), ("paired", paired)):
        for shape, timed in res["times"].items():
            for tag, value in timed["checks"].items():
                checks[f"{probe} {shape} {tag}"] = value
    bad = {k: v for k, v in checks.items() if not (v["rel_err"] <= 1e-2 and v["cosine"] >= 0.9999)}
    if bad:
        raise AssertionError(f"attn_probes: a probe's numerics check failed: {bad}")
    print(f"attn_probes: {len(checks)} probe checks within per slot 1e-2 and cosine 0.9999, "
          f"every timed route at both timed shapes among them")
    print(f"attn_probes: launches in the probes' runs K10 {counts['k10']}, K11 {counts['k11']}")
    grouped = check_grouped(gen)
    times = time_grouped(seed, batched["times"], paired["times"])
    # K11's build: tensor-core products, TMA boxes and bulk copies, no spills.
    sass = sass_counts("paged_attn_paired_kernel", K3_SASS_OPS)
    resources = resource_usage("paged_attn_paired_kernel")
    print(f"K11 SASS (paged_attn_paired_kernel): {sass}; registers at entry {resources['reg']}, "
          f"stack frame {resources['stack']} bytes, local {resources['local']}")
    if not all(sass[op] for op in K3_SASS_OPS):
        raise AssertionError(f"K11: no HMMA, UTMALDG or UBLKCP in its SASS: {sass}")
    times["paged_attn_paired"].update(sass=sass, resources=resources)
    return dict(counts, max_abs_err=grouped, times=times,
                probes={"batched": batched["times"], "paired": paired["times"]})


# -- the dense continuous batcher, per-request sampling, the OpenAI endpoints ---------------

DENSE_SLOTS = 8   # the dense batcher's slots: the JAX server's default --max-slots
DENSE_FLAGS = ["--continuous-batching", "--max-slots", str(DENSE_SLOTS)]
DENSE_STEPS = 8   # the fixed batch's compared steps
SAMPLED_STEPS = 6  # the sampled batch's compared steps: the capture's warm-up, then replays


def device_state(b) -> list:
    """A batcher's device state: the dense cache or the pools and page table,
    lengths, pending tokens and the penalty counts."""
    if hasattr(b, "kp"):
        state = [b.kp, b.vp, b.ksp, b.vsp, b.page_table, b.lengths]
    else:
        state = [b.cache["k"], b.cache["v"], b.cache["length"]]
    return [t for t in state + [b.token, b.counts] if t is not None]


def copy_state(dst, src) -> None:
    """The same start for two batchers admitted alike: dst's device state and
    generator set from src's, in place (a captured step keeps reading dst's
    buffers)."""
    for mine, theirs in zip(device_state(dst), device_state(src)):
        mine.copy_(theirs)
    dst.generator.set_state(src.generator.get_state())


def eager_bursts(b) -> None:
    """Make `b` run its decode bursts as eager kernel-path steps with the
    carry on the host (`_batch_step` or `_paged_step`, then `_logprobs` of
    the step's logits), where a served batcher replays its captured step."""
    from vis_zephyr_tpu_torch.serve.batching import _batch_step
    from vis_zephyr_tpu_torch.serve.generate import _logprobs
    from vis_zephyr_tpu_torch.serve.paged import _paged_step

    def step(alive, overrides, penalties, grammar):
        if hasattr(b, "kp"):
            return _paged_step(b.model, b.kp, b.vp, (b.ksp, b.vsp), b.page_table, b.lengths,
                               b.token, alive, b.generator, b.cfg, b.sampling,
                               sample_overrides=overrides, penalties=penalties, grammar=grammar)
        return _batch_step(b.model, b.cache, b.token, alive, b.generator, b.cfg, b.sampling,
                           sample_overrides=overrides, penalties=penalties, grammar=grammar)

    def burst(n, overrides, penalties, lp_out, grammar=None):
        alive, left = b._active_dev.clone(), b._left_dev.clone()
        toks, entry = [], []
        for j in range(n):
            entry.append(alive.clone())
            tok, logits = step(alive, overrides, penalties, grammar)
            if lp_out is not None:
                for out, got in zip(lp_out, _logprobs(logits, tok)):
                    out[j].copy_(got)
            toks.append(tok.clone())
            left -= 1
            alive = alive & (tok != b.sampling.eos_token_id) & (left > 0)
        return torch.stack(toks), torch.stack(entry), logits

    b._burst_device = burst


def streams(handles) -> list:
    """What each request has received: its tokens and its logprob entries."""
    return [(list(h.out.queue), [(c, ids.tolist(), lps.tolist()) for c, ids, lps in h.lp_log])
            for h in handles]


def same_batchers(a, b, ha, hb) -> dict:
    """Bit-equality of two batchers after a step: the last logits, the device
    state, and the host's lengths, histories and streams."""
    return dict(logits=torch.equal(a.last_logits, b.last_logits),
                device=all(torch.equal(x, y) for x, y in zip(device_state(a), device_state(b))),
                host=(a.slot_len.tolist() == b.slot_len.tolist()
                      and [list(h) for h in a.slot_hist] == [list(h) for h in b.slot_hist]
                      and streams(ha) == streams(hb)))


def post_json(port: int, method: str, path: str, payload=None):
    """One request to the server; returns (status, body text)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    body = None if payload is None else json.dumps(payload)
    conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    return resp.status, text


def run_dense_server(model, cfg, seed: int, new_tokens: int, card: str, n: int = 16) -> dict:
    """The server with `--continuous-batching --max-slots 8` (the dense
    batcher: one cache of 8 x 2048 rows, prefill chunks of 256, every decode
    step a replay) under `n` concurrent /chat requests of about 40, 300 and
    600 words: every reply HTTP 200 with all its tokens, K2 = 32 x (decode
    steps + prefill chunks), K1 = 0 (chunked admission), every slot free at
    the end; TTFT, tokens/s, captures and the graph pool printed."""
    import numpy as np

    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve import api

    L = cfg.decoder.num_layers
    parser = argparse.ArgumentParser()
    api.add_engine_args(parser)
    flags = parser.parse_args(DENSE_FLAGS + ["--max-new-tokens", str(new_tokens)])
    engine = api.engine_from_args(model, cfg, WordTokenizer(cfg.decoder.vocab_size), flags)
    b = engine.batcher
    side = cfg.vision.image_size
    requests = paged_requests(np.random.default_rng(seed + 1), cfg, n)
    chunks = 0
    for sid, question, px, valid in requests:
        engine.attach_pixels(sid, px, valid, (2 * side, side))
        length = len(engine.prompt_ids(question)) - 1 + int(valid.sum()) * cfg.tokens_per_patch
        chunks += -(-length // b.prefill_chunk)
    cache_gib = 2 * b.cache["k"].numel() * b.cache["k"].element_size() / 2**30
    print(f"dense_batch: server flags {' '.join(DENSE_FLAGS)} -> {type(b).__name__}, max_slots "
          f"{b.max_slots}, cache_len {b.cache_len}, prefill chunk {b.prefill_chunk}; the cache "
          f"{cache_gib:.2f} GiB")
    engine.attach_pixels("warm", requests[0][2], requests[0][3], (2 * side, side))
    engine.chat_text("warm", requests[0][1])  # the capture, outside the counted run
    server, thread = start_server(engine)
    port = server.server_address[1]
    try:
        fa.launches = kv_cache.launches = 0
        b.steps = b.slots_stepped = b.bursts = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(
                lambda r: post_chat(port, {"session_id": r[0], "question": r[1]}), requests))
        wall = time.perf_counter() - t0
        counts = dict(k1=fa.launches, k2=kv_cache.launches)
    finally:
        stop_server(server, thread)
        engine.close()
    for (sid, _, _, _), (status, text, _, _) in zip(requests, results):
        words = text.split()
        if status != 200 or len(words) != new_tokens:
            raise AssertionError(f"dense_batch request {sid}: HTTP {status}, {len(words)} tokens "
                                 f"(want {new_tokens}): {text[:60]!r}")
    want = dict(k1=0, k2=L * (b.steps + chunks))
    ttfts = sorted(r[2] for r in results)
    print(f"dense_batch: {n} requests, all HTTP 200 with {new_tokens} tokens; {b.steps} decode "
          f"steps, mean active slots per step {b.slots_stepped / b.steps:.2f} of {b.max_slots}; "
          f"K2 dense_cache_append {counts['k2']} (want {L} x ({b.steps} steps + {chunks} prefill "
          f"chunks) = {want['k2']}), K1 flash_fwd {counts['k1']} (want 0); TTFT median "
          f"{statistics.median(ttfts) * 1e3:.1f} ms, max {ttfts[-1] * 1e3:.1f} ms; "
          f"{n * new_tokens} tokens in {wall:.2f} s = {n * new_tokens / wall:.1f} tokens/s over "
          f"all slots, {wall / b.steps * 1e3:.1f} ms of wall per scheduler step; captures "
          f"{b.graphs.captures} ({b.graphs.capture_seconds:.2f} s), graph pool "
          f"{b.graphs.pool_bytes() / 2**20:.1f} MiB [{card}]", flush=True)
    if counts != want or b.has_work or b.active.any() or b.slots_stepped <= b.steps:
        raise AssertionError("dense_batch: the served dense batcher miscounted, leaked a slot or "
                             "did not share steps")
    return dict(counts, tokens_per_s=n * new_tokens / wall, ttft_median=statistics.median(ttfts),
                ttft_max=ttfts[-1], captures=b.graphs.captures,
                pool_mib=b.graphs.pool_bytes() / 2**20)


def run_dense_batch(model, cfg, seed: int, new_tokens: int, card: str) -> dict:
    """The dense continuous batcher (8 slots, cache 2048): the served run
    (`run_dense_server`); then a fixed batch of 8 requests admitted whole
    into two batchers, one stepping as served (every step a replay of the
    captured step) and one through eager kernel-path `_batch_step`s from
    the same state: tokens, logits, cache, lengths and the host's streams
    bit for bit over 8 steps, K2 exact; the first step's logits per slot
    against the serialized path's `decode_step` (B = 1) on the same request,
    cosine >= 0.999; the replayed and the eager step profiled (wall, device
    busy, idle share, largest items); a burst of 8 against 8 single steps
    (budgets 2 to 9, every slot ending inside it) bit for bit; and
    `--lookahead 4`: 5 verify steps replayed against 5 eager `decode_verify`
    steps with acceptance and rollback, bit for bit."""
    import numpy as np

    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step, show_step
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve import generate as gen

    L = cfg.decoder.num_layers
    out = run_dense_server(model, cfg, seed, new_tokens, card)

    requests = direct_requests(cfg, seed, DENSE_SLOTS)
    served = admitted_batcher(model, cfg, requests, DENSE_SLOTS, dense=True)
    eager = admitted_batcher(model, cfg, requests, DENSE_SLOTS, dense=True)
    copy_state(eager, served)
    eager_bursts(eager)
    hs, he = list(served.slot_req), list(eager.slot_req)
    first = served.token.clone()
    kv_cache.launches = 0
    steps = []
    for step in range(DENSE_STEPS):
        served.step()
        eager.step()
        steps.append(same_batchers(served, eager, hs, he))
        if step == 0:
            first_logits = served.last_logits.clone()
    equal = {key: all(s[key] for s in steps) for key in steps[0]}
    counted, want = kv_cache.launches, 2 * L * DENSE_STEPS
    print(f"dense_batch: 8 slots, lengths about {int(served.slot_len.mean())}: {DENSE_STEPS} "
          f"steps as served (the capture's warm-up, then replays) against {DENSE_STEPS} eager "
          f"kernel-path `_batch_step`s from the same state: bit-equal {equal} (logits; cache, "
          f"lengths and pending tokens; the host's streams); K2 {counted} (want {want}); "
          f"captures {served.graphs.captures}, graph pool {served.graphs.pool_bytes() / 2**20:.1f} "
          f"MiB [{card}]", flush=True)
    if not all(equal.values()) or counted != want:
        raise AssertionError(f"dense_batch: the replayed step disagrees with the eager one: {steps}")

    cosines, same_first = [], True
    for slot, (ids, px, valid) in enumerate(requests):
        last, cache, _ = gen.prefill(model, torch.from_numpy(ids).cuda()[None],
                                     torch.from_numpy(px).cuda()[None],
                                     torch.from_numpy(valid).cuda()[None], cfg, 2048)
        tok = last.argmax(-1)
        same_first &= int(tok[0]) == int(first[slot])
        logits, _ = gen.decode_step(model, cache, tok, cfg)
        cosines.append(cosine(logits[0], first_logits[slot]))
        del cache
    print(f"dense_batch: the first step's logits per slot against the serialized path's "
          f"`decode_step` (B = 1) on the same request: cosine min {min(cosines):.6f} (>= 0.999); "
          f"first tokens equal {same_first} [{card}]", flush=True)
    if not min(cosines) >= 0.999 or not same_first:
        raise AssertionError("dense_batch: the batched step disagrees with the serialized step")

    for name, b in (("replayed", served), ("eager", eager)):
        got = profile_step(b.step, warm=2, timed=8, profiled=4)
        out[f"step_{name}"] = {k: v for k, v in got.items() if k != "items"}
        show_step(f"dense_batch, the {name} 8-slot decode step", "dense_batch", got, card, n=8)
        if int(b.active.sum()) != DENSE_SLOTS:
            raise AssertionError("dense_batch: a slot finished inside the profile")
    out["pool_mib_fixed"] = served.graphs.pool_bytes() / 2**20
    del served, eager
    torch.cuda.empty_cache()

    # A burst of 8 against 8 single steps, both replayed; budgets 2 to 9.
    options = [dict(max_new_tokens=2 + i) for i in range(DENSE_SLOTS)]
    burst = admitted_batcher(model, cfg, requests, DENSE_SLOTS, dense=True, options=options,
                             multi_step=BURST_STEPS)
    single = admitted_batcher(model, cfg, requests, DENSE_SLOTS, dense=True, options=options)
    copy_state(single, burst)
    hb, hs = list(burst.slot_req), list(single.slot_req)
    burst.step()
    for _ in range(BURST_STEPS):
        single.step()
    checks = dict(streams=streams(hb) == streams(hs),
                  device=all(torch.equal(x, y) for x, y in zip(device_state(burst),
                                                                device_state(single))),
                  ended=not burst.active.any() and not single.active.any(),
                  one_burst=(burst.bursts, single.bursts) == (1, 0))
    print(f"dense_batch: a burst of {BURST_STEPS} (replays) against {BURST_STEPS} single "
          f"replayed steps, budgets 2 to 9 (every slot ends inside the burst): {checks} "
          f"[{card}]", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"dense_batch: the burst disagrees with the single steps: {checks}")
    del burst, single
    torch.cuda.empty_cache()

    # --lookahead 4: the dense verify step replayed against decode_verify.
    rep = direct_requests(cfg, seed, DENSE_SLOTS, repeat=True)
    spec = admitted_batcher(model, cfg, rep, DENSE_SLOTS, dense=True, lookahead=SPEC_LOOKAHEAD)
    other = admitted_batcher(model, cfg, rep, DENSE_SLOTS, dense=True, lookahead=SPEC_LOOKAHEAD)
    copy_state(other, spec)

    def eager_verify(toks, valid):
        other.last_logits, _ = gen.decode_verify(model, other.cache, torch.from_numpy(toks).cuda(),
                                                 torch.from_numpy(valid).cuda(), cfg)
        return torch.argmax(other.last_logits, dim=-1).cpu().numpy()

    other._verify_device = eager_verify
    hs, ho = list(spec.slot_req), list(other.slot_req)
    kv_cache.launches = gen.verify_calls = 0
    vsteps = []
    for _ in range(VERIFY_STEPS):
        spec.step()
        other.step()
        vsteps.append(same_batchers(spec, other, hs, ho))
    vequal = {key: all(s[key] for s in vsteps) for key in vsteps[0]}
    vcounts = (kv_cache.launches, gen.verify_calls)
    vwant = (2 * L * VERIFY_STEPS, 2 * VERIFY_STEPS)
    print(f"dense_batch --lookahead {SPEC_LOOKAHEAD}: {VERIFY_STEPS} verify steps of 8 slots "
          f"(S = {SPEC_LOOKAHEAD + 1}; the warm-up, then replays) against {VERIFY_STEPS} eager "
          f"`decode_verify`s with acceptance and rollback: bit-equal {vequal}; {spec.accepted} of "
          f"{spec.proposed} proposals accepted; K2 {vcounts[0]}, verify calls {vcounts[1]} (want "
          f"{vwant}) [{card}]", flush=True)
    if not all(vequal.values()) or vcounts != vwant or spec.accepted == 0:
        raise AssertionError(f"dense_batch: the replayed verify step disagrees: {vsteps}")
    del spec, other
    torch.cuda.empty_cache()
    return out


def run_dense_batch_quant(model, cfg, seed: int, card: str) -> dict:
    """The dense batcher on int8 weights: 8 slots admitted whole, then
    DENSE_STEPS replayed decode steps: K5 224 a step (M = 8, one chunk), no
    dequantize call, K2 32 a step, finite logits; the step's wall, device
    busy and idle share printed."""
    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step
    from vis_zephyr_tpu_torch.ops import kv_cache

    L = cfg.decoder.num_layers
    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, DENSE_SLOTS), DENSE_SLOTS,
                         dense=True)
    reset_routes()
    kv_cache.launches = 0
    for _ in range(DENSE_STEPS):
        b.step()
    routes = read_routes()
    counts = dict(routes, k2=kv_cache.launches)
    want = expected_routes(model, (0, 0), decoder_routes(cfg, DENSE_SLOTS, DENSE_STEPS))
    finite = bool(torch.isfinite(b.last_logits).all())
    got = profile_step(b.step, warm=1, timed=6, profiled=2)
    print(f"dense_batch int{weight_bits(model)}: 8 slots, {DENSE_STEPS} replayed decode steps: "
          f"{show_routes(routes, want)}; K2 {counts['k2']} (want {L * DENSE_STEPS}); logits "
          f"finite {finite}; a step's wall {got['wall_ms']:.2f} ms, device busy "
          f"{got['device_ms']:.2f} ms, idle share {got['idle_share']:.2f} [{card}]", flush=True)
    if routes != want or counts["k2"] != L * DENSE_STEPS or not finite:
        raise AssertionError("dense_batch: the quantized dense step miscounted or is not finite")
    del b
    torch.cuda.empty_cache()
    return counts


def run_sampled(model, cfg, seed: int, card: str) -> dict:
    """Per-request sampling in the replayed steps of both batchers: 8
    requests, the even slots at temperature 0.8 and top-p 0.9, the odd ones
    greedy; slots 0 and 1 with logprobs (top 5), slots 2 and 3 with
    frequency 0.5 and presence 1.0 penalties. Two batchers of a kind from
    the same state and generator state, one stepping as served (replays),
    one through eager kernel-path steps, SAMPLED_STEPS steps: tokens,
    logits, state, counts and logprobs bit for bit; the greedy rows the
    argmax of their (penalized) logits; the logprobs `log_softmax` of the
    step's logits within 1e-3; the penalized slots' counts exactly their
    emitted tokens; the sampled tokens inside their nucleus."""
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    options = [dict(temperature=0.8, top_p=0.9) if slot % 2 == 0 else {} for slot in range(8)]
    for slot in (0, 1):
        options[slot]["logprobs"] = 5
    for slot in (2, 3):
        options[slot].update(frequency_penalty=0.5, presence_penalty=1.0)
    requests = direct_requests(cfg, seed + 7, 8)
    out = {}
    for kind in ("dense", "paged"):
        extra = dict(dense=True) if kind == "dense" else dict(kv_quant=True, kv_fused=True)
        fa.launches = kv_cache.launches = pa.attn_launches = pa.rows_launches = 0
        served = admitted_batcher(model, cfg, requests, 8, options=options, **extra)
        eager = admitted_batcher(model, cfg, requests, 8, options=options, **extra)
        copy_state(eager, served)
        eager_bursts(eager)
        hs, he = list(served.slot_req), list(eager.slot_req)
        checks, lp_err, nucleus_ok = [], 0.0, True
        greedy_ok = True
        for _ in range(SAMPLED_STEPS):
            counts_before = served.counts.clone()
            served.step()
            eager.step()
            checks.append(same_batchers(served, eager, hs, he))
            logits = served.last_logits.float()
            tok = served.token.long()
            pen = logits - 0.5 * counts_before - 1.0 * (counts_before > 0).float()
            for slot in (1, 5, 7):
                greedy_ok &= int(tok[slot]) == int(logits[slot].argmax())
            greedy_ok &= int(tok[3]) == int(pen[3].argmax())
            lsm = torch.log_softmax(logits, dim=-1)
            for slot in (0, 1):
                chosen, ids, lps = hs[slot].lp_log[-1]
                lp_err = max(lp_err, abs(chosen - float(lsm[slot, tok[slot]])),
                             float((torch.from_numpy(lps).cuda()
                                    - lsm[slot, torch.from_numpy(ids).long().cuda()]).abs().max()))
            for slot in (0, 2, 4, 6):
                row = (pen[slot] if slot == 2 else logits[slot]) / 0.8
                srt = torch.sort(row, descending=True).values
                cum = torch.softmax(srt, -1).cumsum(-1)
                cut = srt[min(int((cum < 0.9).sum()), srt.numel() - 1)]
                nucleus_ok &= bool(row[tok[slot]] >= cut)
        equal = {key: all(c[key] for c in checks) for key in checks[0]}
        emitted = {slot: list(hs[slot].out.queue) for slot in (2, 3)}
        counts_ok = all(torch.equal(served.counts[slot].cpu(),
                                    torch.bincount(torch.tensor(emitted[slot]),
                                                   minlength=cfg.decoder.vocab_size).float())
                        for slot in (2, 3))
        counted = dict(k1=fa.launches, k2=kv_cache.launches, k3=pa.attn_launches,
                       k4=pa.rows_launches)
        gates = dict(bit_equal=all(equal.values()), greedy_rows=greedy_ok,
                     logprobs=lp_err <= 1e-3, counts=counts_ok, nucleus=nucleus_ok,
                     replayed=served.graphs.captures >= 1 and served.bursts == 0)
        print(f"sampled {kind}: 8 slots (4 at temperature 0.8, top-p 0.9; 2 with logprobs, 2 "
              f"penalized), {SAMPLED_STEPS} steps as served (replays) against eager kernel-path "
              f"steps from the same generator state: bit-equal {equal}; {gates}; logprobs max "
              f"error against log_softmax {lp_err:.2e}; launches {counted} (both batchers) "
              f"[{card}]", flush=True)
        if not all(gates.values()):
            raise AssertionError(f"sampled {kind}: {gates}, {checks}")
        out[kind] = counted
        del served, eager
        torch.cuda.empty_cache()
    return out


def run_openai(model, cfg, seed: int, card: str) -> dict:
    """The OpenAI endpoints on the port's server in this process
    (`--continuous-batching --max-slots 8`, the dense batcher), the
    stand-in tokenizer and text prompts: GET /v1/models; a chat completion
    as one body and as SSE (the same text, [DONE] last); n = 2 (equal
    greedy choices); a stop string (the text cut before it, finish_reason
    "stop"); logprobs (one entry a token, the greedy token the top-1);
    penalties; `tools` under tool_choice "auto" (free text, no call)."""
    import numpy as np

    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve import api

    parser = argparse.ArgumentParser()
    api.add_engine_args(parser)
    engine = api.engine_from_args(model, cfg, WordTokenizer(cfg.decoder.vocab_size),
                                  parser.parse_args(DENSE_FLAGS + ["--max-new-tokens", "64"]))
    question = make_question(np.random.default_rng(seed + 8), 40)
    chat = {"messages": [{"role": "system", "content": "answer briefly"},
                         {"role": "user", "content": question}], "max_tokens": 12}
    server, thread = start_server(engine)
    port = server.server_address[1]
    checks = {}
    try:
        kv_cache.launches = 0
        t0 = time.perf_counter()
        status, body = post_json(port, "GET", "/v1/models")
        checks["models"] = status == 200 and json.loads(body)["data"][0]["id"] == "vis-zephyr-tpu"
        status, body = post_json(port, "POST", "/v1/chat/completions", chat)
        plain = json.loads(body)
        text = plain["choices"][0]["message"]["content"]
        checks["plain"] = (status == 200 and plain["usage"]["completion_tokens"] == 12
                           and len(text.split()) == 12)
        status, body = post_json(port, "POST", "/v1/chat/completions", dict(chat, stream=True))
        events = [json.loads(line[6:]) for line in body.splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        streamed = "".join(e["choices"][0]["delta"].get("content", "") for e in events
                           if e["choices"])
        checks["sse"] = (status == 200 and body.rstrip().endswith("data: [DONE]")
                         and streamed == text and events[-1]["usage"]["completion_tokens"] == 12)
        status, body = post_json(port, "POST", "/v1/chat/completions", dict(chat, n=2))
        texts = [c["message"]["content"] for c in json.loads(body)["choices"]]
        checks["n2"] = status == 200 and texts == [text, text]
        stop = text.split()[3]
        status, body = post_json(port, "POST", "/v1/chat/completions", dict(chat, stop=[stop]))
        cut = json.loads(body)["choices"][0]
        checks["stop"] = (status == 200 and cut["finish_reason"] == "stop"
                          and text.startswith(cut["message"]["content"])
                          and stop not in cut["message"]["content"])
        status, body = post_json(port, "POST", "/v1/chat/completions",
                                 dict(chat, logprobs=True, top_logprobs=3))
        content = json.loads(body)["choices"][0]["logprobs"]["content"]
        checks["logprobs"] = (status == 200 and len(content) == 12
                              and all(e["top_logprobs"][0]["logprob"] == e["logprob"] <= 0
                                      and e["top_logprobs"][0]["token"] == e["token"]
                                      for e in content)
                              and " ".join(e["token"] for e in content) == text)
        status, body = post_json(port, "POST", "/v1/chat/completions",
                                 dict(chat, frequency_penalty=0.5, presence_penalty=1.5,
                                      temperature=0.8, top_p=0.9))
        checks["sampled_penalized"] = (status == 200
                                       and json.loads(body)["usage"]["completion_tokens"] == 12)
        status, body = post_json(port, "POST", "/v1/chat/completions",
                                 dict(chat, tools=[{"type": "function",
                                                    "function": {"name": "f"}}]))
        auto = json.loads(body) if status == 200 else {}
        checks["tools_auto"] = (status == 200 and auto["usage"]["completion_tokens"] <= 12
                                and "tool_calls" not in auto["choices"][0]["message"])
        wall = time.perf_counter() - t0
        counts = dict(k2=kv_cache.launches)
    finally:
        stop_server(server, thread)
        engine.close()
    print(f"openai: /v1/models, /v1/chat/completions plain, SSE, n = 2, stop {stop!r}, logprobs "
          f"(top 3), sampled with penalties, tools (auto): {checks}; K2 {counts['k2']}; "
          f"{wall:.2f} s for the 8 requests [{card}]", flush=True)
    if not all(checks.values()) or counts["k2"] == 0:
        raise AssertionError(f"openai: {checks}")
    return counts


DRAFT_LAYERS = 2   # the small draft's decoder depth, at the published widths
# The draft phase's paged slots and requests: a draft keeps a dense cache of
# its own, which for the target drafting for itself is 17.2 GiB at 16 slots
# of 2048 rows (34.4 at the paged phase's 32).
DRAFT_SLOTS = 16
DRAFT_PAGED_FLAGS = ["--continuous-batching", "--kv-cache", "paged", "--kv-quant", "--max-slots",
                     str(DRAFT_SLOTS)]
DRAFT_ROUNDS = 3   # proposal rounds held bit for bit: the capture's warm-up, then replays


def write_small_draft(seed: int, cfg, root: str) -> str:
    """A random draft model dir beside the target: decoder depth DRAFT_LAYERS
    at the published widths and the same vocabulary, its vision tower cut to
    the 21 layers the fusion selects and its Q-Former to one block (only its
    decoder runs); the port's params-only `state/state.pt`, `config.json`
    and the Zephyr-form `tokenizer.json`."""
    from vis_zephyr_tpu_torch.models.vis_zephyr import init_vis_zephyr

    dcfg = cfg.replace(
        vision=dataclasses.replace(cfg.vision, num_layers=cfg.vision.num_selected_layers),
        projector=dataclasses.replace(cfg.projector, num_blocks=1),
        decoder=dataclasses.replace(cfg.decoder, num_layers=DRAFT_LAYERS))
    draft = init_vis_zephyr(dcfg, torch.Generator("cuda").manual_seed(seed + 11), device="cuda",
                            dtype=torch.bfloat16)
    path = os.path.join(root, "draft")
    os.makedirs(os.path.join(path, "state"))
    t0 = time.perf_counter()
    torch.save({"params": draft.state_dict()}, os.path.join(path, "state", "state.pt"))
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(dcfg.to_json())
    write_zephyr_tokenizer(os.path.join(path, "tokenizer.json"), dcfg.decoder.vocab_size)
    n_params = sum(p.numel() for p in draft.parameters())
    n_decoder = sum(p.numel() for p in draft.decoder.parameters())
    print(f"draft: a random draft model (decoder {DRAFT_LAYERS} layers at the published widths, "
          f"{n_decoder / 1e9:.3f} B of its {n_params / 1e9:.3f} B params; vision cut to "
          f"{dcfg.vision.num_layers} layers, Q-Former to 1 block) saved as state/state.pt "
          f"({dir_bytes(os.path.join(path, 'state')) / 2**30:.2f} GiB) with config.json and "
          f"tokenizer.json in {time.perf_counter() - t0:.2f} s")
    return path


def draft_histories(cfg, seed: int, n: int) -> list:
    """`n` slot histories as the batchers hand them to a draft: a request's
    vocabulary tokens (image sentinels dropped), then a pending token."""
    import numpy as np

    rng = np.random.default_rng(seed + 12)
    return [[int(t) for t in ids if t >= 0] + [int(rng.integers(3, cfg.decoder.vocab_size))]
            for ids, _, _ in direct_requests(cfg, seed, n)]


def draft_state(d) -> list:
    return [d.cache["k"], d.cache["v"], d.cache["length"], d.token]


def eager_draft_burst(d, single: bool = False) -> None:
    """Make DraftModel `d` run its proposal bursts as eager kernel-path
    `_batch_step`s where a served draft replays its captured step: with the
    carry on the device, or (`single`) one step at a time with the host
    taking each step's logits, choosing every token (greedy) and writing it
    back before the next step."""
    import numpy as np

    from vis_zephyr_tpu_torch.serve.batching import _batch_step

    pad = d.cfg.decoder.pad_token_id

    def burst(n):
        alive, left = d._active_dev.clone(), d._left_dev.clone()
        toks = []
        for _ in range(n):
            tok, logits = _batch_step(d.model, d.cache, d.token, alive, None, d.cfg, d.SAMPLING)
            left -= 1
            if single:
                live = alive.cpu().numpy()
                chosen = np.where(live, logits.cpu().numpy().argmax(-1), pad)
                tok = torch.from_numpy(chosen).to(d.device)
                d.token.copy_(tok)
                alive = torch.from_numpy(live & (left.cpu().numpy() > 0)).to(d.device)
            else:
                alive = alive & (left > 0)
            toks.append(tok.clone())
        return torch.stack(toks)

    d._burst = burst


def time_draft_burst(d, active, pending, label: str, card: str) -> dict:
    """One proposal round of DraftModel `d` (already admitted), every active
    slot allowed SPEC_LOOKAHEAD proposals: its first call the capture, then
    its wall, device busy and idle share (a round re-proposes from the same
    committed mirror, so the state does not move)."""
    import numpy as np

    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step

    caps = np.where(active, SPEC_LOOKAHEAD, 0)
    got = profile_step(lambda: d.propose(active, pending, caps, SPEC_LOOKAHEAD), warm=2, timed=8,
                       profiled=3)
    n = SPEC_LOOKAHEAD + 1
    print(f"draft burst, {label}: {int(active.sum())} slots, {n} steps a round (span "
          f"{SPEC_LOOKAHEAD} + the feed): wall {got['wall_ms']:.3f} ms a round "
          f"({got['wall_min_ms']:.3f}-{got['wall_max_ms']:.3f}), device busy "
          f"{got['device_ms']:.3f} ms, idle share {got['idle_share']:.2f}, "
          f"{got['launches'] / n:.1f} launches a step; captures {d.graphs.captures} in "
          f"{d.graphs.capture_seconds:.3f} s [{card}]", flush=True)
    return {k: v for k, v in got.items() if k != "items"}


def check_draft_bursts(small, cfg, seed: int, card: str) -> dict:
    """The small draft's proposal bursts held bit for bit: three DraftModels
    over DRAFT_SLOTS slots admitted with the same histories (one slot idle),
    one served (each round a replay of its captured burst after the first,
    the capture's warm-up), one with eager bursts and the carry on the
    device, one stepping singly with the host choosing each token. Over
    DRAFT_ROUNDS rounds (caps 1 to SPEC_LOOKAHEAD, one slot capped at 0 in
    round 2, which stops drafting it; a seeded accepted prefix and a new
    pending token each round) every round's proposals, the length mirror and
    the draft cache (K, V, lengths, tokens) are equal; K1 = layers x
    admissions and K2 = layers x draft steps exactly; then the served
    draft's round timed."""
    import numpy as np

    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve.draft import DraftModel

    dmodel, dcfg = small
    Ld = dcfg.decoder.num_layers
    hists = draft_histories(cfg, seed, DRAFT_SLOTS)
    drafts = [DraftModel(dmodel, dcfg, DRAFT_SLOTS) for _ in range(3)]
    eager_draft_burst(drafts[1])
    eager_draft_burst(drafts[2], single=True)
    active = np.arange(DRAFT_SLOTS) < DRAFT_SLOTS - 1
    fa.launches = kv_cache.launches = 0
    for d in drafts:
        for slot in np.flatnonzero(active):
            d.admit(int(slot), hists[slot])
    admitted = all(torch.equal(x, y) for d in drafts[1:]
                   for x, y in zip(draft_state(drafts[0]), draft_state(d)))
    rng = np.random.default_rng(seed + 13)
    pending = np.array([h[-1] for h in hists])
    rounds = []
    for r in range(DRAFT_ROUNDS):
        caps = np.where(active, rng.integers(1, SPEC_LOOKAHEAD + 1, DRAFT_SLOTS), 0)
        if r == 1:
            caps[1] = 0
        props = [[None if p is None else p.tolist() for p in d.propose(active, pending, caps,
                                                                       SPEC_LOOKAHEAD)]
                 for d in drafts]
        torch.cuda.synchronize()
        rounds.append(dict(
            proposals=props[0] == props[1] == props[2],
            cache=all(torch.equal(x, y) for d in drafts[1:]
                      for x, y in zip(draft_state(drafts[0]), draft_state(d))),
            drafted=sum(p is not None for p in props[0])))
        for slot in np.flatnonzero(active):
            prop = props[0][slot]
            n_ok = int(rng.integers(0, len(prop) + 1)) if prop is not None else 0
            for d in drafts:
                d.commit(int(slot), 1 + n_ok)
            pending[slot] = int(rng.integers(3, cfg.decoder.vocab_size))
        for d in drafts:
            d.rollback()
        rounds[-1]["mirror"] = (drafts[0].len.tolist() == drafts[1].len.tolist()
                                == drafts[2].len.tolist())
    counts = (fa.launches, kv_cache.launches)
    want = (Ld * sum(d.admissions for d in drafts), Ld * sum(d.steps for d in drafts))
    equal = {key: all(r[key] for r in rounds) for key in ("proposals", "cache", "mirror")}
    print(f"draft bursts: {DRAFT_ROUNDS} rounds over {DRAFT_SLOTS} slots (one idle; "
          f"{[r['drafted'] for r in rounds]} drafting), served (the capture's warm-up, then "
          f"replays) against eager bursts and against single steps with the host choosing each "
          f"token, from the same admitted state (equal: {admitted}): bit-equal {equal}; K1 "
          f"{counts[0]}, K2 {counts[1]} (want {Ld} x {want[0] // Ld} admissions, {Ld} x "
          f"{want[1] // Ld} draft steps) [{card}]", flush=True)
    if not (admitted and all(equal.values()) and counts == want
            and rounds[1]["drafted"] < rounds[0]["drafted"]):
        raise AssertionError(f"draft: the replayed proposal burst disagrees: {rounds}")
    timed = time_draft_burst(drafts[0], active & (drafts[0].len > 0), pending,
                             f"the small draft ({Ld} layers)", card)
    del drafts
    torch.cuda.empty_cache()
    return timed


def run_draft_server(model, cfg, seed: int, new_tokens: int, card: str, flags, label: str,
                     draft, n: int) -> dict:
    """The server built from `flags` through `serve/api.py`'s argument path
    (`check_engine_args`, then `engine_from_args` with `draft`, the (model,
    cfg) that `load_draft` gave) under `n` concurrent POST /v1/completions
    of text prompts of about 40, 300 and 600 words (text, so that a draft,
    which sees a prompt's vocabulary tokens alone, conditions on all of it),
    after one warm-up request (the captures) outside the counted run: every
    answer HTTP 200 with all its tokens; launches exact: K1 = draft layers x
    draft admissions (the target admits in chunks), K2 = 32 x the target's
    chunks (and, dense, its verify or decode steps) + draft layers x draft
    steps, paged K3 = 32 x steps with K4 or paged_kv_update as the step;
    every request a draft admission; GET /metrics' requests, TTFT count and
    proposals those of the batcher; every slot (and page) free at the end."""
    import numpy as np

    from vis_zephyr_tpu_torch.data.tokenization import tokenize_with_images
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve import api
    from vis_zephyr_tpu_torch.utils.metrics import ServingMetrics

    L = cfg.decoder.num_layers
    tok = WordTokenizer(cfg.decoder.vocab_size)
    parser = argparse.ArgumentParser()
    api.add_engine_args(parser)
    a = parser.parse_args(flags + ["--max-new-tokens", str(new_tokens)])
    api.check_engine_args(parser, a)
    engine = api.engine_from_args(model, cfg, tok, a, draft)
    b, d = engine.batcher, engine.batcher.draft
    Ld = 0 if d is None else d.cfg.decoder.num_layers
    paged = hasattr(b, "kp")
    rng = np.random.default_rng(seed + 5)
    prompts = [make_question(rng, QUESTION_WORDS[(i // 3) % 3]) for i in range(n)]
    chunks = sum(-(-len(tokenize_with_images(p, tok)) // b.prefill_chunk) for p in prompts)
    server, thread = start_server(engine)
    port = server.server_address[1]

    def complete(prompt):
        status, body = post_json(port, "POST", "/v1/completions",
                                 {"prompt": prompt, "max_tokens": new_tokens})
        answer = json.loads(body) if status == 200 else {}
        return status, answer

    try:
        complete(prompts[0])  # the captures, outside the counted run
        # The reply ends inside the pump's last step, which counts itself
        # after: stop the pump before the counts go to 0 (the burst starts
        # another).
        engine.close()
        fa.launches = kv_cache.launches = pa.attn_launches = pa.rows_launches = 0
        pa.update_launches = 0
        b.steps = b.slots_stepped = b.verify_steps = b.proposed = b.accepted = b.bursts = 0
        if d is not None:
            d.admissions = d.steps = 0
        engine.metrics = b.metrics = ServingMetrics()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n) as pool:
            results = list(pool.map(complete, prompts))
        wall = time.perf_counter() - t0
        counts = dict(k1=fa.launches, k2=kv_cache.launches, k3=pa.attn_launches,
                      k4=pa.rows_launches, kvu=pa.update_launches)
        summary = json.loads(post_json(port, "GET", "/metrics")[1])
    finally:
        stop_server(server, thread)
        engine.close()
    streams = []
    for i, (status, answer) in enumerate(results):
        words = answer["choices"][0]["text"].split() if status == 200 else []
        if len(words) != new_tokens or answer["usage"]["completion_tokens"] != new_tokens:
            raise AssertionError(f"{label} request {i}: HTTP {status}, {len(words)} tokens "
                                 f"(want {new_tokens}): {answer}")
        streams.append(words)
    spec = b.lookahead > 0
    steps = b.verify_steps if spec else b.steps
    admissions, draft_steps = (0, 0) if d is None else (d.admissions, d.steps)
    want = dict(k1=Ld * admissions, k2=L * chunks + (0 if paged else L * steps) + Ld * draft_steps,
                k3=L * steps if paged else 0, k4=steps if paged and not spec else 0,
                kvu=L * steps if paged and spec else 0)
    proposed = summary.get("speculation", {}).get("proposed", 0)
    acceptance = summary.get("speculation", {}).get("acceptance_rate")
    kind = f"verify steps (S = {b.lookahead + 1})" if spec else "decode steps"
    line = (f"{label}: {n} completions, all HTTP 200 with {new_tokens} tokens; {steps} {kind}, "
            f"{b.slots_stepped / steps:.2f} of {b.max_slots} slots a step; launches {counts} "
            f"(want {want}: K1 {Ld} x {admissions} draft admissions, K2 {L} x {chunks} chunks"
            f"{'' if paged else f' + {L} x {steps} steps'} + {Ld} x {draft_steps} draft steps); "
            f"server TTFT p50 {summary['ttft_ms']['p50']} ms, mean {summary['ttft_ms']['mean']} "
            f"ms, TPOT mean {summary['tpot_ms']['mean']} ms; {n * new_tokens / wall:.1f} "
            f"tokens/s over all slots")
    if spec:
        line += (f"; {b.proposed} proposed, {b.accepted} accepted; GET /metrics acceptance rate "
                 f"{acceptance}")
    print(f"{line} [{card}]", flush=True)
    if (counts != want or (d is not None and admissions != n) or (spec and (b.steps or not steps))
            or summary["requests"] != n or summary["ttft_ms"]["count"] != n
            or proposed != b.proposed or b.has_work or b.active.any()
            or (paged and b.allocator.available != b.num_pages - 1)):
        raise AssertionError(f"{label}: miscounted, or the metrics or slots disagree: {counts}, "
                             f"{want}, {summary}")
    return dict(counts, tokens_per_s=n * new_tokens / wall, acceptance=acceptance,
                draft_steps=draft_steps, steps=steps, streams=streams)


def run_draft(model, cfg, seed: int, new_tokens: int, card: str) -> dict:
    """Two-model speculation (the draft phase): the small draft written,
    loaded through the server's flags and held bit for bit
    (`check_draft_bursts`); the target's own burst as a draft timed; then
    each batcher served without speculation, with prompt lookup, with the
    target as its own draft and with the small draft (`run_draft_server`),
    and what the four give printed side by side. Returns each batcher's
    launches summed over its four runs."""
    import shutil
    import tempfile

    import numpy as np

    from vis_zephyr_tpu_torch.serve import api
    from vis_zephyr_tpu_torch.serve.draft import DraftModel

    lookahead = ["--lookahead", str(SPEC_LOOKAHEAD)]
    root = tempfile.mkdtemp(prefix="vzt_draft_")
    try:
        path = write_small_draft(seed, cfg, root)
        parser = argparse.ArgumentParser()
        api.add_engine_args(parser)
        a = parser.parse_args(DRAFT_PAGED_FLAGS + ["--draft-model", path])
        api.check_engine_args(parser, a)
        t0 = time.perf_counter()
        small = api.load_draft(a, "cuda")
        torch.cuda.synchronize()
        print(f"draft: --draft-model loaded by `load_draft` in {time.perf_counter() - t0:.2f} s: "
              f"{small[1].decoder.num_layers} decoder layers, {small[0].dtype}; --lookahead "
              f"{a.lookahead} (the flag's default with a draft)", flush=True)
        if (a.lookahead != SPEC_LOOKAHEAD or small[1].decoder.num_layers != DRAFT_LAYERS
                or small[0].dtype != torch.bfloat16):
            raise AssertionError("draft: the flags did not load the draft as written")
        check_draft_bursts(small, cfg, seed, card)

        # The target drafting for itself: its burst at the paged run's slots.
        d = DraftModel(model, cfg, DRAFT_SLOTS)
        hists = draft_histories(cfg, seed, DRAFT_SLOTS)
        for slot, hist in enumerate(hists):
            d.admit(slot, hist)
        time_draft_burst(d, np.ones(DRAFT_SLOTS, bool), np.array([h[-1] for h in hists]),
                         "the target as its own draft (32 layers)", card)
        del d
        torch.cuda.empty_cache()

        out = {}
        for name, flags, n in (("paged", DRAFT_PAGED_FLAGS, DRAFT_SLOTS),
                               ("dense", DENSE_FLAGS, DENSE_SLOTS)):
            runs = {}
            for kind, extra, draft in (("neither", [], (None, None)),
                                       ("lookup", lookahead, (None, None)),
                                       ("self", lookahead, (model, cfg)),
                                       ("small", ["--draft-model", path], small)):
                runs[kind] = run_draft_server(model, cfg, seed, new_tokens, card, flags + extra,
                                              f"draft {name}, {kind}", draft, n)
                gc.collect()  # the servers' handler classes hold their engines in cycles
                torch.cuda.empty_cache()
            agree = {f"{kind} vs {ref}": sorted(map(first_divergence, runs[kind]["streams"],
                                                    runs[ref]["streams"]))
                     for kind in ("self", "small") for ref in ("lookup", "neither")}
            print(f"draft {name}: tokens/s over all slots, no speculation "
                  f"{runs['neither']['tokens_per_s']:.1f}, prompt lookup "
                  f"{runs['lookup']['tokens_per_s']:.1f}, the target as its own draft "
                  f"{runs['self']['tokens_per_s']:.1f}, the {DRAFT_LAYERS}-layer draft "
                  f"{runs['small']['tokens_per_s']:.1f}; GET /metrics acceptance rate: lookup "
                  f"{runs['lookup']['acceptance']}, self {runs['self']['acceptance']}, small "
                  f"{runs['small']['acceptance']}; verify steps {runs['lookup']['steps']} / "
                  f"{runs['self']['steps']} / {runs['small']['steps']} against "
                  f"{runs['neither']['steps']} decode steps; first divergence of each request's "
                  f"{new_tokens} tokens: {agree} (bf16: a verify's S-row append and a decode "
                  f"step round differently, so greedy ties may break apart) [{card}]", flush=True)
            out[name] = {key: sum(run[key] for run in runs.values())
                         for key in ("k1", "k2", "k3", "k4", "kvu")}
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


PREFIX_TOKENS = 1024  # the shared prefix: 8 pages of 128, 4 chunks of 256
PREFIX_SUFFIXES = (40, 63, 86, 109, 131, 154, 177, 200)  # distinct suffixes: prompts pad to 1280
PREFIX_NEW_TOKENS = 16
LAZY_SLOTS, LAZY_REQUESTS, LAZY_PROMPT = 16, 24, 512
# 80 usable pages: 16 admissions of 5 pages (512 tokens + one row) fill the
# pool, so every slot that grows into its 6th page forces a swap.
LAZY_PAGES = 81
SWAP_SERVER_FLAGS = ["--continuous-batching", "--kv-cache", "paged", "--kv-quant", "--max-slots",
                     "16", "--prefix-cache", "--lazy-alloc", "--num-pages", "48"]
SWAP_SERVER_TOKENS = 200


def reset_paged_counts() -> None:
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    fa.launches = kv_cache.launches = pa.attn_launches = pa.rows_launches = 0
    pa.update_launches = 0


def read_paged_counts() -> dict:
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    return dict(k1=fa.launches, k2=kv_cache.launches, k3=pa.attn_launches, k4=pa.rows_launches,
                kvu=pa.update_launches)


def ended_streams(handles) -> list:
    """Each drained request's tokens, read without blocking: a stream that
    did not end raises instead of waiting for ever."""
    outs = [list(h.out.queue) for h in handles]
    if not all(out and out[-1] is None for out in outs):
        raise AssertionError("a request's stream did not end")
    return [out[:-1] for out in outs]


def prefix_requests(cfg, seed: int) -> list:
    """Eight text-only prompts from `WordTokenizer`: one 1024-token prefix
    (BOS and 1023 words), then a distinct suffix of 40 to 200 words each."""
    import numpy as np

    tok = WordTokenizer(cfg.decoder.vocab_size)
    rng = np.random.default_rng(seed + 9)
    prefix = tok(make_question(rng, PREFIX_TOKENS)).input_ids[:PREFIX_TOKENS]
    return [np.asarray(prefix + tok(make_question(rng, n)).input_ids[1:], np.int64)
            for n in PREFIX_SUFFIXES]


def drive_prefix(model, cfg, requests, warm: bool, quant: bool) -> dict:
    """A PagedBatcher on KV-fused pools (page 128, chunk 256), with the
    prefix cache when `warm`: the first request run to its end, then the
    other seven at once. Returns the streams, each request's prefill logits,
    the launches, the cache's counters and the first of the seven's admission
    wall (submit to first token on the host clock; the first token's copy to
    the host synchronizes)."""
    from vis_zephyr_tpu_torch.serve.generate import SamplingConfig
    from vis_zephyr_tpu_torch.serve.paged import PagedBatcher

    b = PagedBatcher(model, cfg, max_slots=8, cache_len=2048, prefill_chunk=256, kv_fused=True,
                     kv_quant=quant, prefix_cache=warm,
                     sampling=SamplingConfig(max_new_tokens=PREFIX_NEW_TOKENS, eos_token_id=-1))
    logits = {}
    install = b._install

    def recording_install(req, slot, last_logits, *rest):
        logits[req.request_id] = last_logits.float().clone()
        return install(req, slot, last_logits, *rest)

    b._install = recording_install
    reset_paged_counts()
    handles = [b.submit(requests[0])]
    b.run_until_drained()
    handles += [b.submit(ids) for ids in requests[1:]]
    b.run_until_drained()
    torch.cuda.synchronize()
    counts = read_paged_counts()
    first = handles[1]
    return dict(streams=ended_streams(handles),
                logits=[logits[h.request_id] for h in handles], counts=counts, steps=b.steps,
                hits=b.prefix_cache.hits if warm else 0,
                pages_reused=b.prefix_cache.pages_reused if warm else 0,
                admission_s=first.first_token_at - first.submitted_at, batcher=b)


def drive_lazy(model, cfg, prompts, budgets, lazy: bool) -> dict:
    """24 requests on 16 slots (int8 fused pools, chunks of 256): lazy on a
    pool of 80 usable pages, or eager on the default pool (128, room for every
    full span). Every decode step is a replay of the captured step. Returns
    the streams, launches, steps, captures and the swaps' counts, bytes and
    times (each swap timed on the host clock between two synchronizes)."""
    from vis_zephyr_tpu_torch.serve.generate import SamplingConfig
    from vis_zephyr_tpu_torch.serve.paged import PagedBatcher
    from vis_zephyr_tpu_torch.utils.metrics import ServingMetrics

    b = PagedBatcher(model, cfg, max_slots=LAZY_SLOTS, cache_len=2048, prefill_chunk=256,
                     kv_fused=True, kv_quant=True, lazy_alloc=lazy,
                     num_pages=LAZY_PAGES if lazy else None, metrics=ServingMetrics(),
                     sampling=SamplingConfig(eos_token_id=-1))
    swaps = {"out": [0, 0.0], "in": [0, 0.0]}  # bytes of raw pool rows, seconds

    def snapshot_bytes(slot) -> int:
        return sum(t.nbytes for key, t in b._swapped[slot].items() if key not in ("n", "token"))

    def timed(kind, fn):
        def run(slot, *args):
            if kind == "in":
                swaps[kind][0] += snapshot_bytes(slot)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(slot, *args)
            torch.cuda.synchronize()
            swaps[kind][1] += time.perf_counter() - t0
            if kind == "out":
                swaps[kind][0] += snapshot_bytes(slot)
        return run

    b._swap_out, b._swap_in = timed("out", b._swap_out), timed("in", b._swap_in)
    reset_paged_counts()
    t0 = time.perf_counter()
    handles = [b.submit(ids, max_new_tokens=int(n)) for ids, n in zip(prompts, budgets)]
    b.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(streams=ended_streams(handles), counts=read_paged_counts(),
                steps=b.steps, captures=b.graphs.captures, wall=wall, swaps=swaps,
                swap_out=b.metrics.preempt_swap_out, swap_in=b.metrics.preempt_swap_in,
                free=b.allocator.available, num_pages=b.num_pages,
                clean=not b.has_work and not b.page_table.any())


def run_prefix_swap(model, cfg, seed: int, card: str) -> dict:
    """The paged batcher's prefix cache and lazy allocation at full width
    (the prefix_swap phase): warm against cold admission on bf16 and int8
    fused pools, lazy against eager allocation over 24 requests on 16 slots,
    and the server with `--prefix-cache --lazy-alloc --kv-quant` under
    concurrent /v1/completions. Returns the launches summed over its runs."""
    import numpy as np

    from vis_zephyr_tpu_torch.serve import api

    L = cfg.decoder.num_layers
    total = dict(k1=0, k2=0, k3=0, k4=0, kvu=0)

    def add(counts):
        for key in total:
            total[key] += counts[key]

    # -- the prefix cache -------------------------------------------------------
    requests = prefix_requests(cfg, seed)
    chunks = [-(-len(ids) // 256) for ids in requests]
    skipped = PREFIX_TOKENS // 256  # chunks a warm admission skips
    runs = {}
    for name, warm, quant in (("bf16 cold", False, False), ("bf16 warm", True, False),
                              ("int8 cold", False, True), ("int8 warm", True, True),
                              ("int8 warm again", True, True)):
        runs[name] = run = drive_prefix(model, cfg, requests, warm, quant)
        add(run["counts"])
        k2_want = L * (sum(chunks) - (skipped * (len(requests) - 1) if warm else 0))
        c = run["counts"]
        b = run["batcher"]
        ok = (c["k2"] == k2_want and c["k3"] == L * run["steps"] and c["k4"] == run["steps"]
              and c["k1"] == 0 and all(len(s) == PREFIX_NEW_TOKENS for s in run["streams"])
              and not b.active.any() and not b.page_table.any())
        print(f"prefix_swap {name}: {len(requests)} prompts of {[len(r) for r in requests]} "
              f"tokens ({PREFIX_TOKENS} shared), {run['steps']} decode steps; K2 "
              f"dense_cache_append {c['k2']} (want {L} x {k2_want // L} chunks = {k2_want}), K3 "
              f"{c['k3']} (want {L} x steps), K4 {c['k4']} (want steps), K1 {c['k1']} (want 0); "
              f"cache hits {run['hits']}, pages reused {run['pages_reused']}; admission wall of "
              f"the first of the seven (submit to first token): "
              f"{run['admission_s'] * 1e3:.1f} ms [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"prefix_swap {name}: launches or streams not as counted")
        run.pop("batcher")
        del b
    cold, warm = runs["bf16 cold"], runs["bf16 warm"]
    same_logits = [torch.equal(a, b) for a, b in zip(cold["logits"], warm["logits"])]
    print(f"prefix_swap bf16: warm tokens equal cold on {sum(a == b for a, b in zip(warm['streams'], cold['streams']))} "
          f"of {len(requests)} requests; prefill logits bit-equal on {sum(same_logits)}; "
          f"hits {warm['hits']} (want >= 7), pages reused {warm['pages_reused']} (want >= 56); "
          f"admission wall {warm['admission_s'] * 1e3:.1f} ms warm, "
          f"{cold['admission_s'] * 1e3:.1f} ms cold [{card}]", flush=True)
    if (warm["streams"] != cold["streams"] or warm["hits"] < len(requests) - 1
            or warm["pages_reused"] < (len(requests) - 1) * PREFIX_TOKENS // 128):
        raise AssertionError("prefix_swap: a warm admission on bf16 pools did not give the "
                             "cold tokens, or the cache did not hit")
    q_cold, q_warm, q_again = runs["int8 cold"], runs["int8 warm"], runs["int8 warm again"]
    diverge = [first_divergence(a, b) for a, b in zip(q_warm["streams"], q_cold["streams"])]
    cosines = [cosine(a, b) for a, b in zip(q_warm["logits"], q_cold["logits"])]
    repeat = (q_warm["streams"] == q_again["streams"]
              and all(torch.equal(a, b) for a, b in zip(q_warm["logits"], q_again["logits"])))
    print(f"prefix_swap int8: two warm runs equal bit for bit (tokens and prefill logits): "
          f"{repeat}; warm against cold (the suffix attends the int8-rounded prefix): first "
          f"divergence per request {diverge} of {PREFIX_NEW_TOKENS}, prefill last-logit cosine "
          f"min {min(cosines):.6f}; hits {q_warm['hits']}, pages reused "
          f"{q_warm['pages_reused']} [{card}]", flush=True)
    if not repeat or q_warm["hits"] < len(requests) - 1:
        raise AssertionError("prefix_swap: two warm runs on int8 pools differ, or no hit")

    # -- lazy allocation and host swap --------------------------------------------
    tok = WordTokenizer(cfg.decoder.vocab_size)
    rng = np.random.default_rng(seed + 10)
    prompts = [np.asarray(tok(make_question(rng, LAZY_PROMPT)).input_ids[:LAZY_PROMPT], np.int64)
               for _ in range(LAZY_REQUESTS)]
    budgets = rng.integers(64, 257, LAZY_REQUESTS)
    spans = [-(-(LAZY_PROMPT + int(n)) // 128) for n in budgets]
    eager = drive_lazy(model, cfg, prompts, budgets, lazy=False)
    torch.cuda.empty_cache()
    lazy = drive_lazy(model, cfg, prompts, budgets, lazy=True)
    for run in (eager, lazy):
        add(run["counts"])
    same = sum(a == b for a, b in zip(lazy["streams"], eager["streams"]))
    (out_bytes, out_s), (in_bytes, in_s) = lazy["swaps"]["out"], lazy["swaps"]["in"]
    print(f"prefix_swap lazy: {LAZY_REQUESTS} requests of {LAZY_PROMPT} tokens, budgets "
          f"{int(budgets.min())}-{int(budgets.max())}, on {LAZY_SLOTS} slots; full spans of the "
          f"first {LAZY_SLOTS}: {sum(spans[:LAZY_SLOTS])} pages against {lazy['num_pages'] - 1} "
          f"usable (eager: {eager['num_pages'] - 1}); swaps out {lazy['swap_out']}, in "
          f"{lazy['swap_in']}; {out_bytes / 2**20:.1f} MiB of raw pool rows swapped out in "
          f"{out_s * 1e3:.1f} ms ({out_bytes / max(out_s, 1e-9) / 1e9:.2f} GB/s), "
          f"{in_bytes / 2**20:.1f} MiB in in {in_s * 1e3:.1f} ms "
          f"({in_bytes / max(in_s, 1e-9) / 1e9:.2f} GB/s); tokens equal to eager allocation's "
          f"on {same} of {LAZY_REQUESTS}; decode steps {lazy['steps']} lazy, {eager['steps']} "
          f"eager, captured steps {lazy['captures']} and {eager['captures']}; wall "
          f"{lazy['wall']:.2f} s lazy, {eager['wall']:.2f} s eager [{card}]", flush=True)
    for name, run in (("eager", eager), ("lazy", lazy)):
        c = run["counts"]
        want = (L * 2 * LAZY_REQUESTS, L * run["steps"], run["steps"])
        print(f"prefix_swap {name} counters: K2 {c['k2']}, K3 {c['k3']}, K4 {c['k4']} (want "
              f"{want}); allocator {run['free']} of {run['num_pages'] - 1} free, table clear "
              f"{run['clean']}")
        if (c["k2"], c["k3"], c["k4"]) != want or not run["clean"] or \
                run["free"] != run["num_pages"] - 1:
            raise AssertionError(f"prefix_swap {name}: launches not as counted, or pages leaked")
    if (lazy["streams"] != eager["streams"] or lazy["swap_out"] < 1 or lazy["swap_in"] < 1
            or lazy["captures"] != eager["captures"]):
        raise AssertionError("prefix_swap: lazy allocation did not give eager allocation's "
                             "tokens, did not swap, or recaptured its step")

    # -- the server -------------------------------------------------------------------
    parser = argparse.ArgumentParser()
    api.add_engine_args(parser)
    flags = parser.parse_args(SWAP_SERVER_FLAGS + ["--max-new-tokens", str(SWAP_SERVER_TOKENS)])
    engine = api.engine_from_args(model, cfg, WordTokenizer(cfg.decoder.vocab_size), flags)
    b = engine.batcher
    rng = np.random.default_rng(seed + 11)
    shared = make_question(rng, 1100)
    prompts = [f"{shared} {make_question(rng, 20 + 3 * i)}" for i in range(b.max_slots)]
    server, thread = start_server(engine)
    port = server.server_address[1]
    try:
        reset_paged_counts()
        b.steps = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as pool:
            replies = list(pool.map(lambda p: post_json(port, "POST", "/v1/completions", {
                "prompt": p, "max_tokens": SWAP_SERVER_TOKENS}), prompts))
        wall = time.perf_counter() - t0
        counts = read_paged_counts()
        summary = json.loads(post_json(port, "GET", "/metrics")[1])
    finally:
        stop_server(server, thread)
        engine.close()
    add(counts)
    done = [status == 200 and json.loads(body)["usage"]["completion_tokens"] == SWAP_SERVER_TOKENS
            for status, body in replies]
    pc, pre = summary.get("prefix_cache", {}), summary.get("preemption", {})
    print(f"prefix_swap server: flags {' '.join(SWAP_SERVER_FLAGS)} -> {b.num_pages} pages of "
          f"{b.page_size}, chunk {b.prefill_chunk}; {len(prompts)} concurrent /v1/completions on "
          f"a 1100-word prefix: {sum(done)} HTTP 200 with {SWAP_SERVER_TOKENS} tokens; GET "
          f"/metrics prefix_cache {pc}, preemption {pre}, requests {summary.get('requests')}; "
          f"{b.steps} decode steps, K2 {counts['k2']}, K3 {counts['k3']} (want {L} x steps), K4 "
          f"{counts['k4']} (want steps); {len(prompts) * SWAP_SERVER_TOKENS / wall:.1f} tokens/s "
          f"over all slots in {wall:.2f} s [{card}]", flush=True)
    if (not all(done) or pc.get("hits", 0) < 1 or pre.get("swap_out", 0) < 1
            or pre.get("swap_in", 0) < 1 or counts["k3"] != L * b.steps
            or counts["k4"] != b.steps or counts["k2"] == 0):
        raise AssertionError("prefix_swap server: a request failed, or /metrics shows no cache "
                             "hit or no swap, or the launches are not as counted")
    return total


MLORA_RANK, MLORA_ALPHA = 128, 256   # the reference's stage-2 r and alpha (LOAD_LORA)
MLORA_NAMES = ("a", "b")
MLORA_MIX = (0, 1, 2, 0, 1, 2)       # the fixed batch's adapters a slot: base, a, b twice
MLORA_STEPS = 8                       # the fixed batch's compared decode steps
MLORA_SERVER_FLAGS = ["--continuous-batching", "--kv-cache", "paged", "--kv-quant",
                      "--max-slots", "8", "--max-new-tokens", "16"]
MLORA_PREFIX_WORDS = 700              # the prefix cache's prompt: 5 pages of 128
_mlora_state: dict = {}               # the pack, kept for the int8 part


def write_adapter_dirs(cfg, seed: int, root: str) -> dict:
    """Two random peft adapters at the published widths, all seven targets in
    every layer (r = 128, alpha = 256; A ~ N(0, 1/K), B ~ N(0, 0.02^2), drawn
    in f32 on the card and saved in bf16 as `adapter_model.bin`, since the
    card's machine has no safetensors). Returns {name: dir}."""
    from vis_zephyr_tpu_torch.ops.mlora import MODULES, target_dims

    gen = torch.Generator("cuda").manual_seed(seed + 21)
    dims = target_dims(cfg)
    dirs = {}
    for name in MLORA_NAMES:
        sd = {}
        for i in range(cfg.decoder.num_layers):
            for target, (K, M) in dims.items():
                pre = f"base_model.model.model.layers.{i}.{MODULES[target]}"
                a = torch.randn((MLORA_RANK, K), generator=gen, device="cuda") / math.sqrt(K)
                b = torch.randn((M, MLORA_RANK), generator=gen, device="cuda") * 0.02
                sd[f"{pre}.lora_A.weight"] = a.to(torch.bfloat16).cpu()
                sd[f"{pre}.lora_B.weight"] = b.to(torch.bfloat16).cpu()
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])
        torch.save(sd, os.path.join(dirs[name], "adapter_model.bin"))
        with open(os.path.join(dirs[name], "adapter_config.json"), "w") as f:
            json.dump({"r": MLORA_RANK, "lora_alpha": MLORA_ALPHA}, f)
    return dirs


def mlora_flags(dirs: dict, extra=()):
    """The server's flags with `--lora-adapters a=DIR,b=DIR`, parsed and
    checked as `serve/api.py::main` parses them."""
    from vis_zephyr_tpu_torch.serve import api

    parser = argparse.ArgumentParser()
    api.add_engine_args(parser)
    flags = parser.parse_args(MLORA_SERVER_FLAGS + list(extra) + [
        "--lora-adapters", ",".join(f"{n}={d}" for n, d in dirs.items())])
    api.check_engine_args(parser, flags)
    return flags


class LaunchSum:
    """The paged counters summed over the runs that served with the pack:
    each run resets them just before and reads them just after."""

    def __init__(self):
        self.total: dict = {}

    def __enter__(self):
        reset_paged_counts()
        from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

        qmm.launches = 0
        return self

    def __exit__(self, *exc):
        from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

        torch.cuda.synchronize()
        got = dict(read_paged_counts(), k5=qmm.launches)
        for key, n in got.items():
            self.total[key] = self.total.get(key, 0) + n
        return False


def mlora_batcher(model, cfg, requests, slots: int, **kw):
    """`admitted_batcher` that also keeps each slot's prefill logits (the
    first token's), as `b.first_logits` [slots, V] f32."""
    from vis_zephyr_tpu_torch.serve.batching import ContinuousBatcher

    seen = {}
    activate = ContinuousBatcher._activate

    def recording(self, req, slot, last_logits):
        seen[slot] = last_logits.float().clone()
        return activate(self, req, slot, last_logits)

    ContinuousBatcher._activate = recording
    try:
        b = admitted_batcher(model, cfg, requests, slots, **kw)
    finally:
        ContinuousBatcher._activate = activate
    b.first_logits = torch.stack([seen[s] for s in range(slots)])
    return b


def fed_steps(b, steps: int, feed=None) -> tuple:
    """`steps` decode steps of an admitted batcher (`mlora_batcher`); with
    `feed` (tokens [steps + 1, B]) each step starts from feed[j]. Returns
    (tokens [steps + 1, B]: the admission's first tokens, then each
    step's; logits [steps + 1, B, V]: the ones each token was taken from)."""
    toks, logits = [b.token.clone()], [b.first_logits]
    for j in range(steps):
        if feed is not None:
            b.token.copy_(feed[j])
        if b.step() != b.max_slots:
            raise AssertionError("mlora: a slot finished inside the compared steps")
        toks.append(b.token.clone())
        logits.append(b.last_logits.float().clone())
    return torch.stack(toks), torch.stack(logits)


def solo_runs(model, cfg, requests, mixed_toks, dense: bool, pack=None, names=None,
              attach: bool = True) -> dict:
    """Each request of the fixed batch alone (one slot), fed the mixed batch's
    tokens: under its adapter's leaves attached to the model
    (`train/lora.py::attach_lora`, the single-LoRA path; `attach`) or
    through the pack in a batcher of one slot (the quantized base, which
    attach_lora refuses). Returns {slot: (tokens, logits)}."""
    from vis_zephyr_tpu_torch.ops.mlora import lora_leaves_for_adapter
    from vis_zephyr_tpu_torch.train.lora import attach_lora, split_lora

    out = {}
    kw = dict(kv_quant=True, kv_fused=True) if not dense else {}
    for idx in sorted(set(MLORA_MIX)):
        if attach and idx:
            attach_lora(model, lora_leaves_for_adapter(pack, idx))
        try:
            for slot, aidx in enumerate(MLORA_MIX):
                if aidx != idx:
                    continue
                extra = {} if attach else dict(mlora=pack, adapter_names=names)
                options = None if attach or not idx else [{"adapter": MLORA_NAMES[idx - 1]}]
                b = mlora_batcher(model, cfg, [requests[slot]], 1, dense=dense,
                                  options=options, **kw, **extra)
                out[slot] = fed_steps(b, MLORA_STEPS, mixed_toks[:, slot:slot + 1])
                del b
        finally:
            if attach and idx:
                split_lora(model)
    return out


def hold_solo(label: str, mixed: tuple, solo: dict, card: str) -> None:
    """Every slot's logits' cosine with its solo run's >= 0.999 at every
    step (both fed the same tokens), and its greedy tokens equal the solo
    run's wherever the two runs' logits can decide them: a token may differ
    only where the solo run's margin between its own token and the mixed
    run's is within twice the largest logit difference of the two rows (a
    tie under bf16's rounding: random weights put the top logits of 32000
    closer than a batch of 6 and a batch of 1 round apart)."""
    toks, logits = mixed
    worst, equal, ties, total = 1.0, 0, [], 0
    for slot, (s_toks, s_logits) in solo.items():
        worst = min(worst, float(slot_cosines(s_logits[:, 0], logits[:, slot]).min()))
        for j in range(toks.shape[0]):
            total += 1
            got, want = int(toks[j, slot]), int(s_toks[j, 0])
            if got == want:
                equal += 1
                continue
            row, s_row = logits[j, slot], s_logits[j, 0]
            margin = float(s_row[want] - s_row[got])
            noise = float((row - s_row).abs().max())
            ties.append((slot, j, round(margin, 4), round(noise, 4)))
    decided = all(m <= 2 * n for _, _, m, n in ties)
    print(f"mlora {label}: {len(solo)} slots ({MLORA_MIX}: 0 base, 1 a, 2 b) over "
          f"{MLORA_STEPS} replayed steps against each request alone, fed the same tokens: "
          f"greedy tokens equal {equal} of {total}; the others (slot, step, solo margin, "
          f"largest logit difference) {ties}, all ties: {decided}; logits cosine min "
          f"{worst:.6f} (>= 0.999) [{card}]", flush=True)
    if not (decided and worst >= 0.999):
        raise AssertionError(f"mlora {label}: a slot disagrees with its solo run")


def run_mlora(model, cfg, seed: int, card: str) -> dict:
    """Multi-LoRA serving at full width (the mlora phase): two random r = 128
    adapters written as peft dirs and loaded by `--lora-adapters`; a fixed
    batch of base, a and b slots on the paged batcher (int8 KV-fused pools,
    page 128) and on the dense batcher held against each request alone with
    its adapter attached, base rows bit for bit against the batch served
    with no pack; the prefix cache kept apart per adapter; the server with
    the flag; the 32-slot replayed step with and without the pack. Returns
    the launches of the runs that served with the pack."""
    import shutil
    import tempfile

    import numpy as np

    from vis_zephyr_tpu_torch.ops.mlora import pack_bytes
    from vis_zephyr_tpu_torch.serve import api
    from vis_zephyr_tpu_torch.serve.generate import SamplingConfig
    from vis_zephyr_tpu_torch.serve.paged import PagedBatcher

    root = tempfile.mkdtemp(prefix="vzt_mlora_")
    t0 = time.perf_counter()
    dirs = write_adapter_dirs(cfg, seed, root)
    t_write = time.perf_counter() - t0
    flags = mlora_flags(dirs)
    t0 = time.perf_counter()
    pack, names = api.load_adapters(flags, cfg, "cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    shutil.rmtree(root)  # the pack is on the card; the server below takes it as loaded
    _mlora_state.update(pack=pack, names=names)
    print(f"mlora: two adapters (r={MLORA_RANK}, alpha={MLORA_ALPHA}, 7 targets x "
          f"{cfg.decoder.num_layers} layers) written as peft dirs in {t_write:.1f} s, loaded "
          f"by --lora-adapters in {t_load:.1f} s; the pack on the card: "
          f"{pack_bytes(pack) / 2**30:.3f} GiB (names {names}) [{card}]", flush=True)
    counts = LaunchSum()
    requests = direct_requests(cfg, seed + 5, len(MLORA_MIX))
    options = [{"adapter": None if i == 0 else MLORA_NAMES[i - 1]} for i in MLORA_MIX]
    base_slots = [s for s, i in enumerate(MLORA_MIX) if i == 0]
    for dense in (False, True):
        label = "dense batcher" if dense else "paged batcher (int8 fused pools, page 128)"
        kw = {} if dense else dict(kv_quant=True, kv_fused=True)
        with counts:
            b = mlora_batcher(model, cfg, requests, len(MLORA_MIX), dense=dense,
                              options=options, mlora=pack, adapter_names=names, **kw)
            mixed = fed_steps(b, MLORA_STEPS)
            captures = b.graphs.captures
            # Another mix in the same buffer: the step replays, no new capture.
            b.slot_adapter.copy_(b.slot_adapter.flip(0))
            fed_steps(b, 2)
            same_graph = b.graphs.captures == captures
        bare = mlora_batcher(model, cfg, requests, len(MLORA_MIX), dense=dense, **kw)
        bare_run = fed_steps(bare, MLORA_STEPS, mixed[0])
        exact = (torch.equal(bare_run[1][:, base_slots], mixed[1][:, base_slots])
                 and torch.equal(bare_run[0][:, base_slots], mixed[0][:, base_slots]))
        del b, bare
        print(f"mlora {label}: captures {captures} over {MLORA_STEPS} steps, none more after the "
              f"adapter mix changed: {same_graph}; base slots {base_slots} bit for bit the "
              f"batch served with no pack: {exact}", flush=True)
        if not (same_graph and captures >= 1 and exact):
            raise AssertionError(f"mlora {label}: the mix changed the graph, or a base row "
                                 "moved under the pack")
        hold_solo(label, mixed, solo_runs(model, cfg, requests, mixed[0], dense, pack), card)

    # Verify steps under the pack (`--lookahead 4`) on both batchers: each a
    # replay of one capture, none more after the mix changes.
    for dense in (False, True):
        label = "dense" if dense else "paged"
        kw = {} if dense else dict(kv_quant=True, kv_fused=True)
        with counts:
            b = mlora_batcher(model, cfg, requests, len(MLORA_MIX), dense=dense,
                              options=options, mlora=pack, adapter_names=names,
                              lookahead=SPEC_LOOKAHEAD, **kw)
            for _ in range(3):
                b.step()
            captures = b.graphs.captures
            b.slot_adapter.copy_(b.slot_adapter.flip(0))
            b.step()
        replayed = (b.verify_steps == 4 and captures >= 1 and b.graphs.captures == captures
                    and bool(torch.isfinite(b.last_logits).all()))
        print(f"mlora {label} verify steps (S={SPEC_LOOKAHEAD + 1}, 6 slots, the pack): "
              f"{b.verify_steps} steps, captures {captures}, none more after the mix changed: "
              f"{b.graphs.captures == captures}; accepted {b.accepted} of {b.proposed} "
              f"proposals", flush=True)
        del b
        if not replayed:
            raise AssertionError(f"mlora {label}: the verify steps under the pack did not replay")

    # The prefix cache: one 700-word prompt under a, b, then a again (bf16
    # fused pools, where a warm admission gives the cold one's tokens).
    tok = WordTokenizer(cfg.decoder.vocab_size)
    ids = np.asarray(tok(make_question(np.random.default_rng(seed + 6), MLORA_PREFIX_WORDS))
                     .input_ids, np.int64)
    b = PagedBatcher(model, cfg, max_slots=2, cache_len=2048, prefill_chunk=256, kv_fused=True,
                     prefix_cache=True, mlora=pack, adapter_names=names,
                     sampling=SamplingConfig(max_new_tokens=8, eos_token_id=-1))
    streams, reused = [], []
    with counts:
        for name in ("a", "b", "a"):
            h = b.submit(ids, adapter=name)
            b.run_until_drained()
            streams.append(ended_streams([h])[0])
            reused.append(b.prefix_cache.pages_reused)
    apart = (reused[:2] == [0, 0] and reused[2] > 0 and b.prefix_cache.hits == 1
             and streams[2] == streams[0] and streams[1] != streams[0])
    print(f"mlora prefix cache: {len(ids)} tokens under a, b, a: pages reused after each "
          f"{reused}, hits {b.prefix_cache.hits}; a's repeat gives a's tokens: "
          f"{streams[2] == streams[0]}; b's differ: {streams[1] != streams[0]}", flush=True)
    del b
    if not apart:
        raise AssertionError("mlora: the prefix cache shared pages across adapters, or a's "
                             "repeat did not hit")

    # The server with --lora-adapters (its pack is the one loaded above).
    engine = api.engine_from_args(model, cfg, tok, flags, adapters=(pack, names))
    server, thread = start_server(engine)
    port = server.server_address[1]
    checks, texts = {}, {}
    prompt = {"prompt": make_question(np.random.default_rng(seed + 7), 60), "max_tokens": 12}
    try:
        with counts:
            status, body = post_json(port, "GET", "/v1/models")
            checks["models"] = (status == 200 and [m["id"] for m in json.loads(body)["data"]]
                                == ["vis-zephyr-tpu", "a", "b"])
            for model_id in ("a", "b", "base"):
                status, body = post_json(port, "POST", "/v1/completions",
                                         dict(prompt, model=model_id))
                out = json.loads(body)
                checks[f"model {model_id}"] = (status == 200
                                               and out["usage"]["completion_tokens"] == 12)
                texts[model_id] = out["choices"][0]["text"]
            checks["adapters differ"] = len(set(texts.values())) == 3
            status, body = post_json(port, "POST", "/v1/completions", dict(prompt, model="zzz"))
            checks["unknown model 400"] = status == 400 and "unknown model" in body
            px, valid = session_pixels(np.random.default_rng(seed + 8), cfg.vision.image_size, 1)
            engine.attach_pixels("m", px, valid, (cfg.vision.image_size,) * 2)
            status, text, _, _ = post_chat(port, {"session_id": "m", "adapter": "b",
                                                  "question": "what is in the picture"})
            checks["/chat adapter"] = status == 200 and len(text.split()) > 0
            status, text, _, _ = post_chat(port, {"session_id": "m", "adapter": "zzz",
                                                  "question": "and now"})
            checks["/chat unknown 400"] = status == 400 and "unknown adapter" in text
    finally:
        stop_server(server, thread)
        engine.close()
    print(f"mlora server ({' '.join(MLORA_SERVER_FLAGS)} --lora-adapters a=...,b=...): "
          f"{checks} [{card}]", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"mlora server: {checks}")

    # The 32-slot replayed step with the pack (base, a, b in turn) and without.
    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step

    reqs = direct_requests(cfg, seed, 32)
    rows = {}
    for with_pack in (True, False):
        extra = dict(mlora=pack, adapter_names=names,
                     options=[{"adapter": (None, "a", "b")[i % 3]} for i in range(32)]) \
            if with_pack else {}
        b = admitted_batcher(model, cfg, reqs, 32, kv_quant=True, kv_fused=True, **extra)
        rows[with_pack] = got = profile_step(b.step)
        if int(b.active.sum()) != 32:
            raise AssertionError("mlora: a slot finished inside the timed steps")
        print(f"mlora step: the replayed 32-slot decode step (int8 fused pools, lengths about "
              f"{int(b.slot_len.mean())}) {'with the pack (base, a, b mixed)' if with_pack else 'without a pack'}: "
              f"wall {got['wall_ms']:.2f} ms (min {got['wall_min_ms']:.2f}), device busy "
              f"{got['device_ms']:.2f} ms, idle share {got['idle_share']:.2f}, "
              f"{got['launches']:.1f} kernel launches a step [{card}]", flush=True)
        del b
    print(f"mlora step: the pack adds {rows[True]['device_ms'] - rows[False]['device_ms']:.2f} ms "
          f"of device time a step ({pack_bytes(pack) / 2**30:.3f} GiB of panels, read once a "
          f"step at best: {pack_bytes(pack) / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM peak) "
          f"[{card}]", flush=True)
    torch.cuda.empty_cache()
    print(f"mlora: launches with the pack {counts.total}", flush=True)
    if min(counts.total[k] for k in ("k1", "k2", "k3", "k4", "kvu")) <= 0:
        raise AssertionError(f"mlora: a kernel of the path was not launched: {counts.total}")
    return counts.total


def run_mlora_int8(model, cfg, seed: int, card: str) -> dict:
    """The mlora phase's fixed batch on `--load-8bit` weights (K5 under every
    projection, the pack's deltas added to its output): each slot against
    the same request alone in a one-slot batcher under the same adapter
    (attach_lora refuses a quantized base). Returns the launches."""
    state = _mlora_state
    pack, names = state["pack"], state["names"]  # built for the bf16 model; any base takes it
    requests = direct_requests(cfg, seed + 5, len(MLORA_MIX))
    options = [{"adapter": None if i == 0 else MLORA_NAMES[i - 1]} for i in MLORA_MIX]
    counts = LaunchSum()
    with counts:
        b = mlora_batcher(model, cfg, requests, len(MLORA_MIX), options=options, mlora=pack,
                          adapter_names=names, kv_quant=True, kv_fused=True)
        mixed = fed_steps(b, MLORA_STEPS)
        del b
        solo = solo_runs(model, cfg, requests, mixed[0], False, pack, names, attach=False)
    hold_solo("int8 weights, paged batcher", mixed, solo, card)
    print(f"mlora int8: launches {counts.total}", flush=True)
    if counts.total["k5"] <= 0 or counts.total["k3"] <= 0:
        raise AssertionError(f"mlora int8: K5 or K3 not launched: {counts.total}")
    state.clear()
    return counts.total


GRAMMAR_REGEX = "[0-9]{3}-[a-z]{4}"
# The integer field is held to an enum of integers: under greedy decoding
# random weights repeat a digit to the budget inside an unbounded integer
# (the integer's own regex is held on the CPU, tests/test_torch_structured.py).
GRAMMAR_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "pattern": "[a-z]{3,8}"},
    "age": {"type": "integer", "enum": [18, 30, 45, 60]},
    "color": {"enum": ["red", "green", "blue"]}}}
GRAMMAR_TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather", "description": "Weather for a city",
        "parameters": {"type": "object", "properties": {"city": {"enum": ["Paris", "Tokyo"]}}}}},
    {"type": "function", "function": {"name": "noop", "parameters": {}}},
]
GRAMMAR_BURST = 16   # the paged server's burst: 4 regex, 4 schema, 8 unconstrained
GRAMMAR_TOKENS = 64  # each request's budget
GRAMMAR_STEPS = 10   # timed steps of each form


class MaskedLaunches:
    """The paged counters' changes over the calls of a wrapped device step
    that ran with a grammar mask (`mask_of(args, kwargs)` not None), and how
    many such calls there were."""

    def __init__(self):
        self.total = {}
        self.calls = 0

    def wrap(self, fn, mask_of):
        def wrapped(*args, **kw):
            if mask_of(args, kw) is None:
                return fn(*args, **kw)
            before = read_paged_counts()
            out = fn(*args, **kw)
            self.calls += 1
            for key, n in read_paged_counts().items():
                self.total[key] = self.total.get(key, 0) + n - before[key]
            return out
        return wrapped


def record_keys(graphs) -> list:
    """The keys of every step `graphs` (a `StepGraphs`) runs from now on
    (`run` wrapped on the instance); a grammar step's key holds "grammar"."""
    keys = []
    run = graphs.run

    def recording(key, *args, **kw):
        keys.append(key)
        return run(key, *args, **kw)

    graphs.run = recording
    return keys


def grammar_text(strings, tokens) -> bytes:
    return b"".join(strings[t] for t in tokens)


def record_tokens(batcher) -> list:
    """[{prompt ids: emitted tokens}]: the batcher's `_emit` (wrapped on the
    instance) files each emitted token in the last dict of the list; append
    a dict to start a new record."""
    record = [{}]
    emit = batcher._emit

    def recording(req, tok):
        record[-1].setdefault(tuple(int(t) for t in req.input_ids), []).append(tok)
        return emit(req, tok)

    batcher._emit = recording
    return record


def check_constrained(label: str, grammar, strings, tokens, text: str, schema: bool) -> None:
    if not grammar.dfa.matches(grammar_text(strings, tokens)):
        raise AssertionError(f"grammar {label}: {text!r} does not match its grammar")
    if schema:
        doc = json.loads(text)
        if set(doc) != set(GRAMMAR_SCHEMA["properties"]) or doc["color"] not in (
                "red", "green", "blue") or not isinstance(doc["age"], int):
            raise AssertionError(f"grammar {label}: {doc} lacks the schema's fields")


def run_grammar(model, cfg, seed: int, card: str) -> dict:
    """Structured output at full width: the token strings of the Zephyr-form
    `tokenizer.json` (32000 pieces, written by the script) read through the
    port's `NativeTokenizer`, each grammar compiled over them (timed); the
    paged server (`--kv-quant`, 32 slots) under a burst of 16 /v1/completions
    requests, 4 under a regex, 4 under a JSON schema (a patterned string, an
    integer of an enum, an enum) and 8 free, then the same 16 with no grammar (the free
    requests' tokens equal in both runs); the dense batcher and the
    serialized path with 2 constrained and 2 free requests each (the free
    ones equal a run of their own); every constrained reply matches its
    grammar (the schema's parses with its fields); the masked steps are
    replays of one capture on each path and launch K3 and K4 (paged) or K2
    (dense, serialized), K1 at admission; a json_schema chat completion and
    a forced tool call (`tools`, `tool_choice` "required") on the server;
    the 16-slot step's wall time masked against unmasked and the mask
    gather's device time. Returns the launches."""
    import tempfile

    import numpy as np

    from vis_zephyr_tpu_torch.data.tokenization import tokenize_with_images
    from vis_zephyr_tpu_torch.data.tokenizer_native import NativeTokenizer
    from vis_zephyr_tpu_torch.serve import api, generate
    from vis_zephyr_tpu_torch.serve.structured import token_strings_from_tokenizer

    with tempfile.TemporaryDirectory() as root:
        write_zephyr_tokenizer(os.path.join(root, "tokenizer.json"), cfg.decoder.vocab_size)
        tok = NativeTokenizer(root)
    t0 = time.perf_counter()
    strings = token_strings_from_tokenizer(tok, cfg.decoder.vocab_size)
    strings_s = time.perf_counter() - t0

    def engine_for(flags):
        parser = argparse.ArgumentParser()
        api.add_engine_args(parser)
        return api.engine_from_args(model, cfg, tok, parser.parse_args(
            flags + ["--max-new-tokens", str(GRAMMAR_TOKENS)]))

    paged = engine_for(PAGED_FLAGS)
    paged._token_strings = strings
    compile_s = {}
    for name, kw in (("regex", dict(pattern=GRAMMAR_REGEX)),
                     ("schema", dict(json_schema=GRAMMAR_SCHEMA))):
        t0 = time.perf_counter()
        grammar = paged.compile_grammar(**kw)
        compile_s[name] = (time.perf_counter() - t0, grammar.n_states)
    regex_g = paged.compile_grammar(GRAMMAR_REGEX)
    schema_g = paged.compile_grammar(json_schema=GRAMMAR_SCHEMA)
    print(f"grammar: token strings of {len(strings)} ids in {strings_s * 1e3:.1f} ms; compiled "
          + ", ".join(f"{name} ({n} DFA states) in {sec * 1e3:.1f} ms"
                      for name, (sec, n) in compile_s.items())
          + f" (host) [{card}]", flush=True)

    rng = np.random.default_rng(seed + 21)
    questions = [make_question(rng, (20, 60, 120)[i % 3]) for i in range(GRAMMAR_BURST)]
    kinds = ["regex" if i % 4 == 0 else "schema" if i % 4 == 1 else None
             for i in range(GRAMMAR_BURST)]
    formats = {"regex": {"type": "regex", "regex": GRAMMAR_REGEX},
               "schema": {"type": "json_schema", "json_schema": {"schema": GRAMMAR_SCHEMA}}}
    grammars = {"regex": regex_g, "schema": schema_g}
    launches = {}

    def add(counts):
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n

    checks = {}
    # The paged server: the burst with grammars, then the same 16 without.
    b = paged.batcher
    masked = MaskedLaunches()
    b._burst_device = masked.wrap(b._burst_device, lambda a, kw: kw.get("grammar",
                                                                       a[4] if len(a) > 4 else None))
    keys = record_keys(b.graphs)
    record = record_tokens(b)
    ids = [tuple(int(t) for t in tokenize_with_images(q, tok)) for q in questions]
    server, thread = start_server(paged)
    port = server.server_address[1]
    walls = {}
    try:
        for constrained in (True, False):
            record.append({})
            payloads = [dict({"prompt": q, "max_tokens": GRAMMAR_TOKENS},
                             **({"response_format": formats[k]} if constrained and k else {}))
                        for q, k in zip(questions, kinds)]
            reset_paged_counts()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(payloads)) as pool:
                replies = list(pool.map(lambda p: post_json(port, "POST", "/v1/completions", p),
                                        payloads))
            walls[constrained] = time.perf_counter() - t0
            torch.cuda.synchronize()
            add(read_paged_counts())
            if any(status != 200 for status, _ in replies):
                raise AssertionError(f"grammar: a burst request failed: {replies}")
            texts = [json.loads(body)["choices"][0]["text"] for _, body in replies]
            tokens = [record[-1].get(i, []) for i in ids]
            if constrained:
                for i, kind in enumerate(kinds):
                    if kind:
                        check_constrained(f"paged {kind}", grammars[kind], strings, tokens[i],
                                          texts[i], kind == "schema")
                served = tokens
        free = [i for i, k in enumerate(kinds) if k is None]
        checks["paged_free_equal"] = all(served[i] == tokens[i] and tokens[i] for i in free)
        grammar_keys = [k for k in keys if "grammar" in k]
        checks["paged_replays"] = (len(grammar_keys) > 1 and len(set(grammar_keys)) == 1
                                   and masked.calls == len(grammar_keys))
        paged_masked = dict(masked.total, steps=masked.calls)  # the burst's masked steps
        checks["paged_masked_k3_k4"] = paged_masked.get("k3", 0) > 0 and paged_masked.get(
            "k4", 0) > 0
        # The OpenAI surfaces on the same server.
        chat = {"messages": [{"role": "user", "content": questions[0]}], "max_tokens": 96}
        status, body = post_json(port, "POST", "/v1/chat/completions",
                                 dict(chat, response_format=formats["schema"]))
        doc = json.loads(json.loads(body)["choices"][0]["message"]["content"])
        checks["openai_json_schema"] = status == 200 and set(doc) == set(
            GRAMMAR_SCHEMA["properties"])
        status, body = post_json(port, "POST", "/v1/chat/completions",
                                 dict(chat, tools=GRAMMAR_TOOLS, tool_choice="required"))
        choice = json.loads(body)["choices"][0]
        calls = choice["message"].get("tool_calls") or []
        checks["openai_tool_call"] = (status == 200 and choice["finish_reason"] == "tool_calls"
                                      and len(calls) == 1 and calls[0]["function"]["name"] in (
                                          "get_weather", "noop"))
        tool_call = calls[0]["function"] if calls else None
    finally:
        stop_server(server, thread)
        paged.close()  # the pump stops: this thread steps the batcher from here on
    # The masked and the unmasked 16-slot step, timed on the idle batcher.
    step_ms = {}
    handles = [b.submit(np.asarray(i, np.int64), max_new_tokens=1024) for i in ids]
    while b._has_admission_work():  # the server's chunked admission, a chunk a step
        b.step()
    if int(b.active.sum()) != GRAMMAR_BURST:
        raise AssertionError(f"grammar: {int(b.active.sum())} of the timed batch's "
                             f"{GRAMMAR_BURST} requests admitted")
    for form in ("unmasked", "masked"):
        if form == "masked":
            for slot in np.flatnonzero(b.active):
                b.grammar_slots.attach(int(slot), schema_g)
        b.step()  # the form's capture
        times = []
        for _ in range(GRAMMAR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.step()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms[form] = (statistics.median(times), int(b.active.sum()))
    gather = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    gather_ms = []
    for _ in range(20):
        gather[0].record()
        b.grammar_slots.gather()
        gather[1].record()
        torch.cuda.synchronize()
        gather_ms.append(gather[0].elapsed_time(gather[1]))
    for h in handles:
        b.cancel(h)
    while b.has_work:
        b.step()
    print(f"grammar paged: burst of {GRAMMAR_BURST} (4 regex, 4 schema, 8 free) "
          f"{walls[True]:.2f} s, the same without grammars {walls[False]:.2f} s; its masked "
          f"steps {paged_masked.pop('steps')}, one capture ({len(set(grammar_keys))} key), "
          f"their launches {paged_masked}; json_schema reply {doc}; tool call {tool_call}; step at "
          f"{step_ms['unmasked'][1]} active slots of 32: unmasked "
          f"{step_ms['unmasked'][0]:.3f} ms, masked {step_ms['masked'][0]:.3f} ms "
          f"({step_ms['masked'][1]} active; wall, median of {GRAMMAR_STEPS}), the mask gather "
          f"{statistics.median(gather_ms):.4f} ms on the device [{card}]", flush=True)

    # The dense batcher and the serialized path: 2 constrained, 2 free each.
    picks = [0, 1, 2, 3]  # regex, schema, free, free
    # Whole admission on the dense batcher: a text prompt is padded to K1's
    # tile there (chunked admission attends its scratch cache in plain
    # attention).
    for label, flags in (("dense", DENSE_FLAGS + ["--prefill-chunk", "0"]),
                         ("serialized", [])):
        engine = engine_for(flags)
        masked = MaskedLaunches()
        if engine.batcher is not None:
            engine.batcher._burst_device = masked.wrap(
                engine.batcher._burst_device,
                lambda a, kw: kw.get("grammar", a[4] if len(a) > 4 else None))
            step_fn, graphs = None, engine.batcher.graphs
        else:
            step_fn = generate.decode_multi_step
            generate.decode_multi_step = masked.wrap(step_fn, lambda a, kw: kw.get("mask"))
            # The model's fixed B = 1 cache (2048 slots, larger than any
            # request here needs), whose graphs the serialized steps replay.
            graphs = generate.burst_cache(model, cfg, 1, 2048, torch.zeros(
                1, dtype=torch.long, device=engine.device))[1]
        keys = [] if graphs is None else record_keys(graphs)  # no graphs on the CPU
        try:
            reset_paged_counts()
            streams = [engine.generate_request(questions[i], max_new_tokens=GRAMMAR_TOKENS,
                                               grammar=grammars[kinds[i]] if kinds[i] else None)
                       for i in picks]
            got = [list(s) for s in streams]
            alone = [list(engine.generate_request(questions[i], max_new_tokens=GRAMMAR_TOKENS))
                     for i in picks[2:]]
            torch.cuda.synchronize()
            add(read_paged_counts())
        finally:
            if step_fn is not None:
                generate.decode_multi_step = step_fn
            if graphs is not None:
                graphs.__dict__.pop("run")  # the class's `run` again
            engine.close()
        for i, tokens in zip(picks[:2], got[:2]):
            check_constrained(f"{label} {kinds[i]}", grammars[kinds[i]], strings, tokens,
                              tok.decode(tokens), kinds[i] == "schema")
        checks[f"{label}_free_equal"] = got[2:] == alone and all(alone)
        checks[f"{label}_masked_k2"] = masked.calls > 0 and masked.total.get("k2", 0) > 0
        grammar_keys = [k for k in keys if "grammar" in k]
        checks[f"{label}_replays"] = (len(grammar_keys) == masked.calls > 1
                                      and len(set(grammar_keys)) == 1)
        print(f"grammar {label}: masked steps {masked.calls} (one capture: "
              f"{len(set(grammar_keys))} key), their launches {masked.total}; replies "
              f"{[tok.decode(t) for t in got[:2]]} [{card}]", flush=True)
    print(f"grammar: checks {checks}; launches {launches} [{card}]", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"grammar: {checks}")
    if min(launches.get(k, 0) for k in ("k1", "k2", "k3", "k4")) <= 0:
        raise AssertionError(f"grammar: a kernel of the path was not launched: {launches}")
    return launches


EVAL_ITEMS = 8      # the VCR items of the greedy batch
EVAL_BATCH = 8      # its batch size (the harness's default --batch-size)
EVAL_TOKENS = 16    # each answer's budget (the harness's default --max-new-tokens)
EVAL_BEAMS = 4      # --num-beams of the beam-search items
EVAL_BEAM_ITEMS = 2
EVAL_LAST_BATCH = 6  # a batch size that leaves a smaller last batch (6, then 2)


def vcr_eval_items(cfg, seed: int, tokenizer) -> list:
    """EVAL_ITEMS prepared VCR items without PIL: each a raw VCR record (4
    detector boxes with polygon masks, a question and 4 answer choices whose
    entity tags name the boxes), its prompt from the port's `vcr_qa_eval`
    (constant point style, seeded) in the `zephyr_vcr` template, and seeded
    pixels with 1 to 4 valid crops (`session_pixels`). The masks' polygons
    are read as `visual_prompt_process` reads them, and each must lie in its
    box; the overlay itself (PIL) is held on the CPU by the tests."""
    import random

    import numpy as np

    from vis_zephyr_tpu_torch.data.vip.geometry import PolygonSet
    from vis_zephyr_tpu_torch.data.vip.processor import _extract_segmentations, vcr_qa_eval
    from vis_zephyr_tpu_torch.eval.eval_vqa import prompt_item

    rng = np.random.default_rng(seed + 23)
    words = WORDS
    items = []
    for i in range(EVAL_ITEMS):
        boxes, segms = [], []
        for _ in range(4):
            x0, y0 = rng.uniform(0, 400, 2)
            x1, y1 = x0 + rng.uniform(30, 200), y0 + rng.uniform(30, 200)
            boxes.append([float(x0), float(y0), float(x1), float(y1), float(rng.uniform())])
            cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
            segms.append([[[float(x0), float(cy)], [float(cx), float(y0)], [float(x1), float(cy)],
                           [float(cx), float(y1)]]])
        meta = {"boxes": boxes, "segms": segms}

        def corpus(k):
            picks = [str(w) for w in rng.choice(words, k)]
            picks.insert(int(rng.integers(0, k)), sorted({int(e) for e in rng.choice(4, 2)}))
            return picks + ["?"]

        record = {"id": f"vcr-val-{i}", "question": corpus(8),
                  "answer_choices": [corpus(10) for _ in range(4)],
                  "answer_label": int(rng.integers(0, 4)),
                  "class_names": ["person", "person", "dog", "car"]}
        assignments, entities, convs = vcr_qa_eval(record, random.Random(seed + i))
        for entity in entities:
            x0, y0, x1, y1 = PolygonSet.from_flat(_extract_segmentations(meta, entity)).bounds
            bx = meta["boxes"][entity]
            if not (bx[0] <= x0 and bx[1] <= y0 and x1 <= bx[2] and y1 <= bx[3]):
                raise AssertionError(f"eval: the mask of entity {entity} leaves its box")
        px, valid = session_pixels(rng, cfg.vision.image_size, 1 + i % 4)
        items.append(prompt_item(convs[0]["value"], px, valid, tokenizer, gold=convs[1]["value"],
                                 question_id=record["id"]))
    return items


def run_eval(model, cfg, seed: int, card: str) -> dict:
    """The evaluation entry point (`eval/eval_vqa.py`) after preparation, at
    full width: EVAL_ITEMS VCR items (`vcr_eval_items`) through
    `score_items` greedily at batch EVAL_BATCH, then EVAL_BEAM_ITEMS of them
    with `--num-beams` EVAL_BEAMS, EVAL_TOKENS tokens each, counted: K1 32
    a prefill (one batched, one per beam search), K2 32 a decode step,
    exactly. Then the gates: each row of the batched prefill against its item
    alone at B = 1 and the batch against `plain_versions()` (first logits'
    cosine >= 0.999); the replayed beam search against the eager one
    (`decode_step` with the kernels) on a cache of the same slots, the same
    hypotheses and scores bit for bit; `num_beams` 1 equal to greedy
    `generate`; the best hypothesis's score against a teacher-forced forward
    (the prompt's prefill, then the hypothesis in one verify pass).
    Readings: the greedy batch's items/s (its first
    run with the captures, then a second), a beam step's wall replayed and
    eager, the reorder's time, the captures, and what a smaller last batch
    costs (batch EVAL_LAST_BATCH: batches of 6 and 2)."""
    import importlib.util
    import io

    import numpy as np

    from vis_zephyr_tpu_torch.eval.eval_vqa import collate, score_items
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve import generate as gen

    L = cfg.decoder.num_layers
    eos = cfg.decoder.eos_token_id
    tokenizer = WordTokenizer(cfg.decoder.vocab_size)
    items = vcr_eval_items(cfg, seed, tokenizer)
    sampling = gen.SamplingConfig(max_new_tokens=EVAL_TOKENS, eos_token_id=eos)
    beam_items = items[:EVAL_BEAM_ITEMS]

    def key(batch: int):
        return batch, torch.device("cuda", torch.cuda.current_device())

    def has_graphs(batch: int) -> bool:
        return key(batch) in gen._bursts.get(model, {})

    def graphs_of(batch: int):
        return gen._bursts[model][key(batch)][1]

    # The harness's two decode routes, counted from 0.
    fa.launches = kv_cache.launches = 0
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = score_items(model, cfg, tokenizer, items, sampling, EVAL_BATCH, out)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    greedy_counts = (fa.launches, kv_cache.launches)
    t0 = time.perf_counter()
    beams = score_items(model, cfg, tokenizer, beam_items, sampling, EVAL_BATCH, out,
                        num_beams=EVAL_BEAMS)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    counts = dict(k1=fa.launches, k2=kv_cache.launches)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    steps = EVAL_TOKENS - 1  # no EOS: lm_head's EOS row is zero, below every beam's pool
    want = dict(k1=L * (1 + EVAL_BEAM_ITEMS), k2=L * steps * (1 + EVAL_BEAM_ITEMS))
    print(f"eval: {EVAL_ITEMS} VCR items greedy at batch {EVAL_BATCH} ({first_s:.2f} s with its "
          f"capture: {EVAL_ITEMS / first_s:.2f} items/s), {EVAL_BEAM_ITEMS} with --num-beams "
          f"{EVAL_BEAMS} ({beam_s:.2f} s with the capture), {EVAL_TOKENS} tokens each; "
          f"(correct, total) {greedy} and {beams}; K1 {counts['k1']} (want {want['k1']}: 32 a "
          f"prefill), K2 {counts['k2']} (want {want['k2']}: 32 a decode step); greedy alone "
          f"K1 {greedy_counts[0]}, K2 {greedy_counts[1]} [{card}]")
    if counts != want or greedy_counts != (L, L * steps):
        raise AssertionError(f"eval: launch counts {counts} (greedy {greedy_counts}), want {want}")
    if len(lines) != EVAL_ITEMS + EVAL_BEAM_ITEMS or any(
            line["extracted_answer"] not in "ABCD" or line["gold_answer"] not in "ABCD"
            or len(line["text"].split()) != EVAL_TOKENS for line in lines):
        raise AssertionError(f"eval: the answers JSONL is not whole: {lines[:2]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score_items(model, cfg, tokenizer, items, sampling, EVAL_BATCH, io.StringIO())
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    print(f"eval: the greedy batch again (replays only): {again_s:.3f} s, "
          f"{EVAL_ITEMS / again_s:.2f} items/s [{card}]")

    # Each row of the batched prefill against its item alone, and the batch
    # on the kernel path against the plain versions: the first logits.
    def first_logits(batch):
        ids, valid, px, pv = (torch.from_numpy(a).cuda() for a in collate(batch, cfg))
        cache_len = gen._cache_len(ids.shape[1], px, cfg, EVAL_TOKENS)
        return gen.prefill(model, ids, px, pv, cfg, cache_len, text_valid=valid)[0]

    batched = first_logits(items)
    alone = torch.cat([first_logits([it]) for it in items])
    with _kernels.plain_versions():
        plain = first_logits(items)
    rows = [cosine(batched[b], alone[b]) for b in range(EVAL_ITEMS)]
    vs_plain = [cosine(batched[b], plain[b]) for b in range(EVAL_ITEMS)]
    print(f"eval: first logits of the batch of {EVAL_ITEMS} (right-padded, text_valid) against "
          f"each item alone, cosine min {min(rows):.6f}, against the plain versions min "
          f"{min(vs_plain):.6f} (>= 0.999 each); first tokens equal alone "
          f"{int((batched.argmax(-1) == alone.argmax(-1)).sum())} of {EVAL_ITEMS}")
    if not (bool(torch.isfinite(batched).all()) and min(rows) >= 0.999
            and min(vs_plain) >= 0.999):
        raise AssertionError(f"eval: batched prefill disagrees: alone {rows}, plain {vs_plain}")

    # Beam search replayed against eager, on a cache of the same slots.
    def one(it):
        return (torch.as_tensor(it["input_ids"][None]).cuda(),
                torch.as_tensor(it["images"][None]).cuda(),
                torch.as_tensor(it["patch_valid"][None]).cuda())

    replayed_stats, eager_stats = {}, {}
    for it in beam_items:
        args = (model, *one(it), cfg, EVAL_BEAMS, EVAL_TOKENS, eos)
        got = gen.beam_hypotheses(*args, stats=replayed_stats)
        slots = gen._bursts[model][key(EVAL_BEAMS)][0]["k"].shape[2]
        want_pool = gen.beam_hypotheses(*args, cache_len=slots, eager=True, stats=eager_stats)
        same = got == want_pool
        print(f"eval: beam search ({EVAL_BEAMS} beams, {EVAL_TOKENS} tokens) of {it['question_id']}"
              f": replayed over the fixed cache of {slots} slots against eager steps on a "
              f"gathered cache of as many: {len(got)} hypotheses, scores and tokens bit-equal "
              f"{same}; best {got[0][0]:.6f}")
        if not same:
            raise AssertionError(f"eval: replayed beams {got[:2]} differ from eager {want_pool[:2]}")
    ids, px, pv = one(beam_items[0])
    best_score, best = gen.beam_hypotheses(model, ids, px, pv, cfg, EVAL_BEAMS, EVAL_TOKENS,
                                           eos)[0]
    # The best hypothesis's score teacher-forced: the prompt's prefill, then
    # the hypothesis in one cached forward (a verify pass of its tokens; the
    # Q-Former reads the prompt's text, so the prompt is prefilled alone).
    cache_len = gen._cache_len(ids.shape[1], px, cfg, EVAL_TOKENS)
    last, cache, _ = gen.prefill(model, ids, px, pv, cfg, cache_len)
    hyp = torch.tensor([best], device="cuda")
    rest = gen.decode_verify(model, cache, hyp[:, :-1],
                             torch.ones_like(hyp[:, :-1], dtype=torch.bool), cfg)[0]
    logits = torch.cat([last[:, None], rest], dim=1)
    lsm = torch.log_softmax(logits[0].float(), dim=-1)
    chosen = lsm[torch.arange(len(best)), hyp[0]]
    forced = float(chosen.sum()) / len(best)
    tol = max(0.02 * abs(best_score), 0.02)
    print(f"eval: the best hypothesis's score {best_score:.6f} against a teacher-forced forward "
          f"of prompt + hypothesis {forced:.6f} (|diff| {abs(forced - best_score):.6f} <= "
          f"{tol:.6f}: 2 % of the score, the bf16 rounding between {len(best) - 1} decode steps "
          f"at B = {EVAL_BEAMS} and one pass over the {len(best) - 1} rows)")
    if not abs(forced - best_score) <= tol:
        raise AssertionError(f"eval: beam score {best_score} against teacher-forced {forced}")
    greedy_toks = [int(t) for t in gen.generate(model, ids, px, pv, cfg, sampling)[0]]
    one_beam = gen.beam_search(model, ids, px, pv, cfg, num_beams=1, max_new_tokens=EVAL_TOKENS,
                               eos_token_id=eos)
    print(f"eval: num_beams 1 against greedy generate: equal {one_beam == greedy_toks}")
    if one_beam != greedy_toks:
        raise AssertionError(f"eval: one beam {one_beam} is not greedy {greedy_toks}")

    # Readings: a beam step's wall, the reorder's time, the captures.
    cache = gen._bursts[model][key(EVAL_BEAMS)][0]
    rows_now = int(cache["length"][0])
    parents = [1, 0, 3, 2]  # every beam moved
    reorder_ms = median_ms(lambda: gen._beam_reorder(cache, parents, rows=rows_now))
    moved = 2 * L * EVAL_BEAMS * rows_now * cfg.decoder.num_kv_heads * cfg.decoder.head_dim * 2
    replayed_ms, eager_ms = (statistics.median(st["step_s"]) * 1e3
                             for st in (replayed_stats, eager_stats))
    print(f"eval: a beam step (decode at B = {EVAL_BEAMS}, the top-{2 * EVAL_BEAMS} to the host, "
          f"the ranking, the reorder): replayed median {replayed_ms:.2f} ms (of "
          f"{len(replayed_stats['step_s'])}), eager {eager_ms:.2f} ms; the reorder of "
          f"{EVAL_BEAMS} moved rows of {rows_now} slots {reorder_ms:.4f} ms (CUDA events around "
          f"the call, its index copies included; bound {bound_ms(2 * moved, 0)[0]:.4f} ms: "
          f"{moved / 2**20:.1f} MiB gathered and written) [{card}]")
    for batch in (EVAL_BATCH, EVAL_BEAMS, 1):
        g = graphs_of(batch)
        print(f"eval: B = {batch} captures {g.captures} in {g.capture_seconds:.2f} s of host time, "
              f"graph pools {g.pool_bytes() / 2**20:.1f} MiB")
    last_batches = (EVAL_LAST_BATCH, EVAL_ITEMS % EVAL_LAST_BATCH)
    before = {b: ((graphs_of(b).captures, graphs_of(b).capture_seconds) if has_graphs(b)
                  else (0, 0.0)) for b in last_batches}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score_items(model, cfg, tokenizer, items, sampling, EVAL_LAST_BATCH, io.StringIO())
    torch.cuda.synchronize()
    last_s = time.perf_counter() - t0
    added = [(b, graphs_of(b).captures - before[b][0], graphs_of(b).capture_seconds - before[b][1])
             for b in last_batches]
    print(f"eval: PIL importable on this host: {importlib.util.find_spec('PIL') is not None} "
          f"(the items were built without it)")
    print(f"eval: the {EVAL_ITEMS} items at batch {EVAL_LAST_BATCH} (batches of {EVAL_LAST_BATCH} "
          f"and {EVAL_ITEMS % EVAL_LAST_BATCH}): {last_s:.3f} s with their burst caches and "
          f"captures ({', '.join(f'B = {b}: {c} capture, {s:.2f} s' for b, c, s in added)}), "
          f"against {again_s:.3f} s for one replayed batch of {EVAL_BATCH} [{card}]")
    return counts


PHASES = ("kernels", "slice1", "paged", "batch", "writefirst", "spec", "multistep",
          "dense_batch", "sampled", "openai", "draft", "prefix_swap", "mlora", "grammar",
          "eval", "profile",
          "precision", "int8", "mlp_probe", "int4", "train", "load", "attn_probes")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one batched decode step and one verify step "
                         "(torch.profiler)")
    ap.add_argument("--phases", default=None,
                    help=f"comma-separated subset of {', '.join(PHASES)}; prints no result line")
    args = ap.parse_args(argv)
    full = [p for p in PHASES if p != "profile" or args.profile]
    phases = full if args.phases is None else args.phases.split(",")
    if not set(phases) <= set(PHASES):
        raise SystemExit(f"chip_smoke: unknown phase in {phases}")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from vis_zephyr_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.lib()
    print(f"build: nvcc {' '.join(_kernels.NVCC_FLAGS)}, one process per source -> "
          f"{_kernels.LIB} in {time.perf_counter() - t0:.1f} s")

    clock = [time.perf_counter()]

    def done(phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    gen = torch.Generator("cuda").manual_seed(args.seed)
    dense, dense8, int8_logits = {}, {}, None
    if "kernels" in phases:
        k1 = check_flash(gen)
        k78 = check_flash_bwd(gen)
        done("kernels K1, K7, K8")
        k2 = check_cache_append(gen)
        k3 = check_paged_attention(gen)
        k4 = check_paged_rows(gen)
        k3_rows = check_paged_attention_rows(gen)
        k3_single = check_paged_single(gen)
        k4_update = check_paged_update(gen)
        done("kernels K1-K4")
        k5 = check_quant_matmul(gen)
        done("kernels K5")
        k6 = check_quant_matmul_int4(gen)
        done("kernels K6")
        k9 = check_fused_mlp(gen)
        done("kernels K9")
    model = None
    if set(phases) - {"kernels", "train", "load", "attn_probes"}:
        model, cfg = build_model(args.seed)
    if "slice1" in phases:
        dense = run_slice(model, cfg, args.seed, args.max_new_tokens, card)
        done("slice1")
    if "paged" in phases:
        paged = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card, observe=True)
        done("paged")
    if "batch" in phases:
        batch = run_fixed_batch(model, cfg, args.seed)
        done("batch")
    if "writefirst" in phases:
        from vis_zephyr_tpu_torch.ops import paged_attention as pa

        pa.attn_launches = pa.update_launches = 0
        writefirst = run_writefirst(model, cfg, args.seed)
        run_step_profile(model, cfg, args.seed, card)
        done("writefirst")
    if "spec" in phases:
        spec_dense = run_spec_dense(model, cfg, args.seed, args.max_new_tokens, card)
        # The same burst without speculation first, for the comparison only.
        unspec = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card, n=16,
                                  label="spec paged, lookahead 0", repeat=True)
        spec_paged = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card, n=16,
                                      label="spec paged", lookahead=SPEC_LOOKAHEAD, repeat=True)
        agree = sorted(first_divergence(spec_paged["streams"][sid], words)
                       for sid, words in unspec["streams"].items())
        print(f"spec paged: the burst of 16 with --lookahead {SPEC_LOOKAHEAD}: "
              f"{spec_paged['tokens_per_s']:.1f} tokens/s, TTFT median "
              f"{spec_paged['ttft_median'] * 1e3:.1f} ms; without: {unspec['tokens_per_s']:.1f} "
              f"tokens/s, {unspec['ttft_median'] * 1e3:.1f} ms; the two replies of a session agree "
              f"on their first {agree} of {args.max_new_tokens} tokens (other steps share other "
              f"batches: bf16 ties may break apart) [{card}]")
        run_spec_batch(model, cfg, args.seed)
        run_verify_replay(model, cfg, args.seed, card)
        done("spec")
    if "multistep" in phases:
        run_burst_batch(model, cfg, args.seed, card)
        multistep_paged = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card,
                                           label="multistep paged", multi_step=BURST_STEPS)
        multistep_dense = run_burst_dense(model, cfg, args.seed, args.max_new_tokens, card)
        run_burst_timing(model, cfg, args.seed, card)
        done("multistep")
    if "dense_batch" in phases:
        dense_batch = run_dense_batch(model, cfg, args.seed, args.max_new_tokens, card)
        done("dense_batch")
    if "sampled" in phases:
        sampled = run_sampled(model, cfg, args.seed, card)
        done("sampled")
    if "openai" in phases:
        openai = run_openai(model, cfg, args.seed, card)
        done("openai")
    if "draft" in phases:
        drafted = run_draft(model, cfg, args.seed, args.max_new_tokens, card)
        done("draft")
    if "prefix_swap" in phases:
        prefix_swap = run_prefix_swap(model, cfg, args.seed, card)
        gc.collect()  # the server's handler class holds its engine in a cycle
        torch.cuda.empty_cache()
        done("prefix_swap")
    if "mlora" in phases:
        mlora = run_mlora(model, cfg, args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()
        done("mlora")
    if "grammar" in phases:
        grammar = run_grammar(model, cfg, args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()
        done("grammar")
    if "eval" in phases:
        evaluated = run_eval(model, cfg, args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()
        done("eval")
    if "profile" in phases:
        run_profile(model, cfg, args.seed, card)
        run_profile(model, cfg, args.seed, card, label="spec profile", lookahead=SPEC_LOOKAHEAD)
        run_dense_profile(model, cfg, args.seed, card)
        run_prefill_profile(model, cfg, args.seed, card)
        done("profile")
    if "precision" in phases:
        if "slice1" not in phases:
            raise SystemExit("chip_smoke: the precision phase needs slice1")
        torch.cuda.empty_cache()
        check_precision(model, cfg, *dense["precision_inputs"])
        done("precision")
    if "int8" in phases:
        # --load-8bit on both served paths: a fresh model from the same seed,
        # quantized in place after the bf16 one is gone.
        if "batch" not in phases:
            raise SystemExit("chip_smoke: the int8 phase needs batch (its bf16 reference)")
        del model
        dense.pop("precision_inputs", None)
        gc.collect()  # the servers' handler classes hold their engines in cycles
        torch.cuda.empty_cache()
        model, cfg = quantize_model(args.seed, card, bits=8)
        dense8 = run_slice(model, cfg, args.seed, args.max_new_tokens, card, n_requests=2,
                           label="int8 dense")
        paged8 = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card, n=16,
                                  label="int8 paged")
        int8_logits = run_fixed_batch_quant(model, cfg, args.seed, batch, card)
        run_verify_routes(model, cfg, args.seed, card)
        if "dense_batch" in phases:
            dense_batch8 = run_dense_batch_quant(model, cfg, args.seed, card)
        if "mlora" in phases:
            mlora8 = run_mlora_int8(model, cfg, args.seed, card)
        if "multistep" in phases:
            run_burst_timing(model, cfg, args.seed, card, label="int8 multistep",
                             sizes=(BURST_STEPS,), dense=False)
        done("int8")
        if "profile" in phases:
            run_profile(model, cfg, args.seed, card, label="int8 profile")
            run_profile(model, cfg, args.seed, card, label="int8 spec profile",
                        lookahead=SPEC_LOOKAHEAD)
            done("int8 profile")
    if "mlp_probe" in phases:
        # The port's probe run (numerics, then K9 at both tilings and the K5
        # route in CUDA graphs of 32 chained calls), and K9 on a real int8
        # layer's MLP: layer 0 of the int8 phase's model, else a full-width
        # MLP quantized alike.
        from vis_zephyr_tpu_torch.experiments import fused_mlp_matvec_probe as probe

        probe.launches = 0
        probe_run = probe.main(["--seed", str(args.seed)])
        if "int8" in phases:
            layer = model.decoder.model.layers[0]
            run_mlp_layer(layer.mlp, cfg.decoder.hidden_size, layer.post_attention_layernorm.weight,
                          cfg.decoder.rms_norm_eps, "layer 0 of the int8 model", card)
        else:
            mlp, hidden, norm, eps = standalone_int8_mlp(args.seed)
            run_mlp_layer(mlp, hidden, norm, eps, "a full-width MLP quantized as load_8bit does",
                          card)
            del mlp
        mlp_probe = {"k9": probe.launches}
        print(f"mlp_probe: K9 launches {probe.launches} (the probe's eager warm-ups and graph "
              f"captures, and the layer check)")
        done("mlp_probe")
    if "int4" in phases:
        # --load-4bit on both served paths: int4 decoder, int8 Q-Former, again a
        # fresh model from the same seed once the one before is gone.
        if "batch" not in phases:
            raise SystemExit("chip_smoke: the int4 phase needs batch (its bf16 reference)")
        del model
        for run in (dense, dense8):
            run.pop("precision_inputs", None)
        gc.collect()
        torch.cuda.empty_cache()
        model, cfg = quantize_model(args.seed, card, bits=4)
        dense4 = run_slice(model, cfg, args.seed, args.max_new_tokens, card, n_requests=2,
                           label="int4 dense")
        paged4 = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card, n=16,
                                  label="int4 paged")
        run_fixed_batch_quant(model, cfg, args.seed, batch, card, int8=int8_logits)
        run_verify_routes(model, cfg, args.seed, card)
        if "multistep" in phases:
            run_burst_timing(model, cfg, args.seed, card, label="int4 multistep",
                             sizes=(BURST_STEPS,), dense=False)
        done("int4")
        if "profile" in phases:
            run_profile(model, cfg, args.seed, card, label="int4 profile")
            done("int4 profile")
    if "train" in phases:
        # The trainer builds its own full-width model from the seed: the
        # served one goes first.
        del model
        for run in (dense, dense8):
            run.pop("precision_inputs", None)
        gc.collect()
        torch.cuda.empty_cache()
        trained = run_train(args.seed, card)
        done("train")
    if "load" in phases:
        # The load paths build their own full-width model from the seed.
        model = None
        for run in (dense, dense8):
            run.pop("precision_inputs", None)
        gc.collect()
        torch.cuda.empty_cache()
        loads = run_load(args.seed, args.max_new_tokens, card)
        done("load")
    if "attn_probes" in phases:
        # Last, so that the K10 and K11 counters, still 0 when it starts, show
        # that no served phase launched either kernel.
        model = None
        gc.collect()
        torch.cuda.empty_cache()
        attn = run_attn_probes(args.seed, gen, card)
        done("attn_probes")
    if phases != full:
        print(f"partial run of phases {phases}: no result line")
        return

    # The counts of the served runs (bf16, int8 and int4 weights on each
    # path, speculation on each path, multi-step bursts on each path, the
    # dense batcher on bf16 and int8 weights, per-request sampling on both
    # batchers, the OpenAI endpoints, each batcher's four runs of the draft
    # phase, the prefix cache and lazy allocation's runs and the runs with a
    # multi-LoRA pack on bf16 and int8 weights, the grammar phase's runs on
    # its three paths, and the evaluation harness's greedy batch and beam
    # searches), each set to 0 just before its run and read just
    # after it. `launches` is their sum and `launches_by_path`
    # says which run gave what.
    runs = {"dense": dense, "paged": paged, "dense_int8": dense8, "paged_int8": paged8,
            "dense_int4": dense4, "paged_int4": paged4, "spec_dense": spec_dense,
            "spec_paged": spec_paged, "multistep_dense": multistep_dense,
            "multistep_paged": multistep_paged, "dense_batch": dense_batch,
            "dense_batch_int8": dense_batch8, "sampled_dense": sampled["dense"],
            "sampled_paged": sampled["paged"], "openai": openai,
            "draft_paged": drafted["paged"], "draft_dense": drafted["dense"],
            "prefix_swap": prefix_swap, "mlora": mlora, "mlora_int8": mlora8,
            "grammar": grammar, "eval": evaluated,
            "writefirst": writefirst, "mlp_probe": mlp_probe,
            "train": trained["train"], "train_lora": trained["train_lora"],
            "load": loads["load"], "load_int8": loads["load_int8"], "attn_probes": attn}
    by_path = {name: {path: run.get(key, 0) for path, run in runs.items()}
               for name, key in (("flash_fwd", "k1"), ("dense_cache_append", "k2"),
                                 ("paged_attn_decode", "k3"), ("paged_kv_rows", "k4"),
                                 ("quant_matmul_int8", "k5"), ("quant_matmul_int4", "k6"),
                                 ("paged_kv_update", "kvu"), ("flash_bwd_dkv", "k7"),
                                 ("flash_bwd_dq", "k8"), ("fused_mlp_matvec", "k9"),
                                 ("paged_attn_batched", "k10"), ("paged_attn_paired", "k11"))}
    # Each path must have gone through its own kernels (chunked admission
    # attends its scratch cache with plain attention, so K1 is the dense path's).
    dense_kernels = ("flash_fwd", "dense_cache_append")
    paged_kernels = ("dense_cache_append", "paged_attn_decode", "paged_kv_rows")
    both = ("quant_matmul_int8", "quant_matmul_int4")  # the int4 Q-Former stays int8
    on_path = {"dense": dense_kernels, "paged": paged_kernels,
               "dense_int8": dense_kernels + ("quant_matmul_int8",),
               "paged_int8": paged_kernels + ("quant_matmul_int8",),
               "dense_int4": dense_kernels + both, "paged_int4": paged_kernels + both,
               "spec_dense": dense_kernels,
               "multistep_dense": dense_kernels, "multistep_paged": paged_kernels,
               "spec_paged": ("dense_cache_append", "paged_attn_decode", "paged_kv_update"),
               "dense_batch": ("dense_cache_append",),
               "dense_batch_int8": ("dense_cache_append", "quant_matmul_int8"),
               "sampled_dense": ("flash_fwd", "dense_cache_append"),
               "sampled_paged": ("flash_fwd", "paged_attn_decode", "paged_kv_rows"),
               "openai": ("dense_cache_append",),
               # The drafts admit whole (K1) and step their dense caches (K2).
               "draft_paged": ("flash_fwd", "dense_cache_append", "paged_attn_decode",
                               "paged_kv_update"),
               "draft_dense": ("flash_fwd", "dense_cache_append"),
               # Warm admissions' suffix chunks (K2), decode steps over shared
               # and grown pages (K3, K4).
               "prefix_swap": paged_kernels,
               # With the pack loaded: whole admissions (K1), the dense
               # batcher's steps and chunked admissions (K2), the paged steps
               # (K3, K4) and verify steps (K4's other entry), and K5 under
               # every projection on int8 weights.
               "mlora": ("flash_fwd",) + paged_kernels + ("paged_kv_update",),
               "mlora_int8": ("flash_fwd", "paged_attn_decode", "paged_kv_rows",
                              "quant_matmul_int8"),
               # The grammar phase's admissions (K1), the dense and serialized
               # masked steps (K2) and the paged ones (K3, K4).
               "grammar": ("flash_fwd",) + paged_kernels,
               # The harness's batched prefill and beam prefills (K1), its
               # greedy and beam decode steps (K2).
               "eval": dense_kernels,
               "writefirst": ("paged_attn_decode", "paged_kv_update"),
               "mlp_probe": ("fused_mlp_matvec",),
               "train": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
               "train_lora": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
               "load": dense_kernels, "load_int8": dense_kernels + ("quant_matmul_int8",),
               "attn_probes": ("paged_attn_batched", "paged_attn_paired")}
    if not all(by_path[name][path] > 0 for path, names in on_path.items() for name in names):
        raise AssertionError(f"a kernel was never launched on its served path: {by_path}")
    if any(n for name in ("paged_attn_batched", "paged_attn_paired")
           for path, n in by_path[name].items() if path != "attn_probes"):
        raise AssertionError(f"K10 or K11 launched outside the attention probes: {by_path}")
    paged_py = "vis_zephyr_tpu/ops/paged_attention.py"
    kernels = [
        dict(name="flash_fwd", source="vis_zephyr_tpu_torch/csrc/flash_fwd.cu",
             replaces="vis_zephyr_tpu/ops/flash_attention.py:42",
             max_abs_err=k1["max_abs_err"], **k1["times"][256], by_shape=k1["times"],
             sass=k1["sass"]),
        dict(name="dense_cache_append", source="vis_zephyr_tpu_torch/csrc/dense_cache_append.cu",
             replaces="vis_zephyr_tpu/ops/kv_cache.py:37",
             max_abs_err=k2["max_abs_err"], **k2["times"]),
        dict(name="paged_attn_decode", source="vis_zephyr_tpu_torch/csrc/paged_attn_decode.cu",
             replaces=f"{paged_py}:109, {paged_py}:417, {paged_py}:604 and {paged_py}:911",
             max_abs_err=max(k3["max_abs_err"], k3_rows["max_abs_err"], k3_single["max_abs_err"]),
             **k3["times"], at_2048=k3["at_2048"], by_rows=k3_rows["by_rows"],
             rows_7_8=k3_single["times"], sass=k3["sass"], resources=k3["resources"]),
        dict(name="paged_kv_rows", source="vis_zephyr_tpu_torch/csrc/paged_kv_rows.cu",
             replaces=f"{paged_py}:1691", max_abs_err=k4["max_abs_err"], **k4["times"]),
        # Timed at gate/up, M = 32; `passes` holds a decoder pass at each M.
        dict(name="quant_matmul_int8", source="vis_zephyr_tpu_torch/csrc/quant_matmul_int8.cu",
             replaces="vis_zephyr_tpu/ops/quant_matmul.py:34", max_abs_err=k5["max_abs_err"],
             **k5["times"], passes=k5["passes"], sass=k5["sass"], resources=k5["resources"]),
        dict(name="quant_matmul_int4", source="vis_zephyr_tpu_torch/csrc/quant_matmul_int4.cu",
             replaces="vis_zephyr_tpu/ops/quant_matmul.py:116", max_abs_err=k6["max_abs_err"],
             **k6["times"], passes=k6["passes"], sass=k6["sass"], resources=k6["resources"]),
        dict(name="paged_kv_update", source="vis_zephyr_tpu_torch/csrc/paged_kv_rows.cu",
             replaces=f"{paged_py}:1482 and {paged_py}:1574",
             max_abs_err=k4_update["max_abs_err"], **k4_update["times"]),
        # Timed at causal B=1, T=S=2048; `by_shape` holds T=S=256 and the
        # trainer's B=8 with padded keys too.
        dict(name="flash_bwd_dkv", source="vis_zephyr_tpu_torch/csrc/flash_bwd.cu",
             replaces="vis_zephyr_tpu/ops/flash_attention.py:200",
             max_abs_err=k78["dkv"]["max_abs_err"], **k78["dkv"]["times"][2048],
             by_shape=k78["dkv"]["times"], sass=k78["dkv"]["sass"],
             resources=k78["dkv"]["resources"]),
        dict(name="flash_bwd_dq", source="vis_zephyr_tpu_torch/csrc/flash_bwd.cu",
             replaces="vis_zephyr_tpu/ops/flash_attention.py:262",
             max_abs_err=k78["dq"]["max_abs_err"], **k78["dq"]["times"][2048],
             by_shape=k78["dq"]["times"], sass=k78["dq"]["sass"],
             resources=k78["dq"]["resources"]),
        # Timed at M = 1 (single-stream decode) at the default block_i; `by_M` holds
        # M = 8 and both tilings, the K5 route and the int8-pack yardstick.
        dict(name="fused_mlp_matvec", source="vis_zephyr_tpu_torch/csrc/fused_mlp_matvec.cu",
             replaces="experiments/fused_mlp_matvec_probe.py:38", max_abs_err=k9["max_abs_err"],
             **{key: k9["times"][1][key] for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                                     "bound_ms", "bound_by", "k5_route_ms",
                                                     "k5_route_device_ms", "int8pack_route_ms")},
             by_M=k9["times"], probe_us_per_layer=probe_run.get("us_per_layer")),
        # At the probes' bench shape (128 slots of 640 tokens, one layer);
        # `probe_step_ms` holds each probe's routes per 32-layer step at 128
        # and at 32 slots.
        dict(name="paged_attn_batched", source="vis_zephyr_tpu_torch/csrc/paged_attn_grouped.cu",
             replaces="experiments/batched_paged_attention_probe.py:19",
             max_abs_err=attn["max_abs_err"]["k10"], **attn["times"]["paged_attn_batched"]),
        dict(name="paged_attn_paired", source="vis_zephyr_tpu_torch/csrc/paged_attn_paired.cu",
             replaces="experiments/paired_slot_attention_probe.py:28",
             max_abs_err=attn["max_abs_err"]["k11"], **attn["times"]["paged_attn_paired"]),
    ]
    for kernel in kernels:
        counts = by_path[kernel["name"]]
        kernel.update(route="cuda", launches=sum(counts.values()), launches_by_path=counts)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

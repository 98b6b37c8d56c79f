"""GPU smoke run of the PyTorch port's single-request serving path.

    python3 chip_smoke.py [--seed N] [--max-new-tokens N]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; exits non-zero on a machine without a card. Phases:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds `vis_zephyr_tpu_torch/csrc/*.cu` into the ignored
             `vis_zephyr_tpu_torch/build/`;
3. K1      — flash_fwd against its plain version (f32 from the same bf16
             inputs): causal T=S 256 and 2048, non-causal, and B=2 with
             right-padded keys plus a row that has no valid key;
             output max-abs <= 2e-2, logsumexp max-abs <= 1e-2;
4. K2      — dense_cache_append against its plain version, bit-exact;
             median kernel and plain times over 20 CUDA-event runs;
5. slice   — full-width Zephyr-7B + CLIP-L/336 + Q-Former with random bf16
             weights, the port's /chat server on 127.0.0.1, 3 sessions and 4
             requests; checks the launch counters and the kernel path's
             prefill and decode-step-8 logits against the plain path
             (cosine >= 0.999); TTFT and decode tokens/s; last, the bf16
             prefill logits against an f32 run of the same weights (the JAX
             engine's arithmetic for f32 pixels; cosine >= 0.999).

The line before last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Any failed check raises.
"""

from __future__ import annotations

import argparse
import http.client
import json
import statistics
import subprocess
import threading
import time
import zlib

import torch

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


def check_flash(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    Hq, Hkv, D = 32, 8, 128
    S_row = torch.arange(256, device=dev)
    padded = torch.stack([S_row < 200, (S_row >= 1) & (S_row < 230)])  # b=1, q row 0: no key
    cases = [
        ("causal T=S=256", 1, 256, 256, True, None),
        ("causal T=S=2048", 1, 2048, 2048, True, None),
        ("non-causal T=256 S=512", 1, 256, 512, False, None),
        ("causal B=2 padded kv_valid", 2, 256, 256, True, padded),
    ]
    worst = 0.0
    times = {}
    for name, B, T, S, causal, kv_valid in cases:
        q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        if kv_valid is None:
            kv_valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        scale = D ** -0.5
        out, m, l = fa.flash_attention_fwd(q, k, v, kv_valid, causal, scale)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), kv_valid, causal, scale)
        ref_lse = masked_lse(q, k, kv_valid, causal, scale)
        has_key = torch.isfinite(ref_lse)
        err = (out.float() - ref).abs()
        # Rows without a valid key must be exactly 0 (the plain version's
        # uniform softmax over -1e30 scores is no reference there).
        err = err.masked_fill(~has_key.transpose(1, 2)[..., None], 0.0)
        out_err = float(err.max())
        empty_rows = ~has_key.transpose(1, 2)
        if bool(empty_rows.any()):
            if float(out.float()[empty_rows].abs().max()) != 0.0:
                raise AssertionError(f"K1 {name}: a row with no valid key is not 0")
            if bool((l[~has_key] != 0).any()):
                raise AssertionError(f"K1 {name}: l is not 0 on a row with no valid key")
        lse = m + torch.log(l)
        lse_err = float((lse - ref_lse)[has_key].abs().max())
        print(f"K1 {name}: out max-abs {out_err:.3e} (<= 2e-2), lse max-abs "
              f"{lse_err:.3e} (<= 1e-2), rows without a key: {int(empty_rows.sum())}")
        if not (out_err <= 2e-2 and lse_err <= 1e-2):
            raise AssertionError(f"K1 {name}: kernel disagrees with the plain version")
        worst = max(worst, out_err)
        if causal and B == 1:
            kernel_ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v, kv_valid, causal, scale))
            plain_ms = median_ms(lambda: fa.flash_attention_plain(q, k, v, kv_valid, causal, scale))
            times[T] = (kernel_ms, plain_ms)
            print(f"K1 {name}: kernel {kernel_ms:.4f} ms, plain (bf16 matmul + f32 softmax) "
                  f"{plain_ms:.4f} ms, median of 20")
    return {"max_abs_err": worst, "times": times}


def check_cache_append(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import kv_cache

    dev = "cuda"
    Hkv, D = 8, 128
    cases = [("L=32 B=1 S=2048 T=1", 32, 1, 2048, 1, [517]),
             ("L=32 B=3 S=2048 T=4, one length at S-2", 32, 3, 2048, 4, [0, 1000, 2046])]
    times = None
    for name, L, B, S, T, lens in cases:
        ck = torch.randn(L, B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        cv = torch.randn(L, B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        layer = L - 3
        got_k, got_v = ck.clone(), cv.clone()
        kv_cache.dense_cache_update(got_k, got_v, k, v, lengths, layer)
        ref_k, ref_v = ck.clone(), cv.clone()
        kv_cache.dense_cache_update_plain(ref_k, ref_v, k, v, lengths, layer)
        torch.cuda.synchronize()
        exact = torch.equal(got_k, ref_k) and torch.equal(got_v, ref_v)
        print(f"K2 {name}: bit-exact against the plain version: {exact}")
        if not exact:
            raise AssertionError(f"K2 {name}: kernel disagrees with the plain version")
        if times is None:
            kernel_ms = median_ms(lambda: kv_cache.dense_cache_update(got_k, got_v, k, v, lengths, layer))
            plain_ms = median_ms(lambda: kv_cache.dense_cache_update_plain(ref_k, ref_v, k, v, lengths, layer))
            times = (kernel_ms, plain_ms)
            print(f"K2 {name}: kernel {kernel_ms:.4f} ms, plain (indexed write) "
                  f"{plain_ms:.4f} ms, median of 20")
    return {"max_abs_err": 0.0, "times": times}


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


def run_slice(seed: int, max_new_tokens: int, card: str) -> dict:
    import numpy as np

    from vis_zephyr_tpu_torch.models.vis_zephyr import VisZephyrConfig, init_vis_zephyr
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve.api import serve
    from vis_zephyr_tpu_torch.serve.engine import DEFAULT_IMAGE_TOKEN, ChatEngine
    from vis_zephyr_tpu_torch.serve.generate import _cache_len, decode_step, prefill

    cfg = VisZephyrConfig()
    L = cfg.decoder.num_layers
    t0 = time.perf_counter()
    model = init_vis_zephyr(cfg, torch.Generator("cuda").manual_seed(seed), device="cuda",
                            dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(model, name).parameters())
                for name in ("vision", "projector", "decoder")}
    print(f"slice: full-width VisZephyrConfig() with random bf16 weights "
          f"(vision {n_params['vision'] / 1e9:.2f} B, projector {n_params['projector'] / 1e9:.2f} B, "
          f"decoder {n_params['decoder'] / 1e9:.2f} B params) in {time.perf_counter() - t0:.1f} s")

    tokenizer = WordTokenizer(cfg.decoder.vocab_size)
    engine = ChatEngine(model, cfg, tokenizer, max_new_tokens=max_new_tokens)
    rng = np.random.default_rng(seed)
    side = cfg.vision.image_size
    sessions = [f"s{i}" for i in range(3)]
    pixels = {}
    for sid in sessions:
        # Seeded pixels [4, 336, 336, 3] with 3 valid patches, attached the way
        # `attach_image` stores a preprocessed image (no PIL on the card's host).
        px = rng.standard_normal((4, side, side, 3)).astype(np.float32)
        px[3] = 0.0
        pixels[sid] = px
        engine.attach_pixels(sid, px, np.array([True, True, True, False]), (2 * side, side))

    server = serve(engine, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    # A session's first turn carries the <image> placeholder, as `chat` adds
    # it when it attaches an image itself.
    requests = [(sessions[0], f"{DEFAULT_IMAGE_TOKEN}\ndescribe the picture"),
                (sessions[1], f"{DEFAULT_IMAGE_TOKEN}\nwhat is in the image"),
                (sessions[2], f"{DEFAULT_IMAGE_TOKEN}\ncount the objects"),
                (sessions[0], "and what colour is it")]
    results = []
    try:
        fa.launches = 0
        kv_cache.launches = 0
        for sid, question in requests:
            status, text, ttft, total = post_chat(port, {"session_id": sid, "question": question})
            n = len(text.split())
            results.append((sid, status, text, ttft, total, n))
        flash_launches, append_launches = fa.launches, kv_cache.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    decode_steps = 0
    rates = []
    for sid, status, text, ttft, total, n in results:
        words_ok = n > 0 and all(w[0] == "w" and w[1:].isdigit() for w in text.split())
        print(f"slice request {sid}: HTTP {status}, {n} tokens streamed, TTFT {ttft * 1e3:.1f} ms, "
              f"total {total * 1e3:.1f} ms, text starts {text[:48]!r}")
        if status != 200 or not words_ok:
            raise AssertionError(f"request on {sid} did not stream text")
        decode_steps += min(n, max_new_tokens - 1)
        if n > 1:
            rates.append((n - 1) / (total - ttft))
    print(f"slice counters: K1 flash_fwd {flash_launches} launches (want {L * len(requests)}), "
          f"K2 dense_cache_append {append_launches} (want {L} x {decode_steps} decode steps)")
    if flash_launches != L * len(requests) or append_launches != L * decode_steps:
        raise AssertionError("the serving path did not go through the kernels as counted")

    # Kernel path against the plain path on session s1's request.
    ids = torch.tensor([engine.prompt_ids(requests[1][1])], device="cuda")
    images = torch.as_tensor(pixels[sessions[1]], device="cuda")[None]
    valid = torch.tensor([[True, True, True, False]], device="cuda")
    # The cache length `generate_stream` picks, so the kernel path's greedy
    # tokens must equal the streamed ones exactly.
    cache_len = _cache_len(ids.shape[1], images, cfg, max_new_tokens)
    last_k, cache_k, lengths = prefill(model, ids, images, valid, cfg, cache_len)
    last_p, cache_p, _ = prefill(model, ids, images, valid, cfg, cache_len, use_flash=False)
    if not (bool(torch.isfinite(last_k).all()) and last_k.shape == (1, cfg.decoder.vocab_size)):
        raise AssertionError(f"prefill logits not finite of shape [1, V]: {tuple(last_k.shape)}")
    cos_prefill = cosine(last_k, last_p)
    token = last_k.argmax(-1)
    direct = [int(token)]
    for _ in range(8):
        logits_k, cache_k = decode_step(model, cache_k, token, cfg, pallas_cache=True)
        logits_p, cache_p = decode_step(model, cache_p, token, cfg, pallas_cache=False)
        token = logits_k.argmax(-1)
        direct.append(int(token))
    cos_decode = cosine(logits_k, logits_p)
    streamed = [int(w[1:]) for w in results[1][2].split()][:len(direct)]
    same_tokens = direct[:len(streamed)] == streamed  # a stream ends early only at EOS
    print(f"slice check (prefill length {int(lengths[0])}, padded to a multiple of 128): "
          f"prefill last-token logits cosine {cos_prefill:.6f}, decode-step-8 logits cosine "
          f"{cos_decode:.6f} (kernel path vs use_flash=False / pallas_cache=False, >= 0.999); "
          f"direct greedy tokens equal the streamed ones: {same_tokens}")
    if not (cos_prefill >= 0.999 and cos_decode >= 0.999 and bool(torch.isfinite(logits_k).all())):
        raise AssertionError("kernel path disagrees with the plain path")
    if not same_tokens:
        raise AssertionError(f"served tokens {streamed} differ from a direct run's {direct}")

    ttfts = [r[3] for r in results]
    rate = statistics.median(rates) if rates else float("nan")
    print(f"slice: TTFT median {statistics.median(ttfts) * 1e3:.1f} ms (first request "
          f"{ttfts[0] * 1e3:.1f} ms), decode {rate:.2f} tokens/s median over requests, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")

    # Precision: the port runs the multimodal prefill in bf16, while the JAX
    # engine's f32 pixels promote its vision stack and prefill to f32 over the
    # same bf16 weights. Hold the kernel path's logits against that
    # arithmetic: the same weights widened to f32 (exactly), plain attention.
    del cache_k, cache_p
    model.float()
    last_f32, _, _ = prefill(model, ids, images, valid, cfg, cache_len, use_flash=False)
    cos_f32 = cosine(last_k, last_f32)
    same_top1 = int(last_k.argmax(-1)) == int(last_f32.argmax(-1))
    print(f"slice precision: bf16 kernel-path prefill last-token logits against an f32 run of "
          f"the same weights: cosine {cos_f32:.6f} (>= 0.999), max-abs "
          f"{float((last_k - last_f32).abs().max()):.4e}, same top-1 token: {same_top1}")
    if not cos_f32 >= 0.999:
        raise AssertionError("bf16 prefill disagrees with the f32 run of the same weights")
    return {"flash_launches": flash_launches, "append_launches": append_launches}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {card}")

    from vis_zephyr_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.lib()
    print(f"build: nvcc {' '.join(_kernels.NVCC_FLAGS)} -> {_kernels.LIB} "
          f"in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator("cuda").manual_seed(args.seed)
    k1 = check_flash(gen)
    k2 = check_cache_append(gen)
    counts = run_slice(args.seed, args.max_new_tokens, card)

    k1_ms, k1_plain = k1["times"][256]
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": "vis_zephyr_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "vis_zephyr_tpu/ops/flash_attention.py:42",
         "launches": counts["flash_launches"], "max_abs_err": k1["max_abs_err"],
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "dense_cache_append", "route": "cuda",
         "source": "vis_zephyr_tpu_torch/csrc/dense_cache_append.cu",
         "replaces": "vis_zephyr_tpu/ops/kv_cache.py:37",
         "launches": counts["append_launches"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["times"][0], "plain_ms": k2["times"][1]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

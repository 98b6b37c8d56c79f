"""Shared helpers of the `tests/test_torch_*.py` files.

The PyTorch port keeps its own config dataclasses; the tests build the JAX
package's config and rebuild the port's from it field by field, so both
packages run the same model. The paged batchers' scripted drive and state
snapshots (`drive`, `jax_snapshot`, `port_snapshot`, `assert_same_state`)
serve the paged serving and prefix-cache tests. `one_torch_thread` is the
autouse fixture that every port test file imports. `jax_params_numpy` keeps
each (config, seed)'s JAX init on disk (`tests/.jax_params/`, keyed by the
JAX package's model sources), so that the modules which share one compute
it once a run. The paged-attention cases of the single-row and the ops
tests (`single_case`, `run_single`, `ops_case`, `ops_run_both`) serve the
files those tests were split into.
"""

import dataclasses
import functools
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vis_zephyr_tpu_torch import config as tconfig
from vis_zephyr_tpu_torch.ops import paged_attention as tpa


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread while a port test module runs. The suite
    runs several pytest workers on a few cores, and each worker's default
    pool (a thread a core) oversubscribes them: tiny models' small ops then
    spend their time waiting for threads. A module imports this fixture to
    take it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(jax_cfg) -> tconfig.VisZephyrConfig:
    """The port's `VisZephyrConfig` with every field of the JAX package's."""
    raw = dataclasses.asdict(jax_cfg)
    return tconfig.VisZephyrConfig(
        vision=tconfig.VisionConfig(**raw.pop("vision")),
        projector=tconfig.ProjectorConfig(**raw.pop("projector")),
        decoder=tconfig.DecoderConfig(**raw.pop("decoder")),
        **raw,
    )


PARAMS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_params")


@functools.lru_cache(maxsize=None)
def _init_sources_digest() -> str:
    """A digest of what the JAX init's values depend on: the jax and numpy
    versions and the JAX package's config and model sources."""
    import vis_zephyr_tpu

    root = os.path.dirname(vis_zephyr_tpu.__file__)
    h = hashlib.sha256(f"{jax.__version__} {np.__version__}".encode())
    files = [os.path.join(root, "config.py")] + sorted(
        os.path.join(root, "models", f) for f in os.listdir(os.path.join(root, "models"))
        if f.endswith(".py"))
    for path in files:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}|")
        else:
            yield f"{prefix}{key}", value


def _unflatten(items):
    tree = {}
    for path, value in items:
        *parents, leaf = path.split("|")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def jax_params_numpy(jax_cfg, seed: int):
    """Random JAX-package parameters as a tree (nested dicts) of numpy arrays.

    The values are `init_vis_zephyr(jax_cfg, PRNGKey(seed))`'s. Its jit
    compile costs seconds in each module that calls it, so the arrays are
    kept in `PARAMS_DIR` under a key of the config, the seed and
    `_init_sources_digest()`, and read back there by later calls."""
    key = hashlib.sha256(f"{jax_cfg!r} {seed} {_init_sources_digest()}".encode()).hexdigest()
    path = os.path.join(PARAMS_DIR, key[:32] + ".npz")
    if os.path.exists(path):
        with np.load(path) as saved:
            return _unflatten((name, saved[name]) for name in saved.files)
    from vis_zephyr_tpu.models.vis_zephyr import init_vis_zephyr

    init = jax.jit(init_vis_zephyr, static_argnums=(0,))
    params = jax.tree_util.tree_map(np.asarray, init(jax_cfg, jax.random.PRNGKey(seed)))
    os.makedirs(PARAMS_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **dict(_flatten(params)))
    os.replace(tmp, path)  # whole files only: other workers may be reading
    return params


def port_model(params, jax_cfg):
    """The port's `VisZephyr` carrying the JAX parameters `params`."""
    from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax
    from vis_zephyr_tpu_torch.models.vis_zephyr import VisZephyr

    tcfg = port_config(jax_cfg)
    model = VisZephyr(tcfg)
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return model.requires_grad_(False).eval()


def word_list(vocab_size: int):
    """"<s>", "</s>", "<unk>", "<image>", then "w0", "w1", ...: `vocab_size` words."""
    return ["<s>", "</s>", "<unk>", "<image>"] + [f"w{i}" for i in range(vocab_size - 4)]


def word_tokenizer(words):
    """An offline HF fast tokenizer of whole words (ids 0..len(words)-1), with
    HF's added-token machinery (`add_tokens`, `len`), saved and reloaded like
    a downloaded one."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                                   pad_token="</s>", unk_token="<unk>", model_max_length=512)


def assert_state_matches(got: dict, want: dict, **tol):
    """Two state dicts with the same keys and shapes, values within `tol`
    (numpy's `assert_allclose` keywords), compared in f32."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        np.testing.assert_allclose(got[key].float().numpy(), value.float().numpy(),
                                   err_msg=key, **tol)


def drive(batcher, requests, snapshot, max_steps=200):
    """Run a scripted scenario, [(ids, images, patch_valid, max_new_tokens,
    submit before step N)], through either package's paged batcher; returns
    (tokens per request, snapshots before each step, snapshots after each
    step)."""
    handles = {}
    before, after = [], []
    for step in range(max_steps):
        for i, (ids, images, valid, max_new, at) in enumerate(requests):
            if at == step:
                handles[i] = batcher.submit(ids, images, valid, max_new_tokens=max_new)
        if len(handles) == len(requests) and not batcher.has_work:
            break
        before.append(snapshot(batcher))
        batcher.step()
        after.append(snapshot(batcher))
    assert not batcher.has_work
    return [list(batcher.stream(handles[i])) for i in range(len(requests))], before, after


def jax_snapshot(b):
    """A JAX paged batcher's pools, scales, table, lengths, tokens and active set."""
    return dict(pools=tuple(None if a is None else np.asarray(a)
                            for a in (b.kp, b.vp, b.ksp, b.vsp)),
                table=np.asarray(b.page_table), lengths=np.asarray(b.lengths),
                token=np.asarray(b.token), active=b.active.copy())


def port_snapshot(b):
    """The port's paged batcher's state as `jax_snapshot` gives it (the pools
    through the layout converters)."""
    pools = tpa.pools_to_jax_layout(*(None if a is None else a.numpy().copy()
                                      for a in (b.kp, b.vp, b.ksp, b.vsp)))
    return dict(pools=pools, table=b.page_table.numpy().copy(),
                lengths=b.lengths.numpy().copy(), token=b.token.numpy().copy(),
                active=b.active.copy())


def assert_same_state(got, want, where):
    """Table, lengths, active set and tokens equal; f32 pools and scales to
    1e-4; int8 values within 1 and almost all equal (the two frameworks' f32
    matmuls round differently through the layers, which can move a value
    across a rounding boundary)."""
    np.testing.assert_array_equal(got["table"], want["table"], err_msg=where)
    np.testing.assert_array_equal(got["lengths"], want["lengths"], err_msg=where)
    np.testing.assert_array_equal(got["active"], want["active"], err_msg=where)
    np.testing.assert_array_equal(got["token"], want["token"], err_msg=where)
    for name, g, w in zip(("k_pages", "v_pages", "k_scales", "v_scales"),
                          got["pools"], want["pools"]):
        assert (g is None) == (w is None), (where, name)
        if g is None:
            continue
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, (where, name, diff.max())
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{where} {name}")


# -- paged-attention cases ----------------------------------------------------------------


def to_torch(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def to_jax(x):
    return None if x is None else jnp.asarray(x)


def np32(x):
    """A JAX or torch array as f32 numpy (bf16 widens exactly); int8 stays."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return (x if x.dtype == torch.int8 else x.float()).numpy()
    return np.asarray(x if x.dtype == jnp.int8 else x.astype(jnp.float32))


# The single-row `paged_attention` cases (`test_torch_paged_single*.py`).
SINGLE_TOL = dict(rtol=0, atol=2e-5)
SINGLE_HQ, SINGLE_HKV, SINGLE_D, SINGLE_PS, SINGLE_PPS, SINGLE_NPAGES = 8, 2, 128, 16, 4, 32
# Lengths: nothing in the pool, one token, a page boundary and past it, 37, full.
SINGLE_LENGTHS = [0, 1, SINGLE_PS, SINGLE_PS + 1, 37, SINGLE_PPS * SINGLE_PS]


def single_case(seed, lengths, pool, fused):
    """Pools in the JAX layout: JAX arrays (bf16, or int8 with scales) and
    the port's tensors holding the same values."""
    from vis_zephyr_tpu.ops import paged_attention as jpa

    HQ, HKV, D, PS, PPS, NPAGES = (SINGLE_HQ, SINGLE_HKV, SINGLE_D, SINGLE_PS, SINGLE_PPS,
                                   SINGLE_NPAGES)
    rng = np.random.default_rng(seed)
    B = len(lengths)
    table = rng.permutation(np.arange(1, NPAGES))[: B * PPS].reshape(B, PPS).astype(np.int32)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    kp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    vp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    ksc = vsc = None
    if pool == "int8":
        kp, ksc = (np.asarray(a) for a in jpa.quantize_kv_pool(jnp.asarray(kp)))
        vp, vsc = (np.asarray(a) for a in jpa.quantize_kv_pool(jnp.asarray(vp)))
    else:  # bf16 values, held as f32 numpy
        kp = np32(jnp.asarray(kp, jnp.bfloat16))
        vp = np32(jnp.asarray(vp, jnp.bfloat16))
    if fused:
        kp, vp = np.concatenate([kp, vp], axis=2), None
        if pool == "int8":
            ksc, vsc = np.concatenate([ksc, vsc], axis=3), None
    k_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    jk, jv = to_jax(kp), to_jax(vp)
    tk, tv, tks, tvs = (to_torch(a) for a in tpa.pools_from_jax_layout(kp, vp, ksc, vsc))
    if pool == "bf16":
        jk, tk = jk.astype(jnp.bfloat16), tk.to(torch.bfloat16)
        if vp is not None:
            jv, tv = jv.astype(jnp.bfloat16), tv.to(torch.bfloat16)
    return dict(q=q, table=table, lengths=np.asarray(lengths, np.int32), k_new=k_new,
                v_new=v_new, jax=(jk, jv, to_jax(ksc), to_jax(vsc)), port=(tk, tv, tks, tvs))


def run_single(case, lengths, selfterm, window=None, scale=None, jax_too=True):
    """(port `paged_attention`, JAX `paged_attention` in interpret mode)."""
    from vis_zephyr_tpu.ops import paged_attention as jpa

    _t, _j = to_torch, to_jax
    jk, jv, jks, jvs = case["jax"]
    tk, tv, tks, tvs = case["port"]
    new = dict(k_new=case["k_new"], v_new=case["v_new"]) if selfterm else {}
    before = tpa.attn_launches
    got = tpa.paged_attention(
        _t(case["q"]), tk, tv, _t(case["table"]), _t(lengths), scale=scale,
        sliding_window=window, k_scales=tks, v_scales=tvs,
        **{k: _t(v) for k, v in new.items()}).numpy()
    assert got.shape == case["q"].shape and tpa.attn_launches == before  # the plain version
    if not jax_too:
        return got, None
    want = jpa.paged_attention(
        _j(case["q"]), jk, jv, _j(case["table"]), _j(lengths), scale=scale, interpret=True,
        sliding_window=window, k_scales=jks, v_scales=jvs, **{k: _j(v) for k, v in new.items()})
    return got, np.asarray(want)


# The `paged_attention_fa` cases (`test_torch_paged_ops*.py`).
OPS_TOL = dict(rtol=0, atol=2e-5)
OPS_HQ, OPS_HKV, OPS_D, OPS_PS, OPS_PPS, OPS_NPAGES = 8, 2, 64, 16, 4, 32


def ops_case(seed, lengths, quant, fused):
    """Pools in the JAX layout (numpy): f32, or int8 with scales."""
    from vis_zephyr_tpu.ops import paged_attention as jpa

    HQ, HKV, D, PS, PPS, NPAGES = OPS_HQ, OPS_HKV, OPS_D, OPS_PS, OPS_PPS, OPS_NPAGES
    rng = np.random.default_rng(seed)
    B = len(lengths)
    table = rng.permutation(NPAGES)[: B * PPS].reshape(B, PPS).astype(np.int32)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    kp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    vp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    ksc = vsc = None
    if quant:
        kp, ksc = (np.asarray(a) for a in jpa.quantize_kv_pool(jnp.asarray(kp)))
        vp, vsc = (np.asarray(a) for a in jpa.quantize_kv_pool(jnp.asarray(vp)))
    if fused:
        kp, vp = np.concatenate([kp, vp], axis=2), None
        if quant:
            ksc, vsc = np.concatenate([ksc, vsc], axis=3), None
    k_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    return q, kp, vp, ksc, vsc, table, np.asarray(lengths, np.int32), k_new, v_new


def ops_run_both(case, selfterm, window=None, slot_block=1):
    """(port plain version, JAX kernel in interpret mode). `slot_block=1` is
    the JAX package's one-slot-per-program kernel (`_fa_mh_kernel`), None its
    default grouped one (`_fa_gmh_kernel`), which compiles four times as long."""
    from vis_zephyr_tpu.ops import paged_attention as jpa

    _t, _j = to_torch, to_jax
    q, kp, vp, ksc, vsc, table, lengths, k_new, v_new = case
    q_offs = lengths if selfterm else lengths - 1
    new = dict(k_new=k_new, v_new=v_new) if selfterm else {}
    want = jpa.paged_attention_fa(
        _j(q), _j(kp), _j(vp), _j(table), _j(lengths), _j(q_offs), sliding_window=window,
        k_scales=_j(ksc), v_scales=_j(vsc), interpret=True, slot_block=slot_block,
        **{k: _j(v) for k, v in new.items()})
    tk, tv, tks, tvs = tpa.pools_from_jax_layout(kp, vp, ksc, vsc)
    got = tpa.paged_attention_fa(
        _t(q), _t(tk), _t(tv), _t(table), _t(lengths), _t(q_offs), sliding_window=window,
        k_scales=_t(tks), v_scales=_t(tvs), **{k: _t(v) for k, v in new.items()})
    return got.numpy(), np.asarray(want)


# -- synthetic VCR records (`test_torch_vip.py`, `test_torch_eval.py`) -------------------

VCR_CLASSES = ["person", "person", "dog", "car"]


def vcr_records(root, n: int, seed: int = 0, size=(100, 80)):
    """`n` VCR records in the reference's raw format under `root` (a
    directory): each a seeded PNG of `size` (width, height), a `meta_dir`
    JSON with 4 detector boxes (score last) and a polygon mask per box (the
    second box's in two rings, one too short to keep), a question, 4 answer
    and 4 rationale choices whose entity tags name the boxes. Returns (the
    records, the image folder), the folder being what `meta_dir`'s
    "./dataset" stands for."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    folder = os.path.join(str(root), "vcr_images")
    os.makedirs(folder, exist_ok=True)
    W, H = size
    words = ["is", "the", "looking", "at", "holding", "near", "why", "what", "doing",
             "because", "they", "want", "to", "go", "home", "it", "rains", "smiling"]
    records = []
    for i in range(n):
        name = f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)).save(os.path.join(folder, name))
        boxes, segms = [], []
        for b in range(4):
            x0, y0 = rng.uniform(0, W * 0.6), rng.uniform(0, H * 0.6)
            x1, y1 = x0 + rng.uniform(8, W * 0.4), y0 + rng.uniform(8, H * 0.4)
            boxes.append([float(x0), float(y0), float(x1), float(y1), float(rng.uniform())])
            ring = [[float(x0), float(y0)], [float(x1), float(y0)],
                    [float(x1), float(y1)], [float(x0), float(y1)]]
            segms.append([ring, [[float(x0), float(y0)], [float(x1), float(y1)]]] if b == 1
                         else [ring])
        meta = f"meta{i}.json"
        with open(os.path.join(folder, meta), "w") as f:
            json.dump({"boxes": boxes, "segms": segms}, f)

        def corpus(k):
            picks = [str(w) for w in rng.choice(words, k)]
            tags = sorted({int(e) for e in rng.choice(4, int(rng.integers(1, 3)), replace=False)})
            picks.insert(int(rng.integers(0, k)), tags)
            return picks + ["?" if k % 2 else "."]

        records.append({
            "id": f"vcr-val-{i}",
            "question_id": f"q{i}",
            "image": name,
            "meta_dir": f"./dataset/{meta}",
            "class_names": VCR_CLASSES,
            "question": corpus(4),
            "answer_choices": [corpus(5) for _ in range(4)],
            "answer_label": int(rng.integers(0, 4)),
            "rationale_choices": [corpus(6) for _ in range(4)],
            "rationale_label": int(rng.integers(0, 4)),
        })
    return records, folder

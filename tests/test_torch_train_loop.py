"""The port's trainer on data, against the JAX package, on the CPU (moved
from `test_torch_train.py`, which holds the loss, the steps, the optimizer
and LoRA).

- The port's `preprocess` and `Collator` equal JAX's on a fixture.
- `train()` stage 1 on a PIL fixture: the same per-step losses as the JAX
  `train()` on a one-device mesh, the checkpoint layout, and resume from the
  latest full state with the data order fast-forwarded; what `train()` does
  not port (an FSDP or model mesh) and an orbax full state are refused by
  name.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.conversation import templates as jtemplates
from vis_zephyr_tpu.data import dataset as jdataset
from vis_zephyr_tpu.data import tokenization as jtok
from vis_zephyr_tpu_torch.conversation import templates as ttemplates
from vis_zephyr_tpu_torch.data import dataset as tdataset
from vis_zephyr_tpu_torch.data import tokenization as ttok
from vis_zephyr_tpu_torch.train import checkpoints as tckpt
from conftest import MockTokenizer

CFG = tiny_config()
TCFG = port_config(CFG)


# -- data --------------------------------------------------------------------------------


CONVERSATIONS = [
    [{"from": "human", "value": "<image>\nWhat is in the picture?"},
     {"from": "gpt", "value": "A red bus on a wet street."}],
    [{"from": "human", "value": "Describe it."}, {"from": "gpt", "value": "Noise."},
     {"from": "human", "value": "And the colour?"}, {"from": "gpt", "value": "Grey, mostly."}],
]


@pytest.mark.parametrize("template", ["zephyr_v1", "plain"])
def test_preprocess_and_collator_match_jax(template):
    tok = MockTokenizer()
    sources = CONVERSATIONS[:1] if template == "plain" else CONVERSATIONS
    for has_image in ((True,) if template == "plain" else (True, False)):
        want = jtok.preprocess(sources, tok, has_image=has_image, conv=jtemplates[template])
        got = ttok.preprocess(sources, tok, has_image=has_image, conv=ttemplates[template])
        for key in ("input_ids", "labels"):
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(0)
    samples = [{"input_ids": ids, "labels": lab,
                "images": rng.standard_normal((3, 4, 4, 3)).astype(np.float32),
                "patch_valid": np.arange(3) < 2}
               for ids, lab in zip(want["input_ids"], want["labels"])]
    for max_length in (2048, 16):
        jb = jdataset.Collator(pad_token_id=0, max_length=max_length, pad_multiple=8)(samples)
        tb = tdataset.Collator(pad_token_id=0, max_length=max_length, pad_multiple=8)(samples)
        assert set(jb) == set(tb)
        for key in jb:
            np.testing.assert_array_equal(tb[key], jb[key])


# -- train() end to end ----------------------------------------------------------------


@pytest.fixture
def pil_fixture(tmp_path):
    """The JAX trainer test's fixture (`tests/test_train_loop.py`): 8 random
    JPEGs of 80-150 x 100 pixels with one-turn conversations."""
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    records = []
    for i in range(8):
        name = f"img{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (80 + 10 * i, 100, 3), np.uint8)).save(img_dir / name)
        records.append({
            "id": f"sample-{i}", "image": name,
            "conversations": [
                {"from": "human", "value": f"<image>\nQuestion number {i}?"},
                {"from": "gpt", "value": f"Answer number {i} with several words."},
            ],
        })
    data_path = tmp_path / "data.json"
    data_path.write_text(json.dumps(records))
    return str(data_path), str(img_dir)


def _train_args(module, data_path, img_dir, out, **over):
    kw = dict(stage="1", data_path=data_path, image_folder=img_dir, image_aspect_ratio="anyres",
              mm_grid_pinpoints=CFG.mm_grid_pinpoints, model_max_length=128,
              per_device_batch_size=2, num_epochs=2, max_steps=2, learning_rate=1e-3,
              mm_projector_lr=1e-2, mesh_data=1, mesh_fsdp=1, mesh_model=1, output_dir=out,
              save_steps=1, logging_steps=1, remat=True, resume=False, dtype="float32",
              seed=0)
    kw.update(over)
    if module is not None:  # the port's trainer: on the CPU
        kw["device"] = "cpu"
    return kw


def _losses(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def test_train_stage1_matches_jax_and_resumes(tmp_path, pil_fixture, monkeypatch):
    from vis_zephyr_tpu.data import native as jnative
    from vis_zephyr_tpu.train import train as jtrain
    from vis_zephyr_tpu_torch.data import native as tnative
    from vis_zephyr_tpu_torch.data import prefetch as tprefetch
    from vis_zephyr_tpu_torch.train import train as ttrain

    data_path, img_dir = pil_fixture
    # Each dataset takes its native C++ image route when its library is
    # built; hold both to the PIL route here (tests/test_torch_load_train.py
    # runs both trainers on whichever route the machine builds).
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    # Both trainers start from the JAX init of seed 0: the port's random
    # init draws from a torch generator, so the test hands it the JAX tree
    # through the weight bridge.
    init = jax_params_numpy(CFG, 0)
    monkeypatch.setattr(ttrain, "init_vis_zephyr",
                        lambda cfg, generator, device, dtype: port_model(init, CFG).to(device, dtype))
    # MockTokenizer numbers words as it first sees them, and the prefetch
    # threads tokenize in a racy order: see every word once, in file order,
    # so that both trainers (and every thread) read one fixed vocabulary.
    tok = MockTokenizer()
    for rec in json.load(open(data_path)):
        jtok.preprocess([rec["conversations"]], tok, has_image=True)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jtrain.train(jtrain.TrainArguments(**_train_args(None, data_path, img_dir, jout)),
                 tok, cfg=CFG)

    consumed = []
    real_loader = tprefetch.PrefetchLoader

    class RecordingLoader(real_loader):
        def __init__(self, dataset, collator, batch_indices, **kw):
            consumed.extend(batch_indices)
            super().__init__(dataset, collator, batch_indices, **kw)

    monkeypatch.setattr(tprefetch, "PrefetchLoader", RecordingLoader)
    args = ttrain.TrainArguments(**_train_args(ttrain, data_path, img_dir, tout))
    state = ttrain.train(args, tok, cfg=TCFG)
    assert state["step"] == 2
    np.testing.assert_allclose(_losses(tout), _losses(jout), rtol=1e-4)

    # Layout: projector-only saves each step, the final full state, and the
    # stage-1 projector artifact after it.
    names = sorted(os.listdir(tout))
    assert {"checkpoint-1", "checkpoint-2", "checkpoint-3", "metrics.jsonl",
            "benchmark.csv"} <= set(names)
    assert os.path.exists(os.path.join(tout, "checkpoint-1", "projector", "projector.pt"))
    assert os.path.exists(os.path.join(tout, "checkpoint-2", "state", "state.pt"))
    assert os.path.exists(os.path.join(tout, "checkpoint-3", "projector", "projector.pt"))
    assert tckpt.checkpoint_meta(os.path.join(tout, "checkpoint-2"))["step"] == 2
    assert tckpt.latest_checkpoint(tout) == os.path.join(tout, "checkpoint-3")
    assert tckpt.latest_checkpoint(tout, full_state=True) == os.path.join(tout, "checkpoint-2")
    rows = [json.loads(line) for line in open(os.path.join(tout, "metrics.jsonl"))]
    for key in ("step", "loss", "grad_norm", "tokens", "samples_per_s", "step_time_s", "lr",
                "projector_lr", "epoch"):
        assert key in rows[0], key
    assert rows[0]["projector_lr"] > rows[0]["lr"]
    assert "samples_per_s" in open(os.path.join(tout, "benchmark.csv")).read()

    # The saved projector is the trained one.
    proj = state["params"].projector
    loaded = tckpt.load_projector(os.path.join(tout, "checkpoint-3"),
                                  port_model(jax_params_numpy(CFG, 1), CFG).projector)
    for a, b in zip(loaded.state_dict().values(), proj.state_dict().values()):
        assert torch.equal(a, b)

    # Resume: the full state comes back and the sampler fast-forwards, so
    # the next batch is the one an uninterrupted run would take third.
    first = list(consumed)
    consumed.clear()
    args3 = dataclasses.replace(args, max_steps=3, resume=True)
    state3 = ttrain.train(args3, tok, cfg=TCFG)
    assert state3["step"] == 3 and consumed and consumed[0] == first[2]
    assert len(_losses(tout)) == 3


def test_train_refuses_what_is_not_ported(tmp_path, pil_fixture):
    from vis_zephyr_tpu_torch.train import train as ttrain

    data_path, img_dir = pil_fixture
    base = _train_args(ttrain, data_path, img_dir, str(tmp_path / "x"))
    for over, match in ((dict(mesh_fsdp=4), "step 13"), (dict(mesh_model=2), "step 13")):
        with pytest.raises(NotImplementedError, match=match):
            ttrain.train(ttrain.TrainArguments(**{**base, **over}), MockTokenizer(), cfg=TCFG)
    # An orbax full state is refused by name.
    orbax = tmp_path / "orbax" / "checkpoint-5" / "state"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.load_checkpoint(str(orbax.parent), {"params": port_model(jax_params_numpy(CFG, 0), CFG)})

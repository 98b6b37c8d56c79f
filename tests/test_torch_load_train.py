"""The port's trainer with the image-token flags against the JAX trainer, on
the CPU: `train()` with `mm_use_im_start_end=True` adds `<im_start>` /
`<im_end>` to the tokenizer and two mean rows to the tables, and its first
loss equals the JAX `train()`'s on a one-device mesh (both from the JAX init
of seed 0 through the weight bridge, both datasets on one image route).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_train import _losses, _train_args, pil_fixture  # noqa: F401 — a fixture
from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import jax_params_numpy, port_config, port_model, word_list, word_tokenizer
from vis_zephyr_tpu.config import tiny_config

CFG = tiny_config()
TCFG = port_config(CFG)
WORDS = word_list(CFG.decoder.vocab_size)


def test_train_with_im_start_end_matches_jax(tmp_path, pil_fixture, monkeypatch):  # noqa: F811
    from vis_zephyr_tpu.train import train as jtrain
    from vis_zephyr_tpu_torch.train import train as ttrain

    data_path, img_dir = pil_fixture
    init = jax_params_numpy(CFG, 0)
    # Both trainers start from one JAX init (seed 0), the port's through the
    # weight bridge; the JAX trainer takes the tree as it is.
    monkeypatch.setattr(ttrain, "init_vis_zephyr",
                        lambda cfg, generator, device, dtype: port_model(init, CFG).to(device, dtype))
    monkeypatch.setattr(jtrain, "init_vis_zephyr", lambda cfg, key, dtype: jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype), init))
    words = WORDS[:4] + sorted({w for rec in json.load(open(data_path))
                                for turn in rec["conversations"]
                                for w in turn["value"].replace("?", " ").replace(".", " ").split()}
                               - set(WORDS[:4]))
    words += [f"w{i}" for i in range(CFG.decoder.vocab_size - len(words))]
    over = dict(max_steps=1, num_epochs=1, mm_use_im_start_end=True)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jtok, ttok = word_tokenizer(words), word_tokenizer(words)
    jtrain.train(jtrain.TrainArguments(**_train_args(None, data_path, img_dir, jout, **over)),
                 jtok, cfg=CFG)
    state = ttrain.train(ttrain.TrainArguments(**_train_args(ttrain, data_path, img_dir, tout,
                                                             **over)), ttok, cfg=TCFG)
    assert len(ttok) == len(jtok) == CFG.decoder.vocab_size + 2
    model = state["params"]
    assert model.decoder.model.embed_tokens.weight.shape[0] == CFG.decoder.vocab_size + 2
    assert model.cfg.mm_use_im_start_end and model.cfg.decoder.vocab_size == len(ttok)
    np.testing.assert_allclose(_losses(tout), _losses(jout), rtol=1e-4)

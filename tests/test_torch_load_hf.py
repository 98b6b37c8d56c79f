"""The reference's released forms through the port's builder against the JAX
builder, on the CPU, with `tests/test_builder.py`'s fixtures (an HF Mistral
decoder, an HF CLIP tower and a torch Q-Former at tiny widths): the stage-2
artifact (HF base + peft adapter dir + `non_lora_trainables.bin` carrying
the projector and embedding tables larger than the base's) and the
consolidated single-dir checkpoint. Every weight equals the JAX builder's
within 1e-5 in f32, and the returned config's vocabulary follows the tables.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_builder import TINY_DEC, hf_dirs  # noqa: F401 — hf_dirs is a fixture
from test_vision_parity import TINY_PROJ, TINY_VISION
from torch_port_util import assert_state_matches, port_config
from vis_zephyr_tpu.config import VisZephyrConfig as JaxConfig
from vis_zephyr_tpu.models import builder as jbuilder
from vis_zephyr_tpu_torch.models import builder as tbuilder
from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _peft_artifact(path, qf, vocab_extra: int, seed: int = 0):
    """A reference stage-2 artifact: adapter_config.json, adapter_model.bin
    (r 4, α 8) and non_lora_trainables.bin with the projector and embedding
    tables `vocab_extra` rows larger than the base's."""
    path.mkdir()
    r, alpha = 4, 8.0
    (path / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": alpha}))
    gen = torch.Generator().manual_seed(seed)
    d, hd = TINY_DEC, TINY_DEC.head_dim
    shapes = {"self_attn.q_proj": (d.hidden_size, d.num_heads * hd),
              "self_attn.k_proj": (d.hidden_size, d.num_kv_heads * hd),
              "self_attn.v_proj": (d.hidden_size, d.num_kv_heads * hd),
              "self_attn.o_proj": (d.num_heads * hd, d.hidden_size),
              "mlp.gate_proj": (d.hidden_size, d.intermediate_size),
              "mlp.up_proj": (d.hidden_size, d.intermediate_size),
              "mlp.down_proj": (d.intermediate_size, d.hidden_size)}
    asd = {}
    for i in range(d.num_layers):
        for mod, (din, dout) in shapes.items():
            pre = f"base_model.model.model.layers.{i}.{mod}"
            asd[f"{pre}.lora_A.weight"] = torch.randn(r, din, generator=gen) * 0.1
            asd[f"{pre}.lora_B.weight"] = torch.randn(dout, r, generator=gen) * 0.1
    torch.save(asd, path / "adapter_model.bin")
    V = d.vocab_size + vocab_extra
    nlt = {f"base_model.model.model.mm_projector.{k}": v for k, v in qf.state_dict().items()}
    nlt["base_model.model.model.embed_tokens.weight"] = torch.randn(V, d.hidden_size, generator=gen)
    nlt["base_model.model.lm_head.weight"] = torch.randn(V, d.hidden_size, generator=gen)
    torch.save(nlt, path / "non_lora_trainables.bin")


@pytest.mark.parametrize("form", ["peft", "consolidated"])
def test_released_forms_match_the_jax_builder(tmp_path, hf_dirs, form):  # noqa: F811
    _, base_dir, tower_dir, mistral, clip, qf = hf_dirs
    jcfg = JaxConfig(vision=TINY_VISION, projector=TINY_PROJ, decoder=TINY_DEC)
    art = tmp_path / form
    if form == "peft":
        _peft_artifact(art, qf, vocab_extra=3)
        kw = dict(model_base=base_dir, vision_tower_path=tower_dir)
        vocab = TINY_DEC.vocab_size + 3
    else:
        art.mkdir()
        sd = dict(mistral.state_dict())
        sd.update({f"model.mm_projector.{k}": v for k, v in qf.state_dict().items()})
        sd.update({f"model.vision_tower.vision_tower.{k}": v for k, v in clip.state_dict().items()})
        torch.save(sd, art / "pytorch_model.bin")
        kw = {}
        vocab = TINY_DEC.vocab_size
    (art / "config.json").write_text(jcfg.to_json())

    _, jparams, _, _ = jbuilder.load_pretrained_model(str(art), dtype=jnp.float32, **kw)
    _, loaded, cfg, _ = tbuilder.load_pretrained_model(str(art), dtype=torch.float32,
                                                       device="cpu", **kw)
    assert cfg.decoder.vocab_size == vocab
    want = state_dict_from_jax(_np_tree(jparams), port_config(jcfg))
    assert_state_matches(loaded.state_dict(), want, rtol=1e-5, atol=1e-5)


def test_lora_artifact_needs_the_tower(tmp_path, hf_dirs):  # noqa: F811
    _, base_dir, _, _, _, qf = hf_dirs
    _peft_artifact(tmp_path / "art", qf, vocab_extra=0)
    with pytest.raises(FileNotFoundError, match="--vision-tower"):
        tbuilder.load_pretrained_model(str(tmp_path / "art"), model_base=base_dir, device="cpu")


